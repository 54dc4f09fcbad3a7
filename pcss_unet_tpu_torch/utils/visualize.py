"""Computation-graph visualization (port of
``pcss_unet_tpu/utils/visualize.py``; the reference renders torch autograd
graphs with graphviz, visualize.py:21-68):

- ``graph_text(fn, *args)``: the ``torch.export`` graph of ``fn`` (the
  counterpart of ``jaxpr_text`` / ``hlo_text``);
- ``device_ops_text(fn, *args)``: what one call actually runs, in time
  order, from ``torch.profiler``: on a card the device kernels by name (the
  port's own among them), on the CPU the top-level ATen ops (the
  counterpart of ``optimized_hlo_text``);
- ``graph_dot(fn, *args)``: graphviz DOT of the exported graph's nodes
  (the counterpart of ``jaxpr_dot``), rendered by ``render_dot`` where the
  ``graphviz`` package is present.

``torch.export`` cannot trace the port's kernels (ctypes calls into a
library built on the card), so graphs are of plain forwards, as the
reference's ``inspect`` graphs its plain eval model.
"""

from __future__ import annotations

import torch


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, *args, **kwargs):
    """``torch.export`` of ``fn`` (a module, or a function wrapped into
    one) on these arguments."""
    module = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    return torch.export.export(module, args, kwargs or None)


def graph_text(fn, *args, **kwargs) -> str:
    return str(_export(fn, *args, **kwargs))


def device_ops_text(fn, *args, **kwargs) -> str:
    """One call of ``fn`` under torch.profiler: one line per op in time
    order, its name and its own time in µs (device time on a card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available() and any(
        torch.is_tensor(a) and a.is_cuda for a in args)
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn(*args, **kwargs)
        if on_card:
            torch.cuda.synchronize()
    if on_card:
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    else:
        events = [e for e in prof.events() if e.cpu_parent is None]
    events.sort(key=lambda e: e.time_range.start)
    return "\n".join(f"{e.name}  {e.time_range.elapsed_us():.1f} us"
                     for e in events)


def _aval(node) -> str:
    """A node's value as jax's ``str_short`` writes one: ``float32[4,8]``."""
    val = node.meta.get("val")
    if torch.is_tensor(val):
        dt = str(val.dtype).replace("torch.", "")
        return f"{dt}[{','.join(str(int(d)) for d in val.shape)}]"
    return type(val).__name__


def _op_name(target) -> str:
    name = getattr(target, "__name__", str(target))     # aten: "tanh.default"
    return name.split(".")[0]


def graph_dot(fn, *args, max_nodes: int = 400, **kwargs) -> str:
    """DOT source for the exported graph: ops as nodes, value flow as
    edges (the autograd-graph analogue of visualize.py:21-68)."""
    graph = _export(fn, *args, **kwargs).graph
    lines = ["digraph graph_module {", "  rankdir=TB;",
             '  node [shape=box, fontsize=10, style=filled,'
             ' fillcolor="#e8f0fe"];']
    names: dict[str, str] = {}

    def vname(node):
        if node.name not in names:
            names[node.name] = f"v{len(names)}"
        return names[node.name]

    inputs = [n for n in graph.nodes if n.op == "placeholder"]
    ops = [n for n in graph.nodes if n.op == "call_function"]
    output = next(n for n in graph.nodes if n.op == "output")
    for i, node in enumerate(inputs):
        lines.append(f'  {vname(node)} [label="input {i}\\n{_aval(node)}",'
                     ' fillcolor="#d2e3fc"];')
    for n, node in enumerate(ops[:max_nodes]):
        enode = f"e{n}"
        lines.append(f'  {enode} [label="{_op_name(node.target)}"];')
        for arg in node.all_input_nodes:
            lines.append(f"  {vname(arg)} -> {enode};")
        lines.append(f'  {vname(node)} [label="{_aval(node)}",'
                     ' fillcolor="#ffffff"];')
        lines.append(f"  {enode} -> {vname(node)};")
    if len(ops) > max_nodes:
        lines.append(f'  truncated [label="... {len(ops) - max_nodes}'
                     ' more eqns", fillcolor="#fce8e6"];')
    for i, node in enumerate(output.all_input_nodes):
        lines.append(f'  out{i} [label="output {i}",'
                     ' fillcolor="#ceead6"];')
        lines.append(f"  {vname(node)} -> out{i};")
    lines.append("}")
    return "\n".join(lines)


def render_dot(dot_source: str, out_path: str) -> str | None:
    """Render DOT to an image if the graphviz package is present; returns
    the written path or None (the DOT source is still usable as text)."""
    try:
        import graphviz  # noqa: PLC0415

        src = graphviz.Source(dot_source)
        return src.render(outfile=out_path, cleanup=True)
    except Exception:  # noqa: BLE001 - graphviz genuinely optional
        return None
