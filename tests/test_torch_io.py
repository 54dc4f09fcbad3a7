"""The port's IO stack (``pcss_unet_tpu_torch.io``) against the JAX
package's, at test time: EXR files written by either package read back
through the other equal, value for value, for every compression, pixel type
and layout, with each backend (the native codec the port builds into
``build/exr`` and the pure-Python one); multipart selection; the
``read_exr`` contract; error types; and PNG masks and labels with the same
pixel codes as the JAX package's (which writes them with Pillow)."""

import io

import numpy as np
import pytest
from PIL import Image

from pcss_unet_tpu.io import exr as jexr
from pcss_unet_tpu.io import exr_py as jexr_py
from pcss_unet_tpu.io import png as jpng
from pcss_unet_tpu_torch.io import exr as pexr
from pcss_unet_tpu_torch.io import exr_py as pexr_py
from pcss_unet_tpu_torch.io import png as ppng

COMPS = ["NONE", "RLE", "ZIPS", "ZIP", "PXR24", "PIZ", "B44", "B44A", "DWAA",
         "DWAB"]
PIXEL_TYPES = {"HALF": jexr_py.PT_HALF, "FLOAT": jexr_py.PT_FLOAT}
LAYOUTS = {"scanline": None, "tiled32": (32, 32)}
NAMES = ["A", "B", "G", "R"]


@pytest.fixture(params=["python", "native"])
def backend(request, monkeypatch):
    """Both packages read and write through one backend (the switch is the
    same environment variable); 'native' needs both codecs to build."""
    monkeypatch.setenv("PCSS_EXR_BACKEND", request.param)
    if request.param == "native" and (pexr._load_native() is None
                                      or jexr._load_native() is None):
        pytest.skip(f"native EXR codec unavailable: {pexr.native_error()}")
    return request.param


def _planes(rng, h=45, w=70):
    """Smooth planes with detail, inside the half range (lossy codecs
    differ by codec, not by package)."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    out = {}
    for i, n in enumerate("RGBA"):
        base = np.sin(xx / (7 + i)) * np.cos(yy / (5 + i)) * (1 + i)
        out[n] = (base + 0.05 * rng.standard_normal((h, w))).astype(np.float32)
    return out


def _equal(a: dict, b: dict, names=NAMES):
    for n in names:
        assert a[n] is not None and b[n] is not None, n
        assert a[n].dtype == b[n].dtype == np.float32
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("pixel_type", list(PIXEL_TYPES))
@pytest.mark.parametrize("comp", COMPS)
def test_port_reads_what_jax_writes(tmp_path, rng, backend, comp, pixel_type,
                                    layout):
    path = str(tmp_path / "j.exr")
    jexr.write_exr(path, _planes(rng), compression=comp,
                   pixel_type=PIXEL_TYPES[pixel_type], tile_size=LAYOUTS[layout])
    got = pexr.read_exr_channels(path, NAMES)
    assert pexr.last_backend() == backend
    _equal(got, jexr.read_exr_channels(path, NAMES))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("pixel_type", list(PIXEL_TYPES))
@pytest.mark.parametrize("comp", COMPS)
def test_jax_reads_what_port_writes(tmp_path, rng, backend, comp, pixel_type,
                                    layout):
    path = str(tmp_path / "p.exr")
    planes = _planes(rng)
    pexr.write_exr(path, planes, compression=comp,
                   pixel_type=PIXEL_TYPES[pixel_type], tile_size=LAYOUTS[layout])
    got = pexr.read_exr_channels(path, NAMES)
    _equal(jexr.read_exr_channels(path, NAMES), got)
    if comp in ("NONE", "RLE", "ZIPS", "ZIP", "PIZ") and pixel_type == "FLOAT":
        _equal(got, planes)             # the lossless schemes give it back


def _three_parts(rng):
    return [("beauty", {n: rng.standard_normal((20, 24)).astype(np.float32)
                        for n in "RGB"}),
            ("depth", {"Z": rng.standard_normal((20, 24)).astype(np.float32)}),
            ("aux", {"X": rng.standard_normal((20, 24)).astype(np.float32),
                     "Y": rng.standard_normal((20, 24)).astype(np.float32)})]


@pytest.mark.parametrize("tile", [None, (16, 16)], ids=["scanline", "tiled16"])
@pytest.mark.parametrize("comp", ["NONE", "ZIP", "PIZ"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_multipart_by_index_and_name(tmp_path, rng, backend, writer, comp, tile):
    parts = _three_parts(rng)
    path = str(tmp_path / "mp.exr")
    code = getattr(jexr_py, f"COMP_{comp}")
    (jexr if writer == "jax" else pexr).write_exr_multipart(
        path, parts, compression=code, tile_size=tile)
    for idx, (pname, chans) in enumerate(parts):
        names = sorted(chans)
        assert pexr.list_exr_channels(path, part=idx) == \
            jexr.list_exr_channels(path, part=idx)
        for sel in (idx, pname):
            got = pexr.read_exr_channels(path, names, part=sel)
            _equal(got, jexr.read_exr_channels(path, names, part=sel), names)
            _equal(got, chans, names)
    # the default is part 0: other parts' channels read as absent
    assert pexr.read_exr_channels(path, ["Z"])["Z"] is None


def test_read_exr_contract(tmp_path, rng, backend):
    """A missing A gives ones; NaN/+Inf/-Inf become 0/1/0 — as the JAX
    package's read_exr, plane for plane."""
    h, w = 9, 13
    chans = {n: rng.standard_normal((h, w)).astype(np.float32) for n in "RGB"}
    chans["R"][0, :3] = [np.nan, np.inf, -np.inf]
    path = str(tmp_path / "rgb.exr")
    jexr.write_exr(path, chans)
    got, want = pexr.read_exr(path), jexr.read_exr(path)
    assert len(got) == 4
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)
    np.testing.assert_array_equal(got[3], np.ones((h, w), np.float32))
    assert got[0][0, :3].tolist() == [0.0, 1.0, 0.0]
    np.testing.assert_array_equal(pexr.read_exr_stack(path),
                                  jexr.read_exr_stack(path))


def _raised(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - the type is what is compared
        return e
    raise AssertionError("no exception")


def test_errors_raise_the_same_types(tmp_path, rng, backend):
    missing = str(tmp_path / "nope.exr")
    pe, je = (_raised(lambda: m.read_exr(missing)) for m in (pexr, jexr))
    assert type(pe) is type(je) and isinstance(pe, IOError)
    # an undefined compression code (10) patched into a valid file
    path = str(tmp_path / "bad.exr")
    pexr_py.write_exr_py(path, {"R": rng.standard_normal((8, 8)).astype(np.float32)})
    data = bytearray(open(path, "rb").read())
    tag = b"compression\x00compression\x00"
    data[data.index(tag) + len(tag) + 4] = 10
    open(path, "wb").write(bytes(data))
    pe, je = (_raised(lambda: m.read_exr_channels(path, ["R"]))
              for m in (pexr, jexr))
    assert type(pe) is type(je), (pe, je)
    assert "nsupported" in str(pe)
    pe, je = (_raised(lambda: m.write_exr(path, {"R": np.zeros((2, 2))},
                                          compression="LZW"))
              for m in (pexr, jexr))
    assert type(pe) is type(je) is ValueError


@pytest.mark.parametrize("shape", [(17, 23), (40, 64), (1, 1)])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_write_mask_png_codes(tmp_path, rng, mode, shape):
    """The port's PNG (its own encoder) decodes, through Pillow and through
    the port's decoder, to the JAX package's pixel codes, for [H, W] and
    [H, W, 1] masks."""
    h, w = shape
    vals = np.concatenate([np.arange(256, dtype=np.float32) / 255.0,
                           np.nextafter(np.arange(256, dtype=np.float32) / 255.0,
                                        np.float32(-1)),
                           [np.nan, np.inf, -np.inf, -0.5, 1.5]])
    mask = np.resize(rng.permutation(vals), (h, w, 1)).astype(np.float32)
    pp, jp = str(tmp_path / "p.png"), str(tmp_path / "j.png")
    ppng.write_mask_png(pp, mask, mode=mode)
    jpng.write_mask_png(jp, mask, mode=mode)
    got, want = Image.open(pp), Image.open(jp)
    assert got.mode == want.mode == mode
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    ppng.write_mask_png(pp, mask[..., 0], mode=mode)
    np.testing.assert_array_equal(np.asarray(Image.open(pp)), np.asarray(want))
    with open(jp, "rb") as f:
        np.testing.assert_array_equal(ppng.decode_png_l(f.read()),
                                      np.asarray(want.convert("L")))
    with pytest.raises(ValueError, match="mode"):
        ppng.write_mask_png(pp, mask, mode="P")


@pytest.mark.parametrize("target", [None, (20, 30), (7, 50), (41, 9)])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_read_label_png(tmp_path, rng, mode, target):
    """Labels written by Pillow in each mode (its encoder picks the row
    filters) read as the JAX package reads them: luma as ``convert('L')``,
    NEAREST resize, /255."""
    h, w = 19, 27
    yy, xx = np.mgrid[:h, :w]
    rgb = np.stack([(xx * 9) % 256, (yy * 13) % 256, (xx * yy) % 256],
                   -1).astype(np.uint8)
    noisy = (rgb.astype(int) + rng.integers(0, 40, rgb.shape)) % 256
    img = Image.fromarray(noisy.astype(np.uint8), "RGB")
    img = {"L": img.convert("L"), "LA": img.convert("LA"), "RGB": img,
           "RGBA": img.convert("RGBA"), "P": img.convert("P")}[mode]
    path = str(tmp_path / "label.png")
    img.save(path)
    got = ppng.read_label_png(path, target)
    want = jpng.read_label_png(path, target)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_png_rejects_what_it_cannot_decode(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        ppng.decode_png_l(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        ppng.decode_png_l(b"GIF89a")
