"""Top-level dispatcher: ``python -m pcss_unet_tpu_torch <command> [args...]``.

Every command of ``python -m pcss_unet_tpu`` runs (``PORTED``); a command
outside ``PORTED`` would exit 2 with a message that says it is not ported
yet.
"""

import sys

COMMANDS = ("organize", "prepare", "stats", "train", "infer", "serve",
            "validate", "temporal", "check", "inspect")
PORTED = ("organize", "prepare", "stats", "train", "infer", "serve",
          "validate", "temporal", "check", "inspect")


def main():
    """Run the command; returns what its ``main`` returns."""
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help") or \
            sys.argv[1] not in COMMANDS:
        print("usage: python -m pcss_unet_tpu_torch <command> [args...]")
        missing = [c for c in COMMANDS if c not in PORTED]
        print(f"commands: {', '.join(PORTED)}"
              + (f" (not ported yet: {', '.join(missing)})" if missing else ""))
        raise SystemExit(0 if len(sys.argv) >= 2 and
                         sys.argv[1] in ("-h", "--help") else 2)
    if sys.argv[1] not in PORTED:
        print(f"pcss_unet_tpu_torch: command {sys.argv[1]!r} is not ported "
              "yet; run it with python -m pcss_unet_tpu", file=sys.stderr)
        raise SystemExit(2)
    import importlib

    module = importlib.import_module(f"pcss_unet_tpu_torch.cli.{sys.argv[1]}")
    return module.main(sys.argv[2:])


if __name__ == "__main__":
    main()
