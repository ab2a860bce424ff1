"""`python -m bcalm_tpu_torch` entry: runs cli.main, maps an uncaught
exception to a message and exit code 1 (as `python -m bcalm_tpu` does)."""

import sys


def run() -> int:
    try:
        from bcalm_tpu_torch.cli import main

        return main()
    except KeyboardInterrupt:
        return 130
    except Exception as e:  # noqa: BLE001 — process boundary: report, exit 1
        print(f"EXCEPTION: {e!r}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(run())
