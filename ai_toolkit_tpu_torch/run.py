"""CLI entry: ``python -m ai_toolkit_tpu_torch.run job.yaml [more.yaml] [--device cuda]``.

Port of ``run.py``: the same job files (``ai_toolkit_tpu_torch.config.get_config``),
run sequentially, ``-r/--recover`` continues past failures and ``-n/--name``
overrides the job name. The device defaults to ``cuda`` and is never chosen
silently: ``--device cuda`` without a CUDA device raises.
"""

from __future__ import annotations

import argparse
import sys
import traceback

import torch


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available on this machine")
    return device


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="ai_toolkit_tpu_torch job runner")
    parser.add_argument("config_files", nargs="+", help="config name(s) or path(s)")
    parser.add_argument("-r", "--recover", action="store_true",
                        help="continue running remaining jobs on failure")
    parser.add_argument("-n", "--name", type=str, default=None, help="job name override")
    parser.add_argument("--device", type=str, default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from ai_toolkit_tpu_torch.config import get_config
    from ai_toolkit_tpu_torch.jobs import run_job

    failures = 0
    for config_file in args.config_files:
        try:
            raw = get_config(config_file, name_override=args.name)
            print(f"Running job: {raw['config']['name']}")
            run_job(raw, device)
        except KeyboardInterrupt:
            print("interrupted")
            return 130
        except Exception:
            traceback.print_exc()
            failures += 1
            if not args.recover:
                return 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
