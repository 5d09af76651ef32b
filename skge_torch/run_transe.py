"""Per-model entry point, `scripts/run_transe.py`'s counterpart (the
reference harness's run_transe.py): the experiment CLI with `--model transe`
pinned, `python -m skge_torch.run_transe [experiment flags]`."""

import sys

from skge_torch import experiment


def main(argv=None) -> int:
    return experiment.main(["--model", "transe"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
