"""Per-model entry point, `scripts/run_hole.py`'s counterpart (the
reference harness's run_hole.py): the experiment CLI with `--model hole`
pinned, `python -m skge_torch.run_hole [experiment flags]`."""

import sys

from skge_torch import experiment


def main(argv=None) -> int:
    return experiment.main(["--model", "hole"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
