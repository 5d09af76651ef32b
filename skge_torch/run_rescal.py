"""Per-model entry point, `scripts/run_rescal.py`'s counterpart (the
reference harness's run_rescal.py): the experiment CLI with `--model rescal`
pinned, `python -m skge_torch.run_rescal [experiment flags]`."""

import sys

from skge_torch import experiment


def main(argv=None) -> int:
    return experiment.main(["--model", "rescal"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
