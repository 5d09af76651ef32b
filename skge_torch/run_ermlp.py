"""Per-model entry point, `scripts/run_ermlp.py`'s counterpart (the
reference harness's run_ermlp.py): the experiment CLI with `--model ermlp`
pinned, `python -m skge_torch.run_ermlp [experiment flags]`."""

import sys

from skge_torch import experiment


def main(argv=None) -> int:
    return experiment.main(["--model", "ermlp"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    sys.exit(main())
