"""One driver a cell `kind`: `train` and `serve`."""
