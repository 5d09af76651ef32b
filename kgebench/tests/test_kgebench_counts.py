"""The operation and byte counts against counts made by hand."""

import math

from kgebench import counts, registry

POOL = {"sampler": "shared", "k": 1024, "modes": [0, 1]}
IID = {"sampler": "random-mode", "negatives": 1, "modes": [0, 1]}
CFG = {"ncomp": 150, "entities": 14951}


def model(name):
    return registry.load_module(registry.ROOT / "models" / f"{name}.py", f"counts_{name}")


def test_k1_bytes():
    # 15,520 int64 ids, 15,520 x 152 fp32 gradients, 9,000 touched rows of 152
    assert counts.k1_bytes(15520, 152, 9000) == 8 * 15520 + 4 * 15520 * 152 + 4 * 9000 * 152
    assert counts.k1_bytes(15520, 152, 9000) == 124160 + 9436160 + 5472000


def test_train_units_as_bench_counts_them():
    # 2 scores a pair; 2 modes x 1,024 pool pairs a positive; 483,142 positives
    assert counts.train_units(POOL, 483142) == 2 * 2048 * 483142 == 1978949632
    assert counts.train_units(IID, 141442) == 2 * 2 * 141442


def test_transe_flops():
    t = model("transe")
    # a positive: score (2 adds, |x|, sum) and backward (sign, three rows): 8d;
    # each mode: the query (d, backward 2d) and 1,024 pairs of 6d
    per = 8 * 150 + 2 * (3 * 150 + 1024 * 6 * 150)
    assert counts.train_flops(t, CFG, POOL, 10) == 10 * per
    # serving: one query add and 14,951 forward pairs of 3d
    assert counts.serve_flops(t, CFG, 4) == 4 * (150 + 14951 * 450)


def test_hole_flops():
    h = model("hole")
    circ = 7.5 * 150 * math.log2(150) + 6 * 76
    triple = (circ + 300) + (2 * circ + 450)
    assert math.isclose(counts.train_flops(h, CFG, IID, 1), 3 * triple)
    pool = triple + 2 * (3 * circ + 1024 * 900)
    assert math.isclose(counts.train_flops(h, CFG, POOL, 1), pool)
