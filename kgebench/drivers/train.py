"""Training cells: `skge_torch.training.make_epoch_fn` over
`make_pairwise_step(model, AdaGrad, sampler, margin, aggregate)`.

Set-up makes the graph and the weights from the seed, builds the one
epoch function the window drives, and runs its first epoch: the warm-up,
and the steps the check reads. A `Recorder` between the epoch function
and the step keeps copies of what the first three steps left (each
step's loss, AdaGrad's accumulators after the first, the tables after
the third); it keeps nothing afterwards. The window runs whole epochs,
each ended by a synchronize, and closes at the first epoch end at or
after `seconds`.
"""

from __future__ import annotations

import time

import torch

from kgebench import check, counts, gen, profiling, reference
from skge_torch.models import MODELS
from skge_torch.optim import AdaGrad
from skge_torch.sampling import RandomModeSampler, SharedNegativeSampler
from skge_torch.training import TrainState, make_epoch_fn, make_pairwise_step

CHECKED_STEPS = 3


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """The step as `make_epoch_fn` calls it, keeping copies of what the
    first `CHECKED_STEPS` steps left."""

    def __init__(self, step):
        self.step = step
        self.first_step_s = None
        self.loss = []
        self.p2_1 = None
        self.params = None

    def __call__(self, state, batch, mask, **kw):
        i = len(self.loss)
        if i == 0:
            sync(batch.device)
            t0 = time.perf_counter()
        state, m = self.step(state, batch, mask, **kw)
        if i == 0:
            sync(batch.device)
            self.first_step_s = time.perf_counter() - t0
        if i < CHECKED_STEPS:
            self.loss.append(m.loss.detach().clone())
            if i == 0:
                self.p2_1 = {k: v["p2"].detach().clone() for k, v in state.opt_state.items()}
            if i == CHECKED_STEPS - 1:
                self.params = {k: v.detach().clone() for k, v in state.params.items()}
        return state, m

    def record(self) -> dict:
        return {"loss": [float(x) for x in self.loss], "p2_1": self.p2_1,
                "params": self.params}


def sampler_of(traffic: dict, n_e: int):
    modes = tuple(traffic["modes"])
    if traffic["sampler"] == "shared":
        return SharedNegativeSampler(n_e, k=traffic["k"], modes=modes)
    return RandomModeSampler(n_e, modes=modes * traffic["negatives"])


class Session:
    def __init__(self, spec, seed: int, device: torch.device):
        cfg, traffic = spec.config, spec.traffic
        self.spec, self.seed, self.device = spec, seed, device
        t0 = time.perf_counter()
        self.xs = torch.as_tensor(gen.kg(cfg, seed), device=device)
        self.n = self.xs.shape[0]
        params = gen.weights(spec.model.tables(cfg), seed, device)
        self.p0 = {k: v.clone() for k, v in params.items()}
        model = MODELS[cfg["model"]](cfg["entities"], cfg["relations"], cfg["ncomp"],
                                     **cfg.get("model_args", {}))
        opt = AdaGrad(lr=cfg["lr"], eps=cfg["adagrad_eps"])
        step = make_pairwise_step(model, opt, sampler_of(traffic, cfg["entities"]),
                                  margin=cfg["margin"], aggregate=cfg["aggregate"])
        self.recorder = Recorder(step)
        self.epoch = make_epoch_fn(self.recorder, self.n, cfg["nbatches"])
        self.state = TrainState(params, opt.init(params),
                                gen.draw_generator(seed, device), 0)
        t1 = time.perf_counter()
        self.state, _ = self.epoch(self.state, self.xs)
        sync(device)
        self.phases = {"inputs": t1 - t0, "first epoch": time.perf_counter() - t1,
                       "its first step": self.recorder.first_step_s}

    def window(self, seconds: float) -> dict:
        losses, ends = [], []
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            self.state, m = self.epoch(self.state, self.xs)
            sync(self.device)
            losses.append(m.loss)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        dt, epochs = ends[-1], len(ends)
        self.epoch_s = [b - a for a, b in zip([0.0] + ends, ends)]
        steps = torch.cat(losses)
        return {
            "metrics": {"train_triples_per_s":
                        counts.train_units(self.spec.traffic, self.n) * epochs / dt},
            "attempted": int(steps.shape[0]),
            "failed": int(torch.sum(~torch.isfinite(steps))),
        }

    def window_figures(self) -> dict:
        return {}

    def traced(self) -> profiling.Span:
        """One more epoch under the profiler."""
        with profiling.traced(self.device, "train", "kgebench.train_epoch") as span:
            self.state, _ = self.epoch(self.state, self.xs)
        span.model_flops = counts.train_flops(self.spec.model, self.spec.config,
                                              self.spec.traffic, self.n)
        return span

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = self.epoch = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, prec: str = "fp64") -> dict:
        spec = self.spec
        ref = reference.train_steps(spec.model, spec.config, spec.traffic, self.p0, self.xs,
                                    gen.draw_generator(self.seed, self.device), CHECKED_STEPS,
                                    reference.PRECISIONS[prec])
        return check.train_numbers(self.recorder.record(), ref, self.p0)
