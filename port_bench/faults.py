"""Faults planted in the program under test, to show that the comparison
deciding `correct` catches them (`calibrate.py --fault`, and the tests).
The benchmark's own runs never plant one.

Each is a context manager that patches one function of the program and
restores it on exit.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def token(beams: int):
    """A served token altered where it is produced: each decoded row's
    second token moved half the vocabulary on."""
    from rgrg_tpu_torch.models import full_model
    name = "beam_generate" if beams > 1 else "greedy_generate"

    def make(orig):
        def broken(params, *args, **kwargs):
            out = orig(params, *args, **kwargs)
            ids = out[0] if isinstance(out, tuple) else out
            vocab = params["wte"]["embedding"].shape[0]
            ids[:, 2] = (ids[:, 2] + vocab // 2) % (vocab - 2)
            return out
        return broken
    return _patched(full_model, name, make)


def box():
    """An answer altered where it is produced: every region's box moved
    40 pixels."""
    from rgrg_tpu_torch.models.detector import RegionDetector

    def make(orig):
        def broken(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            out["top_region_boxes"] = out["top_region_boxes"] + 40.0
            return out
        return broken
    return _patched(RegionDetector, "forward", make)


def unchanged():
    """A training step that returns its state unchanged: the optimizer
    neither accumulates nor steps."""
    from rgrg_tpu_torch.train import trainer

    def make(orig):
        def broken(self):
            for t in self.tensors:
                t.grad = None
            return False
        return broken
    return _patched(trainer.Optimizer, "step", make)


def half_batch():
    """Half of each training batch left out: the step sees the first half
    of the rows and takes its means over them."""
    from rgrg_tpu_torch.train import trainer

    def make(orig):
        def build(*args, **kwargs):
            step = orig(*args, **kwargs)

            def broken(state, batch, rng):
                return step(state, {k: v[: len(v) // 2] for k, v in batch.items()}, rng)
            return broken
        return build
    return _patched(trainer, "make_train_step", make)


FAULTS = {"token": token, "box": box, "unchanged": unchanged, "half_batch": half_batch}
