"""Inputs made from the seed on the device: the weights both sides get, the
uint8 image pool, the order batches are drawn from it, and the readings a
training cell compares."""

from __future__ import annotations

import torch

from perfbench.reference import model as ref_model

from .session import sub_seed

WEIGHTS, POOL, ORDER, DRAWS, NOISE = 1, 2, 3, 4, 5  # sub-seed tags


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def weights(shapes, device, seed: int, tag: int = 0) -> dict:
    """The seeded weights of one network, made in one draw on ``device``."""
    return ref_model.init_weights(shapes, generator(device, seed, WEIGHTS, tag), device)


def load_into(module, weights: dict) -> None:
    """Copy ``weights`` into ``module``'s parameters by name; every name must
    match both ways."""
    names = dict(module.named_parameters())
    if set(names) != set(weights):
        raise KeyError(f"parameter names differ: program only {sorted(set(names) - set(weights))}, "
                       f"reference only {sorted(set(weights) - set(names))}")
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(weights[name].to(p.dtype))


def pool(n: int, side: int, device, seed: int, tag: int = 0) -> torch.Tensor:
    """(n, side, side, 3) uint8 images drawn on ``device``: uniform noise
    about a mean level and with a contrast of each image's own (levels
    16–240, half-ranges 8–128), so that, as in a real set, the rows of a
    batch differ in what they contribute to the loss."""
    g = generator(device, seed, POOL, tag)
    u = torch.rand((n, side, side, 3), generator=g, device=device)
    level = torch.rand((n, 1, 1, 1), generator=g, device=device) * 224 + 16
    spread = torch.rand((n, 1, 1, 1), generator=g, device=device) * 120 + 8
    return (level + spread * (2 * u - 1)).round_().clamp_(0, 255).to(torch.uint8)


class Order:
    """Batches of pool indices in epochs without replacement, drawn on the
    device (no host sync): every row of an epoch differs."""

    def __init__(self, n: int, batch: int, device, seed: int, tag: int = 0):
        if n % batch:
            raise ValueError(f"pool of {n} images not a multiple of the batch {batch}")
        self.n, self.batch, self.device = n, batch, device
        self.g = generator(device, seed, ORDER, tag)
        self.perm, self.at = None, n

    def next(self) -> torch.Tensor:
        if self.at >= self.n:
            self.perm = torch.randperm(self.n, generator=self.g, device=self.device)
            self.at = 0
        idx = self.perm[self.at:self.at + self.batch]
        self.at += self.batch
        return idx


def adam_mu(opt_state):
    """The first moments of the Adam state inside an optimizer state tree
    (the NamedTuple with ``count``, ``mu`` and ``nu``)."""
    if hasattr(opt_state, "_fields") and {"count", "mu", "nu"} <= set(opt_state._fields):
        return opt_state.mu
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = adam_mu(s)
            if found is not None:
                return found
    return None


def leaf_norms(names, tensors, scale: float = 1.0) -> dict:
    """``name -> ‖tensor‖·scale`` for parallel lists, as one device sync."""
    norms = torch.stack([torch.linalg.vector_norm(t.detach().float()) for t in tensors])
    return {n: float(v) * scale for n, v in zip(names, norms.tolist())}


class Readings:
    """What a training cell compares: each checked step's loss, the first
    step's gradient by leaf (from Adam's first moment: m₁ = (1 − β₁)·g₁), and
    each leaf's change over the checked steps, taken before the next. The
    reference's also hold each leaf's value norm and size after the steps
    (``value_norms``, ``numel``), which say whether a change is resolved."""

    def __init__(self):
        self.losses, self.grad_norms, self.delta_norms = [], None, None
        self.value_norms, self.numel = None, None


def drive_checked_steps(step, named_params, opt_state_of, n_steps: int, loss_of):
    """Run ``n_steps`` calls of ``step()`` (the window's own call on the
    window's feed) and take the readings: ``named_params()`` gives the
    program's (name, parameter) pairs in its optimizer's leaf order,
    ``opt_state_of()`` its optimizer state(s) as a list, ``loss_of(out)`` the
    losses a call returned."""
    r = Readings()
    names = [n for n, _ in named_params()]
    start = [p.detach().clone() for _, p in named_params()]
    for k in range(n_steps):
        out = step()
        r.losses.append(loss_of(out))
        if k == 0:
            mus = [m for s in opt_state_of() for m in adam_mu(s)]
            r.grad_norms = leaf_norms(names, mus, 1.0 / (1.0 - 0.9))
    r.delta_norms = leaf_norms(names, [p.detach() - s for (_, p), s in zip(named_params(), start)])
    return r
