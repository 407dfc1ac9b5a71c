"""Optimizer: Adam with per-parameter-group learning rates (torch).

Counterpart of ``gsjax.train.optim``: the reference's six Adam param
groups with ``eps = 1e-15`` (reference: scene/gaussian_model.py:149-167),
xyz on the exponential-decay schedule scaled by the scene radius, f_rest at
feature_lr / 20, the rest at fixed rates.

gsjax chains ``optax.scale_by_adam`` with a per-leaf learning-rate
transform; the port keeps a ``torch.optim.Adam`` with one named group per
parameter over the state's parameter tensors (so its state and
``state_dict`` have Adam's layout: ``step``, ``exp_avg``, ``exp_avg_sq``),
and its :meth:`GaussianAdam.step` applies optax's update in optax's float32
arithmetic and order, which it updates in place:
``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g g + b2 nu``, the bias
corrections ``1 - b**count`` taken in float32 on the host,
``u = (mu / bc1) / (sqrt(nu / bc2) + eps)``, ``p -= lr u``. Before each
step every group's lr is set from its schedule at ``step = count + 1``
(reference iterations start at 1), as gsjax's ``scale_by_group_lr`` does.

:func:`adam_moments` / :func:`with_adam_moments` read and replace the
moments (densification edits them), and :func:`opt_state_from_numpy` /
:func:`opt_state_to_numpy` carry a mid-training optimizer state over from
gsjax and back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gsjax_torch.models.gaussians import PARAM_KEYS
from gsjax_torch.utils.schedules import expon_lr_schedule

BETAS = (0.9, 0.999)
EPS = 1e-15


def _sqrt_(xs):
    """Correctly rounded float32 square roots of the tensors ``xs``, in
    place, as XLA's and CUDA's ``sqrt`` are. torch's vectorized CPU ``sqrt``
    is not (it misrounds some float32 inputs by one ulp), so on the CPU
    the root is taken in float64 and rounded once: exact, since a double
    carries more than twice float32's digits plus two."""
    if xs and xs[0].device.type == "cuda":
        torch._foreach_sqrt_(xs)
    else:
        for x in xs:
            x.copy_(torch.sqrt(x.double()))


class GaussianAdam(torch.optim.Adam):
    """A ``torch.optim.Adam`` over a state's six parameter tensors, one
    named group each, with the learning rates of ``lr_fns`` (name -> (step
    -> lr)) and optax's update (see the module docstring). ``count`` is the
    number of applied steps (gsjax's lr count); each parameter's
    ``state["step"]`` is Adam's own count (optax's
    ``ScaleByAdamState.count``), a float32 CPU tensor as torch keeps it."""

    def __init__(self, params: Dict[str, torch.Tensor], lr_fns):
        groups = [{"params": [params[k]], "name": k, "lr": float(lr_fns[k](1))}
                  for k in PARAM_KEYS]
        super().__init__(groups, betas=BETAS, eps=EPS)
        self.lr_fns = lr_fns
        self.count = 0

    def set_lrs(self):
        """Set every group's lr from its schedule at ``count + 1``."""
        for group in self.param_groups:
            group["lr"] = float(self.lr_fns[group["name"]](self.count + 1))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.set_lrs()
        b1, b2 = BETAS
        ps, grads, mus, nus, bc1, bc2, lrs = [], [], [], [], [], [], []
        for group in self.param_groups:
            p = group["params"][0]
            if p.grad is None:
                continue
            st = self.state[p]
            if not st:
                st["step"] = torch.zeros((), dtype=torch.float32)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["step"] += 1
            # optax: 1 - decay ** count in float32 (a CPU scalar here: the
            # host's powf is XLA CPU's, bit for bit, and no device sync)
            count = st["step"].float().cpu()
            bc1.append(float(1 - torch.tensor(b1, dtype=torch.float32) ** count))
            bc2.append(float(1 - torch.tensor(b2, dtype=torch.float32) ** count))
            ps.append(p)
            grads.append(p.grad)
            mus.append(st["exp_avg"])
            nus.append(st["exp_avg_sq"])
            lrs.append(group["lr"])
        if not ps:
            self.count += 1
            return loss
        # every product and sum rounds to float32 once, in optax's order;
        # the foreach ops divide by a scalar exactly (no reciprocal)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, sq)
        den = torch._foreach_div(nus, bc2)
        _sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, lrs)
        torch._foreach_sub_(ps, upd)
        self.count += 1
        return loss

    def param(self, name: str) -> torch.Tensor:
        return next(g["params"][0] for g in self.param_groups if g["name"] == name)


class GroupAdam:
    """The optimizer's recipe, as gsjax's ``make_optimizer`` returns an
    optax transformation: :meth:`init` binds it to a parameter dict."""

    def __init__(self, lr_fns):
        self.lr_fns = lr_fns

    def init(self, params: Dict[str, torch.Tensor]) -> GaussianAdam:
        """Make ``params`` leaf tensors that require grad (in place) and
        return the optimizer over them, with zero moments and count 0."""
        for k in PARAM_KEYS:
            params[k].requires_grad_(True)
        return GaussianAdam(params, self.lr_fns)


def make_optimizer(opt_cfg, spatial_lr_scale: float) -> GroupAdam:
    """Build the training optimizer for a Gaussian parameter dict.

    ``opt_cfg`` carries the reference's OptimizationParams fields
    (arguments/__init__.py:71-90)."""
    xyz_sched = expon_lr_schedule(
        lr_init=opt_cfg.position_lr_init * spatial_lr_scale,
        lr_final=opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    )
    return GroupAdam({
        "xyz": xyz_sched,
        "features_dc": lambda _: opt_cfg.feature_lr,
        "features_rest": lambda _: opt_cfg.feature_lr / 20.0,
        "opacity": lambda _: opt_cfg.opacity_lr,
        "scaling": lambda _: opt_cfg.scaling_lr,
        "rotation": lambda _: opt_cfg.rotation_lr,
    })


def adam_moments(opt: GaussianAdam):
    """The first and second moments as two dicts keyed by parameter name
    (zeros before the first step)."""
    mu, nu = {}, {}
    for k in PARAM_KEYS:
        p = opt.param(k)
        st = opt.state.get(p, {})
        mu[k] = st.get("exp_avg", torch.zeros_like(p, memory_format=torch.preserve_format))
        nu[k] = st.get("exp_avg_sq", torch.zeros_like(p, memory_format=torch.preserve_format))
    return mu, nu


def adam_count(opt: GaussianAdam) -> int:
    """Adam's own step count (optax's ``ScaleByAdamState.count``), which
    drives the bias correction: ``opt.count`` unless a checkpoint set it
    apart (a reference checkpoint's Adam steps and its iteration differ)."""
    st = opt.state.get(opt.param("xyz"))
    return int(st["step"]) if st else int(opt.count)


def with_adam_moments(opt: GaussianAdam, mu, nu, count=None) -> GaussianAdam:
    """Replace the moments (after densification); Adam's step count stays
    as it was unless ``count`` sets it. Returns ``opt``."""
    step = torch.tensor(float(adam_count(opt) if count is None else count),
                        dtype=torch.float32)
    for k in PARAM_KEYS:
        p = opt.param(k)
        opt.state[p] = {
            "step": step.clone(),
            "exp_avg": mu[k].detach().to(p.device, torch.float32).clone(),
            "exp_avg_sq": nu[k].detach().to(p.device, torch.float32).clone(),
        }
    return opt


def opt_state_from_numpy(mu, nu, count: int, optimizer: GaussianAdam) -> GaussianAdam:
    """Load gsjax's Adam state into ``optimizer``: ``mu`` and ``nu`` as
    dicts of numpy arrays keyed by parameter name (``adam_moments`` of a
    gsjax ``opt_state``), ``count`` its step count."""
    optimizer.count = int(count)
    return with_adam_moments(
        optimizer,
        {k: torch.from_numpy(np.array(mu[k], np.float32)) for k in PARAM_KEYS},
        {k: torch.from_numpy(np.array(nu[k], np.float32)) for k in PARAM_KEYS},
        count=int(count),
    )


def opt_state_to_numpy(optimizer: GaussianAdam):
    """The inverse of :func:`opt_state_from_numpy`: ``(mu, nu, count)``."""
    mu, nu = adam_moments(optimizer)

    def np_(d):
        return {k: v.detach().cpu().numpy() for k, v in d.items()}

    return np_(mu), np_(nu), int(optimizer.count)


def grow_optimizer(optimizer: GaussianAdam, params: Dict[str, torch.Tensor]) -> GaussianAdam:
    """Carry ``optimizer`` over to the grown ``params`` of
    ``models.gaussians.grow_capacity``: a new optimizer over them with the
    moments zero-padded to the new capacity and the same count (gsjax's
    ``grow_opt_state``, train/loop.py:59-69). Capacity is fixed between
    growths, so the optimizer's parameter tensors stay the state's."""
    mu, nu = adam_moments(optimizer)

    def pad(a, like):
        out = torch.zeros_like(like, dtype=torch.float32)
        out[: a.shape[0]] = a
        return out

    grown = GroupAdam(optimizer.lr_fns).init(params)
    grown.count = optimizer.count
    if not optimizer.state:  # no step taken yet: nothing to carry
        return grown
    return with_adam_moments(grown, {k: pad(mu[k], params[k]) for k in PARAM_KEYS},
                             {k: pad(nu[k], params[k]) for k in PARAM_KEYS},
                             count=adam_count(optimizer))
