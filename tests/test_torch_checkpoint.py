"""gsjax_torch's checkpoints against gsjax's, on the CPU: a gsjax ``.npz``
loads into the port and a port ``.npz`` into gsjax, bit for bit, and a
reference ``.pth`` (the ``capture()`` tuple, written here with
``torch.save``) loads into both alike. Same numpy inputs from seeds on both
sides."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from gsjax.configs import OptimizationParams as JOpt
from gsjax_torch.configs import OptimizationParams as TOpt
from test_torch_densify import _carry_stats, _dense_state, _moments, one_torch_thread  # noqa: F401

KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def _j_template(cap, max_sh, lr_scale):
    from gsjax.models.gaussians import create_empty
    from gsjax.train.optim import make_optimizer

    s = create_empty(cap, max_sh, lr_scale)
    return s, make_optimizer(JOpt(), lr_scale).init(s.params)


def _t_template(cap, max_sh, lr_scale):
    from gsjax_torch.models.gaussians import create_empty
    from gsjax_torch.train.optim import make_optimizer

    s = create_empty(cap, max_sh, lr_scale, device="cpu")
    return s, make_optimizer(TOpt(), lr_scale).init(s.params)


def _assert_same(tstate, topt, jstate, jopt):
    from gsjax_torch.train.optim import adam_count, adam_moments

    assert tstate.capacity == jstate.capacity
    assert tstate.max_sh_degree == jstate.max_sh_degree
    assert tstate.spatial_lr_scale == jstate.spatial_lr_scale
    assert tstate.active_sh_degree == int(jstate.active_sh_degree)
    for k in KEYS:
        np.testing.assert_array_equal(tstate.params[k].detach().numpy(),
                                      np.asarray(jstate.params[k]), err_msg=k)
    for k in ("active", "max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_array_equal(getattr(tstate, k).numpy(),
                                      np.asarray(getattr(jstate, k)), err_msg=k)
    mu, nu = adam_moments(topt)
    for k in KEYS:
        np.testing.assert_array_equal(mu[k].numpy(), np.asarray(jopt[0].mu[k]), err_msg=k)
        np.testing.assert_array_equal(nu[k].numpy(), np.asarray(jopt[0].nu[k]), err_msg=k)
    assert adam_count(topt) == int(jopt[0].count)
    assert topt.count == int(jopt[1].count)
    assert all(topt.param(k) is tstate.params[k] for k in KEYS)


def _j_opt(jstate, seed, adam_steps, lr_steps):
    from gsjax.train.optim import make_optimizer

    mu, nu = _moments(jstate, seed)
    o = make_optimizer(JOpt(), jstate.spatial_lr_scale).init(jstate.params)
    adam = o[0]._replace(count=jnp.int32(adam_steps),
                         mu={k: jnp.asarray(v) for k, v in mu.items()},
                         nu={k: jnp.asarray(v) for k, v in nu.items()})
    return (adam, o[1]._replace(count=jnp.int32(lr_steps))) + tuple(o[2:])


def test_gsjax_checkpoint_loads_in_the_port(tmp_path):
    from gsjax.train.checkpoint import save_checkpoint as j_save
    from gsjax_torch.train.checkpoint import load_checkpoint

    jstate = dataclasses.replace(_dense_state(200, 256, seed=11), spatial_lr_scale=2.5,
                                 active_sh_degree=jnp.int32(2))
    jopt = _j_opt(jstate, 12, adam_steps=40, lr_steps=43)
    path = str(tmp_path / "chkpnt43.npz")
    j_save(path, jstate, jopt, 43)
    tstate, topt, it = load_checkpoint(path, _t_template)
    assert it == 43
    _assert_same(tstate, topt, jstate, jopt)


def test_port_checkpoint_loads_in_gsjax(tmp_path):
    from gsjax.train.checkpoint import load_checkpoint as j_load
    from gsjax_torch.train.checkpoint import save_checkpoint
    from gsjax_torch.train.optim import (
        adam_moments, make_optimizer, opt_state_from_numpy, with_adam_moments,
    )

    jstate = _dense_state(150, 256, seed=13)
    tstate = dataclasses.replace(_carry_stats(jstate), spatial_lr_scale=1.5,
                                 active_sh_degree=1)
    mu, nu = _moments(jstate, 14)
    topt = opt_state_from_numpy(mu, nu, 21, make_optimizer(TOpt(), 1.5).init(tstate.params))
    topt = with_adam_moments(topt, *adam_moments(topt), count=17)  # Adam's own count
    path = str(tmp_path / "chkpnt21.npz")
    save_checkpoint(path, tstate, topt, 21)
    js, jo, it = j_load(path, _j_template)
    assert it == 21
    _assert_same(tstate, topt, js, jo)


def _reference_pth(path, n=90, seed=15):
    """A reference checkpoint: ``torch.save((capture(), iteration))`` with
    the optimizer state of a named-group ``torch.optim.Adam`` after three
    steps (reference scene/gaussian_model.py:61-75, 149-162)."""
    rng = np.random.default_rng(seed)
    shapes = {"xyz": (n, 3), "f_dc": (n, 1, 3), "f_rest": (n, 15, 3), "scaling": (n, 3),
              "rotation": (n, 4), "opacity": (n, 1)}
    ps = {k: torch.nn.Parameter(torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)))
          for k, s in shapes.items()}
    adam = torch.optim.Adam([{"params": [p], "lr": 1e-3, "name": k} for k, p in ps.items()],
                            eps=1e-15)
    for _ in range(3):
        for p in ps.values():
            p.grad = torch.from_numpy(rng.normal(0, 1e-3, p.shape).astype(np.float32))
        adam.step()
    capture = (2, ps["xyz"], ps["f_dc"], ps["f_rest"], ps["scaling"], ps["rotation"],
               ps["opacity"], torch.from_numpy(rng.uniform(0, 9, n).astype(np.float32)),
               torch.from_numpy(rng.uniform(0, 1e-3, (n, 1)).astype(np.float32)),
               torch.from_numpy(rng.integers(0, 5, (n, 1)).astype(np.float32)),
               adam.state_dict(), 3.25)
    torch.save((capture, 1200), path)


def test_reference_checkpoint_loads_like_gsjax(tmp_path):
    from gsjax.train.checkpoint import load_reference_checkpoint as j_load_ref
    from gsjax_torch.train.checkpoint import load_reference_checkpoint
    from gsjax_torch.train.optim import adam_count

    path = str(tmp_path / "chkpnt1200.pth")
    _reference_pth(path)
    js, jo, jit = j_load_ref(path, _j_template)
    ts, to, it = load_reference_checkpoint(path, _t_template)
    assert it == jit == 1200 and ts.capacity == 128
    _assert_same(ts, to, js, jo)
    assert adam_count(to) == 3 and to.count == 1200
    # the loaded optimizer steps on from there
    for v in ts.params.values():
        v.grad = torch.full_like(v, 1e-4)
    to.step()
    assert to.count == 1201 and adam_count(to) == 4
    assert bool(torch.isfinite(ts.params["xyz"]).all())
