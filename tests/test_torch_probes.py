"""The speed-of-light probe and the bench scene of gsjax_torch against
gsjax, on the CPU.

The probe's plain version (``ops/cuda_probe.sol_probe_plain``) against
gsjax's two Pallas ``sol_kernel`` probes. Those are nested in the
measurement sessions' ``main()`` (``scripts/_r4_session.py`` stage ``vpu``,
``scripts/_r5_session.py`` stage ``vpux``), so the test reads each
script's source, takes the ``sol_kernel`` definition out with ``ast`` and
runs it through ``pl.pallas_call`` with the sessions' grid spec in
interpret mode, as gsjax's own kernels run on the CPU. The scripts are
only read.

Under the sessions' exp coefficients an exp pass forgets its input (x
settles to exp's fixed point), so the exp configurations are compared
again with the kernel's exp line rewritten, in the extracted definition
only, to the port's check coefficients (``cuda_probe.check_exp_coefs``),
under which every pass and every chunk shows in the output.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gsjax.ops.pallas_composite import ATTR_W, PIX
from gsjax_torch.bench_scene import bench_camera, toy_scene
from gsjax_torch.ops import cuda_probe as cp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# rtol of the plain version against the TPU probes: both round every
# multiply and add (measured ~2e-7); the 128-lane sums differ in order
RTOL = 1e-5
# per-tile pair counts: empty at an aligned start, 5, empty at an unaligned
# start (one chunk: the window reaches back to the aligned start), 1, 127,
# 128, 130 and 300 (windows of 1 to 3 chunks, several straddling tiles)
COUNTS = (0, 5, 0, 1, 127, 128, 130, 300)


@functools.lru_cache(maxsize=None)
def _tpu_sol_kernel(script, exp_coefs=None):
    """The ``sol_kernel`` FunctionDef of a session script, executed in a
    namespace that holds what its body names. With ``exp_coefs`` (a, b),
    its exp pass ``jnp.exp(-1e-6 * x - (0.1 + j * 1e-7))`` becomes
    ``jnp.exp(a * x - b[j])``."""
    path = os.path.join(ROOT, "scripts", script)
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    defs = [n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef) and n.name == "sol_kernel"]
    assert len(defs) == 1, script
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "PIX": PIX, "ATTR_W": ATTR_W}
    if exp_coefs is not None:
        calls = [n for n in ast.walk(defs[0]) if isinstance(n, ast.Call)
                 and ast.unparse(n.func) == "jnp.exp"]
        assert [ast.unparse(c.args[0]) for c in calls] == ["-1e-06 * x - (0.1 + j * 1e-07)"]
        calls[0].args[0] = ast.parse("_EXP_A * x - _EXP_B[j]", mode="eval").body
        ast.fix_missing_locations(defs[0])
        ns["_EXP_A"], ns["_EXP_B"] = exp_coefs
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns["sol_kernel"]


def _run_tpu_probe(script, tile_start, table, exp_coefs=None, **kw):
    """The sessions' ``pallas_call`` of the probe (``_r4_session.py:356-383``,
    ``_r5_session.py:379-404``), in interpret mode."""
    num_t = tile_start.shape[0] - 1
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(num_t,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.MemorySpace.HBM)],
        out_specs=pl.BlockSpec((1, 1, PIX), lambda t, *_: (t, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, ATTR_W, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
    )
    out = pl.pallas_call(
        functools.partial(_tpu_sol_kernel(script, exp_coefs), **kw),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((num_t, 1, PIX), jnp.float32),
        interpret=True,
    )(jnp.asarray(tile_start), jnp.asarray(table))
    return np.asarray(out)[:, 0, :]


@pytest.fixture(scope="module")
def probe_inputs():
    tile_start = torch.tensor(np.concatenate([[0], np.cumsum(COUNTS)]), dtype=torch.int32)
    return tile_start, cp.sol_probe_inputs(tile_start, seed=3)


@pytest.mark.parametrize("script,kw", [
    ("_r4_session.py", dict(k_ops=4)),
    ("_r4_session.py", dict(k_ops=40)),
    ("_r5_session.py", dict(k_ops=20, k_exp=0, use_while=False)),
    ("_r5_session.py", dict(k_ops=20, k_exp=5, use_while=False)),
    ("_r5_session.py", dict(k_ops=20, k_exp=10, use_while=False)),
    ("_r5_session.py", dict(k_ops=20, k_exp=0, use_while=True)),
    ("_r5_session.py", dict(k_ops=20, k_exp=5, use_while=True)),
    ("_r5_session.py", dict(k_ops=20, k_exp=10, use_while=True)),
], ids=["r4-k4", "r4-k40", "r5-f20e0", "r5-f20e5", "r5-f20e10", "r5-w20e0", "r5-w20e5",
        "r5-w20e10"])
def test_plain_probe_matches_tpu_probe(probe_inputs, script, kw):
    tile_start, table = probe_inputs
    assert tuple(table.shape) == (7, ATTR_W, 128)  # 691 pairs + (-691) % 128 + 128
    want = _run_tpu_probe(script, tile_start.numpy(), table.numpy(), **kw)
    got = cp.sol_probe_plain(tile_start, table, kw["k_ops"], kw.get("k_exp", 0)).numpy()
    assert got.shape == want.shape == (len(COUNTS), PIX)
    assert np.all(want[0] == 0.0) and np.all(got[0] == 0.0)  # the empty aligned tile
    assert np.all(want[2] != 0.0)  # the empty unaligned tile runs one chunk
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("k_exp", [5, 10])
@pytest.mark.parametrize("use_while", [False, True], ids=["f", "w"])
def test_plain_probe_matches_tpu_probe_check_coefs(probe_inputs, use_while, k_exp):
    """The exp configurations again, under the check coefficients, where
    the output depends on every pass and chunk."""
    tile_start, table = probe_inputs
    coefs = cp.check_exp_coefs(20)
    want = _run_tpu_probe("_r5_session.py", tile_start.numpy(), table.numpy(), exp_coefs=coefs,
                          k_ops=20, k_exp=k_exp, use_while=use_while)
    got = cp.sol_probe_plain(tile_start, table, 20, k_exp, coefs).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("k_exp", [5, 10])
def test_check_coefs_expose_each_pass_and_chunk(probe_inputs, k_exp):
    """Under the sessions' exp coefficients a pass too few, a multiply-add
    pass too few or rows from the wrong chunks change no tile by 1e-6
    relative; under the check coefficients each changes every non-empty tile
    by more than 100 x the card's tolerance (2e-5)."""
    tile_start, table = probe_inputs
    shifted = table.clone()
    shifted[:, 0] = shifted[:, 0].roll(1, 0)

    def min_change(coefs):
        want = cp.sol_probe_plain(tile_start, table, 20, k_exp, coefs)
        faults = (cp.sol_probe_plain(tile_start, table, 20, k_exp - 1, coefs),
                  cp.sol_probe_plain(tile_start, table, 19, k_exp, coefs),
                  cp.sol_probe_plain(tile_start, shifted, 20, k_exp, coefs))
        live = want[:, 0] != 0.0
        return min(float(((f - want).abs() / want.abs())[live].min()) for f in faults)

    assert min_change(cp.PROBE_EXP) < 1e-6
    assert min_change(cp.check_exp_coefs(20)) > 100 * 2e-5


def test_probe_wrapper_on_cpu(probe_inputs):
    tile_start, table = probe_inputs
    for k_ops, k_exp in cp.SWEPT:
        assert torch.equal(cp.sol_probe(tile_start, table, k_ops, k_exp),
                           cp.sol_probe_plain(tile_start, table, k_ops, k_exp))
    with pytest.raises(ValueError, match="no kernel instance"):
        cp.sol_probe(tile_start, table, 8, 0)
    with pytest.raises(ValueError, match="no kernel instance"):
        cp.sol_probe(tile_start, table, 20, 2)
    with pytest.raises(ValueError, match="tile_start"):
        cp.sol_probe(tile_start.long(), table, 4, 0)
    with pytest.raises(ValueError, match="table"):
        cp.sol_probe(tile_start, table.double(), 4, 0)
    with pytest.raises(ValueError, match="table"):
        cp.sol_probe(tile_start, table[:, :4].contiguous(), 4, 0)
    with pytest.raises(ValueError, match="contiguous"):
        cp.sol_probe(tile_start, table.transpose(0, 1).contiguous().transpose(0, 1), 4, 0)
    with pytest.raises(ValueError, match="past the table"):
        cp.sol_probe_plain(tile_start, table[:3].contiguous(), 4, 0)
    with pytest.raises(ValueError, match="offsets"):
        cp.sol_probe(tile_start, table, 20, 5, (-1.0, (0.0,) * 5))
    # the plain version takes any pair
    assert cp.sol_probe_plain(tile_start, table, 3, 1).shape == (len(COUNTS), PIX)
    coefs = cp.check_exp_coefs(20)
    assert torch.equal(cp.sol_probe(tile_start, table, 20, 10, coefs),
                       cp.sol_probe_plain(tile_start, table, 20, 10, coefs))


def test_probe_work_counts_the_windows(probe_inputs):
    from gsjax_torch.utils.profiling import sol_probe_work

    tile_start, _ = probe_inputs
    # windows: 0, 1, 1, 1, 2, 2, 2, 3 chunks
    chunks = 12
    bytes_, ops, elements, exps = sol_probe_work(tile_start, 20, 5)
    assert elements == chunks * PIX * 128
    assert ops == elements * (1 + 2 * 20 + 3 * 5)
    assert exps == elements * 5
    assert bytes_ == chunks * 512 + 9 * 4 + 8 * PIX * 4


def test_toy_scene_equals_gsjax():
    from __graft_entry__ import _toy_scene

    for log_scale in (-2.5, -5.2):
        jstate, jcam = _toy_scene(3000, 4096, 176, 104, seed=1, log_scale=log_scale)
        tstate, tcam = toy_scene(3000, 4096, 176, 104, seed=1, log_scale=log_scale,
                                 device="cpu")
        assert set(tstate.params) == set(jstate.params)
        for k, v in jstate.params.items():
            assert np.array_equal(tstate.params[k].numpy(), np.asarray(v)), k
        assert np.array_equal(tstate.active.numpy(), np.asarray(jstate.active))
        assert tstate.active_sh_degree == int(jstate.active_sh_degree)
        assert tstate.capacity == 4096
        for f in ("R", "T"):
            assert np.array_equal(getattr(tcam, f), getattr(jcam, f)), f
        for f in ("fov_x", "fov_y", "width", "height"):
            assert getattr(tcam, f) == getattr(jcam, f), f
    # the turned and moved poses of the smoke test keep the intrinsics
    cam = bench_camera(64, 48, yaw=0.01, shift=(0.02, 0.0, 0.0))
    assert cam.fov_y == 0.9 * 48 / 64 and np.allclose(cam.R @ cam.R.T, np.eye(3))
