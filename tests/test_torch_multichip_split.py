"""``python -m gsjax_torch.multichip_split`` against gsjax's primitives on the
CPU: two gloo ranks run the port's sharded path up to binning on a small
bench scene, and their per-rank counts equal those of gsjax's
``scripts/multichip_split.py`` ``probe`` (preprocess, ``_exchange_splats``
and ``build_tile_bins`` in a ``shard_map`` on 2 of the conftest's virtual
CPU devices). The probe is taken from the script's source with ``ast``: it
is a closure inside the script's ``main``."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(n=6000, capacity=8192, width=128, height=128)


def _gsjax_counts(G, exchange, mp_total, mult, mt):
    import functools

    import jax
    import jax.numpy as jnp
    from jax import lax, shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from __graft_entry__ import _toy_scene
    from gsjax.models.gaussians import activated_params
    from gsjax.ops.binning import build_tile_bins
    from gsjax.ops.projection import num_tiles, preprocess
    from gsjax.ops.rasterize import RasterizeSettings
    from gsjax.parallel.shard import _a2a_rows_auto, _cdiv, _exchange_splats, shard_gaussian_state

    settings = RasterizeSettings(max_pairs=mp_total, expansion="compact",
                                 splat_exchange=exchange, max_tiles_per_gauss=mt)
    tiles_x, tiles_y = num_tiles(SCENE["width"], SCENE["height"])
    strips_y = _cdiv(tiles_y, G)
    mp_strip = max(_cdiv(int(settings.max_pairs // G * mult), 128) * 128, 1024)
    state, cam = _toy_scene(n=SCENE["n"], capacity=SCENE["capacity"], width=SCENE["width"],
                            height=SCENE["height"], log_scale=-5.2)
    mesh = Mesh(np.array(jax.devices()[:G]).reshape(G), ("gauss",))
    state = shard_gaussian_state(state, mesh)
    with open(os.path.join(ROOT, "scripts", "multichip_split.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "probe")
    ns = dict(functools=functools, shard_map=shard_map, mesh=mesh, P=P, jax=jax, jnp=jnp,
              lax=lax, activated_params=activated_params, preprocess=preprocess,
              settings=settings, G=G, _a2a_rows_auto=_a2a_rows_auto,
              _exchange_splats=_exchange_splats, strips_y=strips_y, tiles_x=tiles_x,
              build_tile_bins=build_tile_bins, mp_strip=mp_strip)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "multichip_split.py", "exec"), ns)
    rows = np.asarray(jax.jit(ns["probe"])(state.params, state.active, state.active_sh_degree,
                                           cam.to_render_camera()))
    keys = ("visible_splats", "src_pairs", "recv_rows", "recv_buf_rows", "strip_pairs",
            "bin_dropped", "exchange_dropped")
    return [dict(zip(keys, map(int, r))) for r in rows], mp_strip


@pytest.mark.parametrize("exchange,mp_total,mult,mt", [
    ("a2a", 4096, 1.2, 16),  # a budget short of the pairs: strips drop
    ("all_gather", 1 << 16, 1.0, 2),  # a tile cap of 2: capped pairs drop
], ids=["a2a", "all_gather"])
def test_split_counts_equal_gsjax(tmp_path, exchange, mp_total, mult, mt):
    out = str(tmp_path / "split.json")
    res = subprocess.run(
        [sys.executable, "-m", "gsjax_torch.multichip_split", "--device", "cpu", "--ranks", "2",
         "--exchange", exchange, "--max_pairs", str(mp_total), "--strip_budget_mult", str(mult),
         "--max_tiles_per_gauss", str(mt), "--gaussians", str(SCENE["n"]),
         "--capacity", str(SCENE["capacity"]), "--width", str(SCENE["width"]),
         "--height", str(SCENE["height"]), "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    with open(out) as f:
        assert json.load(f) == report
    want, mp_strip = _gsjax_counts(2, exchange, mp_total, mult, mt)
    assert report["per_chip"] == want
    assert report["operating_point"]["max_pairs_per_strip"] == mp_strip
    assert sum(c["bin_dropped"] for c in want) > 0  # the drop counters are exercised
    assert "projection" not in report  # no card, no measured phase times
    assert report["balance"]["total_strip_pairs"] == sum(c["strip_pairs"] for c in want)
