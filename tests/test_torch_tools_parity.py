"""PyTorch port: ``tools/parity_check`` (the port's loss curve against
JAX's committed 1000-step curves).

* ``seeded_unet_state``: the diffusers keys and shapes of the tiny UNet,
  torch's default-init bounds, unit norm scales and zero norm biases; JAX
  loads it strictly (``hf_to_flax_params``); each fixture records the
  sha256 of the start it ran from.
* The port's ``run_port`` on the CPU tracks the first 40 steps of each
  fixture (ddpm at seed 42, flow matching at seed 7, the seeds of
  ``tests/test_loss_parity.py``) at rel <= 1e-4, the bar that test holds
  JAX to the torch twin at (100x tighter than the north star's 1%).
* JAX's train step regenerated live for 10 ddpm steps equals the
  fixture's first 10 (rtol 1e-6: the same program on the same CPU).
* ``compare`` / ``compare_curves`` give JAX ``tools/parity_check.py``'s
  numbers and exit codes.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu_torch.models.unet import (
    SDXLUNet, UNetConfig)
from sdxl_training_improvements_tpu_torch.tools import parity_check as P

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under six xdist workers a pool the size of
    the host slows the tiny model's steps many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(method, seed):
    return json.loads(P.fixture_path(method, seed).read_text())


def test_seeded_state_is_torch_default_init():
    cfg = UNetConfig.tiny()
    state = P.seeded_unet_state(cfg, 42)
    with torch.device("meta"):
        unet = SDXLUNet(cfg)
    ref = unet.state_dict()
    assert list(state) == sorted(ref)
    for k, v in state.items():
        assert v.dtype == np.float32 and v.shape == tuple(ref[k].shape), k
        owner = ref.get(k.rsplit(".", 1)[0] + ".weight")
        if owner is not None and owner.ndim >= 2:
            bound = float(np.prod(owner.shape[1:])) ** -0.5
            assert np.abs(v).max() <= bound and np.abs(v).max() > 0.5 * bound
        elif k.endswith(".weight"):
            assert (v == 1).all(), k
        else:
            assert (v == 0).all(), k
    again = P.seeded_unet_state(cfg, 42)
    assert all(np.array_equal(state[k], again[k]) for k in state)
    assert P.state_digest(state) != P.state_digest(
        P.seeded_unet_state(cfg, 7))


@pytest.mark.parametrize("method,seed", P.CURVES)
def test_fixture_records_its_start(method, seed):
    fx = _fixture(method, seed)
    assert fx["impl"] == "jax" and fx["method"] == method
    assert fx["seed"] == seed and len(fx["losses"]) == fx["steps"] == 1000
    assert np.isfinite(fx["losses"]).all()
    assert fx["start_sha256"] == P.state_digest(
        P.seeded_unet_state(UNetConfig.tiny(), seed))


def test_jax_loads_the_seeded_state_strictly():
    import jax
    import jax.numpy as jnp
    from sdxl_training_improvements_tpu.models import weights as JW
    from sdxl_training_improvements_tpu.models.unet import (
        SDXLUNet as JUNet, UNetConfig as JUNetConfig)
    ucfg = JUNetConfig.tiny()
    unet = JUNet(config=ucfg, dtype=jnp.float32, param_dtype=jnp.float32)
    template = jax.eval_shape(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16)), jnp.zeros((1,)),
        jnp.zeros((1, 77, ucfg.cross_attention_dim)),
        jnp.zeros((1, ucfg.pooled_embed_dim)), jnp.zeros((1, 6))))
    state = P.seeded_unet_state(UNetConfig.tiny(), 42)
    params = JW.hf_to_flax_params(template, state, strict=True)
    assert len(jax.tree_util.tree_leaves(params)) == len(state)


@pytest.mark.parametrize("method,seed", P.CURVES)
def test_port_curve_tracks_jax_fixture(method, seed):
    steps = 40
    ref = _fixture(method, seed)["losses"][:steps]
    got = P.run_port(steps, seed, method=method, device="cpu")
    out = P.compare_curves(ref, got)
    assert out["steps_compared"] == steps
    assert out["max_rel_divergence"] <= 1e-4, out


def test_fixture_regenerates_from_jax():
    from tools.make_parity_fixtures import run_jax
    losses, digest = run_jax(10, 42, method="ddpm")
    fx = _fixture("ddpm", 42)
    assert digest == fx["start_sha256"]
    np.testing.assert_allclose(losses, fx["losses"][:10], rtol=1e-6, atol=0)


def test_compare_matches_jax_tool(tmp_path, capsys):
    from tools import parity_check as JP
    a = _fixture("ddpm", 42)["losses"][:50]
    rng = np.random.default_rng(0)
    for scale, rc in ((1e-3, 0), (3e-2, 1)):
        b = list(np.asarray(a) * (1 + scale * rng.standard_normal(50)))
        pa, pb = tmp_path / "a.json", tmp_path / "b.json"
        pa.write_text(json.dumps({"losses": a}))
        pb.write_text(json.dumps({"losses": b}))
        assert JP.compare(str(pa), str(pb)) == rc
        jax_out = json.loads(capsys.readouterr().out)
        assert P.compare(str(pa), str(pb)) == rc
        ours = json.loads(capsys.readouterr().out)
        for k in ("steps_compared", "max_rel_divergence",
                  "mean_rel_divergence", "within_1pct"):
            assert ours[k] == pytest.approx(jax_out[k], rel=1e-12), k
        assert (ours["steps_over_tol"] == []) == (rc == 0)


def test_cli_writes_curve_and_comparison(tmp_path):
    out = tmp_path / "port.json"
    rc = P.main(["--method", "flow_matching", "--seed", "7", "--steps", "3",
                 "--device", "cpu", "--out", str(out), "--against",
                 str(P.fixture_path("flow_matching", 7))])
    got = json.loads(out.read_text())
    assert rc == 0 and got["card"] is None and len(got["losses"]) == 3
    assert got["comparison"]["max_rel_divergence"] <= 1e-4
