"""PyTorch port: the trainer with schedule-free, SOAP and int8 moments
against the JAX ``SDXLTrainer`` on the CPU.

Both trainers train the same seeded tiny UNet over one cache read by both
packages, the batches replaying the same noise and timesteps
(``tests/test_torch_loop_features.py``'s helpers), 2 epochs of 2 steps:

* schedule-free (fp32): every step's loss at rtol 2e-4 (the bar of
  ``tests/test_torch_loop.py``; the losses are ~1e-6, so no atol), and the
  trained parameters and the evaluated x at rtol 2e-4 / atol 2e-5.  The
  JAX trainer's z starts as ``p.astype(f32)``, which for an fp32 UNet is
  the parameter's own buffer, and its donating step refuses the alias:
  the test hands JAX's trainer a copy of z.
* SOAP (fp32, ``max_precond_dim`` 16, ``precondition_frequency`` 2: the
  install, an Adam step and a QR refresh): every step's loss at rtol 2e-4,
  the parameters at rtol 2e-4 / atol 2e-5.  LAPACK in JAX and in torch may
  pick other signs, and in a degenerate eigenspace another rotation; only
  axes of at most 16 are preconditioned here, whose GG (the 3x3 kernels'
  9, the latents' 4) is full rank after the first step, so the update does
  not depend on the pick.  A wider axis of a leaf fed by one vector a
  sample (the time embeddings) has a rank-2 GG at batch 2.
* int8 moments (bf16 UNet, ``adamw_bf16`` with hash noise): the port's
  optimizer starts from JAX's state (its decay phases); each step's loss at
  rtol 5e-3, and the decoded moments after the run, m and v each within
  0.15 relative L2 of JAX's (measured: losses 5.4e-4 to 1.8e-3 apart, the
  moments 0.046 and 0.070).  Bit-equality cannot hold here: the two
  packages' bf16 forwards round at other places (the first loss, before
  any update, differs by 6.1e-4), and the counter-hash noise is indexed by
  each element's place in its package's own layout (a kernel is [in, out]
  in JAX, [out, in] in the port), so the roundings draw differently and
  the bf16 parameters drift apart by whole steps.  A decode in the wrong
  decade or of the wrong sign moves a moment by far more than 0.15.  The
  int8 update itself is held bit-equal to JAX's, seeds injected, in
  ``tests/test_torch_optim_extra.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_training_improvements_tpu_torch.models.weights import (
    from_jax_opt_state, from_jax_params)
from sdxl_training_improvements_tpu_torch.ops.quantize import dequantize_8bit
from sdxl_training_improvements_tpu_torch.training.optimizers import (
    SOAPState, ScheduleFreeKahanState, schedule_free_eval_params)
from test_torch_loop_features import _recording, _trainers

RTOL, ATOL = 2e-4, 2e-5
INT8_LOSS_RTOL, INT8_MOMENT_REL_L2 = 5e-3, 0.15

CASES = {
    "schedule_free": ({"optimizer_type": "adamw_schedule_free_kahan",
                       "warmup_steps": 1}, "no"),
    "soap": ({"optimizer_type": "soap", "precondition_frequency": 2,
              "max_precond_dim": 16}, "no"),
    "int8": ({"optimizer_type": "adamw_bf16", "moments_8bit": True},
             "bf16"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in ``tests/test_torch_loop_features.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_params(jparams):
    return from_jax_params(_host(jparams))


def _moment_rel_l2(tt, jstate, name: str) -> float:
    """Relative L2 of the decoded int8 moment ``name`` over the bf16
    leaves, the port's against JAX's."""
    ref = getattr(from_jax_opt_state(_host(jstate._replace(key=None)),
                                     like=tt.state.params), name)
    got = getattr(tt.state.opt_state, name)
    signed = name == "exp_avg"
    num = den = 0.0
    for k, p in tt.state.params.items():
        if p.dtype != torch.bfloat16:
            continue
        assert isinstance(got[k], dict) and got[k]["q"].dtype == torch.uint8
        a = dequantize_8bit(got[k], signed, torch.float32).double()
        b = dequantize_8bit(ref[k], signed, torch.float32).double()
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    return (num / den) ** 0.5


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_trainer_matches_jax(tmp_path, case):
    optimizer, precision = CASES[case]
    jt, tt = _trainers(tmp_path, optimizer, {}, precision)
    if case == "schedule_free":
        st = jt.state.opt_state
        jt.state = jt.state._replace(opt_state=st._replace(
            z=jax.tree_util.tree_map(jnp.copy, st.z)))
    if case == "int8":
        tt.state.opt_state = from_jax_opt_state(  # JAX's decay phases
            _host(jt.state.opt_state._replace(key=None)),
            like=tt.state.params)
    jlosses, tlosses = [], []
    _recording(jt, jlosses)
    _recording(tt, tlosses)
    jt.train()
    tt.train()
    assert len(tlosses) == len(jlosses) == 4
    assert tt.state.step == 4
    ref = _port_params(jt.state.params)
    assert set(ref) == set(tt.state.params)
    if case == "int8":
        np.testing.assert_allclose(tlosses, jlosses, rtol=INT8_LOSS_RTOL,
                                   atol=0)
        for name in ("exp_avg", "exp_avg_sq"):
            assert _moment_rel_l2(tt, jt.state.opt_state, name) <= \
                INT8_MOMENT_REL_L2, name
        return
    np.testing.assert_allclose(tlosses, jlosses, rtol=RTOL, atol=0)
    for k, v in ref.items():
        np.testing.assert_allclose(tt.state.params[k].detach().numpy(),
                                   v.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    if case == "schedule_free":
        assert isinstance(tt.state.opt_state, ScheduleFreeKahanState)
        x = schedule_free_eval_params(tt.state.opt_state, tt.state.params)
        for k, v in _port_params(jt.eval_params()).items():
            np.testing.assert_allclose(x[k].detach().numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    else:
        assert isinstance(tt.state.opt_state, SOAPState)
        assert any(m.numel() for ms in tt.state.opt_state.gg.values()
                   for m in ms)
