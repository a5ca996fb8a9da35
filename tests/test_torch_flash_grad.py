"""The flash path's backward against the JAX package's, on the CPU.

The JAX package makes its Pallas flash kernel differentiable with
``_flash_with_vjp``: a ``jax.custom_vjp`` whose backward recomputes
attention through ``reference_mha`` under ``jax.vjp`` from q, k and v
alone.  The port's ``flash_attention`` does the same with a
``torch.autograd.Function`` whose backward is ``flash_attention_backward``.

The oracle is ``jax.vjp`` of the JAX ``mha``/``gqa_mha`` with
``impl="pallas_interpret"`` (the Pallas kernel in interpret mode, as
``tests/test_ops.py`` runs it here), on the same numpy inputs and
cotangent.  Tolerance 1e-3, that of ``tests/test_ops.py``'s
``test_flash_gradients``.

The kernel itself runs only on the card; to test the Function's wiring
here (saved tensors, gradients landing in the parent of strided head
views, one forward launch, no Function under ``no_grad``), the launch is
replaced by the plain version through ``monkeypatch``.  The same contract
on the card is in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.ops.attention import gqa_mha as jax_gqa_mha
from distributed_llm_scheduler_tpu.ops.attention import mha as jax_mha
from distributed_llm_scheduler_tpu_torch.ops import attention as A
from distributed_llm_scheduler_tpu_torch.ops import kernels

TOL = 1e-3  # tests/test_ops.py test_flash_gradients


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_vjp(fn, arrays, cot):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_jax_vjp(causal):
    shape = (1, 2, 32, 16)
    q, k, v, cot = _arrays([shape] * 4, seed=11 + causal)
    want = _jax_vjp(lambda q, k, v: jax_mha(q, k, v, causal=causal,
                                            impl="pallas_interpret"),
                    (q, k, v), cot)
    got = A.flash_attention_backward(
        *(torch.from_numpy(a) for a in (q, k, v, cot)), causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() < TOL, name


@pytest.mark.parametrize("causal", [True, False])
def test_backward_gqa_sums_each_group(causal):
    """Hq 4 over Hkv 2: dk and dv come back with 2 heads, as ``jax.vjp``
    of the JAX ``gqa_mha`` (which repeats K/V inside the graph) gives."""
    q, cot = _arrays([(1, 4, 32, 16)] * 2, seed=21)
    k, v = _arrays([(1, 2, 32, 16)] * 2, seed=22)
    want = _jax_vjp(lambda q, k, v: jax_gqa_mha(q, k, v, causal=causal,
                                                impl="pallas_interpret"),
                    (q, k, v), cot)
    got = A.flash_attention_backward(
        *(torch.from_numpy(a) for a in (q, k, v, cot)), causal=causal)
    assert got[1].shape == got[2].shape == (1, 2, 32, 16)
    for name, g, w in zip("qkv", got, want):
        assert np.abs(g.numpy() - w).max() < TOL, name


def test_backward_takes_a_scale():
    q, k, v, cot = _arrays([(1, 2, 32, 16)] * 4, seed=5)
    want = _jax_vjp(lambda q, k, v: jax_mha(q, k, v, sm_scale=0.3,
                                            impl="pallas_interpret"),
                    (q, k, v), cot)
    got = A.flash_attention_backward(
        *(torch.from_numpy(a) for a in (q, k, v, cot)), sm_scale=0.3)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() < TOL


@pytest.fixture
def plain_launch(monkeypatch):
    """The kernel launch replaced by the plain version (K/V repeated for
    GQA), counted as the launcher counts; returns the list of calls."""
    calls = []

    def launch(q, k, v, causal, sm_scale):
        calls.append(q.shape)
        g = q.shape[1] // k.shape[1]
        return A.reference_mha(q, k.repeat_interleave(g, 1),
                               v.repeat_interleave(g, 1), causal, sm_scale)

    monkeypatch.setattr(A, "_flash_forward", launch)
    return calls


def _fused_qkv_loss(x, attend, H, hd, cot):
    """GPT-2's layout: q, k and v are strided head views of one (B, T,
    3*H*hd) product; the loss is <attention output, cot>."""
    B, T, _ = x.shape
    q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2)
               for t in x.split(H * hd, dim=-1))
    return (attend(q, k, v) * cot).sum()


def test_function_grads_land_in_the_fused_parent(plain_launch):
    B, T, H, hd = 2, 32, 2, 16
    x_np, cot_np = _arrays([(B, T, 3 * H * hd), (B, H, T, hd)], seed=31)

    def jax_loss(x):
        q, k, v = (t.reshape(B, T, H, hd).transpose(0, 2, 1, 3)
                   for t in jnp.split(x, 3, axis=-1))
        out = jax_mha(q, k, v, impl="pallas_interpret")
        return (out * jnp.asarray(cot_np)).sum()

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x_np)))
    x = torch.from_numpy(x_np).requires_grad_()
    loss = _fused_qkv_loss(x, A.flash_attention, H, hd,
                           torch.from_numpy(cot_np))
    loss.backward()
    assert len(plain_launch) == 1  # one forward launch, none in backward
    assert x.grad.shape == x.shape
    assert np.abs(x.grad.numpy() - want).max() < TOL


def test_function_gqa_grads_at_kv_heads(plain_launch):
    q_np, cot_np = _arrays([(1, 4, 32, 16)] * 2, seed=41)
    k_np, v_np = _arrays([(1, 2, 32, 16)] * 2, seed=42)
    want = _jax_vjp(lambda q, k, v: jax_gqa_mha(q, k, v,
                                                impl="pallas_interpret"),
                    (q_np, k_np, v_np), cot_np)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q_np, k_np, v_np))
    (A.flash_attention(q, k, v) * torch.from_numpy(cot_np)).sum().backward()
    assert len(plain_launch) == 1
    for name, t, w in zip("qkv", (q, k, v), want):
        assert t.grad.shape == w.shape, name
        assert np.abs(t.grad.numpy() - w).max() < TOL, name


def test_residual_path_keeps_the_attention_term(plain_launch):
    """A loss that reaches q through attention and a residual: the
    attention term must not be dropped (the fault the Function fixes)."""
    q_np, k_np, v_np = _arrays([(1, 2, 32, 16)] * 3, seed=51)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q_np, k_np, v_np))
    (A.flash_attention(q, k, v) + q).sum().backward()
    qr = torch.from_numpy(q_np).requires_grad_()
    (A.reference_mha(qr, torch.from_numpy(k_np), torch.from_numpy(v_np))
     + qr).sum().backward()
    assert torch.allclose(q.grad, qr.grad, atol=1e-5)
    assert (q.grad - 1).abs().max() > 1e-3  # not the residual's ones alone


def test_no_grad_takes_no_function(plain_launch):
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _arrays([(1, 2, 32, 16)] * 3, seed=61))
    with torch.no_grad():
        out = A.flash_attention(q, k, v)
    assert out.grad_fn is None and len(plain_launch) == 1
    out = A.flash_attention(q.detach(), k.detach(), v.detach())
    assert out.grad_fn is None and len(plain_launch) == 2
    out = A.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert len(plain_launch) == 3


def test_cpu_tensors_never_reach_the_launcher():
    """Without the replacement, a CPU call that needs grad still refuses
    the launcher's CPU input; ``mha`` on the CPU takes the plain version,
    differentiable as it is, and counts no launch."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _arrays([(1, 2, 32, 32)] * 3, seed=71))
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_attention(q, k, v)
    before = kernels.launches[A.KERNEL]
    A.mha(q, k, v).sum().backward()
    assert kernels.launches[A.KERNEL] == before
    assert q.grad is not None and k.grad is not None
