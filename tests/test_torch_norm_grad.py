"""The norms' backward against the JAX package's gradients, on the CPU.

A norm call that needs a gradient goes through ``ops.norms._NormFunction``:
its forward is the CUDA kernel's launch, its backward
(``norm_backward``) recomputes the norm through the plain version and
differentiates that.  The JAX package's Pallas norms have no autodiff
rule; its GPT-2 trains through the plain XLA norm, so the oracle is
``jax.vjp`` of the JAX ``layer_norm``/``rms_norm`` with ``impl="xla"`` on
the same numpy inputs and cotangent.  Tolerance 1e-3, that of
``tests/test_ops.py``'s gradient tests.

The kernel runs only on the card; to test the Function's wiring here (one
forward launch, gradients for x and every weight, no Function and the
same launch under ``no_grad``), the launch is replaced by the plain
version through ``monkeypatch``.  The same contract on the card is in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.ops import norms as JN
from distributed_llm_scheduler_tpu_torch.ops import norms as TN

TOL = 1e-3
SHAPES = [(4, 16, 128), (2, 77, 100), (3, 768)]


def _case(shape, seed, kernel):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, ((g, b) if kernel == TN.LN_KERNEL else (g,)), dy


def _jax_grads(kernel, x, ws, dy):
    fn = {TN.LN_KERNEL: lambda x, *w: JN.layer_norm(x, *w, impl="xla"),
          TN.RMS_KERNEL: lambda x, *w: JN.rms_norm(x, *w, impl="xla")}[kernel]
    _, vjp = jax.vjp(fn, jnp.asarray(x), *map(jnp.asarray, ws))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.detach().numpy() - w).max() < TOL


@pytest.mark.parametrize("kernel", [TN.LN_KERNEL, TN.RMS_KERNEL])
@pytest.mark.parametrize("shape", SHAPES)
def test_norm_backward_matches_jax_vjp(kernel, shape):
    x, ws, dy = _case(shape, seed=len(shape) + shape[-1], kernel=kernel)
    got = TN.norm_backward(kernel, torch.from_numpy(x),
                           [torch.from_numpy(w) for w in ws],
                           torch.from_numpy(dy))
    _close(got, _jax_grads(kernel, x, ws, dy))


@pytest.mark.parametrize("kernel", [TN.LN_KERNEL, TN.RMS_KERNEL])
def test_cpu_entry_grads_match_jax_vjp(kernel):
    """The public entry on CPU tensors (the plain version) differentiates
    to the same gradients."""
    x, ws, dy = _case((2, 8, 64), seed=3, kernel=kernel)
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    fn = TN.layer_norm if kernel == TN.LN_KERNEL else TN.rms_norm
    got = torch.autograd.grad(fn(xt, *wt), [xt, *wt], torch.from_numpy(dy))
    _close(got, _jax_grads(kernel, x, ws, dy))


@pytest.fixture
def plain_launch(monkeypatch):
    """The kernel launch replaced by the plain version, counting calls."""
    calls = []

    def launch(kernel, x, weights, eps):
        calls.append((kernel, torch.is_grad_enabled()))
        return TN._PLAIN[kernel](x, *weights, eps)

    monkeypatch.setattr(TN, "_launch_forward", launch)
    return calls


@pytest.mark.parametrize("kernel", [TN.LN_KERNEL, TN.RMS_KERNEL])
def test_function_wiring(plain_launch, kernel):
    """With grad: one forward launch inside the Function, gradients for x
    and every weight equal to JAX's; without: the same launch, no graph."""
    x, ws, dy = _case((2, 8, 64), seed=9, kernel=kernel)
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    entry = (TN.layer_norm_kernel if kernel == TN.LN_KERNEL
             else TN.rms_norm_kernel)
    out = entry(xt, *wt)
    assert type(out.grad_fn).__name__ == "_NormFunctionBackward"
    assert plain_launch == [(kernel, False)]  # Function.forward: grad off
    got = torch.autograd.grad(out, [xt, *wt], torch.from_numpy(dy))
    assert len(plain_launch) == 1  # the backward recomputes, no launch
    _close(got, _jax_grads(kernel, x, ws, dy))
    with torch.no_grad():
        out = entry(xt, *wt)
    assert out.grad_fn is None and len(plain_launch) == 2
    # an input that needs no gradient takes the launch directly too
    out = entry(xt.detach(), *(w.detach() for w in wt))
    assert out.grad_fn is None and plain_launch[-1] == (kernel, True)


def test_function_grads_only_the_inputs_that_need_them(plain_launch):
    """Only the inputs that require grad get a gradient back."""
    x, (g, b), dy = _case((4, 32), seed=1, kernel=TN.LN_KERNEL)
    xt = torch.from_numpy(x).requires_grad_()
    out = TN.layer_norm_kernel(xt, torch.from_numpy(g), torch.from_numpy(b))
    (gx,) = torch.autograd.grad(out, [xt], torch.from_numpy(dy))
    want = _jax_grads(TN.LN_KERNEL, x, (g, b), dy)[0]
    assert np.abs(gx.numpy() - want).max() < TOL
