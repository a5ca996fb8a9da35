"""The port's int8 weights (``utils/quantize.py``) against the JAX
package's.

The same float32 inputs, made from a numpy seed, go through both: the
int8 ``q`` must be *equal* to JAX's and the scales allclose at 1e-6 (both
compute absmax / 127 in float32 and round half to even).  ``quantize_dag``
must give the JAX graph's name, per-task param bytes and spec shapes, keep
the re-batching markers, and its dequantizing fns and fused forward must
match the JAX quantized forward at rtol = atol = 2e-5.
"""

import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models.gpt2 import GPT2Config as JaxConfig
from distributed_llm_scheduler_tpu.utils import quantize as JQ
from distributed_llm_scheduler_tpu_torch.core.graph import (
    is_batch0,
    is_concat0,
    rootslice_of,
)
from distributed_llm_scheduler_tpu_torch.utils import quantize as TQ

CPU = torch.device("cpu")
SHAPES = [(64, 96), (3, 40, 50), (128, 64), (256, 8)]


def _data(shape, seed, zero_col=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_col:
        x[..., 0] = 0.0  # an all-zero channel takes scale 1.0
    return x


def _same_q(jq, tq):
    assert np.array_equal(np.asarray(jq.q), tq.q.numpy())
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert tuple(tq.scale.shape) == tuple(jq.scale.shape)
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("zero_col", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_channel_quantization_equals_jax(shape, zero_col):
    x = _data(shape, 0, zero_col)
    jq, tq = JQ.quantize_array(x), TQ.quantize_array(torch.from_numpy(x))
    _same_q(jq, tq)
    np.testing.assert_allclose(
        TQ.dequantize(tq, torch.float32).numpy(),
        np.asarray(JQ.dequantize(jq, np.float32)), rtol=1e-6, atol=1e-7)
    assert TQ.qparam_bytes(torch.from_numpy(x)) == JQ.qparam_bytes(x)


@pytest.mark.parametrize("shape", SHAPES)
def test_rowwise_quantization_equals_jax(shape):
    x = _data(shape, 1)
    _same_q(JQ.quantize_array_rowwise(x),
            TQ.quantize_array_rowwise(torch.from_numpy(x)))


@pytest.mark.parametrize("shape,group", [((128, 64), 64), ((256, 8), 32),
                                         ((96, 40), 64), ((64, 96), 64)])
def test_grouped_quantization_equals_jax(shape, group):
    """Grouped scales (ndim + 1), or the per-channel fallback where axis 0
    does not split into several groups."""
    x = _data(shape, 2)
    jq = JQ.quantize_array_grouped(x, group)
    tq = TQ.quantize_array_grouped(torch.from_numpy(x), group)
    _same_q(jq, tq)
    np.testing.assert_allclose(
        TQ.dequantize(tq, torch.float32).numpy(),
        np.asarray(JQ.dequantize(jq, np.float32)), rtol=1e-6, atol=1e-7)


def test_bf16_weights_quantize_as_jax():
    """A bf16 weight widens to float32 exactly before quantizing."""
    import jax.numpy as jnp

    x = _data((64, 96), 3)
    jq = JQ.quantize_array(jnp.asarray(x, jnp.bfloat16))
    tq = TQ.quantize_array(torch.from_numpy(x).to(torch.bfloat16))
    _same_q(jq, tq)
    deq = TQ.dequantize(tq, torch.bfloat16)
    assert deq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        deq.float().numpy(),
        np.asarray(JQ.dequantize(jq, jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("shape,min_elems", [((64, 64), 4096), ((64, 63), 4096),
                                             ((8192,), 16), ((4, 4), 16)])
def test_should_quantize_equals_jax(shape, min_elems):
    x = np.zeros(shape, np.float32)
    assert TQ.should_quantize(torch.from_numpy(x), min_elems) == \
        JQ.should_quantize(x, min_elems)
    assert not TQ.should_quantize(torch.zeros(shape, dtype=torch.int32),
                                  min_elems)


@pytest.mark.parametrize("scheme", ["channel", "grouped"])
def test_quantize_params_equals_jax(scheme):
    params = {"wte": _data((128, 64), 4), "w": _data((128, 96), 5),
              "b": _data((96,), 6), "g": _data((2, 8), 7)}
    jout = JQ.quantize_params(params, min_elems=64, scheme=scheme,
                              rowwise_keys=("wte",))
    tout = TQ.quantize_params({k: torch.from_numpy(v) for k, v in params.items()},
                              min_elems=64, scheme=scheme,
                              rowwise_keys=("wte",))
    assert set(tout) == set(jout)
    for k in jout:
        if isinstance(jout[k], JQ.QParam):
            _same_q(jout[k], tout[k])
        else:
            assert not isinstance(tout[k], TQ.QParam)
    with pytest.raises(ValueError, match="unknown quantization scheme"):
        TQ.quantize_params({}, scheme="nope")


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_rederive_shard_quants_equals_jax(layout):
    base = _data((96, 64), 8)
    if layout == "rows":
        shards = {f"t_shard_{k}": base[32 * k:32 * (k + 1)] for k in range(3)}
    else:
        shards = {f"t_shard_{k}": base[:, 16 * k:16 * (k + 1)] for k in range(4)}
    params = {"t": base, **shards}
    jout = JQ.rederive_shard_quants(JQ.quantize_params(params, min_elems=16))
    tout = TQ.rederive_shard_quants(TQ.quantize_params(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params.items()},
        min_elems=16))
    for k in jout:
        _same_q(jout[k], tout[k])
    with pytest.raises(ValueError, match="only channel-layout scales"):
        TQ.rederive_shard_quants({"t": TQ.quantize_array_rowwise(
            torch.from_numpy(base)), **{k: torch.from_numpy(
                np.ascontiguousarray(v)) for k, v in shards.items()}})


KW = dict(batch=4, seq_len=16, microbatches=2, vocab_shards=4)


@pytest.fixture(scope="module")
def dags():
    jdag = jax_build(JaxConfig.tiny(), **KW)
    tdag = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW)
    jfp = jdag.init_params()
    fp = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jfp.items() if "_shard_" not in k}, CPU)
    return dict(jq=JQ.quantize_dag(jdag), tq=TQ.quantize_dag(tdag),
                jfp=jfp, tfp=tdag.derive_params(fp), fp=fp)


def test_quantize_dag_graph_equals_jax(dags):
    jg, tg = dags["jq"].graph, dags["tq"].graph
    assert tg.name == jg.name and tg.name.endswith("_int8")
    assert tg.topo_order == jg.topo_order
    for t in tg:
        assert t.param_bytes == jg[t.task_id].param_bytes, t.task_id
    assert tg.total_param_gb() == pytest.approx(jg.total_param_gb(), rel=1e-12)
    for name, spec in dags["jq"].param_specs.items():
        tspec = dags["tq"].param_specs[name]
        assert isinstance(tspec, TQ.QParam) == isinstance(spec, JQ.QParam)
        if isinstance(spec, JQ.QParam):
            assert tuple(tspec.q.shape) == tuple(spec.q.shape)
            assert tuple(tspec.scale.shape) == tuple(spec.scale.shape)


def test_quantize_dag_keeps_the_rebatching_markers(dags):
    """The shim carries batch-axis-0, concat and root-slice markers, so the
    segments still re-batch int8 tasks; a shared fn stays one shim."""
    base = P.build_gpt2_dag(P.GPT2Config.tiny(), **KW).graph
    tg = dags["tq"].graph
    for t in tg:
        b = base[t.task_id]
        assert is_batch0(t.fn) == is_batch0(b.fn), t.task_id
        assert is_concat0(t.fn) == is_concat0(b.fn), t.task_id
        assert (rootslice_of(t.fn) is None) == (rootslice_of(b.fn) is None)
    assert tg["mb0_layer_0_ln1"].fn is tg["mb1_layer_0_ln1"].fn
    assert tg["mb0_layer_0_ffn_expand"].fn is tg["mb1_layer_1_ffn_expand"].fn
    from distributed_llm_scheduler_tpu_torch.backends.rebatch import (
        plan_rebatch,
    )

    plan = plan_rebatch(tg, tuple(tg.topo_order))
    assert plan.classes


def test_quantized_params_equal_jax(dags):
    from distributed_llm_scheduler_tpu.utils.quantize import quantize_like

    jparams = quantize_like(dags["jq"], dags["jfp"])
    tparams = dags["tq"].derive_params(dags["fp"])
    assert set(tparams) == set(jparams)
    for k, v in jparams.items():
        if isinstance(v, JQ.QParam):
            _same_q(v, tparams[k])
        else:
            np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(v))
    # quantize_like converts fp weights to the DAG's layout the same way
    like = TQ.quantize_like(dags["tq"], dags["tfp"])
    for k, v in jparams.items():
        if isinstance(v, JQ.QParam):
            _same_q(v, like[k])


def test_quantized_forward_matches_jax(dags):
    import jax.numpy as jnp

    from distributed_llm_scheduler_tpu.utils.quantize import quantize_like

    ids = np.random.default_rng(3).integers(0, 512, (4, 16), dtype=np.int32)
    jparams = quantize_like(dags["jq"], dags["jfp"])
    tparams = dags["tq"].derive_params(dags["fp"])
    want = np.asarray(dags["jq"].reference_forward(jparams, jnp.asarray(ids)))
    got = dags["tq"].reference_forward(tparams, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # the placed int8 DAG, each task through its dequantizing shim
    tg = dags["tq"].graph
    cluster = P.Cluster.from_torch_devices([CPU] * 2, hbm_cap_gb=4.0)
    sched = P.get_scheduler("roundrobin").schedule(tg, cluster)
    rep = P.DeviceBackend(cluster).execute(tg, sched, tparams,
                                           torch.from_numpy(ids))
    np.testing.assert_allclose(rep.output.numpy(), want, rtol=2e-5, atol=2e-5)
    seg = P.DeviceBackend(cluster).execute(tg, sched, tparams,
                                           torch.from_numpy(ids), segments=True)
    np.testing.assert_allclose(seg.output.numpy(), want, rtol=2e-5, atol=2e-5)
    # placement moves and counts a QParam leaf by leaf
    def nbytes(v):
        return sum(t.numel() * t.element_size()
                   for t in (v if isinstance(v, TQ.QParam) else (v,)))

    assert rep.param_bytes_placed == {
        n: sum(nbytes(tparams[g])
               for g in {g for t in lst for g in tg[t].params_needed})
        for n, lst in sched.per_node.items()
    }
