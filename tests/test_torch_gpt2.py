"""The port's GPT-2 forward and placed execution against the JAX package.

Weights come from the JAX package's initializer and cross the bridge
(``params_from_numpy``); token ids come from one numpy seed.  Float
outputs are held at rtol = atol = 2e-4, the tolerance the repo uses for a
placed DAG against the fused forward (``__graft_entry__.py:333``): f32
roundoff in a different summation order stays far below it, a wiring bug
does not.  Transfer counts carry no roundoff and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_llm_scheduler_tpu as J
import distributed_llm_scheduler_tpu_torch as P
from distributed_llm_scheduler_tpu.backends.device import (
    DeviceBackend as JaxBackend,
)
from distributed_llm_scheduler_tpu.frontend.gpt2_dag import (
    build_gpt2_dag as jax_build,
)
from distributed_llm_scheduler_tpu.models import gpt2 as jgpt2
from distributed_llm_scheduler_tpu_torch.frontend.gpt2_dag import (
    build_gpt2_dag as torch_build,
)
from distributed_llm_scheduler_tpu_torch.models import gpt2 as tgpt2

CPU = torch.device("cpu")
RTOL = ATOL = 2e-4


@pytest.fixture(scope="module")
def tiny():
    """Tiny f32 GPT-2, batch 4 x seq 32, 2 microbatches, 4 vocab shards,
    with the JAX package's weights bridged to the port."""
    kw = dict(batch=4, seq_len=32, microbatches=2, vocab_shards=4)
    jdag = jax_build(jgpt2.GPT2Config.tiny(), **kw)
    tdag = torch_build(tgpt2.GPT2Config.tiny(), **kw)
    jparams = jdag.init_params()
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU
    )
    ids = np.random.default_rng(7).integers(
        0, 512, size=(4, 32), dtype=np.int32
    )
    return jdag, tdag, jparams, tparams, ids


def test_bridge_is_name_for_name(tiny):
    jdag, tdag, jparams, tparams, _ = tiny
    assert sorted(tparams) == sorted(jparams)
    for name, arr in jparams.items():
        assert tuple(tparams[name].shape) == arr.shape, name
        np.testing.assert_array_equal(tparams[name].numpy(), np.asarray(arr))


def test_derived_params_equal_jax(tiny):
    """``derive_params`` turns the model's weights into the graph's: the
    vocab shards equal the JAX DAG's, name for name; ``init_params`` gives
    every param the graph declares."""
    jdag, tdag, jparams, tparams, _ = tiny
    model = {k: v for k, v in tparams.items() if "_shard_" not in k}
    full = tdag.derive_params(model)
    assert sorted(full) == sorted(jparams)
    for name, arr in jparams.items():
        np.testing.assert_array_equal(full[name].numpy(), np.asarray(arr))
    assert set(tdag.init_params(seed=4, device=CPU)) == set(tdag.param_specs)


def test_bridge_bf16_round_trip_is_exact():
    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.bfloat16)
    jparams = jgpt2.init_params(cfg, jax.random.PRNGKey(3))
    tparams = P.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, CPU, torch.bfloat16
    )
    for name, arr in jparams.items():
        assert tparams[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tparams[name].float().numpy(), np.asarray(arr, np.float32)
        )


def test_forward_matches_jax(tiny):
    jdag, tdag, jparams, tparams, ids = tiny
    want = np.asarray(jgpt2.forward(jparams, jnp.asarray(ids), jdag.config))
    got = tgpt2.forward(tparams, torch.from_numpy(ids), tdag.config).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_numpy_init_feeds_both_packages():
    cfg = tgpt2.GPT2Config.tiny()
    np_params = tgpt2.init_params_numpy(cfg, seed=5)
    assert set(np_params) == set(
        jgpt2.param_shapes(jgpt2.GPT2Config.tiny())
    )
    ids = np.random.default_rng(1).integers(0, 512, (2, 16), dtype=np.int32)
    want = np.asarray(jgpt2.forward(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(ids),
        jgpt2.GPT2Config.tiny(),
    ))
    got = tgpt2.forward(
        P.params_from_numpy(np_params, CPU), torch.from_numpy(ids), cfg
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _heft_pair(jdag, tdag):
    jg = J.fuse_linear_chains(jdag.graph)
    tg = P.fuse_linear_chains(tdag.graph)
    jc = J.Cluster.from_jax_devices(jax.devices()[:4])
    tc = P.Cluster.from_torch_devices([CPU] * 4)
    js = J.get_scheduler("heft").schedule(jg, jc)
    ts = P.get_scheduler("heft").schedule(tg, tc)
    return jg, tg, jc, tc, js, ts


def test_placed_execution_matches_fused_and_jax(tiny):
    jdag, tdag, jparams, tparams, ids = tiny
    jg, tg, jc, tc, js, ts = _heft_pair(jdag, tdag)
    assert ts.per_node == js.per_node
    assert len({n for n, lst in ts.per_node.items() if lst}) > 1

    # dispatch follows each node's scheduled list and respects deps
    order = P.DeviceBackend.dispatch_order(tg, ts)
    pos = {t: i for i, t in enumerate(order)}
    for nid, lst in ts.per_node.items():
        members = set(lst)
        assert [t for t in order if t in members] == lst, nid
    for t in tg:
        for d in t.dependencies:
            assert pos[d] < pos[t.task_id]

    rep = P.DeviceBackend(tc).execute(
        tg, ts, tparams, torch.from_numpy(ids), reps=2
    )
    jrep = JaxBackend(jc, pre_analysis=False).execute(
        jg, js, jparams, jnp.asarray(ids)
    )
    fused = tdag.reference_forward(tparams, torch.from_numpy(ids)).numpy()
    got = rep.output.numpy()
    np.testing.assert_allclose(got, fused, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jrep.output), rtol=RTOL, atol=ATOL
    )
    assert rep.transfer_edges == jrep.transfer_edges > 0
    assert rep.transfer_bytes == jrep.transfer_bytes
    assert rep.n_dispatches == len(tg)
    assert rep.makespan_s > 0 and rep.peak_hbm_bytes == {}
    assert rep.param_bytes_placed == jrep.param_bytes_placed


def test_profile_and_calibrate_time_every_task(tiny):
    _, tdag, _, tparams, ids = tiny
    g = P.fuse_linear_chains(tdag.graph)
    cm = P.calibrate(g, tparams, torch.from_numpy(ids), device=CPU, repeats=1)
    assert cm.platform == "cpu" and cm.graph_name == g.name
    assert set(cm.task_seconds) == set(g.task_ids())
    assert all(s > 0 for s in cm.task_seconds.values())
    assert cm.apply(g) == len(g)
    c = P.Cluster.from_torch_devices([CPU] * 2)
    s = P.get_scheduler("greedy").schedule(g, c)
    rep = P.DeviceBackend(c).execute(
        g, s, tparams, torch.from_numpy(ids), profile=True
    )
    assert set(rep.timings) == set(g.task_ids())
    assert all(t.finish >= t.start >= 0 for t in rep.timings.values())


def test_backend_refuses_unbound_clusters():
    with pytest.raises(ValueError, match="torch_device"):
        P.DeviceBackend(P.Cluster.uniform(2, 1.0))
