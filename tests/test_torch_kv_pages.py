"""The port's paged KV cache against the JAX package's, on the CPU.

The page allocator is host Python in both packages, so the contract is
equality: the same operation sequence must hand out the same page ids and
leave the same books.  The tensor ops carry no arithmetic, so they must
be bitwise equal to the JAX functions on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_scheduler_tpu.models import kv_pages as J
from distributed_llm_scheduler_tpu_torch.models import kv_pages as T

S, PPSEQ, PS, HKV, HD, NP = 4, 3, 4, 2, 8, 13


def books(pool):
    return (pool.free_pages, pool.used_pages, sorted(pool._allocated),
            list(pool._free), pool.can_alloc(5), pool.can_alloc(99))


OPS = {
    "alloc_free_lifo": [("alloc", 3), ("alloc", 2), ("free", [2, 1]),
                        ("alloc", 4), ("free", [5]), ("alloc", 1)],
    "exhaustion": [("alloc", 10), ("alloc", 3), ("free", [4, 2]),
                   ("alloc", 3)],
    "bad_frees": [("alloc", 2), ("free", [0]), ("free", [7]),
                  ("free", [1]), ("free", [1])],
    "tokens": [("tokens", 9), ("tokens", 0), ("tokens", 17), ("tokens", 99)],
}


def run_ops(pool, ops):
    trace = []
    for op, arg in ops:
        try:
            if op == "alloc":
                trace.append(("ok", pool.alloc(arg)))
            elif op == "tokens":
                trace.append(("ok", pool.alloc_for_tokens(arg)))
            else:
                pool.free(arg)
                trace.append(("ok", None))
        except (MemoryError, ValueError) as e:
            trace.append((type(e).__name__, str(e)))
        trace.append(books(pool))
    return trace


@pytest.mark.parametrize("name", sorted(OPS))
def test_page_pool_op_sequences_equal_jax(name):
    want = run_ops(J.PagePool(n_pages=NP, page_size=PS), OPS[name])
    got = run_ops(T.PagePool(n_pages=NP, page_size=PS), OPS[name])
    assert got == want


def test_host_helpers_equal_jax():
    toks = np.random.default_rng(0).integers(0, 50, size=(1, 37))
    assert T.prefix_chunk_keys(toks, 8) == J.prefix_chunk_keys(toks, 8)
    assert T.prefix_chunk_keys(torch.from_numpy(toks), 8) == \
        J.prefix_chunk_keys(jnp.asarray(toks), 8)
    for n in (0, 1, 15, 16, 17):
        assert T.pages_needed(n, 16) == J.pages_needed(n, 16)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        assert T.pool_bytes_per_layer(257, 16, 12, 64, tdt) == \
            J.pool_bytes_per_layer(257, 16, 12, 64, jdt)
        assert T.paged_param_bytes(2, 9, 4, 2, 8, tdt, 3, 5) == \
            J.paged_param_bytes(2, 9, 4, 2, 8, jdt, 3, 5)
    with pytest.raises(ValueError):
        T.PagePool(n_pages=1)
    p = T.PagePool.from_budget(10 * 2 * 2 * 16 * 2 * 8 * 4, 2, 2, 8, torch.float32)
    assert p.n_pages == J.PagePool.from_budget(
        10 * 2 * 2 * 16 * 2 * 8 * 4, 2, 2, 8, jnp.float32).n_pages == 10


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((NP, PS, HKV, HD)).astype(np.float32)
    pt = np.zeros((S, PPSEQ), np.int32)
    pt[:, :] = np.arange(1, 1 + S * PPSEQ).reshape(S, PPSEQ)
    pt[3, 1:] = 0  # trash-padded tail
    new = rng.standard_normal((S, HKV, 1, HD)).astype(np.float32)
    lengths = np.array([0, 5, 11, 3], np.int32)
    return pool, pt, new, lengths


def test_page_table_array_equals_jax():
    tables = [[3, 1], [], [4, 5, 6]]
    got = T.page_table_array(tables, 3, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.page_table_array(tables, 3)))
    with pytest.raises(ValueError):
        T.page_table_array([[1, 2, 3, 4]], 3, device="cpu")


@pytest.mark.parametrize("active", [[1, 1, 1, 1], [1, 0, 1, 1]])
def test_write_token_kv_bitwise(state, active):
    pool, pt, new, lengths = state
    act = np.asarray(active, bool)
    want = np.asarray(J.write_token_kv(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(pt),
        jnp.asarray(lengths), jnp.asarray(act)))
    t_pool = torch.from_numpy(pool.copy())
    got = T.write_token_kv(t_pool, torch.from_numpy(new), torch.from_numpy(pt),
                           torch.from_numpy(lengths), torch.from_numpy(act))
    assert got is t_pool  # written in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_write_prompt_kv_bitwise(state):
    pool, pt, _, _ = state
    rows = np.random.default_rng(4).standard_normal(
        (PPSEQ * PS, HKV, HD)).astype(np.float32)
    pages = pt[1]
    want = np.asarray(J.write_prompt_kv(jnp.asarray(pool), jnp.asarray(rows),
                                        jnp.asarray(pages)))
    got = T.write_prompt_kv(torch.from_numpy(pool.copy()), torch.from_numpy(rows),
                            torch.from_numpy(pages))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        T.write_prompt_kv(torch.from_numpy(pool.copy()),
                          torch.from_numpy(rows[:-1]), torch.from_numpy(pages))


@pytest.mark.parametrize("flat", [False, True])
def test_gather_kv_bitwise(state, flat):
    pool, pt, _, _ = state
    jf, tf = (J.gather_kv_flat, T.gather_kv_flat) if flat else (J.gather_kv, T.gather_kv)
    want = np.asarray(jf(jnp.asarray(pool), jnp.asarray(pt)))
    got = tf(torch.from_numpy(pool), torch.from_numpy(pt)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_init_paged_kv_matches_jax():
    got = T.init_paged_kv(2, 5, 4, 2, 8, torch.bfloat16, device="cpu")
    want = J.init_paged_kv(2, 5, 4, 2, 8, jnp.bfloat16)
    assert list(got) == list(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16 and not got[k].any()
