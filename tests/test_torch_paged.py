"""The port's paged KV cache against the JAX package, on the CPU.

Host bookkeeping (allocator, prefix cache) gives JAX-equal refcounts, free
lists and hits; the block-table gather and scatters leave pools bit-equal
to JAX's, float and kv8; the paged attention kernels' plain versions equal
the dense plain versions over the gathered view bit for bit, and are
within 1e-5 of JAX's paged Pallas kernels in interpret mode; the paged
model steps match JAX's logits within ``test_torch_model.py``'s
tolerances; paged ``Engine.serve`` emits the JAX paged engine's greedy
tokens (near ties excepted, as ``test_torch_engine.py``) with equal integer
scheduler counters, through prefix sharing with over-subscription,
chunked prefill, admission gating and a preemption with resume; every
serve returns all its blocks."""
import dataclasses
import sys
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import jax_compile_cache  # noqa: E402,F401  (test-process settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kvq as JK  # noqa: E402
from repro.kernels import flash_attention as JFA  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import blocks as JSB  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch import kvq as TK  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.serve import blocks as TSB  # noqa: E402
from repro_torch.serve.engine import Engine, Request, ServeConfig, _ServeControl  # noqa: E402
from test_torch_engine import PROMPT_SEED, TIE  # noqa: E402
from test_torch_model import LENS, _assert_close, _prompts, make_pair  # noqa: E402

BS = 4
N_NEW = 6


def _pool_equal(jpool, tpool):
    """JAX pool {'k','v'} of arrays or packed blocks == the port's."""
    for name in ("k", "v"):
        j, t = jpool[name], tpool[name]
        if isinstance(t, TK.PackedKVBlock):
            np.testing.assert_array_equal(np.asarray(j.qm), t.qm.numpy())
            np.testing.assert_array_equal(np.asarray(j.scale), t.scale.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(j), t.numpy())


# ---------------------------------------------------------------------------
# host bookkeeping
# ---------------------------------------------------------------------------

def _alloc_ops(alloc, prefix, seed):
    """One seeded sequence of allocator and prefix-cache operations;
    returns the observable state after each."""
    rng = np.random.default_rng(seed)
    tables = np.zeros((3, 6), np.int32)
    errors = (JSB.BlockError, TSB.BlockError)
    trace = []
    vocab = 3  # few distinct tokens: prefix chains collide often
    for _ in range(60):
        op = int(rng.integers(6))
        lane = int(rng.integers(3))
        toks = rng.integers(0, vocab, int(rng.integers(1, 13)))
        try:
            if op == 0:  # reserve: prefix hits, then fresh blocks
                alloc.free(int(b) for b in tables[lane] if b)
                tables[lane] = 0
                hits = prefix.lookup(toks)
                fresh = alloc.alloc(max(0, -(-len(toks) // BS) - len(hits)))
                ids = hits + fresh
                tables[lane, :len(ids)] = ids
            elif op == 1:
                prefix.register(toks, tables[lane])
            elif op == 2:
                n = int(np.count_nonzero(tables[lane]))
                if n:
                    trace.append(alloc.ensure_writable(tables[lane], range(n)))
            elif op == 3:
                trace.append(prefix.evict_one())
            elif op == 4 and tables[lane, 0]:
                trace.append(prefix.forget(int(tables[lane, 0])))
            else:
                alloc.free(int(b) for b in tables[lane] if b)
                tables[lane] = 0
        except errors as e:
            trace.append(type(e).__name__)
        trace.append((alloc.refcounts().tolist(), alloc.free_list(), alloc.peak_used,
                      alloc.shared_blocks(), prefix.hits, prefix.lookups,
                      sorted(prefix.block_ids()), tables.tolist()))
    prefix.drop_all()
    trace.append((alloc.free_blocks, alloc.used_blocks))
    return trace


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_and_prefix_cache_match_jax(seed):
    ja = JSB.BlockAllocator(9, BS)
    ta = TSB.BlockAllocator(9, BS)
    assert _alloc_ops(ja, JSB.PrefixCache(ja), seed) == _alloc_ops(ta, TSB.PrefixCache(ta), seed)
    assert TSB.block_span(9, BS) == JSB.block_span(9, BS) == 3
    assert TSB.blocks_written(7, 6, 12, BS) == JSB.blocks_written(7, 6, 12, BS)


def test_allocator_errors_match_jax():
    for mod in (JSB, TSB):
        with pytest.raises(ValueError, match="need >= 2 blocks"):
            mod.BlockAllocator(1, BS)
        a = mod.BlockAllocator(3, BS)
        a.alloc(2)
        with pytest.raises(mod.BlockError, match="exhausted"):
            a.alloc(1)
        with pytest.raises(ValueError, match="unallocated logical block"):
            a.ensure_writable(np.zeros(2, np.int32), [0])


@pytest.mark.parametrize("kv", [None, "kv8"])
def test_copy_blocks_moves_every_leaf(kv):
    rng = np.random.default_rng(4)
    shp = (6, 2, BS, 8)
    vals = [rng.standard_normal(shp).astype(np.float32) for _ in range(4)]
    spec = TK.KV_PRESETS.get(kv)

    def leaf(x):
        t = torch.from_numpy(x)
        return TK.quantize_kv(t, spec) if spec else t

    pool = [{"k": leaf(vals[0]), "v": leaf(vals[1])}, {"k": leaf(vals[2]), "v": leaf(vals[3])}]
    jleaf = lambda x: JK.quantize_kv(jnp.asarray(x), JK.KV_PRESETS[kv]) if kv else jnp.asarray(x)
    jpool = {"units": [], "tail": [{"k": jleaf(v), "v": jleaf(w)}
                                   for v, w in (vals[:2], vals[2:])]}
    TSB.copy_blocks(pool, [1, 4], [3, 5])
    jpool = JSB.copy_blocks(jpool, [1, 4], [3, 5])
    for j, t in zip(jpool["tail"], pool):
        _pool_equal(j, t)


# ---------------------------------------------------------------------------
# block-table gather and scatters
# ---------------------------------------------------------------------------

def _pools(kv, nb=10, h=2, d=32, seed=5):
    rng = np.random.default_rng(seed)
    shp = (nb, h, BS, d)
    raw = {n: rng.standard_normal(shp).astype(np.float32) for n in ("k", "v")}
    if kv is None:
        return ({n: jnp.asarray(x) for n, x in raw.items()},
                {n: torch.from_numpy(x.copy()) for n, x in raw.items()})
    jspec, tspec = JK.KV_PRESETS[kv], TK.KV_PRESETS[kv]
    return ({n: JK.quantize_kv(jnp.asarray(x), jspec) for n, x in raw.items()},
            {n: TK.quantize_kv(torch.from_numpy(x), tspec) for n, x in raw.items()})


TABLE = np.asarray([[3, 1, 7, 0], [5, 5, 2, 9], [0, 0, 0, 0]], np.int32)  # shuffled, shared


@pytest.mark.parametrize("kv", [None, "kv8"])
def test_gather_and_paged_writes_match_jax(kv):
    jpool, tpool = _pools(kv)
    s_c = TABLE.shape[1] * BS
    jv = jax.jit(JB._gather_kv_entry, static_argnums=2)(jpool["k"], jnp.asarray(TABLE), s_c)
    tv = TA.gather_kv_view(tpool["k"], torch.from_numpy(TABLE), s_c)
    _pool_equal({"k": jv, "v": jv}, {"k": tv, "v": tv})
    # fresh K/V of every lane; writes masked by write_len
    rng = np.random.default_rng(6)
    table = np.asarray([[3, 1, 7, 4], [8, 6, 2, 9], [0, 0, 0, 0]], np.int32)
    k, v = (rng.standard_normal((3, 2, 5, 32)).astype(np.float32) for _ in range(2))
    pos, write_len = np.asarray([2, 9, 0]), np.asarray([5, 3, 0])
    jpool = jax.jit(JB.write_kv_blocks, static_argnums=6)(
        jpool, jnp.asarray(table), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(write_len), s_c)
    plan = TB.write_plan(table, pos, write_len, 5, s_c, block_size=BS, device="cpu")
    TB.write_kv_blocks(tpool, torch.from_numpy(k), torch.from_numpy(v), plan)
    _pool_equal(jpool, tpool)
    # a prefill fill of ragged lengths, the first lane skipping a hit block
    lens = np.asarray([7, 16, 3])
    table[2, 0] = 5  # an idle lane's table is all scratch: give it a block
    kk, vv = (rng.standard_normal((3, 2, 16, 32)).astype(np.float32) for _ in range(2))
    jpool = jax.jit(JB.fill_kv_cache_paged, static_argnums=5)(
        jpool, jnp.asarray(table), jnp.asarray(kk), jnp.asarray(vv), jnp.asarray(lens), s_c,
        jnp.asarray([4, 0, 0]))
    plan = TB.fill_plan(table, lens, s_c, block_size=BS, device="cpu",
                        write_start=np.asarray([4, 0, 0]))
    TB.write_kv_blocks(tpool, torch.from_numpy(kk), torch.from_numpy(vv), plan)
    _pool_equal(jpool, tpool)


# ---------------------------------------------------------------------------
# B6 / B7 plain versions
# ---------------------------------------------------------------------------

def _paged_case(seed, hq=4, hkv=2, d=32, nb=12, mb=5):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    pk, pv = f(nb, hkv, BS, d), f(nb, hkv, BS, d)
    table = torch.from_numpy(rng.integers(0, nb, (3, mb)).astype(np.int32))
    return f, pk, pv, table


@pytest.mark.parametrize("sq,window", [(1, 0), (6, 0), (6, 5)])
@pytest.mark.parametrize("packed", [False, True], ids=["B6", "B7"])
def test_paged_plain_equals_dense_plain_over_gather(sq, window, packed):
    f, pk, pv, table = _paged_case(7)
    q = f(3, 4, sq, 32)
    kv_len = torch.tensor([19, 7, 13], dtype=torch.int32)   # partial last blocks
    q0 = kv_len - sq
    gk, gv = FA.gather_blocks(pk, table), FA.gather_blocks(pv, table)
    if not packed:
        out = FA.paged_flash_attention(q, pk, pv, table, kv_len, q0, window=window)
        ref = FA.flash_attention(q, gk, gv, kv_len, q0, window=window)
    else:
        kq, vq = (TK.quantize_kv(t, TK.KV_PRESETS["kv8"]) for t in (pk, pv))
        out = FA.paged_packed_flash_attention(q, kq.qm, kq.scale, vq.qm, vq.scale, table,
                                              kv_len, q0, window=window)
        g = [FA.gather_blocks(t, table) for t in (kq.qm, kq.scale, vq.qm, vq.scale)]
        ref = FA.packed_flash_attention(q, *g, kv_len, q0, window=window)
        # and B7 over the pool equals B6 over the dequantized pool
        deq = FA.paged_flash_attention(q, kq.dequantize(), vq.dequantize(), table, kv_len,
                                       q0, window=window)
        assert torch.equal(out, deq)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("packed", [False, True], ids=["B6", "B7"])
def test_paged_plain_matches_jax_pallas_interpret(packed):
    """One lane, one head, as ``tests/test_paged.py`` calls the Pallas
    kernels: a 4-query tail at q_start 12 over 16 keys of a shuffled
    table, and a decode query over a partial last block."""
    f, pk, pv, table = _paged_case(8, hq=1, hkv=1, d=16, nb=9, mb=4)
    tab = table[:1]
    q = f(1, 1, 4, 16)
    for sq, kv_len, q_start, window in ((4, 16, 12, None), (4, 16, 12, 6), (1, 14, 13, None)):
        qq = q[:, :, :sq]
        lens = torch.tensor([kv_len], dtype=torch.int32)
        q0 = torch.tensor([q_start], dtype=torch.int32)
        if packed:
            kq, vq = (TK.quantize_kv(t, TK.KV_PRESETS["kv8"]) for t in (pk, pv))
            out = FA.paged_packed_flash_attention(qq, kq.qm, kq.scale, vq.qm, vq.scale, tab,
                                                  lens, q0, window=window or 0)
            ref = JFA.paged_packed_flash_attention_kernel_call(
                jnp.asarray(qq[0, 0].numpy()), *(jnp.asarray(t[:, 0].numpy()) for t in
                                                 (kq.qm, kq.scale, vq.qm, vq.scale)),
                jnp.asarray(tab[0].numpy()), kv_len=kv_len, window=window, q_start=q_start,
                bq=sq)
        else:
            out = FA.paged_flash_attention(qq, pk, pv, tab, lens, q0, window=window or 0)
            ref = JFA.paged_flash_attention_kernel_call(
                jnp.asarray(qq[0, 0].numpy()), jnp.asarray(pk[:, 0].numpy()),
                jnp.asarray(pv[:, 0].numpy()), jnp.asarray(tab[0].numpy()), kv_len=kv_len,
                window=window, q_start=q_start, bq=sq)
        np.testing.assert_allclose(out[0, 0].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [40, 256])  # not a multiple of 16; gemma3-12b's d_head
@pytest.mark.parametrize("packed", [False, True], ids=["B6", "B7"])
def test_paged_plain_matches_jax_pallas_interpret_head_dims(packed, d):
    """B6 / B7's plain versions at the head dims the card's kernels now
    take, against the Pallas kernels at the d_head 16 tolerance, and equal
    to the dense plain versions over the gathered view."""
    f, pk, pv, table = _paged_case(d, hq=1, hkv=1, d=d, nb=9, mb=4)
    tab = table[:1]
    q = f(1, 1, 4, d)
    lens, q0 = torch.tensor([15], dtype=torch.int32), torch.tensor([11], dtype=torch.int32)
    if packed:
        kq, vq = (TK.quantize_kv(t, TK.KV_PRESETS["kv8"]) for t in (pk, pv))
        out = FA.paged_packed_flash_attention(q, kq.qm, kq.scale, vq.qm, vq.scale, tab, lens,
                                              q0, window=5)
        ref = JFA.paged_packed_flash_attention_kernel_call(
            jnp.asarray(q[0, 0].numpy()), *(jnp.asarray(t[:, 0].numpy()) for t in
                                            (kq.qm, kq.scale, vq.qm, vq.scale)),
            jnp.asarray(tab[0].numpy()), kv_len=15, window=5, q_start=11, bq=4)
        g = [FA.gather_blocks(t, tab) for t in (kq.qm, kq.scale, vq.qm, vq.scale)]
        dense = FA.packed_flash_attention(q, *g, lens, q0, window=5)
    else:
        out = FA.paged_flash_attention(q, pk, pv, tab, lens, q0, window=5)
        ref = JFA.paged_flash_attention_kernel_call(
            jnp.asarray(q[0, 0].numpy()), jnp.asarray(pk[:, 0].numpy()),
            jnp.asarray(pv[:, 0].numpy()), jnp.asarray(tab[0].numpy()), kv_len=15, window=5,
            q_start=11, bq=4)
        dense = FA.flash_attention(q, FA.gather_blocks(pk, tab), FA.gather_blocks(pv, tab),
                                   lens, q0, window=5)
    np.testing.assert_allclose(out[0, 0].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert torch.equal(out, dense)


def test_paged_wrapper_checks():
    f, pk, pv, table = _paged_case(9)
    q = f(3, 4, 1, 32)
    ok = torch.tensor([4, 4, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"table entries must lie in \[0, 12\)"):
        FA.paged_flash_attention(q, pk, pv, table + 12, ok, ok - 1)
    with pytest.raises(ValueError, match="exceeds the table's 20 slots"):
        FA.paged_flash_attention(q, pk, pv, table, ok * 6, ok - 1)
    with pytest.raises(ValueError, match="table must be"):
        FA.paged_flash_attention(q, pk, pv, table[:2], ok, ok - 1)


def test_paged_decode_reads_no_gathered_view():
    """``count_kv_gathers`` sees nothing KV-sized on the paged decode path
    (the plain versions stand in for the kernels) and the gather oracle."""
    f, pk, pv, table = _paged_case(10)
    q = f(3, 4, 1, 32)
    pos = torch.tensor([18, 6, 12], dtype=torch.int32)
    view = table.shape[0] * pk.shape[1] * table.shape[1] * BS * pk.shape[3]
    assert TO.count_kv_gathers(TA.paged_decode_attention, q, pk, pv, table, pos,
                               min_size=view) == 0
    assert TO.count_kv_gathers(TA.gather_kv_view, pk, table, table.shape[1] * BS,
                               min_size=view) == 1


@pytest.mark.parametrize("kv", [None, "kv8"])
def test_verify_attention_matches_jax(kv):
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, kn, vn, kc, vc = f(2, 4, 5, 32), f(2, 2, 5, 32), f(2, 2, 5, 32), f(2, 2, 16, 32), \
        f(2, 2, 16, 32)
    pos = np.asarray([9, 3])
    if kv:
        jq = lambda x: jax.jit(JK.quantize_kv, static_argnums=1)(jnp.asarray(x),
                                                                 JK.KV_PRESETS[kv])
        tq = lambda x: TK.quantize_kv(torch.from_numpy(x), TK.KV_PRESETS[kv])
    else:
        jq, tq = jnp.asarray, torch.from_numpy
    for window in (0, 6):
        j = JA.verify_attention(jnp.asarray(q), jq(kn), jq(vn), jq(kc), jq(vc),
                                jnp.asarray(pos), window=window)
        t = TA.verify_attention(torch.from_numpy(q), tq(kn), tq(vn), tq(kc), tq(vc),
                                torch.from_numpy(pos), window=window)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# paged model steps
# ---------------------------------------------------------------------------

# the JAX paged steps, jitted whole (eager JAX compiles op by op)
J_PREFILL = jax.jit(JM.prefill_paged, static_argnums=(4, 5))
J_DECODE = jax.jit(JM.decode_step_paged, static_argnums=(6, 7))
J_VERIFY = jax.jit(JM.verify_step_paged, static_argnums=(5, 6))
J_COMMIT = jax.jit(JM.rollback_cache_paged, static_argnums=(5, 6))


@pytest.mark.parametrize("variant,packed,kv", [("gqa", False, None), ("mha", True, "kv8")],
                         ids=["gqa-float", "mha-packed-kv8"])
def test_paged_model_steps_match_jax(variant, packed, kv):
    jcfg, params, model = make_pair(variant, packed)
    rel = 1e-3 if packed else 1e-5
    max_len, nb = 24, 20
    toks = _prompts(jcfg.vocab_size)
    table = np.zeros((len(LENS), max_len // BS), np.int32)
    table[:, :] = 1 + np.arange(table.size).reshape(table.shape) % (nb - 1)
    table[1, :2] = table[0, :2]  # lane 1 shares lane 0's first two blocks
    start = np.asarray([0, 2 * BS, 0], np.int32)
    jcache = JM.init_paged_cache(jcfg, len(LENS), nb, BS, kv=kv)
    jl, jcache, _ = J_PREFILL(params, {"tokens": jnp.asarray(toks)}, jcache,
                              jnp.asarray(table), jcfg, max_len, jnp.asarray(LENS),
                              jnp.asarray(start))
    tcache = model.init_paged_cache(nb, BS, kv=kv)
    with torch.inference_mode():
        tl, tcache, _ = model.prefill_paged(torch.from_numpy(toks), tcache, table, max_len,
                                            lengths=LENS, write_start=start)
    _assert_close(jl, tl, rel)
    # lane 1 skipped the shared blocks; give it its own from here on
    table[1, :2] = [18, 19]
    jcache = JSB.copy_blocks(jcache, table[0, :2].tolist(), [18, 19])
    TSB.copy_blocks(tcache, table[0, :2].tolist(), [18, 19])
    rng = np.random.default_rng(12)
    pos = LENS.copy()
    live = np.asarray([1, 0, 1], np.int32)  # lane 1 idles through a decode step
    step = rng.integers(0, jcfg.vocab_size, (len(LENS), 1))
    jl, jcache = J_DECODE(params, {"tokens": jnp.asarray(step)}, jcache, jnp.asarray(table),
                          jnp.asarray(pos), jnp.asarray(live), jcfg, max_len)
    with torch.inference_mode():
        tl, tcache = model.decode_step_paged(torch.from_numpy(step), tcache, table, pos, live,
                                             max_len)
    _assert_close(np.asarray(jl)[live == 1], tl[torch.from_numpy(live == 1)], rel)
    pos = pos + live
    # a 3-token verify pass, then a commit of keep = (2, 3, 0)
    vt = rng.integers(0, jcfg.vocab_size, (len(LENS), 3))
    jl, jsteps = J_VERIFY(params, {"tokens": jnp.asarray(vt)}, jcache, jnp.asarray(table),
                          jnp.asarray(pos), jcfg, max_len)
    with torch.inference_mode():
        tl, tsteps = model.verify_step_paged(torch.from_numpy(vt), tcache, table, pos, max_len)
    _assert_close(jl, tl, rel)
    keep = np.asarray([2, 3, 0], np.int32)
    jcache = J_COMMIT(jcache, jnp.asarray(table), jsteps, jnp.asarray(keep),
                      jnp.asarray(pos), jcfg, max_len)
    model.rollback_cache_paged(tcache, table, tsteps, keep, pos, max_len)
    if kv:  # the committed mantissas and scales of both layers
        for i, c in enumerate(tcache):
            for name in ("k", "v"):
                j = jcache["units"][0][name]
                jl_ = JK.PackedKVBlock(j.qm[i], j.scale[i], bits=j.bits, fmt=j.fmt)
                live_blocks = np.unique(table[[0, 2]])
                got = c[name].qm.numpy()[live_blocks].astype(np.int32)
                want = np.asarray(jl_.qm)[live_blocks].astype(np.int32)
                assert np.abs(got - want).max() <= 1 and (got != want).mean() < 0.01
    step = rng.integers(0, jcfg.vocab_size, (len(LENS), 1))
    pos = pos + keep
    jl, _ = J_DECODE(params, {"tokens": jnp.asarray(step)}, jcache, jnp.asarray(table),
                     jnp.asarray(pos), jnp.ones(len(LENS), jnp.int32), jcfg, max_len)
    with torch.inference_mode():
        tl, _ = model.decode_step_paged(torch.from_numpy(step), tcache, table, pos,
                                        np.ones(len(LENS), np.int32), max_len)
    _assert_close(jl, tl, rel)


# ---------------------------------------------------------------------------
# the paged engine against the JAX paged engine
# ---------------------------------------------------------------------------

def _engines(quant, kv=None, variant="gqa", **scfg):
    """The JAX and port engines over the same weights and the same
    ServeConfig fields (JAX's 'dsbp_ref' where the port runs its default
    'dsbp_fused')."""
    jcfg, params, model = make_pair(variant, packed=False)
    jscfg = dict(scfg, kv_quant=kv)
    if quant:
        jcfg = jcfg.replace(quant="precise")
        model.cfg = model.cfg.replace(quant="precise")
        jscfg["quant_method"] = "dsbp_ref"
    jeng = JaxEngine(params, jcfg, JaxServeConfig(**jscfg))
    eng = Engine(model, ServeConfig(**dict(scfg, kv_quant=kv)), device="cpu")
    return jeng, eng


def _streams_match(jout, tout, jeng, reqs):
    """Every stream equal, except from a step where the JAX model's own
    top-2 logit gap (teacher-forced) is a near tie."""
    assert set(jout) == set(tout)
    prompts = {r.uid: np.asarray(r.tokens) for r in reqs}
    for uid, j in jout.items():
        t = tout[uid]
        diff = np.flatnonzero(j[:len(t)] != t[:len(j)])
        if diff.size:
            s = int(diff[0])
            seq = np.concatenate([prompts[uid], j[:s]])[None]
            lg = np.asarray(JM.forward(jeng.params, {"tokens": jnp.asarray(seq)},
                                       jeng.cfg))[0, -1]
            top2 = np.sort(lg)[-2:]
            assert top2[1] - top2[0] < TIE * np.abs(lg).max(), (
                f"request {uid} diverges at step {s}: {j} vs {t}")
        else:
            assert len(j) == len(t), uid


_COUNTERS = ("decode_steps", "occupied_lanes", "admissions", "prefill_tokens",
             "decode_tokens", "cow_splits", "chunk_steps", "chunked_requests",
             "stalled_decode_steps", "interleaved_decode_steps", "max_concurrent",
             "shared_blocks_peak", "admission_blocked", "preemptions", "resumed",
             "block_peak_used", "block_bytes", "prefix_lookups", "prefix_hit_blocks",
             "bytes_saved_sharing", "requests", "lanes", "kv_block_size", "kv_blocks")


def _requests(cls, lens, seed=PROMPT_SEED, prompt=None, **fields):
    rng = np.random.default_rng(seed)
    toks = [np.concatenate([prompt, rng.integers(0, 512, n)]) if prompt is not None
            else rng.integers(0, 512, n) for n in lens]
    return [cls(uid=i, tokens=t, max_new_tokens=N_NEW,
                **{k: v[i] for k, v in fields.items()}) for i, t in enumerate(toks)]


def _serve_both(jeng, eng, lens, faults=None, **kw):
    """Serve the same requests through both engines: streams equal under
    the near-tie rule, integer counters equal, every block returned."""
    reqs = _requests(Request, lens, **kw)
    jout = jeng.serve(_requests(JaxRequest, lens, **kw), faults=faults)
    tout = eng.serve(reqs)
    _streams_match(jout, tout, jeng, reqs)
    jst, tst = jeng.last_stats, eng.last_stats
    for key in _COUNTERS:
        assert tst[key] == jst[key], (key, tst[key], jst[key])
    for key in ("block_utilization", "kv_bytes_per_token", "kv_packed", "paged", "completed"):
        assert tst[key] == jst[key], key
    assert tst["blocks_in_use_at_exit"] == 0
    return tout, tst


@pytest.mark.parametrize("quant,kv", [(None, None), ("precise", None), ("precise", "kv8")],
                         ids=["float", "packed", "packed-kv8"])
def test_paged_serve_oversubscribed_shared_prompt_matches_jax(quant, kv):
    """8 requests sharing a 16-token system prompt run 8-concurrent on the
    KV blocks of 4 dense slots."""
    jeng, eng = _engines(quant, kv, max_len=32, batch_size=4, prefill_bucket=8,
                         paged=True, kv_block_size=BS, max_active=8)
    assert eng.kv_blocks == jeng.kv_blocks == 4 * (32 // BS) + 1
    sys_prompt = np.random.default_rng(9).integers(0, 512, 16)
    _, st = _serve_both(jeng, eng, [4] * 8, prompt=sys_prompt)
    assert st["max_concurrent"] == 8 > 4
    assert st["shared_blocks_peak"] > 0 and st["prefix_hit_blocks"] >= 7 * 4
    assert st["kv_packed"] == (kv is not None)


def test_paged_serve_chunked_prefill_matches_jax():
    """Long prompts chunk through the verify path between decode steps:
    decode never stalls and runs while a chunked prefill is in flight."""
    jeng, eng = _engines("precise", max_len=40, batch_size=2, prefill_bucket=8, paged=True,
                         kv_block_size=BS, chunk_prefill_tokens=8)
    _, st = _serve_both(jeng, eng, [20, 5, 18, 7])
    assert st["chunked_requests"] == 2 and st["chunk_steps"] >= 2
    assert st["stalled_decode_steps"] == 0 and st["interleaved_decode_steps"] > 0


def test_paged_serve_admission_gates_on_blocks_matches_jax():
    """A pool of two lanes' blocks under four lanes: admissions wait; a
    request that can never fit raises BlockError in both packages."""
    jeng, eng = _engines("precise", max_len=16, batch_size=4, prefill_bucket=8, paged=True,
                         kv_block_size=BS, kv_blocks=9, prefix_sharing=False)
    _, st = _serve_both(jeng, eng, [8, 8, 8, 8])
    assert st["admission_blocked"] > 0
    tiny = dict(max_len=16, batch_size=1, prefill_bucket=8, paged=True, kv_block_size=BS,
                kv_blocks=3)
    jt, tt = _engines("precise", **tiny)
    prompt = np.random.default_rng(11).integers(0, 512, 8)
    with pytest.raises(JSB.BlockError):
        jt.serve([prompt], max_new_tokens=6)
    with pytest.raises(TSB.BlockError, match="cannot be admitted even with an idle pool"):
        tt.serve([prompt], max_new_tokens=6)


class _RefusingAllocator(TSB.BlockAllocator):
    """An allocator whose copy-on-write calls with the given indices
    refuse as an exhausted pool does (the JAX ``FaultPlan(cow_failures=)``
    injection, in a test double: the port has no fault plans yet)."""

    refuse: frozenset = frozenset()

    def __init__(self, *args):
        super().__init__(*args)
        self._calls = 0

    def ensure_writable(self, table, logical_blocks):
        i, self._calls = self._calls, self._calls + 1
        if i in self.refuse:
            raise TSB.BlockError("copy-on-write split refused")
        return super().ensure_writable(table, logical_blocks)


def test_paged_serve_preemption_with_resume_matches_jax(monkeypatch):
    """Refused splits preempt the lowest-priority lane, which re-queues
    with prompt + emitted and resumes: the streams equal the JAX engine's
    under the same refusals, and the port's own run without refusals."""
    scfg = dict(max_len=32, batch_size=4, paged=True, kv_block_size=BS, prefill_bucket=8)
    jeng, eng = _engines("precise", **scfg)
    plain = TSB.BlockAllocator
    lens, prio = [5, 9, 7, 6], {"priority": [0, 2, 1, 0]}
    monkeypatch.setattr(_RefusingAllocator, "refuse", frozenset({0, 3}))
    monkeypatch.setattr(TSB, "BlockAllocator", _RefusingAllocator)
    out, st = _serve_both(jeng, eng, lens, faults=JF.FaultPlan(cow_failures={0, 3}), **prio)
    assert st["preemptions"] >= 1 and st["resumed"] >= 1
    monkeypatch.setattr(TSB, "BlockAllocator", plain)
    base = eng.serve(_requests(Request, lens, **prio))
    assert eng.last_stats["preemptions"] == 0
    for uid in base:  # recompute-on-resume continues each stream exactly
        np.testing.assert_array_equal(out[uid], base[uid])


def test_admission_preempts_only_strictly_lower_priority():
    """White-box, as the JAX robustness suite: a queued request preempts an
    active lane only when its priority is strictly higher; the victim
    re-queues with prompt + emitted, ahead of equal-priority waiters."""
    _, eng = _engines(None, max_len=32, batch_size=2, kv_blocks=5, max_active=2,
                      prefix_sharing=False, paged=True, kv_block_size=BS)
    rng = np.random.default_rng(0)
    low = Request(uid="low", tokens=rng.integers(0, 512, 8), max_new_tokens=8)
    high = Request(uid="high", tokens=rng.integers(0, 512, 8), max_new_tokens=4, priority=3)
    for contender, preempts in ((high, True), (dataclasses.replace(high, uid="eq",
                                                                   priority=0), False)):
        alloc = TSB.BlockAllocator(eng.kv_blocks, BS)
        cache = eng.model.init_paged_cache(eng.kv_blocks, BS)
        tables = np.zeros((eng.lanes, eng._table_width), np.int32)
        tables[0, :4] = alloc.alloc(4)  # low owns the whole pool
        lanes = [{"req": low, "phase": "decode", "done0": 0}, None]
        stats = {"admissions": 0, "prefill_tokens": 0, "admission_blocked": 0,
                 "chunked_requests": 0, "preemptions": 0, "resumed": 0}
        ctl = _ServeControl(stats=stats, out={"low": [3]},
                            status={"low": "queued", contender.uid: "queued"},
                            gen=eng._generator())
        tok, pos = np.zeros(2, np.int64), np.asarray([3, 0], np.int32)
        queue = deque([contender])
        eng._admit_paged(cache, queue, [1], lanes, tables, alloc, None, tok, pos, ctl)
        if preempts:
            assert stats["preemptions"] == 1
            assert any(l is not None and l["req"].uid == "high" for l in lanes)
            assert queue and queue[0].uid == "low"
            assert len(queue[0].tokens) == len(low.tokens) + 1
            assert ctl.status["low"] == "preempted"
        else:
            assert stats["preemptions"] == 0 and stats["admission_blocked"] == 1
            assert lanes[0]["req"].uid == "low"


def test_serve_orders_queue_by_priority():
    """Both schedulers admit highest priority first, FIFO among equals."""
    for paged in (False, True):
        _, eng = _engines(None, max_len=32, batch_size=1, paged=paged, kv_block_size=BS)
        reqs = [Request(uid=i, tokens=np.arange(1, 4) + i, max_new_tokens=1, priority=p)
                for i, p in enumerate([0, 2, 1, 2])]
        assert [r.uid for r in eng._build_queue(reqs, 1)] == [1, 3, 2, 0]


def test_paged_serve_returns_blocks_on_error(monkeypatch):
    """The serve loop's ``finally`` returns every block and empties the
    prefix cache when a step raises."""
    _, eng = _engines(None, max_len=32, batch_size=2, paged=True, kv_block_size=BS)
    calls = []

    def boom(*args, **kw):
        calls.append(1)
        raise RuntimeError("step failed")

    monkeypatch.setattr(eng.model, "decode_step_paged", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        eng.serve([np.arange(1, 9), np.arange(1, 7)], max_new_tokens=4)
    assert calls and eng.last_stats["completed"] is False
    assert eng.last_stats["blocks_in_use_at_exit"] == 0


@pytest.mark.parametrize("scfg", [dict(kv_block_size=0), dict(kv_block_size=5),
                                  dict(kv_blocks=1)])
def test_paged_config_errors_match_jax(scfg):
    jcfg, params, model = make_pair("gqa", packed=False)
    full = dict(max_len=32, paged=True, **scfg)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(params, jcfg, JaxServeConfig(**full))
    with pytest.raises(ValueError) as terr:
        Engine(model, ServeConfig(**full), device="cpu")
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--kv-quant", "kv8", "--max-active", "6"]],
                         ids=["float", "kv8"])
def test_launcher_paged_flags(monkeypatch, capsys, extra):
    argv = ["serve", "--smoke", "--packed", "--device", "cpu", "--paged", "--kv-block-size",
            "4", "--new-tokens", "3", "--prompt-len", "7", "--batch", "2", *extra]
    monkeypatch.setattr(sys, "argv", argv)
    launcher.main()
    out = capsys.readouterr().out
    # max_len 7 + 3 + 8 = 18 rounds up to 20, five blocks per lane
    assert "paged KV: 11 blocks x 4 slots" in out
    assert f"{6 if extra else 2} lanes, table width 5" in out
    assert "block pool: peak" in out and "0 stalled decode steps" in out
    assert "served 4 ragged requests" in out
