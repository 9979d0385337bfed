"""tpulab_torch paged programs vs tpulab's, plus the port's own invariants.

- ``paged_mixed_step`` and ``paged_decode_block`` (the ragged plan) and
  ``paged_prefill`` (dense and flash attention) and ``paged_extend`` (the
  split plan) against tpulab's on the same weights (bridge), pool and
  per-lane inputs: tokens must be equal, logprobs/logits within 1e-4
  (f32 everywhere; the two backends sum in different orders), and the
  pool equal within 1e-5 on every page but the scratch page 0.
- Within the port, a K-block is bit-identical to K chained single steps.
- ``PagedKVPool`` accounting: free list, refcounts, scratch page 0,
  grow/shrink, the allocator gauge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulab.engine import paged as jp
from tpulab.models.transformer import init_transformer_params
from tpulab.ops.flash_attention import \
    make_flash_attention_fn as jax_flash_fn
from tpulab_torch.engine import paged as tp
from tpulab_torch.models.convert import params_from_numpy
from tpulab_torch.ops.flash_attention import make_flash_attention_fn

torch.set_num_threads(2)

VOCAB, D_MODEL, N_HEADS, N_KV, N_LAYERS, D_FF = 64, 32, 4, 2, 2, 48
S, MP, B = 4, 6, 3
ROPE = 10000.0
KW = dict(n_heads=N_HEADS, n_layers=N_LAYERS, n_kv_heads=N_KV,
          rope_theta=ROPE)


@pytest.fixture(scope="module")
def weights():
    p = init_transformer_params(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF,
                                seed=7, n_kv_heads=N_KV, ffn="swiglu",
                                tie_embeddings=False)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu",
                              n_heads=N_HEADS, n_kv_heads=N_KV)
    return p, model.params


def _pool():
    shape = (N_LAYERS, 1 + B * MP, 2, S, N_KV, D_MODEL // N_HEADS)
    return jnp.zeros(shape, jnp.float32), torch.zeros(shape)


def _tables():
    return np.arange(1, 1 + B * MP, dtype=np.int32).reshape(B, MP)


def _mixed(weights, kv_j, kv_t, seq, q_lens, kv_lens, temps, seeds):
    pj, pt = weights
    nt_j, lp_j, last_j, kv_j = jp.paged_mixed_step(
        pj, kv_j, jnp.asarray(_tables()), jnp.asarray(seq, jnp.int32),
        jnp.asarray(q_lens, jnp.int32), jnp.asarray(kv_lens, jnp.int32),
        jnp.asarray(temps, jnp.float32), jnp.asarray(seeds, jnp.uint32),
        compute_dtype=jnp.float32, **KW)
    nt_t, lp_t, last_t = tp.paged_mixed_step(
        pt, kv_t, torch.from_numpy(_tables()), torch.as_tensor(seq).long(),
        torch.tensor(q_lens), torch.tensor(kv_lens),
        torch.tensor(temps, dtype=torch.float32), torch.tensor(seeds),
        compute_dtype=torch.float32, **KW)
    assert nt_t.tolist() == np.asarray(nt_j).tolist()
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               rtol=1e-4, atol=1e-4)
    _same_pool(kv_j, kv_t)
    return kv_j, nt_t


def _same_pool(kv_j, kv_t):
    np.testing.assert_allclose(kv_t[:, 1:].numpy(), np.asarray(kv_j)[:, 1:],
                               rtol=1e-5, atol=1e-5)


def _prefilled(weights):
    """Two mixed rounds: fresh prompts, then decode + chunk + new prompt
    (lane 2 idle in the first)."""
    rng = np.random.default_rng(3)
    kv_j, kv_t = _pool()
    seq = np.zeros((B, 8), np.int64)
    seq[0, :7] = rng.integers(0, VOCAB, 7)
    seq[1, :5] = rng.integers(0, VOCAB, 5)
    kv_j, nt = _mixed(weights, kv_j, kv_t, seq, [7, 5, 0], [7, 5, 0],
                      [0.0, 0.8, 0.0], [[0, 0], [11, 3], [0, 0]])
    seq2 = np.zeros((B, 8), np.int64)
    seq2[0, 0] = int(nt[0])
    seq2[1, :3] = rng.integers(0, VOCAB, 3)
    seq2[2, :6] = rng.integers(0, VOCAB, 6)
    kv_j, nt2 = _mixed(weights, kv_j, kv_t, seq2, [1, 3, 6], [8, 8, 6],
                       [0.9, 0.0, 0.0], [[5, 1], [0, 0], [0, 0]])
    return kv_j, kv_t, [8, 8, 6], nt2.tolist()


def test_mixed_step_matches_tpulab(weights):
    _prefilled(weights)


def _block_args(lengths, tokens):
    return dict(lengths=np.asarray(lengths), tokens=np.asarray(tokens),
                active=np.array([True, True, True]),
                temps=np.array([0.0, 0.8, 0.0], np.float32),
                seeds=np.array([[0, 0], [123, 9], [0, 0]]),
                steps_rem=np.array([5, 3, 5]),
                stop_ids=np.array([[-1, -1], [-1, -1], [7, 40]]))


def _torch_args(a):
    return [torch.from_numpy(_tables()), torch.from_numpy(a["lengths"]),
            torch.from_numpy(a["tokens"]), torch.from_numpy(a["active"]),
            torch.from_numpy(a["temps"]), torch.from_numpy(a["seeds"]),
            torch.from_numpy(a["steps_rem"]),
            torch.from_numpy(a["stop_ids"])]


def test_decode_block_matches_tpulab(weights):
    pj, pt = weights
    kv_j, kv_t, lengths, tokens = _prefilled(weights)
    a = _block_args(lengths, tokens)
    out_j = jp.paged_decode_block(
        pj, kv_j, jnp.asarray(_tables()), jnp.asarray(a["lengths"],
                                                      jnp.int32),
        jnp.asarray(a["tokens"], jnp.int32), jnp.asarray(a["active"]),
        jnp.asarray(a["temps"]), jnp.asarray(a["seeds"], jnp.uint32),
        jnp.asarray(a["steps_rem"], jnp.int32),
        jnp.asarray(a["stop_ids"], jnp.int32), k=4,
        compute_dtype=jnp.float32, **KW)
    out_t = tp.paged_decode_block(pt, kv_t, *_torch_args(a), k=4,
                                  compute_dtype=torch.float32, **KW)
    toks_j, lps_j, ems_j = (np.asarray(x) for x in out_j[:3])
    assert out_t[0].tolist() == toks_j.tolist()
    assert out_t[2].tolist() == ems_j.tolist()
    np.testing.assert_allclose(out_t[1].numpy(), lps_j, rtol=1e-4,
                               atol=1e-4)
    for got, want in zip(out_t[3:], out_j[3:7]):   # carried state
        assert got.tolist() == np.asarray(want).tolist()
    _same_pool(out_j[7], kv_t)


def test_decode_block_equals_chained_steps(weights):
    """Within the port: one K-block == K single steps, bit for bit, in
    tokens, logprobs and every pool slot."""
    _pj, pt = weights
    _kv_j, kv_t, lengths, tokens = _prefilled(weights)
    a = _block_args(lengths, tokens)
    kv_a, kv_b = kv_t.clone(), kv_t.clone()
    tables, lens, toks, live, temps, seeds, rem, stops = _torch_args(a)
    blk = tp.paged_decode_block(pt, kv_a, *_torch_args(a), k=4,
                                compute_dtype=torch.float32, **KW)
    lens, toks, rem = lens.long(), toks.long(), rem.long()
    for j in range(4):
        nt, lp, _ = tp.paged_decode_step(
            pt, kv_b, tables, lens, toks, live, temps=temps, seeds=seeds,
            compute_dtype=torch.float32, **KW)
        assert torch.equal(blk[2][:, j], live)
        nt = torch.where(live, nt, toks)
        assert torch.equal(blk[0][:, j], nt)
        assert torch.equal(blk[1][:, j], lp)
        lens, rem, toks = lens + live.long(), rem - live.long(), nt
        live = live & (rem > 0) & ~(nt[:, None] == stops).any(1)
    assert torch.equal(kv_a[:, 1:], kv_b[:, 1:])   # page 0 is scratch


@pytest.mark.parametrize("program", ["mixed_step", "decode_block"])
def test_every_layer_attends_through_the_ragged_family(weights, monkeypatch,
                                                       program):
    """The paged programs have no other attention path: each layer of each
    forward calls ``ragged_paged_attention`` exactly once (on CUDA that is
    one kernel launch)."""
    _pj, pt = weights
    calls = []
    real = tp.ragged_paged_attention

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(tp, "ragged_paged_attention", counted)
    if program == "mixed_step":
        _pool_j, kv_t = _pool()
        seq = np.random.default_rng(4).integers(0, VOCAB, (B, 5))
        tp.paged_mixed_step(
            pt, kv_t, torch.from_numpy(_tables()), torch.from_numpy(seq),
            torch.tensor([5, 2, 0]), torch.tensor([5, 2, 0]),
            torch.zeros(B), torch.zeros(B, 2, dtype=torch.long),
            compute_dtype=torch.float32, **KW)
        assert calls == [(B, 5, N_HEADS, D_MODEL // N_HEADS)] * N_LAYERS
    else:
        _kv_j, kv_t, lengths, tokens = _prefilled(weights)
        calls.clear()
        tp.paged_decode_block(pt, kv_t, *_torch_args(
            _block_args(lengths, tokens)), k=4, compute_dtype=torch.float32,
            **KW)
        assert calls == [(B, 1, N_HEADS, D_MODEL // N_HEADS)] * (4 * N_LAYERS)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_prefill_then_extend_match_tpulab(weights, attn):
    """The split plan's programs: ``paged_prefill`` (dense or flash
    attention) over a 7-token prompt padded to 8, then ``paged_extend`` of
    one token and of a 5-token tail padded to 8.  Last logits within 1e-4
    and live pool pages within 1e-5 of tpulab's, f32."""
    pj, pt = weights
    rng = np.random.default_rng(6)
    kv_j, kv_t = _pool()
    table = _tables()[0]
    prompt = np.zeros((1, 8), np.int64)
    prompt[0, :7] = rng.integers(0, VOCAB, 7)
    fn_j = jax_flash_fn(causal=True) if attn == "flash" else None
    fn_t = make_flash_attention_fn(causal=True) if attn == "flash" else None
    last_j, kv_j = jp.paged_prefill(
        pj, kv_j, jnp.asarray(table), jnp.asarray(prompt, jnp.int32),
        jnp.int32(7), compute_dtype=jnp.float32, attention_fn=fn_j, **KW)
    last_t = tp.paged_prefill(pt, kv_t, torch.from_numpy(table),
                              torch.from_numpy(prompt), 7,
                              compute_dtype=torch.float32, attention_fn=fn_t,
                              **KW)
    assert last_t.shape == (VOCAB,)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               rtol=1e-4, atol=1e-4)
    _same_pool(kv_j, kv_t)
    # one more token at position 7, then a 5-token tail from position 8
    one = rng.integers(0, VOCAB, (1, 1))
    last_j, kv_j = jp.paged_extend(
        pj, kv_j, jnp.asarray(table), jnp.asarray(one, jnp.int32),
        jnp.int32(7), jnp.int32(8), compute_dtype=jnp.float32, **KW)
    last_t = tp.paged_extend(pt, kv_t, torch.from_numpy(table),
                             torch.from_numpy(one), 7, 8,
                             compute_dtype=torch.float32, **KW)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               rtol=1e-4, atol=1e-4)
    tail = np.zeros((1, 8), np.int64)
    tail[0, :5] = rng.integers(0, VOCAB, 5)
    last_j, kv_j = jp.paged_extend(
        pj, kv_j, jnp.asarray(table), jnp.asarray(tail, jnp.int32),
        jnp.int32(8), jnp.int32(13), compute_dtype=jnp.float32, **KW)
    last_t = tp.paged_extend(pt, kv_t, torch.from_numpy(table),
                             torch.from_numpy(tail), 8, 13,
                             compute_dtype=torch.float32, **KW)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               rtol=1e-4, atol=1e-4)
    _same_pool(kv_j, kv_t)


def test_extend_attends_through_the_ragged_family(weights, monkeypatch):
    """``paged_extend`` has no attention path of its own: one
    ``ragged_paged_attention`` call per layer."""
    _pj, pt = weights
    calls = []
    real = tp.ragged_paged_attention

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(tp, "ragged_paged_attention", counted)
    _kv_j, kv_t = _pool()
    tp.paged_extend(pt, kv_t, torch.from_numpy(_tables()[0]),
                    torch.zeros((1, 4), dtype=torch.long), 4, 7,
                    compute_dtype=torch.float32, **KW)
    assert calls == [(1, 4, N_HEADS, D_MODEL // N_HEADS)] * N_LAYERS


def test_pool_accounting():
    pool = tp.PagedKVPool(6, 4, 2, 2, 8, torch.float32, "cpu")
    assert pool.hbm_bytes == 2 * 6 * 2 * 4 * 2 * 8 * 4
    assert pool._alloc.bytes_in_use == pool.hbm_bytes
    assert pool.page_nbytes == pool.hbm_bytes // 6
    got = [pool.allocate_page() for _ in range(5)]
    assert 0 not in got and sorted(got) == [1, 2, 3, 4, 5]
    assert pool.allocate_page() is None and pool.free_pages == 0
    pool.add_ref(got[0])
    assert pool.refcount(got[0]) == 2
    pool.release_pages([got[0], 0])      # scratch page 0 never re-enters
    assert pool.refcount(got[0]) == 1 and pool.free_pages == 0
    pool.release_pages(got)
    assert pool.free_pages == 5 and pool.refcount(got[0]) == 0
    with pytest.raises(ValueError):
        pool.add_ref(got[0])
    assert pool.grow(2) == 2 and pool.n_pages == 8
    assert pool.kv.shape[1] == 8 and pool.hbm_bytes == pool.page_nbytes * 8
    assert pool.shrinkable_pages() == 7
    assert pool.shrink(3) == 3 and pool.kv.shape[1] == 5
    assert pool.free_pages == 4
    pool.kv[:, 1] = 1.0
    pool.reset()
    assert not pool.kv.any() and pool.free_pages == 4
    assert pool._alloc.bytes_in_use == pool.hbm_bytes
    pool.close()
    assert pool.hbm_bytes == 0 and pool._alloc.bytes_in_use == 0
