"""Long-context streaming: unbounded token stream -> windowed scoring
(the reference's cyclic_windowed_buffer capability promoted to a sequence
workload: window = sequence chunk, overlap = context carry-over) +
KV-cache generation.  The port of tpulab's
``examples/04_long_context_stream.py``.

    python -m tpulab_torch.examples.ex04_long_context_stream --chunks 12 \
        --window 256 --overlap 64 [--device cpu]
"""

import argparse

from tpulab_torch.examples._device import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=int, default=256, help="tokens/window")
    ap.add_argument("--overlap", type=int, default=64,
                    help="context carry-over tokens")
    ap.add_argument("--chunks", type=int, default=12)
    ap.add_argument("--generate", type=int, default=16,
                    help="tokens to generate after streaming")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from functools import partial

    import numpy as np
    import torch

    import tpulab_torch.memory as tm
    from tpulab_torch.core import CyclicWindowedTaskExecutor, ThreadPool
    from tpulab_torch.cuda.platform import resolve_device
    from tpulab_torch.models.transformer import (init_transformer_params,
                                                 make_generate_fn,
                                                 transformer_apply)

    device = resolve_device(args.device)
    vocab, d_model, heads, layers = 1024, 128, 4, 2
    params = init_transformer_params(vocab, d_model, heads, layers, 256,
                                     device=device)
    fwd = partial(transformer_apply, n_heads=heads, n_layers=layers,
                  compute_dtype=torch.float32)

    # window geometry in BYTES over int32 tokens
    tok_bytes = 4
    window_b = args.window * tok_bytes
    overlap_b = args.overlap * tok_bytes
    stride = args.window - args.overlap
    count = 4
    alloc = tm.make_allocator(tm.MallocAllocator())
    buf = alloc.allocate_descriptor(count * (window_b - overlap_b) + overlap_b)

    scores = []

    def score_window(wid, view):
        tokens = np.frombuffer(view, np.int32)[None, :]
        with torch.inference_mode():
            logits = fwd(params, {"tokens": torch.from_numpy(
                tokens.astype(np.int64)).to(device)})["logits"]
        # mean NLL of the window continuation (skip carried-over context)
        logp = logits[0, args.overlap - 1:-1].float().cpu().numpy()
        nxt = tokens[0, args.overlap:]
        nll = -(logp[np.arange(len(nxt)), nxt]
                - np.log(np.exp(logp).sum(-1))).mean()
        scores.append((wid, float(nll)))
        print(f"window {wid}: {len(nxt)} new tokens, nll={nll:.3f}")

    with ThreadPool(2) as pool:
        stream = CyclicWindowedTaskExecutor(
            buf, window_count=count, window_size=window_b, overlap=overlap_b,
            compute_fn=score_window, executor=pool)
        rng = np.random.default_rng(0)
        for _ in range(args.chunks):
            chunk = rng.integers(0, vocab, stride, dtype=np.int32)
            stream.append(chunk.tobytes())   # backpressure when all windows busy
        stream.sync_all()
    print(f"scored {len(scores)} overlapping windows over "
          f"{args.chunks * stride} streamed tokens (bounded memory: "
          f"{buf.size} bytes)")

    # KV-cache continuation from the final completed window (after
    # wrap-around the final window lives at slot (current-1) % count)
    gen = make_generate_fn(params, heads, layers,
                           max_len=args.window + args.generate,
                           compute_dtype=torch.float32)
    final_slot = (stream.current_window - 1) % count
    off = final_slot * (window_b - overlap_b)
    prompt = np.frombuffer(buf.memoryview()[off:off + window_b],
                           np.int32)[None, :]
    with torch.inference_mode():
        out = gen(torch.from_numpy(prompt[:, -32:].astype(np.int64))
                  .to(device), args.generate)
    print(f"generated continuation: {out.cpu().numpy()[0][:8]}...")
    stream.release()


if __name__ == "__main__":
    main()
