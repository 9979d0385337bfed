#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpulab_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # also trace serve run 3 of phase 5

Phases, each reported on its own lines with its seconds; any failure
raises and the script exits non-zero without printing a result:

1. device  — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.  TF32 is switched off for matmuls and cuDNN.
2. build   — the three kernel sources under ``tpulab_torch/ops/csrc/``
   (with the shared headers ``common.cuh`` and ``attn_wgmma.cuh``)
   compiled by ``nvcc`` (``--split-compile=0``), one process per source,
   all started together; build seconds, registers and spills per
   kernel.
3. kernels — every kernel's wrapper on the card held against its plain
   PyTorch version, with the tolerance set by the output dtype (f32
   rtol = atol = 1e-4; bf16 rtol 8e-3, one bf16 ulp, atol 4e-3), and a
   planted error per kernel that the same check must REJECT.  Each case
   also prints the body that ran (``wgmma``: bf16 on the tensor cores;
   ``fma``: f32 FMAs on CUDA cores; ``ring``: the paged kernel's one body)
   and, for ragged and paged, its split-KV count, and checks that a
   second launch gives a bit-identical output:
   - ragged_paged_attention at the serving geometry (Hq 32, Hkv 8, D 128,
     page 16, 8 lanes x 128 pages), eight shapes (``verify_k8``: the
     speculative verify forward at K=8, 9 rows a lane over 1033
     positions); planted: one page skipped at 2048 context;
   - flash_attention at B 1, H 32, D 128, T in {8, 64, 128, 512, 1024,
     2048} (the split serve's buckets among them), causal and not;
     planted: the diagonal K tile of every causal row past the first
     tile dropped, at T 2048; and at B 1, H 16, D 128, T 1024, causal,
     bf16 (a rank's prefill at {"model": 2}), the same planted error;
   - paged_decode_attention at the serving geometry: 8 lanes at positions
     1023 and 2047, and one lane at 2047; planted: one page skipped at
     2048 context; kernel 1's time at the same shape beside it;
   - e4m3 pools (the pages the kernels upcast themselves): kernel 1 at
     all_decode, chunk_over_ctx and verify_k8 with bf16 q (the ``wgmma``
     body, pages staged raw and converted in shared memory) and all_decode
     with f32 q (``fma``), kernel 3 at 8 x 1024 and 1 x 2048 (bf16 q);
     each also relaunched over a copy with 0x7F (NaN) in every dead
     position, which must not change one bit, and a skipped page
     rejected; times at 1 byte a KV element beside the 16-bit pool's
     (no library call takes e4m3 K/V: the SDPA column is n/a).
   Kernel, plain, bound and ``F.scaled_dot_product_attention`` (a
   labelled yardstick; the port never calls it) times per case, CUDA
   events with the L2 flushed.  Then the host time of one wrapper call
   per kernel and body (the tensor-map encodes, the split-KV scratch).
4. invariants — at full width with 2 layers: in bf16,
   ``paged_decode_block(k=8)`` equals 8 chained ``paged_decode_step``
   calls bit for bit, ``paged_mixed_step`` equals ``paged_ragged_forward``
   + the device pick, and the ``paged_decode_attention`` op, driven over
   every layer of that pool, agrees with the ragged kernel at decode
   shape; in f32, ``paged_prefill`` (flash) and ``paged_ragged_forward``
   over one 1500-token prompt give the same live pages and last logits,
   and the split and ragged plans give the same greedy tokens wherever
   the port's own top-1 margin exceeds 1e-3.  Speculation, f32 (layer
   1's wo / w2 scaled by 0.05): batchers with the 1-layer early-exit
   draft and with the target as its own draft give the streams of plain
   blocks (greedy and device-sampled) under the same margin rule, the
   self-draft accepts >= 90 % of a lone request's proposals, and the
   dense ``SpeculativeGenerator`` equals ``make_generate_fn``.  The host
   KV tier: a bf16 pool round trip of 98 scattered pages through the
   side stream, twice (bit-identical, no other page touched, page 0
   included); f32, both plans, a preempted victim resumed from the tier
   (no re-prefill), by re-prefill (``kv_offload=None``) and through a
   ``kvcache.swap`` chaos re-prefill against its unpreempted stream, and
   a prefill-batcher -> wire -> decode-batcher shipment against the
   unified stream, all under the margin rule.  int8 weights and e4m3
   pages: ``to_kv_dtype`` on the card == on the CPU over every bf16
   pattern and the f32 specials, one full-width layer quantized and
   ``qmat``'d on the card == on the CPU, bit for bit; at f32 over an
   e4m3 pool the K-block / mixed-step invariants and the decode op (f32
   queries), the e4m3 pool round trip (random bytes, NaN codes
   included), the preempt / chaos / shipment checks (wire bytes of the
   predicted length), and an int8 tree's speculating batcher against
   plain blocks, under the margin rule over an e4m3 replay.
5. serve   — ``ContinuousBatcher`` at the full width of Meta-Llama-3-8B
   (32 layers, random bf16 weights from a seed) serves a greedy /
   stop-token / device-sampled / logprobs / host-sampled / streaming
   request mix under the ragged plan, then (that batcher shut down) under
   the split plan (``ragged=False``: flash prefill, then K-blocks); then
   the same two serves with the int8 tree quantized on the card from the
   same weights over e4m3 pages (pool and weight bytes, tok/s and TTFT
   beside the bf16 serves'; with ``--profile`` run 3 of each serve
   traced for the device's busy share), and one decode forward's device
   time with each weight and page kind.  Per
   plan: lengths, ranges, stop token, logprobs, dispatch kinds, kernel
   launches == n_layers x the forwards that run each kernel, every one
   of them on the ``wgmma`` body (bf16), and a second identical run
   giving identical streams.  Prints tokens/s and time to first token
   per plan; no gain is claimed.  Then a preempting serve (4 lanes:
   victims of 300, 700, 1000 and 1500 tokens x 64 steps, outranked by
   two priority-10 requests once every victim has emitted its first
   token) on a batcher with the host tier (1 GiB) and one without:
   swap-outs == swap-ins == 2, no failure or drop, one prompt fill per
   request on the tier side and more without it, ragged launches == 32 x
   forward steps, pages balanced; swap bytes and times, each victim's
   resume time, and a synced round trip at each evicted lane's page
   count.  Then a disagg serve: a prefill and a decode batcher ship three
   prompts (1500, 700, 64 tokens) through the wire; zero prompt fills on
   the decode side.  Then the speculative serve: layers
   4-31's wo / w2 scaled by 0.05 in place (trained-model emulation), an
   8-request x 64-step mix (greedy, stop token, logprobs, device-sampled;
   no host-sampled lane) through a plain batcher and one with the
   early-exit draft of 4 layers (two page tables a lane); per mode runs
   2 and 3 identical, ragged launches == 32 x forward steps + 4 x draft
   forward steps, all on ``wgmma``, every page home at the end, and
   speculation really ran; tok/s, tokens per decode dispatch, host syncs
   per token and acceptance side by side.
6. infer   — the compiled-model Infer path at full width, none of the
   three kernels on it (ResNet convolves through cuDNN, ViT attends
   through plain ``dense_attention``): ``InferenceManager(
   max_exec_concurrency=4)`` registers ``build_model("resnet50",
   max_batch_size=128, input_dtype=np.uint8)`` (the README quickstart)
   and ``vit_b16`` the same way, random weights from the registry's seed.
   Checks, batch 2: each model's f32 forward on the card (TF32 off)
   against the port's CPU forward on the same weights, then the bf16
   serving forward against that f32 result (max abs error over max
   |logit| <= 1e-3 and 5e-2, top-1 equal where the margin is clear);
   ``infer_runner`` at batch 1, 3, 8 and 128 against the bucket's direct
   forward; one batch-8 request twice, bit for bit (cuDNN benchmark
   off); 64 requests from 8 threads against their sequential results,
   then every buffers slot, token and context back in its pool; a
   ``BatchedInferRunner`` over 64 batch-1 requests launching fewer
   batches than requests, its rows against the unbatched ones.  Then
   ``InferBench.run`` at batch 1, 8, 32 and 128 (images/s beside the
   compute bound: ``CompiledModel.flops`` per image over 989 TFLOP/s
   bf16), ``.latency`` at batch 1 (p50 / p90 / p99), and one
   torch.profiler window at batch 128: the device's busy share (the
   union of kernel intervals over the wall time) and kernel time by
   class (conv, gemm, elementwise, other).
7. hbm     — the HBM economy and weight multiplexing at full width: the
   ragged-plan batcher over a fresh Llama-3-8B-width bf16 tree as the
   KV tenant of an ``HBMArbiter`` (``n_pages=129``: one request's pages
   plus the scratch page, so the size ladder is 129 / 258 / 516 / 1032;
   ``kv_offload`` of 2 GiB), ResNet-50 and ViT-B/16 (phase 6's models)
   and the pinned LLM tree as the weights tenant of a
   ``WeightMultiplexer``.  A warm-up runs one request per mixed-round
   width and decode-block size, so every (program, shape key) measures
   its scratch first; the batcher's programs, which run one at a time,
   claim the largest key together (one claim, every key's measurement
   kept); the capacity is the LLM's bytes + the top rung + half a page +
   that claim, and the vision weights and the top rung must not fit
   together.  Trace: a ViT-B/16 Infer (batch 8); a greedy
   burst of 12 requests (1500 ... 300 tokens, 32 steps) with a ViT and a
   ResNet Infer from two threads once every lane has its first token;
   both Infers again after.  After every step ``arb.verify()`` holds and
   no byte is over-committed; the ledger is printed beside
   ``memory_allocated`` / ``memory_reserved``.  Checks: grows, shrinks,
   demotions and evictions each >= 1; one prompt fill per request and
   every host-tier snapshot restored (demoted lanes never re-prefill);
   kernel 1 launches == 32 x forward steps; no new scratch key in the
   trace; every Infer bit-identical to the unmultiplexed serve; every
   greedy stream equal to a no-arbiter, fixed 1032-page batcher's, or
   first differing where the two candidates lie within twice the bf16
   noise of that prefix (the most two bf16 computations move a pair of
   logits apart).  Then the 16 GB tree swapped out to a pinned
   ``HostParamStore`` and back, twice, through a ``BatcherAdapter``
   under a budget that holds the LLM or ViT-B/16, not both:
   ``memory_allocated`` falls by the tree's bytes as the swap-out lands,
   per-leaf checksums and a greedy request's tokens are unchanged;
   seconds and GB/s each way.
8. service — the serving front door at full width, driven through the
   server's own request behaviors (serialized requests in, serialized
   responses out, a local servicer context carrying metadata; where grpc
   is not installed ``InferenceManager.serve`` builds the service and
   its start raises the ImportError naming grpc, where it is the
   service also listens on a socket that this phase does not use):
   ResNet-50 (phase
   6's, uint8, max batch 128) and the Llama-3-8B-width ragged batcher
   (phase 5's, bf16) as the KV tenant of an ``HBMArbiter``, under an
   ``AdmissionController`` (max_inflight 8, queue 2, the batcher as its
   load source), ``batching=True``.  References first (the same
   requests through ``cb.submit`` and the direct runner), then every
   kernel count set to 0 and: Status (rn50's bucket ladder and IO specs,
   ``free_kv_pages`` == the batcher's, ``free_hbm_bytes`` == the
   arbiter's); Health; Infer at batch 1 and 8 bit-identical to the
   direct runner; StreamInfer, 16 pipelined requests of the max batch,
   each bit-identical to its unary twin; Infer p50 / p99 at batch 1
   through the service against the direct runner; a greedy and a
   device-sampled Generate stream (prompt 1500 x 32 steps) bit-identical
   to ``cb.submit`` with equal logprobs, TTFT and tok/s beside the
   direct run's; a burst of 8 streams against the direct burst (equal,
   or within the bf16 noise rule of phase 7 from the first difference);
   a burst of 12 past ``max_inflight`` (2 RESOURCE_EXHAUSTED with
   ``retry_after_ms`` > 0, every lane and page home); a client dropping
   after 4 tokens (its lane free within the dispatch in flight and one
   tick); an out-of-vocab prompt (INVALID_ARGUMENT) and an unknown model
   (UNKNOWN_MODEL); ``drain`` with an open stream (readiness off, returns
   after the stream).  Kernel 1's launches over the drive == 32 x its
   forward steps, all ``wgmma``; the service's mean stage profile.
9. obs     — the observability plane at full width, phase 5's model and
   config.  (a) ``benchmark_obs_overhead`` on the ragged-plan bf16
   batcher (8 lanes, page 16, K <= 8): a burst of 16 greedy requests of
   512 tokens x 32 steps, bare / armed / bare / armed, armed meaning a
   flight recorder, a ``ChromeTraceRecorder`` on ``trace=``,
   ``GenerationMetrics`` polled, a debugz poller every 20 ms and a
   running ``DeviceWatchdog``: tok/s and overhead per pair (printed, not
   gated), record assembly p50 / p99, the snapshot's time and its hold of
   the scheduler lock, records observed and retained; tokens
   bit-identical wherever a pair dispatched alike (``dispatch_kinds``,
   forward steps), else held by phase 7's bf16 noise rule.  (b) Through
   the service in process (``serve(flight=, metrics=, watchdog=, hbm=)``
   over the batcher under an ``HBMArbiter``, ``ChaosMetrics``
   installed): 8 uniform streams, one hit by ``engine.step=delay:0+1``
   (kept as ``chaos``), one over its 150 ms deadline under
   ``engine.step=delay:0.02+999`` (kept as ``deadline``); Debug
   mid-stream shows the live lane and the hbm and flight sections;
   Debug with ``profile_ticks=4`` returns a directory whose
   ``trace.json`` holds 32 x the captured forward steps of kernel 1
   launches; after it, on the main thread, arming under another
   profiler session raises and that session traces the card (kernel 1
   of the request it covers); then a second ``profile_ticks=4`` capture
   holds 32 x its forward steps again; a
   ``start_metrics_server(port=0)`` scrape on
   127.0.0.1 whose TTFT count equals the first tokens served and whose
   ``tpulab_chaos_injections_total{point="engine.step"}`` equals the
   schedules' trips; the watchdog healthy after 3+ canaries while
   serving, then a canary spinning on its own stream past the deadline
   turns Health not-ready within deadline + period and the restored
   canary ready again.  (c) Kernel 1's launches over the phase == 32 x
   every forward step of its batchers, all ``wgmma``.

10. batch  — the offline batch lane at full width: phase 5's ragged bf16
   batcher (8 lanes, ``max_len`` 2048, page 16, K <= 8, chunk 256, 1025
   pages) with a 2 GiB host tier, behind an ``AdmissionController``
   (the batcher as its load source).  Three ``BatchJob``s share one
   ``JSONLResultSink`` in a temporary directory: 8 greedy items, 7
   device-sampled (T 0.8, a seed) and 1 host-sampled, prompts of 256 ...
   768 tokens x 48 steps, each job fed by its own ``BatchScheduler``
   (4 + 3 + 1 in flight: the 8 lanes).  Every count set to 0, then each
   item served alone (the references); an online burst (8 greedy
   requests of 512 x 32) alone; run 1 soaks the lane, a burst arrives
   and preempts it, and once every online request has its first token
   ``batch.run=error`` kills the three runs mid-feed; a burst alone; run
   2 resumes from the sink while bursts arrive; a burst alone.  Gates:
   batch preemptions > 0 and no online request preempted; every partial
   greedy and device-sampled item continues at its delivered count and
   decodes only ``steps - delivered`` tokens (the run's generated tokens
   == those + the online bursts'), the host-sampled item restarts behind
   a ``reset`` record; every item's tokens equal the item served alone,
   or from the first difference every pick of both within the bf16 noise
   (phase 7's rule under the item's sampler: the Gumbel-perturbed scores
   for device sampling, the draw's cumulative interval for host
   sampling); every lane and page home; kernel 1's launches == 32 x the
   forward steps, all ``wgmma``.  Printed: ``soak_utilization``, items/s,
   online TTFT p50 / p99 soaking against alone, the resume's seconds to
   its first token.
11. fleet  — replica processes over gRPC sockets.  The parent frees its
   card memory first; ``SubprocessReplicaProvider`` starts three
   ``python -m tpulab_torch.fleet.replica_main`` processes at
   Llama-3-8B width (32 layers, bf16, untied head, seed 0, 4 lanes,
   ``max_len`` 2048, page 16, prefix cache on; each about 16 GB of
   weights, 1.08 GB of pages and its scratch), one with
   ``TPULAB_CHAOS=rpc.stream=kill@8``; nvidia-smi's used memory sampled
   each second.  (a) one lone greedy 512 x 32 request straight to each
   of the two plain replicas: the same tokens bit for bit.  (b) a
   ``GenerationReplicaSet(prefix_affinity=True, affinity_tokens=256)``
   over the two (``ReplicaSetMetrics``, a trace recorder), a
   ``FleetSupervisor`` with an ``EventJournal``: 12 requests over 3
   shared 256-token prefixes each land on the prefix's HRW home as the
   parent ranks it, and each home's prefix-cache hits grow; TTFT direct
   against through the set.  (c) the armed replica joins; a 512 x 32
   prompt whose HRW home it is streams through the set; the replica
   exits with code 86 mid-stream and the set resumes on a survivor:
   exactly 32 tokens, one resume, none replayed, the tokens before the
   kill equal the survivor's uninterrupted lone stream; after the fleet
   is gone the rest is held by the bf16 noise rule on weights rebuilt
   here from the seed.  (d) the supervisor calls the exit a death,
   respawns the lineage under backoff; the new member answers Status
   and serves (a)'s tokens; the journal replays without a sequence gap.
   (e) a stream held on every member, a ``FleetAutoscaler`` drains the
   newest: its stream finishes during the SIGUSR1 drain (the same tokens
   as the others'), SIGTERM exits 0, no death is recorded.  Kernel 1:
   each replica's Debug snapshot (its wrapper's launch count and its
   forward steps) read before it retires, launches == 32 x forward
   steps, all ``wgmma``; the killed replica's are lost and printed so.
   Printed: spawn to first Status, the failover gap, TTFT through the
   set against direct, the drain's seconds, peak memory.
12. fabric — the fleet KV fabric and the multi-router control plane at
   Llama-3-8B width: one bf16 tree (seed 0) under two split-plan
   batchers (``ragged=False``: flash prefill; 4 lanes, ``max_len`` 2048,
   page 16, K <= 8, a 2 GiB host tier, ``kv_publish=True``), A and B,
   each served on a loopback socket with ``serve(kvfabric=KVFabric(...),
   fleet=...)`` (HRW homes over 256-token prefixes, the cost gate off so
   that every eligible pull is taken and timed).  (a) a 1024-token prompt
   homed on A, served there greedy and device-sampled (T 0.8), then on
   B: B pulls it through A's FetchKV behavior in process (134 MB, past
   gRPC's default 4 MiB receive limit) — no prefill and no kernel 2 on
   B, pulls 2, degrades 0, 1024 tokens saved each; four concurrent B
   requests for a new A-homed prompt make one fetch.  (b) over the
   socket (``RemoteInferenceManager.fetch_kv``): a 16-token prompt (one
   page) pulls; a 512-token one degrades to B's local prefill on kernel 2
   and the client's status is printed.  (c) three ``FleetController``s
   (TTL 1 s, a tick every 0.1 s) over one ``FileLeaseBackend``, each
   with its own prefix-affinity replica set, supervisor, autoscaler
   (an ``InProcessReplicaProvider`` over the same tree: one scale-up
   adds a third batcher C) and journal; traffic through all three sets;
   exactly one leader at every 10 ms sample, every autoscaler decision
   by the lease's holder; the leader stopped without resigning, a
   follower leads within TTL + 2 ticks with a larger token, the old
   token's publish raises ``StaleLeaderError``, A's and B's Debug
   ``fleet`` sections agree on the new token, the journals replay with
   no sequence gap.  (d) ``FleetObserver.fleetz`` over A, B and C (lanes,
   free KV pages, free HBM bytes, kernels; the controller; the SLO
   document; the ``FederationMetrics`` exposition), then A shut down:
   fleetz reports it as data and a B request homed on A degrades to a
   local prefill.  Kernel 1 == 32 x the forward steps of A, B and C,
   kernel 2 == 32 x their prefill forwards; every stream equals its
   reference or passes phase 7's bf16 noise rule.  Printed: pull ms and
   GB/s, TTFT pulled against a cold local prefill, the socket pull, the
   takeover seconds, the fleetz scrape, peak memory.
13. parallel — ``tpulab_torch.parallel`` on an NCCL process group of
   world size 1 (one card: NCCL takes one rank a card), opened by
   ``multihost.initialize`` over a ``FileStore`` in a temporary
   directory, under a ``{"data": 1, "model": 1}`` CUDA mesh; every
   collective of the package runs through it.  (a) f32 at Llama-3-8B
   width, 2 layers, B 2 x T 256: the loss and every parameter's gradient
   through the flash kernel (its f32 ``fma`` body, the blockwise
   backward) against dense ``causal_attention``'s autograd (loss rel
   <= 1e-5, per leaf max |diff| / max |g| <= 1e-4), the sharded step's
   first loss both ways, then 4 flash steps at lr 5e-2 on one batch:
   the loss falls.  (b) bf16 at full width and depth (32 layers, B 1 x
   T 2048): 3 steps of
   ``make_sharded_train_step`` with ``make_flash_attention_fn``, ms per
   step (synchronized), tokens/s, ``max_memory_allocated``; kernel 2
   launches == 32 x 3 exactly (forward only: the backward is plain
   PyTorch, as tpulab's) and no other kernel; finite losses.  On the
   step's weights before step 1, each bf16 forward's mean per-token
   |NLL - NLL of the f32 dense forward|: the flash forward's within
   twice the dense bf16 forward's, a planted fault (flash without the
   causal mask) beyond it; step 1's loss equals the flash forward's mean
   NLL within 1e-5.  (c) checkpoint at full width, 2
   layers, bf16: ``TrainCheckpointer.save`` after step 1
   (asynchronous: step 2 runs while it writes), restored into a fresh
   tree through ``abstract_like``: step 2 again equals the uninterrupted
   step 2 bit for bit (loss and every parameter); save and restore
   seconds and bytes, then the directory deleted.  (d) at world size 1,
   bit for bit against their single-device forms: ring attention (its
   one-block form; and plain attention within the bf16 tolerance) and
   Ulysses (``dense_attention``) at B 1, T 2048, H 32, D 128, bf16; the
   expert-parallel FFN against ``moe_ffn`` at Mixtral-8x7B's widths (N
   512, bf16); the pipeline against its stage (4 microbatches).  (e)
   ``make_moe_transformer`` at Mixtral-8x7B's widths on tpulab's GELU
   expert block (d 4096, f 14336, 8 experts, top-2, vocab 32000, 2
   layers, seq 512, bf16 compute, f32 weights) served through the
   port's ``InferenceManager`` and through a ``MultiDeviceDispatcher``
   of two managers on ``cuda:0``: logits finite and bit-equal to the
   direct ``apply_fn``; ms per batch.  (f) ``python -m
   tpulab_torch.parallel.dryrun --nproc 1`` as a subprocess exits 0
   (tpulab's dry-run sequence on one NCCL rank); ``--nproc 2`` exits
   non-zero with "need 2 devices, have 1".

14. sharded — the paged serving path under a tensor-parallel mesh at
   Llama-3-8B width (32 layers, random bf16 weights from phase 5's seed;
   8 lanes, ``max_len`` 2048, page 16, K <= 8, the ragged plan): 8
   requests (prompts of 1000 ... 16 tokens x 32 steps, even ones greedy,
   odd ones device-sampled at T 0.8), after a 2-token warm-up request,
   through ``ContinuousBatcher`` at (a) ``mesh=None`` and (b) ``mesh=make_mesh({"model": 1})`` on an NCCL
   group of one rank: streams bit-identical, kernel 1 launches == 32 x
   forward steps, all on ``wgmma``.  (c) two spawned ranks share the
   card over gloo's CUDA collectives (``multihost.initialize(...,
   backend="gloo")``; NCCL takes one rank a card), each cutting its
   shards of the same weights leaf by leaf on the card (Hq 16, Hkv 4 a
   rank) and serving the mix on ``{"model": 2}``: each rank's kernel 1
   launches == 32 x the coordinator's forward steps, and every stream
   equals mesh=None's or passes phase 7's bf16 noise rule; tok/s and
   peak memory per rank.  The same two ranks then run (e) the split plan
   (``ragged=False``, no chunking) as a KV-fabric owner
   (``kv_publish``): four greedy prompts (1000, 500, 200, 64 tokens) x 8
   steps, kernel 2 on each rank's 16 query heads: kernel 2 launches per
   rank == 32 x the prefills and kernel 1 == 32 x the forward steps, all
   ``wgmma``, one publish a prompt, the streams against (a)'s under the
   noise rule; the 1000-token prompt's blob is pulled into a mesh=None
   batcher (no prefill there) whose continuation matches the owner's
   under the same rule.  (f) a ``WeightMultiplexer`` on the coordinator
   over the batcher's ``BatcherAdapter`` (the whole tree's bytes) and a
   2 GiB second servable: registering the servable pushes the weights
   out (each rank's device memory falls by its shard; swap-out seconds,
   the follower's replayed copy timed), an acquire brings them back, and
   one greedy request's 8 tokens are bit-identical before and after.
   (d) the int8 tree, each projection quantized whole on each rank's
   card and cut by its parent's rule (half the int8 bytes a rank), on
   the mix's last four requests x 16 steps, against the same tree
   quantized on the card at mesh=None: kernel 1 launches per rank == 32
   x the forward steps, all ``wgmma``; streams equal or within the noise
   rule over an int8 replay.
15. rows   — tpulab's eleven bench rows through the port's functions,
   each once, its JSON on a line of its own.  At Llama-3-8B width on one
   bf16 tree (seed 0): ``benchmark_decode_dispatch`` (K 1 / 4 / 8 / 16,
   4 lanes x 32 steps, prompt 8; tpulab's 48 steps cut for time),
   ``benchmark_speculative_decode`` (k 8, 2 lanes x 32 steps, cut the
   same way, the 4-layer early-exit draft, tail scale 0.05),
   ``benchmark_ragged_attention`` (3 lanes x 24 steps, prompt 12: the
   split plan with flash prefill against the ragged plan) and
   ``benchmark_llm_decode`` (8 lanes at context 1024, page 16, 64 steps
   a pass; the int8 tree quantized from the same one).  At tpulab's own
   geometry: ``benchmark_decode_kernel_sweep`` (d 1024, 4 layers, page
   32; (8, 2048), (32, 2048), (8, 8192), (8, 16384)) and the dense
   ``benchmark_speculative``.  At the arguments of tpulab's bench.py,
   f32, at d_model 256 over 4 heads where bench.py's d_model 64 would
   give head dim 16 (no kernel is built for it): ``benchmark_kv_offload``
   (4 + 4 requests, 20 steps), ``benchmark_disagg`` (8 x 48 tokens x 8
   steps), ``benchmark_hbm_arbiter`` (12 requests) and
   ``benchmark_multi_model`` (6 switches x 8 steps).  The batchers each
   row builds are recorded; the phase fails on any ``error`` key, a
   tok/s <= 0, kernel 1 launches other than n_layers x forward steps (+
   draft layers x draft forwards + the speculative row's block-size
   warm-up) or kernel 2 launches other than n_layers x the split plan's
   prefill forwards (the sweep and llm_decode: n_layers x 3 x iters a
   timed pass set, the gather side none), syncs per token not falling
   as K grows (each ``decode_dispatch`` burst's head decoding before the
   rest are queued, the card's usual order, made certain), int8
   megabytes not below bf16's, no hbm demotion or
   eviction, or a disagg run whose shipments are not one a request with
   no failure and no decode-side prefill.  Parity flags: ``parity_vs_k1`` and the multi-model flags
   bit for bit; the speculative and ragged rows' (bf16) by phase 7's
   bf16 noise rule over the recorded stream pairs; the dense
   ``exact_match``, disagg's and hbm's tokens (f32) by phase 4's margin
   rule (hbm's model outputs bit for bit).  Seconds per row printed.

16. import — bring-your-own-model at full width, run after phase 6
   (trtlab's model-entry workflow: parse, build, verify, serialize a
   plan, serve).  (a) ResNet-50 written as ONNX by
   ``tests/torch_onnx_util.py`` from seeded f32 weights (224 x 224, 1000
   classes, NCHW, every conv ``SAME_UPPER``, BatchNormalization
   unfolded), ``load_onnx_model(max_batch_size=32)``, served through an
   ``InferenceManager`` -> ``InferRunner``; the runner's rows are the
   bucket program's bit for bit, and the logits are the native
   ``make_resnet(depth=50)``'s on the folded weights and the model's own
   CPU run's within 1e-3 of max |logit| (f32, TF32 off); imported again
   with ``weight_quant="int8"`` (within 0.1); ``save_engine`` (its
   weights at buckets 8 and 32: cut, each ``torch.export`` trace took
   10-17 s on the H100's host) -> ``register_engine`` with no
   ``apply_fn`` serves the in-memory model's logits bit for bit (runner
   at batch 8, buckets 8 and 32); ``memory_analysis``; save and load
   seconds.  (b)
   ``build_model("resnet50_int8")`` (W8) and W8A8 calibrated on 4 seeded
   batches of 8 from the same f32 draw: against that draw's f32 forward
   tpulab's bounds (W8: max abs error < 0.1 x max |logit|, correlation >
   0.99; W8A8: correlation > 0.95), top-1 agreement printed; three W8A8
   convs' int32 accumulators (``torch._int_mm``; the stem's K 147 padded
   to 152) equal to the CPU's int64 products; a
   ``TimedBenchmarkWorkspace`` at bucket 8 captured as a CUDA graph for
   each: the replay bit-identical to the eager bucket program, its
   compute time beside the eager forward's.  (c) a torchvision-named
   ResNet-50 (``make_resnet_from_torch``) and an HF-named ViT-B/16
   (``make_vit_from_hf``), uint8, served (f32 card vs CPU <= 1e-3, bf16
   vs f32 <= 5e-2, the runner bit for bit); an HF-named Llama-3-8B-width
   state dict (bf16, cut to 4 layers) through
   ``llama_params_from_torch`` on the card (every leaf equal to the f32
   tree it was made from) into the ragged batcher: phase 14's 8-request
   mix bit-identical to the batcher over that tree, kernel 1 launches ==
   4 x forward steps.  InferBench images/s at batch 32 for bf16, ONNX
   f32, ONNX int8, W8, W8A8 and the loaded artifact.

17. memory — tpulab's memory library and the device layer's memory side,
   run last.  (a) ``make_cuda_allocator()``'s device blocks under the
   framework: a cached ``BlockArena`` of 64 MiB blocks (a freed block
   comes back at its address, nothing new allocated; none live after
   ``shrink_to_fit``), ``test_memory.py``'s transactional sequences
   (bump, rotate, whole-stack release, an oversize refusal) and its
   best-fit sequence (the 2000-byte hole reused, spans coalesced), a
   device descriptor carrying its tensor; ``memory_allocated`` moves by
   exactly the live blocks' bytes at every step.  (b)
   ``make_staging_allocator()``: a 256 MiB node, page-aligned,
   first-touched and ``is_pinned()`` (``cudaHostRegister``); H2D and D2H
   GB/s against the same copies from ``MallocAllocator``'s pageable
   memory (CUDA events, median of 5); behind a device spin the pinned
   H2D returns with the copy still pending.  (c) ``Buffers(1024,
   block_size=1024)``: two 800-byte page-locked views from two blocks,
   both back on ``reset()``.  (d) a 16,384-token int32 stream (seed 17)
   appended 512 tokens at a time through a ``CudaCyclicWindowedStack``
   over a pinned descriptor (4 windows of 2,048 tokens, overlap 512, one
   executor thread), each window's continuation NLL scored by the
   Llama-3-8B-width bf16 forward (32 layers, seed 0) on kernel 2: 10
   windows, each computed on the bytes appended, kernel 2 launches == 32
   x windows, each NLL within 5e-2 nats of the plain attention's forward
   of the same window, the host staging never past the descriptor;
   tokens/s.  (e) ``python -m tpulab_torch.tools.build_engine --model
   resnet50 --max-batch 2`` as a subprocess (the card by default): its
   artifact, loaded with no ``apply_fn``, gives the in-memory model's
   logits bit for bit at bucket 2; ``python -m
   tpulab_torch.tools.onnx_summary`` on phase 16's ResNet-50 ONNX
   (written again) exits 0, importable.  (f) ``DeviceInfo``: the name
   is nvidia-smi's, ``bytes_limit`` is ``mem_get_info``'s total,
   ``peak_flops("bf16")`` 989.4e12, ``cpu_affinity`` CPUs of this host.

18. dtypes — f16 compute and f16 / e5m2 pages, and the programs users
   run, last.  (a) On the serving geometry (Hq 32, Hkv 8, D 128, page
   16, 8 lanes x 128 pages): kernel 1 over f16 q / f16 pages, bf16 and
   f16 q / e5m2 pages (all_decode, chunk_over_ctx, verify_k8; the
   ``wgmma`` body in q's type) and the two mixed ``fma`` cells (bf16 q /
   f16 pages, f16 q / bf16 pages; all_decode); kernel 3 over the three
   pools at 8 x 1024 and 1 x 2048; kernel 2 at f16, T 2048 (H 32) and T
   1024 (H 16), causal; each against its plain version on the same
   bytes (f16 rtol 2e-3, atol 1e-3), relaunched bit for bit, e5m2 pools
   relaunched over 0x7F (NaN) in every dead position without a bit
   moving, a skipped page and a dropped diagonal tile rejected; times
   beside the bf16 and e4m3 rows of phase 3 and SDPA at f16 (n/a for
   e5m2 and mixed types).  Kernels 1 and 2 at D 32 (``ex07``'s heads) on
   their ``fma`` body.  (b) The card's ``.to(float16 / float8_e5m2 /
   float8_e4m3fn)`` over every bf16 and f16 pattern and the f32 specials
   equals the CPU's on every number (its NaN codes differ: counted), and
   ``to_kv_dtype`` equals the CPU's on every input.  (c) At Llama-3-8B
   width (8 layers, seed 0), under both plans: an f16-compute serve
   (f16 pages) of a 4-request burst, and a bf16 serve over e5m2 pages
   with its one lane's victim preempted to the host tier and restored;
   launches by form (``wgmma f16`` / ``wgmma bf16``) == n_layers x the
   forward steps (kernel 1) and the prefills (kernel 2); each stream
   against the same batcher on plain attention, equal or within twice
   the kernel-vs-plain noise of the plain replay's top.  (d) ``python -m
   tpulab_torch.examples.ex07_llm_server --oneshot`` at its default
   width and with ``--kv-fp8`` (its own client, 16 greedy tokens),
   ``ex30_python_api`` and ``ex04_long_context_stream``, at once; then
   ``ex00_basic_infer --model resnet50 --batch-size 8 --seconds 3``;
   each exits 0 with its own printed checks.

The line before the last is the kernels JSON, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Meta-Llama-3-8B's config.json geometry (random weights)
LLAMA3_8B = dict(vocab=128256, d_model=4096, n_heads=32, n_kv_heads=8,
                 d_ff=14336, n_layers=32, rope_theta=500000.0)
SERVE = dict(lanes=8, max_len=2048, page_size=16, decode_block=8,
             prefill_chunk=256)
# the split plan: one full-prompt flash prefill per request, then K-blocks
SPLIT = dict(ragged=False, prefill_chunk=None, prefix_cache=False)
KERNELS = ("ragged_attention", "flash_attention", "paged_attention")
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}   # dense tensor-core bf16; f32 FMA
# (rtol, atol) by the OUTPUT dtype.  f32: both sides read the same values
# and sum in f32, only the order differs (~1e-6 measured).  bf16: the
# kernel's tensor-core body also rounds P to bf16 before P V (2^-9
# relative per weight, averaged over the keys a row sees), and both sides
# round the output to bf16 at the end, so a last-place flip (2^-8 to
# 2^-7 relative) is the expected difference; rtol 8e-3 allows one and
# atol 4e-3 covers outputs near zero.  f16: the same two roundings in
# f16 (P to f16, 2^-12 relative; the output, a last-place flip 2^-11 to
# 2^-10 relative): rtol 2e-3 allows a flip of outputs in [1, 4), atol
# 1e-3 covers outputs near zero.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 4e-3),
       "float16": (2e-3, 1e-3)}
# the split and ragged plans may pick different greedy tokens only where
# the two best f32 logits lie closer than this (their logits differ by
# ~1e-5: summation order)
MARGIN_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- timing
class Timer:
    """CUDA-event timing of single launches with the 50 MB L2 flushed in
    between (outside the timed span): each launch finds its inputs cold,
    as a layer of a real step does.  A short device spin before the start
    event keeps the wrapper's host-side cost out of the measured span.
    ``flush``: "dirty" (the default: 64 MB written, so the launch also
    pays to write back the dirty lines it evicts), "clean" (64 MB read)
    or "warm" (no flush: inputs may sit in L2)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int, warmup: int = 2,
                 flush: str = "dirty") -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            if flush == "dirty":
                self.flush.zero_()
            elif flush == "clean":
                self.flush.sum(dtype=torch.int32)
            torch.cuda._sleep(1_000_000)    # ~0.5 ms: the host enqueues fn
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def check_close(torch, label, got, want):
    """Kernel vs plain at the output dtype's tolerance; returns the max
    abs error or raises."""
    rtol, atol = TOL[dtype_name(got.dtype)]
    err = (got.float() - want.float()).abs().max().item()
    if (not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
            or not torch.isfinite(got).all()):
        raise AssertionError(f"kernel != plain: {label} max_abs_err={err} "
                             f"rtol={rtol} atol={atol}")
    return err


def check_rejects(torch, label, got, planted):
    """The same comparison must FAIL against a planted error."""
    rtol, atol = TOL[dtype_name(got.dtype)]
    shift = (got.float() - planted.float()).abs().max().item()
    if torch.allclose(got.float(), planted.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: the tolerance passes the planted "
                             f"error (max shift {shift:.2e})")
    log(f"kernels: planted {label}: max shift {shift:.2e}, rejected at "
        f"rtol {rtol:g} atol {atol:g}")


def launch_twice(torch, label, wrapper, call, body=None):
    """Two launches through ``wrapper`` (``call()`` launches it once):
    both must run ``body`` (a wrapper with one body: both must count)
    and give bit-identical outputs.  Returns the first output."""
    before = dict(wrapper.launches_by_body) if body else wrapper.launches
    got = call()
    again = call()
    torch.cuda.synchronize()
    if body:
        ran = {k: n - before[k] for k, n in wrapper.launches_by_body.items()}
        if ran != {k: 2 if k == body else 0 for k in ran}:
            raise AssertionError(f"{label}: bodies {ran}, want 2 x {body}")
    elif wrapper.launches - before != 2:
        raise AssertionError(f"{label}: {wrapper.launches - before} "
                             "launches counted, want 2")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: a second launch is not bit-identical")
    return got


def bound(nbytes, ops, kind):
    """Least time (ms) for the work, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_decode_ms(torch, timer, q, pool, tables, vis, rep):
    """Yardstick: SDPA over the pre-gathered, GQA-expanded context with an
    additive mask (the gather is not timed).  q (B, M, Hq, D); vis
    (B, M, T) visible positions."""
    import torch.nn.functional as F

    b, m, hq, d = q.shape
    _, _, s, hkv, _ = pool.shape
    t = tables.shape[1] * s
    ctx = pool[tables.long()]
    kd = ctx[:, :, 0].reshape(b, t, hkv, d).repeat_interleave(rep, 2)
    vd = ctx[:, :, 1].reshape(b, t, hkv, d).repeat_interleave(rep, 2)
    kd, vd = (x.transpose(1, 2).to(q.dtype).contiguous() for x in (kd, vd))
    qd = q.transpose(1, 2).contiguous()
    mask = torch.zeros(vis.shape, dtype=q.dtype, device="cuda")
    neg = max(-1e30, torch.finfo(q.dtype).min)   # f16 holds -65504 at most
    mask = mask.masked_fill(~vis, neg)[:, None]
    return timer(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask), iters=5)


# ---------------------------------------------------------------- phase 2
def phase_build():
    """One nvcc per source, all started together; then load each."""
    from concurrent.futures import ThreadPoolExecutor

    from tpulab_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        built = list(ex.map(_build.compile_library, KERNELS))
    for name, (path, secs, nvlog) in zip(KERNELS, built):
        lines = nvlog.splitlines()
        regs = [int(w) for line in lines if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = sum(1 for line in lines if "spill" in line
                     and not line.strip().startswith(
                         "0 bytes stack frame, 0 bytes spill stores, "
                         "0 bytes spill loads"))
        log(f"build: {name} -> {os.path.relpath(path, HERE)} ({secs:.1f} s; "
            f"{len(regs)} instantiations, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{spills} with spills)")
        _build.load(name)
    log(f"build: phase {time.perf_counter() - t0:.1f} s (parallel)")


# ---------------------------------------------------------------- phase 3
RA_GEOM = dict(hq=32, hkv=8, d=128, s=16, b=8, mp=128)


def ra_cases():
    """(name, q_lens, kv_lens) at 8 lanes, pages of 16, 128 pages a lane."""
    return [
        ("all_decode", [1] * 8, [1024] * 8),
        ("all_prefill", [256] * 8, [256] * 8),
        ("chunk_over_ctx", [256] * 8, [1024] * 8),
        ("mixed", [1, 256, 5, 0, 1, 100, 1, 17],
         [1024, 1280, 37, 0, 2000, 600, 16, 33]),
        ("verify", [5] * 8, [5, 21, 200, 512, 1024, 1500, 2000, 2048]),
        ("page_cross", [4, 4, 1, 1, 16, 16, 3, 2],
         [18, 32, 17, 16, 48, 16, 33, 64]),
        ("long_decode", [1] * 8, [2048] * 8),
        # a speculative verify forward at K=8: 9 rows a lane
        ("verify_k8", [9] * 8, [1033] * 8),
    ]


def ra_bound(q_lens, kv_lens, m, q_es, kv_es, kind):
    """K/V rows each lane's queries can see plus valid q rows read once,
    the whole output written once; 4*D*Hq operations per (query, visible
    key) pair."""
    g = RA_GEOM
    kv_bytes = sum(kv if q else 0 for q, kv in zip(q_lens, kv_lens)) \
        * g["hkv"] * g["d"] * 2 * kv_es
    q_bytes = sum(q_lens) * g["hq"] * g["d"] * q_es
    out_bytes = g["b"] * m * g["hq"] * g["d"] * q_es
    meta = g["b"] * g["mp"] * 4 + 2 * g["b"] * 4
    pairs = sum(kv - q + j + 1 for q, kv in zip(q_lens, kv_lens)
                for j in range(q))
    return bound(kv_bytes + q_bytes + out_bytes + meta,
                 4 * g["d"] * g["hq"] * pairs, kind)


def serving_pool(torch, np, rng):
    """An f32 pool at the serving geometry and scattered page tables, as
    a long-running pool hands them out."""
    g = RA_GEOM
    n_pages = g["b"] * g["mp"] + 1
    pool32 = torch.from_numpy(rng.standard_normal(
        (n_pages, 2, g["s"], g["hkv"], g["d"])).astype(np.float32)).cuda()
    tables = torch.from_numpy(
        (rng.permutation(n_pages - 1) + 1).astype(np.int32).reshape(
            g["b"], g["mp"])).cuda()
    return pool32, tables


DTYPE_MIXES = (("bf16/bf16", "bfloat16", "bfloat16"),
               ("f32/f32", "float32", "float32"),
               ("f32/bf16", "float32", "bfloat16"))


def phase_ragged(torch, timer):
    import numpy as np

    from tpulab_torch.ops.ragged_attention import (
        _sm_count, ragged_body, ragged_paged_attention,
        ragged_paged_attention_reference, ragged_splits)

    g = RA_GEOM
    rng = np.random.default_rng(0)
    pool32, tables = serving_pool(torch, np, rng)
    t = g["mp"] * g["s"]
    n_sm = _sm_count(torch.cuda.current_device())
    rows = []
    for dname, q_name, kv_name in DTYPE_MIXES:
        q_dt, kv_dt = getattr(torch, q_name), getattr(torch, kv_name)
        pool = pool32.to(kv_dt)
        kind = "bf16" if dname == "bf16/bf16" else "f32"
        for name, q_lens_l, kv_lens_l in ra_cases():
            m = max(q_lens_l)
            q = torch.from_numpy(rng.standard_normal(
                (g["b"], m, g["hq"], g["d"])).astype(np.float32)).cuda()
            q = q.to(q_dt)
            q_lens = torch.tensor(q_lens_l, dtype=torch.int32, device="cuda")
            kv_lens = torch.tensor(kv_lens_l, dtype=torch.int32,
                                   device="cuda")
            args = (q, pool, tables, q_lens, kv_lens)
            body = ragged_body(q_dt, kv_dt, g["d"])
            splits = ragged_splits(g["b"], m, g["hq"], g["hkv"], g["mp"],
                                   g["s"], n_sm, body)
            got = launch_twice(torch, f"ragged {name} {dname}",
                               ragged_paged_attention,
                               lambda: ragged_paged_attention(*args), body)
            err = check_close(torch, f"ragged {name} {dname}", got,
                              ragged_paged_attention_reference(*args))
            if name == "long_decode":
                # a kernel that skipped page 5 of every lane at decode
                skip = torch.cat([tables[:, :5], tables[:, 6:],
                                  tables[:, :1]], 1)
                check_rejects(torch, f"ragged skipped page, 2048 context, "
                              f"{dname}", got,
                              ragged_paged_attention_reference(
                                  q, pool, skip, q_lens, kv_lens - g["s"]))
            ms = timer(lambda: ragged_paged_attention(*args), iters=20)
            plain_ms = timer(lambda: ragged_paged_attention_reference(*args),
                             iters=3, warmup=1)
            pos = (kv_lens - q_lens)[:, None] + torch.arange(m,
                                                             device="cuda")
            ar = torch.arange(t, device="cuda")[None, None]
            vis = (ar <= pos[..., None]) & (ar < kv_lens[:, None, None])
            lib_ms = sdpa_decode_ms(torch, timer, q, pool, tables, vis,
                                    g["hq"] // g["hkv"])
            bound_ms, bound_by = ra_bound(q_lens_l, kv_lens_l, m,
                                          q.element_size(),
                                          pool.element_size(), kind)
            rows.append(dict(case=name, dtypes=dname, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms,
                             body=f"{body} x{splits}"))
            log(f"kernels: ragged {name:<14} {dname:<9} {body:<5} x{splits:<2} "
                f"err={err:.2e} kernel={ms:.4f} plain={plain_ms:.4f} "
                f"bound={bound_ms:.4f} ({bound_by}) ms | yardstick, unused "
                f"by the port: sdpa={lib_ms:.4f} ms")
        del pool
    return rows


FA_GEOM = dict(b=1, h=32, d=128)
FA_TS = (8, 64, 128, 512, 1024, 2048)   # the split serve's buckets among them
FA_TILE = 64                     # the kernel's query tile


def masked_plain(torch, q, k, v, mask):
    """The plain f32 attention under an explicit (T, T) mask."""
    s = torch.einsum("bqhd,bkhd->bhqk",
                     q.float() * (1.0 / math.sqrt(q.shape[3])), k.float())
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


#: the split plan's prefill under {"model": 2} at Llama-3-8B width: each
#: rank attends over its 16 query heads (phase 14 (e)); prompts of 513 to
#: 1024 tokens pad to this bucket
FA_RANK = dict(b=1, h=16, d=128, t=1024)


def phase_flash(torch, timer):
    import numpy as np

    g = FA_GEOM
    rng = np.random.default_rng(1)
    rows = []
    for dname in ("bfloat16", "float32"):
        for t in FA_TS:
            for causal in (True, False):
                rows.append(flash_case(torch, timer, rng, g["b"], g["h"],
                                       g["d"], t, dname, causal,
                                       causal and t == FA_TS[-1]))
    g = FA_RANK
    rows.append(flash_case(torch, timer, rng, g["b"], g["h"], g["d"], g["t"],
                           "bfloat16", True, True))
    return rows


def flash_case(torch, timer, rng, b, h, d, t, dname, causal, planted):
    """One flash case against its plain version (and, with ``planted``, a
    kernel that skipped the diagonal tile of every row past the first
    tile, which the check must reject); times beside the bound and SDPA."""
    import numpy as np
    import torch.nn.functional as F

    from tpulab_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_reference,
                                                  flash_body)

    dt = getattr(torch, dname)
    kind = "f32" if dt == torch.float32 else "bf16"   # f16's peak is bf16's
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, t, h, d)).astype(np.float32)).cuda().to(dt) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    label = f"T={t} {'causal' if causal else 'full'}"
    if h != FA_GEOM["h"]:
        label += f" H={h}"
    body = flash_body(dt, d)
    got = launch_twice(
        torch, f"flash {label} {dname}", flash_attention,
        lambda: flash_attention(q, k, v, causal=causal), body)
    err = check_close(torch, f"flash {label} {dname}", got,
                      flash_attention_reference(q, k, v, causal))
    if planted:
        i = torch.arange(t, device="cuda")
        qi, ki = i[:, None] // FA_TILE, i[None, :] // FA_TILE
        mask = (i[None, :] <= i[:, None]) & ~((ki == qi) & (qi > 0))
        check_rejects(torch, f"flash diagonal tile dropped, {label}, "
                      f"{dname}", got, masked_plain(torch, q, k, v, mask))
    ms = timer(lambda: flash_attention(q, k, v, causal=causal), iters=10)
    plain_ms = timer(lambda: flash_attention_reference(q, k, v, causal),
                     iters=3, warmup=1)
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), iters=10)
    pairs = b * (t * (t + 1) // 2 if causal else t * t)
    bound_ms, bound_by = bound(4 * b * t * h * d * q.element_size(),
                               4 * d * h * pairs, kind)
    log(f"kernels: flash {label:<12} {dname:<8} {body:<5} "
        f"err={err:.2e} kernel={ms:.4f} plain={plain_ms:.4f} "
        f"bound={bound_ms:.4f} ({bound_by}) ms | yardstick, "
        f"unused by the port: sdpa={lib_ms:.4f} ms")
    return dict(case=label, dtypes=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, body=body)


def host_us(torch, call, n=200):
    """Mean host time (us) of one wrapper call: what the host spends to
    enqueue it (fewer launches than the device queue holds, drained
    before and after)."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def phase_host(torch):
    """Host cost per wrapper call: a wgmma flash call encodes three TMA
    tensor maps, a split ragged or paged call allocates its f32 scratch
    and launches the merge as well."""
    import numpy as np

    from tpulab_torch.ops.flash_attention import flash_attention
    from tpulab_torch.ops.paged_attention import (paged_decode_attention,
                                                  paged_splits)
    from tpulab_torch.ops.ragged_attention import (_sm_count,
                                                   ragged_paged_attention,
                                                   ragged_splits)

    g, rng = RA_GEOM, np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal(
        (3, 1, 512, FA_GEOM["h"], FA_GEOM["d"])).astype(np.float32)).cuda()
    us = {}
    for name, dt in (("wgmma", torch.bfloat16), ("fma", torch.float32)):
        q, k, v = qkv.to(dt)
        us[f"flash {name}"] = host_us(torch, lambda: flash_attention(q, k, v))
    pool32, tables = serving_pool(torch, np, rng)
    pool = pool32.to(torch.bfloat16)
    n_sm = _sm_count(torch.cuda.current_device())
    for m, kv in ((1, 1024), (256, 1024)):
        splits = ragged_splits(g["b"], m, g["hq"], g["hkv"], g["mp"],
                               g["s"], n_sm)
        q = torch.from_numpy(rng.standard_normal(
            (g["b"], m, g["hq"], g["d"])).astype(np.float32)).cuda().to(
                torch.bfloat16)
        lens = [torch.full((g["b"],), n, dtype=torch.int32, device="cuda")
                for n in (m, kv)]
        us[f"ragged wgmma x{splits}"] = host_us(
            torch, lambda: ragged_paged_attention(q, pool, tables, *lens))
    for b in (g["b"], 1):
        splits = paged_splits(b, g["hkv"], g["mp"], g["s"], n_sm)
        q = torch.from_numpy(rng.standard_normal(
            (b, g["hq"], g["d"])).astype(np.float32)).cuda().to(
                torch.bfloat16)
        pos = torch.full((b,), 1023, dtype=torch.int32, device="cuda")
        us[f"paged ring {b} lanes x{splits}"] = host_us(
            torch, lambda: paged_decode_attention(q, pool, tables[:b], pos))
    log("kernels: host time per wrapper call (enqueue, mean of 200): "
        + ", ".join(f"{k} {v:.1f} us" for k, v in us.items())
        + " (flash wgmma: three tensor-map encodes; a split ragged or "
        "paged call: scratch allocation and the merge launch)")


# (lanes, inclusive current position) of each case
PD_CASES = ((8, 1023), (8, 2047), (1, 2047))


def phase_paged(torch, timer):
    import numpy as np

    from tpulab_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference,
        paged_splits)
    from tpulab_torch.ops.ragged_attention import (_sm_count,
                                                   ragged_paged_attention)

    g = RA_GEOM
    rng = np.random.default_rng(2)
    pool32, tables8 = serving_pool(torch, np, rng)
    t = g["mp"] * g["s"]
    n_sm = _sm_count(torch.cuda.current_device())
    rows = []
    for dname, q_name, kv_name in DTYPE_MIXES:
        q_dt, kv_dt = getattr(torch, q_name), getattr(torch, kv_name)
        pool = pool32.to(kv_dt)
        kind = "bf16" if dname == "bf16/bf16" else "f32"
        for lanes, pos in PD_CASES:
            tables = tables8[:lanes]
            ones = torch.ones(lanes, dtype=torch.int32, device="cuda")
            q = torch.from_numpy(rng.standard_normal(
                (lanes, g["hq"], g["d"])).astype(np.float32)).cuda().to(q_dt)
            lengths = torch.full((lanes,), pos, dtype=torch.int32,
                                 device="cuda")
            args = (q, pool, tables, lengths)
            case = f"{lanes} x {pos + 1}"
            splits = paged_splits(lanes, g["hkv"], g["mp"], g["s"], n_sm)
            got = launch_twice(torch, f"paged {case} {dname}",
                               paged_decode_attention,
                               lambda: paged_decode_attention(*args))
            err = check_close(torch, f"paged {case} {dname}", got,
                              paged_decode_attention_reference(*args))
            if (lanes, pos) == (8, 2047):
                skip = torch.cat([tables[:, :5], tables[:, 6:],
                                  tables[:, :1]], 1)
                check_rejects(torch, f"paged skipped page, 2048 context, "
                              f"{dname}", got,
                              paged_decode_attention_reference(
                                  q, pool, skip, lengths - g["s"]))
            ms = timer(lambda: paged_decode_attention(*args), iters=20)
            plain_ms = timer(lambda: paged_decode_attention_reference(*args),
                             iters=3, warmup=1)
            ragged_ms = timer(lambda: ragged_paged_attention(
                q[:, None], pool, tables, ones, lengths + 1), iters=20)
            vis = (torch.arange(t, device="cuda")[None, None]
                   <= lengths[:, None, None])
            lib_ms = sdpa_decode_ms(torch, timer, q[:, None], pool, tables,
                                    vis, g["hq"] // g["hkv"])
            n_ctx = lanes * (pos + 1)
            bound_ms, bound_by = bound(
                n_ctx * g["hkv"] * g["d"] * 2 * pool.element_size()
                + 2 * lanes * g["hq"] * g["d"] * q.element_size()
                + lanes * g["mp"] * 4 + lanes * 4,
                4 * g["d"] * g["hq"] * n_ctx, kind)
            rows.append(dict(case=case, dtypes=dname, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms,
                             ragged_ms=ragged_ms, body=f"ring x{splits}"))
            if dname == "bf16/bf16" and lanes == 8:
                # what the default timing holds besides the kernel's reads
                clean, warm = (timer(lambda: paged_decode_attention(*args),
                                     iters=20, flush=f)
                               for f in ("clean", "warm"))
                floor1, floor2 = (timer(lambda: [torch.cuda._sleep(0)
                                                 for _ in range(n)],
                                        iters=20) for n in (1, 2))
                log(f"kernels: paged {case} {dname} timing context: kernel "
                    f"{ms:.4f} ms (dirty flush), {clean:.4f} (clean flush),"
                    f" {warm:.4f} (warm L2); timer floor {floor1:.4f} ms "
                    f"one empty launch, {floor2:.4f} two")
            log(f"kernels: paged {case:<8} {dname:<9} ring x{splits:<2} "
                f"err={err:.2e} kernel={ms:.4f} ragged(kernel 1)="
                f"{ragged_ms:.4f} plain={plain_ms:.4f} bound={bound_ms:.4f} "
                f"({bound_by}) ms | yardstick, unused by the port: "
                f"sdpa={lib_ms:.4f} ms")
        del pool
    return rows


# e4m3 pools: kernel 1's shapes on both bodies (q dtype, cases), kernel 3's
# (lanes, inclusive position) cases
E4M3_RAGGED = (("bf16/e4m3", "bfloat16", ("all_decode", "chunk_over_ctx",
                                         "verify_k8")),
               ("f32/e4m3", "float32", ("all_decode",)))
E4M3_PAGED = ((8, 1023), (1, 2047))


def nan_dead_tails(torch, pool, tables, first_dead):
    """A copy of an e4m3 pool with 0x7F (NaN) in every position at or past
    ``first_dead[b]`` of each lane's table: the dead tail of its last live
    page and every dead page."""
    s = pool.shape[2]
    pos = torch.arange(tables.shape[1] * s, device=pool.device)
    lane, p = (pos[None] >= first_dead[:, None]).nonzero(as_tuple=True)
    out = pool.clone()
    out.view(torch.uint8)[tables[lane, p // s].long(), :, p % s] = 0x7F
    return out


def phase_e4m3_kernels(torch, timer, rows):
    """Kernels 1 and 3 over e4m3 pools (the serving geometry's pool cast
    from f32 on the card): each case held against its plain version over
    the same bytes, relaunched bit-identically, and launched again over a
    copy with 0x7F in every dead position, which must not change one bit
    of the output; a skipped page is rejected.  Times at 1 byte a KV
    element beside the bf16 (f32 q: f32/bf16) pool's time of the same
    case from ``rows``; no library call takes e4m3 K/V ("n/a")."""
    import numpy as np

    from tpulab_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference,
        paged_splits)
    from tpulab_torch.ops.ragged_attention import (
        _sm_count, ragged_body, ragged_paged_attention,
        ragged_paged_attention_reference, ragged_splits)

    g = RA_GEOM
    e4m3 = torch.float8_e4m3fn
    rng = np.random.default_rng(13)
    pool32, tables = serving_pool(torch, np, rng)
    pool = pool32.to(e4m3)
    del pool32
    n_sm = _sm_count(torch.cuda.current_device())
    cases = dict((n, (q, kv)) for n, q, kv in ra_cases())
    new = {"ragged": [], "paged": []}

    def beside(kernel, case, dname):
        pair = "bf16/bf16" if dname.startswith("bf16") else "f32/bf16"
        return next(r["ms"] for r in rows[kernel]
                    if (r["case"], r["dtypes"]) == (case, pair))

    for dname, q_name, names in E4M3_RAGGED:
        q_dt = getattr(torch, q_name)
        for name in names:
            q_lens_l, kv_lens_l = cases[name]
            m = max(q_lens_l)
            q = torch.from_numpy(rng.standard_normal(
                (g["b"], m, g["hq"], g["d"])).astype(np.float32)).cuda()
            q = q.to(q_dt)
            q_lens, kv_lens = (torch.tensor(x, dtype=torch.int32,
                                            device="cuda")
                               for x in (q_lens_l, kv_lens_l))
            args = (q, pool, tables, q_lens, kv_lens)
            body = ragged_body(q_dt, e4m3, g["d"])
            splits = ragged_splits(g["b"], m, g["hq"], g["hkv"], g["mp"],
                                   g["s"], n_sm, body)
            label = f"ragged {name} {dname}"
            got = launch_twice(torch, label, ragged_paged_attention,
                               lambda: ragged_paged_attention(*args), body)
            err = check_close(torch, label, got,
                              ragged_paged_attention_reference(*args))
            poisoned = nan_dead_tails(torch, pool, tables, kv_lens)
            if not torch.equal(ragged_paged_attention(
                    q, poisoned, tables, q_lens, kv_lens), got):
                raise AssertionError(f"{label}: 0x7F in dead positions "
                                     "changed the output")
            del poisoned
            if name == "all_decode":
                skip = torch.cat([tables[:, :5], tables[:, 6:],
                                  tables[:, :1]], 1)
                check_rejects(torch, f"ragged skipped page, 1024 context, "
                              f"{dname}", got,
                              ragged_paged_attention_reference(
                                  q, pool, skip, q_lens, kv_lens - g["s"]))
            ms = timer(lambda: ragged_paged_attention(*args), iters=20)
            plain_ms = timer(lambda: ragged_paged_attention_reference(*args),
                             iters=3, warmup=1)
            kind = "bf16" if q_dt == torch.bfloat16 else "f32"
            bound_ms, bound_by = ra_bound(q_lens_l, kv_lens_l, m,
                                          q.element_size(), 1, kind)
            bf16_ms = beside("ragged", name, dname)
            new["ragged"].append(dict(
                case=name, dtypes=dname, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, bf16_pool_ms=bf16_ms,
                body=f"{body} x{splits}"))
            log(f"kernels: ragged {name:<14} {dname:<9} {body:<5} "
                f"x{splits:<2} err={err:.2e} kernel={ms:.4f} (16-bit pool "
                f"{bf16_ms:.4f}) plain={plain_ms:.4f} bound={bound_ms:.4f} "
                f"({bound_by}, 1 byte a KV element) ms; sdpa n/a (no "
                "library call takes e4m3 K/V); 0x7F dead tails: output "
                "unchanged")

    for lanes, pos in E4M3_PAGED:
        tab = tables[:lanes]
        q = torch.from_numpy(rng.standard_normal(
            (lanes, g["hq"], g["d"])).astype(np.float32)).cuda().to(
                torch.bfloat16)
        lengths = torch.full((lanes,), pos, dtype=torch.int32, device="cuda")
        args = (q, pool, tab, lengths)
        case = f"{lanes} x {pos + 1}"
        label = f"paged {case} bf16/e4m3"
        splits = paged_splits(lanes, g["hkv"], g["mp"], g["s"], n_sm)
        got = launch_twice(torch, label, paged_decode_attention,
                           lambda: paged_decode_attention(*args))
        err = check_close(torch, label, got,
                          paged_decode_attention_reference(*args))
        poisoned = nan_dead_tails(torch, pool, tab, lengths + 1)
        if not torch.equal(paged_decode_attention(q, poisoned, tab, lengths),
                           got):
            raise AssertionError(f"{label}: 0x7F in dead positions changed "
                                 "the output")
        del poisoned
        if lanes == 8:
            skip = torch.cat([tab[:, :5], tab[:, 6:], tab[:, :1]], 1)
            check_rejects(torch, "paged skipped page, 1024 context, "
                          "bf16/e4m3", got, paged_decode_attention_reference(
                              q, pool, skip, lengths - g["s"]))
        ms = timer(lambda: paged_decode_attention(*args), iters=20)
        plain_ms = timer(lambda: paged_decode_attention_reference(*args),
                         iters=3, warmup=1)
        n_ctx = lanes * (pos + 1)
        bound_ms, bound_by = bound(
            n_ctx * g["hkv"] * g["d"] * 2
            + 2 * lanes * g["hq"] * g["d"] * q.element_size()
            + lanes * g["mp"] * 4 + lanes * 4,
            4 * g["d"] * g["hq"] * n_ctx, "f32")
        bf16_ms = beside("paged", case, "bf16/e4m3")
        new["paged"].append(dict(
            case=case, dtypes="bf16/e4m3", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, bf16_pool_ms=bf16_ms, body=f"ring x{splits}"))
        log(f"kernels: paged {case:<8} bf16/e4m3 ring x{splits:<2} "
            f"err={err:.2e} kernel={ms:.4f} (16-bit pool {bf16_ms:.4f}) "
            f"plain={plain_ms:.4f} bound={bound_ms:.4f} ({bound_by}, 1 byte "
            "a KV element) ms; sdpa n/a; 0x7F dead tails: output unchanged")
    return new


# ---------------------------------------------------------------- phase 4
def full_width_params(torch, n_layers, dtype, seed):
    from tpulab_torch.models.transformer import init_transformer_params

    c = LLAMA3_8B
    return init_transformer_params(
        c["vocab"], c["d_model"], c["n_heads"], n_layers, c["d_ff"],
        seed=seed, n_kv_heads=c["n_kv_heads"], ffn="swiglu",
        tie_embeddings=False, device="cuda", dtype=dtype)


def phase_invariants(torch, params=None, compute=None, kv_dtype=None):
    """The K-block and mixed-step invariants at full width, 2 layers (bf16
    weights and pool, or the given f32 ``params`` over a ``kv_dtype``
    pool), then the paged_decode_attention op over the same pool; returns
    that op path's launch count."""
    import numpy as np

    from tpulab_torch.engine.paged import (PagedKVPool, paged_decode_block,
                                           paged_decode_step,
                                           paged_mixed_step,
                                           paged_ragged_forward)
    from tpulab_torch.engine.prng import device_sample_tokens
    from tpulab_torch.ops.ragged_attention import pool_bytes as bits

    c = LLAMA3_8B
    n_layers = 2
    compute = compute or torch.bfloat16
    kv_dtype = kv_dtype or compute
    own = params is None
    if own:
        params = full_width_params(torch, n_layers, compute, seed=1)
    kw = dict(n_heads=c["n_heads"], n_layers=n_layers,
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=compute)
    b, mp, s = 8, 128, 16
    pool = PagedKVPool(b * mp + 1, s, n_layers, c["n_kv_heads"],
                       c["d_model"] // c["n_heads"], kv_dtype, "cuda")
    rng = np.random.default_rng(2)
    tables = torch.arange(1, b * mp + 1, dtype=torch.int32,
                          device="cuda").reshape(b, mp)
    q_lens_l = [40, 200, 5, 256, 17, 90, 130, 64]
    seq = torch.from_numpy(rng.integers(0, c["vocab"], (b, 256))).cuda()
    q_lens = torch.tensor(q_lens_l, device="cuda")
    kv_lens = q_lens.clone()
    temps = torch.tensor([0, .8, 0, 1., 0, .7, 0, 0], device="cuda")
    seeds = torch.from_numpy(rng.integers(0, 2**32, (b, 2))).cuda()
    with torch.inference_mode():
        kv_c, kv_d = pool.kv, pool.kv.clone()
        nt, lp, last = paged_mixed_step(params, kv_c, tables, seq, q_lens,
                                        kv_lens, temps, seeds, **kw)
        last2 = paged_ragged_forward(params, kv_d, tables, seq, q_lens,
                                     kv_lens, last_only=True, **kw)
        nt2 = device_sample_tokens(last2, temps, seeds, kv_lens - 1)
        # page 0 is scratch: invalid positions of every lane collide
        # there in an unspecified order, so live pages are compared
        diff = [n for n, same in (
            ("logits", torch.equal(last, last2)),
            ("tokens", torch.equal(nt, nt2)),
            ("pool", torch.equal(bits(kv_c[:, 1:]),
                                 bits(kv_d[:, 1:])))) if not same]
        if diff:
            raise AssertionError("paged_mixed_step != paged_ragged_forward "
                                 f"+ device pick: {diff}")
        del kv_d
        launches = decode_op_path(torch, rng, kv_c, tables, kv_lens - 1,
                                  compute)
        rem = torch.tensor([8, 3, 8, 8, 5, 8, 8, 8], device="cuda")
        stops = torch.full((b, 2), -1, dtype=torch.long, device="cuda")
        stops[2, 0] = int(nt[2])        # lane 2 stops when it repeats
        active = torch.ones(b, dtype=torch.bool, device="cuda")
        kv_a, kv_b = kv_c.clone(), kv_c.clone()
        blk = paged_decode_block(params, kv_a, tables, kv_lens, nt, active,
                                 temps, seeds, rem, stops, k=8, **kw)
        lens, toks, live, r = kv_lens.long(), nt.long(), active, rem.long()
        for j in range(8):
            t, lpj, _ = paged_decode_step(params, kv_b, tables, lens, toks,
                                          live, temps=temps, seeds=seeds,
                                          **kw)
            t = torch.where(live, t, toks)
            same = (torch.equal(blk[0][:, j], t)
                    and torch.equal(blk[1][:, j], lpj)
                    and torch.equal(blk[2][:, j], live))
            if not same:
                raise AssertionError(f"K-block != chained steps at step {j}")
            lens, r, toks = lens + live.long(), r - live.long(), t
            live = live & (r > 0) & ~(t[:, None] == stops).any(1)
        if not torch.equal(bits(kv_a[:, 1:]), bits(kv_b[:, 1:])):
            raise AssertionError("K-block pool != chained-steps pool")
        if not (torch.isfinite(blk[1]).all() and (blk[1] <= 0).all()
                and (blk[0] >= 0).all() and (blk[0] < c["vocab"]).all()):
            raise AssertionError("decode block emitted invalid tokens")
    emitted = blk[2].sum(1).tolist()
    log(f"invariants: full width, {n_layers} layers, {dtype_name(compute)} "
        f"over a {dtype_name(kv_dtype)} pool: K-block(k=8) == 8 chained "
        f"steps bit for bit (emitted per lane {emitted}); mixed step == "
        "ragged forward + device pick")
    pool.close()
    if own:
        del params
    del kv_a, kv_b, kv_c
    torch.cuda.empty_cache()
    return launches


def decode_op_path(torch, rng, kv, tables, positions, q_dtype):
    """The public ``paged_decode_attention`` op driven over every layer of
    a model-written pool (the path's launches are counted from 0), then
    held against the ragged kernel at decode shape and the plain version
    on the same inputs (those launches are not counted)."""
    from tpulab_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention

    c = LLAMA3_8B
    b = tables.shape[0]
    q = torch.from_numpy(rng.standard_normal(
        (b, c["n_heads"], c["d_model"] // c["n_heads"])).astype(
            "float32")).cuda().to(q_dtype)
    paged_decode_attention.launches = 0
    outs = [paged_decode_attention(q, kv[layer], tables, positions)
            for layer in range(kv.shape[0])]
    torch.cuda.synchronize()
    launches = paged_decode_attention.launches
    if launches != kv.shape[0]:
        raise AssertionError(f"decode op: {launches} launches over "
                             f"{kv.shape[0]} layers")
    ones = torch.ones(b, dtype=torch.int32, device="cuda")
    errs = []
    for layer, out in enumerate(outs):
        errs.append(check_close(torch, f"decode op layer {layer}", out,
                                paged_decode_attention_reference(
                                    q, kv[layer], tables, positions)))
        errs.append(check_close(torch, f"decode op vs ragged, layer {layer}",
                                out, ragged_paged_attention(
                                    q[:, None], kv[layer], tables, ones,
                                    positions + 1)[:, 0]))
    log(f"invariants: paged_decode_attention op over {kv.shape[0]} layers of "
        f"the mixed round's {dtype_name(kv.dtype)} pool, "
        f"{dtype_name(q_dtype)} queries: {launches} launches; == plain and "
        f"== the "
        f"ragged kernel at decode shape (max err {max(errs):.2e})")
    return launches


def phase_plans_f32(torch):
    """f32, full width, 2 layers: paged_prefill (flash) vs the ragged
    forward over one prompt, and the split vs the ragged plan's greedy
    tokens."""
    import numpy as np

    from tpulab_torch.engine.paged import (ContinuousBatcher, PagedKVPool,
                                           paged_prefill,
                                           paged_ragged_forward)
    from tpulab_torch.ops.flash_attention import make_flash_attention_fn

    c = LLAMA3_8B
    n_layers = 2
    params = full_width_params(torch, n_layers, torch.float32, seed=3)
    kw = dict(n_heads=c["n_heads"], n_layers=n_layers,
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.float32)
    rng = np.random.default_rng(4)
    s, mp, t = 16, 128, 1500
    pool = PagedKVPool(mp + 1, s, n_layers, c["n_kv_heads"],
                       c["d_model"] // c["n_heads"], torch.float32, "cuda")
    table = torch.arange(1, mp + 1, dtype=torch.int32, device="cuda")
    prompt = rng.integers(0, c["vocab"], (t,))
    padded = np.zeros((1, 2048), np.int64)
    padded[0, :t] = prompt
    with torch.inference_mode():
        kv_a, kv_b = pool.kv, pool.kv.clone()
        last_a = paged_prefill(params, kv_a, table,
                               torch.from_numpy(padded).cuda(), t,
                               attention_fn=make_flash_attention_fn(), **kw)
        last_b = paged_ragged_forward(
            params, kv_b, table[None], torch.from_numpy(padded[:, :t]).cuda(),
            torch.tensor([t], device="cuda"), torch.tensor([t], device="cuda"),
            last_only=True, **kw)[0]
        live = (t + s - 1) // s
        rtol, atol = TOL["float32"]
        err_l = (last_a - last_b).abs().max().item()
        err_p = (kv_a[:, 1:live + 1] - kv_b[:, 1:live + 1]).abs().max().item()
        if not (torch.allclose(last_a, last_b, rtol=rtol, atol=atol)
                and torch.allclose(kv_a[:, 1:live + 1], kv_b[:, 1:live + 1],
                                   rtol=rtol, atol=atol)):
            raise AssertionError(f"paged_prefill(flash) != ragged forward: "
                                 f"logits {err_l:.2e}, pool {err_p:.2e}")
    log(f"invariants: full width, {n_layers} layers, f32: paged_prefill "
        f"(flash, T={padded.shape[1]}) == ragged forward over a {t}-token "
        f"prompt (last logits err {err_l:.2e}, {live} live pages err "
        f"{err_p:.2e}; rtol {rtol:g} atol {atol:g})")
    pool.close()
    del kv_a, kv_b

    prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in (5, 300, 1000)]
    streams = {}
    for plan, extra in (("ragged", {}), ("split", {"ragged": False})):
        cb = ContinuousBatcher(params, n_heads=c["n_heads"],
                               n_layers=n_layers, n_kv_heads=c["n_kv_heads"],
                               rope_theta=c["rope_theta"],
                               compute_dtype=torch.float32, device="cuda",
                               lanes=4, max_len=1024 + 16, page_size=s,
                               **extra)
        try:
            futs = [cb.submit(p, 8) for p in prompts]
            streams[plan] = [list(f.result(timeout=300)) for f in futs]
        finally:
            cb.shutdown()
    notes = [same_or_near_tie(torch, params, kw, f"split vs ragged, "
                              f"{len(p)}-token prompt", p, a, b)
             for p, a, b in zip(prompts, streams["ragged"], streams["split"])]
    notes = [n for n in notes if n]
    log(f"invariants: split vs ragged plan, greedy, prompts of "
        f"{[len(p) for p in prompts]} tokens x 8 steps: "
        + ("; ".join(notes) if notes else "identical streams"))
    return params, kw


# ---------------------------------------------------------------- kvtier
KV_BUDGET = 1 << 30     # host tier of the kvtier phases: holds every victim


def gbps(nbytes, seconds):
    return nbytes / max(seconds, 1e-9) / 1e9


def phase_kvtier_pool(torch, dtype):
    """A bf16 or e4m3 pool, full width, 2 layers, filled with random bytes
    (NaN codes included): a 98-page snapshot (one 1500-token lane's page
    count at 32 layers) of scattered pages through the side stream and
    back into other pages, twice; the pages come back bit for bit and no
    other page (scratch page 0 included) changes."""
    import numpy as np

    from tpulab_torch.engine.paged import PagedKVPool
    from tpulab_torch.kvcache import KVOffloadManager

    c = LLAMA3_8B
    n = 98
    n_pages = 4 * n + 1                  # two trips, fresh pages each
    pool = PagedKVPool(n_pages, 16, 2, c["n_kv_heads"],
                       c["d_model"] // c["n_heads"], dtype, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    raw = pool.kv.view(torch.uint8)
    raw.copy_(torch.randint(0, 256, raw.shape, generator=gen, device="cuda",
                            dtype=torch.uint8))
    perm = np.random.default_rng(9).permutation(n_pages - 1) + 1
    mgr = KVOffloadManager(pool, KV_BUDGET)
    times = []
    try:
        for trip in range(2):
            src = [int(p) for p in perm[trip * 2 * n:trip * 2 * n + n]]
            dst = [int(p) for p in perm[trip * 2 * n + n:
                                        (trip + 1) * 2 * n]]
            before = pool.kv.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = mgr.swap_out(src, n * 16 - 5, pool.kv)
            if h is None or not h.wait(60):
                raise AssertionError("kvtier: the snapshot did not land")
            t1 = time.perf_counter()
            if mgr.restore(h, dst, pool.kv) is not pool.kv:
                raise AssertionError("kvtier: the restore degraded")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            bits = pool.kv.view(torch.uint8)
            was = before.view(torch.uint8)
            rest = sorted(set(range(n_pages)) - set(dst))
            if not torch.equal(bits[:, dst], was[:, src]):
                raise AssertionError("kvtier: restored pages differ")
            if not torch.equal(bits[:, rest], was[:, rest]):
                raise AssertionError("kvtier: a page outside the targets "
                                     "changed (scratch page 0 or a "
                                     "neighbour)")
            times.append((t1 - t0, t2 - t1))
            del before, was
        if (mgr.swap_outs, mgr.swap_ins, mgr.swap_failures,
                mgr.swap_drops) != (2, 2, 0, 0):
            raise AssertionError(f"kvtier: counters {mgr.swap_outs} out, "
                                 f"{mgr.swap_ins} in, {mgr.swap_failures} "
                                 f"failures, {mgr.swap_drops} drops")
        nbytes = n * mgr.page_nbytes
    finally:
        mgr.close()
        pool.close()
    log(f"invariants: kvtier, {dtype_name(dtype)} pool round trip of {n} "
        "scattered pages "
        f"({nbytes / 2**20:.2f} MiB, 2 layers) twice: bit-identical, page 0 "
        "and every other page unchanged; "
        + "; ".join(f"trip {i + 1}: swap-out landed {o * 1e3:.2f} ms "
                    f"({gbps(nbytes, o):.2f} GB/s), restore synced "
                    f"{r * 1e3:.2f} ms ({gbps(nbytes, r):.2f} GB/s)"
                    for i, (o, r) in enumerate(times)))


def preempted_run(cb, victim, hi, steps, hi_steps=4):
    """The victim with an on_token that submits the outranking request at
    its 4th token (on the scheduler thread: the preemption always lands
    while the victim decodes); returns both streams."""
    late = {}

    def arrive(tok, i):
        if i == 3 and "f" not in late:
            late["f"] = cb.submit(hi, hi_steps, priority=10)

    low = list(cb.submit(victim, steps, on_token=arrive).result(timeout=600))
    return low, list(late["f"].result(timeout=600))


def phase_kvtier_serve_f32(torch, params, kw, kv_dtype=None):
    """f32, full width, 2 layers, both plans, over an f32 pool or a
    ``kv_dtype`` one: a preempted victim resumed from the host tier and by
    re-prefill (``kv_offload=None``) against its unpreempted stream; one
    ``kvcache.swap`` chaos resume; then a prefill-batcher -> wire ->
    decode-batcher shipment against the unified stream, whose wire bytes
    have the length of the wire layout (magic, version, header, CRC and
    one payload byte per element at e4m3).  Streams agree under the
    margin rule (over a ``kv_dtype`` pool, its replay through one)."""
    import numpy as np

    from tpulab_torch import chaos
    from tpulab_torch.disagg import KVShipper, prompt_digest
    from tpulab_torch.engine.paged import ContinuousBatcher

    c = LLAMA3_8B
    rng = np.random.default_rng(10)
    victim = rng.integers(0, c["vocab"], (1000,)).astype(np.int32)
    hi = rng.integers(0, c["vocab"], (64,)).astype(np.int32)
    steps = 16
    cfg = dict(device="cuda", lanes=1, max_len=1024 + 32, page_size=16,
               kv_dtype=kv_dtype, **kw)
    pool_name = dtype_name(kv_dtype or kw["compute_dtype"])
    notes = []
    for plan, extra in (("ragged", {}), ("split", {"ragged": False})):
        tier = ContinuousBatcher(params, kv_offload=KV_BUDGET, **cfg,
                                 **extra)
        plain = ContinuousBatcher(params, **cfg, **extra)
        try:
            alone = list(tier.submit(victim, steps).result(timeout=600))
            f0 = tier.prompt_fills
            offl, _ = preempted_run(tier, victim, hi, steps)
            f1 = tier.prompt_fills
            g0 = plain.prompt_fills
            repf, _ = preempted_run(plain, victim, hi, steps)
            g1 = plain.prompt_fills
            mgr = tier.kv_offload
            if not (mgr.swap_outs == mgr.swap_ins == 1 and f1 - f0 == 2
                    and mgr.swap_failures == mgr.swap_drops == 0
                    and g1 - g0 == 3 and tier.preemptions == 1
                    and plain.preemptions == 1):
                raise AssertionError(
                    f"kvtier f32 {plan}: swaps {mgr.swap_outs}/"
                    f"{mgr.swap_ins}, failures {mgr.swap_failures}, drops "
                    f"{mgr.swap_drops}, prompt fills {f1 - f0} (want 2) "
                    f"and {g1 - g0} without the tier (want 3)")
            if plan == "ragged":
                with chaos.inject("kvcache.swap=error+1") as sched:
                    f2 = tier.prompt_fills
                    chao, _ = preempted_run(tier, victim, hi, steps)
                if not (sched.fired("kvcache.swap") == 1
                        and mgr.swap_failures == 1 and mgr.swap_ins == 1
                        and tier.prompt_fills - f2 == 3):
                    raise AssertionError(
                        f"kvtier chaos: fired {sched.fired('kvcache.swap')}"
                        f", failures {mgr.swap_failures}, swap-ins "
                        f"{mgr.swap_ins}, fills {tier.prompt_fills - f2}")
                streams = (("offloaded", offl), ("re-prefilled", repf),
                           ("chaos re-prefilled", chao))
            else:
                streams = (("offloaded", offl), ("re-prefilled", repf))
            for label, got in streams:
                note = same_or_near_tie(torch, params, kw, f"kvtier {plan} "
                                        f"{label} vs unpreempted", victim,
                                        alone, got, kv_dtype=kv_dtype)
                if note:
                    notes.append(note)
        finally:
            tier.shutdown()
            plain.shutdown()
        for cb in (tier, plain):
            if cb.pool.free_pages != cb.pool.n_pages - 1:
                raise AssertionError(f"kvtier f32 {plan}: pages unbalanced")
    log(f"invariants: kvtier, f32 over a {pool_name} pool, 2 layers, ragged "
        "and split plans: a "
        f"{len(victim)}-token victim x {steps} steps preempted at its 4th "
        "token resumed from the host tier (1 swap-out, 1 swap-in, no "
        "re-prefill), by re-prefill, and (ragged) through a kvcache.swap "
        "chaos re-prefill: "
        + ("; ".join(notes) if notes else "every stream == the unpreempted"))

    prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in (300, 1000)]
    cfg2 = dict(cfg, lanes=2, kv_offload=KV_BUDGET)
    pre, dec, uni = (ContinuousBatcher(params, **cfg2) for _ in range(3))
    sizes = []
    try:
        want = [list(uni.submit(p, steps).result(timeout=600))
                for p in prompts]
        got = []
        for p in prompts:
            dig = prompt_digest(p)
            fut = pre.submit(p, 1, export_digest=dig)
            first = fut.result(timeout=600)[0]
            blob = KVShipper(pre.kv_offload).export(
                fut._tpulab_kv_export, digest=dig, first_token=first)
            ship = KVShipper(dec.kv_offload).import_shipment(blob)
            if blob is None or ship is None:
                raise AssertionError("kvtier f32 shipment lost")
            sizes.append((len(blob), wire_length(pre.pool, len(p), blob)))
            got.append(list(dec.submit_shipped(
                p, steps, first, ship.handle).result(timeout=600)))
        if (dec.prompt_fills, dec.kv_offload.swap_ins) != (0, 2):
            raise AssertionError(f"kvtier f32 shipment: decode side "
                                 f"{dec.prompt_fills} prompt fills, "
                                 f"{dec.kv_offload.swap_ins} swap-ins")
    finally:
        for cb in (pre, dec, uni):
            cb.shutdown()
    if any(n != want_n for n, want_n in sizes):
        raise AssertionError(f"kvtier {pool_name} shipment: wire bytes "
                             f"{sizes} (got, want)")
    notes = [same_or_near_tie(torch, params, kw, f"shipped vs unified, "
                              f"{len(p)}-token prompt", p, a, b,
                              kv_dtype=kv_dtype)
             for p, a, b in zip(prompts, want, got)]
    notes = [n for n in notes if n]
    log(f"invariants: kvtier, f32 over a {pool_name} pool, ragged plan: "
        f"prefill batcher -> wire -> decode batcher, prompts "
        f"{[len(p) for p in prompts]} x {steps}: wire bytes "
        f"{[n for n, _ in sizes]} as the layout predicts; 0 prompt fills on "
        "the decode side; "
        + ("; ".join(notes) if notes else "streams == the unified batcher"))


def pick_margin(torch, row, temp, seed, pos):
    """The gap between the two best scores a pick compares at position
    ``pos``: the logits (greedy) or logits / T + the (seed, position)
    Gumbel draw (device sampling), as ``device_sample_tokens`` scores."""
    from tpulab_torch.engine.prng import fold_in, gumbel, prng_key

    z = row.float()
    if temp > 0:
        key = prng_key(0, row.device, (1,))
        for word in (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, pos):
            key = fold_in(key, torch.tensor([word], device=row.device))
        z = z / temp + gumbel(key, z.shape[-1])[0]
    top2 = z.topk(2).values
    return (top2[0] - top2[1]).item()


def wire_length(pool, length, blob):
    """The byte count of a shipment of ``length`` positions from ``pool``
    by the wire layout: magic, version and header length, the JSON header,
    the payload's CRC-32, then every element of the page-granular snapshot
    at the pool's itemsize."""
    import struct

    from tpulab_torch.disagg import wire

    pages = -(-length // pool.page_size)
    base = len(wire.MAGIC) + struct.calcsize("<HI")
    (hdr_len,) = struct.unpack_from("<I", blob, len(wire.MAGIC) + 2)
    return (base + hdr_len + struct.calcsize("<I")
            + pages * pool.kv[:, 0].numel() * pool.kv.element_size())


def replay_logits(torch, params, kw, seq, kv_dtype, tail=None):
    """The last position's f32 logits of ``seq`` (1, T) (with ``tail``,
    the last ``tail`` positions', (tail, vocab)): the dense forward, or
    with ``kv_dtype`` one ragged forward over a fresh pool of that dtype
    (the K/V rounded as the serve rounds them)."""
    from tpulab_torch.engine.paged import PagedKVPool, paged_ragged_forward
    from tpulab_torch.models.transformer import (transformer_apply,
                                                 weight_shape)

    tokens = torch.from_numpy(seq).long().cuda()
    with torch.inference_mode():
        if kv_dtype is None:
            logits = transformer_apply(params, {"tokens": tokens},
                                       **kw)["logits"][0]
            return logits[-1] if tail is None else logits[-tail:]
        t, s = seq.shape[1], 16
        d_model = weight_shape(params["layer0"]["wqkv"])[0]
        pool = PagedKVPool(-(-t // s) + 1, s, kw["n_layers"],
                           kw["n_kv_heads"], d_model // kw["n_heads"],
                           kv_dtype, "cuda")
        table = torch.arange(1, pool.n_pages, dtype=torch.int32,
                             device="cuda")[None]
        n = torch.tensor([t], device="cuda")
        out = paged_ragged_forward(params, pool.kv, table, tokens, n, n,
                                   last_only=tail is None, **kw)[0]
        pool.close()
        return out if tail is None else out[-tail:]


def same_or_near_tie(torch, params, kw, label, prompt, want, got, temp=0.0,
                     seed=0, kv_dtype=None):
    """``got`` equals ``want``, or first differs where the f32 model's own
    pick margin (:func:`pick_margin` over :func:`replay_logits`) is below
    ``MARGIN_TOL``; returns a note for the log."""
    import numpy as np

    if got == want:
        return None
    i = next((j for j, (x, y) in enumerate(zip(want, got)) if x != y),
             min(len(want), len(got)))
    if i == min(len(want), len(got)):
        raise AssertionError(f"{label}: lengths {len(want)} != {len(got)}")
    seq = np.concatenate([prompt, np.asarray(want[:i], np.int32)])[None]
    row = replay_logits(torch, params, kw, seq, kv_dtype)
    margin = pick_margin(torch, row, temp, seed, seq.shape[1] - 1)
    if margin >= MARGIN_TOL:
        raise AssertionError(f"{label}: streams differ at step {i} with "
                             f"pick margin {margin:.2e}")
    return (f"{label} differs at step {i} (margin {margin:.2e} < "
            f"{MARGIN_TOL:g})")


def phase_spec_f32(torch):
    """f32, full width, 2 layers, layer 1's wo / w2 scaled by 0.05 (so the
    1-layer early-exit draft agrees): speculating batchers (early-exit
    draft; the target as its own draft) against plain blocks, greedy and
    device-sampled, and the dense SpeculativeGenerator against
    make_generate_fn, each under the margin rule."""
    import numpy as np

    from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
    from tpulab_torch.engine.speculative import SpeculativeGenerator
    from tpulab_torch.models.transformer import (early_exit_draft,
                                                 make_generate_fn)

    c = LLAMA3_8B
    n_layers, s = 2, 16
    params = full_width_params(torch, n_layers, torch.float32, seed=5)
    with torch.inference_mode():
        for w in ("wo", "w2"):
            params["layer1"][w].mul_(0.05)
    kw = dict(n_heads=c["n_heads"], n_layers=n_layers,
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in (5, 300, 1000)]
    temps = (0.0, 0.8, 0.0)
    seeds = (0, 4321, 0)
    max_len, steps = 1024 + 32, 24
    streams, stats = {}, {}
    for mode, draft, dl in (("plain", None, None),
                            ("early_exit", early_exit_draft(params, 1), 1),
                            ("self", params, n_layers)):
        cb = ContinuousBatcher(
            params, device="cuda", lanes=4, max_len=max_len, page_size=s,
            n_pages=2 * 4 * (max_len // s) + 1, draft_params=draft,
            draft_n_layers=dl, **kw)
        try:
            futs = [cb.submit(p, steps, sampling=SamplingParams(
                temperature=t, seed=sd, device=True))
                for p, t, sd in zip(prompts, temps, seeds)]
            streams[mode] = [list(f.result(timeout=300)) for f in futs]
            stats[mode] = (cb.spec_dispatches, cb.spec_tokens_drafted,
                           cb.spec_tokens_accepted)
            if mode == "self":
                # acceptance over one lone request of 1 + 7 x 9 tokens: no
                # block reaches past its budget (drafts there count as
                # drafted, never as accepted)
                before = stats[mode]
                cb.submit(prompts[1], 64).result(timeout=300)
                stats["self_lone"] = tuple(
                    now - was for now, was in zip(
                        (cb.spec_dispatches, cb.spec_tokens_drafted,
                         cb.spec_tokens_accepted), before))
        finally:
            cb.shutdown()
    notes = []
    for mode in ("early_exit", "self"):
        if stats[mode][0] == 0:
            raise AssertionError(f"f32 spec ({mode}): no speculative "
                                 "dispatch ran")
        for p, t, sd, want, got in zip(prompts, temps, seeds,
                                       streams["plain"], streams[mode]):
            note = same_or_near_tie(
                torch, params, kw, f"spec ({mode}) vs plain, {len(p)}-token "
                f"prompt, T {t}", p, want, got, t, sd)
            if note:
                notes.append(note)
    acc = {m: stats[m][2] / max(1, stats[m][1]) for m in stats}
    if acc["self_lone"] < 0.9:
        raise AssertionError(f"self-draft acceptance {acc['self_lone']:.3f} "
                             "< 0.9")
    log(f"invariants: full width, {n_layers} layers, f32: speculating "
        f"batchers vs plain blocks, prompts {[len(p) for p in prompts]} x "
        f"{steps} steps (greedy, device-sampled T 0.8, greedy): "
        + ("; ".join(notes) if notes else "identical streams")
        + f"; acceptance early-exit draft {acc['early_exit']:.3f} "
        f"({stats['early_exit'][2]}/{stats['early_exit'][1]} over "
        f"{stats['early_exit'][0]} dispatches), self-draft "
        f"{acc['self']:.3f}, over a lone 64-step request "
        f"{acc['self_lone']:.3f} ({stats['self_lone'][2]}/"
        f"{stats['self_lone'][1]}, >= 0.9)")
    dense_p = rng.integers(0, c["vocab"], (64,)).astype(np.int32)
    gen = SpeculativeGenerator(params, early_exit_draft(params, 1),
                               draft_n_layers=1, k=4, max_len=128,
                               device="cuda", **kw)
    got = gen.generate(dense_p, steps)
    want = make_generate_fn(params, max_len=128, **kw)(
        dense_p[None], steps)[0].tolist()
    note = same_or_near_tie(torch, params, kw, "dense SpeculativeGenerator "
                            "vs make_generate_fn", dense_p, want, got)
    log(f"invariants: dense SpeculativeGenerator (early-exit draft, k 4) vs "
        f"make_generate_fn greedy, 64-token prompt x {steps}: "
        f"{note or 'identical'}; {gen.rounds} rounds, {gen.accepted} "
        "accepted")
    del params, gen
    torch.cuda.empty_cache()


def phase_cast_and_qmat(torch):
    """The e4m3 page cast and the int8 dequantization, on the card against
    the CPU (which the tests hold to tpulab): ``to_kv_dtype`` over all
    65536 bf16 patterns and the f32 specials, and one full-width layer's
    projections (random bf16 weights) quantized on the card and on the
    CPU, then ``qmat``'d at bf16 and f32 on each, all bit for bit."""
    import numpy as np

    from tpulab_torch.engine.paged import to_kv_dtype
    from tpulab_torch.models.quantization import quantize_matrix
    from tpulab_torch.models.transformer import qmat

    e4m3 = torch.float8_e4m3fn
    pats = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    tiny = 2.0 ** -9
    specials = torch.tensor(
        [0.0, -0.0, 448.0, -448.0, 456.0, 463.99997, 464.0, -464.0,
         464.00003, 465.0, -466.0, 1e30, float("inf"), float("-inf"),
         float("nan"), tiny, -tiny, tiny / 2, tiny * 1.5, 2.0 ** -6],
        dtype=torch.float32)
    noise = torch.from_numpy(np.random.default_rng(15).normal(
        0, 100, 1 << 20).astype(np.float32))
    for label, x in (("bf16 patterns", pats), ("f32 specials", specials),
                     ("f32 N(0, 100^2)", noise)):
        want = to_kv_dtype(x, e4m3).view(torch.uint8)
        got = to_kv_dtype(x.cuda(), e4m3).view(torch.uint8).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"to_kv_dtype on the card != CPU over "
                                 f"{label}: {int((got != want).sum())} codes")
    c = LLAMA3_8B
    d, hd = c["d_model"], c["d_model"] // c["n_heads"]
    shapes = {"wqkv": (d, (c["n_heads"] + 2 * c["n_kv_heads"]) * hd),
              "wo": (d, d), "w1": (d, c["d_ff"]), "w2": (c["d_ff"], d),
              "w3": (d, c["d_ff"])}
    gen = torch.Generator(device="cuda").manual_seed(16)
    for name, shape in shapes.items():
        w = torch.empty(shape, device="cuda").normal_(
            0, 0.02, generator=gen).to(torch.bfloat16)
        on_card = quantize_matrix(w)
        on_cpu = quantize_matrix(w.cpu())
        for k in ("w_int8", "scale"):
            if not torch.equal(on_card[k].cpu(), on_cpu[k]):
                raise AssertionError(f"quantize {name}.{k}: card != CPU")
        for dt in (torch.bfloat16, torch.float32):
            got = qmat(on_card, dt).cpu()
            if not torch.equal(got, qmat(on_cpu, dt)):
                raise AssertionError(f"qmat {name} {dtype_name(dt)}: card "
                                     "!= CPU")
        del w, on_card, on_cpu
    log("invariants: to_kv_dtype(e4m3) on the card == the CPU over all 65536 "
        "bf16 patterns, the f32 specials and 2^20 f32 N(0, 100^2) samples; "
        "one full-width layer's projections quantized on the card == on the "
        "CPU (w_int8 and scale), and qmat at bf16 and f32 == the CPU's, bit "
        "for bit")


def phase_int8_spec_f32(torch):
    """f32, full width, 2 layers, int8 weights (quantized on the card after
    layer 1's wo / w2 are scaled by 0.05) over an e4m3 pool: a batcher
    with the 1-layer early-exit draft against plain blocks, greedy and
    device-sampled, under the margin rule over an e4m3 replay."""
    import numpy as np

    from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
    from tpulab_torch.models.quantization import quantize_transformer_params
    from tpulab_torch.models.transformer import early_exit_draft

    c = LLAMA3_8B
    n_layers, s = 2, 16
    e4m3 = torch.float8_e4m3fn
    params = full_width_params(torch, n_layers, torch.float32, seed=17)
    with torch.inference_mode():
        for w in ("wo", "w2"):
            params["layer1"][w].mul_(0.05)
    qparams = quantize_transformer_params(params)
    del params
    torch.cuda.empty_cache()
    kw = dict(n_heads=c["n_heads"], n_layers=n_layers,
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.float32)
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in (5, 300, 1000)]
    temps, seeds = (0.0, 0.8, 0.0), (0, 4321, 0)
    max_len, steps = 1024 + 32, 24
    streams, stats = {}, {}
    for mode in ("plain", "spec"):
        extra = (dict(draft_params=early_exit_draft(qparams, 1),
                      draft_n_layers=1) if mode == "spec" else {})
        cb = ContinuousBatcher(
            qparams, device="cuda", lanes=4, max_len=max_len, page_size=s,
            n_pages=2 * 4 * (max_len // s) + 1, kv_dtype=e4m3, **extra,
            **kw)
        try:
            futs = [cb.submit(p, steps, sampling=SamplingParams(
                temperature=t, seed=sd, device=True))
                for p, t, sd in zip(prompts, temps, seeds)]
            streams[mode] = [list(f.result(timeout=300)) for f in futs]
            stats[mode] = (cb.spec_dispatches, cb.spec_tokens_drafted,
                           cb.spec_tokens_accepted)
        finally:
            cb.shutdown()
    if stats["spec"][0] == 0:
        raise AssertionError("int8/e4m3 spec: no speculative dispatch ran")
    notes = [same_or_near_tie(torch, qparams, kw, f"int8/e4m3 spec vs plain, "
                              f"{len(p)}-token prompt, T {t}", p, want, got,
                              t, sd, kv_dtype=e4m3)
             for p, t, sd, want, got in zip(prompts, temps, seeds,
                                            streams["plain"],
                                            streams["spec"])]
    notes = [n for n in notes if n]
    d, dr, ac = stats["spec"]
    log(f"invariants: full width, {n_layers} layers, int8 weights, f32 over "
        f"an e4m3 pool: speculating batcher (early-exit draft) vs plain "
        f"blocks, prompts {[len(p) for p in prompts]} x {steps} steps: "
        + ("; ".join(notes) if notes else "identical streams")
        + f"; acceptance {ac / max(1, dr):.3f} ({ac}/{dr} over {d} "
        "dispatches)")
    del qparams
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 5
def dev_ms(e):
    """A profiler event's own device time, ms."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0)) / 1e3


def kernel_classes(torch, prof):
    """The profiled device kernels and their device time (ms) by class:
    attention kernels, matmul, other."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    classes = {"attention (ragged_attn_*)": 0.0,
               "attention (flash_fwd_*)": 0.0, "matmul": 0.0,
               "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        cls = ("attention (ragged_attn_*)" if "ragged_attn" in n
               else "attention (flash_fwd_*)" if "flash_fwd" in n
               else "matmul" if any(w in n for w in (
                   "gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas"))
               else "other")
        classes[cls] += dev_ms(e)
    return kernels, classes


def device_breakdown(torch, prof, wall_s, card, plan):
    """Device time by kernel (torch.profiler, CUDA activity) over one
    serve run: the classes attention kernels / matmul / other, the top
    kernels, and the device's busy share of the run's wall time."""
    kernels, classes = kernel_classes(torch, prof)
    busy = sum(classes.values())
    top = sorted(kernels, key=dev_ms, reverse=True)[:8]
    log(f"profile: {plan}, serve run 3 wall {wall_s * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (wall_s * 1e3):.1f}%) "
        f"[{card}]")
    for cls, ms in classes.items():
        log(f"profile:   {cls:<32} {ms:10.1f} ms "
            f"({100 * ms / max(busy, 1e-9):.1f}% of device time)")
    for e in top:
        log(f"profile:   {dev_ms(e):10.1f} ms {e.count:6d}x {e.key[:80]}")
    return dict(busy_ms=busy, share=busy / (wall_s * 1e3), classes=classes)


class Metrics:
    """The batcher's metrics hook: collects TTFT and end-to-end latency."""

    def __init__(self):
        self.ttft, self.e2e = [], []

    def observe_ttft(self, s):
        self.ttft.append(s)

    def observe_e2e(self, s):
        self.e2e.append(s)

    def observe_itl(self, s):
        pass

    def observe_queue_wait(self, s):
        pass

    def note_deadline_expired(self):
        pass


# the batcher counters a serve run reads (deltas over the run)
COUNTERS = ("forward_steps", "prefill_forwards", "prefill_dispatches",
            "tokens_generated", "decode_dispatches", "decode_host_syncs",
            "draft_forward_steps", "spec_dispatches", "spec_tokens_drafted",
            "spec_tokens_accepted", "spec_fallbacks", "spec_probes")


def run_mix(torch, cb, specs, counted, late=None):
    """Submit ``specs`` (name, prompt, steps, submit kwargs) at once with
    every kernel's count set to 0, wait for them (and for the request
    ``late["late"]`` a callback submits); returns (outputs dict, stats:
    wall seconds, counter deltas, launches by kernel and body)."""
    futs = {}
    for fn in counted.values():
        fn.launches = 0
        fn.launches_by_body = dict.fromkeys(fn.launches_by_body, 0)
    before = {n: getattr(cb, n) for n in COUNTERS}
    kinds = dict(cb.dispatch_kinds)
    t0 = time.perf_counter()
    # submit the mix atomically (the scheduler's lock is re-entrant), so
    # repeated runs schedule identical rounds
    with cb._cv:
        for name, prompt, steps, kw in specs:
            futs[name] = cb.submit(prompt, steps, **kw)
    outs = {name: f.result(timeout=900) for name, f in futs.items()}
    if late is not None:
        while "late" not in late:
            time.sleep(0.001)
        outs["late"] = late["late"].result(timeout=900)
    wall = time.perf_counter() - t0
    stats = {n: getattr(cb, n) - before[n] for n in COUNTERS}
    stats.update(wall_s=wall, tokens=stats["tokens_generated"],
                 launches={name: fn.launches for name, fn in counted.items()},
                 by_body={name: dict(fn.launches_by_body)
                          for name, fn in counted.items()},
                 kinds={k: cb.dispatch_kinds[k] - kinds[k] for k in kinds},
                 steps={name: st for name, _, st, _ in specs})
    return outs, stats


def serve_once(torch, cb, prompts, stop_token, counted):
    """Submit the request mix with every kernel's count set to 0; returns
    (outputs dict, stats)."""
    from tpulab_torch.engine.paged import SamplingParams

    late = {}

    def trigger(tok, i):            # runs on the scheduler thread
        if i == 0 and "late" not in late:
            late["late"] = cb.submit(prompts["late"], 48)

    specs = [
        ("greedy_stop", prompts[5], 40, dict(stop_tokens=(
            [stop_token] if stop_token is not None else None))),
        ("device_a", prompts[64], 48, dict(sampling=SamplingParams(
            temperature=0.8, seed=1234, device=True))),
        ("device_b", prompts[300], 48, dict(sampling=SamplingParams(
            temperature=0.8, seed=99, device=True))),
        ("stream_trigger", prompts[700], 32, dict(on_token=trigger)),
        ("host_topk", prompts[1000], 32, dict(sampling=SamplingParams(
            temperature=0.9, top_k=50, seed=5))),
        ("greedy_logprobs", prompts[1500], 40, dict(logprobs=True)),
    ]
    outs, stats = run_mix(torch, cb, specs, counted, late)
    stats["steps"]["late"] = 48
    return outs, stats


def check_plan(plan, st, n_layers, n_requests):
    """Dispatch kinds and launch counts of one serve run."""
    ra, fa = st["launches"]["ragged"], st["launches"]["flash"]
    if ra != n_layers * st["forward_steps"]:
        raise AssertionError(f"{plan}: ragged launches {ra} != n_layers x "
                             f"forward steps {n_layers} x "
                             f"{st['forward_steps']}")
    if fa != n_layers * st["prefill_forwards"]:
        raise AssertionError(f"{plan}: flash launches {fa} != n_layers x "
                             f"prefill forwards {n_layers} x "
                             f"{st['prefill_forwards']}")
    for name, n in st["launches"].items():
        # the serve is bf16 at D 128: every launch takes the wgmma body
        if st["by_body"][name] != {"fma": 0, "wgmma": n}:
            raise AssertionError(f"{plan}: {name} launches by body "
                                 f"{st['by_body'][name]}, want all {n} "
                                 "on wgmma")
    kinds = st["kinds"]
    if plan == "ragged":
        ok = (kinds["mixed"] > 0 and kinds["decode"] > 0
              and st["prefill_dispatches"] == 0 and fa == 0)
    else:
        ok = (kinds["mixed"] == 0 and kinds["decode"] > 0
              and st["prefill_dispatches"] == n_requests
              and st["prefill_forwards"] == n_requests and fa > 0)
    if not ok:
        raise AssertionError(f"{plan}: dispatch kinds {kinds}, prefill "
                             f"dispatches {st['prefill_dispatches']}, "
                             f"forwards {st['prefill_forwards']}, flash "
                             f"launches {fa}")


def serve_plan(torch, model, prompts, plan, card, profile, kv_dtype=None,
               weights="bf16"):
    """Three runs of the mix on one batcher (pages of ``kv_dtype``, the
    compute dtype by default): run 1 picks the stop token (greedy_stop's
    9th token), runs 2 and 3 must be identical; ``profile`` traces run
    3."""
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.ops.flash_attention import flash_attention
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention

    c = LLAMA3_8B
    counted = {"ragged": ragged_paged_attention, "flash": flash_attention}
    metrics = Metrics()
    cfg = dict(SERVE, **(SPLIT if plan == "split" else {}))
    cb = ContinuousBatcher(model, n_heads=c["n_heads"],
                           n_layers=c["n_layers"],
                           n_kv_heads=c["n_kv_heads"],
                           rope_theta=c["rope_theta"],
                           compute_dtype=torch.bfloat16, device="cuda",
                           metrics=metrics, kv_dtype=kv_dtype, **cfg)
    label = f"{plan} plan, {weights} weights, {dtype_name(cb.pool.dtype)} KV"
    pool_bytes = cb.pool.hbm_bytes
    try:
        out1, _ = serve_once(torch, cb, prompts, None, counted)
        stop = out1["greedy_stop"][8]
        runs = []
        for i in range(2):
            metrics.ttft.clear()
            metrics.e2e.clear()
            torch.cuda.synchronize()
            if profile and i == 1:
                from torch.profiler import ProfilerActivity

                from tpulab_torch.utils.tracing import profiler_session
                with profiler_session(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    out, st = serve_once(torch, cb, prompts, stop, counted)
                st["busy"] = device_breakdown(torch, prof, st["wall_s"],
                                              card, label)
            else:
                out, st = serve_once(torch, cb, prompts, stop, counted)
            st["ttft_s"] = sorted(metrics.ttft)
            runs.append((out, st))
    finally:
        cb.shutdown()
    (out2, st2), (out3, st3) = runs
    for name, toks in out2.items():
        toks = toks[0] if isinstance(toks, tuple) else toks
        if name == "greedy_stop":
            cut = out1[name].index(stop) + 1
            if toks != out1[name][:cut]:
                raise AssertionError(f"{plan}: stop token did not end "
                                     "greedy_stop where the unstopped run "
                                     "emits it")
        elif len(toks) != st2["steps"][name]:
            raise AssertionError(f"{plan} {name}: {len(toks)} tokens, want "
                                 f"{st2['steps'][name]}")
        if not all(0 <= t < c["vocab"] for t in toks):
            raise AssertionError(f"{plan} {name}: token outside [0, vocab)")
    lps = out2["greedy_logprobs"][1]
    if not all(math.isfinite(x) and x <= 0 for x in lps):
        raise AssertionError(f"{plan}: logprobs must be finite and <= 0")
    # runs 2 and 3 are the same requests scheduled into the same rounds;
    # run 1 (no stop token) schedules differently once greedy_stop would
    # have stopped, so only its prefix up to the stop is compared above
    for name in ("greedy_stop", "device_a", "device_b", "greedy_logprobs",
                 "stream_trigger", "late"):
        if out2[name] != out3[name]:
            raise AssertionError(f"{plan} {name}: the second run differs")
    for st in (st2, st3):
        check_plan(plan, st, c["n_layers"], len(out2))
    ttft = st2["ttft_s"]
    st2.update(pool_bytes=pool_bytes, busy3=st3.get("busy"),
               wall3_s=st3["wall_s"], ttft3_s=st3["ttft_s"])
    log(f"serve: {label}: pool {pool_bytes} bytes ({cb.pool.n_pages} pages)")
    log(f"serve: {label}: {len(out2)} requests, {st2['tokens']} tokens "
        f"in {st2['wall_s']:.3f} s = {st2['tokens'] / st2['wall_s']:.1f} "
        f"tok/s; TTFT min {ttft[0] * 1e3:.1f} / median "
        f"{ttft[len(ttft) // 2] * 1e3:.1f} / max {ttft[-1] * 1e3:.1f} ms; "
        f"dispatches {st2['kinds']}, prefill dispatches "
        f"{st2['prefill_dispatches']}; launches ragged "
        f"{st2['launches']['ragged']} = {c['n_layers']} x "
        f"{st2['forward_steps']} forward steps, flash "
        f"{st2['launches']['flash']} = {c['n_layers']} x "
        f"{st2['prefill_forwards']} prefill forwards, all on the wgmma "
        f"body [{card}]")
    log(f"serve: {label}: second identical run {st3['wall_s']:.3f} s, "
        f"{st3['tokens'] / st3['wall_s']:.1f} tok/s; streams identical")
    return st2


# the preempting serve: 4 lanes of the serving geometry (513 pages)
KVSERVE = dict(SERVE, lanes=4)
VICTIMS = (300, 700, 1000, 1500)    # admitted in this order: the 1500- and
#                                     1000-token lanes are evicted first


class TierMetrics(Metrics):
    """Metrics hook plus the resume and host-tier swap observations."""

    def __init__(self):
        super().__init__()
        self.resumes, self.swaps = [], []

    def observe_resume(self, s, kind):
        self.resumes.append((kind, s))

    def observe_swap_out(self, s, nbytes):
        self.swaps.append(("out", nbytes, s))

    def observe_swap_in(self, s, nbytes):
        self.swaps.append(("in", nbytes, s))


def preempting_run(torch, cb, victims, his, counted):
    """The four victims (64 steps) submitted at once; once every one has
    emitted its first token, its on_token (on the scheduler thread)
    submits the two priority-10 requests (32 steps).  Launch counts set
    to 0 before, read after; returns (streams, stats)."""
    first, late = set(), {}

    def arrive(name):
        def hook(tok, i):
            if i == 0:
                first.add(name)
                if len(first) == len(victims) and "hi" not in late:
                    late["hi"] = [cb.submit(p, 32, priority=10) for p in his]
        return hook

    for fn in counted.values():
        fn.launches = 0
        fn.launches_by_body = dict.fromkeys(fn.launches_by_body, 0)
    names = ("forward_steps", "prompt_fills", "preemptions",
             "tokens_generated")
    before = {n: getattr(cb, n) for n in names}
    t0 = time.perf_counter()
    with cb._cv:
        futs = [cb.submit(p, 64, on_token=arrive(len(p))) for p in victims]
    outs = [list(f.result(timeout=900)) for f in futs]
    outs += [list(f.result(timeout=900)) for f in late["hi"]]
    wall = time.perf_counter() - t0
    st = {n: getattr(cb, n) - before[n] for n in names}
    st.update(wall_s=wall, launches={k: f.launches for k, f in
                                     counted.items()})
    return outs, st


def serve_kvtier(torch, model, card):
    """The same preempting traffic on one batcher with the host tier
    (budget KV_BUDGET: every victim fits) and one without, same weights;
    then, on the tier's pool, a synced swap-out and restore at each
    victim's page count."""
    import numpy as np

    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention

    c = LLAMA3_8B
    rng = np.random.default_rng(11)
    victims = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in VICTIMS]
    his = [rng.integers(0, c["vocab"], (64,)).astype(np.int32)
           for _ in range(2)]
    counted = {"ragged": ragged_paged_attention}
    res = {}
    for side, opt in (("tier", KV_BUDGET), ("no tier", None)):
        metrics = TierMetrics()
        cb = ContinuousBatcher(model, n_heads=c["n_heads"],
                               n_layers=c["n_layers"],
                               n_kv_heads=c["n_kv_heads"],
                               rope_theta=c["rope_theta"],
                               compute_dtype=torch.bfloat16, device="cuda",
                               metrics=metrics, kv_offload=opt, **KVSERVE)
        mgr = cb.kv_offload
        if mgr is not None:
            mgr.metrics = metrics
        try:
            outs, st = preempting_run(torch, cb, victims, his, counted)
            st.update(resumes=list(metrics.resumes),
                      swaps=list(metrics.swaps), synced=[])
            if mgr is not None:
                mgr.metrics = None
                if not mgr.drain(60):
                    raise AssertionError("kvtier serve: write-behind stuck")
                st.update(swap_outs=mgr.swap_outs, swap_ins=mgr.swap_ins,
                          failures=mgr.swap_failures, drops=mgr.swap_drops,
                          saved=mgr.recompute_tokens_saved,
                          out_bytes=mgr.swap_out_bytes,
                          in_bytes=mgr.swap_in_bytes)
                # device-inclusive times at each evicted lane's page count
                for _d, nbytes, _s in [w for w in st["swaps"]
                                       if w[0] == "out"]:
                    n = nbytes // mgr.page_nbytes
                    pages = [cb.pool.allocate_page() for _ in range(2 * n)]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    h = mgr.swap_out(pages[:n], n * 16, cb.pool.kv)
                    if h is None or not h.wait(60):
                        raise AssertionError("kvtier: synced swap failed")
                    t1 = time.perf_counter()
                    mgr.restore(h, pages[n:], cb.pool.kv)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    cb.pool.release_pages(pages)
                    st["synced"].append((n, nbytes, t1 - t0, t2 - t1))
        finally:
            cb.shutdown()
        st["balanced"] = cb.pool.free_pages == cb.pool.n_pages - 1
        res[side] = (outs, st)
    n_req = len(victims) + len(his)
    for side, (outs, st) in res.items():
        ra = st["launches"]["ragged"]
        if ra != c["n_layers"] * st["forward_steps"] or not st["balanced"]:
            raise AssertionError(f"kvtier serve ({side}): ragged launches "
                                 f"{ra} vs {c['n_layers']} x "
                                 f"{st['forward_steps']}, pages balanced "
                                 f"{st['balanced']}")
        if [len(o) for o in outs] != [64] * len(victims) + [32] * len(his):
            raise AssertionError(f"kvtier serve ({side}): stream lengths")
        if st["preemptions"] != len(his):
            raise AssertionError(f"kvtier serve ({side}): "
                                 f"{st['preemptions']} preemptions")
    st = res["tier"][1]
    kinds = [k for k, _ in st["resumes"]]
    if not (st["swap_outs"] == st["swap_ins"] == len(his)
            and st["failures"] == st["drops"] == 0
            and st["prompt_fills"] == n_req
            and kinds == ["swap_in"] * len(his)):
        raise AssertionError(f"kvtier serve (tier): swaps {st['swap_outs']}"
                             f"/{st['swap_ins']}, failures "
                             f"{st['failures']}, drops {st['drops']}, "
                             f"prompt fills {st['prompt_fills']} (want "
                             f"{n_req}), resumes {kinds}")
    st0 = res["no tier"][1]
    if not (st0["prompt_fills"] > n_req and [k for k, _ in st0["resumes"]]
            == ["re_prefill"] * len(his)):
        raise AssertionError(f"kvtier serve (no tier): prompt fills "
                             f"{st0['prompt_fills']}, resumes "
                             f"{st0['resumes']}")
    same = sum(a == b for a, b in zip(res["tier"][0], res["no tier"][0]))
    for side, (outs, s) in res.items():
        log(f"serve: kvtier serve, {side:<7}: {n_req} requests (victims "
            f"{list(VICTIMS)} x 64, 2 x 64-token priority 10 x 32), "
            f"{s['tokens_generated']} tokens in {s['wall_s']:.3f} s = "
            f"{s['tokens_generated'] / s['wall_s']:.1f} tok/s; preemptions "
            f"{s['preemptions']}, prompt fills {s['prompt_fills']}; ragged "
            f"launches {s['launches']['ragged']} = {c['n_layers']} x "
            f"{s['forward_steps']}; resumes "
            + ", ".join(f"{k} {t * 1e3:.1f} ms" for k, t in s["resumes"])
            + f"; pages balanced [{card}]")
    log(f"serve: kvtier serve, tier: swap-outs {st['swap_outs']}, swap-ins "
        f"{st['swap_ins']}, failures {st['failures']}, drops {st['drops']} "
        f"(budget {KV_BUDGET >> 20} MiB holds every victim); "
        f"recompute_tokens_saved {st['saved']}; bytes out "
        f"{st['out_bytes']}, in {st['in_bytes']}; "
        + "; ".join(f"swap-{d} {n / 2**20:.1f} MiB {s * 1e3:.2f} ms "
                    f"({gbps(n, s):.2f} GB/s, {'write-behind landed' if d == 'out' else 'host time to the enqueued scatter'})"
                    for d, n, s in st["swaps"])
        + f"; {same}/{n_req} streams identical to the no-tier side (bf16)")
    log("serve: kvtier serve, tier pool, synced round trip at each evicted "
        "lane's page count: "
        + "; ".join(f"{n} pages {b / 2**20:.1f} MiB: swap-out landed "
                    f"{o * 1e3:.2f} ms ({gbps(b, o):.2f} GB/s), restore "
                    f"synced {r * 1e3:.2f} ms ({gbps(b, r):.2f} GB/s)"
                    for n, b, o, r in st["synced"]) + f" [{card}]")
    return res


def serve_disagg(torch, model, card):
    """A prefill batcher and a decode batcher on the same weights (two
    pools of the serving geometry): three prompts prefilled with
    ``export_digest``, shipped through the wire, admitted with
    ``submit_shipped`` (32 steps)."""
    import numpy as np

    from tpulab_torch.disagg import KVShipper, prompt_digest
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention

    c = LLAMA3_8B
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in (1500, 700, 64)]
    kw = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.bfloat16, device="cuda",
              kv_offload=KV_BUDGET, **SERVE)
    pre = ContinuousBatcher(model, **kw)
    dec = ContinuousBatcher(model, **kw)
    ragged_paged_attention.launches = 0
    rows, futs = [], []
    try:
        out_sh, in_sh = KVShipper(pre.kv_offload), KVShipper(dec.kv_offload)
        t0 = time.perf_counter()
        for p in prompts:
            dig = prompt_digest(p)
            fut = pre.submit(p, 1, export_digest=dig)
            first = fut.result(timeout=600)[0]
            t1 = time.perf_counter()
            blob = out_sh.export(fut._tpulab_kv_export, digest=dig,
                                 first_token=first)
            t2 = time.perf_counter()
            ship = in_sh.import_shipment(blob) if blob else None
            t3 = time.perf_counter()
            if ship is None:
                raise AssertionError(f"disagg serve: the {len(p)}-token "
                                     "shipment was lost")
            futs.append(dec.submit_shipped(p, 32, first, ship.handle))
            rows.append((len(p), len(blob), t2 - t1, t3 - t2))
        outs = [list(f.result(timeout=600)) for f in futs]
        wall = time.perf_counter() - t0
        launches = ragged_paged_attention.launches
        fs = pre.forward_steps + dec.forward_steps
        st = dict(pre_fills=pre.prompt_fills, dec_fills=dec.prompt_fills,
                  swap_ins=dec.kv_offload.swap_ins,
                  tokens=dec.tokens_generated)
    finally:
        pre.shutdown()
        dec.shutdown()
    if not (st["dec_fills"] == 0 and st["pre_fills"] == len(prompts)
            and st["swap_ins"] == len(prompts)
            and [len(o) for o in outs] == [32] * len(prompts)
            and launches == c["n_layers"] * fs
            and pre.pool.free_pages == pre.pool.n_pages - 1
            and dec.pool.free_pages == dec.pool.n_pages - 1):
        raise AssertionError(f"disagg serve: {st}, launches {launches} vs "
                             f"{c['n_layers']} x {fs}")
    log(f"serve: disagg serve, prefill + decode batchers: "
        + "; ".join(f"{n}-token prompt: wire {b} bytes, export {e * 1e3:.1f}"
                    f" ms, import {i * 1e3:.1f} ms" for n, b, e, i in rows)
        + f"; decode side 0 prompt fills, {st['swap_ins']} swap-ins, "
        f"{st['tokens']} tokens ({len(prompts)} x 32, index 0 shipped); "
        f"ragged launches {launches} = {c['n_layers']} x {fs}; "
        f"{wall:.3f} s; pages balanced [{card}]")
    return launches


# the speculative serve: SERVE plus an early-exit draft of the first 4
# layers, and a pool for two page tables a lane (2 x 8 x 128 + 1 pages)
SPEC_DRAFT_LAYERS = 4
SPEC = dict(draft_n_layers=SPEC_DRAFT_LAYERS,
            n_pages=2 * SERVE["lanes"] * SERVE["max_len"]
            // SERVE["page_size"] + 1)
SPEC_TAIL_SCALE = 0.05


def spec_specs(prompts, stop_token):
    """The speculative serve's mix: 8 requests x 64 steps; five greedy
    (one with a stop token, one with logprobs), three device-sampled at
    T 0.8.  No host-sampled lane: one would make every dispatch plain."""
    from tpulab_torch.engine.paged import SamplingParams

    def dev(seed):
        return dict(sampling=SamplingParams(temperature=0.8, seed=seed,
                                            device=True))

    kinds = [("greedy_stop", dict(stop_tokens=(
                [stop_token] if stop_token is not None else None))),
             ("device_a", dev(1234)), ("greedy_b", {}), ("device_b", dev(99)),
             ("greedy_c", {}), ("greedy_logprobs", dict(logprobs=True)),
             ("greedy_d", {}), ("device_c", dev(7))]
    return [(name, p, 64, kw) for (name, kw), p in zip(kinds, prompts)]


def serve_spec(torch, model, card, profile):
    """The same mix through a plain and a speculating batcher on the same
    weights (layers 4-31's wo / w2 scaled by 0.05 IN PLACE first: the
    trained-model emulation, without which an early-exit draft agrees
    with almost nothing).  Per mode three runs: run 1 picks the stop
    token (greedy_stop's 9th), runs 2 and 3 must be identical."""
    import numpy as np

    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.transformer import early_exit_draft
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention

    c = LLAMA3_8B
    with torch.inference_mode():
        for layer in model.layers[SPEC_DRAFT_LAYERS:]:
            layer.wo.mul_(SPEC_TAIL_SCALE)
            layer.w2.mul_(SPEC_TAIL_SCALE)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in (5, 64, 300, 700, 1000, 1500, 64, 300)]
    counted = {"ragged": ragged_paged_attention}
    res = {}
    for mode in ("plain", "spec"):
        extra = (dict(SPEC, draft_params=early_exit_draft(
            model, SPEC_DRAFT_LAYERS)) if mode == "spec" else {})
        cb = ContinuousBatcher(model, n_heads=c["n_heads"],
                               n_layers=c["n_layers"],
                               n_kv_heads=c["n_kv_heads"],
                               rope_theta=c["rope_theta"],
                               compute_dtype=torch.bfloat16, device="cuda",
                               **SERVE, **extra)
        try:
            out1, _ = run_mix(torch, cb, spec_specs(prompts, None), counted)
            stop = out1["greedy_stop"][8]
            runs = []
            for i in range(2):
                torch.cuda.synchronize()
                if profile and mode == "spec" and i == 1:
                    from torch.profiler import ProfilerActivity

                    from tpulab_torch.utils.tracing import profiler_session
                    with profiler_session(activities=[
                            ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
                        runs.append(run_mix(torch, cb,
                                            spec_specs(prompts, stop),
                                            counted))
                    device_breakdown(torch, prof, runs[-1][1]["wall_s"],
                                     card, "spec serve, speculating batcher")
                else:
                    runs.append(run_mix(torch, cb, spec_specs(prompts, stop),
                                        counted))
            # every request resolved: its lane, both tables, went home
            free = cb.pool.free_pages
            n_pages = cb.pool.n_pages
        finally:
            cb.shutdown()
        (out2, st2), (out3, st3) = runs
        if free != n_pages - 1:
            raise AssertionError(f"{mode} serve: {free} free pages after the "
                                 f"last request, want {n_pages - 1}")
        cut = out1["greedy_stop"].index(stop) + 1
        if out2["greedy_stop"] != out1["greedy_stop"][:cut]:
            raise AssertionError(f"{mode} serve: the stop token did not end "
                                 "greedy_stop where run 1 emits it")
        for name, toks in out2.items():
            toks = toks[0] if isinstance(toks, tuple) else toks
            if name != "greedy_stop" and len(toks) != 64:
                raise AssertionError(f"{mode} {name}: {len(toks)} tokens")
            if not all(0 <= t < c["vocab"] for t in toks):
                raise AssertionError(f"{mode} {name}: token outside vocab")
            if out3[name] != out2[name]:
                raise AssertionError(f"{mode} {name}: run 3 differs")
        lps = out2["greedy_logprobs"][1]
        if not all(math.isfinite(x) and x <= 0 for x in lps):
            raise AssertionError(f"{mode}: logprobs must be finite and <= 0")
        for st in (st2, st3):
            ra = st["launches"]["ragged"]
            want = (c["n_layers"] * st["forward_steps"]
                    + SPEC_DRAFT_LAYERS * st["draft_forward_steps"])
            if ra != want or st["by_body"]["ragged"] != {"fma": 0,
                                                         "wgmma": ra}:
                raise AssertionError(
                    f"{mode} serve: ragged launches {ra} (by body "
                    f"{st['by_body']['ragged']}), want {c['n_layers']} x "
                    f"{st['forward_steps']} + {SPEC_DRAFT_LAYERS} x "
                    f"{st['draft_forward_steps']}, all on wgmma")
            spec_ran = (st["spec_dispatches"] > 0 and st["kinds"]["verify"]
                        == st["spec_dispatches"]
                        and st["spec_tokens_accepted"] > 0)
            if spec_ran != (mode == "spec"):
                raise AssertionError(f"{mode} serve: spec dispatches "
                                     f"{st['spec_dispatches']}, kinds "
                                     f"{st['kinds']}, accepted "
                                     f"{st['spec_tokens_accepted']}")
        res[mode] = st2 | {"wall3_s": st3["wall_s"]}
    for mode, st in res.items():
        tok = st["tokens"]
        acc = st["spec_tokens_accepted"] / max(1, st["spec_tokens_drafted"])
        log(f"serve: spec serve, {mode:<5}: {tok} tokens in "
            f"{st['wall_s']:.3f} s = {tok / st['wall_s']:.1f} tok/s (run 3: "
            f"{tok / st['wall3_s']:.1f}); {tok / st['decode_dispatches']:.2f} "
            f"tokens per decode dispatch ({st['kinds']}); "
            f"{st['decode_host_syncs'] / tok:.4f} host syncs per token; "
            f"acceptance {acc:.3f} ({st['spec_tokens_accepted']}/"
            f"{st['spec_tokens_drafted']}), fallbacks {st['spec_fallbacks']}, "
            f"probes {st['spec_probes']}; ragged launches "
            f"{st['launches']['ragged']} = {c['n_layers']} x "
            f"{st['forward_steps']} + {SPEC_DRAFT_LAYERS} x "
            f"{st['draft_forward_steps']} draft forwards, all wgmma; "
            f"streams of runs 2 and 3 identical [{card}]")
    return res


def forward_device_ms(torch, params, kv_dtype, card, label):
    """Device time of one decode forward (``paged_decode_step``) at the
    serve's width, 32 layers, 8 lanes at position 1023 over a
    ``kv_dtype`` pool: the kernels' device time summed over 3 profiled
    forwards (torch.profiler, CUDA activity) / 3, by class; and the
    forward's stream time (CUDA events, mean of 3)."""
    from torch.profiler import ProfilerActivity

    from tpulab_torch.utils.tracing import profiler_session

    from tpulab_torch.engine.paged import PagedKVPool, paged_decode_step

    c = LLAMA3_8B
    b, mp, s = 8, 64, 16
    pool = PagedKVPool(b * mp + 1, s, c["n_layers"], c["n_kv_heads"],
                       c["d_model"] // c["n_heads"], kv_dtype, "cuda")
    tables = torch.arange(1, b * mp + 1, dtype=torch.int32,
                          device="cuda").reshape(b, mp)
    lengths = torch.full((b,), mp * s - 1, dtype=torch.int32, device="cuda")
    tokens = torch.arange(b, device="cuda") * 1000 % c["vocab"]
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    kw = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.bfloat16)

    def step():
        return paged_decode_step(params, pool.kv, tables, lengths, tokens,
                                 active, **kw)

    with torch.inference_mode():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(3):
            step()
        e.record()
        e.synchronize()
        stream_ms = a.elapsed_time(e) / 3
        with profiler_session(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
    pool.close()
    classes = {k: ms / 3 for k, ms in kernel_classes(torch, p)[1].items()}
    total = sum(classes.values())
    if total == 0:
        log(f"serve: one decode forward, {label}: device time not measured "
            f"(the profiler saw no device activity); stream time "
            f"{stream_ms:.3f} ms [{card}]")
        return dict(device_ms=None, stream_ms=stream_ms, classes=classes)
    log(f"serve: one decode forward, {label}, 8 lanes at position 1023: "
        f"device {total:.3f} ms (" + ", ".join(
            f"{k} {v:.3f}" for k, v in classes.items())
        + f"); stream time {stream_ms:.3f} ms [{card}]")
    return dict(device_ms=total, stream_ms=stream_ms, classes=classes)


def phase_serve(torch, card, profile=False):
    import numpy as np

    from tpulab_torch.models.quantization import (quantize_transformer_params,
                                                  transformer_param_bytes)
    from tpulab_torch.models.transformer import Transformer

    c = LLAMA3_8B
    t0 = time.perf_counter()
    model = Transformer(full_width_params(torch, c["n_layers"],
                                          torch.bfloat16, seed=0),
                        n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
                        rope_theta=c["rope_theta"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serve: Llama-3-8B geometry, {n_params / 1e9:.3f} B params bf16, "
        f"random init {time.perf_counter() - t0:.1f} s; weights "
        f"{transformer_param_bytes(model) / 1e9:.3f} GB")
    rng = np.random.default_rng(7)
    prompts = {n: rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in (5, 64, 300, 700, 1000, 1500)}
    prompts["late"] = rng.integers(0, c["vocab"], (64,)).astype(np.int32)
    out = {}
    for plan in ("ragged", "split"):
        t1 = time.perf_counter()
        out[plan] = serve_plan(torch, model, prompts, plan, card, profile)
        log(f"serve: {plan} plan {time.perf_counter() - t1:.1f} s")
    # W8A16 with e4m3 pages: the int8 tree quantized on the card from the
    # same bf16 weights (before the spec serve scales them)
    t1 = time.perf_counter()
    qmodel = Transformer(quantize_transformer_params(model),
                         n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
                         rope_theta=c["rope_theta"])
    torch.cuda.synchronize()
    out["weight_bytes"] = (transformer_param_bytes(model),
                           transformer_param_bytes(qmodel))
    log(f"serve: int8 weights quantized on the card in "
        f"{time.perf_counter() - t1:.1f} s: {out['weight_bytes'][1]} bytes "
        f"({out['weight_bytes'][1] / 1e9:.3f} GB) against "
        f"{out['weight_bytes'][0]} bf16")
    e4m3 = torch.float8_e4m3fn
    for plan in ("ragged", "split"):
        t1 = time.perf_counter()
        out[f"int8 {plan}"] = serve_plan(
            torch, qmodel, prompts, plan, card, profile, kv_dtype=e4m3,
            weights="int8")
        log(f"serve: int8/e4m3 {plan} plan {time.perf_counter() - t1:.1f} s")
    out["forward"] = {
        "bf16": forward_device_ms(torch, model.params, torch.bfloat16,
                                  card, "bf16 weights, bf16 KV"),
        "int8": forward_device_ms(torch, qmodel.params, e4m3, card,
                                  "int8 weights, e4m3 KV")}
    for plan in ("ragged", "split"):
        a, q = out[plan], out[f"int8 {plan}"]
        log(f"serve: {plan} plan, bf16 weights + bf16 KV vs int8 weights + "
            f"e4m3 KV (same call, same mix): tok/s "
            f"{a['tokens'] / a['wall_s']:.1f} / "
            f"{a['tokens'] / a['wall3_s']:.1f} vs "
            f"{q['tokens'] / q['wall_s']:.1f} / "
            f"{q['tokens'] / q['wall3_s']:.1f} (runs 2 / 3); TTFT max "
            f"{a['ttft_s'][-1] * 1e3:.1f} vs {q['ttft_s'][-1] * 1e3:.1f} ms;"
            f" pool {a['pool_bytes']} vs {q['pool_bytes']} bytes"
            + (f"; device busy (run 3) {100 * a['busy3']['share']:.1f} % vs "
               f"{100 * q['busy3']['share']:.1f} %" if q["busy3"] else "")
            + f" [{card}]")
    del qmodel
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out["kvtier"] = serve_kvtier(torch, model, card)
    out["disagg"] = serve_disagg(torch, model, card)
    log(f"serve: kvtier and disagg serves {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    out["spec"] = serve_spec(torch, model, card, profile)
    log(f"serve: spec serve (plain and speculating batchers) "
        f"{time.perf_counter() - t1:.1f} s")
    return out


# ---------------------------------------------------------------- phase 6
# The README quickstart's model (ResNet-50, 224 x 224 x 3 uint8 input, 1000
# classes, max_batch_size=128, bf16 compute) and ViT-B/16 at the same
# serving settings (google/vit-base-patch16-224 geometry: d 768, 12 heads,
# 12 layers, d_ff 3072); random weights from the registry's seed 0.
INFER_MODELS = (("rn50", "resnet50"), ("vit_b16", "vit_b16"))
INFER = dict(max_batch_size=128, concurrency=4, sizes=(1, 3, 8, 128),
             bench=(1, 8, 32, 128), seconds=2.0, latency_iters=100,
             profile_batches=16, requests=64, threads=8, window_s=0.005)
# logits against a reference: max abs error <= tol x max |reference logit|,
# and the same top-1 wherever the reference's top-1 margin exceeds that.
# f32 card vs the port's CPU forward (cuDNN / cuBLAS TF32 off): both sum
# in f32, in other orders and algorithms.  bf16 serving forward vs the
# f32 one: tpulab's own bf16 logits sit 1-2 % (relative) from its f32 ones
# at image 32 (tests/test_torch_vision.py's measure).
INFER_F32_TOL = 1e-3
INFER_BF16_TOL = 5e-2


def logit_check(torch, label, got, want, tol, quiet=False):
    """``got`` against ``want`` (B, classes) under the rule above; returns
    the relative error or raises."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    bound = tol * scale
    if not torch.isfinite(got).all() or err > bound:
        raise AssertionError(f"{label}: max abs err {err:.3e} > {tol:g} x "
                             f"max |logit| {scale:.3e}")
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > bound
    same = got.argmax(-1) == want.argmax(-1)
    if not same[clear].all():
        raise AssertionError(f"{label}: top-1 differs where the margin "
                             f"exceeds {bound:.3e}")
    if not quiet:
        log(f"infer: {label}: max abs err {err:.3e} = {err / scale:.2e} x "
            f"max |logit| {scale:.3e} (tol {tol:g}); top-1 equal on "
            f"{int(clear.sum())} clear rows of {len(same)}")
    return err / scale


def infer_images(np, n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 224, 224, 3)).astype(np.uint8)


def pools_home(mgr, name, timeout=30.0):
    """Every buffers slot, execution token and context back in its pool
    (the post stage returns them just after it settles the future)."""
    pools = {"buffers": mgr.buffers_pool, "tokens": mgr.exec_tokens,
             "contexts": mgr.context_pool(name)}
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(p.available == p.size for p in pools.values()):
            return {k: p.size for k, p in pools.items()}
        time.sleep(0.005)
    raise AssertionError(f"{name}: pools not home: " + ", ".join(
        f"{k} {p.available}/{p.size}" for k, p in pools.items()))


def infer_cpu_checks(torch, np, mgr, name, model):
    """f32 on the card (TF32 off) vs the port's CPU forward on the same
    weights, then the bf16 serving forward (the placed weights) vs that
    f32 result; batch 2."""
    from tpulab_torch.engine.runtime import tree_to

    def f32_forward(params, x):
        fn = model.apply_fn         # a functools.partial of the model's apply
        return fn.func(params, {"input": x}, **dict(
            fn.keywords, compute_dtype=torch.float32))["logits"]

    x = infer_images(np, 2, 11)
    on_card = torch.from_numpy(x).cuda()
    card = f32_forward(model.params, on_card)
    cpu = f32_forward(tree_to(model.params, "cpu"), torch.from_numpy(x))
    e32 = logit_check(torch, f"{name} f32 card vs CPU", card, cpu,
                      INFER_F32_TOL)
    bf16 = mgr.compiled(name)(2, {"input": on_card})["logits"]
    e16 = logit_check(torch, f"{name} bf16 serving vs f32 card", bf16, card,
                      INFER_BF16_TOL)
    return e32, e16


def infer_serving_checks(torch, np, mgr, name):
    """infer_runner at every size of INFER["sizes"] against the bucket's
    direct forward; one request twice, bit for bit; 64 requests from 8
    threads, each against its own sequential result, then every slot and
    token home; a BatchedInferRunner over 64 batch-1 requests."""
    import threading

    from tpulab_torch.engine.batched_runner import BatchedInferRunner

    runner = mgr.infer_runner(name)
    compiled = mgr.compiled(name)
    model = mgr.model(name)
    for n in INFER["sizes"]:
        x = infer_images(np, n, 100 + n)
        got = runner.infer(input=x).result(120)["logits"]
        bucket = model.pick_bucket(n)
        padded = np.zeros((bucket, 224, 224, 3), np.uint8)
        padded[:n] = x
        direct = compiled(bucket, {"input": torch.from_numpy(
            padded).cuda()})["logits"][:n].cpu()
        if got.shape != (n, 1000):
            raise AssertionError(f"{name}: batch {n} gave {got.shape}")
        check_close(torch, f"{name} runner batch {n} (bucket {bucket}) vs "
                    f"its direct forward", torch.from_numpy(got), direct)
    x = infer_images(np, 8, 7)
    a = runner.infer(input=x).result(120)["logits"]
    b = runner.infer(input=x).result(120)["logits"]
    if not np.array_equal(a, b):
        raise AssertionError(f"{name}: the same request twice differs")
    log(f"infer: {name}: batch 8 twice bit-identical")

    inputs = [infer_images(np, 1 + i % 8, 200 + i) for i in range(8)]
    want = [runner.infer(input=v).result(120)["logits"] for v in inputs]
    results, errors = [], []
    per = INFER["requests"] // INFER["threads"]

    def client(t):
        try:
            futs = [(k, runner.infer(input=inputs[k]))
                    for k in ((t + j) % 8 for j in range(per))]
            results.extend((k, f.result(300)["logits"]) for k, f in futs)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(INFER["threads"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or len(results) != INFER["requests"]:
        raise AssertionError(f"{name}: {len(results)} of "
                             f"{INFER['requests']} resolved: {errors[:1]}")
    same = sum(int(np.array_equal(got, want[k])) for k, got in results)
    worst = max(logit_check(torch, f"{name} concurrent request {k}",
                            torch.from_numpy(got), torch.from_numpy(want[k]),
                            INFER_BF16_TOL, quiet=True)
                for k, got in results)
    home = pools_home(mgr, name)
    log(f"infer: {name}: {len(results)} requests from {len(threads)} "
        f"threads resolved ({same} bit-identical to their sequential "
        f"result, worst {worst:.2e} x max |logit|); pools home {home}")

    batched = BatchedInferRunner(mgr, name, window_s=INFER["window_s"])
    singles = [infer_images(np, 1, 300 + i) for i in range(INFER["requests"])]
    alone = [runner.infer(input=v).result(120)["logits"] for v in singles]
    try:
        futs = [batched.infer(input=v) for v in singles]
        rows = [f.result(300)["logits"] for f in futs]
    finally:
        batched.shutdown()
    launched = batched.batches_launched
    if not 1 <= launched < len(singles):
        raise AssertionError(f"{name}: batched runner launched {launched} "
                             f"batches for {len(singles)} requests")
    worst = max(logit_check(torch, f"{name} batched row {i}",
                            torch.from_numpy(r), torch.from_numpy(w),
                            INFER_BF16_TOL, quiet=True)
                for i, (r, w) in enumerate(
                                zip(rows, alone)))
    pools_home(mgr, name)
    log(f"infer: {name}: BatchedInferRunner {len(singles)} batch-1 requests "
        f"-> {launched} batches; rows vs unbatched worst {worst:.2e} x "
        f"max |logit|")
    return dict(batches_launched=launched, requests=len(singles))


def infer_kernel_classes(torch, prof):
    """Device time (ms, summed over kernels) by class: convolutions,
    matrix products, elementwise, other (reductions, pooling, softmax,
    layout and dtype copies)."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    classes = {"conv": 0.0, "gemm": 0.0, "elementwise": 0.0, "other": 0.0}
    for e in kernels:
        n = e.key.lower()
        cls = ("conv" if any(w in n for w in (
                   "conv", "fprop", "winograd", "cudnn", "implicit"))
               else "gemm" if any(w in n for w in (
                   "gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas"))
               else "elementwise" if "elementwise" in n
               else "other")
        classes[cls] += dev_ms(e)
    return kernels, classes


def infer_profile(torch, np, mgr, name, card):
    """One profiled window at batch 128 (INFER["profile_batches"] batches,
    the buffers pool's depth in flight): the device's busy share of the
    wall time and the device time by kernel class."""
    from torch.profiler import ProfilerActivity

    from tpulab_torch.utils.tracing import device_busy_ms, profiler_session

    runner = mgr.infer_runner(name)
    x = infer_images(np, INFER["max_batch_size"], 5)
    runner.infer(input=x).result(300)
    with profiler_session(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inflight = []
        for _ in range(INFER["profile_batches"]):
            if len(inflight) >= mgr.max_buffers:
                inflight.pop(0).result(300)
            inflight.append(runner.infer(input=x))
        for f in inflight:
            f.result(300)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, classes = infer_kernel_classes(torch, prof)
    busy = device_busy_ms(prof)
    total = sum(classes.values())
    if total == 0:
        log(f"infer: {name} profile: device time not measured (the "
            f"profiler saw no device activity); wall {wall_ms:.1f} ms "
            f"[{card}]")
        return dict(wall_ms=wall_ms, busy_ms=None, busy_share=None,
                    classes=classes)
    log(f"infer: {name} profile, {INFER['profile_batches']} batches of "
        f"{INFER['max_batch_size']}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall_ms:.1f} %), kernel time "
        f"{total:.1f} ms [{card}]")
    for cls, ms in classes.items():
        log(f"infer:   {cls:<12} {ms:10.1f} ms "
            f"({100 * ms / max(total, 1e-9):.1f} % of kernel time)")
    for e in sorted(kernels, key=dev_ms, reverse=True)[:6]:
        log(f"infer:   {dev_ms(e):10.1f} ms {e.count:6d}x {e.key[:80]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms,
                classes=classes)


def infer_measure(torch, mgr, name, card):
    """InferBench.run at every batch of INFER["bench"] and .latency at
    batch 1, each images/s beside its compute bound: FLOPs per image
    (``CompiledModel.flops``) over the card's dense bf16 peak."""
    from tpulab_torch.engine.infer_bench import InferBench

    flops = mgr.compiled(name).flops(1)
    bound_ips = PEAK_OPS_S["bf16"] / flops
    bench = InferBench(mgr)
    runs = {}
    for b in INFER["bench"]:
        r = bench.run(name, batch_size=b, seconds=INFER["seconds"], warmup=4)
        runs[b] = r
        log(f"infer: {name} batch {b}: {r['inferences_per_second']:.1f} "
            f"images/s ({r['batches_per_second']:.2f} batches/s, "
            f"{r['execution_time_per_batch_ms']:.3f} ms/batch, "
            f"{int(r['max_concurrency'])} in flight, "
            f"{int(r['batches_computed'])} batches); compute bound "
            f"{bound_ips:.0f} images/s ({flops / 1e9:.3f} GFLOP/image at "
            f"{PEAK_OPS_S['bf16'] / 1e12:.0f} TFLOP/s bf16) [{card}]")
    lat = bench.latency(name, batch_size=1,
                        iterations=INFER["latency_iters"])
    log(f"infer: {name} latency, batch 1, {lat['iterations']} closed-loop "
        f"requests: p50 {lat['p50_ms']:.3f} ms, p90 {lat['p90_ms']:.3f} ms, "
        f"p99 {lat['p99_ms']:.3f} ms, mean {lat['mean_ms']:.3f} ms; bound "
        f"{flops / PEAK_OPS_S['bf16'] * 1e3:.4f} ms [{card}]")
    return dict(gflop_per_image=flops / 1e9, bound_images_s=bound_ips,
                images_s={b: r["inferences_per_second"]
                          for b, r in runs.items()},
                ms_per_batch={b: r["execution_time_per_batch_ms"]
                              for b, r in runs.items()},
                latency_ms={k: lat[k] for k in ("p50_ms", "p90_ms",
                                                  "p99_ms")})


def phase_infer(torch, card):
    """The compiled-model Infer path: ``InferenceManager`` ->
    ``InferRunner`` / ``BatchedInferRunner`` -> ``InferBench`` serving
    ResNet-50 and ViT-B/16 at full width."""
    import numpy as np

    import tpulab_torch
    from tpulab_torch.models import build_model

    torch.backends.cudnn.benchmark = False     # the same kernels each call
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mgr = tpulab_torch.InferenceManager(
        max_exec_concurrency=INFER["concurrency"])
    models = {}
    for name, entry in INFER_MODELS:
        t1 = time.perf_counter()
        models[name] = build_model(entry,
                                   max_batch_size=INFER["max_batch_size"],
                                   input_dtype=np.uint8)
        mgr.register_model(name, models[name])
        c = mgr.compiled(name)
        log(f"infer: registered {name} ({entry}): "
            f"{models[name].weights_size_in_bytes()} weight bytes (f32 "
            f"tree), buckets {models[name].batch_buckets}, activations "
            f"{c.activation_size_in_bytes()} bytes at bucket "
            f"{INFER['max_batch_size']}, {time.perf_counter() - t1:.1f} s "
            "(weights drawn, placed, every bucket run once)")
    mgr.update_resources()
    out = {}
    try:
        for name, _entry in INFER_MODELS:
            st = out[name] = {}
            st["f32_vs_cpu"], st["bf16_vs_f32"] = infer_cpu_checks(
                torch, np, mgr, name, models[name])
            st.update(infer_serving_checks(torch, np, mgr, name))
        for name, _entry in INFER_MODELS:
            out[name].update(infer_measure(torch, mgr, name, card))
            out[name]["profile"] = infer_profile(torch, np, mgr, name, card)
            pools_home(mgr, name)
    finally:
        mgr.shutdown()
    log("infer: " + json.dumps(out))
    log(f"infer: phase {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------- phase 16
# Bring-your-own-model: trtlab's model-entry workflow on the port.  (a)
# ResNet-50 written as ONNX from seeded f32 weights (every conv
# SAME_UPPER, BatchNormalization unfolded), imported, served, held
# against the native ResNet-50 on the folded weights and against its own
# CPU run; imported again with int8 weights; saved as an engine artifact,
# loaded with no apply_fn and served.  (b) ``resnet50_int8`` from the
# registry (W8) and W8A8 calibrated on seeded batches; one W8A8 conv's
# int32 accumulators against the CPU's int64 products; a CUDA-graph
# workspace at bucket 8 against the eager program.  (c) a torchvision-
# named ResNet-50, an HF-named ViT-B/16 and an HF-named Llama-3-8B-width
# state dict (bf16, cut to 4 layers) through the importers, served.
IMPORT = dict(max_batch_size=32, bench_batch=32, bench_s=1.0, seed=16,
              calib_batches=4, calib_batch=8, ws_bucket=8, ws_iters=20,
              tv_vit_max_batch=8, llama_layers=4, plan_buckets=(8, 32))
# The artifact holds two of the model's six buckets (cut: one
# torch.export trace took 10-17 s inside this script on the H100's host,
# six of them 78-89 s of the phase).
# int8 against f32 logits: tpulab's own bounds (tests/test_quantization.py)
# — weight-only: max abs error below 0.1 x max |logit| and correlation
# above 0.99; W8A8: correlation above 0.95.  Top-1 is printed; it is
# gated (logit_check's rule) only where the f32 margin exceeds the bound.
IMPORT_W8_TOL = 0.1
IMPORT_W8_CORR = 0.99
IMPORT_W8A8_CORR = 0.95


def tv_resnet50_sd(torch, seed):
    """A torchvision-named ResNet-50 state dict of seeded weights (He
    convs, BatchNorm statistics near identity, an N(0, 0.01) head), on
    the CPU."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, std=1.0):
        return torch.randn(*shape, generator=g) * std

    sd = {}

    def conv_bn(conv, bn, cout, cin, k):
        sd[f"{conv}.weight"] = n(cout, cin, k, k,
                                 std=math.sqrt(2.0 / (cin * k * k)))
        sd[f"{bn}.weight"] = 1 + n(cout, std=0.1)
        sd[f"{bn}.bias"] = n(cout, std=0.1)
        sd[f"{bn}.running_mean"] = n(cout, std=0.1)
        sd[f"{bn}.running_var"] = (1 + n(cout, std=0.1)).abs()

    conv_bn("conv1", "bn1", 64, 3, 7)
    cin = 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        cmid = 64 * 2 ** stage
        for b in range(blocks):
            pre = f"layer{stage + 1}.{b}"
            conv_bn(f"{pre}.conv1", f"{pre}.bn1", cmid, cin, 1)
            conv_bn(f"{pre}.conv2", f"{pre}.bn2", cmid, cmid, 3)
            conv_bn(f"{pre}.conv3", f"{pre}.bn3", cmid * 4, cmid, 1)
            if b == 0:
                conv_bn(f"{pre}.downsample.0", f"{pre}.downsample.1",
                        cmid * 4, cin, 1)
            cin = cmid * 4
    sd["fc.weight"] = n(1000, cin, std=0.01)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def hf_vit_b16_sd(torch, seed):
    """An HF-named ViT-B/16 (224, 1000 classes) state dict of seeded
    N(0, 0.02) weights and near-unit LayerNorms, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    d, ff, layers = 768, 3072, 12

    def n(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {"vit.embeddings.cls_token": n(1, 1, d),
          "vit.embeddings.position_embeddings": n(1, 197, d),
          "vit.embeddings.patch_embeddings.projection.weight":
              n(d, 3, 16, 16),
          "vit.embeddings.patch_embeddings.projection.bias": n(d),
          "vit.layernorm.weight": 1 + n(d), "vit.layernorm.bias": n(d),
          "classifier.weight": n(1000, d), "classifier.bias": n(1000)}
    for i in range(layers):
        pre = f"vit.encoder.layer.{i}"
        for m in ("query", "key", "value"):
            sd[f"{pre}.attention.attention.{m}.weight"] = n(d, d)
            sd[f"{pre}.attention.attention.{m}.bias"] = n(d)
        sd.update({
            f"{pre}.layernorm_before.weight": 1 + n(d),
            f"{pre}.layernorm_before.bias": n(d),
            f"{pre}.layernorm_after.weight": 1 + n(d),
            f"{pre}.layernorm_after.bias": n(d),
            f"{pre}.attention.output.dense.weight": n(d, d),
            f"{pre}.attention.output.dense.bias": n(d),
            f"{pre}.intermediate.dense.weight": n(ff, d),
            f"{pre}.intermediate.dense.bias": n(ff),
            f"{pre}.output.dense.weight": n(d, ff),
            f"{pre}.output.dense.bias": n(d)})
    return sd


def hf_llama_sd(tree, n_layers):
    """The HF ``LlamaForCausalLM`` names of a transformer tree (q / k / v
    split out of ``wqkv``, every Linear weight (out, in)), on its
    device, in its dtype."""
    c = LLAMA3_8B
    hd = c["d_model"] // c["n_heads"]
    q, kv = c["n_heads"] * hd, c["n_kv_heads"] * hd
    sd = {"model.embed_tokens.weight": tree["embed"],
          "model.norm.weight": tree["final_norm"]["scale"],
          "lm_head.weight": tree["lm_head"].T.contiguous()}
    for i in range(n_layers):
        lp, pre = tree[f"layer{i}"], f"model.layers.{i}"
        wqkv = lp["wqkv"]
        sd.update({
            f"{pre}.input_layernorm.weight": lp["ln1"]["scale"],
            f"{pre}.post_attention_layernorm.weight": lp["ln2"]["scale"],
            f"{pre}.self_attn.q_proj.weight": wqkv[:, :q].T.contiguous(),
            f"{pre}.self_attn.k_proj.weight":
                wqkv[:, q:q + kv].T.contiguous(),
            f"{pre}.self_attn.v_proj.weight":
                wqkv[:, q + kv:].T.contiguous(),
            f"{pre}.self_attn.o_proj.weight": lp["wo"].T.contiguous(),
            f"{pre}.mlp.gate_proj.weight": lp["w1"].T.contiguous(),
            f"{pre}.mlp.up_proj.weight": lp["w3"].T.contiguous(),
            f"{pre}.mlp.down_proj.weight": lp["w2"].T.contiguous()})
    return sd


def tree_cast(tree, dtype):
    return {k: tree_cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def trees_equal(torch, a, b, path=""):
    """Every leaf of ``b`` equal to ``a``'s, bit for bit, dtype too;
    returns the leaf count or raises naming the first difference."""
    if set(a) != set(b):
        raise AssertionError(f"import: tree keys differ at {path!r}")
    n = 0
    for k, v in a.items():
        if isinstance(v, dict):
            n += trees_equal(torch, v, b[k], f"{path}/{k}")
        elif v.dtype != b[k].dtype or not torch.equal(v, b[k]):
            raise AssertionError(f"import: leaf {path}/{k} differs")
        else:
            n += 1
    return n


def corr(torch, a, b) -> float:
    a, b = a.double().flatten().cpu(), b.double().flatten().cpu()
    return float(torch.corrcoef(torch.stack([a, b]))[0, 1])


def card_images(torch, n, seed, nchw=False):
    """Seeded f32 N(0, 1) images on the card (NHWC, or NCHW)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n, 3, 224, 224) if nchw else (n, 224, 224, 3)
    return torch.randn(*shape, device="cuda", generator=g)


def runner_rows(torch, mgr, name, x):
    """``x`` through the manager's runner (numpy out) and the bucket's
    direct forward cut to the batch: the runner's rows bit for bit."""
    m = mgr.compiled(name).model
    arr = x.cpu().numpy()
    got = mgr.infer_runner(name).infer(
        **{m.inputs[0].name: arr}).result(timeout=300)
    out = m.outputs[0].name
    bucket = m.pick_bucket(x.shape[0])
    pad = torch.zeros((bucket, *x.shape[1:]), dtype=x.dtype, device="cuda")
    pad[:x.shape[0]] = x
    with torch.inference_mode():
        want = mgr.compiled(name)(bucket, {m.inputs[0].name: pad})[out]
    want = want[:x.shape[0]].cpu()
    if not torch.equal(torch.from_numpy(got[out]), want):
        raise AssertionError(f"import: {name} runner rows differ from the "
                             f"bucket {bucket} forward")
    return want


def import_int32_check(torch, q, units):
    """One W8A8 conv per unit named: the quantized activation's int32
    accumulators on the card (``torch._int_mm``) against the CPU's int64
    products, bit for bit."""
    from tpulab_torch.models.resnet import int8_conv, quantize_activation

    out = {}
    for name, (cin, size, stride) in units.items():
        unit = q
        for part in name.split("/"):
            unit = unit[part]
        g = torch.Generator(device="cuda").manual_seed(len(name))
        # activations spanning the unit's calibrated range (and past it:
        # the clip at +-127 included)
        x = torch.randn(2, cin, size, size, device="cuda", generator=g)
        xq = quantize_activation(x * (unit["act_scale"] * 60),
                                 unit["act_scale"])
        rows = unit["kernel"].permute(3, 0, 1, 2)
        card = int8_conv(xq, rows, stride)
        cpu = int8_conv(xq.cpu(), rows.cpu(), stride)
        if card.dtype != torch.int32 or not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"import: {name} int32 accumulators "
                                 "differ from the CPU's int64 products")
        out[name] = [list(card.shape), int(card.abs().max())]
    return out


def import_workspace(torch, mgr, name, card):
    """A TimedBenchmarkWorkspace at IMPORT["ws_bucket"] over the manager's
    compiled model: the graph replay bit-identical to the eager bucket
    program on seeded inputs, and its compute time against the eager
    forward's (CUDA events, warm)."""
    import statistics

    from tpulab_torch.engine.workspace import TimedBenchmarkWorkspace

    compiled = mgr.compiled(name)
    b = IMPORT["ws_bucket"]
    t0 = time.perf_counter()
    ws = TimedBenchmarkWorkspace(compiled.model, batch_size=b,
                                 compiled=compiled)
    build_s = time.perf_counter() - t0
    if ws.graph is None:
        raise AssertionError(f"import: {name} workspace captured no graph")
    stages = []
    for i in range(IMPORT["ws_iters"]):
        x = card_images(torch, b, 700 + i)
        ws.host_input_tensors["input"].copy_(x)
        stages.append(ws.timed_run())
        if i < 2:
            with torch.inference_mode():
                want = compiled(b, {"input": x})["logits"].cpu()
            if not torch.equal(torch.from_numpy(ws.host_outputs["logits"]),
                               want):
                raise AssertionError(f"import: {name} graph replay differs "
                                     "from the eager bucket program")
    x = card_images(torch, b, 799)
    eager = []
    with torch.inference_mode():
        for _ in range(IMPORT["ws_iters"]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            compiled(b, {"input": x})
            e1.record()
            e1.synchronize()
            eager.append(e0.elapsed_time(e1))
    med = {k: statistics.median(s[k] for s in stages[2:])
           for k in stages[0]}
    eager_ms = statistics.median(eager[2:])
    log(f"import: {name} CUDA-graph workspace, bucket {b}: captured in "
        f"{build_s:.2f} s; replay bit-identical to the eager bucket program "
        f"on 2 seeded batches; median of {len(stages) - 2} timed runs: h2d "
        f"{med['h2d_ms']:.4f} ms, compute {med['compute_ms']:.4f} ms "
        f"against eager {eager_ms:.4f} ms ({eager_ms / med['compute_ms']:.2f}"
        f"x), d2h {med['d2h_ms']:.4f} ms, total {med['total_ms']:.4f} ms "
        f"[{card}]")
    return dict(graph_compute_ms=med["compute_ms"], eager_ms=eager_ms,
                h2d_ms=med["h2d_ms"], d2h_ms=med["d2h_ms"],
                total_ms=med["total_ms"], capture_s=build_s)


def import_llama(torch, np, card):
    """(c) the Llama-3-8B-width HF state dict: bf16 weights drawn on the
    card, their HF names, imported (f32, as tpulab imports) and served by
    the ragged-plan batcher against the batcher over the f32 tree the
    state dict was made from (the bf16 draw upcast: the checkpoint loses
    nothing).  Returns kernel 1's launches over the imported serve."""
    import gc

    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.models.torch_import import llama_params_from_torch
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention

    ra = ragged_paged_attention
    n_layers = IMPORT["llama_layers"]
    t0 = time.perf_counter()
    src = full_width_params(torch, n_layers, torch.bfloat16, seed=17)
    sd = hf_llama_sd(src, n_layers)
    ref_tree = tree_cast(src, torch.float32)
    del src
    t1 = time.perf_counter()
    params = llama_params_from_torch(sd)
    import_s = time.perf_counter() - t1
    del sd
    gc.collect()
    leaves = trees_equal(torch, ref_tree, params)
    kw = dict(shard_kw(torch), n_layers=n_layers)
    specs = shard_specs(np)
    streams, steps, launches, bodies, wall = {}, 0, 0, {}, {}
    for label, tree in (("source", ref_tree), ("imported", params)):
        cb = ContinuousBatcher(tree, **kw)
        try:
            shard_warm(cb)
            if label == "imported":
                ra.launches = 0
                ra.launches_by_body = dict.fromkeys(ra.launches_by_body, 0)
                steps0 = cb.forward_steps
            t2 = time.perf_counter()
            streams[label] = shard_serve(cb, specs)
            wall[label] = time.perf_counter() - t2
            if label == "imported":
                steps = cb.forward_steps - steps0
                launches = ra.launches
                bodies = dict(ra.launches_by_body)
        finally:
            cb.shutdown()
    if streams["imported"] != streams["source"]:
        bad = [n for n in streams["source"]
               if streams["imported"][n] != streams["source"][n]]
        raise AssertionError(f"import: the imported Llama's streams {bad} "
                             "differ from the source tree's")
    if launches != n_layers * steps or launches == 0:
        raise AssertionError(f"import: kernel 1 launches {launches} != "
                             f"{n_layers} x {steps} forward steps")
    toks = sum(len(s) for s in streams["imported"].values())
    log(f"import: (c) HF Llama-3-8B-width state dict (bf16, {n_layers} of "
        f"32 layers) -> llama_params_from_torch on the card in "
        f"{import_s:.2f} s ({leaves} f32 leaves, each equal bit for bit to "
        f"the source tree's); the ragged batcher ({len(specs)} requests, "
        f"prompts {list(SHARD_PROMPTS)} x {SHARD_STEPS} steps, even greedy, "
        f"odd device-sampled): streams bit-identical to the source tree's; "
        f"{toks} tokens in {wall['imported']:.2f} s against "
        f"{wall['source']:.2f} s; kernel 1 launches {launches} == "
        f"{n_layers} x {steps} forward steps ({bodies}); set-up "
        f"{t1 - t0:.2f} s [{card}]")
    del params, ref_tree
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_import(torch, card):
    """Bring-your-own-model at full width (module docstring, phase 16).
    Returns kernel 1's launches over (c)'s imported serve."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    import tpulab_torch
    from tpulab_torch.engine.runtime import tree_to
    from tpulab_torch.models import build_model
    from tpulab_torch.models.convert import tree_from_numpy
    from tpulab_torch.models.onnx_import import load_onnx_model
    from tpulab_torch.models.quantization import (calibrate_resnet,
                                                  quantize_resnet_params_w8a8,
                                                  quantized_bytes)
    from tpulab_torch.models.resnet import init_resnet_params, make_resnet
    from tpulab_torch.models.torch_import import (make_resnet_from_torch,
                                                  make_vit_from_hf)
    from tpulab_torch.engine.infer_bench import InferBench

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_onnx_util

    torch.backends.cudnn.benchmark = False
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="import-")
    mbs = IMPORT["max_batch_size"]
    out = {}
    mgr = tpulab_torch.InferenceManager(max_exec_concurrency=4)
    try:
        # (a) ONNX ResNet-50, 224 x 224, 1000 classes, f32, NCHW
        t0 = time.perf_counter()
        data, folded = torch_onnx_util.resnet50_graph(IMPORT["seed"], 1000,
                                                      224)
        path = os.path.join(tmp, "resnet50.onnx")
        with open(path, "wb") as f:
            f.write(data)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        onnx_m = load_onnx_model(path, name="rn50_onnx", max_batch_size=mbs)
        load_s = time.perf_counter() - t0
        onnx_q = load_onnx_model(path, name="rn50_onnx_int8",
                                 max_batch_size=mbs, weight_quant="int8")
        log(f"import: (a) ResNet-50 as ONNX ({len(data) / 1e6:.1f} MB, "
            f"written in {gen_s:.2f} s) -> load_onnx_model in {load_s:.2f} s "
            f"(parse, a batch-1 CPU forward for the output specs, params to "
            f"the card): inputs {[(s.name, s.shape) for s in onnx_m.inputs]}"
            f", outputs {[(s.name, s.shape) for s in onnx_m.outputs]}; "
            f"weights {onnx_m.weights_size_in_bytes()} bytes f32, "
            f"{onnx_q.weights_size_in_bytes()} int8 [{card}]")
        # (b) the registry's W8 and the W8A8 calibrated from the f32 tree
        w8 = build_model("resnet50_int8", max_batch_size=mbs)
        f32_tree = init_resnet_params(50, seed=0)    # the registry's draw
        t0 = time.perf_counter()
        calib = [card_images(torch, IMPORT["calib_batch"], 500 + i)
                 for i in range(IMPORT["calib_batches"])]
        ranges = calibrate_resnet(f32_tree, calib)
        q8a8 = quantize_resnet_params_w8a8(f32_tree, ranges)
        calib_s = time.perf_counter() - t0
        w8a8 = make_resnet(50, max_batch_size=mbs, params=q8a8).renamed(
            "rn50_w8a8")
        bf16 = make_resnet(50, max_batch_size=mbs, params=f32_tree)
        # (c) torchvision ResNet-50 and HF ViT-B/16 through the importers
        tv = make_resnet_from_torch(
            tv_resnet50_sd(torch, 18), max_batch_size=IMPORT[
                "tv_vit_max_batch"], input_dtype=np.uint8)
        vit = make_vit_from_hf(hf_vit_b16_sd(torch, 19), image_size=224,
                               patch_size=16, n_heads=12,
                               max_batch_size=IMPORT["tv_vit_max_batch"],
                               input_dtype=np.uint8)
        t0 = time.perf_counter()
        for name, model in (("rn50_onnx", onnx_m),
                            ("rn50_onnx_int8", onnx_q),
                            ("rn50_w8", w8), ("rn50_w8a8", w8a8),
                            ("rn50_bf16", bf16), ("rn50_tv", tv),
                            ("vit_hf", vit)):
            mgr.register_model(name, model)
        reg_s = time.perf_counter() - t0
        # the engine artifact of the f32 ONNX model (its weights, the
        # buckets of IMPORT["plan_buckets"]), registered back
        plan = os.path.join(tmp, "rn50_onnx.engine")
        t0 = time.perf_counter()
        rt = tpulab_torch.engine.Runtime()
        view = tpulab_torch.engine.Model(
            "rn50_onnx", onnx_m.apply_fn, onnx_m.params, onnx_m.inputs,
            onnx_m.outputs, mbs, list(IMPORT["plan_buckets"]))
        rt.save_engine(rt.compile_model(view), plan)
        save_s = time.perf_counter() - t0
        plan_bytes = sum(os.path.getsize(os.path.join(plan, f))
                         for f in os.listdir(plan))
        # when each file landed (its mtime), seconds from the first
        marks = sorted((os.path.getmtime(os.path.join(plan, f)), f)
                       for f in os.listdir(plan))
        log("import: artifact files written at " + ", ".join(
            f"{f} +{t - marks[0][0]:.2f} s" for t, f in marks)
            + f" [{card}]")
        t0 = time.perf_counter()
        mgr.register_engine("rn50_plan", plan)
        reload_s = time.perf_counter() - t0
        mgr.update_resources()
        ma = mgr.compiled("rn50_onnx").memory_analysis(mbs)
        log(f"import: registered 8 models in {reg_s:.1f} s (every bucket "
            f"run once); engine artifact saved in {save_s:.2f} s "
            f"({plan_bytes / 1e6:.1f} MB: {sorted(os.listdir(plan))}), "
            f"loaded with no apply_fn and registered in {reload_s:.2f} s; "
            f"memory_analysis(rn50_onnx, {mbs}): argument "
            f"{ma.argument_size_in_bytes}, output "
            f"{ma.output_size_in_bytes}, temp {ma.temp_size_in_bytes} "
            f"bytes [{card}]")

        # (a) checks: the native ResNet-50 on the folded weights, the CPU
        x_nchw = card_images(torch, 4, 21, nchw=True)
        x_nhwc = x_nchw.permute(0, 2, 3, 1).contiguous()
        onnx_out = runner_rows(torch, mgr, "rn50_onnx", x_nchw[:3])
        native = make_resnet(50, compute_dtype=torch.float32,
                             params=tree_from_numpy(folded, "cuda"))
        with torch.inference_mode():
            nat = native.apply_fn(native.params, {"input": x_nhwc[:3]})[
                "logits"]
            cpu = onnx_m.apply_fn(tree_to(onnx_m.params, "cpu"),
                                  {"input": x_nchw[:2].cpu()})["logits"]
        st = out["onnx"] = {}
        st["vs_native"] = logit_check(torch, "rn50_onnx (f32) vs native "
                                      "ResNet-50 f32 on the folded weights",
                                      onnx_out, nat, INFER_F32_TOL)
        st["vs_cpu"] = logit_check(torch, "rn50_onnx card vs its CPU run",
                                   onnx_out[:2], cpu, INFER_F32_TOL)
        q_out = runner_rows(torch, mgr, "rn50_onnx_int8", x_nchw[:3])
        st["int8_vs_f32"] = logit_check(torch, "rn50_onnx_int8 vs f32",
                                        q_out, onnx_out, IMPORT_W8_TOL)
        st["int8_corr"] = corr(torch, q_out, onnx_out)
        x_plan = card_images(torch, IMPORT["plan_buckets"][0], 23,
                             nchw=True)
        if not torch.equal(runner_rows(torch, mgr, "rn50_plan", x_plan),
                           runner_rows(torch, mgr, "rn50_onnx", x_plan)):
            raise AssertionError("import: the loaded artifact's logits "
                                 "differ from the in-memory model's")
        for b in IMPORT["plan_buckets"]:
            xb = card_images(torch, b, 40 + b, nchw=True)
            with torch.inference_mode():
                want = mgr.compiled("rn50_onnx")(b, {"input": xb})["logits"]
                got = mgr.compiled("rn50_plan")(b, {"input": xb})["logits"]
            if not torch.equal(got, want):
                raise AssertionError(f"import: artifact bucket {b} differs")
        log(f"import: (a) the artifact (no apply_fn, bucket programs "
            f"from torch.export) bit-identical to the in-memory model "
            f"through the runner (batch {len(x_plan)}) and at buckets "
            f"{list(IMPORT['plan_buckets'])}; int8 weights: correlation "
            f"{st['int8_corr']:.5f} [{card}]")

        # (b) W8 / W8A8 against the f32 forward of the same draw
        f32_model = make_resnet(50, compute_dtype=torch.float32,
                                params=f32_tree)
        x8 = card_images(torch, IMPORT["ws_bucket"], 22)
        with torch.inference_mode():
            ref = f32_model.apply_fn(f32_tree, {"input": x8})["logits"]
        sb = out["int8"] = {}
        for name, rule in (("rn50_w8", IMPORT_W8_CORR),
                           ("rn50_w8a8", IMPORT_W8A8_CORR)):
            got = runner_rows(torch, mgr, name, x8)
            c = corr(torch, got, ref)
            rel = float((got - ref.cpu()).abs().max()
                        / ref.abs().max().cpu())
            top1 = float((got.argmax(-1) == ref.cpu().argmax(-1))
                         .float().mean())
            if c <= rule or not torch.isfinite(got).all():
                raise AssertionError(f"import: {name} correlation {c:.4f} "
                                     f"<= {rule}")
            if name == "rn50_w8":
                logit_check(torch, f"{name} vs f32", got, ref,
                            IMPORT_W8_TOL, quiet=True)
            sb[name] = dict(corr=c, rel_err=rel, top1=top1)
            log(f"import: (b) {name} (bf16 compute) vs the f32 forward of "
                f"the same draw, batch {len(x8)}: correlation {c:.5f} (> {rule}), "
                f"max abs err {rel:.4f} x max |logit|, top-1 equal on "
                f"{top1:.3f} of rows [{card}]")
        sb["int32"] = import_int32_check(torch, q8a8, {
            "stem": (3, 224, 2), "s2b0/conv2": (256, 28, 2),
            "s3b2/conv3": (512, 7, 1)})
        sb["w8a8_bytes"] = quantized_bytes(q8a8)
        sb["calib_s"] = calib_s
        log(f"import: (b) W8A8 int32 accumulators on the card "
            f"(torch._int_mm) == the CPU's int64 products, bit for bit: "
            f"{sb['int32']}; calibration over {len(calib)} x "
            f"{IMPORT['calib_batch']} images in {calib_s:.2f} s; weights "
            f"{w8.weights_size_in_bytes()} (W8) / {sb['w8a8_bytes']} "
            f"(W8A8) bytes against {bf16.weights_size_in_bytes()} f32 "
            f"[{card}]")
        sb["workspace"] = {n: import_workspace(torch, mgr, n, card)
                           for n in ("rn50_w8a8", "rn50_w8")}

        # (c) the torchvision ResNet-50 and the HF ViT-B/16
        for name in ("rn50_tv", "vit_hf"):
            e32, e16 = infer_cpu_checks(torch, np, mgr, name,
                                        mgr.compiled(name).model)
            arr = infer_images(np, 3, 12)
            runner_rows(torch, mgr, name, torch.from_numpy(arr).cuda())
            out[name] = dict(f32_vs_cpu=e32, bf16_vs_f32=e16)

        # images/s at batch 32 (InferBench, f32 NCHW / NHWC inputs)
        bench = InferBench(mgr)
        out["images_s"] = {}
        for name in ("rn50_bf16", "rn50_onnx", "rn50_onnx_int8", "rn50_w8",
                     "rn50_w8a8", "rn50_plan"):
            r = bench.run(name, batch_size=IMPORT["bench_batch"],
                          seconds=IMPORT["bench_s"], warmup=4)
            out["images_s"][name] = r["inferences_per_second"]
            log(f"import: {name} batch {IMPORT['bench_batch']}: "
                f"{r['inferences_per_second']:.1f} images/s "
                f"({r['execution_time_per_batch_ms']:.3f} ms/batch, "
                f"{int(r['batches_computed'])} batches) [{card}]")
        out["save_s"], out["load_s"] = save_s, reload_s
    finally:
        mgr.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    launches = import_llama(torch, np, card)
    log("import: " + json.dumps(out))
    log(f"import: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


# ---------------------------------------------------------------- phase 7
# The HBM economy: the Llama-3-8B-width batcher (ragged plan, lanes 8,
# max_len 2048, page 16) as the arbiter's KV tenant over an elastic pool
# whose base is tpulab's small share, one request's pages plus the
# scratch page (2048 / 16 + 1 = 129 pages of 2,097,152 bytes), so the
# size ladder is 129 / 258 / 516 / 1032; ResNet-50 and ViT-B/16 (phase 6's
# models) and the LLM's tree (pinned) as the weights tenant of a
# WeightMultiplexer; a host KV tier of 2 GiB.
HBM_BASE_PAGES = 129
HBM_RUNGS = 3
HBM_SERVE = dict(SERVE, n_pages=HBM_BASE_PAGES)
HBM_KV_OFFLOAD = 2 << 30
# the burst: the first 8 (one a lane) hold more than half the top rung
# (578 prompt pages), so a squeeze to 516 pages must demote live lanes
HBM_BURST = (1500, 1400, 1300, 1200, 1100, 1000, 900, 800, 700, 500, 400,
             300)
HBM_STEPS = 32
HBM_INFER_BATCH = 8
# the scratch warm-up: one request a mixed-round width (a prompt of n
# tokens rides a round of width pow2(n): 1 ... 256) and a decode-block
# size (steps 2 / 3 / 5 / 9 end on a block of 1 / 2 / 4 / 8), run alone:
# every (program, shape key) the burst can reach is measured before it
HBM_WARM = tuple(zip((1, 2, 3, 5, 9, 17, 33, 65, 129),
                     (2, 3, 5, 9, 2, 3, 5, 9, 9)))


def hbm_programs(cb):
    """The batcher's scratch-measured programs."""
    return {n: getattr(cb, n) for n in (
        "_mixed_step", "_decode_block", "_decode_step", "_prefill",
        "_extend")}


def leaf_sums(torch, tree, prefix=""):
    """Per-leaf checksums of a weight tree: the sum of the leaf's 16-bit
    words and their sum weighted by position (mod 65521), over int64."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_sums(torch, v, f"{prefix}{k}/"))
            continue
        w = v.reshape(-1).view(torch.int16)
        s1 = s2 = 0
        for i, chunk in enumerate(w.split(1 << 26)):
            x = chunk.to(torch.int64)
            pos = (torch.arange(x.numel(), device=x.device)
                   + i * (1 << 26)) % 65521 + 1
            s1 += int(x.sum())
            s2 += int((x * pos).sum())
        out[prefix + k] = (s1, s2)
    return out


def sampled_scores(torch, dense, sampling, first_pos):
    """Per step, the scores a pick compares and how far the bf16 noise
    may move them: greedy — the logits; device sampling — logits / T + the
    (seed, position) Gumbel draw (:func:`pick_margin`'s), the noise / T.
    Step ``j`` is the pick after position ``first_pos + j``."""
    from tpulab_torch.engine.prng import fold_in, gumbel, prng_key

    if sampling is None or sampling.temperature <= 0:
        return dense, 1.0
    seed, rows = sampling.seed, []
    for j in range(dense.shape[0]):
        key = prng_key(0, dense.device, (1,))
        for word in (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
                     first_pos + j):
            key = fold_in(key, torch.tensor([word], device=dense.device))
        rows.append(dense[j] / sampling.temperature
                    + gumbel(key, dense.shape[-1])[0])
    return torch.stack(rows), 1.0 / sampling.temperature


def host_picks_within_bf16_noise(torch, dense, noise, stream, start,
                                 sampling):
    """Host sampling: the port's ``SamplingParams.pick`` draws one uniform
    per pick from ``default_rng(seed)`` and takes the first token whose
    cumulative softmax(logits / T) passes it.  Logits moved by at most
    ``d`` move every cumulative probability by at most ``expm1(2 d / T)``,
    so with ``d`` twice the bf16 path noise the pick must lie in the
    replayed cumulative interval widened by that much.  Returns the
    largest widening used over the interval's distance to the draw."""
    import numpy as np

    if sampling.top_k or 0.0 < sampling.top_p < 1.0:
        raise ValueError("the host-sampling noise rule covers plain "
                         "temperature sampling")
    rng = np.random.default_rng(sampling.seed)
    worst, bad = 0.0, []
    for j, tok in enumerate(stream):
        u = rng.random()
        if j < start:
            continue
        z = dense[j].double().cpu().numpy() / sampling.temperature
        p = np.exp(z - z.max())
        cdf = np.cumsum(p / p.sum())
        lo = cdf[tok - 1] if tok else 0.0
        eps = math.expm1(2 * 2 * float(noise[j]) / sampling.temperature)
        miss = max(lo - u, u - cdf[tok], 0.0)
        if miss > eps:
            bad.append((j, miss, eps))
        worst = max(worst, miss / max(eps, 1e-30))
    return bad, worst


def picks_within_bf16_noise(torch, params, kw, label, prompt, stream,
                            start, sampling=None):
    """Hold every pick of ``stream`` from step ``start`` on against a
    teacher-forced replay of its own prefix: at each step the pick's dense
    logit lies within twice that position's bf16 path noise of the dense
    top logit.  The noise is the largest distance one logit moves between
    two bf16 computations of the same prefix (the dense forward and one
    ragged forward over a fresh pool), so twice it is the most two such
    computations can move a pair of logits apart.  One forward each way
    replays every step.  With ``sampling`` (a ``SamplingParams``) the
    scores are the sampler's (:func:`sampled_scores`, and for host
    sampling :func:`host_picks_within_bf16_noise`).  Returns the largest
    gap / noise ratio."""
    import numpy as np

    n = len(stream)
    seq = np.concatenate([prompt, np.asarray(stream[:-1], np.int32)])[None]
    dense = replay_logits(torch, params, kw, seq, None, tail=n).float()
    paged = replay_logits(torch, params, kw, seq, torch.bfloat16,
                          tail=n).float()
    noise = (dense - paged).abs().amax(-1)
    if sampling is not None and sampling.temperature > 0 \
            and not sampling.device:
        bad, worst = host_picks_within_bf16_noise(torch, dense, noise,
                                                  stream, start, sampling)
        if bad:
            raise AssertionError(f"{label}: host picks (step, distance, "
                                 f"allowed) {bad} outside the bf16 noise")
        return worst
    scores, scale = sampled_scores(torch, dense, sampling, len(prompt) - 1)
    noise = noise * scale
    picks = torch.tensor(stream, device=dense.device)
    gap = scores.amax(-1) - scores.gather(1, picks[:, None])[:, 0]
    bad = [(j, float(gap[j]), float(noise[j])) for j in range(start, n)
           if gap[j] > 2 * noise[j]]
    if bad:
        raise AssertionError(f"{label}: picks (step, gap, noise) {bad} lie "
                             "over twice the bf16 path noise below the "
                             "dense top logit")
    return float((gap[start:] / noise[start:].clamp_min(1e-30)).max())


def same_or_bf16_noise(torch, params, kw, label, prompt, want, got,
                       sampling=None):
    """``got`` equals ``want``; or, from the first step where they differ,
    every pick of both streams passes :func:`picks_within_bf16_noise`
    (under ``sampling``'s scores).  Returns a note for the log."""
    if got == want:
        return None
    n = min(len(want), len(got))
    i = next((j for j in range(n) if want[j] != got[j]), n)
    if i == n:
        raise AssertionError(f"{label}: lengths {len(want)} != {len(got)}")
    r = max(picks_within_bf16_noise(torch, params, kw, label, prompt, x, i,
                                    sampling)
            for x in (want, got))
    return (f"{label} differs from step {i}, every pick from there on "
            f"within {r:.2f} x the bf16 path noise of the dense top")


class PageBytesCheck:
    """Holds the KV pages' bytes across the elastic pool's moves, byte
    for byte, on host copies (page-by-page runs, each layer's run one
    contiguous copy: no device temporaries): a lane's live pages as it is
    demoted to the host tier against the same pages after its restore,
    and every page in use across each grow and shrink.  Wraps the
    batcher's host tier and pool in place; ``resized(op, k)`` is called
    as each resize returns, with its result.  Mismatches are collected, not
    raised (a raise on the scheduler thread would go to its recovery
    path); ``seconds`` is the time the copies took on that thread."""

    def __init__(self, torch, cb, resized=None):
        self.torch = torch
        self.snaps, self.bad = {}, []
        self.restores = self.resizes = self.nbytes = 0
        self.seconds = 0.0
        kvt, pool = cb.kv_offload, cb.pool
        swap_out, restore, discard = kvt.swap_out, kvt.restore, kvt.discard

        def checked_swap_out(pages, length, kv, key=None):
            t0 = time.perf_counter()
            snap = self.copy(kv, pages)
            self.seconds += time.perf_counter() - t0
            handle = swap_out(pages, length, kv, key)
            if handle is not None:
                self.snaps[handle.key] = (list(pages), snap)
            return handle

        def checked_restore(handle, pages, kv):
            out = restore(handle, pages, kv)
            want = self.snaps.pop(handle.key, None)
            if out is not None and want is not None:
                t0 = time.perf_counter()
                if not self.torch.equal(self.copy(out, pages), want[1]):
                    self.bad.append(("restore", handle.key, want[0], pages))
                self.seconds += time.perf_counter() - t0
                self.restores += 1
            return out

        def checked_discard(handle):
            self.snaps.pop(handle.key, None)
            return discard(handle)

        kvt.swap_out, kvt.restore = checked_swap_out, checked_restore
        kvt.discard = checked_discard
        for op in ("grow", "shrink"):
            fn = getattr(pool, op)

            def checked_resize(n, fn=fn, op=op):
                t0 = time.perf_counter()
                with pool._lock:
                    used = sorted(set(range(1, pool.n_pages))
                                  - set(pool._free))
                before = self.copy(pool.kv, used)
                self.seconds += time.perf_counter() - t0
                k = fn(n)
                if resized is not None:
                    resized(op, k)
                t0 = time.perf_counter()
                if not self.torch.equal(self.copy(pool.kv, used), before):
                    self.bad.append((op, n, k, len(used)))
                self.seconds += time.perf_counter() - t0
                self.resizes += bool(k)
                return k
            setattr(pool, op, checked_resize)

    def copy(self, kv, pages):
        """The bytes of ``pages`` (in that order), (L, len(pages), ...) on
        the host."""
        raw = kv.view(self.torch.uint8)
        out = self.torch.empty((raw.shape[0], len(pages)) + raw.shape[2:],
                               dtype=self.torch.uint8)
        i = 0
        while i < len(pages):
            j = i + 1
            while j < len(pages) and pages[j] == pages[j - 1] + 1:
                j += 1
            for layer in range(raw.shape[0]):
                out[layer, i:j].copy_(raw[layer, pages[i]:pages[j - 1] + 1])
            i = j
        self.nbytes += out.numel()
        return out


class SwapMetrics:
    """The multiplexer's swap observer: (direction, seconds, bytes, the
    CUDA allocator's live bytes as the swap settles).  A swap-out settles
    after the transfer engine has dropped the device tree, so its reading
    shows the freed memory."""

    def __init__(self, torch):
        self.torch, self.swaps = torch, []

    def observe_swap_in(self, s, nbytes):
        self.swaps.append(("in", s, nbytes,
                           self.torch.cuda.memory_allocated()))

    def observe_swap_out(self, s, nbytes):
        self.swaps.append(("out", s, nbytes,
                           self.torch.cuda.memory_allocated()))


def hbm_burst(torch, cb, prompts, steps, on_first=None):
    """Submit the burst at once, each request streaming (its index-0 token
    counted; ``on_first(n)`` called on the scheduler thread with the
    count); returns the streams."""
    first = []

    def hook(tok, i):
        if i == 0:
            first.append(tok)
            if on_first is not None:
                on_first(len(first))

    with cb._cv:
        futs = [cb.submit(p, steps, on_token=hook) for p in prompts]
    return [[int(t) for t in f.result(timeout=900)] for f in futs]


def phase_hbm(torch, card):
    """The HBM economy and multi-model weight multiplexing at full width:
    ``ContinuousBatcher(hbm=HBMArbiter(...))`` as the KV tenant, a
    ``WeightMultiplexer(hbm=...)`` over ResNet-50, ViT-B/16 and the
    (pinned) LLM tree as the weights tenant; then the LLM tree swapped
    through a ``BatcherAdapter`` to a pinned ``HostParamStore`` and back.
    Returns kernel 1's launches over the burst."""
    import threading

    import numpy as np

    import tpulab_torch
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.hbm import (KV_TENANT, SCRATCH_TENANT, WEIGHTS_TENANT,
                                  HBMArbiter)
    from tpulab_torch.models import build_model
    from tpulab_torch.modelstore import (BatcherAdapter, CompiledModelAdapter,
                                         HostParamStore, WeightMultiplexer,
                                         tree_nbytes)
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention

    c = LLAMA3_8B
    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = False     # the same kernels each call
    torch.cuda.empty_cache()    # the earlier phases' cached blocks, once,
    #                             before anything here is measured
    kw = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.bfloat16)
    params = full_width_params(torch, c["n_layers"], torch.bfloat16, seed=0)
    llm_bytes = tree_nbytes(params)

    # the weights tenant's compiled models; their raw trees are drawn on
    # the CPU and dropped (the adapters redraw them for a cold rebuild)
    mgr = tpulab_torch.InferenceManager(
        max_exec_concurrency=INFER["concurrency"])
    redraw = {}
    for name, entry in INFER_MODELS:
        def draw(entry=entry):
            return build_model(entry, max_batch_size=INFER["max_batch_size"],
                               input_dtype=np.uint8, device="cpu")
        redraw[name] = draw
        mgr.register_model(name, draw())
    mgr.update_resources()
    vis = [name for name, _ in INFER_MODELS]
    vis_bytes = {n: tree_nbytes(mgr.compiled(n).device_params) for n in vis}
    xs = {n: infer_images(np, HBM_INFER_BATCH, 700 + i)
          for i, n in enumerate(vis)}

    def infer(name):
        return mgr.infer_runner(name).infer(input=xs[name]).result(
            120)["logits"]

    ref_out = {n: infer(n) for n in vis}        # no multiplexer
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in HBM_BURST]
    top = HBM_BASE_PAGES << HBM_RUNGS

    # the reference: no arbiter, a fixed full-size pool (the top rung);
    # run twice, the second time in reverse order on a fresh batcher
    refs = []
    for order in (1, -1):
        t0 = time.perf_counter()
        ref_cb = ContinuousBatcher(params, device="cuda",
                                   **dict(HBM_SERVE, n_pages=top), **kw)
        try:
            refs.append(hbm_burst(torch, ref_cb, prompts[::order],
                                  HBM_STEPS)[::order])
        finally:
            ref_cb.shutdown()
        del ref_cb
        log(f"hbm: reference burst (no arbiter, fixed {top}-page pool"
            f"{', reverse order' if order < 0 else ''}): {len(prompts)} "
            f"requests x {HBM_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s")
    ref, ref_rev = refs

    # the KV tenant; the capacity is set once the warm-up has measured
    # the programs' scratch
    arb = HBMArbiter(1 << 50)
    cb = ContinuousBatcher(params, device="cuda", kv_offload=HBM_KV_OFFLOAD,
                           hbm=arb, **HBM_SERVE, **kw)
    del params                  # the batcher holds the only reference
    mux = None
    try:
        pn = cb.pool.page_nbytes
        t0 = time.perf_counter()
        for n, steps in HBM_WARM:
            cb.submit(rng.integers(0, c["vocab"], (n,)).astype(np.int32),
                      steps).result(timeout=300)
        progs = hbm_programs(cb)
        keys = {k: len(p.keys) for k, p in progs.items()}
        scratch = arb.ledger.tenant_bytes(SCRATCH_TENANT)
        claims = [(tag, b) for t, tag, b in arb.ledger.claims()
                  if t == SCRATCH_TENANT]
        table = cb.scratch.table
        # the batcher's programs run one at a time: ONE claim, the
        # largest (program, shape key)'s, every key still measured
        if (claims != [(cb.scratch.tag, max(table.values()))]
                or len(table) != sum(keys.values())
                or not all(b > 0 for b in table.values())):
            raise AssertionError(f"hbm: scratch claims {claims} for "
                                 f"{keys} keys, bytes "
                                 f"{sorted(table.values())}")
        log(f"hbm: scratch warm-up {time.perf_counter() - t0:.1f} s: "
            f"{len(table)} (program, shape key) measurements {keys} (min "
            f"{min(table.values())}, max {max(table.values())}, sum "
            f"{sum(table.values())} bytes); the group claims the largest, "
            f"{scratch} bytes [{card}]")
        # tpulab's bench rule (LLM weights + the top rung + half a page),
        # plus the scratch just claimed: without it the claim would leave
        # no headroom at all; the vision weights and the top rung still
        # never fit together
        capacity = llm_bytes + top * pn + pn // 2 + scratch
        if capacity - llm_bytes - scratch >= top * pn + sum(vis_bytes.values()):
            raise AssertionError("hbm: the vision weights and the top rung "
                                 "fit together")
        arb.ledger.capacity_bytes = capacity
        mux = WeightMultiplexer(llm_bytes + sum(vis_bytes.values()),
                                hbm=arb,
                                host_budget_bytes=2 * sum(vis_bytes.values()))
        mux.register("llm", BatcherAdapter(cb), pinned=True)
        for n in vis:
            mux.register(n, CompiledModelAdapter(mgr.compiled(n),
                                                 redraw[n]))
        log(f"hbm: capacity {capacity} bytes = LLM {llm_bytes} + top rung "
            f"{top} x {pn} + half a page + scratch {scratch}; vision "
            + ", ".join(f"{n} {b}" for n, b in vis_bytes.items())
            + f"; base pool {cb.pool.n_pages} pages ({cb.pool.hbm_bytes} "
            f"bytes), ladder {[HBM_BASE_PAGES << r for r in range(4)]}")

        steps_log = []

        def snap(label):
            torch.cuda.synchronize()
            bad = arb.verify()
            led = arb.ledger
            row = dict(step=label, claimed=led.total_claimed,
                       kv=led.tenant_bytes(KV_TENANT),
                       weights=led.tenant_bytes(WEIGHTS_TENANT),
                       scratch=led.tenant_bytes(SCRATCH_TENANT),
                       free=arb.free_hbm_bytes,
                       allocated=torch.cuda.memory_allocated(),
                       reserved=torch.cuda.memory_reserved(),
                       pool_pages=cb.pool.n_pages,
                       hot=mux.resident_models())
            steps_log.append(row)
            log(f"hbm: {label}: ledger {row['claimed']} (kv {row['kv']}, "
                f"weights {row['weights']}, scratch {row['scratch']}), free "
                f"{row['free']}; memory_allocated {row['allocated']}, "
                f"memory_reserved {row['reserved']}, allocated minus kv + "
                f"weights {row['allocated'] - row['kv'] - row['weights']}; "
                f"pool {row['pool_pages']} pages; hot {row['hot']}")
            if bad or row["free"] < 0:
                raise AssertionError(f"hbm: {label}: verify {bad}, free "
                                     f"{row['free']}")

        def check_out(name, got, when):
            if not torch.equal(torch.as_tensor(got),
                               torch.as_tensor(ref_out[name])):
                raise AssertionError(f"hbm: {name} Infer {when} is not "
                                     "bit-identical to the unmultiplexed "
                                     "serve")

        def leased_infer(name, timing):
            t1 = time.perf_counter()
            with mux.acquire(name, timeout=300):
                timing[name] = time.perf_counter() - t1
                return infer(name)

        snap("registered")
        acq = {}
        check_out("vit_b16", leased_infer("vit_b16", acq), "(step 1)")
        snap(f"1. ViT-B/16 Infer, batch {HBM_INFER_BATCH} (acquire "
             f"{acq['vit_b16'] * 1e3:.1f} ms)")

        # 2-3. the burst; both Infers once every lane has its first token
        trigger = threading.Event()
        events = []
        t_burst = [0.0]

        def lanes_now():
            return [(x["state"], x["pages"]) for x in
                    cb.debug_state()["lanes"] if x["state"] != "idle"]

        pages_held = PageBytesCheck(
            torch, cb, lambda op, k: events.append(
                (time.perf_counter() - t_burst[0], op, k, cb.pool.n_pages)))
        ragged_paged_attention.launches = 0
        ragged_paged_attention.launches_by_body = dict.fromkeys(
            ragged_paged_attention.launches_by_body, 0)
        kvt = cb.kv_offload
        before = dict(fs=cb.forward_steps, fills=cb.prompt_fills,
                      grows=cb.hbm_grows, shrinks=cb.hbm_shrinks,
                      demotions=cb.hbm_demotions, swap_ins=kvt.swap_ins,
                      swap_outs=kvt.swap_outs, evictions=mux.evictions,
                      denials=arb.denials)
        mid, outs = {}, {}

        def mid_burst():
            trigger.wait(600)
            events.append((time.perf_counter() - t_burst[0], "trigger",
                           lanes_now(), cb.pool.n_pages))
            threads = [threading.Thread(
                target=lambda n=n: outs.__setitem__(n, leased_infer(n, mid)))
                for n in vis]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            events.append((time.perf_counter() - t_burst[0], "leased",
                           lanes_now(), cb.pool.n_pages))

        def on_first(n):
            # on the scheduler thread: once every lane has its first
            # token, start the Infers and hold this tick until the
            # arbiter has pressed the KV tenant, so the squeeze finds the
            # lanes as they are now (the top half of the pool live)
            if n != cb.lanes:
                return
            pressed = arb.demotions_forced
            trigger.set()
            end = time.monotonic() + 30
            while (arb.demotions_forced == pressed
                   and time.monotonic() < end):
                time.sleep(0.001)

        side = threading.Thread(target=mid_burst)
        side.start()
        t0 = t_burst[0] = time.perf_counter()
        try:
            got = hbm_burst(torch, cb, prompts, HBM_STEPS, on_first)
        finally:
            trigger.set()           # a failed burst must not strand it
        wall = time.perf_counter() - t0
        side.join(600)
        launches = ragged_paged_attention.launches
        by_body = dict(ragged_paged_attention.launches_by_body)
        fs = cb.forward_steps - before["fs"]
        for n in vis:
            if n not in outs:
                raise AssertionError(f"hbm: the mid-burst {n} Infer failed")
            check_out(n, outs[n], "(mid-burst)")
        log("hbm: burst timeline (s from submit): " + "; ".join(
            f"{t:.3f} {what} {x} -> {n} pages" for t, what, x, n in events)
            + f"; the page-byte checks' host copies took "
            f"{pages_held.seconds:.3f} s of the scheduler thread")
        snap(f"2-3. burst of {len(prompts)} x {HBM_STEPS} in {wall:.2f} s, "
             "ViT-B/16 and ResNet-50 Infers mid-burst (acquire "
             + ", ".join(f"{n} {s * 1e3:.1f} ms" for n, s in mid.items())
             + ")")
        after = {}
        for n in vis:
            check_out(n, leased_infer(n, after), "(after the burst)")
        if not mux.drain(120) or not cb.kv_offload.drain(120):
            raise AssertionError("hbm: write-behind swaps did not settle")
        snap("4. both Infers after the burst (acquire " + ", ".join(
            f"{n} {s * 1e3:.1f} ms" for n, s in after.items()) + ")")

        # the checks
        new_keys = {k: len(p.keys) - keys[k] for k, p in progs.items()}
        d = dict(fills=cb.prompt_fills - before["fills"],
                 grows=cb.hbm_grows - before["grows"],
                 shrinks=cb.hbm_shrinks - before["shrinks"],
                 demotions=cb.hbm_demotions - before["demotions"],
                 snapshots=kvt.swap_outs - before["swap_outs"],
                 resumes=kvt.swap_ins - before["swap_ins"],
                 evictions=mux.evictions - before["evictions"],
                 denials=arb.denials - before["denials"])
        log(f"hbm: counters over the trace {d}; arbiter grants "
            f"{arb.grants}, pressure rounds {arb.pressure_events}, forced "
            f"demotions {arb.demotions_forced}, forced evictions "
            f"{arb.evictions_forced}; multiplexer swap-ins {mux.swap_ins} "
            f"({mux.swap_in_bytes} bytes), swap-outs {mux.swap_outs} "
            f"({mux.swap_out_bytes} bytes), cold rebuilds "
            f"{mux.cold_rebuilds}, failures {mux.swap_failures}; kv tier "
            f"swap-outs {cb.kv_offload.swap_outs}, failures "
            f"{cb.kv_offload.swap_failures}, drops {cb.kv_offload.swap_drops}"
            f"; ragged launches {launches} = {c['n_layers']} x {fs} "
            f"forward steps, by body {by_body} [{card}]")
        if not (d["grows"] >= 1 and d["shrinks"] >= 1 and d["demotions"] >= 1
                and mux.evictions >= 1):
            raise AssertionError(f"hbm: the economy did not move: {d}, "
                                 f"evictions {mux.evictions}")
        # a demoted lane resumes from its host-tier snapshot (a lane
        # demoted again before its restore keeps the one snapshot): every
        # snapshot restored, none lost, and no prompt filled twice
        if (d["fills"] != len(prompts) or d["resumes"] != d["snapshots"]
                or d["snapshots"] < 1 or kvt.swap_failures or kvt.swap_drops):
            raise AssertionError(f"hbm: {d['fills']} prompt fills for "
                                 f"{len(prompts)} requests, {d['snapshots']} "
                                 f"host-tier snapshots, {d['resumes']} "
                                 f"restores, failures {kvt.swap_failures}, "
                                 f"drops {kvt.swap_drops}")
        if launches != c["n_layers"] * fs or by_body.get("wgmma") != launches:
            raise AssertionError(f"hbm: ragged launches {launches} vs "
                                 f"{c['n_layers']} x {fs}, by body "
                                 f"{by_body}")
        # the KV bytes across the elastic moves, exactly: every restored
        # lane's pages equal its pages as it was demoted, and every page
        # in use kept its bytes across every grow and shrink
        if (pages_held.bad or pages_held.restores != d["resumes"]
                or pages_held.resizes != d["grows"] + d["shrinks"]):
            raise AssertionError(f"hbm: KV page bytes changed {pages_held.bad}"
                                 f"; restores checked {pages_held.restores} "
                                 f"of {d['resumes']}, resizes checked "
                                 f"{pages_held.resizes} of "
                                 f"{d['grows'] + d['shrinks']}")
        log(f"hbm: KV page bytes held exactly: {pages_held.restores} host-tier"
            f" restores equal their lanes' pages at demotion, every page in "
            f"use equal across {pages_held.resizes} grows and shrinks "
            f"({pages_held.nbytes} bytes copied to the host and compared) "
            f"[{card}]")
        if any(new_keys.values()) or mux.swap_failures or mux.cold_rebuilds:
            raise AssertionError(f"hbm: scratch keys the warm-up missed "
                                 f"{new_keys}, swap failures "
                                 f"{mux.swap_failures}, cold rebuilds "
                                 f"{mux.cold_rebuilds}")
        # the streams: equal to the no-arbiter reference, or, from the
        # first step they differ, every pick of both held to a
        # teacher-forced replay; the reference's own second run (the same
        # burst in reverse order) is held the same way, the witness that
        # the schedule alone moves bf16 picks
        notes = [same_or_bf16_noise(torch, cb.params, kw, f"request {i} "
                                    f"({len(p)} tokens)", p, w, g)
                 for i, (p, w, g) in enumerate(zip(prompts, ref, got))]
        notes = [x for x in notes if x]
        witness = [same_or_bf16_noise(torch, cb.params, kw, f"reference "
                                      f"request {i} reversed", p, w, g)
                   for i, (p, w, g) in enumerate(zip(prompts, ref, ref_rev))]
        witness = [x for x in witness if x]
        log(f"hbm: {len(prompts) - len(notes)}/{len(prompts)} greedy "
            "streams token-identical to the reference (no arbiter, fixed "
            "full-size pool)" + ("; " + "; ".join(notes) if notes else "")
            + f". The reference burst again in reverse order: "
            f"{len(prompts) - len(witness)}/{len(prompts)} streams "
            "identical to its first run"
            + ("; " + "; ".join(witness) if witness else "")
            + f". {sum(g in (w, v) for g, w, v in zip(got, ref, ref_rev))}"
            f"/{len(prompts)} arbiter streams identical to one of the two "
            "reference runs"
            + f". Every Infer bit-identical to the unmultiplexed serve; "
            f"ledger == gauges and free >= 0 after every step [{card}]")

        # the LLM swap: a weights budget that holds the LLM or ViT-B/16,
        # not both, over a pinned host tier
        mux.close()
        mux = None
        probe = rng.integers(0, c["vocab"], (64,)).astype(np.int32)
        want = cb.submit(probe, 16).result(timeout=300)
        sums = leaf_sums(torch, cb.params)
        vit = vis_bytes["vit_b16"]
        obs = SwapMetrics(torch)
        mux = WeightMultiplexer(
            max(llm_bytes, vit) + min(llm_bytes, vit) // 2,
            store=HostParamStore(llm_bytes + 2 * vit),
            metrics=obs)
        mux.register("llm", BatcherAdapter(cb))
        trips = []
        for trip in range(2):
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if trip == 0:   # ViT-B/16 enters hot: the trim evicts the LLM
                mux.register("vit_b16",
                             CompiledModelAdapter(mgr.compiled("vit_b16")))
            else:           # ViT-B/16's acquire evicts it again
                mux.acquire("vit_b16", timeout=300).release()
            if not mux.drain(600):
                raise AssertionError("hbm: the LLM swap-out did not land")
            t_out = time.perf_counter() - t0
            # the live bytes as the LLM's swap-out settled (trip 2's
            # acquire places ViT-B/16 only after that)
            out_s, landed = [(s_, a) for d_, s_, b, a in obs.swaps
                             if d_ == "out" and b == llm_bytes][-1]
            drop = a0 - landed
            if (mux.state_of("llm") != "cold" or cb.params is not None
                    or drop < llm_bytes):
                raise AssertionError(f"hbm: LLM swap-out: state "
                                     f"{mux.state_of('llm')}, "
                                     f"memory_allocated fell {drop} bytes "
                                     f"(tree {llm_bytes})")
            t0 = time.perf_counter()
            lease = mux.acquire("llm", timeout=600)
            t_in = time.perf_counter() - t0
            try:
                again = cb.submit(probe, 16).result(timeout=300)
                ok_sums = leaf_sums(torch, cb.params) == sums
            finally:
                lease.release()
            if again != want or not ok_sums:
                raise AssertionError(f"hbm: after the LLM swap, trip "
                                     f"{trip}: tokens equal {again == want}"
                                     f", leaf checksums equal {ok_sums}")
            in_s = [s_ for d_, s_, b, _ in obs.swaps
                    if d_ == "in" and b == llm_bytes][-1]
            trips.append((t_out, out_s, t_in, in_s, drop))
            log(f"hbm: LLM swap trip {trip + 1}: {llm_bytes} bytes out in "
                f"{out_s:.3f} s landed ({gbps(llm_bytes, out_s):.2f} GB/s; "
                f"{t_out:.3f} s to the drain), memory_allocated fell "
                f"{drop} bytes as it landed; back in {in_s:.3f} s "
                f"({gbps(llm_bytes, in_s):.2f} GB/s, pop + place + sync; "
                f"acquire {t_in:.3f} s incl. ViT-B/16's write-behind "
                f"swap-out); {len(sums)} leaf checksums equal, a greedy "
                f"64-token x 16 request gives the same tokens [{card}]")
    finally:
        if mux is not None:
            mux.close()
        cb.shutdown()
        mgr.shutdown()
    log(f"hbm: " + json.dumps(dict(steps=steps_log, counters=d,
                                   launches=launches, forward_steps=fs,
                                   trips=trips, scratch_claims=len(claims),
                                   scratch_keys=len(table),
                                   scratch_key_sum=sum(table.values()),
                                   scratch_bytes=scratch,
                                   capacity=capacity)))
    log(f"hbm: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 8
# The serving front door: the inference service (build_infer_service,
# through InferenceManager.serve) over phase 6's ResNet-50 and phase 5's
# Llama-3-8B-width ragged batcher as the KV tenant of an HBMArbiter, with
# admission control; driven through the server's own request behaviors
# (serialized requests in, serialized responses out; no socket: the
# script needs no grpc).
SVC_MAX_INFLIGHT = 8
SVC_QUEUE = 2
SVC_PROMPT = 1500
SVC_STEPS = 32
SVC_BURST = (1500, 1400, 1300, 1200, 1100, 1000, 900, 800)
SVC_SAMPLED = dict(temperature=0.75, seed=1234)   # 0.75 is exact in f32
SVC_STREAM_INFER = 16       # requests of the max batch (no aggregation)
SVC_LATENCY_ITERS = 100


def svc_stream(pb, server, path, req, ctx=None, on_token=None):
    """One Generate stream through the server's behavior: the tokens,
    logprobs, final status code and retry hint, time to the first token
    and wall time."""
    from tpulab_torch.rpc.server import LocalServicerContext

    ctx = ctx or LocalServicerContext([("tpulab-tenant", "chip-smoke")])
    out = dict(tokens=[], logprobs=[], code=None, retry_after_ms=0,
               ttft_s=None)
    t0 = time.perf_counter()
    for b in server.invoke_stream(path, [req.SerializeToString()], ctx):
        m = pb.GenerateResponse.FromString(b)
        if m.final:
            out["code"] = m.status.code
            out["retry_after_ms"] = m.status.retry_after_ms
            out["message"] = m.status.message
            continue
        if out["ttft_s"] is None:
            out["ttft_s"] = time.perf_counter() - t0
        out["tokens"].append(m.token)
        out["logprobs"].append(m.logprob)
        if on_token is not None and on_token(len(out["tokens"])):
            break
    out["wall_s"] = time.perf_counter() - t0
    return out


def svc_threads(fns):
    """Run ``fns`` on threads started together; their results in order."""
    import threading

    outs = [None] * len(fns)

    def run(i):
        outs[i] = fns[i]()

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(900)
    return outs


def direct_stream(cb, prompt, steps, sampling=None, logprobs=False):
    """The same request through ``cb.submit`` alone: tokens, logprobs,
    time to the first token and wall time."""
    first = []
    t0 = time.perf_counter()

    def hook(tok, i, lp=None):
        if not first:
            first.append(time.perf_counter() - t0)

    r = cb.submit(prompt, steps, sampling=sampling, logprobs=logprobs,
                  on_token=hook).result(timeout=900)
    wall = time.perf_counter() - t0
    toks, lps = r if logprobs else (r, None)
    return dict(tokens=[int(t) for t in toks], logprobs=lps,
                ttft_s=first[0], wall_s=wall)


def lanes_home(cb, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if (cb.active_lanes == 0 and cb.queued_requests == 0
                and cb.pool.free_pages == cb.pool.n_pages - 1):
            return True
        time.sleep(0.005)
    return False


def phase_service(torch, card):
    """The serving front door at full width (module docstring, phase 8).
    Returns kernel 1's launches over the service drive."""
    import numpy as np

    import tpulab_torch
    from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
    from tpulab_torch.hbm import HBMArbiter
    from tpulab_torch.models import build_model
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention
    from tpulab_torch.rpc.infer_service import (SERVICE_NAME,
                                                proto_to_tensor,
                                                tensor_to_proto)
    from tpulab_torch.rpc.protos import inference_pb2 as pb
    from tpulab_torch.rpc.server import LocalServicerContext
    from tpulab_torch.serving import AdmissionConfig, AdmissionController

    c = LLAMA3_8B
    t_phase = time.perf_counter()
    torch.backends.cudnn.benchmark = False     # the same kernels each call
    torch.cuda.empty_cache()
    path = f"/{SERVICE_NAME}/"
    kw = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.bfloat16)
    params = full_width_params(torch, c["n_layers"], torch.bfloat16, seed=0)
    arb = HBMArbiter(torch.cuda.get_device_properties(0).total_memory)
    cb = ContinuousBatcher(params, device="cuda", hbm=arb, **SERVE, **kw)
    del params
    mgr = tpulab_torch.InferenceManager(
        max_exec_concurrency=INFER["concurrency"])
    t0 = time.perf_counter()
    mgr.register_model("rn50", build_model(
        "resnet50", max_batch_size=INFER["max_batch_size"],
        input_dtype=np.uint8))
    adm = AdmissionController(AdmissionConfig(
        max_inflight=SVC_MAX_INFLIGHT, max_queue_depth=SVC_QUEUE),
        load=cb)
    import importlib.util

    def installed(m):
        try:
            return importlib.util.find_spec(m) is not None
        except ImportError:         # a parent package is missing
            return False
    have = {m: installed(m) for m in ("grpc", "google.protobuf")}
    try:
        mgr.serve(port=0, batching=True, generation_engines={"llm": cb},
                  admission=adm, hbm=arb)
        log(f"service: serving over grpc on port {mgr.server.bound_port} "
            f"as well ({have}); driven in process below")
    except ImportError as e:
        # no grpc here: the built server serves in process through its
        # behaviors
        log(f"service: in process, no socket ({have}: "
            f"{str(e).split(';')[0]})")
    server = mgr.server
    res = server._infer_resources
    if res.hbm is not arb or adm.hbm is not arb:
        raise AssertionError("service: the arbiter is not wired in")
    log(f"service: built in {time.perf_counter() - t0:.1f} s (ResNet-50 "
        f"registered, every bucket run once); batcher {cb.pool.n_pages} "
        f"pages, arbiter capacity {arb.capacity_bytes} bytes")

    def unary(method, req, ctx=None, cls=None):
        return cls.FromString(server.invoke(
            path + method, req.SerializeToString(),
            ctx or LocalServicerContext([("tpulab-tenant", "chip-smoke")])))

    try:
        # -- references: the same requests through the batcher alone ----
        rng = np.random.default_rng(31)
        prompt = rng.integers(0, c["vocab"], (SVC_PROMPT,)).astype(np.int32)
        burst = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
                 for n in SVC_BURST]
        ref_greedy = direct_stream(cb, prompt, SVC_STEPS, logprobs=True)
        ref_device = direct_stream(cb, prompt, SVC_STEPS, SamplingParams(
            device=True, **SVC_SAMPLED), logprobs=True)
        t0 = time.perf_counter()
        with cb._cv:
            futs = [cb.submit(p, SVC_STEPS) for p in burst]
        ref_burst = [[int(t) for t in f.result(timeout=900)] for f in futs]
        ref_burst_s = time.perf_counter() - t0
        x1, x8 = infer_images(np, 1, 501), infer_images(np, 8, 508)
        runner = mgr.infer_runner("rn50")
        ref_infer = {n: runner.infer(input=x).result(120)["logits"]
                     for n, x in ((1, x1), (8, x8))}
        big = [infer_images(np, INFER["max_batch_size"], 600 + i)
               for i in range(4)]
        if not lanes_home(cb):
            raise AssertionError("service: lanes not home after the "
                                 "references")

        # -- the service drive: every count set to 0 here ----------------
        ragged_paged_attention.launches = 0
        ragged_paged_attention.launches_by_body = dict.fromkeys(
            ragged_paged_attention.launches_by_body, 0)
        fs0 = cb.forward_steps

        # Status and Health
        st = unary("Status", pb.StatusRequest(), cls=pb.StatusResponse)
        free_hbm = arb.free_hbm_bytes
        model = mgr.model("rn50")
        ms = {m.name: m for m in st.models}
        want_io = ([("input", "uint8", [224, 224, 3])],
                   [("logits", "float32", [1000])])
        got_io = ("rn50" in ms and (
            [(s.name, s.dtype, list(s.dims)) for s in ms["rn50"].inputs],
            [(s.name, s.dtype, list(s.dims)) for s in ms["rn50"].outputs]))
        if (st.status.code != pb.SUCCESS or got_io != want_io
                or list(ms["rn50"].batch_buckets) != model.batch_buckets
                or model.batch_buckets != [
                    1 << i for i in range(INFER["max_batch_size"]
                                          .bit_length())]
                or ms["rn50"].max_batch_size != INFER["max_batch_size"]
                or st.free_kv_pages != cb.pool.free_pages
                or st.free_hbm_bytes != free_hbm or free_hbm <= 0
                or st.draining or st.inflight_requests):
            raise AssertionError(f"service: Status {st}; free pages "
                                 f"{cb.pool.free_pages}, free_hbm_bytes "
                                 f"{free_hbm}")
        h = unary("Health", pb.HealthRequest(), cls=pb.HealthResponse)
        if not (h.live and h.ready):
            raise AssertionError(f"service: Health {h}")
        log(f"service: Status: rn50 buckets {list(ms['rn50'].batch_buckets)}"
            f", IO {got_io}, {ms['rn50'].weights_bytes} weight bytes; "
            f"free_kv_pages {st.free_kv_pages} == the batcher's; "
            f"free_hbm_bytes {st.free_hbm_bytes} == the arbiter's (scratch "
            f"claim {cb.scratch.claim_bytes} bytes, the largest of "
            f"{len(cb.scratch.table)} keys); Health live and ready")

        # Infer at batch 1 and 8, bit-identical to the direct runner
        for n, x in ((1, x1), (8, x8)):
            r = unary("Infer", pb.InferRequest(
                model_name="rn50", batch_size=n,
                inputs=[tensor_to_proto("input", x)]), cls=pb.InferResponse)
            got = proto_to_tensor(r.outputs[0]) if r.outputs else None
            if (r.status.code != pb.SUCCESS or got is None
                    or got.tobytes() != ref_infer[n].tobytes()):
                raise AssertionError(f"service: Infer batch {n} status "
                                     f"{r.status}, not bit-identical to "
                                     "the direct runner")
        # StreamInfer: 16 pipelined requests of the max batch, each
        # against its unary twin
        twins = [unary("Infer", pb.InferRequest(
            model_name="rn50", batch_size=len(x),
            inputs=[tensor_to_proto("input", x)]), cls=pb.InferResponse)
            for x in big]
        reqs = [pb.InferRequest(model_name="rn50", batch_size=len(big[0]),
                                correlation_id=i, inputs=[tensor_to_proto(
                                    "input", big[i % len(big)])])
                for i in range(SVC_STREAM_INFER)]
        t0 = time.perf_counter()
        resps = [pb.InferResponse.FromString(b) for b in server.invoke_stream(
            path + "StreamInfer", (r.SerializeToString() for r in reqs))]
        stream_s = time.perf_counter() - t0
        by_id = {r.correlation_id: r for r in resps}
        bad = [i for i in range(SVC_STREAM_INFER)
               if i not in by_id or by_id[i].status.code != pb.SUCCESS
               or by_id[i].outputs[0].raw_data
               != twins[i % len(big)].outputs[0].raw_data]
        if bad or len(resps) != SVC_STREAM_INFER:
            raise AssertionError(f"service: StreamInfer responses {bad} "
                                 "differ from their unary twins")
        pools_home(mgr, "rn50")
        log(f"service: Infer batch 1 and 8 bit-identical to the direct "
            f"runner; StreamInfer {SVC_STREAM_INFER} x batch "
            f"{len(big[0])} in {stream_s:.3f} s, each bit-identical to its "
            "unary twin; every buffers slot, token and context home")
        # Infer latency at batch 1: the service against the direct runner
        req1 = pb.InferRequest(model_name="rn50", batch_size=1,
                               inputs=[tensor_to_proto("input", x1)])
        raw1 = req1.SerializeToString()
        lat = {"service": [], "direct": []}
        for _ in range(5):
            server.invoke(path + "Infer", raw1)
            runner.infer(input=x1).result(120)
        for _ in range(SVC_LATENCY_ITERS):
            t1 = time.perf_counter()
            server.invoke(path + "Infer", raw1)
            t2 = time.perf_counter()
            runner.infer(input=x1).result(120)
            lat["service"].append(t2 - t1)
            lat["direct"].append(time.perf_counter() - t2)
        lat_ms = {k: {q: float(np.percentile(v, q)) * 1e3 for q in (50, 99)}
                  for k, v in lat.items()}
        log(f"service: Infer latency, rn50 batch 1, {SVC_LATENCY_ITERS} "
            f"closed-loop requests each way: service p50 "
            f"{lat_ms['service'][50]:.3f} ms / p99 "
            f"{lat_ms['service'][99]:.3f} ms, direct runner p50 "
            f"{lat_ms['direct'][50]:.3f} ms / p99 "
            f"{lat_ms['direct'][99]:.3f} ms (the service adds the "
            f"message round trip and the {res._batch_window_s * 1e3:.0f} ms "
            f"batching window) [{card}]")

        # Generate: one stream at a time, greedy then device-sampled
        gen_path = path + "Generate"
        singles = {}
        for label, extra, ref in (
                ("greedy", {}, ref_greedy),
                ("device-sampled", dict(device_sampling=True,
                                        **SVC_SAMPLED), ref_device)):
            got = svc_stream(pb, server, gen_path, pb.GenerateRequest(
                model_name="llm", prompt=prompt, steps=SVC_STEPS,
                return_logprobs=True, **extra))
            want_lp = np.asarray(ref["logprobs"], np.float32)
            if (got["code"] != pb.SUCCESS or got["tokens"] != ref["tokens"]
                    or not np.array_equal(np.asarray(got["logprobs"],
                                                     np.float32), want_lp)):
                raise AssertionError(f"service: {label} stream differs from "
                                     f"cb.submit: {got['tokens']} vs "
                                     f"{ref['tokens']}, code {got['code']}")
            singles[label] = dict(
                service_ttft_ms=got["ttft_s"] * 1e3,
                direct_ttft_ms=ref["ttft_s"] * 1e3,
                service_tok_s=SVC_STEPS / got["wall_s"],
                direct_tok_s=SVC_STEPS / ref["wall_s"])
            log(f"service: Generate {label}, prompt {SVC_PROMPT} x "
                f"{SVC_STEPS} steps: tokens bit-identical to cb.submit, "
                f"logprobs equal; TTFT {got['ttft_s'] * 1e3:.1f} ms through "
                f"the service vs {ref['ttft_s'] * 1e3:.1f} ms direct, "
                f"{SVC_STEPS / got['wall_s']:.1f} vs "
                f"{SVC_STEPS / ref['wall_s']:.1f} tok/s [{card}]")

        # Generate: a burst of 8 streams
        t0 = time.perf_counter()
        outs = svc_threads([lambda p=p: svc_stream(pb, server, gen_path,
                                                   pb.GenerateRequest(
            model_name="llm", prompt=p, steps=SVC_STEPS)) for p in burst])
        burst_s = time.perf_counter() - t0
        for i, got in enumerate(outs):
            if got["code"] != pb.SUCCESS or len(got["tokens"]) != SVC_STEPS:
                raise AssertionError(f"service: burst stream {i} status "
                                     f"{got['code']} {got.get('message')}")
        # the streams are held to the direct burst after the launch count
        # is read (the noise rule's replays run kernel 1 themselves)

        # admission: a burst past max_inflight
        n_adm = SVC_MAX_INFLIGHT + SVC_QUEUE + 2
        adm_prompts = [rng.integers(0, c["vocab"], (64 + 16 * i,)).astype(
            np.int32) for i in range(n_adm)]
        rej0 = adm.rejected_total
        adm_outs = svc_threads([lambda p=p: svc_stream(
            pb, server, gen_path, pb.GenerateRequest(
                model_name="llm", prompt=p, steps=16))
            for p in adm_prompts])
        codes = [o["code"] for o in adm_outs]
        rejected = [o for o in adm_outs if o["code"] == pb.RESOURCE_EXHAUSTED]
        if (len(rejected) != n_adm - SVC_MAX_INFLIGHT - SVC_QUEUE
                or codes.count(pb.SUCCESS) != SVC_MAX_INFLIGHT + SVC_QUEUE
                or not all(o["retry_after_ms"] > 0 and not o["tokens"]
                           for o in rejected)):
            raise AssertionError(f"service: admission burst codes {codes}")
        if (not lanes_home(cb) or adm.inflight or adm.queue_depth
                or adm.rejected_total - rej0 != len(rejected)):
            raise AssertionError(f"service: after the admission burst: "
                                 f"lanes {cb.active_lanes}, free pages "
                                 f"{cb.pool.free_pages}/{cb.pool.n_pages}, "
                                 f"admission inflight {adm.inflight}")
        log(f"service: admission burst of {n_adm} (max_inflight "
            f"{SVC_MAX_INFLIGHT}, queue {SVC_QUEUE}): "
            f"{codes.count(pb.SUCCESS)} served, {len(rejected)} "
            f"RESOURCE_EXHAUSTED with retry_after_ms "
            f"{sorted(o['retry_after_ms'] for o in rejected)}; every lane "
            f"and page home, admission inflight 0")

        # cancel: the client drops mid-decode
        ctx = LocalServicerContext([("tpulab-tenant", "chip-smoke")])
        mark = {}

        def drop_at(n):
            if n == 4:
                mark["dispatches"] = cb.decode_dispatches
                mark["t"] = time.perf_counter()
                ctx.cancel()
                return True
            return False

        got = svc_stream(pb, server, gen_path, pb.GenerateRequest(
            model_name="llm", prompt=prompt, steps=256), ctx=ctx,
            on_token=drop_at)
        if not lanes_home(cb, timeout=30):
            raise AssertionError("service: the dropped stream's lane was "
                                 "not freed")
        ticks = cb.decode_dispatches - mark["dispatches"]
        freed_ms = (time.perf_counter() - mark["t"]) * 1e3
        if ticks > 2 or got["code"] is not None:
            raise AssertionError(f"service: the dropped stream ran {ticks} "
                                 "more dispatches (want the one in flight "
                                 f"and one tick at most), final {got['code']}")
        log(f"service: a client dropping after 4 tokens: its lane and pages "
            f"free after {ticks} more dispatch(es) (the one in flight), "
            f"{freed_ms:.1f} ms; no final written")

        # bad input
        oov = svc_stream(pb, server, gen_path, pb.GenerateRequest(
            model_name="llm", prompt=[1, c["vocab"]], steps=4))
        unknown = svc_stream(pb, server, gen_path, pb.GenerateRequest(
            model_name="nope", prompt=[1, 2], steps=4))
        unk_infer = unary("Infer", pb.InferRequest(
            model_name="nope", batch_size=1,
            inputs=[tensor_to_proto("input", x1)]), cls=pb.InferResponse)
        if (oov["code"] != pb.INVALID_ARGUMENT
                or unknown["code"] != pb.UNKNOWN_MODEL
                or unk_infer.status.code != pb.UNKNOWN_MODEL):
            raise AssertionError(f"service: bad input codes {oov['code']}, "
                                 f"{unknown['code']}, "
                                 f"{unk_infer.status.code}")
        log("service: an out-of-vocab prompt gets INVALID_ARGUMENT, an "
            "unknown model UNKNOWN_MODEL (Generate and Infer), as tpulab")

        # drain with an open Generate stream
        first = {}
        holder = {}

        def long_stream():
            holder["out"] = svc_stream(
                pb, server, gen_path, pb.GenerateRequest(
                    model_name="llm", prompt=prompt, steps=96),
                on_token=lambda n: first.setdefault("t", time.perf_counter())
                and False)
            holder["t_done"] = time.perf_counter()

        import threading
        t = threading.Thread(target=long_stream)
        t.start()
        while "t" not in first and t.is_alive():
            time.sleep(0.001)
        drained = mgr.drain(timeout=120, settle_s=0.05)
        t_drained = time.perf_counter()
        h = unary("Health", pb.HealthRequest(), cls=pb.HealthResponse)
        t.join(120)
        out = holder.get("out", {})
        if (not drained or h.ready or not h.live
                or out.get("code") != pb.SUCCESS
                or len(out.get("tokens", ())) != 96
                or t_drained < holder["t_done"] - 0.05):
            raise AssertionError(f"service: drain {drained}, Health {h}, "
                                 f"stream {out.get('code')}")
        log("service: drain turned readiness off and returned after the "
            "open 96-step stream finished (Health live, not ready)")

        launches = ragged_paged_attention.launches
        by_body = dict(ragged_paged_attention.launches_by_body)
        fs = cb.forward_steps - fs0
        if (launches != c["n_layers"] * fs or launches == 0
                or by_body.get("wgmma") != launches):
            raise AssertionError(f"service: ragged launches {launches} vs "
                                 f"{c['n_layers']} x {fs} forward steps, "
                                 f"by body {by_body}")
        prof = res.stage_profile()
        log(f"service: mean stage profile over {prof.get('n')} Infer "
            f"requests (ms): {prof} [{card}]")
        log(f"service: ragged launches through the service {launches} = "
            f"{c['n_layers']} x {fs} forward steps, all on wgmma [{card}]")

        notes = [same_or_bf16_noise(torch, cb.params, kw,
                                    f"burst stream {i} ({len(p)} tokens)",
                                    p, want, got["tokens"])
                 for i, (p, want, got) in enumerate(zip(burst, ref_burst,
                                                        outs))]
        notes = [x for x in notes if x]
        n_tok = SVC_STEPS * len(burst)
        ttfts = sorted(o["ttft_s"] for o in outs)
        log(f"service: Generate burst of {len(burst)} x {SVC_STEPS}: "
            f"{len(burst) - len(notes)}/{len(burst)} streams bit-identical "
            f"to the direct-submit burst" + ("; " + "; ".join(notes)
                                             if notes else "")
            + f"; {n_tok / burst_s:.1f} tok/s through the service vs "
            f"{n_tok / ref_burst_s:.1f} direct, TTFT median "
            f"{ttfts[len(ttfts) // 2] * 1e3:.1f} / max "
            f"{ttfts[-1] * 1e3:.1f} ms [{card}]")
        log("service: " + json.dumps(dict(
            singles=singles, burst_tok_s=n_tok / burst_s,
            direct_burst_tok_s=n_tok / ref_burst_s,
            infer_latency_ms=lat_ms, stage_profile=prof,
            stream_infer_s=stream_s, cancel_dispatches=ticks,
            cancel_ms=freed_ms, launches=launches, forward_steps=fs,
            free_hbm_bytes=free_hbm,
            scratch_claim=cb.scratch.claim_bytes,
            scratch_keys=len(cb.scratch.table))))
    finally:
        mgr.shutdown()
        cb.shutdown()
    log(f"service: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 9
# the observability plane at full width: the overhead row over phase 5's
# model and config (a burst of 16 greedy requests of 512 tokens x 32
# steps, bare and armed alternating), then the plane through the service
OBS_BENCH = dict(n_requests=16, steps=32, lanes=8, prompt_len=512,
                 page_size=16, pairs=2)      # K <= 8: the batcher's default
OBS_PROMPT = 128            # the service drive's prompts
OBS_PROFILE_TICKS = 4
OBS_WD = dict(period_s=0.1, deadline_s=1.0)


#: counts kernel 1's launches in a Chrome trace (argv[1]) and prints it
COUNT_RAGGED = """\
import json, sys
with open(sys.argv[1]) as f:
    events = json.load(f)["traceEvents"]
print(sum(1 for e in events if e.get("cat") == "kernel"
          and "ragged_attn_" in e["name"] and "merge" not in e["name"]))
"""


def ragged_kernel_launches(path):
    """Kernel 1's launches in a torch.profiler Chrome trace: device
    kernels named ``ragged_attn_*`` but the split-KV merge.  A child
    process parses the file: ``json.load`` of a 66 MB trace holds the
    interpreter lock for seconds, which would stall the watchdog's
    canary thread and the serving threads of this process."""
    import subprocess

    out = subprocess.run([sys.executable, "-c", COUNT_RAGGED, path],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return int(out.stdout)


def refused_under_outer_capture(torch, cb, prompt):
    """``cb.arm_profile`` while another profiler session runs on the main
    thread: the RuntimeError's message, and that session's kernel 1
    launches over the request it covers (it must trace the card)."""
    from torch.profiler import ProfilerActivity

    from tpulab_torch.utils.tracing import profiler_session

    with profiler_session(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as outer:
        try:
            cb.arm_profile(2)
        except RuntimeError as e:
            refused = str(e)
        else:
            raise AssertionError("obs: a capture armed under another")
        cb.submit(prompt, 4).result(timeout=300)
        torch.cuda.synchronize()
    events = outer.key_averages()
    ragged = sum(e.count for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "ragged_attn_" in e.key and "merge" not in e.key)
    if not ragged:
        raise AssertionError(
            "obs: the outer capture lost the card: "
            f"{sum(e.count for e in events)} events, "
            f"{[e.key[:40] for e in events][:8]}")
    return refused, ragged


def debug_capture(pb, unary, gen, streams, cb, n_layers, card, label):
    """Debug with ``profile_ticks``, traffic until the capture ends; its
    ``trace.json`` must hold n_layers x the forward steps counted over it
    of kernel 1 launches.  Returns the capture's record."""
    d = unary("Debug", pb.DebugRequest(
        model_name="llm", profile_ticks=OBS_PROFILE_TICKS),
        pb.DebugResponse)
    if d.status.code != pb.SUCCESS or not d.profile_dir:
        raise AssertionError(f"obs: {label} profile_ticks {d.status}")
    t_cap = time.perf_counter()
    before = cb.last_profile
    while cb.last_profile is before and time.perf_counter() - t_cap < 120:
        streams.append(gen(16, "profiled"))
    prof = cb.last_profile
    if prof is before or "error" in prof:
        raise AssertionError(f"obs: {label} capture {prof}")
    n_kernel = ragged_kernel_launches(prof["trace"])
    size = os.path.getsize(prof["trace"])
    if n_kernel != n_layers * prof["forward_steps"] or not n_kernel:
        raise AssertionError(
            f"obs: the {label} capture holds {n_kernel} ragged kernels, "
            f"{n_layers} x {prof['forward_steps']} forward steps counted "
            f"over it ({prof['device_events']} device events)")
    log(f"obs: {label} Debug profile_ticks={OBS_PROFILE_TICKS}: "
        f"{prof['trace']} ({size} bytes, {prof['device_events']} device "
        f"events) holds {n_kernel} ragged kernel launches = {n_layers} x "
        f"{prof['forward_steps']} forward steps captured [{card}]")
    return prof


def spin_cycles_per_s(torch):
    """The card's spin rate for ``torch.cuda._sleep`` (cycles a second),
    from one timed spin."""
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    torch.cuda._sleep(int(2e8))
    b.record()
    b.synchronize()
    return 2e8 / (a.elapsed_time(b) / 1e3)


def obs_bench(torch, params, kw, card):
    """(a) ``benchmark_obs_overhead`` at full width; token parity held per
    pair by dispatch (the caller holds the rest by the noise rule once
    the launch count is read)."""
    from tpulab_torch.obs import benchmark_obs_overhead

    c = LLAMA3_8B
    row = benchmark_obs_overhead(
        vocab=c["vocab"], n_heads=c["n_heads"], n_layers=c["n_layers"],
        n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
        params=params, device="cuda", dtype=torch.bfloat16,
        debug_poll_s=0.02, **OBS_BENCH)
    for i, p in enumerate(row["pairs"]):
        if p["same_dispatch"] and not p["parity"]:
            raise AssertionError(f"obs: pair {i} dispatched alike "
                                 f"{p['dispatch_on']} but its tokens differ")
        log(f"obs: pair {i}: bare {p['tok_s_off']:.1f} tok/s, armed "
            f"{p['tok_s_on']:.1f}, overhead {p['overhead_pct']:+.2f} %; "
            f"tokens {'bit-identical' if p['parity'] else 'differ'}; "
            f"dispatch {'alike' if p['same_dispatch'] else 'differs'} "
            f"({p['dispatch_on']}) [{card}]")
    if not row["watchdog_healthy"] or row["canaries"] < 1:
        raise AssertionError(f"obs: the bench's watchdog {row['canaries']} "
                             f"canaries, healthy {row['watchdog_healthy']}")
    if row["records_observed"] != OBS_BENCH["n_requests"] + 1:
        raise AssertionError(f"obs: {row['records_observed']} flight "
                             "records in an armed run")
    log(f"obs: overhead row at full width: mean bare "
        f"{row['tok_s_off']:.1f} tok/s, armed {row['tok_s_on']:.1f} "
        f"({row['overhead_pct']:+.2f} %, printed, not gated); flight "
        f"records observed {row['records_observed']}, retained "
        f"{row['records_retained']}; assembly p50 {row['assembly_ms_p50']} "
        f"/ p99 {row['assembly_ms_p99']} ms; {row['debug_polls']} debugz "
        f"polls, snapshot p50 {row['snapshot_ms_p50']} / p99 "
        f"{row['snapshot_ms_p99']} ms, scheduler lock held p50 "
        f"{row['lock_hold_ms_p50']} / p99 {row['lock_hold_ms_p99']} / max "
        f"{row['lock_hold_ms_max']} ms; {row['trace_events']} trace "
        f"events; {row['canaries']} canaries, last "
        f"{row['last_canary_ms']} ms [{card}]")
    return row


def phase_obs(torch, card):
    """The observability plane at full width (module docstring, phase 9).
    Returns kernel 1's launches over the phase."""
    import threading
    import urllib.request

    import numpy as np

    import tpulab_torch
    from tpulab_torch import chaos
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.hbm import HBMArbiter
    from tpulab_torch.obs import FlightRecorder
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention
    from tpulab_torch.rpc.infer_service import SERVICE_NAME
    from tpulab_torch.rpc.protos import inference_pb2 as pb
    from tpulab_torch.rpc.server import LocalServicerContext
    from tpulab_torch.utils.metrics import (ChaosMetrics, GenerationMetrics,
                                            InferenceMetrics,
                                            start_metrics_server)
    from tpulab_torch.utils.watchdog import DeviceWatchdog

    c = LLAMA3_8B
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kw = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.bfloat16)
    params = full_width_params(torch, c["n_layers"], torch.bfloat16, seed=0)
    # every count of the phase from here
    ragged_paged_attention.launches = 0
    ragged_paged_attention.launches_by_body = dict.fromkeys(
        ragged_paged_attention.launches_by_body, 0)

    # (a) the overhead row
    t0 = time.perf_counter()
    row = obs_bench(torch, params, kw, card)
    fs_total = row["forward_steps_total"]
    log(f"obs: (a) {time.perf_counter() - t0:.1f} s")

    # (b) the plane through the service
    t0 = time.perf_counter()
    arb = HBMArbiter(torch.cuda.get_device_properties(0).total_memory)
    gm = GenerationMetrics(model="llm")
    cb = ContinuousBatcher(params, device="cuda", hbm=arb, metrics=gm,
                           **SERVE, **kw)
    fr = FlightRecorder(p99_min_n=10_000)   # no slow exemplars here
    im = InferenceMetrics()
    cm = ChaosMetrics().install()
    wd = DeviceWatchdog(**OBS_WD).start()
    mgr = tpulab_torch.InferenceManager()
    try:
        mgr.serve(port=0, generation_engines={"llm": cb}, flight=fr,
                  metrics=im, watchdog=wd, hbm=arb)
    except ImportError:
        pass                        # no grpc: the built server serves
    server = mgr.server
    path = f"/{SERVICE_NAME}/"
    gen_path = path + "Generate"
    http, http_thread = start_metrics_server([gm, cm, im], port=0,
                                             addr="127.0.0.1")
    rng = np.random.default_rng(41)
    pool = [rng.integers(0, c["vocab"], (OBS_PROMPT,)).astype(np.int32)
            for _ in range(64)]

    def prompt():
        return pool.pop()

    def unary(method, req, cls):
        return cls.FromString(server.invoke(
            path + method, req.SerializeToString(),
            LocalServicerContext([("tpulab-tenant", "chip-smoke")])))

    def gen(steps, tenant, **kw2):
        return svc_stream(pb, server, gen_path, pb.GenerateRequest(
            model_name="llm", prompt=prompt(), steps=steps,
            tenant_id=tenant, **kw2))

    fired = 0
    streams = []
    try:
        # uniform baseline, a chaos-hit request, one over its deadline
        streams += svc_threads([lambda: gen(8, "uniform")] * 8)
        with chaos.inject("engine.step=delay:0+1") as sched:
            streams.append(gen(8, "chaos-t", trace_id="c" * 16))
            fired += sched.fired("engine.step")
        with chaos.inject("engine.step=delay:0.02+999") as sched:
            late = gen(64, "late-t", deadline_ms=150)
            fired += sched.fired("engine.step")
        streams.append(late)
        if late["code"] != pb.DEADLINE_EXCEEDED or any(
                s["code"] != pb.SUCCESS for s in streams[:-1]):
            raise AssertionError(f"obs: stream codes "
                                 f"{[s['code'] for s in streams]}")

        # Debug mid-stream
        holder = {}
        first = threading.Event()

        def paced():
            with chaos.inject("engine.step=delay:0.02") as sched:
                holder["out"] = svc_stream(
                    pb, server, gen_path, pb.GenerateRequest(
                        model_name="llm", prompt=prompt(), steps=48,
                        tenant_id="midstream", trace_id="f" * 16),
                    on_token=lambda n: first.set() and False)
                holder["fired"] = sched.fired("engine.step")

        th = threading.Thread(target=paced)
        th.start()
        first.wait(120)
        t_dbg = time.perf_counter()
        d = unary("Debug", pb.DebugRequest(), pb.DebugResponse)
        debug_ms = (time.perf_counter() - t_dbg) * 1e3
        th.join(300)
        fired += holder["fired"]
        streams.append(holder["out"])
        snap = json.loads(d.snapshot_json)
        rows = [r for r in snap["engines"]["llm"]["lanes"]
                if r.get("tenant") == "midstream" and r["tokens"] > 0]
        if (d.status.code != pb.SUCCESS or not rows
                or rows[0]["trace_id"] != "f" * 16 or "hbm" not in snap
                or "flight" not in snap or snap["hbm"]["verify_mismatches"]
                or not snap["watchdog"]["healthy"]):
            raise AssertionError(f"obs: mid-stream Debug {d.status} lanes "
                                 f"{snap.get('engines')}")
        log(f"obs: Debug mid-stream ({debug_ms:.2f} ms through the "
            f"service, {len(d.snapshot_json)} bytes): lane "
            f"{rows[0]['lane']} {rows[0]['state']} {rows[0]['tokens']}/"
            f"{rows[0]['steps']} tokens, {rows[0]['pages']} pages; hbm "
            f"claims {len(snap['hbm']['claims'])}, verify clean; flight "
            f"observed {snap['flight']['observed_total']}; watchdog "
            f"healthy; scheduler lock held {cb.debug_lock_hold_s * 1e3:.4f}"
            f" ms [{card}]")

        # Debug with profile_ticks (on the scheduler thread), then a
        # main-thread session that must refuse a capture and trace the
        # card, then a second Debug capture that must trace it again
        debug_capture(pb, unary, gen, streams, cb, c["n_layers"], card,
                      "first")
        refused, n_outer = refused_under_outer_capture(torch, cb, prompt())
        direct_requests = 1                 # the request it covered
        log(f"obs: after the Debug capture, arming under a main-thread "
            f"session: RuntimeError ({refused!r}); the session traced the "
            f"card ({n_outer} kernel 1 launches of the request it "
            f"covered)")
        debug_capture(pb, unary, gen, streams, cb, c["n_layers"], card,
                      "second")

        # the scrape
        gm.poll(cb)
        im.poll_device(0)
        reserved = torch.cuda.memory_reserved(0)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{http.server_port}/metrics",
                timeout=30) as r:
            text = r.read().decode()
        samples = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                name, _, value = line.rpartition(" ")
                samples[name] = float(value)
        firsts = sum(1 for s in streams if s["tokens"]) + direct_requests
        ttft_n = samples["tpulab_llm_ttft_seconds_count"]
        trips = sum(v for k, v in samples.items()
                    if k.startswith("tpulab_chaos_injections_total{")
                    and 'point="engine.step"' in k)
        if (ttft_n != firsts or trips != fired or trips < 3
                or samples["tpulab_llm_tokens_total"] != cb.tokens_generated
                or samples["tpulab_llm_requests_completed_total"]
                != cb.completed_requests
                or samples["tpulab_hbm_bytes_in_use"] <= 0):
            raise AssertionError(
                f"obs: scrape ttft count {ttft_n} vs {firsts} first tokens, "
                f"engine.step injections {trips} vs {fired}")
        log(f"obs: /metrics scrape ({len(text)} bytes): TTFT count "
            f"{ttft_n:.0f} == {firsts} first tokens; tokens "
            f"{cb.tokens_generated}, completed {cb.completed_requests} == "
            f"the batcher's; engine.step injections {trips:.0f} == the "
            f"schedules' {fired}; hbm_bytes_in_use "
            f"{samples['tpulab_hbm_bytes_in_use']:.0f} (memory_reserved "
            f"{reserved} after the poll), framework_hbm_bytes "
            f"{samples['tpulab_framework_hbm_bytes']:.0f}")

        # the flight keeps
        by = {}
        for r in fr.records():
            by.setdefault(r.get("tenant"), []).append(r)
        chaos_rec, late_rec = by["chaos-t"][0], by["late-t"][0]
        if (chaos_rec["keep"] != "chaos"
                or chaos_rec.get("chaos_trips") != {"engine.step": 1}
                or late_rec["keep"] != "deadline"
                or late_rec["outcome"] != "DEADLINE_EXCEEDED"):
            raise AssertionError(f"obs: flight keeps {chaos_rec} {late_rec}")
        log(f"obs: flight: observed {fr.observed_total}, retained "
            f"{len(fr)} {dict(fr.kept_by_reason)}; chaos-t kept as chaos "
            f"({chaos_rec['chaos_trips']}), late-t kept as deadline "
            f"({late_rec['tokens_delivered']}/64 tokens delivered)")

        # the watchdog: healthy while serving, then a wedged canary
        if not wd.healthy or wd.canaries < 3:
            raise AssertionError(f"obs: watchdog {wd.canaries} canaries, "
                                 f"healthy {wd.healthy} ({wd.reason})")
        canary_ms = wd.last_canary_s * 1e3
        rate = spin_cycles_per_s(torch)
        spin_s = OBS_WD["deadline_s"] + OBS_WD["period_s"] + 2.0
        canary = wd._canary

        def wedged(x, _n=int(rate * spin_s)):
            torch.cuda._sleep(_n)       # the canary stream spins
            return x.sum()

        def ready():
            return unary("Health", pb.HealthRequest(),
                         pb.HealthResponse).ready

        t_w = time.perf_counter()
        wd._canary = (wedged, canary[1])
        while ready() and time.perf_counter() - t_w < 30:
            time.sleep(0.005)
        off_s = time.perf_counter() - t_w
        limit = OBS_WD["deadline_s"] + OBS_WD["period_s"]
        wd._canary = canary
        while not ready() and time.perf_counter() - t_w < 60:
            time.sleep(0.01)
        on_s = time.perf_counter() - t_w
        if off_s > limit + 0.25 or not ready():
            raise AssertionError(f"obs: Health not-ready after {off_s:.3f}"
                                 f" s (limit {limit} s), ready again "
                                 f"{ready()}")
        log(f"obs: watchdog: {wd.canaries} canaries while serving, last "
            f"{canary_ms:.3f} ms; a canary spinning {spin_s:.1f} s on its "
            f"stream turned Health not-ready after {off_s:.3f} s (deadline "
            f"+ period {limit} s) and ready again {on_s:.3f} s after the "
            f"swap [{card}]")
        fs_total += cb.forward_steps
    finally:
        http.shutdown()
        http.server_close()
        cm.uninstall()
        wd.stop()
        mgr.shutdown()
        cb.shutdown()
    log(f"obs: (b) {time.perf_counter() - t0:.1f} s")

    # (c) kernel 1 over the phase, read before the noise rule's replays
    launches = ragged_paged_attention.launches
    by_body = dict(ragged_paged_attention.launches_by_body)
    if (launches != c["n_layers"] * fs_total or not launches
            or by_body.get("wgmma") != launches):
        raise AssertionError(f"obs: ragged launches {launches} vs "
                             f"{c['n_layers']} x {fs_total} forward steps, "
                             f"by body {by_body}")
    log(f"obs: ragged launches over the phase {launches} = "
        f"{c['n_layers']} x {fs_total} forward steps, all on wgmma")

    # (a)'s pairs that dispatched differently: the bf16 noise rule
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, c["vocab"], (OBS_BENCH["prompt_len"],),
                            np.int32)
               for _ in range(OBS_BENCH["n_requests"])]
    ruled = 0
    for i, p in enumerate(row["pairs"]):
        if p["parity"]:
            continue
        ruled += 1
        for j, (want, got) in enumerate(zip(p["tokens_off"],
                                            p["tokens_on"])):
            same_or_bf16_noise(torch, params, kw, f"obs pair {i} request "
                               f"{j}", prompts[j], list(want), list(got))
    log(f"obs: {len(row['pairs']) - ruled} of {len(row['pairs'])} pairs "
        f"bit-identical armed vs bare; {ruled} held by the bf16 noise rule")
    log("obs: " + json.dumps({k: v for k, v in row.items()
                              if k != "pairs"}))
    del params
    log(f"obs: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------------------------- phase 10
# the offline batch lane at full width: phase 5's ragged batcher with a
# 2 GiB host tier behind an AdmissionController; one checkpoint file for
# three jobs (one sampling config a job): 8 greedy items, 7 device-sampled
# and 1 host-sampled, prompts of 256 ... 768 tokens x 48 steps
BATCH_STEPS = 48
BATCH_LENS = (256, 768, 320, 704, 384, 640, 448, 576, 512, 288, 736, 352,
              672, 416, 608, 480)
BATCH_SPLIT = (("greedy", 8, {}),
               ("device", 7, dict(temperature=0.8, seed=4242,
                                  device_sampling=True)),
               ("host", 1, dict(temperature=0.8, seed=77)))
BATCH_INFLIGHT = {"greedy": 4, "device": 3, "host": 1}   # 8 lanes
BATCH_KV_OFFLOAD = 2 << 30
BATCH_ONLINE = (512, 32, 8)     # an online burst: 8 greedy 512 x 32


def online_burst(cb, prompts, steps, ttft=None):
    """Submit ``prompts`` at once (greedy, streaming); returns each
    request's TTFT (filled into ``ttft`` as the first tokens arrive) and
    tokens."""
    t0 = time.perf_counter()
    ttft = [None] * len(prompts) if ttft is None else ttft

    def hook(k):
        def on_token(tok, i, lp=None):
            if ttft[k] is None:
                ttft[k] = time.perf_counter() - t0
        return on_token

    with cb._cv:
        futs = [cb.submit(p, steps, on_token=hook(k))
                for k, p in enumerate(prompts)]
    toks = [[int(t) for t in f.result(timeout=900)] for f in futs]
    return ttft, toks


def run_jobs(scheds, jobs):
    """Run every job on its scheduler, each in its own thread; returns
    the threads and the report dict they fill."""
    import threading

    reports = {}

    def one(name):
        reports[name] = scheds[name].run(jobs[name], timeout_s=900)

    threads = [threading.Thread(target=one, args=(n,), daemon=True)
               for n in jobs]
    for t in threads:
        t.start()
    return threads, reports


def wait_for(pred, label, timeout=300.0):
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"{label}: not reached in {timeout} s")
        time.sleep(0.002)


def phase_batch(torch, card):
    """The offline batch lane at full width (module docstring, phase 10).
    Returns kernel 1's launches over the phase."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from tpulab_torch import chaos
    from tpulab_torch.batch import BatchJob, BatchScheduler, JSONLResultSink
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention
    from tpulab_torch.serving import AdmissionConfig, AdmissionController

    c = LLAMA3_8B
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    kw = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.bfloat16)
    params = full_width_params(torch, c["n_layers"], torch.bfloat16, seed=0)
    cb = ContinuousBatcher(params, device="cuda",
                           kv_offload=BATCH_KV_OFFLOAD, **SERVE, **kw)
    adm = AdmissionController(AdmissionConfig(max_inflight=64), load=cb)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
               for n in BATCH_LENS]
    jobs, items, k = {}, [], 0
    for name, n, sampling in BATCH_SPLIT:
        jobs[name] = BatchJob(name, prompts[k:k + n], steps=BATCH_STEPS,
                              **sampling)
        items += [(name, i) for i in range(n)]
        k += n
    plen, psteps, pn = BATCH_ONLINE
    online = [rng.integers(0, c["vocab"], (plen,)).astype(np.int32)
              for _ in range(pn)]
    tmp = tempfile.mkdtemp(prefix="chip-smoke-batch-")
    try:
        # -- every count set to 0 here: the phase's drive starts ----------
        ragged_paged_attention.launches = 0
        ragged_paged_attention.launches_by_body = dict.fromkeys(
            ragged_paged_attention.launches_by_body, 0)
        fs0, p0, bp0 = cb.forward_steps, cb.preemptions, cb.batch_preemptions
        # references: every item served alone on this batcher
        t0 = time.perf_counter()
        alone = {(name, i): [int(t) for t in cb.submit(
            jobs[name].prompts[i], BATCH_STEPS,
            sampling=jobs[name].sampling()).result(timeout=900)]
            for name, i in items}
        log(f"batch: {len(items)} items served alone "
            f"({time.perf_counter() - t0:.1f} s)")
        ttft = {"off": [], "on": []}

        def burst(mode):
            got, _ = online_burst(cb, online, psteps)
            ttft[mode] += got

        burst("off")
        sink = JSONLResultSink(os.path.join(tmp, "results.jsonl"))
        scheds = {n: BatchScheduler(cb, sink=sink, admission=adm,
                                    max_inflight=BATCH_INFLIGHT[n])
                  for n in jobs}
        util = []

        def soak_util():
            util.append(sum(s.soak_utilization for s in scheds.values()))

        # -- run 1: the lane soaks, an online burst preempts it, and a
        # batch.run kill ends it mid-feed while the burst decodes -------
        t_run1 = time.perf_counter()
        threads, rep1 = run_jobs(scheds, jobs)
        wait_for(lambda: (scheds["host"].tokens_delivered >= 4
                          and scheds["greedy"].tokens_delivered >= 4
                          and scheds["device"].tokens_delivered >= 4),
                 "batch: the lane soaking")
        soak_util()
        live = [None] * pn
        th = threading.Thread(target=online_burst,
                              args=(cb, online, psteps, live), daemon=True)
        th.start()
        # the burst has preempted the lane once every online request has
        # its first token: the kill lands mid-feed
        wait_for(lambda: all(x is not None for x in live),
                 "batch: the burst's first tokens")
        with chaos.inject("batch.run=error") as sched_chaos:
            for t in threads:
                t.join(900)
            fired = sched_chaos.fired("batch.run")
        th.join(900)
        ttft["on"] += live
        run1_s = time.perf_counter() - t_run1
        if fired < 1 or any(r["interrupted"] != "error"
                            for r in rep1.values()):
            raise AssertionError(f"batch: run 1 not killed ({fired} fires, "
                                 f"{ {n: r['interrupted'] for n, r in rep1.items()} })")
        progress = {n: sink.load_progress(n) for n in jobs}
        delivered = {(n, i): len(progress[n].get(i).tokens)
                     if progress[n].get(i) else 0 for n, i in items}
        done1 = {(n, i) for n, i in items
                 if progress[n].get(i) and progress[n][i].done}
        partial = [key for key in items if key not in done1
                   and 0 < delivered[key] < BATCH_STEPS]
        if not any(n != "host" for n, _ in partial) \
                or ("host", 0) not in partial:
            raise AssertionError(f"batch: the kill left no resumable or no "
                                 f"host-sampled partial item: {partial}")
        burst("off")

        # -- run 2: resume from the checkpoint, online bursts arriving ----
        tg0 = cb.tokens_generated
        with open(sink.path) as f:
            n_rec0 = len(f.readlines())

        def delivered_total():
            return sum(s.tokens_delivered for s in scheds.values())

        d0 = delivered_total()
        t_run2 = time.perf_counter()
        threads, rep2 = run_jobs(scheds, jobs)
        # the resume's own latency first: bursts only once it has a token
        wait_for(lambda: delivered_total() > d0
                 or not any(t.is_alive() for t in threads),
                 "batch: run 2's first token")
        resume_s = time.perf_counter() - t_run2
        soak_util()
        on_bursts = 0
        for _ in range(2):
            if not any(t.is_alive() for t in threads):
                break
            burst("on")
            on_bursts += 1
            soak_util()
        for t in threads:
            t.join(900)
        run2_s = time.perf_counter() - t_run2
        run2_generated = cb.tokens_generated - tg0
        burst("off")
        if any(r["interrupted"] is not None
               or r["items_done"] != len(jobs[n]) for n, r in rep2.items()):
            raise AssertionError(f"batch: run 2 {rep2}")
        launches = ragged_paged_attention.launches
        by_body = dict(ragged_paged_attention.launches_by_body)
        fs = cb.forward_steps - fs0
        online_preempted = ((cb.preemptions - p0)
                            - (cb.batch_preemptions - bp0))
        # the records run 2 wrote: a resumable item continues at its
        # delivered count, the host-sampled one restarts behind a reset
        with open(sink.path) as f:
            recs = [json.loads(x) for x in f.readlines()[n_rec0:]
                    if x.strip()]
        decoded = {}
        for r in recs:
            key = (r["job"], r["item"])
            if "tokens" in r:
                decoded.setdefault(key, []).append(
                    (r["start"], len(r["tokens"])))
        resets = {(r["job"], r["item"]) for r in recs if r.get("reset")}
        for key in items:
            if key in done1:
                if key in decoded:
                    raise AssertionError(f"batch: {key} was done and "
                                         "decoded again")
                continue
            start = 0 if key[0] == "host" else delivered[key]
            spans = sorted(decoded.get(key, []))
            n_dec = sum(n for _, n in spans)
            if (not spans or spans[0][0] != start
                    or n_dec != BATCH_STEPS - start):
                raise AssertionError(f"batch: {key} delivered "
                                     f"{delivered[key]}, run 2 decoded "
                                     f"{spans}")
        if resets != {("host", 0)}:
            raise AssertionError(f"batch: reset records {resets}")
        skipped = sum(r["tokens_resume_skipped"] for r in rep2.values())
        want_skipped = sum(delivered[k2] for k2 in partial
                           if k2[0] != "host")
        run2_batch = sum(BATCH_STEPS - (0 if k2[0] == "host"
                                        else delivered[k2])
                         for k2 in items if k2 not in done1)
        run2_online = on_bursts * pn * psteps
        if (skipped != want_skipped
                or run2_generated != run2_batch + run2_online):
            raise AssertionError(
                f"batch: resume skipped {skipped} (want {want_skipped}); "
                f"run 2 generated {run2_generated} tokens, want "
                f"{run2_batch} batch + {run2_online} online")
        if cb.batch_preemptions - bp0 < 1 or online_preempted:
            raise AssertionError(f"batch: {cb.batch_preemptions - bp0} "
                                 f"batch preemptions, {online_preempted} "
                                 "online")
        if (launches != c["n_layers"] * fs or launches == 0
                or by_body.get("wgmma") != launches):
            raise AssertionError(f"batch: ragged launches {launches} vs "
                                 f"{c['n_layers']} x {fs} forward steps, "
                                 f"by body {by_body}")
        if not lanes_home(cb):
            raise AssertionError("batch: lanes or pages not home")
        results = {(n, i): rep2[n]["results"][i] for n, i in items}
        notes = [same_or_bf16_noise(
            torch, params, kw, f"batch item {n}/{i}", jobs[n].prompts[i],
            alone[(n, i)], results[(n, i)], jobs[n].sampling())
            for n, i in items]
        notes = [x for x in notes if x]
        on, off = sorted(ttft["on"]), sorted(ttft["off"])

        def q(v, p):
            return v[min(len(v) - 1, int(p * len(v)))] * 1e3
        n_items = len(items)
        log(f"batch: run 1 killed mid-feed by batch.run=error "
            f"({fired} fires) with {len(partial)} items partial "
            f"({sum(delivered[k2] for k2 in partial)} tokens delivered); "
            f"run 2 resumed {want_skipped} delivered tokens with zero "
            f"re-decode, the host-sampled item restarted behind a reset "
            f"record; {cb.batch_preemptions - bp0} batch preemptions, 0 "
            f"online [{card}]")
        log(f"batch: {n_items - len(notes)}/{n_items} items bit-identical "
            f"to the item served alone"
            + ("; " + "; ".join(notes) if notes else ""))
        log(f"batch: ragged launches {launches} = {c['n_layers']} x {fs} "
            f"forward steps, all on wgmma; lanes and pages home [{card}]")
        row = dict(
            soak_utilization=sum(util) / max(1, len(util)),
            items_per_s=n_items / (run1_s + run2_s),
            online_ttft_ms={"soaking": {"p50": q(on, .5), "p99": q(on, .99),
                                        "n": len(on)},
                            "alone": {"p50": q(off, .5), "p99": q(off, .99),
                                      "n": len(off)}},
            resume_s=resume_s,
            run1_s=run1_s, run2_s=run2_s,
            batch_preemptions=cb.batch_preemptions - bp0,
            launches=launches, forward_steps=fs)
        log("batch: " + json.dumps(row) + f" [{card}]")
    finally:
        cb.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    del params, cb
    log(f"batch: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------------------------- phase 11
# the fleet: replica processes (python -m tpulab_torch.fleet.replica_main)
# at Llama-3-8B width over gRPC on 127.0.0.1, 4 lanes each, prefix cache on
FLEET_LANES = 4
FLEET_PROMPT, FLEET_STEPS = 512, 32
FLEET_PREFIX, FLEET_SUFFIX, FLEET_AFFINITY_STEPS = 256, 64, 16
FLEET_KILL_AT = 8               # rpc.stream=kill@8 in the victim
FLEET_HOLD_STEPS = 64           # the stream held through the drain


def replica_args():
    c = LLAMA3_8B
    return ("--device", "cuda", "--dtype", "bf16", "--vocab", str(c["vocab"]),
            "--d-model", str(c["d_model"]), "--n-heads", str(c["n_heads"]),
            "--n-kv-heads", str(c["n_kv_heads"]),
            "--n-layers", str(c["n_layers"]), "--d-ff", str(c["d_ff"]),
            "--ffn", "swiglu", "--untied",
            "--rope-theta", str(c["rope_theta"]),
            "--lanes", str(FLEET_LANES), "--max-len", str(SERVE["max_len"]),
            "--page-size", str(SERVE["page_size"]),
            "--decode-block", str(SERVE["decode_block"]),
            "--prefill-chunk", str(SERVE["prefill_chunk"]), "--seed", "0")


class GpuMemory:
    """Samples ``nvidia-smi``'s used memory every second; ``peak`` MiB."""

    def __init__(self):
        import subprocess
        import threading

        self.peak, self._stop = 0, threading.Event()

        def loop():
            while not self._stop.wait(1.0):
                try:
                    out = subprocess.run(
                        ["nvidia-smi", "--query-gpu=memory.used",
                         "--format=csv,noheader,nounits", "--id=0"],
                        capture_output=True, text=True, timeout=30)
                    self.peak = max(self.peak, int(out.stdout.split()[0]))
                except (OSError, ValueError, IndexError,
                        subprocess.SubprocessError):
                    pass
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(60)


def stream_direct(mgr, prompt, steps):
    """A lone greedy stream straight to one replica: tokens, TTFT and
    arrival times."""
    from tpulab_torch.rpc.infer_service import GenerateStreamClient

    t0 = time.perf_counter()
    toks, at = [], []
    for t in GenerateStreamClient(mgr, "lm").generate(prompt, steps,
                                                      timeout=300):
        toks.append(int(t))
        at.append(time.perf_counter() - t0)
    return toks, at


def phase_fleet(torch, card):
    """Replica processes over gRPC (module docstring, phase 11).  Returns
    kernel 1's launches the replicas reported."""
    import gc
    import importlib.util
    import shutil
    import tempfile
    import threading

    import numpy as np

    from tpulab_torch import chaos
    from tpulab_torch.fleet import (FleetAutoscaler, FleetSupervisor,
                                    PrefixAffinityRouter,
                                    SubprocessReplicaProvider, prefix_digest)
    from tpulab_torch.obs import EventJournal, replay_journal, sequence_gaps
    from tpulab_torch.rpc.infer_service import (GenerateStreamClient,
                                                RemoteInferenceManager)
    from tpulab_torch.rpc.replica import GenerationReplicaSet
    from tpulab_torch.utils.metrics import FleetMetrics, ReplicaSetMetrics
    from tpulab_torch.utils.tracing import ChromeTraceRecorder

    c = LLAMA3_8B
    t_phase = time.perf_counter()
    if importlib.util.find_spec("grpc") is None:
        raise AssertionError("fleet: grpc is not installed: the replica "
                             "processes serve over gRPC sockets")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(0)
    # cuBLAS keeps a workspace for every (handle, stream) it ran on, the
    # handles of finished threads (every batcher's scheduler) included,
    # inside the caching allocator's count
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        torch.cuda.empty_cache()
    log(f"fleet: the parent holds {torch.cuda.memory_allocated(0)} bytes "
        f"allocated ({held} before the cuBLAS workspaces were cleared), "
        f"{torch.cuda.memory_reserved(0)} reserved")
    kw = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.bfloat16)
    snaps, spawn_s = {}, []

    class Provider(SubprocessReplicaProvider):
        """Reads each replica's Debug snapshot (its kernel-1 launches and
        forward steps) before it is retired; a dead one answers nothing."""

        def retire(self, address):
            if address not in snaps:
                try:
                    mgr = RemoteInferenceManager(address)
                    try:
                        d = mgr.debugz("lm", timeout=30)
                    finally:
                        mgr.close()
                    ra = d["kernels"]["ragged_paged_attention"]
                    snaps[address] = dict(
                        launches=ra["launches"], by_body=ra["by_body"],
                        forward_steps=d["engines"]["lm"]["dispatch"][
                            "forward_steps"])
                except Exception as e:  # noqa: BLE001 - a dead replica
                    snaps[address] = {"lost": f"{type(e).__name__}"}
            super().retire(address)

        def spawn(self, extra_env=None):
            t0 = time.perf_counter()
            addr = super().spawn(extra_env)
            spawn_s.append(time.perf_counter() - t0)
            return addr

    gpu = GpuMemory()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    prov = Provider(replica_args=replica_args(), ready_timeout_s=180.0,
                    term_grace_s=60.0)
    journal = EventJournal(os.path.join(tmp, "journal.jsonl"),
                           node="chip-smoke")
    rs, direct = None, {}
    rng = np.random.default_rng(53)
    prompt = rng.integers(0, c["vocab"], (FLEET_PROMPT,)).astype(np.int32)
    try:
        # -- three replicas at once: a, b and the chaos-armed victim ------
        t0 = time.perf_counter()
        addrs = {}

        def spawn(name, env=None):
            addrs[name] = prov.spawn(extra_env=env)

        threads = [threading.Thread(target=spawn, args=(n, e), daemon=True)
                   for n, e in (("a", None), ("b", None),
                                ("victim", {"TPULAB_CHAOS":
                                            f"rpc.stream=kill@{FLEET_KILL_AT}"}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if len(addrs) != 3:
            raise AssertionError(f"fleet: spawned {addrs}")
        log(f"fleet: 3 replicas up in {time.perf_counter() - t0:.1f} s "
            f"(spawn to first Status {', '.join(f'{x:.1f}' for x in spawn_s)}"
            f" s; {FLEET_LANES} lanes, max_len {SERVE['max_len']}, page "
            f"{SERVE['page_size']}, prefix cache on) [{card}]")
        direct.update({n: RemoteInferenceManager(a)
                       for n, a in addrs.items()})

        # (a) identity: one lone greedy request to each member
        ref, at_a = stream_direct(direct["a"], prompt, FLEET_STEPS)
        got_b, at_b = stream_direct(direct["b"], prompt, FLEET_STEPS)
        if got_b != ref or len(ref) != FLEET_STEPS:
            raise AssertionError("fleet: two replicas gave different "
                                 "tokens for the same lone request")
        log(f"fleet: (a) a lone greedy {FLEET_PROMPT} x {FLEET_STEPS} "
            f"request gives the same tokens on both replicas, bit for bit; "
            f"TTFT of each replica's first request {at_a[0] * 1e3:.1f} / "
            f"{at_b[0] * 1e3:.1f} ms [{card}]")

        # (b) affinity over a and b: 12 requests over 3 shared prefixes
        rsm = ReplicaSetMetrics()
        rec = ChromeTraceRecorder(process_name="chip-smoke fleet")
        rs = GenerationReplicaSet([addrs["a"], addrs["b"]], "lm",
                                  prefix_affinity=True,
                                  affinity_tokens=FLEET_PREFIX,
                                  metrics=rsm, trace=rec)
        sup_metrics = FleetMetrics()
        sup = FleetSupervisor(rs, prov, respawn_backoff_s=0.5,
                              probe_timeout_s=10.0, metrics=sup_metrics,
                              journal=journal)
        sup.probe()
        router = PrefixAffinityRouter()
        prefixes = [rng.integers(0, c["vocab"], (FLEET_PREFIX,)).astype(
            np.int32) for _ in range(3)]
        ttft_direct = []
        for _ in range(3):          # cold prompts of (b)'s length, direct
            _, at_d = stream_direct(direct["a"], rng.integers(
                0, c["vocab"], (FLEET_PREFIX + FLEET_SUFFIX,)).astype(
                    np.int32), FLEET_AFFINITY_STEPS)
            ttft_direct.append(at_d[0])
        hits0 = {a: v["prefix_hits"] for a, v in rs.poll_load().items()}
        homes, ttft_set = {}, []
        for r in range(4):
            for k, pre in enumerate(prefixes):
                p = np.concatenate([pre, rng.integers(
                    0, c["vocab"], (FLEET_SUFFIX,)).astype(np.int32)])
                home = router.ranked(prefix_digest(p, FLEET_PREFIX),
                                     [addrs["a"], addrs["b"]])[0]
                served0 = list(rs.served)
                t0 = time.perf_counter()
                n = 0
                for _ in rs.generate(p, FLEET_AFFINITY_STEPS, timeout=300):
                    if not n:
                        ttft_set.append((r, time.perf_counter() - t0))
                    n += 1
                went = [rs.addresses[i] for i, (x, y) in
                        enumerate(zip(served0, rs.served)) if y > x]
                if went != [home] or n != FLEET_AFFINITY_STEPS:
                    raise AssertionError(f"fleet: prefix {k} went to "
                                         f"{went}, its HRW home is {home}")
                homes[k] = home
        hits = {a: v["prefix_hits"] - hits0[a]
                for a, v in rs.poll_load().items()}
        for k, home in homes.items():
            if hits[home] <= 0:
                raise AssertionError(f"fleet: prefix {k}'s home {home} "
                                     f"shows no prefix-cache hits ({hits})")
        def med(v):
            v = sorted(v)
            return v[len(v) // 2] * 1e3
        ttft = dict(direct_cold_ms=med(ttft_direct),
                    set_cold_ms=med([t for r, t in ttft_set if r == 0]),
                    set_warm_ms=med([t for r, t in ttft_set if r > 0]))
        log(f"fleet: (b) 12 requests over 3 shared {FLEET_PREFIX}-token "
            f"prefixes each served on its HRW home (the parent's ranking); "
            f"prefix-cache hits per replica {hits}; TTFT median of "
            f"{FLEET_PREFIX + FLEET_SUFFIX}-token prompts: direct "
            f"{ttft['direct_cold_ms']:.1f} ms, through the set "
            f"{ttft['set_cold_ms']:.1f} ms on a prefix's first request, "
            f"{ttft['set_warm_ms']:.1f} ms once its home caches it "
            f"[{card}]")

        # (c) failover: the victim joins; a prompt whose home it is
        rs.add_replica(addrs["victim"])
        sup.probe()
        members = [addrs["a"], addrs["b"], addrs["victim"]]
        while True:
            p_c = rng.integers(0, c["vocab"], (FLEET_PROMPT,)).astype(
                np.int32)
            rank = router.ranked(prefix_digest(p_c, FLEET_PREFIX), members)
            if rank[0] == addrs["victim"]:
                break
        survivor = next(n for n in ("a", "b") if addrs[n] == rank[1])
        lone, _ = stream_direct(direct[survivor], p_c, FLEET_STEPS)
        t0 = time.perf_counter()
        got, at = [], []
        for t in rs.generate(p_c, FLEET_STEPS, timeout=300):
            got.append(int(t))
            at.append(time.perf_counter() - t0)
        with open(rec.save(os.path.join(tmp, "set_trace.json"))) as f:
            spans = json.load(f)["traceEvents"]
        resumed = [e["args"] for e in spans if e.get("name") == "attempt"
                   and e.get("args", {}).get("mode") == "resume"]
        wait_for(lambda: prov.is_alive(addrs["victim"]) is False,
                 "fleet: the victim's exit", 120)
        code = prov.exit_code(addrs["victim"])
        if (len(got) != FLEET_STEPS or rs.resumes != 1 or len(resumed) != 1
                or rs.tokens_replayed or code != chaos.KILL_EXIT_CODE):
            raise AssertionError(
                f"fleet: failover got {len(got)} tokens, resumes "
                f"{rs.resumes}, attempts {resumed}, replayed "
                f"{rs.tokens_replayed}, victim exit {code}")
        d = resumed[0]["resumed_from"]
        if not 0 < d <= FLEET_KILL_AT or got[:d] != lone[:d]:
            raise AssertionError(f"fleet: {d} tokens before the kill; equal "
                                 f"to the uninterrupted stream: "
                                 f"{got[:d] == lone[:d]}")
        gap = at[d] - at[d - 1]
        log(f"fleet: (c) the victim died with exit code {code} after "
            f"{d} tokens; the set resumed on {survivor} from token {d} "
            f"(one resume, 0 tokens replayed), {len(got)} tokens exactly "
            f"once, the {d} before the kill equal to the uninterrupted "
            f"stream; failover gap {gap * 1e3:.1f} ms [{card}]")

        # (d) supervision: the death by exit code, a respawn under backoff
        acts = sup.probe()
        if acts["deaths"] != [addrs["victim"]]:
            raise AssertionError(f"fleet: supervisor {acts}")
        t0 = time.perf_counter()
        respawned = []
        while not respawned:
            if time.perf_counter() - t0 > 300:
                raise AssertionError("fleet: no respawn")
            time.sleep(0.2)
            respawned = sup.probe()["respawns"]
        new = respawned[0]
        st = RemoteInferenceManager(new)
        try:
            st.server_status(timeout=30)
            again, _ = stream_direct(st, prompt, FLEET_STEPS)
        finally:
            st.close()
        if again != ref or rs.breaker_states()[new] != "closed":
            raise AssertionError("fleet: the respawned replica does not "
                                 "serve the lone request's tokens")
        evs = replay_journal(journal.path)
        death = [e for e in evs if e["kind"] == "replica_death"]
        if (sequence_gaps(evs) or len(death) != 1
                or death[0].get("exit_code") != chaos.KILL_EXIT_CODE
                or not any(e["kind"] == "replica_respawn" for e in evs)):
            raise AssertionError(f"fleet: journal {evs}")
        log(f"fleet: (d) the supervisor called the exit-{code} a death, "
            f"respawned the lineage as {new} after "
            f"{time.perf_counter() - t0:.1f} s (spawn to first Status "
            f"{spawn_s[-1]:.1f} s), which serves the lone request's tokens; "
            f"journal {len(evs)} events, no sequence gap [{card}]")

        # (e) scale-down: a stream on every member, then a drain
        holds = []
        for addr in rs.active_addresses():
            box = {"toks": [], "first": threading.Event()}

            def run(addr=addr, box=box):
                m = RemoteInferenceManager(addr)
                try:
                    for t in GenerateStreamClient(m, "lm").generate(
                            prompt, FLEET_HOLD_STEPS, timeout=300):
                        box["toks"].append(int(t))
                        box["first"].set()
                finally:
                    m.close()
            box["thread"] = threading.Thread(target=run, daemon=True)
            box["thread"].start()
            holds.append((addr, box))
        for _, box in holds:
            if not box["first"].wait(120):
                raise AssertionError("fleet: a held stream never started")
        asc = FleetAutoscaler(rs, prov, wait_signal=lambda: 0.0,
                              min_replicas=2, max_replicas=3, hold=1,
                              drain_timeout_s=120.0, journal=journal,
                              metrics=sup_metrics)
        t0 = time.perf_counter()
        if asc.evaluate() != "drain_started":
            raise AssertionError("fleet: no scale-down")
        victim2 = next(a for a, s in rs.breaker_states().items()
                       if s == "draining")
        at_drain = {a: len(b["toks"]) for a, b in holds}
        if not asc.wait_for_drain(240.0) or asc.scale_downs != 1:
            raise AssertionError("fleet: the drain did not retire")
        drain_s = time.perf_counter() - t0
        for _, box in holds:
            box["thread"].join(300)
        toks = {a: b["toks"] for a, b in holds}
        code2 = prov.exit_code(victim2)
        if (at_drain[victim2] >= FLEET_HOLD_STEPS
                or len(toks[victim2]) != FLEET_HOLD_STEPS or code2 != 0
                or len({tuple(v) for v in toks.values()}) != 1
                or sup.probe()["deaths"]):
            raise AssertionError(
                f"fleet: scale-down of {victim2}: {at_drain[victim2]} "
                f"tokens at the drain, {len(toks[victim2])} in the end, "
                f"exit {code2}")
        log(f"fleet: (e) the autoscaler drained {victim2} with its stream "
            f"at token {at_drain[victim2]}/{FLEET_HOLD_STEPS}; the stream "
            f"finished (the same tokens as the other members'), SIGTERM "
            f"exit 0; drain to retire {drain_s:.1f} s; the supervisor saw "
            f"no death [{card}]")
        evs = replay_journal(journal.path)
        if sequence_gaps(evs) or not any(e["kind"] == "scale_down"
                                         for e in evs):
            raise AssertionError(f"fleet: journal {evs}")
    finally:
        if rs is not None:
            rs.close()
        for m in direct.values():
            m.close()
        prov.close()
        journal.close()
        gpu.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    # kernel 1 per replica, from its Debug snapshot before it retired
    launches = 0
    for addr, s in snaps.items():
        if "lost" in s:
            log(f"fleet: {addr}: killed, its launches are lost")
            continue
        if (s["launches"] != c["n_layers"] * s["forward_steps"]
                or s["launches"] == 0
                or s["by_body"].get("wgmma") != s["launches"]):
            raise AssertionError(f"fleet: {addr}: ragged launches {s}")
        launches += s["launches"]
    log(f"fleet: ragged launches reported by the replicas {launches} = "
        f"{c['n_layers']} x their forward steps, all on wgmma: "
        + json.dumps(snaps) + f" [{card}]")
    log(f"fleet: peak nvidia-smi memory {gpu.peak} MiB [{card}]")
    # (c) after the kill, under the bf16 noise rule: the weights rebuilt
    # here from the replicas' seed, now that no replica holds a copy
    params = full_width_params(torch, c["n_layers"], torch.bfloat16, seed=0)
    note = same_or_bf16_noise(torch, params, kw, "failover stream", p_c,
                              lone, got)
    log("fleet: (c) the resumed tokens "
        + (note or "equal the uninterrupted stream bit for bit"))
    del params
    torch.cuda.empty_cache()
    log("fleet: " + json.dumps(dict(
        spawn_to_ready_s=spawn_s, failover_gap_ms=gap * 1e3,
        ttft=ttft, drain_s=drain_s,
        peak_memory_mib=gpu.peak, launches=launches)) + f" [{card}]")
    log(f"fleet: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 12
FAB_LANES = 4
FAB_PROMPT, FAB_STEPS = 1024, 32
FAB_AFFINITY = 256
FAB_SOCKET_OK, FAB_SOCKET_BIG = 16, 512   # one page; 32 pages (64 MiB)
FAB_KV_OFFLOAD = 2 << 30
FAB_SAMPLED = dict(temperature=0.8, seed=4321)
FAB_TTL_S, FAB_TICK_S = 1.0, 0.1
FAB_ROUTERS = 3
FAB_ELECT_PROMPT, FAB_ELECT_STEPS = 64, 8


class FetchRoute:
    """A fabric member as the fetcher's client.  With ``mode["socket"]``
    False the FetchKV request goes through the owner's server behavior in
    process (``Server.invoke``): a 1024-token pull is 134 MB, past the
    4 MiB a gRPC client receives by default.  With it True the request
    rides ``RemoteInferenceManager.fetch_kv`` over the socket.  Counts
    the fetches and keeps the errors the client saw; ``gate`` (if set)
    runs before an in-process fetch."""

    def __init__(self, address, servers, mode):
        self.address, self._servers, self._mode = address, servers, mode
        self.fetches, self.errors, self.gate = 0, [], None
        self._remote = None

    def fetch_kv(self, model_name, digest):
        from tpulab_torch.rpc.infer_service import (SERVICE_NAME,
                                                    RemoteInferenceManager)
        from tpulab_torch.rpc.protos import inference_pb2 as pb

        self.fetches += 1
        if self._mode["socket"]:
            if self._remote is None:
                self._remote = RemoteInferenceManager(self.address)
            try:
                return self._remote.fetch_kv(model_name, digest)
            except Exception as e:  # noqa: BLE001 - the status seen
                code = getattr(e, "code", None)
                self.errors.append(
                    f"{code().name}: {e.details()}" if callable(code)
                    else f"{type(e).__name__}: {str(e)[:300]}")
                raise
        if self.gate is not None:
            self.gate()
        resp = pb.FetchKVResponse.FromString(
            self._servers[self.address].invoke(
                f"/{SERVICE_NAME}/FetchKV", pb.FetchKVRequest(
                    model_name=model_name,
                    digest=bytes(digest)).SerializeToString()))
        if resp.status.code == pb.NOT_FOUND:
            return None
        if resp.status.code != pb.SUCCESS:
            raise RuntimeError(f"FetchKV {resp.status.code}: "
                               f"{resp.status.message}")
        return bytes(resp.kv_shipment)

    def close(self):
        if self._remote is not None:
            self._remote.close()


def exposition(registry):
    """The port's Prometheus text of ``registry`` as {sample: value}."""
    from tpulab_torch.utils.metrics import generate_latest

    out = {}
    for line in generate_latest(registry).decode().splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def fab_stream(addr, prompt, steps, sampling=None):
    """One Generate stream over the socket: tokens and TTFT (s)."""
    from tpulab_torch.rpc.infer_service import (GenerateStreamClient,
                                                RemoteInferenceManager)

    kw = {}
    if sampling:
        kw = dict(temperature=sampling["temperature"], device_sampling=True,
                  seed=sampling["seed"])
    mgr = RemoteInferenceManager(addr)
    try:
        t0 = time.perf_counter()
        toks, ttft = [], None
        for t in GenerateStreamClient(mgr, "lm").generate(
                prompt, steps, timeout=300, **kw):
            if ttft is None:
                ttft = time.perf_counter() - t0
            toks.append(int(t))
        return toks, ttft
    finally:
        mgr.close()


def homed(rng, router, n, members, home, vocab):
    """A random ``n``-token prompt whose HRW home among ``members`` is
    ``home``."""
    import numpy as np

    from tpulab_torch.fleet import prefix_digest

    while True:
        p = rng.integers(0, vocab, (n,)).astype(np.int32)
        if router.ranked(prefix_digest(p, FAB_AFFINITY), members)[0] == home:
            return p


def phase_fabric(torch, card):
    """The fleet KV fabric and the multi-router control plane at full
    width (module docstring, phase 12).  Returns the phase's kernel 1 and
    kernel 2 launches."""
    import gc
    import importlib.util
    import re
    import shutil
    import tempfile
    import threading
    from types import SimpleNamespace

    import numpy as np

    import tpulab_torch
    from tpulab_torch.disagg import prompt_digest
    from tpulab_torch.engine.paged import ContinuousBatcher, SamplingParams
    from tpulab_torch.fleet import (FileLeaseBackend, FleetAutoscaler,
                                    FleetController, FleetObserver,
                                    FleetSupervisor, InProcessReplicaProvider,
                                    LeaderElector, PrefixAffinityRouter,
                                    StaleLeaderError, membership_snapshot)
    from tpulab_torch.kvfabric import KVFabric
    from tpulab_torch.obs import (EventJournal, SLOTracker, replay_journal,
                                  sequence_gaps)
    from tpulab_torch.ops.flash_attention import flash_attention
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention
    from tpulab_torch.rpc.infer_service import RemoteInferenceManager
    from tpulab_torch.rpc.replica import GenerationReplicaSet
    from tpulab_torch.utils.metrics import (FederationMetrics, FleetMetrics,
                                            KVFabricMetrics)

    c = LLAMA3_8B
    t_phase = time.perf_counter()
    if importlib.util.find_spec("grpc") is None:
        raise AssertionError("fabric: grpc is not installed: the replicas "
                             "serve on loopback sockets")
    gc.collect()
    torch.cuda.empty_cache()
    gpu = GpuMemory()
    t0 = time.perf_counter()
    params = full_width_params(torch, c["n_layers"], torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    kw = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=torch.bfloat16)
    cb_kw = dict(kw, lanes=FAB_LANES, max_len=SERVE["max_len"],
                 page_size=SERVE["page_size"],
                 decode_block=SERVE["decode_block"], prefill_flash=True,
                 **SPLIT)
    log(f"fabric: one Llama-3-8B-width bf16 tree (seed 0) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(0)} bytes allocated [{card}]")

    class TimedFabric(KVFabric):
        """The fabric with each adopted pull's seconds and bytes kept."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.pulled = []

        def pull(self, *a, **k):
            t = time.perf_counter()
            got = super().pull(*a, **k)
            if got is not None:
                self.pulled.append((time.perf_counter() - t, got.nbytes,
                                    got.coalesced))
            return got

    members, servers, mode = [], {}, {"socket": False}
    routes = {}

    def connect(addr):
        routes[addr] = FetchRoute(addr, servers, mode)
        return routes[addr]

    class LateFleet:
        """The Debug ``fleet`` handle, bound to a controller once the
        replicas' addresses exist."""
        ctl = None

        def snapshot(self):
            return self.ctl.snapshot()

    batchers = {}                 # name -> batcher, every one of the phase
    fab_metrics = KVFabricMetrics()

    def replica(name, publish=True, fabric=True):
        cb = ContinuousBatcher(params, kv_offload=FAB_KV_OFFLOAD,
                               kv_publish=publish, **cb_kw)
        batchers[name] = cb
        fab = handle = None
        if fabric:
            fab = TimedFabric("pending", lambda: list(members), connect,
                              PrefixAffinityRouter(
                                  affinity_tokens=FAB_AFFINITY),
                              cost_gate=False, metrics=fab_metrics)
            handle = LateFleet()
        mgr = tpulab_torch.InferenceManager(max_exec_concurrency=1)
        mgr.serve(port=0, generation_engines={"lm": cb}, kvfabric=fab,
                  fleet=handle)
        addr = f"127.0.0.1:{mgr.server.bound_port}"
        servers[addr] = mgr.server
        if fab is not None:
            fab.self_key = addr
        return SimpleNamespace(name=name, cb=cb, mgr=mgr, fab=fab,
                               fleet=handle, addr=addr)

    tmp = tempfile.mkdtemp(prefix="chip-smoke-fabric-")
    a = b = spare = None
    closed = set()               # replicas already shut down
    made = []                    # the autoscaler's replica, until spawned
    ctls, journals, rss, provs = [], [], [], []
    checks = []                  # (label, prompt, want, got, sampling)
    try:
        a, b = replica("A"), replica("B")
        members.extend([a.addr, b.addr])
        router = PrefixAffinityRouter(affinity_tokens=FAB_AFFINITY)
        rng = np.random.default_rng(67)
        for fn in (ragged_paged_attention, flash_attention):
            fn.launches = 0
            fn.launches_by_body = dict.fromkeys(fn.launches_by_body, 0)
        steps0 = {n: (cb.forward_steps, cb.prefill_forwards)
                  for n, cb in batchers.items()}

        def published(cb, prompt):
            wait_for(lambda: ("fab", prompt_digest(prompt))
                     in cb.kv_offload.store, "fabric: the publish", 120)

        def snap():
            return b.fab.snapshot()

        # (a) a full-width pull, in process
        p = homed(rng, router, FAB_PROMPT, members, a.addr, c["vocab"])
        ref_g, ttft_a = fab_stream(a.addr, p, FAB_STEPS)
        ref_s, _ = fab_stream(a.addr, p, FAB_STEPS, FAB_SAMPLED)
        published(a.cb, p)
        if a.cb.kv_publishes != 1 or a.cb.prefill_forwards != 2:
            raise AssertionError(f"fabric: A published {a.cb.kv_publishes}"
                                 f", prefilled {a.cb.prefill_forwards}")
        fl0 = flash_attention.launches
        got_g, ttft_pull = fab_stream(b.addr, p, FAB_STEPS)
        got_s, _ = fab_stream(b.addr, p, FAB_STEPS, FAB_SAMPLED)
        s = snap()
        if (b.cb.prompt_fills or b.cb.prefill_dispatches
                or flash_attention.launches != fl0 or s["pulls"] != 2
                or s["degrades"] or s["recompute_tokens_saved"]
                != 2 * FAB_PROMPT or routes[a.addr].fetches != 2):
            raise AssertionError(f"fabric: (a) B prefilled "
                                 f"{b.cb.prompt_fills}, flash "
                                 f"{flash_attention.launches - fl0}, {s}")
        checks += [("pulled greedy stream", p, ref_g, got_g, None),
                   ("pulled device-sampled stream", p, ref_s, got_s,
                    SamplingParams(device=True, **FAB_SAMPLED))]
        pull_s = [x[0] for x in b.fab.pulled]
        pull_gbps = [x[1] / x[0] / 1e9 for x in b.fab.pulled]
        fetch = exposition(fab_metrics.registry)
        log(f"fabric: (a) B pulled the {FAB_PROMPT}-token prompt homed on "
            f"A twice (greedy, device-sampled) through FetchKV in process: "
            f"0 prefills on B, kernel 2 unmoved, pulls 2, degrades 0, "
            f"{s['recompute_tokens_saved']} tokens saved; "
            f"{b.fab.pulled[0][1]} wire bytes a pull; pull "
            f"{', '.join(f'{x * 1e3:.1f}' for x in pull_s)} ms "
            f"({', '.join(f'{x:.3f}' for x in pull_gbps)} GB/s), the fetch "
            f"part {fetch['tpulab_kvfabric_pull_seconds_sum'] / 2 * 1e3:.1f}"
            f" ms mean; TTFT "
            f"pulled {ttft_pull * 1e3:.1f} ms (A's first request, its "
            f"first forwards in the process: {ttft_a * 1e3:.1f} ms) "
            f"[{card}]")

        # single-flight: four B requests for one new A-homed prompt
        p_sf = homed(rng, router, FAB_PROMPT, members, a.addr, c["vocab"])
        ref_sf, _ = fab_stream(a.addr, p_sf, FAB_STEPS)
        published(a.cb, p_sf)
        co0, f0 = s["coalesced"], routes[a.addr].fetches

        def hold():
            wait_for(lambda: snap()["coalesced"] >= co0 + 3,
                     "fabric: four concurrent pulls", 120)
        routes[a.addr].gate = hold
        outs = svc_threads([lambda: fab_stream(b.addr, p_sf, FAB_STEPS)
                            for _ in range(4)])
        routes[a.addr].gate = None
        s = snap()
        if (routes[a.addr].fetches - f0 != 1 or s["coalesced"] - co0 != 3
                or s["pulls"] != 6 or s["degrades"] or b.cb.prompt_fills):
            raise AssertionError(f"fabric: single-flight {s}, fetches "
                                 f"{routes[a.addr].fetches - f0}")
        checks += [(f"single-flight stream {i}", p_sf, ref_sf, o[0], None)
                   for i, o in enumerate(outs)]
        log(f"fabric: (a) four concurrent B requests for one new A-homed "
            f"{FAB_PROMPT}-token prompt made 1 fetch (3 coalesced), four "
            f"adoptions, 0 prefills on B [{card}]")

        # (b) over the socket
        mode["socket"] = True
        p16 = homed(rng, router, FAB_SOCKET_OK, members, a.addr, c["vocab"])
        ref16, _ = fab_stream(a.addr, p16, FAB_STEPS)
        published(a.cb, p16)
        fl0, n0 = flash_attention.launches, len(b.fab.pulled)
        got16, _ = fab_stream(b.addr, p16, FAB_STEPS)
        s = snap()
        if (b.cb.prompt_fills or flash_attention.launches != fl0
                or s["pulls"] != 7 or s["degrades"]
                or len(b.fab.pulled) != n0 + 1):
            raise AssertionError(f"fabric: (b) socket pull {s}, "
                                 f"{routes[a.addr].errors}")
        checks.append(("socket-pulled stream", p16, ref16, got16, None))
        sock_s, sock_bytes, _ = b.fab.pulled[-1]
        p512 = homed(rng, router, FAB_SOCKET_BIG, members, a.addr,
                     c["vocab"])
        ref512, _ = fab_stream(a.addr, p512, FAB_STEPS)
        published(a.cb, p512)
        fl0, pf0 = flash_attention.launches, b.cb.prefill_forwards
        got512, _ = fab_stream(b.addr, p512, FAB_STEPS)
        s = snap()
        if (s["degrades"] != 1 or s["pulls"] != 7
                or b.cb.prefill_forwards != pf0 + 1
                or flash_attention.launches != fl0 + c["n_layers"]
                or not routes[a.addr].errors):
            raise AssertionError(f"fabric: (b) the {FAB_SOCKET_BIG}-token "
                                 f"socket pull {s}")
        checks.append(("degraded stream", p512, ref512, got512, None))
        log(f"fabric: (b) over the socket: the {FAB_SOCKET_OK}-token "
            f"prompt ({sock_bytes} wire bytes) pulled in "
            f"{sock_s * 1e3:.1f} ms, 0 prefills on B; the "
            f"{FAB_SOCKET_BIG}-token prompt degraded to B's local prefill "
            f"(degrades 1, kernel 2 launched {c['n_layers']} times on B); "
            f"the client saw: {routes[a.addr].errors[-1]} [{card}]")
        # B's own cold prefill of a B-homed prompt, for the comparison
        pb_ = homed(rng, router, FAB_PROMPT, members, b.addr, c["vocab"])
        _, ttft_cold = fab_stream(b.addr, pb_, FAB_STEPS)
        gate_fab = KVFabric(b.addr, members, connect, router)
        gate_fab.fetch_bytes_per_s = b.fab.fetch_bytes_per_s
        skip = gate_fab._gate_skips(FAB_PROMPT, b.cb)
        log(f"fabric: B's cold prefill of a B-homed {FAB_PROMPT}-token "
            f"prompt: TTFT {ttft_cold * 1e3:.1f} ms against "
            f"{ttft_pull * 1e3:.1f} ms pulled; B's prefill EWMA "
            f"{b.cb.prefill_ewma_tok_s:.0f} tok/s, fetch EWMA "
            f"{b.fab.fetch_bytes_per_s / 1e9:.3f} GB/s: the cost gate, "
            f"armed, would {'skip' if skip else 'take'} this pull (this "
            f"phase runs with the gate off to measure the pull) [{card}]")

        # (c) election: three routers over one lease
        lease = os.path.join(tmp, "lease")
        spare = replica("C", publish=False, fabric=False)
        made.append(spare)
        scaled = []

        def factory():
            r = made.pop()            # built before the controllers start
            return r.mgr, r.cb

        evals = []

        class Autoscaler(FleetAutoscaler):
            """Records, at each decision, who held the lease."""

            def evaluate(self):
                evals.append((self.node, self.backend.holder(),
                              self.elector.fencing_token))
                out = super().evaluate()
                if out == "scale_up":
                    scaled.append(self.node)
                return out

        def wait_signal():
            return 0.2 if scaled else 10.0   # idle between the thresholds

        for i in range(FAB_ROUTERS):
            node = f"router-{i}"
            j = EventJournal(os.path.join(tmp, f"{node}.jsonl"), node=node)
            rs = GenerationReplicaSet([a.addr, b.addr], "lm",
                                      prefix_affinity=True,
                                      affinity_tokens=FAB_AFFINITY)
            prov = InProcessReplicaProvider(factory)
            fm = FleetMetrics()
            el = LeaderElector(FileLeaseBackend(lease), node_id=node,
                               ttl_s=FAB_TTL_S, journal=j, metrics=fm)
            asc = Autoscaler(rs, prov, wait_signal=wait_signal, hold=1,
                             min_replicas=2, max_replicas=3, journal=j)
            asc.node, asc.backend, asc.elector = node, el.backend, el
            ctls.append(FleetController(
                rs, el, supervisor=FleetSupervisor(rs, prov, journal=j),
                autoscaler=asc, metrics=fm, journal=j))
            journals.append(j)
            rss.append(rs)
            provs.append(prov)
        a.fleet.ctl, b.fleet.ctl = ctls[1], ctls[2]
        if not ctls[0].tick()["leader"]:
            raise AssertionError("fabric: router-0 did not lead")
        samples, stopped = [], set()
        watching = threading.Event()

        def watch():
            while not watching.wait(0.01):
                samples.append(sum(1 for i, ctl in enumerate(ctls)
                                   if i not in stopped
                                   and ctl.elector.is_leader))
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        for ctl in ctls:
            ctl.start(interval_s=FAB_TICK_S)
        wait_for(lambda: len(scaled) == 1 and all(
            spare.addr in rs.addresses for rs in rss),
            "fabric: the scale-up reaching every router", 60)
        three = [a.addr, b.addr, spare.addr]
        prompts = [homed(rng, router, FAB_ELECT_PROMPT, three, home,
                         c["vocab"]) for home in (spare.addr, b.addr)]
        served = svc_threads([
            (lambda rs=rs, q=q: [int(t) for t in rs.generate(
                q, FAB_ELECT_STEPS, timeout=300)])
            for rs in rss for q in prompts])
        if any(len(x) != FAB_ELECT_STEPS for x in served):
            raise AssertionError("fabric: (c) routed traffic")
        before = list(samples)
        old_token = ctls[0].elector.fencing_token
        t_stop = time.perf_counter()
        stopped.add(0)
        ctls[0].stop(resign=False)
        wait_for(lambda: any(ctls[i].elector.is_leader for i in (1, 2)),
                 "fabric: the takeover", 10)
        takeover = time.perf_counter() - t_stop
        new = next(i for i in (1, 2) if ctls[i].elector.is_leader)
        new_token = ctls[new].elector.fencing_token
        try:
            ctls[0].elector.backend.publish_membership(
                membership_snapshot(rss[0]), old_token)
            fenced = False
        except StaleLeaderError:
            fenced = True
        lost = ctls[0].tick()

        def fleet_docs():
            docs = []
            for addr in (a.addr, b.addr):
                m = RemoteInferenceManager(addr)
                try:
                    docs.append(m.debugz("lm", timeout=30)["fleet"])
                finally:
                    m.close()
            return docs
        wait_for(lambda: all((d.get("membership") or {}).get("token")
                             == new_token for d in fleet_docs()),
                 "fabric: the Debug fleet sections", 10)
        docs = fleet_docs()
        after = samples[len(before):]
        for ctl in ctls[1:]:
            ctl.stop()
        watching.set()
        watcher.join(10)
        leaders = [d["election"]["node_id"] for d in docs
                   if d["election"]["is_leader"]]
        wrong = [e for e in evals if e[1] != (e[0], e[2])]
        evs = [replay_journal(j.path) for j in journals]
        acq = sorted((e for es in evs for e in es
                      if e["kind"] == "elect_acquire"),
                     key=lambda e: e["wall_time"])
        tokens = [e["token"] for e in acq]
        if (before.count(1) != len(before) or max(after + [0]) > 1
                or after[-1:] != [1] or wrong or not evals
                or takeover > FAB_TTL_S + 2 * FAB_TICK_S
                or new_token <= old_token or not fenced
                or lost["leader"] or len(scaled) != 1
                or leaders != [f"router-{new}"]
                or len({(d["membership"]["token"],
                         tuple(d["membership"]["members"]))
                        for d in docs}) != 1
                or any(sequence_gaps(e) for e in evs)
                or sequence_gaps([e for es in evs for e in es])
                or tokens != sorted(set(tokens))):
            raise AssertionError(
                f"fabric: (c) leaders sampled {sorted(set(before))} / "
                f"{sorted(set(after))}, wrong deciders {wrong[:3]}, "
                f"takeover {takeover:.3f} s, tokens {old_token} -> "
                f"{new_token} ({tokens}), fenced {fenced}, docs {docs}")
        log(f"fabric: (c) three routers over one lease (TTL {FAB_TTL_S} s, "
            f"tick {FAB_TICK_S} s): exactly one leader in "
            f"{len(before)} samples; {len(evals)} autoscaler decisions, "
            f"each by the lease's holder; one scale-up by {scaled[0]} "
            f"(the third replica reached all three routers); "
            f"{sum(len(x) for x in served)} tokens routed through the "
            f"three sets; router-0 stopped without resigning: router-{new}"
            f" led {takeover:.3f} s later with token {new_token} > "
            f"{old_token}, router-0's publish raised StaleLeaderError; "
            f"both replicas' Debug fleet sections name router-{new} and "
            f"membership token {new_token} (seq "
            f"{[d['membership']['seq'] for d in docs]}); journals "
            f"{[len(e) for e in evs]} events, no sequence gap [{card}]")

        # (d) federation
        fed = FederationMetrics()
        obs = FleetObserver(rss[new], controller=ctls[new], slo=SLOTracker(),
                            metrics=fed)
        try:
            scrapes = [obs.fleetz() for _ in range(5)]
            z = scrapes[-1]
            rep = z["replicas"]
            if (set(rep) != {a.addr, b.addr, spare.addr}
                    or not all(d["up"] and "lanes" in d and "kernels" in d
                               for d in rep.values())
                    or "election" not in z["control"] or "slo" not in z):
                raise AssertionError(f"fabric: (d) fleetz {z}")
            fams = exposition(fed.registry)
            if (fams["tpulab_fed_replicas"] != 3
                    or fams[f'tpulab_fed_replica_up{{replica="{a.addr}"}}']
                    != 1):
                raise AssertionError(f"fabric: (d) exposition {fams}")
            scrape_ms = sorted(s_["scrape_s"] for s_ in scrapes)[2] * 1e3
            log("fabric: (d) fleetz over three replicas: " + json.dumps({
                n: {k: rep[addr][k] for k in ("lanes", "free_kv_pages",
                                              "free_hbm_bytes")}
                for n, addr in (("A", a.addr), ("B", b.addr),
                                ("C", spare.addr))})
                + f"; each with its kernels section; the controller's "
                f"state (router-{new} leading) and the SLO document; "
                f"scrape median {scrape_ms:.1f} ms of 5; the federation "
                f"exposition parses ({len(fams)} samples) [{card}]")
            p_d = homed(rng, router, FAB_SOCKET_BIG, members, a.addr,
                        c["vocab"])
            ref_d, _ = fab_stream(a.addr, p_d, FAB_STEPS)
            published(a.cb, p_d)
            closed.add("A")
            a.mgr.shutdown()
            a.cb.shutdown()
            z = obs.fleetz()
            if z["replicas"][a.addr].get("up") is not False:
                raise AssertionError(f"fabric: (d) dead A: {z}")
            s0, pf0 = snap(), b.cb.prefill_forwards
            got_d, _ = fab_stream(b.addr, p_d, FAB_STEPS)
            s = snap()
            if (s["degrades"] != s0["degrades"] + 1
                    or s["pulls"] != s0["pulls"]
                    or b.cb.prefill_forwards != pf0 + 1):
                raise AssertionError(f"fabric: (d) after A's death {s}")
            checks.append(("stream after the owner's death", p_d, ref_d,
                           got_d, None))
            err = z["replicas"][a.addr]["error"]
            code = re.search(r"StatusCode\.(\w+)", err)
            log(f"fabric: (d) A shut down: fleetz reports it as data (up "
                f"false, {code.group(1) if code else err[:120]}); a B request "
                f"homed on A degraded to B's local prefill (degrades "
                f"{s['degrades']}) [{card}]")
        finally:
            obs.close()
        # the phase's kernel counts, before the noise rule replays
        fwd = {n: cb.forward_steps - steps0.get(n, (0, 0))[0]
               for n, cb in batchers.items()}
        pre = {n: cb.prefill_forwards - steps0.get(n, (0, 0))[1]
               for n, cb in batchers.items()}
        ragged = ragged_paged_attention.launches
        flash = flash_attention.launches
        if (ragged != c["n_layers"] * sum(fwd.values()) or not ragged
                or flash != c["n_layers"] * sum(pre.values())
                or pre["A"] == 0 or fwd["C"] == 0
                or ragged_paged_attention.launches_by_body.get("wgmma")
                != ragged):
            raise AssertionError(f"fabric: kernel 1 {ragged} for forward "
                                 f"steps {fwd}, kernel 2 {flash} for "
                                 f"prefill forwards {pre}")
        log(f"fabric: kernel 1 launches {ragged} = {c['n_layers']} x the "
            f"forward steps of A, B and C {fwd}, all on wgmma; kernel 2 "
            f"{flash} = {c['n_layers']} x the prefill forwards {pre} (B's "
            f"only the degraded and B-homed prompts) [{card}]")
    finally:
        for ctl in ctls:
            ctl.stop(resign=False)
        for rs in rss:
            rs.close()
        for prov in provs:
            prov.close()
        for r in routes.values():
            r.close()
        for j in journals:
            j.close()
        if not made:
            closed.add("C")      # spawned: its provider retired it
        for r in (a, b, spare):
            if r is not None:
                if r.fab is not None:
                    r.fab.close()
                if r.name not in closed:
                    r.mgr.shutdown()
                    r.cb.shutdown()
        gpu.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    notes = []
    for label, prompt, want, got, sp in checks:
        note = same_or_bf16_noise(torch, params, kw, label, prompt, want,
                                  got, sp)
        if note:
            notes.append(note)
    log("fabric: every stream equals its reference bit for bit"
        + (f", but: {'; '.join(notes)}" if notes else "") + f" [{card}]")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fabric: peak nvidia-smi memory {gpu.peak} MiB [{card}]")
    log(f"fabric: phase {time.perf_counter() - t_phase:.1f} s")
    return dict(ragged=ragged, flash=flash)


# ---------------------------------------------------------------- phase 13
# Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1 config.json: d 4096,
# 32 heads, SwiGLU experts of 14336, 8 experts, top-2, vocab 32000) on
# tpulab's MoE block (GELU experts, a fused (d, 3d) wqkv); depth cut to 2
PAR_MOE = dict(vocab=32000, d_model=4096, n_heads=32, n_layers=2,
               d_ff=14336, n_experts=8, top_k=2, seq_len=512)
PAR_F32 = dict(n_layers=2, batch=2, seq=256, steps=4, lr=5e-2)
PAR_BF16 = dict(n_layers=32, batch=1, seq=2048, steps=3, lr=1e-3)
PAR_CKPT = dict(n_layers=2, batch=2, seq=256, lr=1e-3)
# f32 gradients through the flash kernel's f32 body and its blockwise
# backward against dense attention's autograd: both sum in f32 in other
# orders (~1e-6 relative a sum); per leaf, max |g_flash - g_dense| over
# max |g_dense|
PAR_GRAD_TOL = 1e-4
PAR_LOSS_RTOL = 1e-5


def par_batch(torch, vocab, batch, seq, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, vocab, (batch, seq), generator=gen)
            for k in ("tokens", "targets")}


def par_leaves(tree, prefix=""):
    """(path, leaf) pairs of a tree, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from par_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def par_ms(torch, fn, n=3):
    """Mean synchronized wall ms of ``fn()`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_parallel(torch, card):
    """``tpulab_torch.parallel`` on an NCCL process group of world size 1
    (module docstring, phase 13).  Returns kernel 2's launches: the
    full-depth train step's, then (a)'s and (c)'s."""
    import gc
    import shutil
    import subprocess
    import tempfile
    from functools import partial

    import numpy as np
    import torch.distributed as dist

    from tpulab_torch.engine.inference_manager import InferenceManager
    from tpulab_torch.models.transformer import (causal_attention,
                                                 dense_attention,
                                                 make_moe_transformer,
                                                 transformer_apply)
    from tpulab_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_reference,
                                                  make_flash_attention_fn)
    from tpulab_torch.ops.paged_attention import paged_decode_attention
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention
    from tpulab_torch.parallel import (MultiDeviceDispatcher,
                                       TrainCheckpointer, abstract_like,
                                       make_expert_parallel_ffn, make_mesh,
                                       make_pipeline,
                                       make_sharded_train_step, multihost,
                                       ring_attention, ulysses_attention)
    from tpulab_torch.parallel.mesh import mesh_shape
    from tpulab_torch.parallel.moe import init_moe_params, moe_ffn
    from tpulab_torch.parallel.pipeline import stack_stage_params
    from tpulab_torch.parallel.ring_attention import _ring_attn_local
    from tpulab_torch.parallel.sharding import full_tensor, map_tree
    from tpulab_torch.parallel.training import _nll, cross_entropy_loss

    c = LLAMA3_8B
    bf16, f32 = torch.bfloat16, torch.float32
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="parallel-")
    flash_total = 0
    try:
        t0 = time.perf_counter()
        multihost.initialize(f"file://{tmp}/store", 1, 0)
        mesh = make_mesh({"data": 1, "model": 1})
        log(f"parallel: process group {dist.get_backend()} world size "
            f"{dist.get_world_size()} over a FileStore, mesh "
            f"{mesh_shape(mesh)} ({mesh.device_type}) in "
            f"{time.perf_counter() - t0:.3f} s [{card}]")
        if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
            raise AssertionError("parallel: the card's group is not NCCL")

        def kw(n_layers, dtype, attention_fn):
            return dict(n_heads=c["n_heads"], n_layers=n_layers,
                        n_kv_heads=c["n_kv_heads"],
                        rope_theta=c["rope_theta"], compute_dtype=dtype,
                        attention_fn=attention_fn)

        def on_card(batch):
            return {k: v.cuda() for k, v in batch.items()}

        # (a) f32, full width, 2 layers: flash (the f32 "fma" body and the
        # blockwise backward) against dense attention, then 4 steps
        a = PAR_F32
        flash_fn = make_flash_attention_fn()
        apply_flash = partial(transformer_apply,
                              **kw(a["n_layers"], f32, flash_fn))
        apply_dense = partial(transformer_apply,
                              **kw(a["n_layers"], f32, causal_attention))
        params = full_width_params(torch, a["n_layers"], f32, seed=0)
        batch = par_batch(torch, c["vocab"], a["batch"], a["seq"], 13)
        f0 = flash_attention.launches
        losses, grads = {}, {}
        for name, fn in (("flash", apply_flash), ("dense", apply_dense)):
            leaves = map_tree(lambda t: t.detach().requires_grad_(True),
                              params)
            loss = cross_entropy_loss(fn, leaves, on_card(batch))
            loss.backward()
            losses[name] = float(loss.detach())
            grads[name] = {k: v.grad for k, v in par_leaves(leaves)}
            del leaves, loss
        rel = abs(losses["flash"] - losses["dense"]) / abs(losses["dense"])
        worst = max(((grads["flash"][k] - g).abs().max()
                     / g.abs().max().clamp_min(1e-30)).item()
                    for k, g in grads["dense"].items())
        log(f"parallel: (a) f32 d {c['d_model']} x {a['n_layers']} layers, "
            f"B {a['batch']} T {a['seq']}: loss flash {losses['flash']:.7f} "
            f"dense {losses['dense']:.7f} (rel {rel:.2e}, tol "
            f"{PAR_LOSS_RTOL:g}); gradients: worst leaf max |diff| / max "
            f"|g| = {worst:.2e} (tol {PAR_GRAD_TOL:g}) over "
            f"{len(grads['dense'])} leaves")
        if not (rel <= PAR_LOSS_RTOL and worst <= PAR_GRAD_TOL):
            raise AssertionError("parallel (a): flash and dense disagree")
        del grads
        steps = {}
        for name, fn in (("flash", apply_flash), ("dense", apply_dense)):
            step, sp = make_sharded_train_step(fn, params, mesh,
                                               learning_rate=a["lr"])
            steps[name] = [float(step(sp, batch)[1])]
            if name == "flash":
                for _ in range(a["steps"] - 1):
                    steps[name].append(float(step(sp, batch)[1]))
            del step, sp
        first = abs(steps["flash"][0] - steps["dense"][0]) \
            / abs(steps["dense"][0])
        if not (first <= PAR_LOSS_RTOL
                and abs(steps["flash"][0] - losses["flash"])
                <= PAR_LOSS_RTOL * abs(losses["flash"])):
            raise AssertionError(f"parallel (a): step losses {steps} "
                                 f"against {losses}")
        if not steps["flash"][-1] < steps["flash"][0]:
            raise AssertionError(f"parallel (a): the loss did not fall: "
                                 f"{steps['flash']}")
        a_launches = flash_attention.launches - f0
        log(f"parallel: (a) the step, flash vs dense, step 1 loss rel "
            f"{first:.2e}; {a['steps']} flash steps at lr {a['lr']:g}: "
            f"{['%.6f' % x for x in steps['flash']]} (falls); kernel 2 "
            f"launches {a_launches}")
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # (b) bf16, full width and depth: the main path of this slice
        b = PAR_BF16
        params = full_width_params(torch, b["n_layers"], bf16, seed=0)
        step, sp = make_sharded_train_step(
            partial(transformer_apply, **kw(b["n_layers"], bf16, flash_fn)),
            params, mesh, learning_rate=b["lr"])
        del params
        gc.collect()
        torch.cuda.empty_cache()
        batch = on_card(par_batch(torch, c["vocab"], b["batch"], b["seq"],
                                  14))
        n_tok = batch["tokens"].numel()
        # per-token NLL on the step's weights before step 1 moves them:
        # each bf16 forward's mean |NLL - NLL of the f32 dense forward|
        # over the tokens; the flash forward (the step's) must stay within
        # twice the dense bf16 forward's, and a planted fault (flash
        # without the causal mask) must not
        with torch.no_grad():
            local = map_tree(lambda t: t.to_local(), sp)

            def per_token(dtype, fn):
                return _nll(partial(transformer_apply, **kw(
                    b["n_layers"], dtype, fn)), local, batch["tokens"],
                    batch["targets"])
            ref = per_token(f32, causal_attention)
            flash_nll = per_token(bf16, flash_fn)
            dev = {name: float((nl - ref).abs().mean()) for name, nl in (
                ("dense", per_token(bf16, causal_attention)),
                ("flash", flash_nll),
                ("planted", per_token(bf16, make_flash_attention_fn(
                    causal=False))))}
            flash_loss = float(flash_nll.mean())
            del local, ref, flash_nll
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts0 = (ragged_paged_attention.launches,
                   paged_decode_attention.launches)
        flash_attention.launches = 0
        step_ms, step_losses = [], []
        for _ in range(b["steps"]):
            t0 = time.perf_counter()
            _, loss = step(sp, batch)
            step_losses.append(float(loss))     # synchronizes
            step_ms.append((time.perf_counter() - t0) * 1e3)
        b_launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        want = b["n_layers"] * b["steps"]
        if b_launches != want or counts0 != (
                ragged_paged_attention.launches,
                paged_decode_attention.launches):
            raise AssertionError(f"parallel (b): kernel 2 launches "
                                 f"{b_launches}, want {want} (forward "
                                 "only), and no other kernel")
        if not all(math.isfinite(x) for x in step_losses):
            raise AssertionError(f"parallel (b): losses {step_losses}")
        gap = abs(step_losses[0] - flash_loss)
        if not (dev["flash"] <= 2 * dev["dense"] < dev["planted"]
                and gap <= PAR_LOSS_RTOL * abs(flash_loss)):
            raise AssertionError(
                f"parallel (b): mean per-token |NLL - NLL f32 dense| "
                f"{dev} (flash within 2 x dense, planted beyond); step 1 "
                f"loss {step_losses[0]} against the flash forward's "
                f"{flash_loss}")
        mean_ms = sum(step_ms) / len(step_ms)
        # the step's least time: bf16 matmuls (forward + backward: 6
        # FLOPs a weight a token) and the flash forward (4 B H D a causal
        # pair) at the bf16 peak; the f32 vocab head and the plain f32
        # attention backward (10 B H D a causal pair) at the f32 peak
        d, hd = c["d_model"], c["d_model"] // c["n_heads"]
        w_layer = d * (c["n_heads"] + 2 * c["n_kv_heads"]) * hd + d * d \
            + 3 * d * c["d_ff"]
        pairs = b["batch"] * b["seq"] * (b["seq"] + 1) // 2
        attn = c["n_heads"] * hd * pairs * b["n_layers"]
        ops_bf16 = 6 * n_tok * w_layer * b["n_layers"] + 4 * attn
        ops_f32 = 6 * n_tok * d * c["vocab"] + 10 * attn
        bound_ms = (ops_bf16 / PEAK_OPS_S["bf16"]
                    + ops_f32 / PEAK_OPS_S["f32"]) * 1e3
        log(f"parallel: (b) bf16 Llama-3-8B width x {b['n_layers']} layers, "
            f"B {b['batch']} T {b['seq']}, flash: step ms "
            f"{['%.1f' % x for x in step_ms]} (mean {mean_ms:.1f}), "
            f"{n_tok / (mean_ms / 1e3):.1f} tokens/s, max_memory_allocated "
            f"{peak} B ({peak / 1e9:.2f} GB); losses "
            f"{['%.6f' % x for x in step_losses]}; kernel 2 launches "
            f"{b_launches} == {b['n_layers']} x {b['steps']} (the backward "
            f"launches none); the step's operation bound {bound_ms:.4f} ms "
            f"({ops_bf16:.3e} bf16 at 989 TFLOP/s + {ops_f32:.3e} f32 at "
            f"67) [{card}]")
        log(f"parallel: (b) mean per-token |NLL - NLL of the f32 dense "
            f"forward| on the step's weights: dense bf16 {dev['dense']:.4e},"
            f" flash bf16 {dev['flash']:.4e} (<= 2 x dense), planted "
            f"non-causal flash {dev['planted']:.4e} (> 2 x dense: "
            f"rejected); step 1 loss {step_losses[0]:.6f} against the flash "
            f"forward's {flash_loss:.6f}: |diff| {gap:.3e} (rel tol "
            f"{PAR_LOSS_RTOL:g})")
        del step, sp, batch
        gc.collect()
        torch.cuda.empty_cache()

        # (c) checkpoint at full width, 2 layers, bf16: save after step 1
        # (asynchronously; step 2 runs while it writes), restore into a
        # fresh tree, step 2 again
        k = PAR_CKPT
        apply = partial(transformer_apply, **kw(k["n_layers"], bf16,
                                                flash_fn))
        batch = par_batch(torch, c["vocab"], k["batch"], k["seq"], 15)
        f0 = flash_attention.launches
        step, sp = make_sharded_train_step(
            apply, full_width_params(torch, k["n_layers"], bf16, seed=1),
            mesh, learning_rate=k["lr"])
        step(sp, batch)
        ck_dir = os.path.join(tmp, "ckpt")
        ck = TrainCheckpointer(ck_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(1, {"step": 1, "params": sp})
        staged_s = time.perf_counter() - t0
        _, loss2 = step(sp, batch)
        loss2 = float(loss2)
        ck.wait()
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(os.path.join(ck_dir, "1"))
                     for f in fs)
        step2, fresh = make_sharded_train_step(
            apply, full_width_params(torch, k["n_layers"], bf16, seed=2),
            mesh, learning_rate=k["lr"])
        target = {"step": 0, "params": abstract_like(fresh)}
        del fresh
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ck.restore(target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ck.close()
        _, loss2r = step2(state["params"], batch)
        same = all(torch.equal(full_tensor(x), full_tensor(y))
                   for (_, x), (_, y) in zip(par_leaves(state["params"]),
                                             par_leaves(sp)))
        if state["step"] != 1 or float(loss2r) != loss2 or not same:
            raise AssertionError(f"parallel (c): resumed step 2 loss "
                                 f"{float(loss2r)} vs {loss2}, params equal "
                                 f"{same}, step {state['step']}")
        c_launches = flash_attention.launches - f0
        log(f"parallel: (c) checkpoint, bf16 full width x {k['n_layers']} "
            f"layers: save {save_s:.3f} s ({staged_s:.3f} s to stage; step "
            f"2 ran while it wrote), {nbytes} bytes; restore "
            f"{restore_s:.3f} s ({nbytes / restore_s / 1e9:.2f} GB/s); "
            f"resumed step 2 == uninterrupted bit for bit (loss {loss2!r}, "
            f"every parameter) [{card}]")
        shutil.rmtree(ck_dir)
        del step, sp, step2, state, target
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the collectives at world size 1 against their single-device
        # forms, bit for bit
        g = np.random.default_rng(16)
        q, kk, v = (torch.from_numpy(g.standard_normal(
            (1, 2048, 32, 128)).astype(np.float32)).cuda().to(bf16)
            for _ in range(3))
        ring = ring_attention(mesh, "model")
        got = ring(q, kk, v)
        if not torch.equal(got, _ring_attn_local(q, kk, v, True)):
            raise AssertionError("parallel (d): ring != its one-block form")
        err = check_close(torch, "ring vs plain attention", got,
                          flash_attention_reference(q, kk, v, True))
        uly = ulysses_attention(mesh, "model")
        if not torch.equal(uly(q, kk, v), dense_attention(q, kk, v)):
            raise AssertionError("parallel (d): Ulysses != dense attention")
        ring_ms = par_ms(torch, lambda: ring(q, kk, v))
        uly_ms = par_ms(torch, lambda: uly(q, kk, v))
        dense_ms = par_ms(torch, lambda: dense_attention(q, kk, v))
        m = PAR_MOE
        moe = init_moe_params(m["d_model"], m["d_ff"], m["n_experts"],
                              seed=3, device="cuda")
        x = torch.from_numpy(g.standard_normal(
            (m["seq_len"], m["d_model"])).astype(np.float32)).cuda()
        ffn, shard = make_expert_parallel_ffn(mesh, "model",
                                              top_k=m["top_k"],
                                              compute_dtype=bf16)
        sharded = shard(moe)
        if not torch.equal(ffn(sharded, x),
                           moe_ffn(moe, x, m["top_k"], bf16)):
            raise AssertionError("parallel (d): expert-parallel != moe_ffn")
        ep_ms = par_ms(torch, lambda: ffn(sharded, x))
        moe_ms = par_ms(torch, lambda: moe_ffn(moe, x, m["top_k"], bf16))
        del moe, sharded
        stage = {"w": torch.from_numpy((g.standard_normal(
            (4096, 4096)) * 0.02).astype(np.float32)).cuda().to(bf16),
            "b": torch.zeros(4096, dtype=bf16, device="cuda")}
        stage_fn = lambda p, y: torch.nn.functional.gelu(
            y @ p["w"] + p["b"], approximate="tanh")
        pipeline, shard_pp = make_pipeline(mesh, stage_fn, "model")
        xs = torch.from_numpy(g.standard_normal(
            (4, 256, 4096)).astype(np.float32)).cuda().to(bf16)
        got = pipeline(shard_pp(stack_stage_params([stage])), xs)
        if not torch.equal(got, torch.stack([stage_fn(stage, y)
                                             for y in xs])):
            raise AssertionError("parallel (d): pipeline != the stage")
        log(f"parallel: (d) NCCL world size 1, bit for bit against the "
            f"single-device forms: ring (B 1, T 2048, H 32, D 128, bf16; "
            f"{ring_ms:.3f} ms; vs plain attention max err {err:.2e}), "
            f"Ulysses == dense_attention ({uly_ms:.3f} ms; dense "
            f"{dense_ms:.3f} ms), expert-parallel FFN == moe_ffn "
            f"(N {m['seq_len']}, d {m['d_model']}, f {m['d_ff']}, "
            f"{m['n_experts']} experts, top-{m['top_k']}, bf16: "
            f"{ep_ms:.3f} ms, dense {moe_ms:.3f} ms), pipeline == its stage "
            f"(4 microbatches of 256 x 4096) [{card}]")
        del q, kk, v, x, xs, stage
        gc.collect()
        torch.cuda.empty_cache()

        # (e) the MoE transformer at Mixtral's widths through the port's
        # InferenceManager and a MultiDeviceDispatcher of two managers on
        # the one card
        model = make_moe_transformer(**m, max_batch_size=1,
                                     compute_dtype=bf16, device="cuda")
        toks = g.integers(0, m["vocab"], (1, m["seq_len"])).astype(np.int32)
        with torch.inference_mode():
            direct = model.apply_fn(model.params, {"tokens": torch.from_numpy(
                toks).cuda()})["logits"].cpu().numpy()
        if not np.isfinite(direct).all():
            raise AssertionError("parallel (e): non-finite MoE logits")
        mgr = InferenceManager(max_executions=1)
        mgr.register_model("moe", model)
        mgr.update_resources()
        try:
            runner = mgr.infer_runner("moe")
            out = runner.infer(tokens=toks).result(timeout=300)["logits"]
            if not np.array_equal(out, direct):
                raise AssertionError("parallel (e): served != direct")
            t0 = time.perf_counter()
            for _ in range(5):
                runner.infer(tokens=toks).result(timeout=300)
            mgr_ms = (time.perf_counter() - t0) / 5 * 1e3
        finally:
            mgr.shutdown()
        del mgr, runner
        gc.collect()
        torch.cuda.empty_cache()
        disp = MultiDeviceDispatcher.create(lambda: model, "moe",
                                            devices=["cuda:0", "cuda:0"],
                                            max_executions=1)
        try:
            t0 = time.perf_counter()
            futs = [disp.infer("moe", tokens=toks) for _ in range(4)]
            outs = [f.result(timeout=300)["logits"] for f in futs]
            disp_ms = (time.perf_counter() - t0) / 4 * 1e3
            if not all(np.array_equal(o, direct) for o in outs):
                raise AssertionError("parallel (e): dispatched != direct")
        finally:
            disp.shutdown()
        log(f"parallel: (e) MoE transformer (d {m['d_model']}, f "
            f"{m['d_ff']}, {m['n_experts']} experts top-{m['top_k']}, vocab "
            f"{m['vocab']}, {m['n_layers']} layers, seq {m['seq_len']}, bf16 "
            f"compute, f32 weights): logits finite and bit-equal to the "
            f"direct apply_fn through the InferenceManager ({mgr_ms:.1f} ms "
            f"a batch of 1) and through a MultiDeviceDispatcher of two "
            f"managers on cuda:0 (4 requests, {disp_ms:.1f} ms a batch) "
            f"[{card}]")
        del disp, model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    # (f) the dry run as a subprocess: one rank on the card; two refused
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    cmd = [sys.executable, "-m", "tpulab_torch.parallel.dryrun"]
    t0 = time.perf_counter()
    one = subprocess.run(cmd + ["--nproc", "1"], cwd=HERE, env=env,
                         capture_output=True, text=True, timeout=300)
    one_s = time.perf_counter() - t0
    if (one.returncode != 0 or "dryrun pipeline (pp=1) ok" not in one.stdout
            or "dryrun paged sharded decode ok" not in one.stdout):
        raise AssertionError(f"parallel (f): dryrun --nproc 1 rc "
                             f"{one.returncode}: {one.stdout[-2000:]}"
                             f"{one.stderr[-3000:]}")
    two = subprocess.run(cmd + ["--nproc", "2"], cwd=HERE, env=env,
                         capture_output=True, text=True, timeout=300)
    if two.returncode == 0 or "need 2 devices, have 1" not in two.stderr:
        raise AssertionError(f"parallel (f): dryrun --nproc 2 rc "
                             f"{two.returncode}: {two.stderr[-2000:]}")
    for line in one.stdout.splitlines():
        log(f"parallel: (f) {line}")
    log(f"parallel: (f) dryrun --nproc 1 exit 0 in {one_s:.1f} s; "
        f"--nproc 2 exit {two.returncode}: need 2 devices, have 1")
    log(f"parallel: phase {time.perf_counter() - t_phase:.1f} s; kernel 2 "
        f"launches: {b_launches} the full-depth step, {a_launches} (a), "
        f"{c_launches} (c) [{card}]")
    return b_launches + a_launches + c_launches


# ---------------------------------------------------------------- phase 14
# the sharded serve: phase 5's Llama-3-8B geometry, 8 requests (even
# ones greedy, odd ones device-sampled) x SHARD_STEPS
SHARD_SERVE = dict(lanes=8, max_len=2048, page_size=16, decode_block=8,
                   prefill_chunk=256)
SHARD_PROMPTS = (1000, 700, 500, 300, 200, 128, 64, 16)
SHARD_STEPS = 32
SHARD_TEMP = 0.8
SHARD_SEED = 4242
SHARD_RANKS = 2                 # the ranks that share the one card
# (d): the int8 tree on the mix's last four requests (200, 128, 64 and 16
# tokens, two greedy, two device-sampled), cut to 16 steps: its eager
# dequantization made the first four's long prefills take 28 s at M 2 on
# one H100
SHARD_INT8 = (4, 5, 6, 7)
SHARD_INT8_STEPS = 16
# (e): the split plan's owner publishes the mix's four greedy prompts
# (1000, 500, 200 and 64 tokens: flash buckets 1024 ... 64) over 8 steps;
# the 1000-token prompt's blob is pulled into a mesh=None batcher
SHARD_PUB = (0, 2, 4, 6)
SHARD_PUB_STEPS = 8
SHARD_KV_OFFLOAD = 1 << 30
# (f): one greedy request before and after the swap; the second servable
SHARD_SWAP_STEPS = 8
SHARD_BLOB_BYTES = 2 << 30


def shard_specs(np):
    """(name, prompt, device-sampling seed or None) of the phase's mix."""
    rng = np.random.default_rng(14)
    return [(f"r{i}", rng.integers(0, LLAMA3_8B["vocab"], (n,), np.int32),
             SHARD_SEED + i if i % 2 else None)
            for i, n in enumerate(SHARD_PROMPTS)]


def shard_warm(cb):
    """One short request before the timed serve: the first collectives
    (NCCL makes its communicator at the first one) and the first
    allocations stay out of the timing."""
    cb.submit([1, 2, 3], 2).result(timeout=900)


def shard_sampling(seed):
    from tpulab_torch.engine.paged import SamplingParams

    return (SamplingParams(temperature=SHARD_TEMP, seed=seed, device=True)
            if seed is not None else None)


def shard_serve(cb, specs, steps=SHARD_STEPS):
    """Submit the mix at once (atomically: repeated runs schedule the same
    rounds) and wait for it."""
    futs = {}
    with cb._cv:
        for name, prompt, seed in specs:
            futs[name] = cb.submit(prompt, steps,
                                   sampling=shard_sampling(seed))
    return {name: list(f.result(timeout=900)) for name, f in futs.items()}


class DeviceBlob:
    """The second servable of (f): one device tensor of ``nbytes`` behind
    the weight multiplexer's adapter protocol."""

    def __init__(self, torch, nbytes):
        self.torch, self.nbytes = torch, nbytes
        self.tree = self.rebuild()

    def resident(self):
        return self.tree is not None

    def param_bytes(self):
        return self.nbytes

    def busy(self):
        return False

    def detach(self):
        tree, self.tree = self.tree, None
        return tree

    def on_detached(self):
        pass

    def attach(self, host_tree):
        from tpulab_torch.cuda.allocators import place_tree
        self.tree = place_tree(host_tree, "cuda")
        self.torch.cuda.synchronize()

    def rebuild(self):
        return {"w": self.torch.zeros(self.nbytes, dtype=self.torch.uint8,
                                      device="cuda")}


class LaunchCounts:
    """Kernels 1 and 2's launch counters of this process, zeroed by
    :meth:`zero` and read by :meth:`read`."""

    def __init__(self):
        from tpulab_torch.ops.flash_attention import flash_attention
        from tpulab_torch.ops.ragged_attention import ragged_paged_attention
        self.fns = {"ragged": ragged_paged_attention,
                    "flash": flash_attention}

    def zero(self):
        for fn in self.fns.values():
            fn.launches = 0
            fn.launches_by_body = dict.fromkeys(fn.launches_by_body, 0)

    def read(self):
        out = {}
        for name, fn in self.fns.items():
            out[name] = fn.launches
            out[f"{name}_bodies"] = dict(fn.launches_by_body)
        return out


def gb(torch):
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 1e9


def shard_publish(torch, cb, specs, out_dir):
    """(e) on the coordinator: serve the greedy prompts on the publishing
    owner, wait for every snapshot to land, write the first prompt's
    fabric blob for the parent to pull."""
    from tpulab_torch.disagg.wire import prompt_digest
    from tpulab_torch.kvfabric import fabric_export

    t0 = time.perf_counter()
    outs = shard_serve(cb, specs, SHARD_PUB_STEPS)
    wall = time.perf_counter() - t0
    end = time.monotonic() + 300
    for _, prompt, _ in specs:
        while ("fab", prompt_digest(prompt)) not in cb.kv_offload.store:
            if time.monotonic() > end:
                raise AssertionError("sharded (e): a publish never landed")
            time.sleep(0.01)
    blob = fabric_export(cb, prompt_digest(specs[0][1]))
    if blob is None:
        raise AssertionError("sharded (e): the owner exports nothing")
    with open(os.path.join(out_dir, "blob.bin"), "wb") as f:
        f.write(blob)
    return {"outs": outs, "wall_s": wall, "kv_publishes": cb.kv_publishes,
            "prefill_forwards": cb.prefill_forwards,
            "forward_steps": cb.forward_steps, "blob_bytes": len(blob)}


def shard_swap(torch, cb, prompt):
    """(f) on the coordinator: a WeightMultiplexer over the batcher's
    adapter; a second servable's registration pushes the weights out, an
    acquire brings them back; one greedy request before and after."""
    from tpulab_torch.modelstore import BatcherAdapter, WeightMultiplexer

    def serve():
        return list(cb.submit(prompt, SHARD_SWAP_STEPS).result(timeout=900))

    out = {"before": serve(), "hot_gb": gb(torch),
           "shard_gb": tree_gb(cb.params)}
    blob = DeviceBlob(torch, SHARD_BLOB_BYTES)
    metrics = SwapMetrics(torch)
    mux = WeightMultiplexer(cb.tree_bytes + SHARD_BLOB_BYTES // 2,
                            host_budget_bytes=16 << 30, metrics=metrics)
    try:
        mux.register("llm", BatcherAdapter(cb))
        t0 = time.perf_counter()
        mux.register("other", blob)
        if not mux.drain(timeout=300):
            raise AssertionError("sharded (f): the swap-out never landed")
        out["out_s"] = time.perf_counter() - t0
        out["cold"] = [mux.state_of("llm"), cb.params is None]
        out["cold_gb"] = gb(torch)
        t0 = time.perf_counter()
        with mux.acquire("llm", timeout=300):
            out["in_s"] = time.perf_counter() - t0
            out["hot"] = mux.state_of("llm")
            out["after"] = serve()
        mux.drain(timeout=300)
        out["swaps"] = [list(x) for x in metrics.swaps]
        out["param_bytes"] = cb.tree_bytes
    finally:
        mux.close()
    return out


def shard_kw(torch):
    c = LLAMA3_8B
    return dict(n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"],
                n_layers=c["n_layers"], rope_theta=c["rope_theta"],
                compute_dtype=torch.bfloat16, **SHARD_SERVE)


def sharded_rank(rank, world, store, out_dir):
    """One of phase 14's ranks sharing the card: a gloo group (its CUDA
    collectives, asked for by name: NCCL takes one rank a card), this
    rank's shards of the phase's weights cut leaf by leaf on the card,
    the batcher on {"model": world}: (c), then (e), (f) and (d); writes
    what it saw to ``rank<r>.json``."""
    import faulthandler

    import numpy as np
    import torch

    # a fatal signal (an abort in native code) prints every thread's stack
    faulthandler.enable(all_threads=True)

    def stage(what):
        print(f"sharded rank {rank}: {what}", file=sys.stderr, flush=True)

    sys.path.insert(0, HERE)
    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.engine.sharded import init_transformer_shards
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention
    from tpulab_torch.parallel import make_mesh, multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"file://{store}", world, rank, backend="gloo")
    stage("group up")
    mesh = make_mesh({"model": world})
    c = LLAMA3_8B
    params = init_transformer_shards(
        mesh, c["vocab"], c["d_model"], c["n_heads"], c["n_layers"],
        c["d_ff"], seed=0, n_kv_heads=c["n_kv_heads"], ffn="swiglu",
        tie_embeddings=False, dtype=torch.bfloat16)
    cb = ContinuousBatcher(params, mesh=mesh, **shard_kw(torch))
    stage("batcher up")
    import gc
    res = {"rank": rank, "kv": list(cb.pool.kv.shape),
           "wqkv": list(cb.params["layer0"]["wqkv"].shape),
           "backend": torch.distributed.get_backend()}
    try:
        if cb.is_coordinator:
            shard_warm(cb)
            steps0, toks0 = cb.forward_steps, cb.tokens_generated
            t0 = time.perf_counter()
            res["outs"] = shard_serve(cb, shard_specs(np))
            res["wall_s"] = time.perf_counter() - t0
            res["forward_steps"] = cb.forward_steps - steps0
            res["tokens"] = cb.tokens_generated - toks0
            res["steps_total"] = cb.forward_steps
    finally:
        cb.shutdown()
    stage("batcher shut down")
    res["launches"] = ragged_paged_attention.launches
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    counts = LaunchCounts()
    specs = shard_specs(np)

    # (e) the split plan (kernel 2 on this rank's 16 query heads) as a
    # fabric owner
    counts.zero()
    t0 = time.perf_counter()
    cb = ContinuousBatcher(params, mesh=mesh, **dict(
        shard_kw(torch), ragged=False, prefill_chunk=None,
        kv_offload=SHARD_KV_OFFLOAD, kv_publish=True))
    try:
        e = (shard_publish(torch, cb, [specs[i] for i in SHARD_PUB],
                           out_dir) if cb.is_coordinator else {})
    finally:
        cb.shutdown()
    del cb
    gc.collect()      # the shut-down batchers' references to the shards
    e.update(counts.read(), stage_s=time.perf_counter() - t0)
    res["e"] = e
    stage("(e) split plan + kv_publish done")

    # (f) the weights swapped out and back by a multiplexer on the
    # coordinator; a follower times its replay and reads its memory cold
    counts.zero()
    t0 = time.perf_counter()
    f = {"hot_gb": None}
    out_op = ContinuousBatcher._op_weights_out
    in_op = ContinuousBatcher._op_weights_in

    def weights_out(self):
        f["hot_gb"] = gb(torch)
        f["shard_gb"] = tree_gb(self.params)
        t = time.perf_counter()
        out_op(self)
        f.update(out_s=time.perf_counter() - t, cold_gb=gb(torch))

    def weights_in(self, builder=None):
        t = time.perf_counter()
        in_op(self, builder)
        f["in_s"] = time.perf_counter() - t

    if rank:
        ContinuousBatcher._op_weights_out = weights_out
        ContinuousBatcher._op_weights_in = weights_in
    cb = ContinuousBatcher(params, mesh=mesh, **shard_kw(torch))
    del params        # the batcher's shards are the only reference left
    try:
        if cb.is_coordinator:
            f = shard_swap(torch, cb, specs[7][1])
    finally:
        cb.shutdown()
    ContinuousBatcher._op_weights_out = out_op
    ContinuousBatcher._op_weights_in = in_op
    del cb
    f.update(counts.read(), stage_s=time.perf_counter() - t0)
    res["f"] = f
    stage("(f) weight swap done")

    # (d) the int8 tree: each projection quantized whole on the card,
    # then cut by its parent's rule
    counts.zero()
    t0 = time.perf_counter()
    qparams = init_transformer_shards(
        mesh, c["vocab"], c["d_model"], c["n_heads"], c["n_layers"],
        c["d_ff"], seed=0, n_kv_heads=c["n_kv_heads"], ffn="swiglu",
        tie_embeddings=False, dtype=torch.bfloat16, quantize=True)
    whole = sum(x.numel() for x in int8_leaves(qparams))
    cb = ContinuousBatcher(qparams, mesh=mesh, **shard_kw(torch))
    del qparams
    d = {"int8_bytes": sum(x.numel() for x in int8_leaves(cb.params)),
         "int8_whole": whole, "draw_s": time.perf_counter() - t0}
    try:
        if cb.is_coordinator:
            t1 = time.perf_counter()
            d["outs"] = shard_serve(cb, [specs[i] for i in SHARD_INT8],
                                    SHARD_INT8_STEPS)
            d["wall_s"] = time.perf_counter() - t1
            d["forward_steps"] = cb.forward_steps
            d["tokens"] = cb.tokens_generated
    finally:
        cb.shutdown()
    d.update(counts.read(), stage_s=time.perf_counter() - t0)
    res["d"] = d
    stage("(d) int8 serve done")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    stage("results written")


def tree_gb(tree):
    """The GB of a tree's tensor leaves."""
    return sum(tree_gb(v) if isinstance(v, dict)
               else v.numel() * v.element_size() / 1e9
               for v in tree.values())


def int8_leaves(tree):
    """The ``w_int8`` leaves of a tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from int8_leaves(v)
        elif k == "w_int8":
            yield v


def phase_sharded(torch, card):
    """The paged serving path under a tensor-parallel mesh at Llama-3-8B
    width (module docstring, phase 14).  Returns kernel 1's launches in
    the {"model": 1} serve and in every rank of the {"model": 2} launch,
    and kernel 2's in (e)'s ranks."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from tpulab_torch.engine.paged import ContinuousBatcher
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention
    from tpulab_torch.parallel import make_mesh, multihost

    ra = ragged_paged_attention
    c = LLAMA3_8B
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    params = full_width_params(torch, c["n_layers"], torch.bfloat16, seed=0)
    specs = shard_specs(np)
    kw = shard_kw(torch)
    tmp = tempfile.mkdtemp(prefix="sharded-")
    try:
        # (a) mesh=None, the reference streams
        cb = ContinuousBatcher(params, **kw)
        try:
            shard_warm(cb)
            t0 = time.perf_counter()
            ref = shard_serve(cb, specs)
            ref_s = time.perf_counter() - t0
        finally:
            cb.shutdown()
        # (b) {"model": 1} on an NCCL group of one rank: bit for bit
        multihost.initialize(f"file://{tmp}/store", 1, 0)
        if dist.get_backend() != "nccl":
            raise AssertionError("sharded: the card's group is not NCCL")
        mesh = make_mesh({"model": 1})
        cb = ContinuousBatcher(params, mesh=mesh, **kw)
        try:
            shard_warm(cb)
            ra.launches = 0
            ra.launches_by_body = dict.fromkeys(ra.launches_by_body, 0)
            steps0, toks0 = cb.forward_steps, cb.tokens_generated
            t0 = time.perf_counter()
            got = shard_serve(cb, specs)
            m1_s = time.perf_counter() - t0
            steps = cb.forward_steps - steps0
            toks = cb.tokens_generated - toks0
        finally:
            cb.shutdown()
        launches = ra.launches
        dist.destroy_process_group()
        if got != ref:
            bad = [n for n in ref if got[n] != ref[n]]
            raise AssertionError(f"sharded: the M 1 streams {bad} differ "
                                 "from mesh=None")
        if launches != c["n_layers"] * steps or ra.launches_by_body != {
                "fma": 0, "wgmma": launches}:
            raise AssertionError(f"sharded: kernel 1 launches {launches} "
                                 f"({ra.launches_by_body}) != "
                                 f"{c['n_layers']} x {steps}")
        log(f"sharded: (a) mesh=None and (b) {{\"model\": 1}} over NCCL, "
            f"{len(specs)} requests (prompts {list(SHARD_PROMPTS)}, "
            f"{SHARD_STEPS} steps; even greedy, odd device-sampled T "
            f"{SHARD_TEMP}): streams bit-identical; {toks} tokens in "
            f"{m1_s:.2f} s ({toks / m1_s:.1f} tok/s) against {ref_s:.2f} s "
            f"at mesh=None; kernel 1 launches {launches} == "
            f"{c['n_layers']} x {steps} forward steps, all wgmma [{card}]")
        gc.collect()
        torch.cuda.empty_cache()
        # (d)'s reference: the tree quantized on the card, matrix by
        # matrix, served at mesh=None
        from tpulab_torch.models.quantization import (
            quantize_transformer_params)
        qparams = quantize_transformer_params(params)
        cb = ContinuousBatcher(qparams, **kw)
        try:
            ref_int8 = shard_serve(cb, [specs[i] for i in SHARD_INT8],
                                   SHARD_INT8_STEPS)
        finally:
            cb.shutdown()

        # (c)-(f) two ranks on the one card over gloo's CUDA collectives
        t0 = time.perf_counter()
        multihost.launch(sharded_rank, SHARD_RANKS,
                         (SHARD_RANKS, f"{tmp}/store2", tmp), timeout=900)
        two_s = time.perf_counter() - t0
        ranks = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        coord = ranks[0]
        hkv = c["n_kv_heads"] // SHARD_RANKS
        for r in ranks:
            if r["kv"][4] != hkv or r["backend"] != "gloo":
                raise AssertionError(f"sharded (c): rank {r['rank']} holds "
                                     f"{r['kv']} over {r['backend']}")
            if r["launches"] != c["n_layers"] * coord["steps_total"]:
                raise AssertionError(
                    f"sharded (c): rank {r['rank']} kernel 1 launches "
                    f"{r['launches']} != {c['n_layers']} x "
                    f"{coord['steps_total']}")
        kw_dense = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
                        n_kv_heads=c["n_kv_heads"],
                        rope_theta=c["rope_theta"],
                        compute_dtype=torch.bfloat16)
        from tpulab_torch.engine.paged import SamplingParams
        notes = []
        for name, prompt, seed in specs:
            sp = (SamplingParams(temperature=SHARD_TEMP, seed=seed,
                                 device=True) if seed is not None else None)
            note = same_or_bf16_noise(torch, params, kw_dense,
                                      f"{name}", prompt,
                                      ref[name], coord["outs"][name], sp)
            if note:
                notes.append(note)
        same = sum(coord["outs"][n] == ref[n] for n in ref)
        log(f"sharded: (c) {SHARD_RANKS} ranks on one card over gloo's "
            f"CUDA collectives, {{\"model\": {SHARD_RANKS}}}: each rank "
            f"{coord['kv']} pages (Hkv {hkv}), wqkv {coord['wqkv']}; "
            f"{coord['tokens']} tokens in {coord['wall_s']:.2f} s "
            f"({coord['tokens'] / coord['wall_s']:.1f} tok/s); kernel 1 "
            f"launches per rank {[r['launches'] for r in ranks]} == "
            f"{c['n_layers']} x {coord['steps_total']} forward steps (the "
            f"warm-up's included); peak GB per rank "
            f"{[round(r['peak_gb'], 2) for r in ranks]}; {same} of "
            f"{len(ref)} streams bit-identical to mesh=None, the rest "
            f"within the bf16 noise rule; launch {two_s:.1f} s [{card}]")
        for note in notes:
            log(f"sharded: (c) {note}")
        sharded_int8(torch, ranks, specs, qparams, ref_int8, kw_dense, card)
        del qparams
        sharded_publish(torch, ranks, specs, params, ref, kw, kw_dense, tmp,
                        card)
        sharded_swap(ranks, card)
        k1 = launches + sum(r["launches"] + r["d"]["ragged"]
                            + r["e"]["ragged"] + r["f"]["ragged"]
                            for r in ranks)
        k2 = sum(r["e"]["flash"] for r in ranks)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    log(f"sharded: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return k1, k2


def launches_per_rank(ranks, key, kernel, want, body="wgmma"):
    """Each rank's ``kernel`` launches in stage ``key`` equal ``want``,
    every one on ``body``."""
    for r in ranks:
        got = r[key][kernel]
        if got != want or r[key][f"{kernel}_bodies"].get(body) != got:
            raise AssertionError(
                f"sharded ({key}): rank {r['rank']} {kernel} launches {got} "
                f"({r[key][f'{kernel}_bodies']}) != {want}, all {body}")
    return [r[key][kernel] for r in ranks]


def sharded_int8(torch, ranks, specs, qparams, ref, kw_dense, card):
    """(d): each rank holds half the int8 bytes; kernel 1 launches per
    rank == n_layers x the forward steps; the streams of the mesh=None
    int8 serve, or the bf16 noise rule over an int8 replay."""
    n_layers = LLAMA3_8B["n_layers"]
    d = ranks[0]["d"]
    for r in ranks:
        if SHARD_RANKS * r["d"]["int8_bytes"] != r["d"]["int8_whole"]:
            raise AssertionError(f"sharded (d): rank {r['rank']} holds "
                                 f"{r['d']['int8_bytes']} of "
                                 f"{r['d']['int8_whole']} int8 bytes")
    per_rank = launches_per_rank(ranks, "d", "ragged",
                                 n_layers * d["forward_steps"])
    notes = [same_or_bf16_noise(torch, qparams, kw_dense, f"(d) {name}",
                                prompt, ref[name], d["outs"][name],
                                shard_sampling(seed))
             for name, prompt, seed in (specs[i] for i in SHARD_INT8)]
    same = sum(d["outs"][n] == ref[n] for n in ref)
    log(f"sharded: (d) the int8 tree (quantized whole on each rank's card, "
        f"cut by the parent's rule; drawn in "
        f"{[round(r['d']['draw_s'], 1) for r in ranks]} s) at "
        f"{{\"model\": {SHARD_RANKS}}}: int8 bytes per rank "
        f"{[r['d']['int8_bytes'] for r in ranks]} of "
        f"{d['int8_whole']}; {d['tokens']} tokens (prompts "
        f"{[len(specs[i][1]) for i in SHARD_INT8]} x {SHARD_INT8_STEPS} "
        f"steps) in {d['wall_s']:.2f} s; kernel 1 "
        f"launches per rank {per_rank} == {n_layers} x "
        f"{d['forward_steps']} forward steps, all wgmma; {same} of "
        f"{len(ref)} streams bit-identical to the mesh=None int8 serve, "
        f"the rest within the bf16 noise rule; stage "
        f"{[round(r['d']['stage_s'], 1) for r in ranks]} s [{card}]")
    for note in notes:
        if note:
            log(f"sharded: {note}")


def sharded_publish(torch, ranks, specs, params, ref, kw, kw_dense, tmp,
                    card):
    """(e): kernel 2 launches per rank == n_layers x the prefills, all
    wgmma; one publish per distinct prompt; the owner's streams against
    (a)'s; the first prompt's blob pulled into a mesh=None batcher
    continues the owner's stream (no prefill of its own)."""
    from tpulab_torch.disagg import KVShipper
    from tpulab_torch.engine.paged import ContinuousBatcher

    n_layers = LLAMA3_8B["n_layers"]
    e = ranks[0]["e"]
    pub = [specs[i] for i in SHARD_PUB]
    if e["kv_publishes"] != len(pub) or e["prefill_forwards"] != len(pub):
        raise AssertionError(f"sharded (e): {e['kv_publishes']} publishes, "
                             f"{e['prefill_forwards']} prefills of "
                             f"{len(pub)} prompts")
    flash = launches_per_rank(ranks, "e", "flash",
                              n_layers * e["prefill_forwards"])
    ragged = launches_per_rank(ranks, "e", "ragged",
                               n_layers * e["forward_steps"])
    notes = [same_or_bf16_noise(torch, params, kw_dense, f"(e) {name}",
                                prompt, ref[name][:SHARD_PUB_STEPS],
                                e["outs"][name])
             for name, prompt, _ in pub]
    name, prompt, _ = pub[0]
    with open(os.path.join(tmp, "blob.bin"), "rb") as f:
        blob = f.read()
    cb = ContinuousBatcher(params, **dict(kw, kv_offload=SHARD_KV_OFFLOAD))
    try:
        ship = KVShipper(cb.kv_offload).import_shipment(blob)
        if ship is None:
            raise AssertionError("sharded (e): the mesh owner's blob was "
                                 "refused by the mesh=None puller")
        t0 = time.perf_counter()
        pulled = list(cb.submit_shipped(prompt, SHARD_PUB_STEPS,
                                        ship.first_token, ship.handle)
                      .result(timeout=900))
        pull_s = time.perf_counter() - t0
        if cb.prompt_fills:
            raise AssertionError(f"sharded (e): the puller prefilled "
                                 f"{cb.prompt_fills} prompts")
    finally:
        cb.shutdown()
    notes.append(same_or_bf16_noise(torch, params, kw_dense,
                                    f"(e) pulled {name}", prompt,
                                    e["outs"][name], pulled))
    same = sum(e["outs"][n] == ref[n][:SHARD_PUB_STEPS] for n, _, _ in pub)
    log(f"sharded: (e) the split plan at {{\"model\": {SHARD_RANKS}}} as "
        f"a fabric owner (kernel 2 on each rank's "
        f"{LLAMA3_8B['n_heads'] // SHARD_RANKS} query heads), prompts "
        f"{[len(p) for _, p, _ in pub]} x {SHARD_PUB_STEPS} steps in "
        f"{e['wall_s']:.2f} s: kernel 2 launches per rank {flash} == "
        f"{n_layers} x {e['prefill_forwards']} prefills, kernel 1 {ragged} "
        f"== {n_layers} x {e['forward_steps']} forward steps, all wgmma; "
        f"{e['kv_publishes']} publishes; {same} of {len(pub)} streams "
        f"bit-identical to (a)'s first {SHARD_PUB_STEPS} tokens; the "
        f"{len(prompt)}-token prompt's blob ({e['blob_bytes']} bytes) "
        f"pulled into a mesh=None batcher, no prefill, continued in "
        f"{pull_s:.2f} s: {'bit-identical to' if pulled == e['outs'][name] else 'within the bf16 noise rule of'} "
        f"the owner's stream; stage "
        f"{[round(r['e']['stage_s'], 1) for r in ranks]} s [{card}]")
    for note in notes:
        if note:
            log(f"sharded: {note}")


def sharded_swap(ranks, card):
    """(f): the coordinator's weights swapped out by a second servable's
    registration and back by an acquire; every rank's memory falls by its
    shard while cold; the stream after the swap is the one before it, bit
    for bit."""
    f, g = ranks[0]["f"], ranks[1]["f"]
    if f["cold"] != ["cold", True] or f["hot"] != "hot":
        raise AssertionError(f"sharded (f): states {f['cold']} / "
                             f"{f['hot']}")
    if f["after"] != f["before"]:
        raise AssertionError(f"sharded (f): the stream after the swap "
                             f"{f['after']} != before {f['before']}")
    blob_gb = SHARD_BLOB_BYTES / 1e9
    for r, freed in ((f, f["shard_gb"] - blob_gb), (g, g["shard_gb"])):
        if r["hot_gb"] - r["cold_gb"] < freed - 0.1:
            raise AssertionError(
                f"sharded (f): device memory {r['hot_gb']:.3f} -> "
                f"{r['cold_gb']:.3f} GB while cold, want {freed:.3f} GB "
                "freed")
    outs = [x for x in f["swaps"] if x[0] == "out"]
    ins = [x for x in f["swaps"] if x[0] == "in"]
    log(f"sharded: (f) a WeightMultiplexer on the coordinator over the "
        f"{{\"model\": {SHARD_RANKS}}} batcher's BatcherAdapter "
        f"(param_bytes {f['param_bytes']}, the whole tree's) and a "
        f"{blob_gb:.3f} GB second servable: cold {f['cold']}, then "
        f"{f['hot']}; device GB hot -> cold, coordinator "
        f"{f['hot_gb']:.3f} -> {f['cold_gb']:.3f} (its "
        f"{f['shard_gb']:.3f} GB shard out, the servable in), follower "
        f"{g['hot_gb']:.3f} -> {g['cold_gb']:.3f} (its {g['shard_gb']:.3f} "
        f"GB shard out); swap-out {f['out_s']:.3f} s (the multiplexer's "
        f"fetches: the LLM's {outs[0][1]:.3f} s, later the servable's "
        f"{outs[1][1]:.3f} s), the follower's copy {g['out_s']:.3f} s; "
        f"swap-in {f['in_s']:.3f} s (the multiplexer's "
        f"{ins[0][1]:.3f} s), the follower's {g['in_s']:.3f} s; "
        f"{SHARD_SWAP_STEPS} tokens before and after bit-identical; kernel "
        f"1 launches per rank {[r['f']['ragged'] for r in ranks]}; stage "
        f"{[round(r['f']['stage_s'], 1) for r in ranks]} s [{card}]")


# ---------------------------------------------------------------- phase 15
# tpulab's bench rows on the card.  The serving rows at Llama-3-8B width
# over one bf16 tree (phase 5's seed); the kernel sweep at tpulab's own
# geometry; the host-tier rows at the arguments of tpulab's bench.py.
ROWS_DECODE_DISPATCH = dict(ks=(1, 4, 8, 16), lanes=4, steps=32,
                            prompt_len=8)
ROWS_SPEC_DECODE = dict(k=8, lanes=2, steps=32,
                        draft_layers=SPEC_DRAFT_LAYERS,
                        tail_scale=SPEC_TAIL_SCALE)
ROWS_RAGGED = dict(lanes=3, steps=24, prompt_len=12, kernel=True)
ROWS_LLM_DECODE = dict(lanes=8, ctx=1024, page_size=16, iters=64)
# tpulab's sweep at its defaults
ROWS_SWEEP = dict(n_heads=8, n_layers=4, d_model=1024, page_size=32,
                  combos=((8, 2048), (32, 2048), (8, 8192), (8, 16384)))
# tpulab's bench.py runs kv_offload, disagg and multi_model at their
# default d_model 64 over 4 heads: head dim 16, which no kernel is built
# for (64, 128, 256).  They run at hbm_arbiter's own width, d_model 256
# over 4 heads (head dim 64); everything else is bench.py's.
ROWS_HOST_WIDTH = dict(d_model=256, n_heads=4)
ROWS_KV_OFFLOAD = dict(n_low=4, n_hi=4, steps=20)
ROWS_DISAGG = dict(n_requests=8, prompt_len=48, steps=8)
ROWS_HBM = dict(n_llm=12)
ROWS_MULTI_MODEL = dict(switches=6, steps=8)


class BatcherLog:
    """While a row runs, the port's ``ContinuousBatcher`` is a recording
    subclass: every batcher the row builds, in order, and each request's
    prompt, steps and future (``submit`` and ``submit_shipped``).  The
    forward counters survive ``shutdown``."""

    def __init__(self):
        self.made = []

    def __enter__(self):
        import numpy as np

        from tpulab_torch.engine import paged

        made = self.made
        self._paged, self._base = paged, paged.ContinuousBatcher

        class Recorded(self._base):
            def __init__(self, *a, **kw):
                self.requests = []
                super().__init__(*a, **kw)
                made.append(self)

            def submit(self, prompt, steps, *a, **kw):
                fut = super().submit(prompt, steps, *a, **kw)
                self.requests.append((np.asarray(prompt), steps, fut))
                return fut

            def submit_shipped(self, prompt, steps, *a, **kw):
                fut = super().submit_shipped(prompt, steps, *a, **kw)
                self.requests.append((np.asarray(prompt), steps, fut))
                return fut

        paged.ContinuousBatcher = Recorded
        return self

    def __exit__(self, *exc):
        self._paged.ContinuousBatcher = self._base
        return False

    def total(self, name):
        return sum(getattr(cb, name) for cb in self.made)


def stream_pairs(a, b):
    """(prompt, a's tokens, b's tokens) for every request of batcher ``a``
    matched with ``b``'s request of the same prompt and steps, in order of
    submission within each (prompt, steps)."""
    theirs = {}
    for prompt, steps, fut in b.requests:
        theirs.setdefault((prompt.tobytes(), steps), []).append(fut)
    pairs = []
    for prompt, steps, fut in a.requests:
        other = theirs.get((prompt.tobytes(), steps))
        if other:
            pairs.append((prompt, list(fut.result()),
                          list(other.pop(0).result())))
    return pairs


def row_errors(row, path=""):
    """Every ``error`` / ``*_error`` key of a row, at any depth."""
    out = []
    items = row.items() if isinstance(row, dict) else enumerate(row)
    for k, v in items:
        here = f"{path}/{k}"
        if isinstance(k, str) and (k == "error" or k.endswith("_error")):
            out.append(f"{here}: {v}")
        elif isinstance(v, (dict, list)):
            out += row_errors(v, here)
    return out


def row_rates(row, path=""):
    """Every ``*tok_s`` value of a row, at any depth."""
    out = {}
    items = row.items() if isinstance(row, dict) else enumerate(row)
    for k, v in items:
        here = f"{path}/{k}"
        if isinstance(k, str) and k.endswith("tok_s"):
            out[here] = v
        elif isinstance(v, (dict, list)):
            out.update(row_rates(v, here))
    return out


def hold_flag(torch, label, flag, rule, pairs, params, kw):
    """A parity flag of a row: True, or (``rule`` "margin": f32, the
    margin rule of phase 4; "bf16": phase 7's bf16 noise rule) every
    differing stream pair passes the rule.  ``rule`` "exact" (bit for bit)
    takes the flag as it is.  Returns a note for the log."""
    if flag is True:
        return "equal"
    if rule == "exact" or not pairs:
        raise AssertionError(f"rows: {label} is {flag} (held bit for bit)")
    notes = []
    for prompt, want, got in pairs:
        if want == got:
            continue
        if rule == "margin":
            note = same_or_near_tie(torch, params, kw, label, prompt, want,
                                    got)
        else:
            note = same_or_bf16_noise(torch, params, kw, label, prompt,
                                      want, got)
        if note not in notes:
            notes.append(note)
    if not notes:
        raise AssertionError(f"rows: {label} is {flag} but every recorded "
                             "stream pair is equal")
    return "; ".join(notes)


def run_row(torch, name, fn, kw, expect, bf16=False):
    """``fn(**kw)`` once with kernels 1 and 2 counted from 0 and the
    batchers recorded; prints the row's JSON on its own line.  ``expect``
    (BatcherLog, row) -> (kernel 1 launches, kernel 2 launches) the row
    must have made.  Fails on an error key, a tok/s <= 0, or launches
    other than expected (with ``bf16`` every kernel 1 launch on
    ``wgmma``)."""
    from tpulab_torch.ops.flash_attention import flash_attention
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention

    for k in (ragged_paged_attention, flash_attention):
        k.launches = 0
        k.launches_by_body = dict.fromkeys(k.launches_by_body, 0)
    t0 = time.perf_counter()
    with BatcherLog() as rec:
        row = fn(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"rows: {json.dumps({name: row})}")
    errors = row_errors(row)
    if errors:
        raise AssertionError(f"rows: {name}: {errors}")
    rates = row_rates(row)
    bad = {k: v for k, v in rates.items() if not v > 0}
    if bad:
        raise AssertionError(f"rows: {name}: tok/s <= 0 at {bad}")
    ra, fl = ragged_paged_attention.launches, flash_attention.launches
    want_ra, want_fl = expect(rec, row)
    by_body = dict(ragged_paged_attention.launches_by_body)
    if (ra, fl) != (want_ra, want_fl) or (bf16 and by_body["wgmma"] != ra):
        raise AssertionError(f"rows: {name}: kernel 1 launches {ra} (by "
                             f"body {by_body}), kernel 2 {fl}; want "
                             f"{want_ra}, {want_fl}")
    log(f"rows: {name}: {secs:.1f} s; {len(rec.made)} batchers; kernel 1 "
        f"launches {ra} {by_body}, kernel 2 {fl}, as counted from the "
        "batchers' forwards")
    return row, rec, secs, (ra, fl)


@contextlib.contextmanager
def head_first_bursts(lanes):
    """Each burst of ``lanes`` submits on a batcher built in the block has
    its first request decoding (one decode dispatch) before ``submit``
    returns, so the rest queue behind a lane already decoding: the card's
    usual order at Llama-3-8B width, made certain (else which of a row's
    bursts queue whole is thread timing; the CPU tests' twin is
    ``tests/torch_bench_util.head_first_bursts``)."""
    from tpulab_torch.engine import paged

    base = paged.ContinuousBatcher
    real = base.submit

    def submit(self, *a, **kw):
        n = getattr(self, "_burst_submits", 0)
        self._burst_submits = n + 1
        d0 = self.decode_dispatches
        fut = real(self, *a, **kw)
        if n % lanes == 0:
            deadline = time.monotonic() + 60
            while (self.decode_dispatches == d0
                   and time.monotonic() < deadline):
                time.sleep(0.0005)
        return fut

    base.submit = submit
    try:
        yield
    finally:
        base.submit = real


def batcher_launches(n_layers, draft_layers=0, warm=0):
    """Expected launches of a batcher row: kernel 1 ``n_layers`` x forward
    steps (+ draft layers x draft forwards + ``warm``), kernel 2
    ``n_layers`` x the split plan's flash prefill forwards."""
    def expect(rec, row):
        return (n_layers * rec.total("forward_steps")
                + draft_layers * rec.total("draft_forward_steps") + warm,
                n_layers * rec.total("prefill_forwards"))
    return expect


def spec_warm_launches(k, n_layers, draft_layers, menu):
    """Kernel 1 launches of ``_warm_block_sizes`` in the plain and the
    speculating batcher: a plain block of m steps runs m forwards (K=1
    excepted), a speculative one m + 1 draft forwards and one verify."""
    plain = sum(m for m in menu if 1 < m <= k) * n_layers
    spec = sum((m + 1) * draft_layers + n_layers for m in menu if m <= k)
    return plain + spec


def phase_rows(torch, card):
    """Phase 15: tpulab's eleven bench rows through the port's functions,
    each once, on the card."""
    import numpy as np

    from tpulab_torch.disagg import benchmark_disagg
    from tpulab_torch.engine import paged
    from tpulab_torch.engine.speculative import (SpeculativeGenerator,
                                                 benchmark_speculative)
    from tpulab_torch.hbm import benchmark_hbm_arbiter
    from tpulab_torch.kvcache import benchmark_kv_offload
    from tpulab_torch.models.transformer import (init_transformer_params,
                                                 make_generate_fn)
    from tpulab_torch.modelstore import benchmark_multi_model

    t_phase = time.perf_counter()
    c = LLAMA3_8B
    L = c["n_layers"]
    # the rows' own widths; the tree (``params=``) carries the rest
    width = dict(vocab=c["vocab"], d_model=c["d_model"],
                 n_heads=c["n_heads"], n_layers=L, n_kv_heads=c["n_kv_heads"],
                 rope_theta=c["rope_theta"])
    t0 = time.perf_counter()
    params = full_width_params(torch, L, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(f"rows: Llama-3-8B-width bf16 tree {time.perf_counter() - t0:.1f} "
        "s")
    kw8 = dict(n_heads=c["n_heads"], n_layers=L, n_kv_heads=c["n_kv_heads"],
               rope_theta=c["rope_theta"], compute_dtype=torch.bfloat16)
    bf = torch.bfloat16
    rows, secs, notes = {}, {}, {}
    launches = [0, 0]

    def row(name, fn, kw, expect, bf16=False):
        rows[name], rec, secs[name], n = run_row(torch, name, fn, kw,
                                                 expect, bf16)
        launches[0] += n[0]
        launches[1] += n[1]
        return rows[name], rec

    # decode dispatch: K-blocks against K=1, bit for bit; every burst's
    # head decodes first (syncs per token then fall as K grows at every
    # run, not only when each burst happens to queue whole or not)
    with head_first_bursts(ROWS_DECODE_DISPATCH["lanes"]):
        r, _ = row("decode_dispatch", paged.benchmark_decode_dispatch,
                   dict(ROWS_DECODE_DISPATCH, **width, dtype=bf,
                        params=params, device="cuda"), batcher_launches(L),
                   bf16=True)
    ks = ROWS_DECODE_DISPATCH["ks"]
    for k in ks[1:]:
        notes[f"decode_dispatch K={k}"] = hold_flag(
            torch, f"decode_dispatch parity_vs_k1 at K={k}",
            r["k"][str(k)]["parity_vs_k1"], "exact", [], params, kw8)
    spt = [r["k"][str(k)]["syncs_per_token"] for k in ks]
    if any(b >= a for a, b in zip(spt, spt[1:])):
        raise AssertionError(f"rows: decode_dispatch syncs per token "
                             f"{spt} do not fall as K grows {ks}")

    # speculative decode: the split plan's spec blocks against plain ones
    sd = ROWS_SPEC_DECODE
    r, rec = row("speculative_decode", paged.benchmark_speculative_decode,
                 dict(sd, **width, dtype=bf, params=params, device="cuda"),
                 batcher_launches(L, sd["draft_layers"], spec_warm_launches(
                     sd["k"], L, sd["draft_layers"],
                     paged.ContinuousBatcher.BLOCK_K_MENU)), bf16=True)
    if r["parity"] is not True:
        scaled = paged._scaled_tail(params, sd["draft_layers"], L,
                                    sd["tail_scale"])
        notes["speculative_decode"] = hold_flag(
            torch, "speculative_decode spec vs plain", r["parity"], "bf16",
            stream_pairs(*rec.made), scaled, kw8)
        del scaled
    else:
        notes["speculative_decode"] = "equal"

    # ragged attention: the split plan (flash prefill) against the ragged
    # plan, both on kernel 1
    r, rec = row("ragged_attention", paged.benchmark_ragged_attention,
                 dict(ROWS_RAGGED, **width, dtype=bf, params=params,
                      device="cuda"), batcher_launches(L), bf16=True)
    notes["ragged_attention"] = hold_flag(
        torch, "ragged_attention ragged_kernel vs legacy",
        r["ragged_kernel"]["parity"], "bf16", stream_pairs(*rec.made),
        params, kw8)

    # llm decode: bf16 against the int8 tree quantized from the same one
    ld = ROWS_LLM_DECODE
    r, _ = row("llm_decode", paged.benchmark_llm_decode,
               dict(ld, **width, dtype=bf, params=params, device="cuda"),
               lambda rec, row: (2 * L * 3 * ld["iters"], 0), bf16=True)
    if not r["int8_param_mb"] < r["bf16_param_mb"]:
        raise AssertionError(f"rows: llm_decode int8 {r['int8_param_mb']} "
                             f"MB not below bf16 {r['bf16_param_mb']} MB")
    del params
    torch.cuda.empty_cache()

    # kernel 1 against the gather math at tpulab's (lanes, context) combos
    sw = ROWS_SWEEP
    iters = [max(16, int(256 * (8 * 2048) / (b * ctx)))
             for b, ctx in sw["combos"]]
    row("decode_kernel_sweep", paged.benchmark_decode_kernel_sweep,
        dict(sw, device="cuda"),
        lambda rec, row: (sum(sw["n_layers"] * 3 * i for i in iters), 0))

    # the dense speculative generator against plain greedy, f32
    recorded = []
    generate = SpeculativeGenerator.generate

    def recording(self, prompt, steps):
        out = generate(self, prompt, steps)
        recorded.append((np.asarray(prompt), out))
        return out
    SpeculativeGenerator.generate = recording
    try:
        r, _ = row("speculative", benchmark_speculative,
                   dict(device="cuda"), lambda rec, row: (0, 0))
    finally:
        SpeculativeGenerator.generate = generate
    if r["exact_match"] is not True:
        sp = dict(n_heads=8, n_layers=8, compute_dtype=torch.float32)
        target = paged._scaled_tail(
            init_transformer_params(2048, 512, 8, 8, 2048, seed=0,
                                    device="cuda"), 2, 8, 0.05)
        prompt, got = recorded[-1]
        want = make_generate_fn(target, max_len=512, **sp)(
            prompt[None], len(got))[0].tolist()
        notes["speculative"] = hold_flag(
            torch, "speculative exact_match", False, "margin",
            [(prompt, want, got)], target, sp)
    else:
        notes["speculative"] = "equal"

    # the host-tier rows, f32 at head dim 64, on trees drawn here (seed 0)
    def small_tree(vocab, d_model, n_heads, n_layers):
        return init_transformer_params(vocab, d_model, n_heads, n_layers,
                                       4 * d_model, device="cuda")

    def f32_kw(n_heads, n_layers):
        return dict(n_heads=n_heads, n_layers=n_layers, n_kv_heads=n_heads,
                    compute_dtype=torch.float32)

    hw = ROWS_HOST_WIDTH
    r, _ = row("kv_offload", benchmark_kv_offload,
               dict(ROWS_KV_OFFLOAD, **hw, device="cuda",
                    params=small_tree(256, hw["d_model"], hw["n_heads"], 2)),
               batcher_launches(2))
    tree = small_tree(256, hw["d_model"], hw["n_heads"], 2)
    r, rec = row("disagg", benchmark_disagg,
                 dict(ROWS_DISAGG, **hw, params=tree, device="cuda"),
                 batcher_launches(2))
    # a lost shipment falls back to a local prefill and still gives equal
    # tokens: the mechanism is held to its counts as the CPU test holds it
    d, n_req = r["disagg"], ROWS_DISAGG["n_requests"]
    if (d["ship_failures"], d["decode_prefill_dispatches"],
            d["shipments"]) != (0, 0, n_req):
        raise AssertionError(
            f"rows: disagg ship_failures {d['ship_failures']}, decode "
            f"prefills {d['decode_prefill_dispatches']}, shipments "
            f"{d['shipments']} (want 0, 0, {n_req})")
    notes["disagg"] = hold_flag(
        torch, "disagg token_parity", r["token_parity"], "margin",
        stream_pairs(rec.made[0], rec.made[2]), tree, f32_kw(4, 2))
    tree = small_tree(256, 256, 4, 4)
    r, rec = row("hbm_arbiter", benchmark_hbm_arbiter,
                 dict(ROWS_HBM, params=tree, device="cuda"),
                 batcher_launches(4))
    for k in ("demotions", "evictions"):
        if not r["arbiter_on"][k] > 0:
            raise AssertionError(f"rows: hbm_arbiter {k} "
                                 f"{r['arbiter_on'][k]}")
    notes["hbm_arbiter"] = hold_flag(
        torch, "hbm_arbiter parity (tokens)", r["parity"], "margin",
        stream_pairs(*rec.made), tree, f32_kw(4, 4))
    if r["parity"] is not True and "model_outs" in r["arbiter_on"]:
        raise AssertionError("rows: hbm_arbiter model outputs differ (held "
                             "bit for bit)")
    # its own draw: the baseline's cold rebuild re-draws the weights
    r, _ = row("multi_model", benchmark_multi_model,
               dict(ROWS_MULTI_MODEL, **hw, device="cuda"),
               batcher_launches(2))
    for k in ("parity", "llm_parity", "vit_parity"):
        notes[f"multi_model {k}"] = hold_flag(
            torch, f"multi_model {k}", r[k], "exact", [], None, None)
    torch.cuda.empty_cache()
    log(f"rows: parity flags: {json.dumps(notes)}")
    dd, sd_r = rows["decode_dispatch"], rows["speculative_decode"]
    log("rows: decode_dispatch tok/s by K "
        + ", ".join(f"{k}: {dd['k'][str(k)]['tok_s']:.1f} "
                    f"({dd['k'][str(k)]['syncs_per_token']:.4f} syncs a "
                    "token)" for k in ks)
        + f"; speculative_decode acceptance "
        f"{sd_r['spec']['acceptance']:.3f}, uplift {sd_r['uplift']:.3f}; "
        f"llm_decode bf16 {rows['llm_decode']['bf16_tok_s']:.1f} / int8 "
        f"{rows['llm_decode']['int8_tok_s']:.1f} tok/s; kv_offload "
        "re-prefills off / on "
        f"{rows['kv_offload']['tier_off']['re_prefill_dispatches']} / "
        f"{rows['kv_offload']['tier_on']['re_prefill_dispatches']} [{card}]")
    log("rows: seconds by row " + json.dumps(
        {k: round(v, 1) for k, v in secs.items()}))
    log(f"rows: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


# ---------------------------------------------------------------- main
MEM_BLOCK = 64 << 20            # (a): the device arena's block
MEM_STAGING = 256 << 20         # (b): one pinned staging node
MEM_COPY_ITERS = 5
MEM_SPIN_CYCLES = 200_000_000   # (b): about 0.1 s of device spin
# (d): the card version of examples/04_long_context_stream.py
MEM_STREAM = dict(tokens=16384, window_count=4, window=2048, overlap=512,
                  chunk=512, seed=17)
MEM_NLL_TOL = 5e-2   # nats, |window NLL flash - plain|, both bf16 (a mean
#                      over 1536 tokens; per-token bf16 noise is 6-9e-2)
MEM_ENGINE_MAX_BATCH = 2        # (e): two buckets, 1 and 2


def mem_arenas(torch, card):
    """(a) tpulab's arena, transactional and best-fit sequences over
    ``make_cuda_allocator()``'s device blocks; the caching allocator's
    count moves by exactly the live blocks' bytes."""
    import tpulab_torch.memory as tm
    from tpulab_torch.cuda import CudaMemory, make_cuda_allocator

    raw = make_cuda_allocator()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()

    def held(label):
        got = torch.cuda.memory_allocated() - base
        want = raw.live_allocations * MEM_BLOCK
        if got != want or raw.bytes_in_use != want:
            raise RuntimeError(f"memory (a) {label}: memory_allocated moved "
                               f"{got}, tracked {raw.bytes_in_use}, live "
                               f"blocks x {MEM_BLOCK} = {want}")
        return raw.live_allocations

    assert raw.memory_type is CudaMemory and raw.max_alignment() == 256
    arena = tm.BlockArena(tm.FixedSizeBlockAllocator(raw, MEM_BLOCK),
                          cached=True)
    b = arena.allocate_block()
    buf = raw.buffer(b.addr)
    if not (buf.is_cuda and buf.dtype == torch.uint8
            and buf.numel() == MEM_BLOCK and int(buf.max()) == 0):
        raise RuntimeError("memory (a): a device block is not a zeroed "
                           f"uint8 tensor of {MEM_BLOCK} bytes on the card")
    del buf                     # the block's bytes now live in the arena only
    held("one block")
    arena.deallocate_block(b)
    b2 = arena.allocate_block()
    if b2.addr != b.addr or held("recycled") != 1:
        raise RuntimeError("memory (a): a freed block came back at another "
                           "address or allocated a new one")
    arena.deallocate_block(b2)
    arena.shrink_to_fit()
    if held("shrunk") != 0:
        raise RuntimeError("memory (a): live blocks after shrink_to_fit")
    # test_memory.py's transactional sequences, at device-block scale
    t = tm.make_transactional_allocator(arena)
    q = MEM_BLOCK // 4
    a1, a2 = t.allocate_node(q), t.allocate_node(q)
    if a2 != a1 + q:
        raise RuntimeError("memory (a): transactional bump not O(1)")
    a3 = t.allocate_node(3 * q)                 # forces a rotation
    if t.live_stacks != 2 or held("rotated") != 2:
        raise RuntimeError("memory (a): rotation did not take a new block")
    t.deallocate_node(a1)
    t.deallocate_node(a2)
    if t.live_stacks != 1:
        raise RuntimeError("memory (a): the drained stack was kept")
    t.deallocate_node(a3)
    addrs = [t.allocate_node(MEM_BLOCK // 8) for _ in range(8)]
    for a in addrs[:-1]:
        t.deallocate_node(a)
    last = t.allocate_node(MEM_BLOCK)           # retires the old stack
    t.deallocate_node(addrs[-1])
    if t.live_stacks != 1:
        raise RuntimeError("memory (a): whole-stack release failed")
    t.deallocate_node(last)
    try:
        t.allocate_node(2 * MEM_BLOCK)
        raise RuntimeError("memory (a): an oversize node was accepted")
    except tm.BadAllocationSize:
        pass
    n_trans = held("transactional")
    arena.shrink_to_fit()
    # test_memory.py's best-fit sequence over device blocks
    bf = tm.BFitAllocator(tm.FixedSizeBlockAllocator(raw, MEM_BLOCK))
    a, b_, c = (bf.allocate_node(n) for n in (1000, 2000, 500))
    bf.deallocate_node(b_)
    d = bf.allocate_node(1500)
    if d != b_:
        raise RuntimeError("memory (a): best fit missed the 2000-byte hole")
    e = bf.allocate_node(100, alignment=4096)
    for x in (a, c, d, e):
        bf.deallocate_node(x)
    if e % 4096 or bf.free_bytes != MEM_BLOCK or len(bf._free_by_addr) != 1:
        raise RuntimeError("memory (a): best-fit spans did not coalesce")
    held("bfit")
    desc = tm.make_allocator(raw).allocate_descriptor(4096)
    if not (desc.device_buffer.is_cuda and desc.memory_type is CudaMemory):
        raise RuntimeError("memory (a): a device descriptor carries no "
                           "tensor on the card")
    desc.release()
    for blk in list(bf._blocks):
        bf._arena.deallocate_block(blk)
    if held("closed") != 1 or t.live_stacks != 1:
        raise RuntimeError("memory (a): blocks other than the transactional "
                           "allocator's current stack outlived their users")
    log(f"memory: (a) device arenas on make_cuda_allocator(): a {MEM_BLOCK} "
        "B block recycled at its address with nothing new allocated, none "
        "live after shrink_to_fit; transactional bump / rotate / "
        f"whole-stack release ({n_trans} blocks live at its end: its cached "
        "block and its current stack, which tpulab's allocator also keeps); "
        "best fit reused the 2000 B hole and coalesced back to one span; "
        "memory_allocated moved by exactly the live blocks' bytes at every "
        f"step [{card}]")


def mem_staging(torch, card):
    """(b) a pinned 256 MiB staging node against pageable memory."""
    import tpulab_torch.memory as tm
    from tpulab_torch.cuda import make_staging_allocator
    from tpulab_torch.memory.descriptor import host_view

    st = make_staging_allocator()
    pg = tm.MallocAllocator()
    pin_addr = st.allocate_node(MEM_STAGING)
    pg_addr = pg.allocate_node(MEM_STAGING)
    pinned = torch.frombuffer(host_view(pin_addr, MEM_STAGING),
                              dtype=torch.uint8)
    pageable = torch.frombuffer(host_view(pg_addr, MEM_STAGING),
                                dtype=torch.uint8)
    if pin_addr % 4096 or not pinned.is_pinned() or pageable.is_pinned():
        raise RuntimeError(f"memory (b): staging node at 0x{pin_addr:x} "
                           f"aligned {pin_addr % 4096 == 0}, pinned "
                           f"{pinned.is_pinned()}; pageable pinned "
                           f"{pageable.is_pinned()}")
    if bool(pinned[:4096].any()):
        raise RuntimeError("memory (b): the staging node was not first-touched")
    pinned.copy_(torch.randint(0, 256, (MEM_STAGING,), dtype=torch.uint8))
    pageable.copy_(pinned)
    dev = torch.empty(MEM_STAGING, dtype=torch.uint8, device="cuda")

    def gbps(fn):
        times = []
        for _ in range(MEM_COPY_ITERS + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        return MEM_STAGING / sorted(times[1:])[len(times[1:]) // 2] / 1e9

    rates = {
        "h2d_pinned": gbps(lambda: dev.copy_(pinned, non_blocking=True)),
        "h2d_pageable": gbps(lambda: dev.copy_(pageable, non_blocking=True)),
        "d2h_pinned": gbps(lambda: pinned.copy_(dev, non_blocking=True)),
        "d2h_pageable": gbps(lambda: pageable.copy_(dev, non_blocking=True)),
    }
    if not torch.equal(pinned, pageable):
        raise RuntimeError("memory (b): the round trips changed bytes")
    # asynchrony: behind a device spin, the pinned copy returns at once
    torch.cuda.synchronize()
    torch.cuda._sleep(MEM_SPIN_CYCLES)
    t0 = time.perf_counter()
    dev.copy_(pinned, non_blocking=True)
    ret_s = time.perf_counter() - t0
    done = torch.cuda.current_stream().record_event()
    pending = not done.query()
    done.synchronize()
    wait_s = time.perf_counter() - t0
    if not pending:
        raise RuntimeError("memory (b): the pinned copy had completed when "
                           "it returned (it ran synchronously)")
    st.deallocate_node(pin_addr, MEM_STAGING)
    pg.deallocate_node(pg_addr, MEM_STAGING)
    again = st.allocate_node(MEM_STAGING)       # unregistered, re-registered
    st.deallocate_node(again, MEM_STAGING)
    del dev
    log(f"memory: (b) make_staging_allocator(): a {MEM_STAGING} B node, "
        "page-aligned, first-touched, is_pinned() True (cudaHostRegister); "
        f"GB/s (median of {MEM_COPY_ITERS}, CUDA events): H2D pinned "
        f"{rates['h2d_pinned']:.2f} vs pageable {rates['h2d_pageable']:.2f}, "
        f"D2H pinned {rates['d2h_pinned']:.2f} vs pageable "
        f"{rates['d2h_pageable']:.2f}; behind a device spin the pinned H2D "
        f"returned in {ret_s * 1e3:.3f} ms with the copy still pending "
        f"(complete {wait_s * 1e3:.1f} ms later) [{card}]")
    return rates


def mem_buffers(torch, card):
    """(c) ``Buffers`` on the framework: a second block for a second view."""
    from tpulab_torch.engine.buffers import Buffers

    bufs = Buffers(1024, block_size=1024)
    v1, v2 = bufs._carve(800), bufs._carve(800)
    depth = bufs._stack.depth
    if depth != 2 or not (v1.is_pinned() and v2.is_pinned()):
        raise RuntimeError(f"memory (c): Buffers(1024) gave two 800 B views "
                           f"from {depth} block(s), pinned "
                           f"{v1.is_pinned()} / {v2.is_pinned()}")
    v1.fill_(1)
    v2.fill_(2)
    if int(v1.sum()) != 800 or int(v2.sum()) != 1600:
        raise RuntimeError("memory (c): the two views overlap")
    bufs.reset()
    cached = bufs._arena.cached_blocks
    if bufs._stack.depth != 0 or cached != 2:
        raise RuntimeError(f"memory (c): reset left depth "
                           f"{bufs._stack.depth}, {cached} cached blocks")
    bufs.release()
    log("memory: (c) Buffers(1024, block_size=1024): two 800 B views from "
        "two page-locked blocks (a second block pushed), both back on "
        f"reset() ({cached} cached), returned by release() [{card}]")


def window_nll(torch, logits, tokens, overlap):
    """Mean NLL of a window's continuation (the carried-over context
    skipped), as examples/04_long_context_stream.py scores it."""
    logp = logits[0, overlap - 1:-1].float()
    nxt = tokens[0, overlap:]
    return (torch.logsumexp(logp, -1)
            - logp.gather(-1, nxt[:, None])[:, 0]).mean()


def mem_stream(torch, card):
    """(d) a 16,384-token stream through ``CudaCyclicWindowedStack`` at
    Llama-3-8B width, each window's forward on kernel 2."""
    import numpy as np

    import tpulab_torch.memory as tm
    from tpulab_torch.core.thread_pool import ThreadPool
    from tpulab_torch.cuda import make_staging_allocator
    from tpulab_torch.cuda.cyclic_buffer import CudaCyclicWindowedStack
    from tpulab_torch.models.transformer import (causal_attention,
                                                 transformer_apply)
    from tpulab_torch.ops.flash_attention import (flash_attention,
                                                  make_flash_attention_fn)

    c, s = LLAMA3_8B, MEM_STREAM
    t0 = time.perf_counter()
    params = full_width_params(torch, c["n_layers"], torch.bfloat16, seed=0)
    tree_s = time.perf_counter() - t0
    stride = s["window"] - s["overlap"]
    n_win = (s["tokens"] - s["overlap"]) // stride
    stream = np.random.default_rng(s["seed"]).integers(
        0, c["vocab"], s["tokens"], dtype=np.int32)
    expect = torch.from_numpy(stream).cuda()
    fwd = dict(n_heads=c["n_heads"], n_layers=c["n_layers"],
               compute_dtype=torch.bfloat16, n_kv_heads=c["n_kv_heads"],
               rope_theta=c["rope_theta"])
    flash = make_flash_attention_fn(causal=True)

    def nll_of(tokens, attention_fn):
        with torch.inference_mode():
            logits = transformer_apply(params, {"tokens": tokens},
                                       attention_fn=attention_fn,
                                       **fwd)["logits"]
            return window_nll(torch, logits, tokens, s["overlap"])

    nll_of(expect[None, :s["window"]].long(), flash)    # warm-up
    torch.cuda.synchronize()
    nll, same = {}, {}

    def compute(win_id, dev):
        lo = win_id * stride
        same[win_id] = (dev == expect[lo:lo + s["window"]]).all()
        nll[win_id] = nll_of(dev[None].long(), flash)
        return nll[win_id]

    staging = make_staging_allocator()
    desc = tm.make_allocator(staging).allocate_descriptor(
        (s["window_count"] * stride + s["overlap"]) * 4)
    most = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    with ThreadPool(1) as pool:
        stk = CudaCyclicWindowedStack(
            desc, s["window_count"], s["window"] * 4, s["overlap"] * 4,
            compute_fn=compute, dtype=torch.int32, executor=pool)
        for i in range(0, s["tokens"], s["chunk"]):
            stk.append(stream[i:i + s["chunk"]].tobytes())
            most = max(most, stk._cursor)
        stk.sync_all()
    stream_s = time.perf_counter() - t0
    launches = flash_attention.launches
    staged = (staging.live_allocations, desc.size)
    stk.release()
    if sorted(nll) != list(range(n_win)):
        raise RuntimeError(f"memory (d): windows {sorted(nll)}, want "
                           f"{n_win}")
    if launches != c["n_layers"] * n_win:
        raise RuntimeError(f"memory (d): kernel 2 launches {launches} != "
                           f"{c['n_layers']} x {n_win} windows")
    bad = [w for w in range(n_win) if not bool(same[w])]
    if bad:
        raise RuntimeError(f"memory (d): windows {bad} computed on bytes "
                           "other than the ones appended (a slot rewritten "
                           "under its asynchronous copy)")
    if most > desc.size or staged[0] != 1:
        raise RuntimeError(f"memory (d): host staging reached {most} B of "
                           f"a {desc.size} B descriptor ({staged[0]} nodes)")
    diffs = []
    for w in range(n_win):
        lo = w * stride
        plain = nll_of(expect[None, lo:lo + s["window"]].long(),
                       causal_attention)
        got, want = float(nll[w]), float(plain)
        if not (math.isfinite(got) and abs(got - want) <= MEM_NLL_TOL):
            raise RuntimeError(f"memory (d): window {w} NLL {got:.6f} with "
                               f"kernel 2 against {want:.6f} plain "
                               f"(tolerance {MEM_NLL_TOL})")
        diffs.append(abs(got - want))
    del params
    torch.cuda.empty_cache()
    tok_s = s["tokens"] / stream_s
    log(f"memory: (d) {s['tokens']} int32 tokens (seed {s['seed']}) through "
        f"CudaCyclicWindowedStack over a {desc.size} B pinned descriptor "
        f"({s['window_count']} windows of {s['window']} tokens, overlap "
        f"{s['overlap']}; appended {s['chunk']} at a time, one executor "
        f"thread) at Llama-3-8B width (bf16, tree drawn in {tree_s:.1f} s): "
        f"{n_win} windows, each on the bytes appended; window NLLs "
        f"{[round(float(nll[w]), 4) for w in range(n_win)]}, max |flash - "
        f"plain| {max(diffs):.3e} (<= {MEM_NLL_TOL}); kernel 2 launches "
        f"{launches} == {c['n_layers']} x {n_win}; host staging at most "
        f"{most} of {desc.size} B in {staged[0]} node; {tok_s:.1f} "
        f"tokens/s ({stream_s:.2f} s) [{card}]")
    return launches, tok_s


def mem_tools(torch, card):
    """(e) the two tools as subprocesses on the card's default device."""
    import shutil
    import subprocess
    import tempfile

    from tpulab_torch.engine.runtime import Runtime
    from tpulab_torch.models import build_model

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_onnx_util

    tmp = tempfile.mkdtemp(prefix="memory-")
    try:
        out = os.path.join(tmp, "rn50.engine")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "tpulab_torch.tools.build_engine",
             "--model", "resnet50", "--max-batch",
             str(MEM_ENGINE_MAX_BATCH), "--out", out],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        build_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise RuntimeError(f"memory (e): build_engine exited "
                               f"{run.returncode}: {run.stderr[-2000:]}")
        rep = json.loads(run.stdout)
        if rep["buckets"] != [1, 2] or sorted(os.listdir(out)) != [
                "bucket_1.pt2", "bucket_2.pt2", "params.npz", "spec.json",
                "tree.json"]:
            raise RuntimeError(f"memory (e): artifact {rep} "
                               f"{sorted(os.listdir(out))}")
        t0 = time.perf_counter()
        loaded = Runtime().load_engine(out)
        load_s = time.perf_counter() - t0
        mem = Runtime().compile_model(build_model(
            "resnet50", max_batch_size=MEM_ENGINE_MAX_BATCH))
        x = card_images(torch, 2, 31)
        got = loaded(2, {"input": x})["logits"]
        want = mem(2, {"input": x})["logits"]
        if not torch.equal(got, want):
            raise RuntimeError("memory (e): the artifact's logits differ "
                               "from the in-memory model's at bucket 2 (max "
                               f"{float((got - want).abs().max()):.3e})")
        del loaded, mem
        onnx_path = os.path.join(tmp, "resnet50.onnx")
        with open(onnx_path, "wb") as f:
            f.write(torch_onnx_util.resnet50_graph(IMPORT["seed"], 1000,
                                                   224)[0])
        t0 = time.perf_counter()
        summ = subprocess.run(
            [sys.executable, "-m", "tpulab_torch.tools.onnx_summary",
             onnx_path], cwd=HERE, capture_output=True, text=True,
            timeout=300)
        summ_s = time.perf_counter() - t0
        rep2 = json.loads(summ.stdout) if summ.stdout else {}
        if summ.returncode != 0 or rep2.get("importable") is not True:
            raise RuntimeError(f"memory (e): onnx_summary exited "
                               f"{summ.returncode}: {summ.stderr[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"memory: (e) python -m tpulab_torch.tools.build_engine --model "
        f"resnet50 --max-batch {MEM_ENGINE_MAX_BATCH} (the card, no --device):"
        f" buckets {rep['buckets']}, {rep['weights_bytes']} weight bytes, "
        f"build_s {rep['build_s']}, {build_s:.1f} s as a process; "
        f"load_engine without apply_fn in {load_s:.2f} s: bucket 2 logits "
        "bit for bit the in-memory model's; python -m "
        f"tpulab_torch.tools.onnx_summary on phase 16's ResNet-50 ONNX: "
        f"importable, {rep2['nodes']} nodes, {rep2['weight_bytes']} weight "
        f"bytes, exit 0 in {summ_s:.1f} s [{card}]")
    return build_s, load_s


def mem_device_info(torch, card):
    """(f) ``DeviceInfo`` on the card against nvidia-smi and torch."""
    from tpulab_torch.cuda import DeviceInfo

    name = card.rsplit(",", 1)[0].strip()
    kind = DeviceInfo.device_kind()
    _free, total = torch.cuda.mem_get_info()
    info = DeviceInfo.memory_info()
    cpus = DeviceInfo.cpu_affinity()
    attrs = DeviceInfo.attributes()
    problems = []
    if kind != name:
        problems.append(f"device_kind {kind!r} != nvidia-smi's {name!r}")
    if info.bytes_limit != total:
        problems.append(f"bytes_limit {info.bytes_limit} != {total}")
    if DeviceInfo.peak_flops("bf16") != 989.4e12:
        problems.append(f"peak_flops bf16 {DeviceInfo.peak_flops('bf16')}")
    if not cpus or max(cpus) >= (os.cpu_count() or 1):
        problems.append(f"cpu_affinity {list(cpus)}")
    if DeviceInfo.alignment() != 256 or DeviceInfo.coords() is not None:
        problems.append("alignment / coords")
    if problems:
        raise RuntimeError("memory (f): " + "; ".join(problems))
    log(f"memory: (f) DeviceInfo: count {DeviceInfo.count()}, device_kind "
        f"{kind!r} == nvidia-smi's; memory_info in use {info.bytes_in_use}, "
        f"limit {info.bytes_limit} == mem_get_info's total, peak "
        f"{info.peak_bytes_in_use}; peak_flops bf16 "
        f"{DeviceInfo.peak_flops('bf16'):.4g}, int8 "
        f"{DeviceInfo.peak_flops('int8'):.4g}; cpu_affinity {len(cpus)} CPUs "
        f"({min(cpus)}-{max(cpus)}) of {os.cpu_count()}; attributes "
        f"{attrs} [{card}]")


def phase_memory(torch, card):
    """The memory library and the device layer's memory side (module
    docstring, phase 17).  Returns kernel 2's launches over (d)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    secs = {}
    for label, fn in (("a", mem_arenas), ("b", mem_staging),
                      ("c", mem_buffers), ("d", mem_stream),
                      ("e", mem_tools), ("f", mem_device_info)):
        t0 = time.perf_counter()
        res = fn(torch, card)
        secs[label] = time.perf_counter() - t0
        if label == "d":
            launches = res[0]
    log(f"memory: phase {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in secs.items())
        + f") [{card}]")
    return launches


# ---------------------------------------------------------------- phase 18
# (a) the new dtype cases of kernels 1 and 3 on the serving geometry: the
# tensor-core cells (q, pages) with their cases, then kernel 1's two mixed
# fma cells; kernel 3's (lanes, inclusive position) cases
DT_RAGGED = (("f16/f16", "float16", "float16", ("all_decode",
                                                 "chunk_over_ctx",
                                                 "verify_k8")),
             ("bf16/e5m2", "bfloat16", "float8_e5m2", ("all_decode",
                                                        "chunk_over_ctx",
                                                        "verify_k8")),
             ("f16/e5m2", "float16", "float8_e5m2", ("all_decode",
                                                      "chunk_over_ctx",
                                                      "verify_k8")),
             ("bf16/f16", "bfloat16", "float16", ("all_decode",)),
             ("f16/bf16", "float16", "bfloat16", ("all_decode",)))
DT_PAGED = (("f16/f16", "float16", "float16"),
            ("bf16/e5m2", "bfloat16", "float8_e5m2"),
            ("f16/e5m2", "float16", "float8_e5m2"))
DT_PAGED_CASES = ((8, 1023), (1, 2047))
# (c) the serves at Llama-3-8B width, depth cut to DT_LAYERS
DT_LAYERS = 8
DT_BURST = (700, 300, 64, 16)        # prompt lengths of the burst
DT_STEPS = 16
DT_SAMPLED = dict(temperature=0.8, seed=2020)   # the burst's last request
DT_VICTIM, DT_VICTIM_STEPS, DT_HI = 1000, 24, 200
DT_KV_OFFLOAD = 1 << 30


def beside_ms(rows, kernel, case, dtypes):
    """The time of an earlier row of the same case (None if there is
    none)."""
    return next((r["ms"] for r in rows.get(kernel, ())
                 if (r["case"], r["dtypes"]) == (case, dtypes)), None)


def fmt_ms(x):
    return "n/a" if x is None else f"{x:.4f}"


def dtype_kernels(torch, timer, rows):
    """(a) Kernels 1 and 3 over f16 and e5m2 pools and f16 q, kernel 2 at
    f16: each case against its plain version on the same bytes, relaunched
    bit for bit on its stated body; e5m2 pools also relaunched over a copy
    with 0x7F (NaN) in every dead position, which must not move a bit; a
    skipped page (kernels 1 and 3) and a dropped diagonal tile (kernel 2)
    rejected.  Times beside the same case's bf16 and e4m3 rows and, for
    f16 K/V, SDPA at f16 (no library call takes e5m2 K/V, nor mixed q and
    K/V types: "n/a")."""
    import numpy as np

    from tpulab_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference,
        paged_splits)
    from tpulab_torch.ops.ragged_attention import (
        _sm_count, ragged_body, ragged_paged_attention,
        ragged_paged_attention_reference, ragged_splits)

    g = RA_GEOM
    rng = np.random.default_rng(18)
    pool32, tables = serving_pool(torch, np, rng)
    n_sm = _sm_count(torch.cuda.current_device())
    cases = dict((n, (q, kv)) for n, q, kv in ra_cases())
    t = g["mp"] * g["s"]
    new = {"ragged": [], "paged": [], "flash": []}
    pools = {name: pool32.to(getattr(torch, name))
             for name in ("float16", "float8_e5m2", "bfloat16")}
    del pool32

    def row(kernel, case, dname, body, err, ms, plain_ms, bound_ms, by,
            lib_ms):
        r = dict(case=case, dtypes=dname, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                 library_ms=lib_ms, body=body,
                 bf16_ms=beside_ms(rows, kernel, case, "bf16/bf16"),
                 e4m3_ms=beside_ms(rows, kernel, case, "bf16/e4m3"))
        new[kernel].append(r)
        log(f"dtypes: {kernel} {case:<14} {dname:<9} {body:<10} "
            f"err={err:.2e} kernel={ms:.4f} plain={plain_ms:.4f} "
            f"bound={bound_ms:.4f} ({by}) ms; beside bf16/bf16 "
            f"{fmt_ms(r['bf16_ms'])}, bf16/e4m3 {fmt_ms(r['e4m3_ms'])} | "
            f"yardstick, unused by the port: sdpa={fmt_ms(lib_ms)} ms")

    def poisoned_equal(label, call, pool, tab, first_dead, got):
        if pool.dtype != torch.float8_e5m2:
            return
        bad = nan_dead_tails(torch, pool, tab, first_dead)
        if not torch.equal(call(bad), got):
            raise AssertionError(f"{label}: 0x7F in dead positions changed "
                                 "the output")

    for dname, q_name, kv_name, names in DT_RAGGED:
        q_dt, kv_dt = getattr(torch, q_name), getattr(torch, kv_name)
        pool = pools[kv_name]
        kind = "f32" if q_dt == torch.float32 else "bf16"
        for name in names:
            q_lens_l, kv_lens_l = cases[name]
            m = max(q_lens_l)
            q = torch.from_numpy(rng.standard_normal(
                (g["b"], m, g["hq"], g["d"])).astype(np.float32)).cuda()
            q = q.to(q_dt)
            q_lens, kv_lens = (torch.tensor(x, dtype=torch.int32,
                                            device="cuda")
                               for x in (q_lens_l, kv_lens_l))
            args = (q, pool, tables, q_lens, kv_lens)
            body = ragged_body(q_dt, kv_dt, g["d"])
            splits = ragged_splits(g["b"], m, g["hq"], g["hkv"], g["mp"],
                                   g["s"], n_sm, body)
            label = f"ragged {name} {dname}"
            got = launch_twice(torch, label, ragged_paged_attention,
                               lambda: ragged_paged_attention(*args), body)
            err = check_close(torch, label, got,
                              ragged_paged_attention_reference(*args))
            poisoned_equal(label, lambda p: ragged_paged_attention(
                q, p, tables, q_lens, kv_lens), pool, tables, kv_lens, got)
            if name == "all_decode":
                skip = torch.cat([tables[:, :5], tables[:, 6:],
                                  tables[:, :1]], 1)
                check_rejects(torch, f"ragged skipped page, 1024 context, "
                              f"{dname}", got,
                              ragged_paged_attention_reference(
                                  q, pool, skip, q_lens, kv_lens - g["s"]))
            ms = timer(lambda: ragged_paged_attention(*args), iters=20)
            plain_ms = timer(lambda: ragged_paged_attention_reference(*args),
                             iters=3, warmup=1)
            lib_ms = None
            if q_dt == kv_dt:
                pos = (kv_lens - q_lens)[:, None] + torch.arange(
                    m, device="cuda")
                ar = torch.arange(t, device="cuda")[None, None]
                vis = (ar <= pos[..., None]) & (ar < kv_lens[:, None, None])
                lib_ms = sdpa_decode_ms(torch, timer, q, pool, tables, vis,
                                        g["hq"] // g["hkv"])
            bound_ms, by = ra_bound(q_lens_l, kv_lens_l, m, q.element_size(),
                                    pool.element_size(), kind)
            row("ragged", name, dname, f"{body} x{splits}", err, ms,
                plain_ms, bound_ms, by, lib_ms)

    for dname, q_name, kv_name in DT_PAGED:
        q_dt = getattr(torch, q_name)
        pool = pools[kv_name]
        for lanes, pos in DT_PAGED_CASES:
            tab = tables[:lanes]
            q = torch.from_numpy(rng.standard_normal(
                (lanes, g["hq"], g["d"])).astype(np.float32)).cuda().to(q_dt)
            lengths = torch.full((lanes,), pos, dtype=torch.int32,
                                 device="cuda")
            args = (q, pool, tab, lengths)
            case = f"{lanes} x {pos + 1}"
            label = f"paged {case} {dname}"
            splits = paged_splits(lanes, g["hkv"], g["mp"], g["s"], n_sm)
            got = launch_twice(torch, label, paged_decode_attention,
                               lambda: paged_decode_attention(*args))
            err = check_close(torch, label, got,
                              paged_decode_attention_reference(*args))
            poisoned_equal(label, lambda p: paged_decode_attention(
                q, p, tab, lengths), pool, tab, lengths + 1, got)
            if lanes == 8:
                skip = torch.cat([tab[:, :5], tab[:, 6:], tab[:, :1]], 1)
                check_rejects(torch, f"paged skipped page, 1024 context, "
                              f"{dname}", got,
                              paged_decode_attention_reference(
                                  q, pool, skip, lengths - g["s"]))
            ms = timer(lambda: paged_decode_attention(*args), iters=20)
            plain_ms = timer(lambda: paged_decode_attention_reference(*args),
                             iters=3, warmup=1)
            lib_ms = None
            if q_dt == pool.dtype:
                vis = (torch.arange(t, device="cuda")[None, None]
                       <= lengths[:, None, None])
                lib_ms = sdpa_decode_ms(torch, timer, q[:, None], pool, tab,
                                        vis, g["hq"] // g["hkv"])
            n_ctx = lanes * (pos + 1)
            bound_ms, by = bound(
                n_ctx * g["hkv"] * g["d"] * 2 * pool.element_size()
                + 2 * lanes * g["hq"] * g["d"] * q.element_size()
                + lanes * g["mp"] * 4 + lanes * 4,
                4 * g["d"] * g["hq"] * n_ctx, "f32")
            row("paged", case, dname, f"ring x{splits}", err, ms, plain_ms,
                bound_ms, by, lib_ms)
    del pools

    # D 32 (ex07_llm_server's default heads: Hq 8, Hkv 2): the fma body
    # of kernel 1 over bf16 and e4m3 pages (its two serves in (d)), and
    # kernel 2's f32 and bf16 fma body
    from tpulab_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_reference,
                                                  flash_body)
    g32 = dict(b=8, hq=8, hkv=2, d=32, s=16, mp=64)
    drng = np.random.default_rng(32)
    n32 = g32["b"] * g32["mp"] + 1
    pool32 = torch.from_numpy(drng.standard_normal(
        (n32, 2, g32["s"], g32["hkv"], g32["d"])).astype(np.float32)).cuda()
    tab32 = torch.from_numpy((drng.permutation(n32 - 1) + 1).astype(
        np.int32).reshape(g32["b"], g32["mp"])).cuda()
    for q_name, kv_name, m in (("bfloat16", "bfloat16", 1),
                               ("bfloat16", "float8_e4m3fn", 1),
                               ("bfloat16", "bfloat16", 64)):
        q_dt, kv_dt = getattr(torch, q_name), getattr(torch, kv_name)
        q = torch.from_numpy(drng.standard_normal(
            (g32["b"], m, g32["hq"], g32["d"])).astype(np.float32)).cuda()
        args = (q.to(q_dt), pool32.to(kv_dt), tab32,
                torch.full((g32["b"],), m, dtype=torch.int32, device="cuda"),
                torch.full((g32["b"],), 1000, dtype=torch.int32,
                           device="cuda"))
        label = (f"ragged D 32 {m} x 1000 {dtype_name(q_dt)}/"
                 f"{dtype_name(kv_dt)}")
        got = launch_twice(torch, label, ragged_paged_attention,
                           lambda: ragged_paged_attention(*args), "fma")
        err = check_close(torch, label, got,
                          ragged_paged_attention_reference(*args))
        log(f"dtypes: {label}: fma body, err={err:.2e}, relaunch "
            "bit-identical")
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        q, k, v = (torch.from_numpy(drng.standard_normal(
            (1, 512, 8, 32)).astype(np.float32)).cuda().to(dt)
                   for _ in range(3))
        label = f"flash D 32 T=512 causal {dname}"
        got = launch_twice(torch, label, flash_attention,
                           lambda: flash_attention(q, k, v),
                           flash_body(dt, 32))
        err = check_close(torch, label, got,
                          flash_attention_reference(q, k, v))
        log(f"dtypes: {label}: fma body, err={err:.2e}, relaunch "
            "bit-identical")
    del pool32

    frng = np.random.default_rng(19)
    for b, h, d, tlen in ((FA_GEOM["b"], FA_GEOM["h"], FA_GEOM["d"],
                           FA_TS[-1]),
                          (FA_RANK["b"], FA_RANK["h"], FA_RANK["d"],
                           FA_RANK["t"])):
        r = flash_case(torch, timer, frng, b, h, d, tlen, "float16", True,
                       True)
        r["bf16_ms"] = beside_ms(rows, "flash", r["case"], "bfloat16")
        new["flash"].append(r)
        log(f"dtypes: flash {r['case']} float16 beside bfloat16 "
            f"{fmt_ms(r['bf16_ms'])} ms")
    return new


def dtype_casts(torch):
    """(b) The card's casts to float16, float8_e5m2 and float8_e4m3fn over
    every bf16 and f16 pattern and the f32 specials (1 << 20 random f32
    bit patterns among them, NaN payloads included) against the CPU's:
    ``Tensor.to`` bit for bit on every number (its NaN codes differ on the
    card: counted), and the batcher's ``to_kv_dtype`` bit for bit on
    every input."""
    import numpy as np

    from tpulab_torch.engine.paged import to_kv_dtype

    pats = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    specials = torch.tensor(
        [0.0, -0.0, 57344.0, -57344.0, 61439.0, 61440.0, 61441.0, 65504.0,
         65519.0, 65520.0, -65520.0, 1e6, -1e30, float("inf"),
         float("-inf"), float("nan"), -float("nan"), 2.0 ** -16,
         2.0 ** -17, 2.0 ** -24, 2.0 ** -25, 1e-30, 448.0, 464.0,
         464.00003], dtype=torch.float32)
    rand = torch.from_numpy(np.random.default_rng(18).integers(
        0, 1 << 32, 1 << 20, dtype=np.uint64).astype(np.uint32).view(
            np.float32))
    n, nan_codes = 0, {}
    for src in (pats.view(torch.bfloat16), pats.view(torch.float16),
                torch.cat([specials, rand])):
        num = ~torch.isnan(src)
        for dt in (torch.float16, torch.float8_e5m2, torch.float8_e4m3fn):
            key = f"{dtype_name(src.dtype)} -> {dtype_name(dt)}"
            for name, cast in (("to_kv_dtype", lambda x: to_kv_dtype(x, dt)),
                               (".to", lambda x: x.to(dt))):
                cpu = cast(src).view(torch.uint8).reshape(src.numel(), -1)
                card = cast(src.cuda()).cpu().view(torch.uint8).reshape(
                    src.numel(), -1)
                same = (cpu == card).all(-1)
                if name == "to_kv_dtype" and not same.all():
                    at = (~same).nonzero().flatten()[:4]
                    raise AssertionError(
                        f"{key} to_kv_dtype: the card's bits differ from "
                        f"the CPU's at {int((~same).sum())} inputs, e.g. "
                        f"{src[at].tolist()}: CPU {cpu[at].tolist()}, "
                        f"card {card[at].tolist()}")
                if not same[num].all():
                    raise AssertionError(f"{key} .to: the card's bits differ "
                                         "from the CPU's on a number")
                if name == ".to":
                    nan_codes[key] = int((~same).sum())
            n += src.numel()
    log(f"dtypes: casts on the card == on the CPU bit for bit over every "
        f"bf16 and f16 pattern and {specials.numel()} f32 specials + "
        f"{rand.numel()} random f32 bit patterns ({n} values): "
        f"to_kv_dtype on every input; .to on every number, its NaN codes "
        f"differing on the card at {nan_codes} inputs (to_kv_dtype gives "
        f"jnp's)")


@contextlib.contextmanager
def plain_attention():
    """The batcher's attention on the kernels' plain versions, on the
    card: the ragged wrapper's name in ``engine.paged`` and the flash
    module's forward swapped for their references (no kernel launches)."""
    import tpulab_torch.engine.paged as paged
    from tpulab_torch.ops.ragged_attention import \
        ragged_paged_attention_reference

    fa = sys.modules["tpulab_torch.ops.flash_attention"]
    saved = paged.ragged_paged_attention, fa._forward
    paged.ragged_paged_attention = ragged_paged_attention_reference
    fa._forward = fa.flash_attention_reference
    try:
        yield
    finally:
        paged.ragged_paged_attention, fa._forward = saved


def held_to_plain(torch, params, kw, label, prompt, want, got, kv_dtype,
                  sampling=None):
    """``got`` (the kernels) equals ``want`` (the plain attention); or,
    from the first step where they differ, every pick of both lies within
    twice that position's path noise below the plain replay's top score.
    The noise is the largest distance one logit moves between a ragged
    forward over a fresh ``kv_dtype`` pool on the kernels and the same
    forward on their plain versions (teacher-forced on each stream's own
    prefix).  Returns a note for the log."""
    import numpy as np

    if got == want:
        return None
    n = min(len(want), len(got))
    i = next((j for j in range(n) if want[j] != got[j]), n)
    if i == n:
        raise AssertionError(f"{label}: lengths {len(want)} != {len(got)}")
    worst = 0.0
    for stream in (want, got):
        seq = np.concatenate([prompt, np.asarray(stream[:-1],
                                                 np.int32)])[None]
        kern = replay_logits(torch, params, kw, seq, kv_dtype,
                             tail=len(stream)).float()
        with plain_attention():
            plain = replay_logits(torch, params, kw, seq, kv_dtype,
                                  tail=len(stream)).float()
        noise = (kern - plain).abs().amax(-1)
        scores, scale = sampled_scores(torch, plain, sampling,
                                       len(prompt) - 1)
        noise = noise * scale
        picks = torch.tensor(stream, device=plain.device)
        gap = scores.amax(-1) - scores.gather(1, picks[:, None])[:, 0]
        bad = [(j, float(gap[j]), float(noise[j]))
               for j in range(i, len(stream)) if gap[j] > 2 * noise[j]]
        if bad:
            raise AssertionError(f"{label}: picks (step, gap, noise) {bad} "
                                 "lie over twice the kernel-vs-plain path "
                                 "noise below the plain top score")
        worst = max(worst, float((gap[i:] / noise[i:].clamp_min(1e-30))
                                 .max()))
    return (f"{label} differs from step {i}, every pick from there on "
            f"within {worst:.2f} x the kernel-vs-plain path noise")


def dtype_batcher(torch, params, compute, kv_dtype, plan, offload):
    from tpulab_torch.engine.paged import ContinuousBatcher

    c = LLAMA3_8B
    cfg = dict(SERVE, **(SPLIT if plan == "split" else {}))
    if offload:
        cfg.update(lanes=1, kv_offload=DT_KV_OFFLOAD)
    return ContinuousBatcher(params, n_heads=c["n_heads"],
                             n_layers=DT_LAYERS, n_kv_heads=c["n_kv_heads"],
                             rope_theta=c["rope_theta"],
                             compute_dtype=compute, kv_dtype=kv_dtype,
                             device="cuda", **cfg)


def dtype_serve(torch, params, compute, kv_dtype, plan, card):
    """One serve on the kernels (every count set to 0 just before, read
    just after) and the same on plain attention; returns the kernels'
    launches by form.  f16 compute: the burst; bf16 over e5m2 pages: one
    lane, a victim outranked at its 4th token, swapped to the host tier
    and restored."""
    import numpy as np

    from tpulab_torch.engine.paged import SamplingParams
    from tpulab_torch.ops.flash_attention import flash_attention
    from tpulab_torch.ops.ragged_attention import ragged_paged_attention

    c = LLAMA3_8B
    kw = dict(n_heads=c["n_heads"], n_layers=DT_LAYERS,
              n_kv_heads=c["n_kv_heads"], rope_theta=c["rope_theta"],
              compute_dtype=compute)
    offload = kv_dtype == torch.float8_e5m2
    rng = np.random.default_rng(20)
    label = (f"{plan} plan, {dtype_name(compute)} compute over "
             f"{dtype_name(kv_dtype or compute)} pages")
    if offload:
        prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
                   for n in (DT_VICTIM, DT_HI)]
        samplings = [None, None]
    else:
        prompts = [rng.integers(0, c["vocab"], (n,)).astype(np.int32)
                   for n in DT_BURST]
        samplings = [None] * (len(DT_BURST) - 1) + [SamplingParams(
            device=True, **DT_SAMPLED)]

    def run(cb):
        if offload:
            return preempted_run(cb, prompts[0], prompts[1],
                                 DT_VICTIM_STEPS)
        with cb._cv:
            futs = [cb.submit(p, DT_STEPS, **({"sampling": s} if s else {}))
                    for p, s in zip(prompts, samplings)]
        return [list(f.result(timeout=600)) for f in futs]

    cb = dtype_batcher(torch, params, compute, kv_dtype, plan, offload)
    try:
        for fn in (ragged_paged_attention, flash_attention):
            fn.launches = 0
            fn.launches_by_body = dict.fromkeys(fn.launches_by_body, 0)
            fn.launches_by_form = dict.fromkeys(fn.launches_by_form, 0)
        before = (cb.forward_steps, cb.prefill_forwards)
        t0 = time.perf_counter()
        got = run(cb)
        wall = time.perf_counter() - t0
        forms = {"ragged": dict(ragged_paged_attention.launches_by_form),
                 "flash": dict(flash_attention.launches_by_form)}
        steps = cb.forward_steps - before[0]
        prefills = cb.prefill_forwards - before[1]
        tier = None
        if offload:
            mgr = cb.kv_offload
            if not mgr.drain(60):
                raise AssertionError(f"{label}: write-behind stuck")
            tier = (cb.preemptions, mgr.swap_outs, mgr.swap_ins,
                    mgr.swap_failures, mgr.swap_drops, cb.prompt_fills)
        balanced = cb.pool.free_pages == cb.pool.n_pages - 1
    finally:
        cb.shutdown()
    cb = dtype_batcher(torch, params, compute, kv_dtype, plan, offload)
    try:
        with plain_attention():
            want = run(cb)
    finally:
        cb.shutdown()
    form = "wgmma f16" if compute == torch.float16 else "wgmma bf16"
    ra = forms["ragged"]
    fa = forms["flash"]
    if ra != {k: (DT_LAYERS * steps if k == form else 0) for k in ra}:
        raise AssertionError(f"{label}: ragged launches by form {ra}, want "
                             f"{DT_LAYERS} x {steps} on {form}")
    if fa != {k: (DT_LAYERS * prefills if k == form else 0) for k in fa}:
        raise AssertionError(f"{label}: flash launches by form {fa}, want "
                             f"{DT_LAYERS} x {prefills} on {form}")
    if (plan == "split") != (prefills > 0) or not balanced:
        raise AssertionError(f"{label}: {prefills} prefill forwards, pages "
                             f"balanced {balanced}")
    if tier is not None and tier != (1, 1, 1, 0, 0, 2):
        raise AssertionError(f"{label}: (preemptions, swap-outs, swap-ins, "
                             f"failures, drops, prompt fills) {tier}, want "
                             "(1, 1, 1, 0, 0, 2)")
    notes = []
    for i, (p, s) in enumerate(zip(prompts, samplings)):
        if any(not 0 <= t < c["vocab"] for t in got[i]):
            raise AssertionError(f"{label}: token outside [0, vocab)")
        note = held_to_plain(torch, params, kw, f"{label} request {i}", p,
                             want[i], got[i], kv_dtype or compute, s)
        if note:
            notes.append(note)
    n_tok = sum(len(x) for x in got)
    log(f"dtypes: {label}: {len(got)} requests, {n_tok} tokens in "
        f"{wall:.3f} s = {n_tok / wall:.1f} tok/s; kernel 1 {form} "
        f"{ra[form]} = {DT_LAYERS} x {steps} forward steps, kernel 2 "
        f"{form} {fa[form]} = {DT_LAYERS} x {prefills} prefills"
        + (f"; host tier (preemptions, swap-outs, swap-ins, failures, "
           f"drops, prompt fills) {tier}" if tier else "")
        + "; streams against the plain attention: "
        + ("; ".join(notes) if notes else "identical") + f" [{card}]")
    return forms


def dtype_serves(torch, card):
    """(c) At Llama-3-8B width (DT_LAYERS layers, random weights, seed
    0), under both plans: an f16-compute serve (f16 pages by default) of
    a short burst, and a bf16 serve over e5m2 pages with one lane
    preempted to the host tier and restored; each against the same
    batcher on plain attention."""
    params = full_width_params(torch, DT_LAYERS, torch.float16, 0)
    total = {"ragged": {}, "flash": {}}
    for compute, kv_dtype in ((torch.float16, None),
                              (torch.bfloat16, torch.float8_e5m2)):
        if compute == torch.bfloat16:
            params = tree_cast(params, compute)
        for plan in ("ragged", "split"):
            forms = dtype_serve(torch, params, compute, kv_dtype, plan,
                                card)
            for kernel, by in forms.items():
                for k, n in by.items():
                    total[kernel][k] = total[kernel].get(k, 0) + n
    del params
    torch.cuda.empty_cache()
    return total


def example_run(args, timeout=300):
    """``python -m tpulab_torch.examples.<args>`` from the checkout;
    returns (seconds, stdout) or raises with the tail of stderr."""
    import subprocess

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          f"tpulab_torch.examples.{args[0]}", *args[1:]],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=HERE)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(args)} exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    return time.perf_counter() - t0, out.stdout


def example_llm(extra):
    """``ex07_llm_server --oneshot`` on the card at its default width with
    ``extra`` flags, driven by its own client mode (16 greedy tokens);
    the server must exit 0 after the request.  Returns (seconds, tokens,
    the server's banner)."""
    import subprocess

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    srv = subprocess.Popen(
        [sys.executable, "-m", "tpulab_torch.examples.ex07_llm_server",
         "--port", "0", "--oneshot", *extra], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=HERE)
    try:
        seen = []
        for line in srv.stdout:
            seen.append(line)
            if "LLM server on :" in line:
                break
        else:
            raise AssertionError("ex07 server died at startup:\n"
                                 + "".join(seen)[-3000:])
        banner = seen[-1].strip()
        port = banner.split("LLM server on :")[1].split()[0]
        _, out = example_run(["ex07_llm_server", "--connect",
                              f"localhost:{port}", "--prompt", "1,2,3,4",
                              "--steps", "16"], timeout=180)
        toks = out.split("\n")[0].split()
        rest = srv.stdout.read()
        if srv.wait(timeout=60) != 0:
            raise AssertionError(f"ex07 server {extra} exited "
                                 f"{srv.returncode}: {rest[-2000:]}")
    finally:
        srv.kill()
    if (len(toks) != 16 or not out.strip().endswith("done")
            or "kernel=True" not in banner):
        raise AssertionError(f"ex07 {extra}: client printed {out!r}, "
                             f"server {banner!r}")
    return time.perf_counter() - t0, [int(t) for t in toks], banner


def dtype_examples(card):
    """(d) The entry points users run, each a subprocess on the card:
    ``ex07_llm_server --oneshot`` at its default width and with
    ``--kv-fp8`` (its own client's 16 greedy tokens), ``ex30_python_api``
    and ``ex04_long_context_stream`` at their defaults, all four at once;
    then ``ex00_basic_infer --model resnet50 --batch-size 8 --seconds 3``
    alone.  Each exits 0 with its own printed checks."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as ex:
        llm = [ex.submit(example_llm, extra) for extra in ([], ["--kv-fp8"])]
        api = ex.submit(example_run, ["ex30_python_api"])
        stream = ex.submit(example_run, ["ex04_long_context_stream"])
        (s07, t07, b07), (s08, t08, b08) = (f.result() for f in llm)
        s30, out30 = api.result()
        s04, out04 = stream.result()
    if "remote == local: OK" not in out30:
        raise AssertionError(f"ex30: {out30[-1000:]}")
    m = re.search(r"scored (\d+) overlapping windows", out04)
    if not m or int(m.group(1)) < 1 or "generated continuation" not in out04:
        raise AssertionError(f"ex04: {out04[-1000:]}")
    s00, out00 = example_run(["ex00_basic_infer", "--model", "resnet50",
                              "--batch-size", "8", "--seconds", "3"])
    rate = json.loads(out00.strip().splitlines()[-1])["inf/sec"]
    if not rate > 0:
        raise AssertionError(f"ex00: {out00[-1000:]}")
    log(f"dtypes: examples: ex07 default {s07:.1f} s ({b07}; tokens "
        f"{t07}), ex07 --kv-fp8 {s08:.1f} s (tokens {t08}), ex30 {s30:.1f} "
        f"s (remote == local: OK), ex04 {s04:.1f} s ({m.group(0)}) — these "
        f"four at once; then ex00 resnet50 batch 8 {s00:.1f} s, "
        f"{rate:.1f} inf/s [{card}]")


def phase_dtypes(torch, timer, rows, card):
    """Phase 18: f16 compute and f16 / e5m2 pages through kernels 1-3,
    the casts, the serves, and the examples users run."""
    t0 = time.perf_counter()
    new = dtype_kernels(torch, timer, rows)
    log(f"dtypes: (a) kernels {time.perf_counter() - t0:.1f} s")
    dtype_casts(torch)
    t1 = time.perf_counter()
    forms = dtype_serves(torch, card)
    log(f"dtypes: (c) serves {time.perf_counter() - t1:.1f} s; launches "
        f"by form {forms}")
    t1 = time.perf_counter()
    dtype_examples(card)
    log(f"dtypes: (d) examples {time.perf_counter() - t1:.1f} s")
    log(f"dtypes: phase {time.perf_counter() - t0:.1f} s")
    return new, forms


def kernel_entry(name, source, replaces, launches, rows, main, case,
                 extra=None, forms=None):
    """One kernel's line: times of its main case, the max error over
    that case's dtype mix, (kernels with several bodies) the body, with
    its split count, that ran each case, the main case in other dtypes
    (``extra``: key -> its case and dtype mix, e.g. ``"e4m3"``, ``"f16"``,
    ``"e5m2"``) and phase 18's main-path launches by form (``forms``)."""
    row = next(r for r in rows if (r["case"], r["dtypes"]) == main)
    entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches,
                 max_abs_err=max(r["max_abs_err"] for r in rows
                                 if r["dtypes"] == main[1]),
                 ms=row["ms"], plain_ms=row["plain_ms"],
                 bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                 library_ms=row["library_ms"], case=case)
    if "body" in row:   # "<body> x<splits>" ragged and paged, "<body>" flash
        entry["bodies"] = {f"{r['case']} {r['dtypes']}": r["body"]
                           for r in rows}
    for key, want in (extra or {}).items():
        r = next(r for r in rows if (r["case"], r["dtypes"]) == want)
        entry[key] = {k: r[k] for k in (
            "case", "dtypes", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "bf16_pool_ms", "bf16_ms", "e4m3_ms")
            if k in r}
    if forms is not None:
        entry["phase18_launches_by_form"] = forms
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace serve run 3 of each plan's bf16 and int8 "
                         "serves and of the speculating batcher with "
                         "torch.profiler and print the device's busy "
                         "share and time by kernel class")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from tpulab_torch.cuda.platform import card_name_and_power_limit

    t_all = time.perf_counter()
    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power_limit(0)
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, capability "
        f"{torch.cuda.get_device_capability(0)}; TF32 off for matmul and "
        "cuDNN")

    phase_build()

    timer = Timer(torch)
    rows = {}
    for name, phase in (("ragged", phase_ragged), ("flash", phase_flash),
                        ("paged", phase_paged)):
        t0 = time.perf_counter()
        rows[name] = phase(torch, timer)
        log(f"kernels: {name} phase {time.perf_counter() - t0:.1f} s; "
            "every case on its stated body, a second launch bit-identical")
    t0 = time.perf_counter()
    e4m3_rows = phase_e4m3_kernels(torch, timer, rows)
    log(f"kernels: e4m3 pools {time.perf_counter() - t0:.1f} s")
    phase_host(torch)

    t0 = time.perf_counter()
    op_launches = phase_invariants(torch)
    phase_cast_and_qmat(torch)
    params32, kw32 = phase_plans_f32(torch)
    op_launches += phase_invariants(torch, params32, torch.float32,
                                    torch.float8_e4m3fn)
    for dt in (torch.bfloat16, torch.float8_e4m3fn):
        phase_kvtier_pool(torch, dt)
    phase_kvtier_serve_f32(torch, params32, kw32)
    phase_kvtier_serve_f32(torch, params32, kw32, torch.float8_e4m3fn)
    del params32
    torch.cuda.empty_cache()
    phase_spec_f32(torch)
    phase_int8_spec_f32(torch)
    log(f"invariants: phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    st = phase_serve(torch, card, args.profile)
    log(f"serve: phase {time.perf_counter() - t0:.1f} s")
    phase_infer(torch, card)
    import_launches = phase_import(torch, card)
    hbm_launches = phase_hbm(torch, card)
    svc_launches = phase_service(torch, card)
    obs_launches = phase_obs(torch, card)
    batch_launches = phase_batch(torch, card)
    fleet_launches = phase_fleet(torch, card)
    fab = phase_fabric(torch, card)
    par_launches = phase_parallel(torch, card)
    shard_launches, shard_flash = phase_sharded(torch, card)
    rows_launches = phase_rows(torch, card)
    mem_launches = phase_memory(torch, card)
    dt_rows, dt_forms = phase_dtypes(
        torch, timer, {k: rows[k] + e4m3_rows.get(k, []) for k in rows},
        card)
    dt_launches = {k: sum(v.values()) for k, v in dt_forms.items()}

    kernels = [
        kernel_entry("ragged_paged_attention",
                     "tpulab_torch/ops/csrc/ragged_attention.cu",
                     "tpulab/ops/ragged_attention.py:190",
                     st["ragged"]["launches"]["ragged"]
                     + st["int8 ragged"]["launches"]["ragged"]
                     + st["int8 split"]["launches"]["ragged"]
                     + st["spec"]["spec"]["launches"]["ragged"]
                     + st["kvtier"]["tier"][1]["launches"]["ragged"]
                     + st["disagg"] + hbm_launches + svc_launches
                     + obs_launches + batch_launches + fleet_launches
                     + fab["ragged"] + shard_launches + rows_launches[0]
                     + import_launches + dt_launches["ragged"],
                     rows["ragged"] + e4m3_rows["ragged"]
                     + dt_rows["ragged"],
                     ("all_decode", "bf16/bf16"),
                     "all_decode bf16/bf16, 8 lanes x 1024 context; "
                     "launches: ragged-plan serve run + int8/e4m3 ragged- "
                     "and split-plan serve runs + speculative serve run + "
                     "preempting serve (host tier side) + disagg serve + "
                     "the hbm phase's burst + the service phase's drive + "
                     "the obs phase + the batch phase + the fleet "
                     "replicas (read from each replica's Debug snapshot "
                     "before it retired; the killed replica's are lost) "
                     "+ the fabric phase + the sharded phase's "
                     "{\"model\": 1} serve and every rank of its "
                     "{\"model\": 2} launch ((c) bf16, (d) int8, (e) "
                     "split plan, (f) weight swap) + the rows phase + the "
                     "import phase's HF Llama serve (4 layers) + the "
                     "dtypes phase's serves (f16 compute, bf16 over e5m2 "
                     "pages; 8 layers, both plans)",
                     {"e4m3": ("all_decode", "bf16/e4m3"),
                      "f16": ("all_decode", "f16/f16"),
                      "e5m2": ("all_decode", "bf16/e5m2")},
                     dt_forms["ragged"]),
        kernel_entry("flash_attention",
                     "tpulab_torch/ops/csrc/flash_attention.cu",
                     "tpulab/ops/flash_attention.py:80",
                     st["split"]["launches"]["flash"]
                     + st["int8 split"]["launches"]["flash"] + fab["flash"]
                     + par_launches + shard_flash + rows_launches[1]
                     + mem_launches + dt_launches["flash"],
                     rows["flash"] + dt_rows["flash"],
                     (f"T={FA_TS[-1]} causal", "bfloat16"),
                     "B 1, T 2048, H 32, D 128, causal, bf16; launches: "
                     "split-plan serve runs, bf16 and int8/e4m3, + the "
                     "fabric phase's owner and fallback prefills + the "
                     "parallel phase's train steps (the full-depth bf16 "
                     "step's forwards, 32 x 3, and the 2-layer f32 and "
                     "checkpoint steps) + the sharded phase's split-plan "
                     "owner, both ranks (H 16 a rank) + the rows phase's "
                     "split-plan prefills + the memory phase's stream "
                     "(32 x its windows) + the dtypes phase's split-plan "
                     "serves (f16 and bf16, 8 layers)",
                     {"f16": (f"T={FA_TS[-1]} causal", "float16")},
                     dt_forms["flash"]),
        kernel_entry("paged_decode_attention",
                     "tpulab_torch/ops/csrc/paged_attention.cu",
                     "tpulab/ops/paged_attention.py:221", op_launches,
                     rows["paged"] + e4m3_rows["paged"] + dt_rows["paged"],
                     ("8 x 1024", "bf16/bf16"),
                     "8 lanes x 1024 positions, bf16/bf16; launches: the "
                     "decode op over every layer of a model-written pool, "
                     "bf16 and e4m3",
                     {"e4m3": ("8 x 1024", "bf16/e4m3"),
                      "f16": ("8 x 1024", "f16/f16"),
                      "e5m2": ("8 x 1024", "bf16/e5m2")}),
    ]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
