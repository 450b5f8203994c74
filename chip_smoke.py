#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (ddlbench_tpu_torch/) on the card, in phases, each printing
one JSON line; any failure raises and exits non-zero:

1. build   — compiles the hand-written CUDA kernels from the sources in the
             checkout (ops/csrc/*.cu: paged_attention, flash_attention and
             fused_xent, one nvcc each, started together, for sm_90a) and
             reports the time; then, for each flash and fused-head kernel
             (each template instance of the bfloat16 fused-head kernels,
             one per D chunk count), its registers and spill bytes (the
             -Xptxas -v log) and its counts of wgmma (HGMMA), TMA load
             (UTMALDG) and mma.sync (HMMA) instructions (cuobjdump -sass).
             Fails if a bfloat16 flash or fused-head kernel (forward, dQ,
             dK/dV; forward, dh, dW) has no HGMMA, no UTMALDG or any HMMA,
             or if ptxas serialised its wgmma products (a C7520 note);
             without cuobjdump the line says so and checks only the
             notes. The same for the paged kernels (each pool type's
             instance), with their counts of cp.async copies (LDGSTS):
             fails if an instance of the chunk kernel (paged_chunk_tiled)
             or of the decode kernel (paged_decode_ring) is missing,
             spills or has no LDGSTS.
2. kernels — holds each paged kernel against its plain PyTorch version at
             the serving slice's shapes (rows 8, H 8, dh 64, page 16, a
             64-page pool, scattered random tables, per-row positions with
             partial pages, npl 1/3/16; the chunk kernel at C 16 and 256;
             float32 queries over float32, bfloat16 and int8 pools, the
             int8 pools written by the port's own quantising chunk write so
             their scales are real; and the verify pass's shape, rows 8,
             C 5, per-row unaligned starts, over float32 and int8 pools)
             within 1e-4 max abs error; and the chunk kernel's edges over
             float32 and int8 pools: C 1, a partial last query tile (C 17,
             33), npl 9 (not a multiple of the 8 warps); the decode
             kernel's edges over float32, bfloat16 and int8 pools: pages
             of 8, 16 and 32, npl 1, 9 and 16, and pages of 64 (the beam
             cache's: four 16-key chunks, the ring refilled inside a page),
             npl 1-8 (transformer_moe_s's beam holds 8), positions on a page's first and last key, a row on
             page 0 (warps 1-7 walk nothing). The
             chunk kernel run again at C 16, C 256 and the verify shape,
             and the decode kernel, over float32 and int8, must give the
             same bits. Planted faults over an int8 pool, built from the
             plain versions, must be rejected: the K scale ignored (scale
             1), and each page's scales read from the next slot; and six
             aimed at the two kernels' design, each held against its
             output: one warp's pages dropped (pages j = 7 mod 8 masked
             out; chunk and decode), the last 16-query tile at C 256
             attending with positions 16 too early, the decode query's
             last visible page skipped, and on an int8 pool each page's
             scales taken from the previous page of its warp's walk (page
             j - 8; chunk and decode); four fault-free controls must
             pass. Then times the kernel, its plain version and one
             PyTorch library call computing the same function
             (scaled_dot_product_attention over the pre-gathered pages,
             dequantised beforehand for an int8 pool — a yardstick, never
             used by the port) with CUDA events, the L2 cache flushed
             before every launch, at the deepest shapes the main path's
             pool can hold (decode: 8 rows over all 63 usable slots, npl
             16; chunk: the C-16 chunk that ends a 16-page stream; float32
             and int8, and besides bfloat16, the 256-query unchunked chunk
             and the verify pass over float32 and int8), beside the least
             time the card could take (bound_ms: the larger of the bytes,
             an int8 pool's scale rows included, over 3.35 TB/s and the
             operations over the peak rate for their type).
3. serve   — zeroes the kernels' launch counters, runs servebench's main
             path (transformer_s on synthtext at full width and depth,
             random weights from seed 0, continuous policy, closed loop, 16
             requests) on the card, and requires every request completed,
             both kernels launched, no call on the plain path, and two
             requests' emitted tokens to be
             the greedy choice of the plain full-forward model (the "xla"
             einsum attention, no kernel) run on prompt + emitted tokens
             (each emitted token's logit within 1e-3 of its position's max
             logit).
3b. serve_levers — servebench with the serving levers on the card: the
             same model and traffic with 4 shared 64-token prefixes
             (--shared-prefix 4:64), the prefix cache and speculative
             verify (ngram:N:4). (b) over an int8 pool, at N = 3, 2, 1 in
             turn until the traffic's drafts are accepted: N is the first
             whose drafts are accepted, else the first that drafts (none
             drafting fails); every request completed, prefix hits, both
             int8 kernels launched (counted apart from float-pool
             launches, which must be 0), no paged call on the plain path
             (the follow-up's included). (a) over a float32 pool at that
             N: pool_bytes exactly four times (b)'s. (c) as (b), with token
             streams bitwise equal to (b)'s. These counters, launches and
             the digits gate read servebench's run alone. Then, through
             each run's server, three requests whose prompt is a cached
             prefix exactly (full hits: binds and copy-on-write), counted
             apart. Every request
             of (a), the follow-up's included, is held by the
             teacher-forced check above. The digits gate: servebench's
             int8 streams must agree with (a)'s at >= 0.75 of positions
             (the reference's int8 gate); a miss is reported, and passes
             only if each stream's first flip lies within the int8 pool's
             logit noise there (the two tokens' float32 logit gap at most
             twice the largest |int8 - float32| logit difference, both
             through the serving path on the shared prefix). Prints the
             three rows' counters and wall-clock step times.
3c. serve_slo — servebench's SLO surface on the card: transformer_s at
             full width, open-loop poisson arrivals under the diurnal
             shape at rate 0.5, 32 requests (cut from 64), deadlines
             (slack 64) with the driver's retry (2:8), a 0.3 batch-tier
             mix, top-k 40 sampling at temperature 0.8, traced with the
             timeline. Over a float32 and an int8 pool, with the launch
             counters zeroed before the first run: (a) the card's row
             equals the port's row of the same command on the CPU on
             every virtual-time field (all but the wall-clock fields,
             provenance and plain_launches), and so do the timeout and
             shed records; (b) a second card run gives bitwise-equal
             sampled streams, and a run of the same traffic without
             deadlines on a 20-page pool, which evicts, gives the
             requests it completed the streams they have in the first
             run, evicted ones among them; (c) completed + timeouts +
             rejected = requests, each shed submission was retried or
             rejected, and every page is back on the free list; (d)
             serveview's TTFT components on the card's trace file sum
             exactly (in the trace's integer units) to each request's
             TTFT; (e) both paged kernels of the pool's type launched,
             neither of the other type's, and no call on the plain path.
             (f) planted faults, each run on the card and each required
             to fail its check: the sampler keyed by engine step in place
             of token index (b), batch admitted ahead of interactive (a),
             and a timeout that keeps its pages (c). Reports the first
             token index at which each pool's card streams leave the
             CPU's (not required: the kernels' summation order moves the
             logits); then wall_tokens_per_s and decode_step_ms of the
             command sampled against the same command greedy, in turns
             (greedy, sampled, sampled, greedy) over a float32 pool,
             beside the card's nvidia-smi line, with sample_ms (the
             host's time for one draw).
3d. serve_fleet — the replicated fleet on the card: transformer_s at full
             width (random weights, seed 0) over a float32 and an int8
             pool, five commands with the traffic of the reference's
             own end-to-end fleet tests (the seed-5 tiny traffic of
             tests/test_serve_chaos.py, test_elastic.py and
             test_autoscale.py): (i) servechaos --replicas 3 --kill 6:2
             --stall 10:0:40 --heartbeat 4, 10 requests; (ii) the same
             under --deadline-slack 64 --retry 2:8 --tier-mix 0.3 with
             poisson arrivals at rate 0.5; (iii) servechaos --replicas 2
             --kill 8:1 --autoscale 2:2 (with its scripted-recovery
             baseline); (iv) servebench --replicas 2 --resize 8:1
             --resize 24:3, 16 requests; (v) servebench --shape diurnal
             --autoscale 1:2, 8 requests. With the launch counters zeroed
             before a pool type's card runs: (a) each card row equals the
             port's row of the same command on the CPU on every
             virtual-time field (the fail, heartbeat, resize and
             autoscale events among them), and so do the fleet's stall
             events, timeouts and sheds; (b) no request lost, and the
             streams equal the card's own control (servechaos's
             unfaulted run; for (iv) and (v) the same command without
             --resize or --autoscale); under (iii) the auto-repair MTTR at
             most the scripted one; (c) every live and retired engine
             holds no work, the live and drained ones have every page
             back, and every retired one has released its pool; (d) both
             paged kernels of the pool's type launched, neither of the
             other type's, no call on the plain path; (e) every engine of
             (i)'s 3-replica fleet holds the one model (the same
             parameter storage), and building that fleet grows
             torch.cuda.memory_allocated by its pools' bytes within 10 %.
             A stream that leaves its control is reported with its first
             fork and the top-2 logit margin there. Planted faults, each
             run on the card and each required to fail its check: a kill
             that drops the killed replica's queue (b), a step that kicks
             a stalled replica's monitor (a) and dispatch to the
             most-loaded replica (a). Then the serve_slo command greedy
             over a float32 pool at 1 and 2 replicas, warm, in turns
             (1, 2, 2, 1), with wall_tokens_per_s and decode_step_ms
             beside the card's nvidia-smi line: the replicas share one
             card and take turns on its stream.
3e. serve_disagg — disaggregated serving and the SDC ledger on the card:
             transformer_s at full width (random weights, seed 0) over a
             float32 and an int8 pool, with the traffic of the
             reference's own disaggregation and SDC end-to-end tests (the
             seed-5 tiny traffic of tests/test_serve_disagg.py and
             test_serve_sdc.py, 10 requests, 12-page pools of page 4):
             servebench --disaggregate 1:1, --disaggregate 2:1
             --autoscale 1:2, servechaos --disaggregate 2:2 --kill 2:p0
             --kill 8:d0. With the launch counters zeroed before a pool
             type's card runs: (a) each row equals the port's row of the
             same command on the CPU on every virtual-time field and on
             the shipped_* counts, and the int8 payload shipped is a
             quarter of the float32 one for the same pages; (b) no
             request lost, and the streams equal the same traffic's on
             the aggregated fleet of P + D replicas; (c) servechaos
             --corrupt at payload, sidecar (int8), prefix, ship, the
             decode fleet's pool, and a prefill-side page with boundary
             checks only (caught at its export, never on the wire): each
             flip detected, nothing escaped or lost, the streams equal
             the unfaulted control's, every quarantined slot out of use
             for good; the payload flip's time is the first of 3, 2, 4-8
             whose flip escapes under --no-detect, which float32 must
             find (int8 tries float32's time and reports); (d) servebench --scrub 4 on
             clean traffic (also on a 6-page pool that evicts, so
             re-prefills meet the recompute check, and on 1:1) detects
             nothing and keeps the streams of the run without the ledger;
             (e) both paged kernels of the pool's type launched, neither
             of the other type's, no call on the plain path;
             flip_pool_bit changes exactly one bit of the card's bytes;
             a 2:2 server holds the one model and grows
             torch.cuda.memory_allocated by its pools' bytes within 10 %.
             Planted faults, each run on the card and each required to
             fail its check: an export that skips its verify (c), a
             write_pages that drops the scale sidecars (b) and a
             page_checksum that leaves out the sidecar keys (c). Then
             the serve_slo command greedy over a float32 pool, warm, in
             turns: 1 and 2 replicas against --disaggregate 1:1 (1, 2,
             1:1, 1:1, 2, 1), and the ledger off against --scrub 0 and
             --scrub 4 (off, 0, 4, 4, 0, off), with wall_tokens_per_s
             and decode_step_ms beside the card's nvidia-smi line.
3f. decode — KV-cached greedy and beam decoding (models/decode.py) on
             seq2seq_s / synthmt at full width (d 512, 8 layers, 8 heads,
             dh 64, vocab 32 768, T 256, source 128; random weights, seed
             0), B 8, beam 4: decodebench's defaults. (a) On the card, the
             full-forward greedy and beam loops are the oracle of the dense
             cached and the paged greedy and beam over float32 caches; the
             dense cached greedy and beam over a bfloat16 cache (the same
             rounding of every cached K/V, plain attention) are the oracle
             of the paged ones over a bfloat16 cache (their distance from
             the float32 loops is reported). Tokens must be equal, and beam
             scores within rtol 1e-4, but for a fork whose evidence, printed,
             shows a near tie: teacher-forced on the shared prefix, the
             oracle's top-2 logit margin below the two paths' logit
             distance on the gap between the two chosen tokens, and the
             path within 1e-3 of the oracle on every logit. (b) Launches,
             the counters zeroed before each run: every paged run launches
             the decode kernel 127 x 8 = 1 016 times (positions 128-254,
             8 layers) and the flash forward 8 times (the prompt's
             prefill), a dense cached run the flash forward 8 times and
             the decode kernel none, and no run takes a plain path. (c)
             The decode kernel at the beam cache's last step (32 rows, 4
             pages of 64, position 254) over float32 and bfloat16, timed
             with its plain version and SDPA over the pre-gathered pages,
             beside its bound (phase 2's edges include pages of 64). (d)
             decodebench at its defaults plus --chunk-prefill --kv-dtype
             float32,bfloat16,int8 --repeats 1: exit 0, the six decode
             rows, 8 chunk
             and 12 kv-dtype rows, none erred or skipped, no plain call,
             each paged kernel launched over float and int8 pools
             (counted apart from (a)). Reported: one warm paged beam
             run (float32) under torch.profiler: the device's busy share,
             launches and top kernels.
             (e) mtacc at its defaults (seq2seq_t trained 400 steps on
             the card): the gate passes. (f) The engine's greedy streams
             on transformer_s (4 requests, 32 new tokens each, a float32
             pool of 16-position pages) equal models/decode.py's paged
             greedy_decode (pages of 64) on the same prompts, with the
             near-tie rule of (a).
4. profile — the same path (8 requests, warm) under torch.profiler: the
             device's busy share, the device time by kernel, and each
             paged kernel instance's calls and device time.
5. flash_kernels — holds each flash kernel (forward, dQ, dK/dV) against
             its plain version: H 8, dh 64, float32 and bfloat16; causal at
             lmbench's own shape (B 16, T 1024), at B 2, T 1024, T 1000
             (tail tiles) and T 960 (a multiple of 64, not of 128), a query
             block at an offset, a key offset that leaves rows fully masked,
             prefix_len 100, seq2seq_s's own shape (B 64, T 256, prefix
             128: the prefix ends on a 128-key tile) and a 48-row query
             block at offset 952 over 1000 keys (fewer rows than one
             warpgroup). Tolerance:
             float32 1e-4 max abs error; bfloat16 1e-4 max abs on the lse
             and, on every output, each row's (one query's or key's dh
             values) L2 error within 2^-6 of that row's L2 norm: four
             bfloat16 unit roundoffs (the output's rounding, and the
             kernels' rounding of P and dS before the products they feed,
             which the plain versions keep in float32). A row far smaller
             than the others is measured against 1e-3 of the mean row
             norm. The check must reject the plain versions with a planted
             tail fault at T 1000: the last 8 keys dropped (forward, dQ)
             or the last 8 queries (dK/dV); and dQ with the second
             warpgroup's 64 rows of a 128-query item (queries 64-127)
             zeroed. In bfloat16, dQ run again at lmbench's shape must
             give the same bits (no atomics). Then longctx32k: the forward
             at T 32768, B 1, its last 256 rows against the plain version
             of those queries (q_offset T - 256 over the full K/V), and
             the backward kernels on that query block against theirs. The
             kernels table carries each kernel's worst bfloat16 max abs
             error (the training path's type).
6. flash_times — each flash kernel, its plain version and a PyTorch
             library call (scaled_dot_product_attention, is_causal; for
             dQ and dK/dV the backward of that call through
             torch.autograd.grad, which computes the pair, so both rows
             carry the pair's time) with CUDA events, the L2 flushed, at
             lmbench's main-path shape (B 16, H 8, T 1024, dh 64, bf16,
             causal) and, for the record, at B 2, T 8192, beside bound_ms:
             the larger of the bytes over 3.35 TB/s and the flops over
             989 TFLOP/s (4, 6 and 8 x dh flops per visible (query, key)
             pair for the forward, dQ and dK/dV).
7. fxent_kernels — holds each fused LM-head kernel (forward, dh, dW)
             against its plain version, float32 and bfloat16, both
             cotangents non-zero (0.7 on the objective, 0.3 on the CE): at
             lmbench's head (N 16 384 = B 16 x T 1024, D 512, V 32 768,
             smoothing 0), the same shape with synthmt's masking (label -1
             at positions < 127 of each 256-row segment, smoothing 0.1), a
             ragged case (N 1 000, D 64, V 1 000: tail rows and a tail vocab
             tile; every 5th row masked; smoothing 0 and 0.1), all rows
             masked (sums 0, dh and dW exactly 0), W = 0 (every logit
             ties: correct = the valid rows labelled 0), and transformer_m's
             and transformer_t's heads (N 4 096, V 32 768, D 768 with
             synthmt's masking, D 32). Tolerance: float32
             the objective and CE sums within rtol 1e-5, correct exact, lse
             within 1e-4, dh and dW within 1e-4 max abs; bfloat16 the lse
             within 1e-4, each dh row and each dW column within 2^-6
             relative L2, an argmax mismatch only at a near-tie (the two
             logits within 1e-3; the count is reported). The check must
             reject the plain versions with planted faults on synthmt's
             case: the last vocab tile skipped (forward, dh), the
             forward's odd vocab tiles dropped (one warpgroup's share),
             gold read from the next column, the label mask dropped (dh,
             dW), the last D half of dh dropped and the last row tile of
             dW skipped. In bfloat16, the forward (all four outputs), dh
             and dW run again on synthmt's and the D-768 case must give
             the same bits (no atomics).
8. fxent_times — each fused kernel, its plain version and a PyTorch
             library yardstick (torch.matmul then F.cross_entropy on the
             float32 logits; for dh and dW the backward of that pair
             through torch.autograd.grad, which computes both, so both
             rows carry the pair's time), CUDA events, L2 flushed, at
             lmbench's head in bf16, beside bound_ms (2 N D V flops for the
             forward, 4 N D V for dh and dW, at 989 TFLOP/s; the bytes of
             each input and output once at 3.35 TB/s).
9. train   — zeroes the flash and fused-head counters and trains
             lmbench's main path on the card: transformer_s on synthtext
             (B 16, T 1024, full width and depth), bf16, flash+fused (the
             default), random weights from seed 0, 2 warm-up and 10 timed
             steps through make_strategy / train_step / timed_steps.
             Requires every step's loss finite, each flash kernel launched
             8 times a step (once per layer) and each fused-head kernel
             once a step, and no call on the plain path. Then one step's
             loss and gradients from the same weights and batch must agree
             between the fused head and the logits (flash both) and
             between flash and xla attention (fused both): the loss
             within 1e-2 absolute, each gradient leaf within 5e-2
             relative L2 (bf16 activations on every path). Reports the
             peak device memory of one step's forward and backward each
             way, then prints the port's lmbench rows for the four forced
             cells.
10. seq2seq — the same on seq2seq_s / synthmt (B 64, T 256, 128-token
             source: the prefix path of the flash kernels), flash+fused,
             Adam, label smoothing 0.1, 2 warm-up and 5 timed steps:
             finite losses, the same launch counts, 64 x 129 = 8 256 valid
             labels a batch, the fused-vs-logits agreement; then lmbench
             rows for flash+fused and flash+logits on synthmt.
10b. moe_train — the same on transformer_moe_s / synthtext (d 512, 8
             layers, 8 heads, 4 Switch MoE blocks of 8 experts, capacity
             factor 1.25, aux weight 0.01; B 16, T 1024, bf16), 2 warm-up
             and 10 timed steps: finite losses, each flash kernel 8
             launches a step and each fused-head kernel 1, no plain-path
             call; each MoE block's aux loss (reported apart from the CE)
             and drop share (tokens past capacity) in the last step; the
             one-step agreements at the dense cells' bars, the compared
             run's MoE blocks pinned to the fused flash run's experts;
             beside each, the tokens whose expert differs in a run left
             to its own router (a flip in a token whose expert and drop
             agreed in every earlier block passes only where its top-2
             router probabilities lie within 2^-5) and that run's loss
             gap (within 1e-2); peak memory;
             one profiled step (moe_train_profile); lmbench's four rows
             (no remat retry for an MoE arch).
10c. lstm_train — seq2seq_lstm_s / synthmt (d 512, 4 LSTM layers on
             torch.lstm, one cross-attention; B 64, T 256, Adam,
             smoothing 0.1), 2 + 5 steps: no flash launch, each
             fused-head kernel once a step, 64 x 129 valid labels a
             batch, the agreements; each LSTM layer on the card (bf16,
             cuDNN) against the same layer in float32 on the CPU, on one
             batch's embedding (lstm_vs_cpu: max abs error within 2^-5 of
             the largest output, relative L2 within 1e-2); one profiled
             step (lstm_train_profile); lmbench rows for flash+fused and
             flash+logits.
10d. moe_decode — transformer_moe_s built at capacity factor 8 (so its
             full forward drops nothing), B 8, greedy and beam 4 from 256
             prompt tokens to 512: the paged and the dense cache's tokens
             against the full-forward loop (over the unpadded prefix), a
             fork only at an accepted near tie and beam scores within
             1e-4; each paged run B7 (512 - 1 - 256) x 8 times and B1 8
             (the prompt's prefill), each dense run B1 8, no plain-path
             call; B7 at the beam cache's last step (32 rows, 8 pages of
             64) in f32 and bf16, held against its plain version within
             1e-4, beside its bound, the plain version's time and SDPA's; decodebench's rows (four timed, the full-forward rows
             skipped for a causal LM).
10e. text_data — writes a made-up corpus from a seed (a train.txt and a
             train.src/train.tgt pair, 4 000 lines) and runs the CLI's
             -s --data-dir on it: transformer_moe_s on the text corpus,
             seq2seq_lstm_s on the parallel corpus and transformer_moe_s
             on a generated token store, 3 steps of B 8 each, finite
             losses and the source's line; each source's first batch on
             the card must equal the CPU's bitwise.
10f. tiny_dispatch — transformer_t (head dim 8, which the flash and
             paged kernels do not take) on the card: lmbench's auto cell
             (B 4, T 1024, 1 + 3 steps) through the plain attention and the
             fused-head kernels at D 32, servebench (8 requests) through
             the plain paged attention, both rows' plain_launches > 0, and
             a forced flash backend raising on head dim 8.
11. train_profile — 3 warm flash+fused steps under torch.profiler: the
             device's busy share, the top device kernels, and each port
             kernel's device time and launches per step.
12. image  — image training, which runs no port kernel (convolutions and
             BatchNorm are cuDNN's). (a) image_check: resnet50/imagenet
             from seed 0, one training step (forward, backward, running
             statistics) at B 4 on the card (channels_last) and on the
             CPU from the same weights and batch, in float32 and in
             float64. float64: the card's loss, every gradient leaf and
             every running statistic within 1e-9 relative L2 of the
             CPU's. float32: the loss within 1e-4 relative and each
             running statistic within 1e-4 relative L2 of the CPU's
             float32 step; the card's worst gradient leaf within 1e-3
             relative L2 of the CPU's float64 step, or within twice the
             CPU float32 step's own worst leaf where that is larger
             (resnet50's float32 gradients at init lie a few per cent
             from float64 on any device: BatchNorm's backward cancels at
             every layer). A leaf under 1e-3 of the largest leaf of its
             kind is measured against that floor. Three planted faults
             must be rejected: the stride-2 convolutions padded
             symmetrically (torch's padding=k//2 in place of XLA's SAME),
             the running variance updated with the biased batch variance,
             and BatchNorm's backward without its mean term (only the
             gradients show it). (b) image:
             the main path at full width, resnet50/imagenet, B 128,
             bfloat16 on float32 masters, channels_last, cudnn.benchmark
             on, through make_strategy / train_step /
             timed_steps_prefetched at depth 0, 2 warm-up and 10 timed
             steps: every loss finite; images/sec,
             step p50/p95 (CUDA events) and one step's peak memory. (c)
             image_profile: 3 warm steps under torch.profiler: the
             device's busy share and its time by kernel group
             (convolutions and GEMMs, BatchNorm, pooling and reductions,
             elementwise and casts, optimizer, other) and by kernel. (d) image_cli:
             ``python -m ddlbench_tpu_torch.cli -b imagenet -f single -m
             resnet50 -e 1 --steps-per-epoch 20`` in-process: its train,
             epoch, valid and summary lines and the result line, every
             logged loss finite. (e) image_bench: tools/bench's headline
             record (resnet50/imagenet, B 128, 30 steps, 5 warm-up, median
             of 3), then image_models: one short bench row (B 32, 3 warm-up
             and 5 steps) for each of resnet18, resnet152, vgg11, vgg16
             and mobilenetv2 on imagenet.
13. real_data — on-disk images, which run no port kernel either (the
             native loader is host C++ built by g++ from
             native/dataloader.cpp; augmentation and normalisation are
             torch ops on the card). (a) real_ingest: an MNIST IDX pair
             and CIFAR-10 data_batch_*/test_batch pickles of seeded uint8
             images, written with struct and pickle to a temporary
             directory, imported through the port: each store's bytes,
             labels, shape and count as written. (b) real_augment:
             cifar10's pad-4 crop + flip and imagenet's flip of a seeded
             B 128 uint8 batch on the card against the same function on
             the CPU at three (epoch, step) keys: the uint8 batch bitwise,
             the normalised bfloat16 batch exactly; planted faults, each
             rejected: the flip over H, an exclusive randint upper bound,
             and the loader's ring handed over without a copy (batch 0's
             bytes change after depth + 2 further batches; at depths 1
             and 2). (c) real_data_cli, the main path at full width:
             ``python -m ddlbench_tpu_torch.cli -b imagenet -f single -m
             resnet50 -s --data-dir D -e 1 --steps-per-epoch 20
             --batch-size 128 --dtype bfloat16`` in-process on a store of
             20 x 128 train and 2 x 128 test images written by the port's
             generate_dataset (about 390 MB, removed after), at prefetch
             depth 2 and with --no-prefetch: images/s, step p50/p95, the
             input stall and its share of the epoch, peak memory, the
             reference's lines, every logged loss finite; before them,
             what a batch costs the producer alone (the host ms of the
             copy out of the ring and of queueing the upload, augmentation
             and normalisation, and the device ms of that work). (d) real_accum:
             resnet50/imagenet, one step of 2 micro-steps of 2 rows
             (--grad-accum-steps 2) in float64 on the card against the
             CPU: loss, every gradient leaf and every running statistic
             within 1e-9 (floored as in 12). (e) image_bench_prefetch:
             tools/bench's headline record at --prefetch-depth 2 (12's)
             and at 0.
14. image_zoo — lenet, alexnet, squeezenet, resnext50, densenet121,
             inception and nasnet at imagenet width (the CPU's float64
             step takes a few seconds for each): one training step at B 2
             in float64 on the card against the CPU's from the same
             weights, within 1e-9 as in 12; three planted faults, each
             rejected: AvgPool excluding the padding (nasnet), densenet's
             concat in the wrong order, resnext's grouped kernel with its
             group axes swapped; then a short bench row for each (B 32,
             bf16, channels_last, 3 warm-up and 5 steps): images/s, step
             p50/p95, peak memory.

Then it prints the script's wall time from the build on, the kernels table
(one JSON object: the paged kernels over
float pools and over int8 pools, the flash and the fused-head kernels; the
int8 rows' launches are serve_levers (b)'s, the float decode row's serve's
plus decode (a)'s and moe_decode's; the flash and fused-head rows' are
train's, moe_train's and lstm_train's, the flash forward's moe_decode's
too), the card's name and power
limit as nvidia-smi reports them, and, last, the device record.
Without a CUDA device, or away from the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, per type
ROWS, H, DH, PAGE, POOL_PAGES, NPG = 8, 8, 64, 16, 64, 16
TOL = 1e-4  # max abs error, float32 queries over either pool dtype
# live pages of the 8 decode rows in the timed case: the 63 usable slots of
# the 64-page pool (slot 0 is scratch), one row at the 16-page max_len
DECODE_LIVE = (16, 9, 8, 8, 8, 6, 4, 4)
SOURCE = "ddlbench_tpu_torch/ops/csrc/paged_attention.cu"
# each paged row of the kernels table -> the TPU kernel it replaces (the
# int8 rows: the same two kernels over int8 pools)
KERNELS = {
    "paged_attention": "ddlbench_tpu/ops/paged_decode.py:318",
    "paged_chunk_attention": "ddlbench_tpu/ops/paged_decode.py:703",
    "paged_attention_int8":
        "ddlbench_tpu/ops/paged_decode.py:318 (int8 branch, :323-340)",
    "paged_chunk_attention_int8":
        "ddlbench_tpu/ops/paged_decode.py:703 (int8 branch, :714-731)",
}
# (page, npl, the key of its page a row's position is on) of the decode
# kernel's edge checks
DECODE_EDGES = ((16, 16, "last"), (16, 16, "first"), (16, 9, "last"),
                (16, 1, "first"), (8, 9, "first"), (8, 16, "last"),
                (32, 9, "last"), (32, 16, "first"), (32, 1, "last")) + tuple(
    # the beam cache's page of 64: four 16-key chunks, the two-stage ring
    # refilled inside a page (models/decode.py, phase decode), up to the 8
    # live pages of transformer_moe_s's beam (phase moe_decode), where each
    # of the kernel's 8 warps holds a page
    (64, npl, key) for npl in range(1, 9) for key in ("first", "last"))
SPEC_K = 4  # drafted tokens a verify pass checks
VERIFY_C = SPEC_K + 1  # the verify pass: the pending token + SPEC_K drafts
# the n-gram lengths serve_levers tries, in order: the reference's 3 first
SPEC_NGRAMS = (3, 2, 1)
# servebench with the serving levers (the reference's raw-speed levers and
# prefix-cache A/B), run at float32, int8, and int8 again
LEVER_ARGS = ["-m", "transformer_s", "-b", "synthtext", "--policies",
              "continuous", "--arrival", "closed", "--requests", "16",
              "--seed", "0", "--shared-prefix", "4:64", "--prefix-cache",
              "--wall-clock"]
DIGITS_GATE_INT8 = 0.75  # the reference's tests/test_serve_quant.py gate
# phase 3c, serve_slo: the SLO surface's command at 32 requests (cut from
# 64 to keep the script inside its time limit); --kv-dtype and --trace are
# added per run
SLO_TRAFFIC = [
    "-m", "transformer_s", "-b", "synthtext", "--policies", "continuous",
    "--arrival", "poisson", "--shape", "diurnal", "--rate", "0.5",
    "--requests", "32", "--tier-mix", "0.3", "--timeline", "--wall-clock",
    "--seed", "0"]
SLO_DEADLINES = ["--deadline-slack", "64", "--retry", "2:8"]
SLO_SAMPLE = ["--sample", "temperature:0.8,top-k:40"]
SLO_ARGS = SLO_TRAFFIC + SLO_DEADLINES + SLO_SAMPLE
SLO_GREEDY_ARGS = SLO_TRAFFIC + SLO_DEADLINES
# (b)'s eviction run: a pool of 20 pages evicts on this traffic; without
# deadlines every evicted request completes on the recompute path (with
# them, the evicted ones time out)
SLO_EVICT_ARGS = SLO_TRAFFIC + SLO_SAMPLE + ["--pool-pages", "20"]
# row fields that are not virtual time: wall clock, provenance, and the
# plain-path count (0 on the CPU by definition)
SLO_NOT_VIRTUAL = frozenset((
    "wall_s", "wall_tokens_per_s", "decode_step_ms", "prefill_chunk_ms",
    "sample_ms", "schema_version", "platform", "device_kind",
    "device_count", "torch_version", "cuda_version", "plain_launches"))
FLASH_SOURCE = "ddlbench_tpu_torch/ops/csrc/flash_attention.cu"
# each flash kernel -> the pallas_call it replaces
FLASH_KERNELS = {
    "flash_fwd": "ddlbench_tpu/ops/flash_attention.py:465",
    "flash_dq": "ddlbench_tpu/ops/flash_attention.py:549",
    "flash_dkv": "ddlbench_tpu/ops/flash_attention.py:597",
}
FLASH_FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}
FLASH_TOL = 1e-4  # max abs error in float32, and of the lse in bfloat16
BF16_ROW_RTOL = 2.0 ** -6  # bfloat16: each row's L2 error over its L2 norm
# (B, H, Tq, Tk, q_offset, k_offset, prefix_len) of the flash checks
FLASH_CASES = (
    (16, 8, 1024, 1024, 0, 0, 0),  # lmbench's main-path shape
    (2, 8, 1024, 1024, 0, 0, 0),
    (2, 8, 1000, 1000, 0, 0, 0),
    (2, 8, 512, 1000, 488, 0, 0),
    (2, 8, 1000, 1000, 0, 100, 0),
    (2, 8, 1000, 1000, 0, 0, 100),
    (64, 8, 256, 256, 0, 0, 128),  # seq2seq_s: the prefix ends on a tile
    (2, 8, 960, 960, 0, 0, 0),  # a multiple of 64, not of 128
    (2, 8, 48, 1000, 952, 0, 0),  # under one warpgroup of rows, at an offset
)
# the flash library's kernels by name (the build phase's report), and the
# bfloat16 ones that must be compiled to wgmma (HGMMA) and TMA (UTMALDG)
FLASH_BUILT = ("flash_fwd_wgmma", "flash_dkv_wgmma", "flash_dq_wgmma",
               "flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32",
               "wgmma_tile_test")
FLASH_HOPPER = ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma")
# the fused-head library's kernels (the bfloat16 ones built for each D
# chunk count: fx_dh_wgmma<8> is D 449-512), and the bfloat16 ones that
# must be wgmma and TMA, with no mma.sync
FX_BUILT = ("fx_fwd_wgmma", "fx_dh_wgmma", "fx_dw_wgmma", "fx_fwd_f32",
            "fx_dh_f32", "fx_dw_f32", "fx_wgmma_tile_test")
FX_HOPPER = ("fx_fwd_wgmma", "fx_dh_wgmma", "fx_dw_wgmma")
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")
# the paged library's kernels (an instance per pool type), each of which
# must copy its pages by cp.async (LDGSTS) with no spill
PAGED_BUILT = ("paged_chunk_tiled", "paged_decode_ring")
PAGED_TYPES = {"IfE": "float", "I13__nv_bfloat16E": "bf16", "IaE": "int8"}
# the port's kernels of a training step, as the profiler names them
TRAIN_KERNELS = ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma",
                 "fx_fwd_wgmma", "fx_dh_wgmma", "fx_dw_wgmma")
LONG_T, LONG_Q = 32_768, 256
TRAIN_ARGS = ["-m", "transformer_s", "-b", "synthtext", "--steps", "10",
              "--warmup", "2"]
S2S_ARGS = ["-m", "seq2seq_s", "-b", "synthmt", "--steps", "5", "--warmup",
            "2"]
LAYERS = 8  # transformer_s, seq2seq_s: one launch of each flash kernel per
# layer, and one of each fused-head kernel a step
# the rest of token training: transformer_moe_s (8 attention layers, 4 of
# them Switch MoE blocks of 8 experts, capacity factor 1.25) and
# seq2seq_lstm_s (4 LSTM layers and one cross-attention: no flash call)
MOE_ARGS = ["-m", "transformer_moe_s", "-b", "synthtext", "--steps", "10",
            "--warmup", "2"]
LSTM_ARGS = ["-m", "seq2seq_lstm_s", "-b", "synthmt", "--steps", "5",
             "--warmup", "2"]
# a token whose expert differs between two one-step runs (fused vs
# logits, flash vs xla), and whose expert and drop agreed in every
# earlier MoE block, is accepted only where its top-2 router
# probabilities lie this close in the first run: bfloat16 activations
# move a router probability by far less
MOE_FLIP_MARGIN = 2.0 ** -5
# lstm_vs_cpu: an LSTM layer in bfloat16 on the card (cuDNN) against the
# same layer in float32 on the CPU over 256 recurrent steps: max abs error
# within 2^-5 of the largest output (4 bfloat16 ulps there), relative L2
# within 1e-2
LSTM_TOL_ABS, LSTM_TOL_REL = 2.0 ** -5, 1e-2
# moe_decode: the model at capacity factor E, so that its full forward
# (the oracle) drops nothing; decodebench's rows at B 8, beam 4, from 256
# prompt tokens to 512 (the beam cache's last step: 32 rows, 8 pages of 64)
MOE_DECODE_CF = 8.0
MOE_DECODE_ARGS = ["-m", "transformer_moe_s", "-b", "synthtext", "--batch",
                   "8", "--beam", "4", "--total-len", "512", "--repeats",
                   "1"]
# text_data: the CLI on on-disk text (-s --data-dir), a few steps each
TEXT_LINES = 4000
TEXT_CLI = {
    "text_corpus": ["-b", "synthtext", "-m", "transformer_moe_s"],
    "translation_corpus": ["-b", "synthmt", "-m", "seq2seq_lstm_s"],
    "token_store": ["-b", "synthtext", "-m", "transformer_moe_s"],
}
TEXT_CLI_COMMON = ["-s", "-e", "1", "--steps-per-epoch", "3", "-p", "1",
                   "--batch-size", "8"]
FX_SOURCE = "ddlbench_tpu_torch/ops/csrc/fused_xent.cu"
# each fused-head kernel -> the pallas_call it replaces
FX_KERNELS = {
    "fxent_fwd": "ddlbench_tpu/ops/fused_xent.py:443",
    "fxent_dh": "ddlbench_tpu/ops/fused_xent.py:565",
    "fxent_dw": "ddlbench_tpu/ops/fused_xent.py:581",
}
FX_FLOPS_PER_NDV = {"fxent_fwd": 2, "fxent_dh": 4, "fxent_dw": 4}
FX_HEAD = (16_384, 512, 32_768)  # lmbench's head: N = B 16 x T 1024, D, V
FX_SUM_RTOL = 1e-5  # float32 objective and CE sums
FX_TOL = 1e-4  # float32 dh/dW max abs; each row's lse and gold in both types
FX_ZSUM_RTOL = 1e-5  # each row's zsum within this of the row's sum of |z|
# (and as much absolute), in both types
FX_TIE = 1e-3  # bfloat16: an argmax may differ where two logits are this close
FX_COT = (0.7, 0.3)  # the cotangents of the objective and the CE sums
# image training (phase 12): the card-vs-CPU float32 check's batch and
# tolerances, the main path's batch and steps, the CLI's arguments, and
# the short bench rows of the other five reference models
IMAGE_CHECK_B = 4
IMAGE_LOSS_RTOL, IMAGE_GRAD_RTOL, IMAGE_STAT_RTOL = 1e-4, 1e-3, 1e-4
# the float64 card step against the float64 CPU step: loss, every gradient
# leaf and every running statistic
IMAGE_F64_RTOL = 1e-9
# a leaf under this share of the largest leaf of its kind is measured
# against that floor (zero up to rounding: the bias of a BatchNorm that
# feeds another one), as tests/test_torch_image_train.py does
IMAGE_FLOOR = 1e-3
IMAGE_B, IMAGE_STEPS, IMAGE_WARMUP = 128, 10, 2
IMAGE_CLI_ARGS = ["-b", "imagenet", "-f", "single", "-m", "resnet50", "-e",
                  "1", "--steps-per-epoch", "20"]
IMAGE_SHORT_ARCHS = ("resnet18", "resnet152", "vgg11", "vgg16",
                     "mobilenetv2")
IMAGE_SHORT_ARGS = ["--benchmark", "imagenet", "--batch-size", "32",
                    "--warmup", "3", "--steps", "5", "--repeats", "1"]
# real data (phase 13): the main path's batch and store (steps of train,
# of test), the CLI's arguments (the store's directory added), the
# augmentation check's batch and (epoch, step) keys, the accumulation
# check's micro-batch and K, and the ring fault's prefetch depths
REAL_B, REAL_STEPS, REAL_TEST_STEPS = 128, 20, 2
REAL_CLI_ARGS = ["-b", "imagenet", "-f", "single", "-m", "resnet50", "-s",
                 "-e", "1", "--steps-per-epoch", str(REAL_STEPS),
                 "--batch-size", str(REAL_B), "--dtype", "bfloat16", "-p",
                 "5"]
AUG_B, AUG_KEYS = 128, ((0, 0), (1, 7), (3, 19))
ACCUM_MICRO_B, ACCUM_K = 2, 2
RING_DEPTHS = (1, 2)
# the rest of the image zoo (phase 14), each checked at imagenet width
ZOO_ARCHS = ("lenet", "alexnet", "squeezenet", "resnext50", "densenet121",
             "inception", "nasnet")
ZOO_CHECK_B = 2
# (name, N, D, V, smoothing, masking) of the fused-head checks
FX_CASES = (
    ("lmbench", *FX_HEAD, 0.0, "none"),
    ("synthmt", *FX_HEAD, 0.1, "synthmt"),
    ("ragged", 1000, 64, 1000, 0.1, "every5"),
    ("ragged_s0", 1000, 64, 1000, 0.0, "every5"),
    ("all_masked", 1000, 64, 1000, 0.1, "all"),
    ("zero_head", 1000, 64, 1000, 0.0, "every5"),
    ("wide", 4096, 768, 32_768, 0.1, "synthmt"),  # transformer_m's head
    ("narrow", 4096, 32, 32_768, 0.0, "every5"),  # transformer_t's head
)


def ptxas_report(log: str) -> dict:
    """{mangled kernel: {registers, spill_bytes}} from nvcc's -Xptxas -v
    log, and ``wgmma_serialized`` for a kernel that ptxas names in a C7520
    note (its wgmma products serialised: a wait after each). A C7520 note
    that names no kernel is filed under the key ``""``."""
    out, cur = {}, None
    for line in log.splitlines():
        if "C7520" in line:
            m = re.search(r"'(\w+)'", line)
            out.setdefault(m.group(1) if m else "", {})[
                "wgmma_serialized"] = True
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                "cuobjdump")
    return str(path) if path.exists() else None


def sass_counts(tool: str, lib: Path, ops=SASS_OPS) -> dict:
    """{mangled kernel: {opcode: count}} of ``ops`` in a built library's
    machine code (cuobjdump -sass)."""
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), dict.fromkeys(ops, 0))
        elif cur is not None:
            for op in re.findall(r"\b(" + "|".join(ops) + r")\b", line):
                cur[op] += 1
    return out


def short_name(mangled: str, names) -> str | None:
    """The kernel of ``names`` a mangled name is, with its template
    argument where it has one (``fx_dh_wgmma<8>``)."""
    name = next((k for k in names if k in mangled), None)
    m = name and re.search(name + r"ILi(\d+)E", mangled)
    return f"{name}<{m.group(1)}>" if m else name


def library_kernels(_build, tool, lib_name, names, hopper):
    """{kernel: registers, spill bytes, HGMMA / UTMALDG / HMMA counts} of
    one library; raises if a kernel named in ``hopper`` (each of its
    template instances) lacks HGMMA or UTMALDG, has HMMA, or had its wgmma
    products serialised by ptxas (C7520, or such a note naming no
    kernel)."""
    lib = _build._target(lib_name)
    kernels = {}
    for mangled, rec in ptxas_report(lib.with_suffix(".log").read_text()
                                     ).items():
        if rec.get("wgmma_serialized") and (
                not mangled or short_name(mangled, hopper)):
            raise AssertionError(f"{lib_name}: ptxas serialised the wgmma "
                                 f"products of {mangled or 'a kernel'} "
                                 "(C7520)")
        if short_name(mangled, names):
            kernels[short_name(mangled, names)] = dict(rec)
    if tool is None:
        return kernels
    for mangled, counts in sass_counts(tool, lib).items():
        if short_name(mangled, names):
            kernels.setdefault(short_name(mangled, names), {}).update(counts)
    for name, rec in kernels.items():
        if name.split("<")[0] in hopper and not (
                rec.get("HGMMA") and rec.get("UTMALDG")
                and rec.get("HMMA") == 0):
            raise AssertionError(f"{name} was not compiled to wgmma and TMA "
                                 f"loads alone: {rec}")
    if not all(any(k.split("<")[0] == h for k in kernels) for h in hopper):
        raise AssertionError(f"{lib_name}: a kernel of {hopper} is missing "
                             f"from {sorted(kernels)}")
    return kernels


def paged_kernels(_build, tool):
    """{kernel<pool type>: registers, spill bytes, LDGSTS count} of the
    paged library; raises if an instance of a paged kernel is missing,
    spills or, with cuobjdump, has no LDGSTS (cp.async) instruction."""
    lib = _build._target("paged_attention")

    def name(mangled):
        base = next((k for k in PAGED_BUILT if k in mangled), None)
        kind = next((v for k, v in PAGED_TYPES.items()
                     if base and base + k in mangled), "?")
        return base and f"{base}<{kind}>"

    kernels = {}
    for mangled, rec in ptxas_report(lib.with_suffix(".log").read_text()
                                     ).items():
        if name(mangled):
            kernels[name(mangled)] = dict(rec)
    if tool is not None:
        for mangled, counts in sass_counts(tool, lib, ("LDGSTS",)).items():
            if name(mangled):
                kernels.setdefault(name(mangled), {}).update(counts)
    want = {f"{k}<{v}>" for k in PAGED_BUILT for v in PAGED_TYPES.values()}
    if not want <= set(kernels):
        raise AssertionError(f"paged_attention: instances "
                             f"{sorted(want - set(kernels))} missing")
    for k, rec in kernels.items():
        if rec.get("spill_bytes", 0) or (tool and not rec.get("LDGSTS")):
            raise AssertionError(f"{k} spills or has no cp.async (LDGSTS): "
                                 f"{rec}")
    return kernels


def phase_build(_build):
    """Compile every kernel library (one nvcc each, started together),
    then show what the flash and fused-head libraries' kernels were
    compiled to: registers and spill bytes from the -Xptxas -v log, and the
    counts of wgmma (HGMMA), TMA load (UTMALDG) and mma.sync (HMMA)
    instructions from cuobjdump, and the paged kernels' registers, spills
    and cp.async (LDGSTS) counts. Fails if a bfloat16 flash or fused-head
    kernel lacks HGMMA or UTMALDG, has HMMA, or had its wgmma products
    serialised (C7520), or if an instance of a paged kernel (chunk,
    decode) spills or has no LDGSTS."""
    t0 = time.perf_counter()
    built = _build.build()
    seconds = time.perf_counter() - t0
    for name in built:
        print(_build._target(name).with_suffix(".log").read_text(),
              file=sys.stderr)
    tool = cuobjdump()
    emit({"phase": "build", "seconds": seconds, "nvcc_seconds": built,
          "cuobjdump": tool or "not found: instruction counts not checked",
          "flash_attention_kernels": library_kernels(
              _build, tool, "flash_attention", FLASH_BUILT, FLASH_HOPPER),
          "fused_xent_kernels": library_kernels(
              _build, tool, "fused_xent", FX_BUILT, FX_HOPPER),
          "paged_attention_kernels": paged_kernels(_build, tool)})


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


KV_U = {}


def make_pools(torch, pd, dtype, gen, dev, page=PAGE):
    """Random K/V pools [POOL_PAGES, page, H, DH] of ``dtype``. An int8
    pool holds random float32 rows as the port's own chunk write
    quantises them (layer seed 1), so its scales are real sidecars."""
    pk = torch.randn(POOL_PAGES, page, H, DH, generator=gen).to(dev)
    pv = torch.randn(POOL_PAGES, page, H, DH, generator=gen).to(dev)
    if dtype != torch.int8:
        return {"pool_k": pk.to(dtype), "pool_v": pv.to(dtype)}
    pool = pd.serve_pool_init(POOL_PAGES, page, H, DH, torch.int8, dev)
    n = POOL_PAGES * page
    if n not in KV_U:  # the rounding table of n positions, hashed once
        KV_U[n] = pd.kv_u_table(1, n, H, DH, dev)
    pool.update(kv_seed=1, kv_u=KV_U[n])
    every = {**pool, "table": torch.arange(POOL_PAGES, dtype=torch.int32,
                                           device=dev)[None]}
    pd.paged_table_chunk_write(every, pk.reshape(1, n, H, DH),
                               pv.reshape(1, n, H, DH), 0, page)
    return {k: pool[k] for k in ("pool_k", "pool_v", "scale_k", "scale_v")}


def make_case(torch, pd, dtype, npl, C, gen, dev, aligned=True):
    """Pools, a scattered table drawn with replacement, a float32 query
    and per-row positions (decode, C None) or chunk starts: page-aligned
    (prefill), or any start whose span fits the live pages (verify)."""
    cache = make_pools(torch, pd, dtype, gen, dev)
    table = torch.randint(1, POOL_PAGES, (ROWS, NPG), generator=gen)
    cache["table"] = table.to(dev, torch.int32)
    if C is None:
        q = torch.randn(ROWS, H, DH, generator=gen).to(dev)
        pos = torch.randint(0, npl * PAGE, (ROWS,), generator=gen)
    elif aligned:
        q = torch.randn(ROWS, H, C, DH, generator=gen).to(dev)
        pos = torch.randint(0, (npl * PAGE - C) // PAGE + 1, (ROWS,),
                            generator=gen) * PAGE
    else:
        q = torch.randn(ROWS, H, C, DH, generator=gen).to(dev)
        pos = torch.randint(0, npl * PAGE - C + 1, (ROWS,), generator=gen)
    return q, cache, pos.to(dev, torch.int32)


def decode_edge_case(torch, pd, dtype, page, npl, key, gen, dev):
    """A decode case at the decode kernel's edges: pools of ``page``-position
    pages, a scattered table drawn with replacement, row 0 on the last live
    page, row 1 on page 0 (warps 1-7 walk nothing), the others on random
    live pages, each row on its page's ``key`` ("first" or "last") key."""
    cache = make_pools(torch, pd, dtype, gen, dev, page)
    cache["table"] = torch.randint(1, POOL_PAGES, (ROWS, npl),
                                   generator=gen).to(dev, torch.int32)
    q = torch.randn(ROWS, H, DH, generator=gen).to(dev)
    pages = torch.randint(0, npl, (ROWS,), generator=gen)
    pages[0], pages[1] = npl - 1, 0
    pos = pages * page + (0 if key == "first" else page - 1)
    return q, cache, pos.to(dev, torch.int32)


def run_kernel(pd, q, cache, pos, npl, C, page=PAGE):
    if C is None:
        return pd.paged_attention(q, cache, pos, npl, page)
    return pd.paged_chunk_attention(q, cache, pos, npl, page)


def run_plain(pd, q, cache, pos, npl, C, page=PAGE):
    if C is None:
        return pd._paged_attention_ref(q, cache, pos, npl, page)
    return pd._paged_chunk_attention_ref(q, cache, pos, npl, page)


def library_call(torch, q, cache, pos, npl, C, page=PAGE):
    """scaled_dot_product_attention over the pages gathered (and, for an
    int8 pool, dequantised) beforehand, with the same absolute causal
    mask: returns the timed closure."""
    import torch.nn.functional as F

    tbl = cache["table"][:, :npl].long()
    L = npl * page
    rows = q.shape[0]

    def pages(name):  # an int8 pool dequantised here, outside the timing
        x = cache["pool_" + name][tbl].float()
        if "scale_" + name in cache:
            x = x * cache["scale_" + name][tbl][..., None, None]
        return x.reshape(rows, L, H, DH).transpose(1, 2)

    k, v = pages("k"), pages("v")
    qq = q[:, :, None] if C is None else q
    k, v = k.to(q.dtype).contiguous(), v.to(q.dtype).contiguous()
    cq = 1 if C is None else C
    qpos = pos[:, None] + torch.arange(cq, device=q.device)[None, :]
    mask = (torch.arange(L, device=q.device)[None, None, None, :]
            <= qpos[:, None, :, None])
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def time_ms(torch, fn, flush, iters=20, warmup=5) -> float:
    """Mean device time of fn() over ``iters`` launches: CUDA events
    around each launch, the L2 flushed (64 MiB written) before each. A
    device-side sleep holds the stream while the host enqueues every
    launch, so the events time the device's work, not the host's Python
    between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * 5e-3 * iters))  # ~5 ms a launch at 2 GHz
    events = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def bound(q, cache, pos, npl, C, page=PAGE):
    """(bound_ms, bound_by) for one call on these inputs: bytes each input
    read once (the live table entries, and each distinct pool slot they
    name once — a slot two rows share is one read) and the output written
    once, over the memory rate; the QK and PV products over the visible
    (query, key) pairs, over the peak rate for float32 (the query's type;
    the kernel computes in float32 over any pool). An int8 pool adds each
    distinct slot's two float32 scale rows."""
    elt = cache["pool_k"].element_size()
    cq = 1 if C is None else C
    nbytes = 2 * q.numel() * q.element_size()  # q read + out written
    nbytes += pos.numel() * 4
    pairs, slots = 0, set()
    for r, p0 in enumerate(pos.tolist()):
        last = min(p0 + cq - 1, npl * page - 1)
        live = last // page + 1
        nbytes += live * 4  # table entries
        slots.update(cache["table"][r, :live].tolist())
        pairs += sum(min(p0 + c, npl * page - 1) + 1 for c in range(cq))
    nbytes += len(slots) * 2 * page * H * DH * elt  # K, V of each slot
    if "scale_k" in cache:
        nbytes += len(slots) * 2 * page * 4  # its K and V scale rows
    flops = 4 * pairs * H * DH
    dt = "float32"
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_planted_faults(torch, pd, gen, dev):
    """The check must reject two faults built from the plain versions
    over an int8 pool: the K scale ignored (scale 1), and each page's
    scales read from the next slot."""
    out = []
    for C, aligned in ((None, True), (16, True), (VERIFY_C, False)):
        q, cache, pos = make_case(torch, pd, torch.int8, NPG, C, gen, dev,
                                  aligned)
        want = run_plain(pd, q, cache, pos, NPG, C)
        faults = {
            "k_scale_ignored": {**cache, "scale_k": torch.ones_like(
                cache["scale_k"])},
            "scales_from_next_slot": {
                **cache, "scale_k": cache["scale_k"].roll(-1, 0),
                "scale_v": cache["scale_v"].roll(-1, 0)},
        }
        for fault, bad in faults.items():
            err = (run_plain(pd, q, bad, pos, NPG, C) - want).abs().max()
            err = err.item()
            rec = {"fault": fault, "C": C, "max_abs_err": err, "tol": TOL,
                   "rejected": not err <= TOL}
            out.append(rec)
            if not rec["rejected"]:
                raise AssertionError(f"planted fault {fault} C={C} passed "
                                     f"the check: {err} <= {TOL}")
    return out


def paged_plain(torch, q, cache, pos, npl, drop_mod8=None, late_tile=False,
                scale_lag=0, skip_last_page=False):
    """The chunk attention's plain arithmetic with an optional planted
    fault: keys of pages j = ``drop_mod8`` mod 8 masked out (one warp's
    pages); the last 16 queries' positions 16 too early (the last query
    tile at the wrong offset); on an int8 pool, page j's scales taken
    from the slot of page j - ``scale_lag`` (pages before ``scale_lag``
    keep their own); each query's last visible page skipped (where it is
    not page 0). A decode query [rows, H, DH] is a chunk of one."""
    if q.dim() == 3:
        return paged_plain(torch, q[:, :, None], cache, pos, npl, drop_mod8,
                           late_tile, scale_lag, skip_last_page)[:, :, 0]
    rows, _, C, _ = q.shape
    tbl = cache["table"][:, :npl].long()
    L = npl * PAGE

    def pages(name):
        x = cache["pool_" + name][tbl].float()  # [rows, npl, PAGE, H, DH]
        if "scale_" + name in cache:
            stbl = tbl.clone()
            if scale_lag:
                stbl[:, scale_lag:] = tbl[:, :-scale_lag]
            x = x * cache["scale_" + name][stbl][..., None, None]
        return x.reshape(rows, L, H, DH).transpose(1, 2)

    k, v = pages("k"), pages("v")
    scores = torch.einsum("rhqd,rhkd->rhqk", q, k) / math.sqrt(DH)
    qpos = pos[:, None].long() + torch.arange(C, device=q.device)[None, :]
    if late_tile:
        qpos[:, -16:] -= 16
    kpos = torch.arange(L, device=q.device)
    ok = kpos[None, None, None, :] <= qpos[:, None, :, None]
    if drop_mod8 is not None:
        ok = ok & ((kpos // PAGE) % 8 != drop_mod8)[None, None, None, :]
    if skip_last_page:
        last = (qpos // PAGE)[:, :, None]  # [rows, C, 1]
        ok = ok & (((kpos // PAGE)[None, None, :] != last)
                   | (last == 0))[:, None]
    probs = torch.softmax(scores.masked_fill(~ok, -math.inf), -1)
    return torch.einsum("rhqk,rhkd->rhqd", probs, v)


def paged_planted_faults(torch, pd, gen, dev):
    """The 1e-4 check that passes a paged kernel must reject the plain
    arithmetic with a fault aimed at one part of the kernel's design. The
    chunk kernel: one warp's pages dropped, the last query tile at
    positions 16 too early (C 256), each page's scales from the previous
    page of its warp's walk (int8). The decode kernel (C None, row 0 at the
    last key of its 16 pages): one warp's pages dropped, each query's last
    visible page skipped, each page's scales from the previous page of its
    warp's walk (int8). The fault-free plain arithmetic (the controls) must
    pass. Returns (faults, controls)."""
    faults, controls = [], []
    for fault, dtype, C, kw in (
            ("control", torch.float32, 16, {}),
            ("warp_7_pages_dropped", torch.float32, 16, {"drop_mod8": 7}),
            ("last_tile_16_early", torch.float32, 256, {"late_tile": True}),
            ("control_int8", torch.int8, 16, {}),
            ("scales_from_previous_page_of_warp", torch.int8, 16,
             {"scale_lag": 8}),
            ("decode_control", torch.float32, None, {}),
            ("decode_warp_7_pages_dropped", torch.float32, None,
             {"drop_mod8": 7}),
            ("decode_last_page_skipped", torch.float32, None,
             {"skip_last_page": True}),
            ("decode_control_int8", torch.int8, None, {}),
            ("decode_scales_from_previous_page_of_warp", torch.int8, None,
             {"scale_lag": 8})):
        q, cache, pos = make_case(torch, pd, dtype, NPG, C, gen, dev)
        if C is None:
            pos[0] = NPG * PAGE - 1
        got = run_kernel(pd, q, cache, pos, NPG, C)
        err = (paged_plain(torch, q, cache, pos, NPG, **kw) - got).abs()
        err = err.max().item()
        rec = {"fault": fault, "C": C, "pool": str(dtype).split(".")[-1],
               "max_abs_err": err, "tol": TOL, "rejected": not err <= TOL}
        control = "control" in fault
        (controls if control else faults).append(rec)
        if control == rec["rejected"]:
            raise AssertionError(f"paged planted fault {fault}: {rec}")
    return faults, controls


def paged_reruns(torch, pd, gen, dev):
    """A paged kernel run twice on the same inputs gives the same bits (the
    warps merge in a fixed order): the chunk kernel at C 16, C 256 and the
    verify shape, the decode kernel (C None)."""
    out = []
    for dtype in (torch.float32, torch.int8):
        for C, aligned in ((16, True), (256, True), (VERIFY_C, False),
                           (None, True)):
            q, cache, pos = make_case(torch, pd, dtype, NPG, C, gen, dev,
                                      aligned)
            a = run_kernel(pd, q, cache, pos, NPG, C)
            b = run_kernel(pd, q, cache, pos, NPG, C)
            same = bool(torch.equal(a, b))
            out.append({"C": C, "pool": str(dtype).split(".")[-1],
                        "reruns_bitwise_equal": same})
            if not same:
                raise AssertionError(f"paged kernel reruns differ: C={C} "
                                     f"{dtype}")
    return out


def phase_kernels(torch, pd, dev):
    gen = torch.Generator().manual_seed(0)
    worst = {name: 0.0 for name in KERNELS}
    checks = []
    cases = [(dtype, C, npl, True)
             for dtype in (torch.float32, torch.bfloat16, torch.int8)
             for C, npls in ((None, (1, 3, 16)), (16, (1, 3, 16)),
                             (256, (16,)))
             for npl in npls]
    # the verify pass: rows 8, C 5, per-row unaligned starts
    cases += [(dtype, VERIFY_C, npl, False)
              for dtype in (torch.float32, torch.int8) for npl in (3, 16)]
    # the chunk kernel's edges: one query, partial last query tiles, npl 9
    cases += [(dtype, C, npl, aligned)
              for dtype in (torch.float32, torch.int8)
              for C, npl, aligned in ((1, 16, False), (17, 16, True),
                                      (33, 16, False), (1, 9, False),
                                      (16, 9, True), (33, 9, True))]

    def check(dtype, C, npl, page, starts, q, cache, pos):
        dname = str(dtype).split(".")[-1]
        name = "paged_attention" if C is None else "paged_chunk_attention"
        got = run_kernel(pd, q, cache, pos, npl, C, page)
        want = run_plain(pd, q, cache, pos, npl, C, page)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = math.isfinite(err) and err <= TOL
        checks.append({"kernel": name, "pool": dname, "npl": npl, "C": C,
                       "page": page, "starts": starts, "max_abs_err": err,
                       "tol": TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} {dname} pool page={page} npl={npl} "
                                 f"C={C}: max abs err {err} > {TOL}")
        if dtype == torch.int8:
            worst[name + "_int8"] = max(worst[name + "_int8"], err)
        elif dtype == torch.float32:
            worst[name] = max(worst[name], err)

    for dtype, C, npl, aligned in cases:
        check(dtype, C, npl, PAGE, "page-aligned" if aligned else "unaligned",
              *make_case(torch, pd, dtype, npl, C, gen, dev, aligned))
    # the decode kernel's edges: pages of 8 (one partial chunk), 16 and 32
    # (two chunks), npl 1, 9 and 16, pages of 64 at npl 1-8, positions on
    # a page's first and last key, a row whose warps 1-7 walk nothing
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for page, npl, key in DECODE_EDGES:
            check(dtype, None, npl, page, f"{key} key of a page",
                  *decode_edge_case(torch, pd, dtype, page, npl, key, gen,
                                    dev))
    faults = int8_planted_faults(torch, pd, gen, dev)
    design_faults, controls = paged_planted_faults(torch, pd, gen, dev)
    emit({"phase": "kernels", "checks": checks,
          "planted_faults": faults + design_faults,
          "fault_free_controls": controls,
          "paged_reruns": paged_reruns(torch, pd, gen, dev)})

    # timing at the deepest shapes the main path's pool can hold, float32
    # and int8 pools — these are the kernels table's. Decode: the 8 rows
    # hold all 63 usable slots, each slot in one row only, every row at
    # the last position of its last page, one row at the 16-page max_len
    # (npl 16). Prefill chunk: 1 row, C 16, the chunk that ends a 16-page
    # stream over 16 distinct slots. Then, for the record, the same over a
    # bfloat16 pool, the unchunked admission's one 256-query chunk, and
    # the verify pass (8 rows, C 5, each row's span ending 0-2 positions
    # before the end of its live pages). Table columns past a row's live
    # pages name the scratch slot.
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    perm = (torch.randperm(POOL_PAGES - 1, generator=gen) + 1).tolist()
    table = torch.zeros(ROWS, NPG, dtype=torch.int32)
    for r, live in enumerate(DECODE_LIVE):
        table[r, :live] = torch.tensor(perm[:live])
        perm = perm[live:]
    decode_pos = torch.tensor([live * PAGE - 1 for live in DECODE_LIVE],
                              dtype=torch.int32)
    verify_pos = torch.tensor([live * PAGE - VERIFY_C - r % 3
                               for r, live in enumerate(DECODE_LIVE)],
                              dtype=torch.int32)
    timed, more = {}, []
    for key, C, rows, dtype in (
            ("paged_attention", None, ROWS, torch.float32),
            ("paged_chunk_attention", 16, 1, torch.float32),
            ("paged_attention_int8", None, ROWS, torch.int8),
            ("paged_chunk_attention_int8", 16, 1, torch.int8),
            ("paged_attention", None, ROWS, torch.bfloat16),
            ("paged_chunk_attention", 16, 1, torch.bfloat16),
            ("paged_chunk_attention", 256, 1, torch.float32),
            ("verify", VERIFY_C, ROWS, torch.float32),
            ("verify_int8", VERIFY_C, ROWS, torch.int8)):
        cache = make_pools(torch, pd, dtype, gen, dev)
        cache["table"] = table[:rows].to(dev)
        shape = (rows, H, DH) if C is None else (rows, H, C, DH)
        q = torch.randn(*shape, generator=gen).to(dev)
        if C is None:
            pos = decode_pos.to(dev)
        elif C == VERIFY_C:
            pos = verify_pos.to(dev)
        else:  # row 0 holds 16 pages: the chunk ending its stream
            pos = torch.full((rows,), NPG * PAGE - C, dtype=torch.int32,
                             device=dev)
        b_ms, b_by = bound(q, cache, pos, NPG, C)
        if not timed:  # a process's first timed call reads high: discard it
            time_ms(torch, lambda: run_kernel(pd, q, cache, pos, NPG, C),
                    flush)
        rec = {
            "ms": time_ms(torch, lambda: run_kernel(pd, q, cache, pos, NPG,
                                                    C), flush),
            "plain_ms": time_ms(torch, lambda: run_plain(pd, q, cache, pos,
                                                         NPG, C), flush),
            "library_ms": time_ms(torch, library_call(torch, q, cache, pos,
                                                      NPG, C), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"rows": rows, "H": H, "dh": DH, "C": C, "page": PAGE,
                      "npl": NPG, "pool": str(dtype).split(".")[-1],
                      "live_pages": (list(DECODE_LIVE)
                                     if C in (None, VERIFY_C) else [NPG])},
        }
        if key in timed or key.startswith("verify"):
            more.append({"kernel": key, **rec})
        else:
            timed[key] = rec
    emit({"phase": "kernel_times", "times": timed, "more": more,
          "library_note": "library_ms: scaled_dot_product_attention over "
                          "the live pages gathered beforehand; for an int8 "
                          "pool also dequantised beforehand (int8 * scale "
                          "outside the timed call)"})
    return worst, timed


def teacher_forced_check(torch, model, server, reqs, dev, n_check=2):
    """Each emitted token of ``n_check`` finished requests must be the
    greedy choice (within 1e-3 of the max logit) of the plain full-forward
    model on prompt + emitted tokens: the "xla" attention backend, so no
    kernel under test computes the reference."""
    from ddlbench_tpu_torch.models.transformer import set_attention_backend

    by_rid = {f["rid"]: f for f in server.finished}
    worst = 0.0
    set_attention_backend("xla")
    try:
        for rid in sorted(by_rid)[:n_check]:
            f = by_rid[rid]
            prompt = reqs[rid].prompt.tolist()
            toks = prompt + f["tokens"]
            with torch.no_grad():
                logits = model(torch.tensor([toks], device=dev))[0].float()
            S = len(prompt)
            for i, tok in enumerate(f["tokens"]):
                row = logits[S - 1 + i]
                gap = (row.max() - row[tok]).item()
                worst = max(worst, gap)
                if not math.isfinite(gap) or gap > 1e-3:
                    raise AssertionError(
                        f"request {rid} token {i}: emitted {tok} is {gap} "
                        "below the plain model's max logit")
    finally:
        set_attention_backend("auto")
    return worst


def phase_serve(torch, dev):
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.ops import paged_decode as pd
    from ddlbench_tpu_torch.tools import servebench

    args = servebench.build_parser().parse_args([
        "-m", "transformer_s", "-b", "synthtext", "--policies", "continuous",
        "--arrival", "closed", "--requests", "16", "--seed", "0",
        "--wall-clock"])
    model = get_model(args.model, args.benchmark, seed=args.seed).to(dev)
    pd.paged_attention.launches = 0
    pd.paged_chunk_attention.launches = 0
    (rec, server, reqs), = servebench.run(args, model, dev)
    launches = {"paged_attention": pd.paged_attention.launches,
                "paged_chunk_attention": pd.paged_chunk_attention.launches}
    if rec["completed"] != args.requests:
        raise AssertionError(f"completed {rec['completed']} of "
                             f"{args.requests} requests")
    if rec["plain_launches"]:
        raise AssertionError(f"{rec['plain_launches']} paged calls took the "
                             "plain path on the main path")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    gap = teacher_forced_check(torch, model, server, reqs, dev)
    emit({"phase": "serve", "launches": launches,
          "teacher_forced_max_gap": gap, "row": rec})
    return launches


def lever_followup(server, reqs, clock):
    """Three more requests through a server that has finished servebench's
    run: the first request's 64-token shared prefix (4 pages) alone (a
    full hit if its pages are still cached, else a prefill that caches
    them), then that prompt twice, admitted together, each a full
    page-aligned hit that binds 3 pages and copies the 4th: the
    copy-on-write path, which servebench's unique prompt tails never take.
    Returns the new requests."""
    from ddlbench_tpu_torch.serve.workload import ServeRequest

    head = reqs[0].prompt[:64].copy()
    extra = []
    for batch in ([head], [head, head]):
        for p in batch:
            extra.append(ServeRequest(rid=len(reqs) + len(extra), prompt=p,
                                      max_new=8, arrival=clock))
            server.submit(extra[-1], now=clock)
        while server.has_work():
            clock += server.step(clock).cost
    return extra


def serve_logits(torch, engine, toks):
    """The float32 logits [T, V] at every position of ``toks`` through
    ``engine``'s model and pools (one unchunked prefill at position 0 over
    pages 1.., the paged chunk kernel reading back what it wrote)."""
    from ddlbench_tpu_torch.models.layers import ServeLayer

    page, T = engine.page, len(toks)
    npl = -(-T // page)
    dev = engine.device
    table = torch.zeros((1, engine.npg_max), dtype=torch.int32, device=dev)
    table[0, :npl] = torch.arange(1, npl + 1, dtype=torch.int32)
    h = torch.zeros((1, npl * page), dtype=torch.int32, device=dev)
    h[0, :T] = torch.tensor(toks, dtype=torch.int32)
    with torch.no_grad():
        for layer, pool in zip(engine.model.layers, engine.pools):
            h = (layer.serve_prefill(pool, table, h, 0, npl, page)
                 if isinstance(layer, ServeLayer) else layer(h))
    return h[0, :T].float()


def divergences(torch, model, dev, reqs, toks_a, toks_b):
    """Where an int8 stream first leaves its float32 stream, the two
    tokens' logit gap through the float32 serving path on the shared
    prefix, and the int8 pool's perturbation of that position's logits
    (the largest |int8 - float32| over the vocabulary, both through the
    serving path). A flip is within the int8 noise when the gap is at
    most twice that perturbation."""
    from ddlbench_tpu_torch.config import ServeConfig
    from ddlbench_tpu_torch.serve.engine import ServeEngine

    engines = {kv: ServeEngine(model, ServeConfig(kv_dtype=kv), dev)
               for kv in ("float32", "int8")}
    out = {}
    for rid, want in toks_a.items():
        got = toks_b[rid]
        i = next((i for i, (x, y) in enumerate(zip(want, got)) if x != y),
                 None)
        if i is None:
            continue
        toks = reqs[rid].prompt.tolist() + want[:i]
        z32, z8 = (serve_logits(torch, engines[kv], toks)[-1]
                   for kv in ("float32", "int8"))
        a, b = want[i], got[i]
        gap = (z32[a] - z32[b]).item()
        noise = (z8 - z32).abs().max().item()
        out[rid] = {"position": i, "float32_gap": gap,
                    "int8_logit_noise": noise,
                    "int8_gap": (z8[a] - z8[b]).item(),
                    "within_noise": gap <= 2 * noise}
    return out


def phase_serve_levers(torch, pd, dev):
    """servebench with the int8 pool, the prefix cache and speculative
    verify on the card: (b) int8 at the first n-gram length of SPEC_NGRAMS
    whose traffic drafts and accepts (else the first that drafts); (a)
    float32, held against the plain full-forward model; (c) int8 again,
    bitwise (b). Counters, launches and the digits gate read servebench's
    run alone; the copy-on-write follow-up after it is counted apart."""
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.tools import servebench

    model = get_model("transformer_s", "synthtext", seed=0).to(dev)
    kernels = (pd.paged_attention, pd.paged_chunk_attention)

    def run(kv, n):
        args = servebench.build_parser().parse_args(
            LEVER_ARGS + ["--kv-dtype", kv,
                          "--speculative", f"ngram:{n}:{SPEC_K}"])
        for fn in kernels:
            fn.launches = fn.launches_int8 = 0
        (rec, server, reqs), = servebench.run(args, model, dev)
        launches = {"paged_attention_int8": pd.paged_attention.launches_int8,
                    "paged_chunk_attention_int8":
                        pd.paged_chunk_attention.launches_int8,
                    "float_pool_launches": sum(fn.launches
                                               for fn in kernels)}
        if rec["completed"] != args.requests:
            raise AssertionError(f"{kv}: completed {rec['completed']} of "
                                 f"{args.requests} requests")
        if rec["plain_launches"]:
            raise AssertionError(f"{kv}: {rec['plain_launches']} paged calls "
                                 "took the plain path")
        if rec["prefix_hits"] <= 0:
            raise AssertionError(f"{kv}: no prefix hit")
        toks = {f["rid"]: f["tokens"] for f in server.finished}
        return rec, server, reqs, toks, launches

    def followup(kv, rec, server, reqs):
        plain0 = sum(fn.plain_launches for fn in kernels)
        extra = lever_followup(server, reqs, rec["duration"])
        if sum(fn.plain_launches for fn in kernels) != plain0:
            raise AssertionError(f"{kv} follow-up: paged calls took the "
                                 "plain path")
        stats = server.stats_summary()
        delta = {k: stats[k] - rec[k] for k in ("prefix_hits",
                                                 "cow_copies")}
        if delta["cow_copies"] <= 0:
            raise AssertionError(f"{kv} follow-up: no copy-on-write copy")
        toks = {f["rid"]: f["tokens"] for f in server.finished
                if f["rid"] >= len(reqs)}
        return reqs + extra, toks, delta

    tried = {}
    for n in SPEC_NGRAMS:
        tried[n] = run("int8", n)
        if tried[n][0]["spec_accepted"] > 0:
            break
    accepting = [n for n in tried if tried[n][0]["spec_accepted"] > 0]
    drafting = [n for n in tried if tried[n][0]["spec_drafted"] > 0]
    if not drafting:
        raise AssertionError(f"int8: no n-gram length of {SPEC_NGRAMS} "
                             "drafts on servebench's traffic")
    ngram = (accepting or drafting)[0]
    rec_b, server_b, reqs_b, toks_b, launches = tried[ngram]
    for name in ("paged_attention_int8", "paged_chunk_attention_int8"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if launches["float_pool_launches"]:
        raise AssertionError("an int8 run launched the float-pool kernels")
    _, follow_b, delta_b = followup("int8", rec_b, server_b, reqs_b)
    rec_a, server_a, reqs_a, toks_a, _ = run("float32", ngram)
    reqs_a, follow_a, delta_a = followup("float32", rec_a, server_a, reqs_a)
    gap = teacher_forced_check(torch, model, server_a, reqs_a, dev,
                               n_check=len(reqs_a))
    if rec_b["pool_bytes"] * 4 != rec_a["pool_bytes"]:
        raise AssertionError(f"int8 pool_bytes {rec_b['pool_bytes']} is "
                             f"not a quarter of {rec_a['pool_bytes']}")
    rec_c, server_c, reqs_c, toks_c, _ = run("int8", ngram)
    _, follow_c, _ = followup("int8", rec_c, server_c, reqs_c)
    if toks_c != toks_b or follow_c != follow_b:
        raise AssertionError("int8 token streams differ between two runs")
    # the reference's digits gate: positional agreement of servebench's
    # int8 streams with its float32 ones. A miss must be explained: each
    # stream's first flip lies within the int8 pool's logit noise
    total = sum(len(t) for t in toks_a.values())
    agree = sum(x == y for rid, t in toks_a.items()
                for x, y in zip(t, toks_b[rid]))
    digits = agree / total
    flips = divergences(torch, model, dev, reqs_a, toks_a, toks_b)
    if digits < DIGITS_GATE_INT8 and not all(
            f["within_noise"] for f in flips.values()):
        raise AssertionError(
            f"int8 digits gate: {agree}/{total} tokens match float32, "
            f"gate {DIGITS_GATE_INT8}, and a flip lies outside the int8 "
            f"noise: {flips}")
    keys = ("kv_dtype", "speculative", "completed", "output_tokens",
            "duration", "goodput_tokens_per_unit", "ttft_p50", "itl_p50",
            "prefill_tokens", "prefix_hits", "prefix_tokens_saved",
            "cow_copies", "spec_passes", "spec_drafted", "spec_accepted",
            "spec_accept_rate", "tokens_per_pass", "pool_bytes",
            "decode_calls", "prefill_calls", "wall_s", "wall_tokens_per_s",
            "decode_step_ms", "verify_step_ms", "prefill_chunk_ms")
    emit({"phase": "serve_levers", "speculative": f"ngram:{ngram}:{SPEC_K}",
          "int8_ngrams_tried": {f"ngram:{n}:{SPEC_K}": {
              k: t[0][k] for k in ("spec_passes", "spec_drafted",
                                   "spec_accepted")}
              for n, t in tried.items()},
          "launches": launches, "teacher_forced_max_gap": gap,
          "digits_int8_vs_float32": digits, "digits_agree": agree,
          "digits_total": total, "digits_gate": DIGITS_GATE_INT8,
          "digits_gate_met": digits >= DIGITS_GATE_INT8,
          "first_flips": flips,
          "int8_runs_bitwise": True,
          "followup": {"float32": delta_a, "int8": delta_b,
                       "int8_tokens_agree_float32": sum(
                           x == y for rid, t in follow_a.items()
                           for x, y in zip(t, follow_b[rid]))
                       / sum(len(t) for t in follow_a.values())},
          "rows": {name: {k: rec.get(k) for k in keys}
                   for name, rec in (("a_float32", rec_a), ("b_int8", rec_b),
                                     ("c_int8", rec_c))}})
    return launches


def slo_run(model, dev, kv, trace_dir, extra=(), argv=SLO_ARGS):
    """servebench's SLO command (``argv``) over a ``kv`` pool on ``dev``,
    traced into a new file of ``trace_dir``. Returns (row, server, trace
    path, {rid: tokens})."""
    from ddlbench_tpu_torch.tools import servebench

    path = str(Path(trace_dir) / f"slo_{len(os.listdir(trace_dir))}.json")
    args = servebench.build_parser().parse_args(
        argv + ["--kv-dtype", kv, "--trace", path] + list(extra))
    (rec, server, _), = servebench.run(args, model, dev)
    return rec, server, path, {f["rid"]: f["tokens"]
                               for f in server.finished}


def slo_row_diff(card, cpu):
    """(a): the virtual-time fields on which two rows differ."""
    keys = (set(card) | set(cpu)) - SLO_NOT_VIRTUAL
    return sorted(k for k in keys if card.get(k) != cpu.get(k))


def slo_conserved(rec, server):
    """(c): every request reached one terminal state (completed, timed
    out, or rejected after its retries), each shed submission was retried
    or rejected, and every page is back on the free list."""
    eng = server.engines[0]
    al = eng.allocator
    shed, retries, rejected, timeouts = (
        rec.get(k, 0) for k in ("shed", "retries", "rejected", "timeouts"))
    return (rec["completed"] + timeouts + rejected == rec["requests"]
            and rec.get("requests_lost", 0) == 0
            and shed == retries + rejected
            and al.free_pages == al.capacity and al.in_use == 0
            and not eng.has_work())


def slo_regenerates(base, evicting, server):
    """(b), the eviction half: the requests an evicting run completed
    carry the sampled streams they have in ``base``, evicted ones among
    them."""
    evicted = {e["rid"] for e in server.engines[0].evicted_log}
    both = set(base) & set(evicting)
    return bool(evicted & both) and all(base[r] == evicting[r]
                                        for r in both)


def slo_decomposition(path, server):
    """(d): serveview's TTFT components on a trace file sum exactly to
    each request's TTFT, which is the finished record's. The trace stamps
    one model pass as 1000 integer units, so the sums are taken there.
    Returns (ok, requests decomposed)."""
    from ddlbench_tpu_torch.serve.engine import _vns
    from ddlbench_tpu_torch.telemetry.serveview import breakdown

    with open(path) as f:
        bd = breakdown(json.load(f))
    fin = {f["rid"]: f for f in server.finished}
    ok = (bd["decomp_exact"] and bd["dropped_events"] == 0
          and bd["requests"] >= len(fin))
    for d in bd["per_request"]:
        parts = sum(_vns(d[k]) for k in ("queue", "prefill", "decode",
                                         "sched_gap"))
        ok = ok and d["exact"] and parts == _vns(d["ttft"])
        f = fin.get(d["rid"])
        if f is not None:
            ok = ok and _vns(d["ttft"]) == (_vns(f["first_token_t"])
                                            - _vns(f["arrival"]))
    return ok, bd["requests"]


def first_forks(card, cpu):
    """For each request completed on both: the first token index at which
    the card's sampled stream leaves the CPU's (absent where they agree)."""
    out = {}
    for rid in sorted(set(card) & set(cpu)):
        i = next((i for i, (a, b) in enumerate(zip(card[rid], cpu[rid]))
                  if a != b), None)
        if i is not None:
            out[rid] = i
    return out


def slo_faults(model, dev, trace_dir, cpu_rec):
    """(f): planted faults, each run on the card over a float32 pool and
    each required to fail its check: the sampler keyed by engine step in
    place of token index (b), batch admitted ahead of interactive (a),
    and a timeout that keeps its pages (c)."""
    from ddlbench_tpu_torch.serve.engine import ServeEngine, sample_token

    def keyed_by_step(self, raw, rid, token_index):
        return sample_token(raw, self.cfg.temperature, self.cfg.top_k,
                            self.cfg.sample_seed, rid,
                            int(self.stats["steps"]))

    def batch_first(self):
        for i, r in enumerate(self.queue):
            if r.tier == "batch":
                return i
        return 0

    def keeps_pages(self, now, rep):
        expired = [r for r in self.queue
                   if r.deadline is not None and now >= r.deadline]
        dead = {id(r) for r in expired}
        kept = [r for r in self.queue if id(r) not in dead]
        self.queue.clear()
        self.queue.extend(kept)
        for r in expired:
            self._record_timeout(r.rid, now, r.deadline, "queued", 0,
                                 r.tier, rep)
        for a in [a for a in self._active()
                  if a.req.deadline is not None and now >= a.req.deadline]:
            self.table[a.row, :] = 0  # its pages are never freed
            self.rows[a.row] = None
            self._record_timeout(a.req.rid, now, a.req.deadline, a.state,
                                 len(a.out), a.req.tier, rep)

    def caught_b():
        _, _, _, base = slo_run(model, dev, "float32", trace_dir)
        _, server, _, ev = slo_run(model, dev, "float32", trace_dir,
                                   argv=SLO_EVICT_ARGS)
        return not slo_regenerates(base, ev, server)

    def caught_a():
        rec, _, _, _ = slo_run(model, dev, "float32", trace_dir)
        return bool(slo_row_diff(rec, cpu_rec))

    def caught_c():
        rec, server, _, _ = slo_run(model, dev, "float32", trace_dir)
        return rec["timeouts"] > 0 and not slo_conserved(rec, server)

    out = {}
    for name, attr, fault, caught in (
            ("sampler_keyed_by_step", "_emit_token", keyed_by_step,
             caught_b),
            ("batch_admitted_first", "_next_admission_index", batch_first,
             caught_a),
            ("timeout_keeps_pages", "_cancel_expired", keeps_pages,
             caught_c)):
        original = getattr(ServeEngine, attr)
        setattr(ServeEngine, attr, fault)
        try:
            out[name] = "rejected" if caught() else "PASSED"
        finally:
            setattr(ServeEngine, attr, original)
    return out


SLO_ROW_KEYS = (
    "completed", "shed", "timeouts", "retries", "rejected", "requests_lost",
    "shed_rate", "timeout_rate", "retry_amplification", "duration",
    "ttft_p50", "ttft_p95", "itl_p50", "goodput_tokens_per_unit",
    "slo_attainment", "interactive_completed", "batch_completed",
    "interactive_slo_attainment", "batch_slo_attainment", "evicted",
    "decomp_exact", "wall_s", "wall_tokens_per_s", "decode_step_ms",
    "prefill_chunk_ms", "sample_ms")


def phase_serve_slo(torch, pd, dev):
    """servebench's SLO surface on the card (phase 3c of the docstring):
    per pool type, checks (a)-(e); then sampled against greedy in turns
    and the planted faults (f)."""
    import tempfile

    from ddlbench_tpu_torch.models.zoo import get_model

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cpu_model = get_model("transformer_s", "synthtext", seed=0)
    card_model = get_model("transformer_s", "synthtext", seed=0).to(dev)
    kernels = (pd.paged_attention, pd.paged_chunk_attention)
    pools, checks, cpu_rows = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slo_") as tmp:
        for kv in ("float32", "int8"):
            for fn in kernels:
                fn.launches = fn.launches_int8 = fn.plain_launches = 0
            rec, server, path, toks = slo_run(card_model, dev, kv, tmp)
            launches = {
                "paged_attention": pd.paged_attention.launches,
                "paged_chunk_attention": pd.paged_chunk_attention.launches,
                "paged_attention_int8": pd.paged_attention.launches_int8,
                "paged_chunk_attention_int8":
                    pd.paged_chunk_attention.launches_int8,
                "plain_launches": rec["plain_launches"]}
            mine, other = (("_int8", "") if kv == "int8" else ("", "_int8"))
            # (e): both paged kernels of this pool type launched, neither
            # of the other type's, no call on the plain path
            checks[f"{kv}_e_launches"] = (
                launches[f"paged_attention{mine}"] > 0
                and launches[f"paged_chunk_attention{mine}"] > 0
                and launches[f"paged_attention{other}"] == 0
                and launches[f"paged_chunk_attention{other}"] == 0
                and launches["plain_launches"] == 0)
            _, _, _, toks2 = slo_run(card_model, dev, kv, tmp)
            rec_ev, server_ev, _, toks_ev = slo_run(
                card_model, dev, kv, tmp, argv=SLO_EVICT_ARGS)
            cpu_rec, cpu_server, _, cpu_toks = slo_run(cpu_model, cpu, kv,
                                                       tmp)
            cpu_rows[kv] = cpu_rec
            diff = slo_row_diff(rec, cpu_rec)
            decomp_ok, decomposed = slo_decomposition(path, server)
            checks[f"{kv}_a_row_equals_cpu"] = not diff
            checks[f"{kv}_a_terminal_records_equal_cpu"] = (
                server.timed_out == cpu_server.timed_out
                and server.shed_records == cpu_server.shed_records)
            checks[f"{kv}_b_reruns_bitwise"] = toks == toks2
            checks[f"{kv}_b_eviction_regenerates"] = slo_regenerates(
                toks, toks_ev, server_ev)
            checks[f"{kv}_c_conserved"] = (slo_conserved(rec, server)
                                           and slo_conserved(rec_ev,
                                                             server_ev))
            checks[f"{kv}_d_decomposition_exact"] = decomp_ok
            forks = first_forks(toks, cpu_toks)
            pools[kv] = {
                "launches": launches, "row_diff_vs_cpu": diff,
                "row": {k: rec.get(k) for k in SLO_ROW_KEYS},
                "evict_run": {k: rec_ev[k] for k in (
                    "evicted", "completed", "duration")},
                "evicted_and_completed": sorted(
                    {e["rid"] for e in server_ev.engines[0].evicted_log}
                    & set(toks_ev)),
                "decomposed_requests": decomposed,
                "streams_forked_vs_cpu": len(forks),
                "first_fork_index": min(forks.values()) if forks else None}
        # the command sampled against greedy over a float32 pool, in
        # turns (greedy, sampled, sampled, greedy), all warm
        turns = {"sampled": [], "greedy": []}
        for name in ("greedy", "sampled", "sampled", "greedy"):
            rec, _, _, _ = slo_run(
                card_model, dev, "float32", tmp,
                argv=SLO_ARGS if name == "sampled" else SLO_GREEDY_ARGS)
            turns[name].append({k: rec.get(k) for k in (
                "wall_s", "wall_tokens_per_s", "decode_step_ms",
                "prefill_chunk_ms", "sample_ms", "output_tokens")})
        faults = slo_faults(card_model, dev, tmp, cpu_rows["float32"])
    emit({"phase": "serve_slo", "argv": SLO_ARGS,
          "evict_argv": SLO_EVICT_ARGS, "checks": checks,
          "planted_faults": faults, "pools": pools,
          "sampled_vs_greedy": {"card": card_line(), **turns},
          "seconds": time.perf_counter() - t0})
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, v in faults.items() if v != "rejected"]
    if failed:
        raise AssertionError(f"serve_slo: failed {failed}")


# phase 3d, serve_fleet: the reference's fleet end-to-end tests' traffic
# (tests/test_serve_chaos.py's servechaos runs, tests/test_elastic.py's
# servebench --resize, tests/test_autoscale.py's servebench --autoscale)
# on transformer_s; --kv-dtype is added per pool
CHAOS_BASE = [
    "-m", "transformer_s", "-b", "synthtext", "--arrival", "closed",
    "--concurrency", "4", "--requests", "10", "--max-batch", "2",
    "--pool-pages", "9", "--page", "4", "--max-len", "16",
    "--prompt-lens", "2,4,8", "--out-lens", "2,4,8", "--seed", "5"]
BENCH_BASE = CHAOS_BASE[:8] + [
    "--requests", "8", "--max-batch", "2", "--pool-pages", "9", "--page",
    "4", "--max-len", "16", "--prompt-lens", "2,4,8", "--out-lens", "2,4,8",
    "--slo-ttft", "8", "--slo-itl", "2.5", "--seed", "5", "--policies",
    "continuous"]
# name -> (tool, argv, the flags (with their values) a control run drops)
FLEET_RUNS = {
    "i_kill_stall": ("servechaos", CHAOS_BASE + [
        "--replicas", "3", "--kill", "6:2", "--stall", "10:0:40",
        "--heartbeat", "4"], None),
    "ii_kill_stall_slo": ("servechaos", CHAOS_BASE + [
        "--replicas", "3", "--kill", "6:2", "--stall", "10:0:40",
        "--heartbeat", "4", "--deadline-slack", "64", "--retry", "2:8",
        "--tier-mix", "0.3", "--arrival", "poisson", "--rate", "0.5"], None),
    "iii_autoscale_repair": ("servechaos", CHAOS_BASE + [
        "--replicas", "2", "--kill", "8:1", "--autoscale", "2:2"], None),
    "iv_resize": ("servebench", [
        "-m", "transformer_s", "-b", "synthtext", "--policies",
        "continuous", "--arrival", "closed", "--concurrency", "6",
        "--requests", "16", "--max-batch", "4", "--pool-pages", "24",
        "--page", "8", "--max-len", "64", "--prompt-lens", "2,6,12",
        "--out-lens", "2,4,8", "--replicas", "2", "--resize", "8:1",
        "--resize", "24:3"], ("--resize",)),
    "v_autoscale_diurnal": ("servebench", BENCH_BASE + [
        "--arrival", "poisson", "--rate", "0.4", "--shape", "diurnal",
        "--autoscale", "1:2", "--scale-window", "8", "--scale-cooldown",
        "8"], ("--autoscale", "--scale-window", "--scale-cooldown")),
}
MEMORY_RTOL = 0.10  # (e): a fleet's allocation against its pools' bytes
FLEET_ROW_KEYS = (
    "completed", "requests_lost", "streams_match", "streams_compared",
    "kills_fired", "stalls_fired", "heartbeat_drains", "mttr_replica_s",
    "mttr_scripted_s", "repair_mttr_le_scripted", "repairs",
    "scale_events", "replica_hours", "final_replicas", "resize_events",
    "shed", "timeouts", "duration", "goodput_tokens_per_unit")


def without(argv, flags):
    """``argv`` with each of ``flags`` and its value left out."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        else:
            out.append(a)
    return out


def fleet_run(model, dev, tool, argv, kv):
    """One fleet command over a ``kv`` pool on ``dev``. Returns (row,
    {name: server}, {rid: tokens} of the run's own server, {rid: prompt
    tokens})."""
    from ddlbench_tpu_torch.tools import servebench, servechaos

    argv = argv + ["--kv-dtype", kv]
    if tool == "servechaos":
        args = servechaos.build_parser().parse_args(argv)
        rec, servers, reqs = servechaos.run(args, model, dev)
    else:
        args = servebench.build_parser().parse_args(argv)
        (rec, server, reqs), = servebench.run(args, model, dev)
        servers = {"chaos": server}
    return (rec, servers,
            {f["rid"]: f["tokens"] for f in servers["chaos"].finished},
            {r.rid: r.prompt.tolist() for r in reqs})


def fleet_idle(servers) -> bool:
    """(c): every live and retired engine of every server holds no work;
    the live and the drained ones have every page back on the free list;
    every retired one (drained or killed) has released its pool."""
    for srv in servers.values():
        killed = {ev["replica_id"] for ev in srv.fail_events}
        for eng in srv.engines + srv.retired:
            al = eng.allocator
            if eng.has_work():
                return False
            if eng.replica not in killed and not (
                    al.free_pages == al.capacity and al.in_use == 0):
                return False
        if any(p is not None for e in srv.retired for p in e.pools):
            return False
    return True


def fleet_memory(torch, model, dev, kv, build=None):
    """(e): build the 3-replica fleet of run (i) (or the server ``build``
    returns) and return (every engine's model is ``model`` with the same
    parameter storage, allocated bytes, the pools' bytes)."""
    from ddlbench_tpu_torch.config import ServeConfig
    from ddlbench_tpu_torch.serve.engine import make_server

    cfg = ServeConfig(max_batch=2, pool_pages=9, page=4, max_len=16,
                      prefill_chunk=4, replicas=3, kv_dtype=kv)
    build = build or (lambda: make_server(model, cfg, dev))
    # earlier phases' traced servers hold reference cycles: collect them
    # now, and let no collection free device memory inside the window
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(dev)
        server = build()
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated(dev) - m0
    finally:
        gc.enable()
    ptrs = {p.data_ptr() for p in model.parameters()}
    shared = all(e.model is model and {p.data_ptr() for p in
                                       e.model.parameters()} == ptrs
                 for e in server.engines)
    seen, pool_bytes = set(), 0
    for e in server.engines:
        for pool in e.pools:
            for t in (pool or {}).values():
                if torch.is_tensor(t) and t.data_ptr() not in seen:
                    seen.add(t.data_ptr())
                    pool_bytes += t.numel() * t.element_size()
    del server
    return shared, grown, pool_bytes


def fleet_forks(torch, model, dev, prompts, card, control):
    """The first fork of each stream that left its control: the token
    index and the control's top-2 logit margin there (both through the
    plain full-forward model)."""
    from ddlbench_tpu_torch.models.transformer import set_attention_backend

    out = []
    set_attention_backend("xla")
    try:
        for rid in sorted(set(card) & set(control)):
            a, b = card[rid], control[rid]
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if i is None:
                continue
            toks = prompts[rid] + b[:i]
            with torch.no_grad():
                row = model(torch.tensor([toks], device=dev))[0, -1].float()
            top = torch.topk(row, 2).values
            out.append({"rid": rid, "index": i,
                        "top2_margin": (top[0] - top[1]).item()})
    finally:
        set_attention_backend("auto")
    return out


def fleet_faults(model, dev, cpu_row):
    """Planted faults, each run on the card (run (i), float32 pool) and
    each required to fail its check: a kill that drops the killed
    replica's queue (b: a request is lost), a step that kicks a stalled
    replica's monitor (a: no heartbeat drain) and dispatch to the
    most-loaded replica (a)."""
    from ddlbench_tpu_torch.serve.engine import ReplicatedServer

    real_fail, real_step = ReplicatedServer.fail, ReplicatedServer.step

    def drops_queue(self, replica, now=0.0, dispatch=None):
        self.engines[replica].queue.clear()
        return real_fail(self, replica, now, dispatch)

    def kicks_stalled(self, now=0.0):
        rep = real_step(self, now)
        for e in self.engines:
            if e.monitor is not None:
                e.monitor.kick(now + rep.cost)
        return rep

    def most_loaded(self):
        return max(enumerate(self.engines),
                   key=lambda ie: (ie[1].load(), -ie[0]))[1]

    tool, argv, _ = FLEET_RUNS["i_kill_stall"]
    out = {}
    for name, attr, fault, check in (
            ("fail_drops_queue", "fail", drops_queue, "b"),
            ("step_kicks_stalled", "step", kicks_stalled, "a"),
            ("dispatch_most_loaded", "_least_loaded", most_loaded, "a")):
        original = ReplicatedServer.__dict__[attr]
        setattr(ReplicatedServer, attr, fault)
        try:
            rec, _, _, _ = fleet_run(model, dev, tool, argv, "float32")
        finally:
            setattr(ReplicatedServer, attr, original)
        caught = (rec["requests_lost"] != 0 if check == "b"
                  else bool(slo_row_diff(rec, cpu_row)))
        out[name] = "rejected" if caught else "PASSED"
    return out


def phase_serve_fleet(torch, pd, dev):
    """The replicated fleet on the card (phase 3d of the docstring): per
    pool type, the five fleet commands with checks (a)-(e); the planted
    faults; then 1 against 2 replicas, warm, in turns."""
    import tempfile

    from ddlbench_tpu_torch.models.zoo import get_model

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cpu_model = get_model("transformer_s", "synthtext", seed=0)
    card_model = get_model("transformer_s", "synthtext", seed=0).to(dev)
    kernels = (pd.paged_attention, pd.paged_chunk_attention)
    checks, pools, cpu_rows = {}, {}, {}
    for kv in ("float32", "int8"):
        for fn in kernels:
            fn.launches = fn.launches_int8 = fn.plain_launches = 0
        runs, plain = {}, 0
        for name, (tool, argv, drop) in FLEET_RUNS.items():
            rec, servers, toks, prompts = fleet_run(card_model, dev, tool,
                                                    argv, kv)
            plain += rec["plain_launches"]
            if drop:  # the card's own control: the run without the flags
                ctrl_rec, ctrl_servers, ctrl, _ = fleet_run(
                    card_model, dev, tool, without(argv, drop), kv)
                plain += ctrl_rec["plain_launches"]
                servers["control"] = ctrl_servers["chaos"]
                match = toks == ctrl
            else:
                ctrl = {f["rid"]: f["tokens"]
                        for f in servers["control"].finished}
                match = rec["streams_match"] is True
            runs[name] = (rec, servers, toks, ctrl, match, prompts)
        launches = {
            "paged_attention": pd.paged_attention.launches,
            "paged_chunk_attention": pd.paged_chunk_attention.launches,
            "paged_attention_int8": pd.paged_attention.launches_int8,
            "paged_chunk_attention_int8":
                pd.paged_chunk_attention.launches_int8,
            "plain_launches": plain}
        mine, other = (("_int8", "") if kv == "int8" else ("", "_int8"))
        checks[f"{kv}_d_launches"] = (
            launches[f"paged_attention{mine}"] > 0
            and launches[f"paged_chunk_attention{mine}"] > 0
            and launches[f"paged_attention{other}"] == 0
            and launches[f"paged_chunk_attention{other}"] == 0
            and plain == 0
            and pd.paged_attention.plain_launches == 0
            and pd.paged_chunk_attention.plain_launches == 0)
        rows, forks = {}, {}
        for name, (rec, servers, toks, ctrl, match, prompts) in \
                runs.items():
            tool, argv, _ = FLEET_RUNS[name]
            cpu_rec, cpu_servers, _, _ = fleet_run(cpu_model, cpu, tool,
                                                   argv, kv)
            cpu_rows[(kv, name)] = cpu_rec
            diff = slo_row_diff(rec, cpu_rec)
            srv, cpu_srv = servers["chaos"], cpu_servers["chaos"]
            checks[f"{kv}_{name}_a_row_equals_cpu"] = not diff and all(
                getattr(srv, k) == getattr(cpu_srv, k) for k in (
                    "fail_events", "stall_events", "heartbeat_events",
                    "resize_events", "timed_out", "shed_records"))
            ok_b = rec["requests_lost"] == 0 and match
            if name == "iii_autoscale_repair":
                ok_b = ok_b and rec["repair_mttr_le_scripted"] is True
            checks[f"{kv}_{name}_b_no_loss_streams_match"] = ok_b
            checks[f"{kv}_{name}_c_idle_and_freed"] = fleet_idle(servers)
            if not match:
                forks[name] = fleet_forks(torch, card_model, dev, prompts,
                                          toks, ctrl)
            rows[name] = {k: rec[k] for k in FLEET_ROW_KEYS if k in rec}
            if diff:
                rows[name]["row_diff_vs_cpu"] = diff
        shared, grown, pool_bytes = fleet_memory(torch, card_model, dev, kv)
        checks[f"{kv}_e_one_weight_copy"] = (
            shared and abs(grown - pool_bytes) <= MEMORY_RTOL * pool_bytes)
        pools[kv] = {"launches": launches, "rows": rows, "forks": forks,
                     "memory": {"allocated_bytes": grown,
                                "pool_bytes": pool_bytes}}
    faults = fleet_faults(card_model, dev,
                          cpu_rows[("float32", "i_kill_stall")])
    # 1 against 2 replicas on the card, warm, in turns (1, 2, 2, 1): the
    # serve_slo command greedy over a float32 pool
    turns = {"1": [], "2": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        slo_run(card_model, dev, "float32", tmp, argv=SLO_GREEDY_ARGS)
        for n in ("1", "2", "2", "1"):
            rec, _, _, _ = slo_run(card_model, dev, "float32", tmp,
                                   extra=["--replicas", n],
                                   argv=SLO_GREEDY_ARGS)
            turns[n].append({k: rec.get(k) for k in (
                "wall_s", "wall_tokens_per_s", "decode_step_ms",
                "prefill_chunk_ms", "output_tokens", "duration",
                "decode_batch_util", "decode_calls")})
    emit({"phase": "serve_fleet", "runs": {k: [t, a] for k, (t, a, _) in
                                           FLEET_RUNS.items()},
          "checks": checks, "planted_faults": faults, "pools": pools,
          "replicas_1_vs_2": {"card": card_line(), **turns},
          "seconds": time.perf_counter() - t0})
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, v in faults.items() if v != "rejected"]
    if failed:
        raise AssertionError(f"serve_fleet: failed {failed}")


# phase 3e, serve_disagg: the reference's disaggregation and SDC
# end-to-end tests' traffic (tests/test_serve_disagg.py and
# tests/test_serve_sdc.py: the seed-5 tiny traffic, 10 requests) on
# transformer_s; --kv-dtype is added per pool
DISAGG_BASE = [
    "-m", "transformer_s", "-b", "synthtext", "--arrival", "closed",
    "--concurrency", "4", "--requests", "10", "--max-batch", "2",
    "--pool-pages", "12", "--page", "4", "--max-len", "16",
    "--prompt-lens", "2,4,8", "--out-lens", "2,4,8", "--seed", "5"]
DISAGG_BENCH = DISAGG_BASE + ["--policies", "continuous", "--slo-ttft", "8",
                              "--slo-itl", "2.5"]
# name -> (tool, argv, the replica count of its aggregated control)
DISAGG_RUNS = {
    "i_bench_1_1": ("servebench", DISAGG_BENCH + ["--disaggregate", "1:1"],
                    2),
    "ii_bench_2_1_autoscale": ("servebench", DISAGG_BENCH + [
        "--disaggregate", "2:1", "--autoscale", "1:2", "--scale-window",
        "4", "--scale-cooldown", "4"], 3),
    "iii_chaos_2_2_kills": ("servechaos", DISAGG_BASE + [
        "--disaggregate", "2:2", "--kill", "2:p0", "--kill", "8:d0"], 4),
}
# servechaos --corrupt with detection on; "{t}" is the payload flip's time
# (the first candidate whose flip escapes under --no-detect on the card)
SDC_RUNS = {
    "payload": DISAGG_BASE + ["--replicas", "2", "--corrupt",
                              "{t}:0:payload"],
    "sidecar": DISAGG_BASE + ["--replicas", "2", "--corrupt",
                              "3:0:sidecar"],
    "prefix": DISAGG_BASE + [
        "--replicas", "2", "--corrupt", "5:0:prefix", "--prefix-cache",
        "--shared-prefix", "2:8", "--max-len", "24", "--pool-pages", "20"],
    "ship": DISAGG_BASE + ["--disaggregate", "1:1", "--corrupt",
                           "6:0:ship"],
    "decode_pool": DISAGG_BASE + ["--disaggregate", "1:1", "--corrupt",
                                  "6:d0:payload"],
    # boundary checks only, prompts long enough that a prefill-side page
    # settles between chunks: the export's verify catches the flip
    "export": DISAGG_BASE + [
        "--disaggregate", "1:1", "--corrupt", "1:p0:payload", "--scrub", "0",
        "--pool-pages", "20", "--max-len", "32", "--prompt-lens", "8,12,16"],
}
PAYLOAD_TIMES = (3, 2, 4, 5, 6, 7, 8)  # the reference's 3 first
# clean traffic with the ledger armed, each against the same command
# without --scrub; the 6-page pool evicts, so re-prefills meet the
# recompute check
SCRUB_RUNS = {
    "bench": DISAGG_BENCH + ["--scrub", "4"],
    "bench_evicting": DISAGG_BENCH + ["--scrub", "4", "--pool-pages", "6"],
    "bench_disagg_1_1": DISAGG_BENCH + ["--scrub", "4", "--disaggregate",
                                        "1:1"],
}
DISAGG_ROW_KEYS = (
    "completed", "requests_lost", "streams_match", "duration",
    "goodput_tokens_per_unit", "shipped_requests", "shipped_pages",
    "shipped_payload_bytes", "shipped_sidecar_bytes",
    "shipped_checksum_bytes", "kills_fired", "repairs", "scale_events",
    "sdc_injected", "sdc_detected", "sdc_quarantined", "sdc_recovered",
    "sdc_scrubbed", "sdc_recompute_checks", "sdc_wire_detected",
    "sdc_wire_repaired", "sdc_escaped", "mttd_sdc", "mttr_sdc_s")
TURN_KEYS = ("wall_s", "wall_tokens_per_s", "decode_step_ms",
             "prefill_chunk_ms", "output_tokens", "duration", "decode_calls",
             "prefill_calls", "ledger_s")


def sdc_caught(rec, target) -> bool:
    """(c): the flip was detected (at the wire for a ship), nothing
    escaped or was lost, and every stream equals the unfaulted control;
    a prefill-side flip is caught at the export, never on the wire."""
    det = (rec["sdc_wire_detected"] >= 1 and rec["sdc_wire_repaired"] >= 1
           if target == "ship" else rec["sdc_detected"] >= 1)
    ok = (det and rec["corrupts_fired"] >= 1 and rec["sdc_escaped"] == 0
          and rec["requests_lost"] == 0 and rec["streams_match"] is True)
    if target == "export":
        ok = ok and rec["sdc_wire_detected"] == 0 and [
            e["where"] for e in rec["sdc_events"]][:1] == ["export"]
    return ok


def quarantine_held(server) -> bool:
    """(c): every quarantined slot stayed out of use (off the free list
    and out of every page table), and each pool detection quarantined."""
    n_pool = sum(1 for e in server.sdc_events
                 if e["where"] not in ("wire", "recompute"))
    held = 0
    for eng in server.engines + server.retired:
        al = eng.allocator
        held += al.quarantined
        if al._quarantined & (set(al._free)
                              | set(eng.table.ravel().tolist())):
            return False
    return held >= n_pool


def flip_one_bit(torch, model, dev, kv):
    """(e): flip_pool_bit changes exactly one bit of the device bytes of
    the payload (and of the sidecar for int8), read back from the card."""
    import numpy as np

    from ddlbench_tpu_torch.config import ServeConfig
    from ddlbench_tpu_torch.serve import integrity
    from ddlbench_tpu_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, ServeConfig(
        max_batch=2, pool_pages=12, page=4, max_len=16, prefill_chunk=4,
        kv_dtype=kv, integrity=True), dev)
    li = integrity.pool_layers(eng)[0]
    bits = {}
    for key in ("pool_k",) + (("scale_k",) if kv == "int8" else ()):
        t = eng.pools[li][key]
        t.copy_(torch.randn(t.shape, device=dev).to(t.dtype))
        before = t.reshape(-1).view(torch.uint8).cpu().clone().numpy()
        integrity.flip_pool_bit(eng, li, 3, key=key, index=3, bit=6)
        after = t.reshape(-1).view(torch.uint8).cpu().clone().numpy()
        bits[key] = int(np.unpackbits(before ^ after).sum())
    return bits


def disagg_faults(model, dev, ctrl_int8):
    """Planted faults, each run on the card and each required to fail its
    check: an export that skips its verify (the prefill-side flip reaches
    the wire: (c)), a write_pages that drops the scale sidecars (int8
    streams leave the aggregated control: (b)) and a page_checksum that
    leaves out the sidecar keys (a sidecar flip escapes: (c))."""
    from ddlbench_tpu_torch.serve import engine, integrity

    eng_cls = engine.ServeEngine
    real_verify, real_write = eng_cls._verify_slot, eng_cls.write_pages
    real_checksum = integrity.page_checksum

    def export_skips_verify(self, slot, where, rep=None):
        return True if where == "export" else real_verify(self, slot,
                                                          where, rep)

    def write_drops_sidecars(self, slots, pages):
        return real_write(self, slots, [
            None if rows is None else
            {k: v for k, v in rows.items() if k.startswith("pool")}
            for rows in pages])

    def checksum_skips_sidecars(rows):
        return real_checksum({k: v for k, v in rows.items()
                              if not k.startswith("scale")})

    out = {}
    for name, patches, (tool, argv, kv), caught in (
            ("export_skips_verify",
             [(eng_cls, "_verify_slot", export_skips_verify)],
             ("servechaos", SDC_RUNS["export"], "float32"),
             lambda rec, toks: not sdc_caught(rec, "export")),
            ("write_drops_sidecars",
             [(eng_cls, "write_pages", write_drops_sidecars)],
             DISAGG_RUNS["i_bench_1_1"][:2] + ("int8",),
             lambda rec, toks: toks != ctrl_int8),
            ("checksum_skips_sidecars",
             [(engine, "page_checksum", checksum_skips_sidecars),
              (integrity, "page_checksum", checksum_skips_sidecars)],
             ("servechaos", SDC_RUNS["sidecar"], "int8"),
             lambda rec, toks: not sdc_caught(rec, "sidecar"))):
        originals = [(obj, attr, getattr(obj, attr))
                     for obj, attr, _ in patches]
        for obj, attr, fault in patches:
            setattr(obj, attr, fault)
        try:
            rec, _, toks, _ = fleet_run(model, dev, tool, argv, kv)
        finally:
            for obj, attr, original in originals:
                setattr(obj, attr, original)
        out[name] = "rejected" if caught(rec, toks) else "PASSED"
    return out


def phase_serve_disagg(torch, pd, dev):
    """Disaggregated serving and the SDC ledger on the card (phase 3e of
    the docstring): per pool type, checks (a)-(e); the planted faults;
    then 1 and 2 replicas against 1:1, and integrity off against --scrub
    0 and --scrub 4, warm, in turns."""
    import tempfile

    from ddlbench_tpu_torch.config import ServeConfig
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.serve.handoff import make_disaggregated

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cpu_model = get_model("transformer_s", "synthtext", seed=0)
    card_model = get_model("transformer_s", "synthtext", seed=0).to(dev)
    kernels = (pd.paged_attention, pd.paged_chunk_attention)
    checks, pools, ctrl_streams = {}, {}, {}
    for kv in ("float32", "int8"):
        for fn in kernels:
            fn.launches = fn.launches_int8 = fn.plain_launches = 0
        rows, forks, plain = {}, {}, 0
        runs = {}
        for name, (tool, argv, n_agg) in DISAGG_RUNS.items():
            rec, servers, toks, prompts = fleet_run(card_model, dev, tool,
                                                    argv, kv)
            # (b)'s control: the same traffic on the aggregated fleet of
            # P + D replicas
            ctrl_rec, _, ctrl, _ = fleet_run(
                card_model, dev, "servebench",
                DISAGG_BENCH + ["--replicas", str(n_agg)], kv)
            plain += rec["plain_launches"] + ctrl_rec["plain_launches"]
            runs[name] = (rec, servers, toks, ctrl, prompts)
            ok_b = (rec["requests_lost"] if "requests_lost" in rec
                    else rec["requests"] - rec["completed"]) == 0 \
                and len(toks) == rec["requests"] and toks == ctrl
            if tool == "servechaos":
                ok_b = ok_b and rec["streams_match"] is True
            checks[f"{kv}_{name}_b_no_loss_streams_bitwise"] = ok_b
            if toks != ctrl:
                forks[name] = fleet_forks(torch, card_model, dev, prompts,
                                          toks, ctrl)
            rows[name] = {k: rec[k] for k in DISAGG_ROW_KEYS if k in rec}
        ctrl_streams[kv] = runs["i_bench_1_1"][3]
        # (c): each target detected, quarantined for good, nothing escaped.
        # The payload flip's time is the first whose flip escapes without
        # the ledger; the float32 flip must escape (the reference's
        # disarmed twin is float32). int8 tries float32's time: a flip
        # there moves one element by 64 steps of its row's scale and may
        # move no argmax, so its escape is reported only
        t_flip = None
        for t in (PAYLOAD_TIMES if kv == "float32" else
                  (pools["float32"]["payload_flip_t"],)):
            argv = [a.format(t=t) for a in SDC_RUNS["payload"]]
            rec, _, _, _ = fleet_run(card_model, dev, "servechaos",
                                     argv + ["--no-detect"], kv)
            plain += rec["plain_launches"]
            if rec["corrupts_fired"] and rec["sdc_escaped"] >= 1:
                t_flip = t
                rows["payload_no_detect"] = {
                    k: rec[k] for k in DISAGG_ROW_KEYS if k in rec}
                break
        if kv == "float32":
            checks["float32_c_no_detect_escapes"] = t_flip is not None
        escaped = t_flip is not None
        t_flip = t_flip or pools.get("float32", {}).get(
            "payload_flip_t") or PAYLOAD_TIMES[0]
        for target in ("payload", "sidecar", "prefix", "ship",
                       "decode_pool", "export"):
            if target == "sidecar" and kv != "int8":
                continue
            argv = [a.format(t=t_flip) for a in SDC_RUNS[target]]
            rec, servers, _, _ = fleet_run(card_model, dev, "servechaos",
                                           argv, kv)
            plain += rec["plain_launches"]
            checks[f"{kv}_c_{target}_caught"] = sdc_caught(rec, target)
            checks[f"{kv}_c_{target}_quarantine_held"] = quarantine_held(
                servers["chaos"])
            rows[f"corrupt_{target}"] = {
                "corrupt": rec["corrupt"],
                "where": [e["where"] for e in rec["sdc_events"]],
                **{k: rec[k] for k in DISAGG_ROW_KEYS if k in rec}}
        # (d): clean traffic with the ledger armed
        for name, argv in SCRUB_RUNS.items():
            rec, servers, toks, _ = fleet_run(card_model, dev, "servebench",
                                              argv, kv)
            plain_rec, _, plain_toks, _ = fleet_run(
                card_model, dev, "servebench", without(argv, ("--scrub",)),
                kv)
            plain += rec["plain_launches"] + plain_rec["plain_launches"]
            where = [e["where"] for e in servers["chaos"].sdc_events]
            ok = (rec["sdc_detected"] == 0 and rec["sdc_scrubbed"] > 0
                  and "recompute" not in where and toks == plain_toks
                  and len(toks) == rec["requests"])
            if name == "bench_evicting":
                ok = ok and rec["sdc_recompute_checks"] > 0
            checks[f"{kv}_d_{name}_clean"] = ok
            rows[f"scrub_{name}"] = {k: rec[k] for k in DISAGG_ROW_KEYS
                                     if k in rec}
        launches = {
            "paged_attention": pd.paged_attention.launches,
            "paged_chunk_attention": pd.paged_chunk_attention.launches,
            "paged_attention_int8": pd.paged_attention.launches_int8,
            "paged_chunk_attention_int8":
                pd.paged_chunk_attention.launches_int8,
            "plain_launches": plain}
        mine, other = (("_int8", "") if kv == "int8" else ("", "_int8"))
        checks[f"{kv}_e_launches"] = (
            launches[f"paged_attention{mine}"] > 0
            and launches[f"paged_chunk_attention{mine}"] > 0
            and launches[f"paged_attention{other}"] == 0
            and launches[f"paged_chunk_attention{other}"] == 0
            and plain == 0
            and pd.paged_attention.plain_launches == 0
            and pd.paged_chunk_attention.plain_launches == 0)
        bits = flip_one_bit(torch, card_model, dev, kv)
        checks[f"{kv}_e_flip_one_bit"] = all(b == 1 for b in bits.values())
        cfg = ServeConfig(max_batch=2, pool_pages=12, page=4, max_len=16,
                          prefill_chunk=4, kv_dtype=kv)
        shared, grown, pool_bytes = fleet_memory(
            torch, card_model, dev, kv,
            build=lambda: make_disaggregated(card_model, cfg, dev, 2, 2))
        checks[f"{kv}_e_one_weight_copy"] = (
            shared and abs(grown - pool_bytes) <= MEMORY_RTOL * pool_bytes)
        # (a): each card row against the port's row on the CPU
        for name, (rec, servers, _, _, _) in runs.items():
            tool, argv, _ = DISAGG_RUNS[name]
            cpu_rec, cpu_servers, _, _ = fleet_run(cpu_model, cpu, tool,
                                                   argv, kv)
            diff = slo_row_diff(rec, cpu_rec)
            srv, cpu_srv = servers["chaos"], cpu_servers["chaos"]
            checks[f"{kv}_{name}_a_row_equals_cpu"] = not diff and all(
                getattr(srv, k) == getattr(cpu_srv, k) for k in (
                    "fail_events", "resize_events", "timed_out",
                    "shed_records"))
            if diff:
                rows[name]["row_diff_vs_cpu"] = diff
        pools[kv] = {"launches": launches, "rows": rows, "forks": forks,
                     "payload_flip_t": t_flip,
                     "payload_no_detect_escaped": escaped,
                     "flip_bits": bits,
                     "memory": {"allocated_bytes": grown,
                                "pool_bytes": pool_bytes}}
    f32 = pools["float32"]["rows"]["i_bench_1_1"]
    i8 = pools["int8"]["rows"]["i_bench_1_1"]
    checks["a_int8_ships_quarter_payload"] = (
        i8["shipped_pages"] == f32["shipped_pages"] > 0
        and 4 * i8["shipped_payload_bytes"] == f32["shipped_payload_bytes"])
    faults = disagg_faults(card_model, dev, ctrl_streams["int8"])
    # 1 and 2 replicas against 1:1, then integrity off against --scrub 0
    # and 4, on the card, warm, in turns: the serve_slo command greedy
    # over a float32 pool
    layouts = {"1": ["--replicas", "1"], "2": ["--replicas", "2"],
               "1:1": ["--disaggregate", "1:1"]}
    ledger = {"off": [], "scrub_0": ["--scrub", "0"],
              "scrub_4": ["--scrub", "4"]}
    turns = {"layout": {k: [] for k in layouts},
             "integrity": {k: [] for k in ledger}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_disagg_") as tmp:
        slo_run(card_model, dev, "float32", tmp, argv=SLO_GREEDY_ARGS)
        for group, opts, order in (
                ("layout", layouts, ("1", "2", "1:1", "1:1", "2", "1")),
                ("integrity", ledger, ("off", "scrub_0", "scrub_4",
                                       "scrub_4", "scrub_0", "off"))):
            for n in order:
                rec, server, _, _ = slo_run(card_model, dev, "float32", tmp,
                                            extra=opts[n],
                                            argv=SLO_GREEDY_ARGS)
                ledgers = [e.integrity for e in server.engines
                           + server.retired if e.integrity is not None]
                turns[group][n].append({
                    **{k: rec.get(k) for k in TURN_KEYS if k in rec},
                    "stamps_and_verifies": sum(g.stamps + g.verifies
                                               for g in ledgers)})
    emit({"phase": "serve_disagg",
          "runs": {k: [t, a] for k, (t, a, _) in DISAGG_RUNS.items()},
          "checks": checks, "planted_faults": faults, "pools": pools,
          "turns": {"card": card_line(), **turns},
          "seconds": time.perf_counter() - t0})
    failed = [k for k, ok in checks.items() if not ok]
    failed += [k for k, v in faults.items() if v != "rejected"]
    if failed:
        raise AssertionError(f"serve_disagg: failed {failed}")


# phase decode: models/decode.py at seq2seq_s's full width (d 512, 8 layers,
# 8 heads, dh 64, vocab 32 768, T 256, source 128), decodebench's defaults
DECODE_MODEL = ("seq2seq_s", "synthmt")
DECODE_B, DECODE_BEAM = 8, 4
# beam scores against their oracle's, relative: the paths sum in other
# orders (float32 noise), and a bfloat16 cache's oracle rounds K/V alike
DECODE_SCORE_RTOL = 1e-4
# the largest |logit| distance between a path and its oracle at a fork,
# teacher-forced on the shared prefix: float32 summation-order noise; a
# path farther off than this is wrong, not tied
DECODE_LOGIT_TOL = 1e-3
# (one timed call a row after the warm one: the script's time limit is
# shared with every later phase)
DECODE_BENCH_ARGS = ["--chunk-prefill", "--kv-dtype",
                     "float32,bfloat16,int8", "--repeats", "1"]
# (f): the engine's requests on transformer_s, prompt lengths and new
# tokens each
ORACLE_PROMPTS, ORACLE_NEW = (17, 64, 100, 33), 32
# B7 at the beam cache's last decode step: rows B x beam, npl, page
BEAM_SHAPE = (DECODE_B * DECODE_BEAM, 4, 64)


def path_logits(torch, dec, pd, model, toks, variant, dtype, S, T):
    """The float32 logits predicting position len(toks) after the prefix
    ``toks`` [n], one row alone through one decoding path, teacher-forced:
    ``full`` (one forward over the zero-padded stream), ``cached`` or
    ``paged`` (the prompt's prefill, then one decode step a token)."""
    x = toks[None].long()
    n = x.shape[1]
    with torch.no_grad():
        if variant == "full":
            pad = torch.zeros(1, T, dtype=torch.long, device=x.device)
            pad[:, :n] = x
            return model(pad)[0, n - 1].float()
        paged = variant == "paged"
        init = dec.init_paged_caches if paged else dec.init_caches
        caches = init(model, 1, T, dtype)
        logits, caches = (dec.paged_prefill if paged else dec.prefill)(
            model, caches, x[:, :S])
        for t in range(S, n):
            if paged:
                logits, caches = dec.paged_decode_one(
                    model, caches, x[:, t:t + 1], t, t // pd.PAGE + 1)
            else:
                logits, caches = dec.decode_one(model, caches,
                                                x[:, t:t + 1], t)
    return logits[0, -1].float()


def fork_evidence(torch, z_want, z_got, a, b):
    """Whether a fork (the oracle chose token a, the path b) is a near tie
    the paths' own numerics explain: the oracle's top-2 logit margin below
    the two paths' logit distance at that step — the distance measured on
    the gap that decides the choice, |(z_want[a] - z_want[b]) - (z_got[a]
    - z_got[b])| — and the path within DECODE_LOGIT_TOL of the oracle on
    every logit (a wrong path is far off, not tied)."""
    top2 = torch.topk(z_want, 2).values
    margin = (top2[0] - top2[1]).item()
    gap_want = (z_want[a] - z_want[b]).item()
    gap_got = (z_got[a] - z_got[b]).item()
    distance = abs(gap_want - gap_got)
    max_abs = (z_got - z_want).abs().max().item()
    return {"oracle_token": a, "path_token": b, "top2_margin": margin,
            "gap_oracle": gap_want, "gap_path": gap_got,
            "logit_distance": distance, "max_abs_logit_diff": max_abs,
            "accepted": margin < distance and max_abs <= DECODE_LOGIT_TOL}


def decode_forks(torch, got, want, logits_of):
    """Each row's first fork between ``got`` and ``want`` [rows, T], with
    its evidence: ``logits_of(prefix, side)`` gives the logits predicting
    the fork's position after the shared prefix, side "want" or "got"."""
    forks = {}
    for r in range(want.shape[0]):
        diff = (got[r] != want[r]).nonzero()
        if len(diff) == 0:
            continue
        i = int(diff[0])
        prefix = want[r, :i]
        ev = fork_evidence(torch, logits_of(prefix, "want"),
                           logits_of(prefix, "got"), int(want[r, i]),
                           int(got[r, i]))
        forks[r] = {"position": i, **ev}
    return forks


def held_to_oracle(torch, got, want, logits_of):
    """A decoding path's (tokens, beam scores or None) against its
    oracle's: each row's first fork (decode_forks), accepted only at a
    near tie, and the beam scores of the rows without a fork within
    DECODE_SCORE_RTOL. Returns the record, "ok" among its keys."""
    (got_x, got_s), (want_x, want_s) = got, want
    forks = decode_forks(torch, got_x, want_x, logits_of)
    rows = want_x.shape[0]
    rec = {"forks": forks, "tokens_equal_rows": rows - len(forks)}
    ok = all(f["accepted"] for f in forks.values())
    if got_s is not None:
        keep = [r for r in range(rows) if r not in forks]
        rel = ((got_s[keep] - want_s[keep]).abs()
               / want_s[keep].abs()).max().item() if keep else 0.0
        rec.update(score_max_rel=rel, score_rtol=DECODE_SCORE_RTOL)
        ok = ok and rel <= DECODE_SCORE_RTOL
    return {**rec, "ok": ok}


def beam_time(torch, pd, dev, dtype, flush, shape=BEAM_SHAPE):
    """B7 at a beam cache's last decode step (``shape``: rows, live pages,
    page; BEAM_SHAPE is seq2seq_s's: 32 rows, 4 live pages of 64,
    position 254 in every row, each row on its own slots): the kernel
    held against its plain version within TOL, then the kernel, the
    plain version and SDPA over the pre-gathered pages timed, with the
    bound."""
    rows, npl, page = shape
    gen = torch.Generator().manual_seed(4)
    cache = pd.paged_cache_init(rows, npl * page, H, DH, dtype, page=page,
                                device=dev)
    for name in ("pool_k", "pool_v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=gen))
    q = torch.randn(rows, H, DH, generator=gen).to(dev)
    pos = torch.full((rows,), npl * page - 2, dtype=torch.int32, device=dev)
    b_ms, b_by = bound(q, cache, pos, npl, None, page)
    err = (pd.paged_attention(q, cache, pos, npl, page)
           - pd._paged_attention_ref(q, cache, pos, npl, page)
           ).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"paged_attention at the beam shape {shape} "
                             f"over a {dtype} pool: max abs err {err} > "
                             f"{TOL}")
    time_ms(torch, lambda: pd.paged_attention(q, cache, pos, npl, page),
            flush)  # the first timed call reads high
    return {
        "max_abs_err": err, "tol": TOL,
        "ms": time_ms(torch, lambda: pd.paged_attention(q, cache, pos, npl,
                                                        page), flush),
        "plain_ms": time_ms(torch, lambda: pd._paged_attention_ref(
            q, cache, pos, npl, page), flush),
        "library_ms": time_ms(torch, library_call(torch, q, cache, pos, npl,
                                                  None, page), flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": {"rows": rows, "H": H, "dh": DH, "page": page, "npl": npl,
                  "pos": npl * page - 2, "pool": str(dtype).split(".")[-1]}}


def device_kernels(prof):
    """The device kernels a torch.profiler run recorded, and their summed
    device milliseconds."""
    kern = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    return kern, sum(e.self_device_time_total for e in kern) / 1e3


def decode_profile(torch, dec, model, src, T, beam):
    """Where a paged beam run's time goes (float32 cache, warm): the
    device's busy share of its wall time under torch.profiler, its
    launches, and the device time of the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        dec.beam_search_decode(model, src, T, beam=beam, paged=True)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern, busy_ms = device_kernels(prof)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms if kern else None,
            "device_busy_share": busy_ms / wall_ms if kern else None,
            "kernel_launches": sum(e.count for e in kern),
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def decode_bench_rows(torch):
    """decodebench at its defaults plus DECODE_BENCH_ARGS, in-process:
    (exit code, rows)."""
    import contextlib
    import io

    from ddlbench_tpu_torch.tools import decodebench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = decodebench.main(DECODE_BENCH_ARGS)
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    for row in rows:
        print(json.dumps(row), flush=True)
    return rc, rows


def serve_oracle(torch, dec, pd, dev):
    """(f): the engine's greedy streams on transformer_s (a float32 pool of
    16-position pages) against models/decode.py's paged greedy_decode
    (pages of 64) on each request's prompt; a fork must be a near tie
    (fork_evidence: the decode path's logits as the oracle, the serving
    path's, through serve_logits, as the other)."""
    from ddlbench_tpu_torch.config import ServeConfig
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.serve.engine import ServeEngine
    from ddlbench_tpu_torch.serve.workload import ServeRequest

    model = get_model("transformer_s", "synthtext", seed=0).to(dev)
    engine = ServeEngine(model, ServeConfig(), dev)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, model.num_classes, (n,), generator=gen)
               for n in ORACLE_PROMPTS]
    for rid, p in enumerate(prompts):
        engine.submit(ServeRequest(rid=rid, prompt=p.numpy().astype("int32"),
                                   max_new=ORACLE_NEW, arrival=0.0))
    clock = 0.0
    while engine.has_work():
        clock += engine.step(clock).cost
    got = {f["rid"]: f["tokens"] for f in engine.finished}
    T = model.in_shape[0]
    forks = {}
    for rid, p in enumerate(prompts):
        S = len(p)
        want = dec.greedy_decode(model, p[None].to(dev), S + ORACLE_NEW,
                                 paged=True)[0]
        stream = torch.tensor(p.tolist() + got[rid], device=dev)

        def logits_of(prefix, side, S=S):
            if side == "want":
                return path_logits(torch, dec, pd, model, prefix, "paged",
                                   torch.float32, S, T)
            with torch.no_grad():
                return serve_logits(torch, engine, prefix.tolist())[-1]

        fork = decode_forks(torch, stream[None], want[None], logits_of)
        if fork:
            forks[rid] = fork[0]
    return {"requests": len(prompts), "new_tokens": ORACLE_NEW,
            "prompt_lens": list(ORACLE_PROMPTS), "forks": forks,
            "ok": len(got) == len(prompts)
            and all(f["accepted"] for f in forks.values())}


def phase_decode(torch, pd, fa, dev):
    """KV-cached greedy and beam decoding on the card (phase 3f of the
    docstring): (a) paths against their oracles, (b) launches, (c) B7 at
    the beam shape, (d) decodebench, (e) mtacc, (f) the serving oracle.
    Returns B7's launches over (a)'s paged runs."""
    from ddlbench_tpu_torch.config import DATASETS
    from ddlbench_tpu_torch.models import decode as dec
    from ddlbench_tpu_torch.models import seq2seq as s2s
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.tools import mtacc

    t0 = time.perf_counter()
    arch, bench = DECODE_MODEL
    spec = DATASETS[bench]
    T, S, B, beam = spec.seq_len, spec.src_len, DECODE_B, DECODE_BEAM
    model = get_model(arch, bench, seed=0).to(dev)
    src = torch.randint(0, spec.num_classes, (B, S),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    f32, bf16 = torch.float32, torch.bfloat16

    def zero():
        pd.paged_attention.launches = pd.paged_attention.plain_launches = 0
        fa.flash_fwd.launches = fa.flash_attention.plain_launches = 0

    def counts():
        return {"paged_attention": pd.paged_attention.launches,
                "flash_fwd": fa.flash_fwd.launches,
                "plain": pd.paged_attention.plain_launches
                + fa.flash_attention.plain_launches}

    # name -> (mode, variant, cache dtype, oracle run)
    runs = {
        "full_greedy": ("greedy", "full", f32, None),
        "full_beam": ("beam", "full", f32, None),
        "cached_greedy": ("greedy", "cached", f32, "full_greedy"),
        "cached_beam": ("beam", "cached", f32, "full_beam"),
        "paged_greedy": ("greedy", "paged", f32, "full_greedy"),
        "paged_beam": ("beam", "paged", f32, "full_beam"),
        # a bfloat16 cache's oracle is the dense cache in bfloat16: the
        # same rounding of every cached K/V, the plain attention
        "cached_greedy_bf16": ("greedy", "cached", bf16, None),
        "cached_beam_bf16": ("beam", "cached", bf16, None),
        "paged_greedy_bf16": ("greedy", "paged", bf16, "cached_greedy_bf16"),
        "paged_beam_bf16": ("beam", "paged", bf16, "cached_beam_bf16"),
    }
    out, launches, seconds = {}, {}, {}
    for name, (mode, variant, dtype, _) in runs.items():
        zero()
        tr = time.perf_counter()
        if variant == "full":
            res = (s2s.greedy_decode(model, src, T, use_cache=False)
                   if mode == "greedy" else s2s.beam_search_decode(
                       model, src, T, beam=beam, use_cache=False))
        elif mode == "greedy":
            res = dec.greedy_decode(model, src, T, dtype=dtype,
                                    paged=variant == "paged")
        else:
            res = dec.beam_search_decode(model, src, T, beam=beam,
                                         dtype=dtype,
                                         paged=variant == "paged")
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - tr
        launches[name] = counts()
        out[name] = res if mode == "beam" else (res, None)

    # (a) each path against its oracle: tokens equal but for near-tie
    # forks; beam scores of the rows without a fork within the rtol
    checks, compared = {}, {}
    for name, (mode, variant, dtype, oracle) in runs.items():
        if oracle is None:
            continue
        o_variant, o_dtype = runs[oracle][1], runs[oracle][2]

        def logits_of(prefix, side, variant=variant, dtype=dtype,
                      o_variant=o_variant, o_dtype=o_dtype):
            v, d = (o_variant, o_dtype) if side == "want" else (variant,
                                                                  dtype)
            return path_logits(torch, dec, pd, model, prefix, v, d, S, T)

        compared[name] = {"oracle": oracle, **held_to_oracle(
            torch, out[name], out[oracle], logits_of)}
    checks["a_paths_against_oracles"] = all(r["ok"] for r in
                                            compared.values())
    # the bfloat16 cache's distance from the float32 loops: reported only
    bf16_vs_f32 = {
        name: {"tokens_equal_frac": (out[name][0] == out[ref][0]).float()
               .mean().item()}
        for name, ref in (("paged_greedy_bf16", "full_greedy"),
                          ("paged_beam_bf16", "full_beam"))}
    bf16_vs_f32["paged_beam_bf16"]["score_max_rel"] = (
        (out["paged_beam_bf16"][1] - out["full_beam"][1]).abs()
        / out["full_beam"][1].abs()).max().item()

    # (b) launches: a paged run B7 once a layer a decode step (positions
    # S .. T - 2), B1 once a layer (the prompt's prefill); no plain call
    want_b7, want_b1 = (T - 1 - S) * LAYERS, LAYERS
    checks["b_launches"] = all(
        launches[n]["plain"] == 0 for n in runs) and all(
        launches[n]["paged_attention"] == (want_b7 if runs[n][1] == "paged"
                                           else 0)
        and launches[n]["flash_fwd"] == want_b1
        for n in runs if runs[n][1] != "full")
    b7 = sum(launches[n]["paged_attention"] for n in runs)
    del out
    torch.cuda.empty_cache()
    profile = decode_profile(torch, dec, model, src, T, beam)

    # (c) B7 at the beam shape
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    times = {str(d).split(".")[-1]: beam_time(torch, pd, dev, d, flush)
             for d in (f32, bf16)}
    del flush, model
    torch.cuda.empty_cache()

    # (d) decodebench on the card, its launches counted apart
    kernels = (pd.paged_attention, pd.paged_chunk_attention)
    for fn in kernels:
        fn.launches = fn.launches_int8 = fn.plain_launches = 0
    rc, rows = decode_bench_rows(torch)
    bench_launches = {f"{fn.__name__}{sfx}": getattr(fn, "launches" + sfx)
                      for fn in kernels for sfx in ("", "_int8")}
    kinds = {"decode": sum("mode" in r for r in rows),
             "chunk": sum(r["variant"].startswith("chunk-") for r in rows),
             "kv_dtype": sum(r["variant"] == "kv-dtype" for r in rows)}
    checks["d_decodebench"] = (
        rc == 0 and kinds == {"decode": 6, "chunk": 8, "kv_dtype": 12}
        and not any("error" in r or "skipped" in r for r in rows)
        and all(r.get("plain_launches", 0) == 0 for r in rows)
        and all(n > 0 for n in bench_launches.values())
        and not any(fn.plain_launches for fn in kernels))

    # (e) mtacc on the card
    doc = mtacc.run(mtacc.build_parser().parse_args([]), dev)
    checks["e_mtacc"] = bool(doc["pass"])

    # (f) the serving oracle on transformer_s
    oracle = serve_oracle(torch, dec, pd, dev)
    checks["f_serve_oracle"] = oracle["ok"]

    emit({"phase": "decode", "model": arch, "benchmark": bench, "batch": B,
          "beam": beam, "total_len": T, "prompt_len": S, "checks": checks,
          "compared": compared, "bf16_vs_float32_loops": bf16_vs_f32,
          "launches": launches,
          "expected_paged": {"paged_attention": want_b7, "flash_fwd": want_b1,
                             "plain": 0},
          "run_seconds": seconds, "paged_beam_profile": profile,
          "b7_beam_shape": times,
          "decodebench": {"rc": rc, "rows": kinds,
                          "launches": bench_launches},
          "mtacc": {k: doc[k] for k in ("seq_accuracy", "token_accuracy",
                                        "final_loss", "train_steps",
                                        "greedy_equals_full_forward",
                                        "pass")},
          "serve_oracle": oracle, "card": card_line(),
          "seconds": time.perf_counter() - t0})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"decode: failed {failed}")
    return b7


def phase_profile(torch, dev):
    """Where a serving run's time goes: the same main path (warm kernels,
    8 requests) under torch.profiler — device time by kernel name, each
    paged kernel instance's calls and device ms, and the device's busy
    share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.tools import servebench

    args = servebench.build_parser().parse_args([
        "-m", "transformer_s", "-b", "synthtext", "--policies", "continuous",
        "--arrival", "closed", "--requests", "8", "--seed", "1",
        "--wall-clock"])
    model = get_model(args.model, args.benchmark, seed=args.seed).to(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (rec, server, _), = servebench.run(args, model, dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern, busy_ms = device_kernels(prof)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    paged = {}  # each paged kernel instance, as the profiler names it
    for e in kern:
        name = next((k for k in PAGED_BUILT if k in e.key), None)
        if name:
            name += e.key[e.key.index(name) + len(name):].split("(")[0]
            rec = paged.setdefault(name, {"calls": 0, "ms": 0.0})
            rec["calls"] += e.count
            rec["ms"] += e.self_device_time_total / 1e3
    st = server.engines[0].stats
    emit({"phase": "profile", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if kern else None,
          "device_busy_share": busy_ms / wall_ms if kern else None,
          "decode_calls": st["decode_calls"],
          "prefill_calls": st["prefill_calls"],
          "kernel_launches": sum(e.count for e in kern),
          "paged_kernels": paged,
          "top_kernels": [{"name": e.key[:80], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3}
                          for e in top]})


def row_rel_err(got, want) -> float:
    """Worst row's L2 error over its L2 norm (a row: one query's or key's
    dh values). A row whose norm is under 1e-3 of the mean row norm is
    measured against that floor: a fully masked query, or a key no query
    sees, is 0 in both."""
    d = (got.float() - want.float()).norm(dim=-1)
    r = want.float().norm(dim=-1)
    floor = max(1e-3 * r.mean().item(), 1e-30)
    return (d / r.clamp(min=floor)).max().item()


def flash_errs(torch, outs, lse_err=None):
    """{max_abs_err, row_rel_err, ok} of a kernel's outputs against their
    plain versions, ``outs`` a tuple of (got, want) pairs; the lse error,
    where given, counts in the max abs error."""
    errs = [] if lse_err is None else [lse_err]
    rel = 0.0
    for got, want in outs:
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{got.dtype} {tuple(got.shape)} vs "
                                 f"{want.dtype} {tuple(want.shape)}")
        errs.append((got.float() - want.float()).abs().max().item())
        rel = max(rel, row_rel_err(got, want))
    abs_err = max(errs)
    if outs[0][0].dtype == torch.float32:
        ok = abs_err <= FLASH_TOL
    else:
        ok = (rel <= BF16_ROW_RTOL
              and (lse_err is None or lse_err <= FLASH_TOL))
    finite = math.isfinite(abs_err) and math.isfinite(rel)
    return {"max_abs_err": abs_err if finite else math.inf,
            "row_rel_err": rel if finite else math.inf, "ok": ok and finite}


def flash_inputs(torch, gen, dev, dtype, B, H, Tq, Tk):
    q, do = (torch.randn(B, H, Tq, DH, generator=gen).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(B, H, Tk, DH, generator=gen).to(dev, dtype)
            for _ in range(2))
    return q, k, v, do


def flash_compare(torch, fa, q, k, v, do, qo, ko, pre, fwd=None):
    """{kernel: flash_errs(...)} of the three kernels against their plain
    versions on (q, k, v, do); the backward pair runs on the plain
    forward's lse and delta. ``fwd`` is the kernel forward's (o, lse) when
    the caller ran it already (the longctx check). Also returns the
    kernels' outputs and the plain lse and delta."""
    o_ref, lse_ref = fa._flash_fwd_ref(q, k, v, qo, ko, pre)
    o, lse = fwd or fa.flash_fwd(q, k, v, qo, ko, pre)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, lse_ref, delta, qo, ko, pre)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, qo, ko, pre)
    dq_ref = fa._flash_dq_ref(q, k, v, do, lse_ref, delta, qo, ko, pre)
    dk_ref, dv_ref = fa._flash_dkv_ref(q, k, v, do, lse_ref, delta, qo, ko,
                                       pre)
    torch.cuda.synchronize()
    seen = lse_ref > -1e29  # rows that see at least one key
    if not bool((lse[~seen] < -1e29).all()):
        raise AssertionError("flash_fwd: a fully masked row's lse is not "
                             "~-1e30")
    lse_err = (lse - lse_ref)[seen].abs().max().item() if seen.any() else 0.
    out = {"flash_fwd": flash_errs(torch, ((o, o_ref),), lse_err),
           "flash_dq": flash_errs(torch, ((dq, dq_ref),)),
           "flash_dkv": flash_errs(torch, ((dk, dk_ref), (dv, dv_ref)))}
    return out, (o, dq, dk, dv), (lse_ref, delta)


def planted_faults(torch, fa, q, k, v, do, outs, lse_ref, delta, n=8):
    """The bfloat16 check must reject the kernels' causal outputs held
    against plain versions with a tail fault: the last ``n`` keys dropped
    (forward, dQ; the last queries' rows change) or the last ``n`` queries
    (dK/dV); and one aimed at dQ's split of a 128-query item between two
    warpgroups: the second warpgroup's 64 rows (queries 64-127) zeroed.
    Returns what the check says of each, and what a bound scaled by the
    tensor's largest value says (2e-2 x max(1, max |plain|) on the max abs
    error), which a fault confined to a few rows can pass."""
    o, dq, dk, dv = outs
    k_cut, v_cut = k[:, :, :-n], v[:, :, :-n]
    o_bad, _ = fa._flash_fwd_ref(q, k_cut, v_cut)
    dq_bad = fa._flash_dq_ref(q, k_cut, v_cut, do, lse_ref, delta)
    dk_bad, dv_bad = fa._flash_dkv_ref(q[:, :, :-n], k, v, do[:, :, :-n],
                                       lse_ref[..., :-n], delta[..., :-n])
    dq_half = fa._flash_dq_ref(q, k, v, do, lse_ref, delta)
    dq_half[:, :, 64:128] = 0
    verdicts = {}
    for name, pairs in (("flash_fwd", ((o, o_bad),)),
                        ("flash_dq", ((dq, dq_bad),)),
                        ("flash_dq_second_warpgroup_zeroed",
                         ((dq, dq_half),)),
                        ("flash_dkv", ((dk, dk_bad), (dv, dv_bad)))):
        e = flash_errs(torch, pairs)
        scaled = all((g.float() - w.float()).abs().max().item()
                     <= 2e-2 * max(1.0, w.float().abs().max().item())
                     for g, w in pairs)
        verdicts[name] = {"row_rel_err": e["row_rel_err"],
                          "rejected": not e["ok"],
                          "max_scaled_bound_accepts": scaled}
        if e["ok"]:
            raise AssertionError(f"{name}: the bfloat16 check accepts a "
                                 f"planted tail fault ({e})")
    return verdicts


def flash_rerun_bitwise(torch, fa, q, k, v, do, lse_ref, delta, dq):
    """dQ run again on the same inputs must give the same bits (no
    atomics); raises if not."""
    again = fa.flash_dq(q, k, v, do, lse_ref, delta)
    torch.cuda.synchronize()
    same = {"flash_dq": bool(torch.equal(again, dq))}
    if not all(same.values()):
        raise AssertionError(f"a rerun changed the bits: {same}")
    return same


def phase_flash_kernels(torch, fa, dev):
    gen = torch.Generator().manual_seed(1)
    worst = {name: 0.0 for name in FLASH_KERNELS}
    checks, faults, reruns = [], None, None

    def record(case, dtype, errs):
        for name, e in errs.items():
            checks.append({"kernel": name, "case": case,
                           "dtype": str(dtype).split(".")[-1], **e})
            if not e["ok"]:
                raise AssertionError(f"{name} {case} {dtype}: {e} (float32 "
                                     f"max abs {FLASH_TOL}; bfloat16 row "
                                     f"{BF16_ROW_RTOL}, lse {FLASH_TOL})")
            if dtype == torch.bfloat16:
                worst[name] = max(worst[name], e["max_abs_err"])

    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            B, Hh, Tq, Tk, qo, ko, pre = case
            q, k, v, do = flash_inputs(torch, gen, dev, dtype, B, Hh, Tq, Tk)
            errs, outs, (lse_ref, delta) = flash_compare(
                torch, fa, q, k, v, do, qo, ko, pre)
            record(list(case), dtype, errs)
            if dtype == torch.bfloat16 and case == (2, 8, 1000, 1000, 0, 0,
                                                    0):
                faults = planted_faults(torch, fa, q, k, v, do, outs,
                                        lse_ref, delta)
            if dtype == torch.bfloat16 and case == FLASH_CASES[0]:
                reruns = flash_rerun_bitwise(torch, fa, q, k, v, do, lse_ref,
                                             delta, outs[1])
            del q, k, v, do, outs, lse_ref, delta
    torch.cuda.empty_cache()
    # longctx32k: the kernel forward over the whole sequence, its last
    # LONG_Q rows held against the plain version of those queries; the
    # backward kernels on that query block (the plain path cannot hold a
    # 32k x 32k score tensor)
    dtype = torch.bfloat16
    q, k, v, do = flash_inputs(torch, gen, dev, dtype, 1, H, LONG_T, LONG_T)
    o, lse = fa.flash_fwd(q, k, v)
    qo = LONG_T - LONG_Q
    tail = (o[:, :, qo:], lse[:, :, qo:])
    errs, _, _ = flash_compare(torch, fa, q[:, :, qo:].contiguous(), k, v,
                               do[:, :, qo:].contiguous(), qo, 0, 0,
                               fwd=tail)
    record(["longctx32k", 1, H, LONG_T, LONG_T, qo, 0, 0], dtype, errs)
    emit({"phase": "flash_kernels", "float32_max_abs_tol": FLASH_TOL,
          "bfloat16_row_rel_tol": BF16_ROW_RTOL, "checks": checks,
          "planted_faults": faults, "reruns_bitwise_equal": reruns})
    return worst


def flash_bound(name, B, Hh, T, dtype_bytes):
    """(bound_ms, bound_by) of one causal call at [B, H, T, 64]: each
    input read once and each output written once over the memory rate;
    the flops of the visible (query, key) pairs over the bf16 peak."""
    pairs = B * Hh * T * (T + 1) // 2
    tile = B * Hh * T * DH * dtype_bytes  # one [B, H, T, dh] tensor
    rows = B * Hh * T * 4  # one float32 [B, H, T] tensor (lse, delta)
    nbytes = {"flash_fwd": 3 * tile + tile + rows,
              "flash_dq": 4 * tile + 2 * rows + tile,
              "flash_dkv": 4 * tile + 2 * rows + 2 * tile}[name]
    flops = FLASH_FLOPS_PER_PAIR[name] * DH * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash_times(torch, fa, dev):
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator().manual_seed(2)
    times = {}
    for B, T in ((16, 1024), (2, 8192)):
        q, k, v, do = flash_inputs(torch, gen, dev, torch.bfloat16, B, H, T,
                                   T)
        o, lse = fa.flash_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), flush)
        runs = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v),
                          lambda: fa._flash_fwd_ref(q, k, v),
                          time_ms(torch, lambda: F.scaled_dot_product_attention(
                              q, k, v, is_causal=True), flush)),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta),
                         lambda: fa._flash_dq_ref(q, k, v, do, lse, delta),
                         lib_bwd),
            "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta),
                          lambda: fa._flash_dkv_ref(q, k, v, do, lse, delta),
                          lib_bwd),
        }
        for name, (kern, plain, lib_ms) in runs.items():
            b_ms, b_by = flash_bound(name, B, H, T, 2)
            times.setdefault(name, []).append({
                "B": B, "H": H, "T": T, "dh": DH, "dtype": "bfloat16",
                "ms": time_ms(torch, kern, flush),
                "plain_ms": time_ms(torch, plain, flush, iters=5, warmup=1),
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
        del out, qg, kg, vg
        torch.cuda.empty_cache()
    emit({"phase": "flash_times", "times": times,
          "library_note": "library_ms of flash_dq and flash_dkv is the "
                          "backward of scaled_dot_product_attention, which "
                          "computes dQ, dK and dV together"})
    return {name: rows[0] for name, rows in times.items()}


def fx_inputs(torch, gen, dev, dtype, N, D, V, masking, zero_head=False):
    """h [N, D], W [D, V] (scaled so the logits have unit-order spread) and
    int64 labels [N] with the case's masking."""
    h = torch.randn(N, D, generator=gen).to(dev, dtype)
    w = (torch.randn(D, V, generator=gen) * D ** -0.5).to(dev, dtype)
    if zero_head:
        w.zero_()
    labels = torch.randint(0, V, (N,), generator=gen)
    if masking == "every5":
        labels[::5] = -1
        labels[1::7] = 0  # label-0 rows for the zero-head case
    elif masking == "synthmt":
        labels[torch.arange(N) % 256 < 127] = -1
    elif masking == "all":
        labels[:] = -1
    return h, w, labels.to(dev)


def fx_coef(torch, smoothing, V, dev):
    """(c_p, c_oh, c_sm) of the backward for the cotangents FX_COT."""
    go, gce = FX_COT
    return torch.tensor([go + gce, go * (1 - smoothing) + gce,
                         go * smoothing / V], device=dev)


def col_rel_err(got, want) -> float:
    """row_rel_err over columns (one vocab entry's D values of dW)."""
    return row_rel_err(got.T, want.T)


def argmax_near_ties(torch, h, w, got, want):
    """(mismatches, mismatches not at a near-tie): rows whose argmaxes
    differ, and of those the rows whose two chosen logits (float32, plain)
    are more than FX_TIE apart."""
    rows = (got != want).nonzero()[:, 0]
    if rows.numel() == 0:
        return 0, 0
    z = h[rows].float() @ w.float()
    gap = (z.gather(1, got[rows].long()[:, None])
           - z.gather(1, want[rows].long()[:, None])).abs()[:, 0]
    return rows.numel(), int((gap > FX_TIE).sum())


def zsum_over_tol(torch, fx, h, w, zsum, zsum_ref) -> float:
    """The worst row's zsum error over its tolerance, FX_ZSUM_RTOL times
    (1 + the row's sum of |z|, float32 plain): above 1 fails."""
    scale = torch.cat([fx._logits(h[i:i + fx.ROW_CHUNK], w).abs().sum(-1)
                       for i in range(0, h.shape[0], fx.ROW_CHUNK)])
    return ((zsum - zsum_ref).abs() / (FX_ZSUM_RTOL * (scale + 1))
            ).max().item()


def fx_compare(torch, fx, h, w, labels, smoothing, coef):
    """{kernel: {max_abs_err, ..., ok}} of the three fused-head kernels
    against their plain versions (the backward pair on the plain lse), and
    the kernels' and plain outputs. The forward is held row by row on lse,
    gold and zsum in both types."""
    V = w.shape[1]
    got = fx.fxent_fwd(h, w, labels)
    want = fx._fxent_fwd_ref(h, w, labels)
    lse = want[0]
    dh = fx.fxent_dh(h, w, labels, lse, coef)
    dw = fx.fxent_dw(h, w, labels, lse, coef)
    dh_ref = fx._fxent_dh_ref(h, w, labels, lse, coef)
    dw_ref = fx._fxent_dw_ref(h, w, labels, lse, coef)
    torch.cuda.synchronize()
    f32 = h.dtype == torch.float32
    sums = fx.loss_sums(*got, labels, smoothing, V)
    sums_ref = fx.loss_sums(*want, labels, smoothing, V)
    sum_err = max(abs(a.item() - b.item()) / max(abs(b.item()), 1e-30)
                  for a, b in zip(sums[:2], sums_ref[:2]))
    lse_err = (got[0] - want[0]).abs().max().item()
    gold_err = (got[1] - want[1]).abs().max().item()
    zsum_err = (got[2] - want[2]).abs().max().item()
    zsum_ratio = zsum_over_tol(torch, fx, h, w, got[2], want[2])
    n_mis, n_far = argmax_near_ties(torch, h, w, got[3], want[3])
    fwd = {"max_abs_err": lse_err, "gold_max_abs_err": gold_err,
           "zsum_max_abs_err": zsum_err, "zsum_err_over_tol": zsum_ratio,
           "sum_rel_err": sum_err,
           "correct": int(sums[2]), "correct_plain": int(sums_ref[2]),
           "argmax_mismatches": n_mis, "argmax_mismatches_not_near_tie":
           n_far}
    fwd["ok"] = (lse_err <= FX_TOL and gold_err <= FX_TOL
                 and zsum_ratio <= 1.0
                 and (sum_err <= FX_SUM_RTOL and n_mis == 0 if f32
                      else n_far == 0))
    out = {"fxent_fwd": fwd}
    for name, a, b, rel in (("fxent_dh", dh, dh_ref, row_rel_err),
                            ("fxent_dw", dw, dw_ref, col_rel_err)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: {a.dtype} {tuple(a.shape)} vs "
                                 f"{b.dtype} {tuple(b.shape)}")
        err = (a.float() - b.float()).abs().max().item()
        r = rel(a, b)
        ok = err <= FX_TOL if f32 else r <= BF16_ROW_RTOL
        finite = math.isfinite(err) and math.isfinite(r)
        out[name] = {"max_abs_err": err if finite else math.inf,
                     "rel_err": r if finite else math.inf,
                     "ok": ok and finite}
    return out, (got, dh, dw), (want, dh_ref, dw_ref)


def fx_unmasked_plain(torch, fx, h, w, labels, lse, coef, dh_ref, dw_ref):
    """The plain dh and dW with the label mask dropped: masked rows take
    dz = c_p p - c_sm (no label matches) instead of 0. Their part is the
    plain versions' on those rows with label 0 and no one-hot term, put in
    dh's rows and added to dW."""
    rows = labels < 0
    part = (h[rows], w, torch.zeros_like(labels[rows]), lse[rows],
            coef * torch.tensor([1.0, 0.0, 1.0], device=coef.device))
    dh = dh_ref.clone()
    dh[rows] = fx._fxent_dh_ref(*part)
    dw = (dw_ref.float() + fx._fxent_dw_ref(*part).float()).to(w.dtype)
    return dh, dw


def fx_planted_faults(torch, fx, h, w, labels, coef, outs, refs):
    """The bfloat16 check must reject the kernels' outputs held against
    plain versions with planted faults: the last vocab tile (64 columns)
    skipped (forward: its lse and zsum; dh), gold read from the next
    column, the label mask dropped (dh, dW), and three aimed at the wgmma
    designs' split of the work: the forward's odd 64-column vocab tiles
    dropped (one warpgroup's share), the last D half of dh dropped (one
    warpgroup's output chunks), and the last row tile of dW skipped.
    Returns what the check says of each."""
    got, dh, dw = outs
    want, dh_ref, dw_ref = refs
    V = w.shape[1]
    lse = want[0]
    lse_cut, _, zsum_cut, _ = fx._fxent_fwd_ref(
        h, w[:, :V - 64].contiguous(), torch.full_like(labels, -1))
    gold_next = fx._fxent_fwd_ref(
        h, w, torch.where(labels >= 0, (labels + 1) % V, labels))[1]
    w_tail0 = w.clone()
    w_tail0[:, V - 64:] = 0  # z of the last tile contributes nothing to dh
    dh_cut = fx._fxent_dh_ref(h, w_tail0, labels, lse, coef)
    dh_nomask, dw_nomask = fx_unmasked_plain(torch, fx, h, w, labels, lse,
                                             coef, dh_ref, dw_ref)
    dh_half = dh_ref.clone()
    dh_half[:, h.shape[1] // 2:] = 0
    n_cut = (h.shape[0] - 1) // 64 * 64  # the rows before the last tile
    dw_cut = fx._fxent_dw_ref(h[:n_cut], w, labels[:n_cut], lse[:n_cut],
                              coef)
    even = (torch.arange(V, device=w.device) // 64) % 2 == 0
    lse_even = fx._fxent_fwd_ref(h, w[:, even].contiguous(),
                                 torch.full_like(labels, -1))[0]
    torch.cuda.synchronize()
    checks = {
        "fxent_fwd_last_tile_skipped":
            ("lse_abs_err", (got[0] - lse_cut).abs().max().item(), FX_TOL),
        "fxent_fwd_zsum_last_tile_skipped":
            ("zsum_err_over_tol",
             zsum_over_tol(torch, fx, h, w, got[2], zsum_cut), 1.0),
        "fxent_fwd_odd_vocab_tiles_dropped":
            ("lse_abs_err", (got[0] - lse_even).abs().max().item(), FX_TOL),
        "fxent_fwd_gold_next_column":
            ("gold_abs_err", (got[1] - gold_next).abs().max().item(),
             FX_TOL),
        "fxent_dh_last_tile_skipped":
            ("row_rel_err", row_rel_err(dh, dh_cut), BF16_ROW_RTOL),
        "fxent_dh_mask_dropped":
            ("row_rel_err", row_rel_err(dh, dh_nomask), BF16_ROW_RTOL),
        "fxent_dw_mask_dropped":
            ("col_rel_err", col_rel_err(dw, dw_nomask), BF16_ROW_RTOL),
        "fxent_dh_last_d_half_dropped":
            ("row_rel_err", row_rel_err(dh, dh_half), BF16_ROW_RTOL),
        "fxent_dw_last_row_tile_skipped":
            ("col_rel_err", col_rel_err(dw, dw_cut), BF16_ROW_RTOL),
    }
    verdicts = {}
    for name, (what, err, tol) in checks.items():
        verdicts[name] = {what: err, "tol": tol, "rejected": not err <= tol}
        if err <= tol:
            raise AssertionError(f"{name}: the check accepts a planted "
                                 f"fault ({what} {err} <= {tol})")
    return verdicts


def fx_rerun_bitwise(torch, fx, h, w, labels, lse, coef, outs):
    """The forward's four outputs, dh and dW run again on the same inputs
    must give the same bits (no atomics); raises if not."""
    fwd = fx.fxent_fwd(h, w, labels)
    dh = fx.fxent_dh(h, w, labels, lse, coef)
    dw = fx.fxent_dw(h, w, labels, lse, coef)
    torch.cuda.synchronize()
    same = {f"fxent_fwd_{name}": bool(torch.equal(a, b))
            for name, a, b in zip(("lse", "gold", "zsum", "argmax"), fwd,
                                  outs[0])}
    same.update({"fxent_dh": bool(torch.equal(dh, outs[1])),
                 "fxent_dw": bool(torch.equal(dw, outs[2]))})
    if not all(same.values()):
        raise AssertionError(f"a rerun changed the bits: {same}")
    return same


def phase_fxent_kernels(torch, fx, dev):
    gen = torch.Generator().manual_seed(3)
    worst = {name: 0.0 for name in FX_KERNELS}
    checks, faults, reruns = [], None, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case, N, D, V, s, masking in FX_CASES:
            h, w, labels = fx_inputs(torch, gen, dev, dtype, N, D, V, masking,
                                     zero_head=case == "zero_head")
            coef = fx_coef(torch, s, V, dev)
            errs, outs, refs = fx_compare(torch, fx, h, w, labels, s, coef)
            valid = int((labels >= 0).sum())
            if case == "all_masked":
                zeros = (int(torch.count_nonzero(outs[1])) == 0
                         and int(torch.count_nonzero(outs[2])) == 0)
                sums = [t.item() for t in fx.loss_sums(*outs[0], labels, s,
                                                       V)]
                errs["fxent_fwd"]["ok"] &= sums == [0.0, 0.0, 0]
                errs["fxent_dh"]["ok"] &= zeros
                errs["fxent_dw"]["ok"] &= zeros
            if case == "zero_head":
                want = int(((labels == 0)).sum())
                errs["fxent_fwd"]["ok"] &= (
                    errs["fxent_fwd"]["correct"] == want > 0)
            for name, e in errs.items():
                checks.append({"kernel": name, "case": case, "N": N, "D": D,
                               "V": V, "smoothing": s, "valid_rows": valid,
                               "dtype": dname, **e})
                if not e["ok"]:
                    raise AssertionError(
                        f"{name} {case} {dname}: {e} (lse and gold "
                        f"{FX_TOL}, zsum {FX_ZSUM_RTOL} of 1 + sum |z|; "
                        f"float32 sums rtol {FX_SUM_RTOL}, dh/dW {FX_TOL}; "
                        f"bfloat16 rows/columns {BF16_ROW_RTOL})")
                if dtype == torch.bfloat16:
                    worst[name] = max(worst[name], e["max_abs_err"])
            if dtype == torch.bfloat16 and case == "synthmt":
                faults = fx_planted_faults(torch, fx, h, w, labels, coef,
                                           outs, refs)
            if dtype == torch.bfloat16 and case in ("synthmt", "wide"):
                reruns[case] = fx_rerun_bitwise(torch, fx, h, w, labels,
                                                refs[0][0], coef, outs)
            del h, w, labels, outs, refs
    torch.cuda.empty_cache()
    emit({"phase": "fxent_kernels", "float32_sum_rtol": FX_SUM_RTOL,
          "float32_max_abs_tol": FX_TOL, "lse_tol": FX_TOL,
          "gold_tol": FX_TOL, "zsum_rtol_of_abs_sum": FX_ZSUM_RTOL,
          "bfloat16_rel_tol": BF16_ROW_RTOL, "near_tie": FX_TIE,
          "cotangents": FX_COT, "checks": checks, "planted_faults": faults,
          "reruns_bitwise_equal": reruns})
    return worst


def fx_bound(name, N, D, V, elt):
    """(bound_ms, bound_by) of one fused-head call at [N, D] x [D, V]:
    each input read once and each output written once (labels int64, the
    per-row outputs and lse float32) over the memory rate; the flops over
    the bf16 peak."""
    nbytes = (N * D + D * V) * elt + N * 8
    nbytes += {"fxent_fwd": 4 * N * 4, "fxent_dh": N * 4 + 12 + N * D * elt,
               "fxent_dw": N * 4 + 12 + D * V * elt}[name]
    flops = FX_FLOPS_PER_NDV[name] * N * D * V
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_fxent_times(torch, fx, dev):
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator().manual_seed(4)
    N, D, V = FX_HEAD
    h, w, labels = fx_inputs(torch, gen, dev, torch.bfloat16, N, D, V, "none")
    coef = fx_coef(torch, 0.0, V, dev)
    lse = fx.fxent_fwd(h, w, labels)[0]
    hg, wg = (t.detach().requires_grad_() for t in (h, w))
    loss = F.cross_entropy(torch.matmul(hg, wg).float(), labels,
                           ignore_index=-1, reduction="sum")
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        loss, (hg, wg), retain_graph=True), flush, iters=10)
    runs = {
        "fxent_fwd": (lambda: fx.fxent_fwd(h, w, labels),
                      lambda: fx._fxent_fwd_ref(h, w, labels),
                      time_ms(torch, lambda: F.cross_entropy(
                          torch.matmul(h, w).float(), labels,
                          ignore_index=-1, reduction="sum"), flush,
                          iters=10)),
        "fxent_dh": (lambda: fx.fxent_dh(h, w, labels, lse, coef),
                     lambda: fx._fxent_dh_ref(h, w, labels, lse, coef),
                     lib_bwd),
        "fxent_dw": (lambda: fx.fxent_dw(h, w, labels, lse, coef),
                     lambda: fx._fxent_dw_ref(h, w, labels, lse, coef),
                     lib_bwd),
    }
    del loss
    times = {}
    for name, (kern, plain, lib_ms) in runs.items():
        b_ms, b_by = fx_bound(name, N, D, V, 2)
        times[name] = {
            "N": N, "D": D, "V": V, "dtype": "bfloat16",
            "ms": time_ms(torch, kern, flush, iters=10),
            "plain_ms": time_ms(torch, plain, flush, iters=3, warmup=1),
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    del hg, wg
    torch.cuda.empty_cache()
    emit({"phase": "fxent_times", "times": times,
          "library_note": "library_ms: torch.matmul then F.cross_entropy on "
                          "the float32 logits (fxent_fwd); the backward of "
                          "that pair through torch.autograd.grad, which "
                          "computes dh and dW together (fxent_dh, "
                          "fxent_dw)"})
    return times


@contextlib.contextmanager
def pinned_experts(torch, experts):
    """Route the MoE blocks' tokens to ``experts`` (one [S] tensor a
    block, in forward order) in place of the router's argmax, the gate
    staying the router's probability of that expert: two runs pinned to
    one routing compute the same function, so their gap is rounding, not
    router flips."""
    from ddlbench_tpu_torch.models import moe

    pending, top1 = list(experts), moe.top1_gate

    def pinned(gate_logits):
        probs = torch.softmax(gate_logits.float(), -1)
        expert = pending.pop(0)
        return probs, expert, probs.gather(-1, expert[:, None])[:, 0]

    moe.top1_gate = pinned
    try:
        yield
    finally:
        moe.top1_gate = top1
    if pending:
        raise AssertionError(f"{len(pending)} pinned MoE blocks never ran")


def one_step(torch, strategy, cfg, x, y, attn, fused, pin=()):
    """One step's unsmoothed loss and gradients (forward and backward, no
    update) under attention ``attn`` and the fused head or the logits,
    each MoE block's experts pinned to ``pin`` where given
    (pinned_experts), and the peak device memory it took: (loss, grads,
    peak bytes, bytes allocated at its start, each MoE block's (experts,
    router probabilities, kept mask))."""
    import dataclasses

    from ddlbench_tpu_torch.models.moe import moe_blocks
    from ddlbench_tpu_torch.models.transformer import set_attention_backend
    from ddlbench_tpu_torch.parallel.common import loss_and_grads

    set_attention_backend(attn)
    strategy.model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    try:
        with (pinned_experts(torch, pin) if pin
              else contextlib.nullcontext()):
            ce, _, grads = loss_and_grads(
                strategy.model,
                dataclasses.replace(cfg, fused_head_loss=fused), x, y,
                torch.bfloat16, strategy.smoothing)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        set_attention_backend("auto")
    routes = [(b.last_route.expert.clone(), b.last_route.probs.clone(),
               b.last_route.keep.clone())
              for b in moe_blocks(strategy.model)]
    out = (ce.item(), [g.float().clone() for g in grads], peak, start,
           routes)
    strategy.model.zero_grad(set_to_none=True)
    return out


def router_flips(torch, a, b):
    """The tokens whose expert differs between two one_step runs, each MoE
    block's count and how many of them had already changed expert or
    drop in an earlier block (whose input then differs by more than
    noise), and the largest top-2 router-probability margin in run ``a``
    among the others (raises past MOE_FLIP_MARGIN)."""
    per_layer, cascaded, worst, clean = [], [], 0.0, None
    for (ea, pa, ka), (eb, _, kb) in zip(a[4], b[4]):
        clean = torch.ones_like(ka) if clean is None else clean
        flipped = ea != eb
        fresh = (flipped & clean).nonzero()[:, 0]
        per_layer.append(int(flipped.sum()))
        cascaded.append(int((flipped & ~clean).sum()))
        if fresh.numel():
            top2 = pa[fresh].topk(2, -1).values
            worst = max(worst, (top2[:, 0] - top2[:, 1]).max().item())
        clean = clean & ~flipped & (ka == kb)
    rec = {"flipped_tokens": per_layer, "after_earlier_change": cascaded,
           "tokens": int(a[4][0][0].numel()),
           "worst_fresh_flip_margin": worst, "margin_tol": MOE_FLIP_MARGIN}
    if worst > MOE_FLIP_MARGIN:
        raise AssertionError(f"a router flip beyond the noise: {rec}")
    return rec


def agreement(a, b, names):
    """Loss and worst gradient-leaf gap of two one_step results; raises
    past the flash-vs-xla bars (1e-2 absolute, 5e-2 relative L2)."""
    loss_gap = abs(a[0] - b[0])
    grad_rel = max(((g - h).norm() / h.norm().clamp(min=1e-30)).item()
                   for g, h in zip(a[1], b[1]))
    grad_tol = 5e-2
    rec = {f"loss_{names[0]}": a[0], f"loss_{names[1]}": b[0],
           "loss_abs_diff": loss_gap, "loss_tol": 1e-2,
           "worst_grad_rel_l2": grad_rel, "grad_tol": grad_tol}
    if not (loss_gap <= 1e-2 and grad_rel <= grad_tol):
        raise AssertionError(f"{names[0]} and {names[1]} disagree on one "
                             f"step: {rec}")
    return rec


def train_cell(torch, fa, fx, dev, argv, phase):
    """Train lmbench's cell ``argv`` on the card, flash+fused (the
    default), with every flash and fused-head launch counter zeroed just
    before the timed run and read just after; a seq2seq batch must carry
    B x (T - src_len + 1) valid labels. Then the one-step agreements and
    peak memory. Emits the phase's line and returns (launches, strategy,
    data)."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.models.moe import moe_blocks
    from ddlbench_tpu_torch.models.transformer import AttentionBlock
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.tools import lmbench
    from ddlbench_tpu_torch.tools.timing import timed_steps

    args = lmbench.build_parser().parse_args(argv)
    cfg = RunConfig(benchmark=args.benchmark, arch=args.model,
                    batch_size=args.batch_size, compute_dtype=args.dtype,
                    attention_backend="flash", steps_per_epoch=args.steps,
                    seed=0)
    strategy = make_strategy(cfg, dev)
    # each flash kernel launches once per attention layer a step
    layers = sum(isinstance(m, AttentionBlock)
                 for m in strategy.model.modules())
    per_step = {**{name: layers for name in FLASH_KERNELS},
                **{name: 1 for name in FX_KERNELS}}
    spec = cfg.dataset()
    B, T = cfg.global_batch(), spec.seq_len
    valid_per_batch = (B * (T - spec.src_len + 1) if spec.kind == "seq2seq"
                       else B * T)
    data = make_synthetic(cfg.dataset(), B, dev, seed=0,
                          steps_per_epoch=args.steps)
    lr, losses = cfg.resolved_lr(), []

    def run_step(x, y):
        m = strategy.train_step(x, y, lr)
        losses.append(m["loss"])
        return m

    counters = {**{name: getattr(fa, name) for name in FLASH_KERNELS},
                **{name: getattr(fx, name) for name in FX_KERNELS}}
    for fn in counters.values():
        fn.launches = 0
    plain0 = fa.flash_attention.plain_launches
    dt = timed_steps(run_step, data.batch, args.steps, args.warmup)
    launches = {name: fn.launches for name, fn in counters.items()}
    if fa.flash_attention.plain_launches != plain0:
        raise AssertionError(f"{fa.flash_attention.plain_launches - plain0} "
                             "attention calls took the plain path on the "
                             "main path")
    steps_run = len(losses)
    loss_vals = torch.stack(losses).float().tolist()
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"non-finite training loss: {loss_vals}")
    for name, n in launches.items():
        if n != per_step[name] * steps_run:
            raise AssertionError(f"{name} launched {n} times in {steps_run} "
                                 f"steps, not {per_step[name]} a step")
    # the MoE blocks' routing in the last timed step
    blocks = moe_blocks(strategy.model)
    moe = {"aux_weight": cfg.moe_aux_weight,
           "capacity_factor": cfg.moe_capacity_factor,
           "aux": [b.last_route.aux.item() for b in blocks],
           "drop_share": [(~b.last_route.keep).float().mean().item()
                          for b in blocks]} if blocks else None
    if moe:
        moe["aux_term"] = cfg.moe_aux_weight * sum(moe["aux"])
    # the batches the run took (timed_steps: epoch 0 step 0 warms up)
    valid_vals = [int((data.batch(*key)[1] >= 0).sum()) for key in
                  [(0, 0)] + [(1, step) for step in range(args.steps)]]
    if set(valid_vals) != {valid_per_batch}:
        raise AssertionError(f"valid labels per batch {valid_vals}, not "
                             f"{valid_per_batch}")

    # one step from the same weights and batch: fused vs logits (flash),
    # flash vs xla (fused), and the peak memory of each head. The MoE
    # blocks of the compared runs route as the fused flash run did, so
    # every gradient leaf is held to the same bar; a run left to its own
    # router counts the router flips and its loss gap
    x, y = data.batch(2, 0)
    fused = one_step(torch, strategy, cfg, x, y, "flash", True)
    pin = [route[0] for route in fused[4]]
    logits = one_step(torch, strategy, cfg, x, y, "flash", False, pin)
    xla = one_step(torch, strategy, cfg, x, y, "xla", True, pin)
    gib = 2.0 ** 30
    pairs = {}
    for key, other, names, attn, head in (
            ("fused_vs_logits", logits, ("fused", "logits"), "flash", False),
            ("flash_vs_xla", xla, ("flash", "xla"), "xla", True)):
        pairs[key] = agreement(fused, other, names)
        if blocks:
            free = one_step(torch, strategy, cfg, x, y, attn, head)
            router = router_flips(torch, fused, free)
            router["unpinned_loss_abs_diff"] = abs(fused[0] - free[0])
            if not router["unpinned_loss_abs_diff"] <= 1e-2:
                raise AssertionError(f"{key}: the unpinned runs' losses "
                                     f"disagree: {router}")
            pairs[key]["router"] = router
            del free
    fused_vs_logits, flash_vs_xla = pairs["fused_vs_logits"], \
        pairs["flash_vs_xla"]
    emit({"phase": phase, "model": args.model, "benchmark": args.benchmark,
          "batch": B, "seq_len": T, "dtype": args.dtype,
          "config": "flash+fused", "optimizer": cfg.resolved_optimizer(),
          "label_smoothing": cfg.resolved_label_smoothing(),
          "steps": steps_run, "launches": launches,
          "launches_per_step": per_step,
          "valid_labels_per_batch": sorted(set(valid_vals)),
          "losses": loss_vals, "moe": moe,
          "timed_tokens_per_sec": args.steps * B * T / dt,
          "timed_ms_per_step": 1e3 * dt / args.steps,
          "fused_vs_logits": fused_vs_logits,
          "flash_vs_xla": flash_vs_xla,
          "step_peak_memory_gib": {
              "flash+fused": fused[2] / gib, "flash+logits": logits[2] / gib,
              "xla+fused": xla[2] / gib},
          "step_peak_over_start_gib": {
              "flash+fused": (fused[2] - fused[3]) / gib,
              "flash+logits": (logits[2] - logits[3]) / gib,
              "xla+fused": (xla[2] - xla[3]) / gib}})
    del fused, logits, xla
    torch.cuda.empty_cache()
    return launches, strategy, data


def phase_train(torch, fa, fx, dev):
    """lmbench's main path (transformer_s / synthtext, flash+fused), then
    the port's lmbench rows for the four forced cells."""
    from ddlbench_tpu_torch.tools import lmbench

    launches, strategy, data = train_cell(torch, fa, fx, dev, TRAIN_ARGS,
                                          "train")
    rc = lmbench.main(TRAIN_ARGS)
    if rc != 0:
        raise AssertionError(f"lmbench exited {rc}")
    return launches, strategy, data


def phase_seq2seq(torch, fa, fx, dev):
    """seq2seq_s / synthmt through the prefix path and the fused head
    (Adam, smoothing 0.1; B 64 x 129 = 8 256 valid labels a batch), then
    its lmbench rows."""
    from ddlbench_tpu_torch.tools import lmbench

    launches, strategy, data = train_cell(torch, fa, fx, dev, S2S_ARGS,
                                          "seq2seq")
    del strategy, data
    torch.cuda.empty_cache()
    rc = lmbench.main(S2S_ARGS + ["--configs", "flash+fused,flash+logits"])
    if rc != 0:
        raise AssertionError(f"lmbench exited {rc}")
    return launches


def phase_moe_train(torch, fa, fx, dev):
    """transformer_moe_s / synthtext at full width (B 16, T 1 024, 8
    experts, capacity factor 1.25), flash+fused, then one profiled step
    and its lmbench rows (no remat retry). Returns the launches."""
    from ddlbench_tpu_torch.tools import lmbench

    launches, strategy, data = train_cell(torch, fa, fx, dev, MOE_ARGS,
                                          "moe_train")
    phase_train_profile(torch, strategy, data, "moe_train_profile", 1)
    del strategy, data
    torch.cuda.empty_cache()
    rc = lmbench.main(MOE_ARGS)
    if rc != 0:
        raise AssertionError(f"lmbench exited {rc}")
    return launches


def lstm_vs_cpu(torch, strategy, data):
    """Each LSTM layer of the trained model on the card (bf16: cuDNN's
    recurrence over weights re-packed at the call) against the same layer
    in float32 on the CPU (PyTorch's own cell), both fed one batch's
    embedding rounded to bf16 at the cell's shape; raises past
    LSTM_TOL_ABS times the largest output or past LSTM_TOL_REL."""
    import copy

    from ddlbench_tpu_torch.models.lstm import LSTMLayer

    model = strategy.model
    x, _ = data.batch(2, 0)
    layers = []
    with torch.no_grad():
        h = model.layers[0](x).to(torch.bfloat16)
        for i, layer in enumerate(model.layers):
            if not isinstance(layer, LSTMLayer):
                continue
            got = layer(h).float().cpu()
            want = copy.deepcopy(layer).cpu().float()(h.float().cpu())
            layers.append({
                "layer": i, "residual": layer.residual,
                "max_abs_err": (got - want).abs().max().item(),
                "rel_l2": ((got - want).norm() / want.norm()).item(),
                "max_abs_out": want.abs().max().item()})
    rec = {"phase": "lstm_vs_cpu", "shape": list(h.shape),
           "layers": layers, "tol_abs": LSTM_TOL_ABS,
           "tol_rel": LSTM_TOL_REL}
    emit(rec)
    if not all(r["max_abs_err"] <= LSTM_TOL_ABS * r["max_abs_out"]
               and r["rel_l2"] <= LSTM_TOL_REL for r in layers):
        raise AssertionError(f"an LSTM layer on the card disagrees with "
                             f"the CPU: {rec}")


def phase_lstm_train(torch, fa, fx, dev):
    """seq2seq_lstm_s / synthmt (B 64, T 256, 4 LSTM layers on
    torch.lstm), flash+fused, Adam, smoothing 0.1: no flash launch, the
    fused head once a step; one profiled step; its lmbench rows. Returns
    the launches."""
    from ddlbench_tpu_torch.tools import lmbench

    launches, strategy, data = train_cell(torch, fa, fx, dev, LSTM_ARGS,
                                          "lstm_train")
    lstm_vs_cpu(torch, strategy, data)
    phase_train_profile(torch, strategy, data, "lstm_train_profile", 1)
    del strategy, data
    torch.cuda.empty_cache()
    rc = lmbench.main(LSTM_ARGS + ["--configs", "flash+fused,flash+logits"])
    if rc != 0:
        raise AssertionError(f"lmbench exited {rc}")
    return launches


def full_forward_decode(torch, dec, model, src, T, beam=None):
    """The full-forward oracle of a causal LM: one forward over the
    unpadded prefix per position, greedy, or beam search with
    models/decode.py's expansion. Returns (tokens, scores or None)."""
    with torch.no_grad():
        if beam is None:
            x = src.long()
            for _ in range(src.shape[1], T):
                x = torch.cat([x, model(x)[:, -1].argmax(-1)[:, None]], 1)
            return x, None
        B, S = src.shape
        x = torch.zeros(B * beam, T, dtype=torch.long, device=src.device)
        x[:, :S] = src.long().repeat_interleave(beam, 0)
        score = dec.first_scores(B, beam, src.device)
        for t in range(S, T):
            x, score, _ = dec.beam_expand(x, score, model(x[:, :t])[:, -1],
                                          t, B, beam)
        return dec.best_beam(x, score, B, beam, T - S, 0.6)


def phase_moe_decode(torch, pd, fa, dev):
    """transformer_moe_s decoding on the card (random weights, seed 0,
    capacity factor 8): greedy and beam 4 at B 8 from 256 prompt tokens
    to 512, over the paged (B7 at page 64, B1 on the prefill) and the
    dense caches, each against the full-forward loop (near-tie forks
    only); the launches; B7 at the beam cache's last step; decodebench's
    rows. Returns B7's and B1's launches over the cached runs."""
    from ddlbench_tpu_torch.config import DATASETS
    from ddlbench_tpu_torch.device import provenance
    from ddlbench_tpu_torch.models import decode as dec
    from ddlbench_tpu_torch.models.moe import moe_blocks
    from ddlbench_tpu_torch.models.transformer import AttentionBlock
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.tools import decodebench

    t0 = time.perf_counter()
    args = decodebench.build_parser().parse_args(MOE_DECODE_ARGS)
    spec = DATASETS[args.benchmark]
    T, B, beam = args.total_len, args.batch, args.beam
    S = T // 2
    model = get_model(args.model, spec, seed=0,
                      moe_capacity_factor=MOE_DECODE_CF).to(dev)
    layers = sum(isinstance(m, AttentionBlock) for m in model.modules())
    src = torch.randint(0, spec.num_classes, (B, S),
                        generator=torch.Generator().manual_seed(1)).to(dev)

    def zero():
        pd.paged_attention.launches = pd.paged_attention.plain_launches = 0
        fa.flash_fwd.launches = fa.flash_attention.plain_launches = 0

    def counts():
        return {"paged_attention": pd.paged_attention.launches,
                "flash_fwd": fa.flash_fwd.launches,
                "plain": pd.paged_attention.plain_launches
                + fa.flash_attention.plain_launches}

    out, launches, seconds = {}, {}, {}
    for mode in ("greedy", "beam"):
        tr = time.perf_counter()
        out[f"full_{mode}"] = full_forward_decode(
            torch, dec, model, src, T, beam if mode == "beam" else None)
        torch.cuda.synchronize()
        seconds[f"full_{mode}"] = time.perf_counter() - tr
        dropped = sum(int((~b.last_route.keep).sum())
                      for b in moe_blocks(model))
        if dropped:
            raise AssertionError(f"the full forward dropped {dropped} tokens "
                                 f"at capacity factor {MOE_DECODE_CF}")
        for variant in ("cached", "paged"):
            name = f"{variant}_{mode}"
            zero()
            tr = time.perf_counter()
            paged = variant == "paged"
            res = (dec.greedy_decode(model, src, T, paged=paged)
                   if mode == "greedy" else dec.beam_search_decode(
                       model, src, T, beam=beam, paged=paged))
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - tr
            launches[name] = counts()
            out[name] = res if mode == "beam" else (res, None)

    checks, compared = {}, {}
    for name in ("cached_greedy", "paged_greedy", "cached_beam",
                 "paged_beam"):
        variant, mode = name.split("_")

        def logits_of(prefix, side, variant=variant):
            return path_logits(torch, dec, pd, model, prefix,
                               "full" if side == "want" else variant,
                               torch.float32, S, T)

        compared[name] = held_to_oracle(torch, out[name],
                                        out[f"full_{mode}"], logits_of)
    checks["paths_against_full_forward"] = all(r["ok"] for r in
                                               compared.values())
    want_b7, want_b1 = (T - 1 - S) * layers, layers
    checks["launches"] = all(
        launches[n]["plain"] == 0 and launches[n]["flash_fwd"] == want_b1
        and launches[n]["paged_attention"] == (want_b7 if "paged" in n
                                               else 0) for n in launches)
    b7 = sum(launches[n]["paged_attention"] for n in launches)
    del out
    torch.cuda.empty_cache()

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    shape = (B * beam, (T - 2) // 64 + 1, 64)
    times = {str(d).split(".")[-1]: beam_time(torch, pd, dev, d, flush,
                                               shape)
             for d in (torch.float32, torch.bfloat16)}
    del flush
    torch.cuda.empty_cache()

    rows = list(decodebench.decode_rows(args, model, spec, dev,
                                        provenance(dev)))
    for row in rows:
        print(json.dumps(row), flush=True)
    timed = [r for r in rows if "skipped" not in r]
    checks["decodebench"] = (
        len(timed) == 4 and not any("error" in r for r in rows)
        and all(r["plain_launches"] == 0 for r in timed)
        and {r["variant"] for r in rows if "skipped" in r} == {"full"})
    emit({"phase": "moe_decode", "model": args.model,
          "benchmark": args.benchmark, "capacity_factor": MOE_DECODE_CF,
          "batch": B, "beam": beam, "prompt_len": S, "total_len": T,
          "checks": checks, "compared": compared, "launches": launches,
          "expected_paged": {"paged_attention": want_b7,
                             "flash_fwd": want_b1, "plain": 0},
          "run_seconds": seconds, "b7_moe_beam_shape": times,
          "decodebench": [{k: r.get(k) for k in (
              "mode", "variant", "tokens_per_sec", "ms_per_token",
              "plain_launches", "skipped")} for r in rows],
          "card": card_line(), "seconds": time.perf_counter() - t0})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"moe_decode: failed {failed}")
    return b7, sum(launches[n]["flash_fwd"] for n in launches)


def write_text_corpus(root: Path, seed: int = 0) -> None:
    """A made-up text corpus from ``seed``: ``train.txt`` (TEXT_LINES
    lines of a 200-word vocabulary) and a ``train.src``/``train.tgt``
    pair whose target reverses the source's words."""
    import random

    rng = random.Random(seed)
    letters = "abcdefghiklmnoprstuvy"
    words = ["".join(rng.choice(letters) for _ in range(rng.randint(2, 9)))
             for _ in range(200)]
    lines = [" ".join(rng.choice(words) for _ in range(rng.randint(4, 16)))
             for _ in range(TEXT_LINES)]
    root.mkdir(parents=True, exist_ok=True)
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    (root / "train.src").write_text("\n".join(lines) + "\n")
    (root / "train.tgt").write_text("\n".join(
        " ".join(w[::-1] for w in line.split()[::-1]) for line in lines)
        + "\n")


def phase_text_data(torch, dev):
    """On-disk text on the card (phase 10e of the docstring): the CLI's
    -s --data-dir on a text corpus, a parallel corpus and a generated
    token store, a few steps each; each source's first batch on the card
    equal to the CPU's bitwise."""
    import contextlib
    import io
    import tempfile

    from ddlbench_tpu_torch import cli
    from ddlbench_tpu_torch.train.loop import make_data

    t0 = time.perf_counter()
    runs, first_equal = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_text_") as tmp:
        corpus = Path(tmp) / "corpus"
        write_text_corpus(corpus)
        for name, argv in TEXT_CLI.items():
            root = corpus if "corpus" in name else Path(tmp) / "store"
            argv = argv + TEXT_CLI_COMMON + ["--data-dir", str(root)]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            lines = out.getvalue().splitlines()
            for line in lines:
                print(line, flush=True)
            losses = [float(re.search(r"loss (\S+)", line).group(1))
                      for line in lines if line.startswith("train | ")]
            source = next((line for line in lines if line.startswith(
                ("text corpus: ", "translation data: "))), None)
            result = json.loads(lines[-1][len("result: "):])
            if not (rc == 0 and len(losses) == 3
                    and all(math.isfinite(v) for v in losses)
                    and (source is not None) == ("corpus" in name)):
                raise AssertionError(f"text_data {name}: rc {rc}, losses "
                                     f"{losses}, source line {source!r}")
            # the first batch of the run's source, on the card and on the
            # CPU (a store: two readers of the same sequential stream)
            cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
            batches = []
            for d in (dev, torch.device("cpu")):
                data = make_data(cfg, d)
                try:
                    batches.append([t.cpu() for t in data.batch(0, 0)])
                finally:
                    getattr(data, "close", lambda: None)()
            first_equal[name] = all(torch.equal(a, b) and a.dtype == b.dtype
                                    for a, b in zip(*batches))
            runs[name] = {"argv": argv, "source": source,
                          "train_losses": losses,
                          "samples_per_sec": result["samples_per_sec"],
                          "first_batch_shape": list(batches[0][0].shape)}
    emit({"phase": "text_data", "runs": runs,
          "first_batch_equal_cpu": first_equal,
          "seconds": time.perf_counter() - t0})
    if not all(first_equal.values()):
        raise AssertionError(f"text_data: first batches differ from the "
                             f"CPU's: {first_equal}")


def phase_tiny_dispatch(torch, dev):
    """transformer_t (d 32, 4 heads: head dim 8, which the flash and paged
    kernels do not take) on the card: lmbench's ``auto`` cell trains a few
    steps through the plain attention and the fused-head kernels (D 32),
    servebench serves through the plain paged attention, each row
    reporting its plain-path calls (> 0), and a forced ``flash`` raises."""
    from ddlbench_tpu_torch.models.transformer import (causal_attention,
                                                       set_attention_backend)
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.ops import fused_xent as fx
    from ddlbench_tpu_torch.tools import lmbench, servebench

    lm_args = lmbench.build_parser().parse_args(
        ["-m", "transformer_t", "-b", "synthtext", "--batch-size", "4",
         "--steps", "3", "--warmup", "1", "--configs", "auto"])
    fx.fxent_dh.launches = fx.fxent_dw.launches = 0
    try:
        lm = lmbench.run_config(lm_args, "auto", False, dev)
    finally:
        set_attention_backend("auto")
    fused = {"fxent_dh": fx.fxent_dh.launches,
             "fxent_dw": fx.fxent_dw.launches}
    sv_args = servebench.build_parser().parse_args(
        ["-m", "transformer_t", "-b", "synthtext", "--policies",
         "continuous", "--arrival", "closed", "--requests", "8", "--seed",
         "0"])
    model = get_model(sv_args.model, sv_args.benchmark,
                      seed=sv_args.seed).to(dev)
    (sv, _, _), = servebench.run(sv_args, model, dev)
    q = torch.zeros(1, 4, 16, 8, dtype=torch.bfloat16, device=dev)
    set_attention_backend("flash")
    try:
        causal_attention(q, q, q)
        raised = None
    except ValueError as e:
        raised = str(e)
    finally:
        set_attention_backend("auto")
    rec = {"phase": "tiny_dispatch", "lmbench_row": lm,
           "fused_head_launches": fused, "servebench_row": sv,
           "forced_flash_dh8_raises": raised}
    if not (lm["plain_launches"] > 0 and sv["plain_launches"] > 0
            and sv["completed"] == sv_args.requests and raised
            and all(n > 0 for n in fused.values())
            and math.isfinite(lm["ms_per_step"])):
        raise AssertionError(f"transformer_t on the card: {rec}")
    emit(rec)


def phase_train_profile(torch, strategy, data, phase="train_profile",
                        steps=3):
    """Where a flash+fused training step's device time goes: ``steps``
    warm steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from ddlbench_tpu_torch.models.transformer import set_attention_backend

    set_attention_backend("flash")
    lr = strategy.cfg.resolved_lr()
    x, y = data.batch(3, 0)
    strategy.train_step(x, y, lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            m = strategy.train_step(*data.batch(3, i + 1), lr)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    set_attention_backend("auto")
    kern, busy_ms = device_kernels(prof)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    port = {}  # each port kernel's device ms and launches per step
    for e in kern:
        name = next((k for k in TRAIN_KERNELS if k in e.key), None)
        if name:
            rec = port.setdefault(name, {"ms_per_step": 0.0,
                                         "calls_per_step": 0.0})
            rec["ms_per_step"] += e.self_device_time_total / 1e3 / steps
            rec["calls_per_step"] += e.count / steps
    emit({"phase": phase, "model": strategy.cfg.arch, "steps": steps,
          "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if kern else None,
          "device_busy_share": busy_ms / wall_ms if kern else None,
          "port_kernels": port,
          "top_kernels": [{"name": e.key[:80], "calls": e.count,
                           "ms": e.self_device_time_total / 1e3,
                           "share_of_busy": (e.self_device_time_total / 1e3
                                             / busy_ms)}
                          for e in top]})


def image_step(torch, model, x, y, cfg, dtype):
    """One training step's forward and backward of ``model`` on (x, y) in
    ``dtype`` (None: the model's own), train mode: (loss, gradient
    leaves, the running statistics it leaves), on the host."""
    from ddlbench_tpu_torch.parallel.common import loss_and_grads

    ce, _, grads = loss_and_grads(model, cfg, x, y, dtype, 0.0)
    return (ce.item(), [g.detach().double().cpu() for g in grads],
            [b.detach().double().cpu() for b in model.buffers()])


def worst_leaf(got, want) -> float:
    """The largest relative L2 error of ``got``'s leaves against
    ``want``'s, each leaf measured against at least IMAGE_FLOOR of the
    largest leaf of ``want`` (0 for no leaves)."""
    if not want:
        return 0.0
    floor = max(IMAGE_FLOOR * max(b.norm().item() for b in want), 1e-30)
    return max(((a - b).norm() / max(b.norm().item(), floor)).item()
               for a, b in zip(got, want))


def image_agreement(card, card64, cpu, f64):
    """The card's float32 and float64 steps against the CPU's. float64:
    the loss, every gradient leaf and every running statistic within
    IMAGE_F64_RTOL (relative L2) of the CPU's float64 step. float32: the
    loss within IMAGE_LOSS_RTOL relative and each running statistic within
    IMAGE_STAT_RTOL of the CPU's float32 step, and the card's worst
    gradient leaf no further from the CPU's float64 step than
    IMAGE_GRAD_RTOL or twice the CPU float32 step's worst leaf, whichever
    is larger. Leaves are measured with the IMAGE_FLOOR of their kind.
    Returns the record with "ok"."""
    worst = worst_leaf

    def loss_rel(a, b):
        return abs(a[0] - b[0]) / abs(b[0])

    f64_rec = {"loss_rel": loss_rel(card64, f64),
               "worst_grad_rel_l2": worst(card64[1], f64[1]),
               "worst_stat_rel_l2": worst(card64[2], f64[2])}
    grad_card = worst(card[1], f64[1])
    grad_cpu = worst(cpu[1], f64[1])
    grad_bar = max(IMAGE_GRAD_RTOL, 2 * grad_cpu)
    rec = {"loss_card": card[0], "loss_cpu": cpu[0],
           "loss_rel": loss_rel(card, cpu),
           "worst_stat_rel_l2": worst(card[2], cpu[2]),
           "worst_grad_rel_l2_vs_f64": grad_card,
           "cpu_f32_worst_grad_rel_l2_vs_f64": grad_cpu,
           "grad_bar": grad_bar,
           "worst_grad_rel_l2_vs_cpu": worst(card[1], cpu[1]),
           "float64_card_vs_cpu": f64_rec}
    rec["ok_float32"] = (rec["loss_rel"] <= IMAGE_LOSS_RTOL
                         and rec["worst_stat_rel_l2"] <= IMAGE_STAT_RTOL
                         and grad_card <= grad_bar)
    rec["ok_float64"] = all(v <= IMAGE_F64_RTOL for v in f64_rec.values())
    rec["ok"] = rec["ok_float32"] and rec["ok_float64"]
    return rec


def image_card_vs_cpu(torch, dev):
    """resnet50/imagenet from seed 0, one training step at B 4 on the card
    (channels_last) and on the CPU from the same weights, running
    statistics and batch, in float32 and in float64 (module docstring,
    phase 12); then the same card steps with three planted faults, each
    of which must be rejected: the stride-2 convolutions padded
    symmetrically (torch's padding=k//2, not XLA's SAME), the running
    variance updated with the biased batch variance, and BatchNorm's
    backward without its mean term (the batch mean taken as a constant: a
    fault only the gradients show)."""
    import copy

    import torch.nn.functional as F

    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.models import layers
    from ddlbench_tpu_torch.models.zoo import get_model

    cfg = RunConfig(benchmark="imagenet", arch="resnet50",
                    compute_dtype="float32", seed=0)
    cfg.validate()
    initial = get_model(cfg.arch, cfg.benchmark, seed=0)
    x, y = make_synthetic(cfg.dataset(), IMAGE_CHECK_B, torch.device("cpu"),
                          seed=0).batch(0, 0)
    t0 = time.perf_counter()
    cpu = image_step(torch, copy.deepcopy(initial), x, y, cfg,
                     torch.float32)
    f64 = image_step(torch, copy.deepcopy(initial).double(), x.double(), y,
                     cfg, None)
    cpu_s = time.perf_counter() - t0

    def on_card():
        steps = []
        for dtype in (torch.float32, torch.float64):
            model = copy.deepcopy(initial).to(dev, dtype).to(
                memory_format=torch.channels_last)
            steps.append(image_step(
                torch, model, x.to(dev, dtype), y.to(dev), cfg,
                torch.float32 if dtype == torch.float32 else None))
        return steps

    card = image_agreement(*on_card(), cpu, f64)
    if not card["ok"]:
        raise AssertionError(f"resnet50 card step disagrees with the CPU "
                             f"step: {card}")
    conv2d = layers.conv2d

    def symmetric_conv2d(x, kernel, stride=1, groups=1):
        if stride == 1:
            return conv2d(x, kernel, stride, groups)
        return F.conv2d(x, kernel, stride=stride,
                        padding=kernel.shape[2] // 2, groups=groups)

    def biased_bn(self, x):
        y = F.batch_norm(x, None, None, self.scale, self.bias, True, 0.0,
                         layers.BN_EPS)
        with torch.no_grad():
            self.mean.mul_(0.9).add_(0.1 * x.mean((0, 2, 3)))
            self.var.mul_(0.9).add_(0.1 * x.var((0, 2, 3), unbiased=False))
        return y

    def bn_without_mean_gradient(self, x):
        n = x.numel() // x.shape[1]
        mean = x.mean((0, 2, 3)).detach()
        xc = x - mean[None, :, None, None]
        var = (xc * xc).mean((0, 2, 3))
        with torch.no_grad():
            self.mean.mul_(0.9).add_(0.1 * mean)
            self.var.mul_(0.9).add_(0.1 * var * n / (n - 1))
        inv = torch.rsqrt(var + layers.BN_EPS) * self.scale
        return xc * inv[None, :, None, None] + self.bias[None, :, None, None]

    faults = {}
    for name, target, attr, fault in (
            ("symmetric_stride2_padding", layers, "conv2d",
             symmetric_conv2d),
            ("biased_running_var", layers.BatchNorm, "forward", biased_bn),
            ("batchnorm_without_mean_gradient", layers.BatchNorm, "forward",
             bn_without_mean_gradient)):
        original = getattr(target, attr)
        setattr(target, attr, fault)
        try:
            rec = image_agreement(*on_card(), cpu, f64)
        finally:
            setattr(target, attr, original)
        rec["rejected"] = not rec.pop("ok")
        faults[name] = rec
    if not all(f["rejected"] for f in faults.values()):
        raise AssertionError(f"a planted fault passed the card-vs-CPU "
                             f"check: {faults}")
    return {"model": cfg.arch, "benchmark": cfg.benchmark,
            "batch": IMAGE_CHECK_B, "dtypes": ["float32", "float64"],
            "loss_rtol": IMAGE_LOSS_RTOL, "grad_rtol": IMAGE_GRAD_RTOL,
            "stat_rtol": IMAGE_STAT_RTOL, "float64_rtol": IMAGE_F64_RTOL,
            "floor": IMAGE_FLOOR, "cpu_steps_s": cpu_s,
            "card_vs_cpu": card, "planted_faults": faults}


def image_main_path(torch, dev):
    """resnet50/imagenet at B 128, bfloat16 on float32 masters,
    channels_last, cudnn.benchmark on, through make_strategy / train_step
    / timed_steps_prefetched at depth 0 (each batch made inline): 2
    warm-up and 10 timed steps, every loss finite; then one more step's
    peak device memory."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.prefetch import Prefetcher
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.telemetry.stats import percentile
    from ddlbench_tpu_torch.tools.timing import timed_steps_prefetched

    torch.backends.cudnn.benchmark = True
    cfg = RunConfig(benchmark="imagenet", arch="resnet50",
                    batch_size=IMAGE_B, compute_dtype="bfloat16", seed=0)
    strategy = make_strategy(cfg, dev)
    data = make_synthetic(cfg.dataset(), IMAGE_B, dev, seed=0,
                          steps_per_epoch=IMAGE_STEPS)
    lr, losses = cfg.resolved_lr(), []

    def run_step(x, y):
        m = strategy.train_step(x, y, lr)
        losses.append(m["loss"])
        return m

    dt, stall_s, steps, step_s = timed_steps_prefetched(
        run_step, Prefetcher(data, depth=0), IMAGE_WARMUP)
    loss_vals = torch.stack(losses).float().tolist()
    if steps != IMAGE_STEPS or not all(math.isfinite(v) for v in loss_vals):
        raise AssertionError(f"{steps} resnet50 steps of {IMAGE_STEPS}, "
                             f"losses {loss_vals}")
    layout = next(strategy.model.parameters()).is_contiguous(
        memory_format=torch.channels_last)
    x, y = data.batch(2, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    float(strategy.train_step(x, y, lr)["loss"])
    peak = torch.cuda.max_memory_allocated()
    step_ms = [t * 1e3 for t in step_s]
    return strategy, data, {
        "model": cfg.arch, "benchmark": cfg.benchmark, "batch": IMAGE_B,
        "dtype": cfg.compute_dtype, "channels_last": layout,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "steps": IMAGE_STEPS, "warmup": IMAGE_WARMUP, "losses": loss_vals,
        "images_per_sec": IMAGE_STEPS * IMAGE_B / dt,
        "ms_per_step": 1e3 * dt / IMAGE_STEPS,
        "step_ms_p50": percentile(step_ms, 50),
        "step_ms_p95": percentile(step_ms, 95), "input_stall_s": stall_s,
        "step_peak_memory_gib": peak / 2 ** 30,
        "step_peak_over_start_gib": (peak - start) / 2 ** 30}


def image_cli(torch):
    """The training CLI in-process on the card: resnet50/imagenet, one
    epoch of 20 steps at the reference's default batch (32); its lines
    must carry the reference's schema and the summary a finite loss."""
    import contextlib
    import io

    from ddlbench_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(IMAGE_CLI_ARGS)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(line, flush=True)
    kinds = {k: sum(line.startswith(k) for line in lines)
             for k in ("train | ", "epoch 1/1 done", "valid | ",
                       "valid accuracy: ", "result: ")}
    result = json.loads(lines[-1][len("result: "):])
    losses = [float(re.search(r"loss (\S+)", line).group(1))
              for line in lines if line.startswith("train | ")]
    if not (rc == 0 and kinds["train | "] >= 1
            and all(kinds[k] == 1 for k in kinds if k != "train | ")
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"the CLI run on the card: rc {rc}, {kinds}, "
                             f"losses {losses}")
    return {"argv": IMAGE_CLI_ARGS, "line_counts": kinds,
            "train_losses": losses, "result": result}


def image_bench(torch, argv):
    """tools/bench in-process: its one JSON record."""
    import contextlib
    import io

    from ddlbench_tpu_torch.tools import bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    rec = json.loads(out.getvalue().splitlines()[-1])
    if rc != 0 or not (rec["value"] > 0 and rec["platform"] == "gpu"):
        raise AssertionError(f"bench {argv}: rc {rc}, {rec}")
    torch.cuda.empty_cache()
    return rec


# the step's device kernels by what they compute, matched on their names
# in this order (first match wins)
# (cuDNN runs the 1x1 convolutions as cuBLASLt GEMMs, "nvjet" kernels)
IMAGE_KERNEL_GROUPS = (
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("optimizer", ("foreach", "multi_tensor", "sgd")),
    ("convolution_and_gemm", ("conv", "cudnn", "xmma", "gemm", "wgrad",
                              "dgrad", "fprop", "cutlass", "winograd",
                              "implicit", "nvjet", "cublas")),
    ("pool_and_reduce", ("pool", "reduce_kernel", "mean")),
    ("elementwise_and_cast", ("elementwise", "vectorized", "copy", "cast",
                              "fill", "where", "clamp", "threshold")),
)


def image_profile(torch, strategy, data):
    """Three warm resnet50 B 128 steps under torch.profiler: the device's
    busy share, its time by kernel group (with each group's largest
    kernels) and by kernel. Only kernels count: a user annotation's
    device range (``Optimizer.step#SGD.step``) spans kernels counted
    already."""
    from torch.profiler import ProfilerActivity, profile

    lr = strategy.cfg.resolved_lr()
    float(strategy.train_step(*data.batch(3, 0), lr)["loss"])
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            m = strategy.train_step(*data.batch(3, i + 1), lr)
        float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = {}  # kernel name -> [calls, device ms]
    for e in prof.events():
        if (e.device_type.name != "CUDA" or e.self_device_time_total <= 0
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith("Optimizer.")):
            continue
        rec = kern.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.self_device_time_total / 1e3
    if not kern:
        raise AssertionError("torch.profiler recorded no device time")
    busy_ms = sum(ms for _, ms in kern.values())
    groups = {}
    for name, (calls, ms) in sorted(kern.items(), key=lambda kv: -kv[1][1]):
        key = name.lower()
        group = next((g for g, words in IMAGE_KERNEL_GROUPS
                      if any(w in key for w in words)), "other")
        rec = groups.setdefault(group, {"ms_per_step": 0.0,
                                        "launches_per_step": 0.0,
                                        "largest": []})
        rec["ms_per_step"] += ms / steps
        rec["launches_per_step"] += calls / steps
        if len(rec["largest"]) < 3:
            rec["largest"].append(name[:90])
    for rec in groups.values():
        rec["share_of_busy"] = rec["ms_per_step"] * steps / busy_ms
    top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:15]
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "launches_per_step": sum(c for c, _ in kern.values()) / steps,
            "groups": dict(sorted(groups.items(),
                                  key=lambda kv: -kv[1]["ms_per_step"])),
            "top_kernels": [{"name": name[:90], "calls": calls, "ms": ms,
                             "share_of_busy": ms / busy_ms}
                            for name, (calls, ms) in top]}


def phase_image(torch, dev):
    """Image training on the card (phase 12 of the docstring)."""
    t0 = time.perf_counter()
    check = image_card_vs_cpu(torch, dev)
    emit({"phase": "image_check", **check})
    strategy, data, main_path = image_main_path(torch, dev)
    emit({"phase": "image", **main_path})
    emit({"phase": "image_profile", **image_profile(torch, strategy, data)})
    del strategy, data
    torch.cuda.empty_cache()
    emit({"phase": "image_cli", **image_cli(torch)})
    torch.cuda.empty_cache()
    headline = image_bench(torch, [])
    emit({"phase": "image_bench", "headline": headline})
    rows = [image_bench(torch, ["--arch", arch] + IMAGE_SHORT_ARGS)
            for arch in IMAGE_SHORT_ARCHS]
    emit({"phase": "image_models", "rows": rows})
    emit({"phase": "image_seconds", "seconds": time.perf_counter() - t0})
    return headline


def f64_agreement(card, cpu):
    """The float64 card step against the float64 CPU step: the loss's
    relative error and the worst gradient leaf's and running statistic's
    relative L2 (with the IMAGE_FLOOR of their kind); "ok" when all are
    within IMAGE_F64_RTOL."""
    rec = {"loss_card": card[0], "loss_cpu": cpu[0],
           "loss_rel": abs(card[0] - cpu[0]) / abs(cpu[0]),
           "worst_grad_rel_l2": worst_leaf(card[1], cpu[1]),
           "worst_stat_rel_l2": worst_leaf(card[2], cpu[2])}
    rec["ok"] = all(rec[k] <= IMAGE_F64_RTOL for k in
                    ("loss_rel", "worst_grad_rel_l2", "worst_stat_rel_l2"))
    return rec


def f64_card_step(torch, initial, x, y, cfg, dev):
    """image_step of a float64 copy of ``initial`` on the card
    (channels_last)."""
    import copy

    model = copy.deepcopy(initial).to(dev, torch.float64).to(
        memory_format=torch.channels_last)
    xd = x.to(dev, torch.float64).contiguous(
        memory_format=torch.channels_last)
    return image_step(torch, model, xd, y.to(dev), cfg, None)


def real_ingest(root: Path):
    """13a: an MNIST IDX pair and CIFAR-10 pickles of seeded uint8 images,
    written here with struct and pickle, imported through the port
    (resolve_split): each store's bytes, labels, shape and count must be
    what was written."""
    import pickle
    import struct

    import numpy as np

    from ddlbench_tpu_torch.config import DATASETS
    from ddlbench_tpu_torch.data.imagefolder import resolve_split

    rng = np.random.default_rng(0)
    src = root / "ingest"
    src.mkdir()
    written = {}
    for prefix, split, n in (("train", "train", 60), ("t10k", "test", 20)):
        imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, n, dtype=np.uint8)
        with open(src / f"{prefix}-images-idx3-ubyte", "wb") as f:
            f.write(struct.pack(">BBBB3I", 0, 0, 8, 3, n, 28, 28))
            f.write(imgs.tobytes())
        with open(src / f"{prefix}-labels-idx1-ubyte", "wb") as f:
            f.write(struct.pack(">BBBBI", 0, 0, 8, 1, n))
            f.write(labels.tobytes())
        written[("mnist", split)] = (imgs[..., None], labels)
    cifar = src / "cifar-10-batches-py"
    cifar.mkdir()
    parts = {"train": [], "test": []}
    for name, n in [(f"data_batch_{i}", 10) for i in range(1, 6)] + [
            ("test_batch", 8)]:
        rows = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
        labels = rng.integers(0, 10, n).tolist()
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rows, b"labels": labels}, f)
        parts["test" if name == "test_batch" else "train"].append(
            (rows, labels))
    for split, got in parts.items():
        rows = np.concatenate([r for r, _ in got])
        written[("cifar10", split)] = (
            rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
            np.concatenate([lb for _, lb in got]))
    stores = {}
    for (name, split), (imgs, labels) in written.items():
        d = Path(resolve_split(str(src), DATASETS[name], split))
        meta = json.loads((d / "meta.json").read_text())
        ok = ((d / "images.bin").read_bytes()
              == np.ascontiguousarray(imgs).tobytes()
              and np.array_equal(np.fromfile(d / "labels.bin", np.int32),
                                 labels.astype(np.int32))
              and (meta["h"], meta["w"], meta["c"])
              == tuple(DATASETS[name].image_size)
              and meta["count"] == len(labels))
        stores[f"{name}/{split}"] = {"count": meta["count"], "ok": ok}
        if not ok:
            raise AssertionError(f"the {name} {split} import is not what "
                                 f"was written: {meta}")
    return stores


def ring_check(torch, dev, root: Path, depth, fault):
    """Batch 0's raw bytes of an on-disk cifar10 stream on the card,
    held while depth + 2 more batches are drawn through the prefetcher,
    against a fresh stream's batch 0. ``fault``: the loader's ring handed
    over without a copy. Returns whether they are equal."""
    from ddlbench_tpu_torch.config import DATASETS
    from ddlbench_tpu_torch.data import ondisk
    from ddlbench_tpu_torch.data.prefetch import Prefetcher

    kw = dict(train_count=64, test_count=8, seed=4, augment=False)
    data = ondisk.OnDiskData(str(root), DATASETS["cifar10"], 8, dev, **kw)
    if fault:  # the reference's ring of max(2, depth + 1) buffer pairs
        loader, turn = data._loaders["train"], itertools.count()
        ring = [(torch.empty(loader.shape, dtype=torch.uint8),
                 torch.empty(loader.batch_size, dtype=torch.int32))
                for _ in range(max(2, depth + 1))]

        def raw(train=True):
            return loader.next(into=ring[next(turn) % len(ring)])

        data.raw = raw
    held, prepare = [], data.prepare

    def keep(imgs, labels, *a, **k):
        held.append(imgs)
        return prepare(imgs, labels, *a, **k)

    data.prepare = keep
    stream = Prefetcher(data, depth=depth).stream(1)
    for _ in range(depth + 3):
        next(stream)
    stream.close()
    data.close()
    fresh = ondisk.OnDiskData(str(root), DATASETS["cifar10"], 8,
                              torch.device("cpu"), **kw)
    want = fresh.raw()[0]
    fresh.close()
    return torch.equal(held[0].cpu(), want)


def real_augment(torch, dev, root: Path):
    """13b: cifar10's pad-crop + flip and imagenet's flip of a seeded uint8
    batch of AUG_B on the card against the same function on the CPU, at
    AUG_KEYS: the uint8 batch bitwise, the normalised bfloat16 batch
    exactly. Planted faults, each rejected: the flip over H, an exclusive
    randint upper bound (cifar10), and the loader's ring handed over
    without a copy (batch 0 changes after depth + 2 further batches)."""
    from ddlbench_tpu_torch.data import ondisk
    from ddlbench_tpu_torch.ops import threefry

    def flip_over_h(imgs, key, pad, flip):
        m = threefry.bernoulli(threefry.split(key)[1], 0.5,
                               (imgs.shape[0],)).to(imgs.device)
        return torch.where(m[:, None, None, None], imgs.flip(1), imgs)

    def exclusive_randint(imgs, key, pad, flip):
        real = threefry.randint
        threefry.randint = lambda k, s, lo, hi: real(k, s, lo, hi - 1)
        try:
            return ondisk.augment_u8(imgs, key, pad, flip)
        finally:
            threefry.randint = real

    g = torch.Generator().manual_seed(0)
    table = ondisk.normalize_table().to(torch.bfloat16)
    table_card = table.to(dev)
    out = {}
    for name, hwc in (("cifar10", (32, 32, 3)), ("imagenet", (224, 224, 3))):
        pol = ondisk.AUGMENT[name]
        imgs = torch.randint(0, 256, (AUG_B, *hwc), generator=g,
                             dtype=torch.uint8)
        card = imgs.to(dev)
        faults = {"flip_over_h": flip_over_h}
        if pol["pad"]:
            faults["exclusive_randint"] = exclusive_randint
        rejected = dict.fromkeys(faults, False)
        u8_equal = bf16_equal = True
        for epoch, step in AUG_KEYS:
            key = ondisk.augment_key(1, epoch, REAL_STEPS, step)
            want = ondisk.augment_u8(imgs, key, **pol)
            got = ondisk.augment_u8(card, key, **pol)
            u8_equal &= torch.equal(got.cpu(), want)
            bf16_equal &= torch.equal(table_card[got.int()].cpu(),
                                      table[want.int()])
            for f, fn in faults.items():
                rejected[f] |= not torch.equal(fn(card, key, **pol).cpu(),
                                               want)
        out[name] = {"policy": pol, "u8_bitwise": u8_equal,
                     "bf16_exact": bf16_equal, "planted_faults": rejected}
    ring = {f"depth{d}": {"copied_unchanged": ring_check(torch, dev, root, d,
                                                         False),
                          "ring_view_rejected": not ring_check(
                              torch, dev, root, d, True)}
            for d in RING_DEPTHS}
    ok = (all(r["u8_bitwise"] and r["bf16_exact"]
              and all(r["planted_faults"].values()) for r in out.values())
          and all(all(r.values()) for r in ring.values()))
    if not ok:
        raise AssertionError(f"on-device augmentation: {out} {ring}")
    return {"batch": AUG_B, "keys": AUG_KEYS, "datasets": out,
            "ring": ring}


def real_cli(torch, root: Path):
    """13c: the main path at full width: the CLI on an on-disk imagenet
    store of REAL_STEPS x REAL_B train and REAL_TEST_STEPS x REAL_B test
    images (the port's generate_dataset), at prefetch depth 2 and with
    --no-prefetch: images/s, step p50/p95, the input stall and its share
    of the epoch, peak memory; every logged loss finite, the reference's
    lines."""
    import contextlib
    import io

    from ddlbench_tpu_torch import cli
    from ddlbench_tpu_torch.config import DATASETS
    from ddlbench_tpu_torch.data.native_loader import generate_dataset

    spec = DATASETS["imagenet"]
    t0 = time.perf_counter()
    for split, n in (("train", REAL_STEPS), ("test", REAL_TEST_STEPS)):
        generate_dataset(str(root), spec, split, count=n * REAL_B, seed=1)
    gen_s = time.perf_counter() - t0
    store_bytes = sum(f.stat().st_size for f in
                      (root / "imagenet").rglob("*.bin"))
    producer = producer_costs(torch, root, spec)
    runs = {}
    for label, extra in (("prefetch_depth_2", ["--prefetch-depth", "2"]),
                         ("no_prefetch", ["--no-prefetch"])):
        argv = REAL_CLI_ARGS + ["--data-dir", str(root)] + extra
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        lines = out.getvalue().splitlines()
        for line in lines:
            print(line, flush=True)
        kinds = {k: sum(line.startswith(k) for line in lines)
                 for k in ("train | ", "epoch 1/1 done", "valid | ",
                           "valid accuracy: ", "result: ")}
        result = json.loads(lines[-1][len("result: "):])
        losses = [float(re.search(r"loss (\S+)", line).group(1))
                  for line in lines if line.startswith("train | ")]
        if not (rc == 0 and kinds["train | "] == REAL_STEPS // 5
                and all(kinds[k] == 1 for k in kinds if k != "train | ")
                and all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"the real-data CLI ({label}): rc {rc}, "
                                 f"{kinds}, losses {losses}")
        runs[label] = {
            "argv": argv, "train_losses": losses,
            "images_per_sec": result["samples_per_sec"],
            "step_ms_p50": result["step_time_p50_ms"],
            "step_ms_p95": result["step_time_p95_ms"],
            "input_stall_ms": result["input_stall_ms_per_epoch"],
            "stall_frac": result["input_stall_ms_per_epoch"]
            / (1e3 * result["sec_per_epoch"]),
            "sec_per_epoch": result["sec_per_epoch"],
            "valid_history": result["valid_history"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    return {"store_images": (REAL_STEPS + REAL_TEST_STEPS) * REAL_B,
            "store_bytes": store_bytes, "generate_seconds": gen_s,
            "producer_ms_per_batch": producer, "runs": runs}


def producer_costs(torch, root: Path, spec):
    """The host milliseconds a batch of the store costs the producer, on
    this thread with no step running, the mean over an epoch: copying it
    out of the loader's ring into pinned memory (``raw``) and queueing its
    upload, augmentation and normalisation (``prepare``); then the device
    milliseconds of that queued work for the epoch, per batch."""
    from ddlbench_tpu_torch.data.ondisk import OnDiskData

    data = OnDiskData(str(root), spec, REAL_B, torch.device("cuda"),
                      seed=1, dtype=torch.bfloat16)
    raw_s = prep_s = 0.0
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for step in range(REAL_STEPS):
        t0 = time.perf_counter()
        imgs, labels = data.raw()
        t1 = time.perf_counter()
        data.prepare(imgs, labels, 1, step)
        raw_s += t1 - t0
        prep_s += time.perf_counter() - t1
    end.record()
    torch.cuda.synchronize()
    data.close()
    return {"raw_host": 1e3 * raw_s / REAL_STEPS,
            "prepare_host": 1e3 * prep_s / REAL_STEPS,
            "device": start.elapsed_time(end) / REAL_STEPS}


def real_accum(torch, dev):
    """13d: resnet50/imagenet, one step of ACCUM_K micro-steps of
    ACCUM_MICRO_B rows (grad_accum_steps), float64, on the card against
    the CPU: loss, every gradient leaf and every running statistic within
    IMAGE_F64_RTOL; the K-step must differ from the one-batch step."""
    import copy

    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.models.zoo import get_model

    cfg = RunConfig(benchmark="imagenet", arch="resnet50", seed=0,
                    batch_size=ACCUM_MICRO_B, grad_accum_steps=ACCUM_K,
                    compute_dtype="float32")
    cfg.validate()
    initial = get_model(cfg.arch, cfg.benchmark, seed=0)
    x, y = make_synthetic(cfg.dataset(), cfg.global_batch(),
                          torch.device("cpu"), seed=0).batch(0, 0)
    cpu = image_step(torch, copy.deepcopy(initial).double(), x.double(), y,
                     cfg, None)
    card = f64_card_step(torch, initial, x, y, cfg, dev)
    rec = f64_agreement(card, cpu)
    one = image_step(torch, copy.deepcopy(initial).double(), x.double(), y,
                     RunConfig(benchmark="imagenet", arch="resnet50",
                               batch_size=cfg.global_batch()), None)
    rec["one_batch_loss"] = one[0]
    if not (rec["ok"] and one[0] != cpu[0]):
        raise AssertionError(f"grad accumulation on the card: {rec}")
    return {"model": cfg.arch, "global_batch": cfg.global_batch(),
            "grad_accum_steps": ACCUM_K, "dtype": "float64",
            "rtol": IMAGE_F64_RTOL, **rec}


def phase_real_data(torch, dev):
    """Real image data on the card (phase 13 of the docstring)."""
    import tempfile

    from ddlbench_tpu_torch.data import native_loader

    t0 = time.perf_counter()
    native_loader.build()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        root = Path(tmp)
        emit({"phase": "real_ingest", "loader_build_seconds": build_s,
              "stores": real_ingest(root)})
        emit({"phase": "real_augment",
              **real_augment(torch, dev, root / "ring")})
        emit({"phase": "real_data_cli", **real_cli(torch, root / "store")})
    emit({"phase": "real_accum", **real_accum(torch, dev)})
    torch.cuda.empty_cache()
    return {"seconds": time.perf_counter() - t0}


def zoo_faults(torch, dev, cpu_steps, batches, cfgs, initial):
    """14's planted faults, each on the card against its arch's CPU float64
    step, each rejected: AvgPool excluding the padding (nasnet),
    densenet's concat in the wrong order, and resnext's grouped kernel
    with its group axes swapped."""
    import torch.nn.functional as F

    from ddlbench_tpu_torch.models import extra, layers

    def avg_excluding(self, x):
        return F.avg_pool2d(x, self.window, self.stride,
                            padding=self.window // 2,
                            count_include_pad=False)

    def dense_reversed(self, x):
        feats = x
        for i in range(self.n_layers):
            y = F.relu(getattr(self, f"l{i}_bn1")(feats))
            y = layers.conv2d(y, getattr(self, f"l{i}_c1"))
            y = F.relu(getattr(self, f"l{i}_bn2")(y))
            y = layers.conv2d(y, getattr(self, f"l{i}_c2"))
            feats = torch.cat([y.to(feats.dtype), feats], dim=1)
        return feats

    def groups_swapped(self, x):
        w = self.c2
        swapped = w.reshape(self.groups, w.shape[0] // self.groups,
                            *w.shape[1:]).transpose(0, 1).reshape(w.shape)
        y = F.relu(self.bn1(layers.conv2d(x, self.c1)))
        y = F.relu(self.bn2(layers.conv2d(y, swapped, self.stride,
                                          self.groups)))
        y = self.bn3(layers.conv2d(y, self.c3))
        sc = (x if self.proj is None
              else self.bnp(layers.conv2d(x, self.proj, self.stride)))
        return F.relu(y + sc)

    out = {}
    for name, arch, target, fault in (
            ("avgpool_excluding_padding", "nasnet", layers.AvgPool,
             avg_excluding),
            ("densenet_concat_reversed", "densenet121", extra.DenseBlock,
             dense_reversed),
            ("resnext_group_axes_swapped", "resnext50", extra.ResNeXtBlock,
             groups_swapped)):
        original = target.forward
        target.forward = fault
        try:
            rec = f64_agreement(f64_card_step(
                torch, initial[arch], *batches[arch], cfgs[arch], dev),
                cpu_steps[arch])
        finally:
            target.forward = original
        rec["rejected"] = not rec.pop("ok")
        out[name] = {"arch": arch, **rec}
    if not all(r["rejected"] for r in out.values()):
        raise AssertionError(f"a planted zoo fault passed: {out}")
    return out


def phase_image_zoo(torch, dev):
    """The rest of the image zoo (phase 14 of the docstring)."""
    import copy

    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.models.zoo import get_model

    t0 = time.perf_counter()
    checks, rows = {}, []
    cpu_steps, batches, cfgs, initial = {}, {}, {}, {}
    for arch in ZOO_ARCHS:
        cfg = RunConfig(benchmark="imagenet", arch=arch, seed=0,
                        compute_dtype="float32")
        cfg.validate()
        model = get_model(arch, cfg.benchmark, seed=0)
        x, y = make_synthetic(cfg.dataset(), ZOO_CHECK_B,
                              torch.device("cpu"), seed=0).batch(0, 0)
        tc = time.perf_counter()
        cpu = image_step(torch, copy.deepcopy(model).double(), x.double(),
                         y, cfg, None)
        cpu_s = time.perf_counter() - tc
        rec = f64_agreement(f64_card_step(torch, model, x, y, cfg, dev), cpu)
        checks[arch] = {"width": "imagenet", "batch": ZOO_CHECK_B,
                        "cpu_float64_step_s": cpu_s, **rec}
        if not rec["ok"]:
            raise AssertionError(f"{arch}: the card's float64 step "
                                 f"disagrees with the CPU's: {rec}")
        if arch in ("nasnet", "densenet121", "resnext50"):
            cpu_steps[arch], batches[arch] = cpu, (x, y)
            cfgs[arch], initial[arch] = cfg, model
        torch.cuda.empty_cache()
        rows.append(image_bench(torch, ["--arch", arch] + IMAGE_SHORT_ARGS))
    faults = zoo_faults(torch, dev, cpu_steps, batches, cfgs, initial)
    emit({"phase": "image_zoo", "float64_rtol": IMAGE_F64_RTOL,
          "floor": IMAGE_FLOOR, "checks": checks, "planted_faults": faults,
          "rows": [{k: r[k] for k in (
              "metric", "value", "step_time_p50_ms", "step_time_p95_ms",
              "stall_frac", "peak_memory_gib", "batch", "dtype",
              "channels_last", "prefetch_depth")} for r in rows],
          "seconds": time.perf_counter() - t0})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    try:
        from ddlbench_tpu_torch.device import resolve_device
        from ddlbench_tpu_torch.ops import _build
        from ddlbench_tpu_torch.ops import flash_attention as fa
        from ddlbench_tpu_torch.ops import fused_xent as fx
        from ddlbench_tpu_torch.ops import paged_decode as pd
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    phase_build(_build)

    worst, timed = phase_kernels(torch, pd, dev)
    launches = phase_serve(torch, dev)
    launches.update(phase_serve_levers(torch, pd, dev))
    phase_serve_slo(torch, pd, dev)
    phase_serve_fleet(torch, pd, dev)
    phase_serve_disagg(torch, pd, dev)
    launches["paged_attention"] += phase_decode(torch, pd, fa, dev)
    phase_profile(torch, dev)
    flash_worst = phase_flash_kernels(torch, fa, dev)
    flash_timed = phase_flash_times(torch, fa, dev)
    fx_worst = phase_fxent_kernels(torch, fx, dev)
    fx_timed = phase_fxent_times(torch, fx, dev)
    train_launches, strategy, data = phase_train(torch, fa, fx, dev)
    phase_seq2seq(torch, fa, fx, dev)
    for more in (phase_moe_train(torch, fa, fx, dev),
                 phase_lstm_train(torch, fa, fx, dev)):
        for name, n in more.items():
            train_launches[name] += n
    b7, b1 = phase_moe_decode(torch, pd, fa, dev)
    launches["paged_attention"] += b7
    train_launches["flash_fwd"] += b1
    phase_text_data(torch, dev)
    phase_tiny_dispatch(torch, dev)
    phase_train_profile(torch, strategy, data)
    del strategy, data
    torch.cuda.empty_cache()
    headline = phase_image(torch, dev)
    real = phase_real_data(torch, dev)
    keys = ("value", "input_stall_ms_per_epoch", "stall_frac",
            "step_time_p50_ms", "step_time_p95_ms", "run_seconds",
            "peak_memory_gib", "prefetch_depth")
    inline = image_bench(torch, ["--prefetch-depth", "0"])
    emit({"phase": "image_bench_prefetch", "note": "tools/bench's headline "
          "record at prefetch depth 2 (phase 12's) and at 0",
          "depth_2": {k: headline[k] for k in keys},
          "depth_0": {k: inline[k] for k in keys}})
    emit({"phase": "real_data_seconds", **real})
    phase_image_zoo(torch, dev)
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})

    def row(name, source, replaces, n, err, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    emit({"kernels": [
        row(name, SOURCE, KERNELS[name], launches[name], worst[name],
            timed[name]) for name in KERNELS] + [
        row(name, FLASH_SOURCE, FLASH_KERNELS[name], train_launches[name],
            flash_worst[name], flash_timed[name])
        for name in FLASH_KERNELS] + [
        row(name, FX_SOURCE, FX_KERNELS[name], train_launches[name],
            fx_worst[name], fx_timed[name]) for name in FX_KERNELS]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
