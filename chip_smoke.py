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
             logits), and at the first token where each int8 stream of
             the card leaves the CPU's (ROADMAP C.9), teacher-forced on
             the shared prefix through the serving path: the card's int8
             logits' top-2 margin, the two tokens' gap, the int8 pool's
             perturbation of the card's logits (max |int8 - float32|)
             and the card's int8 logits' distance from the CPU's
             ("int8_forks", reported; only the forked steps are read);
             then wall_tokens_per_s and decode_step_ms of the command
             sampled against the same command greedy, in turns (greedy,
             sampled) over a float32 pool, beside the card's nvidia-smi
             line, with sample_ms (the host's time for one draw).
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
             (1, 2), with wall_tokens_per_s and decode_step_ms
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
             1:1), and the ledger off against --scrub 0 and --scrub 4
             (off, 0, 4), with wall_tokens_per_s
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
             run (float32, the prompt and 32 decoded positions) under
             torch.profiler: the device's busy share, launches and top
             kernels.
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
             warpgroup), sp_train's two ring blocks (B 16, 512
             queries over 512 keys: rank 1's fully visible block at
             q_offset 512, and the diagonal) and the prefix ring's block
             above the diagonal (seq2seq_s under sp at world 4: B 64, 64
             queries at offset 0 over 64 keys at offset 64, prefix 128,
             visible only through the prefix). Tolerance:
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
             the backward kernels on that query block against theirs.
             Last, flash_attention_lse on the kernels against its plain
             version on the three ring blocks under random cotangents of o
             and of the lse (which shifts delta), at the same
             tolerances: in float32 end to end (o, lse, dq, dk, dv); in
             bfloat16 o and lse, and the backward kernels against the
             plain backward on the plain forward's lse and shifted delta
             (shared residuals, as above). The
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
             resnet50 -e 1 --steps-per-epoch 10`` in-process: its train,
             epoch, valid and summary lines and the result line, every
             logged loss finite. (e) image_bench: tools/bench's headline
             record (resnet50/imagenet, B 128, 30 steps, 5 warm-up, one
             loop: --repeats 1), then image_models: one short bench row
             (B 32, 2 warm-up and 3 steps) for each of resnet18, vgg11
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
             bf16, channels_last, 2 warm-up and 3 steps): images/s, step
             p50/p95, peak memory.
15. dp_train — data parallel (parallel/dp.py) on the one card: ranks are
             processes (distributed.spawn), spawned after the build, at
             world 2 over gloo with both ranks on cuda:0 (NCCL refuses two
             ranks on one card; gloo takes the CUDA tensors of all-reduce
             and broadcast, and reduce-scatter and all-gather go through
             pinned host memory, which the line records), then at world 1
             over NCCL in the script's own process (nccl_world1).
             transformer_s / synthtext at full width, bf16, the
             fused head, "auto" attention, a global batch of 32 rows (16 a
             rank), from one init (seed 0) and one set of batches, three
             steps each of six engine runs: replicated f32, sharded
             (--dp-shard-update), overlapped (sharded, --comm-buckets 4),
             bf16 wire, int8 wire, and int8 again. Per engine: losses, ms
             a step (steps 2-3) and global tokens/s. (a) step 1 of
             replicated dp against single on the same 32 rows: the loss
             within 1e-3 relative; each gradient leaf within 1e-6
             (relative L2) of single's on the two ranks' 16-row halves
             combined, and within 1e-3 of the 32-row step's or twice the
             halves' own distance to it (bf16 rounds a 16-row step apart
             from a 32-row one). (b) sharded and overlapped against
             replicated after three steps: the parameters bitwise, or
             within 1e-6 relative L2; the line says which. (c) bf16 and
             int8 losses finite and within rtol 0.05 of replicated f32's;
             the two int8 runs bitwise equal. (d) replicated dp at NCCL
             world 1 against single, each step's loss within 1e-6 of
             single with dp's update formulas (single through torch.optim
             printed beside it). (e) every rank launches B1-B6 8/8/8/1/1/1
             times a step in every engine run, with no attention call on
             the plain path. Both ranks' losses equal.
16. dp_image — sync-BN on the card. resnet18 / cifar10 in float64,
             replicated dp at world 2 (shared card), one step on 8 rows a
             rank: the loss, every gradient leaf and every running
             statistic within 1e-9 of single on the 16 rows (floored as in
             12). Then resnet50 / imagenet, bf16, B 128, replicated dp at
             NCCL world 1 and single, 2 warm-up and 10 timed steps each:
             images/s, finite losses, and a torch.profiler breakdown of 3
             more steps each (busy share, launches, time by kernel group):
             the cost of the dp machinery on one card.

17. pipe_train — the pipelines (parallel/gpipe.py, pipeline_rt.py,
             pipedream.py) through make_strategy, every one of four stages
             on the one card (shared_card): transformer_s / synthtext at
             full width, bf16, the fused head, "auto" attention, from seed
             0's weights; gpipe fill-drain and zero-bubble at mb 4 x M 8,
             pipedream at the global 64 (mb 8 x M 8); three steps each
             (the first a warm-up), every B1-B6 counter zeroed before the
             three rows and read after: (d) each kernel's launches exactly
             what the events imply (pipe_expected: under zero-bubble dh
             and dW once per last-chunk microbatch, each in its own event)
             and no attention call on the plain path. (a) gpipe's step 1
             against single's on the same 32 rows: the loss within 1e-4
             relative, the update (parameters after minus before) within
             1e-2 relative L2 (bf16: 4-row microbatches round apart from
             one 32-row batch). (b) zero-bubble's step gradient against
             fill-drain's in float32 within 1e-6 relative L2 (only the
             order of the microbatch sums differs). (c) pipedream's first
             two steps against a sequential replay of the same events on
             the card (pipedream_replay, written apart from the engine:
             weight versions per microbatch, per-microbatch momentum SGD),
             the parameters' change within 1e-3 relative L2. (e) tokens/s
             of each row beside the nvidia-smi line. Then hetero_train:
             --stage-replication 2,1 (parallel/hetero.py: one process
             over three "devices" of the card, stage 0's two replicas
             each running half of every microbatch's rows), gpipe at mb
             4 x M 8 and pipedream at the global 32 (mb 4 x M 8), bf16,
             three steps each: each kernel's launches what every
             replica's events imply (hetero_expected), none on the plain
             path; tokens/s beside the nvidia-smi line; float32 on
             transformer_s cut to 2 blocks and 128 tokens (mb 2 x M 2):
             the plan's step against the uniform 2-stage gpipe's on the
             card (every update within 1e-4 relative L2) and against the
             same plan's step on the CPU (the loss within 1e-5, every
             update within 1e-3), gpipe and pipedream.
17b. plan_train — profile -> partition -> plan (profiler/profile.py,
             partition/optimizer.py and its C++ core, partition/planner.py,
             profiler/actlog.py) on transformer_s / synthtext at full
             width, seed 0. (a) profile_model at pipe_train's micro-batch
             (4 x 1 024) in "flops" mode on the card equals, node for node,
             the same call on the CPU; in "time" mode on the card (CUDA
             events, 2 warm-ups and 5 samples a node) every block's
             forward and backward time > 0 and B1-B3 launched exactly what
             the samples imply (none on the plain path); the nodes' sum
             printed beside a timed float32 single step of the same rows.
             (b) --auto-partition --pipe-schedule 1f1b --pipe-costs profile
             on four stages of the card through make_strategy: the plan,
             the executed bounds and the cost vectors printed, bf16 steps
             (one warm-up, two timed) beside the default balanced split's
             unit-cost 1f1b in the same process, the plan's launches what
             its events imply; its float32 step at the same bounds and
             vectors, cut to mb 2 x M 4 on 128 tokens, against the CPU's
             (the loss within 1e-5, every update within 1e-3 relative
             L2). (c) --plan auto at world 4 in flops mode with the H100
             HardwareModel (hbm_bytes printed beside the card's
             total_memory): the winner and every candidate printed; a
             winner that runs in one process runs here, one that spawns
             ranks runs in the sharded spawn (25b). (d) one float32
             activation capture under single (train/loop's logger) on the
             card and on the CPU, 2 rows x 128 tokens: equal keys, every
             array within 1e-3 of the CPU array's largest magnitude, B1-B3
             one launch a block.
18. pipe_image — resnet50 / imagenet on four stages of the one card. (a)
             gpipe's step in float64 at mb 2 x M 2 on the card against the
             same step on the CPU: the loss, every gradient leaf and every
             running statistic within 1e-9 (BatchNorm normalises each
             microbatch alone, so the step is not single's). Then gpipe at
             mb 24 x M 12 and pipedream at the global 128 (mb 16 x M 8),
             bf16, three steps each: (c) pipedream's first two against the
             replay, as in 17; (e) images/s beside the nvidia-smi line.
             Then packed_chain: inception and nasnet / cifar10 under
             gpipe at 2 stages of the card, each split over its
             node-granular packed chain (models/branchy.py, every node a
             layer, the tensors crossing a cut packed into one
             boundary), one float64 step at mb 2 x M 2 on the card
             against the same step on the CPU: the loss, every gradient
             leaf and running statistic within 1e-9.
19-21. sp_train, ep_train, fsdp_train — the sharded one-program
             strategies (parallel/sp.py, ep.py, sharded.py) through
             make_strategy on spawned ranks: world 2 on the one card over
             gloo (ranks 0-1 of a world-4 spawn whose four ranks first run
             26; sp's K/V all-gather, ep's all_to_all, fsdp's
             reduce-scatter and all-gather staged through pinned host
             memory), then sp at
             NCCL world 1. sp: transformer_s / synthtext at full width
             (T 1 024 in two 512-token shards); ep: transformer_moe_s at
             capacity factor 8 = E (no drops) and aux weight 0; fsdp:
             transformer_s; float32 (one compared step) and bfloat16 (one
             compared step and 1 timed one), "auto" attention, the fused
             head, SGD, a global batch of 8 rows. (a) rank 0 holds the
             step against single's on the same rows: float32, the loss
             within 1e-5 relative and each leaf's update within 1e-4
             relative L2; bfloat16, the loss within 2e-3 and each update
             within max(1e-2, twice single's own bf16-to-f32 distance).
             ep's float32 step routes by its routers; single's float32
             step and both bfloat16 compared steps are pinned to that
             routing (pinned_experts), so every ep gap is rounding, held
             to the dense cells' bars; the tokens each router would have
             sent elsewhere are reported.
             (b) sp's float32 step at depth 2 on the card against the
             same step of two gloo ranks on the CPU (the plain versions):
             the loss within 1e-5, each update within 1e-3. (c) every
             rank's launches: B1-B3 once per attention layer a step
             times rank + 1 under sp (n(n+1)/2 over the ranks: a causal
             rank runs its diagonal block and the blocks before it), once
             under ep and fsdp; B4-B6 once a step; no attention call on
             the plain path. fsdp: each rank holds half of every layer's
             packed parameters (plus at most one pad element a layer) and
             of its optimizer state, and gathers every block and the
             head again for each step's backward; resnet50 / imagenet in
             float64 at 4 rows (sync-BN) against single's step on the same
             rows: the loss, every gradient leaf and every running
             statistic within 1e-9 relative (IMAGE_F64_RTOL). Losses, ms
             a step and global tokens/s per cell; the two ranks' losses
             equal.
22. serve_tp — tensor-parallel serving: servebench's serve command
             (transformer_s at full width, closed loop, 16 requests) at
             --serve-tp 1 and 2, over a float32 and an int8 pool, the
             paged counters zeroed before each run. At tp 2 one replica
             is two Megatron shards walked in one process on the one
             card, each attending its 4 heads (B7, B8 and their int8
             branches on the shard's contiguous pool slice): every
             request completed, no paged call on the plain path, both
             kernels of the pool's type launched and none of the other
             type, float32 launches exactly twice tp 1's, the float32
             streams bitwise tp 1's and two of them held by the
             teacher-forced check, the pool's bytes tp 1's and the int8
             pool a quarter of the float32 one, serve_tp in the row;
             the int8 streams at tp 2 held to the float32 ones of the
             same width as serve_levers holds int8 (each first flip
             within the int8 noise, through tp-2 engines), and that
             noise on every stream's tokens within INT8_TP_NOISE_RATIO
             of tp 1's; tokens/s of tp 2 beside tp 1's (not a scaling
             figure: the host walks both shards on one card).
23-24. tpp_train, tp_train — tensor parallelism in training, in the
             world-2 subgroup of 19-21's spawn (a spawn's start-up costs
             tens of seconds): tpp (-f gpipe --tp-size 2: 2 stages x 2
             shards, each rank walking fill-drain over its two stages on
             the card, micro-batch 2 x 2 microbatches of 1 024 tokens,
             the unfused head) and tp (-f tp: the batch of 4 rows
             replicated, Megatron-sliced blocks, every other leaf
             gathered on use, the fused head), transformer_s at full
             width (each shard 4 heads of dh 64), float32 (one compared
             step; tp also one update) and bfloat16 (one compared step
             and 1 timed one). (a) rank 0 holds the step against -f
             gpipe at 2 stages (tpp) or single (tp) on the same rows, alone
             on the card: float32, the loss within 1e-5 relative and each
             gradient leaf (whole: the shards' slices gathered) within
             1e-5 relative L2, and tp's update too: the momentum buffer
             within 1e-5, every parameter after the step (its gathered
             parts and Megatron slices whole) within 1e-5, and the step
             the parameters took (after minus before) within 4e-4, ten
             times the new weights' float32 rounding;
             bfloat16, the sharded cells' bars. (c) every rank's launches
             exactly what the steps imply (tpp: pipe_expected's, B4-B6
             none; tp: B1-B3 8 and B4-B6 1 a step), no attention call on
             the plain path; the ranks' losses equal. tp's resnet18 /
             cifar10 step in float64 at 4 rows against single's within
             1e-9 relative. Host-staged gloo on one card: ms a step and
             tokens/s are not scaling figures.
25. hybrid_train — hybrid PP x DP in the same world-2 spawn: -g 4 as
             --dp-replicas 2 x 2 stages, every rank one replica walking
             its two stages on the card, transformer_s at full width,
             micro-batch 2 x 2 microbatches a replica (a global batch of
             8 rows), bf16, "auto" attention, the fused head, through
             make_strategy: fill-drain, 1f1b, pipedream and gpipe
             --dp-shard-update --comm-buckets 2 (hybrid PP x ZeRO-1),
             two steps each (the first a warm-up): (c) every rank's
             launches what its events imply (pipe_expected), none on the
             plain path, the ranks' losses equal; ms a step and tokens/s
             beside the nvidia-smi line; ZeRO-1's optimizer bytes a rank
             half of every chunk's padded row and half the replicated
             engine's within the pads. (a) float32, transformer_s cut to
             2 blocks and 128 tokens: each runtime's step on the card
             against the same step of the same ranks on the CPU (the
             loss within 1e-5, every update within 1e-3); (b) ZeRO-1's
             step against the replicated hybrid's on the card (every
             update within 1e-6); resnet18 / cifar10 in float64, the
             fill-drain hybrid's step on the card against the CPU's: the
             loss, every replica-averaged gradient and every averaged
             running statistic within 1e-9. Host-staged gloo on one
             card: the rows price the schedules' work and the wire, not
             scaling.
25b. plan_auto_train — the --plan auto winner of 17b (c) when it spawns
             ranks (its replicas), in the sharded spawn after tpp3d: rank
             0 solves and broadcasts the rewrite (planner.resolve_auto_plan)
             to all four ranks, the ranks the plan spawns build it through
             make_strategy and run one warm-up and two timed bf16 steps of
             pipe_train's 32 rows: every rank's resolved config equals the
             main process's solve, its launches what its events imply,
             none on the plain path, finite losses equal on the ranks.
26. tpp3d_train — 3-D tpp (-g 8 as --dp-replicas 2 x 2 stages x
             --tp-size 2: the reference's ('data', 'stage', 'model')
             mesh), first in the sharded spawn, which runs at world 4 on
             the shared card for it: rank d * 2 + t is shard t of replica
             d (its tp and data groups made by make_strategy), walking
             fill-drain over its two stages, transformer_s at full width
             and depth, micro-batch 2 x 2 microbatches a replica (8 rows
             of 1 024), the unfused head; float32 (one compared step) and
             bfloat16 (one compared step and 1 timed one). (a) on rank 0:
             the compared step's gradient (summed over the replicas / 2,
             the shards' slices gathered) against 2-D tpp's (-f gpipe
             --tp-size 2 at micro-batch 4, ranks 0-1) on the same rows,
             at tpp_train's bars; (b) every rank's float32 step on
             transformer_s cut to 2 blocks and 128 tokens on the card
             against the same step of the same four ranks on the CPU (the
             plain versions): the loss within 1e-5, its update within 1e-4
             relative L2; (c) every rank's launches what its fill-drain
             events imply (pipe_expected, B4-B6 none), none on the plain
             path; the four ranks' losses equal; ms a step and tokens/s
             beside the nvidia-smi line, peak memory a rank.
27. remat_train — remat_layers under fsdp and tp on ranks 0-1: one
             float32 step of each on 8 rows of transformer_s with remat
             off, then on, from the same weights: the loss within 1e-5
             and every leaf's update within 1e-5 relative L2 (bitwise
             equality reported), (c) B1 launches twice a layer with remat
             (the recompute; B2-B6 unchanged), none on the plain path,
             fsdp's re-gathers the same (every block and the head, once:
             the recompute runs on the backward's gather), and each
             step's peak memory (printed, not gated); resnet50 / imagenet
             in float64 at 4 rows, fsdp (sync-BN, beside fsdp_train's
             image row) and single on rank 0, with remat against
             without: every gradient leaf within 1e-12 and the running
             statistics bitwise (the recompute updates none).
28. moe_dp, moe_fsdp — transformer_moe_s at full width (8 experts) at
             capacity factor 1.25 and aux weight 0.01, float32, 8 rows,
             routed over the global batch (models/moe.global_routing): the
             replicated dp engine in dp_train's world-2 spawn, fsdp on the
             sharded spawn's ranks 0-1, the fused head. One compared step
             (by the ranks' own routers) and one update, against single
             on the same rows pinned to the ranks' routing (gathered): the
             loss within 1e-5, every gradient leaf within 1e-4 and every
             update within 4e-4 relative L2, the dropped tokens summed
             over the ranks equal to single's and more than none; (c)
             B1-B3 8 and B4-B6 1 a step on every rank, none on the plain
             path; single's own router flips against the pinned routing
             reported, and the update step's ms beside single's on the
             same rows (printed, not gated: each rank's expert buffer
             holds the global capacity).

Then it prints the script's wall time from the build on, the kernels table
(one JSON object: the paged kernels over
float pools and over int8 pools, the flash and the fused-head kernels; the
int8 rows' launches are serve_levers (b)'s, the float decode row's serve's
plus decode (a)'s and moe_decode's; the flash and fused-head rows' are
train's, moe_train's, lstm_train's, every dp_train rank's, pipe_train's,
hetero_train's and every sp_train, ep_train, fsdp_train, tpp_train,
tp_train, hybrid_train, tpp3d_train, remat_train, moe_dp and moe_fsdp
rank's,
the flash forward's moe_decode's too; serve_tp's tp-2 runs add to the four
paged rows), the card's name and power
limit as nvidia-smi reports them, and, last, the device record.
Without a CUDA device, or away from the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import io
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
# the same sampler's (temperature, top-k, seed: SLO_TRAFFIC's --seed)
SLO_DRAW = (0.8, 40, 0)
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
    # sp_train's ring at world 2 (T 1024 in two 512-token shards): rank 1's
    # fully visible block at absolute offsets, and every rank's diagonal
    (16, 8, 512, 512, 512, 0, 0),
    (16, 8, 512, 512, 0, 0, 0),
    # the prefix ring of seq2seq_s / synthmt at world 4 (T 256 in 64-token
    # shards, prefix 128): rank 0's queries see rank 1's block, above the
    # diagonal, only through the prefix
    (64, 8, 64, 64, 0, 64, 128),
)
# flash_attention_lse with a random lse cotangent (the delta shift) on
# the rings' three block shapes above, against its plain version
FLASH_LSE_CASES = FLASH_CASES[-3:]
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
                  "1", "--steps-per-epoch", "10"]
# tools/bench's headline record, one timed loop of its 30 steps (its
# default is the median of 3: the script's time is shared)
HEADLINE_ARGS = ["--repeats", "1"]
IMAGE_SHORT_ARCHS = ("resnet18", "vgg11", "mobilenetv2")
IMAGE_SHORT_ARGS = ["--benchmark", "imagenet", "--batch-size", "32",
                    "--warmup", "2", "--steps", "3", "--repeats", "1"]
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
    pages 1.., the paged chunk kernel reading back what it wrote; at tp >
    1 on every shard, the engine's own walk)."""
    page, T = engine.page, len(toks)
    npl = -(-T // page)
    dev = engine.device
    table = torch.zeros((1, engine.npg_max), dtype=torch.int32, device=dev)
    table[0, :npl] = torch.arange(1, npl + 1, dtype=torch.int32)
    h = torch.zeros((1, npl * page), dtype=torch.int32, device=dev)
    h[0, :T] = torch.tensor(toks, dtype=torch.int32)
    with torch.no_grad():
        h = engine._walk(engine.model.layers, engine.pools, table, h,
                         "serve_prefill", 0, npl)
    return h[0, :T].float()


def divergences(torch, model, dev, reqs, toks_a, toks_b, tp=1):
    """Where an int8 stream first leaves its float32 stream, the two
    tokens' logit gap through the float32 serving path on the shared
    prefix, and the int8 pool's perturbation of that position's logits
    (the largest |int8 - float32| over the vocabulary, both through the
    serving path at tensor-parallel width ``tp``). A flip is within the
    int8 noise when the gap is at most twice that perturbation."""
    from ddlbench_tpu_torch.config import ServeConfig
    from ddlbench_tpu_torch.serve.engine import ServeEngine

    engines = {kv: ServeEngine(model, ServeConfig(kv_dtype=kv, tp=tp), dev)
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


def int8_noise(torch, model, dev, seqs, tp):
    """The int8 pool's perturbation of the logits on each token list of
    ``seqs`` (by rid): the largest |int8 - float32| over every position
    and the vocabulary, both through the serving path at tensor-parallel
    width ``tp``."""
    from ddlbench_tpu_torch.config import ServeConfig
    from ddlbench_tpu_torch.serve.engine import ServeEngine

    f32, i8 = (ServeEngine(model, ServeConfig(kv_dtype=kv, tp=tp), dev)
               for kv in ("float32", "int8"))
    return {rid: (serve_logits(torch, i8, toks)
                  - serve_logits(torch, f32, toks)).abs().max().item()
            for rid, toks in seqs.items()}


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
    path, {rid: tokens}, the requests)."""
    from ddlbench_tpu_torch.tools import servebench

    path = str(Path(trace_dir) / f"slo_{len(os.listdir(trace_dir))}.json")
    args = servebench.build_parser().parse_args(
        argv + ["--kv-dtype", kv, "--trace", path] + list(extra))
    (rec, server, reqs), = servebench.run(args, model, dev)
    return rec, server, path, {f["rid"]: f["tokens"]
                               for f in server.finished}, reqs


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


def int8_fork_margins(torch, card_model, cpu_model, dev, reqs, card,
                      cpu):
    """ROADMAP C.9: at the first token where each int8 stream of the card
    leaves the CPU's, teacher-forced on the shared prefix through the
    serving path: the card's int8 logits' top-2 margin and the two
    tokens' gap in them, the int8 pool's own perturbation of the card's
    logits (the largest |int8 - float32| over the vocabulary) and the
    card's int8 logits' distance from the CPU's (the largest |card -
    CPU|). A fork lies inside the int8 noise when the card's int8 logits
    differ from the CPU's by no more than the int8 pool perturbs them:
    the card then computes the CPU's int8 function, and the sampled draw
    fell on a boundary that noise of that size moves; the sampler's own
    draw (SLO_DRAW, the token's counter-based uniform) from each side's
    logits is replayed to see whether it gives that side's token."""
    from ddlbench_tpu_torch.config import ServeConfig
    from ddlbench_tpu_torch.serve.engine import ServeEngine, sample_token

    engines = {(where, kv): ServeEngine(model, ServeConfig(kv_dtype=kv), d)
               for where, model, d in (("card", card_model, dev),
                                       ("cpu", cpu_model,
                                        torch.device("cpu")))
               for kv in ("float32", "int8") if (where, kv) != ("cpu",
                                                                "float32")}
    out = {}
    for rid, i in first_forks(card, cpu).items():
        toks = reqs[rid].prompt.tolist() + cpu[rid][:i]
        z8, z32, z8_cpu = (serve_logits(torch, engines[key], toks)[-1].cpu()
                           for key in (("card", "int8"), ("card", "float32"),
                                       ("cpu", "int8")))
        top = z8.topk(2).values
        a, b = card[rid][i], cpu[rid][i]
        noise = (z8 - z32).abs().max().item()
        dist = (z8 - z8_cpu).abs().max().item()
        draws = [sample_token(z.double().numpy(), *SLO_DRAW, rid, i)
                 for z in (z8, z8_cpu)]
        out[rid] = {"index": i, "card_top2_margin": (top[0] - top[1]).item(),
                    "forked_tokens_gap": (z8[a] - z8[b]).item(),
                    "int8_logit_noise": noise, "card_vs_cpu_int8": dist,
                    "within_noise": dist <= noise,
                    "draws_give_each_sides_token": draws == [a, b]}
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
        _, _, _, base, _ = slo_run(model, dev, "float32", trace_dir)
        _, server, _, ev, _ = slo_run(model, dev, "float32", trace_dir,
                                   argv=SLO_EVICT_ARGS)
        return not slo_regenerates(base, ev, server)

    def caught_a():
        rec, _, _, _, _ = slo_run(model, dev, "float32", trace_dir)
        return bool(slo_row_diff(rec, cpu_rec))

    def caught_c():
        rec, server, _, _, _ = slo_run(model, dev, "float32", trace_dir)
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
            rec, server, path, toks, reqs = slo_run(card_model, dev, kv,
                                                    tmp)
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
            _, _, _, toks2, _ = slo_run(card_model, dev, kv, tmp)
            rec_ev, server_ev, _, toks_ev, _ = slo_run(
                card_model, dev, kv, tmp, argv=SLO_EVICT_ARGS)
            cpu_rec, cpu_server, _, cpu_toks, _ = slo_run(cpu_model, cpu,
                                                          kv,
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
            if kv == "int8":
                # C.9, measured: only the forked steps are read
                pools["int8_forks"] = int8_fork_margins(
                    torch, card_model, cpu_model, dev, reqs, toks, cpu_toks)
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
        # turns (greedy, sampled), both warm
        turns = {"sampled": [], "greedy": []}
        for name in ("greedy", "sampled"):
            rec, _, _, _, _ = slo_run(
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
    # 1 against 2 replicas on the card, warm, in turns (1, 2): the
    # serve_slo command greedy over a float32 pool
    turns = {"1": [], "2": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        slo_run(card_model, dev, "float32", tmp, argv=SLO_GREEDY_ARGS)
        for n in ("1", "2"):
            rec, _, _, _, _ = slo_run(card_model, dev, "float32", tmp,
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
                ("layout", layouts, ("1", "2", "1:1")),
                ("integrity", ledger, ("off", "scrub_0", "scrub_4"))):
            for n in order:
                rec, server, _, _, _ = slo_run(card_model, dev, "float32",
                                               tmp, extra=opts[n],
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
# the paged beam profile's decoded positions (each a step like the
# others; the profiler's parse grows with the launches)
DECODE_PROFILE_NEW = 32
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
    """Where a paged beam run's time goes (float32 cache, warm; the prompt
    and DECODE_PROFILE_NEW positions of the ``T``): the device's busy
    share of its wall time under torch.profiler, its launches, and the
    device time of the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    T = min(T, src.shape[1] + DECODE_PROFILE_NEW)

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
    del q, k, v, do, o, lse, tail
    lse_checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_LSE_CASES:
            errs = flash_lse_compare(torch, fa, gen, dev, dtype, case)
            lse_checks.append({"case": list(case),
                               "dtype": str(dtype).split(".")[-1], **errs})
            for name, e in errs.items():
                if not e["ok"]:
                    raise AssertionError(f"flash_attention_lse {name} {case} "
                                         f"{dtype}: {e}")
                if dtype == torch.bfloat16 and name in worst:
                    worst[name] = max(worst[name], e["max_abs_err"])
    torch.cuda.empty_cache()
    emit({"phase": "flash_kernels", "float32_max_abs_tol": FLASH_TOL,
          "bfloat16_row_rel_tol": BF16_ROW_RTOL, "checks": checks,
          "lse_cotangent_checks": lse_checks,
          "planted_faults": faults, "reruns_bitwise_equal": reruns})
    return worst


def flash_lse_compare(torch, fa, gen, dev, dtype, case):
    """flash_attention_lse (the kernels B1-B3) against its plain version
    on one block, under random cotangents of o and of the lse (the lse's
    shifts delta), each as flash_errs measures it. float32: the two
    autograd Functions end to end, o, lse, dq, dk and dv. bfloat16: o
    and lse, and the backward kernels against the plain backward on the
    plain forward's lse and shifted delta (rowsum(dO * O) - g_lse): the
    row bar assumes shared residuals, as flash_compare's do (the rows
    seeing few keys have a dq that is almost only the shift, and two
    bf16 roundings of O move their delta by more)."""
    B, Hh, Tq, Tk, qo, ko, pre = case
    q, k, v, do = flash_inputs(torch, gen, dev, dtype, B, Hh, Tq, Tk)
    g_lse = torch.randn(B, Hh, Tq, generator=gen).to(dev)
    outs = {}
    for name, fn in (("kernel", fa.flash_attention_lse),
                     ("plain", fa.flash_attention_lse_plain)):
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o, lse = fn(qg, kg, vg, qo, ko, pre)
        grads = torch.autograd.grad((o, lse), (qg, kg, vg), (do, g_lse))
        outs[name] = (o.detach(), lse.detach(), *grads)
    (o, lse, dq, dk, dv), (o_r, lse_r, dq_r, dk_r, dv_r) = (outs["kernel"],
                                                           outs["plain"])
    if dtype == torch.bfloat16:
        delta = (do.float() * o_r.float()).sum(-1) - g_lse
        dq = fa.flash_dq(q, k, v, do, lse_r, delta, qo, ko, pre)
        dk, dv = fa.flash_dkv(q, k, v, do, lse_r, delta, qo, ko, pre)
        dq_r = fa._flash_dq_ref(q, k, v, do, lse_r, delta, qo, ko, pre)
        dk_r, dv_r = fa._flash_dkv_ref(q, k, v, do, lse_r, delta, qo, ko,
                                       pre)
    torch.cuda.synchronize()
    lse_err = (lse - lse_r).abs().max().item()
    return {"flash_fwd": flash_errs(torch, ((o, o_r),), lse_err),
            "flash_dq": flash_errs(torch, ((dq, dq_r),)),
            "flash_dkv": flash_errs(torch, ((dk, dk_r), (dv, dv_r)))}

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
    ("collective", ("nccl",)),
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
    headline = image_bench(torch, HEADLINE_ARGS)
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


# ---- phases 15-16: data-parallel training (ROADMAP A.6) -------------------
#
# One card: the world-2 runs share it over gloo, every rank on cuda:0
# (distributed.spawn(shared_card=True), whose reduce-scatter and
# all-gather go through pinned host memory), and NCCL runs at world 1
# (its collectives run; nothing short-circuits a world of one). The ranks
# are processes of their own, spawned after phase 1 built the kernels,
# which they load.

# dp_train: transformer_s / synthtext at full width, bf16, the fused head,
# "auto" attention (the flash kernels), a global batch of 32 rows (16 a
# rank at world 2), three steps of each engine from one init (seed 0) and
# one set of batches; int8 twice, for the replay
DP_TOKEN_MODEL = ("transformer_s", "synthtext")
DP_ROWS, DP_STEPS, DP_LR = 32, 3, 0.01
DP_ENGINES = (("replicated", {}),
              ("sharded", {"dp_shard_update": True}),
              ("overlapped", {"dp_shard_update": True, "comm_buckets": 4}),
              ("bf16", {"allreduce_dtype": "bf16"}),
              ("int8", {"allreduce_dtype": "int8"}),
              ("int8_replay", {"allreduce_dtype": "int8"}))
# (a): step 1 of replicated dp at world 2 against single on the same 32
# rows. The loss within DP_SINGLE_REL; each gradient leaf (relative L2)
# within DP_HALVES_REL of single's gradients of the two ranks' 16-row
# halves combined, which is what dp computes, and within DP_SINGLE_REL of
# the 32-row step's or twice the halves' own distance to it, whichever is
# larger: in bfloat16 a 16-row step's activations round apart from a
# 32-row step's, 2.8e-3 on an H100 (PERF.md §6) and 3.0e-3 on the CPU,
# with dp equal to the halves to 0.0 on both
DP_SINGLE_REL, DP_HALVES_REL = 1e-3, 1e-6
DP_ENGINE_REL = 1e-6  # (b): where the parameters are not bitwise
DP_WIRE_RTOL = 0.05  # (c): the reference's bar for bf16 and int8 losses
# (d): NCCL world 1 against single, each step's loss: against single with
# the reference's update formulas (parallel/common.flat_optimizer, dp's
# own) within this; single through torch.optim is printed beside it (its
# fused multiply-adds round the update apart: 2.6e-6 at step 3 on an
# H100, PERF.md §6)
DP_NCCL_RTOL = 1e-6
# dp_image: resnet18 / cifar10 in float64, 8 rows a rank at world 2,
# held to single on the 16 rows within IMAGE_F64_RTOL; then resnet50 /
# imagenet bf16 B 128 through replicated dp at NCCL world 1 and through
# single, images/s over DP_IMAGE_STEPS timed steps each
DP_F64_MODEL, DP_F64_ROWS = ("resnet18", "cifar10"), 8
DP_IMAGE_MODEL = ("resnet50", "imagenet")
DP_IMAGE_B, DP_IMAGE_STEPS, DP_IMAGE_WARMUP = 128, 10, 2
DP_COUNTERS = tuple(FLASH_KERNELS) + tuple(FX_KERNELS)


def dp_token_cfg(world, **kw):
    from ddlbench_tpu_torch.config import RunConfig

    return RunConfig(benchmark=DP_TOKEN_MODEL[1], arch=DP_TOKEN_MODEL[0],
                     strategy="dp", num_devices=world,
                     batch_size=DP_ROWS // world, compute_dtype="bfloat16",
                     attention_backend="auto", seed=0, **kw)


def dp_counters():
    from ddlbench_tpu_torch.ops import flash_attention as fa
    from ddlbench_tpu_torch.ops import fused_xent as fx

    return {name: getattr(fa if name in FLASH_KERNELS else fx, name)
            for name in DP_COUNTERS}


def dp_steps(torch, strategy, batches, lr):
    """``strategy``'s train steps on ``batches``, the launch counters
    zeroed just before and read just after: (losses, ms per step,
    launches, plain-path attention calls)."""
    from ddlbench_tpu_torch.ops import flash_attention as fa

    counters = dp_counters()
    for fn in counters.values():
        fn.launches = 0
    plain0 = fa.flash_attention.plain_launches
    losses, ms = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(strategy.train_step(x, y, lr)["loss"].item())
        ms.append(1e3 * (time.perf_counter() - t0))
    return (losses, ms, {n: fn.launches for n, fn in counters.items()},
            fa.flash_attention.plain_launches - plain0)


def param_vector(torch, model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def rel_l2(torch, a, b) -> float:
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp(min=1e-30)).item()


def dp_vs_single(torch, comm, batch):
    """(a): replicated dp's step-1 loss and reduced gradient on the global
    batch against single's on the same rows; on rank 0 also single on each
    rank's half, combined, to show the split's own distance."""
    import dataclasses

    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.parallel.common import loss_and_grads, unpack_flat

    dev = comm.device
    strat = make_strategy(dp_token_cfg(comm.world), dev, comm)
    m, gred = strat.reduced_grads(*batch)
    by_id = {id(p): g for p, g in zip(strat.params,
                                      unpack_flat(gred, strat.meta))}
    dp_grads = [by_id[id(p)].float() for p in strat.model.parameters()]
    dp_loss = m["loss"].item()
    del strat, gred, by_id
    if comm.rank:
        return None
    single_cfg = dataclasses.replace(dp_token_cfg(1), strategy="single",
                                     batch_size=DP_ROWS)
    single = make_strategy(single_cfg, dev)

    def step(x, y):
        ce, _, grads = loss_and_grads(single.model, single_cfg, x, y,
                                      torch.bfloat16, 0.0)
        return ce.item(), [g.detach().float().clone() for g in grads]

    loss32, g32 = step(*batch)
    half = DP_ROWS // 2
    halves = [step(batch[0][i:i + half], batch[1][i:i + half])
              for i in (0, half)]
    g_half = [(a + b) / 2 for a, b in zip(halves[0][1], halves[1][1])]
    rec = {"loss_dp": dp_loss, "loss_single": loss32,
           "loss_rel": abs(dp_loss - loss32) / abs(loss32),
           "worst_grad_rel_l2": max(rel_l2(torch, a, b)
                                    for a, b in zip(dp_grads, g32)),
           "halves_vs_single_worst_grad_rel_l2": max(
               rel_l2(torch, a, b) for a, b in zip(g_half, g32)),
           "dp_vs_halves_worst_grad_rel_l2": max(
               rel_l2(torch, a, b) for a, b in zip(dp_grads, g_half))}
    rec["grad_bar"] = max(DP_SINGLE_REL,
                          2 * rec["halves_vs_single_worst_grad_rel_l2"])
    rec["ok"] = (rec["loss_rel"] <= DP_SINGLE_REL
                 and rec["dp_vs_halves_worst_grad_rel_l2"] <= DP_HALVES_REL
                 and rec["worst_grad_rel_l2"] <= rec["grad_bar"])
    return rec


def dp_engines(torch, comm):
    """Three steps of each engine of DP_ENGINES from one init and one set
    of batches: the losses, ms per step, global tokens/s, the launches of
    B1-B6 on this rank, and the parameters against the replicated run's
    (bitwise, and relative L2) and the second int8 run's against the
    first's."""
    import dataclasses

    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.parallel.api import make_strategy

    cfg0 = dp_token_cfg(comm.world)
    T = cfg0.dataset().seq_len
    data = make_synthetic(cfg0.dataset(), DP_ROWS, comm.device, seed=0)
    batches = [data.batch(0, s) for s in range(DP_STEPS)]
    out = {"vs_single": dp_vs_single(torch, comm, batches[0])}
    kept = {}
    for name, kw in DP_ENGINES:
        strat = make_strategy(dataclasses.replace(cfg0, **kw), comm.device,
                              comm)
        losses, ms, launches, plain = dp_steps(torch, strat, batches, DP_LR)
        strat.materialize_params()
        flat = param_vector(torch, strat.model)
        base = kept.get("int8" if name == "int8_replay" else "replicated")
        rec = {"losses": losses, "ms_per_step": ms,
               "timed_ms_per_step": sum(ms[1:]) / (len(ms) - 1),
               "launches": launches, "plain_launches": plain}
        rec["global_tokens_per_s"] = (DP_ROWS * T * 1e3
                                      / rec["timed_ms_per_step"])
        if base is not None:
            rec["params_bitwise"] = bool(torch.equal(flat, base))
            rec["params_rel_l2"] = rel_l2(torch, flat, base)
        if name in ("replicated", "int8"):
            kept[name] = flat
        out[name] = rec
        del strat, flat
        torch.cuda.empty_cache()
    return out


def dp_image_f64(torch, comm):
    """dp_image's float64 check: resnet18 / cifar10, one step of
    replicated dp on DP_F64_ROWS rows a rank (sync-BN) against single on
    all the rows: the loss, every gradient leaf and every running
    statistic (rank 0 compares)."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.parallel.common import unpack_flat
    from ddlbench_tpu_torch.parallel.dp import DPStrategy

    dev, rows = comm.device, DP_F64_ROWS * comm.world
    arch, bench = DP_F64_MODEL
    cfg = RunConfig(benchmark=bench, arch=arch, strategy="dp",
                    num_devices=comm.world, batch_size=DP_F64_ROWS, seed=0)

    def model64():
        return get_model(arch, bench, seed=0).to(
            dev, torch.float64).to(memory_format=torch.channels_last)

    x, y = make_synthetic(cfg.dataset(), rows, dev, seed=0).batch(0, 0)
    x = x.to(torch.float64).contiguous(memory_format=torch.channels_last)
    strat = DPStrategy(model64(), cfg, comm)
    strat.compute_dtype = torch.float64  # the model's own type
    strat.init()
    m, gred = strat.reduced_grads(x, y)
    by_id = {id(p): g for p, g in zip(strat.params,
                                      unpack_flat(gred, strat.meta))}
    dp = (m["loss"].item(),
          [by_id[id(p)].detach().cpu() for p in strat.model.parameters()],
          [b.detach().cpu() for b in strat.model.buffers()])
    if comm.rank:
        return None
    import dataclasses

    single_cfg = dataclasses.replace(cfg, strategy="single", num_devices=1,
                                     batch_size=rows)
    rec = f64_agreement(dp, image_step(torch, model64(), x, y, single_cfg,
                                       None))
    rec["rows_per_rank"] = DP_F64_ROWS
    return rec


def nccl_world1(fn):
    """``fn(comm)`` on an NCCL group of one rank in this process (a spawn
    costs tens of seconds of start-up), joined through a rendezvous file
    and left after."""
    import tempfile

    import torch.distributed as dist

    from ddlbench_tpu_torch import distributed

    with tempfile.TemporaryDirectory(prefix="ddlb_nccl1_") as tmp:
        comm = distributed.init_rank(0, 1, os.path.join(tmp, "rdv"), "cuda")
        try:
            return fn(comm)
        finally:
            dist.destroy_process_group()


def dp_shared_rank(comm):
    """A rank of the world-2 shared-card run: dp_train's engines,
    dp_image's float64 check and moe_dp (phase 28)."""
    import torch

    return {"rank": comm.rank, "comm": comm.record(),
            "train": dp_engines(torch, comm),
            "image_f64": dp_image_f64(torch, comm),
            "moe": moe_global_cell(torch, comm, "dp")}


def single_ref_update_losses(torch, cfg, batches, lr, dev):
    """single's losses over ``batches`` with the reference's update
    formulas (parallel/common.flat_optimizer, what dp runs) in place of
    torch.optim: dp at world 1 without its collectives."""
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.parallel.common import (flat_optimizer,
                                                    loss_and_grads)

    model = get_model(cfg.arch, cfg.benchmark, seed=cfg.seed).to(dev)
    params = list(model.parameters())
    init, update = flat_optimizer(cfg)
    state, losses = init(params), []
    for x, y in batches:
        ce, _, grads = loss_and_grads(model, cfg, x, y, torch.bfloat16, 0.0)
        losses.append(ce.item())
        with torch.no_grad():
            new, state = update(params, grads, state, lr)
            for p, t in zip(params, new):
                p.copy_(t)
    return losses


def dp_nccl_rank(comm):
    """The world-1 NCCL run: (d) replicated dp's three steps against
    single's on the same rows, then resnet50 / imagenet bf16 B 128 through
    replicated dp and through single, images/s each and one profile
    each."""
    import dataclasses

    import torch

    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.tools.timing import timed_steps

    dev = comm.device
    cfg = dp_token_cfg(1)
    data = make_synthetic(cfg.dataset(), DP_ROWS, dev, seed=0)
    batches = [data.batch(0, s) for s in range(DP_STEPS)]
    runs = {}
    for name, c in (("dp", cfg), ("single", dataclasses.replace(
            cfg, strategy="single"))):
        strat = make_strategy(c, dev, comm if name == "dp" else None)
        runs[name] = dp_steps(torch, strat, batches, DP_LR)
        del strat
        torch.cuda.empty_cache()
    dl, sl = runs["dp"][0], runs["single"][0]
    rl = single_ref_update_losses(
        torch, dataclasses.replace(cfg, strategy="single"), batches, DP_LR,
        dev)

    def worst(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    train = {"losses_dp": dl, "losses_single_ref_update": rl,
             "losses_single_torch_optim": sl,
             "worst_loss_rel": worst(dl, rl),
             "worst_loss_rel_vs_torch_optim": worst(dl, sl),
             "launches": runs["dp"][2], "plain_launches": runs["dp"][3]}
    train["ok"] = train["worst_loss_rel"] <= DP_NCCL_RTOL
    image = {}
    for name, strategy in (("dp", "dp"), ("single", "single")):
        icfg = RunConfig(benchmark=DP_IMAGE_MODEL[1], arch=DP_IMAGE_MODEL[0],
                         strategy=strategy, batch_size=DP_IMAGE_B,
                         compute_dtype="bfloat16", seed=0)
        strat = make_strategy(icfg, dev, comm if name == "dp" else None)
        idata = make_synthetic(icfg.dataset(), DP_IMAGE_B, dev, seed=0)
        lr, losses = icfg.resolved_lr(), []

        def run_step(x, y, strat=strat, lr=lr, losses=losses):
            m = strat.train_step(x, y, lr)
            losses.append(m["loss"])
            return m

        dt = timed_steps(run_step, idata.batch, DP_IMAGE_STEPS,
                         DP_IMAGE_WARMUP)
        image[name] = {"images_per_s": DP_IMAGE_STEPS * DP_IMAGE_B / dt,
                       "ms_per_step": 1e3 * dt / DP_IMAGE_STEPS,
                       "finite": all(math.isfinite(v) for v in
                                     torch.stack(losses).float().tolist())}
        if dev.type == "cuda":
            prof = image_profile(torch, strat, idata)
            image[name]["profile"] = {
                k: prof[k] for k in ("device_busy_share", "launches_per_step",
                                     "groups")}
            image[name]["profile"]["device_ms_per_step"] = (
                prof["device_busy_ms"] / prof["steps"])
        del strat, idata, losses
        torch.cuda.empty_cache()
    image["dp_over_single"] = (image["dp"]["images_per_s"]
                               / image["single"]["images_per_s"])
    return {"comm": comm.record(), "train": train, "image": image}


def phase_dp(torch):
    """Phases 15-16 and moe_dp (28; module docstring): the world-2
    shared-card ranks, then the world-1 NCCL rank in this process. Emits
    dp_train, dp_image and moe_dp and returns the B1-B6 launches of
    every rank's main-path steps."""
    from ddlbench_tpu_torch import distributed

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shared = distributed.spawn(dp_shared_rank, 2, "cuda", shared_card=True)
    t1 = time.perf_counter()
    nccl = nccl_world1(dp_nccl_rank)
    t2 = time.perf_counter()
    per_step = {**{n: LAYERS for n in FLASH_KERNELS},
                **{n: 1 for n in FX_KERNELS}}
    launches = {n: 0 for n in DP_COUNTERS}
    checks, engines = {}, {}
    for rank in shared:
        for name, _ in DP_ENGINES:
            rec = rank["train"][name]
            ok = (rec["plain_launches"] == 0 and all(
                rec["launches"][n] == per_step[n] * DP_STEPS
                for n in DP_COUNTERS))
            checks[f"e_rank{rank['rank']}_{name}"] = ok
            for n in DP_COUNTERS:
                launches[n] += rec["launches"][n]
    for n in DP_COUNTERS:
        launches[n] += nccl["train"]["launches"][n]
    checks["e_nccl"] = nccl["train"]["plain_launches"] == 0 and all(
        nccl["train"]["launches"][n] == per_step[n] * DP_STEPS
        for n in DP_COUNTERS)
    r0 = shared[0]["train"]
    for name, _ in DP_ENGINES:
        engines[name] = {k: r0[name].get(k) for k in (
            "losses", "timed_ms_per_step", "global_tokens_per_s",
            "params_bitwise", "params_rel_l2")}
    checks["a_vs_single"] = r0["vs_single"]["ok"]
    for name in ("sharded", "overlapped"):
        checks[f"b_{name}"] = (r0[name]["params_bitwise"]
                               or r0[name]["params_rel_l2"] <= DP_ENGINE_REL)
    f32 = r0["replicated"]["losses"]
    for name in ("bf16", "int8"):
        got = r0[name]["losses"]
        checks[f"c_{name}"] = all(
            math.isfinite(a) and abs(a - b) <= DP_WIRE_RTOL * abs(b)
            for a, b in zip(got, f32))
    checks["c_int8_replay"] = (r0["int8_replay"]["params_bitwise"] and
                               r0["int8_replay"]["losses"]
                               == r0["int8"]["losses"])
    checks["same_losses_on_both_ranks"] = all(
        shared[1]["train"][n]["losses"] == r0[n]["losses"]
        for n, _ in DP_ENGINES)
    checks["d_nccl_vs_single"] = nccl["train"]["ok"]
    emit({"phase": "dp_train", "model": DP_TOKEN_MODEL[0],
          "benchmark": DP_TOKEN_MODEL[1], "global_batch": DP_ROWS,
          "world": 2, "dtype": "bfloat16", "steps": DP_STEPS,
          "comm_shared": shared[0]["comm"], "comm_nccl": nccl["comm"],
          "vs_single": r0["vs_single"], "engines": engines,
          "nccl_world1": nccl["train"],
          "launches_per_rank": {f"rank{r['rank']}": {
              n: r["train"][n]["launches"] for n, _ in DP_ENGINES}
              for r in shared},
          "bitwise_b": {n: r0[n]["params_bitwise"]
                        for n in ("sharded", "overlapped")},
          "checks": checks, "seconds": {"shared_spawn": t1 - t0,
                                        "nccl_world1": t2 - t1}})
    f64 = shared[0]["image_f64"]
    image_checks = {"f64_sync_bn_vs_single": f64["ok"],
                    "resnet50_finite": all(v["finite"] for k, v in
                                           nccl["image"].items()
                                           if isinstance(v, dict))}
    emit({"phase": "dp_image", "float64_world2": {
              "model": DP_F64_MODEL, **f64},
          "bf16_nccl_world1": {"model": DP_IMAGE_MODEL,
                               "batch": DP_IMAGE_B, **nccl["image"]},
          "checks": image_checks})
    failed = [k for k, v in {**checks, **image_checks}.items() if not v]
    if failed:
        raise AssertionError(f"data-parallel checks failed: {failed}")
    for name, n in moe_line([r["moe"] for r in shared], "dp").items():
        launches[name] += n
    return launches


PIPE_S = 4  # stages, every one on the one card (distributed.stage_devices)
PIPE_TOKEN = ("transformer_s", "synthtext")
PIPE_IMAGE = ("resnet50", "imagenet")
PIPE_TIMED = 2  # timed steps of each row, after its first (warm-up) step
PIPE_F64_BATCH = (2, 2)  # resnet50's float64 gpipe check: mb, M
PIPE_COUNTERS = tuple(FLASH_KERNELS) + tuple(FX_KERNELS)
# (a) transformer_s: gpipe's step 1 against single's on the same 32 rows,
# bfloat16 (4-row microbatches round apart from one 32-row batch): the
# loss's relative error and the update's (params after minus before)
# relative L2 over every leaf. Measured on the H100 (PERF.md, PR 19):
# 0 and 2.55e-3; the bars are those with room
PIPE_SINGLE_LOSS_RTOL = 1e-4
PIPE_SINGLE_UPDATE_REL = 1e-2
# (b) zero-bubble's step gradient against fill-drain's, float32: only the
# order of the microbatch sums differs (relative L2 over every leaf;
# measured 7.7e-8)
PIPE_F32_GRAD_REL = 1e-6
# (c) pipedream's first two steps against the replay (relative L2 of the
# parameters' change over the two steps, every leaf; measured 0 on both
# models, with cuDNN's algorithm choice left to chance here)
PIPE_REPLAY_REL = 1e-3


def pipe_strategy(torch, model, benchmark, strategy, dev, dtype="bfloat16",
                  **kw):
    """make_strategy for a pipeline of PIPE_S stages on the one card
    (shared_card), random weights from seed 0."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.parallel.api import make_strategy

    cfg = RunConfig(benchmark=benchmark, arch=model, strategy=strategy,
                    num_devices=PIPE_S, compute_dtype=dtype, seed=0, **kw)
    return make_strategy(cfg, dev, shared_card=dev.type == "cuda")


def recording_updates(strategy):
    """Wrap ``strategy._update`` so each chunk's gradient of the step is
    kept (float64, on the host) as it is applied; returns the dict."""
    grads = {}
    update = strategy._update

    def record(c, g, lr):
        grads[c] = [t.detach().double().cpu() for t in g]
        return update(c, g, lr)

    strategy._update = record
    return grads


def flat(torch, tensors):
    return torch.cat([t.detach().double().reshape(-1).cpu()
                      for t in tensors])


def rel_change(torch, after, before, want_after):
    """Relative L2 of (after - before) against (want_after - before)."""
    d = flat(torch, after) - flat(torch, before)
    w = flat(torch, want_after) - flat(torch, before)
    return ((d - w).norm() / w.norm()).item()


def pipe_expected(strategy, schedule, steps):
    """The B1-B6 launches ``steps`` steps of ``strategy`` make: each
    (chunk, microbatch) forward runs its attention blocks' flash forward
    and, on the last chunk, the fused head's forward; a recompute runs
    them again; a backward of a block (to its input or its weights) runs
    dQ and dK/dV; the head's backward runs dh and dW once each per
    microbatch, in one event (fill-drain, pipedream) or in its B and W
    events (zero-bubble: B recomputes every chunk but the first, W every
    chunk)."""
    from ddlbench_tpu_torch.models.transformer import AttentionBlock

    blocks = [sum(isinstance(m, AttentionBlock)
                  for layer in strategy.chunk_layers(c)
                  for m in layer.modules())
              for c in range(strategy.num_chunks)]
    tot, rest = sum(blocks), sum(blocks[1:])
    if schedule == "zero-bubble":
        fwd, bwd, fx_fwd = 2 * tot + rest, tot + rest, 3
    else:
        fwd, bwd, fx_fwd = 2 * tot, tot, 2
    n = strategy.num_microbatches * steps
    return {"flash_fwd": n * fwd, "flash_dq": n * bwd, "flash_dkv": n * bwd,
            "fxent_fwd": n * fx_fwd, "fxent_dh": n, "fxent_dw": n}


def pipe_timed(torch, strategy, batches, lr, snap=None):
    """Step 1 of ``batches`` warms up, the rest are timed: (seconds,
    losses). ``snap``: (k, fn), fn() called after step k (1-based)."""
    losses = []
    for i, (x, y) in enumerate(batches):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(strategy.train_step(x, y, lr)["loss"])
        if snap is not None and snap[0] == i + 1:
            snap[1]()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    vals = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite pipeline loss: {vals}")
    return dt, vals


def params_of(strategy):
    return [p.detach().clone() for p in strategy.model.parameters()]


def pipedream_replay(torch, strategy, initial, batches, lr):
    """The reference tests' sequential replay of PipeDream
    (tests/test_pipedream.py ``simulate_pipedream``), written apart from
    parallel/pipedream.py, on ``initial``'s weights (a copy of the
    strategy's starting model on its device): its closed-form timetable
    F(c, f) = c + f for f <= C-1-c, else c + 2f, and B(c, b) = 2b + 2C-1-c
    over C chunks and 2M + 2C - 2 half-ticks; dicts of weight versions by
    (chunk, microbatch); each backward at its forward's weights,
    recomputed with the running statistics frozen; a momentum SGD update
    (m = mu m + g + wd p; p -= lr m) after every backward. Returns the
    model's parameters after ``batches``."""
    from ddlbench_tpu_torch.models.layers import apply_chunk
    from ddlbench_tpu_torch.parallel.common import (cross_entropy_loss,
                                                    fused_chunk_loss_sums)

    cfg, cd = strategy.cfg, strategy.compute_dtype
    bounds, C, M = strategy.bounds, strategy.num_chunks, \
        strategy.num_microbatches
    mu, wd = cfg.resolved_momentum(), cfg.resolved_weight_decay()
    layers = [initial.layers[bounds[c]:bounds[c + 1]] for c in range(C)]
    names = [[(i, n) for i, layer in enumerate(layers[c])
              for n, _ in layer.named_parameters()] for c in range(C)]
    cur = [[p.detach().clone() for layer in layers[c]
            for p in layer.parameters()] for c in range(C)]
    mom = [[torch.zeros_like(p) for p in ps] for ps in cur]
    F, B = {}, {}
    for c in range(C):
        for f in range(M):
            F[(c + f if f <= C - 1 - c else c + 2 * f, c)] = f
            B[(2 * f + 2 * C - 1 - c, c)] = f

    def run(c, ps, x, y, update_stats):
        dicts = [{} for _ in layers[c]]
        for (i, n), p in zip(names[c], ps):
            dicts[i][n] = p
        if c < C - 1:
            return apply_chunk(layers[c], x, cd, dicts, update_stats)
        if strategy.fused:
            s, _, _, v = fused_chunk_loss_sums(
                layers[c], x, y, cd, strategy.smoothing, dicts,
                update_stats)
            return s / v.clamp(min=1).float()
        return cross_entropy_loss(
            apply_chunk(layers[c], x, cd, dicts, update_stats), y,
            strategy.smoothing)

    initial.train()
    for x_all, y_all in batches:
        xs = [t.to(cd) if t.is_floating_point() else t
              for t in x_all.split(strategy.mb)]
        ys = y_all.split(strategy.mb)
        versions, inputs, acts, cots = {}, {}, {}, {}
        for h in range(2 * M + 2 * C - 2):
            for c in range(C):
                if (h, c) in F:
                    f = F[(h, c)]
                    x = xs[f] if c == 0 else acts.pop((c, f))
                    versions[(c, f)] = [p.clone() for p in cur[c]]
                    inputs[(c, f)] = x
                    with torch.no_grad():
                        out = run(c, cur[c], x, ys[f], True)
                    if c < C - 1:
                        acts[(c + 1, f)] = out
                if (h, c) in B:
                    b = B[(h, c)]
                    ps = [p.requires_grad_(True)
                          for p in versions.pop((c, b))]
                    x = inputs.pop((c, b))
                    if c > 0:
                        x = x.detach().requires_grad_(True)
                    with torch.enable_grad():
                        out = run(c, ps, x, ys[b], False)
                        wrt = ps + ([x] if c > 0 else [])
                        g = torch.autograd.grad(
                            out, wrt, None if c == C - 1
                            else cots.pop((c, b)), allow_unused=True)
                    g = [torch.zeros_like(t) if gi is None else gi
                         for gi, t in zip(g, wrt)]
                    if c > 0:
                        cots[(c - 1, b)] = g[-1].to(cd)
                    with torch.no_grad():
                        for i, p in enumerate(cur[c]):
                            mom[c][i] = mom[c][i] * mu + (
                                g[i].float() + p * wd)
                            cur[c][i] = p - mom[c][i] * lr
    return [p for ps in cur for p in ps]


def pipe_counted(fa, fx):
    counters = {**{n: getattr(fa, n) for n in FLASH_KERNELS},
                **{n: getattr(fx, n) for n in FX_KERNELS}}
    for fn in counters.values():
        fn.launches = 0
    return counters, fa.flash_attention.plain_launches


def phase_pipe_train(torch, fa, fx, dev):
    """Phase 17 (module docstring): transformer_s / synthtext on four
    stages of the one card. Returns the B1-B6 launches of its main-path
    runs."""
    import copy

    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.parallel.api import make_strategy

    model, bench = PIPE_TOKEN
    t_start = time.perf_counter()
    runs = {"gpipe_fill_drain": ("gpipe", {}),
            "gpipe_zero_bubble": ("gpipe", {"pipe_schedule": "zero-bubble"}),
            "pipedream": ("pipedream", {})}
    strategies = {k: pipe_strategy(torch, model, bench, st, dev, **kw)
                  for k, (st, kw) in runs.items()}
    gpipe, pdream = strategies["gpipe_fill_drain"], strategies["pipedream"]
    lr, T = gpipe.cfg.resolved_lr(), gpipe.cfg.dataset().seq_len
    initial = params_of(gpipe)  # seed 0: every strategy's start
    pd_initial = {k: v.clone() for k, v in pdream.model.state_dict().items()}
    batches = {}
    for k, s in strategies.items():
        data = make_synthetic(s.cfg.dataset(), s.mb * s.num_microbatches,
                              dev, seed=0)
        batches[k] = [data.batch(1, i) for i in range(1 + PIPE_TIMED)]

    # the main path: each row's steps, every B1-B6 counter zeroed before
    # and read after
    snaps = {}
    counters, plain0 = pipe_counted(fa, fx)
    rows = {}
    for k, s in strategies.items():
        k_snap = 1 if k == "gpipe_fill_drain" else 2
        snap = (k_snap, lambda k=k, s=s: snaps.__setitem__(k, params_of(s)))
        rows[k] = pipe_timed(torch, s, batches[k], lr, snap)
    launches = {n: fn.launches for n, fn in counters.items()}
    plain = fa.flash_attention.plain_launches - plain0
    want = {n: 0 for n in PIPE_COUNTERS}
    for k, s in strategies.items():
        sched = "pipedream" if k == "pipedream" else s.cfg.pipe_schedule
        for n, c in pipe_expected(s, sched, 1 + PIPE_TIMED).items():
            want[n] += c
    checks = {"d_launches": launches == want and plain == 0}
    shape = {k: (s.mb * s.num_microbatches, s.mb, s.num_microbatches,
                 s.bounds) for k, s in strategies.items()}
    del strategies, gpipe
    gc.collect()
    torch.cuda.empty_cache()

    # (a) gpipe's step 1 against single's on the same rows (32)
    B = shape["gpipe_fill_drain"][0]
    single = make_strategy(RunConfig(benchmark=bench, arch=model,
                                     batch_size=B, seed=0), dev)
    loss_s = float(single.train_step(*batches["gpipe_fill_drain"][0],
                                     lr)["loss"])
    a_rec = {"loss_gpipe": rows["gpipe_fill_drain"][1][0],
             "loss_single": loss_s,
             "update_rel_l2": rel_change(torch, snaps["gpipe_fill_drain"],
                                         initial, params_of(single))}
    a_rec["loss_rel"] = abs(a_rec["loss_gpipe"] - loss_s) / abs(loss_s)
    checks["a_vs_single"] = (a_rec["loss_rel"] <= PIPE_SINGLE_LOSS_RTOL
                             and a_rec["update_rel_l2"]
                             <= PIPE_SINGLE_UPDATE_REL)
    del single
    torch.cuda.empty_cache()

    # (b) zero-bubble's gradient against fill-drain's, float32
    grads = {}
    for sched in ("fill-drain", "zero-bubble"):
        s = pipe_strategy(torch, model, bench, "gpipe", dev,
                          dtype="float32", pipe_schedule=sched)
        rec = recording_updates(s)
        s.train_step(*batches["gpipe_fill_drain"][0], lr)
        grads[sched] = torch.cat([g.reshape(-1) for c in sorted(rec)
                                  for g in rec[c]])
        del s, rec
        torch.cuda.empty_cache()
    b_rel = ((grads["zero-bubble"] - grads["fill-drain"]).norm()
             / grads["fill-drain"].norm()).item()
    checks["b_zero_bubble_vs_fill_drain_f32"] = b_rel <= PIPE_F32_GRAD_REL
    del grads

    # (c) pipedream's first two steps against the replay on the card
    replica = copy.deepcopy(pdream.model)
    replica.load_state_dict(pd_initial)
    replay = pipedream_replay(torch, pdream, replica,
                              batches["pipedream"][:2], lr)
    c_rel = rel_change(torch, snaps["pipedream"],
                       [pd_initial[n] for n, _ in
                        pdream.model.named_parameters()], replay)
    checks["c_pipedream_vs_replay"] = c_rel <= PIPE_REPLAY_REL
    del replica, replay, pdream
    card = card_line()
    emit({"phase": "pipe_train", "model": model, "benchmark": bench,
          "stages": PIPE_S, "shared_card": True, "dtype": "bfloat16",
          "rows": {k: {"tokens_per_sec": PIPE_TIMED * b * T / dt,
                       "ms_per_step": 1e3 * dt / PIPE_TIMED, "losses": ls,
                       "global_batch": b, "microbatch": mb,
                       "microbatches": m, "bounds": bd, "card": card}
                   for k, (dt, ls, b, mb, m, bd) in (
                       (k, rows[k] + shape[k]) for k in rows)},
          "a_vs_single": {**a_rec, "loss_rtol": PIPE_SINGLE_LOSS_RTOL,
                          "update_rel_bar": PIPE_SINGLE_UPDATE_REL},
          "b_grad_rel_l2_f32": b_rel, "b_bar": PIPE_F32_GRAD_REL,
          "c_replay_rel_l2": c_rel, "c_bar": PIPE_REPLAY_REL,
          "launches": launches, "launches_expected": want,
          "plain_launches": plain, "checks": checks,
          "seconds": time.perf_counter() - t_start})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"pipeline checks failed: {failed}")
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in pipe_hetero(torch, fa, fx, dev).items():
        launches[name] += n
    return launches


# hetero_train: --stage-replication 2,1 (parallel/hetero.py), one
# process over three "devices" of the one card. The float32 checks run
# transformer_s cut to HYB_CUT blocks on HYB_CUT_T tokens, mb 2 x M 2:
# the plan's step against the uniform 2-stage gpipe's at the same global
# batch on the card (every leaf's update within HET_UNIFORM_REL: only the
# sums' split differs, a replica's GEMMs over half the rows; measured
# 1.55e-5 on the H100, the card's own distance to the CPU's step
# 1.66e-5), and against the same plan's step on the CPU (the loss within
# SHARD_F32_LOSS, every update within SHARD_CPU_UPDATE)
HET_REPL = (2, 1)
HET_RUNS = (("gpipe", {"micro_batch_size": 4, "num_microbatches": 8}),
            ("pipedream", {"batch_size": 32, "micro_batch_size": 4}))
HET_UNIFORM_REL = 1e-4


def hetero_expected(strategy, steps):
    """B1-B6 launches of ``steps`` hetero steps: every replica of a stage
    runs its stage's events on its rows (fill-drain with remat or
    pipedream alike: a forward, a recompute and a backward of each block
    a microbatch; the head's forward twice, dh and dW once)."""
    from ddlbench_tpu_torch.models.transformer import AttentionBlock

    blocks = sum(r * sum(isinstance(m, AttentionBlock)
                         for layer in strategy.chunk_layers(s)
                         for m in layer.modules())
                 for s, r in enumerate(strategy.repl))
    last = strategy.repl[-1]
    n = strategy.num_microbatches * steps
    return {"flash_fwd": 2 * n * blocks, "flash_dq": n * blocks,
            "flash_dkv": n * blocks, "fxent_fwd": 2 * n * last,
            "fxent_dh": n * last, "fxent_dw": n * last}


def het_cut_step(torch, strategy, dev, repl):
    """One float32 step of the cut transformer_s (``repl``: a replication
    plan, or None for the uniform 2-stage gpipe) on ``dev``: (loss,
    update)."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.distributed import stage_devices
    from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy
    from ddlbench_tpu_torch.parallel.hetero import (HeteroGPipeStrategy,
                                                    HeteroPipeDreamStrategy)

    n = sum(repl) if repl else 2
    cfg = RunConfig(benchmark=SHARD_TOKEN[1], arch=SHARD_TOKEN[0],
                    strategy=strategy, num_devices=n,
                    stage_replication=repl, micro_batch_size=2,
                    num_microbatches=2, batch_size=4, compute_dtype="float32",
                    seed=0, optimizer="sgd", attention_backend="auto")
    devs = stage_devices(str(dev.type), n, dev.type == "cuda")
    cls = (GPipeStrategy if repl is None else HeteroPipeDreamStrategy
           if strategy == "pipedream" else HeteroGPipeStrategy)
    s = cls(hyb_cut_model().to(devs[0]), cfg, devs)
    s.init()
    x, y = shard_batches(torch, cfg, 4, 1, dev, seed=7)[0]
    return hyb_update(torch, s, (x[:, :HYB_CUT_T], y[:, :HYB_CUT_T]),
                      SHARD_LR)


def pipe_hetero(torch, fa, fx, dev):
    """hetero_train (module docstring, 17): the plan's bfloat16 main path
    through make_strategy for gpipe and pipedream, the counters zeroed
    before each and read after; then the float32 cut checks. Returns the
    B1-B6 launches of the main-path runs."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.parallel.api import make_strategy

    t_start = time.perf_counter()
    launches = {n: 0 for n in PIPE_COUNTERS}
    rows, checks = {}, {}
    card = card_line()
    for strategy, kw in HET_RUNS:
        cfg = RunConfig(benchmark=PIPE_TOKEN[1], arch=PIPE_TOKEN[0],
                        strategy=strategy, num_devices=sum(HET_REPL),
                        stage_replication=HET_REPL, compute_dtype="bfloat16",
                        seed=0, **kw)
        s = make_strategy(cfg, dev, shared_card=dev.type == "cuda")
        B = cfg.global_batch()
        data = make_synthetic(cfg.dataset(), B, dev, seed=0)
        batches = [data.batch(1, i) for i in range(1 + PIPE_TIMED)]
        counters, plain0 = pipe_counted(fa, fx)
        dt, losses = pipe_timed(torch, s, batches, cfg.resolved_lr())
        got = {n: fn.launches for n, fn in counters.items()}
        want = hetero_expected(s, 1 + PIPE_TIMED)
        plain = fa.flash_attention.plain_launches - plain0
        checks[f"d_launches_{strategy}"] = got == want and plain == 0
        for n in PIPE_COUNTERS:
            launches[n] += got[n]
        rows[strategy] = {"tokens_per_sec": PIPE_TIMED * B * 1024 / dt,
                          "ms_per_step": 1e3 * dt / PIPE_TIMED,
                          "losses": losses, "global_batch": B,
                          "microbatch": s.mb,
                          "microbatches": s.num_microbatches,
                          "bounds": s.bounds, "launches": got,
                          "launches_expected": want, "card": card}
        del s, data, batches
        gc.collect()
        torch.cuda.empty_cache()
    f32 = {}
    for strategy in ("gpipe", "pipedream"):
        lc, uc = het_cut_step(torch, strategy, dev, HET_REPL)
        lp, up = het_cut_step(torch, strategy, torch.device("cpu"),
                              HET_REPL)
        r = {"loss_card": lc, "loss_cpu": lp,
             "loss_rel": abs(lc - lp) / abs(lp)}
        r["worst_update_rel_l2"], r["worst_update_leaf"] = worst_update(
            torch, uc, up)
        r["ok"] = (r["loss_rel"] <= SHARD_F32_LOSS
                   and r["worst_update_rel_l2"] <= SHARD_CPU_UPDATE)
        if strategy == "gpipe":
            lu, uu = het_cut_step(torch, "gpipe", dev, None)
            r["uniform"] = {"loss": lu, "loss_rel": abs(lc - lu) / abs(lu),
                            "worst_update_rel_l2": worst_update(
                                torch, uc, uu)[0]}
            r["ok"] = (r["ok"] and r["uniform"]["loss_rel"]
                       <= HET_UNIFORM_REL and
                       r["uniform"]["worst_update_rel_l2"]
                       <= HET_UNIFORM_REL)
        checks[f"a_{strategy}_f32"] = r["ok"]
        f32[strategy] = r
    emit({"phase": "hetero_train", "model": PIPE_TOKEN[0],
          "benchmark": PIPE_TOKEN[1], "stage_replication": HET_REPL,
          "shared_card": True, "dtype": "bfloat16", "rows": rows,
          "a_f32": f32, "a_cut": {"blocks": HYB_CUT, "tokens": HYB_CUT_T},
          "checks": checks, "seconds": time.perf_counter() - t_start})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"hetero checks failed: {failed}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---- 17b: profile -> partition -> plan (plan_train) ------------------------
PLAN_MB = 4  # pipe_train's gpipe micro-batch: 4 x 1 024 tokens a profile
PLAN_REPEATS = 5  # timed samples a node (after profile.py's 2 warm-ups)
PLAN_WARMUP = 2
# (b)'s float32 card-vs-CPU step at the plan's bounds and cost vectors,
# cut in depth: mb 2 x M 4 on HYB_CUT_T tokens (the bars: SHARD_F32_LOSS,
# SHARD_CPU_UPDATE)
PLAN_CUT_MB, PLAN_CUT_M = 2, 4
# (d): one float32 capture of 2 rows x HYB_CUT_T tokens; every activation
# and gradient within this share of the CPU array's largest magnitude
PLAN_ACT_ROWS = 2
ACT_F32_TOL = 1e-3
def plan_cfg(**kw):
    """transformer_s / synthtext on PIPE_S stages of the one card, seed 0."""
    from ddlbench_tpu_torch.config import RunConfig

    return RunConfig(benchmark=PIPE_TOKEN[1], arch=PIPE_TOKEN[0],
                     strategy="gpipe", num_devices=PIPE_S, seed=0, **kw)


def counted(fa, fx, fn):
    """(fn(), the B1-B6 launches it made, its plain attention calls)."""
    counters, plain0 = pipe_counted(fa, fx)
    out = fn()
    return (out, {n: c.launches for n, c in counters.items()},
            fa.flash_attention.plain_launches - plain0)


def plan_profile(torch, fa, fx, dev):
    """(a): the flops profile on the card and on the CPU (equal, node for
    node), the time profile on the card (its launches, every block's fwd
    and bwd > 0), and a single float32 step of the same rows timed."""
    import dataclasses

    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.profiler.profile import profile_model

    model = get_model(*PIPE_TOKEN, seed=0)
    g_cpu = profile_model(model, PLAN_MB, mode="flops")
    model = model.to(dev)
    g_card = profile_model(model, PLAN_MB, mode="flops")
    nodes = lambda g: [dataclasses.asdict(n) for n in g.topological_sort()]
    t0 = time.perf_counter()
    g_time, got, plain = counted(fa, fx, lambda: profile_model(
        model, PLAN_MB, mode="time", repeats=PLAN_REPEATS))
    time_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    calls = PLAN_WARMUP + PLAN_REPEATS
    want = {n: 0 for n in PIPE_COUNTERS}
    want.update(flash_fwd=2 * calls * LAYERS, flash_dq=calls * LAYERS,
                flash_dkv=calls * LAYERS)
    blocks = [n for n in g_time.topological_sort()
              if n.node_desc.startswith("block")]
    cfg = RunConfig(benchmark=PIPE_TOKEN[1], arch=PIPE_TOKEN[0],
                    batch_size=PLAN_MB, compute_dtype="float32", seed=0)
    single = make_strategy(cfg, dev)
    x, y = make_synthetic(cfg.dataset(), PLAN_MB, dev, seed=0).batch(1, 0)
    single.train_step(x, y, cfg.resolved_lr())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        single.train_step(x, y, cfg.resolved_lr())
    torch.cuda.synchronize()
    single_ms = 1e3 * (time.perf_counter() - t1) / 3
    del single
    torch.cuda.empty_cache()
    total = sum(n.forward_compute_time + n.backward_compute_time
                for n in g_time.nodes.values())
    rec = {"micro_batch": PLAN_MB, "dtype": "float32",
           "flops_graph_nodes": len(g_card.nodes),
           "flops_ms": {n.node_desc: [n.forward_compute_time,
                                      n.backward_compute_time]
                        for n in g_card.topological_sort()},
           "time_ms": {n.node_desc: [n.forward_compute_time,
                                     n.backward_compute_time]
                       for n in g_time.topological_sort()},
           "time_sum_ms": total, "single_f32_step_ms": single_ms,
           "time_sum_over_step": total / single_ms,
           "time_profile_s": time_s, "repeats": PLAN_REPEATS,
           "launches": got, "launches_expected": want,
           "plain_launches": plain}
    checks = {"a_flops_card_equals_cpu": (nodes(g_card) == nodes(g_cpu)
                                          and str(g_card) == str(g_cpu)),
              "a_time_blocks_positive": bool(blocks) and all(
                  n.forward_compute_time > 0 and n.backward_compute_time > 0
                  for n in blocks),
              "a_launches": got == want and plain == 0}
    return rec, checks, got


def plan_cut_step(torch, part, dev):
    """(b)'s float32 step of the plan's bounds and cost vectors, cut to
    PLAN_CUT_MB x PLAN_CUT_M rows of HYB_CUT_T tokens, on ``dev``: (loss,
    update)."""
    from ddlbench_tpu_torch.parallel.api import AutoPartition, make_strategy

    cfg = part.cfg.replace(compute_dtype="float32", optimizer="sgd",
                           micro_batch_size=PLAN_CUT_MB,
                           num_microbatches=PLAN_CUT_M)
    s = make_strategy(cfg, dev, shared_card=dev.type == "cuda",
                      partition=AutoPartition(cfg, part.bounds, part.graph,
                                              part.cuts))
    rows = PLAN_CUT_MB * PLAN_CUT_M
    x, y = shard_batches(torch, cfg, rows, 1, dev, seed=7)[0]
    return hyb_update(torch, s, (x[:, :HYB_CUT_T], y[:, :HYB_CUT_T]),
                      SHARD_LR)


def plan_execute(torch, fa, fx, dev):
    """(b): --auto-partition --pipe-schedule 1f1b --pipe-costs profile on
    PIPE_S stages of the card through make_strategy, bf16 steps timed in
    turns with the default balanced split's unit-cost 1f1b; its launches
    (counted), then the float32 cut step against the CPU's."""
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.parallel.api import auto_partition, make_strategy

    cfg = plan_cfg(auto_partition=True, pipe_schedule="1f1b",
                   pipe_costs="profile", compute_dtype="bfloat16")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        part = auto_partition(cfg, dev)
        planned = make_strategy(cfg, dev, shared_card=dev.type == "cuda",
                                partition=part)
        balanced = pipe_strategy(torch, PIPE_TOKEN[0], PIPE_TOKEN[1], "gpipe",
                                 dev, pipe_schedule="1f1b")
    lines = out.getvalue().splitlines()
    print(out.getvalue(), end="", flush=True)
    B, lr = cfg.global_batch(), cfg.resolved_lr()
    data = make_synthetic(cfg.dataset(), B, dev, seed=0)
    batches = [data.batch(1, i) for i in range(1 + PIPE_TIMED)]
    dt_bal, loss_bal = pipe_timed(torch, balanced, batches, lr)
    (dt, losses), got, plain = counted(
        fa, fx, lambda: pipe_timed(torch, planned, batches, lr))
    want = pipe_expected(planned, "1f1b" if planned._fused_bw
                         else "zero-bubble", 1 + PIPE_TIMED)
    rec = {"plan_lines": [ln for ln in lines
                          if ln.startswith("auto-partition")],
           "executed_bounds": planned.bounds,
           "cost_vectors": part.cfg.pipe_cost_vectors,
           "stage_replication": part.cfg.stage_replication,
           "dp_replicas": part.cfg.dp_replicas,
           "balanced_bounds": balanced.bounds, "global_batch": B,
           "ms_per_step": 1e3 * dt / PIPE_TIMED,
           "balanced_ms_per_step": 1e3 * dt_bal / PIPE_TIMED,
           "losses": losses, "balanced_losses": loss_bal,
           "launches": got, "launches_expected": want,
           "plain_launches": plain, "card": card_line()}
    del planned, balanced, data, batches
    gc.collect()
    torch.cuda.empty_cache()
    lc, uc = plan_cut_step(torch, part, dev)
    lp, up = plan_cut_step(torch, part, torch.device("cpu"))
    r = {"loss_card": lc, "loss_cpu": lp, "loss_rel": abs(lc - lp) / abs(lp),
         "rows": PLAN_CUT_MB * PLAN_CUT_M, "tokens": HYB_CUT_T}
    r["worst_update_rel_l2"], r["worst_update_leaf"] = worst_update(
        torch, uc, up)
    r["ok"] = (r["loss_rel"] <= SHARD_F32_LOSS
               and r["worst_update_rel_l2"] <= SHARD_CPU_UPDATE)
    rec["b_card_vs_cpu_f32"] = r
    checks = {"b_launches": got == want and plain == 0,
              "b_bounds_executed": planned_bounds_ok(rec, part),
              "b_card_vs_cpu_f32": r["ok"]}
    torch.cuda.empty_cache()
    return rec, checks, got


def planned_bounds_ok(rec, part) -> bool:
    """The strategy runs the plan's bounds, weighted by its vectors."""
    return (list(rec["executed_bounds"]) == list(part.bounds)
            and rec["cost_vectors"] is not None
            and rec["plan_lines"] != [])


def plan_auto_solve():
    """(c): --plan auto at world PIPE_S in flops mode with the H100
    HardwareModel: (record, rewrite)."""
    import dataclasses

    from ddlbench_tpu_torch.partition.planner import plan_for_config

    cfg = plan_cfg(plan="auto", compute_dtype="bfloat16")
    plan, rewrite, _ = plan_for_config(cfg)
    resolved = cfg.replace(**rewrite)
    resolved.validate()
    rec = {"hardware": dataclasses.asdict(cfg.hardware),
           "winner": plan.winner.as_record(), "reason": plan.reason,
           "candidates": [c.as_record() for c in plan.candidates],
           "rewrite": {k: list(v) if isinstance(v, tuple) else v
                       for k, v in rewrite.items()},
           "ranks": resolved.spawned_ranks()}
    return rec, rewrite


def plan_auto_steps(torch, fa, fx, cfg, dev, comm=None):
    """One warm-up and PIPE_TIMED timed bf16 steps of the resolved --plan
    auto config through make_strategy (on ``comm``'s ranks when the plan
    spawns them), the counters zeroed before and read after."""
    from ddlbench_tpu_torch.parallel.api import make_strategy

    s = make_strategy(cfg, dev, comm, shared_card=dev.type == "cuda")
    rows = cfg.global_batch()
    batches = shard_batches(torch, cfg, rows, 1 + PIPE_TIMED, dev)
    (dt, losses), got, plain = counted(
        fa, fx, lambda: pipe_timed(torch, s, batches, SHARD_LR))
    want = (pipe_expected(s, "1f1b" if getattr(s, "_fused_bw", True)
                          else "zero-bubble", 1 + PIPE_TIMED)
            if cfg.strategy == "gpipe" else None)
    rec = {"ms_per_step": 1e3 * dt / PIPE_TIMED, "losses": losses,
           "global_batch": rows, "bounds": getattr(s, "bounds", None),
           "launches": got, "launches_expected": want,
           "plain_launches": plain}
    del s, batches
    torch.cuda.empty_cache()
    return rec


def plan_actlog(torch, fa, fx, dev):
    """(d): one float32 capture of the activation logger under single on
    transformer_s, on the card (its launches counted) and on the CPU."""
    import tempfile

    import numpy as np

    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.parallel.api import make_strategy
    from ddlbench_tpu_torch.train.loop import activation_logger

    arrays = {}
    with tempfile.TemporaryDirectory(prefix="ddlb_actlog_") as tmp:
        for where in ("card", "cpu"):
            d = dev if where == "card" else torch.device("cpu")
            cfg = RunConfig(benchmark=PIPE_TOKEN[1], arch=PIPE_TOKEN[0],
                            batch_size=PLAN_ACT_ROWS, compute_dtype="float32",
                            seed=0, activation_log_dir=f"{tmp}/{where}")
            s = make_strategy(cfg, d)
            logger = activation_logger(cfg, s, 0)
            x, y = shard_batches(torch, cfg, PLAN_ACT_ROWS, 1, d, seed=3)[0]
            x, y = x[:, :HYB_CUT_T], y[:, :HYB_CUT_T]
            path, got, plain = counted(fa, fx,
                                       lambda: logger.log(1, 0, x, y))
            if where == "card":
                launches, plain_card = got, plain
            with np.load(path) as f:
                arrays[where] = {k: f[k] for k in f.files}
            del s
            torch.cuda.empty_cache()
    card, cpu = arrays["card"], arrays["cpu"]
    worst = max((float(np.abs(card[k] - cpu[k]).max())
                 / max(float(np.abs(cpu[k]).max()), 1e-30), k)
                for k in cpu)
    want = {n: 0 for n in PIPE_COUNTERS}
    want.update(flash_fwd=LAYERS, flash_dq=LAYERS, flash_dkv=LAYERS)
    rec = {"keys": len(cpu), "rows": PLAN_ACT_ROWS, "tokens": HYB_CUT_T,
           "worst_rel_to_max": worst[0], "worst_key": worst[1],
           "tol": ACT_F32_TOL, "loss_card": float(card["loss"]),
           "loss_cpu": float(cpu["loss"]), "launches": launches,
           "launches_expected": want, "plain_launches": plain_card}
    checks = {"d_keys_equal": sorted(card) == sorted(cpu),
              "d_card_vs_cpu": worst[0] <= ACT_F32_TOL,
              "d_launches": launches == want and plain_card == 0}
    return rec, checks, launches


def phase_plan_train(torch, fa, fx, dev):
    """Phase 17b (module docstring): profile -> partition -> plan on the
    card. Returns (the B1-B6 launches of its main-path runs: the time
    profile, the executed plan's steps, the activation capture, and the
    --plan auto winner's steps when it runs in this process; (c)'s
    rewrite, which the sharded spawn's ranks must arrive at)."""
    t_start = time.perf_counter()
    launches = {n: 0 for n in PIPE_COUNTERS}
    line = {"phase": "plan_train", "model": PIPE_TOKEN[0],
            "benchmark": PIPE_TOKEN[1], "stages": PIPE_S,
            "shared_card": True, "card": card_line(),
            "hbm_bytes_model": None, "total_memory": torch.cuda
            .get_device_properties(dev).total_memory}
    checks, seconds = {}, {}
    for key, fn in (("a_profile", plan_profile), ("b_plan", plan_execute),
                    ("d_actlog", plan_actlog)):
        t0 = time.perf_counter()
        rec, ch, got = fn(torch, fa, fx, dev)
        seconds[key] = time.perf_counter() - t0
        line[key] = rec
        checks.update(ch)
        for n in PIPE_COUNTERS:
            launches[n] += got[n]
    t0 = time.perf_counter()
    rec, rewrite = plan_auto_solve()
    line["hbm_bytes_model"] = rec["hardware"]["hbm_bytes"]
    if rec["ranks"] == 0:
        cfg = plan_cfg(plan="auto", compute_dtype="bfloat16").replace(
            **rewrite)
        rec["run"] = plan_auto_steps(torch, fa, fx, cfg, dev)
        checks["c_launches"] = (rec["run"]["plain_launches"] == 0 and (
            rec["run"]["launches_expected"] is None
            or rec["run"]["launches"] == rec["run"]["launches_expected"]))
        for n in PIPE_COUNTERS:
            launches[n] += rec["run"]["launches"][n]
    else:
        rec["run"] = "on the sharded spawn's ranks: plan_auto_train"
    seconds["c_plan_auto"] = time.perf_counter() - t0
    line["c_plan_auto"] = rec
    line["checks"] = checks
    line["seconds"] = {**seconds, "total": time.perf_counter() - t_start}
    emit(line)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"plan checks failed: {failed}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec["rewrite"]


def plan_auto_cell(torch, comm2, comm4):
    """The --plan auto winner on the sharded spawn's ranks (phase 25b):
    rank 0 solves and broadcasts (planner.resolve_auto_plan), and the
    ranks the plan spawns run its steps. Only the rank count where the
    plan runs in one process (phase 17b ran it)."""
    import dataclasses

    from ddlbench_tpu_torch.ops import flash_attention as fa
    from ddlbench_tpu_torch.ops import fused_xent as fx
    from ddlbench_tpu_torch.partition.planner import resolve_auto_plan

    t0 = time.perf_counter()
    cfg = plan_cfg(plan="auto", compute_dtype="bfloat16")
    with contextlib.redirect_stdout(io.StringIO()):
        resolved = resolve_auto_plan(cfg, comm=comm4)
    ranks = resolved.spawned_ranks()
    comm = {2: comm2, comm4.world: comm4}.get(ranks)
    if ranks == 0 or comm is None:
        return {"ranks": ranks, "rewrite_strategy": resolved.strategy}
    rec = plan_auto_steps(torch, fa, fx, resolved, comm.device, comm)
    rec.update(ranks=ranks, strategy=resolved.strategy,
               config={k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in dataclasses.asdict(resolved).items()
                       if k in PLAN_REWRITE_KEYS},
               seconds=time.perf_counter() - t0)
    return rec


# the fields of planner._rewrite_fields, compared rank against solver
PLAN_REWRITE_KEYS = ("plan", "auto_partition", "plan_bounds", "num_stages",
                     "dp_replicas", "tp_size", "dp_shard_update",
                     "batch_size", "micro_batch_size", "num_microbatches",
                     "pipe_schedule", "strategy")


def plan_auto_line(shared4, rewrite):
    """Phase 25b's line from the ranks' --plan auto cells (each rank's
    config held to ``rewrite``, phase 17b's solve): emits plan_auto_train
    and returns the B1-B6 launches of every rank's steps (none where the
    plan ran in one process)."""
    launches = {n: 0 for n in SHARD_COUNTERS}
    cells = [r.get("plan_auto") for r in shared4]
    runs = [c for c in cells if c and "launches" in c]
    if not runs:
        return launches
    checks = {}
    for r, c in zip(shared4, cells):
        if not (c and "launches" in c):
            continue
        who = f"rank{r['rank']}"
        checks[f"c_launches_{who}"] = (c["plain_launches"] == 0 and (
            c["launches_expected"] is None
            or c["launches"] == c["launches_expected"]))
        checks[f"c_same_plan_{who}"] = c["config"] == {
            k: v for k, v in rewrite.items() if k in PLAN_REWRITE_KEYS}
        checks[f"c_finite_{who}"] = all(math.isfinite(v)
                                        for v in c["losses"])
        for n in SHARD_COUNTERS:
            launches[n] += c["launches"][n]
    checks["c_same_losses"] = all(c["losses"] == runs[0]["losses"]
                                  for c in runs)
    emit({"phase": "plan_auto_train", "model": PIPE_TOKEN[0],
          "shared_card": True, "card": card_line(), "dtype": "bfloat16",
          "ranks": runs[0]["ranks"], "config": runs[0]["config"],
          "rank0": {k: v for k, v in runs[0].items() if k != "config"},
          "launches": {f"rank{i}": c["launches"]
                       for i, c in enumerate(cells) if c and "launches" in c},
          "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"plan auto checks failed: {failed}")
    return launches


PACKED_ARCHS = ("inception", "nasnet")
PACKED_BENCH = "cifar10"


def packed_f64_step(torch, arch, dev):
    """``arch`` / cifar10 under gpipe at 2 stages (its packed chain, built
    by make_strategy) in float64 at mb 2 x M 2 from seed 0's weights, one
    step: (loss, every chunk's gradient, the running statistics)."""
    from ddlbench_tpu_torch.config import RunConfig
    from ddlbench_tpu_torch.data.synthetic import make_synthetic
    from ddlbench_tpu_torch.parallel.api import make_strategy

    cfg = RunConfig(benchmark=PACKED_BENCH, arch=arch, strategy="gpipe",
                    num_devices=2, micro_batch_size=2, num_microbatches=2,
                    compute_dtype="float32", seed=0)
    s = make_strategy(cfg, dev, shared_card=dev.type == "cuda")
    s.model.double()
    s.compute_dtype = torch.float64
    s.init()
    rec = recording_updates(s)
    x, y = make_synthetic(cfg.dataset(), 4, torch.device("cpu"),
                          seed=0).batch(0, 0)
    x = x.double()
    if dev.type == "cuda":
        x = x.to(dev).contiguous(memory_format=torch.channels_last)
    loss = float(s.train_step(x, y.to(dev), cfg.resolved_lr())["loss"])
    return (loss, [g for c in sorted(rec) for g in rec[c]],
            [b.detach().double().cpu() for b in s.model.buffers()],
            len(s.model.layers), s.bounds)


def pipe_packed(torch, dev):
    """packed_chain (module docstring, 18): inception and nasnet under
    gpipe at 2 stages of the one card, their node-granular packed
    chains: the float64 step against the CPU's."""
    t_start = time.perf_counter()
    out, checks = {}, {}
    for arch in PACKED_ARCHS:
        got = packed_f64_step(torch, arch, dev)
        cpu = packed_f64_step(torch, arch, torch.device("cpu"))
        out[arch] = {**f64_agreement(got[:3], cpu[:3]), "layers": got[3],
                     "bounds": got[4]}
        checks[f"a_{arch}_float64"] = out[arch]["ok"]
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "packed_chain", "benchmark": PACKED_BENCH, "stages": 2,
          "micro_batch": 2, "microbatches": 2, "shared_card": True,
          "archs": out, "checks": checks,
          "seconds": time.perf_counter() - t_start})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"packed-chain checks failed: {failed}")


def pipe_f64_step(torch, dev):
    """resnet50/imagenet gpipe (fill-drain) at mb 2, M 2 in float64 from
    seed 0's weights, one step on one batch: (loss, every chunk's
    gradient, the running statistics) on the host."""
    mb, M = PIPE_F64_BATCH
    s = pipe_strategy(torch, *PIPE_IMAGE, "gpipe", dev, dtype="float32",
                      micro_batch_size=mb, num_microbatches=M)
    s.model.double()
    s.compute_dtype = torch.float64
    s.init()
    rec = recording_updates(s)
    from ddlbench_tpu_torch.data.synthetic import make_synthetic

    x, y = make_synthetic(s.cfg.dataset(), mb * M, torch.device("cpu"),
                          seed=0).batch(0, 0)
    x = x.double()
    if dev.type == "cuda":
        x = x.to(dev).contiguous(memory_format=torch.channels_last)
    loss = float(s.train_step(x, y.to(dev), s.cfg.resolved_lr())["loss"])
    return (loss, [g for c in sorted(rec) for g in rec[c]],
            [b.detach().double().cpu() for b in s.model.buffers()])


def phase_pipe_image(torch, dev):
    """Phase 18 (module docstring): resnet50 / imagenet on four stages of
    the one card."""
    import copy

    from ddlbench_tpu_torch.data.synthetic import make_synthetic

    model, bench = PIPE_IMAGE
    t_start = time.perf_counter()
    # (a) the card's float64 gpipe step against the CPU's
    t0 = time.perf_counter()
    cpu = pipe_f64_step(torch, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    f64 = f64_agreement(pipe_f64_step(torch, dev), cpu)
    gc.collect()
    torch.cuda.empty_cache()
    rows, checks = {}, {"a_float64_card_vs_cpu": f64["ok"]}
    replay_rel = None
    card = card_line()
    for key in ("gpipe", "pipedream"):
        s = pipe_strategy(torch, model, bench, key, dev)
        B = s.mb * s.num_microbatches
        lr = s.cfg.resolved_lr()
        data = make_synthetic(s.cfg.dataset(), B, dev, seed=0)
        batches = [data.batch(1, i) for i in range(1 + PIPE_TIMED)]
        initial = {k: v.clone() for k, v in s.model.state_dict().items()}
        snap = {}
        dt, losses = pipe_timed(torch, s, batches, lr, (
            2, lambda: snap.__setitem__("p", params_of(s))))
        if key == "pipedream":
            # (c) the first two steps against the replay on the card
            replica = copy.deepcopy(s.model)
            replica.load_state_dict(initial)
            replay = pipedream_replay(torch, s, replica, batches[:2], lr)
            replay_rel = rel_change(torch, snap["p"], [
                initial[n] for n, _ in s.model.named_parameters()], replay)
            checks["c_pipedream_vs_replay"] = replay_rel <= PIPE_REPLAY_REL
            del replica, replay
        rows[key] = {"images_per_sec": PIPE_TIMED * B / dt,
                     "ms_per_step": 1e3 * dt / PIPE_TIMED,
                     "losses": losses, "global_batch": B,
                     "microbatch": s.mb,
                     "microbatches": s.num_microbatches,
                     "bounds": s.bounds, "card": card}
        del s, data, batches, initial, snap
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "pipe_image", "model": model, "benchmark": bench,
          "stages": PIPE_S, "shared_card": True, "dtype": "bfloat16",
          "rows": rows, "a_float64": {**f64, "batch": PIPE_F64_BATCH,
                                      "cpu_seconds": cpu_s},
          "c_replay_rel_l2": replay_rel, "c_bar": PIPE_REPLAY_REL,
          "checks": checks, "seconds": time.perf_counter() - t_start})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"pipeline image checks failed: {failed}")
    pipe_packed(torch, dev)


# ---- 19-21: the sharded one-program strategies (sp, ep, fsdp) ----------
SHARD_TOKEN = ("transformer_s", "synthtext")
SHARD_MOE = ("transformer_moe_s", "synthtext")
SHARD_IMAGE = ("resnet50", "imagenet")
SHARD_ROWS = 8  # the global batch of every token row (4 a rank under ep/fsdp)
SHARD_IMAGE_ROWS = 4  # resnet50's float64 global batch (2 a rank)
SHARD_TIMED = 1  # timed bfloat16 steps after the compared one
SHARD_LR = 0.01
SHARD_CUT = 2  # sp (b): transformer_s cut to its first 2 blocks,
SHARD_CUT_ROWS, SHARD_CUT_T = 1, 256  # one 256-token row
SHARD_COUNTERS = tuple(FLASH_KERNELS) + tuple(FX_KERNELS)
# The bars of (a), the sharded step's loss and reduced gradient against
# single's on the same rows (ep's compared steps pinned to one routing,
# shard_token_cell). The gradient, not the update: an SGD update measured
# as parameters after minus before carries the float32 rounding of the
# new parameters, a floor of about one ulp of the weight against lr x
# grad. (Every strategy, single included, now updates by one formula,
# common.flat_optimizer; tp_train compares the update too.) float32:
# the loss within SHARD_F32_LOSS relative and each leaf's gradient
# within SHARD_F32_GRAD relative L2, only the order of the sums
# differing (a misrouted gradient is O(1)); bfloat16: the loss within
# SHARD_BF16_LOSS and each leaf's gradient within SHARD_BF16_FLOOR or
# twice single's own bfloat16 distance to its float32 gradient (the ring
# combines bf16-rounded block outputs, and bf16 rounds a 4-row step apart
# from an 8-row one), whichever is larger. fsdp's resnet50 step in
# float64 with sync-BN: the loss, every gradient leaf and every running
# statistic within IMAGE_F64_RTOL of single's (dp_image's check). (b) sp
# on the card against the same step of gloo ranks on the CPU (the plain
# versions, the same optimizer on both), float32, depth SHARD_CUT: the
# loss within SHARD_F32_LOSS, each update within SHARD_CPU_UPDATE.
SHARD_F32_LOSS, SHARD_F32_GRAD = 1e-5, 1e-4
SHARD_BF16_LOSS, SHARD_BF16_FLOOR = 2e-3, 1e-2
SHARD_CPU_UPDATE = 1e-3


def shard_cfg(strategy, world, arch, bench, dtype, rows, **kw):
    from ddlbench_tpu_torch.config import RunConfig

    per = rows if strategy in ("sp", "single", "tp") else rows // world
    base = dict(benchmark=bench, arch=arch, strategy=strategy,
                num_devices=world, batch_size=per, compute_dtype=dtype,
                attention_backend="auto", seed=0, optimizer="sgd",
                moe_aux_weight=0.0, moe_capacity_factor=8.0)
    return RunConfig(**{**base, **kw})


def shard_batches(torch, cfg, rows, n, dev, seed=0):
    """``n`` global batches of ``rows`` rows of cfg's data, made on the
    CPU (the same tokens for the card and the CPU ranks) and moved."""
    from ddlbench_tpu_torch.data.synthetic import make_synthetic

    data = make_synthetic(cfg.dataset(), rows, torch.device("cpu"),
                          seed=seed)
    out = []
    for i in range(n):
        x, y = data.batch(0, i)
        if x.dim() == 4:
            x = x.contiguous(memory_format=torch.channels_last)
        out.append((x.to(dev), y.to(dev)))
    return out


def named_of(strategy):
    if hasattr(strategy, "named_params"):
        return {k: v.detach().float().clone()
                for k, v in strategy.named_params().items()}
    return {f"{i}.{n}": p.detach().float().clone()
            for i, layer in enumerate(strategy.model.layers)
            for n, p in layer.named_parameters()}


def update_of(torch, strategy, batch, lr, ms=None):
    """One train step's (loss, {name: update}) on ``batch``; its wall ms,
    the card synchronised before, appended to ``ms`` where given."""
    before = named_of(strategy)
    if ms is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    m = strategy.train_step(*batch, lr)
    loss = m["loss"].item()
    if ms is not None:
        ms.append(1e3 * (time.perf_counter() - t0))
    after = named_of(strategy)
    return loss, {k: after[k] - before[k] for k in before}


def worst_update(torch, got, want):
    """(the largest relative L2 distance of a leaf of ``got`` from
    ``want``'s, that leaf's name)."""
    return max((rel_l2(torch, got[k], want[k]), k) for k in want)


def grads_of(torch, strategy, batch):
    """The sharded step's forward and backward on ``batch`` without the
    update (``reduced_grads``): (the loss, {"<layer>.<name>": the whole
    gradient, summed over the ranks}), sharded pieces all-gathered (a
    collective every rank calls)."""
    m, grads = strategy.reduced_grads(*batch)
    out = {}
    if hasattr(strategy, "shards"):  # fsdp: one flat shard a layer
        for i, g in enumerate(grads):
            if strategy.lengths[i]:
                full = strategy.comm.all_gather(g.contiguous())
                out.update({f"{i}.{n}": t.detach().clone() for n, t in
                            strategy._views(i, full).items()})
    else:
        for (n, _), g in zip(strategy._named(), grads):
            if strategy._is_sharded(n):
                g = strategy._gather_sharded(n, g)
            out[n] = g.detach().clone()
    return m["loss"].item(), out


def single_grads(torch, single, batch):
    """single's loss and gradients on ``batch`` (loss_and_grads, no
    update), by "<layer>.<name>"."""
    from ddlbench_tpu_torch.parallel.common import loss_and_grads

    ce, _, grads = loss_and_grads(single.model, single.cfg, *batch,
                                  single.compute_dtype, single.smoothing)
    names = [f"{i}.{n}" for i, layer in enumerate(single.model.layers)
             for n, _ in layer.named_parameters()]
    return ce.item(), {n: g.detach().clone() for n, g in zip(names, grads)}


def routing_of(torch, strategy):
    """Each MoE block's routing in its last forward: (the experts, one
    [S] tensor a block, and how many tokens the router's own argmax
    would have sent elsewhere, a count a block: nonzero only under
    pinned_experts)."""
    from ddlbench_tpu_torch.models.moe import moe_blocks

    routes = [b.last_route for b in moe_blocks(strategy.model)]
    return ([r.expert.clone() for r in routes],
            [int((r.probs.argmax(-1) != r.expert).sum()) for r in routes])


def shard_run(torch, comm, strategy, model, dtype, rows, batches, pin=()):
    """The sharded main path on this rank: make_strategy, the counters
    zeroed, one compared step (grads_of: the forward and backward, its
    MoE blocks pinned to ``pin``'s experts where given, pinned_experts)
    and the timed train steps: (loss, gradients, launches, plain-path
    calls, ms per timed step, the strategy, the compared step's
    routing_of or None for a dense model)."""
    from ddlbench_tpu_torch.ops import flash_attention as fa
    from ddlbench_tpu_torch.parallel.api import make_strategy

    cfg = shard_cfg(strategy, comm.world, *model, dtype, rows)
    strat = make_strategy(cfg, comm.device, comm)
    counters = dp_counters()
    for fn in counters.values():
        fn.launches = 0
    plain0 = fa.flash_attention.plain_launches
    with (pinned_experts(torch, pin) if pin else contextlib.nullcontext()):
        loss, grads = grads_of(torch, strat, batches[0])
    routing = routing_of(torch, strat) if strategy == "ep" else None
    ms = []
    for x, y in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strat.train_step(x, y, SHARD_LR)["loss"].item()
        ms.append(1e3 * (time.perf_counter() - t0))
    return (loss, grads, {n: fn.launches for n, fn in counters.items()},
            fa.flash_attention.plain_launches - plain0, ms, strat, routing)


def vs_single(torch, comm, model, dtype, rows, batch, loss, grads,
              ref=None, pin=()):
    """(a) on rank 0: the sharded step's loss and gradients against
    single's on the same rows (the bars above), single's MoE blocks
    pinned to ``pin``'s experts where given; ``ref`` is single's float32
    gradients, the bfloat16 bar's reference. Returns (record, single's
    gradients)."""
    from ddlbench_tpu_torch.parallel.api import make_strategy

    single = make_strategy(shard_cfg("single", 1, *model, dtype, rows),
                           comm.device)
    with (pinned_experts(torch, pin) if pin else contextlib.nullcontext()):
        s_loss, s_grads = single_grads(torch, single, batch)
    rec = {"loss": loss, "loss_single": s_loss,
           "loss_rel": abs(loss - s_loss) / abs(s_loss)}
    if pin:
        rec["single_own_router_flips"] = routing_of(torch, single)[1]
    rec["worst_grad_rel_l2"], rec["worst_grad_leaf"] = worst_update(
        torch, grads, s_grads)
    if dtype == "float32":
        del single
        torch.cuda.empty_cache()
        rec["ok"] = (rec["loss_rel"] <= SHARD_F32_LOSS
                     and rec["worst_grad_rel_l2"] <= SHARD_F32_GRAD)
        return rec, s_grads
    del single
    torch.cuda.empty_cache()
    rec["single_bf16_vs_f32_worst_grad_rel_l2"] = worst_update(
        torch, s_grads, ref)[0]
    # reported, not a bar: the sharded bf16 step's own distance to
    # single's float32 gradients
    rec["bf16_vs_single_f32_worst_grad_rel_l2"] = worst_update(
        torch, grads, ref)
    rec["grad_bar"] = max(SHARD_BF16_FLOOR,
                          2 * rec["single_bf16_vs_f32_worst_grad_rel_l2"])
    rec["ok"] = (rec["loss_rel"] <= SHARD_BF16_LOSS
                 and rec["worst_grad_rel_l2"] <= rec["grad_bar"])
    return rec, s_grads


def shard_steps(dtype):
    """Steps a cell runs: float32 only its compared one."""
    return 1 if dtype == "float32" else 1 + SHARD_TIMED


def shard_token_cell(torch, comm, strategy, model, tokens):
    """One strategy's token cell on this rank, float32 then bfloat16 (the
    float32 single gradients are the bfloat16 bar's reference): shard_run
    and (a) on rank 0, with the seconds each took. ep: the float32 ep step
    routes by its own routers, and the three compared steps after it
    (single's float32, ep's and single's bfloat16) are pinned to that
    routing (each rank's tokens its own, single's all of them, gathered),
    so the four compute one function and differ by rounding alone."""
    out, ref, local, whole = {}, None, (), ()
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        batches = shard_batches(torch, shard_cfg(strategy, comm.world,
                                                 *model, dtype, SHARD_ROWS),
                                SHARD_ROWS, shard_steps(dtype), comm.device)
        loss, grads, launches, plain, ms, strat, routing = shard_run(
            torch, comm, strategy, model, dtype, SHARD_ROWS, batches, local)
        rec = {"launches": launches, "plain_launches": plain, "loss": loss}
        if routing is not None and not local:
            # the routing every later compared step is pinned to
            local = routing[0]
            whole = [comm.all_gather(e) for e in local]
        elif routing is not None:
            rec["own_router_flips"] = routing[1]
        if ms:
            rec["timed_ms_per_step"] = sum(ms) / len(ms)
            rec["global_tokens_per_s"] = (SHARD_ROWS * tokens * 1e3
                                          / rec["timed_ms_per_step"])
        if strategy == "fsdp":
            rec.update(param_bytes=strat.param_bytes(),
                       opt_bytes=strat.opt_state_bytes(),
                       padded_elements=sum(strat.padded),
                       whole_elements=sum(strat.lengths),
                       layers=len(strat.lengths),
                       regathers=strat.regathers)
        del strat
        torch.cuda.empty_cache()
        rec["run_s"] = time.perf_counter() - t0
        if comm.rank == 0:
            t0 = time.perf_counter()
            rec["vs_single"], s_grads = vs_single(
                torch, comm, model, dtype, SHARD_ROWS, batches[0], loss,
                grads, ref, whole)
            rec["single_s"] = time.perf_counter() - t0
            if dtype == "float32":
                ref = s_grads
        out[dtype] = rec
        del grads, batches
        torch.cuda.empty_cache()
    return out


def sp_cut_step(torch, comm):
    """(b)'s step: sp in float32 on transformer_s cut to SHARD_CUT blocks,
    on SHARD_CUT_ROWS rows of SHARD_CUT_T tokens, on this rank's device:
    (loss, update on the host)."""
    from ddlbench_tpu_torch.models.layers import LayerModel
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.parallel.sp import SPStrategy

    full = get_model(*SHARD_TOKEN, seed=0)
    cut = LayerModel(full.name, list(full.layers[:1 + SHARD_CUT])
                     + [full.layers[-1]], full.in_shape, full.num_classes)
    cfg = shard_cfg("sp", comm.world, *SHARD_TOKEN, "float32",
                    SHARD_CUT_ROWS)
    strat = SPStrategy(cut.to(comm.device), cfg, comm)
    strat.init()
    x, y = shard_batches(torch, cfg, SHARD_CUT_ROWS, 1, comm.device,
                         seed=5)[0]
    loss, upd = update_of(torch, strat, (x[:, :SHARD_CUT_T],
                                         y[:, :SHARD_CUT_T]), SHARD_LR)
    return loss, {k: v.cpu() for k, v in upd.items()}


def sp_card_vs_cpu(torch, comm):
    """(b): the cut sp step on the card, then the same step on the CPU
    over the same gloo group (gloo takes CPU tensors as they are; the
    plain versions run there); rank 0 compares."""
    import dataclasses

    card = sp_cut_step(torch, comm)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // comm.world))
    try:
        cpu = sp_cut_step(torch, dataclasses.replace(
            comm, device=torch.device("cpu"), staged=frozenset()))
    finally:
        torch.set_num_threads(threads)
    if comm.rank:
        return None
    rec = {"loss_card": card[0], "loss_cpu": cpu[0],
           "loss_rel": abs(card[0] - cpu[0]) / abs(cpu[0])}
    rec["worst_update_rel_l2"], rec["worst_update_leaf"] = worst_update(
        torch, card[1], cpu[1])
    rec["ok"] = (rec["loss_rel"] <= SHARD_F32_LOSS
                 and rec["worst_update_rel_l2"] <= SHARD_CPU_UPDATE)
    return rec


def fsdp_image_f64(torch, comm):
    """resnet50 / imagenet under fsdp in float64 on SHARD_IMAGE_ROWS rows
    (sync-BN): the loss, the reduce-scattered gradient gathered whole and
    the running statistics against single's on the same rows (rank 0
    compares, dp_image's f64_agreement)."""
    import dataclasses

    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.parallel.sharded import FSDPStrategy

    dev = comm.device
    cfg = shard_cfg("fsdp", comm.world, *SHARD_IMAGE, "float32",
                    SHARD_IMAGE_ROWS)

    def model64():
        return get_model(*SHARD_IMAGE, seed=0).to(dev, torch.float64).to(
            memory_format=torch.channels_last)

    x, y = shard_batches(torch, cfg, SHARD_IMAGE_ROWS, 1, dev)[0]
    x = x.to(torch.float64).contiguous(memory_format=torch.channels_last)
    strat = FSDPStrategy(model64(), cfg, comm)
    strat.compute_dtype = torch.float64  # the model's own type
    strat.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = grads_of(torch, strat, (x, y))
    peak = torch.cuda.max_memory_allocated()
    names = [f"{i}.{n}" for i, layer in enumerate(strat.model.layers)
             for n, _ in layer.named_parameters()]
    got = (loss, [grads[n].cpu() for n in names],
           [b.detach().double().cpu() for b in strat.model.buffers()])
    del strat, grads
    torch.cuda.empty_cache()
    # phase 27: the same step with remat_layers against this one
    remat = remat_image_f64(torch, comm, FSDPStrategy, cfg, x, y, model64,
                            got)
    if comm.rank:
        return None
    single_cfg = dataclasses.replace(cfg, strategy="single", num_devices=1,
                                     batch_size=SHARD_IMAGE_ROWS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    single = image_step(torch, model64(), x, y, single_cfg, None)
    peak_single = torch.cuda.max_memory_allocated()
    rec = f64_agreement(got, single)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    single_remat = image_step(torch, model64(), x, y, dataclasses.replace(
        single_cfg, remat_layers=True), None)
    rec.update(remat=remat, peak_bytes=peak, peak_bytes_single=peak_single,
               single_remat=remat_f64_record(
                   single_remat, single, torch.cuda.max_memory_allocated()))
    torch.cuda.empty_cache()
    return rec


def sharded_shared_rank(comm4):
    """A rank of the world-4 shared-card run: 3-D tpp on all four ranks
    (phase 26), the --plan auto winner on the ranks it spawns (25b: the
    plan solved on rank 0 and broadcast to all four), then on the
    subgroup of ranks 0-1 (world 2; ranks 2-3 are done) the sp, ep and fsdp token cells, fsdp's float64 resnet50
    step (with phase 27's remat rows), sp's (b), tpp's and tp's cells and
    tp's float64 image step (phases 23-24), the hybrid (25), the remat
    token rows (27) and moe_fsdp (28), all in one spawn: a spawn's
    start-up costs tens of seconds."""
    import torch

    from ddlbench_tpu_torch import distributed

    T = 1024
    comm = distributed.subgroup(comm4, [0, 1])
    out = {"rank": comm4.rank, "comm4": comm4.record(),
           "comm": None if comm is None else comm.record()}
    t0 = time.perf_counter()
    out["tpp3d"] = tpp3d_cell(torch, comm4, comm)
    out["tpp3d_s"] = time.perf_counter() - t0
    out["plan_auto"] = plan_auto_cell(torch, comm, comm4)
    if comm is None:
        return out
    for strategy, model in (("sp", SHARD_TOKEN), ("ep", SHARD_MOE),
                            ("fsdp", SHARD_TOKEN)):
        out[strategy] = shard_token_cell(torch, comm, strategy, model, T)
    t0 = time.perf_counter()
    out["fsdp_image"] = fsdp_image_f64(torch, comm)
    out["fsdp_image_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b_card_vs_cpu"] = sp_card_vs_cpu(torch, comm)
    out["b_s"] = time.perf_counter() - t0
    for strategy in ("tpp", "tp"):
        t0 = time.perf_counter()
        out[strategy] = tp_token_cell(torch, comm, strategy)
        out[f"{strategy}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["tp_image"] = tp_image_f64(torch, comm)
    out["tp_image_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["hybrid"] = hybrid_cell(torch, comm)
    out["hybrid_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["remat"] = {s: remat_cell(torch, comm, s) for s in ("fsdp", "tp")}
    out["remat_s"] = time.perf_counter() - t0
    out["moe_fsdp"] = moe_global_cell(torch, comm, "fsdp")
    return out


def sharded_nccl_rank(comm):
    """sp at NCCL world 1: its token cell ((a) against single, launches)."""
    import torch

    return {"comm": comm.record(),
            "sp": shard_token_cell(torch, comm, "sp", SHARD_TOKEN, 1024)}


def shard_expected(strategy, rank, dtype):
    """(c): each kernel's launches on one rank over a cell's steps: B4-B6
    once a step; B1-B3 once per attention layer a step, times rank + 1
    under sp (a causal rank runs its diagonal block and every block
    before it)."""
    steps = shard_steps(dtype)
    blocks = rank + 1 if strategy == "sp" else 1
    return {**{n: LAYERS * blocks * steps for n in FLASH_KERNELS},
            **{n: steps for n in FX_KERNELS}}


def phase_sharded(torch, plan_rewrite):
    """Phases 19-21 and 23-28 (module docstring): the world-4 shared-card
    ranks (3-D tpp on all four, the world-2 cells on ranks 0-1, sp's (b)
    among them), then sp at NCCL world 1 in this process. Emits
    sp_train, ep_train, fsdp_train, tpp_train, tp_train, hybrid_train,
    tpp3d_train, plan_auto_train (its ranks held to ``plan_rewrite``,
    phase 17b's --plan auto solve), remat_train and moe_fsdp, and returns
    the B1-B6
    launches of every rank's main-path steps."""
    from ddlbench_tpu_torch import distributed

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shared4 = distributed.spawn(sharded_shared_rank, T3_WORLD, "cuda",
                                shared_card=True)
    shared = shared4[:2]  # the world-2 subgroup's ranks
    t1 = time.perf_counter()
    nccl = nccl_world1(sharded_nccl_rank)
    t2 = time.perf_counter()
    cpu_b = shared[0]["b_card_vs_cpu"]
    launches = {n: 0 for n in SHARD_COUNTERS}
    failed = []
    for strategy in ("sp", "ep", "fsdp"):
        checks, per_rank = {}, {}
        runs = [(f"rank{r['rank']}", r["rank"], r[strategy]) for r in shared]
        if strategy == "sp":
            runs.append(("nccl", 0, nccl["sp"]))
        for who, rank, cell in runs:
            for dtype, rec in cell.items():
                checks[f"c_{who}_{dtype}"] = (
                    rec["plain_launches"] == 0 and rec["launches"]
                    == shard_expected(strategy, rank, dtype))
                per_rank[f"{who}_{dtype}"] = rec["launches"]
                for n in SHARD_COUNTERS:
                    launches[n] += rec["launches"][n]
                if "vs_single" in rec:
                    checks[f"a_{who}_{dtype}"] = rec["vs_single"]["ok"]
        r0 = shared[0][strategy]
        line = {"phase": f"{strategy}_train",
                "model": (SHARD_MOE if strategy == "ep" else SHARD_TOKEN),
                "global_batch": SHARD_ROWS, "world": 2,
                "steps": {d: shard_steps(d) for d in r0},
                "comm_shared": shared[0]["comm"],
                "cells": {d: {k: v for k, v in rec.items()
                              if k != "launches"} for d, rec in r0.items()},
                "launches": per_rank}
        checks["same_losses_on_both_ranks"] = all(
            shared[1][strategy][d]["loss"] == r0[d]["loss"] for d in r0)
        if strategy == "sp":
            line["nccl_world1"] = {"comm": nccl["comm"], "cells": {
                d: {k: v for k, v in rec.items() if k != "launches"}
                for d, rec in nccl["sp"].items()}}
            line["b_card_vs_cpu"] = cpu_b
            checks["b_card_vs_cpu"] = cpu_b["ok"]
        if strategy == "fsdp":
            for d, rec in r0.items():
                half = 4 * rec["padded_elements"] // 2
                checks[f"bytes_{d}"] = (
                    rec["param_bytes"] == half == rec["opt_bytes"]
                    and 4 * rec["whole_elements"] / 2 <= half
                    <= 4 * (rec["whole_elements"] / 2 + rec["layers"]))
                # every block and the head gathered again for each step's
                # backward (the embedding's backward reads no weight)
                checks[f"regathers_{d}"] = all(
                    r["fsdp"][d]["regathers"]
                    == (LAYERS + 1) * shard_steps(d) for r in shared)
            line["image_float64"] = {
                "model": SHARD_IMAGE, "global_batch": SHARD_IMAGE_ROWS,
                "seconds": shared[0]["fsdp_image_s"],
                **shared[0]["fsdp_image"]}
            checks["a_image_float64"] = shared[0]["fsdp_image"]["ok"]
        line["checks"] = checks
        line["seconds"] = {"shared_spawn": t1 - t0, "b": shared[0]["b_s"],
                           "nccl_world1": t2 - t1}
        emit(line)
        failed += [f"{strategy}:{k}" for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"sharded-strategy checks failed: {failed}")
    for name, n in tp_lines(shared).items():
        launches[name] += n
    for name, n in hybrid_line(shared).items():
        launches[name] += n
    for lines in (tpp3d_line(shared4), plan_auto_line(shared4, plan_rewrite),
                  remat_line(shared),
                  moe_line([r["moe_fsdp"] for r in shared], "fsdp")):
        for name, n in lines.items():
            launches[name] += n
    return launches


# ---- 22-24: tensor parallelism (serve_tp, tpp_train, tp_train) ----------
TP = 2  # the tensor-parallel width of every tp phase
# serve_tp: servebench's serve command at tp 1 and tp 2 over each pool
SERVE_TP_ARGS = ["-m", "transformer_s", "-b", "synthtext", "--policies",
                 "continuous", "--arrival", "closed", "--requests", "16",
                 "--seed", "0", "--wall-clock"]
# tpp_train: 2 stages x tp 2, micro-batch 2 x 2 microbatches (global 4
# rows of 1 024 tokens), the unfused head (the reference's tpp scope)
TPP_STAGES, TPP_MB, TPP_M = 2, 2, 2
TP_ROWS = 4  # tp_train's global batch, replicated on both ranks
TP_TIMED = 1  # timed bfloat16 steps after the compared one
# The bars, stated before the first run: float32 loss, every gradient
# leaf (and tp's update) within TP_F32_REL relative (L2 for a leaf) of
# -f gpipe at 2 stages (tpp) or single (tp) on the same rows, only the
# order of the sums differing; bfloat16 as the sharded cells' (a): the
# loss within SHARD_BF16_LOSS and each leaf within SHARD_BF16_FLOOR or
# twice the reference strategy's own bfloat16 distance to its float32
# gradient, whichever is larger. tp's float64 image step (every leaf
# gathered on use, BatchNorm over the replicated batch) against single's
# within IMAGE_F64_RTOL.
TP_F32_REL = 1e-5
# tp's parameters after its float32 step, every leaf whole, against
# single's: within TP_F32_REL relative L2, and the step itself (after
# minus before) within TP_PARAM_STEP_REL: the new weights' float32
# rounding puts a floor of 4.04e-5 under it at this lr (PERF.md §6, a
# probe on the card), a dropped or misplaced update reads 1 or more
TP_PARAM_STEP_REL = 4e-4
TP_IMAGE = ("resnet18", "cifar10")
# serve_tp's int8 streams at tp 2, stated before the first run: every
# first flip from the float32 streams of the same width within the int8
# noise through tp-2 engines (serve_levers' rule), and that noise on
# every stream's tokens at most INT8_TP_NOISE_RATIO times tp 1's on the
# same tokens. On the CPU (transformer_s, 4 streams) tp 2 over tp 1
# reads 0.93-1.02, and a 2 % scale error on half the shard writes
# 1.41-1.70.
INT8_TP_NOISE_RATIO = 1.25
TP_IMAGE_ROWS = 4


def tp_whole_grads(torch, comm, grads):
    """tpp's per-rank gradients (a Megatron-sliced leaf's is its
    shard's) whole, by "<layer>.<name>": the slices all-gathered and put
    back together (models/transformer.tp_merge_layer_params)."""
    from ddlbench_tpu_torch.models.transformer import (TP_SLICED_KEYS,
                                                       tp_merge_layer_params)

    layers = {}
    for name, g in grads.items():
        i, key = name.split(".", 1)
        layers.setdefault(int(i), {})[key] = g
    out = {}
    for i, named in sorted(layers.items()):
        if "wqkv" in named and "w1" in named:  # a dense (sliced) block
            parts = {k: comm.all_gather(named[k].contiguous()).view(
                comm.world, *named[k].shape) for k in TP_SLICED_KEYS}
            named = tp_merge_layer_params(
                [{k: t[r] for k, t in parts.items()}
                 for r in range(comm.world)],
                {k: v for k, v in named.items() if k not in TP_SLICED_KEYS})
        out.update({f"{i}.{k}": v.detach().clone() for k, v in
                    named.items()})
    return out


def tpp_cfg(dtype, tp):
    from ddlbench_tpu_torch.config import RunConfig

    return RunConfig(benchmark=SHARD_TOKEN[1], arch=SHARD_TOKEN[0],
                     strategy="gpipe", num_devices=TPP_STAGES * tp,
                     num_stages=TPP_STAGES, tp_size=tp,
                     micro_batch_size=TPP_MB, num_microbatches=TPP_M,
                     compute_dtype=dtype, seed=0, optimizer="sgd",
                     fused_head_loss=False, attention_backend="auto")


def tp_bar(rec, dtype, grads, want, own_bf16=None):
    """(a)'s record: the loss and the worst gradient leaf against the
    reference strategy's, ok under dtype's bar (above)."""
    import torch

    rec["worst_grad_rel_l2"], rec["worst_grad_leaf"] = worst_update(
        torch, grads, want)
    if dtype == "float32":
        rec["ok"] = (rec["loss_rel"] <= TP_F32_REL
                     and rec["worst_grad_rel_l2"] <= TP_F32_REL)
        return rec
    rec["reference_bf16_vs_f32_worst_grad_rel_l2"] = own_bf16
    rec["grad_bar"] = max(SHARD_BF16_FLOOR, 2 * own_bf16)
    rec["ok"] = (rec["loss_rel"] <= SHARD_BF16_LOSS
                 and rec["worst_grad_rel_l2"] <= rec["grad_bar"])
    return rec


def tp_token_cell(torch, comm, strategy):
    """tpp's or tp's token cell on this rank, float32 then bfloat16: the
    counters zeroed, the compared step (the forward and backward without
    the update, gradients gathered whole), tp's float32 update, the
    timed bfloat16 steps; on rank 0, (a) against -f gpipe at 2 stages
    (tpp) or single (tp) on the same rows, each alone on the card."""
    from ddlbench_tpu_torch.ops import flash_attention as fa
    from ddlbench_tpu_torch.parallel.api import make_strategy

    out, ref = {}, None
    rows = TPP_MB * TPP_M if strategy == "tpp" else TP_ROWS
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg = (tpp_cfg(dtype, TP) if strategy == "tpp" else
               shard_cfg("tp", comm.world, *SHARD_TOKEN, dtype, rows))
        batches = shard_batches(torch, cfg, rows,
                                1 if dtype == "float32" else 1 + TP_TIMED,
                                comm.device)
        card = comm.device.type == "cuda"
        strat = make_strategy(cfg, comm.device, comm, shared_card=card)
        counters = dp_counters()
        for fn in counters.values():
            fn.launches = 0
        plain0 = fa.flash_attention.plain_launches
        m, grads = strat.reduced_grads(*batches[0])
        loss = m["loss"].item()
        grads = (tp_whole_grads(torch, comm, grads) if strategy == "tpp"
                 else {k: v.detach().clone() for k, v in
                       strat.whole_grads(grads).items()})
        rec = {"loss": loss}
        if strategy == "tp" and dtype == "float32":
            # the update as the momentum buffer (lr x it is the step) and
            # as what reached the parameters the rank holds, its gathered
            # parts and its Megatron slices: every leaf whole before and
            # after
            before = {k: v.clone() for k, v in strat.named_params().items()}
            strat.train_step(*batches[0], SHARD_LR)
            update = {k: v.clone() for k, v in
                      strat.whole_grads(strat.opt["m"]).items()}
            after = {k: v.clone() for k, v in strat.named_params().items()}
        ms = []
        for x, y in batches[1:]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            strat.train_step(x, y, SHARD_LR)["loss"].item()
            ms.append(1e3 * (time.perf_counter() - t1))
        rec["launches"] = {n: fn.launches for n, fn in counters.items()}
        rec["plain_launches"] = fa.flash_attention.plain_launches - plain0
        steps = 1 + len(ms) + (strategy == "tp" and dtype == "float32")
        if strategy == "tpp":
            want = pipe_expected(strat, "fill-drain", steps)
            want.update({n: 0 for n in FX_KERNELS})  # the unfused head
        else:
            want = {**{n: LAYERS * steps for n in FLASH_KERNELS},
                    **{n: steps for n in FX_KERNELS}}
        rec["launches_expected"] = want
        if ms:
            rec["timed_ms_per_step"] = sum(ms) / len(ms)
            rec["global_tokens_per_s"] = (rows * 1024 * 1e3
                                          / rec["timed_ms_per_step"])
        if strategy == "tp":
            rec["param_elements"] = sum(strat.param_counts().values())
        del strat
        torch.cuda.empty_cache()
        rec["run_s"] = time.perf_counter() - t0
        if comm.rank == 0:
            t0 = time.perf_counter()
            if strategy == "tpp":
                base = make_strategy(tpp_cfg(dtype, 1), comm.device,
                                     shared_card=card)
                bm, bgrads = base.reduced_grads(*batches[0])
                b_loss = bm["loss"].item()
            else:
                base = make_strategy(shard_cfg("single", 1, *SHARD_TOKEN,
                                               dtype, rows), comm.device)
                b_loss, bgrads = single_grads(torch, base, batches[0])
            bgrads = {k: v.detach().clone() for k, v in bgrads.items()}
            a = {"loss_reference": b_loss,
                 "loss_rel": abs(loss - b_loss) / abs(b_loss)}
            own = (None if dtype == "float32"
                   else worst_update(torch, bgrads, ref)[0])
            a = tp_bar(a, dtype, grads, bgrads, own)
            if strategy == "tp" and dtype == "float32":
                names = [f"{i}.{n}" for i, layer in
                         enumerate(base.model.layers)
                         for n, _ in layer.named_parameters()]
                b_before = {n: p.detach().clone() for n, p in
                            zip(names, base.model.parameters())}
                base.train_step(*batches[0], SHARD_LR)
                b_after = dict(zip(names, base.model.parameters()))
                a["worst_update_rel_l2"], a["worst_update_leaf"] = \
                    worst_update(torch, update,
                                 dict(zip(names, base.opt["m"])))
                a["worst_param_step_rel_l2"], a["worst_param_step_leaf"] = \
                    worst_update(torch,
                                 {k: after[k] - before[k] for k in names},
                                 {k: b_after[k].detach() - b_before[k]
                                  for k in names})
                a["worst_param_rel_l2"], a["worst_param_leaf"] = \
                    worst_update(torch, after, {k: b_after[k].detach()
                                                for k in names})
                a["ok"] = (a["ok"] and a["worst_update_rel_l2"] <= TP_F32_REL
                           and a["worst_param_step_rel_l2"]
                           <= TP_PARAM_STEP_REL
                           and a["worst_param_rel_l2"] <= TP_F32_REL)
            if dtype == "float32":
                ref = bgrads
            rec["vs_reference"] = a
            rec["reference_s"] = time.perf_counter() - t0
            del base
        out[dtype] = rec
        del grads, batches
        torch.cuda.empty_cache()
    return out


def tp_image_f64(torch, comm):
    """TP_IMAGE under tp in float64 on TP_IMAGE_ROWS rows (every leaf
    gathered on use): the loss, the gradient whole and the running
    statistics against single's on the same rows (rank 0 compares)."""
    import dataclasses

    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.parallel.sharded import TPStrategy

    dev = comm.device
    cfg = shard_cfg("tp", comm.world, *TP_IMAGE, "float32", TP_IMAGE_ROWS)

    def model64():
        return get_model(*TP_IMAGE, seed=0).to(dev, torch.float64).to(
            memory_format=torch.channels_last)

    x, y = shard_batches(torch, cfg, TP_IMAGE_ROWS, 1, dev)[0]
    x = x.to(torch.float64).contiguous(memory_format=torch.channels_last)
    strat = TPStrategy(model64(), cfg, comm)
    strat.compute_dtype = torch.float64  # the model's own type
    strat.init()
    m, grads = strat.reduced_grads(x, y)
    whole = strat.whole_grads(grads)
    names = [f"{i}.{n}" for i, layer in enumerate(model64().layers)
             for n, _ in layer.named_parameters()]
    got = (m["loss"].item(), [whole[n].cpu() for n in names],
           [b.detach().double().cpu() for b in strat.model.buffers()])
    del strat, grads, whole
    torch.cuda.empty_cache()
    if comm.rank:
        return None
    single_cfg = dataclasses.replace(cfg, strategy="single", num_devices=1)
    rec = f64_agreement(got, image_step(torch, model64(), x, y, single_cfg,
                                        None))
    torch.cuda.empty_cache()
    return rec


# ---- 25: hybrid PP x DP (hybrid_train) ------------------------------------
HYB_S, HYB_R = 2, 2  # stages, replicas (-g 4 as --dp-replicas 2 x 2 stages)
HYB_MB, HYB_M = 2, 2  # a replica's micro-batch and microbatches
HYB_ROWS = HYB_MB * HYB_M * HYB_R  # the global batch
HYB_TIMED = 1  # timed bfloat16 steps after a warm-up one
HYB_BUCKETS = 2  # ZeRO-1's --comm-buckets
HYB_RUNS = (("fill_drain", "gpipe", {}),
            ("1f1b", "gpipe", {"pipe_schedule": "1f1b"}),
            ("pipedream", "pipedream",
             {"batch_size": HYB_MB * HYB_M, "micro_batch_size": HYB_MB,
              "num_microbatches": None}),
            ("zero1", "gpipe", {"dp_shard_update": True,
                                "comm_buckets": HYB_BUCKETS}))
# the float32 checks: transformer_s at full width cut to its first
# HYB_CUT blocks on HYB_CUT_T tokens (the CPU steps stay short); (a) the
# card's step against the same step of the same gloo ranks on the CPU
# (the kernels' plain versions there): the loss within SHARD_F32_LOSS,
# every leaf's update within SHARD_CPU_UPDATE relative L2; (b) ZeRO-1's
# step against the replicated hybrid's on the card: every leaf's update
# within HYB_ZERO1_REL (only where the sums' slices fall differs)
HYB_CUT, HYB_CUT_T = 2, 128
HYB_ZERO1_REL = 1e-6
HYB_IMAGE = ("resnet18", "cifar10")  # the float64 BatchNorm row


def hyb_cfg(strategy, dtype, arch=None, bench=None, **kw):
    from ddlbench_tpu_torch.config import RunConfig

    base = dict(benchmark=bench or SHARD_TOKEN[1],
                arch=arch or SHARD_TOKEN[0], strategy=strategy,
                num_devices=HYB_S * HYB_R, dp_replicas=HYB_R,
                num_stages=HYB_S, micro_batch_size=HYB_MB,
                num_microbatches=HYB_M, compute_dtype=dtype, seed=0,
                optimizer="sgd", attention_backend="auto")
    base.update(kw)
    return RunConfig(**base)


def hyb_engine(torch, comm, model, cfg, dtype):
    """A hybrid strategy of ``cfg``'s runtime on ``model`` (moved to this
    rank's stage devices), replica comm.rank, initialised."""
    from ddlbench_tpu_torch.distributed import hybrid_stage_devices
    from ddlbench_tpu_torch.parallel.gpipe import GPipeStrategy
    from ddlbench_tpu_torch.parallel.pipedream import PipeDreamStrategy
    from ddlbench_tpu_torch.parallel.pipeline_rt import (
        ScheduledPipelineStrategy)

    devs = hybrid_stage_devices(str(comm.device.type), HYB_S, HYB_R,
                                comm.rank, comm.device.type == "cuda")
    cls = (PipeDreamStrategy if cfg.strategy == "pipedream" else
           ScheduledPipelineStrategy if cfg.pipe_schedule != "fill-drain"
           else GPipeStrategy)
    s = cls(model.to(devs[0]), cfg, devs, dp_comm=comm)
    s.compute_dtype = getattr(torch, dtype)
    s.init()
    return s


def hyb_cut_model():
    from ddlbench_tpu_torch.models.layers import LayerModel
    from ddlbench_tpu_torch.models.zoo import get_model

    full = get_model(*SHARD_TOKEN, seed=0)
    return LayerModel(full.name, list(full.layers[:1 + HYB_CUT])
                      + [full.layers[-1]], full.in_shape, full.num_classes)


def hyb_update(torch, strat, batch, lr):
    """One train step: (loss, {"<layer>.<name>": update} on the host),
    the parameters read current (ZeRO-1's gathered first)."""
    sync = getattr(strat, "sync_params", lambda: None)
    sync()
    before = {f"{i}.{n}": p.detach().double().cpu().clone()
              for i, layer in enumerate(strat.model.layers)
              for n, p in layer.named_parameters()}
    loss = float(strat.train_step(*batch, lr)["loss"])
    sync()
    return loss, {f"{i}.{n}": p.detach().double().cpu() - before[f"{i}.{n}"]
                  for i, layer in enumerate(strat.model.layers)
                  for n, p in layer.named_parameters()}


def hyb_cut_steps(torch, comm):
    """The float32 cut steps of every runtime on this rank's device:
    {run: (loss, update)}."""
    out = {}
    for key, strategy, kw in HYB_RUNS:
        cfg = hyb_cfg(strategy, "float32", **kw)
        x, y = shard_batches(torch, cfg, HYB_ROWS, 1, comm.device,
                             seed=7)[0]
        strat = hyb_engine(torch, comm, hyb_cut_model(), cfg, "float32")
        out[key] = hyb_update(torch, strat, (x[:, :HYB_CUT_T],
                                             y[:, :HYB_CUT_T]), SHARD_LR)
        del strat
        torch.cuda.empty_cache()
    return out


def hyb_image_f64(torch, comm):
    """resnet18 / cifar10 fill-drain hybrid in float64 on this rank's
    device: (loss, every chunk's replica-averaged gradient as applied,
    the running statistics after the step's averaging)."""
    from ddlbench_tpu_torch.models.zoo import get_model

    cfg = hyb_cfg("gpipe", "float32", *HYB_IMAGE)
    model = get_model(*HYB_IMAGE, seed=0).double()
    if comm.device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    x, y = shard_batches(torch, cfg, HYB_ROWS, 1, comm.device)[0]
    x = x.double()
    if comm.device.type == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    strat = hyb_engine(torch, comm, model, cfg, "float64")
    rec = recording_updates(strat)
    loss = float(strat.train_step(x, y, cfg.resolved_lr())["loss"])
    return (loss, [g for c in sorted(rec) for g in rec[c]],
            [b.detach().double().cpu() for b in strat.model.buffers()])


def hybrid_cell(torch, comm):
    """Phase 25 on this rank (in the world-2 shared-card spawn): the
    bfloat16 main path of every hybrid runtime through make_strategy
    (the counters zeroed before each and read after, timed steps, the
    optimizer bytes), then the float32 cut steps and resnet18's float64
    step on the card and on the CPU over the same gloo group (rank 0
    compares)."""
    import dataclasses

    from ddlbench_tpu_torch.ops import flash_attention as fa
    from ddlbench_tpu_torch.parallel.api import make_strategy

    card = comm.device.type == "cuda"
    out = {"runs": {}}
    for key, strategy, kw in HYB_RUNS:
        t0 = time.perf_counter()
        cfg = hyb_cfg(strategy, "bfloat16", **kw)
        batches = shard_batches(torch, cfg, HYB_ROWS, 1 + HYB_TIMED,
                                comm.device)
        strat = make_strategy(cfg, comm.device, comm, shared_card=card)
        counters = dp_counters()
        for fn in counters.values():
            fn.launches = 0
        plain0 = fa.flash_attention.plain_launches
        losses, ms = [], []
        for i, (x, y) in enumerate(batches):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(strat.train_step(x, y, SHARD_LR)["loss"]))
            if i:
                ms.append(1e3 * (time.perf_counter() - t1))
        rec = {"launches": {n: fn.launches for n, fn in counters.items()},
               "plain_launches": fa.flash_attention.plain_launches - plain0,
               "launches_expected": pipe_expected(
                   strat, "pipedream" if strategy == "pipedream"
                   else strat.cfg.pipe_schedule, len(batches)),
               "losses": losses, "bounds": strat.bounds,
               "ms_per_step": sum(ms) / len(ms),
               "opt_bytes": strat.opt_state_bytes(),
               "row_padded": [m.padded for m in strat._row_meta]
               if strat.pipe_shard else None,
               "chunk_elements": [sum(p.numel() for p in
                                      strat.chunk_params(c))
                                  for c in range(strat.num_chunks)]}
        rec["global_tokens_per_s"] = (HYB_ROWS * 1024 * 1e3
                                      / rec["ms_per_step"])
        rec["run_s"] = time.perf_counter() - t0
        out["runs"][key] = rec
        del strat, batches
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cut_card = hyb_cut_steps(torch, comm)
    img_card = hyb_image_f64(torch, comm)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // comm.world))
    try:
        cpu = dataclasses.replace(comm, device=torch.device("cpu"),
                                  staged=frozenset())
        cut_cpu = hyb_cut_steps(torch, cpu)
        img_cpu = hyb_image_f64(torch, cpu)
    finally:
        torch.set_num_threads(threads)
    out["checks_s"] = time.perf_counter() - t0
    if comm.rank:
        return out
    a = {}
    for key in cut_cpu:
        (lc, uc), (lp, up) = cut_card[key], cut_cpu[key]
        r = {"loss_card": lc, "loss_cpu": lp,
             "loss_rel": abs(lc - lp) / abs(lp)}
        r["worst_update_rel_l2"], r["worst_update_leaf"] = worst_update(
            torch, uc, up)
        r["ok"] = (r["loss_rel"] <= SHARD_F32_LOSS
                   and r["worst_update_rel_l2"] <= SHARD_CPU_UPDATE)
        a[key] = r
    b = {"worst_update_rel_l2": worst_update(
        torch, cut_card["zero1"][1], cut_card["fill_drain"][1])[0],
        "loss_rel": abs(cut_card["zero1"][0] - cut_card["fill_drain"][0])
        / abs(cut_card["fill_drain"][0])}
    b["ok"] = (b["worst_update_rel_l2"] <= HYB_ZERO1_REL
               and b["loss_rel"] <= HYB_ZERO1_REL)
    out.update(a_card_vs_cpu_f32=a, b_zero1_vs_replicated_f32=b,
               image_float64=f64_agreement(img_card, img_cpu))
    return out


def hybrid_line(shared):
    """Phase 25's line from the ranks' hybrid cells: emits hybrid_train
    and returns the B1-B6 launches of every rank's main-path runs."""
    launches = {n: 0 for n in SHARD_COUNTERS}
    checks, per_rank = {}, {}
    for r in shared:
        for key, rec in r["hybrid"]["runs"].items():
            who = f"rank{r['rank']}_{key}"
            checks[f"c_{who}"] = (rec["plain_launches"] == 0 and
                                  rec["launches"] == rec["launches_expected"])
            per_rank[who] = rec["launches"]
            for n in SHARD_COUNTERS:
                launches[n] += rec["launches"][n]
    r0 = shared[0]["hybrid"]
    for key in r0["runs"]:
        checks[f"same_losses_{key}"] = (
            shared[1]["hybrid"]["runs"][key]["losses"]
            == r0["runs"][key]["losses"])
    for key, rec in r0["a_card_vs_cpu_f32"].items():
        checks[f"a_{key}"] = rec["ok"]
    checks["b_zero1_vs_replicated"] = r0["b_zero1_vs_replicated_f32"]["ok"]
    checks["image_float64"] = r0["image_float64"]["ok"]
    rep, z = r0["runs"]["fill_drain"], r0["runs"]["zero1"]
    # each rank holds half of every chunk's padded row of momentum (SGD)
    half = sum(4 * p // HYB_R for p in z["row_padded"])
    checks["zero1_opt_bytes_half"] = (
        z["opt_bytes"] == half
        and 0 <= HYB_R * z["opt_bytes"] - rep["opt_bytes"]
        <= 4 * HYB_R * HYB_BUCKETS * len(z["row_padded"]))
    emit({"phase": "hybrid_train", "model": SHARD_TOKEN,
          "stages": HYB_S, "replicas": HYB_R, "micro_batch": HYB_MB,
          "microbatches": HYB_M, "global_batch": HYB_ROWS,
          "shared_card": True, "card": card_line(), "dtype": "bfloat16",
          "runs": {k: {kk: v for kk, v in rec.items() if kk != "launches"}
                   for k, rec in r0["runs"].items()},
          "launches": per_rank,
          "zero1_opt_bytes": z["opt_bytes"],
          "replicated_opt_bytes": rep["opt_bytes"],
          "a_card_vs_cpu_f32": r0["a_card_vs_cpu_f32"],
          "a_cut": {"blocks": HYB_CUT, "tokens": HYB_CUT_T},
          "b_zero1_vs_replicated_f32": r0["b_zero1_vs_replicated_f32"],
          "image_float64": {"model": HYB_IMAGE, "global_batch": HYB_ROWS,
                            **r0["image_float64"]},
          "checks": checks,
          "seconds": {"checks": r0["checks_s"],
                      "runs": {k: rec["run_s"]
                               for k, rec in r0["runs"].items()}}})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"hybrid checks failed: {failed}")
    return launches


def tp_lines(shared):
    """Phases 23-24 from the world-2 shared-card ranks' tpp and tp cells:
    emits tpp_train and tp_train and returns their B1-B6 launches."""
    launches = {n: 0 for n in SHARD_COUNTERS}
    failed = []
    for strategy, phase in (("tpp", "tpp_train"), ("tp", "tp_train")):
        checks, per_rank = {}, {}
        for r in shared:
            for dtype, rec in r[strategy].items():
                who = f"rank{r['rank']}_{dtype}"
                checks[f"c_{who}"] = (rec["plain_launches"] == 0 and
                                      rec["launches"]
                                      == rec["launches_expected"])
                per_rank[who] = rec["launches"]
                for n in SHARD_COUNTERS:
                    launches[n] += rec["launches"][n]
                if "vs_reference" in rec:
                    checks[f"a_{who}"] = rec["vs_reference"]["ok"]
        r0 = shared[0][strategy]
        checks["same_losses_on_both_ranks"] = all(
            shared[1][strategy][d]["loss"] == r0[d]["loss"] for d in r0)
        line = {"phase": phase, "model": SHARD_TOKEN, "world": TP,
                "shared_card": True, "card": card_line(),
                "reference": ("-f gpipe, 2 stages" if strategy == "tpp"
                              else "-f single"),
                "cells": {d: {k: v for k, v in rec.items()
                              if k not in ("launches",)}
                          for d, rec in r0.items()},
                "launches": per_rank,
                "seconds": shared[0][f"{strategy}_s"]}
        if strategy == "tpp":
            line.update(stages=TPP_STAGES, micro_batch=TPP_MB,
                        microbatches=TPP_M)
        else:
            line["global_batch"] = TP_ROWS
            line["image_float64"] = {
                "model": TP_IMAGE, "global_batch": TP_IMAGE_ROWS,
                "seconds": shared[0]["tp_image_s"],
                **shared[0]["tp_image"]}
            checks["a_image_float64"] = shared[0]["tp_image"]["ok"]
        line["checks"] = checks
        emit(line)
        failed += [f"{strategy}:{k}" for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"tensor-parallel checks failed: {failed}")
    return launches


# ---- 26-28: 3-D tpp, remat_layers under fsdp and tp, MoE under dp/fsdp --
#
# tpp3d_train: -g 8 as --dp-replicas 2 x 2 stages x --tp-size 2 (the
# reference's ('data', 'stage', 'model') mesh), a rank a shard of a
# replica, all four in the sharded phases' spawn (distributed.spawn at
# world 4 on the shared card: its world-2 cells run on the subgroup of
# ranks 0-1), micro-batch 2 x 2 microbatches a replica (8 rows of 1 024)
T3_R = 2
T3_WORLD = T3_R * TP
T3_ROWS = TPP_MB * TPP_M * T3_R
T3_TIMED = 1  # timed bfloat16 steps after the compared one
# remat: each strategy's float32 step on SHARD_ROWS rows with
# remat_layers on against off (the same weights and rows): the loss within
# SHARD_F32_LOSS and every leaf's update within TP_F32_REL (the recompute
# runs the forward's own kernels again, so bitwise equality is expected
# and reported); resnet50's float64 step (single, and fsdp's image row)
# with remat against without: every gradient leaf within REMAT_F64_REL
# (relative L2, the IMAGE_FLOOR of its kind) and the running statistics
# bitwise (updated by the first forward only)
REMAT_F64_REL = 1e-12
# moe_dp, moe_fsdp: transformer_moe_s at full width (8 experts) at the
# reference's capacity factor 1.25 (tokens drop) and aux weight 0.01,
# float32, SHARD_ROWS rows: one compared step (routed by each rank's own
# router over the global batch) and one update against single on the same
# rows pinned to the ranks' routing (gathered), so the two compute one
# function: the loss within SHARD_F32_LOSS, every gradient leaf within
# SHARD_F32_GRAD, every leaf's update within TP_PARAM_STEP_REL (the new
# weights' rounding, as tp's), the dropped tokens of the ranks summed
# equal to single's, and more than none
MOE_CF, MOE_AUX = 1.25, 0.01


def tpp3d_cfg(dtype, replicas=T3_R, mb=TPP_MB):
    """3-D tpp's config (2-D at ``replicas`` 1: the same global batch at
    micro-batch ``mb`` = TPP_MB x T3_R)."""
    from ddlbench_tpu_torch.config import RunConfig

    return RunConfig(benchmark=SHARD_TOKEN[1], arch=SHARD_TOKEN[0],
                     strategy="gpipe",
                     num_devices=TPP_STAGES * TP * replicas,
                     num_stages=TPP_STAGES, tp_size=TP,
                     dp_replicas=replicas, micro_batch_size=mb,
                     num_microbatches=TPP_M, compute_dtype=dtype, seed=0,
                     optimizer="sgd", fused_head_loss=False,
                     attention_backend="auto")


def tpp_step_grads(torch, strat, batch):
    """A tpp step's forward and backward (3-D or 2-D) without the update:
    (the loss, every leaf's gradient whole: summed over the replicas and
    divided by R as the step applies it, the shards' slices gathered)."""
    from ddlbench_tpu_torch.parallel.gpipe import mean_over

    m, grads = strat.reduced_grads(*batch)
    if strat.dp > 1:
        for c in range(strat.num_chunks):
            mean_over(strat.dp_comm, [p.grad for p in strat.chunk_params(c)
                                      if p.grad is not None])
    return m["loss"].item(), tp_whole_grads(torch, strat.tp_comm, grads)


def tpp3d_cut_step(torch, comm):
    """The float32 3-D step on transformer_s cut to HYB_CUT blocks and
    HYB_CUT_T tokens on this rank's device (the CPU's through the same
    gloo groups): (loss, this rank's update)."""
    from ddlbench_tpu_torch.distributed import (tpp3d_comms,
                                                tpp3d_stage_devices)
    from ddlbench_tpu_torch.parallel.tpp import TPGPipeStrategy

    cfg = tpp3d_cfg("float32")
    tp_comm, dp_comm = tpp3d_comms(comm, T3_R, TP)
    devs = tpp3d_stage_devices(comm.device.type, TPP_STAGES, TP, T3_R,
                               comm.rank, comm.device.type == "cuda")
    strat = TPGPipeStrategy(hyb_cut_model().to(devs[0]), cfg, devs,
                            tp_comm, dp_comm=dp_comm)
    strat.init()
    x, y = shard_batches(torch, cfg, T3_ROWS, 1, comm.device, seed=7)[0]
    return hyb_update(torch, strat, (x[:, :HYB_CUT_T], y[:, :HYB_CUT_T]),
                      SHARD_LR)


def tpp3d_cell(torch, comm, comm2):
    """Phase 26 on this rank of the world-4 spawn (``comm2``: the world-2
    subgroup of ranks 0-1, None on ranks 2-3): float32 then bfloat16
    through make_strategy (the counters zeroed before and read after the
    compared step and the timed steps), the compared step's gradient
    whole against 2-D tpp's on the same global batch (ranks 0-1, rank 0
    compares), then the float32 cut step on the card and on the CPU over
    the same gloo groups (each rank compares its own)."""
    import dataclasses

    from ddlbench_tpu_torch.ops import flash_attention as fa
    from ddlbench_tpu_torch.parallel.api import make_strategy

    card = comm.device.type == "cuda"
    out, ref2d = {}, None
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg = tpp3d_cfg(dtype)
        batches = shard_batches(torch, cfg, T3_ROWS,
                                1 if dtype == "float32" else 1 + T3_TIMED,
                                comm.device)
        strat = make_strategy(cfg, comm.device, comm, shared_card=card)
        counters = dp_counters()
        for fn in counters.values():
            fn.launches = 0
        plain0 = fa.flash_attention.plain_launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = tpp_step_grads(torch, strat, batches[0])
        ms = []
        for x, y in batches[1:]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            strat.train_step(x, y, SHARD_LR)["loss"].item()
            ms.append(1e3 * (time.perf_counter() - t1))
        want = pipe_expected(strat, "fill-drain", 1 + len(ms))
        want.update({n: 0 for n in FX_KERNELS})  # the unfused head
        rec = {"loss": loss, "tp_rank": strat.tp_comm.rank,
               "dp_rank": strat.dp_comm.rank,
               "launches": {n: fn.launches for n, fn in counters.items()},
               "plain_launches": fa.flash_attention.plain_launches - plain0,
               "launches_expected": want,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        if ms:
            rec["timed_ms_per_step"] = sum(ms) / len(ms)
            rec["global_tokens_per_s"] = (T3_ROWS * 1024 * 1e3
                                          / rec["timed_ms_per_step"])
        del strat
        torch.cuda.empty_cache()
        if comm2 is not None:
            base = make_strategy(tpp3d_cfg(dtype, 1, TPP_MB * T3_R),
                                 comm2.device, comm2, shared_card=card)
            b_loss, bgrads = tpp_step_grads(torch, base, batches[0])
            del base
            torch.cuda.empty_cache()
            if comm2.rank == 0:
                a = {"loss_2d": b_loss,
                     "loss_rel": abs(loss - b_loss) / abs(b_loss)}
                own = (None if dtype == "float32"
                       else worst_update(torch, bgrads, ref2d)[0])
                rec["vs_2d"] = tp_bar(a, dtype, grads, bgrads, own)
                if dtype == "float32":
                    ref2d = bgrads
        rec["run_s"] = time.perf_counter() - t0
        out[dtype] = rec
        del grads, batches
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    card_step = tpp3d_cut_step(torch, comm)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // comm.world))
    try:
        cpu_step = tpp3d_cut_step(torch, dataclasses.replace(
            comm, device=torch.device("cpu"), staged=frozenset()))
    finally:
        torch.set_num_threads(threads)
    a = {"loss_card": card_step[0], "loss_cpu": cpu_step[0],
         "loss_rel": abs(card_step[0] - cpu_step[0]) / abs(cpu_step[0])}
    a["worst_update_rel_l2"], a["worst_update_leaf"] = worst_update(
        torch, card_step[1], cpu_step[1])
    a["ok"] = (a["loss_rel"] <= SHARD_F32_LOSS
               and a["worst_update_rel_l2"] <= SHARD_F32_GRAD)
    out["a_card_vs_cpu_f32"] = a
    out["checks_s"] = time.perf_counter() - t0
    return out


def tpp3d_line(shared4):
    """Phase 26's line from every rank's tpp3d cell: emits tpp3d_train and
    returns the B1-B6 launches of every rank's main-path steps."""
    launches = {n: 0 for n in SHARD_COUNTERS}
    checks, per_rank = {}, {}
    for r in shared4:
        cell = r["tpp3d"]
        for dtype in ("float32", "bfloat16"):
            rec = cell[dtype]
            who = f"rank{r['rank']}_{dtype}"
            checks[f"c_{who}"] = (rec["plain_launches"] == 0 and
                                  rec["launches"] == rec["launches_expected"])
            per_rank[who] = rec["launches"]
            for n in SHARD_COUNTERS:
                launches[n] += rec["launches"][n]
            if "vs_2d" in rec:
                checks[f"a_vs_2d_{dtype}"] = rec["vs_2d"]["ok"]
        checks[f"b_card_vs_cpu_rank{r['rank']}"] = cell[
            "a_card_vs_cpu_f32"]["ok"]
    r0 = shared4[0]["tpp3d"]
    checks["same_losses_on_every_rank"] = all(
        r["tpp3d"][d]["loss"] == r0[d]["loss"] for r in shared4
        for d in ("float32", "bfloat16"))
    emit({"phase": "tpp3d_train", "model": SHARD_TOKEN,
          "mesh": {"data": T3_R, "stage": TPP_STAGES, "model": TP},
          "micro_batch": TPP_MB, "microbatches": TPP_M,
          "global_batch": T3_ROWS, "shared_card": True, "card": card_line(),
          "reference": "2-D tpp (-f gpipe --tp-size 2, micro-batch "
                       f"{TPP_MB * T3_R}) on the same rows",
          "cells": {d: {k: v for k, v in r0[d].items() if k != "launches"}
                    for d in ("float32", "bfloat16")},
          "launches": per_rank,
          "b_card_vs_cpu_f32": {f"rank{r['rank']}": r["tpp3d"][
              "a_card_vs_cpu_f32"] for r in shared4},
          "b_cut": {"blocks": HYB_CUT, "tokens": HYB_CUT_T},
          "checks": checks,
          "seconds": {"cells": {d: r0[d]["run_s"]
                                for d in ("float32", "bfloat16")},
                      "checks": r0["checks_s"]}})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"3-D tpp checks failed: {failed}")
    return launches


def remat_expected(remat):
    """B1-B6 launches of one float32 step of fsdp or tp: B1-B3 once per
    attention layer, B1 again per layer under remat (its recompute; the
    fused head is not recomputed), B4-B6 once."""
    return {"flash_fwd": LAYERS * (2 if remat else 1), "flash_dq": LAYERS,
            "flash_dkv": LAYERS, **{n: 1 for n in FX_KERNELS}}


def remat_cell(torch, comm, strategy):
    """Phase 27's token rows on this rank of the world-2 subgroup: one
    float32 step of ``strategy`` (fsdp or tp) on SHARD_ROWS rows with
    remat_layers off, then on, from the same weights: the loss, every
    leaf's update whole, the launches, fsdp's re-gathers and the peak
    device memory of the step; rank 0 compares on against off."""
    from ddlbench_tpu_torch.ops import flash_attention as fa
    from ddlbench_tpu_torch.parallel.api import make_strategy

    runs = {}
    batch = shard_batches(torch, shard_cfg(strategy, comm.world,
                                           *SHARD_TOKEN, "float32",
                                           SHARD_ROWS),
                          SHARD_ROWS, 1, comm.device)[0]
    for remat in (False, True):
        cfg = shard_cfg(strategy, comm.world, *SHARD_TOKEN, "float32",
                        SHARD_ROWS, remat_layers=remat)
        strat = make_strategy(cfg, comm.device, comm)
        before = named_of(strat)
        counters = dp_counters()
        for fn in counters.values():
            fn.launches = 0
        plain0 = fa.flash_attention.plain_launches
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = strat.train_step(*batch, SHARD_LR)["loss"].item()
        peak = torch.cuda.max_memory_allocated()
        rec = {"loss": loss,
               "launches": {n: fn.launches for n, fn in counters.items()},
               "plain_launches": fa.flash_attention.plain_launches - plain0,
               "launches_expected": remat_expected(remat),
               "peak_bytes": peak, "peak_over_start_bytes": peak - start,
               "regathers": getattr(strat, "regathers", None)}
        after = named_of(strat)
        runs[remat] = (rec, {k: after[k] - before[k] for k in before})
        del strat, before, after
        torch.cuda.empty_cache()
    out = {"off": runs[False][0], "on": runs[True][0]}
    if comm.rank == 0:
        (off, u_off), (on, u_on) = runs[False], runs[True]
        a = {"loss_rel": abs(on["loss"] - off["loss"]) / abs(off["loss"]),
             "bitwise": on["loss"] == off["loss"] and all(
                 torch.equal(u_on[k], u_off[k]) for k in u_off)}
        a["worst_update_rel_l2"], a["worst_update_leaf"] = worst_update(
            torch, u_on, u_off)
        a["ok"] = (a["loss_rel"] <= SHARD_F32_LOSS
                   and a["worst_update_rel_l2"] <= TP_F32_REL)
        out["on_vs_off"] = a
    return out


def remat_image_f64(torch, comm, strat_cls, cfg, x, y, model64, off):
    """resnet50's float64 step under ``strat_cls`` (fsdp) with remat on,
    from the same weights and rows as ``off`` (its step without remat:
    loss, gradient leaves, running statistics): (the record on rank 0,
    the peak bytes of each step)."""
    import dataclasses

    strat = strat_cls(model64(), dataclasses.replace(cfg, remat_layers=True),
                      comm)
    strat.compute_dtype = torch.float64
    strat.init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = grads_of(torch, strat, (x, y))
    peak = torch.cuda.max_memory_allocated()
    names = [f"{i}.{n}" for i, layer in enumerate(strat.model.layers)
             for n, _ in layer.named_parameters()]
    on = (loss, [grads[n].cpu() for n in names],
          [b.detach().double().cpu() for b in strat.model.buffers()])
    del strat, grads
    torch.cuda.empty_cache()
    return remat_f64_record(on, off, peak)


def remat_f64_record(on, off, peak_on):
    rec = {"loss_rel": abs(on[0] - off[0]) / abs(off[0]),
           "worst_grad_rel_l2": worst_leaf(on[1], off[1]),
           "stats_bitwise": all(a.equal(b) for a, b in zip(on[2], off[2])),
           "peak_bytes_remat": peak_on}
    rec["ok"] = (rec["loss_rel"] <= REMAT_F64_REL
                 and rec["worst_grad_rel_l2"] <= REMAT_F64_REL
                 and rec["stats_bitwise"])
    return rec


def remat_line(shared):
    """Phase 27's line from the world-2 ranks' remat cells and fsdp's
    image row: emits remat_train and returns the B1-B6 launches."""
    launches = {n: 0 for n in SHARD_COUNTERS}
    checks, per_rank = {}, {}
    for r in shared:
        for strategy in ("fsdp", "tp"):
            for key in ("off", "on"):
                rec = r["remat"][strategy][key]
                who = f"rank{r['rank']}_{strategy}_{key}"
                checks[f"c_{who}"] = (rec["plain_launches"] == 0 and
                                      rec["launches"]
                                      == rec["launches_expected"])
                per_rank[who] = rec["launches"]
                for n in SHARD_COUNTERS:
                    launches[n] += rec["launches"][n]
            fsdp = r["remat"]["fsdp"]
            checks[f"regathers_rank{r['rank']}"] = (
                fsdp["on"]["regathers"] == fsdp["off"]["regathers"]
                == LAYERS + 1)
    r0 = shared[0]
    for strategy in ("fsdp", "tp"):
        checks[f"a_{strategy}_on_vs_off"] = r0["remat"][strategy][
            "on_vs_off"]["ok"]
    img = r0["fsdp_image"]
    checks["image_fsdp_remat"] = img["remat"]["ok"]
    checks["image_single_remat"] = img["single_remat"]["ok"]
    emit({"phase": "remat_train", "model": SHARD_TOKEN, "world": 2,
          "global_batch": SHARD_ROWS, "dtype": "float32",
          "shared_card": True, "card": card_line(),
          "rows": {s: {k: {kk: v for kk, v in rec.items()
                           if kk != "launches"} if isinstance(rec, dict)
                       else rec for k, rec in r0["remat"][s].items()}
                   for s in ("fsdp", "tp")},
          "launches": per_rank,
          "image_float64": {"model": SHARD_IMAGE,
                            "global_batch": SHARD_IMAGE_ROWS,
                            "fsdp_remat_vs_fsdp": img["remat"],
                            "single_remat_vs_single": img["single_remat"],
                            "peak_bytes_fsdp": img["peak_bytes"],
                            "peak_bytes_single": img["peak_bytes_single"]},
          "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"remat checks failed: {failed}")
    return launches


def moe_cfg(strategy, world):
    return shard_cfg(strategy, world, *SHARD_MOE, "float32", SHARD_ROWS,
                     moe_capacity_factor=MOE_CF, moe_aux_weight=MOE_AUX)


def moe_named_grads(torch, strat, batch):
    """dp's (replicated engine) or fsdp's step without the update on the
    global batch: (loss, every leaf's reduced gradient whole)."""
    from ddlbench_tpu_torch.parallel.common import unpack_flat

    if hasattr(strat, "shards"):
        return grads_of(torch, strat, batch)
    m, gred = strat.reduced_grads(*batch)
    by_id = {id(p): g for p, g in zip(strat.params,
                                      unpack_flat(gred, strat.meta))}
    return m["loss"].item(), {
        f"{i}.{n}": by_id[id(p)].reshape(p.shape).detach().clone()
        for i, layer in enumerate(strat.model.layers)
        for n, p in layer.named_parameters()}


def moe_drops(model):
    """Each MoE block's dropped tokens in its last forward."""
    from ddlbench_tpu_torch.models.moe import moe_blocks

    return [int((~b.last_route.keep).sum()) for b in moe_blocks(model)]


def moe_global_cell(torch, comm, strategy):
    """Phase 28 on this rank (dp: the dp phase's world-2 spawn; fsdp: the
    sharded spawn's world-2 subgroup): the compared step (routes by the
    ranks' own routers over the global batch) and one update on the same
    rows, the counters zeroed before and read after; rank 0 holds both
    against single on the rows pinned to the ranks' routing."""
    from ddlbench_tpu_torch.ops import flash_attention as fa
    from ddlbench_tpu_torch.parallel.api import make_strategy

    t0 = time.perf_counter()
    cfg = moe_cfg(strategy, comm.world)
    batch = shard_batches(torch, cfg, SHARD_ROWS, 1, comm.device)[0]
    strat = make_strategy(cfg, comm.device, comm)
    counters = dp_counters()
    for fn in counters.values():
        fn.launches = 0
    plain0 = fa.flash_attention.plain_launches
    loss, grads = moe_named_grads(torch, strat, batch)
    experts = routing_of(torch, strat)[0]
    drops = moe_drops(strat.model)
    step_ms = []
    u_loss, update = update_of(torch, strat, batch, SHARD_LR, step_ms)
    rec = {"loss": loss, "drops": drops, "ms_per_step": step_ms[0],
           "launches": {n: fn.launches for n, fn in counters.items()},
           "plain_launches": fa.flash_attention.plain_launches - plain0,
           "launches_expected": {**{n: 2 * LAYERS for n in FLASH_KERNELS},
                                 **{n: 2 for n in FX_KERNELS}}}
    whole = [comm.all_gather(e) for e in experts]
    total_drops = comm.all_reduce(torch.tensor(
        drops, dtype=torch.int64, device=comm.device)).tolist()
    del strat
    torch.cuda.empty_cache()
    if comm.rank == 0:
        single = make_strategy(moe_cfg("single", 1), comm.device)
        with pinned_experts(torch, whole):
            s_loss, s_grads = single_grads(torch, single, batch)
        s_drops = moe_drops(single.model)
        flips = routing_of(torch, single)[1]
        with pinned_experts(torch, whole):
            _, s_update = update_of(torch, single, batch, SHARD_LR,
                                    step_ms)
        a = {"loss_single": s_loss,
             "loss_rel": abs(loss - s_loss) / abs(s_loss),
             "drops_ranks": total_drops, "drops_single": s_drops,
             "capacity": math.ceil(MOE_CF * SHARD_ROWS
                                   * cfg.dataset().image_size[0] / 8),
             "single_own_router_flips": flips,
             "single_ms_per_step": step_ms[1]}
        a["worst_grad_rel_l2"], a["worst_grad_leaf"] = worst_update(
            torch, grads, s_grads)
        a["worst_update_rel_l2"], a["worst_update_leaf"] = worst_update(
            torch, update, s_update)
        a["ok"] = (a["loss_rel"] <= SHARD_F32_LOSS
                   and a["worst_grad_rel_l2"] <= SHARD_F32_GRAD
                   and a["worst_update_rel_l2"] <= TP_PARAM_STEP_REL
                   and total_drops == s_drops and sum(s_drops) > 0)
        rec["vs_single"] = a
        del single
        torch.cuda.empty_cache()
    rec["run_s"] = time.perf_counter() - t0
    return rec


def moe_line(ranks, strategy):
    """Phase 28's line (moe_dp or moe_fsdp) from the world-2 ranks' MoE
    cells: emits it and returns the B1-B6 launches."""
    launches = {n: 0 for n in SHARD_COUNTERS}
    checks, per_rank = {}, {}
    for i, rec in enumerate(ranks):
        checks[f"c_rank{i}"] = (rec["plain_launches"] == 0 and
                                rec["launches"] == rec["launches_expected"])
        per_rank[f"rank{i}"] = rec["launches"]
        for n in SHARD_COUNTERS:
            launches[n] += rec["launches"][n]
    r0 = ranks[0]
    checks["a_vs_single"] = r0["vs_single"]["ok"]
    checks["same_losses_on_both_ranks"] = all(
        r["loss"] == r0["loss"] for r in ranks)
    emit({"phase": f"moe_{strategy}", "model": SHARD_MOE, "world": 2,
          "global_batch": SHARD_ROWS, "dtype": "float32",
          "capacity_factor": MOE_CF, "aux_weight": MOE_AUX,
          "shared_card": True, "card": card_line(),
          "cell": {k: v for k, v in r0.items() if k != "launches"},
          "launches": per_rank, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"moe_{strategy} checks failed: {failed}")
    return launches


def phase_serve_tp(torch, pd, dev):
    """Phase 22: servebench's serve command on transformer_s at tp 1 and
    tp 2 (one replica of two Megatron shards on the one card), over a
    float32 and an int8 pool, the counters zeroed before each run: every
    request completed; at tp 2 no paged call on the plain path and both
    kernels of the pool's type launched (twice tp 1's launches: each
    shard attends its 4 heads), none of the other type; the float32
    streams bitwise tp 1's, two of them held by the teacher-forced check;
    the int8 pool a quarter of the float32 pool's bytes at tp 2 as at
    tp 1; the int8 streams at tp 2 against the float32 ones, each first
    flip within the int8 noise, that noise within INT8_TP_NOISE_RATIO of
    tp 1's. Tokens/s of tp 2 beside tp 1 (host-walked shards on one card:
    not a scaling figure). Returns the tp 2 runs' launches."""
    from ddlbench_tpu_torch.models.zoo import get_model
    from ddlbench_tpu_torch.tools import servebench

    t0 = time.perf_counter()
    model = get_model("transformer_s", "synthtext", seed=0).to(dev)
    kernels = (pd.paged_attention, pd.paged_chunk_attention)
    runs, checks = {}, {}
    launches = {n: 0 for n in KERNELS}
    for kv in ("float32", "int8"):
        for tp in (1, TP):
            for fn in kernels:
                fn.launches = fn.launches_int8 = fn.plain_launches = 0
            argv = SERVE_TP_ARGS + ["--kv-dtype", kv, "--serve-tp", str(tp)]
            args = servebench.build_parser().parse_args(argv)
            (rec, server, reqs), = servebench.run(args, model, dev)
            got = {"paged_attention": pd.paged_attention.launches,
                   "paged_chunk_attention": pd.paged_chunk_attention.launches,
                   "paged_attention_int8": pd.paged_attention.launches_int8,
                   "paged_chunk_attention_int8":
                       pd.paged_chunk_attention.launches_int8}
            runs[(kv, tp)] = {
                "rec": rec, "launches": got,
                "streams": {f["rid"]: f["tokens"] for f in server.finished},
                "server": server if tp == TP and kv == "float32" else None,
                "reqs": reqs}
            if tp == TP:
                for n in KERNELS:
                    launches[n] += got[n]
    for kv in ("float32", "int8"):
        one, two = runs[(kv, 1)], runs[(kv, TP)]
        mine, other = (("_int8", "") if kv == "int8" else ("", "_int8"))
        checks[f"{kv}_completed"] = all(
            r["rec"]["completed"] == 16 for r in (one, two))
        checks[f"{kv}_launches"] = (
            two["rec"]["plain_launches"] == 0
            and two["launches"][f"paged_attention{mine}"] > 0
            and two["launches"][f"paged_chunk_attention{mine}"] > 0
            and two["launches"][f"paged_attention{other}"] == 0
            and two["launches"][f"paged_chunk_attention{other}"] == 0)
        checks[f"{kv}_serve_tp_in_row"] = two["rec"].get("serve_tp") == TP
        checks[f"{kv}_pool_bytes_as_tp1"] = (two["rec"]["pool_bytes"]
                                             == one["rec"]["pool_bytes"])
    f32 = runs[("float32", TP)]
    checks["float32_launches_twice_tp1"] = all(
        f32["launches"][n] == 2 * runs[("float32", 1)]["launches"][n]
        for n in ("paged_attention", "paged_chunk_attention"))
    checks["float32_streams_bitwise_tp1"] = (
        f32["streams"] == runs[("float32", 1)]["streams"])
    checks["int8_pool_quarter"] = (
        4 * runs[("int8", TP)]["rec"]["pool_bytes"]
        == f32["rec"]["pool_bytes"])
    gap = teacher_forced_check(torch, model, f32["server"], f32["reqs"], dev)
    # int8 at tp 2 (INT8_TP_NOISE_RATIO's note): its streams against the
    # float32 ones of the same width, as serve_levers holds int8
    i8, want = runs[("int8", TP)]["streams"], f32["streams"]
    total = sum(len(t) for t in want.values())
    agree = sum(x == y for r, t in want.items() for x, y in zip(t, i8[r]))
    flips = divergences(torch, model, dev, f32["reqs"], want, i8, tp=TP)
    checks["int8_first_flips_within_noise"] = all(
        f["within_noise"] for f in flips.values())
    seqs = {r: f32["reqs"][r].prompt.tolist() + t for r, t in want.items()}
    noise = {tp: int8_noise(torch, model, dev, seqs, tp) for tp in (1, TP)}
    ratio = {r: noise[TP][r] / noise[1][r] for r in seqs}
    checks["int8_noise_as_tp1"] = max(ratio.values()) <= INT8_TP_NOISE_RATIO
    int8_same = sum(i8[r] == runs[("int8", 1)]["streams"][r] for r in i8)
    emit({"phase": "serve_tp", "argv": SERVE_TP_ARGS, "tp": TP,
          "card": card_line(), "checks": checks,
          "teacher_forced_max_gap": gap,
          "int8_tp2": {"digits_vs_float32": agree / total,
                       "digits_agree": agree, "digits_total": total,
                       "digits_gate": DIGITS_GATE_INT8,
                       "digits_gate_met": agree / total >= DIGITS_GATE_INT8,
                       "first_flips": flips,
                       "logit_noise_tp1": noise[1],
                       "logit_noise_tp2": noise[TP],
                       "noise_ratio_max": max(ratio.values()),
                       "noise_ratio_bar": INT8_TP_NOISE_RATIO,
                       "streams_equal_tp1": int8_same},
          "rows": {f"{kv}_tp{tp}": {k: r["rec"].get(k) for k in (
              "completed", "pool_bytes", "wall_tokens_per_s",
              "decode_step_ms", "prefill_chunk_ms", "serve_tp")}
              for (kv, tp), r in runs.items()},
          "launches": {f"{kv}_tp{tp}": r["launches"]
                       for (kv, tp), r in runs.items()},
          "seconds": time.perf_counter() - t0})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"serve_tp checks failed: {failed}")
    return launches

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
    inline = image_bench(torch, HEADLINE_ARGS + ["--prefetch-depth", "0"])
    emit({"phase": "image_bench_prefetch", "note": "tools/bench's headline "
          "record at prefetch depth 2 (phase 12's) and at 0",
          "depth_2": {k: headline[k] for k in keys},
          "depth_0": {k: inline[k] for k in keys}})
    emit({"phase": "real_data_seconds", **real})
    phase_image_zoo(torch, dev)
    for name, n in phase_dp(torch).items():
        train_launches[name] += n
    for name, n in phase_pipe_train(torch, fa, fx, dev).items():
        train_launches[name] += n
    plan_launches, plan_rewrite = phase_plan_train(torch, fa, fx, dev)
    for name, n in plan_launches.items():
        train_launches[name] += n
    phase_pipe_image(torch, dev)
    for name, n in phase_serve_tp(torch, pd, dev).items():
        launches[name] += n
    for name, n in phase_sharded(torch, plan_rewrite).items():
        train_launches[name] += n
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
