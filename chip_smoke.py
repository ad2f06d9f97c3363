#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --out DIR        # also write the results as JSON

Phases, in order; a failing phase makes the run exit non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. each kernel against its plain PyTorch version on the card, in float32,
   at the smollm-135m shapes with tiles that are not powers of two (K1 in
   each of its variants: ``splitk`` at the five decode shapes with w in both
   layouts, ``tc`` at the four forward shapes and the transposed unembed in
   one and two stages, ``fma`` at one odd tile, every epilogue, with the
   float64 product as a witness; K2 in each of the same variants: ``tc`` at
   the two attention contractions (b3 m768) in one and two stages and at
   hymba-1.5b's (b5 m1280), ``splitk`` at the decode contraction (b12 m3)
   in one split and many, ``fma`` at a ragged tile, and at olmoe-1b-7b's
   expert products (``tc`` at b64 m64 k2048 n1024, ``splitk`` at b64 m4 in
   one split and in 128), each run twice for the same bits; K4, the row
   softmax, also in bfloat16, on its registers variant at row blocks
   36-288 and its shared-memory variant at N = 258, where a block too
   large for shared memory must be rejected; K3 on its tc variant (causal,
   window, softcap, full, at S 256 and 96) and its fma variant, at
   olmoe's (1, 16, 256, 128) on fma, at whisper-medium's encoder shape
   (1, 16, 1500, 64) not causal, where every tile is fma, at qwen2-vl-2b's
   (1, 12, 256, 128) kvh 2 causal, at stablelm-3b's (1, 32, 256, 80)
   kvh 32 causal, fma at D 80, and at qwen1.5-110b's (1, 64, 256, 128)
   kvh 8 causal, fma at D 128, G 8, each run twice for the same bits, with
   the bound);
3b. the decode kernels (K5, and K6 against K5 on the gathered view)
   against their plain versions on the card, in float32, at the serving
   shapes, with ragged lengths, sentinels, a softcap and a window, at kv
   tiles whose split of the kv axis leaves whole splits masked (a length-1
   slot, the window), and K5 at olmoe's decode tick (b4, 16 kv heads of
   one query head, D 128), over whisper-medium's 1500-frame cross-attention
   cache (b4, kvh 16, G 1, D 64), at qwen2-vl-2b's tick (b4, kvh 2, G
   6, D 128), at stablelm-3b's (b4, kvh 32, G 1, D 80) and at
   qwen1.5-110b's (b4, kvh 8, G 8, D 128: tiles 16 to 128, at 64 and 128
   a split part of one tile; tile 256 refused for shared memory before any
   launch), each run twice
   for the same bits, the last tile of each timed beside SDPA and the
   bound; each replayed twice from one
   CUDA graph for the
   eager call's bits; K5's device time at every kv tile that divides 256,
   beside ``scaled_dot_product_attention`` on the same inputs;
3c. K7, the chunked SSD scan, against its plain version on the card, in
   float32 and with bfloat16 x/B/C, with and without the final state, at
   mamba2-370m's and hymba-1.5b's forward shapes, at chunks of 17, 37 and
   48 tokens (one chunk that fills no mma tile) and with a decay whose exp
   overflows above the diagonal; replayed twice from one CUDA graph; a
   chunk that does not divide S and one too large for shared memory must
   be rejected; its chunk kernel must run at least 128 CTAs at mamba2's
   forward shape, where each of its two kernels is also traced;
3d. K3 at smollm-135m's forward shape (causal) at every tile that its tc
   variant takes, each against its plain version, with its device time
   beside ``scaled_dot_product_attention``'s and the bound;
3e. K3 and K5 at gemma2-2b's shapes, head_dim 256 with the attention
   softcap 50: K3 at (1, 8, 4608, 256) kvh 4 causal, with the 4096-token
   window and global, on its fma variant; K5 at gemma2's tick (b4, kvh 4,
   G 2, t 256) and over a 4608-position cache with the window and ragged
   lengths; each run twice for the same bits (K5 also replayed twice from
   one CUDA graph) against its plain version; the tiles whose CTA exceeds
   shared memory there (K3 (64, 64), K5 block_kv 128) refused with
   ``ScheduleRejected`` before any launch; each kernel's device time by
   graph replay beside its plain version, its bound and the library's
   (SDPA takes no softcap: the compiled ``flex_attention``, which a
   process of its own compiles beside phases 7 and 8 and, once phases 8 and 22
   are over, holds against the plain version and times on the same
   inputs; SDPA's time without the softcap is printed beside it, as such);
3f. the kernels at arctic-480b's shapes, each against its plain version on
   the same inputs and timed by CUDA-graph replay beside its library call
   and its bound: K1 tc at the forward's m256 products (k7168 n7168, the
   dense residual MLP's k7168 n4864 and k4864 n7168, k7168 n1024) and
   splitk at the tick's m4 k7168 n7168 and the unembed over the
   32000-wide table; K2 splitk at the tick's b128 m4 expert products
   beside ``torch.bmm``; K3 at (1, 56, 256, 128) kvh 8 causal, G 7, at
   every tile (fma, or refused for shared memory before any launch); K5 at
   b4 kvh 8 G 7 t256 D 128 at every kv tile, twice for the same bits;
4. the forward path, part one: extract every task the reference extracts
   from smollm-135m (batch 1, seq 256: dense, batch_matmul, rmsnorm, sfm
   and attention, non-dispatchable sites included) and tune them on the
   ``cuda`` backend through ``cached+local``, ``ROUNDS_PER_TASK`` search
   rounds a task (a task left with no tile the card runs gets up to
   ``COLD_SEARCHES`` further searches with fresh seeds; every task must
   reach a finite best, on every path, but a matrix product that no
   schedule reaches under the validator's tile cap and the lowering's grid
   cap, which ``schedulable`` leaves out and prints); rmsnorm goes through
   the structural lowering (``torch-fallback``), its candidates through a
   runner that times one no further once its first call passes
   ``STRUCTURAL_TIMEOUT_S``, sfm through K4;
5. the forward path, part two: the full-width 30-layer bf16 forward under
   ``DispatchContext`` (rmsnorm dispatched at all 61 sites, K3's 30 launches
   all tc, traced) against the same forward with no context;
7. the serving path: extract smollm-135m's decode tasks (4 slots, max_seq
   256, paged, 32-token prefill chunks), tune them the same way, serve 8
   requests through ``ContinuousBatchingScheduler`` on the paged arena
   under the tuned context, then the same requests with no context; one
   decode-only tick is run both ways and compared;
8. the operator path: ``tune_workload`` on the ``cuda`` backend for each
   of the paper's 12 operators at their reduced shapes and for ``sfm`` at
   256x256 (13 runs, small budget): sfm through K4, the others through the
   structural lowering;
6. each kernel's time at its smollm main-path shapes with the tuned tiles
   (K7's at mamba2's forward shape is phase 3c's; K1's at the mamba2
   unembed follows phases 9 and 10), beside its plain version, the one
   PyTorch call that computes the same function (where there is one;
   with a softcap or a window the compiled ``flex_attention``), and the
   least time the card could take (K1, K2 and K3, whatever variant
   launched, at the card's best f32-accurate rate, 3xTF32, K7 at the rate
   of each product's operand types, each also at 67 TFLOP/s); device times (kernel
   and library call) from CUDA events around a CUDA graph of 20 calls;
   then the same device times at fixed
   tiles (``FIXED_TILES``: the tiles of the per-shape tables PERF.md keeps
   for K1, K2, K3 and K4), so runs whose search picked other tiles compare
   at the same tile;
9. the mamba2-370m forward path: extract the reference's 14 tasks (batch 1,
   seq 256), tune them the same way, then the full-width bf16 forward at
   ``SSM_LAYERS`` = 4 of its 48 layers under ``DispatchContext`` (a
   rmsnorm hit a layer and the final one, the unembed, K7 at every layer),
   then held against the same forward with no context whose
   scan runs the plain version, both on the parameters cast to f32 (in
   bf16 the random deep model amplifies one-ulp differences; the bf16
   difference is reported); the same phase function as 15, 16, 20, 23 and
   25 (``phase_model_forward``);
10. the mamba2-370m serving path: extract its decode tasks (4 slots,
   max_seq 256: the slot arena, whole-prompt prefill), tune them, serve 8
   requests through ``ContinuousBatchingScheduler`` under the tuned context
   (K7 in every admitted prompt's prefill), then with no context; one
   decode-only tick with every slot live replayed both ways, timed and
   traced (``phase_ssm_serve``, as phase 24);
11. the olmoe-1b-7b forward path: extract the reference's 11 tasks (batch
   1, seq 256), tune them, then the
   full-width bf16 forward at ``MOE_LAYERS`` = 2 of its 16 layers under
   ``DispatchContext`` (K2 at every expert product, three launches a
   layer, printed by variant; K3 one a layer, all fma, at head dim 128),
   traced, against the same forward with no context.  Top-k routing is discontinuous, so the numbers are held in
   f32, on the parameters cast to f32: each MoE layer dispatched against
   plain on the same input (routing runs plain in both) within
   ``tol_moe_rel``, and the whole forward within ``TOL_LOGITS_REL`` when no
   token's routing differs between the two runs, with the flips of every
   layer printed;
12. the olmoe-1b-7b serving path: extract its 16 decode tasks (4 slots,
   max_seq 256, paged, 32-token chunks), tune them the same way, serve 8
   requests on the paged arena under the tuned context and with no
   context; one decode-only tick launches K2 three times a layer, all
   ``splitk``, and K5 once a layer, and is held against the plain tick in
   f32 as in phase 11;
   then phase 6 at olmoe's shapes;
13. the smollm-135m training path, at the launcher's batch 8, seq 128:
   extract the reference's 10 tasks and tune them; one step at
   ``TRAIN_LAYERS`` = 2 of its 30 layers under ``DispatchContext``
   against the same step with no context on f32 parameters (the loss
   within ``TOL_TRAIN_LOSS_REL``, every gradient leaf within
   ``TOL_TRAIN_GRAD`` of its max |g|, the AdamW updates within 2·lr); its
   launches (K1 14 a layer and the unembed, K3 two a layer, all ``tc``:
   remat runs each layer's forward twice) and hits by key; 4 bf16 steps on
   one batch under the tuned context, each timed, whose loss must fall,
   the plain step timed beside them and one step of each traced; phase 6
   at the step's shapes; then
   ``launch/train.py``'s ``main`` at full width for 10 steps with a
   checkpoint every 5, whose loss must fall, resumed from its step-5
   checkpoint and held against the uninterrupted run (``TOL_RESUME_REL``),
   with the checkpoint's round trip and the resumed batches bitwise;
14. the mamba2-370m training path: one step's loss and gradients with the
   scan on K7 (twice a layer; backward the plain scan's autograd) against
   the plain scan on f32 parameters, the six leaves that reach the loss
   only through the scan named and non-zero; then 4 bf16 steps on one
   batch, whose loss must fall (the same phase function as 13 and 27,
   ``phase_train``);
15. the qwen2-vl-2b paths (M-RoPE, embedding inputs): the reference's 10
   forward tasks (batch 1, seq 256, seeded embeddings) tuned, the
   full-width bf16 forward at ``VL_LAYERS`` = 2 of its 28 layers under
   ``DispatchContext`` (K3 one a layer, fma at D 128 GQA 6; K1 seven a
   layer, the unembed plain: no schedule fits both the tile and the grid
   cap; rmsnorm two a layer and the final one) against
   the same forward with no context, timed and traced, then both on f32
   parameters within ``TOL_F32_LOGITS_REL``; its 9 decode tasks tuned and
   8 requests served on the paged arena, dispatched
   and plain, with one decode-only tick (K5 once a layer) compared;
16. the whisper-medium paths (encoder, cross-attention): the reference's
   20 forward tasks (batch 1, seq 256, 1500 seeded frames) tuned, the
   full-width bf16 forward (``WHISPER_LAYERS`` = 2 encoder and 2 decoder
   layers) dispatched against plain as in phase 15 (K3 a layer: non-causal
   fma at S 1500 in the encoder, causal in the decoder; K2 four a decoder
   layer on the cross-attention's chunked contractions; K1 seven an
   encoder layer, eight a decoder layer and the unembed, the
   cross-attention's q/k/v plain as in the reference; every rmsnorm); its
   11 decode tasks tuned, then ``prefill`` of 4 prompts over 1500 frames
   and 16 greedy ``decode_step`` calls, dispatched and plain: in f32 the
   tokens agree (where one differs, the plain top-2 logits must be a near
   tie) and every step launches K5 once a layer over the 1500-frame cache
   and once over the 256-position one; bf16 steps timed and one traced; then phase 6 at the
   two models' shapes;
17. the measurement fleet: phase 4's smollm-135m forward tasks tuned
   through ``cached+pool://workers=2`` (two spawned worker processes on
   the card, timing in turns under the card's timing lock) and through
   ``rpc://`` to two ``spawn_local_workers`` processes, then one dense task
   with one RPC worker killed after the first batch (its budget must
   complete on the survivor); no timeout, crash, quarantine or
   ``MeasurementFault`` but that one death, every candidate of the budget
   measured, both RPC workers used; the workers' launches (K1-K4), each
   worker reading its wrappers' counters around every timing and sending
   the difference back in the result's meta, summed by kernel and variant;
   the pool's database
   dispatched into the full-width forward against plain within
   ``TOL_LOGITS_REL``; each best schedule scored by ``AnalyticalRunner``
   beside its measured ms; the legacy ``search/runner.py`` on one dense
   schedule; the phase's trace folded by ``obs/report.py``, whose fleet
   counts must equal the RPC runners' stats;
18. the serving router: two ``repro_torch.serving.worker`` processes
   spawned on the card, each serving smollm-135m at full width (30 layers,
   bf16, seed-0 parameters) on phase 7's paged arena and dispatching phase
   7's database (saved to a file), each warmed up with one short request;
   16 greedy requests of 16 tokens (phase 7's 8 prompts and 8 more from
   the same generator) through ``ServingRouter``, worker 0 SIGKILLed after
   the first poll round in which a request has tokens, then drained: all
   16 complete, exactly one death and at least one resubmit, the
   survivor's ``stats["launches"]`` show K1 and K5, every stream equals
   the same requests served by one scheduler in this process (built as a
   worker builds its own, run while the workers start) or differs first at
   a step whose in-process top-2 logits are within ``ROUTER_TIE_REL``; the
   same scheduler serves phase 7's prompts again in reverse order, and the
   two compositions' logits differ by at most half that bound; the
   phase's trace folded by ``obs/report.py`` gives ``serving_router``
   counts equal to the router's, and no worker is left after ``shutdown``;
19. the mesh path on one card: smollm-135m's tasks extracted under a
   logical (data 2, model 3) mesh that holds the card six times (batch 2,
   seq 256: the 9 per-shard keys of ``MESH_KEYS``), tuned as in phase 4
   and their tiles checked; the full-width forward in f32 dispatched under
   the mesh against the plain unsharded forward within
   ``TOL_F32_LOGITS_REL`` (``stats["mesh_sharded"]`` 241: 210 dense, the
   unembed and 30 attentions; K1 6 x 211 launches, K3 6 x 30, each
   per-shard kernel once a mesh coordinate), then in bf16 within
   ``TOL_LOGITS_REL``, timed; one dispatched loss and its gradients under
   the mesh against plain in f32 (``TOL_TRAIN_LOSS_REL``,
   ``TOL_TRAIN_GRAD``); K2 at olmoe's expert product (b64 m64 k2048 n1024)
   over a (model 2) mesh against ``torch.bmm``; the dry run
   (``launch/dryrun.py``) of smollm's ``DRYRUN_SHAPES`` cells on both
   production meshes (meta tensors only); each per-shard kernel timed as
   in phase 6;
20. the gemma2-2b forward (head_dim 256, attention softcap 50, a 4096-token
   window on every other layer, post-norms, gelu, the tied 256000-wide
   unembed with a logit softcap of 30): the reference's 12 tasks at batch
   1, seq 4608 (the window narrower than the sequence) tuned but the three
   products beyond the schedule caps (``schedulable``) and the norm
   (``plain_norm``), which run plain; the full-width bf16 forward at
   ``GEMMA_LAYERS`` = 4 of its 26 layers (a depth with a window period)
   under ``DispatchContext`` against the same forward with no context,
   timed and traced, then both on f32 parameters within
   ``TOL_F32_LOGITS_REL`` (K3 4 launches, all fma, 2 with the window; K1
   16; every gate derived from the config);
21. the gemma2-2b serving path, phase 7's tier at the same depth: the
   reference's 16 tasks of a paged tick tuned but the chunk norm
   (``plain_norm``), which runs plain, 8 requests of 16 new tokens served dispatched
   and plain, one decode-only tick held in f32 within ``TOL_F32_LOGITS_REL``
   (K5 4 launches at D 256, K1 29 all splitk, the unembed over the
   256000-wide table among them), its copies traced; then phase 6 at
   gemma2's shapes;
22. the three ``examples/*_torch.py`` twins, each its own process on the
   card, the three at once and beside phase 8, their timings and phase
   8's taking turns under one timing lock, collected before phase 6: the quickstart (``--smoke``) prints its trace
   and a finite best, the serving twin serves 8 of 8 requests, the
   training twin (``--steps 10 --rounds 1``) ends with a lower loss;
23. the hymba-1.5b forward (attention and Mamba-2 SSD heads in parallel in
   every layer; global attention at the first, middle and last layers, a
   1024-token window elsewhere: a pattern with no period, whose window the
   reference traces through its layer scan) at ``HYMBA_LAYERS`` = 6 of
   its 32 layers: the reference's 20 tasks (batch 1, seq 256) tuned but
   the unembed (``HYMBA_PLAIN_UNEMBED``) and the norm (``plain_norm``),
   which run plain; the bf16 forward dispatched
   against plain, timed and traced, then in f32 within
   ``TOL_F32_LOGITS_REL``: K2 at both chunked-attention contractions once
   a layer, ``traced_window`` at every layer's attention, K3 and the
   backend's fused attention never, K7 once a layer, K1 seven a layer;
24. the hymba-1.5b serving path: its 11 decode tasks (4 slots, max_seq
   1152) tuned, 8 requests of 16 new tokens served on the slot arena in
   f32, dispatched and plain, one prompt of 1088 tokens so that its
   decode steps pass the window: each dispatched stream equal to the plain
   one or differing first at a near tie (phase 18's rule), decode
   attention ``traced_window`` once a layer a tick and K5 never, K7 in
   every prefill; one decode-only tick replayed, compared, timed and
   traced; then phase 6 at hymba's shapes (K7 at N 16 on the forward and
   on the long prefill with its state);
25. the stablelm-3b forward at full width and half its depth,
   ``STABLELM_LAYERS`` = 16 of 32 (32 heads of 80 over 32 kv heads, no window):
   the reference's 9 tasks (batch 1, seq 256) tuned but the norm
   (``plain_norm``) and the unembed (``STABLELM_UNEMBED``), which run
   plain; the bf16 forward dispatched against plain, timed and traced,
   then in f32 within ``TOL_F32_LOGITS_REL``: K3 once a layer, all fma at
   D 80, its key hit once a layer, K1 seven a layer, the dispatch reasons
   the plain keys' ``unknown_key`` misses alone;
26. the stablelm-3b serving path, phase 7's paged tier at the same depth:
   its 11 dispatchable tasks tuned but the chunk norm (``plain_norm``), 8
   requests of 16 new tokens served on f32 parameters, dispatched and
   plain, each dispatched stream equal to the plain one or differing
   first at a near tie (phase 18's rule); one decode-only tick held within
   ``TOL_F32_LOGITS_REL`` (K1 113 all splitk, K5 16 at D 80, G 1); then
   phase 6 at stablelm's shapes;
27. hymba-1.5b's train step at batch 8, seq 128 and ``HYMBA_TRAIN_LAYERS``
   = 8 (over 4: no window period) through ``phase_train``: the reference's
   20 tasks tuned but the norm (``plain_norm``) and the unembed
   (``schedulable``); one f32 step under the
   tuned context against the plain step (no context, the plain scan):
   K1 seven a layer and K2 at both chunked contractions, each in the
   forward and in remat's recompute, K7 in both, K3 never,
   ``traced_window`` at every layer's attention in both, the loss, the
   gradients (the six scan leaves named) and the updates as in phase 13;
   then 4 bf16 steps on one batch, whose loss must fall; phase 6 at the
   step's keys;
28. the qwen1.5-110b forward at full width (64 heads of 128 over 8 kv
   heads, a bias on q, k and v, d_ff 49152, vocab 152064) and
   ``QWEN15_LAYERS`` = 6 of its 80 layers (the parameters in bf16 and f32
   fill most of the card): the reference's 10 tasks (batch 1, seq 256)
   tuned but the norm (``plain_norm``) and the MLP's two products and the
   unembed (``schedulable``), which run plain; the bf16 forward dispatched
   against plain, timed and traced, then in f32 within
   ``TOL_F32_LOGITS_REL``: K1 four a layer (q, k, v and o), K3 once a
   layer, all fma at D 128, G 8, its key hit once a layer, K2 never, the
   dispatch reasons the ``unknown_key`` misses of the 5·L + 2 plain sites
   alone; the phase's peak of allocated device memory;
29. the qwen1.5-110b serving path, phase 7's paged tier at the same
   depth: the 16 tasks of a paged tick tuned but the chunk norm and the
   chunk's MLP (no schedule), 8 requests of 16 new tokens served on f32
   parameters, dispatched and plain, each dispatched stream equal to the
   plain one or differing first at a near tie (phase 18's rule); one
   decode-only tick held within ``TOL_F32_LOGITS_REL`` (K1 43 all splitk,
   the m4 unembed over the 152064-wide table among them, K5 6 at D 128,
   G 8); the phase's peak memory; then phase 6 at qwen1.5's shapes;
   phases 28-29 leave the chunked attention's contractions, its softmax
   and the tick's four contractions untuned (tuning targets no dispatched
   site reaches);
30. the arctic-480b forward at full width (56 heads of 128 over 8 kv heads,
   128 experts top-2 of d_ff 4864 beside a dense residual MLP, vocab 32000)
   and ``ARCTIC_LAYERS`` = 2 of its 35 layers: the reference's 14 tasks
   (batch 1, seq 256) tuned but the norm, the router's product, the
   chunked attention's contractions and the softmaxes (``plain_norm``,
   ``ARCTIC_TUNING_ONLY``) and the two expert products (C 8) and the
   unembed, which no schedule reaches (``schedulable``, held key by key);
   the bf16 forward dispatched against plain, timed and traced, its error
   and routing flips by layer reported (K1 seven a layer, K3 once a layer,
   all fma at D 128, G 7, K2 never, the dispatch reasons the
   ``unknown_key`` misses of the 5·L + 2 plain sites alone); then
   ``ARCTIC_F32_LAYERS`` = 1 layer drawn anew and cast to f32 leaf by leaf
   (``cast_f32_``), dispatched against plain within ``TOL_F32_LOGITS_REL``
   where no token's routing differs; the peak of allocated device memory
   of the tuning, the bf16 forward and the f32 check, each leaving
   ``MIN_FREE_BYTES`` of the card free;
31. the arctic-480b serving path, phase 7's paged tier at
   ``ARCTIC_SERVE_LAYERS`` = 1 layer in f32: the 20 tasks of a paged tick
   tuned but the norms and ``ARCTIC_SERVE_TUNING_ONLY``, the two b128 m4
   expert products found by cold searches ``COLD_WIDE`` candidates wide;
   8 requests of 16 new tokens served dispatched and plain, the streams by
   phase 18's rule, every model call (a chunk's included) launching K2
   three times a layer; one decode-only tick within ``TOL_F32_LOGITS_REL``
   where no routing differs (K1 8 all splitk, the m4 unembed over the
   32000-wide table among them, K2 3 at b128 m4, K5 1 at G 7), each MoE
   layer of the tick dispatched against plain on the same f32 input
   within ``tol_moe_rel`` (7168·2^-24); the peaks as in phase 30; then
   phase 6 at arctic's shapes.

Every kernel wrapper counts its launches; the counts are zeroed just before
each of the twenty-seven paths (forward: phases 4-5; serving: phase 7;
operators: phase 8; mamba2 forward: phase 9; mamba2 serving: phase 10;
olmoe forward: phase 11; olmoe serving: phase 12; smollm training: phase
13; mamba2 training: phase 14; qwen2-vl forward and serving: phase 15;
whisper forward and decoding: phase 16; the fleet: phase 17; the router:
phase 18; the mesh: phase 19; gemma2 forward: phase 20; gemma2 serving:
phase 21; hymba forward: phase 23; hymba serving: phase 24; stablelm
forward: phase 25; stablelm serving: phase 26; hymba training: phase 27;
qwen1.5 forward: phase 28; qwen1.5 serving: phase 29; arctic forward:
phase 30; arctic serving: phase 31)
and read just
after it.  A path's launches, and the ``launches``
of the kernels line, count every process of the run: the parent's counters,
and on the fleet and router paths also the launches the spawned workers
report (phase 17's read around each timing and sent in the result's meta,
phase 18's read from ``stats`` from the end of each worker's warm-up to its
kill or the drain's end; ``fleet_worker_launches`` and
``router_worker_launches`` of the kernels line).  Each kernel's entry there
is timed at the shape where it did the most work on the paths: its
dispatch hits times its work a call (``shape_hits``; a kernel no
dispatched key reaches keeps its timed shape of most extracted work).
K1's, K2's and K3's launches are also counted by variant: K1's
are printed for the tuned forward, one decode-only tick (every one
``splitk``) and the mamba2 forward, K2's for phase 3 (every variant), the
serving path's tuning (every one ``splitk``, but gemma2's chunk
contraction at M 64), the olmoe forward and its
decode-only tick (every one ``splitk``), K3's for phase 3 (both variants),
the tuned forward (every one ``tc``), the olmoe forward (every one
``fma``) and the dispatched train step (every one ``tc``).  TF32 is off for float32 matmuls in
this script (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False), so the plain
versions run in full float32.  The second-to-last line is a JSON object
with one entry per kernel; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))
try:
    # the card's published peaks (H100 SXM data sheet, dense), one source
    # for the port's roofline and this script: f32 outside the tensor cores,
    # TF32 and bf16 on them, and HBM3 bandwidth.  A product of two f32
    # operands takes three TF32 products (3xTF32: K1's tc variant, K7 in
    # f32); one whose other operand is bf16, exact in TF32, takes two (K7's
    # scores.x, state and C.h in bf16); two bf16 operands take one bf16
    # product (K7's C.B^T in bf16)
    from repro_torch.backends.analysis import (
        PEAK_3XTF32_FLOPS,
        PEAK_BF16_FLOPS,
        PEAK_F32_FLOPS,
        PEAK_HBM_BYTES,
        PEAK_TF32_FLOPS,
    )
except ModuleNotFoundError as e:
    if e.name != "repro_torch":
        raise
    raise SystemExit("chip_smoke: src/repro_torch not found beside this script; "
                     "run it from the root of a checkout") from None

SEQ = 256
BATCH = 1
# Depth, at full width, of the paths whose forwards, ticks and steps take
# the run's time beside tuning (every dispatched path is host-bound, its
# time linear in its layers): whisper-medium's 24 encoder and 24 decoder
# layers (phase 16), olmoe-1b-7b's 16 (phases 11-12), smollm-135m's 30 in
# its train step (phase 13; the launcher trains all 30) and qwen2-vl-2b's
# 28 (phase 15) were halved first, and since gemma2-2b's phases 20-22
# came those four run a quarter of their depth, and since hymba-1.5b's
# phases 23-24 came mamba2-370m a quarter of its 48 (phases 9, 10 and 14);
# since stablelm-3b's phases 25-26 and hymba's train step (phase 27) came
# (101.6 s of a 1008.1 s run on an H100) and a run took 1187.1 s on a host
# 28 % slower, these paths run 2 to 4 layers, so that every path fits the
# run's time limit on a slow host (PERF.md §6); every gate is derived from
# the depth; gemma2-2b runs 4 of its 26 (``GEMMA_LAYERS``), hymba-1.5b 6 of
# its 32 (``HYMBA_LAYERS``), stablelm-3b 16 of its 32 (``STABLELM_LAYERS``),
# qwen1.5-110b 6 of its 80 (``QWEN15_LAYERS``: the card's memory),
# arctic-480b 2 of its 35 (``ARCTIC_LAYERS``: the card's memory), the other
# paths every layer
WHISPER_LAYERS = 2
MOE_LAYERS = 2
TRAIN_LAYERS = 2
VL_LAYERS = 2
SSM_LAYERS = 4
# search rounds a task, on every path.  Tuning takes most of the run (722 of
# 1139 s on an H100 at two rounds a task), and all fifteen paths must fit its
# time limit: phases 15-16 went from two rounds to one when phase 18 came
ROUNDS_PER_TASK = 1
M_FWD = BATCH * SEQ  # the rows of every forward matmul
TOL_MATMUL = 2e-3  # f32, K <= 2048, N(0,1) inputs: |y| up to ~200
TOL_ATTN = 1e-4  # f32, outputs are convex combinations of v
TOL_LOGITS_REL = 5e-2  # bf16 plain forward vs f32 kernels cast to bf16
TOL_SOFTMAX_F32 = 1e-5  # f32 softmax values lie in [0, 1]
TOL_SOFTMAX_BF16 = 8e-3  # two bf16 ulps at 1
# K7 against its plain version, relative to the output's largest magnitude:
# f32 sums of N + L terms in another order; with bf16 x/B/C both round y
# to bf16 once (one ulp is 2^-8 of |y|); the f32 state like f32 y
TOL_SSD_F32 = 1e-5
TOL_SSD_BF16 = 8e-3

# the same dispatched forward and decode-only tick measured before rmsnorm
# was dispatched (PERF.md, NVIDIA H100 80GB HBM3, 700 W)
NO_NORM_FORWARD_MS = 82.39
NO_NORM_TICK_MS = 100.25
# K1's device time in one traced decode-only tick when it had only its FMA
# kernel, before the split-K variant (PERF.md, NVIDIA H100 80GB HBM3, 700 W)
FMA_TICK_K1_MS = 20.09

# the serving path (phase 7)
SERVE_SLOTS = 4
SERVE_MAX_SEQ = 256
SERVE_PAGE = 16
SERVE_CHUNK = 32
SERVE_REQUESTS = 8
# 16 new tokens a request on phase 7's tier and the router's, as on
# gemma2's, hymba's and stablelm's: for the run's time on a slow host
SERVE_NEW_TOKENS = 16

# the mamba2-370m paths (phases 9 and 10): the slot arena, whole prompts
SSM_ARCH = "mamba2-370m"
SSM_CHUNK = 64
SSM_FORWARD_TASKS = 14
SSM_DECODE_TASKS = 7

# the olmoe-1b-7b paths (phases 11 and 12): the forward at batch 1, seq 256,
# and the serving path's paged arena
MOE_ARCH = "olmoe-1b-7b"
MOE_FORWARD_TASKS = 11
MOE_DECODE_TASKS = 16

# the training paths (phases 13 and 14): the launcher's defaults, batch 8,
# seq 128, lr 3e-4; smollm-135m's 10 training tasks tuned.  The dispatched step (f32 kernels, f32 parameters) against
# the plain one: the loss within 1e-4 relative and each gradient leaf within
# 1e-3 of its max |g| (f32 sums in other orders through 30 or 48 layers and
# their backward); the updated parameters within 2·lr, since the first AdamW
# step moves each element by about sign(g)·lr and a rounding-level gradient
# may flip sign.  A resumed launcher run against an uninterrupted one: the
# loss sequence within 1e-3 relative (backward on the card need not be
# deterministic)
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH = 8
TRAIN_SEQ = 128
TRAIN_TASKS = 10
TRAIN_LR = 3e-4
TOL_TRAIN_LOSS_REL = 1e-4
TOL_TRAIN_GRAD = 1e-3
LAUNCHER_STEPS = 10
LAUNCHER_CKPT_EVERY = 5
TOL_RESUME_REL = 1e-3
SSM_TRAIN_STEPS = 4
# the leaves of the SSD mixer that reach the loss only through the scan
SSD_SCAN_LEAVES = ("wx", "wB", "wC", "wdt", "A_log", "dt_bias")
# phases 15-16: qwen2-vl-2b (M-RoPE, embedding inputs) and whisper-medium
# (encoder, cross-attention), their forwards and decode tasks tuned, their
# logits held in f32 against plain
VL_ARCH = "qwen2-vl-2b"
VL_FORWARD_TASKS = 10
VL_DECODE_TASKS = 9
WHISPER_ARCH = "whisper-medium"
WHISPER_FORWARD_TASKS = 20
WHISPER_DECODE_TASKS = 11
ENC_FRAMES = 1500  # whisper-medium's encoder frames
WHISPER_PROMPT = 32
WHISPER_STEPS = 16
# f32 parameters, dispatched against plain: f32 sums in other orders (and
# the encoder's 24 layers before the decoder's), relative to max |logit|
TOL_F32_LOGITS_REL = 1e-4
# phase 17: the measurement fleet, smollm-135m's forward tasks tuned through
# two spawned pool workers and two RPC workers on the card; the dense task
# tuned again with one RPC worker killed mid-run, whose pool-tuned best the
# legacy serial runner also times
FLEET_WORKERS = 2
FLEET_KILL_TASK = "dense/k=576/m=256/n=576"
LOCK_TAKES = 1000
# phase 18: the serving router, smollm-135m at full width from two worker
# processes on the card (phase 7's arena and database), one SIGKILLed once
# the first tokens are out; 16 greedy requests: phase 7's 8 prompts and 8
# more from the same generator
ROUTER_ARCH = "smollm-135m"
ROUTER_WORKERS = 2
ROUTER_REQUESTS = 16
# a stream served through the router against the same requests served by
# one scheduler in this process, on the same parameters, settings and
# database.  Both run the same kernels, but a token's tick differs in
# composition (a resubmitted request's prompt chunks and decode steps share
# ticks with other requests), so its rows can go through K1 at another M and
# tile (m4 splitk, m128 tc): f32 sums in other orders before the bf16
# roundings.  Where two runs' logits at a step differ by at most d of max
# |logit|, their argmax can differ only where the top-2 gap is at most 2d.
# d is measured in every run between two in-process compositions (phase 7's
# prompts served again in reverse order): 2.06e-2 over 256 steps on an H100
# (NVIDIA H100 80GB HBM3, 700.00 W), where the in-process gaps had a median
# of 0.316 and 6.4 % of steps within 0.1.  The bound is twice 2d, for
# compositions the reversed run does not reach, and the run fails if its
# own 2d exceeds it
ROUTER_TIE_REL = 8e-2
# phase 19, the mesh path on one card: smollm-135m at batch 2, seq 256 on a
# logical (data 2, model 3) mesh that holds the card six times; the 9
# per-shard keys the reference's extraction gives under that mesh, with
# their weights
MESH_SHAPE = (2, 3)
MESH_BATCH = 2
MESH_KEYS = {
    "dense/k=576/m=256/n=512": 60,
    "dense/k=576/m=256/n=16384": 1,
    "dense/k=1536/m=256/n=192": 30,
    "dense/k=576/m=256/n=192": 60,
    "dense/k=576/m=256/n=64": 60,
    "attention/b=1/causal=1/d=64/h=3/kvh=1/s=256/softcap=0.0/window=0": 30,
    "batch_matmul/b=2/k=256/m=768/n=64": 30,
    "batch_matmul/b=2/k=64/m=768/n=256": 30,
    "rmsnorm/d=576/eps=1e-06/tokens=512": 61,
}
# olmoe-1b-7b's expert product (B, M, K, N), served over a (model 2) mesh
MESH_BMM = (64, 64, 2048, 1024)
# the dry-run cells phase 19 runs on both production meshes (the whole
# grid of smollm's cells takes ~27 s on a CPU; PERF.md)
DRYRUN_SHAPES = ("train_4k",)
# phases 20-21, gemma2-2b (head_dim 256, attention softcap 50, a 4096-token
# window on every other layer, post-norms, gelu, a tied 256000-wide unembed
# with a logit softcap of 30).  The forward runs at batch 1, seq 4608, so
# that the local layers' window is narrower than the sequence; its depth is
# 4 of 26 layers, an even depth, with the window period 2, where an odd
# one has none: at such a depth neither
# package extracts the fused attention task (``window_period``), and K3
# would leave the path.  Serving is phase 7's tier at the same depth
GEMMA_ARCH = "gemma2-2b"
GEMMA_LAYERS = 4
GEMMA_SEQ = 4608
GEMMA_FORWARD_TASKS = 12
# the reference's tasks of gemma2's paged serving tick, every site
# included: a decode step's and the 32-token chunks'.  All are tuned but
# the chunk norm (128 tokens, d 2304, 57 sites a tick), which runs plain:
# through the structural lowering it took 15.1 ms a call, so each prefill
# tick spent about a second in host loops (PERF.md)
GEMMA_SERVE_TASKS = 16
# likewise the forward's norm (d 2304 over 4608 tokens, 57 sites) is
# extracted but not tuned: it has no kernel, and the structural lowering's
# candidates loop on the host, each over 0.5 s on its first call at this
# size (8 of 8 in a round, 76.9 s, then the fresh searches past the run's
# limit, on an H100: NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).  The decode
# step's norm (4 tokens) is tuned

# a gemma2 forward candidate (seq 4608) whose first call passes 0.5 s is
# timed no further: the tuned tiles take 1-41 ms a call, and timing each
# slow sampled tile in full (its warm-up and three repeats after the first
# call) took 56.8-80.8 s of one fresh search (PERF.md)
GEMMA_TUNE_TIMEOUT_S = 0.5
# 8 requests of 16 new tokens, not phase 7's 32: every dispatched tick is
# host-bound (230-400 ms), and the run's time limit holds
GEMMA_NEW_TOKENS = 16
# K3 at D 256 runs fma only (``TC_HEAD_DIMS``); (16, 64) fits its CTA in
# shared memory there (168,384 bytes) and the lowering's grid cap (a q
# block of 8 rows, whose CTA fits too, does not), (64, 64) does not fit;
# K5's block_kv 64 fits at D 256 and G 2, 128 does not
GEMMA_K3_TILE = (16, 64)
GEMMA_K3_OVER_CAP = (64, 64)
GEMMA_K5_TILE = 64
GEMMA_K5_OVER_CAP = 128
# the seed of phase 3e's inputs, which the flex process draws again
FLEX_SEED = 26
# phases 23-24: hymba-1.5b, attention and Mamba-2 SSD heads in parallel in
# every layer, global attention at the first, middle and last layers and a
# 1024-token window elsewhere.  That pattern has no period at any depth
# over 4, so the reference traces the window through its layer scan and
# serves attention through its chunked path's two contractions (K2), never
# the fused kernel (K3), and decode attention plainly, never K5; a cut
# depth must stay over 4.  6 of its 32 layers (globals at 0, 3 and 5), as
# the other large paths run at a fraction: at 32 the two phases and their
# phase 6 took 95 s on an H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# §6), 42.5 s at 16
HYMBA_ARCH = "hymba-1.5b"
HYMBA_LAYERS = 6
HYMBA_FORWARD_TASKS = 20
HYMBA_DECODE_TASKS = 11
# one prompt of 1088 tokens (17 SSD chunks of 64) decodes 16 tokens at
# positions 1088-1103, past the window, so every windowed layer's mask
# drops its oldest keys; the cache holds 1152 positions (its global layers
# keep the whole context)
HYMBA_LONG_PROMPT = 1088
HYMBA_MAX_SEQ = 1152
HYMBA_NEW_TOKENS = 16
# the forward's norm (256 tokens, d 1600) is extracted but left plain, as
# gemma2's are: 2 of its 8 structural candidates passed
# STRUCTURAL_TIMEOUT_S on their first call, and its round took 10.6 s
# (measured on one H100); the decode tick's norm (4 tokens) is tuned.
# The forward unembed (m256 k1600 n32001) is extracted but left plain:
# 32001 = 3 x 10667 with 10667 prime, so K1's bn is 1 or 3 (a wider tile
# needs more than its 512 threads), and a tile under the grid cap then
# needs bm·bk >= 16,667, which the seeded search's tilings (their inner
# reduce factor at most 128, and a divisor of 1600) almost never draw: a
# fresh search and its three reseeded ones rejected every candidate
# (tests/test_torch_hymba.py runs that search).  FIXED_TILES times K1 at
# the tile (256, 3, 80) instead; the decode unembed (m4) is tuned
HYMBA_PLAIN_UNEMBED = "dense/k=1600/m=256/n=32001"
# hymba-1.5b's train step (phase 27) at batch 8, seq 128: 8 layers, over
# 4, so its windows (globals at 0, 4 and 7) have no period and the
# reference traces them (K2 at the chunked contractions, never K3); the
# reference's 20 tasks, the unembed (1024·32001·1600 multiply-adds) beyond
# the schedule caps and the norm left plain
HYMBA_TRAIN_LAYERS = 8
HYMBA_TRAIN_TASKS = 20
# phases 25-26: stablelm-3b at full width (d_model 2560, 32 heads of 80
# over 32 kv heads, d_ff 6912, vocab 50304) and 16 of its 32 layers (all
# 32 until arctic-480b's phases 30-31 came, whose time they pay for with
# the tuning inputs drawn on the card; PERF.md §6): no window, so any
# depth is periodic and the reference serves its
# attention through K3, on fma (D 80 is no tc head dim), and K5 at D 80,
# G 1.  The forward's norm is left plain, as gemma2's and hymba's are
# (plain_norm); the serving chunk's too, the tick's is tuned.  The forward
# unembed needs 256·50304·2560 = 3.30e10 multiply-adds, 4 % under the two
# caps' product, so only tiles of 125,770-131,072 elements whose bn divides
# 50304 = 2^7·3·131 fit both caps.  It is left plain: the seeded searches
# draw such a tile only in their third reseed (tests/test_torch_stablelm.py
# runs them), and the tile a search drew on the card changed from run to
# run, once an fma tile 20 times slower than the plain product, so the
# tuned path would have two modes.  FIXED_TILES times K1 at the valid tile
# (256, 128, 4)
STABLELM_ARCH = "stablelm-3b"
STABLELM_LAYERS = 16
STABLELM_FORWARD_TASKS = 9
STABLELM_UNEMBED = "dense/k=2560/m=256/n=50304"
# phases 28-29: qwen1.5-110b at full width (d_model 8192, 64 heads of 128
# over 8 kv heads, d_ff 49152, vocab 152064, a bias on q, k and v) and 6 of
# its 80 layers: no window, so any depth is periodic and the reference
# serves its attention through K3, on fma (D 128 is no tc head dim), and K5
# at D 128, G 8.  A layer holds 1.36e9 parameters and the tied embedding
# 1.25e9: at 6 layers 18.8 GB in bf16 and 37.6 GB in f32, both held while
# the forward's f32 check casts them (the phase's peak was 56.7-57.7 GB
# allocated on an H100; 7 layers would take 65 GB, 8 layers 73).  The forward's MLP (256·49152·8192
# = 1.03e11 multiply-adds), its unembed (3.19e11) and the serving chunk's
# MLP at m128 (5.15e10) exceed the caps' product 2^35 and run plain
# (``schedulable``), as the norms do but the tick's (``plain_norm``)
QWEN15_ARCH = "qwen1.5-110b"
QWEN15_LAYERS = 6
QWEN15_FORWARD_TASKS = 10
QWEN15_SERVE_TASKS = 16
# the chunked attention's contractions and its softmax (the forward) and
# the four contractions of a paged tick's chunk and decode step: tuning
# targets no dispatched site reaches (K3 and K5 replace them), left
# untuned for the run's time
QWEN15_TUNING_ONLY = (
    "batch_matmul/b=8/k=128/m=2048/n=256", "batch_matmul/b=8/k=256/m=2048/n=128",
    "sfm/m=16384/n=256",
)
QWEN15_SERVE_TUNING_ONLY = (
    "batch_matmul/b=32/k=128/m=256/n=256", "batch_matmul/b=32/k=256/m=256/n=128",
    "batch_matmul/b=32/k=128/m=8/n=256", "batch_matmul/b=32/k=256/m=8/n=128",
)
# phases 30-31: arctic-480b at full width (d_model 7168, 56 heads of 128
# over 8 kv heads, G 7; 128 experts top-2 of d_ff 4864 beside a dense
# residual MLP of d_ff 4864; vocab 32000).  A layer holds 1.361e10
# parameters, 27.2 GB in bf16 and 54.4 GB in f32, 3 x 8.93 GB of them the
# experts; the tied embedding 0.46 GB.  The bf16 forward runs 2 of its 35
# layers (54.9 GB), its f32 check 1 layer drawn anew (54.4 GB, cast leaf by
# leaf: ``cast_f32_``), and paged serving in f32 1 layer: K2's expert
# products at the tick's b128 m4 read the f32 experts in place, where a
# bf16 served model's would be copied to f32 a call (17.85 GB each).  At
# seq 256 an expert takes C = max(int(2·2·256/128), 4) = 8 tokens: the
# forward's expert products (128·8·7168·4864 = 3.57e10 multiply-adds) and
# unembed (5.87e10) exceed the caps' product 2^35 and run plain
# (``schedulable``); a tick's C is 4 (1.785e10), so K2 serves them there.
# The router's product, the chunked attention's two contractions and the
# softmaxes are tuning targets no dispatched site reaches, left untuned
# with the norms
ARCTIC_ARCH = "arctic-480b"
ARCTIC_LAYERS = 2
ARCTIC_F32_LAYERS = 1
ARCTIC_SERVE_LAYERS = 1
ARCTIC_FORWARD_TASKS = 14
ARCTIC_SERVE_TASKS = 20
ARCTIC_TUNING_ONLY = (
    "dense/k=7168/m=256/n=128",  # the router, a plain einsum in both packages
    "batch_matmul/b=8/k=128/m=1792/n=256", "batch_matmul/b=8/k=256/m=1792/n=128",
    "sfm/m=14336/n=256", "sfm/m=256/n=128",
)
ARCTIC_SERVE_TUNING_ONLY = (
    "dense/k=7168/m=4/n=128", "dense/k=7168/m=128/n=128",
    "batch_matmul/b=32/k=128/m=224/n=256", "batch_matmul/b=32/k=256/m=224/n=128",
    "batch_matmul/b=32/k=128/m=7/n=256", "batch_matmul/b=32/k=256/m=7/n=128",
)
# the batch of 128 experts takes 7 of the grid cap's 18 bits, so of the
# valid tiles the space draws for a b128 m4 expert product about one in
# 200 fits both caps: the first round's 8 candidates of each fit none
# (tests/test_torch_arctic.py), and searches of 8 candidates a round drew
# none for one of the two in 22 reseeds (on the CPU, a runner that lowers
# and times nothing); a further search of a task left with no tile
# measures this many fresh samples a round, each rejected before any
# launch but those the card runs
COLD_WIDE = 128
# every part of the arctic, qwen1.5 and stablelm paths leaves this much of
# the card's memory free at its peak
MIN_FREE_BYTES = 15e9
# phase 22: the three examples/ twins, each a process on the card
EXAMPLE_RUNS = (
    ("quickstart_torch.py", ["--smoke"]),
    ("serve_batched_torch.py", []),
    ("tune_and_train_torch.py", ["--steps", "10", "--rounds", "1"]),
)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def graph_ms(fn, reps: int = 20) -> float:
    """The device time of one call of ``fn``: CUDA events around one replay
    of a CUDA graph that captured ``reps`` calls, over ``reps`` (the gaps
    between the graph's kernels included, the host's enqueue not); the
    calls are warmed on the capture stream first, so the graph allocates
    nothing new.  Not the profiler: over 20 back-to-back calls it misses
    whole windows, or part of one, at random (PERF.md)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import numpy as np
    import torch

    from repro_torch.search.measure.local import time_call

    return float(np.median(time_call(fn, torch.device("cuda"), reps, warmup))) * 1e3


def timed_ms(fn, n: int = 3):
    """(the last output, median host ms) of ``n`` calls of ``fn``, each
    ending in ``synchronize()``."""
    import torch

    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return out, sorted(ts)[len(ts) // 2] * 1e3


def sdpa(q, k, v, causal: bool):
    """The library call that computes K3's function (a yardstick only)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True
    )


# compiled flex_attention calls by (q shape, k shape, window, softcap,
# decode): the shapes and options of phases 3e and 6 compile once each
_FLEX = {}


def flex_call(q, k, v, *, window: int = 0, softcap=None, bias=None):
    """The library call that computes K3's function, causal (``bias``
    None), or K5's (q (B, KVH, G, D), ``bias`` (B, T)) with a softcap or a
    window: PyTorch's ``flex_attention``, compiled, the softcap (and K5's
    bias) as its score_mod and the causal window as its BlockMask.  A
    yardstick only: the port never calls it.  Returns the call; its output
    is (B, H, S, D), K5's (B, H, 1, D)."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    decode = bias is not None
    B, _, T, D = k.shape
    qq = q.reshape(B, -1, 1, D) if decode else q
    key = (tuple(qq.shape), tuple(k.shape), window, softcap, decode)
    if key not in _FLEX:
        buf = torch.zeros(B, T, device=q.device) if decode else None

        def score_mod(score, b, h, q_idx, kv_idx):
            if softcap:
                score = softcap * torch.tanh(score / softcap)
            return score + buf[b, kv_idx] if decode else score

        def mask_mod(b, h, q_idx, kv_idx):
            keep = q_idx >= kv_idx
            return keep & (q_idx - kv_idx < window) if window else keep

        mask = None if decode else create_block_mask(
            mask_mod, None, None, qq.shape[2], T, device=q.device)
        _FLEX[key] = (torch.compile(flex_attention, dynamic=False, fullgraph=True),
                      score_mod, mask, buf)
    fn, score_mod, mask, buf = _FLEX[key]
    if decode:
        buf.copy_(bias)
    return lambda: fn(qq, k, v, score_mod=score_mod, block_mask=mask, enable_gqa=True)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def mm_bound(M: int, N: int, K: int, B: int = 1):
    """(bound ms, by, bound ms at 67 TFLOP/s) of one K1 (B = 1) or K2 call:
    2BMNK flops at the card's best f32-accurate rate (3xTF32), whatever
    variant launched, x and w read once, y written once."""
    flops, nbytes = 2 * B * M * N * K, 4 * B * (M * K + K * N + M * N)
    b_ms, b_by = bound(flops, nbytes, PEAK_3XTF32_FLOPS)
    return b_ms, b_by, bound(flops, nbytes)[0]


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def phase_build() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    dt = time.perf_counter() - t0
    print(f"[build] {sorted(built) or 'cached'} in {dt:.1f} s "
          f"into {_build.build_dir()}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    return dt


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(gen) -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref, sm_count

    dev = "cuda"
    errs = {"matmul": 0.0, "batch_matmul": 0.0, "flash_attention": 0.0}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def report(kernel, label, got, want, tol, k_ms, p_ms, lib_ms=None, exact=None):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        errs[kernel] = max(errs[kernel], err)
        lib = f" library {lib_ms:.4f} ms" if lib_ms is not None else ""
        f64 = ""
        if exact is not None:  # the same product in float64, as a witness
            f64 = (f" (kernel vs float64 {float((got.double() - exact).abs().max()):.3e},"
                   f" plain vs float64 {float((want.double() - exact).abs().max()):.3e})")
        print(f"[kernels] {kernel} {label}: max_abs_err {err:.3e} (tol {tol:g}){f64} "
              f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms{lib}")
        if not math.isfinite(err) or err > tol:
            fail(f"{kernel} {label}: max_abs_err {err} > {tol}")

    # K1, each variant against the plain version, every epilogue.  splitk:
    # the five decode shapes (m4) with w in both layouts, one split and
    # many, and a bn that is not a multiple of 4, and mamba2's unembed;
    # tc: the four forward shapes (m256), a serving chunk (m128), smollm's
    # and mamba2's transposed unembeds, in one and two stages; fma: one
    # tile (bk = 36) that neither of the others takes.  check_tiles holds
    # every tuned K1 tile against the plain version as well
    vocab, ssm_vocab = 49152, 50280
    k1_cases = [
        (4, 576, 1536, (4, 64, 48), "splitk"),
        (4, 1536, 576, (4, 64, 96), "splitk"),
        (4, 576, 576, (4, 18, 64), "splitk"),
        (4, 576, 192, (4, 48, 576), "splitk"),
        (4, 576, vocab, (4, 256, 96), "splitk"),
        (4, 576, vocab, (4, 512, 576), "splitk"),
        (4, 1024, ssm_vocab, (4, 60, 64), "splitk"),
        (M_FWD, 576, 576, (64, 64, 32), "tc"),
        (M_FWD, 576, 192, (32, 48, 64), "tc"),
        (M_FWD, 576, 1536, (128, 192, 96), "tc"),
        (M_FWD, 1536, 576, (128, 64, 128), "tc"),
        (128, 576, 1536, (128, 16, 24), "tc"),
        (M_FWD, 576, vocab, (64, 192, 64), "tc"),
        (M_FWD, 1024, ssm_vocab, (32, 120, 32), "tc"),
        (M_FWD, 576, 1536, (128, 8, 36), "fma"),
    ]
    for M, K, N, blocks, var in k1_cases:
        if N in (vocab, ssm_vocab):
            layouts = ("k",)  # the tied unembed reads the table transposed
        else:
            layouts = ("n", "k") if var == "splitk" else ("n",)
        for layout in layouts:
            x = randn(M, K)
            w = randn(N, K).t() if layout == "k" else randn(K, N)
            bias = randn(N)
            cfg = mm.launch_config(1, M, N, K, blocks)
            if cfg["variant"] != var:
                fail(f"matmul {blocks} on {(M, N, K)} takes {cfg['variant']}, not {var}")
            exact = x.double() @ w.double()
            for epi in ("none", "bias", "relu", "gelu", "silu", "softcap"):
                b = bias if epi == "bias" else None
                got = mm.matmul(x, w, b, epilogue=epi, block_sizes=blocks)
                if mm.matmul.last_launch != cfg:
                    fail(f"matmul launched {mm.matmul.last_launch}, want {cfg}")
                want = ref.matmul(x, w, b, epilogue=epi)
                k_ms = median_ms(lambda: mm.matmul(x, w, b, epilogue=epi, block_sizes=blocks))
                p_ms = median_ms(lambda: ref.matmul(x, w, b, epilogue=epi))
                lib_ms = None
                if epi == "none":
                    lib_ms = median_ms(lambda: torch.matmul(x, w))
                elif epi == "bias":
                    lib_ms = median_ms(lambda: torch.addmm(b, x, w))
                label = (f"{var} ({M},{N},{K}) w {layout}-contiguous {epi} blocks "
                         f"{blocks} grid {cfg['grid']} stages {cfg['stages']} "
                         f"splits {cfg['splits']}")
                report("matmul", label, got, want, TOL_MATMUL, k_ms, p_ms, lib_ms,
                       exact if epi == "none" else None)

    # K2, each variant against the plain version, with the float64 product
    # as a witness: tc at smollm's two attention contractions in canonical
    # layout (B·KVH, G·S, ·), in two stages and one, and at hymba-1.5b's
    # (b5 m1280, dispatched in its forward); splitk at the serving decode
    # contraction (b12 m3 k256 n64) in one split and many, each run twice
    # for the same bits; fma at a ragged tile.  check_tiles holds every
    # tuned K2 tile against the plain version as well
    H, KVH, D = 9, 3, 64
    G = H // KVH
    k2_before = read_variants("batch_matmul")
    for (Bb, Mm, Kk, Nn), bs, var in (
        ((KVH, G * SEQ, SEQ, D), (96, 64, 32), "tc"),
        ((KVH, G * SEQ, SEQ, D), (128, 64, 256), "tc"),
        ((KVH, G * SEQ, D, SEQ), (48, 64, 64), "tc"),
        ((KVH, G * SEQ, D, SEQ), (96, 64, 32), "tc"),
        ((5, 1280, 256, 64), (64, 64, 64), "tc"),
        ((5, 1280, 64, 256), (128, 128, 64), "tc"),
        ((12, 3, 256, 64), (3, 64, 256), "splitk"),
        ((12, 3, 256, 64), (3, 64, 32), "splitk"),
        ((12, 3, 256, 64), (1, 16, 64), "splitk"),
        ((KVH, G * SEQ, SEQ, D), (24, 32, 32), "fma"),
        # olmoe-1b-7b's expert products: the forward's wi/wg (m64) and a
        # decode tick's (m4) in one split and in 128
        ((64, 64, 2048, 1024), (64, 64, 32), "tc"),
        ((64, 4, 2048, 1024), (4, 1024, 2048), "splitk"),
        ((64, 4, 2048, 1024), (4, 64, 16), "splitk"),
    ):
        a, b = randn(Bb, Mm, Kk), randn(Bb, Kk, Nn)
        cfg = mm.launch_config(Bb, Mm, Nn, Kk, bs)
        if cfg["variant"] != var:
            fail(f"batch_matmul {bs} on {(Bb, Mm, Nn, Kk)} takes {cfg['variant']}, not {var}")
        got = mm.batch_matmul(a, b, block_sizes=bs)
        again = mm.batch_matmul(a, b, block_sizes=bs)
        if mm.batch_matmul.last_launch != cfg:
            fail(f"batch_matmul launched {mm.batch_matmul.last_launch}, want {cfg}")
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"batch_matmul {var} {bs} on {(Bb, Mm, Nn, Kk)}: two runs differ")
        want = ref.batch_matmul(a, b)
        report("batch_matmul",
               f"{var} ({Bb},{Mm},{Nn},{Kk}) blocks {bs} grid {cfg['grid']} stages "
               f"{cfg['stages']} splits {cfg['splits']}", got, want,
               TOL_MATMUL, median_ms(lambda: mm.batch_matmul(a, b, block_sizes=bs)),
               median_ms(lambda: ref.batch_matmul(a, b)),
               median_ms(lambda: torch.bmm(a, b)), a.double() @ b.double())
    k2_variants = {k: n - k2_before[k] for k, n in read_variants("batch_matmul").items()}
    print(f"[kernels] batch_matmul launches by variant in phase 3: {k2_variants}")
    if min(k2_variants.values()) <= 0:
        fail(f"batch_matmul variants launched in phase 3: {k2_variants}")

    # K3: causal, sliding window, softcap, GQA 9/3, at S=256 and S=96, on
    # the tc variant (the S=96 tiles leave the last m16 tile of a CTA part
    # filled) and on fma (a kv tile of 4), each run twice for the same bits
    k3_before = read_variants("flash_attention")
    sms = sm_count(dev)
    for S in (SEQ, 96):
        q = randn(BATCH, H, S, D)
        k, v = randn(BATCH, KVH, S, D), randn(BATCH, KVH, S, D)
        for label, kw, blocks, var in (
            ("causal", dict(causal=True), (64, 32), "tc"),
            ("causal window=64", dict(causal=True, window=64), (8, 64), "tc"),
            ("causal softcap=50", dict(causal=True, softcap=50.0), (48, 96), "tc"),
            ("full", dict(causal=False), (128, 128), "tc"),
            ("causal", dict(causal=True), (32, 4), "fma"),
        ):
            bq, bkv = blocks
            got = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
            again = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)
            plan = fa.flash_attention.last_launch
            snapped = plan["blocks"]
            if plan != fa.launch_config(BATCH, H, KVH, S, D, *snapped, sms) or \
                    plan["variant"] != var:
                fail(f"flash_attention {snapped} on S={S} launched {plan}, want {var}")
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"flash_attention {var} {snapped} on S={S}: two runs differ")
            want = ref.flash_attention(q, k, v, **kw)
            lib_ms = None
            if "window" not in kw and "softcap" not in kw:
                lib_ms = median_ms(lambda: sdpa(q, k, v, kw["causal"]))
            report("flash_attention",
                   f"{var} (1,{H},{S},{D}) kvh {KVH} {label} blocks {snapped} grid "
                   f"{plan['grid']} threads {plan['threads']} splits {plan['splits']}",
                   got, want, TOL_ATTN,
                   median_ms(lambda: fa.flash_attention(
                       q, k, v, block_q=bq, block_kv=bkv, **kw)),
                   median_ms(lambda: ref.flash_attention(q, k, v, **kw)), lib_ms)
    # olmoe-1b-7b's attention, (1, 16, 256, 128) kvh 16 causal: tc takes no
    # D above 64, so K3 runs fma there
    q = randn(BATCH, 16, SEQ, 128)
    k, v = randn(BATCH, 16, SEQ, 128), randn(BATCH, 16, SEQ, 128)
    got = fa.flash_attention(q, k, v, block_q=32, block_kv=32)
    again = fa.flash_attention(q, k, v, block_q=32, block_kv=32)
    plan = fa.flash_attention.last_launch
    if plan != fa.launch_config(BATCH, 16, 16, SEQ, 128, 32, 32, sms) or plan["variant"] != "fma":
        fail(f"flash_attention (32, 32) at D 128 launched {plan}, want fma")
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("flash_attention fma at D 128: two runs differ")
    report("flash_attention",
           f"fma (1,16,{SEQ},128) kvh 16 causal blocks (32, 32) grid {plan['grid']}",
           got, ref.flash_attention(q, k, v), TOL_ATTN,
           median_ms(lambda: fa.flash_attention(q, k, v, block_q=32, block_kv=32)),
           median_ms(lambda: ref.flash_attention(q, k, v)),
           median_ms(lambda: sdpa(q, k, v, True)))
    # whisper-medium's encoder attention, (1, 16, 1500, 64) non-causal: no
    # divisor of 1500 is a multiple of 8, so every tile K3 takes there is
    # fma; qwen2-vl-2b's (1, 12, 256, 128) kvh 2 causal, fma at D 128;
    # stablelm-3b's (1, 32, 256, 80) kvh 32 causal, fma at D 80 (no tc head
    # dim); and qwen1.5-110b's (1, 64, 256, 128) kvh 8 causal, fma at D 128,
    # G 8 (70,144, 76,128 and 148,480 bytes of shared memory); with the bound
    for (h, kvh, s, d, causal), tiles in (
        ((16, 16, ENC_FRAMES, 64, False), ((60, 50), (125, 125))),
        ((12, 2, SEQ, 128, True), ((32, 32), (64, 16))),
        ((32, 32, SEQ, 80, True), ((32, 32), (16, 64))),
        ((64, 8, SEQ, 128, True), ((32, 32), (8, 64), (64, 64))),
    ):
        q = randn(BATCH, h, s, d)
        k, v = randn(BATCH, kvh, s, d), randn(BATCH, kvh, s, d)
        want = ref.flash_attention(q, k, v, causal=causal)
        for bq, bkv in tiles:
            got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
            again = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
            plan = fa.flash_attention.last_launch
            if plan != fa.launch_config(BATCH, h, kvh, s, d, bq, bkv, sms) or \
                    plan["variant"] != "fma":
                fail(f"flash_attention ({bq}, {bkv}) on {(h, kvh, s, d)} launched "
                     f"{plan}, want fma")
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"flash_attention fma ({bq}, {bkv}) on {(h, kvh, s, d)}: two "
                     "runs differ")
            b_ms, b_by, _ = attention_bound(BATCH, h, kvh, s, d, causal)
            report("flash_attention",
                   f"fma (1,{h},{s},{d}) kvh {kvh} {'causal' if causal else 'full'} "
                   f"blocks ({bq}, {bkv}) grid {plan['grid']}, twice the same bits, "
                   f"bound {b_ms:.4f} ms ({b_by})",
                   got, want, TOL_ATTN,
                   median_ms(lambda: fa.flash_attention(
                       q, k, v, causal=causal, block_q=bq, block_kv=bkv)),
                   median_ms(lambda: ref.flash_attention(q, k, v, causal=causal)),
                   median_ms(lambda: sdpa(q, k, v, causal)))
    k3_variants = {k: n - k3_before[k] for k, n in read_variants("flash_attention").items()}
    print(f"[kernels] flash_attention launches by variant in phase 3: {k3_variants}")
    if min(k3_variants.values()) <= 0:
        fail(f"flash_attention variants launched in phase 3: {k3_variants}")

    # K4: the attention softmax rows of one kv chunk (M = B·H·S, N = chunk),
    # at row blocks that divide 2304 = 2^8·3^2 and are not powers of two, on
    # the registers variant (288 rows: no shared memory to limit the block);
    # then the shared-memory variant at N = 258 (not a multiple of 4)
    from repro_torch.kernels import ScheduleRejected
    from repro_torch.kernels import softmax as sm

    errs["row_softmax"] = 0.0
    M, N = BATCH * H * SEQ, SEQ
    x = randn(M, N) * 4.0
    x_shared = randn(M // 8, N + 2) * 4.0
    for dtype, tol in ((torch.float32, TOL_SOFTMAX_F32),
                       (torch.bfloat16, TOL_SOFTMAX_BF16)):
        for xx, bms in ((x.to(dtype), (36, 72, 144, 288)),
                        (x_shared.to(dtype), (12, 48))):
            want = ref.row_softmax(xx)
            for bm in bms:
                cfg = sm.launch_config(*xx.shape, bm)
                got = sm.row_softmax(xx, block_rows=bm)
                if sm.row_softmax.last_launch != cfg:
                    fail(f"row_softmax launched {sm.row_softmax.last_launch}, want {cfg}")
                report("row_softmax",
                       f"{cfg['variant']} {tuple(xx.shape)} {str(dtype)[6:]} "
                       f"block_rows {bm} threads {cfg['threads']} smem {cfg['smem_bytes']}",
                       got, want, tol,
                       median_ms(lambda: sm.row_softmax(xx, block_rows=bm)),
                       median_ms(lambda: ref.row_softmax(xx)),
                       median_ms(lambda: torch.softmax(xx, -1)))
    for xx, bm, reason in ((x, 100, "divide"), (randn(M, N + 2), 288, "shared_memory")):
        try:
            sm.row_softmax(xx, block_rows=bm)
        except ScheduleRejected as e:
            print(f"[kernels] row_softmax block_rows {bm} at N={xx.shape[1]}: "
                  f"rejected ({e.reason})")
            if e.reason != reason:
                fail(f"row_softmax {bm} at N={xx.shape[1]} rejected for {e.reason}, "
                     f"not {reason}")
        else:
            fail(f"row_softmax block_rows {bm} at N={xx.shape[1]} was not rejected")
    return errs


def attention_work(b, h, kvh, s, d, causal: bool = True, window: int = 0):
    """(flops, bytes) of one K3 call: q·k and p·v over the unmasked pairs
    of each head, s(s+1)/2 causal and s² not, and with a causal window of
    w < s keys w(w+1)/2 + (s - w)·w; q, k and v read once, o written
    once."""
    if causal and 0 < window < s:
        pairs = window * (window + 1) // 2 + (s - window) * window
    else:
        pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * h * d * pairs, 4 * (2 * b * h * s * d + 2 * b * kvh * s * d)


def attention_bound(b, h, kvh, s, d, causal: bool = True, window: int = 0):
    """(bound ms, by, bound ms at 67 TFLOP/s) of one K3 call: its products
    at the card's best f32-accurate rate (3xTF32), whatever variant
    launched."""
    flops, nbytes = attention_work(b, h, kvh, s, d, causal, window)
    b_ms, b_by = bound(flops, nbytes, PEAK_3XTF32_FLOPS)
    return b_ms, b_by, bound(flops, nbytes)[0]


def phase_attention_tiles(gen, errs: dict) -> dict:
    """Phase 3d: K3 at smollm-135m's forward shape (causal) at every tile
    that the tc variant takes, each held against the plain version within
    TOL_ATTN, its device time by graph replay beside SDPA's."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, sm_count

    H, KVH, D = 9, 3, 64
    q = torch.randn(BATCH, H, SEQ, D, generator=gen, device="cuda")
    k = torch.randn(BATCH, KVH, SEQ, D, generator=gen, device="cuda")
    v = torch.randn(BATCH, KVH, SEQ, D, generator=gen, device="cuda")
    want = ref.flash_attention(q, k, v)
    divisors = [t for t in range(1, SEQ + 1) if SEQ % t == 0]
    tiles = {}
    for bq in divisors:
        for bkv in divisors:
            plan = fa.launch_config(BATCH, H, KVH, SEQ, D, bq, bkv, sm_count("cuda"))
            if plan["variant"] != "tc":
                continue
            got = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["flash_attention"] = max(errs["flash_attention"], err)
            if not math.isfinite(err) or err > TOL_ATTN or \
                    fa.flash_attention.last_launch != plan:
                fail(f"flash_attention tc ({bq}, {bkv}): max_abs_err {err}, "
                     f"launched {fa.flash_attention.last_launch}")
            tiles[f"{bq},{bkv}"] = ms = graph_ms(
                lambda: fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv))
            print(f"[time] flash_attention tc ({BATCH},{H},{SEQ},{D}) kvh {KVH} causal "
                  f"({bq}, {bkv}): device {ms:.4f} ms, grid {plan['grid']} threads "
                  f"{plan['threads']} splits {plan['splits']} ({plan['tiles']} runs x "
                  f"{plan['sub']} parts) stages {plan['stages']}; max_abs_err {err:.3e} "
                  f"(tol {TOL_ATTN:g})")
    sdpa_ms = graph_ms(lambda: sdpa(q, k, v, True))
    b_ms, b_by, b67 = attention_bound(BATCH, H, KVH, SEQ, D)
    best = min(tiles, key=tiles.get)
    print(f"[time] flash_attention tc at {len(tiles)} tiles: {min(tiles.values()):.4f}-"
          f"{max(tiles.values()):.4f} ms (fastest ({best})); sdpa device {sdpa_ms:.4f} ms; "
          f"bound {b_ms:.5f} ms ({b_by}; {b67:.5f} ms at 67 TFLOP/s)")
    return dict(tile_device_ms=tiles, sdpa_device_ms=sdpa_ms, bound_ms=b_ms,
                bound_by=b_by, bound_f32_ms=b67)


def decode_bias(lengths, T, window: int = 0):
    """(B, T) additive decode mask: 0 where position < length (and inside
    the window), -1e30 elsewhere."""
    import torch

    pos = torch.arange(T, device="cuda")[None, :]
    lv = torch.tensor(lengths, device="cuda")[:, None]
    ok = pos < lv
    if window:
        ok &= pos > lv - 1 - window
    return torch.where(ok, 0.0, -1e30).float()


def gathered(pool, table):
    """A page pool gathered through a page table into the contiguous
    (B, KVH, P·ps, D) view (sentinels clamped), as K6's yardstick."""
    import torch

    n_pages, kvh, ps, d = pool.shape
    B, P = table.shape
    idx = torch.clamp(table.long(), max=n_pages - 1)
    return pool[idx].permute(0, 2, 1, 3, 4).reshape(B, kvh, P * ps, d).contiguous()


def sdpa_decode(q4, k, v, bias):
    """The library call that computes K5's function (a yardstick only):
    q (B, H, 1, D) against the cache, the bias as an additive mask."""
    import torch.nn.functional as F

    B, KVH, G, D = q4.shape
    return F.scaled_dot_product_attention(
        q4.reshape(B, KVH * G, 1, D), k, v, attn_mask=bias[:, None, None, :],
        enable_gqa=True,
    )


def phase_decode_kernels(gen, errs: dict) -> dict:
    """Phase 3b: K5 and K6 against their plain versions; returns K5's
    device ms at every kv tile that divides the serving cache, and SDPA's,
    with every slot full."""
    import torch

    from repro_torch.kernels import ScheduleRejected
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, KVH, G, D = SERVE_SLOTS, 3, 3, 64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def report(kernel, label, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        print(f"[decode] {kernel} {label}: max_abs_err {err:.3e} (tol {TOL_ATTN:g})")
        if not math.isfinite(err) or err > TOL_ATTN:
            fail(f"{kernel} {label}: max_abs_err {err} > {TOL_ATTN}")

    q = randn(B, KVH, G, D)
    # tiles 8 and 16 split the kv axis finely: a length-1 slot, and the
    # window, leave whole splits masked
    for T, tiles in ((SERVE_MAX_SEQ, (8, 16, 64, 256)), (192, (16, 48, 96))):
        k, v = randn(B, KVH, T, D), randn(B, KVH, T, D)
        cases = [("full", None, decode_bias([T] * B, T)),
                 ("ragged", None, decode_bias([T, 1, 77, T - 5], T)),
                 ("ragged softcap=50", 50.0, decode_bias([T, 33, 2, 150], T)),
                 ("ragged window=64", None, decode_bias([T, 100, 64, 9], T, 64))]
        for bkv in tiles:
            for label, cap, bias in cases:
                got = fa.decode_flash_attention(q, k, v, bias, softcap=cap,
                                                block_kv=bkv)
                plan = fa.decode_flash_attention.last_launch
                if plan["blocks"] != (bkv,):
                    fail(f"decode_flash_attention launched {plan['blocks']}, asked ({bkv},)")
                want = ref.decode_attention(q, k, v, bias, softcap=cap)
                report("decode_flash_attention",
                       f"({B},{KVH},{G},{T},{D}) block_kv {bkv}, {plan['splits']} "
                       f"splits of {plan['rows_per_split']} rows, {label}", got, want)
        bias = decode_bias([T, 1, 77, 9], T)
        same = replay_twice(lambda: (fa.decode_flash_attention(q, k, v, bias,
                                                               block_kv=16),))
        print(f"[decode] decode_flash_attention T {T} block_kv 16, replayed twice "
              f"from one CUDA graph: {'the same bits' if same else 'DIFFERENT bits'}")
        if not same:
            fail("decode_flash_attention: a graph replay differs from the eager call")
    # olmoe-1b-7b's decode tick: 16 kv heads of one query head, D 128
    T = SERVE_MAX_SEQ
    q128 = randn(B, 16, 1, 128)
    k128, v128 = randn(B, 16, T, 128), randn(B, 16, T, 128)
    for bkv in (16, 64, 128):
        for label, bias in (("full", decode_bias([T] * B, T)),
                            ("ragged", decode_bias([T, 1, 77, T - 5], T))):
            got = fa.decode_flash_attention(q128, k128, v128, bias, block_kv=bkv)
            again = fa.decode_flash_attention(q128, k128, v128, bias, block_kv=bkv)
            plan = fa.decode_flash_attention.last_launch
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"decode_flash_attention D 128 block_kv {bkv}: two runs differ")
            report("decode_flash_attention",
                   f"({B},16,1,{T},128) block_kv {bkv}, {plan['splits']} splits of "
                   f"{plan['rows_per_split']} rows, {label}", got,
                   ref.decode_attention(q128, k128, v128, bias))
    # whisper-medium's cross-attention over the 1500 encoder frames (16 kv
    # heads of one query head, D 64; a tile above 375 rows overflows shared
    # memory), qwen2-vl-2b's tick (2 kv heads of 6 query heads, D 128),
    # stablelm-3b's (32 kv heads of one query head, D 80) and qwen1.5-110b's
    # (8 kv heads of 8 query heads, D 128: 32 (slot, kv head) pairs want 5
    # splits on 132 SMs, and at tiles 64 and 128 a split is part of one
    # tile); each shape's last tile timed beside SDPA and the bound
    for (kvh, g, T, d), tiles in (((16, 1, ENC_FRAMES, 64), (50, 125, 300, 375)),
                                  ((2, 6, SERVE_MAX_SEQ, 128), (16, 64, 128)),
                                  ((32, 1, SERVE_MAX_SEQ, 80), (16, 64, 128)),
                                  ((8, 8, SERVE_MAX_SEQ, 128), (16, 32, 64, 128))):
        qx = randn(B, kvh, g, d)
        kx, vx = randn(B, kvh, T, d), randn(B, kvh, T, d)
        for bkv in tiles:
            for label, bias in (("full", decode_bias([T] * B, T)),
                                ("ragged", decode_bias([T, 1, 77, T - 5], T))):
                got = fa.decode_flash_attention(qx, kx, vx, bias, block_kv=bkv)
                again = fa.decode_flash_attention(qx, kx, vx, bias, block_kv=bkv)
                plan = fa.decode_flash_attention.last_launch
                torch.cuda.synchronize()
                if plan["blocks"] != (bkv,) or not torch.equal(got, again):
                    fail(f"decode_flash_attention ({B},{kvh},{g},{T},{d}) block_kv "
                         f"{bkv}: launched {plan['blocks']}, or two runs differ")
                report("decode_flash_attention",
                       f"({B},{kvh},{g},{T},{d}) block_kv {bkv}, {plan['splits']} "
                       f"splits of {plan['rows_per_split']} rows, {label}, twice the "
                       "same bits", got, ref.decode_attention(qx, kx, vx, bias))
        bias = decode_bias([T] * B, T)
        k_ms = graph_ms(lambda: fa.decode_flash_attention(qx, kx, vx, bias, block_kv=bkv))
        l_ms = graph_ms(lambda: sdpa_decode(qx, kx, vx, bias))
        b_ms, b_by = bound(*decode_work(B, kvh, g, T, d))
        print(f"[time] decode_flash_attention ({B},{kvh},{g},{T},{d}) block_kv {bkv}: "
              f"device {k_ms:.4f} ms, sdpa device {l_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
    # at qwen1.5-110b's G 8, D 128 a kv tile of 256 needs 279,648 bytes of
    # shared memory: refused before any launch
    before = fa.decode_flash_attention.launches
    try:
        fa.decode_flash_attention(qx, kx, vx, bias, block_kv=T)
    except ScheduleRejected as e:
        print(f"[decode] decode_flash_attention ({B},{kvh},{g},{T},{d}) block_kv {T}: "
              f"rejected ({e.reason}): {e}")
        if e.reason != "shared_memory" or fa.decode_flash_attention.launches != before:
            fail(f"decode_flash_attention block_kv {T} at G {g}, D {d}: rejected for "
                 f"{e.reason}, launches {fa.decode_flash_attention.launches - before}")
    else:
        fail(f"decode_flash_attention block_kv {T} at G {g}, D {d} was not refused")
    # K6: pages scattered over a pool, sentinel entries, ragged lengths
    P = SERVE_MAX_SEQ // SERVE_PAGE
    n_pages = B * P + 3
    kp, vp = randn(n_pages, KVH, SERVE_PAGE, D), randn(n_pages, KVH, SERVE_PAGE, D)
    table = torch.randperm(n_pages - 1, generator=gen, device="cuda")[: B * P]
    table = table.reshape(B, P).to(torch.int32)
    table[1, 10:] = n_pages
    table[3, 1:] = n_pages
    T = P * SERVE_PAGE
    for label, cap, bias in (
        ("sentinels ragged", None, decode_bias([T, 10 * SERVE_PAGE - 3, 77, 16], T)),
        ("sentinels ragged softcap=50", 50.0, decode_bias([T, 150, 1, 5], T)),
    ):
        got = fa.paged_decode_flash_attention(q, kp, vp, table, bias, softcap=cap)
        want = fa.decode_flash_attention(q, gathered(kp, table), gathered(vp, table),
                                         bias, softcap=cap, block_kv=SERVE_PAGE)
        report("paged_decode_flash_attention",
               f"pools {tuple(kp.shape)} table {tuple(table.shape)} {label} vs K5",
               got, want)
        report("paged_decode_flash_attention", f"{label} vs plain", got,
               ref.paged_decode_attention(q, kp, vp, table, bias, softcap=cap))
    same = replay_twice(lambda: (fa.paged_decode_flash_attention(q, kp, vp, table,
                                                                 bias),))
    splits = fa.paged_decode_flash_attention.last_launch["splits"]
    print(f"[decode] paged_decode_flash_attention, {splits} splits, replayed twice "
          f"from one CUDA graph: {'the same bits' if same else 'DIFFERENT bits'}")
    if not same:
        fail("paged_decode_flash_attention: a graph replay differs from the eager call")
    T = SERVE_MAX_SEQ
    k, v = randn(B, KVH, T, D), randn(B, KVH, T, D)
    bias = decode_bias([T] * B, T)
    tiles = {}
    for bkv in [t for t in range(1, T + 1) if T % t == 0]:
        tiles[bkv] = graph_ms(lambda: fa.decode_flash_attention(q, k, v, bias,
                                                                block_kv=bkv))
        plan = fa.decode_flash_attention.last_launch
        print(f"[time] decode_flash_attention ({B},{KVH},{G},{T},{D}) block_kv {bkv}: "
              f"device {tiles[bkv]:.4f} ms ({plan['splits']} splits of "
              f"{plan['rows_per_split']} rows, grid {plan['grid']})")
    sdpa_ms = graph_ms(lambda: sdpa_decode(q, k, v, bias))
    print(f"[time] decode sdpa ({B},{KVH},{G},{T},{D}): device {sdpa_ms:.4f} ms")
    return dict(block_kv_device_ms=tiles, sdpa_device_ms=sdpa_ms)


def phase_arctic_kernels(gen, errs: dict) -> dict:
    """Phase 3f: the kernels at arctic-480b's shapes (``ARCTIC_ARCH``), each
    held against its plain version on the same inputs and timed by CUDA-graph
    replay beside its library call and its bound: K1 at the forward's m256
    products (q and o k7168 n7168, the dense residual MLP's k7168 n4864 and
    k4864 n7168, k and v n1024) on tc and at the tick's m4 products (k7168
    n7168, and the unembed over the 32000-wide table read k-contiguous) on
    splitk; K2 at the tick's expert products (b128 m4: wi and wg k7168
    n4864, wo k4864 n7168; 17.85 GB of f32 operand each) on splitk beside
    ``torch.bmm``; K3 at (1, 56, 256, 128) kvh 8 causal, G 7, at every tile
    the search can draw, each fma or refused for shared memory before any
    launch, beside SDPA with ``enable_gqa``; K5 at b4 kvh 8 G 7 t256 D 128 at
    every kv tile, full and ragged, each run twice for the same bits (tile
    256 refused for shared memory), beside SDPA.  Returns the rows by label:
    device ms, library device ms, bound ms (by) and its 67 TFLOP/s twin,
    max_abs_err."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ScheduleRejected
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref, sm_count

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cfg = get_config(ARCTIC_ARCH)
    rows = {}

    def row(kernel, label, got, want, tol, k_ms, lib_ms, b_ms, b_by, b67=None, **extra):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        rows[label] = dict(kernel=kernel, device_ms=k_ms, library_device_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b67,
                           max_abs_err=err, **extra)
        b67_s = "" if b67 is None else f" [{b67:.4f} at 67 TFLOP/s]"
        print(f"[arctic-kernels] {kernel} {label}: max_abs_err {err:.3e} (tol {tol:g}); "
              f"device {k_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}){b67_s}")
        if not math.isfinite(err) or err > tol:
            fail(f"{kernel} {label}: max_abs_err {err} > {tol}")

    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab
    for M, K, N, blocks, var, layout in (
        (M_FWD, D, D, (128, 64, 8), "tc", "n"),
        (M_FWD, D, F_, (128, 64, 8), "tc", "n"),
        (M_FWD, F_, D, (128, 64, 8), "tc", "n"),
        (M_FWD, D, 1024, (128, 32, 8), "tc", "n"),
        (SERVE_SLOTS, D, D, (4, 256, 128), "splitk", "n"),
        (SERVE_SLOTS, D, V, (4, 256, 64), "splitk", "k"),
    ):
        x = randn(M, K)
        w = randn(N, K).t() if layout == "k" else randn(K, N)
        got = mm.matmul(x, w, block_sizes=blocks)
        plan = mm.matmul.last_launch
        if plan != mm.launch_config(1, M, N, K, blocks) or plan["variant"] != var:
            fail(f"matmul {blocks} on {(M, N, K)} launched {plan}, want {var}")
        b_ms, b_by, b67 = mm_bound(M, N, K)
        row("matmul", f"m{M} k{K} n{N} w {layout}-contiguous {var} {blocks}", got,
            ref.matmul(x, w), TOL_MATMUL,
            graph_ms(lambda: mm.matmul(x, w, block_sizes=blocks)),
            graph_ms(lambda: torch.matmul(x, w)), b_ms, b_by, b67, blocks=list(blocks),
            variant=var)
        del x, w
    for K, N, blocks in ((D, F_, (4, 608, 32)), (F_, D, (4, 896, 32))):
        B = cfg.moe_experts
        a, b = randn(B, SERVE_SLOTS, K), randn(B, K, N)
        got = mm.batch_matmul(a, b, block_sizes=blocks)
        again = mm.batch_matmul(a, b, block_sizes=blocks)
        plan = mm.batch_matmul.last_launch
        torch.cuda.synchronize()
        if plan != mm.launch_config(B, SERVE_SLOTS, N, K, blocks) or \
                plan["variant"] != "splitk" or not torch.equal(got, again):
            fail(f"batch_matmul {blocks} at b{B} m4 k{K} n{N}: launched {plan}, or two "
                 "runs differ")
        b_ms, b_by, b67 = mm_bound(SERVE_SLOTS, N, K, B)
        row("batch_matmul", f"b{B} m{SERVE_SLOTS} k{K} n{N} splitk {blocks} (splits "
            f"{plan['splits']}), twice the same bits", got, ref.batch_matmul(a, b),
            TOL_MATMUL, graph_ms(lambda: mm.batch_matmul(a, b, block_sizes=blocks)),
            graph_ms(lambda: torch.bmm(a, b)), b_ms, b_by, b67, blocks=list(blocks),
            variant="splitk")
        del a, b, got, again
        torch.cuda.empty_cache()
    # K3 at every tile: fma (D 128 is no tc head dim) or refused for shared
    # memory before any launch
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = randn(BATCH, h, SEQ, hd)
    k, v = randn(BATCH, kvh, SEQ, hd), randn(BATCH, kvh, SEQ, hd)
    want = ref.flash_attention(q, k, v)
    divisors = [t for t in range(1, SEQ + 1) if SEQ % t == 0]
    tiles, refused, sms = {}, [], sm_count("cuda")
    for bq in divisors:
        for bkv in divisors:
            before = fa.flash_attention.launches
            try:
                plan = fa.launch_config(BATCH, h, kvh, SEQ, hd, bq, bkv, sms)
            except ScheduleRejected as e:
                try:
                    fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
                except ScheduleRejected as e2:
                    if e.reason != "shared_memory" or e2.reason != e.reason or \
                            fa.flash_attention.launches != before:
                        fail(f"flash_attention ({bq}, {bkv}) at G 7: refused for "
                             f"{e2.reason}, launches {fa.flash_attention.launches - before}")
                    refused.append((bq, bkv))
                    continue
                fail(f"flash_attention ({bq}, {bkv}) at G 7 was not refused")
            got = fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs["flash_attention"] = max(errs["flash_attention"], err)
            if plan["variant"] != "fma" or fa.flash_attention.last_launch != plan or \
                    not math.isfinite(err) or err > TOL_ATTN:
                fail(f"flash_attention ({bq}, {bkv}) at G 7: launched "
                     f"{fa.flash_attention.last_launch}, max_abs_err {err}")
            tiles[(bq, bkv)] = (graph_ms(lambda: fa.flash_attention(
                q, k, v, block_q=bq, block_kv=bkv)), err)
    best = min(tiles, key=lambda t: tiles[t][0])
    bq, bkv = best
    b_ms, b_by, b67 = attention_bound(BATCH, h, kvh, SEQ, hd)
    print(f"[arctic-kernels] flash_attention (1,{h},{SEQ},{hd}) kvh {kvh} causal: "
          f"{len(tiles)} tiles fma, {min(t[0] for t in tiles.values()):.4f}-"
          f"{max(t[0] for t in tiles.values()):.4f} ms; {len(refused)} refused for "
          f"shared memory before any launch: {refused}")
    row("flash_attention", f"(1,{h},{SEQ},{hd}) kvh {kvh} causal fma {best}, the "
        f"fastest of {len(tiles)} tiles", fa.flash_attention(q, k, v, block_q=bq,
                                                             block_kv=bkv), want,
        TOL_ATTN, tiles[best][0], graph_ms(lambda: sdpa(q, k, v, True)), b_ms, b_by, b67,
        blocks=list(best), variant="fma",
        tile_device_ms={f"{a},{b}": t[0] for (a, b), t in tiles.items()},
        refused=[list(t) for t in refused])
    del q, k, v, want
    # K5 at the tick: 4 slots, 8 kv heads of 7 query heads
    g, T = h // kvh, SERVE_MAX_SEQ
    qx = randn(SERVE_SLOTS, kvh, g, hd)
    kx, vx = randn(SERVE_SLOTS, kvh, T, hd), randn(SERVE_SLOTS, kvh, T, hd)
    full = decode_bias([T] * SERVE_SLOTS, T)
    ragged = decode_bias([T, 1, 77, T - 5], T)
    k5 = {}
    for bkv in divisors:
        before = fa.decode_flash_attention.launches
        try:
            got = fa.decode_flash_attention(qx, kx, vx, full, block_kv=bkv)
        except ScheduleRejected as e:
            if e.reason != "shared_memory" or fa.decode_flash_attention.launches != before:
                fail(f"decode_flash_attention block_kv {bkv} at G 7: refused for "
                     f"{e.reason}")
            print(f"[arctic-kernels] decode_flash_attention block_kv {bkv} at G 7: "
                  f"refused ({e.reason}) before any launch")
            continue
        plan = fa.decode_flash_attention.last_launch
        for label, bias in (("full", full), ("ragged", ragged)):
            got = fa.decode_flash_attention(qx, kx, vx, bias, block_kv=bkv)
            again = fa.decode_flash_attention(qx, kx, vx, bias, block_kv=bkv)
            torch.cuda.synchronize()
            err = float((got - ref.decode_attention(qx, kx, vx, bias)).abs().max())
            errs["decode_flash_attention"] = max(errs.get("decode_flash_attention", 0.0),
                                                 err)
            if not torch.equal(got, again) or not math.isfinite(err) or err > TOL_ATTN:
                fail(f"decode_flash_attention block_kv {bkv} at G 7 {label}: "
                     f"max_abs_err {err}, or two runs differ")
        k5[bkv] = graph_ms(lambda: fa.decode_flash_attention(qx, kx, vx, full,
                                                             block_kv=bkv))
        print(f"[arctic-kernels] decode_flash_attention ({SERVE_SLOTS},{kvh},{g},{T},{hd}) "
              f"block_kv {bkv}: {plan['splits']} splits of {plan['rows_per_split']} rows, "
              f"device {k5[bkv]:.4f} ms; full and ragged within {TOL_ATTN:g}, twice the "
              "same bits")
    bkv = min(k5, key=k5.get)
    b_ms, b_by = bound(*decode_work(SERVE_SLOTS, kvh, g, T, hd))
    row("decode_flash_attention", f"b{SERVE_SLOTS} kvh{kvh} G{g} t{T} D{hd} ({bkv},), the "
        f"fastest of {len(k5)} tiles", fa.decode_flash_attention(qx, kx, vx, full,
                                                                 block_kv=bkv),
        ref.decode_attention(qx, kx, vx, full), TOL_ATTN, k5[bkv],
        graph_ms(lambda: sdpa_decode(qx, kx, vx, full)), b_ms, b_by, blocks=[bkv],
        tile_device_ms={str(t): ms for t, ms in k5.items()})
    return rows


def phase_gemma_kernels(errs: dict) -> dict:
    """Phase 3e: K3 and K5 at gemma2-2b's shapes against their plain
    versions in float32, each run twice for the same bits (K5 also replayed
    twice from one CUDA graph); the tiles over the shared-memory cap
    refused by ``ScheduleRejected`` before any launch, through the check
    the lowering makes (``check_tile``, ``check_decode_tile``); each
    kernel's device time by graph replay beside its plain version, its
    bound and SDPA's at the same shape without the softcap (as such).  The
    inputs are ``flex_inputs``': SDPA takes no softcap, so the library
    call is the compiled ``flex_attention``, timed on the same inputs by
    the flex process and added to the rows later (``add_flex_times``).
    Returns the timing rows."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ScheduleRejected
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, sm_count

    cfg = get_config(GEMMA_ARCH)
    H, KVH, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, GEMMA_SEQ
    G, W, CAP = H // KVH, cfg.local_window, cfg.attn_softcap
    sms = sm_count("cuda")

    def check(kernel, label, got, again, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        same = torch.equal(got, again)
        print(f"[gemma-kernels] {kernel} {label}: max_abs_err {err:.3e} (tol "
              f"{TOL_ATTN:g}); two runs {'the same bits' if same else 'DIFFER'}")
        if not math.isfinite(err) or err > TOL_ATTN or not same:
            fail(f"{kernel} {label}: max_abs_err {err} > {TOL_ATTN}, or two runs differ")

    def refused(kernel, label, call, wrapper):
        n = wrapper.launches
        try:
            call()
        except ScheduleRejected as e:
            print(f"[gemma-kernels] {kernel} {label}: rejected ({e.reason}) before any "
                  f"launch: {e}")
            if e.reason != "shared_memory" or wrapper.launches != n:
                fail(f"{kernel} {label}: rejected for {e.reason}, launches {n} -> "
                     f"{wrapper.launches}")
        else:
            fail(f"{kernel} {label} was not rejected")

    rows = {}
    # K3: (1, 8, 4608, 256) kvh 4 causal softcap 50, with the local layers'
    # 4096-token window and global, on fma at a tile the search can pick
    q, k, v, _ = flex_inputs((BATCH, H, S, D), (BATCH, KVH, S, D), None, 0)
    bq, bkv = GEMMA_K3_TILE
    for window in (W, 0):
        # window None is global, in the kernel and its plain version alike
        kw = dict(causal=True, window=window or None, softcap=CAP)

        def launch():
            return fa.flash_attention(q, k, v, block_q=bq, block_kv=bkv, **kw)

        got, again = launch(), launch()
        plan = fa.flash_attention.last_launch
        if plan != fa.launch_config(BATCH, H, KVH, S, D, bq, bkv, sms) or \
                plan["variant"] != "fma":
            fail(f"flash_attention {GEMMA_K3_TILE} at D {D} launched {plan}, want fma")
        label = (f"fma ({BATCH},{H},{S},{D}) kvh {KVH} causal softcap={CAP:g} "
                 f"window={window} blocks {GEMMA_K3_TILE} grid {plan['grid']} smem "
                 f"{plan['smem_bytes']} B")
        check("flash_attention", label, got, again, ref.flash_attention(q, k, v, **kw))
        del got, again
        d_ms = graph_ms(launch)
        p_ms = median_ms(lambda: ref.flash_attention(q, k, v, **kw), reps=5, warmup=1)
        sdpa_ms = graph_ms(lambda: sdpa(q, k, v, True))
        flops = attention_work(BATCH, H, KVH, S, D, True, window)[0]
        b_ms, b_by, b67 = attention_bound(BATCH, H, KVH, S, D, True, window)
        key = f"gemma2 K3 window={window}"
        rows[key] = dict(kernel="flash_attention", variant="fma", blocks=list(GEMMA_K3_TILE),
                         ms=d_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=None,
                         library_device_ms=None, sdpa_no_softcap_device_ms=sdpa_ms,
                         bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b67, flops=flops,
                         weight=0, flex=((BATCH, H, S, D), (BATCH, KVH, S, D), window))
        print(f"[time] {key} {label}: device {d_ms:.4f} ms plain {p_ms:.4f} ms (sdpa "
              f"without the softcap, causal, no window: device {sdpa_ms:.4f} ms) bound "
              f"{b_ms:.4f} ms ({b_by}, {b67:.4f} ms at 67 TFLOP/s)")
    over = GEMMA_K3_OVER_CAP
    refused("flash_attention", f"{over} at D {D} ({fa.smem_bytes(*over, D)} B)",
            lambda: fa.check_tile(BATCH, H, KVH, S, D, *over), fa.flash_attention)
    refused("flash_attention", f"{over} at D {D}, through the wrapper",
            lambda: fa.flash_attention(q, k, v, softcap=CAP, block_q=over[0],
                                       block_kv=over[1]), fa.flash_attention)
    del q, k, v

    # K5: gemma2-2b's tick (b4, kvh 4, G 2, t 256, D 256, softcap 50), and
    # over a 4608-position cache with the 4096 window and ragged lengths
    B = SERVE_SLOTS
    for T, tiles, cases in (
        (SERVE_MAX_SEQ, (16, GEMMA_K5_TILE),
         (("full", 0, [SERVE_MAX_SEQ] * B), ("ragged", 0, [SERVE_MAX_SEQ, 1, 77, 250]))),
        (GEMMA_SEQ, (32, GEMMA_K5_TILE),
         (("full, window 4096", W, [GEMMA_SEQ] * B),
          ("ragged, window 4096", W, [GEMMA_SEQ, W + 3, 17, W - 1]))),
    ):
        q, k, v, _ = flex_inputs((B, KVH, G, D), (B, KVH, T, D), None, 0)
        for blk in tiles:
            for label, window, lengths in cases:
                bias = decode_bias(lengths, T, window)

                def launch():
                    return fa.decode_flash_attention(q, k, v, bias, softcap=CAP,
                                                     block_kv=blk)

                got, again = launch(), launch()
                plan = fa.decode_flash_attention.last_launch
                if plan != fa.decode_launch_config(B, KVH, G, T, D, blk, sms):
                    fail(f"decode_flash_attention block_kv {blk} at D {D} launched {plan}")
                check("decode_flash_attention",
                      f"({B},{KVH},{G},{T},{D}) softcap={CAP:g} block_kv {blk}, "
                      f"{plan['splits']} splits of {plan['rows_per_split']} rows, smem "
                      f"{plan['smem_bytes']} B, {label}", got, again,
                      ref.decode_attention(q, k, v, bias, softcap=CAP))
                if blk != GEMMA_K5_TILE or lengths[1] != lengths[0]:
                    continue
                d_ms = graph_ms(launch)
                p_ms = median_ms(lambda: ref.decode_attention(q, k, v, bias, softcap=CAP))
                sdpa_ms = graph_ms(lambda: sdpa_decode(q, k, v, bias))
                flops, nbytes = decode_work(B, KVH, G, T, D, attended=min(T, window or T))
                b_ms, b_by = bound(flops, nbytes)
                key = f"gemma2 K5 t{T}" + (f" window={window}" if window else "")
                rows[key] = dict(kernel="decode_flash_attention", blocks=[blk], ms=d_ms,
                                 device_ms=d_ms, plain_ms=p_ms, library_ms=None,
                                 library_device_ms=None, sdpa_no_softcap_device_ms=sdpa_ms,
                                 bound_ms=b_ms, bound_by=b_by, flops=flops, weight=0,
                                 splits=plan["splits"],
                                 flex=((B, KVH, G, D), (B, KVH, T, D), window))
                print(f"[time] {key} ({B},{KVH},{G},{T},{D}) block_kv {blk}, "
                      f"{plan['splits']} splits: device {d_ms:.4f} ms plain {p_ms:.4f} ms "
                      f"(sdpa without the softcap: device {sdpa_ms:.4f} ms) bound "
                      f"{b_ms:.4f} ms ({b_by})")
        bias = decode_bias(cases[-1][2], T, cases[-1][1])
        same = replay_twice(lambda: (fa.decode_flash_attention(
            q, k, v, bias, softcap=CAP, block_kv=GEMMA_K5_TILE),))
        print(f"[gemma-kernels] decode_flash_attention T {T} D {D} block_kv "
              f"{GEMMA_K5_TILE}, replayed twice from one CUDA graph: "
              f"{'the same bits' if same else 'DIFFERENT bits'}")
        if not same:
            fail("decode_flash_attention at D 256: a graph replay differs from the eager call")
        over = GEMMA_K5_OVER_CAP
        refused("decode_flash_attention",
                f"block_kv {over} at G {G}, D {D}, T {T} "
                f"({fa.decode_smem_bytes(G, over, D)} B)",
                lambda: fa.check_decode_tile(G, T, D, over), fa.decode_flash_attention)
        refused("decode_flash_attention", f"block_kv {over} at T {T}, through the wrapper",
                lambda: fa.decode_flash_attention(q, k, v, bias, softcap=CAP,
                                                  block_kv=over), fa.decode_flash_attention)
    return rows


def ssd_work(b, S, H, P, N, L, state_out: bool = False, elem_bytes: int = 2):
    """(C·Bᵀ flops, other flops, bytes) of one K7 call, the work the
    function needs on these inputs: C·Bᵀ once per (batch, chunk) (B and C
    are shared by the heads) over the L(L+1)/2 pairs the causal mask keeps;
    per (batch, head) and chunk, scores·x over the same pairs, the state's
    Bᵀx over all L rows for every chunk but the last (whose state is read
    only when asked for) and C·h over all L rows for every chunk but the
    first (the state before it is zero); x, log_a, B and C read once, y
    written once (and the f32 state, when asked for).  x, B, C and y of
    ``elem_bytes``."""
    pairs, nc = L * (L + 1) // 2, S // L
    state = 2 * L * N * P
    per_head = nc * 2 * pairs * P + (nc - 1) * 2 * state + (state if state_out else 0)
    nbytes = elem_bytes * (2 * b * S * H * P + 2 * b * S * N) + 4 * b * S * H
    if state_out:
        nbytes += 4 * b * H * N * P
    return b * nc * 2 * pairs * N, b * H * per_head, nbytes


def ssd_bound(b, S, H, P, N, L, elem_bytes: int = 2, state_out: bool = False):
    """(bound ms, by, bound ms at the 3xTF32 rate, bound ms at 67 TFLOP/s,
    flops, bytes) of one K7 call: each product at the rate of its operand
    types.  In bf16, C·Bᵀ (two bf16 operands) runs at the bf16 rate and the
    other three (an f32 operand against a bf16 one) at half the TF32 rate;
    in f32 all four at the 3xTF32 rate."""
    cb, rest, nbytes = ssd_work(b, S, H, P, N, L, state_out=state_out,
                                elem_bytes=elem_bytes)
    flops = cb + rest
    if elem_bytes == 2:
        t_ops = cb / PEAK_BF16_FLOPS + rest / (PEAK_TF32_FLOPS / 2)
    else:
        t_ops = flops / PEAK_3XTF32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    b_ms, b_by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    return (b_ms, b_by, bound(flops, nbytes, PEAK_3XTF32_FLOPS)[0],
            bound(flops, nbytes)[0], flops, nbytes)


def traced_ms(fn, names, calls: int = 10) -> dict:
    """The mean device time of each kernel whose name holds one of
    ``names``, over ``calls`` calls of ``fn`` under ``torch.profiler``
    (None for a kernel that did not run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = {n: [] for n in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    spans[n].append((e.time_range.end - e.time_range.start) / 1e3)
    return {n: sum(v) / len(v) if v else None for n, v in spans.items()}


def replay_twice(fn) -> bool:
    """Whether ``fn``'s outputs (a tuple of tensors) from one eager call
    and from each of two replays of a CUDA graph that captured it are the
    same bits: the split-K counters and scratch of K5, K6 and K7 must come
    back ready for the next replay."""
    import torch

    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = fn()
    for _ in range(2):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            return False
    return True


def phase_ssd_kernel(gen, errs: dict) -> dict:
    """Phase 3c: K7 against its plain version; returns its timing row at
    mamba2-370m's forward shape (bf16 x/B/C, chunk 64, no state out)."""
    import torch

    from repro_torch.kernels import ScheduleRejected
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as ssd_k

    errs["ssd"] = 0.0

    def inputs(b, S, H, P, N, decay=0.3):
        x = torch.randn(b, S, H, P, generator=gen, device="cuda")
        la = -torch.rand(b, S, H, generator=gen, device="cuda") * decay
        B = torch.randn(b, S, N, generator=gen, device="cuda") * 0.3
        C = torch.randn(b, S, N, generator=gen, device="cuda") * 0.3
        return x, la, B, C

    cases = (
        ("mamba2-370m forward", (1, 256, 32, 64, 128), 0.3),
        ("hymba-1.5b forward", (1, 256, 25, 64, 16), 0.3),
        ("17-token prompt", (1, 17, 32, 64, 128), 0.3),
        ("37-token prompt", (1, 37, 32, 64, 128), 0.3),
        ("hymba 37-token prompt", (1, 37, 25, 64, 16), 0.3),
        ("48-token prompt", (1, 48, 32, 64, 128), 0.3),
        ("decay 20/step: exp overflows above the diagonal", (1, 256, 32, 64, 128), 20.0),
    )
    for label, (b, S, H, P, N), decay in cases:
        x, la, B, C = inputs(b, S, H, P, N, decay)
        L = min(SSM_CHUNK, S)
        for dtype, tol in ((torch.float32, TOL_SSD_F32), (torch.bfloat16, TOL_SSD_BF16)):
            xx, BB, CC = x.to(dtype), B.to(dtype), C.to(dtype)
            want, want_h = ref.ssd_chunked(xx, la, BB, CC, chunk=L, return_state=True)
            got = ssd_k.ssd(xx, la, BB, CC, chunk=SSM_CHUNK)
            got2, h = ssd_k.ssd(xx, la, BB, CC, chunk=SSM_CHUNK, return_state=True)
            torch.cuda.synchronize()
            plan = ssd_k.ssd.last_launch
            if plan["blocks"] != (L,):
                fail(f"ssd launched {plan}, want chunk {L}")
            if dtype == torch.float32:
                print(f"[ssd] {label}: chunk grid {plan['grid']} (head group "
                      f"{plan['head_group']}), pass grid {plan['pass_grid']} (slice "
                      f"{plan['p_slice']}), {plan['kernels']} kernel(s)")
            err = float((got.float() - want.float()).abs().max())
            rel = err / float(want.float().abs().max())
            rel_h = float((h - want_h).abs().max() / want_h.abs().max())
            errs["ssd"] = max(errs["ssd"], err)
            print(f"[ssd] {label} ({b},{S},{H},{P}) N {N} chunk {L} {str(dtype)[6:]}: "
                  f"max_abs_err {err:.3e}, rel {rel:.3e} (tol {tol:g}); state rel "
                  f"{rel_h:.3e} (tol {TOL_SSD_F32:g})")
            finite = bool(torch.isfinite(got.float()).all() and torch.isfinite(h).all())
            if not finite or rel > tol or rel_h > TOL_SSD_F32 or not torch.equal(got, got2):
                fail(f"ssd {label} {dtype}: rel err {rel}, state {rel_h}, finite {finite}")
    # two replays of one CUDA graph give the eager call's bits: the scratch
    # between the two kernels is the graph's own
    for label, (b, S, H, P, N) in (("mamba2-370m forward", (1, 256, 32, 64, 128)),
                                   ("37-token prompt", (1, 37, 32, 64, 128))):
        x, la, B, C = inputs(b, S, H, P, N)
        x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
        same = replay_twice(lambda: ssd_k.ssd(x, la, B, C, chunk=SSM_CHUNK,
                                              return_state=True))
        print(f"[ssd] {label} bf16 with its state, replayed twice from one CUDA "
              f"graph: {'the same bits' if same else 'DIFFERENT bits'}")
        if not same:
            fail(f"ssd {label}: a graph replay differs from the eager call")
    for S, N, chunk, reason in ((80, 128, 64, "divide"), (256, 128, 256, "shared_memory")):
        x, la, B, C = inputs(1, S, 32, 64, N)
        try:
            ssd_k.ssd(x, la, B, C, chunk=chunk)
        except ScheduleRejected as e:
            print(f"[ssd] chunk {chunk} at S={S}, N={N}: rejected ({e.reason})")
            if e.reason != reason:
                fail(f"ssd chunk {chunk} at S={S} rejected for {e.reason}, not {reason}")
        else:
            fail(f"ssd chunk {chunk} at S={S}, N={N} was not rejected")

    # the main path's shape: mamba2-370m's forward, bf16 x/B/C, chunk 64
    row = ssd_timing(gen, "mamba2-370m forward", (1, 256, 32, 64, 128))
    if any(ms is None for ms in row["traced_ms"].values()):
        fail(f"ssd's kernels were not all traced at mamba2-370m's forward shape: "
             f"{row['traced_ms']}")
    if row["chunk_ctas"] < 128:
        fail(f"ssd's chunk kernel ran {row['chunk_ctas']} CTAs at mamba2-370m's "
             "forward shape")
    return row


def ssd_timing(gen, label: str, shape: tuple, f32: bool = False,
               state: bool = False) -> dict:
    """K7's timing row at ``shape`` (b, S, H, P, N), chunk 64: x, B and C
    in bf16 (or f32), the final state returned with ``state``; the kernel's
    host and device ms, its two kernels traced, the plain version's ms and
    the bound at the operand types' rates."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as ssd_k

    b, S, H, P, N = shape
    x = torch.randn(b, S, H, P, generator=gen, device="cuda")
    la = -torch.rand(b, S, H, generator=gen, device="cuda") * 0.3
    B = torch.randn(b, S, N, generator=gen, device="cuda") * 0.3
    C = torch.randn(b, S, N, generator=gen, device="cuda") * 0.3
    if not f32:
        x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()

    def launch():
        return ssd_k.ssd(x, la, B, C, chunk=SSM_CHUNK, return_state=state)

    k_ms = median_ms(launch)
    d_ms = graph_ms(launch)
    plan = ssd_k.ssd.last_launch
    p_ms = median_ms(lambda: ref.ssd_chunked(x, la, B, C, chunk=SSM_CHUNK,
                                             return_state=state))
    b_ms, b_by, b3x, b67, flops, nbytes = ssd_bound(
        b, S, H, P, N, SSM_CHUNK, elem_bytes=4 if f32 else 2, state_out=state)
    # a kernel the profiler saw no event of prints None (not measured): it
    # loses events over short windows (PERF.md §7)
    traced = traced_ms(launch, K7_KERNEL_NAMES)
    ctas = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
    print(f"[time] ssd {label} ({b},{S},{H},{P}) N {N} chunk {SSM_CHUNK} "
          f"{'f32' if f32 else 'bf16'}{' with its state' if state else ''}: kernel "
          f"{k_ms:.4f} ms (device {d_ms:.4f} ms, {plan['kernels']} kernel(s): {ctas} "
          f"chunk CTAs, pass grid {plan['pass_grid']}; traced "
          + ", ".join(f"{n} {ms if ms is None else round(ms, 4)} ms"
                      for n, ms in traced.items())
          + f") plain {p_ms:.4f} ms library - (no single PyTorch call computes the "
          f"SSD scan) bound {b_ms:.5f} ms ({b_by}; {b3x:.5f} ms at the 3xTF32 rate, "
          f"{b67:.5f} ms at 67 TFLOP/s; {flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB)")
    return dict(kernel="ssd", blocks=[SSM_CHUNK], shape=list(shape), f32=f32,
                state=state, ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, bound_3xtf32_ms=b3x, bound_f32_ms=b67,
                traced_ms=traced, chunk_ctas=ctas, flops=flops, weight=0)


# ---------------------------------------------------------------------------
# phases 4-5: the forward path
# ---------------------------------------------------------------------------

FORWARD_KERNELS = ("matmul", "batch_matmul", "flash_attention", "row_softmax")
KERNELS = FORWARD_KERNELS + ("decode_flash_attention", "paged_decode_flash_attention",
                             "ssd")
# the kernels that count their launches by variant
VARIANT_KERNELS = ("matmul", "batch_matmul", "flash_attention")
# workloads of the path with no hand-written kernel: the structural lowering
STRUCTURAL_OPS = ("rmsnorm",)
# the first call, in seconds, after which a structural candidate is not
# timed further (a ``timeout`` failure).  Such a candidate runs its loop
# tree as eager calls on the host, and a bad tile takes seconds a call
# where the best takes milliseconds.  Timed in full on an H100 (NVIDIA
# H100 80GB HBM3, 700.00 W; tools/tune_probe.py --structural-timeout 10),
# rmsnorm's best at 1500 tokens took 0.028 s a call and its other
# candidates 0.06-3.2 s and one over 10 s; the candidates of whisper's two
# rmsnorm tasks took 55.7 s of its forward's 96.8 s of tuning, and those of
# the train step's one 53.5 s of 84.7 s.  At 0.5 s the norm rounds still
# took 147 s of a 1066 s run, and every tuned norm's best took 1.8-27.2 ms
# a call (measured on one H100), so 0.2 s leaves each best 7x its time;
# one round a task measures its seeded first samples, the same each run
STRUCTURAL_TIMEOUT_S = 0.2


def _wrappers():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import softmax as sm
    from repro_torch.kernels import ssd as ssd_k

    return {"matmul": mm.matmul, "batch_matmul": mm.batch_matmul,
            "flash_attention": fa.flash_attention,
            "row_softmax": sm.row_softmax,
            "decode_flash_attention": fa.decode_flash_attention,
            "paged_decode_flash_attention": fa.paged_decode_flash_attention,
            "ssd": ssd_k.ssd}


def reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0
    for k in VARIANT_KERNELS:
        w = _wrappers()[k]
        w.launches_by_variant = dict.fromkeys(w.launches_by_variant, 0)


def read_counts() -> dict:
    return {k: w.launches for k, w in _wrappers().items()}


def read_variants(kernel: str = "matmul") -> dict:
    """K1's, K2's or K3's launches by variant so far (``splitk``, ``tc``,
    ``fma``; K3 ``tc``, ``fma``)."""
    return dict(_wrappers()[kernel].launches_by_variant)


def variants_since(before: dict, kernel: str = "matmul") -> dict:
    return {k: n - before.get(k, 0) for k, n in read_variants(kernel).items()}


# the hits by key of every DispatchContext a path runs under (each dict is
# the context's own, which it fills in place)
PATH_HITS = []


def path_context(db, **kwargs):
    """A ``DispatchContext`` whose hits by key count toward the kernels
    line's choice of each kernel's shape (``path_hits``)."""
    import repro_torch

    ctx = repro_torch.DispatchContext(db, **kwargs)
    PATH_HITS.append(ctx.hits_by_key)
    return ctx


def path_hits() -> Counter:
    """The dispatch hits by key over every path run so far."""
    hits = Counter()
    for by_key in PATH_HITS:
        hits.update(by_key)
    return hits


# the search every path tunes with: one round measures 8 candidates
TUNE_SEARCH = dict(max_trials=32, init_random=8, population=16, measure_per_round=8,
                   rollout_factor=2)


# the timing inputs of the tasks the last ``phase_tune`` timed through a
# local runner, by key, for ``check_tiles`` to replay the best records on
# (it empties the dict): drawing them again from numpy took tens of seconds
# at qwen1.5-110b's width (the decode unembed's table is 1.25e9 draws)
TUNED_INPUTS = {}


def plain_norm(cfg, tokens: int) -> tuple:
    """The key of ``cfg``'s norm over ``tokens`` rows, left plain
    (``phase_tune``'s ``plain_keys``)."""
    from repro_torch.search.database import workload_key

    return (workload_key("rmsnorm", d=cfg.d_model, eps=cfg.norm_eps, tokens=tokens),)


def phase_tune(cfg, db, extract=None, tag="tune", runner_spec="cached+local",
               plain_keys=(), cold_width: int = 0, unschedulable=None):
    """Extract (the forward's tasks unless ``extract`` is given) and tune the
    schedulable tasks through ``runner_spec`` (a spec or a built runner,
    which the caller closes) on the card, but those whose keys are in
    ``plain_keys`` (each must be extracted), which are printed and left
    plain as the unschedulable ones are; returns (tasks, best), the tasks
    tuned.  With ``cold_width``, each further search of a task left with
    no tile measures that many candidates a round (``COLD_WIDE``).  With
    ``unschedulable``, the keys that no schedule reaches must be exactly
    those."""
    import repro_torch
    from repro_torch.search.evolutionary import SearchConfig
    from repro_torch.search.measure.local import LocalRunner

    t0 = time.perf_counter()
    if extract is None:
        # every site the reference extracts, non-dispatchable ones included
        tasks = repro_torch.extract_tasks(cfg, batch=BATCH, seq=SEQ)
        keys = {t.key for t in tasks}
        if len(tasks) != 10 or f"sfm/m={BATCH * cfg.n_heads * SEQ}/n={SEQ}" not in keys:
            fail(f"forward extraction gave {sorted(keys)}; want the reference's 10 "
                 "tasks with the sfm site")
    else:
        tasks = extract()
    print(f"[{tag}] extracted {len(tasks)} tasks in {time.perf_counter() - t0:.1f} s")
    for t in tasks:
        print(f"[{tag}]   {t.key} weight {t.weight:g}")
    none = [t for t in tasks if not schedulable(t)]
    if unschedulable is not None and {t.key for t in none} != set(unschedulable):
        fail(f"[{tag}] keys with no schedule {sorted(t.key for t in none)}, want "
             f"{sorted(unschedulable)}")
    if none:
        # no search can find what the two caps leave out: these sites keep
        # the plain product under dispatch, as the reference's would
        tile, grid = schedule_caps()
        print(f"[{tag}] no schedule both the validator (a tile of at most {tile} "
              f"elements) and the lowering (a grid of at most {grid} steps) "
              f"accept, so not tuned: {[t.key for t in none]}")
        tasks = [t for t in tasks if schedulable(t)]
    if set(plain_keys) - {t.key for t in tasks}:
        fail(f"[{tag}] keys to leave plain that were not extracted: "
             f"{sorted(set(plain_keys) - {t.key for t in tasks})}")
    plain = [t.key for t in tasks if t.key in plain_keys]
    if plain:
        print(f"[{tag}] left plain, not tuned: {plain}")
        tasks = [t for t in tasks if t.key not in plain]
    search = SearchConfig(**TUNE_SEARCH)
    groups = [(tasks, runner_spec)]
    if runner_spec == "cached+local":
        # the structural tasks through a runner that times a candidate no
        # further once its first call passes STRUCTURAL_TIMEOUT_S
        slow = [t for t in tasks if t.key.split("/")[0] in STRUCTURAL_OPS]
        groups = [([t for t in tasks if t not in slow], runner_spec),
                  (slow, f"{runner_spec}://timeout_s={STRUCTURAL_TIMEOUT_S}")]
    best, searches = {}, []
    TUNED_INPUTS.clear()
    for group, spec in groups:
        if not group:
            continue
        config = repro_torch.TuneConfig(
            search=search, runner_spec=spec, backend="cuda",
            device="cuda", warm_start=False,
        )
        t0 = time.perf_counter()
        sched = repro_torch.TaskScheduler(group, database=db, config=config)
        best.update(sched.tune(total_rounds=ROUNDS_PER_TASK * len(group)))
        print(f"[{tag}] {sched.rounds_run} rounds in {time.perf_counter() - t0:.1f} s "
              f"through {spec if isinstance(spec, str) else type(spec).__name__}; "
              f"runner stats {sched.runner.stats()}")
        searches += sched.searches
        # a task whose space the card mostly rejects (smollm's unembed at
        # m1024 needs bm·bn·bk >= 110592 under the grid-steps cap; its
        # untuned tile has 1536·64) can go stale before one candidate runs;
        # it gets further searches with fresh seeds, each as long as the
        # scheduler grants a cold task, and each ended once every cold task
        # has a tile the card runs.  They measure through the group's
        # runner, whose timing inputs are drawn once (a runner of their own
        # would hold a second copy: 35.7 GB more for arctic-480b's two
        # b128 expert products)
        for seed in range(1, COLD_SEARCHES + 1):
            cold = [t for t in group if not math.isfinite(best[t.key])]
            if not cold:
                break
            print(f"[{tag}] no tile the card runs yet for {[t.key for t in cold]}: "
                  f"search seed {seed}")
            t0 = time.perf_counter()
            wide = dict(population=cold_width, init_random=cold_width,
                        measure_per_round=cold_width, generations=0, rollout_factor=1,
                        max_trials=cold_width * (config.patience + 1)) if cold_width else {}
            retry = repro_torch.TaskScheduler(cold, database=db, config=dataclasses.replace(
                config, runner_spec=sched.runner,
                search=dataclasses.replace(search, seed=seed, **wide)))
            for _ in range(config.patience + 1):
                best.update(retry.tune(total_rounds=len(cold)))
                if all(math.isfinite(best[t.key]) for t in cold):
                    break
            searches += retry.searches
            print(f"[{tag}] search seed {seed}: {retry.rounds_run} rounds in "
                  f"{time.perf_counter() - t0:.1f} s")
        local = getattr(sched.runner, "inner", None)
        if isinstance(local, LocalRunner):
            TUNED_INPUTS.update((t.key, local.inputs(t.func)) for t in group)
    for key, lat in best.items():
        if not math.isfinite(lat):
            fail(f"task {key} has no finite best latency")
    reasons = Counter(failure_reason(err) for search in searches
                      for _, err in search.errors)
    print(f"[{tag}] failed candidates by reason: {dict(reasons)}")
    others = [r for r in reasons if not r.startswith(EXPECTED_FAILURES)]
    if others:
        fail(f"candidates failed for reasons other than a rejection: {others}")
    return tasks, best


def schedule_caps():
    """(the validator's cap on a tile's elements, the lowering's cap on a
    grid's tile steps), the reference's caps."""
    from repro_torch.backends.gpu_backend import MAX_GRID_STEPS
    from repro_torch.core.validator import MAX_TILE_ELEMS

    return MAX_TILE_ELEMS, MAX_GRID_STEPS


def schedulable(task) -> bool:
    """Whether any schedule of a matrix-product task can reach the card: a
    tile holds at most ``MAX_TILE_ELEMS`` elements (bm·bn·bk) and a grid
    at most ``MAX_GRID_STEPS`` tiles, so a product of more multiply-adds
    (B·M·N·K) than the two caps' product has no schedule at all:
    qwen2-vl-2b's forward unembed, 256·151936·1536 > 2^17·2^18."""
    from repro_torch.search.database import parse_workload_key

    op, kw = parse_workload_key(task.key)
    if op not in ("dense", "batch_matmul"):
        return True
    tile, grid = schedule_caps()
    return kw.get("b", 1) * kw["m"] * kw["n"] * kw["k"] <= tile * grid


# what a candidate may fail with: a tile the card cannot run, a trace the
# validator refuses, or a first call over the runner's timeout
EXPECTED_FAILURES = ("rejected (", "invalid trace", "timeout")
# further searches for a task left with no tile the card runs
COLD_SEARCHES = 3


def failure_reason(err: str) -> str:
    """A candidate's error without its numbers: ``rejected (grid)``,
    ``invalid trace``, ``timeout``, or the whole error if it is none of
    these."""
    if err.startswith("rejected ("):
        return err.split(":", 1)[0]
    for kind in EXPECTED_FAILURES[1:]:
        if err.startswith(kind):
            return kind
    return err


def check_tiles(tasks, db) -> dict:
    """Replay each task's best record and check that the kernel launched
    with the record's snapped tile: variant, grid, threads and shared
    memory are the ones ``launch_config`` gives those blocks."""
    import torch

    from repro_torch.kernels import flash_attention as fa, sm_count
    from repro_torch.kernels import matmul as mm
    from repro_torch.search.measure.local import device_inputs
    from repro_torch.search.tune import apply_trace

    from repro_torch.kernels import softmax as sm

    runs = {}
    for t in tasks:
        rec = db.best(t.key)
        meta = rec.meta
        if t.key.split("/")[0] in STRUCTURAL_OPS:
            # no kernel: the best record went through the structural lowering
            print(f"[tiles] {t.key}: {meta}; best {rec.latency_s * 1e3:.4f} ms")
            if meta.get("lowered_with") != "torch-fallback" or meta.get("backend") != "cuda":
                fail(f"{t.key}: record meta {meta}, want cuda torch-fallback")
            continue
        if meta.get("pallas_kernel") == "row_softmax":
            snapped = (meta["pallas_rows_snapped"],)
            sampled = meta["pallas_rows_sampled"]
        else:
            snapped = tuple(meta["pallas_blocks_snapped"])
            sampled = meta.get("pallas_blocks_sampled")
        _, lowered = apply_trace(t.func, rec.trace(), backend="cuda")
        ins = TUNED_INPUTS.pop(t.key, None) or device_inputs(t.func, torch.device("cuda"))
        outs = lowered.fn(ins)
        torch.cuda.synchronize()
        kern = meta["pallas_kernel"]
        last = _wrappers()[kern].last_launch
        shapes = [b.shape for b in t.func.inputs]
        if kern == "flash_attention":
            b, kvh, g, s, d = shapes[0]
            cfg = fa.launch_config(b, kvh * g, kvh, s, d, *snapped, sm_count("cuda"))
            want = {k: cfg[k] for k in ("variant", "grid", "threads", "smem_bytes",
                                        "splits")}
        elif kern == "decode_flash_attention":
            b, kvh, g, d = shapes[0]
            (bkv,) = snapped
            cfg = fa.decode_launch_config(b, kvh, g, shapes[1][2], d, bkv,
                                          sm_count("cuda"))
            want = {k: cfg[k] for k in ("grid", "threads", "smem_bytes", "splits")}
        elif kern == "row_softmax":
            M, N = shapes[0]
            cfg = sm.launch_config(M, N, *snapped)
            want = {k: cfg[k] for k in ("variant", "grid", "threads", "smem_bytes")}
        else:
            if kern == "matmul":
                (M, K), (_, N), B = shapes[0], shapes[1], 1
            else:
                (B, M, K), N = shapes[0], shapes[1][2]
            cfg = mm.launch_config(B, M, N, K, snapped)
            want = {k: cfg[k] for k in ("variant", "grid", "threads", "smem_bytes")}
        got = {k: last[k] for k in want}
        var = f" {last['variant']}" if "variant" in last else ""
        print(f"[tiles] {t.key}:{var} sampled {sampled} "
              f"snapped {list(snapped)} -> grid {last['grid']} threads "
              f"{last['threads']} smem {last['smem_bytes']} B; best "
              f"{rec.latency_s * 1e3:.4f} ms")
        if tuple(last["blocks"]) != snapped or got != want:
            fail(f"{t.key}: launch {last} does not follow snapped blocks {snapped}")
        if kern == "matmul":
            tuned_k1_against_plain(t, ins, snapped, next(iter(outs.values())))
        elif kern == "batch_matmul":
            tuned_k2_against_plain(t, ins, snapped, next(iter(outs.values())))
        runs[t.key] = (kern, snapped, shapes)
    TUNED_INPUTS.clear()
    return runs


def tuned_k1_against_plain(t, ins, blocks, got) -> None:
    """Hold K1 at a tuned tile against the plain version within
    TOL_MATMUL: the record's own output (w as the task gives it,
    n-contiguous) and the same product with w read transposed
    (k-contiguous, as the tied unembed reads its table)."""
    import torch

    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref

    name = t.func.name  # the epilogue, as lower_dense reads it
    epi = name[len("dense_"):] if name.startswith("dense_") else "none"
    x, w, bias = ins["X"], ins["W"], ins.get("bias")
    want = ref.matmul(x, w, bias, epilogue=epi)
    got_k = mm.matmul(x, w.t().contiguous().t(), bias, epilogue=epi, block_sizes=blocks)
    var = mm.matmul.last_launch["variant"]
    for layout, y in (("n", got), ("k", got_k)):
        err = float((y.float() - want.float()).abs().max())
        print(f"[tiles] {t.key}: {var} {list(blocks)} w {layout}-contiguous {epi} "
              f"against plain: max_abs_err {err:.3e} (tol {TOL_MATMUL:g})")
        if not math.isfinite(err) or err > TOL_MATMUL:
            fail(f"{t.key}: K1 {var} {blocks} w {layout}-contiguous: "
                 f"max_abs_err {err} > {TOL_MATMUL}")


def tuned_k2_against_plain(t, ins, blocks, got) -> None:
    """Hold K2 at a tuned tile against the plain version within
    TOL_MATMUL: the record's own output (contiguous operands) and the same
    product with both operands read transposed (x m-contiguous, w
    k-contiguous, as attention reads k)."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref

    a, b = ins["A"], ins["B"]
    want = ref.batch_matmul(a, b)
    got_t = mm.batch_matmul(a.transpose(1, 2).contiguous().transpose(1, 2),
                            b.transpose(1, 2).contiguous().transpose(1, 2),
                            block_sizes=blocks)
    var = mm.batch_matmul.last_launch["variant"]
    for layout, y in (("contiguous", got), ("transposed", got_t)):
        err = float((y.float() - want.float()).abs().max())
        print(f"[tiles] {t.key}: {var} {list(blocks)} operands {layout} against "
              f"plain: max_abs_err {err:.3e} (tol {TOL_MATMUL:g})")
        if not math.isfinite(err) or err > TOL_MATMUL:
            fail(f"{t.key}: K2 {var} {blocks} operands {layout}: "
                 f"max_abs_err {err} > {TOL_MATMUL}")


def phase_forward(cfg, tasks, db, gen_seed: int = 0):
    import torch

    import repro_torch
    from repro_torch.models import transformer as T
    from repro_torch.search.database import workload_key

    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(gen_seed + 1)
    toks = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g, device="cuda")

    with torch.no_grad():
        T.forward(cfg, params, toks)  # warm the plain path
        plain, plain_ms = timed_ms(lambda: T.forward(cfg, params, toks))
        ctx = path_context(db, tasks=tasks, backend="cuda")
        reset_counts()
        with ctx:
            tuned = T.forward(cfg, params, toks)
        torch.cuda.synchronize()
        fwd_counts = read_counts()
        fwd_variants = read_variants()
        k3_variants = read_variants("flash_attention")
        stats, by_key = dict(ctx.stats), ctx.stats_by_key()  # this one forward
        with ctx:
            _, tuned_ms = timed_ms(lambda: T.forward(cfg, params, toks))
        # K3's device time over the dispatched forward's launches
        def run_tuned():
            with ctx:
                return T.forward(cfg, params, toks)

        # three forwards: the profiler's events of each take seconds to read
        k3_traced = traced_ms(run_tuned, K3_KERNEL_NAMES, calls=3)
    diff = (tuned.float() - plain.float()).abs()
    max_abs = float(diff.max())
    rel = max_abs / float(plain.float().abs().max())
    print(f"[forward] logits {tuple(tuned.shape)} {tuned.dtype}; max_abs_err "
          f"{max_abs:.4e} max_rel_err {rel:.4e} (tol {TOL_LOGITS_REL:g})")
    print(f"[forward] plain {plain_ms:.2f} ms, dispatched {tuned_ms:.2f} ms "
          f"(median of 3, batch {BATCH} seq {SEQ}; before rmsnorm was dispatched: "
          f"{NO_NORM_FORWARD_MS} ms)")
    print(f"[forward] dispatch stats of one forward {stats}")
    reasons = {}
    for key, row in by_key.items():
        print(f"[forward]   {key}: hits {row['hits']} misses {row['misses']} "
              f"fallbacks {row['fallbacks']} reasons {row['reasons']}")
        for r, n in row["reasons"].items():
            reasons[r] = reasons.get(r, 0) + n
    print(f"[forward] kernel launches in one dispatched forward: {fwd_counts}; "
          f"K1 by variant {fwd_variants}")
    n_k3 = fwd_counts["flash_attention"]
    traced = {n: ms for n, ms in k3_traced.items() if ms is not None}
    k3_ms = traced.get(K3_KERNEL_NAMES[0], 0.0) * n_k3
    print(f"[forward] flash_attention launches by variant in one dispatched forward: "
          f"{k3_variants}; traced device time {traced} ms a launch, "
          f"{k3_ms:.4f} ms a forward")
    if k3_variants != {"tc": cfg.n_layers, "fma": 0} or set(traced) != {K3_KERNEL_NAMES[0]}:
        fail(f"the dispatched forward's flash_attention launches: {k3_variants}, "
             f"traced {traced}; want {cfg.n_layers} tc")
    if not torch.isfinite(tuned.float()).all():
        fail("dispatched logits are not finite")
    if tuned.shape != (BATCH, SEQ, cfg.vocab):
        fail(f"logits shape {tuple(tuned.shape)}")
    if rel > TOL_LOGITS_REL:
        fail(f"logits rel err {rel} > {TOL_LOGITS_REL}")
    if stats["hits"] <= 0:
        fail("no dispatch hits")
    if reasons.get("lowering_failed"):
        fail(f"{reasons['lowering_failed']} lowering_failed misses")
    for k in ("matmul", "flash_attention"):
        if fwd_counts[k] <= 0:
            fail(f"{k} was not launched in the dispatched forward")
    norm_key = workload_key("rmsnorm", d=cfg.d_model, eps=cfg.norm_eps,
                            tokens=BATCH * SEQ)
    norm_hits = by_key.get(norm_key, {}).get("hits", 0)
    print(f"[forward] {norm_key}: {norm_hits} hits in one forward")
    if norm_hits != 2 * cfg.n_layers + 1 or reasons.get("not_in_slice"):
        fail(f"forward: {norm_hits} rmsnorm hits, reasons {reasons}; want "
             f"{2 * cfg.n_layers + 1} and no not_in_slice")
    return dict(max_abs_err=max_abs, max_rel_err=rel, plain_ms=plain_ms,
                dispatched_ms=tuned_ms, stats=stats, rmsnorm_hits=norm_hits,
                reasons=reasons, matmul_variants=fwd_variants,
                flash_attention_variants=k3_variants, flash_attention_traced_ms=k3_ms,
                flash_attention_traced_ms_a_launch=traced), fwd_counts


# ---------------------------------------------------------------------------
# phase 6: tuned-tile timings at the main path's shapes
# ---------------------------------------------------------------------------


def phase_timings(tasks, runs, gen, vocab: int) -> dict:
    import torch

    from repro_torch.search.database import parse_workload_key

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels import softmax as sm

    rows = {}
    for t in tasks:
        if t.key not in runs:
            continue  # no kernel: the structural lowering (check_tiles)
        kern, snapped, shapes = runs[t.key]
        extra = {}
        if kern == "matmul":
            (M, K), (_, N) = shapes[0], shapes[1]
            x = torch.randn(M, K, generator=gen, device="cuda")
            w = torch.randn(K, N, generator=gen, device="cuda")
            if N == vocab:  # the tied unembed reads the table transposed
                w = torch.randn(N, K, generator=gen, device="cuda").t()
            def launch():
                return mm.matmul(x, w, block_sizes=snapped)

            def library():
                return torch.matmul(x, w)
            k_ms = median_ms(launch)
            p_ms = median_ms(lambda: ref.matmul(x, w))
            l_ms = median_ms(library)
            flops = 2 * M * N * K
            var = mm.launch_config(1, M, N, K, snapped)["variant"]
            b_ms, b_by, b67 = mm_bound(M, N, K)
            extra = dict(variant=var, bound_f32_ms=b67)
        elif kern == "batch_matmul":
            (B, M, K), N = shapes[0], shapes[1][2]
            a = torch.randn(B, M, K, generator=gen, device="cuda")
            b = torch.randn(B, K, N, generator=gen, device="cuda")
            def launch():
                return mm.batch_matmul(a, b, block_sizes=snapped)

            def library():
                return torch.bmm(a, b)
            k_ms = median_ms(launch)
            p_ms = median_ms(lambda: ref.batch_matmul(a, b))
            l_ms = median_ms(library)
            flops = 2 * B * M * N * K
            var = mm.launch_config(B, M, N, K, snapped)["variant"]
            b_ms, b_by, b67 = mm_bound(M, N, K, B)
            extra = dict(variant=var, bound_f32_ms=b67)
        elif kern == "row_softmax":
            M, N = shapes[0]
            (bm,) = snapped
            x = torch.randn(M, N, generator=gen, device="cuda")
            def launch():
                return sm.row_softmax(x, block_rows=bm)
            def library():
                return torch.softmax(x, -1)
            k_ms = median_ms(launch)
            p_ms = median_ms(lambda: ref.row_softmax(x))
            l_ms = median_ms(library)
            # max, subtract, exp, sum and divide an element; x read once and
            # y written once
            flops, nbytes = 5 * M * N, 2 * 4 * M * N
            extra = dict(variant=sm.launch_config(M, N, bm)["variant"])
        elif kern == "decode_flash_attention":
            (b, kvh, g, d), t_len = shapes[0], shapes[1][2]
            (bkv,) = snapped
            cap = parse_workload_key(t.key)[1]["softcap"] or None
            q = torch.randn(b, kvh, g, d, generator=gen, device="cuda")
            k = torch.randn(b, kvh, t_len, d, generator=gen, device="cuda")
            v = torch.randn(b, kvh, t_len, d, generator=gen, device="cuda")
            bias = decode_bias([t_len] * b, t_len)
            def launch():
                return fa.decode_flash_attention(q, k, v, bias, softcap=cap, block_kv=bkv)
            def plain_mask():
                return sdpa_decode(q, k, v, bias)
            # SDPA takes no softcap: flex_attention computes K5's function
            # then, timed at this shape by the flex process
            library = flex_time(q, k, 0) if cap else plain_mask
            k_ms = median_ms(launch)
            extra = dict(splits=fa.decode_flash_attention.last_launch["splits"])
            p_ms = median_ms(lambda: ref.decode_attention(q, k, v, bias, softcap=cap))
            l_ms = library["ms"] if isinstance(library, dict) else median_ms(library)
            flops, nbytes = decode_work(b, kvh, g, t_len, d)
        else:
            b, kvh, g, s, d = shapes[0]
            h = kvh * g
            kw = parse_workload_key(t.key)[1]
            causal, cap = bool(kw["causal"]), kw["softcap"] or None
            window = kw["window"] or None  # 0 in a key is global
            q = torch.randn(b, h, s, d, generator=gen, device="cuda")
            k = torch.randn(b, kvh, s, d, generator=gen, device="cuda")
            v = torch.randn(b, kvh, s, d, generator=gen, device="cuda")
            bq, bkv = snapped
            def launch():
                return fa.flash_attention(q, k, v, causal=causal, window=window,
                                          softcap=cap, block_q=bq, block_kv=bkv)
            def plain_mask():
                return sdpa(q, k, v, causal)
            # SDPA takes no softcap and no window bound to the causal mask:
            # flex_attention computes K3's function then (gemma2, causal),
            # timed at this shape by the flex process
            library = flex_time(q, k, window or 0) if cap or window else plain_mask
            k_ms = median_ms(launch)
            p_ms = median_ms(lambda: ref.flash_attention(q, k, v, causal=causal,
                                                         window=window, softcap=cap))
            l_ms = library["ms"] if isinstance(library, dict) else median_ms(library)
            var = fa.flash_attention.last_launch["variant"]
            flops = attention_work(b, h, kvh, s, d, causal, window or 0)[0]
            b_ms, b_by, b67 = attention_bound(b, h, kvh, s, d, causal, window or 0)
            extra = dict(variant=var, bound_f32_ms=b67)
        if kern not in ("matmul", "batch_matmul", "flash_attention"):
            b_ms, b_by = bound(flops, nbytes)
        # the kernel and the library call on one footing: device time by
        # CUDA-graph replay of 20 calls each
        d_ms = graph_ms(launch)
        l_d_ms = library["device_ms"] if isinstance(library, dict) else graph_ms(library)
        if kern in ("flash_attention", "decode_flash_attention") and \
                library is not plain_mask:
            # SDPA's time without the softcap and the window, kept beside the
            # library's under its own name
            extra.update(sdpa_plain_mask_device_ms=graph_ms(plain_mask))
        rows[t.key] = dict(kernel=kern, blocks=list(snapped), ms=k_ms,
                           device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms,
                           library_device_ms=l_d_ms, bound_ms=b_ms, bound_by=b_by,
                           weight=t.weight, flops=flops, **extra)
        var = f" {extra['variant']}" if "variant" in extra else ""
        if "splits" in extra:
            var = f" {extra['splits']} splits"
        f32 = (f", {extra['bound_f32_ms']:.4f} ms at 67 TFLOP/s"
               if "bound_f32_ms" in extra else "")
        lib = f"library {l_ms:.4f} ms (device {l_d_ms:.4f} ms)"
        if "sdpa_plain_mask_device_ms" in extra:
            lib += (f" [flex_attention, timed at this shape by the flex process; sdpa "
                    f"without the softcap and window: device "
                    f"{extra['sdpa_plain_mask_device_ms']:.4f} ms]")
        print(f"[time] {t.key} {kern}{var} blocks {list(snapped)}: kernel {k_ms:.4f} ms "
              f"(device {d_ms:.4f} ms) plain {p_ms:.4f} ms {lib} bound {b_ms:.4f} ms "
              f"({b_by}{f32})")
    return rows


# Fixed tiles timed every run, so runs compare at the same tile whatever
# the search picks: K1 at the tiles of the per-shape table PERF.md keeps for
# its three variants, K2 and K4 at the tiles PERF.md records for their
# kernels before the shared variants and the registers softmax, K3 at the
# search's tile before its tc variant and at a 64-row q block.
# (kernel, shape, blocks); K1's shape is (M, K, N, w layout), K2's (B, M,
# K, N), K4's (M, N), K3's (B, H, KVH, S, D), causal
FIXED_TILES = (
    ("matmul", (256, 576, 1536, "n"), (64, 32, 64)),
    ("matmul", (256, 576, 49152, "k"), (64, 96, 16)),
    ("matmul", (256, 1536, 576, "n"), (64, 24, 24)),
    ("matmul", (256, 576, 576, "n"), (16, 96, 72)),
    ("matmul", (256, 576, 192, "n"), (16, 96, 72)),
    ("matmul", (128, 576, 1536, "n"), (128, 16, 24)),
    ("matmul", (128, 1536, 576, "n"), (16, 24, 32)),
    ("matmul", (128, 576, 576, "n"), (16, 24, 64)),
    ("matmul", (128, 576, 192, "n"), (128, 16, 24)),
    ("matmul", (4, 576, 49152, "k"), (4, 96, 96)),
    ("matmul", (4, 576, 1536, "n"), (2, 6, 96)),
    ("matmul", (4, 1536, 576, "n"), (4, 18, 64)),
    ("matmul", (4, 576, 576, "n"), (2, 12, 96)),
    ("matmul", (4, 576, 192, "n"), (2, 32, 64)),
    ("matmul", (256, 1024, 50280, "k"), (32, 120, 32)),
    ("matmul", (4, 1024, 50280, "k"), (4, 60, 64)),
    # qwen2-vl-2b's forward unembed, which no schedule reaches (schedulable)
    ("matmul", (256, 1536, 151936, "k"), (64, 128, 32)),
    # hymba-1.5b's forward unembed, left plain (HYMBA_PLAIN_UNEMBED): bn 3,
    # the largest divisor of 32001 that K1's threads take
    ("matmul", (256, 1600, 32001, "k"), (256, 3, 80)),
    # stablelm-3b's forward unembed, left plain (STABLELM_UNEMBED), at a
    # tile of 131,072 elements under both caps
    ("matmul", (256, 2560, 50304, "k"), (256, 128, 4)),
    ("batch_matmul", (3, 768, 256, 64), (24, 32, 32)),
    # hymba-1.5b's train-step SSD product over 65536 batches, a tuning
    # target the step does not hit: two splitk launches of at most 65535
    ("batch_matmul", (65536, 1, 1, 25), (1, 25, 1)),
    ("row_softmax", (2304, 256), (12,)),
    ("flash_attention", (1, 9, 3, 256, 64), (8, 128)),
    ("flash_attention", (1, 9, 3, 256, 64), (64, 128)),
)


def fixed_tile_timings(gen) -> list:
    """Device ms by CUDA-graph replay of each FIXED_TILES entry, beside its
    library call's."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import softmax as sm

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    rows = []
    for kern, shape, blocks in FIXED_TILES:
        if kern == "matmul":
            M, K, N, layout = shape
            x = randn(M, K)
            w = randn(N, K).t() if layout == "k" else randn(K, N)
            calls = (lambda: mm.matmul(x, w, block_sizes=blocks),
                     lambda: torch.matmul(x, w))
        elif kern == "batch_matmul":
            B, M, K, N = shape
            a, b = randn(B, M, K), randn(B, K, N)
            calls = (lambda: mm.batch_matmul(a, b, block_sizes=blocks),
                     lambda: torch.bmm(a, b))
        elif kern == "flash_attention":
            B, H, KVH, S, D = shape
            q, k, v = randn(B, H, S, D), randn(B, KVH, S, D), randn(B, KVH, S, D)
            calls = (lambda: fa.flash_attention(q, k, v, block_q=blocks[0],
                                                block_kv=blocks[1]),
                     lambda: sdpa(q, k, v, True))
        else:
            x = randn(*shape)
            calls = (lambda: sm.row_softmax(x, block_rows=blocks[0]),
                     lambda: torch.softmax(x, -1))
        calls[0]()
        var = _wrappers()[kern].last_launch["variant"]
        d_ms, l_ms = (graph_ms(fn) for fn in calls)
        b_ms, b_by = None, None
        if kern == "matmul":
            b_ms, b_by, _ = mm_bound(M, N, K)
        elif kern == "batch_matmul":
            b_ms, b_by, _ = mm_bound(M, N, K, B)
        print(f"[time] fixed tile {kern} {var} {shape} {list(blocks)}: device "
              f"{d_ms:.4f} ms, library {l_ms:.4f} ms ({d_ms / l_ms:.2f}x)"
              + (f", bound {b_ms:.4f} ms ({b_by})" if b_ms is not None else ""))
        rows.append(dict(kernel=kern, variant=var, shape=list(shape),
                         blocks=list(blocks), device_ms=d_ms, library_device_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def unembed_tasks(tasks, runs, vocab: int) -> list:
    """The tasks whose tuned kernel is K1 with N = vocab (the unembed)."""
    return [t for t in tasks if t.key in runs and runs[t.key][0] == "matmul"
            and runs[t.key][2][1][1] == vocab]


def structural_timings(tasks, db) -> dict:
    """The host cost of the structural lowering: each no-kernel task's best
    record replayed on the card (CUDA-event median of 20 calls, which
    include the host's Python loop) beside the one-call plain version and
    the record's iterated-loop trip count."""
    import torch

    from repro_torch.backends.gpu_backend import plain
    from repro_torch.core.validator import validate_trace
    from repro_torch.search.measure.local import device_inputs
    from repro_torch.search.tune import apply_trace

    rows = {}
    for t in tasks:
        if t.key.split("/")[0] not in STRUCTURAL_OPS:
            continue
        rec = db.best(t.key)
        iters = validate_trace(t.func, rec.trace()).iterations
        _, lowered = apply_trace(t.func, rec.trace(), backend="cuda")
        ins = device_inputs(t.func, torch.device("cuda"))
        base = plain(t.func)
        s_ms = median_ms(lambda: lowered.fn(ins))
        p_ms = median_ms(lambda: base(ins))
        rows[t.key] = dict(structural_ms=s_ms, plain_ms=p_ms, iterations=iters,
                           weight=t.weight)
        print(f"[time] {t.key} structural ({iters} iterated trips): {s_ms:.4f} ms "
              f"a call, plain {p_ms:.4f} ms; {t.weight:g} sites")
    return rows


def decode_work(b, kvh, g, t_len, d, table_entries: int = 0, attended: int = 0):
    """(flops, bytes) of one decode attention call: q·k and p·v over the
    whole cache, or over the ``attended`` positions a slot's bias leaves
    (a window); those K and V rows read once, q read and o written, the
    bias row read (and the page table, for K6)."""
    att = attended or t_len
    flops = 4 * b * kvh * g * att * d
    nbytes = 4 * (2 * b * kvh * att * d + 2 * b * kvh * g * d + b * t_len
                  + table_entries)
    return flops, nbytes


def paged_timing(gen, t_len: int, ps: int) -> dict:
    """K6 at the serving shape, pages scattered over the pool, beside K5
    on the gathered view and the plain version.  No single PyTorch call
    reads a cache through a page table, so there is no library time."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    b, kvh, g, d = SERVE_SLOTS, 3, 3, 64
    P = t_len // ps
    n_pages = b * P
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda")
    kp = torch.randn(n_pages, kvh, ps, d, generator=gen, device="cuda")
    vp = torch.randn(n_pages, kvh, ps, d, generator=gen, device="cuda")
    table = torch.randperm(n_pages, generator=gen, device="cuda").reshape(b, P)
    table = table.to(torch.int32)
    bias = decode_bias([t_len] * b, t_len)
    def launch():
        return fa.paged_decode_flash_attention(q, kp, vp, table, bias)
    k_ms = median_ms(launch)
    d_ms = graph_ms(launch)
    splits = fa.paged_decode_flash_attention.last_launch["splits"]
    p_ms = median_ms(lambda: ref.paged_decode_attention(q, kp, vp, table, bias))
    flops, nbytes = decode_work(b, kvh, g, t_len, d, table_entries=b * P)
    b_ms, b_by = bound(flops, nbytes)
    row = dict(kernel="paged_decode_flash_attention", blocks=[ps], ms=k_ms,
               device_ms=d_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               flops=flops, weight=0, splits=splits)
    print(f"[time] paged decode ({b},{kvh},{g},{t_len},{d}) page {ps}, {splits} splits: kernel "
          f"{k_ms:.4f} ms (device {d_ms:.4f} ms) plain {p_ms:.4f} ms library - (no single PyTorch call "
          f"reads through a page table) bound {b_ms:.4f} ms ({b_by})")
    return row


# ---------------------------------------------------------------------------
# phase 7: the serving path
# ---------------------------------------------------------------------------


def serve_requests(cfg, params, dispatch, prompts, on_tick=None,
                   new_tokens: int = SERVE_NEW_TOKENS, record: bool = False):
    """Serve ``prompts`` through the paged continuous-batching scheduler,
    ``new_tokens`` each; ``on_tick(sched)`` runs before every tick.  With
    ``record``, each token's logits row and top-2 gap are kept
    (:func:`serve_recording`).  Returns (scheduler, requests, wall seconds,
    (gaps, rows), each a list per request, empty without ``record``)."""
    import torch

    from repro_torch.serving import ContinuousBatchingScheduler, ServeConfig

    sched = ContinuousBatchingScheduler(cfg, params, config=ServeConfig(
        max_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, paged=True,
        page_size=SERVE_PAGE, prefill_chunk=SERVE_CHUNK, dispatch=dispatch,
    ))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs, gaps, rows, _ = serve_recording(sched, prompts, new_tokens, on_tick, record)
    torch.cuda.synchronize()
    return sched, reqs, time.perf_counter() - t0, (gaps, rows)


# the kernels K1 launches; K2 shares all three, but launches in neither
# traced call (the decode-only tick checks that K2 has no launch in it, and
# mamba2 has no batch_matmul site)
K1_KERNEL_NAMES = ("matmul_splitk_kernel", "matmul_tc_kernel", "matmul_tile_kernel")
# K3's two kernels, K5's and K6's one, and K7's two
K3_KERNEL_NAMES = ("flash_attention_tc_kernel", "flash_attention_kernel")
K5_KERNEL_NAMES = ("decode_attention_kernel",)
K7_KERNEL_NAMES = ("ssd_chunk_kernel", "ssd_pass_kernel")
# PyTorch's copy kernels (``.contiguous()``, ``copy_``, a slice assigned)
# and CUDA's memcpys, by the words in their names
COPY_KERNEL_NAMES = ("copy_kernel", "Memcpy")


def kernel_grids(prof) -> list:
    """(name, grid, duration in us) of each kernel of a profile, read from
    its chrome trace (the launch grid is in each kernel's ``args``), which
    is written under the git-ignored ``build/`` and removed."""
    path = ROOT / "build" / f"profile_{os.getpid()}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        path.unlink()
    return [(e["name"], tuple(e["args"]["grid"]), e.get("dur", 0.0)) for e in events
            if e.get("cat") == "kernel" and "grid" in e.get("args", {})]


def profile_device(fn, grids_k2=None) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device's events
    (kernels, copies), their summed time by name, the time the device was
    busy (the union of their intervals), the span from the first event's
    start to the last one's end, the summed time of K1's, K3's, K5's and
    K7's kernels, and that of the copies (PyTorch's copy kernels and
    memcpys; ``copy_events`` counts them).  K1 and K2 launch the same kernels: with ``grids_k2``
    (the grids of K2's launches on the path) a matmul kernel whose grid is
    one of them counts as K2's (``batch_matmul_ms``, None where none
    does).  Empty when the profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return {}
    busy, end = 0.0, spans[0][0]
    by_name = Counter()
    groups = {"matmul_ms": K1_KERNEL_NAMES, "decode_attention_ms": K5_KERNEL_NAMES,
              "ssd_ms": K7_KERNEL_NAMES, "flash_attention_ms": K3_KERNEL_NAMES,
              "copy_ms": COPY_KERNEL_NAMES}
    by_kernel = dict.fromkeys(groups, 0.0)
    copies = 0
    for t0, t1, name in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name[:60]] += t1 - t0
        for key, names in groups.items():
            if any(k in name for k in names):
                by_kernel[key] += t1 - t0
        copies += any(k in name for k in COPY_KERNEL_NAMES)
    span = end - spans[0][0]
    out = dict(events=len(spans), copy_events=copies, busy_ms=busy / 1e3,
               span_ms=span / 1e3,
               idle_share=1.0 - busy / span if span > 0 else 0.0,
               **{k: v / 1e3 for k, v in by_kernel.items()},
               top_ms={k: v / 1e3 for k, v in by_name.most_common(6)})
    if grids_k2 is not None:
        k2 = [dur for name, grid, dur in kernel_grids(prof)
              if grid in grids_k2 and any(k in name for k in K1_KERNEL_NAMES)]
        out.update(batch_matmul_ms=sum(k2) / 1e3 if k2 else None,
                   batch_matmul_events=len(k2))
        if k2:
            out["matmul_ms"] -= out["batch_matmul_ms"]
    return out


def k2_grids(runs, keys):
    """The grids of the tuned K2 launches of ``keys`` in ``runs``
    (``check_tiles``), or None (K2's traced time not measured) where one of
    them is also a grid of a K1 launch of ``keys``, which the trace could
    not tell apart."""
    from repro_torch.kernels import matmul as mm

    grids = {"matmul": set(), "batch_matmul": set()}
    for kern, snapped, shapes in (runs[k] for k in keys if k in runs):
        if kern == "matmul":
            (M, K), (_, N), B = shapes[0], shapes[1], 1
        elif kern == "batch_matmul":
            (B, M, K), N = shapes[0], shapes[1][2]
        else:
            continue
        grids[kern].add(tuple(mm.launch_config(B, M, N, K, snapped)["grid"]))
    shared = grids["matmul"] & grids["batch_matmul"]
    if shared:
        print(f"[trace] K1 and K2 share launch grids {sorted(shared)}: K2's traced "
              "time is not measured")
        return None
    return grids["batch_matmul"]


def snapshot_tick(sched) -> dict:
    """The scheduler's next tick, decode lanes only: its inputs and a copy
    of the arena it would run on."""
    import torch

    toks, valid, chunked = sched.tick_inputs()
    if chunked or toks.shape[1] != 1:
        fail(f"the checked tick is not decode-only: chunks {chunked}")
    return dict(toks=torch.from_numpy(toks).cuda(),
                valid=torch.from_numpy(valid).cuda(),
                cache={k: v.clone() for k, v in sched.arena.cache.items()})


def decode_only_tick(sched, snap, ctx, timing_ctx, attn_key: str,
                     norm_key: str, runs=None, params32=None, moe_inputs=None) -> dict:
    """Run a snapshotted decode-only tick (a paged ``serve_step`` tick, or
    with no ``valid`` in ``snap`` a slot arena's ``decode_step``) on copies
    of its arena, under ``ctx`` and with no context, and compare the
    logits; then time the same
    tick both ways on the host clock (median of 3, each on a fresh copy,
    under ``timing_ctx`` so ``ctx``'s counts stay the check's) and trace it
    once each way with the profiler (with ``runs``, the tuned tiles, K2's
    kernels told from K1's by their grids).  With ``params32`` the logits
    are also compared on those f32 parameters and an f32 copy of the arena,
    with each MoE layer's routing flips (none for a dense model).  With
    ``moe_inputs`` (a list) the tick itself is an MoE model's: its routing
    flips are counted and each MoE layer's input in the dispatched run is
    appended there."""
    import torch

    toks, valid = snap["toks"], snap.get("valid")
    if valid is None:  # a slot-arena tick (``decode_step``): every lane live
        valid = torch.ones(toks.shape[0], dtype=torch.int32, device=toks.device)

    def copy(dtype=None):
        return {k: v.to(dtype) if dtype and v.is_floating_point() else v.clone()
                for k, v in snap["cache"].items()}

    def run(dispatch, cache, params=None):
        with torch.no_grad(), (dispatch if dispatch is not None else nullcontext()):
            if "valid" not in snap:
                return sched.model.decode_step(params or sched.params, cache, toks)[0]
            return sched.model.serve_step(params or sched.params, cache, toks, valid)[0]

    def tick_ms(dispatch):
        ts = []
        for _ in range(3):
            cache = copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(dispatch, cache)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[1] * 1e3

    hits_before = dict(ctx.hits_by_key)
    hits0 = ctx.hits_by_key.get(attn_key, 0)
    norm0 = ctx.hits_by_key.get(norm_key, 0)
    counts0 = read_counts()
    variants0 = read_variants()
    k2_variants0 = read_variants("batch_matmul")
    reasons0 = Counter(r for row in ctx.stats_by_key().values()
                       for r, n in row["reasons"].items() for _ in range(n))
    routes_t, routes_p = [], []
    with moe_routes(routes_t, moe_inputs) if moe_inputs is not None else nullcontext():
        tuned = run(ctx, copy())
    torch.cuda.synchronize()
    hits = ctx.hits_by_key.get(attn_key, 0) - hits0
    tick_keys = [k for k, n in ctx.hits_by_key.items() if n > hits_before.get(k, 0)]
    norm_hits = ctx.hits_by_key.get(norm_key, 0) - norm0
    launches = {k: n - counts0[k] for k, n in read_counts().items()}
    variants = variants_since(variants0)
    k2_variants = variants_since(k2_variants0, "batch_matmul")
    reasons = Counter(r for row in ctx.stats_by_key().values()
                      for r, n in row["reasons"].items() for _ in range(n))
    with moe_routes(routes_p) if moe_inputs is not None else nullcontext():
        plain = run(None, copy())
    live = valid.bool()
    d, p = tuned[live].float(), plain[live].float()
    rel = float((d - p).abs().max() / p.abs().max())
    moe = {}
    if moe_inputs is not None:
        moe["flips_by_layer"] = routing_flips(routes_t, routes_p)
    if params32 is not None:
        # top-k routing is discontinuous: the MoE tick is held in f32, with
        # the routing flips of each layer counted (phase 11 says why)
        routes_t, routes_p = [], []
        with moe_routes(routes_t):
            d32 = run(timing_ctx, copy(torch.float32), params32)[live]
        with moe_routes(routes_p):
            p32 = run(None, copy(torch.float32), params32)[live]
        moe = dict(f32_max_rel_err=float((d32 - p32).abs().max() / p32.abs().max()),
                   f32_finite=bool(torch.isfinite(d32).all()),
                   flips_by_layer=routing_flips(routes_t, routes_p))
    dispatched_ms, plain_ms = tick_ms(timing_ctx), tick_ms(None)
    caches = copy(), copy()
    grids = k2_grids(runs, tick_keys) if runs is not None else None
    traced = profile_device(lambda: run(timing_ctx, caches[0]), grids)
    traced_plain = profile_device(lambda: run(None, caches[1]))
    return dict(lanes=int(live.sum()), attention_decode_hits=hits,
                rmsnorm_hits=norm_hits, launches=launches, matmul_variants=variants,
                batch_matmul_variants=k2_variants,
                new_reasons=dict(reasons - reasons0),
                max_rel_err=rel, finite=bool(torch.isfinite(d).all()), **moe,
                dispatched_ms=dispatched_ms, plain_ms=plain_ms,
                profile=traced, profile_plain=traced_plain)


def phase_serve(cfg, db, gen_seed: int = 0, tag: str = "serve",
                decode_tasks: int = 0, serve_tasks: int = 0, plain_keys=(),
                tick_launches=None, new_tokens: int = SERVE_NEW_TOKENS,
                f32: bool = False, cold_width: int = 0, unschedulable=None):
    """Phase 7 (smollm-135m), 12 (olmoe-1b-7b), 15 (qwen2-vl-2b), 21
    (gemma2-2b), 26 (stablelm-3b), 29 (qwen1.5-110b) or 31 (arctic-480b):
    the model's decode
    tasks tuned, its tuned tiles checked, 8
    requests served on the paged arena under the tuned context and with no
    context, then one decode-only tick compared, timed and traced.  The
    tasks are those of a decode step and a 32-wide paged serving tick: the
    dispatchable ones, or with ``serve_tasks`` (and for olmoe) all the
    ``serve_tasks`` the reference extracts, non-dispatchable contractions
    included as tuning targets; those of ``plain_keys`` are left plain.
    With ``decode_tasks`` they are the ``decode_tasks`` ones of a decode
    step alone (the tick's chunk sites then run plain).  With ``tick_launches``
    (launches a kernel) the tick is also held in f32 within
    ``TOL_F32_LOGITS_REL`` on the parameters cast to f32, and its launches
    must be those.  Each request generates ``new_tokens``.  With ``f32``
    both runs serve the parameters cast to f32, the tick is held in f32
    within ``TOL_F32_LOGITS_REL``, and each dispatched stream must equal the
    plain one or differ first where the plain top-2 logits are within 2d of
    max |logit|, d the largest difference of the two runs' logits over the
    steps whose streams agree before them (phase 18's rule), itself within
    ``TOL_F32_LOGITS_REL``; an MoE model served so (arctic-480b) is held
    there only where no token's routing differs in the tick, every model
    call of the serving run (a prompt chunk's included) must launch K2
    three times a layer, and each MoE layer of the tick is dispatched
    against plain on the same f32 input within ``tol_moe_rel``.  The
    tuning's cold searches are ``cold_width`` wide and, with
    ``unschedulable``, exactly those keys have no schedule (``phase_tune``); the
    result's ``peak_bytes`` holds the device memory allocated at the peak
    of the tuning and of the serving.  Returns the tasks, their bests, the
    results, the tuning's launch counts and the checked tiles."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels.matmul import SPLITK_MAX_M
    from repro_torch.models import transformer as T
    from repro_torch.search.database import parse_workload_key, workload_key

    moe = bool(cfg.moe_experts)

    def extract():
        if decode_tasks:
            tasks = repro_torch.extract_decode_tasks(cfg, batch=SERVE_SLOTS,
                                                     max_seq=SERVE_MAX_SEQ)
            if len(tasks) != decode_tasks:
                fail(f"{cfg.name} decode extraction gave {len(tasks)} tasks, want "
                     f"the reference's {decode_tasks}")
            return tasks
        # olmoe: all 16 tasks the reference extracts (its three
        # non-dispatchable contractions are tuning targets), gemma2 all 16,
        # arctic all 20; smollm: the 13 dispatchable ones
        want = serve_tasks or (MOE_DECODE_TASKS if moe else 0)
        tasks = repro_torch.extract_decode_tasks(
            cfg, batch=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, paged=True,
            chunk=SERVE_CHUNK, page_size=SERVE_PAGE, dispatchable_only=not want,
        )
        if want and len(tasks) != want:
            fail(f"{cfg.name} decode extraction gave {len(tasks)} tasks, want the "
                 f"reference's {want}")
        return tasks

    torch.cuda.reset_peak_memory_stats()
    tasks, best = phase_tune(cfg, db, extract=extract, tag=f"{tag}-tune",
                             plain_keys=plain_keys, cold_width=cold_width,
                             unschedulable=unschedulable)
    tune_counts = read_counts()
    k2_tune = read_variants("batch_matmul")
    print(f"[{tag}-tune] batch_matmul launches by variant while tuning: {k2_tune}")
    # the decode contraction (smollm M = 3, gemma2 M = 2) tunes on K2's
    # split-K variant, gemma2's chunk contraction (M = 64) on another, and
    # olmoe's expert products also at m32: without a task of M >= 16 every
    # launch is splitk; none where no contraction is tuned (qwen1.5's are
    # tuning targets left plain)
    k2_keys = [t.key for t in tasks if t.key.startswith("batch_matmul/") and t.key in best]
    wide = any(parse_workload_key(k)[1]["m"] >= SPLITK_MAX_M for k in k2_keys)
    others = tune_counts["batch_matmul"] - k2_tune["splitk"]
    if not moe and ((k2_tune["splitk"] > 0) != bool(k2_keys) or bool(others) != wide):
        fail(f"serving tuning launched K2 {tune_counts['batch_matmul']} times, by "
             f"variant {k2_tune}; want splitk where a contraction is tuned, and "
             f"another variant only for a task of M >= {SPLITK_MAX_M}")
    runs = check_tiles(tasks, db)
    peaks = dict(tuning=release_memory())
    attn_key = next(t.key for t in tasks if t.key.startswith("attention_decode"))
    norm_key = workload_key("rmsnorm", d=cfg.d_model, eps=cfg.norm_eps,
                            tokens=SERVE_SLOTS)
    # two norms a layer, four with gemma2's post-norms, and the final one;
    # none where the tick's norm is left plain
    norms = 0 if norm_key in plain_keys else (4 if cfg.post_norms else 2) * cfg.n_layers + 1
    if norms and norm_key not in {t.key for t in tasks}:
        fail(f"decode extraction has no {norm_key} task")
    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    serve_cfg = cfg
    if f32:
        serve_cfg = dataclasses.replace(cfg, dtype="float32")
        params = cast_f32_(params)
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 97, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in lens]
    print(f"[{tag}] {SERVE_REQUESTS} requests, prompt lengths {lens.tolist()}, "
          f"{new_tokens} new tokens each, greedy, {'f32' if f32 else 'bf16'} "
          f"parameters, {cfg.n_layers} layers")
    ctx = path_context(db, tasks=tasks, backend="cuda")
    snap = {}
    # at each tick's start: K2's launches, prefill chunks and decode steps
    # so far, then at the run's end, so each tick's share is a difference
    ticks = []

    def tick_state(sched):
        s = sched.stats
        return read_counts()["batch_matmul"], s["prefill_chunks"], s["decode_steps"]

    def on_tick(sched):
        ticks.append(tick_state(sched))
        # the first tick that will decode only (nothing prefilling, and no
        # admission can start a prompt) is kept for the check below
        idle_admit = not sched.queue or not sched.pool.free
        if not snap and sched.active and not sched.prefilling and idle_admit:
            snap.update(snapshot_tick(sched))

    counts0 = read_counts()
    sched, reqs, wall, (_, rows) = serve_requests(serve_cfg, params, ctx, prompts, on_tick,
                                                  new_tokens, record=f32)
    serve_counts = {k: read_counts()[k] - counts0[k] for k in KERNELS}
    ticks.append(tick_state(sched))
    # (K2 launches, chunks, decode steps) of every tick that ran the model
    tick_work = [tuple(b - a for a, b in zip(t0, t1)) for t0, t1 in zip(ticks, ticks[1:])]
    tick_work = [t for t in tick_work if t[1] or t[2]]
    stats, by_key = dict(ctx.stats), ctx.stats_by_key()  # the serving run's
    if not snap:
        fail("no decode-only tick was checked")
    plain_sched, plain_reqs, plain_wall, (plain_gaps, plain_rows) = serve_requests(
        serve_cfg, params, None, prompts, new_tokens=new_tokens, record=f32)
    # the check runs after both serving runs, so it perturbs neither their
    # times (its profiler trace included) nor the path's launch counts
    timing_ctx = path_context(db, tasks=tasks, backend="cuda")
    # a bf16 run's tick is also held in f32 on the parameters cast to f32
    tick32 = not f32 and (moe or tick_launches is not None)
    params32 = _tree_map(lambda t: t.float(), params) if tick32 else None
    moe_inputs = [] if moe and f32 else None
    check = decode_only_tick(sched, snap, ctx, timing_ctx, attn_key, norm_key,
                             runs if moe else None, params32, moe_inputs)
    del params32
    if moe_inputs is not None:
        check["moe_layer_max_rel_err"] = moe_layer_errors(
            cfg, sched.params, moe_inputs, path_context(db, tasks=tasks, backend="cuda"))
        del moe_inputs
    peaks["serving"] = release_memory()
    done = sum(r.done for r in reqs)
    tokens = sum(len(r.generated) for r in reqs)
    ttft = [r.ttft_s for r in reqs]
    plain_ttft = [r.ttft_s for r in plain_reqs]
    agree = total = 0
    differ = []
    for i, (r, pr) in enumerate(zip(reqs, plain_reqs)):
        for a, b in zip(r.generated, pr.generated):
            agree, total = agree + (a == b), total + 1
        first = next((j for j, (a, b) in enumerate(zip(r.generated, pr.generated))
                      if a != b), None)
        if f32 and first is not None:
            differ.append(dict(request=i, step=first, top2_gap=plain_gaps[i][first]))
    d, d_steps = logit_spread((plain_reqs, plain_rows), (reqs, rows)) if f32 else (None, 0)
    del rows, plain_rows
    s = sched.stats
    res = dict(
        requests=len(reqs), completed=done, tokens=tokens, wall_s=wall,
        plain_wall_s=plain_wall,
        decode_tok_s=sched.decode_tok_s, prefill_tok_s=sched.prefill_tok_s,
        plain_decode_tok_s=plain_sched.decode_tok_s,
        plain_prefill_tok_s=plain_sched.prefill_tok_s,
        ttft_p50_s=float(np.percentile(ttft, 50)),
        ttft_p95_s=float(np.percentile(ttft, 95)),
        plain_ttft_p50_s=float(np.percentile(plain_ttft, 50)),
        plain_ttft_p95_s=float(np.percentile(plain_ttft, 95)),
        decode_steps=s["decode_steps"], mixed_ticks=s["mixed_ticks"],
        prefill_chunks=s["prefill_chunks"],
        attention_decode_tuned=stats["attention_decode_tuned"],
        greedy_agreement=agree / max(total, 1), stats=stats, tick_check=check,
        launches=serve_counts, batch_matmul_tune_variants=k2_tune, f32=f32,
        first_differences=differ, logit_spread=d, logit_spread_steps=d_steps,
        peak_bytes=peaks,
    )
    print(f"[{tag}] completed {done}/{len(reqs)} requests, {tokens} tokens in "
          f"{wall:.2f} s ({s['decode_steps']} decode ticks, {s['mixed_ticks']} "
          f"mixed, {s['prefill_chunks']} prefill chunks)")
    print(f"[{tag}] dispatched: decode {sched.decode_tok_s:.1f} tok/s, prefill "
          f"{sched.prefill_tok_s:.1f} tok/s, TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms "
          f"p95 {res['ttft_p95_s'] * 1e3:.1f} ms")
    print(f"[{tag}] plain: decode {plain_sched.decode_tok_s:.1f} tok/s, prefill "
          f"{plain_sched.prefill_tok_s:.1f} tok/s, TTFT p50 "
          f"{res['plain_ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{res['plain_ttft_p95_s'] * 1e3:.1f} ms, wall {plain_wall:.2f} s")
    print(f"[{tag}] dispatch stats {stats}")
    reasons = Counter()
    for key, row in by_key.items():
        print(f"[{tag}]   {key}: hits {row['hits']} misses {row['misses']} "
              f"fallbacks {row['fallbacks']} reasons {row['reasons']}")
        reasons.update(row["reasons"])
    print(f"[{tag}] decode-only tick check: "
          f"{ {k: v for k, v in check.items() if not k.startswith('profile')} }")
    for label in ("profile", "profile_plain"):
        prof = check[label]
        if not prof:
            print(f"[{tag}] {label}: the profiler saw no device event (not measured)")
            continue
        print(f"[{tag}] {label} of one decode-only tick: {prof['events']} device "
              f"events, busy {prof['busy_ms']:.2f} ms of a {prof['span_ms']:.2f} ms "
              f"span, idle share {prof['idle_share']:.3f}")
        for name, ms in prof["top_ms"].items():
            print(f"[{tag}]   {ms:8.3f} ms  {name}")
    k1_ms = check["profile"].get("matmul_ms")
    k1_ms = "not measured" if k1_ms is None else f"{k1_ms:.3f} ms"
    print(f"[{tag}] K1 in one decode-only tick: launches by variant "
          f"{check['matmul_variants']}; device time {k1_ms} (traced; "
          f"{FMA_TICK_K1_MS} ms before the split-K variant)")
    if moe:
        k2_ms = check["profile"].get("batch_matmul_ms")
        k2_ms = "not measured" if k2_ms is None else f"{k2_ms:.3f} ms"
        print(f"[{tag}] K2 in one decode-only tick: launches by variant "
              f"{check['batch_matmul_variants']}; device time {k2_ms} (traced, "
              f"{check['profile'].get('batch_matmul_events')} kernels told by grid)")
    k5_ms = check["profile"].get("decode_attention_ms")
    k5_ms = "not measured" if k5_ms is None else f"{k5_ms:.3f} ms"
    print(f"[{tag}] K5 in one decode-only tick: "
          f"{check['launches']['decode_flash_attention']} launches, device time "
          f"{k5_ms} (traced)")
    if check["profile"]:
        # dispatch hands every kernel f32 operands: a bf16 weight is cast on
        # each call, the tied embedding of the unembed too
        print(f"[{tag}] copies in one decode-only tick: {check['profile']['copy_ms']:.3f} "
              f"ms traced ({check['profile']['copy_events']} events)")
    print(f"[{tag}] one decode-only tick ({check['lanes']} lanes, host clock, median "
          f"of 3): dispatched {check['dispatched_ms']:.2f} ms, plain "
          f"{check['plain_ms']:.2f} ms (before rmsnorm was dispatched: dispatched "
          f"{NO_NORM_TICK_MS} ms)")
    if f32:
        print(f"[{tag}] greedy tokens equal to the plain run: {agree}/{total}; first "
              f"differences {differ}; the runs' logits differ by d = {d:.4e} of max "
              f"|logit| over {d_steps} steps")
    else:
        print(f"[{tag}] greedy tokens agreeing with the plain run: {agree}/{total} "
              f"({res['greedy_agreement']:.3f}; reported, not gated: bf16 plain vs "
              f"f32 kernels)")
    print(f"[{tag}] kernel launches while serving: {serve_counts}")
    total_mem = torch.cuda.get_device_properties(0).total_memory
    print(f"[{tag}] peak device memory allocated: "
          + ", ".join(f"{part} {n / 2**30:.2f} GiB" for part, n in peaks.items())
          + f" of {total_mem / 2**30:.2f}")
    if moe and f32:
        chunk_k2 = [k2 for k2, chunks, _ in tick_work if chunks]
        print(f"[{tag}] K2 launches while serving: {serve_counts['batch_matmul']} over "
              f"{len(tick_work)} model calls, {sum(chunk_k2)} of them in the "
              f"{len(chunk_k2)} calls with prompt chunks")
        if not chunk_k2 or any(k2 != 3 * cfg.n_layers for k2, _, _ in tick_work):
            fail(f"serving: K2 launches by model call {[t[0] for t in tick_work]}; want "
                 f"{3 * cfg.n_layers} in each, the chunks' included")
    for label, rs in (("dispatched", reqs), ("plain", plain_reqs)):
        served = sum(r.done and len(r.generated) == new_tokens for r in rs)
        if served != len(rs):
            fail(f"{label}: {served} of {len(rs)} requests finished with "
                 f"{new_tokens} tokens")
    if serve_counts["decode_flash_attention"] <= 0:
        fail("decode_flash_attention was not launched while serving")
    if serve_counts["matmul"] <= 0:
        fail("matmul was not launched while serving")
    if reasons.get("lowering_failed"):
        fail(f"{reasons['lowering_failed']} lowering_failed misses while serving")
    if check["matmul_variants"]["splitk"] != check["launches"]["matmul"]:
        fail(f"decode-only tick: K1 launches by variant {check['matmul_variants']}; "
             "every one should be splitk")
    # olmoe: the three expert products of every layer on K2's split-K
    # variant; smollm: no K2 (its plain decode contractions ride in K5)
    k2_want = 3 * cfg.n_layers if moe else 0
    if check["launches"]["batch_matmul"] != k2_want or \
            check["batch_matmul_variants"]["splitk"] != k2_want:
        fail(f"decode-only tick: {check['launches']['batch_matmul']} K2 launches, by "
             f"variant {check['batch_matmul_variants']}; want {k2_want} splitk")
    k5_tick = check["launches"]["decode_flash_attention"]
    if check["attention_decode_hits"] != cfg.n_layers or k5_tick != cfg.n_layers:
        fail(f"decode-only tick: {check['attention_decode_hits']} attention_decode "
             f"hits, {k5_tick} K5 launches; want {cfg.n_layers}")
    if check["rmsnorm_hits"] != norms:
        fail(f"decode-only tick: {check['rmsnorm_hits']} {norm_key} hits; want {norms}")
    for k, n in (tick_launches or {}).items():
        if check["launches"][k] != n:
            fail(f"decode-only tick: {check['launches'][k]} {k} launches; want {n}")
    if check["new_reasons"].get("lowering_failed") or check["new_reasons"].get("not_in_slice"):
        fail(f"decode-only tick reasons {check['new_reasons']}")
    if moe and not f32:
        flips = sum(check["flips_by_layer"])
        print(f"[{tag}] decode-only tick in f32: max_rel_err "
              f"{check['f32_max_rel_err']:.4e} (tol {TOL_LOGITS_REL:g} when no token's "
              f"routing differs); routing flips by layer {check['flips_by_layer']}; "
              f"bf16 max_rel_err {check['max_rel_err']:.4e} (reported, not gated)")
        if not check["f32_finite"] or (not flips and check["f32_max_rel_err"] > TOL_LOGITS_REL):
            fail(f"decode-only tick f32 logits rel err {check['f32_max_rel_err']}, "
                 f"{flips} routing flips")
    elif f32:
        flips = sum(check.get("flips_by_layer", ()))
        print(f"[{tag}] decode-only tick, served in f32: max_rel_err "
              f"{check['max_rel_err']:.4e} (tol {TOL_F32_LOGITS_REL:g}"
              + (f" where no routing differs); routing flips by layer "
                 f"{check['flips_by_layer']}" if moe else ")"))
        if not check["finite"] or (not flips and not check["max_rel_err"] <= TOL_F32_LOGITS_REL):
            fail(f"decode-only tick f32 logits rel err {check['max_rel_err']} > "
                 f"{TOL_F32_LOGITS_REL}")
        if moe:
            layer_rel = check["moe_layer_max_rel_err"]
            print(f"[{tag}] each MoE layer of the tick dispatched against plain on the "
                  f"same f32 input: max_rel_err by layer {[f'{r:.2e}' for r in layer_rel]} "
                  f"(tol {tol_moe_rel(cfg):.3e})")
            if len(layer_rel) != cfg.n_layers or not all(
                    math.isfinite(r) and r <= tol_moe_rel(cfg) for r in layer_rel):
                fail(f"{cfg.name} MoE layers of the tick against plain: {layer_rel}")
        if not d <= TOL_F32_LOGITS_REL:
            fail(f"{cfg.name}: the dispatched f32 logits differ from plain by {d} of "
                 f"max |logit|, over {TOL_F32_LOGITS_REL}")
        ties = [t for t in differ if t["top2_gap"] > 2 * d]
        if ties:
            fail(f"{cfg.name}: streams differ where the plain top-2 gap exceeds 2d = "
                 f"{2 * d:.3e}: {ties}")
    elif tick32:
        print(f"[{tag}] decode-only tick in f32: max_rel_err {check['f32_max_rel_err']:.4e} "
              f"(tol {TOL_F32_LOGITS_REL:g}); bf16 max_rel_err {check['max_rel_err']:.4e} "
              "(reported, not gated)")
        if not check["f32_finite"] or not check["f32_max_rel_err"] <= TOL_F32_LOGITS_REL:
            fail(f"decode-only tick f32 logits rel err {check['f32_max_rel_err']} > "
                 f"{TOL_F32_LOGITS_REL}")
    elif not check["finite"] or check["max_rel_err"] > TOL_LOGITS_REL:
        fail(f"decode-only tick logits rel err {check['max_rel_err']} > {TOL_LOGITS_REL}")
    return tasks, best, res, tune_counts, runs


# ---------------------------------------------------------------------------
# phases 9-10: the mamba2-370m paths
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def dispatch_reasons(by_key) -> Counter:
    """Every key's and site's dispatch reasons, summed."""
    return sum((Counter(row["reasons"]) for row in by_key.values()), Counter())


def slot_recording(sched, prompts, new_tokens: int, long_prompt: int):
    """Serve ``prompts`` on a slot-arena scheduler to the end, recording for
    every token generated the logits row it was sampled from (kept on the
    device) and that row's top-2 gap over its max |logit|, K7's launches in
    the prefill of the ``long_prompt``-token prompt, and a copy of the first
    decode tick's inputs with every slot live.  Returns (requests, gaps,
    rows, wall s, that prefill's K7 launches, the tick's snapshot)."""
    import torch

    model = sched.model
    prefill, decode_step = model.prefill, model.decode_step
    log = {"prefills": [], "tick": None, "snap": None, "long_ssd": None}

    def top2_gaps(logits):
        rows = logits[:, 0].float()
        top2 = rows.topk(2, -1).values
        return logits[:, 0], ((top2[:, 0] - top2[:, 1]) / rows.abs().amax(-1)).tolist()

    def recording_prefill(params, cache, tokens, **kwargs):
        n0 = _wrappers()["ssd"].launches
        logits, cache = prefill(params, cache, tokens, **kwargs)
        if tokens.shape[1] == long_prompt:
            log["long_ssd"] = _wrappers()["ssd"].launches - n0
        log["prefills"].append(top2_gaps(logits))
        return logits, cache

    def recording_decode(params, cache, tokens):
        if log["snap"] is None and len(sched.active) == sched.n_slots:
            log["snap"] = dict(toks=tokens.clone(),
                               cache={k: v.clone() for k, v in cache.items()})
        logits, cache = decode_step(params, cache, tokens)
        # the tick's lanes, read before sampling releases any
        log["tick"] = top2_gaps(logits) + ({r.rid: s for s, r in sched.active.items()},)
        return logits, cache

    model.prefill, model.decode_step = recording_prefill, recording_decode
    reqs = [sched.submit(p, max_new_tokens=new_tokens) for p in prompts]
    gaps, rows = [[] for _ in reqs], [[] for _ in reqs]
    n_prefills = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        while sched.pending():
            before = [len(r.generated) for r in reqs]
            sched.step()
            # the step's prefills ran in submission order, each giving its
            # request's first token; its decode tick gave one to each live lane
            for i, (r, n) in enumerate(zip(reqs, before)):
                new = len(r.generated) - n
                if new and n == 0:
                    row, gap = log["prefills"][n_prefills]
                    n_prefills += 1
                    rows[i].append(row[0].clone())
                    gaps[i].append(gap[0])
                    new -= 1
                if new:
                    row, gap, slots = log["tick"]
                    rows[i].append(row[slots[r.rid]].clone())
                    gaps[i].append(gap[slots[r.rid]])
    finally:
        del model.prefill, model.decode_step
    torch.cuda.synchronize()
    return reqs, gaps, rows, time.perf_counter() - t0, log["long_ssd"], log["snap"]


def phase_ssm_serve(cfg, db, gen_seed: int = 0, tag: str = "ssm-serve",
                    n_tasks: int = SSM_DECODE_TASKS, max_seq: int = SERVE_MAX_SEQ,
                    long_prompt: int = 128, f32: bool = False,
                    new_tokens: int = SERVE_NEW_TOKENS, tick_launches=None):
    """Phase 10 (mamba2-370m) or 24 (hymba-1.5b): the model's ``n_tasks``
    decode tasks (batch 4, ``max_seq``) tuned and their tiles checked, then
    8 requests served on the slot arena under the tuned context and with no
    context: 7 prompts of one SSD chunk (16-64 tokens) and one of
    ``long_prompt`` tokens (whole chunks of 64), ``new_tokens`` each, greedy;
    then the first decode tick with every slot live replayed on copies of
    its arena, compared, timed and traced both ways.  With ``f32`` both runs
    serve the parameters cast to f32, and each dispatched stream must equal
    the plain one or differ first where the plain top-2 logits are within
    2d of max |logit|, d the largest difference of the two runs' logits
    over the steps whose streams agree before them (phase 18's rule), with
    d itself within ``TOL_F32_LOGITS_REL``; in bf16 the streams are
    reported only.  A model with attention (hymba, whose windows the
    reference traces) must note ``traced_window`` at its decode attention
    once a layer a tick and launch K5 never; ``tick_launches`` holds the
    replayed tick's launches a kernel."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.models import transformer as T
    from repro_torch.search.database import workload_key
    from repro_torch.serving import ContinuousBatchingScheduler, KVArena, ServeConfig

    def extract():
        tasks = repro_torch.extract_decode_tasks(cfg, batch=SERVE_SLOTS, max_seq=max_seq)
        if len(tasks) != n_tasks:
            fail(f"{cfg.name} decode extraction gave {len(tasks)} tasks, want "
                 f"the reference's {n_tasks}")
        return tasks

    tasks, best = phase_tune(cfg, db, extract=extract, tag=f"{tag}-tune")
    tune_counts = read_counts()
    runs = check_tiles(tasks, db)
    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    serve_cfg = cfg
    if f32:
        serve_cfg = dataclasses.replace(cfg, dtype="float32")
        params = _tree_map(lambda t: t.float(), params)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 65, SERVE_REQUESTS - 1).tolist() + [long_prompt]
    rng.shuffle(lens)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in lens]
    print(f"[{tag}] {SERVE_REQUESTS} requests, prompt lengths {lens}, {new_tokens} new "
          f"tokens each, greedy, max_seq {max_seq}, "
          f"{'f32' if f32 else 'bf16'} parameters, {cfg.n_layers} layers")

    def serve(dispatch):
        sched = ContinuousBatchingScheduler(serve_cfg, params, config=ServeConfig(
            max_slots=SERVE_SLOTS, max_seq=max_seq, dispatch=dispatch))
        if not isinstance(sched.arena, KVArena) or sched.config.prefill_chunk:
            fail(f"{cfg.name} is not served on the slot arena with whole prompts")
        return sched, *slot_recording(sched, prompts, new_tokens, long_prompt)

    ctx = path_context(db, tasks=tasks, backend="cuda")
    counts0 = read_counts()
    sched, reqs, gaps, rows, wall, long_ssd, snap = serve(ctx)
    serve_counts = {k: n - counts0[k] for k, n in read_counts().items()}
    stats, by_key = dict(ctx.stats), ctx.stats_by_key()
    plain_sched, plain_reqs, plain_gaps, plain_rows, plain_wall, _, _ = serve(None)
    done = sum(r.done and len(r.generated) == new_tokens for r in reqs)
    agree = total = 0
    differ = []
    for i, (r, pr) in enumerate(zip(reqs, plain_reqs)):
        for j, (a, b) in enumerate(zip(r.generated, pr.generated)):
            agree, total = agree + (a == b), total + 1
        first = next((j for j, (a, b) in enumerate(zip(r.generated, pr.generated))
                      if a != b), None)
        if first is not None:
            differ.append(dict(request=i, step=first, top2_gap=plain_gaps[i][first]))
    d, d_steps = logit_spread((plain_reqs, plain_rows), (reqs, rows))
    del rows, plain_rows
    ttft = [r.ttft_s for r in reqs]
    plain_ttft = [r.ttft_s for r in plain_reqs]
    norm_key = workload_key("rmsnorm", d=cfg.d_model, eps=cfg.norm_eps, tokens=SERVE_SLOTS)
    norm_hits = by_key.get(norm_key, {}).get("hits", 0)
    reasons = dispatch_reasons(by_key)
    decode_reasons = by_key.get("site:attention_decode", {}).get("reasons", {})
    s = sched.stats
    timing_ctx = path_context(db, tasks=tasks, backend="cuda")
    attn_key = workload_key("attention_decode", b=SERVE_SLOTS, h=cfg.n_heads,
                            kvh=cfg.n_kv_heads, t=T.cache_max_len(cfg, max_seq),
                            d=cfg.head_dim, softcap=float(cfg.attn_softcap or 0.0))
    tick = decode_only_tick(sched, snap, ctx, timing_ctx, attn_key, norm_key, runs)
    res = dict(
        requests=len(reqs), completed=done, prompt_lens=lens, wall_s=wall,
        plain_wall_s=plain_wall, decode_steps=s["decode_steps"], f32=f32,
        decode_tok_s=sched.decode_tok_s, prefill_tok_s=sched.prefill_tok_s,
        plain_decode_tok_s=plain_sched.decode_tok_s,
        plain_prefill_tok_s=plain_sched.prefill_tok_s,
        ttft_p50_s=float(np.percentile(ttft, 50)),
        ttft_p95_s=float(np.percentile(ttft, 95)),
        plain_ttft_p50_s=float(np.percentile(plain_ttft, 50)),
        plain_ttft_p95_s=float(np.percentile(plain_ttft, 95)),
        greedy_equal=agree, greedy_total=total, first_differences=differ,
        logit_spread=d, logit_spread_steps=d_steps, rmsnorm_hits=norm_hits,
        decode_attention_reasons=decode_reasons, long_prompt_ssd_launches=long_ssd,
        stats=stats, launches=serve_counts, tick_check=tick,
    )
    print(f"[{tag}] completed {done}/{len(reqs)} requests in {wall:.2f} s "
          f"({s['decode_steps']} decode ticks on the slot arena)")
    print(f"[{tag}] dispatched: decode {sched.decode_tok_s:.1f} tok/s, prefill "
          f"{sched.prefill_tok_s:.1f} tok/s, TTFT p50 {res['ttft_p50_s'] * 1e3:.1f} ms "
          f"p95 {res['ttft_p95_s'] * 1e3:.1f} ms")
    print(f"[{tag}] plain: decode {plain_sched.decode_tok_s:.1f} tok/s, prefill "
          f"{plain_sched.prefill_tok_s:.1f} tok/s, TTFT p50 "
          f"{res['plain_ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{res['plain_ttft_p95_s'] * 1e3:.1f} ms, wall {plain_wall:.2f} s")
    for key, row in by_key.items():
        print(f"[{tag}]   {key}: hits {row['hits']} misses {row['misses']} "
              f"fallbacks {row['fallbacks']} reasons {row['reasons']}")
    print(f"[{tag}] greedy tokens equal to the plain run: {agree}/{total}; first "
          f"differences {differ}; the runs' logits differ by d = {d:.4e} of max "
          f"|logit| over {d_steps} steps"
          + ("" if f32 else " (reported, not gated: bf16 plain vs f32 kernels)"))
    print(f"[{tag}] kernel launches while serving: {serve_counts} (ssd: "
          f"{cfg.n_layers} a prefill x {len(reqs)} requests = "
          f"{cfg.n_layers * len(reqs)} expected; {long_ssd} in the {long_prompt}-token "
          "prompt's prefill)")
    tp = tick["profile"]
    print(f"[{tag}] decode-only tick ({tick['lanes']} lanes): dispatched "
          f"{tick['dispatched_ms']:.2f} ms, plain {tick['plain_ms']:.2f} ms (median of "
          f"3); logits max_rel_err {tick['max_rel_err']:.4e}; launches "
          f"{tick['launches']}; new reasons {tick['new_reasons']}"
          + (f"; traced busy {tp['busy_ms']:.2f} ms of {tp['span_ms']:.2f} ms, idle "
             f"{tp['idle_share']:.3f}, K1 {tp['matmul_ms']:.3f} ms" if tp else ""))
    if done != len(reqs):
        fail(f"{cfg.name}: {done} of {len(reqs)} requests finished with "
             f"{new_tokens} tokens")
    if serve_counts["ssd"] != cfg.n_layers * len(reqs) or long_ssd != cfg.n_layers:
        fail(f"{cfg.name} serving launched ssd {serve_counts['ssd']} times, "
             f"{long_ssd} in the long prompt's prefill")
    if serve_counts["matmul"] <= 0 or norm_hits <= 0:
        fail(f"{cfg.name} serving: matmul launches {serve_counts['matmul']}, "
             f"{norm_hits} rmsnorm hits")
    if reasons.get("lowering_failed"):
        fail(f"{cfg.name} serving: {reasons['lowering_failed']} lowering_failed misses")
    if not tick["finite"]:
        fail(f"{cfg.name}: the replayed tick's logits are not finite")
    if not cfg.attn_free:
        want = {"traced_window": cfg.n_layers * s["decode_steps"]}
        if decode_reasons != want or serve_counts["decode_flash_attention"] != 0:
            fail(f"{cfg.name} serving: decode attention reasons {decode_reasons}, want "
                 f"{want}; K5 launched {serve_counts['decode_flash_attention']} times")
        if tick["new_reasons"].get("traced_window") != cfg.n_layers:
            fail(f"{cfg.name} tick: new reasons {tick['new_reasons']}, want "
                 f"traced_window once a layer")
    for k, n in (tick_launches or {}).items():
        if tick["launches"][k] != n:
            fail(f"{cfg.name} tick launched {k} {tick['launches'][k]} times, want {n}")
    if f32:
        if not d <= TOL_F32_LOGITS_REL:
            fail(f"{cfg.name}: the dispatched f32 logits differ from plain by {d} of "
                 f"max |logit|, over {TOL_F32_LOGITS_REL}")
        ties = [t for t in differ if t["top2_gap"] > 2 * d]
        if ties:
            fail(f"{cfg.name}: streams differ where the plain top-2 gap exceeds 2d = "
                 f"{2 * d:.3e}: {ties}")
        if not tick["max_rel_err"] <= TOL_F32_LOGITS_REL:
            fail(f"{cfg.name} tick: f32 logits rel err {tick['max_rel_err']}")
    return tasks, best, res, tune_counts, runs


# ---------------------------------------------------------------------------
# phases 11-12: the olmoe-1b-7b paths
# ---------------------------------------------------------------------------


@contextmanager
def moe_routes(record: list, inputs: list = None):
    """While active, every ``layers.moe`` call appends its gate indices
    (T, k) to ``record`` (and its input to ``inputs``): the same routing,
    run again on the same input, plain (its einsum is never dispatched)."""
    from repro_torch.models import layers as L

    moe = L.moe

    def spy(p, x, top_k, *args, **kw):
        record.append(L.moe_route(p, x.reshape(-1, x.shape[-1]), top_k)[1])
        if inputs is not None:
            inputs.append(x.detach().clone())
        return moe(p, x, top_k, *args, **kw)

    L.moe = spy
    try:
        yield record
    finally:
        L.moe = moe


def routing_flips(a: list, b: list) -> list:
    """Per layer, the tokens whose set of chosen experts differs between
    two runs' gate indices."""
    if len(a) != len(b):
        fail(f"routing recorded for {len(a)} and {len(b)} MoE calls")
    return [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b)]


def tol_moe_rel(cfg) -> float:
    """One MoE layer dispatched against plain on the same f32 input,
    relative to the output's largest magnitude: K·2^-24 at the widest K of
    its expert products (max(d_model, d_ff)), the bound on the relative
    rounding error of one f32 dot product of K terms, summed in another
    order: 2048·2^-24 for olmoe-1b-7b (d_model 2048, d_ff 1024), 7168·2^-24
    = 4.27e-4 for arctic-480b (d_model 7168, d_ff 4864)."""
    return max(cfg.d_model, cfg.d_ff) * 2.0**-24


def moe_layer_errors(cfg, params32, inputs: list, ctx) -> list:
    """Each MoE layer of the f32 ``params32`` on its recorded input
    (``inputs[i]``, layer i's) under ``ctx`` against the same layer plain:
    its max_rel_err.  Routing runs plain in both, so on the same input it is
    the same by construction; the dispatched layer must launch K2 three
    times (wi, wg and wo)."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    rel = []
    for i, h2 in enumerate(inputs):
        p = T._layer(params32["layers"], i)["moe"]
        args = (cfg.moe_top_k, cfg.moe_capacity_factor)
        want = L.moe(p, h2, *args, act=cfg.act)
        n = read_counts()["batch_matmul"]
        with ctx:
            got = L.moe(p, h2, *args, act=cfg.act)
        torch.cuda.synchronize()
        if read_counts()["batch_matmul"] - n != 3:
            fail(f"{cfg.name} layer {i}: the dispatched MoE launched K2 "
                 f"{read_counts()['batch_matmul'] - n} times, want 3")
        rel.append(float((got - want).abs().max() / want.abs().max()))
    return rel


def phase_moe_forward(cfg, db, gen_seed: int = 0):
    """Phase 11: olmoe-1b-7b's 11 forward tasks tuned and their tiles
    checked, then the full-width bf16 forward at ``cfg.n_layers`` under the
    tuned context (K2 three times a layer, K3 once, all fma) against the same forward
    with no context, traced; then the numerical check in f32: each MoE
    layer dispatched against plain on the same input, and the whole
    forward with each layer's routing flips counted."""
    import torch

    import repro_torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    def extract():
        tasks = repro_torch.extract_tasks(cfg, batch=BATCH, seq=SEQ)
        if len(tasks) != MOE_FORWARD_TASKS:
            fail(f"{cfg.name} forward extraction gave {len(tasks)} tasks, want the "
                 f"reference's {MOE_FORWARD_TASKS}")
        return tasks

    tasks, best = phase_tune(cfg, db, extract=extract, tag="moe-tune")
    tune_counts = read_counts()
    print(f"[moe-tune] batch_matmul launches by variant while tuning: "
          f"{read_variants('batch_matmul')}")
    runs = check_tiles(tasks, db)
    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(gen_seed + 1)
    toks = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g, device="cuda")

    n_moe = 3 * cfg.n_layers  # wi, wg and wo of every layer
    with torch.no_grad():
        T.forward(cfg, params, toks)  # warm the plain path
        plain, plain_ms = timed_ms(lambda: T.forward(cfg, params, toks))
        ctx = path_context(db, tasks=tasks, backend="cuda")
        counts0 = read_counts()
        k1v0, k2v0, k3v0 = (read_variants(k) for k in VARIANT_KERNELS)
        with ctx:
            tuned = T.forward(cfg, params, toks)
        torch.cuda.synchronize()
        fwd_counts = {k: n - counts0[k] for k, n in read_counts().items()}
        k1v = variants_since(k1v0)
        k2v = variants_since(k2v0, "batch_matmul")
        k3v = variants_since(k3v0, "flash_attention")
        stats, by_key = dict(ctx.stats), ctx.stats_by_key()  # this one forward
        with ctx:
            _, tuned_ms = timed_ms(lambda: T.forward(cfg, params, toks))
        timing_ctx = path_context(db, tasks=tasks, backend="cuda")

        def traced_fwd():
            with timing_ctx:
                T.forward(cfg, params, toks)

        grids = k2_grids(runs, [k for k, row in by_key.items() if row["hits"]])
        profiles = dict(dispatched=profile_device(traced_fwd, grids),
                        plain=profile_device(lambda: T.forward(cfg, params, toks)))
        bf16_rel = float((tuned.float() - plain.float()).abs().max()
                         / plain.float().abs().max())
        finite = bool(torch.isfinite(tuned.float()).all())
        shape = tuple(tuned.shape)
        del plain, tuned
        # the numerical check, in f32 (the f32 parameters take 27.6 GB; the
        # bf16 ones go first).  Routing runs plain in both runs of a layer,
        # so on the same input it is the same by construction
        params32 = cast_f32_(params)
        del params
        torch.cuda.empty_cache()
        routes_t, routes_p, inputs = [], [], []
        with moe_routes(routes_t, inputs), path_context(
                db, tasks=tasks, backend="cuda"):
            tuned32 = T.forward(cfg, params32, toks)
        with moe_routes(routes_p):
            plain32 = T.forward(cfg, params32, toks)
        flips = routing_flips(routes_t, routes_p)
        layer_rel = moe_layer_errors(cfg, params32, inputs,
                                     path_context(db, tasks=tasks, backend="cuda"))
        del params32, inputs
        torch.cuda.empty_cache()
    diff = (tuned32 - plain32).abs()
    max_abs = float(diff.max())
    rel = max_abs / float(plain32.abs().max())
    reasons = dispatch_reasons(by_key)
    k2_ms = profiles["dispatched"].get("batch_matmul_ms")
    print(f"[moe-forward] logits {shape}: bf16 max_rel_err {bf16_rel:.4e} against the "
          f"plain bf16 forward (reported, not gated: routing flips); in f32 max_abs_err "
          f"{max_abs:.4e} max_rel_err {rel:.4e} (tol {TOL_LOGITS_REL:g} when no token's "
          f"routing differs)")
    print(f"[moe-forward] routing flips by layer between the dispatched and the plain "
          f"f32 forward ({BATCH * SEQ} tokens, top-{cfg.moe_top_k} of "
          f"{cfg.moe_experts}): {flips}")
    print(f"[moe-forward] each MoE layer dispatched against plain on the same f32 "
          f"input: max_rel_err by layer {[f'{r:.2e}' for r in layer_rel]} (tol "
          f"{tol_moe_rel(cfg):.3e})")
    print(f"[moe-forward] plain {plain_ms:.2f} ms, dispatched {tuned_ms:.2f} ms "
          f"(median of 3, batch {BATCH} seq {SEQ}, {cfg.n_layers} layers)")
    for key, row in by_key.items():
        print(f"[moe-forward]   {key}: hits {row['hits']} misses {row['misses']} "
              f"fallbacks {row['fallbacks']} reasons {row['reasons']}")
    for label, prof in profiles.items():
        if not prof:
            print(f"[moe-forward] {label}: the profiler saw no device event (not measured)")
            continue
        print(f"[moe-forward] profile of one {label} forward: {prof['events']} device "
              f"events, busy {prof['busy_ms']:.2f} ms of a {prof['span_ms']:.2f} ms "
              f"span, idle share {prof['idle_share']:.3f}")
        for name, ms in prof["top_ms"].items():
            print(f"[moe-forward]   {ms:8.3f} ms  {name}")
    print(f"[moe-forward] kernel launches in one dispatched forward: {fwd_counts}; by "
          f"variant K1 {k1v}, K2 {k2v}, K3 {k3v}; K2 traced "
          + ("not measured" if k2_ms is None else
             f"{k2_ms:.3f} ms over {profiles['dispatched']['batch_matmul_events']} "
             "kernels told by grid"))
    if not finite or shape != (BATCH, SEQ, cfg.vocab):
        fail(f"{cfg.name} dispatched logits not finite or of shape {shape}")
    if fwd_counts["batch_matmul"] != n_moe or sum(k2v.values()) != n_moe:
        fail(f"{cfg.name} forward launched K2 {fwd_counts['batch_matmul']} times "
             f"({k2v}), want {n_moe}")
    if fwd_counts["flash_attention"] != cfg.n_layers or k3v.get("fma") != cfg.n_layers:
        fail(f"{cfg.name} forward launched K3 {fwd_counts['flash_attention']} times "
             f"({k3v}), want {cfg.n_layers} fma")
    if k2_ms is not None and profiles["dispatched"]["batch_matmul_events"] != n_moe:
        fail(f"{cfg.name}: {profiles['dispatched']['batch_matmul_events']} K2 kernels "
             f"traced, want {n_moe}")
    if reasons.get("lowering_failed"):
        fail(f"{cfg.name} forward: {reasons['lowering_failed']} lowering_failed misses")
    if len(layer_rel) != cfg.n_layers or not all(math.isfinite(r) and r <= tol_moe_rel(cfg)
                                                 for r in layer_rel):
        fail(f"{cfg.name} MoE layers dispatched against plain: {layer_rel}")
    if not sum(flips) and not rel <= TOL_LOGITS_REL:
        fail(f"{cfg.name} f32 logits rel err {rel} > {TOL_LOGITS_REL} with no routing flip")
    res = dict(max_abs_err=max_abs, max_rel_err=rel, bf16_max_rel_err=bf16_rel,
               routing_flips=flips, moe_layer_max_rel_err=layer_rel,
               plain_ms=plain_ms, dispatched_ms=tuned_ms, stats=stats,
               reasons=dict(reasons), profiles=profiles, launches=fwd_counts,
               matmul_variants=k1v, batch_matmul_variants=k2v,
               flash_attention_variants=k3v, batch_matmul_traced_ms=k2_ms,
               tasks=len(tasks))
    return tasks, best, res, tune_counts, fwd_counts, runs


# ---------------------------------------------------------------------------
# phases 13 and 14: the training paths
# ---------------------------------------------------------------------------


def _device_batch(batch: dict) -> dict:
    import torch

    return {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}


def grad_errors(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| over its max |want| (the tolerance's
    scale), by path."""
    from repro_torch.training import checkpoint as ckpt

    want = dict(ckpt._flatten_with_paths(want))
    return {path: float((g.float() - want[path].float()).abs().max()
                        / want[path].float().abs().max().clamp_min(1e-30))
            for path, g in ckpt._flatten_with_paths(got)}


def update_errors(got: dict, want: dict) -> tuple:
    """(max |got - want| over the parameter leaves, elements off by more
    than 1e-6, elements in all)."""
    from repro_torch.training.optimizer import tree_leaves

    worst, far, total = 0.0, 0, 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = (a.float() - b.float()).abs()
        worst = max(worst, float(d.max()))
        far += int((d > 1e-6).sum())
        total += d.numel()
    return worst, far, total


def step_wall_ms(fn, n: int = 3) -> float:
    import torch

    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] * 1e3


def phase_train(cfg, gen, db=None, gen_seed: int = 0, tag: str = "train",
                n_tasks: int = TRAIN_TASKS, plain_keys=(), want=None,
                scan_leaves=(), launcher: bool = False):
    """Phases 13 (smollm-135m), 14 (mamba2-370m) and 27 (hymba-1.5b): a
    train step at batch 8, seq 128.  With ``db``, the reference's
    ``n_tasks`` tasks tuned (but those of ``plain_keys``, and those beyond
    the schedule caps) and their tiles checked.  One step of the entry
    point, ``make_train_step``, on f32 parameters with the tuned kernels
    (under the tuned context, and K7 for the SSD scan: forward the kernel,
    backward the plain version's autograd) against the plain step (no
    context, the plain scan): the loss and the updated parameters, then
    every gradient leaf of the same step (``scan_leaves``, those that reach
    the loss only through the scan, named and non-zero).  The step's
    launches a kernel are ``want``'s (``flash_attention_tc``: K3's on
    ``tc``); its hits by key are ``want["hits"]``, or without them every
    extracted site's key twice (remat recomputes every layer) but the final
    norm's and the unembed's, outside the checkpointed layers, once;
    ``want["reasons"]`` holds a key's or site's reasons exactly.  Then
    ``SSM_TRAIN_STEPS`` bf16 steps on one batch under the tuned context,
    each timed, whose loss must fall;
    with ``db`` the plain step timed beside them, one step of each traced,
    and phase 6 at the step's shapes (at every task's with ``launcher``,
    else at the keys the step hit); with ``launcher`` the launcher's
    ``main`` at full width for ``LAUNCHER_STEPS`` steps with a checkpoint
    every ``LAUNCHER_CKPT_EVERY``, and again from that checkpoint."""
    import shutil

    import torch

    import repro_torch
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.search.database import workload_key
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import OptConfig, adamw_init, schedule, tree_leaves
    from repro_torch.training.train_loop import make_train_step, value_and_grad

    want = dict(want or {})
    L = cfg.n_layers
    tasks, best, runs = [], {}, {}
    tune_counts = dict.fromkeys(KERNELS, 0)
    ctx = timing_ctx = None
    if db is not None:
        def extract():
            tasks = repro_torch.extract_tasks(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
            keys = {t.key for t in tasks}
            sfm = f"sfm/m={TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ}/n={TRAIN_SEQ}"
            if len(tasks) != n_tasks or sfm not in keys:
                fail(f"{cfg.name} training extraction gave {sorted(keys)}; want the "
                     f"reference's {n_tasks} tasks with {sfm}")
            return tasks

        tasks, best = phase_tune(cfg, db, extract=extract, tag=f"{tag}-tune",
                                 plain_keys=plain_keys)
        tune_counts = read_counts()
        runs = check_tiles(tasks, db)
        ctx = path_context(db, tasks=tasks, backend="cuda")
        timing_ctx = path_context(db, tasks=tasks, backend="cuda")
    model = build_model(cfg)
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=LAUNCHER_STEPS)
    lr1 = float(schedule(opt, 1))  # the first step's learning rate
    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    params32 = _tree_map(lambda t: t.float(), params)
    pipe = SyntheticTokenPipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=gen_seed)
    batch = _device_batch(pipe.batch_at(0))

    def loss_on(backend):
        return lambda p, b: T.loss_fn(cfg, p, b, ssd_backend=backend)

    # one step of the entry point on f32 parameters: make_train_step under
    # the tuned context (the scan on K7, model.loss's default) against the
    # plain step (no context, the plain scan); the path's launches, hits
    # and reasons are this step's
    step_d = make_train_step(model, opt, dispatch=ctx)
    step_p = make_train_step(SimpleNamespace(loss=loss_on("torch")), opt)
    counts0 = read_counts()
    variants0 = {k: read_variants(k) for k in VARIANT_KERNELS}
    new_k, _, m_k = step_d(params32, adamw_init(params32), batch)
    torch.cuda.synchronize()
    step_counts = {k: n - counts0[k] for k, n in read_counts().items()}
    variants = {k: variants_since(variants0[k], k) for k in VARIANT_KERNELS}
    by_key = ctx.stats_by_key() if ctx is not None else {}
    step_hits = dict(ctx.hits_by_key) if ctx is not None else {}
    new_t, _, m_t = step_p(params32, adamw_init(params32), batch)
    loss_k, loss_t = float(m_k["loss"]), float(m_t["loss"])
    loss_rel = abs(loss_k - loss_t) / abs(loss_t)
    worst, far, total = update_errors(new_k, new_t)
    del new_k, new_t
    # the same step's gradients, leaf by leaf (after the counts are read)
    with ctx if ctx is not None else nullcontext():
        _, g_k = value_and_grad(loss_on("cuda"), params32, batch)
    _, g_t = value_and_grad(loss_on("torch"), params32, batch)
    errs = grad_errors(g_k, g_t)
    scan = {name: (errs[f"layers/ssd/{name}"], float(g_k["layers"]["ssd"][name].abs().max()))
            for name in scan_leaves}
    del g_k, g_t, params32
    torch.cuda.empty_cache()
    if db is not None and "hits" not in want:
        # every site dispatched: the forward's sites twice (the forward,
        # remat's recompute), the final norm and the unembed once
        dense = {t.key: int(t.weight) for t in tasks if t.key.startswith("dense/")}
        norm_key = workload_key("rmsnorm", d=cfg.d_model, eps=cfg.norm_eps,
                                tokens=TRAIN_BATCH * TRAIN_SEQ)
        unembed_key = workload_key("dense", k=cfg.d_model, m=TRAIN_BATCH * TRAIN_SEQ,
                                   n=cfg.vocab)
        attn_key = next(t.key for t in tasks if t.key.startswith("attention/"))
        want["hits"] = {k: 2 * w - (k == unembed_key) for k, w in dense.items()}
        want["hits"][norm_key] = 2 * (2 * L) + 1
        want["hits"][attn_key] = 2 * L
        want.setdefault("matmul", sum(want["hits"][k] for k in dense))

    # bf16 steps on one batch under the tuned context, each timed
    opt_b = OptConfig(lr=1e-3, warmup_steps=1, total_steps=SSM_TRAIN_STEPS)
    step_t = make_train_step(model, opt_b, dispatch=timing_ctx)
    state, losses, walls = (params, adamw_init(params)), [], []
    for _ in range(SSM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step_t(*state, batch)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        state = (p, o)
    del state, p, o
    warm = sorted(walls[1:])
    dispatched_ms, plain_ms, profiles, rows = warm[len(warm) // 2], None, {}, {}
    if db is not None:
        # the plain step timed beside them, one step of each traced
        opt_state = adamw_init(params)
        step_p = make_train_step(model, opt_b)
        step_p(params, opt_state, batch)  # warm the plain path
        plain_ms = step_wall_ms(lambda: step_p(params, opt_state, batch))
        profiles = dict(dispatched=profile_device(lambda: step_t(params, opt_state, batch)),
                        plain=profile_device(lambda: step_p(params, opt_state, batch)))
        del opt_state
        # phase 6 at the step's shapes (for time, only at the keys the step
        # hit but on the smollm path)
        rows = phase_timings(tasks if launcher else [t for t in tasks if step_hits.get(t.key)],
                             runs, gen, cfg.vocab)

    res = dict(loss_dispatched=loss_k, loss_plain=loss_t, loss_rel=loss_rel,
               grad_rel_err=errs, scan_leaves=scan, update_max_abs=worst,
               update_far=far, update_elements=total, lr=lr1, launches=step_counts,
               matmul_variants=variants["matmul"],
               batch_matmul_variants=variants["batch_matmul"],
               flash_attention_variants=variants["flash_attention"], hits=step_hits,
               reasons={k: row["reasons"] for k, row in by_key.items()},
               bf16_losses=losses, bf16_step_wall_ms=walls, dispatched_ms=dispatched_ms,
               plain_ms=plain_ms, profiles=profiles, tasks=len(tasks), layers=L)
    print(f"[{tag}] one step at batch {TRAIN_BATCH} seq {TRAIN_SEQ}, {L} layers, f32 "
          f"parameters: loss tuned {loss_k:.6f} plain {loss_t:.6f} rel {loss_rel:.3e} (tol "
          f"{TOL_TRAIN_LOSS_REL:g})")
    print(f"[{tag}] gradient max err by leaf over the leaf's max |g| (tol "
          f"{TOL_TRAIN_GRAD:g}): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if scan:
        print(f"[{tag}] the leaves that reach the loss only through the scan: "
              + ", ".join(f"{k} err {e:.2e} max |g| {g:.3e}" for k, (e, g) in scan.items()))
    print(f"[{tag}] updated parameters: max |tuned - plain| {worst:.3e} (tol 2·lr = "
          f"{2 * lr1:.1e}); {far} of {total} elements differ by more than 1e-6")
    print(f"[{tag}] launches in one tuned step: {step_counts}; by variant K1 "
          f"{variants['matmul']}, K2 {variants['batch_matmul']}, K3 "
          f"{variants['flash_attention']}")
    for key, row in sorted(by_key.items()):
        print(f"[{tag}]   {key}: hits {row['hits']} misses {row['misses']} fallbacks "
              f"{row['fallbacks']} reasons {row['reasons']} (want "
              f"{want.get('hits', {}).get(key, 0)} hits)")
    print(f"[{tag}] {SSM_TRAIN_STEPS} bf16 steps on one batch: losses "
          f"{[round(x, 4) for x in losses]}; wall ms {[round(w, 2) for w in walls]}"
          + (f"; plain step wall ms {plain_ms:.2f} (median of 3)" if plain_ms else ""))
    for label, prof in profiles.items():
        if not prof:
            print(f"[{tag}] {label}: the profiler saw no device event (not measured)")
            continue
        print(f"[{tag}] profile of one {label} bf16 step: {prof['events']} device events, "
              f"busy {prof['busy_ms']:.2f} ms of a {prof['span_ms']:.2f} ms span, idle "
              f"share {prof['idle_share']:.3f}; K1 {prof['matmul_ms']:.3f} ms, K3 "
              f"{prof['flash_attention_ms']:.3f} ms, K7 {prof['ssd_ms']:.3f} ms, copies "
              f"{prof['copy_ms']:.3f} ms traced")
        for name, ms in prof["top_ms"].items():
            print(f"[{tag}]   {ms:8.3f} ms  {name}")

    bad = {k: v for k, v in errs.items() if not v <= TOL_TRAIN_GRAD}
    if not loss_rel <= TOL_TRAIN_LOSS_REL or bad:
        fail(f"{cfg.name} tuned step: loss rel {loss_rel}, gradient leaves out of "
             f"tolerance {bad}")
    if not all(g > 0 for _, g in scan.values()):
        fail(f"{cfg.name}: a scan leaf has no gradient: {scan}")
    if not worst <= 2 * lr1:
        fail(f"{cfg.name} tuned step: parameters {worst} from plain > 2·lr")
    for k in KERNELS:
        if k in want and step_counts[k] != want[k]:
            fail(f"{cfg.name} tuned step launched {k} {step_counts[k]} times, want {want[k]}")
    if "flash_attention_tc" in want and \
            variants["flash_attention"]["tc"] != want["flash_attention_tc"]:
        fail(f"{cfg.name} tuned step: K3 by variant {variants['flash_attention']}, want "
             f"{want['flash_attention_tc']} tc")
    if db is not None and step_hits != want["hits"]:
        fail(f"{cfg.name} tuned step hits {step_hits}, want {want['hits']}")
    for key, rs in want.get("reasons", {}).items():
        if by_key.get(key, {}).get("reasons") != rs:
            fail(f"{cfg.name} tuned step: {key} reasons {by_key.get(key, {}).get('reasons')}, "
                 f"want {rs}")
    if dispatch_reasons(by_key).get("lowering_failed"):
        fail(f"{cfg.name} tuned step: lowering_failed misses {dispatch_reasons(by_key)}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{cfg.name} bf16 losses do not fall: {losses}")
    if not launcher:
        return tasks, best, res, tune_counts, step_counts, rows

    # the launcher at full width, then resumed from its middle checkpoint
    ck_dir = ROOT / "build" / f"train_ckpt_{os.getpid()}"
    shutil.rmtree(ck_dir, ignore_errors=True)
    args = ["--steps", str(LAUNCHER_STEPS), "--ckpt-every", str(LAUNCHER_CKPT_EVERY),
            "--ckpt-dir", str(ck_dir), "--log-every", "5"]
    try:
        t0 = time.perf_counter()
        full = train_launcher.main(args)
        full_s = time.perf_counter() - t0
        saved = sorted(os.listdir(ck_dir))
        # a run cut after its middle checkpoint: the last was never written
        shutil.rmtree(ck_dir / f"step_{LAUNCHER_STEPS}")
        (ck_dir / "LATEST").write_text(str(LAUNCHER_CKPT_EVERY))
        resumed = train_launcher.main(args)
        # the save/restore round trip of the resumed run's last state
        _, state, _ = ckpt.restore(str(ck_dir), step=LAUNCHER_STEPS, device="cuda")
        ckpt.save(str(ck_dir), LAUNCHER_STEPS + 1, state)
        _, again, _ = ckpt.restore(str(ck_dir), step=LAUNCHER_STEPS + 1, device="cuda")
        round_trip = all(
            a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
            for a, b in zip(tree_leaves(state), tree_leaves(again)))
        n_leaves = len(tree_leaves(state))
        del state, again
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    batches_same = all(pipe.batch_at(k)["tokens"].tobytes()
                       == next(pipe.iter_from(k))["tokens"].tobytes()
                       for k in range(LAUNCHER_CKPT_EVERY, LAUNCHER_STEPS))
    resume_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[LAUNCHER_CKPT_EVERY:]))
    head, tail = full[:5], full[-5:]
    print(f"[{tag}] launcher: {LAUNCHER_STEPS} steps in {full_s:.1f} s, checkpoints "
          f"{saved}; losses {[round(x, 4) for x in full]}")
    print(f"[{tag}] resumed from step {LAUNCHER_CKPT_EVERY}: losses "
          f"{[round(x, 4) for x in resumed]}; max rel diff to the uninterrupted run "
          f"{resume_rel:.3e} (tol {TOL_RESUME_REL:g}); save/restore of {n_leaves} leaves "
          f"bitwise {round_trip}; resumed batches bitwise {batches_same}")
    if not all(math.isfinite(x) for x in full) or not sum(tail) < sum(head):
        fail(f"{cfg.name} launcher losses do not fall: {full}")
    if len(resumed) != LAUNCHER_STEPS - LAUNCHER_CKPT_EVERY or not resume_rel <= TOL_RESUME_REL:
        fail(f"{cfg.name} resumed losses {resumed} against {full[LAUNCHER_CKPT_EVERY:]}")
    if not (round_trip and batches_same):
        fail(f"{cfg.name}: checkpoint round trip bitwise {round_trip}, resumed batches "
             f"bitwise {batches_same}")
    res.update(launcher_losses=full, resumed_losses=resumed, resume_max_rel=resume_rel,
               launcher_s=full_s, checkpoint_round_trip=round_trip)
    return tasks, best, res, tune_counts, step_counts, rows


# ---------------------------------------------------------------------------
# phases 15 and 16: qwen2-vl-2b and whisper-medium
# ---------------------------------------------------------------------------


def model_inputs(cfg, batch: int, seed: int, seq: int = SEQ) -> dict:
    """The forward's inputs from a seeded generator: ``tokens`` (batch,
    seq) for a model that reads tokens; else the stub frontend's, bf16,
    ``embeds`` (batch, seq, D), and whisper's ``frames`` (batch, 1500, D),
    N(0, 1) as the reference's ``make_train_batch`` draws them."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    if not cfg.embedding_inputs:
        return {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                                        device="cuda")}
    ins = {"embeds": torch.randn(batch, seq, cfg.d_model, generator=g, device="cuda")}
    if cfg.enc_layers:
        ins["frames"] = torch.randn(batch, cfg.enc_frames, cfg.d_model, generator=g,
                                    device="cuda")
    return {k: v.to(torch.bfloat16) for k, v in ins.items()}


def phase_model_forward(cfg, db, tag: str, n_tasks: int, want: dict, gen_seed: int = 0,
                        seq: int = SEQ, plain_keys=(), runner_spec="cached+local",
                        tol: float = TOL_F32_LOGITS_REL, f32_layers: int = 0,
                        unschedulable=None):
    """Phase 9 (mamba2-370m), 15 (qwen2-vl-2b), 16 (whisper-medium), 20
    (gemma2-2b), 23 (hymba-1.5b), 25 (stablelm-3b), 28 (qwen1.5-110b) or 30
    (arctic-480b), the forward: the reference's
    ``n_tasks`` tasks (batch 1, ``seq`` tokens or embeddings; whisper's 1500
    frames) tuned and their tiles checked; the full-width bf16 forward under
    the tuned context against the plain forward (the SSD scan's plain
    version too), timed and traced; then both on the parameters cast to
    f32, held within ``tol``.  With ``f32_layers`` the f32 check runs on a
    model of that depth, drawn anew once the bf16 one is released.  An MoE
    model's routing flips between the two runs are counted by layer in
    both dtypes, and its f32 logits are held only where no token's routing
    differs (phase 11's rule).  ``want`` holds the dispatched forward's
    launches of each kernel it names (K1 ``matmul``, K2 ``batch_matmul``,
    K3 ``flash_attention``, K7 ``ssd``), K3's ``fma`` launches at least,
    the rmsnorm hits, the attention hits by key, and optionally
    ``hits`` (key: hits) and ``reasons`` (key or ``site:...``: its reasons
    exactly) and ``attention_fused`` (the backend's fused attention's
    count); the tasks of ``plain_keys`` are left plain, the others tuned
    through ``runner_spec`` (``phase_tune``; with ``unschedulable``, exactly
    those keys have no schedule).  The result's ``peak_bytes``
    holds the device memory allocated at the peak of the tuning, the bf16
    forward and the f32 check."""
    import torch

    import repro_torch
    from repro_torch.models import transformer as T

    moe = bool(cfg.moe_experts)

    def extract():
        tasks = repro_torch.extract_tasks(cfg, batch=BATCH, seq=seq)
        if len(tasks) != n_tasks:
            fail(f"{cfg.name} forward extraction gave {len(tasks)} tasks, want the "
                 f"reference's {n_tasks}")
        return tasks

    peaks = {}
    torch.cuda.reset_peak_memory_stats()
    tasks, best = phase_tune(cfg, db, extract=extract, tag=f"{tag}-tune",
                             runner_spec=runner_spec, plain_keys=plain_keys,
                             unschedulable=unschedulable)
    tune_counts = read_counts()
    runs = check_tiles(tasks, db)
    peaks["tuning"] = release_memory()
    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    ins = model_inputs(cfg, BATCH, gen_seed + 1, seq)

    def fwd(c, p):
        return T.forward(c, p, **ins)

    def plain_fwd(c, p):
        return T.forward(c, p, **ins, ssd_backend="torch")

    routes = {k: [] for k in ("bf16", "bf16_plain", "f32", "f32_plain")}
    with torch.no_grad():
        plain_fwd(cfg, params)  # warm the plain path
        plain, plain_ms = timed_ms(lambda: plain_fwd(cfg, params))
        ctx = path_context(db, tasks=tasks, backend="cuda")
        counts0 = read_counts()
        k1v0, k2v0, k3v0 = (read_variants(k) for k in VARIANT_KERNELS)
        with ctx, moe_routes(routes["bf16"]):
            tuned = fwd(cfg, params)
        torch.cuda.synchronize()
        fwd_counts = {k: n - counts0[k] for k, n in read_counts().items()}
        k1v = variants_since(k1v0)
        k2v = variants_since(k2v0, "batch_matmul")
        k3v = variants_since(k3v0, "flash_attention")
        stats, by_key = dict(ctx.stats), ctx.stats_by_key()  # this one forward
        if moe:
            with moe_routes(routes["bf16_plain"]):
                plain_fwd(cfg, params)
        with ctx:
            _, tuned_ms = timed_ms(lambda: fwd(cfg, params))
        timing_ctx = path_context(db, tasks=tasks, backend="cuda")

        def traced_fwd():
            with timing_ctx:
                fwd(cfg, params)

        grids = k2_grids(runs, [k for k, row in by_key.items() if row["hits"]])
        profiles = dict(dispatched=profile_device(traced_fwd, grids),
                        plain=profile_device(lambda: plain_fwd(cfg, params)))
        bf16_rel = float((tuned.float() - plain.float()).abs().max()
                         / plain.float().abs().max())
        finite = bool(torch.isfinite(tuned.float()).all())
        shape = tuple(tuned.shape)
        del tuned
        peaks["bf16"] = release_memory()
        # the numerical check in f32: the config's dtype too, which the
        # embeddings and frames are cast to
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        if f32_layers and f32_layers != cfg.n_layers:
            del params
            release_memory()
            cfg32 = dataclasses.replace(cfg32, n_layers=f32_layers)
            params = T.init_params(cfg32, seed=gen_seed, device="cuda")
        params32 = cast_f32_(params)
        del params
        torch.cuda.empty_cache()
        with path_context(db, tasks=tasks, backend="cuda"), moe_routes(routes["f32"]):
            tuned32 = fwd(cfg32, params32)
        with moe_routes(routes["f32_plain"]):
            plain32 = plain_fwd(cfg32, params32)
        del params32
        peaks["f32"] = release_memory()
    max_abs = float((tuned32 - plain32).abs().max())
    rel = max_abs / float(plain32.abs().max())
    # the yardstick of the bf16 line: how far bf16 rounding alone moves the
    # plain forward from the same forward in f32 (at one depth)
    bf16_floor = None
    if cfg32.n_layers == cfg.n_layers:
        bf16_floor = float((plain.float() - plain32).abs().max() / plain32.abs().max())
    del tuned32, plain32, plain
    flips = {k: routing_flips(routes[k], routes[f"{k}_plain"]) for k in ("bf16", "f32")}
    reasons = dispatch_reasons(by_key)
    norm_hits = sum(row["hits"] for key, row in by_key.items()
                    if key.startswith("rmsnorm/"))
    attn_hits = {key: row["hits"] for key, row in by_key.items()
                 if key.startswith("attention/")}
    floor = "" if bf16_floor is None else (
        f"; the plain bf16 forward is {bf16_floor:.4e} from the plain f32 one")
    print(f"[{tag}] logits {shape}: f32 max_abs_err {max_abs:.4e} max_rel_err "
          f"{rel:.4e} (tol {tol:g}{' where no routing differs' if moe else ''}) at "
          f"{cfg32.n_layers} layers; bf16 max_rel_err {bf16_rel:.4e} against the plain "
          f"bf16 forward at {cfg.n_layers} (reported, not gated{floor})")
    if moe:
        print(f"[{tag}] routing flips by layer between the dispatched and the plain "
              f"forward ({BATCH * seq} tokens, top-{cfg.moe_top_k} of {cfg.moe_experts}): "
              f"bf16 {flips['bf16']} (reported, not gated), f32 {flips['f32']}")
    print(f"[{tag}] plain {plain_ms:.2f} ms, dispatched {tuned_ms:.2f} ms (median of "
          f"3, batch {BATCH} seq {seq}, {cfg.n_layers} layers"
          + (f" and {cfg.enc_layers} encoder layers over {cfg.enc_frames} frames)"
             if cfg.enc_layers else ")"))
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[{tag}] peak device memory allocated: "
          + ", ".join(f"{part} {n / 2**30:.2f} GiB" for part, n in peaks.items())
          + f" of {total / 2**30:.2f}")
    for key, row in by_key.items():
        print(f"[{tag}]   {key}: hits {row['hits']} misses {row['misses']} "
              f"fallbacks {row['fallbacks']} reasons {row['reasons']}")
    for label, prof in profiles.items():
        if not prof:
            print(f"[{tag}] {label}: the profiler saw no device event (not measured)")
            continue
        print(f"[{tag}] profile of one {label} forward: {prof['events']} device "
              f"events, busy {prof['busy_ms']:.2f} ms of a {prof['span_ms']:.2f} ms "
              f"span, idle share {prof['idle_share']:.3f}; traced K1 "
              f"{prof['matmul_ms']:.3f} ms, K2 {prof.get('batch_matmul_ms')} ms, K3 "
              f"{prof['flash_attention_ms']:.3f} ms, K7 {prof['ssd_ms']:.3f} ms, "
              f"copies {prof['copy_ms']:.3f} ms ({prof['copy_events']} events)")
        for name, ms in prof["top_ms"].items():
            print(f"[{tag}]   {ms:8.3f} ms  {name}")
    print(f"[{tag}] kernel launches in one dispatched forward: {fwd_counts}; by "
          f"variant K1 {k1v}, K2 {k2v}, K3 {k3v}; rmsnorm hits {norm_hits}; "
          f"attention hits {attn_hits}; backend fused attention "
          f"{stats['attention_fused']}")
    if not finite or shape != (BATCH, seq, cfg.vocab):
        fail(f"{cfg.name} dispatched logits not finite or of shape {shape}")
    if not math.isfinite(rel) or (not sum(flips["f32"]) and not rel <= tol):
        fail(f"{cfg.name} f32 logits rel err {rel} > {tol}"
             + (" with no routing flip" if moe else ""))
    for k in ("matmul", "batch_matmul", "flash_attention", "ssd"):
        if k in want and fwd_counts[k] != want[k]:
            fail(f"{cfg.name} forward launched {k} {fwd_counts[k]} times, want {want[k]}")
    if k3v["fma"] < want.get("flash_attention_fma", 0):
        fail(f"{cfg.name} forward: K3 by variant {k3v}, want at least "
             f"{want['flash_attention_fma']} fma")
    if norm_hits != want["rmsnorm"] or attn_hits != want["attention"]:
        fail(f"{cfg.name} forward: rmsnorm hits {norm_hits}, attention hits "
             f"{attn_hits}; want {want['rmsnorm']}, {want['attention']}")
    for key, n in want.get("hits", {}).items():
        if by_key.get(key, {}).get("hits", 0) != n:
            fail(f"{cfg.name} forward: {key} hit {by_key.get(key, {}).get('hits', 0)} "
                 f"times, want {n}")
    for key, rs in want.get("reasons", {}).items():
        if by_key.get(key, {}).get("reasons") != rs:
            fail(f"{cfg.name} forward: {key} reasons {by_key.get(key, {}).get('reasons')}, "
                 f"want {rs}")
    if "attention_fused" in want and stats["attention_fused"] != want["attention_fused"]:
        fail(f"{cfg.name} forward: the backend's fused attention ran "
             f"{stats['attention_fused']} times, want {want['attention_fused']}")
    if reasons.get("lowering_failed"):
        fail(f"{cfg.name} forward: {reasons['lowering_failed']} lowering_failed misses")
    res = dict(max_abs_err=max_abs, max_rel_err=rel, bf16_max_rel_err=bf16_rel,
               plain_bf16_vs_f32_rel=bf16_floor, f32_layers=cfg32.n_layers,
               plain_ms=plain_ms, dispatched_ms=tuned_ms, stats=stats,
               reasons=dict(reasons), profiles=profiles, launches=fwd_counts,
               matmul_variants=k1v, batch_matmul_variants=k2v,
               flash_attention_variants=k3v, rmsnorm_hits=norm_hits,
               attention_hits=attn_hits, tasks=len(tasks), peak_bytes=peaks)
    if moe:
        res["routing_flips"] = flips
    return tasks, best, res, tune_counts, fwd_counts, runs


def release_memory() -> int:
    """The device memory allocated at its peak since the last call (or the
    last ``reset_peak_memory_stats``), after which what is no longer
    referenced is released (a tuning's inputs, held by runners in
    reference cycles) and the peak reset."""
    import gc

    import torch

    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return peak


def cast_f32_(tree):
    """Cast every leaf of a parameter tree to f32 in place, leaf by leaf:
    each bf16 leaf is released once its f32 copy replaces it, so the peak
    is the f32 tree and one leaf's bf16 copy, not both trees (81.6 GB for
    one arctic-480b layer, over the card's 79.2 GiB).  Returns the tree,
    whose values are those of a cast of the whole tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            cast_f32_(v)
        else:
            tree[k] = v.float()
        del v
    return tree


def phase_hymba(cfg, gen, gen_seed: int = 0):
    """Phases 23-24, hymba-1.5b at full width and ``cfg.n_layers`` (over 4:
    its window pattern has no period): the forward (phase 23: 20 tasks,
    K2 at both attention contractions once a layer, ``traced_window`` at
    every layer's attention, K3 never, K7 once a layer, f32 within
    ``TOL_F32_LOGITS_REL``) and slot-arena serving in f32 across the
    1024-token window (phase 24); then phase 6 at its shapes (K1, K2, K4,
    and K7 at N 16 on the forward and on the long prompt's prefill with its
    state).  Returns (forward result, serving result, timing rows)."""
    import torch

    from repro_torch.models.transformer import layer_windows, window_period
    from repro_torch.search.database import Database, workload_key

    L = cfg.n_layers
    if window_period(layer_windows(cfg)) is not None:
        fail(f"{cfg.name} at {L} layers has a window period: the reference would "
             "serve its attention through K3")
    print(f"[hymba] {L} layers, windows {[int(w) for w in layer_windows(cfg)]} (no "
          "period: the reference traces them)")
    G, KVH = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads
    bmm = [workload_key("batch_matmul", b=BATCH * KVH, m=G * SEQ, n=n, k=k)
           for n, k in ((SEQ, cfg.head_dim), (cfg.head_dim, SEQ))]
    print(f"[hymba] the forward unembed {HYMBA_PLAIN_UNEMBED} is left plain: bn can "
          "only be 1 or 3 and the seeded searches draw no tile under the grid cap "
          "(HYMBA_PLAIN_UNEMBED)")
    db = Database()
    reset_counts()  # the hymba forward path starts here
    tasks, best, fwd, tune_counts, fwd_counts, runs = phase_model_forward(
        cfg, db, "hymba-forward", HYMBA_FORWARD_TASKS, dict(
            # q, k, v, o and the MLP's three, every layer (the unembed
            # plain; the SSD mixer's projections are plain einsums in both
            # packages, extracted as tuning targets); both chunked
            # attention contractions through K2, the SSD scan through K7;
            # the norm plain
            matmul=7 * L, batch_matmul=2 * L, flash_attention=0, ssd=L,
            rmsnorm=0, attention={}, hits={k: L for k in bmm},
            reasons={"site:attention": {"traced_window": L}}, attention_fused=0),
        plain_keys=(HYMBA_PLAIN_UNEMBED,) + plain_norm(cfg, BATCH * SEQ))
    fwd.update(tune_launches=tune_counts, best=best)
    clock_s = time.perf_counter()
    serve_db = Database()
    torch.cuda.empty_cache()
    reset_counts()  # the hymba serving path starts here
    serve_tasks, serve_best, serve, serve_tune_counts, serve_runs = phase_ssm_serve(
        cfg, serve_db, tag="hymba-serve", n_tasks=HYMBA_DECODE_TASKS,
        max_seq=HYMBA_MAX_SEQ, long_prompt=HYMBA_LONG_PROMPT, f32=True,
        new_tokens=HYMBA_NEW_TOKENS,
        # the 7 products of every layer and the decode unembed; no K5
        tick_launches=dict(matmul=7 * L + 1, batch_matmul=0,
                           decode_flash_attention=0, flash_attention=0))
    serve.update(tune_launches=serve_tune_counts, best=serve_best,
                 seconds=time.perf_counter() - clock_s)
    torch.cuda.empty_cache()
    # phase 6 at the keys the two paths served (the tuning-only sites of
    # the SSD mixer's einsums and softmaxes left out, for time)
    hits = path_hits()
    rows = phase_timings([t for t in tasks if hits[t.key]], runs, gen, cfg.vocab)
    rows.update(phase_timings([t for t in serve_tasks if hits[t.key]], serve_runs,
                              gen, cfg.vocab))
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    rows["ssd_hymba"] = ssd_timing(gen, "hymba-1.5b forward",
                                   (BATCH, SEQ, cfg.ssm_heads, P, N))
    rows["ssd_hymba_prefill"] = ssd_timing(
        gen, "hymba-1.5b long prefill", (1, HYMBA_LONG_PROMPT, cfg.ssm_heads, P, N),
        f32=True, state=True)
    return fwd, serve, rows


def phase_dense(cfg, gen, tag: str, n_tasks: int, forward_k1: int, unknown_key: int,
                plain_keys=(), serve_tasks: int = 0, gen_seed: int = 0,
                f32_layers: int = 0, serve_layers: int = 0, serve_plain_keys=(),
                cold_width: int = 0, unschedulable=None, serve_unschedulable=None):
    """Phases 25-26 (stablelm-3b, 32 heads of 80 over 32 kv heads), 28-29
    (qwen1.5-110b, 64 heads of 128 over 8 kv heads, q/k/v biases) and 30-31
    (arctic-480b, 56 heads of 128 over 8 kv heads, 128 experts top-2 beside
    a dense residual MLP): a model with no window at full width and
    ``cfg.n_layers``.  The
    forward: the reference's ``n_tasks`` tasks tuned but the norm and
    ``plain_keys``, left plain, and the products no schedule reaches
    (``unschedulable`` where given, key by key; K1
    ``forward_k1`` launches; K3 once a layer, all fma: D 80 and 128 are no
    tc head dim; K2 never; the attention key hit once a layer; the
    dispatch reasons ``unknown_key`` misses at the ``unknown_key`` sites
    whose key has no record, and nothing else; f32 within
    ``TOL_F32_LOGITS_REL``, at ``f32_layers`` where given, and for an MoE
    model where no token's routing differs).  Paged serving in f32 at
    ``serve_layers`` (else the same depth): the tasks of a paged tick (all
    ``serve_tasks`` of them, else the dispatchable ones) tuned but the
    chunk norm and ``serve_plain_keys`` (``serve_unschedulable`` the keys
    with no schedule), 8 requests of 16 new tokens, the
    streams held by phase 18's rule, the decode-only tick's K1 seven a
    layer and the m4 unembed, all splitk, K5 once a layer, and an MoE
    model's K2 three times a layer.  Each part (the tunings, the bf16
    forward, the f32 check, the serving) prints its peak of allocated
    device memory, which must leave ``MIN_FREE_BYTES`` of the card free;
    then phase 6 at the keys the two paths served.  Returns (forward
    result, serving result, timing rows)."""
    import torch

    from repro_torch.models.transformer import layer_windows, window_period
    from repro_torch.search.database import Database

    L = cfg.n_layers
    if window_period(layer_windows(cfg)) is None:
        fail(f"{cfg.name} at {L} layers has no window period")
    attn_key = (f"attention/b={BATCH}/causal=1/d={cfg.head_dim}/h={cfg.n_heads}/"
                f"kvh={cfg.n_kv_heads}/s={SEQ}/softcap=0.0/window=0")
    total = torch.cuda.get_device_properties(0).total_memory

    def held(part: str, peaks: dict) -> None:
        for name, n in peaks.items():
            if total - n < MIN_FREE_BYTES:
                fail(f"{cfg.name} {part} {name}: {n / 1e9:.2f} GB allocated at the peak "
                     f"leaves {(total - n) / 1e9:.2f} GB of the card free, under "
                     f"{MIN_FREE_BYTES / 1e9:g}")

    db = Database()
    release_memory()
    reset_counts()  # the model's forward path starts here
    tasks, best, fwd, tune_counts, _, runs = phase_model_forward(
        cfg, db, f"{tag}-forward", n_tasks, dict(
            matmul=forward_k1, batch_matmul=0, flash_attention=L, flash_attention_fma=L,
            rmsnorm=0, attention={attn_key: L}, attention_fused=0),
        plain_keys=plain_norm(cfg, BATCH * SEQ) + tuple(plain_keys), f32_layers=f32_layers,
        unschedulable=unschedulable)
    want_reasons = {"unknown_key": unknown_key}
    print(f"[{tag}-forward] left plain: {list(plain_keys)} and the norm; dispatch "
          f"reasons {fwd['reasons']} (want {want_reasons})")
    if fwd["reasons"] != want_reasons:
        fail(f"{cfg.name} forward: dispatch reasons {fwd['reasons']}, want {want_reasons}")
    held("forward", fwd["peak_bytes"])
    fwd.update(tune_launches=tune_counts, best=best)
    clock_s = time.perf_counter()
    serve_cfg = dataclasses.replace(cfg, n_layers=serve_layers) if serve_layers else cfg
    Ls = serve_cfg.n_layers
    serve_db = Database()
    release_memory()
    reset_counts()  # the model's serving path starts here
    serve_tasks, serve_best, serve, serve_tune_counts, serve_runs = phase_serve(
        serve_cfg, serve_db, tag=f"{tag}-serve", serve_tasks=serve_tasks, f32=True,
        plain_keys=plain_norm(cfg, SERVE_SLOTS * SERVE_CHUNK) + tuple(serve_plain_keys),
        cold_width=cold_width, unschedulable=serve_unschedulable,
        # q, k, v, o and the MLP's three of every layer, and the decode
        # unembed; K5 at every layer; an MoE layer's three expert products
        tick_launches=dict(matmul=7 * Ls + 1, decode_flash_attention=Ls,
                           **({"batch_matmul": 3 * Ls} if cfg.moe_experts else {})))
    held("serving", serve["peak_bytes"])
    serve.update(tune_launches=serve_tune_counts, best=serve_best,
                 seconds=time.perf_counter() - clock_s)
    # the served parameters go before phase 6 draws its operands (arctic's
    # f32 layer, 54.4 GB, beside two 17.85 GB expert operands would not fit)
    release_memory()
    # phase 6 at the keys the two paths served (K1 at m256, the m128 chunk
    # and m4; K2 at an MoE tick; K3 fma and K5)
    hits = path_hits()
    rows = phase_timings([t for t in tasks if hits[t.key]], runs, gen, cfg.vocab)
    rows.update(phase_timings([t for t in serve_tasks if hits[t.key]], serve_runs,
                              gen, cfg.vocab))
    return fwd, serve, rows


def phase_hymba_train(cfg, gen):
    """Phase 27, hymba-1.5b's train step at ``cfg.n_layers`` (over 4: no
    window period) through ``phase_train``: the reference's tasks tuned but
    the norm (the unembed has no schedule); one f32 step under the tuned
    context against the plain step: K1 seven a layer and K2 at both chunked
    contractions, each in the forward and in remat's recompute, K7 in both,
    K3 never, ``traced_window`` at every layer's attention in both; then
    bf16 steps whose loss must fall.  Returns (result, the tuning's
    launches, the f32 step's, timing rows)."""
    from repro_torch.models.transformer import layer_windows, window_period
    from repro_torch.search.database import Database, workload_key

    L, m = cfg.n_layers, TRAIN_BATCH * TRAIN_SEQ
    if window_period(layer_windows(cfg)) is not None:
        fail(f"{cfg.name} at {L} layers has a window period: the reference would "
             "serve its attention through K3")
    G, KVH, hd = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads, cfg.head_dim
    d, f = cfg.d_model, cfg.d_ff
    # every site twice, the forward's and remat's recompute: a layer's q and
    # o, k and v, the MLP's wi and wg, then its wo (K1), and the chunked
    # attention's two contractions (K2)
    hits = {workload_key("dense", k=d, m=m, n=d): 4 * L,
            workload_key("dense", k=d, m=m, n=KVH * hd): 4 * L,
            workload_key("dense", k=d, m=m, n=f): 4 * L,
            workload_key("dense", k=f, m=m, n=d): 2 * L,
            **{workload_key("batch_matmul", b=TRAIN_BATCH * KVH, m=G * TRAIN_SEQ,
                            n=n, k=k): 2 * L
               for n, k in ((TRAIN_SEQ, hd), (hd, TRAIN_SEQ))}}
    print(f"[hymba-train] {L} layers, windows {[int(w) for w in layer_windows(cfg)]} (no "
          "period: the reference traces them)")
    _, best, res, tune_counts, step_counts, rows = phase_train(
        cfg, gen, Database(), tag="hymba-train", n_tasks=HYMBA_TRAIN_TASKS,
        plain_keys=plain_norm(cfg, m), scan_leaves=SSD_SCAN_LEAVES,
        want=dict(matmul=2 * 7 * L, batch_matmul=2 * 2 * L, ssd=2 * L,
                  flash_attention=0, hits=hits,
                  reasons={"site:attention": {"traced_window": 2 * L}}))
    res.update(tune_launches=tune_counts, best=best)
    return res, tune_counts, step_counts, rows


def phase_whisper_decode(cfg, db, gen_seed: int = 0):
    """Phase 16, decoding: whisper-medium's 11 decode tasks (batch 4, max_seq
    256) tuned and their tiles checked; ``prefill``
    of 4 prompts of ``WHISPER_PROMPT`` tokens over 1500 seeded frames, then
    ``WHISPER_STEPS`` greedy ``decode_step`` calls, under the tuned context
    and with no context: in f32 the greedy tokens must agree (where one
    differs, that step's two top plain logits must lie within
    ``TOL_F32_LOGITS_REL`` of max |logit| of each other), and every step
    launches K5 24 times over the 1500-frame cross-attention cache and 24
    over the 256-position self-attention cache; in bf16 the steps are
    timed and one dispatched step traced."""
    import torch

    import repro_torch
    from repro_torch.models import transformer as T
    from repro_torch.search.database import workload_key

    B = SERVE_SLOTS

    def extract():
        tasks = repro_torch.extract_decode_tasks(cfg, batch=B, max_seq=SERVE_MAX_SEQ)
        if len(tasks) != WHISPER_DECODE_TASKS:
            fail(f"{cfg.name} decode extraction gave {len(tasks)} tasks, want the "
                 f"reference's {WHISPER_DECODE_TASKS}")
        return tasks

    tasks, best = phase_tune(cfg, db, extract=extract, tag="whisper-decode-tune")
    tune_counts = read_counts()
    runs = check_tiles(tasks, db)
    attn_keys = {t: workload_key("attention_decode", b=B, h=cfg.n_heads,
                                 kvh=cfg.n_kv_heads, t=t, d=cfg.head_dim, softcap=0.0)
                 for t in (cfg.enc_frames, SERVE_MAX_SEQ)}
    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(gen_seed + 2)
    prompt = torch.randint(0, cfg.vocab, (B, WHISPER_PROMPT), generator=g, device="cuda")
    frames = torch.randn(B, cfg.enc_frames, cfg.d_model, generator=g, device="cuda")

    def generate(c, p, dispatch, on_step=None):
        """Greedy tokens (B, WHISPER_STEPS + 1), the logits they came from,
        and each decode step's host ms."""
        cache = T.init_cache(c, B, SERVE_MAX_SEQ)
        toks, logits_seen, step_ms = [], [], []
        with torch.no_grad(), (dispatch if dispatch is not None else nullcontext()):
            logits, cache = T.prefill(c, p, cache, prompt, frames=frames)
            for i in range(WHISPER_STEPS + 1):
                logits = logits[:, -1].float()
                logits_seen.append(logits)
                toks.append(logits.argmax(-1))
                if i == WHISPER_STEPS:
                    break
                if on_step is not None:
                    on_step(i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = T.decode_step(c, p, cache, toks[-1][:, None])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(toks, 1), logits_seen, step_ms

    # bf16: the steps timed, and one dispatched step traced
    ctx = path_context(db, tasks=tasks, backend="cuda")
    _, _, tuned_ms = generate(cfg, params, ctx)
    _, _, plain_ms = generate(cfg, params, None)
    timing_ctx = path_context(db, tasks=tasks, backend="cuda")
    cache = T.init_cache(cfg, B, SERVE_MAX_SEQ)
    with torch.no_grad(), timing_ctx:
        _, cache = T.prefill(cfg, params, cache, prompt, frames=frames)
        nxt = torch.zeros((B, 1), dtype=torch.long, device="cuda")
        profile = profile_device(lambda: T.decode_step(cfg, params, cache, nxt))
    del cache
    # f32: the greedy tokens, dispatched against plain, and each step's
    # launches and attention_decode hits
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    ctx32 = path_context(db, tasks=tasks, backend="cuda")
    steps = []
    marks = {}

    def on_step(i):
        if marks:
            steps.append(dict(
                launches={k: n - marks["counts"][k] for k, n in read_counts().items()},
                hits={t: ctx32.hits_by_key.get(k, 0) - marks["hits"][t]
                      for t, k in attn_keys.items()}))
        marks.update(counts=read_counts(),
                     hits={t: ctx32.hits_by_key.get(k, 0) for t, k in attn_keys.items()})

    counts0 = read_counts()
    toks_t, _, _ = generate(cfg32, params32, ctx32, on_step)
    on_step(WHISPER_STEPS)  # the last step's counts
    launches = {k: n - counts0[k] for k, n in read_counts().items()}
    toks_p, logits_p, _ = generate(cfg32, params32, None)
    del params32
    torch.cuda.empty_cache()
    agree = (toks_t == toks_p).all(0)  # by position, over the lanes
    first = int((~agree).nonzero()[0]) if not bool(agree.all()) else None
    ties = []  # the top-2 plain logits' gap of each lane that differs there
    if first is not None:
        lanes = (toks_t[:, first] != toks_p[:, first]).nonzero()[:, 0]
        top2 = logits_p[first][lanes].topk(2, -1).values
        scale = logits_p[first][lanes].abs().amax(-1)
        ties = ((top2[:, 0] - top2[:, 1]) / scale).tolist()
    tuned_step = sorted(tuned_ms)[len(tuned_ms) // 2]
    plain_step = sorted(plain_ms)[len(plain_ms) // 2]
    k5 = [s["launches"]["decode_flash_attention"] for s in steps]
    print(f"[whisper-decode] {B} lanes, prompts of {WHISPER_PROMPT} tokens over "
          f"{cfg.enc_frames} frames, {WHISPER_STEPS} greedy steps; f32 tokens "
          f"dispatched {toks_t.tolist()}")
    print(f"[whisper-decode] f32 tokens agreeing with plain by position: "
          f"{agree.tolist()}" + ("" if first is None else
                                 f"; first difference at {first}, top-2 plain logit "
                                 f"gaps over max |logit| of the lanes that differ "
                                 f"{ties}"))
    print(f"[whisper-decode] bf16 decode step host ms, median of {WHISPER_STEPS}: "
          f"dispatched {tuned_step:.2f}, plain {plain_step:.2f}")
    if profile:
        print(f"[whisper-decode] profile of one dispatched bf16 step: "
              f"{profile['events']} device events, busy {profile['busy_ms']:.2f} ms of a "
              f"{profile['span_ms']:.2f} ms span, idle share {profile['idle_share']:.3f}; "
              f"traced K1 {profile['matmul_ms']:.3f} ms, K5 "
              f"{profile['decode_attention_ms']:.3f} ms")
    else:
        print("[whisper-decode] the profiler saw no device event (not measured)")
    print(f"[whisper-decode] K5 launches by f32 step {k5}; attention_decode hits by "
          f"step {[s['hits'] for s in steps]}; launches over prefill and steps "
          f"{launches}")
    if len(steps) != WHISPER_STEPS or any(
            s["hits"] != {t: cfg.n_layers for t in attn_keys}
            or s["launches"]["decode_flash_attention"] != 2 * cfg.n_layers for s in steps):
        fail(f"{cfg.name} decode steps: K5 launches {k5}, hits "
             f"{[s['hits'] for s in steps]}; want {cfg.n_layers} at each of "
             f"t={list(attn_keys)} a step")
    if first is not None and not all(t <= TOL_F32_LOGITS_REL for t in ties):
        fail(f"{cfg.name} f32 greedy tokens differ at step {first} where the plain "
             f"top-2 logits are {ties} of max |logit| apart")
    res = dict(agree=agree.tolist(), first_difference=first, top2_gaps=ties,
               tokens=toks_t.tolist(), step_ms_dispatched=tuned_step,
               step_ms_plain=plain_step, profile=profile, launches=launches,
               k5_by_step=k5)
    return tasks, best, res, tune_counts, launches, runs


# ---------------------------------------------------------------------------
# phase 17: the measurement fleet
# ---------------------------------------------------------------------------


def tally_worker_launches(runner, tally: Counter, uneven: list) -> None:
    """Sum the kernel launches that ``runner``'s worker processes made,
    which the parent's counters do not see: a worker reads its wrappers'
    counters around each candidate's timing and returns the difference in
    the result's ``meta["launches"]`` (``name`` and ``name/variant``).  A
    measured candidate whose lowering names a kernel that did not launch
    fails the phase; one that launched it other than once a call of its
    timing (one first call, then warmup and repeats when it ran in time)
    goes into ``uneven``."""
    run = runner.run

    def counted(inputs):
        results = run(inputs)
        for mi, res in zip(inputs, results):
            if res.source != "measured":
                continue
            launched = res.meta.get("launches", {})
            tally.update(launched)
            kernel = res.meta.get("pallas_kernel")
            if kernel and not launched.get(kernel):
                fail(f"{mi.workload_key}: the worker's lowering names {kernel}, "
                     f"which did not launch (launches {launched})")
            calls = 1 + runner.warmup + runner.repeats if res.ok else 1
            if kernel and launched[kernel] != calls:
                uneven.append((mi.workload_key, launched, calls))
        return results

    runner.run = counted


def check_fleet_stats(tag: str, stats: dict, deaths: int = 0) -> None:
    """No timeout, crash or quarantine, and ``deaths`` worker deaths."""
    bad = {k: stats.get(k, 0) for k in ("timeouts", "crashes", "quarantined_traces",
                                        "quarantine_rejects")}
    if any(bad.values()) or stats.get("worker_deaths", 0) != deaths:
        fail(f"{tag}: runner stats {stats}; want no timeout, crash or quarantine "
             f"and {deaths} worker deaths")


def same_hash_rows(tasks, db_a, db_b) -> list:
    """(key, ms in db_a, ms in db_b) for each trace both databases hold."""
    from repro_torch.search.measure.hashing import structural_hash

    rows = []
    for t in tasks:
        a = {structural_hash(t.key, r.trace()): r.latency_s for r in db_a.records.get(t.key, [])}
        for r in db_b.records.get(t.key, []):
            h = structural_hash(t.key, r.trace())
            if h in a:
                rows.append((t.key, a[h] * 1e3, r.latency_s * 1e3))
    return rows


def phase_fleet(cfg, local_db, local_tune_s: float, gen_seed: int = 0) -> dict:
    """smollm-135m's forward tasks tuned through two spawned pool workers
    and through two RPC workers (then one dense task with one RPC worker
    killed mid-run), the pool's database dispatched into the full-width
    forward, each best schedule scored by the analytical runner, the legacy
    serial runner on one dense schedule, and the phase's trace folded."""
    import torch

    import repro_torch
    from repro_torch.backends.analysis import AnalyticalRunner
    from repro_torch.core.validator import validate_trace
    from repro_torch.core.workloads import get_workload
    from repro_torch.models import transformer as T
    from repro_torch.obs import RingBufferSink, configure_tracing, disable_tracing
    from repro_torch.obs.report import fold, render_text
    from repro_torch.search.database import Database, parse_workload_key
    from repro_torch.search.evolutionary import SearchConfig
    from repro_torch.search.measure import create_runner, spawn_local_workers
    from repro_torch.search.measure.local import timing_lock
    from repro_torch.search.runner import LocalRunner as LegacyRunner

    t_phase = time.perf_counter()
    sink = RingBufferSink()
    configure_tracing(sink)
    worker_launches: Counter = Counter()
    uneven: list = []  # candidates that launched other than once a call
    budget = ROUNDS_PER_TASK * TUNE_SEARCH["measure_per_round"]
    try:
        # 1. the pool: two spawned workers sharing the card, timing in turns
        pool_db = Database()
        t0 = time.perf_counter()
        pool = create_runner(f"cached+pool://workers={FLEET_WORKERS}", backend="cuda",
                             device="cuda")
        tally_worker_launches(pool.inner, worker_launches, uneven)
        try:
            tasks, pool_best = phase_tune(cfg, pool_db, tag="fleet-pool", runner_spec=pool)
            pool_stats = pool.stats()
        finally:
            pool.close()
        pool_s = time.perf_counter() - t0
        inner = {k[len("inner_"):]: v for k, v in pool_stats.items() if k.startswith("inner_")}
        check_fleet_stats("pool", inner)
        n_pool = pool_stats["cache_hits"] + pool_stats["cache_misses"]
        if n_pool < budget * len(tasks) or inner["measured"] != pool_stats["cache_misses"]:
            fail(f"pool measured {inner['measured']} of {n_pool} candidates; want every "
                 f"one of at least {budget * len(tasks)}")

        # 2. the RPC fleet: two worker processes, then one killed mid-run
        rpc_db = Database()
        t0 = time.perf_counter()
        handles = spawn_local_workers(FLEET_WORKERS, backend="cuda", device="cuda")
        spawn_s = time.perf_counter() - t0
        address = ",".join(h.addr for h in handles)
        rpc_stats = []
        try:
            rpc = create_runner(f"rpc://{address}", backend="cuda", device="cuda")
            tally_worker_launches(rpc, worker_launches, uneven)
            try:
                phase_tune(cfg, rpc_db, tag="fleet-rpc", runner_spec=rpc)
                rpc_stats.append(rpc.stats())
            finally:
                rpc.close()
            rpc_s = time.perf_counter() - t0
            check_fleet_stats("rpc", rpc_stats[0])
            used = [a for a, w in rpc_stats[0]["per_worker"].items() if w["candidates"] > 0]
            if len(used) != FLEET_WORKERS:
                fail(f"rpc run used workers {used} of {address}")
            if rpc_stats[0]["measured"] < budget * len(tasks):
                fail(f"rpc measured {rpc_stats[0]['measured']} candidates; want at "
                     f"least {budget * len(tasks)}")

            name, kw = parse_workload_key(FLEET_KILL_TASK)
            kill_search = SearchConfig(**{**TUNE_SEARCH, "max_trials": 2 * budget})
            rpc = create_runner(f"rpc://{address}", backend="cuda", device="cuda")
            tally_worker_launches(rpc, worker_launches, uneven)
            run = rpc.run

            def run_then_kill(inputs):
                # the first batch lands on both workers; the next finds one dead
                res = run(inputs)
                if handles[0].proc.poll() is None:
                    handles[0].kill()
                return res

            rpc.run = run_then_kill
            t0 = time.perf_counter()
            try:
                killed = repro_torch.tune_workload(name, kw, database=Database(), config=(
                    repro_torch.TuneConfig(search=kill_search, runner_spec=rpc,
                                           backend="cuda", device="cuda",
                                           warm_start=False)))
                rpc_stats.append(rpc.stats())
            finally:
                rpc.close()
            kill_s = time.perf_counter() - t0
        finally:
            for h in handles:
                h.kill()
        check_fleet_stats("rpc kill-one", rpc_stats[1], deaths=1)
        print(f"[fleet] kill-one {FLEET_KILL_TASK}: {killed.trials} trials, best "
              f"{killed.best_latency_s * 1e3:.4f} ms, {kill_s:.1f} s; stats {rpc_stats[1]}")
        if killed.trials < kill_search.max_trials or not math.isfinite(killed.best_latency_s):
            fail(f"kill-one run measured {killed.trials} of {kill_search.max_trials} "
                 f"trials, best {killed.best_latency_s}")
        survivor = rpc_stats[1]["per_worker"][handles[1].addr]
        if rpc_stats[1]["retries"] < 1 or survivor["candidates"] < kill_search.max_trials // 2:
            fail(f"kill-one run: no retry on the survivor ({rpc_stats[1]})")
    finally:
        disable_tracing()

    # the workers' launches, read from their counters (the parent's see none)
    by_kernel = kernel_launches(worker_launches)
    print(f"[fleet] worker launches by kernel and variant (pool and rpc): {by_kernel}; "
          f"{len(uneven)} candidates launched other than once a call of their "
          f"timing {uneven[:5]}")
    for k in FORWARD_KERNELS:
        if not worker_launches[k]:
            fail(f"{k} was not launched in the fleet's workers")

    for key, local_ms, pool_ms in same_hash_rows(tasks, local_db, pool_db):
        print(f"[fleet] same trace: {key} local {local_ms:.4f} ms, pool {pool_ms:.4f} ms")

    # 3. the pool's database dispatched into the full-width forward
    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(gen_seed + 1)
    toks = torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g, device="cuda")
    before = read_counts()
    with torch.no_grad():
        plain = T.forward(cfg, params, toks)
        with path_context(pool_db, tasks=tasks, backend="cuda") as ctx:
            tuned = T.forward(cfg, params, toks)
        torch.cuda.synchronize()
    fwd_counts = {k: n - before[k] for k, n in read_counts().items()}
    rel = float((tuned.float() - plain.float()).abs().max() / plain.float().abs().max())
    print(f"[fleet] pool-tuned forward {tuple(tuned.shape)}: max_rel_err {rel:.4e} "
          f"(tol {TOL_LOGITS_REL:g}); dispatch {dict(ctx.stats)}; launches {fwd_counts}")
    if not torch.isfinite(tuned.float()).all() or rel > TOL_LOGITS_REL:
        fail(f"pool-tuned forward: rel err {rel} > {TOL_LOGITS_REL} or not finite")
    for k in ("matmul", "flash_attention"):
        if fwd_counts[k] <= 0:
            fail(f"{k} was not launched in the pool-tuned forward")
    del params

    # 4. the analytical runner beside each measured best
    analytical = {}
    for t in tasks:
        rec = pool_db.best(t.key)
        sch = validate_trace(t.func, rec.trace()).schedule
        est_ms = AnalyticalRunner().measure(sch).latency_s * 1e3
        analytical[t.key] = dict(estimate_ms=est_ms, measured_ms=rec.latency_s * 1e3)
        print(f"[fleet] {t.key}: analytical {est_ms:.4f} ms, measured "
              f"{rec.latency_s * 1e3:.4f} ms")

    # the legacy serial runner on one dense schedule
    name, kw = parse_workload_key(FLEET_KILL_TASK)
    func = get_workload(name, **kw)
    sch = validate_trace(func, pool_db.best(FLEET_KILL_TASK).trace()).schedule
    legacy = LegacyRunner(device="cuda")
    got, base = legacy.measure(sch), legacy.baseline(func)
    print(f"[fleet] legacy runner {FLEET_KILL_TASK}: {got.latency_s * 1e3:.4f} ms "
          f"{got.error!r}, plain {base * 1e3:.4f} ms")
    if not (got.ok and math.isfinite(base)):
        fail(f"legacy runner: {got}, baseline {base}")

    # the timing lock's host cost, taken uncontended as every measurement
    # of phases 4-16 takes it
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for _ in range(LOCK_TAKES):
        with timing_lock(dev):
            pass
    lock_us = (time.perf_counter() - t0) / LOCK_TAKES * 1e6
    print(f"[fleet] timing lock: {lock_us:.2f} us a take ({LOCK_TAKES} uncontended)")

    # 5. the phase's trace, folded; its fleet counts against the runners'
    report = fold(sink.events)
    print(render_text(report))
    fleet = report["rpc"] or {}
    want_deaths = sum(s["worker_deaths"] for s in rpc_stats)
    want_retries = sum(s["retries"] for s in rpc_stats)
    for addr in {a for s in rpc_stats for a in s["per_worker"]}:
        row = fleet.get("workers", {}).get(addr, {})
        want = [sum(s["per_worker"].get(addr, {}).get(f, 0) for s in rpc_stats)
                for f in ("batches", "deaths")]
        got_row = [row.get("batches", 0) - row.get("failed_batches", 0), row.get("deaths", 0)]
        if got_row != want:
            fail(f"report fleet row {addr} {row}; the runners say batches and deaths {want}")
    if (fleet.get("worker_deaths"), fleet.get("retries")) != (want_deaths, want_retries):
        fail(f"report fleet {fleet}; the runners say {want_deaths} deaths, "
             f"{want_retries} retries")
    m = report["measure"]
    if m["timeouts"] or m["crashes"] or m["quarantined"]:
        fail(f"report measure section {m}")
    wall = time.perf_counter() - t_phase
    print(f"[fleet] tuning wall: local {local_tune_s:.1f} s, pool {pool_s:.1f} s, rpc "
          f"{rpc_s:.1f} s (spawn {spawn_s:.1f} s); phase {wall:.1f} s")
    return dict(tuning_wall_s=dict(local=local_tune_s, pool=pool_s, rpc=rpc_s,
                                   rpc_spawn=spawn_s, kill_one=kill_s),
                pool_best=pool_best, pool_stats=pool_stats, rpc_stats=rpc_stats,
                worker_launches=by_kernel, uneven_candidates=uneven,
                forward_max_rel_err=rel,
                forward_launches=fwd_counts, analytical=analytical,
                legacy=dict(ms=got.latency_s * 1e3, plain_ms=base * 1e3),
                timing_lock_us=lock_us,
                report_rpc=fleet, wall_s=wall), fwd_counts


# ---------------------------------------------------------------------------
# phase 18: the serving router
# ---------------------------------------------------------------------------


def serve_recording(sched, prompts, new_tokens: int, on_tick=None, record: bool = True):
    """Serve ``prompts`` on ``sched`` to the end, ``on_tick(sched)`` before
    every tick, recording (with ``record``) for every token generated the
    logits row it was taken from (kept on the device) and that row's top-2
    gap over its max |logit|.  Returns (requests, gaps and rows: a list per
    request, wall s)."""
    serve_step = sched.model.serve_step
    tick = {}

    def recording(*args, **kwargs):
        logits, cache = serve_step(*args, **kwargs)
        tick["rows"] = logits[:, 0]
        rows = tick["rows"].float()
        top2 = rows.topk(2, -1).values
        tick["gaps"] = ((top2[:, 0] - top2[:, 1]) / rows.abs().amax(-1)).tolist()
        # the tick's lanes, read after admission and before sampling
        tick["slots"] = {r.rid: s for s, r in {**sched.prefilling, **sched.active}.items()}
        return logits, cache

    if record:
        sched.model.serve_step = recording
    reqs = [sched.submit(p, max_new_tokens=new_tokens) for p in prompts]
    gaps = [[] for _ in reqs]
    rows = [[] for _ in reqs]
    t0 = time.perf_counter()
    try:
        while sched.pending():
            if on_tick is not None:
                on_tick(sched)
            before = [len(r.generated) for r in reqs]
            sched.step()
            for i, (r, n) in enumerate(zip(reqs, before)):
                if record and len(r.generated) > n:
                    lane = tick["slots"][r.rid]
                    gaps[i].append(tick["gaps"][lane])
                    rows[i].append(tick["rows"][lane].clone())
    finally:
        if record:
            del sched.model.serve_step
    return reqs, gaps, rows, time.perf_counter() - t0


def logit_spread(a, b) -> tuple:
    """The largest difference of two runs' logits at the same request and
    step over the first run's max |logit| there, over the steps whose
    streams agree before them; each run is (requests, rows) as
    :func:`serve_recording` returns them.  Returns (d, steps compared)."""
    d, steps = 0.0, 0
    for ra, rows_a, rb, rows_b in zip(a[0], a[1], b[0], b[1]):
        ga, gb = [int(t) for t in ra.generated], [int(t) for t in rb.generated]
        for j, (xa, xb) in enumerate(zip(rows_a, rows_b)):
            if ga[:j] != gb[:j]:
                break
            xa = xa.float()
            d = max(d, ((xa - xb.float()).abs().amax() / xa.abs().amax()).item())
            steps += 1
    return d, steps


def time_replies(links) -> dict:
    """Wrap each link's ``request`` so that ``clock["slowest_s"]`` of the
    returned dict keeps the slowest reply's seconds (reset it between
    stages), to hold beside the router's 10 s socket timeout."""
    clock = {"slowest_s": 0.0}
    for w in links:
        def timed(msg, request=w.request):
            t0 = time.perf_counter()
            try:
                return request(msg)
            finally:
                clock["slowest_s"] = max(clock["slowest_s"], time.perf_counter() - t0)
        w.request = timed
    return clock


def warm_up_workers(links) -> float:
    """One request of a 1-token prompt and 2 new tokens on each worker,
    straight through its link (the router's counters stay the run's): its
    two ticks, one 32 wide and one decode-only, lower every key of the
    worker's database while holding its scheduler lock.  Returns the wall
    seconds."""
    from repro_torch.search.measure.rpc import PROTOCOL_VERSION

    t0 = time.perf_counter()
    rids = {w.index: w.request({"v": PROTOCOL_VERSION, "type": "submit", "prompt": [1],
                                "max_new": 2})["rid"] for w in links}
    while rids:
        for w in links:
            if w.index in rids:
                st = w.request({"v": PROTOCOL_VERSION, "type": "poll",
                                "rids": [rids[w.index]]})["requests"]
                if st[str(rids[w.index])]["done"]:
                    del rids[w.index]
        time.sleep(0.02)
    return time.perf_counter() - t0


def kernel_launches(counts: dict) -> dict:
    """Launch counters (``kernels.launch_counts()``: ``name`` and
    ``name/variant``) as {kernel: {launches, by_variant}}, moved ones only."""
    return {k: dict(launches=counts.get(k, 0), by_variant={
        name.split("/", 1)[1]: n for name, n in sorted(counts.items())
        if name.startswith(k + "/") and n}) for k in KERNELS if counts.get(k)}


def phase_router(serve_db) -> dict:
    """Phase 18: ``ROUTER_WORKERS`` serving workers spawned on the card, each
    serving ``ROUTER_ARCH`` at full width (``--full-size``) on phase 7's paged arena
    and dispatching phase 7's database, behind the ``ServingRouter``; 16
    greedy requests, worker 0 SIGKILLed after the first poll round in which
    a request has tokens, then drained.  The same requests served by one
    scheduler in this process, built as a worker builds its own, run while
    the workers start; every stream must equal its in-process twin or differ
    first at a step whose in-process top-2 logits are within
    ``ROUTER_TIE_REL``.  The same scheduler then serves phase 7's 8 prompts
    again in reverse order, another tick composition on the same kernels:
    the largest difference of the two runs' logits, d, must be within half
    the bound.  The workers' launches are those from the end of their
    warm-up to the kill (worker 0) or the drain's end (worker 1)."""
    import signal
    import tempfile
    import threading

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.obs import RingBufferSink, configure_tracing, disable_tracing
    from repro_torch.obs.report import fold
    from repro_torch.search.database import Database
    from repro_torch.search.measure.rpc import PROTOCOL_VERSION
    from repro_torch.serving.router import ServingRouter, spawn_serving_workers
    from repro_torch.serving.worker import build_scheduler

    t_phase = time.perf_counter()
    arch = ROUTER_ARCH
    cfg = get_config(arch)
    rng = np.random.default_rng(0)
    prompts, lens = [], []
    for _ in range(ROUTER_REQUESTS // SERVE_REQUESTS):  # phase 7's draws, then more
        n_tok = rng.integers(32, 97, SERVE_REQUESTS)
        prompts += [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in n_tok]
        lens += n_tok.tolist()
    settings = dict(max_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, page_size=SERVE_PAGE,
                    prefill_chunk=SERVE_CHUNK)
    ref: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        db_path = os.path.join(tmp, "serve_db.json")
        saved = Database(db_path)
        saved.records = serve_db.records
        saved.save()

        def reference():
            try:
                sched = build_scheduler(arch, db=db_path, seed=0, smoke=False,
                                        device="cuda", **settings)
                ref["reqs"], ref["gaps"], rows, ref["wall_s"] = serve_recording(
                    sched, prompts, SERVE_NEW_TOKENS)
                ref["decode_tok_s"] = sched.decode_tok_s
                ref["dispatch"] = dict(sched.dispatch.stats)
                # phase 7's prompts again, last first
                back = list(reversed(range(SERVE_REQUESTS)))
                t0 = time.perf_counter()
                b_reqs, _, b_rows, _ = serve_recording(
                    sched, [prompts[i] for i in back], SERVE_NEW_TOKENS)
                ref["spread_wall_s"] = time.perf_counter() - t0
                ref["d"], ref["d_steps"] = logit_spread(
                    ([ref["reqs"][i] for i in back], [rows[i] for i in back]),
                    (b_reqs, b_rows))
            except Exception as e:  # raised again in the main thread
                ref["error"] = e

        t0 = time.perf_counter()
        ref_thread = threading.Thread(target=reference)
        ref_thread.start()
        try:
            links = spawn_serving_workers(
                ROUTER_WORKERS, model=arch, db=db_path, device="cuda",
                extra_args=["--full-size"], **settings)
            spawn_s = time.perf_counter() - t0
        finally:
            ref_thread.join()
        procs = [w.proc for w in links]
        try:
            if "error" in ref:
                raise ref["error"]
            router = ServingRouter(links, model=arch)
        except BaseException:
            for w in links:
                w.kill()
            raise
        sink = RingBufferSink()
        replies = time_replies(links)
        stats_msg = {"v": PROTOCOL_VERSION, "type": "stats"}
        try:
            warm_s = warm_up_workers(links)
            slowest_s, replies["slowest_s"] = replies["slowest_s"], 0.0
            warm_launches = [w.request(stats_msg)["stats"]["launches"] for w in links]
            configure_tracing(sink)
            try:
                t0 = time.perf_counter()
                for p in prompts:
                    router.submit(p.tolist(), max_new=SERVE_NEW_TOKENS)
                victim = links[0]
                deadline = time.monotonic() + 120
                while not any(r.tokens for r in router.requests):
                    if time.monotonic() > deadline:
                        fail("router: no request had a token within 120 s")
                    router.poll()
                    time.sleep(0.02)
                kill_at_s = time.perf_counter() - t0
                with_tokens = sum(bool(r.tokens) for r in router.requests)
                victim_stats = victim.request(stats_msg)["stats"]
                os.kill(victim.pid, signal.SIGKILL)
                victim.proc.wait(timeout=30)
                router.drain(timeout_s=180)
                drain_s = time.perf_counter() - t0
                run_slowest_s = replies["slowest_s"]
            finally:
                disable_tracing()
            summary = router.summary()
        finally:
            router.shutdown()
    left = [p.pid for p in procs if p.poll() is None]

    reqs = router.requests
    stats = dict(router.stats)
    tokens = sum(len(r.tokens) for r in reqs)
    worker_stats = [victim_stats, summary["workers"][1]["scheduler"]]
    # each worker's launches in the measured run: since its warm-up
    run_launches = [{k: n - before.get(k, 0) for k, n in st["launches"].items()}
                    if st else {} for st, before in zip(worker_stats, warm_launches)]
    workers = [dict(completed=w["completed"], alive=w["alive"], pid=w["pid"],
                    decode_tok_s=st["decode_tok_s"] if st else None,
                    launches=kernel_launches(n))
               for w, st, n in zip(summary["workers"], worker_stats, run_launches)]
    worker_launches = Counter()
    for n in run_launches:
        worker_launches.update({k: n.get(k, 0) for k in KERNELS})
    equal, differ = 0, []
    for i, (r, want) in enumerate(zip(reqs, ref["reqs"])):
        want_toks = [int(t) for t in want.generated]
        if r.tokens == want_toks:
            equal += 1
            continue
        j = next((k for k, (a, b) in enumerate(zip(r.tokens, want_toks)) if a != b),
                 min(len(r.tokens), len(want_toks)))
        gap = ref["gaps"][i][j] if j < len(ref["gaps"][i]) else None
        differ.append(dict(request=i, step=j, top2_gap=gap, resubmits=r.resubmits))
    gaps = np.asarray([g for per in ref["gaps"] for g in per])
    gap_median = float(np.median(gaps))
    under = float(np.mean(gaps <= ROUTER_TIE_REL))
    d = ref["d"]
    folded = fold(sink.events)["serving_router"] or {}
    ref_tokens = sum(len(r.generated) for r in ref["reqs"])
    print(f"[router] {ROUTER_WORKERS} workers ({arch} --full-size, cuda, paged, "
          f"{SERVE_SLOTS} slots, max_seq {SERVE_MAX_SEQ}, {SERVE_CHUNK}-token chunks, "
          f"phase 7's database): spawn {spawn_s:.2f} s; warm-up {warm_s:.2f} s, slowest "
          f"reply {slowest_s:.3f} s (socket timeout 10 s)")
    print(f"[router] {ROUTER_REQUESTS} requests, prompt lengths {lens}, "
          f"{SERVE_NEW_TOKENS} new tokens each, greedy; worker 0 SIGKILLed at "
          f"{kill_at_s:.2f} s, when {with_tokens} requests had tokens; slowest reply "
          f"{run_slowest_s:.3f} s")
    print(f"[router] drain wall {drain_s:.2f} s, {tokens} tokens, "
          f"{tokens / drain_s:.1f} tok/s total; stats {stats}")
    for i, w in enumerate(workers):
        when = "at the kill" if i == 0 else "after the drain"
        tok_s = "not measured" if w["decode_tok_s"] is None else f"{w['decode_tok_s']:.1f}"
        print(f"[router] worker {i} (pid {w['pid']}, alive {w['alive']}): completed "
              f"{w['completed']}, decode {tok_s} tok/s {when}; launches by kernel and "
              f"variant from its warm-up's end {when}: {w['launches']}")
    print(f"[router] in-process scheduler on the same database: {ref_tokens} tokens in "
          f"{ref['wall_s']:.2f} s (beside the workers' start), decode "
          f"{ref['decode_tok_s']:.1f} tok/s; dispatch {ref['dispatch']}")
    print(f"[router] in-process top-2 gap over max |logit|, {gaps.size} steps: min "
          f"{gaps.min():.4e}, median {gap_median:.4e}, share within the bound "
          f"{ROUTER_TIE_REL:g}: {under:.4f}")
    print(f"[router] phase 7's prompts again in reverse order ({ref['spread_wall_s']:.2f} s): "
          f"logits differ by at most d = {d:.4e} of max |logit| over {ref['d_steps']} "
          f"steps; 2d = {2 * d:.4e} (bound {ROUTER_TIE_REL:g})")
    print(f"[router] streams equal to the in-process run: {equal}/{len(reqs)}; "
          f"differing (first step, in-process top-2 gap over max |logit|, bound "
          f"{ROUTER_TIE_REL:g}): {differ}")
    print(f"[router] report serving_router {folded}")
    if left:
        fail(f"router: worker processes {left} left after shutdown")
    done = sum(r.done and len(r.tokens) == SERVE_NEW_TOKENS for r in reqs)
    if done != ROUTER_REQUESTS:
        fail(f"router: {done} of {ROUTER_REQUESTS} requests completed with "
             f"{SERVE_NEW_TOKENS} tokens")
    if stats["worker_deaths"] != 1 or stats["resubmits"] < 1 or \
            [w["alive"] for w in workers] != [False, True] or \
            victim.proc.returncode != -signal.SIGKILL:
        tails = "\n".join(f"worker {w.index}: " + "\n".join(w.tail) for w in links)
        fail(f"router: stats {stats}, workers alive {[w['alive'] for w in workers]}, "
             f"victim rc {victim.proc.returncode}; want the one death of worker 0 by "
             f"SIGKILL and a resubmit\n{tails}")
    survivor = workers[1]["launches"]
    for k in ("matmul", "decode_flash_attention"):
        if survivor.get(k, {}).get("launches", 0) <= 0:
            fail(f"router: the surviving worker launched no {k} ({survivor})")
    if ref_tokens != ROUTER_REQUESTS * SERVE_NEW_TOKENS:
        fail(f"router: the in-process run generated {ref_tokens} tokens")
    if not 2 * d <= ROUTER_TIE_REL:
        fail(f"router: two in-process compositions' logits differ by {d:.4e} of max "
             f"|logit|, more than half the near-tie bound {ROUTER_TIE_REL:g}")
    ties = [t for t in differ if t["top2_gap"] is None or t["top2_gap"] > ROUTER_TIE_REL]
    if ties:
        fail(f"router: streams differ from the in-process run where its top-2 logits "
             f"are no near tie: {ties}")
    if {k: folded.get(k) for k in stats} != stats or folded.get("workers") != {
            str(i): {"completed": w["completed"], "deaths": int(not w["alive"])}
            for i, w in enumerate(workers) if w["completed"] or not w["alive"]}:
        fail(f"router: report {folded}; the router says {stats}, workers {workers}")
    wall = time.perf_counter() - t_phase
    print(f"[router] phase {wall:.1f} s")
    return dict(spawn_s=spawn_s, warm_up_s=warm_s, warm_up_slowest_reply_s=slowest_s,
                slowest_reply_s=run_slowest_s,
                kill_at_s=kill_at_s, drain_s=drain_s, tokens=tokens,
                tok_s=tokens / drain_s, stats=stats, workers=workers,
                worker_launches=dict(worker_launches), streams_equal=equal,
                differ=differ, gap_median=gap_median, gap_share_within_bound=under,
                spread_d=d, spread_steps=ref["d_steps"],
                in_process=dict(wall_s=ref["wall_s"], spread_wall_s=ref["spread_wall_s"],
                                decode_tok_s=ref["decode_tok_s"],
                                dispatch=ref["dispatch"]),
                report=folded, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 8: the operator path
# ---------------------------------------------------------------------------


def phase_mesh(cfg, db, gen, gen_seed: int = 0) -> dict:
    """Phase 19: the mesh path on one card.  smollm-135m's tasks extracted
    under a logical (data 2, model 3) mesh (``MESH_KEYS``), tuned and their
    tiles checked; the full-width forward dispatched under the mesh (each
    per-shard kernel once a mesh coordinate) against the plain unsharded
    forward in f32 and bf16; one dispatched loss and its gradients against
    plain in f32; K2 at olmoe's expert product over a (model 2) mesh
    against ``torch.bmm``; the dry run of smollm's ``DRYRUN_SHAPES`` cells
    on both production meshes; each per-shard kernel timed as in phase 6."""
    import torch

    import repro_torch
    from repro_torch.core.workloads import get_workload
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.search.database import Database, workload_key
    from repro_torch.search.task_scheduler import TuneTask
    from repro_torch.training.train_loop import value_and_grad

    t_phase = time.perf_counter()
    card = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), devices=[card] * math.prod(MESH_SHAPE))
    n_coords = mesh.size

    def extract():
        with use_mesh(mesh):
            tasks = repro_torch.extract_tasks(cfg, batch=MESH_BATCH, seq=SEQ,
                                              dispatchable_only=True)
        got = {t.key: t.weight for t in tasks}
        if got != MESH_KEYS:
            fail(f"extraction under {mesh} gave {got}; want {MESH_KEYS}")
        return tasks

    tasks, best = phase_tune(cfg, db, extract=extract, tag="mesh-tune")
    tune_counts = read_counts()
    runs = check_tiles(tasks, db)
    params = T.init_params(cfg, seed=gen_seed, device="cuda")
    params32 = _tree_map(lambda t: t.float(), params)
    g = torch.Generator(device="cuda")
    g.manual_seed(gen_seed + 1)
    toks = torch.randint(0, cfg.vocab, (MESH_BATCH, SEQ + 1), generator=g, device="cuda")
    ins = toks[:, :-1]

    # the f32 forward under the mesh, counted, against the plain one
    with torch.no_grad():
        plain32 = T.forward(cfg, params32, ins)
        ctx = path_context(db, tasks=tasks, backend="cuda")
        counts0 = read_counts()
        k1v0, k3v0 = read_variants(), read_variants("flash_attention")
        with ctx, use_mesh(mesh):
            tuned32 = T.forward(cfg, params32, ins)
        torch.cuda.synchronize()
    fwd_counts = {k: n - counts0[k] for k, n in read_counts().items()}
    k1v, k3v = variants_since(k1v0), variants_since(k3v0, "flash_attention")
    stats, by_key = dict(ctx.stats), ctx.stats_by_key()
    rel32 = float((tuned32 - plain32).abs().max() / plain32.abs().max())
    finite = bool(torch.isfinite(tuned32).all())
    shape = tuple(tuned32.shape)
    del tuned32, plain32
    n_dense = 7 * cfg.n_layers + 1  # q, k, v, o and the MLP's three, the unembed
    want = dict(mesh_sharded=n_dense + cfg.n_layers, matmul=n_coords * n_dense,
                flash_attention=n_coords * cfg.n_layers)
    reasons = dispatch_reasons(by_key)
    norm_key = workload_key("rmsnorm", d=cfg.d_model, eps=cfg.norm_eps,
                            tokens=MESH_BATCH * SEQ)
    norm_hits = by_key.get(norm_key, {}).get("hits", 0)
    print(f"[mesh] {mesh} on {card}: logits {shape} f32 max_rel_err {rel32:.4e} "
          f"(tol {TOL_F32_LOGITS_REL:g}) against the plain unsharded forward")
    print(f"[mesh] dispatch stats of one forward {stats}; reasons {dict(reasons)}")
    for key, row in by_key.items():
        print(f"[mesh]   {key}: hits {row['hits']} misses {row['misses']} fallbacks "
              f"{row['fallbacks']} reasons {row['reasons']}")
    print(f"[mesh] kernel launches in one forward: {fwd_counts}; K1 by variant {k1v}, "
          f"K3 {k3v}; want {want}")
    if not finite or shape != (MESH_BATCH, SEQ, cfg.vocab):
        fail(f"mesh forward logits not finite or of shape {shape}")
    if not rel32 <= TOL_F32_LOGITS_REL:
        fail(f"mesh forward f32 rel err {rel32} > {TOL_F32_LOGITS_REL}")
    if (stats["mesh_sharded"] != want["mesh_sharded"] or stats["misses"]
            or fwd_counts["matmul"] != want["matmul"]
            or fwd_counts["flash_attention"] != want["flash_attention"]
            or fwd_counts["batch_matmul"] or norm_hits != 2 * cfg.n_layers + 1):
        fail(f"mesh forward: stats {stats}, launches {fwd_counts}, rmsnorm hits "
             f"{norm_hits}; want {want}, no miss, no K2 and "
             f"{2 * cfg.n_layers + 1} rmsnorm hits")
    for bad in ("mesh_error", "no_shard_record", "unservable", "lowering_failed"):
        if reasons.get(bad):
            fail(f"mesh forward: {reasons[bad]} {bad}")

    # where the f32 forward's device time goes, traced once each way: the
    # kernels on the blocks the path serves, and the copies (K3's lowering
    # copies each q, k and v block; shard_map writes each block into the
    # assembled output) against the plain forward's own
    with torch.no_grad():
        def run_mesh32():
            with ctx, use_mesh(mesh):
                T.forward(cfg, params32, ins)

        profiles = dict(mesh=profile_device(run_mesh32),
                        plain=profile_device(lambda: T.forward(cfg, params32, ins)))
    for label, prof in profiles.items():
        if not prof:
            print(f"[mesh] {label} f32 forward: the profiler saw no device event "
                  "(not measured)")
            continue
        print(f"[mesh] {label} f32 forward traced: {prof['events']} device events, "
              f"busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span "
              f"(idle share {prof['idle_share']:.3f}); K1 {prof['matmul_ms']:.3f} ms, "
              f"K3 {prof['flash_attention_ms']:.3f} ms, copies {prof['copy_ms']:.3f} ms "
              f"in {prof['copy_events']} events")
        for name, ms in prof["top_ms"].items():
            print(f"[mesh]   {ms:8.3f} ms  {name}")

    # the same forward in bf16, dispatched under the mesh and plain, timed
    del params32
    torch.cuda.empty_cache()
    with torch.no_grad():
        T.forward(cfg, params, ins)  # warm the plain path
        plain, plain_ms = timed_ms(lambda: T.forward(cfg, params, ins))
        timing_ctx = path_context(db, tasks=tasks, backend="cuda")

        def run_mesh():
            with timing_ctx, use_mesh(mesh):
                return T.forward(cfg, params, ins)

        run_mesh()  # warm: the per-shard kernels' first calls
        tuned, tuned_ms = timed_ms(run_mesh)
    rel16 = float((tuned.float() - plain.float()).abs().max() / plain.float().abs().max())
    del tuned, plain
    print(f"[mesh] bf16 logits max_rel_err {rel16:.4e} (tol {TOL_LOGITS_REL:g}); "
          f"plain {plain_ms:.2f} ms, dispatched under the mesh {tuned_ms:.2f} ms "
          f"(median of 3, batch {MESH_BATCH} seq {SEQ})")
    if not rel16 <= TOL_LOGITS_REL:
        fail(f"mesh forward bf16 rel err {rel16} > {TOL_LOGITS_REL}")

    # one dispatched loss and its gradients under the mesh, f32
    params32 = _tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    model = build_model(cfg)
    batch = {"tokens": toks.to(torch.int32)}
    loss_ctx = path_context(db, tasks=tasks, backend="cuda")
    counts0 = read_counts()
    with loss_ctx, use_mesh(mesh):
        loss_d, g_d = value_and_grad(model.loss, params32, batch)
    torch.cuda.synchronize()
    loss_counts = {k: n - counts0[k] for k, n in read_counts().items()}
    loss_p, g_p = value_and_grad(model.loss, params32, batch)
    loss_rel = abs(float(loss_d) - float(loss_p)) / abs(float(loss_p))
    gerrs = grad_errors(g_d, g_p)
    worst = max(gerrs, key=gerrs.get)
    del g_d, g_p, params32
    torch.cuda.empty_cache()
    print(f"[mesh] loss dispatched {float(loss_d):.6f} plain {float(loss_p):.6f} "
          f"(rel {loss_rel:.3e}, tol {TOL_TRAIN_LOSS_REL:g}); gradients within "
          f"{gerrs[worst]:.3e} of max |g| (worst {worst}; tol {TOL_TRAIN_GRAD:g}); "
          f"launches {loss_counts}; stats {loss_ctx.stats}")
    if not loss_rel <= TOL_TRAIN_LOSS_REL:
        fail(f"mesh loss rel err {loss_rel} > {TOL_TRAIN_LOSS_REL}")
    if not all(e <= TOL_TRAIN_GRAD for e in gerrs.values()):
        fail(f"mesh gradients: {worst} at {gerrs[worst]} > {TOL_TRAIN_GRAD}")
    if loss_ctx.stats["misses"] or loss_ctx.stats["mesh_sharded"] <= want["mesh_sharded"]:
        fail(f"mesh loss: stats {loss_ctx.stats}; want no miss and the recompute's "
             "sites on the mesh")

    # K2 at olmoe's expert product over a (model 2) mesh
    B, M, K, N = MESH_BMM
    mesh2 = make_mesh((2,), ("model",), devices=[card] * 2)
    kw = dict(b=B // 2, m=M, n=N, k=K)
    bmm_task = TuneTask(key=workload_key("batch_matmul", **kw),
                        func=get_workload("batch_matmul", **kw), weight=1.0, use_mxu=True)
    bmm_db = Database()
    counts0 = read_counts()
    phase_tune(cfg, bmm_db, extract=lambda: [bmm_task], tag="mesh-bmm-tune")
    bmm_tune_counts = {k: n - counts0[k] for k, n in read_counts().items()}
    a = torch.randn(B, M, K, generator=gen, device="cuda")
    bm = torch.randn(B, K, N, generator=gen, device="cuda")
    bctx = path_context(bmm_db, tasks=[bmm_task], backend="cuda")
    counts0 = read_counts()
    with use_mesh(mesh2):
        got = bctx.batch_matmul(a, bm)
    torch.cuda.synchronize()
    bmm_counts = {k: n - counts0[k] for k, n in read_counts().items()}
    bmm_err = float((got - torch.bmm(a, bm)).abs().max())
    print(f"[mesh] K2 at b{B} m{M} k{K} n{N} over {mesh2}: {bmm_counts['batch_matmul']} "
          f"launches, max_abs_err {bmm_err:.3e} against "
          f"torch.bmm (tol {TOL_MATMUL:g}); stats {bctx.stats}")
    if (bmm_counts["batch_matmul"] != 2 or bctx.stats["mesh_sharded"] != 1
            or not bmm_err <= TOL_MATMUL):
        fail(f"mesh K2: launches {bmm_counts}, stats {bctx.stats}, err {bmm_err}")
    del a, bm, got

    # the dry run of smollm's cells on both production meshes (meta only)
    dry = {}
    for shape_name in DRYRUN_SHAPES:
        for multi_pod in (False, True):
            t0 = time.perf_counter()
            rec = dryrun.run_cell(cfg.name, shape_name, multi_pod)
            wall = time.perf_counter() - t0
            if rec["status"] != "ok":
                fail(f"dry run {cfg.name} {shape_name} {rec['mesh']}: {rec}")
            dry[f"{shape_name}/{rec['mesh']}"] = dict(
                wall_s=wall, n_devices=rec["n_devices"],
                argument_gib=rec["memory"]["argument_bytes"] / 2**30,
                output_gib=rec["memory"]["output_bytes"] / 2**30,
                flops_per_device=rec["cost"]["flops"])
            print(f"[mesh] dry run {cfg.name} {shape_name} {rec['mesh']}: "
                  f"{rec['n_devices']} devices, arguments "
                  f"{rec['memory']['argument_bytes'] / 2**30:.4f} GiB a device, "
                  f"{rec['cost']['flops']:.4e} FLOPs a device, {wall:.1f} s")

    # each per-shard kernel as phase 6 times it, with its launches a forward
    timings = phase_timings(tasks, runs, gen, cfg.vocab)
    for key, row in timings.items():
        row["forward_launches"] = n_coords * by_key.get(key, {}).get("hits", 0)
    phase_s = time.perf_counter() - t_phase
    print(f"[mesh] phase 19 took {phase_s:.1f} s")
    path_counts = {k: tune_counts[k] + fwd_counts[k] + loss_counts[k]
                   + bmm_tune_counts[k] + bmm_counts[k] for k in KERNELS}
    return dict(seconds=phase_s, f32_max_rel_err=rel32, bf16_max_rel_err=rel16,
                plain_ms=plain_ms, dispatched_ms=tuned_ms, stats=stats,
                reasons=dict(reasons), launches=fwd_counts, matmul_variants=k1v,
                flash_attention_variants=k3v, rmsnorm_hits=norm_hits,
                loss_rel_err=loss_rel, grad_max_rel_err=gerrs[worst],
                loss_launches=loss_counts, bmm_err=bmm_err, dryrun=dry,
                profiles=profiles, timings=timings, tune_best=best), fwd_counts, \
        path_counts


def start_examples() -> dict:
    """Phase 22, started: the ``examples/*_torch.py`` twins, each its own
    process on the card (``--device cuda``, the default), the three started
    together with one temporary directory under the git-ignored ``build/``
    for their databases, and this process's timing-lock directory
    (``REPRO_TIMING_LOCK_DIR``), so that their timings and phase 8's, which
    runs beside them, take turns on the card.  ``finish_examples`` collects
    them."""
    from repro_torch.search.measure.local import LOCK_DIR_ENV

    tmp = ROOT / "build" / f"examples_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    lock_dir = os.environ.get(LOCK_DIR_ENV) or tempfile.gettempdir()
    env = dict(os.environ, PYTHONPATH=str(SRC), TMPDIR=str(tmp),
               **{LOCK_DIR_ENV: lock_dir})
    procs = {script: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script), *args, "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for script, args in EXAMPLE_RUNS}
    return dict(procs=procs, tmp=tmp, t0=time.perf_counter())


def finish_examples(started: dict) -> dict:
    """Phase 22, collected: each twin must exit 0 and print its result, the
    quickstart its recorded trace and a finite best, the serving twin 8 of
    8 requests served, the training twin a falling loss.  Past 300 s from
    their start the twins still running are killed and the phase fails;
    their temporary directory is removed."""
    import re
    import shutil

    procs, t0 = started["procs"], started["t0"]
    outs = {}
    try:
        for script, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
            outs[script] = (proc.returncode, stdout, stderr, time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(started["tmp"], ignore_errors=True)
    rows = {}
    for script, args in EXAMPLE_RUNS:
        rc, stdout, stderr, wall = outs[script]
        tail = stdout.strip().splitlines()[-3:]
        print(f"[examples] {script} {' '.join(args)}: exit {rc}, collected {wall:.1f} s "
              f"after the three started; last lines {tail}")
        if rc != 0:
            fail(f"{script} exited {rc}: {stderr[-2000:]}")
        if script == "quickstart_torch.py":
            m = re.search(r"best latency\s*:\s*(\S+) us", stdout)
            best = float(m.group(1)) if m else float("nan")
            ok = "=== recorded trace (Figure 6) ===" in stdout and \
                "device            : cuda" in stdout and math.isfinite(best)
            rows[script] = dict(wall_s=wall, best_us=best)
        elif script == "serve_batched_torch.py":
            ok = "served 8/8 requests on cuda" in stdout
            rows[script] = dict(wall_s=wall, served=ok)
        else:
            m = re.search(r"done: first loss (\S+) -> last (\S+) ", stdout)
            first, last = (float(x) for x in m.groups()) if m else (math.nan, math.nan)
            ok = last < first and "training improved loss" in stdout
            rows[script] = dict(wall_s=wall, first_loss=first, last_loss=last)
        if not ok:
            fail(f"{script}: the output lacks its result: {stdout[-2000:]}")
    return rows


def flex_cases(cfg) -> list:
    """The (q shape, k shape, bias shape, window) of every ``flex_call``
    that phases 3e and 6 time for gemma2 (``cfg``): K3 at (1, H, GEMMA_SEQ,
    D) with the window and global, K5 at the tick (t SERVE_MAX_SEQ, every
    position) and over GEMMA_SEQ positions with the window, each with the
    attention softcap."""
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = SERVE_SLOTS
    k3 = [((BATCH, H, GEMMA_SEQ, D), (BATCH, KVH, GEMMA_SEQ, D), None, w)
          for w in (cfg.local_window, 0)]
    k5 = [((B, KVH, H // KVH, D), (B, KVH, t, D), (B, t), w)
          for t, w in ((SERVE_MAX_SEQ, 0), (GEMMA_SEQ, cfg.local_window))]
    return k3 + k5


def flex_inputs(q_shape, k_shape, bias_shape, window):
    """A ``flex_cases`` entry's inputs, the same in every process: q, k and
    v N(0, 1) from a generator seeded ``FLEX_SEED``; K5's bias over every
    position, inside the window."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(FLEX_SEED)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               for shape in (q_shape, k_shape, k_shape))
    bias = None
    if bias_shape is not None:
        bias = decode_bias([bias_shape[1]] * bias_shape[0], bias_shape[1], window)
    return q, k, v, bias


def flex_process() -> None:
    """``--flex``: compile ``flex_call`` at every ``flex_cases`` entry, wait
    for a line on stdin (the parent's word that the card is idle), then
    hold each call against the plain version on the entry's inputs and
    time it (host median and CUDA-graph device ms); the results go out as
    one JSON line."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ref

    cfg = get_config(GEMMA_ARCH)
    cap = cfg.attn_softcap
    calls = []
    for case in flex_cases(cfg):
        q, k, v, bias = flex_inputs(*case)
        call = (flex_call(q, k, v, window=case[3], softcap=cap) if bias is None else
                flex_call(q, k, v, softcap=cap, bias=bias))
        call()
        calls.append((case, q, k, v, bias, call))
    torch.cuda.synchronize()
    print(f"[flex] compiled {len(calls)} calls", flush=True)
    sys.stdin.readline()
    rows = []
    for case, q, k, v, bias, call in calls:
        if bias is None:
            want = ref.flash_attention(q, k, v, causal=True, window=case[3] or None,
                                       softcap=cap)
        else:
            want = ref.decode_attention(q, k, v, bias, softcap=cap)
        err = float((call().reshape(want.shape) - want).abs().max())
        del want
        rows.append(dict(case=case, max_abs_err=err, ms=median_ms(call),
                         device_ms=graph_ms(call)))
    print(json.dumps({"flex": rows}))


# the flex_attention times by (q shape, k shape, window), from the flex
# process (``finish_flex``), for phases 3e and 6
FLEX_TIMES = {}


def start_flex():
    """``flex_process`` in its own process, started before phase 7 so that
    its compiles (over a minute for the four calls) overlap phases 7 and
    8; stopped at exit if still running."""
    import atexit

    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--flex"],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def finish_flex(started) -> None:
    """Tell the flex process that the card is idle (phases 8 and 22 over,
    nothing else running), collect its times into ``FLEX_TIMES`` and hold
    each call within TOL_ATTN of the plain version."""
    proc, t0 = started
    try:
        out, _ = proc.communicate("go\n", timeout=max(1.0, 300 - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = out.strip().splitlines()
    print(f"[flex] the flex_attention process exited {proc.returncode} "
          f"{time.perf_counter() - t0:.1f} s after its start: "
          f"{[line for line in lines if line.startswith('[flex]')]}")
    if proc.returncode != 0 or not lines or not lines[-1].startswith('{"flex"'):
        fail(f"the flex_attention process failed: {out[-2000:]}")
    for row in json.loads(lines[-1])["flex"]:
        q_shape, k_shape, bias_shape, window = row["case"]
        kind = "K3" if bias_shape is None else "K5"
        print(f"[flex] {kind} q {q_shape} k {k_shape} window {window}: max_abs_err "
              f"{row['max_abs_err']:.3e} against plain (tol {TOL_ATTN:g}); host "
              f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms")
        if not row["max_abs_err"] <= TOL_ATTN:
            fail(f"flex_attention {row['case']}: max_abs_err {row['max_abs_err']}")
        FLEX_TIMES[(tuple(q_shape), tuple(k_shape), window)] = row


def add_flex_times(rows: dict) -> None:
    """Phase 3e's rows get the flex process's times on their inputs as
    their library times (device ms, as the rows' own)."""
    for key, row in rows.items():
        q_shape, k_shape, window = row["flex"]
        lib = FLEX_TIMES.get((q_shape, k_shape, window))
        if lib is None:
            fail(f"no flex_attention time for {key}")
        row["library_ms"] = row["library_device_ms"] = lib["device_ms"]
        print(f"[time] {key}: library {lib['device_ms']:.4f} ms (flex_attention, device; "
              f"the kernel's {row['device_ms']:.4f} ms)")


def flex_time(q, k, window: int) -> dict:
    """The flex process's row at these shapes (the softcap is gemma2's)."""
    row = FLEX_TIMES.get((tuple(q.shape), tuple(k.shape), window))
    if row is None:
        fail(f"no flex_attention time at q {tuple(q.shape)} k {tuple(k.shape)} "
             f"window {window}: not a flex_cases entry")
    return row


def phase_operators() -> dict:
    """``tune_workload`` on the ``cuda`` backend for each paper operator at
    its reduced shape, and for ``sfm`` at its default 256x256: each must
    reach a finite best, sfm through K4 and the others through the
    structural lowering (``torch-fallback`` in the best record's meta)."""
    import repro_torch
    from repro_torch.core.workloads import PAPER_OPERATORS, REDUCED_KWARGS
    from repro_torch.search.database import Database, workload_key
    from repro_torch.search.evolutionary import SearchConfig

    runs = [(n, REDUCED_KWARGS[n]) for n in PAPER_OPERATORS] + [("sfm", dict(m=256, n=256))]
    # one round of 4 candidates, not two: a dep or cbr candidate whose one
    # call ran 37-56 s took most of phase 8 in five of eight runs (1-6 s
    # otherwise), and each operator's first round reached a finite best
    # (on an H100; PERF.md §6)
    search = SearchConfig(max_trials=4, init_random=4, population=8,
                          measure_per_round=4)
    rows = {}
    for name, kw in runs:
        db = Database()
        config = repro_torch.TuneConfig(
            search=search, runner_spec="cached+local", backend="cuda",
            device="cuda", warm_start=False,
        )
        t0 = time.perf_counter()
        res = repro_torch.tune_workload(name, kw, config=config, database=db)
        wall = time.perf_counter() - t0
        key = workload_key(name, **kw)
        rec = db.best(key)
        meta = rec.meta if rec is not None else {}
        lowered = meta.get("pallas_kernel") or meta.get("lowered_with")
        rows[key] = dict(best_ms=res.best_latency_s * 1e3,
                         plain_ms=res.baseline_latency_s * 1e3,
                         default_ms=res.default_latency_s * 1e3,
                         trials=res.trials, failures=res.measure_failures,
                         lowered=lowered, wall_s=wall)
        print(f"[operators] {key}: best {res.best_latency_s * 1e3:.4f} ms, plain "
              f"{res.baseline_latency_s * 1e3:.4f} ms, untuned "
              f"{res.default_latency_s * 1e3:.4f} ms; {res.trials} trials, "
              f"{res.measure_failures} failed; {lowered}; {wall:.1f} s")
        if not math.isfinite(res.best_latency_s):
            fail(f"{key} has no finite best latency")
        want = "row_softmax" if name == "sfm" else "torch-fallback"
        if lowered != want:
            fail(f"{key}: best record lowered with {lowered}, want {want}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory to write chip_smoke.json into")
    ap.add_argument("--flex", action="store_true",
                    help="only time the flex_attention calls (the process finish_flex reads)")
    args = ap.parse_args(argv)
    # the compile caches of flex_attention (the flex process) inside the
    # checkout
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "torchinductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.flex:
        flex_process()
        return 0

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          "allow_tf32 False (matmul, cudnn)")

    from repro_torch.configs.base import get_config
    from repro_torch.search.database import Database, workload_key

    def clock(phase: str) -> None:
        print(f"[clock] {phase} done at {time.perf_counter() - t_start:.1f} s")

    build_s = phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = phase_kernels(gen)

    decode_tiles = phase_decode_kernels(gen, errs)
    ssd_row = phase_ssd_kernel(gen, errs)
    attention_tiles = phase_attention_tiles(gen, errs)
    gemma_rows = phase_gemma_kernels(errs)
    arctic_kernel_rows = phase_arctic_kernels(gen, errs)
    clock("phases 2-3f")

    cfg = get_config("smollm-135m")
    db = Database()
    reset_counts()  # the forward path starts here
    t0 = time.perf_counter()
    tasks, best = phase_tune(cfg, db)
    local_tune_s = time.perf_counter() - t0
    tune_counts = read_counts()
    print(f"[tune] kernel launches while tuning: {tune_counts}")
    for k in FORWARD_KERNELS:
        if tune_counts[k] <= 0:
            fail(f"{k} was not launched while tuning")
    clock("phase 4")
    runs = check_tiles(tasks, db)
    fwd, fwd_counts = phase_forward(cfg, tasks, db)
    clock("phase 5")

    # the process that compiles the flex_attention calls beside phases 7
    # and 8 (its compiles outlast phase 8 alone) and times them once the
    # card is idle, collected before phase 6 times anything
    flex_run = start_flex()
    serve_db = Database()
    reset_counts()  # the serving path starts here
    serve_tasks, serve_best, serve, serve_tune_counts, serve_runs = phase_serve(
        cfg, serve_db)
    runs.update(serve_runs)
    clock("phase 7")

    # phase 22, the examples' twins, runs beside phase 8 (each in its own
    # process), and is collected before phase 6 times anything
    examples_run = start_examples()
    reset_counts()  # the operator path starts here
    operators = phase_operators()
    op_counts = read_counts()
    clock("phase 8")
    examples = finish_examples(examples_run)
    clock("phase 22 (beside phase 8)")
    finish_flex(flex_run)
    add_flex_times(gemma_rows)
    clock("phase 3e's library times")
    print(f"[operators] kernel launches: {op_counts}")
    if op_counts["row_softmax"] <= 0:
        fail("row_softmax was not launched on the operator path")
    # phase 6 for the smollm paths, before the mamba2 ones
    rows = phase_timings(tasks, runs, gen, cfg.vocab)
    rows.update(phase_timings(serve_tasks, runs, gen, cfg.vocab))
    rows["paged_decode"] = paged_timing(gen, SERVE_MAX_SEQ, SERVE_PAGE)
    rows["ssd"] = ssd_row
    structural = structural_timings(tasks, db)
    structural.update(structural_timings(serve_tasks, serve_db))
    fixed = fixed_tile_timings(gen)
    clock("phase 6")

    ssm_cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_LAYERS)
    ssm_db = Database()
    reset_counts()  # the mamba2 forward path starts here
    ssm_tasks, ssm_best, ssm_fwd, ssm_tune_counts, ssm_fwd_counts, ssm_runs = \
        phase_model_forward(ssm_cfg, ssm_db, "ssm-forward", SSM_FORWARD_TASKS, dict(
            # every layer's scan through K7, its norm and the final one, and
            # the unembed; held in f32 at TOL_LOGITS_REL: one-ulp differences
            # of the scan grow through the layers of random weights
            ssd=ssm_cfg.n_layers, rmsnorm=ssm_cfg.n_layers + 1, attention={},
            hits={workload_key("dense", k=ssm_cfg.d_model, m=BATCH * SEQ,
                               n=ssm_cfg.vocab): 1}), tol=TOL_LOGITS_REL)
    # phase 6 for the mamba2 unembed, the one K1 site of its paths
    rows.update(phase_timings(unembed_tasks(ssm_tasks, ssm_runs, ssm_cfg.vocab),
                              ssm_runs, gen, ssm_cfg.vocab))
    clock("phase 9")

    ssm_serve_db = Database()
    reset_counts()  # the mamba2 serving path starts here
    ssm_serve_tasks, ssm_serve_best, ssm_serve, ssm_serve_tune_counts, ssm_serve_runs = \
        phase_ssm_serve(ssm_cfg, ssm_serve_db)
    rows.update(phase_timings(
        unembed_tasks(ssm_serve_tasks, ssm_serve_runs, ssm_cfg.vocab),
        ssm_serve_runs, gen, ssm_cfg.vocab))
    clock("phase 10")

    moe_cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    moe_db = Database()
    reset_counts()  # the olmoe forward path starts here
    moe_tasks, moe_best, moe_fwd, moe_tune_counts, moe_fwd_counts, moe_runs = \
        phase_moe_forward(moe_cfg, moe_db)
    clock("phase 11")

    moe_serve_db = Database()
    reset_counts()  # the olmoe serving path starts here
    moe_serve_tasks, moe_serve_best, moe_serve, moe_serve_tune_counts, moe_serve_runs = \
        phase_serve(moe_cfg, moe_serve_db, tag="moe-serve")
    clock("phase 12")
    # phase 6 at olmoe's shapes: K2's expert products (m64, m32, m4), K3's
    # fma at D 128, K5 at G 1 and D 128, K1's projections and unembed
    torch.cuda.empty_cache()
    rows.update(phase_timings(moe_tasks, moe_runs, gen, moe_cfg.vocab))
    rows.update(phase_timings(moe_serve_tasks, moe_serve_runs, gen, moe_cfg.vocab))
    clock("phase 6 (olmoe)")

    torch.cuda.empty_cache()
    train_cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    train_db = Database()
    reset_counts()  # the smollm training path starts here
    _, train_best, train, train_tune_counts, train_counts, train_rows = phase_train(
        train_cfg, gen, train_db, launcher=True,
        # K3 at every layer, on tc, and its recompute; K1 at every dense site
        # twice but the unembed's (phase_train)
        want=dict(flash_attention=2 * TRAIN_LAYERS, flash_attention_tc=2 * TRAIN_LAYERS))
    clock("phase 13")
    torch.cuda.empty_cache()
    reset_counts()  # the mamba2 training path starts here
    _, _, ssm_train, _, ssm_train_step_counts, _ = phase_train(
        ssm_cfg, gen, tag="ssm-train", scan_leaves=SSD_SCAN_LEAVES,
        # the scan through K7 at every layer and its recompute
        want=dict(ssd=2 * ssm_cfg.n_layers))
    ssm_train_counts = read_counts()
    clock("phase 14")

    torch.cuda.empty_cache()
    vl_cfg = dataclasses.replace(get_config(VL_ARCH), n_layers=VL_LAYERS)
    vl_db = Database()
    reset_counts()  # the qwen2-vl forward path starts here
    vl_tasks, vl_best, vl_fwd, vl_tune_counts, vl_fwd_counts, vl_runs = \
        phase_model_forward(vl_cfg, vl_db, "vl-forward", VL_FORWARD_TASKS, dict(
            # q, k, v, o and the MLP of every layer; the unembed has no
            # schedule (``schedulable``) and runs plain
            matmul=7 * vl_cfg.n_layers, batch_matmul=0,
            flash_attention=vl_cfg.n_layers, flash_attention_fma=vl_cfg.n_layers,
            rmsnorm=2 * vl_cfg.n_layers + 1,
            attention={"attention/b=1/causal=1/d=128/h=12/kvh=2/s=256/softcap=0.0/"
                       "window=0": vl_cfg.n_layers}))
    vl_serve_db = Database()
    reset_counts()  # the qwen2-vl serving path starts here
    vl_serve_tasks, vl_serve_best, vl_serve, vl_serve_tune_counts, vl_serve_runs = \
        phase_serve(vl_cfg, vl_serve_db, tag="vl-serve", decode_tasks=VL_DECODE_TASKS)
    clock("phase 15")

    torch.cuda.empty_cache()
    wh_cfg = dataclasses.replace(get_config(WHISPER_ARCH), n_layers=WHISPER_LAYERS,
                                 enc_layers=WHISPER_LAYERS)
    wh_db = Database()
    reset_counts()  # the whisper forward path starts here
    L_enc, L_dec = wh_cfg.enc_layers, wh_cfg.n_layers
    wh_tasks, wh_best, wh_fwd, wh_tune_counts, wh_fwd_counts, wh_runs = \
        phase_model_forward(wh_cfg, wh_db, "whisper-forward", WHISPER_FORWARD_TASKS, dict(
            # the encoder's q, k, v, o and MLP (7 a layer), the decoder's
            # self-attention, cross-attention wo and MLP (8 a layer), the
            # unembed; the cross-attention's q, k, v run plain, as in the
            # reference; K2 at its two contractions of two 1024-frame chunks
            matmul=7 * L_enc + 8 * L_dec + 1, batch_matmul=4 * L_dec,
            flash_attention=L_enc + L_dec, flash_attention_fma=L_enc,
            rmsnorm=2 * L_enc + 1 + 3 * L_dec + 1,
            attention={
                f"attention/b=1/causal=0/d=64/h=16/kvh=16/s={wh_cfg.enc_frames}/"
                "softcap=0.0/window=0": L_enc,
                f"attention/b=1/causal=1/d=64/h=16/kvh=16/s={SEQ}/softcap=0.0/"
                "window=0": L_dec}))
    wh_dec_db = Database()
    reset_counts()  # the whisper decoding path starts here
    wh_dec_tasks, wh_dec_best, wh_dec, wh_dec_tune_counts, wh_dec_counts, wh_dec_runs = \
        phase_whisper_decode(wh_cfg, wh_dec_db)
    clock("phase 16")
    # phase 6 at the two models' shapes: K1 at m1500 and at the n51865 and
    # n151936 unembeds, K2 b16 m256, K3 non-causal at S 1500 and at D 128
    # GQA 6, K5 at t1500 and at D 128 G6
    torch.cuda.empty_cache()
    for t_list, t_runs, vocab in ((vl_tasks, vl_runs, vl_cfg.vocab),
                                  (vl_serve_tasks, vl_serve_runs, vl_cfg.vocab),
                                  (wh_tasks, wh_runs, wh_cfg.vocab),
                                  (wh_dec_tasks, wh_dec_runs, wh_cfg.vocab)):
        rows.update(phase_timings(t_list, t_runs, gen, vocab))
    clock("phase 6 (qwen2-vl, whisper)")

    torch.cuda.empty_cache()
    reset_counts()  # the fleet path starts here
    fleet, fleet_fwd_counts = phase_fleet(cfg, db, local_tune_s)
    fleet_counts = read_counts()
    clock("phase 17")

    torch.cuda.empty_cache()
    reset_counts()  # the router path starts here
    router = phase_router(serve_db)
    router_counts = read_counts()
    clock("phase 18")

    torch.cuda.empty_cache()
    reset_counts()  # the mesh path starts here
    mesh, mesh_fwd_counts, mesh_counts = phase_mesh(cfg, Database(), gen)
    clock("phase 19")

    from repro_torch.models.transformer import layer_windows

    torch.cuda.empty_cache()
    gm_cfg = dataclasses.replace(get_config(GEMMA_ARCH), n_layers=GEMMA_LAYERS)
    L = gm_cfg.n_layers
    windows = [int(w) for w in layer_windows(gm_cfg)]
    gm_attn = Counter(
        f"attention/b={BATCH}/causal=1/d={gm_cfg.head_dim}/h={gm_cfg.n_heads}/"
        f"kvh={gm_cfg.n_kv_heads}/s={GEMMA_SEQ}/softcap={gm_cfg.attn_softcap}/"
        f"window={w if 0 < w < GEMMA_SEQ else 0}" for w in windows)
    gm_db = Database()
    reset_counts()  # the gemma2 forward path starts here
    gm_tasks, gm_best, gm_fwd, gm_tune_counts, gm_fwd_counts, gm_runs = \
        phase_model_forward(gm_cfg, gm_db, "gemma-forward", GEMMA_FORWARD_TASKS, dict(
            # q, k, v and o of every layer: the MLP's products (m4608 k2304
            # n9216 and k9216 n2304) and the unembed exceed the schedule
            # caps (``schedulable``) and run plain
            matmul=4 * L, batch_matmul=0, flash_attention=L, flash_attention_fma=L,
            # the norm runs plain (``plain_norm``)
            rmsnorm=0, attention=dict(gm_attn)), seq=GEMMA_SEQ,
            plain_keys=plain_norm(gm_cfg, BATCH * GEMMA_SEQ),
            runner_spec=f"cached+local://timeout_s={GEMMA_TUNE_TIMEOUT_S}")
    clock("phase 20")

    torch.cuda.empty_cache()
    gm_serve_db = Database()
    reset_counts()  # the gemma2 serving path starts here
    gm_serve_tasks, gm_serve_best, gm_serve, gm_serve_tune_counts, gm_serve_runs = \
        phase_serve(gm_cfg, gm_serve_db, tag="gemma-serve",
                    serve_tasks=GEMMA_SERVE_TASKS, new_tokens=GEMMA_NEW_TOKENS,
                    plain_keys=plain_norm(gm_cfg, SERVE_SLOTS * SERVE_CHUNK),
                    tick_launches=dict(
                        # q, k, v, o and the gated MLP's three of every layer,
                        # and the decode unembed; K5 at every layer
                        matmul=7 * L + 1, decode_flash_attention=L))
    clock("phase 21")
    # phase 6 at gemma2's shapes: K1 at m4608 and the m4 unembed over the
    # 256000-wide table, K2 b4 m9216, K3 fma at D 256 with the softcap and
    # window, K4 m36864 n1024, K5 at D 256 G 2
    torch.cuda.empty_cache()
    rows.update(gemma_rows)
    rows.update(phase_timings(gm_tasks, gm_runs, gen, gm_cfg.vocab))
    rows.update(phase_timings(gm_serve_tasks, gm_serve_runs, gen, gm_cfg.vocab))
    clock("phase 6 (gemma2)")

    torch.cuda.empty_cache()
    hy_cfg = dataclasses.replace(get_config(HYMBA_ARCH), n_layers=HYMBA_LAYERS)
    hy, hy_serve, hy_rows = phase_hymba(hy_cfg, gen)
    rows.update(hy_rows)
    clock("phases 23-24 and phase 6 (hymba)")

    torch.cuda.empty_cache()
    sl_cfg = dataclasses.replace(get_config(STABLELM_ARCH), n_layers=STABLELM_LAYERS)
    L = sl_cfg.n_layers
    sl, sl_serve, sl_rows = phase_dense(
        # q, k, v, o and the MLP's three of every layer; the unembed plain;
        # unknown_key at the norm's 2·L + 1 sites and the unembed's
        sl_cfg, gen, "stablelm", STABLELM_FORWARD_TASKS, forward_k1=7 * L,
        unknown_key=2 * L + 2, plain_keys=(STABLELM_UNEMBED,))
    rows.update(sl_rows)
    clock("phases 25-26 and phase 6 (stablelm)")

    torch.cuda.empty_cache()
    hyt_cfg = dataclasses.replace(get_config(HYMBA_ARCH), n_layers=HYMBA_TRAIN_LAYERS)
    reset_counts()  # the hymba training path starts here
    hyt, hyt_tune_counts, hyt_counts, hyt_rows = phase_hymba_train(hyt_cfg, gen)
    rows.update(hyt_rows)
    clock("phase 27 and phase 6 (hymba's train step)")

    torch.cuda.empty_cache()
    qw_cfg = dataclasses.replace(get_config(QWEN15_ARCH), n_layers=QWEN15_LAYERS)
    L = qw_cfg.n_layers
    qw, qw_serve, qw_rows = phase_dense(
        # q, k, v and o of every layer (q, k and v with the bias epilogue);
        # the MLP and the unembed have no schedule (``schedulable``):
        # unknown_key at the norm's 2·L + 1 sites, the MLP's 3·L and the
        # unembed's; every task of a paged tick tuned (the contractions
        # the decode attention replaces are tuning targets)
        qw_cfg, gen, "qwen15", QWEN15_FORWARD_TASKS, forward_k1=4 * L,
        unknown_key=5 * L + 2, serve_tasks=QWEN15_SERVE_TASKS,
        plain_keys=QWEN15_TUNING_ONLY, serve_plain_keys=QWEN15_SERVE_TUNING_ONLY,
        unschedulable=(f"dense/k=8192/m={M_FWD}/n=49152", f"dense/k=49152/m={M_FWD}/n=8192",
                       f"dense/k=8192/m={M_FWD}/n=152064"),
        serve_unschedulable=("dense/k=8192/m=128/n=49152", "dense/k=49152/m=128/n=8192"))
    rows.update(qw_rows)
    clock("phases 28-29 and phase 6 (qwen1.5)")

    torch.cuda.empty_cache()
    ar_cfg = dataclasses.replace(get_config(ARCTIC_ARCH), n_layers=ARCTIC_LAYERS)
    L = ar_cfg.n_layers
    E, D, F_ = ar_cfg.moe_experts, ar_cfg.d_model, ar_cfg.d_ff
    ar, ar_serve, ar_rows = phase_dense(
        # q, k, v, o and the dense residual MLP's three of every layer; the
        # expert products (C 8) and the unembed have no schedule
        # (``schedulable``): unknown_key at the norm's 2·L + 1 sites, the
        # experts' 3·L and the unembed's; K2 serves the tick's experts (C 4)
        ar_cfg, gen, "arctic", ARCTIC_FORWARD_TASKS, forward_k1=7 * L,
        unknown_key=5 * L + 2, plain_keys=ARCTIC_TUNING_ONLY,
        unschedulable=(f"batch_matmul/b={E}/k={D}/m=8/n={F_}",
                       f"batch_matmul/b={E}/k={F_}/m=8/n={D}",
                       f"dense/k={D}/m={M_FWD}/n={ar_cfg.vocab}"),
        serve_tasks=ARCTIC_SERVE_TASKS, serve_unschedulable=(),
        f32_layers=ARCTIC_F32_LAYERS, serve_layers=ARCTIC_SERVE_LAYERS,
        serve_plain_keys=plain_norm(ar_cfg, SERVE_SLOTS) + ARCTIC_SERVE_TUNING_ONLY,
        cold_width=COLD_WIDE)
    rows.update(ar_rows)
    clock("phases 30-31 and phase 6 (arctic)")

    paths = {
        "forward": {k: tune_counts[k] + fwd_counts[k] for k in KERNELS},
        "serving": {k: serve_tune_counts[k] + serve["launches"][k] for k in KERNELS},
        "operators": op_counts,
        "mamba2_forward": {k: ssm_tune_counts[k] + ssm_fwd_counts[k] for k in KERNELS},
        "mamba2_serving": {k: ssm_serve_tune_counts[k] + ssm_serve["launches"][k]
                           for k in KERNELS},
        "olmoe_forward": {k: moe_tune_counts[k] + moe_fwd_counts[k] for k in KERNELS},
        "olmoe_serving": {k: moe_serve_tune_counts[k] + moe_serve["launches"][k]
                          for k in KERNELS},
        "smollm_train": {k: train_tune_counts[k] + train_counts[k] for k in KERNELS},
        "mamba2_train": ssm_train_counts,
        "qwen2vl_forward": {k: vl_tune_counts[k] + vl_fwd_counts[k] for k in KERNELS},
        "qwen2vl_serving": {k: vl_serve_tune_counts[k] + vl_serve["launches"][k]
                            for k in KERNELS},
        "whisper_forward": {k: wh_tune_counts[k] + wh_fwd_counts[k] for k in KERNELS},
        "whisper_decode": {k: wh_dec_tune_counts[k] + wh_dec_counts[k] for k in KERNELS},
        # the parent's launches and the workers' (each read around its timings)
        "fleet": {k: fleet_counts[k] + fleet["worker_launches"].get(k, {}).get("launches", 0)
                  for k in KERNELS},
        # the parent's in-process runs and the workers' (from the end of their
        # warm-up to the kill or the drain's end)
        "router": {k: router_counts[k] + router["worker_launches"][k] for k in KERNELS},
        # tuning, one f32 forward, one loss and its gradients, K2's expert
        # product: each per-shard kernel once a mesh coordinate
        "mesh": mesh_counts,
        "gemma2_forward": {k: gm_tune_counts[k] + gm_fwd_counts[k] for k in KERNELS},
        "gemma2_serving": {k: gm_serve_tune_counts[k] + gm_serve["launches"][k]
                           for k in KERNELS},
        "hymba_forward": {k: hy["tune_launches"][k] + hy["launches"][k] for k in KERNELS},
        "hymba_serving": {k: hy_serve["tune_launches"][k] + hy_serve["launches"][k]
                          for k in KERNELS},
        "stablelm_forward": {k: sl["tune_launches"][k] + sl["launches"][k] for k in KERNELS},
        "stablelm_serving": {k: sl_serve["tune_launches"][k] + sl_serve["launches"][k]
                             for k in KERNELS},
        # tuning and the f32 step, as smollm's
        "hymba_train": {k: hyt_tune_counts[k] + hyt_counts[k] for k in KERNELS},
        "qwen15_forward": {k: qw["tune_launches"][k] + qw["launches"][k] for k in KERNELS},
        "qwen15_serving": {k: qw_serve["tune_launches"][k] + qw_serve["launches"][k]
                           for k in KERNELS},
        "arctic_forward": {k: ar["tune_launches"][k] + ar["launches"][k] for k in KERNELS},
        "arctic_serving": {k: ar_serve["tune_launches"][k] + ar_serve["launches"][k]
                           for k in KERNELS},
    }
    launches = {k: sum(paths[p][k] for p in paths) for k in KERNELS}
    print(f"[launches] by path (tuning + run): {paths}")

    sources = {
        "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:46"),
        "batch_matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                         "src/repro/kernels/matmul.py:114"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:96"),
        "decode_flash_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/flash_attention.py:218"),
        "paged_decode_flash_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/flash_attention.py:337"),
        "row_softmax": ("src/repro_torch/kernels/csrc/softmax.cu",
                        "src/repro/kernels/softmax.py:26"),
        "ssd": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:60"),
    }
    entries = []
    hits = path_hits()
    for k in KERNELS:
        # the shape where the kernel did the most work on the paths: its
        # hits under dispatch times its work a call.  A kernel that no
        # dispatched key reaches (K6 and K7, launched directly, and K4,
        # whose sites the fused attention replaces) keeps the timed shape of
        # most extracted work; ``shape_hits`` 0 says so
        mine = [r for r in rows if rows[r]["kernel"] == k]
        on_path = [r for r in mine if hits[r]]
        key = max(on_path or mine, key=lambda r: rows[r]["flops"] * (
            hits[r] if on_path else rows[r]["weight"]))
        r = rows[key]
        entries.append(dict(
            name=k, route="cuda", source=sources[k][0], replaces=sources[k][1],
            launches=launches[k], forward_launches=fwd_counts[k],
            olmoe_forward_launches=moe_fwd_counts[k],
            olmoe_tick_launches=moe_serve["tick_check"]["launches"][k],
            smollm_train_step_launches=train_counts[k],
            mamba2_train_step_launches=ssm_train["launches"][k],
            qwen2vl_forward_launches=vl_fwd_counts[k],
            qwen2vl_tick_launches=vl_serve["tick_check"]["launches"][k],
            whisper_forward_launches=wh_fwd_counts[k],
            whisper_decode_launches=wh_dec_counts[k],
            fleet_forward_launches=fleet_fwd_counts[k],
            fleet_worker_launches=fleet["worker_launches"].get(k, {}).get("launches", 0),
            router_worker_launches=router["worker_launches"][k],
            mesh_forward_launches=mesh_fwd_counts[k],
            gemma2_forward_launches=gm_fwd_counts[k],
            gemma2_tick_launches=gm_serve["tick_check"]["launches"][k],
            hymba_forward_launches=hy["launches"][k],
            hymba_tick_launches=hy_serve["tick_check"]["launches"][k],
            stablelm_forward_launches=sl["launches"][k],
            stablelm_tick_launches=sl_serve["tick_check"]["launches"][k],
            hymba_train_step_launches=hyt["launches"][k],
            qwen15_forward_launches=qw["launches"][k],
            qwen15_tick_launches=qw_serve["tick_check"]["launches"][k],
            arctic_forward_launches=ar["launches"][k],
            arctic_tick_launches=ar_serve["tick_check"]["launches"][k],
            launches_by_path={p: paths[p][k] for p in paths},
            max_abs_err=errs[k], ms=r["ms"], device_ms=r["device_ms"],
            plain_ms=r["plain_ms"], library_device_ms=r.get("library_device_ms"),
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=key, shape_hits=hits[key],
            blocks=r["blocks"],
            **{k: r[k] for k in ("variant", "bound_f32_ms", "bound_3xtf32_ms", "splits") if k in r},
        ))
    total_s = time.perf_counter() - t_start
    print(f"[done] build {build_s:.1f} s, total {total_s:.1f} s")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           total_s=total_s, kernels=entries, timings=rows,
                           forward=fwd, tune_best=best,
                           tune_launches=tune_counts, serve=serve,
                           serve_tune_best=serve_best, operators=operators,
                           structural=structural, ssm_forward=ssm_fwd,
                           ssm_tune_best=ssm_best, ssm_serve=ssm_serve,
                           ssm_serve_tune_best=ssm_serve_best,
                           moe_forward=moe_fwd, moe_tune_best=moe_best,
                           moe_serve=moe_serve, moe_serve_tune_best=moe_serve_best,
                           train=train, train_tune_best=train_best,
                           train_timings=train_rows, ssm_train=ssm_train,
                           vl_forward=vl_fwd, vl_tune_best=vl_best, vl_serve=vl_serve,
                           vl_serve_tune_best=vl_serve_best, whisper_forward=wh_fwd,
                           whisper_tune_best=wh_best, whisper_decode=wh_dec,
                           whisper_decode_tune_best=wh_dec_best, fleet=fleet,
                           router=router, mesh=mesh, gemma2_forward=gm_fwd,
                           gemma2_tune_best=gm_best, gemma2_serve=gm_serve,
                           gemma2_serve_tune_best=gm_serve_best, examples=examples,
                           hymba_forward=hy, hymba_serve=hy_serve,
                           stablelm_forward=sl, stablelm_serve=sl_serve, hymba_train=hyt,
                           qwen15_forward=qw, qwen15_serve=qw_serve,
                           arctic_forward=ar, arctic_serve=ar_serve,
                           arctic_kernels=arctic_kernel_rows,
                           launches_by_path=paths, fixed_tiles=fixed,
                           decode_tiles=decode_tiles,
                           attention_tiles=attention_tiles,
                           matmul_variants=dict(
                               forward=fwd["matmul_variants"],
                               decode_tick=serve["tick_check"]["matmul_variants"],
                               mamba2_forward=ssm_fwd["matmul_variants"],
                               olmoe_forward=moe_fwd["matmul_variants"],
                               olmoe_decode_tick=moe_serve["tick_check"]["matmul_variants"]),
                           batch_matmul_variants=dict(
                               olmoe_forward=moe_fwd["batch_matmul_variants"],
                               olmoe_decode_tick=moe_serve["tick_check"][
                                   "batch_matmul_variants"])), f, indent=1)
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
