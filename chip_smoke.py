#!/usr/bin/env python3
"""Drive the PyTorch port of the paged-attention server on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the root of a checkout
    python3 chip_smoke.py --kernels-only  # build + kernel phase only
    python3 chip_smoke.py --train-only    # build + training phase only
    python3 chip_smoke.py --dist-only     # build + distributed phase only
    python3 chip_smoke.py --launch-only   # build + launch phase only
    python3 chip_smoke.py --dry-only      # build + dry-run phase only

Phases, each of which fails the script (exit code 1) when it fails:

1. build: compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a), print the card's name and power limit, the registers, shared
   memory and spills of the tensor-core kernels and of K1 (``-Xptxas
   -v``), and the count of HGMMA (wgmma) instructions in the library, which
   must not be 0, and of TF32 HGMMA instructions in the split-TF32
   kernels, which must not be 0 either;
2. kernels: each hand-written kernel — K1 paged decode partials, K2 split-K
   combine, K3 chunked paged prefill partials, K4 flex prefill — against
   its plain PyTorch version on the card, at the full-width llama2-7b
   shapes of the main paths (H = Hkv = 32, D = 128, page 64, batch 8; K1:
   lens 256..2048, 2 pages per block, 4 splits; K3: a 512-token chunk
   step resuming at 0..1061, dead rows, q_block 128; K4: prompts up to
   1536) and on small sweeps (GQA, window, softcap, int8, D = 64, split-K,
   q_block 1 and 3, single-token chunks, Q-blocks over 128 rows), in f32
   (tolerance 2e-5) and bf16 (2e-2), with |a - b| <= tol * (1 + |b|).
   The decode op (K1 then K2 from one call, ``paged_attention_kernel``,
   at every split count) is checked beside K1 and K2 everywhere: against
   its plain version and against the two wrappers called one after the
   other bit for bit (``torch.equal``), all-dead slots exact zeros, and at
   every split count 1 to 8 and 12 with one K2 launch each; timed beside
   SDPA: its wall time, its kernels' device time and the host's share.
   K2 on K3's partials (``combine_prefill_partials``, strided, into (B, C,
   H, D)) against its plain version at S 1, 2 and 4 on every K3 route and
   on every K3 case of the sweeps, and timed per layer at the main chunk
   step beside the folded path it replaced.  K1's edge cases:
   lens 0, 1, 63, 64, 65, 512, 513 and 2048 (empty splits), the full
   32-page table in one split of 2048 keys, pages of 8 and 16 tokens at
   smoke width (f32, bf16, int8 pools).  The full-table cases of K1 and of
   K3 in f32 also print how far each side is from the plain version
   evaluated in f64.
   K3 and K4 run on the tensor cores by route: bf16 on the bf16 tile
   ("_tc": wgmma, K/V by TMA), f32 on the split-TF32 tile ("_tf32x3":
   every product as three TF32 products on wgmma); K3's int8 pools on
   either tile ("_tc/int8", "_tf32x3/int8": int8 boxes widened into a
   working stage, kv_scale folded in; both timed at the main shapes) and
   its odd pages ("/odd": the gaps between boxes masked).  Each route is
   checked and timed under its own name.  Edge cases of the tiles: K4 at
   Q = K = 2048, K3 resuming at 1536 over a full 32-page table (both also
   against f64 in f32), Q-blocks of 128 and 120 rows, pages of 7 (at D 64
   and 192, G 1 and 6, every pool), 8, 12, 16, 96, 128 and 200 tokens, D
   = 64, and a case per kernel with distinct V rows and scores
   that are not symmetric in the keys (a wrong key permutation in the
   f32 tile's p.V shows there).  Times: kernel, plain version, the bound
   the card sets (f32: the operations at 67 TFLOP/s, ``bound_ms``, and
   three TF32 products per f32 one at 495 TFLOP/s, printed beside it),
   and one PyTorch library call for the same function (K4: SDPA with the
   causal & padding mask; the causal-only SDPA time is printed beside it).
   K4's mask and score variants (the mods of core.flex lowered into the
   kernel's descriptor) on both routes against the plain version with the
   kernel's own product arithmetic (bf16: P in one bf16 term, 2e-2; f32:
   three TF32 products, 2e-5): at B 4, H = Hkv = 32, D 128, Q = K = 4096
   with padding lens 3500..4096, causal & padding, window & padding at
   1024 and 4096 (also against f64 in f32) and one case of each other
   family (document, prefix-LM | window, softcap, ALiBi), each timed
   (device), bounded by its live pairs and timed beside SDPA with the same
   boolean mask or ALiBi bias (none for softcap), and PyTorch's compiled
   FlexAttention on window & padding as a yardstick; then a sweep at
   small shapes over every mod (windows 1, 100, 1000; documents; prefix-LM
   0, 100, Q; or; paged; softcap, ALiBi, compose_score both ways) with D
   64, GQA, q tiles of 120 and ragged K.  K1 on ring tables at full width
   (window 4096, 65 pages, lens 4160..5016).  The GQA groups and head dims
   of the Nemotron-4 family: K1 at G 3, 6, 12, 16 and 24 by D 64, 128 and
   192 with f32, bf16 and int8 pools, on a ring table at G 6, on int8
   pools with odd 7-token pages at D 64 and 192, and at G 32 (two
   chunks over the grid) against G 16 on the same pools, timed; K3 on
   both tiles (pages of 16; odd pages of 12, int8 pools with either q)
   and K4 on both tiles at D 192 with G 6 and 12 (K3 at the engine's
   q_block: R = 126 and 120 rows; K4 causal & padding and window &
   padding); and K1, K3 and K4 at the real heads of nemotron-4-15b (48 /
   8, D 128), llama3-405b (128 / 8, D 128) and nemotron-4-340b (96 / 8, D
   192) at batch 4 (K1) and 2 (K3, K4), each timed (device) beside its
   bound and SDPA with ``enable_gqa``.  Head dim 256, at recurrentgemma-
   9b's heads (16 over one kv head: G 16): K1, K2 and the decode op on
   ring tables as its 'W' layers decode (batch 8, window 2048, a ring of
   33 pages of 64, lens 2200..3000) in f32, bf16 and int8; K3 on each of
   its eight routes at G 1 and 16, and timed at the real heads' chunk
   step on four; K4 under window 2048 & padding (B 2, Q = K = 3072) on
   both tiles, and causal & document and causal + softcap; each timed
   case beside its plain version, its bound and SDPA, its errors kept as
   the kernel's D-256 instance (``<kernel>/d256``).  The f32 cases whose
   plain version carries rounding of the order of the f32 tolerance
   (K3's full table, D 192 and 256, the real heads' long rows) are held
   against the plain version evaluated in f64 instead;
3. model: llama2-7b widths at 4 layers in f32: prefill and 3 decode
   steps through the kernels (K4 and K3 on the split-TF32 tile) agree with
   the plain oracle path; chunked prefill in chunks of 96 through K3 agrees
   with the monolithic prefill through K4 and with the plain path, and so
   does the chunked prefill over int8 pools (K3's "tf32x3/int8"); a
   smoke-size engine gives the plain path's greedy tokens on the kernel
   path, monolithic and chunked, with and without the prefix cache;
4. engine: full llama2-7b (32 layers, random weights from a seed, bf16)
   served by ``repro_torch.serving.Engine``: 8 slots, max_seq_len 2048,
   12 greedy requests with prompts of 256..1536 tokens and 32 new tokens
   each, monolithic prefill.  Kernel launch counts are reset just before
   and read just after: K1, K2 and K4's bf16 route must have launched, K3
   and K4's f32 route not.  In every engine phase K2 must launch at the
   decode layout (``combine/decode``) whenever K1 launches, and on K3's
   partials (``combine/prefill``) exactly when K3 launches; the profiled
   chunk steps must show K2 time;
5. chunked: the same weights served with ``prefill_chunk=512`` and
   ``prefix_cache=True``: a wave of 4 requests, then a wave of 8, each
   prompt a shared 1024-token head plus its own 128..512-token tail, 32
   new tokens each.  Counts reset before the first wave and read after
   the second: K1, K2 and K3's bf16 route must have launched, K4 and
   K3's other routes not, and the second wave must hit at least
   8 x 1024 cached tokens.  The profiled steps of both phases must
   attribute device time to K4 (prefill step) and K3 (chunk step);
5b. int8 engine: the same weights, prompts and knobs with an int8 KV
   cache (``kv_dtype="int8"``: the same 256 pages at half the bytes, which
   is checked): K3's "tc/int8", K1 and K2 must launch, K4 and K3's other
   variants never, the second wave must hit 8 x 1024 tokens; its chunk
   step, decode step, TTFT, tok/s and peak memory are printed beside the
   bf16 pools', with the share of equal greedy tokens (not checked); one
   1536-token prompt's chunked prefill and two decode steps' logits
   through the kernels agree with the plain path on int8 pools (on the
   same weights in f32, the int8 K/V teacher-forced) within
   ``BF16_MODEL_TOL`` of the logits' scale;
6. f32 engine: after the bf16 weights are released, full llama2-7b at the
   engine's default dtype, f32 (about 27 GB of weights), 4 slots: 4
   greedy requests with prompts of 512..1536 tokens and 16 new tokens,
   monolithic (K4's split-TF32 route, K1, K2; K3 and K4's bf16 route
   never), then the same weights and prompts with ``prefill_chunk=512``
   (K3's split-TF32 route, K1, K2; K4 and K3's other routes never); the
   prefill logits of one request through the kernels agree with the plain
   path (``impl="ref"``) within the model tolerance, and so do those of a
   4736-token prompt through the ``swa`` model (32 'W' layers, window
   4096: K4's window & padding variant on the split-TF32 tile);
8. nemotron-4-15b (after the llama2-7b weights are gone): full width and
   depth in bf16 (32 layers, d_model 6144, 48 heads over 8: G 6, d_ff
   24576, vocab 256000; about 31.2 GB of weights), 8 slots, max_seq_len
   2048: 8 greedy requests of 256..1536 tokens, 16 new tokens, monolithic
   (K4's bf16 tile, K1, K2; K3 and K4's f32 route never), then a wave of 2
   and a wave of 6 on a shared 1024-token head with ``prefill_chunk=512,
   prefix_cache=True`` (K3's bf16 tile at R = 126 rows, K1, K2; K4 and
   K3's other routes never; the second wave hits the cache);
9. nemotron-4-15b at 4 layers in f32: prefill and two decode steps'
   logits of a 1000-token prompt through the kernels against the plain
   path within the model tolerance, monolithic (K4's split-TF32 tile, K1
   in f32 at G 6) and chunked by 512 (K3's split-TF32 tile);
10. nemotron-4-340b at 2 layers in bf16 (d_model 18432, 96 heads over 8:
   G 12, D 192; about 32.7 GB): the same logits against the plain path
   within ``BF16_MODEL_TOL`` (relative), monolithic and chunked by 512,
   then 4 requests through the engine, monolithic (K4's bf16 tile at D
   192, K1, K2) and with ``prefill_chunk=512`` (K3's bf16 tile);
11. recurrentgemma-9b (after the Nemotron weights are gone): full width
   and depth in bf16 (38 layers of pattern RRW: 26 RG-LRU blocks, 12 'W'
   layers of window 2048; 16 heads over one kv head: G 16, D 256; GeGLU
   d_ff 12288; about 20.9 GB), 8 slots, max_seq_len 3072, ring tables of
   33 pages: 8 greedy requests (four of 2200..3000 tokens, four of
   256..1024), 32 new tokens each, monolithic: K4's window & padding
   variant on the bf16 tile, K1 and K2 at D 256 must launch, K3 never;
   tok/s, decode ms per step, TTFT, pool and recurrent-state bytes, peak
   memory, a profiled prefill and decode step by kind and the RG-LRU scan
   alone; a 2200-token prompt's prefill and two decode steps' logits
   against the plain path on the same weights in f32 within
   ``BF16_MODEL_TOL`` of the logits' scale;
12. recurrentgemma-9b at 6 layers (RRWRRW) in f32: the same logits
   through K4's split-TF32 tile and K1 in f32 at D 256 against the plain
   path within the model tolerance.
13. the MoE family (after 12), each config at full width and depth in
   bf16 at its capacity factor 1.25 (granite-moe-1b-a400m: 24 layers,
   16 heads over 8: G 2, D 64, 32 experts top-8, about 2.7 GB;
   olmoe-1b-7b: 16 layers, G 1, D 128, 64 experts top-8, about 13.8 GB),
   8 slots, max_seq_len 2048: the engine phase's 12 prompts, monolithic
   (K4's bf16 tile, K1, K2; K3 never), with the share of dropped expert
   choices in prefill and decode, a profiled prefill and decode step
   with the MoE's router, dispatch, experts and combine in columns of
   their own and the bytes a decode step reads; then chunked by 512 with
   the prefix cache on a shared 1024-token head (K3's bf16 tile; K4
   never; the second wave hits the cache); a 1024-token prompt's logits
   against the plain path on the weights in f32 within
   ``BF16_MODEL_TOL`` of their scale, the routing teacher-forced
   (``RouteTape``; the choices that differ unforced are counted); and at
   4 layers in f32 the same within ``MODEL_TOL``, monolithic and chunked
   by 512 (the split-TF32 tiles);
14. llama-3.2-vision-11b at full width and depth in bf16 (40 layers
   CAAAA: 8 cross-attention layers over 1601 image tokens, 32 'A'
   layers; G 4, D 128; about 19.6 GB; the gates drawn non-zero): 8
   requests with their own random (1601, 1280) images, monolithic (K4,
   K1, K2), a profiled prefill and decode step with the cross-attention
   in columns of its own, the dense cross-attention per layer beside
   SDPA; chunked by 512 with first chunks and resumes in one step (K3,
   K1, K2); a fork (the child's slot holds the parent's image K/V);
   ``prefix_cache=True`` refused; the logits through the kernels against
   the plain path at full depth, in f32 (``MODEL_TOL``) and in bf16
   (``BF16_MODEL_TOL``; over these 40 random layers the bf16 plain path
   itself ends past it from the f32 one, which is printed); and at one
   CAAAA unit in f32 the logits
   within ``MODEL_TOL``, monolithic and chunked, and the contiguous
   baseline's greedy tokens equal to the paged engine's.
   The kernel phase's real-heads tables include granite-moe-1b-a400m
   (16 / 8, D 64) and llama-3.2-vision-11b (32 / 8, D 128).
15. whisper-medium at full width and depth in bf16 (24 encoder and 24
   decoder layers, 16 heads over 16: G 1, D 64; 1500 audio frames; about
   1.5 GB; ``embed/tok`` drawn at std 1.0, which keeps the greedy tokens
   from following the sinusoidal positions alone), 8 slots, max_seq_len
   448: 12 requests with their own random (1500, 1024) frames and
   prompts of 4..224 tokens, 64 new tokens, monolithic (K4's full mask
   once per encoder layer and pass, its causal & padding once per
   decoder layer and prefill, K1, K2), a profiled prefill and decode step
   with the encoder, its self-attention, the cross K/V projections and
   the cross-attention in columns of their own, K4's full mask timed at
   the encoder's shape, the dense cross-attention beside SDPA; chunked by
   128 (K3, K1, K2, K4's full mask for first chunks only) with first
   chunks and resumes in one step; a fork (the child's slot holds the
   parent's cross K/V); ``prefix_cache=True`` refused; the logits of a
   224-token prompt through the kernels in bf16 against the plain path
   on the weights in f32 (``BF16_MODEL_TOL`` of their scale); and at 4 +
   4 layers in f32 the logits within ``MODEL_TOL``, monolithic and
   chunked, and the greedy tokens and sampled logits of
   the contiguous baseline and of the chunked engine equal to the paged
   monolithic engine's.  The kernel phase adds K4 at the encoder's shape
   (B 2, 16 heads, Q = K = 1500 padded to 1536 keys, D 64, full mask) on
   both tiles, in f32 also against f64 (the 36 padded keys kept out of
   the softmax by ``kv_len`` alone), and whisper's heads (16 / 16, D 64)
   to the real-heads tables;
16. xlstm-350m at full width and depth in bf16 (24 blocks MMMMMMMS: 21
   mLSTM, 3 sLSTM, 4 heads of 256, no FFN; ``embed/tok`` at std 1.0), 8
   slots, max_seq_len 2048, no attention layer (the config's contiguous
   state): 12 requests of 256..1536 tokens in mixed-length waves, 32 new
   tokens each; no kernel may launch (the blocks are plain PyTorch, as
   the JAX package's are plain jnp); a profiled prefill and decode step
   with the mLSTM parallel form, its final states and the sLSTM scan in
   columns of their own, and the three timed alone at 8 x 1536; at one
   unit (8 blocks) in f32, each request of a mixed-length wave gets the
   tokens and logits it gets alone, and prefill over 1000 tokens plus one
   decode step gives the last logits of prefill over the 1001 tokens
   within ``MODEL_TOL``.
17. training (after 16), in f32: llama2-7b at full width and 4 layers
   (1.07 B parameters), 30 AdamW steps of the launcher's path
   (``launch.train.train``, the chunked attention) on
   ``synthetic_batches(4, 512, 32000, seed=0)``: every loss finite, the
   mean of the last 5 below the first 5's by ``TRAIN_MARGIN``, no kernel
   launched; step ms by CUDA events, tok/s, peak memory, a profiled step
   by kind; on the trained weights: ``"ref"`` against ``"chunked"`` at B
   1 x S 2048 (loss 1e-5, grad norm 1e-4, relative), K4's forward
   without grad (``tf32x3`` within ``MODEL_TOL``, the bf16 weights on
   ``tc`` within ``BF16_MODEL_TOL``), and the paper's perplexity
   equivalence: two held-out 256-token sequences scored teacher-forced
   through K4, by paged decode through K1/K2 (pages of 64) and by the
   plain forward, within ``NLL_TOL``; then granite-moe-1b-a400m at full
   width and depth (capacity 1.25), 10 steps at B 4 x S 512: aux finite,
   ce falling, step ms, peak memory and the share of dropped expert
   choices.  ``--train-only`` runs the build and this phase alone.
18. distributed (after 17): the decode step across 2 ranks, processes
   that share this card in one ``gloo`` group (NCCL refuses two ranks on
   one device).  Every case runs first on one device (references saved
   in the ignored build dir, the memory freed), then on both ranks under
   ``launch.steps.plan_for`` with the same weights (``init_params(plan=)``,
   seed 0) and the one-device greedy tokens teacher-forced: llama2-7b at
   8 of its 32 layers in bf16 under tp (8 prompts of 256..1536, K4 over
   16 heads a rank, then 32 steps of K1 + K2), and at 4 layers in f32;
   under kvp
   (``shard_decode_state`` stripes the pages: K1 over each rank's stripe
   with ``local_lens``, K2 over both ranks' splits) 1 x 8192 and a batch
   of 8 with rows that leave the second stripe empty, at 8 layers in
   bf16 and at 4 layers in f32; the f32 1 x 8192 case once more, for 4
   steps, with the second rank's stripe dropped from every merge (a
   planted fault the check must see: the run fails unless its logits
   leave ``MODEL_TOL``); llama3-405b at 2 layers in bf16 under kvp (real
   GQA, 128 q heads over 8 kv heads: each rank holds 64 heads of
   ``wq``/``wo``, the ``"q_heads"`` cut, gathers all 128 for K1 over its
   stripe and keeps its 64 after K2; the run fails unless both ranks hold
   H/2); granite-moe at full
   depth in f32, dropless, with ``moe_ep`` (16 experts a rank, the tokens
   exchanged by all-to-all) and under GSPMD's cut (16 experts a rank over
   every token, the partial sums reduced; no all-to-all; the run fails
   unless each rank holds E/2 experts under its schedule); logits
   within ``MODEL_TOL`` (f32) or ``BF16_MODEL_TOL`` of their scale
   (bf16), greedy agreement and the first diverging step reported.  Also
   dp attention at nemotron-4-15b's heads (G 6: 3 a rank) against one
   device's K1 + K2, and ring attention at llama2-7b's heads, S 8192,
   causal and window 4096, against the chunked plain path (f32).  The
   ranks report launches (summed into the ``kernels`` line), step ms by
   events, kernels' device ms, collective calls, bytes and seconds, and
   which collectives gloo took only through host memory; any rank's
   failure fails the run.  K2's "dist" route is checked and timed at the
   kvp merge's layout.  Collective times here are gloo between processes
   on one card, not NVLink.  ``--dist-only`` runs the build and this
   phase alone.
19. launch (with 18: the same 2 rank processes, after its cases): the
   plans' step builders (``launch.steps``) against one device's runs of
   the same weights.  Prefill: llama2-7b in bf16 (at full depth under
   the (2, 1) plan, at 8 layers under (1, 2)) and at 4 layers in f32, 8
   prompts of 256..1536, under the (2, 1) plan (each rank prefills its 4
   rows with every head: ``build_prefill_step``) and the (1, 2) plan
   (every row, 16 heads a rank, the activations cut along the sequence
   between blocks, the plans' default; at f32 also with
   ``seq_parallel=False``, the sums all-reduced), K4 on each rank, then
   ``shard_decode_state`` and 4 decode steps (K1, K2) teacher-forced by
   one device's greedy tokens: logits within ``BF16_MODEL_TOL`` of their
   scale (bf16) or ``MODEL_TOL`` (f32); granite-8b (FSDP: its weights'
   ``embed`` dims over "data") at 4 layers in bf16 under (2, 1), each
   layer's weights gathered before use; llama2-7b at 4 layers in f32
   under the ring plan on (1, 2) (whole attention weights, ring
   attention in plain ops, no K4).  Train: llama2-7b at full width, 4
   layers, f32, B 4 x S 512 (the training phase's): the local plan must take 2
   microbatches (f32 logits of 262 MB over the 256 MB budget), and 2
   microbatched steps land within ``LAUNCH_STEP_TOL`` of 2 plain ones;
   under (2, 1) (data parallel at 1 layer: the gradients summed over
   the ranks) and (1, 2) (tensor parallel: heads, ``d_ff`` and the vocab
   cut; the sequence cut, without it, and the ring) the rank's
   gradients within ``LAUNCH_GRAD_TOL`` · (1 + |g|) of one device's, its
   params after 2 steps within ``LAUNCH_STEP_TOL`` (``GradTape``: an
   element whose gradient a step took more than ``LAUNCH_GRAD_SHARE``
   from one device's is held to AdamW's own bound instead, and at most
   ``LAUNCH_ROUNDING_SHARE`` of them), the losses and grad norms within
   ``LAUNCH_LOSS_TOL``; step ms by events, peak memory and collectives
   per rank.  granite-8b under FSDP on (2, 1), 4 layers f32, one step,
   held alike: each rank's state about half the whole, the all-gathers
   and reduce-scatters counted.  granite-moe-1b-a400m at full width, 4
   layers, f32, B 4 x S 512, capacity 1.25, on (1, 2) under GSPMD's
   expert cut and under ``moe_ep`` (the all-to-all under grad): 2 steps
   held alike, each rank holding E/2 experts and their moments,
   all-to-all calls and bytes logged (EP only).  Then ``launch.serve`` at
   full width (llama2-7b, f32, 8
   requests at the CLI's defaults), paged (K4, K1, K2 must launch) and
   ``--no-paged`` (K4; K1 must not launch): every request its
   ``--max-new`` tokens, the CLI's report logged.  ``--launch-only`` runs
   the build and this phase alone.
20. dry run (after 19): ``launch.steps.dry_step`` (fake tensors on the
   CPU, the kernels by their stand-ins) against the card, each case
   failing the run on a miss: the predicted peak within
   ``DRY_PEAK_TOL`` of ``max_memory_allocated`` after
   ``reset_peak_memory_stats`` (less what the process held beyond the
   step's arguments), the aten ops' FLOPs equal to ``FlopCounterMode``
   over the real step, the stand-ins' launches by route equal to the
   ``launch_counts()`` deltas, and the collectives' calls and bytes equal
   to the mesh's ``stats``; the roofline terms printed beside the
   measured step ms (no bound).  One device: llama2-7b at 4 layers in f32
   (B 4 x S 512, 2 microbatches), then at full depth in bf16 the prefill
   of the 8 launch prompts (K4) and one decode step (K1 + K2).  Two
   ranks, in the launch cases' train steps: the (2, 1) and (1, 2) ranks,
   granite-8b's FSDP (2, 1) rank and granite-moe's (1, 2) ranks under
   both expert schedules (the all-to-alls of the backward counted).
   ``--dry-only`` runs the build and this phase alone (the rank cases in
   2 rank processes of their own).
7. swa engine (between 5 and 6, on the bf16 weights): llama2-7b's
   ``swa`` variant, every layer 'W' with window 4096, served from ring
   pages (4 slots, max_seq_len 5120, a pool of 4 x 5120 tokens): 4
   prompts of 4160..5000 tokens, 16 new tokens each, monolithic (K4's
   window & padding variant on the bf16 tile, K1, K2 on ring tables),
   then with ``prefill_chunk=512`` (the windowed chunks in plain ops, K1,
   K2); K3 and K4's f32 route never launch, and every ring wraps.

7b. baseline (after 7, on the bf16 weights): the paper's comparison.
   The engine phase's 12 prompts served twice, paged (K4, K1, K2; a pool
   of the live tokens rounded up to whole pages plus one page of headroom
   per slot) and as the contiguous baseline (``paged=False``: max-length
   buffers of 8.59 GB; K4 prefill, decode attention in plain ops; K1 and
   K3 never launch): decode ms per step, TTFT, ``memory_report`` at the
   step with the most live tokens, peak memory, one profiled decode step
   by kind (the baseline's attention in a column of its own) and that
   attention timed alone; at 4 layers in f32, 6 prompts over 4 slots on
   both engines: equal greedy tokens, every sampled row's logits within
   ``MODEL_TOL`` of the paged engine's;
7c. fork: llama2-7b in bf16 with the prefix cache: a parent of 1007
   tokens attaches to a cached 960-token head (K3), decodes, and forks 3
   children (K1, K2 over aliased and copied pages): at most one new page
   per fork, each copied tail page equal to the parent's bit for bit; at
   4 layers in f32 each greedy child's tokens equal a fresh request's on
   its prefix and the parent's equal its run without forks;
7d. faults: 4 layers at full width in bf16, chunked by 64 (K3): NaN
   injected into one row fails it alone, the others' tokens bit-identical
   to a run without faults; a transient decode error retried to the same
   tokens; ``Backpressure`` from a bounded queue; the JAX suite's chaos
   soak (``SOAK_SEED``, lengths scaled by the page) with the allocator's
   invariants after every step;
7e. page state: the device-side allocator (``core.paging.PageState``):
   2000 random reserve / extend / free / fork operations on CUDA tensors,
   its tables, refcounts, lengths and free stack equal to the
   ``HostPageManager``'s after each.

``--time-k4 [--src DIR]`` only times K4's causal & padding at the main
path's shapes (B 8, Q = K = 1536) on both routes, from this checkout's
package or another tree's: an A/B probe across commits (parent, change,
change, parent).  ``--time-main [--src DIR]`` does the same for K1, K3
and K4 at the main path's shapes (D 128, G 1) in bf16 and f32, and for
K3 with bf16 q over int8 pools (whichever kernel the tree runs it on).

The last two lines of standard output are the kernels JSON line and the
result line ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the repository's ``src/repro_torch`` beside this file, it exits non-zero
and prints no result.
"""

import collections
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

F32_TOL, BF16_TOL = 2e-5, 2e-2
MODEL_TOL = 1e-3  # f32 logits, 4 layers at d_model 4096: summation order
# bf16 logits against the plain path: max|a - b| <= tol * (1 + max|b|).
# With random weights the attention scores have a std of ~7, so the
# softmax is sharp and one bf16 rounding of q, k or P (2^-8 relative)
# moves a head's output by a few percent; through the layers and the
# unembedding that moves the logits by a few percent of their scale.  A
# wrong tile or key moves them by their scale.
BF16_MODEL_TOL = 5e-2
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
# dense peaks by input type: f32 on the CUDA cores (the tensor cores take no
# IEEE f32), bf16 on the tensor cores
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
TF32_OPS = 495e12  # dense TF32 tensor cores: the f32 tile's 3 products

SEED = 0
SOAK_SEED = 0xFA57  # the fault suite's pinned seed (tests/test_faults.py)
# profiler names of the kernels, by kernel and tile (substrings; K3's int8
# variants are instances of the same templates)
KERNEL_NAMES = {"paged_prefill_tc": "paged_prefill_kernel_tc<",
                "paged_prefill_tf32x3": "paged_prefill_kernel_tf32<",
                "flex_prefill_tc": "flex_fwd_kernel_tc<",
                "flex_prefill_tf32x3": "flex_fwd_kernel_tf32<"}


def kernel_name(key):
    """The profiler name of a check key ("paged_prefill_tc/int8" etc.)."""
    return KERNEL_NAMES[key.split("/")[0]]


def k3_routes_except(*keep):
    """K3's launch-count keys of every tile and variant but ``keep``."""
    from repro_torch.kernels.paged_attention.paged_attention import ROUTES
    return tuple(f"paged_prefill/{r}" for r in ROUTES if r not in keep)


def set_src(src):
    """Run the repro_torch under ``src`` (this checkout's by default)."""
    global SRC
    SRC = src


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    if LOG and OUT.is_dir():
        (OUT / "chip_smoke.log").write_text("\n".join(LOG + [f"FAIL: {msg}"]))
    sys.exit(1)


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


LOG = []  # every line logged, written to OUT / "chip_smoke.log"


def log(msg):
    LOG.append(msg)
    print(msg, flush=True)


def nvidia_smi():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError:
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        "nvidia-smi unavailable")


def time_ms(torch, fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, kernel_name, reps=10):
    """Device time per call of the CUDA kernels whose name contains
    ``kernel_name`` (or one of a tuple of names; each launched once per
    call), from torch.profiler: each kernel's mean over the launches the
    profiler recorded (it may drop some), summed (None when it records
    none)."""
    names = (kernel_name,) if isinstance(kernel_name, str) else kernel_name
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if any(x in ev.key for x in names) and ev.count:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0)
                                ) / ev.count
    return total_us / 1e3 if total_us > 0 else None


def host_ms(torch, fn, reps=50):
    """Host milliseconds per call of ``fn``, calls queued back to back
    (the card runs them meanwhile; synchronised only after the clock)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / reps


class Checker:
    def __init__(self, torch):
        self.torch = torch
        self.max_err = {}

    def close(self, kernel, what, got, want, tol):
        t = self.torch
        got, want = got.float(), want.float()
        if got.shape != want.shape:
            fail(f"{kernel} {what}: shape {tuple(got.shape)} != "
                 f"{tuple(want.shape)}")
        if not bool(t.isfinite(got).all()):
            fail(f"{kernel} {what}: non-finite values")
        err = (got - want).abs()
        bad = err > tol * (1 + want.abs())
        worst = float(err.max())
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), worst)
        log(f"  {kernel:12s} {what:44s} max|err| {worst:.3e} "
            f"(|err| <= {tol:g} * (1 + |plain|))")
        if bool(bad.any()):
            fail(f"{kernel} {what}: max|err| {worst:.3e} beyond tol {tol}")

    def versus_f64(self, kernel, what, got, plain, exact, tol=None,
                   mag=None):
        """Log how far the kernel's and the f32 plain version's outputs are
        from the plain version evaluated in f64 (which side carries an
        error).  With ``tol``, the kernel is held against the f64
        evaluation, ``|got - exact| <= tol * (1 + |exact|)``: the check for
        the cases whose f32 plain version carries rounding of the order of
        the f32 tolerance itself (partials over 2048 keys, rows of 192).
        With ``mag``, the bound is ``tol * (1 + mag)``: K3's acc on int8
        pools, whose sums over int8 V up to 127 * kv_scale reach hundreds
        while single elements cancel to near 0, takes the magnitude its
        sum is taken over (the sum of p * |v| * kv_scale), which is what
        f32 rounding follows."""
        def err(a, b):
            return float((a.double() - b).abs().max())
        kerr = err(got, exact)
        scale = exact.abs() if mag is None else mag
        rel = float(((got.double() - exact).abs() / (1 + scale)).max())
        log(f"  {kernel:12s} {what:44s} vs f64: kernel max|err| "
            f"{kerr:.3e}, f32 plain {err(plain, exact):.3e}"
            + ("" if tol is None else
               f" (checked: |err| <= {tol:g} * (1 + "
               f"{'|f64|' if mag is None else 'sum p|v|'}): {rel:.3e})"))
        if tol is None:
            return
        if not bool(self.torch.isfinite(got).all()):
            fail(f"{kernel} {what}: non-finite values")
        bad = (got.double() - exact).abs() > tol * (1 + scale)
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), kerr)
        if bool(bad.any()):
            fail(f"{kernel} {what}: max|err| {kerr:.3e} from f64 beyond "
                 f"tol {tol}")


def paged_inputs(torch, gen, B, Hkv, G, D, P, max_pages, lens, dtype, dev,
                 int8=False, window=0):
    num_pages = B * max_pages + 3
    q = torch.randn((B, Hkv, G, D), generator=gen, device=dev).to(dtype)
    shape = (num_pages, P, Hkv, D)
    if int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages, generator=gen, device=dev).int()
    tables = torch.full((B, max_pages), -1, dtype=torch.int32, device=dev)
    k = 0
    for b in range(B):
        n = max_pages if window else min(-(-int(lens[b]) // P), max_pages)
        tables[b, :n] = perm[k:k + n]
        k += n
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens_t


def kernel_phase(torch, chk):
    import torch.nn.functional as F
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention import flex_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = {}

    # -- K1 + K2 at the main-path shapes --------------------------------
    B, H, D, P, max_pages, ppb, ns = 8, 32, 128, 64, 32, 2, 4
    lens = torch.randint(256, 2049, (B,), generator=gen, device=dev).tolist()
    log(f"K1/K2 main path: B={B} H=Hkv={H} D={D} page={P} "
        f"max_pages={max_pages} ppb={ppb} splits={ns} lens={lens}")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        q, kp, vp, tables, lens_t = paged_inputs(
            torch, gen, B, H, 1, D, P, max_pages, lens, dtype, dev)
        kw = dict(scale=D ** -0.5, pages_per_block=ppb, num_splits=ns)
        got = pa.paged_attention_partials(q, kp, vp, tables, lens_t, **kw)
        want = pa._paged_attention_partials_plain(
            q, kp, vp, tables, lens_t, window=0, softcap=0.0, kv_scale=0.0,
            **kw)
        torch.cuda.synchronize()
        for part, g_, w_ in zip("m l acc".split(), got, want):
            chk.close("paged_decode", f"{name} main {part}", g_, w_, tol)
        out_k = pa.combine_partials_kernel(*got, dtype=dtype)
        out_p = pa._combine_partials_plain(*got, dtype=dtype)
        torch.cuda.synchronize()
        chk.close("combine", f"{name} main (S={ns})", out_k, out_p, tol)
        op_args = (q, kp, vp, tables, lens_t)
        op = pa.paged_attention_kernel(*op_args, **kw)
        chk.close("decode_op", f"{name} main (K1 + K2, one call)", op,
                  pa._combine_partials_plain(*want, dtype=dtype), tol)
        if not torch.equal(op, out_k):
            fail(f"decode op {name} main: not K1's partials then K2")

        k1_ms = time_ms(torch, lambda: pa.paged_attention_partials(
            q, kp, vp, tables, lens_t, **kw))
        k1_plain = time_ms(torch, lambda: pa._paged_attention_partials_plain(
            q, kp, vp, tables, lens_t, window=0, softcap=0.0, kv_scale=0.0,
            **kw), reps=5)
        k2_ms = time_ms(torch, lambda: pa.combine_partials_kernel(
            *got, dtype=dtype))
        k2_plain = time_ms(torch, lambda: pa._combine_partials_plain(
            *got, dtype=dtype))
        # library yardstick: SDPA over pre-gathered contiguous KV, which
        # computes K1 + K2 together (the gather is not timed)
        L = max(lens)
        safe = tables.clamp(min=0).long()
        kc = kp[safe].reshape(B, max_pages * P, H, D)[:, :L].transpose(1, 2)
        vc = vp[safe].reshape(B, max_pages * P, H, D)[:, :L].transpose(1, 2)
        kc, vc = kc.contiguous(), vc.contiguous()
        keep = (torch.arange(L, device=dev)[None, :] < lens_t[:, None]
                ).reshape(B, 1, 1, L)
        qs = q.reshape(B, H, 1, D)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=keep))
        # the bound formulas beside the wrappers (the dry run's too)
        item = q.element_size()
        k1_ops, k1_bytes = pa.decode_cost(q.shape, got[0].shape[2],
                                          tables.shape[1], sum(lens), item,
                                          item)
        k1_bound = 1e3 * max(k1_bytes / HBM_BPS, k1_ops / PEAK_OPS[name])
        k2_ops, k2_bytes = pa.combine_cost(out_k.numel() // D,
                                           got[0].shape[2], D, item)
        k2_bound = 1e3 * max(k2_bytes / HBM_BPS, k2_ops / PEAK_OPS[name])
        k1_dev = device_ms(torch, lambda: pa.paged_attention_partials(
            q, kp, vp, tables, lens_t, **kw), "paged_decode_kernel")
        k2_dev = device_ms(torch, lambda: pa.combine_partials_kernel(
            *got, dtype=dtype), "combine_kernel")
        # the decode op from one call: its wall time by events, the device
        # time of its two kernels, the host's share, and its host time per
        # call when calls are queued back to back
        op_ms = time_ms(torch, lambda: pa.paged_attention_kernel(
            *op_args, **kw))
        op_dev = device_ms(torch, lambda: pa.paged_attention_kernel(
            *op_args, **kw), ("paged_decode_kernel", "combine_kernel"))
        op_host = host_ms(torch, lambda: pa.paged_attention_kernel(
            *op_args, **kw))
        op_over = None if op_dev is None else op_ms - op_dev
        parts = op_host_parts(torch, op_args, kw)
        log(f"  decode_op    {name}: host us per call by part: "
            + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
        log(f"  decode_op    {name}: one call {op_ms:.4f} ms (device K1 + "
            f"K2 {fmt(op_dev)}; host overhead {fmt(op_over)}; host "
            f"{op_host:.4f} ms per call queued back to back), SDPA over "
            f"pre-gathered KV {lib:.4f} ms")
        rows[("decode_op", name)] = dict(ms=op_ms, device_ms=op_dev,
                                         host_overhead_ms=op_over,
                                         host_ms=op_host,
                                         host_us_by_part=parts,
                                         bound_ms=k1_bound
                                         + k2_bound, library_ms=lib)
        log(f"  paged_decode {name}: kernel {k1_ms:.4f} ms (device "
            f"{fmt(k1_dev)}), plain {k1_plain:.4f} ms, bound "
            f"{k1_bound:.4f} ms (bytes), SDPA over pre-gathered KV (K1+K2) "
            f"{lib:.4f} ms")
        log(f"  combine      {name}: kernel {k2_ms:.4f} ms (device "
            f"{fmt(k2_dev)}), plain {k2_plain:.4f} ms, bound "
            f"{k2_bound:.4f} ms (bytes)")
        rows[("paged_decode", name)] = dict(ms=k1_ms, device_ms=k1_dev,
                                            plain_ms=k1_plain,
                                            bound_ms=k1_bound,
                                            bound_by="bytes",
                                            library_ms=lib)
        rows[("combine", name)] = dict(ms=k2_ms, device_ms=k2_dev,
                                       plain_ms=k2_plain,
                                       bound_ms=k2_bound, bound_by="bytes",
                                       library_ms=None)
        del kp, vp, kc, vc

    # K1 with every split full (lens 2048): how close the streaming comes
    # to the byte bound when no split is short or empty
    lens_full = [max_pages * P] * B
    q, kp, vp, tables, lens_t = paged_inputs(
        torch, gen, B, H, 1, D, P, max_pages, lens_full, torch.bfloat16, dev)
    kw = dict(scale=D ** -0.5, pages_per_block=ppb, num_splits=ns)
    full_dev = device_ms(torch, lambda: pa.paged_attention_partials(
        q, kp, vp, tables, lens_t, **kw), "paged_decode_kernel")
    full_bound = 1e3 * (2 * sum(lens_full) * H * D * 2) / HBM_BPS
    log(f"  paged_decode bfloat16 lens {lens_full[0]} (every split full): "
        f"device {fmt(full_dev)}, bound {full_bound:.4f} ms (bytes)")
    rows[("paged_decode_full", "bfloat16")] = dict(device_ms=full_dev,
                                                   bound_ms=full_bound)
    del q, kp, vp

    decode_edge_cases(torch, chk, gen)
    # every split count from 1 to 8, and 12, from their own generator, so
    # the cases after them keep their inputs
    splits = torch.Generator(device=dev)
    splits.manual_seed(SEED + 19)
    decode_split_cases(torch, chk, splits)

    # -- K1 + K2 sweep: GQA, window, softcap, int8, D=64 ------------------
    sweep = [  # (G, D, ppb, splits, window, softcap, int8)
        (4, 128, 2, 3, 0, 0.0, False),
        (8, 64, 1, 2, 0, 0.0, False),
        (2, 128, 2, 2, 100, 0.0, False),
        (1, 64, 1, 4, 0, 30.0, False),
        (4, 128, 2, 2, 0, 0.0, True),
        (1, 128, 4, 1, 0, 0.0, True),
    ]
    for G, Dd, sp_ppb, sp_ns, window, softcap, int8 in sweep:
        Bs, Hs, Ps = 3, 4, 16
        if window:
            ring = -(-window // Ps) + 1
            mp, slens = ring, [7, 150, 333]
        else:
            mp, slens = 9, [140, 17, 1]
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            name = str(dtype).replace("torch.", "")
            args = paged_inputs(torch, gen, Bs, Hs, G, Dd, Ps, mp, slens,
                                dtype, dev, int8=int8, window=window)
            kw = dict(scale=Dd ** -0.5, window=window, softcap=softcap,
                      kv_scale=0.05 if int8 else 0.0,
                      pages_per_block=sp_ppb, num_splits=sp_ns)
            tag = (f"{name} G{G} D{Dd} w{window} cap{softcap:g} "
                   f"{'int8' if int8 else ''}")
            check_decode(torch, chk, tag, args, kw, dtype, tol)

    # -- K4 at the main-path shapes --------------------------------------
    Bf, Hf, Q = 8, 32, 1536
    plens = torch.randint(256, Q + 1, (Bf,), generator=gen,
                          device=dev).tolist()
    plens[0] = Q
    log(f"K4 main path: B={Bf} H=Hkv={Hf} D={D} Q=K={Q} "
        f"mask causal & padding(lens={plens})")
    plens_t = torch.tensor(plens, dtype=torch.int32, device=dev)
    mm = flex.and_masks(flex.causal_mask, flex.padding_mask(plens_t))
    bm = flex.build_block_mask(mm, Q, Q, 128, 128, B=Bf, device=dev)
    # exactly K4's function for SDPA: causal and padding as a boolean mask
    exact = (torch.ones(Q, Q, dtype=torch.bool, device=dev).tril()[None]
             & (torch.arange(Q, device=dev)[None, None, :]
                < plens_t[:, None, None]))[:, None]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        key = "flex_prefill_" + fa.flex_route(dtype)
        shape = (Bf, Hf, Q, D)
        q = torch.randn(shape, generator=gen, device=dev).to(dtype)
        k = torch.randn(shape, generator=gen, device=dev).to(dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(dtype)
        kw = dict(scale=D ** -0.5, mask_mod=mm, q_len=Q, kv_len=Q)
        got = fa.flex_attention_kernel(q, k, v, bm, **kw)
        want = fa._flex_attention_plain(q, k, v, bm, **kw)
        torch.cuda.synchronize()
        chk.close(key, f"{name} main causal&padding", got, want, tol)
        k4_ms = time_ms(torch, lambda: fa.flex_attention_kernel(
            q, k, v, bm, **kw), reps=5)
        k4_plain = time_ms(torch, lambda: fa._flex_attention_plain(
            q, k, v, bm, **kw), reps=3, warmup=1)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=exact), reps=5)
        lib_causal = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=5)
        pairs = sum(min(qq + 1, L) for L in plens for qq in range(Q))
        ops, nbytes = fa.flex_cost(q.shape, k.shape, q.element_size(),
                                   pairs)
        k4_bound = 1e3 * max(nbytes / HBM_BPS, ops / PEAK_OPS[name])
        k4_dev = device_ms(torch, lambda: fa.flex_attention_kernel(
            q, k, v, bm, **kw), kernel_name(key), reps=3)
        row = dict(ms=k4_ms, device_ms=k4_dev, plain_ms=k4_plain,
                   bound_ms=k4_bound, bound_by="operations", library_ms=lib,
                   library_causal_only_ms=lib_causal)
        extra = ""
        if dtype == torch.float32:
            row["bound_tf32x3_ms"] = 1e3 * 3 * ops / TF32_OPS
            extra = (f" (bound_ms: f32 operations at 67 TFLOP/s; three "
                     f"TF32 products at 495 TFLOP/s: "
                     f"{row['bound_tf32x3_ms']:.4f} ms)")
        log(f"  {key} {name}: kernel {k4_ms:.4f} ms (device "
            f"{fmt(k4_dev)}), plain {k4_plain:.3f} ms, bound {k4_bound:.4f} "
            f"ms (operations){extra}, SDPA with the causal & padding mask "
            f"{lib:.4f} ms (SDPA causal only, not the same function: "
            f"{lib_causal:.4f} ms)")
        rows[(key, name)] = row
        del q, k, v, got, want
    del exact

    # K4 at max_seq_len: the TMA ring over 16 (bf16) or 32 (f32) kv tiles
    # per q tile; f32 also against the plain version in f64
    Q2 = 2048
    l2 = torch.tensor([Q2, 1500], dtype=torch.int32, device=dev)
    m2 = flex.and_masks(flex.causal_mask, flex.padding_mask(l2))
    bm2 = flex.build_block_mask(m2, Q2, Q2, 128, 128, B=2, device=dev)
    kw = dict(scale=D ** -0.5, mask_mod=m2, q_len=Q2, kv_len=Q2)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        key = "flex_prefill_" + fa.flex_route(dtype)
        q, k, v = (torch.randn((2, Hf, Q2, D), generator=gen, device=dev
                               ).to(dtype) for _ in range(3))
        got = fa.flex_attention_kernel(q, k, v, bm2, **kw)
        want = fa._flex_attention_plain(q, k, v, bm2, **kw)
        chk.close(key, f"{name} B2 H32 Q=K=2048 causal&padding", got, want,
                  tol)
        if dtype == torch.float32:
            live = flex.materialize(m2, 2, 1, Q2, Q2, device=dev)
            chk.versus_f64(key, f"{name} Q=K=2048", got, want,
                           flex_f64_mask(torch, q, k, v, live, D ** -0.5))
        del q, k, v, got, want
    flex_permutation_case(torch, chk, gen)

    # -- K4 sweep: ragged tiles, GQA, D=64, every mask variant -----------
    cases = [  # (B, H, Hkv, Q, D, mask, q_block, kv_block)
        (2, 4, 2, 200, 64, "causal&padding", 128, 128),
        (3, 8, 2, 77, 128, "causal&padding", 128, 128),
        (2, 4, 4, 130, 128, "causal", 48, 32),
        (2, 2, 1, 96, 64, "padding", 40, 56),
        (1, 2, 2, 33, 128, "full", 16, 16),
    ]
    for Bs, Hs, Hk, Qs, Dd, mname, qb, kb in cases:
        sl = torch.randint(1, Qs + 1, (Bs,), generator=gen, device=dev)
        mods = {"causal": flex.causal_mask, "full": flex.full_mask,
                "padding": flex.padding_mask(sl),
                "causal&padding": flex.and_masks(flex.causal_mask,
                                                 flex.padding_mask(sl))}
        mod = mods[mname]
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            name = str(dtype).replace("torch.", "")
            from repro_torch.kernels.flex_attention.ops import flex_attention
            q = torch.randn((Bs, Hs, Qs, Dd), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn((Bs, Hk, Qs, Dd), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((Bs, Hk, Qs, Dd), generator=gen,
                            device=dev).to(dtype)
            got = flex_attention(q, k, v, mask_mod=mod, q_block=qb,
                                 kv_block=kb)
            qbb, kbb = min(qb, Qs), min(kb, Qs)
            if mod is flex.causal_mask:
                bms = flex.causal_block_mask(Qs, Qs, qbb, kbb, device=dev)
            else:
                bms = flex.build_block_mask(
                    mod, Qs, Qs, qbb, kbb,
                    B=Bs if isinstance(mod, flex.AuxMod) else None,
                    device=dev)
            pq, pk = -Qs % qbb, -Qs % kbb
            want = fa._flex_attention_plain(
                F.pad(q, (0, 0, 0, pq)), F.pad(k, (0, 0, 0, pk)),
                F.pad(v, (0, 0, 0, pk)), bms, scale=Dd ** -0.5,
                mask_mod=mod, q_len=Qs, kv_len=Qs)[:, :, :Qs]
            chk.close("flex_prefill_" + fa.flex_route(dtype),
                      f"{name} B{Bs} H{Hs}/{Hk} Q{Qs} D{Dd} {mname} "
                      f"tiles {qbb}x{kbb}", got, want, tol)
    # the cases added with the window variants draw from their own
    # generator, so the cases after them keep their inputs
    own = torch.Generator(device=dev)
    own.manual_seed(SEED + 16)
    rows.update(flex_variant_phase(torch, chk, own))
    ring_decode_cases(torch, chk, own)
    rows.update(prefill_kernel_phase(torch, chk, gen))
    # the GQA groups and head dims of the Nemotron-4 slice, from their own
    # generator, so the cases above keep their inputs
    heads = torch.Generator(device=dev)
    heads.manual_seed(SEED + 17)
    rows.update(gqa_head_phase(torch, chk, heads))
    # head dim 256 (recurrentgemma-9b), from its own generator
    d256 = torch.Generator(device=dev)
    d256.manual_seed(SEED + 18)
    rows.update(head_dim_256_phase(torch, chk, d256))
    # whisper-medium's encoder (full mask over padded frames), from its own
    # generator
    enc = torch.Generator(device=dev)
    enc.manual_seed(SEED + 19)
    rows.update(encoder_flex_case(torch, chk, enc))
    return rows


def ramp_v(torch, v):
    """V whose rows are distinct and ordered (key j: j / K plus a small
    per-column term): with scores that are not symmetric in the keys, a
    kernel that pairs a key's probability with another key's V row gives
    another answer."""
    K, D = v.shape[-2], v.shape[-1]
    dev = v.device
    ramp = (torch.arange(K, device=dev)[:, None] / K
            + 1e-3 * torch.arange(D, device=dev)[None, :])
    return (ramp.expand(v.shape) + 0.01 * v.float()).to(v.dtype).contiguous()


def flex_permutation_case(torch, chk, gen):
    """K4 on a ragged shape (Q = K = 200, kv tiles of 56 keys, not a
    multiple of 8) with ordered V rows, in both dtypes."""
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention import flex_attention as fa
    dev = torch.device("cuda")
    B, H, Q, D = 2, 4, 224, 128
    lens = torch.tensor([Q, 131], dtype=torch.int32, device=dev)
    mm = flex.and_masks(flex.causal_mask, flex.padding_mask(lens))
    bm = flex.build_block_mask(mm, Q, Q, 32, 56, B=B, device=dev)
    kw = dict(scale=D ** -0.5, mask_mod=mm, q_len=Q, kv_len=Q)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        q, k, v = (torch.randn((B, H, Q, D), generator=gen, device=dev
                               ).to(dtype) for _ in range(3))
        v = ramp_v(torch, v)
        chk.close("flex_prefill_" + fa.flex_route(dtype),
                  f"{name} ordered V rows, tiles 32x56",
                  fa.flex_attention_kernel(q, k, v, bm, **kw),
                  fa._flex_attention_plain(q, k, v, bm, **kw), tol)


def flex_f64_mask(torch, q, k, v, live, scale):
    """K4 over a dense (B, 1|H, Q, K) live mask evaluated in f64, one batch
    row at a time (rows with nothing live give 0)."""
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    G = q.shape[1] // k.shape[1]
    for b in range(q.shape[0]):
        kb = k[b].double().repeat_interleave(G, dim=0)
        vb = v[b].double().repeat_interleave(G, dim=0)
        s = (q[b].double() * scale) @ kb.transpose(-1, -2)
        s = s.masked_fill(~live[b], float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
        out[b] = p @ vb
    return out


def op_block_mask(torch, mod, Q, K, qb, kb, B, window):
    """The BlockMask that ``ops.flex_attention`` builds for ``mod``."""
    from repro_torch.core import flex
    dev = torch.device("cuda")
    qb, kb = min(qb, Q), min(kb, K)
    if mod is flex.causal_mask:
        return flex.causal_block_mask(Q, K, qb, kb, device=dev)
    if window > 0:
        return flex.causal_block_mask(Q, K, qb, kb, window=window,
                                      device=dev)
    return flex.build_block_mask(
        mod, Q, K, qb, kb, B=B if isinstance(mod, flex.AuxMod) else None,
        device=dev)


def check_flex_variant(torch, chk, tag, q, k, v, mod, score, qb=128, kb=128,
                       window=0):
    """The op (K4 on the card, padded to whole tiles) against the plain
    version on the same BlockMask and padding, with the kernel's own
    product arithmetic: P in one bf16 term (bf16, 2e-2), three TF32
    products (f32, 2e-5).  Returns the kernel's output."""
    import torch.nn.functional as F
    from repro_torch.kernels.flex_attention import flex_attention as fa
    from repro_torch.kernels.flex_attention.ops import flex_attention
    B, H, Q, D = q.shape
    K = k.shape[2]
    got = flex_attention(q, k, v, mask_mod=mod, score_mod=score, q_block=qb,
                         kv_block=kb, window=window)
    bm = op_block_mask(torch, mod, Q, K, qb, kb, B, window)
    pq, pk = -Q % bm.q_block, -K % bm.kv_block
    f32 = q.dtype == torch.float32
    want = fa._flex_attention_plain(
        F.pad(q, (0, 0, 0, pq)), F.pad(k, (0, 0, 0, pk)),
        F.pad(v, (0, 0, 0, pk)), bm, scale=D ** -0.5, mask_mod=mod,
        score_mod=score, q_len=Q, kv_len=K, p_terms=None if f32 else 1,
        tf32_terms=3 if f32 else None)[:, :, :Q]
    name = str(q.dtype).replace("torch.", "")
    chk.close("flex_prefill_" + fa.flex_route(q.dtype),
              f"{name} {tag} ({fa.lower_mods(mod, score).name}, tiles "
              f"{bm.q_block}x{bm.kv_block})", got,
              want, F32_TOL if f32 else BF16_TOL)
    return got


# K4 in bf16 at the encoder's shape against f64 over the real keys:
# |err| <= tol * (1 + |f64|).  The output's bf16 rounding is half an ulp,
# at most 2^-9 for |o| < 1, i.e. <= 1.3e-3 * (1 + |o|), and P's one bf16
# rounding adds a few 1e-4 (measured on the H100: 9.9e-4 in this form);
# the 36 padded keys taken into the softmax scale every output by ~1 -
# 36/2500 (measured: 3.8e-3).
ENC_BF16_F64_TOL = 2e-3


def encoder_flex_case(torch, chk, gen):
    """K4 at whisper-medium's encoder self-attention: B 2, 16 heads, Q = K
    = 1500 frames, D 64, the full mask, 128 x 128 tiles, through the op
    (which pads the frames to 1536 keys: only ``kv_len`` keeps the 36
    zero keys out of the softmax) on both routes against the plain
    version on the same padding with the kernel's own product arithmetic,
    and against the evaluation in f64 over the 1500 real keys (f32:
    ``F32_TOL``; bf16: ``ENC_BF16_F64_TOL``).  The plain version with the
    padded keys live (the fault) must miss the f64 check's bound, or the
    check could not see it.  Timed (device) beside its bound, its plain
    version and SDPA with no mask (the same function).  Returns the timed
    rows."""
    import torch.nn.functional as F
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention import flex_attention as fa
    from repro_torch.kernels.flex_attention.ops import flex_attention
    dev = torch.device("cuda")
    B, H, Q, D = 2, 16, 1500, 64
    mod = flex.full_mask
    bm = op_block_mask(torch, mod, Q, Q, 128, 128, B, 0)
    pad = -Q % bm.kv_block
    kw = dict(scale=D ** -0.5, mask_mod=mod, q_len=Q, kv_len=Q)
    rows = {}
    for dtype, tol, f64_tol in ((torch.bfloat16, BF16_TOL, ENC_BF16_F64_TOL),
                                (torch.float32, F32_TOL, F32_TOL)):
        name = str(dtype).replace("torch.", "")
        key = "flex_prefill_" + fa.flex_route(dtype)
        f32 = dtype == torch.float32
        q, k, v = (torch.randn((B, H, Q, D), generator=gen, device=dev
                               ).to(dtype) for _ in range(3))
        qp, kp, vp = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        tag = f"whisper-medium encoder B{B} H{H} Q=K={Q} D{D} {name} full"
        got = flex_attention(q, k, v, mask_mod=mod)
        arith = dict(p_terms=None if f32 else 1,
                     tf32_terms=3 if f32 else None)
        want = fa._flex_attention_plain(qp, kp, vp, bm, **arith,
                                        **kw)[:, :, :Q]
        chk.close(key, f"{tag} (tiles {bm.q_block}x{bm.kv_block}, keys "
                  f"padded to {Q + pad})", got, want, tol)
        plain = fa._flex_attention_plain(qp, kp, vp, bm, **kw)[:, :, :Q]
        live = torch.ones((B, 1, Q, Q), dtype=torch.bool, device=dev)
        exact = flex_f64_mask(torch, q, k, v, live, D ** -0.5)
        chk.versus_f64(key, tag, got, plain, exact, tol=f64_tol)
        fault = fa._flex_attention_plain(
            qp, kp, vp, bm, **arith, **dict(kw, kv_len=Q + pad))[:, :, :Q]
        miss = float(((fault.double() - exact).abs()
                      / (1 + exact.abs())).max())
        log(f"  {key} {tag}: the plain version with the {pad} padded keys "
            f"live misses f64 by {miss:.3e} (bound {f64_tol:g})")
        if not miss > f64_tol:
            fail(f"{key} {tag}: padded keys in the softmax stay within "
                 f"{f64_tol:g} of f64: the check cannot see them")
        del plain, live, exact, fault
        dev_ms = device_ms(torch, lambda: flex_attention(q, k, v,
                                                         mask_mod=mod),
                           kernel_name(key), reps=3)
        plain_ms = time_ms(torch, lambda: fa._flex_attention_plain(
            qp, kp, vp, bm, **kw), reps=2, warmup=1)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v),
                      reps=5)
        ops_ = 4 * D * H * B * Q * Q
        nbytes = 4 * q.numel() * q.element_size()
        bound = 1e3 * max(nbytes / HBM_BPS, ops_ / PEAK_OPS[name])
        extra = (f"; three TF32 products at 495 TFLOP/s: "
                 f"{1e3 * 3 * ops_ / TF32_OPS:.4f} ms" if f32 else "")
        log(f"  {key} {tag}: device {fmt(dev_ms)}, bound {bound:.4f} ms "
            f"(operations{extra}), plain {plain_ms:.3f} ms, SDPA (no mask) "
            f"{lib:.4f} ms")
        rows[(f"{key} whisper-medium encoder", name)] = dict(
            device_ms=dev_ms, bound_ms=bound, bound_by="operations",
            plain_ms=plain_ms, library_ms=lib, G=1, D=D,
            live_pairs=B * Q * Q)
        del q, k, v, qp, kp, vp, got, want
    return rows


def flex_variant_phase(torch, chk, gen):
    """K4's mask and score variants on both routes.  Main shapes (B 4, H =
    Hkv = 32, D 128, Q = K = 4096, padding lens 3500..4096): causal &
    padding, window & padding at 1024 and 4096 (the analytic windowed
    BlockMask, as the engine's prefill builds it; also against f64 in
    f32), and one case of each other variant family, each checked, timed
    (device), bounded by its live pairs and timed beside its library call;
    then a sweep at small shapes over every mod of core.flex."""
    import torch.nn.functional as F
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention import flex_attention as fa

    dev = torch.device("cuda")
    rows = {}
    B, H, D, Q = 4, 32, 128, 4096
    lens = torch.randint(3500, Q + 1, (B,), generator=gen,
                         device=dev).tolist()
    lens[0] = Q
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    pad = flex.padding_mask(lens_t)
    bounds = torch.tensor([0, 600, 1700, 2300, 3100, Q], device=dev)
    docs = (torch.arange(Q, device=dev)[None, :] >= bounds[1:-1, None]
            ).sum(0).int()[None].repeat(B, 1).contiguous()
    slopes = 2.0 ** (-8.0 * (torch.arange(H, device=dev) + 1) / H)
    # name: (mask, score, window of the analytic BlockMask, library call)
    main = {
        "causal&padding": (flex.and_masks(flex.causal_mask, pad), None, 0,
                           "mask"),
        "window1024&padding": (flex.and_masks(
            flex.sliding_window_mask(1024), pad), None, 1024, "mask"),
        "window4096&padding": (flex.and_masks(
            flex.sliding_window_mask(4096), pad), None, 4096, "mask"),
        "causal&document": (flex.and_masks(flex.causal_mask,
                                           flex.document_mask(docs)),
                            None, 0, "mask"),
        "prefix_lm|window": (flex.or_masks(flex.prefix_lm_mask(512),
                                           flex.sliding_window_mask(1024)),
                             None, 0, "mask"),
        "causal+softcap": (flex.causal_mask, flex.softcap_score(30.0), 0,
                           None),
        "causal+alibi": (flex.causal_mask, flex.alibi_score(slopes), 0,
                         "bias"),
    }
    log(f"K4 variants, main shapes: B={B} H=Hkv={H} D={D} Q=K={Q} padding "
        f"lens {lens}")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        route = fa.flex_route(dtype)
        shape = (B, H, Q, D)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        for case, (mod, score, window, lib_kind) in main.items():
            got = check_flex_variant(torch, chk, f"main {case}", q, k, v,
                                     mod, score, window=window)
            live = flex.materialize(mod, B, 1, Q, Q, device=dev).expand(
                B, 1, Q, Q)
            if case.startswith("window") and dtype == torch.float32:
                # the rows past each padding length differ by design (the
                # windowed BlockMask's full tiles skip the padding mask)
                keep = (torch.arange(Q, device=dev)[None, None, :, None]
                        < lens_t[:, None, None, None])
                plain = fa._flex_attention_plain(
                    q, k, v, op_block_mask(torch, mod, Q, Q, 128, 128, B,
                                           window), scale=D ** -0.5,
                    mask_mod=mod, q_len=Q, kv_len=Q)
                exact = flex_f64_mask(torch, q, k, v, live, D ** -0.5)
                chk.versus_f64(f"flex_prefill_{route}",
                               f"{name} main {case}, live rows",
                               got * keep, plain * keep, exact * keep)
                del plain, exact
            del got
            bm = op_block_mask(torch, mod, Q, Q, 128, 128, B, window)
            kw = dict(scale=D ** -0.5, mask_mod=mod, score_mod=score,
                      q_len=Q, kv_len=Q)
            dev_ms = device_ms(torch, lambda: fa.flex_attention_kernel(
                q, k, v, bm, **kw), KERNEL_NAMES["flex_prefill_" + route],
                reps=3)
            ev_ms = time_ms(torch, lambda: fa.flex_attention_kernel(
                q, k, v, bm, **kw), reps=5)
            pairs = int(live.sum()) * H
            ops = 4 * D * pairs
            nbytes = 4 * q.numel() * q.element_size()
            bound = 1e3 * max(nbytes / HBM_BPS, ops / PEAK_OPS[name])
            by = ("operations" if ops / PEAK_OPS[name] > nbytes / HBM_BPS
                  else "bytes")
            lib = None
            if lib_kind == "mask":
                lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=live), reps=3, warmup=1)
            elif lib_kind == "bias":
                qi = torch.arange(Q, device=dev)
                bias = (-slopes[:, None, None] * (qi[:, None] - qi[None, :])
                        ).to(dtype)[None]
                bias = bias.masked_fill(~live, float("-inf"))
                lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias), reps=3, warmup=1)
                del bias
            row = dict(ms=ev_ms, device_ms=dev_ms, bound_ms=bound,
                       bound_by=by, library_ms=lib, live_pairs=pairs)
            extra = ""
            if dtype == torch.float32:
                row["bound_tf32x3_ms"] = 1e3 * 3 * ops / TF32_OPS
                extra = (f", three TF32 products "
                         f"{row['bound_tf32x3_ms']:.4f} ms")
            lib_txt = {"mask": f"SDPA with the boolean mask {fmt(lib)}",
                       "bias": f"SDPA with the ALiBi bias {fmt(lib)}",
                       None: "none (no single call computes it)"}[lib_kind]
            log(f"  flex_prefill_{route} {name} {case}: kernel "
                f"{ev_ms:.4f} ms (device {fmt(dev_ms)}), bound "
                f"{bound:.4f} ms ({by}, {pairs:.4e} live pairs{extra}), "
                f"library {lib_txt}")
            rows[(f"flex_prefill_{route}:{case}", name)] = row
            del live
        if dtype == torch.bfloat16:
            rows[("torch_flex_attention", name)] = torch_flex_yardstick(
                torch, q, k, v, lens_t)
        del q, k, v
    flex_variant_sweep(torch, chk, gen)
    return rows


def torch_flex_yardstick(torch, q, k, v, lens_t):
    """PyTorch's own FlexAttention (``torch.nn.attention.flex_attention``,
    compiled) on window & padding at the main shapes: the paper's
    baseline, timed as a yardstick; the port never calls it.  Returns
    {window: ms}, or the reason it did not run."""
    out = {}
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        B, _, Q, _ = q.shape
        fn = torch.compile(flex_attention)
        for window in (1024, 4096):
            def mod(b, h, qi, ki, w=window):
                return (ki <= qi) & (qi - ki < w) & (ki < lens_t[b])
            t0 = time.perf_counter()
            bm = create_block_mask(mod, B, None, Q, Q, device="cuda")
            fn(q, k, v, block_mask=bm)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            out[window] = time_ms(torch, lambda: fn(q, k, v, block_mask=bm),
                                  reps=5)
            log(f"  torch.nn.attention.flex_attention bfloat16 window "
                f"{window} & padding: {out[window]:.4f} ms (compile and "
                f"first call {first:.1f} s)")
    except Exception as e:  # a yardstick only: its failure fails nothing
        log(f"  torch.nn.attention.flex_attention: not measured "
            f"({type(e).__name__}: {str(e)[:200]})")
        out["error"] = repr(e)[:500]
    return out


def flex_variant_sweep(torch, chk, gen):
    """Every mod of core.flex on both routes at small shapes: D 64 and 128,
    GQA (G 4), q tiles 128 and 120, K not a multiple of the tile (the op
    pads); windows 1, 100 and 1000; documents contiguous and interleaved;
    prefix_lm 0, 100 and Q; or(prefix_lm, window); paged_mask over 3
    packed sequences; softcap 30, ALiBi, compose_score in both orders;
    window & padding with softcap; ordered V rows."""
    from repro_torch.core import flex
    dev = torch.device("cuda")
    B, H, Hkv, Q = 2, 8, 2, 1100
    lens = torch.tensor([Q, 777], dtype=torch.int32, device=dev)
    pad = flex.padding_mask(lens)
    contiguous = (torch.arange(Q, device=dev) // 300).int()[None].repeat(
        B, 1).contiguous()
    interleaved = torch.randint(0, 3, (B, Q), generator=gen, device=dev,
                                dtype=torch.int32)
    slots = [400, 500, 200]
    sid = torch.repeat_interleave(torch.arange(3, device=dev),
                                  torch.tensor(slots, device=dev)).int()
    pos = torch.cat([torch.arange(n, device=dev) for n in slots]).int()
    seq_lens = torch.tensor([350, 500, 60], dtype=torch.int32, device=dev)
    slopes = 2.0 ** (-8.0 * (torch.arange(H, device=dev) + 1) / H)
    cap, alibi = flex.softcap_score(30.0), flex.alibi_score(slopes)
    cases = [  # (tag, mask, score, window, D, q tile, kv tile)
        ("window 1", flex.sliding_window_mask(1), None, 1, 128, 128, 128),
        ("window 100 & padding", flex.and_masks(
            flex.sliding_window_mask(100), pad), None, 100, 64, 120, 128),
        ("window 1000 & padding", flex.and_masks(
            flex.sliding_window_mask(1000), pad), None, 1000, 128, 128, 96),
        ("window 100, streaming BlockMask", flex.sliding_window_mask(100),
         None, 0, 128, 120, 128),
        ("documents contiguous", flex.and_masks(
            flex.causal_mask, flex.document_mask(contiguous)), None, 0, 128,
         128, 128),
        ("documents interleaved", flex.document_mask(interleaved), None, 0,
         64, 120, 128),
        ("prefix_lm 0", flex.prefix_lm_mask(0), None, 0, 128, 128, 128),
        ("prefix_lm 100 & padding", flex.and_masks(
            flex.prefix_lm_mask(100), pad), None, 0, 64, 128, 128),
        ("prefix_lm Q", flex.prefix_lm_mask(Q), None, 0, 128, 120, 128),
        ("prefix_lm 100 | window 50", flex.or_masks(
            flex.prefix_lm_mask(100), flex.sliding_window_mask(50)), None,
         0, 128, 128, 128),
        ("paged, 3 packed sequences", flex.paged_mask(sid, pos, seq_lens),
         None, 0, 128, 128, 128),
        ("softcap 30", flex.causal_mask, cap, 0, 128, 128, 128),
        ("alibi", flex.causal_mask, alibi, 0, 64, 120, 128),
        ("softcap then alibi", flex.causal_mask, flex.compose_score(
            cap, alibi), 0, 128, 128, 128),
        ("alibi then softcap", flex.and_masks(
            flex.causal_mask, pad), flex.compose_score(alibi, cap), 0, 128,
         128, 128),
        ("window 100 & padding + softcap", flex.and_masks(
            flex.sliding_window_mask(100), pad), cap, 100, 128, 128, 128),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for tag, mod, score, window, D, qb, kb in cases:
            q = torch.randn((B, H, Q, D), generator=gen, device=dev
                            ).to(dtype)
            k, v = (torch.randn((B, Hkv, Q, D), generator=gen, device=dev
                                ).to(dtype) for _ in range(2))
            if tag.startswith("documents interleaved"):
                v = ramp_v(torch, v)  # ordered V rows
            check_flex_variant(torch, chk, f"sweep {tag} B{B} H{H}/{Hkv} "
                               f"Q=K={Q} D{D}", q, k, v, mod, score, qb, kb,
                               window)


def ring_decode_cases(torch, chk, gen):
    """K1 (and K2, the decode op) at full width on ring tables, as the swa
    engine decodes: window 4096, a ring of 65 pages of 64, lens 4160..5016
    (the ring has wrapped), bf16 and f32, against the plain K1."""
    from repro_torch.kernels.paged_attention import ops
    dev = torch.device("cuda")
    window, P = 4096, 64
    ring = -(-window // P) + 1
    lens = torch.randint(4160, 5017, (4,), generator=gen,
                         device=dev).tolist()
    ppb, ns = ops.choose_decode_params(ring, P, 128, None, None)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        args = paged_inputs(torch, gen, 4, 32, 1, 128, P, ring, lens, dtype,
                            dev, window=window)
        kw = dict(scale=128 ** -0.5, window=window, pages_per_block=ppb,
                  num_splits=ns)
        check_decode(torch, chk, f"{name} ring of {ring} pages, window "
                     f"{window}, lens {lens}", args, kw, dtype, tol)


def op_host_parts(torch, args, kw):
    """Host microseconds per call of the decode op's parts, each timed
    alone over calls queued back to back: the wrapper's preparation
    (checks, partition, allocations, C arguments), the raw stream, the C
    call (two tensor maps, K1's and K2's launches), and the whole op."""
    from repro_torch.kernels import use_kernel
    from repro_torch.kernels.build import get_lib
    from repro_torch.kernels.paged_attention import paged_attention as pa
    lib = get_lib()
    name, c_args, _, _, _ = pa._decode_call(*args, window=0, softcap=0.0,
                                            kv_scale=0.0, combine=True, **kw)
    idx = args[0].device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    fn = getattr(lib, name)
    parts = {
        "device check": lambda: use_kernel("decode", *args),
        "preparation": lambda: pa._decode_call(
            *args, window=0, softcap=0.0, kv_scale=0.0, combine=True, **kw),
        "device + stream": lambda: (torch.cuda.current_device(),
                                    torch._C._cuda_getCurrentRawStream(idx)),
        "C call": lambda: fn(*c_args, stream),
        "whole op": lambda: pa.paged_attention_kernel(*args, **kw),
    }
    return {k: 1e3 * host_ms(torch, f, reps=200) for k, f in parts.items()}


def check_decode(torch, chk, tag, args, kw, dtype, tol, f64=False,
                 hold_f64=False):
    """K1's partials, K2 and the decode op against their plain versions,
    the decode op (one C call) against K1's and K2's wrappers called one
    after the other bit for bit (``torch.equal``), all-dead slots exact
    zeros; with ``f64``, also how far each side is from the plain version
    in f64; with ``hold_f64``, K1's partials are checked against the f64
    evaluation instead of the f32 plain version (rows of 192)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    kw = dict(dict(window=0, softcap=0.0, kv_scale=0.0), **kw)
    got = pa.paged_attention_partials(*args, **kw)
    want = pa._paged_attention_partials_plain(*args, **kw)
    if not hold_f64:
        for part, g_, w_ in zip("m l acc".split(), got, want):
            chk.close("paged_decode", f"{tag} {part}", g_, w_, tol)
    if f64 or hold_f64:
        q, kp, vp = (x.double() for x in args[:3])
        exact = pa._paged_attention_partials_plain(q, kp, vp, *args[3:], **kw)
        for part, g_, w_, x_ in zip("m l acc".split(), got, want, exact):
            chk.versus_f64("paged_decode", f"{tag} {part}", g_, w_, x_,
                           tol=tol if hold_f64 else None)
        del exact
    split = pa.combine_partials_kernel(*got, dtype=dtype)  # K1 -> K2
    chk.close("combine", tag, split,
              pa._combine_partials_plain(*got, dtype=dtype), tol)
    op = pa.paged_attention_kernel(*args, **kw)
    chk.close("decode_op", tag, op,
              pa._combine_partials_plain(*want, dtype=dtype), tol)
    if not torch.equal(op, split):
        fail(f"decode op {tag}: not K1's partials then K2 bit for bit")
    dead = op[args[4] == 0]
    if not torch.equal(dead, torch.zeros_like(dead)):
        fail(f"decode op {tag}: all-dead slots are not exact zeros")


def decode_edge_cases(torch, chk, gen):
    """K1, K2 and the op at the edges of the new kernel's tiles, pages and
    splits, over a full table, and at smaller pages."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops

    dev = torch.device("cuda")
    both = ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL))
    # main widths: lens at the 32-token tile, the 64-token page and the
    # 512-token split edges; 1 leaves three of the four splits empty, 0
    # all four
    lens = [1, 63, 64, 65, 512, 513, 2048, 0]
    for dtype, tol in both:
        name = str(dtype).replace("torch.", "")
        args = paged_inputs(torch, gen, len(lens), 32, 1, 128, 64, 32, lens,
                            dtype, dev)
        kw = dict(scale=128 ** -0.5, pages_per_block=2, num_splits=4)
        check_decode(torch, chk, f"{name} edge lens {lens}", args, kw,
                     dtype, tol)
    # the full 32-page table in one split of 16 blocks: 2048 keys
    for dtype, tol in both:
        name = str(dtype).replace("torch.", "")
        args = paged_inputs(torch, gen, 2, 32, 1, 128, 64, 32, [2048, 1999],
                            dtype, dev)
        kw = dict(scale=128 ** -0.5, pages_per_block=2, num_splits=1)
        check_decode(torch, chk, f"{name} full table, 1 split of 2048",
                     args, kw, dtype, tol, f64=dtype == torch.float32)
    # pages of 8 and 16 tokens at smoke width (several pages per tile),
    # the engine's blocks for a 256-token table, in two splits
    scfg = get_config("llama2-7b").smoke()
    Hs, Ds = scfg.n_kv_heads, scfg.resolved_head_dim
    Gs = scfg.n_heads // Hs
    for Ps in (8, 16):
        mp = 256 // Ps
        ppb, ns = ops.choose_decode_params(mp, Ps, Ds, None, 2)
        slens = [1, Ps - 1, Ps, Ps + 1, 33, 100, 256]
        for dtype, tol in both:
            for int8 in (False, True):
                name = str(dtype).replace("torch.", "")
                args = paged_inputs(torch, gen, len(slens), Hs, Gs, Ds, Ps,
                                    mp, slens, dtype, dev, int8=int8)
                kw = dict(scale=Ds ** -0.5, kv_scale=0.05 if int8 else 0.0,
                          pages_per_block=ppb, num_splits=ns)
                check_decode(torch, chk, f"{name} smoke H{Hs} G{Gs} D{Ds} "
                             f"page {Ps} ppb {ppb} S {ns}"
                             f"{' int8' if int8 else ''}", args, kw, dtype,
                             tol)


def decode_split_cases(torch, chk, gen):
    """The decode op at every split count from 1 to 8 and at 12, at the
    main widths (B 8, 32 heads, D 128, a 2048-token table of 64-token
    pages, 2 pages per block) with the edge lens 0, 1, 63, 64, 65, 512,
    513 and 2048, in f32 and bf16 (``check_decode``), each op launching K2
    once at the decode layout."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    lens = [0, 1, 63, 64, 65, 512, 513, 2048]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        args = paged_inputs(torch, gen, len(lens), 32, 1, 128, 64, 32, lens,
                            dtype, dev)
        for S in (*range(1, 9), 12):
            kw = dict(scale=128 ** -0.5, pages_per_block=2, num_splits=S)
            check_decode(torch, chk, f"{name} edge lens, S {S}", args, kw,
                         dtype, tol)
            before = dict(pa.combine_partials_kernel.launches_by_route)
            pa.paged_attention_kernel(*args, **kw)
            after = pa.combine_partials_kernel.launches_by_route
            moved = {k: after[k] - before[k] for k in after}
            if moved != {"decode": 1, "prefill": 0, "dist": 0}:
                fail(f"decode op at S {S}: K2 launches {moved}")


def chunk_inputs(torch, gen, Hkv, G, D, P, max_pages, q_start, q_lens, dtype,
                 dev, int8=False):
    """Chunk queries (B, C, H, D), pools, tables with each live row's pages
    scattered and -1 elsewhere (dead rows: q_lens 0), kv_lens, q_start."""
    B, C = len(q_start), max(max(q_lens), 1)
    kv_lens = [s + n for s, n in zip(q_start, q_lens)]
    q, kp, vp, tables, _ = paged_inputs(torch, gen, B, Hkv, 1, D, P,
                                        max_pages, [0] * B, dtype, dev,
                                        int8=int8)
    q = torch.randn((B, C, Hkv * G, D), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(kp.shape[0], generator=gen, device=dev).int()
    k = 0
    for b in range(B):
        n = -(-kv_lens[b] // P) if q_lens[b] else 0
        tables[b, :n] = perm[k:k + n]
        k += n
    i32 = dict(dtype=torch.int32, device=dev)
    return (q, kp, vp, tables, torch.tensor(kv_lens, **i32),
            torch.tensor(q_start, **i32))


def fold_prefill(t, S):
    """(B, Hkv, NQ, S, R[, D]) partials → the combine's (B·NQ, Hkv, S, R[, D])."""
    B, Hkv, NQ = t.shape[:3]
    return t.transpose(1, 2).reshape(B * NQ, Hkv, S, *t.shape[4:]).contiguous()


def folded_prefill_combine(torch, m, l, acc, C, q_block, dtype):
    """The prefill combine as it ran on the card before the strided K2:
    the Q-blocks folded into the batch (three transposing copies), the
    plain normalise at one split (K2 at the decode layout above), then a
    permuting copy into (B, C, H, D)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    B, n_kv, NQ, S, R = m.shape
    D, G = acc.shape[-1], R // q_block
    folded = [fold_prefill(x, S) for x in (m, l, acc)]
    o = (pa.combine_partials_kernel(*folded, dtype=dtype) if S > 1
         else pa._combine_partials_plain(*folded, dtype=dtype))
    o = o.reshape(B, NQ, n_kv, q_block, G, D).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(B, NQ * q_block, n_kv * G, D)[:, :C]


def check_prefill_combine(torch, chk, tag, got, C, q_block, dtype, tol):
    """The strided K2 on K3's partials ``got`` where they lie, into (B, C,
    H, D), against its plain version (``combine/prefill``)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    before = pa.combine_partials_kernel.launches_by_route["prefill"]
    out = pa.combine_prefill_partials(*got, C, q_block, dtype=dtype)
    if pa.combine_partials_kernel.launches_by_route["prefill"] != before + 1:
        fail(f"prefill combine {tag}: K2 did not launch on its route")
    want = pa._combine_prefill_plain(*got, C, q_block, dtype=dtype)
    chk.close("combine/prefill", f"{tag} S{got[0].shape[3]} C{C}", out,
              want, tol)


def all_device_ms(torch, fn, reps=5):
    """Device time per call of every CUDA kernel ``fn`` launches, from
    torch.profiler (None when it records none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
             for ev in prof.key_averages()
             if str(getattr(ev, "device_type", "")).endswith("CUDA"))
    return us / 1e3 / reps if us > 0 else None


def time_prefill_combine(torch, chk, name, got, C, q_block, dtype, tol):
    """The prefill combine of one layer at the main chunk shape: the
    strided K2 (events and device) against the way the card ran it before
    (`folded_prefill_combine`: events and the device time of all its
    kernels), the plain version, and the byte bound (the partials read
    once, the output written once)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    new = lambda: pa.combine_prefill_partials(  # noqa: E731
        *got, C, q_block, dtype=dtype)
    old = lambda: folded_prefill_combine(  # noqa: E731
        torch, *got, C, q_block, dtype)
    chk.close("combine/prefill", f"{name} main chunk step (S 1) against "
              "the folded path", new(), old(), tol)
    out = new()
    nbytes = (sum(t.numel() * 4 for t in got)
              + out.numel() * out.element_size())
    row = dict(ms=time_ms(torch, new), device_ms=device_ms(
        torch, new, "combine_kernel"),
        plain_ms=time_ms(torch, lambda: pa._combine_prefill_plain(
            *got, C, q_block, dtype=dtype), reps=5),
        bound_ms=1e3 * nbytes / HBM_BPS, bound_by="bytes", library_ms=None,
        folded_ms=time_ms(torch, old), folded_device_ms=all_device_ms(
            torch, old))
    log(f"  combine/prefill {name} (per layer, {nbytes / 1e6:.1f} MB): "
        f"kernel {row['ms']:.4f} ms (device {fmt(row['device_ms'])}), "
        f"before (fold + plain + permute) {row['folded_ms']:.4f} ms (device "
        f"{fmt(row['folded_device_ms'])}), plain {row['plain_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms (bytes)")
    return row


def prefill_combine_cases(torch, chk, gen):
    """The strided K2 on K3's partials at S 1, 2 and 4 on each of K3's
    eight routes (bf16 or f32 q; pools of q's dtype or int8; pages of 16
    or 12), at G 6 with the engine's q_block (21: R = 126 rows) and a
    chunk of 40 tokens (not a multiple of q_block), D 128, against its
    plain version."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    G, D, q_start, q_lens = 6, 128, [100, 0, 37], [40, 37, 0]
    for P in (16, 12):
        mp = -(-160 // P)
        for int8 in (False, True):
            for dtype, tol in ((torch.bfloat16, BF16_TOL),
                               (torch.float32, F32_TOL)):
                args = chunk_inputs(torch, gen, 2, G, D, P, mp, q_start,
                                    q_lens, dtype, dev, int8=int8)
                route = pa.prefill_route(dtype, torch.int8 if int8 else
                                         dtype, P)
                for S in (1, 2, 4):
                    _, _, qb = ops.choose_prefill_params(mp, P, D, 40, G)
                    kw = dict(scale=D ** -0.5, softcap=0.0,
                              kv_scale=0.05 if int8 else 0.0,
                              pages_per_block=1, num_splits=S, q_block=qb)
                    got = pa.paged_prefill_partials(*args, **kw)
                    check_prefill_combine(
                        torch, chk, f"{route} G{G} D{D} page {P} q_block "
                        f"{qb} (R {qb * G})", got, args[0].shape[1], qb,
                        dtype, tol)


def check_k3(torch, chk, key, tag, args, kw, got, tol, f64=False):
    """K3's partials ``got`` against its plain version on ``args``; with
    ``f64`` (the f32 cases whose plain version carries rounding of the
    order of the f32 tolerance: long tables, D 192, int8 pools) against
    the plain version evaluated in f64 instead, acc on int8 pools bounded
    by the magnitude its sum is taken over (``Checker.versus_f64``)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    want = pa._paged_prefill_partials_plain(*args, **kw)
    if not f64:
        for part, g_, w_ in zip(("m", "l", "acc"), got, want):
            chk.close(key, f"{tag} {part}", g_, w_, tol)
        return
    dbl = [x.double() for x in args[:3]]
    exact = pa._paged_prefill_partials_plain(*dbl, *args[3:], **kw)
    mag = None
    if kw["kv_scale"] > 0:
        mag = pa._paged_prefill_partials_plain(dbl[0], dbl[1], dbl[2].abs(),
                                               *args[3:], **kw)[2]
    for part, g_, w_, x_ in zip(("m", "l", "acc"), got, want, exact):
        chk.versus_f64(key, f"{tag} {part}", g_, w_, x_, tol=tol,
                       mag=mag if part == "acc" else None)


def k3_bound(torch, q, kp, tables, kv_lens, got, q_start, q_lens, H, D):
    """K3's least time on the card for this call, ms: the larger of the
    bytes it must move (q, the live K/V rows, tables, lens, partials) at
    3.35 TB/s and its operations (4 D per live (row, key) pair and head)
    at the peak of q's type (bf16 989, f32 67 TFLOP/s), whichever bounds
    it, and the operations as the split-TF32 tile does them (three TF32
    products, two on int8 pools) at 495 TFLOP/s (f32 q; else None)."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        prefill_cost)
    keys = sum(s + t + 1 for s, n in zip(q_start, q_lens) for t in range(n))
    ops, nbytes = prefill_cost(
        q.shape, kp.shape[2], keys, sum(kv_lens.tolist()), tables.shape[1],
        sum(t.numel() * 4 for t in got), q.element_size(),
        kp.element_size())
    f32 = q.dtype == torch.float32
    peak = PEAK_OPS["float32" if f32 else "bfloat16"]
    bound = 1e3 * max(nbytes / HBM_BPS, ops / peak)
    by = "operations" if ops / peak > nbytes / HBM_BPS else "bytes"
    tf32 = None
    if f32:
        products = 2 if kp.dtype == torch.int8 else 3
        tf32 = 1e3 * max(nbytes / HBM_BPS, products * ops / TF32_OPS)
    return bound, by, ops, nbytes, tf32


def prefill_kernel_phase(torch, chk, gen):
    """K3 against its plain version: the main path's chunk step, then a
    sweep; K2 merges the sweep's split-K partials."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as pa

    dev = torch.device("cuda")
    rows = {}
    # -- K3 at the main-path shapes: a 512-token chunk step of 8 rows,
    #    resumes at 0 / 512 / 1024 / 1061, ragged last chunks, 2 dead rows
    H, D, P, max_pages, ppb, ns, qb = 32, 128, 64, 32, 2, 1, 128
    q_start = [0, 512, 1024, 1024 + 37, 512, 0, 1, 1]
    q_lens = [512, 512, 512, 512, 300, 200, 0, 0]
    log(f"K3 main path: B={len(q_start)} C=512 H=Hkv={H} D={D} page={P} "
        f"max_pages={max_pages} ppb={ppb} splits={ns} q_block={qb} "
        f"q_start={q_start} q_lens={q_lens}")
    # f32 and bf16 q on their tensor-core tiles, over pools of q's dtype
    # and over int8 pools (the int8 variants; f32 q held against f64);
    # then the same over odd pages of 12 tokens (the "/odd" variants: boxes
    # 16 rows apart, the gaps masked) at the KV-block width the engine
    # takes for them (10 pages)
    configs = ((torch.float32, False, F32_TOL), (torch.bfloat16, False,
                                                 BF16_TOL),
               (torch.bfloat16, True, BF16_TOL), (torch.float32, True,
                                                  F32_TOL))
    for (dtype, int8, tol), Pc in [(c, P) for c in configs] + [
            (c, 12) for c in configs]:
        mp = -(-max_pages * P // Pc)
        cppb = ppb if Pc == P else ops.choose_prefill_params(
            mp, Pc, D, 512, 1)[0]
        name = (("int8" if int8 else str(dtype).replace("torch.", ""))
                + ("" if Pc == P else f" page {Pc}"))
        key = "paged_prefill_" + pa.prefill_route(
            dtype, torch.int8 if int8 else dtype, Pc)
        q, kp, vp, tables, kv_lens, qs = chunk_inputs(
            torch, gen, H, 1, D, Pc, mp, q_start, q_lens, dtype, dev,
            int8=int8)
        kv_scale = 0.05 if int8 else 0.0
        kw = dict(scale=D ** -0.5, softcap=0.0, kv_scale=kv_scale,
                  pages_per_block=cppb, num_splits=ns, q_block=qb)
        args = (q, kp, vp, tables, kv_lens, qs)
        got = pa.paged_prefill_partials(*args, **kw)
        torch.cuda.synchronize()
        check_k3(torch, chk, key, f"{name} main", args, kw, got, tol,
                 f64=int8 and dtype == torch.float32)
        k3_ms = time_ms(torch, lambda: pa.paged_prefill_partials(*args, **kw),
                        reps=5)
        k3_plain = time_ms(torch, lambda: pa._paged_prefill_partials_plain(
            *args, **kw), reps=3, warmup=1)
        k3_dev = device_ms(torch, lambda: pa.paged_prefill_partials(
            *args, **kw), kernel_name(key), reps=3)
        # library yardstick: SDPA over K/V pre-gathered into contiguous
        # form (int8 pools dequantised), with the causal-offset mask as a
        # boolean attn_mask (the gather is not timed; the dead rows'
        # all-false masks are moot)
        B, C = q.shape[:2]
        L = int(kv_lens.max())
        safe = tables.clamp(min=0).long()

        def gathered(pool):
            x = pool[safe].reshape(B, -1, H, D)[:, :L].transpose(1, 2)
            return (x.to(dtype) * kv_scale if int8 else x).contiguous()

        kc, vc = gathered(kp), gathered(vp)
        pos = torch.arange(L, device=dev)
        qpos = qs[:, None].long() + torch.arange(C, device=dev)[None]
        mask = ((pos[None, None] < kv_lens[:, None, None])
                & (pos[None, None] <= qpos[:, :, None]))[:, None]
        qt = q.transpose(1, 2).contiguous()
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=mask), reps=5)
        k3_bound_ms, k3_by, flops, nbytes, tf32 = k3_bound(
            torch, q, kp, tables, kv_lens, got, q_start, q_lens, H, D)
        row = dict(ms=k3_ms, device_ms=k3_dev, plain_ms=k3_plain,
                   bound_ms=k3_bound_ms, bound_by=k3_by, library_ms=lib)
        extra = ""
        if tf32 is not None:
            row["bound_tf32x3_ms"] = tf32
            extra = (f"; bound_ms is the f32 operations at 67 TFLOP/s, "
                     f"{2 if int8 else 3} TF32 products at 495 TFLOP/s: "
                     f"{tf32:.4f} ms")
        log(f"  {key} {name}: kernel {k3_ms:.4f} ms (device "
            f"{fmt(k3_dev)}), plain {k3_plain:.4f} ms, bound "
            f"{k3_bound_ms:.4f} ms ({k3_by}: {flops:.3e} flop, {nbytes:.3e} "
            f"B{extra}), SDPA with a causal-offset mask over pre-gathered "
            f"KV {lib:.4f} ms")
        rows[(key, name)] = row
        if not int8 and Pc == P:
            rows[("combine/prefill", name)] = time_prefill_combine(
                torch, chk, name, got, C, qb, dtype, tol)
        del q, kp, vp, kc, vc, got, mask

    # -- K3 sweep: GQA, D=64, softcap, int8, split-K through K2, q_block
    #    1 and 3, single-token chunk rows, R > 128 (three row tiles), every
    #    route's pages
    both = ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL))
    sweep = [  # (G, D, P, max_pages, q_start, q_lens, ppb, S, q_block,
        #         softcap, int8, dtypes)
        (4, 128, 16, 9, [100, 0, 1], [40, 37, 0], 2, 1, 32, 0.0, False, both),
        (1, 64, 16, 9, [17, 60], [50, 13], 1, 2, 3, 30.0, False, both),
        (2, 128, 8, 12, [30, 5, 0], [9, 1, 9], 2, 3, 1, 0.0, True, both),
        (8, 64, 16, 6, [20, 33], [45, 1], 3, 2, 40, 0.0, False, both),
        (2, 64, 16, 9, [16, 130, 7], [1, 1, 1], 1, 2, 1, 0.0, True, both),
        # a 512-token chunk resuming at 1536 over a full 32-page table (kv
        # 2048, 32 heads): the tiles' longest un-normalised sums (f32 also
        # held against the plain version in f64); then Q-blocks of R =
        # q_block * G = 128 and 120 rows (not a multiple of 64)
        (1, 128, 64, 32, [1536, 1000], [512, 300], 2, 1, 128, 0.0, False,
         both),
        (4, 128, 16, 9, [40, 3], [70, 64], 2, 1, 32, 0.0, False, both),
        (8, 128, 16, 9, [0, 21], [45, 30], 2, 2, 15, 0.0, False, both),
        # pages of 8 (eight to an f32 tile), 12 (odd: boxes 16 rows apart,
        # the gaps masked per element), 96 and 128 (longer than the f32
        # tile: cut into boxes of 64 rows, the last of a 96-token page
        # masked at 32), 200 (longer than either tile: boxes of 128 and 64
        # rows, the last of the page masked at 72 and 8)
        (2, 128, 8, 12, [30, 5, 0], [9, 1, 9], 2, 3, 1, 0.0, False, both),
        (2, 64, 12, 9, [16, 50], [20, 7], 2, 2, 4, 0.0, False, both),
        (2, 64, 12, 9, [16, 50], [20, 7], 2, 2, 4, 0.0, True, both),
        (1, 128, 96, 4, [100, 0], [200, 96], 2, 1, 64, 0.0, False, both),
        (2, 128, 128, 4, [300, 17], [100, 64], 1, 2, 32, 10.0, False, both),
        (1, 128, 200, 3, [100, 0], [300, 150], 1, 2, 64, 0.0, False, both),
        (1, 128, 200, 3, [100, 0], [300, 150], 1, 2, 64, 0.0, True, both),
    ]
    for (G, Dd, Ps, mp, qst, qln, sp_ppb, sp_ns, sp_qb, cap, int8,
         dtypes) in sweep:
        for dtype, tol in dtypes:
            name = str(dtype).replace("torch.", "")
            key = "paged_prefill_" + pa.prefill_route(
                dtype, torch.int8 if int8 else dtype, Ps)
            args = chunk_inputs(torch, gen, 32 if mp == 32 else 2, G, Dd, Ps,
                                mp, qst, qln, dtype, dev, int8=int8)
            kw = dict(scale=Dd ** -0.5, softcap=cap,
                      kv_scale=0.05 if int8 else 0.0,
                      pages_per_block=sp_ppb, num_splits=sp_ns,
                      q_block=sp_qb)
            got = pa.paged_prefill_partials(*args, **kw)
            tag = (f"{name} G{G} D{Dd} page {Ps} q_block{sp_qb} S{sp_ns} "
                   f"cap{cap:g} {'int8' if int8 else ''}"
                   f"{' full table' if mp == 32 else ''}")
            # the full table and int8 pools in f32: the f32 plain version's
            # own rounding (over 2048 keys; over V up to 127 * 0.05) is of
            # the order of the f32 tolerance, so the kernel is held against
            # f64 instead
            check_k3(torch, chk, key, tag, args, kw, got, tol,
                     f64=dtype == torch.float32 and (mp == 32 or int8))
            check_prefill_combine(torch, chk, tag, got, args[0].shape[1],
                                  sp_qb, dtype, tol)
    prefill_permutation_case(torch, chk, gen)
    prefill_odd_page_cases(torch, chk, gen)
    # K2 on K3's partials at every route, from its own generator
    own = torch.Generator(device=dev)
    own.manual_seed(SEED + 20)
    prefill_combine_cases(torch, chk, own)
    return rows


def prefill_odd_page_cases(torch, chk, gen):
    """K3 on pages of 7 tokens (up to 16 boxes 8 rows apart in a stage,
    the gaps masked per element) at D 64 and 192, G 1 and 6, over pools of
    q's dtype and int8 pools, both q dtypes, two splits through K2 (f32 on
    int8 pools held against f64)."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    q_start, q_lens = [93, 0, 40], [40, 57, 0]
    mp = -(-max(s + n for s, n in zip(q_start, q_lens)) // 7)
    for D in (64, 192):
        for G in (1, 6):
            for int8 in (False, True):
                for dtype, tol in ((torch.float32, F32_TOL),
                                   (torch.bfloat16, BF16_TOL)):
                    ppb, ns, qb = ops.choose_prefill_params(mp, 7, D, 57, G,
                                                            num_splits=2)
                    args = chunk_inputs(torch, gen, 2, G, D, 7, mp, q_start,
                                        q_lens, dtype, dev, int8=int8)
                    kw = dict(scale=D ** -0.5, softcap=0.0,
                              kv_scale=0.05 if int8 else 0.0,
                              pages_per_block=ppb, num_splits=ns,
                              q_block=qb)
                    key = "paged_prefill_" + pa.prefill_route(
                        dtype, torch.int8 if int8 else dtype, 7)
                    name = str(dtype).replace("torch.", "")
                    tag = (f"{name}{' int8' if int8 else ''} G{G} D{D} odd "
                           f"page 7 ppb {ppb} S {ns}")
                    got = pa.paged_prefill_partials(*args, **kw)
                    check_k3(torch, chk, key, tag, args, kw, got, tol,
                             f64=int8 and dtype == torch.float32)
                    check_prefill_combine(torch, chk, tag, got,
                                          args[0].shape[1], qb, dtype, tol)


def prefill_permutation_case(torch, chk, gen):
    """K3 with distinct, ordered V rows (each pool token's row is its own
    index plus a small per-column term): pages of 16 (several to a tile),
    a chunk of 100 at 37 and one of 64 at 0, in both dtypes."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        q, kp, vp, tables, kv_lens, qs = chunk_inputs(
            torch, gen, 2, 4, 128, 16, 12, [37, 0], [100, 64], dtype, dev)
        n, P, _, D = vp.shape
        tok = torch.arange(n * P, device=dev).reshape(n, P, 1, 1) / (n * P)
        vp = (tok + 1e-3 * torch.arange(D, device=dev) + 0.01 * vp.float()
              ).to(dtype).contiguous()
        args = (q, kp, vp, tables, kv_lens, qs)
        kw = dict(scale=D ** -0.5, softcap=0.0, kv_scale=0.0,
                  pages_per_block=2, num_splits=1, q_block=32)
        got = pa.paged_prefill_partials(*args, **kw)
        want = pa._paged_prefill_partials_plain(*args, **kw)
        key = "paged_prefill_" + pa.prefill_route(dtype, dtype, P)
        for part, g_, w_ in zip("m l acc".split(), got, want):
            chk.close(key, f"{name} ordered V rows {part}", g_, w_, tol)


# the repo's configs whose attention heads the kernel phase runs at reduced
# batch and length: (name, H, Hkv, D)
REAL_HEADS = (("nemotron-4-15b", 48, 8, 128), ("llama3-405b", 128, 8, 128),
              ("nemotron-4-340b", 96, 8, 192),
              ("granite-moe-1b-a400m", 16, 8, 64),
              ("llama-3.2-vision-11b", 32, 8, 128),
              ("whisper-medium", 16, 16, 64))


def gqa_head_phase(torch, chk, gen):
    """K1 at every GQA group and head dim, K3 and K4 at D = 192, and all
    three at the real heads of nemotron-4-15b, llama3-405b,
    nemotron-4-340b, granite-moe-1b-a400m (G 2, D 64),
    llama-3.2-vision-11b (G 4, D 128) and whisper-medium (G 1, D 64)
    (timed).  Returns the timed rows."""
    gqa_decode_cases(torch, chk, gen)
    gqa_prefill_cases(torch, chk, gen)
    gqa_flex_cases(torch, chk, gen)
    rows = decode_chunk_cost(torch, chk, gen)
    for name, H, Hkv, D in REAL_HEADS:
        rows.update(real_heads_decode(torch, chk, gen, name, H, Hkv, D))
        rows.update(real_heads_prefill(torch, chk, gen, name, H, Hkv, D))
        rows.update(real_heads_flex(torch, chk, gen, name, H, Hkv, D))
    return rows


def gqa_decode_cases(torch, chk, gen):
    """K1 (with K2 and the decode op) at G in {3, 6, 12, 16, 24} and D in
    {64, 128, 192}, with f32, bf16 and int8 pools (int8 with bf16 q); a
    ring table at G 6; int8 pools with odd pages of 7 tokens at D 64 and
    192 (each page its own TMA box at a 128-byte aligned stage offset).
    f32 at D = 192 is held against the plain version in f64."""
    from repro_torch.kernels.paged_attention import ops
    dev = torch.device("cuda")
    pools = ((torch.float32, False, F32_TOL), (torch.bfloat16, False,
                                               BF16_TOL),
             (torch.bfloat16, True, BF16_TOL))
    lens, B, Hkv, P, mp = [140, 17, 1], 3, 2, 16, 9
    for G in (3, 6, 12, 16, 24):
        for D in (64, 128, 192):
            for dtype, int8, tol in pools:
                name = "int8" if int8 else str(dtype).replace("torch.", "")
                args = paged_inputs(torch, gen, B, Hkv, G, D, P, mp, lens,
                                    dtype, dev, int8=int8)
                kw = dict(scale=D ** -0.5, kv_scale=0.05 if int8 else 0.0,
                          pages_per_block=2, num_splits=2)
                check_decode(torch, chk, f"{name} G{G} D{D} Hkv{Hkv}", args,
                             kw, dtype, tol,
                             hold_f64=dtype == torch.float32 and D == 192)
    window = 100
    ring = -(-window // P) + 1
    for D in (128, 192):
        for dtype, int8, tol in pools[:2]:
            name = str(dtype).replace("torch.", "")
            args = paged_inputs(torch, gen, B, Hkv, 6, D, P, ring,
                                [7, 150, 333], dtype, dev, window=window)
            kw = dict(scale=D ** -0.5, window=window, pages_per_block=2,
                      num_splits=2)
            check_decode(torch, chk, f"{name} G6 D{D} ring of {ring} pages "
                         f"window {window}", args, kw, dtype, tol,
                         hold_f64=dtype == torch.float32 and D == 192)
    odd = [1, 6, 7, 8, 50, 100]
    mp7 = -(-max(odd) // 7)
    for D in (64, 192):
        for G in (1, 6):
            ppb, ns = ops.choose_decode_params(mp7, 7, D, None, 2)
            args = paged_inputs(torch, gen, len(odd), Hkv, G, D, 7, mp7, odd,
                                torch.bfloat16, dev, int8=True)
            kw = dict(scale=D ** -0.5, kv_scale=0.05, pages_per_block=ppb,
                      num_splits=ns)
            check_decode(torch, chk, f"int8 G{G} D{D} odd page 7 ppb {ppb} "
                         f"S {ns}", args, kw, torch.bfloat16, BF16_TOL)


def gqa_prefill_cases(torch, chk, gen, D=192, groups=(6, 12), Hkv=2,
                      every_route=False):
    """K3 on both tiles at D = 192 with G 6 and 12, at the engine's
    q_block (21 and 10: R = 126 and 120 rows, a partial row tile on both
    tiles): bf16 ("tc"), f32 ("tf32x3", held against f64) on pages of 16,
    and on odd pages of 12, over pools of q's dtype and int8 pools
    ("tc/int8/odd", "tf32x3/odd", "tf32x3/int8/odd"; f32 held against
    f64).  With ``every_route``, each of the eight routes (either tile, q's
    dtype or int8 pools, pages of 16 or 12) at the given D, groups and kv
    heads."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    cases = ((torch.bfloat16, False, 16, BF16_TOL),
             (torch.float32, False, 16, F32_TOL),
             (torch.bfloat16, True, 12, BF16_TOL),
             (torch.float32, False, 12, F32_TOL),
             (torch.float32, True, 12, F32_TOL))
    if every_route:
        cases = tuple((dt, i8, P, tol) for P in (16, 12) for i8 in (False,
                                                                   True)
                      for dt, tol in ((torch.bfloat16, BF16_TOL),
                                      (torch.float32, F32_TOL)))
    for G in groups:
        for dtype, int8, P, tol in cases:
            mp = -(-160 // P)
            q_start, q_lens = [100, 0, 37], [40, 37, 0]
            _, _, qb = ops.choose_prefill_params(mp, P, D, max(q_lens), G)
            args = chunk_inputs(torch, gen, Hkv, G, D, P, mp, q_start,
                                q_lens, dtype, dev, int8=int8)
            kw = dict(scale=D ** -0.5, softcap=0.0,
                      kv_scale=0.05 if int8 else 0.0, pages_per_block=2,
                      num_splits=2, q_block=qb)
            key = "paged_prefill_" + pa.prefill_route(
                dtype, torch.int8 if int8 else dtype, P)
            name = str(dtype).replace("torch.", "") + (" int8" if int8
                                                       else "")
            tag = f"{name} G{G} D{D} page {P} q_block {qb} (R {qb * G})"
            got = pa.paged_prefill_partials(*args, **kw)
            check_k3(torch, chk, key, tag, args, kw, got, tol,
                     f64=dtype == torch.float32)
            check_prefill_combine(torch, chk, tag, got, args[0].shape[1], qb,
                                  dtype, tol)


def gqa_flex_cases(torch, chk, gen):
    """K4 on both tiles at D = 192 with G 6 and 12: causal & padding and
    window(64) & padding at Q = K = 200 (ragged tiles of 128), against the
    plain version with the kernel's product arithmetic; f32 also against
    f64."""
    from repro_torch.core import flex
    dev = torch.device("cuda")
    B, Hkv, Q, D = 2, 2, 200, 192
    lens = torch.tensor([Q, 131], dtype=torch.int32, device=dev)
    pad = flex.padding_mask(lens)
    for G in (6, 12):
        for mname, mod, window in (
                ("causal&padding", flex.and_masks(flex.causal_mask, pad), 0),
                ("window64&padding",
                 flex.and_masks(flex.sliding_window_mask(64), pad), 64)):
            for dtype, _ in ((torch.float32, F32_TOL),
                             (torch.bfloat16, BF16_TOL)):
                q = torch.randn((B, Hkv * G, Q, D), generator=gen,
                                device=dev).to(dtype)
                k, v = (torch.randn((B, Hkv, Q, D), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))
                tag = f"G{G} D{D} Q=K={Q} {mname}"
                got = check_flex_variant(torch, chk, tag, q, k, v, mod, None,
                                         window=window)
                if dtype == torch.float32:
                    live = flex.materialize(mod, B, 1, Q, Q, device=dev)
                    exact = flex_f64_mask(torch, q, k, v, live, D ** -0.5)
                    chk.versus_f64("flex_prefill_tf32x3", f"float32 {tag}",
                                   got, got, exact, tol=F32_TOL)


def decode_chunk_cost(torch, chk, gen):
    """What K1's grid split costs past 16 heads: the same pools (batch 4,
    8 kv heads, D 128, bf16, a 2048-token table, lens 256..2048) read for
    G 16 (one chunk: one pass over the K/V) and G 32 (two chunks, each
    reading the K/V again), checked and timed (device)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    B, Hkv, D, P, mp = 4, 8, 128, 64, 32
    lens = torch.randint(256, mp * P + 1, (B,), generator=gen,
                         device=dev).tolist()
    args = paged_inputs(torch, gen, B, Hkv, 32, D, P, mp, lens,
                        torch.bfloat16, dev)
    kw = dict(scale=D ** -0.5, pages_per_block=2, num_splits=4)
    rows, times = {}, {}
    for G in (16, 32):
        a = (args[0][:, :, :G].contiguous(),) + args[1:]
        check_decode(torch, chk, f"bfloat16 G{G} D{D} Hkv{Hkv} (chunks "
                     f"{pa.decode_group_plan(G)[2]})", a, kw, torch.bfloat16,
                     BF16_TOL)
        full = dict(window=0, softcap=0.0, kv_scale=0.0, **kw)
        times[G] = device_ms(torch, lambda: pa.paged_attention_partials(
            *a, **full), "paged_decode_kernel", reps=5)
    kv_bytes = 2 * sum(lens) * Hkv * D * 2
    log(f"  paged_decode bfloat16 G 32 in two chunks (each reading the "
        f"{kv_bytes / 1e6:.1f} MB of K/V again) vs G 16 in one: device "
        f"{fmt(times[32])} vs {fmt(times[16])}")
    rows[("paged_decode chunks", "bfloat16")] = dict(
        device_ms_g16=times[16], device_ms_g32=times[32], kv_bytes=kv_bytes)
    return rows


def real_heads_decode(torch, chk, gen, cfg_name, H, Hkv, D):
    """K1 and the decode op at a config's real heads, batch 4, a 2048-token
    table of 64-token pages at the engine's partition, lens 256..2048, in
    f32 (held against f64: G heads of up to 2048 keys each give the f32
    plain version's rounding many chances to reach the tolerance), bf16
    and int8 pools; timed (device) beside its byte bound and SDPA over
    pre-gathered KV (GQA)."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    B, P, mp = 4, 64, 32
    G = H // Hkv
    ppb, ns = ops.choose_decode_params(mp, P, D, None, None)
    lens = torch.randint(256, mp * P + 1, (B,), generator=gen,
                         device=dev).tolist()
    rows = {}
    for dtype, int8, tol in ((torch.float32, False, F32_TOL),
                             (torch.bfloat16, False, BF16_TOL),
                             (torch.bfloat16, True, BF16_TOL)):
        name = "int8" if int8 else str(dtype).replace("torch.", "")
        args = paged_inputs(torch, gen, B, Hkv, G, D, P, mp, lens, dtype,
                            dev, int8=int8)
        q, kp, vp, tables, lens_t = args
        kw = dict(scale=D ** -0.5, kv_scale=0.05 if int8 else 0.0,
                  pages_per_block=ppb, num_splits=ns)
        tag = f"{cfg_name} heads H{H}/{Hkv} D{D} {name}"
        check_decode(torch, chk, f"{tag} lens {lens}", args, kw, dtype, tol,
                     hold_f64=dtype == torch.float32)
        full = dict(window=0, softcap=0.0, **kw)
        dev_ms = device_ms(torch, lambda: pa.paged_attention_partials(
            *args, **full), "paged_decode_kernel", reps=5)
        op_ms = device_ms(torch, lambda: pa.paged_attention_kernel(
            *args, **full), ("paged_decode_kernel", "combine_kernel"), reps=5)
        L = max(lens)
        safe = tables.clamp(min=0).long()

        def gathered(pool):
            x = pool[safe].reshape(B, mp * P, Hkv, D)[:, :L].transpose(1, 2)
            return (x.to(dtype) * 0.05 if int8 else x).contiguous()

        kc, vc = gathered(kp), gathered(vp)
        keep = (torch.arange(L, device=dev)[None, :] < lens_t[:, None]
                ).reshape(B, 1, 1, L)
        qs = q.reshape(B, H, 1, D)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=keep, enable_gqa=True), reps=5)
        live = sum(lens)
        nbytes = (2 * live * Hkv * D * kp.element_size()
                  + q.numel() * q.element_size() + tables.numel() * 4
                  + B * 4 + B * Hkv * ns * G * (D + 2) * 4)
        ops_ = 4 * live * H * D
        peak = PEAK_OPS["float32" if dtype == torch.float32 else "bfloat16"]
        bound = 1e3 * max(nbytes / HBM_BPS, ops_ / peak)
        by = "operations" if ops_ / peak > nbytes / HBM_BPS else "bytes"
        gw, slices, chunks, _ = pa.decode_group_plan(G)
        log(f"  paged_decode {tag}: device {fmt(dev_ms)}, bound "
            f"{bound:.4f} ms ({by}), SDPA over pre-gathered KV (GQA, K1+K2) "
            f"{lib:.4f} ms; G {G} as {chunks} chunk(s) of {slices} "
            f"slice(s) of {gw} heads per warp; ppb {ppb}, {ns} splits; the "
            f"decode op (K1 + K2) device {fmt(op_ms)}")
        rows[(f"paged_decode {cfg_name}", name)] = dict(
            device_ms=dev_ms, bound_ms=bound, bound_by=by, library_ms=lib,
            G=G, D=D, plan=(gw, slices, chunks), op_device_ms=op_ms)
        del args, q, kp, vp, kc, vc
    return rows


def real_heads_prefill(torch, chk, gen, cfg_name, H, Hkv, D, plain=False):
    """K3 at a config's real heads on both tiles and bf16 q over int8
    pools ("tc/int8"): a chunk step of 2
    rows (512 tokens at 0; 300 tokens resuming at 1061) over a 2048-token
    table of 64-token pages, at the engine's q_block; timed (device)
    beside its bound and SDPA with the causal-offset mask over pre-gathered
    KV (GQA).  f32 is held against f64 (un-normalised partials over up to
    1361 keys for G x 812 rows per kv head: the f32 plain version's own
    rounding reaches the tolerance).  With ``plain``, f32 q over int8 pools
    ("tf32x3/int8", held against f64) as well, and each route also timed
    by events beside its plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    P, mp = 64, 32
    G = H // Hkv
    q_start, q_lens = [0, 1061], [512, 300]
    ppb, ns, qb = ops.choose_prefill_params(mp, P, D, 512, G)
    rows = {}
    routes = ((torch.bfloat16, False, BF16_TOL),
              (torch.float32, False, F32_TOL),
              (torch.bfloat16, True, BF16_TOL))
    if plain:
        routes += ((torch.float32, True, F32_TOL),)
    for dtype, int8, tol in routes:
        name = "int8" if int8 else str(dtype).replace("torch.", "")
        if int8 and dtype == torch.float32:
            name = "float32 int8"
        key = "paged_prefill_" + pa.prefill_route(
            dtype, torch.int8 if int8 else dtype, P)
        args = chunk_inputs(torch, gen, Hkv, G, D, P, mp, q_start, q_lens,
                            dtype, dev, int8=int8)
        q, kp, vp, tables, kv_lens, qs = args
        kw = dict(scale=D ** -0.5, softcap=0.0,
                  kv_scale=0.05 if int8 else 0.0, pages_per_block=ppb,
                  num_splits=ns, q_block=qb)
        tag = f"{cfg_name} heads H{H}/{Hkv} D{D} {name} q_block {qb}"
        got = pa.paged_prefill_partials(*args, **kw)
        check_k3(torch, chk, key, tag, args, kw, got, tol,
                 f64=dtype == torch.float32)
        dev_ms = device_ms(torch, lambda: pa.paged_prefill_partials(
            *args, **kw), kernel_name(key), reps=3)
        B, C = q.shape[:2]
        L = int(kv_lens.max())
        safe = tables.clamp(min=0).long()

        def gathered(pool):
            x = pool[safe].reshape(B, -1, Hkv, D)[:, :L].transpose(1, 2)
            return (x.to(dtype) * 0.05 if int8 else x).contiguous()

        kc, vc = gathered(kp), gathered(vp)
        pos = torch.arange(L, device=dev)
        qpos = qs[:, None].long() + torch.arange(C, device=dev)[None]
        mask = ((pos[None, None] < kv_lens[:, None, None])
                & (pos[None, None] <= qpos[:, :, None]))[:, None]
        qt = q.transpose(1, 2).contiguous()
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=mask, enable_gqa=True), reps=5)
        bound, by, _, _, tf32 = k3_bound(torch, q, kp, tables, kv_lens, got,
                                         q_start, q_lens, H, D)
        extra = ("" if tf32 is None else
                 f"; three TF32 products at 495 TFLOP/s: {tf32:.4f} ms")
        log(f"  {key} {tag} (R {qb * G}): device {fmt(dev_ms)}, bound "
            f"{bound:.4f} ms ({by}{extra}), SDPA with the causal-offset "
            f"mask over pre-gathered KV (GQA) {lib:.4f} ms")
        rows[(f"{key} {cfg_name}", name)] = dict(
            device_ms=dev_ms, bound_ms=bound, bound_by=by, library_ms=lib,
            G=G, D=D, q_block=qb)
        if plain:
            r = rows[(f"{key} {cfg_name}", name)]
            r["ms"] = time_ms(torch, lambda: pa.paged_prefill_partials(
                *args, **kw), reps=5)
            r["plain_ms"] = time_ms(
                torch, lambda: pa._paged_prefill_partials_plain(*args, **kw),
                reps=2, warmup=1)
            log(f"  {key} {tag}: kernel {r['ms']:.4f} ms by events, plain "
                f"{r['plain_ms']:.3f} ms")
        del args, q, kp, vp, kc, vc, got, mask
    return rows


def real_heads_flex(torch, chk, gen, cfg_name, H, Hkv, D):
    """K4 at a config's real heads on both tiles: batch 2, Q = K = 1024,
    causal & padding (lens 1024 and 700), 128 x 128 BlockMask tiles; timed
    (device) beside its bound (live pairs) and SDPA with the same boolean
    mask (GQA)."""
    import torch.nn.functional as F
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention import flex_attention as fa
    dev = torch.device("cuda")
    B, Q = 2, 1024
    plens = [Q, 700]
    lens_t = torch.tensor(plens, dtype=torch.int32, device=dev)
    mm = flex.and_masks(flex.causal_mask, flex.padding_mask(lens_t))
    bm = flex.build_block_mask(mm, Q, Q, 128, 128, B=B, device=dev)
    exact = (torch.ones(Q, Q, dtype=torch.bool, device=dev).tril()[None]
             & (torch.arange(Q, device=dev)[None, None, :]
                < lens_t[:, None, None]))[:, None]
    rows = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        name = str(dtype).replace("torch.", "")
        key = "flex_prefill_" + fa.flex_route(dtype)
        q = torch.randn((B, H, Q, D), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, Hkv, Q, D), generator=gen, device=dev
                            ).to(dtype) for _ in range(2))
        kw = dict(scale=D ** -0.5, mask_mod=mm, q_len=Q, kv_len=Q)
        got = fa.flex_attention_kernel(q, k, v, bm, **kw)
        f32 = dtype == torch.float32
        want = fa._flex_attention_plain(
            q, k, v, bm, p_terms=None if f32 else 1,
            tf32_terms=3 if f32 else None, **kw)
        tag = f"{cfg_name} heads H{H}/{Hkv} D{D} {name} Q=K={Q}"
        chk.close(key, f"{tag} causal&padding", got, want, tol)
        del want
        dev_ms = device_ms(torch, lambda: fa.flex_attention_kernel(
            q, k, v, bm, **kw), kernel_name(key), reps=3)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=exact, enable_gqa=True), reps=5)
        pairs = sum(min(qq + 1, L) for L in plens for qq in range(Q))
        ops_ = 4 * D * H * pairs
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        bound = 1e3 * max(nbytes / HBM_BPS, ops_ / PEAK_OPS[name])
        extra = (f"; three TF32 products at 495 TFLOP/s: "
                 f"{1e3 * 3 * ops_ / TF32_OPS:.4f} ms" if f32 else "")
        log(f"  {key} {tag}: device {fmt(dev_ms)}, bound {bound:.4f} ms "
            f"(operations{extra}), "
            f"{1e9 * dev_ms / pairs / H if dev_ms else 0:.3f} ps per live "
            f"pair and head; SDPA with the causal & padding "
            f"mask (GQA) {lib:.4f} ms")
        rows[(f"{key} {cfg_name}", name)] = dict(
            device_ms=dev_ms, bound_ms=bound, bound_by="operations",
            library_ms=lib, G=H // Hkv, D=D, live_pairs=pairs)
        del q, k, v, got
    del exact
    return rows


RG_HEADS = ("recurrentgemma-9b", 16, 1, 256)  # name, H, Hkv, D


def head_dim_256_phase(torch, chk, gen):
    """K1, K2, K3 and K4 at head dim 256: recurrentgemma-9b's attention
    layers (16 query heads over one kv head: G 16).  K1 and the decode op
    on ring tables past the window, at the engine's batch, in f32, bf16
    and int8; K3 on each of its eight routes at G 1 and 16, then timed at
    the real heads on four; K4 under window 2048 & padding on both tiles,
    and two other mod families.  Each timed case gives its device ms, its
    bound and SDPA (``enable_gqa``).  The errors are kept apart, as the
    kernels' D-256 instances (``<kernel>/d256``).  Returns the timed
    rows."""
    sub = Checker(torch)
    name, H, Hkv, D = RG_HEADS
    log(f"head dim 256 ({name}'s heads: H {H} over Hkv {Hkv}, G "
        f"{H // Hkv}):")
    rows = d256_decode(torch, sub, gen)
    gqa_prefill_cases(torch, sub, gen, D=D, groups=(1, 16), Hkv=Hkv,
                      every_route=True)
    for (key, dtype), row in real_heads_prefill(
            torch, sub, gen, name, H, Hkv, D, plain=True).items():
        # "paged_prefill_tc/int8 recurrentgemma-9b", "float32 int8" ->
        # "paged_prefill_tc/int8/d256", "int8"
        rows[(key.replace(f" {name}", "/d256"), dtype.split()[-1])] = row
    rows.update(d256_flex(torch, sub, gen))
    for kernel, err in sub.max_err.items():
        chk.max_err[kernel + "/d256"] = err
    return rows


def d256_decode(torch, chk, gen):
    """K1, K2 and the decode op as recurrentgemma-9b's 'W' layers decode:
    batch 8, 16 heads over one kv head, D 256, window 2048 on a ring of 33
    pages of 64, lens 2200..3000 (every ring has wrapped), at the engine's
    partition; f32 (held against f64), bf16 and int8 pools (bf16 q); each
    timed (events and device) beside its plain version, its byte bound and
    SDPA over the ring's slots with the live-slot mask (GQA)."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    _, H, Hkv, D = RG_HEADS
    B, P, window = 8, 64, 2048
    G = H // Hkv
    ring = -(-window // P) + 1
    ppb, ns = ops.choose_decode_params(ring, P, D, None, None)
    lens = torch.randint(2200, 3001, (B,), generator=gen,
                         device=dev).tolist()
    rows = {}
    for dtype, int8, tol in ((torch.float32, False, F32_TOL),
                             (torch.bfloat16, False, BF16_TOL),
                             (torch.bfloat16, True, BF16_TOL)):
        name = "int8" if int8 else str(dtype).replace("torch.", "")
        args = paged_inputs(torch, gen, B, Hkv, G, D, P, ring, lens, dtype,
                            dev, int8=int8, window=window)
        q, kp, vp, tables, lens_t = args
        kw = dict(scale=D ** -0.5, window=window,
                  kv_scale=0.05 if int8 else 0.0, pages_per_block=ppb,
                  num_splits=ns)
        tag = f"G{G} D{D} {name} ring of {ring} pages, window {window}"
        check_decode(torch, chk, f"{tag} lens {lens}", args, kw, dtype, tol,
                     hold_f64=dtype == torch.float32)
        full = dict(softcap=0.0, **kw)
        got = pa.paged_attention_partials(*args, **full)
        k1 = dict(
            ms=time_ms(torch, lambda: pa.paged_attention_partials(
                *args, **full)),
            device_ms=device_ms(torch, lambda: pa.paged_attention_partials(
                *args, **full), "paged_decode_kernel", reps=5),
            plain_ms=time_ms(torch, lambda: pa._paged_attention_partials_plain(
                *args, **full), reps=3))
        k2 = dict(
            ms=time_ms(torch, lambda: pa.combine_partials_kernel(
                *got, dtype=dtype)),
            device_ms=device_ms(torch, lambda: pa.combine_partials_kernel(
                *got, dtype=dtype), "combine_kernel", reps=5),
            plain_ms=time_ms(torch, lambda: pa._combine_partials_plain(
                *got, dtype=dtype)))
        # the decode op: K1 and K2 from one call
        op_dev = device_ms(torch, lambda: pa.paged_attention_kernel(
            *args, **full), ("paged_decode_kernel", "combine_kernel"), reps=5)
        n_slots = ring * P
        kc, vc = ((pool[tables.long()].reshape(B, n_slots, Hkv, D)
                   .transpose(1, 2).to(dtype) * (0.05 if int8 else 1.0))
                  .contiguous() for pool in (kp, vp))
        keep = pa._token_live(lens_t, n_slots, P, window).reshape(
            B, 1, 1, n_slots)
        qs = q.reshape(B, H, 1, D)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=keep, enable_gqa=True))
        live = sum(min(L, window) for L in lens)
        item = q.element_size()
        partials = sum(t.numel() * 4 for t in got)
        nbytes = (2 * live * Hkv * D * kp.element_size() + q.numel() * item
                  + tables.numel() * 4 + B * 4 + partials)
        ops_ = 4 * live * H * D
        peak = PEAK_OPS["float32" if dtype == torch.float32 else "bfloat16"]
        k1.update(bound_ms=1e3 * max(nbytes / HBM_BPS, ops_ / peak),
                  bound_by=("operations" if ops_ / peak > nbytes / HBM_BPS
                            else "bytes"), library_ms=lib)
        k2.update(bound_ms=1e3 * (partials + B * H * D * item) / HBM_BPS,
                  bound_by="bytes", library_ms=None)
        gw, slices, chunks, _ = pa.decode_group_plan(G)
        log(f"  paged_decode {tag}: kernel {k1['ms']:.4f} ms (device "
            f"{fmt(k1['device_ms'])}), plain {k1['plain_ms']:.3f} ms, "
            f"bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}), SDPA over "
            f"the ring's slots with the live mask (GQA, K1+K2) {lib:.4f} "
            f"ms; G {G} as {chunks} chunk(s) of {slices} slice(s) of {gw} "
            f"heads per warp; ppb {ppb}, {ns} splits")
        log(f"  combine      {tag} (G x D = {G * D}): kernel {k2['ms']:.4f} "
            f"ms (device {fmt(k2['device_ms'])}), plain "
            f"{k2['plain_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms "
            f"(bytes)")
        log(f"  decode_op    {tag}: device K1 + K2 {fmt(op_dev)}")
        k1["op_device_ms"] = op_dev
        rows[("paged_decode/d256", name)] = k1
        rows[("combine/d256", name)] = k2
        del args, q, kp, vp, kc, vc, got
    return rows


def d256_flex(torch, chk, gen):
    """K4 as recurrentgemma-9b's 'W' layers prefill: batch 2, 16 heads over
    one kv head, D 256, Q = K = 3072 under window 2048 & padding (lens 3072
    and 2600; the analytic windowed BlockMask, as the engine builds it), on
    both tiles against the plain version with the kernel's product
    arithmetic (f32 also against f64 on the live rows), timed (events and
    device) beside the plain version, the bound of its live pairs and SDPA
    with the same boolean mask (GQA); then causal & document and causal +
    softcap at Q = K = 1100 on both tiles."""
    import torch.nn.functional as F
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention import flex_attention as fa
    dev = torch.device("cuda")
    _, H, Hkv, D = RG_HEADS
    B, Q, window = 2, 3072, 2048
    lens_t = torch.tensor([Q, 2600], dtype=torch.int32, device=dev)
    mod = flex.and_masks(flex.sliding_window_mask(window),
                         flex.padding_mask(lens_t))
    bm = op_block_mask(torch, mod, Q, Q, 128, 128, B, window)
    live = flex.materialize(mod, B, 1, Q, Q, device=dev).expand(B, 1, Q, Q)
    keep = (torch.arange(Q, device=dev)[None, None, :, None]
            < lens_t[:, None, None, None])
    pairs = int(live.sum()) * H
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        route = fa.flex_route(dtype)
        q = torch.randn((B, H, Q, D), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, Hkv, Q, D), generator=gen, device=dev
                            ).to(dtype) for _ in range(2))
        tag = f"G{H // Hkv} D{D} Q=K={Q} window{window}&padding"
        got = check_flex_variant(torch, chk, tag, q, k, v, mod, None,
                                 window=window)
        kw = dict(scale=D ** -0.5, mask_mod=mod, q_len=Q, kv_len=Q)
        if dtype == torch.float32:
            # rows past each padding length differ by design (the windowed
            # BlockMask's full tiles skip the padding mask)
            plain = fa._flex_attention_plain(q, k, v, bm, **kw)
            exact = flex_f64_mask(torch, q, k, v, live, D ** -0.5)
            chk.versus_f64(f"flex_prefill_{route}", f"{name} {tag}, live "
                           f"rows", got * keep, plain * keep, exact * keep)
            del plain, exact
        row = dict(
            ms=time_ms(torch, lambda: fa.flex_attention_kernel(
                q, k, v, bm, **kw), reps=5),
            device_ms=device_ms(torch, lambda: fa.flex_attention_kernel(
                q, k, v, bm, **kw), KERNEL_NAMES["flex_prefill_" + route],
                reps=3),
            plain_ms=time_ms(torch, lambda: fa._flex_attention_plain(
                q, k, v, bm, **kw), reps=2, warmup=1),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=live, enable_gqa=True), reps=3, warmup=1))
        ops_ = 4 * D * pairs
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        row.update(bound_ms=1e3 * max(nbytes / HBM_BPS, ops_ / PEAK_OPS[name]),
                   bound_by="operations", live_pairs=pairs)
        extra = ""
        if dtype == torch.float32:
            row["bound_tf32x3_ms"] = 1e3 * 3 * ops_ / TF32_OPS
            extra = f"; three TF32 products {row['bound_tf32x3_ms']:.4f} ms"
        log(f"  flex_prefill_{route} {name} {tag}: kernel {row['ms']:.4f} ms "
            f"(device {fmt(row['device_ms'])}), plain {row['plain_ms']:.3f} "
            f"ms, bound {row['bound_ms']:.4f} ms (operations, {pairs:.4e} "
            f"live pairs{extra}), SDPA with the boolean mask (GQA) "
            f"{row['library_ms']:.4f} ms")
        rows[(f"flex_prefill_{route}/d256", name)] = row
        del q, k, v, got
    del live, keep
    Q2 = 1100
    docs = (torch.arange(Q2, device=dev) // 300).int()[None].repeat(
        B, 1).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((B, H, Q2, D), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, Hkv, Q2, D), generator=gen, device=dev
                            ).to(dtype) for _ in range(2))
        for tag, mm, score in (
                ("causal&document", flex.and_masks(
                    flex.causal_mask, flex.document_mask(docs)), None),
                ("causal+softcap 30", flex.causal_mask,
                 flex.softcap_score(30.0))):
            check_flex_variant(torch, chk, f"G{H // Hkv} D{D} Q=K={Q2} {tag}",
                               q, k, v, mm, score)
    return rows


class Int8Tape:
    """Teacher-forces an int8 KV cache between two passes of a model, as
    the token inputs are: the first pass records the int8 K/V that
    ``models.attention.kv_quant`` writes, the second writes that record in
    place of its own, call by call, and counts the elements where its own
    rounding differed.  Two paths whose activations differ by rounding
    alone (1e-6 in f32) still round some K/V values to the other int8
    step (0.05 apart), and a flip can move the logits by more than the
    kernels' own error.  With the tape both passes attend over the same
    cache, and the comparison sees the attention arithmetic."""

    def __init__(self, torch):
        self.torch, self.tape = torch, []
        self.differ = self.total = 0

    @contextlib.contextmanager
    def pass_(self, replay):
        from repro_torch.models import attention
        orig, calls = attention.kv_quant, iter(range(len(self.tape)))

        def quant(cfg, x):
            q = orig(cfg, x)
            if q.dtype != self.torch.int8:
                return q
            if not replay:
                self.tape.append(q.clone())
                return q
            want = self.tape[next(calls)]
            if want.shape != q.shape:
                fail(f"int8 tape: {tuple(q.shape)} written where "
                     f"{tuple(want.shape)} was recorded")
            self.differ += int((want != q).sum())
            self.total += q.numel()
            return want

        attention.kv_quant = quant
        try:
            yield
        finally:
            attention.kv_quant = orig

    def report(self):
        return (f"{self.differ} of {self.total} int8 K/V values of the "
                f"second pass rounded to another step than the first's")


def chunked_logits(torch, model, params, tokens, lens_t, tables, pool,
                   impl, pool_dtype):
    """The last prompt token's logits of every row, prefilled by
    ``prefill_chunk`` in chunks of 96 tokens from pools of ``pool_dtype``
    (zeros) and ``tables``."""
    dev = tokens.device
    S = tokens.shape[1]
    st = {"tables": tables,
          "k_pages": torch.zeros(pool, dtype=pool_dtype, device=dev),
          "v_pages": torch.zeros(pool, dtype=pool_dtype, device=dev)}
    last = None
    start = torch.zeros_like(lens_t)
    while bool((start < lens_t).any()):
        ql = torch.clamp(torch.clamp(lens_t - start, max=96), min=0)
        C = int(ql.max())
        idx = (start[:, None] + torch.arange(C, device=dev)[None]).long()
        chunk = torch.gather(tokens, 1, idx.clamp(max=S - 1))
        logits, _ = model.prefill_chunk(params, chunk, st, start, ql,
                                        impl=impl)
        if last is None:
            last = torch.zeros_like(logits)
        ends = (start + ql == lens_t) & (ql > 0)
        last[ends] = logits[ends]
        start = start + ql
    return last


def model_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request

    dev = torch.device("cuda")
    cfg = get_config("llama2-7b").replace(n_layers=4)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init_params(gen, torch.float32, dev)
    lens = [100, 257, 384, 512]
    B, P, pps = len(lens), cfg.page_size, 16
    S = max(lens)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    num_pages = B * pps + 4
    perm = torch.randperm(num_pages, generator=gen, device=dev).int()
    tables = perm[:B * pps].reshape(B, 1, pps).contiguous()
    pool = (cfg.n_layers, num_pages, P, cfg.n_kv_heads, cfg.resolved_head_dim)
    worst = 0.0
    outs = {}
    for impl in ("kernel", "ref"):
        st = {"pos": lens_t, "tables": tables,
              "k_pages": torch.zeros(pool, device=dev),
              "v_pages": torch.zeros(pool, device=dev)}
        logits, st = model.prefill(params, tokens, st, lens=lens_t,
                                   impl=impl)
        seq = [logits]
        nxt = logits.argmax(-1)
        for _ in range(3):
            logits, st = model.decode_step(params, nxt, st, impl=impl)
            seq.append(logits)
            nxt = logits.argmax(-1)
        outs[impl] = torch.stack(seq)
    torch.cuda.synchronize()
    got, want = outs["kernel"], outs["ref"]
    if not bool(torch.isfinite(got).all()):
        fail("model phase: non-finite logits")
    worst = float((got - want).abs().max())
    log(f"model phase (llama2-7b widths, 4 layers, f32): prefill + 3 decode "
        f"logits, kernel path vs plain path max|err| {worst:.3e} "
        f"(tol {MODEL_TOL:g}, |logit| max {float(want.abs().max()):.3f})")
    if worst > MODEL_TOL:
        fail(f"model phase: max|err| {worst} beyond {MODEL_TOL}")

    # chunked prefill in chunks of 96 (not a multiple of the page): K3
    # against the monolithic prefill through K4, and against the plain path
    chunked = {impl: chunked_logits(torch, model, params, tokens, lens_t,
                                    tables, pool, impl, torch.float32)
               for impl in ("kernel", "ref")}
    torch.cuda.synchronize()
    mono = outs["kernel"][0]
    err_mono = float((chunked["kernel"] - mono).abs().max())
    err_plain = float((chunked["kernel"] - chunked["ref"]).abs().max())
    log(f"model phase: chunked prefill (chunks of 96, K3) vs monolithic "
        f"(K4) max|err| {err_mono:.3e}, vs the plain chunked path "
        f"{err_plain:.3e} (tol {MODEL_TOL:g})")
    if not bool(torch.isfinite(chunked["kernel"]).all()):
        fail("model phase: non-finite chunked logits")
    if max(err_mono, err_plain) > MODEL_TOL:
        fail(f"model phase: chunked logits beyond {MODEL_TOL}")

    # the same chunks over int8 pools (kv_dtype "int8"): K3's int8 variant
    # of the split-TF32 tile against the plain path
    from repro_torch import kernels
    # (the plain path writes the kernel path's int8 K/V: Int8Tape)
    model8 = build_model(cfg.replace(kv_dtype="int8"))
    int8, tape = {}, Int8Tape(torch)
    for impl in ("kernel", "ref"):
        kernels.reset_launch_counts()
        with tape.pass_(replay=impl == "ref"):
            int8[impl] = chunked_logits(torch, model8, params, tokens,
                                        lens_t, tables, pool, impl,
                                        torch.int8)
        torch.cuda.synchronize()
        if impl == "kernel":
            int8_counts = kernels.launch_counts()
    err8 = float((int8["kernel"] - int8["ref"]).abs().max())
    log(f"model phase: chunked prefill (chunks of 96) over int8 pools, K3 "
        f"tf32x3/int8 vs the plain path max|err| {err8:.3e} (tol "
        f"{MODEL_TOL:g}, |logit| max {float(int8['ref'].abs().max()):.3f}; "
        f"{tape.report()}); launches {int8_counts}")
    if not bool(torch.isfinite(int8["kernel"]).all()):
        fail("model phase: non-finite chunked logits over int8 pools")
    if err8 > MODEL_TOL:
        fail(f"model phase: chunked logits over int8 pools beyond "
             f"{MODEL_TOL}")
    if int8_counts["paged_prefill/tf32x3/int8"] <= 0 or any(
            int8_counts[k] for k in k3_routes_except("tf32x3/int8")):
        fail(f"model phase: the int8 chunks did not run on K3's "
             f"tf32x3/int8 variant alone ({int8_counts})")
    del params, outs, chunked, int8
    model_stats = {"int8_chunked_logits_max_err": err8,
                   "int8_chunked_launches": int8_counts}
    # greedy tokens on a smoke-size engine: the kernel path, monolithic
    # and chunked, with and without the prefix cache, against the plain
    # path run monolithic without the cache.  Prompts share a 40-token
    # head (5 pages), so admissions after the first hit the cache.
    scfg = get_config("llama2-7b").smoke()
    rng = torch.Generator().manual_seed(SEED)
    head = torch.randint(0, scfg.vocab_size, (40,), generator=rng).tolist()
    prompts = [head + torch.randint(0, scfg.vocab_size, (int(n),),
                                    generator=rng).tolist()
               for n in torch.randint(1, 60, (6,), generator=rng)]
    runs = {"plain": dict(impl="ref"), "kernel": {},
            "kernel chunked 24 + prefix cache": dict(prefill_chunk=24,
                                                     prefix_cache=True),
            "kernel + prefix cache": dict(prefix_cache=True)}
    toks, hits = {}, {}
    for run, kw in runs.items():
        eng = Engine(scfg, max_slots=4, max_seq_len=128, pool_tokens=320,
                     seed=SEED, num_splits=2, pages_per_block=2, **kw)
        reqs = [Request(prompt=list(p), max_new_tokens=8) for p in prompts]
        eng.generate(reqs[:1])  # a cold first wave seeds the cache
        eng.generate(reqs[1:])
        toks[run] = [r.output for r in reqs]
        hits[run] = eng.memory_report()["prefix_hit_tokens"]
    for run in runs:
        if toks[run] != toks["plain"]:
            fail(f"smoke engine: {run} tokens {toks[run]} != plain "
                 f"{toks['plain']}")
    if not all(hits[run] > 0 for run in runs if "cache" in run):
        fail(f"smoke engine: the prefix cache never hit ({hits})")
    log(f"smoke engine: greedy tokens equal on every path "
        f"({sum(len(t) for t in toks['plain'])} tokens each; prefix hit "
        f"tokens {hits})")
    return model_stats


PREFILL_KERNELS = ("paged_prefill", "flex_prefill")


def drive(torch, eng, reqs, on_step=None, extras=None):
    """Add ``reqs`` (with ``extras``, one per request, when given) and step
    the engine until they are done, calling ``on_step()`` after each step.
    Returns the wall seconds and the wall ms of each step, split into
    steps that prefilled (launched a prefill kernel, K3 or K4, or advanced
    a request's prefill: the 'W' layers' chunks run no kernel) and the
    others (decode)."""
    from repro_torch import kernels
    for r, e in zip(reqs, extras or [None] * len(reqs)):
        eng.add_request(r, e)
    prefill_ms, decode_ms = [], []
    t0 = time.perf_counter()
    for _ in range(10_000):
        if all(r.done for r in reqs):
            break
        before = kernels.launch_counts()
        filled = [r.prefill_pos for r in reqs]
        s0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - s0)
        after = kernels.launch_counts()
        prefilled = (any(after[k] > before[k] for k in PREFILL_KERNELS)
                     or filled != [r.prefill_pos for r in reqs])
        (prefill_ms if prefilled else decode_ms).append(dt)
        if on_step is not None:
            on_step()
    return time.perf_counter() - t0, prefill_ms, decode_ms


def check_path(phase, eng, reqs, new, counts, must, never):
    """Fail unless every request finished with ``new`` tokens, no request
    failed, every kernel in ``must`` launched and none in ``never``.  K2's
    layouts follow from the phase's kernels: a phase that decodes (K1)
    launches ``combine/decode``; a phase that runs K3 launches
    ``combine/prefill``, any other never."""
    from repro_torch.serving import Status
    if "paged_decode" in must:
        must = (*must, "combine/decode")
    if any(k.startswith("paged_prefill") for k in must):
        must = (*must, "combine/prefill")
    else:
        never = (*never, "combine/prefill")
    bad = [r.rid for r in reqs
           if r.status is not Status.FINISHED or len(r.output) != new]
    if bad:
        fail(f"{phase}: requests {bad} did not finish with {new} tokens "
             f"(failed: {[str(r.error) for r in reqs if r.error]})")
    if eng.scheduler.failed:
        fail(f"{phase}: the numerics guard failed a request (non-finite "
             "logits)")
    missing = [k for k in must if counts.get(k, 0) <= 0]
    if missing:
        fail(f"{phase}: kernels never launched on its path: {missing}")
    stray = [k for k in never if counts.get(k, 0) > 0]
    if stray:
        fail(f"{phase}: kernels launched off its path: {stray} ({counts})")


def log_profile(name, prof):
    log(f"profile {name}: wall {prof['wall_ms']:.2f} ms/step, device busy "
        f"{fmt(prof['device_ms'])} ({prof['busy_share']}); device ms/step "
        f"by kind {prof['by_kind']}")


def engine_phase(torch):
    """Monolithic prefill (K4) and decode (K1, K2) at full width.  Returns
    the stats and the weights, which the chunked phase reuses."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, Request

    cfg = get_config("llama2-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, max_slots=8, max_seq_len=2048, dtype=torch.bfloat16,
                 seed=SEED)
    torch.cuda.synchronize()
    log(f"engine phase: llama2-7b, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, bf16, 8 slots, max_seq_len 2048, pool "
        f"{eng.num_pages} pages of {cfg.page_size}; weights and pools "
        f"ready in {time.perf_counter() - t0:.1f} s")
    rng = torch.Generator().manual_seed(SEED)
    n_req, new = 12, 32
    plens = torch.randint(256, 1537, (n_req,), generator=rng).tolist()
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=new) for n in plens]

    kernels.reset_launch_counts()
    wall, prefill_ms, decode_ms = drive(torch, eng, reqs)
    counts = kernels.launch_counts()
    check_path("engine", eng, reqs, new, counts,
               must=("paged_decode", "combine", "flex_prefill",
                     "flex_prefill/tc"),
               never=("paged_prefill", "flex_prefill/tf32x3"))
    ttft = sorted(r.metrics["ttft_s"] for r in reqs)
    new_tokens = sum(len(r.output) for r in reqs)
    stats = dict(
        requests=n_req, prompt_lens=plens, new_tokens=new_tokens,
        wall_s=wall, tok_s=new_tokens / wall,
        ttft_s_p50=ttft[len(ttft) // 2], ttft_s_max=ttft[-1],
        decode_ms_per_step_median=statistics.median(decode_ms),
        decode_steps=len(decode_ms), prefill_steps=len(prefill_ms),
        prefill_ms_per_step=prefill_ms,
        preempted=eng.scheduler.preempted,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts)
    log(f"engine: {new_tokens} tokens in {wall:.2f} s = "
        f"{stats['tok_s']:.1f} tok/s; TTFT p50 {stats['ttft_s_p50']:.3f} s "
        f"max {stats['ttft_s_max']:.3f} s; decode "
        f"{stats['decode_ms_per_step_median']:.2f} ms/step (median of "
        f"{len(decode_ms)}), prefill steps {[round(x) for x in prefill_ms]} "
        f"ms; preemptions {eng.scheduler.preempted}; "
        f"max_memory_allocated {stats['max_memory_allocated_gb']:.2f} GB; "
        f"launches {counts}")

    # where the time goes: a profiled follow-up wave (after the launch
    # counts were read): the step admitting 8 prompts of 1024 tokens
    # (their prefill plus their first decode), then 3 decode steps
    for _ in range(8):
        eng.add_request(Request(prompt=torch.randint(
            0, cfg.vocab_size, (1024,), generator=rng).tolist(),
            max_new_tokens=8))
    stats["profile_prefill_step"] = profile_steps(torch, eng, 1)
    stats["profile_decode_step"] = profile_steps(torch, eng, 3)
    for name in ("prefill_step", "decode_step"):
        log_profile(name, stats["profile_" + name])
    check_attributed("prefill_step", stats["profile_prefill_step"],
                     "K4 flex_prefill")
    return stats, eng.params


def chunked_phase(torch, params):
    """Chunked prefill (K3) with the global prefix cache, then decode (K1,
    K2), at full width: long prompts that share a 1024-token head, the
    system prompt of a deployment.  Wave A (4 requests) caches the head;
    wave B (8 requests, after A finishes) attaches to it and prefills only
    its own tails."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, Request

    cfg = get_config("llama2-7b")
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_slots=8, max_seq_len=2048,
                 dtype=torch.bfloat16, seed=SEED, prefill_chunk=512,
                 prefix_cache=True)
    rng = torch.Generator().manual_seed(SEED + 1)
    head_len, new = 1024, 32
    head = torch.randint(0, cfg.vocab_size, (head_len,), generator=rng)

    def wave(n):
        tails = torch.randint(128, 513, (n,), generator=rng).tolist()
        return [Request(prompt=head.tolist() + torch.randint(
            0, cfg.vocab_size, (t,), generator=rng).tolist(),
            max_new_tokens=new) for t in tails]

    log(f"chunked phase: llama2-7b, bf16, 8 slots, max_seq_len 2048, "
        f"prefill_chunk 512, prefix cache on; prompts = a shared "
        f"{head_len}-token head + a 128..512-token tail, {new} new tokens")
    kernels.reset_launch_counts()
    waves, all_reqs = {}, []
    for name, n in (("A", 4), ("B", 8)):
        reqs = wave(n)
        hits0 = eng.prefix_cache.hit_tokens
        wall, chunk_ms, decode_ms = drive(torch, eng, reqs)
        all_reqs += reqs
        ttft = sorted(r.metrics["ttft_s"] for r in reqs)
        new_tokens = sum(len(r.output) for r in reqs)
        waves[name] = dict(
            requests=n, prompt_lens=[r.prompt_len for r in reqs],
            new_tokens=new_tokens, wall_s=wall, tok_s=new_tokens / wall,
            ttft_s_p50=ttft[len(ttft) // 2], ttft_s_max=ttft[-1],
            prefix_hit_tokens=eng.prefix_cache.hit_tokens - hits0,
            chunk_steps=len(chunk_ms), chunk_ms_per_step=chunk_ms,
            chunk_ms_median=statistics.median(chunk_ms),
            decode_steps=len(decode_ms),
            decode_ms_median=statistics.median(decode_ms))
        w = waves[name]
        log(f"chunked wave {name}: {new_tokens} tokens in {wall:.2f} s = "
            f"{w['tok_s']:.1f} tok/s; TTFT p50 {w['ttft_s_p50']:.3f} s max "
            f"{w['ttft_s_max']:.3f} s; chunk steps {len(chunk_ms)} (median "
            f"{w['chunk_ms_median']:.1f} ms: "
            f"{[round(x) for x in chunk_ms]}), decode steps "
            f"{len(decode_ms)} (median {w['decode_ms_median']:.2f} ms); "
            f"prefix hit tokens {w['prefix_hit_tokens']}")
    counts = kernels.launch_counts()
    check_path("chunked", eng, all_reqs, new, counts,
               must=("paged_decode", "combine", "paged_prefill",
                     "paged_prefill/tc"),
               never=("flex_prefill", *k3_routes_except("tc")))
    if waves["B"]["prefix_hit_tokens"] < 8 * head_len:
        fail(f"chunked: wave B hit {waves['B']['prefix_hit_tokens']} "
             f"cached tokens, fewer than 8 x {head_len}")
    mem = eng.memory_report()
    stats = dict(waves=waves, launches=counts,
                 outputs=[r.output for r in all_reqs],
                 preempted=eng.scheduler.preempted,
                 prefill_stalls=eng.scheduler.prefill_stalls,
                 memory_report=mem,
                 max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                 / 1e9)
    log(f"chunked: launches {counts}; preemptions {stats['preempted']}, "
        f"prefill stalls {stats['prefill_stalls']}; prefix cache: "
        f"{mem['cached_pages']:.0f} cached pages "
        f"({mem['reclaimable_pages']:.0f} reclaimable), "
        f"{mem['prefix_hit_tokens']:.0f} hit tokens; max_memory_allocated "
        f"{stats['max_memory_allocated_gb']:.2f} GB")

    # where the time goes: one profiled chunk step (after the launch
    # counts were read) of 4 fresh requests on the cached head
    for r in wave(4):
        eng.add_request(r)
    stats["profile_chunk_step"] = profile_steps(torch, eng, 1)
    log_profile("chunk_step", stats["profile_chunk_step"])
    check_attributed("chunk_step", stats["profile_chunk_step"],
                     "K3 paged_prefill")
    check_attributed("chunk_step", stats["profile_chunk_step"],
                     "K2 combine")
    return stats


def int8_engine_phase(torch, params, bf16):
    """The chunked phase's model, weights and traffic with an int8 KV cache
    (``kv_dtype="int8"``, the repo's KV-memory knob): llama2-7b at full
    width and depth in bf16, 8 slots, max_seq_len 2048, the same 256-page
    pool at half the bytes, ``prefill_chunk=512, prefix_cache=True``, a
    wave of 4 then a wave of 8 on a shared 1024-token head (the same
    prompts).  K3's int8 variant of the bf16 tile, K1 and K2 must launch,
    K4 and K3's other variants never; every request finishes, the second
    wave hits at least 8 x 1024 cached tokens, and ``pool_bytes`` is half
    the bf16 phase's.  Then one 1536-token prompt's chunked prefill and
    two decode steps' logits through the kernels against the plain path
    on int8 pools, run on the same weights in f32 (the bf16 plain path's
    own rounding over 32 layers exceeds the tolerance), with the int8 K/V
    teacher-forced (``Int8Tape``), within ``BF16_MODEL_TOL`` of the
    logits' scale.  The
    share of greedy tokens equal to the bf16 phase's is printed, not
    checked: quantising the cache changes tokens."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request
    from repro_torch.utils.tree import tree_map

    cfg = get_config("llama2-7b").replace(kv_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_slots=8, max_seq_len=2048,
                 dtype=torch.bfloat16, seed=SEED, prefill_chunk=512,
                 prefix_cache=True)
    if eng.state["k_pages"].dtype != torch.int8:
        fail(f"int8 engine: pools of {eng.state['k_pages'].dtype}")
    rng = torch.Generator().manual_seed(SEED + 1)  # the chunked phase's
    head_len, new = 1024, 32
    head = torch.randint(0, cfg.vocab_size, (head_len,), generator=rng)

    def wave(n):
        tails = torch.randint(128, 513, (n,), generator=rng).tolist()
        return [Request(prompt=head.tolist() + torch.randint(
            0, cfg.vocab_size, (t,), generator=rng).tolist(),
            max_new_tokens=new) for t in tails]

    log(f"int8 engine phase: llama2-7b, bf16 weights, kv_dtype int8 "
        f"(kv_scale {cfg.kv_scale}), 8 slots, max_seq_len 2048, pool "
        f"{eng.num_pages} pages of {cfg.page_size}, prefill_chunk 512, "
        f"prefix cache on; the chunked phase's prompts")
    kernels.reset_launch_counts()
    waves, all_reqs = {}, []
    for name, n in (("A", 4), ("B", 8)):
        reqs = wave(n)
        hits0 = eng.prefix_cache.hit_tokens
        wall, chunk_ms, decode_ms = drive(torch, eng, reqs)
        all_reqs += reqs
        ttft = sorted(r.metrics["ttft_s"] for r in reqs)
        new_tokens = sum(len(r.output) for r in reqs)
        waves[name] = dict(
            requests=n, new_tokens=new_tokens, wall_s=wall,
            tok_s=new_tokens / wall, ttft_s_p50=ttft[len(ttft) // 2],
            ttft_s_max=ttft[-1],
            prefix_hit_tokens=eng.prefix_cache.hit_tokens - hits0,
            chunk_ms_per_step=chunk_ms,
            chunk_ms_median=statistics.median(chunk_ms),
            decode_ms_median=statistics.median(decode_ms))
        w, b = waves[name], bf16["waves"][name]
        log(f"int8 wave {name} (bf16 pools' wave beside it): "
            f"{new_tokens} tokens in {wall:.2f} s = {w['tok_s']:.1f} tok/s "
            f"({b['tok_s']:.1f}); TTFT p50 {w['ttft_s_p50']:.3f} s "
            f"({b['ttft_s_p50']:.3f}); chunk steps median "
            f"{w['chunk_ms_median']:.1f} ms ({b['chunk_ms_median']:.1f}): "
            f"{[round(x) for x in chunk_ms]}; decode median "
            f"{w['decode_ms_median']:.2f} ms/step "
            f"({b['decode_ms_median']:.2f}); prefix hit tokens "
            f"{w['prefix_hit_tokens']}")
    counts = kernels.launch_counts()
    check_path("int8 engine", eng, all_reqs, new, counts,
               must=("paged_decode", "combine", "paged_prefill",
                     "paged_prefill/tc/int8"),
               never=("flex_prefill", *k3_routes_except("tc/int8")))
    if waves["B"]["prefix_hit_tokens"] < 8 * head_len:
        fail(f"int8 engine: wave B hit {waves['B']['prefix_hit_tokens']} "
             f"cached tokens, fewer than 8 x {head_len}")
    mem = eng.memory_report()
    bf16_pool = bf16["memory_report"]["pool_bytes"]
    if 2 * mem["pool_bytes"] != bf16_pool:
        fail(f"int8 engine: pool_bytes {mem['pool_bytes']:.0f} is not half "
             f"the bf16 pools' {bf16_pool:.0f}")
    outputs = [r.output for r in all_reqs]
    same = [a == b for x, y in zip(outputs, bf16["outputs"])
            for a, b in zip(x, y)]
    stats = dict(
        waves=waves, launches=counts, memory_report=mem,
        greedy_tokens_equal_to_bf16=sum(same) / len(same),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"int8 engine: pool_bytes {mem['pool_bytes'] / 1e9:.3f} GB "
        f"(bf16 {bf16_pool / 1e9:.3f}); max_memory_allocated "
        f"{stats['max_memory_allocated_gb']:.2f} GB (bf16 "
        f"{bf16['max_memory_allocated_gb']:.2f}); greedy tokens equal to "
        f"the bf16 phase's: {sum(same)} of {len(same)} (not checked); "
        f"launches {counts}")
    # where the time goes: one profiled chunk step of 4 fresh requests on
    # the cached head (after the launch counts were read), as the chunked
    # phase's
    for r in wave(4):
        eng.add_request(r)
    stats["profile_chunk_step"] = profile_steps(torch, eng, 1)
    log_profile("int8 chunk_step", stats["profile_chunk_step"])
    check_attributed("int8 chunk_step", stats["profile_chunk_step"],
                     "K3 paged_prefill")
    check_attributed("int8 chunk_step", stats["profile_chunk_step"],
                     "K2 combine")
    del eng
    torch.cuda.empty_cache()

    # one 1536-token prompt, chunked by 512, over int8 pools: the kernels
    # (bf16) against the plain path on the same weights in f32.  The plain
    # path in bf16 rounds its scores to bf16, and over 32 layers of random
    # weights its logits move past BF16_MODEL_TOL from the kernels', on
    # int8 pools and on bf16 pools alike: both distances are printed
    # beside the check.
    import gc
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    n = 1536
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    pool = (cfg.n_layers, -(-(n + 2) // cfg.page_size), cfg.page_size,
            cfg.n_kv_heads, cfg.resolved_head_dim)
    model = build_model(cfg)
    p32 = tree_map(lambda x: x.float(), params)
    tape = Int8Tape(torch)
    out, lcounts = logits_pair(torch, model, params, tokens, pool, 512,
                               pool_dtype=torch.int8, tape=tape,
                               ref_params=p32)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    plain16, _ = logits_pair(torch, model, params, tokens, pool, 512,
                             pool_dtype=torch.int8, tape=Int8Tape(torch))
    bf16_pools, _ = logits_pair(torch, build_model(get_config("llama2-7b")),
                                params, tokens, pool, 512)
    got, want = out["kernel"], out["ref"]
    if not bool(torch.isfinite(got).all()):
        fail("int8 engine: non-finite logits")
    if lcounts["paged_prefill/tc/int8"] <= 0 or lcounts["paged_decode"] <= 0:
        fail(f"int8 engine: the logits' kernel path did not run K3 "
             f"tc/int8 and K1 ({lcounts})")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    rel = err / (1 + scale)
    def rel_to(out):
        return float((out["kernel"] - out["ref"]).abs().max()) / (
            1 + float(out["ref"].abs().max()))

    rel16, rel16_pools = rel_to(plain16), rel_to(bf16_pools)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"int8 engine: prefill (chunks of 512) + 2 decode logits of a "
        f"{n}-token prompt over int8 pools, kernel path (bf16) vs the "
        f"plain path on the weights in f32: max|err| {err:.3e} = "
        f"{rel:.3e} of (1 + max|logit|) (tol {BF16_MODEL_TOL:g}; "
        f"max|logit| {scale:.3f}), greedy argmax agreement {agree:.2f} "
        f"({tape.report()}); vs the plain path in bf16 {rel16:.3e}, and "
        f"on bf16 pools {rel16_pools:.3e} (neither checked); launches "
        f"{lcounts}")
    if rel > BF16_MODEL_TOL:
        fail(f"int8 engine: logits max|err| {err} beyond {BF16_MODEL_TOL} "
             f"* (1 + {scale})")
    stats["logits"] = dict(max_err=err, rel_to_scale=rel,
                           rel_to_scale_vs_bf16_plain=rel16,
                           bf16_pools_rel_to_scale_vs_bf16_plain=rel16_pools,
                           argmax_agreement=agree, launches=lcounts,
                           int8_values_differing=tape.differ,
                           int8_values=tape.total)
    return stats


def f32_engine_phase(torch):
    """The engine's default dtype, f32, at full width (after the bf16
    weights are gone): 4 requests served monolithic (K4), then the same
    weights and prompts chunked (K3), both on the split-TF32 tile; then
    one request's prefill logits through the kernels against the plain
    path."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, Request

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama2-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, max_slots=4, max_seq_len=2048, seed=SEED)
    torch.cuda.synchronize()
    if eng.dtype != torch.float32:
        fail(f"f32 engine: the engine's default dtype is {eng.dtype}")
    log(f"f32 engine phase: llama2-7b, {cfg.n_layers} layers, the "
        f"engine's default dtype (f32), 4 slots, max_seq_len 2048; weights "
        f"and pools ready in {time.perf_counter() - t0:.1f} s")
    rng = torch.Generator().manual_seed(SEED + 2)
    new = 16
    plens = torch.randint(512, 1537, (4,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in plens]
    runs = (
        ("monolithic", {}, ("paged_decode", "combine", "flex_prefill",
                            "flex_prefill/tf32x3"),
         ("paged_prefill", "flex_prefill/tc")),
        ("chunked 512", dict(prefill_chunk=512),
         ("paged_decode", "combine", "paged_prefill",
          "paged_prefill/tf32x3"),
         ("flex_prefill", *k3_routes_except("tf32x3"))))
    stats, outputs = {}, {}
    for mode, kw, must, never in runs:
        if kw:
            eng = Engine(cfg, eng.params, max_slots=4, max_seq_len=2048,
                         seed=SEED, **kw)
        reqs = [Request(prompt=list(x), max_new_tokens=new) for x in prompts]
        kernels.reset_launch_counts()
        wall, prefill_ms, decode_ms = drive(torch, eng, reqs)
        counts = kernels.launch_counts()
        check_path(f"f32 engine ({mode})", eng, reqs, new, counts, must,
                   never)
        outputs[mode] = [r.output for r in reqs]
        ttft = sorted(r.metrics["ttft_s"] for r in reqs)
        stats[mode] = dict(
            prompt_lens=plens, wall_s=wall, tok_s=4 * new / wall,
            ttft_s_max=ttft[-1], prefill_ms_per_step=prefill_ms,
            decode_ms_median=statistics.median(decode_ms), launches=counts)
        log(f"f32 engine ({mode}): {4 * new} tokens in {wall:.2f} s; "
            f"prefill steps {[round(x) for x in prefill_ms]} ms; decode "
            f"{stats[mode]['decode_ms_median']:.2f} ms/step (median); TTFT "
            f"max {ttft[-1]:.3f} s; launches {counts}")
    same = outputs["monolithic"] == outputs["chunked 512"]
    log(f"f32 engine: greedy tokens monolithic vs chunked "
        f"{'equal' if same else 'differ'} (not checked: K4 and K3 sum in "
        f"other orders)")

    # one request's prefill logits, kernels (K4 split-TF32) vs plain path
    dev = torch.device("cuda")
    model, params = eng.model, eng.params
    n, P = plens[0], cfg.page_size
    pps = -(-n // P)
    tokens = torch.tensor([prompts[0]], device=dev)
    lens_t = torch.tensor([n], dtype=torch.int32, device=dev)
    tables = torch.arange(pps, dtype=torch.int32, device=dev).reshape(1, 1,
                                                                       pps)
    pool = (cfg.n_layers, pps, P, cfg.n_kv_heads, cfg.resolved_head_dim)
    logits = {}
    for impl in ("kernel", "ref"):
        st = {"pos": lens_t, "tables": tables,
              "k_pages": torch.zeros(pool, device=dev),
              "v_pages": torch.zeros(pool, device=dev)}
        logits[impl], _ = model.prefill(params, tokens, st, lens=lens_t,
                                        impl=impl)
        del st
    torch.cuda.synchronize()
    got, want = logits["kernel"], logits["ref"]
    if not bool(torch.isfinite(got).all()):
        fail("f32 engine: non-finite prefill logits")
    err = float((got - want).abs().max())
    log(f"f32 engine: prefill logits of a {n}-token prompt ({cfg.n_layers} "
        f"layers), "
        f"kernel path vs plain path max|err| {err:.3e} (tol {MODEL_TOL:g}, "
        f"|logit| max {float(want.abs().max()):.3f})")
    if err > MODEL_TOL:
        fail(f"f32 engine: prefill logits max|err| {err} beyond {MODEL_TOL}")
    stats["prefill_logits_max_err"] = err
    stats["tokens_equal_monolithic_chunked"] = same
    stats["swa"] = swa_f32_check(torch, params)
    stats["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return stats


def swa_engine_phase(torch, params):
    """The ``swa`` variant of llama2-7b (every layer 'W', window 4096) at
    full width in bf16, on the engine phase's weights (the shapes are
    equal): 4 slots, max_seq_len 5120, a pool of 4 x 5120 tokens (the host
    reserves a page for every token, as in the JAX engine, though the
    device tables are ring-wide), 4 prompts of 4160..5000 tokens and 16
    new tokens each.  Served monolithic (K4's window & padding variant on
    the bf16 tile; K1 and K2 on ring tables), then with
    ``prefill_chunk=512`` (the 'W' layers' attend-then-write chunks in
    plain ops, as in the JAX package; K1, K2).  K3 and K4's f32 route never
    launch, and every request's last position passes window + page, so
    its ring has wrapped."""
    from repro_torch import kernels
    from repro_torch.configs import get_config, make_run
    from repro_torch.serving import Engine, Request

    cfg = make_run(get_config("llama2-7b"), "decode_32k", "swa").model
    if set(cfg.pattern()) != {"W"} or cfg.window != 4096:
        fail(f"swa engine: pattern {cfg.layer_pattern} window {cfg.window}")
    rng = torch.Generator().manual_seed(SEED + 3)
    new, slots, max_len = 16, 4, 5120
    plens = torch.randint(4160, 5001, (slots,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in plens]
    log(f"swa engine phase: llama2-7b swa ({cfg.n_layers} layers 'W', "
        f"window {cfg.window}), bf16, {slots} slots, max_seq_len {max_len}, "
        f"pool {slots} x {max_len} tokens; prompts {plens}, {new} new "
        "tokens each")
    runs = (
        ("monolithic", {}, ("paged_decode", "combine", "flex_prefill",
                            "flex_prefill/tc",
                            "flex_prefill/tc/window&padding"),
         ("paged_prefill", "flex_prefill/tf32x3")),
        ("chunked 512", dict(prefill_chunk=512), ("paged_decode", "combine"),
         ("paged_prefill", "flex_prefill")))
    stats = {}
    for mode, kw, must, never in runs:
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, max_slots=slots, max_seq_len=max_len,
                     pool_tokens=slots * max_len, dtype=torch.bfloat16,
                     seed=SEED, **kw)
        if eng.pages_per_seq != -(-cfg.window // cfg.page_size) + 1:
            fail(f"swa engine: tables {eng.pages_per_seq} pages wide, not "
                 "the ring")
        reqs = [Request(prompt=list(p), max_new_tokens=new) for p in prompts]
        peak = {}

        def at_peak():  # the memory report at the most pages in use
            mem = eng.memory_report()
            if mem["used_pages"] > peak.get("used_pages", -1):
                peak.update(mem)

        kernels.reset_launch_counts()
        wall, prefill_ms, decode_ms = drive(torch, eng, reqs, at_peak)
        counts = kernels.launch_counts()
        check_path(f"swa engine ({mode})", eng, reqs, new, counts, must,
                   never)
        last = min(r.prompt_len + len(r.output) - 1 for r in reqs)
        if last < cfg.window + cfg.page_size:
            fail(f"swa engine ({mode}): last position {last} does not pass "
                 f"window + page ({cfg.window + cfg.page_size})")
        mem = peak
        ttft = sorted(r.metrics["ttft_s"] for r in reqs)
        stats[mode] = dict(
            prompt_lens=plens, new_tokens=slots * new, wall_s=wall,
            tok_s=slots * new / wall, ttft_s_p50=ttft[len(ttft) // 2],
            ttft_s_max=ttft[-1], prefill_ms_per_step=prefill_ms,
            prefill_steps=len(prefill_ms),
            decode_ms_median=statistics.median(decode_ms),
            decode_steps=len(decode_ms), last_position_min=last,
            preempted=eng.scheduler.preempted, memory_report=mem,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=counts)
        kind = "chunk" if kw else "prefill"
        log(f"swa engine ({mode}): {slots * new} tokens in {wall:.2f} s = "
            f"{stats[mode]['tok_s']:.1f} tok/s; TTFT p50 "
            f"{stats[mode]['ttft_s_p50']:.3f} s max {ttft[-1]:.3f} s; "
            f"{kind} steps {len(prefill_ms)} "
            f"({[round(x) for x in prefill_ms]} ms); decode "
            f"{stats[mode]['decode_ms_median']:.2f} ms/step (median of "
            f"{len(decode_ms)}); preemptions {eng.scheduler.preempted}; "
            f"max_memory_allocated "
            f"{stats[mode]['max_memory_allocated_gb']:.2f} GB; memory "
            f"report at its peak {mem}; launches {counts}")
        del eng
    return stats


def swa_f32_check(torch, params):
    """One 4736-token prompt's prefill logits through the f32 ``swa`` model
    (32 'W' layers, window 4096, ring tables of 65 pages; K4's window &
    padding variant on the split-TF32 tile) against the plain path."""
    from repro_torch import kernels
    from repro_torch.configs import get_config, make_run
    from repro_torch.models.api import build_model

    dev = torch.device("cuda")
    cfg = make_run(get_config("llama2-7b"), "decode_32k", "swa").model
    model = build_model(cfg)
    n, P = 4736, cfg.page_size
    ring = -(-cfg.window // P) + 1
    rng = torch.Generator().manual_seed(SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=rng).to(dev)
    lens_t = torch.tensor([n], dtype=torch.int32, device=dev)
    tables = torch.arange(ring, dtype=torch.int32, device=dev).reshape(
        1, 1, ring)
    pool = (cfg.n_layers, ring, P, cfg.n_kv_heads, cfg.resolved_head_dim)
    logits = {}
    for impl in ("kernel", "ref"):
        st = {"pos": lens_t, "tables": tables,
              "k_pages": torch.zeros(pool, device=dev),
              "v_pages": torch.zeros(pool, device=dev)}
        kernels.reset_launch_counts()
        logits[impl], _ = model.prefill(params, tokens, st, lens=lens_t,
                                        impl=impl)
        torch.cuda.synchronize()
        if impl == "kernel":
            counts = kernels.launch_counts()
        del st
    need = "flex_prefill/tf32x3/window&padding"
    if counts.get(need, 0) != cfg.n_layers:
        fail(f"f32 swa: {need} launched {counts.get(need, 0)} times, not "
             f"once per layer ({counts})")
    got, want = logits["kernel"], logits["ref"]
    if not bool(torch.isfinite(got).all()):
        fail("f32 swa: non-finite prefill logits")
    err = float((got - want).abs().max())
    log(f"f32 swa: prefill logits of a {n}-token prompt ({cfg.n_layers} "
        f"'W' layers, window {cfg.window}), kernel path vs plain path "
        f"max|err| {err:.3e} (tol {MODEL_TOL:g}, |logit| max "
        f"{float(want.abs().max()):.3f}); launches {counts}")
    if err > MODEL_TOL:
        fail(f"f32 swa: prefill logits max|err| {err} beyond {MODEL_TOL}")
    return dict(prefill_logits_max_err=err, launches=counts)


def nemotron_engine_phase(torch):
    """nemotron-4-15b at full width and depth in bf16 (32 layers, d_model
    6144, 48 heads over 8 kv heads: G 6, d_ff 24576, vocab 256000, page
    64; random weights from the seed, about 31.2 GB): 8 slots, max_seq_len
    2048; 8 greedy requests of 256..1536 tokens, 16 new tokens each,
    monolithic (K4's bf16 tile at G 6, K1, K2); then the same weights with
    ``prefill_chunk=512, prefix_cache=True``: a wave of 2 and a wave of 6
    requests sharing a 1024-token head (K3's bf16 tile at q_block 21, R =
    126 rows; K1, K2; K4 never), the second wave hitting the cache."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.serving import Engine, Request
    from repro_torch.utils.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("nemotron-4-15b")
    G = cfg.n_heads // cfg.n_kv_heads
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, max_slots=8, max_seq_len=2048, dtype=torch.bfloat16,
                 seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(eng.params))
    log(f"nemotron-4-15b phase: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (G {G}), "
        f"D {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, bf16 ({n_params / 1e9:.2f} B parameters, "
        f"{2 * n_params / 1e9:.1f} GB), 8 slots, max_seq_len 2048, pool "
        f"{eng.num_pages} pages of {cfg.page_size}; weights and pools "
        f"ready in {time.perf_counter() - t0:.1f} s")
    rng = torch.Generator().manual_seed(SEED + 5)
    new = 16
    plens = torch.randint(256, 1537, (8,), generator=rng).tolist()
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=new) for n in plens]
    kernels.reset_launch_counts()
    wall, prefill_ms, decode_ms = drive(torch, eng, reqs)
    counts = kernels.launch_counts()
    check_path("nemotron-4-15b (monolithic)", eng, reqs, new, counts,
               must=("paged_decode", "combine", "flex_prefill",
                     "flex_prefill/tc"),
               never=("paged_prefill", "flex_prefill/tf32x3"))
    ttft = sorted(r.metrics["ttft_s"] for r in reqs)
    stats = {"monolithic": dict(
        prompt_lens=plens, new_tokens=8 * new, wall_s=wall,
        tok_s=8 * new / wall, ttft_s_p50=ttft[len(ttft) // 2],
        ttft_s_max=ttft[-1], prefill_ms_per_step=prefill_ms,
        decode_ms_per_step_median=statistics.median(decode_ms),
        decode_steps=len(decode_ms),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts)}
    m = stats["monolithic"]
    log(f"nemotron-4-15b (monolithic): {8 * new} tokens in {wall:.2f} s = "
        f"{m['tok_s']:.1f} tok/s; TTFT p50 {m['ttft_s_p50']:.3f} s max "
        f"{ttft[-1]:.3f} s; prefill steps {[round(x) for x in prefill_ms]} "
        f"ms; decode {m['decode_ms_per_step_median']:.2f} ms/step (median "
        f"of {len(decode_ms)}); max_memory_allocated "
        f"{m['max_memory_allocated_gb']:.2f} GB; launches {counts}")
    stats["profile_decode_step"] = profile_steps_on(torch, eng, cfg, rng)
    log_profile("nemotron-4-15b decode_step", stats["profile_decode_step"])

    params = eng.params
    del eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_slots=8, max_seq_len=2048,
                 dtype=torch.bfloat16, seed=SEED, prefill_chunk=512,
                 prefix_cache=True)
    _, _, qb = ops.choose_prefill_params(eng.pages_per_seq, cfg.page_size,
                                         cfg.resolved_head_dim, 512, G)
    head = torch.randint(0, cfg.vocab_size, (1024,), generator=rng).tolist()
    kernels.reset_launch_counts()
    waves, all_reqs = {}, []
    for name, n in (("A", 2), ("B", 6)):
        tails = torch.randint(128, 513, (n,), generator=rng).tolist()
        wreqs = [Request(prompt=head + torch.randint(
            0, cfg.vocab_size, (t,), generator=rng).tolist(),
            max_new_tokens=new) for t in tails]
        hits0 = eng.prefix_cache.hit_tokens
        wall, chunk_ms, dms = drive(torch, eng, wreqs)
        all_reqs += wreqs
        ttft = sorted(r.metrics["ttft_s"] for r in wreqs)
        waves[name] = dict(
            requests=n, prompt_lens=[r.prompt_len for r in wreqs],
            wall_s=wall, tok_s=n * new / wall,
            ttft_s_p50=ttft[len(ttft) // 2], ttft_s_max=ttft[-1],
            prefix_hit_tokens=eng.prefix_cache.hit_tokens - hits0,
            chunk_ms_per_step=chunk_ms,
            decode_ms_median=statistics.median(dms))
        w = waves[name]
        log(f"nemotron-4-15b chunked wave {name}: {n * new} tokens in "
            f"{wall:.2f} s = {w['tok_s']:.1f} tok/s; TTFT p50 "
            f"{w['ttft_s_p50']:.3f} s max {w['ttft_s_max']:.3f} s; chunk "
            f"steps {[round(x) for x in chunk_ms]} ms; decode "
            f"{w['decode_ms_median']:.2f} ms/step; prefix hit tokens "
            f"{w['prefix_hit_tokens']}")
    counts = kernels.launch_counts()
    check_path("nemotron-4-15b (chunked 512 + prefix cache)", eng, all_reqs,
               new, counts,
               must=("paged_decode", "combine", "paged_prefill",
                     "paged_prefill/tc"),
               never=("flex_prefill", *k3_routes_except("tc")))
    if waves["B"]["prefix_hit_tokens"] < 6 * 1024:
        fail(f"nemotron-4-15b: wave B hit "
             f"{waves['B']['prefix_hit_tokens']} cached tokens, fewer than "
             f"6 x 1024")
    stats["chunked"] = dict(
        waves=waves, launches=counts, q_block=qb, rows=qb * G,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"nemotron-4-15b (chunked): K3 at q_block {qb} (R {qb * G} rows); "
        f"max_memory_allocated "
        f"{stats['chunked']['max_memory_allocated_gb']:.2f} GB; launches "
        f"{counts}")
    return stats


def profile_steps_on(torch, eng, cfg, rng):
    """One profiled decode step of 8 fresh short requests, after a step
    that prefills them (the launch counts were read before)."""
    from repro_torch.serving import Request
    for _ in range(8):
        eng.add_request(Request(prompt=torch.randint(
            0, cfg.vocab_size, (512,), generator=rng).tolist(),
            max_new_tokens=4))
    eng.step()
    torch.cuda.synchronize()
    return profile_steps(torch, eng, 1)


def logits_pair(torch, model, params, tokens, pool, chunk=None,
                pool_dtype=None, tape=None, ref_params=None, extra=None):
    """Prefill logits of one prompt, then two decode steps' logits, through
    the plain path (impl "ref"; greedy) and the kernels (teacher-forced
    with the plain path's tokens, so both see the same inputs); with
    ``chunk``, the prompt is prefilled by ``prefill_chunk`` in chunks of
    that size.  The pools take ``pool_dtype`` (int8 for a model of
    kv_dtype "int8"), by default the dtype of the weights the path runs
    on; with an ``Int8Tape``, the kernel path writes the plain path's int8
    K/V; with ``ref_params`` (the same weights in f32) the plain path runs
    on them.  A model with 'R' layers carries its recurrent state from
    prefill to decode in the state dict, one with 'C' layers its image
    K/V (from ``extra``); a ``RouteTape`` forces the MoE routing as the
    int8 tape forces K/V.  Returns
    {impl: (3, V) logits} and the kernel path's launch counts."""
    from repro_torch import kernels
    from repro_torch.utils.tree import tree_leaves
    dev = tokens.device
    n = tokens.shape[1]
    pps = pool[1]
    tables = torch.arange(pps, dtype=torch.int32, device=dev).reshape(1, 1,
                                                                       pps)
    lens_t = torch.tensor([n], dtype=torch.int32, device=dev)
    out, counts, forced = {}, {}, []
    for impl in ("ref", "kernel"):
        w = ref_params if impl == "ref" and ref_params is not None else (
            params)
        dtype = pool_dtype or tree_leaves(w)[0].dtype
        st = {"pos": lens_t, "tables": tables,
              "k_pages": torch.zeros(pool, dtype=dtype, device=dev),
              "v_pages": torch.zeros(pool, dtype=dtype, device=dev)}
        kernels.reset_launch_counts()
        taped = (tape.pass_(replay=impl == "kernel") if tape is not None
                 else contextlib.nullcontext())
        with taped:
            if chunk is None:
                logits, st = model.prefill(w, tokens, st, lens=lens_t,
                                           extra=extra, impl=impl)
            else:
                start = 0
                while start < n:
                    c = min(chunk, n - start)
                    i32 = dict(dtype=torch.int32, device=dev)
                    logits, st = model.prefill_chunk(
                        w, tokens[:, start:start + c], st,
                        torch.tensor([start], **i32),
                        torch.tensor([c], **i32), extra=extra, impl=impl)
                    start += c
                st = dict(st, pos=lens_t)
            seq = [logits]
            for i in range(2):
                if impl == "ref":
                    forced.append(logits.argmax(-1))
                logits, st = model.decode_step(w, forced[i], st,
                                               impl=impl)
                seq.append(logits)
        torch.cuda.synchronize()
        out[impl] = torch.stack(seq).float()
        counts[impl] = kernels.launch_counts()
        del st
    return out, counts["kernel"]


def layer_gaps(torch, model, params, tokens, pool, extra=None, forced=False,
               tape=None):
    """Where two paths on the same weights part: the prefill of ``tokens``
    through the plain path (impl "ref"), then the kernels, and after each
    layer the distance of the kernel path's residual stream from the plain
    path's, ``||a - b|| / ||b||`` over the whole (1, S, d_model) stream.
    The paths differ only in the attention of the 'A' layers (K4 against
    the plain attention); every other op runs the same code.  With
    ``forced`` each layer of the kernel path starts from the plain path's
    input, so its distance is the layer's own; without, it is everything
    the layers before it passed on.  A ``RouteTape`` forces the MoE
    routing.  Returns (the distances per layer, the plain path's norm
    ``||b||`` per layer, the last token's logits' max|err| as a share of
    1 + max|logit|, None when ``forced``)."""
    from repro_torch.utils.tree import tree_leaves
    dev = tokens.device
    n = tokens.shape[1]
    pps = pool[1]
    tables = torch.arange(pps, dtype=torch.int32, device=dev).reshape(1, 1,
                                                                       pps)
    lens_t = torch.tensor([n], dtype=torch.int32, device=dev)
    dtype = tree_leaves(params)[0].dtype
    plain_ffn, seen, gaps, norms, logits = model._apply_ffn, [], [], [], {}
    for impl in ("ref", "kernel"):
        calls = iter(range(len(model.codes)))

        def ffn(p, x, *rest):
            y = plain_ffn(p, x, *rest)
            if impl == "ref":
                seen.append(y)
                return y
            want = seen[next(calls)].float()
            norms.append(float(want.norm()))
            gaps.append(float((y.float() - want).norm()) / norms[-1])
            return seen[len(gaps) - 1] if forced else y
        st = {"pos": lens_t, "tables": tables,
              "k_pages": torch.zeros(pool, dtype=dtype, device=dev),
              "v_pages": torch.zeros(pool, dtype=dtype, device=dev)}
        model._apply_ffn = ffn
        taped = (tape.pass_(replay=impl == "kernel") if tape is not None
                 else contextlib.nullcontext())
        try:
            with taped:
                out, _ = model.prefill(params, tokens, st, lens=lens_t,
                                       extra=extra, impl=impl)
        finally:
            del model._apply_ffn
        logits[impl] = out.float()
        del st
    if forced:
        return gaps, norms, None
    scale = 1 + float(logits["ref"].abs().max())
    return gaps, norms, float((logits["kernel"] - logits["ref"]).abs().max()
                              ) / scale


def log_gaps(name, codes, gaps, norms, share):
    """One line of ``layer_gaps``' distances: every layer's; free, the
    growth from the first 'A' layer to the last layer and the logits';
    forced, the largest, and what the layers' own differences would make
    after the last layer if the residual stream only carried them on:
    added in one direction (``Σ e_l / ||b_L||``, e_l = distance_l ·
    ||b_l||) or independently (``sqrt(Σ e_l²) / ||b_L||``)."""
    per = [float(f"{g:.3g}") for g in gaps]
    if share is None:
        e = [g * n for g, n in zip(gaps, norms)]
        coherent = sum(e) / norms[-1]
        independent = sum(x * x for x in e) ** 0.5 / norms[-1]
        log(f"{name}: each layer's own residual-stream distance, kernel vs "
            f"plain path, from the plain path's input {per}; largest "
            f"{max(gaps):.3e}; carried to the last layer: {coherent:.3e} "
            f"added in one direction, {independent:.3e} independently "
            f"(||b|| from {norms[0]:.4g} to {norms[-1]:.4g})")
        return dict(per_layer=gaps, norms=norms, largest=max(gaps),
                    coherent=coherent, independent=independent)
    first = next(i for i, c in enumerate(codes) if c == "A")
    growth = gaps[-1] / gaps[first] if gaps[first] else float("inf")
    log(f"{name}: residual-stream distance kernel vs plain path after each "
        f"layer {per}; after the first 'A' layer {gaps[first]:.3e}, after "
        f"the last layer {gaps[-1]:.3e} ({growth:.1f}x); last-token logits "
        f"max|err| {share:.3e} of (1 + max|logit|)")
    return dict(per_layer=gaps, first_a=gaps[first], last=gaps[-1],
                growth=growth, logits_share=share)


def nemotron_f32_check(torch):
    """nemotron-4-15b at full width and 4 layers in f32 (about 18.8 GB):
    one 1000-token prompt's prefill and two decode steps' logits through
    the kernels against the plain path, monolithic (K4's split-TF32 tile,
    K1 in f32 at G 6) and chunked by 512 (K3's split-TF32 tile)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config("nemotron-4-15b").replace(n_layers=4)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init_params(gen, torch.float32, dev)
    torch.cuda.synchronize()
    log(f"nemotron-4-15b f32 check: 4 layers at full width, f32 weights "
        f"ready in {time.perf_counter() - t0:.1f} s")
    n, P = 1000, cfg.page_size
    pps = -(-(n + 2) // P)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    pool = (cfg.n_layers, pps, P, cfg.n_kv_heads, cfg.resolved_head_dim)
    stats = {}
    for mode, chunk, must in (
            ("monolithic", None, ("flex_prefill/tf32x3", "paged_decode")),
            ("chunked 512", 512, ("paged_prefill/tf32x3", "paged_decode"))):
        out, counts = logits_pair(torch, model, params, tokens, pool, chunk)
        got, want = out["kernel"], out["ref"]
        if not bool(torch.isfinite(got).all()):
            fail(f"nemotron-4-15b f32 ({mode}): non-finite logits")
        missing = [k for k in must if counts.get(k, 0) <= 0]
        if missing:
            fail(f"nemotron-4-15b f32 ({mode}): kernels never launched: "
                 f"{missing} ({counts})")
        err = float((got - want).abs().max())
        log(f"nemotron-4-15b f32 ({mode}): prefill + 2 decode logits of a "
            f"{n}-token prompt, kernel path vs plain path max|err| "
            f"{err:.3e} (tol {MODEL_TOL:g}, |logit| max "
            f"{float(want.abs().max()):.3f}); launches {counts}")
        if err > MODEL_TOL:
            fail(f"nemotron-4-15b f32 ({mode}): max|err| {err} beyond "
                 f"{MODEL_TOL}")
        stats[mode] = dict(max_err=err, launches=counts)
    return stats


def nemotron_340b_phase(torch):
    """nemotron-4-340b at full width and 2 layers in bf16 (d_model 18432,
    96 heads over 8 kv heads: G 12, D 192, d_ff 73728, its untied
    256000-row embedding and unembedding; about 32.7 GB): one 1000-token
    prompt's prefill and two decode steps' logits through the kernels
    against the plain path within ``BF16_MODEL_TOL``, monolithic (K4's
    bf16 tile at D 192, K1) and chunked by 512 (K3's bf16 tile); then 4
    requests through the engine, monolithic and with
    ``prefill_chunk=512``."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request
    from repro_torch.utils.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    cfg = get_config("nemotron-4-340b").replace(n_layers=2)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init_params(gen, torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"nemotron-4-340b phase: 2 layers at full width (d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, D "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}), bf16 "
        f"({2 * n_params / 1e9:.1f} GB) ready in "
        f"{time.perf_counter() - t0:.1f} s")
    n, P = 1000, cfg.page_size
    pps = -(-(n + 2) // P)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    pool = (cfg.n_layers, pps, P, cfg.n_kv_heads, cfg.resolved_head_dim)
    stats = {}
    for mode, chunk, must in (
            ("logits monolithic", None, ("flex_prefill/tc", "paged_decode")),
            ("logits chunked 512", 512, ("paged_prefill/tc",
                                         "paged_decode"))):
        out, counts = logits_pair(torch, model, params, tokens, pool, chunk)
        got, want = out["kernel"], out["ref"]
        if not bool(torch.isfinite(got).all()):
            fail(f"nemotron-4-340b ({mode}): non-finite logits")
        missing = [k for k in must if counts.get(k, 0) <= 0]
        if missing:
            fail(f"nemotron-4-340b ({mode}): kernels never launched: "
                 f"{missing} ({counts})")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        rel = err / (1 + scale)
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        log(f"nemotron-4-340b ({mode}): prefill + 2 decode logits of a "
            f"{n}-token prompt, kernel path vs plain path max|err| "
            f"{err:.3e} = {rel:.3e} of (1 + max|logit|) (tol "
            f"{BF16_MODEL_TOL:g}; max|logit| {scale:.3f}), greedy argmax "
            f"agreement {agree:.2f}; launches {counts}")
        if rel > BF16_MODEL_TOL:
            fail(f"nemotron-4-340b ({mode}): max|err| {err} beyond "
                 f"{BF16_MODEL_TOL} * (1 + {scale})")
        stats[mode] = dict(max_err=err, rel_to_scale=rel,
                           argmax_agreement=agree, launches=counts)
    rng = torch.Generator().manual_seed(SEED + 6)
    plens = torch.randint(256, 1025, (4,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (k,), generator=rng).tolist()
               for k in plens]
    for mode, kw, must, never in (
            ("engine monolithic", {}, ("paged_decode", "combine",
                                       "flex_prefill/tc"),
             ("paged_prefill", "flex_prefill/tf32x3")),
            ("engine chunked 512", dict(prefill_chunk=512),
             ("paged_decode", "combine", "paged_prefill/tc"),
             ("flex_prefill", *k3_routes_except("tc")))):
        eng = Engine(cfg, params, max_slots=4, max_seq_len=2048,
                     dtype=torch.bfloat16, seed=SEED, **kw)
        reqs = [Request(prompt=list(x), max_new_tokens=8) for x in prompts]
        kernels.reset_launch_counts()
        wall, prefill_ms, decode_ms = drive(torch, eng, reqs)
        counts = kernels.launch_counts()
        check_path(f"nemotron-4-340b ({mode})", eng, reqs, 8, counts, must,
                   never)
        log(f"nemotron-4-340b ({mode}): {4 * 8} tokens in {wall:.2f} s; "
            f"prefill steps {[round(x) for x in prefill_ms]} ms; decode "
            f"{statistics.median(decode_ms):.2f} ms/step; launches {counts}")
        stats[mode] = dict(prompt_lens=plens, wall_s=wall,
                           prefill_ms_per_step=prefill_ms,
                           decode_ms_median=statistics.median(decode_ms),
                           launches=counts)
        del eng
    stats["max_memory_allocated_gb"] = (torch.cuda.max_memory_allocated()
                                        / 1e9)
    return stats


def rec_state_bytes(eng):
    """Bytes of the engine's recurrent state (``state["rec"]``)."""
    from repro_torch.utils.tree import tree_leaves
    return sum(x.numel() * x.element_size()
               for x in tree_leaves(eng.state.get("rec", {})))


def rglru_scan_ms(torch, cfg, B, S, dtype):
    """Device ms of one RG-LRU prefill scan (``rglru.linear_scan``, plain
    PyTorch: the log-depth doubling) over (B, S, lru_width) inputs of the
    model's dtype, by events: the part of a prefill step that the profile
    files under "other"."""
    from repro_torch.models import rglru
    dev = torch.device("cuda")
    w = cfg.lru_width or cfg.d_model
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    log_a = -torch.rand((B, S, w), generator=gen, device=dev)
    b = torch.randn((B, S, w), generator=gen, device=dev).to(dtype)
    ms = time_ms(torch, lambda: rglru.linear_scan(log_a, b), reps=5)
    del log_a, b
    return ms


def rglru_engine_phase(torch):
    """recurrentgemma-9b at full width and depth in bf16 (38 layers of
    pattern RRW: 26 RG-LRU blocks and 12 'W' layers of window 2048; d_model
    4096, 16 heads over one kv head: G 16, D 256; GeGLU d_ff 12288, vocab
    256000; random weights from the seed, about 20.9 GB), 8 slots,
    max_seq_len 3072, ring tables of 33 pages of 64 and a pool of 8 x 3072
    tokens: 8 greedy requests, four of 2200..3000 tokens (past the window:
    K4's window cuts and every ring wraps) and four of 256..1024, 32 new
    tokens each, monolithic.  K4's window & padding variant on the bf16
    tile, K1 and K2 must launch, at D 256, and K3 never.  Then one profiled
    prefill step and one decode step, the RG-LRU scan timed at the
    prefill's shape, and a 2200-token prompt's prefill and two decode
    steps' logits through the kernels against the plain path on the same
    weights in f32 (``BF16_MODEL_TOL`` of the logits' scale)."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request
    from repro_torch.utils.tree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("recurrentgemma-9b")
    G, D = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, max_slots=8, max_seq_len=3072, pool_tokens=8 * 3072,
                 dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(eng.params))
    ring = -(-cfg.window // cfg.page_size) + 1
    if eng.pages_per_seq != ring:
        fail(f"recurrentgemma-9b: tables of {eng.pages_per_seq} pages, not "
             f"the ring's {ring}")
    log(f"recurrentgemma-9b phase: {cfg.n_layers} layers of pattern "
        f"{cfg.layer_pattern} ({eng.model.n_rec_layers} 'R', "
        f"{eng.model.n_attn_layers} 'W' of window {cfg.window}), d_model "
        f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (G {G}), D "
        f"{D}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16 "
        f"({n_params / 1e9:.2f} B parameters, {2 * n_params / 1e9:.1f} GB), "
        f"8 slots, max_seq_len 3072, ring tables of {ring} pages of "
        f"{cfg.page_size}, pool {eng.num_pages} pages; recurrent state "
        f"{rec_state_bytes(eng) / 1e6:.2f} MB; weights and pools ready in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = torch.Generator().manual_seed(SEED + 9)
    new = 32
    plens = (torch.randint(2200, 3001, (4,), generator=rng).tolist()
             + torch.randint(256, 1025, (4,), generator=rng).tolist())
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=new) for n in plens]
    kernels.reset_launch_counts()
    wall, prefill_ms, decode_ms = drive(torch, eng, reqs)
    counts = kernels.launch_counts()
    check_path("recurrentgemma-9b", eng, reqs, new, counts,
               must=("paged_decode", "combine", "flex_prefill",
                     "flex_prefill/tc", "flex_prefill/tc/window&padding"),
               never=("paged_prefill", "flex_prefill/tf32x3"))
    if max(plens) + new <= ring * cfg.page_size:
        fail("recurrentgemma-9b: no ring wrapped")
    mem = eng.memory_report()
    ttft = sorted(r.metrics["ttft_s"] for r in reqs)
    stats = dict(
        prompt_lens=plens, new_tokens=8 * new, wall_s=wall,
        tok_s=8 * new / wall, ttft_s_p50=ttft[len(ttft) // 2],
        ttft_s_max=ttft[-1], prefill_ms_per_step=prefill_ms,
        decode_ms_per_step_median=statistics.median(decode_ms),
        decode_steps=len(decode_ms), preempted=eng.scheduler.preempted,
        pool_bytes=mem["pool_bytes"], rec_state_bytes=rec_state_bytes(eng),
        memory_report=mem,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts)
    log(f"recurrentgemma-9b (monolithic): {8 * new} tokens in {wall:.2f} s "
        f"= {stats['tok_s']:.1f} tok/s; TTFT p50 {stats['ttft_s_p50']:.3f} "
        f"s max {ttft[-1]:.3f} s; prefill steps "
        f"{[round(x) for x in prefill_ms]} ms; decode "
        f"{stats['decode_ms_per_step_median']:.2f} ms/step (median of "
        f"{len(decode_ms)}); preemptions {eng.scheduler.preempted}; pool "
        f"{mem['pool_bytes'] / 1e6:.1f} MB, recurrent state "
        f"{stats['rec_state_bytes'] / 1e6:.2f} MB; max_memory_allocated "
        f"{stats['max_memory_allocated_gb']:.2f} GB; launches {counts}")
    # where the time goes (after the launch counts were read): the step
    # that admits 8 fresh prompts of 2200 tokens (their prefill and first
    # decode), then a decode step; and the RG-LRU scan alone at the
    # prefill's shape
    for _ in range(8):
        eng.add_request(Request(prompt=torch.randint(
            0, cfg.vocab_size, (2200,), generator=rng).tolist(),
            max_new_tokens=4))
    stats["profile_prefill_step"] = profile_steps(torch, eng, 1)
    stats["profile_decode_step"] = profile_steps(torch, eng, 1)
    for name in ("prefill_step", "decode_step"):
        log_profile(f"recurrentgemma-9b {name}", stats["profile_" + name])
    check_attributed("recurrentgemma-9b prefill_step",
                     stats["profile_prefill_step"], "K4 flex_prefill")
    check_attributed("recurrentgemma-9b decode_step",
                     stats["profile_decode_step"], "K1 paged_decode")
    scan = rglru_scan_ms(torch, cfg, 8, 2200, torch.bfloat16)
    stats["rglru_scan_ms_per_layer"] = scan
    log(f"recurrentgemma-9b: RG-LRU scan (8 x 2200 x {cfg.lru_width}, bf16) "
        f"{scan:.3f} ms per layer, {eng.model.n_rec_layers * scan:.1f} ms "
        f"over the {eng.model.n_rec_layers} 'R' layers of a prefill step")
    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the logits: the kernels (bf16) against the plain path on the same
    # weights in f32 (the bf16 plain path's own rounding over 38 layers
    # is of the order of the tolerance: its distance is printed too)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    n = 2200
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    model = build_model(cfg)
    pool = (model.n_attn_layers, ring, cfg.page_size, cfg.n_kv_heads, D)
    p32 = tree_map(lambda x: x.float(), params)
    out, lcounts = logits_pair(torch, model, params, tokens, pool,
                               ref_params=p32)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    plain16, _ = logits_pair(torch, model, params, tokens, pool)
    got, want = out["kernel"], out["ref"]
    if not bool(torch.isfinite(got).all()):
        fail("recurrentgemma-9b: non-finite logits")
    missing = [k for k in ("flex_prefill/tc/window&padding", "paged_decode")
               if lcounts.get(k, 0) <= 0]
    if missing:
        fail(f"recurrentgemma-9b logits: kernels never launched: {missing}")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    rel = err / (1 + scale)
    rel16 = float((plain16["kernel"] - plain16["ref"]).abs().max()) / (
        1 + float(plain16["ref"].abs().max()))
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"recurrentgemma-9b: prefill + 2 decode logits of a {n}-token "
        f"prompt (past the window), kernel path (bf16) vs the plain path on "
        f"the weights in f32: max|err| {err:.3e} = {rel:.3e} of (1 + "
        f"max|logit|) (tol {BF16_MODEL_TOL:g}; max|logit| {scale:.3f}), "
        f"greedy argmax agreement {agree:.2f}; vs the plain path in bf16 "
        f"{rel16:.3e} (not checked); launches {lcounts}")
    if rel > BF16_MODEL_TOL:
        fail(f"recurrentgemma-9b: logits max|err| {err} beyond "
             f"{BF16_MODEL_TOL} * (1 + {scale})")
    stats["logits"] = dict(max_err=err, rel_to_scale=rel,
                           rel_to_scale_vs_bf16_plain=rel16,
                           argmax_agreement=agree, launches=lcounts)
    return stats


def rglru_f32_check(torch):
    """recurrentgemma-9b at full width and 6 layers (RRWRRW: two 'W'
    layers) in f32 (about 13.7 GB): a 2200-token prompt's prefill and two
    decode steps' logits through the kernels (K4's split-TF32 tile under
    window 2048 & padding, K1 in f32 at G 16, D 256, on ring tables past
    the window) against the plain path within the model tolerance."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config("recurrentgemma-9b").replace(n_layers=6)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = model.init_params(gen, torch.float32, dev)
    torch.cuda.synchronize()
    log(f"recurrentgemma-9b f32 check: {cfg.n_layers} layers "
        f"({cfg.pattern()}) at full width, f32 weights ready in "
        f"{time.perf_counter() - t0:.1f} s")
    n = 2200
    ring = -(-cfg.window // cfg.page_size) + 1
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    pool = (model.n_attn_layers, ring, cfg.page_size, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    out, counts = logits_pair(torch, model, params, tokens, pool)
    got, want = out["kernel"], out["ref"]
    if not bool(torch.isfinite(got).all()):
        fail("recurrentgemma-9b f32: non-finite logits")
    missing = [k for k in ("flex_prefill/tf32x3/window&padding",
                           "paged_decode") if counts.get(k, 0) <= 0]
    if missing:
        fail(f"recurrentgemma-9b f32: kernels never launched: {missing} "
             f"({counts})")
    err = float((got - want).abs().max())
    log(f"recurrentgemma-9b f32: prefill + 2 decode logits of a {n}-token "
        f"prompt, kernel path vs plain path max|err| {err:.3e} (tol "
        f"{MODEL_TOL:g}, |logit| max {float(want.abs().max()):.3f}); "
        f"launches {counts}")
    if err > MODEL_TOL:
        fail(f"recurrentgemma-9b f32: max|err| {err} beyond {MODEL_TOL}")
    return dict(max_err=err, launches=counts)


# -- the MoE and cross-attention families -------------------------------------
MOE_PARTS = ("router", "dispatch", "experts", "combine")
CROSS_PARTS = ("cross_kv", "cross_attn")


class RouteTape:
    """Teacher-forces the MoE routing between two passes of a model, as
    ``Int8Tape`` forces int8 K/V: the first pass records each MoE layer's
    top-k experts (``models.moe.top_k_route``), the second takes the
    recorded experts in place of its own, call by call, with its own
    gates at them (renormalised), and counts the choices its own top-k
    made otherwise.  Routing is discrete: two paths whose router logits
    differ by rounding flip a near-tie, and a flipped choice moves its
    token's FFN output by a whole expert's.  With the tape both passes
    route alike, and the comparison sees the arithmetic."""

    def __init__(self, torch):
        self.torch, self.tape = torch, []
        self.diffs, self.total = [], 0

    @property
    def differ(self) -> int:
        """The choices that differed, summed on the host only when read
        (a replayed step does not wait on the device)."""
        return sum(int(d) for d in self.diffs)

    @contextlib.contextmanager
    def pass_(self, replay):
        from repro_torch.models import moe
        torch = self.torch
        orig, calls = moe.top_k_route, iter(range(len(self.tape)))

        def route(probs, k):
            gates, idx = orig(probs, k)
            if not replay:
                self.tape.append(idx.clone())
                return gates, idx
            want = self.tape[next(calls)]
            if want.shape != idx.shape:
                fail(f"route tape: {tuple(idx.shape)} routed where "
                     f"{tuple(want.shape)} was recorded")
            self.diffs.append((idx[:, :, None] != want[:, None, :])
                              .all(-1).sum())
            self.total += idx.numel()
            g = probs.gather(1, want)
            return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want

        moe.top_k_route = route
        try:
            yield
        finally:
            moe.top_k_route = orig

    def report(self):
        return (f"{self.differ} of {self.total} expert choices of the "
                f"second pass differed from the first's")


class DropCount:
    """The kept and the live (token, choice) pairs of every MoE dispatch
    while on, split into decode calls (as many tokens as the engine's
    slots) and the others (prefill, chunks), and the distinct experts the
    live tokens of a decode call choose.  It keeps references to the
    dispatch's inputs and outputs and sums them after the run: nothing is
    launched or read on the host inside a step."""

    def __init__(self, torch, slots):
        self.torch, self.slots, self.calls = torch, slots, []

    @contextlib.contextmanager
    def on(self):
        from repro_torch.models import moe
        orig = moe.dispatch

        def wrapped(idx, C, E, live=None):
            out = orig(idx, C, E, live)
            self.calls.append((idx, out[1], live))
            return out

        moe.dispatch = wrapped
        try:
            yield
        finally:
            moe.dispatch = orig

    def shares(self):
        """{kind: (dropped share, kept, live choices)}."""
        out = {}
        for kind in ("prefill", "decode"):
            kept = live = 0
            for idx, ok, lv in self.calls:
                T, k = idx.shape
                if (T == self.slots) != (kind == "decode"):
                    continue
                kept += int(ok.sum())
                live += k * (T if lv is None else int(lv.sum()))
            out[kind] = (1 - kept / live if live else None, kept, live)
        return out

    def decode_experts(self):
        """The mean count of distinct experts that a decode call's live
        tokens choose (the experts whose weights the step needs)."""
        n = [int(idx[lv].unique().numel()) for idx, _, lv in self.calls
             if idx.shape[0] == self.slots]
        return sum(n) / len(n) if n else None


def annotate_all(torch, module, names):
    """``annotated`` for several functions of one module at once."""
    stack = contextlib.ExitStack()
    for name in names:
        stack.enter_context(annotated(torch, module, name))
    return stack


def weight_bytes(params, moe_only=False):
    """Bytes of the weights a decode step reads: every layer's (only the
    experts with ``moe_only``) and the unembedding; the embedding table
    gives only the batch's rows unless it is tied to the unembedding."""
    from repro_torch.utils.tree import tree_leaves
    layers = params["layers"]
    if moe_only:
        return sum(x.numel() * x.element_size() for p in layers
                   if "moe" in p for k, x in p["moe"].items()
                   if k != "router")
    total = sum(x.numel() * x.element_size() for x in tree_leaves(layers))
    emb = params["embed"]
    total += sum(x.numel() * x.element_size() for x in tree_leaves(params["ln_f"]))
    head = emb.get("head", emb["tok"])
    return total + head.numel() * head.element_size()


def set_gates(torch, params, rng):
    """Draw every cross-attention gate from U(0.5, 1) (the JAX init is 0,
    and tanh(0) = 0 would hide the cross-attention path)."""
    for p in params["layers"]:
        if "gate" in p:
            p["gate"].fill_(0.5 + 0.5 * float(torch.rand((), generator=rng)))


def images(torch, n, cfg, seed, dtype):
    """``n`` random (n_image_tokens, d_vision) image embeddings on the card,
    from ``seed``: the per-request extras of a cross-attention model."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [{"image_embeds": torch.randn(
        (cfg.n_image_tokens, cfg.d_vision), generator=gen, device=dev
    ).to(dtype)} for _ in range(n)]


def serve_stats(torch, reqs, wall, prefill_ms, decode_ms, counts):
    ttft = sorted(r.metrics["ttft_s"] for r in reqs)
    new_tokens = sum(len(r.output) for r in reqs)
    return dict(
        prompt_lens=[r.prompt_len for r in reqs], new_tokens=new_tokens,
        wall_s=wall, tok_s=new_tokens / wall, ttft_s_p50=ttft[len(ttft) // 2],
        ttft_s_max=ttft[-1], prefill_ms_per_step=prefill_ms,
        decode_ms_per_step_median=(statistics.median(decode_ms)
                                   if decode_ms else None),
        decode_steps=len(decode_ms),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts)


def log_serve(name, st):
    log(f"{name}: {st['new_tokens']} tokens in {st['wall_s']:.2f} s = "
        f"{st['tok_s']:.1f} tok/s; TTFT p50 {st['ttft_s_p50']:.3f} s max "
        f"{st['ttft_s_max']:.3f} s; prefill steps "
        f"{[round(x) for x in st['prefill_ms_per_step']]} ms; decode "
        f"{fmt(st['decode_ms_per_step_median'])}/step (median of "
        f"{st['decode_steps']}); max_memory_allocated "
        f"{st['max_memory_allocated_gb']:.2f} GB; launches {st['launches']}")


def profile_pair(torch, eng, cfg, rng, module, parts, extras=None):
    """One profiled prefill step (8 fresh prompts of 1024 tokens, their
    prefill and first decode) and one decode step, with the kernels of
    ``module``'s functions ``parts`` in columns of their own."""
    from repro_torch.serving import Request
    for i in range(8):
        eng.add_request(Request(prompt=torch.randint(
            0, cfg.vocab_size, (1024,), generator=rng).tolist(),
            max_new_tokens=4), extras[i] if extras else None)
    out = {}
    with annotate_all(torch, module, parts):
        out["prefill_step"] = profile_steps(torch, eng, 1, annotation=parts)
        out["decode_step"] = profile_steps(torch, eng, 1, annotation=parts)
    for name, prof in out.items():
        log_profile(f"{cfg.name} {name}", prof)
    check_attributed(f"{cfg.name} prefill_step", out["prefill_step"],
                     "K4 flex_prefill")
    check_attributed(f"{cfg.name} decode_step", out["decode_step"],
                     "K1 paged_decode")
    for _ in range(8):  # finish the wave
        eng.step()
    return out


def check_logits(name, out, counts, must, tol, rel=False):
    """Hold the kernel path's logits against the plain path's: max|err|
    <= tol (or tol * (1 + max|logit|) with ``rel``); every kernel in
    ``must`` launched, and K2 after K1."""
    got, want = out["kernel"], out["ref"]
    if not bool(got.isfinite().all()):
        fail(f"{name}: non-finite logits")
    if "paged_decode" in must:  # K1's partials merge in K2
        must = (*must, "combine/decode")
    missing = [k for k in must if counts.get(k, 0) <= 0]
    if missing:
        fail(f"{name}: kernels never launched: {missing} ({counts})")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    bound = tol * (1 + scale) if rel else tol
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"{name}: prefill + 2 decode logits, kernel path vs plain path "
        f"max|err| {err:.3e} (bound {bound:.3e}; max|logit| {scale:.3f}); "
        f"greedy argmax agreement {agree:.2f}; launches {counts}")
    if err > bound:
        fail(f"{name}: logits max|err| {err} beyond {bound}")
    return dict(max_err=err, bound=bound, scale=scale, argmax_agreement=agree,
                launches=counts)


def moe_engine_phase(torch, name):
    """A MoE config (granite-moe-1b-a400m: 24 layers, d_model 1024, 16
    heads over 8: G 2, D 64, 32 experts top-8 of d_ff 512; olmoe-1b-7b: 16
    layers, d_model 2048, 16 heads over 16: G 1, D 128, 64 experts top-8
    of d_ff 1024) at full width and depth in bf16 (random weights from the
    seed), at the config's capacity factor 1.25, 8 slots, max_seq_len
    2048: the engine phase's 12 prompts of 256..1536 tokens, 32 new
    tokens each, monolithic (K4's bf16 tile, K1, K2; K3 never); the share
    of dropped expert choices in prefill and decode; a profiled prefill
    and decode step with the MoE's router, dispatch, experts and combine
    in columns of their own; then the same weights with
    ``prefill_chunk=512, prefix_cache=True``: a wave of 4 and a wave of 8
    on a shared 1024-token head (K3's bf16 tile, K1, K2; K4 never; the
    second wave hits the cache); the logits of a 1024-token prompt
    (prefill and two decode steps) through the kernels against the plain
    path on the weights in f32 (``BF16_MODEL_TOL`` of the logits' scale)
    with the routing teacher-forced (``RouteTape``; the choices that
    differ unforced are counted); and the decode step's bytes."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request
    from repro_torch.utils.tree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(name)
    G, D = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, max_slots=8, max_seq_len=2048, dtype=torch.bfloat16,
                 seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(eng.params))
    experts_b = weight_bytes(eng.params, moe_only=True)
    step_b = weight_bytes(eng.params)
    log(f"{name} phase: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} (G {G}), D {D}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.expert_ff}, "
        f"capacity factor {cfg.moe_capacity}, vocab {cfg.vocab_size}, bf16 "
        f"({n_params / 1e9:.3f} B parameters, {2 * n_params / 1e9:.2f} GB; "
        f"experts {experts_b / 1e9:.2f} GB), 8 slots, max_seq_len 2048, "
        f"pool {eng.num_pages} pages of {cfg.page_size}; weights and pools "
        f"ready in {time.perf_counter() - t0:.1f} s")
    rng = torch.Generator().manual_seed(SEED)
    new = 32
    plens = torch.randint(256, 1537, (12,), generator=rng).tolist()
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=new) for n in plens]
    drops = DropCount(torch, 8)
    kernels.reset_launch_counts()
    with drops.on():
        wall, prefill_ms, decode_ms = drive(torch, eng, reqs)
    counts = kernels.launch_counts()
    check_path(f"{name} (monolithic)", eng, reqs, new, counts,
               must=("paged_decode", "combine", "flex_prefill",
                     "flex_prefill/tc"),
               never=("paged_prefill", "flex_prefill/tf32x3"))
    stats = {"monolithic": serve_stats(torch, reqs, wall, prefill_ms,
                                       decode_ms, counts)}
    m = stats["monolithic"]
    m["dropped"] = {k: dict(share=v[0], kept=v[1], live=v[2])
                    for k, v in drops.shares().items()}
    chosen = drops.decode_experts()
    chosen_b = experts_b * chosen / cfg.n_experts
    m["decode_bytes"] = dict(
        weights=step_b, experts=experts_b,
        weights_bound_ms=1e3 * step_b / HBM_BPS,
        experts_bound_ms=1e3 * experts_b / HBM_BPS,
        experts_chosen=chosen, experts_chosen_bytes=chosen_b,
        experts_chosen_bound_ms=1e3 * chosen_b / HBM_BPS)
    log_serve(f"{name} (monolithic)", m)
    log(f"{name}: dropped expert choices at {cfg.moe_capacity}: prefill "
        f"{m['dropped']['prefill']}, decode {m['dropped']['decode']}; a "
        f"decode step reads {step_b / 1e9:.3f} GB of weights (>= "
        f"{m['decode_bytes']['weights_bound_ms']:.3f} ms at 3.35 TB/s), of "
        f"which the experts {experts_b / 1e9:.3f} GB (>= "
        f"{m['decode_bytes']['experts_bound_ms']:.3f} ms; the bmm reads "
        f"every expert, empty slots too); its live tokens choose "
        f"{chosen:.2f} of {cfg.n_experts} experts per layer on average, "
        f"{chosen_b / 1e9:.3f} GB (>= "
        f"{m['decode_bytes']['experts_chosen_bound_ms']:.3f} ms)")
    stats["profile"] = profile_pair(torch, eng, cfg, rng, moe, MOE_PARTS)

    params = eng.params
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_slots=8, max_seq_len=2048,
                 dtype=torch.bfloat16, seed=SEED, prefill_chunk=512,
                 prefix_cache=True)
    head = torch.randint(0, cfg.vocab_size, (1024,), generator=rng).tolist()
    kernels.reset_launch_counts()
    waves, all_reqs = {}, []
    for wave, n in (("A", 4), ("B", 8)):
        tails = torch.randint(128, 513, (n,), generator=rng).tolist()
        wreqs = [Request(prompt=head + torch.randint(
            0, cfg.vocab_size, (t,), generator=rng).tolist(),
            max_new_tokens=new) for t in tails]
        hits0 = eng.prefix_cache.hit_tokens
        wall, chunk_ms, dms = drive(torch, eng, wreqs)
        all_reqs += wreqs
        w = serve_stats(torch, wreqs, wall, chunk_ms, dms, None)
        w["prefix_hit_tokens"] = eng.prefix_cache.hit_tokens - hits0
        waves[wave] = w
        log(f"{name} chunked wave {wave}: {w['new_tokens']} tokens in "
            f"{wall:.2f} s = {w['tok_s']:.1f} tok/s; TTFT p50 "
            f"{w['ttft_s_p50']:.3f} s; chunk steps "
            f"{[round(x) for x in chunk_ms]} ms; decode "
            f"{fmt(w['decode_ms_per_step_median'])}/step; prefix hit tokens "
            f"{w['prefix_hit_tokens']}")
    counts = kernels.launch_counts()
    check_path(f"{name} (chunked 512 + prefix cache)", eng, all_reqs, new,
               counts, must=("paged_decode", "combine", "paged_prefill",
                             "paged_prefill/tc"),
               never=("flex_prefill", *k3_routes_except("tc")))
    if waves["B"]["prefix_hit_tokens"] < 8 * 1024:
        fail(f"{name}: wave B hit {waves['B']['prefix_hit_tokens']} cached "
             "tokens, fewer than 8 x 1024")
    stats["chunked"] = dict(
        waves=waves, launches=counts,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{name} (chunked): max_memory_allocated "
        f"{stats['chunked']['max_memory_allocated_gb']:.2f} GB; launches "
        f"{counts}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # the logits, the kernels (bf16) against the plain path on the weights
    # in f32, the routing forced
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    n = 1024
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    model = build_model(cfg)
    pool = (model.n_attn_layers, -(-(n + 2) // cfg.page_size),
            cfg.page_size, cfg.n_kv_heads, D)
    p32 = tree_map(lambda x: x.float(), params)
    tape = RouteTape(torch)
    out, lcounts = logits_pair(torch, model, params, tokens, pool,
                               tape=tape, ref_params=p32)
    del p32
    gaps = {}  # beside the VLM's: bf16 kernels against bf16 plain
    for key, kw in (("bf16", {}), ("bf16 forced", dict(forced=True))):
        gaps[key] = log_gaps(
            f"{name} prefill ({key}, routing forced)", model.codes,
            *layer_gaps(torch, model, params, tokens, pool,
                        tape=RouteTape(torch), **kw))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    stats["logits"] = check_logits(
        f"{name} (bf16, full depth, routing forced)", out, lcounts,
        ("flex_prefill/tc", "paged_decode"), BF16_MODEL_TOL, rel=True)
    stats["logits"]["unforced_choices_differing"] = [tape.differ, tape.total]
    stats["layer_gaps"] = gaps
    log(f"{name}: {tape.report()}")
    return stats


def moe_f32_check(torch, name):
    """A MoE config at full width and 4 layers in f32: one 1000-token
    prompt's prefill and two decode steps' logits through the kernels
    against the plain path within the model tolerance, monolithic (K4's
    split-TF32 tile, K1 in f32) and chunked by 512 (K3's split-TF32 tile),
    the routing forced."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config(name).replace(n_layers=4)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init_params(gen, torch.float32, dev)
    n, P = 1000, cfg.page_size
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    pool = (cfg.n_layers, -(-(n + 2) // P), P, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    stats = {}
    for mode, chunk, must in (
            ("monolithic", None, ("flex_prefill/tf32x3", "paged_decode")),
            ("chunked 512", 512, ("paged_prefill/tf32x3", "paged_decode"))):
        tape = RouteTape(torch)
        out, counts = logits_pair(torch, model, params, tokens, pool, chunk,
                                  tape=tape)
        stats[mode] = check_logits(f"{name} f32 4 layers ({mode})", out,
                                   counts, must, MODEL_TOL)
        stats[mode]["unforced_choices_differing"] = [tape.differ,
                                                     tape.total]
        log(f"{name} f32 ({mode}): {tape.report()}")
    return stats


def cross_attention_times(torch, cfg, eng, prefill_q=1536):
    """The dense cross-attention (``core.attention.prefill_attention``,
    plain path) per layer, by events, beside SDPA (``enable_gqa``) over
    the same tensors: a prefill of 8 x ``prefill_q`` queries and a decode
    step of 8 queries over the keys of the engine's cross state (1601
    image tokens, 1500 audio frames), bf16."""
    import torch.nn.functional as F
    from repro_torch.core import attention as core_attn
    dev = torch.device("cuda")
    k, v = eng.state["cross_k"][0], eng.state["cross_v"][0]
    out = {}
    for what, S in ((f"prefill 8 x {prefill_q}", prefill_q),
                    ("decode 8 x 1", 1)):
        q = torch.randn((8, S, cfg.n_heads, cfg.resolved_head_dim),
                        device=dev).to(torch.bfloat16)
        dense = time_ms(torch, lambda: core_attn.prefill_attention(
            q, k, v, causal=False, impl="ref"), reps=5)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True), reps=5)
        got = core_attn.prefill_attention(q, k, v, causal=False, impl="ref")
        want = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
        err = float((got.float() - want.transpose(1, 2).float()).abs().max())
        out[what] = dict(dense_ms=dense, sdpa_ms=sdpa, max_abs_diff=err)
        log(f"{cfg.name} cross-attention {what} over {k.shape[1]} "
            f"keys, per layer: dense plain path {dense:.4f} ms, SDPA "
            f"{sdpa:.4f} ms (max|diff| {err:.3e})")
    return out


def chunk_kinds(eng):
    """Record, for every chunk step of ``eng``, its rows at their first
    chunk and its resumes: a list of (firsts, resumes).  A step that holds
    both runs the model's ``partial`` cross mode (padding rows pose as
    resumes, but only live rows count here)."""
    kinds, plain = [], eng._run_chunk

    def run_chunk(slots, rs, batch, starts, q_lens):
        firsts = int((starts[:len(slots)] == 0).sum())
        kinds.append((firsts, len(slots) - firsts))
        return plain(slots, rs, batch, starts, q_lens)
    eng._run_chunk = run_chunk
    return kinds


def common_prefix(a, b):
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def vlm_engine_phase(torch):
    """llama-3.2-vision-11b at full width and depth in bf16 (40 layers of
    pattern CAAAA: 8 cross-attention layers over 1601 image tokens and 32
    'A' layers; d_model 4096, 32 heads over 8: G 4, D 128, d_ff 14336,
    vocab 128256; random weights from the seed, the gates drawn from U(0.5,
    1)), 8 slots, max_seq_len 2048: 8 greedy requests of 256..1536 tokens,
    each with its own random (1601, 1280) image embeddings, 32 new tokens,
    monolithic (K4's bf16 tile, K1, K2; K3 never); a profiled prefill and
    decode step with the cross-attention in columns of its own; the dense
    cross-attention timed beside SDPA; then chunked by 512 (K3's bf16 tile,
    K1, K2; K4 never), with steps that hold first chunks and resumes
    together; a request forked (the child's slot gets the parent's image
    K/V); ``prefix_cache=True`` refused; and the logits of a 1024-token
    prompt through the kernels against the plain path, in f32 on the same
    weights (``MODEL_TOL``) and in bf16 (``BF16_MODEL_TOL`` of the
    logits' scale)."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.errors import EngineConfigError
    from repro_torch.models import attention
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request, Status
    from repro_torch.utils.tree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama-3.2-vision-11b")
    G, D = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, max_slots=8, max_seq_len=2048, dtype=torch.bfloat16,
                 seed=SEED)
    rng = torch.Generator().manual_seed(SEED + 13)
    set_gates(torch, eng.params, rng)
    params = eng.params
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    step_b = weight_bytes(params)
    cross_b = sum(eng.state[k].numel() * eng.state[k].element_size()
                  for k in ("cross_k", "cross_v"))
    log(f"llama-3.2-vision-11b phase: {cfg.n_layers} layers of pattern "
        f"{cfg.layer_pattern} ({eng.model.n_cross_layers} 'C' over "
        f"{cfg.n_image_tokens} image tokens, {eng.model.n_attn_layers} "
        f"'A'), d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"(G {G}), D {D}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16 "
        f"({n_params / 1e9:.3f} B parameters, {2 * n_params / 1e9:.2f} GB), "
        f"8 slots, max_seq_len 2048, pool {eng.num_pages} pages "
        f"({eng.memory_report()['pool_bytes'] / 1e9:.3f} GB), cross state "
        f"{cross_b / 1e9:.3f} GB; ready in {time.perf_counter() - t0:.1f} s")
    new = 32
    plens = torch.randint(256, 1537, (8,), generator=rng).tolist()
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=new) for n in plens]
    extras = images(torch, 8, cfg, SEED + 13, torch.bfloat16)
    kernels.reset_launch_counts()
    wall, prefill_ms, decode_ms = drive(torch, eng, reqs, extras=extras)
    counts = kernels.launch_counts()
    check_path("llama-3.2-vision-11b (monolithic)", eng, reqs, new, counts,
               must=("paged_decode", "combine", "flex_prefill",
                     "flex_prefill/tc"),
               never=("paged_prefill", "flex_prefill/tf32x3"))
    stats = {"monolithic": serve_stats(torch, reqs, wall, prefill_ms,
                                       decode_ms, counts)}
    m = stats["monolithic"]
    m["decode_bytes"] = dict(weights=step_b, cross_state=cross_b,
                             weights_bound_ms=1e3 * step_b / HBM_BPS,
                             cross_bound_ms=1e3 * cross_b / HBM_BPS)
    log_serve("llama-3.2-vision-11b (monolithic)", m)
    log(f"llama-3.2-vision-11b: a decode step reads {step_b / 1e9:.3f} GB of "
        f"weights (>= {m['decode_bytes']['weights_bound_ms']:.3f} ms at 3.35 "
        f"TB/s) and {cross_b / 1e9:.3f} GB of image K/V (>= "
        f"{m['decode_bytes']['cross_bound_ms']:.3f} ms)")
    stats["profile"] = profile_pair(
        torch, eng, cfg, rng, attention, CROSS_PARTS,
        images(torch, 8, cfg, SEED + 14, torch.bfloat16))
    stats["cross_attention"] = cross_attention_times(torch, cfg, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # chunked by 512: a step's budget holds one request's last chunk and
    # the next one's first (the model's partial cross mode)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_slots=8, max_seq_len=2048,
                 dtype=torch.bfloat16, seed=SEED, prefill_chunk=512)
    mixed = chunk_kinds(eng)
    creqs = [Request(prompt=list(r.prompt), max_new_tokens=new)
             for r in reqs]
    kernels.reset_launch_counts()
    wall, chunk_ms, dms = drive(torch, eng, creqs, extras=extras)
    counts = kernels.launch_counts()
    check_path("llama-3.2-vision-11b (chunked 512)", eng, creqs, new, counts,
               must=("paged_decode", "combine", "paged_prefill",
                     "paged_prefill/tc"),
               never=("flex_prefill", *k3_routes_except("tc")))
    n_mixed = sum(1 for f, r in mixed if f and r)
    if not n_mixed:
        fail(f"llama-3.2-vision-11b (chunked): no chunk step held a first "
             f"chunk beside a resume ({mixed})")
    stats["chunked"] = serve_stats(torch, creqs, wall, chunk_ms, dms, counts)
    stats["chunked"]["steps_first_and_resume"] = n_mixed
    stats["chunked"]["agree_with_monolithic"] = sum(
        a.output == b.output for a, b in zip(reqs, creqs))
    stats["chunked"]["tokens_before_divergence"] = [
        common_prefix(a.output, b.output) for a, b in zip(reqs, creqs)]
    log_serve("llama-3.2-vision-11b (chunked 512)", stats["chunked"])
    log(f"llama-3.2-vision-11b (chunked): {n_mixed} of {len(mixed)} chunk "
        f"steps held first chunks beside resumes; "
        f"{stats['chunked']['agree_with_monolithic']} of 8 requests' greedy "
        f"tokens equal to the monolithic run's, the first "
        f"{stats['chunked']['tokens_before_divergence']} of 32 alike (bf16, "
        f"K3 against K4: not checked; the f32 check holds the chunked "
        f"engine's tokens to the monolithic one's)")

    # fork: the child's slot gets the parent's image K/V
    parent = Request(prompt=list(reqs[0].prompt), max_new_tokens=8)
    eng.add_request(parent, extras[0])
    while parent.status is not Status.RUNNING or not parent.output:
        eng.step()
    kernels.reset_launch_counts()
    child = eng.fork_request(parent, max_new_tokens=8)
    same = all(torch.equal(eng.state[k][:, child.slot],
                           eng.state[k][:, parent.slot])
               for k in ("cross_k", "cross_v"))
    while not (parent.done and child.done):
        eng.step()
    fcounts = kernels.launch_counts()
    if not same or child.status is not Status.FINISHED:
        fail(f"llama-3.2-vision-11b fork: cross rows copied {same}, child "
             f"{child.status}")
    stats["fork"] = dict(cross_rows_equal=same, child=child.output,
                         parent=parent.output, launches=fcounts)
    log(f"llama-3.2-vision-11b fork: the child's image K/V equal the "
        f"parent's; child tokens {child.output}, parent {parent.output}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    try:
        Engine(cfg, params, max_slots=2, max_seq_len=256,
               dtype=torch.bfloat16, prefix_cache=True)
    except EngineConfigError as e:
        log(f"llama-3.2-vision-11b: prefix_cache=True refused: {e}")
    else:
        fail("llama-3.2-vision-11b: prefix_cache=True was not refused")

    # the logits at full depth: the kernels in f32 against the plain path
    # in f32 (MODEL_TOL), and in bf16 against the plain path in bf16
    # (BF16_MODEL_TOL of the scale).  Over these 40 random layers the bf16
    # plain path itself ends 4.8-5.2 % of (1 + max|logit|) from the f32
    # one (measured on an H100), at BF16_MODEL_TOL: the bf16 paths'
    # distances from the f32 plain path are printed, not checked.
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    n = 1024
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    model = build_model(cfg)
    pool = (model.n_attn_layers, -(-(n + 2) // cfg.page_size),
            cfg.page_size, cfg.n_kv_heads, D)
    img = {"image_embeds": extras[1]["image_embeds"][None]}
    p32 = tree_map(lambda x: x.float(), params)
    out32, c32 = logits_pair(torch, model, p32, tokens, pool, extra=img)
    out16, c16 = logits_pair(torch, model, params, tokens, pool, extra=img)
    # where the bf16 paths part: layer by layer, free and each layer from
    # the plain path's input, in f32, and with every gate at 0 (no
    # cross-attention)
    name = "llama-3.2-vision-11b prefill"
    gaps = {}
    for key, w, kw in (("bf16", params, {}),
                       ("bf16 forced", params, dict(forced=True)),
                       ("f32", p32, {})):
        gaps[key] = log_gaps(f"{name} ({key})", model.codes, *layer_gaps(
            torch, model, w, tokens, pool, img, **kw))
    gates = [p["gate"] for p in params["layers"] if "gate" in p]
    kept = [g.clone() for g in gates]
    for g in gates:
        g.zero_()
    gaps["bf16 gates 0"] = log_gaps(f"{name} (bf16, gates 0)", model.codes,
                                    *layer_gaps(torch, model, params, tokens,
                                                pool, img))
    for g, k in zip(gates, kept):
        g.copy_(k)
    del p32, params
    gc.collect()
    torch.cuda.empty_cache()
    stats["logits_f32"] = check_logits(
        "llama-3.2-vision-11b (f32, full depth)", out32, c32,
        ("flex_prefill/tf32x3", "paged_decode"), MODEL_TOL)
    stats["logits"] = check_logits(
        "llama-3.2-vision-11b (bf16, full depth)", out16, c16,
        ("flex_prefill/tc", "paged_decode"), BF16_MODEL_TOL, rel=True)
    want = out32["ref"]
    scale = 1 + float(want.abs().max())
    stats["logits"]["to_f32_plain"] = {
        path: float((out16[impl] - want).abs().max()) / scale
        for path, impl in (("bf16 kernel", "kernel"), ("bf16 plain", "ref"))}
    stats["layer_gaps"] = gaps
    log(f"llama-3.2-vision-11b: distance from the f32 plain path, of (1 + "
        f"max|logit|): {stats['logits']['to_f32_plain']} (not checked)")
    return stats


def vlm_f32_check(torch):
    """llama-3.2-vision-11b at one unit (5 layers, CAAAA) in f32, the gates
    drawn from U(0.5, 1): a 1000-token prompt's prefill and two decode
    steps' logits through the kernels against the plain path, monolithic
    and chunked by 512 (``MODEL_TOL``); then 4 requests with their images
    on 4 slots through the paged engine, the contiguous baseline
    (``paged=False``) and the paged engine chunked by 512, with steps
    that hold first chunks beside resumes (the model's ``partial`` cross
    mode; K3, K1, K2): each engine's greedy tokens equal to the paged
    monolithic one's, and the logits of every token each request sampled
    within ``MODEL_TOL`` of that one's."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config("llama-3.2-vision-11b").replace(n_layers=5)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init_params(gen, torch.float32, dev)
    set_gates(torch, params, torch.Generator().manual_seed(SEED + 15))
    n, P = 1000, cfg.page_size
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    pool = (model.n_attn_layers, -(-(n + 2) // P), P, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    extras = images(torch, 4, cfg, SEED + 15, torch.float32)
    img = {"image_embeds": extras[0]["image_embeds"][None]}
    stats = {}
    for mode, chunk, must in (
            ("monolithic", None, ("flex_prefill/tf32x3", "paged_decode")),
            ("chunked 512", 512, ("paged_prefill/tf32x3", "paged_decode"))):
        out, counts = logits_pair(torch, model, params, tokens, pool, chunk,
                                  extra=img)
        stats[mode] = check_logits(f"llama-3.2-vision-11b f32 one unit "
                                   f"({mode})", out, counts, must, MODEL_TOL)

    # the contiguous baseline and the chunked engine against the paged
    # monolithic engine
    rng = torch.Generator().manual_seed(SEED + 3)
    plens = torch.randint(100, 700, (4,), generator=rng).tolist()
    toks = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
            for n in plens]
    runs = {}
    for name, kw in (("paged", {}), ("contiguous", dict(paged=False)),
                     ("chunked 512", dict(prefill_chunk=512))):
        eng = Engine(cfg, params, max_slots=4, max_seq_len=1024, seed=SEED,
                     **kw)
        record_rows(eng)
        kinds = chunk_kinds(eng) if "prefill_chunk" in kw else None
        rs = [Request(prompt=list(p), max_new_tokens=8) for p in toks]
        kernels.reset_launch_counts()
        eng.generate(rs, extras)
        runs[name] = dict(tokens=[r.output for r in rs],
                          rows=[torch.stack(eng.by_request[id(r)])
                                for r in rs],
                          launches=kernels.launch_counts(), kinds=kinds)
        if kinds is not None:
            check_path(f"llama-3.2-vision-11b f32 one unit ({name} engine)",
                       eng, rs, 8, runs[name]["launches"],
                       must=("paged_decode", "combine", "paged_prefill",
                             "paged_prefill/tf32x3"),
                       never=("flex_prefill",
                              *k3_routes_except("tf32x3")))
        del eng
    want = runs["paged"]
    for name, key in (("contiguous", "baseline"),
                      ("chunked 512", "chunked_engine")):
        got = runs[name]
        if got["tokens"] != want["tokens"]:
            fail(f"llama-3.2-vision-11b {name} engine (one unit, f32): "
                 f"greedy tokens {got['tokens']} != paged monolithic "
                 f"{want['tokens']}")
        err = max(float((a - b).abs().max())
                  for a, b in zip(got["rows"], want["rows"]))
        extra_note = ""
        if got["kinds"] is not None:
            n_mixed = sum(1 for f, r in got["kinds"] if f and r)
            extra_note = (f"; {n_mixed} of {len(got['kinds'])} chunk steps "
                          f"held first chunks beside resumes "
                          f"{got['kinds']}")
            if not n_mixed:
                fail(f"llama-3.2-vision-11b {name} engine (one unit, f32): "
                     f"no chunk step held a first chunk beside a resume "
                     f"({got['kinds']})")
        log(f"llama-3.2-vision-11b {name} engine (one unit, f32): greedy "
            f"tokens equal to the paged monolithic engine's "
            f"({sum(len(x) for x in want['tokens'])} tokens); logits of "
            f"every sampled token max|err| {err:.3e} (tol {MODEL_TOL:g})"
            f"{extra_note}; launches {got['launches']}")
        if err > MODEL_TOL:
            fail(f"llama-3.2-vision-11b {name} engine: logits beyond "
                 f"{MODEL_TOL}")
        stats[key] = dict(tokens_equal=True, logits_max_err=err,
                          launches=got["launches"], chunk_steps=got["kinds"])
    return stats


# -- the encoder-decoder and xLSTM families -----------------------------------
WHISPER_PARTS = ("encode", "attn_train", "cross_kv", "cross_attn")
XLSTM_PARTS = ("_mlstm_parallel", "_mlstm_last_state", "_slstm_scan",
               "mlstm_decode", "slstm_decode")


def set_tok(torch, params, seed):
    """Draw ``embed/tok`` at std 1.0 (the init's 0.02 beside whisper's
    sinusoidal positions of magnitude 1 lets the position, not the input,
    decide the tied unembedding)."""
    tok = params["embed"]["tok"]
    gen = torch.Generator(device=tok.device)
    gen.manual_seed(seed)
    tok.copy_(torch.randn(tok.shape, generator=gen, device=tok.device))


def frames(torch, n, cfg, seed, dtype):
    """``n`` random N(0, 1) (n_audio_frames, d_model) frame embeddings on
    the card, from ``seed``: the per-request extras of whisper."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [{"frames": torch.randn(
        (cfg.n_audio_frames, cfg.d_model), generator=gen, device=dev
    ).to(dtype)} for _ in range(n)]


def whisper_step_bytes(params):
    """Bytes of the weights a whisper decode step reads: every decoder
    layer's but its cross-attention K/V projections (used at prefill
    only), the final norm and the tied embedding as the unembedding."""
    from repro_torch.utils.tree import tree_leaves
    total = 0
    for p in params["dec"]:
        for k, v in p.items():
            if k == "cross_attn":
                v = {n: x for n, x in v.items() if n in ("wq", "wo")}
            total += sum(x.numel() * x.element_size() for x in tree_leaves(v))
    total += sum(x.numel() * x.element_size() for x in tree_leaves(params["ln_f"]))
    tok = params["embed"]["tok"]
    return total + tok.numel() * tok.element_size()


def check_encoder_passes(name, counts, passes, cfg, route):
    """K4 ran the full mask once per encoder layer and encoder pass, and
    (monolithic) causal & padding once per decoder layer and prefill."""
    got = counts.get(f"flex_prefill/{route}/full", 0)
    if got != cfg.n_encoder_layers * passes:
        fail(f"{name}: K4's full mask launched {got} times, not "
             f"{cfg.n_encoder_layers} per encoder pass x {passes} "
             f"({counts})")


def whisper_engine_phase(torch):
    """whisper-medium at full width and depth in bf16 (24 encoder and 24
    decoder layers, d_model 1024, 16 heads over 16: G 1, D 64, d_ff 4096
    ungated GELU, LayerNorm, sinusoidal positions, 1500 audio frames,
    vocab 51865; random weights from the seed, ``embed/tok`` at std 1.0),
    8 slots, max_seq_len 448 (its ``max_target_positions``), pages of 64:
    12 greedy requests, each with its own N(0, 1) (1500, 1024) frames and
    a prompt of 4..224 tokens, 64 new tokens each, monolithic (K4's full
    mask once per encoder layer and pass, causal & padding per decoder
    layer, both on the bf16 tile; K1, K2; K3 never); a profiled prefill
    and decode step with the encoder, its self-attention, the cross K/V
    projections and the cross-attention in columns of their own, K4's
    full mask timed alone at the encoder's shape; the dense
    cross-attention beside SDPA; then chunked by 128 (K3's bf16 tile, K4's
    full mask for the first chunks' encoder passes only, K1, K2), with
    steps that hold first chunks and resumes together; a request forked
    (the child's slot gets the parent's cross K/V); ``prefix_cache=True``
    refused; and a 224-token prompt's prefill and two decode steps'
    logits through the kernels in bf16 against the plain path on the
    weights in f32 (``BF16_MODEL_TOL`` of the logits' scale)."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import flex
    from repro_torch.errors import EngineConfigError
    from repro_torch.kernels.flex_attention.ops import flex_attention
    from repro_torch.models import attention
    from repro_torch.models.api import build_model
    from repro_torch.models.encdec import EncDecModel
    from repro_torch.serving import Engine, Request, Status
    from repro_torch.utils.tree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("whisper-medium")
    D, n_ctx = cfg.resolved_head_dim, cfg.max_target_positions
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, max_slots=8, max_seq_len=n_ctx, dtype=torch.bfloat16,
                 seed=SEED)
    set_tok(torch, eng.params, SEED + 23)
    params = eng.params
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    step_b = whisper_step_bytes(params)
    cross_b = sum(eng.state[k].numel() * eng.state[k].element_size()
                  for k in ("cross_k", "cross_v"))
    pool_b = eng.memory_report()["pool_bytes"]
    log(f"whisper-medium phase: {cfg.n_encoder_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} (G 1), D {D}, d_ff {cfg.d_ff} "
        f"({cfg.activation}), {cfg.n_audio_frames} audio frames, vocab "
        f"{cfg.vocab_size}, bf16 ({n_params / 1e9:.3f} B parameters, "
        f"{2 * n_params / 1e9:.2f} GB), 8 slots, max_seq_len {n_ctx}, pool "
        f"{eng.num_pages} pages of {cfg.page_size} ({pool_b / 1e9:.3f} GB), "
        f"cross state {cross_b / 1e9:.3f} GB; ready in "
        f"{time.perf_counter() - t0:.1f} s")
    new = 64
    rng = torch.Generator().manual_seed(SEED + 23)
    plens = torch.randint(4, n_ctx // 2 + 1, (12,), generator=rng).tolist()
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=new) for n in plens]
    extras = frames(torch, 12, cfg, SEED + 23, torch.bfloat16)
    kernels.reset_launch_counts()
    wall, prefill_ms, decode_ms = drive(torch, eng, reqs, extras=extras)
    counts = kernels.launch_counts()
    check_path("whisper-medium (monolithic)", eng, reqs, new, counts,
               must=("paged_decode", "combine", "flex_prefill",
                     "flex_prefill/tc", "flex_prefill/tc/full",
                     "flex_prefill/tc/causal&padding"),
               never=("paged_prefill", "flex_prefill/tf32x3"))
    check_encoder_passes("whisper-medium (monolithic)", counts,
                         len(prefill_ms), cfg, "tc")
    if counts["flex_prefill/tc/causal&padding"] != cfg.n_layers * len(
            prefill_ms):
        fail(f"whisper-medium (monolithic): K4's causal & padding launched "
             f"{counts['flex_prefill/tc/causal&padding']} times, not once "
             f"per decoder layer and prefill ({counts})")
    stats = {"monolithic": serve_stats(torch, reqs, wall, prefill_ms,
                                       decode_ms, counts)}
    m = stats["monolithic"]
    m["encoder_passes"] = len(prefill_ms)
    m["decode_bytes"] = dict(
        weights=step_b, cross_state=cross_b,
        bound_ms=1e3 * (step_b + cross_b) / HBM_BPS,
        weights_bound_ms=1e3 * step_b / HBM_BPS)
    m["pool_bytes"], m["cross_state_bytes"] = pool_b, cross_b
    log_serve("whisper-medium (monolithic)", m)
    log(f"whisper-medium: a decode step of 8 full slots reads "
        f"{step_b / 1e9:.3f} GB of decoder weights and {cross_b / 1e9:.3f} "
        f"GB of cross K/V (>= {m['decode_bytes']['bound_ms']:.3f} ms at "
        f"3.35 TB/s; the weights alone "
        f"{m['decode_bytes']['weights_bound_ms']:.3f} ms); the pool of "
        f"self-attention K/V is {pool_b / 1e9:.3f} GB beside "
        f"{cross_b / 1e9:.3f} GB of cross K/V")

    # where the time goes: the step that admits 8 fresh 224-token prompts
    # with their frames (encoder, prefill, first decode), then a decode
    # step; K4's full mask alone at the encoder's shape
    wextra = frames(torch, 8, cfg, SEED + 24, torch.bfloat16)
    for i in range(8):
        eng.add_request(Request(prompt=torch.randint(
            0, cfg.vocab_size, (n_ctx // 2,), generator=rng).tolist(),
            max_new_tokens=4), wextra[i])
    with annotated(torch, EncDecModel, "encode"), annotate_all(
            torch, attention, WHISPER_PARTS[1:]):
        stats["profile_prefill_step"] = profile_steps(
            torch, eng, 1, annotation=WHISPER_PARTS)
        stats["profile_decode_step"] = profile_steps(
            torch, eng, 1, annotation=WHISPER_PARTS)
    for name in ("prefill_step", "decode_step"):
        log_profile(f"whisper-medium {name}", stats["profile_" + name])
    check_attributed("whisper-medium prefill_step",
                     stats["profile_prefill_step"], "K4 flex_prefill")
    check_attributed("whisper-medium decode_step",
                     stats["profile_decode_step"], "K1 paged_decode")
    while eng.scheduler.running:
        eng.step()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    q, k, v = (torch.randn((8, cfg.n_heads, cfg.n_audio_frames, D),
                           generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    full = device_ms(torch, lambda: flex_attention(
        q, k, v, mask_mod=flex.full_mask), kernel_name("flex_prefill_tc"),
        reps=3)
    del q, k, v
    stats["k4_full_mask_ms_per_layer"] = full
    log(f"whisper-medium: K4's full mask at the encoder's shape (8 x 16 "
        f"heads x {cfg.n_audio_frames} frames, D {D}, bf16) device "
        f"{fmt(full)} per layer, x {cfg.n_encoder_layers} layers per "
        f"encoder pass")
    stats["cross_attention"] = cross_attention_times(torch, cfg, eng,
                                                     prefill_q=n_ctx // 2)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # chunked by 128: a step's budget holds one request's last chunk and
    # the next one's first (the model's partial cross mode)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_slots=8, max_seq_len=n_ctx,
                 dtype=torch.bfloat16, seed=SEED, prefill_chunk=128)
    mixed = chunk_kinds(eng)
    creqs = [Request(prompt=list(r.prompt), max_new_tokens=new)
             for r in reqs]
    kernels.reset_launch_counts()
    wall, chunk_ms, dms = drive(torch, eng, creqs, extras=extras)
    counts = kernels.launch_counts()
    check_path("whisper-medium (chunked 128)", eng, creqs, new, counts,
               must=("paged_decode", "combine", "paged_prefill",
                     "paged_prefill/tc", "flex_prefill/tc/full"),
               never=("flex_prefill/tc/causal&padding",
                      "flex_prefill/tf32x3", *k3_routes_except("tc")))
    check_encoder_passes("whisper-medium (chunked 128)", counts,
                         sum(1 for f, _ in mixed if f), cfg, "tc")
    n_mixed = sum(1 for f, r in mixed if f and r)
    if not n_mixed:
        fail(f"whisper-medium (chunked): no chunk step held a first chunk "
             f"beside a resume ({mixed})")
    stats["chunked"] = serve_stats(torch, creqs, wall, chunk_ms, dms, counts)
    stats["chunked"]["steps_first_and_resume"] = n_mixed
    stats["chunked"]["agree_with_monolithic"] = sum(
        a.output == b.output for a, b in zip(reqs, creqs))
    log_serve("whisper-medium (chunked 128)", stats["chunked"])
    log(f"whisper-medium (chunked): {n_mixed} of {len(mixed)} chunk steps "
        f"held first chunks beside resumes; "
        f"{stats['chunked']['agree_with_monolithic']} of 12 requests' "
        f"greedy tokens equal to the monolithic run's (bf16, K3 against K4 "
        f"and the closed-form positions against the table: not checked; "
        f"the f32 check holds the chunked engine's tokens)")

    # fork: the child's slot gets the parent's cross K/V
    parent = Request(prompt=list(reqs[0].prompt), max_new_tokens=8)
    eng.add_request(parent, extras[0])
    while parent.status is not Status.RUNNING or not parent.output:
        eng.step()
    kernels.reset_launch_counts()
    child = eng.fork_request(parent, max_new_tokens=8)
    same = all(torch.equal(eng.state[k][:, child.slot],
                           eng.state[k][:, parent.slot])
               for k in ("cross_k", "cross_v"))
    while not (parent.done and child.done):
        eng.step()
    fcounts = kernels.launch_counts()
    if not same or child.status is not Status.FINISHED:
        fail(f"whisper-medium fork: cross rows copied {same}, child "
             f"{child.status}")
    stats["fork"] = dict(cross_rows_equal=same, child=child.output,
                         parent=parent.output, launches=fcounts)
    log(f"whisper-medium fork: the child's cross K/V equal the parent's; "
        f"child tokens {child.output}, parent {parent.output}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    try:
        Engine(cfg, params, max_slots=2, max_seq_len=n_ctx,
               dtype=torch.bfloat16, prefix_cache=True)
    except EngineConfigError as e:
        log(f"whisper-medium: prefix_cache=True refused: {e}")
    else:
        fail("whisper-medium: prefix_cache=True was not refused")

    # the logits at full depth: the kernels in bf16 against the plain path
    # on the same weights in f32
    n = n_ctx // 2
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    model = build_model(cfg)
    pool = (model.n_attn_layers, -(-(n + 2) // cfg.page_size),
            cfg.page_size, cfg.n_kv_heads, D)
    fr = {"frames": extras[1]["frames"][None]}
    p32 = tree_map(lambda x: x.float(), params)
    out, lcounts = logits_pair(torch, model, params, tokens, pool, extra=fr,
                               ref_params=p32)
    del p32, params
    gc.collect()
    torch.cuda.empty_cache()
    stats["logits"] = check_logits(
        "whisper-medium (bf16 kernels vs f32 plain, full depth)", out,
        lcounts, ("flex_prefill/tc/full", "flex_prefill/tc/causal&padding",
                  "paged_decode"), BF16_MODEL_TOL, rel=True)
    return stats


def engines_agree(name, runs, want_key, tol):
    """Each engine run's greedy tokens equal ``runs[want_key]``'s, and the
    logits of every token each request sampled within ``tol`` of that
    run's."""
    want = runs[want_key]
    out = {}
    for key, got in runs.items():
        if key == want_key:
            continue
        if got["tokens"] != want["tokens"]:
            fail(f"{name} {key}: greedy tokens {got['tokens']} != "
                 f"{want_key} {want['tokens']}")
        err = max(float((a - b).abs().max())
                  for a, b in zip(got["rows"], want["rows"]))
        scale = max(float(b.abs().max()) for b in want["rows"])
        log(f"{name} {key}: greedy tokens equal to the {want_key} run's "
            f"({sum(len(x) for x in want['tokens'])} tokens); logits of "
            f"every sampled token max|err| {err:.3e} (tol {tol:g}; "
            f"max|logit| {scale:.3f}); launches {got['launches']}")
        if err > tol:
            fail(f"{name} {key}: logits beyond {tol}")
        out[key] = dict(tokens_equal=True, logits_max_err=err,
                        launches=got["launches"])
    return out


def whisper_f32_check(torch):
    """whisper-medium at full width and 4 + 4 layers in f32
    (``embed/tok`` at std 1.0): a 224-token prompt's prefill and two
    decode steps' logits through the kernels against the plain path,
    monolithic and chunked by 128 (``MODEL_TOL``); then 4 requests with their
    frames on 4 slots through the paged engine, the contiguous baseline
    (``paged=False``) and the paged engine chunked by 128: the greedy
    tokens of both equal to the paged monolithic engine's, and the
    logits of every token each request sampled within ``MODEL_TOL``."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config("whisper-medium").replace(n_layers=4,
                                               n_encoder_layers=4)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init_params(gen, torch.float32, dev)
    set_tok(torch, params, SEED + 25)
    n, P = cfg.max_target_positions // 2, cfg.page_size
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    pool = (model.n_attn_layers, -(-(n + 2) // P), P, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    extras = frames(torch, 4, cfg, SEED + 25, torch.float32)
    fr = {"frames": extras[0]["frames"][None]}
    stats = {}
    for mode, chunk, must in (
            ("monolithic", None, ("flex_prefill/tf32x3/full",
                                  "flex_prefill/tf32x3/causal&padding",
                                  "paged_decode")),
            ("chunked 128", 128, ("flex_prefill/tf32x3/full",
                                  "paged_prefill/tf32x3", "paged_decode"))):
        out, counts = logits_pair(torch, model, params, tokens, pool, chunk,
                                  extra=fr)
        stats[mode] = check_logits(f"whisper-medium f32 4 + 4 layers "
                                   f"({mode})", out, counts, must,
                                   MODEL_TOL)
    rng = torch.Generator().manual_seed(SEED + 5)
    plens = torch.randint(4, n + 1, (4,), generator=rng).tolist()
    toks = [torch.randint(0, cfg.vocab_size, (k,), generator=rng).tolist()
            for k in plens]
    runs = {}
    for name, kw in (("paged", {}), ("contiguous", dict(paged=False)),
                     ("chunked 128", dict(prefill_chunk=128))):
        eng = Engine(cfg, params, max_slots=4,
                     max_seq_len=cfg.max_target_positions, seed=SEED, **kw)
        record_rows(eng)
        kinds = chunk_kinds(eng) if "prefill_chunk" in kw else None
        rs = [Request(prompt=list(p), max_new_tokens=8) for p in toks]
        kernels.reset_launch_counts()
        eng.generate(rs, extras)
        runs[name] = dict(tokens=[r.output for r in rs],
                          rows=[torch.stack(eng.by_request[id(r)])
                                for r in rs],
                          launches=kernels.launch_counts())
        never = ("paged_decode", "paged_prefill") if kw.get(
            "paged") is False else ()
        check_path(f"whisper-medium f32 4 + 4 layers ({name} engine)", eng,
                   rs, 8, runs[name]["launches"],
                   must=(("flex_prefill/tf32x3/full",)
                         + (() if never else ("paged_decode",))
                         + (("paged_prefill/tf32x3",) if kinds is not None
                            else ())),
                   never=never)
        del eng
    stats["engines"] = engines_agree("whisper-medium f32 4 + 4 layers",
                                     runs, "paged", MODEL_TOL)
    stats["engine_launches"] = {k: r["launches"] for k, r in runs.items()}
    return stats


def xlstm_times(torch, cfg, params, B, S, dtype):
    """Device ms of one mLSTM layer's parallel form, its final states and
    one sLSTM layer's scan over (B, S) inputs of the model's dtype, by
    events."""
    from repro_torch.models import ssm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(dtype)
    lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    codes = cfg.pattern()
    pm = params["layers"][codes.index("M")]["rec"]
    ps = params["layers"][codes.index("S")]["rec"]
    parts = ssm._mlstm_parts(pm, x, cfg)
    out = dict(
        mlstm_parallel_ms=time_ms(torch, lambda: ssm._mlstm_parallel(
            pm, x, *parts), reps=3),
        mlstm_last_state_ms=time_ms(torch, lambda: ssm._mlstm_last_state(
            parts[1], parts[2], parts[3], parts[4], lens), reps=3))
    inputs = ssm._slstm_inputs(ps, x)
    state = ssm.slstm_init_state(B, cfg, dtype, dev)
    out["slstm_scan_ms"] = time_ms(torch, lambda: ssm._slstm_scan(
        ps, state, inputs, lens), reps=2, warmup=1)
    return out


def xlstm_engine_phase(torch):
    """xlstm-350m at full width and depth in bf16 (24 blocks of pattern
    MMMMMMMS: 21 mLSTM and 3 sLSTM, d_model 1024, 4 heads of 256, no FFN,
    vocab 50304; random weights from the seed, ``embed/tok`` at std 1.0),
    8 slots, max_seq_len 2048, the config's contiguous state (no
    attention layer: no pool): 12 greedy requests of 256..1536 tokens in
    mixed-length waves, 32 new tokens each.  No kernel launches (the
    blocks are plain PyTorch, as the JAX package's are plain jnp).  tok/s,
    TTFT, peak memory, the recurrent state's bytes; a profiled prefill
    step (8 prompts of 512 tokens) and decode step with the mLSTM parallel
    form, its final states, the sLSTM scan and both blocks' decode in
    columns of their own; and those three parts timed alone at 8 x
    1536."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.serving import Engine, Request
    from repro_torch.utils.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("xlstm-350m")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, max_slots=8, max_seq_len=2048, dtype=torch.bfloat16,
                 seed=SEED)
    set_tok(torch, eng.params, SEED + 26)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(eng.params))
    rec_b = rec_state_bytes(eng)
    step_b = weight_bytes(eng.params)
    log(f"xlstm-350m phase: {cfg.n_layers} blocks of pattern "
        f"{cfg.layer_pattern} ({cfg.pattern().count('M')} mLSTM, "
        f"{cfg.pattern().count('S')} sLSTM), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.d_model // cfg.n_heads}, vocab "
        f"{cfg.vocab_size}, bf16 ({n_params / 1e9:.3f} B parameters, "
        f"{2 * n_params / 1e9:.2f} GB), 8 slots, max_seq_len 2048, paged "
        f"{eng.paged}; recurrent state {rec_b / 1e6:.2f} MB; ready in "
        f"{time.perf_counter() - t0:.1f} s")
    new = 32
    rng = torch.Generator().manual_seed(SEED + 26)
    plens = torch.randint(256, 1537, (12,), generator=rng).tolist()
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=new) for n in plens]
    kernels.reset_launch_counts()
    wall, prefill_ms, decode_ms = drive(torch, eng, reqs)
    counts = kernels.launch_counts()
    check_path("xlstm-350m", eng, reqs, new, counts, must=(),
               never=("paged_decode", "combine", "paged_prefill",
                      "flex_prefill"))
    stats = {"monolithic": serve_stats(torch, reqs, wall, prefill_ms,
                                       decode_ms, counts)}
    m = stats["monolithic"]
    m["rec_state_bytes"] = rec_b
    m["decode_bytes"] = dict(weights=step_b, rec_state=rec_b,
                             bound_ms=1e3 * (step_b + 2 * rec_b) / HBM_BPS)
    log_serve("xlstm-350m", m)
    log(f"xlstm-350m: a decode step reads {step_b / 1e9:.3f} GB of weights "
        f"and reads and writes {rec_b / 1e6:.1f} MB of recurrent state (>= "
        f"{m['decode_bytes']['bound_ms']:.3f} ms at 3.35 TB/s)")
    for _ in range(8):
        eng.add_request(Request(prompt=torch.randint(
            0, cfg.vocab_size, (512,), generator=rng).tolist(),
            max_new_tokens=4))
    with annotate_all(torch, ssm, XLSTM_PARTS):
        stats["profile_prefill_step"] = profile_steps(
            torch, eng, 1, annotation=XLSTM_PARTS)
        stats["profile_decode_step"] = profile_steps(
            torch, eng, 1, annotation=XLSTM_PARTS)
    for name in ("prefill_step", "decode_step"):
        log_profile(f"xlstm-350m {name}", stats["profile_" + name])
    while eng.scheduler.running:
        eng.step()
    stats["parts_8x1536"] = xlstm_times(torch, cfg, eng.params, 8, 1536,
                                        torch.bfloat16)
    t = stats["parts_8x1536"]
    log(f"xlstm-350m at 8 x 1536 in bf16, per layer: mLSTM parallel form "
        f"{t['mlstm_parallel_ms']:.3f} ms, its final states "
        f"{t['mlstm_last_state_ms']:.3f} ms (x {cfg.pattern().count('M')} "
        f"layers), sLSTM scan {t['slstm_scan_ms']:.3f} ms (x "
        f"{cfg.pattern().count('S')})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def xlstm_f32_check(torch):
    """xlstm-350m at full width and one unit (8 blocks, MMMMMMMS) in f32
    (``embed/tok`` at std 1.0): (a) a wave of 4 requests of 300, 800,
    1300 and 1536 tokens on 4 slots, 8 greedy tokens: each request's
    tokens and sampled logits equal those it gets served alone (its state
    is taken at its own last token, not at the padded end); (b) the
    logits of ``prefill`` over 1000 tokens followed by one decode step
    equal the last logits of ``prefill`` over the same 1001 tokens
    within ``MODEL_TOL`` (the closed-form mLSTM state and the sLSTM
    state carried into the recurrence equal the parallel form)."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = get_config("xlstm-350m").replace(n_layers=8)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init_params(gen, torch.float32, dev)
    set_tok(torch, params, SEED + 27)
    rng = torch.Generator().manual_seed(SEED + 27)
    toks = [torch.randint(0, cfg.vocab_size, (k,), generator=rng).tolist()
            for k in (300, 800, 1300, 1536)]
    kernels.reset_launch_counts()
    runs = {}
    for name, prompts in [("wave", toks)] + [(f"alone {i}", [p])
                                             for i, p in enumerate(toks)]:
        eng = Engine(cfg, params, max_slots=4, max_seq_len=2048, seed=SEED)
        record_rows(eng)
        rs = [Request(prompt=list(p), max_new_tokens=8) for p in prompts]
        eng.generate(rs)
        runs[name] = dict(tokens=[r.output for r in rs],
                          rows=[torch.stack(eng.by_request[id(r)])
                                for r in rs])
        del eng
    alone = dict(tokens=[runs[f"alone {i}"]["tokens"][0]
                         for i in range(4)],
                 rows=[runs[f"alone {i}"]["rows"][0] for i in range(4)])
    counts = kernels.launch_counts()
    stats = {"mixed_wave": engines_agree(
        "xlstm-350m f32 one unit", {"alone": alone, "mixed wave": dict(
            runs["wave"], launches=counts)}, "alone", MODEL_TOL)}
    # (b) prefill(S) + one decode step against prefill(S + 1)
    S = 1000
    tokens = torch.randint(0, cfg.vocab_size, (1, S + 1), generator=gen,
                           device=dev)
    st = {"pos": torch.zeros((1,), dtype=torch.int32, device=dev)}
    _, st1 = model.prefill(params, tokens[:, :S], dict(st))
    step, _ = model.decode_step(params, tokens[:, S], st1)
    whole, _ = model.prefill(params, tokens, dict(st))
    err = float((step - whole).abs().max())
    scale = float(whole.abs().max())
    log(f"xlstm-350m f32 one unit: prefill({S}) + a decode step vs "
        f"prefill({S + 1}), last logits: max|err| {err:.3e} (tol "
        f"{MODEL_TOL:g}; max|logit| {scale:.3f}); argmax equal "
        f"{bool(step.argmax() == whole.argmax())}")
    if not bool(torch.isfinite(step).all()) or err > MODEL_TOL:
        fail(f"xlstm-350m f32: prefill + decode logits max|err| {err} "
             f"beyond {MODEL_TOL}")
    stats["prefill_then_decode"] = dict(max_err=err, scale=scale)
    return stats


TRAIN_STEPS, TRAIN_WARM = 30, 2
# the loss must fall by this much (nats) from the mean of the first 5
# steps to the mean of the last 5 (fixed before the first run)
TRAIN_MARGIN = 1.0
NLL_TOL = 1e-4  # teacher-forced against paged-decode NLL, f32
TRAIN_PARTS = ("_chunked_attention", "adamw_update", "clip_by_global_norm")


class StepClock:
    """``on_step`` hook of ``train_loop``: a CUDA event after every step
    (step i takes the device time between the events of steps i - 1 and
    i), and the step's metrics kept as device tensors (read after the
    run, so the loop does not wait for the card)."""

    def __init__(self, torch):
        self.torch, self.events, self.metrics = torch, [], []

    def __call__(self, i, state, metrics):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        self.metrics.append(metrics)

    def step_ms(self, warm):
        self.torch.cuda.synchronize()
        return [self.events[i - 1].elapsed_time(self.events[i])
                for i in range(max(warm, 1), len(self.events))]

    def series(self, key):
        return [float(m[key]) for m in self.metrics]


def train_flops(cfg, B, S):
    """Matmul operations of one training step (forward + backward = 3 x
    the forward's 2 per multiply-add) of a dense model: every layer's
    projections and MLP, the attention's two products over all S x S
    pairs (the plain and chunked paths skip no tile), the unembedding."""
    d, H, D, f = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.d_ff
    Hkv = cfg.n_kv_heads
    proj = d * (H + 2 * Hkv) * D + H * D * d + 3 * d * f
    attn = 2 * H * S * D  # per token: q.K and p.V over S keys
    fwd = 2 * B * S * (cfg.n_layers * (proj + attn) + d * cfg.vocab_size)
    return 3 * fwd


def grad_pass(torch, model, params, batch, impl):
    """(loss, global grad norm) of one forward and backward."""
    from repro_torch.training.optimizer import clip_by_global_norm
    from repro_torch.utils.tree import tree_leaves, tree_map
    p = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss, _ = model.loss_fn(p, batch, impl=impl)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves)
    _, gnorm = clip_by_global_norm(list(grads), 1.0)
    return float(loss.detach()), float(gnorm)


def attention_fwd_bwd_ms(torch, cfg, B, S):
    """Device ms of one layer's chunked attention forward and backward at
    the training shape, by events."""
    from repro_torch.core import attention as core_attn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.randn((B, S, H, D), generator=gen, device=dev,
                    requires_grad=True)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                    requires_grad=True)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev,
                    requires_grad=True)
    g = torch.randn((B, S, H, D), generator=gen, device=dev)

    def fwd_bwd():
        o = core_attn.prefill_attention(q, k, v, impl="chunked")
        torch.autograd.grad(o, (q, k, v), g)
    return time_ms(torch, fwd_bwd, reps=5)


def train_llama_phase(torch):
    """llama2-7b at full width and 4 layers in f32 (1.07 B parameters,
    17.2 GB of params, grads and AdamW moments): 30 steps of the launcher's
    path (``launch.train.train``: ``synthetic_batches(4, 512, 32000,
    seed=0)``, the chunked attention, lr 3e-4); every loss finite, the
    mean of the last 5 below the mean of the first 5 by ``TRAIN_MARGIN``;
    no kernel launched.  Step ms by CUDA events (median after 2 warm
    steps), tok/s, peak memory, one profiled step by kind (the chunked
    attention's forward, the optimizer and the clipping in columns of
    their own) and one layer's attention forward + backward alone.
    Returns (stats, the trained params, the model)."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import attention as core_attn
    from repro_torch.data import synthetic_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.models.api import build_model
    from repro_torch.training import loop
    from repro_torch.training.loop import make_train_step, to_device
    from repro_torch.utils.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama2-7b").replace(n_layers=4)
    B, S, lr = 4, 512, 3e-4
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    clock = StepClock(torch)
    t0 = time.perf_counter()
    state, _ = launch_train.train(cfg, steps=TRAIN_STEPS, batch=B, seq=S,
                                  lr=lr, impl="chunked",
                                  log_every=TRAIN_STEPS, log_fn=log,
                                  on_step=clock)
    times = clock.step_ms(TRAIN_WARM)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    losses = clock.series("loss")
    gnorms = clock.series("grad_norm")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    step_ms = statistics.median(times)
    flops = train_flops(cfg, B, S)
    stats = dict(
        config=f"llama2-7b, 4 layers, f32, B {B} x S {S}, lr {lr}, chunked",
        params=n_params, steps=TRAIN_STEPS, losses=losses, grad_norms=gnorms,
        first5=first, last5=last, margin=TRAIN_MARGIN,
        step_ms=step_ms, step_ms_all=times, tokens_per_s=B * S * 1e3 / step_ms,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, wall_s=wall,
        flops=flops, bound_ms=1e3 * flops / PEAK_OPS["float32"],
        launches=counts)
    log(f"train llama2-7b (4 layers, f32, {n_params / 1e9:.3f} B params): "
        f"{TRAIN_STEPS} steps in {wall:.1f} s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (first 5 {first:.4f}, last 5 {last:.4f}, margin "
        f"{TRAIN_MARGIN}); step {step_ms:.2f} ms (median of "
        f"{len(times)} after {TRAIN_WARM} warm; {min(times):.2f}-"
        f"{max(times):.2f}), {stats['tokens_per_s']:.0f} tok/s, bound "
        f"{stats['bound_ms']:.2f} ms ({flops / 1e12:.2f} TFLOP at 67 "
        f"TFLOP/s), peak {stats['peak_gb']:.2f} GB; launches {counts}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"train llama2-7b: non-finite loss or grad norm {losses}")
    if not first - last >= TRAIN_MARGIN:
        fail(f"train llama2-7b: the loss fell by {first - last:.4f}, less "
             f"than {TRAIN_MARGIN}")
    if any(counts[k] for k in ("paged_decode", "combine", "paged_prefill",
                               "flex_prefill")):
        fail(f"train llama2-7b: a kernel launched while training: {counts}")
    # one profiled step: the chunked attention's forward and the optimizer
    # in columns of their own (the backward's kernels by name)
    model = build_model(cfg)
    step_fn = make_train_step(model, lr=lr, impl="chunked")
    data = synthetic_batches(B, S, cfg.vocab_size, seed=SEED + 1)
    box = {"state": state}

    def one_step():
        box["state"], _ = step_fn(box["state"], to_device(next(data),
                                                          "cuda"))
    one_step()
    with contextlib.ExitStack() as stack:
        stack.enter_context(annotated(torch, core_attn,
                                      "_chunked_attention"))
        stack.enter_context(annotated(torch, loop, "adamw_update"))
        stack.enter_context(annotated(torch, loop, "clip_by_global_norm"))
        stats["profile_step"] = profile_steps(
            torch, types.SimpleNamespace(step=one_step), 1,
            annotation=TRAIN_PARTS)
    log_profile("train llama2-7b step", stats["profile_step"])
    by = stats["profile_step"]["by_kind"]
    busy = stats["profile_step"]["device_ms"] or 0.0
    stats["split_ms"] = dict(
        matmul=by["matmul"], attention_forward=by["_chunked_attention"],
        optimizer=by["adamw_update"] + by["clip_by_global_norm"],
        other=busy - by["matmul"] - by["_chunked_attention"]
        - by["adamw_update"] - by["clip_by_global_norm"])
    stats["busy_share"] = busy / step_ms
    log(f"train llama2-7b step by kind (device ms): "
        f"{ {k: round(v, 2) for k, v in stats['split_ms'].items()} }, busy "
        f"{busy:.2f} ms = {stats['busy_share']:.3f} of the {step_ms:.2f} ms "
        f"step (events; the profiler stretches its own wall); the "
        f"backward's kernels are filed by name (matmul or other)")
    stats["attention_fwd_bwd_ms_per_layer"] = attention_fwd_bwd_ms(
        torch, cfg, B, S)
    log(f"train llama2-7b: one layer's chunked attention forward + "
        f"backward at B {B} x S {S}: "
        f"{stats['attention_fwd_bwd_ms_per_layer']:.3f} ms (x "
        f"{cfg.n_layers} layers)")
    params = box["state"].params
    del state, box
    gc.collect()
    torch.cuda.empty_cache()
    return stats, params, model


@contextlib.contextmanager
def dropped_first_page(torch):
    """A planted fault in paged decode: once a row has passed its first
    page, the decode attention (K1/K2) skips that page, as a kernel that
    lost one page of keys would (its table rolled by one page, its length
    less one page)."""
    from repro_torch.core import attention as core_attn
    real = core_attn.decode_attention

    def faulty(q, k_pages, v_pages, tables, lens, **kw):
        P = k_pages.shape[1]
        past = lens > P
        tables = torch.where(past[:, None], tables.roll(-1, dims=1), tables)
        lens = torch.where(past, lens - P, lens)
        return real(q, k_pages, v_pages, tables, lens, **kw)

    core_attn.decode_attention = faulty
    try:
        yield
    finally:
        core_attn.decode_attention = real


def train_eval_phase(torch, model, params):
    """On the trained llama2-7b weights (f32): (a) ``"ref"`` against
    ``"chunked"`` on one B 1 x S 2048 batch (4 q tiles x 2 kv tiles):
    loss within 1e-5 and the global grad norm within 1e-4, relative; (b)
    K4 without grad: ``forward(impl="kernel")`` logits (the f32 route
    ``flex_prefill/tf32x3``) against ``impl="ref"`` within ``MODEL_TOL``
    on a B 4 x S 512 batch, then the weights cast to bf16 (route ``tc``)
    against the f32 plain forward within ``BF16_MODEL_TOL`` of the
    logits' scale; (c) the paper's §IV-B3 check: two held-out 256-token
    sequences (``synthetic_batches``, seed 9) scored teacher-forced
    through K4, by prefill of the first token and paged decode steps
    through K1/K2 (pages of 64), and by the plain forward: the mean NLLs
    within ``NLL_TOL``; then a planted fault (``dropped_first_page``) must
    move the paged-decode NLL by more than ``NLL_TOL``."""
    from repro_torch import kernels
    from repro_torch.data import synthetic_batches
    from repro_torch.training.evaluate import (paged_decode_nll,
                                               teacher_forced_nll)
    from repro_torch.training.loop import to_device
    from repro_torch.utils.tree import tree_map

    cfg = model.cfg
    stats = {}
    batch = to_device(next(synthetic_batches(1, 2048, cfg.vocab_size,
                                             seed=SEED + 2)), "cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    got = {impl: grad_pass(torch, model, params, batch, impl)
           for impl in ("ref", "chunked")}
    (lr_, gr), (lc, gc_) = got["ref"], got["chunked"]
    stats["ref_vs_chunked"] = dict(
        ref=got["ref"], chunked=got["chunked"],
        loss_rel=abs(lc - lr_) / abs(lr_), gnorm_rel=abs(gc_ - gr) / abs(gr),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=kernels.launch_counts())
    r = stats["ref_vs_chunked"]
    log(f"train eval: B 1 x S 2048, ref loss {lr_:.6f} gnorm {gr:.6f}, "
        f"chunked loss {lc:.6f} gnorm {gc_:.6f}: rel {r['loss_rel']:.3e} "
        f"(tol 1e-5), {r['gnorm_rel']:.3e} (tol 1e-4); peak "
        f"{r['peak_gb']:.2f} GB")
    if not r["loss_rel"] <= 1e-5 or not r["gnorm_rel"] <= 1e-4:
        fail("train eval: ref and chunked disagree")
    if any(r["launches"][k] for k in ("paged_decode", "combine",
                                      "paged_prefill", "flex_prefill")):
        fail(f"train eval: a kernel launched under autograd: "
             f"{r['launches']}")
    # (b) K4 forward without grad
    tokens = torch.as_tensor(next(synthetic_batches(
        4, 512, cfg.vocab_size, seed=SEED + 3))["inputs"], device="cuda")
    kernels.reset_launch_counts()
    with torch.no_grad():
        want, _ = model.forward(params, tokens, impl="ref")
        f32, _ = model.forward(params, tokens, impl="kernel")
        c_f32 = kernels.launch_counts()
        bf = tree_map(lambda x: x.to(torch.bfloat16), params)
        kernels.reset_launch_counts()
        b16, _ = model.forward(bf, tokens, impl="kernel")
        c_b16 = kernels.launch_counts()
        del bf
    scale = float(want.abs().max())
    e32 = float((f32 - want).abs().max())
    e16 = float((b16.float() - want).abs().max())
    stats["k4_forward"] = dict(f32_err=e32, bf16_err=e16, scale=scale,
                               bf16_bound=BF16_MODEL_TOL * (1 + scale),
                               launches_f32=c_f32, launches_bf16=c_b16)
    log(f"train eval: forward B 4 x S 512, K4 (tf32x3) vs plain f32 logits "
        f"max|err| {e32:.3e} (tol {MODEL_TOL:g}; max|logit| {scale:.3f}); "
        f"bf16 weights on K4 (tc) vs f32 plain {e16:.3e} (bound "
        f"{BF16_MODEL_TOL * (1 + scale):.3e}); launches f32 "
        f"{c_f32['flex_prefill/tf32x3']}, bf16 {c_b16['flex_prefill/tc']}")
    if not (bool(torch.isfinite(f32).all()) and bool(
            torch.isfinite(b16).all())):
        fail("train eval: non-finite K4 logits")
    if e32 > MODEL_TOL or e16 > BF16_MODEL_TOL * (1 + scale):
        fail("train eval: K4 forward logits beyond tolerance")
    if (c_f32["flex_prefill/tf32x3"] != cfg.n_layers
            or c_b16["flex_prefill/tc"] != cfg.n_layers):
        fail(f"train eval: K4 launches {c_f32}, {c_b16}")
    del want, f32, b16
    # (c) perplexity equivalence
    toks = torch.as_tensor(next(synthetic_batches(
        2, 256, cfg.vocab_size, seed=9))["inputs"], device="cuda").long()
    kernels.reset_launch_counts()
    nll = dict(teacher_forced_k4=float(teacher_forced_nll(
                   model, params, toks, impl="kernel")),
               paged_decode_k1_k2=float(paged_decode_nll(
                   model, params, toks, page_size=64, impl="kernel")))
    counts = kernels.launch_counts()
    nll["plain_forward"] = float(teacher_forced_nll(model, params, toks,
                                                    impl="ref"))
    spread = max(nll.values()) - min(nll.values())
    stats["perplexity"] = dict(nll, spread=spread, tol=NLL_TOL,
                               launches=counts)
    log(f"train eval: held-out NLL (2 x 256, seed 9): teacher-forced K4 "
        f"{nll['teacher_forced_k4']:.6f}, paged decode K1/K2 "
        f"{nll['paged_decode_k1_k2']:.6f}, plain "
        f"{nll['plain_forward']:.6f}; spread {spread:.3e} (tol "
        f"{NLL_TOL:g}); launches {counts}")
    if not all(math.isfinite(x) for x in nll.values()) or spread > NLL_TOL:
        fail("train eval: the three NLLs disagree")
    must = ("paged_decode", "combine/decode", "flex_prefill/tf32x3")
    if any(counts[k] <= 0 for k in must) or counts["paged_prefill"]:
        fail(f"train eval: launches {counts}")
    # the check can fail: a paged decode that loses one page of keys
    with dropped_first_page(torch):
        faulty = float(paged_decode_nll(model, params, toks, page_size=64,
                                        impl="kernel"))
    moved = abs(faulty - nll["paged_decode_k1_k2"])
    stats["perplexity"].update(dropped_page=faulty, dropped_page_moved=moved)
    log(f"train eval: planted fault (K1/K2 skip each row's first page once "
        f"past it): paged-decode NLL {faulty:.6f}, moved {moved:.3e} "
        f"({moved / NLL_TOL:.1f} x NLL_TOL)")
    if not moved > NLL_TOL:
        fail("train eval: the NLL check does not see a dropped page")
    stats["launches"] = [c_f32, c_b16, counts]
    return stats


def train_moe_phase(torch):
    """granite-moe-1b-a400m at full width and depth in f32 (24 layers, 32
    experts top-8 at capacity 1.25; 1.3 B parameters), B 4 x S 512, 10
    steps of the launcher's path: the aux finite, ce falling (the mean of
    the last 3 below the first 3's); step ms (median after 2 warm),
    peak memory and the share of dropped expert choices."""
    import gc
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.utils.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("granite-moe-1b-a400m")
    B, S, steps = 4, 512, 10
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    clock = StepClock(torch)
    drops = DropCount(torch, slots=0)
    t0 = time.perf_counter()
    with drops.on():
        state, _ = launch_train.train(cfg, steps=steps, batch=B, seq=S,
                                      lr=3e-4, impl="chunked",
                                      log_every=steps, log_fn=log,
                                      on_step=clock)
    times = clock.step_ms(TRAIN_WARM)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ce, aux = clock.series("ce"), clock.series("aux")
    dropped, kept, live = drops.shares()["prefill"]
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    step_ms = statistics.median(times)
    stats = dict(params=n_params, ce=ce, aux=aux, step_ms=step_ms,
                 step_ms_all=times, tokens_per_s=B * S * 1e3 / step_ms,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 dropped_share=dropped, kept=kept, live=live, wall_s=wall,
                 launches=counts)
    log(f"train granite-moe-1b-a400m (full depth, f32, {n_params / 1e9:.3f} "
        f"B params, capacity {cfg.moe_capacity}): {steps} steps in "
        f"{wall:.1f} s; ce {ce[0]:.4f} -> {ce[-1]:.4f}, aux {aux[0]:.4f} -> "
        f"{aux[-1]:.4f}; step {step_ms:.2f} ms ({min(times):.2f}-"
        f"{max(times):.2f}), {stats['tokens_per_s']:.0f} tok/s, peak "
        f"{stats['peak_gb']:.2f} GB; dropped expert choices {dropped:.4f} "
        f"({live - kept} of {live})")
    if not all(math.isfinite(x) for x in ce + aux):
        fail("train granite-moe: non-finite ce or aux")
    if not statistics.mean(ce[-3:]) < statistics.mean(ce[:3]):
        fail(f"train granite-moe: ce did not fall: {ce}")
    if any(counts[k] for k in ("paged_decode", "combine", "paged_prefill",
                               "flex_prefill")):
        fail(f"train granite-moe: a kernel launched: {counts}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def train_phase(torch):
    """The training phase (after the xLSTM checks): llama2-7b at full width
    and 4 layers, its evaluation (ref against chunked, K4's forward, the
    perplexity equivalence through K4, K1 and K2), and granite-moe-1b-a400m
    at full width and depth."""
    t0 = time.perf_counter()
    llama, params, model = train_llama_phase(torch)
    evals = train_eval_phase(torch, model, params)
    del params
    moe = train_moe_phase(torch)
    out = dict(llama2_7b=llama, eval=evals, granite_moe=moe,
               seconds=time.perf_counter() - t0)
    log(f"training phase: {out['seconds']:.1f} s")
    return out


def headroom_pool(cfg, reqs, slots):
    """Tokens of a pool that holds the ``slots`` longest of ``reqs`` at
    their full length, each rounded up to whole pages, plus the
    scheduler's one page of headroom per slot: the live tokens, so that
    ``memory_report`` shows the paper's overhead and nothing preempts."""
    P = cfg.page_size
    pages = sorted(-(-(r.prompt_len + r.max_new_tokens) // P) for r in reqs)
    return (sum(pages[-slots:]) + slots) * P


def annotated(torch, module, name):
    """Context manager: calls of ``module.name`` run under a profiler
    range of that name (the baseline's decode attention, a plain-ops
    path whose kernels the profile files by kernel name otherwise)."""
    @contextlib.contextmanager
    def ctx():
        plain = getattr(module, name)

        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return plain(*a, **k)
        setattr(module, name, wrapped)
        try:
            yield
        finally:
            setattr(module, name, plain)
    return ctx()


def record_rows(eng):
    """Record the logits of every row the engine samples (prefill and
    decode), in call order: ``eng.sampled`` (a list of CPU tensors), and
    by request: ``eng.by_request[id(req)]`` (one row per token)."""
    eng.sampled, eng.by_request = [], {}
    plain = eng._sample_and_append

    def wrapped(reqs, logits, first):
        rows = logits.float().cpu()
        eng.sampled.append(rows)
        for r, row in zip(reqs, rows):
            eng.by_request.setdefault(id(r), []).append(row)
        return plain(reqs, logits, first)
    eng._sample_and_append = wrapped


def baseline_phase(torch, params):
    """The paper's comparison (Fig. 4, Figs. 1-2): full-width llama2-7b in
    bf16 (params of the engine phase), 8 slots, max_seq_len 2048, page 64,
    the engine phase's 12 prompts of 256..1536 tokens and 32 new tokens
    each, served twice: paged (K4, K1, K2) with a pool of the live tokens
    rounded up to whole pages, and as the contiguous baseline
    (``paged=False``: max-length buffers, K4 prefill, decode attention in
    plain ops; K1 and K3 never).  For each: decode ms per step, TTFT,
    ``memory_report`` at the step with the most live tokens, peak memory,
    and one profiled decode step by kind, the baseline's attention in a
    column of its own.  Then at 4 layers of full width in f32 both engines
    greedy on 6 prompts over 4 slots: equal tokens, and every sampled row's
    logits within ``MODEL_TOL`` of the paged engine's."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import attention as core_attn
    from repro_torch.serving import Engine, Request

    cfg = get_config("llama2-7b")
    n_req, new = 12, 32

    def prompts():  # the engine phase's prompts
        rng = torch.Generator().manual_seed(SEED)
        plens = torch.randint(256, 1537, (n_req,), generator=rng).tolist()
        return [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                             generator=rng).tolist(),
                        max_new_tokens=new) for n in plens]

    pool = headroom_pool(cfg, prompts(), 8)
    stats = {}
    for name, kw in (("paged", dict(pool_tokens=pool)),
                     ("contiguous", dict(paged=False))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, max_slots=8, max_seq_len=2048,
                     dtype=torch.bfloat16, seed=SEED, **kw)
        reqs = prompts()
        peak = {"live": -1}

        def on_step():
            live = sum(r.total_len for r in eng.scheduler.running.values())
            if live > peak["live"]:
                peak.update(live=live, report=eng.memory_report())
        kernels.reset_launch_counts()
        wall, prefill_ms, decode_ms = drive(torch, eng, reqs, on_step)
        counts = kernels.launch_counts()
        if name == "paged":
            check_path("baseline/paged", eng, reqs, new, counts,
                       must=("paged_decode", "combine", "flex_prefill",
                             "flex_prefill/tc"),
                       never=("paged_prefill", "flex_prefill/tf32x3"))
        else:
            check_path("baseline/contiguous", eng, reqs, new, counts,
                       must=("flex_prefill", "flex_prefill/tc"),
                       never=("paged_decode", "combine", "paged_prefill",
                              "flex_prefill/tf32x3"))
        ttft = sorted(r.metrics["ttft_s"] for r in reqs)
        st = dict(
            pool_tokens=pool if name == "paged" else None,
            wall_s=wall, ttft_s_p50=ttft[len(ttft) // 2],
            ttft_s_max=ttft[-1],
            decode_ms_per_step_median=statistics.median(decode_ms),
            decode_steps=len(decode_ms), prefill_ms_per_step=prefill_ms,
            preempted=eng.scheduler.preempted,
            memory_report=peak["report"], peak_live_tokens=peak["live"],
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=counts, outputs=[r.output for r in reqs])
        log(f"baseline/{name}: decode {st['decode_ms_per_step_median']:.2f} "
            f"ms/step (median of {len(decode_ms)}); TTFT p50 "
            f"{st['ttft_s_p50']:.3f} s max {st['ttft_s_max']:.3f} s; "
            f"prefill steps {[round(x) for x in prefill_ms]} ms; "
            f"preemptions {st['preempted']}; memory_report at "
            f"{peak['live']} live tokens {peak['report']}; "
            f"max_memory_allocated {st['max_memory_allocated_gb']:.2f} GB; "
            f"launches {counts}")
        # one profiled decode step, on a wave of 8 prompts of 1024 tokens
        rng = torch.Generator().manual_seed(SEED + 7)
        for _ in range(8):
            eng.add_request(Request(prompt=torch.randint(
                0, cfg.vocab_size, (1024,), generator=rng).tolist(),
                max_new_tokens=4))
        eng.step()  # their prefill and first decode
        torch.cuda.synchronize()
        with annotated(torch, core_attn, "decode_attention_contiguous"):
            st["profile_decode_step"] = profile_steps(
                torch, eng, 1, annotation="decode_attention_contiguous")
        log_profile(f"baseline/{name} decode_step",
                    st["profile_decode_step"])
        if "annotated_kernels" in st["profile_decode_step"]:
            log(f"baseline/{name}: its decode attention's kernels, ms per "
                f"step: {st['profile_decode_step']['annotated_kernels']}")
        if name == "contiguous":
            # the same attention timed alone by events, one layer's call at
            # this step's lengths, times the layers
            dev = torch.device("cuda")
            lens = eng.state["pos"].clone()
            q = torch.randn((8, cfg.n_heads, cfg.resolved_head_dim),
                            device=dev).to(torch.bfloat16)
            kb, vb = eng.state["k_buf"][0], eng.state["v_buf"][0]
            st["contiguous_attention_ms_per_layer"] = time_ms(
                torch, lambda: core_attn.decode_attention_contiguous(
                    q, kb, vb, lens))
            # the library yardstick: SDPA over the same buffers and rows
            # (the buffers are head-major, (B, Hkv, max_len, D), as SDPA
            # takes them)
            live = (torch.arange(kb.shape[2], device=dev)[None]
                    < lens[:, None])[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            st["sdpa_ms_per_layer"] = time_ms(
                torch, lambda: sdpa(q[:, :, None], kb, vb, attn_mask=live))
            log(f"baseline/contiguous: decode attention timed alone "
                f"{st['contiguous_attention_ms_per_layer']:.4f} ms per "
                f"layer x {cfg.n_layers} layers = "
                f"{st['contiguous_attention_ms_per_layer'] * cfg.n_layers:.3f}"
                f" ms per step (lens {lens.tolist()}); SDPA over the same "
                f"buffers {st['sdpa_ms_per_layer']:.4f} ms per layer")
        stats[name] = st
        del eng
    torch.cuda.empty_cache()

    # equal greedy tokens and logits within MODEL_TOL, 4 layers in f32
    cfg4 = cfg.replace(n_layers=4)
    rng = torch.Generator().manual_seed(SEED + 3)
    plens = torch.randint(100, 700, (6,), generator=rng).tolist()
    toks = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
            for n in plens]
    runs, params4 = {}, None
    for name, kw in (("paged", {}), ("contiguous", dict(paged=False))):
        eng = Engine(cfg4, params4, max_slots=4, max_seq_len=1024,
                     seed=SEED, **kw)
        params4 = eng.params
        record_rows(eng)
        reqs = [Request(prompt=list(p), max_new_tokens=8) for p in toks]
        eng.generate(reqs)
        runs[name] = ([r.output for r in reqs], eng.sampled)
        del eng
    del params4
    (tp, lp), (tc, lc) = runs["paged"], runs["contiguous"]
    if tp != tc:
        fail(f"baseline: contiguous greedy tokens {tc} != paged {tp}")
    if len(lp) != len(lc) or any(a.shape != b.shape for a, b in zip(lp, lc)):
        fail("baseline: the two engines sampled different rows")
    err = max(float((a - b).abs().max()) for a, b in zip(lc, lp))
    scale = max(float(b.abs().max()) for b in lp)
    log(f"baseline (4 layers, f32): greedy tokens equal "
        f"({sum(len(x) for x in tp)} tokens); {len(lp)} sampled calls, "
        f"logits max|err| {err:.3e} (tol {MODEL_TOL:g}, |logit| max "
        f"{scale:.3f})")
    if err > MODEL_TOL:
        fail(f"baseline: contiguous logits beyond {MODEL_TOL} of paged")
    stats["f32_check"] = dict(logits_max_err=err, logits_scale=scale,
                              tokens=sum(len(x) for x in tp))
    return stats


def fork_phase(torch, params):
    """Fork with copy-on-write at full width: llama2-7b in bf16 (params of
    the engine phase), 4 slots, max_seq_len 2048, the prefix cache on.  A
    warm request caches a 960-token head; the parent (the head and a
    47-token tail) attaches to it (K3 on its suffix), decodes, and forks 3
    children, one every 5 decode steps.  Each fork adds at most one page,
    and each child's tail page equals the parent's bit for bit right after
    the fork; K1, K2, K3 and K4 launch.  Then at 4 layers in f32: each
    greedy child's tokens equal a fresh request's on the same prefix, and
    the parent's equal its run without forks."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, Request

    cfg = get_config("llama2-7b")
    rng = torch.Generator().manual_seed(SEED + 4)
    head = torch.randint(0, cfg.vocab_size, (960,), generator=rng).tolist()
    tail = torch.randint(0, cfg.vocab_size, (47,), generator=rng).tolist()
    P = cfg.page_size

    def run(eng, n_child, new, child_new, check=None):
        """Warm, then the parent with ``n_child`` forks; returns the
        parent, the children and each fork's page delta."""
        eng.generate([Request(prompt=list(head), max_new_tokens=2)])
        parent = Request(prompt=head + tail, max_new_tokens=new)
        eng.add_request(parent)
        children, deltas = [], []
        while len(children) < n_child:
            for _ in range(5):
                eng.step()
            used = eng.mgr.used_pages
            child = eng.fork_request(parent, max_new_tokens=child_new)
            deltas.append(eng.mgr.used_pages - used)
            if check is not None:
                check(parent, child)
            children.append(child)
        for _ in range(1000):
            if parent.done and all(c.done for c in children):
                break
            eng.step()
        return parent, children, deltas

    tails_equal = []

    def check(parent, child):
        n = eng.mgr.lens[parent.rid]
        if n % P:
            src = eng.mgr.tables[parent.rid][n // P]
            dst = eng.mgr.tables[child.rid][n // P]
            st = eng.state
            torch.cuda.synchronize()
            tails_equal.append(
                bool(torch.equal(st["k_pages"][:, src], st["k_pages"][:, dst]))
                and bool(torch.equal(st["v_pages"][:, src],
                                     st["v_pages"][:, dst])))

    eng = Engine(cfg, params, max_slots=4, max_seq_len=2048,
                 dtype=torch.bfloat16, seed=SEED, prefix_cache=True)
    kernels.reset_launch_counts()
    parent, children, deltas = run(eng, 3, 32, 16, check)
    counts = kernels.launch_counts()
    check_path("fork", eng, [parent], 32, counts,
               must=("paged_decode", "combine", "flex_prefill",
                     "flex_prefill/tc", "paged_prefill",
                     "paged_prefill/tc"),
               never=("flex_prefill/tf32x3",
                      *k3_routes_except("tc")))
    if any(c.status.value != "finished" or len(c.output) != 16
           for c in children):
        fail(f"fork: a child did not finish with 16 tokens "
             f"({[(c.status.value, len(c.output)) for c in children]})")
    if parent.cached_prefix < len(head):
        fail(f"fork: the parent attached {parent.cached_prefix} cached "
             f"tokens, fewer than the {len(head)}-token head")
    if any(d > 1 for d in deltas):
        fail(f"fork: a fork added more than one page ({deltas})")
    if len(tails_equal) != 3 or not all(tails_equal):
        fail(f"fork: a copied tail page differs from the parent's "
             f"({tails_equal})")
    stats = dict(page_deltas=deltas, tails_equal=tails_equal,
                 parent_cached_prefix=parent.cached_prefix,
                 memory_report=eng.memory_report(), launches=counts)
    log(f"fork: parent of {parent.prompt_len} tokens ({parent.cached_prefix}"
        f" from the prefix cache), 3 forks adding {deltas} pages, tail "
        f"pages equal {tails_equal}; launches {counts}")
    del eng
    torch.cuda.empty_cache()

    # tokens at 4 layers in f32
    cfg4 = cfg.replace(n_layers=4)
    eng = Engine(cfg4, max_slots=4, max_seq_len=2048, seed=SEED,
                 prefix_cache=True)
    params4 = eng.params
    parent, children, _ = run(eng, 3, 24, 8)
    alone = Engine(cfg4, params4, max_slots=1, max_seq_len=2048, seed=SEED)
    ref = alone.generate([Request(prompt=head + tail,
                                  max_new_tokens=24)])[0]
    fresh = [alone.generate([Request(prompt=list(c.prompt),
                                     max_new_tokens=8)])[0].output
             for c in children]
    if parent.output != ref.output:
        fail(f"fork (f32): the parent's tokens {parent.output} != its run "
             f"without forks {ref.output}")
    if [c.output for c in children] != fresh:
        fail(f"fork (f32): children {[c.output for c in children]} != "
             f"fresh requests {fresh}")
    log(f"fork (4 layers, f32): parent tokens equal its run alone, 3 "
        f"children's equal fresh requests on their prefixes")
    del eng, alone, params4
    return stats


def allocator_ok(mgr):
    """The host manager's invariants without a prefix cache: refcounts
    equal table occurrences, and the free list holds exactly the pages
    nobody references, once each."""
    occ = [0] * mgr.num_pages
    for row in mgr.tables.values():
        for p in row:
            occ[p] += 1
    free = set(mgr.free_list)
    return (len(free) == len(mgr.free_list)
            and mgr.refcount == occ
            and all((mgr.refcount[p] == 0) == (p in free)
                    for p in range(mgr.num_pages)))


def faults_phase(torch):
    """The fault surface at full width, 4 layers of llama2-7b in bf16, 4
    slots, max_seq_len 512, pages of 64, chunked prefill by 64 (K3): NaN
    injected into one request's third sample fails that request alone and
    the others' tokens are bit-identical to a run without faults; a
    transient error at decode is retried to the same tokens; a bounded
    queue sheds with ``Backpressure``; then the chaos soak of the JAX
    suite, its lengths scaled by the page (310 steps of random admits,
    cancels and injected faults under ``SOAK_SEED``), allocator invariants
    after every step, every request terminal at the end."""
    import random

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.errors import (Backpressure, EngineError, InternalError,
                                    NumericsError)
    from repro_torch.serving import Engine, Request, Status
    from repro_torch.serving.faults import FaultPlan, FaultRule

    cfg = get_config("llama2-7b").replace(n_layers=4)
    P = cfg.page_size
    knobs = dict(max_slots=4, max_seq_len=512, prefill_chunk=P,
                 dtype=torch.bfloat16, seed=SEED)

    def batch():  # three decoders and a long prompt mid-prefill
        return ([Request(prompt=[3 + i] * (P // 2 + 16 * i),
                         max_new_tokens=10) for i in range(3)]
                + [Request(prompt=[9] * (4 * P + 37), max_new_tokens=4)])

    kernels.reset_launch_counts()
    clean = Engine(cfg, **knobs)
    params = clean.params
    ref = clean.generate(batch(), max_steps=300)
    reqs = batch()
    plan = FaultPlan([FaultRule(site="sample", kind="nan", rid=reqs[1].rid,
                                nth=3)])
    faulty = Engine(cfg, params, faults=plan, **knobs)
    faulty.generate(reqs, max_steps=300)
    if not (reqs[1].status is Status.FAILED
            and isinstance(reqs[1].error, NumericsError)
            and len(reqs[1].output) == 2):
        fail(f"faults: the NaN row was not failed at its third sample "
             f"({reqs[1].status}, {reqs[1].error})")
    if [reqs[i].output for i in (0, 2, 3)] != [ref[i].output
                                                for i in (0, 2, 3)]:
        fail("faults: a survivor's tokens differ from the run without "
             "faults")
    if faulty.mgr.used_pages != 0:
        fail("faults: the failed request's pages did not come back")

    plan = FaultPlan([FaultRule(site="decode", kind="transient", nth=3)])
    retry = Engine(cfg, params, faults=plan, **knobs)
    again = retry.generate(batch(), max_steps=300)
    if retry.stats["transient_retries"] != 1 or [
            r.output for r in again] != [r.output for r in ref]:
        fail(f"faults: the transient decode error was not retried to the "
             f"same tokens ({retry.robustness_report()})")

    queue = Engine(cfg, params, max_waiting=2, **knobs)
    try:
        for _ in range(3):
            queue.add_request(Request(prompt=[1] * 8, max_new_tokens=2))
        fail("faults: a third request did not meet Backpressure")
    except Backpressure as e:
        shed = dict(reason=e.reason, queue_depth=e.queue_depth)
    del clean, faulty, retry, queue
    checks = kernels.launch_counts()  # the four runs above, on their own

    # the chaos soak, with the lengths of the JAX suite's times P / 8
    rnd = random.Random(SOAK_SEED)
    plan = FaultPlan(seed=SOAK_SEED, rules=[
        FaultRule(site="extend", kind="alloc_fail", prob=0.02, times=None),
        FaultRule(site="reserve", kind="alloc_fail", prob=0.01, times=None),
        FaultRule(site="sample", kind="nan", prob=0.004, times=None),
        FaultRule(site="decode", kind="transient", prob=0.01, times=None),
        FaultRule(site="prefill", kind="transient", prob=0.01, times=None)])
    k = P // 8
    soak = Engine(cfg, params, max_slots=3, max_seq_len=64 * k,
                  pool_tokens=120 * k, prefill_chunk=8 * k, faults=plan,
                  max_waiting=6, admit_watermark=0.95, max_step_retries=6,
                  dtype=torch.bfloat16, seed=SEED)
    all_reqs, shed_n, escapes = [], 0, 0

    def submit():
        nonlocal shed_n
        r = Request(prompt=[1 + rnd.randrange(50)] * (
            k * rnd.choice((5, 9, 14, 26))),
            max_new_tokens=rnd.randint(2, 8),
            deadline_steps=(rnd.randint(15, 60) if rnd.random() < 0.3
                            else None))
        try:
            soak.add_request(r)
            all_reqs.append(r)
        except Backpressure:
            shed_n += 1

    kernels.reset_launch_counts()  # the soak's launches, on their own
    for _ in range(2):
        submit()
    for _ in range(310):
        if rnd.random() < 0.5:
            submit()
        live = [r for r in all_reqs if not r.done]
        if live and rnd.random() < 0.06:
            soak.cancel_request(rnd.choice(live).rid)
        try:
            soak.step()
        except InternalError as e:
            fail(f"faults: soak step raised an internal error {e!r} "
                 f"(cause {e.__cause__!r})")
        except EngineError:
            escapes += 1
        if not allocator_ok(soak.mgr):
            fail("faults: allocator invariants broken in the soak")
    soak.faults = None
    soak.mgr.plan = FaultPlan([])
    for _ in range(600):
        if all(r.done for r in all_reqs):
            break
        soak.step()
    counts = kernels.launch_counts()
    rep = soak.robustness_report()
    statuses = sorted({r.status.value for r in all_reqs})
    if not (all(r.done for r in all_reqs) and soak.mgr.used_pages == 0
            and allocator_ok(soak.mgr) and plan.fires >= 5
            and rep["failed"] >= 1 and rep["cancelled"] >= 3
            and shed_n == rep["shed"]):
        fail(f"faults: the soak did not end clean or barely exercised "
             f"the fault surface ({rep}, fires {plan.fires}, statuses "
             f"{statuses})")
    for what, c in (("fault checks", checks), ("soak", counts)):
        missing = [k for k in ("paged_decode", "combine/decode",
                               "paged_prefill/tc", "combine/prefill")
                   if c[k] <= 0]
        if missing or c["flex_prefill"]:
            fail(f"faults: the {what} ran off the chunked path ({missing} "
                 f"never launched, or K4 did: {c})")
    stats = dict(shed=shed, soak_report=rep, soak_fires=plan.fires,
                 soak_requests=len(all_reqs), soak_escapes=escapes,
                 soak_statuses=statuses, checks_launches=checks,
                 launches=counts)
    log(f"faults (4 layers, bf16): NaN row failed alone, survivors "
        f"bit-identical; transient decode error retried to the same "
        f"tokens; Backpressure {shed}; soak of {len(all_reqs)} requests, "
        f"{plan.fires} fault fires, {escapes} structured escapes, report "
        f"{rep}, statuses {statuses}; launches: fault checks {checks}, "
        f"soak {counts}")
    return stats


def page_state_phase(torch):
    """The device-side allocator (``core.paging.PageState``) on CUDA
    tensors: 2000 random reserve / extend / free / fork operations on a
    512-page pool of 16 sequences x 48 pages (page 64), each applied where
    the host manager accepted it; after every operation the tables,
    refcounts, lengths and free stack equal the ``HostPageManager``'s."""
    import random

    from repro_torch.core import paging
    from repro_torch.core.paging import HostPageManager

    dev = torch.device("cuda")
    P, num_pages, max_seqs, max_pages = 64, 512, 16, 48
    rnd = random.Random(SEED)
    mgr = HostPageManager(num_pages, P)
    state = paging.init_state(num_pages, max_seqs, max_pages, device=dev)
    live, applied = set(), {"reserve": 0, "extend": 0, "free": 0, "fork": 0}
    t0 = time.perf_counter()
    for i in range(10_000):
        if sum(applied.values()) == 2000:
            break
        op = rnd.choice(list(applied))
        idle = [s for s in range(max_seqs) if s not in live]
        if op == "reserve" and idle:
            seq, n = rnd.choice(idle), rnd.randint(1, max_pages * P)
            if not mgr.reserve(seq, n):
                mgr.tables.pop(seq, None)
                continue
            state = paging.reserve(state, seq, n, P)
            live.add(seq)
        elif op == "extend" and live:
            seq, by = rnd.choice(sorted(live)), rnd.randint(1, 3 * P)
            if mgr.lens[seq] + by > max_pages * P or not mgr.extend(seq, by):
                continue
            state = paging.reserve(state, seq, mgr.lens[seq], P)
        elif op == "free" and live:
            seq = rnd.choice(sorted(live))
            mgr.free(seq)
            state = paging.free(state, seq, P)
            live.discard(seq)
        elif op == "fork" and live and idle:
            src, dst = rnd.choice(sorted(live)), rnd.choice(idle)
            if not mgr.fork(src, dst):
                continue
            state, _ = paging.fork(state, src, dst, P)
            live.add(dst)
        else:
            continue
        applied[op] += 1
        top = int(state.free_top)
        tables = state.block_tables.cpu()
        lens = state.seq_lens.cpu().tolist()
        ok = (state.free_stack[:top].tolist() == mgr.free_list
              and state.refcount.tolist() == mgr.refcount
              and all(tables[s, :len(mgr.tables[s])].tolist()
                      == mgr.tables[s] and lens[s] == mgr.lens[s]
                      for s in live))
        if not ok:
            fail(f"page state: the device state left the host manager's "
                 f"after operation {i} ({op})")
    wall = time.perf_counter() - t0
    if sum(applied.values()) < 2000:
        fail(f"page state: only {applied} operations applied")
    log(f"page state: {sum(applied.values())} operations on CUDA tensors "
        f"({applied}) equal the host manager's after each, {wall:.1f} s "
        f"with the checks")
    return dict(applied=applied, wall_s=wall)


def time_k4(torch):
    """Device ms of K4's causal & padding at the main path's shapes (B 8, H =
    Hkv = 32, D 128, Q = K = 1536, padding lens from the seed) on both
    routes, for an A/B call across trees (``--time-k4 --src``): uses only
    the wrappers' arguments that older trees share."""
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention import flex_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, H, Q, D = 8, 32, 1536, 128
    lens = torch.randint(256, Q + 1, (B,), generator=gen, device=dev)
    lens[0] = Q
    mm = flex.and_masks(flex.causal_mask, flex.padding_mask(lens))
    bm = flex.build_block_mask(mm, Q, Q, 128, 128, B=B, device=dev)
    out = {"src": str(SRC), "lens": lens.tolist()}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((B, H, Q, D), generator=gen, device=dev
                               ).to(dtype) for _ in range(3))
        key = "flex_prefill_" + fa.flex_route(dtype)
        kw = dict(scale=D ** -0.5, mask_mod=mm, q_len=Q, kv_len=Q)
        call = lambda: fa.flex_attention_kernel(q, k, v, bm, **kw)  # noqa
        out[key] = dict(
            device_ms=[device_ms(torch, call, kernel_name(key), reps=10)
                       for _ in range(3)],
            event_ms=[time_ms(torch, call, reps=10) for _ in range(3)])
    log(json.dumps({"time_k4": out}))


def time_main(torch):
    """Device ms of K1, K2, the decode op, K3, the prefill combine and K4
    at the main path's shapes (D 128, G 1; K1: B 8, lens from the seed
    over 32 pages of 64, 2 pages per block, 4 splits; K2 on K1's partials;
    the decode op, K1 and K2 from one call; K3: the 512-token chunk step
    of the kernel phase, one split, whose partials the prefill combine
    takes, every kernel it launches counted; K4: causal & padding at B 8,
    Q = K = 1536) in bf16 and f32, for an A/B call across trees
    (``--time-main --src``): uses only the wrappers' arguments that older
    trees share.  Three medians of 10 launches each."""
    from repro_torch.kernels.paged_attention import paged_attention as pa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, H, D, P, mp = 8, 32, 128, 64, 32
    lens = torch.randint(256, 2049, (B,), generator=gen, device=dev).tolist()
    out = {"src": str(SRC), "lens": lens}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        args = paged_inputs(torch, gen, B, H, 1, D, P, mp, lens, dtype, dev)
        kw = dict(scale=D ** -0.5, pages_per_block=2, num_splits=4)
        call = lambda: pa.paged_attention_partials(*args, **kw)  # noqa
        out[f"paged_decode {name}"] = [
            device_ms(torch, call, "paged_decode_kernel", reps=10)
            for _ in range(3)]
        got = call()
        call = lambda: pa.combine_partials_kernel(*got, dtype=dtype)  # noqa
        out[f"combine {name}"] = [
            device_ms(torch, call, "combine_kernel", reps=10)
            for _ in range(3)]
        call = lambda: pa.paged_attention_kernel(*args, **kw)  # noqa
        out[f"decode_op {name}"] = [
            device_ms(torch, call, ("paged_decode_kernel", "combine_kernel"),
                      reps=10) for _ in range(3)]
        q_start = [0, 512, 1024, 1024 + 37, 512, 0, 1, 1]
        q_lens = [512, 512, 512, 512, 300, 200, 0, 0]
        cargs = chunk_inputs(torch, gen, H, 1, D, P, mp, q_start, q_lens,
                             dtype, dev)
        ckw = dict(scale=D ** -0.5, pages_per_block=2, num_splits=1,
                   q_block=128)
        key = "paged_prefill_" + pa.prefill_route(dtype, dtype, P)
        call = lambda: pa.paged_prefill_partials(*cargs, **ckw)  # noqa
        out[key] = [device_ms(torch, call, kernel_name(key), reps=10)
                    for _ in range(3)]
        got = call()
        C = cargs[0].shape[1]
        call = lambda: pa.combine_prefill_partials(  # noqa
            *got, C, 128, dtype=dtype)
        out[f"combine_prefill {name}"] = [
            all_device_ms(torch, call, reps=10) for _ in range(3)]
        del args, cargs, got
    # K3 over int8 pools with bf16 q, on whatever kernel the tree runs it
    cargs = chunk_inputs(torch, gen, H, 1, D, P, mp, q_start, q_lens,
                         torch.bfloat16, dev, int8=True)
    call = lambda: pa.paged_prefill_partials(*cargs, kv_scale=0.05,  # noqa
                                             **ckw)
    key = "paged_prefill " + pa.prefill_route(torch.bfloat16, torch.int8, P)
    out[key] = [device_ms(torch, call, "paged_prefill_kernel", reps=10)
                for _ in range(3)]
    log(json.dumps({"time_main": out}))
    time_k4(torch)


KINDS = (("K1 paged_decode", ("paged_decode_kernel",)),
         ("K2 combine", ("combine_kernel",)),
         ("K3 paged_prefill", ("paged_prefill_kernel",)),
         ("K4 flex_prefill", ("flex_fwd_kernel",)),
         ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma")))


def check_attributed(step, prof, kind):
    """Fail when the profiler saw device time but none of it under the
    kernel ``kind`` that the step runs (a kernel name KINDS misfiles)."""
    if prof["device_ms"] and prof["by_kind"][kind] <= 0:
        fail(f"profile {step}: no device time attributed to {kind} "
             f"({prof['by_kind']})")


def kind_of(name):
    return next((k for k, keys in KINDS if any(x in name for x in keys)),
                "other")


def profile_steps(torch, eng, n, annotation=None):
    """Device time per engine step by kernel kind, and the device's busy
    share of the step's wall time, from torch.profiler.  With
    ``annotation`` (a name, or a tuple of names), the kernels launched
    under the profiler range of that name (``annotated``; the nearest
    such range above them) move from their kinds into a kind of their
    own."""
    names = ((annotation,) if isinstance(annotation, str)
             else tuple(annotation or ()))
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    by_kind = {k: 0.0 for k, _ in KINDS}
    by_kind["other"] = 0.0
    for ev in prof.key_averages():
        if (not str(getattr(ev, "device_type", "")).endswith("CUDA")
                or ev.key in names):  # the range itself on the GPU row
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        by_kind[kind_of(ev.key)] += us / 1e3 / n
    under_by_name = {}
    if names:
        # each op's kernels, by the op's ancestors on the CPU
        under = dict.fromkeys(names, 0.0)
        for fe in prof.events():
            if not getattr(fe, "kernels", None):
                continue
            up = fe.cpu_parent
            while up is not None and up.name not in names:
                up = up.cpu_parent
            if up is None:
                continue
            for kern in fe.kernels:
                ms = kern.duration / 1e3 / n
                by_kind[kind_of(kern.name)] -= ms
                under[up.name] += ms
                key = f"{fe.name}: {kern.name[:60]}"
                under_by_name[key] = under_by_name.get(key, 0.0) + ms
        by_kind.update(under)
    busy = sum(by_kind.values())
    out = dict(wall_ms=wall_ms, device_ms=busy if busy > 0 else None,
               busy_share=(f"{busy / wall_ms:.3f} of wall" if busy > 0
                           else "not measured"),
               by_kind={k: round(v, 4) for k, v in by_kind.items()})
    if under_by_name:  # the annotated range's kernels, largest first
        out["annotated_kernels"] = {
            k: round(v, 4) for k, v in sorted(
                under_by_name.items(), key=lambda kv: -kv[1])[:8]}
    return out


def log_ptxas(text):
    """Registers, shared memory and spills of the tensor-core kernels and of
    K1, from nvcc's -Xptxas -v report (empty when the library was cached)."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and (
                "_tc" in line or "_tf32" in line
                or "paged_decode_kernel" in line):
            fn = line.split("'")[1] if "'" in line else line
            info = [x.split("ptxas info    : ")[-1].strip()
                    for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            log(f"  ptxas {fn}: {'; '.join(info)}")


def count_mma(lib):
    """Tensor-core instructions in the library's SASS, by cuobjdump: all
    HGMMA (wgmma), and in the split-TF32 kernels (``*_kernel_tf32``) the
    TF32 HGMMA and the TF32 HMMA (mma.sync)."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    out = subprocess.run([str(tool) if tool.exists() else "cuobjdump",
                          "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode:
        fail(f"cuobjdump failed: {out.stderr[-2000:]}")
    hgmma = tf32_hgmma = tf32_hmma = 0
    in_tf32 = False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            in_tf32 = "_kernel_tf32" in line
        hgmma += "HGMMA" in line
        if in_tf32 and "TF32" in line:
            tf32_hgmma += "HGMMA" in line
            tf32_hmma += "HMMA" in line
    return hgmma, tf32_hgmma, tf32_hmma


# ---------------------------------------------------------------------------
# distributed: the decode step across 2 ranks on one card (gloo)
# ---------------------------------------------------------------------------
DIST_RANKS = 2
DIST_STEPS = 32
# the bf16 llama2-7b cases' depth, of 32: gloo all-reduces each layer's
# sums between the processes over a case's 32 steps
DIST_BF16_LAYERS = 4
DIST_TP_LENS = [256, 439, 622, 805, 988, 1171, 1354, 1536]
DIST_KVP_LONG = 8192
# batch 8 under kvp: rows of 1 and 64 tokens hold one page, so the second
# rank's stripe of them is empty; 65 and 129 end a page into a stripe
DIST_KVP_LENS = [1, 64, 65, 129, 300, 511, 700, 1024]
DIST_EP_LENS = [16, 32, 45, 64, 77, 96, 110, 128]
DIST_EP_STEPS = 8
DIST_RING_S = 8192
# the kvp case at real GQA: llama3-405b cut to 2 layers, 8 decode steps
DIST_GQA_LAYERS, DIST_GQA_STEPS = 2, 8
DIST_RING_WINDOWS = (0, 4096)
# the kernels the ranks' main paths launch, by launch-count key
DIST_KEYS = ("paged_decode", "combine/decode", "combine/dist",
             "flex_prefill/tc", "flex_prefill/tf32x3", "paged_prefill")


def dist_cases():
    """(name, config, dtype, n_layers or None, scheme, lens, steps)."""
    return [
        ("tp bf16", "llama2-7b", "bfloat16", DIST_BF16_LAYERS, None,
         DIST_TP_LENS, DIST_STEPS),
        ("tp f32", "llama2-7b", "float32", 4, None, DIST_TP_LENS,
         DIST_STEPS),
        ("kvp bf16 8192", "llama2-7b", "bfloat16", DIST_BF16_LAYERS, "kvp",
         [DIST_KVP_LONG], DIST_STEPS),
        ("kvp bf16 batch 8", "llama2-7b", "bfloat16", DIST_BF16_LAYERS,
         "kvp", DIST_KVP_LENS, DIST_STEPS),
        # f32: a bf16 rounding apart flips near-tied top-k choices
        ("ep f32", "granite-moe-1b-a400m", "float32", None, None,
         DIST_EP_LENS, DIST_EP_STEPS),
        # kvp held at MODEL_TOL, as tp f32 is: the bf16 bound is loose
        ("kvp f32 8192", "llama2-7b", "float32", 4, "kvp",
         [DIST_KVP_LONG], DIST_STEPS),
        ("kvp f32 batch 8", "llama2-7b", "float32", 4, "kvp",
         DIST_KVP_LENS, DIST_STEPS),
        # kvp at real GQA (128 q heads over 8 kv heads): the q heads cut
        # over the ranks ("q_heads"), all of them gathered for K1
        ("kvp bf16 llama3-405b", "llama3-405b", "bfloat16", DIST_GQA_LAYERS,
         "kvp", DIST_KVP_LENS, DIST_GQA_STEPS),
        # GSPMD's expert cut: each rank its 16 experts over every token
        ("experts cut f32", "granite-moe-1b-a400m", "float32", None, None,
         DIST_EP_LENS, DIST_EP_STEPS),
    ]


# config fields of a case beyond ``dist_model``'s (the cut: no moe_ep)
DIST_CASE_KW = {"experts cut f32": {"moe_ep": False}}
# the expert schedule of each MoE case
DIST_MOE = {"ep f32": "ep", "experts cut f32": "cut"}

# the planted fault: the case whose kvp merge loses the second rank's
# stripe, and the decode steps it runs
DIST_FAULT_CASE = "kvp f32 8192"
DIST_FAULT_STEPS = 4


def dropped_stripe(coll, rank):
    """A ``merge_flash_partials`` that treats this rank's partials as dead
    on rank 1 (the planted fault of the kvp check): its stripe's keys
    drop out of every merge."""
    real = coll.merge_flash_partials

    def merge(m, l, acc, axes, **kw):
        if rank == 1:
            m, l, acc = m.new_full(m.shape, -1e30), l * 0, acc * 0
        return real(m, l, acc, axes, **kw)
    return merge


def dist_model(torch, name, dtype, n_layers, cfg_kw=None):
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    cfg = get_config(name)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    if name == "granite-moe-1b-a400m":  # EP, dropless
        cfg = cfg.replace(moe_ep=True, moe_capacity=0.0)
    return build_model(cfg.replace(**(cfg_kw or {})))


def dist_tokens(torch, cfg, lens, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    B, S = len(lens), max(lens)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    return tokens, torch.tensor(lens, dtype=torch.int32, device="cuda")


def kernel_device_ms(prof, n):
    """Device ms per call of the CUDA kernels a profile recorded over
    ``n`` calls (None when it recorded none)."""
    total = 0.0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
    return total / 1e3 / n if total > 0 else None


def dist_serve(torch, model, params, tokens, lens, steps, plan=None,
               forced=None):
    """Prefill ``tokens`` and decode ``steps`` tokens, under ``plan`` (this
    rank's params; the state resharded by ``shard_decode_state``) or on
    one device.  ``forced`` (steps + 1, B) tokens teacher-force the decode
    (the single-device run's greedy tokens), so every step's logits are
    comparable.  Returns (logits (steps + 1, B, V) f32 on the host, greedy
    tokens, step ms by CUDA events, device ms per step by the profiler
    over steps 2 and 3, the prefill's and the decode's seconds)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed.collectives import shard_decode_state
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.steps import build_serve_step
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    B, S = tokens.shape
    dtype = next(iter(params["ln_f"].values())).dtype
    run = RunConfig(model=cfg, seq_len=S + steps, global_batch=B,
                    kind="decode")
    state = model.init_decode_state(run, dtype, device="cuda", plan=plan)
    pps = state["tables"].shape[2]
    state["tables"] = torch.arange(B * pps, dtype=torch.int32,
                                   device="cuda").reshape(B, 1, pps)
    if plan is None:
        ctx, step = contextlib.nullcontext(), (
            lambda p, t, s: model.decode_step(p, t, s))
    else:
        ctx, step = use_mesh(plan.mesh, plan.rules), build_serve_step(
            run, plan)[0]
    t_start = time.perf_counter()
    with torch.no_grad():
        with ctx:
            logits, state = model.prefill(params, tokens, state, lens,
                                          attn_ctx=plan and plan.attn_ctx)
        if plan is not None:
            state = shard_decode_state(state, plan)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t_start
        outs, greedy = [logits.float().cpu()], [logits.argmax(-1).cpu()]
        tok = (forced[0].cuda() if forced is not None
               else logits.argmax(-1)).int()
        times = []
        # the profiler over 2 steps only: it stretches every step it sees
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        for i in range(steps):
            if i == 1:
                prof.start()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            logits, state = step(params, tok, state)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
            if i == 2:
                prof.stop()
            outs.append(logits.float().cpu())
            greedy.append(logits.argmax(-1).cpu())
            tok = (forced[i + 1].cuda() if forced is not None
                   else logits.argmax(-1)).int()
    return (torch.stack(outs), torch.stack(greedy), times,
            kernel_device_ms(prof, 2), dict(
                prefill_s=prefill_s,
                decode_s=time.perf_counter() - t_start - prefill_s))


def dist_ring_inputs(torch, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (1, DIST_RING_S, 32, 128)  # llama2-7b's heads
    return [torch.randn(shape, generator=gen, device="cuda")
            for _ in range(3)]


def dist_dp_inputs(torch, dtype, seed):
    """nemotron-4-15b's heads (48 over 8: G 6), batch 8, page 64."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    lens = [1, 63, 64, 200, 513, 1024, 1800, 2048]
    return paged_inputs(torch, gen, 8, 8, 6, 128, 64, 32, lens, dtype,
                        torch.device("cuda"))


def dist_references(torch, work):
    """The single-device runs of every case, saved under ``work`` for the
    ranks: logits and greedy tokens of each served case, the plain
    chunked attention of the ring cases, and K1 + K2's output at the dp
    case's shapes."""
    from repro_torch.core.attention import prefill_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    refs = {}
    for i, (name, cfg_name, dt, nl, _, lens, steps) in enumerate(
            dist_cases()):
        t0 = time.perf_counter()
        model = dist_model(torch, cfg_name, dt, nl, DIST_CASE_KW.get(name))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        params = model.init_params(gen, getattr(torch, dt), "cuda")
        tokens, lens_t = dist_tokens(torch, model.cfg, lens, SEED + 1 + i)
        t_init = time.perf_counter() - t0
        logits, greedy, times, dev, secs = dist_serve(
            torch, model, params, tokens, lens_t, steps)
        torch.save({"logits": logits, "tokens": greedy},
                   work / f"ref_{i}.pt")
        refs[name] = dict(step_ms=statistics.median(times), device_ms=dev,
                          init_s=t_init, **secs,
                          seconds=time.perf_counter() - t0)
        log(f"dist reference {name}: {model.cfg.name}, {model.cfg.n_layers} "
            f"layers, B {len(lens)}, step {refs[name]['step_ms']:.3f} ms, "
            f"device {fmt(dev)}; seconds: weights {t_init:.1f}, prefill "
            f"{secs['prefill_s']:.1f}, {steps} steps {secs['decode_s']:.1f}")
        del params, model
        torch.cuda.empty_cache()
    q, k, v = dist_ring_inputs(torch, SEED + 20)
    for w in DIST_RING_WINDOWS:
        with torch.no_grad():
            out = prefill_attention(q, k, v, window=w, impl="chunked")
        torch.save(out.cpu(), work / f"ring_{w}.pt")
    del q, k, v, out
    for dt in ("float32", "bfloat16"):
        qg, kp, vp, tables, lens = dist_dp_inputs(
            torch, getattr(torch, dt), SEED + 30)
        B, Hkv, G, D = qg.shape
        out = paged_attention(qg.reshape(B, Hkv * G, D), kp, vp, tables,
                              lens).reshape(B, Hkv, G, D)
        torch.save(out.cpu(), work / f"dp_{dt}.pt")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return refs


def logits_gap(got, want, forced, dtype):
    """max|err| of the rank's logits against the single device's, the
    bound (f32: MODEL_TOL; bf16: BF16_MODEL_TOL of the scale), the greedy
    agreement and the first step at which the rank's greedy token leaves
    the single device's (None: never)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    bound = MODEL_TOL if dtype == "float32" else BF16_MODEL_TOL * (1 + scale)
    mine = got.argmax(-1)
    same = (mine == forced).all(dim=1)
    div = None if bool(same.all()) else int((~same).nonzero()[0, 0])
    return dict(max_err=err, bound=bound, scale=scale,
                argmax_agreement=float((mine == forced).float().mean()),
                divergence_step=div, finite=bool(got.isfinite().all()))


def dist_rank_kernels(torch, work, mesh, out):
    """The distributed phase's attention cases on this rank: dp attention
    at nemotron-4-15b's heads and ring attention (results into ``out``)."""
    from repro_torch import kernels
    from repro_torch.core.attention import prefill_attention
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_mesh
    # (c) dp attention at nemotron-4-15b's heads: q-head groups (6)
    # over the 2 ranks, pools replicated
    m, r = mesh.size("model"), mesh.index("model")
    kernels.reset_launch_counts()
    for dt in ("float32", "bfloat16"):
        qg, kp, vp, tables, lens = dist_dp_inputs(
            torch, getattr(torch, dt), SEED + 30)
        G = qg.shape[2]
        gs = slice(r * G // m, (r + 1) * G // m)
        with use_mesh(mesh):
            o = coll.decode_attention_sharded(
                qg[:, :, gs].contiguous(), kp, vp, tables[:, None], lens,
                scheme="dp")
        want = torch.load(work / f"dp_{dt}.pt")[:, :, gs].cuda()
        err = float((o.float() - want.float()).abs().max())
        out.setdefault("dp", {})[dt] = dict(
            max_err=err, finite=bool(o.isfinite().all()),
            tol=F32_TOL if dt == "float32" else BF16_TOL)
    out["dp_launches"] = {k: kernels.launch_counts().get(k, 0)
                          for k in DIST_KEYS}
    # (e) ring attention, f32, S 8192 over the 2 ranks' halves
    q, k, v = dist_ring_inputs(torch, SEED + 20)
    S_l = DIST_RING_S // m
    sl = slice(r * S_l, (r + 1) * S_l)
    rules = DEFAULT_RULES.extend(batch=None, seq=("model",))
    for w in DIST_RING_WINDOWS:
        t0 = time.perf_counter()
        with use_mesh(mesh, rules), torch.no_grad():
            o = prefill_attention(q[:, sl], k[:, sl], v[:, sl], window=w,
                                  impl="ring")
        torch.cuda.synchronize()
        want = torch.load(work / f"ring_{w}.pt")[:, sl].cuda()
        out.setdefault("ring", {})[str(w)] = dict(
            max_err=float((o - want).abs().max()),
            finite=bool(o.isfinite().all()),
            seconds=time.perf_counter() - t0)


def dist_rank(rank, world, work, src, parts=("dist", "launch")):
    """One rank of the distributed and launch phases: join the gloo
    group, run every case of ``parts`` under its plan on ``cuda:0`` and
    write its metrics to ``work/rank{rank}.json`` (a traceback on
    failure)."""
    work = Path(work)
    out = {"rank": rank}
    try:
        set_src(Path(src))
        sys.path.insert(0, src)
        import torch
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(work / "store"), world),
            rank=rank, world_size=world)
        from repro_torch import kernels
        from repro_torch.configs.base import RunConfig
        from repro_torch.distributed import collectives as coll
        from repro_torch.kernels import build
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import plan_for
        build.get_lib()  # built by the parent: loaded, not rebuilt
        real_merge = coll.merge_flash_partials
        mesh = make_mesh((1, world))
        out["cases"] = {}
        for i, (name, cfg_name, dt, nl, scheme, lens, steps) in enumerate(
                dist_cases() if "dist" in parts else ()):
            t0 = time.perf_counter()
            model = dist_model(torch, cfg_name, dt, nl,
                               DIST_CASE_KW.get(name))
            ref = torch.load(work / f"ref_{i}.pt")
            tokens, lens_t = dist_tokens(torch, model.cfg, lens, SEED + 1 + i)
            run = RunConfig(model=model.cfg, seq_len=max(lens) + steps,
                            global_batch=len(lens), kind="decode")
            plan = plan_for(run, mesh, scheme=scheme)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            params = model.init_params(gen, getattr(torch, dt), "cuda",
                                       plan=plan)
            t_init = time.perf_counter() - t0
            kernels.reset_launch_counts()
            stats0 = {k: dict(v) for k, v in mesh.stats.items()}
            logits, _, times, dev, secs = dist_serve(
                torch, model, params, tokens, lens_t, steps, plan,
                forced=ref["tokens"])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            res = logits_gap(logits, ref["logits"], ref["tokens"], dt)
            attn = params["layers"][0]["attn"]
            res.update(scheme=plan.scheme, attn=sorted(set(plan.layout.attn)),
                       heads=[model.cfg.n_heads, int(attn["wq"].shape[1]),
                              int(attn["wo"].shape[0])],
                       moe=plan.layout.moe(),
                       experts=[int(params["layers"][0]["moe"]["wg"].shape[
                           0]), model.cfg.n_experts] if model.cfg.is_moe
                       else None,
                       step_ms=statistics.median(times),
                       device_ms=dev, seconds=time.perf_counter() - t0,
                       init_s=t_init, **secs,
                       launches={k: counts.get(k, 0) for k in DIST_KEYS},
                       weight_gb=weight_bytes(params) / 1e9,
                       collectives={op: dict(
                           calls=mesh.stats["calls"][op]
                           - stats0["calls"].get(op, 0),
                           gb=(mesh.stats["bytes"][op]
                               - stats0["bytes"].get(op, 0)) / 1e9,
                           s=mesh.stats["seconds"][op]
                           - stats0["seconds"].get(op, 0))
                           for op in mesh.stats["calls"]})
            out["cases"][name] = res
            if name == DIST_FAULT_CASE:
                # the planted fault: the same case with rank 1's stripe
                # dropped from every merge must leave the bound (its
                # launches are not the main path's: counted nowhere)
                coll.merge_flash_partials = dropped_stripe(coll, rank)
                try:
                    bad = dist_serve(torch, model, params, tokens, lens_t,
                                     DIST_FAULT_STEPS, plan,
                                     forced=ref["tokens"])[0]
                finally:
                    coll.merge_flash_partials = real_merge
                out["fault"] = logits_gap(
                    bad, ref["logits"][:DIST_FAULT_STEPS + 1],
                    ref["tokens"][:DIST_FAULT_STEPS + 1], dt)
                del bad
            del params, model, logits
            torch.cuda.empty_cache()
        if "dist" in parts:
            dist_rank_kernels(torch, work, mesh, out)
        if "launch" in parts:
            out["launch"] = launch_rank(torch, work)
        elif "dry" in parts:
            from repro_torch.launch.mesh import make_mesh
            meshes = {shape: make_mesh(shape) for shape in LAUNCH_MESHES}
            out["dry"] = [dry_rank_train(torch, meshes[shape], run, mb, kn)
                          for _, shape, run, _, mb, kn in
                          launch_train_cases()] + [
                dry_rank_ws(torch, meshes[(2, 1)], LAUNCH_WS_TAILS[-1][1])]
        out["host_ops"] = sorted(mesh.host_ops or ())
        out["host_copies"] = dict(mesh.host_copies)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — written for the parent
        import traceback
        out["error"] = traceback.format_exc()
    (work / f"rank{rank}.json").write_text(json.dumps(out, default=str))
    if "error" in out:
        sys.exit(1)


def k2_dist_row(torch, chk):
    """K2 at the kvp merge's layout (route "dist"): batch 1, 32 kv heads
    of G 1 and D 128, the 2 ranks' 8 splits each (the local K1 partition
    of 4096 keys), bf16 output; against its plain version, timed."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        _combine_partials_plain, combine_partials_kernel)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 40)
    B, Hkv, S, G, D = 1, 32, DIST_RANKS * 8, 1, 128
    m = torch.randn((B, Hkv, S, G), generator=gen, device="cuda") * 4
    m[:, :, -3:] = -1e30  # dead splits (a rank's stripe past the row)
    l = torch.rand((B, Hkv, S, G), generator=gen, device="cuda") * 100
    l[:, :, -3:] = 0
    acc = torch.randn((B, Hkv, S, G, D), generator=gen, device="cuda")
    acc[:, :, -3:] = 0
    got = combine_partials_kernel(m, l, acc, torch.bfloat16, route="dist")
    want = _combine_partials_plain(m, l, acc, torch.bfloat16)
    chk.close("combine/dist", "kvp merge, 2 ranks x 8 splits, bf16",
              got.float(), want.float(), BF16_TOL)
    nbytes = (2 * m.numel() + acc.numel()) * 4 + got.numel() * 2
    return dict(
        ms=time_ms(torch, lambda: combine_partials_kernel(
            m, l, acc, torch.bfloat16, route="dist")),
        device_ms=device_ms(torch, lambda: combine_partials_kernel(
            m, l, acc, torch.bfloat16, route="dist"), "combine"),
        plain_ms=time_ms(torch, lambda: _combine_partials_plain(
            m, l, acc, torch.bfloat16)),
        bound_ms=1e3 * nbytes / HBM_BPS, bound_by="bytes", library_ms=None)


# the launch phase: the plans' prefill, train and serve entry points on 2
# ranks (the distributed phase's processes) and on one device
LAUNCH_MESHES = ((2, 1), (1, 2))
LAUNCH_DECODE_STEPS = 4
LAUNCH_TRAIN_B, LAUNCH_TRAIN_S, LAUNCH_TRAIN_STEPS = 4, 512, 2
# the depth of the llama2-7b train cases on (1, 2) (sequence cut, ring,
# uncut): gloo moves every layer's gathers and reduce-scatters between
# the processes
LAUNCH_SEQ_LAYERS = 2
LAUNCH_GRAD_TOL = 1e-4  # |g - g_one| <= tol * (1 + |g_one|), f32
LAUNCH_STEP_TOL = 2e-4  # params after the steps against one device's
LAUNCH_LR = 3e-4  # the train steps' learning rate (the JAX builder's)
# AdamW moves an element by lr·m̂/√v̂ whatever its gradients' size, so
# where a rank's gradient is rounding apart from one device's at the
# scale of the gradient itself its step is not one device's: an element
# whose gradient a step took more than this share away from one
# device's is held to AdamW's bound (``adamw_bound``) instead of
# ``LAUNCH_STEP_TOL`` (below it two steps part by at most about
# 2 · lr · share = 1.5e-4) ...
LAUNCH_GRAD_SHARE = 0.25
# ... and may be at most this share of the rank's elements: a fault of a
# cut (a gradient summed twice, or over the wrong ranks) moves most
# elements of a leaf, and every leaf but the norms' (whose gradients are
# large enough for the gradient check) holds more than this share; the
# llama2-7b ranks showed 6e-5 (2, 1) and 2.1e-4 (1, 2)
LAUNCH_ROUNDING_SHARE = 1e-3
LAUNCH_LOSS_TOL = 1e-5  # relative
# an MoE train rank's top-k choices that may differ from one device's
# (replayed from its tape), as a share of them: rounding's near-ties
LAUNCH_ROUTE_FLIPS = 1e-4
LAUNCH_SERVE_REQUESTS = 8
LAUNCH_KEYS = ("flex_prefill/tc", "flex_prefill/tf32x3", "paged_decode",
               "combine/decode", "combine/dist")
# weight-stationary decode (``plan_for(ws_decode=True)``) of the FSDP
# prefill case's state: (name, decode plan knobs, steps, whether the dry
# phase holds its step); the dry phase holds the last one's step (kvp: K1
# on the stripe, the merge's all-gather, K2 across the ranks, besides
# every all-reduce of the tp one)
LAUNCH_WS_TAILS = (("ws tp", {"ws_decode": True}, LAUNCH_DECODE_STEPS,
                    False),
                   ("ws kvp", {"ws_decode": True, "scheme": "kvp"},
                    LAUNCH_DECODE_STEPS, True))
# recurrentgemma-9b under a mesh: full width (d 4096, lru_width 4096, 16
# heads over 1 kv head at D 256, d_ff 12288, vocab 256000), one RRW unit,
# f32 (its one-device AdamW state ≈ 44 GB: two ranks cannot each hold one,
# so the train cases' reference is computed in turns, ``train_reference``);
# its prefill state decoded again weight-stationary on (2, 1)
LAUNCH_RG = "recurrentgemma-9b"
LAUNCH_RG_LAYERS = 3
LAUNCH_RG_TAILS = (("ws", {"ws_decode": True}, 2, False),)


def launch_prefill_cases():
    """(name, config, dtype, n_layers or None, meshes, plan knobs, ws
    tails) of the prefill cases: llama2-7b in bf16, at full depth on
    (2, 1) and at 8 layers on (1, 2) (cut along the sequence, the
    plans' default: gloo reduce-scatters each layer's sums between the
    processes), llama2-7b
    at 4 layers f32 on both launch meshes and on (1, 2) without the
    sequence cut (``seq_parallel=False``: the sums all-reduced, the
    activations whole), granite-8b under FSDP (its ``embed: ("data",)``
    override) on (2, 1), at 4 of its 36 layers (gloo gathers each
    layer's weights between the processes: ≈ 0.5 s a layer and step
    here), and llama2-7b at 4 layers f32 under the ring plan on (1, 2)
    (ring attention in plain ops, no K4; the attention weights whole, the
    decode plan's cut again for the decode steps).  The ws tails: the
    decode plans' knobs under which the FSDP case decodes its prefilled
    state again (``launch_ws_tail``): weight-stationary under tp (every
    rank holds all 8 rows) and under kvp (the pages striped over
    "data": K1 on each process's stripe, K2 ``combine/dist`` across
    both).  Last, recurrentgemma-9b at one ``RRW`` unit in f32
    (``LAUNCH_RG``): on (1, 2) its RG-LRU channels over "model" and the
    sequence cut (K4 at D 256 for the ``W`` layer, the gates'
    reduce-scatter in every ``R`` layer), then dp decode (K1 at G 8 a
    rank); on (2, 1) its rows over "data", then decoded again
    weight-stationary (every row on each rank, the recurrent state's
    rows gathered).  The ws tails run on meshes whose "data" axis holds
    more than one rank."""
    return [("bf16", "llama2-7b", "bfloat16", None, ((2, 1),), {}, ()),
            ("f32", "llama2-7b", "float32", 4, LAUNCH_MESHES, {}, ()),
            ("fsdp granite-8b bf16", "granite-8b", "bfloat16", 4,
             ((2, 1),), {}, LAUNCH_WS_TAILS),
            ("ring f32", "llama2-7b", "float32", 4, ((1, 2),),
             {"ring": True}, ()),
            ("bf16 8 layers", "llama2-7b", "bfloat16", 8, ((1, 2),), {},
             ()),
            ("no-seq f32", "llama2-7b", "float32", 4, ((1, 2),),
             {"seq_parallel": False}, ()),
            ("rglru f32", LAUNCH_RG, "float32", LAUNCH_RG_LAYERS,
             ((1, 2), (2, 1)), {}, LAUNCH_RG_TAILS)]


def launch_references(torch, work):
    """One device's prefill of 8 rows of ``DIST_TP_LENS`` and
    ``LAUNCH_DECODE_STEPS`` greedy decode steps, per prefill case, saved
    under ``work`` for the ranks."""
    refs = {}
    for i, (name, cfg_name, dt, nl, *_) in enumerate(
            launch_prefill_cases()):
        t0 = time.perf_counter()
        model = dist_model(torch, cfg_name, dt, nl)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        params = model.init_params(gen, getattr(torch, dt), "cuda")
        tokens, lens = dist_tokens(torch, model.cfg, DIST_TP_LENS,
                                   SEED + 60 + i)
        logits, greedy, times, _, secs = dist_serve(
            torch, model, params, tokens, lens, LAUNCH_DECODE_STEPS)
        torch.save({"logits": logits, "tokens": greedy},
                   work / f"launch_{name}.pt")
        refs[name] = dict(step_ms=statistics.median(times),
                          seconds=time.perf_counter() - t0, **secs)
        del params, model
        torch.cuda.empty_cache()
    return refs


def launch_train_batches(torch, cfg):
    from repro_torch.data import synthetic_batches
    from repro_torch.training.loop import to_device
    data = synthetic_batches(LAUNCH_TRAIN_B, LAUNCH_TRAIN_S, cfg.vocab_size,
                             cfg=cfg)
    return [to_device(next(data), "cuda") for _ in range(LAUNCH_TRAIN_STEPS)]


def launch_train_run(name="llama2-7b", n_layers=4, **replace):
    """The launch phase's train run: ``name`` at ``n_layers`` layers, B
    ``LAUNCH_TRAIN_B`` x S ``LAUNCH_TRAIN_S`` (llama2-7b; granite-8b, the
    FSDP case, carries the ``embed: ("data",)`` override), with the
    config's fields in ``replace``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    cfg = get_config(name).replace(n_layers=n_layers, **replace)
    return RunConfig(model=cfg, seq_len=LAUNCH_TRAIN_S,
                     global_batch=LAUNCH_TRAIN_B, kind="train")


def launch_train_cases():
    """(name, mesh shape, run, steps, microbatches or None for the
    plan's, plan knobs) of the launch phase's train rank cases: llama2-7b
    on both launch meshes (on (2, 1) at 1 layer: gloo sums every
    gradient between the processes; on (1, 2) at ``LAUNCH_SEQ_LAYERS``,
    cut along the sequence, the plans' default), granite-8b under FSDP
    on (2, 1) for one step (at 4 layers: gloo's reduce-scatter scratch,
    0.805 GB beyond the dry run's peak, stays within ``DRY_PEAK_TOL`` of
    it), granite-moe-1b-a400m
    on (1, 2) under GSPMD's expert cut and under ``moe_ep`` (the
    all-to-all under grad), in one microbatch: at its capacity 1.25 the
    drops are each microbatch's, so the plan's 2 would leave one
    device's plain step (its f32 logits, vocab 49155 whole on 2 ranks,
    pass the 256 MB budget), llama2-7b on (1, 2) under the ring plan
    (ring attention under grad, the heads' q/k/v all-to-all'd to the
    sequence cut and back) and with
    ``seq_parallel=False`` (the activations whole, the row-parallel sums
    all-reduced), and recurrentgemma-9b at one ``RRW`` unit on (1, 2),
    one step under the sequence cut and one under the ring plan, in one
    microbatch (its f32 logits pass the budget: the plan's 4 would only
    take longer), both from one reference (``train_reference``)."""
    moe = "granite-moe-1b-a400m"
    return [("(2, 1)", (2, 1), launch_train_run(n_layers=1),
             LAUNCH_TRAIN_STEPS, None, {}),
            ("(1, 2)", (1, 2), launch_train_run(n_layers=LAUNCH_SEQ_LAYERS),
             LAUNCH_TRAIN_STEPS, None, {}),
            ("(2, 1) fsdp granite-8b", (2, 1), launch_train_run("granite-8b"),
             1, None, {}),
            ("(1, 2) experts cut granite-moe", (1, 2), launch_train_run(moe),
             LAUNCH_TRAIN_STEPS, 1, {}),
            ("(1, 2) experts ep granite-moe", (1, 2),
             launch_train_run(moe, moe_ep=True), LAUNCH_TRAIN_STEPS, 1, {}),
            ("(1, 2) ring llama2-7b", (1, 2),
             launch_train_run(n_layers=LAUNCH_SEQ_LAYERS),
             LAUNCH_TRAIN_STEPS, None, {"ring": True}),
            ("(1, 2) no-seq llama2-7b", (1, 2),
             launch_train_run(n_layers=LAUNCH_SEQ_LAYERS),
             LAUNCH_TRAIN_STEPS, None, {"seq_parallel": False}),
            ("(1, 2) rglru", (1, 2), launch_train_run(
                LAUNCH_RG, LAUNCH_RG_LAYERS), 1, 1, {}),
            ("(1, 2) ring rglru", (1, 2), launch_train_run(
                LAUNCH_RG, LAUNCH_RG_LAYERS), 1, 1, {"ring": True})]


def rank_case_name(run, plan, mesh):
    """A train rank case's name in the dry phase's lines."""
    return (f"train {run.model.name} {run.model.n_layers} layers f32 "
            f"{mesh.shape}"
            f"{' fsdp' if plan.layout.fsdp else ''}"
            f"{' experts ' + plan.layout.moe() if run.model.is_moe else ''}"
            f"{' ring' if plan.layout.ring else ' seq' if plan.layout.seq else ''}"
            f" rank {mesh.rank}")


def leaves_gap(got, want, rel):
    """max over two lists of tensors (``want`` on the host) of |got -
    want|, over (1 + |want|) when ``rel``."""
    worst = 0.0
    for g, w in zip(got, want):
        w = w.to(g.device)
        d = (g.float() - w.float()).abs()
        if rel:
            d = d / (1 + w.float().abs())
        worst = max(worst, float(d.max()))
    return worst


class GradTape:
    """The gradients that each step of a train run hands to AdamW (the
    input of ``clip_by_global_norm``, patched while the steps are built:
    clipping scales a step's gradients by one positive factor), so that
    a rank's steps can be held against one device's element by element.
    In ``mode`` "record" it keeps one device's, ``cut`` to the rank, on
    the host; in "compare" it marks (``flags``) the rank's elements
    whose gradient at some step lies more than ``LAUNCH_GRAD_SHARE`` of
    one device's away from it — rounding as large as the gradient
    itself, where AdamW's step, which does not depend on the gradient's
    size, is rounding too —, takes the first step's largest gap
    relative to 1 + |one device's| (``grad_err``), and times itself by
    events (``ms``), to be taken from the step's time; otherwise it does
    nothing."""

    def __init__(self, torch):
        self.torch, self.mode, self.cut = torch, None, None
        self.ref, self.flags, self.events = [], None, []
        self.first_gap = None

    @contextlib.contextmanager
    def building(self):
        from repro_torch.training import optimizer
        orig = optimizer.clip_by_global_norm

        def clip(grads, *args, **kw):
            if self.mode == "record":
                self._record(grads)
            elif self.mode == "compare":
                self._compare(grads)
            return orig(grads, *args, **kw)

        optimizer.clip_by_global_norm = clip
        try:
            yield
        finally:
            optimizer.clip_by_global_norm = orig

    def _record(self, grads):
        from repro_torch.utils.tree import tree_leaves
        self.ref.append([x.cpu() for x in tree_leaves(self.cut(grads))])

    def _compare(self, grads):
        from repro_torch.utils.tree import tree_leaves
        torch = self.torch
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        flags, gaps = [], []
        for g, r in zip(tree_leaves(grads), self.ref[len(self.events)]):
            r = r.to(g.device)
            d = (g - r).abs()
            flags.append(d > LAUNCH_GRAD_SHARE * r.abs())
            if not self.events:
                gaps.append((d / (1 + r.abs())).max())
            del r, d
        if gaps:
            self.first_gap = torch.stack(gaps).max()
        self.flags = flags if self.flags is None else [
            a | b for a, b in zip(self.flags, flags)]
        e1.record()
        self.events.append((e0, e1))

    def ms(self, step):
        """The comparison's ms in step ``step`` (after it has synced)."""
        e0, e1 = self.events[step]
        return e0.elapsed_time(e1)

    @property
    def grad_err(self) -> float:
        return float(self.first_gap)


def adamw_bound(n_steps, lr=LAUNCH_LR, b1=0.9, b2=0.95):
    """The most by which AdamW's ``n_steps`` first steps can move an
    element apart in two runs from the same params, whatever their
    gradients: each step moves it by lr · |m̂/√v̂|, at most lr · √(Σ_i
    a_i² / b_i) with a_i and b_i the weights of gradient i in m̂ and v̂
    (Cauchy–Schwarz); weight decay adds lr · 0.1 of the gap itself,
    left to ``LAUNCH_STEP_TOL``."""
    total = 0.0
    for t in range(1, n_steps + 1):
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        total += 2 * lr * math.sqrt(sum(
            ((1 - b1) * b1 ** (t - i) / c1) ** 2
            / ((1 - b2) * b2 ** (t - i) / c2) for i in range(1, t + 1)))
    return total + LAUNCH_STEP_TOL


def flagged_gaps(got, want, flags, paths):
    """max |got - want| over two lists of tensors (``want`` on the host)
    at the elements ``flags`` leaves out and at those it marks, how many
    it marks of how many, and the path of the leaf where it marks most
    with their count and the leaf's size."""
    free = held = 0.0
    n = size = 0
    top = (None, 0, 0)
    for g, w, f, path in zip(got, want, flags, paths):
        d = (g.float() - w.to(g.device).float()).abs()
        free = max(free, float(d.masked_fill(f, 0).max()))
        k = int(f.sum())
        if k:
            held = max(held, float(d[f].max()))
        if k > top[1]:
            top = (path, k, f.numel())
        n, size = n + k, size + f.numel()
    return free, held, n, size, top


def launch_train_local(torch):
    """The local plan of PR 24's training shape (llama2-7b, 4 layers, f32,
    B 4 x S 512): its f32 logits (262 MB) pass the 256 MB budget, so the
    plan takes 2 microbatches; two microbatched steps against two plain
    ones from the same weights (params at ``LAUNCH_STEP_TOL``, losses at
    ``LAUNCH_LOSS_TOL``).  Step ms by CUDA events and peak memory."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_train_step, plan_for
    from repro_torch.training import TrainState
    from repro_torch.utils.tree import tree_leaves
    run = launch_train_run()
    plan = plan_for(run, make_local_mesh())
    log(f"launch train: the local plan of llama2-7b (4 layers) at B "
        f"{LAUNCH_TRAIN_B} x S {LAUNCH_TRAIN_S} takes "
        f"{plan.microbatches} microbatches (attention {plan.attn_impl})")
    if plan.microbatches != 2:
        fail(f"launch train: the local plan takes {plan.microbatches} "
             "microbatches, not 2")
    plain = plan_for(run, make_local_mesh(), microbatches=1)
    batches = launch_train_batches(torch, run.model)
    out, finals = {"microbatches": plan.microbatches}, {}
    for name, p in (("microbatched", plan), ("plain", plain)):
        step, _, _, model = build_train_step(run, p, torch.float32)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        st = TrainState.create(model.init_params(gen, torch.float32, "cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for b in batches:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            st, m = step(st, b)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
            losses.append(float(m["loss"]))
        out[name] = dict(step_ms=times, losses=losses,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        finals[name] = tree_leaves(st.params)
        del st
        torch.cuda.empty_cache()
    out["param_err"] = leaves_gap(finals["microbatched"],
                                  finals["plain"], rel=False)
    out["loss_err"] = max(abs(a - b) / abs(b) for a, b in zip(
        out["microbatched"]["losses"], out["plain"]["losses"]))
    del finals
    torch.cuda.empty_cache()
    log(f"launch train, one device: microbatched vs plain after "
        f"{LAUNCH_TRAIN_STEPS} steps: params max|err| "
        f"{out['param_err']:.3e} (tol {LAUNCH_STEP_TOL:g}), losses "
        f"{out['microbatched']['losses']} vs {out['plain']['losses']} "
        f"(rel {out['loss_err']:.2e}); step ms (events) microbatched "
        f"{out['microbatched']['step_ms']}, plain {out['plain']['step_ms']};"
        f" peak {out['microbatched']['peak_gb']:.2f} / "
        f"{out['plain']['peak_gb']:.2f} GB")
    if not out["param_err"] <= LAUNCH_STEP_TOL or not (
            out["loss_err"] <= LAUNCH_LOSS_TOL):
        fail(f"launch train: the microbatched step leaves the plain one "
             f"(params {out['param_err']}, losses {out['loss_err']})")
    return out


def launch_rank_prefill(torch, mesh, work, i, name, cfg_name, dt, nl,
                        knobs=None, tails=()):
    """On this rank: the prefill case ``name`` (config ``cfg_name``) under
    the prefill plan of ``mesh`` with ``knobs`` (the rank's rows, with its
    heads and its FSDP pieces, into pools of its decode layout; its slice
    of the sequence between blocks where "model" holds 2 ranks),
    ``shard_decode_state``, then the decode steps teacher-forced by one
    device's greedy tokens (under the ring plan with the decode plan's
    cut of the weights); logits against one device's rows; the
    prefill's ms by events, its peak and its collectives, and the decode
    steps' collectives.  Then, on a mesh whose "data" axis holds more
    than one rank, the prefilled state decoded again under each of
    ``tails``' decode plans (``launch_ws_tail``)."""
    from repro_torch import kernels
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed.collectives import shard_decode_state
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, local_run,
                                          plan_for, shard_batch)
    t_case = time.perf_counter()
    dtype = getattr(torch, dt)
    model = dist_model(torch, cfg_name, dt, nl)
    cfg = model.cfg
    ref = torch.load(work / f"launch_{name}.pt")
    tokens, lens = dist_tokens(torch, cfg, DIST_TP_LENS, SEED + 60 + i)
    B, S = tokens.shape
    prun = RunConfig(model=cfg, seq_len=S, global_batch=B, kind="prefill")
    drun = RunConfig(model=cfg, seq_len=S + LAUNCH_DECODE_STEPS,
                     global_batch=B, kind="decode")
    pplan = plan_for(prun, mesh, **(knobs or {}))
    dplan = plan_for(drun, mesh)

    def weights(plan):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        return model.init_params(gen, dtype, "cuda", plan=plan)

    params = weights(pplan)
    pstep = build_prefill_step(prun, pplan, dtype)[0]
    sstep = build_serve_step(drun, dplan, dtype)[0]
    mine = shard_batch({"tokens": tokens, "lens": lens,
                        "forced": ref["tokens"].T.contiguous().cuda()},
                       pplan)
    b = mine["tokens"].shape[0]
    r0 = (mesh.flat_index(pplan.batch_axes) if pplan.batch_axes else 0) * b
    state = model.init_decode_state(local_run(drun, pplan), dtype, "cuda",
                                    plan=pplan)
    pps = state["tables"].shape[2]
    state["tables"] = torch.arange(b * pps, dtype=torch.int32,
                                   device="cuda").reshape(b, 1, pps)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    stats0 = {k: dict(mesh.stats[k]) for k in ("calls", "bytes")}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        t0.record()
        logits, state = pstep(params, mine["tokens"], mine["lens"], state)
        t1.record()
        t1.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        coll = {k: {op: n - stats0[k].get(op, 0)
                    for op, n in mesh.stats[k].items()
                    if n - stats0[k].get(op, 0)} for k in ("calls", "bytes")}
        k4 = {k: v for k, v in kernels.launch_counts().items()
              if k.startswith("flex_prefill")}
        filled = state  # shard_decode_state copies the pools it keeps
        state = shard_decode_state(state, dplan)
        if pplan.layout.attn != dplan.layout.attn:  # the ring's whole
            del params
            params = weights(dplan)
        outs, decode_ms = [logits.float().cpu()], []
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        stats0 = {k: dict(mesh.stats[k]) for k in ("calls", "bytes")}
        for s in range(LAUNCH_DECODE_STEPS):
            e0.record()
            logits, state = sstep(params, mine["forced"][:, s].int(), state)
            e1.record()
            e1.synchronize()
            decode_ms.append(e0.elapsed_time(e1))
            outs.append(logits.float().cpu())
        decode_coll = {k: {op: n - stats0[k].get(op, 0)
                           for op, n in mesh.stats[k].items()
                           if n - stats0[k].get(op, 0)}
                       for k in ("calls", "bytes")}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    tails = tails if mesh.size("data") > 1 else ()
    ws = {tail: launch_ws_tail(torch, mesh, model, params, filled, drun,
                               ref, dt, kw, steps)
          for tail, kw, steps, _ in tails}
    del filled
    dry = next((dry_rank_ws(torch, mesh, kw, model, params)
                for _, kw, _, held in tails if held), None)
    rec = [p["rec"] for p in params["layers"] if "rec" in p]
    rows = slice(r0, r0 + b)
    res = logits_gap(torch.stack(outs), ref["logits"][:, rows],
                     ref["tokens"][:, rows], dt)
    res.update(rows=[r0, r0 + b], attn=sorted(set(pplan.layout.attn)),
               fsdp=list(pplan.layout.fsdp), seq=pplan.layout.seq,
               ring=pplan.layout.ring,
               weight_gb=weight_bytes(params) / 1e9,
               scheme=dplan.scheme, pool_heads=int(state["k_pages"].shape[3]),
               prefill_ms=t0.elapsed_time(t1), k4_prefill=k4,
               prefill_peak_gb=peak_gb, prefill_collectives=coll,
               launches={k: counts.get(k, 0) + sum(
                   t["launches"][k] for t in ws.values())
                   for k in LAUNCH_KEYS},
               ws=ws, dry=dry, decode_ms=decode_ms,
               decode_collectives=decode_coll, head_dim=cfg.resolved_head_dim,
               n_rec=len(rec), state=dplan.layout.state,
               rec_channels=int(rec[0]["wa"].shape[0]) if rec else None,
               lru_width=cfg.lru_width,
               seconds=time.perf_counter() - t_case)
    del params, state, logits
    torch.cuda.empty_cache()
    return res


def launch_ws_tail(torch, mesh, model, params, filled, drun, ref, dt, kw,
                   steps=LAUNCH_DECODE_STEPS):
    """The weight-stationary tail of a prefill case on this rank: the
    prefilled ``filled`` (the rank's rows under the prefill plan) taken
    by ``shard_decode_state`` into the decode plan of ``drun`` with the
    knobs ``kw`` (``ws_decode``: every row on every rank), then
    ``steps`` steps teacher-forced by one device's tokens
    with the same FSDP pieces (never gathered): every row's logits
    against one device's, each step's ms by events, the steps'
    collectives and launches, and the shard's seconds."""
    from repro_torch import kernels
    from repro_torch.distributed.collectives import shard_decode_state
    from repro_torch.launch.steps import build_serve_step, plan_for
    t_tail = time.perf_counter()
    dtype = getattr(torch, dt)
    plan = plan_for(drun, mesh, **kw)
    step = build_serve_step(drun, plan, dtype)[0]
    t0 = time.perf_counter()
    with torch.no_grad():
        state = shard_decode_state(filled, plan)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        stats0 = {k: dict(mesh.stats[k]) for k in ("calls", "bytes")}
        outs, times = [], []
        for s in range(steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            logits, state = step(params, ref["tokens"][s].cuda().int(),
                                 state)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
            outs.append(logits.float().cpu())
    counts = kernels.launch_counts()
    coll = {k: {op: n - stats0[k].get(op, 0)
                for op, n in mesh.stats[k].items()
                if n - stats0[k].get(op, 0)} for k in ("calls", "bytes")}
    got, want = torch.stack(outs), ref["logits"][1:steps + 1]
    res = logits_gap(got, want, ref["tokens"][1:steps + 1], dt)
    # each greedy token off one device's: (step, row, one device's top-2
    # margin, the rank's logit gap between the two tokens)
    top2 = want.topk(2, dim=-1).values
    mine = got.argmax(-1)
    res["flips"] = [
        [s, b, float(top2[s, b, 0] - top2[s, b, 1]),
         float(got[s, b, mine[s, b]] - got[s, b, ref["tokens"][s + 1, b]])]
        for s, b in (mine != ref["tokens"][1:steps + 1]).nonzero().tolist()]
    res.update(scheme=plan.scheme, batch_axes=list(plan.batch_axes),
               kv_axes=list(plan.kv_axes),
               act_embed=list(plan.layout.act_embed),
               rows=int(state["pos"].shape[0]),
               pages=int(state["k_pages"].shape[1]), step_ms=times,
               collectives=coll, shard_s=shard_s,
               n_layers=model.cfg.n_layers,
               launches={k: counts.get(k, 0) for k in LAUNCH_KEYS})
    del state, logits
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_tail
    return res


def dry_rank_ws(torch, mesh, kw, model=None, params=None):
    """On this rank: the dry run of the FSDP prefill case's
    weight-stationary decode step (granite-8b at 4 layers bf16, 8 rows
    of ``DIST_TP_LENS`` on ``mesh``, the decode plan's knobs ``kw``)
    against one step of the rank on the card: the state of every row
    (zeros, its tables in order, ``shard_decode_state``'s stripes), the
    rank's FSDP pieces (``params`` of ``model`` when given: the prefill
    case's, whose cut the ws plan keeps)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed.collectives import shard_decode_state
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.launch.steps import build_serve_step, plan_for
    model = model or dist_model(torch, "granite-8b", "bfloat16", 4)
    tokens, lens = dist_tokens(torch, model.cfg, DIST_TP_LENS, SEED + 90)
    B, S = tokens.shape
    run = RunConfig(model=model.cfg, seq_len=S + DRY_PREFILL_DECODE_STEPS,
                    global_batch=B, kind="decode")
    plan = plan_for(run, mesh, **kw)
    dry_plan = plan_for(run, make_dry_mesh(mesh.shape, mesh.axis_names,
                                           mesh.rank), **kw)
    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        params = model.init_params(gen, torch.bfloat16, "cuda", plan=plan)
    state = model.init_decode_state(run, torch.bfloat16, "cuda")
    pps = state["tables"].shape[2]
    state["tables"] = torch.arange(B * pps, dtype=torch.int32,
                                   device="cuda").reshape(B, 1, pps)
    state["pos"] = lens.clone()
    with torch.no_grad():
        state = shard_decode_state(state, plan)
    step = build_serve_step(run, plan, torch.bfloat16)[0]
    name = (f"decode granite-8b 4 layers bf16 {mesh.shape} ws "
            f"{plan.scheme}")
    with torch.no_grad():
        res = dry_compare(torch, name, run, plan, dry_plan, torch.bfloat16,
                          step, [params, tokens[:, 0].int().contiguous(),
                                 state], mesh)
    del state
    torch.cuda.empty_cache()
    return res


def train_reference(torch, run, plan, reference, kept):
    """``reference()`` (one device's steps of ``run``: its losses, grad
    norms, and the rank's cut of its gradients and params on the host),
    computed by one rank at a time — the others wait at a barrier with
    nothing on the card, since two ranks cannot each hold one device's
    state — and kept in ``kept`` for the later cases of the same run and
    cut."""
    import torch.distributed as dist
    from repro_torch.launch.steps import param_specs, spec_leaves
    from repro_torch.models.api import build_model
    key = (repr(run), tuple(spec_leaves(param_specs(
        build_model(run.model), plan))))
    if key not in kept:
        for turn in range(dist.get_world_size()):
            if dist.get_rank() == turn:
                kept[key] = reference()
            torch.cuda.synchronize()
            dist.barrier()
    return kept[key]


def launch_rank_train(torch, mesh, run=None, n_steps=LAUNCH_TRAIN_STEPS,
                      microbatches=None, knobs=None, kept=None):
    """On this rank: ``run`` (``launch_train_run()``, llama2-7b at 4 layers,
    by default; f32) trained under the train plan of ``mesh`` (with
    ``microbatches`` when given, and the plan's ``knobs``): one
    device's gradients at each step and its params after ``n_steps``
    plain steps (computed here from the same weights, the rank's cut
    kept on the host; for recurrentgemma-9b in turns and shared, through
    ``kept``, by its cases: ``train_reference``), then the rank's steps,
    their gradients
    (``GradTape``) and params against them; the bytes of the rank's
    state beside the whole state's, and the collectives of its steps.
    An MoE run's rank replays one device's routing (``RouteTape``, call
    by call: the near-ties that rounding flips would move a token by a
    whole expert, and AdamW's first steps turn any gradient's sign into
    ±lr), and the choices its own top-k made otherwise are counted; more
    than ``LAUNCH_ROUTE_FLIPS`` of them fail the case."""
    from repro_torch.launch.mesh import make_dry_mesh, make_local_mesh
    from repro_torch.launch.steps import (build_train_step, plan_for,
                                          shard_batch)
    from repro_torch.training import TrainState
    from repro_torch.utils.tree import tree_leaves, tree_paths
    t_case = time.perf_counter()
    run = run or launch_train_run()
    knobs = knobs or {}
    plan = plan_for(run, mesh, microbatches=microbatches, **knobs)
    dry_plan = plan_for(run, make_dry_mesh(mesh.shape, mesh.axis_names,
                                           mesh.rank),
                        microbatches=microbatches, **knobs)
    one = plan_for(run, make_local_mesh(), microbatches=1)
    grads_tape = GradTape(torch)
    with grads_tape.building():
        step, _, _, model = build_train_step(run, plan, torch.float32,
                                             lr=LAUNCH_LR)
        one_step = build_train_step(run, one, torch.float32,
                                    lr=LAUNCH_LR)[0]
    grads_tape.cut = lambda g: model.shard_params(g, plan)
    batches = launch_train_batches(torch, run.model)[:n_steps]

    def weights(p):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        return model.init_params(gen, torch.float32, "cuda", plan=p)

    tape = RouteTape(torch) if run.model.is_moe else None

    def routed(replay):
        return tape.pass_(replay) if tape else contextlib.nullcontext()

    def reference():
        full = weights(None)
        with routed(False):
            st = TrainState.create(full)
            out = {"whole_gb": storage_bytes(torch, st) / 1e9, "loss": [],
                   "gnorm": []}
            grads_tape.mode = "record"
            for b in batches:
                st, m = one_step(st, b)
                out["loss"].append(float(m["loss"]))
                out["gnorm"].append(float(m["grad_norm"]))
        out["params"] = [x.cpu() for x in tree_leaves(
            model.shard_params(st.params, plan))]
        out["grads"], grads_tape.ref = grads_tape.ref, []
        del st, full
        torch.cuda.empty_cache()
        return out

    if run.model.name == LAUNCH_RG:
        ref = train_reference(torch, run, plan, reference, kept)
    else:
        ref = reference()
    grads_tape.ref = ref["grads"]
    ref_loss, ref_gnorm, whole_gb = ref["loss"], ref["gnorm"], ref["whole_gb"]
    ref_params = ref["params"]
    torch.cuda.reset_peak_memory_stats()
    params = weights(plan)
    mine = [shard_batch(b, plan) for b in batches]
    with routed(True):
        st = TrainState.create(params)
        state_gb = storage_bytes(torch, st) / 1e9
        stats0 = {k: dict(mesh.stats[k]) for k in ("calls", "bytes")}
        times, losses, gnorms = [], [], []
        grads_tape.mode = "compare"
        for i, b in enumerate(mine):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            st, m = step(st, b)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) - grads_tape.ms(i))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        grads_tape.mode, grads_tape.ref = None, []
    grad_err = grads_tape.grad_err
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    coll = {k: {op: n - stats0[k].get(op, 0)
                for op, n in mesh.stats[k].items()
                if n - stats0[k].get(op, 0)} for k in ("calls", "bytes")}
    param_err, flagged_err, flagged, n_elems, flagged_top = flagged_gaps(
        tree_leaves(st.params), ref_params, grads_tape.flags,
        [path for path, _ in tree_paths(st.params)])
    del ref_params, ref
    grads_tape.flags = None  # the step keeps the tape, off
    experts = None
    if run.model.is_moe:  # the rank's experts, and its moments', of E
        experts = [int(t["layers"][0]["moe"]["wg"].shape[0]) for t in (
            st.params, st.opt.mu, st.opt.nu)] + [run.model.n_experts]
    torch.cuda.empty_cache()
    dry = dry_compare(torch, rank_case_name(run, plan, mesh), run, plan,
                      dry_plan, torch.float32, step, [st, mine[0]], mesh)
    res = dict(grad_err=grad_err, param_err=param_err,
               flagged=[flagged, n_elems], flagged_err=flagged_err,
               flagged_top=flagged_top,
               flagged_bound=adamw_bound(len(mine)), losses=losses,
               ref_losses=ref_loss, gnorms=gnorms, ref_gnorms=ref_gnorm,
               loss_err=max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_loss)),
               gnorm_err=max(abs(a - b) / abs(b)
                             for a, b in zip(gnorms, ref_gnorm)),
               microbatches=plan.microbatches,
               attn=sorted(set(plan.layout.attn)), vocab=plan.layout.vocab,
               fsdp=list(plan.layout.fsdp), moe=plan.layout.moe(),
               seq=plan.layout.seq, ring=plan.layout.ring,
               attn_impl=plan.attn_impl,
               experts=experts,
               route_flips=[tape.differ, tape.total] if tape else None,
               state_gb=state_gb,
               whole_state_gb=whole_gb, collectives=coll,
               step_ms=times, peak_gb=peak_gb, dry=dry,
               seconds=time.perf_counter() - t_case)
    del st, params
    torch.cuda.empty_cache()
    return res


def launch_rank(torch, work):
    """The launch phase's cases on this rank: the (2, 1) and (1, 2) meshes
    over the 2 ranks (made in one order on both), each prefill case, then
    each train case."""
    from repro_torch.launch.mesh import make_mesh
    meshes = {shape: make_mesh(shape) for shape in LAUNCH_MESHES}
    out = {"prefill": {}, "train": {}}
    for shape, mesh in meshes.items():
        for i, (name, cfg_name, dt, nl, on, knobs, tails) in enumerate(
                launch_prefill_cases()):
            if shape in on:
                out["prefill"][f"{shape} {name}"] = launch_rank_prefill(
                    torch, mesh, work, i, name, cfg_name, dt, nl, knobs,
                    tails)
    # the dry run of a ws decode step (a dry phase rank case)
    out["dry"] = [c["dry"] for c in out["prefill"].values() if c["dry"]]
    kept = {}  # the references computed in turns (``train_reference``)
    for name, shape, run, n_steps, mb, knobs in launch_train_cases():
        out["train"][name] = launch_rank_train(torch, meshes[shape], run,
                                               n_steps, mb, knobs, kept)
    out["host_copies"] = {str(s): dict(m.host_copies)
                          for s, m in meshes.items()}
    return out


def launch_serve(torch):
    """``launch.serve`` at full width: llama2-7b in f32 (the engine's
    default dtype, as the JAX launcher serves), weights from seed 0,
    ``LAUNCH_SERVE_REQUESTS`` requests at the CLI's defaults, paged (K4,
    K1, K2) and ``--no-paged`` (K4, decode attention in plain ops)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    args = serve.parse_args(["--arch", "llama2-7b", "--requests",
                             str(LAUNCH_SERVE_REQUESTS)])
    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = build_model(cfg).init_params(gen, torch.float32, "cuda")
    out = {}
    for name, paged in (("paged", True), ("baseline", False)):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        _, reqs, report = serve.serve(
            cfg, params, requests=args.requests, max_new=args.max_new,
            max_slots=args.max_slots, max_seq_len=args.max_seq_len,
            pool_tokens=args.pool_tokens, paged=paged,
            temperature=args.temperature, log_fn=log)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        report["launches"] = {k: counts.get(k, 0) for k in LAUNCH_KEYS}
        report["new_tokens"] = [len(r.output) for r in reqs]
        out[name] = report
        log(f"launch serve {name}: {report['tokens']} tokens, "
            f"{report['tok_s']:.1f} tok/s, {report['steps']} steps, "
            f"{report['preemptions']} preemptions, pool "
            f"{report['pool_mib']:.1f} MiB, overhead "
            f"{report['overhead_frac'] * 100:.1f} %, TTFT "
            f"{[round(t, 3) for t in report['ttft_s']]} s; launches "
            f"{report['launches']}")
        if report["new_tokens"] != [args.max_new] * args.requests:
            fail(f"launch serve {name}: new tokens {report['new_tokens']}")
        must = (("flex_prefill/tf32x3", "paged_decode", "combine/decode")
                if paged else ("flex_prefill/tf32x3",))
        if any(report["launches"][k] <= 0 for k in must):
            fail(f"launch serve {name}: kernels {must} not all launched "
                 f"({report['launches']})")
        if not paged and report["launches"]["paged_decode"]:
            fail("launch serve baseline: K1 launched")
    del params
    torch.cuda.empty_cache()
    return out


def cut_as_named(name, c, calls):
    """Whether a launch case ran the cut its name says: on (1, 2) the
    sequence cut (reduce-scatters along it) unless the name says
    "no-seq" (the row-parallel sums all-reduced, no reduce-scatter),
    never on (2, 1); the ring (send/recv) where the name says so."""
    no_seq = "no-seq" in name
    seq = name.startswith("(1, 2)") and not no_seq
    return (c["seq"] == seq and c["ring"] == ("ring" in name)
            and (calls.get("send_recv", 0) > 0) == c["ring"]
            and (not seq or calls.get("reduce_scatter", 0) > 0)
            and (not no_seq or (calls.get("all_reduce", 0) > 0
                                and not calls.get("reduce_scatter"))))


def ws_tail_misses(name, r, t):
    """Log a weight-stationary tail of rank ``r`` (``launch_ws_tail``)
    and return its misses: logits beyond the bound, or a greedy token
    off one device's where one device's own top-2 margin exceeds that
    bound (a margin inside the tolerance the logits are held to is a tie
    that bf16 decides either way: such flips are logged); a plan with
    batch axes, or activations not cut over "data", or fewer than every
    row; an all-gather other than kvp's
    merge (one a layer and step: no weight is gathered) or an
    all-reduce count other than the layers' (per layer and step the two
    RMSNorms, q/k/v and the MLP's up products, then the final norm and
    the logits), any other collective; K1, and K2 after it (in the
    decode op under tp, across the ranks under kvp), not launched."""
    steps, L = len(t["step_ms"]), t["n_layers"]
    calls = t["collectives"]["calls"]
    gathers = steps * L if t["scheme"] == "kvp" else 0
    reduces = steps * (4 * L + 2)
    k2 = "combine/dist" if t["scheme"] == "kvp" else "combine/decode"
    log(f"launch rank {r} decode {name} ({t['scheme']}, batch axes "
        f"{t['batch_axes']}, kv axes {t['kv_axes']}, activations over "
        f"{t['act_embed']}, {t['rows']} rows, {t['pages']} pages a "
        f"layer): logits vs one device max|err| {t['max_err']:.3e} (bound "
        f"{t['bound']:.3e}, scale {t['scale']:.3f}), agreement "
        f"{t['argmax_agreement']:.3f}; step ms (events) "
        f"{[round(x, 2) for x in t['step_ms']]}; collectives "
        f"{t['collectives']} (all-gathers expected {gathers}, all-reduces "
        f"{reduces}); "
        f"launches {t['launches']}; shard_decode_state {t['shard_s']:.2f} s,"
        f" the tail {t['seconds']:.2f} s; greedy flips (step, row, one "
        f"device's top-2 margin, the rank's gap) {t['flips']}")
    misses = []
    if (not t["finite"] or t["max_err"] > t["bound"]
            or any(f[2] > t["bound"] for f in t["flips"])):
        misses.append(f"launch decode {name} rank {r}: logits max|err| "
                      f"{t['max_err']} (bound {t['bound']}), greedy flips "
                      f"{t['flips']}")
    if (t["batch_axes"] or t["act_embed"] != ["data"]
            or t["rows"] != len(DIST_TP_LENS)):
        misses.append(f"launch decode {name} rank {r}: batch axes "
                      f"{t['batch_axes']}, activations over "
                      f"{t['act_embed']}, {t['rows']} rows")
    if (calls.get("all_gather", 0) != gathers
            or calls.get("all_reduce", 0) != reduces
            or set(calls) - {"all_gather", "all_reduce"}):
        misses.append(f"launch decode {name} rank {r}: collectives {calls}"
                      f" (all-gathers {gathers}, all-reduces {reduces})")
    if t["launches"]["paged_decode"] <= 0 or t["launches"][k2] <= 0:
        misses.append(f"launch decode {name} rank {r}: K1 or {k2} not "
                      f"launched ({t['launches']})")
    return misses


def rglru_misses(name, r, c):
    """Log the ``R`` layers of a recurrentgemma-9b prefill case of rank
    ``r`` and return its misses: channels other than ``lru_width`` / 2 a
    rank on (1, 2) (the whole on (2, 1)); decode steps whose
    reduce-scatters are not exactly one a ``R`` layer and step (the
    gates' packed ``wa|wi`` partials, none on (2, 1)); a prefill on
    (1, 2) without them."""
    steps = len(c["decode_ms"])
    calls, nbytes = (c["decode_collectives"]["calls"],
                     c["decode_collectives"]["bytes"])
    pcalls = c["prefill_collectives"]["calls"]
    cut = name.startswith("(1, 2)")
    rs = steps * c["n_rec"] if cut else 0
    log(f"launch rank {r} prefill {name}: R layers {c['n_rec']}, channels "
        f"{c['rec_channels']} of {c['lru_width']} a rank (cut "
        f"{c['state']}); decode collectives a step: reduce-scatters "
        f"{calls.get('reduce_scatter', 0) / steps:g} "
        f"({nbytes.get('reduce_scatter', 0) / steps:.4g} B), all-reduces "
        f"{calls.get('all_reduce', 0) / steps:g} "
        f"({nbytes.get('all_reduce', 0) / steps:.4g} B), all-gathers "
        f"{calls.get('all_gather', 0) / steps:g}; the prefill's "
        f"reduce-scatters {pcalls.get('reduce_scatter', 0)} "
        f"({c['prefill_collectives']['bytes'].get('reduce_scatter', 0):.4g}"
        f" B)")
    want = c["lru_width"] // (DIST_RANKS if cut else 1)
    if (c["rec_channels"] != want or c["state"] != cut
            or calls.get("reduce_scatter", 0) != rs
            or (cut and not pcalls.get("reduce_scatter"))):
        return [f"launch prefill {name} rank {r}: channels "
                f"{c['rec_channels']} (want {want}), cut {c['state']}, "
                f"decode reduce-scatters {calls.get('reduce_scatter', 0)} "
                f"(want {rs})"]
    return []


def launch_check(ranks):
    """The launch cases of the ranks' results: log each and fail on any
    bound; returns the ranks' launches summed per kernel key, those at
    head dim 256 (recurrentgemma-9b's, the D-256 instances) apart."""
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    d256 = dict.fromkeys(LAUNCH_KEYS, 0)
    misses = []  # every case is logged before the run fails on any
    for res in ranks:
        r = res["rank"]
        for name, c in res["launch"]["prefill"].items():
            log(f"launch rank {r} prefill {name} (rows {c['rows']}, attn "
                f"{c['attn']}, FSDP over {c['fsdp']}, sequence cut "
                f"{c['seq']}, ring {c['ring']}, weights "
                f"{c['weight_gb']:.2f} GB, pools of {c['pool_heads']} kv "
                f"heads, decode {c['scheme']}): logits vs one device max|err| "
                f"{c['max_err']:.3e} (bound {c['bound']:.3e}, scale "
                f"{c['scale']:.3f}), agreement {c['argmax_agreement']:.3f};"
                f" prefill {c['prefill_ms']:.1f} ms (events), decode "
                f"steps {[round(x, 2) for x in c['decode_ms']]} ms, peak "
                f"{c['prefill_peak_gb']:.2f} GB, collectives "
                f"{c['prefill_collectives']}; K4 in the "
                f"prefill {c['k4_prefill']}; launches {c['launches']}; "
                f"{c['seconds']:.1f} s")
            if not c["finite"] or c["max_err"] > c["bound"]:
                misses.append(
                    f"launch prefill {name} rank {r}: logits max|err| "
                    f"{c['max_err']} beyond {c['bound']}")
            # the ring attends in plain ops: K4 runs on every other prefill
            if (sum(c["k4_prefill"].values()) > 0) == c["ring"] or any(
                    c["launches"][k] <= 0
                    for k in ("paged_decode", "combine/decode")):
                misses.append(
                    f"launch prefill {name} rank {r}: K4, K1 or K2 "
                    f"launched where it should not be or not where it "
                    f"should ({c['k4_prefill']}, {c['launches']}, ring "
                    f"{c['ring']})")
            calls = c["prefill_collectives"]["calls"]
            # the (2, 1) prefills reduce-scatter nothing (FSDP gathers)
            if not cut_as_named(name, c, calls) or (
                    not c["seq"] and calls.get("reduce_scatter")):
                misses.append(
                    f"launch prefill {name} rank {r}: sequence cut "
                    f"{c['seq']}, ring {c['ring']}, collectives {calls}")
            if ("fsdp" in name) != (c["fsdp"] == ["data"]):
                misses.append(
                    f"launch prefill {name} rank {r}: FSDP over "
                    f"{c['fsdp']}")
            for tail, t in c["ws"].items():
                misses += ws_tail_misses(f"{name} {tail}", r, t)
            if c["n_rec"]:
                misses += rglru_misses(name, r, c)
            for k in LAUNCH_KEYS:
                (d256 if c["head_dim"] == 256 else launches)[k] += (
                    c["launches"][k])
        for name, c in res["launch"]["train"].items():
            log(f"launch rank {r} train {name} (attn {c['attn']}, vocab cut "
                f"{c['vocab']}, FSDP over {c['fsdp']}, {c['microbatches']} "
                f"microbatch(es), sequence cut {c['seq']}, ring {c['ring']},"
                f" attention {c['attn_impl']}): grads "
                f"vs one device {c['grad_err']:.3e} (tol "
                f"{LAUNCH_GRAD_TOL:g}, relative to 1 + |g|), params after "
                f"{len(c['losses'])} step(s) {c['param_err']:.3e} (tol "
                f"{LAUNCH_STEP_TOL:g}) where every step's gradient lay "
                f"within {LAUNCH_GRAD_SHARE:g} of one device's, "
                f"{c['flagged_err']:.3e} (AdamW's bound "
                f"{c['flagged_bound']:.3e}) at the {c['flagged'][0]} of "
                f"{c['flagged'][1]} elements where one did not (at most "
                f"{LAUNCH_ROUNDING_SHARE:g} of them; most in "
                f"{c['flagged_top']}), losses {c['losses']} vs "
                f"{c['ref_losses']} (rel {c['loss_err']:.2e}), grad norms "
                f"{c['gnorms']} vs {c['ref_gnorms']} (rel "
                f"{c['gnorm_err']:.2e}); state {c['state_gb']:.3f} GB of the "
                f"whole {c['whole_state_gb']:.3f} GB; the steps' collectives "
                f"{c['collectives']}; step ms (events) "
                f"{[round(t, 2) for t in c['step_ms']]}, peak "
                f"{c['peak_gb']:.2f} GB; {c['seconds']:.1f} s")
            flagged, n_elems = c["flagged"]
            if not (c["grad_err"] <= LAUNCH_GRAD_TOL
                    and c["param_err"] <= LAUNCH_STEP_TOL
                    and c["flagged_err"] <= c["flagged_bound"]
                    and flagged <= LAUNCH_ROUNDING_SHARE * n_elems
                    and c["loss_err"] <= LAUNCH_LOSS_TOL
                    and c["gnorm_err"] <= LAUNCH_LOSS_TOL):
                misses.append(
                    f"launch train {name} rank {r}: grads {c['grad_err']}, "
                    f"params {c['param_err']} (and {c['flagged_err']} at "
                    f"{flagged} of {n_elems} elements), losses "
                    f"{c['loss_err']}, grad norms {c['gnorm_err']}")
            calls = c["collectives"]["calls"]
            if not cut_as_named(name, c, calls):
                misses.append(
                    f"launch train {name} rank {r}: sequence cut "
                    f"{c['seq']}, ring {c['ring']}, collectives {calls}")
            if "fsdp" in name and not (
                    c["fsdp"] == ["data"]
                    and c["collectives"]["calls"].get("all_gather", 0) > 0
                    and c["collectives"]["calls"].get("reduce_scatter", 0) > 0
                    and 0.45 <= c["state_gb"] / c["whole_state_gb"] <= 0.55):
                misses.append(
                    f"launch train {name} rank {r}: FSDP over {c['fsdp']} "
                    f"holds {c['state_gb']} of {c['whole_state_gb']} GB with "
                    f"collectives {c['collectives']['calls']}")
            if "experts" in name:
                sched = name.split("experts ")[1].split()[0]
                a2a = (c["collectives"]["calls"].get("all_to_all", 0),
                       c["collectives"]["bytes"].get("all_to_all", 0))
                flips, choices = c["route_flips"]
                log(f"launch rank {r} train {name}: schedule {c['moe']}, "
                    f"experts held (params, mu, nu) of E "
                    f"{c['experts']}; all-to-all calls {a2a[0]}, "
                    f"{a2a[1] / 1e9:.4f} GB in {len(c['step_ms'])} steps; "
                    f"one device's routing replayed: {flips} of {choices} "
                    f"expert choices of the rank's own top-k differed")
                held, E = c["experts"][:3], c["experts"][3]
                if (c["moe"] != sched or held != [E // 2] * 3
                        or (a2a[0] > 0) != (sched == "ep")
                        or flips > LAUNCH_ROUTE_FLIPS * choices):
                    misses.append(
                        f"launch train {name} rank {r}: schedule "
                        f"{c['moe']}, experts {c['experts']}, all-to-all "
                        f"{a2a}, route flips {flips} of {choices}")
        log(f"launch rank {r}: gloo host copies "
            f"{res['launch']['host_copies']}")
        ws_s = sum(t["seconds"] for c in res["launch"]["prefill"].values()
                   for t in c["ws"].values())
        log(f"launch rank {r}: the ws decode tails {ws_s:.1f} s, their dry "
            f"cases {sum(d['seconds'] for d in res['launch']['dry']):.1f} s")
    if misses:
        fail("; ".join(misses))
    return launches, d256


DRY_PEAK_TOL = 0.10  # the dry run's predicted peak against the card's
DRY_PREFILL_DECODE_STEPS = 4


def storage_bytes(torch, tree):
    """Bytes of the distinct storages of a tree's tensors."""
    from repro_torch.utils.tree import tree_leaves
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def dry_compare(torch, name, run, plan, dry_plan, dtype, step, args,
                mesh=None, **kw):
    """The dry run of ``run`` under ``dry_plan`` (``launch.steps.
    dry_step``, fake tensors on the CPU) against ``step(*args)`` on the
    card: the predicted peak against ``max_memory_allocated`` after
    ``reset_peak_memory_stats`` (less what was allocated before the step
    beyond its arguments), the FLOPs of the aten ops against
    ``FlopCounterMode`` over the real step, the stand-ins' launches by
    route against the ``launch_counts()`` deltas, the collectives' calls
    and bytes against the mesh's ``stats``; the roofline terms beside the
    measured step ms.  Two real steps: one measured, one counted."""
    from repro_torch import kernels
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch.steps import dry_step
    from torch.utils.flop_counter import FlopCounterMode
    t_case = time.perf_counter()
    rec = dry_step(run, dry_plan, dtype, **kw)
    trace_s = time.perf_counter() - t_case
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    arg_bytes = storage_bytes(torch, args)
    other = torch.cuda.memory_allocated() - arg_bytes
    stats0 = ({k: dict(mesh.stats[k]) for k in ("calls", "bytes")}
              if mesh is not None else None)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = step(*args)
    t1.record()
    t1.synchronize()
    step_ms = t0.elapsed_time(t1)
    peak = torch.cuda.max_memory_allocated() - other
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    coll = ({k: {op: n - stats0[k].get(op, 0)
                 for op, n in mesh.stats[k].items()
                 if n - stats0[k].get(op, 0)} for k in ("calls", "bytes")}
            if mesh is not None else {"calls": {}, "bytes": {}})
    del out
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    torch.cuda.synchronize()
    del out
    torch.cuda.empty_cache()
    cost = ca.extract_cost(rec)
    dry_coll = {k: dict(rec.stats[k]) for k in ("calls", "bytes")}
    terms = ca.roofline_terms(cost["flops"], cost["bytes"],
                              ca.collective_bytes(rec.stats))
    res = dict(
        name=name, predicted_peak_gb=rec.peak_bytes / 1e9,
        measured_peak_gb=peak / 1e9, other_gb=other / 1e9,
        argument_gb=arg_bytes / 1e9,
        predicted_argument_gb=rec.argument_bytes / 1e9,
        peak_err=rec.peak_bytes / peak - 1,
        flops=rec.flops, measured_flops=float(fc.get_total_flops()),
        kernel_flops=cost["kernel_flops"], bytes=cost["bytes"],
        launches=dict(rec.kernels.launches), measured_launches=launches,
        collectives=dry_coll, measured_collectives=coll,
        roofline_ms={k: 1e3 * v for k, v in terms.items()
                     if k.endswith("_s")},
        bottleneck=terms["bottleneck"], step_ms=step_ms, trace_s=trace_s,
        seconds=time.perf_counter() - t_case)
    res["ok"] = (abs(res["peak_err"]) <= DRY_PEAK_TOL
                 and res["flops"] == res["measured_flops"]
                 and res["launches"] == launches and dry_coll == coll)
    return res


def dry_local_cases(torch):
    """The dry run against the card on one device: llama2-7b at 4 layers
    in f32, the launch phase's train shape (B 4 x S 512, 2 microbatches
    under the local plan); then at full depth in bf16 the prefill of the
    launch phase's 8 prompts (``DIST_TP_LENS``, K4) and one decode step
    after them (K1 + K2)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, build_train_step,
                                          plan_for)
    from repro_torch.training import TrainState
    out = []
    run = launch_train_run()
    plan = plan_for(run, make_local_mesh())
    step, _, _, model = build_train_step(run, plan, torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    st = TrainState.create(model.init_params(gen, torch.float32, "cuda"))
    batch = launch_train_batches(torch, run.model)[0]
    out.append(dry_compare(torch, "train llama2-7b 4 layers f32 (1, 1)",
                           run, plan, plan, torch.float32, step,
                           [st, batch]))
    del st, batch, step, model
    torch.cuda.empty_cache()

    model = dist_model(torch, "llama2-7b", "bfloat16", None)
    cfg = model.cfg
    tokens, lens = dist_tokens(torch, cfg, DIST_TP_LENS, SEED + 60)
    B, S = tokens.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = model.init_params(gen, torch.bfloat16, "cuda")
    for kind in ("prefill", "decode"):
        seq = S if kind == "prefill" else S + DRY_PREFILL_DECODE_STEPS
        run = RunConfig(model=cfg, seq_len=seq, global_batch=B, kind=kind)
        plan = plan_for(run, make_local_mesh())
        state = model.init_decode_state(run, torch.bfloat16, "cuda")
        pps = state["tables"].shape[2]
        state["tables"] = torch.arange(B * pps, dtype=torch.int32,
                                       device="cuda").reshape(B, 1, pps)
        if kind == "prefill":
            step = build_prefill_step(run, plan, torch.bfloat16)[0]
            args = [params, tokens.int(), lens, state]
        else:
            state["pos"] = lens.clone()
            step = build_serve_step(run, plan, torch.bfloat16)[0]
            args = [params, tokens[:, 0].int().contiguous(), state]
        out.append(dry_compare(torch, f"{kind} llama2-7b full depth bf16 "
                               f"B {B} x S {S} (1, 1)", run, plan, plan,
                               torch.bfloat16, step, args))
        del state, args, step
        torch.cuda.empty_cache()
    del params, model
    torch.cuda.empty_cache()
    return out


def dry_rank_train(torch, mesh, run=None, microbatches=None, knobs=None):
    """On this rank: the dry run of the launch phase's train case ``run``
    (``launch_train_run()`` by default) under the train plan of ``mesh``
    (with ``microbatches`` when given and the plan's ``knobs``; a dry
    mesh of its shape, seen from this rank) against one step of the rank
    on the card."""
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.launch.steps import build_train_step, plan_for, shard_batch
    from repro_torch.training import TrainState
    run = run or launch_train_run()
    knobs = knobs or {}
    plan = plan_for(run, mesh, microbatches=microbatches, **knobs)
    dry_plan = plan_for(run, make_dry_mesh(mesh.shape, mesh.axis_names,
                                           mesh.rank),
                        microbatches=microbatches, **knobs)
    step, _, _, model = build_train_step(run, plan, torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    st = TrainState.create(model.init_params(gen, torch.float32, "cuda",
                                             plan=plan))
    batch = shard_batch(launch_train_batches(torch, run.model)[0], plan)
    res = dry_compare(torch, rank_case_name(run, plan, mesh), run, plan,
                      dry_plan, torch.float32, step, [st, batch], mesh)
    del st, batch
    torch.cuda.empty_cache()
    return res


def dry_check(cases):
    """Log each dry-run case and fail on a miss: a peak beyond
    ``DRY_PEAK_TOL``, FLOPs, launches or collectives that differ."""
    for c in cases:
        log(f"dry run {c['name']}: peak predicted "
            f"{c['predicted_peak_gb']:.3f} GB, measured "
            f"{c['measured_peak_gb']:.3f} GB ({c['peak_err'] * 100:+.2f} %,"
            f" bound {DRY_PEAK_TOL * 100:.0f} %; arguments "
            f"{c['predicted_argument_gb']:.3f} / {c['argument_gb']:.3f} GB, "
            f"{c['other_gb']:.3f} GB held outside the step); FLOPs "
            f"{c['flops']:.6e} vs {c['measured_flops']:.6e} (+ kernels "
            f"{c['kernel_flops']:.4e}); launches {c['launches']} vs "
            f"{c['measured_launches']}; collectives {c['collectives']} vs "
            f"{c['measured_collectives']}; roofline ms "
            + ", ".join(f"{k} {v:.3f}" for k, v in c["roofline_ms"].items())
            + f" ({c['bottleneck']}) beside the measured step "
            f"{c['step_ms']:.3f} ms (events); trace {c['trace_s']:.1f} s, "
            f"case {c['seconds']:.1f} s")
        if not c["ok"]:
            fail(f"dry run {c['name']}: the prediction misses the card")


def dry_phase(torch, ranks_dry=()):
    """The dry run against the card: the one-device cases here, and the
    rank cases the 2-rank harness ran (``ranks_dry``); fails on a miss."""
    t0 = time.perf_counter()
    cases = dry_local_cases(torch) + list(ranks_dry)
    dry_check(cases)
    log(f"dry phase: {time.perf_counter() - t0:.1f} s here")
    return cases


def dist_phase(torch, chk, parts=("dist", "launch")):
    """The decode step across 2 ranks on this one card (``"dist"``) and
    the launch entry points (``"launch"``): references on one device
    first (saved, then freed), then 2 processes in one gloo group on
    cuda:0 run every case of ``parts`` under its plan; a rank that fails
    fails the run; then ``launch.serve`` on one device.  Returns the
    results, the ranks' launches summed per kernel key and K2's "dist"
    row."""
    import shutil
    from repro_torch.kernels import build
    t_phase = time.perf_counter()
    # references and results: hundreds of MB, in the ignored build dir
    work = build.BUILD_DIR / "dist_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        return _dist_phase(torch, chk, work, t_phase, parts)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _dist_phase(torch, chk, work, t_phase, parts):
    import multiprocessing as mp
    out = {}
    if "dist" in parts:
        out["references"] = dist_references(torch, work)
        log(f"-- dist references done in "
            f"{time.perf_counter() - t_phase:.1f} s")
    if "launch" in parts:
        t0 = time.perf_counter()
        out["launch"] = {"references": launch_references(torch, work),
                         "train_local": launch_train_local(torch)}
        log(f"-- launch references and the local train plan done in "
            f"{time.perf_counter() - t0:.1f} s")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(r, DIST_RANKS, str(work),
                                                 str(SRC), parts))
             for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, 560 - (time.perf_counter() - t0)))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    ranks = []
    for r, p in enumerate(procs):
        path = work / f"rank{r}.json"
        if not path.exists():
            fail(f"dist rank {r}: no result (exit code {p.exitcode})")
        res = json.loads(path.read_text())
        if "error" in res or p.exitcode != 0:
            fail(f"dist rank {r} failed (exit code {p.exitcode}):\n"
                 f"{res.get('error', '')}")
        ranks.append(res)
    ranks_s = time.perf_counter() - t0
    out.update(ranks=ranks, ranks_seconds=ranks_s)
    # the dry run's rank cases: in the launch cases' train steps, or alone
    out["dry_ranks"] = [c for res in ranks for c in res.get("dry", [
        t["dry"] for t in res.get("launch", {}).get("train", {}).values()]
        + res.get("launch", {}).get("dry", []))]
    if "launch" in parts:
        t0 = time.perf_counter()
        out["launch"]["launches"], out["launch"]["launches_d256"] = (
            launch_check(ranks))
        out["launch"]["serve"] = launch_serve(torch)
        for report in out["launch"]["serve"].values():
            for k, n in report["launches"].items():
                out["launch"]["launches"][k] += n
        out["launch"]["serve_seconds"] = time.perf_counter() - t0
        log(f"launch phase: serve {out['launch']['serve_seconds']:.1f} s; "
            f"launches (ranks and serve) {out['launch']['launches']}")
    if "dist" in parts:
        out.update(_dist_check(torch, chk, ranks))
    seconds = time.perf_counter() - t_phase
    log(f"dist phase ({'+'.join(parts)}): {seconds:.1f} s (ranks "
        f"{ranks_s:.1f} s); collective times are gloo between processes on "
        "one card, not NVLink")
    out["seconds"] = seconds
    return out


def _dist_check(torch, chk, ranks):
    """The distributed cases of the ranks' results: log each, fail on any
    bound; K2's "dist" row.  Returns the ranks' launches and the row."""
    launches = dict.fromkeys(DIST_KEYS, 0)
    for res in ranks:
        log(f"dist rank {res['rank']}: gloo host copies {res['host_copies']}"
            f" (ops gloo refused on CUDA tensors: {res['host_ops']})")
        for name, c in res["cases"].items():
            log(f"dist rank {res['rank']} {name} ({c['scheme']}, attention "
                f"{c['attn']}, heads of {c['heads'][0]} held in wq / wo "
                f"{c['heads'][1]} / {c['heads'][2]}): logits vs "
                f"one device max|err| {c['max_err']:.3e} (bound "
                f"{c['bound']:.3e}, scale {c['scale']:.3f}), greedy "
                f"agreement {c['argmax_agreement']:.3f}, divergence step "
                f"{c['divergence_step']}; step {c['step_ms']:.3f} ms "
                f"(events), device {fmt(c['device_ms'])}; weights "
                f"{c['weight_gb']:.2f} GB; launches {c['launches']}; "
                f"seconds: weights {c['init_s']:.1f}, prefill "
                f"{c['prefill_s']:.1f}, decode {c['decode_s']:.1f}; "
                f"collectives {c['collectives']}")
            if not c["finite"] or c["max_err"] > c["bound"]:
                fail(f"dist {name} rank {res['rank']}: logits max|err| "
                     f"{c['max_err']} beyond {c['bound']}")
            # kvp cuts the q heads over the ranks (GSPMD's heads rule)
            H = c["heads"][0]
            if c["scheme"] == "kvp" and (
                    c["attn"] != ["q_heads"]
                    or c["heads"][1:] != [H // DIST_RANKS] * 2):
                fail(f"dist {name} rank {res['rank']}: kvp holds "
                     f"{c['heads'][1:]} of {H} heads under {c['attn']}, "
                     f"not {H // DIST_RANKS} under 'q_heads'")
            # MoE: E/2 experts a rank under the case's schedule, the
            # tokens exchanged by all-to-all only under EP
            if name in DIST_MOE:
                a2a = c["collectives"].get("all_to_all", {}).get("calls", 0)
                log(f"dist rank {res['rank']} {name}: schedule {c['moe']}, "
                    f"experts {c['experts'][0]} of {c['experts'][1]}, "
                    f"all-to-all calls {a2a}")
                if (c["moe"] != DIST_MOE[name]
                        or c["experts"][0] * DIST_RANKS != c["experts"][1]
                        or (a2a > 0) != (c["moe"] == "ep")):
                    fail(f"dist {name} rank {res['rank']}: schedule "
                         f"{c['moe']}, experts {c['experts']}, all-to-all "
                         f"calls {a2a}")
            # K1, then K2: after K1 in the decode op, or across the ranks
            must = ["paged_decode", "combine/dist" if c["scheme"] == "kvp"
                    else "combine/decode"]
            if any(c["launches"][k] <= 0 for k in must):
                fail(f"dist {name} rank {res['rank']}: kernels {must} not "
                     f"all launched ({c['launches']})")
            for k in DIST_KEYS:
                launches[k] += c["launches"][k]
        c = res["fault"]
        log(f"dist rank {res['rank']} planted fault ({DIST_FAULT_CASE}, "
            f"rank 1's stripe dropped from the merge, {DIST_FAULT_STEPS} "
            f"steps): logits max|err| {c['max_err']:.3e} = "
            f"{c['max_err'] / c['bound']:.1f} x the bound {c['bound']:.3e}")
        if not c["max_err"] > c["bound"]:
            fail(f"dist rank {res['rank']}: the kvp check does not see a "
                 f"dropped stripe ({c['max_err']} within {c['bound']})")
        for dt, c in res["dp"].items():
            log(f"dist rank {res['rank']} dp attention (nemotron-4-15b "
                f"heads, G 6 over 2 ranks) {dt}: max|err| {c['max_err']:.3e}"
                f" vs one device's K1 + K2 (tol {c['tol']:g})")
            if not c["finite"] or c["max_err"] > c["tol"]:
                fail(f"dist dp {dt} rank {res['rank']}: {c['max_err']}")
        for w, c in res["ring"].items():
            log(f"dist rank {res['rank']} ring attention S {DIST_RING_S}, "
                f"window {w}: max|err| {c['max_err']:.3e} vs the chunked "
                f"path (tol {F32_TOL:g}), {c['seconds']:.2f} s")
            if not c["finite"] or c["max_err"] > F32_TOL:
                fail(f"dist ring window {w} rank {res['rank']}: "
                     f"{c['max_err']}")
    row = k2_dist_row(torch, chk)
    log(f"K2 across ranks (combine/dist): {fmt(row['ms'])}, device "
        f"{fmt(row['device_ms'])}, plain {fmt(row['plain_ms'])}, bound "
        f"{row['bound_ms']:.4f} ms (bytes); launches in the ranks "
        f"{launches['combine/dist']}")
    return dict(launches=launches, k2=row)


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and run the kernel phase only (a first "
                    "check of new kernels); prints no result line")
    ap.add_argument("--time-k4", action="store_true",
                    help="build and time K4's causal & padding at the "
                    "main path's shapes only (an A/B probe); prints no "
                    "result line")
    ap.add_argument("--time-main", action="store_true",
                    help="build and time K1, K3 and K4 at the main path's "
                    "shapes only (an A/B probe); prints no result line")
    ap.add_argument("--train-only", action="store_true",
                    help="build and run the training phase only; prints "
                    "no result line")
    ap.add_argument("--dist-only", action="store_true",
                    help="build and run the distributed phase only (2 "
                    "ranks in one gloo group on this card); prints no "
                    "result line")
    ap.add_argument("--launch-only", action="store_true",
                    help="build and run the launch phase only (the plans' "
                    "prefill and train steps on 2 ranks in one gloo group "
                    "on this card, launch.serve); prints no result line")
    ap.add_argument("--dry-only", action="store_true",
                    help="build and run the dry phase only (the dry run's "
                    "predictions against one device's steps and the "
                    "2-rank train steps); prints no result line")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src/ directory whose repro_torch to run "
                    "(default: this checkout's; another tree's for an A/B "
                    "call with --time-k4)")
    args = ap.parse_args()
    only_kernels = args.kernels_only
    set_src(args.src.resolve())
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity needs IEEE
    torch.backends.cudnn.allow_tf32 = False

    t_run = time.perf_counter()
    smi = nvidia_smi()
    log(smi)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.get_lib()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds:.1f} s)")
    OUT.mkdir(exist_ok=True)
    (OUT / "build_log.txt").write_text(build.build_log)
    log_ptxas(build.build_log)
    hgmma, tf32_hgmma, tf32_hmma = count_mma(build.library_path())
    log(f"HGMMA instructions in the built library: {hgmma}; in the "
        f"split-TF32 kernels: {tf32_hgmma} TF32 HGMMA (q.K and p.V), "
        f"{tf32_hmma} TF32 HMMA")
    if hgmma <= 0:
        fail("the library holds no HGMMA: the tensor-core kernels do not "
             "use wgmma")
    if tf32_hgmma <= 0:
        fail("the split-TF32 kernels hold no TF32 HGMMA: their products do "
             "not run on the tensor cores")

    if args.time_k4:
        time_k4(torch)
        return
    if args.time_main:
        time_main(torch)
        return
    if args.train_only:
        log(json.dumps(train_phase(torch)["llama2_7b"]["profile_step"]))
        (OUT / "chip_smoke.log").write_text("\n".join(LOG))
        return
    chk = Checker(torch)
    if args.dry_only:
        dist = dist_phase(torch, chk, ("dry",))
        dry = dry_phase(torch, dist["dry_ranks"])
        (OUT / "chip_smoke.log").write_text("\n".join(LOG))
        (OUT / "chip_smoke_dry.json").write_text(json.dumps(
            dry, indent=1, default=str))
        return
    if args.dist_only or args.launch_only:
        dist = dist_phase(torch, chk,
                          ("dist",) if args.dist_only else ("launch",))
        log(json.dumps({k: dist[k] for k in ("launches", "k2")
                        if k in dist}))
        (OUT / "chip_smoke.log").write_text("\n".join(LOG))
        (OUT / "chip_smoke_dist.json").write_text(json.dumps(
            dist, indent=1, default=str))
        return
    rows = kernel_phase(torch, chk)
    if only_kernels:
        log(json.dumps({f"{k}/{d}": v for (k, d), v in rows.items()}))
        log("kernel phase passed (--kernels-only: no engine phases, no "
            "result line)")
        (OUT / "chip_smoke.log").write_text("\n".join(LOG))
        return
    def done(phase):
        log(f"-- {phase} done at {time.perf_counter() - t_run:.1f} s")

    done("build and kernel phase")
    model = model_phase(torch)
    done("model phase")
    torch.cuda.empty_cache()
    engine, params = engine_phase(torch)
    done("engine phase")
    torch.cuda.empty_cache()
    chunked = chunked_phase(torch, params)
    done("chunked phase")
    torch.cuda.empty_cache()
    int8 = int8_engine_phase(torch, params, chunked)
    done("int8 engine phase")
    torch.cuda.empty_cache()
    swa = swa_engine_phase(torch, params)
    done("swa engine phase")
    base = baseline_phase(torch, params)
    done("baseline phase")
    torch.cuda.empty_cache()
    fork = fork_phase(torch, params)
    done("fork phase")
    del params
    torch.cuda.empty_cache()
    faults = faults_phase(torch)
    done("faults phase")
    page_state = page_state_phase(torch)
    done("page state phase")
    torch.cuda.empty_cache()
    f32 = f32_engine_phase(torch)
    done("f32 engine phase")
    nemo = nemotron_engine_phase(torch)
    done("nemotron-4-15b phase")
    nemo_f32 = nemotron_f32_check(torch)
    done("nemotron-4-15b f32 check")
    nemo_340b = nemotron_340b_phase(torch)
    done("nemotron-4-340b phase")
    rg = rglru_engine_phase(torch)
    done("recurrentgemma-9b phase")
    rg_f32 = rglru_f32_check(torch)
    done("recurrentgemma-9b f32 check")
    moe_runs = {}
    for name in ("granite-moe-1b-a400m", "olmoe-1b-7b"):
        moe_runs[name] = moe_engine_phase(torch, name)
        done(f"{name} phase")
        moe_runs[name]["f32"] = moe_f32_check(torch, name)
        done(f"{name} f32 check")
    vlm = vlm_engine_phase(torch)
    done("llama-3.2-vision-11b phase")
    vlm_f32 = vlm_f32_check(torch)
    done("llama-3.2-vision-11b f32 check")
    whisper = whisper_engine_phase(torch)
    done("whisper-medium phase")
    whisper_f32 = whisper_f32_check(torch)
    done("whisper-medium f32 check")
    xlstm = xlstm_engine_phase(torch)
    done("xlstm-350m phase")
    xlstm_f32 = xlstm_f32_check(torch)
    done("xlstm-350m f32 check")
    train = train_phase(torch)
    done("training phase")
    torch.cuda.empty_cache()
    dist = dist_phase(torch, chk)
    done("distributed and launch phases")
    dry = dry_phase(torch, dist["dry_ranks"])
    done("dry phase")

    src = "src/repro_torch/csrc/"
    k3 = ("paged_prefill.cu", "src/repro/kernels/paged_attention/"
          "paged_attention.py:440", "paged_prefill")
    k4 = ("flex_prefill.cu", "src/repro/kernels/flex_attention/"
          "flex_attention.py:38", "flex_prefill")
    d256 = {  # the D-256 instances, launched by the recurrentgemma phases
        name + "/d256": v for name, v in (
            ("paged_decode", ("paged_decode.cu", "src/repro/kernels/"
                              "paged_attention/paged_attention.py:223",
                              "paged_decode", "bfloat16")),
            ("combine", ("combine.cu", "src/repro/kernels/paged_attention/"
                         "paged_attention.py:161", "combine/decode",
                         "bfloat16")),
            ("paged_prefill_tc", k3[:2] + ("paged_prefill/tc", "bfloat16")),
            ("paged_prefill_tf32x3", k3[:2] + ("paged_prefill/tf32x3",
                                               "float32")),
            ("paged_prefill_tc/int8", k3[:2] + ("paged_prefill/tc/int8",
                                                "int8")),
            ("paged_prefill_tf32x3/int8", k3[:2] + (
                "paged_prefill/tf32x3/int8", "int8")),
            ("flex_prefill_tc", k4[:2] + ("flex_prefill/tc", "bfloat16")),
            ("flex_prefill_tf32x3", k4[:2] + ("flex_prefill/tf32x3",
                                              "float32")))}
    meta = {  # line name: (source, TPU kernel, launch-count key, dtype)
        "paged_decode": ("paged_decode.cu", "src/repro/kernels/"
                         "paged_attention/paged_attention.py:223",
                         "paged_decode", "bfloat16"),
        # K2 at the decode layout, and on K3's partials
        "combine": ("combine.cu", "src/repro/kernels/paged_attention/"
                    "paged_attention.py:161", "combine/decode", "bfloat16"),
        "combine/prefill": ("combine.cu", "src/repro/kernels/"
                            "paged_attention/paged_attention.py:161",
                            "combine/prefill", "bfloat16"),
        "paged_prefill_tc": k3[:2] + ("paged_prefill/tc", "bfloat16"),
        "paged_prefill_tf32x3": k3[:2] + ("paged_prefill/tf32x3", "float32"),
        "paged_prefill_tc/int8": k3[:2] + ("paged_prefill/tc/int8", "int8"),
        "paged_prefill_tf32x3/int8": k3[:2] + ("paged_prefill/tf32x3/int8",
                                               "int8"),
        "flex_prefill_tc": k4[:2] + ("flex_prefill/tc", "bfloat16"),
        "flex_prefill_tf32x3": k4[:2] + ("flex_prefill/tf32x3", "float32"),
    }
    modes = ("monolithic", "chunked 512")
    phases = ([model["int8_chunked_launches"], engine["launches"],
               chunked["launches"], int8["launches"],
               int8["logits"]["launches"]]
              + [swa[mode]["launches"] for mode in modes]
              + [f32[mode]["launches"] for mode in modes]
              + [f32["swa"]["launches"]]
              + [nemo["monolithic"]["launches"], nemo["chunked"]["launches"]]
              + [nemo_f32[mode]["launches"] for mode in modes]
              + [nemo_340b[k]["launches"] for k in (
                  "logits monolithic", "logits chunked 512",
                  "engine monolithic", "engine chunked 512")]
              + [base[k]["launches"] for k in ("paged", "contiguous")]
              + [fork["launches"], faults["checks_launches"],
                 faults["launches"]]
              + [r[k]["launches"] for r in moe_runs.values()
                 for k in ("monolithic", "chunked", "logits")]
              + [r["f32"][mode]["launches"] for r in moe_runs.values()
                 for mode in modes]
              + [vlm[k]["launches"] for k in ("monolithic", "chunked",
                                               "logits", "logits_f32")]
              + [vlm["fork"]["launches"]]
              + [vlm_f32[mode]["launches"] for mode in modes]
              + [vlm_f32["chunked_engine"]["launches"]]
              + [whisper[k]["launches"] for k in ("monolithic", "chunked",
                                                   "fork", "logits")]
              + [whisper_f32[k]["launches"] for k in ("monolithic",
                                                       "chunked 128")]
              + list(whisper_f32["engine_launches"].values())
              + [xlstm["monolithic"]["launches"]]
              + train["eval"]["launches"]
              # the ranks' main paths (counted in the rank processes),
              # and the launch phase's (its ranks and launch.serve)
              + [collections.Counter(dist["launches"]),
                 collections.Counter(dist["launch"]["launches"])])
    # and the launch phase's recurrentgemma-9b cases (its ranks)
    rg_phases = [rg["launches"], rg["logits"]["launches"],
                 rg_f32["launches"],
                 collections.Counter(dist["launch"]["launches_d256"])]
    kernels_line = []
    for name, (fname, replaces, count, dtype) in {**meta, **d256}.items():
        r = rows[(name, dtype)]
        kernels_line.append(dict(
            name=name, route="cuda", source=src + fname, replaces=replaces,
            launches=sum(c[count] for c in (
                rg_phases if name in d256 else phases)),
            max_abs_err=chk.max_err[name], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    k2 = dist["k2"]  # K2 merging every rank's partials (kvp)
    kernels_line.append(dict(
        name="combine/dist", route="cuda", source=src + "combine.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:161",
        # the dist phase's kvp cases and the launch phase's ws kvp tail
        launches=(dist["launches"]["combine/dist"]
                  + dist["launch"]["launches"]["combine/dist"]),
        max_abs_err=chk.max_err["combine/dist"], ms=k2["ms"],
        plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
        bound_by=k2["bound_by"], library_ms=k2["library_ms"]))
    (OUT / "chip_smoke.log").write_text("\n".join(LOG))
    (OUT / "chip_smoke_last.json").write_text(json.dumps(
        {"nvidia_smi": smi, "kernels": kernels_line,
         "times": {f"{k}/{d}": v for (k, d), v in rows.items()},
         "max_abs_err": chk.max_err, "model": model, "engine": engine,
         "chunked": chunked, "int8_engine": int8, "swa_engine": swa,
         "f32_engine": f32,
         "nemotron_4_15b": nemo, "nemotron_4_15b_f32": nemo_f32,
         "nemotron_4_340b": nemo_340b, "recurrentgemma_9b": rg,
         "baseline": base, "fork": fork, "faults": faults,
         "page_state": page_state,
         "recurrentgemma_9b_f32": rg_f32, "moe": moe_runs,
         "llama_3_2_vision_11b": vlm, "llama_3_2_vision_11b_f32": vlm_f32,
         "whisper_medium": whisper, "whisper_medium_f32": whisper_f32,
         "xlstm_350m": xlstm, "xlstm_350m_f32": xlstm_f32,
         "train": train, "dist": dist, "dry": dry},
        indent=1, default=str))
    log(nvidia_smi())
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
