#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --dist-fault   # phase 28 (b)'s gates against a
                                         # planted TP fault (alone)
    python3 chip_smoke.py --pipe-fault   # phase 29 (a)'s and (b)'s gates
                                         # against planted pipeline faults,
                                         # one a run
    python3 chip_smoke.py --sep-fault    # phase 30's f32 gates against
                                         # planted sequence / expert
                                         # parallelism faults, one a run
    python3 chip_smoke.py --disagg-fault # phase 31 (a)'s token gate
                                         # against a migration that skips
                                         # a page

Every phase is fatal (any failure exits non-zero and prints no result):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every csrc/*.cu compiled by nvcc for sm_90a into build/, one
   nvcc process per source, all in parallel; each library's probe kernel
   runs when it is loaded;
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it plus a few more, within a
   stated tolerance, timed with CUDA events (raw launches; the flash
   forward's wrapper, with its host work, beside as wrapper_ms) beside
   the plain version, one library call where PyTorch has one, and the
   bound (the least time the card could take: bytes over 3.35 TB/s or
   operations over the dtype's peak, whichever is larger; the tf32x3
   route's operations counted three times at the 495 TFLOP/s TF32 peak,
   the work f32-grade products take on the tensor cores), failing a time
   below its bound;
   the f32 forward at the main shape also through views whose rows are
   not 16-byte aligned, the one case left to the CUDA-core kernel; paged
   decode at the serving geometries (LLaMA: 16 slots, 32 heads, d 128,
   f32, bf16 and int8 pools, GQA, a window; ERNIE-MoE: 8 slots, 16
   heads, d 64, f32 pool; phase 20's replay engine: 8 slots, 32 heads,
   d 128, 16-token pages, f32 pool, split and single-chunk), the raw launch and the wrapper each held to
   the plain version (and to each other, bit for bit), its chunking as
   the C entry reports it, timed from a CUDA graph of raw launches (the
   split kernel and the combine) that cycles through copies of the pools
   larger together than the L2, beside the wrapper, and a negative
   control: the combine without one slot's last chunk must be rejected;
3b. the fused Adam / AdamW update (csrc/fused_adam.cu, port-only: the
   fusion XLA makes of the JAX TrainStep's update) against the plain
   per-tensor rule: three updates from a fresh state, every parameter and
   state slot bit-equal (torch.equal), at the LLaMA, ERNIE-MoE and BERT
   training parameter sets at full size (bf16 moments, AdamW 0.01) and on
   odd sizes (vector tails, one element, several chunks) with f32 and bf16
   moments, decay on and off, Adam's L2, amsgrad and parameters off
   16-byte alignment; negative control: a chunk table without its middle
   full chunk at the LLaMA set must be rejected; the training sets timed on a
   cold L2 beside their bound (20 bytes a parameter), the plain rule and
   the timed-only torch._fused_adamw_ (another function);
4. + 5. the main path, with every launch count set to 0 just before it
   and read just after: the no-cache LlamaForCausalLM forward at the
   full width of the repo's serving benchmark (vocab 32000, hidden 4096,
   ff 11008, 32 heads, 4 layers, f32 weights drawn from a seed), batch
   2 x seq 1024 — then an Engine serving 24 requests (prompts 64-191
   tokens, 128 new tokens each, mostly greedy, a few sampled) with 16
   slots, 128-token pages, a 64-token prefill bucket and a bf16 pool;
6. checks: finite logits of the right shape, 4 flash launches in the
   forward, all on the tf32x3 route, every request finished,
   paged-decode launches == decode ticks x 4 layers, no leaked pages, and
   every decode call on the split kernel (``kernels.decode.paged_cuda_split``,
   by what the C entry reports), a cross-check of two greedy
   requests against teacher-forced argmax of the no-cache forward
   (bf16 pool and an f32 pool);
6b. the serving accelerators, at the serving shapes (16 slots, 128-token
   pages, 64-token bucket, bf16 pool), each run on
   ``bench.py::bench_llama_serving``'s arrival trace with its counts set
   to 0 just before the engine is built and read just after the trace
   drains: every request finished, 0 pages leaked, paged-decode launches
   == device ticks x layers (under speculation: ticks x (k+1) draft steps
   x the draft's layer), every decode call on the split kernel; printed
   tokens/s and the engine's host and device-wait ms a step and a tick.
   (a) multi-tick: the 24-request trace, all greedy, ``multi_tick=8``
   against 1, each engine counted on its second pass (the first, like
   the JAX bench's compile pass, captures the graphs): tokens identical
   for every request, fused dispatches on
   captured CUDA graphs, and ``torch.profiler`` around one step whose
   dispatch replays the k=8 graph over 16 equal requests must show 8 x 4
   ``paged_decode_split`` kernels and as many combines; (b) prefix: the
   ``serving_prefix`` trace (a 256-token shared system prompt, prompts
   320-447) with the prefix cache on and off; (c) chunked: the
   ``serving_longctx`` trace (16 requests at 20 Hz, every 4th a
   1536-token whale, 96 new tokens) with 256 prefill tokens a step and
   monolithic, the small requests' p99 TTFT printed; (d) speculative:
   ``serving_spec`` (a 1-layer draft from seed 1, k = 4) on the 24-request
   trace, its accept rate printed. In (b)-(d) every request's tokens hold
   teacher-forced agreement >= AGREE_BF16 and the share identical to the
   plain engine's is printed. The ERNIE-MoE case of (d) runs as phase 12b;
6c. the reliability plane at the same width and ``multi_tick=8`` on the
   same 24-request trace, each part counted like 6b (paged-decode
   launches == device ticks x 4 on the split kernel, 0 pages leaked, the
   invariant audit clean, no CUDA graph beyond the k buckets of 6b's
   clean multi_tick=8 run): (a) chaos, bench.py's ``serving_chaos``
   (``FaultInjector(seed=0, rate=0.02)`` over every site, plus a plan
   forcing one decode.nan and one alloc.exhausted, one engine driving the
   trace twice): every request finishes or fails as
   ``nan_logits`` / ``error:prefill``, nan_logits failures ==
   ``serving.nan_quarantines`` == decode.nan + prefill.nan faults, a
   decode.nan and an alloc.exhausted landed, survivors' teacher-forced
   agreement >= AGREE_BF16; survivors' tokens/s, faults by site, repairs
   and step errors printed; (b) ``snapshot_to`` after step 40 (every 6th
   request sampled at temperature 0.8, seeded), ``restore_from`` on a
   fresh engine: every request finishes, waiting ones identical to the
   uninterrupted run, resumed ones (teacher-forced; sampled ones through
   the sampler with their noise replayed) >= AGREE_BF16; (c) deadlines
   of 20 k=1 ticks on a third of the requests and one cancel mid-decode,
   on the second pass of one engine (the first captures the graphs):
   the deadline clamp fires, every expiry within one step of its
   deadline, the cancel's pages back at once, every other request's
   tokens the clean run's (a prefix when a deadline cut them); overlap
   ms a tick printed beside host and device;
6d. one-shot decoding (``text.generate`` / ``beam_search``) at the same
   model, 16 prompts of 128 tokens and 128 new tokens (caches sized for
   256), each run counted on its own (counts to 0 just before, read just
   after; no plain version may run) and printed with tokens/s and the
   median ms of a decode step (the card's events and the host's clock)
   beside 6b's Engine ticks at k=1 and k=8: (a) paged f32 and bf16 pools,
   paged-decode launches == 127 x 4, all on the split kernel,
   teacher-forced agreement >= AGREE_F32 / AGREE_BF16; (b) dense f32,
   bf16, int8 (int8 at AGREE_BF16), the share identical to (a) printed;
   (c) the model at a 64-token window, where "auto" rolls and the
   128-token prefill is longer than the window: rolling bf16 and int8
   tokens equal to the dense layout's, agreement against the windowed
   no-cache forward; (d) use_cache=False, 32 new tokens: flash forward
   launches == 32 x 4, all tf32x3; (e) ERNIE-MoE (phase 12's model), 8
   prompts, 96 new tokens, paged f32: grouped-FFN forward launches ==
   (1 + 95) x 2, the steps' on "rows", the prefill's on simt, paged
   decode == 95 x 4, paged teacher-forced agreement >= MOE_AGREE; (f)
   beam search (2 prompts, 4 beams, 32 new tokens, eos, length penalty
   0.8, dense f32): each best beam's normalised score within 1e-3 of its
   teacher-forced recomputation, num_beams=1 equal to greedy; (g)
   sampling (T 0.8, top-k 50, top-p 0.9, seed 0) twice: identical, every
   token in its teacher-forced keep set; (h) synchronizations under
   ``torch.cuda.set_sync_debug_mode("warn")`` of the paged and dense
   bf16 runs at 32 and 128 new tokens: equal at both lengths (a control
   counts 3 known reads); (i) the incubate ``paged_attention`` op at
   phase 3's LLaMA geometry (bf16, int8 pools): bit-equal to
   ``paged_decode``, within the gate of ``paged_attention_arrays``;

7. training kernels: the flash forward with logsumexp and the two
   backward kernels (dQ, dK/dV) against their plain versions at the
   attention shape of one layer of the training benchmark under bf16 AMP
   (B 12, S 1024, H 32, D 128, causal) plus f32, GQA (8 kv heads),
   window 256, sq 333 / sk 1024, a 4-document flashmask, the
   ERNIE-MoE training shape (B 32, S 512, H 16, D 64, causal) and bf16 at
   head dim 256 (B 2, S 1024, H 8, causal), timed
   beside the plain versions, their bounds and, where aten takes the
   case, the timed-only aten flash forward and backward (SDPA f32 beside
   the f32 forward, the backward of aten's memory-efficient attention
   beside the f32 pass); each case records its route (bf16: the
   tensor-core forward, dQ and dK/dV; f32: the tf32x3 forward, the
   CUDA-core dQ and dK/dV) and the kernel each C entry reported it ran:
   every 16-bit forward and every bf16 dQ and dK/dV launches its wgmma
   kernel at head dim <= 128 and its mma.sync kernel at 256, and each
   wgmma kernel's SASS (the forward
   at bf16 and fp16, dQ and dK/dV at bf16, tile head dims 64 and 128)
   holds HGMMA and UTMALDG; at the LLaMA case the wrapper's Delta =
   rowsum(dO O) is timed as a share of its pass; negative controls: out
   without one 32-key tile, dV without one q tile and dQ without one key
   tile must be rejected;
8. model cross-check: a 2-layer, hidden-512 LLaMA (8 heads, 2 kv heads,
   window 64, seq 256, f32) — one TrainStep loss and every parameter
   gradient on the card against the same weights on the CPU, then again
   with a document mask;
8b. GradScaler: the same model without the window, 4 eager steps under
   ``amp.GradScaler`` (scale 2^16) with Momentum on the card and on the
   CPU from the same weights, one gradient element set to inf by hand at
   step 2: that step skipped and the scale halved on both, and every
   parameter on the card within the f32 gate of the CPU's;
9. + 10. the training main path, counts set to 0 just before it and read
   just after: ``bench.py::bench_llama_1b``'s configuration (LLaMA-7B
   widths at 4 layers, ~1.07 B parameters, batch 12 x seq 1024, fused
   4-chunk LM loss, random f32 weights from a seed) under
   TrainStep(amp_dtype="bfloat16") with AdamW(3e-4, bf16 moments) for 6
   steps on one fixed batch: finite, falling losses; flash forward, dQ
   and dK/dV launches == 4 layers x 6 steps each, the *_cuda counters
   equal to them and no *_plain call, every forward, dQ and dK/dV launch
   on the tensor-core route (``kernels.flash.*_cuda_tc``), each on its
   wgmma kernel (``kernels.flash.{fwd,dq,dkv}_cuda_tc_wgmma``) and none
   on another; one fused update launch a step
   (``kernels.optimizer.adam_fused`` == 6, ``adam_plain`` == 0);
   ms per step, tokens/s, the share of the bf16 peak and the peak device
   memory; then one step's real gradients applied through the fused and
   the plain route to two copies of the parameters and the optimizer
   state, bit-equal, and the update's ms on both routes
   (``profile_training.update_ms``);
9b. the LLaMA pretraining recipe at the same shape: AdamW on
   LinearWarmup(CosineAnnealingDecay(3e-4, 100), 2 steps from 0),
   ``apply_decay_param_fun`` naming the norms out (read by no train
   step, as in the JAX package), 4 steps under recompute "none", "full",
   "selective" and "selective_qkv", each counted on its own: finite,
   falling losses, the lr of every step the scheduler's, flash forward
   launches == 2 x layers x steps under recompute (the rerun) and layers
   x steps without, dQ and dK/dV == layers x steps, all on their wgmma
   kernels, one fused update a step, the q / k / v tags of
   "selective_qkv" run once a layer and step (saved) and no other tag
   run ("selective" keeps attn_core and ffn_mid as the ends of its
   checkpointed regions); one step with a 3-document mask under
   "selective"; peak memory ordered full < selective <= selective_qkv <
   none; a tag's copy timed.

11. MoE kernels: the grouped-FFN forward, dx and dw kernels against their
   plain versions at the MoE training shape (8 experts, capacity 8192,
   hidden 1024, expert FFN 2816, bf16, GELU, counts from a real top-2
   routing of the bench's 16,384 tokens), a decode tick (capacity 8, f32,
   one expert empty), a prefill chunk (capacity 128), a ragged f32 ReLU
   case (hidden 96, FFN 200, capacity 37, counts 0 / full / odd) and a
   bf16 case whose widths the tensor-core route refuses (hidden 1020,
   FFN 2812), held stage by stage (rounded intermediates, then each
   output on the kernel's own intermediates) and end to end (within
   MOE_E2E_RATIO of the allowance); the forward, dx and dw launch on the
   route ``grouped_ffn_route`` names (the training shape on "tc", wgmma
   and TMA; the decode tick's forward on "rows", the weight-streaming
   passes; the other f32 and refused cases on "simt"), read from the
   ``kernels.moe.grouped_ffn_{fwd,dx,dw}_cuda_{tc,rows,simt}`` counters, and
   the tc kernels' SASS holds HGMMA and UTMALDG; negative
   controls at the training shape (dw1 short of one expert's last 64-row
   tile, out short of the down product's last 64-deep K tile, dx short
   of the last 64-deep K tile of dff) and at the decode tick (the rows
   route's out without its last K split) must each be rejected by both
   gates; each timed beside its plain version (an f32 forward from a
   CUDA graph of raw launches, the wrapper beside), its bound over the live
   rows (a time below it fails), its TFLOP/s and the timed-only pair of
   torch.bmm calls;
12. the MoE serving main path, counts set to 0 just before and read just
   after: ``bench.py::bench_ernie_moe_serving``'s configuration
   (``profile_moe``: 4 layers, 2 MoE, 8 experts, f32 weights from a seed)
   in an Engine with 8 slots, 128-token pages and a 64-token bucket, 16
   greedy requests of 64-191 prompt tokens and 96 new tokens: every
   request finished, no page leaked, grouped-FFN forward launches ==
   (prefills + decode ticks) x 2 MoE layers, paged-decode launches ==
   ticks x 4 layers, every decode call on the split kernel, only the
   kernel dispatch, every decode tick's grouped-FFN forward on the rows
   route and every prefill's on simt (capacity 128), by the route the C
   entry reports, and two requests' tokens equal to a 1-slot
   engine's (>= 0.97);
12b. ``bench.py::bench_ernie_moe_serving(draft_layers=1, spec_k=4)``: a
   1-layer dense LLaMA drafting for the ERNIE-MoE verifier, and the
   draft-free engine, on its 16-request trace, counted as in 6b, with
   grouped-FFN forward launches == (prefills + ticks) x MoE layers and
   every request's tokens held to one paged teacher-forced forward;
13. MoE cross-check: a 2-layer ERNIE-MoE (hidden 256, 4 experts, seq 128,
   f32, TF32 off) — one TrainStep loss and every parameter gradient on
   the card within 1e-4 of the CPU's, once the router's top-3 margins of
   the inputs are above 1e-5;
14. the MoE training main path, counts set to 0 just before and read just
   after: ``bench.py::bench_ernie_moe``'s configuration (8 layers, 4 MoE,
   batch 32 x seq 512, CE + aux loss, bf16 AMP, AdamW(1e-4, bf16
   moments)) for 6 steps: finite, falling losses; grouped-FFN forward, dx
   and dw launches == 4 MoE layers x 6 steps, flash forward / dQ / dK/dV
   == 8 layers x 6 steps, no plain call, the flash forward, dQ and dK/dV
   and the grouped-FFN forward, dx and dw on the tc route only (every
   flash forward, dQ and dK/dV on its wgmma kernel), one fused update a
   step; ms per step, tokens/s, the bf16 peak share of
   ``ernie_moe_flops_per_token`` and the peak memory.

15. encoder kernels: the head-dim-64 probe of csrc/flash_fwd.cu (row 5:
   (x x^T) x on a seeded [128, 64] f32 tile of small integers through the
   tf32x3 route's tiles, equal to its plain version bit for bit, timed
   beside it and the timed-only
   torch.matmul pair), the flash forward at the encoder's serving shape
   (B 16, 12 heads, head dim 64, f32, non-causal, C=1 key bands of a
   padding mask with 4 dead rows that must give zeros and ragged live
   lengths, L 128 and 96) beside the timed-only SDPA call, and the
   forward with logsumexp, dQ and dK/dV at the BERT training shape (B
   256, S 128, 12 heads, head dim 64, bf16, no mask);
16. the encoder serving main path, counts set to 0 just before the
   service is built and read just after: ``bench.py::bench_bert_embedding``'s
   configuration (``profile_encoder.BERT_EMBED``: BERT-base, f32 weights
   from a seed) in a BatchEncoder (max_batch 16, bucket 32) replaying the
   64-request trace twice (warm, then timed): every request done, flash
   forward launches == batches x 12 layers on the masked kernel route
   only, all on the tf32x3 route, one head-dim-64 probe launch, no kernel
   build in steady state;
   4 requests' embeddings within 1e-4 relative of the same request
   encoded alone;
17. BERT cross-check: a 2-layer BertForPretraining at BERT-base widths
   (seq 128, f32, TF32 off, dropout 0, a padding mask) — one TrainStep
   loss and every parameter gradient on the card within 1e-4 of the
   CPU's;
18. the BERT training main path, counts set to 0 just before and read
   just after: ``bench.py::bench_bert``'s configuration
   (``profile_encoder.BERT_TRAIN``: batch 256 x seq 128, dense MLM CE,
   bf16 AMP, AdamW(1e-4, bf16 moments), dropout 0.1) for 6 steps:
   finite, falling losses; flash forward, dQ and dK/dV launches == 12
   layers x 6 steps, no plain call, forward, dQ and dK/dV on the tc route
   only, each on its wgmma kernel, one fused update a step; ms per step,
   tokens/s, the
   bf16 peak share by bench_bert's 6N rule and the peak memory;
19. the eager dygraph surface (``import paddle_tpu_torch as paddle``):
   first a 2-layer f32 copy of the model below, dropout 0, on the card
   (tf32x3 forward, simt backward) against the same weights on the CPU
   (the plain versions): the loss and every parameter gradient within
   ``closeness``'s f32 gate, and one AdamW(1e-3) step on the card (the
   fused update) against the plain rule on the CPU from the card's
   weights and gradients, every Parameter read back through the model,
   within the same gate; then the main path (``profile_eager``'s model,
   batch and optimizer), counts set to 0 just before and read just
   after: Embedding(30522, 768) ->
   TransformerEncoder(12 x TransformerEncoderLayer(768, 12, 3072,
   dropout 0.1, gelu)) with a bool key-padding mask [32, 1, 1, 128]
   (lengths 64-128) -> Linear(768, 2) on the first token ->
   cross_entropy, under amp.auto_cast O1 bf16, AdamW(2e-5, weight decay
   0.01; BERT fine-tuning's rate: at 1e-4 Adam's first, sign-sized step
   overshoots a fresh 12-layer model), 6 steps of one fixed batch
   [32, 128]: finite losses, the last below the first, and the batch's
   eval-mode loss (dropout off) lower after the 6 steps than before;
   linear outputs bf16, layer_norm outputs and the loss f32; the tc
   wgmma forward, dQ and dK/dV == 12 x 6 each, sdpa on the key-mask
   kernel route == 12 x 6 and never a plain route, one fused Adam a step
   and no plain one; ms per step (events and host medians), tokens/s,
   peak memory, the host's share of a step and the ops dispatched a step,
   the forward + backward's host enqueue time against its events, and
   (one more, uncounted step) the host syncs a step makes;
20. the serving replay tool, ``python -m paddle_tpu_torch.serving_replay``,
   each run a subprocess whose exit must be 0 and whose report gives its
   wrappers' launch counts (from 0 in the fresh process): (a) a
   24-request trace written to chiprun_out/chip_smoke/ (prompts 64-127,
   128 new tokens) at the widest LLaMA its flags express (``--hidden
   4096 --heads 32 --layers 4 --vocab 32000``, f32), 8 slots, plain and
   ``--multi-tick 8``, both under ``--expect-pallas``: every request
   finished, 0 leaked pages, every decode call on the split paged-decode
   kernel, the same tokens both ways; (b) ``--chaos`` with
   ``--trace-out`` and ``--expect-complete-timelines`` at (a)'s model on
   a 24-request chaos trace the phase writes (shared system prompts,
   contexts to 255; under ``--expect-pallas``, faults injected, survivors
   exact, no leak) and on the chaos fixture (single-chunk kernel; a gate
   only); (c) ``--embedding`` at BERT-base widths on a 256-request trace
   of 128-512 tokens the phase writes (batches of 32) and on the
   embedding fixture (a gate only), the tf32x3 forward and no plain call;
   (d) two Engines over one copy of (a)'s model: after MIGRATE_AT steps 2
   greedy and 2 sampled live requests leave the first
   (``extract_request``) and join the second's queue (``readmit``), and
   every stream equals an uninterrupted run's bit for bit; tokens/s,
   device and host ms a tick and the launches of each run (rates of the
   phase's own traces only);
21. the eager surface's new modules on the card (``set_device("gpu")``):
   (a) ResNet-50's stem and stage 1 from the new layers (Conv2D 7x7/2 64,
   BatchNorm2D, ReLU, MaxPool2D 3x3/2, three 64-64-256 bottlenecks,
   AdaptiveAvgPool2D, Linear to 1000), batch 32 x 3 x 224 x 224, O1 bf16,
   AdamW, 6 steps, finite losses; (b) PTB "large" language models
   (Zaremba et al.: 2 layers of 1500, vocab 10,000, 35 steps, batch 20,
   dropout 0.65, SGD 1.0 clipped at 10), LSTM then GRU, 6 f32 steps each;
   each of (a) and (b) first as an f32 copy (batch 2, dropout 0) on the
   card against the same weights on the CPU, the loss and every gradient
   within ``closeness``'s f32 gate; (c) cholesky, qr, svd, eigh, solve,
   lstsq, inv and det on 64 x 256 x 256 f32 batches: residuals and
   reconstructions over the input's norm, and values against the CPU's,
   below LAPACK's test ratio (30 x n x eps); (d) interpolate in every
   mode down and up, grid_sample and fold against the CPU within the
   f32 gate; ms a step (events and host), images or tokens a second and
   peak memory, beside the card;
22. the high-level paths: (a) ``paddle.Model`` over phase 19's Embedding
   and 12-layer TransformerEncoder with a head on the first token: first
   a 2-layer f32 copy, dropout 0, its ``Model.train_batch`` loss and
   every gradient of its TrainStep on the card against the same weights
   on the CPU (``_xcheck``, closeness's f32 gate); then the main path,
   counts set to 0 just before and read just after: 256 sequences of 128
   tokens from a seed (the first token one of two markers, the label
   which), a DataLoader over a seeded RandomSampler in batches of 32 with
   two worker processes, ``prepare(AdamW(cosine from 2e-5),
   CrossEntropyLoss(), Accuracy(), amp_configs O1)`` (which must build a
   TrainStep: bf16), ``fit`` for 2 epochs with 64 eval sequences each
   epoch and ModelCheckpoint, LRScheduler and EarlyStopping, then
   ``evaluate``, ``predict(stack_outputs=True)``, ``save`` and a fresh
   Model's ``load`` + ``evaluate`` (equal to the first): finite losses,
   the wgmma forward, dQ and dK/dV == 12 x steps each, the f32
   evaluations' forwards on tf32x3 == 12 x eval batches, one fused Adam a
   step, no plain version; ms a step (events, host), samples/s, the
   share of a step cycle the device waits on the host, the cost of the
   per-step float(loss) read (steps through train_batch against the
   train step with one read, in turns) and peak memory; (b) ``jit.save``
   of ``bench_bert_embedding``'s f32 BertModel at [32, 128] int64
   (``torch.export``; the flash forward as the custom op
   ``paddle_tpu_torch::flash_fwd``), ``create_predictor(Config(...))``,
   handles and ``run``, counted around one run: both outputs within
   closeness's f32 gate of the eager forward on the card, 12 tf32x3
   launches inside the exported program, the ``.pdiparams`` equal to the
   model's state dict; negative control: a copy of the artifact with one
   element of the first layer's qkv weight moved by 1 must fail the
   gate; ms a run (events) and sequences/s;
23. weight-only quantized serving: (a) phase 4's LLaMA (LLaMA-7B widths,
   4 layers) with bf16 weights from seed 0, then the same converted by
   ``quantize_for_inference`` to int8 and to int4 (group-16 scales),
   each serving phase 20's 24-request decoder trace (prompts 64-127, 128
   new tokens, one every 10 ms) through an Engine of 8 slots, 16-token
   pages and a bf16 pool: a warm pass, then 3 timed passes counted
   together (every request finished, 0 leaked pages, paged-decode
   launches == device ticks x 4 on the split kernel, no plain call);
   int8 again at ``multi_tick=8`` (no CUDA graph captured after the warm
   pass); 29 WeightOnlyLinears and no float linear left, the linears'
   bytes at most 0.51x bf16's (int8; int4's int8 container with its
   group scales 0.5625x); tokens/s (median and spread), parameter and
   buffer bytes, peak allocated, the share of greedy tokens equal to the
   bf16 model's and the device ms of a decode tick's 29 linears (each
   timed on an [8, in] bf16 input); the closeness gate: [8, 128]
   teacher-forced logits
   of the int8 model against the same model holding weight_dequantize(q,
   s) in bf16 and in f32, both of the int8 model's distances within 2x
   the bf16 dequantized model's own distance from the f32 one; (b)
   ``generate`` on the int8 model, 8 x 128 prompts, 64 new tokens, over
   paged bf16 and int8 KV caches: finite logits, paged-decode launches
   == 63 x 4, ms a step; (c) ``llm_int8_linear`` at [T, 4096] x [4096,
   11008], T 1, 8, 128, 2048: at threshold 0 bit-equal to the CPU route
   (``torch._int_mm`` against an int32 matmul), with an outlier column
   (T <= 128) within the f32 gate, ms beside bf16 ``torch.matmul`` and
   ``weight_only_linear``; (d) the fused ops on the card against the CPU
   at BERT-base widths in f32 (``fused_multi_head_attention``,
   ``fused_feedforward``, ``fused_bias_dropout_residual_layer_norm``,
   ``FusedTransformerEncoderLayer`` forward and backward) within the f32
   gate, and ``fused_moe`` at ERNIE-MoE's serving widths in bf16 against
   the CPU's f32 within its bf16 gate; ms of each;
24. the profiler and debugging surface: (a) phase 19's loop (BERT-base
   width and depth, 32 x 128, O1 bf16, AdamW), 2 warm steps, then 6
   steps with the profiler closed, 6 under ``Profiler(timer_only=True)``
   and, counted (counts to 0 just before, read just after), 6 under
   ``Profiler(targets=[CPU, GPU], scheduler=make_scheduler(closed=1,
   ready=1, record=4, repeat=1), profile_memory=True, record_shapes=True,
   on_trace_ready=export_chrome_tracing(...))``, each step inside
   ``RecordEvent("train_step")``: the exported trace read back by
   ``load_profiler_result`` holds as many dispatch spans as
   ``dispatch.op_count`` rose over the 4 recorded steps and 4
   ``train_step`` spans; its device lane and the summary's device view
   list the wgmma forward, dQ and dK/dV at 12 x 4 launches each and
   ``fused_adam_kernel`` at 4, each equal to its wrapper's count over the
   window, no plain version run; 4 memory samples whose peaks equal
   ``torch.cuda.max_memory_allocated()`` read after each step; no shape
   churn; no build after the first step; the summary's tables and ms a
   step (events and host) closed, timer-only and recording printed; (b)
   one step under ``enable_tensor_checker(CHECK_NAN_INF_AND_ABORT)``
   passes, and (negative control) with an inf in the first layer's query
   weight the next must raise FloatingPointError naming an op;
   ``collect_operator_stats`` over one f32 step of phase 19's 2-layer
   copy gives the same (op, dtype) table on the card and the CPU; (c)
   ``paddle.device.cuda.memory_allocated()`` equals torch's, the
   properties' name nvidia-smi's, a matmul on a side ``Stream`` (under
   ``stream_guard``, ordered by ``Event``s and ``synchronize``) equals
   the default stream's bit for bit, ``to_dlpack`` / ``from_dlpack``
   share the tensor's memory, and ``cpp_extension.load`` (g++) +
   ``register_op`` run a C function forward and backward when the
   machine has g++;
25. paddle.vision (no port kernel on its paths, gated: every launch
   count stays 0): (a) ``resnet50()`` through one ``Model.train_batch``
   on the card and on the CPU with the card's weights (batch 2 x 224):
   in f32 the loss and every BatchNorm running statistic within
   closeness's f32 gate (the gradients' ratio printed: at random weights
   a rounding flips ReLU and max-pool kinks), in f64 also every
   gradient; (b) ResNet-50 in eval at batch 64 after the host pipeline
   Resize(256) -> CenterCrop(224) -> Normalize: ``Model.predict_batch``
   in f32 and O1 bf16 and the ``jit.save`` predictor, held to the eager
   f32 logits within the f32 gate, counted, ms and images/s of each,
   the share of bf16 top-1 equal to f32's, peak memory; (c) the main
   path, counted: PaddleClas's ResNet-50 recipe (Momentum 0.9 at 0.1,
   L2Decay 1e-4, cross-entropy, top-1 / top-5 accuracy, O1 bf16, 64
   images a step) through ``Model.fit`` over ``DatasetFolder`` of 512
   synthetic 256 x 256 images (``.npy``, 8 classes) with
   RandomResizedCrop, flip and Normalize in 8 DataLoader workers, one
   epoch: finite losses, every running statistic moved and finite, no
   build after the first step; ms a step (events, host), images/s, the
   share of a cycle the device waits on the loader, peak memory, and the
   same step on one fixed batch; (d) the detection ops at their
   detectors' sizes on the card against the CPU path (values and
   gradients within the f32 gate): roi_align / roi_pool on Faster R-CNN
   R50-C4's [2, 1024, 50, 84] map with 512 RoIs an image, nms on 6,000
   RPN proposals at IoU 0.7 (kept indices equal but for pairs within
   1e-6 of the threshold; ms and CUDA kernels a call),
   generate_proposals and multiclass_nms3 equal, psroi_pool at R-FCN's
   size, yolo_box / yolo_loss on YOLOv3's three heads at 608, and
   DCNv2's deform_conv2d in stage 5, ms of each; (e) the smallest
   factory of each of 13 families in f32 against the CPU.
26. fft, signal, audio, text.viterbi, geometric, sparse and distribution:
   (a) BERT-CRF tagging, the serving path that reaches the flash forward:
   the port's BertModel at BERT-base (12 layers) -> Linear(768, 9) ->
   ``text.ViterbiDecoder`` (MSRA-NER's 7 tags + start and stop), lengths
   32-128 from the seed; at batch 4 in f32 card vs CPU (emissions within
   the f32 gate, each card path re-scored under the CPU's emissions
   within the gate of the CPU's best score, the share of identical paths
   printed); served at batch 32 x 128 in f32 and from a bf16 copy of the
   encoder (emissions decoded in f32), counted: 12 flash forward launches
   a batch, all tf32x3 (f32) / tc (bf16); ms a batch (events, host)
   split into encoder and decode, the decode's device kernels,
   sequences/s, tokens/s, peak memory, the share of bf16 paths equal to
   f32's; (b) Whisper's front end: 16 x 30 s of seeded tones and noise
   through ``LogMelSpectrogram`` (16 kHz, n_fft 400, hop 160, 80 mels,
   top_db 80) -> [16, 80, 3001] and ``MFCC`` (40), ms and frames/s;
   ``istft(stft(x))`` with a Hann window within 1e-5 max|x| of x away
   from the edges; fft / rfft2 / irfftn / hfft / ihfft2 on [2, 3001,
   400], stft, the log-mel and the MFCC card vs CPU within the f32 gate;
   a WAV through ``audio.save`` / ``audio.load`` equal to 16-bit
   precision; (c) a 2-layer GCN at Cora's shape card vs CPU, loss and
   gradients within the f32 gate, through ``geometric.send_ue_recv`` and
   through ``sparse.matmul`` (the routes within the gate of each other);
   OGB's 3-layer GCN at ogbn-arxiv's shape (169,343 nodes, 1,166,243
   Zipf-sourced edges made symmetric, hidden 256, BatchNorm, dropout
   0.5, Adam 0.01) through ``Model.train_batch`` in f32, 2 warm and 10
   timed full-batch steps a route, counted (the fused Adam update the one
   port kernel): finite falling losses, no build after the first step,
   ms a step, edges/s, peak memory; GraphSAGE sampling [25, 10] for
   1,024 seeds (``sample_neighbors`` twice, ``reindex_graph``,
   ``incubate.graph_khop_sampler``), each pick an edge of its node, none
   twice, count = min(size, degree), host ms; (d) distributions at
   [4096, 256] (Categorical over 1,000, MultivariateNormal and
   LKJCholesky at d = 64): log_prob, entropy and the five registered KL
   pairs with their parameter gradients card vs CPU within the f32 gate
   (MultivariateNormal and LKJCholesky in f64 too), 65,536 draws of each
   class within 4 standard errors of the analytic mean and variance (the
   Cauchy's median), the five reparameterised rsamples' gradients
   finite; (e) SECOND's first ``SubmConv3D(4, 16, 3)`` on a 41 x 1600 x
   1408 grid with 16,000 voxels, densified as in the JAX package: ms,
   peak memory, nnz in and out; at a 41 x 200 x 176 crop the conv,
   ``sparse.nn.BatchNorm`` and ``MaxPool3D`` card vs CPU within the f32
   gate;
27. ``jit.to_static``, ``static`` and ``onnx`` (Inductor and Triton
   caching under build/; (b) and (c)'s graphs compiled into those
   caches beforehand by ``chip_smoke.py --static-warm``, a process at
   the lowest CPU priority started after the build, which phase 27
   waits for; the caches' hits and misses printed): (a) phase 19's model at 2 layers, f32, dropout
   0, batch 4 through ``to_static`` on the card against the same weights
   eagerly on the CPU, loss and every gradient within the f32 gate, the
   call compiled (a graph, no break, no eager pin or fallback warning,
   ``flash_fwd_lse`` in the compiled forward and ``flash_bwd`` in the
   backward); (b) the main path: phase 19's model at BERT-base widths
   and depth (O1 bf16, dropout 0.1, 32 x 128, key mask) with its forward
   and loss through ``to_static`` and the fused AdamW outside it, 2 warm
   steps that compile, then 6 counted: finite losses, the eval-mode loss
   lower after, 72 wgmma forward, dQ and dK/dV launches each from the
   compiled graphs, no surface op dispatched inside them, one fused Adam
   a step, no plain route, no graph break and no new graph; compile
   seconds, ms a step (events, host), tokens/s, peak, and eager and
   compiled steps in turns; (c) its encoder served in eval under
   ``no_grad`` through ``to_static`` at f32 and under O1 bf16, batch 32
   x 128: f32 within the f32 gate of the eager forward, bf16's RMS error
   against the f32 forward within 1.25x eager bf16's (its max within
   2x); 12 tf32x3 / 12 wgmma forward launches a batch; the counted and
   the timed compiled batches run the compiled graph (no surface op
   dispatched, no new graph, no break); ms a batch and sequences/s
   compiled and eager; (d) ``static.nn.cond`` and
   ``while_loop`` compiled on card tensors equal to eager, no break, and
   a negative control (``float(x.sum().numpy())`` must warn once, fall
   back with the right values and pin); (e) ``onnx.export`` of 12
   ``BertEncoderLayer``s at BERT-base widths from the card's weights,
   parsed back and run on the host by ``run_onnx`` at batch 2,
   within the f32 gate of the card's forward; negative control: one
   ``wq`` element moved by 1 must fail it;
28. collective training (``paddle_tpu_torch.distributed``): (a) one
   rank, ``init_parallel_env()`` picking NCCL: every collective on a
   [4096, 4096] bf16 tensor equal to it (a world of one), nothing
   staged; phase 9's configuration through ``fleet.init`` ->
   ``distributed_model`` -> ``distributed_optimizer`` ->
   ``DistributedTrainStep`` for 6 steps, the losses bit-equal to a plain
   ``TrainStep``'s from the same seed, 24 wgmma forward, dQ and dK/dV and
   6 fused Adam launches; (b) two ranks sharing the card under gloo,
   started by the port's launcher (``chip_smoke.py --dist-rank b``),
   mp=2: LLaMA-7B widths x 1 layer in f32 at 2 x 256, the loss, the
   gathered logits and every gathered gradient within closeness's f32
   gate of rank 0's own mp=1 model from the same seed, a send / recv,
   batched isend / irecv and broadcast of CUDA tensors, then phase 9's
   configuration for 6 bf16 steps, each loss within rtol 2^-7 of (a)'s
   (below 2^-7 of the first loss, within 2^-14 of the first loss), each
   rank launching 24 wgmma forward, dQ and dK/dV and 6 fused Adam, bytes
   staged; (c) two ranks, dp=2, ZeRO-1, at 2 layers, 12 x 1024 split 6
   a rank, 3 steps: losses within (b)'s gate of a one-rank
   run on the whole batch, each rank's optimizer state at most 0.55 of its;
   (d) the two ranks' o_proj shards swapped must fail (b)'s f32 gate.
   Per run: the backend, ms a step (events), the staged bytes and host
   ms of the collectives a step by op, peak GB, and the phase's seconds.
29. pipeline parallelism and ZeRO-3: two pp ranks sharing the card
   under gloo (``chip_smoke.py --dist-rank p``): (b) LLaMA-7B widths in
   f32 at 2 x 256, 2 microbatches, one ``train_batch`` (SGD at lr 0) and
   the forward in FThenB, 1F1B, ZBH1 (2 layers), VPP and ZBVPP
   (vpp_degree 2, 4 layers), a 1 + 3 layer split and the tied head (2
   layers): the loss, the logits and every gradient of each stage within
   closeness's f32 gate of a one-rank model from the same seed; (a)
   phase 9's configuration through ``fleet.init(pp_degree=2)`` ->
   ``build_llama_pipe`` -> ``distributed_model`` (``PipelineParallel``,
   1F1B, 4 microbatches of 3 x 1024, AMP bf16) ->
   ``distributed_optimizer`` -> ``train_batch`` for 6 steps: each loss
   within (b)'s ``_loss_gate`` of phase 28 (a)'s, each stage launching
   its 2 layers x 4 x 6 wgmma forward, dQ and dK/dV and 6 fused Adam,
   the bytes staged by send and by recv a step equal to 4 boundary
   activations (3 x 1024 x 4096 bf16) to the byte; (c) the MPMD modes
   ("MPMD", "MPMD-ZBH1") in this process, both stages on the card, at
   (b)'s first model: within the f32 gate of the one-rank model and of
   (b)'s FThenB loss (gradient norms within 1e-4), a graph with a
   dropped receive refused by ``MpmdDriver``; (d) the same two ranks
   re-cut as dp=2, ZeRO-3 at 2 layers, 2 steps: losses within the gate
   of phase 28 (c)'s one-rank run, each rank holding at most 0.505 of
   one rank's parameters (+ the unsliced, printed) and 0.500-0.505 of
   its optimizer state. (b) holds each gradient to closeness's f32 gate
   at its own scale (atol 1e-4 of its max |ref|), and (c) holds
   MPMD-ZBH1's dQ and dK/dV launches to MPMD's (no backward node runs
   twice). ``--pipe-fault`` plants three faults, each in its own run: a
   stage sending the previous microbatch's activation (exits 0 only when
   (a)'s and (b)'s gates both fail it), the tied weight's gradient not
   all-reduced between its stages, and each stage's first W event of
   ZBH1 / ZBVPP skipped (each only when (b)'s gradient gate fails it).
30. sequence, segment and expert parallelism: two ranks sharing the
   card under gloo (``chip_smoke.py --dist-rank s``): (a) sep=2,
   LLaMA-7B widths in f32 at 1 x 2048 (1,024 tokens a rank), 2 layers,
   and 1 layer with 8 kv heads and a 512-token window across the chunks:
   the loss, the gathered logits and every gradient (averaged over sep)
   within closeness's f32 gate of rank 0's own sep=1 model from the same
   seed (each gradient at its own scale, as phase 29 (b)); then
   ``MpmdRingExecutor`` at R=2 in rank 0 (both stages on the card)
   within the f32 gate of the two ranks' ``ring_attention_arrays``; (b)
   phase 9's configuration at 2 layers through
   ``fleet.init(sep_degree=2)`` -> ``SegmentParallel`` ->
   ``DistributedTrainStep`` (12 x 512 a rank, the ring attention, no
   flash launch), AMP bf16, 2 steps, each loss within phase 29's
   ``_loss_gate`` of phase 28 (c)'s one-rank run (2 layers), the k/v
   staged by the ring's sends; (c) mp=2 with ``sequence_parallel``:
   phase 28 (b)'s f32 gate, then phase 9's configuration for 2 bf16
   steps within the gate of 28 (a)'s, each rank launching 4 layers x 2
   wgmma forward, dQ and dK/dV, all_gather and reduce_scatter staged;
   (d) ep=2: ERNIE-MoE at
   its training widths and depth (4 of 8 experts a rank), f32 at 2 x 128
   within the f32 gate of a one-rank model (loss, l_aux, logits, every
   gradient), then its 32 x 512 training batch for 2 bf16 steps within
   the gate of a one-rank run, each rank holding 0.50 of the expert
   parameter bytes and counting one ``ep-sharded`` fallback a MoE layer
   a forward; (e) the ep ranks' expert shards swapped must fail (d)'s f32
   gate. ``--sep-fault`` plants three faults, each in its own run: the
   ring's keys at the wrong source offset ((a) must fail), the
   sequence-parallel norms' gradients not summed over mp ((c)), the ep
   all-gather's backward summing where it should slice ((d));
31. disaggregated and fleet serving of phase 20's LLaMA (LLaMA-7B
   widths x 4 layers, f32, one set of seeded weights) on phase 20's
   replay geometry (8 slots, 16-token pages, 128 pages, a 64-token
   bucket): (a) ``inference.DisaggEngine``, one prefill worker and two
   decode workers at multi_tick 8 with the prefix cache, 8 requests
   (prompts 64-127, half seeded sampling, two sharing a 32-token prefix,
   64 new tokens), decode worker 1 killed two steps after the first
   migrations: every stream equal to the single-loop Engine's, no page
   leaked, a migration a request at least, the kill's requests
   re-admitted, every decode tick on the split paged-decode kernel, no
   flash launch (the Engine's prefill attends through the paged gather),
   no kernel build and one graph capture a k bucket a decode worker; the
   migration's gather and scatter timed with CUDA events; (b)
   ``inference.ServingFleet``, two replicas behind the session router,
   8 requests in two sessions of four sharing a 32-token system prompt,
   a live greedy and a live sampled request migrated, replica 1 killed
   mid-decode: every stream the single-loop Engine's, no page leaked,
   warm routes; (c) the replay tool's ``--disagg --prefill-workers 1
   --decode-workers 2 --kill-worker decode:1:20 --expect-pallas`` on
   phase 20 (a)'s trace, its tokens phase 20 (a)'s plain run's.
   ``--disagg-fault`` runs (a) with every migration's scatter skipping
   the request's last page: its token gate must fail.

It prints the card line, a {"kernels": [...]} line (the tensor-core
forward, dQ and dK/dV as ``flash_fwd`` / ``flash_bwd_dq`` /
``flash_bwd_dkv`` with ``flash_route`` "cuda-tc", each naming its wgmma
kernel (``kernel``, ``launches_wgmma``, ``sass``) and, for dQ and dK/dV,
its mma.sync kernel at head dim 256 (``mma_sync_case``), every case the
kernel its C entry reported, the f32 forward of the
serving paths as
``flash_fwd_tf32x3``, the CUDA-core forward and dQ as ``flash_fwd_simt``
/ ``flash_bwd_dq_simt``; paged decode as ``paged_decode`` (its two
kernels, launches by path and on the split kernel, the MoE geometry's
case); the grouped-FFN forward as ``grouped_ffn_fwd``
on the tc route, ``grouped_ffn_fwd_rows`` (the decode tick) and
``grouped_ffn_fwd_simt`` (the prefill), dx as
``grouped_ffn_bwd_dx`` (tc), dw as ``grouped_ffn_bwd_dw`` (tc) and
``grouped_ffn_bwd_dw_simt`` (the f32 prefill case), each with its
``grouped_ffn_route``; the fused update as ``fused_adam``), and as its
last line
{"ok": true, "device":
{...}}. Details land in
chiprun_out/chip_smoke/ (result JSON, nvcc/ptxas logs, the replay
runs' logs). About fifteen minutes of command time on an H100, the six
kernel builds included; phase 27's Inductor compiles (about five
minutes) run in the warm-up process beside phases 3-26.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
              "tf32": 495e12}
#: TF32 products an f32-grade product takes on the tensor cores (3xTF32:
#: big big + big small + small big), the work the tf32x3 route's bound
#: counts at the TF32 peak
TF32X3_PRODUCTS = 3

# the serving and training configurations are those of
# paddle_tpu_torch.profile_serving / profile_training (imported in main)
N_REQUESTS, PROMPT_LO, PROMPT_HI, NEW_TOKENS = 24, 64, 192, 128
#: cross-check thresholds: share of greedy tokens equal to the
#: teacher-forced argmax of the no-cache f32 forward (an f32 pool only
#: differs by summation order; a bf16 pool rounds K/V to 8 bits)
AGREE_F32, AGREE_BF16 = 0.97, 0.85

TRAIN_STEPS = 6
#: the small on-card cross-check model
XCHECK_MODEL = dict(vocab_size=32000, hidden_size=512,
                    intermediate_size=1408, num_hidden_layers=2,
                    num_attention_heads=8, num_key_value_heads=2,
                    max_position_embeddings=256, fused_linear_ce=True,
                    fused_ce_chunks=4)
#: max relative gradient error, card vs CPU, f32 with TF32 off: only the
#: order of summation differs (kernels, cuBLAS and the CPU); TF32's 10-bit
#: mantissa would be well above it
XCHECK_GRAD_TOL, XCHECK_LOSS_TOL = 1e-4, 1e-4


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: the per-route launch counters of the flash wrappers (each by the kernel
#: its C entry reports it ran; a tc launch at head dims up to 128 also
#: counts on *_cuda_tc_wgmma: the wgmma kernel)
FLASH_ROUTES = ("fwd_cuda_tc", "fwd_cuda_tc_wgmma", "fwd_cuda_tf32x3",
                "fwd_cuda_simt", "dq_cuda_tc", "dq_cuda_tc_wgmma",
                "dq_cuda_simt", "dkv_cuda_tc", "dkv_cuda_tc_wgmma",
                "dkv_cuda_simt")


def flash_routes(counters):
    """The flash forward, dQ and dK/dV launches by route in a counter
    snapshot."""
    return {n: int(counters.get(f"kernels.flash.{n}", 0))
            for n in FLASH_ROUTES}


def reported_kernel(before, after, n):
    """The kernel the C entry of flash kernel ``n`` ("fwd", "dq" or "dkv")
    reported it ran, for the one launch between two counter snapshots:
    "wgmma" (``{n}_cuda_tc_wgmma``), "mma_sync" (``{n}_cuda_tc`` less
    those), "tf32x3" or "simt"; None unless exactly one launch moved the
    counters."""
    moved = {r: int(after.get(f"kernels.flash.{n}_cuda_{r}", 0))
             - int(before.get(f"kernels.flash.{n}_cuda_{r}", 0))
             for r in ("tc", "tc_wgmma", "tf32x3", "simt")}
    ran = {"wgmma": moved["tc_wgmma"],
           "mma_sync": moved["tc"] - moved["tc_wgmma"],
           "tf32x3": moved["tf32x3"], "simt": moved["simt"]}
    return next((k for k, c in ran.items() if c == 1), None) \
        if sorted(ran.values()) == [0, 0, 0, 1] else None


def check_routes(counters, want, what):
    """Every flash launch of a path on the routes ``want`` names (route
    counter -> launches), none on any other."""
    got = flash_routes(counters)
    if got != {n: want.get(n, 0) for n in FLASH_ROUTES}:
        fail(f"{what}: flash launches by route {got}, expected {want} and "
             f"none elsewhere")
    return got


def check_tc_routes(counters, want, what):
    """A bf16 training path (head dim 64 or 128): every flash forward, dQ
    and dK/dV launch on the tensor-core route, each on its wgmma kernel,
    none on tf32x3 or simt."""
    return check_routes(counters, {n: want for n in FLASH_ROUTES
                                   if "_cuda_tc" in n}, what)


def check_f32_routes(counters, want, what):
    """An f32 serving path: every flash forward launch on the tf32x3
    route, none on tc or simt, and no backward launch."""
    return check_routes(counters, {"fwd_cuda_tf32x3": want}, what)


def check_paged_split(counters, launches, what):
    """Every paged-decode call of a serving path ran the split kernel and
    the combine (the C entry reported more than one chunk a slot), none
    the single-chunk path: the decode counters by route."""
    got = {r: int(counters.get(f"kernels.decode.paged_cuda_{r}", 0))
           for r in ("split", "single")}
    if got != {"split": launches, "single": 0}:
        fail(f"{what}: paged-decode calls by route {got}, expected "
             f"{launches} on the split kernel and none elsewhere")
    return got


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device ms of fn() over `iters` back-to-back calls (CUDA
    events around the whole run, after `warmup` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bound(nbytes, flops, dname, route):
    """``bound_ms`` of a flash kernel on its route, with the peak it is
    held to: the dtype's, except that the tf32x3 route counts
    TF32X3_PRODUCTS TF32 products per counted operation at the TF32 peak
    (f32-grade results on the tensor cores), where the f32 CUDA-core peak
    would put the bound above what the route can reach."""
    if route == "tf32x3":
        return (*bound_ms(nbytes, TF32X3_PRODUCTS * flops, "tf32"),
                f"tf32 {PEAK_FLOPS['tf32'] / 1e12:.0f} TFLOP/s x "
                f"{TF32X3_PRODUCTS}")
    return (*bound_ms(nbytes, flops, dname),
            f"{dname} {PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def closeness(got, ref, rtol=None, atol=None):
    """A kernel's output against its plain version (f32 math on the same
    inputs), element by element: |got - ref| <= rtol * |ref| + atol.

    By the output's dtype, unless given: f32 differs only by the order of
    summation, so rtol 0 and atol 1e-4 of max(1, max |ref|). A bf16 (or
    fp16) output is computed in f32 and rounded once on store, at most
    half an ulp, which is 2^-8 |ref| (2^-11) at the bottom of a binade:
    rtol is one ulp there, the dtype's eps, 2^-7 (2^-10), and atol 1e-3
    of the rms of ref, for the f32 noise on entries near zero. Returns
    max_abs_err, the tolerance and ``ratio``, the largest |got - ref| over
    its allowance (pass: <= 1)."""
    import torch
    half = got.dtype in (torch.bfloat16, torch.float16)
    if rtol is None:
        rtol = torch.finfo(got.dtype).eps if half else 0.0
    got, ref = got.float(), ref.float()
    if atol is None:
        atol = (1e-3 * float(ref.square().mean().sqrt()) if half
                else 1e-4 * max(1.0, float(ref.abs().max())))
    diff = (got - ref).abs()
    ratio = float((diff / (rtol * ref.abs() + max(atol, 1e-30))).max())
    return dict(max_abs_err=float(diff.max()), tol=dict(rtol=rtol, atol=atol),
                ratio=ratio)


# -- phase 3: kernels against their plain versions -------------------------

def graph_ms(torch, fn, calls=20, reps=5):
    """Device ms of one fn() from a CUDA graph of ``calls`` back-to-back
    calls, replayed ``reps`` times between CUDA events (after one call
    outside the graph): the kernels' own time with the host's launch
    work taken out, which at a few microseconds a kernel is larger than
    the kernels (events around eager calls then time the host)."""
    fn()
    torch.cuda.synchronize()
    from paddle_tpu_torch.inference.decode_graph import gc_paused
    g = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (reps * calls)


#: the paged decode's serving geometries: (slots, h, h_kv, d, pool dtype,
#: longest context, page size, pages a slot) of LLaMA
#: (profile_serving.MODEL in the Engine of phase 5), ERNIE-MoE
#: (profile_moe's serving engine, phase 12) and phase 20's replay engine
#: (REPLAY_LLAMA + REPLAY_ENGINE: 16-token pages, a table of 16 pages for
#: the replay's own traces, whose contexts reach 255, on the split kernel;
#: a table of 4 for the chaos fixture's, whose contexts reach 34, on the
#: single-chunk kernel)
PAGED_SERVING = {"llama": (16, 32, 32, 128, "bfloat16", 320, 128, 3),
                 "ernie_moe": (8, 16, 16, 64, "float32", 287, 128, 3),
                 "replay": (8, 32, 32, 128, "float32", 255, 16, 16),
                 "replay_fixture": (8, 32, 32, 128, "float32", 34, 16, 4)}


def _paged_combine_control(torch, pa, got, scratch, ctx, want, window,
                           chunk):
    """The combine skipping one slot's last chunk: the kernel's own
    partials (its scratch) combined in chunk order, as the combine does,
    once over every chunk (which must equal the kernel's output within
    the gate, so the recombination is the kernel's) and once without the
    last chunk of the slot with the most chunks; the closeness gate must
    reject the second."""
    b, h, d = got.shape
    acc, ml = pa.decode_partials(scratch, b, h, d)
    lo = (ctx - window).clamp(min=0) if window else torch.zeros_like(ctx)
    hi = ctx.clamp(max=acc.shape[2] * chunk)
    first, last = lo // chunk, (hi - 1) // chunk
    slot = int(torch.argmax(torch.where(hi > lo, last - first, -1)))

    def combine(drop):
        out = torch.zeros_like(got)
        for s_ in range(b):
            if hi[s_] <= lo[s_]:
                continue
            cs = list(range(int(first[s_]), int(last[s_]) + 1))
            if drop and s_ == slot:
                cs = cs[:-1]
            m, l, a = ml[s_, :, cs, 0], ml[s_, :, cs, 1], acc[s_, :, cs]
            w = torch.exp(m - m.max(dim=1, keepdim=True).values)
            out[s_] = (a * w[..., None]).sum(1) / (l * w).sum(1)[:, None]
        return out
    full = closeness(combine(False), got)
    short = closeness(combine(True), want)
    print(f"  negative control (combine without slot {slot}'s last chunk "
          f"of {int(last[slot] - first[slot]) + 1}): ratio to tol "
          f"{short['ratio']:.3g} (rejected: > 1; every chunk: "
          f"{full['ratio']:.3g} against the kernel)", flush=True)
    if not (full["ratio"] <= 1.0 and short["ratio"] > 1.0):
        fail(f"the paged-decode gate does not reject a combine short of a "
             f"chunk: {full}, {short}")
    return dict(slot=slot, chunks=int(last[slot] - first[slot]) + 1,
                ratio=short["ratio"], max_abs_err=short["max_abs_err"],
                ratio_full_recombine=full["ratio"])


def check_paged(torch, pa, kvq):
    """Paged decode at the serving geometries (PAGED_SERVING: LLaMA, 16
    slots, h = h_kv = 32, d 128, contexts ragged up to 320 with dead
    slots, f32, bf16 and int8 pools, GQA rep 4 and a window; ERNIE-MoE, 8
    slots, h = h_kv = 16, d 64, f32 pool, contexts ragged up to 287 with
    a dead slot; the replay engine of phase 20, 8 slots, h = h_kv = 32, d
    128, 16-token pages, f32 pool, contexts ragged up to 255 (split) and
    up to 34 (single chunk), each with a dead slot): the raw launch and the wrapper each against the plain
    version (the wrapper bit-equal to the raw launch), its chunking as
    the C entry reports it, timed as raw launches of the split kernel and
    the combine (``ms``: ``graph_ms`` cycling through copies of the pools
    that together exceed the L2, ``cold_copies``) and through the wrapper
    (``wrapper_ms``, events around eager calls: host included) beside the
    plain version and the bound over the live tokens; at the three
    split serving cases (``controlled``) the combine without a slot's last
    chunk must be rejected."""
    from paddle_tpu_torch.ab_serving_kernels import cold_copies
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    specs = [("serving_bf16", "llama", 32, torch.bfloat16, None),
             ("serving_f32", "llama", 32, torch.float32, None),
             ("int8", "llama", 32, torch.int8, None),
             ("gqa_rep4", "llama", 8, torch.bfloat16, None),
             ("window", "llama", 32, torch.bfloat16, 100),
             ("moe_serving_f32", "ernie_moe", 16, torch.float32, None),
             ("replay_f32", "replay", 32, torch.float32, None),
             ("replay_single_f32", "replay_fixture", 32, torch.float32,
              None)]
    controlled = ("serving_bf16", "moe_serving_f32", "replay_f32")
    ctxs = {}
    for geo, (b, _, _, _, _, longest, _, _) in PAGED_SERVING.items():
        ctx = torch.randint(1, longest + 1, (b,), generator=g, device=dev)
        ctx[3] = 0                     # a dead (idle) slot
        ctx[0] = longest
        if geo == "llama":
            ctx[11] = 0
            ctx[5], ctx[7] = 128, 1
        ctxs[geo] = ctx
    for name, geo, hkv, dt, window in specs:
        b, h, _, d, _, _, bs, nblk = PAGED_SERVING[geo]
        ctx = ctxs[geo]
        nb = b * nblk + 1
        bt = (torch.randperm(nb - 1, generator=g, device=dev) + 1).reshape(
            b, nblk).to(torch.int32)
        q = torch.randn(b, h, d, generator=g, device=dev)
        kf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
        vf = torch.randn(nb, hkv, bs, d, generator=g, device=dev)
        ks = vs = None
        if dt == torch.int8:
            kc, ks = kvq(kf)
            vc, vs = kvq(vf)
        else:
            kc, vc = kf.to(dt), vf.to(dt)
        args = (q, kc, vc, bt, ctx)
        kw = dict(window=window, k_scale=ks, v_scale=vs)
        qf, btc, cl = pa._check_cuda(q, kc, vc, bt, ctx, ks, vs)
        out = torch.empty(b, h, d, device=dev)
        scratch = pa.decode_scratch(qf, btc, bs)
        chunk, nch = pa._decode_launch(qf, kc, vc, btc, cl, out, scratch,
                                       d ** -0.5, window, ks, vs)
        got = pa.paged_decode(*args, **kw)
        torch.cuda.synchronize()
        want = pa.paged_attention_arrays(*args, **kw)
        c = closeness(out, want)
        c_wrap = closeness(got, want)
        control = (_paged_combine_control(torch, pa, out, scratch, ctx,
                                          want, window, chunk)
                   if name in controlled else None)
        live = (torch.minimum(ctx, torch.tensor(nblk * bs, device=dev))
                - (torch.clamp(ctx - window, min=0) if window else 0)
                ).clamp(min=0)
        toks = int(live.sum())
        item = kc.element_size()
        kv_bytes = 2 * toks * hkv * d * item + (8 * toks * hkv if ks is
                                                not None else 0)
        nbytes = (kv_bytes + 2 * q.numel() * 4 + bt.numel() * 4
                  + ctx.numel() * 8)
        flops = 4 * toks * h * d
        bms, by = bound_ms(nbytes, flops, "float32")
        pools = cold_copies(torch, (kc, vc, ks, vs), kv_bytes)
        walk = iter(range(10 ** 9))

        def raw():
            kc_, vc_, ks_, vs_ = pools[next(walk) % len(pools)]
            return pa._decode_launch(qf, kc_, vc_, btc, cl, out, scratch,
                                     d ** -0.5, window, ks_, vs_)
        rec = dict(case=name, geometry=geo, slots=b, heads=h, kv_heads=hkv,
                   head_dim=d, pool=str(dt).replace("torch.", ""),
                   window=window, **c, wrapper_ratio=c_wrap["ratio"],
                   chunk=chunk, chunks_launched=nch,
                   ms=graph_ms(torch, raw), pool_copies=len(pools),
                   wrapper_ms=cuda_ms(lambda: pa.paged_decode(*args, **kw)),
                   plain_ms=cuda_ms(lambda: pa.paged_attention_arrays(
                       *args, **kw)),
                   bound_ms=bms, bound_by=by, live_tokens=toks,
                   negative_control=control)
        del pools
        print(f"  paged_decode[{name}]: err {c['max_abs_err']:.3g} (tol "
              f"{c['tol']}, ratio {c['ratio']:.3g}; wrapper ratio "
              f"{c_wrap['ratio']:.3g}); {nch} chunks of {chunk}; kernels "
              f"{rec['ms']:.4f} ms ({rec['pool_copies']} pool copies), "
              f"wrapper {rec['wrapper_ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by})",
              flush=True)
        if not c["ratio"] <= 1.0:
            fail(f"paged_decode[{name}] disagrees with its plain version: "
                 f"{c}")
        if not (c_wrap["ratio"] <= 1.0 and torch.equal(got, out)):
            fail(f"paged_decode[{name}]: the wrapper's output differs from "
                 f"its plain version ({c_wrap}) or from the raw launch's")
        if chunk != pa.DECODE_CHUNK or nch != pa.paged_decode_chunks(
                nblk, bs) or nch * chunk < int(ctx.max()):
            fail(f"paged_decode[{name}]: the C entry reports {nch} chunks "
                 f"of {chunk} for contexts up to {int(ctx.max())}")
        if rec["ms"] < bms:
            fail(f"paged_decode[{name}]: {rec['ms']} ms is below its bound "
                 f"{bms} ms")
        cases.append(rec)
    return cases


def check_flash(torch, fa):
    """Flash forward at B 2, S 1024, H 32, D 128 causal f32 (the no-cache
    forward's shape, the tf32x3 route), plus GQA, sq != sk with a window,
    a ragged head dim 80, bf16 (the tc route), and the main f32 shape read
    through views whose rows are 4 bytes off 16-byte alignment, which only
    the simt kernel takes. ``ms`` times the raw launch, ``wrapper_ms``
    the wrapper (checks, allocation, counters) around it."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    # name, B, sq, sk, h, hkv, d, dtype, window, rows 16-byte aligned
    specs = [("main_f32", 2, 1024, 1024, 32, 32, 128, torch.float32, None,
              True),
             ("gqa_f32", 2, 1024, 1024, 32, 8, 128, torch.float32, None,
              True),
             ("sq_ne_sk_window", 2, 333, 1024, 32, 32, 128, torch.float32,
              256, True),
             ("ragged_d80", 1, 100, 77, 4, 2, 80, torch.float32, None, True),
             ("main_bf16", 2, 1024, 1024, 32, 32, 128, torch.bfloat16,
              None, True),
             ("main_f32_unaligned", 2, 1024, 1024, 32, 32, 128,
              torch.float32, None, False)]
    cases = []
    for name, B, sq, sk, h, hkv, d, dt, window, aligned in specs:
        pad = 0 if aligned else 1

        def make(s_, hh):
            x = torch.randn(B, s_, hh, d + pad, generator=g, device=dev)
            return x.to(dt)[..., pad:]
        q, k, v = make(sq, h), make(sk, hkv), make(sk, hkv)
        scale = d ** -0.5
        got = fa.flash_fwd(q, k, v, True, scale, window)
        torch.cuda.synchronize()

        def plain():
            # the kernel's own arithmetic: f32 throughout
            return fa.flash_plain(q.transpose(1, 2).float(),
                                  k.transpose(1, 2).float(),
                                  v.transpose(1, 2).float(), True, scale,
                                  window).transpose(1, 2)
        c = closeness(got, plain())
        off = sk - sq
        rows = torch.arange(sq)
        hi = torch.clamp(rows + off + 1, 0, sk)
        lo = torch.clamp(rows + off - window + 1, min=0) if window else 0
        pairs = int((hi - lo).clamp(min=0).sum())
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * B * h * pairs * d
        dname = str(dt).replace("torch.", "")
        route = fa._route_of("fwd", [q, k, v])
        bms, by, peak = flash_bound(nbytes, flops, dname, route)
        rec = dict(case=name, B=B, sq=sq, sk=sk, heads=h, kv_heads=hkv,
                   head_dim=d, dtype=dname, window=window, route=route, **c,
                   ms=cuda_ms(lambda: fa._fwd_launch(q, k, v, got, None, True,
                                                     scale, window, None),
                              iters=10),
                   wrapper_ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, True,
                                                           scale, window),
                                      iters=10),
                   plain_ms=cuda_ms(plain, iters=5),
                   bound_ms=bms, bound_by=by, bound_peak=peak,
                   library_ms=None)
        if name.startswith("main_f32"):
            # SDPA takes 16-byte aligned rows: the unaligned case's library
            # call reads aligned copies of the same inputs
            qt, kt, vt = (t.transpose(1, 2) if aligned
                          else t.transpose(1, 2).contiguous()
                          for t in (q, k, v))
            rec["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                iters=10)
        print(f"  flash_fwd[{name}] ({route}): err "
              f"{c['max_abs_err']:.3g} (tol "
              f"{c['tol']}, ratio {c['ratio']:.3g}) kernel {rec['ms']:.4f} "
              f"ms, plain {rec['plain_ms']:.4f} ms, library "
              f"{rec['library_ms']}, bound {bms:.4f} ms ({by}, {peak})",
              flush=True)
        if not c["ratio"] <= 1.0:
            fail(f"flash_fwd[{name}] disagrees with its plain version: {c}")
        if rec["ms"] < bms:
            fail(f"flash_fwd[{name}]: {rec['ms']} ms is below its bound "
                 f"{bms} ms ({peak})")
        cases.append(rec)
    return cases


def check_probe(torch, build):
    """Each library's probe (o = x + x) against x + x, timed as raw
    launches (not counted: these are comparison launches)."""
    dev = torch.device("cuda")
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    o = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.load("paged_decode")

    def launch():
        build.check(lib.paged_decode_probe(x.data_ptr(), o.data_ptr(),
                                           x.numel(), stream), "probe")
    launch()
    torch.cuda.synchronize()
    err = max_err(o, x + x)
    if err != 0.0:
        fail(f"probe kernel returned a wrong answer (err {err})")
    bms, by = bound_ms(2 * x.numel() * 4, x.numel(), "float32")
    plain = cuda_ms(lambda: x + x)
    return [dict(case="8x128_f32", max_abs_err=err, tol=0.0, ratio=0.0,
                 ms=cuda_ms(launch), plain_ms=plain, library_ms=plain,
                 bound_ms=bms, bound_by=by)]


def _dq_key_tile_share(torch, q, k, v, lse, do, delta, scale, lo, hi):
    """The share of dQ (causal, sq == sk, [B, S, H, D]) that keys
    [lo, hi) contribute, in f32: scale dS[:, :, lo:hi] K[lo:hi] with dS =
    P (dP - Delta) over the rows that see those keys."""
    def t(x):
        return x.transpose(1, 2).float()
    qf, kf, vf, dof = t(q), t(k[:, lo:hi]), t(v[:, lo:hi]), t(do)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    rows = torch.arange(q.shape[1], device=q.device)[:, None]
    keys = torch.arange(lo, hi, device=q.device)[None, :]
    p = torch.where(rows >= keys, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta[..., None])
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale).transpose(1, 2)


def check_is_sharp(torch, fa, q, k, v, out, lse, do, scale, grads, refs):
    """Negative controls at the main training shape (causal, sq == sk): a
    dK/dV kernel that leaves out one 32-row q tile, either the last (its
    q-tile loop one short) or one in the middle (a tile wrongly skipped),
    misses that tile's share of dV; a dQ kernel that leaves out one
    32-key tile in the middle misses that tile's share of dQ in every row
    that sees it. Subtract the share (flash_bwd_plain over those rows and
    the keys up to their end: with sq < sk the rows sit bottom-right,
    where they sit in the full causal band; for dQ the tile's keys against
    every row) from the kernel's output and show that the element-wise
    check rejects each. The rule it replaced (max abs error within 1e-2
    of max |ref|) is reported beside it."""
    def t(x):
        return x.transpose(1, 2).float()
    dq, dv = grads
    ref_dq, ref_dv = refs
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    recs = {}
    for label, lo in (("last_q_tile", q.shape[1] - 32), ("q_tile_480", 480),
                      ("dq_key_tile_480", 480)):
        hi = lo + 32
        if label.startswith("dq"):
            got, ref = dq, ref_dq
            short = dq.float() - _dq_key_tile_share(
                torch, q, k, v, lse, do, delta, scale, lo, hi)
        else:
            got, ref = dv, ref_dv
            share = fa.flash_bwd_plain(
                t(q[:, lo:hi]), t(k[:, :hi]), t(v[:, :hi]), t(out[:, lo:hi]),
                lse[:, :, lo:hi].contiguous(), t(do[:, lo:hi]), True,
                scale)[2]
            short = dv.float()
            short[:, :hi] -= share.transpose(1, 2)
        old_tol = 1e-2 * max(1.0, float(ref.abs().max()))
        c = closeness(short.to(got.dtype), ref)
        recs[label] = rec = dict(ratio=c["ratio"],
                                 max_abs_err=c["max_abs_err"],
                                 old_rule_tol=old_tol,
                                 old_rule_passes=c["max_abs_err"] <= old_tol)
        what = "dQ" if label.startswith("dq") else "dV"
        print(f"  negative control ({what} without {label}): ratio to tol "
              f"{c['ratio']:.3g} (rejected: > 1); max abs err "
              f"{c['max_abs_err']:.3g}, old rule tol {old_tol:.3g} (passes "
              f"the old rule: {rec['old_rule_passes']})", flush=True)
        if not c["ratio"] > 1.0:
            fail(f"the element-wise check does not reject {what} without "
                 f"{label}: {rec}")
    return recs


#: keys per tile of the tc forward's wgmma kernel at head dim 128
#: (csrc/flash_fwd.cu Fwd128): the key tile its negative control leaves
#: out
FWD_KEY_TILE = 32


def check_fwd_is_sharp(torch, fa, q, k, v, ref, scale, lo):
    """Negative control of the forward at the main training shape (causal,
    sq == sk): a kernel that skips the key tile [lo, lo + FWD_KEY_TILE)
    (a walk one tile short, or a tile wrongly skipped) outputs attention
    over the other keys: flash_plain with those key columns masked for
    every row (flashmask bands), in f32, rounded to the output dtype.
    The element-wise check against the plain version ``ref`` must reject
    it."""
    sq, sk = q.shape[1], k.shape[1]
    hi = lo + FWD_KEY_TILE
    bands = torch.zeros(1, 1, 4, sk, dtype=torch.int32, device=q.device)
    bands[..., 1, lo:hi] = sq                  # rows [0, sq) of keys lo..hi
    short = fa.flash_plain(*(x.transpose(1, 2).float() for x in (q, k, v)),
                           True, scale, se=bands).transpose(1, 2)
    c = closeness(short.to(q.dtype), ref)
    print(f"  negative control (out without keys {lo}-{hi - 1}): ratio to "
          f"tol {c['ratio']:.3g} (rejected: > 1); max abs err "
          f"{c['max_abs_err']:.3g}", flush=True)
    if not c["ratio"] > 1.0:
        fail(f"the element-wise check does not reject out without keys "
             f"{lo}-{hi - 1}: {c}")
    return dict(keys=[lo, hi], ratio=c["ratio"], max_abs_err=c["max_abs_err"])


#: phase 7's cases: name, B, sq, sk, h, hkv, d, dtype, window, documents,
#: causal — the LLaMA training shape (the first: the negative controls run
#: there), five edge cases, the ERNIE-MoE training shape (profile_moe's
#: MOE_TRAIN_MODEL attention: batch 32 x seq 512, 16 heads of 64) and bf16
#: at head dim 256, where the tc route runs the mma.sync kernels
FLASH_TRAIN_SPECS = [
    ("train_bf16", 12, 1024, 1024, 32, 32, 128, "bfloat16", None, None,
     True),
    ("f32", 2, 1024, 1024, 32, 32, 128, "float32", None, None, True),
    ("gqa8_bf16", 2, 1024, 1024, 32, 8, 128, "bfloat16", None, None, True),
    ("window256_bf16", 2, 1024, 1024, 32, 32, 128, "bfloat16", 256, None,
     True),
    ("sq333_sk1024_bf16", 2, 333, 1024, 32, 32, 128, "bfloat16", None, None,
     True),
    ("doc4_bf16", 2, 1024, 1024, 32, 32, 128, "bfloat16", None,
     [256, 384, 128, 256], True),
    ("moe_train_bf16", 32, 512, 512, 16, 16, 64, "bfloat16", None, None,
     True),
    ("d256_bf16", 2, 1024, 1024, 8, 8, 256, "bfloat16", None, None, True),
]


def check_flash_train(torch, fa, doc_mask, specs=FLASH_TRAIN_SPECS):
    """Phase 7 (and phase 15 at the BERT training shape): the flash
    forward with logsumexp, the dQ kernel and the dK/dV kernel against
    flash_plain / flash_bwd_plain (f32 math on the same rounded inputs).
    Each kernel is timed on its own; the bound of a kernel counts the
    operations of its own function (forward 4, dQ 6, dK/dV 8 x pairs x
    d, since each backward kernel recomputes S and dP), the pass bound
    counts the backward pass once (10 = 2.5 x the forward's). Each case
    records the route (``fa.flash_route``) its forward, dQ and dK/dV take
    and the kernel each C entry reported it ran (``fwd_kernel``,
    ``bwd_kernel``, from the deltas of the route counters): every 16-bit
    forward and every bf16 dQ and dK/dV must have run its wgmma kernel at
    head dim <= 128 and its mma.sync kernel above. At the LLaMA training
    case (``train_bf16``) the wrapper's Delta = rowsum(dO O) is timed on
    its own, as a share of the pass (aten's backward computes it
    inside)."""
    from paddle_tpu_torch import monitor
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16
    cases = []
    for name, B, sq, sk, h, hkv, d, dname, window, docs, causal in specs:
        dt = getattr(torch, dname)
        q, do = (torch.randn(B, sq, h, d, generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, sk, hkv, d, generator=g, device=dev).to(dt)
                for _ in range(2))
        se = None if docs is None else fa._normalize_startend(
            doc_mask(docs, device=dev), sq, sk, causal)
        scale = d ** -0.5
        item = q.element_size()
        keep = fa._keep_mask(sq, sk, h, causal, window, se, dev)
        pairs = B * h * sq * sk if keep is None else \
            int(keep.sum()) * B * h // (keep.numel() // (sq * sk))

        def t(x):
            return x.transpose(1, 2).float()

        tc_kernel = fa.flash_tc_kernel("fwd", d)
        before = monitor.snapshot()
        out, lse = fa.flash_fwd(q, k, v, causal, scale, window, se,
                                want_lse=True)
        torch.cuda.synchronize()
        fwd_kernel = reported_kernel(before, monitor.snapshot(), "fwd")
        if dt != torch.float32 and fwd_kernel != tc_kernel:
            fail(f"flash_fwd[{name}]: the 16-bit forward at head dim {d} "
                 f"did not launch the {tc_kernel} kernel ({fwd_kernel})")

        def plain_fwd():
            return fa.flash_plain(t(q), t(k), t(v), causal, scale, window,
                                  se, return_lse=True)
        want, want_lse = plain_fwd()
        dead = want_lse <= fa.ROW_INVALID_LSE
        if not torch.equal(lse <= fa.ROW_INVALID_LSE, dead):
            fail(f"flash_fwd[{name}]: rows without keys disagree")
        res = {"out": closeness(out, want.transpose(1, 2)),
               "lse": closeness(lse[~dead], want_lse[~dead], rtol=0.0,
                                atol=1e-5 * max(1.0, float(
                                    want_lse[~dead].abs().max())))}
        fwd_sharp = None
        if name == "train_bf16":
            fwd_sharp = check_fwd_is_sharp(torch, fa, q, k, v,
                                           want.transpose(1, 2), scale, 512)
        del want, want_lse
        before = monitor.snapshot()
        dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, causal, scale,
                                  window, se)
        torch.cuda.synchronize()
        after = monitor.snapshot()
        bwd_kernel = {n: reported_kernel(before, after, n)
                      for n in ("dq", "dkv")}
        if dt == bf16 and bwd_kernel != {"dq": tc_kernel, "dkv": tc_kernel}:
            fail(f"flash_bwd[{name}]: the bf16 backward at head dim {d} did "
                 f"not launch the {tc_kernel} kernels ({bwd_kernel})")

        def plain_bwd():
            return fa.flash_bwd_plain(t(q), t(k), t(v), t(out), lse, t(do),
                                      causal, scale, window, se)
        refs = [r.transpose(1, 2) for r in plain_bwd()]
        for n, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            res[n] = closeness(got, ref)
        sharp = None
        if name == "train_bf16":
            sharp = check_is_sharp(torch, fa, q, k, v, out, lse, do, scale,
                                   (dq, dv), (refs[0], refs[2]))
            sharp["fwd_key_tile_512"] = fwd_sharp
        del dq, dk, dv, refs
        errs = {n: r["max_abs_err"] for n, r in res.items()}
        tols = {n: r["tol"] for n, r in res.items()}
        ratios = {n: r["ratio"] for n, r in res.items()}
        bad = {n: r for n, r in res.items() if not r["ratio"] <= 1.0}
        if bad:
            fail(f"flash[{name}] disagrees with its plain version: {bad}")

        # timing: each kernel alone (raw launches, not counted), the whole
        # backward pass through its wrapper, the plain versions
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, do, lse, delta)
        dq_b = torch.empty_like(q)
        dk_b, dv_b = torch.empty_like(k), torch.empty_like(v)
        rows = B * h * sq * 4
        qb, kb = q.numel() * item, k.numel() * item
        rec = dict(case=name, B=B, sq=sq, sk=sk, heads=h, kv_heads=hkv,
                   head_dim=d, dtype=dname, window=window, documents=docs,
                   causal=causal, pairs=pairs, max_abs_err=errs, tol=tols,
                   ratio=ratios, negative_control=sharp,
                   route={n: fa._route_of(n, [q, k, v] if n == "fwd"
                                          else [q, k, v, do])
                          for n in fa.FLASH_KERNELS},
                   fwd_kernel=fwd_kernel, bwd_kernel=bwd_kernel)
        # each kernel's bytes and counted operations (forward 4, dQ 6,
        # dK/dV 8 x pairs x d), the pass's (10)
        work = {"fwd": (2 * qb + 2 * kb + rows, 4),
                "dq": (3 * qb + 2 * kb + 2 * rows, 6),
                "dkv": (2 * qb + 4 * kb + 2 * rows, 8)}
        for n, (nbytes, per_pair) in work.items():
            rec[n] = {}
            rec[n]["bound_ms"], rec[n]["bound_by"], rec[n]["bound_peak"] = \
                flash_bound(nbytes, per_pair * pairs * d, dname,
                            rec["route"][n])
        out_b, lse_b = torch.empty_like(out), torch.empty_like(lse)
        rec["fwd"].update(
            ms=cuda_ms(lambda: fa._fwd_launch(q, k, v, out_b, lse_b, causal,
                                              scale, window, se), iters=10),
            wrapper_ms=cuda_ms(lambda: fa.flash_fwd(
                q, k, v, causal, scale, window, se, want_lse=True),
                iters=10),
            plain_ms=cuda_ms(plain_fwd, iters=3))
        rec["dq"]["ms"] = cuda_ms(lambda: fa._bwd_launch(
            "flash_bwd_dq_launch", args, dq_b, None, causal, scale, window,
            se), iters=10)
        rec["dkv"]["ms"] = cuda_ms(lambda: fa._bwd_launch(
            "flash_bwd_dkv_launch", args, dk_b, dv_b, causal, scale, window,
            se), iters=10)
        plain_pass = cuda_ms(plain_bwd, iters=3)
        rec["pass"] = dict(
            ms=cuda_ms(lambda: fa.flash_bwd(q, k, v, out, lse, do, causal,
                                            scale, window, se), iters=10),
            plain_ms=plain_pass)
        rec["pass"].update(zip(("bound_ms", "bound_by"), bound_ms(
            4 * qb + 4 * kb + rows, 10 * pairs * d, dname)))
        if name == "train_bf16":
            rec["pass"]["delta_ms"] = cuda_ms(
                lambda: (do.float() * out.float()).sum(-1).transpose(1, 2)
                .contiguous(), iters=10)
            rec["pass"]["delta_share"] = \
                rec["pass"]["delta_ms"] / rec["pass"]["ms"]
            print(f"  flash train[{name}]: Delta = rowsum(dO O) "
                  f"{rec['pass']['delta_ms']:.4f} ms = "
                  f"{rec['pass']['delta_share']:.3f} of the wrapper's pass "
                  f"{rec['pass']['ms']:.4f} ms", flush=True)
        rec["dq"]["plain_ms"] = rec["dkv"]["plain_ms"] = plain_pass
        rec["fwd"]["library_ms"] = rec["pass"]["library_ms"] = None
        rec["library_note"] = (
            "aten flash attention takes bf16/fp16 with equal heads, sq == "
            "sk and no window or mask; it computes dq, dk and dv in one "
            "call, so its time stands beside the pass; an f32 case's "
            "forward stands beside SDPA f32 and its pass beside the "
            "backward of aten's memory-efficient attention "
            "(_efficient_attention_backward, through autograd)")
        plain_case = h == hkv and sq == sk and window is None and se is None
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        if dt == torch.float32 and plain_case:
            rec["fwd"]["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale), iters=10)
            from torch.nn.attention import SDPBackend, sdpa_kernel
            qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                o_e = torch.nn.functional.scaled_dot_product_attention(
                    qg, kg, vg, is_causal=causal, scale=scale)
            rec["pass"]["library_ms"] = cuda_ms(
                lambda: torch.autograd.grad(o_e, (qg, kg, vg), dot,
                                            retain_graph=True), iters=10)
            del qg, kg, vg, o_e
        if dt == bf16 and plain_case:
            aten = torch.ops.aten

            def lib_fwd():
                return aten._scaled_dot_product_flash_attention(
                    qt, kt, vt, 0.0, causal, False, scale=scale)
            o_a, lse_a, cq, ck, mq, mk, seed, off, _ = lib_fwd()
            rec["fwd"]["library_ms"] = cuda_ms(lib_fwd, iters=10)
            rec["pass"]["library_ms"] = cuda_ms(
                lambda: aten._scaled_dot_product_flash_attention_backward(
                    dot, qt, kt, vt, o_a, lse_a, cq, ck, mq, mk, 0.0, causal,
                    seed, off, scale=scale), iters=10)
            del o_a, lse_a
        rec["dq"]["library_ms"] = rec["dkv"]["library_ms"] = \
            rec["pass"]["library_ms"]
        for n in ("fwd", "dq", "dkv"):
            if rec[n]["ms"] < rec[n]["bound_ms"]:
                fail(f"flash train[{name}] {n}: {rec[n]['ms']} ms is below "
                     f"its bound {rec[n]['bound_ms']} ms "
                     f"({rec[n]['bound_peak']})")
        print(f"  flash train[{name}] (routes {rec['route']}, backward "
              f"kernels {bwd_kernel}): err {errs} "
              f"(ratio to tol {ratios}, "
              f"tol {tols}); fwd+lse "
              f"{rec['fwd']['ms']:.3f} ms (bound {rec['fwd']['bound_ms']:.3f}"
              f", plain {rec['fwd']['plain_ms']:.3f}, library "
              f"{rec['fwd']['library_ms']}); dQ {rec['dq']['ms']:.3f} ms "
              f"(bound {rec['dq']['bound_ms']:.3f}); dK/dV "
              f"{rec['dkv']['ms']:.3f} ms (bound {rec['dkv']['bound_ms']:.3f}"
              f"); pass {rec['pass']['ms']:.3f} ms (bound "
              f"{rec['pass']['bound_ms']:.3f}, plain {plain_pass:.3f}, "
              f"library {rec['pass']['library_ms']})", flush=True)
        cases.append(rec)
        del q, k, v, do, out, lse, delta, args, dq_b, dk_b, dv_b, out_b, lse_b
        torch.cuda.empty_cache()
    return cases


def model_cross_check(torch, mods):
    """Phase 8: a small LLaMA on the card against the same weights on the
    CPU (the plain versions of the kernels): one TrainStep loss and every
    parameter gradient of the same loss, with a window, then with a
    document mask."""
    import numpy as np
    out = {}
    for name, extra, docs in (("window64", dict(sliding_window=64), None),
                              ("doc_mask", {}, [64, 96, 32, 64])):
        cfg = mods.LlamaConfig(**XCHECK_MODEL, **extra)
        nets = {"cuda": mods.LlamaForCausalLM(cfg, seed=1)}
        nets["cpu"] = mods.LlamaForCausalLM(cfg, device="cpu")
        nets["cpu"].load_state_dict(
            {k: v.cpu() for k, v in nets["cuda"].state_dict().items()})
        rng = np.random.default_rng(5)
        ids = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64)
        labels = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64)
        res = {}
        for dev, net in nets.items():
            inputs = [torch.from_numpy(ids).to(dev),
                      torch.from_numpy(labels).to(dev)]
            if docs is not None:
                inputs.append(mods.doc_mask(docs, device=dev))
            params = list(net.parameters())
            grads = torch.autograd.grad(net(*inputs), params)
            step = mods.TrainStep(net, lambda o, lab: o, mods.AdamW(
                1e-3, parameters=params))
            res[dev] = (float(step(tuple(inputs), inputs[1])),
                        [gr.cpu() for gr in grads])
        loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        grad_err = max(float((a - b).abs().max()
                             / b.abs().max().clamp(min=1e-30))
                       for a, b in zip(res["cuda"][1], res["cpu"][1]))
        out[name] = dict(loss_cuda=res["cuda"][0], loss_cpu=res["cpu"][0],
                         loss_rel_err=loss_err, max_rel_grad_err=grad_err,
                         grad_tol=XCHECK_GRAD_TOL, loss_tol=XCHECK_LOSS_TOL)
        print(f"model cross-check [{name}]: TrainStep loss cuda "
              f"{res['cuda'][0]:.6f} cpu {res['cpu'][0]:.6f} (rel err "
              f"{loss_err:.2e}, tol {XCHECK_LOSS_TOL}); max relative grad "
              f"error {grad_err:.2e} over {len(res['cpu'][1])} parameters "
              f"(tol {XCHECK_GRAD_TOL})", flush=True)
        if not (loss_err <= XCHECK_LOSS_TOL and grad_err <= XCHECK_GRAD_TOL):
            fail(f"model cross-check [{name}] off: {out[name]}")
        del nets, res
    torch.cuda.empty_cache()
    return out


def train_main_path(torch, mods, fa, monitor, card):
    """Phases 9 + 10: the training benchmark's configuration
    (profile_training's MODEL, BATCH and SEQ) for TRAIN_STEPS steps of one
    fixed batch, counts read around it."""
    batch, seq = mods.train.BATCH, mods.train.SEQ
    cfg = mods.LlamaConfig(**mods.train.MODEL)
    model = mods.LlamaForCausalLM(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    opt = mods.AdamW(3e-4, parameters=model.parameters(),
                     moment_dtype="bfloat16")
    step = mods.TrainStep(model, lambda out, lab: out, opt,
                          amp_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids, labels = (torch.randint(0, cfg.vocab_size, (batch, seq),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
    mods.fad.fused_adam_launch.launches = 0
    monitor.reset()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step((ids, labels), labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_bwd_dq": fa.flash_bwd.launches_dq,
                "flash_bwd_dkv": fa.flash_bwd.launches_dkv}
    adam_launches = mods.fad.fused_adam_launch.launches
    counters = {k: v for k, v in monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted training path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = cfg.num_hidden_layers * TRAIN_STEPS
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"training losses not finite and falling: {losses}")
    if set(launches.values()) != {want}:
        fail(f"training launches {launches}, expected {want} each")
    if counters.get("kernels.flash.fwd_cuda") != want or \
            counters.get("kernels.flash.bwd_cuda") != want or \
            counters.get("kernels.flash.fwd_plain", 0) or \
            counters.get("kernels.flash.bwd_plain", 0):
        fail(f"training kernel-path counters disagree: {counters}")
    routes = check_tc_routes(counters, want, "training")
    update_routes = check_adam_routes(counters, adam_launches, "training")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens = batch * seq
    flops = mods.llama_flops_per_token(cfg) * tokens
    rec = dict(params=n_params, batch=batch, seq=seq,
               steps=TRAIN_STEPS, losses=losses, step_s=times,
               ms_per_step=steady * 1e3, first_step_ms=times[0] * 1e3,
               tokens_per_s=tokens / steady,
               bf16_peak_share=flops / steady / PEAK_FLOPS["bfloat16"],
               peak_mem_gb=peak_gb, launches=launches, counters=counters,
               flash_routes=routes, update_routes=update_routes,
               fused_adam_launches=adam_launches,
               update_ab=update_routes_agree(torch, mods, step, ids,
                                             labels))
    rec["update_ms"], rec["update_plain_ms"] = mods.train.update_ms(step)
    print(f"training: {n_params / 1e9:.3f} B params, batch {batch} x "
          f"seq {seq}, losses {[round(x, 4) for x in losses]}; "
          f"median step {rec['ms_per_step']:.1f} ms (first "
          f"{rec['first_step_ms']:.1f} ms) = {rec['tokens_per_s']:.0f} "
          f"tokens/s, {rec['bf16_peak_share']:.3f} of the 989 TFLOP/s bf16 "
          f"peak (llama_flops_per_token), peak memory {peak_gb:.1f} GB; "
          f"launches {launches}, {adam_launches} fused updates; the update "
          f"{rec['update_ms']:.3f} ms fused, {rec['update_plain_ms']:.3f} "
          f"ms plain (profile_training.update_ms) on {card}", flush=True)
    return rec


def check_adam_routes(counters, launches, what):
    """Every optimizer update of a training path on the fused route: one
    fused launch a step, no tensor on the plain rule."""
    got = {r: int(counters.get(f"kernels.optimizer.adam_{r}", 0))
           for r in ("fused", "plain")}
    if got != {"fused": TRAIN_STEPS, "plain": 0} or launches != TRAIN_STEPS:
        fail(f"{what}: updates by route {got} ({launches} fused launches), "
             f"expected {TRAIN_STEPS} fused and no plain one")
    return got


def update_routes_agree(torch, mods, step, ids, labels):
    """The real gradients of one LLaMA step applied through the fused
    route (``apply_gradients_pytree``) and the plain rule
    (``profile_training.plain_update``) to two copies of the parameters
    and the optimizer state: bit-equal."""
    _, grads = step.loss_and_grads((ids, labels), labels)
    opt = step._opt
    copies = []
    for _ in range(2):
        copies.append(({n: p.detach().clone()
                        for n, p in step._params.items()},
                       {n: {k: v.clone() for k, v in st.items()}
                        for n, st in step.opt_state.items()}))
    (pa, sa), (pb, sb) = copies
    opt.apply_gradients_pytree(pa, grads, sa, opt.get_lr())
    mods.train.plain_update(opt, pb, grads, sb, opt.get_lr())
    torch.cuda.synchronize()
    eq = all(torch.equal(pa[n], pb[n]) for n in pa) and all(
        torch.equal(sa[n][k], sb[n][k]) for n in sa for k in sa[n])
    moved = sum(int((pa[n] != step._params[n]).sum()) for n in pa)
    rec = dict(bit_equal=eq, params=len(pa), elements_moved=moved)
    print(f"training update A/B: one step's real gradients through the "
          f"fused and the plain route, {len(pa)} tensors, {moved:,} "
          f"elements moved: {'bit-equal' if eq else 'DIFFERENT'}",
          flush=True)
    if not eq or not moved:
        fail(f"the fused and the plain update disagree on the LLaMA "
             f"step's gradients: {rec}")
    del copies, pa, pb, sa, sb, grads
    torch.cuda.empty_cache()
    return rec


# -- phase 3b: the fused Adam / AdamW update -------------------------------

#: sizes of phase 3b's odd cases: one element, vector tails, a parameter
#: of several chunks with a ragged last one
ADAM_ODD_SIZES = (1, 7, 8, 4099, 8192 + 13, 3 * 8192 + 5, (1 << 20) + 3)
#: phase 3b's cases: name -> (parameter set, moment dtype, amsgrad, decay,
#: coefficient, parameters 4 bytes off 16-byte alignment); the three
#: training sets are those of phases 9, 14 and 18 (AdamW, bf16 moments)
ADAM_CASES = {
    "llama_train": ("llama", "bfloat16", False, "decoupled", 0.01, False),
    "ernie_moe_train": ("ernie_moe", "bfloat16", False, "decoupled", 0.01,
                        False),
    "bert_train": ("bert", "bfloat16", False, "decoupled", 0.01, False),
    "odd_f32_decay": ("odd", "float32", False, "decoupled", 0.05, False),
    "odd_bf16_nodecay": ("odd", "bfloat16", False, "none", 0.0, False),
    "odd_f32_adam_l2": ("odd", "float32", False, "l2", 0.02, False),
    "odd_bf16_amsgrad": ("odd", "bfloat16", True, "decoupled", 0.05, False),
    "odd_f32_amsgrad_l2_unaligned": ("odd", "float32", True, "l2", 0.02,
                                     True),
}
ADAM_LR, ADAM_BETAS, ADAM_EPS = 3e-4, (0.9, 0.999), 1e-8


def adam_param_sets(torch, mods):
    """{set: [numel of each parameter]} of the three training
    configurations (the models built on the card once, their parameter
    sizes read, the models freed) and the odd sizes."""
    enc, P = mods.enc, mods.moe_profile
    builds = {
        "llama": lambda: mods.LlamaForCausalLM(
            mods.LlamaConfig(**mods.train.MODEL), seed=0),
        "ernie_moe": lambda: mods.ErnieMoEForCausalLM(
            mods.ErnieMoEConfig(**P.MOE_TRAIN_MODEL), seed=0),
        "bert": lambda: mods.BertForPretraining(
            mods.BertConfig(**enc.BERT_TRAIN["model"]),
            seed=enc.BERT_TRAIN["seed"])}
    sets = {"odd": list(ADAM_ODD_SIZES)}
    for name, build in builds.items():
        model = build()
        sets[name] = [p.numel() for p in model.parameters()
                      if p.requires_grad]
        del model
        torch.cuda.empty_cache()
    return sets


def _adam_tensors(torch, sizes, mdt, amsgrad, unaligned, seed):
    """Parameters, gradients and fresh AdamW state on the card: each
    parameter a flat f32 tensor (4 bytes into its buffer when
    ``unaligned``), every 7th gradient element 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    off = 1 if unaligned else 0
    mdt = getattr(torch, mdt)
    ps, gs, sts = [], [], []
    for n in sizes:
        ps.append(torch.randn(n + off, generator=g, device="cuda")[off:]
                  .mul_(0.02))
        gr = torch.randn(n, generator=g, device="cuda").mul_(1e-3)
        gr[::7] = 0.0
        gs.append(gr)
        st = {"moment1": torch.zeros(n, dtype=mdt, device="cuda"),
              "moment2": torch.zeros(n, dtype=mdt, device="cuda"),
              "beta1_pow": torch.full((), ADAM_BETAS[0], device="cuda"),
              "beta2_pow": torch.full((), ADAM_BETAS[1], device="cuda")}
        if amsgrad:
            st["moment2_max"] = torch.zeros(n, dtype=mdt, device="cuda")
        sts.append(st)
    return ps, gs, sts


def _clone_state(sts):
    return [{k: v.clone() for k, v in st.items()} for st in sts]


def _adam_equal(torch, ps, sts, ref_ps, ref_sts):
    """(bit-equal, max |fused - plain| over the parameters)."""
    eq = all(torch.equal(a, b) for a, b in zip(ps, ref_ps)) and all(
        torch.equal(s[k], r[k]) for s, r in zip(sts, ref_sts) for k in s)
    err = max(float((a - b).abs().max()) for a, b in zip(ps, ref_ps))
    return eq, err


def cold_ms(torch, fn, iters, flush):
    """Mean device ms of one fn() with the L2 flushed before each (events
    around each call alone)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def check_fused_adam(torch, mods, fad):
    """Phase 3b: the fused update (csrc/fused_adam.cu) against the plain
    per-tensor rule (``adam_update_plain``) on the card: three updates
    from a fresh state, every parameter and state slot bit-equal, in each
    case of ADAM_CASES; a chunk table without one chunk rejected at the
    LLaMA set; the three training sets timed on a cold L2 beside their
    bound, the plain loop and ``torch._fused_adamw_`` (another function:
    PyTorch's bias correction and epsilon, f32 moments; timed only)."""
    sets = adam_param_sets(torch, mods)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    lr_t = torch.tensor(ADAM_LR, dtype=torch.float32, device="cuda")
    b1, b2 = ADAM_BETAS
    cases = []
    for name, (pset, mdt, ams, decay, coeff, unal) in ADAM_CASES.items():
        sizes = sets[pset]
        ps, gs, sts = _adam_tensors(torch, sizes, mdt, ams, unal,
                                    len(cases))
        ref_ps, ref_sts = [p.clone() for p in ps], _clone_state(sts)

        def fused():
            fad.fused_adam_launch(ps, gs, sts, ADAM_LR, b1, b2, ADAM_EPS,
                                  amsgrad=ams, decay=decay, coeff=coeff)

        def plain(pp=ref_ps, ss=ref_sts):
            for p, g, st in zip(pp, gs, ss):
                fad.adam_update_plain(p, g, st, lr_t, b1, b2, ADAM_EPS,
                                      ams, decay, coeff)
        for _ in range(3):
            fused()
            plain()
        torch.cuda.synchronize()
        eq, err = _adam_equal(torch, ps, sts, ref_ps, ref_sts)
        n = sum(sizes)
        msize = 2 if mdt == "bfloat16" else 4
        nbytes = n * (4 + 4 + 4 + (3 if ams else 2) * 2 * msize)
        bound, bound_by = bound_ms(nbytes, 20 * n, "float32")
        case = dict(case=name, params=n, tensors=len(sizes),
                    moment_dtype=mdt, amsgrad=ams, decay=decay,
                    coeff=coeff, unaligned=unal, bit_equal=eq,
                    max_abs_err=err, tol="bit-equal (torch.equal)",
                    bound_ms=bound, bound_by=bound_by,
                    chunks=int(fad.adam_chunks(sizes, "cuda").shape[0]))
        if not eq:
            fail(f"fused Adam [{name}]: not bit-equal to the plain rule "
                 f"after 3 updates (max |diff| {err:.3e})")
        tables = fad.adam_tables(ps, gs, sts, ams)
        if name == "llama_train":
            # negative control: the table without its middle full chunk
            # must leave that chunk behind the plain update
            chunks = tables.chunks
            full = torch.nonzero(chunks[:, 2] == fad.ADAM_CHUNK).flatten()
            mid = int(full[full.numel() // 2])        # a full chunk
            bad = torch.cat([chunks[:mid], chunks[mid + 1:]])
            fad.fused_adam_launch(ps, gs, sts, ADAM_LR, b1, b2, ADAM_EPS,
                                  amsgrad=ams, decay=decay, coeff=coeff,
                                  tables=tables._replace(chunks=bad))
            plain()
            torch.cuda.synchronize()
            caught, _ = _adam_equal(torch, ps, sts, ref_ps, ref_sts)
            i, start, count = (int(v) for v in chunks[mid].tolist())
            rest = torch.equal(ps[i][:start], ref_ps[i][:start]) and \
                torch.equal(ps[i][start + count:],
                            ref_ps[i][start + count:])
            case["negative_control"] = dict(
                dropped_chunk=[i, start, count],
                rejected=not caught, rest_equal=rest)
            if caught or not rest:
                fail(f"fused Adam negative control not rejected: "
                     f"{case['negative_control']}")
        if pset != "odd":
            # ms: the launch on tables built once (the kernels' device
            # time); wrapper_ms: the wrapper, its checks and its table
            # upload included, as a step calls it
            case["ms"] = cold_ms(torch, lambda: fad.fused_adam_launch(
                ps, gs, sts, ADAM_LR, b1, b2, ADAM_EPS, amsgrad=ams,
                decay=decay, coeff=coeff, tables=tables), 5, flush)
            case["wrapper_ms"] = cold_ms(torch, fused, 5, flush)
            case["plain_ms"] = cold_ms(torch, plain, 2, flush)
            case["library_ms"], case["library_note"] = _fused_adamw_ms(
                torch, ps, gs, flush)
            case["ratio_to_bound"] = case["ms"] / bound
        print(f"fused Adam [{name}]: {n:,} params in {len(sizes)} tensors "
              f"({case['chunks']} chunks), {mdt} moments, amsgrad {ams}, "
              f"decay {decay} {coeff}: bit-equal to the plain rule after 3 "
              f"updates" + (f"; {case['ms']:.3f} ms (wrapper "
                            f"{case['wrapper_ms']:.3f}, bound "
                            f"{bound:.3f}, plain {case['plain_ms']:.3f}, "
                            f"torch._fused_adamw_ "
                            f"{case['library_ms']:.3f})" if "ms" in case
                            else ""), flush=True)
        cases.append(case)
        del ps, gs, sts, ref_ps, ref_sts
        torch.cuda.empty_cache()
    del flush
    return cases


def _fused_adamw_ms(torch, ps, gs, flush):
    """``torch._fused_adamw_`` over the same parameters and gradients with
    f32 moments (it takes no bf16 moments): the nearest library
    yardstick of bandwidth, not the same function."""
    m1 = [torch.zeros_like(p) for p in ps]
    m2 = [torch.zeros_like(p) for p in ps]
    steps = [torch.ones((), device="cuda") for _ in ps]

    def run():
        torch._fused_adamw_(ps, gs, m1, m2, [], steps, lr=ADAM_LR,
                            beta1=ADAM_BETAS[0], beta2=ADAM_BETAS[1],
                            weight_decay=0.01, eps=ADAM_EPS, amsgrad=False,
                            maximize=False)
    ms = cold_ms(torch, run, 5, flush)
    return ms, ("torch._fused_adamw_, f32 moments (28 bytes a parameter), "
                "PyTorch's bias correction: not the same function")


# -- phase 8b: the dynamic loss scale on the card ----------------------------

SCALER_STEPS, SCALER_INF_AT = 4, 1


def grad_scaler_check(torch, mods):
    """Phase 8b: phase 8's LLaMA (f32 weights, fused CE) for SCALER_STEPS
    eager steps under ``amp.GradScaler`` (the fp16 default scale 2^16)
    with Momentum, on the card and on the CPU from the same weights, one
    gradient element set to inf by hand at step SCALER_INF_AT: that step
    skipped and the scale halved on both, and every parameter on the card
    within the f32 gate of the CPU's."""
    import numpy as np
    cfg = mods.LlamaConfig(**XCHECK_MODEL)
    nets = {"cuda": mods.LlamaForCausalLM(cfg, seed=1)}
    nets["cpu"] = mods.LlamaForCausalLM(cfg, device="cpu")
    nets["cpu"].load_state_dict(
        {k: v.cpu() for k, v in nets["cuda"].state_dict().items()})
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64)
    labels = rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64)
    runs = {}
    for dev, net in nets.items():
        opt = mods.optimizer.Momentum(0.05, momentum=0.9,
                                      parameters=net.parameters())
        scaler = mods.GradScaler(init_loss_scaling=2.0 ** 16)
        x, y = (torch.from_numpy(a).to(dev) for a in (ids, labels))
        found, scales, losses = [], [], []
        for i in range(SCALER_STEPS):
            loss = net(x, y)
            losses.append(float(loss))
            scaler.scale(loss).backward()
            if i == SCALER_INF_AT:
                with torch.no_grad():
                    net.llama.embed_tokens.weight.grad[0, 3] = float("inf")
            scaler.step(opt)
            found.append(scaler._found_inf)
            scaler.update()
            scales.append(scaler._scale)
            opt.clear_grad()
        runs[dev] = dict(found=found, scales=scales, losses=losses,
                         params=[p.detach().cpu() for p in
                                 net.parameters()])
    want_found = [i == SCALER_INF_AT for i in range(SCALER_STEPS)]
    ratio = max(closeness(a, b)["ratio"] for a, b in
                zip(runs["cuda"]["params"], runs["cpu"]["params"]))
    rec = dict(found_inf=runs["cuda"]["found"],
               scales=runs["cuda"]["scales"],
               losses_cuda=runs["cuda"]["losses"],
               losses_cpu=runs["cpu"]["losses"], params_ratio=ratio,
               gate="f32: |cuda - cpu| <= 1e-4 max(1, max |cpu|)")
    print(f"GradScaler: skipped {runs['cuda']['found']} (cpu "
          f"{runs['cpu']['found']}), scale {runs['cuda']['scales']}, "
          f"parameters card vs CPU at {ratio:.3f} of the f32 gate",
          flush=True)
    if runs["cuda"]["found"] != want_found or \
            runs["cpu"]["found"] != want_found or \
            runs["cuda"]["scales"] != runs["cpu"]["scales"] or \
            runs["cuda"]["scales"][SCALER_INF_AT] != 2.0 ** 15 or \
            ratio > 1.0:
        fail(f"GradScaler on the card: {rec}")
    del nets, runs
    torch.cuda.empty_cache()
    return rec


# -- phase 9b: the LLaMA pretraining recipe --------------------------------

RECIPE_STEPS, RECIPE_WARMUP, RECIPE_T_MAX, RECIPE_LR = 4, 2, 100, 3e-4
#: the recompute settings of phase 9b; "none" is the baseline of memory
RECIPE_GRANULARITIES = ("none", "full", "selective", "selective_qkv")
#: the tags each granularity saves (one run a layer and step) and the
#: ones it recomputes (two); "selective" keeps attn_core and ffn_mid as
#: the ends of its checkpointed regions, untagged
RECIPE_TAGS = {"selective_qkv": (("attn_q", "attn_k", "attn_v"), ())}


def _recipe_sched(mods):
    lr = mods.optimizer.lr
    return lr.LinearWarmup(lr.CosineAnnealingDecay(RECIPE_LR, RECIPE_T_MAX),
                           RECIPE_WARMUP, 0.0, RECIPE_LR)


def pretrain_recipe_path(torch, mods, fa, fad, monitor, card):
    """Phase 9b: the LLaMA pretraining recipe at the bench shape
    (profile_training's MODEL, BATCH and SEQ; TrainStep(amp_dtype=
    "bfloat16"); AdamW on LinearWarmup(CosineAnnealingDecay), norms named
    out of decay by apply_decay_param_fun, which the train step does not
    read, as in the JAX package) for RECIPE_STEPS steps under each of
    RECIPE_GRANULARITIES, counts set to 0 just before each run and read
    just after, then one step with a document mask under "selective"."""
    batch, seq = mods.train.BATCH, mods.train.SEQ
    ids, labels = (torch.randint(
        0, mods.train.MODEL["vocab_size"], (batch, seq),
        generator=torch.Generator(device="cuda").manual_seed(4),
        device="cuda") for _ in range(2))
    ref = _recipe_sched(mods)
    want_lrs = []
    for _ in range(RECIPE_STEPS):
        want_lrs.append(ref())
        ref.step()
    runs = {}
    for gran in RECIPE_GRANULARITIES:
        cfg = mods.LlamaConfig(**mods.train.MODEL, recompute=gran != "none",
                               recompute_granularity="full" if gran ==
                               "none" else gran)
        model = mods.LlamaForCausalLM(cfg, seed=0)
        sched = _recipe_sched(mods)
        opt = mods.AdamW(sched, parameters=model.named_parameters(),
                         apply_decay_param_fun=lambda n: "norm" not in n)
        step = mods.TrainStep(model, lambda out, lab: out, opt,
                              amp_dtype="bfloat16")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_fwd.launches = 0
        fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
        fad.fused_adam_launch.launches = 0
        monitor.reset()
        lrs, losses, times = [], [], []
        for _ in range(RECIPE_STEPS):
            lrs.append(opt.get_lr())
            t0 = time.perf_counter()
            loss = step((ids, labels), labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            sched.step()
        launches = {"flash_fwd": fa.flash_fwd.launches,
                    "flash_bwd_dq": fa.flash_bwd.launches_dq,
                    "flash_bwd_dkv": fa.flash_bwd.launches_dkv,
                    "fused_adam": fad.fused_adam_launch.launches}
        counters = {k: v for k, v in monitor.snapshot().items()
                    if k.startswith(("kernels.", "recompute."))}
        # -- end of the counted run --
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        layers, n = cfg.num_hidden_layers, RECIPE_STEPS
        rec = dict(losses=losses, lrs=lrs, step_ms=sorted(times[1:])[
            len(times[1:]) // 2] * 1e3, peak_mem_gb=peak_gb,
            launches=launches, counters=counters)
        what = f"recipe [{gran}]"
        if not all(map(math.isfinite, losses)) or \
                not losses[-1] < losses[0]:
            fail(f"{what}: losses not finite and falling: {losses}")
        if lrs != want_lrs:
            fail(f"{what}: lr sequence {lrs}, the scheduler's {want_lrs}")
        fwd_want = (1 if gran == "none" else 2) * layers * n
        want = {"flash_fwd": fwd_want, "flash_bwd_dq": layers * n,
                "flash_bwd_dkv": layers * n, "fused_adam": n}
        if launches != want:
            fail(f"{what}: launches {launches}, expected {want}")
        wg = {k: int(counters.get(f"kernels.flash.{k}_cuda_tc_wgmma", 0))
              for k in ("fwd", "dq", "dkv")}
        if wg != {"fwd": fwd_want, "dq": layers * n, "dkv": layers * n}:
            fail(f"{what}: flash launches on their wgmma kernels {wg}")
        if counters.get("kernels.optimizer.adam_fused") != n or \
                counters.get("kernels.optimizer.adam_plain", 0):
            fail(f"{what}: update routes {counters}")
        saved, rerun = RECIPE_TAGS.get(gran, ((), ()))
        for tag in ("attn_core", "ffn_mid", "attn_q", "attn_k", "attn_v"):
            got = counters.get(f"recompute.checkpoint_name.{tag}", 0)
            exp = layers * n * (1 if tag in saved else 2 if tag in rerun
                                else 0)
            if got != exp:
                fail(f"{what}: tag {tag} ran {got} times, expected {exp}")
        if gran == "selective":
            rec["flashmask_step"] = _recipe_flashmask_step(
                torch, mods, fa, fad, monitor, step, ids, labels, layers)
        print(f"recipe [{gran}]: losses {[round(x, 4) for x in losses]}, "
              f"lrs {lrs}, median step {rec['step_ms']:.1f} ms, peak "
              f"memory {peak_gb:.2f} GB, launches {launches} on {card}",
              flush=True)
        runs[gran] = rec
        del model, opt, step, sched
        torch.cuda.empty_cache()
    peaks = {g: runs[g]["peak_mem_gb"] for g in RECIPE_GRANULARITIES}
    if not (peaks["full"] < peaks["selective"] <= peaks["selective_qkv"]
            < peaks["none"]):
        fail(f"recipe peak memory out of order (full < selective <= "
             f"selective_qkv < none): {peaks}")
    tag_ms = _tag_ms(torch, mods)
    print(f"recipe peak memory GB {peaks}; checkpoint_name copies "
          f"{tag_ms} ms", flush=True)
    return dict(runs=runs, peak_mem_gb=peaks, want_lrs=want_lrs,
                checkpoint_name_ms=tag_ms)


def _recipe_flashmask_step(torch, mods, fa, fad, monitor, step, ids,
                           labels, layers):
    """One step of the selective run with a 3-document mask, counted."""
    se = mods.doc_mask([384, 256, mods.train.SEQ - 640], device="cuda")
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
    fad.fused_adam_launch.launches = 0
    monitor.reset()
    loss = float(step((ids, labels, se), labels))
    torch.cuda.synchronize()
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_bwd_dq": fa.flash_bwd.launches_dq,
                "flash_bwd_dkv": fa.flash_bwd.launches_dkv,
                "fused_adam": fad.fused_adam_launch.launches}
    tags = {k: v for k, v in monitor.snapshot().items()
            if k.startswith("recompute.") and v}
    want = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers, "fused_adam": 1}
    want_tags = {}        # "selective" tags nothing
    if not math.isfinite(loss) or launches != want or tags != want_tags:
        fail(f"recipe flashmask step: loss {loss}, launches {launches} "
             f"(expected {want}), tags {tags} (expected {want_tags})")
    return dict(loss=loss, launches=launches, tags=tags)


def _tag_ms(torch, mods):
    """Device ms of one checkpoint_name copy at the bench shape's tagged
    activations under "selective_qkv" (bf16 under AMP): q [B, S, hidden],
    k and v [B, S, kv heads x head dim]."""
    from paddle_tpu_torch.distributed.fleet import checkpoint_name
    m = mods.train.MODEL
    out = {}
    kv = m["num_key_value_heads"] * m["hidden_size"] // \
        m["num_attention_heads"]
    for tag, width in (("attn_q", m["hidden_size"]), ("attn_k", kv)):
        x = torch.randn(mods.train.BATCH, mods.train.SEQ, width,
                        device="cuda", dtype=torch.bfloat16)
        out[tag] = cuda_ms(lambda x=x: checkpoint_name(x, "timing"))
        del x
    return out


# -- phases 11-14: the MoE path --------------------------------------------

#: the small on-card MoE cross-check model (one MoE block)
MOE_XCHECK_MODEL = dict(vocab_size=32000, hidden_size=256,
                        intermediate_size=704, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=4,
                        num_experts=4, moe_every=2, max_position_embeddings=128)
#: the smallest gap allowed between consecutive top-3 router probabilities
#: of the cross-check's tokens: card and CPU logits differ by f32 rounding,
#: so a closer tie could route differently, and a routing flip is then a
#: fault, not noise
MOE_MARGIN_MIN = 1e-5
#: greedy tokens of the 8-slot engine equal to a 1-slot engine's (a
#: request's tokens do not depend on its batch-mates)
MOE_AGREE = 0.97
#: the grouped-FFN kernels' end-to-end gate against their plain version,
#: in multiples of the element-wise allowance, by operand dtype. f32 is
#: held to the allowance itself. A bf16 output also carries the
#: intermediates' rounding flips (an ha or dz element whose f32 value
#: sits on a rounding midpoint rounds to the other neighbour), amplified
#: by the next product; the stage gate holds each rounding to one
#: allowance, and this bounds their sum: the sound kernels read up to
#: 2.94 (dx), a dw1 short of one row tile 424 (H100 runs of this script)
MOE_E2E_RATIO = {"float32": 1.0, "bfloat16": 8.0}
#: depth of a stage of the tc route's mainloop (csrc/grouped_gemm_tc.cuh
#: kBK): the K tile the negative controls leave out
MOE_K_TILE = 64
#: the per-route launch counters of the grouped-FFN forward, dx and dw
#: kernels
MOE_ROUTES = ("fwd_cuda_tc", "fwd_cuda_rows", "fwd_cuda_simt", "dx_cuda_tc",
              "dx_cuda_simt", "dw_cuda_tc", "dw_cuda_simt")
#: the forward's route at each case of phase 11 (the rest: "simt")
MOE_FWD_ROUTE = {"train_bf16": "tc", "decode_f32": "rows"}


def moe_routes(counters):
    """The grouped-FFN forward, dx and dw launches by route in a counter
    snapshot."""
    return {n: int(counters.get(f"kernels.moe.grouped_ffn_{n}", 0))
            for n in MOE_ROUTES}


def check_moe_routes(counters, want, what):
    """Every grouped-FFN forward, dx and dw launch of a path on the routes
    ``want`` names (route counter -> launches), none on any other."""
    got = moe_routes(counters)
    if got != {n: want.get(n, 0) for n in MOE_ROUTES}:
        fail(f"{what}: grouped-FFN launches by route {got}, expected {want} "
             f"and none elsewhere")
    return got


def _moe_counts(torch, moe_gate, n_tokens, h, e, cap, seed):
    """Per-expert counts of a real top-2 routing of n_tokens random tokens
    at capacity cap (router weights normal, std 0.02)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randn(n_tokens, h, generator=g, device="cuda")
    wg = torch.randn(h, e, generator=g, device="cuda") * 0.02
    idx, _, keep, _, _ = moe_gate.topk_gating_sparse(tok @ wg, 2, cap,
                                                     train=False)
    owner = torch.where(keep, idx.long(), e)
    return torch.zeros(e + 1, dtype=torch.int32, device="cuda").index_add(
        0, owner.reshape(-1), keep.reshape(-1).to(torch.int32))[:e]


def _moe_negative_control(torch, moe, x, cnt, inter, dw1, ref_dw1,
                          plain_dw1, e2e_limit):
    """dw1 short of one expert's last live row tile (the tile loop one
    short): subtract that tile's share, x^T dz over its rows (the plain
    intermediate), and show that both gates reject it: the stage gate
    (against the plain formula on the kernel's intermediates) and the
    end-to-end gate (against the plain version, at ``e2e_limit``)."""
    e0 = int(torch.argmax(cnt))
    c = int(cnt[e0])
    lo = (c - 1) // moe.ROW_TILE * moe.ROW_TILE
    short = dw1.float()
    short[e0] -= x[e0, lo:c].float().T @ inter["dz"][e0, lo:c]
    short = short.to(dw1.dtype)
    stage, e2e = closeness(short, ref_dw1), closeness(short, plain_dw1)
    print(f"  negative control (dw1 without expert {e0}'s rows {lo}-{c - 1})"
          f": ratio to tol {stage['ratio']:.3g} (rejected: > 1), end to end "
          f"{e2e['ratio']:.3g} (rejected: > {e2e_limit})", flush=True)
    if not (stage["ratio"] > 1.0 and e2e["ratio"] > e2e_limit):
        fail(f"the checks do not reject dw1 short of a tile: {stage}, {e2e}")
    return dict(expert=e0, rows=[lo, c], ratio=stage["ratio"],
                ratio_vs_plain=e2e["ratio"], max_abs_err=stage["max_abs_err"])


def _moe_k_tile_controls(torch, keep, ops, ha_k, dz_k, got, ref, plain,
                         e2e_limit):
    """out short of the down product's last MOE_K_TILE-deep K tile, and dx
    short of the last K tile of dff (each mainloop one stage short):
    subtract that tile's share (the plain product of the kernel's own ha,
    or dz, over the tile's dff columns) on the live rows, and show that
    both gates reject each: the stage gate and the end-to-end one (at
    ``e2e_limit``)."""
    _, w1, _, w2, _, ws = ops
    dff = w1.shape[2]
    lo = (dff - 1) // MOE_K_TILE * MOE_K_TILE
    shares = {"out": torch.bmm(ha_k[..., lo:], w2[:, lo:].float()) * ws,
              "dx": torch.bmm(dz_k[..., lo:],
                              w1[..., lo:].float().transpose(1, 2))}
    res = {}
    for n, share in shares.items():
        short = (got[n].float() - torch.where(keep, share, 0.0)).to(
            got[n].dtype)
        stage, e2e = closeness(short, ref[n]), closeness(short, plain[n])
        print(f"  negative control ({n} without dff columns {lo}-{dff - 1})"
              f": ratio to tol {stage['ratio']:.3g} (rejected: > 1), end to "
              f"end {e2e['ratio']:.3g} (rejected: > {e2e_limit})",
              flush=True)
        if not (stage["ratio"] > 1.0 and e2e["ratio"] > e2e_limit):
            fail(f"the checks do not reject {n} short of a K tile: {stage}, "
                 f"{e2e}")
        res[n] = dict(dff_columns=[lo, dff], ratio=stage["ratio"],
                      ratio_vs_plain=e2e["ratio"],
                      max_abs_err=stage["max_abs_err"])
    return res


def _moe_rows_split_control(torch, moe, ops, cnt, act, ref_out, plain_out,
                            e2e_limit):
    """out of the rows route without the down pass's last K split: after
    a launch, the kernel's own partials (its scratch holds the down
    pass's [S, E, C, h] sums of the live rows) reduced as its epilogue
    does, in split order with b2 and ws, once over every split (which
    must give the kernel's out within the gate, so the reduction is the
    kernel's) and once without the last split; both gates, the stage
    one and the end-to-end one (at ``e2e_limit``), must reject the
    second."""
    x, w1, _, _, b2, ws = ops
    E, C, h = x.shape
    dff = w1.shape[2]
    cops = moe._check_cuda("control", *ops, cnt)
    part = moe.grouped_ffn_rows_scratch(E, C, h, dff, x.device)
    ha = torch.empty(E, C, dff, device=x.device)
    out = torch.empty_like(x)
    if moe._fwd_launch(cops, ha, out, act, part) != "rows":
        fail("the rows control's launch took another route")
    torch.cuda.synchronize()
    S = -(-dff // moe.ROWS_K_SPLIT)
    parts = part[:S * E * C * h].view(S, E, C, h)
    keep = moe._row_mask(cnt, C, x.device)

    def reduce(n):
        total = parts[0]
        for k in range(1, n):
            total = total + parts[k]
        return torch.where(keep, (total + b2) * ws, 0.0)
    full = closeness(reduce(S), out)
    short = reduce(S - 1)
    stage, e2e = closeness(short, ref_out), closeness(short, plain_out)
    print(f"  negative control (rows route's out without K split {S - 1} of "
          f"{S}): ratio to tol {stage['ratio']:.3g} (rejected: > 1), end to "
          f"end {e2e['ratio']:.3g} (rejected: > {e2e_limit}); every split: "
          f"{full['ratio']:.3g} against the kernel", flush=True)
    if not (full["ratio"] <= 1.0 and stage["ratio"] > 1.0
            and e2e["ratio"] > e2e_limit):
        fail(f"the checks do not reject the rows route short of a K split: "
             f"{full}, {stage}, {e2e}")
    return dict(splits=S, dropped=S - 1, ratio=stage["ratio"],
                ratio_vs_plain=e2e["ratio"], max_abs_err=stage["max_abs_err"],
                ratio_full_reduce=full["ratio"])


def _moe_rounding_witness(torch, dt, dz_k, inter):
    """Where the dx kernel's rounded dz differs from the plain one: how
    many elements, how many of them by exactly one ulp of ``dt`` (same
    sign, neighbouring bit patterns), and how many of those have the
    plain f32 value within 0.05 ulp of the midpoint of the two neighbours
    (``at_midpoint``; ``median_offset_ulp`` over the one-ulp elements):
    there the two f32 values, which differ only by the order of
    summation, sit on either side of a rounding midpoint. Every other
    differing element is reported by its largest |dz| over the rms of the
    live dz (``others_max_abs_over_rms``) and its largest distance in
    ulps (``max_ulps``, same-sign pairs): values near 0, where the f32
    sums' own error exceeds half an ulp."""
    differ = dz_k != inter["dz"]
    a, b = dz_k[differ].to(dt), inter["dz"][differ].to(dt)
    v = inter["dz32"][differ]
    same = torch.signbit(a) == torch.signbit(b)
    ulps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()
    one = (ulps == 1) & same
    a, b = a.float(), b.float()
    off = torch.where(one, (v - (a + b) / 2).abs() / (a - b).abs(), 1.0)
    mid = off < 0.05
    live = inter["dz32"][inter["dz32"] != 0]
    rms = float(live.square().mean().sqrt()) if live.numel() else 0.0
    others = v[~mid].abs()
    return dict(elements=dz_k.numel(), differ=int(differ.sum()),
                one_ulp=int(one.sum()), at_midpoint=int(mid.sum()),
                median_offset_ulp=float(off[one].median()) if one.any()
                else None,
                others_max_abs_over_rms=float(others.max()) / rms
                if others.numel() else None,
                max_ulps=int(ulps[same].max()) if same.any() else None)


def _sass_counts(build, lib, pattern):
    """{kernel<type>: HGMMA and UTMALDG counts} of the functions of
    library ``lib`` whose name (mangled or not) matches ``pattern``, named
    by its groups joined, from ``cuobjdump -sass``."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build()[lib])],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass of {lib} failed: {sass.stderr[-2000:]}")
    counts = {}
    for fn in sass.stdout.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        m = re.search(pattern, name)
        if m:
            ty = "fp16" if "__half" in name else "bf16"
            short = "_d".join(x for x in m.groups() if x)
            counts[f"{short}<{ty}>"] = dict(
                HGMMA=fn.count("HGMMA"), UTMALDG=fn.count("UTMALDG"))
    return counts


def check_moe_tc_sass(build):
    """The grouped-FFN tc kernels' machine code, as built: each kernel of
    the tc route (``*_tcI*``: the forward's two passes, dx's two, the dw
    products) holds wgmma (HGMMA) and TMA load (UTMALDG) instructions,
    counted in ``cuobjdump -sass`` of its library."""
    counts = {}
    for lib in ("grouped_ffn_fwd", "grouped_ffn_bwd"):
        counts.update(_sass_counts(build, lib,
                                   r"grouped_ffn_([a-z]+_[a-z]+_tc)(?:I|<)"))
    print(f"  tc kernels' SASS (wgmma, TMA loads): {counts}", flush=True)
    if len(counts) != 10 or not all(c["HGMMA"] and c["UTMALDG"]
                                    for c in counts.values()):
        fail(f"the grouped-FFN tc kernels lack wgmma or TMA: {counts}")
    return counts


#: the flash libraries' wgmma kernels (name pattern, its first template
#: int being the tile head dim), each at tile head dims 64 and 128: the
#: forward at bf16 and fp16, dQ and dK/dV at bf16 (4 instantiations each)
FLASH_WGMMA_SASS = {
    "flash_fwd": r"(flash_fwd_wgmma_kernel).*?(?:Li(64|128)E|, (64|128),)",
    "flash_bwd": r"flash_bwd_(dq|dkv)_wgmma_kernel.*?"
                 r"(?:Li(64|128)E|, (64|128),)"}


def check_flash_wgmma_sass(build, lib):
    """The tc route's wgmma kernels of flash library ``lib`` as built
    (``FLASH_WGMMA_SASS``): each instantiation holds wgmma (HGMMA) and TMA
    load (UTMALDG) instructions (``cuobjdump -sass`` of the library)."""
    counts = _sass_counts(build, lib, FLASH_WGMMA_SASS[lib])
    print(f"  {lib} wgmma kernels' SASS (wgmma, TMA loads): {counts}",
          flush=True)
    if len(counts) != 4 or not all(c["HGMMA"] and c["UTMALDG"]
                                   for c in counts.values()):
        fail(f"the {lib} wgmma kernels lack wgmma or TMA: {counts}")
    return counts


def check_moe_kernels(torch, moe, moe_gate, monitor):
    """Phase 11: the grouped-FFN forward, dx and dw kernels against their
    plain versions at the training shape (routed counts of the bench's
    16,384 tokens), a decode tick (8 lanes, one expert empty), a prefill
    chunk (cap 128, routed), a ragged f32 case and a bf16 case the tc
    route refuses; the forward and dx on the route ``grouped_ffn_route``
    names (tc at the training shape only); each timed alone beside the
    plain version, its bound over the LIVE rows (failing a time below
    it), its TFLOP/s, and the timed-only pair of torch.bmm calls over the
    padded buffer.

    Two gates. Stage by stage, every compared value is f32 math on the
    same rounded inputs, rounded once (PR 2's element-wise rule applies):
    the dx kernel's rounded intermediates ha and dz of the live rows (its
    scratch) against the plain ones, and each output against the plain
    formula on the kernel's own intermediates (the forward's ha is the dx
    kernel's, bit for bit: same tiles, same order); db1 and db2, summed
    from f32, against the plain version directly. End to end, each output
    against the plain version within MOE_E2E_RATIO times its allowance
    (``ratio_vs_plain``): a bf16 output also carries the intermediates'
    rounding flips, amplified by the next product. For bf16, where the
    kernel's dz differs from the plain one is recorded
    (``_moe_rounding_witness``)."""
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    specs = [  # name, E, cap, h, dff, dtype, act, counts (or routed tokens)
        ("train_bf16", 8, 8192, 1024, 2816, bf16, "gelu", 16384),
        ("decode_f32", 8, 8, 1024, 2816, f32, "gelu",
         [2, 3, 0, 1, 4, 2, 2, 2]),
        ("prefill_f32", 8, 128, 1024, 2816, f32, "gelu", 128),
        ("ragged_f32", 3, 37, 96, 200, f32, "relu", [0, 37, 13]),
        ("refused_bf16", 4, 256, 1020, 2812, bf16, "gelu",
         [256, 100, 0, 37]),
    ]
    names = ("out", "dx", "dw1", "db1", "dw2", "db2", "dws")
    cases = []
    for i, (name, E, cap, h, dff, dt, act, cspec) in enumerate(specs):
        cnt = (_moe_counts(torch, moe_gate, cspec, h, E, cap, 10 + i)
               if isinstance(cspec, int) else
               torch.tensor(cspec, dtype=torch.int32, device=dev))
        g = torch.Generator(device=dev).manual_seed(20 + i)

        def r(*shape, sc=1.0):
            return torch.randn(*shape, generator=g, device=dev) * sc
        ops = (r(E, cap, h, sc=0.5).to(dt), r(E, h, dff, sc=h ** -0.5).to(dt),
               r(E, 1, dff, sc=0.1), r(E, dff, h, sc=dff ** -0.5).to(dt),
               r(E, 1, h, sc=0.1), torch.rand(E, cap, 1, generator=g,
                                              device=dev))
        gg = r(E, cap, h).to(dt)
        route = moe.grouped_ffn_route(dt, h, dff)
        fwd_route = moe.grouped_ffn_route(dt, h, dff, cap)
        if route != ("tc" if name == "train_bf16" else "simt") or \
                fwd_route != MOE_FWD_ROUTE.get(name, "simt"):
            fail(f"grouped_ffn[{name}]: routes {fwd_route} (forward), "
                 f"{route} (dx, dw)")
        before = moe_routes(monitor.snapshot())
        got = dict(zip(names, (moe.grouped_ffn_fwd(*ops, cnt, act),)
                       + moe.grouped_ffn_bwd(*ops, cnt, gg, act)))
        after = moe_routes(monitor.snapshot())
        want = {n: before[n] + (n in (f"fwd_cuda_{fwd_route}",
                                      f"dx_cuda_{route}",
                                      f"dw_cuda_{route}"))
                for n in MOE_ROUTES}
        if after != want:
            fail(f"grouped_ffn[{name}]: launches by route {after}, "
                 f"expected {want}")
        # the dx kernel's rounded intermediates (scratch, live rows)
        cops = moe._check_cuda("check", *ops, cnt, gg)
        s = moe._bwd_scratch(ops[0], dff)
        dx_b, dw1_b, dw2_b = (torch.empty_like(t) for t in
                              (ops[0], ops[1], ops[3]))
        dws_b = torch.empty(E, cap, 1, device=dev)
        db2_b = torch.empty(E, 1, h, device=dev)
        db1_b = torch.empty(E, 1, dff, device=dev)
        moe._bwd_dx_launch(cops, s, dx_b, dws_b, db2_b, act)
        torch.cuda.synchronize()
        keep = moe._row_mask(cnt, cap, dev)
        ha_k = torch.where(keep, s["ha"].float(), 0.0)
        dz_k = torch.where(keep, s["dz"].float(), 0.0)
        dname = str(dt).replace("torch.", "")
        e2e_limit = MOE_E2E_RATIO[dname]
        inter = moe.grouped_ffn_bwd_intermediates(*ops, cnt, gg, act)
        plain = dict(zip(names, (moe.grouped_ffn_plain(*ops, cnt, act),)
                         + moe.grouped_ffn_bwd_outputs(*ops, cnt, gg,
                                                       **inter)))
        e2e = {n: closeness(got[n], plain[n]) for n in names}
        res = {n: closeness(a.to(dt), inter[n].to(dt))
               for n, a in (("ha", ha_k), ("dz", dz_k))}
        witness = (None if dt == f32 else
                   _moe_rounding_witness(torch, dt, dz_k, inter))
        ref = dict(zip(names, (moe.grouped_ffn_down_plain(
            ha_k, ops[3], ops[4], ops[5], cnt, dt),)
            + moe.grouped_ffn_bwd_outputs(*ops, cnt, gg, **dict(
                inter, ha=ha_k, dz=dz_k))))
        res.update({n: closeness(got[n], ref[n]) for n in names})
        sharp = k_tiles = rows_split = None
        if fwd_route == "rows":
            rows_split = _moe_rows_split_control(torch, moe, ops, cnt, act,
                                                 ref["out"], plain["out"],
                                                 e2e_limit)
        if name == "train_bf16":
            sharp = _moe_negative_control(torch, moe, ops[0], cnt, inter,
                                          got["dw1"], ref["dw1"],
                                          plain["dw1"], e2e_limit)
            k_tiles = _moe_k_tile_controls(torch, keep, ops, ha_k, dz_k, got,
                                           ref, plain, e2e_limit)
        del got, ref, plain, inter, ha_k, dz_k
        bad = {n: v for n, v in res.items() if not v["ratio"] <= 1.0}
        bad.update({f"{n} end to end": v for n, v in e2e.items()
                    if not v["ratio"] <= e2e_limit})
        if witness is not None:
            print(f"  grouped_ffn[{name}] dz, kernel vs plain: {witness}",
                  flush=True)
        if bad:
            fail(f"grouped_ffn[{name}] disagrees with its plain version: "
                 f"{bad}")

        # timing: each kernel alone (raw launches for dx and dw), the
        # plain versions, and the bmm pairs over the padded buffer. Bounds
        # count the port's own entries over the live rows: the forward 2
        # products, dx 4 (z, dh, dz w1^T, ha w2) writing ha and dz of the
        # live rows, dw 2 (dw1, dw2) reading them back and writing dw1
        # and dw2 of every expert.
        hbuf = r(E, cap, dff, sc=0.5).to(dt)
        x, w1, _, w2, _, _ = ops
        live = int(cnt.sum())
        item = x.element_size()
        wbytes = int((cnt > 0).sum()) * 2 * h * dff * item
        rows = live * h * item
        scratch = 2 * live * dff * item
        rec = dict(case=name, experts=E, cap=cap, hidden=h, dff=dff,
                   dtype=dname, activation=act, counts=cnt.tolist(),
                   live_rows=live,
                   max_abs_err={n: v["max_abs_err"] for n, v in res.items()},
                   tol={n: v["tol"] for n, v in res.items()},
                   ratio={n: v["ratio"] for n, v in res.items()},
                   ratio_vs_plain={n: v["ratio"] for n, v in e2e.items()},
                   e2e_limit=e2e_limit, dz_rounding=witness,
                   negative_control=sharp, k_tile_controls=k_tiles,
                   rows_split_control=rows_split,
                   route=dict(fwd=fwd_route, dx=route, dw=route))
        plain_bwd = cuda_ms(lambda: moe.grouped_ffn_bwd_plain(
            *ops, cnt, gg, act), iters=3)
        parts = {
            "fwd": (lambda: moe.grouped_ffn_fwd(*ops, cnt, act),
                    cuda_ms(lambda: moe.grouped_ffn_plain(*ops, cnt, act),
                            iters=3),
                    (lambda: (torch.bmm(x, w1), torch.bmm(hbuf, w2))),
                    wbytes + 2 * rows + 4 * live, 4 * live * h * dff),
            "dx": (lambda: moe._bwd_dx_launch(cops, s, dx_b, dws_b, db2_b,
                                              act), plain_bwd,
                   (lambda: (torch.bmm(gg, w2.transpose(1, 2)),
                             torch.bmm(hbuf, w1.transpose(1, 2)))),
                   wbytes + 3 * rows + 8 * live + scratch,
                   8 * live * h * dff),
            "dw": (lambda: moe._bwd_dw_launch(cops, s, dw1_b, db1_b, dw2_b),
                   plain_bwd,
                   (lambda: (torch.bmm(x.transpose(1, 2), hbuf),
                             torch.bmm(hbuf.transpose(1, 2), gg))),
                   2 * rows + 4 * live + scratch + 2 * E * h * dff * item,
                   4 * live * h * dff),
        }
        for part, (fn, plain_ms, pair, nbytes, flops) in parts.items():
            bms, by = bound_ms(nbytes, flops, dname)
            ms = cuda_ms(fn, iters=10)
            rec[part] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, library_ms=None,
                             library_pair_ms=cuda_ms(pair, iters=10),
                             tflops=flops / ms / 1e9)
            if part == "fwd" and dt == f32:
                # f32 forwards last about as long as the host's launch
                # work: ms from a CUDA graph of raw launches, the
                # wrapper's events time beside
                ha_b = torch.empty(E, cap, dff, device=dev)
                out_b = torch.empty_like(ops[0])
                part_b = (moe.grouped_ffn_rows_scratch(E, cap, h, dff, dev)
                          if fwd_route == "rows" else None)
                fops = cops[:7]
                rec[part].update(wrapper_ms=ms, ms=graph_ms(
                    torch, lambda: moe._fwd_launch(fops, ha_b, out_b, act,
                                                   part_b)))
                rec[part]["tflops"] = flops / rec[part]["ms"] / 1e9
        print(f"  grouped_ffn[{name}] ({fwd_route}, {route}): ratio to tol "
              f"{ {n: round(v, 3) for n, v in rec['ratio'].items()} }, end "
              f"to end {max(rec['ratio_vs_plain'].values()):.3g} (limit "
              f"{e2e_limit}); " + "; ".join(
                  f"{p} {rec[p]['ms']:.4f} ms = {rec[p]['tflops']:.1f} "
                  f"TFLOP/s (bound {rec[p]['bound_ms']:.4f} "
                  f"{rec[p]['bound_by']}, plain {rec[p]['plain_ms']:.4f}, "
                  f"bmm pair {rec[p]['library_pair_ms']:.4f})"
                  for p in ("fwd", "dx", "dw")), flush=True)
        low = {p: (rec[p]["ms"], rec[p]["bound_ms"])
               for p in ("fwd", "dx", "dw")
               if rec[p]["ms"] < rec[p]["bound_ms"]}
        if low:
            fail(f"grouped_ffn[{name}]: times below their bounds (ms, "
                 f"bound): {low}")
        cases.append(rec)
        del ops, gg, cops, s, dx_b, dw1_b, dw2_b, hbuf
        torch.cuda.empty_cache()
    return cases


def moe_serving_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 12: bench_ernie_moe_serving's configuration, counts set to 0
    just before it and read just after; then two requests again on a
    1-slot engine."""
    P = mods.moe_profile
    cfg = mods.ErnieMoEConfig(**P.MOE_SERVE_MODEL)
    model = mods.ErnieMoEForCausalLM(cfg, seed=0)
    model.eval()
    reqs = [(p, mods.SamplingParams(max_new_tokens=P.MOE_NEW_TOKENS))
            for p in P.moe_prompts(cfg.vocab_size)]
    torch.cuda.synchronize()
    reset_counts()
    eng = mods.Engine(model, **P.MOE_ENGINE)
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith(("kernels.", "serving."))}
    # -- end of the counted MoE serving path --
    bad = [o for o in outs if not o.ok or len(o.token_ids) !=
           P.MOE_NEW_TOKENS]
    if len(outs) != P.MOE_REQUESTS or bad:
        fail(f"MoE serving: {len(outs)} outputs, failed/short: {bad[:2]}")
    if eng.leaked_pages():
        fail(f"MoE serving leaked {eng.leaked_pages()} pages")
    ticks = eng.decode_ticks
    prefills = int(counters.get("serving.prefill_slices", 0))
    n_moe = len(model.moe_layers())
    want = (prefills + ticks) * n_moe
    if launches["grouped_ffn_fwd"] != want or \
            counters.get("kernels.moe.grouped_ffn_fwd_cuda") != want:
        fail(f"grouped-FFN forward launches {launches['grouped_ffn_fwd']} "
             f"!= ({prefills} prefills + {ticks} ticks) x {n_moe} MoE layers")
    if launches["paged_decode"] != ticks * cfg.num_hidden_layers:
        fail(f"MoE serving paged-decode launches {launches['paged_decode']} "
             f"!= {ticks} ticks x {cfg.num_hidden_layers} layers")
    paths = eng.moe_decode_path()
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if paths != {"pallas": want} or plain or \
            counters.get("serving.moe.decode_path.pallas") != want:
        fail(f"MoE serving left the kernel path: {paths}, {plain}")
    # every decode tick's forward on the rows route, every prefill's on
    # the simt tiles (capacity 128): by the route the C entry reports
    routes = check_moe_routes(counters, {"fwd_cuda_rows": ticks * n_moe,
                                         "fwd_cuda_simt": prefills * n_moe},
                              "MoE serving")
    decode_routes = check_paged_split(counters, launches["paged_decode"],
                                      "MoE serving")
    n_tok = sum(len(o.token_ids) for o in outs)
    one = mods.Engine(model, **dict(P.MOE_ENGINE, max_slots=1)).run(
        [reqs[0], reqs[1]])
    agree = [sum(int(a == b) for a, b in zip(outs[i].token_ids,
                                             one[i].token_ids))
             / len(one[i].token_ids) for i in range(2)]
    rec = dict(requests=P.MOE_REQUESTS, tokens=n_tok, seconds=serve_s,
               tokens_per_s=n_tok / serve_s, decode_ticks=ticks,
               prefills=prefills, launches=launches,
               moe_decode_path=paths, agreement_1_slot=agree,
               counters=counters, grouped_ffn_routes=routes,
               paged_decode_routes=decode_routes)
    print(f"MoE serving: {P.MOE_REQUESTS} requests, {n_tok} tokens, {ticks} "
          f"decode ticks, {prefills} prefills in {serve_s:.2f} s = "
          f"{n_tok / serve_s:.1f} tok/s on {card}; launches {launches}; "
          f"8-slot vs 1-slot greedy agreement {agree} (threshold "
          f"{MOE_AGREE})", flush=True)
    if min(agree) < MOE_AGREE:
        fail(f"MoE serving: tokens depend on batch-mates: {agree}")
    return rec


def moe_cross_check(torch, mods):
    """Phase 13: a 2-layer ERNIE-MoE (one MoE block) on the card against
    the same weights on the CPU: one TrainStep loss and every parameter
    gradient, once the router's top-3 margins of the CPU's inputs are
    above MOE_MARGIN_MIN."""
    import numpy as np
    cfg = mods.ErnieMoEConfig(**MOE_XCHECK_MODEL)
    nets = {"cuda": mods.ErnieMoEForCausalLM(cfg, seed=1)}
    nets["cpu"] = mods.ErnieMoEForCausalLM(cfg, device="cpu")
    nets["cpu"].load_state_dict(
        {k: v.cpu() for k, v in nets["cuda"].state_dict().items()})
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int64)
    labels = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int64)
    res, seen = {}, {}
    for dev, net in (("cpu", nets["cpu"]), ("cuda", nets["cuda"])):
        def keep_input(module, args, dev=dev):
            seen.setdefault(dev, args[0].detach())      # returns None
        hook = net.moe_layers()[0].register_forward_pre_hook(keep_input)
        x, y = (torch.from_numpy(a).to(dev) for a in (ids, labels))
        ce = mods.CrossEntropyLoss()

        def loss_fn(out, lab, net=net, ce=ce):
            return ce(out, lab) + net.aux_loss()
        params = list(net.parameters())
        grads = torch.autograd.grad(loss_fn(net(x), y), params)
        hook.remove()
        step = mods.TrainStep(net, loss_fn, mods.AdamW(1e-3,
                                                       parameters=params))
        res[dev] = (float(step(x, y)), [gr.cpu() for gr in grads])
    h = seen["cpu"].reshape(-1, cfg.hidden_size)
    probs = torch.softmax(h @ nets["cpu"].moe_layers()[0].gate_weight.detach(),
                          dim=-1)
    top = probs.topk(3, dim=-1).values
    margin = float((top[:, :-1] - top[:, 1:]).min())
    loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(res["cuda"][1], res["cpu"][1]))
    rec = dict(loss_cuda=res["cuda"][0], loss_cpu=res["cpu"][0],
               loss_rel_err=loss_err, max_rel_grad_err=grad_err,
               min_top3_margin=margin, margin_min=MOE_MARGIN_MIN,
               grad_tol=XCHECK_GRAD_TOL, loss_tol=XCHECK_LOSS_TOL)
    print(f"MoE cross-check: smallest top-3 router margin {margin:.3g} "
          f"(min {MOE_MARGIN_MIN}); TrainStep loss cuda {res['cuda'][0]:.6f} "
          f"cpu {res['cpu'][0]:.6f} (rel err {loss_err:.2e}, tol "
          f"{XCHECK_LOSS_TOL}); max relative grad error {grad_err:.2e} over "
          f"{len(res['cpu'][1])} parameters (tol {XCHECK_GRAD_TOL})",
          flush=True)
    if not margin > MOE_MARGIN_MIN:
        fail(f"MoE cross-check inputs sit on a routing tie: {rec}")
    if not (loss_err <= XCHECK_LOSS_TOL and grad_err <= XCHECK_GRAD_TOL):
        fail(f"MoE cross-check off: {rec}")
    del nets, res
    torch.cuda.empty_cache()
    return rec


def moe_train_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 14: bench_ernie_moe's configuration for TRAIN_STEPS steps of
    one fixed batch, counts set to 0 just before and read just after."""
    P = mods.moe_profile
    cfg = mods.ErnieMoEConfig(**P.MOE_TRAIN_MODEL)
    model = mods.ErnieMoEForCausalLM(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    step = P.moe_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids, labels = (torch.randint(0, cfg.vocab_size, (P.MOE_BATCH, P.MOE_SEQ),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted MoE training path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_moe = len(model.moe_layers())
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"MoE training losses not finite and falling: {losses}")
    want = {"grouped_ffn_fwd": n_moe * TRAIN_STEPS,
            "grouped_ffn_bwd_dx": n_moe * TRAIN_STEPS,
            "grouped_ffn_bwd_dw": n_moe * TRAIN_STEPS,
            "flash_fwd": cfg.num_hidden_layers * TRAIN_STEPS,
            "flash_bwd_dq": cfg.num_hidden_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.num_hidden_layers * TRAIN_STEPS}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"MoE training launches {got}, expected {want}")
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if plain or counters.get("kernels.moe.grouped_ffn_bwd_cuda") != \
            want["grouped_ffn_bwd_dx"] or counters.get(
                "kernels.flash.bwd_cuda") != want["flash_bwd_dq"]:
        fail(f"MoE training kernel-path counters disagree: {counters}")
    routes = check_tc_routes(counters, want["flash_fwd"], "MoE training")
    update_routes = check_adam_routes(counters, launches["fused_adam"],
                                      "MoE training")
    moe_tc = check_moe_routes(counters, {
        "fwd_cuda_tc": want["grouped_ffn_fwd"],
        "dx_cuda_tc": want["grouped_ffn_bwd_dx"],
        "dw_cuda_tc": want["grouped_ffn_bwd_dw"]}, "MoE training")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens = P.MOE_BATCH * P.MOE_SEQ
    flops = mods.ernie_moe_flops_per_token(cfg) * tokens
    rec = dict(params=n_params, batch=P.MOE_BATCH, seq=P.MOE_SEQ,
               steps=TRAIN_STEPS, losses=losses, step_s=times,
               ms_per_step=steady * 1e3, first_step_ms=times[0] * 1e3,
               tokens_per_s=tokens / steady,
               bf16_peak_share=flops / steady / PEAK_FLOPS["bfloat16"],
               peak_mem_gb=peak_gb, launches=launches, counters=counters,
               flash_routes=routes, grouped_ffn_routes=moe_tc,
               update_routes=update_routes)
    print(f"MoE training: {n_params / 1e6:.1f} M params, batch "
          f"{P.MOE_BATCH} x seq {P.MOE_SEQ}, losses "
          f"{[round(x, 4) for x in losses]}; median step "
          f"{rec['ms_per_step']:.1f} ms (first {rec['first_step_ms']:.1f} "
          f"ms) = {rec['tokens_per_s']:.0f} tokens/s, "
          f"{rec['bf16_peak_share']:.4f} of the 989 TFLOP/s bf16 peak "
          f"(ernie_moe_flops_per_token, routed), peak memory {peak_gb:.1f} "
          f"GB; launches {launches} on {card}", flush=True)
    return rec


# -- phases 15-18: the encoder path ----------------------------------------

#: phase 15's training case: BERT_TRAIN's attention, one layer (bf16,
#: head dim 64, bidirectional, no mask)
BERT_TRAIN_SPECS = [("bert_train_bf16", 256, 128, 128, 12, 12, 64,
                     "bfloat16", None, None, False)]
#: the small on-card BERT cross-check model: BERT-base widths, 2 layers
BERT_XCHECK_LAYERS, BERT_XCHECK_SEQ = 2, 128
#: batched embeddings against the same request encoded alone (f32, TF32
#: off: only the order of sums differs; the JAX service's contract)
EMBED_B1_RTOL = 1e-4
#: requests of the serving trace held to their b=1 embedding
EMBED_B1_REQUESTS = 4


def check_minor64_probe(torch, fa):
    """Phase 15a: the head-dim-64 probe of csrc/flash_fwd.cu (the tf32x3
    route's tiles) through its wrapper (which raises on a wrong answer),
    equal to its plain version bit for bit on the wrapper's small-integer
    input; the kernel's own
    launch timed beside the plain version and, timed only, the pair of
    torch.matmul calls. The wrapper's whole call also holds the plain
    product it checks against and a host sync, so it is not what the
    kernel's time reads."""
    dev = torch.device("cuda")
    o = fa.probe_minor64(dev)
    x = fa.minor64_input(dev)
    want = fa.minor64_probe_plain(x)
    if not torch.equal(o, want):
        fail(f"the head-dim-64 probe disagrees with its plain version "
             f"(max err {max_err(o, want)})")
    n, d = fa.MINOR64_SHAPE
    bms, by, peak = flash_bound(2 * x.numel() * 4, 2 * (2 * n * n * d),
                                "float32", "tf32x3")
    rec = dict(case="128x64_f32", max_abs_err=0.0, tol=0.0, ratio=0.0,
               route="tf32x3", bound_peak=peak,
               ms=cuda_ms(lambda: fa._minor64_launch(x, o), iters=50),
               plain_ms=cuda_ms(lambda: fa.minor64_probe_plain(x), iters=50),
               library_ms=cuda_ms(lambda: torch.matmul(torch.matmul(x, x.T),
                                                       x), iters=50),
               bound_ms=bms, bound_by=by)
    print(f"  probe_minor64: equal to its plain version; kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, matmul pair "
          f"{rec['library_ms']:.4f} ms, bound {bms:.7f} ms ({by})",
          flush=True)
    return [rec]


def _key_lengths(torch, g, B, L, dead):
    """Live key lengths of a pinned batch: the last ``dead`` rows 0, one
    row the whole bucket, the rest ragged in [1, L)."""
    lens = torch.randint(1, L, (B,), generator=g, device="cuda")
    lens[0] = L
    lens[B - dead:] = 0
    return lens


def check_flash_encoder(torch, fa, F):
    """Phase 15b: the flash forward at the serving shape (B 16, H 12, D 64,
    f32, non-causal) with C=1 key bands from a pinned batch's padding mask
    — 4 dead rows whose every key is masked (they must give zeros),
    ragged live lengths — at L 128 and 96 (not a multiple of the 64-row q
    tile), timed beside the plain version and the timed-only SDPA call
    with the same bool mask. The bound counts what this data needs: the
    pairs (each live row's L queries times its live keys) and the bytes
    (Q of the live rows, K and V of the live keys, O of every row)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention   # timed only
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    B, H, D, dead = 16, 12, 64, 4
    cases = []
    for L in (128, 96):
        q, k, v = (torch.randn(B, L, H, D, generator=g, device=dev)
                   for _ in range(3))
        lens = _key_lengths(torch, g, B, L, dead)
        mask = torch.arange(L, device=dev)[None, :] < lens[:, None]
        keymask = mask[:, None, None, :]
        se = fa._normalize_startend(
            F._mask_to_key_bands(keymask, B, L, L, H), L, L, False)
        scale = D ** -0.5
        got = fa.flash_fwd(q, k, v, False, scale, None, se)
        torch.cuda.synchronize()

        def plain():
            return fa.flash_plain(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), False, scale,
                                  se=se).transpose(1, 2)
        c = closeness(got, plain())
        if not c["ratio"] <= 1.0:
            fail(f"flash_fwd[encoder L{L}] disagrees with its plain version: "
                 f"{c}")
        if got[B - dead:].any():
            fail(f"flash_fwd[encoder L{L}]: dead rows are not zero")
        pairs = int(lens.sum()) * L * H
        # the bytes the function needs: Q of the live batch rows (every
        # query of a live row sees its live keys), K and V of the live
        # keys only, O of every row (dead rows are written as zeros), and
        # the bands
        live_rows = int((lens > 0).sum())
        nbytes = (live_rows * L * H * D + 2 * int(lens.sum()) * H * D
                  + q.numel()) * 4 + se.numel() * 4
        route = fa._route_of("fwd", [q, k, v])
        bms, by, peak = flash_bound(nbytes, 4 * pairs * D, "float32", route)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rec = dict(case=f"serving_f32_L{L}", B=B, sq=L, sk=L, heads=H,
                   head_dim=D, dtype="float32", route=route,
                   bound_peak=peak, dead_rows=dead,
                   live_keys=lens.tolist(), pairs=pairs, **c,
                   ms=cuda_ms(lambda: fa._fwd_launch(q, k, v, got, None,
                                                     False, scale, None, se),
                              iters=20),
                   wrapper_ms=cuda_ms(lambda: fa.flash_fwd(
                       q, k, v, False, scale, None, se), iters=20),
                   plain_ms=cuda_ms(plain, iters=5),
                   library_ms=cuda_ms(lambda: sdpa(
                       qt, kt, vt, attn_mask=keymask), iters=20),
                   bound_ms=bms, bound_by=by)
        print(f"  flash_fwd[encoder L{L}] ({rec['route']}): err "
              f"{c['max_abs_err']:.3g} (ratio "
              f"{c['ratio']:.3g}), dead rows zero; kernel {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, SDPA {rec['library_ms']:.4f} "
              f"ms, bound {bms:.4f} ms ({by}, {peak})", flush=True)
        if rec["ms"] < bms:
            fail(f"flash_fwd[encoder L{L}]: {rec['ms']} ms is below its "
                 f"bound {bms} ms ({peak})")
        cases.append(rec)
    return cases


def encoder_serving_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 16: bench_bert_embedding's configuration (profile_encoder's
    BERT_EMBED), counts set to 0 just before the service is built and read
    just after the trace has run twice (warm, then timed); then
    EMBED_B1_REQUESTS requests held to the same request encoded alone."""
    import numpy as np
    enc = mods.enc
    E = enc.BERT_EMBED
    cfg = mods.BertConfig(**E["model"])
    model = mods.BertModel(cfg, seed=E["seed"])
    model.eval()
    trace = enc.embed_trace(cfg.vocab_size)
    torch.cuda.synchronize()
    reset_counts()
    # phase 15 already probed this card: forget it, so that the service
    # runs its head-dim-64 probe once inside the counted run
    mods.fa._minor64_ok.clear()
    svc = mods.BatchEncoder(model, max_batch=E["max_batch"],
                            bucket=E["bucket"])
    warm = enc.run_embed_trace(svc, trace)
    c_warm = dict(mods.monitor.snapshot())
    timed = enc.run_embed_trace(svc, trace)
    torch.cuda.synchronize()
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith(("kernels.", "serving.embed."))}
    recompiles = svc.steady_state_recompiles()
    # -- end of the counted encoder serving path --
    outs = warm["outs"] + timed["outs"]
    bad = [o for o in outs if not o.ok or o.finish_reason != "done"]
    if len(outs) != 2 * E["n_requests"] or bad:
        fail(f"encoder serving: {len(outs)} outputs, failed: {bad[:2]}")
    batches = int(counters.get("serving.embed.batches", 0))
    want = batches * cfg.num_hidden_layers
    sdpa = {k: v for k, v in counters.items()
            if k.startswith("kernels.flash.sdpa.") and v}
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if launches["flash_fwd"] != want or \
            counters.get("kernels.flash.fwd_cuda") != want:
        fail(f"encoder flash launches {launches['flash_fwd']} != {batches} "
             f"batches x {cfg.num_hidden_layers} layers")
    if sdpa != {"kernels.flash.sdpa.kernel_mask": want} or plain:
        fail(f"encoder serving left the masked kernel route: {sdpa} {plain}")
    routes = check_f32_routes(counters, want, "encoder serving")
    if launches["probe_minor64"] != 1:
        fail(f"the encoder ran the head-dim-64 probe "
             f"{launches['probe_minor64']} times, expected 1")
    if recompiles != 0:
        fail(f"encoder serving built {recompiles} kernel libraries in "
             f"steady state")
    t_batches = batches - int(c_warm["serving.embed.batches"])
    t_tokens = counters["serving.embed.tokens"] - c_warm[
        "serving.embed.tokens"]
    t_pad = counters["serving.embed.pad_tokens"] - c_warm[
        "serving.embed.pad_tokens"]
    # batched against the same request encoded alone (no mask, b = 1)
    by_id = {o.req_id: o for o in timed["outs"]}
    first = min(by_id)
    b1 = []
    with torch.no_grad():
        for i in range(EMBED_B1_REQUESTS):
            ids = torch.from_numpy(trace[1][i][None]).cuda()
            x, pooled = model(ids)
            ref = pooled[0] if trace[2][i] == "cls" else x[0].mean(0)
            got = torch.from_numpy(by_id[first + i].embedding).cuda()
            b1.append(float((got - ref.float()).abs().max()
                            / ref.abs().max()))
    if max(b1) > EMBED_B1_RTOL:
        fail(f"batched embeddings differ from b=1: {b1}")
    steps = timed["steps"]
    rec = dict(requests=E["n_requests"], passes=2, batches=batches,
               timed=dict(seconds=timed["seconds"], batches=t_batches,
                          real_tokens=t_tokens, pad_tokens=t_pad,
                          tokens_per_s=t_tokens / timed["seconds"],
                          last_arrival_s=float(trace[0][-1]),
                          pad_share=t_pad / (t_tokens + t_pad),
                          steps=steps,
                          host_ms_per_step=timed["host_ms"] / steps,
                          device_ms_per_step=timed["device_ms"] / steps,
                          device_ms_per_batch=timed["device_ms"] / t_batches),
               warm_seconds=warm["seconds"], launches=launches,
               steady_state_recompiles=recompiles, b1_rel_err=b1,
               b1_rtol=EMBED_B1_RTOL, counters=counters, flash_routes=routes)
    tm = rec["timed"]
    print(f"encoder serving: {E['n_requests']} requests x 2 passes, "
          f"{batches} batches, flash launches {launches['flash_fwd']} = "
          f"batches x {cfg.num_hidden_layers}, probe_minor64 "
          f"{launches['probe_minor64']}; timed pass {tm['seconds']:.3f} s, "
          f"{tm['batches']} batches, {tm['tokens_per_s']:.0f} real tokens/s "
          f"(arrival-bound: last arrival {tm['last_arrival_s']:.3f} s), "
          f"pad share {tm['pad_share']:.3f}, host "
          f"{tm['host_ms_per_step']:.2f} / device "
          f"{tm['device_ms_per_step']:.2f} ms per step, device "
          f"{tm['device_ms_per_batch']:.2f} ms per batch on {card}; batched vs "
          f"b=1 rel err {max(b1):.2e} (tol {EMBED_B1_RTOL})", flush=True)
    del svc, model
    torch.cuda.empty_cache()
    return rec


def bert_cross_check(torch, mods):
    """Phase 17: a 2-layer BertForPretraining at BERT-base widths, seq 128,
    f32, dropout 0, with a padding mask, on the card against the same
    weights on the CPU: one TrainStep loss and every parameter gradient
    of MLM loss + mean(nsp^2) (so the pooler and NSP head count too)."""
    import dataclasses
    import numpy as np
    cfg = mods.BertConfig(**mods.enc.BERT_TRAIN["model"])
    cfg = dataclasses.replace(cfg, num_hidden_layers=BERT_XCHECK_LAYERS,
                              hidden_dropout_prob=0.0)
    nets = {"cuda": mods.BertForPretraining(cfg, seed=1)}
    nets["cpu"] = mods.BertForPretraining(cfg, device="cpu")
    nets["cpu"].load_state_dict(
        {k: v.cpu() for k, v in nets["cuda"].state_dict().items()})
    rng = np.random.default_rng(7)
    shape = (2, BERT_XCHECK_SEQ)
    ids = rng.integers(0, cfg.vocab_size, shape).astype(np.int64)
    tt = rng.integers(0, 2, shape).astype(np.int64)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int64)
    am = np.ones(shape, np.int64)
    am[1, 88:] = 0

    def loss_fn(out, lab):
        return out[0] + out[1].square().mean()
    res = {}
    for dev, net in nets.items():
        inputs = tuple(torch.from_numpy(a).to(dev)
                       for a in (ids, tt, labels, am))
        params = list(net.parameters())
        grads = torch.autograd.grad(loss_fn(net(*inputs), None), params)
        step = mods.TrainStep(net, loss_fn, mods.AdamW(1e-3,
                                                       parameters=params))
        res[dev] = (float(step(inputs, inputs[2])),
                    [gr.cpu() for gr in grads])
    loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(res["cuda"][1], res["cpu"][1]))
    rec = dict(layers=BERT_XCHECK_LAYERS, seq=BERT_XCHECK_SEQ,
               loss_cuda=res["cuda"][0], loss_cpu=res["cpu"][0],
               loss_rel_err=loss_err, max_rel_grad_err=grad_err,
               grad_tol=XCHECK_GRAD_TOL, loss_tol=XCHECK_LOSS_TOL)
    print(f"BERT cross-check: TrainStep loss cuda {res['cuda'][0]:.6f} cpu "
          f"{res['cpu'][0]:.6f} (rel err {loss_err:.2e}, tol "
          f"{XCHECK_LOSS_TOL}); max relative grad error {grad_err:.2e} over "
          f"{len(res['cpu'][1])} parameters (tol {XCHECK_GRAD_TOL})",
          flush=True)
    if not (loss_err <= XCHECK_LOSS_TOL and grad_err <= XCHECK_GRAD_TOL):
        fail(f"BERT cross-check off: {rec}")
    del nets, res
    torch.cuda.empty_cache()
    return rec


def bert_train_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 18: bench_bert's configuration (profile_encoder's BERT_TRAIN)
    for TRAIN_STEPS steps of one fixed batch, dropout 0.1 from the
    model's generator, counts set to 0 just before and read just after."""
    enc = mods.enc
    T = enc.BERT_TRAIN
    cfg = mods.BertConfig(**T["model"])
    model = mods.BertForPretraining(cfg, seed=T["seed"])
    n_params = sum(p.numel() for p in model.parameters())
    step = enc.bert_train_step(model)
    inputs, labels = enc.train_batch(cfg.vocab_size, model.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(inputs, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted BERT training path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"BERT training losses not finite and falling: {losses}")
    want = cfg.num_hidden_layers * TRAIN_STEPS
    got = {k: launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")}
    if set(got.values()) != {want}:
        fail(f"BERT training launches {got}, expected {want} each")
    sdpa = {k: v for k, v in counters.items()
            if k.startswith("kernels.flash.sdpa.") and v}
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if plain or sdpa != {"kernels.flash.sdpa.kernel": want} or \
            counters.get("kernels.flash.bwd_cuda") != want:
        fail(f"BERT training kernel-path counters disagree: {counters}")
    routes = check_tc_routes(counters, want, "BERT training")
    update_routes = check_adam_routes(counters, launches["fused_adam"],
                                      "BERT training")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens = T["batch"] * T["seq"]
    flops = enc.bert_flops_per_token(model) * tokens
    rec = dict(params=n_params, batch=T["batch"], seq=T["seq"],
               steps=TRAIN_STEPS, losses=losses, step_s=times,
               ms_per_step=steady * 1e3, first_step_ms=times[0] * 1e3,
               tokens_per_s=tokens / steady,
               bf16_peak_share_6n=flops / steady / PEAK_FLOPS["bfloat16"],
               peak_mem_gb=peak_gb, launches=launches, counters=counters,
               flash_routes=routes, update_routes=update_routes)
    print(f"BERT training: {n_params / 1e6:.1f} M params, batch {T['batch']} "
          f"x seq {T['seq']}, dropout {cfg.hidden_dropout_prob}, losses "
          f"{[round(x, 4) for x in losses]}; median step "
          f"{rec['ms_per_step']:.1f} ms (first {rec['first_step_ms']:.1f} ms)"
          f" = {rec['tokens_per_s']:.0f} tokens/s, "
          f"{rec['bf16_peak_share_6n']:.4f} of the 989 TFLOP/s bf16 peak by "
          f"bench_bert's 6N rule, peak memory {peak_gb:.1f} GB; launches "
          f"{got} on {card}", flush=True)
    del step, model
    torch.cuda.empty_cache()
    return rec


# -- phase 19: the eager dygraph surface -----------------------------------
# the model, batch, loss and optimizer are profile_eager's (``ep``)

#: the card-vs-CPU copy: 2 layers, dropout 0, f32, batch 4; its AdamW
#: step at 1e-3, ten times closeness's f32 atol (1e-4), so that a
#: parameter the update missed shows as a ratio near 10
EAGER_XCHECK_LAYERS, EAGER_XCHECK_BATCH, EAGER_XCHECK_LR = 2, 4, 1e-3


def eager_cross_check(torch, paddle, ep):
    """Phase 19 (a): a 2-layer f32 copy of the eager model, dropout 0, one
    forward and backward on the card (tf32x3 forward, simt backward)
    against the same weights on the CPU (the plain versions), through
    ``_xcheck``; then one ``AdamW.step()`` on the card (the fused update)
    against the plain rule on the CPU, applied to the card's weights and
    gradients: every surface Parameter, read back through the model after
    the step."""
    from paddle_tpu_torch.kernels.fused_adam import adam_update_plain

    def update(card, card_grads):
        before = {k: p._data.detach().float().cpu().clone()
                  for k, p in card.named_parameters()}
        opt = ep.make_optimizer(card, lr=EAGER_XCHECK_LR)
        opt.step()
        torch.cuda.synchronize()
        upd = {}
        for k, p in card.named_parameters():
            want = before[k].clone()
            state = {"moment1": torch.zeros_like(want),
                     "moment2": torch.zeros_like(want),
                     "beta1_pow": torch.tensor(opt._beta1),
                     "beta2_pow": torch.tensor(opt._beta2)}
            adam_update_plain(want, card_grads[k], state,
                              torch.tensor(EAGER_XCHECK_LR), opt._beta1,
                              opt._beta2, opt._epsilon, False, "decoupled",
                              ep.WEIGHT_DECAY)
            upd[k] = closeness(p._data.detach().float().cpu(), want)
        worst = max(upd, key=lambda k: upd[k]["ratio"])
        rec = dict(update_lr=EAGER_XCHECK_LR, updated=len(upd),
                   worst_update=worst,
                   worst_update_ratio=upd[worst]["ratio"],
                   worst_update_max_abs_err=upd[worst]["max_abs_err"])
        if len(upd) != len(card.parameters()) or upd[worst]["ratio"] > 1:
            fail(f"eager cross-check: the card's AdamW step is off the "
                 f"plain rule: {rec}")
        return rec

    paddle.set_device("gpu")
    paddle.seed(1)
    batch, _ = ep.fixed_batch(EAGER_XCHECK_BATCH)
    rec = _xcheck(paddle, lambda: ep.build_model(EAGER_XCHECK_LAYERS, 0.0),
                  [t._data.cpu() for t in batch], ep.loss_of, then=update)
    rec.update(layers=EAGER_XCHECK_LAYERS, batch=EAGER_XCHECK_BATCH,
               seq=ep.SEQ, fused_adam_launches=1)
    print(f"eager cross-check: loss cuda {rec['loss_cuda']:.6f} cpu "
          f"{rec['loss_cpu']:.6f} (ratio {rec['loss_ratio']:.3f}); "
          f"{rec['grads']} gradients, worst {rec['worst_grad']} ratio "
          f"{rec['worst_grad_ratio']:.3f} (max abs err "
          f"{rec['worst_grad_max_abs_err']:.2e}); AdamW({EAGER_XCHECK_LR}) "
          f"on the card against the plain rule on the CPU: "
          f"{rec['updated']} parameters, worst {rec['worst_update']} ratio "
          f"{rec['worst_update_ratio']:.3f} (max abs err "
          f"{rec['worst_update_max_abs_err']:.2e}); pass <= 1, closeness's "
          f"f32 gate", flush=True)
    return rec


def eager_train_main_path(torch, paddle, ep, dispatch, launches_of,
                          reset_counts, card):
    """Phase 19 (b): the eager surface's training loop at BERT-base widths
    and depth for TRAIN_STEPS steps of one fixed batch, counts set to 0
    just before and read just after. Beside the training losses (dropout
    on), the loss of the batch in eval mode (dropout off, no gradient)
    before the first step and after the last."""
    paddle.set_device("gpu")
    paddle.seed(0)
    m = ep.MODEL
    model = ep.build_model()
    n_params = sum(p.size for p in model.parameters())
    opt = ep.make_optimizer(model)
    batch, lens = ep.fixed_batch()
    seen = {}

    def eval_loss():
        model.eval()
        with paddle.no_grad():
            loss = float(ep.forward_loss(model, batch))
        model.train()
        return loss

    def dtype_of(key):
        def hook(layer, inputs, out):
            seen.setdefault(key, out.dtype.name)   # returns None: keep out
        return hook
    layer0 = model[1].layers[0]
    hooks = [layer0.linear1.register_forward_post_hook(dtype_of("linear")),
             layer0.norm1.register_forward_post_hook(
                 dtype_of("layer_norm"))]
    eval_before = eval_loss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, host_s, step_s, ev_ms, ops = [], [], [], [], []
    fb_host_s, fb_ev_ms = [], []

    def step():
        e0, eb, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
        n0 = dispatch.op_count
        t0 = time.perf_counter()
        e0.record()
        loss = ep.forward_loss(model, batch)
        loss.backward()
        eb.record()
        tb = time.perf_counter()
        opt.step()
        opt.clear_grad()
        e1.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ops.append(dispatch.op_count - n0)
        fb_host_s.append(tb - t0)
        fb_ev_ms.append(e0.elapsed_time(eb))
        host_s.append(t1 - t0)
        step_s.append(t2 - t0)
        ev_ms.append(e0.elapsed_time(e1))
        seen.setdefault("loss", loss.dtype.name)
        losses.append(float(loss))
    with ep.GcClock() as gc_clock:
        for _ in range(TRAIN_STEPS):
            step()
    launches = launches_of()
    counters = {k: v for k, v in paddle.monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted eager path --
    eval_after = eval_loss()
    gc_objects = len(gc.get_objects())
    # one more step, uncounted, under the sync debug mode: the host syncs
    # a step makes (after which the host's clock includes the device's)
    syncs = count_syncs(torch, step)
    for lst in (losses, host_s, step_s, ev_ms, ops, fb_host_s, fb_ev_ms):
        lst.pop()
    for h in hooks:
        h.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(map(math.isfinite, losses + [eval_before, eval_after])) \
            or not losses[-1] < losses[0] or not eval_after < eval_before:
        fail(f"eager training losses not finite and falling: {losses}, "
             f"eval mode {eval_before} -> {eval_after}")
    if seen != {"linear": "bfloat16", "layer_norm": "float32",
                "loss": "float32"}:
        fail(f"eager O1 dtypes {seen}")
    want = m["layers"] * TRAIN_STEPS
    routes = {k: counters.get(f"kernels.flash.{k}_cuda_tc_wgmma", 0)
              for k in ("fwd", "dq", "dkv")}
    sdpa = {k: v for k, v in counters.items()
            if k.startswith("kernels.flash.sdpa.") and v}
    got = {k: launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")}
    if set(routes.values()) != {want} or set(got.values()) != {want}:
        fail(f"eager flash launches {got}, wgmma routes {routes}, "
             f"expected {want} each")
    if sdpa != {"kernels.flash.sdpa.kernel_mask": want}:
        fail(f"eager sdpa routes {sdpa}, expected only kernel_mask == {want}")
    if counters.get("kernels.optimizer.adam_fused") != TRAIN_STEPS or \
            counters.get("kernels.optimizer.adam_plain", 0):
        fail(f"eager optimizer routes: {counters}")
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if plain:
        fail(f"eager path ran plain versions: {plain}")
    med = statistics.median
    steady = med(step_s[1:])
    tokens = ep.BATCH * ep.SEQ
    rec = dict(params=n_params, batch=ep.BATCH, seq=ep.SEQ, lr=ep.LR,
               lengths=lens.tolist(), steps=TRAIN_STEPS,
               dropout=m["dropout"], losses=losses,
               eval_loss_before=eval_before, eval_loss_after=eval_after,
               gc_ms_per_step=gc_clock.seconds * 1e3 / TRAIN_STEPS,
               gc_collections=gc_clock.collections,
               gc_tracked_objects=gc_objects, dtypes=seen,
               step_s=step_s, host_s=host_s, events_ms=ev_ms,
               ms_per_step=steady * 1e3,
               events_ms_per_step=med(ev_ms[1:]),
               host_ms_per_step=med(host_s[1:]) * 1e3,
               host_share=med(host_s[1:]) / steady,
               fwd_bwd_host_ms=med(fb_host_s[1:]) * 1e3,
               fwd_bwd_events_ms=med(fb_ev_ms[1:]),
               fwd_bwd_host_share=med(fb_host_s[1:]) * 1e3 / med(
                   fb_ev_ms[1:]), syncs_per_step=syncs,
               ops_per_step=ops, host_us_per_op=med(
                   h / n for h, n in zip(host_s[1:], ops[1:])) * 1e6,
               first_step_ms=step_s[0] * 1e3, tokens_per_s=tokens / steady,
               peak_mem_gb=peak_gb, launches=launches, counters=counters,
               fused_adam_launches=launches["fused_adam"])
    print(f"eager surface training: {n_params / 1e6:.1f} M params, batch "
          f"{ep.BATCH} x seq {ep.SEQ}, dropout {m['dropout']}, O1 "
          f"bf16, losses {[round(x, 4) for x in losses]} (eval mode "
          f"{eval_before:.4f} -> {eval_after:.4f}); median step "
          f"{rec['ms_per_step']:.1f} ms (events {rec['events_ms_per_step']:.1f}"
          f" ms, first {rec['first_step_ms']:.1f} ms) = "
          f"{rec['tokens_per_s']:.0f} tokens/s, host {rec['host_ms_per_step']:.1f}"
          f" ms a step ({rec['host_share']:.3f} of it; {ops[-1]} ops, "
          f"{rec['host_us_per_op']:.1f} us an op; {syncs} syncs a step); "
          f"forward + backward: host {rec['fwd_bwd_host_ms']:.1f} ms to "
          f"enqueue, events {rec['fwd_bwd_events_ms']:.1f} ms (share "
          f"{rec['fwd_bwd_host_share']:.3f}), peak memory "
          f"{peak_gb:.1f} GB; gc {rec['gc_ms_per_step']:.1f} ms a step "
          f"({gc_clock.collections} collections, {gc_objects} tracked "
          f"objects); launches {got}, {launches['fused_adam']} "
          f"fused Adam on {card}", flush=True)
    del opt, model
    torch.cuda.empty_cache()
    return rec


# -- phase 20: the serving replay tool and request migration ---------------

#: phase 20's LLaMA: the widest the replay tool's flags express (LLaMA-7B
#: widths, 4 layers, f32 weights, FFN 4 x hidden)
REPLAY_LLAMA = ["--hidden", "4096", "--heads", "32", "--layers", "4",
                "--vocab", "32000"]
REPLAY_ENGINE = ["--max-slots", "8", "--page-size", "16", "--pool-pages",
                 "128", "--prefill-bucket", "64"]
#: BERT-base widths for the --embedding replay
REPLAY_BERT = ["--hidden", "768", "--heads", "12", "--layers", "12",
               "--vocab", "30522"]
REPLAY_REQUESTS, REPLAY_PROMPT, REPLAY_NEW = 24, (64, 127), 128
#: (b)'s chaos trace: REPLAY_REQUESTS requests of REPLAY_PROMPT tokens,
#: every other one opening with a shared 48-token system prompt (three
#: 16-token pages for the prefix cache), 32-128 new tokens each
CHAOS_SYSTEM, CHAOS_NEW = 48, (32, 128)
#: (c)'s embedding trace at BERT-base serving sizes: 256 requests of
#: 128-512 tokens, one every 2 ms, mean and CLS pooling over two tenants,
#: batches of up to 32 padded to 64-token buckets
EMBED_REQUESTS, EMBED_SEQ = 256, (128, 512)
EMBED_SERVICE = ["--max-batch", "32", "--bucket", "64"]
#: (d)'s migration: requests, new tokens, and the step after which
#: 2 greedy and 2 sampled live requests move to the second engine
MIGRATE_REQUESTS, MIGRATE_NEW, MIGRATE_AT = 8, 64, 6


def replay_trace(path):
    """The 24-request decoder trace of phase 20 (a): prompts of 64-127
    tokens, 128 new tokens each (within the tool's 256 positions), one
    arrival every 10 ms."""
    import numpy as np
    rng = np.random.default_rng(20)
    with open(path, "w") as fh:
        for i in range(REPLAY_REQUESTS):
            fh.write(json.dumps({
                "arrival_ms": 10 * i,
                "prompt_len": int(rng.integers(REPLAY_PROMPT[0],
                                               REPLAY_PROMPT[1] + 1)),
                "new_tokens": REPLAY_NEW}) + "\n")


def chaos_trace(path):
    """The chaos trace of phase 20 (b): REPLAY_REQUESTS requests, prompts
    of REPLAY_PROMPT tokens of which every other one starts with the
    CHAOS_SYSTEM-token system prompt, CHAOS_NEW new tokens, one arrival
    every 10 ms; contexts reach 255, within the tool's 256 positions."""
    import numpy as np
    rng = np.random.default_rng(22)
    with open(path, "w") as fh:
        for i in range(REPLAY_REQUESTS):
            line = {"arrival_ms": 10 * i,
                    "prompt_len": int(rng.integers(REPLAY_PROMPT[0],
                                                   REPLAY_PROMPT[1] + 1)),
                    "new_tokens": int(rng.integers(CHAOS_NEW[0],
                                                   CHAOS_NEW[1] + 1))}
            if i % 2 == 0:
                line["system_len"] = CHAOS_SYSTEM
            fh.write(json.dumps(line) + "\n")


def embed_trace(path):
    """The embedding trace of phase 20 (c): EMBED_REQUESTS requests of
    EMBED_SEQ tokens, one every 2 ms, pooling and tenant alternating."""
    import numpy as np
    rng = np.random.default_rng(23)
    with open(path, "w") as fh:
        for i in range(EMBED_REQUESTS):
            fh.write(json.dumps({
                "arrival_ms": 2 * i,
                "seq_len": int(rng.integers(EMBED_SEQ[0], EMBED_SEQ[1] + 1)),
                "pooling": "mean" if i % 2 == 0 else "cls",
                "tenant": "ab"[i % 3 == 0]}) + "\n")


def run_replay(what, args, timeout=600):
    """``python -m paddle_tpu_torch.serving_replay`` as a subprocess; any
    exit but 0 fails the phase. Returns its JSON report."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.serving_replay"] + \
        [str(a) for a in args] + ["--json"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    secs = time.perf_counter() - t0
    (OUT_DIR / f"replay_{what}.log").write_text(
        " ".join(cmd) + "\n" + out.stdout + out.stderr)
    if out.returncode != 0:
        fail(f"replay {what}: exit {out.returncode}: {out.stderr[-2000:]}")
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        fail(f"replay {what}: no report")
    report = json.loads(lines[-1])
    report["process_s"] = secs
    return report


def _replay_decoder_gates(what, rep):
    paths = rep["decode_paths"]
    n_pd = rep["launches"]["paged_decode"]
    c = rep["counters"]
    if rep["failed"] or rep["total_tokens"] != REPLAY_REQUESTS * REPLAY_NEW \
            or len(rep["tokens"]) != REPLAY_REQUESTS:
        fail(f"replay {what}: failed {rep['failed']}, "
             f"{rep['total_tokens']} tokens")
    if rep["leaked_pages"]:
        fail(f"replay {what}: {rep['leaked_pages']} pages leaked")
    if not n_pd or paths["cuda_split"] != n_pd or paths["cuda_single"] \
            or paths["plain"] or c.get("kernels.decode.paged_cuda") != n_pd:
        fail(f"replay {what}: paged-decode launches {n_pd}, paths {paths}")


def _migration(torch, mods, launches_of, reset_counts):
    """Phase 20 (d): two Engines on the card over one LLaMA's weights;
    after MIGRATE_AT steps 2 greedy and 2 sampled live requests leave the
    first (``extract_request``) and join the second's queue; every
    request's tokens equal an uninterrupted run's."""
    import numpy as np
    cfg = mods.LlamaConfig.tiny(vocab=32000, hidden=4096, layers=4,
                                heads=32)
    model = mods.LlamaForCausalLM(cfg, seed=0)
    model.eval()
    rng = np.random.default_rng(21)
    reqs = []
    for i in range(MIGRATE_REQUESTS):
        n = int(rng.integers(REPLAY_PROMPT[0], REPLAY_PROMPT[1] + 1))
        sampled = i % 2 == 1
        reqs.append((rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64),
                     dict(max_new_tokens=MIGRATE_NEW,
                          temperature=0.8 if sampled else 0.0,
                          top_k=50 if sampled else 0, seed=100 + i)))
    kw = dict(max_slots=8, page_size=16, max_context=256, prefill_bucket=64)
    ref = {o.req_id: o.token_ids for o in mods.Engine(model, **kw).run(
        [(p, mods.SamplingParams(**k)) for p, k in reqs])}
    reset_counts()
    a, b = mods.Engine(model, **kw), mods.Engine(model, **kw)
    for p, k in reqs:
        a.add_request(p, mods.SamplingParams(**k))
    done = {}
    for _ in range(MIGRATE_AT):
        done.update({o.req_id: o for o in a.step()})
    live = [r for r in a.requests.values() if r.generated]
    greedy = [r.req_id for r in live if r.params.temperature == 0][:2]
    sampled = [r.req_id for r in live if r.params.temperature > 0][:2]
    if len(greedy) != 2 or len(sampled) != 2:
        fail(f"migration: live greedy {greedy}, sampled {sampled}")
    moved = [a.extract_request(rid) for rid in greedy + sampled]
    for r in moved:
        b.readmit(r)
    while not (a.idle and b.idle):
        for eng in (a, b):
            done.update({o.req_id: o for o in eng.step()})
    launches = launches_of()
    got = {rid: o.token_ids for rid, o in done.items()}
    leaked = a.leaked_pages() + b.leaked_pages()
    diff = sorted(r for r in ref if got.get(r) != ref[r])
    rec = dict(requests=MIGRATE_REQUESTS, moved_greedy=greedy,
               moved_sampled=sampled, at_step=MIGRATE_AT,
               mismatched=diff, leaked_pages=leaked, launches=launches,
               tokens=sum(len(t) for t in got.values()))
    if diff or leaked or not all(o.ok for o in done.values()):
        fail(f"migration: streams differ from the uninterrupted run: {rec}")
    del model, a, b
    torch.cuda.empty_cache()
    return rec


def _replay_fixture_gates(runs):
    """The fixture runs of (b) and (c), gates only (toy lengths, no rate
    is kept): the chaos fixture's contexts reach 34, a table of one
    64-token chunk, so its decode runs the single-chunk kernel
    (check_paged's replay_single_f32 case holds that route to plain);
    the embedding fixture's encoder runs the probe and the flash
    forward."""
    rep = runs["chaos_fixture"]
    paths, ch = rep["decode_paths"], rep["chaos"]
    if not paths["cuda_single"] or paths["cuda_split"] or paths["plain"] \
            or not ch["total_injected"] or not ch["survivors_exact"]:
        fail(f"replay chaos_fixture: paths {paths}, chaos {ch}")
    rep = runs["embedding_fixture"]
    if rep["failed"] or not rep["launches"]["flash_fwd"] or \
            rep["counters"].get("kernels.flash.fwd_plain"):
        fail(f"replay embedding_fixture: failed {rep['failed']}, launches "
             f"{rep['launches']}, counters {rep['counters']}")


def replay_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 20: the port's replay tool on the card, each run a
    subprocess whose counts start at 0 and are read from its report:
    (a) REPLAY_LLAMA serving the 24-request trace plain and with
    --multi-tick 8, both under --expect-pallas (every decode tick on the
    split paged-decode kernel), every request finished, no page leaked,
    the same tokens; (b) --chaos with --trace-out and
    --expect-complete-timelines at REPLAY_LLAMA on the phase's own chaos
    trace (under --expect-pallas, faults injected, survivors exact) and on
    the chaos fixture (a gate only); (c) --embedding at BERT-base widths
    on the phase's 256-request trace and on the embedding fixture (a gate
    only); (d) request migration between two Engines in this process
    (``_migration``). Rates are kept for the phase's own traces only."""
    trace = OUT_DIR / "replay_trace.jsonl"
    replay_trace(trace)
    chaos = OUT_DIR / "replay_chaos_trace.jsonl"
    chaos_trace(chaos)
    embed = OUT_DIR / "replay_embed_trace.jsonl"
    embed_trace(embed)
    fix = ROOT / "tests" / "fixtures"
    llama = REPLAY_LLAMA + REPLAY_ENGINE
    runs = {}
    for what, extra in (("plain", []), ("multi_tick_8",
                                        ["--multi-tick", "8"])):
        rep = run_replay(what, [trace] + llama + ["--expect-pallas"] + extra)
        _replay_decoder_gates(what, rep)
        runs[what] = rep
    if runs["plain"]["tokens"] != runs["multi_tick_8"]["tokens"]:
        fail("replay: --multi-tick 8 tokens differ from the plain run's")
    if not runs["multi_tick_8"]["counters"].get(
            "serving.multi_tick.dispatches"):
        fail("replay: --multi-tick 8 fused no dispatch")
    runs["chaos"] = rep = run_replay("chaos", [
        chaos, "--chaos", "--expect-pallas", "--trace-out",
        OUT_DIR / "replay_chaos_spans.json",
        "--expect-complete-timelines"] + llama)
    if not rep["chaos"]["total_injected"] or rep["leaked_pages"]:
        fail(f"replay chaos: {rep['chaos']}")
    runs["chaos_fixture"] = run_replay("chaos_fixture", [
        fix / "serving_trace_chaos.jsonl", "--chaos", "--trace-out",
        OUT_DIR / "replay_chaos_fixture_spans.json",
        "--expect-complete-timelines"] + llama)
    runs["embedding"] = rep = run_replay("embedding", [
        embed, "--embedding"] + REPLAY_BERT + EMBED_SERVICE)
    if rep["failed"] or not rep["launches"]["flash_fwd"] or \
            rep["counters"].get("kernels.flash.fwd_plain") or \
            rep["requests"] != EMBED_REQUESTS:
        fail(f"replay embedding: failed {rep['failed']}, launches "
             f"{rep['launches']}, counters {rep['counters']}")
    runs["embedding_fixture"] = run_replay("embedding_fixture", [
        fix / "serving_trace_embed.jsonl", "--embedding"] + REPLAY_BERT)
    _replay_fixture_gates(runs)
    migration = _migration(torch, mods, launches_of, reset_counts)
    out = {}
    for what, rep in runs.items():
        hd = rep.get("host_device", {})
        gate_only = what.endswith("_fixture")
        out[what] = dict(
            total_tokens=rep["total_tokens"], steps=rep["steps"],
            requests=rep["requests"], launches=rep["launches"],
            counters={k: v for k, v in rep["counters"].items()
                      if k.startswith("kernels.")},
            chaos=rep.get("chaos"), failed=rep["failed"],
            process_s=rep["process_s"], gate_only=gate_only)
        if gate_only:
            print(f"replay {what} (gate only): {rep['requests']} requests, "
                  f"{rep['total_tokens']} tokens, failed {rep['failed']}, "
                  f"launches {rep['launches']}", flush=True)
            continue
        out[what].update(
            tokens_per_sec=rep["tokens_per_sec"], wall_s=rep["wall_s"],
            device_ms_per_tick=hd.get("device_ms_per_tick", {}).get("mean"),
            host_ms_per_tick=hd.get("host_ms_per_tick", {}).get("mean"),
            host_share=hd.get("host_share"),
            fused_ticks=hd.get("multi_tick", {}).get("fused_ticks"),
            latency_ms=rep.get("latency_ms"), pad_ratio=rep.get("pad_ratio"),
            batch_fill=rep.get("batch_fill"))
        print(f"replay {what}: {rep['requests']} requests, "
              f"{rep['total_tokens']} tokens in {rep['wall_s']} s = "
              f"{rep['tokens_per_sec']} tok/s, device "
              f"{out[what]['device_ms_per_tick']} ms/tick, host "
              f"{out[what]['host_ms_per_tick']} ms/tick, failed "
              f"{rep['failed']}, launches {rep['launches']} "
              f"({rep['process_s']:.1f} s of process) on {card}", flush=True)
    out["migration"] = migration
    # phase 31 (c) holds its disaggregated replay to these tokens
    out["plain"]["tokens"] = runs["plain"]["tokens"]
    print(f"replay migration: {MIGRATE_REQUESTS} requests, moved greedy "
          f"{migration['moved_greedy']} and sampled "
          f"{migration['moved_sampled']} after step {MIGRATE_AT}: every "
          f"stream equals the uninterrupted run's, launches "
          f"{migration['launches']}", flush=True)
    return out


# -- phase 21: conv, pooling, RNN, linalg and resize on the eager surface --

#: (a) ResNet-50's stem and stage 1 at ImageNet's input, O1 bf16
RESNET_BATCH, RESNET_XCHECK_BATCH = 32, 2
#: (b) Zaremba et al.'s "large" PTB LSTM: 2 layers of 1500, vocab 10k,
#: 35 steps, batch 20, dropout 0.65, SGD at 1.0 with the norm clipped at 10
PTB = dict(vocab=10000, hidden=1500, layers=2, steps=35, batch=20,
           dropout=0.65, lr=1.0, clip=10.0)
PTB_XCHECK_BATCH = 2
#: (c) batched linalg: 64 matrices of 256 x 256, f32
LINALG_BATCH, LINALG_N = 64, 256
#: (c)'s gate, LAPACK's own test ratio: a residual or reconstruction over
#: the input's norm, and the card's eigen / singular values, determinants
#: and solutions against the CPU's, each divided by n x eps(f32), below the
#: threshold LAPACK's test suite passes at (THRESH 30 in its input files)
LINALG_THRESH = 30


def resnet_stem_stage1(nn):
    """Conv2D 7x7/2 64 - BatchNorm2D - ReLU - MaxPool2D 3x3/2 - three
    bottlenecks 64-64-256 (the first with a projection) -
    AdaptiveAvgPool2D(1) - Linear(256, 1000)."""
    class Bottleneck(nn.Layer):
        def __init__(self, cin, mid, project):
            super().__init__()
            self.conv1 = nn.Conv2D(cin, mid, 1, bias_attr=False)
            self.bn1 = nn.BatchNorm2D(mid)
            self.conv2 = nn.Conv2D(mid, mid, 3, padding=1, bias_attr=False)
            self.bn2 = nn.BatchNorm2D(mid)
            self.conv3 = nn.Conv2D(mid, 4 * mid, 1, bias_attr=False)
            self.bn3 = nn.BatchNorm2D(4 * mid)
            self.relu = nn.ReLU()
            self.project = nn.Sequential(
                nn.Conv2D(cin, 4 * mid, 1, bias_attr=False),
                nn.BatchNorm2D(4 * mid)) if project else None

        def forward(self, x):
            y = self.relu(self.bn1(self.conv1(x)))
            y = self.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
            skip = self.project(x) if self.project is not None else x
            return self.relu(y + skip)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False),
                nn.BatchNorm2D(64), nn.ReLU(), nn.MaxPool2D(3, 2, 1))
            self.stage1 = nn.Sequential(Bottleneck(64, 64, True),
                                        Bottleneck(256, 64, False),
                                        Bottleneck(256, 64, False))
            self.pool = nn.AdaptiveAvgPool2D(1)
            self.fc = nn.Linear(256, 1000)

        def forward(self, x):
            y = self.pool(self.stage1(self.stem(x)))
            return self.fc(y.reshape([y.shape[0], -1]))
    return Net()


def rnn_lm(nn, mode, dropout):
    """Embedding - dropout - 2-layer LSTM / GRU (inter-layer dropout) -
    dropout - Linear to the vocabulary."""
    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(PTB["vocab"], PTB["hidden"])
            self.drop = nn.Dropout(dropout)
            rnn = nn.LSTM if mode == "lstm" else nn.GRU
            self.rnn = rnn(PTB["hidden"], PTB["hidden"],
                           num_layers=PTB["layers"], dropout=dropout)
            self.out = nn.Linear(PTB["hidden"], PTB["vocab"])

        def forward(self, ids):
            y, _ = self.rnn(self.drop(self.emb(ids)))
            return self.out(self.drop(y))
    return LM()


def _xcheck(paddle, build, inputs, loss_of, then=None, grads_of=None):
    """One f32 forward + backward of ``build()`` on the card and of a CPU
    copy with the card's weights, on the same inputs: closeness's f32
    gate on the loss and on every gradient. The CPU copy is made before
    either runs. ``grads_of(net, *inputs) -> (loss, {name: gradient})``,
    when given, replaces ``loss_of`` and ``backward`` (a path that takes
    its gradients itself, and may update the weights after). ``then(card_model,
    card_grads)``, when given, runs before the card's model is freed and
    returns more fields for the record."""
    import torch
    res = {}
    paddle.set_device("gpu")
    card_net = build()
    paddle.set_device("cpu")
    cpu_net = build()
    cpu_net.set_state_dict(card_net.state_dict())
    for dev, net in (("gpu", card_net), ("cpu", cpu_net)):
        paddle.set_device(dev)
        tensors = [paddle.to_tensor(a) for a in inputs]
        if grads_of is not None:
            loss, grads = grads_of(net, *tensors)
            res[dev] = (torch.as_tensor(float(loss)),
                        {k: g.float().cpu() for k, g in grads.items()})
            continue
        loss = loss_of(net, *tensors)
        loss.backward()
        res[dev] = (loss._data.detach().float().cpu(),
                    {k: p.grad._data.float().cpu()
                     for k, p in net.named_parameters()
                     if p.grad is not None})
    paddle.set_device("gpu")
    loss_c = closeness(res["gpu"][0], res["cpu"][0])
    grads = {k: closeness(g, res["cpu"][1][k])
             for k, g in res["gpu"][1].items()}
    worst = max(grads, key=lambda k: grads[k]["ratio"])
    n_params = len(card_net.parameters())
    n_bn = sum(isinstance(m, paddle.nn.BatchNorm2D)
               for m in card_net.sublayers())
    rec = dict(loss_cuda=float(res["gpu"][0]), loss_cpu=float(res["cpu"][0]),
               loss_ratio=loss_c["ratio"], grads=len(grads),
               worst_grad=worst, worst_grad_ratio=grads[worst]["ratio"],
               worst_grad_max_abs_err=grads[worst]["max_abs_err"])
    if len(grads) != n_params or len(res["cpu"][1]) != n_params or \
            loss_c["ratio"] > 1 or grads[worst]["ratio"] > 1:
        fail(f"card-vs-CPU check off ({n_params} parameters): {rec}")
    if then is not None:
        rec.update(then(card_net, res["gpu"][1]))
    del card_net
    torch.cuda.empty_cache()
    return rec


def _train_steps(torch, paddle, model, opt, batch_of, loss_of, amp):
    """TRAIN_STEPS steps of one fixed batch: losses, per-step event and
    host ms, peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ev_ms, host_ms = [], [], []
    for _ in range(TRAIN_STEPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        if amp:
            with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = loss_of(model, *batch_of)
        else:
            loss = loss_of(model, *batch_of)
        loss.backward()
        opt.step()
        opt.clear_grad()
        e1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    if not all(map(math.isfinite, losses)):
        fail(f"training losses not finite: {losses}")
    return dict(losses=losses, step_ms_events=statistics.median(ev_ms[1:]),
                step_ms_host=statistics.median(host_ms[1:]),
                first_step_ms=host_ms[0],
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def _resnet(torch, paddle, card):
    import numpy as np
    from paddle_tpu_torch import nn
    F = nn.functional

    def loss_of(net, x, y):
        return F.cross_entropy(net(x), y)
    rng = np.random.default_rng(31)
    xs = rng.standard_normal((RESNET_XCHECK_BATCH, 3, 224, 224)).astype(
        np.float32)
    ys = rng.integers(0, 1000, (RESNET_XCHECK_BATCH,)).astype(np.int64)
    paddle.seed(3)
    xcheck = _xcheck(paddle, lambda: resnet_stem_stage1(nn), [xs, ys],
                     loss_of)
    paddle.set_device("gpu")
    paddle.seed(4)
    net = resnet_stem_stage1(nn)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=net.parameters())
    x = paddle.randn([RESNET_BATCH, 3, 224, 224])
    y = paddle.to_tensor(rng.integers(0, 1000, (RESNET_BATCH,)))
    rec = _train_steps(torch, paddle, net, opt, (x, y), loss_of, amp=True)
    rec.update(images_per_s=RESNET_BATCH / rec["step_ms_events"] * 1e3,
               params=sum(int(np.prod(p.shape)) for p in net.parameters()),
               xcheck=xcheck)
    print(f"resnet-50 stem + stage 1: {rec['params'] / 1e6:.2f} M params, "
          f"batch {RESNET_BATCH}x3x224x224 O1 bf16 AdamW: losses "
          f"{[round(v, 4) for v in rec['losses']]}, "
          f"{rec['step_ms_events']:.2f} ms/step (events; host "
          f"{rec['step_ms_host']:.2f}) = {rec['images_per_s']:.0f} images/s, "
          f"peak {rec['peak_gb']:.2f} GB on {card}; card vs CPU (f32, batch "
          f"{RESNET_XCHECK_BATCH}): loss ratio {xcheck['loss_ratio']:.3f}, "
          f"{xcheck['grads']} gradients, worst {xcheck['worst_grad']} ratio "
          f"{xcheck['worst_grad_ratio']:.3f}", flush=True)
    del net, opt
    return rec


def _ptb(torch, paddle, card, mode):
    import numpy as np
    from paddle_tpu_torch import nn
    F = nn.functional

    def loss_of(net, ids, labels):
        logits = net(ids)
        return F.cross_entropy(logits.reshape([-1, PTB["vocab"]]),
                               labels.reshape([-1]))
    rng = np.random.default_rng(32)

    def batch(b):
        seq = rng.integers(0, PTB["vocab"], (b, PTB["steps"] + 1))
        return seq[:, :-1].astype(np.int64), seq[:, 1:].astype(np.int64)
    paddle.seed(5)
    xcheck = _xcheck(paddle, lambda: rnn_lm(nn, mode, 0.0),
                     list(batch(PTB_XCHECK_BATCH)), loss_of)
    paddle.set_device("gpu")
    paddle.seed(6)
    net = rnn_lm(nn, mode, PTB["dropout"])
    opt = paddle.optimizer.SGD(
        learning_rate=PTB["lr"], parameters=net.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(PTB["clip"]))
    ids, labels = (paddle.to_tensor(a) for a in batch(PTB["batch"]))
    rec = _train_steps(torch, paddle, net, opt, (ids, labels), loss_of,
                       amp=False)
    tokens = PTB["batch"] * PTB["steps"]
    rec.update(tokens_per_s=tokens / rec["step_ms_events"] * 1e3,
               params=sum(int(np.prod(p.shape)) for p in net.parameters()),
               xcheck=xcheck)
    print(f"{mode} language model (PTB large: {PTB}): "
          f"{rec['params'] / 1e6:.1f} M params, f32: losses "
          f"{[round(v, 4) for v in rec['losses']]}, "
          f"{rec['step_ms_events']:.2f} ms/step (events; host "
          f"{rec['step_ms_host']:.2f}) = {rec['tokens_per_s']:.0f} tokens/s, "
          f"peak {rec['peak_gb']:.2f} GB on {card}; card vs CPU (f32, "
          f"dropout 0, batch {PTB_XCHECK_BATCH}): loss ratio "
          f"{xcheck['loss_ratio']:.3f}, worst {xcheck['worst_grad']} ratio "
          f"{xcheck['worst_grad_ratio']:.3f}", flush=True)
    del net, opt
    return rec


def _rel(t, ref):
    return float((t - ref).norm() / ref.norm().clamp_min(1e-30))


def _linalg(torch, paddle, card):
    """(c): every op on the card at LINALG_BATCH x 256 x 256 f32, held by
    reconstruction / residual (relative to the input's norm) and its
    values against the same op on the CPU."""
    from paddle_tpu_torch import linalg as L
    g = torch.Generator(device="cpu").manual_seed(33)
    n = LINALG_N
    a_cpu = torch.randn(LINALG_BATCH, n, n, generator=g)
    spd_cpu = a_cpu @ a_cpu.mT / n + torch.eye(n)
    near_i = torch.eye(n) + 0.02 * a_cpu / n ** 0.5
    b_cpu = torch.randn(LINALG_BATCH, n, 4, generator=g)
    paddle.set_device("gpu")
    a, spd, ni, b = (paddle.to_tensor(t.cuda()) for t in
                     (a_cpu, spd_cpu, near_i, b_cpu))
    eye = torch.eye(n, device="cuda")
    res, ms = {}, {}

    def timed(name, fn):
        out = fn()
        ms[name] = cuda_ms(fn, iters=3, warmup=1)
        return out
    Lc = timed("cholesky", lambda: L.cholesky(spd))._data
    res["cholesky"] = _rel(Lc @ Lc.mT, spd._data)
    q, r = (t._data for t in timed("qr", lambda: L.qr(a)))
    res["qr"] = max(_rel(q @ r, a._data), _rel(q.mT @ q, eye))
    u, s, vh = (t._data for t in timed("svd", lambda: L.svd(a)))
    res["svd"] = _rel((u * s[..., None, :]) @ vh, a._data)
    w, v = (t._data for t in timed("eigh", lambda: L.eigh(spd)))
    res["eigh"] = _rel((v * w[..., None, :]) @ v.mT, spd._data)
    x = timed("solve", lambda: L.solve(spd, b))._data
    res["solve"] = _rel(spd._data @ x, b._data)
    # least squares on the (full-rank) SPD batch: the optimum solves it
    sol = timed("lstsq", lambda: L.lstsq(spd, b))[0]._data
    res["lstsq"] = _rel(spd._data @ sol, b._data)
    inv = timed("inv", lambda: L.inv(spd))._data
    res["inv"] = _rel(spd._data @ inv, eye.expand_as(inv))
    det = timed("det", lambda: L.det(ni))._data
    agree = dict(
        eigh=_rel(w.cpu(), torch.linalg.eigvalsh(spd_cpu)),
        svd=_rel(s.cpu(), torch.linalg.svdvals(a_cpu)),
        det=_rel(det.cpu(), torch.linalg.det(near_i)),
        solve=_rel(x.cpu(), torch.linalg.solve(spd_cpu, b_cpu)),
        lstsq=_rel(sol.cpu(), torch.linalg.solve(spd_cpu, b_cpu)))
    unit = n * torch.finfo(torch.float32).eps
    ratio = {k: v / unit for k, v in {**res, **{
        f"{k}_vs_cpu": v for k, v in agree.items()}}.items()}
    rec = dict(batch=LINALG_BATCH, n=n, residual=res, cpu_agreement=agree,
               ratio=ratio, ms=ms, thresh=LINALG_THRESH)
    print(f"linalg on the card, {LINALG_BATCH} x {n} x {n} f32: residuals "
          f"{ {k: f'{v:.1e}' for k, v in res.items()} }, CPU agreement "
          f"{ {k: f'{v:.1e}' for k, v in agree.items()} }, worst / (n eps) "
          f"{max(ratio.values()):.2f} ({max(ratio, key=ratio.get)}; pass < "
          f"{LINALG_THRESH}), ms "
          f"{ {k: round(v, 3) for k, v in ms.items()} } on {card}",
          flush=True)
    if not max(ratio.values()) < LINALG_THRESH:
        fail(f"linalg off: {rec}")
    return rec


def _resize(torch, paddle, card):
    """(d): interpolate in every mode, down and up, grid_sample and fold on
    the card against the CPU, within closeness's f32 gate."""
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator(device="cpu").manual_seed(34)
    x2 = torch.randn(8, 16, 64, 64, generator=g)
    x1 = torch.randn(8, 16, 100, generator=g)
    x3 = torch.randn(2, 4, 16, 16, 16, generator=g)
    theta = torch.randn(8, 2, 3, generator=g) * 0.3 + torch.tensor(
        [[1.0, 0, 0], [0, 1.0, 0]])
    cases = {}
    for mode in ("nearest", "bilinear", "bicubic", "area"):
        for size in ((23, 29), (97, 111)):
            cases[f"{mode}_{size[0]}x{size[1]}"] = (
                lambda t, m=mode, s=size: F.interpolate(t, size=list(s),
                                                        mode=m), x2)
    cases["linear_down"] = (lambda t: F.interpolate(
        t, size=[37], mode="linear", data_format="NCW"), x1)
    cases["linear_up"] = (lambda t: F.interpolate(
        t, size=[251], mode="linear", data_format="NCW"), x1)
    cases["trilinear_up"] = (lambda t: F.interpolate(
        t, size=[24, 20, 32], mode="trilinear", data_format="NCDHW"), x3)
    cases["trilinear_down"] = (lambda t: F.interpolate(
        t, size=[7, 9, 5], mode="trilinear", data_format="NCDHW"), x3)
    for pad in ("zeros", "border", "reflection"):
        cases[f"grid_sample_{pad}"] = (
            lambda t, p=pad: F.grid_sample(t, F.affine_grid(
                paddle.to_tensor(theta.to(t._data.device)), [8, 16, 48, 56],
                align_corners=False), padding_mode=p), x2)
    cols = F.unfold(paddle.to_tensor(x2), [3, 3], strides=2, paddings=1)
    cols_cpu = cols._data.detach().cpu()
    cases["fold"] = (lambda t: F.fold(t, [64, 64], [3, 3], strides=2,
                                      paddings=1), cols_cpu)
    worst = {}
    for name, (fn, inp) in cases.items():
        outs = {}
        for dev in ("gpu", "cpu"):
            paddle.set_device(dev)
            outs[dev] = fn(paddle.to_tensor(inp))._data.float().cpu()
        worst[name] = closeness(outs["gpu"], outs["cpu"])["ratio"]
    paddle.set_device("gpu")
    bad = {k: v for k, v in worst.items() if not v <= 1}
    print(f"resize / grid / fold on the card vs the CPU: {len(worst)} "
          f"cases, worst ratio {max(worst.values()):.3f} "
          f"({max(worst, key=worst.get)}); pass <= 1", flush=True)
    if bad:
        fail(f"resize cases off the CPU: {bad}")
    return dict(cases=worst)


def eager_new_surface(torch, card):
    """Phase 21: the eager surface's new modules on the card
    (``set_device("gpu")``): (a) ResNet-50's stem and stage 1, (b) PTB
    large LSTM and GRU language models, (c) batched linalg, (d) resize,
    grid sampling and fold, each against the CPU."""
    import paddle_tpu_torch as paddle
    out = dict(resnet=_resnet(torch, paddle, card))
    torch.cuda.empty_cache()
    for mode in ("lstm", "gru"):
        out[mode] = _ptb(torch, paddle, card, mode)
        torch.cuda.empty_cache()
    out["linalg"] = _linalg(torch, paddle, card)
    out["resize"] = _resize(torch, paddle, card)
    torch.cuda.empty_cache()
    return out


# -- phase 22: paddle.Model on the card, and the jit.save predictor ---------

#: phase 22's data: HAPI_N training and HAPI_EVAL_N eval sequences of
#: profile_eager.SEQ tokens drawn from HAPI_SEED (the eval set from the
#: next seed); each sequence starts with one of two marker tokens and the
#: label names which, so accuracy can rise
HAPI_N, HAPI_EVAL_N, HAPI_SEED, HAPI_MARKERS = 256, 64, 22, (1000, 2000)
HAPI_EPOCHS, HAPI_WORKERS = 2, 2
#: the card-vs-CPU copy: 2 layers, dropout 0, f32, a batch of 4
HAPI_XCHECK_LAYERS, HAPI_XCHECK_BATCH = 2, 4
#: steps timed through train_batch (a float(loss) read each) and through
#: the train step alone (one read at the end), HAPI_SYNC_PAIRS times each
HAPI_SYNC_STEPS, HAPI_SYNC_PAIRS = 4, 3
#: the predictor's input: [PREDICT_BATCH, PREDICT_SEQ] int64 ids; runs
#: timed; the element of the first layer's qkv weight the negative
#: control moves, and by how much
PREDICT_BATCH, PREDICT_SEQ, PREDICT_RUNS = 32, 128, 10
PREDICT_PERTURB = ("encoder.0.attention.qkv.weight", (0, 0), 1.0)


def hapi_network(paddle, ep, layers=None, dropout=None):
    """``profile_eager.build_model``'s Embedding and TransformerEncoder
    (BERT-base widths; ``layers`` and ``dropout`` to cut them), then a
    head that puts the first token into 2 classes."""
    nn = paddle.nn

    class FirstToken(nn.Layer):
        """Its Linear(d_model, 2) on the first token."""

        def __init__(self, linear):
            super().__init__()
            self.linear = linear

        def forward(self, h):
            return self.linear(h[:, 0])

    m = ep.build_model(ep.MODEL["layers"] if layers is None else layers,
                       ep.MODEL["dropout"] if dropout is None else dropout)
    return nn.Sequential(m[0], m[1], FirstToken(m[2]))


def hapi_dataset(torch, paddle, ep, n, seed):
    """A TensorDataset of n sequences on the CPU (the workers read it):
    ids [n, SEQ] and labels, the first token the label's marker."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, ep.MODEL["vocab"], (n, ep.SEQ), generator=g)
    labels = torch.randint(0, 2, (n,), generator=g)
    ids[:, 0] = torch.tensor(HAPI_MARKERS)[labels]
    return paddle.io.TensorDataset([paddle.to_tensor(ids, place="cpu"),
                                    paddle.to_tensor(labels, place="cpu")])


def _hapi_model(paddle, ep, net, lr, amp):
    model = paddle.Model(net)
    opt = paddle.optimizer.AdamW(learning_rate=lr,
                                 parameters=net.parameters(),
                                 weight_decay=ep.WEIGHT_DECAY)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy(),
                  amp_configs=amp)
    if model._train_step is None:
        fail("phase 22: Model.prepare built no TrainStep (the eager "
             "fallback ran)")
    return model


def hapi_cross_check(torch, paddle, ep):
    """Phase 22 (a), first: a 2-layer f32 copy of the network, dropout 0,
    in a prepared Model on the card (TrainStep: the tf32x3 forward, the
    simt backward) against the same weights on the CPU (the plain
    versions), through ``_xcheck``: the loss ``Model.train_batch`` reports
    and every gradient of its train step within closeness's f32 gate."""
    ds = hapi_dataset(torch, paddle, ep, HAPI_XCHECK_BATCH, HAPI_SEED)
    batch = [t._data for t in ds.tensors]

    def grads_of(net, ids, labels):
        model = _hapi_model(paddle, ep, net, EAGER_XCHECK_LR, None)
        _, grads = model._train_step.loss_and_grads((ids,), labels)
        return model.train_batch([ids], labels)[0], grads

    paddle.seed(1)
    rec = _xcheck(paddle, lambda: hapi_network(
        paddle, ep, HAPI_XCHECK_LAYERS, 0.0), batch, None,
        grads_of=grads_of)
    rec.update(layers=HAPI_XCHECK_LAYERS, batch=HAPI_XCHECK_BATCH,
               seq=ep.SEQ)
    print(f"hapi cross-check: Model.train_batch loss cuda "
          f"{rec['loss_cuda']:.6f} cpu {rec['loss_cpu']:.6f} (ratio "
          f"{rec['loss_ratio']:.3f}); {rec['grads']} gradients, worst "
          f"{rec['worst_grad']} ratio {rec['worst_grad_ratio']:.3f} (max abs "
          f"err {rec['worst_grad_max_abs_err']:.2e}); pass <= 1, "
          f"closeness's f32 gate", flush=True)
    return rec


def _step_clock(torch, paddle):
    """A callback that stamps each train batch's begin and end with the
    host clock and a CUDA event, and keeps the batch losses."""

    class StepClock(paddle.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.marks, self.losses = [], []

        def _mark(self):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return time.perf_counter(), e

        def on_epoch_begin(self, epoch, logs=None):
            self.marks.append([])

        def on_train_batch_begin(self, step, logs=None):
            self.marks[-1].append([self._mark()])

        def on_train_batch_end(self, step, logs=None):
            self.marks[-1][-1].append(self._mark())
            self.losses.append(logs["loss"])

        def timings(self):
            """(host ms, event ms) of each step, and the host ms of each
            cycle from one batch's begin to the next's in an epoch."""
            steps, cycles = [], []
            for epoch in self.marks:
                for i, ((t0, e0), (t1, e1)) in enumerate(epoch):
                    steps.append(((t1 - t0) * 1e3, e0.elapsed_time(e1)))
                    if i + 1 < len(epoch):
                        cycles.append((epoch[i + 1][0][0] - t0) * 1e3)
            return steps, cycles
    return StepClock()


def _sync_cost(torch, model, batch):
    """ms a step that the per-step float(loss) read of ``train_batch``
    costs: HAPI_SYNC_STEPS steps through ``Model.train_batch`` against as
    many through its train step with one read at the end, in turns,
    medians of HAPI_SYNC_PAIRS pairs a step."""
    ids, labels = batch

    def with_reads():
        for _ in range(HAPI_SYNC_STEPS):
            model.train_batch([ids], labels)

    def one_read():
        loss = None
        for _ in range(HAPI_SYNC_STEPS):
            loss = model._train_step((ids,), labels)
        float(loss)
    got = {"with_reads": [], "one_read": []}
    for _ in range(HAPI_SYNC_PAIRS):
        for name, fn in (("with_reads", with_reads), ("one_read", one_read)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            got[name].append((time.perf_counter() - t0) * 1e3
                             / HAPI_SYNC_STEPS)
    med = {k: statistics.median(v) for k, v in got.items()}
    return dict(ms_per_step=med, samples=got,
                cost_ms_per_step=med["with_reads"] - med["one_read"])


def hapi_main_path(torch, paddle, ep, launches_of, reset_counts, card):
    """Phase 22 (a): ``paddle.Model`` at BERT-base widths and depth, counts
    set to 0 just before and read just after: ``fit`` (HAPI_EPOCHS epochs
    of a seeded RandomSampler over HAPI_N sequences in batches of 32, two
    worker processes, O1 -> a bf16 TrainStep, AdamW on a cosine schedule
    from 2e-5, eval data every epoch, ModelCheckpoint, LRScheduler and
    EarlyStopping), ``evaluate``, ``predict(stack_outputs=True)``,
    ``save``, and a fresh Model's ``load`` + ``evaluate``."""
    import shutil
    paddle.set_device("gpu")
    paddle.seed(0)
    net = hapi_network(paddle, ep)
    n_params = sum(p.size for p in net.parameters())
    layers = ep.MODEL["layers"]
    train_ds = hapi_dataset(torch, paddle, ep, HAPI_N, HAPI_SEED)
    eval_ds = hapi_dataset(torch, paddle, ep, HAPI_EVAL_N, HAPI_SEED + 1)
    sampler = paddle.io.RandomSampler(
        train_ds, generator=torch.Generator().manual_seed(HAPI_SEED))
    train = paddle.io.DataLoader(train_ds, batch_sampler=paddle.io.BatchSampler(
        sampler=sampler, batch_size=ep.BATCH), num_workers=HAPI_WORKERS)
    evald = paddle.io.DataLoader(eval_ds, batch_size=ep.BATCH)
    steps = HAPI_EPOCHS * len(train)
    # fit and the callback each step the schedule once a batch
    sched = paddle.optimizer.lr.CosineAnnealingDecay(ep.LR, T_max=4 * steps)
    model = _hapi_model(paddle, ep, net, sched, {"level": "O1"})
    ckpt = ROOT / "build" / "chip_smoke_hapi"
    shutil.rmtree(ckpt, ignore_errors=True)
    clock = _step_clock(torch, paddle)
    cbs = [clock, paddle.callbacks.ModelCheckpoint(
        save_freq=HAPI_EPOCHS, save_dir=str(ckpt / "fit")),
        paddle.callbacks.LRScheduler(by_step=True),
        paddle.callbacks.EarlyStopping(monitor="loss", patience=HAPI_EPOCHS,
                                       verbose=0)]
    lr0 = model._optimizer.get_lr()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    model.fit(train, eval_data=evald, epochs=HAPI_EPOCHS, verbose=0,
              callbacks=cbs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    opt_lr = model._optimizer.get_lr()
    ev = model.evaluate(evald, verbose=0)
    out = model.predict(evald, stack_outputs=True)[0]
    model.save(str(ckpt / "final"))
    fresh = _hapi_model(paddle, ep, hapi_network(paddle, ep), ep.LR,
                        {"level": "O1"})
    fresh.load(str(ckpt / "final"))
    ev_loaded = fresh.evaluate(evald, verbose=0)
    torch.cuda.synchronize()
    launches = launches_of()
    counters = {k: v for k, v in paddle.monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted path --
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    files = sorted(p.name for p in (ckpt / "fit").iterdir())
    del fresh
    if not all(map(math.isfinite, clock.losses)) or \
            len(clock.losses) != steps:
        fail(f"hapi fit: {len(clock.losses)} losses for {steps} steps, "
             f"finite: {clock.losses}")
    if files != [f"{HAPI_EPOCHS - 1}.pdopt", f"{HAPI_EPOCHS - 1}.pdparams"]:
        fail(f"hapi ModelCheckpoint wrote {files}")
    if tuple(out.shape) != (HAPI_EVAL_N, 2) or \
            not torch.isfinite(torch.from_numpy(out)).all():
        fail(f"hapi predict: shape {out.shape}, values {out}")
    loss_c = closeness(torch.tensor(ev_loaded["loss"]),
                       torch.tensor(ev["loss"]))
    if loss_c["ratio"] > 1 or ev_loaded["acc"] != ev["acc"]:
        fail(f"hapi: the loaded Model evaluates {ev_loaded}, the trained "
             f"one {ev}")
    eval_fwd = len(evald) * (HAPI_EPOCHS + 3)   # fit's evals, evaluate,
    want_tc = layers * steps                     # predict, the loaded one
    # the bf16 steps on the wgmma kernels, the f32 evaluations on tf32x3
    got = check_routes(counters, {
        **{n: want_tc for n in FLASH_ROUTES if "_cuda_tc" in n},
        "fwd_cuda_tf32x3": layers * eval_fwd}, "hapi")
    if launches["flash_fwd"] != want_tc + layers * eval_fwd or \
            launches["flash_bwd_dq"] != want_tc or \
            launches["flash_bwd_dkv"] != want_tc:
        fail(f"hapi launches {launches}")
    if counters.get("kernels.optimizer.adam_fused") != steps or \
            counters.get("kernels.optimizer.adam_plain", 0) or \
            launches["fused_adam"] != steps:
        fail(f"hapi optimizer routes: {counters}, launches {launches}")
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if plain:
        fail(f"hapi path ran plain versions: {plain}")
    sync = _sync_cost(torch, model, next(iter(train)))
    med = statistics.median
    step_t, cycles = clock.timings()
    step_host = med(h for h, _ in step_t[1:])
    step_ev = med(e for _, e in step_t[1:])
    cycle = med(cycles[1:])
    rec = dict(params=n_params, batch=ep.BATCH, seq=ep.SEQ, steps=steps,
               epochs=HAPI_EPOCHS, workers=HAPI_WORKERS,
               eval_batches=len(evald), losses=clock.losses,
               lr_first=lr0, lr_last=opt_lr, evaluate=ev,
               evaluate_loaded=ev_loaded, fit_s=fit_s,
               step_ms_host=step_host, step_ms_events=step_ev,
               cycle_ms=cycle, samples_per_s=ep.BATCH / cycle * 1e3,
               host_outside_device_share=(cycle - step_ev) / cycle,
               step_host_ms=[h for h, _ in step_t],
               step_events_ms=[e for _, e in step_t], cycles_ms=cycles,
               float_loss_sync=sync, peak_mem_gb=peak_gb,
               flash_routes=got,
               launches=launches, counters=counters, checkpoints=files)
    print(f"hapi Model.fit: {n_params / 1e6:.1f} M params, {steps} steps "
          f"of {ep.BATCH} x {ep.SEQ} (O1 -> bf16 TrainStep, {HAPI_WORKERS} "
          f"workers), losses {clock.losses[0]:.4f} -> "
          f"{clock.losses[-1]:.4f}, eval {ev}; median step "
          f"{step_host:.2f} ms host / {step_ev:.2f} ms events, cycle "
          f"{cycle:.2f} ms = {rec['samples_per_s']:.1f} samples/s, host "
          f"outside the device {rec['host_outside_device_share']:.3f} of a "
          f"cycle; float(loss) read {sync['cost_ms_per_step']:.2f} ms a "
          f"step ({sync['ms_per_step']}); peak memory {peak_gb:.1f} GB; "
          f"launches wgmma {want_tc} x3, tf32x3 {layers * eval_fwd}, fused "
          f"Adam {launches['fused_adam']} on {card}", flush=True)
    del model, net
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def predictor_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 22 (b): ``jit.save`` of the f32 BertModel of
    ``bench_bert_embedding`` (BERT-base, seed 0) at [32, 128] int64,
    ``create_predictor(Config(...))``, handles and ``run``, counted around
    one run: the outputs within closeness's f32 gate of the eager forward
    on the card, 12 tf32x3 flash launches inside the exported program,
    the loaded ``.pdiparams`` equal to the model's state dict; a copy of
    the artifact with one attention weight moved must fail the gate."""
    import pickle
    import shutil

    import numpy as np
    from paddle_tpu_torch import inference, jit
    E = mods.enc.BERT_EMBED
    cfg = mods.BertConfig(**E["model"])
    model = mods.BertModel(cfg, seed=E["seed"]).eval()
    d = ROOT / "build" / "chip_smoke_predictor"
    shutil.rmtree(d, ignore_errors=True)
    prefix = str(d / "bert")
    t0 = time.perf_counter()
    jit.save(model, prefix, input_spec=[jit.InputSpec(
        [PREDICT_BATCH, PREDICT_SEQ], "int64")])
    save_s = time.perf_counter() - t0
    ids = torch.randint(0, cfg.vocab_size, (PREDICT_BATCH, PREDICT_SEQ),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = [t.cpu() for t in model(ids.cuda())]
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    with open(prefix + ".pdiparams", "rb") as f:
        st = pickle.load(f)
    arrays = {**st["params"], **st["frozen"], **st["buffers"]}
    diff = sorted(k for k in set(sd) | set(arrays) if k not in sd or
                  k not in arrays or not torch.equal(
                      torch.from_numpy(np.asarray(arrays[k])), sd[k]))
    if diff or st["n_inputs"] != 1:
        fail(f"predictor: .pdiparams differ from the state dict at {diff}")

    def predictor(path):
        t = time.perf_counter()
        pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
        pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(
            ids.numpy())
        return pred, time.perf_counter() - t

    def outputs(pred):
        return [torch.from_numpy(pred.get_output_handle(n).copy_to_cpu())
                for n in pred.get_output_names()]
    pred, load_s = predictor(prefix)
    pred.run()                                   # first run, uncounted
    torch.cuda.synchronize()
    reset_counts()
    pred.run()
    torch.cuda.synchronize()
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted run --
    got = outputs(pred)
    layers = cfg.num_hidden_layers
    check_f32_routes(counters, layers, "predictor")
    if launches["flash_fwd"] != layers:
        fail(f"predictor: {launches['flash_fwd']} flash launches a run, "
             f"expected {layers}")
    gates = [closeness(g, w) for g, w in zip(got, want)]
    if len(got) != 2 or max(g["ratio"] for g in gates) > 1:
        fail(f"predictor output off the eager forward: {gates}")
    # timing: events around pred.run (host copies in and out included) and
    # around the loaded program on a device batch
    ids_dev = ids.cuda()
    run_ms = [cuda_ms(pred.run, iters=1, warmup=0)
              for _ in range(PREDICT_RUNS)]
    layer_ms = [cuda_ms(lambda: pred._layer(ids_dev), iters=1, warmup=0)
                for _ in range(PREDICT_RUNS)]
    # negative control: one attention weight moved in a copy
    name, idx, delta = PREDICT_PERTURB
    st["params"][name][idx] += delta
    with open(prefix + "_moved.pdiparams", "wb") as f:
        pickle.dump(st, f)
    shutil.copy(prefix + ".pdmodel", prefix + "_moved.pdmodel")
    bad, _ = predictor(prefix + "_moved")
    bad.run()
    moved = max(closeness(g, w)["ratio"] for g, w in zip(outputs(bad), want))
    if moved <= 1:
        fail(f"predictor negative control: a moved {name}{list(idx)} passed "
             f"the gate (ratio {moved:.3f})")
    med = statistics.median(run_ms)
    rec = dict(batch=PREDICT_BATCH, seq=PREDICT_SEQ, layers=layers,
               save_s=save_s, load_s=load_s,
               pdmodel_bytes=os.path.getsize(prefix + ".pdmodel"),
               pdiparams_bytes=os.path.getsize(prefix + ".pdiparams"),
               max_abs_err=max(g["max_abs_err"] for g in gates),
               ratio=max(g["ratio"] for g in gates), gates=gates,
               run_ms=run_ms, run_ms_median=med,
               program_ms=layer_ms,
               program_ms_median=statistics.median(layer_ms),
               sequences_per_s=PREDICT_BATCH / med * 1e3,
               negative_control=dict(weight=name, index=list(idx),
                                     delta=delta, ratio=moved),
               launches=launches, counters=counters)
    print(f"predictor: BERT-base f32 exported in {save_s:.1f} s "
          f"({rec['pdmodel_bytes'] / 1e6:.1f} MB program, "
          f"{rec['pdiparams_bytes'] / 1e6:.1f} MB weights), loaded in "
          f"{load_s:.1f} s; [{PREDICT_BATCH}, {PREDICT_SEQ}] a run: {med:.2f} "
          f"ms (events, host copies in and out included; the program alone "
          f"{rec['program_ms_median']:.2f} ms) = "
          f"{rec['sequences_per_s']:.0f} sequences/s; {layers} tf32x3 "
          f"launches a run; ratio {rec['ratio']:.3f} of closeness's f32 "
          f"gate; moved weight {moved:.1f} (rejected) on {card}",
          flush=True)
    del pred, bad, model
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


# -- phase 23: weight-only int8 / int4 serving, nn.quant and incubate ------

#: (a) the Engine of phase 20's replay runs (8 slots, 16-token pages, 128
#: pages, a 64-token bucket) with a bf16 pool, over phase 20's decoder
#: trace; a warm pass, then QUANT_PASSES timed ones
QUANT_ENGINE = dict(max_slots=8, page_size=16, pool_pages=128,
                    prefill_bucket=64, max_context=256,
                    cache_dtype="bfloat16")
QUANT_PASSES = 3
#: the converted linears' bytes on the card (weights and scales) over their
#: bf16 bytes: int8 is 1 byte a weight and one bf16 scale a column (0.5 +
#: 1/K); int4 keeps its values in an int8 container, as the JAX package
#: does, plus a bf16 scale a 16-row group: 0.5625
QUANT_BYTES_LIMIT = {"int8": 0.51, "int4": 0.5625 + 1e-3}
#: the closeness gate: one teacher-forced [8, 128] forward of the int8
#: model against the same model whose converted linears hold
#: weight_dequantize(q, s) in bf16. The two differ only where the scale is
#: multiplied (after the bf16 product, one rounding more) and in the bf16
#: rounding of each dequantized weight, so both sit within bf16's own
#: rounding noise of the exact (f32) dequantized model, measured in the
#: same run as the bf16 dequantized model's distance from it: the int8
#: model's distance from the exact one, and its distance from the bf16
#: dequantized one, each at most QUANT_CLOSE_RATIO x that noise (relative
#: L2 of the logits)
QUANT_TF = (8, 128)
QUANT_CLOSE_RATIO = 2.0
#: (b) generate on the int8 model: batch, prompt, new tokens
QUANT_GEN = (8, 128, 64)
#: (c) llm_int8_linear at LLaMA-7B's up projection, [T, 4096] x [4096,
#: 11008]; the outlier case (column 7 x 30, threshold 6) at the rows up to
#: INT8_OUTLIER_ROWS (its CPU route is an int32 matmul)
INT8_K, INT8_N, INT8_ROWS, INT8_OUTLIER_ROWS = 4096, 11008, (1, 8, 128,
                                                              2048), 128
#: (d) BERT-base widths, f32: batch, sequence, hidden, heads, FFN
FUSED_BERT = (32, 128, 768, 12, 3072)
#: fused_moe at ERNIE-MoE's serving widths (profile_moe: hidden 1024, FFN
#: 2816, 8 experts, top 2) over 8 slots' 128-token prefills, bf16
FUSED_MOE_TOKENS = (8, 128)
#: the bf16 gate of fused_moe against the CPU's f32 on the same bf16
#: inputs: rtol two bf16 ulps (the down product's and the combine's
#: roundings), atol 2^-4 of the output's rms (the [..., 2 x FFN]
#: intermediate rounded to bf16 before the down product: 2^-9 relative in
#: each of its 2816 terms, about 2^-8 of the rms summed)
MOE_BF16_RTOL, MOE_BF16_ATOL_RMS = 2.0 ** -6, 2.0 ** -4


def quant_trace(vocab):
    """Phase 20's decoder trace: replay_trace's prompt lengths (64-127,
    from its generator), token ids from a seed, one arrival every 10 ms."""
    import numpy as np
    rng = np.random.default_rng(20)
    lens = [int(rng.integers(REPLAY_PROMPT[0], REPLAY_PROMPT[1] + 1))
            for _ in range(REPLAY_REQUESTS)]
    ids = np.random.default_rng(23)
    return (np.arange(REPLAY_REQUESTS) * 0.010,
            [ids.integers(0, vocab, (n,)).astype(np.int64) for n in lens])


def quant_model(torch, mods, weight_dtype):
    """phase 4's LLaMA (profile_serving.MODEL) with bf16 weights from seed
    0, converted by quantize_for_inference unless ``weight_dtype`` is
    "bfloat16". Returns (model, seconds the conversion took)."""
    from paddle_tpu_torch.profile_serving import MODEL
    from paddle_tpu_torch.quantization import quantize_for_inference
    model = mods.LlamaForCausalLM(mods.LlamaConfig(**MODEL,
                                                   dtype="bfloat16"), seed=0)
    model.eval()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if weight_dtype != "bfloat16":
        quantize_for_inference(model, weight_dtype=weight_dtype)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def free_cuda(torch):
    """Collect the engines' reference cycles (a multi-tick engine's CUDA
    graphs hold their memory pool until then), then return the cache."""
    gc.collect()
    torch.cuda.empty_cache()


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def linear_bytes(torch, model):
    """(the linears' bytes — weights, scales, biases — and the model's
    parameters plus buffers, in bytes on the card; the float and the
    converted linears counted)."""
    from paddle_tpu_torch.quantization import WeightOnlyLinear
    lin = sum(_nbytes(list(m.parameters(recurse=False))
                      + list(m.buffers(recurse=False)))
              for m in model.modules()
              if isinstance(m, (torch.nn.Linear, WeightOnlyLinear)))
    return lin, _nbytes(list(model.parameters()) + list(model.buffers()))


def quant_serve(torch, mods, what, model, trace, ref, launches_of,
                reset_counts, card, multi_tick=1):
    """(a): one Engine over ``model``: a warm pass of the trace, then
    QUANT_PASSES timed passes counted together (counts to 0 just before,
    read just after): every request finished at full length each pass, no
    page leaked, paged-decode launches == device ticks x layers, all on
    the split kernel, no plain call; under multi_tick no graph captured
    after the warm pass. tokens/s (median, spread), the parameters' and
    buffers' bytes, the peak allocated, the share of greedy tokens equal
    to ``ref`` (the bf16 model's first timed pass) and the device ms of a
    decode tick's linears (``decode_linears_ms``)."""
    L = model.config.num_hidden_layers
    eng = mods.Engine(model, multi_tick=multi_tick, **QUANT_ENGINE)
    drive_trace(torch, eng, mods.SamplingParams, trace, REPLAY_NEW)
    graphs = list(eng._multi.captured) if multi_tick > 1 else []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ticks0, passes = eng.decode_ticks, []
    for _ in range(QUANT_PASSES):
        outs, secs, _ = drive_trace(torch, eng, mods.SamplingParams, trace,
                                    REPLAY_NEW)
        passes.append((outs, secs))
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith(("kernels.", "serving."))}
    peak = torch.cuda.max_memory_allocated()
    # -- end of the counted run --
    ticks = eng.decode_ticks - ticks0
    for outs, _ in passes:
        bad = [o for o in outs if not o.ok or len(o.token_ids) != REPLAY_NEW]
        if len(outs) != REPLAY_REQUESTS or bad:
            fail(f"quant {what}: {len(outs)} outputs, failed/short: "
                 f"{bad[:2]}")
    if eng.leaked_pages():
        fail(f"quant {what}: {eng.leaked_pages()} pages leaked")
    n_pd = launches["paged_decode"]
    if n_pd != ticks * L or counters.get("kernels.decode.paged_cuda") != \
            n_pd or any(v for k, v in counters.items()
                        if k.endswith("_plain")):
        fail(f"quant {what}: paged-decode launches {n_pd} != {ticks} ticks "
             f"x {L}, or a plain call: {counters}")
    check_paged_split(counters, n_pd, f"quant {what}")
    if multi_tick > 1 and (list(eng._multi.captured) != graphs
                           or not counters.get(
                               "serving.multi_tick.dispatches")):
        fail(f"quant {what}: graphs {graphs} after the warm pass, "
             f"{eng._multi.captured} after the timed ones, dispatches "
             f"{counters.get('serving.multi_tick.dispatches')}")
    tokens = [o.token_ids for o in passes[0][0]]
    n_tok = sum(len(t) for t in tokens)
    rates = sorted(n_tok / s for _, s in passes)
    same = 1.0 if ref is None else sum(
        int(a == b) for t, r in zip(tokens, ref) for a, b in zip(t, r)) / \
        n_tok
    lin_b, all_b = linear_bytes(torch, model)
    lin_ms = decode_linears_ms(torch, model)
    rec = dict(weights=what, multi_tick=multi_tick, requests=REPLAY_REQUESTS,
               tokens_per_pass=n_tok, passes=QUANT_PASSES,
               seconds=[s for _, s in passes],
               tokens_per_s=rates, tokens_per_s_median=rates[len(rates) // 2],
               tokens_per_s_spread=rates[-1] - rates[0], decode_ticks=ticks,
               ms_per_tick=sum(s for _, s in passes) * 1e3 / ticks,
               linear_bytes=lin_b, model_bytes=all_b, peak_allocated=peak,
               decode_linears_ms=lin_ms,
               decode_linears_bound_ms=lin_b / HBM_BYTES_PER_S * 1e3,
               greedy_equal_to_bf16=same, graphs=graphs,
               launches=launches, counters=counters)
    print(f"  {what}{' k=%d' % multi_tick if multi_tick > 1 else ''}: "
          f"{n_tok} tokens a pass, {QUANT_PASSES} passes: "
          f"{rec['tokens_per_s_median']:.1f} tok/s median (spread "
          f"{rec['tokens_per_s_spread']:.1f}), {ticks} device ticks, "
          f"{rec['ms_per_tick']:.3f} wall ms a tick, its 29 linears "
          f"{lin_ms:.4f} device ms (their bytes once at the HBM rate: "
          f"{rec['decode_linears_bound_ms']:.4f}); parameters + buffers "
          f"{all_b / 1e9:.3f} GB (linears {lin_b / 1e9:.3f}), peak "
          f"allocated {peak / 1e9:.3f} GB; greedy tokens equal to bf16's "
          f"{same:.4f}; paged decode {n_pd} on the split kernel on {card}",
          flush=True)
    del eng
    free_cuda(torch)
    return rec, tokens


def decode_linears_ms(torch, model):
    """Device ms of a decode tick's linears: each linear (float or
    converted) timed with CUDA events on an [8, in] bf16 input (the
    QUANT_ENGINE slots' tokens), summed."""
    from paddle_tpu_torch.quantization import WeightOnlyLinear
    g = torch.Generator(device="cuda").manual_seed(19)
    xs, total = {}, 0.0
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Linear, WeightOnlyLinear)):
                k = m.in_features
                if k not in xs:
                    xs[k] = torch.randn(QUANT_ENGINE["max_slots"], k,
                                        generator=g, device="cuda",
                                        dtype=torch.bfloat16)
                total += cuda_ms(lambda: m(xs[k]))
    return total


def dequantized_copy(torch, model, dtype):
    """A copy of a converted ``model`` in ``dtype`` whose WeightOnlyLinears
    are torch.nn.Linears holding weight_dequantize(q, s) (rounded to
    ``dtype``)."""
    import copy
    from paddle_tpu_torch.quantization import WeightOnlyLinear
    from paddle_tpu_torch.quantization.functional import weight_dequantize
    ref = copy.deepcopy(model)
    for mod in list(ref.modules()):
        for name, c in list(mod.named_children()):
            if isinstance(c, WeightOnlyLinear):
                lin = torch.nn.Linear(c.in_features, c.out_features,
                                      bias=c.bias is not None, device="meta")
                lin.weight = torch.nn.Parameter(weight_dequantize(
                    c.weight, c.weight_scale).t().contiguous().to(dtype),
                    requires_grad=False)
                if c.bias is not None:
                    lin.bias = torch.nn.Parameter(c.bias.to(dtype),
                                                  requires_grad=False)
                setattr(mod, name, lin)
    return ref.to(dtype)


def quant_closeness(torch, model):
    """(a)'s closeness gate (QUANT_CLOSE_RATIO)."""
    b, s = QUANT_TF
    ids = torch.randint(0, model.config.vocab_size, (b, s),
                        generator=torch.Generator(device="cuda").manual_seed(
                            17), device="cuda")
    with torch.no_grad():
        got = model(ids).float()
        ref16 = dequantized_copy(torch, model, torch.bfloat16)
        want = ref16(ids).float()
        del ref16
        ref32 = dequantized_copy(torch, model, torch.float32)
        exact = ref32(ids).float()
        del ref32
    torch.cuda.empty_cache()

    def rel(a, r):
        return float((a - r).norm() / r.norm())
    noise = rel(want, exact)
    rec = dict(rel_l2=rel(got, want), int8_vs_exact=rel(got, exact),
               bf16_dequant_vs_exact=noise, bound_ratio=QUANT_CLOSE_RATIO,
               max_abs_err=float((got - want).abs().max()),
               argmax_equal=float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean()))
    rec["ratio"] = max(rec["rel_l2"], rec["int8_vs_exact"]) / max(
        noise, 1e-30)
    print(f"  closeness, [{b}, {s}] teacher-forced logits, relative L2: "
          f"int8 vs the bf16 dequantized weights {rec['rel_l2']:.6f}, int8 "
          f"vs the exact f32 dequantized model {rec['int8_vs_exact']:.6f}, "
          f"bf16 dequantized vs exact (bf16's noise) {noise:.6f}: "
          f"{rec['ratio']:.3f} x the noise (bound {QUANT_CLOSE_RATIO}); "
          f"argmax equal {rec['argmax_equal']:.4f}", flush=True)
    if not math.isfinite(rec["ratio"]) or rec["ratio"] > QUANT_CLOSE_RATIO:
        fail(f"quant closeness: {rec}")
    return rec


def quant_generate(torch, mods, model, launches_of, reset_counts, card):
    """(b): generate on the int8 model over the paged bf16 and int8 KV
    caches, each counted on its own (after an uncounted warm-up of 4
    tokens): the logits of every forward finite, paged-decode launches ==
    (new - 1) steps x layers on the split kernel, no plain call; ms a
    decode step (the median interval between forwards on the card's
    events) and tokens/s."""
    from paddle_tpu_torch.text import generate
    b, s, new = QUANT_GEN
    L = model.config.num_hidden_layers
    ids = torch.randint(0, model.config.vocab_size, (b, s),
                        generator=torch.Generator(device="cuda").manual_seed(
                            18), device="cuda")
    res, paths = {}, {}
    for cache in ("bfloat16", "int8"):
        what = f"quant_generate_{cache}_cache"
        kw = dict(cache_impl="paged", page_size=16, cache_dtype=cache)
        generate(model, ids, 4, **kw)
        events, finite = [], []

        def pre(*_):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        def post(m, inputs, out):
            logits = out[0] if isinstance(out, tuple) else out
            finite.append(torch.isfinite(logits).all())
        hooks = [model.register_forward_pre_hook(pre),
                 model.register_forward_hook(post)]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        try:
            out = generate(model, ids, new, **kw)
        finally:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launches_of()
        counters = {k: v for k, v in mods.monitor.snapshot().items()
                    if k.startswith("kernels.")}
        # -- end of the counted run --
        steps = new - 1
        if tuple(out.shape) != (b, s + new) or not bool(
                torch.stack(finite).all()):
            fail(f"quant {what}: shape {tuple(out.shape)}, finite logits "
                 f"{[bool(f) for f in finite]}")
        if launches["paged_decode"] != steps * L or any(
                v for k, v in counters.items() if k.endswith("_plain")):
            fail(f"quant {what}: paged-decode launches "
                 f"{launches['paged_decode']} != {steps} x {L}, or a plain "
                 f"call: {counters}")
        check_paged_split(counters, steps * L, f"quant {what}")
        dev = sorted(a.elapsed_time(c) for a, c in zip(events[1:],
                                                       events[2:]))
        res[what] = dict(batch=b, prompt=s, new_tokens=new, seconds=secs,
                         tokens_per_s=b * new / secs,
                         ms_per_step=dev[len(dev) // 2],
                         forwards=len(events), counters=counters)
        paths[what] = launches
        print(f"  {what}: {b} x {new} tokens in {secs:.3f} s = "
              f"{b * new / secs:.1f} tok/s, a decode step {dev[len(dev) // 2]:.3f} "
              f"ms (median, events), {launches['paged_decode']} paged-decode "
              f"launches on {card}", flush=True)
    return res, paths


def int8_linear_check(torch, card):
    """(c): llm_int8_linear at [T, INT8_K] x [INT8_K, INT8_N]: at threshold
    0 the card's output equals the CPU route's bit for bit (the int32
    product is exact on both, the scaling the same f32 elementwise ops);
    with an outlier column (x 30, threshold 6) within closeness's f32 gate
    of the CPU's; ms (events) beside bf16 torch.matmul of the same shape
    and weight_only_linear (int8, per-column scales) on bf16 inputs."""
    from paddle_tpu_torch.nn import quant
    g = torch.Generator(device="cuda").manual_seed(31)
    w = torch.randn(INT8_K, INT8_N, generator=g, device="cuda") * 0.02
    q, s = quant.weight_quantize(w, algo="llm.int8")
    qc, sc = q.cpu(), s.cpu()
    wb = w.to(torch.bfloat16)
    q8, s8 = quant.weight_quantize(wb)
    out = []
    for t in INT8_ROWS:
        x = torch.randn(t, INT8_K, generator=g, device="cuda")
        got = quant.llm_int8_linear(x, q, None, s, threshold=0.0)
        want = quant.llm_int8_linear(x.cpu(), qc, None, sc, threshold=0.0)
        rec = dict(rows=t, bit_equal=bool(torch.equal(got.cpu(), want)))
        if not rec["bit_equal"]:
            fail(f"llm_int8_linear [{t}, {INT8_K}]: the card differs from "
                 f"the CPU route at threshold 0, max "
                 f"{max_err(got.cpu(), want)}")
        if t <= INT8_OUTLIER_ROWS:
            xo = x.clone()
            xo[:, 7] *= 30.0
            c = closeness(quant.llm_int8_linear(xo, q, None, s).cpu(),
                          quant.llm_int8_linear(xo.cpu(), qc, None, sc))
            if c["ratio"] > 1:
                fail(f"llm_int8_linear [{t}, {INT8_K}] with outliers: {c}")
            rec["outliers"] = c
            rec["outlier_ms"] = cuda_ms(
                lambda: quant.llm_int8_linear(xo, q, None, s))
        xb = x.to(torch.bfloat16)
        rec.update(ms=cuda_ms(lambda: quant.llm_int8_linear(
            x, q, None, s, threshold=0.0)),
            bf16_matmul_ms=cuda_ms(lambda: xb @ wb),
            weight_only_int8_ms=cuda_ms(
                lambda: quant.weight_only_linear(xb, q8, None, s8)))
        out.append(rec)
        print(f"  llm_int8_linear [{t}, {INT8_K}] x [{INT8_K}, {INT8_N}]: "
              f"bit-equal to the CPU at threshold 0; {rec['ms']:.4f} ms "
              f"(bf16 matmul {rec['bf16_matmul_ms']:.4f}, weight_only_linear "
              f"int8 {rec['weight_only_int8_ms']:.4f})"
              + (f"; outliers {rec['outlier_ms']:.4f} ms at ratio "
                 f"{rec['outliers']['ratio']:.3f} of the f32 gate"
                 if "outliers" in rec else "") + f" on {card}", flush=True)
    return out


def fused_ops_check(torch, paddle, card):
    """(d): the fused functionals at BERT-base widths in f32 on the card
    against the same calls on the CPU (dropout 0, closeness's f32 gate),
    FusedTransformerEncoderLayer forward and backward (``_xcheck``), and
    fused_moe at ERNIE-MoE serving widths in bf16 against the CPU's f32 on
    the same bf16 inputs (MOE_BF16_*); ms of each on the card."""
    from paddle_tpu_torch import incubate
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.profile_moe import MOE_SERVE_MODEL
    B, S, H, NH, FF = FUSED_BERT
    g = torch.Generator().manual_seed(41)

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g) * scale + shift
    mask = torch.zeros(B, 1, 1, S)
    mask[::2, ..., S - 16:] = -1e4          # half the batch padded by 16
    args = {
        "fused_multi_head_attention": (
            lambda a: IF.fused_multi_head_attention(
                a["x"], a["qkv"], a["wo"], ln_scale=a["s1"], ln_bias=a["b1"],
                qkv_bias=a["bqkv"], linear_bias=a["bo"],
                attn_mask=a["mask"], dropout_rate=0.0,
                attn_dropout_rate=0.0),
            dict(x=rn(B, S, H), qkv=rn(3, NH, H // NH, H, scale=0.02),
                 wo=rn(H, H, scale=0.02), s1=rn(H, scale=0.1, shift=1.0),
                 b1=rn(H, scale=0.1), bqkv=rn(3 * H, scale=0.02),
                 bo=rn(H, scale=0.02), mask=mask)),
        "fused_feedforward": (
            lambda a: IF.fused_feedforward(
                a["x"], a["w1"], a["w2"], a["b1"], a["b2"], a["s1"],
                a["c1"], a["s2"], a["c2"], dropout1_rate=0.0,
                dropout2_rate=0.0, activation="gelu"),
            dict(x=rn(B, S, H), w1=rn(H, FF, scale=0.02),
                 w2=rn(FF, H, scale=0.02), b1=rn(FF, scale=0.02),
                 b2=rn(H, scale=0.02), s1=rn(H, scale=0.1, shift=1.0),
                 c1=rn(H, scale=0.1), s2=rn(H, scale=0.1, shift=1.0),
                 c2=rn(H, scale=0.1))),
        "fused_bias_dropout_residual_layer_norm": (
            lambda a: IF.fused_bias_dropout_residual_layer_norm(
                a["x"], a["r"], a["b"], a["s"], a["c"], dropout_rate=0.0),
            dict(x=rn(B, S, H), r=rn(B, S, H), b=rn(H, scale=0.02),
                 s=rn(H, scale=0.1, shift=1.0), c=rn(H, scale=0.1))),
    }
    res = {}
    for name, (call, a) in args.items():
        want = call(a)
        on = {k: v.cuda() for k, v in a.items()}
        c = closeness(call(on).cpu(), want)
        c["ms"] = cuda_ms(lambda: call(on))
        res[name] = c
        print(f"  {name} [{B}, {S}, {H}] f32: ratio {c['ratio']:.4f} of "
              f"closeness's f32 gate, {c['ms']:.4f} ms on {card}",
              flush=True)
        if c["ratio"] > 1:
            fail(f"{name} on the card vs the CPU: {c}")
    x_enc = rn(B, S, H).numpy()

    def grads_of(net, x):
        """The loss and every parameter's gradient; a parameter the layer
        does not use (the post-LN blocks' pre-LN ones) has zeros."""
        loss = (net(x) ** 2).mean()
        loss.backward()
        return loss, {k: torch.zeros_like(p._data) if p.grad is None
                      else p.grad._data for k, p in net.named_parameters()}

    def timed(net, grads):
        x = paddle.to_tensor(x_enc)
        fwd = cuda_ms(lambda: net(x), iters=10)
        fb = cuda_ms(lambda: (net(x) ** 2).mean().backward(), iters=10)
        return dict(forward_ms=fwd, forward_backward_ms=fb)
    enc = _xcheck(paddle, lambda: incubate.nn.FusedTransformerEncoderLayer(
        H, NH, FF, dropout_rate=0.0, activation="gelu"), [x_enc], None,
        then=timed, grads_of=grads_of)
    res["fused_transformer_encoder_layer"] = enc
    print(f"  FusedTransformerEncoderLayer [{B}, {S}, {H}] f32: loss and "
          f"{enc['grads']} gradients within closeness's f32 gate (worst "
          f"{enc['worst_grad']} at {enc['worst_grad_ratio']:.4f}); forward "
          f"{enc['forward_ms']:.3f} ms, forward + backward "
          f"{enc['forward_backward_ms']:.3f} ms on {card}", flush=True)
    d, f = MOE_SERVE_MODEL["hidden_size"], MOE_SERVE_MODEL["intermediate_size"]
    e = MOE_SERVE_MODEL["num_experts"]
    n, t = FUSED_MOE_TOKENS
    bf = [v.to(torch.bfloat16) for v in (
        rn(n, t, d), rn(n, t, e), rn(e, d, 2 * f, scale=0.02),
        rn(e, f, d, scale=0.02))]
    want = IF.fused_moe(*(v.float() for v in bf), moe_topk=2)
    on = [v.cuda() for v in bf]
    got = IF.fused_moe(*on, moe_topk=2).cpu()
    rms = float(want.square().mean().sqrt())
    c = closeness(got, want, rtol=MOE_BF16_RTOL, atol=MOE_BF16_ATOL_RMS * rms)
    c["ms"] = cuda_ms(lambda: IF.fused_moe(*on, moe_topk=2), iters=10)
    c["rms_err_over_rms"] = float((got.float() - want).square().mean()
                                  .sqrt()) / rms
    res["fused_moe"] = c
    print(f"  fused_moe [{n}, {t}, {d}] x {e} experts (FFN {f}, top 2) bf16 "
          f"vs the CPU's f32: ratio {c['ratio']:.4f} of the bf16 gate, rms "
          f"error {c['rms_err_over_rms']:.6f} of the rms, {c['ms']:.3f} ms "
          f"on {card}", flush=True)
    if c["ratio"] > 1:
        fail(f"fused_moe on the card vs the CPU: {c}")
    return res


def quant_main_path(torch, paddle, mods, launches_of, reset_counts, card):
    """Phase 23: (a) phase 20's 24-request decoder trace served by
    QUANT_ENGINE over phase 4's LLaMA at bf16 weights, then converted by
    quantize_for_inference to int8 (also at multi_tick 8: no graph
    captured after the warm pass) and to int4 (group-16 scales), each
    built from seed 0 and counted on its own (``quant_serve``), with the
    conversion's gates (29 WeightOnlyLinears, no float linear left, the
    linears' bytes within QUANT_BYTES_LIMIT of bf16's) and the closeness
    gate on the int8 model; (b) generate on the int8 model; (c)
    llm_int8_linear; (d) the fused ops. Returns (records, launches by
    counted run)."""
    from paddle_tpu_torch.quantization import WeightOnlyLinear
    print("weight-only quantized serving:", flush=True)
    res, paths = {}, {}
    model, _ = quant_model(torch, mods, "bfloat16")
    trace = quant_trace(model.config.vocab_size)
    res["bfloat16"], ref = quant_serve(torch, mods, "bfloat16", model,
                                       trace, None, launches_of,
                                       reset_counts, card)
    bf16_linear_bytes = res["bfloat16"]["linear_bytes"]
    del model
    free_cuda(torch)
    for wd in ("int8", "int4"):
        model, conv_s = quant_model(torch, mods, wd)
        n_wol = sum(isinstance(m, WeightOnlyLinear) for m in model.modules())
        n_float = sum(isinstance(m, torch.nn.Linear)
                      for m in model.modules())
        L = model.config.num_hidden_layers
        if n_wol != 7 * L + 1 or n_float:
            fail(f"quant {wd}: {n_wol} WeightOnlyLinears (want {7 * L + 1}),"
                 f" {n_float} float linears left")
        rec, _ = quant_serve(torch, mods, wd, model, trace, ref,
                             launches_of, reset_counts, card)
        rec.update(weight_only_linears=n_wol, convert_s=conv_s,
                   linear_bytes_ratio=rec["linear_bytes"]
                   / bf16_linear_bytes)
        print(f"  {wd}: {n_wol} WeightOnlyLinears converted in "
              f"{conv_s:.2f} s; the linears' bytes "
              f"{rec['linear_bytes_ratio']:.4f} of bf16's (limit "
              f"{QUANT_BYTES_LIMIT[wd]})", flush=True)
        if rec["linear_bytes_ratio"] > QUANT_BYTES_LIMIT[wd]:
            fail(f"quant {wd}: linears at {rec['linear_bytes_ratio']} of "
                 f"bf16's bytes")
        res[wd] = rec
        if wd == "int8":
            res["int8_multi_tick_8"], _ = quant_serve(
                torch, mods, "int8", model, trace, ref, launches_of,
                reset_counts, card, multi_tick=8)
            res["closeness"] = quant_closeness(torch, model)
            gen, gen_paths = quant_generate(torch, mods, model, launches_of,
                                            reset_counts, card)
            res.update(gen)
            paths.update(gen_paths)
        del model
        free_cuda(torch)
    for wd in ("bfloat16", "int8", "int8_multi_tick_8", "int4"):
        paths[f"quant_serving_{wd}"] = res[wd].pop("launches")
    res["llm_int8_linear"] = int8_linear_check(torch, card)
    res["fused_ops"] = fused_ops_check(torch, paddle, card)
    torch.cuda.empty_cache()
    return res, paths


# -- phase 24: the profiler and debugging surface ---------------------------

#: phase 24's schedule: one closed step, one READY step (the torch
#: profiler's CUPTI set-up), PROFILE_RECORD recorded steps, once
PROFILE_RECORD = 4
PROFILE_SCHEDULE = dict(closed=1, ready=1, record=PROFILE_RECORD, repeat=1)
PROFILE_STEPS = 2 + PROFILE_RECORD
#: kernels the device view must show, by the wrapper count they equal
PROFILE_KERNELS = {"flash_fwd_wgmma_kernel": "flash_fwd",
                   "flash_bwd_dq_wgmma_kernel": "flash_bwd_dq",
                   "flash_bwd_dkv_wgmma_kernel": "flash_bwd_dkv",
                   "fused_adam_kernel": "fused_adam"}
#: the torch profiler's own traces (large; not brought back)
PROFILE_LOG_DIR = ROOT / "build" / "profiler_log"


def _profiled_loop(torch, ep, model, opt, batch, steps, prof=None,
                   probe=None):
    """``steps`` steps of phase 19's loop, each inside
    ``RecordEvent("train_step")``, the card synchronised after each, then
    ``prof.step()`` when a profiler runs. ``probe(i, where)`` runs before
    step i's body ("before"), after its synchronize ("body") and after
    its ``prof.step()`` ("after"). Returns per step (host s to enqueue,
    wall s to the synchronize, events ms, prof.step() s)."""
    from paddle_tpu_torch.profiler import RecordEvent
    enq, wall, ev, pstep = [], [], [], []
    for i in range(steps):
        if probe:
            probe(i, "before")
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        with RecordEvent("train_step"):
            loss = ep.forward_loss(model, batch)
            loss.backward()
            opt.step()
            opt.clear_grad()
        e1.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enq.append(t1 - t0)
        wall.append(t2 - t0)
        ev.append(e0.elapsed_time(e1))
        if probe:
            probe(i, "body")
        t3 = time.perf_counter()
        if prof is not None:
            prof.step()
        pstep.append(time.perf_counter() - t3)
        if probe:
            probe(i, "after")
    return enq, wall, ev, pstep


def _step_medians(enq, wall, ev, window):
    med = statistics.median
    return dict(ms_per_step=med(wall[window]) * 1e3,
                events_ms_per_step=med(ev[window]),
                host_ms_per_step=med(enq[window]) * 1e3,
                step_ms=[w * 1e3 for w in wall[window]])


def profiler_main_path(torch, paddle, ep, dispatch, launches_of,
                       reset_counts, card):
    """Phase 24 (a): phase 19's loop at BERT-base width and depth under
    ``paddle.profiler`` (targets CPU + GPU, one closed, one READY and
    PROFILE_RECORD recorded steps, memory and shapes recorded, the
    chrome trace exported), counts set to 0 just before and read just
    after; beside it the same loop with the profiler closed and with
    ``timer_only=True``."""
    from paddle_tpu_torch import profiler as P
    paddle.set_device("gpu")
    paddle.seed(0)
    model = ep.build_model()
    opt = ep.make_optimizer(model)
    batch, _ = ep.fixed_batch()
    window = slice(2, PROFILE_STEPS)       # the recorded steps
    _profiled_loop(torch, ep, model, opt, batch, 2)          # warm
    closed = _step_medians(*_profiled_loop(
        torch, ep, model, opt, batch, PROFILE_STEPS)[:3], window)

    def profiler(**kw):
        return P.Profiler(
            targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU],
            scheduler=P.make_scheduler(**PROFILE_SCHEDULE),
            profile_memory=True, record_shapes=True,
            log_dir=str(PROFILE_LOG_DIR), **kw)

    with profiler(timer_only=True) as p:
        timer_only = _step_medians(*_profiled_loop(
            torch, ep, model, opt, batch, PROFILE_STEPS, p)[:3], window)

    seen = {}

    def on_trace_ready(prof):
        P.export_chrome_tracing(str(OUT_DIR / "profiler"))(prof)
        rt = prof.runtime_stats   # its collectors are replaced after this
        seen.update(summary=prof.summary(row_limit=12),
                    data=prof.statistic_data, ops=rt.ops,
                    compiles=rt.compiles, memory=rt.memory)

    marks = {}

    def probe(i, where):
        if (i, where) in ((window.start, "before"),
                          (window.stop - 1, "body")):
            marks[where] = (launches_of(), dispatch.op_count)
        if where == "after" and window.start <= i < window.stop:
            marks.setdefault("max_allocated", []).append(
                torch.cuda.max_memory_allocated())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with profiler(on_trace_ready=on_trace_ready) as p:
        enq, wall, ev, pstep = _profiled_loop(torch, ep, model, opt, batch,
                                              PROFILE_STEPS, p, probe)
    launches = launches_of()
    counters = {k: v for k, v in paddle.monitor.snapshot().items()
                if k.startswith("kernels.")}
    # -- end of the counted path --
    recording = _step_medians(enq, wall, ev, window)
    trace = P.load_profiler_result(p.last_trace_path)
    (l0, n0), (l1, n1) = marks["before"], marks["body"]
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ops_in_trace = sum(e["cat"] == "op" for e in xs)
    steps_in_trace = sum(e["cat"] == "user" and e["name"] == "train_step"
                         for e in xs)
    in_trace = {}
    for e in xs:
        if e["cat"] == "kernel":
            in_trace[e["name"]] = in_trace.get(e["name"], 0) + 1
    view = seen["data"].kernel_stats
    want = {k: l1[w] - l0[w] for k, w in PROFILE_KERNELS.items()}
    got = {k: (in_trace.get(k, 0), view.get(k, {}).get("calls", 0))
           for k in PROFILE_KERNELS}
    layers = ep.MODEL["layers"]
    expect = {k: (PROFILE_RECORD if w == "fused_adam" else
                  layers * PROFILE_RECORD)
              for k, w in PROFILE_KERNELS.items()}
    if ops_in_trace != n1 - n0:
        fail(f"profiler: {ops_in_trace} dispatch spans in the trace, "
             f"dispatch.op_count rose by {n1 - n0} over the window")
    if steps_in_trace != PROFILE_RECORD:
        fail(f"profiler: {steps_in_trace} train_step spans, expected "
             f"{PROFILE_RECORD}")
    if any(got[k] != (want[k], want[k]) or want[k] != expect[k]
           for k in PROFILE_KERNELS):
        fail(f"profiler device view (trace, summary) {got}, wrapper "
             f"counts over the window {want}, expected {expect}")
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    if plain:
        fail(f"profiled path ran plain versions: {plain}")
    samples = seen["memory"].samples
    peaks = [s["peak_bytes_in_use"] for s in samples]
    if len(samples) != PROFILE_RECORD or \
            peaks != marks["max_allocated"] or \
            {s["source"] for s in samples} != {"device"} or \
            seen["memory"].peak() != marks["max_allocated"][-1]:
        fail(f"profiler memory samples {samples} against "
             f"max_memory_allocated {marks['max_allocated']}")
    churn = seen["ops"].shape_churn_report()
    recompiles = seen["compiles"].steady_state_recompiles()
    if churn or recompiles:
        fail(f"profiler: shape churn {churn}, steady-state builds "
             f"{recompiles}")
    ops_top = sorted(((n, st.calls, st.total_s * 1e3)
                      for n, st in seen["ops"].stats.items()),
                     key=lambda r: -r[2])[:10]
    kernels_top = sorted(((n, s["calls"], s["total_ms"])
                          for n, s in view.items()),
                         key=lambda r: -r[2])[:10]
    busy_ms = sum(s["total_ms"] for s in view.values()) / PROFILE_RECORD
    (OUT_DIR / "profiler" / "summary.txt").write_text(seen["summary"])
    trace_mb = sum(f.stat().st_size for f in PROFILE_LOG_DIR.glob(
        "*.pt.trace.json")) / 1e6
    rec = dict(layers=layers, batch=ep.BATCH, seq=ep.SEQ,
               schedule=PROFILE_SCHEDULE, closed=closed,
               timer_only=timer_only, recording=recording,
               prepare_s=pstep[0], trace_ready_s=pstep[window.stop - 1],
               ops_per_step=(n1 - n0) / PROFILE_RECORD,
               device_kernels=got, wrapper_launches=want,
               device_busy_ms_per_step=busy_ms,
               device_busy_share=busy_ms / recording["ms_per_step"],
               memory_peaks=peaks, peak_mem_gb=peaks[-1] / 1e9,
               ops_top=ops_top, kernels_top=kernels_top,
               chrome_trace=str(Path(p.last_trace_path).relative_to(ROOT)),
               chrome_trace_mb=Path(p.last_trace_path).stat().st_size / 1e6,
               torch_trace_mb=trace_mb, launches=launches,
               counters=counters)
    print(seen["summary"], flush=True)
    print(f"profiler (phase 19's loop, {layers} layers, batch {ep.BATCH} x "
          f"{ep.SEQ}, O1 bf16): ms a step, median of the {PROFILE_RECORD} "
          f"recorded steps (events / host to enqueue): closed "
          f"{closed['ms_per_step']:.2f} ({closed['events_ms_per_step']:.2f}"
          f" / {closed['host_ms_per_step']:.2f}), timer_only "
          f"{timer_only['ms_per_step']:.2f} "
          f"({timer_only['events_ms_per_step']:.2f} / "
          f"{timer_only['host_ms_per_step']:.2f}), recording "
          f"{recording['ms_per_step']:.2f} "
          f"({recording['events_ms_per_step']:.2f} / "
          f"{recording['host_ms_per_step']:.2f}); READY (CUPTI set-up) "
          f"{pstep[0]:.2f} s, trace ready (stop, export) "
          f"{pstep[window.stop - 1]:.2f} s; {rec['ops_per_step']:.0f} ops "
          f"a step; device view {got} == wrapper counts {want}; device "
          f"busy {busy_ms:.2f} ms a step ({rec['device_busy_share']:.3f}); "
          f"peak {peaks[-1] / 1e9:.2f} GB == max_memory_allocated; top ops "
          f"{[(n, c, round(ms, 2)) for n, c, ms in ops_top[:5]]}; top "
          f"kernels {[(n, c, round(ms, 2)) for n, c, ms in kernels_top[:5]]}"
          f"; chrome trace {rec['chrome_trace_mb']:.1f} MB, torch trace "
          f"{trace_mb:.1f} MB on {card}", flush=True)
    del opt, model
    torch.cuda.empty_cache()
    return rec


def debugging_check(torch, paddle, ep, card):
    """Phase 24 (b): ``amp.debugging`` on the card. One step of phase
    19's loop under ``enable_tensor_checker(CHECK_NAN_INF_AND_ABORT)``
    passes; negative control: with one element of the first layer's query
    weight set to inf the next step must raise FloatingPointError naming
    an op. Then ``collect_operator_stats`` over one f32 step of phase
    19's 2-layer cross-check copy on the card and on the CPU: the same
    (op, dtype) -> count table."""
    from paddle_tpu_torch.amp import debugging as D
    from paddle_tpu_torch.core import dispatch
    paddle.set_device("gpu")
    paddle.seed(0)
    model = ep.build_model()
    opt = ep.make_optimizer(model)
    batch, _ = ep.fixed_batch()
    cfg = D.TensorCheckerConfig(
        enable=True, debug_mode=D.DebugMode.CHECK_NAN_INF_AND_ABORT)
    D.enable_tensor_checker(cfg)
    try:
        t0 = time.perf_counter()
        ep.step(model, opt, batch)
        torch.cuda.synchronize()
        checked_s = time.perf_counter() - t0
        q = model[1].layers[0].self_attn.q_proj.weight
        with paddle.no_grad():
            q._data[0, 0] = float("inf")
        raised = None
        try:
            ep.step(model, opt, batch)
        except FloatingPointError as e:
            raised = str(e)
    finally:
        D.disable_tensor_checker()
        dispatch._nan_pending.clear()
    if raised is None or not raised.startswith("Op "):
        fail(f"tensor checker: an inf weight did not raise naming an op "
             f"({raised!r})")
    del opt, model
    torch.cuda.empty_cache()

    tables = {}
    for dev in ("gpu", "cpu"):
        paddle.set_device(dev)
        paddle.seed(1)
        net = ep.build_model(EAGER_XCHECK_LAYERS, 0.0)
        o = ep.make_optimizer(net, lr=EAGER_XCHECK_LR)
        b, _ = ep.fixed_batch(EAGER_XCHECK_BATCH)
        with D.collect_operator_stats():
            loss = ep.loss_of(net, *b)
            loss.backward()
            o.step()
            o.clear_grad()
        tables[dev] = D.operator_stats()
    paddle.set_device("gpu")
    if tables["gpu"] != tables["cpu"] or not tables["gpu"]:
        fail(f"operator stats differ: card {tables['gpu']} cpu "
             f"{tables['cpu']}")
    rec = dict(checked_step_s=checked_s, negative_control=raised,
               operator_stats={f"{k[0]}:{k[1]}": v
                               for k, v in sorted(tables["gpu"].items())})
    print(f"amp.debugging: one BERT-base step under the tensor checker "
          f"({checked_s:.2f} s), an inf query weight raised "
          f"{raised!r}; operator stats of a 2-layer f32 step equal on the "
          f"card and the CPU ({sum(tables['gpu'].values())} ops, "
          f"{len(tables['gpu'])} (op, dtype) rows) on {card}", flush=True)
    return rec


PHASE24_EXT = r'''
extern "C" void phase24_affine(const float* x, float* y, long n, float a) {
  for (long i = 0; i < n; ++i) y[i] = a * x[i] + 1.0f;
}
'''


def device_utils_check(torch, paddle, card):
    """Phase 24 (c): ``paddle.device`` and ``paddle.utils`` on the card:
    the allocator reading, the card's name, a matmul on a side Stream
    ordered by Events, DLPack without a copy, and ``cpp_extension`` with
    g++ when the machine has it."""
    import ctypes
    import shutil

    from paddle_tpu_torch import device as D
    from paddle_tpu_torch.utils import cpp_extension
    paddle.set_device("gpu")
    keep = torch.empty(1 << 20, device="cuda")   # a known allocation
    alloc = (D.cuda.memory_allocated(), torch.cuda.memory_allocated())
    name = D.cuda.get_device_properties().name
    if alloc[0] != alloc[1] or name != card.split(",")[0].strip():
        fail(f"device: memory_allocated {alloc}, name {name!r} vs {card!r}")
    del keep
    g = torch.Generator(device="cuda").manual_seed(24)
    a, b = (paddle.to_tensor(torch.randn(2048, 2048, generator=g,
                                         device="cuda")) for _ in range(2))
    ready = D.Event()
    ready.record()                       # a and b made on the default stream
    side = D.Stream()
    side.wait_event(ready)
    with D.stream_guard(side):
        on_side = torch.cuda.current_stream() == side.stream_base
        c = paddle.matmul(a, b)
    done = side.record_event()
    D.current_stream().wait_event(done)
    D.synchronize()
    ref = paddle.matmul(a, b)
    D.synchronize()
    if not on_side or side == D.current_stream() or \
            not torch.equal(c._data, ref._data):
        fail(f"device: the side stream's matmul (current inside the guard "
             f"{on_side}) differs from the default stream's")
    t = paddle.randn([64, 64])
    cap = paddle.to_dlpack(t)
    back = paddle.from_dlpack(cap)
    shared = back._data.data_ptr() == t._data.data_ptr() == \
        torch.from_dlpack(cap).data_ptr()
    if not shared:
        fail("dlpack: to_dlpack / from_dlpack copied the cuda tensor")
    ext = None
    if shutil.which("g++"):
        src = ROOT / "build" / "phase24_ext" / "phase24_affine.cc"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(PHASE24_EXT)
        lib = cpp_extension.load("phase24_affine", [str(src)],
                                 build_directory=str(src.parent))
        lib.phase24_affine.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_long, ctypes.c_float]

        def fwd(x, a=1.0):
            x = x.contiguous()
            y = torch.empty_like(x)
            lib.phase24_affine(x.data_ptr(), y.data_ptr(), x.numel(), a)
            return y

        op = cpp_extension.register_op(
            "phase24_affine", fwd, backward=lambda x, gy, a=1.0: gy * a)
        x = paddle.to_tensor(torch.arange(6, dtype=torch.float32),
                             place="cpu", stop_gradient=False)
        y = op(x, a=3.0)
        y.sum().backward()
        ok = torch.equal(y._data.detach(), 3 * x._data.detach() + 1) and \
            torch.equal(x.grad._data, torch.full((6,), 3.0))
        if not ok:
            fail(f"cpp_extension: {y._data} / {x.grad._data}")
        ext = "g++ build, forward and backward equal to 3x + 1 and 3"
    else:
        print("cpp_extension: no g++ on this machine; not exercised on the "
              "card (tests/test_torch_device_utils.py covers it on the CPU)",
              flush=True)
    rec = dict(memory_allocated=alloc, device_name=name,
               side_stream_matmul="bit-equal", dlpack_shared=shared,
               cpp_extension=ext, device_count=D.device_count(),
               cudnn=D.get_cudnn_version())
    print(f"device / utils: memory_allocated {alloc[0]} == torch's, "
          f"properties name {name!r}, a 2048^2 matmul on a side stream "
          f"(guard, events, synchronize) bit-equal to the default "
          f"stream's, dlpack shares data_ptr, cpp_extension: {ext}",
          flush=True)
    return rec


# -- phase 6b: the serving accelerators ------------------------------------

#: the draft length of bench.py's speculative serving extras
SPEC_K = 4
#: requests of phase 6b's profiler check, all greedy, equal lengths
PROFILE_SLOTS, PROFILE_PROMPT = 16, 128


# -- phase 25: paddle.vision: ResNet-50 served and trained, detection ops --

#: the seed every phase-25 input and weight is drawn from
VISION_SEED = 25
#: ImageNet's mean and std, on the [0, 1] scale ToTensor gives
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
#: (a) the card-vs-CPU copy of ResNet-50: f32, a batch of 2 x 224 x 224
VISION_XCHECK_BATCH = 2
#: (b) serving: ResNet-50 in eval, batch 64 of 375 x 500 x 3 uint8 images
#: (ImageNet's typical size) through Resize(256) -> CenterCrop(224) ->
#: Normalize once on the host; timed runs a path
VISION_SERVE_BATCH, VISION_SERVE_HW, VISION_SERVE_RUNS = 64, (375, 500), 6
#: (c) PaddleClas's ImageNet ResNet-50 recipe
#: (ppcls/configs/ImageNet/ResNet/ResNet50.yaml): 64 images a card,
#: Momentum 0.9 at lr 0.1, L2Decay 1e-4, O1; over IMAGES 256 x 256 x 3
#: uint8 images in CLASSES class folders, one epoch of drop_last batches
#: (WARM untimed steps, then the rest timed)
VISION_TRAIN = dict(batch=64, lr=0.1, momentum=0.9, decay=1e-4, images=512,
                    classes=8, hw=256, warm=2)
#: (d) the detectors' shapes: Faster R-CNN R50-C4 (an 800 x 1333 image at
#: stride 16: a [2, 1024, 50, 84] C4 map, 512 RoIs an image, 14 x 14
#: RoIAlign / 7 x 7 RoIPool, RPN's 15 anchors a cell, 6,000 pre-NMS
#: proposals at IoU 0.7, 1,000 kept); R-FCN (21 classes x 7 x 7
#: position-sensitive channels, 300 RoIs an image); YOLOv3-DarkNet53 at
#: 608 x 608, 80 classes, batch 8 (heads 19 / 38 / 76, COCO's anchors,
#: 50 ground-truth boxes an image); DCNv2 in ResNet-50's stage 5 (3 x 3,
#: 512 -> 512 on [2, 512, 25, 42])
DET = dict(c4=(2, 1024, 50, 84), image=(800, 1333), stride=16, rois=512,
           align=14, pool=7, anchors=15, pre_nms=6000, post_nms=1000,
           iou=0.7, rfcn_classes=21, rfcn_rois=300, yolo_batch=8,
           yolo_size=608, yolo_classes=80, yolo_gt=50,
           yolo_anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
                         116, 90, 156, 198, 373, 326],
           yolo_masks=[[6, 7, 8], [3, 4, 5], [0, 1, 2]],
           yolo_strides=[32, 16, 8], dcn=(2, 512, 25, 42))
#: (d) a trained YOLOv3's heads are mostly empty: objectness logits drawn
#: from N(OBJ), class logits from N(CLS) (mean, std), so that about a tenth
#: of the 22,743 boxes an image pass the 0.01 confidence threshold
YOLO_OBJ, YOLO_CLS = (-7.0, 2.0), (-5.0, 2.0)
#: (e) the smallest factory of each family, f32, batch 2, and its input
ZOO = (("LeNet", (1, 28, 28)), ("alexnet", (3, 224, 224)),
       ("vgg11", (3, 224, 224)), ("resnet18", (3, 224, 224)),
       ("resnext50_32x4d", (3, 224, 224)), ("mobilenet_v1", (3, 224, 224)),
       ("mobilenet_v2", (3, 224, 224)),
       ("mobilenet_v3_small", (3, 224, 224)),
       ("squeezenet1_1", (3, 224, 224)),
       ("shufflenet_v2_x0_25", (3, 224, 224)),
       ("densenet121", (3, 224, 224)), ("googlenet", (3, 224, 224)),
       ("inception_v3", (3, 299, 299)))


def _vision_model(paddle, net, amp):
    """``paddle.Model(net)`` prepared as PaddleClas's recipe: Momentum,
    L2Decay, cross-entropy, top-1 / top-5 accuracy; O1 when ``amp``."""
    model = paddle.Model(net)
    opt = paddle.optimizer.Momentum(
        learning_rate=VISION_TRAIN["lr"], momentum=VISION_TRAIN["momentum"],
        parameters=net.parameters(),
        weight_decay=paddle.regularizer.L2Decay(VISION_TRAIN["decay"]))
    model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                  paddle.metric.Accuracy(topk=(1, 5)),
                  amp_configs={"level": "O1"} if amp else None)
    if model._train_step is None:
        fail("phase 25: Model.prepare built no TrainStep (the eager "
             "fallback ran)")
    return model


def _vision_step(torch, paddle, dtype):
    """One ``Model.train_batch`` of ``resnet50()`` in ``dtype`` on the card
    and on the CPU with the card's weights, on VISION_SEED's batch:
    ({device: (loss, {name: gradient}, {name: running stat})}, the
    parameter and BatchNorm counts), the gradients from
    ``loss_and_grads`` (the running statistics restored after it), the
    statistics after the step."""
    import numpy as np
    from paddle_tpu_torch.vision import models
    rng = np.random.default_rng(VISION_SEED)
    x = rng.standard_normal((VISION_XCHECK_BATCH, 3, 224, 224))
    y = rng.integers(0, 1000, (VISION_XCHECK_BATCH,)).astype(np.int64)
    paddle.set_device("gpu")
    paddle.seed(VISION_SEED)
    card_net = models.resnet50()
    paddle.set_device("cpu")
    cpu_net = models.resnet50()
    cpu_net.set_state_dict(card_net.state_dict())
    res = {}
    for dev, net in (("gpu", card_net), ("cpu", cpu_net)):
        paddle.set_device(dev)
        net.to(dtype=dtype)
        model = _vision_model(paddle, net, amp=False)
        xt = paddle.to_tensor(x, dtype=dtype)
        yt = paddle.to_tensor(y)
        bufs = {k: b._data.clone() for k, b in net.named_buffers()}
        _, grads = model._train_step.loss_and_grads((xt._data,), yt._data)
        for k, b in net.named_buffers():
            b._data.copy_(bufs[k])
        loss = model.train_batch([xt], yt)[0]
        res[dev] = (torch.tensor(loss),
                    {k: g.double().cpu() for k, g in grads.items()},
                    {k: b._data.double().cpu()
                     for k, b in net.named_buffers()})
        del model
    counts = dict(params=len(card_net.parameters()),
                  bn=sum(isinstance(m, paddle.nn.BatchNorm2D)
                         for m in card_net.sublayers()))
    paddle.set_device("gpu")
    del card_net, cpu_net
    torch.cuda.empty_cache()
    return res, counts


def vision_cross_check(torch, paddle):
    """Phase 25 (a): ``resnet50()`` through one ``Model.train_batch`` on the
    card and on the CPU with the card's weights, batch 2 x 3 x 224 x 224
    (``_vision_step``). In f32 (TF32 off): the loss and every BatchNorm
    ``_mean`` / ``_variance`` after the step within closeness's f32 gate;
    the gradients' ratio is printed, not gated. At random weights a
    ResNet-50's gradients move by ~90x that gate when the input moves by
    1e-7 (f64 on the CPU): a rounding flips a ReLU or max-pool kink, so
    two f32 computations differ there by more than f32's rounding. In
    f64, where nothing flips: the loss, every gradient and every running
    statistic within the same gate."""
    rec = {}
    for dtype in ("float32", "float64"):
        res, counts = _vision_step(torch, paddle, dtype)
        loss_c = closeness(res["gpu"][0], res["cpu"][0])
        grads = {k: closeness(g, res["cpu"][1][k])
                 for k, g in res["gpu"][1].items()}
        stats = {k: closeness(b, res["cpu"][2][k])
                 for k, b in res["gpu"][2].items()}
        worst_g = max(grads, key=lambda k: grads[k]["ratio"])
        worst_s = max(stats, key=lambda k: stats[k]["ratio"])
        r = dict(loss_cuda=float(res["gpu"][0]),
                 loss_cpu=float(res["cpu"][0]), loss_ratio=loss_c["ratio"],
                 grads=len(grads), worst_grad=worst_g,
                 worst_grad_ratio=grads[worst_g]["ratio"],
                 worst_grad_max_abs_err=grads[worst_g]["max_abs_err"],
                 running_stats=len(stats), worst_stat=worst_s,
                 worst_stat_ratio=stats[worst_s]["ratio"])
        gated = [loss_c["ratio"], r["worst_stat_ratio"]] + (
            [r["worst_grad_ratio"]] if dtype == "float64" else [])
        if len(grads) != len(res["cpu"][1]) or \
                len(grads) != counts["params"] or \
                len(stats) != 2 * counts["bn"] or max(gated) > 1:
            fail(f"phase 25 (a): ResNet-50 card vs CPU off in {dtype}: {r}")
        rec[dtype] = r
        print(f"vision (a) ResNet-50 train_batch card vs CPU ({dtype}, batch "
              f"{VISION_XCHECK_BATCH}): loss {r['loss_cuda']:.6f} / "
              f"{r['loss_cpu']:.6f} (ratio {r['loss_ratio']:.3f}); "
              f"{len(stats)} running stats, worst {worst_s} ratio "
              f"{r['worst_stat_ratio']:.3f}; {len(grads)} gradients, worst "
              f"{worst_g} ratio {r['worst_grad_ratio']:.3f}"
              f"{'' if dtype == 'float64' else ' (not gated)'}; pass <= 1",
              flush=True)
    return rec


def _events_and_host(torch, fn, runs):
    """Median (event ms, host ms) of ``runs`` calls of fn, each synced."""
    ev, host = [], []
    for _ in range(runs):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(e0.elapsed_time(e1))
    return statistics.median(ev), statistics.median(host)


def device_kernels(torch, fn):
    """Device kernels, copies and memsets of one synced fn(), as
    torch.profiler records them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type.name == "CUDA")


def vision_serving(torch, paddle, launches_of, reset_counts, card):
    """Phase 25 (b): ``resnet50(num_classes=1000)`` in eval at batch 64:
    the host pipeline (ToTensor, Resize(256), CenterCrop(224), Normalize
    with ImageNet's mean and std) once, then ``Model.predict_batch`` in
    f32 and under ``amp.auto_cast`` O1 bf16, then ``jit.save`` ->
    ``inference.create_predictor`` in f32 held to the eager f32 logits
    within closeness's f32 gate; counts around the three paths."""
    import shutil

    import numpy as np
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.vision import models
    from paddle_tpu_torch.vision import transforms as T
    rng = np.random.default_rng(VISION_SEED + 1)
    h, w = VISION_SERVE_HW
    raw = rng.integers(0, 256, (VISION_SERVE_BATCH, h, w, 3), np.uint8)
    pipe = T.Compose([T.ToTensor(), T.Resize(256), T.CenterCrop(224),
                      T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    t0 = time.perf_counter()
    batch = np.stack([pipe(im) for im in raw])
    pipe_ms = (time.perf_counter() - t0) * 1e3
    paddle.set_device("gpu")
    paddle.seed(VISION_SEED + 1)
    net = models.resnet50(num_classes=1000)
    net.eval()
    model = paddle.Model(net)
    model.prepare()
    x = paddle.to_tensor(batch)
    rec = dict(batch=VISION_SERVE_BATCH, image_hw=list(VISION_SERVE_HW),
               pipeline_ms=pipe_ms)

    def f32():
        return model.predict_batch([x])

    def bf16():
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            return model.predict_batch([x])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits = f32()._data.float()
    logits_bf16 = bf16()._data
    for name, fn in (("f32", f32), ("bf16", bf16)):
        fn()
        ev, host = _events_and_host(torch, fn, VISION_SERVE_RUNS)
        rec[name] = dict(ms_events=ev, ms_host=host,
                         images_per_s=VISION_SERVE_BATCH / ev * 1e3)
    rec["peak_gb_eager"] = torch.cuda.max_memory_allocated() / 1e9
    d = ROOT / "build" / "chip_smoke_vision"
    shutil.rmtree(d, ignore_errors=True)
    prefix = str(d / "resnet50")
    t0 = time.perf_counter()
    jit.save(net, prefix, input_spec=[jit.InputSpec(
        [VISION_SERVE_BATCH, 3, 224, 224], "float32")])
    rec["save_s"] = time.perf_counter() - t0
    pred = inference.create_predictor(inference.Config(prefix + ".pdmodel"))
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(batch)
    pred.run()
    got = torch.from_numpy(pred.get_output_handle(
        pred.get_output_names()[0]).copy_to_cpu())
    ev, host = _events_and_host(torch, pred.run, VISION_SERVE_RUNS)
    rec["predictor"] = dict(ms_events=ev, ms_host=host,
                            images_per_s=VISION_SERVE_BATCH / ev * 1e3)
    x_dev = x._data
    rec["predictor"]["program_ms"] = _events_and_host(
        torch, lambda: pred._layer(x_dev), VISION_SERVE_RUNS)[0]
    torch.cuda.synchronize()
    launches = launches_of()
    # -- end of the counted paths --
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gate = closeness(got, logits.cpu())
    finite = bool(torch.isfinite(logits).all() and
                  torch.isfinite(logits_bf16.float()).all())
    top1 = float((logits.argmax(-1) == logits_bf16.float().argmax(-1))
                 .float().mean())
    rec.update(predictor_gate=gate, bf16_top1_equal_share=top1,
               launches=launches, shape=list(logits.shape))
    if tuple(logits.shape) != (VISION_SERVE_BATCH, 1000) or not finite or \
            gate["ratio"] > 1:
        fail(f"phase 25 (b): serving off: shape {tuple(logits.shape)}, "
             f"finite {finite}, predictor {gate}")
    if any(launches.values()):
        fail(f"phase 25 (b): serving launched port kernels: {launches}")
    print(f"vision (b) ResNet-50 serving, batch {VISION_SERVE_BATCH} "
          f"(host pipeline {pipe_ms:.1f} ms): f32 "
          f"{rec['f32']['ms_events']:.2f} ms (host "
          f"{rec['f32']['ms_host']:.2f}) = "
          f"{rec['f32']['images_per_s']:.0f} images/s; bf16 O1 "
          f"{rec['bf16']['ms_events']:.2f} ms (host "
          f"{rec['bf16']['ms_host']:.2f}) = "
          f"{rec['bf16']['images_per_s']:.0f} images/s, top-1 equal to "
          f"f32's {top1:.3f}; predictor (saved in {rec['save_s']:.1f} s) "
          f"{rec['predictor']['ms_events']:.2f} ms a run with host copies "
          f"(program {rec['predictor']['program_ms']:.2f}) = "
          f"{rec['predictor']['images_per_s']:.0f} images/s, ratio "
          f"{gate['ratio']:.3f} of the f32 gate; peak "
          f"{rec['peak_gb']:.2f} GB on {card}", flush=True)
    del pred, model, net, x
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def _vision_folders(root):
    """VISION_TRAIN's images as ``root/class_k/i.npy`` (HWC uint8 256 x
    256 x 3), the class-conditional patterns of the datasets'
    ``_synthetic_images`` from VISION_SEED."""
    import numpy as np
    from paddle_tpu_torch.vision.datasets import _synthetic_images
    n, k, hw = (VISION_TRAIN[n] for n in ("images", "classes", "hw"))
    imgs, labels = _synthetic_images(n, k, (3, hw, hw), VISION_SEED)
    imgs = np.round(imgs * 255).astype(np.uint8).transpose(0, 2, 3, 1)
    for c in range(k):
        (root / f"class_{c}").mkdir(parents=True)
    for i, (im, c) in enumerate(zip(imgs, labels)):
        np.save(root / f"class_{c}" / f"{i:04d}.npy", im)
    return np.bincount(labels, minlength=k).tolist()


def vision_train_main_path(torch, paddle, launches_of, reset_counts, card):
    """Phase 25 (c), the main path: ``resnet50()`` trained by PaddleClas's
    recipe through ``Model.fit`` over ``DatasetFolder(root,
    loader=np.load, extensions=(".npy",))`` with ToTensor,
    RandomResizedCrop(224), RandomHorizontalFlip and Normalize, in a
    ``DataLoader(batch_size=64, shuffle=True, drop_last=True,
    num_workers=min(8, cpus))``: one epoch (2 warm steps, the rest timed),
    counts to 0 just before and read just after. Then the same
    ``train_batch`` on one fixed batch, without the loader."""
    import shutil

    import numpy as np
    from paddle_tpu_torch.vision import datasets, models
    from paddle_tpu_torch.vision import transforms as T
    root = OUT_DIR / "vision_data"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        per_class = _vision_folders(root)
        data_s = time.perf_counter() - t0
        ds = datasets.DatasetFolder(
            str(root), loader=np.load, extensions=(".npy",),
            transform=T.Compose([T.ToTensor(), T.RandomResizedCrop(224),
                                 T.RandomHorizontalFlip(),
                                 T.Normalize(IMAGENET_MEAN, IMAGENET_STD)]))
        workers = min(8, os.cpu_count() or 1)
        loader = paddle.io.DataLoader(ds, batch_size=VISION_TRAIN["batch"],
                                      shuffle=True, drop_last=True,
                                      num_workers=workers)
        paddle.set_device("gpu")
        paddle.seed(VISION_SEED + 2)
        np.random.seed(VISION_SEED + 2)
        net = models.resnet50()
        model = _vision_model(paddle, net, amp=True)
        stats0 = {k: b._data.clone() for k, b in net.named_buffers()}
        clock = _step_clock(torch, paddle)
        builds = []

        class Builds(paddle.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                builds.append(int(paddle.monitor.snapshot().get(
                    "kernels.builds", 0)))
        steps = len(loader)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, verbose=0, callbacks=[clock, Builds()])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = launches_of()
        counters = {k: v for k, v in paddle.monitor.snapshot().items()
                    if k.startswith("kernels.")}
        # -- end of the counted path --
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = clock.losses
        moved = [k for k, b in net.named_buffers()
                 if not torch.equal(b._data, stats0[k])]
        finite_stats = all(bool(torch.isfinite(b._data).all())
                           for _, b in net.named_buffers())
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            fail(f"phase 25 (c): {len(losses)} losses for {steps} steps: "
                 f"{losses}")
        if len(moved) != len(stats0) or not finite_stats:
            fail(f"phase 25 (c): running stats moved {len(moved)} of "
                 f"{len(stats0)}, finite {finite_stats}")
        if len(set(builds)) != 1:
            fail(f"phase 25 (c): kernel builds after the first step: "
                 f"{builds}")
        if any(launches.values()):
            fail(f"phase 25 (c): the vision path launched port kernels "
                 f"{launches} (none of them is on it)")
        warm = VISION_TRAIN["warm"]
        step_t, cycles = clock.timings()
        med = statistics.median
        step_host = med(h for h, _ in step_t[warm:])
        step_ev = med(e for _, e in step_t[warm:])
        cycle = med(cycles[warm:])
        # the same step on one fixed batch, no loader
        x, y = next(iter(loader))
        model.train_batch([x], y)
        fixed_ev, fixed_host = _events_and_host(
            torch, lambda: model.train_batch([x], y), steps - warm)
        model.eval_batch([x], y)
        acc = model._metrics[0].accumulate()
        b = VISION_TRAIN["batch"]
        rec = dict(steps=steps, timed=steps - warm, workers=workers,
                   per_class=per_class, data_s=data_s, fit_s=fit_s,
                   losses=losses, step_ms_host=step_host,
                   step_ms_events=step_ev, cycle_ms=cycle,
                   images_per_s=b / cycle * 1e3,
                   loader_wait_share=(cycle - step_ev) / cycle,
                   fixed_batch=dict(ms_events=fixed_ev, ms_host=fixed_host,
                                    images_per_s=b / fixed_host * 1e3),
                   step_host_ms=[h for h, _ in step_t],
                   step_events_ms=[e for _, e in step_t], cycles_ms=cycles,
                   accuracy_top1_top5=acc, peak_gb=peak_gb,
                   running_stats_moved=len(moved), builds=builds,
                   launches=launches, counters=counters)
        print(f"vision (c) ResNet-50 Model.fit (PaddleClas recipe, O1 bf16, "
              f"batch {b}, {workers} workers, {steps} steps of which "
              f"{steps - warm} timed): losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; step {step_ev:.2f} ms events / "
              f"{step_host:.2f} ms host, cycle {cycle:.2f} ms = "
              f"{rec['images_per_s']:.0f} images/s, device waits on the "
              f"loader {rec['loader_wait_share']:.3f} of a cycle; one fixed "
              f"batch {fixed_ev:.2f} ms events / {fixed_host:.2f} host; "
              f"{len(moved)} running stats moved; peak {peak_gb:.2f} GB; "
              f"no port kernel launched on {card}", flush=True)
        del model, net, loader
        torch.cuda.empty_cache()
        return rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _det_check(torch, what, fn, inputs, grad_of=(), iters=3):
    """``fn(*inputs)`` on the card against the CPU path on copies of the
    same inputs: every floating output within closeness's f32 gate, and
    the gradients of sum(out * w) (w fixed, from VISION_SEED) in the
    inputs named by ``grad_of`` (indices); ms of the card's forward and of
    forward + backward (events, after one warm call)."""
    def leaves(dev):
        """The inputs as fresh leaves on ``dev`` (a gradient must stop
        there, never reach ``inputs`` through the copy)."""
        return [t.detach().to(dev).requires_grad_(i in grad_of)
                if torch.is_tensor(t) else t for i, t in enumerate(inputs)]

    def run(dev):
        ins = leaves(dev)
        outs = fn(*ins)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        outs = [o._data if hasattr(o, "_data") else o for o in outs]
        grads = {}
        if grad_of:
            g = torch.Generator().manual_seed(VISION_SEED)
            loss = sum((o * torch.randn(tuple(o.shape), generator=g).to(
                dev)).sum() for o in outs if o.is_floating_point())
            gs = torch.autograd.grad(loss, [ins[i] for i in grad_of])
            grads = {i: g.cpu() for i, g in zip(grad_of, gs)}
        return [o.detach().cpu() for o in outs], grads
    card_out, card_g = run("cuda")
    cpu_out, cpu_g = run("cpu")
    gates = [closeness(a, b) for a, b in zip(card_out, cpu_out)
             if a.is_floating_point()]
    gates += [closeness(card_g[i], cpu_g[i]) for i in grad_of]
    equal_ints = all(torch.equal(a, b) for a, b in zip(card_out, cpu_out)
                     if not a.is_floating_point())
    worst = max((g["ratio"] for g in gates), default=0.0)
    if worst > 1 or not equal_ints:
        fail(f"phase 25 (d) {what}: card vs CPU {gates}, integer outputs "
             f"equal {equal_ints}")
    dev_in = leaves("cuda")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: fn(*dev_in), iters=iters, warmup=1)

    def fwd_bwd():
        outs = fn(*dev_in)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        sum(o._data.float().sum() for o in outs
            if o._data.is_floating_point()).backward()
    bwd_ms = cuda_ms(fwd_bwd, iters=iters, warmup=1) if grad_of else None
    return dict(ratio=worst, max_abs_err=max(
        (g["max_abs_err"] for g in gates), default=0.0), gates=len(gates),
        fwd_ms=fwd_ms, fwd_bwd_ms=bwd_ms)


def _rpn_boxes(rng, n, image):
    """n RPN-like proposals on an image of (h, w): a dense cluster of
    jittered boxes around each of n/60 objects."""
    import numpy as np
    h, w = image
    k = max(n // 60, 1)
    cx, cy = rng.uniform(0, w, k), rng.uniform(0, h, k)
    bw, bh = rng.uniform(32, 400, k), rng.uniform(32, 400, k)
    obj = rng.integers(0, k, n)
    jit = rng.normal(0, 0.12, (n, 4))
    x1 = cx[obj] - bw[obj] / 2 + jit[:, 0] * bw[obj]
    y1 = cy[obj] - bh[obj] / 2 + jit[:, 1] * bh[obj]
    x2 = cx[obj] + bw[obj] / 2 + jit[:, 2] * bw[obj]
    y2 = cy[obj] + bh[obj] / 2 + jit[:, 3] * bh[obj]
    b = np.stack([np.minimum(x1, x2), np.minimum(y1, y2),
                  np.maximum(x1, x2), np.maximum(y1, y2)], 1)
    return np.clip(b, 0, [w - 1, h - 1, w - 1, h - 1]).astype(np.float32)


def _nms_check(torch, tops, rng):
    """nms on DET['pre_nms'] proposals at IoU DET['iou']: the kept indices
    on the card equal the CPU's, or differ only where a suppression bit
    differs on a pair whose CPU IoU lies within 1e-6 of the threshold;
    ms (events and host) and the CUDA kernels and copies one call makes
    (torch.profiler)."""
    import numpy as np
    n, thr = DET["pre_nms"], DET["iou"]
    boxes = torch.from_numpy(_rpn_boxes(rng, n, DET["image"]))
    scores = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    keep = {d: tops.nms(boxes.to(d), thr, scores.to(d))._data.cpu()
            for d in ("cuda", "cpu")}
    order = torch.argsort(-scores, stable=True)
    iou = {d: tops._iou_matrix(boxes[order].to(d)).cpu()
           for d in ("cuda", "cpu")}
    later = torch.ones(n, n, dtype=torch.bool).triu(1)
    near = ((iou["cpu"] - thr).abs() <= 1e-6) & later
    flips = ((iou["cuda"] > thr) != (iou["cpu"] > thr)) & later
    if not torch.equal(keep["cuda"], keep["cpu"]) and \
            bool((flips & ~near).any()):
        fail(f"phase 25 (d) nms: kept indices differ beyond the near-"
             f"threshold pairs ({int(flips.sum())} flipped bits)")
    b_dev, s_dev = boxes.cuda(), scores.cuda()
    ev, host = _events_and_host(
        torch, lambda: tops.nms(b_dev, thr, s_dev), 5)
    launches = device_kernels(torch, lambda: tops.nms(b_dev, thr, s_dev))
    kept = int((keep["cpu"] >= 0).sum())
    return dict(boxes=n, kept=kept, equal=torch.equal(keep["cuda"],
                                                      keep["cpu"]),
                near_threshold_pairs=int(near.sum()),
                flipped_bits=int(flips.sum()), ms_events=ev, ms_host=host,
                cuda_activities=launches)


def vision_detection_ops(torch, paddle, card):
    """Phase 25 (d): the detection ops at their detectors' sizes (DET), each
    on the card against the port's CPU path on the same inputs (TF32 off):
    values and, where the op has them, gradients within closeness's f32
    gate; generate_proposals and multiclass_nms3 (host numpy) equal; nms
    by _nms_check. ms of each beside the card."""
    import numpy as np
    from paddle_tpu_torch.vision import ops as tops
    rng = np.random.default_rng(VISION_SEED + 3)
    T = torch.from_numpy
    out = {}
    n_img, c, fh, fw = DET["c4"]
    ih, iw = DET["image"]
    scale = 1.0 / DET["stride"]
    c4 = T(rng.standard_normal(DET["c4"]).astype(np.float32))
    rois = T(np.concatenate([_rpn_boxes(rng, DET["rois"], DET["image"])
                             for _ in range(n_img)]))
    num = np.full(n_img, DET["rois"], np.int32)
    out["roi_align"] = _det_check(
        torch, "roi_align", lambda x, b: tops.roi_align(
            x, b, num, DET["align"], scale, -1, True), [c4, rois], (0,))
    out["roi_pool"] = _det_check(
        torch, "roi_pool", lambda x, b: tops.roi_pool(
            x, b, num, DET["pool"], scale), [c4, rois], (0,))
    del c4
    out["nms"] = _nms_check(torch, tops, rng)
    # RPN proposals from [2, 15, 50, 84] scores and [2, 60, 50, 84] deltas
    a = DET["anchors"]
    sizes = np.array([32, 64, 128, 256, 512], np.float32)
    ratios = np.array([0.5, 1.0, 2.0], np.float32)
    aw = (sizes[:, None] / np.sqrt(ratios)[None]).reshape(-1)
    ah = (sizes[:, None] * np.sqrt(ratios)[None]).reshape(-1)
    cy, cx = np.meshgrid((np.arange(fh) + 0.5) * DET["stride"],
                         (np.arange(fw) + 0.5) * DET["stride"],
                         indexing="ij")
    anchors = np.stack([cx[..., None] - aw / 2, cy[..., None] - ah / 2,
                        cx[..., None] + aw / 2, cy[..., None] + ah / 2],
                       -1).astype(np.float32)            # [H, W, A, 4]
    rpn = [rng.uniform(0, 1, (n_img, a, fh, fw)).astype(np.float32),
           rng.normal(0, 0.2, (n_img, 4 * a, fh, fw)).astype(np.float32),
           np.array([[ih, iw]] * n_img, np.float32), anchors,
           np.ones_like(anchors)]
    props = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res = tops.generate_proposals(
            *[T(v).to(d) for v in rpn], pre_nms_top_n=DET["pre_nms"],
            post_nms_top_n=DET["post_nms"], nms_thresh=DET["iou"])
        props[d] = ([r._data.cpu() for r in res],
                    (time.perf_counter() - t0) * 1e3)
    if not all(torch.equal(p, q) for p, q in zip(props["cuda"][0],
                                                 props["cpu"][0])):
        fail("phase 25 (d) generate_proposals: card result differs")
    out["generate_proposals"] = dict(
        kept=props["cpu"][0][2].tolist(), ms_host=props["cuda"][1])
    # R-FCN position-sensitive pooling
    k = DET["pool"]
    ps = T(rng.standard_normal((n_img, DET["rfcn_classes"] * k * k, fh,
                                fw)).astype(np.float32))
    ps_rois = T(np.concatenate([_rpn_boxes(rng, DET["rfcn_rois"],
                                           DET["image"])
                                for _ in range(n_img)]))
    ps_num = np.full(n_img, DET["rfcn_rois"], np.int32)
    out["psroi_pool"] = _det_check(
        torch, "psroi_pool", lambda x, b: tops.psroi_pool(
            x, b, ps_num, k, scale), [ps, ps_rois], (0,))
    del ps
    # YOLOv3: three heads, decode, loss, NMS
    nb, cls, size = DET["yolo_batch"], DET["yolo_classes"], DET["yolo_size"]
    heads = []
    for stride in DET["yolo_strides"]:
        s = size // stride
        v = rng.normal(0, 1, (nb, 3, 5 + cls, s, s))
        v[:, :, 2:4] *= 0.5
        v[:, :, 4] = rng.normal(*YOLO_OBJ, (nb, 3, s, s))
        v[:, :, 5:] = rng.normal(*YOLO_CLS, (nb, 3, cls, s, s))
        heads.append(T(v.reshape(nb, 3 * (5 + cls), s, s).astype(
            np.float32)))
    img = T(np.array([[size, size]] * nb, np.int32))
    anc = DET["yolo_anchors"]
    gt = np.zeros((nb, DET["yolo_gt"], 4), np.float32)
    gt[..., :2] = rng.uniform(0.05, 0.95, (nb, DET["yolo_gt"], 2))
    gt[..., 2:] = rng.uniform(0.02, 0.5, (nb, DET["yolo_gt"], 2))
    label = T(rng.integers(0, cls, (nb, DET["yolo_gt"])).astype(np.int64))
    decoded = []
    for i, (mask, stride) in enumerate(zip(DET["yolo_masks"],
                                           DET["yolo_strides"])):
        sub = [v for j in mask for v in anc[2 * j:2 * j + 2]]
        out[f"yolo_box_{size // stride}"] = _det_check(
            torch, f"yolo_box {size // stride}", lambda x, im: tops.yolo_box(
                x, im, sub, cls, 0.01, stride), [heads[i], img], (0,))
        out[f"yolo_loss_{size // stride}"] = _det_check(
            torch, f"yolo_loss {size // stride}",
            lambda x, g, lab: tops.yolo_loss(
                x, g, lab, anc, mask, cls, 0.7, stride),
            [heads[i], T(gt), label], (0,))
        with torch.no_grad():
            decoded.append(tops.yolo_box(heads[i].cuda(), img.cuda(), sub,
                                         cls, 0.01, stride))
    boxes = torch.cat([b._data for b, _ in decoded], 1)
    scores = torch.cat([s._data for _, s in decoded], 1).transpose(1, 2)
    nms3 = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res = tops.multiclass_nms3(boxes.to(d), scores.contiguous().to(d),
                                   score_threshold=0.01, nms_top_k=1000,
                                   keep_top_k=100, nms_threshold=0.45)
        nms3[d] = ([r._data.cpu() for r in res],
                   (time.perf_counter() - t0) * 1e3)
    if not all(torch.equal(p, q) for p, q in zip(nms3["cuda"][0],
                                                 nms3["cpu"][0])):
        fail("phase 25 (d) multiclass_nms3: card result differs")
    cand = int(((scores > 0.01).sum(-1) > 0).sum())
    out["multiclass_nms3"] = dict(
        boxes_per_image=int(boxes.shape[1]), kept=nms3["cpu"][0][1].tolist(),
        boxes_over_threshold=cand, ms_host=nms3["cuda"][1])
    del heads, decoded, boxes, scores
    # DCNv2 in ResNet-50's stage 5
    n, ch, h, w = DET["dcn"]
    x = T(rng.standard_normal((n, ch, h, w)).astype(np.float32))
    off = T(rng.normal(0, 1, (n, 18, h, w)).astype(np.float32))
    msk = T(rng.uniform(0, 1, (n, 9, h, w)).astype(np.float32))
    wt = T((rng.standard_normal((ch, ch, 3, 3)) / np.sqrt(ch * 9)).astype(
        np.float32))
    out["deform_conv2d"] = _det_check(
        torch, "deform_conv2d", lambda a, o, m, ww: tops.deform_conv2d(
            a, o, ww, padding=1, mask=m), [x, off, msk, wt], (0, 1, 2, 3))
    print(f"vision (d) detection ops on the card vs the CPU (f32 gate; ms "
          f"forward / forward + backward on {card}):", flush=True)
    for name, r in out.items():
        if "fwd_ms" in r:
            bwd = "" if r["fwd_bwd_ms"] is None else \
                f" / {r['fwd_bwd_ms']:.2f}"
            print(f"  {name}: {r['fwd_ms']:.2f}{bwd} ms, ratio "
                  f"{r['ratio']:.3f}", flush=True)
    r = out["nms"]
    print(f"  nms: {r['boxes']} boxes -> {r['kept']} kept, equal to the "
          f"CPU {r['equal']} ({r['near_threshold_pairs']} pairs within 1e-6 "
          f"of the threshold, {r['flipped_bits']} bits flipped); "
          f"{r['ms_events']:.2f} ms events / {r['ms_host']:.2f} ms host, "
          f"{r['cuda_activities']} CUDA kernels and copies a call",
          flush=True)
    gp, mn = out["generate_proposals"], out["multiclass_nms3"]
    print(f"  generate_proposals (host): kept {gp['kept']}, "
          f"{gp['ms_host']:.1f} ms; multiclass_nms3 (host): {mn['kept']} "
          f"rows an image of {mn['boxes_per_image']} boxes, "
          f"{mn['ms_host']:.1f} ms; both equal to the CPU's", flush=True)
    torch.cuda.empty_cache()
    return out


def vision_zoo(torch, paddle, card):
    """Phase 25 (e): the smallest factory of each family (ZOO) in f32, eval,
    batch 2, on the card against a CPU copy with its weights, within
    closeness's f32 gate."""
    import numpy as np
    from paddle_tpu_torch.vision import models
    rng = np.random.default_rng(VISION_SEED + 4)
    out = {}
    for name, shape in ZOO:
        x = rng.standard_normal((2, *shape)).astype(np.float32)
        paddle.set_device("gpu")
        paddle.seed(VISION_SEED + 4)
        card_net = getattr(models, name)()
        paddle.set_device("cpu")
        cpu_net = getattr(models, name)()
        cpu_net.set_state_dict(card_net.state_dict())
        res = []
        for dev, net in (("gpu", card_net), ("cpu", cpu_net)):
            paddle.set_device(dev)
            net.eval()
            with torch.no_grad():
                res.append(net(paddle.to_tensor(x))._data.float().cpu())
        paddle.set_device("gpu")
        gate = closeness(res[0], res[1])
        if gate["ratio"] > 1 or not torch.isfinite(res[0]).all():
            fail(f"phase 25 (e) {name}: card vs CPU {gate}")
        out[name] = dict(ratio=gate["ratio"],
                         max_abs_err=gate["max_abs_err"],
                         shape=list(res[0].shape))
        del card_net, cpu_net
    torch.cuda.empty_cache()
    worst = max(out, key=lambda k: out[k]["ratio"])
    print(f"vision (e) zoo, {len(out)} families, f32 batch 2 card vs CPU: "
          f"worst {worst} ratio {out[worst]['ratio']:.3f} (pass <= 1) on "
          f"{card}", flush=True)
    return out


def vision_main_path(torch, launches_of, reset_counts, card):
    """Phase 25: paddle.vision on the card, (a)-(e); ``set_device("gpu")``
    throughout but for the CPU copies."""
    import paddle_tpu_torch as paddle
    t0 = time.perf_counter()
    paddle.set_device("gpu")
    out = dict(cross_check=vision_cross_check(torch, paddle))
    out["serving"] = vision_serving(torch, paddle, launches_of,
                                    reset_counts, card)
    out["training"] = vision_train_main_path(torch, paddle, launches_of,
                                             reset_counts, card)
    out["detection"] = vision_detection_ops(torch, paddle, card)
    out["zoo"] = vision_zoo(torch, paddle, card)
    paddle.set_device("gpu")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 25 in {out['seconds']:.1f} s", flush=True)
    return out


# -- phase 26: fft, signal, audio, text.viterbi, geometric, sparse, ------
# -- distribution: BERT-CRF tagging, a Whisper log-mel front end and an ---
# -- ogbn-arxiv GCN -------------------------------------------------------

#: the seed every phase-26 input and weight is drawn from
SIGNAL_SEED = 26
#: (a) PaddleNLP's BERT/ERNIE + CRF token classification at BERT-base
#: widths (12 layers, hidden 768, 12 heads, vocabulary 30,522), MSRA-NER's
#: 7 BIO tags + start and stop (N = 9), max_seq_len 128; lengths 32-128;
#: a card-vs-CPU copy at batch 4, served at batch 32; RUNS timed runs
CRF = dict(layers=12, tags=9, seq=128, len_lo=32, len_hi=128, xcheck=4,
           batch=32, runs=5)
#: (b) Whisper's front end (openai/whisper, whisper/audio.py): 16 kHz,
#: N_FFT 400, HOP_LENGTH 160, 80 mels, 30 s chunks; 16 chunks a batch;
#: MFCC with 40 coefficients; a batch of 2 against the CPU
WHISPER = dict(sr=16000, n_fft=400, hop=160, n_mels=80, seconds=30.0,
               batch=16, n_mfcc=40, xcheck=2, runs=5)
#: (c) Planetoid Cora in Kipf & Welling's GCN (2,708 nodes, 10,556
#: directed edges, 1,433 bag-of-words features, 7 classes, hidden 16,
#: dropout 0 for the check); OGB ogbn-arxiv (169,343 nodes, 1,166,243
#: edges made symmetric, 128 features, 40 classes) in OGB's GCN baseline
#: (3 layers, hidden 256, BatchNorm, ReLU, dropout 0.5, Adam at 0.01),
#: 2 warm and 10 timed full-batch steps a route; PGL's GraphSAGE sizes
#: [25, 10] for 1,024 seeds
CORA = dict(nodes=2708, edges=10556, feats=1433, classes=7, hidden=16,
            words=18)
ARXIV = dict(nodes=169343, edges=1166243, feats=128, classes=40,
             hidden=256, layers=3, dropout=0.5, lr=0.01, warm=2, steps=10,
             zipf=1.8)
SAGE = dict(sizes=(25, 10), seeds=1024)
#: (d) a policy-gradient / VAE loss's width: parameters [4096, 256],
#: Categorical over [4096, 1000] logits, MultivariateNormal and
#: LKJCholesky at d = 64; SAMPLES draws a class for the moment gates
DIST = dict(rows=4096, cols=256, classes=1000, d=64, samples=65536)
#: (e) SECOND's voxel backbone (PaddleDetection): a 41 x 1600 x 1408
#: grid, 4 point features, the first SubmConv3D(4, 16, 3), 16,000 active
#: voxels; the card-vs-CPU crop 41 x 200 x 176
SECOND = dict(grid=(41, 1600, 1408), crop=(41, 200, 176), in_ch=4,
              out_ch=16, voxels=16000)


def _gate26(what, got, ref, **kw):
    """closeness's gate (f32 unless given) of a card result against the
    CPU's; fails the phase beyond it."""
    import torch
    got, ref = got.detach().cpu(), ref.detach().cpu()
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    if tuple(got.shape) != tuple(ref.shape):
        fail(f"phase 26 {what}: shape {tuple(got.shape)} vs "
             f"{tuple(ref.shape)}")
    c = closeness(got.double(), ref.double(), **kw)
    if not c["ratio"] <= 1.0:
        fail(f"phase 26 {what}: card vs CPU {c}")
    return c


# -- (a) BERT-CRF ---------------------------------------------------------

def _crf_batch(rng, cfg, batch):
    import numpy as np
    ids = rng.integers(1, cfg.vocab_size, (batch, CRF["seq"]))
    lens = rng.integers(CRF["len_lo"], CRF["len_hi"] + 1, batch)
    am = (np.arange(CRF["seq"])[None, :] < lens[:, None]).astype(np.int64)
    return ids.astype(np.int64) * am, lens.astype(np.int64), am


def _path_score(em, trans, path, n):
    """A path's score under the text.viterbi convention (start row N-1,
    stop row N-2 at the last valid step), in f64."""
    N = trans.shape[0]
    s = trans[N - 1, path[0]] + em[0, path[0]]
    for t in range(1, n):
        s += trans[path[t - 1], path[t]] + em[t, path[t]]
    return s + trans[N - 2, path[n - 1]]


def crf_main_path(torch, paddle, mods, launches_of, reset_counts, card):
    """Phase 26 (a), the serving path that reaches a TPU kernel's port:
    the port's BertModel (12 layers, BERT-base) -> Linear(768, 9) ->
    ``text.ViterbiDecoder(transitions, include_bos_eos_tag=True)``.
    A card-vs-CPU copy at batch 4 in f32 (emissions within the f32 gate;
    each card path re-scored under the CPU's emissions within the gate of
    the CPU's best score), then batch 32 x 128 served in f32 and with a
    bf16 copy of the encoder (emissions decoded in f32), counts to 0 just
    before each and read just after: every flash forward launch of the
    f32 path on tf32x3, of the bf16 path on tc."""
    import dataclasses

    import numpy as np
    cfg = dataclasses.replace(mods.BertConfig(),
                              num_hidden_layers=CRF["layers"],
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    g = torch.Generator().manual_seed(SIGNAL_SEED)
    head_w = torch.randn(CRF["tags"], cfg.hidden_size, generator=g) * 0.05
    head_b = torch.randn(CRF["tags"], generator=g) * 0.1
    trans = torch.randn(CRF["tags"], CRF["tags"], generator=g)
    enc = mods.BertModel(cfg, device="cuda", seed=SIGNAL_SEED).eval()
    cpu = mods.BertModel(cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in enc.state_dict().items()})
    heads = {"cpu": (head_w, head_b, trans)}
    heads["cuda"] = tuple(t.to("cuda") for t in heads["cpu"])

    def emissions(net, dev, ids, am):
        w, b, _ = heads[dev]
        seq = net(ids, attention_mask=am)[0]
        return seq.float() @ w.T + b

    def decode(dev, em, lens):
        dec = paddle.text.ViterbiDecoder(paddle.to_tensor(heads[dev][2]),
                                         include_bos_eos_tag=True)
        sc, path = dec(paddle.to_tensor(em), paddle.to_tensor(lens))
        return sc._data, path._data

    rng = np.random.default_rng(SIGNAL_SEED)
    ids, lens, am = _crf_batch(rng, cfg, CRF["xcheck"])
    res = {}
    with torch.no_grad():
        for dev, net in (("cuda", enc), ("cpu", cpu)):
            paddle.set_device("gpu" if dev == "cuda" else "cpu")
            t = [torch.from_numpy(a).to(dev) for a in (ids, lens, am)]
            em = emissions(net, dev, t[0], t[2])
            res[dev] = (em, *decode(dev, em, t[1]))
    paddle.set_device("gpu")
    em_gate = _gate26("(a) emissions", res["cuda"][0], res["cpu"][0])
    em_cpu = res["cpu"][0].double().numpy()
    tr = trans.double().numpy()
    paths = res["cuda"][2].cpu().numpy()
    rescored = torch.tensor([_path_score(em_cpu[b], tr, paths[b], lens[b])
                             for b in range(len(lens))])
    score_gate = _gate26("(a) re-scored card paths", rescored,
                         res["cpu"][1].double())
    same = float(np.mean([np.array_equal(paths[b, :n],
                                         res["cpu"][2].numpy()[b, :n])
                          for b, n in enumerate(lens)]))
    del cpu
    # serving at batch 32 x 128: f32, then the bf16 copy
    ids, lens, am = _crf_batch(rng, cfg, CRF["batch"])
    t_ids, t_lens, t_am = (torch.from_numpy(a).to("cuda")
                           for a in (ids, lens, am))
    enc16 = mods.BertModel(cfg, device="cuda", seed=SIGNAL_SEED).eval()
    enc16.load_state_dict(enc.state_dict())
    enc16.to(torch.bfloat16)
    out = dict(xcheck=dict(batch=CRF["xcheck"], emissions=em_gate,
                           rescored=score_gate, identical_share=same))
    for what, net in (("f32", enc), ("bf16", enc16)):
        with torch.no_grad():
            em = emissions(net, "cuda", t_ids, t_am)
            decode("cuda", em, t_lens)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            em = emissions(net, "cuda", t_ids, t_am)
            sc, path = decode("cuda", em, t_lens)
            torch.cuda.synchronize()
            launches = launches_of()
            counters = {k: v for k, v in paddle.monitor.snapshot().items()
                        if k.startswith("kernels.")}
            # -- end of the counted path --
            peak = torch.cuda.max_memory_allocated() / 1e9
            enc_ev, enc_host = _events_and_host(
                torch, lambda: emissions(net, "cuda", t_ids, t_am),
                CRF["runs"])
            dec_ev, dec_host = _events_and_host(
                torch, lambda: decode("cuda", em, t_lens), CRF["runs"])
            bat_ev, bat_host = _events_and_host(
                torch, lambda: decode("cuda", emissions(
                    net, "cuda", t_ids, t_am), t_lens), CRF["runs"])
            dec_launch = device_kernels(
                torch, lambda: decode("cuda", em, t_lens))
        if not (bool(torch.isfinite(sc).all())
                and tuple(path.shape) == (CRF["batch"], CRF["seq"])):
            fail(f"phase 26 (a) {what}: scores / paths {tuple(path.shape)}")
        want = CRF["layers"]
        routes = flash_routes(counters)
        route = "fwd_cuda_tf32x3" if what == "f32" else "fwd_cuda_tc"
        if launches["flash_fwd"] != want or routes[route] != want:
            fail(f"phase 26 (a) {what}: flash forward launches "
                 f"{launches['flash_fwd']}, by route {routes}, expected "
                 f"{want} on {route}")
        toks = int(lens.sum())
        rec = dict(launches=launches, counters=counters, flash_routes=routes,
                   encoder_ms_events=enc_ev, encoder_ms_host=enc_host,
                   decode_ms_events=dec_ev, decode_ms_host=dec_host,
                   batch_ms_events=bat_ev, batch_ms_host=bat_host,
                   decode_launches=dec_launch,
                   decode_share=dec_ev / bat_ev,
                   sequences_per_s=CRF["batch"] / bat_host * 1e3,
                   tokens_per_s=toks / bat_host * 1e3,
                   padded_tokens_per_s=CRF["batch"] * CRF["seq"]
                   / bat_host * 1e3, peak_gb=peak, paths=path.cpu())
        out[what] = rec
        print(f"phase 26 (a) BERT-CRF {what} (BERT-base widths x "
              f"{CRF['layers']} layers, batch {CRF['batch']} x {CRF['seq']}, "
              f"{toks} valid tokens): batch "
              f"{bat_ev:.2f} ms events / {bat_host:.2f} host = encoder "
              f"{enc_ev:.2f} / {enc_host:.2f} + decode {dec_ev:.2f} / "
              f"{dec_host:.2f} ({dec_launch} device kernels); "
              f"{rec['sequences_per_s']:.0f} sequences/s, "
              f"{rec['tokens_per_s']:.0f} tokens/s; flash forward "
              f"{routes}; peak {peak:.2f} GB on {card}", flush=True)
    b16 = out["bf16"].pop("paths").numpy()
    f32 = out["f32"].pop("paths").numpy()
    out["bf16_identical_share"] = float(np.mean([
        np.array_equal(b16[b, :n], f32[b, :n]) for b, n in enumerate(lens)]))
    print(f"phase 26 (a) cross-check at batch {CRF['xcheck']}: emissions "
          f"ratio {em_gate['ratio']:.3f}, re-scored paths ratio "
          f"{score_gate['ratio']:.3f} (pass <= 1), {same:.2f} of paths "
          f"identical; bf16 paths equal to f32's: "
          f"{out['bf16_identical_share']:.2f}", flush=True)
    del enc, enc16
    free_cuda(torch)
    return out


# -- (b) the Whisper log-mel front end ---------------------------------------

def audio_main_path(torch, paddle, card):
    """Phase 26 (b): 16 x 30 s of ``audio.datasets``' seeded tones and
    noise through ``LogMelSpectrogram`` at Whisper's settings ([16, 80,
    3001]) and ``MFCC``; ``istft(stft(x))`` with a Hann window equal to x
    within 1e-5 max|x| away from the edges; fft / rfft2 / irfftn / hfft /
    ihfft2 on [2, 3001, 400], stft, the log-mel and the MFCC at batch 2
    against the CPU; a WAV written and read back."""
    import numpy as np
    from paddle_tpu_torch.audio import datasets as adatasets
    from paddle_tpu_torch.audio import features as afeatures
    W = WHISPER
    syn = adatasets._SyntheticAudio(7, W["batch"], W["sr"], W["seconds"],
                                    SIGNAL_SEED)
    x = torch.from_numpy(syn._waves).to("cuda")
    n_frames = int(W["sr"] * W["seconds"]) // W["hop"] + 1
    layers = {}

    def build(dev):
        paddle.set_device("gpu" if dev == "cuda" else "cpu")
        lm = afeatures.LogMelSpectrogram(
            sr=W["sr"], n_fft=W["n_fft"], hop_length=W["hop"],
            n_mels=W["n_mels"], f_min=0.0, f_max=8000.0, power=2.0,
            top_db=80.0)
        mf = afeatures.MFCC(sr=W["sr"], n_mfcc=W["n_mfcc"],
                            n_mels=W["n_mels"], n_fft=W["n_fft"],
                            hop_length=W["hop"])
        return lm, mf
    layers["cuda"] = build("cuda")
    layers["cpu"] = build("cpu")
    paddle.set_device("gpu")
    lm, mf = layers["cuda"]
    xt = paddle.to_tensor(x)
    win = paddle.audio.functional.get_window("hann", W["n_fft"])
    out = {}
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        logmel = lm(xt)._data
        mfcc = mf(xt)._data
        if tuple(logmel.shape) != (W["batch"], W["n_mels"], n_frames) or \
                tuple(mfcc.shape) != (W["batch"], W["n_mfcc"], n_frames):
            fail(f"phase 26 (b): log-mel {tuple(logmel.shape)}, MFCC "
                 f"{tuple(mfcc.shape)}")
        if not (bool(torch.isfinite(logmel).all())
                and bool(torch.isfinite(mfcc).all())):
            fail("phase 26 (b): the features are not finite")
        for name, fn in (
                ("logmel", lambda: lm(xt)), ("mfcc", lambda: mf(xt)),
                ("stft", lambda: paddle.signal.stft(
                    xt, W["n_fft"], W["hop"], window=win)),
                ("istft_of_stft", lambda: paddle.signal.istft(
                    paddle.signal.stft(xt, W["n_fft"], W["hop"], window=win),
                    W["n_fft"], W["hop"], window=win,
                    length=x.shape[-1]))):
            ev, host = _events_and_host(torch, fn, W["runs"])
            out[name] = dict(ms_events=ev, ms_host=host,
                             frames_per_s=W["batch"] * n_frames / ev * 1e3)
        back = paddle.signal.istft(
            paddle.signal.stft(xt, W["n_fft"], W["hop"], window=win),
            W["n_fft"], W["hop"], window=win, length=x.shape[-1])._data
        edge = W["n_fft"]
        err = float((back - x)[:, edge:-edge].abs().max())
        lim = 1e-5 * float(x.abs().max())
        if not err <= lim:
            fail(f"phase 26 (b): istft(stft(x)) off by {err:.3e} > {lim:.3e}")
        peak = torch.cuda.max_memory_allocated() / 1e9
    # card vs CPU at batch 2
    B = W["xcheck"]
    g = np.random.default_rng(SIGNAL_SEED + 1)
    a = g.standard_normal((B, n_frames, W["n_fft"])).astype(np.float32)
    c = (g.standard_normal((B, n_frames, W["n_fft"] // 2 + 1))
         + 1j * g.standard_normal((B, n_frames, W["n_fft"] // 2 + 1))
         ).astype(np.complex64)
    gates = {}
    cases = {"fft": (a, lambda t: paddle.fft.fft(t)),
             "rfft2": (a, lambda t: paddle.fft.rfft2(t)),
             "irfftn": (c, lambda t: paddle.fft.irfftn(t)),
             "hfft": (c, lambda t: paddle.fft.hfft(t)),
             "ihfft2": (a, lambda t: paddle.fft.ihfft2(t)),
             "stft": (syn._waves[:B], lambda t: paddle.signal.stft(
                 t, W["n_fft"], W["hop"], window=paddle.audio.functional
                 .get_window("hann", W["n_fft"]))),
             "logmel": (syn._waves[:B], None), "mfcc": (syn._waves[:B],
                                                        None)}
    with torch.no_grad():
        for name, (arr_, fn) in cases.items():
            got = {}
            for dev in ("cuda", "cpu"):
                paddle.set_device("gpu" if dev == "cuda" else "cpu")
                t = paddle.to_tensor(torch.from_numpy(arr_).to(dev))
                if fn is None:
                    layer = layers[dev][0 if name == "logmel" else 1]
                    got[dev] = layer(t)._data
                else:
                    got[dev] = fn(t)._data
                if name in ("fft", "rfft2", "irfftn", "hfft", "ihfft2") \
                        and dev == "cuda":
                    ev, _ = _events_and_host(torch, lambda: fn(t), 3)
                    out.setdefault("fft_ms", {})[name] = ev
            gates[name] = _gate26(f"(b) {name}", got["cuda"], got["cpu"])
    paddle.set_device("gpu")
    # a WAV written by audio.save, read back by audio.load
    wav = OUT_DIR / "phase26_whisper.wav"
    clip = x[:2, :W["sr"]].clamp(-0.99, 0.99)
    paddle.audio.save(str(wav), paddle.to_tensor(clip), W["sr"])
    loaded, sr = paddle.audio.load(str(wav))
    werr = float((loaded._data.to(clip.device) - clip).abs().max())
    if sr != W["sr"] or not werr <= 1.0 / 32768 + 1e-7:
        fail(f"phase 26 (b): WAV round trip sr {sr}, error {werr:.3e}")
    wav.unlink()
    out.update(shape_logmel=list(logmel.shape), shape_mfcc=list(mfcc.shape),
               istft_max_err=err, istft_limit=lim, gates=gates,
               wav_max_err=werr, peak_gb=peak)
    print(f"phase 26 (b) Whisper front end ([{W['batch']}, "
          f"{int(W['sr'] * W['seconds'])}] -> log-mel "
          f"{list(logmel.shape)}, MFCC {list(mfcc.shape)}): log-mel "
          f"{out['logmel']['ms_events']:.2f} ms events / "
          f"{out['logmel']['ms_host']:.2f} host "
          f"({out['logmel']['frames_per_s']:.0f} frames/s), MFCC "
          f"{out['mfcc']['ms_events']:.2f} / {out['mfcc']['ms_host']:.2f}, "
          f"stft {out['stft']['ms_events']:.2f}, istft(stft) "
          f"{out['istft_of_stft']['ms_events']:.2f}; fft ms "
          f"{ {k: round(v, 3) for k, v in out['fft_ms'].items()} }; "
          f"istft error {err:.2e} (limit {lim:.2e}); card vs CPU ratios "
          f"{ {k: round(v['ratio'], 3) for k, v in gates.items()} }; "
          f"peak {peak:.2f} GB on {card}", flush=True)
    return out


# -- (c) graph learning --------------------------------------------------------

def _random_graph(rng, n, e, zipf=None):
    """``e`` directed edges (sources Zipf-distributed over a random
    ranking of the nodes when ``zipf``), made symmetric."""
    import numpy as np
    if zipf:
        rank = rng.permutation(n)
        src = rank[np.minimum(rng.zipf(zipf, e) - 1, n - 1)]
    else:
        src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    return (np.concatenate([src, dst]).astype(np.int64),
            np.concatenate([dst, src]).astype(np.int64))


def _gcn_norm(src, dst, n):
    """Self loops added, then D^-1/2 (A + I) D^-1/2 per edge (f32)."""
    import numpy as np
    loops = np.arange(n, dtype=np.int64)
    s, d = np.concatenate([src, loops]), np.concatenate([dst, loops])
    deg = np.bincount(d, minlength=n).astype(np.float64)
    w = (1.0 / np.sqrt(deg[s] * deg[d])).astype(np.float32)
    return s, d, w


def _aggregate(paddle, route, graph):
    """The aggregation A_hat h of one route."""
    src, dst, w, adj, n = graph
    if route == "send_ue_recv":
        return lambda h: paddle.geometric.send_ue_recv(
            h, w, src, dst, "mul", "sum", out_size=n)
    return lambda h: paddle.sparse.matmul(adj, h)


def _graph_tensors(paddle, torch, s, d, w, n, dev):
    import numpy as np
    paddle.set_device("gpu" if dev == "cuda" else "cpu")
    src = paddle.to_tensor(torch.from_numpy(s).to(dev))
    dst = paddle.to_tensor(torch.from_numpy(d).to(dev))
    wt = paddle.to_tensor(torch.from_numpy(w[:, None]).to(dev))
    adj = paddle.sparse.sparse_coo_tensor(
        paddle.to_tensor(torch.from_numpy(np.stack([d, s])).to(dev)),
        paddle.to_tensor(torch.from_numpy(w).to(dev)), [n, n])
    return src, dst, wt, adj, n


def cora_cross_check(torch, paddle, card):
    """Phase 26 (c) check: a 2-layer GCN at Cora's shape, forward and
    backward on the card and on the CPU through each aggregation route:
    the loss and every gradient within the f32 gate, and the two routes
    within the gate of each other."""
    import numpy as np
    C = CORA
    rng = np.random.default_rng(SIGNAL_SEED + 2)
    src, dst = _random_graph(rng, C["nodes"], C["edges"] // 2)
    s, d, w = _gcn_norm(src, dst, C["nodes"])
    x = (rng.random((C["nodes"], C["feats"])) < C["words"] / C["feats"]
         ).astype(np.float32)
    y = rng.integers(0, C["classes"], C["nodes"]).astype(np.int64)
    w1 = (rng.standard_normal((C["feats"], C["hidden"]))
          / np.sqrt(C["feats"])).astype(np.float32)
    w2 = (rng.standard_normal((C["hidden"], C["classes"]))
          / np.sqrt(C["hidden"])).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        graph = _graph_tensors(paddle, torch, s, d, w, C["nodes"], dev)
        for route in ("send_ue_recv", "sparse_matmul"):
            agg = _aggregate(paddle, route, graph)
            ps = [paddle.to_tensor(torch.from_numpy(a).to(dev),
                                   stop_gradient=False) for a in (w1, w2)]
            xt = paddle.to_tensor(torch.from_numpy(x).to(dev))
            h = paddle.nn.functional.relu(agg(paddle.matmul(xt, ps[0])))
            logits = agg(paddle.matmul(h, ps[1]))
            loss = paddle.nn.functional.cross_entropy(
                logits, paddle.to_tensor(torch.from_numpy(y).to(dev)))
            loss.backward()
            res[(dev, route)] = [loss._data.detach(), logits._data.detach()
                                 ] + [p.grad._data for p in ps]
    paddle.set_device("gpu")
    names = ("loss", "logits", "grad_w1", "grad_w2")
    gates = {}
    for route in ("send_ue_recv", "sparse_matmul"):
        for nm, a, b in zip(names, res[("cuda", route)], res[("cpu", route)]):
            gates[f"{route}.{nm}"] = _gate26(f"(c) Cora {route} {nm}", a, b)
    for nm, a, b in zip(names, res[("cuda", "send_ue_recv")],
                        res[("cuda", "sparse_matmul")]):
        gates[f"routes.{nm}"] = _gate26(f"(c) Cora routes {nm}", a, b)
    worst = max(v["ratio"] for v in gates.values())
    print(f"phase 26 (c) Cora GCN ({C['nodes']} nodes, {len(s)} edges with "
          f"self loops, {C['feats']} features): loss "
          f"{float(res[('cuda', 'send_ue_recv')][0]):.6f}; card vs CPU and "
          f"route vs route worst ratio {worst:.3f} (pass <= 1) on {card}",
          flush=True)
    return dict(gates=gates, worst_ratio=worst)


def _gcn_layer(paddle):
    class GCN(paddle.nn.Layer):
        """OGB's full-batch GCN: (Linear -> A_hat -> BatchNorm -> ReLU ->
        dropout) x (layers - 1), then Linear -> A_hat."""

        def __init__(self, agg, feats, hidden, classes, layers, dropout):
            super().__init__()
            dims = [feats] + [hidden] * (layers - 1) + [classes]
            self.lins = paddle.nn.LayerList([
                paddle.nn.Linear(a, b) for a, b in zip(dims, dims[1:])])
            self.bns = paddle.nn.LayerList([
                paddle.nn.BatchNorm1D(hidden) for _ in range(layers - 1)])
            self.drop = paddle.nn.Dropout(dropout)
            self.agg = agg

        def forward(self, x):
            for lin, bn in zip(self.lins[:-1], self.bns):
                x = self.drop(paddle.nn.functional.relu(bn(self.agg(lin(x)))))
            return self.agg(self.lins[-1](x))
    return GCN


def arxiv_main_path(torch, paddle, launches_of, reset_counts, card):
    """Phase 26 (c) main path: OGB's GCN baseline at ogbn-arxiv's shape
    through ``Model.train_batch`` in f32 (full batch), on each
    aggregation route: 2 warm steps, then 10 timed, counts to 0 just
    before and read just after; finite, falling losses and no kernel
    build after the first step; the port kernel the path launches is
    the fused Adam update (counted)."""
    import numpy as np
    A = ARXIV
    rng = np.random.default_rng(SIGNAL_SEED + 3)
    t0 = time.perf_counter()
    src, dst = _random_graph(rng, A["nodes"], A["edges"], A["zipf"])
    s, d, w = _gcn_norm(src, dst, A["nodes"])
    x = rng.standard_normal((A["nodes"], A["feats"])).astype(np.float32)
    y = rng.integers(0, A["classes"], A["nodes"]).astype(np.int64)
    data_s = time.perf_counter() - t0
    graph = _graph_tensors(paddle, torch, s, d, w, A["nodes"], "cuda")
    xt = paddle.to_tensor(torch.from_numpy(x).to("cuda"))
    yt = paddle.to_tensor(torch.from_numpy(y).to("cuda"))
    GCN = _gcn_layer(paddle)
    out = dict(nodes=A["nodes"], edges=len(s), data_s=data_s)
    for route in ("send_ue_recv", "sparse_matmul"):
        paddle.seed(SIGNAL_SEED + 4)
        net = GCN(_aggregate(paddle, route, graph), A["feats"], A["hidden"],
                  A["classes"], A["layers"], A["dropout"])
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.Adam(A["lr"],
                                            parameters=net.parameters()),
                      paddle.nn.CrossEntropyLoss())
        if model._train_step is None:
            fail("phase 26 (c): Model.prepare built no TrainStep")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, builds, step_ev, step_host = [], [], [], []
        for i in range(A["warm"] + A["steps"]):
            ev, host = _events_and_host(torch, lambda: losses.append(
                model.train_batch([xt], yt)[0]), 1)
            step_ev.append(ev)
            step_host.append(host)
            builds.append(int(paddle.monitor.snapshot().get(
                "kernels.builds", 0)))
        launches = launches_of()
        # -- end of the counted path --
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(map(math.isfinite, losses)) or \
                not losses[-1] < losses[0]:
            fail(f"phase 26 (c) {route}: losses {losses}")
        if len(set(builds)) != 1:
            fail(f"phase 26 (c) {route}: kernel builds after the first "
                 f"step: {builds}")
        others = {k: v for k, v in launches.items() if k != "fused_adam"}
        if any(others.values()) or not launches["fused_adam"]:
            fail(f"phase 26 (c) {route}: port kernels launched {launches} "
                 f"(the fused Adam update only is on the path)")
        warm = A["warm"]
        ev = statistics.median(step_ev[warm:])
        host = statistics.median(step_host[warm:])
        rec = dict(losses=losses, step_ms_events=ev, step_ms_host=host,
                   edges_per_s=len(s) / host * 1e3, peak_gb=peak,
                   builds=builds, launches=launches,
                   step_events_ms=step_ev, step_host_ms=step_host)
        out[route] = rec
        print(f"phase 26 (c) ogbn-arxiv GCN via {route} ({A['nodes']} "
              f"nodes, {len(s)} edges with self loops, {A['layers']} layers "
              f"x {A['hidden']}, f32, {A['steps']} timed steps): losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; step {ev:.2f} ms "
              f"events / {host:.2f} host, {rec['edges_per_s']:.3e} edges/s; "
              f"peak {peak:.2f} GB on {card}", flush=True)
        del model, net
    out["csc"] = (s, d)
    return out


def sage_sampling(torch, paddle, csc, card):
    """Phase 26 (c) sampling: GraphSAGE at PGL's sizes [25, 10] for 1,024
    seeds on the arxiv graph in CSC: ``geometric.sample_neighbors`` twice
    and ``reindex_graph``, then ``incubate.graph_khop_sampler``; the
    samples a subset of the neighbours with no repeats, count = min(size,
    degree), the edge ids of the picks distinct and the picks' own; host
    ms of each."""
    import numpy as np
    s, d = csc
    n = ARXIV["nodes"]
    order = np.argsort(d, kind="stable")
    row = s[order]
    colptr = np.concatenate([[0], np.cumsum(np.bincount(d, minlength=n))]
                            ).astype(np.int64)
    deg = np.diff(colptr)
    rng = np.random.default_rng(SIGNAL_SEED + 5)
    seeds = rng.choice(n, SAGE["seeds"], replace=False).astype(np.int64)
    paddle.seed(SIGNAL_SEED + 5)
    t_row, t_col, t_seeds, t_eids = (
        paddle.to_tensor(torch.from_numpy(a).to("cuda"))
        for a in (row, colptr, seeds, np.arange(len(row), dtype=np.int64)))
    out, frontier = {}, t_seeds
    hop_nodes = []
    t0 = time.perf_counter()
    for hop, size in enumerate(SAGE["sizes"]):
        t1 = time.perf_counter()
        nb, cnt, eid = paddle.geometric.sample_neighbors(
            t_row, t_col, frontier, sample_size=size, eids=t_eids,
            return_eids=True)
        torch.cuda.synchronize()
        out[f"hop{hop}_ms"] = (time.perf_counter() - t1) * 1e3
        nodes = frontier.numpy()
        nb_np, cnt_np, eid_np = nb.numpy(), cnt.numpy(), eid.numpy()
        if cnt_np.tolist() != np.minimum(deg[nodes], size).tolist():
            fail(f"phase 26 (c) sampling hop {hop}: counts differ from "
                 f"min(size, degree)")
        owner = np.repeat(nodes, cnt_np)
        # each pick an edge of its node (CSC positions), none twice, and
        # the neighbour that edge brings
        if not (np.all(eid_np >= colptr[owner])
                and np.all(eid_np < colptr[owner + 1])
                and np.array_equal(row[eid_np], nb_np)
                and len(np.unique(eid_np)) == len(eid_np)):
            fail(f"phase 26 (c) sampling hop {hop}: a pick is not an edge "
                 f"of its node, or an edge was picked twice")
        hop_nodes.append((frontier, nb, cnt))
        frontier = paddle.to_tensor(torch.from_numpy(np.unique(
            np.concatenate([nodes, nb_np]))).to("cuda"))
    t1 = time.perf_counter()
    r_src, r_dst, r_nodes = paddle.geometric.reindex_graph(*hop_nodes[0])
    torch.cuda.synchronize()
    out["reindex_ms"] = (time.perf_counter() - t1) * 1e3
    out["sample_two_hops_and_reindex_ms"] = (time.perf_counter() - t0) * 1e3
    if r_nodes.numpy()[:SAGE["seeds"]].tolist() != seeds.tolist():
        fail("phase 26 (c) reindex_graph: the seeds do not come first")
    t1 = time.perf_counter()
    k_src, k_dst, k_nodes, k_idx = paddle.incubate.graph_khop_sampler(
        t_row, t_col, t_seeds, list(SAGE["sizes"]))
    torch.cuda.synchronize()
    out["khop_ms"] = (time.perf_counter() - t1) * 1e3
    kn = k_nodes.numpy()
    if k_idx.numpy().tolist() != list(range(SAGE["seeds"])):
        fail("phase 26 (c) graph_khop_sampler: sample_index is not the seeds")
    out["khop_edges"] = int(k_src.shape[0])
    out["khop_nodes"] = int(len(kn))
    print(f"phase 26 (c) GraphSAGE sampling [{SAGE['sizes'][0]}, "
          f"{SAGE['sizes'][1]}] x {SAGE['seeds']} seeds: hop 0 "
          f"{out['hop0_ms']:.1f} ms, hop 1 {out['hop1_ms']:.1f} ms, reindex "
          f"{out['reindex_ms']:.1f} ms (host); graph_khop_sampler "
          f"{out['khop_ms']:.1f} ms host, {out['khop_edges']} edges over "
          f"{out['khop_nodes']} nodes on {card}", flush=True)
    return out


# -- (d) distributions -------------------------------------------------------

def _dist_cases(D):
    """name -> (ctor of params, params as numpy, value, methods)."""
    import numpy as np
    r, c = DIST["rows"], DIST["cols"]
    k, d = DIST["classes"], DIST["d"]
    g = np.random.default_rng(SIGNAL_SEED + 6)

    def u(lo, hi, *shape):
        return g.uniform(lo, hi, shape).astype(np.float32)
    a = g.standard_normal((d, d))
    cov = (a @ a.T / d + np.eye(d)).astype(np.float32)
    corr = cov.astype(np.float64)
    sd = np.sqrt(np.diag(corr))
    lkj_l = np.linalg.cholesky(corr / np.outer(sd, sd)).astype(np.float32)
    return {
        "Normal": (lambda m, s: D.Normal(m, s), [u(-1, 1, r, c),
                   u(.5, 2, r, c)], u(-2, 2, r, c)),
        "Uniform": (lambda lo, hi: D.Uniform(lo, hi), [u(-2, -1, r, c),
                    u(1, 2, r, c)], u(-1, 1, r, c)),
        "Bernoulli": (lambda lg: D.Bernoulli(logits=lg), [u(-2, 2, r, c)],
                      (g.random((r, c)) < .5).astype(np.float32)),
        "Categorical": (lambda lg: D.Categorical(lg), [u(-3, 3, r, k)],
                        g.integers(0, k, r).astype(np.int64)),
        "Exponential": (lambda lam: D.Exponential(lam), [u(.5, 2, r, c)],
                        u(.1, 3, r, c)),
        "Cauchy": (lambda m, s: D.Cauchy(m, s), [u(-1, 1, r, c),
                   u(.5, 2, r, c)], u(-3, 3, r, c)),
        "ContinuousBernoulli": (lambda p: D.ContinuousBernoulli(p),
                                [u(.05, .95, r, c)], u(.01, .99, r, c)),
        "Geometric": (lambda p: D.Geometric(p), [u(.1, .9, r, c)],
                      g.integers(0, 6, (r, c)).astype(np.float32)),
        "StudentT": (lambda df, m, s: D.StudentT(df, m, s), [
            u(3, 8, r, c), u(-1, 1, r, c), u(.5, 2, r, c)], u(-3, 3, r, c)),
        "Binomial": (lambda p: D.Binomial(np.full((r, c), 10), p),
                     [u(.1, .9, r, c)],
                     g.integers(0, 11, (r, c)).astype(np.float32)),
        "MultivariateNormal": (lambda m, cv: D.MultivariateNormal(
            m, covariance_matrix=cv), [u(-1, 1, d), cov],
            g.standard_normal((r, d)).astype(np.float32)),
        "LKJCholesky": (lambda: D.LKJCholesky(d, 2.0), [], lkj_l),
    }


_KL26 = {
    "Normal": lambda D, p: (D.Normal(p[0], p[1]), D.Normal(p[2], p[1] + 1)),
    "Uniform": lambda D, p: (D.Uniform(p[0] - 2, p[1] + 1),
                             D.Uniform(p[0] - 3, p[1] + 2)),
    "Bernoulli": lambda D, p: (D.Bernoulli(logits=p[0]),
                               D.Bernoulli(logits=p[2])),
    "Categorical": lambda D, p: (D.Categorical(p[3]), D.Categorical(p[4])),
    "Exponential": lambda D, p: (D.Exponential(p[1]), D.Exponential(
        p[1] + 0.5)),
}


def distribution_check(torch, paddle, card):
    """Phase 26 (d): each class's log_prob and entropy (where it has one)
    and the five registered KL pairs at [4096, 256] (Categorical over
    [4096, 1000], MultivariateNormal and LKJCholesky at d = 64), on the
    card against the CPU within the f32 gate with their gradients in the
    parameters (MultivariateNormal and LKJCholesky in f64 too); then
    65,536 draws a class within 4 standard errors of the analytic mean
    and variance, and the five reparameterised rsamples' gradients
    finite."""
    from torch.profiler import ProfilerActivity, profile
    D = paddle.distribution
    gates, ms, first_ops = {}, {}, {}
    for dtype in ("float32", "float64"):
        cases = _dist_cases(D)
        names = sorted(cases) if dtype == "float32" else \
            ["MultivariateNormal", "LKJCholesky"]
        for name in names:
            ctor, params, value = cases[name]
            res = {}

            def run(dev):
                ps = [paddle.to_tensor(torch.from_numpy(p).to(dev),
                                       dtype=dtype, stop_gradient=False)
                      for p in params]
                v = torch.from_numpy(value).to(dev)
                vt = paddle.to_tensor(v, dtype=None if value.dtype.kind in
                                      "iu" else dtype)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist = ctor(*ps)
                outs = [dist.log_prob(vt)]
                if name not in ("LKJCholesky", "ContinuousBernoulli"):
                    outs.append(dist.entropy())
                total = sum(o.sum() for o in outs if not o.stop_gradient)
                grads = []
                if ps and not isinstance(total, int):
                    total.backward()
                    grads = [p.grad._data for p in ps if p.grad is not None]
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3, \
                    [o._data for o in outs] + grads
            for dev in ("cuda", "cpu"):
                paddle.set_device("gpu" if dev == "cuda" else "cpu")
                if dev == "cuda":
                    # the first call is profiled (the host ops that took
                    # the most of it), the second one timed
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        first_ms = run(dev)[0]
                    first_ops[f"{name}.{dtype}"] = [
                        (e.key, e.self_cpu_time_total / 1e3) for e in sorted(
                            prof.key_averages(),
                            key=lambda e: -e.self_cpu_time_total)[:3]]
                    ms[f"{name}.{dtype}"], res[dev] = run(dev)
                    ms[f"{name}.{dtype}.first_call"] = first_ms
                else:
                    res[dev] = run(dev)[1]
            for i, (a, b) in enumerate(zip(res["cuda"], res["cpu"])):
                gates[f"{name}.{dtype}.{i}"] = _gate26(
                    f"(d) {name} {dtype} output {i}", a, b)
    paddle.set_device("gpu")
    for pair in sorted(_KL26):
        res = {}
        for dev in ("cuda", "cpu"):
            paddle.set_device("gpu" if dev == "cuda" else "cpu")
            cs = _dist_cases(D)
            raw = [cs["Normal"][1][0], cs["Normal"][1][1],
                   cs["Cauchy"][1][0], cs["Categorical"][1][0],
                   cs["Categorical"][1][0][::-1].copy()]
            ps = [paddle.to_tensor(torch.from_numpy(p).to(dev),
                                   stop_gradient=False) for p in raw]
            p, q = _KL26[pair](D, ps)
            kl = D.kl_divergence(p, q)
            kl.sum().backward()
            res[dev] = [kl._data] + [t.grad._data for t in ps
                                     if t.grad is not None]
        for i, (a, b) in enumerate(zip(res["cuda"], res["cpu"])):
            gates[f"kl.{pair}.{i}"] = _gate26(f"(d) KL {pair} {i}", a, b)
    paddle.set_device("gpu")
    moments = _moment_gates(torch, paddle, D)
    rs = _rsample_grads(torch, paddle, D)
    worst = max(v["ratio"] for v in gates.values())
    print(f"phase 26 (d) distributions at [{DIST['rows']}, {DIST['cols']}] "
          f"(Categorical x {DIST['classes']}, d = {DIST['d']}): "
          f"{len(gates)} card-vs-CPU outputs and gradients, worst ratio "
          f"{worst:.3f} (pass <= 1); {DIST['samples']} draws of "
          f"{len(moments)} classes within 4 standard errors; rsample "
          f"gradients finite for {sorted(rs)}; ms (second call) "
          f"{ {k: round(v, 2) for k, v in ms.items() if 'first' not in k} } "
          f"on {card}",
          flush=True)
    slow = {k: (round(ms[f"{k}.first_call"], 1), v)
            for k, v in first_ops.items() if ms[f"{k}.first_call"] > 100}
    print(f"phase 26 (d) first calls over 100 ms and their top host ops "
          f"(self ms): {slow}", flush=True)
    return dict(gates=gates, worst_ratio=worst, ms=ms, moments=moments,
                rsample=rs, first_call_top_ops=first_ops)


def _moment_gates(torch, paddle, D):
    """65,536 draws of each class (scalar parameters) against its analytic
    mean and variance, each within 4 standard errors (the variance's
    standard error from the sample's own kurtosis)."""
    import numpy as np
    n = DIST["samples"]

    def f(v):
        return np.float32(v)
    cb = 0.3
    cb_mean = cb / (2 * cb - 1) + 1 / (2 * math.atanh(1 - 2 * cb))
    cb_var = (cb * (cb - 1) / (1 - 2 * cb) ** 2
              + 1 / (2 * math.atanh(1 - 2 * cb)) ** 2)
    table = {
        "Normal": (D.Normal(f(0.5), f(2.0)), 0.5, 4.0),
        "Uniform": (D.Uniform(f(-1.0), f(3.0)), 1.0, 16 / 12),
        "Bernoulli": (D.Bernoulli(f(0.3)), 0.3, 0.21),
        "Categorical": (D.Categorical(np.log(np.array([.2, .5, .3],
                                                      np.float32))),
                        1.1, 0.49),
        "Exponential": (D.Exponential(f(2.0)), 0.5, 0.25),
        "Gamma": (D.Gamma(f(3.0), f(2.0)), 1.5, 0.75),
        "Chi2": (D.Chi2(f(4.0)), 4.0, 8.0),
        "Beta": (D.Beta(f(2.0), f(3.0)), 0.4, 0.04),
        "Laplace": (D.Laplace(f(1.0), f(0.5)), 1.0, 0.5),
        "Gumbel": (D.Gumbel(f(0.0), f(1.0)), 0.5772156649, math.pi ** 2 / 6),
        "Poisson": (D.Poisson(f(3.5)), 3.5, 3.5),
        "Binomial": (D.Binomial(np.array(10), f(0.3)), 3.0, 2.1),
        "Geometric": (D.Geometric(f(0.4)), 1.5, 3.75),
        "StudentT": (D.StudentT(f(6.0), f(1.0), f(2.0)), 1.0, 6.0),
        "ContinuousBernoulli": (D.ContinuousBernoulli(f(cb)), cb_mean,
                                cb_var),
        "LogNormal": (D.LogNormal(f(0.1), f(0.4)), math.exp(0.18),
                      (math.exp(0.16) - 1) * math.exp(0.36)),
        "Dirichlet": (D.Dirichlet(np.array([2.0, 3.0], np.float32)),
                      np.array([0.4, 0.6]), np.array([0.04, 0.04])),
        "Multinomial": (D.Multinomial(5, np.array([.2, .8], np.float32)),
                        np.array([1.0, 4.0]), np.array([0.8, 0.8])),
        "MultivariateNormal": (D.MultivariateNormal(
            np.array([1.0, -1.0], np.float32), covariance_matrix=np.array(
                [[2.0, 0.5], [0.5, 1.0]], np.float32)),
            np.array([1.0, -1.0]), np.array([2.0, 1.0])),
        "Cauchy": (None, None, None),
    }
    out = {}
    paddle.seed(SIGNAL_SEED + 7)
    for name, (dist, mean, var) in table.items():
        if dist is None:                  # no moments: the median, 4 SE
            dist = D.Cauchy(f(1.0), f(2.0))
            s = dist.sample([n]).numpy().astype(np.float64)
            se = math.pi * 2.0 / 2 / math.sqrt(n)
            med = float(np.median(s))
            if not abs(med - 1.0) <= 4 * se:
                fail(f"phase 26 (d) Cauchy: sample median {med} vs 1.0 "
                     f"(4 SE {4 * se:.4f})")
            out[name] = dict(median=med, se=se)
            continue
        s = dist.sample([n]).numpy().astype(np.float64)
        if not np.all(np.isfinite(s)):
            fail(f"phase 26 (d) {name}: non-finite samples")
        m, v = s.mean(axis=0), s.var(axis=0)
        se = np.sqrt(np.asarray(var) / n)
        kurt = np.maximum(((s - m) ** 4).mean(axis=0)
                          / np.maximum(v, 1e-12) ** 2, 3.0)
        se_v = np.asarray(var) * np.sqrt((kurt - 1) / n)
        if not (np.all(np.abs(m - mean) <= 4 * se)
                and np.all(np.abs(v - var) <= 4 * se_v)):
            fail(f"phase 26 (d) {name}: mean {m} var {v}, analytic {mean} "
                 f"{var} (4 SE {4 * se} / {4 * se_v})")
        out[name] = dict(mean=np.asarray(m).tolist(),
                         var=np.asarray(v).tolist())
    return out


def _rsample_grads(torch, paddle, D):
    import numpy as np
    g = np.random.default_rng(SIGNAL_SEED + 8)
    r, c, d = DIST["rows"], DIST["cols"], DIST["d"]

    def t(a):
        return paddle.to_tensor(a.astype(np.float32), stop_gradient=False)
    loc, scale = t(g.uniform(-1, 1, (r, c))), t(g.uniform(.5, 2, (r, c)))
    p = t(g.uniform(.05, .95, (r, c)))
    mloc = t(g.uniform(-1, 1, d))
    a = g.standard_normal((d, d))
    tril = t(np.linalg.cholesky(a @ a.T / d + np.eye(d)))
    out = {}
    for name, dist, leaves in (
            ("Normal", D.Normal(loc, scale), (loc, scale)),
            ("Cauchy", D.Cauchy(loc, scale), (loc, scale)),
            ("ContinuousBernoulli", D.ContinuousBernoulli(p), (p,)),
            ("MultivariateNormal", D.MultivariateNormal(mloc,
                                                        scale_tril=tril),
             (mloc, tril)),
            ("Independent", D.Independent(D.Normal(loc, scale), 1),
             (loc, scale))):
        for x in leaves:
            x.clear_grad()
        s = dist.rsample([4])
        (s * s).mean().backward()
        ok = all(x.grad is not None and bool(torch.isfinite(
            x.grad._data).all()) for x in leaves)
        if not ok:
            fail(f"phase 26 (d) {name}: rsample gradients not finite")
        out[name] = [float(x.grad._data.abs().max()) for x in leaves]
    return out


# -- (e) SECOND's first sparse convolution -----------------------------------

def _voxel_grid(rng, grid, voxels, ch):
    """``voxels`` distinct active sites of a [1, *grid] grid and their
    [voxels, ch] point features (a hybrid COO: indices [4, nnz])."""
    import numpy as np
    flat = rng.choice(int(np.prod(grid)), voxels, replace=False)
    sites = np.stack(np.unravel_index(np.sort(flat), grid))
    idx = np.concatenate([np.zeros((1, voxels), np.int64), sites]
                         ).astype(np.int64)
    return idx, rng.standard_normal((voxels, ch)).astype(np.float32)


def sparse_conv_check(torch, paddle, card):
    """Phase 26 (e): ``sparse.nn.SubmConv3D(4, 16, 3, padding=1)`` on
    SECOND's 41 x 1600 x 1408 grid with 16,000 active voxels, with the
    JAX package's semantics (densify, dense conv, submanifold mask,
    sparsify): ms, peak allocated, nnz in and out; then at a 41 x 200 x
    176 crop the conv, ``sparse.nn.BatchNorm(16)`` and ``MaxPool3D(3, 2,
    1)`` against the CPU within the f32 gate."""
    import numpy as np
    S = SECOND
    rng = np.random.default_rng(SIGNAL_SEED + 9)
    paddle.seed(SIGNAL_SEED + 9)
    conv = paddle.sparse.nn.SubmConv3D(S["in_ch"], S["out_ch"], 3,
                                       padding=1)
    idx, vals = _voxel_grid(rng, S["grid"], S["voxels"], S["in_ch"])
    x = paddle.sparse.sparse_coo_tensor(
        paddle.to_tensor(torch.from_numpy(idx).to("cuda")),
        paddle.to_tensor(torch.from_numpy(vals).to("cuda")),
        [1, *S["grid"], S["in_ch"]])
    with torch.no_grad():
        conv(x)
        torch.cuda.reset_peak_memory_stats()
        y = conv(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        ev, host = _events_and_host(torch, lambda: conv(x), 3)
    nnz_in, nnz_out = x.nnz(), y.nnz()
    active_out = int(y.indices()._data[:4].unique(dim=1).shape[1])
    if active_out > S["voxels"] or y.shape != [1, *S["grid"], S["out_ch"]]:
        fail(f"phase 26 (e): {active_out} active output sites for "
             f"{S['voxels']} input voxels, shape {y.shape}")
    del y
    free_cuda(torch)
    # the crop against the CPU
    crop = S["crop"]
    n_crop = max(1, S["voxels"] * crop[1] * crop[2]
                 // (S["grid"][1] * S["grid"][2]))
    idx, vals = _voxel_grid(rng, crop, n_crop, S["in_ch"])
    state = {k: v.numpy() for k, v in conv.state_dict().items()}
    pool = paddle.sparse.nn.MaxPool3D(3, 2, 1)
    got = {}
    for dev in ("cuda", "cpu"):
        paddle.set_device("gpu" if dev == "cuda" else "cpu")
        c = paddle.sparse.nn.SubmConv3D(S["in_ch"], S["out_ch"], 3,
                                        padding=1)
        c.set_state_dict(state)
        b = paddle.sparse.nn.BatchNorm(S["out_ch"])
        xs = paddle.sparse.sparse_coo_tensor(
            paddle.to_tensor(torch.from_numpy(idx).to(dev)),
            paddle.to_tensor(torch.from_numpy(vals).to(dev)),
            [1, *crop, S["in_ch"]])
        y = c(xs)
        z = b(y)
        p = pool(z)
        got[dev] = [y.to_dense()._data, z.to_dense()._data,
                    p.to_dense()._data, y.nnz(), p.nnz()]
    paddle.set_device("gpu")
    gates = {n: _gate26(f"(e) crop {n}", a, b)
             for n, a, b in zip(("subm_conv", "batch_norm", "max_pool"),
                                got["cuda"][:3], got["cpu"][:3])}
    if got["cuda"][3:] != got["cpu"][3:]:
        fail(f"phase 26 (e) crop: nnz card {got['cuda'][3:]} vs CPU "
             f"{got['cpu'][3:]}")
    out = dict(ms_events=ev, ms_host=host, peak_gb=peak, nnz_in=nnz_in,
               nnz_out=nnz_out, active_out=active_out, crop_gates=gates,
               crop_nnz=got["cpu"][3:])
    print(f"phase 26 (e) SECOND SubmConv3D({S['in_ch']}, {S['out_ch']}, 3) "
          f"on [1, {S['grid'][0]}, {S['grid'][1]}, {S['grid'][2]}, "
          f"{S['in_ch']}] ({S['voxels']} voxels, densified as in JAX): "
          f"{ev:.2f} ms events / {host:.2f} host, peak {peak:.2f} GB, nnz "
          f"in {nnz_in} out {nnz_out} ({active_out} sites); crop "
          f"{list(crop)} card vs CPU ratios "
          f"{ {k: round(v['ratio'], 3) for k, v in gates.items()} } on "
          f"{card}", flush=True)
    return out


def signal_graph_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 26: (a) BERT-CRF tagging, (b) the Whisper log-mel front end,
    (c) the Cora cross-check, ogbn-arxiv GCN training and GraphSAGE
    sampling, (d) distributions, (e) SECOND's first sparse convolution;
    ``set_device("gpu")`` throughout but for the CPU copies."""
    import paddle_tpu_torch as paddle
    t0 = time.perf_counter()
    paddle.set_device("gpu")
    out = dict(crf=crf_main_path(torch, paddle, mods, launches_of,
                                 reset_counts, card))
    out["audio"] = audio_main_path(torch, paddle, card)
    out["cora"] = cora_cross_check(torch, paddle, card)
    arxiv = arxiv_main_path(torch, paddle, launches_of, reset_counts, card)
    out["sampling"] = sage_sampling(torch, paddle, arxiv.pop("csc"), card)
    out["arxiv"] = arxiv
    out["distributions"] = distribution_check(torch, paddle, card)
    out["sparse_conv"] = sparse_conv_check(torch, paddle, card)
    paddle.set_device("gpu")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 26 in {out['seconds']:.1f} s", flush=True)
    return out


# -- phase 27: jit.to_static, static and onnx on the card ------------------

#: (a): phase 19's model cut to 2 layers, f32, dropout 0, batch 4
STATIC_XCHECK_LAYERS, STATIC_XCHECK_BATCH = 2, 4
#: (b): warm steps (they compile) before the TRAIN_STEPS counted ones; then
#: eager and compiled steps in turns (eager, compiled, eager, compiled)
STATIC_WARM, STATIC_TURNS, STATIC_TURN_STEPS = 2, 2, 3
#: (c): timed batches of each serving entry, compiled and eager
STATIC_SERVE_ITERS = 10
#: (c): a 12-layer bf16 forward rounds at other points compiled (Inductor
#: keeps a fused chain's intermediates in f32) than eager, and the layers
#: carry a flipped rounding on, so the compiled bf16 output is held to the
#: eager bf16 one's distance from the f32 forward: its RMS error at most
#: this factor of eager's, and its max error at most twice eager's
STATIC_BF16_RMS_FACTOR = 1.25
#: (e): the exported stack (BERT-base widths), its sequence and the batch
#: the host evaluates
ONNX_BERT = dict(layers=12, seq=128, batch=2)


def host_probes(torch):
    """How fast the host runs where the script stands: ms of a fixed
    pure-Python loop and µs of host time a tiny CUDA launch takes to
    enqueue (medians of 5), the load average, the Python threads alive
    and the child processes. Phase 27 compares its reading with the one
    taken after the build: every compiled path is host-bound, and its
    compiles are host work."""
    import threading

    def median_of(run, n):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) / n)
            torch.cuda.synchronize()
        return statistics.median(times)

    x = torch.zeros(1, device="cuda")

    def launches():
        for _ in range(500):
            x.add_(1)
    launches()
    me = str(os.getpid())
    children = 0
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                children += f.read().rsplit(")", 1)[1].split()[1] == me
        except OSError:
            pass
    return dict(
        python_loop_ms=median_of(lambda: sum(i * i for i in range(200_000)),
                                 1) * 1e3,
        launch_us=median_of(launches, 500) * 1e6,
        load_avg=os.getloadavg(),
        threads=sorted(t.name for t in threading.enumerate()),
        os_threads=len(os.listdir("/proc/self/task")), children=children)


class _GraphLog:
    """A Dynamo backend: Inductor (``compile_fx``, what the "inductor"
    backend runs) that keeps the op targets of every AOTAutograd forward
    and backward graph it compiles (its ``inner_compile``)."""

    def __init__(self):
        self.fw, self.bw = [], []

    def __call__(self, gm, example_inputs):
        from torch._inductor.compile_fx import compile_fx, compile_fx_inner

        def inner(g, ex, **kw):
            (self.bw if kw.get("is_backward") else self.fw).append(
                {str(n.target) for n in g.graph.nodes
                 if n.op == "call_function"})
            return compile_fx_inner(g, ex, **kw)
        return compile_fx(gm, example_inputs, inner_compile=inner)


def _dynamo_counts():
    """(graphs Dynamo made, graph breaks it counted) so far."""
    from torch._dynamo.utils import counters
    return (int(counters["stats"]["unique_graphs"]),
            int(sum(counters["graph_break"].values())))


def _static_warnings(caught):
    return [str(w.message) for w in caught if "to_static" in str(w.message)]


def static_cross_check(torch, paddle, ep):
    """Phase 27 (a): phase 19's model at 2 layers, f32, dropout 0, batch 4,
    through ``paddle.jit.to_static`` on the card (Inductor) against the
    same weights eagerly on the CPU: closeness's f32 gate on the loss and
    every gradient (``_xcheck``). The call compiled: Dynamo made a graph
    and counted no break, no eager pin and no fallback warning, the
    compiled forward holds ``flash_fwd_lse`` and the backward
    ``flash_bwd``."""
    import warnings
    log = _GraphLog()
    entry = {}

    def grads_of(net, ids, keep, labels):
        t0 = time.perf_counter()
        card_side = paddle.get_device() != "cpu"     # _xcheck's device
        if card_side:
            fn = paddle.jit.to_static(
                lambda i, k, y: ep.loss_of(net, i, k, y), backend=log)
            entry["fn"] = fn
            loss = fn(ids, keep, labels)
        else:
            loss = ep.loss_of(net, ids, keep, labels)
        loss.backward()
        if card_side:
            torch.cuda.synchronize()
            entry["compile_s"] = time.perf_counter() - t0
        return loss, {k: p.grad._data for k, p in net.named_parameters()
                      if p.grad is not None}

    paddle.set_device("gpu")
    paddle.seed(1)
    batch, _ = ep.fixed_batch(STATIC_XCHECK_BATCH)
    graphs0, breaks0 = _dynamo_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rec = _xcheck(paddle, lambda: ep.build_model(STATIC_XCHECK_LAYERS,
                                                     0.0),
                      [t._data.cpu() for t in batch], None,
                      grads_of=grads_of)
    graphs, breaks = _dynamo_counts()
    fw = set().union(*log.fw) if log.fw else set()
    bw = set().union(*log.bw) if log.bw else set()
    rec.update(layers=STATIC_XCHECK_LAYERS, batch=STATIC_XCHECK_BATCH,
               seq=ep.SEQ, graphs=graphs - graphs0,
               graph_breaks=breaks - breaks0,
               eager_sigs=len(entry["fn"]._eager_sigs),
               fallback_warnings=_static_warnings(caught),
               fw_graphs=len(log.fw), bw_graphs=len(log.bw),
               fw_holds_flash_fwd="paddle_tpu_torch.flash_fwd_lse.default"
               in fw,
               bw_holds_flash_bwd="paddle_tpu_torch.flash_bwd.default" in bw,
               compile_s=entry["compile_s"])
    if rec["graphs"] < 1 or rec["graph_breaks"] or rec["eager_sigs"] or \
            rec["fallback_warnings"] or not rec["fw_holds_flash_fwd"] or \
            not rec["bw_holds_flash_bwd"]:
        fail(f"phase 27 (a): the card's to_static call did not compile "
             f"whole onto the flash ops: {rec}")
    print(f"phase 27 (a) to_static card vs CPU ({STATIC_XCHECK_LAYERS} "
          f"layers, f32, batch {STATIC_XCHECK_BATCH}): loss cuda "
          f"{rec['loss_cuda']:.6f} cpu {rec['loss_cpu']:.6f} (ratio "
          f"{rec['loss_ratio']:.3f}); {rec['grads']} gradients, worst "
          f"{rec['worst_grad']} ratio {rec['worst_grad_ratio']:.3f}; "
          f"{rec['graphs']} graph, {rec['graph_breaks']} breaks, flash_fwd_lse "
          f"in the forward graph, flash_bwd in the backward; compile + first "
          f"call {rec['compile_s']:.1f} s", flush=True)
    return rec


def static_entries(paddle, ep, model):
    """Phase 27's ``to_static`` entries on ``model``: (b)'s training loss,
    (c)'s eager serving forward (the encoder's hidden states and the
    logits) and that forward through ``to_static``. One definition, so
    that the warm-up (``static_warm_main``) compiles the very graphs
    phase 27 runs."""
    train_loss = paddle.jit.to_static(
        lambda ids, keep, labels: ep.loss_of(model, ids, keep, labels))

    def forward(ids, keep):
        h = model[1](model[0](ids), src_mask=keep)
        return h, model[2](h[:, 0])
    return train_loss, forward, paddle.jit.to_static(forward)


def static_train_main_path(torch, paddle, ep, dispatch, launches_of,
                           reset_counts, card):
    """Phase 27 (b), the main path: phase 19's model at BERT-base widths and
    depth (O1 bf16, dropout 0.1, batch 32 x 128, key mask) with its
    forward and loss through ``paddle.jit.to_static`` (Inductor) and the
    fused AdamW step outside the compiled call. STATIC_WARM warm steps
    compile; counts set to 0 just before the TRAIN_STEPS counted steps and
    read just after. Then phase 19's eager step and the compiled one in
    turns on the same model and batch (recorded, not gated)."""
    import warnings
    paddle.set_device("gpu")
    paddle.seed(0)
    m = ep.MODEL
    model = ep.build_model()
    opt = ep.make_optimizer(model)
    batch, lens = ep.fixed_batch()
    train_loss = static_entries(paddle, ep, model)[0]

    def eager_loss(ids, keep, labels):
        return ep.loss_of(model, ids, keep, labels)

    def eval_loss():
        model.eval()
        with paddle.no_grad():
            loss = float(ep.forward_loss(model, batch))
        model.train()
        return loss

    rows = dict(loss=[], host_s=[], step_s=[], ev_ms=[], fb_ops=[])

    def step(fn, into=rows):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        n0 = dispatch.op_count
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = fn(*batch)
        loss.backward()
        fb_ops = dispatch.op_count - n0
        opt.step()
        opt.clear_grad()
        e1.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if into is not None:
            into["loss"].append(float(loss))
            into["host_s"].append(t1 - t0)
            into["step_s"].append(t2 - t0)
            into["ev_ms"].append(e0.elapsed_time(e1))
            into["fb_ops"].append(fb_ops)
        return t2 - t0

    eval_before = eval_loss()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warm_s = [step(train_loss, None) for _ in range(STATIC_WARM)]
        graphs_warm, breaks0 = _dynamo_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with ep.GcClock() as gc_clock:
            for _ in range(TRAIN_STEPS):
                step(train_loss)
        launches = launches_of()
        counters = {k: v for k, v in paddle.monitor.snapshot().items()
                    if k.startswith("kernels.")}
        # -- end of the counted compiled path --
        graphs_after, breaks = _dynamo_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval_after = eval_loss()
    turns = {"eager": [], "compiled": []}
    for _ in range(STATIC_TURNS):
        for name, fn in (("eager", eager_loss), ("compiled", train_loss)):
            turns[name] += [step(fn, None) * 1e3
                            for _ in range(STATIC_TURN_STEPS)]
    losses = rows["loss"]
    want = m["layers"] * TRAIN_STEPS
    got = {k: launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")}
    problems = []
    if not all(map(math.isfinite, losses + [eval_before, eval_after])) \
            or not eval_after < eval_before:
        problems.append(f"losses {losses}, eval mode {eval_before} -> "
                        f"{eval_after}")
    if set(got.values()) != {want}:
        problems.append(f"flash launches {got}, expected {want} each")
    if any(rows["fb_ops"]):
        problems.append(f"surface ops dispatched eagerly in the compiled "
                        f"forward + backward: {rows['fb_ops']}")
    if counters.get("kernels.optimizer.adam_fused") != TRAIN_STEPS or \
            counters.get("kernels.optimizer.adam_plain", 0):
        problems.append(f"optimizer routes {counters}")
    plain = {k: v for k, v in counters.items()
             if (k.endswith("_plain") or "fallback" in k) and v}
    sdpa = {k: v for k, v in counters.items()
            if k.startswith("kernels.flash.sdpa.") and v}
    if plain or sdpa:
        problems.append(f"plain routes {plain} or eager sdpa calls {sdpa}")
    msgs = _static_warnings(caught)
    if breaks != breaks0 or graphs_after != graphs_warm or msgs or \
            train_loss._eager_sigs or len(train_loss._cache) != 1:
        problems.append(f"graphs {graphs_warm} -> {graphs_after}, breaks "
                        f"{breaks0} -> {breaks}, warnings {msgs}, eager "
                        f"pins {train_loss._eager_sigs}")
    if problems:
        fail("phase 27 (b): " + "; ".join(problems))
    routes = check_tc_routes(counters, want, "phase 27 (b)")
    med = statistics.median
    steady = med(rows["step_s"][1:])
    tokens = ep.BATCH * ep.SEQ
    rec = dict(batch=ep.BATCH, seq=ep.SEQ, lengths=lens.tolist(),
               steps=TRAIN_STEPS, warm_steps=STATIC_WARM,
               dropout=m["dropout"], losses=losses,
               eval_loss_before=eval_before, eval_loss_after=eval_after,
               warm_step_s=warm_s, compile_s=warm_s[0] - steady,
               ms_per_step=steady * 1e3,
               events_ms_per_step=med(rows["ev_ms"][1:]),
               host_ms_per_step=med(rows["host_s"][1:]) * 1e3,
               host_share=med(rows["host_s"][1:]) / steady,
               tokens_per_s=tokens / steady, peak_mem_gb=peak_gb,
               gc_ms_per_step=gc_clock.seconds * 1e3 / TRAIN_STEPS,
               fb_ops=rows["fb_ops"], graphs=graphs_after,
               launches=launches, counters=counters, flash_routes=routes,
               fused_adam_launches=launches["fused_adam"],
               turns_ms=turns, eager_ms_per_step=med(turns["eager"]),
               compiled_ms_per_step=med(turns["compiled"]))
    print(f"phase 27 (b) to_static training: BERT-base ({m['layers']} "
          f"layers), batch {ep.BATCH} x seq {ep.SEQ}, O1 bf16, dropout "
          f"{m['dropout']}, losses {[round(x, 4) for x in losses]} (eval "
          f"mode {eval_before:.4f} -> {eval_after:.4f}); compile "
          f"{rec['compile_s']:.1f} s (warm steps "
          f"{[round(s, 1) for s in warm_s]} s); median step "
          f"{rec['ms_per_step']:.1f} ms (events "
          f"{rec['events_ms_per_step']:.1f} ms) = {rec['tokens_per_s']:.0f} "
          f"tokens/s, host {rec['host_ms_per_step']:.1f} ms a step "
          f"({rec['host_share']:.3f} of it), peak {peak_gb:.1f} GB; "
          f"launches {got}, {launches['fused_adam']} fused Adam, 0 surface "
          f"ops dispatched in the compiled forward + backward; in turns: "
          f"eager {rec['eager_ms_per_step']:.1f} ms vs compiled "
          f"{rec['compiled_ms_per_step']:.1f} ms a step on {card}",
          flush=True)
    return model, batch, rec


def _rms(t):
    return float(t.float().square().mean().sqrt())


def static_serving(torch, paddle, ep, model, batch, dispatch, launches_of,
                   reset_counts, card):
    """Phase 27 (c): the trained model in eval mode under ``no_grad``,
    its encoder's forward (the hidden states of every token) and the
    logits through ``to_static`` at f32 and under O1 bf16, batch 32 x 128:
    each against the eager forward on the card (f32: closeness's gate;
    bf16: held to the eager bf16 output's distance from the f32 forward,
    STATIC_BF16_RMS_FACTOR), one counted batch each (tf32x3 == 12 at f32,
    wgmma == 12 at bf16), then ms a batch compiled and eager. The counted
    batch and the timed compiled ones must run the graph compiled at the
    precision's first call: no surface op dispatched (``op_count``), no
    new Dynamo graph and no graph break."""
    import contextlib
    model.eval()
    ids, keep = batch[0], batch[1]
    layers = len(model[1].layers)
    _, forward, serve = static_entries(paddle, ep, model)
    out = {}
    ref32 = None
    for what in ("f32", "bf16"):
        def amp():
            return paddle.amp.auto_cast(level="O1", dtype="bfloat16") \
                if what == "bf16" else contextlib.nullcontext()
        with paddle.no_grad():
            t0 = time.perf_counter()
            with amp():
                h, logits = serve(ids, keep)
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
            with amp():
                he, le = forward(ids, keep)

            def timed(fn):
                """(device ms, host ms to enqueue) a batch: events and
                the host's clock around STATIC_SERVE_ITERS batches after
                3 warm ones."""
                def run():
                    with amp():
                        fn(ids, keep)
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                t0 = time.perf_counter()
                for _ in range(STATIC_SERVE_ITERS):
                    run()
                host_s = time.perf_counter() - t0
                e1.record()
                e1.synchronize()
                return (e0.elapsed_time(e1) / STATIC_SERVE_ITERS,
                        host_s * 1e3 / STATIC_SERVE_ITERS)
            # the counted batch and the timed compiled ones ran the graph
            # compiled at the first call: no surface op dispatched eagerly
            # (an eager run, Dynamo's own fallback too, dispatches ~200),
            # no new graph (a recompile) and no break
            graphs0, breaks0 = _dynamo_counts()
            ops0 = dispatch.op_count
            reset_counts()
            with amp():
                serve(ids, keep)
            torch.cuda.synchronize()
            launches = launches_of()
            counters = {k: v for k, v in paddle.monitor.snapshot().items()
                        if k.startswith("kernels.")}
            # -- end of the counted batch --
            counted_ops = dispatch.op_count - ops0
            ms, host_ms = timed(serve)
            compiled_ops = dispatch.op_count - ops0
            graphs, breaks = _dynamo_counts()
            eager_ops0 = dispatch.op_count
            eager_ms, eager_host_ms = timed(forward)
            eager_ops = (dispatch.op_count - eager_ops0) // \
                (STATIC_SERVE_ITERS + 3)
        h, he = h._data, he._data
        rec = dict(compile_s=compile_s, ms=ms, eager_ms=eager_ms,
                   host_ms=host_ms, host_share=host_ms / ms,
                   eager_host_ms=eager_host_ms,
                   sequences_per_s=ids.shape[0] / ms * 1e3,
                   eager_sequences_per_s=ids.shape[0] / eager_ms * 1e3,
                   launches=launches, counters=counters,
                   counted_batch_ops=counted_ops,
                   compiled_ops=compiled_ops, eager_ops_per_batch=eager_ops,
                   new_graphs=graphs - graphs0,
                   graph_breaks=breaks - breaks0,
                   hidden_vs_eager=closeness(h, he),
                   logits_vs_eager=closeness(logits._data, le._data))
        if compiled_ops or graphs != graphs0 or breaks != breaks0 or \
                not eager_ops:
            fail(f"phase 27 (c) {what} serving did not run its compiled "
                 f"graph: {compiled_ops} surface ops dispatched eagerly in "
                 f"the counted and timed batches (eager: {eager_ops} a "
                 f"batch), {graphs - graphs0} new graphs, "
                 f"{breaks - breaks0} breaks")
        finite = bool(torch.isfinite(h).all()) and \
            tuple(h.shape) == (ids.shape[0], ids.shape[1], h.shape[-1])
        if what == "f32":
            ref32 = he.float()
            good = rec["hidden_vs_eager"]["ratio"] <= 1 and \
                rec["logits_vs_eager"]["ratio"] <= 1
            routes = check_f32_routes(counters, layers,
                                      "phase 27 (c) f32 serving")
        else:
            err_c, err_e = (h.float() - ref32), (he.float() - ref32)
            rec.update(rms_err_vs_f32=_rms(err_c),
                       eager_rms_err_vs_f32=_rms(err_e),
                       max_err_vs_f32=float(err_c.abs().max()),
                       eager_max_err_vs_f32=float(err_e.abs().max()),
                       rms_factor=STATIC_BF16_RMS_FACTOR)
            good = rec["rms_err_vs_f32"] <= STATIC_BF16_RMS_FACTOR * \
                rec["eager_rms_err_vs_f32"] and rec["max_err_vs_f32"] <= \
                2 * rec["eager_max_err_vs_f32"]
            routes = check_routes(counters, {"fwd_cuda_tc": layers,
                                             "fwd_cuda_tc_wgmma": layers},
                                  "phase 27 (c) bf16 serving")
        rec["flash_routes"] = routes
        if not finite or not good or launches["flash_fwd"] != layers or \
                any(launches[k] for k in ("flash_bwd_dq", "flash_bwd_dkv")):
            fail(f"phase 27 (c) {what} serving: finite {finite}, "
                 f"launches {launches}, {rec}")
        out[what] = rec
        print(f"phase 27 (c) to_static serving {what} (batch {ids.shape[0]}"
              f" x {ids.shape[1]}): {ms:.2f} ms a batch compiled (host "
              f"{host_ms:.2f} ms to enqueue it) = "
              f"{rec['sequences_per_s']:.0f} sequences/s, eager "
              f"{eager_ms:.2f} ms (host {eager_host_ms:.2f}) = "
              f"{rec['eager_sequences_per_s']:.0f}; 0 surface ops, 0 new "
              f"graphs in the counted and timed compiled batches; "
              f"hidden vs eager ratio {rec['hidden_vs_eager']['ratio']:.3f}"
              + (f", rms error vs f32 {rec['rms_err_vs_f32']:.2e} (eager "
                 f"{rec['eager_rms_err_vs_f32']:.2e})" if what == "bf16"
                 else "") + f"; compile + first batch {compile_s:.1f} s; "
              f"{launches['flash_fwd']} flash launches on {card}",
              flush=True)
    if len(serve._cache) != 1 or serve._eager_sigs:
        fail(f"phase 27 (c): serving entries {len(serve._cache)}, pins "
             f"{serve._eager_sigs}")
    model.train()
    return out


def static_control_flow(torch, paddle, card):
    """Phase 27 (d): ``static.nn.cond`` and ``while_loop`` inside
    ``to_static`` on card tensors, equal to eager with no graph break; then
    the negative control: ``float(x.sum().numpy())`` in a ``to_static``
    function must warn once, fall back, return the right values and show
    its pin in ``_eager_sigs`` (the check (a)-(c) rely on sees a break)."""
    import warnings
    paddle.set_device("gpu")
    g = torch.Generator(device="cuda").manual_seed(27)
    x = paddle.to_tensor(torch.randn(64, 256, generator=g, device="cuda"))
    n = paddle.static.nn

    def branchy(x):
        y = n.cond(x.mean() > 0, lambda: x * 2.0, lambda: x - 1.0)
        _, acc = n.while_loop(lambda i, a: i < 5,
                              lambda i, a: (i + 1, paddle.tanh(a) + a),
                              [paddle.to_tensor(0), y])
        return acc

    def value_branch(x):
        if float(x.sum().numpy()) > 0:
            return x * 2.0
        return x - 1.0
    rec = {}
    graphs0, breaks0 = _dynamo_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        flow = paddle.jit.to_static(branchy)
        got = {s: flow(x * s) for s in (1.0, -1.0)}
    graphs, breaks = _dynamo_counts()
    for s, t in got.items():
        c = closeness(t._data, branchy(x * s)._data)
        rec[f"sign_{s:+.0f}"] = c
        if c["ratio"] > 1:
            fail(f"phase 27 (d): compiled cond / while_loop off eager: {c}")
    rec.update(graphs=graphs - graphs0, graph_breaks=breaks - breaks0,
               warnings=_static_warnings(caught))
    if rec["graphs"] < 1 or rec["graph_breaks"] or rec["warnings"] or \
            flow._eager_sigs:
        fail(f"phase 27 (d): cond / while_loop broke the graph: {rec}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        neg = paddle.jit.to_static(value_branch)
        outs = [neg(x * s) for s in (1.0, -1.0)]
    msgs = _static_warnings(caught)
    wants = [value_branch(x * s) for s in (1.0, -1.0)]
    right = all(torch.equal(o._data, w._data) for o, w in zip(outs, wants))
    rec["negative_control"] = dict(warnings=msgs, pins=len(neg._eager_sigs),
                                   right_values=right)
    if len(msgs) != 1 or "falling back to eager" not in msgs[0] or \
            len(neg._eager_sigs) != 1 or not right:
        fail(f"phase 27 (d) negative control: the value-dependent branch "
             f"was not caught as a graph break: {rec['negative_control']}")
    print(f"phase 27 (d) cond + while_loop compiled on the card, equal to "
          f"eager (ratios {rec['sign_+1']['ratio']:.3f}, "
          f"{rec['sign_-1']['ratio']:.3f}), {rec['graphs']} graph(s), no "
          f"break; negative control: one fallback warning, pinned, right "
          f"values", flush=True)
    return rec


def run_onnx(model, x):
    """A numpy evaluator of the op set ``paddle.onnx.export`` writes for a
    stack of ``BertEncoderLayer``s: runs a parsed graph
    (``_proto.parse_model``) on input ``x``, bound to the graph input
    ``input``, on the host, with no onnx package. ``Gelu`` is the exact
    erf in float64, cast back. Raises on any other op."""
    import numpy as np
    from scipy.special import erf

    def layer_norm(x, scale, bias, axis=-1, epsilon=1e-5):
        axes = tuple(range(axis % x.ndim, x.ndim))
        mean, var = x.mean(axis=axes, keepdims=True), \
            x.var(axis=axes, keepdims=True)
        return (x - mean) / np.sqrt(var + epsilon) * scale + bias

    def softmax(x, axis=-1):
        e = np.exp(x - x.max(axis=axis, keepdims=True))
        return e / e.sum(axis=axis, keepdims=True)

    def gelu(x):
        x64 = x.astype(np.float64)
        return (0.5 * x64 * (1.0 + erf(x64 / np.sqrt(2.0)))).astype(x.dtype)

    ops = {"MatMul": np.matmul, "Add": np.add, "Mul": np.multiply,
           "Gelu": gelu, "Softmax": softmax, "LayerNormalization": layer_norm,
           "Transpose": lambda x, perm: x.transpose(perm),
           "Reshape": lambda x, shape: x.reshape(
               [x.shape[i] if d == 0 else int(d) for i, d in
                enumerate(shape)])}
    g = model["graph"]
    env = dict(g["initializers"], input=x)
    for node in g["nodes"]:
        if node["op_type"] not in ops:
            raise NotImplementedError(
                f"run_onnx: op {node['op_type']} is not in the BERT "
                "encoder's op set")
        env[node["outputs"][0]] = ops[node["op_type"]](
            *[env[i] for i in node["inputs"]], **node["attrs"])
    return env[g["outputs"][0]]


def onnx_export_check(torch, paddle, mods, card):
    """Phase 27 (e): a stack of the port's ``BertEncoderLayer``s at
    BERT-base widths (12 layers, f32) exported by ``paddle.onnx.export``
    from the card's weights with a symbolic batch ([None, 128, 768]),
    parsed back with ``_proto.parse_model`` and run on the host by
    ``run_onnx`` at batch 2: within closeness's f32 gate
    of the card's eager forward. Negative control: the parsed file with
    one element of the first ``wq`` initializer moved by 1 must fail the
    gate."""
    import numpy as np
    from paddle_tpu_torch.onnx import _proto
    E = ONNX_BERT
    model = mods.BertModel(mods.BertConfig(num_hidden_layers=E["layers"]),
                           seed=27).eval()
    stack = model.encoder
    h = model.config.hidden_size
    g = torch.Generator(device="cuda").manual_seed(27)
    x = torch.randn(E["batch"], E["seq"], h, generator=g, device="cuda")
    with torch.no_grad():
        want = x
        for lyr in stack:
            want = lyr(want)
    path = ROOT / "build" / "phase27_bert_encoder"    # ~340 MB, removed
    t0 = time.perf_counter()
    fname = paddle.onnx.export(stack, str(path), input_spec=[
        paddle.jit.InputSpec([None, E["seq"], h], "float32")])
    export_s = time.perf_counter() - t0
    size_mb = os.path.getsize(fname) / 2 ** 20
    parsed = _proto.parse_model(open(fname, "rb").read())
    os.remove(fname)
    xs = x.cpu().numpy()
    t0 = time.perf_counter()
    got = run_onnx(parsed, xs)
    run_s = time.perf_counter() - t0
    ref = want.cpu()
    c = closeness(torch.from_numpy(np.asarray(got)), ref)
    inits = parsed["graph"]["initializers"]
    wq = next(k for k in inits if k.startswith("wq"))
    inits[wq] = inits[wq].copy()
    inits[wq].flat[0] += 1.0
    moved = closeness(torch.from_numpy(np.asarray(run_onnx(parsed, xs))),
                      ref)
    ops = sorted({n["op_type"] for n in parsed["graph"]["nodes"]})
    rec = dict(layers=E["layers"], seq=E["seq"], batch=E["batch"],
               hidden=h, nodes=len(parsed["graph"]["nodes"]), ops=ops,
               initializers=len(inits), size_mb=size_mb,
               export_s=export_s, host_run_s=run_s, vs_card=c,
               negative_control=dict(initializer=wq, ratio=moved["ratio"]))
    if tuple(np.asarray(got).shape) != tuple(ref.shape) or c["ratio"] > 1 \
            or moved["ratio"] <= 1:
        fail(f"phase 27 (e): ONNX export of the BERT stack: {rec}")
    print(f"phase 27 (e) onnx.export of {E['layers']} BertEncoderLayers "
          f"({h} wide, [None, {E['seq']}, {h}]): {rec['nodes']} nodes, "
          f"{size_mb:.0f} MB in {export_s:.1f} s; run on the host at batch "
          f"{E['batch']} in {run_s:.1f} s, ratio {c['ratio']:.3f} to the "
          f"card's forward (max abs err {c['max_abs_err']:.2e}); negative "
          f"control ({wq}[0] + 1) ratio {moved['ratio']:.1f}", flush=True)
    del model, stack
    torch.cuda.empty_cache()
    return rec


def static_warm_main(argv):
    """``chip_smoke.py --static-warm OUT``: phase 27 (b)'s and (c)'s
    ``to_static`` entries (``static_entries``) compiled once, at the
    lowest CPU priority, beside the earlier phases, into the Inductor and
    Triton caches under ``build/`` that ``main`` names before it starts
    this process; phase 27 then loads those graphs from the caches in
    its own first calls. At phase 27's model, batch and precisions: one
    O1 bf16 training step (forward and backward), then one serving batch
    in eval mode at f32 and under O1 bf16. Writes the seconds to OUT."""
    import contextlib
    os.nice(19)             # its compile workers inherit the priority
    t0 = time.perf_counter()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import profile_eager as ep
    paddle.set_device("gpu")
    paddle.seed(0)
    model = ep.build_model()
    batch, _ = ep.fixed_batch()
    train_loss, _, serve = static_entries(paddle, ep, model)
    rec = {}
    t = time.perf_counter()
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = train_loss(*batch)
    loss.backward()
    torch.cuda.synchronize()
    rec["train_s"] = time.perf_counter() - t
    model.eval()
    with paddle.no_grad():
        for what in ("f32", "bf16"):
            t = time.perf_counter()
            with (paddle.amp.auto_cast(level="O1", dtype="bfloat16")
                  if what == "bf16" else contextlib.nullcontext()):
                serve(batch[0], batch[1])
            torch.cuda.synchronize()
            rec[f"serve_{what}_s"] = time.perf_counter() - t
    rec["seconds"] = time.perf_counter() - t0
    Path(argv[0]).write_text(json.dumps(rec))


def start_static_warm():
    """Start ``static_warm_main`` in a process of its own (its output in
    OUT_DIR); stopped at exit if a phase fails before phase 27 waits."""
    import atexit
    log = open(OUT_DIR / "static_warm.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--static-warm",
         str(OUT_DIR / "static_warm.json")], cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT)
    log.close()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return dict(proc=proc, t0=time.perf_counter())


def finish_static_warm(warm):
    """Wait for the warm-up; any exit but 0 fails phase 27. Returns its
    seconds, and how long phase 27 waited for it."""
    t0 = time.perf_counter()
    rc = warm["proc"].wait(timeout=DIST_RANK_TIMEOUT)
    waited = time.perf_counter() - t0
    if rc != 0:
        tail = (OUT_DIR / "static_warm.log").read_text()[-3000:]
        fail(f"phase 27: the compile warm-up exited {rc}:\n{tail}")
    rec = json.loads((OUT_DIR / "static_warm.json").read_text())
    rec.update(waited_s=waited, ended_after_s=t0 - warm["t0"] + waited)
    return rec


def _cache_counts():
    """Inductor's FX-graph and AOTAutograd cache hits and misses so far."""
    from torch._dynamo.utils import counters
    return {k: int(counters[g][k]) for g, k in (
        ("inductor", "fxgraph_cache_hit"), ("inductor", "fxgraph_cache_miss"),
        ("aot_autograd", "autograd_cache_hit"),
        ("aot_autograd", "autograd_cache_miss"))}


def to_static_main_path(torch, mods, launches_of, reset_counts, card,
                        host_at_start, warm):
    """Phase 27: (a) ``to_static`` card vs CPU, (b) BERT-base trained
    through ``to_static`` (the main path), (c) served through it at f32
    and bf16, (d) ``static.nn`` control flow and the graph-break negative
    control, (e) ``onnx.export`` of a BERT-base encoder stack."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import profile_eager as ep
    from paddle_tpu_torch.core import dispatch
    t0 = time.perf_counter()
    warm = finish_static_warm(warm)
    host = host_probes(torch)
    print(f"phase 27 host, after the build -> now: python loop "
          f"{host_at_start['python_loop_ms']:.2f} -> "
          f"{host['python_loop_ms']:.2f} ms, a launch "
          f"{host_at_start['launch_us']:.2f} -> {host['launch_us']:.2f} us "
          f"to enqueue, load average {host_at_start['load_avg'][0]:.2f} -> "
          f"{host['load_avg'][0]:.2f}, OS threads "
          f"{host_at_start['os_threads']} -> {host['os_threads']}, "
          f"children {host_at_start['children']} -> {host['children']}; "
          f"Python threads now {host['threads']}", flush=True)
    out = dict(host_at_start=host_at_start, host=host,
               cross_check=static_cross_check(torch, paddle, ep))
    cache0 = _cache_counts()
    model, batch, out["training"] = static_train_main_path(
        torch, paddle, ep, dispatch, launches_of, reset_counts, card)
    out["serving"] = static_serving(torch, paddle, ep, model, batch,
                                    dispatch, launches_of, reset_counts, card)
    cache = {k: v - cache0[k] for k, v in _cache_counts().items()}
    out["warm_up"] = dict(warm, cache=cache)
    print(f"phase 27 warm-up: (b) and (c) compiled beside the earlier "
          f"phases in {warm['seconds']:.1f} s (training step "
          f"{warm['train_s']:.1f} s, serving f32 {warm['serve_f32_s']:.1f} "
          f"s, bf16 {warm['serve_bf16_s']:.1f} s), ended "
          f"{warm['ended_after_s']:.1f} s after its start, phase 27 waited "
          f"{warm['waited_s']:.1f} s; (b) and (c)'s caches: FX graph "
          f"{cache['fxgraph_cache_hit']} hits / {cache['fxgraph_cache_miss']} "
          f"misses, AOTAutograd {cache['autograd_cache_hit']} / "
          f"{cache['autograd_cache_miss']}", flush=True)
    del model, batch
    torch.cuda.empty_cache()
    out["control_flow"] = static_control_flow(torch, paddle, card)
    out["onnx"] = onnx_export_check(torch, paddle, mods, card)
    from torch._dynamo.utils import compile_times
    (OUT_DIR / "phase27_compile_times.txt").write_text(
        compile_times(repr="str"))
    try:                     # Inductor's compile workers end with the phase
        from torch._inductor.async_compile import shutdown_compile_workers
        shutdown_compile_workers()
    except ImportError:
        pass
    paddle.set_device("gpu")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 27 in {out['seconds']:.1f} s", flush=True)
    return out


def bench_trace(vocab, n_requests=24, prompt_lo=64, prompt_hi=192,
                arrival_rate_hz=40.0, shared_prefix=0, whale_every=0,
                whale_prompt=0):
    """bench.py::bench_llama_serving's arrival trace, drawn in its order
    from one seed-0 generator: (arrival seconds, prompts)."""
    import numpy as np
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate_hz, n_requests))
    system = (rng.integers(0, vocab, (shared_prefix,)) if shared_prefix
              else np.zeros((0,), np.int64))
    prompts = [np.concatenate([system, rng.integers(
        0, vocab, (int(rng.integers(prompt_lo, prompt_hi))
                   - shared_prefix,))]).astype(np.int64)
        for _ in range(n_requests)]
    if whale_every:
        for i in range(0, n_requests, int(whale_every)):
            prompts[i] = rng.integers(0, vocab, (int(whale_prompt),)).astype(
                np.int64)
    return arrivals, prompts


def drive_trace(torch, eng, SamplingParams, trace, new_tokens):
    """One pass of an arrival trace (bench.py::_drive_serving_trace):
    each greedy request joins at its arrival time on the host clock; the
    loop sleeps only while the engine is idle. Returns (outputs in
    arrival order, seconds, each step's wall ms)."""
    arrivals, prompts = trace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, i, n, steps = [], 0, len(prompts), []
    while len(outs) < n:
        now = time.perf_counter() - t0
        while i < n and arrivals[i] <= now:
            eng.add_request(prompts[i],
                            SamplingParams(max_new_tokens=new_tokens))
            i += 1
        if i < n and eng.idle:
            time.sleep(max(0.0, arrivals[i] - (time.perf_counter() - t0)))
            continue
        t1 = time.perf_counter()
        outs.extend(eng.step())
        steps.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    return (sorted(outs, key=lambda o: o.req_id),
            time.perf_counter() - t0, steps)


def paged_teacher_forced_agreement(torch, model, prompt, tokens):
    """Share of ``tokens`` equal to the argmax of ONE paged forward over
    prompt + tokens[:-1] into a fresh f32 pool (the serving function of
    the model: MoE blocks in decode mode, no capacity drops)."""
    import numpy as np
    from paddle_tpu_torch.inference.engine import _make_paged_pools, inject_bt
    spec = model.serving_spec()
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int64)])
    pages = -(-len(seq) // 128)
    pools = _make_paged_pools(spec["num_layers"], pages + 1,
                              spec["kv_heads"], 128, spec["head_dim"],
                              torch.float32, False, "cuda")
    bt = torch.arange(1, pages + 1, dtype=torch.int32,
                      device="cuda")[None]
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(seq[None]).cuda(),
                          kv_caches=inject_bt(pools, bt),
                          cache_index=torch.zeros(1, dtype=torch.int64,
                                                  device="cuda"))
    want = logits[0, len(prompt) - 1:].argmax(-1).cpu().tolist()
    return sum(int(a == b) for a, b in zip(tokens, want)) / len(tokens)


def accel_run(torch, mods, what, model, engine_kw, trace, new_tokens,
              launches_of, reset_counts, card, decode_calls_per_tick,
              warm=False):
    """One counted serving run: counts set to 0 just before the engine is
    built (``warm``: the engine runs the trace once first, as the JAX
    bench's compile pass, and the counts go to 0 before the second pass),
    read just after the trace drains. Fails unless every request
    finished with its full length, no page leaked, every decode call ran
    the split paged-decode kernel, and paged-decode launches == device
    ticks x ``decode_calls_per_tick`` (the layers; under speculation the
    draft's k+1 steps x its layers)."""
    if warm:
        eng = mods.Engine(model, **engine_kw)
        drive_trace(torch, eng, mods.SamplingParams, trace, new_tokens)
        reset_counts()
    else:
        reset_counts()
        eng = mods.Engine(model, **engine_kw)
    ticks0 = eng.decode_ticks
    outs, secs, step_ms = drive_trace(torch, eng, mods.SamplingParams,
                                      trace, new_tokens)
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith(("kernels.", "serving."))}
    host_ms = mods.monitor.histogram("serving.hist.host_ms_per_tick").sum
    dev_ms = mods.monitor.histogram("serving.hist.device_ms_per_tick").sum
    # -- end of the counted run --
    bad = [o for o in outs if not o.ok or len(o.token_ids) != new_tokens]
    if len(outs) != len(trace[1]) or bad:
        fail(f"{what}: {len(outs)} outputs, failed/short: {bad[:2]}")
    leaked = eng.leaked_pages()
    if leaked:
        fail(f"{what}: {leaked} pages leaked")
    ticks, steps = eng.decode_ticks - ticks0, int(counters["serving.steps"])
    if launches["paged_decode"] != ticks * decode_calls_per_tick or \
            counters.get("kernels.decode.paged_cuda") != \
            launches["paged_decode"] or any(
                v for k, v in counters.items() if k.endswith("_plain")):
        fail(f"{what}: paged-decode launches {launches['paged_decode']} != "
             f"{ticks} ticks x {decode_calls_per_tick}, or a plain call: "
             f"{counters}")
    check_paged_split(counters, launches["paged_decode"], what)
    n_tok = sum(len(o.token_ids) for o in outs)
    rec = dict(requests=len(outs), tokens=n_tok, seconds=secs,
               tokens_per_s=n_tok / secs, steps=steps, decode_ticks=ticks,
               ms_per_step=secs * 1e3 / steps,
               host_ms_per_step=host_ms / steps,
               device_wait_ms_per_step=dev_ms / steps,
               host_ms_per_tick=host_ms / max(ticks, 1),
               device_wait_ms_per_tick=dev_ms / max(ticks, 1),
               step_ms_max=max(step_ms),
               step_ms_median=float(sorted(step_ms)[len(step_ms) // 2]),
               ttft_ms=[o.ttft_ms for o in outs],
               launches=launches, counters=counters)
    print(f"  {what}: {n_tok} tokens in {secs:.2f} s = {n_tok / secs:.1f} "
          f"tok/s, {steps} steps, {ticks} device ticks, host "
          f"{host_ms / steps:.3f} / device-wait {dev_ms / steps:.3f} ms a "
          f"step ({host_ms / max(ticks, 1):.3f} / "
          f"{dev_ms / max(ticks, 1):.3f} a tick) on {card}", flush=True)
    return rec, eng, outs


def hold_agreement(torch, model, what, trace, outs, plain, threshold,
                   paged=False):
    """Every request's tokens against teacher-forced argmax (the no-cache
    forward, or one paged forward) at ``threshold``, and the share of
    requests whose tokens equal the plain engine's."""
    tf = paged_teacher_forced_agreement if paged else \
        teacher_forced_agreement
    agree = [tf(torch, model, p, o.token_ids)
             for p, o in zip(trace[1], outs)]
    same = sum(int(o.token_ids == q.token_ids)
               for o, q in zip(outs, plain)) / len(outs)
    print(f"  {what}: teacher-forced agreement min {min(agree):.4f} "
          f"(threshold {threshold}); {same:.4f} of requests identical to "
          f"the plain engine's", flush=True)
    if min(agree) < threshold:
        fail(f"{what}: teacher-forced agreement below {threshold}: {agree}")
    return dict(agreement_min=min(agree), agreement=agree,
                identical_share=same)


def profile_one_replay(torch, mods, eng, layers):
    """torch.profiler around one step whose dispatch is a k=8 multi-tick
    replay over 16 equal greedy requests: the device trace must hold
    8 x layers split paged-decode kernels and as many combines."""
    from paddle_tpu_torch.profile_serving import _kernel_times
    import numpy as np
    rng = np.random.default_rng(1)
    for _ in range(PROFILE_SLOTS):
        eng.add_request(rng.integers(0, eng.vocab_size, (PROFILE_PROMPT,)),
                        mods.SamplingParams(max_new_tokens=32))
    eng.step()                                 # admit + prefill all 16
    eng.step()                  # a k=8 dispatch (captures it if need be)
    c = mods.monitor.counter
    d0, t0 = c("serving.multi_tick.dispatches").get(), \
        c("serving.multi_tick.ticks").get()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.step()
        torch.cuda.synchronize()
    trace = OUT_DIR / "multi_tick_replay_trace.json"
    prof.export_chrome_trace(str(trace))
    per, _ = _kernel_times(trace)
    trace.unlink()
    got = {k: sum(v[1] for n, v in per.items() if k in n)
           for k in ("paged_decode_split", "paged_decode_combine")}
    fused = (c("serving.multi_tick.dispatches").get() - d0,
             c("serving.multi_tick.ticks").get() - t0)
    while eng.num_active:
        eng.step()
    print(f"  profiler, one multi-tick step (dispatches, ticks) {fused}: "
          f"{got} (want {8 * layers} each)", flush=True)
    if fused != (1, 8) or got != {"paged_decode_split": 8 * layers,
                                  "paged_decode_combine": 8 * layers}:
        fail(f"multi-tick replay: {fused} dispatch/ticks, device kernels "
             f"{got}; names seen {sorted(per)[:20]}")
    return dict(dispatches_ticks=fused, kernels=got)


def serving_accelerators(torch, mods, model, launches_of, reset_counts,
                         card):
    """Phase 6b: bench.py::bench_llama_serving's traces at the keywords of
    its serving extras (the 24-request default at multi_tick 8 and 1,
    serving_prefix, serving_longctx, serving_spec) in Engines of 16
    slots, 128-token pages, a 64-token bucket and a bf16 pool, each run
    counted on its own (``accel_run``). Also returns the clean
    multi_tick=8 run's outputs and captured k buckets (phase 6c's
    reference)."""
    import dataclasses
    import numpy as np
    cfg = model.config
    L = cfg.num_hidden_layers
    common = dict(max_slots=16, page_size=128, prefill_bucket=64,
                  cache_dtype="bfloat16")
    print("serving accelerators:", flush=True)
    res, paths = {}, {}

    def run(name, kw, trace, new_tokens, calls=L, warm=False):
        rec, eng, outs = accel_run(torch, mods, name, model,
                                   dict(common, **kw), trace, new_tokens,
                                   launches_of, reset_counts, card, calls,
                                   warm)
        res[name], paths[name] = rec, rec.pop("launches")
        return eng, outs

    # (a) multi-tick: the default trace, all greedy, k = 8 against 1, each
    # engine's second pass (the first captures the graphs)
    base = bench_trace(cfg.vocab_size)
    ctx = PROMPT_HI + NEW_TOKENS
    eng8, multi = run("multi_tick_8", dict(max_context=ctx, multi_tick=8),
                      base, NEW_TOKENS, warm=True)
    _, single = run("multi_tick_1", dict(max_context=ctx), base, NEW_TOKENS,
                    warm=True)
    mt = res["multi_tick_8"]["counters"]
    if [o.token_ids for o in multi] != [o.token_ids for o in single]:
        fail("multi-tick: tokens differ from the single-tick engine's")
    if not mt.get("serving.multi_tick.dispatches"):
        fail("multi-tick: no fused dispatch ran")
    res["multi_tick_8"]["fused"] = {k[len("serving.multi_tick."):]: v
                                    for k, v in mt.items()
                                    if k.startswith("serving.multi_tick.")}
    res["multi_tick_8"]["graphs"] = eng8._multi.captured
    res["multi_tick_8"]["profile_replay"] = profile_one_replay(
        torch, mods, eng8, L)
    del eng8
    # (b) prefix: a 256-token shared system prompt, cache on and off
    trace = bench_trace(cfg.vocab_size, shared_prefix=256, prompt_lo=320,
                        prompt_hi=448)
    kw = dict(max_context=448 + NEW_TOKENS)
    eng, on = run("prefix_on", dict(kw, prefix_cache=True), trace,
                  NEW_TOKENS)
    res["prefix_on"]["hit_rate"] = eng.prefix_hit_rate
    if not res["prefix_on"]["counters"].get("serving.prefix_hits"):
        fail("prefix cache: no hit on the shared-prefix trace")
    _, off = run("prefix_off", kw, trace, NEW_TOKENS)
    res["prefix_on"]["agreement"] = hold_agreement(
        torch, model, "prefix_on", trace, on, off, AGREE_BF16)
    # (c) chunked: every 4th request a 1536-token whale, 256 tokens a step
    trace = bench_trace(cfg.vocab_size, n_requests=16, whale_every=4,
                        whale_prompt=1536, arrival_rate_hz=20.0)
    kw = dict(max_context=1537 + 96)
    _, chunked = run("chunked", dict(kw, max_prefill_tokens_per_step=256),
                     trace, 96)
    _, mono = run("monolithic", kw, trace, 96)
    for name, outs in (("chunked", chunked), ("monolithic", mono)):
        small = [o.ttft_ms for i, o in enumerate(outs) if i % 4]
        res[name]["small_ttft_p99_ms"] = float(np.percentile(small, 99))
    print(f"  small-request p99 TTFT: chunked "
          f"{res['chunked']['small_ttft_p99_ms']:.1f} ms, monolithic "
          f"{res['monolithic']['small_ttft_p99_ms']:.1f} ms", flush=True)
    res["chunked"]["agreement"] = hold_agreement(
        torch, model, "chunked", trace, chunked, mono, AGREE_BF16)
    # (d) speculative: a 1-layer draft (seed 1) proposing SPEC_K tokens
    dcfg = dataclasses.replace(cfg, num_hidden_layers=1,
                               max_position_embeddings=ctx + SPEC_K + 1)
    draft = mods.LlamaForCausalLM(dcfg, seed=1)
    draft.eval()
    eng, spec = run("spec", dict(max_context=ctx, draft_model=draft,
                                 spec_k=SPEC_K),
                    base, NEW_TOKENS, calls=(SPEC_K + 1) * 1)
    res["spec"]["accept_rate"] = eng.spec_accept_rate
    print(f"  spec: accept rate {eng.spec_accept_rate:.4f}", flush=True)
    res["spec"]["agreement"] = hold_agreement(
        torch, model, "spec", base, spec, single, AGREE_BF16)
    return res, paths, dict(outs=multi, graphs=res["multi_tick_8"]["graphs"])


def moe_spec_path(torch, mods, launches_of, reset_counts, card):
    """Phase 12b: bench.py::bench_ernie_moe_serving(draft_layers=1,
    spec_k=4) — a 1-layer dense LLaMA (seed 1) drafting for the ERNIE-MoE
    verifier (8 slots, 128-token pages, 64-token bucket), against the
    draft-free engine on the same trace; grouped-FFN forward launches ==
    (prefills + ticks) x MoE layers."""
    import numpy as np
    P = mods.moe_profile
    ctx = P.MOE_PROMPT_HI + P.MOE_NEW_TOKENS + SPEC_K + 1
    cfg = mods.ErnieMoEConfig(**dict(P.MOE_SERVE_MODEL,
                                     max_position_embeddings=ctx))
    model = mods.ErnieMoEForCausalLM(cfg, seed=0)
    model.eval()
    draft = mods.LlamaForCausalLM(mods.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=1,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=ctx), seed=1)
    draft.eval()
    trace = (np.cumsum(np.random.default_rng(0).exponential(
        1.0 / 40.0, P.MOE_REQUESTS)), P.moe_prompts(cfg.vocab_size))
    kw = dict(P.MOE_ENGINE, max_context=ctx)
    print("MoE speculative serving:", flush=True)
    res, paths = {}, {}
    n_moe = len(model.moe_layers())
    for name, extra, calls in (
            ("moe_plain", {}, cfg.num_hidden_layers),
            ("moe_spec", dict(draft_model=draft, spec_k=SPEC_K),
             SPEC_K + 1)):
        rec, eng, outs = accel_run(torch, mods, name, model,
                                   dict(kw, **extra), trace,
                                   P.MOE_NEW_TOKENS, launches_of,
                                   reset_counts, card, calls)
        launches = rec.pop("launches")
        want = (int(rec["counters"].get("serving.prefill_slices", 0))
                + rec["decode_ticks"]) * n_moe
        if launches["grouped_ffn_fwd"] != want or \
                eng.moe_decode_path() != {"pallas": want}:
            fail(f"{name}: grouped-FFN forward launches "
                 f"{launches['grouped_ffn_fwd']} / {eng.moe_decode_path()} "
                 f"!= {want}")
        rec["grouped_ffn_routes"] = moe_routes(rec["counters"])
        res[name], paths[name] = rec, launches
        res[name + "_outs"] = outs
        if name == "moe_spec":
            rec["accept_rate"] = eng.spec_accept_rate
            print(f"  moe_spec: accept rate {eng.spec_accept_rate:.4f}",
                  flush=True)
    thr = AGREE_BF16 if eng.cache_dtype != torch.float32 else AGREE_F32
    res["moe_spec"]["agreement"] = hold_agreement(
        torch, model, "moe_spec", trace, res.pop("moe_spec_outs"),
        res.pop("moe_plain_outs"), thr, paged=True)
    return res, paths


# -- phase 6c: reliability at the serving shapes ---------------------------

#: bench.py's serving_chaos extra: FaultInjector(seed 0, rate 0.02) over
#: every site the engine queries
CHAOS_SEED, CHAOS_RATE = 0, 0.02
#: phase 6c (a)'s forced faults: which queries a step makes follows the
#: wall-clock arrivals, so the seeded draws reach a decode.nan and an
#: alloc.exhausted on some runs only; the plan fires one of each at the
#: first query at or after its step (the plan draws nothing from the
#: injector's Generator)
CHAOS_PLAN = "30:decode.nan,60:alloc.exhausted"
#: phase 6c (b): the step after which the snapshot is written (the first
#: step past it at which every request of the trace has arrived)
SNAPSHOT_STEP = 40
#: phase 6c (c): deadlines of about this many k=1 device ticks
DEADLINE_TICKS = 20


def drive_requests(torch, eng, trace, params_of, on_step=None):
    """``drive_trace`` with per-request SamplingParams (``params_of(i)``)
    and a hook: ``on_step(eng, n_steps, n_arrived, outs)`` runs after each
    step (it may add an Output it caused, such as a cancel's, to ``outs``).
    Returns (outputs by req_id, seconds, each step's wall ms)."""
    arrivals, prompts = trace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, i, n, steps = {}, 0, len(prompts), []
    while len(outs) < n:
        now = time.perf_counter() - t0
        while i < n and arrivals[i] <= now:
            eng.add_request(prompts[i], params_of(i))
            i += 1
        if i < n and eng.idle:
            time.sleep(max(0.0, arrivals[i] - (time.perf_counter() - t0)))
            continue
        t1 = time.perf_counter()
        outs.update({o.req_id: o for o in eng.step()})
        steps.append((time.perf_counter() - t1) * 1e3)
        if on_step is not None:
            on_step(eng, len(steps), i, outs)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, steps


def sampled_teacher_forced_agreement(torch, model, prompt, tokens, sp):
    """Share of a SAMPLED request's tokens equal to the port's sampler
    applied to the no-cache forward over prompt + tokens[:-1], with the
    request's noise replayed from its seed (one Gumbel draw a token, as
    the engine draws them): robust to a flip, which only moves one
    position, and sensitive to a wrong generator state, which moves all."""
    import numpy as np
    from paddle_tpu_torch.text.generation import (gumbel_noise,
                                                  sample_token_arrays)
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int64)])
    with torch.no_grad():
        logits = model(torch.from_numpy(seq[None]).cuda())[0]
    cur = logits[len(prompt) - 1:].float()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(sp.seed))
    V = cur.shape[-1]
    noise = torch.stack([gumbel_noise(V, gen, "cuda") for _ in tokens])
    n = len(tokens)
    want = sample_token_arrays(
        cur, noise, torch.full((n,), float(sp.temperature), device="cuda"),
        torch.full((n,), int(sp.top_k), device="cuda"),
        torch.full((n,), float(sp.top_p), device="cuda")).cpu().tolist()
    return sum(int(a == b) for a, b in zip(tokens, want)) / n


def _rel_counts(mods, what, engines, ticks, launches_of, clean_graphs, card):
    """The counted-run gates of phase 6c (as ``accel_run``'s): paged-decode
    launches == device ticks x 4 layers, every call on the split kernel,
    no plain call, audit clean, no page leaked, no graph beyond the clean
    run's k buckets. Returns (record, launches)."""
    launches = launches_of()
    counters = {k: v for k, v in mods.monitor.snapshot().items()
                if k.startswith(("kernels.", "serving."))}
    layers = engines[0].serving_spec["num_layers"]
    if launches["paged_decode"] != ticks * layers or \
            counters.get("kernels.decode.paged_cuda") != \
            launches["paged_decode"] or any(
                v for k, v in counters.items() if k.endswith("_plain")):
        fail(f"{what}: paged-decode launches {launches['paged_decode']} != "
             f"{ticks} ticks x {layers}, or a plain call: {counters}")
    check_paged_split(counters, launches["paged_decode"], what)
    for eng in engines:
        findings = eng.check_invariants()
        leaked = eng.leaked_pages()
        if findings or leaked:
            fail(f"{what}: {leaked} pages leaked, audit {findings}")
        extra = sorted(set(eng._multi.captured) - set(clean_graphs))
        if extra:
            fail(f"{what}: CUDA graphs captured for k {extra} beyond the "
                 f"clean run's buckets {clean_graphs}")
    host = mods.monitor.histogram("serving.hist.host_ms_per_tick").sum
    dev = mods.monitor.histogram("serving.hist.device_ms_per_tick").sum
    ov = mods.monitor.histogram("serving.hist.overlap_ms_per_tick").sum
    rec = dict(decode_ticks=ticks, steps=int(counters["serving.steps"]),
               host_ms_per_tick=host / max(ticks, 1),
               device_ms_per_tick=dev / max(ticks, 1),
               overlap_ms_per_tick=ov / max(ticks, 1),
               graphs=[eng._multi.captured for eng in engines],
               counters=counters, card=card)
    print(f"  {what}: {ticks} device ticks, host {rec['host_ms_per_tick']:.3f}"
          f" / device {rec['device_ms_per_tick']:.3f} / overlap "
          f"{rec['overlap_ms_per_tick']:.3f} ms a tick on {card}", flush=True)
    return rec, launches


def serving_reliability(torch, mods, model, clean, k1_tick_ms, launches_of,
                        reset_counts, card):
    """Phase 6c: the reliability plane at bench.py::bench_llama_serving's
    width (16 slots, 128-token pages, 64-token bucket, bf16 pool,
    multi_tick=8) on the 24-request trace of phase 6b, against 6b's clean
    multi_tick=8 run (``clean``: its outputs and captured k buckets).
    Every part counts its launches from 0 before its engine and reads them
    after its drain (``_rel_counts``).

    (a) chaos, bench.py's serving_chaos: FaultInjector(seed 0, rate 0.02)
    over every site, one engine driving the trace twice (warm, timed): the
    faults must include a decode.nan and an alloc.exhausted that landed
    (seed 0 reaches both on some runs only, so ``CHAOS_PLAN`` forces one
    of each at fixed steps);
    every request finishes or fails as nan_logits / error:prefill, the
    nan_logits failures == serving.nan_quarantines == decode.nan +
    prefill.nan faults; survivors hold teacher-forced agreement >=
    AGREE_BF16. (b) a snapshot after step SNAPSHOT_STEP, restored on a
    fresh engine: every request finishes; waiting ones emit the
    uninterrupted run's tokens exactly, resumed ones hold teacher-forced
    agreement (sampled ones: the sampler over the no-cache forward with
    their noise replayed from the seed) >= AGREE_BF16. (c) deadlines of
    DEADLINE_TICKS k=1 ticks on a third of the requests and one cancel
    mid-decode, on the trace's second pass through one engine (the first,
    without deadlines, captures the graphs and seeds the clamp's tick
    estimate): the deadline clamp fires, every expiry lands within one
    step of its deadline, the cancel returns the pages at once, and every
    other request's tokens are the clean run's (a prefix of them when a
    deadline cut it)."""
    from paddle_tpu_torch.inference import FaultInjector, FaultPlan
    cfg = model.config
    common = dict(max_slots=16, page_size=128, prefill_bucket=64,
                  cache_dtype="bfloat16", multi_tick=8,
                  max_context=PROMPT_HI + NEW_TOKENS)
    trace = bench_trace(cfg.vocab_size)
    prompts = trace[1]
    clean_outs, clean_graphs = clean["outs"], clean["graphs"]
    greedy = mods.SamplingParams(max_new_tokens=NEW_TOKENS)
    print("serving reliability:", flush=True)
    res, paths = {}, {}

    # (a) chaos: the warm pass and the timed pass on one engine
    reset_counts()
    inj = FaultInjector(seed=CHAOS_SEED, rate=CHAOS_RATE,
                        plan=FaultPlan.parse(CHAOS_PLAN))
    eng = mods.Engine(model, fault_injector=inj, **common)
    passes = []
    for _ in range(2):
        off = eng._next_id
        outs, secs, _ = drive_requests(torch, eng, trace, lambda i: greedy)
        passes.append(([outs[off + j] for j in range(len(prompts))], secs))
    rec, paths["reliability_chaos"] = _rel_counts(
        mods, "chaos", [eng], eng.decode_ticks, launches_of, clean_graphs,
        card)
    c = rec["counters"]
    every = [o for outs, _ in passes for o in outs]
    bad = [o for o in every if not o.ok and o.finish_reason != "nan_logits"
           and not o.finish_reason.startswith("error:prefill")]
    n_nan = sum(o.finish_reason == "nan_logits" for o in every)
    want_nan = inj.counts.get("decode.nan", 0) + \
        inj.counts.get("prefill.nan", 0)
    if bad or n_nan != c.get("serving.nan_quarantines", 0) or \
            n_nan != want_nan:
        fail(f"chaos: failures outside the allowed set {bad[:2]}, or "
             f"nan_logits {n_nan} != quarantines "
             f"{c.get('serving.nan_quarantines')} != injected {want_nan}")
    # a recorded alloc.exhausted always took effect (a prefill requeued or
    # a sequence preempted); every request then still retired as checked
    if not n_nan or not inj.counts.get("alloc.exhausted"):
        fail(f"chaos: a decode.nan and an alloc.exhausted did not both "
             f"land: {inj.counts}, {c}")
    timed, secs = passes[1]
    surv = [(j, o) for j, o in enumerate(timed) if o.ok]
    agree = [teacher_forced_agreement(torch, model, prompts[j], o.token_ids)
             for j, o in surv]
    same = sum(o.token_ids == clean_outs[j].token_ids for j, o in surv)
    if agree and min(agree) < AGREE_BF16:
        fail(f"chaos: a survivor's teacher-forced agreement {min(agree)} "
             f"< {AGREE_BF16}")
    n_tok = sum(len(o.token_ids) for _, o in surv)
    rec.update(faults=dict(inj.counts), requests=len(every),
               survivors_timed=len(surv), survivor_tokens=n_tok,
               seconds=secs, survivor_tokens_per_s=n_tok / secs,
               identical_to_clean=same / max(len(surv), 1),
               agreement_min=min(agree) if agree else None,
               invariant_repairs=c.get("serving.invariant_repairs", 0),
               step_errors=c.get("serving.step_errors", 0),
               nan_quarantines=n_nan)
    print(f"  chaos: faults {inj.counts}; {len(surv)} of {len(timed)} "
          f"survive the timed pass, {n_tok / secs:.1f} tok/s of survivors, "
          f"{same} identical to the clean run, agreement min "
          f"{rec['agreement_min']}; invariant repairs "
          f"{rec['invariant_repairs']}, step errors {rec['step_errors']}",
          flush=True)
    res["reliability_chaos"] = rec
    del eng

    # (b) snapshot after step SNAPSHOT_STEP, restored on a fresh engine;
    # every 6th request sampled (temperature 0.8, seeded)
    def params_b(i):
        if i % 6 == 5:
            return mods.SamplingParams(max_new_tokens=NEW_TOKENS,
                                       temperature=0.8, seed=i)
        return greedy

    path = OUT_DIR / "snapshot_6c.json"
    snap_at = {}

    def snapshot_after(e, n_steps, arrived, outs):
        if n_steps >= SNAPSHOT_STEP and arrived == len(prompts) \
                and not snap_at:
            e.snapshot_to(str(path))
            snap_at["step"] = n_steps

    reset_counts()
    eng = mods.Engine(model, **common)
    uninterrupted, _, _ = drive_requests(torch, eng, trace, params_b,
                                         snapshot_after)
    if not snap_at:
        fail("restore: the trace drained before the snapshot step")
    eng2 = mods.Engine(model, **common)
    n_restored = eng2.restore_from(str(path))
    restored = {}
    while not eng2.idle:
        restored.update({o.req_id: o for o in eng2.step()})
    rec, paths["reliability_restore"] = _rel_counts(
        mods, "restore", [eng, eng2], eng.decode_ticks + eng2.decode_ticks,
        launches_of, clean_graphs, card)
    snap = json.loads(path.read_text())
    resumed = {e["req_id"] for e in snap["requests"] if e["generated"]}
    if len(restored) != n_restored or any(not o.ok or len(o.token_ids)
                                          != NEW_TOKENS
                                          for o in restored.values()):
        fail(f"restore: {len(restored)} of {n_restored} restored requests "
             f"finished, or one failed or ran short")
    rows = {}
    for rid, o in restored.items():
        j = rid                 # a fresh engine: ids in arrival order
        sp = params_b(j)
        if rid not in resumed:
            if o.token_ids != uninterrupted[rid].token_ids:
                fail(f"restore: request {rid}, waiting at the snapshot, "
                     f"differs from the uninterrupted run")
            continue
        a = (sampled_teacher_forced_agreement(torch, model, prompts[j],
                                              o.token_ids, sp)
             if sp.temperature > 0 else
             teacher_forced_agreement(torch, model, prompts[j],
                                      o.token_ids))
        rows[rid] = dict(agreement=a, sampled=sp.temperature > 0,
                         identical=o.token_ids
                         == uninterrupted[rid].token_ids)
    low = {r: v for r, v in rows.items() if v["agreement"] < AGREE_BF16}
    if low:
        fail(f"restore: resumed requests below {AGREE_BF16}: {low}")
    sampled = [v for v in rows.values() if v["sampled"]]
    rec.update(snapshot_step=snap_at["step"], restored=n_restored,
               resumed=len(rows), waiting_identical=n_restored - len(rows),
               resumed_identical=sum(v["identical"] for v in rows.values()),
               sampled_resumed=len(sampled),
               sampled_identical=sum(v["identical"] for v in sampled),
               agreement_min=min((v["agreement"] for v in rows.values()),
                                 default=None), rows=rows)
    print(f"  restore: snapshot after step {snap_at['step']}, "
          f"{n_restored} restored ({len(rows)} resumed, "
          f"{rec['resumed_identical']} of them identical; sampled "
          f"{rec['sampled_identical']} of {len(sampled)} identical), "
          f"agreement min {rec['agreement_min']}", flush=True)
    res["reliability_restore"] = rec
    del eng, eng2

    # (c) deadlines of ~DEADLINE_TICKS k=1 ticks on a third of the
    # requests, and one cancel mid-decode, on the trace's second pass: the
    # first (no deadline) captures the graphs and gives the deadline
    # clamp its tick estimate, so a fused dispatch between two arrivals
    # meets live deadlines (after the arrivals the queue drains only as
    # the deadlines expire)
    deadline_ms = DEADLINE_TICKS * k1_tick_ms

    def params_c(i):
        if i % 3 == 0:
            return mods.SamplingParams(max_new_tokens=NEW_TOKENS,
                                       deadline_ms=deadline_ms)
        return greedy

    cancelled = {}

    def cancel_one(e, n_steps, arrived, outs):
        if cancelled:
            return
        for r in e._slots:
            if r is not None and (r.req_id - off) % 3 and \
                    r.state == "DECODE" and len(r.generated) >= 16:
                free0, held = e.pages_free, len(r.pages)
                out = e.cancel(r.req_id)
                if e.pages_free != free0 + held:
                    fail(f"cancel: {held} pages did not return at once")
                cancelled[out.req_id] = outs[out.req_id] = out
                return

    reset_counts()
    eng = mods.Engine(model, **common)
    drive_requests(torch, eng, trace, lambda i: greedy)
    off = eng._next_id
    outs, secs, step_ms = drive_requests(torch, eng, trace, params_c,
                                         cancel_one)
    rec, paths["reliability_deadline"] = _rel_counts(
        mods, "deadline", [eng], eng.decode_ticks, launches_of, clean_graphs,
        card)
    c = rec["counters"]
    if not cancelled or not c.get("serving.multi_tick.clamp.deadline"):
        fail(f"deadline: no cancel ({cancelled}) or no deadline clamp: {c}")
    # an expiry lands at the step after the deadline passed: within the
    # worst step of the run plus the drive loop's gap between two steps
    worst = max(step_ms) + 1.0
    overrun = []
    for rid, o in outs.items():
        ref = clean_outs[rid - off].token_ids
        if rid in cancelled:
            ok = o.finish_reason == "cancelled" and \
                o.token_ids == ref[:len(o.token_ids)]
        elif (rid - off) % 3 == 0:
            late = (o.spans[-1]["t0_ms"] - o.spans[0]["t0_ms"]) - deadline_ms
            overrun.append(late)
            ok = (o.ok and o.token_ids == ref and late <= worst) or (
                o.finish_reason == "deadline" and 0.0 < late <= worst
                and o.token_ids == ref[:len(o.token_ids)])
        else:
            ok = o.ok and o.token_ids == ref
        if not ok:
            fail(f"deadline: request {rid} {o.finish_reason} with "
                 f"{len(o.token_ids)} tokens breaks the contract (deadline "
                 f"{deadline_ms:.1f} ms, worst step {worst:.2f} ms)")
    rec.update(deadline_ms=deadline_ms, k1_tick_ms=k1_tick_ms,
               timeouts=c.get("serving.timeouts", 0),
               clamp_deadline=c["serving.multi_tick.clamp.deadline"],
               cancelled=sorted(cancelled), worst_step_ms=worst,
               overrun_ms_max=max(overrun), seconds=secs)
    print(f"  deadline: {deadline_ms:.1f} ms on {len(overrun)} requests, "
          f"{rec['timeouts']} timeouts, deadline clamps "
          f"{rec['clamp_deadline']}, overrun max {max(overrun):.2f} ms "
          f"(worst step {worst:.2f}); cancelled {sorted(cancelled)}; "
          f"overlap {rec['overlap_ms_per_tick']:.3f} ms a tick", flush=True)
    res["reliability_deadline"] = rec
    del eng
    return res, paths


# -- phase 6d: one-shot decoding -------------------------------------------

#: phase 6d's batch: prompts x prompt tokens x new tokens (total = 128 +
#: _bucketed(128) = 256), and the ERNIE-MoE case's
ONE_SHOT_B, ONE_SHOT_S, ONE_SHOT_NEW = 16, 128, 128
ONE_SHOT_MOE_B, ONE_SHOT_MOE_NEW = 8, 96
#: (c)'s window: shorter than the 128-token prompt, so "auto" rolls
ONE_SHOT_WINDOW = 64
#: (f) and (g)
BEAM_B, BEAM_K, BEAM_NEW, BEAM_LP = 2, 4, 32, 0.8
SAMPLE_KW = dict(temperature=0.8, top_k=50, top_p=0.9, seed=0)
#: (f)'s gate on a returned beam's length-normalised score against its
#: teacher-forced recomputation, relative
BEAM_SCORE_RTOL = 1e-3


def one_shot_tf_agreement(torch, model, seqs, s):
    """Per row, the share of the generated tokens seqs[:, s:] equal to
    the argmax of ONE no-cache forward over seqs[:, :-1]."""
    with torch.no_grad():
        pred = model(seqs[:, :-1])[:, s - 1:].argmax(-1)
    return (pred == seqs[:, s:]).float().mean(1).tolist()


def one_shot_keep_sets(torch, logits, temperature, top_k, top_p):
    """generate's sampler keep set of each row of logits [n, V]: ranks <
    top_k, then the nucleus of the renormalised survivors."""
    scaled = logits.float() / temperature
    svals, order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    ranks = torch.arange(scaled.shape[-1], device=scaled.device)[None]
    keep = ranks < top_k
    probs = torch.softmax(torch.where(keep, svals, float("-inf")), dim=-1)
    keep = keep & ((torch.cumsum(probs, -1) - probs) < top_p)
    return torch.zeros_like(keep).scatter(1, order, keep)


def count_syncs(torch, fn):
    """Synchronizations fn() makes, as ``torch.cuda.set_sync_debug_mode``
    ("warn") reports them (warnings captured); the card is synchronised
    after the count, outside it."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def _windowed(model, window):
    """Set the LLaMA model's sliding window (config and every layer);
    returns the old one."""
    old = model.config.sliding_window
    model.config.sliding_window = window
    for lyr in model.llama.layers:
        lyr.self_attn.window = window
    return old


def one_shot_decoding(torch, mods, model, engine_ticks, launches_of,
                      reset_counts, card):
    """Phase 6d: ``text.generate`` / ``beam_search`` at the serving model
    (LLaMA-7B widths, 4 layers, f32), 16 prompts of 128 tokens, 128 new
    tokens; every run counted on its own (counts to 0 just before, read
    just after) and printed with tokens/s and ms a decode step beside
    the Engine's k=1 and k=8 ticks of this call. (a) greedy paged f32 and
    bf16 pools: paged-decode launches == 127 x 4, all split, no plain
    call, teacher-forced agreement >= AGREE_F32 / AGREE_BF16; (b) dense
    f32, bf16, int8 (the same gate, int8 at AGREE_BF16; identical share
    against (a) printed); (c) the model at a 64-token window: "auto"
    picks rolling, the 128-token prefill past the window; rolling bf16 and
    int8 tokens == the dense layout's, agreement against the windowed
    no-cache forward; (d) use_cache=False, 32 new tokens: flash forward
    launches == 32 x 4, all tf32x3; (e) ERNIE-MoE (bench_ernie_moe_serving's
    model), 8 prompts, 96 new tokens, paged f32: grouped-FFN forward
    launches == (1 + 95) x 2, the steps on "rows", paged-decode == 95 x 4,
    paged teacher-forced >= MOE_AGREE; (f) beam search, 2 prompts, 4
    beams, 32 new tokens, eos set, length_penalty 0.8, dense f32: each
    best beam's length-normalised score within BEAM_SCORE_RTOL of its
    teacher-forced recomputation, num_beams=1 == greedy dense; (g)
    sampling (T 0.8, top-k 50, top-p 0.9, seed 0) twice: identical, every
    token in its teacher-forced keep set; (h) the synchronizations of (a)'s
    paged bf16 and (b)'s dense bf16 runs at 32 and 128 new tokens equal
    (none grows with the length), with a control that counts known
    syncs; (i) the incubate paged_attention op at phase 3's LLaMA
    geometry (bf16, int8 pools) bit-equal to paged_decode and within the
    gate of paged_attention_arrays. Returns (records, launches by run)."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.quantization import kv_quantize_arrays
    from paddle_tpu_torch.text import beam_search, generate
    from paddle_tpu_torch.text.generation import _beam_search
    cfg = model.config
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    B, S, NEW = ONE_SHOT_B, ONE_SHOT_S, ONE_SHOT_NEW
    g = torch.Generator(device="cuda").manual_seed(14)
    ids = torch.randint(0, V, (B, S), generator=g, device="cuda")
    k1, k8 = (engine_ticks[k]["seconds"] * 1e3
              / engine_ticks[k]["decode_ticks"]
              for k in ("multi_tick_1", "multi_tick_8"))
    print(f"one-shot decoding (Engine of phase 6b: k=1 {k1:.3f}, k=8 "
          f"{k8:.3f} wall ms a device tick):", flush=True)
    res, paths = {}, {}
    # one short call of each model's first path before any time is taken
    # (first-call costs: allocator, library handles)
    generate(model, ids, 2, cache_impl="paged", page_size=128)
    torch.cuda.synchronize()

    def counted(name, call, m=model):
        """One counted run of call(); the model's forwards stamped (host
        clock and a CUDA event each, asynchronously) for the ms a step:
        the medians of the intervals between one decode forward and the
        next (the first, the prefill, left out)."""
        stamps, events = [], []

        def stamp(*_):
            stamps.append(time.perf_counter())
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        hook = m.register_forward_pre_hook(stamp)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        try:
            out = call()
        finally:
            hook.remove()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launches_of()
        counters = {k: v for k, v in mods.monitor.snapshot().items()
                    if k.startswith("kernels.")}
        plain = {k: v for k, v in counters.items()
                 if k.endswith("_plain") and v}
        if plain:
            fail(f"one-shot {name}: a plain version ran: {plain}")
        host = sorted(b - a for a, b in zip(stamps[1:], stamps[2:]))
        dev = sorted(a.elapsed_time(b) for a, b in zip(events[1:],
                                                       events[2:]))
        res[name] = dict(seconds=secs, counters=counters, forwards=len(stamps),
                         host_ms_per_step=(host[len(host) // 2] * 1e3
                                           if host else None),
                         device_ms_per_step=dev[len(dev) // 2] if dev
                         else None)
        paths[name] = launches
        return out, secs

    def gen(name, m, x, new, **kw):
        """A counted generate of ``new`` tokens (after an uncounted one of
        4, the warm-up of this path), with tokens/s over its wall time
        and the medians of a decode step's host and device ms."""
        generate(m, x, 4, **kw)
        out, secs = counted(name, lambda: generate(m, x, new, **kw), m)
        b = x.shape[0]
        r = res[name]
        r.update(new_tokens=new, batch=b, tokens_per_s=b * new / secs,
                 k1_tick_ms=k1, k8_tick_ms=k8)
        print(f"  {name}: {b} x {new} tokens in {secs:.3f} s = "
              f"{b * new / secs:.1f} tok/s; a decode step (median) "
              f"{r['device_ms_per_step']:.3f} ms on the card's events, "
              f"{r['host_ms_per_step']:.3f} on the host's clock (Engine k=1 "
              f"{k1:.3f}, k=8 {k8:.3f} ms a tick) on {card}", flush=True)
        if tuple(out.shape) != (b, x.shape[1] + new) or \
                out.device.type != "cuda":
            fail(f"one-shot {name}: result {tuple(out.shape)} on "
                 f"{out.device}")
        return out

    def agreement(name, m, out, thr):
        agree = one_shot_tf_agreement(torch, m, out, S)
        res[name]["agreement"] = agree
        print(f"    teacher-forced agreement min {min(agree):.4f} mean "
              f"{sum(agree) / len(agree):.4f} (threshold {thr})", flush=True)
        if min(agree) < thr:
            fail(f"one-shot {name}: teacher-forced agreement {agree} < "
                 f"{thr}")

    def launches_are(name, want):
        got = {k: paths[name][k] for k in want}
        if got != want:
            fail(f"one-shot {name}: launches {paths[name]}, expected {want}")

    # (a) paged, greedy, f32 and bf16 pools
    paged = {}
    for dt, thr in (("float32", AGREE_F32), ("bfloat16", AGREE_BF16)):
        name = f"one_shot_paged_{dt}"
        paged[dt] = gen(name, model, ids, NEW, cache_impl="paged",
                        page_size=128, cache_dtype=dt)
        launches_are(name, {"paged_decode": (NEW - 1) * L, "flash_fwd": 0})
        check_paged_split(res[name]["counters"], (NEW - 1) * L, name)
        agreement(name, model, paged[dt], thr)
    # (b) dense f32, bf16, int8
    dense = {}
    for dt, thr in (("float32", AGREE_F32), ("bfloat16", AGREE_BF16),
                    ("int8", AGREE_BF16)):
        name = f"one_shot_dense_{dt}"
        dense[dt] = gen(name, model, ids, NEW, cache_impl="dense",
                        cache_dtype=dt)
        launches_are(name, {"paged_decode": 0, "flash_fwd": 0})
        if res[name]["counters"].get("kernels.decode.dense") != NEW * L:
            fail(f"one-shot {name}: dense cache calls "
                 f"{res[name]['counters']}")
        agreement(name, model, dense[dt], thr)
        ref = paged.get(dt, paged["bfloat16"])
        same = float((dense[dt][:, S:] == ref[:, S:]).float().mean())
        res[name]["identical_share_vs_paged"] = same
        print(f"    identical to (a)'s paged "
              f"{dt if dt in paged else 'bfloat16'} tokens: {same:.4f}",
              flush=True)
    # (c) rolling: the model at a 64-token window
    old = _windowed(model, ONE_SHOT_WINDOW)
    try:
        for dt in ("bfloat16", "int8"):
            roll, den = f"one_shot_rolling_{dt}", f"one_shot_dense_window_{dt}"
            r = gen(roll, model, ids, NEW, cache_dtype=dt)   # "auto"
            if res[roll]["counters"].get("kernels.decode.rolling") != NEW * L:
                fail(f"one-shot {roll}: 'auto' did not roll: "
                     f"{res[roll]['counters']}")
            d = gen(den, model, ids, NEW, cache_impl="dense", cache_dtype=dt)
            same = bool(torch.equal(r, d))
            res[roll]["equal_to_dense"] = same
            print(f"    rolling == dense layout of the windowed model: "
                  f"{same}", flush=True)
            if not same:
                share = float((r[:, S:] == d[:, S:]).float().mean())
                fail(f"one-shot {roll}: tokens differ from the dense "
                     f"layout's (identical share {share:.4f})")
            agreement(roll, model, r, AGREE_BF16)
    finally:
        _windowed(model, old)
    # (d) the padded path: 32 full no-cache forwards
    name = "one_shot_padded"
    out = gen(name, model, ids, 32, use_cache=False)
    launches_are(name, {"flash_fwd": 32 * L, "paged_decode": 0})
    res[name]["flash_routes"] = check_f32_routes(res[name]["counters"],
                                                 32 * L, name)
    agreement(name, model, out, AGREE_F32)
    # (e) ERNIE-MoE, paged f32
    P = mods.moe_profile
    mcfg = mods.ErnieMoEConfig(**P.MOE_SERVE_MODEL)
    moe_model = mods.ErnieMoEForCausalLM(mcfg, seed=0)
    moe_model.eval()
    mids = torch.randint(0, mcfg.vocab_size, (ONE_SHOT_MOE_B, S),
                         generator=g, device="cuda")
    name, mnew = "one_shot_moe_paged_float32", ONE_SHOT_MOE_NEW
    generate(moe_model, mids, 2, cache_impl="paged", page_size=128)
    n_moe = len(moe_model.moe_layers())
    mout = gen(name, moe_model, mids, mnew, cache_impl="paged",
               page_size=128, cache_dtype="float32")
    launches_are(name, {"paged_decode": (mnew - 1) * mcfg.num_hidden_layers,
                        "grouped_ffn_fwd": mnew * n_moe})
    check_paged_split(res[name]["counters"],
                      (mnew - 1) * mcfg.num_hidden_layers, name)
    # the prefill (capacity 8 x 128) on simt, the steps (capacity 8) on rows
    res[name]["grouped_ffn_routes"] = check_moe_routes(
        res[name]["counters"], {"fwd_cuda_rows": (mnew - 1) * n_moe,
                                "fwd_cuda_simt": n_moe}, name)
    agree = [paged_teacher_forced_agreement(
        torch, moe_model, mids[r].cpu().numpy(), mout[r, S:].tolist())
        for r in range(ONE_SHOT_MOE_B)]
    res[name]["agreement"] = agree
    print(f"    paged teacher-forced agreement min {min(agree):.4f} "
          f"(threshold {MOE_AGREE})", flush=True)
    if min(agree) < MOE_AGREE:
        fail(f"one-shot {name}: teacher-forced agreement {agree}")
    del moe_model
    torch.cuda.empty_cache()
    # (f) beam search, dense f32
    bids = ids[:BEAM_B]
    eos = int(dense["float32"][0, S + 10])     # a token greedy emits
    name = "one_shot_beam"
    (tokens, norm, lens), secs = counted(name, lambda: _beam_search(
        model, bids, BEAM_NEW, BEAM_K, BEAM_LP, eos, "float32"))
    step_ms = res[name]["device_ms_per_step"]
    with torch.no_grad():
        lp = torch.log_softmax(model(tokens[:, :-1]).float(), dim=-1)
    rel = []
    for r in range(BEAM_B):
        n = int(lens[r])
        tf = float(lp[r, S - 1:S - 1 + n].gather(
            -1, tokens[r, S:S + n, None]).sum()) / n ** BEAM_LP
        rel.append(abs(float(norm[r]) - tf) / abs(tf))
    one = beam_search(model, bids, BEAM_NEW, num_beams=1, eos_token_id=eos,
                      cache_dtype="float32")
    greedy = generate(model, bids, BEAM_NEW, eos_token_id=eos,
                      cache_impl="dense", cache_dtype="float32")
    res[name].update(scores=norm.tolist(), lengths=lens.tolist(), eos=eos,
                     score_rel_err=rel, one_beam_equals_greedy=bool(
                         torch.equal(one, greedy)))
    print(f"  {name}: {BEAM_B} prompts x {BEAM_K} beams x {BEAM_NEW} tokens "
          f"in {secs:.3f} s ({step_ms:.3f} ms a step), scores "
          f"{norm.tolist()} (lengths {lens.tolist()}), teacher-forced "
          f"relative error {rel} (gate {BEAM_SCORE_RTOL}); num_beams=1 == "
          f"greedy dense: {res[name]['one_beam_equals_greedy']}", flush=True)
    if max(rel) > BEAM_SCORE_RTOL or not res[name]["one_beam_equals_greedy"]:
        fail(f"one-shot beam search: {res[name]}")
    # (g) sampling, twice from one seed
    name = "one_shot_sampled"
    a = gen(name, model, ids, NEW, cache_impl="dense",
            cache_dtype="float32", **SAMPLE_KW)
    b = generate(model, ids, NEW, cache_impl="dense", cache_dtype="float32",
                 **SAMPLE_KW)
    with torch.no_grad():
        logits = model(a[:, :-1])[:, S - 1:]
    keep = one_shot_keep_sets(torch, logits.reshape(-1, V),
                              SAMPLE_KW["temperature"], SAMPLE_KW["top_k"],
                              SAMPLE_KW["top_p"])
    inside = float(keep.gather(1, a[:, S:].reshape(-1, 1)).float().mean())
    res[name].update(repeat_equal=bool(torch.equal(a, b)),
                     share_in_keep_set=inside)
    print(f"    same seed twice identical: {res[name]['repeat_equal']}; "
          f"share of tokens in their teacher-forced keep set {inside}",
          flush=True)
    if not res[name]["repeat_equal"] or inside != 1.0:
        fail(f"one-shot sampling: {res[name]}")
    # (h) no per-step host synchronisation
    # the control: 2 and 5 host reads of a card tensor differ by 3 syncs
    control = count_syncs(torch, lambda: [int(ids[0, i]) for i in range(5)]) \
        - count_syncs(torch, lambda: [int(ids[0, i]) for i in range(2)])
    syncs = {}
    for impl, dt in (("paged", "bfloat16"), ("dense", "bfloat16")):
        for n in (32, NEW):
            syncs[f"{impl}_{dt}_{n}"] = count_syncs(torch, lambda: generate(
                model, ids, n, cache_impl=impl, page_size=128,
                cache_dtype=dt))
    res["one_shot_syncs"] = dict(syncs=syncs, control_5_less_2_reads=control)
    print(f"  synchronizations (set_sync_debug_mode): {syncs}; control "
          f"(5 host reads less 2) {control}", flush=True)
    if control != 3 or syncs["paged_bfloat16_32"] != \
            syncs[f"paged_bfloat16_{NEW}"] or syncs["dense_bfloat16_32"] \
            != syncs[f"dense_bfloat16_{NEW}"]:
        fail(f"one-shot decoding syncs grow with the length (or the count "
             f"misses known syncs): {syncs}, control {control}")
    # (i) the incubate paged_attention op at phase 3's LLaMA geometry
    b, h, hkv, d, _, longest, bs, nblk = PAGED_SERVING["llama"]
    ctx = torch.randint(1, longest + 1, (b,), generator=g, device="cuda")
    ctx[3] = ctx[11] = 0
    ctx[0] = longest
    nb = b * nblk + 1
    bt = (torch.randperm(nb - 1, generator=g, device="cuda") + 1).reshape(
        b, nblk).to(torch.int32)
    q = torch.randn(b, h, d, generator=g, device="cuda")
    ops = {}
    for dt in (torch.bfloat16, torch.int8):
        kf = torch.randn(nb, hkv, bs, d, generator=g, device="cuda")
        vf = torch.randn(nb, hkv, bs, d, generator=g, device="cuda")
        if dt == torch.int8:
            (kc, ks), (vc, vs) = kv_quantize_arrays(kf), kv_quantize_arrays(vf)
        else:
            kc, vc, ks, vs = kf.to(dt), vf.to(dt), None, None
        got = IF.paged_attention(q, kc, vc, bt, ctx, k_scale=ks, v_scale=vs)
        raw = pa.paged_decode(q, kc, vc, bt, ctx, k_scale=ks, v_scale=vs)
        want = pa.paged_attention_arrays(q, kc, vc, bt, ctx, k_scale=ks,
                                         v_scale=vs)
        c = closeness(got, want)
        key = str(dt).replace("torch.", "")
        ops[key] = dict(equal_to_paged_decode=bool(torch.equal(got, raw)),
                        **c)
        print(f"  incubate paged_attention[{key}]: == paged_decode "
              f"{ops[key]['equal_to_paged_decode']}, err "
              f"{c['max_abs_err']:.3g} (ratio {c['ratio']:.3g})", flush=True)
        if not (ops[key]["equal_to_paged_decode"] and c["ratio"] <= 1.0):
            fail(f"incubate paged_attention[{key}]: {ops[key]}")
    res["one_shot_paged_attention_op"] = ops
    return res, paths


# -- phase 28: collective training (process groups, collectives, fleet) ----

#: (b)'s f32 check: LLaMA-7B widths x 1 layer, f32, the fused loss, at
#: batch DIST_F32_BATCH x DIST_F32_SEQ; (c): phase 9's widths at
#: DIST_ZERO_LAYERS layers, DIST_ZERO_STEPS steps
DIST_F32_BATCH, DIST_F32_SEQ = 2, 256
DIST_ZERO_LAYERS, DIST_ZERO_STEPS = 2, 3
#: (b) and (c)'s bf16 gate on each step's loss against the one-rank
#: run's: |got - want| <= max(rtol |want|, floor). rtol 2^-7, bf16's eps
#: (the mp ranks round their partial products to bf16 before the
#: all-reduce, where one rank accumulates them in f32 and rounds once),
#: holds every step whose loss is at least 2^-7 of the first step's (the
#: first two of phase 9's batch); below that, the floor of 2^-14 of the
#: first step's loss: the fixed batch drives the loss from ~11.2 to
#: ~0.005 in 6 steps, where that rounding alone moves it by ~2e-4 (2.8e-2
#: relative)
DIST_BF16_RTOL = 2.0 ** -7
DIST_BF16_FLOOR_OF_FIRST = 2.0 ** -14
#: ZeRO-1's optimizer state a rank against the one-rank run's
DIST_ZERO_STATE_SHARE = 0.55
#: a rank process's time limit (its imports, builds loaded, the runs)
DIST_RANK_TIMEOUT = 600


def _loss_gate(got, want):
    """The largest |got - want| over its allowance (pass: <= 1) of two
    runs' per-step losses, and the largest relative difference."""
    floor = DIST_BF16_FLOOR_OF_FIRST * abs(want[0])
    ratio = max(abs(g - w) / max(DIST_BF16_RTOL * abs(w), floor)
                for g, w in zip(got, want))
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    return ratio, rel


def _dist_counts(torch, fa, fad, monitor):
    """Zero the launch counts and the counters a run reads."""
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
    fad.fused_adam_launch.launches = 0
    monitor.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _dist_comm(counters, steps):
    """Staged bytes, calls and host ms of the collectives a step, by op."""
    out = {}
    for k, v in counters.items():
        for kind in ("staged_bytes", "calls", "host_us"):
            pre = f"distributed.{kind}."
            if k.startswith(pre) and v:
                op = k[len(pre):]
                val = v / steps
                out.setdefault(op, {})[
                    "host_ms" if kind == "host_us" else kind] = \
                    val / 1e3 if kind == "host_us" else val
    return out


def _dist_train(torch, mods, model_cfg, stage, steps, distributed):
    """``steps`` bf16 steps of phase 9's batch through fleet's
    DistributedTrainStep (``distributed``) or a plain TrainStep; counts
    read around the steps. The model is built from seed 0."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel_step import \
        DistributedTrainStep
    cfg = mods.LlamaConfig(**model_cfg)
    model = mods.LlamaForCausalLM(cfg, seed=0)
    opt = mods.AdamW(3e-4, parameters=model.parameters(),
                     moment_dtype="bfloat16")
    if distributed:
        step = DistributedTrainStep(
            fleet.distributed_model(model), lambda out, lab: out,
            fleet.distributed_optimizer(opt), amp_dtype="bfloat16",
            sharding_stage=stage)
        state_bytes = step.opt_state_bytes()
        param_bytes = step.parameter_bytes()
    else:
        step = mods.TrainStep(model, lambda out, lab: out, opt,
                              amp_dtype="bfloat16")
        state_bytes = sum(t.numel() * t.element_size()
                          for s in step.opt_state.values()
                          for t in s.values())
        n = sum(p.numel() * p.element_size() for p in model.parameters())
        param_bytes = dict(sliced=0, whole=n, total=n)
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids, labels = (torch.randint(0, cfg.vocab_size,
                                 (mods.train.BATCH, mods.train.SEQ),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    _dist_counts(torch, mods.fa, mods.fad, monitor)
    losses, ms = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step((ids, labels), labels)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    counters = dict(monitor.snapshot())
    rec = dict(losses=losses, step_ms=ms,
               ms_per_step=sorted(ms[1:])[len(ms[1:]) // 2] if steps > 1
               else ms[0],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               opt_state_bytes=state_bytes, param_bytes=param_bytes,
               params=sum(p.numel() for p in model.parameters()),
               launches={"flash_fwd": mods.fa.flash_fwd.launches,
                         "flash_bwd_dq": mods.fa.flash_bwd.launches_dq,
                         "flash_bwd_dkv": mods.fa.flash_bwd.launches_dkv,
                         "fused_adam": mods.fad.fused_adam_launch.launches},
               counters={k: v for k, v in counters.items()
                         if k.startswith("kernels.")},
               comm=_dist_comm(counters, steps))
    del step, opt, model, loss
    free_cuda(torch)
    return rec


def _dist_f32_check(torch, mods, mp_group, sequence_parallel=False):
    """(b)'s f32 gate and (d)'s negative control, on the mp=2 ranks: the
    loss, the gathered logits and every gradient of LLaMA-7B widths x 1
    layer against rank 0's own mp=1 model from the same seed; then the
    two ranks' o_proj shards swapped, which must fail the gate.
    ``sequence_parallel`` (phase 30 (c)): the mp=2 model with it, its
    norms' gradients summed over mp as the step sums them."""
    from paddle_tpu_torch import bridge
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.communication import collectives as C
    from paddle_tpu_torch.distributed.fleet.meta_optimizers \
        .dygraph_optimizer import hybrid_parallel_optimizer as hpo
    cfg = mods.LlamaConfig(**{**mods.train.MODEL, "num_hidden_layers": 1,
                              "sequence_parallel": sequence_parallel})
    gen = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, cfg.vocab_size, (DIST_F32_BATCH, DIST_F32_SEQ),
                        generator=gen, device="cuda")
    model = mods.LlamaForCausalLM(cfg, seed=1)
    loss = model(ids, labels=ids)
    loss.backward()
    if sequence_parallel:
        hpo.sum_sequence_parallel_grads(
            [(p, p.grad) for p in model.parameters()], mp_group)
    with torch.no_grad():
        logits = model(ids)
    grads = {}
    for name, p in model.named_parameters():
        parts = C.all_gather(None, p.grad.contiguous(), group=mp_group)
        if mp_group.rank == 0:
            grads[name] = bridge.tp_merge(parts, "llama", name)
    o = model.llama.layers[0].self_attn.o_proj.weight
    with torch.no_grad():
        shards = C.all_gather(None, o.detach().contiguous(), group=mp_group)
        o.copy_(shards[1 - mp_group.rank])
        swapped = (model(ids, labels=ids), model(ids))
    rec = None
    if mp_group.rank == 0:
        saved = mesh_mod.get_mesh()
        mesh_mod.set_mesh(None)
        try:
            ref = mods.LlamaForCausalLM(cfg, seed=1)
        finally:
            mesh_mod.set_mesh(saved)
        want = ref(ids, labels=ids)
        want.backward()
        with torch.no_grad():
            want_logits = ref(ids)
        g = {n: closeness(grads[n], p.grad)
             for n, p in ref.named_parameters()}
        rec = dict(loss=closeness(loss.detach(), want.detach()),
                   logits=closeness(logits, want_logits),
                   grads_worst=max(g.values(), key=lambda c: c["ratio"]),
                   grads_ratio=max(c["ratio"] for c in g.values()),
                   n_grads=len(g), losses=(float(loss), float(want)))
        neg = dict(loss=closeness(swapped[0].detach(), want.detach()),
                   logits=closeness(swapped[1], want_logits))
        rec["negative_control"] = dict(
            ratio=max(c["ratio"] for c in neg.values()), **neg)
        del ref, want, want_logits
    del model, loss, logits, grads, swapped
    free_cuda(torch)
    return rec


def _dist_p2p(torch, rank, world_group):
    """A send / recv and a batched isend / irecv between the two ranks,
    and a broadcast, on CUDA tensors (staged under gloo)."""
    from paddle_tpu_torch import distributed as dist
    peer = 1 - rank
    got = torch.zeros(1 << 20, device="cuda")
    mine = torch.full((1 << 20,), float(rank + 1), device="cuda")
    if rank == 0:
        dist.send(mine, dst=peer)
        dist.recv(got, src=peer)
    else:
        dist.recv(got, src=peer)
        dist.send(mine, dst=peer)
    ok = bool((got == peer + 1).all())
    got.zero_()
    for t in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, peer),
                                     dist.P2POp(dist.irecv, got, peer)]):
        t.wait()
    ok = ok and bool((got == peer + 1).all())
    b = mine.clone()
    dist.broadcast(b, src=1)
    return ok and bool((b == 2).all())


def dist_rank_main(argv):
    """Phase 28's, 29's and 30's rank, started by the port's launcher
    (``s``: phase 30, ``seq_rank``); ``b``
    (mp=2: the f32 check, the negative control, P2P, then phase 9's bf16
    training for TRAIN_STEPS steps), ``c`` (dp=2, ZeRO-1:
    DIST_ZERO_LAYERS layers, DIST_ZERO_STEPS steps), ``p`` (pp=2: phase
    29 (b)'s f32 gate in every schedule, then (a), phase 9's pipeline for
    TRAIN_STEPS steps, then (d), the world re-cut as dp=2 for ZeRO-3 at
    DIST_ZERO_LAYERS layers, PIPE_ZERO3_STEPS steps). Writes
    ``rank<r>.json`` to --out."""
    import argparse
    p = argparse.ArgumentParser(prog="chip_smoke.py --dist-rank")
    p.add_argument("which", choices=("b", "c", "p", "s"))
    p.add_argument("--out", required=True)
    p.add_argument("--plant-fault", nargs="?", const="on",
                   choices=("on",) + tuple(PIPE_FAULTS) + tuple(SEP_FAULTS),
                   help="b: _c_identity's backward without its all-reduce "
                        "(``--dist-fault``); p: one of PIPE_FAULTS "
                        "(``--pipe-fault``); s: one of SEP_FAULTS "
                        "(``--sep-fault``)")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    import torch
    if args.plant_fault and args.which == "p":
        _plant_pipe_fault(args.plant_fault)
    elif args.plant_fault and args.which == "s":
        _plant_sep_fault(args.plant_fault)
    elif args.plant_fault:
        from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops
        mp_ops._Identity.backward = staticmethod(lambda ctx, g: (g, None))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from types import SimpleNamespace

    from paddle_tpu_torch import profile_moe as moe_profile
    from paddle_tpu_torch import profile_training as train
    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_adam as fad
    from paddle_tpu_torch.nn._modules import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import (ErnieMoEConfig,
                                              ErnieMoEForCausalLM,
                                              LlamaConfig, LlamaForCausalLM)
    mods = SimpleNamespace(train=train, LlamaConfig=LlamaConfig,
                           LlamaForCausalLM=LlamaForCausalLM, AdamW=AdamW,
                           TrainStep=TrainStep, fa=fa, fad=fad,
                           moe_profile=moe_profile,
                           ErnieMoEConfig=ErnieMoEConfig,
                           ErnieMoEForCausalLM=ErnieMoEForCausalLM,
                           CrossEntropyLoss=CrossEntropyLoss)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2} if args.which == "b" \
        else {"pp_degree": 2} if args.which == "p" \
        else {"sep_degree": 2} if args.which == "s" else {"dp_degree": 2}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    rank = env.get_rank()
    rec = dict(rank=rank, backend=env.backend(), device=str(env.device()),
               world=env.get_world_size(),
               mp=hcg.get_model_parallel_world_size(),
               dp=hcg.get_data_parallel_world_size())
    if args.which == "b":
        rec["f32"] = _dist_f32_check(torch, mods,
                                     hcg.get_model_parallel_group())
        rec["p2p_ok"] = _dist_p2p(torch, rank, None)
        rec["run"] = _dist_train(torch, mods, train.MODEL, 0, TRAIN_STEPS,
                                 True)
    elif args.which == "s":
        rec.update(seq_rank(torch, mods, args.plant_fault))
    elif args.which == "c":
        rec["run"] = _dist_train(
            torch, mods, {**train.MODEL,
                          "num_hidden_layers": DIST_ZERO_LAYERS},
            1, DIST_ZERO_STEPS, True)
    elif args.plant_fault and PIPE_FAULTS.get(args.plant_fault) is not None:
        rec["f32"] = _pipe_f32_check(torch, mods, [
            c for c in PIPE_F32_CASES
            if _pipe_case_name(*c) in PIPE_FAULTS[args.plant_fault]])
    else:
        rec["f32"] = _pipe_f32_check(torch, mods)
        rec["run"] = _pipe_train(torch, mods, TRAIN_STEPS)
        if not args.plant_fault:
            # (d) in the same processes, the world re-cut as dp=2
            s = fleet.DistributedStrategy()
            s.hybrid_configs = {"dp_degree": 2}
            fleet.init(is_collective=True, strategy=s)
            rec["dp"] = fleet.get_hybrid_communicate_group() \
                .get_data_parallel_world_size()
            rec["zero3"] = _dist_train(
                torch, mods, {**train.MODEL,
                              "num_hidden_layers": DIST_ZERO_LAYERS},
                3, PIPE_ZERO3_STEPS, True)
    rec["seconds"] = time.perf_counter() - t0
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank{rank}.json").write_text(json.dumps(rec))
    # leave the world together (a process group alive at exit can abort)
    from paddle_tpu_torch import distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def _dist_launch(which, timeout=DIST_RANK_TIMEOUT, fault=False):
    """Two ranks of ``chip_smoke.py --dist-rank which`` through the port's
    launcher (subprocesses sharing the card); any exit but 0 fails."""
    kind = fault if isinstance(fault, str) else "on"
    out = OUT_DIR / f"dist_{which}{'_fault_' + kind if fault else ''}"
    for f in out.glob("rank*.json"):
        f.unlink()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--log_dir", str(out),
           str(ROOT / "chip_smoke.py"), "--dist-rank", which, "--out",
           str(out)] + (["--plant-fault", kind] if fault else [])
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        logs = "".join(f"--- {p.name}\n{p.read_text()[-3000:]}"
                       for p in sorted(out.glob("workerlog.*")))
        fail(f"phase 28 ({which}): the launcher exited {run.returncode}: "
             f"{run.stdout[-1000:]}{run.stderr[-1000:]}\n{logs}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    return dict(ranks=ranks, process_s=secs)


def dist_fault_main():
    """``chip_smoke.py --dist-fault``: phase 28 (b)'s gates against a
    planted tensor-parallel fault, ``_c_identity``'s backward without its
    all-reduce on both ranks (each keeps its own part of the gradient of
    the column-parallel layers' input). Builds the kernels, runs phase
    9's configuration on one rank for TRAIN_STEPS bf16 steps, then the
    faulted mp=2 ranks; prints the f32 gate's and each step's bf16 loss
    gate ratios. Exits 0 only when both gates fail the faulted run."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    from types import SimpleNamespace

    from paddle_tpu_torch import profile_training as train
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build as build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_adam as fad
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build.build()
    for name in build.SOURCES:
        build.load(name)
    mods = SimpleNamespace(train=train, LlamaConfig=LlamaConfig,
                           LlamaForCausalLM=LlamaForCausalLM, AdamW=AdamW,
                           TrainStep=TrainStep, fa=fa, fad=fad)
    want = _dist_train(torch, mods, train.MODEL, 0, TRAIN_STEPS, False)
    ranks = _dist_launch("b", fault=True)["ranks"]
    f32 = ranks[0]["f32"]
    f32_ratio = max(f32["loss"]["ratio"], f32["logits"]["ratio"],
                    f32["grads_ratio"])
    floor = DIST_BF16_FLOOR_OF_FIRST * abs(want["losses"][0])
    for r in ranks:
        got = r["run"]["losses"]
        per = [abs(g - w) / max(DIST_BF16_RTOL * abs(w), floor)
               for g, w in zip(got, want["losses"])]
        r["bf16_gate_ratio"] = _loss_gate(got, want["losses"])[0]
        print(f"dist fault, rank {r['rank']}: losses "
              f"{[round(x, 5) for x in got]} against one rank's "
              f"{[round(x, 5) for x in want['losses']]}: bf16 gate ratio "
              f"a step {[round(x, 3) for x in per]}", flush=True)
    print(f"dist fault: f32 gate ratio {f32_ratio:.1f} (loss "
          f"{f32['loss']['ratio']:.3f}, logits {f32['logits']['ratio']:.3f}, "
          f"gradients {f32['grads_ratio']:.1f}) on {card}", flush=True)
    if f32_ratio <= 1 or any(r["bf16_gate_ratio"] <= 1 for r in ranks):
        fail("dist fault: a gate passed the planted fault")


def _dist_collectives_nccl(torch, card):
    """(a)'s collectives on a world of one under NCCL: every op of
    ``communication`` on a [4096, 4096] bf16 tensor (P2P needs a peer:
    the two-rank runs hold it), values checked, nothing staged."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import monitor
    gen = torch.Generator(device="cuda").manual_seed(28)
    x = torch.randn(4096, 4096, generator=gen, device="cuda").bfloat16()
    monitor.reset()
    bad = []

    def same(what, got):
        if not torch.equal(got, x):
            bad.append(what)

    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = x.clone()
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        same(f"all_reduce {op}", t)
    t = x.clone()
    dist.reduce(t, dst=0)
    same("reduce", t)
    got = []
    dist.all_gather(got, x)
    same("all_gather", got[0])
    objs = []
    dist.all_gather_object(objs, {"rank": 0})
    if objs != [{"rank": 0}]:
        bad.append("all_gather_object")
    t = x.clone()
    dist.broadcast(t, src=0)
    same("broadcast", t)
    t = torch.empty_like(x)
    dist.scatter(t, [x], src=0)
    same("scatter", t)
    t = torch.empty_like(x)
    dist.reduce_scatter(t, [x])
    same("reduce_scatter", t)
    got = []
    dist.alltoall(got, [x])
    same("alltoall", got[0])
    t = torch.empty_like(x)
    dist.alltoall_single(t, x)
    same("alltoall_single", t)
    dist.barrier()
    torch.cuda.synchronize()
    counters = dict(monitor.snapshot())
    staged = dist.communication.staged_bytes()
    if bad or staged:
        fail(f"phase 28 (a): collectives on a world of one under NCCL: "
             f"wrong {bad}, staged bytes {staged}")
    return _dist_comm(counters, 1)


def dist_main_path(torch, mods, launches_of, reset_counts, card):
    """Phase 28: collective training. (a) one rank under NCCL: the
    collectives, then phase 9's configuration through fleet.init ->
    distributed_model -> distributed_optimizer -> DistributedTrainStep
    for TRAIN_STEPS steps, the losses bit-equal to a plain TrainStep's
    from the same seed; (b) two ranks sharing the card under gloo (the
    port's launcher), mp=2: the f32 gate against rank 0's mp=1 model and
    (d) its negative control, then phase 9's bf16 training, each step's
    loss within ``_loss_gate`` of (a)'s; (c) two ranks, dp=2, ZeRO-1 at
    DIST_ZERO_LAYERS layers against a one-rank run of that model on the
    whole batch (losses, and at most DIST_ZERO_STATE_SHARE of its
    optimizer state a rank)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import env, fleet
    t_phase = time.perf_counter()
    free_cuda(torch)
    # (a)
    dist.init_parallel_env()
    backend = env.backend()
    if backend != "nccl":
        fail(f"phase 28 (a): one rank on one card picked {backend}, not nccl")
    comm_a = _dist_collectives_nccl(torch, card)
    fleet.init(is_collective=True)
    plain = _dist_train(torch, mods, mods.train.MODEL, 0, TRAIN_STEPS, False)
    reset_counts()
    a = _dist_train(torch, mods, mods.train.MODEL, 0, TRAIN_STEPS, True)
    a_launches = launches_of()
    want = mods.train.MODEL["num_hidden_layers"] * TRAIN_STEPS
    if a["losses"] != plain["losses"]:
        fail(f"phase 28 (a): DistributedTrainStep losses {a['losses']} are "
             f"not bit-equal to TrainStep's {plain['losses']}")
    if a["comm"].get("all_reduce", {}).get("staged_bytes") or any(
            c.get("staged_bytes") for c in a["comm"].values()):
        fail(f"phase 28 (a): bytes staged under NCCL: {a['comm']}")
    if {a["launches"][k] for k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv")} != {want} \
            or a["launches"]["fused_adam"] != TRAIN_STEPS:
        fail(f"phase 28 (a): launches {a['launches']}")
    a["routes"] = check_tc_routes(a["counters"], want, "phase 28 (a)")
    check_adam_routes(a["counters"], TRAIN_STEPS, "phase 28 (a)")
    a["collectives"] = comm_a
    a["backend"] = backend
    dist.destroy_process_group()
    fleet._reset()
    free_cuda(torch)
    # (b) and (d)
    b = _dist_launch("b")
    r0 = b["ranks"][0]
    f32 = r0["f32"]
    ratio = max(f32["loss"]["ratio"], f32["logits"]["ratio"],
                f32["grads_ratio"])
    if ratio > 1:
        fail(f"phase 28 (b): mp=2 f32 against mp=1 outside closeness's f32 "
             f"gate (ratio {ratio:.3f}): {f32}")
    if f32["negative_control"]["ratio"] <= 1:
        fail(f"phase 28 (d): swapped o_proj shards pass the f32 gate: "
             f"{f32['negative_control']}")
    for r in b["ranks"]:
        run = r["run"]
        if r["backend"] != "gloo" or r["mp"] != 2 or not r["p2p_ok"]:
            fail(f"phase 28 (b): rank {r['rank']}: backend {r['backend']}, "
                 f"mp {r['mp']}, p2p {r['p2p_ok']}")
        ratio_b, rel = _loss_gate(run["losses"], a["losses"])
        if ratio_b > 1:
            fail(f"phase 28 (b): rank {r['rank']} losses {run['losses']} vs "
                 f"(a) {a['losses']}: gate ratio {ratio_b:.3f} (relative "
                 f"{rel:.2e})")
        run["loss_gate_ratio"], run["loss_rel_to_a"] = ratio_b, rel
        if {run["launches"][k] for k in ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv")} != {want} \
                or run["launches"]["fused_adam"] != TRAIN_STEPS:
            fail(f"phase 28 (b): rank {r['rank']} launches {run['launches']}")
        run["routes"] = check_tc_routes(run["counters"], want,
                                        f"phase 28 (b) rank {r['rank']}")
        if not run["comm"].get("all_reduce", {}).get("staged_bytes"):
            fail(f"phase 28 (b): nothing staged under gloo: {run['comm']}")
    # (c)
    zero_cfg = {**mods.train.MODEL, "num_hidden_layers": DIST_ZERO_LAYERS}
    c_ref = _dist_train(torch, mods, zero_cfg, 0, DIST_ZERO_STEPS, False)
    c = _dist_launch("c")
    want_c = DIST_ZERO_LAYERS * DIST_ZERO_STEPS
    for r in c["ranks"]:
        run = r["run"]
        ratio_c, rel = _loss_gate(run["losses"], c_ref["losses"])
        run["loss_gate_ratio"], run["loss_rel_to_one_rank"] = ratio_c, rel
        run["state_share"] = run["opt_state_bytes"] / c_ref["opt_state_bytes"]
        if r["dp"] != 2 or ratio_c > 1 \
                or run["state_share"] > DIST_ZERO_STATE_SHARE:
            fail(f"phase 28 (c): rank {r['rank']}: dp {r['dp']}, losses "
                 f"{run['losses']} vs one rank {c_ref['losses']} (gate "
                 f"ratio {ratio_c:.3f}, relative {rel:.2e}), optimizer state "
                 f"share {run['state_share']:.3f}")
        if {run["launches"][k] for k in ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv")} != {want_c} \
                or run["launches"]["fused_adam"] != DIST_ZERO_STEPS:
            fail(f"phase 28 (c): rank {r['rank']} launches {run['launches']}")
        run["routes"] = check_tc_routes(run["counters"], want_c,
                                        f"phase 28 (c) rank {r['rank']}")
    secs = time.perf_counter() - t_phase
    rec = dict(a=a, a_plain=plain, a_launches=a_launches, b=b, c=c,
               c_one_rank=c_ref, seconds=secs, card=card)

    def comm_line(comm):
        return ", ".join(f"{op} {v.get('staged_bytes', 0) / 1e6:.1f} MB "
                         f"staged, {v.get('host_ms', 0):.1f} host ms"
                         for op, v in sorted(comm.items()))
    print(f"phase 28 (a): backend nccl, 1 rank; collectives on [4096, 4096] "
          f"bf16 equal, 0 bytes staged; DistributedTrainStep losses "
          f"{[round(x, 4) for x in a['losses']]} bit-equal to TrainStep's; "
          f"{a['ms_per_step']:.1f} ms a step (events; TrainStep "
          f"{plain['ms_per_step']:.1f}), peak {a['peak_gb']:.1f} GB; "
          f"collectives a step: {comm_line(a['comm']) or 'none'} on {card}",
          flush=True)
    print(f"phase 28 (b): backend gloo, 2 ranks on one card, mp=2; f32 "
          f"gate ratio {ratio:.3f} (loss {f32['loss']['ratio']:.3f}, "
          f"logits {f32['logits']['ratio']:.3f}, {f32['n_grads']} "
          f"gradients {f32['grads_ratio']:.3f}); (d) swapped o_proj ratio "
          f"{f32['negative_control']['ratio']:.1f} (caught) on {card}",
          flush=True)
    for name, run_set in (("b", b), ("c", c)):
        for r in run_set["ranks"]:
            run = r["run"]
            rel = run.get("loss_rel_to_a", run.get("loss_rel_to_one_rank"))
            print(f"phase 28 ({name}) rank {r['rank']}: backend "
                  f"{r['backend']}, losses "
                  f"{[round(x, 4) for x in run['losses']]} (gate ratio "
                  f"{run['loss_gate_ratio']:.3f}, relative {rel:.2e}), "
                  f"{run['ms_per_step']:.1f} ms a step (events), peak "
                  f"{run['peak_gb']:.1f} GB, optimizer state "
                  f"{run['opt_state_bytes'] / 1e9:.3f} GB, launches "
                  f"{run['launches']}; collectives a step: "
                  f"{comm_line(run['comm'])}; {r['seconds']:.1f} s in the "
                  f"rank on {card}", flush=True)
    print(f"phase 28 (c): one rank on the whole batch: losses "
          f"{[round(x, 4) for x in c_ref['losses']]}, "
          f"{c_ref['ms_per_step']:.1f} ms a step, optimizer state "
          f"{c_ref['opt_state_bytes'] / 1e9:.3f} GB; phase 28 "
          f"{secs:.1f} s ((b) {b['process_s']:.1f} s, (c) "
          f"{c['process_s']:.1f} s of launcher time) on {card}", flush=True)
    return rec


# -- phase 29: pipeline parallelism and ZeRO-3 -----------------------------

#: (a): phase 9's LLaMA at pp=2 (two gloo ranks on the card), 1F1B over
#: PIPE_M microbatches of 3 x 1024
PIPE_M, PIPE_MODE = 4, "1F1B"
#: (b): the f32 gate, LLaMA-7B widths at DIST_F32_BATCH x DIST_F32_SEQ in
#: PIPE_F32_M microbatches: (schedule, layers, vpp_degree, seg_method,
#: tied head) against a one-rank f32 model from the same seed
PIPE_F32_M = 2
PIPE_F32_CASES = (("FThenB", 2, 1, "uniform", False),
                  ("1F1B", 2, 1, "uniform", False),
                  ("VPP", 4, 2, "uniform", False),
                  ("ZBH1", 2, 1, "uniform", False),
                  ("ZBVPP", 4, 2, "uniform", False),
                  ("FThenB", 4, 1, [2, 5], False),     # 1 + 3 layers
                  ("FThenB", 2, 1, "uniform", True))   # the tied head
#: (c): the one-process MPMD modes at (b)'s first model
PIPE_MPMD_MODES = ("MPMD", "MPMD-ZBH1")
#: (b)'s gradient gate: closeness's f32 gate at each gradient's own scale
#: (atol this fraction of its max |ref|), not of max(1, max |ref|)
PIPE_GRAD_ATOL = 1e-4
#: ``--pipe-fault``'s planted faults, each in its own run, and the (b)
#: cases whose gradient gate must fail it (None: every case, and (a)'s
#: loss gate too)
PIPE_FAULTS = {"stale": None,
               "shared": ("FThenB_2l_tied",),
               "w": ("ZBH1_2l", "ZBVPP_4l_v2")}
#: (d): ZeRO-3's steps (the first of phase 28 (c)'s one-rank run's), its
#: resident parameters a rank (the sliced ones) and its optimizer state,
#: over one rank's
PIPE_ZERO3_STEPS = 2
PIPE_ZERO3_PARAM_SHARE = 0.505
PIPE_ZERO3_STATE_SHARE = (0.500, 0.505)


def _pipe_case_name(mode, layers, vpp, seg, tied):
    return (f"{mode}_{layers}l" + (f"_v{vpp}" if vpp > 1 else "")
            + ("_seg" + "+".join(map(str, seg)) if isinstance(seg, list)
               else "") + ("_tied" if tied else ""))


def _plant_pipe_fault(kind):
    """``--pipe-fault``'s planted fault ``kind`` in a pp rank: "stale",
    every stage sends the previous microbatch's activation in place of
    its own (from the second message on); "shared", the stages holding a
    shared weight keep their own parts of its gradient (no all-reduce);
    "w", each stage skips its first W event (microbatch 0's weight
    gradients) under ZBH1 / ZBVPP."""
    from paddle_tpu_torch.distributed import pipeline as P
    from paddle_tpu_torch.distributed.fleet.meta_parallel import pp_layers
    orig = P.StageRunner._event

    def stale(self, ev, ops, inbox, produced, slots):
        orig(self, ev, ops, inbox, produced, slots)
        if ev.phase == "fwd":
            prev = self.__dict__.setdefault("_planted_prev", {})
            for msg in ev.sends:
                key = (tuple(msg.tag), msg.peer)
                mine = produced[key]
                old = prev.get(msg.peer)
                prev[msg.peer] = mine
                if old is not None and old.shape == mine.shape:
                    produced[key] = old

    def skip_w(self, ev, ops, inbox, produced, slots):
        if ev.phase == "w" and ev.micro == 0 and ev.chunk == 0:
            slots.pop(ev.reads[0])
            return
        orig(self, ev, ops, inbox, produced, slots)

    if kind == "stale":
        P.StageRunner._event = stale
    elif kind == "w":
        P.StageRunner._event = skip_w
    elif kind == "shared":
        pp_layers.PipelineLayer.allreduce_shared_weight_gradients = \
            lambda self: None
    else:
        raise ValueError(f"unknown pipeline fault {kind!r}")


def _pipe_reference(torch, mods, cfg, ids):
    """The one-rank f32 model of (b) / (c) from seed 1: its loss, logits
    and gradients (built with no mesh: a whole model)."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    saved = mesh_mod.get_mesh()
    mesh_mod.set_mesh(None)
    try:
        ref = mods.LlamaForCausalLM(cfg, seed=1)
    finally:
        mesh_mod.set_mesh(saved)
    want = ref(ids, labels=ids)
    want.backward()
    with torch.no_grad():
        logits = ref(ids)
    grads = {n: p.grad for n, p in ref.named_parameters()}
    del ref
    return want.detach(), logits, grads


def _pipe_f32_ids(torch):
    gen = torch.Generator(device="cuda").manual_seed(7)
    return torch.randint(0, 32000, (DIST_F32_BATCH, DIST_F32_SEQ),
                         generator=gen, device="cuda")


def _pipe_closeness(torch, model, loss, logits, want, want_logits,
                    ref_grads, rename):
    """closeness's f32 gate of a pipeline's loss, output and gradients
    (this rank's stage) against the one-rank model's."""
    g = {}
    for n, p in model.named_parameters():
        ref = ref_grads[rename(n)]
        g[n] = closeness(p.grad, ref, atol=PIPE_GRAD_ATOL *
                         float(ref.float().abs().max()))
    rec = dict(loss=closeness(loss.reshape(()), want),
               loss_value=float(loss),
               grads_ratio=max(c["ratio"] for c in g.values()),
               grads_worst=max(g, key=lambda n: g[n]["ratio"]),
               n_grads=len(g),
               grad_norms={n: float(p.grad.float().norm())
                           for n, p in model.named_parameters()})
    if logits is not None:
        rec["logits"] = closeness(logits, want_logits)
    rec["ratio"] = max([rec["loss"]["ratio"], rec["grads_ratio"]]
                       + ([rec["logits"]["ratio"]] if logits is not None
                          else []))
    return rec


def _pipe_f32_check(torch, mods, cases=PIPE_F32_CASES):
    """(b), on a pp=2 rank: each case's one f32 train_batch (SGD at lr 0,
    so the gradients stay in .grad) and its forward against the one-rank
    model of its layers from the same seed: closeness's f32 gate on the
    loss, the logits (the last stage) and every gradient of this rank's
    stage."""
    from paddle_tpu_torch import bridge, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.text.models import build_llama_pipe
    ids = _pipe_f32_ids(torch)
    refs, out = {}, {}
    for mode, layers, vpp, seg, tied in cases:
        cfg = mods.LlamaConfig(**{**mods.train.MODEL,
                                  "num_hidden_layers": layers,
                                  "tie_word_embeddings": tied})
        if (layers, tied) not in refs:
            refs.clear()
            free_cuda(torch)
            refs[(layers, tied)] = _pipe_reference(torch, mods, cfg, ids)
        want, want_logits, ref_grads = refs[(layers, tied)]
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"pp_degree": 2}
        s.pipeline_configs = {"accumulate_steps": PIPE_F32_M,
                              "schedule_mode": mode, "vpp_degree": vpp}
        fleet.init(is_collective=True, strategy=s)
        model = fleet.distributed_model(build_llama_pipe(
            cfg, seed=1, seg_method=seg))
        loss = model.train_batch(
            (ids, ids), optimizer.SGD(0.0, parameters=model.parameters()))
        logits = model.eval_batch((ids, None), compute_loss=False)
        rec = _pipe_closeness(torch, model, loss, logits, want, want_logits,
                              ref_grads, bridge._pipe_to_llama_names(
                                  layers, tied))
        rec["names"] = sorted(n for n, _ in model.named_parameters())
        out[_pipe_case_name(mode, layers, vpp, seg, tied)] = rec
        del model, loss, logits
        free_cuda(torch)
    refs.clear()
    free_cuda(torch)
    return out


def _pipe_train(torch, mods, steps):
    """(a), on a pp=2 rank: phase 9's configuration through fleet.init
    (pp_degree 2, PIPE_MODE over PIPE_M microbatches, AMP bf16) ->
    build_llama_pipe -> distributed_model -> distributed_optimizer ->
    train_batch for ``steps`` steps on phase 9's batch (seed 4), the model
    from seed 0; counts read around the steps."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.text.models import build_llama_pipe
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": 2}
    s.pipeline_configs = {"accumulate_steps": PIPE_M,
                          "schedule_mode": PIPE_MODE}
    s.amp = True
    fleet.init(is_collective=True, strategy=s)
    cfg = mods.LlamaConfig(**mods.train.MODEL)
    model = fleet.distributed_model(build_llama_pipe(cfg, seed=0))
    opt = fleet.distributed_optimizer(mods.AdamW(
        3e-4, parameters=model.parameters(), moment_dtype="bfloat16"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids, labels = (torch.randint(0, cfg.vocab_size,
                                 (mods.train.BATCH, mods.train.SEQ),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    stage = fleet.get_hybrid_communicate_group().get_stage_id()
    layers = sum(1 for n, _ in model.named_parameters()
                 if n.endswith("input_layernorm.weight"))
    _dist_counts(torch, mods.fa, mods.fad, monitor)
    losses, ms = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = model.train_batch((ids, labels), opt)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    counters = dict(monitor.snapshot())
    act = (mods.train.BATCH // PIPE_M) * mods.train.SEQ * \
        cfg.hidden_size * 2
    rec = dict(losses=losses, step_ms=ms,
               ms_per_step=sorted(ms[1:])[len(ms[1:]) // 2],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               stage=stage, stage_layers=layers,
               params=sum(p.numel() for p in model.parameters()),
               names=sorted(n for n, _ in model.named_parameters()),
               boundary_bytes=act,
               runner=dict(model.last_runner.stats),
               launches={"flash_fwd": mods.fa.flash_fwd.launches,
                         "flash_bwd_dq": mods.fa.flash_bwd.launches_dq,
                         "flash_bwd_dkv": mods.fa.flash_bwd.launches_dkv,
                         "fused_adam": mods.fad.fused_adam_launch.launches},
               counters={k: v for k, v in counters.items()
                         if k.startswith("kernels.")},
               comm=_dist_comm(counters, steps))
    del model, opt, loss
    free_cuda(torch)
    return rec


def _pipe_mpmd(torch, mods, reset_counts, launches_of, fthenb):
    """(c): ``PipelineParallel`` in the MPMD modes in this process, both
    stages on the card (stage_devices), at (b)'s first model: one f32
    train_batch (SGD at lr 0) and the forward against the one-rank model
    (the f32 gate) and against (b)'s FThenB loss and gradient norms; a
    graph with a dropped receive must be refused by ``MpmdDriver``."""
    from paddle_tpu_torch import bridge, monitor, optimizer
    from paddle_tpu_torch.distributed import mpmd_graph as mg
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineParallel
    from paddle_tpu_torch.distributed.mpmd_runtime import (
        MpmdDriver, MpmdGraphRejected)
    from paddle_tpu_torch.text.models import build_llama_pipe
    mode0, layers, vpp, seg, tied = PIPE_F32_CASES[0]
    cfg = mods.LlamaConfig(**{**mods.train.MODEL,
                              "num_hidden_layers": layers})
    ids = _pipe_f32_ids(torch)
    want, want_logits, ref_grads = _pipe_reference(torch, mods, cfg, ids)
    rename = bridge._pipe_to_llama_names(layers, False)
    out = {}
    for mode in PIPE_MPMD_MODES:
        s = DistributedStrategy()
        s.pipeline_configs = {"accumulate_steps": PIPE_F32_M,
                              "schedule_mode": mode}
        model = PipelineParallel(build_llama_pipe(cfg, num_stages=2, seed=1),
                                 strategy=s)
        reset_counts()
        loss = model.train_batch(
            (ids, ids), optimizer.SGD(0.0, parameters=model.parameters()))
        torch.cuda.synchronize()
        launches = launches_of()
        counters = {k: v for k, v in monitor.snapshot().items()
                    if k.startswith("kernels.")}
        logits = model.eval_batch((ids, None), compute_loss=False)
        rec = _pipe_closeness(torch, model, loss, logits, want, want_logits,
                              ref_grads, rename)
        norms = rec.pop("grad_norms")
        rec["loss_equal_to_fthenb"] = rec["loss_value"] == \
            fthenb["loss_value"]
        rec["grad_norms_rel_to_fthenb"] = max(
            abs(norms[n] - g) / max(abs(g), 1e-30)
            for n, g in fthenb["grad_norms"].items())
        rec["fthenb_loss"] = closeness(torch.tensor(rec["loss_value"]),
                                       torch.tensor(fthenb["loss_value"]))
        rec.update(launches=launches, counters=counters,
                   driver=model.mpmd_driver.stats(),
                   devices=[str(d) for d in model._devices])
        out[mode] = rec
        del model, loss, logits
        free_cuda(torch)
    del want, want_logits, ref_grads
    free_cuda(torch)
    g = mg.schedule_graph("FThenB", 2, PIPE_F32_M)
    g.programs[1][0].recvs.clear()          # stage 1's first receive
    try:
        MpmdDriver(g)
        out["refused"] = None
    except MpmdGraphRejected as e:
        out["refused"] = list(e.rules)
    return out


def pipe_main_path(torch, mods, launches_of, reset_counts, card, dist):
    """Phase 29: pipeline parallelism and ZeRO-3. (b) then (a) on two pp
    ranks sharing the card under gloo (the port's launcher,
    ``--dist-rank p``): (b) the f32 gate in every schedule, the 1 + 3
    split and the tied head, each against a one-rank f32 model; (a)
    phase 9's LLaMA at pp=2, PIPE_MODE, TRAIN_STEPS bf16 steps, each
    loss within ``_loss_gate`` of phase 28 (a)'s (a one-rank step from
    the same seed, bit-equal to TrainStep's), the boundary's bytes staged
    to the byte, each stage's flash launches = its layers x PIPE_M x
    steps; (c) the MPMD modes in this process (both stages on the card)
    within the f32 gate of the one-rank model and of (b)'s FThenB, a
    defective graph refused; (d) the same two ranks re-cut as dp=2,
    ZeRO-3 at DIST_ZERO_LAYERS for PIPE_ZERO3_STEPS steps against phase
    28 (c)'s one-rank run: losses within ``_loss_gate``, each rank's
    resident parameters and optimizer state a half of one rank's."""
    t_phase = time.perf_counter()
    free_cuda(torch)
    p = _dist_launch("p")
    # (b)
    cases = {}
    for r in p["ranks"]:
        for name, rec in r["f32"].items():
            cases.setdefault(name, []).append(rec)
    b_ratio = {n: max(c["ratio"] for c in recs) for n, recs in cases.items()}
    if max(b_ratio.values()) > 1:
        fail(f"phase 29 (b): a pipeline outside closeness's f32 gate: "
             f"{b_ratio}")
    for name, recs in cases.items():
        names = [set(r["names"]) for r in recs]
        tied = name.endswith("_tied")
        if (names[0] & names[1]) != ({"0.weight"} if tied else set()):
            fail(f"phase 29 (b) {name}: the stages' parameters overlap: "
                 f"{sorted(names[0] & names[1])}")
    # (a)
    want = dist["a"]["losses"]
    exp_layers = mods.train.MODEL["num_hidden_layers"] // 2
    for r in p["ranks"]:
        run = r["run"]
        ratio, rel = _loss_gate(run["losses"], want)
        run["loss_gate_ratio"], run["loss_rel_to_one_rank"] = ratio, rel
        if r["backend"] != "gloo" or ratio > 1:
            fail(f"phase 29 (a): rank {r['rank']} ({r['backend']}) losses "
                 f"{run['losses']} vs one rank's {want}: gate ratio "
                 f"{ratio:.3f} (relative {rel:.2e})")
        k = exp_layers * PIPE_M * TRAIN_STEPS
        if run["stage_layers"] != exp_layers or \
                {run["launches"][n] for n in ("flash_fwd", "flash_bwd_dq",
                                              "flash_bwd_dkv")} != {k} \
                or run["launches"]["fused_adam"] != TRAIN_STEPS:
            fail(f"phase 29 (a): rank {r['rank']} layers "
                 f"{run['stage_layers']}, launches {run['launches']}")
        run["routes"] = check_tc_routes(run["counters"], k,
                                        f"phase 29 (a) rank {r['rank']}")
        staged = PIPE_M * run["boundary_bytes"]
        for op in ("send", "recv"):
            got = run["comm"].get(op, {}).get("staged_bytes")
            if got != staged:
                fail(f"phase 29 (a): rank {r['rank']} staged {got} bytes a "
                     f"step by {op}, the microbatches give {staged}")
    # (c)
    fthenb = [c for c in cases[_pipe_case_name(*PIPE_F32_CASES[0])]
              if c.get("logits") is not None][0]
    fthenb_norms = {}
    for c in cases[_pipe_case_name(*PIPE_F32_CASES[0])]:
        fthenb_norms.update(c["grad_norms"])
    mpmd = _pipe_mpmd(torch, mods, reset_counts, launches_of,
                      dict(loss_value=fthenb["loss_value"],
                           grad_norms=fthenb_norms))
    for mode in PIPE_MPMD_MODES:
        c = mpmd[mode]
        # each forward and each backward node once a microbatch: the
        # zero-bubble W events run no dQ or dK/dV again
        k = PIPE_F32_CASES[0][1] * PIPE_F32_M
        if c["ratio"] > 1 or c["fthenb_loss"]["ratio"] > 1 or \
                c["grad_norms_rel_to_fthenb"] > 1e-4 or \
                {c["launches"][n] for n in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")} != {k}:
            fail(f"phase 29 (c): {mode}: {c}")
    if not mpmd["refused"] or "mpmd.unmatched-p2p" not in mpmd["refused"]:
        fail(f"phase 29 (c): MpmdDriver ran a graph with a dropped "
             f"receive (refused: {mpmd['refused']})")
    # (d), run by the same ranks after (a)
    c_ref = dist["c_one_rank"]
    want_z = DIST_ZERO_LAYERS * PIPE_ZERO3_STEPS
    for r in p["ranks"]:
        run = r["zero3"]
        ratio, rel = _loss_gate(run["losses"],
                                c_ref["losses"][:PIPE_ZERO3_STEPS])
        run["loss_gate_ratio"], run["loss_rel_to_one_rank"] = ratio, rel
        one = c_ref["param_bytes"]["total"]
        pb = run["param_bytes"]
        run["param_share"] = pb["sliced"] / one
        run["param_whole_share"] = pb["whole"] / one
        run["state_share"] = run["opt_state_bytes"] / \
            c_ref["opt_state_bytes"]
        lo, hi = PIPE_ZERO3_STATE_SHARE
        if r["dp"] != 2 or ratio > 1 or \
                run["param_share"] > PIPE_ZERO3_PARAM_SHARE or \
                not lo <= run["state_share"] <= hi:
            fail(f"phase 29 (d): rank {r['rank']}: dp {r['dp']}, losses "
                 f"{run['losses']} vs one rank {c_ref['losses']} (gate "
                 f"ratio {ratio:.3f}), parameter share "
                 f"{run['param_share']:.4f} (+ whole "
                 f"{run['param_whole_share']:.4f}), state share "
                 f"{run['state_share']:.4f}")
        if {run["launches"][k] for k in ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv")} != {want_z} \
                or run["launches"]["fused_adam"] != PIPE_ZERO3_STEPS:
            fail(f"phase 29 (d): rank {r['rank']} launches {run['launches']}")
        run["routes"] = check_tc_routes(run["counters"], want_z,
                                        f"phase 29 (d) rank {r['rank']}")
    secs = time.perf_counter() - t_phase

    def comm_line(comm):
        return ", ".join(f"{op} {v.get('staged_bytes', 0) / 1e6:.1f} MB "
                         f"staged, {v.get('calls', 0):.0f} calls, "
                         f"{v.get('host_ms', 0):.1f} host ms"
                         for op, v in sorted(comm.items()))
    g_ratio = {n: max(c["grads_ratio"] for c in recs)
               for n, recs in cases.items()}
    print(f"phase 29 (b): pp=2, 2 gloo ranks, f32 gate ratio by case "
          + ", ".join(f"{n} {v:.3f} (gradients {g_ratio[n]:.3f})"
                      for n, v in b_ratio.items())
          + f" on {card}", flush=True)
    for r in p["ranks"]:
        run = r["run"]
        print(f"phase 29 (a) rank {r['rank']} (stage {run['stage']}, "
              f"{run['stage_layers']} layers, {run['params'] / 1e6:.1f} M "
              f"parameters): losses {[round(x, 4) for x in run['losses']]} "
              f"(gate ratio {run['loss_gate_ratio']:.3f}, relative "
              f"{run['loss_rel_to_one_rank']:.2e}), "
              f"{run['ms_per_step']:.1f} ms a step (events), peak "
              f"{run['peak_gb']:.1f} GB, launches {run['launches']}; a "
              f"step: {comm_line(run['comm'])}; {r['seconds']:.1f} s in "
              f"the rank on {card}", flush=True)
    for mode in PIPE_MPMD_MODES:
        c = mpmd[mode]
        print(f"phase 29 (c) {mode}: one process, stages on "
              f"{c['devices']}: f32 gate ratio {c['ratio']:.3f}, loss "
              f"{'==' if c['loss_equal_to_fthenb'] else '!='} (b)'s FThenB "
              f"(ratio {c['fthenb_loss']['ratio']:.3f}), gradient norms "
              f"within {c['grad_norms_rel_to_fthenb']:.1e}; launches "
              f"{c['launches']}; driver {c['driver']}", flush=True)
    print(f"phase 29 (c): a graph with a dropped receive refused: "
          f"{mpmd['refused']}", flush=True)
    for r in p["ranks"]:
        run = r["zero3"]
        print(f"phase 29 (d) rank {r['rank']}: ZeRO-3, losses "
              f"{[round(x, 4) for x in run['losses']]} (gate ratio "
              f"{run['loss_gate_ratio']:.3f}), parameters "
              f"{run['param_share']:.4f} of one rank's (+ unsliced "
              f"{run['param_whole_share']:.4f}), optimizer state "
              f"{run['state_share']:.4f}, {run['ms_per_step']:.1f} ms a "
              f"step, peak {run['peak_gb']:.1f} GB; a step: "
              f"{comm_line(run['comm'])} on {card}", flush=True)
    print(f"phase 29: {secs:.1f} s ((b), (a) and (d) {p['process_s']:.1f} "
          f"s of launcher time) on {card}", flush=True)
    return dict(p=p, mpmd=mpmd, b_ratio=b_ratio, seconds=secs, card=card)


def pipe_fault_main():
    """``chip_smoke.py --pipe-fault``: phase 29's gates against planted
    pipeline faults, each in its own pair of pp ranks (``--dist-rank p
    --plant-fault KIND``, PIPE_FAULTS): "stale" (each stage sends the
    previous microbatch's activation) must fail (a)'s bf16 loss gate and
    (b)'s f32 gate in every case; "shared" (the tied weight's gradient not
    all-reduced) and "w" (a skipped ZB W event) must each fail (b)'s
    gradient gate in their cases. Builds the kernels, runs phase 9's
    configuration on one rank (a TrainStep) for TRAIN_STEPS bf16 steps,
    then the faulted ranks; prints each gate's ratios. Exits 0 only when
    every fault is caught."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    from types import SimpleNamespace

    from paddle_tpu_torch import profile_training as train
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import _build as build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_adam as fad
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.build()
    for name in build.SOURCES:
        build.load(name)
    mods = SimpleNamespace(train=train, LlamaConfig=LlamaConfig,
                           LlamaForCausalLM=LlamaForCausalLM, AdamW=AdamW,
                           TrainStep=TrainStep, fa=fa, fad=fad)
    want = _dist_train(torch, mods, train.MODEL, 0, TRAIN_STEPS, False)
    floor = DIST_BF16_FLOOR_OF_FIRST * abs(want["losses"][0])
    missed = []
    for kind, case_names in PIPE_FAULTS.items():
        ranks = _dist_launch("p", fault=kind)["ranks"]
        b, g = {}, {}
        for r in ranks:
            for name, rec in r["f32"].items():
                b[name] = max(b.get(name, 0.0), rec["ratio"])
                g[name] = max(g.get(name, 0.0), rec["grads_ratio"])
        print(f"pipe fault {kind}: (b) f32 gate ratio by case "
              + ", ".join(f"{n} {v:.1f} (gradients {g[n]:.1f})"
                          for n, v in b.items()), flush=True)
        if case_names is not None:
            if sorted(g) != sorted(case_names) or \
                    min(g.values()) <= 1:
                missed.append(kind)
            continue
        a = []
        for r in ranks:
            got = r["run"]["losses"]
            per = [abs(x - w) / max(DIST_BF16_RTOL * abs(w), floor)
                   for x, w in zip(got, want["losses"])]
            a.append(_loss_gate(got, want["losses"])[0])
            print(f"pipe fault {kind}, rank {r['rank']}: losses "
                  f"{[round(x, 5) for x in got]} against one rank's "
                  f"{[round(x, 5) for x in want['losses']]}: bf16 gate "
                  f"ratio a step {[round(x, 3) for x in per]}", flush=True)
        if len(b) != len(PIPE_F32_CASES) or min(b.values()) <= 1 or \
                min(a) <= 1:
            missed.append(kind)
    print(f"pipe fault: {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    if missed:
        fail(f"pipe fault: a gate passed the planted fault(s) {missed}")


# -- phase 30: sequence, segment and expert parallelism --------------------

#: (a): LLaMA-7B widths at 1 x SEP_F32_SEQ over sep=2 (1,024 tokens a
#: rank) in f32, against rank 0's sep=1 model: (case, config overrides)
SEP_F32_SEQ = 2048
SEP_F32_CASES = (("mha_2l", dict(num_hidden_layers=2)),
                 ("gqa8_window512_1l", dict(num_hidden_layers=1,
                                            num_key_value_heads=8,
                                            sliding_window=512)))
#: (b), (c), (d): bf16 steps of each configuration; (b) at phase 28
#: (c)'s depth (its one-rank run the reference): at 4 layers its 4.29 GB
#: f32 gradient all-reduce over sep, staged through host memory, took
#: 6.9 of its 8.9 s a step. At 3 steps a configuration phase 30 took
#: 112.4 s of a 1,091 s ``chip_smoke.py`` (both on H100 80GB HBM3, 700 W):
#: 2 steps keep the script inside its limit on slower hosts
SEQ_STEPS = 2
SEP_TRAIN_LAYERS = DIST_ZERO_LAYERS
#: (d): ERNIE-MoE's f32 check at EP_F32_BATCH x EP_F32_SEQ; the share of
#: the expert parameters a rank holds at ep=2
EP_F32_BATCH, EP_F32_SEQ = 2, 128
EP_PARAM_SHARE = 0.50
#: ``--sep-fault``'s planted faults, each in its own run, and the part
#: whose f32 gate must fail it
SEP_FAULTS = {"ring_offset": "a", "sp_norm": "c", "ep_gather": "d"}


def _plant_sep_fault(kind):
    """``--sep-fault``'s planted fault ``kind`` in a rank: "ring_offset",
    every ring hop places the block's keys at this rank's own positions
    (not at their source rank's); "sp_norm", the sequence-parallel norms'
    gradients are not summed over mp; "ep_gather", the ep all-gather's
    backward sums the ranks' gradients where it should keep this rank's
    rows."""
    from paddle_tpu_torch.distributed import parallel_step
    from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops
    from paddle_tpu_torch.distributed.fleet.meta_optimizers \
        .dygraph_optimizer import hybrid_parallel_optimizer as hpo
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    from paddle_tpu_torch.kernels import ring_attention as ra
    if kind == "ring_offset":
        fwd, bwd = ra.fwd_hop, ra.bwd_hop

        def fwd_hop(q32, kk, vv, acc, m, l, pos_q, k_off, causal, window):
            return fwd(q32, kk, vv, acc, m, l, pos_q, int(pos_q[0]), causal,
                       window)

        def bwd_hop(q32, do32, lse, d_rows, kk, vv, dk, dv, dq, pos_q, k_off,
                    causal, window):
            return bwd(q32, do32, lse, d_rows, kk, vv, dk, dv, dq, pos_q,
                       int(pos_q[0]), causal, window)

        ra.fwd_hop, ra.bwd_hop = fwd_hop, bwd_hop
    elif kind == "sp_norm":
        hpo.sum_sequence_parallel_grads = lambda pairs, group: None
        parallel_step.sum_sequence_parallel_grads = hpo \
            .sum_sequence_parallel_grads
    elif kind == "ep_gather":
        moe_layer._EpGather.backward = staticmethod(
            lambda ctx, g: (mp_ops._reduce_scatter(g, ctx.group, ctx.dim),
                            None, None))
    else:
        raise ValueError(f"unknown sequence-parallel fault {kind!r}")


def _seq_fleet(**degrees):
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _whole_model(cls, cfg, seed):
    """``cls(cfg, seed=seed)`` built with no mesh: the whole model, as one
    rank's (a model's splits are fixed when it is built)."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    saved = mesh_mod.get_mesh()
    mesh_mod.set_mesh(None)
    try:
        return cls(cfg, seed=seed)
    finally:
        mesh_mod.set_mesh(saved)


def _own_scale_grads(got, ref):
    """closeness's f32 gate of each gradient at its own scale (phase 29
    (b)'s): {name: ratio}."""
    return {n: closeness(g, ref[n], atol=PIPE_GRAD_ATOL * float(
        ref[n].float().abs().max()))["ratio"] for n, g in got.items()}


def _ring_bytes(counters):
    return {op: counters.get(f"distributed.staged_bytes.{op}", 0)
            for op in ("send", "recv")}


def _sep_f32(torch, mods, mpmd=True):
    """(a), on a sep=2 rank: each SEP_F32_CASES model's loss, gathered
    logits and every gradient (summed over sep, as the step sums them)
    against rank 0's own sep=1 model from the same seed; then
    MpmdRingExecutor at R=2 in rank 0 against the two ranks' ring."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed.communication import collectives as C
    from paddle_tpu_torch.distributed.mpmd_runtime import MpmdRingExecutor
    from paddle_tpu_torch.kernels.ring_attention import ring_attention_arrays
    hcg = _seq_fleet(sep=2)
    g = hcg.get_sep_parallel_group()
    gen = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, mods.train.MODEL["vocab_size"], (1, SEP_F32_SEQ),
                        generator=gen, device="cuda")
    k = SEP_F32_SEQ // 2
    mine = ids[:, g.rank * k:(g.rank + 1) * k]
    out = {}
    for name, over in SEP_F32_CASES:
        cfg = mods.LlamaConfig(**{**mods.train.MODEL, **over,
                                  "max_position_embeddings": SEP_F32_SEQ})
        model = mods.LlamaForCausalLM(cfg, seed=1)
        monitor.reset()
        loss = model(mine, labels=mine)
        loss.backward()
        staged = _ring_bytes(monitor.counters())
        with torch.no_grad():
            logits = torch.cat(C.all_gather(None, model(mine).contiguous(),
                                            group=g), dim=1)
        grads = {}
        for n, p in model.named_parameters():
            t = p.grad.contiguous()
            C.all_reduce(t, group=g)
            grads[n] = t
        rec = dict(staged_a_step=staged, loss_value=float(loss.detach()))
        if g.rank == 0:
            ref = _whole_model(mods.LlamaForCausalLM, cfg, 1)
            want = ref(ids, labels=ids)
            want.backward()
            want = want.detach()
            with torch.no_grad():
                want_logits = ref(ids)
            gr = _own_scale_grads(grads, {n: p.grad for n, p in
                                          ref.named_parameters()})
            rec.update(loss=closeness(loss.detach(), want),
                       logits=closeness(logits, want_logits),
                       grads_ratio=max(gr.values()),
                       grads_worst=max(gr, key=gr.get), n_grads=len(gr),
                       want_loss=float(want))
            rec["ratio"] = max(rec["loss"]["ratio"], rec["logits"]["ratio"],
                               rec["grads_ratio"])
            del ref, want, want_logits
        out[name] = rec
        del model, loss, logits, grads
        free_cuda(torch)
    if not mpmd:
        return out
    # MpmdRingExecutor (one process, both stages on the card) against the
    # two ranks' ring_attention_arrays, attention at LLaMA-7B's shape
    gen = torch.Generator(device="cuda").manual_seed(30)
    q, kk, v, cot = (torch.randn(1, 32, SEP_F32_SEQ, 128, generator=gen,
                                 device="cuda") for _ in range(4))
    part = slice(g.rank * k, (g.rank + 1) * k)
    qs, ks, vs = (t[:, :, part].clone().requires_grad_() for t in (q, kk, v))
    ring = ring_attention_arrays(qs, ks, vs, causal=True)
    (ring * cot[:, :, part]).sum().backward()
    got = {n: torch.cat(C.all_gather(None, t.detach().contiguous(), group=g),
                        dim=2)
           for n, t in (("out", ring), ("dq", qs.grad), ("dk", ks.grad),
                        ("dv", vs.grad))}
    if g.rank == 0:
        ex = MpmdRingExecutor(2, causal=True)
        t0 = time.perf_counter()
        o, (dq, dk, dv) = ex.run(q, kk, v, dout=cot)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = {n: closeness(x, got[n]) for n, x in
             (("out", o), ("dq", dq), ("dk", dk), ("dv", dv))}
        out["mpmd"] = dict(ratio=max(x["ratio"] for x in c.values()),
                           by_tensor={n: x["ratio"] for n, x in c.items()},
                           seconds=secs, driver=ex.stats())
    del q, kk, v, cot, qs, ks, vs, ring, got
    free_cuda(torch)
    return out


def _ep_f32(torch, mods, hcg):
    """(d)'s f32 check and (e), on an ep=2 rank: ERNIE-MoE at its training
    widths and depth, f32, EP_F32_BATCH x EP_F32_SEQ: CE + aux, the loss,
    l_aux, the logits and every gradient (the experts' gathered over ep)
    against rank 0's own one-rank model from the same seed (the einsum
    dispatch, whose routing the ep fallback takes); then (e) the two
    ranks' expert shards swapped, which must fail the gate."""
    from paddle_tpu_torch.bridge import ep_merge
    from paddle_tpu_torch.distributed.communication import collectives as C
    P = mods.moe_profile
    g = hcg.get_expert_parallel_group()
    cfg = mods.ErnieMoEConfig(**P.MOE_TRAIN_MODEL)
    model = mods.ErnieMoEForCausalLM(cfg, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, cfg.vocab_size, (EP_F32_BATCH, EP_F32_SEQ),
                        generator=gen, device="cuda")
    ce = mods.CrossEntropyLoss()

    def loss_of(net):
        logits = net(ids)
        aux = net.aux_loss()
        return ce(logits, ids) + aux, aux, logits

    loss, aux, logits = loss_of(model)
    loss.backward()
    grads = {n: ep_merge(C.all_gather(None, p.grad.contiguous(), group=g), n)
             for n, p in model.named_parameters()}
    experts = [p for n, p in model.named_parameters() if ".experts." in n]
    mine = sum(p.numel() * p.element_size() for p in experts)
    with torch.no_grad():
        for p in experts:
            shards = C.all_gather(None, p.detach().contiguous(), group=g)
            p.copy_(shards[1 - g.rank])
        swapped = loss_of(model)
    rec = dict(expert_bytes=mine, loss_value=float(loss.detach()))
    if g.rank == 0:
        one_cfg = mods.ErnieMoEConfig(**{**P.MOE_TRAIN_MODEL,
                                         "moe_dispatch_mode": "einsum"})

        ref = _whole_model(mods.ErnieMoEForCausalLM, one_cfg, 1)
        want, want_aux, want_logits = loss_of(ref)
        want.backward()
        gr = _own_scale_grads(grads, {n: p.grad for n, p in
                                      ref.named_parameters()})
        rec.update(loss=closeness(loss.detach(), want.detach()),
                   l_aux=closeness(aux.detach(), want_aux.detach()),
                   logits=closeness(logits.detach(), want_logits.detach()),
                   grads_ratio=max(gr.values()),
                   grads_worst=max(gr, key=gr.get), n_grads=len(gr),
                   want_loss=float(want),
                   one_rank_expert_bytes=sum(
                       p.numel() * p.element_size()
                       for n, p in ref.named_parameters()
                       if ".experts." in n))
        rec["ratio"] = max(rec[k]["ratio"] for k in ("loss", "l_aux",
                                                     "logits"))
        rec["ratio"] = max(rec["ratio"], rec["grads_ratio"])
        neg = dict(loss=closeness(swapped[0].detach(), want.detach()),
                   logits=closeness(swapped[2].detach(),
                                    want_logits.detach()))
        rec["negative_control"] = dict(
            ratio=max(c["ratio"] for c in neg.values()), **neg)
        del ref, want, want_logits
    del model, loss, logits, grads, swapped
    free_cuda(torch)
    return rec


def _ep_train(torch, mods, steps, distributed):
    """(d)'s bf16 run: ERNIE-MoE's training configuration (phase 14's
    batch, CE + aux, AdamW with bf16 moments, AMP bf16) for ``steps``
    steps through DistributedTrainStep at ep=2 (``distributed``), or one
    rank's TrainStep with the einsum dispatch (whose routing the ep
    fallback takes); counts read around the steps."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel_step import \
        DistributedTrainStep
    P = mods.moe_profile
    over = {} if distributed else {"moe_dispatch_mode": "einsum"}
    cfg = mods.ErnieMoEConfig(**{**P.MOE_TRAIN_MODEL, **over})
    model = mods.ErnieMoEForCausalLM(cfg, seed=0)
    ce = mods.CrossEntropyLoss()
    opt = mods.AdamW(P.MOE_LR, parameters=model.parameters(),
                     moment_dtype="bfloat16")

    def loss_fn(out, lab):
        return ce(out, lab) + model.aux_loss()

    if distributed:
        step = DistributedTrainStep(fleet.distributed_model(model), loss_fn,
                                    fleet.distributed_optimizer(opt),
                                    amp_dtype="bfloat16")
    else:
        step = mods.TrainStep(model, loss_fn, opt, amp_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids, labels = (torch.randint(0, cfg.vocab_size, (P.MOE_BATCH, P.MOE_SEQ),
                                 generator=gen, device="cuda")
                   for _ in range(2))
    _dist_counts(torch, mods.fa, mods.fad, monitor)
    losses, ms = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step(ids, labels)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    counters = dict(monitor.snapshot())
    rec = dict(losses=losses, step_ms=ms,
               ms_per_step=sorted(ms[1:])[len(ms[1:]) // 2],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               n_moe=len(model.moe_layers()),
               layers=cfg.num_hidden_layers,
               expert_bytes=sum(p.numel() * p.element_size()
                                for n, p in model.named_parameters()
                                if ".experts." in n),
               launches={"flash_fwd": mods.fa.flash_fwd.launches,
                         "flash_bwd_dq": mods.fa.flash_bwd.launches_dq,
                         "flash_bwd_dkv": mods.fa.flash_bwd.launches_dkv,
                         "fused_adam": mods.fad.fused_adam_launch.launches},
               counters={k: v for k, v in counters.items()
                         if k.startswith("kernels.")},
               comm=_dist_comm(counters, steps))
    del step, opt, model, loss
    free_cuda(torch)
    return rec


def seq_rank(torch, mods, fault=None):
    """Phase 30's rank (``--dist-rank s``): (a) sep=2 the f32 checks and
    MpmdRingExecutor; (b) sep=2, phase 9's configuration through
    SegmentParallel and DistributedTrainStep for SEQ_STEPS bf16 steps;
    (c) mp=2 + sequence_parallel, the f32 check then SEQ_STEPS bf16
    steps (SEP_TRAIN_LAYERS layers in (b)); (d) ep=2, ERNIE-MoE's f32
    check with (e), then SEQ_STEPS bf16 steps. With a planted fault, only
    the f32 check of its part."""
    out, secs = {}, {}
    part = SEP_FAULTS.get(fault)
    t = time.perf_counter()
    if part in (None, "a"):
        out["a"] = _sep_f32(torch, mods, mpmd=part is None)
        secs["a"], t = time.perf_counter() - t, time.perf_counter()
    if part is None:
        _seq_fleet(sep=2)
        out["b"] = _dist_train(torch, mods, {
            **mods.train.MODEL, "num_hidden_layers": SEP_TRAIN_LAYERS}, 0,
            SEQ_STEPS, True)
        secs["b"], t = time.perf_counter() - t, time.perf_counter()
    if part in (None, "c"):
        hcg = _seq_fleet(mp=2)
        out["c_f32"] = _dist_f32_check(
            torch, mods, hcg.get_model_parallel_group(),
            sequence_parallel=True)
        if part is None:
            out["c"] = _dist_train(torch, mods, {**mods.train.MODEL,
                                                 "sequence_parallel": True},
                                   0, SEQ_STEPS, True)
        secs["c"], t = time.perf_counter() - t, time.perf_counter()
    if part in (None, "d"):
        hcg = _seq_fleet(ep=2)
        out["d_f32"] = _ep_f32(torch, mods, hcg)
        if part is None:
            out["d"] = _ep_train(torch, mods, SEQ_STEPS, True)
        secs["d"] = time.perf_counter() - t
    out["part_seconds"] = secs
    return out


def _seq_comm_line(comm):
    return ", ".join(f"{op} {v.get('staged_bytes', 0) / 1e6:.1f} MB "
                     f"staged, {v.get('calls', 0):.0f} calls, "
                     f"{v.get('host_ms', 0):.1f} host ms"
                     for op, v in sorted(comm.items()))


def seq_main_path(torch, mods, launches_of, reset_counts, card, dist):
    """Phase 30: sequence, segment and expert parallelism on two gloo
    ranks sharing the card (``--dist-rank s``): (a) the ring's f32 gate
    at sep=2 (LLaMA-7B widths x 2 layers, and x 1 layer with GQA and a
    window across the chunks) and MpmdRingExecutor against the ring; (b)
    phase 9's configuration at sep=2 (SegmentParallel, 512 tokens a
    rank) at SEP_TRAIN_LAYERS layers, each loss within ``_loss_gate`` of
    phase 28 (c)'s one-rank run of that depth; (c) mp=2
    with ``sequence_parallel``: phase 28 (b)'s f32 gate, then phase 9's
    configuration, each loss within the gate of 28 (a)'s, each rank's
    wgmma launches its 4 layers x SEQ_STEPS; (d) ep=2: ERNIE-MoE's f32
    gate at its training widths and depth, (e) swapped expert shards
    failing it, then its training batch for SEQ_STEPS bf16 steps within
    the gate of a one-rank run (built here), each rank holding half of
    the expert parameters and counting one ep-sharded fallback a MoE
    layer a forward."""
    t_phase = time.perf_counter()
    free_cuda(torch)
    one_rank_ep = _ep_train(torch, mods, SEQ_STEPS, False)
    s = _dist_launch("s")
    ranks = s["ranks"]
    r0 = ranks[0]
    want = {"b": dist["c_one_rank"]["losses"][:SEQ_STEPS],
            "c": dist["a"]["losses"][:SEQ_STEPS]}
    layers = mods.train.MODEL["num_hidden_layers"]
    # (a)
    a = r0["a"]
    a_ratio = {n: a[n]["ratio"] for n, _ in SEP_F32_CASES}
    if max(a_ratio.values()) > 1 or a["mpmd"]["ratio"] > 1:
        fail(f"phase 30 (a): sep=2 outside closeness's f32 gate: {a_ratio}, "
             f"MpmdRingExecutor {a['mpmd']}")
    # (b), (c)
    for part in ("b", "c"):
        for r in ranks:
            run = r[part]
            ratio, rel = _loss_gate(run["losses"], want[part])
            run["loss_gate_ratio"], run["loss_rel_to_a"] = ratio, rel
            flash = 0 if part == "b" else layers * SEQ_STEPS
            launched = {run["launches"][k] for k in (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
            if r["backend"] != "gloo" or ratio > 1 or launched != {flash} \
                    or run["launches"]["fused_adam"] != SEQ_STEPS:
                fail(f"phase 30 ({part}): rank {r['rank']} ({r['backend']}) "
                     f"losses {run['losses']} vs one rank's {want[part]}: "
                     f"gate ratio {ratio:.3f} (relative {rel:.2e}); "
                     f"launches {run['launches']}")
            if flash:
                run["routes"] = check_tc_routes(
                    run["counters"], flash, f"phase 30 ({part}) rank "
                                            f"{r['rank']}")
    sends = [r["b"]["comm"].get("send", {}).get("staged_bytes", 0)
             for r in ranks]
    if not all(sends):
        fail(f"phase 30 (b): no k/v staged by the ring: {sends}")
    c32 = r0["c_f32"]
    c_ratio = max(c32["loss"]["ratio"], c32["logits"]["ratio"],
                  c32["grads_ratio"])
    if c_ratio > 1:
        fail(f"phase 30 (c): mp=2 + sequence_parallel f32 against mp=1 "
             f"outside closeness's f32 gate: {c32}")
    for r in ranks:
        comm = r["c"]["comm"]
        if not (comm.get("all_gather", {}).get("staged_bytes")
                and comm.get("reduce_scatter", {}).get("staged_bytes")):
            fail(f"phase 30 (c): rank {r['rank']} staged no all_gather / "
                 f"reduce_scatter: {comm}")
    # (d), (e)
    d32 = r0["d_f32"]
    if d32["ratio"] > 1:
        fail(f"phase 30 (d): ep=2 ERNIE-MoE f32 outside closeness's f32 "
             f"gate: {d32}")
    if d32["negative_control"]["ratio"] <= 1:
        fail(f"phase 30 (e): swapped expert shards pass the f32 gate: "
             f"{d32['negative_control']}")
    for r in ranks:
        run = r["d"]
        ratio, rel = _loss_gate(run["losses"], one_rank_ep["losses"])
        run["loss_gate_ratio"], run["loss_rel_to_one_rank"] = ratio, rel
        run["expert_share"] = run["expert_bytes"] / \
            one_rank_ep["expert_bytes"]
        fallback = run["counters"].get(
            "kernels.moe.dispatch_path.fallback.ep-sharded", 0)
        want_fb = run["n_moe"] * SEQ_STEPS
        flash = run["layers"] * SEQ_STEPS
        if ratio > 1 or run["expert_share"] != EP_PARAM_SHARE or \
                fallback != want_fb or \
                {run["launches"][k] for k in ("flash_fwd", "flash_bwd_dq",
                                              "flash_bwd_dkv")} != {flash} \
                or run["launches"]["fused_adam"] != SEQ_STEPS:
            fail(f"phase 30 (d): rank {r['rank']}: losses {run['losses']} vs "
                 f"one rank {one_rank_ep['losses']} (gate ratio "
                 f"{ratio:.3f}), expert share {run['expert_share']:.4f}, "
                 f"ep-sharded fallbacks {fallback} (want {want_fb}), "
                 f"launches {run['launches']}")
        run["routes"] = check_tc_routes(run["counters"], flash,
                                        f"phase 30 (d) rank {r['rank']}")
    secs = time.perf_counter() - t_phase
    for name, _ in SEP_F32_CASES:
        c = a[name]
        print(f"phase 30 (a) {name}: sep=2, 2 gloo ranks, f32 gate ratio "
              f"{c['ratio']:.3f} (loss {c['loss']['ratio']:.3f}, logits "
              f"{c['logits']['ratio']:.3f}, {c['n_grads']} gradients "
              f"{c['grads_ratio']:.3f}, worst {c['grads_worst']}); k/v "
              f"staged a forward + backward by send "
              f"{c['staged_a_step']['send'] / 1e6:.1f} MB on {card}",
              flush=True)
    print(f"phase 30 (a): MpmdRingExecutor R=2 in one process against the "
          f"ranks' ring: ratio {a['mpmd']['ratio']:.3f} "
          f"({a['mpmd']['by_tensor']}), {a['mpmd']['seconds']:.2f} s, "
          f"driver {a['mpmd']['driver']} on {card}", flush=True)
    kv_hop = mods.train.BATCH * (mods.train.SEQ // 2) * \
        mods.train.MODEL["num_key_value_heads"] * \
        (mods.train.MODEL["hidden_size"] //
         mods.train.MODEL["num_attention_heads"]) * 2 * 2
    for part in ("b", "c", "d"):
        for r in ranks:
            run = r[part]
            rel = run.get("loss_rel_to_a", run.get("loss_rel_to_one_rank"))
            fallbacks = run["counters"].get(
                "kernels.moe.dispatch_path.fallback.ep-sharded", 0)
            extra = (f", expert share {run['expert_share']:.2f}, ep-sharded "
                     f"fallbacks {fallbacks}" if part == "d" else "")
            print(f"phase 30 ({part}) rank {r['rank']}: losses "
                  f"{[round(x, 4) for x in run['losses']]} (gate ratio "
                  f"{run['loss_gate_ratio']:.3f}, relative {rel:.2e}), "
                  f"{run['ms_per_step']:.1f} ms a step (events), peak "
                  f"{run['peak_gb']:.1f} GB, launches {run['launches']}"
                  f"{extra}; a step: {_seq_comm_line(run['comm'])} on "
                  f"{card}", flush=True)
    print(f"phase 30 (b): k/v a ring hop {kv_hop / 1e6:.1f} MB a layer (bf16, "
          f"12 x 512 x 32 x 128 x 2); staged by send a step "
          f"{sends[0] / 1e6:.1f} MB (rank 0)", flush=True)
    print(f"phase 30 (c): mp=2 + sequence_parallel f32 gate ratio "
          f"{c_ratio:.3f} (loss {c32['loss']['ratio']:.3f}, logits "
          f"{c32['logits']['ratio']:.3f}, {c32['n_grads']} gradients "
          f"{c32['grads_ratio']:.3f}) on {card}", flush=True)
    print(f"phase 30 (d): ERNIE-MoE ep=2 f32 gate ratio {d32['ratio']:.3f} "
          f"(loss {d32['loss']['ratio']:.3f}, l_aux "
          f"{d32['l_aux']['ratio']:.3f}, logits {d32['logits']['ratio']:.3f},"
          f" {d32['n_grads']} gradients {d32['grads_ratio']:.3f}); (e) "
          f"swapped expert shards ratio "
          f"{d32['negative_control']['ratio']:.1f} (caught); one rank: "
          f"losses {[round(x, 4) for x in one_rank_ep['losses']]}, "
          f"{one_rank_ep['ms_per_step']:.1f} ms a step on {card}",
          flush=True)
    print(f"phase 30: {secs:.1f} s ({s['process_s']:.1f} s of launcher time; "
          f"rank 0 {r0['seconds']:.1f} s, by part "
          f"{ {k: round(v, 1) for k, v in r0['part_seconds'].items()} }) "
          f"on {card}", flush=True)
    return dict(s=s, one_rank_ep=one_rank_ep, seconds=secs, card=card)


def sep_fault_main():
    """``chip_smoke.py --sep-fault``: phase 30's f32 gates against planted
    faults (SEP_FAULTS), each in its own pair of ranks (``--dist-rank s
    --plant-fault KIND``): the ring placing keys at the wrong source
    offset must fail (a)'s; the sequence-parallel norms' gradients left
    unsummed over mp must fail (c)'s; the ep all-gather's backward summing
    where it should slice must fail (d)'s. Builds the kernels, then the
    faulted ranks; prints each gate's ratio. Exits 0 only when every
    fault is caught."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    from paddle_tpu_torch.kernels import _build as build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.build()
    missed = []
    for kind, part in SEP_FAULTS.items():
        r0 = _dist_launch("s", fault=kind)["ranks"][0]
        if part == "a":
            ratio = {n: r0["a"][n]["ratio"] for n, _ in SEP_F32_CASES}
            caught = min(ratio.values()) > 1
        else:
            rec = r0[f"{part}_f32"]
            ratio = rec.get("grads_ratio")
            caught = ratio > 1
        print(f"sep fault {kind}: ({part}) f32 gate ratio {ratio}", flush=True)
        if not caught:
            missed.append(kind)
    print(f"sep fault: {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    if missed:
        fail(f"sep fault: a gate passed the planted fault(s) {missed}")


# -- phase 31: disaggregated and fleet serving -------------------------------

#: phase 31's engines: phase 20's replay geometry (8 slots, 16-token pages,
#: 128 pages a pool, a 64-token bucket, f32 pool) over phase 20's LLaMA
DISAGG_ENGINE = dict(max_slots=8, page_size=16, pool_pages=128,
                     prefill_bucket=64, max_context=256)
#: (a): 8 requests of REPLAY_PROMPT tokens (phase 20 (d)'s generator),
#: alternately greedy and seeded sampling (temperature 0.8, top-k 50),
#: DISAGG_NEW new tokens; requests 0 and 1 open with one
#: DISAGG_PREFIX-token prefix; decode worker 1 dies DISAGG_KILL_AFTER
#: driver steps after the first migrations
DISAGG_REQUESTS, DISAGG_NEW, DISAGG_PREFIX, DISAGG_KILL_AFTER = 8, 64, 32, 2
#: (b): 8 requests in two sessions of four, each opening with its own
#: FLEET_SYSTEM-token system prompt, one arriving a step; after
#: FLEET_MIGRATE_AT steps a live greedy and a live sampled request
#: migrate, after FLEET_KILL_AT replica 1 dies
FLEET_SYSTEM, FLEET_MIGRATE_AT, FLEET_KILL_AT = 32, 10, 14
#: (c)'s kill: decode worker 1 at this replay step
DISAGG_REPLAY_KILL_STEP = 20


def _disagg_requests(mods, vocab):
    import numpy as np
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, vocab, (DISAGG_PREFIX,))
    reqs = []
    for i in range(DISAGG_REQUESTS):
        n = int(rng.integers(REPLAY_PROMPT[0], REPLAY_PROMPT[1] + 1))
        p = rng.integers(0, vocab, (n,))
        if i < 2:
            p[:DISAGG_PREFIX] = prefix
        sampled = i % 2 == 1
        reqs.append((p.astype(np.int64), mods.SamplingParams(
            max_new_tokens=DISAGG_NEW, temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, seed=300 + i)))
    return reqs


def _fleet_requests(mods, vocab):
    import numpy as np
    rng = np.random.default_rng(31)
    systems = [rng.integers(0, vocab, (FLEET_SYSTEM,)) for _ in range(2)]
    reqs = []
    for i in range(DISAGG_REQUESTS):
        n = int(rng.integers(REPLAY_PROMPT[0], REPLAY_PROMPT[1] + 1))
        p = np.concatenate([systems[i % 2],
                            rng.integers(0, vocab, (n - FLEET_SYSTEM,))])
        sampled = i % 4 in (1, 2)
        reqs.append((p.astype(np.int64), mods.SamplingParams(
            max_new_tokens=DISAGG_NEW, temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, seed=400 + i)))
    return reqs


def _reference_tokens(mods, model, reqs):
    eng = mods.Engine(model, **DISAGG_ENGINE)
    return {o.req_id: o.token_ids for o in eng.run(reqs)}


def _plant_disagg_fault():
    """``--disagg-fault``: every migration's scatter skips the request's
    last page (its row index sent to the scratch page), so the decode
    worker attends stale KV there."""
    from paddle_tpu_torch.inference import disagg
    scatter = disagg.DecodeWorker._scatter

    def skipping(self, block, idx):
        idx = idx.clone()
        idx[int((idx > 0).sum()) - 1] = 0
        return scatter(self, block, idx)
    disagg.DecodeWorker._scatter = skipping


def _disagg_serve(torch, mods, model, launches_of, reset_counts, card):
    """Phase 31 (a): the DisaggEngine (one prefill worker, two decode
    workers at multi_tick 8, the prefix cache on) serving the 8 requests,
    decode worker 1 killed DISAGG_KILL_AFTER steps after the first
    migrations; its gather and scatter timed with CUDA events. Returns the
    record (``mismatched`` lists the requests whose tokens differ from the
    single-loop Engine's; the caller gates it)."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference import DisaggEngine, disagg
    reqs = _disagg_requests(mods, model.config.vocab_size)
    ref = _reference_tokens(mods, model, reqs)
    free_cuda(torch)
    ev = {"gather": [], "scatter": []}
    gather, scatter = DisaggEngine._gather, disagg.DecodeWorker._scatter

    def timed(kind, fn):
        def run(self, *a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(self, *a)
            end.record()
            ev[kind].append((start, end))
            return out
        return run
    DisaggEngine._gather = timed("gather", gather)
    disagg.DecodeWorker._scatter = timed("scatter", scatter)
    migrate_s = [0.0]
    migrate = DisaggEngine._migrate

    def migrate_timed(self):
        t = time.perf_counter()
        migrate(self)
        migrate_s[0] += time.perf_counter() - t
    DisaggEngine._migrate = migrate_timed
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = DisaggEngine(model, prefill_workers=1, decode_workers=2,
                           prefix_cache=True, multi_tick=8, **DISAGG_ENGINE)
        for p, sp in reqs:
            eng.add_request(p, sp)
        done, steps, first_mig, displaced = {}, 0, None, None
        captured_dead = 0
        while not eng.idle:
            done.update({o.req_id: o for o in eng.step()})
            steps += 1
            mig = monitor.counter("serving.disagg.migrations").get()
            if first_mig is None and mig:
                first_mig = steps
            if displaced is None and first_mig is not None \
                    and steps == first_mig + DISAGG_KILL_AFTER:
                captured_dead = len(eng.decode[1]._multi.captured)
                displaced = eng.kill_worker("decode", 1)
            if steps > 5000:
                fail("phase 31 (a): the disaggregated engine did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        DisaggEngine._gather, disagg.DecodeWorker._scatter = gather, scatter
        DisaggEngine._migrate = migrate
    launches = launches_of()
    counters = monitor.counters()
    got = {rid: o.token_ids for rid, o in done.items()}
    mismatched = sorted(r for r in ref if got.get(r) != ref[r])
    leaked = eng.leaked_pages()
    findings = eng.check_invariants()
    captured = {f"decode{i}": w._multi.captured
                for i, w in enumerate(eng.decode) if w is not None}
    gms = [s.elapsed_time(e) for s, e in ev["gather"]]
    sms = [s.elapsed_time(e) for s, e in ev["scatter"]]
    cfg = model.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    page_bytes = (cfg.num_hidden_layers * 2 * cfg.num_key_value_heads *
                  eng.page_size * hd * 4)
    n_tok = sum(len(t) for t in got.values())
    rec = dict(
        requests=len(reqs), steps=steps, wall_s=wall,
        tokens=n_tok, tokens_per_s=n_tok / wall, mismatched=mismatched,
        failed=[rid for rid, o in done.items() if not o.ok],
        leaked_pages=leaked, invariant_findings=findings,
        migrations=counters.get("serving.disagg.migrations", 0),
        migrated_pages=counters.get("serving.migrated_pages", 0),
        migrated_bytes=counters.get("serving.migrated_pages", 0)
        * page_bytes,
        moved_block_bytes=len(sms) * eng.max_blocks * page_bytes,
        readmitted=counters.get("serving.disagg.readmitted", 0),
        displaced=displaced, killed_at_step=(first_mig or 0)
        + DISAGG_KILL_AFTER, first_migration_step=first_mig,
        gather_ms=gms, scatter_ms=sms,
        gather_ms_a_request=sum(gms) / max(len(gms), 1),
        scatter_ms_a_request=sum(sms) / max(len(sms), 1),
        gather_share=sum(gms) / 1e3 / wall,
        scatter_share=sum(sms) / 1e3 / wall,
        migrate_step_share=migrate_s[0] / wall,
        graph_captures=counters.get("cuda.graph_captures", 0),
        captured=captured, captured_by_dead_worker=captured_dead,
        kernel_builds=counters.get("kernels.builds", 0),
        prefix_hit_rate=eng.prefix_hit_rate,
        utilization=eng.utilization(), launches=launches,
        counters={k: v for k, v in counters.items()
                  if k.startswith(("kernels.", "serving.disagg.",
                                   "serving.multi_tick.dispatches"))},
        card=card)
    del eng
    free_cuda(torch)
    return rec


def _disagg_gates(rec):
    """(a)'s gates beside its tokens: every request finished, no leak, at
    least one migration a request, the kill's displaced requests
    re-admitted (no decode preemption happens at this size), every decode
    tick on the split kernel, no flash launch outside a prefill (the
    Engine's prefill attends through the paged gather: none at all), no
    kernel build, and no graph capture beyond one a k bucket a decode
    worker."""
    c, l = rec["counters"], rec["launches"]
    if rec["failed"] or len(rec["mismatched"]) or rec["tokens"] != \
            DISAGG_REQUESTS * DISAGG_NEW:
        fail(f"phase 31 (a): failed {rec['failed']}, tokens differ from "
             f"the single-loop Engine's for {rec['mismatched']}")
    if rec["leaked_pages"] or rec["invariant_findings"]:
        fail(f"phase 31 (a): {rec['leaked_pages']} pages leaked, findings "
             f"{rec['invariant_findings']}")
    if rec["migrations"] < DISAGG_REQUESTS or not rec["displaced"] or \
            rec["readmitted"] != rec["displaced"]:
        fail(f"phase 31 (a): {rec['migrations']} migrations, "
             f"{rec['readmitted']} re-admitted for {rec['displaced']} "
             f"displaced by the kill")
    rec["paged_decode_routes"] = check_paged_split(
        c, l["paged_decode"], "phase 31 (a)")
    if not l["paged_decode"] or c.get("kernels.decode.paged_plain"):
        fail(f"phase 31 (a): paged decode launches {l['paged_decode']}, "
             f"counters {c}")
    if l["flash_fwd"]:
        fail(f"phase 31 (a): {l['flash_fwd']} flash forward launches; the "
             f"engine's prefill and decode attend through the paged pools")
    n_graphs = sum(len(v) for v in rec["captured"].values()) + \
        rec["captured_by_dead_worker"]
    if rec["kernel_builds"] or rec["graph_captures"] != n_graphs or \
            not c.get("serving.multi_tick.dispatches"):
        fail(f"phase 31 (a): {rec['kernel_builds']} kernel builds, "
             f"{rec['graph_captures']} graph captures for {n_graphs} k "
             f"buckets {rec['captured']}, multi-tick dispatches "
             f"{c.get('serving.multi_tick.dispatches')}")


def _fleet_serve(torch, mods, model, launches_of, reset_counts, card):
    """Phase 31 (b): a two-replica ServingFleet behind the session router
    serving the two sessions' requests (one arriving a step), a live
    greedy and a live sampled request migrated, then replica 1 killed
    mid-decode; every stream against the single-loop Engine's."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference import ServingFleet
    reqs = _fleet_requests(mods, model.config.vocab_size)
    ref = _reference_tokens(mods, model, reqs)
    free_cuda(torch)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet = ServingFleet(model, replicas=2, router="session",
                         **DISAGG_ENGINE)
    done, moved, killed, steps, i = {}, [], None, 0, 0
    while i < len(reqs) or not fleet.idle:
        if i < len(reqs):
            fleet.add_request(*reqs[i])
            i += 1
        done.update({o.req_id: o for o in fleet.step()})
        steps += 1
        if steps == FLEET_MIGRATE_AT:
            for sampled in (False, True):
                rid = next(r for r, q in sorted(fleet.requests.items())
                           if q.generated and r not in moved
                           and (q.params.temperature > 0) == sampled)
                if not fleet.migrate_request(rid):
                    fail(f"phase 31 (b): request {rid} did not migrate")
                moved.append(rid)
        if steps == FLEET_KILL_AT:
            killed = fleet.kill_replica(1)
        if steps > 5000:
            fail("phase 31 (b): the fleet did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of()
    counters = monitor.counters()
    got = {rid: o.token_ids for rid, o in done.items()}
    mismatched = sorted(r for r in ref if got.get(r) != ref[r])
    n_tok = sum(len(t) for t in got.values())
    rec = dict(requests=len(reqs), steps=steps, wall_s=wall, tokens=n_tok,
               tokens_per_s=n_tok / wall, mismatched=mismatched,
               failed=[rid for rid, o in done.items() if not o.ok],
               migrated=moved, killed_readmitted=killed,
               leaked_pages=fleet.leaked_pages(),
               invariant_findings=fleet.check_invariants(),
               prefix_hit_rate=fleet.prefix_hit_rate,
               routed_warm=counters.get("serving.fleet.routed_warm", 0),
               routed_cold=counters.get("serving.fleet.routed_cold", 0),
               replicas=fleet.utilization(), launches=launches,
               counters={k: v for k, v in counters.items()
                         if k.startswith(("kernels.", "serving.fleet."))},
               card=card)
    if rec["failed"] or mismatched or rec["leaked_pages"] or \
            rec["invariant_findings"] or not rec["routed_warm"] or \
            not killed:
        fail(f"phase 31 (b): failed {rec['failed']}, tokens differ for "
             f"{mismatched}, {rec['leaked_pages']} pages leaked, findings "
             f"{rec['invariant_findings']}, routed warm "
             f"{rec['routed_warm']}, {killed} re-admitted by the kill")
    rec["paged_decode_routes"] = check_paged_split(
        counters, launches["paged_decode"], "phase 31 (b)")
    del fleet
    free_cuda(torch)
    return rec


def disagg_main_path(torch, mods, launches_of, reset_counts, card, replay):
    """Phase 31: disaggregated and fleet serving of phase 20's LLaMA
    (LLaMA-7B widths x 4 layers, one set of seeded weights for every
    engine) on phase 20's replay geometry: (a) ``_disagg_serve`` and its
    gates; (b) ``_fleet_serve``; (c) the replay tool with ``--disagg
    --prefill-workers 1 --decode-workers 2 --kill-worker decode:1:<step>
    --expect-pallas`` on phase 20 (a)'s trace, its tokens phase 20 (a)'s
    plain run's. Counts are set to 0 before each served run and read
    after it; (c)'s come back in its report."""
    t_phase = time.perf_counter()
    free_cuda(torch)
    cfg = mods.LlamaConfig.tiny(vocab=32000, hidden=4096, layers=4,
                                heads=32)
    model = mods.LlamaForCausalLM(cfg, seed=0)
    model.eval()
    a = _disagg_serve(torch, mods, model, launches_of, reset_counts, card)
    _disagg_gates(a)
    print(f"phase 31 (a): DisaggEngine 1 prefill + 2 decode workers "
          f"(multi_tick 8) at LLaMA-7B widths x 4 layers f32: "
          f"{a['requests']} requests, {a['tokens']} tokens in "
          f"{a['wall_s']:.2f} s = {a['tokens_per_s']:.1f} tok/s, equal to "
          f"the single-loop Engine's; decode1 killed at step "
          f"{a['killed_at_step']} ({a['displaced']} re-admitted); "
          f"{a['migrations']} migrations, {a['migrated_pages']} pages "
          f"({a['migrated_bytes'] / 1e6:.1f} MB of KV; "
          f"{a['moved_block_bytes'] / 1e6:.1f} MB in fixed blocks); gather "
          f"{a['gather_ms_a_request']:.3f} ms and scatter "
          f"{a['scatter_ms_a_request']:.3f} ms a request (events), shares "
          f"of the wall: gather {a['gather_share']:.4f}, scatter "
          f"{a['scatter_share']:.4f}, migration steps (host) "
          f"{a['migrate_step_share']:.4f}; prefix hit rate "
          f"{a['prefix_hit_rate']:.4f}; graphs {a['captured']}; launches "
          f"{a['launches']} on {card}", flush=True)
    b = _fleet_serve(torch, mods, model, launches_of, reset_counts, card)
    print(f"phase 31 (b): ServingFleet 2 replicas (session router): "
          f"{b['requests']} requests, {b['tokens']} tokens in "
          f"{b['wall_s']:.2f} s = {b['tokens_per_s']:.1f} tok/s, equal to "
          f"the single-loop Engine's; migrated {b['migrated']}, replica 1 "
          f"killed ({b['killed_readmitted']} re-admitted); prefix hit rate "
          f"{b['prefix_hit_rate']:.4f}, routed warm / cold "
          f"{b['routed_warm']} / {b['routed_cold']}; launches "
          f"{b['launches']} on {card}", flush=True)
    del model
    free_cuda(torch)
    trace = OUT_DIR / "replay_trace.jsonl"
    c = run_replay("disagg", [
        trace, "--disagg", "--prefill-workers", "1", "--decode-workers",
        "2", "--kill-worker", f"decode:1:{DISAGG_REPLAY_KILL_STEP}",
        "--expect-pallas"] + REPLAY_LLAMA + REPLAY_ENGINE)
    # the tool zeroes its counts after its clean reference run: the
    # launches and the counters are both the kill run's
    _replay_decoder_gates("disagg", c)
    wk = c["worker_kill"]
    if c["tokens"] != replay["plain"]["tokens"] or not wk["survivors_exact"] \
            or not c["disagg"]["readmitted"]:
        fail(f"phase 31 (c): tokens equal phase 20 (a)'s: "
             f"{c['tokens'] == replay['plain']['tokens']}, kill {wk}, "
             f"disagg {c['disagg']}")
    secs = time.perf_counter() - t_phase
    print(f"phase 31 (c): replay --disagg 1p+2d, decode:1 killed at step "
          f"{DISAGG_REPLAY_KILL_STEP}: {c['requests']} requests, "
          f"{c['total_tokens']} tokens, tokens equal to phase 20 (a)'s, "
          f"{c['disagg']['migrations']} migrations, "
          f"{c['disagg']['readmitted']} re-admitted, {c['tokens_per_sec']} "
          f"tok/s ({c['process_s']:.1f} s of process) on {card}",
          flush=True)
    print(f"phase 31: {secs:.1f} s on {card}", flush=True)
    c = {k: v for k, v in c.items() if k != "tokens"}
    return dict(a=a, b=b, c=c, seconds=secs, card=card)


def disagg_fault_main():
    """``chip_smoke.py --disagg-fault``: phase 31 (a) with every
    migration's scatter skipping the request's last page
    (``_plant_disagg_fault``). Exits 0 only when (a)'s token gate fails
    it; prints the mismatched requests."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    from types import SimpleNamespace

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference import Engine, SamplingParams
    from paddle_tpu_torch.kernels import _build as build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.text.models import LlamaConfig, LlamaForCausalLM
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.build()
    mods = SimpleNamespace(Engine=Engine, SamplingParams=SamplingParams,
                           LlamaConfig=LlamaConfig,
                           LlamaForCausalLM=LlamaForCausalLM)

    def reset_counts():
        build.probe.launches = pa.paged_decode.launches = 0
        fa.flash_fwd.launches = 0
        monitor.reset()

    def launches_of():
        return {"probe": build.probe.launches,
                "paged_decode": pa.paged_decode.launches,
                "flash_fwd": fa.flash_fwd.launches}
    _plant_disagg_fault()
    cfg = LlamaConfig.tiny(vocab=32000, hidden=4096, layers=4, heads=32)
    model = LlamaForCausalLM(cfg, seed=0)
    model.eval()
    rec = _disagg_serve(torch, mods, model, launches_of, reset_counts, card)
    print(f"disagg fault: a scatter skipping each request's last page: "
          f"{len(rec['mismatched'])} of {rec['requests']} requests' tokens "
          f"differ from the single-loop Engine's {rec['mismatched']}; "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    if not rec["mismatched"]:
        fail("disagg fault: (a)'s token gate passed the planted fault")


# -- phases 4 and 5: the main path -----------------------------------------

def make_requests(SamplingParams, vocab_size):
    import numpy as np
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQUESTS):
        n = int(rng.integers(PROMPT_LO, PROMPT_HI))
        prompt = rng.integers(0, vocab_size, (n,)).astype(np.int64)
        if i % 6 == 5:          # 4 of 24 sampled, the rest greedy
            sp = SamplingParams(max_new_tokens=NEW_TOKENS, temperature=0.8,
                                top_k=50 if i % 12 == 5 else 0,
                                top_p=0.9 if i % 12 == 11 else 0.0, seed=i)
        else:
            sp = SamplingParams(max_new_tokens=NEW_TOKENS)
        reqs.append((prompt, sp))
    return reqs


def teacher_forced_agreement(torch, model, prompt, tokens):
    """Share of `tokens` equal to the argmax of the no-cache forward over
    prompt + tokens[:-1] at each generated position."""
    import numpy as np
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int64)])
    with torch.no_grad():
        logits = model(torch.from_numpy(seq[None]).cuda())[0]
    want = logits[len(prompt) - 1:].argmax(-1).cpu().tolist()
    return sum(int(a == b) for a, b in zip(tokens, want)) / len(tokens)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    try:
        from types import SimpleNamespace

        from paddle_tpu_torch import monitor
        from paddle_tpu_torch import optimizer as optimizer
        from paddle_tpu_torch import profile_encoder as enc
        from paddle_tpu_torch import profile_moe as moe_profile
        from paddle_tpu_torch import profile_training as train
        from paddle_tpu_torch.incubate.distributed.models.moe import \
            gate as moe_gate
        from paddle_tpu_torch.amp import GradScaler
        from paddle_tpu_torch.inference import (BatchEncoder, Engine,
                                                SamplingParams)
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.kernels import _build as build
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.kernels import fused_adam as fad
        from paddle_tpu_torch.kernels import moe
        from paddle_tpu_torch.kernels import paged_attention as pa
        from paddle_tpu_torch.nn._modules import CrossEntropyLoss
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.nn.functional import \
            document_startend_row_indices as doc_mask
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch.profile_serving import MODEL
        from paddle_tpu_torch.quantization import kv_quantize_arrays
        from paddle_tpu_torch.text.models import (BertConfig,
                                                  BertForPretraining,
                                                  BertModel, ErnieMoEConfig,
                                                  ErnieMoEForCausalLM,
                                                  LlamaConfig,
                                                  LlamaForCausalLM,
                                                  ernie_moe_flops_per_token,
                                                  llama_flops_per_token)
        mods = SimpleNamespace(
            LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
            TrainStep=TrainStep, AdamW=AdamW, doc_mask=doc_mask,
            llama_flops_per_token=llama_flops_per_token, train=train,
            ErnieMoEConfig=ErnieMoEConfig,
            ErnieMoEForCausalLM=ErnieMoEForCausalLM,
            ernie_moe_flops_per_token=ernie_moe_flops_per_token,
            CrossEntropyLoss=CrossEntropyLoss, Engine=Engine,
            SamplingParams=SamplingParams, monitor=monitor,
            moe_profile=moe_profile, enc=enc, BertConfig=BertConfig,
            BertModel=BertModel, BertForPretraining=BertForPretraining,
            BatchEncoder=BatchEncoder, fa=fa, fad=fad, optimizer=optimizer,
            GradScaler=GradScaler)
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    # Inductor's and Triton's caches (phase 27) in build/, which git ignores
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    # a reference states its float32 matmul precision: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}",
          flush=True)

    # 2. build (parallel nvcc) and load (each library runs its probe)
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    for name, log in build.build_logs.items():
        (OUT_DIR / f"nvcc_{name}.log").write_text(log)
    for name in build.SOURCES:
        build.load(name)
    print(f"build: {sorted(build.SOURCES)} in {build_s:.1f} s, probes ok",
          flush=True)
    host_at_start = host_probes(torch)   # phase 27 compares its own
    # phase 27's compiles, warmed beside phases 3-26 in a process of its own
    warm = start_static_warm()

    def reset_counts():
        build.probe.launches = 0
        fa.probe_minor64.launches = 0
        pa.paged_decode.launches = 0
        fa.flash_fwd.launches = 0
        fa.flash_bwd.launches_dq = fa.flash_bwd.launches_dkv = 0
        moe.grouped_ffn_fwd.launches = 0
        moe.grouped_ffn_bwd.launches_dx = moe.grouped_ffn_bwd.launches_dw = 0
        fad.fused_adam_launch.launches = 0
        monitor.reset()

    def launches_of():
        return {"probe": build.probe.launches,
                "probe_minor64": fa.probe_minor64.launches,
                "paged_decode": pa.paged_decode.launches,
                "flash_fwd": fa.flash_fwd.launches,
                "flash_bwd_dq": fa.flash_bwd.launches_dq,
                "flash_bwd_dkv": fa.flash_bwd.launches_dkv,
                "grouped_ffn_fwd": moe.grouped_ffn_fwd.launches,
                "grouped_ffn_bwd_dx": moe.grouped_ffn_bwd.launches_dx,
                "grouped_ffn_bwd_dw": moe.grouped_ffn_bwd.launches_dw,
                "fused_adam": fad.fused_adam_launch.launches}

    # 3. kernels against their plain versions
    print("kernels vs plain versions:", flush=True)
    probe_cases = check_probe(torch, build)
    paged_cases = check_paged(torch, pa, kv_quantize_arrays)
    flash_cases = check_flash(torch, fa)
    flash_sass = check_flash_wgmma_sass(build, "flash_fwd")
    flash_bwd_sass = check_flash_wgmma_sass(build, "flash_bwd")
    train_cases = check_flash_train(torch, fa, doc_mask)
    # 3b. the fused Adam / AdamW update against the plain rule
    adam_cases = check_fused_adam(torch, mods, fad)

    # 4. + 5. the main path: counts to 0 just before, read just after
    build.probe.launches = 0
    pa.paged_decode.launches = 0
    fa.flash_fwd.launches = 0
    monitor.reset()
    cfg = LlamaConfig(**MODEL)
    model = LlamaForCausalLM(cfg, seed=0)
    model.eval()
    ids = torch.randint(0, cfg.vocab_size, (2, 1024),
                        generator=torch.Generator(device="cuda").manual_seed(2),
                        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    flash_fwd_launches = fa.flash_fwd.launches
    if tuple(logits.shape) != (2, 1024, cfg.vocab_size):
        fail(f"forward logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("forward logits are not finite")
    if flash_fwd_launches != cfg.num_hidden_layers:
        fail(f"flash kernel launched {flash_fwd_launches} times in the "
             f"forward, expected {cfg.num_hidden_layers}")
    del logits
    print(f"forward: [2, 1024] in {fwd_s * 1e3:.1f} ms (first call), "
          f"{flash_fwd_launches} flash launches", flush=True)

    eng = Engine(model, max_slots=16, page_size=128, prefill_bucket=64,
                 max_context=PROMPT_HI + NEW_TOKENS, cache_dtype="bfloat16")
    reqs = make_requests(SamplingParams, cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"probe": build.probe.launches,
                "paged_decode": pa.paged_decode.launches,
                "flash_fwd": fa.flash_fwd.launches}
    counters = {k: v for k, v in monitor.snapshot().items()
                if k.startswith(("kernels.", "serving."))}
    # -- end of the counted main path --
    bad = [o for o in outs if not o.ok or len(o.token_ids) != NEW_TOKENS]
    if len(outs) != N_REQUESTS or bad:
        fail(f"serving: {len(outs)} outputs, failed/short: {bad[:2]}")
    ticks = eng.decode_ticks
    if launches["paged_decode"] != ticks * cfg.num_hidden_layers:
        fail(f"paged-decode launches {launches['paged_decode']} != "
             f"{ticks} ticks x {cfg.num_hidden_layers} layers")
    if counters.get("kernels.decode.paged_cuda") != launches["paged_decode"] \
            or counters.get("kernels.flash.fwd_cuda") != \
            launches["flash_fwd"] or counters.get(
                "kernels.decode.paged_plain", 0) or counters.get(
                "kernels.flash.fwd_plain", 0):
        fail(f"kernel-path counters disagree with launches: {counters}")
    if launches["probe"] < 1:
        fail("the engine did not run the kernel probe")
    serving_routes = check_f32_routes(counters, launches["flash_fwd"],
                                      "serving")
    decode_routes = check_paged_split(counters, launches["paged_decode"],
                                      "serving")
    if eng.leaked_pages():
        fail(f"{eng.leaked_pages()} pages leaked")
    n_tok = sum(len(o.token_ids) for o in outs)
    tok_s = n_tok / serve_s
    print(f"serving: {N_REQUESTS} requests, {n_tok} tokens, {ticks} decode "
          f"ticks, {counters.get('serving.preemptions', 0)} preemptions in "
          f"{serve_s:.2f} s = {tok_s:.1f} tok/s on {card}", flush=True)

    # 6. cross-check two greedy requests against the no-cache forward
    greedy = [i for i, (_, sp) in enumerate(reqs) if sp.temperature == 0][:2]
    f32_eng = Engine(model, max_slots=2, page_size=128, prefill_bucket=64,
                     max_context=PROMPT_HI + NEW_TOKENS,
                     cache_dtype="float32")
    f32_outs = f32_eng.run([reqs[i] for i in greedy])
    agree = {"bf16_pool": [], "f32_pool": []}
    for i, fo in zip(greedy, f32_outs):
        prompt = reqs[i][0]
        agree["bf16_pool"].append(teacher_forced_agreement(
            torch, model, prompt, outs[i].token_ids))
        agree["f32_pool"].append(teacher_forced_agreement(
            torch, model, prompt, fo.token_ids))
    print(f"cross-check (teacher-forced no-cache argmax agreement): "
          f"{agree} (thresholds f32 {AGREE_F32}, bf16 {AGREE_BF16})",
          flush=True)
    if min(agree["f32_pool"]) < AGREE_F32 or \
            min(agree["bf16_pool"]) < AGREE_BF16:
        fail(f"cross-check below threshold: {agree}")
    del eng, f32_eng
    torch.cuda.empty_cache()

    # 6b. the serving accelerators, each run counted on its own
    accel, accel_paths, clean8 = serving_accelerators(
        torch, mods, model, launches_of, reset_counts, card)
    # 6c. the reliability plane at the serving shapes, each part counted
    rel, rel_paths = serving_reliability(
        torch, mods, model, clean8, accel["multi_tick_1"]["step_ms_median"],
        launches_of, reset_counts, card)
    accel.update(rel)
    accel_paths.update(rel_paths)
    del clean8
    # 6d. one-shot decoding (generate, beam_search), each run counted
    one_shot, one_shot_paths = one_shot_decoding(
        torch, mods, model, accel, launches_of, reset_counts, card)
    # its counted runs join the registry the kernel line reads launches from
    accel.update({p: r for p, r in one_shot.items() if p in one_shot_paths})
    accel_paths.update(one_shot_paths)
    torch.cuda.empty_cache()
    # the serving phase's model and engines go before training's
    del model, outs, f32_outs
    torch.cuda.empty_cache()

    # 8. the model on the card against the CPU, at small depth; 8b. the
    # dynamic loss scale on the card against the CPU
    xcheck = model_cross_check(torch, mods)
    scaler = grad_scaler_check(torch, mods)

    # 9. + 10. the training main path: counts to 0 just before, read after
    training = train_main_path(torch, mods, fa, monitor, card)
    torch.cuda.empty_cache()
    # 9b. the pretraining recipe under each recompute granularity
    recipe = pretrain_recipe_path(torch, mods, fa, fad, monitor, card)

    # 11. the MoE kernels against their plain versions
    print("MoE kernels vs plain versions:", flush=True)
    moe_sass = check_moe_tc_sass(build)
    moe_cases = check_moe_kernels(torch, moe, moe_gate, monitor)

    # 12. the MoE serving main path, 13. the MoE cross-check, 14. the MoE
    # training main path (12 and 14 count their launches around them)
    moe_serving = moe_serving_main_path(torch, mods, launches_of,
                                        reset_counts, card)
    torch.cuda.empty_cache()
    moe_spec, moe_spec_paths = moe_spec_path(torch, mods, launches_of,
                                             reset_counts, card)
    accel.update(moe_spec)
    accel_paths.update(moe_spec_paths)
    torch.cuda.empty_cache()
    moe_xcheck = moe_cross_check(torch, mods)
    moe_training = moe_train_main_path(torch, mods, launches_of,
                                       reset_counts, card)
    torch.cuda.empty_cache()

    # 15. the head-dim-64 probe and the flash kernels at the encoder's
    # shapes, 16. the encoder serving main path, 17. the BERT cross-check,
    # 18. the BERT training main path (16 and 18 count around them)
    print("encoder kernels vs plain versions:", flush=True)
    minor64_cases = check_minor64_probe(torch, fa)
    enc_flash_cases = check_flash_encoder(torch, fa, F)
    bert_train_cases = check_flash_train(torch, fa, doc_mask,
                                         BERT_TRAIN_SPECS)
    torch.cuda.empty_cache()
    enc_serving = encoder_serving_main_path(torch, mods, launches_of,
                                            reset_counts, card)
    bert_xcheck = bert_cross_check(torch, mods)
    bert_training = bert_train_main_path(torch, mods, launches_of,
                                         reset_counts, card)
    torch.cuda.empty_cache()

    # 19. the eager dygraph surface: the card against the CPU, then its
    # training main path (counts around it)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import profile_eager as ep
    from paddle_tpu_torch.core import dispatch
    eager_xcheck = eager_cross_check(torch, paddle, ep)
    eager = eager_train_main_path(torch, paddle, ep, dispatch, launches_of,
                                  reset_counts, card)
    torch.cuda.empty_cache()

    # 20. the replay tool on the card (each run a subprocess whose counts
    # start at 0 and come back in its report) and request migration
    # (counted around it); 21. the new eager modules against the CPU
    replay = replay_main_path(torch, mods, launches_of, reset_counts, card)
    surface = eager_new_surface(torch, card)

    # 22. paddle.Model on the card (the card against the CPU, then the
    # counted path) and the jit.save predictor (counted around one run)
    hapi_xcheck = hapi_cross_check(torch, paddle, ep)
    hapi = hapi_main_path(torch, paddle, ep, launches_of, reset_counts, card)
    predictor = predictor_main_path(torch, mods, launches_of, reset_counts,
                                    card)

    # 23. weight-only int8 / int4 serving at phase 4's widths (each run
    # counted on its own), generate on the int8 model, llm_int8_linear and
    # the fused ops against the CPU
    quant, quant_paths = quant_main_path(torch, paddle, mods, launches_of,
                                         reset_counts, card)

    # 24. the profiler and debugging surface: phase 19's loop profiled
    # (counts around it), amp.debugging, then device and utils
    prof_run = profiler_main_path(torch, paddle, ep, dispatch, launches_of,
                                  reset_counts, card)
    debugging = debugging_check(torch, paddle, ep, card)
    device_utils = device_utils_check(torch, paddle, card)

    # 25. paddle.vision: ResNet-50 card vs CPU, served, trained (counts
    # around each path), the detection ops at their detectors' sizes and
    # the zoo against the CPU
    vision = vision_main_path(torch, launches_of, reset_counts, card)

    # 26. fft / signal / audio, text.viterbi, geometric, sparse and
    # distribution: BERT-CRF tagging (counts around each served batch),
    # the Whisper log-mel front end, the Cora check, ogbn-arxiv GCN
    # training on both aggregation routes (counts around each), GraphSAGE
    # sampling, distributions and SECOND's first sparse convolution
    signal = signal_graph_main_path(torch, mods, launches_of, reset_counts,
                                    card)

    # 27. jit.to_static, static and onnx: the card against the CPU through
    # to_static, BERT-base trained (counts around the counted steps) and
    # served (counts around one batch each) through it, static.nn control
    # flow with the graph-break negative control, the ONNX export
    static = to_static_main_path(torch, mods, launches_of, reset_counts,
                                 card, host_at_start, warm)

    # 28. collective training: one rank under NCCL through fleet and
    # DistributedTrainStep (counts around its steps), two ranks sharing
    # the card under gloo at mp=2 and at dp=2 with ZeRO-1 (each rank's
    # counts around its steps), the f32 gate and its negative control
    distributed = dist_main_path(torch, mods, launches_of, reset_counts,
                                 card)

    # 29. pipeline parallelism and ZeRO-3: two pp ranks sharing the card
    # (the f32 gate in every schedule, then phase 9's LLaMA at pp=2, each
    # rank's counts around its steps), the MPMD modes in this process
    # (counts around each train_batch), two dp ranks at ZeRO-3 (each
    # rank's counts around its steps)
    pipe = pipe_main_path(torch, mods, launches_of, reset_counts, card,
                          distributed)

    # 30. sequence, segment and expert parallelism: two ranks sharing the
    # card (sep=2: the ring's f32 gate and MpmdRingExecutor, phase 9's
    # LLaMA through SegmentParallel; mp=2 + sequence_parallel; ep=2
    # ERNIE-MoE), each rank's counts around its steps
    seq = seq_main_path(torch, mods, launches_of, reset_counts, card,
                        distributed)

    # 31. disaggregated and fleet serving of phase 20's LLaMA: the
    # DisaggEngine with a decode worker killed, the two-replica fleet with
    # migrations and a replica killed (counts around each), and the replay
    # tool's --disagg with --kill-worker (a subprocess)
    disagg = disagg_main_path(torch, mods, launches_of, reset_counts, card,
                              replay)

    src = "paddle_tpu_torch/csrc/"

    def replay_by_path(kernel):
        """Phase 20's launches of ``kernel``: each replay subprocess's
        report and the migration's count."""
        return {f"replay_{w}": r["launches"][kernel]
                for w, r in replay.items() if r["launches"][kernel]}

    def accel_by_path(kernel):
        return {p: l[kernel] for p, l in accel_paths.items()}

    def disagg_by_path(kernel):
        """Phase 31's launches of ``kernel``: (a), (b) and (c)'s report."""
        return {"disagg_a": disagg["a"]["launches"][kernel],
                "fleet_b": disagg["b"]["launches"][kernel],
                "replay_disagg_c": disagg["c"]["launches"][kernel]}

    def quant_by_path(kernel):
        """Phase 23's launches of ``kernel``, by counted run."""
        return {p: l[kernel] for p, l in quant_paths.items()}

    def moe_accel(route):
        return {p: r["grouped_ffn_routes"][route] for p, r in accel.items()
                if "grouped_ffn_routes" in r}

    main_paged = paged_cases[0]
    moe_paged = next(c for c in paged_cases if c["geometry"] == "ernie_moe")
    main_flash = flash_cases[0]
    main_train = train_cases[0]
    bt_case = bert_train_cases[0]
    all_train = train_cases + bert_train_cases
    ms_l = moe_serving["launches"]
    es_l, bt_l = enc_serving["launches"], bert_training["launches"]
    # launches by route: the bf16 training paths run the tc kernels, the
    # f32 serving paths the tf32x3 forward (their counter snapshots)
    # phase 23's counted runs, by the names of quant_paths
    quant_runs = {(p if p.startswith("quant_") else f"quant_serving_{p}"):
                  r for p, r in quant.items()
                  if isinstance(r, dict) and "counters" in r}
    # phase 28's counted runs: (a) in this process, each rank of (b), (c)
    dist_runs = {"dist_nccl": distributed["a"],
                 **{f"dist_mp2_rank{r['rank']}": r["run"]
                    for r in distributed["b"]["ranks"]},
                 **{f"dist_zero1_rank{r['rank']}": r["run"]
                    for r in distributed["c"]["ranks"]},
                 # phase 29's bf16 counted runs: (a) each pp rank, (d)
                 # each ZeRO-3 rank
                 **{f"pipe_pp2_rank{r['rank']}": r["run"]
                    for r in pipe["p"]["ranks"]},
                 **{f"pipe_zero3_rank{r['rank']}": r["zero3"]
                    for r in pipe["p"]["ranks"]},
                 # phase 30's bf16 counted runs: each rank at sep=2 (the
                 # ring: no flash launch), mp=2 + SP and ep=2 ERNIE-MoE
                 **{f"seq_{name}_rank{r['rank']}": r[part]
                    for part, name in (("b", "sep2"), ("c", "sp_mp2"),
                                       ("d", "ep2"))
                    for r in seq["s"]["ranks"]}}
    # phase 29 (c)'s f32 counted runs (the MPMD modes in this process)
    pipe_f32 = {f"pipe_{m.lower()}": pipe["mpmd"][m]
                for m in PIPE_MPMD_MODES}
    tc_paths = {"training": training, "moe_training": moe_training,
                "bert_training": bert_training, "eager_training": eager,
                **{f"recipe_{g}": r for g, r in recipe["runs"].items()},
                "hapi": hapi, **quant_runs, "profiler": prof_run,
                "bert_crf_bf16": signal["crf"]["bf16"],
                "static_training": static["training"],
                "static_serving_bf16": static["serving"]["bf16"],
                **dist_runs}
    f32_paths = {"serving": dict(counters=counters),
                 "encoder_serving": enc_serving,
                 "one_shot_padded": one_shot["one_shot_padded"],
                 "replay_embedding": replay["embedding"],
                 "replay_embedding_fixture": replay["embedding_fixture"],
                 "hapi": hapi, "predictor": predictor,
                 "bert_crf_f32": signal["crf"]["f32"],
                 "static_serving_f32": static["serving"]["f32"],
                 **pipe_f32}

    # phase 27's counted runs (the probe ran in an earlier phase: 0 here)
    static_runs = {"static_training": static["training"],
                   **{f"static_serving_{w}": static["serving"][w]
                      for w in ("f32", "bf16")}}

    def by_path(paths, route):
        return {p: flash_routes(r["counters"])[route]
                for p, r in paths.items()}

    def flash_case(c, part, outs):
        return dict(case=c["case"], route=c["route"][part],
                    kernel=c["fwd_kernel"] if part == "fwd"
                    else c["bwd_kernel"][part],
                    max_abs_err=max(c["max_abs_err"][n] for n in outs),
                    ratio=max(c["ratio"][n] for n in outs), **c[part])

    def first_on(cases, route, part=None):
        return next(c for c in cases
                    if (c["route"] if part is None else c["route"][part])
                    == route)

    fwd_tc = by_path(tc_paths, "fwd_cuda_tc")
    fwd_wgmma = by_path(tc_paths, "fwd_cuda_tc_wgmma")
    fwd_tf32 = by_path(f32_paths, "fwd_cuda_tf32x3")
    fwd_simt = by_path({**tc_paths, **f32_paths}, "fwd_cuda_simt")
    simt_flash = first_on(flash_cases, "simt")
    main_numbers = ("max_abs_err", "tol", "ratio", "ms", "plain_ms",
                    "bound_ms", "bound_by", "bound_peak", "library_ms")
    kernels = [
        dict(name="probe", route="cuda", source=src + "common.cuh",
             replaces="paddle_tpu/kernels/flash_attention.py:105",
             launches=launches["probe"] + ms_l["probe"] + sum(
                 accel_by_path("probe").values()) + sum(
                 replay_by_path("probe").values()) + sum(
                 disagg_by_path("probe").values()),
             launches_by_path={"serving": launches["probe"],
                               "moe_serving": ms_l["probe"],
                               **accel_by_path("probe"),
                               **replay_by_path("probe"),
                               **disagg_by_path("probe")},
             cases=probe_cases,
             **{k: probe_cases[0][k] for k in (
                 "max_abs_err", "tol", "ratio", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms")}),
        dict(name="paged_decode", route="cuda",
             kernels=["paged_decode_split", "paged_decode_combine"],
             source=src + "paged_decode.cu",
             replaces="paddle_tpu/kernels/paged_attention.py:278",
             launches=launches["paged_decode"] + ms_l["paged_decode"] + sum(
                 accel_by_path("paged_decode").values()) + sum(
                 replay_by_path("paged_decode").values()) + sum(
                 quant_by_path("paged_decode").values()) + sum(
                 disagg_by_path("paged_decode").values()),
             launches_by_path={"serving": launches["paged_decode"],
                               "moe_serving": ms_l["paged_decode"],
                               **accel_by_path("paged_decode"),
                               **replay_by_path("paged_decode"),
                               **quant_by_path("paged_decode"),
                               **disagg_by_path("paged_decode")},
             launches_split={"serving": decode_routes["split"],
                             "moe_serving": moe_serving[
                                 "paged_decode_routes"]["split"],
                             **{p: int(r["counters"].get(
                                 "kernels.decode.paged_cuda_split", 0))
                                for p, r in accel.items()},
                             **{f"replay_{w}": int(r["counters"].get(
                                 "kernels.decode.paged_cuda_split", 0))
                                for w, r in replay.items()
                                if "counters" in r},
                             **{p: int(r["counters"].get(
                                 "kernels.decode.paged_cuda_split", 0))
                                for p, r in quant_runs.items()},
                             **{p: disagg[k]["paged_decode_routes"]["split"]
                                for p, k in (("disagg_a", "a"),
                                             ("fleet_b", "b"))},
                             "replay_disagg_c": int(disagg["c"][
                                 "counters"].get(
                                 "kernels.decode.paged_cuda_split", 0))},
             moe_serving_case={k: moe_paged[k] for k in (
                 "case", "max_abs_err", "ratio", "wrapper_ratio", "ms",
                 "pool_copies", "wrapper_ms", "plain_ms", "bound_ms",
                 "bound_by", "chunks_launched", "negative_control")},
             note="one call: the split kernel over (chunk of "
                  "DECODE_CHUNK tokens, kv head, slot) and the combine of "
                  "the chunks' partials; ms is their device time from a "
                  "CUDA graph of raw launches cycling through pool_copies "
                  "copies of the pools (more than the L2 between two reads "
                  "of one), wrapper_ms the wrapper's (events around eager "
                  "calls, host included); launches_split counts the calls "
                  "whose C entry reported more than one chunk a slot",
             cases=paged_cases, library_ms=None,
             **{k: main_paged[k] for k in (
                 "max_abs_err", "tol", "ratio", "wrapper_ratio", "ms",
                 "pool_copies", "wrapper_ms", "plain_ms", "bound_ms",
                 "bound_by", "chunk", "chunks_launched",
                 "negative_control")}),
        dict(name="flash_fwd", route="cuda", flash_route="cuda-tc",
             kernel="flash_fwd_wgmma_kernel", source=src + "flash_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:280",
             launches=sum(fwd_tc.values()), launches_by_path=fwd_tc,
             launches_wgmma=sum(fwd_wgmma.values()), sass=flash_sass,
             note="the tc route's forward: at head dims up to 128 the "
                  "wgmma kernel (wgmma fed by TMA, a producer warp and one "
                  "consumer warpgroup), at larger ones the mma.sync "
                  "kernel; launches_wgmma counts the former, as the C "
                  "entry reports the kernel it ran",
             case=main_train["case"],
             max_abs_err=main_train["max_abs_err"]["out"],
             lse_max_abs_err=main_train["max_abs_err"]["lse"],
             tol=main_train["tol"]["out"],
             ratio=max(main_train["ratio"][n] for n in ("out", "lse")),
             cases=[flash_case(c, "fwd", ("out", "lse")) for c in all_train
                    if c["route"]["fwd"] == "tc"],
             bert_train=flash_case(bt_case, "fwd", ("out", "lse")),
             **main_train["fwd"]),
        dict(name="flash_fwd_tf32x3", route="cuda", flash_route="cuda-tf32x3",
             source=src + "flash_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:280",
             launches=sum(fwd_tf32.values()), launches_by_path=fwd_tf32,
             case=main_flash["case"],
             cases=[c for c in flash_cases if c["route"] == "tf32x3"],
             encoder_cases=enc_flash_cases,
             train_cases=[flash_case(c, "fwd", ("out", "lse"))
                          for c in all_train
                          if c["route"]["fwd"] == "tf32x3"],
             note="bound_ms counts 3 TF32 products per counted operation "
                  "at the 495 TFLOP/s TF32 peak (3xTF32), or the bytes, the "
                  "larger; library_ms is SDPA f32 (timed only)",
             **{k: main_flash[k] for k in main_numbers}),
        dict(name="flash_fwd_simt", route="cuda", flash_route="cuda-simt",
             source=src + "flash_fwd.cu",
             replaces="paddle_tpu/kernels/flash_attention.py:280",
             launches=sum(fwd_simt.values()), launches_by_path=fwd_simt,
             case=simt_flash["case"],
             cases=[c for c in flash_cases if c["route"] == "simt"],
             note="held at a case the tc and tf32x3 routes refuse (rows "
                  "not 16-byte aligned); no main path launches it",
             **{k: simt_flash[k] for k in main_numbers}),
    ]
    for kname, part, line, grads, route in (
            ("flash_bwd_dq", "dq", 452, ("dq",), "tc"),
            ("flash_bwd_dq_simt", "dq", 452, ("dq",), "simt"),
            ("flash_bwd_dkv", "dkv", 521, ("dk", "dv"), "tc")):
        paths = by_path(tc_paths if route == "tc" else
                        {**tc_paths, **pipe_f32}, f"{part}_cuda_{route}")
        wgmma_paths = by_path(tc_paths, f"{part}_cuda_tc_wgmma")
        main = main_train if route == "tc" else \
            first_on(all_train, route, part)
        entry = dict(
            name=kname, route="cuda", flash_route=f"cuda-{route}",
            source=src + "flash_bwd.cu",
            replaces=f"paddle_tpu/kernels/flash_attention.py:{line}",
            launches=sum(paths.values()), launches_by_path=paths,
            case=main["case"],
            max_abs_err=max(main["max_abs_err"][n] for n in grads),
            tol={n: main["tol"][n] for n in grads},
            ratio=max(main["ratio"][n] for n in grads),
            pass_ms=main["pass"]["ms"],
            pass_bound_ms=main["pass"]["bound_ms"],
            note="bound_ms counts this kernel's own function (S and dP "
                 "recomputed in each backward kernel); pass_bound_ms counts "
                 "one backward pass (2.5x the forward's operations); "
                 "plain_ms (flash_bwd_plain) and library_ms (the aten flash "
                 "backward, timed only, null where aten does not take the "
                 "case) each compute the whole pass, dq, dk and dv "
                 "together: compare them with pass_ms",
            cases=[flash_case(c, part, grads) for c in all_train
                   if c["route"][part] == route],
            **main[part])
        if route == "tc":
            entry["bert_train"] = dict(flash_case(bt_case, part, grads),
                                       pass_ms=bt_case["pass"]["ms"])
            mma = next(c for c in all_train
                       if c["bwd_kernel"][part] == "mma_sync")
            entry.update(
                kernel=f"flash_bwd_{part}_wgmma_kernel",
                launches_wgmma=sum(wgmma_paths.values()),
                launches_wgmma_by_path=wgmma_paths,
                mma_sync_kernel=f"flash_bwd_{part}_tc_kernel",
                mma_sync_case=dict(flash_case(mma, part, grads),
                                   pass_ms=mma["pass"]["ms"]),
                sass={k: v for k, v in flash_bwd_sass.items()
                      if k.startswith(part + "_")},
                kernel_note="the tc route runs the wgmma kernel (wgmma fed "
                            "by TMA) at head dims up to 128 and the mma.sync "
                            "kernel above; launches_wgmma counts the former, "
                            "as the C entry reports the kernel it ran; no "
                            "main path runs the latter (head dims 64 and "
                            "128): mma_sync_case holds it against its plain "
                            "version at head dim 256 in phase 7")
            if part == "dq":
                entry["delta_ms"] = main["pass"]["delta_ms"]
                entry["delta_share_of_pass"] = main["pass"]["delta_share"]
        if kname == "flash_bwd_dkv":
            entry["simt_cases"] = [flash_case(c, part, grads)
                                   for c in all_train
                                   if c["route"][part] == "simt"]
        kernels.append(entry)
    kernels.append(dict(
        name="probe_minor64", route="cuda", source=src + "flash_fwd.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:801",
        launches=es_l["probe_minor64"] + sum(
            replay_by_path("probe_minor64").values()) + sum(
            signal["crf"][w]["launches"]["probe_minor64"]
            for w in ("f32", "bf16")) + sum(
            r["launches"]["probe_minor64"] for r in static_runs.values()),
        launches_by_path={"encoder_serving": es_l["probe_minor64"],
                          **replay_by_path("probe_minor64"),
                          **{f"bert_crf_{w}": signal["crf"][w]["launches"][
                              "probe_minor64"] for w in ("f32", "bf16")},
                          **{p: r["launches"]["probe_minor64"]
                             for p, r in static_runs.items()}},
        cases=minor64_cases,
        note="library_ms times the pair of torch.matmul calls (timed only); "
             "the plain version is the same pair",
        **{k: minor64_cases[0][k] for k in (
            "max_abs_err", "tol", "ratio", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}))
    main_moe = moe_cases[0]
    decode_moe = next(c for c in moe_cases if c["case"] == "decode_f32")
    prefill_moe = next(c for c in moe_cases if c["case"] == "prefill_f32")
    mr_s = moe_serving["grouped_ffn_routes"]
    mr_t = moe_training["grouped_ffn_routes"]
    for kname, part, line, outs, route, case, paths in (
            ("grouped_ffn_fwd", "fwd", 181, ("out",), "tc", main_moe,
             {"moe_serving": mr_s["fwd_cuda_tc"],
              "moe_training": mr_t["fwd_cuda_tc"]}),
            ("grouped_ffn_fwd_rows", "fwd", 181, ("out",), "rows",
             decode_moe, {"moe_serving": mr_s["fwd_cuda_rows"],
                          "moe_training": mr_t["fwd_cuda_rows"],
                          **moe_accel("fwd_cuda_rows")}),
            ("grouped_ffn_fwd_simt", "fwd", 181, ("out",), "simt",
             prefill_moe, {"moe_serving": mr_s["fwd_cuda_simt"],
                           "moe_training": mr_t["fwd_cuda_simt"],
                           **moe_accel("fwd_cuda_simt")}),
            ("grouped_ffn_bwd_dx", "dx", 344, ("dx", "dws", "db2", "ha",
                                                "dz"), "tc", main_moe,
             {"moe_training": mr_t["dx_cuda_tc"]}),
            ("grouped_ffn_bwd_dw", "dw", 462, ("dw1", "db1", "dw2"), "tc",
             main_moe, {"moe_training": mr_t["dw_cuda_tc"]}),
            ("grouped_ffn_bwd_dw_simt", "dw", 462, ("dw1", "db1", "dw2"),
             "simt", prefill_moe, {"moe_training": mr_t["dw_cuda_simt"]})):
        kernels.append(dict(
            name=kname, route="cuda", grouped_ffn_route=route,
            source=src + ("grouped_ffn_fwd.cu" if part == "fwd"
                          else "grouped_ffn_bwd.cu"),
            replaces=f"paddle_tpu/kernels/moe.py:{line}",
            launches=sum(paths.values()), launches_by_path=paths,
            case=case["case"],
            max_abs_err=max(case["max_abs_err"][n] for n in outs),
            tol={n: case["tol"][n] for n in outs},
            ratio=max(case["ratio"][n] for n in outs),
            ratio_vs_plain=max(case["ratio_vs_plain"][n] for n in outs
                               if n in case["ratio_vs_plain"]),
            e2e_limit=case["e2e_limit"],
            note="grouped_ffn_route: tc (wgmma on TMA-fed 128 x 128 tiles, "
                 "bf16/fp16 with h and dff multiples of 8; the dw products "
                 "read both operands MN-major), rows (the forward of f32 "
                 "buffers of capacity <= 16: the live experts' weights "
                 "streamed once over (column slab, K split, expert) blocks, "
                 "K-split partials summed by a reduce epilogue) or simt "
                 "(f32 FMA on the CUDA cores: f32, odd widths); an f32 "
                 "forward's ms comes from a CUDA graph of raw launches "
                 "(wrapper_ms: the wrapper); "
                 "bound_ms counts the port's own entry over the live rows: "
                 "forward 2 products (weights of the live experts, x in, "
                 "out written); dx 4 products (z, dh, dz w1^T, ha w2; the "
                 "weights, x and g in, dx written, ha and dz of the live "
                 "rows written for dw); dw 2 products (dw1, dw2; x, g, ha "
                 "and dz of the live rows in, dw1 and dw2 of every expert "
                 "written); library_ms is null (no single PyTorch call "
                 "computes a fused grouped FFN); library_pair_ms times two "
                 "torch.bmm calls over the padded buffer, timed only; "
                 "plain_ms of dx and dw is the whole plain backward; ratio "
                 "is the stage gate, ratio_vs_plain the end-to-end one "
                 "(limit e2e_limit)",
            cases=[dict(case=c["case"], route=c["route"][part], **c[part])
                   for c in moe_cases if c["route"][part] == route],
            rows_split_control=(case["rows_split_control"]
                                if route == "rows" else None),
            sass={k: v for k, v in moe_sass.items()
                  if route == "tc" and k.startswith(part)},
            **case[part]))
    adam_main = adam_cases[0]
    adam_paths = {"training": training["fused_adam_launches"],
                  "moe_training": moe_training["launches"]["fused_adam"],
                  "bert_training": bert_training["launches"]["fused_adam"],
                  "eager_training": eager["fused_adam_launches"],
                  **{f"recipe_{g}": r["launches"]["fused_adam"]
                     for g, r in recipe["runs"].items()},
                  "recipe_flashmask": recipe["runs"]["selective"][
                      "flashmask_step"]["launches"]["fused_adam"],
                  "hapi": hapi["launches"]["fused_adam"],
                  "profiler": prof_run["launches"]["fused_adam"],
                  **{f"arxiv_gcn_{r}": signal["arxiv"][r]["launches"][
                      "fused_adam"] for r in ("send_ue_recv",
                                              "sparse_matmul")},
                  "static_training": static["training"]["fused_adam_launches"],
                  **{p: r["launches"]["fused_adam"]
                     for p, r in dist_runs.items()}}
    kernels.append(dict(
        name="fused_adam", route="cuda", source=src + "fused_adam.cu",
        replaces="port-only: no TPU kernel; the per-parameter fusion XLA "
                 "makes of the JAX TrainStep's update, "
                 "paddle_tpu/jit/api.py:508",
        launches=sum(adam_paths.values()), launches_by_path=adam_paths,
        case=adam_main["case"], max_abs_err=adam_main["max_abs_err"],
        tol="bit-equal (torch.equal on every parameter and state slot)",
        ms=adam_main["ms"], wrapper_ms=adam_main["wrapper_ms"],
        plain_ms=adam_main["plain_ms"],
        bound_ms=adam_main["bound_ms"], bound_by=adam_main["bound_by"],
        library_ms=adam_main["library_ms"],
        library_note=adam_main["library_note"],
        negative_control=adam_main["negative_control"],
        note="one launch updates every f32 parameter of a step (a chunk "
             "table drives the blocks; 16-byte vectors, a scalar tail), a "
             "second advances the beta powers; bound_ms counts 20 bytes a "
             "parameter with bf16 moments (f32 parameter read and written, "
             "f32 gradient read, two bf16 moments read and written); ms on "
             "a cold L2, the launch on tables built once; wrapper_ms the "
             "wrapper with its checks and table upload; plain_ms the "
             "per-tensor rule",
        cases=adam_cases))
    for k in kernels:                 # also under these two names
        k["kernel_ms"], k["max_err"] = k["ms"], k["max_abs_err"]
    result = dict(card=card, kind=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  forward_ms_first_call=fwd_s * 1e3,
                  serving=dict(requests=N_REQUESTS, tokens=n_tok,
                               seconds=serve_s, tokens_per_s=tok_s,
                               decode_ticks=ticks,
                               preemptions=counters.get(
                                   "serving.preemptions", 0),
                               flash_routes=serving_routes,
                               paged_decode_routes=decode_routes),
                  counters=counters, agreement=agree,
                  serving_accelerators=accel,
                  flash_train_cases=train_cases, model_cross_check=xcheck,
                  training=training, moe_kernel_cases=moe_cases,
                  moe_tc_sass=moe_sass, flash_wgmma_sass=flash_sass,
                  flash_bwd_wgmma_sass=flash_bwd_sass,
                  moe_serving=moe_serving, moe_cross_check=moe_xcheck,
                  moe_training=moe_training, minor64_cases=minor64_cases,
                  encoder_flash_cases=enc_flash_cases,
                  bert_flash_train_cases=bert_train_cases,
                  encoder_serving=enc_serving, bert_cross_check=bert_xcheck,
                  bert_training=bert_training, fused_adam_cases=adam_cases,
                  grad_scaler=scaler, pretrain_recipe=recipe,
                  one_shot_decoding=one_shot,
                  eager_cross_check=eager_xcheck, eager_training=eager,
                  replay=replay, eager_new_surface=surface,
                  hapi_cross_check=hapi_xcheck, hapi=hapi,
                  predictor=predictor, quantized_serving=quant,
                  profiler=prof_run, debugging=debugging,
                  device_utils=device_utils, vision=vision,
                  signal_graph_distribution=signal, to_static=static,
                  distributed=distributed, pipeline=pipe,
                  sequence_parallel=seq, disaggregated_serving=disagg,
                  kernels=kernels)
    (OUT_DIR / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--static-warm"]:
        static_warm_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--dist-fault"]:
        dist_fault_main()
    elif sys.argv[1:2] == ["--pipe-fault"]:
        pipe_fault_main()
    elif sys.argv[1:2] == ["--sep-fault"]:
        sep_fault_main()
    elif sys.argv[1:2] == ["--disagg-fault"]:
        disagg_fault_main()
    else:
        main()
