"""Drive the PyTorch/CUDA port's serving, training, encoder-training and
distributed paths on one NVIDIA Hopper card.

    python3 chip_smoke.py

Twenty-seven phases in one process (phases 17 to 20 and 23 also spawn
two processes each, phase 21 eight, two and four, phase 26 one, phase 27
eight, four, three and four); any failure raises and exits non-zero,
and
only a run in which every phase passed prints the final line:

1. device: name, capability (must be 9.0), versions, power limit;
2. build: compile every kernel under ``paddle_tpu_torch/ops/cuda/csrc``
   with nvcc (one process per part of each source) and print ptxas's
   registers, shared memory and spills;
3. kernels at full width: each paged-attention kernel against its plain
   PyTorch version on the card (tolerance below), then timed beside the
   plain version, one library call and the byte bound at the served
   decode geometry and at a long-context shape (2048 positions);
4. serve: the 0.44B Llama (bf16, random weights from a seed) through
   ``ServingEngine`` with default settings on a seeded 16-request trace
   (a shared system prompt, so the prefix cache hits), once with bf16
   KV pools, once with int8 pools and once with int8 weights over bf16
   pools. Each engine captures its three phase programs as CUDA graphs
   in ``warmup()`` (exactly 3 captures), then serves with one replay
   per prefill chunk and per round; every request must finish, and each
   kernel's launch count over its run must equal layers x decode rounds
   (> 0). Prints tokens/s, ms per decode and per verify round, prefill
   ms per request, the replays and the capture time; then reads one
   decode replay under ``torch.profiler``, where each paged kernel's
   split and merge launches must appear once per layer;
5. token identity: a float32 tiny engine (on graphs) under preemption
   pressure must emit exactly the tokens of the port's own greedy
   ``generate()``, with bf16-width pools and with int8 pools; on a tiny
   fp32 model copied from the CPU, left-padded and int8-weight
   ``generate()`` must give the CPU's tokens; sampling with one seed
   twice must repeat itself, and ``top_k=1`` must give the greedy
   tokens;
6. flash kernels at full width: the forward, dQ (through both entries:
   given delta, and computing delta itself, whose delta is held too) and
   dK/dV kernels each against its plain PyTorch version on the card,
   output tile by output tile (causal, sliding window, GQA, sq < sk,
   non-causal, d 64, ragged 1000), then timed at the headline shape
   beside the plain version, ``F.scaled_dot_product_attention`` and the
   bound, dQ as the Llama step runs it (computing delta);
7. train: the 0.44B Llama (bf16, random weights from a seed) through
   ``TrainStep`` (one CUDA graph a step) with ``AdamW(1e-4,
   multi_precision=True)`` on one b8 x s1024 batch; the loss must start
   near ln(vocab), stay finite and fall, and each flash kernel must
   launch layers x steps times; one eager step is split into forward,
   backward and optimizer by CUDA events;
8. train identity: a float32 tiny model trained 10 AdamW steps with
   global-norm clipping on the card (kernels) and on the CPU (plain
   versions) from the same weights must agree step by step;
9. encoder kernels at full width: the head-batched kernels (4-6; dQ
   through both entries, given delta and computing it, whose delta is
   held too) and the key-mask and dropout variants of kernels 1-3, each
   against its plain version on the card, output tile by output tile and
   dmask row by row (BERT-base's b64 s512 h12 d64 bf16 with a key mask
   from seeded lengths and dropout 0.1; the same with dropout only; a
   window, GQA, sq < sk, an fp32 case, and batch rows of 0, 64, 100 and
   300 keys, non-causal and causal, for the skip of wholly padded key
   tiles), then timed at BERT's shape beside the plain version,
   ``F.scaled_dot_product_attention`` with the same mask and dropout, and
   the bound (padding keys not counted), dQ as the BERT step runs it
   (computing delta), with the same kernels on the dropout-only call
   beside (the skip shows as the difference); and, with dropout 0.1 and
   no mask, the ERNIE-proxy attention (b4 s1024 h12 d128 bf16,
   bidirectional and causal: kernel 6 on its mma.sync dK/dV) and phase
   12's own calls (the 10B trunk's b4 s1024 h64 d64 in both passes, the
   NLG branch's h12 causal), held the same way, the proxy's and the
   trunk's timed beside SDPA and the bound;
10. BERT-base MLM train: ``BertForMaskedLM`` at full width (bf16 O2
   through ``amp.decorate``, dropout 0.1, random weights from a seed)
   through ``TrainStep`` with ``AdamW(1e-4, multi_precision=True)`` on
   one padded b64 x s512 batch; the loss must start near ln(vocab), stay
   finite and fall, each head-batched kernel must launch layers x steps
   times and kernels 1-3 not at all;
11. encoder identity: a float32 tiny BERT trained 10 AdamW steps on the
   card and on the CPU from the same weights, with attention dropout
   0.1 from the same seed words, must agree step by step;
12. ERNIE pretraining: ``ErnieForPretraining`` at the ERNIE-3.0 10B
   widths with the trunk cut from 48 to 8 layers (2.02 B parameters,
   every one bf16, dropout 0.1, random weights from a seed) through
   ``TrainStep`` with ``AdamW(multi_precision=True)`` under
   ``LinearWarmup(PolynomialDecay)`` on ernie_bench.py's b4 x s1024
   batch; the loss must start near 2 ln(vocab), stay finite and fall,
   each head-batched kernel must launch (2 x trunk + 2 x task layers) x
   steps times (the trunk runs twice, NLU bidirectional and NLG causal)
   and kernels 1-3 not at all. Prints ms a step, tokens/s, MFU, the
   forward/backward/optimizer split and peak memory, then two steps of
   ``Lamb(multi_precision=True)`` over the same parameters with its
   optimizer ms beside AdamW's;
13. ERNIE identity: a float32 tiny ERNIE trained 10 ``Lamb`` steps under
   ``LinearWarmup(CosineAnnealingDecay)`` on the card and on the CPU
   (padded batches, attention dropout 0.1 from the same seed words) must
   agree step by step; 5 steps, ``state_dict`` into a fresh model,
   optimizer and scheduler, then 5 more must equal the 10 uninterrupted
   steps bit for bit on the card; ``ErnieForSequenceClassification`` in
   eval (kernels 1-3) must give the CPU's logits;
14. train on graphs: bench.py's headline step built as it builds it
   (``TrainStep(..., donate=True)``, bf16 parameters, AdamW with fp32
   masters), 2 warm-up and 5 timed steps eagerly, then the same on CUDA
   graphs from the same weights: ms a step, peak memory,
   ``memory_analysis()``, ``exec_cache.stats()`` (one capture) and 12
   launches of each of kernels 1-3 a replay; the losses must agree
   within 1e-3 relative. A tiny fp32 Llama, 10 steps on graphs against
   10 eager steps (losses 1e-6 relative, parameters 1e-5 of their max;
   the reason is printed). ``ce_chunk_size=4096`` (a ragged tail at
   32000) against plain CE: ms, peak memory, the first loss within
   1e-3. ``AsyncStepper(max_in_flight=2)``: the same losses as
   ``TrainStep``. The headline step on graphs with ``nan_check=True``:
   ms a step and peak against the plain graph's (the cost of checking
   the update's outputs). ``nan_check`` with a weight set to inf: the
   card names the leaf the CPU names, and leaves parameters, states and
   the step count as they were;
15. float16: (a) kernels 1-3 in float16 at phase 6's shape against
   their plain versions (1e-2 per 64-row tile, two calls
   bit-identical), timed as CUDA-graph replays beside SDPA in float16;
   then the headline model with fp32 parameters, 5 steps under
   ``auto_cast(level="O1", dtype="float16")`` through
   ``GradScaler(init_loss_scaling=2**15).minimize`` (the scale after
   each step printed) and 5 under O1 bfloat16 without a scaler: finite
   losses, ms a step, and kernels 1-3 launching 12 times a step; (b)
   BERT-base MLM (phase 10's padded b64 x s512 batch, dropout 0.1, fp32
   parameters) 5 steps under O1 float16 with ``GradScaler(2**15)``, then
   3 under ``amp.decorate`` O2 float16: losses (the first near
   ln(vocab)), the scale, ms a step, peak memory, kernels 4-6 once a
   layer a step and no other kernel; (c) phase 25a's Transformer-base
   under O1 float16 with ``GradScaler(2**15)``, 5 steps: the tile mode
   and the class pass 6 times a step, kernels 4-6 12 times; (d) every
   float16 kernel against its plain version and timed beside it, SDPA
   in float16 and its bound: kernels 4-6 at BERT's shape (key row and
   dropout) and at ERNIE's trunk (dropout, both directions), the
   mma.sync dK/dV at the ERNIE proxy (d 128, dropout), kernels 1-3 at d
   64 (dQ given delta and computing it), the tile mode at 25b's shape
   and kernels 7 and 8 at phase 3's geometry and 2048 slots (each
   element within two float16 ulps of itself, ``fp16_over``);
16. fit and LBFGS: ``hapi.Model(LlamaForCausalLM(headline)).prepare(
   AdamW).fit`` over a seeded ``TensorDataset`` of 40 sequences (batch
   8, ``num_iters=5``, ``log_freq=1``, ``EarlyStopping`` and
   ``ModelCheckpoint`` in a temporary directory): ms between batch ends
   against phase 14's graph step, ``evaluate``, and the checkpoint
   loaded into a fresh model and optimizer equal to the live ones; then
   5 ``LBFGS(line_search_fn="strong_wolfe")`` steps of a tiny fp32
   network on the card against the CPU, within 1e-6;
17. distributed: (a) ``init_parallel_env()`` brings up NCCL at world
   size 1 through a store on a free local port and ``fleet.init`` makes
   every axis group; every collective of ``distributed/collective.py``
   runs on CUDA fp32 and bf16 tensors, over the world and each axis,
   each result checked (``ppermute`` as the identity permutation);
   (b) the headline model through ``fleet.distributed_model`` and
   ``fleet.distributed_optimizer(AdamW(1e-4, multi_precision=True,
   weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0)))`` in
   ``TrainStep`` on CUDA graphs, 2 warm-up and 5 timed steps, whose
   losses must equal the plain model's with the same weights, optimizer
   and clip bit for bit (run first in the phase, before the process
   group), with 12 launches of each of kernels 1-3 a replay; ms a step
   and peak beside phase 7's; (c) two spawned processes sharing the card
   over gloo, each building its mp 2 shards of the same model from the
   global weights through ``load_jax_weights`` and taking 3 eager AdamW
   steps on the same batch: each step's loss within 2e-2 of (b)'s, the
   same on both ranks, 6 heads a rank and 36 launches of each of
   kernels 1-3 a rank (gloo stages CUDA tensors through the host, so
   the times it prints are no tensor-parallel speed);
18. pipeline: (a) ``LlamaForCausalLMPipe`` at pp 1 (``fleet.init`` on
   NCCL at world size 1), loaded with the plain model's weights through
   the canonical state (``to_pipe_layout``), in ``TrainStep`` on CUDA
   graphs with 17b's optimizer and clip: its losses equal the plain
   step's bit for bit, 12 launches of each of kernels 1-3 a replay;
   (b) pp 2 at full width and depth, two spawned ranks sharing the card
   over gloo (embedding and layers 0-5; layers 6-11, norm, head and
   loss), 4 microbatches of 2 rows, 3 ``train_batch`` steps under GPipe
   and again under 1F1B: losses within 1e-3 of one card's, the two
   schedules bit-identical, step 1's gradients of 17c's leaves (through
   ``gather_jax_layout`` and ``from_pipe_layout``) within 5e-2 of one
   card's, 6 x 4 x 3 = 72 launches of each of kernels 1-3 a rank; peak
   memory and (host-staged) ms a step a rank and schedule;
   (c) ``ErnieForPretrainingPipe("nlg")`` at the 10B widths, trunk 4 of
   48, dropout 0, bf16, b4 x s1024: pp 2 (two ranks, 2 microbatches, 2
   steps) within 1e-3 of pp 1 on one card, each rank's launches held to
   their formula;
19. context parallelism: (a) the headline model with
   ``context_parallel=True``, ring and then Ulysses, at sep 1 (NCCL,
   world size 1) on CUDA graphs: losses bit-identical to the plain
   step's; (b) sep 2 over gloo, two ranks sharing the card, each with
   512 of the 1024 tokens of all 8 rows, ring then Ulysses, 3 eager
   steps each: losses within 1e-3 of one card's, step 1's gradients
   within 5e-2, kernels 1-3 launched 12 x 3 a rank under Ulysses and
   under the causal ring 12 x 3 on rank 0 (the later block skipped) and
   twice that on rank 1; then the ring's block calls at a rank's shape
   (kernel 1 with and without the causal mask, keeping lse; kernels 2
   and 3 given the global lse and delta) against their plain versions
   (FLASH_REL_TOL per tile) and timed beside them, their bounds and
   SDPA's non-causal calls;
20. experts, ZeRO and the sharded checkpoint: (a) the MoE Llama (the
   headline widths with 8 experts a layer, top-2, capacity factor 1.25,
   aux coefficient 0.01: 1.42 B parameters) on one card with 17b's
   optimizer and clip at b8 x s1024 (T 8192, C 2560), 5 eager steps
   whose updates read device scalars as a captured step's do, then
   TrainStep on CUDA graphs (2 warm-up, 5 timed): the graph's losses
   equal the eager ones bit for bit, one capture, 60 launches of each
   of kernels 1-3; ms a step, peak, the tokens each layer dispatches
   and drops, the aux losses; (b) its experts over dp 2, two ranks
   sharing the card over gloo (4 experts and 4 rows a rank), 3 eager
   steps: step 1's loss within 1e-3 of (a)'s and its gradients within
   5e-2, the later losses within 1e-2 (see MOE_DRIFT_TOL),
   36 launches of each of kernels 1-3 a rank, the bytes the dispatch
   and combine moved, and how many of step 1's tokens the ranks sent to
   another buffer row than one card; kernels 1-3 at a rank's shape (b4)
   against their plain versions (FLASH_REL_TOL per tile). Two witnesses
   of MOE_DRIFT_TOL: ``--fp32-witness`` runs 20b again in fp32, one card
   against the two ranks, and prints the same readings; ``--fault
   experts`` holds rank 1's experts at their first values (a planted
   fault), and the phase must then fail; (c) ZeRO at sharding 2 on
   the dense headline step, two ranks over gloo (4 rows a rank), os_g, p_g_os and os_g
   with offload, 2 eager steps each: losses within 1e-3 of one card's,
   step 1's gradients within 5e-2, each rank's peak and the bytes of
   masters and moments on the card and on the host; offload's peak
   below os_g's by at least 0.9 of the masters' and moments' bytes
   (each parameter's are on the card during its own update only);
   (d) the p_g_os
   ranks save parameters, masters and moments with
   ``save_state_dict(async_save=True)`` and one rank loads them into the
   plain model and optimizer: every tensor's sha1 equals the ranks'
   gathered state's, the next loss within 1e-3 of the ranks'; save and
   load GB/s (parameters only, said so, where the disk has no room);
   (e) four ranks sharing the card over gloo, one spawn: the dense
   headline step (all 12 layers) at mp 2 x sharding 2 under os_g and
   p_g_os (4 rows and 6 heads a rank, 2 eager steps each; each slice
   is a quarter), and (a)'s MoE Llama, its depth cut to 6, at dp 2 x
   sharding 2 with its experts over sharding (4 a rank) under os_g (2
   rows a rank, 2 eager steps): losses and step 1's gradients against
   one card (for the MoE the same depth, eager) as in (c) and (b), each
   rank's masters and moments beside (c)'s, its parameters, peak,
   launches and ms a step; kernels 1-3 at both ranks' shapes against
   their plain versions;
21. the reference's hybrid step (``__graft_entry__.py``'s
   ``dryrun_multichip``): (a) ``LlamaForCausalLMPipe`` at the 0.44B
   widths, depth 2 (1 layer a stage), 8 experts a layer over dp
   (top-2, capacity 1.25), ``sequence_parallel=True`` and the parallel
   CE, at dp 2 x mp 2 x pp 2: eight ranks sharing the card over gloo,
   1F1B over 2 microbatches, 3 AdamW steps on b8 x s1024, against the
   same pipe on one card (its microbatches in turn), in bf16 (the main
   path; every gate call handed one card's expert choices, see
   ``_steer_choices``) and again in fp32 (the gates free): step 1's
   loss within 1e-3 and its gradients (eight leaves, gathered over mp
   and dp) within 5e-2, steps 2-3 within MOE_DRIFT_TOL (the eight ranks
   run both dtypes in one spawn); how many of the
   ranks' own bf16 choices differ from one card's; how many of step 1's
   token choices in layer 1 took another expert or slot than on one
   card (none, in bf16); each rank's launches of kernels 1-3 (1 layer
   x 2 microbatches x 3 steps, none of kernels 4-8), peak, bytes sent
   (``[2, 512, 1536]`` a microbatch) and tokens dispatched a layer;
   kernels 1-3 at a rank's shape against their plain versions; (b)
   ``ErnieForPretraining`` at the 10B widths, trunk 4, bf16, attention
   dropout 0.1 at mp 2 (two ranks, 32 trunk heads each, hashing their
   heads' global coordinates) against one card with the same seed
   words, 2 steps within 1e-3 and step 1's gradients (two attention
   weights, gathered over mp) within 5e-2; with ``--fault dropout`` the
   ranks hash their launches' own heads, and the phase must then fail;
   kernels 4-6 at a rank's 32 heads with
   those coordinates against their plain versions; the ERNIE pipe
   (``nlg``, dropout 0) at pp 2 x mp 2 against pp 1 within 1e-3; (c)
   the pipe with ring attention at pp 2 x sep 2 with the 8 experts
   (all on every rank, the gate global over sep), with Ulysses and with
   SP at pp 2 x mp 2 (no experts), and the MoE ``LlamaForCausalLM`` with
   SP at mp 2, and ``LlamaForCausalLM`` (no experts) with SP and
   context parallelism together at mp 2 x sep 2 (a rank's sequence
   chunk split further over mp; ring and Ulysses over sep on its 6
   heads), one step each, step 1 within 1e-3 of one card, each rank's
   launches held to their formula;
22. the vision path (BASELINE configs 1 and 2): (a) ResNet-50 as
   ``benchmarks/baseline_configs.py`` builds it (1000 classes,
   ``amp.decorate`` O2 bf16, ``Momentum(0.1, 0.9, multi_precision=
   True)``, ``CrossEntropyLoss``, ``TrainStep(donate=True)`` on CUDA
   graphs with ``cudnn.benchmark``) on one seeded b256 x 224 bf16 batch,
   NCHW and then NHWC, 2 warm-up and 10 timed steps each: ms a step,
   imgs/s, MFU by the reference's formula (imgs/s x 3 x 4.1e9 /
   989e12), peak memory, and one replay under the profiler (kernels,
   device ms by kind); the loss must start within 1.0 of ln(1000), stay
   finite and fall (the last five steps' mean below the first),
   ``bn1._mean`` must move at every step and no buffer
   in an eval-mode step; (b) a tiny fp32 ResNet-18 (b4 x 64, 10
   classes), 5 Momentum steps on graphs on the card against the CPU
   from the same weights (losses and the parameters' relative norm
   distance within 1e-4 at every step, the running statistics after
   them: means over their channels' std, variances over their max) and
   against eager on the card (rounding as a replay does, cuDNN
   deterministic: bit for bit); a weight set to inf under ``nan_check`` must leave
   parameters, velocities and running statistics bit-identical; (c)
   config 1's MLP (``tests/test_mnist_e2e.py``) trained eagerly with
   Adam for 3 epochs (loss from above 1.5 to below 0.2, accuracy above
   0.95), and ``LeNet`` through ``hapi.Model.fit`` on graphs with
   ``metric.Accuracy`` (one capture; loss and accuracy better after).
   None of the eight kernels lies on this path: none may launch.
23. the tensor op surface (``paddle_tpu_torch.tensor``): (a) every row
   of the two CPU test tables (the op specs of ``tests/op_specs.py`` in
   the tensor namespace, ``tests/torch_tensor_cases.py``'s ``CASES``
   and the 42 in-place variants) on the card against the port's own CPU
   result from the same numpy inputs, with equal dtypes: integer and
   bool outputs exactly, and float outputs whose values all come from
   the row's inputs (moved or selected: reshape, gather, sort, max,
   ...), fp32 arithmetic within ``TENSOR_REL_TOL`` of each output's
   largest magnitude, linalg through the specs' invariants
   (reconstructions, sorted eigenvalues); ``matmul`` (white) and
   ``exp`` (black) under ``auto_cast`` bf16; no module of JAX or of the
   reference package may have been imported (checked again at the end
   of the run);
   (b) the random ops on the card: one seed gives one draw, moments
   within 6 standard errors, ``draws()`` counts each call; (c) two ranks
   sharing the card over gloo at mp 2 decode the 0.44B Llama (phase 4's
   widths) through ``generate()`` (16 greedy tokens) and
   ``ServingEngine`` (two requests), each from its own shards (6 q and
   6 kv heads a rank), in bf16 and with ``int8_weights`` + ``kv_int8``:
   their tokens must be one card's (the int8 engine's up to a tie that
   one card's logits hold within two bf16 ulps), each engine run must
   launch kernel
   7 (bf16) or 8 (int8) on every rank, once a layer a decode round, and
   its phases must have run eagerly (gloo stages the collectives through
   the host); readings: each rank's decode-weight and pool bytes, its
   peak, and the launches;
   (d) ``BatchNorm1D`` at batch 1 in train mode inside a ``TrainStep``
   graph against the CPU: losses, parameters and running statistics.
   None of the eight kernels may launch in 23a, 23b or 23d.
24. the ``nn.functional`` surface: (a) every spec of ``tests/op_specs.py``
   under ``paddle_tpu.nn.functional`` and every row of
   ``tests/torch_functional_cases.py`` on the card against the port's
   own CPU result, forward and gradient (of ``sum(out * cotangent)``),
   with equal dtypes: ints, bools and moved values exactly, fp32 within
   ``CARD_TOL`` (1e-5) of each output's largest magnitude or a row's
   wider limit (cuDNN's convolutions, the CTC and RNN-T recurrences);
   TF32 off; no module of JAX or of the reference package imported;
   (b) the random functions on the card: one seed one draw, one count a
   call, means within 6 standard errors; (c) ``F.flash_attention`` at
   the Llama training shape (b8 s1024 h12 d128 bf16, causal, no
   dropout: kernels 1-3 once each) and at BERT-base's (b64 s512 h12 d64
   bf16, dropout 0.1: kernels 4-6 once each), its output and gradients
   per 64-row tile against the plain versions at phases 6 and 9's
   tolerances; (d) readings, not held: ms of ``conv2d_transpose``,
   bilinear ``interpolate``, ``grid_sample`` and ``ctc_loss`` at sizes
   users run them;
25. the nn layer surface: (a) Transformer-base (``nn.Transformer``'s own
   widths: d 512, 8 heads, ffn 2048, 6 + 6 layers, dropout 0.1) with
   32000-token source and target embeddings, a Linear head and CE with
   label smoothing 0.1, under ``amp.decorate`` O2 bf16 with ``AdamW``,
   eagerly (dropout draws), on a seeded copy task at b64 x src 256
   (padded to lengths 128-256) x tgt 256, 2 warm-up and 5 timed steps:
   ms a step, tokens/s, peak memory; the decoder's causal mask runs the
   tile mode of kernels 1-3 and the key-padding masks kernels 4-6, each
   exactly once a layer a step (kernels 1-3 outside the tile mode not at
   all); a tiny fp32 copy (attention dropout 0.1 from the same seed
   words) trained 3 steps on the card and on the CPU within
   ``IDENTITY_LOSS_ATOL``; then 32 steps of greedy cached decode through
   ``gen_cache`` (kernel 1 and kernel 4 once a layer a step), its logits
   within ``DECODE_REL_TOL`` of the full causal forward over the decoded
   prefix; (b) the tile mode at the decoder's shape (b64 s256 h8 d64
   bf16, dropout 0.1) on the causal [s, s] mask and on the causal mask
   with a key padding per batch row ([b, 1, s, s]) against its plain
   version (per 64-row tile within ``FLASH_REL_TOL``, dQ given delta
   and computing it, the fused delta per row within 1e-5, dmask per
   (batch, head) within 1e-3, the class table byte for byte), the class
   counts and the share of pairs the backward visits; timed on the
   causal mask as the main path runs it (dQ computing delta and dK/dV,
   each with its class pass, the class pass alone, and the whole
   backward of the autograd Function) beside its plain version, SDPA
   given the same additive mask and dropout, and the bound (the mask's
   bytes once, only live pairs); (c)
   ``nn.LSTM(512, 1024, 2 layers, bidirect)`` forward and backward on
   [64, 256, 512] fp32, timed, and a small one on the card against the
   CPU (1e-4); (d) every case of ``tests/torch_layer_cases.py`` on the
   card against the port's CPU result (outputs, gradients, state);
26. the top-level namespace: (a) a fresh interpreter runs ``import
   paddle_tpu_torch as paddle``, resolves every name of its lazy tables,
   finds each name still to port raising ``AttributeError`` naming its
   ROADMAP item, imports neither JAX nor the reference, and feeds a
   numpy-default dataset (float64 samples, int64 labels) through
   ``paddle.io.DataLoader`` into a float32 ``Linear`` on the card
   (batches float32 and int32); (b) phase 25a's Transformer-base written
   only through top-level names (``paddle.seed``, ``paddle.nn``,
   ``paddle.amp.decorate`` O2 bf16, ``paddle.Model(net).prepare(
   paddle.optimizer.AdamW(grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0)))``
   and ``fit`` over a dataset of int64 ids and Python-int lengths, 2
   warm-up and 5 timed steps: ms a step, and the tile mode and kernels
   4-6 exactly once a layer a step); ``paddle.summary`` (total params
   equal to the sum of the numels) and ``paddle.flops``;
   ``paddle.set_rng_state(paddle.get_rng_state())`` repeating a dropout
   forward bit for bit; ``paddle.device``'s memory readings equal to
   ``torch.cuda``'s; a ``paddle.autograd.PyLayer`` running the decoder's
   causal self-attention on the tile mode (b64 s256 h8 d64 bf16) whose
   backward recomputes under ``paddle.enable_grad()`` and calls
   ``paddle.grad``, per 64-row tile within ``FLASH_REL_TOL`` of the fp32
   plain version (so is the plain autograd call), launching kernel 1 and
   the class pass twice and kernels 2 and 3 once; ``FLAGS_check_nan_inf``
   raising ``FloatingPointError`` on ``paddle.log`` of a negative and on
   ``x / 0``, and a ``TrainStep`` capturing its graph with the flag on;
27. the model-parallel items of A.6: (b) kernels 1-3 at a rank's 1 and
   2 heads (b8 d128 bf16 causal, q, k and v views of one projection
   row) against their plain versions per tile at s1024 and at 27a's
   s1020, and timed at s1024 as in phase 6; kernel 7 at one head over
   its bf16 and fp32 pools and kernel 8 over its int8 pool as in phase
   3; (a) the 0.44B Llama at mp 8 with SP (eight ranks sharing the card
   over gloo, 2, 2, 2, 2, 1, 1, 1, 1 heads), b8 x s1020 (padded to 1024
   for the scatter), ``ce_chunk_size=4096`` over each rank's vocab
   columns, 2 eager AdamW steps with the clip: losses within 1e-3 of one
   card's, step 1's gradients within ``MP8_GRAD_REL_TOL``, kernels 1-3
   launched 12 x 2 a rank; before the steps, ``generate()`` and the
   engine, 16 greedy tokens for 2 prompts of 8, on the bf16 model
   (against one card's tokens, or a first parting that 23c's tie rule
   or the rounding witness of ``MP8_ROUND_RATIO`` holds) and on the
   shards of an fp32 copy of the same weights (fp32 and int8 pools,
   equal to one card's), kernels 7 and 8 launched 12 a decode round on
   every rank; (c) ``LBFGS`` with strong Wolfe at dp 2 x mp 2 (four
   ranks) against one card, losses within 1e-4 and every rank making
   the same closure calls; (d) class-sharded ``margin_cross_entropy``
   on ArcFace's head (85742 classes over 3 ranks) against one card's;
   (e) 20a's MoE Llama at depth 2, mp 2 x sep 2 with SP and ring, its
   experts over (sep, mp), in bf16 with the ranks handed one card's
   expert choices as 21a's bf16 leg is, then in fp32 with the ranks'
   gates choosing for themselves: each leg's step 1 within 1e-3 of one
   card, steps 2-3 within 1e-2, the tokens each rank dispatched and how
   many of its own choices differed.

Kernels and library calls are timed with CUDA events as the median of
5 repetitions, the kernels' and the library's repetitions interleaved
(min-max printed beside it); each repetition replays one CUDA graph of
20 calls, so the reading is the device's time per call and not the
host's (the eager time per call is printed beside it). A port kernel
that cannot be captured fails its phase. The library call is timed on
every SDPA backend that accepts it and the fastest is the yardstick;
SDPA's backward is captured as the ``torch.autograd.grad`` call a user
makes, or, if that capture fails, as its backward node called directly;
with dropout it is captured together with its forward and the
forward's time is subtracted (the line says which). Phases 6 and 9 also
time each whole backward
(delta and the two backward kernels, as the autograd Function runs
them) against SDPA's whole backward.
Prints the card's name and power limit (``nvidia-smi``), then one JSON
line with every kernel's numbers (each with its float16 row and its
float16 launches over phase 15's training steps), then as its last
line
``{"ok": true, "device": {...}}``. Needs no network and no JAX; exits
non-zero without a CUDA device or without the repository beside it.

    python3 chip_smoke.py --phases 6,7

runs phases 1 and 2 and the phases named (for comparing two trees in
one call), and prints neither JSON line.
"""
import argparse
import contextlib
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from paddle_tpu_torch import amp, hapi, io
from paddle_tpu_torch.distributed.shard import gather_global
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.jit import AsyncStepper, TrainStep, exec_cache
from paddle_tpu_torch.models import (
    BertConfig, BertForMaskedLM, ErnieConfig, ErnieForPretraining,
    ErnieForSequenceClassification, LlamaConfig, LlamaForCausalLM,
    gather_jax_layout, generate, load_jax_weights,
)
from paddle_tpu_torch.nn import (
    ClipGradByGlobalNorm, Linear, ParamAttr, initializer,
)
from paddle_tpu_torch.nn.layer.layers import (
    load_jax_weights as load_layer_weights,
)
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import head_flash as hf
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.optimizer import LBFGS, AdamW, Lamb, lr
from paddle_tpu_torch.quantization import quantize_kv
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                  torch.int8: 1979e12, torch.float32: 67e12}
# kernel vs plain version on the same card, bf16 outputs: one bf16
# rounding of an O(1) output is up to 2**-8 ~ 4e-3; the rest is fp32
# summation order (streaming vs one-pass softmax)
BF16_ATOL = 2e-2
# float16 outputs: each element within two float16 ulps of its own
# magnitude (2**-9 of it; each side rounds an fp32 result to float16
# once, so they differ by at most one ulp), elements below 1/64 of the
# largest held as if they were that size (fp32 summation order); a
# kernel that rounded through bf16 (2**-8) would miss it


def fp16_over(got, want):
    """The worst ratio of |got - want| to that per-element limit (<= 1
    passes)."""
    want = want.float()
    w = want.abs()
    lim = 2.0 ** -9 * (w + w.max() / 64)
    return ((got.float() - want).abs() / lim).max().item()

# the repo's headline 0.44B Llama (benchmarks/serving_bench.py)
FULL = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
            num_hidden_layers=12, num_attention_heads=12,
            max_position_embeddings=2048, dtype="bfloat16")
MAX_SEQ_LEN = 512
# decode geometry of ServingConfig's defaults at max_seq_len 512
LANES, BLOCK, M = 8, 16, 32
POS = [0, 37, 100, 200, 255, 300, 450, M * BLOCK - 1]  # lane 0 idle
# a long-context timing shape: the same lanes at up to the 0.44B Llama's
# max_position_embeddings (2048 slots, 8878 visible)
M_LONG = 128
POS_LONG = [0, 300, 700, 1023, 1300, 1600, 1900, M_LONG * BLOCK - 1]


def log(*a):
    print(*a, flush=True)


# -- phase 1 ------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {name} capability {cap} torch {torch.__version__} "
        f"cuda {torch.version.cuda} count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


# -- phase 2 ------------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {len(libs)} libraries in "
        f"{time.perf_counter() - t0:.1f} s: {sorted(libs)}")
    for name in sorted(libs):
        for line in _build.ptxas_report(name):
            log(f"[build] {name}: {line}")


# -- phase 3 ------------------------------------------------------------------

def _pools(nkv, d, layers, gen, quant, m=M, dtype=torch.bfloat16):
    """One ``dtype`` (or int8 + scales) pool per layer, the engine's
    layout, and a scattered block table of ``m`` blocks a lane: lane 0
    idle on null block 0."""
    nblocks = LANES * m + 1
    shape = (layers, nblocks, BLOCK, nkv, d)
    k = torch.randn(shape, device="cuda", generator=gen)
    v = torch.randn(shape, device="cuda", generator=gen)
    tables = (torch.randperm(LANES * m, device="cuda", generator=gen)
              .to(torch.int32).reshape(LANES, m) + 1)
    tables[0] = 0
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return (kq, vq, ks, vs), tables
    return (k.to(dtype), v.to(dtype)), tables


REPS, ITERS = 5, 20


def _time_reps(fns, contexts=None, iters=ITERS, reps=REPS):
    """Time each of ``fns`` ({name: fn(i)}, call i gets i) as ``reps``
    repetitions of ``iters`` calls between two CUDA events, interleaved:
    every function's first repetition, then every function's second, and
    so on (all warmed up first). ``contexts`` maps a name to a context
    manager factory entered around each of its repetitions. Returns
    {name: [ms per call in each repetition]}."""
    contexts = contexts or {}
    for name, fn in fns.items():
        with contexts.get(name, contextlib.nullcontext)():
            for i in range(3):
                fn(i)
    torch.cuda.synchronize()
    out = {name: [] for name in fns}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        for name, fn in fns.items():
            with contexts.get(name, contextlib.nullcontext)():
                t0.record()
                for i in range(iters):
                    fn(i)
                t1.record()
            torch.cuda.synchronize()
            out[name].append(t0.elapsed_time(t1) / iters)
    return out


@functools.cache
def _capture_stream():
    """The side stream every capture runs on. A tensor whose autograd
    graph is replayed inside a capture is made on it too, since autograd
    runs each backward op on its forward op's stream."""
    return torch.cuda.Stream()


def _capture(fn, context):
    """One CUDA graph of ``ITERS`` calls of ``fn`` (after 3 warm-up
    calls), captured on ``_capture_stream()`` inside ``context()``."""
    stream = _capture_stream()
    with context():
        torch.cuda.synchronize()
        with torch.cuda.stream(stream):
            for i in range(3):
                fn(i)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for i in range(ITERS):
                fn(i)
        graph.replay()  # a replay that faults names its graph here
        torch.cuda.synchronize()
    return graph


def _time_graphs(fns, contexts=None, optional=(), fallbacks=None):
    """``_time_reps`` of CUDA graphs: each of ``fns`` ({name: fn(i)}) is
    captured as one graph of ``ITERS`` calls (inside its context from
    ``contexts``, if any), and the graphs' replays are timed in
    interleaved repetitions. A replay runs the calls' kernels back to
    back with no host work between them, so this is the device's time
    per call, where ``_time_reps`` of eager calls measures the host
    instead once the device work is shorter than the host's per call.
    A function whose capture fails fails the phase, unless it is a
    library call named in ``optional``: that one is captured through its
    ``fallbacks`` entry if it has one, else left out (and named).
    Returns ({name: [ms per call in each repetition]}, {name: "" or
    " (fallback)"} for each function timed)."""
    contexts = contexts or {}
    fallbacks = fallbacks or {}
    graphs, how = {}, {}
    for name, fn in fns.items():
        context = contexts.get(name, contextlib.nullcontext)
        for tag, f in (("", fn), (" (fallback)", fallbacks.get(name))):
            if f is None:
                continue
            log(f"[graphs] capturing {name}{tag}")
            try:
                graphs[name] = _capture(f, context)
            except RuntimeError as e:
                if name not in optional:
                    raise AssertionError(f"{name} could not be captured as "
                                         f"a CUDA graph") from e
                log(f"[graphs] {name}{tag} is not capturable: "
                    f"{str(e).splitlines()[0]}")
                continue
            how[name] = tag
            break
        else:
            log(f"[graphs] {name} left out")
    times = _time_reps({n: lambda i, g=g: g.replay()
                        for n, g in graphs.items()}, iters=1)
    return {n: [t / ITERS for t in ts] for n, ts in times.items()}, how


def _med(xs):
    return statistics.median(xs)


def _spread(xs):
    """``median (min-max)`` of one function's repetitions."""
    return f"{_med(xs):.4f} ({min(xs):.4f}-{max(xs):.4f})"


def _time_plain(fn, iters):
    """ms per call of a plain version (one repetition; it is the
    arithmetic's reference, not a yardstick of speed)."""
    return _time_reps({"plain": lambda i: fn()}, iters=iters, reps=1)[
        "plain"][0]


def _sdpa_backends(call):
    """{backend name: factory of its ``sdpa_kernel`` context} for every
    backend of ``F.scaled_dot_product_attention`` that accepts ``call()``
    (each tried once)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]):
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        ok[be.name.lower()] = lambda be=be: sdpa_kernel([be])
    if not ok:
        raise RuntimeError("no SDPA backend accepts the yardstick call")
    return ok


def _library(times, prefix, how=None):
    """The fastest backend's median over the ``prefix[backend]`` entries
    of ``times`` (None if no backend was timed), and a printable list of
    every backend's reading, with ``how`` each was captured."""
    how = how or {}
    rows = {n[len(prefix) + 1:-1]: (xs, how.get(n, ""))
            for n, xs in times.items() if n.startswith(prefix + "[")}
    if not rows:
        return None, "no backend captured"
    best = min(_med(xs) for xs, _ in rows.values())
    return best, ", ".join(f"{n}{tag} {_spread(xs)}"
                           for n, (xs, tag) in rows.items())


def _bound(nkv, g, d, pos, window, kv_dtype, quant):
    """Least time for the work of one call at the lanes' ``pos`` (one
    lane each): the larger of the bytes it must move over the HBM rate
    and its operations over the peak rate for the inputs' type. Bytes: q
    and out (fp32 beside fp32 pools, else 16-bit), pos, the table entries of the blocks that hold
    visible slots, and each visible K/V slot once (plus its int8
    scales)."""
    nh = nkv * g
    lanes = len(pos)
    qb = 4 if kv_dtype == torch.float32 else 2  # q's and out's elements
    elt = 1 if quant else qb
    vis = [min(p + 1, window) if window else p + 1 for p in pos]
    live_blocks = sum(p // BLOCK - (p + 1 - v) // BLOCK + 1
                      for p, v in zip(pos, vis))
    nbytes = (2 * lanes * nh * d * qb + 4 * lanes + 4 * live_blocks
              + 2 * sum(vis) * nkv * d * elt
              + (2 * sum(vis) * nkv * 4 if quant else 0))
    ops = sum(vis) * nh * (4 * d + 5)  # QK and PV dots + softmax
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kv_dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _check_case(nkv, g, window, quant, gen, layers=2, m=M, pos=POS,
                dtype=torch.bfloat16):
    d = 128
    pools, tables = _pools(nkv, d, layers, gen, quant, m=m, dtype=dtype)
    q = torch.randn(LANES, nkv * g, d, device="cuda",
                    generator=gen).to(dtype)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    kern = pa.paged_attend_int8 if quant else pa.paged_attend
    ref = pa.paged_attend_int8_ref if quant else pa.paged_attend_ref

    def args(li):
        return (q, *(p[li] for p in pools), tables, pos)

    got = kern(*args(0), window=window)
    torch.cuda.synchronize()
    want = ref(*args(0), window=window)
    err = (got.float() - want.float()).abs().max().item()
    tag = f"{kern.__name__} nkv={nkv} g={g} window={window} M={m} " \
        f"{str(dtype)[6:]}"
    if dtype == torch.float16:
        over = fp16_over(got, want)
        log(f"[kernels] {tag}: max_abs_err {err:.3e}, {over:.3f} of the "
            f"float16 per-element limit (max |out| "
            f"{want.float().abs().max().item():.3f})")
        ok = over <= 1
    else:
        log(f"[kernels] {tag}: max_abs_err {err:.3e} (tol {BF16_ATOL})")
        ok = err <= BF16_ATOL
    if not ok:
        raise AssertionError(f"{tag}: kernel disagrees with its plain "
                             f"version: max_abs_err {err}")
    return err, pools, tables, q, pos


def _library_call(q, pools, tables, pos, quant, layers):
    """The yardstick: F.scaled_dot_product_attention over K/V already
    gathered (and dequantized) per layer, with the boolean visibility
    mask; the gather is outside the timing. Returns fn(layer)."""
    nh, d = q.shape[1], q.shape[2]
    slots = tables.shape[1] * BLOCK
    idx = tables.long()
    dense = []
    for li in range(layers):
        if quant:
            kq, vq, ks, vs = (p[li] for p in pools)
            kc = (kq[idx].float() * ks[idx][..., None]).to(q.dtype)
            vc = (vq[idx].float() * vs[idx][..., None]).to(q.dtype)
        else:
            kc, vc = pools[0][li][idx], pools[1][li][idx]
        # [L, M, B, nkv, d] -> [L, nkv, M*B, d]
        dense.append(tuple(t.reshape(LANES, slots, -1, d)
                           .transpose(1, 2).contiguous() for t in (kc, vc)))
    slot = torch.arange(slots, device="cuda")
    mask = (slot[None, :] <= pos[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    nkv = dense[0][0].shape[1]

    def call(li):
        k, v = dense[li]
        return torch.nn.functional.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, enable_gqa=nkv != nh)

    return call


def _time_shape(quant, gen, layers, m, pos, dtype=torch.bfloat16, nkv=12):
    """One kernel at one shape, cycling through the per-layer pools as
    the engine's decode step does (so K/V are not served from L2 by a
    repeat): checked against its plain version, then timed beside the
    plain version, every SDPA backend and the bound. ``dtype``: q's and
    the float pools'; ``nkv``: the q and kv heads (12 on one card, 6 on
    a rank at mp 2). Returns the row."""
    name = "paged_attend_int8" if quant else "paged_attend"
    err, pools, tables, q, pos_t = _check_case(nkv, 1, 0, quant, gen,
                                                layers=layers, m=m, pos=pos,
                                                dtype=dtype)
    kern = pa.paged_attend_int8 if quant else pa.paged_attend
    ref = pa.paged_attend_int8_ref if quant else pa.paged_attend_ref

    def kern_fn(li):
        return kern(q, *(p[li] for p in pools), tables, pos_t)

    lib_fn = _library_call(q, pools, tables, pos_t, quant, layers)
    fns = {"kernel": lambda i: kern_fn(i % layers)}
    backends = _sdpa_backends(lambda: lib_fn(0))
    for be in backends:
        fns[f"sdpa[{be}]"] = lambda i: lib_fn(i % layers)
    contexts = {f"sdpa[{be}]": ctx for be, ctx in backends.items()}
    times, _ = _time_graphs(fns, contexts, optional=contexts)
    eager = _time_reps({"kernel": fns["kernel"]})["kernel"]
    ms = _med(times["kernel"])
    library_ms, lib_txt = _library(times, "sdpa")
    plain_ms = _time_plain(lambda: ref(q, *(p[0] for p in pools), tables,
                                       pos_t), iters=20)
    bound_ms, bound_by = _bound(nkv, 1, 128, pos, 0,
                                torch.int8 if quant else dtype, quant)
    log(f"[kernels] {name} L={LANES} M={m} B={BLOCK} nkv={nkv} d=128 "
        f"{str(dtype)[6:]} pos={pos}: kernel_ms {_spread(times['kernel'])} (CUDA graphs of "
        f"{ITERS} calls; median, min-max of {REPS}) plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} (fastest SDPA "
        f"backend, graphs too: {lib_txt}) bound_ms {bound_ms:.5f} "
        f"({bound_by}); kernel / bound {ms / bound_ms:.2f}, kernel / "
        f"library {ms / library_ms:.2f}; eager calls (host-inclusive) "
        f"{_spread(eager)} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)


def phase_kernels():
    gen = torch.Generator("cuda").manual_seed(0)
    errs = {"paged_attend": 0.0, "paged_attend_int8": 0.0}
    for nkv, g, window, quant in ((12, 1, 0, False), (12, 1, 64, False),
                                  (4, 3, 0, False), (12, 1, 0, True),
                                  (12, 1, 64, True), (4, 3, 0, True)):
        err, *_ = _check_case(nkv, g, window, quant, gen)
        key = "paged_attend_int8" if quant else "paged_attend"
        errs[key] = max(errs[key], err)
    rows = {}
    layers = FULL["num_hidden_layers"]
    for quant in (False, True):
        name = "paged_attend_int8" if quant else "paged_attend"
        # the served geometry is the table's row; the long shape is
        # printed beside it
        row = _time_shape(quant, gen, layers, M, POS)
        long_row = _time_shape(quant, gen, layers, M_LONG, POS_LONG)
        # a rank's shape at mp 2 (phase 23c: 6 q and 6 kv heads)
        rank_row = _time_shape(quant, gen, layers, M, POS, nkv=6)
        row["max_abs_err"] = max(errs[name], row["max_abs_err"],
                                 long_row["max_abs_err"],
                                 rank_row["max_abs_err"])
        row["mp2_rank"] = rank_row
        log(f"[kernels] {name} at a rank's 6 heads against half of the 12 "
            f"heads' time: {rank_row['ms']:.4f} / {row['ms'] / 2:.4f} = "
            f"{2 * rank_row['ms'] / row['ms']:.3f}")
        rows[name] = row
        log(f"[kernels] {name}: launches per decode round = {layers} "
            f"(layers), one per call (split and merge launches inside)")
    return rows


# -- phase 4 ------------------------------------------------------------------

def _trace(seed=0, n=16, system=32):
    """Prompts of 64-192 tokens that open with one shared 32-token
    system prompt (two full blocks for the prefix cache), 32-64 new
    tokens each."""
    rng = np.random.RandomState(seed)
    vocab = FULL["vocab_size"]
    head = rng.randint(0, vocab, (system,))
    return [(np.concatenate([head, rng.randint(
        0, vocab, (int(rng.randint(64, 193)) - system,))]).astype(np.int32),
        int(rng.randint(32, 65))) for _ in range(n)]


def phase_clocks(eng):
    """Wrap the engine's prefill, plain decode round and verify round
    with host clocks (each ends in the engine's own host sync). Returns
    {phase: [seconds, calls]}, filled as the engine runs."""
    spent = {"prefill": [0.0, 0], "decode": [0.0, 0], "verify": [0.0, 0]}
    for phase, attr in (("prefill", "_prefill"),
                        ("decode", "_plain_decode_round"),
                        ("verify", "_verify_round")):
        inner = getattr(eng, attr)

        def wrapped(*a, _inner=inner, _acc=spent[phase]):
            t0 = time.perf_counter()
            _inner(*a)
            _acc[0] += time.perf_counter() - t0
            _acc[1] += 1

        setattr(eng, attr, wrapped)
    return spent


def _ms_per(spent, phase):
    sec, calls = spent[phase]
    return sec / max(calls, 1) * 1e3


def _serve_once(model, trace, card, kv_int8=False, int8_weights=False):
    """One measured run of the main path on CUDA graphs: the engine
    captures its phases in ``warmup()``, then counts are zeroed just
    before the trace and read just after. Returns (the paged kernel's
    launch count over the run, tokens/s, the engine)."""
    wrapper = pa.paged_attend_int8 if kv_int8 else pa.paged_attend
    eng = ServingEngine(model, ServingConfig(
        max_seq_len=MAX_SEQ_LEN, kv_int8=kv_int8, int8_weights=int8_weights))
    assert eng.paged_active and eng.spec_active \
        and eng.config.prefix_cache
    eng.warmup()
    if eng.counters["graph_captures"] != 3:
        raise AssertionError(f"warmup() captured "
                             f"{eng.counters['graph_captures']} graphs, "
                             f"expected 3 (decode, prefill, verify)")
    capture_ms = sum(e.capture_ms for e in eng._graphs.values())
    spent = phase_clocks(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attend.launches = 0
    pa.paged_attend_int8.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in trace]
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wrapper.launches
    c = eng.counters
    layers = FULL["num_hidden_layers"]
    for r, (_, n) in zip(reqs, trace):
        if len(outs[r.request_id]) != n:
            raise AssertionError(f"request {r.request_id} returned "
                                 f"{len(outs[r.request_id])} of {n} tokens")
        if not ((outs[r.request_id] >= 0)
                & (outs[r.request_id] < FULL["vocab_size"])).all():
            raise AssertionError("token ids out of the vocabulary")
    if c["decode_steps"] <= 0:
        raise AssertionError("no plain decode round ran: the paged kernel "
                             "was never on the path")
    if launches != layers * c["decode_steps"]:
        raise AssertionError(
            f"{wrapper.__name__} launched {launches} times, expected "
            f"layers x decode_steps = {layers} x {c['decode_steps']}")
    other = pa.paged_attend if kv_int8 else pa.paged_attend_int8
    if other.launches:
        raise AssertionError(f"{other.__name__} ran on the wrong pool")
    if c["prefix_hit_tokens"] <= 0:
        raise AssertionError("the shared system prompt never hit the "
                             "prefix cache")
    rounds = c["decode_steps"] + c["verify_steps"]
    if c["graph_replays"] != rounds + c["prefill_chunks"] \
            or c["graph_captures"] != 3:
        raise AssertionError(
            f"{c['graph_replays']} replays and {c['graph_captures']} "
            f"captures, expected rounds + prefill chunks = {rounds} + "
            f"{c['prefill_chunks']} and 3")
    tokens = sum(n for _, n in trace)
    log(f"[serve] kv_int8={kv_int8} int8_weights={int8_weights} on {card}: "
        f"{len(trace)} requests, {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tokens/s; {c['decode_steps']} decode rounds "
        f"{_ms_per(spent, 'decode'):.3f} ms each, {c['verify_steps']} "
        f"verify rounds {_ms_per(spent, 'verify'):.3f} ms each, prefill "
        f"{_ms_per(spent, 'prefill'):.3f} ms per request "
        f"({c['prefill_chunks']} chunks); {c['graph_captures']} graphs "
        f"captured in {capture_ms:.1f} ms, {c['graph_replays']} replays; "
        f"{c['prefix_hit_tokens']} prefix-hit tokens, "
        f"{c['spec_accepted_tokens']}/{c['spec_proposed_tokens']} drafts "
        f"accepted; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"{wrapper.__name__} launches {launches}")
    return launches, tokens / wall, eng


def _profile_decode_replay(eng, kv_int8, attempts=3):
    """One decode replay under ``torch.profiler``: the paged kernel's
    split and merge launches must each appear once per layer (the graph
    holds them; the wrapper's counter is only Python).

    CUPTI may drop activity records, so a replay can show fewer launches
    than its graph holds, never more. The replay is profiled up to
    ``attempts`` times: every attempt must show at most one launch per
    layer, and one of them exactly one."""
    L, M = eng.config.max_lanes, eng.blocks_per_lane
    inputs = dict(tables=np.zeros((L, M), np.int32),
                  cur_len=np.zeros(L, np.int32),
                  last_tok=np.zeros(L, np.int32))  # idle lanes: block 0
    eng._run("decode", **inputs)
    torch.cuda.synchronize()
    layers = FULL["num_hidden_layers"]
    expected = {"split": layers, "merge": layers}
    seen = []
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng._run("decode", **inputs)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        count = {part: sum(e.count for e in kernels
                           if f"paged_{part}_kernel" in e.key)
                 for part in ("split", "merge")}
        seen.append(count)
        log(f"[serve] kv_int8={kv_int8}: decode replay {attempt + 1} under "
            f"the profiler: {sum(e.count for e in kernels)} kernels, "
            f"{sum(e.self_device_time_total for e in kernels) / 1e3:.3f} ms "
            f"of device time; paged split {count['split']}, merge "
            f"{count['merge']} (layers {layers})")
        if any(count[k] > layers for k in count):
            raise AssertionError(f"the decode replay launched the paged "
                                 f"kernels {count} times, expected {layers} "
                                 f"each")
        if count == expected:
            return
    raise AssertionError(f"{attempts} decode replays launched the paged "
                         f"kernels {seen} times, expected {layers} each")


def phase_serve(card):
    t0 = time.perf_counter()
    model = LlamaForCausalLM(LlamaConfig(**FULL), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] 0.44B Llama: {n_params / 1e9:.3f} B parameters, bf16, "
        f"built in {time.perf_counter() - t0:.1f} s")
    trace = _trace()
    launches, rates = {}, {}
    for name, kv_int8, int8_weights in (
            ("paged_attend", False, False),
            ("paged_attend_int8", True, False),
            ("int8_weights", False, True)):
        n, rates[name], eng = _serve_once(model, trace, card, kv_int8,
                                          int8_weights)
        if name in pa.__all__:
            launches[name] = n
            _profile_decode_replay(eng, kv_int8)
        del eng
        gc.collect()  # its pools go to the next engine of their geometry
    log(f"[serve] tokens/s on {card}: bf16 pools {rates['paged_attend']:.1f},"
        f" int8 pools {rates['paged_attend_int8']:.1f}, int8 weights "
        f"{rates['int8_weights']:.1f}")
    return launches


# -- phase 5 ------------------------------------------------------------------

def _tiny_pair():
    """A tiny fp32 Llama on the CPU from a seed and its copy on the
    card."""
    cpu = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                           device="cpu",
                           generator=torch.Generator("cpu").manual_seed(1))
    card = LlamaForCausalLM(cpu.config, device="cuda")
    load_jax_weights(card, {n: p.detach().numpy()
                            for n, p in cpu.named_parameters()})
    return cpu, card


def phase_identity():
    """tests/test_serving.py::test_engine_paged_token_identical's
    geometry on the card: the engine's tokens (phases on CUDA graphs,
    decode through the CUDA kernels) equal the port's own greedy
    generate(), request by request; then generate()'s left padding,
    int8 weights and sampling on the card."""
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                             device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    for kv_int8 in (False, True):
        eng = ServingEngine(model, ServingConfig(
            max_lanes=3, block_size=2, num_blocks=12, prefill_chunk=4,
            max_seq_len=20, kv_int8=kv_int8))
        rng = np.random.RandomState(5)
        reqs = []
        for _ in range(6):
            plen, new = int(rng.randint(2, 9)), int(rng.randint(6, 12))
            prompt = rng.randint(0, model.config.vocab_size,
                                 (plen,)).astype(np.int32)
            reqs.append((eng.submit(prompt, max_new_tokens=new), prompt,
                         new))
        outs = eng.run()
        c = eng.counters
        if c["preemptions"] <= 0 or c["decode_steps"] <= 0 \
                or c["graph_replays"] <= 0:
            raise AssertionError(f"identity run is vacuous: {c}")
        for r, prompt, new in reqs:
            want = generate(model, prompt[None], max_new_tokens=new,
                            kv_int8=kv_int8).cpu().numpy()[0]
            if not np.array_equal(outs[r.request_id], want):
                raise AssertionError(
                    f"kv_int8={kv_int8} request {r.request_id}: engine "
                    f"{outs[r.request_id].tolist()} != generate "
                    f"{want.tolist()}")
        log(f"[identity] kv_int8={kv_int8}: {len(reqs)} requests on graphs "
            f"({c['graph_replays']} replays) token-identical to generate() "
            f"through {c['preemptions']} preemptions, {c['decode_steps']} "
            f"paged decode rounds")
    cpu, card = _tiny_pair()
    rng = np.random.RandomState(6)
    mask = np.array([[0, 0, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1, 1],
                     [0, 0, 0, 0, 0, 1, 1]], np.int32)
    ids = np.where(mask == 1, rng.randint(0, cpu.config.vocab_size,
                                          mask.shape), 0).astype(np.int32)
    for kw in (dict(attention_mask=mask), dict(int8_weights=True),
               dict(attention_mask=mask, int8_weights=True)):
        want = generate(cpu, ids, max_new_tokens=10, device="cpu",
                        **kw).numpy()
        got = generate(card, ids, max_new_tokens=10, **kw).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"generate({sorted(kw)}) on the card "
                                 f"{got.tolist()} != CPU {want.tolist()}")
    sample = dict(do_sample=True, temperature=0.8, top_p=0.9, seed=7)
    a = generate(card, ids[1:], max_new_tokens=16, **sample)
    b = generate(card, ids[1:], max_new_tokens=16, **sample)
    greedy = generate(card, ids[1:], max_new_tokens=16)
    top1 = generate(card, ids[1:], max_new_tokens=16, do_sample=True,
                    top_k=1, seed=8)
    if not (torch.equal(a, b) and torch.equal(top1, greedy)):
        raise AssertionError("sampling on the card: a seed did not repeat "
                             "itself, or top_k=1 left the greedy tokens")
    log(f"[identity] fp32 tiny Llama: left-padded, int8-weight and both "
        f"generate() token-identical to the CPU; sampling repeats with its "
        f"seed and top_k=1 gives the greedy tokens")


# -- phase 6 ------------------------------------------------------------------

# (name, b, sq, sk, h, h_kv, causal, window, d), bf16; the first is the
# training step's shape. d 64 runs the forward's 64-column template, and
# 1000 rows and keys leave ragged tiles (TMA's zero fill and the masks).
FLASH_CASES = [
    ("headline", 8, 1024, 1024, 12, 12, True, 0, 128),
    ("window256", 8, 1024, 1024, 12, 12, True, 256, 128),
    ("gqa", 2, 1024, 1024, 12, 4, True, 0, 128),
    ("sq512_sk1024", 2, 512, 1024, 12, 12, True, 0, 128),
    ("noncausal", 2, 1024, 1024, 12, 12, False, 0, 128),
    ("d64", 4, 1024, 1024, 12, 12, True, 0, 64),
    ("ragged1000", 2, 1000, 1000, 12, 4, True, 0, 128),
]
# Kernel vs plain version on the same card and bf16 inputs; the plain
# version runs on fp32 copies of the same values and returns fp32, so
# only the kernel's own roundings separate them. These shapes run the
# tensor-core kernels (bf16, d <= 128).
#
# The deciding measure is relative and per tile: for each (batch, head)
# and each 64 rows (the kernels' tile), ||got - want|| / ||want||. A
# measure scaled by the max abs would take its scale from the first rows
# and keys, where causal attention is sharpest and |dK|, |dV| are
# largest (the key at position j is attended with weight ~1/(j+1), so
# |dV| there is ~sqrt(1/(j+1)) of the first key's); at the max-scaled
# 2e-2 a late tile off by tens of percent would pass. Expected floor: one
# bf16 rounding of the output (relative RMS ~2**-8 / sqrt(3) ~ 2.3e-3 at
# worst) and, in the backward, the bf16 rounding of P and dS as
# tensor-core operands (~2e-3 each, averaged over the sums); the plain
# result's own bf16 rounding is printed beside the error as that floor.
# FLASH_REL_TOL is ~4x the floor, and a tile 10 % off fails it.
FLASH_REL_TOL = 1e-2
# also held, as first specified: O within 2e-2 abs (one bf16 rounding of
# an O(1) value is up to 2**-8 ~ 4e-3), each gradient within 2e-2 of its
# max abs; lse is fp32 in both, so only the order of the sums separates
# them (1e-3 on values ~10)
FLASH_ATOL = 2e-2
LSE_ATOL = 1e-3
# delta = rowsum(dO * O) computed inside kernel 2 against _delta's torch
# ops on the same bf16 dO and O: both sum fp32 products, in other
# orders, so each (batch, head) row within 1e-5 of its relative
# Frobenius error (~1e-7 expected)
DELTA_REL_TOL = 1e-5


def _flash_inputs(b, sq, sk, h, h_kv, gen, d=128, dtype=torch.bfloat16):
    def mk(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    return mk(b, sq, h, d), mk(b, sk, h_kv, d), mk(b, sk, h_kv, d), \
        mk(b, sq, h, d)


def _normalized_err(got, want):
    scale = want.float().abs().max().clamp(min=1e-9)
    return ((got.float() - want.float()) / scale).abs().max().item()


def _tile_rel_err(got, want, tile=64):
    """The largest relative Frobenius error over the output tiles of
    ``[b, s, h, d]`` tensors: ``tile`` rows of one (batch, head) each. A
    tile whose reference is exactly zero (rows that see no key) must be
    exactly zero too."""
    b, s, h, d = want.shape
    pad = (0, 0, 0, 0, 0, -s % tile)

    def tile_sq_norms(x):
        x = torch.nn.functional.pad(x, pad)
        return x.reshape(b, -1, tile, h, d).square().sum((2, 4))

    dn = tile_sq_norms(got.float() - want.float())
    wn = tile_sq_norms(want.float())
    rel = torch.where(wn > 0, dn / wn, torch.where(
        dn > 0, torch.full((), float("inf"), device=dn.device), 0.0))
    return rel.max().sqrt().item()


# An additive key-mask value at or below this is padding: its p,
# exp(score + mask - row max), is exactly 0 in fp32 (exp(-1000) is far
# below the smallest subnormal), so it adds nothing to O, dQ, dK, dV or
# dmask, unless every key its query row sees is padding.
PAD_LEVEL = -1e3


def _flash_bound(q, k, causal, window, kernel, kmask=None):
    """Least time for one call's work at these inputs: the larger of its
    bytes over the HBM rate (each input read once, each output written
    once) and its operations over the bf16 peak. Operations count only
    the (row, key) pairs the function needs: visible (causal, window)
    and, with ``kmask`` (``[b, 1, sk]`` or ``[b * h, 1, sk]`` fp32, the
    same row for every head), not padding; a row that sees only padding
    needs all its visible keys. 2 * d per product per pair, 2 products
    forward (QK, PV), 3 for dQ (QK, dO.V, dS.K), 4 for dK/dV (QK, dO.V,
    P^T.dO, dS^T.Q), 5 for the whole backward (``*_bwd``: QK, dO.V, dS.K,
    P^T.dO, dS^T.Q, which is what it needs when one pass computes all
    three gradients); the softmax, mask and dropout hash are not counted
    (other units, far below the products). K and V are read only at the
    keys some row needs; dK and dV are written in full. kmask's rows are
    read by each kernel, and dK/dV writes as many dmask rows. dQ that
    computes delta (``*_bwd_dq_delta``) also reads O; the whole backward
    reads q, O, dO and lse and writes dQ, dK and dV. Returns
    (ms, "bytes" or "operations", ms counting every visible pair and
    all of K and V)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    vis = fa._visible(sq, sk, causal, window, q.device)
    vis = torch.ones(sq, sk, dtype=torch.bool, device=q.device) \
        if vis is None else vis
    if kmask is None:
        need = vis.expand(b, sq, sk)
    else:
        live = kmask.reshape(b, -1, sk)[:, 0] > PAD_LEVEL  # [b, sk]
        need = vis & live[:, None]
        need = need | (vis & ~need.any(-1, keepdim=True))
    pairs = int(need.sum())  # summed over batch rows
    live_keys = int(need.any(1).sum())
    stage = kernel.split("_", 1)[1]  # fwd, bwd_dq(_delta), bwd_dkv, bwd
    products = {"fwd": 2, "bwd_dq": 3, "bwd_dq_delta": 3, "bwd_dkv": 4,
                "bwd": 5}
    q_bytes = q.numel() * q.element_size()
    kv_bytes = 2 * k.numel() * k.element_size()  # K and V in full
    row_bytes = b * h * sq * 4  # one fp32 per row: lse, delta
    km_bytes = 0 if kmask is None else kmask.numel() * 4

    def bound(pairs, kv_read):
        ops = h * pairs * 2 * d * products[stage]
        nbytes = {"fwd": 2 * q_bytes + kv_read + row_bytes + km_bytes,
                  "bwd_dq": 3 * q_bytes + kv_read + 2 * row_bytes + km_bytes,
                  "bwd_dq_delta": 4 * q_bytes + kv_read + 2 * row_bytes
                  + km_bytes,
                  "bwd_dkv": 2 * q_bytes + kv_read + kv_bytes + 2 * row_bytes
                  + 2 * km_bytes,
                  "bwd": 4 * q_bytes + kv_read + kv_bytes + row_bytes
                  + 2 * km_bytes}[stage]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
        return max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"

    ms, by = bound(pairs, kv_bytes * live_keys // (b * sk))
    all_pairs_ms, _ = bound(b * int(vis.sum()), kv_bytes)
    return ms, by, all_pairs_ms


def _flash_check(case, gen, fused=False, dtype=torch.bfloat16):
    """Kernels 1-3 against their plain versions at ``case`` in ``dtype``
    (bf16 or fp16); ``fused``: v is a strided view of a ``[b, s, (h + 2
    h_kv) d]`` projection row, as the Llama attention hands it on (q and
    k come out of RoPE contiguous)."""
    name, b, sq, sk, h, h_kv, causal, window, d = case
    kw = dict(causal=causal, window=window)
    q, k, v, do = _flash_inputs(b, sq, sk, h, h_kv, gen, d=d, dtype=dtype)
    if fused:
        row = torch.cat([t.reshape(b, sk, -1) for t in (q, k, v)], -1)
        v = row[..., (h + h_kv) * d:].view(b, sk, h_kv, d)
    f32 = [t.float() for t in (q, k, v, do)]
    out, lse = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_fwd_ref(*f32[:3], **kw)
    # the backward's inputs, shared by kernel and plain version: lse and
    # delta = rowsum(dO * O) from O as the forward hands it on (bf16);
    # kernel 2 runs through both entries, delta given and delta computed
    out_b = want_out.to(q.dtype)
    delta = fa._delta(do, out_b)
    dq = fa.flash_bwd_dq(q, k, v, do, want_lse, delta, **kw)
    dq_f, delta_f = fa.flash_bwd_dq_delta(q, k, v, do, out_b, want_lse, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    want_dq = fa.flash_bwd_dq_ref(*f32, want_lse, delta, **kw)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(*f32, want_lse, delta, **kw)
    pairs = {"flash_fwd": [(out, want_out)],
             "flash_bwd_dq": [(dq, want_dq), (dq_f, want_dq)],
             "flash_bwd_dkv": [(dk, want_dk), (dv, want_dv)]}
    delta_err = _row_rel_err(delta_f[:, None], delta[:, None])
    rel = {n: max(_tile_rel_err(g, w) for g, w in p) for n, p in pairs.items()}
    floor = {n: max(_tile_rel_err(w.to(q.dtype), w) for _, w in p)
             for n, p in pairs.items()}
    abs_err = {n: max((g.float() - w).abs().max().item() for g, w in p)
               for n, p in pairs.items()}
    loose = {"flash_fwd": abs_err["flash_fwd"],
             "flash_bwd_dq": max(_normalized_err(dq, want_dq),
                                 _normalized_err(dq_f, want_dq)),
             "flash_bwd_dkv": max(_normalized_err(dk, want_dk),
                                  _normalized_err(dv, want_dv))}
    lse_err = (lse - want_lse).abs().max().item()
    log(f"[flash] {name} b={b} sq={sq} sk={sk} h={h} h_kv={h_kv} d={d} "
        f"{str(dtype)[6:]} causal={causal} window={window}: per-tile "
        f"relative error "
        + ", ".join(f"{n} {rel[n]:.3e} ({str(dtype)[6:]} floor "
                    f"{floor[n]:.3e})"
                    for n in rel)
        + f" (tol {FLASH_REL_TOL}); O max_abs_err {loose['flash_fwd']:.3e}, "
        f"dQ {loose['flash_bwd_dq']:.3e}, dK/dV "
        f"{loose['flash_bwd_dkv']:.3e} of their max (tol {FLASH_ATOL}); "
        f"lse {lse_err:.3e} (tol {LSE_ATOL}); kernel 2's delta "
        f"{delta_err:.3e} per row (tol {DELTA_REL_TOL})")
    bad = [n for n in rel if not (rel[n] <= FLASH_REL_TOL
                                  and loose[n] <= FLASH_ATOL)]
    if bad or not lse_err <= LSE_ATOL or not delta_err <= DELTA_REL_TOL:
        raise AssertionError(f"{name}: {bad or ['lse or delta']} disagree "
                             f"with the plain versions: relative {rel}, "
                             f"{loose}, lse {lse_err}, delta {delta_err}")
    return abs_err, (q, k, v, do, out_b, want_lse, delta)


def _sdpa_fns(q, k, v, do, **kw):
    """The yardstick: PyTorch's fused attention on ``[b, h, s, d]`` copies
    of the same inputs, forward and backward (dQ, dK and dV together), on
    each backend that accepts the call. Returns (fns, contexts,
    fallbacks, minus) for ``_timed``: ``sdpa_fwd[backend]`` and
    ``sdpa_bwd[backend]``. Without dropout the backward is
    ``torch.autograd.grad`` from the forward's output (made on the capture
    stream, where autograd then runs the backward ops), and its fallback
    calls the backend's backward node (``out.grad_fn``) directly. With
    dropout a backward captured apart from its forward cannot run: a
    forward outside a capture leaves its dropout seed on the host, where
    a captured backward reads a device pointer (and the reverse faults
    the warm-up calls). There the backward is captured together with its
    forward, and ``minus`` names the forward whose time ``_timed``
    subtracts. Timed only: the port never calls it."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    plain = [t.detach() for t in (qt, kt, vt)]
    fns, contexts, fallbacks, minus = {}, {}, {}, {}
    for be, ctx in _sdpa_backends(lambda: sdpa(*plain, **kw)).items():
        fwd, bwd = f"sdpa_fwd[{be}]", f"sdpa_bwd[{be}]"
        fns[fwd] = lambda i: sdpa(*plain, **kw)
        contexts[fwd] = contexts[bwd] = ctx
        if kw.get("dropout_p"):
            fns[bwd] = lambda i: torch.autograd.grad(
                sdpa(qt, kt, vt, **kw), (qt, kt, vt), dot)
            minus[bwd] = fwd
            continue
        torch.cuda.synchronize()
        with ctx(), torch.cuda.stream(_capture_stream()):
            out_t = sdpa(qt, kt, vt, **kw)
        torch.cuda.synchronize()
        fns[bwd] = lambda i, o=out_t: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True)
        fallbacks[bwd] = lambda i, o=out_t: o.grad_fn(dot)
    return fns, contexts, fallbacks, minus


def _whole_backward(fn_cls, q, k, v, out, lse, do, **args):
    """``fn_cls.backward`` (the autograd Function's backward, as a
    training step runs it) on saved tensors (q, k, v, out, lse) and the
    forward's arguments."""
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, out, lse), args=args)
    return lambda i: fn_cls.backward(ctx, do)


def _ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def _timed(port, library, contexts, fallbacks, minus):
    """Port functions and library calls ({name: fn(i)}) as CUDA-graph
    replays (a port function that cannot be captured fails the phase; a
    library call is left out), and the port functions as eager calls. A
    library entry named in ``minus`` ({name: other}) reads its time less
    the other's, repetition by repetition. Returns (graph times, how each
    library call was captured, eager times)."""
    times, how = _time_graphs({**library, **port}, contexts,
                              optional=library, fallbacks=fallbacks)
    for name, other in minus.items():
        if name in times and other in times:
            times[name] = [a - b for a, b in zip(times[name], times[other])]
            how[name] = " (with its forward in one graph, less the forward)"
        else:
            times.pop(name, None)
    return times, how, _time_reps(port)


def _flash_kernel_rows(q, k, v, do, out, lse, delta, errs, extra=None):
    """Kernels 1-3 at one causal shape (kernel 2 as the Llama step runs
    it, computing delta), and ``extra`` port calls ({name: fn(i)}), as
    CUDA-graph replays beside SDPA's fastest backend; each kernel's row
    (ms, plain_ms, library_ms, bound_ms, bound_by, max_abs_err from
    ``errs``). Returns (rows, graph times, eager times, {kernel:
    (library ms, how)})."""
    kw = dict(causal=True, window=0)
    kernels = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_ref(q, k, v, **kw)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq_delta(q, k, v, do, out, lse, **kw),
            lambda: fa.flash_bwd_dq_delta_ref(q, k, v, do, out, lse, **kw)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
            lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)),
    }
    # SDPA's causal mask is top-left aligned, equal to bottom-right at sq
    # == sk; its backward yields dQ, dK and dV together, so kernels 2 and
    # 3 share one library time
    library, contexts, fallbacks, minus = _sdpa_fns(q, k, v, do,
                                                    is_causal=True)
    port = {name: lambda i, f=kern: f() for name, (kern, _) in kernels.items()}
    port.update(extra or {})
    times, how, eager = _timed(port, library, contexts, fallbacks, minus)
    lib = {"flash_fwd": _library(times, "sdpa_fwd", how),
           "flash_bwd_dq": _library(times, "sdpa_bwd", how)}
    lib["flash_bwd_dkv"] = lib["flash_bwd_dq"]
    rows = {}
    for name, (_, plain) in kernels.items():
        bound_ms, bound_by, _ = _flash_bound(
            q, k, True, 0, name + ("_delta" if name == "flash_bwd_dq" else ""))
        rows[name] = dict(ms=_med(times[name]),
                          plain_ms=_time_plain(plain, iters=5),
                          library_ms=lib[name][0], bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=errs[name])
    return rows, times, eager, lib


def phase_flash(layers):
    gen = torch.Generator("cuda").manual_seed(1)
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for case in FLASH_CASES[1:]:
        e, _ = _flash_check(case, gen)
        errs = {k: max(errs[k], e[k]) for k in errs}
    e, (q, k, v, do, out, lse, delta) = _flash_check(FLASH_CASES[0], gen)
    errs = {k_: max(errs[k_], e[k_]) for k_ in errs}
    kw = dict(causal=True, window=0)
    given = "flash_bwd_dq (delta given)"
    whole = "flash_bwd (delta + 2 + 3)"
    extra = {given: lambda i: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             whole: _whole_backward(
                 fa._FlashFn, q, k, v, out, lse, do, kmask=None, seed=None,
                 dropout=0.0, scale=1.0 / q.shape[-1] ** 0.5, **kw)}
    rows, times, eager, lib = _flash_kernel_rows(q, k, v, do, out, lse,
                                                 delta, errs, extra)
    lib[whole] = lib["flash_bwd_dq"]
    for name, row in rows.items():
        log(f"[flash] {name} b8 s1024 h12 d128 bf16 causal: kernel_ms "
            f"{_spread(times[name])} (CUDA graphs of {ITERS} calls; "
            f"median, min-max of {REPS}) plain_ms {row['plain_ms']:.4f} "
            f"library_ms {_ms(row['library_ms'])} (fastest SDPA backend, "
            f"graphs too: {lib[name][1]}) bound_ms {row['bound_ms']:.5f} "
            f"({row['bound_by']}); eager calls (host-inclusive) "
            f"{_spread(eager[name])} ms; launches per train step = "
            f"{layers} (layers)"
            + (f"; through the entry given delta {_spread(times[given])} ms"
               if name == "flash_bwd_dq" else ""))
    lib_ms, lib_txt = lib[whole]
    ms = _med(times[whole])
    bound_ms, bound_by, _ = _flash_bound(q, k, True, 0, "flash_bwd")
    log(f"[flash] {whole} b8 s1024 h12 d128 bf16 causal, as "
        f"_FlashFn.backward runs it: {_spread(times[whole])} ms (CUDA "
        f"graphs) against SDPA's whole backward {_ms(lib_ms)} ({lib_txt}): "
        f"{ms / lib_ms if lib_ms else float('nan'):.2f}x; bound_ms "
        f"{bound_ms:.5f} ({bound_by}); eager calls {_spread(eager[whole])} "
        f"ms")
    return rows


# -- phase 7 ------------------------------------------------------------------

TRAIN = dict(FULL, max_position_embeddings=1024,
             use_parallel_cross_entropy=False, ce_chunk_size=0)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
WARMUP_STEPS, TIMED_STEPS = 2, 5
FLASH_WRAPPERS = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
READINGS = {}  # one phase's numbers another prints beside its own


def _train_batch(vocab, b, s, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int32)
    return (torch.from_numpy(ids).to("cuda"),
            torch.from_numpy(labels).to("cuda"))


def phase_train(card):
    """bench.py's headline train step on the card: the 0.44B Llama, bf16,
    b8 x s1024, plain CE, AdamW(1e-4) with fp32 masters, TrainStep."""
    cfg = LlamaConfig(**TRAIN)
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    step = TrainStep(model, opt, lambda m, i, l: m(i, l))
    ids, labels = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(ids, labels)) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    for w in FLASH_WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    timed = [step(ids, labels) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    losses += [float(x) for x in timed]
    layers, steps = cfg.num_hidden_layers, TIMED_STEPS
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not abs(losses[0] - np.log(cfg.vocab_size)) < 0.7:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln(vocab) = {np.log(cfg.vocab_size):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for p in model.parameters():
        master = opt._master_weights[id(p)]
        if p.dtype != torch.bfloat16 or master.dtype != torch.float32:
            raise AssertionError(f"param {p.dtype}, master {master.dtype}")
    for name, n in launches.items():
        if n != layers * steps or n <= 0:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps, expected layers x steps = "
                                 f"{layers} x {steps}")
    # two more steps run eagerly (TrainStep replays the same work as one
    # graph), the second split by CUDA events: the first eager step after
    # the graph's capture pays the allocator's warm-up
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(2):
        opt.clear_grad()
        ev[0].record()
        loss = model(ids, labels)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    ms = wall / steps * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = model.flops_per_token(TRAIN_SEQ) * tokens / (ms / 1e3) \
        / PEAK_OPS_PER_S[torch.bfloat16]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] on {card}: {n_params / 1e9:.3f} B parameters, bf16, "
        f"b{TRAIN_BATCH} x s{TRAIN_SEQ}; losses "
        f"{[round(x, 4) for x in losses]}; {ms:.2f} ms per step over "
        f"{steps} steps = {tokens / ms * 1e3:.0f} tokens/s, MFU "
        f"{mfu:.4f} (flops_per_token x tokens / time / 989e12); one step "
        f"split: forward {split[0]:.2f} ms, backward {split[1]:.2f} ms, "
        f"optimizer {split[2]:.2f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; flash "
        f"launches {launches}")
    READINGS["phase7"] = (ms, torch.cuda.max_memory_allocated() / 2**30)
    del model, opt, step
    torch.cuda.empty_cache()
    return launches


# -- phase 8 ------------------------------------------------------------------

IDENTITY_STEPS = 10
# fp32 on both sides, so the card runs the fp32-FMA kernels; it holds
# the autograd Function, the model and the optimizer around them, which
# the bf16 tensor-core kernels of the main path share (those kernels are
# held in phase 6). The card sums in another order than the CPU. The
# losses are held to 1e-4 at every step. Params to 2e-3, the tolerance
# of tests/test_torch_train.py against JAX: Adam's first steps move each
# weight by about lr * sign(g), so a gradient near 0 whose sign the two
# summation orders flip moves the weight ~2 lr apart.
IDENTITY_LOSS_ATOL, IDENTITY_PARAM_ATOL = 1e-4, 2e-3


def train_tiny(device, weights, steps=IDENTITY_STEPS):
    """The tiny fp32 model from ``weights`` trained ``steps`` AdamW steps
    (lr 1e-3, wd 0.01, global-norm clip 1.0) on seeded batches; returns
    (losses, model)."""
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device=device)
    load_jax_weights(model, weights)
    step = TrainStep(model, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                  parameters=model.parameters(),
                                  grad_clip=ClipGradByGlobalNorm(1.0)))
    losses = []
    for i in range(steps):
        rng = np.random.RandomState(100 + i)
        ids, labels = (torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(device)
            for _ in range(2))
        losses.append(float(step(ids, labels)))
    return losses, model


def phase_train_identity():
    seed_model = LlamaForCausalLM(
        LlamaConfig.tiny(num_hidden_layers=2), device="cpu",
        generator=torch.Generator("cpu").manual_seed(0))
    weights = {n: p.detach().numpy() for n, p in seed_model.named_parameters()}
    for w in FLASH_WRAPPERS:
        w.launches = 0
    got, gm = train_tiny("cuda", weights)
    if min(w.launches for w in FLASH_WRAPPERS) <= 0:
        raise AssertionError("the card's tiny run never launched the flash "
                             "kernels")
    want, wm = train_tiny("cpu", weights)
    diff = max(abs(a - b) for a, b in zip(got, want))
    pdiff = max((p.detach().cpu() - q.detach()).abs().max().item()
                for p, q in zip(gm.parameters(), wm.parameters()))
    log(f"[train-identity] {IDENTITY_STEPS} AdamW steps, fp32 tiny: "
        f"losses card {[round(x, 6) for x in got]} vs CPU "
        f"{[round(x, 6) for x in want]}: max diff {diff:.3e} (tol "
        f"{IDENTITY_LOSS_ATOL}), params max diff {pdiff:.3e} (tol "
        f"{IDENTITY_PARAM_ATOL})")
    if not diff <= IDENTITY_LOSS_ATOL or not pdiff <= IDENTITY_PARAM_ATOL:
        raise AssertionError("the card's training run left the CPU's")


# -- phase 9 ------------------------------------------------------------------

# (name, b, sq, sk, h, h_kv, causal, window, dtype, masked[, d]) at d 64
# unless given, each with dropout 0.1 and, where masked, a key mask from seeded lengths
# 128-512 (or from the lengths given). The first is BERT-base's attention
# on a padded batch (phase 10's traffic); "dropout_only" is the same
# without a mask, as benchmarks/baseline_configs.py::bench_bert_mlm calls
# it (no attention_mask). The explicit lengths hold the dK/dV kernels'
# skip of wholly padded key tiles both ways: a batch row of length 0
# (every key padding: nothing is skipped), and 64, 100 and 300, which end
# on and between the 64-key tiles, non-causal and causal.
ENC_CASES = [
    ("bert", 64, 512, 512, 12, 12, False, 0, torch.bfloat16, True),
    ("dropout_only", 64, 512, 512, 12, 12, False, 0, torch.bfloat16, False),
    ("window128", 4, 512, 512, 12, 12, True, 128, torch.bfloat16, True),
    ("gqa", 4, 512, 512, 12, 4, False, 0, torch.bfloat16, True),
    ("sq256_sk512", 4, 256, 512, 12, 12, True, 0, torch.bfloat16, True),
    ("fp32", 4, 512, 512, 12, 12, False, 0, torch.float32, True),
    ("lengths", 4, 512, 512, 12, 12, False, 0, torch.bfloat16,
     (0, 64, 100, 300)),
    ("lengths_causal", 4, 512, 512, 12, 12, True, 0, torch.bfloat16,
     (300, 0, 100, 64)),
    # the repo's single-chip ERNIE attention shape (benchmarks/
    # ernie_bench.py:48-56: b4 s1024, 12 heads of d 128), dropout 0.1, no
    # mask, bidirectional (NLU) and causal (NLG); at d 128 with dropout
    # kernel 6 runs the mma.sync dK/dV
    ("ernie_proxy", 4, 1024, 1024, 12, 12, False, 0, torch.bfloat16, False,
     128),
    ("ernie_proxy_causal", 4, 1024, 1024, 12, 12, True, 0, torch.bfloat16,
     False, 128),
    # phase 12's own calls: the 10B trunk (64 heads of d 64) in both
    # passes and the NLG branch (12 heads of d 64), b4 s1024, no mask
    ("ernie_trunk", 4, 1024, 1024, 64, 64, False, 0, torch.bfloat16, False),
    ("ernie_trunk_causal", 4, 1024, 1024, 64, 64, True, 0, torch.bfloat16,
     False),
    ("ernie_branch_causal", 4, 1024, 1024, 12, 12, True, 0, torch.bfloat16,
     False),
]
ERNIE_TIMED = ("ernie_proxy", "ernie_proxy_causal", "ernie_trunk",
               "ernie_trunk_causal")
ENC_DROPOUT = 0.1
ENC_SEED = (20240607, -77)  # the two dropout seed words, fixed
# Tolerances as phase 6: every output per 64-row tile of each (batch,
# head) against the plain version on fp32 copies, bf16 within 1e-2; the
# fp32 case (the fp32-FMA kernels) within 1e-5, which one flipped keep
# bit breaks (it moves its row by p / (1 - p) of one probability, ~2e-3
# at s512). dmask, an fp32 sum over heads and rows of fp32 ds terms that
# partly cancel (from bf16 inputs too), by the relative Frobenius error
# of each of its rows (batch row, or query head for kernel 3), within
# 1e-3 (bf16) or 1e-4 (fp32: the order of the sums): one key of a row
# 10 % off moves that row by ~5e-3. lse (fp32 in both) relative to its
# size, within 1e-6 (~8 fp32 ulps): a row whose visible keys are all
# padded has |lse| ~ 1e4, where one ulp is ~1e-3, phase 6's absolute
# limit.
ENC_REL_TOL = {torch.bfloat16: 1e-2, torch.float16: 1e-2,
               torch.float32: 1e-5}
DMASK_REL_TOL = {torch.bfloat16: 1e-3, torch.float16: 1e-3,
                 torch.float32: 1e-4}
LSE_REL_TOL = 1e-6
HB_WRAPPERS = (hf.hb_fwd, hf.hb_bwd_dq, hf.hb_bwd_dkv)
FAMILIES = {
    "kernels 4-6": (HB_WRAPPERS, (hf.hb_fwd_ref, hf.hb_bwd_dq_ref,
                                  hf.hb_bwd_dkv_ref)),
    "kernels 1-3": (FLASH_WRAPPERS, (fa.flash_fwd_ref, fa.flash_bwd_dq_ref,
                                     fa.flash_bwd_dkv_ref)),
}


def _padding_mask(b, sk, seed=0, lengths=None):
    """The additive key rows ``[b, 1, sk]`` fp32 of a padded batch with
    lengths uniform in 128..sk (or ``lengths``), as ``BertModel`` builds
    them under bf16 (``(mask - 1) * 1e4`` rounds to -9984)."""
    if lengths is None:
        lengths = np.random.RandomState(seed).randint(128, sk + 1, b)
    keep = np.arange(sk)[None] < np.asarray(lengths)[:, None]
    m = torch.from_numpy(keep).to("cuda", torch.bfloat16)
    return ((m - 1.0) * 1e4).float().reshape(b, 1, sk)


def _row_rel_err(got, want):
    """The largest relative Frobenius error over the rows of ``[rows, 1,
    sk]`` tensors; a row whose reference is exactly zero must be too."""
    dn = (got.float() - want.float()).square().sum((1, 2))
    wn = want.float().square().sum((1, 2))
    rel = torch.where(wn > 0, dn / wn, torch.where(
        dn > 0, torch.full((), float("inf"), device=dn.device), 0.0))
    return rel.max().sqrt().item()


def _enc_check(case, family, gen, coords=None):
    """One case of one kernel family against its plain versions; returns
    the max abs errors by wrapper and the inputs for timing. ``coords``:
    the dropout hash's global coordinates (a rank's part of the batch
    and heads), given to the kernels and the plain versions alike."""
    name, b, sq, sk, h, h_kv, causal, window, dtype, masked, *d = case
    d = d[0] if d else 64
    (fwd, bdq, bdkv), (fwd_ref, bdq_ref, bdkv_ref) = FAMILIES[family]
    q, k, v, do = (t.to(dtype) for t in _flash_inputs(b, sq, sk, h, h_kv,
                                                      gen, d=d))
    km = _padding_mask(b, sk, lengths=masked if isinstance(
        masked, tuple) else None) if masked else None
    if masked and family == "kernels 1-3":  # one row per query head
        km = km.repeat_interleave(h, 0)
    kw = dict(causal=causal, window=window, kmask=km, seed=ENC_SEED,
              dropout=ENC_DROPOUT)
    if coords is not None:
        kw["coords"] = coords
    f32 = [t.float() for t in (q, k, v, do)]
    out, lse = fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fwd_ref(*f32[:3], **kw)
    delta = (do.float() * want_out.to(dtype).float()).sum(-1) \
        .permute(0, 2, 1).reshape(b * h, sq).contiguous()
    dq = bdq(q, k, v, do, want_lse, delta, **kw)
    # kernel 5 as _HbFlashFn.backward runs it in bf16 and fp16: computing
    # delta from the same O, held like kernel 2's fused entry in phase 6
    fused = family == "kernels 4-6" and dtype != torch.float32
    if fused:
        dq_f, delta_f = hf.hb_bwd_dq_delta(q, k, v, do, want_out.to(dtype),
                                           want_lse, **kw)
    dk, dv, *dm = bdkv(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    want_dq = bdq_ref(*f32, want_lse, delta, **kw)
    want_dk, want_dv, *want_dm = bdkv_ref(*f32, want_lse, delta, **kw)
    if len(dm) != bool(masked) or len(want_dm) != bool(masked):
        raise AssertionError(f"{family} {name}: dmask returned "
                             f"{len(dm)} / {len(want_dm)} times, masked "
                             f"{masked}")
    pairs = {fwd.__name__: [(out, want_out)], bdq.__name__: [(dq, want_dq)],
             bdkv.__name__: [(dk, want_dk), (dv, want_dv)]}
    delta_err = 0.0
    if fused:
        pairs[bdq.__name__].append((dq_f, want_dq))
        delta_err = _row_rel_err(delta_f[:, None], delta[:, None])
    rel = {n: max(_tile_rel_err(g, w) for g, w in p) for n, p in pairs.items()}
    abs_err = {n: max((g.float() - w).abs().max().item() for g, w in p)
               for n, p in pairs.items()}
    dm_err = _row_rel_err(dm[0], want_dm[0]) if masked else 0.0
    lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)) \
        .max().item()
    log(f"[encoder] {family} {name} b={b} sq={sq} sk={sk} h={h} h_kv={h_kv} "
        f"d={d} {str(dtype)[6:]} causal={causal} window={window} "
        f"{'kmask' if masked else 'no mask'} dropout={ENC_DROPOUT}: "
        f"per-tile relative error "
        + ", ".join(f"{n} {rel[n]:.3e}" for n in rel)
        + f" (tol {ENC_REL_TOL[dtype]}); "
        + (f"dmask {dm_err:.3e} per row (tol {DMASK_REL_TOL[dtype]}); "
           if masked else "")
        + f"lse {lse_err:.3e} of its size (tol {LSE_REL_TOL})"
        + (f"; kernel 5's delta {delta_err:.3e} per row (tol "
           f"{DELTA_REL_TOL})" if fused else "")
        + (f"; lengths {masked}" if isinstance(masked, tuple) else "")
        + (f"; dropout at global coordinates {coords} (first batch row, "
           f"first head, global heads)" if coords is not None else ""))
    bad = [n for n in rel if not rel[n] <= ENC_REL_TOL[dtype]]
    if bad or not dm_err <= DMASK_REL_TOL[dtype] \
            or not lse_err <= LSE_REL_TOL or not delta_err <= DELTA_REL_TOL:
        raise AssertionError(f"{family} {name}: "
                             f"{bad or ['dmask, lse or delta']} disagree "
                             f"with the plain versions: {rel}, dmask "
                             f"{dm_err}, lse {lse_err}, delta {delta_err}")
    return abs_err, (q, k, v, do, want_out.to(dtype), want_lse, delta, kw)


def _family_fns(family, inputs, tag):
    """Each kernel of ``family`` on ``inputs``, for ``_time_graphs``:
    {"<wrapper>/<tag>": fn}. Kernel 5 runs as ``_HbFlashFn.backward``
    runs it, computing delta (``hb_bwd_dq_delta``); kernel 2's variants
    take delta given, as ``_FlashFn.backward`` runs them."""
    q, k, v, do, out, lse, delta, kw = inputs
    fwd, bdq, bdkv = FAMILIES[family][0]
    if bdq is hf.hb_bwd_dq:
        dq_fn = lambda i: hf.hb_bwd_dq_delta(q, k, v, do, out, lse, **kw)
    else:
        dq_fn = lambda i: bdq(q, k, v, do, lse, delta, **kw)
    return {f"{fwd.__name__}/{tag}": lambda i: fwd(q, k, v, **kw),
            f"{bdq.__name__}/{tag}": dq_fn,
            f"{bdkv.__name__}/{tag}": lambda i: bdkv(q, k, v, do, lse,
                                                     delta, **kw)}


def phase_encoder_kernels(layers):
    gen = torch.Generator("cuda").manual_seed(2)
    errs = dict.fromkeys((w.__name__ for w in HB_WRAPPERS), 0.0)
    inputs = {}
    for case in ENC_CASES:
        for family in FAMILIES:
            e, inputs[case[0], family] = _enc_check(case, family, gen)
            errs = {n: max(x, e.get(n, 0.0)) for n, x in errs.items()}
    # kernels 4-6 at BERT's shape, kernels 1-3 with the key-mask and
    # dropout variants on the same inputs, both families on the
    # dropout-only calls, and the yardstick: SDPA on [b, h, s, d] copies
    # with the same additive mask (bf16, [b, 1, 1, s]) and dropout 0.1,
    # its backward giving dQ, dK and dV together (timed only)
    q, k, v, do, out, lse, delta, kw = inputs["bert", "kernels 4-6"]
    library, contexts, fallbacks, minus = _sdpa_fns(
        q, k, v, do, attn_mask=kw["kmask"][:, None].to(q.dtype),
        dropout_p=ENC_DROPOUT)
    port = {}
    for family, case, tag in (("kernels 4-6", "bert", "bert"),
                              ("kernels 1-3", "bert", "variant"),
                              ("kernels 4-6", "dropout_only", "drop"),
                              ("kernels 1-3", "dropout_only", "drop")):
        port.update(_family_fns(family, inputs[case, family], tag))
    given = "hb_bwd_dq (delta given)/bert"
    port[given] = lambda i: hf.hb_bwd_dq(q, k, v, do, lse, delta, **kw)
    # the whole backward (5 computing delta, then 6) as _HbFlashFn.backward
    # runs it
    whole = "hb_bwd (5 with delta + 6)"
    port[whole] = _whole_backward(hf._HbFlashFn, q, k, v, out, lse, do,
                                  scale=1.0 / q.shape[-1] ** 0.5, **kw)
    times, how, eager = _timed(port, library, contexts, fallbacks, minus)
    med = {n: _med(xs) for n, xs in times.items()}
    kernels = {
        "hb_fwd": lambda: hf.hb_fwd_ref(q, k, v, **kw),
        "hb_bwd_dq": lambda: hf.hb_bwd_dq_delta_ref(q, k, v, do, out, lse,
                                                    **kw),
        "hb_bwd_dkv": lambda: hf.hb_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                **kw),
    }
    library = {"hb_fwd": _library(times, "sdpa_fwd", how),
               "hb_bwd_dq": _library(times, "sdpa_bwd", how),
               "hb_bwd_dkv": _library(times, "sdpa_bwd", how)}
    # kernel 5 is bound as the entry that also computes delta (reads O)
    stage = {"hb_fwd": "hb_fwd", "hb_bwd_dq": "hb_bwd_dq_delta",
             "hb_bwd_dkv": "hb_bwd_dkv"}
    rows = {}
    for (name, plain), w in zip(kernels.items(), FLASH_WRAPPERS):
        ms = med[f"{name}/bert"]
        plain_ms = _time_plain(plain, iters=3)
        lib_ms, lib_txt = library[name]
        bound_ms, bound_by, all_pairs_ms = _flash_bound(
            q, k, False, 0, stage[name], kmask=kw["kmask"])
        vq, vk, *_, vkw = inputs["bert", "kernels 1-3"]
        v_bound, v_by, _ = _flash_bound(vq, vk, False, 0, w.__name__,
                                        kmask=vkw["kmask"])
        dq_, dk_, *_ = inputs["dropout_only", "kernels 4-6"]
        d_bound, _, _ = _flash_bound(dq_, dk_, False, 0, stage[name])
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=errs[name])
        wn = w.__name__
        log(f"[encoder] {name} b64 s512 h12 d64 bf16 non-causal kmask "
            f"dropout 0.1: kernel_ms {_spread(times[name + '/bert'])} "
            + (f"(computing delta, as the backward runs it; given delta "
               f"{_spread(times[given])}) " if name == "hb_bwd_dq" else "")
            + f"(CUDA graphs of {ITERS} calls; median, min-max of {REPS}; "
            f"eager calls {_spread(eager[name + '/bert'])}) plain_ms "
            f"{plain_ms:.4f} library_ms {_ms(lib_ms)} (fastest SDPA "
            f"backend, graphs too: {lib_txt}) bound_ms {bound_ms:.5f} "
            f"({bound_by}; "
            f"{all_pairs_ms:.5f} counting every pair and all of K, V); {wn} "
            f"with a per-head kmask and dropout "
            f"{_spread(times[wn + '/variant'])} ms (bound {v_bound:.5f}, "
            f"{v_by}); dropout only, no mask: {name} "
            f"{_spread(times[name + '/drop'])} ms, {wn} "
            f"{_spread(times[wn + '/drop'])} ms (bound {d_bound:.5f}); "
            f"launches per train step = {layers} (layers)")
    lib_ms, lib_txt = library["hb_bwd_dq"]
    ms = med[whole]
    bound_ms, bound_by, _ = _flash_bound(q, k, False, 0, "hb_bwd",
                                         kmask=kw["kmask"])
    log(f"[encoder] {whole} b64 s512 h12 d64 bf16 non-causal kmask dropout "
        f"0.1, as _HbFlashFn.backward runs it: {_spread(times[whole])} ms "
        f"(CUDA graphs) against SDPA's whole backward {_ms(lib_ms)} "
        f"({lib_txt}): {ms / lib_ms if lib_ms else float('nan'):.2f}x; "
        f"bound_ms {bound_ms:.5f} ({bound_by}); eager calls "
        f"{_spread(eager[whole])} ms")
    for case in ERNIE_TIMED:
        _time_ernie_case(case, inputs[case, "kernels 4-6"])
    return rows


def _time_ernie_case(tag, inputs):
    """Kernels 4-6 at an ERNIE shape (the d-128 proxy, or phase 12's
    trunk; bf16 or fp16, dropout 0.1, no mask), and their whole backward
    as ``_HbFlashFn.backward`` runs it, beside SDPA with the same dropout
    and causality and the bound; returns each kernel's row (phase 9's
    JSON rows are BERT's)."""
    q, k, v, do, out, lse, delta, kw = inputs
    causal = kw["causal"]
    library, contexts, fallbacks, minus = _sdpa_fns(
        q, k, v, do, is_causal=causal, dropout_p=ENC_DROPOUT)
    port = _family_fns("kernels 4-6", inputs, tag)
    whole = f"hb_bwd/{tag}"
    port[whole] = _whole_backward(hf._HbFlashFn, q, k, v, out, lse, do,
                                  scale=1.0 / q.shape[-1] ** 0.5, **kw)
    times, how, eager = _timed(port, library, contexts, fallbacks, minus)
    lib = {"fwd": _library(times, "sdpa_fwd", how),
           "bwd": _library(times, "sdpa_bwd", how)}
    plain = {"hb_fwd": lambda: hf.hb_fwd_ref(q, k, v, **kw),
             "hb_bwd_dq": lambda: hf.hb_bwd_dq_delta_ref(q, k, v, do, out,
                                                         lse, **kw),
             "hb_bwd_dkv": lambda: hf.hb_bwd_dkv_ref(q, k, v, do, lse,
                                                     delta, **kw)}
    b, s, h, d = q.shape
    rows = {}
    for kern, stage in (("hb_fwd", "hb_fwd"), ("hb_bwd_dq", "hb_bwd_dq_delta"),
                        ("hb_bwd_dkv", "hb_bwd_dkv"), ("hb_bwd", "hb_bwd")):
        name = whole if kern == "hb_bwd" else f"{kern}/{tag}"
        lib_ms, lib_txt = lib["fwd" if kern == "hb_fwd" else "bwd"]
        bound_ms, bound_by, _ = _flash_bound(q, k, causal, 0, stage)
        ms = _med(times[name])
        fn = plain.get(kern)
        rows[kern] = dict(ms=ms, plain_ms=fn and _time_plain(fn, iters=3),
                          library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        plain_ms = _ms(rows[kern]["plain_ms"])
        log(f"[encoder] {tag} {kern} b{b} s{s} h{h} d{d} {str(q.dtype)[6:]} "
            f"{'causal' if causal else 'non-causal'} dropout {ENC_DROPOUT} "
            f"no mask: kernel_ms {_spread(times[name])} (CUDA graphs of "
            f"{ITERS} calls"
            + ("; computing delta, as the backward runs it" if kern ==
               "hb_bwd_dq" else "")
            + ("; 5 with delta + 6" if kern == "hb_bwd" else "")
            + f") plain_ms {plain_ms} library_ms {_ms(lib_ms)} ("
            + ("SDPA's forward" if kern == "hb_fwd" else
               "SDPA's whole backward")
            + f", fastest backend: {lib_txt}) "
            f"{ms / lib_ms if lib_ms else float('nan'):.2f}x; bound_ms "
            f"{bound_ms:.5f} ({bound_by}); eager calls "
            f"{_spread(eager[name])} ms")
    return rows


# -- phase 10 -----------------------------------------------------------------

BERT_BATCH, BERT_SEQ = 64, 512


def _mlm_batch(cfg, b, s, seed=0):
    """A right-padded batch: lengths uniform in 128..s, pad id past each
    length, MLM labels on 15 % of the real tokens and -100 elsewhere."""
    rng = np.random.RandomState(seed)
    mask = (np.arange(s)[None] < rng.randint(128, s + 1, b)[:, None])
    ids = np.where(mask, rng.randint(0, cfg.vocab_size, (b, s)),
                   cfg.pad_token_id)
    labels = np.where(mask & (rng.rand(b, s) < 0.15), ids, -100)
    return [torch.from_numpy(a.astype(np.int32)).to("cuda")
            for a in (ids, mask, labels)]


def bert_train_step():
    """bench_bert_mlm's step on the card: BERT-base MLM (random weights
    from a seed), bf16 O2 through ``amp.decorate``, dropout 0.1,
    ``AdamW(1e-4)`` with fp32 masters, ``TrainStep``. Returns (model,
    optimizer, step, the padded batch ``(ids, mask, labels)``)."""
    trandom.seed(0)
    cfg = BertConfig(max_position_embeddings=512, dtype="bfloat16")
    model = BertForMaskedLM(cfg, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    step = TrainStep(model, opt, lambda m, ids, mask, labels: m(
        ids, None, mask, labels))
    return model, opt, step, _mlm_batch(cfg, BERT_BATCH, BERT_SEQ)


def phase_bert_train(card):
    model, opt, step, (ids, mask, labels) = bert_train_step()
    cfg = model.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(ids, mask, labels)) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    for w in HB_WRAPPERS + FLASH_WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    timed = [step(ids, mask, labels) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in HB_WRAPPERS}
    flash_launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    losses += [float(x) for x in timed]
    layers, steps = cfg.num_hidden_layers, TIMED_STEPS
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not abs(losses[0] - np.log(cfg.vocab_size)) < 0.7:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln(vocab) = {np.log(cfg.vocab_size):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for n, p in model.named_parameters():
        # the pooler and the token-type table (no token types given) are
        # not on the loss's path: no gradient, so no master
        master = opt._master_weights.get(id(p))
        if p.dtype != torch.bfloat16 or p.grad is not None \
                and (master is None or master.dtype != torch.float32):
            raise AssertionError(f"{n}: {p.dtype} without an fp32 master")
    for name, n in launches.items():
        if n != layers * steps:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps, expected layers x steps = "
                                 f"{layers} x {steps}")
    if any(flash_launches.values()):
        raise AssertionError(f"the padded, dropped encoder reached kernels "
                             f"1-3: {flash_launches}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.clear_grad()
    ev[0].record()
    loss = model(ids, None, mask, labels)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    ms = wall / steps * 1e3
    tokens = BERT_BATCH * BERT_SEQ  # bench_bert_mlm counts batch x seq
    mfu = model.flops_per_token(BERT_SEQ) * tokens / (ms / 1e3) \
        / PEAK_OPS_PER_S[torch.bfloat16]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[bert] on {card}: {n_params / 1e6:.2f} M parameters, bf16 O2, "
        f"b{BERT_BATCH} x s{BERT_SEQ} ({int(mask.sum())} real tokens, "
        f"{int((labels >= 0).sum())} predicted); losses "
        f"{[round(x, 4) for x in losses]}; {ms:.2f} ms per step over "
        f"{steps} steps = {tokens / ms * 1e3:.0f} tokens/s, MFU {mfu:.4f} "
        f"(flops_per_token x tokens / time / 989e12); one step split: "
        f"forward {split[0]:.2f} ms, backward {split[1]:.2f} ms, optimizer "
        f"{split[2]:.2f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
        f"{launches}, kernels 1-3 {flash_launches}")
    del model, opt, step
    torch.cuda.empty_cache()
    return launches


# -- phase 11 -----------------------------------------------------------------

def train_tiny_bert(device, weights, steps=IDENTITY_STEPS):
    """The tiny fp32 BERT from ``weights`` trained ``steps`` AdamW steps
    (lr 1e-3, wd 0.01) on seeded padded batches, hidden dropout 0 (CPU
    and CUDA generators differ) and attention dropout 0.1 from seed words
    drawn alike on both sides (the hash does not depend on the device);
    returns the losses."""
    trandom.seed(0)
    cfg = BertConfig.tiny(hidden_dropout_prob=0.0)
    model = BertForMaskedLM(cfg, device=device)
    load_jax_weights(model, weights)
    step = TrainStep(model, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                  parameters=model.parameters()))
    losses = []
    for i in range(steps):
        rng = np.random.RandomState(200 + i)
        ids = rng.randint(0, cfg.vocab_size, (2, 32))
        mask = np.arange(32)[None] < np.array([[32], [21]])
        labels = np.where((rng.rand(2, 32) < 0.3) & mask, ids, -100)
        ids, mask, labels = (torch.from_numpy(a.astype(np.int32)).to(device)
                             for a in (ids, mask, labels))
        losses.append(float(step(ids, None, mask, labels)))
    return losses


def phase_bert_identity():
    seed_model = BertForMaskedLM(BertConfig.tiny(), device="cpu",
                                 generator=torch.Generator("cpu").manual_seed(0))
    weights = {n: p.detach().numpy() for n, p in seed_model.named_parameters()}
    for w in HB_WRAPPERS:
        w.launches = 0
    got = train_tiny_bert("cuda", weights)
    if min(w.launches for w in HB_WRAPPERS) <= 0:
        raise AssertionError("the card's tiny BERT never launched the "
                             "head-batched kernels")
    want = train_tiny_bert("cpu", weights)
    diff = max(abs(a - b) for a, b in zip(got, want))
    log(f"[bert-identity] {IDENTITY_STEPS} AdamW steps, fp32 tiny BERT, "
        f"padded, attention dropout 0.1: losses card "
        f"{[round(x, 6) for x in got]} vs CPU {[round(x, 6) for x in want]}: "
        f"max diff {diff:.3e} (tol {IDENTITY_LOSS_ATOL})")
    if not diff <= IDENTITY_LOSS_ATOL:
        raise AssertionError("the card's encoder run left the CPU's")


# -- phase 12 -----------------------------------------------------------------

# ERNIE-3.0 10B's widths (ErnieConfig() defaults: vocab 40000, trunk 4096
# with 64 heads of d 64 and ffn 16384, task branches 12 x 768 with 12
# heads and ffn 3072, max_pos 2048, type_vocab 4, gelu, dropout 0.1);
# the one reduction: the trunk's depth, 48 -> 8 layers
ERNIE = dict(num_hidden_layers=8, dtype="bfloat16")
ERNIE_BATCH, ERNIE_SEQ = 4, 1024
LAMB_STEPS = 2


def _ernie_batch(cfg, b, s, seed=0):
    """ernie_bench.py's batch: ids, MLM labels on 15 % of the tokens
    (-100 elsewhere) and the ids as LM labels, from numpy seed 0."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (b, s))
    mlm = np.where(rng.rand(b, s) < 0.15, ids, -100)
    return [torch.from_numpy(a.astype(np.int32)).to("cuda")
            for a in (ids, mlm, ids)]


def _ernie_schedule():
    return lr.LinearWarmup(lr.PolynomialDecay(1e-4, decay_steps=100),
                           warmup_steps=2, start_lr=1e-5, end_lr=1e-4)


def ernie_train_step():
    """ernie_bench.py's step on the card at the 10B widths (trunk 8 of
    48): ``ErnieForPretraining`` (random weights from a seed), every
    parameter bf16 (``amp.decorate`` O2), dropout 0.1, ``AdamW`` with fp32
    masters under ``LinearWarmup(PolynomialDecay)``, ``TrainStep``.
    Returns (model, optimizer, scheduler, step, batch ``(ids, mlm_labels,
    lm_labels)``)."""
    trandom.seed(0)
    cfg = ErnieConfig(**ERNIE)
    model = ErnieForPretraining(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    sched = _ernie_schedule()
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                multi_precision=True)
    step = TrainStep(model, opt, lambda m, ids, mlm, lm: m(
        ids, mlm_labels=mlm, lm_labels=lm))
    return model, opt, sched, step, _ernie_batch(cfg, ERNIE_BATCH,
                                                 ERNIE_SEQ)


def _split_step(model, opt, batch):
    """One train step split into forward, backward and optimizer by CUDA
    events, as ``TrainStep`` runs it; returns (loss, [ms of each])."""
    ids, mlm, lm = batch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.clear_grad()
    ev[0].record()
    loss = model(ids, mlm_labels=mlm, lm_labels=lm)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    torch.cuda.synchronize()
    return float(loss.detach()), [ev[i].elapsed_time(ev[i + 1])
                                  for i in range(3)]


def phase_ernie_train(card):
    t_phase = time.perf_counter()
    model, opt, sched, step, batch = ernie_train_step()
    cfg = model.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(WARMUP_STEPS):
        losses.append(float(step(*batch)))
        sched.step()
    torch.cuda.synchronize()
    for w in HB_WRAPPERS + FLASH_WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    timed = []
    for _ in range(TIMED_STEPS):
        timed.append(step(*batch))
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in HB_WRAPPERS}
    flash_launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    losses += [float(x) for x in timed]
    steps = TIMED_STEPS
    # each step: the trunk twice (NLU bidirectional, NLG causal) and the
    # two branches, one attention call a layer each
    per_step = 2 * cfg.num_hidden_layers + 2 * cfg.num_task_layers
    want_loss = 2 * np.log(cfg.vocab_size)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not abs(losses[0] - want_loss) < 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"2 ln(vocab) = {want_loss:.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for n, p in model.named_parameters():
        # the token-type table (no token types given) has no gradient
        master = opt._master_weights.get(id(p))
        if p.dtype != torch.bfloat16 or p.grad is not None \
                and (master is None or master.dtype != torch.float32):
            raise AssertionError(f"{n}: {p.dtype} without an fp32 master")
    for name, n in launches.items():
        if n != per_step * steps:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps, expected (2 x {cfg.num_hidden_layers}"
                                 f" + 2 x {cfg.num_task_layers}) x {steps}")
    if any(flash_launches.values()):
        raise AssertionError(f"the dropped encoder reached kernels 1-3: "
                             f"{flash_launches}")
    loss, split = _split_step(model, opt, batch)
    sched.step()
    peak = torch.cuda.max_memory_allocated()
    ms = wall / steps * 1e3
    tokens = ERNIE_BATCH * ERNIE_SEQ
    fpt = model.flops_per_token(ERNIE_SEQ)
    mfu = fpt * tokens / (ms / 1e3) / PEAK_OPS_PER_S[torch.bfloat16]
    n_params = sum(p.numel() for p in model.parameters())
    n_trunk = sum(p.numel() for n, p in model.named_parameters()
                  if n.startswith("ernie.encoder."))
    # the same parameters under Lamb: AdamW's masters and moments go
    # first, so the two optimizers' states are never held together
    adamw_ms = split[2]
    del opt, step
    gc.collect()
    torch.cuda.empty_cache()
    lamb = Lamb(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    lamb_split = [_split_step(model, lamb, batch) for _ in range(LAMB_STEPS)]
    lamb_losses = [x for x, _ in lamb_split]
    if not all(np.isfinite(lamb_losses)):
        raise AssertionError(f"non-finite Lamb loss: {lamb_losses}")
    log(f"[ernie] on {card}: ERNIE-3.0 10B widths, trunk "
        f"{cfg.num_hidden_layers} of 48 layers, {n_params / 1e9:.3f} B "
        f"parameters ({n_trunk / 1e9:.3f} B trunk), bf16 O2, dropout 0.1, "
        f"b{ERNIE_BATCH} x s{ERNIE_SEQ}; losses "
        f"{[round(x, 4) for x in losses + [loss]]} (2 ln(vocab) = "
        f"{want_loss:.3f}); {ms:.2f} ms per step over {steps} steps = "
        f"{tokens / ms * 1e3:.0f} tokens/s, MFU {mfu:.4f} "
        f"(flops_per_token({ERNIE_SEQ}) = {fpt / 1e9:.3f} G x tokens / time "
        f"/ 989e12); one step split: forward {split[0]:.2f} ms, backward "
        f"{split[1]:.2f} ms, optimizer (AdamW) {adamw_ms:.2f} ms; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB; launches {launches} "
        f"(= {per_step} a step), kernels 1-3 {flash_launches}; Lamb "
        f"(multi_precision) over the same parameters, {LAMB_STEPS} steps: "
        f"losses {[round(x, 4) for x in lamb_losses]}, optimizer "
        f"{[round(sp[2], 2) for _, sp in lamb_split]} ms (the first "
        f"allocates its states) against AdamW's {adamw_ms:.2f} ms; "
        f"max_memory_allocated then {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; phase {time.perf_counter() - t_phase:.1f} s")
    del model, lamb
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phase 13 -----------------------------------------------------------------

ERNIE_RESUME_AT = 5


def _tiny_ernie_schedule():
    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=10),
                           warmup_steps=3, start_lr=1e-4, end_lr=1e-3)


def _tiny_ernie_batch(cfg, i, device):
    """Step ``i``'s padded batch: batch row 1 keeps 21 of 32 tokens, MLM
    labels on 30 % of the real tokens, LM labels on all of them."""
    rng = np.random.RandomState(300 + i)
    ids = rng.randint(0, cfg.vocab_size, (2, 32))
    mask = np.arange(32)[None] < np.array([[32], [21]])
    mlm = np.where((rng.rand(2, 32) < 0.3) & mask, ids, -100)
    lm = np.where(mask, ids, -100)
    return [torch.from_numpy(a.astype(np.int32)).to(device)
            for a in (ids, mask, mlm, lm)]


def _tiny_ernie(device, weights):
    """The tiny fp32 ERNIE from ``weights`` (hidden dropout 0: CPU and
    CUDA generators differ; attention dropout 0.1 from seed words drawn
    alike on both sides), ``Lamb(lamb_weight_decay=0.01)`` under
    ``LinearWarmup(CosineAnnealingDecay)``, and its ``TrainStep``."""
    cfg = ErnieConfig.tiny(hidden_dropout_prob=0.0)
    model = ErnieForPretraining(cfg, device=device)
    load_jax_weights(model, weights)
    sched = _tiny_ernie_schedule()
    opt = Lamb(learning_rate=sched, lamb_weight_decay=0.01,
               parameters=model.named_parameters())
    step = TrainStep(model, opt, lambda m, ids, mask, mlm, lm: m(
        ids, None, mask, mlm, lm))
    return model, opt, sched, step


def train_tiny_ernie(device, weights, steps=IDENTITY_STEPS, start=0,
                     state=None):
    """``steps`` steps of the tiny ERNIE from step ``start``, after
    loading ``state`` (model, optimizer) if given; returns (losses,
    model, optimizer). The seed words follow :func:`trandom.seed` (the
    caller's)."""
    model, opt, sched, step = _tiny_ernie(device, weights)
    if state is not None:
        model.load_state_dict(state[0])
        opt.set_state_dict(state[1])
    losses = []
    for i in range(start, start + steps):
        losses.append(float(step(*_tiny_ernie_batch(model.config, i,
                                                    device))))
        sched.step()
    return losses, model, opt


def phase_ernie_identity():
    t_phase = time.perf_counter()
    seed_model = ErnieForPretraining(
        ErnieConfig.tiny(), device="cpu",
        generator=torch.Generator("cpu").manual_seed(0))
    weights = {n: p.detach().numpy() for n, p in seed_model.named_parameters()}
    for w in HB_WRAPPERS:
        w.launches = 0
    trandom.seed(0)
    got, gm, gopt = train_tiny_ernie("cuda", weights)
    if min(w.launches for w in HB_WRAPPERS) <= 0:
        raise AssertionError("the card's tiny ERNIE never launched the "
                             "head-batched kernels")
    trandom.seed(0)
    want, _, _ = train_tiny_ernie("cpu", weights)
    diff = max(abs(a - b) for a, b in zip(got, want))
    log(f"[ernie-identity] {IDENTITY_STEPS} Lamb steps under LinearWarmup("
        f"CosineAnnealingDecay), fp32 tiny ERNIE, padded, attention "
        f"dropout 0.1: losses card {[round(x, 6) for x in got]} vs CPU "
        f"{[round(x, 6) for x in want]}: max diff {diff:.3e} (tol "
        f"{IDENTITY_LOSS_ATOL})")
    if not diff <= IDENTITY_LOSS_ATOL:
        raise AssertionError("the card's ERNIE run left the CPU's")
    # resume: 5 steps, state_dict into a fresh model, optimizer and
    # scheduler, 5 more; the seed words run on from the first half
    trandom.seed(0)
    first, qm, qopt = train_tiny_ernie("cuda", weights, ERNIE_RESUME_AT)
    state = ({n: t.clone() for n, t in qm.state_dict().items()},
             qopt.state_dict())
    del qm, qopt
    second, rm, ropt = train_tiny_ernie(
        "cuda", weights, IDENTITY_STEPS - ERNIE_RESUME_AT,
        start=ERNIE_RESUME_AT, state=state)
    same_params = all(torch.equal(p, q) for p, q in
                      zip(gm.parameters(), rm.parameters()))
    same_states = True  # (the token-type table has no gradient: no states)
    for p, q in zip(gm.parameters(), rm.parameters()):
        sp = gopt._accumulators.get(id(p), {})
        sq = ropt._accumulators.get(id(q), {})
        same_states &= sp.keys() == sq.keys() and all(
            torch.equal(v, sq[k]) for k, v in sp.items())
    log(f"[ernie-identity] resumed from state_dict after "
        f"{ERNIE_RESUME_AT} steps: losses {[round(x, 6) for x in first + second]};"
        f" bit-identical to the uninterrupted run: losses "
        f"{first + second == got}, parameters {same_params}, Lamb states "
        f"{same_states}, rate {ropt.get_lr() == gopt.get_lr()}")
    if first + second != got or not same_params or not same_states \
            or ropt.get_lr() != gopt.get_lr():
        raise AssertionError("the resumed run left the uninterrupted one")
    # fine-tuning head in eval: no mask, no dropout -> kernels 1-3
    cls_cpu = ErnieForSequenceClassification(
        ErnieConfig.tiny(), num_classes=3, device="cpu",
        generator=torch.Generator("cpu").manual_seed(1))
    cls_weights = {n: p.detach().numpy()
                   for n, p in cls_cpu.named_parameters()}
    cls_card = ErnieForSequenceClassification(ErnieConfig.tiny(),
                                              num_classes=3, device="cuda")
    load_jax_weights(cls_card, cls_weights)
    cls_cpu.eval()
    cls_card.eval()
    ids = _tiny_ernie_batch(cls_cpu.config, 99, "cpu")[0]
    for w in FLASH_WRAPPERS + HB_WRAPPERS:
        w.launches = 0
    with torch.no_grad():
        logits = cls_card(ids.to("cuda")).cpu()
        want_logits = cls_cpu(ids)
    ldiff = (logits - want_logits).abs().max().item()
    flash_n = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    hb_n = sum(w.launches for w in HB_WRAPPERS)
    log(f"[ernie-identity] ErnieForSequenceClassification eval, fp32 tiny, "
        f"no mask: logits max diff card vs CPU {ldiff:.3e} (tol "
        f"{IDENTITY_LOSS_ATOL}); kernels 1-3 {flash_n}, kernels 4-6 {hb_n}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if not ldiff <= IDENTITY_LOSS_ATOL or flash_n["flash_fwd"] \
            != cls_card.config.num_hidden_layers \
            + cls_card.config.num_task_layers or hb_n:
        raise AssertionError("the card's classification logits or routing "
                             "left the CPU's")


# -- phase 14 -----------------------------------------------------------------

# bench.py's headline step (build_headline_trainstep) on the port: the
# 0.44B Llama in bf16 with fp32 masters, AdamW(1e-4), donate=True
GRAPH_LOSS_RTOL = 1e-3   # bf16: eager and graphs round alike, summed alike
# the tiny fp32 run on graphs against eager: the captured AdamW reads its
# rate and bias corrections from device scalars and multiplies by them
# as separate ops (a tensor scalar has no fused alpha= form), one
# rounding more than the eager kernels' FMA; losses held to 1e-6
# relative, parameters to 1e-5 of each tensor's largest value
TINY_GRAPH_LOSS_RTOL, TINY_GRAPH_PARAM_TOL = 1e-6, 1e-5
CE_CHUNK = 4096  # 32000 = 7 x 4096 + 3328: a ragged last chunk


def _headline(chunk=0, **kw):
    """bench.py's build_headline_trainstep on the port (``ce_chunk_size``
    ``chunk``); the weights from one seed, so every call builds the same
    model. Returns (model, opt, step)."""
    cfg = LlamaConfig(**dict(TRAIN, ce_chunk_size=chunk))
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    step = TrainStep(model, opt, lambda m, i, l: m(i, l), donate=True, **kw)
    return model, opt, step


def _release():
    """Free the graphs and cached memory of a finished run (after the
    caller has dropped its models and steps)."""
    exec_cache.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _run_steps(call, batch, warmup=WARMUP_STEPS, timed=TIMED_STEPS):
    """``warmup`` then ``timed`` calls of ``call(*batch)``; returns (the
    losses, ms a timed step by the host clock around them, peak memory
    in GiB, the kernel launches of the timed steps)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(call(*batch)) for _ in range(warmup)]
    torch.cuda.synchronize()
    for w in FLASH_WRAPPERS:
        w.launches = 0
    t0 = time.perf_counter()
    out = [call(*batch) for _ in range(timed)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
    losses += [float(x) for x in out]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    return losses, ms, torch.cuda.max_memory_allocated() / 2**30, launches


def _eager_call(model, opt):
    def call(ids, labels):
        opt.clear_grad()
        loss = model(ids, labels)
        loss.backward()
        opt.step()
        return loss.detach()
    return call


def _tiny_graph_identity(weights):
    """10 steps of the tiny fp32 Llama on graphs and eagerly, from the
    same weights; returns (graph losses, eager losses, the largest
    parameter difference over each tensor's max)."""
    runs = []
    for graphs in (True, False):
        cfg = LlamaConfig.tiny(num_hidden_layers=2)
        model = LlamaForCausalLM(cfg, device="cuda")
        load_jax_weights(model, weights)
        opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        call = TrainStep(model, opt) if graphs else _eager_call(model, opt)
        losses = []
        for i in range(IDENTITY_STEPS):
            rng = np.random.RandomState(100 + i)
            ids, labels = (torch.from_numpy(rng.randint(
                0, cfg.vocab_size, (2, 16)).astype(np.int32)).cuda()
                for _ in range(2))
            losses.append(float(call(ids, labels)))
        runs.append((losses, model))
    (gl, gm), (el, em) = runs
    pdiff = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(gm.parameters(), em.parameters()))
    return gl, el, pdiff


def _nan_check_pair(weights):
    """The tiny fp32 Llama with nan_check on the card and on the CPU: two
    good steps, then a weight set to inf; returns the two errors' (step,
    leaf, kind) and whether the card's parameters were left as they
    were."""
    from paddle_tpu_torch.monitor.numerics import NonFiniteError

    found, intact = [], None
    for device in ("cuda", "cpu"):
        cfg = LlamaConfig.tiny(num_hidden_layers=2)
        model = LlamaForCausalLM(cfg, device=device)
        load_jax_weights(model, weights)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        step = TrainStep(model, opt, nan_check=True)
        for i in range(3):
            rng = np.random.RandomState(200 + i)
            ids, labels = (torch.from_numpy(rng.randint(
                0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(device)
                for _ in range(2))
            if i == 2:
                with torch.no_grad():
                    model.llama.layers[1].mlp.down_proj.weight[3, 5] = \
                        float("inf")
                before = [p.detach().clone() for p in model.parameters()]
                states = [v.clone() for st in opt._accumulators.values()
                          for v in st.values()]
            try:
                step(ids, labels)
            except NonFiniteError as e:
                found.append((e.step, e.leaf, e.kind))
                if device == "cuda":
                    after = [v for st in opt._accumulators.values()
                             for v in st.values()]
                    intact = all(torch.equal(a, b) for a, b in zip(
                        before, model.parameters())) and all(
                        torch.equal(a, b) for a, b in zip(states, after)) \
                        and opt._global_step == 2
    return found, intact


def phase_train_graphs(card):
    """The headline step eagerly and on CUDA graphs, chunked CE, the
    AsyncStepper and nan_check."""
    t_phase = time.perf_counter()
    ids, labels = _train_batch(TRAIN["vocab_size"], TRAIN_BATCH, TRAIN_SEQ)
    layers = TRAIN["num_hidden_layers"]
    model, opt, _ = _headline()
    e_loss, e_ms, e_peak, _ = _run_steps(_eager_call(model, opt),
                                         (ids, labels))
    del model, opt
    _release()
    model, opt, step = _headline()
    exec_cache.clear()
    g_loss, g_ms, g_peak, g_launch = _run_steps(step, (ids, labels))
    ma = step.memory_analysis(ids, labels)
    stats = exec_cache.stats()
    log(f"[graphs] headline step on {card}: eager {e_ms:.2f} ms a step "
        f"(peak {e_peak:.3f} GiB), CUDA graphs {g_ms:.2f} ms a step (peak "
        f"{g_peak:.3f} GiB), {TIMED_STEPS} timed steps after "
        f"{WARMUP_STEPS}; losses eager {[round(x, 5) for x in e_loss]} "
        f"graphs {[round(x, 5) for x in g_loss]}; kernels 1-3 a replay "
        f"{ {k: v / TIMED_STEPS for k, v in g_launch.items()} }; "
        f"memory_analysis {ma._asdict()}; exec_cache.stats() {stats}; "
        f"compiled_count {step.compiled_count}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(g_loss, e_loss))
    if not rel <= GRAPH_LOSS_RTOL:
        raise AssertionError(f"graph losses left the eager ones: {rel}")
    if any(n != layers * TIMED_STEPS for n in g_launch.values()) \
            or stats["captures"] != 1 or step.compiled_count != 1:
        raise AssertionError(f"not one capture and {layers} launches of "
                             f"each kernel a replay: {g_launch}, {stats}")
    del model, opt, step
    _release()
    model, opt, step = _headline(nan_check=True)
    n_loss, n_ms, n_peak, _ = _run_steps(step, (ids, labels))
    nrel = max(abs(a - b) / abs(b) for a, b in zip(n_loss, g_loss))
    log(f"[graphs] nan_check=True on graphs (the update's copies, the "
        f"flag over loss, gradients, parameters, masters and states, one "
        f"host read a step): {n_ms:.2f} ms a step against {g_ms:.2f} "
        f"without ({n_ms - g_ms:+.2f} ms), peak {n_peak:.3f} GiB against "
        f"{g_peak:.3f}; losses within {nrel:.3e} relative of the plain "
        f"graph's")
    if not nrel <= GRAPH_LOSS_RTOL:
        raise AssertionError("the nan_check step's losses left the plain "
                             "graph's")
    del model, opt, step
    _release()
    seed_model = LlamaForCausalLM(
        LlamaConfig.tiny(num_hidden_layers=2), device="cpu",
        generator=torch.Generator("cpu").manual_seed(5))
    weights = {n: p.detach().numpy() for n, p in seed_model.named_parameters()}
    gl, el, pdiff = _tiny_graph_identity(weights)
    lrel = max(abs(a - b) / abs(b) for a, b in zip(gl, el))
    log(f"[graphs] tiny fp32 Llama, {IDENTITY_STEPS} AdamW steps with "
        f"clipping: graphs {gl} vs eager {el}: bit for bit {gl == el}, "
        f"losses within {lrel:.3e} relative (tol {TINY_GRAPH_LOSS_RTOL}), "
        f"parameters within {pdiff:.3e} of their max (tol "
        f"{TINY_GRAPH_PARAM_TOL}; the captured AdamW multiplies by its "
        f"device-side rate as a separate op, one rounding more than the "
        f"eager FMA)")
    if not (lrel <= TINY_GRAPH_LOSS_RTOL and pdiff <= TINY_GRAPH_PARAM_TOL):
        raise AssertionError("the tiny model on graphs left the eager run")
    model, opt, step = _headline(chunk=CE_CHUNK)
    c_loss, c_ms, c_peak, _ = _run_steps(step, (ids, labels))
    crel = abs(c_loss[0] - g_loss[0]) / abs(g_loss[0])
    log(f"[graphs] chunked CE (ce_chunk_size {CE_CHUNK}, ragged tail "
        f"{TRAIN['vocab_size'] % CE_CHUNK}) on graphs: {c_ms:.2f} ms a step, "
        f"peak {c_peak:.3f} GiB, against plain CE {g_ms:.2f} ms and "
        f"{g_peak:.3f} GiB; step-1 loss {c_loss[0]:.6f} vs {g_loss[0]:.6f} "
        f"({crel:.3e} relative, tol {GRAPH_LOSS_RTOL}); losses "
        f"{[round(x, 5) for x in c_loss]}")
    if not crel <= GRAPH_LOSS_RTOL:
        raise AssertionError("chunked CE's first loss left the plain one")
    del model, opt, step
    _release()
    model, opt, step = _headline()
    stepper = AsyncStepper(step, max_in_flight=2)
    a_loss, a_ms, _, _ = _run_steps(stepper, (ids, labels))
    stepper.drain()
    arel = max(abs(a - b) / abs(b) for a, b in zip(a_loss, g_loss))
    log(f"[graphs] AsyncStepper(max_in_flight=2): {a_ms:.2f} ms a step, "
        f"host blocked {stepper.host_blocked_s * 1e3:.2f} ms in all; losses "
        f"equal to TrainStep's: {a_loss == g_loss} (max relative diff "
        f"{arel:.3e}, tol {TINY_GRAPH_LOSS_RTOL})")
    if not arel <= TINY_GRAPH_LOSS_RTOL:
        raise AssertionError("AsyncStepper's losses left TrainStep's")
    del model, opt, step, stepper
    _release()
    found, intact = _nan_check_pair(weights)
    log(f"[graphs] nan_check, a weight set to inf at step 3: card "
        f"{found[0] if found else None}, CPU "
        f"{found[1] if len(found) > 1 else None}; the card's parameters, "
        f"states and step count intact: {intact}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if len(found) != 2 or found[0] != found[1] or not intact:
        raise AssertionError("nan_check did not name the CPU's leaf or did "
                             "not leave the parameters intact")
    _release()
    return {"eager_ms": e_ms, "graph_ms": g_ms}


# -- phase 15 -----------------------------------------------------------------

O1_STEPS = 5


def _fp16_flash_check(gen):
    """Kernels 1-3 in float16 at the headline shape against their plain
    versions (1e-2 per 64-row tile, as bf16), each called twice
    (bit-identical). Returns (errors, inputs)."""
    b, s, h, d = 8, 1024, 12, 128
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(torch.float16) for _ in range(4))
    kw = dict(causal=True, window=0)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    out2, lse2 = fa.flash_fwd(q, k, v, **kw)
    f32 = [t.float() for t in (q, k, v, do)]
    want_out, want_lse = fa.flash_fwd_ref(*f32[:3], **kw)
    out_h = want_out.to(q.dtype)
    dq, delta = fa.flash_bwd_dq_delta(q, k, v, do, out_h, want_lse, **kw)
    dq2, delta2 = fa.flash_bwd_dq_delta(q, k, v, do, out_h, want_lse, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, want_lse, delta, **kw)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    want_delta = fa._delta(do, out_h)
    want_dq = fa.flash_bwd_dq_ref(*f32, want_lse, want_delta, **kw)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(*f32, want_lse, want_delta, **kw)
    pairs = {"flash_fwd": [(out, want_out)], "flash_bwd_dq": [(dq, want_dq)],
             "flash_bwd_dkv": [(dk, want_dk), (dv, want_dv)]}
    rel = {n: max(_tile_rel_err(g, w) for g, w in p) for n, p in pairs.items()}
    errs = {n: max((g.float() - w).abs().max().item() for g, w in p)
            for n, p in pairs.items()}
    same = all(torch.equal(a, b) for a, b in (
        (out, out2), (lse, lse2), (dq, dq2), (delta, delta2), (dk, dk2),
        (dv, dv2)))
    lse_err = (lse - want_lse).abs().max().item()
    log(f"[fp16] kernels 1-3, float16 b8 s1024 h12 d128 causal: per-tile "
        f"relative error {rel} (tol {FLASH_REL_TOL}); max_abs_err {errs}; "
        f"lse {lse_err:.3e} (tol {LSE_ATOL}); two calls bit-identical "
        f"{same}")
    if any(r > FLASH_REL_TOL for r in rel.values()) or not same \
            or not lse_err <= LSE_ATOL:
        raise AssertionError("a float16 kernel disagrees with its plain "
                             "version or with itself")
    return errs, (q, k, v, do, out_h, want_lse, delta)


def phase_o1_fp16(card, smi):
    """15a kernels 1-3 in float16 at the headline shape and the 0.44B
    Llama under O1 float16 and bfloat16; 15b BERT-base and 15c
    Transformer-base training under float16; 15d every float16 kernel
    against its plain version, timed. Returns (each wrapper's float16
    launches over 15a-15c's training steps, the float16 rows by kernel
    name)."""
    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(7)
    errs, (q, k, v, do, out, lse, delta) = _fp16_flash_check(gen)
    kw = dict(causal=True, window=0)
    kernels = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_ref(q, k, v, **kw)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq_delta(q, k, v, do, out, lse, **kw),
            lambda: fa.flash_bwd_dq_delta_ref(q, k, v, do, out, lse, **kw)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
            lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)),
    }
    library, contexts, fallbacks, minus = _sdpa_fns(q, k, v, do,
                                                    is_causal=True)
    port = {n: lambda i, f=kern: f() for n, (kern, _) in kernels.items()}
    times, how, _ = _timed(port, library, contexts, fallbacks, minus)
    lib = {"flash_fwd": _library(times, "sdpa_fwd", how),
           "flash_bwd_dq": _library(times, "sdpa_bwd", how)}
    lib["flash_bwd_dkv"] = lib["flash_bwd_dq"]
    rows = {}
    for name, (_, plain) in kernels.items():
        bound_ms, bound_by, _ = _flash_bound(
            q, k, True, 0, name + ("_delta" if name == "flash_bwd_dq" else ""))
        lib_ms, lib_txt = lib[name]
        plain_ms = _time_plain(plain, iters=5)
        rows[name] = dict(ms=_med(times[name]), plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=errs[name])
        log(f"[fp16] {name} float16 b8 s1024 h12 d128 causal: kernel_ms "
            f"{_spread(times[name])} (CUDA graphs of {ITERS} calls) plain_ms "
            f"{plain_ms:.4f} library_ms {_ms(lib_ms)} "
            f"(SDPA in float16, fastest backend: {lib_txt}) bound_ms "
            f"{bound_ms:.5f} ({bound_by}) max_abs_err {errs[name]:.3e}")
    del q, k, v, do, out, lse, delta, library
    _release()
    cfg = LlamaConfig(**dict(TRAIN, dtype="float32"))
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    ids, labels = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    runs = {}
    for dtype, use_scaler in (("float16", True), ("bfloat16", False)):
        losses, scales, times_ = [], [], []
        for w in FLASH_WRAPPERS:
            w.launches = 0
        for _ in range(O1_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp.auto_cast(level="O1", dtype=dtype):
                loss = model(ids, labels)
            if use_scaler:
                scaler.minimize(opt, scaler.scale(loss))
                scales.append(scaler.get_loss_scaling())
            else:
                loss.backward()
                opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            torch.cuda.synchronize()
            times_.append((time.perf_counter() - t0) * 1e3)
        launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
        runs[dtype] = (losses, scales, times_, launches)
        log(f"[o1] {dtype} O1 on {card}, fp32 parameters"
            + (", GradScaler(init_loss_scaling=2**15).minimize"
               if use_scaler else ", no scaler")
            + f": losses {[round(x, 5) for x in losses]}; scale after each "
            f"step {scales or 'n/a'}; ms a step {[round(t, 2) for t in times_]}"
            f" (median {_med(times_[1:]):.2f}); kernels 1-3 a step "
            f"{ {k_: v_ / O1_STEPS for k_, v_ in launches.items()} }")
        if not all(np.isfinite(losses)) or any(
                n != cfg.num_hidden_layers * O1_STEPS
                for n in launches.values()):
            raise AssertionError(f"O1 {dtype}: non-finite losses or not "
                                 f"{cfg.num_hidden_layers} launches a step")
    if not abs(runs["float16"][0][0] - np.log(cfg.vocab_size)) < 0.7:
        raise AssertionError("the O1 float16 loss does not start near "
                             "ln(vocab)")
    del model, opt
    _release()
    fp16_launches = dict(runs["float16"][3])
    for got in (_bert_fp16_15b(card), _transformer_fp16_15c(card)):
        for n, x in got.items():
            fp16_launches[n] = fp16_launches.get(n, 0) + x
    rows.update(_fp16_kernels_15d(smi))
    log(f"[o1] phase {time.perf_counter() - t_phase:.1f} s; float16 "
        f"launches over 15a-15c's training steps {fp16_launches}")
    return fp16_launches, rows


BERT_O1_STEPS, BERT_O2_STEPS = 5, 3


def _bert_fp16_15b(card):
    """15b: BERT-base MLM at b64 x s512 (phase 10's padded batch,
    dropout 0.1, fp32 parameters from a seed) under ``auto_cast(O1,
    float16)`` through ``GradScaler(2**15).minimize``, then
    ``amp.decorate`` O2 float16 (parameters float16, fp32 masters) under
    ``auto_cast(O2, float16)``: losses, the scale, ms a step, peak
    memory; kernels 4-6 once a layer a step, kernels 1-3 never. Returns
    the launches over both runs."""
    trandom.seed(0)
    cfg = BertConfig(max_position_embeddings=512)
    model = BertForMaskedLM(cfg, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    ids, mask, labels = _mlm_batch(cfg, BERT_BATCH, BERT_SEQ)
    layers = cfg.num_hidden_layers
    total = dict.fromkeys(_launch_counts(), 0)
    for level, steps in (("O1", BERT_O1_STEPS), ("O2", BERT_O2_STEPS)):
        if level == "O2":
            model, opt = amp.decorate(model, opt, level="O2",
                                      dtype="float16")
        _reset_launches()
        losses, scales, ms = [], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp.auto_cast(level=level, dtype="float16"):
                loss = model(ids, None, mask, labels)
            scaler.minimize(opt, scaler.scale(loss))
            opt.clear_grad()
            losses.append(float(loss))
            scales.append(scaler.get_loss_scaling())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        total = {n: total[n] + launches[n] for n in total}
        dtypes = sorted({str(p.dtype)[6:] for p in model.parameters()})
        log(f"[o1] 15b BERT-base MLM {level} float16 on {card}, parameters "
            f"{dtypes}, b{BERT_BATCH} x s{BERT_SEQ} ({int(mask.sum())} real "
            f"tokens), dropout 0.1, GradScaler(init_loss_scaling=2**15): "
            f"losses {[round(x, 5) for x in losses]} (ln(vocab) "
            f"{np.log(cfg.vocab_size):.4f}); scale after each step "
            f"{scales}; ms a step {[round(t, 2) for t in ms]} (median of "
            f"steps 2-{steps} {_med(ms[1:]):.2f}); peak "
            f"{peak:.3f} GiB; launches a step "
            f"{ {n: x / steps for n, x in launches.items() if x} }")
        want = {w.__name__: layers * steps for w in HB_WRAPPERS}
        if not all(np.isfinite(losses)) \
                or any(launches[n] != want.get(n, 0) for n in launches):
            raise AssertionError(f"15b {level}: losses {losses}, launches "
                                 f"{launches} (want {want}, no others)")
        if level == "O1" and not abs(losses[0] - np.log(cfg.vocab_size)) \
                < 0.7:
            raise AssertionError(f"15b: the first loss {losses[0]} is not "
                                 f"near ln(vocab)")
    del model, opt
    _release()
    return {n: x for n, x in total.items() if x}


def _transformer_fp16_15c(card):
    """15c: phase 25a's Transformer-base and copy batch (fp32 parameters,
    dropout 0.1) under ``auto_cast(O1, float16)`` through
    ``GradScaler(2**15).minimize``, 5 steps: losses, ms a step, and the
    tile mode (kernels 1-3 and the class pass) once a decoder layer a
    step, kernels 4-6 once a layer a step, as 25a launches them in bf16.
    Returns the launches."""
    trandom.seed(0)
    model = _seq2seq(T_VOCAB, "cuda", torch.Generator("cuda").manual_seed(25),
                     **T_BASE)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    batch = _copy_batch(T_VOCAB, T_BATCH, T_SRC, T_TGT, "cuda", lo=128)
    _reset_launches()
    _reset_tile_launches()
    losses, scales, ms = [], [], []
    for _ in range(O1_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with amp.auto_cast(level="O1", dtype="float16"):
            loss = model(*batch)
        scaler.minimize(opt, scaler.scale(loss))
        opt.clear_grad()
        losses.append(float(loss))
        scales.append(scaler.get_loss_scaling())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    tile, launched = _tile_launches(), _launch_counts()
    dec, enc = T_BASE["num_decoder_layers"], T_BASE["num_encoder_layers"]
    want_tile = {n: dec * O1_STEPS for n in TILE_NAMES}
    want_hb = {w.__name__: (enc + dec) * O1_STEPS for w in HB_WRAPPERS}
    log(f"[o1] 15c Transformer-base O1 float16 on {card}, fp32 parameters, "
        f"GradScaler(init_loss_scaling=2**15), b{T_BATCH} x src {T_SRC} x "
        f"tgt {T_TGT}: losses {[round(x, 5) for x in losses]}; scale after "
        f"each step {scales}; ms a step {[round(t, 2) for t in ms]} "
        f"(median of steps 2-{O1_STEPS} {_med(ms[1:]):.2f}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches over "
        f"{O1_STEPS} steps: tile mode {tile}, {launched}")
    if not all(np.isfinite(losses)) or tile != want_tile \
            or any(launched[n] != want_hb.get(n, 0) for n in launched):
        raise AssertionError(f"15c: losses {losses}, launches tile {tile} "
                             f"(want {want_tile}), {launched} (want "
                             f"{want_hb}, no others)")
    del model, opt
    _release()
    out = {k: v for k, v in launched.items() if v}
    out.update(tile)
    return out


# 15d: kernels 4-6 at BERT's shape and the ERNIE trunk's (both directions)
# and the mma.sync dK/dV at the ERNIE proxy, in float16, as phase 9 holds
# them in bf16
FP16_ENC_CASES = [
    ("bert", 64, 512, 512, 12, 12, False, 0, torch.float16, True),
    ("ernie_trunk", 4, 1024, 1024, 64, 64, False, 0, torch.float16, False),
    ("ernie_trunk_causal", 4, 1024, 1024, 64, 64, True, 0, torch.float16,
     False),
    ("ernie_proxy", 4, 1024, 1024, 12, 12, False, 0, torch.float16, False,
     128),
]
# kernels 1-3 at d 64 (given delta and computing it) in float16
FP16_FLASH_CASE = ("d64", 4, 1024, 1024, 12, 12, True, 0, 64)


def _fp16_rows(label, port, plain, bounds, errs, library, times=None):
    """Rows of float16 kernels: ``port`` {row: fn(i)} timed as CUDA-graph
    replays beside ``library`` (``_sdpa_fns``'s four) unless ``times`` are
    given, ``plain`` {row: fn()}, ``bounds`` {row: (ms, by)}, ``errs``
    {row: max abs error}; logs each and returns them."""
    if times is None:
        times, how, _ = _timed(port, *library)
    else:
        times, how = times
    lib = {"fwd": _library(times, "sdpa_fwd", how),
           "bwd": _library(times, "sdpa_bwd", how)}
    rows = {}
    for name in port:
        lib_ms, lib_txt = lib["fwd" if "_fwd" in name else "bwd"]
        bound_ms, bound_by = bounds[name]
        rows[name] = dict(ms=_med(times[name]),
                          plain_ms=_time_plain(plain[name], iters=2),
                          library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=errs[name])
        log(f"[fp16] {name} float16 {label}: kernel_ms "
            f"{_spread(times[name])} (CUDA graphs of {ITERS} calls) "
            f"plain_ms {rows[name]['plain_ms']:.4f} library_ms "
            f"{_ms(lib_ms)} (SDPA in float16, fastest backend: {lib_txt}) "
            f"bound_ms {bound_ms:.5f} ({bound_by}) max_abs_err "
            f"{errs[name]:.3e}")
    return rows


def _fp16_kernels_15d(smi):
    """15d: every float16 kernel against its plain version on the card,
    then timed beside its plain version, SDPA in float16 and its bound.
    Returns the rows by kernel name (kernels 4-6 at BERT's shape, the
    tile mode at the decoder's, kernels 7 and 8 at the served
    geometry)."""
    gen = torch.Generator("cuda").manual_seed(15)
    rows, inputs, errs = {}, {}, {}
    for case in FP16_ENC_CASES:
        errs[case[0]], inputs[case[0]] = _enc_check(case, "kernels 4-6", gen)
    # kernels 4-6 at BERT's shape, as the training step runs them
    q, k, v, do, out, lse, delta, kw = inputs["bert"]
    plain = {"hb_fwd": lambda: hf.hb_fwd_ref(q, k, v, **kw),
             "hb_bwd_dq": lambda: hf.hb_bwd_dq_delta_ref(q, k, v, do, out,
                                                         lse, **kw),
             "hb_bwd_dkv": lambda: hf.hb_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                     **kw)}
    port = {n: fn for n, fn in zip(plain, _family_fns(
        "kernels 4-6", inputs["bert"], "bert").values())}
    bounds = {n: _flash_bound(q, k, False, 0, stage, kmask=kw["kmask"])[:2]
              for n, stage in zip(plain, ("hb_fwd", "hb_bwd_dq_delta",
                                          "hb_bwd_dkv"))}
    rows.update(_fp16_rows(
        "b64 s512 h12 d64 non-causal kmask dropout 0.1 (kernel 5 computing "
        "delta)", port, plain, bounds, errs["bert"],
        _sdpa_fns(q, k, v, do, attn_mask=kw["kmask"][:, None].to(q.dtype),
                  dropout_p=ENC_DROPOUT)))
    del q, k, v, do, out, lse, delta
    ernie = {}
    for case in FP16_ENC_CASES[1:]:
        ernie[case[0]] = _time_ernie_case(case[0], inputs.pop(case[0]))
    log(f"[fp16] kernels 4-6 float16 at the ERNIE shapes: "
        + "; ".join(f"{tag} " + ", ".join(
            f"{n} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f})"
            for n, r in rs.items()) for tag, rs in ernie.items()))
    inputs.clear()
    _release()
    # kernels 1-3 at d 64: given delta and computing it
    errs, (q, k, v, do, out, lse, delta) = _flash_check(
        FP16_FLASH_CASE, gen, dtype=torch.float16)
    kw = dict(causal=True, window=0)
    port = {"flash_fwd/d64": lambda i: fa.flash_fwd(q, k, v, **kw),
            "flash_bwd_dq/d64": lambda i: fa.flash_bwd_dq_delta(
                q, k, v, do, out, lse, **kw),
            "flash_bwd_dq (delta given)/d64": lambda i: fa.flash_bwd_dq(
                q, k, v, do, lse, delta, **kw),
            "flash_bwd_dkv/d64": lambda i: fa.flash_bwd_dkv(
                q, k, v, do, lse, delta, **kw)}
    plain = {"flash_fwd/d64": lambda: fa.flash_fwd_ref(q, k, v, **kw),
             "flash_bwd_dq/d64": lambda: fa.flash_bwd_dq_delta_ref(
                 q, k, v, do, out, lse, **kw),
             "flash_bwd_dq (delta given)/d64": lambda: fa.flash_bwd_dq_ref(
                 q, k, v, do, lse, delta, **kw),
             "flash_bwd_dkv/d64": lambda: fa.flash_bwd_dkv_ref(
                 q, k, v, do, lse, delta, **kw)}
    stages = ("flash_fwd", "flash_bwd_dq_delta", "flash_bwd_dq",
              "flash_bwd_dkv")
    bounds = {n: _flash_bound(q, k, True, 0, st)[:2]
              for n, st in zip(port, stages)}
    errs = {n: errs[n.split(" ")[0].split("/")[0]] for n in port}
    _fp16_rows("b4 s1024 h12 d64 causal", port, plain, bounds, errs,
               _sdpa_fns(q, k, v, do, is_causal=True))
    del q, k, v, do, out, lse, delta
    _release()
    rows.update(_fp16_tile_15d(gen))
    # kernels 7 and 8 at the served geometry and at 2048 slots
    layers = FULL["num_hidden_layers"]
    for quant in (False, True):
        name = "paged_attend_int8" if quant else "paged_attend"
        row = _time_shape(quant, gen, layers, M, POS, dtype=torch.float16)
        long_row = _time_shape(quant, gen, layers, M_LONG, POS_LONG,
                               dtype=torch.float16)
        row["max_abs_err"] = max(row["max_abs_err"],
                                 long_row["max_abs_err"])
        row["long"] = long_row
        rows[name] = row
    log(f"[fp16] 15d on {smi}: float16 rows {sorted(rows)}")
    return rows


def _fp16_tile_15d(gen):
    """15d: the tile mode at 25b's shape (b64 s256 h8 d64, dropout 0.1, the
    causal mask) in float16 against its plain version, then timed as the
    main path runs it; returns its rows."""
    b, s, h, d, rate = T_BATCH, T_TGT, T_BASE["nhead"], 64, 0.1
    q, k, v, do = _flash_inputs(b, s, s, h, h, gen, d=d, dtype=torch.float16)
    tile = torch.triu(torch.full((s, s), fa.NEG_INF, device="cuda"),
                      1)[None, None]
    kw = dict(causal=False, seed=(2025, -18), dropout=rate)
    rel, errs, dm_err, lse_err, _, _ = _tile_check(q, k, v, do, tile, kw)
    log(f"[fp16] the tile mode b{b} s{s} h{h} d{d} float16 dropout {rate} "
        f"on the causal mask: per-tile relative error "
        + ", ".join(f"{n} {e:.3e}" for n, e in rel.items() if n != "delta")
        + f" (tol {FLASH_REL_TOL}); fused delta {rel['delta']:.3e} per row "
        f"(tol 1e-5); dmask {dm_err:.3e} (tol 1e-3); lse {lse_err:.3e} "
        f"(tol {LSE_ATOL}); class table "
        f"{'equal' if errs['flash_tile_classes'] == 0 else 'DIFFERS'}")
    if not (all(e <= FLASH_REL_TOL for n, e in rel.items() if n != "delta")
            and rel["delta"] <= 1e-5 and dm_err <= 1e-3
            and lse_err <= LSE_ATOL and errs["flash_tile_classes"] == 0):
        raise AssertionError(f"15d: the float16 tile mode disagrees with "
                             f"its plain version: {rel}, dmask {dm_err}, "
                             f"lse {lse_err}")
    kw = dict(kw, tmask=tile)
    table = fa.tile_classes(tile, s, s, False, full_rows=True)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa._delta(do, out)
    port = {"flash_fwd_tile": lambda i: fa._flash_fwd(q, k, v, table, **kw),
            "flash_bwd_dq_tile": lambda i: fa._dq_delta(
                q, k, v, do, out, lse, table, **kw),
            "flash_bwd_dkv_tile": lambda i: fa._dkv(
                q, k, v, do, lse, delta, table, **kw)}
    plain = {"flash_fwd_tile": lambda: fa.flash_fwd_ref(q, k, v, **kw),
             "flash_bwd_dq_tile": lambda: fa.flash_bwd_dq_delta_ref(
                 q, k, v, do, out, lse, **kw),
             "flash_bwd_dkv_tile": lambda: fa.flash_bwd_dkv_ref(
                 q, k, v, do, lse, delta, **kw)}
    bounds = {n: _tile_bound(q, k, tile, n[len("flash_"):-len("_tile")])
              for n in port}
    rows = _fp16_rows(f"b{b} s{s} h{h} d{d} dropout {rate}, the causal mask "
                      f"(the tile mode, given the class table)", port, plain,
                      bounds, errs, _sdpa_fns(
                          q, k, v, do, attn_mask=tile[0, 0].to(q.dtype),
                          dropout_p=rate))
    del q, k, v, do, out, lse, delta
    _release()
    return rows


# -- phase 16 -----------------------------------------------------------------

FIT_SEQS, FIT_ITERS = 40, 5


def _lbfgs_tiny(device):
    """5 LBFGS(strong_wolfe) steps of a tiny fp32 regression network
    (fp32 matmuls: cuBLAS's default precision, no TF32) on ``device``;
    returns the losses and parameters."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(16, 4).astype(np.float32)).to(device)
    y = torch.sin(x.sum(1, keepdim=True))
    gen = torch.Generator("cpu").manual_seed(0)
    # the Xavier-uniform draw this check was written with (Linear's own
    # default became the reference's XavierNormal)
    xu = ParamAttr(initializer=initializer.XavierUniform())
    l1 = Linear(4, 8, xu, device="cpu", generator=gen).to(device)
    l2 = Linear(8, 1, xu, device="cpu", generator=gen).to(device)
    params = list(l1.parameters()) + list(l2.parameters())
    opt = LBFGS(learning_rate=0.5, max_iter=3,
                line_search_fn="strong_wolfe", parameters=params)

    def closure():
        loss = ((l2(torch.tanh(l1(x))) - y) ** 2).mean()
        loss.backward()
        return loss

    losses = [float(opt.step(closure)) for _ in range(5)]
    return losses, [p.detach().cpu() for p in params]


def phase_fit(card, graph_ms):
    import tempfile

    t_phase = time.perf_counter()
    rng = np.random.RandomState(3)
    ids = rng.randint(0, TRAIN["vocab_size"],
                      (FIT_SEQS, TRAIN_SEQ)).astype(np.int32)
    labels = rng.randint(0, TRAIN["vocab_size"],
                         (FIT_SEQS, TRAIN_SEQ)).astype(np.int32)
    model, opt, _ = _headline()
    net = hapi.Model(model).prepare(opt)
    stamps = []

    class Clock(hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            stamps.append((time.perf_counter(), float(logs["loss"])))

    with tempfile.TemporaryDirectory() as tmp:
        stop = hapi.EarlyStopping(monitor="loss", patience=0)
        ckpt = hapi.ModelCheckpoint(save_freq=1, save_dir=tmp)
        for w in FLASH_WRAPPERS:
            w.launches = 0
        t0 = time.perf_counter()
        net.fit(io.TensorDataset([ids, labels]), batch_size=TRAIN_BATCH,
                epochs=1, num_iters=FIT_ITERS, log_freq=1, shuffle=False,
                verbose=0, callbacks=[stop, ckpt, Clock()])
        fit_s = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in FLASH_WRAPPERS}
        losses = [v for _, v in stamps]
        step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(stamps, stamps[1:])]
        logs = net.evaluate(io.TensorDataset([ids[:16], labels[:16]]),
                            batch_size=TRAIN_BATCH, verbose=0)
        saved = sorted(os.listdir(tmp))
        m2, o2, _ = _headline()
        net2 = hapi.Model(m2).prepare(o2)
        net2.load(os.path.join(tmp, "final"))
        same_params = all(torch.equal(a, b) for a, b in
                          zip(model.parameters(), m2.parameters()))
        sd1, sd2 = opt.state_dict(), o2.state_dict()
        same_opt = sd1.keys() == sd2.keys() and all(
            torch.equal(v, sd2[k]) if isinstance(v, torch.Tensor)
            else v == sd2[k] for k, v in sd1.items())
    log(f"[fit] hapi.Model(LlamaForCausalLM 0.44B bf16).prepare(AdamW).fit"
        f" on {card}: {FIT_SEQS} sequences, batch {TRAIN_BATCH}, num_iters "
        f"{FIT_ITERS}, log_freq 1, EarlyStopping and ModelCheckpoint; "
        f"losses {[round(x, 5) for x in losses]}; ms between batch ends "
        f"{[round(x, 2) for x in step_ms]} (median {_med(step_ms):.2f}) "
        f"against phase 14's graph step {graph_ms:.2f} ms; fit {fit_s:.1f} s "
        f"in all (2 checkpoints: {saved}); kernels 1-3 over the fit "
        f"{launches}; evaluate {logs}; save/load round trip: parameters "
        f"{same_params}, optimizer state {same_opt}")
    want = TRAIN["num_hidden_layers"] * FIT_ITERS
    if any(n != want for n in launches.values()):
        raise AssertionError(f"fit's steps launched kernels 1-3 {launches} "
                             f"times, expected layers x steps = {want}")
    if len(losses) != FIT_ITERS or not all(np.isfinite(losses)) \
            or not np.isfinite(logs["loss"]) or not same_params \
            or not same_opt or "final.pdparams" not in saved:
        raise AssertionError("fit, evaluate or the save/load round trip "
                             "failed")
    del model, opt, net, m2, o2, net2
    _release()
    got, gp = _lbfgs_tiny("cuda")
    want, wp = _lbfgs_tiny("cpu")
    ldiff = max(abs(a - b) for a, b in zip(got, want))
    pdiff = max((a - b).abs().max().item() for a, b in zip(gp, wp))
    log(f"[fit] LBFGS(strong_wolfe), tiny fp32 network, 5 steps: losses "
        f"card {got} vs CPU {want}: max diff {ldiff:.3e}, parameters "
        f"{pdiff:.3e} (tol {LBFGS_TOL}); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not (ldiff <= LBFGS_TOL and pdiff <= LBFGS_TOL):
        raise AssertionError("LBFGS on the card left the CPU's")


LBFGS_TOL = 1e-6


# -- phase 17 -----------------------------------------------------------------

# 17c against one card on the same weights and batch. The losses: mp
# 2's bf16 partial sums moved them 1.3e-4 (NVIDIA H100 80GB HBM3, 700 W);
# at step 1 the loss barely reads the trunk (random weights and labels,
# the final RMSNorm fixing the logits' scale), so the step-1 gradients of
# the leaves below, all-gathered into the reference's layout
# (gather_jax_layout), are held too, each by its relative Frobenius
# error: measured 8.4e-3 (the last layers) to 2.44e-2 (layer 0: the bf16
# differences grow down the backward) on the same card; a wrong q/k/v or
# gate/up piece, a missing reduce or a vocab shard off by one is wrong
# by O(1) there
FLEET_CHECK_TOL = 1e-3
FLEET_GRAD_REL_TOL = 5e-2
FLEET_STEPS = 3
FLEET_GRAD_LEAVES = tuple(
    f"llama.layers.{i}.{leaf}.weight"
    for i in (0, FULL["num_hidden_layers"] - 1)
    for leaf in ("input_layernorm", "self_attn.qkv_proj", "self_attn.o_proj",
                 "post_attention_layernorm", "mlp.gate_up_proj",
                 "mlp.down_proj")) + (
    "llama.norm.weight", "llama.embed_tokens.weight", "lm_head.weight")
# kernels 1-3 at a rank's shape: 6 heads, q, k and v as the attention
# hands them on (v a strided view of the local qkv row, 2304 wide)
FLEET_FLASH_CASE = ("mp 2 rank", 8, 1024, 1024, 6, 6, True, 0, 128)


def _grad_leaves(model):
    """FLEET_GRAD_LEAVES of the model's gradients as global fp32 arrays
    (collective under mp > 1: only these are gathered); the vocab-sized
    ones every 8th vocab row, which spans every mp shard."""
    params = dict(model.named_parameters())
    out = {}
    for n in FLEET_GRAD_LEAVES:
        p = params[n]
        lay = getattr(p, "_dist_layout", None)
        g = p.grad if lay is None else gather_global(p.grad, lay)
        out[n] = g.detach().float().cpu().numpy()
    out["llama.embed_tokens.weight"] = out["llama.embed_tokens.weight"][::8]
    out["lm_head.weight"] = out["lm_head.weight"][:, ::8]
    return out


def _fleet_optimizer(model):
    return AdamW(learning_rate=1e-4, parameters=model.parameters(),
                 multi_precision=True, weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))


def _collectives_nccl():
    """17a: every collective of ``distributed/collective.py`` on NCCL at
    world size 1 (the world group and each axis's group), on CUDA fp32
    and bf16 tensors, each result checked. Returns what ran."""
    from paddle_tpu_torch import distributed as dist

    ran = []

    def check(name, got, want):
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        if len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"17a: {name} gave {got}, expected {want}")
        ran.append(name)

    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.arange(8, device="cuda") + 1).to(dtype).reshape(2, 4)
        tag = str(dtype).split(".")[1]
        for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
            check(f"all_reduce {op} {tag}", dist.all_reduce(
                x.clone(), op=getattr(dist.ReduceOp, op)), x)
        for axis in ("dp", "pp", "sharding", "sep", "mp"):
            check(f"all_reduce over {axis} {tag}",
                  dist.all_reduce(x.clone(), group=axis), x)
        check(f"all_gather {tag}", dist.all_gather([], x), [x])
        check(f"all_gather axis 1 {tag}", dist.all_gather(x, axis=1), x)
        check(f"broadcast {tag}", dist.broadcast(x.clone(), src=0), x)
        check(f"reduce {tag}", dist.reduce(x.clone(), dst=0), x)
        check(f"scatter {tag}", dist.scatter(torch.empty_like(x), [x]), x)
        check(f"scatter, no list {tag}", dist.scatter(x), x)
        check(f"gather {tag}", dist.gather(x), [x])
        check(f"reduce_scatter {tag}", dist.reduce_scatter(x, axis=1), x)
        check(f"all_to_all {tag}", dist.all_to_all([], [x]), [x])
        check(f"all_to_all split 1 concat 0 {tag}", dist.all_to_all(
            x, split_axis=1, concat_axis=0), x)
        check(f"alltoall_single {tag}", dist.alltoall_single(None, x), x)
        check(f"ppermute identity {tag}", dist.ppermute(x, [(0, 0)]), x)
        dist.wait(x)
    dist.barrier()
    ran.append("barrier")
    if dist.all_gather_object([], {"a": 1}) != [{"a": 1}] \
            or dist.broadcast_object_list(["b"]) != ["b"] \
            or dist.scatter_object_list([], ["c"]) != ["c"]:
        raise AssertionError("17a: the object collectives")
    ran.append("object collectives")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"17a: backend {dist.get_backend()}")
    return ran


def _rank_17c(root, ids, labels):
    """One of 17c's two ranks sharing the card: its mp 2 shards of the
    full-width model, from the global weights through
    ``load_jax_weights``'s shard path, then 3 eager AdamW steps."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", init_method=f"file://{root}/store")
    cfg = LlamaConfig(**TRAIN)
    # no hybrid group yet: the one-card model, phase 7's weights
    full = LlamaForCausalLM(cfg, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
    weights = {n: p.detach() for n, p in full.named_parameters()}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(1))
    load_jax_weights(model, weights)
    del full, weights
    heads = model.llama.layers[0].self_attn._nh
    opt = fleet.distributed_optimizer(_fleet_optimizer(model))
    net = fleet.distributed_model(model)
    ids, labels = (torch.from_numpy(a).cuda() for a in (ids, labels))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in FLASH_WRAPPERS:
        w.launches = 0
    losses, ms = [], []
    for i in range(FLEET_STEPS):
        t0 = time.perf_counter()
        opt.clear_grad()
        loss = net(ids, labels)
        loss.backward()
        if i == 0:  # step 1's gradients, outside the step's time
            torch.cuda.synchronize()
            t0 -= time.perf_counter()
            grads = _grad_leaves(model)
            t0 += time.perf_counter()
        opt.step()
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    rank = dist.get_rank()
    out = {"rank": rank, "losses": losses, "heads": heads,
           "launches": {w.__name__: w.launches for w in FLASH_WRAPPERS},
           "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "params": sum(p.numel() for p in model.parameters())}
    del net, model, opt
    # launches read: this check's calls are not counted
    _flash_check(FLEET_FLASH_CASE, torch.Generator("cuda").manual_seed(
        2 + rank), fused=True)
    np.savez(os.path.join(root, f"rank{rank}_grads.npz"), **grads)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_distributed(card):
    """17a collectives on NCCL at world size 1; 17b the full-width step
    through fleet at world size 1 against the plain one; 17c two ranks
    sharing the card at mp 2 over gloo."""
    import socket
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    t_phase = time.perf_counter()
    _release()  # an earlier phase's garbage would count in the peaks
    ids, labels = _train_batch(TRAIN["vocab_size"], TRAIN_BATCH, TRAIN_SEQ)
    cfg = LlamaConfig(**TRAIN)
    runs = {}
    for path in ("plain", "fleet"):
        if path == "fleet":
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            os.environ["PADDLE_MASTER"] = f"127.0.0.1:{port}"
            dist.init_parallel_env()
            fleet.init(is_collective=True,
                       strategy=fleet.DistributedStrategy())
            ran = _collectives_nccl()
            log(f"[distributed] 17a: NCCL {torch.cuda.nccl.version()} at world "
                f"size 1 on {card}, backend {dist.get_backend()}, every "
                f"axis group made by fleet.init; {len(ran)} checks passed: "
                f"{ran}")
        model = LlamaForCausalLM(cfg, device="cuda",
                                 generator=torch.Generator("cuda")
                                 .manual_seed(0))
        opt = _fleet_optimizer(model)
        if path == "fleet":
            model = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(opt)
        step = TrainStep(model, opt, lambda m, i, l: m(i, l))
        exec_cache.clear()
        runs[path] = _run_steps(step, (ids, labels))
        runs[path] += (exec_cache.stats()["captures"],)
        del model, opt, step
        _release()
    (p_loss, p_ms, p_peak, p_launch, p_cap), \
        (f_loss, f_ms, f_peak, f_launch, f_cap) = runs["plain"], runs["fleet"]
    ph7 = READINGS.get("phase7")
    log(f"[distributed] 17b: the 0.44B Llama at b{TRAIN_BATCH} x "
        f"s{TRAIN_SEQ} through fleet.distributed_model and "
        f"distributed_optimizer(AdamW(1e-4, multi_precision, weight decay "
        f"0.01, ClipGradByGlobalNorm(1.0))), TrainStep on CUDA graphs, "
        f"{WARMUP_STEPS} warm-up and {TIMED_STEPS} timed steps: "
        f"{f_ms:.2f} ms a step, peak {f_peak:.3f} GiB, {f_cap} capture; "
        f"the plain model with the same weights, optimizer and clip "
        f"{p_ms:.2f} ms, peak {p_peak:.3f} GiB; phase 7 (no clip) "
        + (f"{ph7[0]:.2f} ms, peak {ph7[1]:.3f} GiB" if ph7 else "not run")
        + f"; losses {[round(x, 5) for x in f_loss]}, bit-identical to the "
        f"plain model's: {f_loss == p_loss}; kernels 1-3 a replay "
        f"{ {k: v / TIMED_STEPS for k, v in f_launch.items()} }")
    layers = cfg.num_hidden_layers
    if f_loss != p_loss:
        raise AssertionError(f"17b: the fleet step's losses {f_loss} are "
                             f"not the plain step's {p_loss}")
    if any(n != layers * TIMED_STEPS for n in f_launch.values()) \
            or f_cap != 1:
        raise AssertionError(f"17b: not one capture and {layers} launches "
                             f"of each kernel a replay: {f_launch}, {f_cap}")
    dist.destroy_process_group()
    # 17c's yardstick: step 1's gradients on one card, same weights
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    model(ids, labels).backward()
    ref_grads = _grad_leaves(model)
    del model
    _release()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dist.spawn(_rank_17c, args=(root, ids.cpu().numpy(),
                                    labels.cpu().numpy()), nprocs=2)
        wall = time.perf_counter() - t0
        ranks, grad_err = [], {}
        for r in range(2):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            with np.load(os.path.join(root, f"rank{r}_grads.npz")) as got:
                for n, want_g in ref_grads.items():
                    err = float(np.linalg.norm(got[n] - want_g)
                                / max(np.linalg.norm(want_g), 1e-30))
                    grad_err[n] = max(grad_err.get(n, 0.0), err)
    want = f_loss[:FLEET_STEPS]
    diff = max(abs(a - b) for o in ranks for a, b in zip(o["losses"], want))
    for o in ranks:
        log(f"[distributed] 17c: rank {o['rank']} of 2 sharing {card}, mp "
            f"2 over gloo: {o['params'] / 1e6:.2f} M parameters held, "
            f"{o['heads']} heads a layer, losses {o['losses']}, kernels "
            f"1-3 over {FLEET_STEPS} steps {o['launches']}, peak "
            f"{o['peak_gib']:.3f} GiB, ms a step "
            f"{[round(x, 1) for x in o['ms']]} (gloo, host-staged, not a "
            f"TP speed)")
    log(f"[distributed] 17c: both ranks' losses within {diff:.3e} of 17b's "
        f"first {FLEET_STEPS} {[round(x, 5) for x in want]} (tol "
        f"{FLEET_CHECK_TOL}; the partial sums of the row-parallel products "
        f"are reduced in bf16); equal on both ranks: "
        f"{ranks[0]['losses'] == ranks[1]['losses']}; spawn to join "
        f"{wall:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    log(f"[distributed] 17c: step 1's gradients all-gathered into the "
        f"reference's layout against one card's, relative Frobenius error "
        f"(worse rank; tol {FLEET_GRAD_REL_TOL}): "
        + ", ".join(f"{n} {e:.3e}" for n, e in grad_err.items()))
    if not diff <= FLEET_CHECK_TOL \
            or ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError("17c: the two ranks' losses left 17b's or "
                             "each other's")
    bad = {n: e for n, e in grad_err.items() if not e <= FLEET_GRAD_REL_TOL}
    if bad:
        raise AssertionError(f"17c: gradients left one card's: {bad}")
    for o in ranks:
        if o["heads"] != TRAIN["num_attention_heads"] // 2 or any(
                n != layers * FLEET_STEPS for n in o["launches"].values()):
            raise AssertionError(f"17c: rank {o['rank']} ran {o['heads']} "
                                 f"heads, launches {o['launches']}")
    return {w: ranks[0]["launches"][w] for w in ranks[0]["launches"]}


# -- phases 18 and 19: shared ----------------------------------------------------

def _nccl_world_one():
    """The process group at world size 1 on NCCL, through a store on a
    free local port."""
    import socket

    from paddle_tpu_torch import distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ["PADDLE_MASTER"] = f"127.0.0.1:{port}"
    dist.init_parallel_env()
    return dist


def _strategy(**kw):
    """A fleet strategy: ``pipeline`` gives ``pipeline_configs``, the rest
    are ``<axis>_degree``s."""
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    pipeline = kw.pop("pipeline", None)
    s.hybrid_configs = {f"{k}_degree": v for k, v in kw.items()}
    if pipeline is not None:
        s.pipeline_configs = pipeline
    return s


def _pick_leaves(got):
    """FLEET_GRAD_LEAVES of a gradient dict in the causal LM's names (as
    ``_grad_leaves`` cuts them)."""
    out = {n: got[n] for n in FLEET_GRAD_LEAVES}
    out["llama.embed_tokens.weight"] = out["llama.embed_tokens.weight"][::8]
    out["lm_head.weight"] = out["lm_head.weight"][:, ::8]
    return out


def _one_card():
    """The yardstick of phases 18 and 19, made once: the 0.44B Llama's
    plain step (AdamW(1e-4, multi_precision, weight decay 0.01,
    ClipGradByGlobalNorm(1.0)), TrainStep on graphs, 2 warm-up and 5
    timed steps) as ``_run_steps`` returns it, and step 1's gradients of
    FLEET_GRAD_LEAVES."""
    if "one_card" not in READINGS:
        ids, labels = _train_batch(TRAIN["vocab_size"], TRAIN_BATCH,
                                   TRAIN_SEQ)
        cfg = LlamaConfig(**TRAIN)
        model = LlamaForCausalLM(cfg, device="cuda",
                                 generator=torch.Generator("cuda")
                                 .manual_seed(0))
        model(ids, labels).backward()
        grads = _grad_leaves(model)
        model.zero_grad(set_to_none=True)
        step = TrainStep(model, _fleet_optimizer(model),
                         lambda m, i, l: m(i, l))
        exec_cache.clear()
        run = _run_steps(step, (ids, labels))
        READINGS["one_card"] = (run + (exec_cache.stats()["captures"],),
                                grads)
        del model, step
        _release()
    return READINGS["one_card"]


def _spawn_ranks(fn, args, n=2):
    """``fn(root, *args)`` in ``n`` spawned ranks sharing the card; returns
    (each rank's JSON result, its npz arrays or None, seconds from spawn
    to join)."""
    import tempfile

    from paddle_tpu_torch import distributed as dist

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        dist.spawn(fn, args=(root,) + tuple(args), nprocs=n)
        wall = time.perf_counter() - t0
        ranks, arrays = [], []
        for r in range(n):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            path = os.path.join(root, f"rank{r}.npz")
            if os.path.exists(path):
                with np.load(path) as got:
                    arrays.append({k: got[k] for k in got.files})
            else:
                arrays.append(None)
    return ranks, arrays, wall


def _save_rank(root, out, arrays=None):
    from paddle_tpu_torch import distributed as dist

    rank = dist.get_rank()
    out["rank"] = rank
    if arrays is not None:
        np.savez(os.path.join(root, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _rank_setup(root):
    from paddle_tpu_torch import distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", init_method=f"file://{root}/store")
    return dist


def _grad_errors(arrays, want):
    """The worst rank's relative Frobenius error of each leaf."""
    err = {}
    for got in arrays:
        for n, w in want.items():
            e = float(np.linalg.norm(got[n] - w)
                      / max(np.linalg.norm(w), 1e-30))
            err[n] = max(err.get(n, 0.0), e)
    return err


def _hold(prefix, tag, ranks, arrays, want_losses, want_grads, launches):
    """18b's and 19b's checks: losses within FLEET_CHECK_TOL of one
    card's, equal on the ranks, step 1's gradients within
    FLEET_GRAD_REL_TOL, each rank's kernels 1-3 launched as ``launches``
    ({rank: n}) says."""
    diff = max(abs(a - b) for o in ranks for a, b in zip(o["losses"],
                                                         want_losses))
    err = _grad_errors(arrays, want_grads)
    log(f"[{prefix}] {tag}: both ranks' losses within {diff:.3e} of one card's first "
        f"{FLEET_STEPS} {[round(x, 5) for x in want_losses]} (tol "
        f"{FLEET_CHECK_TOL}); step 1's gradients against one card's, "
        f"relative Frobenius error (worse rank; tol {FLEET_GRAD_REL_TOL}): "
        + ", ".join(f"{n} {e:.3e}" for n, e in err.items()))
    if not diff <= FLEET_CHECK_TOL \
            or any(o["losses"] != ranks[0]["losses"] for o in ranks):
        raise AssertionError(f"{tag}: the ranks' losses left one card's or "
                             f"each other's")
    bad = {n: e for n, e in err.items() if not e <= FLEET_GRAD_REL_TOL}
    if bad:
        raise AssertionError(f"{tag}: gradients left one card's: {bad}")
    for o in ranks:
        want = launches[o["rank"]]
        if any(n != want for n in o["launches"].values()):
            raise AssertionError(f"{tag}: rank {o['rank']} launched kernels "
                                 f"1-3 {o['launches']} times, expected "
                                 f"{want} each")


# -- phase 18 -----------------------------------------------------------------

PIPE_MICRO = 4            # 18b: n_micro = max(accumulate_steps, pp) = 4
ERNIE_PIPE = dict(num_hidden_layers=4, dtype="bfloat16",
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ERNIE_PIPE_MICRO = 2      # 18c: microbatches of 2 rows
ERNIE_PIPE_STEPS = 2
ERNIE_PIPE_TOL = 1e-3


def _llama_pipe(cfg, weights):
    """The 0.44B Llama pipe on this rank's stage, from the causal LM's
    weights (names), through the canonical state."""
    from paddle_tpu_torch.models import LlamaForCausalLMPipe, to_pipe_layout

    pipe = LlamaForCausalLMPipe(cfg, device="cuda")
    missing, unexpected = pipe.set_state_dict(
        to_pipe_layout(weights, cfg.num_hidden_layers))
    if missing or unexpected:
        raise AssertionError(f"pipe state: missing {missing}, unexpected "
                             f"{unexpected}")
    return pipe


def _rank_18b(root, ids, labels):
    """One of 18b's two stages sharing the card: pp 2, 4 microbatches of
    2 rows, 3 steps with GPipe and then with 1F1B from the same
    weights."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import from_pipe_layout, gather_jax_layout

    dist = _rank_setup(root)
    cfg = LlamaConfig(**TRAIN)
    full = LlamaForCausalLM(cfg, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
    weights = {n: p.detach() for n, p in full.named_parameters()}
    ids, labels = (torch.from_numpy(a).cuda() for a in (ids, labels))
    out, grads = {}, {}
    for sched in ("GPipe", "1F1B"):
        fleet.init(is_collective=True, strategy=_strategy(
            pp=2, pipeline={"accumulate_steps": PIPE_MICRO,
                            "schedule": "1F1B" if sched == "1F1B" else ""}))
        pipe = _llama_pipe(cfg, weights)
        net = fleet.distributed_model(pipe)
        opt = fleet.distributed_optimizer(_fleet_optimizer(pipe))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in FLASH_WRAPPERS:
            w.launches = 0
        losses, ms = [], []
        for i in range(FLEET_STEPS):
            t0 = time.perf_counter()
            if i == 0:  # train_batch's work, the gradients read between
                loss = net.forward_backward_pipeline((ids, labels))
                net._reduce_gradients()
                torch.cuda.synchronize()
                t0 -= time.perf_counter()
                got = from_pipe_layout(gather_jax_layout(pipe, grads=True),
                                       cfg.num_hidden_layers)
                t0 += time.perf_counter()
                opt.step()
                opt.clear_grad()
            else:
                loss = net.train_batch((ids, labels), opt)
            losses.append(float(loss))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        grads[sched] = _pick_leaves(got)
        out[sched] = {
            "losses": losses, "ms": ms,
            "launches": {w.__name__: w.launches for w in FLASH_WRAPPERS},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "params": sum(p.numel() for p in pipe.parameters()),
            "layers": sorted(int(k) for k in pipe._modules),
            "counters": dict(pipe.counters)}
        del net, opt, pipe
        torch.cuda.empty_cache()
    out["same_bits"] = out["GPipe"]["losses"] == out["1F1B"]["losses"] \
        and all(np.array_equal(grads["GPipe"][n], grads["1F1B"][n])
                for n in grads["GPipe"])
    _save_rank(root, out, grads["GPipe"])
    dist.destroy_process_group()


def _ernie_pipe(task="nlg"):
    """The ERNIE pipe at the 10B widths (trunk 4 of 48, dropout 0) on
    this rank's stage, every parameter bf16, and its optimizer."""
    from paddle_tpu_torch.models import ErnieForPretrainingPipe

    cfg = ErnieConfig(**ERNIE_PIPE)
    pipe = ErnieForPretrainingPipe(cfg, task, device="cuda")
    pipe = amp.decorate(pipe, level="O2", dtype="bfloat16")
    return pipe, _fleet_optimizer(pipe)


def _ernie_pipe_batch():
    ids, _, lm = _ernie_batch(ErnieConfig(**ERNIE_PIPE), ERNIE_BATCH,
                              ERNIE_SEQ)
    return ids, lm


def _rank_18c(root):
    """One of 18c's two ERNIE stages sharing the card: 2 steps."""
    from paddle_tpu_torch.distributed import fleet

    dist = _rank_setup(root)
    fleet.init(is_collective=True, strategy=_strategy(
        pp=2, pipeline={"accumulate_steps": ERNIE_PIPE_MICRO}))
    pipe, opt = _ernie_pipe()
    net = fleet.distributed_model(pipe)
    batch = _ernie_pipe_batch()
    for w in FLASH_WRAPPERS + HB_WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(ERNIE_PIPE_STEPS):
        t0 = time.perf_counter()
        losses.append(float(net.train_batch(batch, opt)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    _save_rank(root, {
        "losses": losses, "ms": ms,
        "launches": {w.__name__: w.launches
                     for w in FLASH_WRAPPERS + HB_WRAPPERS},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "params": sum(p.numel() for p in pipe.parameters()),
        "layers": sorted(int(k) for k in pipe._modules)})
    dist.destroy_process_group()


def phase_pipeline(card):
    """18a the Llama pipe at pp 1 on NCCL against the plain step; 18b pp
    2 over gloo, two ranks sharing the card, GPipe and 1F1B; 18c the
    ERNIE pipe at the 10B widths, pp 2 against pp 1."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet

    t_phase = time.perf_counter()
    _release()
    ids, labels = _train_batch(TRAIN["vocab_size"], TRAIN_BATCH, TRAIN_SEQ)
    cfg = LlamaConfig(**TRAIN)
    layers = cfg.num_hidden_layers
    (p_loss, p_ms, p_peak, _, p_cap), ref_grads = _one_card()
    # 18a: pp 1 on NCCL at world size 1
    _nccl_world_one()
    fleet.init(is_collective=True, strategy=_strategy(pp=1))
    plain = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    weights = {n: p.detach() for n, p in plain.named_parameters()}
    pipe = fleet.distributed_model(_llama_pipe(cfg, weights))
    del plain, weights
    step = TrainStep(pipe, _fleet_optimizer(pipe),
                     lambda m, i, l: m.loss_fn(m(i), l))
    exec_cache.clear()
    a_loss, a_ms, a_peak, a_launch = _run_steps(step, (ids, labels))
    a_cap = exec_cache.stats()["captures"]
    log(f"[pipeline] 18a: LlamaForCausalLMPipe at pp 1 (fleet.init on NCCL "
        f"{torch.cuda.nccl.version()}, world size 1; {type(pipe).__name__} "
        f"from fleet.distributed_model), loaded with the plain model's "
        f"weights through the canonical state, TrainStep on CUDA graphs: "
        f"{a_ms:.2f} ms a step, peak {a_peak:.3f} GiB, {a_cap} capture; "
        f"the plain step {p_ms:.2f} ms, peak {p_peak:.3f} GiB; losses "
        f"{[round(x, 5) for x in a_loss]}, bit-identical to the plain "
        f"step's: {a_loss == p_loss}; kernels 1-3 a replay "
        f"{ {k: v / TIMED_STEPS for k, v in a_launch.items()} }")
    if a_loss != p_loss:
        raise AssertionError(f"18a: the pipe's losses {a_loss} are not the "
                             f"plain step's {p_loss}")
    if any(n != layers * TIMED_STEPS for n in a_launch.values()) \
            or a_cap != 1:
        raise AssertionError(f"18a: launches {a_launch}, captures {a_cap}")
    del pipe, step
    _release()
    pdist.destroy_process_group()
    # 18b: pp 2, two ranks on the card
    ranks, arrays, wall = _spawn_ranks(
        _rank_18b, (ids.cpu().numpy(), labels.cpu().numpy()))
    per = layers // 2 * PIPE_MICRO * FLEET_STEPS
    for o in ranks:
        for sched in ("GPipe", "1F1B"):
            r = o[sched]
            log(f"[pipeline] 18b: rank {o['rank']} of 2 sharing {card}, pp 2 "
                f"{sched} over gloo, {PIPE_MICRO} microbatches of "
                f"{TRAIN_BATCH // PIPE_MICRO} rows: layers {r['layers']} "
                f"({r['params'] / 1e6:.2f} M parameters), losses "
                f"{r['losses']}, kernels 1-3 over {FLEET_STEPS} steps "
                f"{r['launches']} (predicted {layers // 2} layers x "
                f"{PIPE_MICRO} microbatches x {FLEET_STEPS} steps = {per}), "
                f"peak {r['peak_gib']:.3f} GiB, ms a step "
                f"{[round(x, 1) for x in r['ms']]} (gloo, host-staged, not "
                f"a pipeline speed), counters {r['counters']}")
        log(f"[pipeline] 18b: rank {o['rank']}: GPipe and 1F1B losses and "
            f"step 1's gradients bit-identical: {o['same_bits']}")
    for sched in ("GPipe", "1F1B"):
        _hold("pipeline", f"18b {sched}",
              [dict(o[sched], rank=o["rank"]) for o in ranks], arrays,
              p_loss[:FLEET_STEPS], ref_grads, {0: per, 1: per})
    if not all(o["same_bits"] for o in ranks):
        raise AssertionError("18b: GPipe and 1F1B differ")
    log(f"[pipeline] 18b: spawn to join {wall:.1f} s")
    # 18c: the ERNIE pipe, pp 1 on one card, then pp 2
    pipe, opt = _ernie_pipe()
    batch = _ernie_pipe_batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one = []
    for _ in range(ERNIE_PIPE_STEPS):
        opt.clear_grad()
        loss = pipe.loss_fn(pipe(batch[0]), batch[1])
        loss.backward()
        opt.step()
        one.append(float(loss))
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in pipe.parameters())
    del pipe, opt, loss
    _release()
    READINGS["ernie_pipe_one"] = one
    ranks, _, wall = _spawn_ranks(_rank_18c, ())
    ec = ErnieConfig(**ERNIE_PIPE)
    trunk = ec.num_hidden_layers // 2
    want = {0: trunk * ERNIE_PIPE_MICRO * ERNIE_PIPE_STEPS,
            1: (trunk + ec.num_task_layers) * ERNIE_PIPE_MICRO
            * ERNIE_PIPE_STEPS}
    diff = max(abs(a - b) for o in ranks for a, b in zip(o["losses"], one))
    log(f"[pipeline] 18c: ErnieForPretrainingPipe('nlg') at the 10B widths, "
        f"trunk {ec.num_hidden_layers} of 48, dropout 0, bf16 (amp.decorate "
        f"O2), b{ERNIE_BATCH} x s{ERNIE_SEQ}, AdamW with "
        f"ClipGradByGlobalNorm(1.0): pp 1 on one card {n_params / 1e9:.3f} B "
        f"parameters, peak {one_peak:.3f} GiB, losses {one}")
    for o in ranks:
        log(f"[pipeline] 18c: rank {o['rank']} of 2, pp 2 over gloo, "
            f"{ERNIE_PIPE_MICRO} microbatches: layers {o['layers']} "
            f"({o['params'] / 1e9:.3f} B parameters), losses {o['losses']}, "
            f"peak {o['peak_gib']:.3f} GiB, ms a step "
            f"{[round(x, 1) for x in o['ms']]} (host-staged); launches "
            f"{o['launches']}: kernels 1-3 predicted {want[o['rank']]} = "
            f"(trunk layers here + branch layers here) x microbatches x "
            f"steps (no mask and no dropout: the attention takes the flash "
            f"entry at d 64), kernels 4-6 predicted 0")
    log(f"[pipeline] 18c: pp 2 within {diff:.3e} of pp 1 (tol "
        f"{ERNIE_PIPE_TOL}); spawn to join {wall:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if not diff <= ERNIE_PIPE_TOL:
        raise AssertionError(f"18c: pp 2's losses left pp 1's by {diff}")
    for o in ranks:
        got = o["launches"]
        if any(got[w.__name__] != want[o["rank"]] for w in FLASH_WRAPPERS) \
                or any(got[w.__name__] for w in HB_WRAPPERS):
            raise AssertionError(f"18c: rank {o['rank']} launches {got}, "
                                 f"expected {want[o['rank']]} of kernels "
                                 f"1-3 and none of 4-6")
    return {w: ranks[0]["launches"][w] for w in ranks[0]["launches"]}


# -- phase 19 -----------------------------------------------------------------

# the ring's block calls at a rank's shape at sep 2: 512 of the 1024
# tokens of all 8 rows, 12 heads of d 128, bf16
RING_BLOCK = (8, 512, 12, 128)


def _ring_block_check(gen):
    """Kernel 1 on the diagonal block (causal) and on an earlier key block
    (no mask), each returning lse, then kernels 2 and 3 on each block
    given the *global* lse and delta of the two combined, each against
    its plain version on fp32 copies (FLASH_REL_TOL per tile); then
    timed as CUDA-graph replays beside their plain versions, their
    bounds and SDPA's non-causal calls. Returns {kernel: row}."""
    b, s, h, d = RING_BLOCK
    q, k0, v0, do = _flash_inputs(b, s, s, h, h, gen, d=d)
    _, k1, v1, _ = _flash_inputs(b, s, s, h, h, gen, d=d)
    f32 = {n: t.float() for n, t in (("q", q), ("k0", k0), ("v0", v0),
                                     ("k1", k1), ("v1", v1), ("do", do))}
    blocks = (("diagonal", k0, v0, True), ("earlier", k1, v1, False))
    errs, parts = {}, []
    for name, k, v, causal in blocks:
        out, lse = fa.flash_fwd(q, k, v, causal=causal)
        want, want_lse = fa.flash_fwd_ref(f32["q"], k.float(), v.float(),
                                          causal=causal)
        errs[f"flash_fwd {name}"] = (_tile_rel_err(out, want),
                                     (lse - want_lse).abs().max().item())
        parts.append((want, want_lse))
    (o0, l0), (o1, l1) = parts
    lse = torch.logaddexp(l0, l1)

    def rows(x):
        return x.reshape(b, h, s).permute(0, 2, 1)[..., None]

    out = (o0 * torch.exp(rows(l0 - lse))
           + o1 * torch.exp(rows(l1 - lse))).to(q.dtype)
    delta = fa._delta(do, out)
    for name, k, v, causal in blocks:
        kw = dict(causal=causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        ref = [t.float() for t in (q, k, v, do)]
        w_dq = fa.flash_bwd_dq_ref(*ref, lse, delta, **kw)
        w_dk, w_dv = fa.flash_bwd_dkv_ref(*ref, lse, delta, **kw)
        errs[f"flash_bwd_dq {name}"] = (_tile_rel_err(dq, w_dq), 0.0)
        errs[f"flash_bwd_dkv {name}"] = (max(_tile_rel_err(dk, w_dk),
                                             _tile_rel_err(dv, w_dv)), 0.0)
    torch.cuda.synchronize()
    log(f"[context] ring block calls at a rank's shape b{b} s{s} h{h} d{d} "
        f"bf16 (global lse and delta of the two blocks into kernels 2 and "
        f"3): per-tile relative error (tol {FLASH_REL_TOL}) "
        + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items())
        + "; lse " + ", ".join(f"{n} {l:.3e}" for n, (_, l) in errs.items()
                               if n.startswith("flash_fwd"))
        + f" (tol {LSE_ATOL})")
    bad = {n: e for n, e in errs.items()
           if not (e[0] <= FLASH_REL_TOL and e[1] <= LSE_ATOL)}
    if bad:
        raise AssertionError(f"ring block calls disagree with the plain "
                             f"versions: {bad}")
    # timed: the earlier (full) block, the ring's new pattern
    kernels = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k1, v1, causal=False),
                      lambda: fa.flash_fwd_ref(q, k1, v1, causal=False)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k1, v1, do, lse, delta, causal=False),
            lambda: fa.flash_bwd_dq_ref(q, k1, v1, do, lse, delta,
                                        causal=False)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k1, v1, do, lse, delta, causal=False),
            lambda: fa.flash_bwd_dkv_ref(q, k1, v1, do, lse, delta,
                                         causal=False)),
    }
    library, contexts, fallbacks, minus = _sdpa_fns(q, k1, v1, do,
                                                    is_causal=False)
    port = {n: lambda i, f=kern: f() for n, (kern, _) in kernels.items()}
    times, how, _ = _timed(port, library, contexts, fallbacks, minus)
    lib = {"flash_fwd": _library(times, "sdpa_fwd", how)}
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = _library(times, "sdpa_bwd",
                                                          how)
    rows_out = {}
    for name, (_, plain) in kernels.items():
        bound_ms, bound_by, _ = _flash_bound(q, k1, False, 0, name)
        plain_ms = _time_plain(plain, iters=3)
        lib_ms, lib_txt = lib[name]
        rows_out[name] = dict(ms=_med(times[name]), plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=lib_ms)
        log(f"[context] ring block {name} b{b} s{s} h{h} d{d} bf16, no mask"
            f"{', given the global lse and delta' if name != 'flash_fwd' else ', lse kept'}"
            f": kernel_ms {_spread(times[name])} (CUDA graphs) plain_ms "
            f"{plain_ms:.4f} library_ms {_ms(lib_ms)} (SDPA non-causal: "
            f"{lib_txt}) bound_ms {bound_ms:.5f} ({bound_by})")
    return rows_out


def _cp_model(cfg, mode, weights):
    model = LlamaForCausalLM(
        LlamaConfig(**dict(TRAIN, context_parallel=True,
                           context_parallel_mode=mode)),
        device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    load_jax_weights(model, weights)
    return model


def _rank_19b(root, ids, labels):
    """One of 19b's two sep ranks sharing the card: its 512 of the 1024
    tokens of all 8 rows, ring then Ulysses, 3 eager AdamW steps each."""
    from paddle_tpu_torch.distributed import fleet

    dist = _rank_setup(root)
    cfg = LlamaConfig(**TRAIN)
    full = LlamaForCausalLM(cfg, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
    weights = {n: p.detach() for n, p in full.named_parameters()}
    del full
    fleet.init(is_collective=True, strategy=_strategy(sep=2))
    hcg = fleet.get_hybrid_communicate_group()
    c = hcg.get_sep_parallel_rank()
    s = TRAIN_SEQ // 2
    ids, labels = (torch.from_numpy(a[:, c * s:(c + 1) * s]).cuda()
                   for a in (ids, labels))
    out, arrays = {"chunk": c}, {}
    for mode in ("ring", "ulysses"):
        model = _cp_model(cfg, mode, weights)
        net = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(_fleet_optimizer(model))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in FLASH_WRAPPERS:
            w.launches = 0
        losses, ms = [], []
        for i in range(FLEET_STEPS):
            t0 = time.perf_counter()
            opt.clear_grad()
            loss = net(ids, labels)
            loss.backward()
            if i == 0:
                torch.cuda.synchronize()
                t0 -= time.perf_counter()
                got = _grad_leaves(model)
                t0 += time.perf_counter()
            opt.step()
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[mode] = {
            "losses": losses, "ms": ms,
            "launches": {w.__name__: w.launches for w in FLASH_WRAPPERS},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        arrays.update({f"{mode}/{n}": a for n, a in got.items()})
        del net, opt, model
        torch.cuda.empty_cache()
    _save_rank(root, out, arrays)
    dist.destroy_process_group()


def phase_context(card):
    """19a ring and Ulysses at sep 1 on NCCL against the plain step; 19b
    sep 2 over gloo, two ranks sharing the card; the ring's block calls
    at a rank's shape."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import fleet

    t_phase = time.perf_counter()
    _release()
    ids, labels = _train_batch(TRAIN["vocab_size"], TRAIN_BATCH, TRAIN_SEQ)
    cfg = LlamaConfig(**TRAIN)
    layers = cfg.num_hidden_layers
    (p_loss, p_ms, _, _, _), ref_grads = _one_card()
    # 19a: sep 1 on NCCL at world size 1
    _nccl_world_one()
    fleet.init(is_collective=True, strategy=_strategy(sep=1))
    plain = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    weights = {n: p.detach() for n, p in plain.named_parameters()}
    del plain
    for mode in ("ring", "ulysses"):
        model = fleet.distributed_model(_cp_model(cfg, mode, weights))
        step = TrainStep(model, _fleet_optimizer(model),
                         lambda m, i, l: m(i, l))
        exec_cache.clear()
        losses, ms, peak, launch = _run_steps(step, (ids, labels))
        cap = exec_cache.stats()["captures"]
        log(f"[context] 19a: context_parallel {mode} at sep 1 (fleet.init "
            f"on NCCL, world size 1), TrainStep on CUDA graphs: {ms:.2f} ms "
            f"a step (the plain step {p_ms:.2f}), peak {peak:.3f} GiB, {cap} "
            f"capture; losses bit-identical to the plain step's: "
            f"{losses == p_loss}; kernels 1-3 a replay "
            f"{ {k: v / TIMED_STEPS for k, v in launch.items()} }")
        if losses != p_loss:
            raise AssertionError(f"19a: {mode}'s losses {losses} are not the "
                                 f"plain step's {p_loss}")
        if any(n != layers * TIMED_STEPS for n in launch.values()) \
                or cap != 1:
            raise AssertionError(f"19a: launches {launch}, captures {cap}")
        del model, step
        _release()
    del weights
    pdist.destroy_process_group()
    # 19b: sep 2, two ranks on the card
    ranks, arrays, wall = _spawn_ranks(
        _rank_19b, (ids.cpu().numpy(), labels.cpu().numpy()))
    steps = FLEET_STEPS
    want = {"ring": {0: layers * steps, 1: 2 * layers * steps},
            "ulysses": {0: layers * steps, 1: layers * steps}}
    launches = {}
    for mode in ("ring", "ulysses"):
        for o in ranks:
            r = o[mode]
            log(f"[context] 19b: rank {o['rank']} of 2 sharing {card}, "
                f"{mode} over sep 2 on gloo, tokens "
                f"[{o['chunk'] * TRAIN_SEQ // 2}, "
                f"{(o['chunk'] + 1) * TRAIN_SEQ // 2}) of all "
                f"{TRAIN_BATCH} rows: losses {r['losses']}, kernels 1-3 "
                f"over {steps} steps {r['launches']} (predicted "
                f"{want[mode][o['rank']]}: "
                + ("causal ring, rank 0 skips the later block, rank 1 runs "
                   "the diagonal and the earlier one" if mode == "ring"
                   else "one local attention a layer")
                + f"), peak {r['peak_gib']:.3f} GiB, ms a step "
                f"{[round(x, 1) for x in r['ms']]} (host-staged)")
            launches[(mode, o["rank"])] = r["launches"]["flash_fwd"]
        _hold("context", f"19b {mode}",
              [dict(o[mode], rank=o["rank"]) for o in ranks],
              [{n[len(mode) + 1:]: a for n, a in got.items()
                if n.startswith(mode + "/")} for got in arrays],
              p_loss[:steps], ref_grads, want[mode])
    rows = _ring_block_check(torch.Generator("cuda").manual_seed(19))
    log(f"[context] 19b: spawn to join {wall:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, rows


# -- phase 20 -----------------------------------------------------------------

# the train cell's 0.44B widths with 8 experts a layer (top-2, capacity
# factor 1.25, aux coefficient 0.01): 1.42 B parameters; at b8 x s1024
# T = 8192 tokens and C = ceil(2 * 8192 / 8 * 1.25) = 2560 slots
MOE = dict(TRAIN, moe_num_experts=8, moe_top_k=2, moe_aux_loss_coeff=0.01)
MOE_STEPS = 5


def _moe_leaf_names(layers):
    """The MoE Llama's step-1 gradient leaves, held as 17c's are
    (relative Frobenius error, FLEET_GRAD_REL_TOL): its first and last
    layers', the final norm's, the embedding's and the LM head's (the
    experts' every 16th hidden unit: 4 of their 12.6 M a leaf would be
    200 MB in fp32)."""
    return tuple(
        f"llama.layers.{i}.{leaf}"
        for i in (0, layers - 1)
        for leaf in ("input_layernorm.weight", "self_attn.qkv_proj.weight",
                     "self_attn.o_proj.weight",
                     "post_attention_layernorm.weight", "mlp.gate_weight",
                     "mlp.w_in", "mlp.w_out")) + (
        "llama.norm.weight", "llama.embed_tokens.weight", "lm_head.weight")


# 20b's later steps: at step 1 the ranks' loss equals one card's (the
# global gate routes every token alike) and the gradients differ by the
# bf16 roundings of the dp sum (each rank's partial gradient, then the
# sum: ~2.9e-3 relative on every replicated leaf, 0 on the experts);
# AdamW's first steps move each weight by about lr whatever its
# gradient's size, and a moved weight flips tokens between experts and
# across the capacity, so the losses then part: 1.2e-3 and 3.1e-3 at
# steps 2 and 3 (NVIDIA H100 80GB HBM3, 700 W). ``--fp32-witness``
# reads the same run in fp32, ``--fault experts`` what this tolerance
# still catches (rank 1's experts never updated); PERF.md has both
MOE_DRIFT_TOL = 1e-2
# --fp32-witness: the model, one card and two ranks, in fp32
MOE_FP32 = dict(MOE, dtype="float32")
# kernels 1-3 at the shape a 20b or 20c rank hands them (4 rows)
RANK_FLASH_CASE = ("dp 2 rank", TRAIN_BATCH // 2, TRAIN_SEQ, TRAIN_SEQ,
                   12, 12, True, 0, 128)
# 20c: offload's peak below os_g's by at least this share of the
# masters' and moments' bytes
OFFLOAD_SAVING = 0.9
ZERO_LEVELS = (("os_g", False), ("p_g_os", False), ("os_g", True))
ZERO_STEPS = 2  # 20c's eager steps a level (step 1's gradients held)
CKPT_TOL = 1e-3
# 20e: four ranks sharing the card on gloo, one spawn: (i) the train cell
# (all 12 layers) at mp 2 x sharding 2 under each of these levels,
# ZERO_STEPS eager steps a level; (ii) 20a's MoE Llama at dp 2 x
# sharding 2 with its experts over sharding, under os_g, ZERO_STEPS
# eager steps (step 1 held at FLEET_CHECK_TOL, step 2 at MOE_DRIFT_TOL)
ZERO_MP_LEVELS = ("os_g", "p_g_os")
# (ii)'s depth is cut 12 -> 6: at 12 its four ranks' peaks (17.6 GiB
# each, 7.9 of it masters and moments) did not fit on the card beside
# what the run's main process holds by phase 20 (the whole run ran out
# of memory there; --phases 20 alone fitted, NVIDIA H100 80GB HBM3,
# 700 W); its yardstick is one card at the same depth, eager
MOE_SHARDING = dict(MOE, num_hidden_layers=6, moe_expert_axis="sharding")
# kernels 1-3 at the shapes 20e's ranks hand them: (i) 4 rows and 6
# heads, (ii) 2 rows and 12 heads
ZERO_MP_FLASH_CASE = ("mp 2 x sharding 2 rank", TRAIN_BATCH // 2, TRAIN_SEQ,
                      TRAIN_SEQ, 6, 6, True, 0, 128)
MOE_SHARDING_FLASH_CASE = ("dp 2 x sharding 2 rank", TRAIN_BATCH // 4,
                           TRAIN_SEQ, TRAIN_SEQ, 12, 12, True, 0, 128)


def _moe_grad_leaves(model, opt=None):
    """The model's gradient leaves (``_moe_leaf_names``) as global fp32
    arrays (an expert leaf gathered over its axis, and under ZeRO,
    ``opt._zero``, each slice over the ZeRO axis: collective); the
    vocab-sized ones every 8th vocab row, the experts every 16th hidden
    unit."""
    from paddle_tpu_torch.distributed.shard import gather_global

    params = dict(model.named_parameters())
    plan = getattr(opt, "_zero", None)
    out = {}
    for n in _moe_leaf_names(model.config.num_hidden_layers):
        p = params[n]
        if plan is not None:
            (_, g), = plan.params_grads([p])
            g = plan.full(p, g)
        else:
            g = p.grad.detach()
            lay = getattr(p, "_dist_layout", None)
            if lay is not None:
                g = gather_global(g.contiguous(), lay)
        if n == "llama.embed_tokens.weight":
            g = g[::8]
        elif n == "lm_head.weight":
            g = g[:, ::8]
        elif n.endswith("mlp.w_in"):
            g = g[:, :, ::16]
        elif n.endswith("mlp.w_out"):
            g = g[:, ::16]
        out[n] = g.float().cpu().numpy()
    return out


def _n_params(cfg):
    """The dense Llama's parameter count from its config."""
    h, f, v, L = (cfg["hidden_size"], cfg["intermediate_size"],
                  cfg["vocab_size"], cfg["num_hidden_layers"])
    return 2 * v * h + L * (4 * h * h + 3 * h * f + 2 * h) + h


def _moe_capacity(T):
    from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
        capacity,
    )

    return capacity(MOE["moe_top_k"], T, MOE["moe_num_experts"], 1.25)


def _moe_model(seed=0, cfg=MOE):
    return LlamaForCausalLM(LlamaConfig(**cfg), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                seed))


def _graph_like_steps(model, opt, batch, steps):
    """``steps`` eager steps whose updates round as a captured TrainStep's
    do: the first with Python scalars (TrainStep's eager first call),
    the later ones reading the rate and step count from device scalars
    (``optimizer._dev_scalars``, as TrainStep._advance writes them for a
    replay). Returns (losses, ms a step after the first)."""
    buf = torch.zeros(2, dtype=torch.float64,
                      device=next(model.parameters()).device)
    losses = []
    for i in range(steps):
        if i == 1:  # the first step warms the allocator and the libraries
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        opt.clear_grad()
        loss = model(*batch)
        loss.backward()
        if i:
            buf.copy_(torch.tensor([float(opt.get_lr()),
                                    float(opt._global_step + 1)],
                                   dtype=torch.float64))
            opt._dev_scalars = buf
        try:
            opt.step()
        finally:
            opt._dev_scalars = None
        losses.append(loss.detach())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    return [float(x) for x in losses], ms


def _moe_one_card(card, ids, labels):
    """20a: the MoE Llama on one card, eager and on graphs. Returns the
    one-card losses, step 1's gradient leaves and the launches."""
    layers = MOE["num_hidden_layers"]
    model = _moe_model()
    n_params = sum(p.numel() for p in model.parameters())
    experts = model.llama.layers[0].mlp
    routes = _next_routes([blk.mlp for blk in model.llama.layers])
    with torch.no_grad():  # the routing and aux losses at step 0
        model(ids)
    aux = [float(blk.mlp.aux_loss) for blk in model.llama.layers]
    model(ids, labels).backward()
    grads = _moe_grad_leaves(model)
    model.zero_grad(set_to_none=True)
    opt = _fleet_optimizer(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e_loss, e_ms = _graph_like_steps(model, opt, (ids, labels), MOE_STEPS)
    e_peak = torch.cuda.max_memory_allocated() / 2**30
    T = ids.numel()
    kept = [[int(x) for x in blk.mlp.dispatched] for blk in
            model.llama.layers]
    del model, opt
    _release()
    model = _moe_model()
    step = TrainStep(model, _fleet_optimizer(model), lambda m, i, l: m(i, l))
    exec_cache.clear()
    g_loss, g_ms, g_peak, launch = _run_steps(step, (ids, labels),
                                              warmup=2, timed=MOE_STEPS)
    cap = exec_cache.stats()["captures"]
    same = g_loss[:MOE_STEPS] == e_loss
    log(f"[experts] 20a: MoE Llama ({n_params / 1e9:.3f} B parameters: "
        f"{MOE['moe_num_experts']} experts a layer of "
        f"{(experts.w_in.numel() + experts.w_out.numel()) // 8 / 1e6:.1f} M, "
        f"top-{MOE['moe_top_k']}, capacity factor "
        f"{experts.capacity_factor}, {layers} layers, bf16) on {card}, "
        f"b{TRAIN_BATCH} x s{TRAIN_SEQ} (T = {T}, C = "
        f"{_moe_capacity(T)}), AdamW(1e-4, multi_precision) with "
        f"ClipGradByGlobalNorm(1.0): eager {e_ms:.2f} ms a step (steps 2-"
        f"{MOE_STEPS}), peak "
        f"{e_peak:.3f} GiB; TrainStep on CUDA graphs {g_ms:.2f} ms a step, "
        f"peak {g_peak:.3f} GiB, {cap} capture; losses {e_loss}; graph "
        f"steps bit-identical to eager over {MOE_STEPS} steps (the eager "
        f"updates read the captured step's device scalars): {same}; "
        f"kernels 1-3 over the {MOE_STEPS} timed replays {launch}")
    log(f"[experts] 20a: tokens dispatched a layer (first choice, second "
        f"choice; of {T} each; the rest dropped to the residual) at step "
        f"{MOE_STEPS}: {kept}; aux loss a layer at step 0 "
        f"{[round(a, 5) for a in aux]} (1.0 is a balanced gate)")
    if not same:
        raise AssertionError(f"20a: graph losses {g_loss} are not the eager "
                             f"ones {e_loss}")
    if any(n != layers * MOE_STEPS for n in launch.values()) or cap != 1:
        raise AssertionError(f"20a: launches {launch}, captures {cap}")
    if not all(np.isfinite(aux)):
        raise AssertionError(f"20a: aux losses {aux}")
    del model, step
    _release()
    return e_loss, grads, np.stack(routes), {
        "eager_ms": e_ms, "graph_ms": g_ms,
                           "peak_gib": g_peak, "launches": launch}


def _next_routes(moe):
    """A list that the next forward of each MoE layer in ``moe`` appends
    its buffer rows to (``route``'s ``rows``: both choices, ``[2,
    tokens]``, the global ``expert * C + slot``, ``E * C`` where
    dropped); then the layer routes as before."""
    got = []
    for mlp in moe:
        def once(tokens, cap, n_rows=1, valid=None, mlp=mlp,
                 route=mlp.route):
            out = route(tokens, cap, n_rows, valid)
            got.append(torch.stack(out[2]).cpu().numpy())
            del mlp.route  # the class's own again
            return out
        mlp.route = once
    return got


def _steer_choices(moe, forced=None):
    """Hook the gate of each MoE layer in ``moe`` ({canonical index:
    layer}) for the module's life. Without ``forced`` each call's own
    expert choices (``[top_k, tokens]``) are appended to the returned
    {index: [...]}; with ``forced`` ({index: [choices, ...]} in call
    order) each call routes by the next given choices instead of its
    own, and the returned lists get how many of its own differed."""
    got = {k: [] for k in moe}
    for k, mlp in moe.items():
        queue = None if forced is None else iter(forced[k])

        def choose(probs, k=k, own=mlp._choose, queue=queue):
            mine = torch.stack(own(probs))
            if queue is None:
                got[k].append(mine)
                return list(mine)
            want = torch.as_tensor(next(queue), device=mine.device)
            got[k].append((mine != want).sum())
            return list(want)
        mlp._choose = choose
    return got


def _moe_eager_one_card(ids, labels, cfg=MOE_FP32, steps=FLEET_STEPS):
    """A yardstick of eager ranks (the fp32 witness's, 20e's): the MoE
    Llama (``cfg``) on one card, ``steps`` eager steps. Returns (losses,
    step 1's gradient leaves, step 1's buffer rows)."""
    model = _moe_model(cfg=cfg)
    opt = _fleet_optimizer(model)
    routes = _next_routes([blk.mlp for blk in model.llama.layers])
    losses = []
    for i in range(steps):
        opt.clear_grad()
        loss = model(ids, labels)
        loss.backward()
        if i == 0:
            grads = _moe_grad_leaves(model)
        opt.step()
        losses.append(float(loss.detach()))
    del model, opt
    _release()
    return losses, grads, np.stack(routes)


def _moe_drift(tag, ranks, arrays, one, one_routes):
    """Log how far 20b's ranks went from one card: every step's loss,
    and at step 1 the token choices (either choice, any layer) that went
    to another expert, or to another buffer row (a slot shifts when an
    earlier token of its expert moved). Returns the largest loss
    difference."""
    drift = max(abs(a - b) for o in ranks
                for a, b in zip(o["losses"], one))
    got = np.concatenate([a["routes"] for a in arrays], axis=-1)
    cap = _moe_capacity(got.shape[-1])  # a row // cap: expert, E dropped
    moved = int((got // cap != one_routes // cap).sum())
    shifted = int((got != one_routes).sum())
    log(f"[experts] {tag}: the ranks' losses {ranks[0]['losses']} against "
        f"one card's {one[:FLEET_STEPS]}: within {drift:.3e} (steps 2-"
        f"{FLEET_STEPS} tol {MOE_DRIFT_TOL}, see MOE_DRIFT_TOL); at step "
        f"1, of {got.size} token choices (layers x 2 x tokens), {moved} "
        f"to another expert or dropped otherwise than on one card, "
        f"{shifted} in another buffer row")
    return drift


def _freeze(opt, saved):
    """``--fault experts``: put the experts' weights (and their masters)
    back to ``saved``, as if the optimizer had skipped them."""
    with torch.no_grad():
        for p, w in saved:
            p.copy_(w)
            m = opt._master_weights.get(id(p))
            if m is not None:
                m.copy_(w)


def _rank_20b(root, ids, labels, cfg, fault):
    """One of 20b's two ranks sharing the card: the MoE Llama (``cfg``)
    at dp 2, 4 experts here, 4 rows of the batch, 3 eager steps; with
    ``fault`` rank 1's experts are never updated."""
    from paddle_tpu_torch.distributed import fleet

    dist = _rank_setup(root)
    full = _moe_model(cfg=cfg)  # no hybrid group yet: every expert
    weights = {n: p.detach() for n, p in full.named_parameters()}
    fleet.init(is_collective=True, strategy=_strategy(dp=2))
    model = _moe_model(1, cfg)
    load_jax_weights(model, weights)
    del full, weights
    rank = dist.get_rank()
    rows = slice(rank * TRAIN_BATCH // 2, (rank + 1) * TRAIN_BATCH // 2)
    ids, labels = (torch.from_numpy(a[rows]).cuda() for a in (ids, labels))
    net = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(_fleet_optimizer(model))
    moe = [blk.mlp for blk in model.llama.layers]
    saved = [(w, w.detach().clone()) for m in moe for w in (m.w_in, m.w_out)
             ] if fault and rank == 1 else []
    routes = _next_routes(moe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in FLASH_WRAPPERS:
        w.launches = 0
    losses, ms = [], []
    for i in range(FLEET_STEPS):
        t0 = time.perf_counter()
        opt.clear_grad()
        loss = net(ids, labels)
        loss.backward()
        if i == 0:
            torch.cuda.synchronize()
            t0 -= time.perf_counter()
            grads = _moe_grad_leaves(model)
            t0 += time.perf_counter()
        opt.step()
        if saved:
            _freeze(opt, saved)
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    _save_rank(root, {
        "losses": losses, "ms": ms,
        "launches": {w.__name__: w.launches for w in FLASH_WRAPPERS},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "experts": moe[0].w_in.shape[0],
        "params": sum(p.numel() for p in model.parameters()),
        "comm_bytes": sum(m.comm_bytes for m in moe) // FLEET_STEPS,
        "dispatched": [[int(x) for x in m.dispatched] for m in moe]},
        dict(grads, routes=np.stack(routes)))
    dist.destroy_process_group()


def _state_bytes(opt, device):
    """Bytes of the optimizer's masters and moments on ``device``'s
    type."""
    ts = list(opt._master_weights.values()) + [
        v for st in opt._accumulators.values() for v in st.values()]
    return sum(t.numel() * t.element_size() for t in ts
               if t.device.type == device)


def _zero_grad_leaves(model, opt):
    """FLEET_GRAD_LEAVES of a ZeRO optimizer's gradient slices, gathered
    whole (over the ZeRO axis, then over mp; collective)."""
    names = {id(p): n for n, p in model.named_parameters()}
    got = {}
    for p, g in opt._params_grads():
        n = names[id(p)]
        if n in FLEET_GRAD_LEAVES:
            got[n] = opt._zero.full(p, g).float().cpu().numpy()
    return _pick_leaves(got)


def _digests(model, opt):
    """sha1 of every parameter (gathered whole, fp32) and of every tensor
    of the optimizer's (whole) ``state_dict``, by name; collective under
    ZeRO."""
    import hashlib

    out = {n: hashlib.sha1(a.tobytes()).hexdigest()
           for n, a in gather_jax_layout(model).items()}
    for k, v in opt.state_dict().items():
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            out["opt/" + k] = hashlib.sha1(t.numpy().tobytes()).hexdigest()
    return out


def _rank_20c(root, ids, labels, ckpt, with_states):
    """One of 20c's two ranks sharing the card: the dense 0.44B step at
    sharding 2 under each ZeRO level, ZERO_STEPS eager steps; after
    ``p_g_os`` the 20d save (parameters and, with ``with_states``, the
    AdamW states)."""
    from paddle_tpu_torch.distributed import checkpoint as ckp
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    dist = _rank_setup(root)
    rank = dist.get_rank()
    rows = slice(rank * TRAIN_BATCH // 2, (rank + 1) * TRAIN_BATCH // 2)
    ids, labels = (torch.from_numpy(a[rows]).cuda() for a in (ids, labels))
    out, arrays = {}, {}
    for level, offload in ZERO_LEVELS:
        tag = level + ("+offload" if offload else "")
        fleet.init(is_collective=True, strategy=_strategy(sharding=2))
        model = LlamaForCausalLM(LlamaConfig(**TRAIN), device="cuda",
                                 generator=torch.Generator("cuda")
                                 .manual_seed(0))
        model, opt, _ = group_sharded_parallel(
            model, _fleet_optimizer(model), level=level, offload=offload)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in FLASH_WRAPPERS:
            w.launches = 0
        losses, ms = [], []
        for i in range(ZERO_STEPS):
            t0 = time.perf_counter()
            opt.clear_grad()
            loss = model(ids, labels)
            loss.backward()
            if i == 0:
                torch.cuda.synchronize()
                t0 -= time.perf_counter()
                got = _zero_grad_leaves(model, opt)
                t0 += time.perf_counter()
            opt.step()
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[tag] = {
            "losses": losses, "ms": ms,
            "launches": {w.__name__: w.launches for w in FLASH_WRAPPERS},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "states_device": _state_bytes(opt, "cuda"),
            "states_host": _state_bytes(opt, "cpu"),
            "pinned": all(t.is_pinned() for t in
                          opt._master_weights.values()) if offload
            else None,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}
        arrays.update({f"{tag}/{n}": a for n, a in got.items()})
        if level == "p_g_os":  # 20d: the save
            state = dict(model.state_dict(keep_vars=True))
            if with_states:
                state.update(ckp.optimizer_state(opt))
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            writer = ckp.save_state_dict(state, ckpt, async_save=True)
            t_call = time.perf_counter() - t0
            writer.join()
            t_save = time.perf_counter() - t0
            digests = _digests(model, opt)
            opt.clear_grad()
            with torch.no_grad():
                nxt = float(model(ids, labels))
            out["save"] = {"call_s": t_call, "join_s": t_save,
                           "next": nxt,
                           "digests": digests if rank == 0 else None}
            del state, writer  # they hold the parameters and states
        del model, opt
        _release()  # ZeRO's hooks tie the model and plan in a cycle
    _save_rank(root, out, arrays)
    dist.destroy_process_group()


def _eager_zero_steps(model, opt, ids, labels, steps, leaves):
    """``steps`` eager steps of a ZeRO rank, kernels 1-3 counted from 0;
    step 1's gradient ``leaves(model, opt)`` taken outside the step's
    time. Returns (the readings, the leaves)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in FLASH_WRAPPERS:
        w.launches = 0
    losses, ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        opt.clear_grad()
        loss = model(ids, labels)
        loss.backward()
        if i == 0:
            torch.cuda.synchronize()
            t0 -= time.perf_counter()
            got = leaves(model, opt)
            t0 += time.perf_counter()
        opt.step()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "ms": ms,
            "launches": {w.__name__: w.launches for w in FLASH_WRAPPERS},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "states_device": _state_bytes(opt, "cuda"),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}, got


def _rank_20e(root, ids, labels):
    """One of 20e's four ranks sharing the card: (ii) first, while no
    hybrid group is up to cut the one-card model's experts: the MoE Llama
    at dp 2 x sharding 2, experts over sharding, under os_g, from the
    one-card weights; then (i) the train cell at mp 2 x sharding 2 under
    each of ZERO_MP_LEVELS."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    dist = _rank_setup(root)
    rank = dist.get_rank()
    out, arrays = {}, {}
    full = _moe_model(cfg=MOE_SHARDING)  # no hybrid group yet: every expert
    weights = {n: p.detach() for n, p in full.named_parameters()}
    fleet.init(is_collective=True, strategy=_strategy(dp=2, sharding=2))
    model = _moe_model(1, MOE_SHARDING)
    load_jax_weights(model, weights)
    del full, weights
    _release()
    # the batch rank dp * 2 + sharding is the global rank here
    rows = slice(rank * TRAIN_BATCH // 4, (rank + 1) * TRAIN_BATCH // 4)
    x, y = (torch.from_numpy(a[rows]).cuda() for a in (ids, labels))
    model, opt, _ = group_sharded_parallel(model, _fleet_optimizer(model),
                                           level="os_g")
    moe = [blk.mlp for blk in model.llama.layers]
    routes = _next_routes(moe)
    run, got = _eager_zero_steps(model, opt, x, y, ZERO_STEPS,
                                 _moe_grad_leaves)
    out["moe"] = dict(run, experts=moe[0].w_in.shape[0],
                      dispatched=[[int(v) for v in m.dispatched]
                                  for m in moe])
    arrays.update({f"moe/{n}": a for n, a in got.items()})
    arrays["moe/routes"] = np.stack(routes)
    del model, opt, moe
    _release()
    # (i): global rank = sharding * 2 + mp; a sharding rank's half
    sh = rank // 2
    rows = slice(sh * TRAIN_BATCH // 2, (sh + 1) * TRAIN_BATCH // 2)
    x, y = (torch.from_numpy(a[rows]).cuda() for a in (ids, labels))
    for level in ZERO_MP_LEVELS:
        fleet.init(is_collective=True, strategy=_strategy(mp=2, sharding=2))
        model = LlamaForCausalLM(LlamaConfig(**TRAIN), device="cuda",
                                 generator=torch.Generator("cuda")
                                 .manual_seed(0))
        model, opt, _ = group_sharded_parallel(
            model, _fleet_optimizer(model), level=level)
        run, got = _eager_zero_steps(model, opt, x, y, ZERO_STEPS,
                                     _zero_grad_leaves)
        out[level] = dict(run, heads=model.llama.layers[0].self_attn._nh)
        arrays.update({f"{level}/{n}": a for n, a in got.items()})
        del model, opt
        _release()
    _save_rank(root, out, arrays)
    dist.destroy_process_group()


def _phase_20e(card, ids, labels, zero_20c):
    """20e's four ranks (see ``_rank_20e``) held against one card: (i)
    against ``_one_card()``'s losses and step 1's gradients, each rank's
    masters and moments beside 20c's sharding-2 reading (``zero_20c``:
    bytes a rank); (ii) step 1 against one card's eager step at its
    depth, step 2 within MOE_DRIFT_TOL. Returns the launches of a rank of
    each leg."""
    layers = TRAIN["num_hidden_layers"]
    (p_loss, _, p_peak, _, _), ref_grads = _one_card()
    one, one_grads, one_routes = _moe_eager_one_card(
        ids, labels, MOE_SHARDING, ZERO_STEPS)
    ranks, arrays, wall = _spawn_ranks(
        _rank_20e, (ids.cpu().numpy(), labels.cpu().numpy()), n=4)
    launches = {}
    for level in ZERO_MP_LEVELS:
        for o in ranks:
            r = o[level]
            log(f"[experts] 20e: rank {o['rank']} of 4 sharing {card}, "
                f"ZeRO {level} at mp 2 x sharding 2 on "
                f"gloo, {TRAIN_BATCH // 2} rows, {r['heads']} heads: losses "
                f"{r['losses']}, masters and moments "
                f"{r['states_device'] / 2**30:.3f} GiB (20c at sharding 2: "
                f"{zero_20c['states'] / 2**30:.3f}; ratio "
                f"{r['states_device'] / zero_20c['states']:.4f}), parameters "
                f"{r['param_bytes'] / 2**30:.3f} GiB (20c "
                f"{zero_20c[level] / 2**30:.3f}), peak {r['peak_gib']:.3f} "
                f"GiB (one card {p_peak:.3f}), kernels 1-3 {r['launches']}, "
                f"ms a step {[round(x, 1) for x in r['ms']]} (host-staged)")
        _hold("experts", f"20e mp 2 x sharding 2 {level}",
              [dict(o[level], rank=o["rank"]) for o in ranks],
              [{n[len(level) + 1:]: a for n, a in got.items()
                if n.startswith(level + "/")} for got in arrays],
              p_loss[:ZERO_STEPS], ref_grads,
              {r: layers * ZERO_STEPS for r in range(4)})
        if any(o[level]["heads"] != 6 for o in ranks):
            raise AssertionError(f"20e {level}: a rank does not run 6 heads")
        launches[level] = ranks[0][level]["launches"]
    moe = [dict(o["moe"], rank=o["rank"]) for o in ranks]
    got = [{n[4:]: a for n, a in a_.items() if n.startswith("moe/")}
           for a_ in arrays]
    for o in moe:
        log(f"[experts] 20e: rank {o['rank']} of 4 sharing {card}, the MoE "
            f"Llama ({MOE_SHARDING['num_hidden_layers']} layers) at dp 2 x "
            f"sharding 2 on gloo, experts over sharding, "
            f"ZeRO os_g: {o['experts']} experts a layer here, "
            f"{TRAIN_BATCH // 4} rows, losses {o['losses']}, masters and "
            f"moments {o['states_device'] / 2**30:.3f} GiB, parameters "
            f"{o['param_bytes'] / 2**30:.3f} GiB, peak {o['peak_gib']:.3f} "
            f"GiB, kernels 1-3 {o['launches']}, ms a step "
            f"{[round(x, 1) for x in o['ms']]} (host-staged), tokens "
            f"dispatched a layer at step {ZERO_STEPS} {o['dispatched']}")
    drift = _moe_drift("20e experts over sharding", moe, got, one, one_routes)
    _hold("experts", "20e MoE step 1", moe, got, one[:1], one_grads,
          {r: MOE_SHARDING["num_hidden_layers"] * ZERO_STEPS
           for r in range(4)})
    if any(o["experts"] != MOE["moe_num_experts"] // 2 for o in moe):
        raise AssertionError("20e: a rank does not hold half the experts")
    if not drift <= MOE_DRIFT_TOL:
        raise AssertionError(f"20e: the MoE losses left one card's by "
                             f"{drift}")
    log(f"[experts] 20e: spawn to join {wall:.1f} s")
    for i, case in enumerate((ZERO_MP_FLASH_CASE, MOE_SHARDING_FLASH_CASE)):
        _flash_check(case, torch.Generator("cuda").manual_seed(24 + i),
                     fused=True)
    launches["moe"] = moe[0]["launches"]
    return launches


def _load_20d(ckpt, with_states, want, ids, labels):
    """20d at one rank: the checkpoint into the plain model (and AdamW);
    every tensor's digest against the ZeRO ranks', the next loss against
    theirs. Returns (seconds, bytes, loss)."""
    from paddle_tpu_torch.distributed import checkpoint as ckp

    model = LlamaForCausalLM(LlamaConfig(**TRAIN), device="cuda",
                             generator=torch.Generator("cuda")
                             .manual_seed(99))
    opt = _fleet_optimizer(model)
    state = dict(model.state_dict(keep_vars=True))
    if with_states:
        state.update(ckp.optimizer_state(opt))
    nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                 for f in os.listdir(ckpt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckp.load_state_dict(state, ckpt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if with_states:
        opt.set_state_dict(state)
    got = _digests(model, opt)
    if not with_states:
        got = {k: v for k, v in got.items() if not k.startswith("opt/")}
        want = {k: v for k, v in want.items() if not k.startswith("opt/")}
    bad = sorted(k for k in want if got.get(k) != want[k])
    if bad or got.keys() != want.keys():
        raise AssertionError(f"20d: tensors not bit for bit: {bad[:5]} "
                             f"(of {len(bad)}), keys "
                             f"{sorted(set(got) ^ set(want))[:5]}")
    with torch.no_grad():
        loss = float(model(ids, labels))
    del model, opt, state
    _release()
    return secs, nbytes, loss, len(want)


def phase_experts(card, fault=False, fp32_witness=False):
    """20a the MoE Llama on one card, eager and on graphs; 20b its
    experts over dp 2 (two ranks on gloo), in bf16 and in fp32; 20c ZeRO
    at sharding 2 (two ranks, os_g, p_g_os, os_g with offload) on the
    dense cell; 20d the p_g_os ranks' sharded checkpoint loaded at one
    rank; 20e four ranks: ZeRO at mp 2 x sharding 2 on the dense cell,
    and the MoE Llama at dp 2 x sharding 2 with its experts over
    sharding under os_g. ``fault``: rank 1's experts are never updated
    in 20b; ``fp32_witness``: 20b again in fp32, read and not held."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    _release()
    ids, labels = _train_batch(TRAIN["vocab_size"], TRAIN_BATCH, TRAIN_SEQ)
    layers = TRAIN["num_hidden_layers"]
    # 20a
    one, one_grads, one_routes, a = _moe_one_card(card, ids, labels)
    # 20b
    batch = (ids.cpu().numpy(), labels.cpu().numpy())
    ranks, arrays, wall = _spawn_ranks(_rank_20b, batch + (MOE, fault))
    for o in ranks:
        log(f"[experts] 20b: rank {o['rank']} of 2 sharing {card}, experts "
            f"over dp 2 on gloo: {o['experts']} experts a layer here "
            f"({o['params'] / 1e9:.3f} B parameters), {TRAIN_BATCH // 2} "
            f"rows, losses {o['losses']}, kernels 1-3 over {FLEET_STEPS} "
            f"steps {o['launches']} (predicted {layers * FLEET_STEPS}), peak "
            f"{o['peak_gib']:.3f} GiB, ms a step "
            f"{[round(x, 1) for x in o['ms']]} (host-staged), dispatch and "
            f"combine moved {o['comm_bytes'] / 2**20:.1f} MiB a forward "
            f"(the backward the same), tokens dispatched a layer at step "
            f"{FLEET_STEPS} {o['dispatched']}")
    # step 1 at FLEET_CHECK_TOL, the later steps at MOE_DRIFT_TOL
    witness = " with rank 1's experts never updated (--fault experts)" \
        if fault else ""
    drift = _moe_drift("20b" + witness, ranks, arrays, one, one_routes)
    _hold("experts", "20b step 1", ranks, arrays, one[:1], one_grads,
          {0: layers * FLEET_STEPS, 1: layers * FLEET_STEPS})
    b_launches = ranks[0]["launches"]
    if any(o["experts"] != MOE["moe_num_experts"] // 2 for o in ranks):
        raise AssertionError("20b: a rank does not hold half the experts")
    log(f"[experts] 20b: spawn to join {wall:.1f} s")
    if fp32_witness:
        t_fp32 = time.perf_counter()
        one32, grads32, routes32 = _moe_eager_one_card(ids, labels)
        ranks32, arrays32, _ = _spawn_ranks(_rank_20b,
                                            batch + (MOE_FP32, fault))
        err = _grad_errors(arrays32, grads32)
        log(f"[experts] 20b fp32 (--fp32-witness): step 1's gradients "
            f"against one card's, relative Frobenius error "
            f"{min(err.values()):.3e} to {max(err.values()):.3e} (bf16: "
            f"see 20b step 1); peak a rank "
            f"{max(o['peak_gib'] for o in ranks32):.3f} GiB; "
            f"{time.perf_counter() - t_fp32:.1f} s")
        _moe_drift("20b fp32" + witness, ranks32, arrays32, one32, routes32)
    if not drift <= MOE_DRIFT_TOL:
        raise AssertionError(f"20b: the losses left one card's by {drift}")
    _flash_check(RANK_FLASH_CASE, torch.Generator("cuda").manual_seed(20),
                 fused=True)
    # 20c and 20d
    (p_loss, _, p_peak, _, _), ref_grads = _one_card()
    root = tempfile.mkdtemp(prefix="ckpt20d_")
    ckpt = os.path.join(root, "ckpt")
    free = shutil.disk_usage(root).free
    # bf16 parameters 2 bytes, the fp32 master and two moments 12 bytes
    need = 14 * _n_params(TRAIN)
    with_states = free > 2 * need
    log(f"[experts] 20d: {free / 2**30:.1f} GiB free where the checkpoint "
        f"goes; saving parameters"
        + (" and AdamW states" if with_states else " only (no room for "
                                                    "the states)"))
    try:
        ranks, arrays, wall = _spawn_ranks(
            _rank_20c, (ids.cpu().numpy(), labels.cpu().numpy(), ckpt,
                        with_states))
        for level, offload in ZERO_LEVELS:
            tag = level + ("+offload" if offload else "")
            for o in ranks:
                r = o[tag]
                log(f"[experts] 20c: rank {o['rank']} of 2 sharing {card}, "
                    f"ZeRO {tag} at sharding 2 on gloo, {TRAIN_BATCH // 2} "
                    f"rows: losses {r['losses']}, peak {r['peak_gib']:.3f} "
                    f"GiB (one card {p_peak:.3f}), masters and moments "
                    f"{r['states_device'] / 2**30:.3f} GiB on the card and "
                    f"{r['states_host'] / 2**30:.3f} GiB on the host"
                    + (f" (pinned: {r['pinned']})" if offload else "")
                    + f", parameters {r['param_bytes'] / 2**30:.3f} GiB, "
                    f"kernels 1-3 {r['launches']}, ms a step "
                    f"{[round(x, 1) for x in r['ms']]} (host-staged)")
            _hold("experts", f"20c {tag}",
                  [dict(o[tag], rank=o["rank"]) for o in ranks],
                  [{n[len(tag) + 1:]: a for n, a in got.items()
                    if n.startswith(tag + "/")} for got in arrays],
                  p_loss[:ZERO_STEPS], ref_grads,
                  {0: layers * ZERO_STEPS, 1: layers * ZERO_STEPS})
            if offload and not (all(o[tag]["pinned"] for o in ranks)
                                and not any(o[tag]["states_device"]
                                            for o in ranks)):
                raise AssertionError("20c: offload left states on the card")
            if offload:
                saved = [o[level]["peak_gib"] - o[tag]["peak_gib"]
                         for o in ranks]
                want = OFFLOAD_SAVING * min(
                    o[tag]["states_host"] for o in ranks) / 2**30
                log(f"[experts] 20c {tag}: peak below {level}'s by "
                    f"{[round(x, 3) for x in saved]} GiB a rank (at least "
                    f"{want:.3f}: {OFFLOAD_SAVING} of the masters' and "
                    f"moments' bytes)")
                if not min(saved) >= want:
                    raise AssertionError(
                        f"20c: offload's peak is not below {level}'s by "
                        f"the states: {saved} GiB, want {want:.3f}")
        c_launches = ranks[0]["p_g_os"]["launches"]
        zero_20c = {"states": ranks[0]["os_g"]["states_device"],
                    "os_g": ranks[0]["os_g"]["param_bytes"],
                    "p_g_os": ranks[0]["p_g_os"]["param_bytes"]}
        log(f"[experts] 20c: spawn to join {wall:.1f} s")
        save = [o["save"] for o in ranks]
        secs, nbytes, loss, n = _load_20d(ckpt, with_states,
                                          save[0]["digests"], ids, labels)
        diff = max(abs(loss - s["next"]) for s in save)
        log(f"[experts] 20d: p_g_os ranks' save_state_dict (async) of "
            f"{nbytes / 1e9:.3f} GB: the call returned in "
            f"{max(s['call_s'] for s in save):.2f} s, joined in "
            f"{max(s['join_s'] for s in save):.2f} s "
            f"({nbytes / 1e9 / max(s['join_s'] for s in save):.3f} GB/s); "
            f"load_state_dict at one rank {secs:.2f} s "
            f"({nbytes / 1e9 / secs:.3f} GB/s); {n} tensors bit for bit "
            f"against the ranks' gathered state; next loss {loss:.6f} "
            f"against the ranks' {[s['next'] for s in save]} (diff "
            f"{diff:.3e}, tol {CKPT_TOL})")
        if not diff <= CKPT_TOL:
            raise AssertionError(f"20d: the loaded model's loss {loss} left "
                                 f"the ranks' by {diff}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # 20e
    e_launches = _phase_20e(card, ids, labels, zero_20c)
    log(f"[experts] phase {time.perf_counter() - t_phase:.1f} s")
    return {"20a": a["launches"], "20b": b_launches,
            "20c": c_launches, "20e": e_launches}


# -- phase 21 -----------------------------------------------------------------

# 21a: the reference's hybrid step (__graft_entry__.py:130-164,
# dryrun_multichip): the pipe at dp 2 x mp 2 x pp 2 with SP, experts over
# dp and the parallel CE, 1F1B over 2 microbatches, at the 0.44B widths
# with the depth cut from 12 to 2 (one layer a stage; 4 until the run
# had to make room for phase 27 in its time limit) and 8 experts a layer
# (top-2, capacity factor 1.25); canonical keys 0 (embedding), 1-2 (the
# decoder layers) and 3 (norm and head)
HYBRID = dict(TRAIN, num_hidden_layers=2, moe_num_experts=8, moe_top_k=2,
              use_parallel_cross_entropy=True)
HYBRID_MICRO = 2
# 21a holds both dtypes at the same limits: step 1's loss within
# FLEET_CHECK_TOL, its gradients within FLEET_GRAD_REL_TOL, steps 2-3
# within MOE_DRIFT_TOL. In bf16, mp 2's partial sums round otherwise
# than one card's products and flip near-tied gate choices; the capacity
# then drops other tokens, and a few flips part the whole step from one
# card by more than those limits. So the bf16 ranks route by one card's
# expert choices (``_steer_choices``: their own softmax, gates, counts,
# slots and capacity, only the argmax handed over) and print how many
# of their own differ; in fp32 the ranks' gates choose for themselves.
_L = HYBRID["num_hidden_layers"]  # the pipe's last decoder layer's index
HYBRID_LEAVES = ("0.embed_tokens.weight", "1.self_attn.qkv_proj.weight",
                 "1.mlp.gate_weight", "1.mlp.w_in",
                 f"{_L}.post_attention_layernorm.weight",
                 f"{_L}.self_attn.o_proj.weight", f"{_L + 1}.norm.weight",
                 f"{_L + 1}.lm_head.weight")
# 21b: ERNIE at the 10B widths, trunk 4 of 48, attention dropout 0.1 (its
# pretraining rate), hidden dropout 0; the pipe as phase 18c builds it
ERNIE_MP = dict(num_hidden_layers=4, dtype="bfloat16",
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.1)
ERNIE_MP_STEPS = 2
ERNIE_MP_SEED = 21
# 21b's step-1 gradients: attention weights before and after the dropout
ERNIE_MP_LEAVES = ("ernie.encoder.0.attention.qkv.weight",
                   "ernie.encoder.3.attention.out.weight")
# kernels 4-6 as an mp-2 rank of 21b calls them: the trunk's b4 s1024,
# 32 of the 64 heads of d 64 (this rank's the second half), dropout 0.1
HYBRID_HB_CASE = ("21b mp 2 rank 1 trunk", ERNIE_BATCH, ERNIE_SEQ,
                  ERNIE_SEQ, 32, 32, False, 0, torch.bfloat16, False, 64)
HYBRID_HB_COORDS = (0, 32, 64)
# kernels 1-3 as a 21a rank calls them: a microbatch's 2 rows of its dp
# rank, the whole sequence (SP gathers it), 6 of the 12 heads
HYBRID_FLASH_CASE = ("21a rank", TRAIN_BATCH // HYBRID_MICRO // 2,
                     TRAIN_SEQ, TRAIN_SEQ, 6, 6, True, 0, 128)


def _thin(key, g):
    """A leaf cut to a sample that spans every shard: the vocab-sized
    ones every 8th vocab row, the experts every 16th hidden unit, the
    fused projections every 4th input row."""
    if key.endswith("embed_tokens.weight"):
        return g[::8]
    if key.endswith("lm_head.weight"):
        return g[:, ::8]
    if key.endswith("mlp.w_in"):
        return g[:, :, ::16]
    if key.endswith("proj.weight"):
        return g[::4]
    if key.startswith("ernie."):  # 21b's [4096, 12288] and [4096, 4096]
        return g[::16]
    return g


def _global_leaves(module, keys):
    """The gradients of ``module``'s ``keys`` that it holds, as global
    fp32 arrays (gathered over their layout's axis: collective over mp
    or dp), thinned by ``_thin``."""
    from paddle_tpu_torch.distributed.shard import gather_global

    params = dict(module.named_parameters())
    out = {}
    for k in keys:
        if k not in params:
            continue
        p = params[k]
        g = p.grad.detach()
        lay = getattr(p, "_dist_layout", None)
        if lay is not None:
            g = gather_global(g.contiguous(), lay)
        out[k] = _thin(k, g).float().cpu().numpy()
    return out


def _micro_rows(dp, r, n_micro=HYBRID_MICRO, b=TRAIN_BATCH):
    """The rows dp rank ``r`` takes: its chunk of each microbatch."""
    return np.arange(b).reshape(n_micro, dp, -1)[:, r].reshape(-1)


def _hybrid_pipe(extra=None, seed=0):
    """The hybrid cell's pipe (HYBRID with ``extra``) on this rank's
    stage, its weights from ``seed`` (every layout builds the same
    model), and its optimizer."""
    from paddle_tpu_torch.models import LlamaForCausalLMPipe

    pipe = LlamaForCausalLMPipe(LlamaConfig(**dict(HYBRID, **(extra or {}))),
                                device="cuda", seed=seed)
    return pipe, _fleet_optimizer(pipe)


def _stage_moe(pipe):
    """This stage's MoE layers by canonical index."""
    return {k: m.mlp for k, m in pipe._modules.items()
            if hasattr(getattr(m, "mlp", None), "route")}


def _pipe_one_card(extra, ids, labels, steps):
    """The yardstick of 21a and 21c: the pipe at pp 1 on one card, its 2
    microbatches run in turn as the pipeline runs them (the loss of
    each divided by the whole batch's count, the gate per microbatch),
    ``steps`` steps. Returns (losses, step 1's leaves, step 1's routing
    of layer 1 in microbatch 0 or None, every gate call's expert choices
    ``[calls, top_k, tokens]`` by layer in call order)."""
    pipe, opt = _hybrid_pipe(extra)
    xs, ys = ids.chunk(HYBRID_MICRO), labels.chunk(HYBRID_MICRO)
    count = sum(pipe.loss_fn.token_count(y) for y in ys)
    losses, leaves = [], None
    moe = _stage_moe(pipe)
    routes = _next_routes([moe[k] for k in moe if k == "1"])
    choices = _steer_choices(moe)
    for i in range(steps):
        opt.clear_grad()
        total = torch.zeros((), device="cuda")
        for x, y in zip(xs, ys):
            loss = pipe.loss_fn(pipe(x), y, count=count)
            loss.backward()
            total += loss.detach()
        if i == 0:
            leaves = _global_leaves(pipe, HYBRID_LEAVES)
        opt.step()
        losses.append(float(total))
    choices = {k: torch.stack(c).cpu().numpy() for k, c in choices.items()}
    del pipe, opt
    _release()
    return losses, leaves, routes[0] if routes else None, choices


def _pipe_rank_run(net, pipe, opt, batch, steps, leaves=False):
    """``steps`` ``train_batch`` steps (step 1 split to read the
    gradients when ``leaves``); returns (losses, ms, step 1's leaves)."""
    losses, ms, got = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        if i == 0 and leaves:
            loss = net.forward_backward_pipeline(batch)
            net._reduce_gradients()
            torch.cuda.synchronize()
            t0 -= time.perf_counter()
            got = _global_leaves(pipe, HYBRID_LEAVES)
            t0 += time.perf_counter()
            opt.step()
            opt.clear_grad()
        else:
            loss = net.train_batch(batch, opt)
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, got


ALL_WRAPPERS = FLASH_WRAPPERS + HB_WRAPPERS + (pa.paged_attend,
                                               pa.paged_attend_int8)


def _reset_launches():
    for w in ALL_WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _launch_counts():
    return {w.__name__: w.launches for w in ALL_WRAPPERS}


def _my_choices(choices, dp, mp):
    """A 21a rank's part of one card's gate choices ({layer: ``[calls,
    top_k, tokens]``}): its 2 rows of each microbatch and its sequence
    half of each row, in its own token order."""
    half = TRAIN_SEQ // 2
    return {k: c.reshape(c.shape[:2] + (-1, TRAIN_SEQ))[
        :, :, 2 * dp:2 * dp + 2, mp * half:(mp + 1) * half].reshape(
            c.shape[:2] + (-1,)) for k, c in choices.items()}


def _rank_21a(root, ids, labels, choices):
    """One of 21a's eight ranks sharing the card: the hybrid pipe at dp 2
    x mp 2 x pp 2 with SP and the experts over dp, 1F1B, 3 steps, in
    bf16 with each gate call routed by its part of one card's
    ``choices``, then in fp32 with its own gates (one spawn for both:
    the eight processes' start-up is most of a run). Saves each dtype's
    results under its name and its leaves as ``<dtype>/<key>``."""
    from paddle_tpu_torch.distributed import fleet

    dist = _rank_setup(root)
    fleet.init(is_collective=True, strategy=_strategy(
        dp=2, mp=2, pp=2, pipeline={"accumulate_steps": HYBRID_MICRO,
                                    "schedule": "1F1B"}))
    out, arrays = {}, {}
    for dtype, steer in (("bfloat16", choices), ("float32", None)):
        got, leaves = _rank_21a_run(dist, fleet, ids, labels, dtype, steer)
        out[dtype] = got
        arrays.update({f"{dtype}/{k}": v for k, v in leaves.items()})
    _save_rank(root, out, arrays)
    dist.destroy_process_group()


def _rank_21a_run(dist, fleet, ids, labels, dtype, choices):
    """One dtype's run of a 21a rank: (its results, its leaves)."""
    hcg = fleet.get_hybrid_communicate_group()
    dp, mp = hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank()
    pipe, opt = _hybrid_pipe({"sequence_parallel": True, "dtype": dtype})
    net = fleet.distributed_model(pipe)
    opt = fleet.distributed_optimizer(opt)
    rows = _micro_rows(2, dp)
    batch = tuple(torch.from_numpy(a[rows]).cuda() for a in (ids, labels))
    stage = _stage_moe(pipe)
    moe = list(stage.values())
    routes = _next_routes([stage[k] for k in stage if k == "1"])
    differ = _steer_choices(stage, None if choices is None
                            else _my_choices(choices, dp, mp))
    _reset_launches()
    losses, ms, leaves = _pipe_rank_run(net, pipe, opt, batch, FLEET_STEPS,
                                        leaves=True)
    if routes:
        leaves = dict(leaves, routes=routes[0])
    out = {"losses": losses, "ms": ms, "launches": _launch_counts(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "coords": [dp, mp, hcg.get_stage_id()],
           "layers": sorted(int(k) for k in pipe._modules),
           "experts": moe[0].w_in.shape[0],
           "heads": next(m for m in pipe.children()
                         if hasattr(m, "self_attn")).self_attn._nh,
           "counters": dict(pipe.counters),
           "dispatched": [[int(x) for x in m.dispatched] for m in moe],
           "comm_bytes": sum(m.comm_bytes for m in moe) // FLEET_STEPS,
           # how many of its own choices differ from one card's, a step
           "differ": None if choices is None else [
               sum(int(n) for c in differ.values()
                   for n in c[i * HYBRID_MICRO:(i + 1) * HYBRID_MICRO])
               for i in range(FLEET_STEPS)]}
    del net, pipe, opt
    _release()
    if dist.get_rank() == 0 and dtype == "bfloat16":  # launches read
        _flash_check(HYBRID_FLASH_CASE,
                     torch.Generator("cuda").manual_seed(21), fused=True)
    return out, leaves


def _ernie_mp_model():
    """21b's ERNIE (10B widths, trunk 4, attention dropout 0.1, every
    parameter bf16) and its optimizer, the dropout seeded alike on every
    layout."""
    cfg = ErnieConfig(**ERNIE_MP)
    model = ErnieForPretraining(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    trandom.seed(ERNIE_MP_SEED)
    return model, _fleet_optimizer(model), _ernie_batch(cfg, ERNIE_BATCH,
                                                        ERNIE_SEQ)


def _ernie_mp_steps(net, opt, batch, model):
    """21b's steps; returns (losses, ms a step, step 1's ERNIE_MP_LEAVES
    of ``model``)."""
    ids, mlm, lm = batch
    losses, ms, leaves = [], [], None
    for i in range(ERNIE_MP_STEPS):
        t0 = time.perf_counter()
        opt.clear_grad()
        loss = net(ids, mlm_labels=mlm, lm_labels=lm)
        loss.backward()
        if i == 0:
            torch.cuda.synchronize()
            t0 -= time.perf_counter()
            leaves = _global_leaves(model, ERNIE_MP_LEAVES)
            t0 += time.perf_counter()
        opt.step()
        losses.append(float(loss.detach()))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, leaves


def _rank_21_two(root, ids, labels, fault):
    """One of two ranks sharing the card: 21b ERNIE at mp 2 (2 steps,
    dropout 0.1; with ``fault`` each rank hashes its launches' own
    heads), then 21c the MoE Llama with SP at mp 2 (1 step)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn.functional import attention as tattn

    dist = _rank_setup(root)
    out = {}
    fleet.init(is_collective=True, strategy=_strategy(mp=2))
    model, opt, batch = _ernie_mp_model()
    net = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    coords = tattn._dropout_coords
    if fault:
        tattn._dropout_coords = lambda q: None
    _reset_launches()
    losses, ms, leaves = _ernie_mp_steps(net, opt, batch, model)
    tattn._dropout_coords = coords
    attn = model.ernie.encoder[0].attention
    out["ernie_mp2"] = {
        "losses": losses, "ms": ms, "launches": _launch_counts(),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "heads": attn.num_heads,
        "params": sum(p.numel() for p in model.parameters())}
    del net, model, opt
    _release()
    fleet.init(is_collective=True, strategy=_strategy(mp=2))
    cfg = LlamaConfig(**dict(HYBRID, sequence_parallel=True))
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    net = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(_fleet_optimizer(model))
    ids, labels = (torch.from_numpy(a).cuda() for a in (ids, labels))
    _reset_launches()
    t0 = time.perf_counter()
    loss = net(ids, labels)
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    out["moe_mp2_sp"] = {
        "losses": [float(loss.detach())],
        "ms": [(time.perf_counter() - t0) * 1e3],
        "launches": _launch_counts(),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "dispatched": [[int(x) for x in blk.mlp.dispatched]
                       for blk in model.llama.layers]}
    del net, model, opt, loss
    _release()
    _save_rank(root, out, leaves)
    dist.destroy_process_group()


# 21b's pipe and 21c's three pipes, each on four ranks: (tag, degrees,
# the pipe's extra config, steps)
HYBRID_FOUR = (
    ("ernie_pp2_mp2", dict(pp=2, mp=2), None, ERNIE_PIPE_STEPS),
    ("ring_pp2_sep2_moe", dict(pp=2, sep=2),
     dict(context_parallel=True, context_parallel_mode="ring"), 1),
    ("ulysses_pp2_sep2", dict(pp=2, sep=2),
     dict(context_parallel=True, context_parallel_mode="ulysses",
          moe_num_experts=0), 1),
    ("sp_pp2_mp2", dict(pp=2, mp=2),
     dict(sequence_parallel=True, moe_num_experts=0), 1),
)


# 21c's legs of SP with context parallelism at mp 2 x sep 2, the
# LlamaForCausalLM at the hybrid cell's depth without experts: (tag, mode)
HYBRID_SP_CP = (("sp_ring_mp2_sep2", "ring"),
                ("sp_ulysses_mp2_sep2", "ulysses"))


def _rank_21_four(root, ids, labels):
    """One of four ranks sharing the card: 21b's ERNIE pipe at pp 2 x mp
    2, then 21c's pipes (ring with the experts, Ulysses, SP), then 21c's
    SP with ring and with Ulysses at mp 2 x sep 2 (one step each)."""
    from paddle_tpu_torch.distributed import fleet

    dist = _rank_setup(root)
    out = {}
    for tag, degrees, extra, steps in HYBRID_FOUR:
        fleet.init(is_collective=True, strategy=_strategy(
            **degrees, pipeline={"accumulate_steps": HYBRID_MICRO,
                                 "schedule": "1F1B"}))
        hcg = fleet.get_hybrid_communicate_group()
        if tag.startswith("ernie"):
            pipe, opt = _ernie_pipe()
            batch = _ernie_pipe_batch()
        else:
            pipe, opt = _hybrid_pipe(extra)
            batch = [torch.from_numpy(a).cuda() for a in (ids, labels)]
            if degrees.get("sep"):  # this rank's sequence chunk
                q = hcg.get_sep_parallel_rank()
                batch = [t.chunk(2, 1)[q].contiguous() for t in batch]
        net = fleet.distributed_model(pipe)
        opt = fleet.distributed_optimizer(opt)
        _reset_launches()
        losses, ms, _ = _pipe_rank_run(net, pipe, opt, tuple(batch), steps)
        out[tag] = {
            "losses": losses, "ms": ms, "launches": _launch_counts(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "stage": hcg.get_stage_id(),
            "seq": hcg.get_sep_parallel_rank()
            if degrees.get("sep") else hcg.get_model_parallel_rank(),
            "counters": dict(pipe.counters),
            "layers": sorted(int(k) for k in pipe._modules)}
        del net, pipe, opt
        _release()
    for tag, mode in HYBRID_SP_CP:
        fleet.init(is_collective=True, strategy=_strategy(mp=2, sep=2))
        hcg = fleet.get_hybrid_communicate_group()
        model = LlamaForCausalLM(LlamaConfig(**dict(
            HYBRID, moe_num_experts=0, sequence_parallel=True,
            context_parallel=True, context_parallel_mode=mode)),
            device="cuda", generator=torch.Generator("cuda").manual_seed(0))
        net = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(_fleet_optimizer(model))
        q = hcg.get_sep_parallel_rank()  # this rank's sequence chunk
        x, y = (torch.from_numpy(a).cuda().chunk(2, 1)[q].contiguous()
                for a in (ids, labels))
        _reset_launches()
        t0 = time.perf_counter()
        loss = net(x, y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        out[tag] = {
            "losses": [float(loss.detach())],
            "ms": [(time.perf_counter() - t0) * 1e3],
            "launches": _launch_counts(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "seq": q, "mp": hcg.get_model_parallel_rank(),
            "heads": model.llama.layers[0].self_attn._nh}
        del net, model, opt, loss
        _release()
    _save_rank(root, out)
    dist.destroy_process_group()


def _hold_losses(tag, ranks, want, tol_first, tol_later=None):
    """Every rank's losses against ``want``: step 1 within ``tol_first``,
    the later ones within ``tol_later``; logs, and raises on a miss."""
    first = max(abs(o["losses"][0] - want[0]) for o in ranks)
    later = max([abs(a - b) for o in ranks
                 for a, b in zip(o["losses"][1:], want[1:])] or [0.0])
    log(f"[hybrid] {tag}: every rank's step 1 within {first:.3e} of one "
        f"card's {want[0]:.6f} (tol {tol_first})"
        + (f", steps 2-{len(want)} within {later:.3e} (tol {tol_later})"
           if len(want) > 1 else ""))
    if not first <= tol_first or (len(want) > 1 and not later <= tol_later):
        raise AssertionError(f"{tag}: the ranks' losses "
                             f"{[o['losses'] for o in ranks]} left one "
                             f"card's {want}")


def _log_leaves(tag, arrays, want):
    """Step 1's gradients (every rank's leaves against one card's
    ``want``): logs the worst rank's relative Frobenius errors and
    returns them."""
    err = {}
    for got in arrays:  # a pipe rank holds its stage's leaves only
        for key, a in got.items():
            e = float(np.linalg.norm(a - want[key])
                      / max(np.linalg.norm(want[key]), 1e-30))
            err[key] = max(err.get(key, 0.0), e)
    log(f"[hybrid] {tag}: step 1's gradients against one card's, relative "
        f"Frobenius error (worst rank; tol {FLEET_GRAD_REL_TOL}): "
        + ", ".join(f"{key} {e:.3e}" for key, e in err.items()))
    return err


def _hold_leaves(tag, err):
    if not max(err.values()) <= FLEET_GRAD_REL_TOL:
        raise AssertionError(f"{tag}: gradients left one card's: {err}")


def _hold_launches(tag, ranks, want):
    """Each rank's launches: ``want(o)`` gives {wrapper: n} for rank
    ``o``; a wrapper not named must not launch."""
    for o in ranks:
        exp = want(o)
        got = o["launches"]
        if any(got[n] != exp.get(n, 0) for n in got):
            raise AssertionError(f"{tag}: rank {o['rank']} launched {got}, "
                                 f"expected {exp}")


def _each(wrappers, n):
    return {w.__name__: n for w in wrappers}


def _hybrid_21a(card, dtype, spawned, one, per):
    """21a in ``dtype``: the eight ranks' results (``spawned``, as
    ``_spawn_ranks`` returns them for both dtypes) against one card's
    ``one`` (losses, step 1's leaves and routing of layer 1, every gate
    call's choices); the bf16 ranks were handed those choices. Returns
    rank 0's launches."""
    one_losses, one_leaves, one_routes, one_choices = one
    steer = dtype == "bfloat16"
    ranks = [dict(o[dtype], rank=o["rank"]) for o in spawned[0]]
    prefix = dtype + "/"
    arrays = [{k[len(prefix):]: v for k, v in got.items()
               if k.startswith(prefix)} for got in spawned[1]]
    tag = f"21a {dtype}"
    for o in ranks:
        dp, mp, stage = o["coords"]
        log(f"[hybrid] {tag}: rank {o['rank']} of 8 sharing {card} (dp "
            f"{dp}, mp {mp}, stage {stage}; layers {o['layers']}, "
            f"{o['experts']} experts and {o['heads']} heads a layer here, "
            f"SP): losses {o['losses']}, kernels 1-3 over {FLEET_STEPS} "
            f"steps {o['launches']} (predicted {per} a step x "
            f"{FLEET_STEPS}), peak {o['peak_gib']:.3f} GiB, ms a step "
            f"{[round(x, 1) for x in o['ms']]} (gloo, host-staged: no "
            f"parallel speed), bytes sent {o['counters']['bytes_sent']} in "
            f"{o['counters']['sends']} sends ({HYBRID_MICRO} x "
            f"{FLEET_STEPS} activations or gradients of [2, "
            f"{TRAIN_SEQ // 2}, {TRAIN['hidden_size']}]), tokens "
            f"dispatched a layer at step {FLEET_STEPS} (first, second "
            f"choice; this rank's {2 * TRAIN_SEQ // 2} of a microbatch) "
            f"{o['dispatched']}, dispatch and combine "
            f"{o['comm_bytes'] / 2**20:.1f} MiB a step"
            + (f"; own gate choices unlike one card's (handed over "
               f"instead), a step over its layers and microbatches "
               f"{o['differ']}" if steer else ""))
    # step 1's routing of layer 1 in microbatch 0 against one card's: a
    # rank holds rows 2 dp .. 2 dp + 1 of the microbatch, columns 512 mp
    # onwards; a row is expert x C + slot
    k = HYBRID["moe_top_k"]
    want_routes = one_routes.reshape(k, -1, TRAIN_SEQ)
    cap = _moe_capacity(TRAIN_BATCH // HYBRID_MICRO * TRAIN_SEQ)
    moved = shifted = seen = 0
    for o, got in zip(ranks, arrays):
        if "routes" not in got:
            continue
        dp, mp, _ = o["coords"]
        r = got.pop("routes").reshape(k, 2, TRAIN_SEQ // 2)
        want = want_routes[:, 2 * dp:2 * dp + 2,
                           mp * TRAIN_SEQ // 2:(mp + 1) * TRAIN_SEQ // 2]
        moved += int((r // cap != want // cap).sum())
        shifted += int((r != want).sum())
        seen += r.size
    log(f"[hybrid] {tag}: step 1, layer 1, microbatch 0: of {seen} token "
        f"choices (2 x {seen // 2} tokens, C = {cap}), {moved} to another "
        f"expert or dropped otherwise than on one card, {shifted} in "
        f"another buffer row")
    err = _log_leaves(tag, arrays, one_leaves)
    _hold_losses(tag, ranks, one_losses, FLEET_CHECK_TOL, MOE_DRIFT_TOL)
    if set(err) != set(HYBRID_LEAVES):
        raise AssertionError(f"{tag}: leaves {sorted(err)} read")
    _hold_leaves(tag, err)
    if steer and shifted:  # the same choices take the same slots
        raise AssertionError(f"{tag}: {shifted} buffer rows unlike one "
                             f"card's under its own choices")
    _hold_launches(tag, ranks,
                   lambda o: _each(FLASH_WRAPPERS, per * FLEET_STEPS))
    if any(o["experts"] != HYBRID["moe_num_experts"] // 2
           or o["heads"] != 6 for o in ranks):
        raise AssertionError(f"{tag}: a rank's experts or heads are not "
                             f"half")
    want_bytes = HYBRID_MICRO * FLEET_STEPS * 2 * TRAIN_SEQ // 2 \
        * TRAIN["hidden_size"] * (2 if steer else 4)
    if any(o["counters"]["bytes_sent"] != want_bytes for o in ranks):
        raise AssertionError(f"{tag}: bytes sent "
                             f"{[o['counters'] for o in ranks]}, expected "
                             f"{want_bytes} a rank")
    return ranks[0]["launches"]


def phase_hybrid(card, fault=False):
    """21a the reference's hybrid step at dp 2 x mp 2 x pp 2 (eight ranks
    on gloo) against one card; 21b ERNIE at mp 2 with attention dropout
    against one card (with ``fault`` at the ranks' own heads, which
    must fail), and its pipe at pp 2 x mp 2 against pp 1, kernels 4-6
    at a rank's global coordinates; 21c the pipe under context
    parallelism with the experts, Ulysses, the pipe with SP and the
    experts under SP."""
    t_phase = time.perf_counter()
    _release()
    ids, labels = _train_batch(TRAIN["vocab_size"], TRAIN_BATCH, TRAIN_SEQ)
    batch = (ids.cpu().numpy(), labels.cpu().numpy())
    layers = HYBRID["num_hidden_layers"]
    per = layers // 2 * HYBRID_MICRO  # a stage's attention calls a step
    # the yardsticks on one card
    one_moe = _pipe_one_card(None, ids, labels, FLEET_STEPS)
    one_dense = _pipe_one_card({"moe_num_experts": 0}, ids, labels, 1)[0]
    model = LlamaForCausalLM(LlamaConfig(**HYBRID), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        one_moe_llama = float(model(ids, labels))
    del model
    model = LlamaForCausalLM(LlamaConfig(**dict(HYBRID, moe_num_experts=0)),
                             device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        one_dense_llama = float(model(ids, labels))
    del model
    model, opt, ebatch = _ernie_mp_model()
    _reset_launches()
    one_ernie, one_ernie_ms, one_ernie_leaves = _ernie_mp_steps(
        model, opt, ebatch, model)
    one_ernie_launches = _launch_counts()
    one_ernie_peak = torch.cuda.max_memory_allocated() / 2**30
    del model, opt
    _release()
    if "ernie_pipe_one" not in READINGS:
        pipe, opt = _ernie_pipe()
        eb = _ernie_pipe_batch()
        losses = []
        for _ in range(ERNIE_PIPE_STEPS):
            opt.clear_grad()
            loss = pipe.loss_fn(pipe(eb[0]), eb[1])
            loss.backward()
            opt.step()
            losses.append(float(loss))
        READINGS["ernie_pipe_one"] = losses
        del pipe, opt, loss
        _release()
    log(f"[hybrid] one card: the hybrid pipe (the 0.44B widths, "
        f"{layers} layers, {HYBRID['moe_num_experts']} experts, top-2, "
        f"b{TRAIN_BATCH} x s{TRAIN_SEQ} in {HYBRID_MICRO} microbatches) "
        f"losses {one_moe[0]}; without experts step 1 {one_dense[0]:.6f}; "
        f"the MoE LlamaForCausalLM (aux loss included) step 1 "
        f"{one_moe_llama:.6f}, without experts {one_dense_llama:.6f}; "
        f"ERNIE at the 10B widths (trunk "
        f"{ERNIE_MP['num_hidden_layers']}, attention dropout 0.1) losses "
        f"{one_ernie}, ms {[round(x, 1) for x in one_ernie_ms]}, peak "
        f"{one_ernie_peak:.3f} GiB, launches {one_ernie_launches}; its pipe "
        f"(dropout 0) at pp 1 {READINGS['ernie_pipe_one']}")
    # 21b (mp 2) and 21c (the experts under SP without the pipe)
    ranks, arrays, wall = _spawn_ranks(_rank_21_two, batch + (fault,))
    ernie_layers = 2 * (ERNIE_MP["num_hidden_layers"]
                        + ErnieConfig().num_task_layers)
    tag = "21b ERNIE mp 2" + (" (--fault dropout: each rank hashes its "
                              "launches' own heads)" if fault else "")
    for o in ranks:
        r = o["ernie_mp2"]
        log(f"[hybrid] {tag}: rank {o['rank']} of 2 ({r['params'] / 1e9:.3f} "
            f"B parameters here, {r['heads']} trunk heads), attention "
            f"dropout 0.1: losses {r['losses']}, launches {r['launches']} "
            f"(kernels 4-6 predicted {ernie_layers} a step), peak "
            f"{r['peak_gib']:.3f} GiB, ms a step "
            f"{[round(x, 1) for x in r['ms']]} (host-staged)")
    err = _log_leaves(tag, arrays, one_ernie_leaves)
    _hold_losses(tag, [dict(o["ernie_mp2"], rank=o["rank"]) for o in ranks],
                 one_ernie, FLEET_CHECK_TOL, FLEET_CHECK_TOL)
    if set(err) != set(ERNIE_MP_LEAVES):
        raise AssertionError(f"{tag}: leaves {sorted(err)} read")
    _hold_leaves(tag, err)
    _hold_launches(tag, [dict(o["ernie_mp2"], rank=o["rank"])
                         for o in ranks],
                   lambda o: _each(HB_WRAPPERS,
                                   ernie_layers * ERNIE_MP_STEPS))
    if any(o["ernie_mp2"]["heads"] != 32 for o in ranks):
        raise AssertionError("21b: a rank does not hold 32 trunk heads")
    launches = {"21b": ranks[0]["ernie_mp2"]["launches"]}
    for o in ranks:
        r = o["moe_mp2_sp"]
        log(f"[hybrid] 21c: rank {o['rank']} of 2, the MoE LlamaForCausalLM "
            f"with SP at mp 2 (each rank routes its {TRAIN_SEQ // 2} "
            f"columns of every row into the global slots): loss "
            f"{r['losses']}, launches {r['launches']}, peak "
            f"{r['peak_gib']:.3f} GiB, tokens dispatched a layer "
            f"{r['dispatched']}")
    _hold_losses("21c MoE SP mp 2", [dict(o["moe_mp2_sp"], rank=o["rank"])
                                     for o in ranks], [one_moe_llama],
                 FLEET_CHECK_TOL)
    _hold_launches("21c MoE SP mp 2", [dict(o["moe_mp2_sp"], rank=o["rank"])
                                       for o in ranks],
                   lambda o: _each(FLASH_WRAPPERS, layers))
    log(f"[hybrid] 21b/21c two ranks: spawn to join {wall:.1f} s")
    _enc_check(HYBRID_HB_CASE, "kernels 4-6",
               torch.Generator("cuda").manual_seed(21),
               coords=HYBRID_HB_COORDS)
    # 21a: eight ranks, bf16 (the main path), then fp32, in one spawn
    one_fp32 = _pipe_one_card({"dtype": "float32"}, ids, labels,
                              FLEET_STEPS)
    spawned = _spawn_ranks(_rank_21a, batch + (one_moe[3],), n=8)
    launches["21a"] = _hybrid_21a(card, "bfloat16", spawned, one_moe, per)
    _hybrid_21a(card, "float32", spawned, one_fp32, per)
    log(f"[hybrid] 21a: spawn to join {spawned[2]:.1f} s (both dtypes)")
    # 21b's pipe and 21c's pipes on four ranks
    ranks, _, wall = _spawn_ranks(_rank_21_four, batch, n=4)
    ec = ErnieConfig(**ERNIE_PIPE)
    trunk = ec.num_hidden_layers // 2
    yard = {"ernie_pp2_mp2": READINGS["ernie_pipe_one"],
            "ring_pp2_sep2_moe": one_moe[0][:1],
            "ulysses_pp2_sep2": one_dense, "sp_pp2_mp2": one_dense}
    for tag, _, _, steps in HYBRID_FOUR:
        rs = [dict(o[tag], rank=o["rank"]) for o in ranks]
        for o in rs:
            log(f"[hybrid] {tag}: rank {o['rank']} of 4 (stage "
                f"{o['stage']}, {'sep' if 'sep' in tag else 'mp'} rank "
                f"{o['seq']}; layers {o['layers']}): losses {o['losses']}, "
                f"launches {o['launches']}, peak {o['peak_gib']:.3f} GiB, "
                f"ms a step {[round(x, 1) for x in o['ms']]} "
                f"(host-staged), counters {o['counters']}")
        _hold_losses(tag, rs, yard[tag][:steps],
                     ERNIE_PIPE_TOL if tag.startswith("ernie")
                     else FLEET_CHECK_TOL, ERNIE_PIPE_TOL)
        if tag.startswith("ernie"):
            want = lambda o: _each(FLASH_WRAPPERS, (
                trunk + (ec.num_task_layers if o["stage"] else 0))
                * HYBRID_MICRO * steps)
        elif tag.startswith("ring"):  # the later block skipped on rank 0
            want = lambda o: _each(FLASH_WRAPPERS,
                                   per * steps * (1 + o["seq"]))
        else:
            want = lambda o: _each(FLASH_WRAPPERS, per * steps)
        _hold_launches(tag, rs, want)
        launches[tag] = rs[0]["launches"]
    for tag, mode in HYBRID_SP_CP:
        rs = [dict(o[tag], rank=o["rank"]) for o in ranks]
        for o in rs:
            log(f"[hybrid] 21c {tag}: rank {o['rank']} of 4 (sep rank "
                f"{o['seq']}, mp rank {o['mp']}; {o['heads']} heads, the "
                f"residual stream [{TRAIN_BATCH}, {TRAIN_SEQ // 4}, "
                f"{TRAIN['hidden_size']}]): loss {o['losses']}, launches "
                f"{o['launches']}, peak {o['peak_gib']:.3f} GiB, ms a step "
                f"{[round(x, 1) for x in o['ms']]} (host-staged)")
        _hold_losses(f"21c {tag}", rs, [one_dense_llama], FLEET_CHECK_TOL)
        if mode == "ring":  # the later block skipped on sep rank 0
            want = lambda o: _each(FLASH_WRAPPERS, layers * (1 + o["seq"]))
        else:
            want = lambda o: _each(FLASH_WRAPPERS, layers)
        _hold_launches(f"21c {tag}", rs, want)
        if any(o["heads"] != 6 for o in rs):
            raise AssertionError(f"21c {tag}: a rank does not hold 6 heads")
        launches[tag] = rs[0]["launches"]
    log(f"[hybrid] 21b/21c four ranks: spawn to join {wall:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 22 -----------------------------------------------------------------

# BASELINE config 2 (benchmarks/baseline_configs.py:28-66): ResNet-50 at
# ImageNet shapes, AMP O2 bf16, Momentum(0.1, 0.9, multi_precision),
# TrainStep(donate=True), one seeded batch stepped on
RESNET_BATCH, RESNET_HW = 256, 224
RESNET_WARMUP, RESNET_TIMED = 2, 10
RESNET_FLOPS_PER_IMG = 3 * 4.1e9  # training ~ 3 x 4.1 GFLOP forward
RESNET_LOSS0_TOL = 1.0            # the first loss within this of ln(1000)
# 22b: the tiny fp32 ResNet-18, card against CPU
VISION_TINY = dict(batch=4, hw=64, classes=10, steps=5, lr=1e-3)
VISION_REL_TOL = 1e-4
# 22c: config 1 (tests/test_mnist_e2e.py) and LeNet through fit
MNIST_N, MNIST_BATCH, MNIST_EPOCHS = 512, 64, 3


def _resnet50_step(fmt):
    """``build_resnet_trainstep`` of ``benchmarks/baseline_configs.py`` on
    the port, at full width. Returns (model, step, x, y)."""
    from paddle_tpu_torch import nn, vision
    from paddle_tpu_torch.optimizer import Momentum

    gen = torch.Generator("cuda").manual_seed(0)
    model = vision.resnet50(data_format=fmt, device="cuda", generator=gen)
    model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters(), multi_precision=True)
    loss_fn = nn.CrossEntropyLoss()
    step = TrainStep(model, opt, lambda m, x, y: loss_fn(m(x), y),
                     donate=True)
    shape = ((RESNET_BATCH, 3, RESNET_HW, RESNET_HW) if fmt == "NCHW"
             else (RESNET_BATCH, RESNET_HW, RESNET_HW, 3))
    x = (torch.randn(shape, device="cuda", generator=gen) * 0.1).to(
        torch.bfloat16)
    y = torch.randint(0, 1000, (RESNET_BATCH, 1), device="cuda",
                      generator=gen)
    return model, step, x, y


# a kernel's kind by its name, the first match wins (cuDNN's batch-norm
# kernels are cudnn::bn_*: batch norm before conv)
_KINDS = (("batch norm", ("batch_norm", "bn_", "batchnorm")),
          ("conv", ("conv", "xmma", "gemm", "cudnn", "implicit", "sm90",
                    "dgrad", "wgrad")),
          ("pool", ("pool",)),
          ("optimizer", ("foreach", "multi_tensor")))


def _replay_profile(step):
    """One replay of the step's graph under ``torch.profiler``: kernels,
    device ms, and the device ms by kind (by kernel name)."""
    entry = next(iter(step._cache.values())).graphs["step"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        entry.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    split = {}
    for e in kernels:
        key = e.key.lower()
        kind = next((k for k, marks in _KINDS
                     if any(m in key for m in marks)), "elementwise/other")
        split[kind] = split.get(kind, 0.0) + e.self_device_time_total / 1e3
    return (sum(e.count for e in kernels),
            sum(e.self_device_time_total for e in kernels) / 1e3, split)


def _resnet50_run(card, fmt):
    """22a in one layout: 2 warm-up and 10 timed graph replays; returns
    the readings."""
    model, step, x, y = _resnet50_step(fmt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    means, losses = [model.bn1._mean.clone()], []
    t_first = time.perf_counter()
    for i in range(RESNET_WARMUP + RESNET_TIMED):
        if i == RESNET_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(x, y))
        means.append(model.bn1._mean.clone())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / RESNET_TIMED * 1e3
    first_s = t0 - t_first
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    moved = [not torch.equal(a, b) for a, b in zip(means, means[1:])]
    kernels, dev_ms, split = _replay_profile(step)
    mem = step.memory_analysis(x, y)
    ips = RESNET_BATCH / (ms / 1e3)
    mfu = ips * RESNET_FLOPS_PER_IMG / PEAK_OPS_PER_S[torch.bfloat16]
    # an eval-mode step (its own signature) moves no running statistic
    before = [b.clone() for b in model.buffers()]
    model.eval()
    step(x[:32], y[:32])
    torch.cuda.synchronize()
    still = all(torch.equal(a, b) for a, b in zip(before, model.buffers()))
    model.train()
    out = dict(fmt=fmt, ms=ms, ips=ips, mfu=mfu, peak=peak, losses=losses,
               moved=moved, kernels=kernels, dev_ms=dev_ms, split=split,
               first_s=first_s, pool_gib=mem.temp_size_in_bytes / 2**30,
               eval_still=still)
    log(f"[vision] 22a ResNet-50 {fmt} b{RESNET_BATCH} x {RESNET_HW} bf16 O2 "
        f"on {card}, cudnn.benchmark on, TrainStep(donate=True) on CUDA "
        f"graphs: {ms:.2f} ms a step ({RESNET_TIMED} timed after "
        f"{RESNET_WARMUP}; the eager first step, its algorithm search and "
        f"the capture took {first_s:.1f} s), {ips:.1f} imgs/s, MFU "
        f"{mfu:.4f} (imgs/s x 3 x 4.1e9 / 989e12), peak {peak:.2f} GiB, "
        f"the capture's pool {out['pool_gib']:.2f} GiB; losses "
        f"{[round(v, 4) for v in losses]}; bn1._mean moved at every step: "
        f"{all(moved)}; an eval-mode step left every buffer as it was: "
        f"{still}; one replay: {kernels} kernels, {dev_ms:.2f} ms of device "
        f"time, by kind "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(
            split.items(), key=lambda kv: -kv[1])))
    del model, step, x, y
    _release()
    return out


def _tiny_resnet(device, weights=None):
    from paddle_tpu_torch import vision

    model = vision.resnet18(num_classes=VISION_TINY["classes"],
                            device=device)
    if weights is not None:
        vision.load_jax_weights(model, weights)
    return model


def _tiny_weights():
    """The tiny ResNet-18's starting weights as 22b was written with:
    ResNet's draws from a generator seeded 0 in construction order, the
    FC weight last and Xavier-uniform. ``Linear``'s default is now the
    reference's XavierNormal, whose draw here starts a trajectory that
    carries the card's and the CPU's rounding past the check's 1e-4
    within the 5 steps (the same code on these weights stays under
    1e-5)."""
    from paddle_tpu_torch import vision

    gen = torch.Generator().manual_seed(0)
    model = vision.resnet18(num_classes=0, device="cpu", generator=gen)
    fc = Linear(512, VISION_TINY["classes"],
                ParamAttr(initializer=initializer.XavierUniform()),
                device="cpu", generator=gen)
    state = dict(model.state_dict(), **{f"fc.{k}": v for k, v
                                        in fc.state_dict().items()})
    return {k: v.numpy() for k, v in state.items()}


def _tiny_vision_batch(i, device):
    rng = np.random.RandomState(300 + i)
    t = VISION_TINY
    x = rng.randn(t["batch"], 3, t["hw"], t["hw"]).astype(np.float32)
    y = rng.randint(0, t["classes"], (t["batch"], 1)).astype(np.int64)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def _tiny_vision_run(device, weights, graphs, nan_check=None):
    """The tiny fp32 ResNet-18's Momentum steps; returns (losses, the
    parameters as one fp64 CPU vector after each step, model, optimizer,
    call). On the card the eager steps round as a captured
    step's do (``_graph_like_steps``): the first with Python scalars,
    the later ones reading the rate from device scalars (a separate
    multiply, one rounding more than the eager FMA)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Momentum

    model = _tiny_resnet(device, weights)
    opt = Momentum(learning_rate=VISION_TINY["lr"], momentum=0.9,
                   parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()

    def loss_of(m, x, y):
        return loss_fn(m(x), y)

    if graphs:
        call = TrainStep(model, opt, loss_of, nan_check=nan_check)
    else:
        buf = torch.zeros(2, dtype=torch.float64, device=device)

        def call(x, y):
            opt.clear_grad()
            loss = loss_of(model, x, y)
            loss.backward()
            if device == "cuda" and opt._global_step:
                buf.copy_(torch.tensor([float(opt.get_lr()),
                                        float(opt._global_step + 1)],
                                       dtype=torch.float64))
                opt._dev_scalars = buf
            try:
                opt.step()
            finally:
                opt._dev_scalars = None
            return loss.detach()
    losses, params = [], []
    for i in range(VISION_TINY["steps"]):
        losses.append(float(call(*_tiny_vision_batch(i, device))))
        params.append(torch.cat([p.detach().double().cpu().flatten()
                                 for p in model.parameters()]))
    return losses, params, model, opt, call


def _max_rel(a_model, b_model):
    """For each kind of tensor, (the largest difference over its scale,
    the tensor's name): running means over their channels' running
    standard deviation (a batch mean of zero-centred activations
    cancels, so its own magnitude is no scale), running variances and
    parameters over their own largest magnitude."""
    want = {n: t.detach().cpu().double()
            for n, t in b_model.state_dict().items()}
    worst = {}
    for n, a in a_model.state_dict().items():
        a, b = a.detach().cpu().double(), want[n]
        if n.endswith("._mean"):
            scale = want[n[:-len("_mean")] + "_variance"].sqrt().max()
            kind = "means"
        else:
            scale = b.abs().max()
            kind = "variances" if n.endswith("._variance") else "params"
        err = ((a - b).abs().max() / scale.clamp(min=1e-30)).item()
        worst[kind] = max(worst.get(kind, (0.0, None)), (err, n),
                          key=lambda e: e[0])
    return worst


def _vision_identity(card):
    """22b: card against the CPU, graphs against eager, and nan_check."""
    from paddle_tpu_torch.monitor.numerics import NonFiniteError

    weights = _tiny_weights()
    cpu_l, cpu_p, cpu_m, _, _ = _tiny_vision_run("cpu", weights,
                                                 graphs=False)
    torch.backends.cudnn.deterministic = True
    try:
        g_l, g_p, g_m, _, _ = _tiny_vision_run("cuda", weights, graphs=True)
        e_l, _, e_m, _, _ = _tiny_vision_run("cuda", weights, graphs=False)
    finally:
        torch.backends.cudnn.deterministic = False
    ldiff = max(abs(a - b) / abs(b) for a, b in zip(g_l, cpu_l))
    pdiff = [((a - b).norm() / b.norm()).item() for a, b in zip(g_p, cpu_p)]
    diff = _max_rel(g_m, cpu_m)
    same = g_l == e_l and all(torch.equal(a, b) for a, b in zip(
        g_m.state_dict().values(), e_m.state_dict().values()))
    log(f"[vision] 22b tiny fp32 ResNet-18 (b{VISION_TINY['batch']} x "
        f"{VISION_TINY['hw']}, {VISION_TINY['classes']} classes, TF32 off), "
        f"{VISION_TINY['steps']} Momentum steps on {card} (graphs) vs CPU: "
        f"losses {[round(v, 6) for v in g_l]} vs "
        f"{[round(v, 6) for v in cpu_l]}: max relative {ldiff:.2e}; the "
        f"parameters' relative norm distance step by step "
        f"{[f'{e:.2e}' for e in pdiff]}; after the steps running means "
        f"{diff['means'][0]:.2e} of their channels' running std (worst "
        f"{diff['means'][1]}), running variances {diff['variances'][0]:.2e} "
        f"of each one's max (worst {diff['variances'][1]}) (tol "
        f"{VISION_REL_TOL}); read, not held: a parameter tensor's largest "
        f"difference over its own max {diff['params'][0]:.2e} (worst "
        f"{diff['params'][1]}); graphs vs eager rounding as graphs do, "
        f"cuDNN deterministic: bit-identical {same}")
    if not (ldiff <= VISION_REL_TOL and same and max(pdiff) <= VISION_REL_TOL
            and diff["means"][0] <= VISION_REL_TOL
            and diff["variances"][0] <= VISION_REL_TOL):
        raise AssertionError("the tiny ResNet-18 on the card left the CPU's "
                             "or its eager run")
    _, _, model, opt, step = _tiny_vision_run("cuda", weights, graphs=True,
                                              nan_check=True)
    with torch.no_grad():
        model.layer3[0].conv1.weight[0, 0, 0, 0] = float("inf")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    states = [v.clone() for st in opt._accumulators.values()
              for v in st.values()]
    try:
        step(*_tiny_vision_batch(VISION_TINY["steps"], "cuda"))
        raised = None
    except NonFiniteError as e:
        raised = (e.step, e.leaf, e.kind)
    intact = all(torch.equal(v, before[k])
                 for k, v in model.state_dict().items()) and all(
        torch.equal(a, b) for a, b in zip(states, [
            v for st in opt._accumulators.values() for v in st.values()]))
    log(f"[vision] 22b nan_check on the captured step with a weight at inf: "
        f"raised {raised}; parameters, velocities and running statistics "
        f"bit-identical to before the step: {intact}")
    if raised is None or not intact:
        raise AssertionError("nan_check did not restore the vision step")
    del model, opt, step, g_m, e_m
    _release()


def _mnist(n, image=False, seed=0):
    """``tests/test_mnist_e2e.py``'s synthetic data: 10 prototypes plus
    noise."""
    rng = np.random.RandomState(seed)
    protos = rng.rand(10, 784).astype(np.float32)
    labels = rng.randint(0, 10, n)
    imgs = (protos[labels] + 0.1 * rng.randn(n, 784)).astype(np.float32)
    if image:
        imgs = imgs.reshape(n, 1, 28, 28)
    return imgs, labels.astype(np.int64)


def _config1_mlp(card):
    """22c, config 1: the MLP of ``tests/test_mnist_e2e.py:27-60`` trained
    eagerly with Adam on the card."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(784, 128, device="cuda")
            self.fc2 = nn.Linear(128, 64, device="cuda")
            self.fc3 = nn.Linear(64, 10, device="cuda")

        def forward(self, x):
            x = F.relu(self.fc1(x))
            x = F.relu(self.fc2(x))
            return self.fc3(x)

    trandom.seed(0)
    xs, ys = _mnist(MNIST_N)
    model = MLP()
    opt = Adam(learning_rate=1e-3, parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()
    xs_d, ys_d = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    order = np.random.RandomState(0)
    losses = []
    t0 = time.perf_counter()
    for _ in range(MNIST_EPOCHS):
        perm = torch.from_numpy(order.permutation(MNIST_N)).cuda()
        for i in range(0, MNIST_N, MNIST_BATCH):
            idx = perm[i:i + MNIST_BATCH]
            loss = loss_fn(model(xs_d[idx]), ys_d[idx])
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
    losses = [float(v) for v in losses]
    secs = time.perf_counter() - t0
    model.eval()
    with torch.no_grad():
        acc = (model(xs_d).argmax(1) == ys_d).float().mean().item()
    log(f"[vision] 22c config 1 MLP (784-128-64-10) on {card}, eager "
        f"Adam(1e-3), {MNIST_EPOCHS} epochs of {MNIST_N // MNIST_BATCH} "
        f"batches of {MNIST_BATCH}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"accuracy {acc:.4f}, {secs:.2f} s")
    if not (losses[0] > 1.5 and losses[-1] < 0.2 and acc > 0.95):
        raise AssertionError("config 1's MLP did not learn as "
                             "tests/test_mnist_e2e.py asks")


def _lenet_fit(card):
    """22c: LeNet through ``hapi.Model.fit`` (TrainStep on CUDA graphs)
    with ``metric.Accuracy``."""
    from paddle_tpu_torch import metric, nn, vision
    from paddle_tpu_torch.optimizer import Adam

    xs, ys = _mnist(MNIST_N, image=True, seed=1)
    data = io.TensorDataset([xs, ys[:, None]])
    model = vision.LeNet(device="cuda")
    net = hapi.Model(model).prepare(
        Adam(learning_rate=1e-3, parameters=model.parameters()),
        loss=nn.CrossEntropyLoss(), metrics=metric.Accuracy())
    before = net.evaluate(data, batch_size=MNIST_BATCH, verbose=0)
    seen = []

    class Losses(hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(float(logs["loss"]))

    captures = exec_cache.stats()["captures"]
    t0 = time.perf_counter()
    net.fit(data, batch_size=MNIST_BATCH, epochs=MNIST_EPOCHS, log_freq=1,
            verbose=0, callbacks=[Losses()])
    secs = time.perf_counter() - t0
    captured = exec_cache.stats()["captures"] - captures
    after = net.evaluate(data, batch_size=MNIST_BATCH, verbose=0)
    log(f"[vision] 22c LeNet through hapi.Model.fit on {card} (TrainStep on "
        f"CUDA graphs, {captured} capture), Adam(1e-3), {MNIST_EPOCHS} "
        f"epochs of {MNIST_N // MNIST_BATCH} batches: loss {seen[0]:.4f} -> "
        f"{seen[-1]:.4f}; evaluate before {before}, after {after}; "
        f"{secs:.2f} s")
    if not (captured == 1 and seen[-1] < seen[0]
            and after["acc"] > before["acc"] and after["loss"] < before[
                "loss"]):
        raise AssertionError("LeNet did not learn through fit on graphs")
    del model, net
    _release()


def phase_vision(card):
    """Phase 22: BASELINE config 2 at full width in both layouts, the tiny
    ResNet-18's identity and nan_check, config 1 and LeNet."""
    t_phase = time.perf_counter()
    _reset_launches()
    torch.backends.cudnn.benchmark = True
    try:
        runs = [_resnet50_run(card, fmt) for fmt in ("NCHW", "NHWC")]
    finally:
        torch.backends.cudnn.benchmark = False
    for r in runs:
        first = r["losses"][0]
        if not (abs(first - np.log(1000)) <= RESNET_LOSS0_TOL
                and all(np.isfinite(r["losses"]))
                and np.mean(r["losses"][-5:]) < first and all(r["moved"])
                and r["eval_still"]):
            raise AssertionError(
                f"ResNet-50 {r['fmt']}: the loss must start within "
                f"{RESNET_LOSS0_TOL} of ln(1000), stay finite and fall (the "
                f"last five steps' mean below the first), bn1._mean must "
                f"move at every step and not in eval mode")
    _vision_identity(card)
    _config1_mlp(card)
    _lenet_fit(card)
    launched = _launch_counts()
    log(f"[vision] launches of the eight kernels over phase 22 (none lies on "
        f"the vision path): {launched}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if any(launched.values()):
        raise AssertionError("the vision path launched an attention kernel")
    return {r["fmt"]: {k: r[k] for k in ("ms", "ips", "mfu", "peak")}
            for r in runs}


# -- phase 23: the tensor op surface ---------------------------------------------

# fp32 on the card against the CPU, relative to an output's largest
# magnitude: the summation order of reductions and products (TF32 off)
TENSOR_REL_TOL = 1e-4
# modules that must stay out of this process
REFERENCE_MODULES = ("jax", "jaxlib", "paddle_tpu")


def _tensor_tables():
    """``tests/op_specs.py``'s specs and ``tests/torch_tensor_cases.py``
    (free of JAX: the reference's adapters import it only when called;
    ``port_adapted`` gives their twins for the port and refuses one that
    has none)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    sys.path.insert(0, tests)
    try:
        import op_specs
        import torch_tensor_cases as cases
    finally:
        sys.path.remove(tests)
    return op_specs.SPECS, cases


def _no_reference(where):
    """Raises if JAX or the reference package was imported here."""
    bad = sorted(n for n in sys.modules
                 if n.split(".")[0] in REFERENCE_MODULES)
    if bad:
        raise AssertionError(f"{where}: the reference's modules were "
                             f"imported: {bad[:8]}")


def _flat_out(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat_out(x)]
    return [out]


def _float_values(arrays):
    """The finite real components of the float and complex arrays."""
    vals = [np.asarray(a, np.complex128 if np.iscomplexobj(a)
                       else np.float64).ravel() for a in arrays
            if np.asarray(a).dtype.kind in "fc"]
    if not vals:
        return np.zeros(0)
    v = np.concatenate(vals)
    v = np.concatenate([v.real, v.imag]) if np.iscomplexobj(v) else v
    return v[np.isfinite(v)]


def _hold_on_card(row, got, want, inputs, sort_complex=False,
                  tol=TENSOR_REL_TOL, tag="23a"):
    """The card's outputs ``got`` against the CPU's ``want``: the same
    dtypes and shapes, on the card; ints and bools equal, and floats
    equal where the CPU's finite values are all drawn from the row's
    numpy ``inputs`` (or are 0 or 1: the op only moved or selected
    them); other floats within ``tol``; eigenvalues (``sort_complex``)
    sorted first. Returns the worst relative error."""
    got, want = _flat_out(got), _flat_out(want)
    if len(got) != len(want):
        raise AssertionError(f"{tag} {row}: {len(got)} outputs on the card, "
                             f"{len(want)} on the CPU")
    moved = np.concatenate([_float_values(inputs), [0.0, 1.0]])
    worst = 0.0
    for g, w in zip(got, want):
        if not isinstance(w, torch.Tensor):
            if g != w:
                raise AssertionError(f"{tag} {row}: {g!r} on the card, {w!r} "
                                     f"on the CPU")
            continue
        if g.device.type != "cuda" or g.dtype != w.dtype \
                or g.shape != w.shape:
            raise AssertionError(
                f"{tag} {row}: {g.dtype} {tuple(g.shape)} on {g.device}, the "
                f"CPU's {w.dtype} {tuple(w.shape)}")
        gn, wn = g.detach().cpu().numpy(), w.detach().numpy()
        if sort_complex:
            gn, wn = np.sort_complex(gn), np.sort_complex(wn)
        exact = wn.dtype.kind in "biu" or np.isin(
            _float_values([wn]), moved).all()
        if exact:
            if not np.array_equal(gn, wn, equal_nan=True):
                raise AssertionError(f"{tag} {row}: not equal on the card "
                                     f"and the CPU")
            continue
        fin = np.isfinite(wn)
        if not np.array_equal(np.isfinite(gn), fin):
            raise AssertionError(f"{tag} {row}: non-finite entries differ")
        if fin.any():
            scale = float(np.abs(wn[fin]).max()) or 1.0
            err = float(np.abs(gn[fin] - wn[fin]).max()) / scale
            worst = max(worst, err)
            if err > tol:
                raise AssertionError(f"{tag} {row}: relative error {err:.2e} "
                                     f"above {tol}")
    return worst


def _tensor_rows(specs, cases):
    """(row id, numpy inputs, sort_complex, run(m, device)) for every row
    of the two tables and the in-place variants; ``m`` is the port or a
    recorder of it."""
    import importlib

    import paddle_tpu_torch as ptt

    names = {n for m in cases.TENSOR_MODULES for n in dir(
        importlib.import_module(f"paddle_tpu_torch.tensor.{m}"))
        if not n.startswith("_")}
    rows = []
    for sname in cases.tensor_specs(specs, names):
        spec = specs[sname]
        cases.port_adapted(spec)  # refuses an adapter with no twin
        kwargs = dict(spec["kwargs"])
        sort_complex = kwargs.pop("_sort_complex", False)

        def run(m, dev, spec=spec, kwargs=kwargs):
            return cases.port_adapted(spec, m)(*cases.spec_inputs(
                lambda a: ptt.to_tensor(a, place=dev), spec["inputs"]),
                **kwargs)
        rows.append((f"spec {sname}", _flat_out(list(spec["inputs"])),
                     sort_complex, run))
    for rid, call, inputs in cases.CASES:
        def run(m, dev, call=call, inputs=inputs):
            return call(m, *[ptt.to_tensor(np.array(a), place=dev)
                             for a in inputs])
        rows.append((rid, list(inputs), False, run))
    for name in ptt.INPLACE:
        def run(m, dev, name=name):
            x, out = cases.call_inplace(
                m, name, lambda a: ptt.to_tensor(np.array(a), place=dev))
            if out is not x:
                raise AssertionError(f"23a {name}_ did not return its input")
            return x
        rows.append((f"{name}_", [cases.P], False, run))
    return rows


def _tensor_ops_on_card():
    """23a: every table row on the card against the CPU; the worst error
    by the module of the first tensor function each row calls."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.device import using_device

    specs, cases = _tensor_tables()
    worst, held = {}, 0
    torch.backends.cuda.matmul.allow_tf32 = False
    for rid, inputs, sort_complex, run in _tensor_rows(specs, cases):
        rec = cases.Recorder(ptt)
        with using_device("cpu"):
            want = run(rec, "cpu")
        with using_device("gpu"):
            got = run(ptt, "cuda")
        err = _hold_on_card(rid, got, want, inputs, sort_complex)
        held += 1
        mod = cases.module_of(rec.seen)
        if err >= worst.get(mod, (-1.0, ""))[0]:
            worst[mod] = (err, rid)
    _no_reference("23a")
    x = torch.ones(4, 4, device="cuda")
    with amp.auto_cast(dtype="bfloat16"):
        white = ptt.matmul(x, x)
        black = ptt.exp(x.to(torch.bfloat16))
    if white.dtype != torch.bfloat16 or black.dtype != torch.float32:
        raise AssertionError(f"23a auto_cast bf16: matmul gave {white.dtype} "
                             f"(white: bfloat16), exp {black.dtype} (black: "
                             f"float32)")
    return held, {m: (float(f"{e:.3g}"), r) for m, (e, r) in worst.items()}


def _tensor_random_on_card():
    """23b: each random op on the card: seed, moments, draw count."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.device import using_device

    _, cases = _tensor_tables()
    with using_device("gpu"):
        return {name: _random_on_card(ptt, cases, name)
                for name in cases.RANDOM}


def _random_on_card(ptt, cases, name):
    """One random op of 23b; its mean's distance in standard errors."""
    fn, mean, var = cases.draw(ptt, name, "cuda")
    ptt.seed(5)
    before = trandom.draws()
    a = fn()
    counted = trandom.draws() - before
    ptt.seed(5)
    b = fn()
    x = a.double()
    se_mean = (var / x.numel()) ** 0.5
    se_var = (3 * var * var / x.numel()) ** 0.5
    dm, dv = abs(float(x.mean()) - mean), abs(float(x.var()) - var)
    if not (a.is_cuda and counted == 1 and torch.equal(a, b)
            and dm < cases.SIGMAS * se_mean
            and dv < cases.SIGMAS * se_var + 1e-9):
        raise AssertionError(
            f"23b {name}: on {a.device}, {counted} draws counted, "
            f"repeatable {torch.equal(a, b)}, mean off by {dm:.3g} "
            f"({dm / se_mean:.2f} se), variance by {dv:.3g}")
    return round(dm / se_mean, 2)


def _rank_23c(root, ids):
    """One of 23c's two ranks sharing the card: the 0.44B Llama at mp 2
    from one card's weights, ``generate()`` and ``ServingEngine`` on the
    rank's shards, in bf16 and with int8 weights and pools."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    torch.cuda.set_device(0)
    dist.init_parallel_env(backend="gloo", init_method=f"file://{root}/store")
    cfg = LlamaConfig(**FULL)
    full = LlamaForCausalLM(cfg, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
    weights = {n: p.detach() for n, p in full.named_parameters()}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(1))
    load_jax_weights(model, weights)
    del full, weights
    out = {"rank": dist.get_rank(), "shard": tuple(model.lm_head.weight.shape),
           "model_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters())}
    for tag, int8 in (("bf16", False), ("int8", True)):
        _reset_launches()
        t0 = time.perf_counter()
        tokens = generate(model, ids, max_new_tokens=TENSOR_NEW,
                          int8_weights=int8, kv_int8=int8, device="cuda")
        gen_launches = _launch_counts()
        eng = ServingEngine(model, ServingConfig(
            max_seq_len=MAX_SEQ_LEN, int8_weights=int8, kv_int8=int8),
            device="cuda")
        reqs = [eng.submit(row, max_new_tokens=TENSOR_NEW) for row in ids]
        done = eng.run()
        torch.cuda.synchronize()
        st = eng.stats()
        launches = _launch_counts()
        out[tag] = {
            "generate": tokens.cpu().tolist(),
            "engine": [np.asarray(done[r.request_id]).tolist()
                       for r in reqs],
            "seconds": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "weight_bytes": st["weight_bytes"],
            "pool_bytes": st["kv_pool_bytes"],
            "pool_shape": tuple(eng._kpool.shape),
            "phase_modes": st["phase_modes"],
            "graph_replays": st["graph_replays"],
            "decode_steps": st["decode_steps"],
            "verify_steps": st["verify_steps"],
            "generate_launches": gen_launches, "launches": launches}
        del eng
        _release()
    with open(os.path.join(root, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


TENSOR_NEW = 16
# where a rank's int8 engine parts from one card's, one card's logits must
# hold the two tokens within two bf16 ulps of the row's largest logit: a
# tie that the fp32 partial sums over mp break otherwise (int8 pools
# requantize a K/V element that moved by one bf16 ulp)
TIE_REL = 2.0 ** -7


def _tie_gap(model, prompt, toks, t, other):
    """One card's int8 logits (``generate``'s arithmetic, the sequence fed
    at once) after ``prompt`` and ``toks[:t]``: the gap between the
    logits of ``toks[t]`` and ``other``, and the row's largest |logit|."""
    from paddle_tpu_torch.models import generation as tgen

    seq = torch.from_numpy(np.concatenate(
        [prompt, np.asarray(toks[:t], np.int32)])[None]).cuda()
    cfg = tgen._GenCfg(model.config)
    cache = torch.zeros((FULL["num_hidden_layers"], 1, seq.shape[1],
                         cfg.num_key_value_heads, cfg.head_dim),
                        dtype=torch.bfloat16, device="cuda")
    logits = tgen._forward(tgen._collect_params(model, int8_weights=True),
                           seq, cache, cache.clone(), seq.shape[1], cfg,
                           kv_int8=True)[0]
    return (float(logits[toks[t]] - logits[other]),
            float(logits.abs().max()))


def _held_to_a_tie(model, ids, got, want):
    """``got`` (a rank's int8 engine tokens) against one card's ``want``,
    row by row: equal, or equal up to a first parting whose two tokens
    one card's logits hold within ``TIE_REL`` of the row's largest logit.
    Returns (held, [(row, position, gap, largest |logit|)])."""
    ties = []
    for row, (g, w) in enumerate(zip(got, want)):
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if t is None:
            continue
        gap, top = _tie_gap(model, ids[row], w, t, g[t])
        ties.append((row, t, gap, top))
    return all(abs(gap) <= TIE_REL * top for _, _, gap, top in ties), ties


def _decode_at_mp2(card):
    """23c (C.7, A.6): two ranks at mp 2 decode one card's tokens from
    their own shards, bf16 and int8; returns the ranks' launches."""
    ids = np.random.RandomState(3).randint(
        0, FULL["vocab_size"], (2, 8)).astype(np.int32)
    model = LlamaForCausalLM(LlamaConfig(**FULL), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    # one card's tokens, generate() and the engine (on graphs): the int8
    # engine reads its pools through kernel 8, which dequantizes in fp32,
    # generate(kv_int8=True) through bf16, so the two may part at a tie
    want, want_engine = {}, {}
    for tag, int8 in (("bf16", False), ("int8", True)):
        want[tag] = generate(model, ids, max_new_tokens=TENSOR_NEW,
                             int8_weights=int8, kv_int8=int8,
                             device="cuda").cpu().tolist()
        eng = ServingEngine(model, ServingConfig(
            max_seq_len=MAX_SEQ_LEN, int8_weights=int8, kv_int8=int8),
            device="cuda")
        reqs = [eng.submit(row, max_new_tokens=TENSOR_NEW) for row in ids]
        done = eng.run()
        want_engine[tag] = [np.asarray(done[r.request_id]).tolist()
                            for r in reqs]
        del eng
    _release()
    ranks, _, wall = _spawn_ranks(_rank_23c, (ids,))
    layers = FULL["num_hidden_layers"]
    for tag, kernel in (("bf16", "paged_attend"),
                        ("int8", "paged_attend_int8")):
        log(f"[tensor] 23c the 0.44B Llama at mp 2 ({tag}"
            + (", int8_weights + kv_int8" if tag == "int8" else "")
            + f"), two ranks sharing {card} over gloo (lm_head shard "
            f"{ranks[0]['shard']}), {TENSOR_NEW} greedy tokens for 2 "
            f"prompts of 8: one card generate {want[tag]}, engine "
            f"{want_engine[tag]} (equal {want[tag] == want_engine[tag]}); "
            + "; ".join(
                f"rank {r['rank']} generate equal one card's "
                f"{r[tag]['generate'] == want[tag]}, engine equal one "
                f"card's {r[tag]['engine'] == want_engine[tag]} "
                f"({r[tag]['engine']}), decode weights "
                f"{r[tag]['weight_bytes'] / 1e9:.4f} GB (the model's own "
                f"shards {r['model_bytes'] / 1e9:.4f} GB), pool "
                f"{r[tag]['pool_shape']} {r[tag]['pool_bytes'] / 1e9:.4f} "
                f"GB, peak {r[tag]['peak_gib']:.3f} GiB, engine phases "
                f"{r[tag]['phase_modes']} ({r[tag]['graph_replays']} graph "
                f"replays), {r[tag]['decode_steps']} decode and "
                f"{r[tag]['verify_steps']} verify rounds, launches: "
                f"generate {r[tag]['generate_launches'][kernel]}, with the "
                f"engine {r[tag]['launches']}, {r[tag]['seconds']:.1f} s"
                for r in ranks))
        for r in ranks:
            got = r[tag]
            held, ties = (got["engine"] == want_engine[tag], [])
            if tag == "int8" and not held:
                held, ties = _held_to_a_tie(model, ids, got["engine"],
                                            want_engine[tag])
                log(f"[tensor] 23c int8: rank {r['rank']}'s engine parts "
                    f"from one card's at (row, position) "
                    + ", ".join(f"({row}, {t}): one card's logits hold the "
                                f"two tokens {gap:.4e} apart, the row's "
                                f"largest |logit| {top:.4f} (a tie within "
                                f"{TIE_REL * top:.4e})"
                                for row, t, gap, top in ties))
            if got["generate"] != want[tag] or not held:
                raise AssertionError(f"23c {tag}: rank {r['rank']} at mp 2 "
                                     f"decoded other tokens than one card")
            exp = {kernel: layers * got["decode_steps"]}
            if any(got["launches"][n] != exp.get(n, 0)
                   for n in got["launches"]) or not got["decode_steps"]:
                raise AssertionError(f"23c {tag}: rank {r['rank']} launched "
                                     f"{got['launches']}, expected {exp}")
            if got["phase_modes"] != {ph: "eager" for ph in
                                      got["phase_modes"]} \
                    or got["graph_replays"]:
                raise AssertionError(f"23c {tag}: phases "
                                     f"{got['phase_modes']} on gloo")
            if got["pool_shape"][3] != FULL["num_attention_heads"] // 2:
                raise AssertionError(f"23c {tag}: pool {got['pool_shape']} "
                                     f"is not a rank's 6 kv heads")
    del model
    _release()
    log(f"[tensor] 23c spawn to join {wall:.1f} s")
    return {tag: ranks[0][tag]["launches"] for tag in ("bf16", "int8")}


class _BnNet(torch.nn.Module):
    """23d's net: a linear layer into ``BatchNorm1D``."""

    def __init__(self, dev):
        super().__init__()
        from paddle_tpu_torch import nn

        self.fc = Linear(8, 4, device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
        self.bn = nn.BatchNorm1D(4, device=dev)

    def forward(self, x):
        return self.bn(self.fc(x))


def _bn_batch1_steps(dev, state):
    from paddle_tpu_torch.optimizer import SGD

    net = _BnNet(dev)
    net.load_state_dict({k: v.to(dev) for k, v in state.items()})
    net.train()
    step = TrainStep(net, SGD(learning_rate=0.1,
                              parameters=net.parameters()),
                     lambda m, x, y: ((m(x) - y) ** 2).mean())
    rng = np.random.RandomState(4)
    losses = []
    for _ in range(4):
        x, y = (torch.from_numpy(rng.randn(1, n).astype(np.float32)).to(dev)
                for n in (8, 4))
        losses.append(float(step(x, y)))
    return losses, {k: v.detach().cpu() for k, v in net.state_dict().items()}


def _bn_batch1_graph(card):
    """23d (C.8): batch 1 in train mode inside a captured step."""
    state = _BnNet("cpu").state_dict()
    exec_cache.clear()
    got, got_state = _bn_batch1_steps("cuda", state)
    captures = exec_cache.stats()["captures"]
    want, want_state = _bn_batch1_steps("cpu", state)
    err = max(float((got_state[k] - want_state[k]).abs().max())
              for k in want_state)
    lerr = max(abs(a - b) for a, b in zip(got, want))
    log(f"[tensor] 23d BatchNorm1D at batch 1 in train mode, 4 SGD "
        f"TrainSteps on {card} ({captures} capture) vs the CPU: losses "
        f"{[round(v, 6) for v in got]}, max difference {lerr:.2e}; "
        f"parameters and running statistics max difference {err:.2e}; "
        f"running mean {got_state['bn._mean'].tolist()}, variance "
        f"{got_state['bn._variance'].tolist()}")
    if captures != 1 or lerr > 1e-6 or err > 1e-6:
        raise AssertionError("23d: the captured batch-1 step left the CPU's "
                             "(or was not captured)")


def phase_tensor_ops(card):
    """Phase 23: the tensor op surface on the card, decode at mp 2 and
    batch norm at one value per channel."""
    t_phase = time.perf_counter()
    _reset_launches()
    held, worst = _tensor_ops_on_card()
    log(f"[tensor] 23a {held} rows of the op tables on {card} against "
        f"the CPU (tol {TENSOR_REL_TOL} relative in fp32; ints, bools "
        f"and outputs drawn from the inputs exact; matmul bf16 and exp "
        f"fp32 under auto_cast bf16; no module of "
        f"{'/'.join(REFERENCE_MODULES)} imported): worst relative error "
        f"by module {worst}")
    t_a = time.perf_counter()
    sigmas = _tensor_random_on_card()
    log(f"[tensor] 23b {len(sigmas)} random ops on {card}: one seed one "
        f"draw, one count a call; mean off by (standard errors) "
        f"{sigmas}; {time.perf_counter() - t_a:.1f} s")
    _bn_batch1_graph(card)
    launched = _launch_counts()
    log(f"[tensor] launches of the eight kernels over 23a, 23b and 23d "
        f"(none lies on these paths): {launched}")
    if any(launched.values()):
        raise AssertionError("the tensor ops launched an attention kernel")
    decode = _decode_at_mp2(card)
    log(f"[tensor] phase {time.perf_counter() - t_phase:.1f} s")
    return {"held": held, "worst": worst, "launches_23c": decode}


# -- phase 24: the nn.functional surface --------------------------------------


def _functional_tables():
    """``tests/op_specs.py``'s specs and ``tests/torch_functional_cases.py``
    (free of JAX, as ``_tensor_tables`` says)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    sys.path.insert(0, tests)
    try:
        import op_specs
        import torch_functional_cases as cases
        import torch_tensor_cases as tcases
    finally:
        sys.path.remove(tests)
    return op_specs.SPECS, cases, tcases


# the op specs whose path runs cuDNN's convolutions: their sums in
# another order than the CPU's
CUDNN_SPECS = ("conv2d", "conv3d", "conv2d_transpose", "conv3d_transpose",
               "depthwise_conv2d", "depthwise_conv2d_transpose")


def _functional_rows(specs, cases, tcases):
    """(row id, numpy inputs, grad indices, card tol, call(F, *xs)) for
    every functional spec and every table row."""
    rows = []
    for sname in cases.functional_specs(specs):
        spec = specs[sname]
        tcases.port_adapted(spec)  # refuses an adapter that has no twin

        def call(F, *xs, spec=spec):
            fn = getattr(F, spec["path"].rsplit(".", 1)[1])
            if spec["adapter"] is not None:
                fn = spec["adapter"](fn)
            return fn(*xs, **spec["kwargs"])
        tol = 1e-4 if sname in CUDNN_SPECS else cases.CARD_TOL
        rows.append((f"spec {sname}", list(spec["inputs"]), spec["grad"],
                     tol, call))
    for row in cases.ROWS:
        rows.append((row.id, list(row.inputs), row.grad, row.card_tol,
                     row.call))
    return rows


def _functional_on_card():
    """24a: every functional row on the card against the CPU, forward and
    gradient; the worst error by the port module of the first function
    each row calls."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.framework.device import using_device

    specs, cases, tcases = _functional_tables()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, held = {}, 0
    for rid, inputs, grad, tol, call in _functional_rows(specs, cases,
                                                         tcases):
        rec = tcases.Recorder(F)
        with using_device("cpu"):
            want = call(rec, *[_on(a, "cpu") for a in inputs])
            want_g = cases.port_grads(lambda *xs: call(F, *xs), inputs,
                                      grad) if grad else []
        with using_device("gpu"):
            got = call(F, *[_on(a, "cuda") for a in inputs])
            got_g = cases.port_grads(lambda *xs: call(F, *xs), inputs, grad,
                                     "cuda") if grad else []
        err = _hold_on_card(rid, got, want, inputs, tol=tol, tag="24a")
        for g, w in zip(got_g, want_g):
            err = max(err, _grad_on_card(rid, g, w, tol))
        held += 1
        mod = next(getattr(f, "__module__", "").rsplit(".", 1)[-1]
                   for _, f in rec.seen)
        if err >= worst.get(mod, (-1.0, ""))[0]:
            worst[mod] = (err, rid)
    _no_reference("24a")
    return held, {m: (float(f"{e:.3g}"), r) for m, (e, r) in worst.items()}


def _on(a, dev):
    """A numpy input as the port's tensor on ``dev``."""
    import paddle_tpu_torch as ptt

    return ptt.to_tensor(np.array(a), place=dev)


def _grad_on_card(rid, got, want, tol):
    """A gradient from the card (numpy) against the CPU's: the same shape,
    within ``tol`` of the CPU's largest magnitude."""
    if got.shape != want.shape:
        raise AssertionError(f"24a {rid}: gradient {got.shape} on the card, "
                             f"{want.shape} on the CPU")
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max()) / scale
    if not err <= tol:
        raise AssertionError(f"24a {rid}: gradient relative error "
                             f"{err:.2e} above {tol}")
    return err


def _functional_random_on_card():
    """24b: each random function on the card: seed, draw count, mean."""
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.framework.device import using_device

    _, cases, _ = _functional_tables()
    out = {}
    with using_device("gpu"):
        for name in cases.RANDOM:
            fn, samples, mean, se = cases.draw(F, name, "cuda")
            ptt.seed(5)
            before = trandom.draws()
            a = fn()
            counted = trandom.draws() - before
            ptt.seed(5)
            b = fn()
            same = all(torch.equal(x, y) for x, y in zip(
                cases.flat(a), cases.flat(b)))
            on_card = all(x.is_cuda for x in cases.flat(a))
            dm = abs(float(samples(a).double().mean()) - mean)
            if not (on_card and counted == 1 and same
                    and dm < cases.SIGMAS * se):
                raise AssertionError(
                    f"24b {name}: on the card {on_card}, {counted} draws "
                    f"counted, repeatable {same}, mean off by {dm:.3g} "
                    f"({dm / se:.2f} se)")
            out[name] = round(dm / se, 2)
    return out


# (tag, b, s, h, d, causal, dropout, the wrappers that must launch once)
FLASH_ATTENTION_CASES = [
    ("llama", 8, 1024, 12, 128, True, 0.0, FLASH_WRAPPERS),
    ("bert", 64, 512, 12, 64, False, 0.1, HB_WRAPPERS),
]


def _flash_attention_call(case, gen):
    """24c: one ``F.flash_attention`` forward and backward at ``case``,
    held per 64-row tile against the plain versions on fp32 copies (the
    seed words the call drew replayed for them); the launches of the
    eight kernels over the call."""
    import paddle_tpu_torch.nn.functional as F

    tag, b, s, h, d, causal, dropout, wrappers = case
    q, k, v, do = _flash_inputs(b, s, s, h, h, gen, d=d)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    state = trandom.get_state()
    _reset_launches()
    out, soft = F.flash_attention(*leaves, dropout=dropout, causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    launched = _launch_counts()
    want = {w.__name__: 1 if w in wrappers else 0 for w in ALL_WRAPPERS}
    if launched != want or soft is not None:
        raise AssertionError(f"24c {tag}: launches {launched}, want {want}; "
                             f"softmax {soft!r}")
    kw = dict(causal=causal)
    refs = (fa.flash_fwd_ref, fa.flash_bwd_dq_ref, fa.flash_bwd_dkv_ref)
    if dropout:
        trandom.set_state(state)
        kw.update(seed=trandom.next_seed_words(), dropout=dropout)
        refs = (hf.hb_fwd_ref, hf.hb_bwd_dq_ref, hf.hb_bwd_dkv_ref)
    f32 = [t.float() for t in (q, k, v, do)]
    want_out, want_lse = refs[0](*f32[:3], **kw)
    delta = (do.float() * want_out.to(q.dtype).float()).sum(-1) \
        .permute(0, 2, 1).reshape(b * h, s).contiguous()
    want_dq = refs[1](*f32, want_lse, delta, **kw)
    want_dk, want_dv = refs[2](*f32, want_lse, delta, **kw)[:2]
    rel = {"out": _tile_rel_err(out.detach(), want_out),
           "dq": _tile_rel_err(leaves[0].grad, want_dq),
           "dk": _tile_rel_err(leaves[1].grad, want_dk),
           "dv": _tile_rel_err(leaves[2].grad, want_dv)}
    tol = FLASH_REL_TOL if not dropout else ENC_REL_TOL[torch.bfloat16]
    log(f"[functional] 24c F.flash_attention {tag} b={b} s={s} h={h} d={d} "
        f"bf16 causal={causal} dropout={dropout}: per-tile relative error "
        + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
        + f" (tol {tol}); launches {launched}")
    if not all(e <= tol for e in rel.values()):
        raise AssertionError(f"24c {tag}: {rel} above {tol}")
    return {k: v for k, v in launched.items() if v}


def _functional_readings():
    """24d: the card's ms for four functions at sizes users run them,
    fp32 (TF32 off), forward only: {name: [ms of each repetition]}."""
    import paddle_tpu_torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(24)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale
    x = rnd(64, 256, 28, 28)
    w = rnd(256, 128, 2, 2, scale=0.05)
    img = rnd(256, 64, 56, 56)
    grid = torch.rand(256, 112, 112, 2, device="cuda", generator=gen) * 2 - 1
    lp = torch.log_softmax(rnd(400, 32, 5000), -1)
    labels = torch.randint(1, 5000, (32, 100), device="cuda", generator=gen)
    in_len = torch.full((32,), 400, device="cuda")
    lab_len = torch.full((32,), 100, device="cuda")
    calls = {
        "conv2d_transpose [64, 256, 28, 28] -> [64, 128, 56, 56] (k 2, "
        "stride 2)": lambda: F.conv2d_transpose(x, w, stride=2),
        "interpolate bilinear [256, 64, 56, 56] -> 112 x 112":
            lambda: F.interpolate(img, size=[112, 112], mode="bilinear"),
        "grid_sample [256, 64, 56, 56] at a [256, 112, 112, 2] grid":
            lambda: F.grid_sample(img, grid),
        "ctc_loss T 400, B 32, C 5000, L 100":
            lambda: F.ctc_loss(lp, labels, in_len, lab_len),
    }
    return _time_reps({n: lambda i, fn=fn: fn() for n, fn in calls.items()},
                      iters=1)


def phase_functional(card, smi):
    """Phase 24: the nn.functional surface on the card."""
    t_phase = time.perf_counter()
    held, worst = _functional_on_card()
    log(f"[functional] 24a {held} rows (specs and table rows) on {card} "
        f"against the CPU, forward and gradient (tol "
        f"{_functional_tables()[1].CARD_TOL} relative in fp32, 1e-4 for "
        f"cuDNN's convolutions and the CTC and RNN-T recurrences; ints, "
        f"bools and moved values exact; TF32 off; no module of "
        f"{'/'.join(REFERENCE_MODULES)} imported): worst relative error "
        f"by module {worst}; {time.perf_counter() - t_phase:.1f} s")
    t_b = time.perf_counter()
    sigmas = _functional_random_on_card()
    log(f"[functional] 24b {len(sigmas)} random functions on {card}: one "
        f"seed one draw, one count a call; mean off by (standard errors) "
        f"{sigmas}; {time.perf_counter() - t_b:.1f} s")
    gen = torch.Generator("cuda").manual_seed(7)
    launches = {}
    for case in FLASH_ATTENTION_CASES:
        launches[case[0]] = _flash_attention_call(case, gen)
    _release()
    readings = _functional_readings()
    log(f"[functional] 24d readings on {smi} (fp32, TF32 off, forward, "
        f"ms of one call, median (min-max) of {REPS} interleaved "
        f"repetitions): "
        + "; ".join(f"{n} {_spread(ts)}" for n, ts in readings.items()))
    _no_reference("24")
    log(f"[functional] phase {time.perf_counter() - t_phase:.1f} s")
    return {"held": held, "worst": worst, "launches": launches,
            "readings": readings}


# -- phase 25: the nn layer surface ---------------------------------------------

# Transformer-base (Vaswani et al. 2017 "base": nn.Transformer's own
# defaults, transformer.py:258-262) with 32000-token source and target
# embeddings, a Linear head and CE with label smoothing 0.1
T_BASE = dict(d_model=512, nhead=8, num_encoder_layers=6,
              num_decoder_layers=6, dim_feedforward=2048, dropout=0.1)
T_VOCAB, T_BATCH, T_SRC, T_TGT, T_BOS = 32000, 64, 256, 256, 1
T_DECODE_STEPS = 32
# cached decode against the full causal forward on the decoded prefix, in
# bf16: each logit within this share of the largest
DECODE_REL_TOL = 5e-2
# the tile mode's kernels: kernels 1-3 in the tile mode, and the class
# pass that the forward on wgmma runs once for itself, dQ and dK/dV
TILE_NAMES = ("flash_fwd_tile", "flash_bwd_dq_tile", "flash_bwd_dkv_tile",
              "flash_tile_classes")


def _tile_launches():
    counts = {n: w.tile_launches for n, w in zip(TILE_NAMES, FLASH_WRAPPERS)}
    counts["flash_tile_classes"] = fa.tile_classes.launches
    return counts


def _reset_tile_launches():
    for w in FLASH_WRAPPERS:
        w.tile_launches = 0
    fa.tile_classes.launches = 0


def _seq2seq(vocab, device, generator=None, **kw):
    """An encoder-decoder ``nn.Transformer`` with source and target
    embeddings, a Linear head and CE with label smoothing 0.1, built from
    the port's ``nn`` layers. ``model(src, src_keep, tgt_in, tgt_out)`` is
    the loss: the source's key-padding mask (``[b, 1, 1, s]``, bool keep)
    for the encoder and the cross attention, the decoder's causal mask
    from ``generate_square_subsequent_mask``."""
    from paddle_tpu_torch import nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            at = dict(device=device, generator=generator)
            d = kw["d_model"]
            self.src_emb = nn.Embedding(vocab, d, **at)
            self.tgt_emb = nn.Embedding(vocab, d, **at)
            self.transformer = nn.Transformer(**kw, **at)
            self.head = nn.Linear(d, vocab, **at)
            self.loss = nn.CrossEntropyLoss(label_smoothing=0.1)

        def logits(self, src, src_keep, tgt_in):
            t = self.transformer
            keep = src_keep[:, None, None, :]
            h = t(self.src_emb(src), self.tgt_emb(tgt_in), keep,
                  t.generate_square_subsequent_mask(tgt_in.shape[1]), keep)
            return self.head(h)

        def forward(self, src, src_keep, tgt_in, tgt_out):
            logits = self.logits(src, src_keep, tgt_in)
            return self.loss(logits.reshape(-1, logits.shape[-1]),
                             tgt_out.reshape(-1))

    return Seq2Seq()


def _copy_batch(vocab, b, s, t, device, seed=0, lo=None):
    """A copy task: sources of seeded lengths in ``[lo, s]`` (padding 0,
    masked), targets their first ``t`` tokens after a BOS."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(lo or s // 2, s + 1, b)
    keep = np.arange(s)[None] < lengths[:, None]
    src = np.where(keep, rng.randint(2, vocab, (b, s)), 0)
    tgt = src[:, :t]
    tgt_in = np.concatenate([np.full((b, 1), T_BOS), tgt[:, :-1]], 1)
    return tuple(torch.from_numpy(a).to(device) for a in (
        src.astype(np.int64), keep, tgt_in.astype(np.int64),
        tgt.astype(np.int64)))


def _tiny_seq2seq_losses(device, weights, steps=3):
    """A tiny fp32 copy (d 32, 4 heads, 1 + 1 layers, vocab 50) from
    ``weights``: 3 AdamW steps with attention dropout 0.1 from seed words
    drawn alike on both devices (residual dropout 0: the CPU's and the
    card's generators differ); returns the losses."""
    trandom.seed(0)
    model = _seq2seq(50, device, d_model=32, nhead=4, num_encoder_layers=1,
                     num_decoder_layers=1, dim_feedforward=64, dropout=0.0,
                     attn_dropout=0.1)
    load_layer_weights(model, weights)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    losses = []
    for i in range(steps):
        batch = _copy_batch(50, 2, 12, 10, device, seed=300 + i, lo=5)
        loss = model(*batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses


def _transformer_25a(card):
    """25a: Transformer-base training steps under O2 bf16 and AdamW, the
    launches of the tile mode and of kernels 4-6, the tiny copy's
    identity."""
    trandom.seed(0)
    gen = torch.Generator("cuda").manual_seed(25)
    model = amp.decorate(_seq2seq(T_VOCAB, "cuda", gen, **T_BASE),
                         level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    n_params = sum(p.numel() for p in model.parameters())
    batch = _copy_batch(T_VOCAB, T_BATCH, T_SRC, T_TGT, "cuda", lo=128)
    src_tokens = int(batch[1].sum())

    def step():
        loss = model(*batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    losses = [float(step()) for _ in range(WARMUP_STEPS)]
    _reset_launches()
    _reset_tile_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    losses += [float(x) for x in timed]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tile, launched = _tile_launches(), _launch_counts()
    dec, enc = T_BASE["num_decoder_layers"], T_BASE["num_encoder_layers"]
    want_tile = {n: dec * TIMED_STEPS for n in TILE_NAMES}
    want_hb = {w.__name__: (enc + dec) * TIMED_STEPS for w in HB_WRAPPERS}
    tok_s = (src_tokens + T_BATCH * T_TGT) / (ms / 1e3)
    log(f"[nn] 25a Transformer-base ({n_params / 1e6:.1f} M parameters: "
        f"d 512, 8 heads, ffn 2048, 6 + 6 layers, dropout 0.1, vocab "
        f"{T_VOCAB}) O2 bf16 AdamW, eager (dropout draws), b{T_BATCH} x "
        f"src {T_SRC} (padded to lengths 128-256, {src_tokens} live) x tgt "
        f"{T_TGT} on {card}: {ms:.2f} ms a step, {tok_s:.0f} tokens/s "
        f"(source and target), peak {peak:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; launches over {TIMED_STEPS} "
        f"steps: tile mode {tile}, {launched}")
    if not (all(np.isfinite(losses))
            and abs(losses[0] - np.log(T_VOCAB)) <= 1.0):
        raise AssertionError(f"25a: losses {losses} must be finite and "
                             f"start within 1.0 of ln({T_VOCAB})")
    if tile != want_tile or any(launched[k] != v for k, v in want_hb.items())\
            or any(w.launches for w in FLASH_WRAPPERS):
        raise AssertionError(f"25a: launches tile {tile} (want {want_tile}),"
                             f" {launched} (want {want_hb}, kernels 1-3 "
                             f"none)")
    # the tiny fp32 copy on the card and on the CPU
    seed_model = _seq2seq(50, "cpu", torch.Generator("cpu").manual_seed(0),
                          d_model=32, nhead=4, num_encoder_layers=1,
                          num_decoder_layers=1, dim_feedforward=64,
                          dropout=0.0, attn_dropout=0.1)
    weights = {n: t.detach().numpy()
               for n, t in seed_model.state_dict().items()}
    _reset_tile_launches()
    got = _tiny_seq2seq_losses("cuda", weights)
    tiny_tile = _tile_launches()
    want = _tiny_seq2seq_losses("cpu", weights)
    diff = max(abs(a - b) for a, b in zip(got, want))
    log(f"[nn] 25a tiny fp32 copy (d 32, 4 heads, 1 + 1 layers, attention "
        f"dropout 0.1), 3 AdamW steps: losses card "
        f"{[round(x, 6) for x in got]} vs CPU {[round(x, 6) for x in want]}"
        f": max diff {diff:.3e} (tol {IDENTITY_LOSS_ATOL}); tile launches "
        f"on the card {tiny_tile}")
    # fp32 runs the FMA kernels, which read no class table
    if not diff <= IDENTITY_LOSS_ATOL or min(
            v for n, v in tiny_tile.items() if n != "flash_tile_classes") <= 0:
        raise AssertionError("25a: the tiny copy's card run left the CPU's")
    return ms, tok_s, peak, tile, model, batch


def _decode_25a(model, batch):
    """25a: greedy cached decode through ``gen_cache`` for
    ``T_DECODE_STEPS`` steps, held against the full causal forward over
    the decoded prefix; kernel 1 (self-attention, one query row) and
    kernel 4 (cross attention, the key-padding mask) launch once a layer
    a step."""
    t = model.transformer
    src, keep = batch[0], batch[1]
    mask = keep[:, None, None, :]
    model.eval()
    _reset_launches()
    _reset_tile_launches()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        memory = t.encoder(model.src_emb(src), mask)
        cache = t.decoder.gen_cache(memory)
        tok = torch.full((src.shape[0],), T_BOS, device=src.device)
        toks, logits = [], []
        for _ in range(T_DECODE_STEPS):
            out, cache = t.decoder(model.tgt_emb(tok)[:, None], memory, None,
                                   mask, cache)
            lg = model.head(out[:, -1])
            tok = lg.argmax(-1)
            toks.append(tok)
            logits.append(lg.float())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = _launch_counts()
        toks, logits = torch.stack(toks, 1), torch.stack(logits, 1)
        tgt_in = torch.cat([torch.full_like(toks[:, :1], T_BOS),
                            toks[:, :-1]], 1)
        full = model.logits(src, keep, tgt_in).float()
    err = ((full - logits).abs().max() / full.abs().max()).item()
    same = (full.argmax(-1) == toks).float().mean().item()
    layers = T_BASE["num_decoder_layers"]
    want = {"flash_fwd": layers * T_DECODE_STEPS,
            "hb_fwd": layers * T_DECODE_STEPS + T_BASE["num_encoder_layers"]}
    log(f"[nn] 25a greedy cached decode, {T_DECODE_STEPS} steps at "
        f"b{src.shape[0]} (encoder included): {ms:.1f} ms, "
        f"{ms / T_DECODE_STEPS:.2f} ms a step; logits against the full "
        f"causal forward over the decoded prefix: {err:.3e} of the largest "
        f"(tol {DECODE_REL_TOL}), argmax agreeing at {same:.4f} of the "
        f"positions; launches {launched}, tile mode {_tile_launches()}")
    if not (torch.isfinite(logits).all() and err <= DECODE_REL_TOL
            and all(launched[k] == v for k, v in want.items())):
        raise AssertionError(f"25a decode: error {err}, launches {launched} "
                             f"(want {want})")
    return ms / T_DECODE_STEPS


def _tile_bound(q, k, tile, stage):
    """Least time for one tile-mode call at these inputs: the larger of
    its bytes over the HBM rate (q, k, v, dO read once; O, dQ, dK, dV
    written once; lse and delta; the mask's own elements once, however it
    broadcasts) and its operations over the bf16 peak, counting only the
    (row, key) pairs whose mask value is live (above PAD_LEVEL; a row with
    none needs all its keys): 2 * d per product per pair, 2 products
    forward, 3 for dQ, 4 for dK/dV. dQ computing delta also reads O;
    the class pass reads the mask and writes a byte a cell."""
    b, sq, h, d = q.shape
    live = tile.expand(b, h, sq, -1) > PAD_LEVEL
    need = live | ~live.any(-1, keepdim=True)
    pairs = int(need.sum())
    products = {"fwd": 2, "bwd_dq": 3, "bwd_dkv": 4, "classes": 0}[stage]
    q_bytes = q.numel() * q.element_size()
    kv_bytes = 2 * k.numel() * k.element_size()
    rows = b * h * sq * 4
    mask_bytes = tile.numel() * 4
    cells = -(-sq // fa.CELL) * -(-k.shape[1] // fa.CELL)
    nbytes = {"fwd": 2 * q_bytes + kv_bytes + rows,
              "bwd_dq": 4 * q_bytes + kv_bytes + 2 * rows,
              "bwd_dkv": 2 * q_bytes + 2 * kv_bytes + 2 * rows,
              "classes": cells * tile.shape[0] * tile.shape[1]}[stage] \
        + mask_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * 2 * d * products / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _causal_padded(b, s, gen):
    """The second mask of 25b: the causal triangle with a key padding per
    batch row (lengths s / 4 to s, seeded), ``[b, 1, s, s]``."""
    lens = torch.randint(s // 4, s + 1, (b,), device="cuda", generator=gen)
    keys = torch.arange(s, device="cuda")
    hide = (keys[None, None, :] > keys[None, :, None]) \
        | (keys[None, None, :] >= lens[:, None, None])
    return torch.where(hide, fa.NEG_INF, 0.0)[:, None].float()


def _tile_check(q, k, v, do, tile, kw):
    """The tile mode's kernels on ``tile`` against their plain versions
    (fp32 copies): the forward, dQ given delta and computing it itself,
    dK/dV with the per-element dmask, the class table and its full-row
    flags; returns (per-tile relative errors, max_abs_err by row, dmask
    error per (batch, head), lse error, the class table and flags,
    whether a row is fully masked)."""
    b, s, h, _ = q.shape
    f32 = [t.float() for t in (q, k, v, do)]
    out, lse = fa.flash_fwd(q, k, v, tmask=tile, **kw)
    want_out, want_lse = fa.flash_fwd_ref(*f32[:3], tmask=tile, **kw)
    out_b = want_out.to(q.dtype)
    delta = fa._delta(do, out_b)
    dq = fa.flash_bwd_dq(q, k, v, do, want_lse, delta, tmask=tile, **kw)
    dq_f, delta_f = fa.flash_bwd_dq_delta(q, k, v, do, out_b, want_lse,
                                          tmask=tile, **kw)
    dk, dv, dm = fa.flash_bwd_dkv(q, k, v, do, want_lse, delta, tmask=tile,
                                  tmask_grad=True, **kw)
    table = fa.tile_classes(tile, s, s, kw["causal"], full_rows=True)
    torch.cuda.synchronize()
    want_dq = fa.flash_bwd_dq_ref(*f32, want_lse, delta, tmask=tile, **kw)
    want_dk, want_dv, want_dm = fa.flash_bwd_dkv_ref(
        *f32, want_lse, delta, tmask=tile, tmask_grad=True, **kw)
    want_table = fa.tile_classes_ref(tile, s, s, kw["causal"],
                                     full_rows=True)
    pairs = {"flash_fwd_tile": [(out, want_out)],
             "flash_bwd_dq_tile": [(dq_f, want_dq), (dq, want_dq)],
             "flash_bwd_dkv_tile": [(dk, want_dk), (dv, want_dv)]}
    rel = {n: max(_tile_rel_err(g, w) for g, w in p)
           for n, p in pairs.items()}
    abs_err = {n: max((g.float() - w).abs().max().item() for g, w in p)
               for n, p in pairs.items()}
    abs_err["flash_tile_classes"] = max(
        (got.int() - want.int()).abs().max().item()
        for got, want in zip(table, want_table))
    rel["delta"] = _row_rel_err(delta_f[:, None], delta[:, None])
    # dmask by (batch, head) slice: a query row that sees one key (row 0
    # of the causal mask) has ds = dp - delta = 0 up to rounding
    dm_err = _row_rel_err(dm.reshape(b * h, 1, -1),
                          want_dm.reshape(b * h, 1, -1))
    lse_err = _lse_err(lse, want_lse)
    full = bool((want_lse <= 0.5 * fa.NEG_INF).any())
    return rel, abs_err, dm_err, lse_err, table, full


def _lse_err(got, want):
    """The largest lse error: absolute over the rows that see a live key,
    relative (to 1e30) over the others, whose lse is -1e30 plus at most
    log(sk) (rows that see no key, fully masked rows), and inf if the two
    disagree on which rows those are."""
    live = want > 0.5 * fa.NEG_INF
    if not torch.equal(live, got > 0.5 * fa.NEG_INF):
        return float("inf")
    err = (got - want).abs()
    return max(err[live].max().item() if live.any() else 0.0,
               (err[~live] / 1e30).max().item() if (~live).any() else 0.0)


def _cell_counts(classes, b, h):
    """(DEAD, ZERO, MIXED) cells over every (batch, head), and the share
    of (row, key) pairs in the cells the backward visits (every cell but
    the DEAD ones when no row is fully masked and no causal flag is
    set: 25b's masks)."""
    c = classes.expand(b, h, -1, -1)
    n = [int((c == k).sum()) for k in (fa.TILE_DEAD, fa.TILE_ZERO,
                                       fa.TILE_MIXED)]
    return n, 1.0 - n[0] / c.numel()


def _fwd_shares(table, b, h, sq, sk, causal):
    """The tile forward's skip rule on the class table and its full-row
    flags (``flash_fwd_tile_wgmma``: a 64-row cell row visits every key
    tile when flagged, else its cells that are not DEAD up to its causal
    band): the share of (row, key) pairs it visits, of key tiles it loads
    (a 128-row item loads a tile either cell row visits), and of visited
    cells whose mask it stages (MIXED, or DEAD beside a flag)."""
    c = table[0].expand(b, h, -1, -1).cpu()
    f = table[1].expand(b, h, -1).cpu().bool()[..., None]
    nrt, nct = c.shape[2:]
    rt, kt = torch.arange(nrt), torch.arange(nct)
    last = torch.clamp(64 * rt + 63, max=sq - 1) + sk - sq if causal \
        else torch.full((nrt,), sk - 1)
    visit = f | ((c != fa.TILE_DEAD) & (64 * kt[None] <= last[:, None]))
    rows = torch.clamp(sq - 64 * rt, max=64)
    cols = torch.clamp(sk - 64 * kt, max=64)
    pairs = (visit * rows[:, None] * cols[None]).sum().item() / (
        b * h * sq * sk)
    items = torch.nn.functional.pad(visit, (0, 0, 0, nrt % 2))
    loaded = items.reshape(b, h, -1, 2, nct).any(3)
    staged = visit & ((c == fa.TILE_MIXED) | ((c == fa.TILE_DEAD) & f))
    return (pairs, loaded.float().mean().item(),
            staged.sum().item() / max(visit.sum().item(), 1))


def _fully_masked_25b(q, k, v, tile, kw):
    """25b's rows that the forward visits whole or outputs 0 for: the
    causal mask with query rows 5 and 200 set to -1e30 (fully masked:
    their cell rows are flagged and averaged over every key), and the
    causal flag over the first 192 keys (rows 0-63 see no key: 0, lse
    -1e30); O per tile within FLASH_REL_TOL of the plain version's and
    lse (_lse_err) within LSE_ATOL. Returns the largest errors."""
    full = tile.clone()
    full[..., 5, :] = fa.NEG_INF
    full[..., 200, :] = fa.NEG_INF
    f32 = [t.float() for t in (q, k, v)]
    rel, lse_err = 0.0, 0.0
    for mask, sk, causal in ((full, k.shape[1], False),
                             (tile[..., :192], 192, True)):
        args = dict(kw, causal=causal, tmask=mask)
        out, lse = fa.flash_fwd(q, k[:, :sk], v[:, :sk], **args)
        want_out, want_lse = fa.flash_fwd_ref(f32[0], f32[1][:, :sk],
                                              f32[2][:, :sk], **args)
        flags = fa.tile_classes(mask, q.shape[1], sk, causal,
                                full_rows=True)[1][0, 0].tolist()
        if flags != ([0] * 4 if causal else [1, 0, 0, 1]):
            raise AssertionError(f"25b: full-row flags {flags}")
        rel = max(rel, _tile_rel_err(out, want_out))
        lse_err = max(lse_err, _lse_err(lse, want_lse))
    if not (rel <= FLASH_REL_TOL and lse_err <= LSE_ATOL):
        raise AssertionError(f"25b: fully masked rows or rows that see no "
                             f"key disagree: O {rel}, lse {lse_err}")
    return rel, lse_err


def _tile_kernels_25b(smi):
    """25b: the tile mode at the decoder's shape (b 64, s 256, h 8, d 64,
    bf16, dropout 0.1, the causal mask of
    ``generate_square_subsequent_mask``, and the causal mask with a key
    padding per batch row) against its plain version, the class counts,
    the shares the forward and the backward visit, fully masked rows and
    rows that see no key; then timed on the causal mask as the main path
    runs it (the forward's class pass once, its table handed to the
    forward, dQ computing delta and dK/dV), beside its plain version,
    SDPA given the same additive mask and the bound, and the whole
    attention (forward with its class pass, then the backward) beside
    SDPA's forward and backward."""
    gen = torch.Generator("cuda").manual_seed(26)
    b, s, h, d, rate = T_BATCH, T_TGT, T_BASE["nhead"], 64, 0.1
    q, k, v, do = _flash_inputs(b, s, s, h, h, gen, d=d)
    tile = torch.triu(torch.full((s, s), fa.NEG_INF, device="cuda"),
                      1)[None, None]
    seed = (2025, -18)
    kw = dict(causal=False, seed=seed, dropout=rate)
    abs_err = {}
    for name, mask in (("causal", tile),
                       ("causal + key padding", _causal_padded(b, s, gen))):
        rel, errs, dm_err, lse_err, table, full = _tile_check(
            q, k, v, do, mask, kw)
        counts, share = _cell_counts(table[0], b, h)
        pairs, tiles, staged = _fwd_shares(table, b, h, s, s, False)
        log(f"[nn] 25b tile mode b={b} s={s} h={h} d={d} bf16 dropout "
            f"{rate}, the {name} mask {list(mask.shape)}: per-tile "
            f"relative error "
            + ", ".join(f"{n} {e:.3e}" for n, e in rel.items()
                        if n != "delta")
            + f" (tol {FLASH_REL_TOL}; dQ given delta and computing it); "
            f"fused delta {rel['delta']:.3e} per row (tol 1e-5); dmask per "
            f"(batch, head) {dm_err:.3e} (tol 1e-3); lse {lse_err:.3e} (tol "
            f"{LSE_ATOL}); class table and flags {'equal' if errs['flash_tile_classes'] == 0 else 'DIFFER'}: "
            f"cells DEAD {counts[0]}, ZERO {counts[1]}, MIXED {counts[2]}, "
            f"cell rows flagged {int(table[1].sum())}; pairs visited by dQ "
            f"and dK/dV {share:.4f}"
            f"{' (a row is fully masked: more are visited)' if full else ''}"
            f"; the forward visits {pairs:.4f} of the pairs, loads "
            f"{tiles:.4f} of the key tiles and stages the mask of "
            f"{staged:.4f} of the cells it visits")
        if not (all(e <= FLASH_REL_TOL for n, e in rel.items()
                    if n != "delta") and rel["delta"] <= 1e-5
                and dm_err <= 1e-3 and lse_err <= LSE_ATOL
                and errs["flash_tile_classes"] == 0):
            raise AssertionError(f"25b: the tile mode disagrees with its "
                                 f"plain version on the {name} mask: {rel},"
                                 f" dmask {dm_err}, lse {lse_err}, classes "
                                 f"{errs['flash_tile_classes']}")
        abs_err = {n: max(e, abs_err.get(n, 0.0)) for n, e in errs.items()}
    rel, lse_err = _fully_masked_25b(q, k, v, tile, kw)
    log(f"[nn] 25b the tile forward on rows it visits whole or outputs 0 "
        f"for (the causal mask with rows 5 and 200 at -1e30, their cell "
        f"rows flagged; the causal flag over 192 keys, rows 0-63 seeing "
        f"none): per-tile relative error {rel:.3e} (tol {FLASH_REL_TOL}), "
        f"lse {lse_err:.3e} (tol {LSE_ATOL}; relative to 1e30 on those "
        f"rows)")
    _release()
    # timed as the main path runs them: the forward's class pass once, its
    # table read by the forward, dQ and dK/dV; no mask gradient
    kw = dict(kw, tmask=tile)
    table = fa.tile_classes(tile, s, s, False, full_rows=True)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa._delta(do, out)
    kernels = {
        "flash_fwd_tile": (lambda: fa._flash_fwd(q, k, v, table, **kw),
                           lambda: fa.flash_fwd_ref(q, k, v, **kw)),
        "flash_bwd_dq_tile": (
            lambda: fa._dq_delta(q, k, v, do, out, lse, table, **kw),
            lambda: fa.flash_bwd_dq_delta_ref(q, k, v, do, out, lse, **kw)),
        "flash_bwd_dkv_tile": (
            lambda: fa._dkv(q, k, v, do, lse, delta, table, **kw),
            lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)),
        "flash_tile_classes": (
            lambda: fa.tile_classes(tile, s, s, False, full_rows=True),
            lambda: fa.tile_classes_ref(tile, s, s, False, full_rows=True)),
    }
    # the whole backward as _FlashFn runs it given the forward's table
    # (the fused dQ, dK/dV), and the whole attention as a training step
    # runs it: the forward with its class pass, then the backward
    args = dict(kw, kmask=None, coords=None, scale=None, window=0)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, out, lse), args=args,
                                needs_input_grad=(True,) * 3 + (False,) * 8,
                                table=table)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    library, contexts, fallbacks, minus = _sdpa_fns(
        q, k, v, do, attn_mask=tile[0, 0].to(q.dtype), dropout_p=rate)
    port = {n: lambda i, f=kern: f() for n, (kern, _) in kernels.items()}
    port["flash_bwd_tile"] = lambda i: fa._FlashFn.backward(ctx, do)
    port["flash_attention_tile"] = lambda i: torch.autograd.grad(
        fa.flash_attention(*leaves, **kw), leaves, do)
    times, how, eager = _timed(port, library, contexts, fallbacks, minus)
    lib = {"flash_fwd_tile": _library(times, "sdpa_fwd", how)}
    lib["flash_bwd_dq_tile"] = lib["flash_bwd_dkv_tile"] = _library(
        times, "sdpa_bwd", how)
    lib["flash_tile_classes"] = (None, "no PyTorch call computes it")
    rows = {}
    for name, (_, plain) in kernels.items():
        ms = _med(times[name])
        plain_ms = _time_plain(plain, iters=2)
        bound_ms, bound_by = _tile_bound(
            q, k, tile, "classes" if name == "flash_tile_classes"
            else name[len("flash_"):-len("_tile")])
        lib_ms, lib_txt = lib[name]
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=abs_err[name])
        log(f"[nn] 25b {name} b{b} s{s} h{h} d{d} bf16 dropout {rate} on "
            f"{smi}: kernel_ms {_spread(times[name])} (CUDA graphs of "
            f"{ITERS} calls; median, min-max of {REPS}; given the class "
            f"table) plain_ms {plain_ms:.4f} library_ms {_ms(lib_ms)} "
            f"({lib_txt}) bound_ms {bound_ms:.5f} ({bound_by}); eager "
            f"calls {_spread(eager[name])} ms")
    lib_fwd = lib["flash_fwd_tile"][0]
    lib_bwd = lib["flash_bwd_dq_tile"][0]
    whole = _med(times["flash_bwd_tile"])
    log(f"[nn] 25b the whole tile backward given the forward's table (dQ "
        f"computing delta, dK/dV; _FlashFn.backward) on {smi}: "
        f"{_spread(times['flash_bwd_tile'])} ms, "
        f"{whole / lib_bwd if lib_bwd else float('nan'):.2f}x SDPA's whole "
        f"backward ({_ms(lib_bwd)} ms); eager "
        f"{_spread(eager['flash_bwd_tile'])} ms")
    both = _med(times["flash_attention_tile"])
    lib_both = lib_fwd + lib_bwd if lib_fwd and lib_bwd else None
    log(f"[nn] 25b the whole tile attention (flash_attention(tmask=): the "
        f"class pass, the forward, dQ computing delta, dK/dV; autograd) on "
        f"{smi}: {_spread(times['flash_attention_tile'])} ms, "
        f"{both / lib_both if lib_both else float('nan'):.2f}x SDPA's "
        f"forward + backward ({_ms(lib_both)} ms); eager "
        f"{_spread(eager['flash_attention_tile'])} ms")
    return rows


def _lstm_25c(smi):
    """25c: ``nn.LSTM(512, 1024, num_layers=2, direction="bidirect")``
    (torch's fused op: cuDNN) forward and backward on [64, 256, 512] fp32
    (TF32 off), timed; and a small one on the card against the CPU."""
    from paddle_tpu_torch import nn

    gen = torch.Generator("cuda").manual_seed(27)
    lstm = nn.LSTM(512, 1024, num_layers=2, direction="bidirect",
                   device="cuda", generator=gen)
    x = torch.randn(64, 256, 512, device="cuda", generator=gen,
                    requires_grad=True)
    g = torch.randn(64, 256, 2048, device="cuda", generator=gen)

    def fwd_bwd(i):
        out, _ = lstm(x)
        torch.autograd.backward(out, g)
    ts = _time_reps({"lstm": fwd_bwd}, iters=2, reps=3)["lstm"]
    small_cpu = nn.LSTM(16, 32, num_layers=2, direction="bidirect",
                        device="cpu",
                        generator=torch.Generator("cpu").manual_seed(0))
    small_gpu = nn.LSTM(16, 32, num_layers=2, direction="bidirect",
                        device="cuda")
    load_layer_weights(small_gpu, {n: t.detach().numpy()
                                   for n, t in small_cpu.state_dict().items()})
    xs = np.random.RandomState(28).randn(4, 10, 16).astype(np.float32)
    res = []
    for m, dev in ((small_cpu, "cpu"), (small_gpu, "cuda")):
        xt = torch.from_numpy(xs).to(dev).requires_grad_()
        out, (h, c) = m(xt)
        (out.sum() + h.sum() + c.sum()).backward()
        res.append([t.detach().cpu() for t in (out, h, c, xt.grad)]
                   + [p.grad.cpu() for p in m.parameters()])
    err = max(((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()
              for a, b in zip(res[1], res[0]))
    log(f"[nn] 25c nn.LSTM(512, 1024, 2 layers, bidirect) fp32 (TF32 off) "
        f"on [64, 256, 512] on {smi}: forward + backward {_spread(ts)} ms "
        f"(torch's fused op, cuDNN); LSTM(16, 32, 2, bidirect) card vs CPU: "
        f"outputs, states and every gradient within {err:.3e} of their "
        f"largest (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"25c: the card's LSTM left the CPU's ({err})")
    return _med(ts)


def _layer_tables():
    """``tests/torch_layer_cases.py`` (free of JAX, as ``_tensor_tables``
    says)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    sys.path.insert(0, tests)
    try:
        import torch_layer_cases as cases
    finally:
        sys.path.remove(tests)
    return cases


def _layer_sweep_25d():
    """25d: every case of the layer sweep on the card against the port's
    CPU result from the same weights (``torch_layer_cases.card_error``),
    each within its ``card_tol``, TF32 off."""
    cases = _layer_tables()
    worst = (0.0, "")
    for case in cases.CASES:
        err = cases.card_error(case)
        if not err <= case.card_tol:
            raise AssertionError(f"25d {case.id}: relative error {err:.3e} "
                                 f"above {case.card_tol}")
        worst = max(worst, (err, case.id))
    _no_reference("25d")
    return len(cases.CASES), worst


def phase_nn(card, smi):
    """Phase 25: the nn layer surface on the card."""
    t_phase = time.perf_counter()
    ms, tok_s, peak, tile_launches, model, batch = _transformer_25a(card)
    decode_ms = _decode_25a(model, batch)
    del model, batch
    _release()
    rows = _tile_kernels_25b(smi)
    _release()
    lstm_ms = _lstm_25c(smi)
    _release()
    t_d = time.perf_counter()
    n, worst = _layer_sweep_25d()
    log(f"[nn] 25d {n} layer cases on {card} against the CPU (outputs, "
        f"gradients, state after the call; TF32 off): worst relative error "
        f"{worst[0]:.3e} ({worst[1]}); {time.perf_counter() - t_d:.1f} s")
    log(f"[nn] phase {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "launches": tile_launches, "ms": ms,
            "tok_s": tok_s, "peak": peak, "decode_ms": decode_ms,
            "lstm_ms": lstm_ms}


# -- phase 26: the top-level namespace -----------------------------------------

# a fresh interpreter on the card: ``import paddle_tpu_torch as paddle``,
# every name of its lazy tables, the names still to port, and C.14's
# reproduction (a numpy-default dataset into a float32 Linear)
_NAMESPACE_PROBE = r"""
import json, sys
import numpy as np
import paddle_tpu_torch as paddle
ok, unported, bad = [], {}, {}
for name in list(paddle._LAZY) + list(paddle._LAZY_ATTRS):
    try:
        getattr(paddle, name)
        ok.append(name)
    except Exception as e:
        bad[name] = repr(e)
for name, item in paddle._UNPORTED.items():
    try:
        getattr(paddle, name)
        bad[name] = "resolved"
    except AttributeError as e:
        if "ROADMAP " + item in str(e):
            unported[name] = item
        else:
            bad[name] = str(e)


class DS(paddle.io.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.random.RandomState(i).rand(4), np.int64(i % 3)


x, y = next(iter(paddle.io.DataLoader(DS(), batch_size=4)))
paddle.seed(0)
net = paddle.nn.Linear(4, 3)
loss = paddle.nn.functional.cross_entropy(net(x.cuda()), y.cuda())
print(json.dumps({
    "ok": ok, "unported": unported, "bad": bad,
    "batch": [str(x.dtype), str(y.dtype)], "weight": str(net.weight.device),
    "loss": float(loss), "dtype": str(paddle.float32),
    "reference": sorted(n for n in sys.modules
                        if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))}))
"""


def _namespace_26a(card):
    """26a: the fresh interpreter's report, held."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _NAMESPACE_PROBE],
                         capture_output=True, text=True, timeout=300,
                         cwd=root, env=dict(os.environ, PYTHONPATH=root))
    if out.returncode != 0:
        raise AssertionError(f"26a: the probe failed: {out.stderr[-2000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"[namespace] 26a a fresh `import paddle_tpu_torch as paddle` on "
        f"{card}: {len(got['ok'])} lazy names resolved, "
        f"{len(got['unported'])} raise naming their item "
        f"({got['unported']}); C.14: batches {got['batch']}, "
        f"Linear(4, 3) on {got['weight']} gives CE {got['loss']:.6f}; "
        f"{time.perf_counter() - t0:.1f} s")
    if got["bad"] or got["reference"] or got["batch"] != [
            "torch.float32", "torch.int32"] or not got[
            "weight"].startswith("cuda") or not np.isfinite(got["loss"]) \
            or got["dtype"] != "torch.float32":
        raise AssertionError(f"26a: {got}")


class _CopyTask(io.Dataset):
    """A seeded copy task as a user's dataset yields it: int64 token ids,
    the source's length as a Python int (the key-padding mask is made
    from it in the network), target input and target."""

    def __init__(self, n, vocab, s, t, seed=0):
        rng = np.random.RandomState(seed)
        self.lengths = rng.randint(s // 2, s + 1, n)
        keep = np.arange(s)[None] < self.lengths[:, None]
        self.src = np.where(keep, rng.randint(2, vocab, (n, s)), 0)
        tgt = self.src[:, :t]
        self.tgt_in = np.concatenate([np.full((n, 1), T_BOS), tgt[:, :-1]],
                                     1)
        self.tgt = tgt

    def __len__(self):
        return len(self.src)

    def __getitem__(self, i):
        return (self.src[i], int(self.lengths[i]), self.tgt_in[i],
                self.tgt[i])


def _paddle_seq2seq(paddle, vocab, **kw):
    """Phase 25a's model through top-level names only: ``forward(src,
    length, tgt_in)`` gives the logits."""
    nn = paddle.nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            d = kw["d_model"]
            self.src_emb = nn.Embedding(vocab, d)
            self.tgt_emb = nn.Embedding(vocab, d)
            self.transformer = nn.Transformer(**kw)
            self.head = nn.Linear(d, vocab)

        def forward(self, src, length, tgt_in):
            t = self.transformer
            keep = (paddle.arange(src.shape[1])[None]
                    < length[:, None])[:, None, None, :]
            return self.head(t(
                self.src_emb(src), self.tgt_emb(tgt_in), keep,
                t.generate_square_subsequent_mask(tgt_in.shape[1]), keep))

    return Seq2Seq()


def _plain_attention(q, k, v, mask):
    """Softmax attention in fp32 with an additive mask, ``[b, s, h, d]``."""
    qt, kt, vt = (t.float().transpose(1, 2) for t in (q, k, v))
    s = qt @ kt.transpose(-1, -2) / math.sqrt(q.shape[-1]) + mask
    return (s.softmax(-1) @ vt).transpose(1, 2)


def _pylayer_26b(paddle, mask, gen):
    """26b: the decoder's causal self-attention on the tile mode inside a
    ``PyLayer`` whose backward recomputes the forward under
    ``enable_grad`` and calls ``paddle.grad``, against the same call
    under plain autograd and the fp32 plain version; its launches."""
    F = paddle.nn.functional

    class CausalAttention(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, q, k, v):
            ctx.save_for_backward(q, k, v)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        @staticmethod
        def backward(ctx, do):
            q, k, v = (t.detach().requires_grad_()
                       for t in ctx.saved_tensor())
            with paddle.enable_grad():
                out = F.scaled_dot_product_attention(q, k, v,
                                                     attn_mask=mask)
            return tuple(paddle.grad(out, [q, k, v], do))

    b, s, h, d = T_BATCH, T_TGT, T_BASE["nhead"], \
        T_BASE["d_model"] // T_BASE["nhead"]
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    runs = {}
    for tag in ("pylayer", "autograd", "plain"):
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        _reset_tile_launches()
        if tag == "pylayer":
            out = CausalAttention.apply(*xs)
        elif tag == "autograd":
            out = F.scaled_dot_product_attention(*xs, attn_mask=mask)
        else:
            out = _plain_attention(*xs, mask)
        grads = torch.autograd.grad(out, xs, do)
        torch.cuda.synchronize()
        runs[tag] = ([out, *grads], _tile_launches())
    names = ("out", "dq", "dk", "dv")
    err = {f"{tag} {n}": _tile_rel_err(g, w) for tag in ("pylayer",
                                                          "autograd")
           for n, g, w in zip(names, runs[tag][0], runs["plain"][0])}
    abs_err = max((g.float() - w.float()).abs().max().item() for g, w in
                  zip(runs["pylayer"][0], runs["autograd"][0]))
    want = {"flash_fwd_tile": 2, "flash_bwd_dq_tile": 1,
            "flash_bwd_dkv_tile": 1, "flash_tile_classes": 2}
    log(f"[namespace] 26b PyLayer over the tile mode (b{b} s{s} h{h} d{d} "
        f"bf16, the causal mask; backward recomputes under enable_grad and "
        f"calls paddle.grad): per-tile error against the fp32 plain version "
        f"{ {k: f'{e:.3e}' for k, e in err.items()} } (tol "
        f"{FLASH_REL_TOL}); max abs difference from the same call under "
        f"autograd {abs_err:.3e}; launches {runs['pylayer'][1]} (plain "
        f"autograd {runs['autograd'][1]})")
    if max(err.values()) > FLASH_REL_TOL or runs["pylayer"][1] != want:
        raise AssertionError(f"26b: the PyLayer's attention: errors {err}, "
                             f"launches {runs['pylayer'][1]} (want {want})")
    return runs["pylayer"][1], max(err.values()), abs_err


def _nan_flag_26b(paddle):
    """26b: ``FLAGS_check_nan_inf`` on card tensors, and a ``TrainStep``
    that still captures with the flag on."""
    msgs = []
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        for bad in (lambda: paddle.log(paddle.to_tensor([-1.0, 2.0])),
                    lambda: paddle.to_tensor([1.0]) / paddle.to_tensor(
                        [0.0])):
            try:
                bad()
            except FloatingPointError as e:
                msgs.append(str(e))
        paddle.seed(1)
        net = paddle.nn.Sequential(paddle.nn.Linear(64, 128),
                                   paddle.nn.ReLU(),
                                   paddle.nn.Linear(128, 1))
        step = TrainStep(net, paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=net.parameters()),
            lambda m, x, y: ((m(x) - y) ** 2).mean())
        x, y = paddle.randn([32, 64]), paddle.randn([32, 1])
        before = exec_cache.stats()["captures"]
        losses = [float(step(x, y)) for _ in range(4)]
        captured = exec_cache.stats()["captures"] - before
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": False})
    log(f"[namespace] 26b FLAGS_check_nan_inf on the card: {msgs}; a "
        f"TrainStep with the flag on: {captured} capture(s), losses "
        f"{[round(v, 6) for v in losses]}")
    if len(msgs) != 2 or captured < 1 or not all(np.isfinite(losses)):
        raise AssertionError(f"26b: the nan flag: {msgs}, {captured} "
                             f"captures, losses {losses}")


def _fit_26b(paddle, card, smi):
    """26b: Transformer-base through top-level names: ``paddle.seed``,
    ``paddle.io.DataLoader`` (inside ``fit``), ``paddle.Model(net)
    .prepare(AdamW(grad_clip=ClipGradByGlobalNorm(1.0)))``, ``fit``;
    ``summary``, ``flops``, the RNG state, the device memory."""
    import io as pyio

    paddle.seed(26)
    net = paddle.amp.decorate(_paddle_seq2seq(paddle, T_VOCAB, **T_BASE),
                              level="O2", dtype="bfloat16")
    n_steps = WARMUP_STEPS + TIMED_STEPS
    data = _CopyTask(T_BATCH * n_steps, T_VOCAB, T_SRC, T_TGT, seed=26)
    small = [torch.as_tensor(np.asarray(a[:2])).cuda() for a in (
        data.src, data.lengths, data.tgt_in)]
    buf = pyio.StringIO()
    with contextlib.redirect_stdout(buf):
        info = paddle.summary(net, input=small)
    total = sum(p.numel() for p in net.parameters())
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        enc_flops = paddle.flops(net.transformer.encoder,
                                 [1, T_SRC, T_BASE["d_model"]])
    lines = len(buf.getvalue().splitlines())
    log(f"[namespace] 26b paddle.summary: {info} ({lines} lines printed), "
        f"sum of numels {total}; "
        f"paddle.flops(encoder, [1, {T_SRC}, {T_BASE['d_model']}]) "
        f"{enc_flops} (its Linear layers' multiply-accumulates)")
    if info["total_params"] != total or info["trainable_params"] != total:
        raise AssertionError(f"26b: summary {info}, numels {total}")

    # the RNG state repeats a dropout step (residual dropout from the
    # card's generator, attention dropout from the seed words)
    ce = paddle.nn.CrossEntropyLoss(label_smoothing=0.1)

    def loss_fn(logits, tgt):
        return ce(logits.reshape([-1, logits.shape[-1]]), tgt.reshape([-1]))

    batch = [torch.as_tensor(np.asarray(a[:8])).cuda()
             for a in (data.src, data.lengths, data.tgt_in)]
    with paddle.no_grad():
        state = paddle.get_rng_state()
        first = net(*batch)
        paddle.set_rng_state(state)
        again = net(*batch)
        other = net(*batch)
    differ = (first != other).float().mean().item()
    log(f"[namespace] 26b set_rng_state(get_rng_state()) before a dropout "
        f"forward (8 rows): logits repeated bit for bit "
        f"{torch.equal(first, again)}; the next draw changes "
        f"{differ:.4f} of them")
    if not torch.equal(first, again) or differ == 0.0:
        raise AssertionError("26b: the RNG state did not repeat the step")
    del first, again, other

    class Clock(paddle.callbacks.Callback):
        def __init__(self):
            self.t, self.losses = [], []

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())
            self.losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))

    opt = paddle.optimizer.AdamW(
        learning_rate=1e-4, parameters=net.parameters(),
        multi_precision=True, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    model = paddle.Model(net)
    model.prepare(opt, loss_fn)
    clock = Clock()
    _reset_launches()
    _reset_tile_launches()
    model.fit(data, batch_size=T_BATCH, epochs=1, shuffle=False, verbose=0,
              log_freq=1, callbacks=[clock])
    ms = (clock.t[-1] - clock.t[WARMUP_STEPS - 1]) * 1e3 / TIMED_STEPS
    tile, launched = _tile_launches(), _launch_counts()
    dec, enc = T_BASE["num_decoder_layers"], T_BASE["num_encoder_layers"]
    want_tile = {n: dec * n_steps for n in TILE_NAMES}
    want_hb = {w.__name__: (enc + dec) * n_steps for w in HB_WRAPPERS}
    mem = {"max_memory_allocated": (paddle.device.max_memory_allocated(),
                                    torch.cuda.max_memory_allocated()),
           "memory_allocated": (paddle.device.memory_allocated(),
                                torch.cuda.memory_allocated()),
           "memory_reserved": (paddle.device.memory_reserved(),
                               torch.cuda.memory_reserved())}
    props = paddle.device.get_device_properties()
    log(f"[namespace] 26b Transformer-base ({total / 1e6:.1f} M) through "
        f"paddle.Model.fit, O2 bf16, AdamW with ClipGradByGlobalNorm(1.0), "
        f"b{T_BATCH} x src {T_SRC} x tgt {T_TGT} from a DataLoader over "
        f"int64 ids and Python-int lengths, on {card} ({smi}): "
        f"{ms:.2f} ms a step over {TIMED_STEPS} steps after "
        f"{WARMUP_STEPS}; losses {[round(x, 4) for x in clock.losses]}; "
        f"launches over {n_steps} steps: tile mode {tile}, {launched}; "
        f"memory {mem}; get_device_properties {props}")
    if len(clock.losses) != n_steps or not (
            all(np.isfinite(clock.losses))
            and abs(clock.losses[0] - np.log(T_VOCAB)) <= 1.0):
        raise AssertionError(f"26b: losses {clock.losses}")
    if tile != want_tile or any(launched[k] != v for k, v in
                                want_hb.items()) \
            or any(w.launches for w in FLASH_WRAPPERS):
        raise AssertionError(f"26b: launches tile {tile} (want {want_tile}),"
                             f" {launched} (want {want_hb}, kernels 1-3 "
                             f"none)")
    if any(a != b for a, b in mem.values()) or \
            props["name"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"26b: device memory {mem}, {props}")
    # readings, not held: the same step as a bare eager loop on one batch
    # already on the card, with the clip and without it (a second AdamW)
    batch = [paddle.to_tensor(np.asarray(a[:T_BATCH])) for a in (
        data.src, data.lengths, data.tgt_in, data.tgt)]
    bare = {}
    for tag, o in (("clip", opt), ("no clip", paddle.optimizer.AdamW(
            learning_rate=1e-4, parameters=net.parameters(),
            multi_precision=True))):
        def step(o=o):
            loss_fn(net(*batch[:3]), batch[3]).backward()
            o.step()
            o.clear_grad()

        for _ in range(WARMUP_STEPS):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            step()
        torch.cuda.synchronize()
        bare[tag] = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    log(f"[namespace] 26b the same step as a bare eager loop (a reading): "
        f"{bare['clip']:.2f} ms with ClipGradByGlobalNorm, "
        f"{bare['no clip']:.2f} ms without; fit's {ms:.2f} ms less the "
        f"bare step with the clip: {ms - bare['clip']:.2f} ms")
    mask = net.transformer.generate_square_subsequent_mask(T_TGT)
    return ms, dict(launched, **tile), mask


def phase_namespace(card, smi):
    """Phase 26: the top-level namespace on the card."""
    import paddle_tpu_torch as paddle

    t_phase = time.perf_counter()
    _namespace_26a(card)
    ms, launched, mask = _fit_26b(paddle, card, smi)
    _release()
    gen = torch.Generator("cuda").manual_seed(26)
    pylayer, err, abs_err = _pylayer_26b(paddle, mask, gen)
    _nan_flag_26b(paddle)
    log(f"[namespace] phase {time.perf_counter() - t_phase:.1f} s")
    return {"ms": ms, "launches": launched, "pylayer": pylayer,
            "pylayer_err": err}


# -- phase 27 -----------------------------------------------------------------

# 27a: the 0.44B Llama at mp 8 with SP, its 12 heads over 8 ranks (2, 2,
# 2, 2, 1, 1, 1, 1), the sequence padded (1020 % 8 = 4) and the chunked
# CE over each rank's 4000 vocab columns of the head
MP8 = dict(FULL, sequence_parallel=True, use_parallel_cross_entropy=False,
           ce_chunk_size=CE_CHUNK)
MP8_SEQ = 1020
MP8_STEPS = 2
MP8_NEW = 16
# 27a's decode runs in the config's dtype (bf16 weights and pools, kernel
# 7's bf16 variant at a rank's 1 or 2 heads) and, beside it, on an fp32
# copy of the same weights (kernel 7's fp32 variant, kernel 8 over int8
# pools). The fp32 tokens must equal one card's. The bf16 tokens must
# equal one card's, or part first at a rounding: 23c's tie rule (one
# card's two logits within TIE_REL of the row's largest), or else the
# witness of _held_to_rounding at the parting position, from the three
# forwards over one card's tokens: one card's bf16 logits L1 and fp32
# logits Lf, rank 0's bf16 logits Lr at mp 8. Held if the ranks' logits
# row stays within MP8_ROUND_RATIO times one card's own bf16 distance
# from fp32 (max |Lr - Lf| <= ratio * max |L1 - Lf|) and the two tokens'
# fp32 logits lie within the two distances of each other. The ratio:
# the column-parallel products round as one card's do; a row-parallel
# sum rounds each of its 8 bf16 partials (together about one rounding of
# the sum, their sizes ~ 1/sqrt(8) of it) and then its 7 bf16 additions:
# ~sqrt(8) = 2.8x one card's single rounding where the sums sit, less
# over the whole layer; 4 leaves room for the max over 32000 logits. A wrong head
# cut or a missing reduce moves every logit by O(|logit|), far beyond.
MP8_DECODE = dict(MP8, dtype="float32")
MP8_ROUND_RATIO = 4.0
# step 1's gradients against one card's, at PERF.md's limit for mp
# (17c's, 5e-2): each row-parallel sum and each reduce-scatter of SP adds
# 8 bf16 partials where 17c added 2, but 17c read 2.4e-2 at layer 0. A
# wrong head cut, a missing reduce or a pad row left in is wrong by O(1).
# The losses keep 1e-3 (fp32 CE on the head's fp32 logits; 17c read
# 1.3e-4).
MP8_GRAD_REL_TOL = 5e-2
# 27b: kernels 1-3 at a rank's heads of 27a (its 1 or 2 of d 128), held
# per tile and timed at s1024, held per tile at s1020 too: 27a's padded
# sequence is trimmed before attention, so the kernels see 1020 rows and
# keys there (a ragged last tile of 60)
RANK_HEAD_CASES = [(f"mp 8 rank, {h} head{'s' * (h > 1)}, s{s}", 8, s, s, h,
                    h, True, 0, 128) for s in (1024, MP8_SEQ) for h in (1, 2)]
# 27c: LBFGS at dp 2 x mp 2 against one card, fp32. Reduced: the width
# (at the 0.44B Llama's, one host float64 vector of a rank's parameters is
# ~1.8 GB; the history holds 20 of them a rank)
LBFGS_CFG = dict(vocab_size=32000, hidden_size=256, intermediate_size=688,
                 num_hidden_layers=2, num_attention_heads=4,
                 max_position_embeddings=256, dtype="float32")
LBFGS_BATCH, LBFGS_SEQ, LBFGS_STEPS = 8, 256, 3
# (max_iter 2: the host float64 two-loop over ~8.6 M parameters a rank is
# the call's time; the CPU tests run 4 iterations a step, which fill and
# roll the history)
LBFGS_KW = dict(learning_rate=1.0, max_iter=2, history_size=10,
                line_search_fn="strong_wolfe")
LBFGS_LOSS_TOL = 1e-4
# 27d: ArcFace's head (Deng et al. 2019, MS1M-ArcFace: 85742 classes,
# 512-d features, margins 1.0 / 0.5 / 0.0, scale 64), a batch of 256, fp32,
# over 3 ranks holding 28581, 28581 and 28580 classes. fp32 on both sides,
# only the order of the sums differs: the loss within 1e-5 of its value,
# the softmax within 1e-6 (its entries are <= 1), each rank's logit
# gradient within 1e-5 of the whole gradient's largest |value|
ARC = dict(classes=85742, dim=512, batch=256, margins=(1.0, 0.5, 0.0, 64.0))
ARC_SPLIT = (28581, 28581, 28580)
ARC_LOSS_RTOL, ARC_SOFTMAX_ATOL, ARC_GRAD_TOL = 1e-5, 1e-6, 1e-5
# 27e: 20a's MoE Llama at depth 2, mp 2 x sep 2 with SP and ring context
# parallelism, the experts over ("sep", "mp"): each rank 2 of the 8. As
# 21a (see HYBRID_MICRO's note), in bf16 the ranks route by one card's
# expert choices and print how many of their own differ (choosing for
# themselves, the bf16 ranks part from one card by 3.6e-2 at step 3 on
# the H100: PERF.md, phase 27). In fp32, from the same weights, the
# ranks' gates choose for themselves, held at the same limits.
EXPERTS_SEP_MP = dict(MOE, num_hidden_layers=2, sequence_parallel=True,
                      context_parallel=True, moe_expert_axis=("sep", "mp"))
EXPERTS_LEGS = (("bfloat16", True), ("float32", False))  # (dtype, steered)
EXPERTS_STEPS = 3
EXPERTS_TOL_FIRST, EXPERTS_TOL_LATER = 1e-3, 1e-2


def _mp8_model(cfg, weights=None):
    """The 0.44B Llama of ``cfg`` on the card: from a generator seeded 0,
    or from one card's ``weights`` (cut to this rank's shards)."""
    model = LlamaForCausalLM(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(0 if weights is None else 1))
    if weights is not None:
        load_jax_weights(model, weights)
    return model


def _mp8_steps(model, opt, ids, labels, leaves=True):
    """MP8_STEPS eager steps; (losses, ms each, step 1's leaves)."""
    losses, ms, grads = [], [], None
    for i in range(MP8_STEPS):
        t0 = time.perf_counter()
        opt.clear_grad()
        loss = model(ids, labels)
        loss.backward()
        if i == 0 and leaves:  # outside the step's time
            torch.cuda.synchronize()
            t0 -= time.perf_counter()
            grads = _grad_leaves(model)
            t0 += time.perf_counter()
        opt.step()
        losses.append(float(loss.detach()))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, grads


def _decode_tokens(model, prompts, kv_int8=False):
    """``generate()``'s greedy tokens (once, beside the model's pools:
    ``generate`` has no int8 pools), then the engine's (pools of the
    model's dtype, or int8 with ``kv_int8``), and the launches each
    made."""
    _reset_launches()
    gen = None if kv_int8 else generate(
        model, prompts, max_new_tokens=MP8_NEW, device="cuda").cpu().tolist()
    gen_launches = _launch_counts()
    eng = ServingEngine(model, ServingConfig(max_seq_len=MAX_SEQ_LEN,
                                             kv_int8=kv_int8), device="cuda")
    reqs = [eng.submit(row, max_new_tokens=MP8_NEW) for row in prompts]
    done = eng.run()
    torch.cuda.synchronize()
    out = {"generate": gen,
           "engine": [np.asarray(done[r.request_id]).tolist() for r in reqs],
           "decode_steps": eng.stats()["decode_steps"],
           "pool": tuple(eng._kpool.shape),
           "generate_launches": gen_launches, "launches": _launch_counts()}
    del eng
    return out


def _witness_seqs(prompts, one):
    """The rows 27a's witness feeds: each prompt followed by one card's
    bf16 tokens but the last, ``generate()``'s rows then the engine's."""
    return np.concatenate([
        np.concatenate([prompts, np.asarray(one[k], np.int32)[:, :-1]], 1)
        for k in ("generate", "engine")]).astype(np.int32)


def _witness_logits(model, seqs):
    """``model``'s logits over ``seqs`` fed at once (its training
    forward, no cache), fp32 on the host."""
    with torch.no_grad():
        return model(torch.from_numpy(seqs).cuda()).float().cpu().numpy()


def _held_to_rounding(got, want, rows0, logits, prompt_len):
    """``got`` (a rank's bf16 tokens, ``generate()``'s or the engine's)
    against one card's ``want``, row by row: equal, or equal up to a
    first parting that 23c's tie rule or the rounding witness holds (see
    MP8_ROUND_RATIO). ``logits``: one card's bf16 and fp32 and rank 0's
    bf16 logits over ``_witness_seqs``, whose rows for these tokens start
    at ``rows0``. Returns (held, a reading of each parting)."""
    held, readings = True, []
    for row, (g, w) in enumerate(zip(got, want)):
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if t is None:
            continue
        one, f32, rank = (x[rows0 + row, prompt_len - 1 + t] for x in logits)
        a, b = w[t], g[t]  # one card's token, the rank's
        r = dict(row=row, position=t, tokens=(a, b),
                 gap_bf16=float(one[a] - one[b]),
                 tie_within=TIE_REL * float(np.abs(one).max()),
                 gap_fp32=float(f32[a] - f32[b]),
                 one_card_off_fp32=float(np.abs(one - f32).max()),
                 rank_off_fp32=float(np.abs(rank - f32).max()))
        r["tie"] = abs(r["gap_bf16"]) <= r["tie_within"]
        r["rounding"] = (r["rank_off_fp32"]
                         <= MP8_ROUND_RATIO * r["one_card_off_fp32"]
                         and abs(r["gap_fp32"])
                         <= r["one_card_off_fp32"] + r["rank_off_fp32"])
        held = held and (r["tie"] or r["rounding"])
        readings.append(r)
    return held, readings


def _rank_27a(root, ids, labels, prompts, seqs):
    """One of 27a's eight ranks sharing the card, on its mp 8 shards of
    one card's weights: ``generate()`` and the engine on the bf16 model
    (rank 0 keeps the witness's logits over ``seqs``), then on an fp32
    copy's shards (fp32 and int8 pools), then 2 eager AdamW steps with
    the clip through fleet."""
    dist = _rank_setup(root)
    from paddle_tpu_torch.distributed import fleet

    cfg = LlamaConfig(**MP8)
    full = _mp8_model(cfg)
    weights = {n: p.detach() for n, p in full.named_parameters()}
    del full
    fleet.init(is_collective=True, strategy=_strategy(mp=8))
    model = _mp8_model(cfg, weights)
    out = {"bf16": _decode_tokens(model, prompts)}
    witness = _witness_logits(model, seqs)
    dec = _mp8_model(LlamaConfig(**MP8_DECODE), weights)
    del weights
    out.update({tag: _decode_tokens(dec, prompts, kv_int8=int8)
                for tag, int8 in (("fp32", False), ("int8", True))})
    del dec
    _release()
    attn = model.llama.layers[0].self_attn
    opt = fleet.distributed_optimizer(_fleet_optimizer(model))
    net = fleet.distributed_model(model)
    ids, labels = (torch.from_numpy(a).cuda() for a in (ids, labels))
    _reset_launches()
    losses, ms, grads = _mp8_steps(net, opt, ids, labels)
    torch.cuda.synchronize()
    out.update(losses=losses, ms=ms, heads=attn._nh, kv_heads=attn._nkv,
               train_launches=_launch_counts(),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if dist.get_rank() == 0:
        grads["witness"] = witness
    _save_rank(root, out, grads)
    dist.destroy_process_group()


DECODE_LEGS = (("bf16", "paged_attend"), ("fp32", "paged_attend"),
               ("int8", "paged_attend_int8"))


def _phase_27a(card):
    """27a: the one card's run, then the eight ranks against it; returns
    a 1-head rank's launches."""
    ids, labels = _train_batch(MP8["vocab_size"], TRAIN_BATCH, MP8_SEQ)
    prompts = np.random.RandomState(3).randint(
        0, MP8["vocab_size"], (2, 8)).astype(np.int32)
    cfg = LlamaConfig(**MP8)
    model = _mp8_model(cfg)
    one = {"bf16": _decode_tokens(model, prompts)}
    seqs = _witness_seqs(prompts, one["bf16"])
    w_one = _witness_logits(model, seqs)
    dec = _mp8_model(LlamaConfig(**MP8_DECODE), {
        n: p.detach() for n, p in model.named_parameters()})
    w_f32 = _witness_logits(dec, seqs)
    one.update({tag: _decode_tokens(dec, prompts, kv_int8=int8)
                for tag, int8 in (("fp32", False), ("int8", True))})
    del dec
    opt = _fleet_optimizer(model)
    want, _, want_grads = _mp8_steps(model, opt, ids, labels)
    del model, opt
    _release()
    ranks, arrays, wall = _spawn_ranks(
        _rank_27a, (ids.cpu().numpy(), labels.cpu().numpy(), prompts, seqs),
        n=8)
    steps = [max(abs(o["losses"][i] - want[i]) for o in ranks)
             for i in range(MP8_STEPS)]
    diff = max(steps)
    err = _grad_errors(arrays, want_grads)
    # AdamW's first update is lr * sign(g) (m / sqrt(v) = g / |g| at step
    # 1): where the ranks' step-1 gradient has the other sign, the weight
    # moves 2 lr the other way, not by a rounding
    flips = max(sum(int((np.sign(a[n]) != np.sign(w)).sum())
                    for n, w in want_grads.items())
                / sum(w.size for w in want_grads.values()) for a in arrays)
    layers = MP8["num_hidden_layers"]
    for o in ranks:
        log(f"[mp8] 27a rank {o['rank']} of 8 sharing {card} (gloo): "
            f"{o['heads']} q heads, {o['kv_heads']} kv heads (replicated: "
            f"mp 8 does not divide 12), losses {o['losses']}, kernels "
            f"1-3 over {MP8_STEPS} steps {o['train_launches']}, peak "
            f"{o['peak_gib']:.3f} GiB, ms a step "
            f"{[round(x, 1) for x in o['ms']]} (host-staged, a reading "
            f"only); decode: pools (bf16) {o['bf16']['pool']}, launches "
            + ", ".join(f"{tag} generate {o[tag]['generate_launches'][k]}, "
                        f"engine {o[tag]['launches'][k]} "
                        f"({o[tag]['decode_steps']} rounds)"
                        for tag, k in DECODE_LEGS))
    log(f"[mp8] 27a the 0.44B Llama at mp 8, SP, b{TRAIN_BATCH} x "
        f"s{MP8_SEQ} (padded to {-(-MP8_SEQ // 8) * 8}), ce_chunk_size "
        f"{CE_CHUNK} over each rank's {MP8['vocab_size'] // 8} vocab "
        f"columns: every rank's losses within {diff:.3e} of one card's "
        f"{[round(x, 5) for x in want]} (tol {FLEET_CHECK_TOL}; each step "
        f"{[f'{x:.3e}' for x in steps]}); step 1's gradients, relative "
        f"Frobenius error (worst rank; tol "
        f"{MP8_GRAD_REL_TOL}): "
        + ", ".join(f"{n} {e:.3e}" for n, e in err.items())
        + f"; their elements of the other sign than one card's (worst "
        f"rank) {flips:.4e}; spawn to join {wall:.1f} s")
    if not diff <= FLEET_CHECK_TOL \
            or any(o["losses"] != ranks[0]["losses"] for o in ranks):
        raise AssertionError("27a: the ranks' losses left one card's or "
                             "each other's")
    bad = {n: e for n, e in err.items() if not e <= MP8_GRAD_REL_TOL}
    if bad:
        raise AssertionError(f"27a: gradients left one card's: {bad}")
    heads = sorted(o["heads"] for o in ranks)
    if heads != [1] * 4 + [2] * 4:
        raise AssertionError(f"27a: the ranks hold {heads} heads")
    logits = (w_one, w_f32, arrays[0]["witness"])
    for o in ranks:
        tl = o["train_launches"]
        if any(tl[w.__name__] != layers * MP8_STEPS for w in FLASH_WRAPPERS):
            raise AssertionError(f"27a: rank {o['rank']} ({o['heads']} "
                                 f"heads) launched kernels 1-3 {tl}")
        for tag, kernel in DECODE_LEGS:
            got, ref = o[tag], one[tag]
            log(f"[mp8] 27a rank {o['rank']} {tag}: generate "
                f"{got['generate']} (one card {ref['generate']}), engine "
                f"{got['engine']} (one card {ref['engine']})")
            if tag == "bf16":
                held, readings = True, []
                for k, rows0 in (("generate", 0), ("engine", 2)):
                    h, r = _held_to_rounding(got[k], ref[k], rows0, logits,
                                             prompts.shape[1])
                    held = held and h
                    readings += [dict(x, of=k) for x in r]
                for r in readings:
                    log(f"[mp8] 27a rank {o['rank']} bf16: {r['of']} parts "
                        f"from one card at row {r['row']}, token "
                        f"{r['position']} ({r['tokens'][0]} on one card, "
                        f"{r['tokens'][1]} here): one card's bf16 logits "
                        f"hold them {r['gap_bf16']:.4e} apart (23c's tie "
                        f"within {r['tie_within']:.4e}: {r['tie']}); the "
                        f"witness: fp32 {r['gap_fp32']:.4e} apart, the bf16 "
                        f"rows' largest distance from fp32 one card "
                        f"{r['one_card_off_fp32']:.4e}, rank 0 at mp 8 "
                        f"{r['rank_off_fp32']:.4e} (ratio "
                        f"{r['rank_off_fp32'] / r['one_card_off_fp32']:.3f}, "
                        f"limit {MP8_ROUND_RATIO}): rounding "
                        f"{r['rounding']}")
            else:
                held = got["generate"] == ref["generate"] \
                    and got["engine"] == ref["engine"]
            if not held:
                raise AssertionError(f"27a {tag}: rank {o['rank']} decoded "
                                     f"other tokens than one card")
            n = got["launches"][kernel]
            if n != layers * got["decode_steps"] or not n:
                raise AssertionError(f"27a {tag}: rank {o['rank']} launched "
                                     f"{kernel} {n} times")
            if got["pool"][3] != o["heads"]:
                raise AssertionError(f"27a {tag}: rank {o['rank']}'s pool "
                                     f"{got['pool']} is not its "
                                     f"{o['heads']} kv heads")
    _release()
    one_head = next(o for o in ranks if o["heads"] == 1)
    return dict(one_head["train_launches"],
                paged_attend=one_head["bf16"]["launches"]["paged_attend"],
                paged_attend_int8=one_head["int8"]["launches"][
                    "paged_attend_int8"])


def _phase_27b():
    """27b: kernels 1-3 at a rank's 1 and 2 heads (held per tile at s1024
    and s1020, timed at s1024), kernel 7 at one head over its bf16 and
    fp32 pools and kernel 8 over its int8 pool; each held and timed.
    Returns the rows."""
    gen = torch.Generator("cuda").manual_seed(27)
    rows = {}
    for case in RANK_HEAD_CASES:
        errs, (q, k, v, do, out, lse, delta) = _flash_check(case, gen,
                                                            fused=True)
        h, s = case[4], case[2]
        if s != 1024:
            continue
        got, times, _, lib = _flash_kernel_rows(q, k, v, do, out, lse, delta,
                                                errs)
        for name, row in got.items():
            rows.setdefault(name, {})[f"mp8_rank_h{h}"] = row
            log(f"[mp8] 27b {name} b8 s{s} h{h} d128 bf16 causal: "
                f"kernel_ms {_spread(times[name])} (CUDA graphs of {ITERS} "
                f"calls) plain_ms {row['plain_ms']:.4f} library_ms "
                f"{_ms(row['library_ms'])} ({lib[name][1]}) bound_ms "
                f"{row['bound_ms']:.5f} ({row['bound_by']}); kernel / "
                f"bound {row['ms'] / row['bound_ms']:.2f}")
    layers = FULL["num_hidden_layers"]
    rows["paged_attend"] = {
        "mp8_rank_h1": _time_shape(False, gen, layers, M, POS, nkv=1),
        "mp8_rank_h1_fp32": _time_shape(False, gen, layers, M, POS,
                                        dtype=torch.float32, nkv=1)}
    rows["paged_attend_int8"] = {"mp8_rank_h1": _time_shape(
        True, gen, layers, M, POS, nkv=1)}
    return rows


def _lbfgs_run(model, net, ids, labels):
    """LBFGS_STEPS steps of LBFGS_KW through fleet: (losses, closure calls
    each step)."""
    from paddle_tpu_torch.distributed import fleet

    calls = [0]

    def closure():
        calls[0] += 1
        loss = net(ids, labels)
        loss.backward()
        return loss

    opt = fleet.distributed_optimizer(
        LBFGS(parameters=model.parameters(), **LBFGS_KW))
    losses, counts = [], []
    for _ in range(LBFGS_STEPS):
        calls[0] = 0
        losses.append(float(opt.step(closure)))
        counts.append(calls[0])
    return losses, counts


def _arcface_inputs():
    """The features, class centres and labels of 27d, seeded, on the
    card: cosines come from the normalized product."""
    gen = torch.Generator("cuda").manual_seed(4)
    x = torch.nn.functional.normalize(torch.randn(
        ARC["batch"], ARC["dim"], device="cuda", generator=gen), dim=1)
    w = torch.nn.functional.normalize(torch.randn(
        ARC["dim"], ARC["classes"], device="cuda", generator=gen), dim=0)
    label = torch.randint(0, ARC["classes"], (ARC["batch"],), device="cuda",
                          generator=gen)
    return x, w, label


def _margin_ce(cos, label, group=None):
    from paddle_tpu_torch.nn import functional as F

    cos = cos.detach().requires_grad_()
    loss, sm = F.margin_cross_entropy(cos, label, *ARC["margins"],
                                      group=group, return_softmax=True)
    loss.backward()
    return float(loss.detach()), sm.detach(), cos.grad


def _lbfgs_rank(weights, ids, labels):
    """27c on this rank (dp 2 x mp 2): its shards of one card's weights,
    its dp rows, LBFGS through fleet."""
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True, strategy=_strategy(dp=2, mp=2))
    hcg = fleet.get_hybrid_communicate_group()
    model = _mp8_model(LlamaConfig(**LBFGS_CFG), weights)
    rows = slice(hcg.get_data_parallel_rank() * LBFGS_BATCH // 2,
                 (hcg.get_data_parallel_rank() + 1) * LBFGS_BATCH // 2)
    ids, labels = (torch.from_numpy(a[rows]).cuda() for a in (ids, labels))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, counts = _lbfgs_run(model, fleet.distributed_model(model), ids,
                                labels)
    return {"losses": losses, "calls": counts,
            "seconds": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _margin_rank(group, rank):
    """27d on rank ``rank`` of the 3 of ``group``: its classes' cosines,
    the class-sharded loss."""
    x, w, label = _arcface_inputs()
    lo = sum(ARC_SPLIT[:rank])
    cos = (x @ w)[:, lo:lo + ARC_SPLIT[rank]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, sm, grad = _margin_ce(cos, label, group)
    torch.cuda.synchronize()
    return ({"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
             "classes": cos.shape[1]},
            {"softmax": sm.cpu().numpy(), "grad": grad.cpu().numpy()})


def _experts_rank(weights, ids, labels, choices):
    """27e on this rank (mp 2 x sep 2, SP, ring): its experts' shards of
    one card's weights and its sequence chunk, each leg of EXPERTS_LEGS
    (the bf16 leg routed by one card's expert ``choices``). Returns
    {dtype: its results}."""
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True, strategy=_strategy(mp=2, sep=2))
    hcg = fleet.get_hybrid_communicate_group()
    chunk = ids.shape[1] // 2
    sep, mp = hcg.get_sep_parallel_rank(), hcg.get_model_parallel_rank()
    cols = slice(sep * chunk, (sep + 1) * chunk)
    ids, labels = (torch.from_numpy(a[:, cols]).cuda()
                   for a in (ids, labels))
    # the rank's tokens under SP: its mp half of its sep chunk, each row
    mine = sep * chunk + mp * (chunk // 2) + np.arange(chunk // 2)
    out = {}
    for dtype, steered in EXPERTS_LEGS:
        torch.cuda.reset_peak_memory_stats()
        model = _mp8_model(LlamaConfig(**dict(EXPERTS_SEP_MP, dtype=dtype)),
                           weights)
        differ = _steer_choices(
            {str(i): blk.mlp for i, blk in enumerate(model.llama.layers)},
            {k: c.reshape(c.shape[:2] + (ids.shape[0], -1))[..., mine]
             .reshape(c.shape[:2] + (-1,)) for k, c in choices.items()}) \
            if steered else None
        net = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(_fleet_optimizer(model))
        _reset_launches()
        losses, dispatched = [], []
        for _ in range(EXPERTS_STEPS):
            opt.clear_grad()
            loss = net(ids, labels)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            dispatched.append([int(blk.mlp.dispatched.sum())
                               for blk in model.llama.layers])
        out[dtype] = {
            "losses": losses, "dispatched": dispatched,
            "differ": None if differ is None else [
                int(sum(c[i] for c in differ.values()))
                for i in range(EXPERTS_STEPS)],
            "experts": model.llama.layers[0].mlp.w_in.shape[0],
            "launches": _launch_counts(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del net, opt, model
        _release()
    return out


def _experts_one_card(batch):
    """27e's yardstick: the MoE Llama on one card, each leg of
    EXPERTS_LEGS from the same weights. Returns ({dtype: losses}, the
    steered leg's expert choices)."""
    cfg = dict(EXPERTS_SEP_MP, sequence_parallel=False, context_parallel=False)
    base = _moe_model(cfg=cfg)
    weights = {n: p.detach() for n, p in base.named_parameters()}
    del base
    want, choices = {}, None
    for dtype, steered in EXPERTS_LEGS:
        model = _mp8_model(LlamaConfig(**dict(cfg, dtype=dtype)), weights)
        opt = _fleet_optimizer(model)
        own = _steer_choices({str(i): blk.mlp for i, blk in
                              enumerate(model.llama.layers)}) \
            if steered else None
        want[dtype] = []
        for _ in range(EXPERTS_STEPS):
            opt.clear_grad()
            loss = model(*batch)
            loss.backward()
            opt.step()
            want[dtype].append(float(loss.detach()))
        if steered:
            choices = {k: torch.stack(c).cpu().numpy()
                       for k, c in own.items()}
        del model, opt
        _release()
    return want, choices


def _rank_27cde(root, lbfgs_batch, experts_batch, choices):
    """One of the four ranks that run 27c, 27d (ranks 0-2) and 27e in one
    spawn. The models' one-card weights are drawn first, before any
    hybrid group."""
    dist = _rank_setup(root)
    from paddle_tpu_torch.distributed.collective import Group

    def weights_of(model):
        return {n: p.detach() for n, p in model.named_parameters()}

    lbfgs_w = weights_of(_mp8_model(LlamaConfig(**LBFGS_CFG)))
    moe_w = weights_of(_moe_model(cfg=EXPERTS_SEP_MP))
    three = Group(ranks=[0, 1, 2], pg=torch.distributed.new_group([0, 1, 2]))
    rank = dist.get_rank()
    out = {"27c": _lbfgs_rank(lbfgs_w, *lbfgs_batch)}
    del lbfgs_w
    arrays = None
    if rank < 3:
        out["27d"], arrays = _margin_rank(three, rank)
    _release()
    out["27e"] = _experts_rank(moe_w, *experts_batch, choices)
    _save_rank(root, out, arrays)
    dist.destroy_process_group()


def _phase_27cde(card):
    """27c, 27d and 27e: one card's yardsticks, then one spawn of four
    ranks."""
    # 27c: LBFGS on one card
    lbfgs_batch = _train_batch(LBFGS_CFG["vocab_size"], LBFGS_BATCH,
                               LBFGS_SEQ, seed=5)
    model = _mp8_model(LlamaConfig(**LBFGS_CFG))
    t0 = time.perf_counter()
    want_c, want_calls = _lbfgs_run(model, model, *lbfgs_batch)
    one_s = time.perf_counter() - t0
    del model
    # 27d: margin CE on the whole logits
    x, w, label = _arcface_inputs()
    arc_loss, arc_sm, arc_grad = _margin_ce(x @ w, label)
    arc_sm, arc_grad = arc_sm.cpu().numpy(), arc_grad.cpu().numpy()
    del x, w
    # 27e: the MoE Llama on one card, the bf16 leg's choices recorded
    experts_batch = _train_batch(MOE["vocab_size"], TRAIN_BATCH, TRAIN_SEQ)
    want_e, choices = _experts_one_card(experts_batch)
    ranks, arrays, wall = _spawn_ranks(
        _rank_27cde, (tuple(t.cpu().numpy() for t in lbfgs_batch),
                      tuple(t.cpu().numpy() for t in experts_batch),
                      choices), n=4)
    log(f"[mp8] 27c, 27d, 27e: four ranks sharing {card} over gloo, spawn "
        f"to join {wall:.1f} s")
    # 27c
    lb = [dict(o["27c"], rank=o["rank"]) for o in ranks]
    diff = max(abs(a - b) for o in lb for a, b in zip(o["losses"], want_c))
    log(f"[mp8] 27c LBFGS ({LBFGS_KW}) on the Llama at hidden "
        f"{LBFGS_CFG['hidden_size']}, vocab {LBFGS_CFG['vocab_size']}, "
        f"{LBFGS_CFG['num_hidden_layers']} layers, fp32, b{LBFGS_BATCH} x "
        f"s{LBFGS_SEQ}: one card's losses {want_c} with {want_calls} "
        f"closure calls ({one_s:.1f} s); at dp 2 x mp 2 "
        + "; ".join(f"rank {o['rank']} {o['losses']}, {o['calls']} calls, "
                    f"peak {o['peak_gib']:.3f} GiB, {o['seconds']:.1f} s"
                    for o in lb)
        + f"; within {diff:.3e} (tol {LBFGS_LOSS_TOL})")
    if not diff <= LBFGS_LOSS_TOL:
        raise AssertionError(f"27c: LBFGS's losses left one card's by {diff}")
    if any(o["calls"] != lb[0]["calls"] for o in lb):
        raise AssertionError("27c: the ranks made other closure calls")
    if not want_c[-1] < want_c[0]:
        raise AssertionError(f"27c: LBFGS did not lower the loss: {want_c}")
    # 27d
    scale = float(np.abs(arc_grad).max())
    errs = []
    for o, a in zip(ranks[:3], arrays[:3]):
        lo = sum(ARC_SPLIT[:o["rank"]])
        cols = slice(lo, lo + ARC_SPLIT[o["rank"]])
        errs.append((abs(o["27d"]["loss"] - arc_loss) / abs(arc_loss),
                     float(np.abs(a["softmax"] - arc_sm[:, cols]).max()),
                     float(np.abs(a["grad"] - arc_grad[:, cols]).max())
                     / scale))
    log(f"[mp8] 27d margin_cross_entropy, ArcFace's head ({ARC['classes']} "
        f"classes, {ARC['dim']}-d, margins {ARC['margins'][:3]}, scale "
        f"{ARC['margins'][3]}, batch {ARC['batch']}, fp32) over 3 ranks "
        f"holding {[o['27d']['classes'] for o in ranks[:3]]} classes: one "
        f"card's loss {arc_loss:.6f}; each rank's (loss relative, softmax "
        f"abs, logit gradient over its max) error {errs} (tol "
        f"{ARC_LOSS_RTOL}, {ARC_SOFTMAX_ATOL}, {ARC_GRAD_TOL}); ms a call "
        f"{[round(o['27d']['ms'], 2) for o in ranks[:3]]} (gloo)")
    for e in errs:
        if not (e[0] <= ARC_LOSS_RTOL and e[1] <= ARC_SOFTMAX_ATOL
                and e[2] <= ARC_GRAD_TOL):
            raise AssertionError(f"27d: a rank left one card's: {errs}")
    # 27e
    for dtype, steered in EXPERTS_LEGS:
        ex = [dict(o["27e"][dtype], rank=o["rank"]) for o in ranks]
        for o in ex:
            log(f"[mp8] 27e {dtype} rank {o['rank']} (mp 2 x sep 2, SP, "
                f"ring; experts over (sep, mp): {o['experts']} of "
                f"{EXPERTS_SEP_MP['moe_num_experts']}): losses "
                f"{o['losses']}, tokens dispatched a layer "
                f"{o['dispatched']}, "
                + (f"own gate choices unlike one card's (handed over) a "
                   f"step {o['differ']}" if steered
                   else "its gates choosing for themselves")
                + f", launches "
                f"{ {k: v for k, v in o['launches'].items() if v} }, peak "
                f"{o['peak_gib']:.3f} GiB")
        log(f"[mp8] 27e {dtype} one card's losses {want_e[dtype]} "
            f"({EXPERTS_SEP_MP['num_hidden_layers']} layers)")
        _hold_losses(f"27e {dtype}", ex, want_e[dtype], EXPERTS_TOL_FIRST,
                     EXPERTS_TOL_LATER)
        for o in ex:
            if o["experts"] != EXPERTS_SEP_MP["moe_num_experts"] // 4 \
                    or not all(d > 0 for step in o["dispatched"]
                               for d in step):
                raise AssertionError(f"27e {dtype}: rank {o['rank']} held "
                                     f"{o['experts']} experts, dispatched "
                                     f"{o['dispatched']}")
            if not all(o["launches"][w.__name__] > 0
                       for w in FLASH_WRAPPERS):
                raise AssertionError(f"27e {dtype}: rank {o['rank']} "
                                     f"launched {o['launches']}")


def phase_mp8(card):
    """Phase 27 (A.6's model-parallel items): 27a the 0.44B Llama at mp 8
    with SP, padding and the vocab-parallel chunked CE, then decode in
    bf16 and fp32; 27b kernels 1-3 at a rank's 1 and 2 heads and 7-8 at
    1; 27c LBFGS at dp 2 x mp 2; 27d class-sharded margin CE over 3
    ranks; 27e experts over (sep, mp), bf16 steered and fp32 unsteered.
    Returns (27a's launches on a 1-head rank, 27b's rows)."""
    _release()
    rows = _phase_27b()
    launches = _phase_27a(card)
    _phase_27cde(card)
    return launches, rows


def _json_row(row):
    """A float16 row for the kernels line (the long paged shape left to
    the log), or None where the kernel has none (the class pass reads the
    fp32 mask only)."""
    return None if row is None else {k: v for k, v in row.items()
                                     if k != "long"}


def main():
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,"
                    "19,20,21,22,23,24,25,26,27",
                    help="phases to run after 1 and 2, comma-separated")
    ap.add_argument("--fault", choices=("experts", "dropout"),
                    help="plant a fault to show that a check catches it: "
                    "'experts' holds rank 1's experts at their first "
                    "values in phase 20b, 'dropout' hashes each rank's "
                    "own heads in phase 21b; the phase must then fail")
    ap.add_argument("--fp32-witness", action="store_true",
                    help="run phase 20b again in fp32 and print how far "
                    "the two ranks go from one card (a reading, not held)")
    args = ap.parse_args()
    only = {int(p) for p in args.phases.split(",")}
    name, smi = phase_device()
    phase_build()
    # the JSON line's launches are each kernel's main path's (kernels 4-6:
    # BERT's, phase 10); ERNIE's (phase 12) are printed beside them
    rows, launches, ernie_launches, graph = {}, {}, {}, {}
    fleet_launches, pipe_launches, context, experts = {}, {}, {}, {}
    hybrid, vision, ops, functional, layers_nn = {}, {}, {}, {}, {}
    namespace, fp16, mp8 = {}, {}, {}
    for n, run in ((3, lambda: rows.update(phase_kernels())),
                   (4, lambda: launches.update(phase_serve(name))),
                   (5, phase_identity),
                   (6, lambda: rows.update(
                       phase_flash(TRAIN["num_hidden_layers"]))),
                   (7, lambda: launches.update(phase_train(name))),
                   (8, phase_train_identity),
                   (9, lambda: rows.update(phase_encoder_kernels(
                       BertConfig().num_hidden_layers))),
                   (10, lambda: launches.update(phase_bert_train(name))),
                   (11, phase_bert_identity),
                   (12, lambda: ernie_launches.update(
                       phase_ernie_train(name))),
                   (13, phase_ernie_identity),
                   (14, lambda: graph.update(phase_train_graphs(name))),
                   (15, lambda: fp16.update(zip(
                       ("launches", "rows"), phase_o1_fp16(name, smi)))),
                   (16, lambda: phase_fit(name, graph.get("graph_ms",
                                                          float("nan")))),
                   (17, lambda: fleet_launches.update(
                       phase_distributed(name))),
                   (18, lambda: pipe_launches.update(phase_pipeline(name))),
                   (19, lambda: context.update(zip(
                       ("launches", "rows"), phase_context(name)))),
                   (20, lambda: experts.update(phase_experts(
                       name, args.fault == "experts",
                       args.fp32_witness))),
                   (21, lambda: hybrid.update(phase_hybrid(
                       name, args.fault == "dropout"))),
                   (22, lambda: vision.update(phase_vision(name))),
                   (23, lambda: ops.update(phase_tensor_ops(name))),
                   (24, lambda: functional.update(
                       phase_functional(name, smi))),
                   (25, lambda: layers_nn.update(phase_nn(name, smi))),
                   (26, lambda: namespace.update(
                       phase_namespace(name, smi))),
                   (27, lambda: mp8.update(zip(
                       ("launches", "rows"), phase_mp8(name))))):
        if n in only:
            t_run = time.perf_counter()
            run()
            log(f"[phase {n}] passed in {time.perf_counter() - t_run:.1f} s")
    _no_reference("the run")
    if only != set(range(3, 28)):
        log(f"[done] phases 1, 2 and {sorted(only)} passed in "
            f"{time.perf_counter() - t0:.1f} s on {smi}")
        return 0
    pallas = "paddle_tpu/ops/pallas/"
    flash_cu = "paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu"
    sources = {"paged": "paddle_tpu_torch/ops/cuda/csrc/paged_attention.cu",
               "flash": flash_cu, "hb": flash_cu}
    replaces = {"paged_attend": pallas + "paged_attention.py:51",
                "paged_attend_int8": pallas + "paged_attention.py:170",
                "flash_fwd": pallas + "flash_attention.py:129",
                "flash_bwd_dq": pallas + "flash_attention.py:201",
                "flash_bwd_dkv": pallas + "flash_attention.py:257",
                "hb_fwd": pallas + "head_flash.py:57",
                "hb_bwd_dq": pallas + "head_flash.py:134",
                "hb_bwd_dkv": pallas + "head_flash.py:190"}
    # beside the main path's: each kernel's launches on one rank of the
    # hybrid phase (kernels 1-3 and 7-8 on 21a's rank 0, 4-6 on 21b's)
    on_hybrid = dict(hybrid["21a"], **{k: hybrid["21b"][k]
                                       for k in ("hb_fwd", "hb_bwd_dq",
                                                 "hb_bwd_dkv")})
    # and each kernel's launches over phase 24c's two F.flash_attention
    # calls (kernels 1-3 at the Llama's shape, 4-6 at BERT's)
    on_functional = {k: sum(c.get(k, 0) for c in
                            functional["launches"].values())
                     for k in replaces}
    # and each kernel's launches over phase 26b's fit through the top-level
    # names (the tile rows below carry theirs), its float16 launches over
    # phase 15's training steps (15a-15c) and its float16 row (phase 15;
    # kernels 1-3 at the headline shape, 4-6 at BERT's, 7-8 at the served
    # geometry)
    kernels = [dict(name=k, route="cuda", source=sources[k.split("_")[0]],
                    replaces=replaces[k], launches=launches[k], **rows[k],
                    launches_phase21=on_hybrid[k],
                    launches_phase24=on_functional[k],
                    launches_phase26=namespace["launches"].get(k, 0),
                    launches_phase15_fp16=fp16["launches"].get(k, 0),
                    launches_phase23c=sum(ops["launches_23c"][t].get(k, 0)
                                          for t in ("bf16", "int8")),
                    launches_phase27a=mp8["launches"].get(k, 0),
                    **mp8["rows"].get(k, {}),
                    fp16=_json_row(fp16["rows"].get(k)))
               for k in replaces]
    # the tile mode of kernels 1-3 (a mode of the TPU's kernels 1-3 for
    # the masks the reference sends to its composite,
    # flash_attention.py:633-641), its launches on phase 25a's
    # Transformer-base steps; the class pass, run with the forward, serves
    # kernels 1-3 (their dead-cell skip)
    kernels += [dict(name=k, route="cuda", source=flash_cu,
                     replaces=replaces[k[:-len("_tile")]
                                       if k.endswith("_tile")
                                       else "flash_fwd"],
                     launches=layers_nn["launches"][k],
                     launches_phase26=namespace["launches"][k],
                     launches_phase15_fp16=fp16["launches"].get(k, 0),
                     fp16=_json_row(fp16["rows"].get(k)),
                     **layers_nn["rows"][k])
                for k in TILE_NAMES]
    log(f"[done] launches on the ERNIE path (phase 12, "
        f"{TIMED_STEPS} steps): {ernie_launches}")
    log(f"[done] launches of kernels 1-3 at 6 heads a rank (phase 17c, "
        f"mp 2, {FLEET_STEPS} steps, each rank): {fleet_launches}")
    log(f"[done] launches on ERNIE's pipe at pp 2 (phase 18c, rank 0, "
        f"{ERNIE_PIPE_STEPS} steps): {pipe_launches}")
    log(f"[done] kernel 1's launches a rank over {FLEET_STEPS} steps at sep "
        f"2 (phase 19b; kernels 2 and 3 alike): "
        + ", ".join(f"{m} rank {r} {n}" for (m, r), n
                    in context["launches"].items()))
    log(f"[done] the ring's block calls at b8 s512 h12 d128 (phase 19b): "
        + json.dumps(context["rows"]))
    log(f"[done] launches of kernels 1-3 on the MoE Llama (phase 20a, "
        f"{MOE_STEPS} replays): {experts['20a']}; a rank at dp 2 (20b, "
        f"{FLEET_STEPS} steps): {experts['20b']}; a ZeRO p_g_os rank (20c, "
        f"{ZERO_STEPS} steps): {experts['20c']}; a rank at mp 2 x "
        f"sharding 2 (20e, 6 heads, {ZERO_STEPS} steps a level): "
        f"{experts['20e']['os_g']} (os_g), {experts['20e']['p_g_os']} "
        f"(p_g_os); the MoE Llama at dp 2 x sharding 2 (20e, "
        f"{MOE_SHARDING['num_hidden_layers']} layers, experts over "
        f"sharding, {ZERO_STEPS} steps): {experts['20e']['moe']}")
    log(f"[done] launches a rank on the hybrid phase (21, each kernel's "
        f"per rank over its run): "
        + "; ".join(f"{k} {v}" for k, v in hybrid.items()))
    log(f"[done] ResNet-50 b{RESNET_BATCH} bf16 O2 on graphs (phase 22a): "
        + "; ".join(f"{fmt} {r['ms']:.2f} ms a step, {r['ips']:.1f} imgs/s, "
                    f"MFU {r['mfu']:.4f}, peak {r['peak']:.2f} GiB"
                    for fmt, r in vision.items()))
    log(f"[done] the tensor op surface (phase 23a): {ops['held']} rows held "
        f"on the card against the CPU, worst error by module "
        f"{ops['worst']}; the sharded decode's launches on rank 0 (23c): "
        f"{ops['launches_23c']}")
    log(f"[done] the nn.functional surface (phase 24a): "
        f"{functional['held']} rows held on the card against the CPU, "
        f"worst error by module {functional['worst']}; 24c launches "
        f"{functional['launches']}")
    log(f"[done] the nn layer surface (phase 25): Transformer-base "
        f"{layers_nn['ms']:.2f} ms a step, {layers_nn['tok_s']:.0f} tokens/s, "
        f"peak {layers_nn['peak']:.2f} GiB, cached decode "
        f"{layers_nn['decode_ms']:.2f} ms a step; LSTM 2 x bidirect "
        f"{layers_nn['lstm_ms']:.2f} ms forward + backward")
    log(f"[done] the top-level namespace (phase 26): Transformer-base "
        f"through paddle.Model.fit {namespace['ms']:.2f} ms a step; the "
        f"PyLayer's launches {namespace['pylayer']}, worst per-tile error "
        f"{namespace['pylayer_err']:.3e}")
    log(f"[done] A.6's model-parallel items (phase 27): launches on a "
        f"1-head rank of 27a (mp 8, {MP8_STEPS} steps, then decode): "
        f"{mp8['launches']}")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
