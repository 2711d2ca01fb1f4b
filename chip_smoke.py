#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels from ``src/repro_torch/csrc`` with
nvcc, holds each against its plain PyTorch version at the serving paths'
shapes (K1, K2 and K3 at smollm-360m's heads and at gemma3-4b-edge's,
head width 256; K1 and K3 at jamba-v0.1-52b's, 32 query heads over 8 KV
heads of width 128, K3 also at exact prompt lengths 1..129 with NaN
rows past the keys' end; K1 and K3 at musicgen-large's, 32 over 32 of
width 64, and llama-3.2-vision-90b's, 64 over 8 of width 128; K3
non-causal at Sq 1, 16 and 45 over the vision stack's 1024 image rows
and K1 at t = 1023 over its image cache; K1, K2 and K3 at gemma-2b's
8 over 1 KV head of width 256, K2 at qwen3-32b's 64 over 8 of width
128, K1 and K3 at llama4-maverick's 40 over 8 of width 128, K3 also at
exact lengths, K2 at granite-8b's 32 over 8 of width 128 (its K1 and K3
are jamba's), K1 and K3 at dbrx-132b's 48 over 8 of width 128, K1 also
with (B,) fill levels and K3 also at exact lengths) and times both, each
kernel in
turns with SDPA (kernel, SDPA, kernel) and, at head widths 128 and 256,
once more with the L2 flushed (``[build] ptxas`` lines give those
instances' registers and spills); K4 and K5 also on the 120-round
ensemble that the launch CLIs train, at their burst (B 100) and
admission (B 1) shapes.  Then, at the full width of smollm-360m (bf16,
seeded random weights), it drives each serving path through the entry
points a user calls, with the launch counters set to 0 just before each
path and read just after:

* ``[slice]`` the paper's head-of-line burst (6 long requests, then 10
  short) through predictor -> SJF queue -> the serial ``RealEngine``,
  under FCFS and then SJF;
* ``[lanes]`` the paging benchmark's backlog (benchmarks/paging_bench.py:
  4 lanes, page 16, max_len 128, pattern LLSSSSLSSLSS, a budget of two
  worst-case longs) through ``BatchedRealEngine``, through
  ``PagedBatchedEngine`` (growth and preemption), and with a shared
  48-token prefix cold then warm (prefix hits take K3's extend mode);
  a float32 copy with TF32 off holds ring lanes, paged lanes, the serial
  engine and the warm pass to the same tokens;
* ``[paged-burst]`` the burst again through ``ClairvoyantServer`` with
  one ``PagedBatchedEngine``, under FCFS and SJF;
* ``[sidecar]`` the burst over HTTP through the port's ``Sidecar``
  (``127.0.0.1:0``) in front of one ``InProcessBackend(RealEngine)``,
  under FCFS and then SJF, half the requests as SSE streams: every
  admission scores one row through the packed ensemble (K5); then a
  client disconnect, a deadline shed, a ``/metrics`` scrape and a
  graceful shutdown under load;
* ``[preempt]`` the burst longs first through the serial engine under
  ``srpt``: a short evicts the decoding long at a segment boundary and
  the long resumes by re-prefill (float32 with TF32 off: the resumed
  tokens equal an uninterrupted decode's; bf16: the agreement printed);
* ``[lanes-faults]`` the paging backlog through ring and paged lanes
  under a fault plan (a lane crash, a transient that the lane drain
  leaves unfired, as the JAX one does, a whole-engine crash) and a
  sojourn deadline: one terminal status per request, none lost;
* ``[launch-serve]`` ``repro_torch.launch.serve`` (virtual-time replicas
  on the gemma3-4b-edge service model; the burst scored by K5) under
  fcfs, sjf and srpt, and sjf at rho 0.74 (in the second side process,
  after gemma-2b's paths; its launches count among smollm-360m's);
* ``[sweep]`` the paper's grids through ``core.sweep``: Fig. 3's
  (fcfs / sjf x 5 rhos x 5 seeds, n 2,000) and Table 8's burst with the
  grid DES on the card (``backend="torch"``) and on the host, and a grid
  mixing srpt rows (host preemptive engine) with key-based rows;
* ``[ranking]`` the ranking metric (Algorithm 1) on a held-out sample,
  scored in one batch through the packed layout (K5, the predictor's
  entry point), the dense layout (K4) and the plain walk;
* ``[speculative]`` draft-verify decode (K=4) in float32 and bf16: the
  burst's prompts through the serial engine with an agreeing and an
  independent draft, and the paging backlog through speculative ring and
  paged lanes;
* ``[tp]`` tensor parallelism: gemma3-4b-edge's train step over a
  ("data", "model") = (1, 2) mesh as two child processes on the one card
  (``python3 chip_smoke.py --tp-rank R FILE``, a gloo group of their own:
  NCCL refuses two ranks on one device), started after the kernel phases
  and run beside the smollm phases from ``[reference]`` to
  ``[lanes-faults]``: (c) a float32 copy at full width cut to 2 layers,
  2 AdamW steps within 1e-4 relative (loss, gradient norm) and atol 5e-4,
  rtol 5e-3 (each rank's parameter blocks) of the single-device step;
  (b) all 34 layers in bf16, 3 AdamW steps at B 2 x 512 (ms a step,
  peak memory a rank, the all-reduces over ``model`` a step and their
  bytes equal to ``roofline.tensor_parallel_bytes``, K3 2 x 34 and K3b
  34 launches a step at H 4 over KV 2, the loss falling); (d)
  smollm-360m in float32 at full width, all 32 layers, its 15 query
  heads over 5 KV heads cut across the ranks (the projections gathered
  whole, every rank attending every head), 2 AdamW steps within 1e-5
  relative (loss, gradient norm) of the single-device step; (e)
  dbrx-132b at full width cut to one ``attn_moe`` layer (48 over 8
  heads at hd 128, 16 experts of d_ff 10752 top-4, vocabulary 100,352)
  in bf16, 3 AdamW steps at B 2 x 512 over the MoE's all-to-all (ms a
  step, peak memory a rank, the collectives over ``model`` by kind equal
  to the roofline's count, K3 2 and K3b 1 launches a step, finite
  losses); after the ranks exit, in this process, (a) a 2-layer bf16
  copy's step through a one-rank (1, 1) mesh bitwise equal to the step
  with no mesh, (b) the single-device loss of gemma3's bf16 weights on
  the first batch within 2e-2 relative of the ranks' first loss and (e)
  dbrx's one-device loss, routed in the ranks' two dispatch groups
  under a shape-only (1, 2) mesh, within 1e-3 relative of theirs, with
  the share of (token, choice) pairs routed to another expert (K3 and
  K3b at the ranks' shapes are held and timed among the kernel phases:
  ``*_hd256_tp``, ``*_hd128_g6_tp``, ``*_hd128_g8_tp``,
  ``*_vision_cross_tp``, ``*_musicgen_tp``); then in the ranks the
  recurrent
  stacks, none of which launches K3 or K3b: (f) jamba-v0.1-52b in
  float32 at full width cut to its first layer (Mamba, d_inner 8192 a
  rank's 4096 channels, its in_proj block all of x or all of z), 2 AdamW
  steps held to the single-device step within 1e-5 relative; (g) its
  first two layers (Mamba, Mamba + MoE of 16 experts, 8 a rank) in bf16,
  3 AdamW steps at B 2 x 512 (ms a step, peak memory a rank, collectives
  by kind equal to the roofline's count, finite losses; in this process
  after the ranks exit, one device's loss in the same two dispatch
  groups within 1e-3 relative); (h) xlstm-350m in float32 at full
  width cut to 4 of its 24 layers (two sLSTM, two mLSTM; 4 heads of 256,
  2 a rank), 2 AdamW steps at B 2 x 128 held to the single-device step
  within 1e-5 relative.  Every part at S 512 (and (h) at S 128) runs
  with the residual stream split by positions over model 2 (``seq_sp``);
  (e′)'s S 511 keeps it whole.  After (b), one forward of its loss under
  the default rules and under ``seq_sp: ()`` counts the activations
  saved for the backward: the blocks' inputs halve.  (e′)
  dbrx's layer, from the same initial weights, one step at B 1 x 511:
  its tokens route in one dispatch group, fewer than the ranks, so
  every rank routes it and runs its own 8 experts over its slots (the
  experts' outputs all-gathered, no all-to-all), held in this process to
  one device routing the same group within 1e-3 relative, the ranks'
  routes equal.  A late pair of ranks (``--tp-rank R FILE late``),
  started once ``[launch-train]``'s gemma3 child has ended and run
  beside the rest of ``[speculative]``: (j) musicgen-large (frames in,
  the 2048-way head split) in float32 cut to 2 layers and (i) a stack of
  llama-3.2-vision-90b's cross-attention layer alone in float32
  (Adafactor; the ranks' single-device steps one after the other), each
  within 1e-5 relative of the single-device step; then (i)
  llama-3.2-vision-90b cut to one pattern repeat (4 attention layers of
  64 over 8 heads at hd 128 and the cross-attention layer over 1024
  image rows, vocabulary 128,256; Adafactor) and (j) all 48 layers of
  musicgen-large (AdamW) in bf16, 3 steps each at B 2 x 512 (ms a step,
  peak memory a rank, collectives equal to the roofline's count, K3 2 x
  and K3b 1 x the self- and cross-attention layers, the cross-attention
  ones counted apart), each held in this process to the single-device
  loss within 2e-2 relative.  Once the late pair has exited, (k) on
  eight ranks (``--tp-rank R FILE apart``) beside the rest of
  ``[speculative]`` and the phases up to ``[mesh]``: xlstm-350m at full
  width cut to its first two layers (sLSTM, mLSTM) in float32 over
  (1, 8), its 4 heads of 256 across the ranks (128 ``qkv`` columns a
  rank: the split projections gathered whole), 2 AdamW steps at B 2 x
  128 held by rank 0 to the single-device step within 1e-5 relative on
  the ranks' whole parameters, each step's collectives equal to the
  roofline's count on every rank;
* ``[launch-sidecar]`` ``python -m repro_torch.launch.sidecar --port 0``
  as child processes, the full-width real backend beside the sim
  backend, under fcfs and then sjf, and the real backend with
  ``--speculative`` under sjf: the burst over HTTP, then SIGTERM; its
  client runs on a thread beside ``[speculative]``;
* ``[train]`` training: a float32 2-layer copy's gradients through K3
  (with its log-sum-exp) and K3b against the plain attention, then 20
  AdamW steps of all 32 layers in bf16 on the Markov stream through
  ``make_train_step`` (K3 2 x 32 and K3b 32 launches a step);
* ``[launch-train]`` ``python -m repro_torch.launch.train`` as child
  processes (each on ``make_local_mesh``'s one-rank NCCL group), started
  before ``[speculative]`` and run beside it: 6 steps straight beside 3
  steps in a second process, then a resumed 3 from the latter's
  checkpoint, with equal losses, and gemma3-4b-edge for 3 steps (all 34
  layers, K3b at head width 256);
* ``[mesh]`` the sharding layer on ``[train]``'s state: one step through
  ``make_train_step(mesh=)`` bitwise equal to the step with no mesh
  (same K3/K3b launches), the int8 gradient exchange
  (``apply_error_feedback``, ``compressed_psum_mean``) over NCCL bitwise
  equal to the CPU's over gloo, with its bytes against a float32
  all-reduce's, ``resume_on_mesh`` of ``[launch-train]``'s checkpoint
  bitwise equal to ``checkpoint.restore``, and the step's roofline
  (FLOPs counted on meta tensors, ``model_flops``, the compute and memory
  bounds at the H100's peaks, device and wall ms, the bf16-peak share);
* then the paper's own backend, gemma3-4b-edge (8 query heads over 4 KV
  heads of width 256, GeGLU, vocab 262,144), once the card is freed:
  ``[gemma3-f32]`` a float32 copy cut to 2 layers at full width against
  the CPU's plain path (prefill logits, 8 greedy steps), and its ring
  lanes == paged lanes == serial engine; then all 34 layers in bf16
  (3.88 B seeded parameters): ``[gemma3-slice]`` the burst through the
  serial engine (FCFS, SJF) with TTFT, ms/token beside the service-time
  model's price, kernels a token and the busy share, ``[gemma3-sidecar]``
  the burst over HTTP, ``[gemma3-lanes]`` the paging backlog through ring
  and paged lanes and the shared prefix cold then warm.  Every serial
  request launches K3 once a layer and K1 once a layer a decode step,
  every lane step K1 or K2 once a layer, exactly.  Then training:
  ``[gemma3-train-f32]`` a float32 2-layer copy's gradients through
  K3/K3b (head width 256) against the plain attention's, and
  ``[gemma3-train]`` all 34 layers in bf16, 10 AdamW steps at B 4 x 512
  through ``make_train_step`` (K3 2 x 34 and K3b 34 launches a step, the
  loss falling, one step profiled);
* then jamba-v0.1-52b (Mamba, MoE with 16 experts top-2, and attention
  in an 8-block pattern), once the card is freed, at full width and one
  of its four pattern repeats (the whole model, 95.8 GiB in bf16, does
  not fit the card; a second repeat would not fit the run's time limit
  beside the last three archs): ``[jamba-f32]`` a float32 copy (8
  layers, 13.27 B parameters), prefill logits and 8 greedy steps
  through K1/K3 against the plain attention on the card, and ring lanes
  through the kernels against ring lanes through the plain attention
  (MoE capacity is shared by a step's tokens, so lanes are held to
  lanes, not to the serial engine); then the 8 layers in bf16 (13.27 B
  seeded parameters): ``[jamba-slice]`` the burst (its longs cut to 32
  new tokens) through the serial engine (exact-length prefill, FCFS and
  SJF) with TTFT and ms/token beside the weight stream and the
  service-time model's price, ``[jamba-profile]``, ``[jamba-sidecar]``
  the burst over HTTP, and ``[jamba-lanes]`` the paging backlog through
  ring lanes, after the block-paged engine and speculative engines
  refuse the stack.  Every
  jamba prefill launches K3 once an attention layer (1), every step K1
  once an attention layer, exactly;
* then the last three architectures, each once the card is freed:
  xlstm-350m (alternating sLSTM and mLSTM blocks, no attention layer):
  ``[xlstm-f32]`` a float32 one-repeat copy (2 layers) on the card
  against the CPU (logits, 8 greedy tokens) and its ring lanes against
  the serial engine; then all 24 layers in bf16: ``[xlstm-slice]`` (the
  burst through the serial engine at exact-length prefill, longs of 32
  new tokens, plus ``[xlstm-profile]``), ``[xlstm-sidecar]`` and
  ``[xlstm-lanes]`` (ring lanes; paged and speculative engines refuse),
  with no K1/K2/K3 launch and K5 once a burst / an admission;
  musicgen-large (the audio frontend: frame embeddings in, one query
  head a KV head): ``[musicgen-f32]`` 2 layers in float32, K1/K3 against
  the plain attention and prefill + teacher-forced decode against the
  training forward, then ``[musicgen]`` all 48 layers in bf16 through
  ``LM.prefill``/``decode_step`` (45 seeded frames, 32 teacher-forced
  steps); llama-3.2-vision-90b cut to one of its 20 pattern repeats (4
  self-attention and 1 cross-attention layers; the whole model does not
  fit the card): ``[vision-f32]`` those 5 layers in float32 against the
  plain attention, then ``[vision]`` in bf16 (1024 seeded image rows, a
  45-token prompt, 32 greedy steps).  Every prefill there launches K3
  once a layer (non-causal in the cross-attention layer) and every step
  K1 once a layer (at t = 1023 over the image cache), exactly.  Each
  float32 copy's loss gradients are then held to the plain attention's
  (``[musicgen-train-f32]``, ``[vision-train-f32]``: the cross-attention
  layer's backward is K3b's full attention at Sq 512 over Skv 1024), and
  each bf16 model is trained in place through ``make_train_step``
  (``[musicgen-train]`` AdamW on seeded frames, ``[vision-train]``
  Adafactor on seeded image embeddings), K3 twice and K3b once an
  attention layer a step, the cross-attention ones counted apart;
* gemma-2b whole (18 layers of 8 query heads over 1 KV head of width
  256, GeGLU, the tied 256,000-row head), in a second side process
  (``python3 chip_smoke.py --second-side-paths``, then ``[launch-serve]``)
  beside the first:
  ``[gemma2b-f32]`` a float32 copy cut to 2 layers against the CPU's
  plain path and its ring lanes == paged lanes == serial engine, then in
  bf16 ``[gemma2b-slice]`` (the burst, FCFS and SJF, with the profile),
  ``[gemma2b-sidecar]`` and ``[gemma2b-lanes]`` (the paging backlog
  through ring and paged lanes, the shared prefix cold then warm);
* granite-8b whole (36 layers of 32 query heads over 8 KV heads of width
  128, SwiGLU, an untied 49,152-row head; 15.38 GiB in bf16), in a
  child process of its own (``python3 chip_smoke.py --granite-paths``)
  started when ``[tp]``'s late pair exits, beside (k), the end of
  ``[speculative]``, ``[train]`` and ``[mesh]``, and waited for before
  the last archs' kernel phases: ``[granite-f32]`` a float32 copy cut
  to 2 layers against the CPU's plain path and its ring lanes == paged
  lanes == serial engine, then in bf16 ``[granite-slice]`` (the
  burst, FCFS and SJF, with the profile),
  ``[granite-sidecar]`` and ``[granite-lanes]`` (ring and paged lanes,
  K2 at hd 128 G 4, the shared prefix cold then warm);
* gemma-2b trained, after ``[gemma3-train]``: ``[gemma2b-train-f32]``
  a float32 2-layer copy's gradients through K3 (with its log-sum-exp)
  and K3b at 8 over 1 KV head of width 256 against the plain
  attention's, and ``[gemma2b-train]`` all 18 layers in bf16, 10 AdamW
  steps at B 4 x 512 through ``make_train_step`` (K3 2 x 18 and K3b 18
  launches a step, the loss falling, one step profiled);
* once every child has ended, qwen3-32b whole (64 layers, 64 query heads
  over 8 KV heads of width 128 with QK-norm, 61.02 GiB of bf16 weights)
  with the card to itself, one engine at a time: ``[qwen3-f32]`` 2
  layers in float32 against the CPU and through ring lanes == paged
  lanes == serial, ``[qwen3-slice]`` the 64 layers on a smaller burst (2
  longs of 24 new tokens, 4 shorts of 4) under FCFS and SJF with fused
  decode == the per-token oracle over 16 tokens, ``[qwen3-profile]``,
  ``[qwen3-sidecar]`` the burst over HTTP under SJF, ``[qwen3-paged]``
  the block-paged pool with a shared prefix, drained clean; then
  llama4-maverick-400b-a17b cut to one of its 24 pattern repeats
  (attention + dense FFN, attention + 128 experts top-1; the whole
  model, 735 GiB in bf16, does not fit the card): ``[llama4-f32]`` the
  repeat in float32 (68.6 GiB) through K1/K3 against the plain attention
  on the card, serial and ring lanes, then in bf16 ``[llama4-slice]``,
  ``[llama4-sidecar]`` (SJF) and ``[llama4-lanes]`` after the paged and
  speculative engines refuse the stack; then dbrx-132b cut to 8 of its
  40 layers (48 query heads over 8 KV heads of width 128, 16 experts
  top-4 on every layer; 50.86 GiB in bf16: the whole model, 245 GiB,
  does not fit the card): ``[dbrx-f32]`` one layer in float32 (16.7
  GiB) through K1/K3 against the plain attention on the card, serial
  and ring lanes, then the 8 layers in bf16: ``[dbrx-slice]`` (the
  burst of qwen3's paths, exact-length prefill; ms/token beside the
  54.6 GB stream of every expert's weights, the peak memory),
  ``[dbrx-sidecar]`` (SJF) and ``[dbrx-lanes]`` after the paged and
  speculative engines refuse the stack;
* ``[examples]`` beside those trained stacks, in a child process of its
  own (``python3 chip_smoke.py --examples``): the six ``examples_torch/``
  scripts through their ``main(["--device", "cuda"])`` as a user runs
  them (quickstart, multireplica_routing, batched_serve,
  speculative_serve, serve_sidecar in process and with ``--http``,
  train_lm at its defaults and with ``--full --steps 60``: all 32 smollm
  layers trained and checkpointed), the launch counters reset before
  each and read after, their printed claims checked, and one line of
  each script's wall seconds, launches and peak card memory.

Before the paths, ``[K3b flash_attention_bwd]`` holds the attention
backward kernel to its plain version (and K3's log-sum-exp to the plain
logsumexp), prints each of its kernels' registers and spills, and holds
it to its plain version and times it beside autograd's SDPA backward at
B 8, S 128, 512 and 1000, pass by pass at the training shape; then
``[K3b flash_attention_bwd_*]`` does the same for the other trained
stacks' instances at their train steps' shapes: head width 256
(gemma3-4b-edge), full attention at Sq 512 over Skv 1024 and causal at
H 64 over KV 8 (llama-3.2-vision-90b), G 1 (musicgen-large), H 8 over KV
1 at head width 256 (gemma-2b, with K3's log-sum-exp there), H 4 over
KV 2 at head width 256 (a ``[tp]`` rank's share of gemma3's heads, B 2),
H 24 over KV 4 at head width 128 (dbrx-132b's share, G 6), H 32 over KV
4 at head width 128 causal and full over 1024 image rows
(llama-3.2-vision-90b's shares) and H 16 over KV 16 at head width 64
(musicgen-large's), beside ``[K3 flash_attention_*_tp]``, K3 with its
log-sum-exp at those
shapes.

It fails (nonzero exit, no result line) without a CUDA device, without
the repository beside it, when a kernel does not build, launch or agree
with its plain version, when a response is not ``ok``, when tokens that
must agree do not, or when a kernel of a path was never launched on it
(and when the paged path launches the ring kernel K1, or a predictor
path launches the dense kernel K4 instead of the packed K5), when a
path's K1, K2 or K3 launches differ from its prefills and decode steps
times its attention layers, when a request is lost or ends twice, when
SJF's short P50 is not below FCFS's in process, over the wire or on the
launch CLIs, when a sidecar child does not drain and exit 0, when a
sweep metric differs between the card and the host or an srpt row runs
on the card, when the ranking metrics differ between K5, K4 and the
plain walk, when a float32 speculative stream differs from plain decode or
its kernel launches differ from the rounds' count, or when the
speculative child reports no accept rate, when K3 at an exact length
reads a key past its end, when jamba's kernels-vs-plain logits, tokens
or lane tokens differ, when the paged or a speculative engine builds a
jamba stack instead of refusing it, when a K3b gradient or K3's
log-sum-exp disagrees with its plain version, when the training loss
does not fall or the train step's K3/K3b launches differ from 2 x 32 /
32 a step, when a K3b pass is among the profiled train step's two
longest kernels, when a resumed training run's losses differ from
the straight run's, when a trained stack's float32 gradients through
K3/K3b differ from the plain attention's by more than 1e-4 of
max|plain|, its bf16 losses are not finite (gemma3's: do not fall) or
its K3/K3b launches differ from 2 x / 1 x its attention layers a step,
when a ``[tp]`` rank fails, its float32 copies leave the single-device
step's tolerances, its collectives differ from the roofline's count, its
K3/K3b launches from 2 x / 1 x the attention layers a step, its two
ranks' losses differ, gemma3's do not fall or dbrx's or jamba's are not
finite, the (1, 1) step is not bitwise the plain one, gemma3's, vision's
or musicgen's first loss is not within 2e-2 of the single device's or
dbrx's (both batches) or jamba's within 1e-3,
when the gemma3 train CLI child fails, when the meshed train step, the card's int8
exchange or the resharded checkpoint is not bitwise equal to its
reference (the step with no mesh, the CPU's exchange,
``checkpoint.restore``) or the meshed step's K3/K3b launches differ, when an xlstm path launches an attention kernel or
its card and CPU logits, tokens or lane tokens differ, when the
musicgen or vision kernels-vs-plain logits or tokens differ or their
launches are not exactly a layer's, when gemma-2b's, granite-8b's,
qwen3-32b's, llama4's or dbrx-132b's float32 holds, bitwise contracts
or exact launches fail, the
paged pool does not drain clean or its warm pass hits no prefix page,
when two kernels-line entries
share a name, or when an example script raises, its printed claim does
not hold (ranking accuracy inside 62–96%, SJF's short P50 below FCFS's,
both drafts bitwise equal, token counts equal across budgets, 100 of
100 served, 80 of 80 drained, train_lm's loss falling at its defaults
and finite at full width), a scoring script does not launch K5 or
launches K4, a decoding script's K3 / K1 launches differ from its
prefills / decode and verify positions times its attention layers, a
train_lm run's K3 / K3b launches differ from 2 x / 1 x its layers a
step, or its final checkpoint is missing.  The examples' launches are
on the ``[examples]`` line, not in the kernels line.

The second-to-last line of standard output is a JSON object with one
entry per kernel, each with the launches of its own model's paths (K1,
K2 and K3 at head width 64 and K3b, K4, K5: smollm-360m; ``*_hd256``:
gemma3-4b-edge; ``*_hd128``: jamba-v0.1-52b; ``*_musicgen``:
musicgen-large; ``*_vision``: llama-3.2-vision-90b's self-attention
and qwen3-32b's (the same heads) and ``*_vision_cross`` its
cross-attention, K3b's among them; ``*_gemma2b``: gemma-2b;
``*_qwen3``: qwen3-32b's K2; ``*_llama4``: llama4-maverick-400b-a17b;
``*_hd128`` K1/K3 also granite-8b's and ``*_granite`` its K2;
``*_dbrx``: dbrx-132b; ``flash_attention_bwd_gemma2b``: gemma-2b's
training;
``*_hd256_tp``: both ``[tp]`` ranks' gemma3 bf16 steps;
``*_hd128_g6_tp``: their dbrx steps; ``*_hd128_g8_tp`` and
``*_vision_cross_tp``: the late pair's vision bf16 steps (self- and
cross-attention apart); ``*_musicgen_tp``: its musicgen bf16 steps; the
ranks' smollm float32 steps count among smollm-360m's); the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

def print(*args, sep=" ", end="\n", file=None):  # noqa: A001
    """The builtin's output in a single write: phases and children's
    readers print side by side on threads, and a line written in pieces
    could be split by another's."""
    (file or sys.stdout).write(sep.join(map(str, args)) + end)


ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.monotonic()
sys.path.insert(0, os.path.join(ROOT, "src"))

# the H100 SXM data sheet's HBM rate and dense bf16 / float32 peaks
from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS  # noqa: E402
L2_FLUSH_BYTES = 128 << 20          # written to flush the H100's 50 MB L2
MAX_LEN, SEGMENT, MAX_NEW = 512, 16, 64
N_LONG, N_SHORT = 6, 10
TOL = {"bf16": 2e-2, "f32": 1e-4}
# the paging benchmark's settings (benchmarks/paging_bench.py:37-45, 60)
L_MAX_LEN, L_SEGMENT, L_LANES, L_PAGE = 128, 8, 4, 16
L_PROMPT, L_LONG, L_SHORT, L_PREFIX = 16, 96, 12, 48
PATTERN = "LLSSSSLSSLSS"
# [lanes-faults]: a long's sojourn deadline, far below its ~96 lane
# steps at full width
FAULT_DEADLINE_S = 1.0
# (H, KV, hd) of the served models' attention
SMOLLM_HEADS, GEMMA_HEADS, JAMBA_HEADS = (15, 5, 64), (8, 4, 256), (32, 8, 128)
MUSICGEN_HEADS, VISION_HEADS = (32, 32, 64), (64, 8, 128)
# musicgen-large and llama-3.2-vision-90b run through LM.prefill /
# decode_step: a 45-position prompt, 32 decode steps, B 1; the vision
# stack attends 1024 seeded image rows and is cut to one of its 20
# pattern repeats (4 self-attention + 1 cross-attention layers: the
# whole model, 163 GiB in bf16, does not fit the card); their float32
# copies take LM_F32_STEPS decode steps
LM_PROMPT, LM_STEPS, IMAGE_ROWS = 45, 32, 1024
LM_F32_STEPS = 8
# K3's exact prompt lengths (a stack with Mamba or MoE blocks prefills
# unbucketed)
EXACT_S = (1, 7, 23, 45, 129)
# the jamba bursts' long budget: half the other models' (the whole run must
# stay inside its time limit); widths, depth and the 8-token shorts as theirs
JAMBA_LONG_NEW = 32
# [tp]: gemma3-4b-edge's heads split over a ("data", "model") = (1, 2)
# mesh, each rank's share (8 over 4 heads -> 4 over 2); dbrx-132b's (48
# over 8 heads at hd 128 -> 24 over 4: G 6); llama-3.2-vision-90b's (64
# over 8 -> 32 over 4: G 8) and musicgen-large's (32 over 32 at hd 64)
TP_HEADS = (4, 2, 256)
DBRX_TP_HEADS = (24, 4, 128)
VISION_TP_HEADS, MUSICGEN_TP_HEADS = (32, 4, 128), (16, 16, 64)
# gemma-2b (multi-query: 8 over 1 KV head of width 256), qwen3-32b (64
# over 8 at hd 128: vision's heads, with QK-norm) and
# llama4-maverick-400b-a17b (40 over 8 at hd 128: G 5)
GEMMA2B_HEADS, QWEN3_HEADS, LLAMA4_HEADS = (8, 1, 256), (64, 8, 128), \
    (40, 8, 128)
# dbrx-132b (48 over 8 at hd 128: G 6), served at 8 of its 40 layers (the
# whole model, 245 GiB in bf16, does not fit one card); granite-8b's heads
# are jamba's (32 over 8 at hd 128: G 4)
DBRX_HEADS, DBRX_LAYERS = (48, 8, 128), 8
# the burst of the models that one card holds only just (qwen3-32b whole,
# llama4's repeat): 2 longs of 24 new tokens, then 4 shorts of 4, and the
# fused-vs-oracle check over 16 tokens
BIG_LONG, BIG_SHORT, BIG_LONG_NEW, BIG_SHORT_NEW, BIG_ORACLE = 2, 4, 24, 4, 16


def _kname(base: str, heads, model=None) -> tuple:
    """A kernel's entry name and print tag at ``heads``: the smollm-360m
    shapes keep the kernel's own name, gemma3's and jamba's add their
    head width, a later model its own name (``model``)."""
    hd = heads[2]
    if model:
        return f"{base}_{model}", f" {model}"
    return ((base, "") if heads == SMOLLM_HEADS
            else (f"{base}_hd{hd}", f" hd{hd}"))


def _owned(entry: dict, model: str, counter=None) -> dict:
    """Tag a kernels-line entry with the model whose paths' launches it
    reports and the launch counter it reads (the kernel's own by
    default); both tags are taken off before the line is printed."""
    entry["model"] = model
    entry["counter"] = counter or entry["name"].split("_hd")[0]
    return entry


def _ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Milliseconds per call from CUDA events around ``iters``
    back-to-back calls after ``warmup``: for kernels this small it is the
    host's launch pace, not the kernel's time (see ``_device_ms``)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _busy_us(events):
    """Length of the union of the CUDA kernel intervals among profiler
    ``events`` (microseconds), or None when there is none."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + cur_e - cur_s


def _device_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    """Device milliseconds per call, without the host's launch gaps: a
    spin kernel holds the stream while the host enqueues ``iters`` calls,
    so the CUDA events bracket back-to-back device work.  If the spin
    ended before the host finished enqueueing (the start event had
    already passed), the run is repeated with a longer spin and fewer
    calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 50_000_000                        # cycles, ~25 ms at ~2 GHz
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        late = start.query()                 # device already reached start
        end.record()
        end.synchronize()
        if not late:
            return start.elapsed_time(end) / iters
        spin, iters = spin * 4, max(1, iters // 2)
    raise RuntimeError("could not enqueue ahead of the device")


def _cold_device_ms(fn, iters: int = 50) -> float:
    """Device milliseconds per call with the L2 cache flushed before every
    launch, as an admission finds the trees after a decode has streamed
    its weights: each call follows a write of ``L2_FLUSH_BYTES``, and the
    flush's own time, measured alone just before and just after, is
    subtracted."""
    import torch
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                      device="cuda")

    def pair():
        buf.zero_()
        fn()
    alone = _device_ms(buf.zero_, iters)
    both = _device_ms(pair, iters)
    alone += _device_ms(buf.zero_, iters)
    return both - alone / 2


def _interleaved(kern, lib) -> tuple:
    """Device ms of ``kern`` timed in turns with ``lib``: kernel, library,
    kernel.  Returns (mean kernel ms, library ms, (first, second))."""
    a = _device_ms(kern)
    lib_ms = _device_ms(lib)
    b = _device_ms(kern)
    return (a + b) / 2, lib_ms, (a, b)


def _host_us(fn, iters: int = 100) -> float:
    """Host microseconds per call of ``fn`` (the wrapper's checks,
    allocations and launch), enqueued behind a spin kernel so that the
    device never holds the host back."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _cold_wide(hd: int, ms: float, kern, G: int = 0) -> str:
    """At head widths 128 and 256 and at 64 over ungrouped heads (``G``
    1: the wgmma and tensor-core bodies): the kernel's cold time, with
    the L2 flushed before every launch."""
    if hd < 128 and not (hd == 64 and G == 1):
        return ""
    cold = _cold_device_ms(kern)
    return f", cold {cold:.4f} (x{cold / ms:.2f} warm)"


def _bound(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ratio(ms: float, lib_ms: float, bound_ms: float) -> str:
    """The kernel against the library call and against its bound."""
    return (f"kernel/sdpa {ms / lib_ms:.2f}, bound share "
            f"{100 * bound_ms / ms:.2f}%")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _check(name: str, err: float, tol: float) -> None:
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max |kernel - plain| = {err:g} > {tol}")


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    secs = _build.build()
    print(f"[build] nvcc sm_90a, {len(secs)} kernels in parallel: "
          f"{time.monotonic() - t0:.1f} s wall "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name, log in _build.PTXAS_REPORT.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "warning" in line:
                print(f"[build] {name}: {line.strip()}")
        for kernel, lines in _wide_ptxas_lines(log):
            print(f"[build] ptxas {kernel}: " + "; ".join(lines))


def phase_decode_kernel(gen, heads=SMOLLM_HEADS, model=None) -> dict:
    """K1 at the serving shapes: B 1, ``heads`` (H 15 over KV 5, hd 64;
    gemma3-4b-edge: 8 over 4, hd 256), ring S 512."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain,
                                                      split_plan)
    (H, KV, hd), (B, S) = heads, (1, MAX_LEN)
    name, tag = _kname("decode_attention", heads, model)
    errs = {}
    for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(dt)
        ck = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        cv = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        # rank 0 alone up to t 63, the whole cluster from t 64, wrapped
        for t_host in (0, 3, 17, 63, 64, 127, 300, S - 1, S + 200):
            t = torch.tensor(t_host, dtype=torch.int32, device="cuda")
            got = decode_attention_cuda(q, ck, cv, t)
            want = decode_attention_plain(q, ck, cv, t)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            _check(f"decode_attention {label} t={t_host}", err, TOL[label])
            errs[(label, t_host)] = err
    print(f"[K1 decode_attention{tag}] max|err| " + " ".join(
        f"{l}@t={t}:{e:.2e}" for (l, t), e in errs.items()))
    # timing at the serial path's fill levels, bf16 (the serving dtype)
    q = torch.randn(B, 1, H, hd, generator=gen, device="cuda",
                    dtype=torch.float32).bfloat16()
    ck = torch.randn(B, S, KV, hd, generator=gen, device="cuda").bfloat16()
    cv = torch.randn(B, S, KV, hd, generator=gen, device="cuda").bfloat16()
    rows = {}
    for t_host in (23, 63, 127, 511):
        t = torch.tensor(t_host, dtype=torch.int32, device="cuda")
        n = min(S, t_host + 1)
        kx = ck[:, :n].transpose(1, 2).repeat_interleave(H // KV, dim=1)
        vx = cv[:, :n].transpose(1, 2).repeat_interleave(H // KV, dim=1)
        qx = q.transpose(1, 2).contiguous()
        kern = lambda: decode_attention_cuda(q, ck, cv, t)    # noqa: E731
        ms, lib, turns = _interleaved(
            kern, lambda: torch.nn.functional.scaled_dot_product_attention(
                qx, kx, vx))
        plain = _device_ms(lambda: decode_attention_plain(q, ck, cv, t))
        esz = 2
        bound, by = _bound(2 * n * KV * hd * esz + 2 * B * H * hd * esz + 4,
                           4 * B * H * n * hd, torch.bfloat16)
        rows[t_host] = (ms, plain, lib, bound, by)
        print(f"[K1 decode_attention{tag}] bf16 S={S} t={t_host} "
              f"({split_plan(S)} splits): device ms kernel {ms:.4f} "
              f"({turns[0]:.4f} / {turns[1]:.4f} around sdpa)"
              f"{_cold_wide(hd, ms, kern)}, plain "
              f"{plain:.4f}, sdpa {lib:.4f}; bound {bound * 1e3:.3f} us "
              f"({by}); {_ratio(ms, lib, bound)}; host-paced kernel "
              f"{_ms(kern):.4f} ms/call")
    t_host = 127
    ms, plain, lib, bound, by = rows[t_host]
    print(f"[K1 decode_attention{tag}] kernels line: bf16 B1 H{H} KV{KV} "
          f"hd{hd} S{S} t={t_host}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:180",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def phase_flash_kernel(gen, heads=SMOLLM_HEADS, model=None) -> dict:
    """K3 at the serving prefill buckets 16..512: B 1, ``heads``."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    (H, KV, hd), B = heads, 1
    name, tag = _kname("flash_attention", heads, model)
    errs = {}
    timed = []
    for S in (16, 32, 64, 96, 128, 256, 512):        # 96: a ragged bucket
        for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
            got = flash_attention_cuda(q, k, v, causal=True)
            want = flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            _check(f"flash_attention {label} S={S}", err, TOL[label])
            errs[(label, S)] = err
            if label != "bf16" or S == 96:
                continue
            qx, kx, vx = (x.transpose(1, 2) for x in (q, k, v))
            kx = kx.repeat_interleave(H // KV, dim=1)
            vx = vx.repeat_interleave(H // KV, dim=1)
            kern = lambda: flash_attention_cuda(q, k, v)    # noqa: E731
            ms, lib, turns = _interleaved(
                kern, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qx, kx, vx, is_causal=True))
            plain = _device_ms(lambda: flash_attention_plain(q, k, v))
            bound, by = _bound(
                (2 * B * S * H * hd + 2 * B * S * KV * hd) * 2,
                4 * B * H * hd * S * (S + 1) / 2, torch.bfloat16)
            timed.append((S, ms, plain, lib, bound, by))
            print(f"[K3 flash_attention{tag}] bf16 S={S}: device ms kernel "
                  f"{ms:.4f} ({turns[0]:.4f} / {turns[1]:.4f} around sdpa)"
                  f"{_cold_wide(hd, ms, kern, H // KV)}, plain {plain:.4f}, "
                  f"sdpa {lib:.4f}; bound "
                  f"{bound * 1e3:.3f} us ({by}); {_ratio(ms, lib, bound)}; "
                  f"host-paced kernel {_ms(kern):.4f} ms/call, wrapper "
                  f"{_host_us(kern):.1f} host us/call")
    print(f"[K3 flash_attention{tag}] max|err| " + " ".join(
        f"{l}@S={s}:{e:.2e}" for (l, s), e in errs.items()))
    S, ms, plain, lib, bound, by = timed[1]          # the 32-token bucket
    print(f"[K3 flash_attention{tag}] kernels line: bf16 causal B1 H{H} "
          f"KV{KV} hd{hd} S={S}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:89",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def phase_gbdt_kernel(model, prompts) -> dict:
    """K4 on the trained 60-round ensemble (T 180, N 127) over real
    admission features, at batch 16 and 512: within 1e-5 of its plain
    version and equal bit for bit to ``tree_fold`` of the plain walk's
    leaves; device ms warm and with the L2 flushed (cold)."""
    import torch
    from repro_torch.core.features import extract_batch
    from repro_torch.kernels.gbdt_infer import (gbdt_margins_cuda,
                                                gbdt_margins_plain,
                                                tree_fold)
    feat, thr, val = model.tensors("cuda")
    T, N = feat.shape
    K = model.n_classes
    rows = []
    err = 0.0
    for B in (16, 512):
        X = torch.as_tensor(extract_batch(prompts[:B]), device="cuda")
        got = gbdt_margins_cuda(X, feat, thr, val, n_classes=K)
        want = gbdt_margins_plain(X, feat, thr, val, n_classes=K)
        torch.cuda.synchronize()
        e = _max_err(got, want)
        _check(f"gbdt_margins B={B}", e, 1e-5)
        leaves = gbdt_margins_plain(X, feat, thr, val, n_classes=T).T
        if not torch.equal(got, tree_fold(leaves, K)):
            raise AssertionError("gbdt_margins: not tree_fold's sums")
        again = gbdt_margins_cuda(X, feat, thr, val, n_classes=K)
        if not torch.equal(got, again):
            raise AssertionError("gbdt_margins is not deterministic")
        err = max(err, e)
        kern = lambda: gbdt_margins_cuda(X, feat, thr, val,    # noqa: E731
                                         n_classes=K)
        ms, cold = _device_ms(kern), _cold_device_ms(kern)
        plain = _device_ms(lambda: gbdt_margins_plain(X, feat, thr, val,
                                                      n_classes=K), iters=5)
        # bytes this data needs: feature and threshold (8 B) of every
        # distinct inner node visited, the value (4 B) of every leaf
        # reached and its feature (4 B) where the walk must read the leaf
        # marker to stop, plus X and the margins
        inner, leaves, marked = _visited_nodes(X, feat, thr)
        bound, by = _bound(inner * 8 + leaves * 4 + marked * 4
                           + X.numel() * 4 + B * K * 4,
                           B * T * (math.log2(N + 1) - 1), torch.float32)
        rows.append((B, ms, cold, plain, bound, by))
        print(f"[K4 gbdt_margins] B={B} T={T} N={N}: device ms kernel "
              f"{ms:.4f} warm, {cold:.4f} cold (L2 flushed), plain "
              f"{plain:.4f}; bound {bound * 1e3:.4f} us ({by}; {inner} inner "
              f"nodes, {leaves} leaves, {marked} read as leaves); "
              f"host-paced kernel {_ms(kern):.4f} ms/call; max|err| "
              f"{e:.2e}, == tree_fold")
    B, ms, cold, plain, bound, by = rows[0]
    print(f"[K4 gbdt_margins] kernels line: f32 B={B} T={T} N={N}")
    return {"name": "gbdt_margins", "route": "cuda",
            "source": "src/repro_torch/csrc/gbdt_infer.cu",
            "replaces": "src/repro/kernels/gbdt_infer.py:131",
            "max_abs_err": err, "ms": ms, "cold_ms": cold, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _visited_nodes(X, feat, thr) -> tuple:
    """(inner, leaves, marked): distinct (tree, node) pairs that the walks
    over X step through, distinct leaves where they end, and the leaves
    among those above the bottom level, whose leaf marker a walk must
    read to stop."""
    import torch
    T, N = feat.shape
    depth = int(math.log2(N + 1)) - 1
    idx = torch.zeros(T, X.shape[0], dtype=torch.long, device=X.device)
    seen = [idx.clone()]
    f64 = feat.long()
    for _ in range(depth):
        f = torch.gather(f64, 1, idx)
        xi = X.T.gather(0, f.clamp(min=0))
        nxt = torch.where(xi < torch.gather(thr, 1, idx), 2 * idx + 1,
                          2 * idx + 2)
        idx = torch.where(f < 0, idx, nxt)
        seen.append(idx.clone())
    tree = torch.arange(T, device=X.device)[:, None]
    every = torch.unique(torch.cat([s + tree * N for s in seen], dim=1))
    ends = torch.unique(idx + tree * N)
    marked = int(((ends % N) < 2 ** depth - 1).sum())
    return int(every.numel() - ends.numel()), int(ends.numel()), marked


def _visited_packed(X, feat, thr, child, depth) -> tuple:
    """(inner, leaves): distinct (tree, slot) pairs of the packed layout
    that the walks over X step out of, and distinct leaf slots where they
    end.  A walk takes exactly ``depth`` steps, so every walk ends on a
    leaf and no slot is both."""
    import torch
    T, M = feat.shape
    idx = torch.zeros(T, X.shape[0], dtype=torch.long, device=X.device)
    seen = [idx.clone()]
    f64, c64 = feat.long(), child.long()
    for _ in range(depth):
        xi = X.T.gather(0, torch.gather(f64, 1, idx))
        idx = torch.gather(c64, 1, idx) + (
            ~(xi < torch.gather(thr, 1, idx))).long()
        seen.append(idx.clone())
    tree = torch.arange(T, device=X.device)[:, None]
    every = torch.unique(torch.cat([s + tree * M for s in seen], dim=1))
    ends = torch.unique(idx + tree * M)
    return int(every.numel() - ends.numel()), int(ends.numel())


def phase_packed_kernel(model, prompts) -> dict:
    """K5 on the packed 60-round ensemble over real admission features at
    batch 1 (one sidecar admission), 16 (a burst) and 512: within 1e-5
    of its plain version, equal to K4 + base score bit for bit, each row
    equal to the same row scored alone; device ms of both kernels warm
    and cold."""
    import torch
    from repro_torch.core.features import extract_batch
    from repro_torch.kernels.gbdt_infer import (gbdt_margins_cuda,
                                                gbdt_margins_packed_cuda,
                                                gbdt_margins_packed_plain)
    packed = model.packed()
    pf, pt, pc, pv = packed.tensors("cuda")
    feat, thr, val = model.tensors("cuda")
    T, M = pf.shape
    K, depth, base = model.n_classes, packed.depth, packed.base_score
    kw = dict(depth=depth, n_classes=K, base_score=base)
    rows, err = [], 0.0
    for B in (1, 16, 512):
        X = torch.as_tensor(extract_batch(prompts[:B]), device="cuda")
        got = gbdt_margins_packed_cuda(X, pf, pt, pc, pv, **kw)
        want = gbdt_margins_packed_plain(X, pf, pt, pc, pv, **kw)
        dense = gbdt_margins_cuda(X, feat, thr, val, n_classes=K) + base
        torch.cuda.synchronize()
        e = _max_err(got, want)
        _check(f"gbdt_margins_packed B={B}", e, 1e-5)
        if not torch.equal(got, dense):
            raise AssertionError(f"gbdt_margins_packed B={B}: not K4's "
                                 "margins + base score bit for bit")
        if not torch.equal(got, gbdt_margins_packed_cuda(X, pf, pt, pc, pv,
                                                         **kw)):
            raise AssertionError("gbdt_margins_packed is not deterministic")
        for b in {0, B // 2, B - 1}:
            alone = gbdt_margins_packed_cuda(X[b:b + 1].clone(), pf, pt, pc,
                                             pv, **kw)
            if not torch.equal(alone[0], got[b]):
                raise AssertionError(f"gbdt_margins_packed: row {b} of "
                                     f"B={B} differs from the row alone")
        err = max(err, e)
        kern = lambda: gbdt_margins_packed_cuda(  # noqa: E731
            X, pf, pt, pc, pv, **kw)
        k4_fn = lambda: gbdt_margins_cuda(X, feat, thr, val,   # noqa: E731
                                          n_classes=K)
        ms, cold = _device_ms(kern), _cold_device_ms(kern)
        k4, k4_cold = _device_ms(k4_fn), _cold_device_ms(k4_fn)
        plain = _device_ms(lambda: gbdt_margins_packed_plain(
            X, pf, pt, pc, pv, **kw), iters=5)
        # bytes this data needs: feature, threshold and child (12 B) of
        # every distinct inner slot visited and the value (4 B) of every
        # leaf slot reached, plus X and the margins
        inner, leaves = _visited_packed(X, pf, pt, pc, depth)
        bound, by = _bound(inner * 12 + leaves * 4 + X.numel() * 4
                           + B * K * 4, B * T * depth, torch.float32)
        rows.append((B, ms, cold, plain, bound, by))
        print(f"[K5 gbdt_margins_packed] B={B} T={T} M={M} depth={depth}: "
              f"device ms kernel {ms:.4f} warm, {cold:.4f} cold (L2 "
              f"flushed); K4 {k4:.4f} warm, {k4_cold:.4f} cold; plain "
              f"{plain:.4f}; bound {bound * 1e3:.4f} us ({by}; {inner} inner "
              f"slots, {leaves} leaves); host-paced kernel "
              f"{_ms(kern):.4f} ms/call; max|err| {e:.2e}, == K4 + base, "
              f"rows == alone")
    B, ms, cold, plain, bound, by = rows[0]
    print(f"[K5 gbdt_margins_packed] kernels line: f32 B={B} T={T} M={M} "
          f"depth={depth} (one sidecar admission)")
    return {"name": "gbdt_margins_packed", "route": "cuda",
            "source": "src/repro_torch/csrc/gbdt_infer.cu",
            "replaces": "src/repro/kernels/gbdt_infer.py:171",
            "max_abs_err": err, "ms": ms, "cold_ms": cold, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def phase_cli_predictor_kernels() -> tuple:
    """K4 and K5 on the ensemble the launch CLIs build
    (``launch.serve.build_predictor``: 120 rounds, T 360), at the shapes
    their paths give them: K4 on ``launch.serve``'s 100-request burst,
    within 1e-5 of its plain version and equal bit for bit to
    ``tree_fold`` of the plain walk's leaves; K5 on each of the sidecar
    burst's 16 admissions alone (B 1), within 1e-5 of its plain version
    and equal to K4 + base score bit for bit.  Returns the two max|err|."""
    import torch
    from repro_torch.core.features import extract_batch
    from repro_torch.data.corpus import sample_dataset
    from repro_torch.kernels.gbdt_infer import (gbdt_margins_cuda,
                                                gbdt_margins_packed_cuda,
                                                gbdt_margins_packed_plain,
                                                gbdt_margins_plain,
                                                tree_fold)
    from repro_torch.launch import serve
    t0 = time.monotonic()
    model = serve.build_predictor(device="cuda").model
    t_train = time.monotonic() - t0
    feat, thr, val = model.tensors("cuda")
    T, N = feat.shape
    K = model.n_classes
    # launch.serve's burst: --requests 100 --seed 0 draws seed 1
    burst = sample_dataset("sharegpt", n=100, seed=1).prompts
    X = torch.as_tensor(extract_batch(burst), device="cuda")
    B = X.shape[0]
    got = gbdt_margins_cuda(X, feat, thr, val, n_classes=K)
    want = gbdt_margins_plain(X, feat, thr, val, n_classes=K)
    torch.cuda.synchronize()
    e4 = _max_err(got, want)
    _check(f"gbdt_margins CLI ensemble B={B} T={T}", e4, 1e-5)
    leaves = gbdt_margins_plain(X, feat, thr, val, n_classes=T).T
    if not torch.equal(got, tree_fold(leaves, K)):
        raise AssertionError("gbdt_margins (CLI ensemble): not tree_fold's "
                             "sums")
    if not torch.equal(got, gbdt_margins_cuda(X, feat, thr, val,
                                              n_classes=K)):
        raise AssertionError("gbdt_margins (CLI ensemble) is not "
                             "deterministic")
    kern4 = lambda: gbdt_margins_cuda(X, feat, thr, val,   # noqa: E731
                                      n_classes=K)
    ms4 = _device_ms(kern4)
    plain4 = _device_ms(lambda: gbdt_margins_plain(X, feat, thr, val,
                                                   n_classes=K), iters=5)
    inner, n_leaves, marked = _visited_nodes(X, feat, thr)
    bound4, by4 = _bound(inner * 8 + n_leaves * 4 + marked * 4
                         + X.numel() * 4 + B * K * 4,
                         B * T * (math.log2(N + 1) - 1), torch.float32)
    print(f"[K4 gbdt_margins] CLI ensemble (120 rounds, trained in "
          f"{t_train:.1f} s on the host) B={B} T={T} N={N}: device ms "
          f"kernel {ms4:.4f}, plain {plain4:.4f}; bound {bound4 * 1e3:.4f} "
          f"us ({by4}); max|err| {e4:.2e}, == tree_fold")

    packed = model.packed()
    pf, pt, pc, pv = packed.tensors("cuda")
    kw = dict(depth=packed.depth, n_classes=K, base_score=packed.base_score)
    pool, longs, shorts = _burst_pool()
    rows = torch.as_tensor(extract_batch(
        [pool.prompts[i] for i in longs + shorts]), device="cuda")
    e5 = 0.0
    for b in range(rows.shape[0]):
        x = rows[b:b + 1].clone()
        got = gbdt_margins_packed_cuda(x, pf, pt, pc, pv, **kw)
        want = gbdt_margins_packed_plain(x, pf, pt, pc, pv, **kw)
        dense = gbdt_margins_cuda(x, feat, thr, val, n_classes=K) \
            + packed.base_score
        torch.cuda.synchronize()
        e = _max_err(got, want)
        _check(f"gbdt_margins_packed CLI ensemble admission {b} T={T}", e,
               1e-5)
        if not torch.equal(got, dense):
            raise AssertionError(f"gbdt_margins_packed (CLI ensemble) "
                                 f"admission {b}: not K4's margins + base "
                                 "score bit for bit")
        e5 = max(e5, e)
    kern5 = lambda: gbdt_margins_packed_cuda(x, pf, pt, pc, pv,  # noqa: E731
                                             **kw)
    ms5 = _device_ms(kern5)
    plain5 = _device_ms(lambda: gbdt_margins_packed_plain(
        x, pf, pt, pc, pv, **kw), iters=5)
    inner, n_leaves = _visited_packed(x, pf, pt, pc, packed.depth)
    bound5, by5 = _bound(inner * 12 + n_leaves * 4 + x.numel() * 4 + K * 4,
                         T * packed.depth, torch.float32)
    print(f"[K5 gbdt_margins_packed] CLI ensemble B=1 T={T} "
          f"M={pf.shape[1]} depth={packed.depth}, {rows.shape[0]} sidecar "
          f"admissions each alone: device ms kernel {ms5:.4f} (last "
          f"admission), plain {plain5:.4f}; bound {bound5 * 1e3:.4f} us "
          f"({by5}); max|err| {e5:.2e}, == K4 + base")
    return e4, e5


def _cpu_twin(lm):
    """``lm``'s weights in an LM on the CPU: built on the meta device (no
    draw) and handed a host copy of each tensor, so that a 10 GB float32
    copy costs its transfer, not a second seeded draw on the host."""
    import torch
    from repro_torch.models.model import LM
    cpu = LM(lm.cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()},
                        assign=True)
    cpu.device = torch.device("cpu")
    return cpu


def phase_full_width_reference(cfg, tag="reference") -> float:
    """The card's path (K1, K3, cuBLAS) against the CPU's plain path on
    the same full-width float32 weights: prefill logits and 8 greedy
    decode steps.  Returns the largest logit difference."""
    import dataclasses
    import torch
    from repro_torch.models.model import LM
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gpu = LM(cfg32, device="cuda", seed=1)
    cpu = _cpu_twin(gpu)
    ids = torch.arange(3, 3 + 40) * 97 % cfg.vocab_size
    toks = torch.zeros(1, 64, dtype=torch.long)
    toks[0, :40] = ids
    lg, cg = gpu.prefill(toks.cuda(), pad_to=MAX_LEN, prompt_len=40)
    lc, cc = cpu.prefill(toks, pad_to=MAX_LEN, prompt_len=40)
    worst = _max_err(lg.cpu(), lc)
    for _ in range(8):
        tok = lg.argmax(-1).view(1, 1)
        if int(tok) != int(lc.argmax()):
            raise AssertionError("greedy token differs between card and CPU")
        lg = gpu.decode_step(cg, tok)
        lc = cpu.decode_step(cc, tok.cpu())
        worst = max(worst, _max_err(lg.cpu(), lc))
    scale = float(lc.abs().max())
    if not math.isfinite(worst) or worst > 1e-3 * max(1.0, scale):
        raise AssertionError(f"full-width f32 logits differ by {worst:g}")
    print(f"[{tag}] full-width f32, card vs CPU plain path: max|logit "
          f"diff| {worst:.3e} (logit scale {scale:.2f}), greedy tokens equal")
    del gpu, cpu
    torch.cuda.empty_cache()
    return worst


def phase_slice(cfg, predictor, smi, tag="slice", long_new=MAX_NEW,
                n_long=N_LONG, n_short=N_SHORT, short_new=8,
                oracle_new=MAX_NEW) -> tuple:
    """The main path at full width: burst -> predictor -> SJF -> engine
    (``n_long`` long requests of ``long_new`` tokens, then ``n_short``
    short ones of ``short_new``; fused decode held to the per-token
    oracle over ``oracle_new`` tokens; one request profiled).
    Each request launches K3 once a layer for its prefill and K1 once a
    layer for each of its decode steps, exactly.  Prints TTFT and decode
    ms/token beside the price the launch CLIs' service-time model sets for
    a token.  Returns the launches, the engine and each prompt's greedy
    tokens."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import attention_layers
    from repro_torch.serving.engine import RealEngine
    from repro_torch.serving.openai_api import CompletionRequest
    from repro_torch.serving.server import ClairvoyantServer
    from repro_torch.serving.service_time import ServiceTimeModel

    pool, longs, shorts = _burst_pool(n_long, n_short)
    order = longs + shorts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = RealEngine(cfg, max_len=MAX_LEN, segment_len=SEGMENT, seed=0)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} {cfg.dtype} {cfg.num_layers}L "
          f"({attention_layers(cfg)} attention) d{cfg.d_model} "
          f"{cfg.param_count():,} params, seeded init "
          f"{time.monotonic() - t0:.1f} s")
    for b in eng.buckets[:3] or (16,):         # first-call set-up
        eng.generate(list(range(1, b)), max_new_tokens=2)

    ops.reset_launches()
    per_policy = {}
    for policy in ("fcfs", "sjf"):
        eng.busy_until = 0.0
        before = dict(ops.LAUNCHES)
        server = ClairvoyantServer(policy=policy, tau=None,
                                   predictor=predictor, engines=[eng])
        server.submit_many(
            [CompletionRequest(prompt=pool.prompts[i]) for i in order],
            arrivals=[j * 1e-4 for j in range(len(order))],
            true_output_tokens=[long_new if i in longs else short_new
                                for i in order],
            klasses=["long" if i in longs else "short" for i in order])
        w0 = time.monotonic()
        resp = server.drain(max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        wall = time.monotonic() - w0
        if len(resp) != len(order) or not all(r.ok for r in resp):
            raise AssertionError(f"{policy}: not every response is ok")
        for r in resp:
            if not r.token_ids or not all(0 <= x < cfg.vocab_size
                                          for x in r.token_ids):
                raise AssertionError(f"{policy}: bad tokens for request "
                                     f"{r.request_id}")
        steps = sum(len(r.token_ids) - 1 for r in resp)
        for k, want in (("flash_attention", len(resp)),
                        ("decode_attention", steps)):
            got = ops.LAUNCHES[k] - before[k]
            if got != want * attention_layers(cfg):
                raise AssertionError(f"[{tag}] {policy}: {got} {k} "
                                     f"launches, expected {want} x "
                                     f"{attention_layers(cfg)} attention "
                                     "layers")
        # one K5 launch scores the whole burst under SJF (submit_many),
        # none under FCFS
        k5 = ops.LAUNCHES["gbdt_margins_packed"] \
            - before["gbdt_margins_packed"]
        if k5 != int(policy == "sjf"):
            raise AssertionError(f"[{tag}] {policy}: {k5} K5 launches for "
                                 "the burst")
        per_policy[policy] = {
            "short_p50_ms": server.percentile(50, "short") * 1e3,
            "long_p50_ms": server.percentile(50, "long") * 1e3,
            "ttft_p50_ms": server.percentile(50, attr="ttft_s") * 1e3,
            "tokens": sum(r.tokens_generated for r in resp),
            "wall_s": wall,
            "order": [r.request_id for r in resp],
            "by_prompt": {pool.prompts[order[r.request_id - 1]]:
                          r.token_ids for r in resp},
            "launches": {k: ops.LAUNCHES[k] - before[k] for k in before}}
    launches = dict(ops.LAUNCHES)
    _check_path(f"[{tag}]", launches, *_attn_checks(
        cfg, ("decode_attention", "flash_attention", "gbdt_margins_packed"),
        ("paged_decode_attention", "gbdt_margins")))
    sjf, fcfs = per_policy["sjf"], per_policy["fcfs"]
    if sjf["by_prompt"] != fcfs["by_prompt"]:
        raise AssertionError(f"[{tag}] a prompt's tokens differ between the "
                             "FCFS and the SJF run")
    for p, v in per_policy.items():
        print(f"[{tag}] {p}: short P50 {v['short_p50_ms']:.1f} ms, long P50 "
              f"{v['long_p50_ms']:.1f} ms, sojourn-TTFT P50 "
              f"{v['ttft_p50_ms']:.1f} ms, {v['tokens']} tokens in "
              f"{v['wall_s']:.2f} s, launches {v['launches']}, dispatch "
              f"order {v['order']}  [{smi}]")
    print(f"[{tag}] SJF short P50 vs FCFS: "
          f"{100 * (1 - sjf['short_p50_ms'] / fcfs['short_p50_ms']):.1f}% "
          f"lower; K3 once an attention layer a request, K1 once an "
          f"attention layer a decode step (exact)  [{smi}]")
    if not sjf["short_p50_ms"] < fcfs["short_p50_ms"]:
        raise AssertionError(f"[{tag}] SJF short P50 {sjf['short_p50_ms']} "
                             f"ms not below FCFS's {fcfs['short_p50_ms']}")

    # fused decode == per-token oracle, and the engine's own timings
    ids = list(range(5, 5 + 24))
    fused = eng.generate(ids, max_new_tokens=oracle_new)
    ref = eng.generate_reference(ids, max_new_tokens=oracle_new)
    if fused["tokens"] != ref["tokens"]:
        raise AssertionError("fused decode differs from generate_reference")
    n = len(fused["tokens"])
    per_tok = (fused["service_s"] - fused["ttft_s"]) / max(1, n - 1)
    per_tok_ref = (ref["service_s"] - ref["ttft_s"]) / max(1, n - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    phase_profile(eng, smi, tag.replace("slice", "profile"))
    priced = 1e3 / ServiceTimeModel.from_arch(cfg).decode_tok_per_s
    weights = _weight_bytes(eng.lm)
    print(f"[{tag}] fused == reference over {n} tokens; prompt 24 tokens: "
          f"TTFT {fused['ttft_s'] * 1e3:.2f} ms, decode "
          f"{per_tok * 1e3:.3f} ms/token ({1 / per_tok:.0f} tok/s; per-token "
          f"oracle loop {per_tok_ref * 1e3:.3f} ms/token), peak memory "
          f"{peak:.0f} MiB; the service-time model prices a token at "
          f"{priced:.3f} ms, the weight stream "
          f"({weights / 1e9:.2f} GB) at 3.35 TB/s "
          f"{weights / HBM_BYTES_PER_S * 1e3:.3f} "
          f"ms  [{smi}]")
    return launches, eng, sjf["by_prompt"]


def _weight_bytes(lm) -> int:
    """Bytes of every parameter of ``lm``: what a decode step streams (the
    xLSTM gate weights are float32 in a bf16 model)."""
    return sum(p.numel() * p.element_size() for p in lm.parameters())


async def _http(port, body=None, headers=None, method="POST",
                path="/v1/chat/completions", close_after_first=False):
    """One loopback HTTP exchange: ("json", status, obj), ("sse", status,
    frames) or ("disconnected", status, frames so far) when the client
    hangs up after the first SSE frame (``close_after_first``)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        payload = b"" if body is None else json.dumps(body).encode()
        hdrs = {"Host": "loopback", "Connection": "close"}
        if payload:
            hdrs["Content-Type"] = "application/json"
            hdrs["Content-Length"] = str(len(payload))
        hdrs.update(headers or {})
        writer.write((f"{method} {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n").encode()
            + payload)
        await writer.drain()
        if close_after_first:
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                          60.0)
            frame = await asyncio.wait_for(reader.readuntil(b"\n\n"), 60.0)
            return ("disconnected", int(head.split()[1]),
                    [frame.decode().strip()])
        data = await asyncio.wait_for(reader.read(), 120.0)
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
    head, _, raw = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    if any(ln.lower().startswith("content-type: text/event-stream")
           for ln in lines):
        frames = [b.strip()[len("data: "):]
                  for b in raw.decode().split("\n\n") if b.strip()]
        return "sse", status, frames
    if "text/plain" in head.decode("latin-1"):
        return "text", status, raw.decode()
    return "json", status, json.loads(raw) if raw else {}


def _wire_tokens(kind, obj) -> list:
    """Token ids of a wire response (its text is ``t<id>`` words)."""
    if kind == "sse":
        text = "".join(json.loads(f)["choices"][0]["delta"].get("content", "")
                       for f in obj[:-1])
    else:
        text = obj["choices"][0]["message"]["content"]
    return [int(w[1:]) for w in text.split()]


def _admission_ms(predictor, eng, prompts) -> dict:
    """Host milliseconds of one admission score (features + K5 + read
    back), idle and while the engine decodes in another thread."""
    import threading
    import numpy as np
    import torch

    def one():
        t0 = time.perf_counter()
        predictor.proba(prompts[0])
        return (time.perf_counter() - t0) * 1e3

    for _ in range(5):
        one()
    out = {"idle": [one() for _ in range(30)]}
    done = threading.Event()

    def decode():
        eng.generate(list(range(5, 29)), max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        done.set()

    th = threading.Thread(target=decode)
    th.start()
    time.sleep(0.05)                           # the decode is under way
    busy = []
    while not done.is_set() and len(busy) < 60:
        busy.append(one())
        time.sleep(0.005)
    th.join(timeout=120)
    if th.is_alive():
        raise AssertionError("decode thread did not finish")
    out["during decode"] = busy
    return {k: (float(np.median(v)), float(np.percentile(v, 99)), len(v))
            for k, v in out.items()}


def _decode_ms_by_thread(eng) -> dict:
    """Decode ms/token of one 64-token request run on the main thread,
    on a plain worker thread, and through ``asyncio.to_thread`` under an
    event loop (how ``InProcessBackend`` runs it), in turns."""
    import asyncio
    import threading
    import numpy as np
    import torch
    ids = list(range(5, 29))

    def run():
        out = eng.generate(ids, max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        return out

    def on_thread():
        box = {}
        th = threading.Thread(target=lambda: box.update(out=run()))
        th.start()
        th.join(timeout=120)
        if th.is_alive():
            raise AssertionError("decode thread did not finish")
        return box["out"]

    ways = {"main thread": run, "worker thread": on_thread,
            "asyncio.to_thread": lambda: asyncio.run(asyncio.to_thread(run))}
    ms = {k: [] for k in ways}
    for k in list(ways) + list(ways)[::-1]:
        out = ways[k]()
        ms[k].append((out["service_s"] - out["ttft_s"])
                     / (len(out["tokens"]) - 1) * 1e3)
    return {k: float(np.median(v)) for k, v in ms.items()}


def phase_sidecar(eng, predictor, smi, slice_tokens, totals,
                  tag="sidecar", extras=True, long_new=MAX_NEW,
                  n_long=N_LONG, n_short=N_SHORT, short_new=8,
                  sjf_only=False) -> None:
    """The serve-bench burst over HTTP through the port's Sidecar, with
    the in-process run's engine behind an InProcessBackend (the engine
    decodes in a worker thread; ``n_long`` requests of ``long_new``
    tokens, then ``n_short`` of ``short_new``).  FCFS, then SJF: every
    response ok with the in-process run's tokens; under SJF one K5
    launch per admission and no K4; SJF's short P50 below FCFS's; then
    decode ms/token by thread and the admission latency.  With
    ``sjf_only`` (a model the time limit serves only once over the
    wire), SJF alone and none of what compares or times it.  With
    ``extras``, then a disconnect, a deadline shed, ``/metrics`` and a
    graceful shutdown under load."""
    import asyncio
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import attention_layers
    from repro_torch.serving.backends import InProcessBackend
    from repro_torch.serving.http_sidecar import Sidecar
    from repro_torch.serving.observability import parse_prometheus
    from repro_torch.serving.server import ClairvoyantServer

    pool, longs, shorts = _burst_pool(n_long, n_short)
    order = longs + shorts

    def make(policy, **kw):
        server = ClairvoyantServer(policy=policy, tau=None,
                                   predictor=predictor,
                                   engines=[InProcessBackend(eng)],
                                   deadline_mode="sojourn", **kw)
        return Sidecar(server, port=0, max_new_tokens=MAX_NEW)

    async def burst(sc):
        async def client(j, i):
            await asyncio.sleep(j * 0.002)         # arrive in burst order
            n = long_new if i in longs else short_new
            t0 = time.monotonic()
            out = await _http(sc.port, {
                "messages": [{"role": "user", "content": pool.prompts[i]}],
                "max_tokens": n, "output_tokens": n,
                "klass": "long" if i in longs else "short",
                "stream": j % 2 == 1})
            return i, time.monotonic() - t0, out
        return await asyncio.wait_for(asyncio.gather(
            *[client(j, i) for j, i in enumerate(order)]), 600.0)

    per = {}
    for policy in ("sjf",) if sjf_only else ("fcfs", "sjf"):
        sc = make(policy)
        admit_ms = []
        submit = sc.server.submit

        def timed_submit(*a, _submit=submit, **kw):
            t0 = time.perf_counter()
            try:
                return _submit(*a, **kw)
            finally:
                admit_ms.append((time.perf_counter() - t0) * 1e3)

        sc.server.submit = timed_submit

        async def run(sc=sc):
            await sc.start()
            try:
                return await burst(sc)
            finally:
                await sc.shutdown(drain_s=5.0)

        ops.reset_launches()
        w0 = time.monotonic()
        outs = asyncio.run(run())
        torch.cuda.synchronize()
        wall = time.monotonic() - w0
        launches = dict(ops.LAUNCHES)
        for k, v in launches.items():
            totals[k] += v
        srv = sc.server
        bad = [(i, kind, st) for i, _, (kind, st, _) in outs
               if st != 200 or kind not in ("json", "sse")]
        if bad or any(v != "ok" for v in srv._terminal.values()) \
                or len(srv._terminal) != len(order):
            raise AssertionError(f"[{tag}] {policy}: not every response "
                                 f"is ok: {bad} {srv._terminal}")
        for i, _, (kind, _, obj) in outs:
            if kind == "sse" and obj[-1] != "[DONE]":
                raise AssertionError(f"[{tag}] an SSE stream did not end "
                                     "in [DONE]")
            if _wire_tokens(kind, obj) != slice_tokens[pool.prompts[i]]:
                raise AssertionError(f"[{tag}] {policy}: tokens over the "
                                     f"wire differ from the in-process "
                                     f"run's for "
                                     f"prompt {i}")
        layers = attention_layers(eng.cfg)
        steps = sum(len(slice_tokens[pool.prompts[i]]) - 1 for i in order)
        if launches["flash_attention"] != len(order) * layers \
                or launches["decode_attention"] != steps * layers:
            raise AssertionError(f"[{tag}] {policy}: launches {launches}, "
                                 f"expected K3 {len(order)} and K1 {steps} "
                                 f"x {layers} layers")
        if srv.fault_stats["predictor_failures"]:
            raise AssertionError(f"[{tag}] the predictor failed: "
                                 f"{srv.predictor_error}")
        if policy == "sjf":
            _check_path(f"[{tag}] sjf", launches, *_attn_checks(
                eng.cfg, ("decode_attention", "flash_attention",
                          "gbdt_margins_packed"),
                ("paged_decode_attention", "gbdt_margins")))
            if launches["gbdt_margins_packed"] != len(order):
                raise AssertionError(
                    f"[{tag}] {launches['gbdt_margins_packed']} K5 "
                    f"launches for {len(order)} SJF admissions")
        else:
            _check_path(f"[{tag}] fcfs", launches, *_attn_checks(
                eng.cfg, ("decode_attention", "flash_attention"),
                ("paged_decode_attention", "gbdt_margins",
                 "gbdt_margins_packed")))
        soj = {c: [t for i, t, _ in outs if (i in longs) == (c == "long")]
               for c in ("short", "long")}
        finish = [r.request_id for r in srv.responses]
        per[policy] = {c: float(np.median(v)) * 1e3 for c, v in soj.items()}
        print(f"[{tag}] {policy}: short P50 {per[policy]['short']:.1f} ms, "
              f"long P50 {per[policy]['long']:.1f} ms over the wire, "
              f"{len(order)} responses ok ({len(order) // 2} SSE), tokens == "
              f"in process, {wall:.2f} s, admissions (submit) P50 "
              f"{np.median(admit_ms):.3f} ms max {max(admit_ms):.3f} ms, "
              f"launches {launches}, finish order (one serial replica: "
              f"the dispatch order) {finish}  [{smi}]")
    if not sjf_only:
        print(f"[{tag}] SJF short P50 vs FCFS over the wire: "
              f"{100 * (1 - per['sjf']['short'] / per['fcfs']['short']):.1f}"
              f"% lower; K5 launches == SJF admissions ({len(order)}), no "
              f"K4 launch; K3 and K1 once a layer a prefill and a decode "
              f"step (exact)  [{smi}]")
        if not per["sjf"]["short"] < per["fcfs"]["short"]:
            raise AssertionError(f"[{tag}] SJF short P50 over the wire "
                                 f"{per['sjf']['short']} ms not below "
                                 f"FCFS's {per['fcfs']['short']}")
        by_thread = _decode_ms_by_thread(eng)
        print(f"[{tag}] decode ms/token of one request (median of 2, in "
              "turns): " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in by_thread.items())
              + f"  [{smi}]")
        lat = _admission_ms(predictor, eng,
                            [pool.prompts[i] for i in shorts])
        for k, (p50, p99, n) in lat.items():
            print(f"[{tag}] admission (features + K5 + read-back) {k}: P50 "
                  f"{p50:.3f} ms, P99 {p99:.3f} ms over {n} calls  [{smi}]")

    async def wire_extras():
        sc = make("sjf")
        await sc.start()
        srv = sc.server
        try:
            # a client that hangs up mid-stream cancels its generation
            long_p = pool.prompts[longs[0]]
            kind, st, _ = await _http(sc.port, {
                "prompt": long_p, "max_tokens": 64, "output_tokens": 64,
                "stream": True}, close_after_first=True)
            for _ in range(2000):
                if 1 in srv._terminal:
                    break
                await asyncio.sleep(0.005)
            cut = next(r for r in srv.responses if r.request_id == 1)
            if (kind, st) != ("disconnected", 200) \
                    or cut.status != "cancelled" \
                    or "mid-generation" not in cut.error \
                    or not 0 < cut.tokens_generated < 64:
                raise AssertionError(f"[{tag}] disconnect: {cut}")
            # a deadline that expires while queued behind a long request
            blocker = asyncio.create_task(_http(sc.port, {
                "prompt": long_p, "max_tokens": 64, "output_tokens": 64}))
            await asyncio.sleep(0.2)
            kind, st, obj = await _http(
                sc.port, {"prompt": pool.prompts[shorts[0]],
                          "max_tokens": 8, "output_tokens": 8},
                headers={"X-Deadline-S": "0.05"})
            if st != 429 or obj["error"]["type"] != "shed" \
                    or (await blocker)[1] != 200:
                raise AssertionError(f"[{tag}] deadline: {st} {obj}")
            kind, st, text = await _http(sc.port, method="GET",
                                         path="/metrics")
            metrics = parse_prometheus(text)
            if st != 200 or not metrics:
                raise AssertionError(f"[{tag}] /metrics did not parse")
            print(f"[{tag}] disconnect after the first SSE frame: "
                  f"cancelled mid-generation after {cut.tokens_generated} "
                  f"of 64 tokens; X-Deadline-S 0.05 behind a long request: "
                  f"429 shed; /metrics: {len(metrics)} families parse  "
                  f"[{smi}]")
            # graceful shutdown under load: work held in flight on purpose
            clients = [asyncio.create_task(_http(sc.port, {
                "prompt": pool.prompts[i], "max_tokens": 64,
                "output_tokens": 64, "stream": j % 2 == 0}))
                for j, i in enumerate(order[:8])]
            await asyncio.sleep(0.5)
        finally:
            await sc.shutdown(drain_s=0.5)
        outs = await asyncio.wait_for(
            asyncio.gather(*clients, return_exceptions=True), 120.0)
        n_admitted = srv._next_id - 1
        tail = [srv._terminal.get(i) for i in range(4, n_admitted + 1)]
        if sorted(srv._terminal) != list(range(1, n_admitted + 1)) \
                or len(srv.responses) != n_admitted \
                or "cancelled" not in tail:
            raise AssertionError(f"[{tag}] shutdown lost or duplicated a "
                                 f"request: {srv._terminal}")
        for out in outs:
            if isinstance(out, Exception) or (
                    out[0] == "sse" and out[2][-1] != "[DONE]"):
                raise AssertionError(f"[{tag}] shutdown: bad client "
                                     f"outcome {out!r}")
        print(f"[{tag}] graceful shutdown with 8 requests in flight, "
              f"drain 0.5 s: {n_admitted} admitted, each exactly one "
              f"terminal ({tail.count('ok')} ok, {tail.count('cancelled')} "
              f"cancelled), 0 lost  [{smi}]")

    if not extras:
        return
    ops.reset_launches()
    asyncio.run(wire_extras())
    for k, v in ops.LAUNCHES.items():
        totals[k] += v


def phase_profile(eng, smi, tag="profile") -> None:
    """Where a decode step's time goes: kernels launched per token and the
    device's busy share while the engine serves one request (the union of
    CUDA kernel intervals over the span of the whole trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ids = list(range(7, 7 + 24))
    eng.generate(ids, max_new_tokens=4)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = eng.generate(ids, max_new_tokens=9)
        torch.cuda.synchronize()
    n = len(out["tokens"])
    _trace_report(prof.events(), n, f"one request, 24-token prompt, {n} "
                  f"tokens (prefill + {n - 1} decode steps)", smi, tag)


def _trace_report(events, n, what, smi, tag) -> None:
    """Kernels a token, the device's busy share (the union of CUDA kernel
    intervals over the span of the whole trace) and the six longest
    kernels of a profiled run of ``n`` tokens."""
    from torch.autograd import DeviceType
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = _busy_us(events)
    if busy is None:
        print(f"[{tag}] device busy share: not measured (the profiler "
              "recorded no CUDA kernel)")
        return
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    per_kernel = {}
    for e in kernels:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    print(f"[{tag}] {what}, profiler on: {len(kernels)} kernels "
          f"(~{len(kernels) / n:.0f} per token), device busy "
          f"{busy / 1e3:.2f} ms of {span / 1e3:.2f} ms traced "
          f"({100 * busy / span:.1f}% busy, {100 - 100 * busy / span:.1f}% "
          f"idle)  [{smi}]")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[{tag}]   {us / 1e3:8.3f} ms  {name[:90]}")


def phase_decode_lanes_kernel(gen, heads=SMOLLM_HEADS, model=None) -> float:
    """K1 with per-lane fill levels, as the ring lanes launch it: B 4 over
    a 128-slot ring, two lanes wrapped.  Each lane must equal the
    scalar-t launch for that lane bit for bit.  Returns the largest
    |kernel - plain|."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    (H, KV, hd), (B, S) = heads, (L_LANES, L_MAX_LEN)
    tag = _kname("", heads, model)[1]
    t_host = [5, 60, S + 3, 3 * S + 100]
    worst = 0.0
    for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(dt)
        ck = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        cv = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        t = torch.tensor(t_host, dtype=torch.int32, device="cuda")
        got = decode_attention_cuda(q, ck, cv, t)
        err = _max_err(got, decode_attention_plain(q, ck, cv, t))
        _check(f"decode_attention (B,) t {label}", err, TOL[label])
        for b in range(B):
            solo = decode_attention_cuda(q[b:b + 1], ck[b:b + 1],
                                         cv[b:b + 1], t[b:b + 1])
            if not torch.equal(solo[0], got[b]):
                raise AssertionError("K1 lane differs from its scalar-t "
                                     f"launch (lane {b}, {label})")
        worst = max(worst, err)
        if label == "bf16":
            kern = lambda: decode_attention_cuda(q, ck, cv, t)  # noqa: E731
            plain = _device_ms(lambda: decode_attention_plain(q, ck, cv, t))
            # SDPA over the whole ring with a boolean mask of each lane's
            # live slots (K/V expanded to the H query heads)
            mask = (torch.arange(S, device="cuda")[None, :]
                    <= t[:, None]).view(B, 1, 1, S)
            qx = q.transpose(1, 2).contiguous()
            kx = ck.transpose(1, 2).repeat_interleave(H // KV, dim=1)
            vx = cv.transpose(1, 2).repeat_interleave(H // KV, dim=1)
            ms, lib, turns = _interleaved(
                kern, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qx, kx, vx, attn_mask=mask))
            n = sum(min(S, x + 1) for x in t_host)
            bound, by = _bound(2 * n * KV * hd * 2 + 2 * B * H * hd * 2
                               + 4 * B, 4 * H * n * hd, torch.bfloat16)
            print(f"[K1 decode_attention{tag}] lanes bf16 B{B} S{S} "
                  f"t={t_host}: "
                  f"device ms kernel {ms:.4f} ({turns[0]:.4f} / "
                  f"{turns[1]:.4f} around sdpa)"
                  f"{_cold_wide(hd, ms, kern)}, plain {plain:.4f}, sdpa "
                  f"(boolean mask) {lib:.4f}; bound {bound * 1e3:.3f} us "
                  f"({by}); {_ratio(ms, lib, bound)}; max|err| {err:.2e}")
    print(f"[K1 decode_attention{tag}] (B,) t: each lane == its scalar-t "
          f"launch "
          f"(bitwise), max|err| vs plain {worst:.2e}")
    return worst


def phase_paged_kernel(gen, heads=SMOLLM_HEADS, model=None) -> dict:
    """K2 at the serving shapes: B 4, ``heads``, page 16, 32 pages a lane
    (max_len 512), mixed fill levels including one past the window; page
    sizes 8 / 16 / 32; bf16 and f32.  On the same logical contents K2
    must equal K1 bit for bit."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)
    (H, KV, hd), (B, window) = heads, (4, MAX_LEN)
    name, tag = _kname("paged_decode_attention", heads, model)
    t_host = [3, 130, 400, window + 70]            # last: past the window
    errs = {}
    timed = None
    for page in (8, 16, 32):
        P = window // page
        n_pages = B * P + 1
        for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            pk = torch.randn(n_pages, page, KV, hd, generator=gen,
                             device="cuda").to(dt)
            pv = torch.randn(n_pages, page, KV, hd, generator=gen,
                             device="cuda").to(dt)
            pk[0], pv[0] = 1e4, -1e4               # poisoned trash page
            bt = (torch.randperm(n_pages - 1, generator=gen,
                                 device="cuda")[:B * P] + 1) \
                .view(B, P).to(torch.int32)
            t = torch.tensor(t_host, dtype=torch.int32, device="cuda")
            for b in range(B - 1):                 # unallocated -> trash
                bt[b, t_host[b] // page + 1:] = 0
            q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(dt)
            got = paged_decode_attention_cuda(q, pk, pv, bt, t)
            want = paged_decode_attention_plain(q, pk, pv, bt, t)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            _check(f"paged_decode_attention {label} page={page}", err,
                   TOL[label])
            errs[(label, page)] = err
            ring_k = pk[bt.long()].reshape(B, P * page, KV, hd)
            ring_v = pv[bt.long()].reshape(B, P * page, KV, hd)
            if not torch.equal(got, decode_attention_cuda(q, ring_k, ring_v,
                                                          t)):
                raise AssertionError(f"K2 != K1 on the same logical window "
                                     f"({label}, page {page})")
            if label == "bf16" and page == L_PAGE:
                kern = lambda: paged_decode_attention_cuda(  # noqa: E731
                    q, pk, pv, bt, t)
                ms, k1_ms, turns = _interleaved(
                    kern, lambda: decode_attention_cuda(q, ring_k, ring_v, t))
                plain = _device_ms(lambda: paged_decode_attention_plain(
                    q, pk, pv, bt, t))
                n = sum(min(window, x + 1) for x in t_host)
                bound, by = _bound(
                    2 * n * KV * hd * 2 + 2 * B * H * hd * 2
                    + bt.numel() * 4 + 4 * B, 4 * H * n * hd, torch.bfloat16)
                timed = (ms, plain, bound, by)
                print(f"[K2 paged_decode_attention{tag}] bf16 B{B} H{H} "
                      f"KV{KV} hd{hd} page {page} P{P} t={t_host}: device "
                      f"ms kernel "
                      f"{ms:.4f} ({turns[0]:.4f} / {turns[1]:.4f} around K1 "
                      f"on the same window, {k1_ms:.4f})"
                      f"{_cold_wide(hd, ms, kern)}, plain {plain:.4f}; bound "
                      f"{bound * 1e3:.3f} us ({by}); bound share "
                      f"{100 * bound / ms:.2f}%; host-paced kernel "
                      f"{_ms(kern):.4f} ms/call")
    print(f"[K2 paged_decode_attention{tag}] max|err| " + " ".join(
        f"{l}@page={p}:{e:.2e}" for (l, p), e in errs.items())
          + "; K2 == K1 bitwise on every case")
    ms, plain, bound, by = timed
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:155",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def phase_flash_extend(gen, heads=SMOLLM_HEADS, model=None) -> float:
    """K3 in extend mode: suffix buckets 16..64 over a 48..128-token prefix
    (q_offset) in a longer key buffer.  The suffix rows must equal those
    rows of the cold prefill bit for bit.  Returns the largest
    |kernel - plain|."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    (H, KV, hd), B = heads, 1
    tag = _kname("", heads, model)[1]
    errs = {}
    for prefix, suffix in ((48, 16), (64, 16), (64, 32), (64, 64),
                           (128, 16), (128, 64)):
        extent = prefix + suffix + 16                  # pad keys beyond
        for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            qf = torch.randn(B, prefix + suffix, H, hd, generator=gen,
                             device="cuda").to(dt)
            k = torch.randn(B, extent, KV, hd, generator=gen,
                            device="cuda").to(dt)
            v = torch.randn(B, extent, KV, hd, generator=gen,
                            device="cuda").to(dt)
            q = qf[:, prefix:]
            got = flash_attention_cuda(q, k, v, q_offset=prefix)
            err = _max_err(got, flash_attention_plain(q, k, v,
                                                      q_offset=prefix))
            _check(f"flash_attention extend {label} {prefix}+{suffix}", err,
                   TOL[label])
            n = prefix + suffix
            cold = flash_attention_cuda(qf, k[:, :n].contiguous(),
                                        v[:, :n].contiguous())
            if not torch.equal(cold[:, prefix:], got):
                raise AssertionError("K3 extend rows differ from the cold "
                                     f"prefill ({label} {prefix}+{suffix})")
            errs[(label, prefix, suffix)] = err
            if label == "bf16" and (prefix, suffix) in ((48, 16), (64, 64)):
                kern = lambda: flash_attention_cuda(  # noqa: E731
                    q, k, v, q_offset=prefix)
                plain = _device_ms(lambda: flash_attention_plain(
                    q, k, v, q_offset=prefix))
                # SDPA with an explicit mask: key j <= prefix + row i
                mask = (torch.arange(extent, device="cuda")[None, :]
                        <= prefix + torch.arange(suffix, device="cuda")
                        [:, None]).view(1, 1, suffix, extent)
                qx = q.transpose(1, 2)
                kx = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
                vx = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
                ms, lib, turns = _interleaved(
                    kern, lambda: torch.nn.functional
                    .scaled_dot_product_attention(qx, kx, vx,
                                                  attn_mask=mask))
                pairs = sum(prefix + i + 1 for i in range(suffix))
                bound, by = _bound((2 * suffix * H * hd
                                    + 2 * extent * KV * hd) * 2,
                                   4 * H * hd * pairs, torch.bfloat16)
                print(f"[K3 flash_attention{tag}] extend bf16 q_offset "
                      f"{prefix} "
                      f"Sq {suffix} Skv {extent}: device ms kernel "
                      f"{ms:.4f} ({turns[0]:.4f} / {turns[1]:.4f} around "
                      f"sdpa){_cold_wide(hd, ms, kern, H // KV)}, plain "
                      f"{plain:.4f}, sdpa (mask) "
                      f"{lib:.4f}; bound {bound * 1e3:.3f} us ({by}); "
                      f"{_ratio(ms, lib, bound)}")
    print(f"[K3 flash_attention{tag}] extend max|err| " + " ".join(
        f"{l}@{p}+{s}:{e:.2e}" for (l, p, s), e in errs.items())
          + "; suffix rows == cold-prefill rows bitwise")
    return max(errs.values())


def phase_flash_exact(gen, heads=JAMBA_HEADS, model=None) -> float:
    """K3 at exact prompt lengths (``EXACT_S``, not power-of-two buckets),
    as a stack with Mamba or MoE blocks prefills: B 1, ``heads``, bf16
    and f32, causal, against the plain version.  The keys and values are
    views into buffers whose rows past S hold NaN: the output must be
    finite and equal bit for bit to the launch on clean contiguous
    copies, so the tail tile's masked keys contribute exact zeros.
    Returns the largest |kernel - plain|."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    (H, KV, hd), B = heads, 1
    tag = _kname("", heads, model)[1]
    errs = {}
    for S in EXACT_S:
        for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
            kb, vb = (torch.full((B, S + 64, KV, hd), float("nan"),
                                 dtype=dt, device="cuda") for _ in range(2))
            kb[:, :S] = torch.randn(B, S, KV, hd, generator=gen,
                                    device="cuda").to(dt)
            vb[:, :S] = torch.randn(B, S, KV, hd, generator=gen,
                                    device="cuda").to(dt)
            k, v = kb[:, :S], vb[:, :S]
            got = flash_attention_cuda(q, k, v, causal=True)
            clean = flash_attention_cuda(q, k.contiguous(), v.contiguous(),
                                         causal=True)
            want = flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or not torch.equal(got, clean):
                raise AssertionError(f"K3 at exact S={S} ({label}) read "
                                     "keys past S")
            err = _max_err(got, want)
            _check(f"flash_attention exact {label} S={S}", err, TOL[label])
            errs[(label, S)] = err
    q = torch.randn(B, 45, H, hd, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(B, 45, KV, hd, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    ms = _device_ms(lambda: flash_attention_cuda(q, k, v))
    plain = _device_ms(lambda: flash_attention_plain(q, k, v))
    print(f"[K3 flash_attention{tag}] exact lengths max|err| " + " ".join(
        f"{l}@S={s}:{e:.2e}" for (l, s), e in errs.items())
          + "; NaN rows past S never read (output == clean launch, "
          f"bitwise); bf16 S=45 device ms kernel {ms:.4f}, plain "
          f"{plain:.4f}")
    return max(errs.values())


def _pattern(vocab, rng, prefix=None, long_new=L_LONG, short_new=L_SHORT):
    """The paging benchmark's backlog: 16-token prompts (after an optional
    shared prefix), long / short budgets in PATTERN order."""
    import numpy as np
    maxes = [long_new if c == "L" else short_new for c in PATTERN]
    prompts = []
    for _ in PATTERN:
        p = rng.integers(1, vocab, size=L_PROMPT).astype(np.int64)
        prompts.append(p if prefix is None else np.concatenate([prefix, p]))
    return prompts, maxes


def _drain_pattern(eng, prompts, maxes, exact=True) -> dict:
    """One ``generate_batch`` over the backlog: wall, tokens, tok/s and the
    short requests' P50 sojourn from the drain's start.  With ``exact``,
    every prefill (cold or extend) must launch K3 once a layer and every
    lane step K1 (ring) or K2 (paged) once a layer: the LM's calls are
    counted (speculative lanes check their rounds' launches instead)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import attention_layers
    lm, calls = eng.lm, {"prefill": 0, "decode_step": 0}

    def counted(name):
        fn = getattr(lm, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    for name in calls:
        setattr(lm, name, counted(name))
    ops.reset_launches()
    t0 = time.monotonic()
    try:
        res = eng.generate_batch(prompts, maxes)
        torch.cuda.synchronize()
    finally:
        for name in calls:
            delattr(lm, name)
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    L = attention_layers(lm.cfg)
    decode = launches["decode_attention"] + launches["paged_decode_attention"]
    if exact and (launches["flash_attention"] != calls["prefill"] * L
                  or decode != calls["decode_step"] * L):
        raise AssertionError(f"launches {launches} for {calls} x {L} layers")
    toks = sum(len(r["tokens"]) for r in res)
    start = min(r["admit_t"] for r in res)
    short = [r["finish_t"] - start for r, c in zip(res, PATTERN) if c == "S"]
    return {"res": res, "tokens": [r["tokens"] for r in res], "wall": wall,
            "n_tok": toks, "tok_s": toks / wall,
            "short_p50_ms": float(np.median(short)) * 1e3,
            "launches": launches, "steps": calls["decode_step"],
            "preempted": [i for i, r in enumerate(res) if r["evictions"]]}


def _lane_engines(cfg, dtype_cfg=None):
    """Ring and paged lane engines on one set of seeded weights, budget =
    two worst-case longs (the paging benchmark's)."""
    from repro_torch.serving.batching import kv_bytes_per_token
    from repro_torch.serving.engine import (BatchedRealEngine,
                                            PagedBatchedEngine)
    c = dtype_cfg or cfg
    budget = 2 * (L_PROMPT + L_LONG) * kv_bytes_per_token(c)
    kw = dict(max_len=L_MAX_LEN, segment_len=L_SEGMENT, n_lanes=L_LANES,
              budget_bytes=budget)
    ring = BatchedRealEngine(c, seed=0, **kw)
    paged = PagedBatchedEngine(c, state_dict=ring.lm.state_dict(),
                               page_size=L_PAGE, **kw)
    return ring, paged


def _attn_checks(cfg, run, skip=()) -> tuple:
    """A path's (run, skip) kernel lists, with K1 and K3 moved from
    ``run`` to ``skip`` when the stack has no attention layer (xlstm:
    then neither may launch)."""
    from repro_torch.models.transformer import attention_layers
    if attention_layers(cfg):
        return run, skip
    att = ("decode_attention", "flash_attention")
    return (tuple(k for k in run if k not in att),
            tuple(skip) + tuple(k for k in run if k in att))


def _check_path(name, launches, run, skip=()):
    for k in run:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} was never launched")
    for k in skip:
        if launches[k] != 0:
            raise AssertionError(f"{name}: kernel {k} launched "
                                 f"{launches[k]} times, expected none")


def phase_lanes(cfg, smi, totals, tag="lanes") -> None:
    """The lane and paged engines at full width (bf16): the paging
    benchmark's backlog through ring lanes, then paged lanes (growth and
    preemption under the two-long budget), then with a shared 48-token
    prefix, cold then warm.  Paged lanes must give the ring lanes' tokens
    for every request that was not preempted (a preempted request resumes
    by re-prefilling its generated tokens, which rounds differently in
    bf16; its agreement is reported)."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import attention_layers
    t0 = time.monotonic()
    ring, paged = _lane_engines(cfg)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} {cfg.dtype} {cfg.num_layers}L, {L_LANES} "
          f"lanes, max_len {L_MAX_LEN}, segment {L_SEGMENT}, page {L_PAGE}, "
          f"budget {ring.budget_bytes} B = {paged.n_pages} pages, pattern "
          f"{PATTERN} (long {L_LONG} / short {L_SHORT} new tokens); engines "
          f"{time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(0)
    warm_p, _ = _pattern(cfg.vocab_size, rng)
    for eng in (ring, paged):                       # first-call set-up
        eng.generate_batch(warm_p[:L_LANES], 4)
    paged.allocator.drop_cache()
    prompts, maxes = _pattern(cfg.vocab_size, np.random.default_rng(100))
    out = {}
    for name, eng in (("ring", ring), ("paged", paged)):
        out[name] = r = _drain_pattern(eng, prompts, maxes)
        for k, v in r["launches"].items():
            totals[k] += v
        # decode steps = decode-kernel launches / layers (one per layer
        # per step; prefills launch K3, not K1/K2)
        steps = (r["launches"]["decode_attention"]
                 + r["launches"]["paged_decode_attention"]) \
            // attention_layers(cfg)
        steps = max(1, steps)
        print(f"[{tag}] {name}: {r['n_tok']} tokens in {r['wall']:.2f} s = "
              f"{r['tok_s']:.1f} tok/s, {steps} lane steps "
              f"({r['wall'] / steps * 1e3:.1f} ms per step incl. prefills), "
              f"short P50 {r['short_p50_ms']:.1f} ms, preemptions "
              f"{eng.lane_manager.stats.get('preemptions', 0)}, dead steps "
              f"{eng.dead_steps}, launches {r['launches']}  [{smi}]")
    _check_path(f"[{tag}] ring", out["ring"]["launches"],
                ("decode_attention", "flash_attention"),
                ("paged_decode_attention",))
    _check_path(f"[{tag}] paged", out["paged"]["launches"],
                ("paged_decode_attention", "flash_attention"),
                ("decode_attention",))
    same = [a == b for a, b in zip(out["ring"]["tokens"],
                                   out["paged"]["tokens"])]
    pre = out["paged"]["preempted"]
    bad = [i for i, ok in enumerate(same) if not ok and i not in pre]
    if bad:
        raise AssertionError(f"[{tag}] paged != ring tokens for requests "
                             f"{bad} that were never preempted")
    print(f"[{tag}] paged == ring tokens ({cfg.dtype}): "
          f"{sum(same)}/{len(same)} requests; preempted and resumed "
          f"{pre}, of which equal "
          f"{[i for i in pre if same[i]]}")
    cut = 1 - out["paged"]["short_p50_ms"] / out["ring"]["short_p50_ms"]
    print(f"[{tag}] paged vs ring: short P50 {100 * cut:.1f}% lower, tok/s "
          f"x{out['paged']['tok_s'] / out['ring']['tok_s']:.2f}  [{smi}]")

    prefix = np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=L_PREFIX).astype(np.int64)
    pp, pm = _pattern(cfg.vocab_size, np.random.default_rng(101), prefix)
    paged.generate_batch(pp[:L_LANES], 4)           # first-call set-up
    _prefix_passes(paged, pp, pm, totals, smi, tag)
    del ring, paged
    torch.cuda.empty_cache()


def _prefix_passes(paged, pp, pm, totals, smi, tag) -> None:
    """The backlog ``pp`` (after a shared prefix; budgets ``pm``) through
    a paged lane engine, cold (its prefix cache dropped first) and then
    warm.  Every prefill (cold or extend) launches K3 once a layer and
    every lane step K2 once a layer, K1 never; every request gets its
    budget of tokens (at most what its window leaves after the prompt),
    each in the vocabulary; after each pass the pool
    has drained clean (no page held, the allocator's invariants intact);
    the warm pass hits the prefix."""
    vocab = paged.cfg.vocab_size
    paged.allocator.reset_transient()
    paged.allocator.drop_cache()                    # the next pass is cold
    passes = {}
    for name in ("cold", "warm"):
        h0 = paged.allocator.stats["prefix_hit_pages"]
        passes[name] = r = _drain_pattern(paged, pp, pm)
        for k, v in r["launches"].items():
            totals[k] += v
        r["hit_pages"] = paged.allocator.stats["prefix_hit_pages"] - h0
        _check_path(f"[{tag}] prefix {name}", r["launches"],
                    ("paged_decode_attention", "flash_attention"),
                    ("decode_attention",))
        for p, toks, m in zip(pp, r["tokens"], pm):
            m = min(m, paged.max_len - len(p))
            if len(toks) != m or not all(0 <= t < vocab for t in toks):
                raise AssertionError(f"[{tag}] prefix {name}: tokens "
                                     f"{toks[:8]} for a budget of {m}")
        states = paged.allocator.page_states()
        paged.allocator.check()
        if states["held"]:
            raise AssertionError(f"[{tag}] prefix {name}: the pool did not "
                                 f"drain clean: {states}")
        steps = max(1, r["steps"])
        print(f"[{tag}] prefix {L_PREFIX} {name}: {r['n_tok']} tokens in "
              f"{r['wall']:.2f} s = {r['tok_s']:.1f} tok/s, {steps} lane "
              f"steps ({r['wall'] / steps * 1e3:.1f} ms per step incl. "
              f"prefills), short P50 {r['short_p50_ms']:.1f} ms, prefix-hit "
              f"pages {r['hit_pages']}, preemptions "
              f"{paged.lane_manager.stats['preemptions']}, pool after the "
              f"drain {states}, launches {r['launches']}  [{smi}]")
    if passes["warm"]["hit_pages"] <= 0:
        raise AssertionError(f"[{tag}] the warm pass had no prefix hit")
    agree = sum(a == b for a, b in zip(passes["cold"]["tokens"],
                                       passes["warm"]["tokens"]))
    print(f"[{tag}] prefix warm == cold tokens ({paged.cfg.dtype}): "
          f"{agree}/{len(pp)}")


def phase_lanes_f32(cfg, smi, totals, tag="lanes-f32") -> None:
    """Float32 full-width copy, TF32 off: ring lanes, paged lanes, the
    serial engine and the warm prefix-hit pass give the same tokens on
    the pattern with budgets capped at 16 tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.serving.engine import RealEngine
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ring, paged = _lane_engines(cfg, cfg32)
    serial = RealEngine(cfg32, state_dict=ring.lm.state_dict(),
                        max_len=L_MAX_LEN, segment_len=L_SEGMENT)
    cap = 16
    prompts, maxes = _pattern(cfg.vocab_size, np.random.default_rng(200),
                              long_new=cap)
    prefix = np.random.default_rng(8).integers(
        1, cfg.vocab_size, size=L_PREFIX).astype(np.int64)
    pp, pm = _pattern(cfg.vocab_size, np.random.default_rng(201), prefix,
                      long_new=cap)
    runs = {"ring": _drain_pattern(ring, prompts, maxes),
            "paged": _drain_pattern(paged, prompts, maxes)}
    paged.allocator.reset_transient()
    paged.allocator.drop_cache()
    runs["cold"] = _drain_pattern(paged, pp, pm)
    runs["warm"] = _drain_pattern(paged, pp, pm)
    for name, r in runs.items():
        for k, v in r["launches"].items():
            totals[k] += v
    ops_serial = [serial.generate(p, max_new_tokens=m)["tokens"]
                  for p, m in zip(prompts, maxes)]
    ops_prefix = [serial.generate(p, max_new_tokens=m)["tokens"]
                  for p, m in zip(pp, pm)]
    for name, want in (("ring", ops_serial), ("paged", ops_serial),
                       ("cold", ops_prefix), ("warm", ops_prefix)):
        got = runs[name]["tokens"]
        if got != want:
            diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"[{tag}] {name} tokens differ from "
                                 f"the serial engine for requests {diff}")
    hits = paged.allocator.stats["prefix_hit_pages"]
    print(f"[{tag}] float32, TF32 off, budgets capped at {cap}: ring "
          f"lanes == paged lanes == serial engine on {len(prompts)} "
          f"requests; prefix cold == warm == serial on {len(pp)} "
          f"({hits} prefix-hit pages, preemptions "
          f"{paged.lane_manager.stats['preemptions']})  [{smi}]")
    del ring, paged, serial
    torch.cuda.empty_cache()


def _plain_attention_ops():
    """A context in which the model's attention calls take the kernels'
    plain PyTorch versions on the card (``ops.flash_attention`` and
    ``ops.decode_attention`` patched): the oracle a path through the
    kernels is held to."""
    from unittest import mock
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(ops, "flash_attention",
                                          flash_attention_plain))
    stack.enter_context(mock.patch.object(ops, "decode_attention",
                                          decode_attention_plain))
    return stack


def phase_jamba_f32(cfg, smi, totals, tag="jamba-f32") -> None:
    """A float32 copy of jamba at full width, one pattern repeat (8
    layers: 7 Mamba, 4 of them MoE, and 1 attention; llama4's: 2 attention
    layers, the second with 128 experts top-1), TF32 off: prefill
    logits and 8 greedy steps through K1/K3 against the same weights
    through the plain attention on the card, within ``TOL["f32"]`` of
    the logit scale, tokens equal; then the paging backlog (budgets
    capped at 16) through ring lanes, kernels against plain, tokens
    equal.  Lanes are held to lanes, not to the serial engine: MoE
    capacity is shared by the tokens of a step, so a lane's tokens
    depend on its neighbours (as in the JAX package)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models.transformer import attention_layers
    from repro_torch.serving.batching import kv_bytes_per_token
    from repro_torch.serving.engine import BatchedRealEngine
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=len(cfg.block_pattern))
    t0 = time.monotonic()
    eng = BatchedRealEngine(
        cfg32, seed=1, max_len=L_MAX_LEN, segment_len=L_SEGMENT,
        n_lanes=L_LANES,
        budget_bytes=2 * (L_PROMPT + L_LONG) * kv_bytes_per_token(cfg32))
    torch.cuda.synchronize()
    lm = eng.lm
    print(f"[{tag}] {cfg32.num_layers} layers {cfg32.block_pattern}, "
          f"{cfg32.param_count():,} float32 parameters "
          f"({cfg32.param_count() * 4 / 1e9:.1f} GB), seeded init "
          f"{time.monotonic() - t0:.1f} s")
    toks = (torch.arange(3, 3 + 40) * 97 % cfg.vocab_size).view(1, 40)
    toks = toks.cuda()

    def greedy():
        lg, cache = lm.prefill(toks, pad_to=L_MAX_LEN)
        logits, out = [lg], []
        for _ in range(8):
            tok = lg.argmax(-1).view(1, 1)
            out.append(int(tok))
            lg = lm.decode_step(cache, tok)
            logits.append(lg)
        return torch.stack(logits), out
    from repro_torch.kernels import ops
    ops.reset_launches()
    k_logits, k_toks = greedy()
    launches = dict(ops.LAUNCHES)
    with _plain_attention_ops():
        p_logits, p_toks = greedy()
    n_attn = attention_layers(cfg32)
    if launches["flash_attention"] != n_attn \
            or launches["decode_attention"] != 8 * n_attn:
        raise AssertionError(f"[{tag}] launches {launches}, expected K3 "
                             f"{n_attn} and K1 8 x {n_attn} (the attention "
                             "layers)")
    worst = _max_err(k_logits, p_logits)
    scale = float(p_logits.abs().max())
    if k_toks != p_toks:
        raise AssertionError(f"[{tag}] greedy tokens differ: {k_toks} vs "
                             f"{p_toks}")
    _check(f"[{tag}] logits", worst / max(1.0, scale), TOL["f32"])
    print(f"[{tag}] card K1/K3 vs card plain attention: prefill 40 tokens "
          f"+ 8 greedy steps, max|logit diff| {worst:.3e} (logit scale "
          f"{scale:.2f}), tokens equal {k_toks}  [{smi}]")
    prompts, maxes = _pattern(cfg.vocab_size, np.random.default_rng(300),
                              long_new=16)
    eng.generate_batch(prompts[:L_LANES], 2)        # first-call set-up
    ring = _drain_pattern(eng, prompts, maxes)
    for k, v in ring["launches"].items():
        totals[k] += v
    with _plain_attention_ops():
        plain = eng.generate_batch(prompts, maxes)
    if ring["tokens"] != [r["tokens"] for r in plain]:
        raise AssertionError(f"[{tag}] ring-lane tokens through the "
                             "kernels differ from the plain attention's")
    _check_path(f"[{tag}] ring", ring["launches"],
                ("decode_attention", "flash_attention"),
                ("paged_decode_attention",))
    print(f"[{tag}] ring lanes ({L_LANES}), {len(prompts)} requests, "
          f"budgets capped at 16: kernels == plain attention tokens, "
          f"launches {ring['launches']}  [{smi}]")
    del eng, lm
    _free_card(tag)


def phase_hybrid_lanes(cfg, smi, totals, tag="jamba-lanes") -> None:
    """A stack with recurrent or MoE blocks (jamba bf16 at one pattern
    repeat; xlstm bf16, all 24 layers) through ring lanes on the paging
    benchmark's backlog, with K1/K3 launches held exactly to the lane
    steps and prefills (none without an attention layer); the
    block-paged engine and a speculative engine must refuse the stack
    with the JAX engine's messages before building any weight.  A stack
    with no K/V per token (xlstm) takes the default budget of a full
    ring a lane."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.batching import kv_bytes_per_token
    from repro_torch.serving.engine import (BatchedRealEngine,
                                            PagedBatchedEngine, RealEngine)
    before = torch.cuda.memory_allocated()
    for build, want in (
            (lambda: PagedBatchedEngine(cfg, max_len=L_MAX_LEN),
             "block-paged KV needs a pure-attention stack"),
            (lambda: RealEngine(cfg, draft_cfg=get_config("smollm-360m"),
                                draft_k=4),
             "speculative decoding needs a pure-attention stack"),
            (lambda: BatchedRealEngine(
                cfg, draft_cfg=get_config("smollm-360m"), draft_k=4),
             "speculative decoding needs a pure-attention stack")):
        try:
            build()
        except ValueError as e:
            if want not in str(e):
                raise
        else:
            raise AssertionError(f"[{tag}] not refused: {want}")
    if torch.cuda.memory_allocated() != before:
        raise AssertionError(f"[{tag}] a refused engine built weights")
    print(f"[{tag}] PagedBatchedEngine and speculative RealEngine / "
          "BatchedRealEngine refuse the stack before building weights "
          "(the JAX messages)")
    t0 = time.monotonic()
    budget = 2 * (L_PROMPT + L_LONG) * kv_bytes_per_token(cfg) or None
    eng = BatchedRealEngine(cfg, seed=0, max_len=L_MAX_LEN,
                            segment_len=L_SEGMENT, n_lanes=L_LANES,
                            budget_bytes=budget)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} bf16 {cfg.num_layers}L, {L_LANES} lanes, "
          f"max_len {L_MAX_LEN}, budget {eng.budget_bytes} B, pattern "
          f"{PATTERN}; "
          f"engine {time.monotonic() - t0:.1f} s")
    eng.generate_batch(
        _pattern(cfg.vocab_size, np.random.default_rng(0))[0][:L_LANES], 4)
    prompts, maxes = _pattern(cfg.vocab_size, np.random.default_rng(100))
    r = _drain_pattern(eng, prompts, maxes)
    for k, v in r["launches"].items():
        totals[k] += v
    _check_path(f"[{tag}] ring", r["launches"], *_attn_checks(
        cfg, ("decode_attention", "flash_attention"),
        ("paged_decode_attention",)))
    for x in r["res"]:
        if not x["tokens"] or not all(0 <= t < cfg.vocab_size
                                      for t in x["tokens"]):
            raise AssertionError(f"[{tag}] bad tokens {x['tokens'][:8]}")
    steps = max(1, r["steps"])
    print(f"[{tag}] ring: {r['n_tok']} tokens in {r['wall']:.2f} s = "
          f"{r['tok_s']:.1f} tok/s, {steps} lane steps "
          f"({r['wall'] / steps * 1e3:.1f} ms per step incl. prefills), "
          f"short P50 {r['short_p50_ms']:.1f} ms, dead steps "
          f"{eng.dead_steps}, launches {r['launches']}  [{smi}]")
    del eng
    torch.cuda.empty_cache()


def phase_paged_burst(cfg, predictor, smi, totals) -> None:
    """The serve-bench burst through ClairvoyantServer with one
    PagedBatchedEngine (4 lanes, page 16, max_len 512) under FCFS and
    SJF: every response ok, short and long P50 per policy."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import PagedBatchedEngine
    from repro_torch.serving.openai_api import CompletionRequest
    from repro_torch.serving.server import ClairvoyantServer

    pool, longs, shorts = _burst_pool()
    order = longs + shorts
    eng = PagedBatchedEngine(cfg, max_len=MAX_LEN, segment_len=SEGMENT,
                             n_lanes=L_LANES, page_size=L_PAGE, seed=0)
    eng.generate_batch([list(range(1, 20))] * L_LANES, 2)   # set-up
    per = {}
    for policy in ("fcfs", "sjf"):
        eng.busy_until = 0.0
        server = ClairvoyantServer(policy=policy, tau=None,
                                   predictor=predictor, engines=[eng])
        ops.reset_launches()
        server.submit_many(
            [CompletionRequest(prompt=pool.prompts[i]) for i in order],
            arrivals=[j * 1e-4 for j in range(len(order))],
            true_output_tokens=[64 if i in longs else 8 for i in order],
            klasses=["long" if i in longs else "short" for i in order])
        w0 = time.monotonic()
        resp = server.drain(max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        wall = time.monotonic() - w0
        launches = dict(ops.LAUNCHES)
        for k, v in launches.items():
            totals[k] += v
        if len(resp) != len(order) or not all(r.ok for r in resp):
            raise AssertionError(f"[paged-burst] {policy}: not every "
                                 "response is ok")
        _check_path(f"[paged-burst] {policy}", launches,
                    ("paged_decode_attention", "flash_attention",
                     "gbdt_margins_packed") if policy == "sjf" else
                    ("paged_decode_attention", "flash_attention"),
                    ("decode_attention", "gbdt_margins"))
        per[policy] = (server.percentile(50, "short") * 1e3,
                       server.percentile(50, "long") * 1e3)
        print(f"[paged-burst] {policy}: short P50 {per[policy][0]:.1f} ms, "
              f"long P50 {per[policy][1]:.1f} ms, "
              f"{sum(r.tokens_generated for r in resp)} tokens in "
              f"{wall:.2f} s, launches {launches}, finish order "
              f"{[r.request_id for r in resp]}  [{smi}]")
    print(f"[paged-burst] SJF short P50 {per['sjf'][0]:.1f} ms vs FCFS "
          f"{per['fcfs'][0]:.1f} ms: "
          f"{100 * (1 - per['sjf'][0] / per['fcfs'][0]):.1f}% lower  [{smi}]")
    phase_profile_lanes(eng, smi)
    del eng
    torch.cuda.empty_cache()


def phase_profile_lanes(eng, smi) -> None:
    """Where a lane step's time goes: kernels per step and the device's
    busy share while 4 lanes decode 8 steps together."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prompts = [list(range(3 + i, 3 + i + 24)) for i in range(L_LANES)]
    eng.generate_batch(prompts, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate_batch(prompts, 9)
        torch.cuda.synchronize()
    events = prof.events()
    busy = _busy_us(events)
    if busy is None:
        print("[profile-lanes] device busy share: not measured (the "
              "profiler recorded no CUDA kernel)")
        return
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    print(f"[profile-lanes] {L_LANES} lanes x (prefill + 8 decode steps), "
          f"paged, profiler on: {len(kernels)} kernels (~"
          f"{len(kernels) / 9:.0f} per step), device busy {busy / 1e3:.2f} "
          f"ms of {span / 1e3:.2f} ms traced ({100 * busy / span:.1f}% busy, "
          f"{100 - 100 * busy / span:.1f}% idle)  [{smi}]")
    per_kernel = {}
    for e in kernels:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile-lanes]   {us / 1e3:8.3f} ms  {name[:90]}")


def _burst_pool(n_long=N_LONG, n_short=N_SHORT):
    """The serve-bench burst's prompts: ``n_long`` long then ``n_short``
    short sharegpt-profile prompts."""
    from repro_torch.data.corpus import sample_dataset
    pool = sample_dataset("sharegpt", n=4000, seed=1)
    shorts = [i for i in range(len(pool)) if pool.lengths[i] < 120][:n_short]
    longs = [i for i in range(len(pool)) if pool.lengths[i] >= 1000][:n_long]
    return pool, longs, shorts


def phase_launch_serve(smi, totals) -> None:
    """``repro_torch.launch.serve.main`` (the queueing CLI: virtual-time
    ``SimEngine`` replicas on the gemma3-4b-edge service model, priced at
    the H100's data-sheet peaks) under fcfs, sjf and srpt on a 100-request
    burst, and under sjf at rho 0.74.  The predictor scores each burst in
    one K5 launch on the card (the packed layout, as the JAX model
    scores); srpt must drain through the preemptive DES."""
    import io
    from repro_torch.core import _native
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.server import ClairvoyantServer

    preemptive_drains = []
    orig = ClairvoyantServer._drain_sim_preemptive

    def spy(self, rep, eng):
        preemptive_drains.append(self.policy)
        return orig(self, rep, eng)

    ClairvoyantServer._drain_sim_preemptive = spy
    p50 = {}
    try:
        for policy, rho in (("fcfs", 0.0), ("sjf", 0.0), ("srpt", 0.0),
                            ("sjf", 0.74)):
            ops.reset_launches()
            preemptive_drains.clear()
            out = io.StringIO()
            w0 = time.monotonic()
            with contextlib.redirect_stdout(out):
                srv = serve.main(["--policy", policy, "--requests", "100",
                                  "--rho", str(rho)])
            wall = time.monotonic() - w0
            launches = dict(ops.LAUNCHES)
            for k, v in launches.items():
                totals[k] += v
            for line in out.getvalue().splitlines():
                print(f"[launch-serve]   {line}")
            if len(srv.ok_responses) != 100:
                raise AssertionError(f"[launch-serve] {policy}: "
                                     f"{len(srv.ok_responses)} of 100 ok")
            want_k5 = 1 if srv.policy_obj.uses_predictor else 0
            if launches["gbdt_margins_packed"] != want_k5 \
                    or launches["gbdt_margins"]:
                raise AssertionError(f"[launch-serve] {policy}: launches "
                                     f"{launches}, expected {want_k5} K5 "
                                     "and no K4")
            if (policy == "srpt") != bool(preemptive_drains):
                raise AssertionError(f"[launch-serve] {policy}: preemptive "
                                     f"drains {preemptive_drains}")
            if rho == 0.0:
                p50[policy] = srv.percentile(50, "short")
            pct = " ".join(
                f"{c} P50/P95/P99 " + "/".join(
                    f"{srv.percentile(q, c):.3f}" for q in (50, 95, 99))
                + " s" for c in ("short", "medium", "long"))
            print(f"[launch-serve] {policy} rho {rho}: tau "
                  f"{srv.router.replicas[0].queue.tau:.3f} s, {pct}, K5 "
                  f"launches {launches['gbdt_margins_packed']}, drain "
                  f"{'_drain_sim_preemptive' if preemptive_drains else '_drain_sim'}"
                  f" (DES engine: {_native.des_engine()}), {wall:.2f} s "
                  f"wall  [{smi}]")
    finally:
        ClairvoyantServer._drain_sim_preemptive = orig
    if not p50["sjf"] < p50["fcfs"]:
        raise AssertionError(f"[launch-serve] SJF short P50 {p50['sjf']} s "
                             f"not below FCFS's {p50['fcfs']} s")
    print(f"[launch-serve] burst short P50: SJF {p50['sjf']:.3f} s vs FCFS "
          f"{p50['fcfs']:.3f} s ({100 * (1 - p50['sjf'] / p50['fcfs']):.1f}"
          f"% lower), srpt {p50['srpt']:.3f} s (virtual time)  [{smi}]")


def _start_child(args):
    """``python -m repro_torch.launch.sidecar ARGS`` from the checkout, its
    output read line by line on a thread.  Returns (process, lines queue,
    bound port)."""
    import queue
    import re
    import threading
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sidecar", "--port", "0",
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()

    def pump():
        for line in child.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        m = re.search(r"listening on http://[\d.]+:(\d+)", line)
        if m:
            print(f"[launch-sidecar]   {line}")
            return child, lines, int(m.group(1))
        print(f"[launch-sidecar]   {line}")
    child.kill()
    child.wait()
    raise AssertionError("[launch-sidecar] the child never listened")


def _stop_child(child, lines) -> list:
    """SIGTERM the child, wait for it (120 s at most) and return the lines
    it printed after listening."""
    import signal
    child.send_signal(signal.SIGTERM)
    try:
        child.wait(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    out = []
    while True:
        line = lines.get(timeout=30)
        if line is None:
            return out
        out.append(line)


def phase_launch_sidecar(smi, totals) -> None:
    """``python -m repro_torch.launch.sidecar --port 0`` as a child process:
    the real backend (smollm-360m at full width on the card, the
    predictor scoring each admission through K5) under fcfs and sjf, then
    the sim backend likewise, each sim child beside the real child of its
    policy.  The serve-bench burst goes over HTTP (2 ms apart, half as SSE
    streams), then SIGTERM: the child must drain all 16 requests ok and
    exit 0, and SJF's short P50 over the wire must be below FCFS's."""
    import asyncio
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    pool, longs, shorts = _burst_pool()
    order = longs + shorts

    async def burst(port):
        async def client(j, i):
            await asyncio.sleep(j * 0.002)
            n = 64 if i in longs else 8
            t0 = time.monotonic()
            out = await _http(port, {
                "messages": [{"role": "user", "content": pool.prompts[i]}],
                "max_tokens": n, "output_tokens": n,
                "stream": j % 2 == 1})
            return i, time.monotonic() - t0, out
        return await asyncio.wait_for(asyncio.gather(
            *[client(j, i) for j, i in enumerate(order)]), 600.0)

    def child_run(backend, extra, policy) -> float:
        """One child: listen, the burst, SIGTERM; its checks.  Returns
        the short P50 over the wire (ms)."""
        w0 = time.monotonic()
        child, lines, port = _start_child(
            ["--backend", backend, "--policy", policy, *extra])
        t_ready = time.monotonic() - w0
        try:
            outs = asyncio.run(burst(port))
        finally:
            report = _stop_child(child, lines)
        for line in report:
            print(f"[launch-sidecar]   {line}")
        bad = [(i, kind, st) for i, _, (kind, st, _) in outs
               if st != 200 or kind not in ("json", "sse")]
        drained = [ln for ln in report if ln.startswith("drained: ")]
        if bad or child.returncode != 0 or not drained \
                or not drained[0].startswith(
                    f"drained: {len(order)} terminals "
                    f"({len(order)} ok)"):
            raise AssertionError(
                f"[launch-sidecar] {backend} {policy}: exit "
                f"{child.returncode}, not ok {bad}, report {report}")
        for i, _, (kind, _, obj) in outs:
            n = len(_wire_tokens(kind, obj))
            if n != (64 if i in longs else 8):
                raise AssertionError(f"[launch-sidecar] {backend} "
                                     f"{policy}: {n} tokens for "
                                     f"prompt {i}")
        launched = [ln for ln in report
                    if ln.startswith("kernel launches: ")]
        launches = json.loads(launched[0][len("kernel launches: "):])
        if backend == "real":
            for k, v in launches.items():
                totals[k] += v
            run = ("decode_attention", "flash_attention") + (
                ("gbdt_margins_packed",) if policy == "sjf" else ())
            _check_path(f"[launch-sidecar] real {policy}", launches,
                        run, ("paged_decode_attention", "gbdt_margins"))
            # one K5 launch an admission, and one more for the CLI's
            # scorer warm-up before it listens
            if policy == "sjf" and \
                    launches["gbdt_margins_packed"] != len(order) + 1:
                raise AssertionError(
                    f"[launch-sidecar] {launches['gbdt_margins_packed']}"
                    f" K5 launches for {len(order)} SJF admissions and "
                    "the warm-up")
        soj = {c: [t for i, t, _ in outs if (i in longs) == (c == "long")]
               for c in ("short", "long")}
        p50 = float(np.median(soj["short"])) * 1e3
        print(f"[launch-sidecar] {backend} {policy}: listening after "
              f"{t_ready:.1f} s, short P50 {p50:.1f} ms, long "
              f"P50 {float(np.median(soj['long'])) * 1e3:.1f} ms over "
              f"the wire, {len(order)} ok ({len(order) // 2} SSE), "
              f"drained on SIGTERM, exit 0, child launches {launches}, "
              f"{time.monotonic() - w0:.1f} s  [{smi}]")
        return p50

    # each real child runs beside the sim child of its policy (both
    # host-bound; the sim one uses the card only for K5), so FCFS and
    # SJF share the host alike
    p50 = {"real": {}, "sim": {}}
    with ThreadPoolExecutor(1) as ex:
        for policy in ("fcfs", "sjf"):
            side = ex.submit(child_run, "sim", ["--time-scale", "0.5"],
                             policy)
            p50["real"][policy] = child_run("real", [], policy)
            p50["sim"][policy] = side.result()
    for backend, pb in p50.items():
        if not pb["sjf"] < pb["fcfs"]:
            raise AssertionError(f"[launch-sidecar] {backend}: SJF short P50 "
                                 f"{pb['sjf']:.1f} ms not below FCFS's "
                                 f"{pb['fcfs']:.1f} ms")
        print(f"[launch-sidecar] {backend}: SJF short P50 over the wire "
              f"{100 * (1 - pb['sjf'] / pb['fcfs']):.1f}% below FCFS's  "
              f"[{smi}]")

    _launch_sidecar_speculative(burst, order, longs, smi, totals)


def _launch_sidecar_speculative(burst, order, longs, smi, totals) -> None:
    """The speculative child: ``--backend real --speculative --policy
    sjf``, each replica's engine decoding draft-verify (the default draft:
    the target's own config, seeded with ``--seed``).  The burst over
    HTTP, a ``/metrics`` scrape, then SIGTERM: all ok, ``drained: 16
    terminals (16 ok)``, exit 0, and the accept-rate gauge above 0."""
    import asyncio
    import numpy as np
    from repro_torch.serving.observability import parse_prometheus
    w0 = time.monotonic()
    child, lines, port = _start_child(["--backend", "real", "--speculative",
                                       "--policy", "sjf"])
    t_ready = time.monotonic() - w0
    try:
        outs = asyncio.run(burst(port))
        _, st, text = asyncio.run(_http(port, method="GET",
                                        path="/metrics"))
    finally:
        report = _stop_child(child, lines)
    for line in report:
        print(f"[launch-sidecar]   {line}")
    rates = [v for _, _, v in parse_prometheus(text).get(
        "clairvoyant_speculative_accept_rate", [])] if st == 200 else []
    bad = [(i, kind, code) for i, _, (kind, code, _) in outs
           if code != 200 or kind not in ("json", "sse")]
    short = [i for i, _, (kind, _, obj) in outs
             if len(_wire_tokens(kind, obj)) != (64 if i in longs else 8)]
    drained = [ln for ln in report if ln.startswith("drained: ")]
    if bad or short or child.returncode != 0 or not drained \
            or not drained[0].startswith(f"drained: {len(order)} terminals "
                                         f"({len(order)} ok)") \
            or not rates or not all(r > 0 for r in rates):
        raise AssertionError(
            f"[launch-sidecar] real --speculative sjf: exit "
            f"{child.returncode}, not ok {bad}, short streams {short}, "
            f"accept-rate gauge {rates}, report {report}")
    launched = [ln for ln in report if ln.startswith("kernel launches: ")]
    launches = json.loads(launched[0][len("kernel launches: "):])
    for k, v in launches.items():
        totals[k] += v
    _check_path("[launch-sidecar] real --speculative sjf", launches,
                ("decode_attention", "flash_attention", "gbdt_margins_packed"),
                ("paged_decode_attention", "gbdt_margins"))
    soj = [t for i, t, _ in outs if i not in longs]
    print(f"[launch-sidecar] real --speculative sjf: listening after "
          f"{t_ready:.1f} s, {len(order)} ok ({len(order) // 2} SSE), "
          f"/metrics clairvoyant_speculative_accept_rate {rates}, short P50 "
          f"{float(np.median(soj)) * 1e3:.1f} ms over the wire, drained on "
          f"SIGTERM, exit 0, child launches {launches}, "
          f"{time.monotonic() - w0:.1f} s  [{smi}]")


def phase_preempt(cfg, predictor, smi, totals) -> None:
    """Live preemption at full width: the burst longs first (3 long, 5
    short, arrivals 1e-6 s apart) through ``ClairvoyantServer`` under
    ``srpt`` with the serial ``RealEngine``.  A short evicts the decoding
    long at a segment boundary; the long resumes by re-prefilling prompt +
    generated prefix.  Every request ok with its full budget; in float32
    (TF32 off) each resumed request's tokens equal an uninterrupted
    decode's; in bf16 the agreement is printed."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import RealEngine
    from repro_torch.serving.openai_api import CompletionRequest
    from repro_torch.serving.server import ClairvoyantServer
    pool, longs, shorts = _burst_pool(3, 5)
    order = longs + shorts
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        eng = RealEngine(c, max_len=MAX_LEN, segment_len=SEGMENT, seed=0)
        eng.generate(list(range(1, 20)), max_new_tokens=2)   # set-up
        server = ClairvoyantServer(policy="srpt", tau=None,
                                   predictor=predictor, engines=[eng])
        evicted = []
        requeue = server._requeue_evicted

        def spy(rep, req, *a, _requeue=requeue):
            evicted.append(req.req_id)
            return _requeue(rep, req, *a)

        server._requeue_evicted = spy
        ops.reset_launches()
        server.submit_many(
            [CompletionRequest(prompt=pool.prompts[i]) for i in order],
            arrivals=[j * 1e-6 for j in range(len(order))],
            true_output_tokens=[64 if i in longs else 8 for i in order],
            klasses=["long" if i in longs else "short" for i in order])
        w0 = time.monotonic()
        resp = server.drain(max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
        wall = time.monotonic() - w0
        launches = dict(ops.LAUNCHES)
        for k, v in launches.items():
            totals[k] += v
        _check_path(f"[preempt] {dtype}", launches,
                    ("decode_attention", "flash_attention",
                     "gbdt_margins_packed"),
                    ("paged_decode_attention", "gbdt_margins"))
        pre = server.router.replicas[0].queue.stats["preemptions"]
        budgets = {j + 1: 64 if i in longs else 8 for j, i in enumerate(order)}
        if len(resp) != len(order) or not all(r.ok for r in resp) \
                or any(r.tokens_generated != budgets[r.request_id]
                       for r in resp) or pre < 1 or not evicted:
            raise AssertionError(
                f"[preempt] {dtype}: preemptions {pre}, responses "
                f"{[(r.request_id, r.status, r.tokens_generated) for r in resp]}")
        by_id = {r.request_id: r for r in resp}
        agree = []
        for rid in sorted(set(evicted)):
            prompt = pool.prompts[order[rid - 1]]
            n = budgets[rid]
            ids = server._tokenizer.encode(prompt)[:max(1, eng.max_len - n)]
            want = eng.generate(ids, max_new_tokens=n)["tokens"]
            agree.append(by_id[rid].token_ids == list(want))
        if dtype == "float32" and not all(agree):
            raise AssertionError(f"[preempt] float32: resumed tokens differ "
                                 f"from an uninterrupted decode: evicted "
                                 f"{sorted(set(evicted))}, agree {agree}")
        finish = [(r.request_id, r.klass[0]) for r in resp]
        print(f"[preempt] {dtype}: srpt, {len(order)} requests ok with full "
              f"budgets, {pre} preemptions (evicted requests "
              f"{sorted(set(evicted))}), resumed == uninterrupted tokens "
              f"{sum(agree)}/{len(agree)}, finish order {finish}, short P50 "
              f"{server.percentile(50, 'short') * 1e3:.1f} ms, long P50 "
              f"{server.percentile(50, 'long') * 1e3:.1f} ms, {wall:.2f} s, "
              f"launches {launches}  [{smi}]")
        del eng, server
        torch.cuda.empty_cache()


def phase_lanes_faults(cfg, smi, totals) -> None:
    """The paging benchmark's backlog (as text prompts) through
    ``ClairvoyantServer`` with ring lanes, then paged lanes, under one
    fault plan each (a lane crash at the 3rd segment boundary, a transient
    at time 0, a whole-engine crash at the 9th boundary) and a sojourn
    deadline on the second long (``FAULT_DEADLINE_S``: it is admitted at
    once and expires in service).  The lane drain leaves the transient to
    the serial drains, as the JAX lane drain does, so it must not fire.
    Every request must end in exactly one terminal status (none lost), at
    least one ``timeout``; paged lanes launch K2 and never K1."""
    import collections
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.faults import FaultPlan, FaultSpec, RetryPolicy
    from repro_torch.serving.openai_api import CompletionRequest
    from repro_torch.serving.server import ClairvoyantServer
    pool, longs, shorts = _burst_pool(PATTERN.count("L"), PATTERN.count("S"))
    it = {"L": iter(longs), "S": iter(shorts)}
    picks = [(next(it[c]), c) for c in PATTERN]
    ring, paged = _lane_engines(cfg)
    for name, eng in (("ring", ring), ("paged", paged)):
        plan = FaultPlan([
            FaultSpec(kind="lane_crash", after_polls=3, replica=0),
            FaultSpec(kind="transient", at=0.0, replica=0),
            FaultSpec(kind="crash", after_polls=9, replica=0, repair_s=0.0)])
        server = ClairvoyantServer(policy="fcfs", tau=None, engines=[eng],
                                   fault_plan=plan,
                                   retry=RetryPolicy(max_retries=4, seed=0),
                                   deadline_mode="sojourn", seed=0)
        for j, (i, c) in enumerate(picks):
            server.submit(CompletionRequest(prompt=pool.prompts[i]),
                          true_output_tokens=L_LONG if c == "L" else L_SHORT,
                          klass="long" if c == "L" else "short",
                          deadline_s=FAULT_DEADLINE_S if j == 1 else None)
        ops.reset_launches()
        w0 = time.monotonic()
        resp = server.drain(max_new_tokens=L_LONG)
        torch.cuda.synchronize()
        wall = time.monotonic() - w0
        eng.fault_injector = None
        launches = dict(ops.LAUNCHES)
        for k, v in launches.items():
            totals[k] += v
        ids = [r.request_id for r in resp]
        statuses = collections.Counter(r.status for r in resp)
        if sorted(ids) != list(range(1, len(picks) + 1)) \
                or sorted(server._terminal) != sorted(ids) \
                or server._inflight or server.queue.live():
            raise AssertionError(f"[lanes-faults] {name}: terminals {ids}, "
                                 f"in flight {list(server._inflight)}")
        if statuses["timeout"] < 1 or server.fault_stats["crashes"] < 2 \
                or server.fault_stats["transients"] != 0:
            raise AssertionError(f"[lanes-faults] {name}: statuses "
                                 f"{dict(statuses)}, fault_stats "
                                 f"{server.fault_stats}")
        if name == "paged":
            _check_path("[lanes-faults] paged", launches,
                        ("paged_decode_attention", "flash_attention"),
                        ("decode_attention",))
        else:
            _check_path("[lanes-faults] ring", launches,
                        ("decode_attention", "flash_attention"),
                        ("paged_decode_attention",))
        print(f"[lanes-faults] {name}: {len(resp)} requests, one terminal "
              f"each, none lost: {dict(statuses)}; fault_stats "
              f"{ {k: v for k, v in server.fault_stats.items() if v} }, "
              f"{wall:.2f} s, launches {launches}  [{smi}]")
    del ring, paged
    torch.cuda.empty_cache()


# ------------------------------------------------- sweeps, ranking, drafts
#: Fig. 3's grid (benchmarks/fig3_rho_sweep.py:21-30): FCFS and SJF with
#: the tau = 3 x E[S_short] guard, five loads, five seeds, 2,000 requests
FIG3_RHOS = (0.3, 0.5, 0.74, 0.85, 0.95)
SPEC_K = 4


def _same_metrics(name, got, want) -> None:
    import numpy as np
    for m in want:
        if not np.array_equal(np.asarray(got[m]), np.asarray(want[m]),
                              equal_nan=True):
            raise AssertionError(f"[sweep] {name}: metric {m} differs "
                                 "between backend='torch' and 'auto'")


def phase_sweep(smi) -> None:
    """The paper's sweep grids through ``core.sweep``: Fig. 3's grid
    (fcfs / sjf at tau 10.5 x 5 rhos x 5 seeds, n 2,000, the RTX 4090
    service model, mix 0.5) and Table 8's burst (50 short + 50 long in
    50 ms, fcfs / sjf / sjf_oracle, 5 runs) with the grid DES on the card
    (``backend="torch"``, float64) and on the host C engine
    (``backend="auto"``); then one grid that mixes srpt rows with
    key-based rows.  Every metric must be equal bit for bit between the
    backends, and the srpt rows must run on the host preemptive engine."""
    import numpy as np
    import torch
    from repro_torch.core import sim_torch, sweep
    from repro_torch.core.sim_fast import RequestBatch
    from repro_torch.serving.service_time import (PAPER_4090_LONG,
                                                  PAPER_4090_SHORT)
    S, L = PAPER_4090_SHORT, PAPER_4090_LONG
    tau = 3.0 * S.mean
    conds = [("fcfs", None), ("sjf", tau)]
    grids = {
        "fig3": lambda **kw: sweep.sweep_poisson(
            conds, rhos=FIG3_RHOS, seeds=range(5), n=2000, short=S,
            long=L, mix_long=0.5, **kw),
        "table8": lambda **kw: sweep.sweep_burst(
            [("fcfs", None), ("sjf", None), ("sjf_oracle", None)],
            seeds=range(5), n_short=50, n_long=50, short=S, long=L, **kw)}
    sweep.sweep_poisson(conds, rhos=(0.5,), seeds=(0,), n=50, short=S,
                        long=L, backend="torch", device="cuda")  # set-up
    res = {}
    for name, run in grids.items():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        dev = run(backend="torch", device="cuda")
        t_dev = time.monotonic() - t0
        t0 = time.monotonic()
        host = run(backend="auto")
        t_host = time.monotonic() - t0
        _same_metrics(name, dev.metrics, host.metrics)
        res[name] = dev
        G = len(dev.conditions) * len(dev.rhos) * len(dev.seeds)
        print(f"[sweep] {name}: {G} cells, backend='torch' (cuda, float64) "
              f"{t_dev:.3f} s, backend='auto' (host C engine) {t_host:.3f} "
              f"s, all {len(dev.metrics)} metrics equal bit for bit  "
              f"[{smi}]")
    sp50 = res["fig3"].metric("short_p50")               # (2, R, S)
    cut = 100.0 * (1.0 - sp50[1] / sp50[0])
    print("[sweep] fig3 SJF short-P50 reduction by rho (mean of 5 "
          "seeds): " + ", ".join(f"{r}: {cut[i].mean():.1f}%"
                                 for i, r in enumerate(FIG3_RHOS)))
    t8 = res["table8"].metric("short_p50")[:, 0]          # (3, seeds)
    print(f"[sweep] table8 burst short P50 (mean of 5 runs): fcfs "
          f"{t8[0].mean():.2f} s, sjf {t8[1].mean():.2f} s "
          f"({100 * (1 - t8[1].mean() / t8[0].mean()):.1f}% lower), "
          f"sjf_oracle {t8[2].mean():.2f} s")

    rows = {"torch": 0, "host_preempt": 0}
    real_dev, real_pre = sim_torch.simulate_grid_torch, \
        sweep.simulate_grid_preempt

    def dev_spy(arrival, *a, **kw):
        rows["torch"] += arrival.shape[0]
        return real_dev(arrival, *a, **kw)

    def pre_spy(arrival, *a, **kw):
        rows["host_preempt"] += arrival.shape[0]
        return real_pre(arrival, *a, **kw)

    mixed = [("fcfs", None), ("sjf", tau), ("srpt", None)]
    batches = [RequestBatch.poisson(np.random.default_rng(s), 2000,
                                    0.85 / (0.5 * (S.mean + L.mean)), S, L)
               for s in range(5)]
    sim_torch.simulate_grid_torch, sweep.simulate_grid_preempt = \
        dev_spy, pre_spy
    try:
        dev = sweep.sweep_batches(batches, mixed, backend="torch",
                                  device="cuda")
    finally:
        sim_torch.simulate_grid_torch, sweep.simulate_grid_preempt = \
            real_dev, real_pre
    _same_metrics("mixed", dev, sweep.sweep_batches(batches, mixed))
    if rows != {"torch": 10, "host_preempt": 5}:
        raise AssertionError(f"[sweep] mixed grid routed rows {rows}, "
                             "expected 10 key-based rows on the card and "
                             "5 srpt rows on the host")
    print(f"[sweep] mixed fcfs / sjf / srpt at rho 0.85: {rows['torch']} "
          f"key-based rows on the card, {rows['host_preempt']} srpt rows on "
          f"the host preemptive engine, metrics equal to backend='auto'; "
          f"short P50 fcfs {dev['short_p50'][0].mean():.2f} s, sjf "
          f"{dev['short_p50'][1].mean():.2f} s, srpt "
          f"{dev['short_p50'][2].mean():.2f} s")


def phase_ranking(predictor, smi, totals) -> None:
    """The paper's ranking metric (Algorithm 1) on a held-out, seeded
    sample of the corpus (2,000 sharegpt-profile prompts, seed 7; the
    predictor trained on seed 42): scored in one batch through the
    predictor's entry point (the packed layout, one K5 launch), through
    the dense layout (``predict_margin_dense``, one K4 launch) and through
    the plain walk; ranking and 3-class accuracy must be equal between
    the three, and the two layouts' probabilities within 1e-5."""
    import numpy as np
    import torch
    from repro_torch.core.features import extract_batch
    from repro_torch.core.ranking import (classification_accuracy,
                                          ranking_accuracy)
    from repro_torch.data.corpus import sample_dataset
    from repro_torch.kernels import ops
    ds = sample_dataset("sharegpt", n=2000, seed=7)
    lengths = np.asarray(ds.lengths)
    ops.reset_launches()
    t0 = time.monotonic()
    proba = predictor.proba_batch(ds.prompts)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    X = extract_batch(ds.prompts)
    m = predictor.model.predict_margin_dense(X, device="cuda")
    m = np.exp(m - m.max(axis=1, keepdims=True))
    dense = m / m.sum(axis=1, keepdims=True)
    launches = dict(ops.LAUNCHES)
    for k, v in launches.items():
        totals[k] += v
    if launches["gbdt_margins"] != 1 or launches["gbdt_margins_packed"] != 1:
        raise AssertionError(f"[ranking] launches {launches}: expected one "
                             "K5 and one K4 launch")
    plain = predictor.model.predict_proba(X, device="cpu")
    err = float(np.abs(proba - plain).max())
    err_dense = float(np.abs(proba - dense).max())
    _check("[ranking] packed (K5) vs dense (K4) probabilities", err_dense,
           1e-5)
    acc = {name: (ranking_accuracy(lengths, p[:, 2]),
                  classification_accuracy(lengths, p))
           for name, p in (("K5", proba), ("K4", dense), ("plain", plain))}
    if not acc["K5"] == acc["K4"] == acc["plain"] \
            or not all(map(math.isfinite, acc["K5"])):
        raise AssertionError(f"[ranking] K5 {acc['K5']}, K4 {acc['K4']}, "
                             f"plain {acc['plain']} differ")
    n_s, n_l = int((lengths < 200).sum()), int((lengths >= 800).sum())
    print(f"[ranking] held-out {len(ds)} prompts ({n_s} short, {n_l} long): "
          f"ranking accuracy {100 * acc['K5'][0]:.2f}% (paper 62-96%), "
          f"3-class accuracy {100 * acc['K5'][1]:.2f}%; K5 == K4 == plain "
          f"walk on both (max |P - P_plain| {err:.1e}, |P_K5 - P_K4| "
          f"{err_dense:.1e}); one K5 and one K4 launch, K5 "
          f"{wall * 1e3:.1f} ms incl. features  [{smi}]")


def _count_rounds(dec) -> dict:
    """Wrap a lane decoder's ``run_segment`` to sum the rounds it runs."""
    n = {"rounds": 0}
    real = dec.run_segment

    def run(caches, dev, steps, eos):
        n["rounds"] += steps
        return real(caches, dev, steps, eos)

    dec.run_segment = run
    return n


def phase_speculative(cfg, smi, totals) -> None:
    """Draft-verify decode at full width (K=4; ``cfg``'s layers, 8 from
    ``main``), in float32
    (TF32 off) and in bf16: the serve-bench prompts through a serial
    ``RealEngine`` with an agreeing draft (the same config and seed) and
    with an independent one (another seed, on a subset), then the paging
    backlog through speculative ring and paged lanes (agreeing draft).
    Float32: every token stream must equal the plain engine's; bf16: the
    agreement is printed.  Launches are held exactly: a serial round
    launches K1 (K+1 draft steps + K+1 verify positions) x layers times,
    a paged lane round K1 (K+1) x layers (the draft ring) and K2 (K+1) x
    layers (the verify)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.kernels import ops
    from repro_torch.serving.batching import kv_bytes_per_token
    from repro_torch.serving.engine import (BatchedRealEngine,
                                            PagedBatchedEngine, RealEngine)
    pool, longs, shorts = _burst_pool()
    tok = HashTokenizer(cfg.vocab_size)
    burst = [(tok.encode(pool.prompts[i]), 64 if i in longs else 8)
             for i in longs + shorts]
    subset = [burst[0]] + burst[len(longs):len(longs) + 2]
    K, W, nl = SPEC_K, SPEC_K + 1, cfg.num_layers
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        plain = RealEngine(c, max_len=MAX_LEN, segment_len=SEGMENT, seed=0)
        engines = {"agree": RealEngine(c, max_len=MAX_LEN,
                                       segment_len=SEGMENT, seed=0,
                                       draft_cfg=c, draft_seed=0,
                                       draft_k=K),
                   "indep": RealEngine(c, max_len=MAX_LEN,
                                       segment_len=SEGMENT, seed=0,
                                       draft_cfg=c, draft_seed=1,
                                       draft_k=K)}
        if not torch.equal(engines["agree"].draft_lm.embed, plain.lm.embed):
            raise AssertionError("[speculative] the agreeing draft's "
                                 "weights are not the target's")
        for eng in (plain, *engines.values()):      # first-call set-up
            eng.generate(list(range(1, 20)), max_new_tokens=6)
        runs = {}
        for name, eng, work in (("plain", plain, burst),
                                ("agree", engines["agree"], burst),
                                ("plain-subset", plain, subset),
                                ("indep", engines["indep"], subset)):
            ops.reset_launches()
            t0 = time.monotonic()
            res = [eng.generate(ids, max_new_tokens=m) for ids, m in work]
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = dict(ops.LAUNCHES)
            for k, v in launches.items():
                totals[k] += v
            n_tok = sum(len(r["tokens"]) for r in res)
            runs[name] = {"tokens": [r["tokens"] for r in res],
                          "wall": wall, "n_tok": n_tok,
                          "launches": launches, "res": res}
            if name in ("agree", "indep"):
                rounds = sum(r["segments"] for r in res)
                want = rounds * (K + 1 + W) * nl
                if launches["decode_attention"] != want:
                    raise AssertionError(
                        f"[speculative] {dtype} {name}: "
                        f"{launches['decode_attention']} K1 launches for "
                        f"{rounds} rounds, expected {want}")
                _check_path(f"[speculative] {dtype} {name}", launches,
                            ("decode_attention", "flash_attention"),
                            ("paged_decode_attention",))
                drafted = sum(r["drafted"] for r in res)
                accepted = sum(r["accepted"] for r in res)
                runs[name].update(rounds=rounds, rate=accepted / drafted)
        for name, base in (("agree", "plain"), ("indep", "plain-subset")):
            r, b = runs[name], runs[base]
            same = sum(x == y for x, y in zip(r["tokens"], b["tokens"]))
            if dtype == "float32" and same != len(b["tokens"]):
                raise AssertionError(f"[speculative] float32 {name}: "
                                     f"{same}/{len(b['tokens'])} streams "
                                     "equal plain decode")
            print(f"[speculative] {dtype} serial, {name} draft, K={K}: "
                  f"{len(b['tokens'])} requests, == plain tokens "
                  f"{same}/{len(b['tokens'])}; accept rate "
                  f"{r['rate']:.3f}; {r['rounds']} rounds, "
                  f"{r['n_tok'] / r['rounds']:.2f} tokens a round; "
                  f"{r['wall'] / r['n_tok'] * 1e3:.3f} ms/token vs plain "
                  f"{b['wall'] / b['n_tok'] * 1e3:.3f}; K1 launches a "
                  f"round {r['launches']['decode_attention'] / r['rounds']:.0f}"
                  f" = (K+1 draft steps + {W} verify positions) x {nl}  "
                  f"[{smi}]")
        sd = plain.lm.state_dict()
        del plain, engines
        torch.cuda.empty_cache()

        # lanes: the paging backlog, agreeing draft, a budget of two
        # worst-case speculative longs (target + draft K/V)
        budget = 2 * (L_PROMPT + L_LONG) * 2 * kv_bytes_per_token(c)
        kw = dict(max_len=L_MAX_LEN, segment_len=L_SEGMENT,
                  n_lanes=L_LANES, budget_bytes=budget, state_dict=sd,
                  draft_cfg=c, draft_state_dict=sd, draft_k=K)
        serial = RealEngine(c, state_dict=sd, max_len=L_MAX_LEN,
                            segment_len=L_SEGMENT)
        prompts, maxes = _pattern(cfg.vocab_size, np.random.default_rng(100))
        want = [serial.generate(p, max_new_tokens=m)["tokens"]
                for p, m in zip(prompts, maxes)]
        for name, eng in (("ring", BatchedRealEngine(c, **kw)),
                          ("paged", PagedBatchedEngine(c, page_size=L_PAGE,
                                                       **kw))):
            eng.generate_batch(prompts[:L_LANES], 4)        # set-up
            if name == "paged":
                eng.allocator.drop_cache()
            n = _count_rounds(eng._lane_decoder)
            r = _drain_pattern(eng, prompts, maxes, exact=False)
            for k, v in r["launches"].items():
                totals[k] += v
            R, la = n["rounds"], r["launches"]
            if name == "ring":
                ok = la["decode_attention"] == R * (K + 1 + W) * nl \
                    and la["paged_decode_attention"] == 0
            else:
                ok = la["decode_attention"] == R * (K + 1) * nl \
                    and la["paged_decode_attention"] == R * W * nl
            if not ok or la["flash_attention"] <= 0:
                raise AssertionError(f"[speculative] {dtype} {name} lanes: "
                                     f"launches {la} for {R} rounds")
            same = sum(a == b for a, b in zip(r["tokens"], want))
            pre = r["preempted"]
            if dtype == "float32" and same != len(want):
                raise AssertionError(f"[speculative] float32 {name} lanes: "
                                     f"{same}/{len(want)} streams equal "
                                     "plain decode")
            print(f"[speculative] {dtype} {name} lanes, agreeing draft: "
                  f"{len(want)} requests, == plain serial tokens "
                  f"{same}/{len(want)} (preempted {pre}); accept rate "
                  f"{eng.accept_rate:.3f}, {r['n_tok']} tokens in "
                  f"{r['wall']:.2f} s = {r['tok_s']:.1f} tok/s, short P50 "
                  f"{r['short_p50_ms']:.1f} ms, {R} rounds, dead steps "
                  f"{eng.dead_steps}, launches {la}  [{smi}]")
            del eng
        del serial
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- training
# lr 3e-4: at 3e-3 (the CLI's default) the first 20 steps' loss rises at
# this width, through the kernels, through the plain attention and in
# float32 alike (scripts/train_lr_probe.py)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 512, 20, 3e-4
# the other trained stacks' bf16 runs, B x TRAIN_S tokens a step: gemma3
# at B 4 (its state is 43.4 GiB before activations), the cut vision stack
# at B 2 over its 1024 image rows (Adafactor: bf16 weights and gradients
# are 23.8 GiB), musicgen at B 4
ARCH_TRAIN_B = {"gemma3-4b-edge": 4, "llama-3.2-vision-90b": 2,
                "musicgen-large": 4, "gemma-2b": 4}
ARCH_TRAIN_STEPS = {"gemma3-4b-edge": 10, "llama-3.2-vision-90b": 6,
                    "musicgen-large": 6, "gemma-2b": 10}


K3B_PASSES = (("bwd_dot", "D"), ("bwd_dkdv", "dK/dV"), ("bwd_dq", "dQ"))


def _k3b_pass_ms(fn):
    """Device ms of each K3b pass in one profiled call of ``fn``, and each
    pass's launch record from the profiler's trace: registers a thread,
    warps an SM and the profiler's estimate of achieved occupancy (from
    the grid and the kernel's resources, not a hardware counter)."""
    import tempfile
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {tag: 0.0 for _, tag in K3B_PASSES}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for key, tag in K3B_PASSES:
            if key in e.name:
                out[tag] += (e.time_range.end - e.time_range.start) / 1e3
    occupancy = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k3b_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    for ev in events:
        args = ev.get("args", {})
        for key, tag in K3B_PASSES:
            if ev.get("cat") == "kernel" and key in ev.get("name", ""):
                occupancy[tag] = tuple(args.get(k) for k in (
                    "registers per thread", "warps per SM",
                    "est. achieved occupancy %"))
    return out, occupancy


def _k3b_ptxas_lines(log: str):
    """(kernel, its register and spill lines) for each K3b kernel entry of
    an ``nvcc -Xptxas -v`` log, the lines as ptxas prints them."""
    out, dtype = [], {None: "", "f": ", f32", "13__nv_bfloat16": ", bf16"}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'\S*?(bwd_[a-z_]+kernel)ILi(\d+)E"
                          r"(13__nv_bfloat16|f)?", line)
            out.append((m and f"{m[1]}<{m[2]}{dtype[m[3]]}>", []))
        elif out and ("Used" in line or "spill" in line):
            out[-1][1].append(line.split(" : ")[-1].strip())
    return [(name, lines) for name, lines in out if name]


def _wide_ptxas_lines(log: str):
    """(kernel, its register and spill lines) for each instance of K3's
    wgmma kernel (head widths 64, 128 and 256) and K1/K2's tensor-core
    body (128 and 256) in an ``nvcc -Xptxas -v`` log, the lines as ptxas
    prints them."""
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'\S*?(flash_wgmma_kernel|decode_tc_kernel)ILi"
                          r"(\d+)E(?:Lb([01])E|Li([12])E)?", line)
            out.append((m and f"{m[1]}<{m[2]}"
                        + {None: "", "0": ", ring", "1": ", paged"}[m[3]]
                        + (f", {m[4]} warpgroup{'s' * (m[4] == '2')}"
                           if m[4] else "") + ">", []))
        elif out and ("Used" in line or "spill" in line):
            out[-1][1].append(line.split(" : ")[-1].strip())
    return [(name, lines) for name, lines in out if name]


def _k3b_errs(tag, got, want, tol=None) -> float:
    """Largest max|got - want| / max(max|want|, 1) over dq, dk, dv (the
    gradients are not O(1)); each is held to ``tol`` when one is given."""
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = _max_err(a, b) / max(float(b.float().abs().max()), 1.0)
        if tol is not None:
            _check(f"K3b {name} {tag}", err, tol)
        worst = max(worst, err)
    return worst


def _sdpa_bwd(q, k, v, do, causal=True):
    """Autograd's backward of (causal) ``scaled_dot_product_attention`` on
    the same inputs (K/V expanded to every query head): the yardstick,
    timed only."""
    import torch
    G = q.shape[2] // k.shape[2]
    qx, kx, vx = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k.repeat_interleave(G, dim=2),
                            v.repeat_interleave(G, dim=2)))
    ox = torch.nn.functional.scaled_dot_product_attention(qx, kx, vx,
                                                          is_causal=causal)
    dox = do.transpose(1, 2)
    return lambda: torch.autograd.grad(ox, (qx, kx, vx), dox,
                                       retain_graph=True)


def phase_flash_bwd_kernel(gen) -> dict:
    """K3b against its plain version on K3's own o and lse (f32 with TF32
    off and bf16; hd 64, 16 and 128; S 16, 48, 128, 512 and a ragged
    1000; B 2, H 15 over KV 5), bf16 also against the plain version that
    rounds P and dS to bf16 where the kernel does; K3's lse against the
    plain logsumexp and its output with a null lse bit-equal to the output
    with one, two K3b calls bit-equal; the ``-Xptxas -v`` lines of each
    K3b kernel; then K3b at B 8, bf16, causal, S 128, 512 (the train
    step's shape) and 1000, held against both plain versions and timed
    beside autograd's SDPA backward, its plain version timed at S 512, and
    each pass's device ms at S 512 from one profiled call.
    Tolerances: K3b within TOL x max|plain| (gradients are not O(1)); the
    lse within 1e-4 (f32) and 1e-3 (bf16)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    report = _build.PTXAS_REPORT.get("flash_attention_bwd")
    if report is None:
        print("[K3b flash_attention_bwd] ptxas: not rebuilt in this run")
    else:
        for name, lines in _k3b_ptxas_lines(report):
            print(f"[K3b flash_attention_bwd] ptxas {name}: "
                  + "; ".join(lines))
    H, KV = 15, 5
    errs, rounded, lse_errs = {}, {}, {}
    for hd, S in ((64, 16), (64, 48), (64, 128), (64, 512), (64, 1000),
                  (16, 128), (16, 512), (16, 1000), (128, 128), (128, 512),
                  (128, 1000)):
        for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q = torch.randn(2, S, H, hd, generator=gen, device="cuda").to(dt)
            k = torch.randn(2, S, KV, hd, generator=gen, device="cuda").to(dt)
            v = torch.randn(2, S, KV, hd, generator=gen, device="cuda").to(dt)
            do = torch.randn(2, S, H, hd, generator=gen, device="cuda").to(dt)
            o, lse = flash_attention_cuda(q, k, v, return_lse=True)
            if not torch.equal(o, flash_attention_cuda(q, k, v)):
                raise AssertionError(f"K3 output with lse differs from K3 "
                                     f"without ({label} hd {hd} S {S})")
            _, want_lse = flash_attention_plain(q, k, v, return_lse=True)
            lerr = _max_err(lse, want_lse)
            _check(f"K3 lse {label} hd {hd} S {S}", lerr,
                   1e-4 if label == "f32" else 1e-3)
            lse_errs[(label, hd, S)] = lerr
            got = flash_attention_bwd_cuda(q, k, v, o, do, lse)
            want = flash_attention_bwd_plain(q, k, v, o, do, lse)
            errs[(label, hd, S)] = _k3b_errs(f"{label} hd {hd} S {S}", got,
                                             want, TOL[label])
            if label == "bf16":
                rounded[(label, hd, S)] = _k3b_errs(
                    f"{label} hd {hd} S {S}", got, flash_attention_bwd_plain(
                        q, k, v, o, do, lse, round_dtype=torch.bfloat16))
            if hd == 64 and S == 1000:
                again = flash_attention_bwd_cuda(q, k, v, o, do, lse)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"K3b not deterministic ({label})")
    print("[K3b flash_attention_bwd] max|err|/max|plain| " + " ".join(
        f"{l}/hd{h}@S={s}:{e:.2e}" for (l, h, s), e in errs.items()))
    print("[K3b flash_attention_bwd] bf16 against the plain version rounding "
          "P and dS to bf16 (beside against f32 P, dS): " + " ".join(
              f"hd{h}@S={s}:{e:.2e} ({errs[(l, h, s)]:.2e})"
              for (l, h, s), e in rounded.items()))
    print("[K3b flash_attention_bwd] K3 lse max|err| " + " ".join(
        f"{l}/hd{h}@S={s}:{e:.2e}" for (l, h, s), e in lse_errs.items())
          + "; K3 with a null lse == K3 with an lse, bitwise; two K3b "
          "calls bitwise equal")

    B, hd, dt = TRAIN_B, 64, torch.bfloat16
    entry = None
    for S in (128, TRAIN_S, 1000):
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dt)
        do = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)

        def kernel():
            return flash_attention_bwd_cuda(q, k, v, o, do, lse)
        got = kernel()
        tag = f"bf16 B{B} hd {hd} S {S}"
        rel = _k3b_errs(tag, got, flash_attention_bwd_plain(
            q, k, v, o, do, lse), TOL["bf16"])
        rel_r = _k3b_errs(tag, got, flash_attention_bwd_plain(
            q, k, v, o, do, lse, round_dtype=torch.bfloat16))
        errs[(f"bf16/B{B}", hd, S)] = rel
        del got
        lib_fn = _sdpa_bwd(q, k, v, do)
        ms = _device_ms(kernel)
        lib = _device_ms(lib_fn)
        ms = (ms + _device_ms(kernel)) / 2          # kernel, sdpa, kernel
        n_bytes = ((4 * B * S * H * hd + 4 * B * S * KV * hd) * 2
                   + B * H * S * 4)
        bound, by = _bound(n_bytes, 10 * B * H * hd * S * (S + 1) / 2, dt)
        line = (f"[K3b flash_attention_bwd] bf16 causal B{B} S{S} H{H} "
                f"KV{KV} hd{hd}: max|err|/max|plain| {rel:.2e} (against "
                f"the plain version rounding P and dS {rel_r:.2e}); "
                f"device ms kernel {ms:.4f}, sdpa backward "
                f"{lib:.4f}, kernel/sdpa-bwd {ms / lib:.2f}; bound "
                f"{bound * 1e3:.3f} us ({by}, {n_bytes / 1e6:.1f} MB), "
                f"bound share {100 * bound / ms:.2f}%")
        if S == TRAIN_S:
            plain = _device_ms(lambda: flash_attention_bwd_plain(
                q, k, v, o, do, lse), iters=5)
            passes, occupancy = _k3b_pass_ms(kernel)
            line += (f"; plain {plain:.4f}; one profiled call: " + ", ".join(
                f"{tag} {t:.4f}" for tag, t in passes.items()) + " ms; "
                "registers a thread / warps an SM / est. achieved "
                "occupancy % (profiler): " + ", ".join(
                    f"{tag} {' / '.join(map(str, o))}"
                    for tag, o in occupancy.items()))
            entry = {"name": "flash_attention_bwd", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                     "replaces": "src/repro/models/attention.py:119",
                     "max_abs_err": None, "ms": ms,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "library_ms": lib}
        print(line)
        del q, k, v, do, o, lse, lib_fn
    entry["max_abs_err"] = max(errs.values())
    return entry


#: K3b at the other trained stacks' heads, each at its bf16 train step's
#: shape: (entry name, model, launch counter, B, Sq, Skv, (H, KV, hd),
#: causal, the lengths also checked at B 2)
K3B_INSTANCES = (
    ("flash_attention_bwd_hd256", "gemma3-4b-edge", "flash_attention_bwd",
     ARCH_TRAIN_B["gemma3-4b-edge"], TRAIN_S, TRAIN_S, GEMMA_HEADS, True,
     ((128, 128), (TRAIN_S, TRAIN_S))),
    ("flash_attention_bwd_vision_cross", "llama-3.2-vision-90b",
     "flash_attention_bwd_cross", ARCH_TRAIN_B["llama-3.2-vision-90b"],
     TRAIN_S, IMAGE_ROWS, VISION_HEADS, False, ((TRAIN_S, IMAGE_ROWS),)),
    ("flash_attention_bwd_vision", "llama-3.2-vision-90b",
     "flash_attention_bwd", ARCH_TRAIN_B["llama-3.2-vision-90b"], TRAIN_S,
     TRAIN_S, VISION_HEADS, True, ((TRAIN_S, TRAIN_S),)),
    ("flash_attention_bwd_musicgen", "musicgen-large", "flash_attention_bwd",
     ARCH_TRAIN_B["musicgen-large"], TRAIN_S, TRAIN_S, MUSICGEN_HEADS, True,
     ((TRAIN_S, TRAIN_S),)),
    ("flash_attention_bwd_hd256_tp", "gemma3-4b-edge-tp",
     "flash_attention_bwd", 2, TRAIN_S, TRAIN_S, TP_HEADS, True,
     ((128, 128), (TRAIN_S, TRAIN_S))),
    ("flash_attention_bwd_hd128_g6_tp", "dbrx-132b-tp",
     "flash_attention_bwd", 2, TRAIN_S, TRAIN_S, DBRX_TP_HEADS, True,
     ((128, 128), (TRAIN_S, TRAIN_S))),
    ("flash_attention_bwd_hd128_g8_tp", "llama-3.2-vision-90b-tp",
     "flash_attention_bwd", 2, TRAIN_S, TRAIN_S, VISION_TP_HEADS, True,
     ((128, 128), (TRAIN_S, TRAIN_S))),
    ("flash_attention_bwd_vision_cross_tp", "llama-3.2-vision-90b-tp",
     "flash_attention_bwd_cross", 2, TRAIN_S, IMAGE_ROWS, VISION_TP_HEADS,
     False, ((TRAIN_S, IMAGE_ROWS),)),
    ("flash_attention_bwd_musicgen_tp", "musicgen-large-tp",
     "flash_attention_bwd", 2, TRAIN_S, TRAIN_S, MUSICGEN_TP_HEADS, True,
     ((TRAIN_S, TRAIN_S),)),
    ("flash_attention_bwd_gemma2b", "gemma-2b", "flash_attention_bwd",
     ARCH_TRAIN_B["gemma-2b"], TRAIN_S, TRAIN_S, GEMMA2B_HEADS, True,
     ((128, 128), (TRAIN_S, TRAIN_S))),
)


def phase_flash_bwd_instances(gen) -> list:
    """K3b at the heads of gemma3-4b-edge (hd 256, causal), of
    llama-3.2-vision-90b's cross-attention (H 64 over KV 8, hd 128, full
    attention, Sq 512 over Skv 1024 image rows) and self-attention, of
    musicgen-large (G 1, hd 64) and of the ``[tp]`` ranks (``*_tp``): at
    B 2, f32 (TF32 off) and bf16, each against the plain version (and
    bf16 also against the one rounding P and dS) within TOL x
    max|plain|, two calls bit-equal; then at each path's bf16 train shape
    timed beside autograd's SDPA backward (K/V expanded, masked alike),
    cold (the L2 flushed before each call), its plain version, its bound
    (bytes: q, k,
    v, o, dO, lse read and dq, dk, dv written once; operations: 5
    products over the causal half or the whole Sq x Skv plane) and each
    pass's device ms in one profiled call.  Returns the kernels-line
    entries."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    entries = []

    def inputs(B, Sq, Skv, heads, dt, causal):
        H, KV, hd = heads
        q, do = (torch.randn(B, Sq, H, hd, generator=gen,
                             device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn(B, Skv, KV, hd, generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        return q, k, v, o, do, lse

    for name, model, counter, B, Sq, Skv, heads, causal, checks in \
            K3B_INSTANCES:
        H, KV, hd = heads
        tag = f"[K3b {name}]"
        if heads == GEMMA2B_HEADS:
            # no other phase holds gemma-2b's train forward, K3 with its
            # log-sum-exp, at these heads
            lse_tag = "[K3 flash_attention_gemma2b with lse]"
            lse_errs = _k3_lse_errs(gen, heads, lse_tag)
            print(f"{lse_tag} {model}, the train forward: max|err| "
                  + " ".join(f"{k_}:{e:.2e}" for k_, e in lse_errs.items()))
        errs = {}
        for cq, ckv in checks:
            for label, dt in (("f32", torch.float32),
                              ("bf16", torch.bfloat16)):
                args = inputs(2, cq, ckv, heads, dt, causal)
                got = flash_attention_bwd_cuda(*args, causal=causal)
                again = flash_attention_bwd_cuda(*args, causal=causal)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{tag} not deterministic ({label} "
                                         f"Sq {cq} Skv {ckv})")
                key = f"{label}@{cq}x{ckv}"
                errs[key] = _k3b_errs(f"{name} {key}", got,
                                      flash_attention_bwd_plain(
                                          *args, causal=causal), TOL[label])
                if label == "bf16":
                    errs[key + "/rounded"] = _k3b_errs(
                        f"{name} {key} rounded", got,
                        flash_attention_bwd_plain(
                            *args, causal=causal,
                            round_dtype=torch.bfloat16), TOL[label])
                del args, got, again
        q, k, v, o, do, lse = inputs(B, Sq, Skv, heads, torch.bfloat16,
                                     causal)

        def kernel():
            return flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                            causal=causal)
        lib_fn = _sdpa_bwd(q, k, v, do, causal=causal)
        ms = _device_ms(kernel)
        lib = _device_ms(lib_fn)
        ms = (ms + _device_ms(kernel)) / 2          # kernel, sdpa, kernel
        cold = _cold_device_ms(kernel)
        plain = _device_ms(lambda: flash_attention_bwd_plain(
            q, k, v, o, do, lse, causal=causal), iters=5)
        passes, occupancy = _k3b_pass_ms(kernel)
        n_bytes = ((4 * B * Sq * H * hd + 4 * B * Skv * KV * hd) * 2
                   + B * H * Sq * 4)
        plane = Sq * (Sq + 1) / 2 if causal else Sq * Skv
        bound, by = _bound(n_bytes, 10 * B * H * hd * plane, torch.bfloat16)
        print(f"{tag} {model}: max|err|/max|plain| " + " ".join(
            f"{k_}:{e:.2e}" for k_, e in errs.items()) + "; two calls "
            f"bitwise equal; bf16 {'causal' if causal else 'full'} B{B} "
            f"Sq{Sq} Skv{Skv} H{H} KV{KV} hd{hd}: device ms kernel "
            f"{ms:.4f} (cold {cold:.4f}), sdpa backward {lib:.4f}, "
            f"kernel/sdpa-bwd {ms / lib:.2f}, plain {plain:.4f}; bound "
            f"{bound * 1e3:.3f} us "
            f"({by}, {n_bytes / 1e6:.1f} MB), bound share "
            f"{100 * bound / ms:.2f}%; one profiled call: " + ", ".join(
                f"{t} {x:.4f}" for t, x in passes.items()) + " ms; "
            "registers a thread / warps an SM / est. achieved occupancy % "
            "(profiler): " + ", ".join(
                f"{t} {' / '.join(map(str, x))}"
                for t, x in occupancy.items()))
        entries.append(_owned(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/models/attention.py:119",
             "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain,
             "bound_ms": bound, "bound_by": by, "library_ms": lib},
            model, counter))
        del q, k, v, o, do, lse, lib_fn
    return entries


def phase_tp_flash_kernel(gen, heads=TP_HEADS, name="flash_attention_hd256_tp",
                          what="gemma3-4b-edge over model 2",
                          model="gemma3-4b-edge-tp", skv=None,
                          counter="flash_attention") -> dict:
    """K3 with its log-sum-exp, the train forward, at the shape a ``[tp]``
    rank gives it: gemma3-4b-edge's heads split over model 2 (causal B 2,
    S 512, H 4 over KV 2, hd 256), dbrx-132b's (H 24 over KV 4, hd 128:
    G 6), llama-3.2-vision-90b's (H 32 over KV 4, hd 128; with ``skv``
    its cross-attention, non-causal over ``skv`` image rows) or
    musicgen-large's (H 16 over KV 16, hd 64).  f32 (TF32 off) and bf16
    at Sq 128 and 512 against the plain version and the plain
    logsumexp; the bf16 Sq 512 call timed in turns with SDPA (K/V
    expanded), cold, its plain version and its bound (q, k, v read, o
    and lse written once; 4 B H hd S(S+1)/2 operations causal, 4 B H hd
    Sq Skv full).  Returns the kernels-line entry (``name``, launches of
    ``model``'s paths under ``counter``)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    (H, KV, hd), B, S = heads, 2, TRAIN_S
    causal = skv is None
    tag = f"[K3 {name}]"
    errs = _k3_lse_errs(gen, heads, tag, skv)
    q = torch.randn(B, S, H, hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(B, skv or S, KV, hd, generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    qx, kx, vx = (x.transpose(1, 2) for x in (q, k, v))
    kx, vx = (x.repeat_interleave(H // KV, dim=1) for x in (kx, vx))
    kern = lambda: flash_attention_cuda(q, k, v, causal=causal,  # noqa: E731
                                        return_lse=True)
    ms, lib, turns = _interleaved(
        kern, lambda: torch.nn.functional.scaled_dot_product_attention(
            qx, kx, vx, is_causal=causal))
    plain = _device_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                       iters=5)
    Skv = skv or S
    n_bytes = (2 * B * S * H * hd + 2 * B * Skv * KV * hd) * 2 + B * H * S * 4
    plane = S * (S + 1) / 2 if causal else S * Skv
    bound, by = _bound(n_bytes, 4 * B * H * hd * plane, torch.bfloat16)
    print(f"{tag} {what}: max|err| " + " ".join(
        f"{k_}:{e:.2e}" for k_, e in errs.items()) + f"; bf16 "
          f"{'causal' if causal else 'full'} B{B} Sq{S} Skv{Skv} H{H} KV{KV} "
          f"hd{hd} with lse: device ms kernel {ms:.4f} "
          f"({turns[0]:.4f} / {turns[1]:.4f} around sdpa"
          f"{_cold_wide(hd, ms, kern, H // KV)}), sdpa {lib:.4f}, "
          f"plain {plain:.4f}; bound {bound * 1e3:.3f} us ({by}, "
          f"{n_bytes / 1e6:.2f} MB); {_ratio(ms, lib, bound)}")
    return _owned({"name": name, "route": "cuda",
                   "source": "src/repro_torch/csrc/flash_attention.cu",
                   "replaces": "src/repro/kernels/flash_attention.py:89",
                   "max_abs_err": max(errs.values()), "ms": ms,
                   "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                   "library_ms": lib}, model, counter)


def _k3_lse_errs(gen, heads, tag, skv=None) -> dict:
    """K3 with its log-sum-exp (the train forward) at ``heads``, causal
    (or, with ``skv``, non-causal over ``skv`` keys), f32 (TF32 off) and
    bf16 at Sq 128 and ``TRAIN_S`` against the plain version and the
    plain logsumexp: the output within ``TOL``, the lse within 1e-4 (f32)
    / 1e-3 (bf16).  Returns each case's max|err|."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    (H, KV, hd), B = heads, 2
    causal = skv is None
    errs = {}
    for n in (128, TRAIN_S):
        for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q = torch.randn(B, n, H, hd, generator=gen, device="cuda").to(dt)
            k, v = (torch.randn(B, skv or n, KV, hd, generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          return_lse=True)
            want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                                   return_lse=True)
            err, lse_err = _max_err(o, want), _max_err(lse, want_lse)
            _check(f"{tag} {label} S={n}", err, TOL[label])
            _check(f"{tag} lse {label} S={n}", lse_err,
                   TOL[label] if label == "f32" else 1e-3)
            errs[f"{label}@{n}"], errs[f"lse {label}@{n}"] = err, lse_err
    return errs


#: the ``[tp]`` ranks' other K3 shares: (heads, entry name, what, model,
#: image rows for the non-causal cross-attention or None, counter)
TP_K3_SHARES = (
    (DBRX_TP_HEADS, "flash_attention_hd128_g6_tp", "dbrx-132b over model 2",
     "dbrx-132b-tp", None, "flash_attention"),
    (VISION_TP_HEADS, "flash_attention_hd128_g8_tp",
     "llama-3.2-vision-90b's self-attention over model 2",
     "llama-3.2-vision-90b-tp", None, "flash_attention"),
    (VISION_TP_HEADS, "flash_attention_vision_cross_tp",
     "llama-3.2-vision-90b's cross-attention over model 2",
     "llama-3.2-vision-90b-tp", IMAGE_ROWS, "flash_attention_cross"),
    (MUSICGEN_TP_HEADS, "flash_attention_musicgen_tp",
     "musicgen-large over model 2", "musicgen-large-tp", None,
     "flash_attention"),
)


def phase_tp_flash_shares(gen) -> list:
    """:func:`phase_tp_flash_kernel` at gemma3-4b-edge's share and at each
    of ``TP_K3_SHARES``.  Returns the kernels-line entries."""
    return [phase_tp_flash_kernel(gen)] + [
        phase_tp_flash_kernel(gen, heads, name, what, model, skv, counter)
        for heads, name, what, model, skv, counter in TP_K3_SHARES]


def _plain_attention(q, k, v, *, causal=True):
    from repro_torch.kernels.flash_attention import flash_attention_plain
    return flash_attention_plain(q, k, v, causal=causal)


def phase_train(cfg, smi, totals):
    """Training at the full width of smollm-360m.  (a) float32 (TF32
    off), 2 layers: one loss's gradients through K3/K3b against the same
    loss through the plain attention on the card.  (b) bf16, all 32
    layers, batch 8 x 512 tokens: 20 AdamW steps (lr 3e-4) on the Markov
    stream through ``make_train_step``; K3 must launch 2 x 32 and K3b 32
    times a step (per-block remat), the loss must stay finite and fall,
    and no K3b pass may be among one profiled step's two longest
    kernels.  Returns the bf16 train state (``[mesh]`` reuses it)."""
    import dataclasses
    import torch
    from repro_torch.models.model import LM
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import init_train_state
    gen = torch.Generator(device="cuda").manual_seed(20)
    lm = LM(dataclasses.replace(cfg, dtype="float32", num_layers=2),
            device="cuda", seed=2)
    _grads_vs_plain(lm, _arch_batch(lm.cfg, 2, gen)(0), smi, tag="train")
    del lm
    torch.cuda.empty_cache()
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10, 1))
    state = init_train_state(cfg, opt, device="cuda", seed=0)
    return _train_bf16(state, opt, _arch_batch(cfg, TRAIN_B, gen),
                       TRAIN_STEPS, smi, totals, "train", hold=True)


def _profile_train_step(step_fn, state, bt, smi, tag="train", hold=True):
    """One train step under the profiler: the device's busy share (the
    union of CUDA kernel intervals over the span of the trace) and the
    kernels that take the most time; with ``hold``, no K3b pass may be
    among the two longest.  Returns the busy milliseconds (None when the
    profiler recorded no kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, bt)
        torch.cuda.synchronize()
    events = prof.events()
    busy = _busy_us(events)
    if busy is None:
        print(f"[{tag}] device busy share: not measured (the profiler "
              "recorded no CUDA kernel)")
        return None
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    print(f"[{tag}] one step profiled: {len(kernels)} kernels, device busy "
          f"{busy / 1e3:.2f} ms of {span / 1e3:.2f} ms traced "
          f"({100 * busy / span:.1f}% busy, {100 - 100 * busy / span:.1f}% "
          f"idle)  [{smi}]")
    per_kernel = {}
    for e in kernels:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    for name, us in top[:8]:
        print(f"[{tag}]   {us / 1e3:8.3f} ms  {name[:90]}")
    k3b = {tag: sum(us for name, us in per_kernel.items() if key in name)
           for key, tag in K3B_PASSES}
    print(f"[{tag}] K3b in the step: " + ", ".join(
        f"{tag} {us / 1e3:.3f} ms" for tag, us in k3b.items())
          + f"; {100 * sum(k3b.values()) / busy:.1f}% of the device's busy "
          f"time")
    if hold and any(key in name for name, _ in top[:2]
                    for key, _ in K3B_PASSES):
        raise AssertionError("[train] a K3b pass is among the step's two "
                             "longest kernels")
    return busy / 1e3


def _grads_vs_plain(lm, batch, smi, tag, host=False) -> None:
    """One loss's gradients through K3/K3b (remat: K3 twice and K3b once
    an attention layer of either kind, exactly; the cross-attention ones
    under their own counters) against the same loss through the plain
    attention on the card (TF32 off): each parameter's
    max|err|/max|plain| within TOL["f32"].  ``host`` keeps the kernel
    path's gradients on the CPU meanwhile (a model whose gradients do not
    fit the card twice)."""
    from unittest import mock
    import torch
    from repro_torch.kernels import ops
    n_self, n_cross = lm.n_attn, lm.n_layers["xattn"]
    lm.requires_grad_(True)
    ops.reset_launches()
    cross_ctx, cross = _cross_launches()
    with cross_ctx:
        lm.loss(batch).backward()
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k]
                for k in ("flash_attention", "flash_attention_bwd")}
    want = {"flash_attention": 2 * (n_self + n_cross),
            "flash_attention_bwd": n_self + n_cross}
    if launches != want or cross["flash_attention_cross"] != 2 * n_cross \
            or cross["flash_attention_bwd_cross"] != n_cross:
        raise AssertionError(f"[{tag}] launches {launches} {cross}, expected "
                             f"{want}, {n_cross} layers of them "
                             f"cross-attention")
    kern = {n: p.grad.cpu() if host else p.grad
            for n, p in lm.named_parameters()}
    lm.zero_grad(set_to_none=True)
    ops.reset_launches()
    with mock.patch.object(ops, "flash_attention_train", _plain_attention):
        lm.loss(batch).backward()
    torch.cuda.synchronize()
    if ops.LAUNCHES["flash_attention"] or ops.LAUNCHES["flash_attention_bwd"]:
        raise AssertionError(f"[{tag}] the plain attention launched "
                             f"{dict(ops.LAUNCHES)}")
    worst, worst_name = 0.0, ""
    for n, p in lm.named_parameters():
        want_g = p.grad
        rel = _max_err(kern[n].to(want_g.device), want_g) / max(
            float(want_g.abs().max()), 1e-30)
        _check(f"[{tag}] grad {n}", rel, TOL["f32"])
        if rel >= worst:
            worst, worst_name = rel, n
    lm.zero_grad(set_to_none=True)
    lm.requires_grad_(False)
    shape = "x".join(map(str, batch["labels"].shape))
    print(f"[{tag}] f32 (TF32 off), {lm.cfg.num_layers} layers at full "
          f"width, B x S {shape}: gradients through K3+K3b vs the plain "
          f"attention on the card, largest max|err|/max|plain| {worst:.2e} "
          f"({worst_name}) over {len(kern)} tensors; launches K3 "
          f"{launches['flash_attention']}, K3b "
          f"{launches['flash_attention_bwd']} (cross-attention {cross})  "
          f"[{smi}]")


def _train_bf16(state, opt, batch, steps, smi, totals, tag, falls=True,
                hold=False):
    """``steps`` bf16 steps of ``make_train_step`` from ``state`` on
    ``batch(step)``: K3 2 x and K3b 1 x the attention layers a step
    (remat; the cross-attention ones counted apart), the loss finite and,
    with ``falls``, lower at the end; prints ms/step, tokens/s, peak
    memory and one profiled step's busy share (``hold``: see
    :func:`_profile_train_step`).  Returns the state."""
    import statistics
    import torch
    from repro_torch.kernels import ops
    from repro_torch.training.train_loop import make_train_step
    lm = state.model
    cfg = lm.cfg
    n_self, n_cross = lm.n_attn, lm.n_layers["xattn"]
    step_fn = make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    ops.reset_launches()
    cross_ctx, cross = _cross_launches()
    with cross_ctx:
        for step in range(steps):
            bt = batch(step)
            t0 = time.monotonic()
            state, metrics = step_fn(state, bt)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t0)
    launched = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n = n_self + n_cross
    want = {"flash_attention": 2 * n * steps, "flash_attention_bwd": n * steps,
            "flash_attention_cross": 2 * n_cross * steps,
            "flash_attention_bwd_cross": n_cross * steps}
    got = {**{k: launched[k] for k in ("flash_attention",
                                       "flash_attention_bwd")}, **{
        k: cross[k] for k in ("flash_attention_cross",
                              "flash_attention_bwd_cross")}}
    if got != want:
        raise AssertionError(f"[{tag}] launches {got} in {steps} steps, "
                             f"expected {want}")
    _add_launches(totals, launched, cross)
    if not all(math.isfinite(x) for x in losses) or (
            falls and losses[-1] >= losses[0]):
        raise AssertionError(f"[{tag}] losses {losses}")
    B, S = bt["labels"].shape
    ms = 1e3 * statistics.median(secs[steps // 2:])
    print(f"[{tag}] bf16 {cfg.name}, {cfg.num_layers} layers at full width "
          f"({n_cross} cross-attention), {opt.kind} lr {opt.lr}, B{B} x S{S}"
          f", {steps} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{ms:.1f} ms/step (median of the last {steps - steps // 2}), "
          f"{B * S / ms * 1e3:.0f} tokens/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches a step: K3 {2 * n}, K3b {n} "
          f"({2 * n_cross} and {n_cross} of them cross-attention)  [{smi}]")
    print(f"[{tag}] losses " + " ".join(f"{x:.4f}" for x in losses))
    _profile_train_step(step_fn, state, batch(steps), smi, tag=tag,
                        hold=hold)
    return state


def _arch_batch(cfg, B, gen, seq=None):
    """``batch(step)`` for a trained stack on the card: tokens and labels
    (``seq`` positions, ``TRAIN_S`` when None) from the Markov stream
    (seeded by the step), or for musicgen seeded frame embeddings beside
    the stream's labels over its codebook, and for a stack with
    cross-attention seeded image embeddings, drawn from ``gen`` or, when
    it is None, from a generator seeded by the step (the same in every
    process: the ``[tp]`` ranks' replicated inputs)."""
    import torch
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    from repro_torch.models.layers import dtype_of
    seq = seq or TRAIN_S
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=seq, global_batch=B))

    def batch(step):
        out = {k: torch.from_numpy(x).long().cuda()
               for k, x in data.batch(step).items()}
        g = gen if gen is not None else torch.Generator(
            device="cuda").manual_seed(1000 + step)
        if cfg.audio_frontend:
            out["frames"] = torch.randn(B, seq, cfg.d_model, generator=g,
                                        device="cuda").to(dtype_of(cfg))
            del out["tokens"]
        if cfg.num_image_tokens:
            out["image_embeds"] = torch.randn(
                B, cfg.num_image_tokens, cfg.d_model, generator=g,
                device="cuda").to(dtype_of(cfg))
        return out
    return batch


#: the stacks trained whole from a fresh state after the paths that serve
#: them, by print tag: (arch id, the batches' generator seed).
#: gemma3-4b-edge, the paper's own backend (d_model 2560, 8 heads over 4
#: KV heads of width 256, vocab 262,144); gemma-2b (d_model 2048, 8 query
#: heads over 1 KV head of width 256, GeGLU, the tied 256,000-row head;
#: its train state 28.01 GiB before activations)
TRAIN_WHOLE = {"gemma3": ("gemma3-4b-edge", 21), "gemma2b": ("gemma-2b", 24)}


def train_whole(smi, totals, tag) -> None:
    """Training ``TRAIN_WHOLE[tag]`` at full width: (a) a float32 2-layer
    copy's gradients through K3/K3b against the plain attention's; (b)
    all its layers in bf16, ``ARCH_TRAIN_STEPS`` AdamW steps (lr 3e-4) at
    ``ARCH_TRAIN_B`` x 512 through ``make_train_step``, the loss
    falling."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import init_train_state
    arch, seed = TRAIN_WHOLE[tag]
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=2)
    lm = LM(cfg32, device="cuda", seed=2)
    _timed(_grads_vs_plain, lm, _arch_batch(cfg32, 2, gen)(0), smi,
           tag=f"{tag}-train-f32")
    del lm
    _free_card(f"{tag}-train")
    steps = ARCH_TRAIN_STEPS[cfg.name]
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=max(steps // 10, 1))
    state = init_train_state(cfg, opt, device="cuda", seed=0)
    _timed(_train_bf16, state, opt, _arch_batch(
        cfg, ARCH_TRAIN_B[cfg.name], gen), steps, smi, totals,
           tag=f"{tag}-train")


def phase_lm_train(lm, smi, totals, tag) -> None:
    """The bf16 model of :func:`phase_lm_api` trained in place through
    ``make_train_step``: musicgen-large (48 layers) with AdamW on seeded
    frames, the cut llama-3.2-vision-90b with Adafactor (its bf16
    weights and gradients take 23.8 GiB; AdamW's float32 moments would
    add 47.5) on seeded image embeddings, its cross-attention layer's
    backward through K3b at Sq 512 over Skv 1024; lr 3e-4, the loss
    finite."""
    import torch
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import TrainState
    cfg = lm.cfg
    steps = ARCH_TRAIN_STEPS[cfg.name]
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=max(steps // 10, 1),
                    kind="adafactor" if cfg.num_image_tokens else "adamw")
    lm.requires_grad_(True)
    state = TrainState(lm, init_opt_state(dict(lm.named_parameters()), opt,
                                          len(cfg.block_pattern)))
    gen = torch.Generator(device="cuda").manual_seed(22)
    _train_bf16(state, opt, _arch_batch(cfg, ARCH_TRAIN_B[cfg.name], gen),
                steps, smi, totals, tag, falls=False)


def _train_child(args, arch="smollm-360m") -> tuple:
    """``python -m repro_torch.launch.train --arch ARCH ARGS`` from the
    checkout on the card (its mesh: a one-rank NCCL group); returns its
    per-step losses (it logs every step) and its other output lines."""
    import re
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--log-every", "1", *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"[launch-train] child exited "
                             f"{out.returncode}:\n{out.stderr[-3000:]}")
    lines = [line for line in out.stdout.splitlines()
             if not re.match(r"step \d+: loss=", line)]
    return [float(m) for m in re.findall(r"step \d+: loss=([\d.]+)",
                                         out.stdout)], lines


def start_launch_train() -> dict:
    """Start ``[launch-train]``'s children (host-bound processes, each
    with its own CUDA context) in the background, to run beside the next
    phases: ``python -m repro_torch.launch.train`` on the card at full
    width (bf16, the CLI's batch 8 x 128), 6 steps straight with
    checkpoints and, at the same time, 3 steps into another checkpoint
    directory followed by a third process resuming from it for 3 more;
    and gemma3-4b-edge (all 34 layers, hd 256 through K3b) for 3 steps
    without a checkpoint (a full-width one is ~47 GB).
    :func:`phase_launch_train` collects them."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    a, b = os.path.join(tmp, "straight"), os.path.join(tmp, "resumed")

    def first_then_resumed():
        return (_train_child(["--steps", "3", "--ckpt", b]),
                _train_child(["--steps", "3", "--ckpt", b]))
    pool = ThreadPoolExecutor(3)
    return {"tmp": tmp, "a": a, "b": b, "pool": pool, "t0": time.monotonic(),
            "straight": pool.submit(_train_child, [
                "--steps", "6", "--ckpt", a, "--ckpt-every", "3"]),
            "resumed": pool.submit(first_then_resumed),
            "gemma3": pool.submit(_train_child, ["--steps", "3"],
                                  arch="gemma3-4b-edge")}


def phase_launch_train(run: dict, smi, beside: str) -> str:
    """Collect :func:`start_launch_train`'s children: the resumed losses
    must equal the straight run's last 3 within rtol 1e-4 (the printed 4
    decimals; as the JAX package's resume test).  Returns the resumed
    run's checkpoint directory (``[mesh]`` reshards it)."""
    import numpy as np
    from repro_torch.training import checkpoint as ckpt_lib
    (straight, l1), ((first, l2), (resumed, l3)), (gemma, l4) = \
        run["straight"].result(), run["resumed"].result(), \
        run["gemma3"].result()
    run["pool"].shutdown()
    secs = time.monotonic() - run["t0"]
    for line in l1 + l2 + l3 + l4:
        print(f"[launch-train]   {line}")
    if len(gemma) != 3 or not all(math.isfinite(x) for x in gemma):
        raise AssertionError(f"[launch-train] gemma3-4b-edge losses {gemma}")
    a, b = run["a"], run["b"]
    if ckpt_lib.all_steps(a) != [3, 6] or ckpt_lib.latest_step(b) != 6:
        raise AssertionError("[launch-train] checkpoints missing: "
                             f"{ckpt_lib.all_steps(a)} "
                             f"{ckpt_lib.all_steps(b)}")
    if len(straight) != 6 or len(first) != 3 or len(resumed) != 3:
        raise AssertionError(f"[launch-train] losses {straight} {first} "
                             f"{resumed}")
    np.testing.assert_allclose(first, straight[:3], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(resumed, straight[3:], rtol=1e-4, atol=1e-4)
    print(f"[launch-train] 4 children in {secs:.1f} s (started before "
          f"{beside} and run beside it; not a time taken alone): straight "
          f"{' '.join(f'{x:.4f}' for x in straight)}; 3 + resumed 3 "
          f"{' '.join(f'{x:.4f}' for x in first + resumed)}; equal; "
          f"gemma3-4b-edge (34 layers, hd 256) "
          f"{' '.join(f'{x:.4f}' for x in gemma)}  [{smi}]")
    return b


def phase_mesh(cfg, state, ckpt_dir, smi, totals) -> None:
    """The sharding layer on the card, on ``[train]``'s full-width bf16
    smollm-360m state and ``make_local_mesh``'s (1, 1) ("data", "model")
    mesh over a one-rank NCCL group.  (a) One step through
    ``make_train_step(mesh=)``: its loss and updated parameters bitwise
    equal to the same step with no mesh from the same state, with
    ``[train]``'s K3/K3b launches a step.  (b) That step's gradients
    through ``apply_error_feedback`` and ``compressed_psum_mean`` over
    NCCL, bitwise equal to the same functions on the gradients copied to
    the CPU (a world-1 gloo group); the exchanged bytes against 2 x 4 B
    per element.  (c) ``resume_on_mesh`` of ``[launch-train]``'s
    checkpoint onto the mesh: every leaf bitwise equal to
    ``checkpoint.restore``.  (d) The roofline of ``[train]``'s step at its
    own shape: FLOPs counted on meta tensors and ``model_flops``, the
    compute and memory bounds at the H100's peaks, the step's device
    (profiler busy) and wall ms, and the share of the bf16 peak."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLMStream
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.dryrun import count_flops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training.elastic import resume_on_mesh
    from repro_torch.training.grad_compress import (EXCHANGED,
                                                    apply_error_feedback,
                                                    compressed_psum_mean,
                                                    init_error_state)
    from repro_torch.training.optimizer import OptConfig, OptState
    from repro_torch.training.train_loop import (TrainState,
                                                 abstract_train_state,
                                                 make_train_step)
    mesh = make_local_mesh("cuda")
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10, 1))
    data = SyntheticLMStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=TRAIN_S,
                                          global_batch=TRAIN_B))
    bt = {k: torch.from_numpy(x).long().cuda()
          for k, x in data.batch(TRAIN_STEPS + 1).items()}
    lm, L = state.model, cfg.num_layers
    params = dict(lm.named_parameters())
    kernels = ("flash_attention", "flash_attention_bwd")
    start = dict(ops.LAUNCHES)
    t0 = time.monotonic()

    def secs() -> str:
        nonlocal t0
        t, t0 = time.monotonic() - t0, time.monotonic()
        return f"({t:.1f} s)"

    # (b)'s gradients first: the step's own, at the state it starts from
    lm.requires_grad_(True)
    lm.loss(bt).backward()
    grads = {n: p.grad.detach().clone() for n, p in params.items()}
    lm.zero_grad(set_to_none=True)

    # (a) one step with no mesh and one through the mesh, same start
    with torch.no_grad():
        snap = {n: p.detach().clone() for n, p in params.items()}
    opt0 = OptState(state.opt.step.clone(),
                    {k: v.clone() for k, v in state.opt.m.items()},
                    {k: v.clone() for k, v in state.opt.v.items()})
    plain, meshed = make_train_step(cfg, opt), make_train_step(cfg, opt,
                                                               mesh=mesh)
    before = dict(ops.LAUNCHES)
    _, m_plain = plain(state, bt)
    mid = dict(ops.LAUNCHES)
    with torch.no_grad():
        want = {n: p.detach().clone() for n, p in params.items()}
        for n, p in params.items():
            p.copy_(snap[n])
    del snap
    state, m_mesh = meshed(TrainState(lm, opt0), bt)
    torch.cuda.synchronize()
    after = dict(ops.LAUNCHES)
    runs = [{k: b[k] - a[k] for k in kernels}
            for a, b in ((before, mid), (mid, after))]
    if runs[0] != runs[1] or runs[1] != {"flash_attention": 2 * L,
                                         "flash_attention_bwd": L}:
        raise AssertionError(f"[mesh] K3/K3b launches plain {runs[0]}, "
                             f"meshed {runs[1]}; [train]'s are 2 x {L} / {L}")
    if not torch.equal(m_plain["loss"], m_mesh["loss"]):
        raise AssertionError(f"[mesh] loss {float(m_mesh['loss'])} != "
                             f"{float(m_plain['loss'])}")
    bad = [n for n, p in params.items() if not torch.equal(p, want[n])]
    if bad:
        raise AssertionError(f"[mesh] meshed step's parameters differ: "
                             f"{bad[:5]}")
    del want
    print(f"[mesh] (a) one bf16 step through make_train_step(mesh=(1, 1) "
          f"NCCL): loss {float(m_mesh['loss']):.6f} and all "
          f"{len(params)} updated parameters bitwise equal to the step "
          f"with no mesh; K3 {runs[1]['flash_attention']}, K3b "
          f"{runs[1]['flash_attention_bwd']} launches, as [train]'s "
          f"{secs()}")

    # (b) the int8 exchange over NCCL against the CPU's over gloo
    EXCHANGED["bytes"] = 0
    deq, err = apply_error_feedback(grads, init_error_state(grads))
    group = mesh.get_group("data")
    mean = {n: compressed_psum_mean(g, group) for n, g in deq.items()}
    torch.cuda.synchronize()
    sent = EXCHANGED["bytes"]
    cpu_group = dist.new_group(ranks=[0], backend="gloo")
    cg = {n: g.cpu() for n, g in grads.items()}
    cdeq, cerr = apply_error_feedback(cg, init_error_state(cg))
    for n, g in cdeq.items():
        for got, ref in ((deq[n], g), (err[n], cerr[n]),
                         (mean[n], compressed_psum_mean(g, cpu_group))):
            if not torch.equal(got.cpu(), ref):
                raise AssertionError(f"[mesh] {n}: the card's exchange "
                                     "differs from the CPU's")
    numel = sum(g.numel() for g in grads.values())
    print(f"[mesh] (b) apply_error_feedback + compressed_psum_mean over "
          f"NCCL on the step's {len(grads)} gradients ({numel:,} elements):"
          f" bitwise equal to the CPU's over gloo (world 1); exchanged "
          f"{sent:,} B ({sent / numel:.3f} B/elem) against 2 x 4 B/elem = "
          f"{8 * numel:,} B for a float32 ring all-reduce {secs()}")
    del grads, deq, err, mean, cg, cdeq, cerr

    # (c) the elastic reshard of [launch-train]'s checkpoint
    _, axes = abstract_train_state(cfg, opt)
    got = resume_on_mesh(state, axes, mesh, ckpt_dir)
    leaves = [(p, x.clone() if isinstance(x, torch.Tensor) else x)
              for p, x in ckpt_lib.flatten(got)]
    ref = ckpt_lib.flatten(ckpt_lib.restore(state, ckpt_dir))
    for (pa, x), (pb, y) in zip(leaves, ref):
        if pa != pb or not torch.equal(torch.as_tensor(x),
                                       torch.as_tensor(y)):
            raise AssertionError(f"[mesh] resume_on_mesh leaf {pa} differs")
    print(f"[mesh] (c) resume_on_mesh of [launch-train]'s step-"
          f"{ckpt_lib.latest_step(ckpt_dir)} checkpoint onto the (1, 1) "
          f"mesh: all {len(leaves)} leaves on the card, bitwise equal to "
          f"checkpoint.restore {secs()}")
    del leaves, ref

    # (d) the roofline of [train]'s step at its own shape
    shape = ShapeConfig("train_b8_s512", TRAIN_S, TRAIN_B, "train")
    meta, _ = abstract_train_state(cfg, opt)
    mb = {k: torch.empty(TRAIN_B, TRAIN_S, dtype=torch.long, device="meta")
          for k in ("tokens", "labels")}
    flops = count_flops(lambda: meta.model.loss(mb, remat=True).backward())
    mf = rl.model_flops(cfg, shape)
    peak = PEAK_FLOPS[str(torch.bfloat16)]
    compute_ms = flops / peak * 1e3
    n_bytes = rl.analytic_bytes(cfg, shape, 1)
    memory_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    torch.cuda.synchronize()
    t0 = time.monotonic()
    state, _ = meshed(state, bt)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = meshed(state, bt)
        torch.cuda.synchronize()
    busy = _busy_us(prof.events())
    if busy is None:
        raise AssertionError("[mesh] the profiler recorded no CUDA kernel")
    device_ms = busy / 1e3
    for k in kernels:
        totals[k] += ops.LAUNCHES[k] - start[k]
    print(f"[mesh] (d) roofline of [train]'s bf16 step, {L} layers, "
          f"B{TRAIN_B} x S{TRAIN_S}: FLOPs counted on meta tensors "
          f"{flops:.4e} (model_flops 6ND {mf:.4e}, x{flops / mf:.3f}: "
          f"remat's second forward and the plain attention's S x S); "
          f"bounds at the H100's peaks: compute {compute_ms:.3f} ms "
          f"(989 TFLOP/s bf16), memory {memory_ms:.3f} ms (analytic "
          f"{n_bytes:.4e} B at 3.35 TB/s); measured: device {device_ms:.3f}"
          f" ms busy (profiler), wall {wall_ms:.3f} ms; bf16-peak share "
          f"{100 * flops / (device_ms * 1e-3) / peak:.2f}% of the device "
          f"time, {100 * flops / (wall_ms * 1e-3) / peak:.2f}% of the wall "
          f"time {secs()}  [{smi}]")
    dist.destroy_process_group()


def jamba_kernels(gen) -> list:
    """K1 and K3 at jamba's attention heads (H32/KV8 hd 128), the kernels
    line's ``*_hd128`` entries: no paged pool (refused for the stack) and
    no extend prefill; K1 also with (B,) fill levels, K3 also at exact
    prompt lengths."""
    k1 = phase_decode_kernel(gen, JAMBA_HEADS)
    k3 = phase_flash_kernel(gen, JAMBA_HEADS)
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            phase_decode_lanes_kernel(gen, JAMBA_HEADS))
    k3["max_abs_err"] = max(k3["max_abs_err"],
                            phase_flash_exact(gen, JAMBA_HEADS))
    return [k1, k3]


def jamba_paths(predictor, smi) -> dict:
    """jamba-v0.1-52b at full width, one of its four pattern repeats (the
    whole model, 95.8 GiB in bf16, does not fit one card, and a second
    repeat does not fit the run's time limit): a float32 copy held to
    the plain attention, then Mamba, MoE and attention (H32/KV8 hd 128)
    in bf16 through the serial engine, the sidecar and ring lanes.
    Returns the paths' launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, num_layers=len(full.block_pattern))
    totals = {k: 0 for k in LAUNCHES}
    _timed(phase_jamba_f32, cfg, smi, totals, tag="jamba-f32")
    launches, eng, tokens = _timed(phase_slice, cfg, predictor, smi,
                                   tag="jamba-slice", long_new=JAMBA_LONG_NEW)
    for k, v in launches.items():
        totals[k] += v
    _timed(phase_sidecar, eng, predictor, smi, tokens, totals,
           tag="jamba-sidecar", extras=False, long_new=JAMBA_LONG_NEW)
    del eng
    _free_card("jamba-lanes")
    _timed(phase_hybrid_lanes, cfg, smi, totals, tag="jamba-lanes")
    return totals


def phase_cross_kernels(gen) -> list:
    """The cross-attention kernels at llama-3.2-vision-90b's heads (H64
    over KV8, hd 128) over its 1024 image rows: K3 non-causal at Sq 1,
    16 and 45 (the prefill; 45 is the [vision] prompt), and K1 at
    t = 1023 over a 1024-slot image cache (the decode, every slot live),
    each against its plain version (bf16 2e-2, f32 1e-4) and K1 also
    against the plain non-causal attention of its one row; timed beside
    SDPA (non-causal, K/V expanded to the query heads).  K3 at Sq 1 is
    timed beside K1 on the same work: the decode takes K1.  Returns the
    two kernels-line entries."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain,
                                                      split_plan)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    (H, KV, hd), T, B = VISION_HEADS, IMAGE_ROWS, 1
    errs, rows = {}, {}
    t = torch.tensor(T - 1, dtype=torch.int32, device="cuda")
    for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        k = torch.randn(B, T, KV, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, T, KV, hd, generator=gen, device="cuda").to(dt)
        kx = k.transpose(1, 2).repeat_interleave(H // KV, dim=1)
        vx = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
        for Sq in (1, 16, LM_PROMPT):
            q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dt)
            got = flash_attention_cuda(q, k, v, causal=False)
            want = flash_attention_plain(q, k, v, causal=False)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            _check(f"flash_attention non-causal {label} Sq={Sq}", err,
                   TOL[label])
            errs[("K3", label, Sq)] = err
            if label != "bf16":
                continue
            qx = q.transpose(1, 2)
            kern = lambda: flash_attention_cuda(q, k, v,  # noqa: E731
                                                causal=False)
            ms, lib, turns = _interleaved(kern, lambda: sdpa(qx, kx, vx))
            plain = _device_ms(lambda: flash_attention_plain(
                q, k, v, causal=False))
            bound, by = _bound((2 * B * Sq * H * hd + 2 * B * T * KV * hd)
                               * 2, 4 * B * H * hd * Sq * T, torch.bfloat16)
            rows[("K3", Sq)] = (ms, plain, lib, bound, by)
            print(f"[K3 flash_attention vision cross] bf16 non-causal "
                  f"Sq={Sq} Skv={T}: device ms kernel {ms:.4f} "
                  f"({turns[0]:.4f} / {turns[1]:.4f} around sdpa)"
                  f"{_cold_wide(hd, ms, kern)}, wrapper {_host_us(kern):.1f} "
                  f"host us/call, plain "
                  f"{plain:.4f}, sdpa {lib:.4f}; bound {bound * 1e3:.3f} us "
                  f"({by}); {_ratio(ms, lib, bound)}; host-paced kernel "
                  f"{_ms(kern):.4f} ms/call")
        q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(dt)
        got = decode_attention_cuda(q, k, v, t)
        want = decode_attention_plain(q, k, v, t)
        full = flash_attention_plain(q, k, v, causal=False)
        torch.cuda.synchronize()
        err = max(_max_err(got, want), _max_err(got, full))
        _check(f"decode_attention t={T - 1} over {T} image slots {label}",
               err, TOL[label])
        errs[("K1", label)] = err
        if label == "bf16":
            qx = q.transpose(1, 2)
            kern = lambda: decode_attention_cuda(q, k, v, t)  # noqa: E731
            ms, lib, turns = _interleaved(kern, lambda: sdpa(qx, kx, vx))
            plain = _device_ms(lambda: decode_attention_plain(q, k, v, t))
            bound, by = _bound(2 * T * KV * hd * 2 + 2 * B * H * hd * 2 + 4,
                               4 * B * H * T * hd, torch.bfloat16)
            rows["K1"] = (ms, plain, lib, bound, by)
            print(f"[K1 decode_attention vision cross] bf16 t={T - 1} over "
                  f"{T} image slots ({split_plan(T)} splits): device ms "
                  f"kernel {ms:.4f} ({turns[0]:.4f} / {turns[1]:.4f} around "
                  f"sdpa){_cold_wide(hd, ms, kern)}, plain {plain:.4f}, sdpa "
                  f"{lib:.4f}; "
                  f"bound {bound * 1e3:.3f} us ({by}); "
                  f"{_ratio(ms, lib, bound)}; host-paced kernel "
                  f"{_ms(kern):.4f} ms/call")
    print(f"[vision cross] one decode row over {T} image rows: K1 "
          f"{rows['K1'][0]:.4f} ms against K3 at Sq 1 {rows['K3', 1][0]:.4f}"
          f" ms (device); max|err| " + " ".join(
              f"{'/'.join(map(str, key))}:{e:.2e}" for key, e in errs.items()))
    k3 = rows["K3", LM_PROMPT]
    entries = []
    for name, src, line, (ms, plain, lib, bound, by), err in (
            ("flash_attention_vision_cross",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:89", k3,
             max(e for key, e in errs.items() if key[0] == "K3")),
            ("decode_attention_vision_cross",
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:180", rows["K1"],
             max(e for key, e in errs.items() if key[0] == "K1"))):
        entries.append(_owned(
            {"name": name, "route": "cuda", "source": src, "replaces": line,
             "max_abs_err": err, "ms": ms, "plain_ms": plain,
             "bound_ms": bound, "bound_by": by, "library_ms": lib},
            "llama-3.2-vision-90b", name.replace("_vision", "")))
    return entries


def new_arch_kernels(gen) -> list:
    """K1 and K3 at musicgen-large's heads (32 over 32, hd 64: one query
    head a KV head, K3 on its wgmma body, also in extend mode, whose rows
    must equal the cold prefill's bit for bit) and at
    llama-3.2-vision-90b's self-attention heads (64 over 8, hd 128: also
    qwen3-32b's, whose launches these entries add to vision's), then the
    vision stack's cross-attention kernels: the kernels line's
    ``*_musicgen``, ``*_vision`` and ``*_vision_cross`` entries."""
    out = []
    for heads, tag, model in ((MUSICGEN_HEADS, "musicgen", "musicgen-large"),
                              (VISION_HEADS, "vision",
                               ("llama-3.2-vision-90b", "qwen3-32b"))):
        k3 = phase_flash_kernel(gen, heads, tag)
        if heads == MUSICGEN_HEADS:
            # K3's wgmma body at G 1: extend rows == the cold rows
            k3["max_abs_err"] = max(k3["max_abs_err"],
                                    phase_flash_extend(gen, heads, tag))
        out += [_owned(phase_decode_kernel(gen, heads, tag), model,
                       "decode_attention"),
                _owned(k3, model, "flash_attention")]
    return out + phase_cross_kernels(gen)


def serve_arch_kernels(gen) -> list:
    """The kernel instances of the three models served whole or by one
    repeat at the end of the run: K1, K2 and K3 at gemma-2b's heads (8
    over 1 KV head of width 256: K1's tensor-core body with all eight
    columns live, K3's wgmma body at G 8; K1 also with (B,) fill levels,
    K2 also == K1, K3 also in extend mode), K2 at qwen3-32b's (64 over 8
    at hd 128; its K1 and K3 are vision's instances) and K1 and K3 at
    llama4-maverick's (40 over 8 at hd 128: G 5 cuts a position's heads
    across K3's 64-row tiles; K3 also at the exact prompt lengths its MoE
    stack prefills at), K2 at granite-8b's (32 over 8 at hd 128: its K1
    and K3 are jamba's ``*_hd128`` instances, which no paged pool reaches)
    and K1 and K3 at dbrx-132b's (48 over 8 at hd 128: G 6; K1 also with
    (B,) fill levels, K3 also at exact prompt lengths).  The kernels
    line's ``*_gemma2b``, ``*_qwen3``, ``*_llama4``,
    ``paged_decode_attention_granite`` and ``*_dbrx`` entries."""
    k1 = phase_decode_kernel(gen, GEMMA2B_HEADS, "gemma2b")
    k1["max_abs_err"] = max(k1["max_abs_err"], phase_decode_lanes_kernel(
        gen, GEMMA2B_HEADS, "gemma2b"))
    k3 = phase_flash_kernel(gen, GEMMA2B_HEADS, "gemma2b")
    k3["max_abs_err"] = max(k3["max_abs_err"], phase_flash_extend(
        gen, GEMMA2B_HEADS, "gemma2b"))
    out = [_owned(k1, "gemma-2b", "decode_attention"),
           _owned(phase_paged_kernel(gen, GEMMA2B_HEADS, "gemma2b"),
                  "gemma-2b", "paged_decode_attention"),
           _owned(k3, "gemma-2b", "flash_attention"),
           _owned(phase_paged_kernel(gen, QWEN3_HEADS, "qwen3"),
                  "qwen3-32b", "paged_decode_attention")]
    k1 = phase_decode_kernel(gen, LLAMA4_HEADS, "llama4")
    k1["max_abs_err"] = max(k1["max_abs_err"], phase_decode_lanes_kernel(
        gen, LLAMA4_HEADS, "llama4"))
    k3 = phase_flash_kernel(gen, LLAMA4_HEADS, "llama4")
    k3["max_abs_err"] = max(k3["max_abs_err"], phase_flash_exact(
        gen, LLAMA4_HEADS, "llama4"))
    model = "llama4-maverick-400b-a17b"
    out += [_owned(k1, model, "decode_attention"),
            _owned(k3, model, "flash_attention"),
            _owned(phase_paged_kernel(gen, JAMBA_HEADS, "granite"),
                   "granite-8b", "paged_decode_attention")]
    k1 = phase_decode_kernel(gen, DBRX_HEADS, "dbrx")
    k1["max_abs_err"] = max(k1["max_abs_err"], phase_decode_lanes_kernel(
        gen, DBRX_HEADS, "dbrx"))
    k3 = phase_flash_kernel(gen, DBRX_HEADS, "dbrx")
    k3["max_abs_err"] = max(k3["max_abs_err"], phase_flash_exact(
        gen, DBRX_HEADS, "dbrx"))
    return out + [_owned(k1, "dbrx-132b", "decode_attention"),
                  _owned(k3, "dbrx-132b", "flash_attention")]


def _cross_launches():
    """(context, counts): inside the context, the K3 and K1 launches made
    by ``CrossAttention.prefill`` / ``.decode`` / ``.forward`` (training,
    remat's second forward included) are added to ``counts``
    ("flash_attention_cross", "decode_attention_cross"), and K3b's
    launches for full attention (in these stacks only the cross-attention
    layer's backward) to "flash_attention_bwd_cross", each read from the
    launch counters around the call."""
    from unittest import mock
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models.attention import CrossAttention
    counts = {"flash_attention_cross": 0, "decode_attention_cross": 0,
              "flash_attention_bwd_cross": 0}
    stack = contextlib.ExitStack()
    for method, kernel in (("prefill", "flash_attention"),
                           ("decode", "decode_attention"),
                           ("forward", "flash_attention")):
        orig = getattr(CrossAttention, method)

        def spy(self, *a, _orig=orig, _k=kernel, **kw):
            before = LAUNCHES[_k]
            out = _orig(self, *a, **kw)
            counts[_k + "_cross"] += LAUNCHES[_k] - before
            return out
        stack.enter_context(mock.patch.object(CrossAttention, method, spy))
    bwd = ops.flash_attention_bwd_cuda

    def bwd_spy(*a, causal=True, **kw):
        before = LAUNCHES["flash_attention_bwd"]
        out = bwd(*a, causal=causal, **kw)
        if not causal:
            counts["flash_attention_bwd_cross"] += \
                LAUNCHES["flash_attention_bwd"] - before
        return out
    stack.enter_context(mock.patch.object(ops, "flash_attention_bwd_cuda",
                                          bwd_spy))
    return stack, counts


def _lm_inputs(cfg, gen, steps=LM_STEPS):
    """Seeded inputs of an LM-API path, drawn by ``frontends.make_batch``
    on ``gen``'s device: (key, sequence of LM_PROMPT + steps positions:
    frames (1, S, D) in the model's dtype or tokens (1, S)), and the
    image rows of a stack with cross-attention."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import frontends
    batch = frontends.make_batch(cfg, SHAPES["prefill_32k"], gen,
                                 batch_size=1, seq_len=LM_PROMPT + steps)
    key = "frames" if cfg.audio_frontend else "tokens"
    seq = batch.pop(key)
    return key, seq, batch


def _lm_run(lm, key, seq, img, steps=LM_STEPS, sync=False):
    """Prefill the first LM_PROMPT positions into a ring of LM_PROMPT +
    ``steps`` slots, then ``steps`` decode steps:
    teacher-forced on the sequence's frames (audio), greedy from the
    prompt (tokens).  Returns (logits (steps + 1, V), greedy tokens or
    None, prefill seconds, decode seconds); the seconds only with
    ``sync`` (the host clock around synchronised work)."""
    import torch
    t0 = time.monotonic()
    lg, cache = lm.prefill(pad_to=LM_PROMPT + steps,
                           **{key: seq[:, :LM_PROMPT]}, **img)
    if sync:
        torch.cuda.synchronize()
    t1 = time.monotonic()
    logits, toks = [lg], []
    for i in range(steps):
        if key == "frames":
            step = seq[:, LM_PROMPT + i:LM_PROMPT + i + 1]
        else:
            step = lg.argmax(-1).view(1, 1)
            toks.append(step)
        lg = lm.decode_step(cache, **{key: step})
        logits.append(lg)
    if sync:
        torch.cuda.synchronize()
    t2 = time.monotonic()
    out = torch.cat(logits)
    return (out, [int(x) for x in torch.cat(toks).view(-1)] if toks
            else None, t1 - t0, t2 - t1)


def phase_lm_f32(cfg, smi, totals, tag) -> None:
    """A float32 copy of musicgen-large (2 layers) or of the cut
    llama-3.2-vision-90b (its 5 layers) at full width, TF32 off, through
    LM.prefill / decode_step: LM_F32_STEPS decode steps through K1/K3
    (cross-attention K3 non-causal and K1 at t = 1023 included) against
    the same weights through the plain attention on the card, logits
    within TOL["f32"] of the logit scale, greedy tokens equal.  The audio
    stack is also held to its own training forward over the same frames
    (prefill + teacher-forced decode == forward at each position).
    Launches: K3 once a layer of either kind a prefill, K1 once a layer
    a step."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    t0 = time.monotonic()
    lm = LM(cfg, seed=1)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.num_layers} layers {cfg.block_pattern[:5]}, "
          f"{cfg.param_count():,} float32 parameters "
          f"({cfg.param_count() * 4 / 1e9:.1f} GB), seeded init "
          f"{time.monotonic() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(11)
    steps = LM_F32_STEPS
    key, seq, img = _lm_inputs(cfg, gen, steps)
    ops.reset_launches()
    cross_ctx, cross = _cross_launches()
    with cross_ctx:
        k_logits, k_toks, _, _ = _lm_run(lm, key, seq, img, steps)
    launches = dict(ops.LAUNCHES)
    with _plain_attention_ops():
        p_logits, p_toks, _, _ = _lm_run(lm, key, seq, img, steps)
    L = cfg.num_layers
    n_cross = lm.n_layers["xattn"]
    if launches["flash_attention"] != L \
            or launches["decode_attention"] != L * steps \
            or cross["flash_attention_cross"] != n_cross \
            or cross["decode_attention_cross"] != n_cross * steps:
        raise AssertionError(f"[{tag}] launches {launches} {cross}, "
                             f"expected K3 {L} and K1 {L} x {steps}, "
                             f"{n_cross} layers of them cross-attention")
    _add_launches(totals, launches, cross)
    worst = _max_err(k_logits, p_logits)
    scale = float(p_logits.abs().max())
    _check(f"[{tag}] logits", worst / max(1.0, scale), TOL["f32"])
    if k_toks != p_toks:
        raise AssertionError(f"[{tag}] greedy tokens differ: {k_toks} vs "
                             f"{p_toks}")
    extra = ""
    if key == "frames":
        with torch.no_grad():
            fwd = lm(frames=seq[:, :LM_PROMPT + steps], remat=False)[0]
        fwd = fwd[LM_PROMPT - 1:LM_PROMPT + steps]
        fworst = _max_err(k_logits, fwd)
        _check(f"[{tag}] decode vs forward", fworst / max(1.0, scale),
               TOL["f32"])
        extra = (f"; prefill + teacher-forced decode vs the training "
                 f"forward over the same frames {fworst:.3e}")
    print(f"[{tag}] card K1/K3 vs card plain attention: prefill "
          f"{LM_PROMPT} positions + {steps} decode steps, max|logit diff| "
          f"{worst:.3e} (logit scale {scale:.2f})"
          + (f", greedy tokens equal {k_toks}" if k_toks else "") + extra
          + f"; launches {launches}, cross-attention {cross}  [{smi}]")
    return lm


def _add_launches(totals, launches, cross=None) -> None:
    """Add a path's launches to a model's totals, the cross-attention
    ones under their own counters (and not the self-attention ones)."""
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    for k, v in (cross or {}).items():
        totals[k] = totals.get(k, 0) + v
        totals[k.replace("_cross", "")] -= v


def phase_lm_api(cfg, smi, totals, tag) -> None:
    """musicgen-large (all 48 layers) or llama-3.2-vision-90b (one
    pattern repeat: 5 layers) at full width in bf16, B 1, through
    LM.prefill / decode_step, as the reference's LM API drives them
    (neither goes through an engine: the engines build token batches
    only): a LM_PROMPT-position prompt (musicgen: seeded frames; vision:
    seeded tokens over 1024 seeded image rows), then LM_STEPS decode
    steps (musicgen teacher-forced on the seeded frames, vision greedy).
    Prints the prefill (TTFT) and decode ms/step beside the weight
    stream, the busy share and the longest kernels; K3 once a layer of
    either kind a prefill and K1 once a layer a step, exactly."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    t0 = time.monotonic()
    lm = LM(cfg, seed=0)
    torch.cuda.synchronize()
    n_self, n_cross = lm.n_attn, lm.n_layers["xattn"]
    print(f"[{tag}] {cfg.name} {cfg.dtype} {cfg.num_layers}L ({n_self} "
          f"self-attention, {n_cross} cross-attention) "
          f"d{cfg.d_model} {cfg.param_count():,} params, seeded init "
          f"{time.monotonic() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(12)
    key, seq, img = _lm_inputs(cfg, gen)
    _lm_run(lm, key, seq, img, steps=2)                 # first-call set-up
    ops.reset_launches()
    cross_ctx, cross = _cross_launches()
    with cross_ctx:
        logits, toks, t_pre, t_dec = _lm_run(lm, key, seq, img, sync=True)
    launches = dict(ops.LAUNCHES)
    L = cfg.num_layers
    if launches["flash_attention"] != L \
            or launches["decode_attention"] != L * LM_STEPS \
            or cross["flash_attention_cross"] != n_cross \
            or cross["decode_attention_cross"] != n_cross * LM_STEPS:
        raise AssertionError(f"[{tag}] launches {launches} {cross}, "
                             f"expected K3 {L} and K1 {L} x {LM_STEPS}")
    _check_path(f"[{tag}]", launches, ("decode_attention", "flash_attention"),
                ("paged_decode_attention", "gbdt_margins",
                 "gbdt_margins_packed"))
    _add_launches(totals, launches, cross)
    if not bool(torch.isfinite(logits).all()) or (
            toks and not all(0 <= x < cfg.vocab_size for x in toks)):
        raise AssertionError(f"[{tag}] non-finite logits or bad tokens")
    weights = _weight_bytes(lm)
    per = t_dec / LM_STEPS
    print(f"[{tag}] prefill {LM_PROMPT} positions (TTFT) "
          f"{t_pre * 1e3:.2f} ms, decode {per * 1e3:.3f} ms/step "
          f"({1 / per:.0f} steps/s) over {LM_STEPS} steps; the weight "
          f"stream ({weights / 1e9:.2f} GB) at 3.35 TB/s "
          f"{weights / HBM_BYTES_PER_S * 1e3:.3f} ms; K3 {L} a prefill ("
          f"{n_cross} non-causal), K1 {L} a step ({n_cross} over the "
          f"image cache), exact; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB"
          + (f"; greedy tokens {toks[:8]}..." if toks else "") + f"  [{smi}]")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _lm_run(lm, key, seq, img, steps=8, sync=True)
    _trace_report(prof.events(), 9, f"prefill {LM_PROMPT} + 8 decode steps",
                  smi, f"{tag}-profile")
    return lm


def xlstm_paths(predictor, smi) -> dict:
    """xlstm-350m (alternating sLSTM and mLSTM, no attention layer) at
    full width: a float32 one-repeat copy on the card against the CPU,
    then all 24 layers in bf16 through the serial engine (exact-length
    prefill), the sidecar and ring lanes.  Returns the paths' launch
    counts (K1 and K3 must stay 0; K5 scores the admissions)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    cfg = get_config("xlstm-350m")
    totals = {k: 0 for k in LAUNCHES}
    _timed(phase_xlstm_f32, dataclasses.replace(
        cfg, num_layers=len(cfg.block_pattern)), smi, totals, tag="xlstm-f32")
    launches, eng, tokens = _timed(phase_slice, cfg, predictor, smi,
                                   tag="xlstm-slice", long_new=JAMBA_LONG_NEW)
    for k, v in launches.items():
        totals[k] += v
    _timed(phase_sidecar, eng, predictor, smi, tokens, totals,
           tag="xlstm-sidecar", extras=False, long_new=JAMBA_LONG_NEW)
    del eng
    _free_card("xlstm-lanes")
    _timed(phase_hybrid_lanes, cfg, smi, totals, tag="xlstm-lanes")
    return totals


def phase_xlstm_f32(cfg, smi, totals, tag="xlstm-f32") -> None:
    """A float32 copy of xlstm-350m cut to one pattern repeat (2 layers:
    sLSTM, mLSTM) at full width, TF32 off, on the card against the same
    state dict on the CPU: a 40-token prefill at exact length and 8
    greedy steps, logits within TOL["f32"] of the logit scale, tokens
    equal; then the paging backlog (budgets capped at 16) through ring
    lanes on the card, each request's tokens equal to the serial
    engine's (no MoE here: a lane's arithmetic is the serial one's)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import BatchedRealEngine, RealEngine
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.monotonic()
    ser = RealEngine(cfg32, seed=1, max_len=L_MAX_LEN, segment_len=L_SEGMENT)
    cpu = LM(cfg32, device="cpu")
    cpu.load_state_dict(ser.lm.state_dict())
    print(f"[{tag}] {cfg32.num_layers} layers {cfg32.block_pattern}, "
          f"{cfg32.param_count():,} float32 parameters, init "
          f"{time.monotonic() - t0:.1f} s")
    toks = (torch.arange(3, 3 + 40) * 97 % cfg.vocab_size).view(1, 40)

    def greedy(lm):
        lg, cache = lm.prefill(toks.to(lm.device))
        logits, out = [lg.cpu()], []
        for _ in range(8):
            tok = lg.argmax(-1).view(1, 1)
            out.append(int(tok))
            lg = lm.decode_step(cache, tok)
            logits.append(lg.cpu())
        return torch.cat(logits), out
    ops.reset_launches()
    g_logits, g_toks = greedy(ser.lm)
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"[{tag}] launches {dict(ops.LAUNCHES)} with "
                             "no attention layer")
    c_logits, c_toks = greedy(cpu)
    worst = _max_err(g_logits, c_logits)
    scale = float(c_logits.abs().max())
    if g_toks != c_toks:
        raise AssertionError(f"[{tag}] greedy tokens differ: {g_toks} vs "
                             f"{c_toks}")
    _check(f"[{tag}] logits", worst / max(1.0, scale), TOL["f32"])
    print(f"[{tag}] card vs CPU (same state dict): prefill 40 tokens + 8 "
          f"greedy steps, max|logit diff| {worst:.3e} (logit scale "
          f"{scale:.2f}), tokens equal {g_toks}  [{smi}]")
    lanes = BatchedRealEngine(cfg32, state_dict=ser.lm.state_dict(),
                              max_len=L_MAX_LEN, segment_len=L_SEGMENT,
                              n_lanes=L_LANES)
    prompts, maxes = _pattern(cfg.vocab_size, np.random.default_rng(300),
                              long_new=16)
    ring = _drain_pattern(lanes, prompts, maxes)
    for k, v in ring["launches"].items():
        totals[k] += v
    serial = [ser.generate(p, max_new_tokens=m)["tokens"]
              for p, m in zip(prompts, maxes)]
    if ring["tokens"] != serial:
        raise AssertionError(f"[{tag}] ring-lane tokens differ from the "
                             "serial engine's")
    _check_path(f"[{tag}] ring", ring["launches"], (),
                ("decode_attention", "flash_attention",
                 "paged_decode_attention"))
    print(f"[{tag}] ring lanes ({L_LANES}), {len(prompts)} requests, "
          f"budgets capped at 16: tokens == the serial engine's, "
          f"{ring['steps']} lane steps, launches {ring['launches']}  "
          f"[{smi}]")
    del ser, cpu, lanes
    _free_card(tag)


def lm_api_paths(name, tag, smi, layers=None) -> dict:
    """musicgen-large or llama-3.2-vision-90b (``layers`` cuts its depth)
    at full width through the LM API: a float32 copy (musicgen: 2
    layers; vision: its 5) held to the plain attention, serving and then
    its loss's gradients; then the bf16 run, serving and then training
    the same weights.  Returns the paths' launch counts, the
    cross-attention ones under their own counters."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    cfg = get_config(name)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    totals = {k: 0 for k in LAUNCHES}
    totals.update(flash_attention_cross=0, decode_attention_cross=0,
                  flash_attention_bwd_cross=0)
    f32 = dataclasses.replace(cfg, dtype="float32",
                              num_layers=min(cfg.num_layers, 2)
                              if cfg.audio_frontend else cfg.num_layers)
    lm = _timed(phase_lm_f32, f32, smi, totals, tag=f"{tag}-f32")
    # B 1 for the vision copy: its float32 gradients are 23.8 GiB, kept
    # on the host while the plain attention's are taken
    gen = torch.Generator(device="cuda").manual_seed(23)
    _timed(_grads_vs_plain, lm, _arch_batch(
        f32, 1 if cfg.num_image_tokens else 2, gen)(0), smi,
           tag=f"{tag}-train-f32", host=bool(cfg.num_image_tokens))
    del lm
    _free_card(f"{tag}-f32")
    lm = _timed(phase_lm_api, cfg, smi, totals, tag=tag)
    _timed(phase_lm_train, lm, smi, totals, tag=f"{tag}-train")
    del lm
    return totals


def _free_card(tag) -> None:
    """Drop what earlier phases left on the card and print what stays
    and the peak so far; the peak restarts from here."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] card freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
          f" GiB allocated, peak so far "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()


def _timed(fn, *args, beside: str = "", **kw):
    """``fn(*args, **kw)``, printing its wall seconds (and what ran beside
    it: such a time is not the phase's alone)."""
    t0 = time.monotonic()
    out = fn(*args, **kw)
    note = f" (beside {beside})" if beside else ""
    print(f"[time] {fn.__name__} {kw.get('tag', '')}: "
         f"{time.monotonic() - t0:.1f} s{note}")
    return out


def _train_predictor():
    """The serving paths' predictor: 60 rounds on 2,400 sharegpt-profile
    prompts (seeded; the same trees in every process).  Returns (the
    dataset, the predictor)."""
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.core.predictor import Predictor
    from repro_torch.data.corpus import sample_dataset
    ds = sample_dataset("sharegpt", n=2400, seed=42, balanced=True)
    t0 = time.monotonic()
    predictor = Predictor.train(ds.prompts, ds.lengths,
                                GBDTParams(num_rounds=60), device="cuda")
    print(f"[predictor] trained 60 rounds on {len(ds)} prompts in "
          f"{time.monotonic() - t0:.1f} s (host)")
    return ds, predictor


# ------------------------------------------------- the side process
# jamba-v0.1-52b's and xlstm-350m's host-paced serving paths run in a
# child process (its own CUDA context and launch counters) beside the
# gemma3-4b-edge, musicgen and vision phases, so that the run stays
# inside its time limit on a slow host
SIDE_FLAG, SIDE_JAMBA_DONE = "--side-paths", "[side] jamba paths done"


def _child_setup() -> tuple:
    """A side process's start: line-buffered output, TF32 off, the card's
    name and limit, the serving paths' predictor.  Returns (smi,
    predictor).  The kernels are the parent's build."""
    import torch
    sys.stdout.reconfigure(line_buffering=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    _, predictor = _train_predictor()
    return smi, predictor


def side_paths() -> int:
    """The child of :func:`start_side_paths`: jamba-v0.1-52b's paths,
    then a line saying so (their card memory, up to 50.5 GiB, is free
    from there), then xlstm-350m's, then one JSON line of both models'
    launches."""
    smi, predictor = _child_setup()
    totals = {"jamba-v0.1-52b": jamba_paths(predictor, smi)}
    _free_card("xlstm")
    print(SIDE_JAMBA_DONE)
    totals["xlstm-350m"] = xlstm_paths(predictor, smi)
    print(json.dumps({"side_totals": totals}))
    return 0


def _start_self(flag, marker=None) -> dict:
    """Start ``python3 chip_smoke.py FLAG`` (``flag``: one argument or a
    list of them); a thread keeps its output lines and sets ``marked``
    once a line starts with ``marker`` or the child has ended."""
    import threading
    args = [flag] if isinstance(flag, str) else list(flag)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    run = {"proc": proc, "lines": [], "marked": threading.Event(),
           "t0": time.monotonic()}

    def pump():
        for line in proc.stdout:
            run["lines"].append(line.rstrip("\n"))
            if marker and line.startswith(marker):
                run["marked"].set()
        run["t_end"] = time.monotonic()      # its output closed: it ended
        run["marked"].set()
    run["thread"] = threading.Thread(target=pump, daemon=True)
    run["thread"].start()
    return run


def _child_secs(run) -> float:
    """Seconds from a :func:`_start_self` child's start to its end."""
    return run.get("t_end", time.monotonic()) - run["t0"]


def start_side_paths() -> dict:
    """Start :func:`side_paths` as ``python3 chip_smoke.py --side-paths``;
    ``marked`` is set once its jamba paths are done or it has ended."""
    return _start_self(SIDE_FLAG, SIDE_JAMBA_DONE)


def _side_failed(run) -> None:
    """Raise, with the child's output, if it has ended and not with 0."""
    code = run["proc"].poll()
    if code not in (None, 0):
        run["thread"].join(timeout=30)
        raise AssertionError(f"[side] the jamba/xlstm child exited {code}:\n"
                             + "\n".join(run["lines"][-60:]))


def wait_side_jamba(run, before: str) -> None:
    """Block until the child's jamba paths are done: ``before`` needs
    the card memory they hold."""
    t0 = time.monotonic()
    run["marked"].wait(timeout=900)
    if SIDE_JAMBA_DONE not in run["lines"]:       # it ended first
        run["proc"].wait(timeout=60)
    _side_failed(run)
    print(f"[side] waited {time.monotonic() - t0:.1f} s for the child's "
          f"jamba paths before {before}")


def collect_side_paths(run, smi) -> tuple:
    """Wait for the child, print its lines and return the launches of
    jamba-v0.1-52b's and xlstm-350m's paths."""
    run["proc"].wait(timeout=900)
    run["thread"].join(timeout=60)
    _side_failed(run)
    for line in run["lines"]:
        print(line)
    got = [json.loads(line) for line in run["lines"]
           if line.startswith('{"side_totals"')]
    if not got:
        raise AssertionError("[side] the child printed no launch counts")
    print(f"[side] jamba-v0.1-52b and xlstm-350m paths in a child process: "
          f"{_child_secs(run):.1f} s, beside the gemma3-4b-edge, musicgen "
          f"and vision phases (neither side's times are taken alone)  "
          f"[{smi}]")
    totals = got[0]["side_totals"]
    return totals["jamba-v0.1-52b"], totals["xlstm-350m"]


# ---------------------- gemma-2b, granite-8b, qwen3-32b, llama4, dbrx
# gemma-2b's paths and then [launch-serve] (host-bound, its own launch
# counters) run in a second side process beside the first; qwen3-32b
# (61.02 GiB of bf16 weights), llama4-maverick's repeat (68.6 GiB in
# float32) and dbrx-132b's 8 layers (50.86 GiB in bf16) each need the
# card to themselves and run last, once every child has ended
SECOND_FLAG = "--second-side-paths"
BIG_BURST = dict(n_long=BIG_LONG, n_short=BIG_SHORT, long_new=BIG_LONG_NEW,
                 short_new=BIG_SHORT_NEW)


def phase_paged_pool(cfg, smi, totals, tag) -> None:
    """The block-paged pool alone, for a model the card holds only once
    (no ring engine beside it): ``PagedBatchedEngine`` with 4 lanes, page
    16, max_len 128 and its default budget (a full window a lane), the
    paging backlog after a shared 48-token prefix with budgets capped at
    16 (long) and 8 (short), cold and then warm (``_prefix_passes``)."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import PagedBatchedEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = PagedBatchedEngine(cfg, max_len=L_MAX_LEN, segment_len=L_SEGMENT,
                             n_lanes=L_LANES, page_size=L_PAGE, seed=0)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} {cfg.dtype} {cfg.num_layers}L, {L_LANES} "
          f"lanes, page {L_PAGE}, max_len {L_MAX_LEN}, {eng.n_pages} pages "
          f"({eng.budget_bytes} B), engine {time.monotonic() - t0:.1f} s")
    prefix = np.random.default_rng(9).integers(
        1, cfg.vocab_size, size=L_PREFIX).astype(np.int64)
    pp, pm = _pattern(cfg.vocab_size, np.random.default_rng(102), prefix,
                      long_new=16, short_new=8)
    eng.generate_batch(pp[:L_LANES], 2)             # first-call set-up
    _prefix_passes(eng, pp, pm, totals, smi, tag)
    print(f"[{tag}] peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB  [{smi}]")
    del eng
    _free_card(tag)


def _card_use(where: str) -> float:
    """Print the card's GiB in use by every process beside what this
    process's allocator holds (allocated, and reserved: its cache too)
    ``where``.  Returns the GiB in use by every process."""
    import torch
    free, total = torch.cuda.mem_get_info()
    held = (total - free) / 2 ** 30
    print(f"{where} the card in use by every process: {held:.2f} of "
          f"{total / 2 ** 30:.2f} GiB; this process's allocator "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")
    return held


def _card_empty(before: str) -> None:
    """Raise unless the card holds (almost) nothing, whichever process
    holds it (this one's CUDA context and allocator cache count too):
    ``before`` builds a model that the card holds only alone."""
    held = _card_use(f"{before} before it:")
    if held > 2.0:
        raise AssertionError(f"{held:.2f} GiB of the card in use before "
                             f"{before}")


#: the models served whole in a side process, by print tag: gemma-2b (18
#: layers of 8 query heads over 1 KV head of width 256, GeGLU, the tied
#: 256,000-row head; 2,506,172,416 parameters) and granite-8b (36 layers of
#: 32 query heads over 8 KV heads of width 128, SwiGLU of width 14,336, an
#: untied 49,152-row head; 8,254,689,280 parameters, 15.38 GiB in bf16)
WHOLE = {"gemma2b": "gemma-2b", "granite": "granite-8b"}


def whole_model_paths(predictor, smi, tag) -> dict:
    """``WHOLE[tag]`` at full width and depth: a float32 copy cut to 2
    layers against the CPU's plain path and through ring lanes, paged
    lanes and the serial engine (the same tokens, bit for bit), then the
    whole stack in bf16 through the serial engine (the burst at
    smollm-360m's sizes), the sidecar, and ring lanes, paged lanes and
    the shared prefix.  Returns the paths' launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    cfg = get_config(WHOLE[tag])
    two = dataclasses.replace(cfg, num_layers=2)
    totals = {k: 0 for k in LAUNCHES}
    _timed(phase_full_width_reference, two, tag=f"{tag}-f32")
    _timed(phase_lanes_f32, two, smi, totals, tag=f"{tag}-f32")
    launches, eng, tokens = _timed(phase_slice, cfg, predictor, smi,
                                   tag=f"{tag}-slice")
    for k, v in launches.items():
        totals[k] += v
    _timed(phase_sidecar, eng, predictor, smi, tokens, totals,
           tag=f"{tag}-sidecar", extras=False)
    del eng
    _free_card(f"{tag}-lanes")
    _timed(phase_lanes, cfg, smi, totals, tag=f"{tag}-lanes")
    return totals


def second_side_paths() -> int:
    """``python3 chip_smoke.py --second-side-paths``: gemma-2b's
    :func:`whole_model_paths`, then ``[launch-serve]``, then one JSON line
    of each one's launches."""
    from repro_torch.kernels._build import LAUNCHES
    smi, predictor = _child_setup()
    totals = {"gemma-2b": _timed(whole_model_paths, predictor, smi,
                                 tag="gemma2b")}
    _free_card("launch-serve")
    totals["launch-serve"] = {k: 0 for k in LAUNCHES}
    _timed(phase_launch_serve, smi, totals["launch-serve"])
    print(json.dumps({"child_totals": totals}))
    return 0


# granite-8b's paths (15.38 GiB of bf16 weights, 32 GiB with the lanes'
# two engines) run in a child of their own once [tp]'s late pair has
# exited, beside (k), the end of [speculative], [train] and [mesh], which
# hold little of the card; the kernel phases after them wait for it
GRANITE_FLAG = "--granite-paths"


def granite_side_paths() -> int:
    """``python3 chip_smoke.py --granite-paths``: granite-8b's
    :func:`whole_model_paths`, then one JSON line of its launches."""
    smi, predictor = _child_setup()
    print(json.dumps({"child_totals": {"granite-8b": _timed(
        whole_model_paths, predictor, smi, tag="granite")}}))
    return 0


def collect_child(run, smi, tag, what, beside) -> dict:
    """Wait for a side process that ends in a ``child_totals`` JSON line
    (:func:`second_side_paths`, :func:`granite_side_paths`), print its
    lines and return that line's launch counts, by model."""
    run["proc"].wait(timeout=900)
    run["thread"].join(timeout=60)
    code = run["proc"].returncode
    if code != 0:
        raise AssertionError(f"[{tag}] the child exited {code}:\n"
                             + "\n".join(run["lines"][-60:]))
    for line in run["lines"]:
        print(line)
    got = [json.loads(line) for line in run["lines"]
           if line.startswith('{"child_totals"')]
    if not got:
        raise AssertionError(f"[{tag}] the child printed no launch counts")
    print(f"[{tag}] {what} in a child process: {_child_secs(run):.1f} s, "
          f"beside {beside} (neither side's times are taken alone)  "
          f"[{smi}]")
    return got[0]["child_totals"]


def qwen3_paths(predictor, smi) -> dict:
    """qwen3-32b whole: all 64 layers (64 query heads over 8 KV heads of
    width 128 with QK-norm, SwiGLU of width 25,600, vocabulary 151,936,
    an untied head; 32,762,123,264 parameters, 61.02 GiB in bf16) on the
    card alone, one engine at a time.  A float32 copy cut to 2 layers at
    full width against the CPU's plain path (prefill + 8 greedy steps)
    and through ring lanes, paged lanes and the serial engine (the same
    tokens, bit for bit); then the 64 layers in bf16: the serial engine
    under FCFS and SJF on a burst of 2 longs of 24 new tokens and 4
    shorts of 4 (fused decode == the per-token oracle over 16 tokens,
    the profile, TTFT, ms/token beside the 65.5 GB weight stream, the
    peak memory), the same burst over HTTP under SJF, and the block-paged
    pool with a shared prefix.  Returns the paths' launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    cfg = get_config("qwen3-32b")
    two = dataclasses.replace(cfg, num_layers=2)
    totals = {k: 0 for k in LAUNCHES}
    _card_empty("[qwen3-f32]")
    _timed(phase_full_width_reference, two, tag="qwen3-f32")
    _timed(phase_lanes_f32, two, smi, totals, tag="qwen3-f32")
    _free_card("qwen3-slice")
    _card_empty("[qwen3-slice]")
    launches, eng, tokens = _timed(phase_slice, cfg, predictor, smi,
                                   tag="qwen3-slice", oracle_new=BIG_ORACLE,
                                   **BIG_BURST)
    for k, v in launches.items():
        totals[k] += v
    _timed(phase_sidecar, eng, predictor, smi, tokens, totals,
           tag="qwen3-sidecar", extras=False, sjf_only=True, **BIG_BURST)
    del eng
    _free_card("qwen3-paged")
    _card_empty("[qwen3-paged]")
    _timed(phase_paged_pool, cfg, smi, totals, tag="qwen3-paged")
    return totals


#: the MoE stacks cut by depth and served with the card to themselves, by
#: print tag: (arch id, layers).  llama4-maverick by one of its 24 pattern
#: repeats (attention + a dense SwiGLU of width 8,192, then attention + a
#: MoE of 128 experts top-1; 40 query heads over 8 KV heads of width 128,
#: vocabulary 202,048; 18,427,438,080 parameters: the whole model, 735 GiB
#: in bf16, does not fit one card; its float32 copy 68.6 GiB); dbrx-132b by
#: 8 of its 40 layers (each attention of 48 query heads over 8 KV heads of
#: width 128, then a MoE of 16 experts of width 10,752, top-4; vocabulary
#: 100,352; 27,305,809,920 parameters, 50.86 GiB in bf16: the whole model,
#: 245 GiB, does not fit; its float32 copy one layer, 16.7 GiB; at B 1 each
#: expert takes one slot, so a token streams every expert's weights)
CUT_MOE = {"llama4": ("llama4-maverick-400b-a17b", 2),
           "dbrx": ("dbrx-132b", DBRX_LAYERS)}


def cut_moe_paths(predictor, smi, tag) -> dict:
    """``CUT_MOE[tag]`` at full width and its cut depth, on the card
    alone: a float32 copy of one pattern repeat through K1/K3 against the
    plain attention on the same weights (prefill + 8 greedy steps, then
    ring lanes against ring lanes: MoE capacity spans a step's tokens),
    then bf16 through the serial engine (the burst of
    :func:`qwen3_paths`, exact-length prefill), the sidecar under SJF, and
    ring lanes after the block-paged and speculative engines refuse the
    stack.  Returns the paths' launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import LAUNCHES
    arch, layers = CUT_MOE[tag]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    totals = {k: 0 for k in LAUNCHES}
    _card_empty(f"[{tag}-f32]")
    _timed(phase_jamba_f32, cfg, smi, totals, tag=f"{tag}-f32")
    _card_use(f"[{tag}-f32] after it:")
    launches, eng, tokens = _timed(phase_slice, cfg, predictor, smi,
                                   tag=f"{tag}-slice", oracle_new=BIG_ORACLE,
                                   **BIG_BURST)
    for k, v in launches.items():
        totals[k] += v
    _timed(phase_sidecar, eng, predictor, smi, tokens, totals,
           tag=f"{tag}-sidecar", extras=False, sjf_only=True, **BIG_BURST)
    del eng
    _free_card(f"{tag}-lanes")
    _timed(phase_hybrid_lanes, cfg, smi, totals, tag=f"{tag}-lanes")
    return totals


# ------------------------------------------------- the examples process
# the six examples_torch/ scripts (their main() on the card, as a user
# runs them) in a child process of their own beside the trained stacks'
# device-bound phases
EXAMPLES_FLAG = "--examples"
# train_lm's runs: (steps, full width); at its defaults (the reduced
# smollm, 200 steps) and all 32 layers of smollm-360m for 60 steps
TRAIN_RUNS = {"train_lm": (200, False), "train_lm-full": (60, True)}
# (tag, script, arguments before --ckpt and --device), in run order
EXAMPLES = (("quickstart", "quickstart", []),
            ("routing", "multireplica_routing", []),
            ("batched", "batched_serve", []),
            ("speculative", "speculative_serve", []),
            ("sidecar", "serve_sidecar", []),
            ("sidecar-http", "serve_sidecar", ["--http"]),
            ("train_lm", "train_lm", []),
            ("train_lm-full", "train_lm", ["--full", "--steps", "60"]))
# what each script's path launches: K5 where prompts are scored, K3 and K1
# where it decodes, K3b where it trains; never K4 nor the paged K2
SCORES = ("quickstart", "routing", "sidecar", "sidecar-http")
DECODES = ("batched", "speculative", "sidecar")


def _count_lm_calls():
    """Count every ``LM``'s prefills, decode steps and verify positions,
    each times its attention layers: the K3 and K1 launches a serving
    path must make.  Returns (context manager, counts)."""
    from contextlib import contextmanager
    from repro_torch.models.model import LM
    from repro_torch.models.transformer import attention_layers
    counts = {"flash_attention": 0, "decode_attention": 0}

    def wrap(name, kernel, positions):
        real = getattr(LM, name)

        def counted(self, *a, **kw):
            counts[kernel] += positions(*a, **kw) * attention_layers(
                self.cfg)
            return real(self, *a, **kw)
        return real, counted

    spies = {"prefill": ("flash_attention", lambda *a, **kw: 1),
             "decode_step": ("decode_attention", lambda *a, **kw: 1),
             "verify_step": ("decode_attention", lambda *a, **kw: int(
                 kw["tokens"].shape[1] if "tokens" in kw
                 else a[1].shape[1]))}

    @contextmanager
    def ctx():
        reals = {}
        for name, (kernel, positions) in spies.items():
            reals[name], counted = wrap(name, kernel, positions)
            setattr(LM, name, counted)
        try:
            yield
        finally:
            for name, real in reals.items():
                setattr(LM, name, real)
    return ctx(), counts


def _example_claims(tag, out, text) -> None:
    """Raise unless the script's own printed claims hold."""
    if tag == "quickstart":
        ok = 0.62 <= out["ranking_accuracy"] <= 0.96 and \
            out["sjf_short_p50"] < out["fcfs_short_p50"]
    elif tag == "routing":
        ok = "drained 80 of 80 after hedging" in text and \
            "100 of 100 served" in text
    elif tag == "batched":
        ok = out["same"] and \
            "token counts identical across budgets: True" in text
    elif tag == "speculative":
        ok = all(r["equal"] for r in out.values()) and text.count(
            "bitwise-equal to fused reference: True") == 2
    elif tag in ("sidecar", "sidecar-http"):
        ok = out["short_p50"]["sjf"] < out["short_p50"]["fcfs"]
    else:
        # at full width the JAX script's lr (3e-3) does not bring the
        # loss down within 200 steps (PERF.md, Findings): there the run is
        # held to finite losses, its launches and its checkpoint
        steps, full = TRAIN_RUNS[tag]
        ok = all(math.isfinite(x) for x in out) and len(out) == steps and \
            (full or out[-1] < out[0])
    if not ok:
        raise AssertionError(f"[examples] {tag}: the script's claim does "
                             f"not hold:\n{text}")


def _example_launches(tag, launched, want) -> None:
    """Raise unless the script's path launched its kernels: K5 where it
    scores, K3 and K1 exactly a layer a prefill and a decode position
    where it decodes, K3 2 x and K3b 1 x the layers a step where it
    trains; never K4 or K2."""
    from repro_torch.configs import get_config
    run = (("gbdt_margins_packed",) if tag in SCORES else ()) + \
        (("flash_attention", "decode_attention") if tag in DECODES else ())
    skip = ["gbdt_margins", "paged_decode_attention"]
    if tag in TRAIN_RUNS:
        steps, full = TRAIN_RUNS[tag]
        cfg = get_config("smollm-360m")
        n = steps * (cfg if full else cfg.reduced()).num_layers
        if (launched["flash_attention"], launched["flash_attention_bwd"]) \
                != (2 * n, n):
            raise AssertionError(f"[examples] {tag}: launches {launched}, "
                                 f"expected K3 {2 * n} and K3b {n}")
    else:
        skip += ["flash_attention_bwd"]
        if tag not in DECODES:
            skip += ["flash_attention", "decode_attention"]
        elif any(launched[k] != want[k] for k in want):
            raise AssertionError(f"[examples] {tag}: launches {launched}, "
                                 f"expected {want} from its LM calls")
    _check_path(f"[examples] {tag}", launched, run, skip)


def examples_paths() -> int:
    """The ``--examples`` child: each example script's
    ``main([..., "--device", "cuda"])`` in turn (each train_lm run with a
    checkpoint directory of its own), its output captured and printed
    with its tag, the launch counters reset before it and read after, its
    claims and launches checked; then one JSON line of each script's wall
    seconds, launches and peak card memory.  The kernels are the
    parent's build."""
    import importlib.util
    import io
    import tempfile
    import torch
    from repro_torch.kernels import ops
    sys.stdout.reconfigure(line_buffering=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="examples_", dir=os.path.join(ROOT,
                                                                 "build"))
    report = {}
    try:
        for tag, script, args in EXAMPLES:
            spec = importlib.util.spec_from_file_location(
                f"example_{script}",
                os.path.join(ROOT, "examples_torch", f"{script}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            ckpt = os.path.join(tmp, tag)
            argv = args + (["--ckpt", ckpt] if script == "train_lm" else []) \
                + ["--device", "cuda"]
            ctx, want = _count_lm_calls()
            buf = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.monotonic()
            with ctx, contextlib.redirect_stdout(buf):
                out = mod.main(argv)
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            launched = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            text = buf.getvalue()
            for line in text.splitlines():
                print(f"[examples:{tag}] {line}")
            _example_claims(tag, out, text)
            _example_launches(tag, launched, want)
            if tag in TRAIN_RUNS and not os.path.isdir(os.path.join(
                    ckpt, f"step_{TRAIN_RUNS[tag][0]:06d}")):
                raise AssertionError(f"[examples] {tag}: no final "
                                     f"checkpoint in {ckpt}")
            report[tag] = {"s": round(secs, 1), "peak_gib": round(
                peak / 2 ** 30, 2), "launches": {
                    k: v for k, v in launched.items() if v}}
            print(f"[examples:{tag}] ok in {secs:.1f} s, peak "
                  f"{peak / 2 ** 30:.2f} GiB, launches "
                  f"{report[tag]['launches']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"examples": report}))
    return 0


def collect_examples(run, smi) -> None:
    """Wait for the ``--examples`` child (:func:`examples_paths`), print its lines, fail if it failed,
    and print one ``[examples]`` line: each script's wall seconds,
    launches (smollm-360m-reduced's, full smollm's in train_lm) and peak
    card memory."""
    code = run["proc"].wait(timeout=900)
    run["thread"].join(timeout=60)
    for line in run["lines"]:
        print(line)
    if code != 0:
        raise AssertionError(f"[examples] the child exited {code}")
    got = [json.loads(line)["examples"] for line in run["lines"]
           if line.startswith('{"examples"')]
    if not got or [t for t, _, _ in EXAMPLES] != list(got[0]):
        raise AssertionError("[examples] the child reported no result for "
                             "some script")
    print("[examples] " + "; ".join(
        f"{tag} {r['s']} s, {r['peak_gib']} GiB, {r['launches']}"
        for tag, r in got[0].items()) + f"  [{smi}]")
    print(f"[examples] the six scripts in a child process: "
          f"{time.monotonic() - run['t0']:.1f} s, beside the trained "
          f"stacks' phases (not taken alone)  [{smi}]")


# ------------------------------------------------- the tensor-parallel ranks
# gemma3-4b-edge's, smollm-360m's and dbrx-132b's train steps over a
# ("data", "model") = (1, 2) mesh: two child processes on the one card
# joined in a gloo group of their own (CUDA tensors; NCCL refuses two
# ranks on one device), started after the kernel phases and run beside the
# smollm serving phases (about 25-28 GiB each at most)
TP_FLAG = "--tp-rank"
TP_B, TP_STEPS, TP_F32_STEPS, TP_SEED = 2, 3, 2, 11
#: (h)'s sequence and layers: the sLSTM runs token by token
TP_XLSTM_S, TP_XLSTM_LAYERS = 128, 4
TP_KERNELS = ("flash_attention", "flash_attention_bwd")


def _tp_state(cfg, opt, mesh):
    """``LM(cfg)`` from ``TP_SEED`` on the card, each parameter cut at once
    to this rank's block of its spec, and AdamW moments of the blocks
    (the whole model's moments are never made).  Returns the state."""
    import torch
    from repro_torch.models.model import LM
    from repro_torch.sharding.partition import local_shard
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import TrainState, state_specs
    lm = LM(cfg, device="cuda", seed=TP_SEED)
    specs = state_specs(cfg, opt, mesh)
    for n, p in lm.named_parameters():
        if specs[f"model/{n}"]:
            p.data = local_shard(p.data, specs[f"model/{n}"], mesh)
    torch.cuda.empty_cache()
    lm.requires_grad_(True)
    return TrainState(lm, init_opt_state(dict(lm.named_parameters()), opt,
                                         len(cfg.block_pattern)))


#: (f)/(h): the plain single-device step's bound when the ranks are held
#: to the one that sums in their order (``_rank_order``)
TP_PLAIN_TOL = 1e-3


@contextlib.contextmanager
def _rank_order(lm, specs, n):
    """On one device, each product of a weight whose spec splits its rows
    over ``model`` (``x_proj``, ``out_proj``, ``wo_out``, ``down``,
    ``w_down``, ``wo``) summed over the ``n`` ranks' blocks of rows, as
    the ranks' partial products are summed; every other product as is.
    The same function in the ranks' order of summation: at full width
    a Mamba's gradient moves by ~1e-5 relative with that order alone
    (its ``exp(dt A)`` scales a last-bit change of dt)."""
    from repro_torch.models import attention, layers, ssm, xlstm
    from repro_torch.sharding.tensor_parallel import split_over_model
    rows = {id(p) for name, p in lm.named_parameters()
            if p.dim() == 2 and split_over_model(specs[f"model/{name}"], 0)}
    plain = layers.dense

    def dense(x, w):
        if id(w) not in rows:
            return plain(x, w)
        c = w.shape[0] // n
        out = plain(x[..., :c], w[:c])
        for r in range(1, n):
            out = out + plain(x[..., r * c:(r + 1) * c], w[r * c:(r + 1) * c])
        return out
    mods = (attention, layers, ssm, xlstm)
    for m in mods:
        m.dense = dense
    try:
        yield
    finally:
        for m in mods:
            m.dense = plain


def _tp_against_one(cfg, opt, mesh, tag, part, tol, seq=None,
                    order=False, alone=False, on_rank0=False) -> dict:
    """``TP_F32_STEPS`` float32 steps of ``cfg`` (``opt``) at B ``TP_B`` x
    ``seq`` (``TRAIN_S`` when None) through ``make_train_step(mesh=)``
    held to the single-device step from the same weights and batches:
    (loss, grad norm) within ``tol`` relative at every step, this rank's
    parameter blocks within atol 5e-4, rtol 5e-3; each step's collectives
    over ``model`` equal to the roofline's count and its K3/K3b launches
    2 x / 1 x the self- and cross-attention layers.

    With ``order`` (a Mamba stack, whose gradient at full width moves by
    ~1e-5 relative with the order of a sum alone, and which AdamW's
    first +-lr update then carries into the next step) each step is held
    to one device's step from the ranks' whole state before it (gathered
    over ``model``), summing its row-split products in the ranks' order
    (:func:`_rank_order`); the plain single-device run of every step
    from the initial weights is held within ``TP_PLAIN_TOL``.  With
    ``alone`` (a model whose single-device step does not fit the card
    twice beside the ranks) the ranks run the single-device steps one
    after the other, each rank's blocks on the host meanwhile.  With
    ``on_rank0`` (many ranks on the card) the ranks' blocks are gathered
    whole and rank 0 alone runs the single-device steps and holds the
    whole parameters to them.  Prints one line; returns the launches,
    the ms of each step, this rank's peak GiB, the collectives a step and
    each step's (loss, grad norm)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import tensor_parallel_bytes
    from repro_torch.models.transformer import flash_layers
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding.partition import gather_shard, local_shard
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step,
                                                 state_specs)
    seq = seq or TRAIN_S
    batch = _arch_batch(cfg, TP_B, None, seq)
    state = _tp_state(cfg, opt, mesh)
    step = make_train_step(cfg, opt, mesh=mesh)
    specs = state_specs(cfg, opt, mesh)
    pspecs = {k[len("model/"):]: v for k, v in specs.items()
              if k.startswith("model/")}
    count = tensor_parallel_bytes(cfg, pspecs, mesh, TP_B, seq,
                                  optimizer=opt.kind)
    L, A = cfg.num_layers, flash_layers(cfg)
    n_model = mesh.mesh.shape[1]
    got, launched, starts, ms = [], {k: 0 for k in TP_KERNELS}, [None], []

    def whole(st):
        """The ranks' whole state on the host: parameters, moments."""
        out = {f"model/{n}": p.detach()
               for n, p in st.model.named_parameters()}
        out.update({f"opt/{k}/{n}": t for k, tree in
                    (("m", st.opt.m), ("v", st.opt.v))
                    for n, t in tree.items()})
        return {k: gather_shard(t, specs[k], mesh).to("cpu", copy=True)
                for k, t in out.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TP_F32_STEPS):
        if order and i:
            starts.append(whole(state))
        tp.reset_collectives()
        before = dict(ops.LAUNCHES)
        t0 = time.monotonic()
        state, m = step(state, batch(i))
        got.append((float(m["loss"]), float(m["grad_norm"])))
        ms.append(1e3 * (time.monotonic() - t0))
        now = {k: ops.LAUNCHES[k] - before[k] for k in TP_KERNELS}
        if now != {"flash_attention": 2 * A, "flash_attention_bwd": A}:
            raise AssertionError(f"{tag} ({part}) step {i} launched {now}; "
                                 f"expected K3 2 x {A} and K3b {A}")
        if tp.snapshot() != count:
            raise AssertionError(f"{tag} ({part}) collectives "
                                 f"{tp.snapshot()}, the roofline counts "
                                 f"{count}")
        for k in TP_KERNELS:
            launched[k] += now[k]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if on_rank0:
        blocks = {n: gather_shard(p.detach(), specs[f"model/{n}"],
                                  mesh).cpu()
                  for n, p in state.model.named_parameters()}
    else:
        blocks = {n: p.detach().cpu() if alone else p.detach()
                  for n, p in state.model.named_parameters()}
    del state, step
    torch.cuda.empty_cache()

    def single(ordered, restart):
        """One device's steps from the initial weights, or with
        ``restart`` each from the ranks' state before it."""
        one = init_train_state(cfg, opt, device="cuda", seed=TP_SEED)
        step = make_train_step(cfg, opt)
        out = []
        with (_rank_order(one.model, specs, 2) if ordered
              else contextlib.nullcontext()), torch.no_grad():
            for i in range(TP_F32_STEPS):
                if restart and starts[i] is not None:
                    params = dict(one.model.named_parameters())
                    for k, t in starts[i].items():
                        kind, name = k.split("/", 1)
                        dst = params[name] if kind == "model" else \
                            getattr(one.opt, name[0])[name[2:]]
                        dst.copy_(t)
                with torch.enable_grad():
                    one, m = step(one, batch(i))
                out.append((float(m["loss"]), float(m["grad_norm"])))
        return one, out

    def max_rel(got, want):
        return max(abs(a - b) / abs(b) for g, w in zip(got, want)
                   for a, b in zip(g, w))
    plain_note = ""
    if order:
        one, plain = single(False, False)
        del one
        plain_rel = max_rel(got, plain)
        if plain_rel > TP_PLAIN_TOL:
            raise AssertionError(f"{tag} ({part}) f32 (loss, grad norm) "
                                 f"{got} against the plain single-device "
                                 f"step's {plain}")
        plain_note = (
            " (each from the ranks' state before it, summing its row-split "
            "products in the ranks' order; the plain single-device steps "
            "from the initial weights " + ", ".join(
                f"({a:.6f}, {b:.6f})" for a, b in plain) + f" at max rel "
            f"{plain_rel:.2e}, <= {TP_PLAIN_TOL:g})")

    def hold():
        """This rank's run against the single-device one."""
        one, want = single(order, order)
        rel = max_rel(got, want)
        if rel > tol:
            raise AssertionError(f"{tag} ({part}) f32 (loss, grad norm) "
                                 f"{got} against the single-device step's "
                                 f"{want}{plain_note}")
        worst = 0.0
        for n, p in one.model.named_parameters():
            ref = p.detach() if on_rank0 else local_shard(
                p.detach(), specs[f"model/{n}"], mesh)
            mine = blocks[n].to(ref.device)
            if not torch.allclose(mine, ref, atol=5e-4, rtol=5e-3):
                raise AssertionError(f"{tag} ({part}) f32 parameter {n} "
                                     "differs from the single-device step's")
            worst = max(worst, _max_err(mine, ref))
        del one
        torch.cuda.empty_cache()
        return want, rel, worst
    head = (f"{tag} ({part}) f32 {cfg.name} {L} layers ({A} attention) at "
            f"full width, {TP_F32_STEPS} {opt.kind} steps at B{TP_B} x "
            f"S{seq} over model {n_model}, {_stream(mesh, TP_B, seq)} (ms a "
            f"step " + " ".join(f"{x:.1f}" for x in ms)
            + f"; peak {peak:.2f} GiB):")
    tail = (f"collectives over model a step {_kinds(count)}, as the roofline "
            f"counts; launches a step K3 {2 * A}, K3b {A}")
    if on_rank0 and dist.get_rank():
        print(f"{head} {tail}; held on rank 0")
    else:
        if alone:
            for r in range(dist.get_world_size()):
                if r == dist.get_rank():
                    want, rel, worst = hold()
                dist.barrier()
        else:
            want, rel, worst = hold()
        whose = "the whole parameters" if on_rank0 else "this rank's blocks"
        print(f"{head} (loss, grad norm) " + ", ".join(
                  f"({a:.6f}, {b:.6f})" for a, b in got) + " against the "
              f"single-device step's " + ", ".join(
                  f"({a:.6f}, {b:.6f})" for a, b in want) + plain_note
              + f": max rel {rel:.2e} (<= {tol:g}); {whose} max|diff| "
              f"{worst:.2e} (atol 5e-4, rtol 5e-3); {tail}"
              + (" (the ranks' single-device steps one after the other)"
                 if alone else ""))
    if on_rank0:
        dist.barrier()
    del starts, blocks
    torch.cuda.empty_cache()
    return {"launches": launched, "ms": ms, "peak_gib": peak, "count": count,
            "steps": got}


def _kinds(count: dict) -> str:
    """A step's collectives by kind, calls and MB handed over."""
    return ", ".join(f"{k} {v['calls']} ({v['bytes'] / 1e6:.2f} MB)"
                     for k, v in count.items() if v["calls"])


def _stream(mesh, B, S) -> str:
    """How the residual stream between blocks lies over ``model`` at B x
    S under the default rules (``seq_sp``)."""
    from repro_torch.sharding.rules import spec_for
    from repro_torch.sharding.tensor_parallel import split_over_model
    n = mesh.mesh.shape[1]
    spec = spec_for((B, S, 1), ("batch", "seq_sp", "embed"), mesh)
    if split_over_model(spec, 1):
        return f"the stream split by positions, {S // n} a rank"
    return (f"the stream whole on every rank (S {S} does not divide over "
            f"model {n})")


def _record_routes(moe) -> list:
    """Record the experts (T, K) of ``moe``'s first routing from now on
    (the step's forward; the recomputation's is not kept).  The wrapper
    holds the module weakly: no cycle keeps it on the card once its
    model is dropped."""
    import weakref
    routes, route, ref = [], type(moe)._route, weakref.ref(moe)

    def recording(ht, router):
        out = route(ref(), ht, router)
        if not routes:
            routes.append(out[2].cpu())
        return out
    moe._route = recording
    return routes


#: the bf16 MoE stacks of ``[tp]`` by part: (arch, layers kept, the MoE
#: layer whose routes are compared, what the line says of the stack)
TP_MOE = {
    "e": ("dbrx-132b", 1, 0,
          "cut to 1 of 40 layers over (1, 2) (attention 48 over 8 heads at "
          "hd 128, 24 over 4 a rank; 16 experts of d_ff 10752 top-4, 8 a "
          "rank"),
    "g": ("jamba-v0.1-52b", 2, 1,
          "cut to 2 of 32 layers over (1, 2) (Mamba, Mamba + MoE: d_inner "
          "8192, 4096 channels a rank; 16 experts of d_ff 14336 top-2, 8 a "
          "rank"),
}


def _tp_moe_cfg(part):
    import dataclasses
    from repro_torch.configs import get_config
    arch, layers, _, _ = TP_MOE[part]
    return dataclasses.replace(get_config(arch), num_layers=layers)


#: (B, S) of the MoE parts' one step routed in fewer dispatch groups than
#: ranks: dbrx-132b's B 1 x 511 tokens are one group over model 2
TP_FEW = {"e": (1, 511)}


def _tp_moe(part, rank, mesh, opt, tag, out_dir) -> dict:
    """(e) and (g): a MoE stack of ``TP_MOE`` at full width, bf16,
    ``TP_STEPS`` AdamW steps at B ``TP_B`` x 512 over model 2: per step
    its wall ms, its collectives over ``model`` by kind (equal to the
    roofline's count), K3 2 and K3b 1 launches an attention layer, a
    finite loss; peak memory.  The experts of this rank's group at step
    1 go to ``out_dir`` for the parent's one-device comparison.  With a
    ``TP_FEW`` shape (e′), first one step from the same initial weights
    at that shape, whose tokens route in one group, fewer than the ranks:
    its collectives (no all-to-all) equal to the roofline's, its routes
    to ``out_dir`` too."""
    import statistics
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import tensor_parallel_bytes
    from repro_torch.models.transformer import attention_layers
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.training.train_loop import make_train_step, state_specs
    cfg = _tp_moe_cfg(part)
    arch, _, layer, desc = TP_MOE[part]
    A = attention_layers(cfg)
    batch = _arch_batch(cfg, TP_B, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, opt, mesh=mesh)
    pspecs = {k[len("model/"):]: v for k, v in
              state_specs(cfg, opt, mesh).items() if k.startswith("model/")}
    launched = {k: 0 for k in TP_KERNELS}

    def one_step(state, bt, count, label):
        tp.reset_collectives()
        before = dict(ops.LAUNCHES)
        t0 = time.monotonic()
        state, m = step(state, bt)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        now = {k: ops.LAUNCHES[k] - before[k] for k in TP_KERNELS}
        if now != {"flash_attention": 2 * A, "flash_attention_bwd": A}:
            raise AssertionError(f"{tag} ({label}) launched {now}; "
                                 f"expected K3 {2 * A} and K3b {A}")
        if tp.snapshot() != count:
            raise AssertionError(f"{tag} ({label}) collectives "
                                 f"{tp.snapshot()}, the roofline counts "
                                 f"{count}")
        if not math.isfinite(loss):
            raise AssertionError(f"{tag} ({label}) bf16 loss {loss}")
        for k in TP_KERNELS:
            launched[k] += now[k]
        return state, loss, secs
    few = None
    if part in TP_FEW:
        B1, S1 = TP_FEW[part]
        state = _tp_state(cfg, opt, mesh)
        routes = _record_routes(state.model.blocks[layer].moe)
        count1 = tensor_parallel_bytes(cfg, pspecs, mesh, B1, S1)
        if count1["all-to-all"]["calls"]:
            raise AssertionError(f"{tag} ({part}′) counts all-to-alls")
        state, loss1, secs1 = one_step(state, _arch_batch(cfg, B1, None, S1)(0),
                                       count1, part + "′")
        torch.save(routes[0], os.path.join(out_dir, f"{part}1_route{rank}.pt"))
        few = {"loss": loss1, "ms": 1e3 * secs1, "shape": [B1, S1]}
        print(f"{tag} ({part}′) bf16 {arch} at full width {desc}), one "
              f"AdamW step at B{B1} x S{S1} from the initial weights, "
              f"{_stream(mesh, B1, S1)}: its "
              f"{B1 * S1} tokens route in one dispatch group over model 2, "
              f"every rank routing it and running its own experts over the "
              f"group's slots: loss {loss1:.4f}; {1e3 * secs1:.1f} ms; "
              f"collectives over model {_kinds(count1)}, as the roofline "
              f"counts (no all-to-all); launches K3 {2 * A}, K3b {A}")
        del state, routes
        torch.cuda.empty_cache()
    state = _tp_state(cfg, opt, mesh)
    routes = _record_routes(state.model.blocks[layer].moe)
    count = tensor_parallel_bytes(cfg, pspecs, mesh, TP_B, TRAIN_S)
    losses, secs = [], []
    for i in range(TP_STEPS):
        state, loss, sec = one_step(state, batch(i), count, part)
        losses.append(loss)
        secs.append(sec)
    peak = torch.cuda.max_memory_allocated()
    torch.save(routes[0], os.path.join(out_dir, f"{part}_route{rank}.pt"))
    ms = [1e3 * x for x in secs]
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"{tag} ({part}) bf16 {arch} at full width {desc}; "
          f"{n_params:,} parameters a rank), AdamW lr {opt.lr}, B{TP_B} x "
          f"S{TRAIN_S}, {_stream(mesh, TP_B, TRAIN_S)}, {TP_STEPS} steps: "
          f"losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; ms a step "
          + " ".join(f"{x:.1f}" for x in ms) + f" (median "
          f"{statistics.median(ms):.1f}); peak {peak / 2 ** 30:.2f} GiB; "
          f"collectives over model a step {_kinds(count)}, as the "
          f"roofline counts; launches a step K3 {2 * A}, K3b {A}; this "
          f"rank {time.monotonic() - T_START:.1f} s from its start")
    del state, step
    torch.cuda.empty_cache()
    return {"losses": losses, "peak_gib": peak / 2 ** 30,
            "launches": launched, "ms": ms, "few": few}


def _tp_bf16(cfg, opt, mesh, tag, part, desc, falls=False) -> dict:
    """``TP_STEPS`` bf16 steps of ``cfg`` (``opt``) at full width at B
    ``TP_B`` x ``TRAIN_S`` through ``make_train_step(mesh=)``: per step
    its wall ms, its collectives over ``model`` by kind (equal to the
    roofline's count) and the K3/K3b launches (2 x and 1 x the self- and
    cross-attention layers, the cross-attention ones counted apart); the
    loss finite (and with ``falls`` lower at the end); peak memory.
    Prints one line; returns the losses, peak GiB, ms and launches (the
    self-attention ones apart from the cross-attention ones)."""
    import statistics
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import tensor_parallel_bytes
    from repro_torch.models.transformer import flash_layers
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.training.train_loop import make_train_step, state_specs
    batch = _arch_batch(cfg, TP_B, None)
    state = _tp_state(cfg, opt, mesh)
    step = make_train_step(cfg, opt, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pspecs = {k[len("model/"):]: v for k, v in
              state_specs(cfg, opt, mesh).items() if k.startswith("model/")}
    count = tensor_parallel_bytes(cfg, pspecs, mesh, TP_B, TRAIN_S,
                                  optimizer=opt.kind)
    A, n_cross = flash_layers(cfg), state.model.n_layers["xattn"]
    losses, secs, colls = [], [], []
    cross_ctx, cross = _cross_launches()
    ops.reset_launches()
    with cross_ctx:
        for i in range(TP_STEPS):
            bt = batch(i)
            tp.reset_collectives()
            before = {k: ops.LAUNCHES[k] for k in TP_KERNELS}
            t0 = time.monotonic()
            state, m = step(state, bt)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.monotonic() - t0)
            colls.append(tp.snapshot())
            now = {k: ops.LAUNCHES[k] - before[k] for k in TP_KERNELS}
            if now != {"flash_attention": 2 * A, "flash_attention_bwd": A}:
                raise AssertionError(f"{tag} ({part}) step {i} launched "
                                     f"{now}; expected K3 2 x {A} and K3b "
                                     f"{A}")
    launched = {k: ops.LAUNCHES[k] for k in TP_KERNELS}
    if cross != {"flash_attention_cross": 2 * n_cross * TP_STEPS,
                 "decode_attention_cross": 0,
                 "flash_attention_bwd_cross": n_cross * TP_STEPS}:
        raise AssertionError(f"{tag} ({part}) cross-attention launches "
                             f"{cross}; expected K3 2 x {n_cross} and K3b "
                             f"{n_cross} a step")
    peak = torch.cuda.max_memory_allocated()
    if any(c != count for c in colls):
        raise AssertionError(f"{tag} ({part}) collectives a step {colls}, "
                             f"the roofline counts {count}")
    if not all(math.isfinite(x) for x in losses) or (
            falls and losses[-1] >= losses[0]):
        raise AssertionError(f"{tag} ({part}) bf16 losses {losses}")
    ms = [1e3 * x for x in secs]
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"{tag} ({part}) bf16 {cfg.name}, {cfg.num_layers} layers at full "
          f"width over (1, 2) ({desc}; gloo, both ranks on cuda:0; "
          f"{n_params:,} parameters a rank), {opt.kind} lr {opt.lr}, B{TP_B} "
          f"x S{TRAIN_S}, {_stream(mesh, TP_B, TRAIN_S)}, {TP_STEPS} steps: "
          f"losses " + " ".join(
              f"{x:.4f}" for x in losses) + "; ms a step " + " ".join(
              f"{x:.1f}" for x in ms) + f" (median "
          f"{statistics.median(ms):.1f}); peak {peak / 2 ** 30:.2f} GiB; "
          f"collectives over model a step {_kinds(count)}, as the roofline "
          f"counts; launches a step K3 {2 * A}, K3b {A} ({2 * n_cross} and "
          f"{n_cross} of them cross-attention); this rank "
          f"{time.monotonic() - T_START:.1f} s from its start")
    del state, step
    torch.cuda.empty_cache()
    totals = {}
    _add_launches(totals, launched, {k: v for k, v in cross.items()
                                     if k != "decode_attention_cross"})
    return {"losses": losses, "peak_gib": peak / 2 ** 30, "ms": ms,
            "launches": totals, "count": count}


def _tp_saved(cfg, mesh, tag) -> None:
    """(b)'s saved bytes: one forward of ``cfg``'s loss (this rank's
    blocks of the weights from ``TP_SEED``, the first batch at B ``TP_B``
    x ``TRAIN_S``) under the default rules (the stream split by
    positions) and under ``seq_sp: ()`` (whole), counting what autograd
    saves for the backward (``saved_tensors_hooks``): every activation
    (the parameters it references aside), and the blocks' inputs (remat
    saves each block's input).  The blocks' inputs must halve over model
    2.  Prints one line."""
    import torch
    from repro_torch.models.model import LM
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.partition import local_shard
    from repro_torch.sharding.rules import DEFAULT_RULES
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import state_specs
    lm = LM(cfg, device="cuda", seed=TP_SEED)
    specs = state_specs(cfg, OptConfig(), mesh)
    for n, p in lm.named_parameters():
        p.data = local_shard(p.data, specs[f"model/{n}"], mesh)
    torch.cuda.empty_cache()
    lm.requires_grad_(True)
    weights = {p.data_ptr() for p in lm.parameters()}
    batch = _arch_batch(cfg, TP_B, None)(0)
    got = {}
    for name, rules in (("split", DEFAULT_RULES),
                        ("whole", {**DEFAULT_RULES, "seq_sp": ()})):
        inputs, saved = [], []
        hooks = [b.register_forward_pre_hook(
            lambda mod, args: inputs.append(args[0])) for b in lm.blocks]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with use_mesh(mesh, rules), torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            loss = lm.loss(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for h in hooks:
            h.remove()
        kept = {(t.data_ptr(), tuple(t.shape)) for t in saved}
        if not all((x.data_ptr(), tuple(x.shape)) in kept for x in inputs):
            raise AssertionError(f"{tag} (b) a block's input was not saved "
                                 f"({name} stream)")
        got[name] = (sum(x.numel() * x.element_size() for x in inputs),
                     sum(t.numel() * t.element_size() for t in saved
                         if t.data_ptr() not in weights),
                     {x.shape[1] for x in inputs}, peak)
        del loss, saved, inputs, kept
    del lm
    torch.cuda.empty_cache()
    (blk_s, all_s, rows_s, peak_s), (blk_w, all_w, rows_w, peak_w) = (
        got["split"], got["whole"])
    n = mesh.mesh.shape[1]
    if rows_s != {TRAIN_S // n} or rows_w != {TRAIN_S} or blk_w != n * blk_s:
        raise AssertionError(f"{tag} (b) saved block inputs {got}")
    print(f"{tag} (b) activations saved for the backward by one forward of "
          f"the loss (bf16 {cfg.name}, {cfg.num_layers} layers, B{TP_B} x "
          f"S{TRAIN_S}): the stream split by positions {all_s / 1e6:.1f} MB, "
          f"of it the {cfg.num_layers} blocks' inputs {blk_s / 1e6:.1f} MB "
          f"({TRAIN_S // n} positions each); whole (seq_sp: ()) "
          f"{all_w / 1e6:.1f} MB, the blocks' inputs {blk_w / 1e6:.1f} MB "
          f"({TRAIN_S}): {blk_w / blk_s:.2f}x; peak {peak_s:.2f} GiB a rank "
          f"split, {peak_w:.2f} whole")


def _tp_setup(rank: int, init_file: str, world: int = 2):
    """A ``[tp]`` rank's gloo group of ``world`` through
    ``file://init_file`` and its (1, ``world``) ("data", "model")
    ``DeviceMesh`` on ``cuda:0``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.stdout.reconfigure(line_buffering=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    return init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))


def tp_rank(rank: int, init_file: str) -> int:
    """One rank of ``[tp]`` (``python3 chip_smoke.py --tp-rank RANK
    FILE``): a gloo group of two through ``file://FILE``, a (1, 2)
    ("data", "model") ``DeviceMesh`` on ``cuda:0``, then (c) a float32
    copy of gemma3-4b-edge at full width cut to 2 layers, ``TP_F32_STEPS``
    AdamW steps through ``make_train_step(mesh=)`` held to the single-
    device step from the same weights and batches (each rank runs it and
    holds its own blocks); (b) all 34 layers in bf16, ``TP_STEPS`` AdamW
    steps at B ``TP_B`` x 512 (:func:`_tp_bf16`), the loss falling, and
    one activation's all-reduce timed alone; (d) smollm-360m in float32
    at full width, all 32 layers (15 query heads over 5 KV heads: the
    heads cut across the ranks), held to the single-device step as (c)
    within 1e-5 relative; (e) dbrx-132b in bf16 at full width cut to one
    layer (:func:`_tp_moe`: the MoE's all-to-all), and (e′) one step of
    it at B 1 x 511, one dispatch group; (f) jamba-v0.1-52b in float32 at
    full width cut to its first (Mamba) layer, held to the single-device
    step as (d); (g) jamba's first two layers (Mamba, Mamba + MoE) in
    bf16 as (e); (h) xlstm-350m in float32 at full width, cut to
    ``TP_XLSTM_LAYERS`` layers, at B ``TP_B`` x ``TP_XLSTM_S``, held as
    (d).  The last line is one
    JSON object of this rank's numbers.  Every part at S 512 (or
    ``TP_XLSTM_S``) runs with the residual stream split by positions over
    model 2 (``seq_sp``, the default rules); (e′)'s S 511 keeps it whole.
    After (b), :func:`_tp_saved` counts what one forward of (b)'s loss
    saves for the backward with the stream split and whole."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.training.optimizer import OptConfig
    mesh = _tp_setup(rank, init_file)
    cfg = get_config("gemma3-4b-edge")
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=1)
    gen = torch.Generator(device="cuda").manual_seed(23)
    tag = f"[tp] rank {rank}:"

    # (c) float32, 2 layers at full width, against the single-device step
    _tp_against_one(dataclasses.replace(cfg, dtype="float32", num_layers=2),
                    opt, mesh, tag, "c", 1e-4)
    dist.barrier()

    # (b) bf16, all 34 layers
    gemma = _tp_bf16(cfg, opt, mesh, tag, "b", "4 over 2 heads of 256 a "
                     "rank", falls=True)
    # one activation's all-reduce alone (its buffers as a step's blocks
    # hand them over), timed on the host around 20 calls
    group = mesh.get_group("model")
    act = torch.randn(TP_B, TRAIN_S, cfg.d_model, generator=gen,
                      device="cuda").to(torch.bfloat16)
    for _ in range(3):
        dist.all_reduce(act.clone(), group=group)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(20):
        dist.all_reduce(act.clone(), group=group)
    torch.cuda.synchronize()
    ar_ms = (time.monotonic() - t0) / 20 * 1e3
    ar = gemma["count"]["all-reduce"]
    print(f"{tag} (b) one {act.numel() * 2 / 1e6:.2f} MB bf16 all-reduce "
          f"alone {ar_ms:.2f} ms (host clock): the step's "
          f"{ar['bytes'] / 1e6:.0f} MB of all-reduces at that rate ~"
          f"{ar_ms * ar['bytes'] / (act.numel() * 2):.0f} ms")
    del act
    dist.barrier()
    _tp_saved(cfg, mesh, tag)
    dist.barrier()

    # (d) smollm-360m, float32, all 32 layers: the heads cut across ranks
    smollm = _tp_against_one(
        dataclasses.replace(get_config("smollm-360m"), dtype="float32"),
        opt, mesh, tag, "d", 1e-5)
    dist.barrier()

    # (e) dbrx-132b, bf16, one attn_moe layer: the experts' all-to-all
    out_dir = os.path.dirname(init_file)
    dbrx = _tp_moe("e", rank, mesh, opt, tag, out_dir)
    dist.barrier()

    # (f) jamba-v0.1-52b, float32, its first layer (Mamba): the channel
    # exchange and the both-ways sum
    jamba = get_config("jamba-v0.1-52b")
    _tp_against_one(dataclasses.replace(jamba, dtype="float32",
                                        num_layers=1),
                    opt, mesh, tag, "f", 1e-5, order=True)
    dist.barrier()

    # (g) jamba, bf16, its first two layers: Mamba, then Mamba + MoE
    jamba_moe = _tp_moe("g", rank, mesh, opt, tag, out_dir)
    dist.barrier()

    # (h) xlstm-350m, float32, 4 of its 24 layers: sLSTM and mLSTM heads
    # (the split stream's gloo collectives lengthen the pair; the
    # sLSTM's host-paced token loop over the other 20 layers is what is
    # cut to keep the run inside its limit)
    _tp_against_one(dataclasses.replace(get_config("xlstm-350m"),
                                        dtype="float32",
                                        num_layers=TP_XLSTM_LAYERS),
                    opt, mesh, tag, "h", 1e-5, seq=TP_XLSTM_S)
    gemma.pop("count")
    print(json.dumps({"tp_rank": rank, **gemma,
                      "smollm": smollm["launches"],
                      "dbrx": dbrx, "jamba": jamba_moe}))
    dist.barrier()
    dist.destroy_process_group()
    return 0


#: the late ``[tp]`` pair's models: (i) llama-3.2-vision-90b cut to one
#: pattern repeat (4 attention layers and the cross-attention layer),
#: trained with Adafactor as ``[vision-train]`` is; (j) musicgen-large,
#: all 48 layers, AdamW
TP_LATE = {"i": ("llama-3.2-vision-90b", 5, "adafactor",
                 "32 over 4 heads of 128 a rank, the cross-attention's over "
                 "1024 image rows"),
           "j": ("musicgen-large", 48, "adamw",
                 "16 over 16 heads of 64 a rank, frames in, the 2048-way "
                 "head split")}


def _tp_late_cfg(part):
    import dataclasses
    from repro_torch.configs import get_config
    arch, layers, kind, _ = TP_LATE[part]
    return dataclasses.replace(get_config(arch), num_layers=layers), kind


def tp_late_rank(rank: int, init_file: str) -> int:
    """One rank of ``[tp]``'s late pair (``python3 chip_smoke.py --tp-rank
    RANK FILE late``), started once ``[launch-train]``'s gemma3 child has
    freed its memory: (j) a float32 copy of musicgen-large cut to 2
    layers held to the single-device step as (c) within 1e-5 relative;
    (i) a float32 stack of llama-3.2-vision-90b's cross-attention block
    alone at full width (its 5-layer float32 state does not fit the card
    beside the ranks: ``PERF.md``), Adafactor, held within 1e-5 relative,
    the ranks' single-device steps one after the other; then (i) and (j)
    of ``TP_LATE`` in bf16 (:func:`_tp_bf16`).  The last line is one JSON
    object of this rank's numbers."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs.base import XATTN
    from repro_torch.training.optimizer import OptConfig
    mesh = _tp_setup(rank, init_file)
    tag = f"[tp] rank {rank}:"
    out = {"tp_rank": rank}
    music, _ = _tp_late_cfg("j")
    vision, _ = _tp_late_cfg("i")
    _tp_against_one(dataclasses.replace(music, dtype="float32",
                                        num_layers=2),
                    OptConfig(lr=TRAIN_LR, warmup_steps=1), mesh, tag, "j",
                    1e-5)
    dist.barrier()
    _tp_against_one(dataclasses.replace(vision, dtype="float32",
                                        block_pattern=(XATTN,),
                                        num_layers=1),
                    OptConfig(lr=TRAIN_LR, warmup_steps=1, kind="adafactor"),
                    mesh, tag, "i", 1e-5, alone=True)
    dist.barrier()
    for part in ("i", "j"):
        cfg, kind = _tp_late_cfg(part)
        res = _tp_bf16(cfg, OptConfig(lr=TRAIN_LR, warmup_steps=1,
                                      kind=kind),
                       mesh, tag, part, TP_LATE[part][3])
        res.pop("count")
        out[part] = res
        dist.barrier()
    print(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


#: (k): xlstm-350m at full width cut to its first two layers (sLSTM,
#: mLSTM), float32, over (1, 8): its 4 heads of 256 fall across the
#: ranks (1024 qkv columns, 128 a rank)
TP_APART = ("xlstm-350m", 2, 8)


def tp_apart_rank(rank: int, init_file: str) -> int:
    """One of (k)'s ranks (``python3 chip_smoke.py --tp-rank RANK FILE
    apart``): a gloo group of ``TP_APART``'s 8 through ``file://FILE`` on
    ``cuda:0``, its (1, 8) mesh, then ``TP_F32_STEPS`` AdamW steps of
    ``TP_APART``'s stack at B ``TP_B`` x ``TP_XLSTM_S`` through
    ``make_train_step(mesh=)`` (the split projections gathered whole, the
    stream split by positions), held to the single-device step within
    1e-5 relative by rank 0 alone, on the ranks' whole parameters.  The
    last line is one JSON object of this rank's numbers."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.training.optimizer import OptConfig
    arch, layers, world = TP_APART
    mesh = _tp_setup(rank, init_file, world)
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              num_layers=layers)
    res = _tp_against_one(cfg, OptConfig(lr=TRAIN_LR, warmup_steps=1), mesh,
                          f"[tp] rank {rank}:", "k", 1e-5, seq=TP_XLSTM_S,
                          on_rank0=True)
    print(json.dumps({"tp_rank": rank, **res}))
    dist.barrier()
    dist.destroy_process_group()
    return 0


#: the ``[tp]`` groups by name: their ranks' extra argument and size
TP_GROUPS = {"first": ([], 2), "late": (["late"], 2),
             "apart": (["apart"], TP_APART[2])}


def start_tp(which="first") -> dict:
    """Start a ``[tp]`` group's ranks (``TP_GROUPS``: the first pair, the
    late pair or (k)'s eight); ``run["ranks"]`` are their
    :func:`_start_self` records."""
    import tempfile
    extra, n = TP_GROUPS[which]
    tmp = tempfile.mkdtemp(prefix="tp_")
    store = os.path.join(tmp, "store")
    return {"tmp": tmp, "t0": time.monotonic(),
            "ranks": [_start_self([TP_FLAG, str(r), store] + extra)
                      for r in range(n)]}


def wait_tp_exit(run) -> dict:
    """``run`` once every one of its ranks has exited."""
    for r in run["ranks"]:
        r["proc"].wait()
    return run


def stop_tp(run) -> None:
    for r in run["ranks"]:
        if r["proc"].poll() is None:
            r["proc"].kill()
            r["proc"].wait()
    shutil.rmtree(run["tmp"], ignore_errors=True)


def _wait_tp(run, smi, beside: str, which: str) -> list:
    """Wait for a ``[tp]`` pair, print its lines and return each rank's
    JSON object."""
    out = []
    for r in run["ranks"]:
        code = r["proc"].wait(timeout=900)
        r["thread"].join(timeout=60)
        for line in r["lines"]:
            if not line.startswith('{"tp_rank"'):
                print(line)
        if code != 0:
            raise AssertionError(f"[tp] a rank exited {code}:\n"
                                 + "\n".join(r["lines"][-60:]))
        out.append(next(json.loads(x) for x in r["lines"]
                        if x.startswith('{"tp_rank"')))
    print(f"[tp] {which} its {len(run['ranks'])} ranks collected "
          f"{time.monotonic() - run['t0']:.1f} s after their start "
          f"({run['t0'] - T_START:.1f} s into the run; each "
          f"rank's own time on its bf16 lines), run beside {beside} "
          f"(neither side's times are taken alone)  [{smi}]")
    return out


def collect_tp(run, smi, beside: str) -> dict:
    """Wait for both ranks and print their lines; then in this process
    (a) a 2-layer bf16 copy's step through ``make_train_step`` on a
    one-rank (1, 1) mesh bitwise equal to the step with no mesh, and
    (b) the single-device loss of the bf16 model from the same weights on
    the first batch within 2e-2 relative of the ranks' first loss, and
    (e) dbrx-132b's and (g) jamba's: one device's loss of the same
    weights and batch, routed in the ranks' two dispatch groups (a
    shape-only (1, 2) mesh), within 1e-3 relative of the ranks' step-1
    loss, and the share of (token, choice) pairs whose expert differs
    between the two; (e′) the same for dbrx's one step in one dispatch
    group.  Returns the ranks' K3/K3b launches in the gemma3 bf16 steps,
    in smollm's float32 steps and in dbrx's steps, by model."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import LM
    from repro_torch.training.optimizer import OptConfig, OptState
    from repro_torch.training.train_loop import (TrainState,
                                                 init_train_state,
                                                 make_train_step)
    out = _wait_tp(run, smi, beside, "(b)-(h):")
    for part in (out, [o["dbrx"] for o in out], [o["jamba"] for o in out]):
        if part[0]["losses"] != part[1]["losses"]:
            raise AssertionError(f"[tp] the ranks' losses differ: {part}")
    cfg = get_config("gemma3-4b-edge")
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=1)
    gen = torch.Generator(device="cuda").manual_seed(23)
    # (a) model 1: a one-rank mesh, bitwise the step with no mesh
    c2 = dataclasses.replace(cfg, num_layers=2)
    bt = _arch_batch(c2, TP_B, gen)(0)
    state = init_train_state(c2, opt, device="cuda", seed=TP_SEED)
    params = dict(state.model.named_parameters())
    with torch.no_grad():
        snap = {n: p.detach().clone() for n, p in params.items()}
    opt0 = OptState(state.opt.step.clone(),
                    {k: v.clone() for k, v in state.opt.m.items()},
                    {k: v.clone() for k, v in state.opt.v.items()})
    _, m_plain = make_train_step(c2, opt)(state, bt)
    with torch.no_grad():
        want = {n: p.detach().clone() for n, p in params.items()}
        for n, p in params.items():
            p.copy_(snap[n])
    _, m_mesh = make_train_step(c2, opt, mesh=make_local_mesh("cuda"))(
        TrainState(state.model, opt0), bt)
    bad = [n for n, p in params.items() if not torch.equal(p, want[n])]
    if bad or not torch.equal(m_plain["loss"], m_mesh["loss"]):
        raise AssertionError(f"[tp] (a) the (1, 1) step differs: {bad[:5]}")
    print(f"[tp] (a) bf16 gemma3-4b-edge, 2 layers at full width: one step "
          f"through make_train_step(mesh=(1, 1) NCCL) bitwise equal to the "
          f"step with no mesh (loss {float(m_mesh['loss']):.6f}, all "
          f"{len(params)} parameters)")
    del state, params, snap, want, opt0
    torch.cuda.empty_cache()
    # (b) the single-device loss from the same weights and batch
    lm = LM(cfg, device="cuda", seed=TP_SEED)
    with torch.no_grad():
        one = float(lm.loss(_arch_batch(cfg, TP_B, gen)(0)))
    del lm
    torch.cuda.empty_cache()
    first = out[0]["losses"][0]
    rel = abs(first - one) / abs(one)
    if rel > 2e-2:
        raise AssertionError(f"[tp] (b) step-1 loss {first} against the "
                             f"single device's {one}")
    print(f"[tp] (b) bf16 34 layers: the ranks' step-1 loss {first:.6f} "
          f"against the single-device loss {one:.6f} from the same weights "
          f"and batch: rel {rel:.2e} (<= 2e-2); losses "
          + " -> ".join(f"{x:.4f}" for x in out[0]["losses"]) + "; peak "
          + " / ".join(f"{o['peak_gib']:.2f}" for o in out)
          + f" GiB a rank  [{smi}]")
    for part, key in (("e", "dbrx"), ("g", "jamba")):
        _moe_against_one(part, [o[key] for o in out], run["tmp"], smi)
    _moe_against_one("e", [o["dbrx"] for o in out], run["tmp"], smi,
                     few=True)
    stop_tp(run)
    return {model: {k: sum(o[part][k] if part else o["launches"][k]
                           for o in out) for k in TP_KERNELS}
            for model, part in (("gemma3-4b-edge-tp", None),
                                ("smollm-360m", "smollm"))} | {
        "dbrx-132b-tp": {k: sum(o["dbrx"]["launches"][k] for o in out)
                         for k in TP_KERNELS}}


def _moe_against_one(part, ranks, tmp, smi, few=False) -> None:
    """(e) and (g) in this process: the ``TP_MOE`` stack (bf16) from the
    ranks' weights, its loss on the first batch on one device under a
    shape-only (1, 2) mesh (``_num_groups`` reads the mesh's size, so it
    routes the ranks' two groups with their capacity), against the
    ranks' step-1 loss within 1e-3 relative; the share of (token,
    choice) pairs whose expert differs (bf16 products at another M may
    flip near-ties).  With ``few`` (e′), the ``TP_FEW`` step's batch,
    which routes in one group there too, against the ranks' loss of that
    step; the ranks, each routing the whole group, must route it
    alike."""
    import torch
    from repro_torch.models.model import LM
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.rules import MeshShape
    cfg = _tp_moe_cfg(part)
    arch, layers, layer, _ = TP_MOE[part]
    B, S = TP_FEW[part] if few else (TP_B, TRAIN_S)
    lm = LM(cfg, device="cuda", seed=TP_SEED)
    routes = _record_routes(lm.blocks[layer].moe)
    with torch.no_grad(), use_mesh(MeshShape(("data", "model"), (1, 2))):
        one = float(lm.loss(_arch_batch(cfg, B, None, S)(0)))
    del lm
    torch.cuda.empty_cache()
    whole = routes[0]
    name = f"{part}1" if few else part
    per_rank = [torch.load(os.path.join(tmp, f"{name}_route{r}.pt"))
                for r in range(2)]
    if few:
        if not torch.equal(per_rank[0], per_rank[1]):
            raise AssertionError(f"[tp] ({part}′) the ranks route the one "
                                 "group differently")
        got, first, label = per_rank[0], ranks[0]["few"]["loss"], part + "′"
        groups, ms = "one dispatch group", " / ".join(
            f"{o['few']['ms']:.1f}" for o in ranks)
    else:
        got, first, label = torch.cat(per_rank), ranks[0]["losses"][0], part
        groups, ms = "two dispatch groups", " / ".join(
            " ".join(f"{x:.1f}" for x in o["ms"]) for o in ranks)
    if got.shape != whole.shape:
        raise AssertionError(f"[tp] ({label}) routes {got.shape} against "
                             f"{whole.shape}")
    flipped = float((got != whole).float().mean())
    rel = abs(first - one) / abs(one)
    if rel > 1e-3:
        raise AssertionError(f"[tp] ({label}) step-1 loss {first} against "
                             f"one device's {one}")
    print(f"[tp] ({label}) bf16 {arch}, {layers} layer"
          f"{'s' if layers > 1 else ''}, B{B} x S{S}: the ranks' step-1 loss "
          f"{first:.6f} against one device's {one:.6f} from the same "
          f"weights and batch in the same {groups}: rel "
          f"{rel:.2e} (<= 1e-3); (token, choice) pairs routed to another "
          f"expert {100 * flipped:.3f}% of {whole.numel()}; "
          + ("" if few else "losses " + " -> ".join(
              f"{x:.4f}" for x in ranks[0]["losses"]) + "; peak "
             + " / ".join(f"{o['peak_gib']:.2f}" for o in ranks)
             + " GiB a rank; ") + f"ms a step {ms}  [{smi}]")


def collect_tp_late(run, smi, beside: str) -> dict:
    """Wait for the late pair and print its lines; then in this process,
    for (i) and (j), the single-device loss of the bf16 model from the
    same weights on the first batch within 2e-2 relative of the ranks'
    first loss, as (b).  Returns the ranks' launches by model
    (``llama-3.2-vision-90b-tp``, ``musicgen-large-tp``: the
    self-attention and the cross-attention ones apart)."""
    import torch
    from repro_torch.models.model import LM
    try:
        out = _wait_tp(run, smi, beside, "(i), (j):")
    finally:
        stop_tp(run)
    launches = {}
    for part in ("i", "j"):
        ranks = [o[part] for o in out]
        if ranks[0]["losses"] != ranks[1]["losses"]:
            raise AssertionError(f"[tp] ({part}) the ranks' losses differ: "
                                 f"{ranks}")
        cfg, _ = _tp_late_cfg(part)
        lm = LM(cfg, device="cuda", seed=TP_SEED)
        with torch.no_grad():
            one = float(lm.loss(_arch_batch(cfg, TP_B, None)(0)))
        del lm
        torch.cuda.empty_cache()
        first = ranks[0]["losses"][0]
        rel = abs(first - one) / abs(one)
        if rel > 2e-2:
            raise AssertionError(f"[tp] ({part}) step-1 loss {first} "
                                 f"against the single device's {one}")
        print(f"[tp] ({part}) bf16 {cfg.name}, {cfg.num_layers} layers: the "
              f"ranks' step-1 loss {first:.6f} against the single-device "
              f"loss {one:.6f} from the same weights and batch: rel "
              f"{rel:.2e} (<= 2e-2); losses " + " -> ".join(
                  f"{x:.4f}" for x in ranks[0]["losses"]) + "; peak "
              + " / ".join(f"{o['peak_gib']:.2f}" for o in ranks)
              + " GiB a rank; ms a step " + " / ".join(
                  " ".join(f"{x:.1f}" for x in o["ms"]) for o in ranks)
              + f"  [{smi}]")
        launches[f"{cfg.name}-tp"] = {
            k: sum(o["launches"][k] for o in ranks) for k in ranks[0][
                "launches"]}
    return launches


def collect_tp_apart(run, smi, beside: str) -> None:
    """Wait for (k)'s ranks and print their lines (rank 0's holds the
    ranks' whole parameters to the single-device step); every rank's
    losses equal, each step's collectives the roofline's count (checked
    by each rank); a line of the ranks' step ms and peak GiB."""
    try:
        out = _wait_tp(run, smi, beside, "(k):")
    finally:
        stop_tp(run)
    if any(o["steps"] != out[0]["steps"] for o in out):
        raise AssertionError(f"[tp] (k) the ranks' (loss, grad norm) "
                             f"differ: {[o['steps'] for o in out]}")
    arch, layers, world = TP_APART
    print(f"[tp] (k) f32 {arch}, {layers} layers over (1, {world}), "
          f"B{TP_B} x S{TP_XLSTM_S}: ms a step by rank " + " / ".join(
              " ".join(f"{x:.1f}" for x in o["ms"]) for o in out)
          + "; peak " + " / ".join(f"{o['peak_gib']:.2f}" for o in out)
          + f" GiB a rank; collectives over model a step "
          f"{_kinds(out[0]['count'])}, as the roofline counts  [{smi}]")


def gemma3_and_lm_api_paths(predictor, smi, child, g_totals) -> tuple:
    """The main process's part beside the side process: gemma3-4b-edge
    served and trained, gemma-2b trained, then musicgen-large and the cut
    llama-3.2-vision-90b through the LM API and trained.  The phases
    whose card memory would not fit beside the child's jamba paths wait
    for them.  Returns gemma3's, gemma-2b training's, musicgen's and
    vision's launches."""
    import dataclasses
    from repro_torch.configs import get_config
    gcfg = get_config("gemma3-4b-edge")
    g2 = dataclasses.replace(gcfg, num_layers=2)
    _timed(phase_full_width_reference, g2, tag="gemma3-f32")
    _timed(phase_lanes_f32, g2, smi, g_totals, tag="gemma3-f32")
    g_launches, geng, g_tokens = _timed(phase_slice, gcfg, predictor, smi,
                                        tag="gemma3-slice")
    for k, v in g_launches.items():
        g_totals[k] += v
    _timed(phase_sidecar, geng, predictor, smi, g_tokens, g_totals,
           tag="gemma3-sidecar", extras=False)
    del geng
    _free_card("gemma3-lanes")
    _timed(phase_lanes, gcfg, smi, g_totals, tag="gemma3-lanes")
    wait_side_jamba(child, "[gemma3-train]")
    # the examples' child (6.9 GiB at most) beside the trained stacks
    examples = _start_self(EXAMPLES_FLAG)
    try:
        _free_card("gemma3-train-f32")
        train_whole(smi, g_totals, tag="gemma3")
        _free_card("gemma2b-train-f32")
        t_totals = {k: 0 for k in g_totals}
        train_whole(smi, t_totals, tag="gemma2b")
        _free_card("musicgen")
        m_totals = lm_api_paths("musicgen-large", "musicgen", smi)
        _free_card("vision")
        v_totals = lm_api_paths("llama-3.2-vision-90b", "vision", smi,
                                layers=len(get_config(
                                    "llama-3.2-vision-90b").block_pattern))
        collect_examples(examples, smi)
    finally:
        if examples["proc"].poll() is None:
            examples["proc"].kill()
            examples["proc"].wait()
    return g_totals, t_totals, m_totals, v_totals


def main() -> int:
    from concurrent.futures import ThreadPoolExecutor
    from concurrent.futures import wait as futures_wait
    import torch
    from repro_torch.configs import get_config

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == [SIDE_FLAG]:
        return side_paths()
    if sys.argv[1:] == [EXAMPLES_FLAG]:
        return examples_paths()
    if sys.argv[1:] == [SECOND_FLAG]:
        return second_side_paths()
    if sys.argv[1:] == [GRANITE_FLAG]:
        return granite_side_paths()
    if sys.argv[1:2] == [TP_FLAG]:
        rank_fn = {("late",): tp_late_rank, ("apart",): tp_apart_rank}.get(
            tuple(sys.argv[4:]), tp_rank)
        return rank_fn(int(sys.argv[2]), sys.argv[3])
    sys.stdout.reconfigure(line_buffering=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    smi = phase_device()
    phase_build()
    ds, predictor = _train_predictor()

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = []
    for heads, model in ((SMOLLM_HEADS, "smollm-360m"),
                         (GEMMA_HEADS, "gemma3-4b-edge")):
        k1 = phase_decode_kernel(gen, heads)
        k3 = phase_flash_kernel(gen, heads)
        k1["max_abs_err"] = max(k1["max_abs_err"],
                                phase_decode_lanes_kernel(gen, heads))
        k3["max_abs_err"] = max(k3["max_abs_err"],
                                phase_flash_extend(gen, heads))
        kernels += [_owned(k, model)
                    for k in (k1, phase_paged_kernel(gen, heads), k3)]
    # granite-8b's K1/K3 are jamba's instances (32 over 8 at hd 128)
    kernels += [_owned(k, ("jamba-v0.1-52b", "granite-8b"))
                for k in jamba_kernels(gen)]
    kernels += [_owned(k, "smollm-360m") for k in (
        phase_gbdt_kernel(predictor.model, ds.prompts),
        phase_packed_kernel(predictor.model, ds.prompts),
        phase_flash_bwd_kernel(gen))]
    kernels += phase_flash_bwd_instances(gen)
    kernels += phase_tp_flash_shares(gen)
    by_name = {k["name"]: k for k in kernels}
    e4, e5 = phase_cli_predictor_kernels()
    by_name["gbdt_margins"]["max_abs_err"] = max(
        by_name["gbdt_margins"]["max_abs_err"], e4)
    by_name["gbdt_margins_packed"]["max_abs_err"] = max(
        by_name["gbdt_margins_packed"]["max_abs_err"], e5)
    print(f"[time] kernel phases: {time.monotonic() - t_start:.1f} s")
    # [tp]'s two ranks (gemma3-4b-edge, smollm-360m, dbrx-132b,
    # jamba-v0.1-52b and xlstm-350m over model 2, ~28 GiB each at most)
    # beside the smollm serving phases, which hold little of the card
    tp_run = start_tp()
    try:
        cfg = get_config("smollm-360m")
        _timed(phase_full_width_reference, cfg)
        # launches on the main paths: each path resets the counters just
        # before it runs and adds what it launched just after
        launches, eng, slice_tokens = _timed(phase_slice, cfg, predictor,
                                             smi)
        totals = dict(launches)
        _timed(phase_sweep, smi)
        _timed(phase_ranking, predictor, smi, totals)
        _timed(phase_sidecar, eng, predictor, smi, slice_tokens, totals)
        del eng
        torch.cuda.empty_cache()
        _timed(phase_lanes, cfg, smi, totals)
        _timed(phase_lanes_f32, cfg, smi, totals)
        _timed(phase_paged_burst, cfg, predictor, smi, totals)
        _timed(phase_preempt, cfg, predictor, smi, totals)
        _timed(phase_lanes_faults, cfg, smi, totals)
        tp_totals = _timed(collect_tp, tp_run, smi,
                           "the smollm phases from [reference] to "
                           "[lanes-faults]")
        for k, v in tp_totals.pop("smollm-360m").items():
            totals[k] += v
    finally:
        stop_tp(tp_run)
    # [launch-train]'s and [launch-sidecar]'s host-bound children run
    # beside [speculative] (the sidecar's client on a thread; its launches
    # are the children's, added after)
    _free_card("launch-train")
    launch_train = start_launch_train()
    side_totals = {k: 0 for k in totals}
    # [tp]'s late pair (llama-3.2-vision-90b and musicgen-large over model
    # 2, ~25 GiB a rank at most) once the gemma3 child (~47 GiB) is done,
    # beside the rest of [speculative]
    late_ex = ThreadPoolExecutor(1)
    late = late_ex.submit(lambda: (futures_wait([launch_train["gemma3"]]),
                                   start_tp("late"))[1])

    def start_apart():
        """[tp]'s (k), xlstm-350m over eight ranks, and granite-8b's paths
        in a child, once the late pair has exited: beside the rest of
        [speculative] and the phases up to [mesh]."""
        wait_tp_exit(late.result())
        return start_tp("apart"), _start_self(GRANITE_FLAG)
    apart = late_ex.submit(start_apart)
    try:
        try:
            with ThreadPoolExecutor(1) as ex:
                side = ex.submit(_timed, phase_launch_sidecar, smi,
                                 side_totals, beside="[speculative]")
                _timed(phase_speculative, cfg, smi, totals,
                       beside="[launch-train]'s children and "
                       "[launch-sidecar]")
                side.result()
            for k, v in side_totals.items():
                totals[k] += v
            ckpt_dir = _timed(phase_launch_train, launch_train, smi,
                              "[speculative]")
            tp_totals.update(_timed(
                collect_tp_late, late.result(), smi,
                "[speculative], [launch-sidecar] and [launch-train]'s "
                "smollm children, started when its gemma3 child ended"))
        finally:
            if late.done() and late.exception() is None:
                stop_tp(late.result())
            late_ex.shutdown()
        state = _timed(phase_train, cfg, smi, totals)
        _timed(phase_mesh, cfg, state, ckpt_dir, smi, totals)
        del state
        shutil.rmtree(launch_train["tmp"])
        _timed(collect_tp_apart, apart.result()[0], smi,
               "the end of [speculative], [train], [mesh] and granite-8b's "
               "paths, started when the late pair ended")
        # before the kernel phases time anything on the card
        r_totals = _timed(collect_child, apart.result()[1], smi, "granite",
                          "granite-8b paths", "(k), the end of "
                          "[speculative], [train] and [mesh], started when "
                          "the late pair ended")["granite-8b"]
    finally:
        if apart.done() and apart.exception() is None:
            tp_apart, granite = apart.result()
            stop_tp(tp_apart)
            if granite["proc"].poll() is None:
                granite["proc"].kill()
                granite["proc"].wait()
    # the later archs' kernels: K1/K3 at musicgen's and vision's heads,
    # the cross-attention kernels and the instances of the models served
    # whole or cut by depth, timed before the side processes start
    _free_card("new-arch kernels")
    kernels += _timed(new_arch_kernels, gen)
    kernels += _timed(serve_arch_kernels, gen)

    # the paper's own backend, gemma3-4b-edge (head width 256, GeGLU):
    # a float32 2-layer copy against the CPU's plain path, then all 34
    # layers in bf16 through the serial engine, the sidecar and the lanes,
    # then trained; beside them jamba-v0.1-52b and xlstm-350m in a child,
    # and gemma-2b and [launch-serve] in a second
    _free_card("gemma3")
    child = start_side_paths()
    second = _start_self(SECOND_FLAG)
    try:
        g_totals, t_totals, m_totals, v_totals = gemma3_and_lm_api_paths(
            predictor, smi, child, {k: 0 for k in totals})
        j_totals, x_totals = collect_side_paths(child, smi)
        second_totals = collect_child(
            second, smi, "second side", "gemma-2b paths and [launch-serve]",
            "the side process and the gemma3-4b-edge, gemma-2b training, "
            "musicgen and vision phases")
        b_totals, ls_totals = (second_totals["gemma-2b"],
                               second_totals["launch-serve"])
        _add_launches(b_totals, t_totals)           # gemma-2b trained
        for k, v in ls_totals.items():
            totals[k] += v
    finally:
        for run in (child, second):
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
    # qwen3-32b whole, then llama4-maverick's repeat, each with the card
    # to itself
    _free_card("qwen3")
    q_totals = _timed(qwen3_paths, predictor, smi)
    _free_card("llama4")
    l_totals = _timed(cut_moe_paths, predictor, smi, tag="llama4")
    _free_card("dbrx")
    d_totals = _timed(cut_moe_paths, predictor, smi, tag="dbrx")

    # each entry reports the launches of its own model's paths
    by_model = {"smollm-360m": totals, "gemma3-4b-edge": g_totals,
                **tp_totals,
                "jamba-v0.1-52b": j_totals, "xlstm-350m": x_totals,
                "musicgen-large": m_totals, "llama-3.2-vision-90b": v_totals,
                "gemma-2b": b_totals, "qwen3-32b": q_totals,
                "llama4-maverick-400b-a17b": l_totals,
                "granite-8b": r_totals, "dbrx-132b": d_totals}
    names = [k["name"] for k in kernels]
    shared = sorted({n for n in names if names.count(n) > 1})
    if shared:
        raise AssertionError(f"kernels line: entries share a name: {shared}")
    for k in kernels:
        model, counter = k.pop("model"), k.pop("counter")
        # an instance two models launch (vision's hd 128 G 8: qwen3-32b's
        # too) counts both models' paths, and each must launch it
        for m in (model if isinstance(model, tuple) else (model,)):
            if by_model[m][counter] <= 0:
                raise AssertionError(f"kernel {k['name']} never launched on "
                                     f"{m}'s paths")
            k["launches"] = k.get("launches", 0) + by_model[m][counter]
    print("[kernels] launches on the main paths: " + "; ".join(
        f"{m} {t}" for m, t in by_model.items()))
    print(f"[done] {time.monotonic() - t_start:.1f} s  [{smi}]")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
