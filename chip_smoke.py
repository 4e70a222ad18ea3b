#!/usr/bin/env python3
"""Smoke run of the port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's three paths at the data scale users run, with random
inputs made from a seed:

* the compiler's main path — ``FusionCompiler.compile`` (trace, fusion
  search, plan) and execution through one generated CUDA kernel (K1) per
  fused group — for the paper's 11 BLAS sequences and the LM programs
  ``LM_RMSNORM``, ``LM_BLOCK``, ``LM_DECODE_ATTN`` and ``FUSED_ADAMW``, in
  modes ``best`` and ``unfused``: BLAS-2, ``LM_RMSNORM`` and
  ``LM_BLOCK`` at n = 4096 (A is 64 MiB in float32, above the 50 MB
  L2), BLAS-1 sequences and ``FUSED_ADAMW`` at n = 2**24 (64 MiB a
  vector), ``LM_DECODE_ATTN`` at n = 131072 (a 128k-token context, one
  head of d = 48: K + V are 48 MiB);
* the hand kernels through ``repro_torch.kernels.ops``: K2 (BiCGK) and
  K3 (GEMVER) at n = 4096; K4 (RMSNorm) on one 4096-wide row as
  ``LM_RMSNORM`` and on a (8192, 4096) prefill (the ``d_model`` of
  Llama-3-8B) in float32 and bfloat16; K5 (decode attention) on one
  Llama-3-8B layer's decode step, (B, Hq, Hkv, S, d) = (8, 32, 8, 8192,
  128), in bfloat16 and float32; K6 (AdamW) over one Llama-3-8B decoder
  layer's N = 218,103,808 parameters, p in float32 and p, g in bfloat16;
  K7 (softmax cross-entropy) on (T, V) = (8192, 128256), 8192 tokens over
  Llama-3-8B's vocabulary, in float32 and bfloat16;
* LM serving, ``serve --arch``'s loop (``launch.serve.generate``):
  Llama-3-8B at its full width and depth in bfloat16, random weights
  from ``--seed``, 8 prompts of 1024 tokens and 32 greedy tokens, K4
  running every RMSNorm and K5 every decode attention; qwen2_7b at
  full width, its depth cut to 2; and the MoE family the same way:
  DeepSeek-V2-Lite (MLA, 64 experts top-6 and 2 shared, a dense first
  layer) at its full width and depth, and Grok-1 (GQA, 8 experts top-2)
  at full width, its depth cut 64 -> 2; then the last four families at
  their full width and depth: LLaVA-NeXT-34B (vlm, 576 patch
  embeddings), Mamba-2-2.7B (ssm), Hymba-1.5B (hybrid, a ring of 1024
  slots) and Whisper-medium (encdec, 1500 frames, prompt 192); each
  ``generate`` runs its first decode step eagerly and replays it as one
  captured CUDA graph at every later position (the position a device
  tensor; K5 reads ``kv_len`` from device memory);
* training, ``launch.train``'s path (``train.steps.make_train_step`` on
  the synthetic pipeline): Llama-3-8B at its full width, its depth cut
  32 -> 4, 8 sequences of 1024 tokens, 8 steps, K4 and K7 on the
  forward (with plain float32 backwards) and K6 on every AdamW leaf;
  then int8 moments at depth 2 for 4 steps, checkpointed after step 2
  (``ckpt.AsyncCheckpointer``) and restored into a fresh state, which
  trains steps 2-3 again;
* replica-sharded serving: the engine's stream through
  ``ShardedServingEngine`` over ``launch.mesh.make_data_mesh()`` and
  over two replicas on the one card.

Phases, each printed as JSON lines:

1. device: the card's name and power limit (``nvidia-smi``), and the
   build of every plan's kernels and of the hand kernels (one ``nvcc``
   per source, in parallel);
2. lm: ``launch.serve.generate`` for Llama-3-8B (32 layers, bfloat16;
   weights from a seeded ``torch.Generator`` on the card, cast once) on
   8 prompts of 1024 tokens from ``--seed``, 32 greedy tokens, counts
   set to 0 just before and read just after (K4 65 · 32, K5's split and
   combine 32 · 31 each): prefill ms, each decode
   step's ms (CUDA events; median and range), tokens a second, the
   step's bound (every weight read once and K/V up to the step's
   ``kv_len``, over 3.35 TB/s; ``lm_step_bound``), peak memory of the
   load and of serving.  One more step counted with every plain version
   forbidden (K4 2·32 + 1 = 65 launches, K5's split and combine 32
   each), timed as one CUDA graph (the device's share of an eager step)
   and run under ``torch.profiler`` (device-busy share, kernel time by
   name).  Decode against forward (``decode_vs_forward``: prefill(1023)
   and one step against the forward over 1024 tokens) within 5e-2, the
   reference's bound, and within 1e-4 in float32 at full depth.  K5 at
   the decode's (8, 32, 8, 1056, 128) with ``kv_len`` 1025 and 1056
   (bfloat16, 1e-3) and 777 (float32, 1e-4), K4 on (8, 4096) and (8192,
   4096) bfloat16 (1e-3), each with a bitwise repeat; K4 and K5 at the
   decode's and prefill's shapes timed beside their bounds, their plain
   versions, ``F.rms_norm`` and SDPA.  ``generate`` captures one graph
   (``captures``) and replays it for steps 2-31 (``step_ms``, their
   median beside ``first_step_ms``, the eager step); its first 4 steps
   are run again on the eager path (``eager_steps``: the same prefill
   and horizon, no capture) and the tokens must be equal
   (``replay_vs_eager_tokens_equal``; ``eager_step_ms``).  K5 with
   ``kv_len`` in device memory at every shape ``lm_k5_shapes`` lists,
   at the steps' mean ``kv_len`` and at half a chunk (every chunk but
   the first empty), against its plain version (1e-3, the split's
   partials too) with a bitwise repeat, and timed at Llama's shape.  Then qwen2_7b (28 heads over 4,
   QKV bias) at full width and depth 2: the same run, launch counts and
   checks, K5 at (8, 28, 4, 1056, 128), K4 on (8, 3584) and (8192,
   3584) (448 of 512 eight-element packs a row: the tail-masked path).
   Then DeepSeek-V2-Lite at full width and depth and Grok-1 at depth 2
   (``lm_run``): the same run and counts (K4 2 L + 1 a pass, 55 and 5
   a step; K5's split and combine L each a step for Grok, none for
   DeepSeek, whose absorbed MLA decode is plain PyTorch), the step
   repeated bitwise, and replayed as one CUDA graph (the MoE layer moves
   nothing to the host); the share of assignments the prefill drops at
   capacity; the distinct experts one step's router chooses, whose
   weights the step's bound reads (beside the bytes of the reference's
   formulation, which multiplies every expert); decode against forward
   with the capacity factor replaced by E / k (no drops), as the
   reference computes it (the prefill's MLA ``kr`` before rope), with
   ``kr`` roped, and with the decode routed to the forward's experts
   (``routing_flips`` lists the near ties that flipped), the last held
   to 5e-2, and in float32 to 1e-4 for DeepSeek at depth 3 (the dense
   layer and 2 MoE layers).  K4 on (8, 2048), (8192, 2048), (8, 6144)
   and (8192, 6144), K5 at Grok's (8, 48, 8, 1056, 128) with ``kv_len``
   1040 (G = 6), each with a bitwise repeat, and timed.  Then the last
   four families (``lm_run``), each at full width and depth: the same
   run (``draw_inputs``: the prompts, then LLaVA's (8, 576, 7168) patch
   embeddings or Whisper's (8, 1500, 1024) frames), launch counts a step
   (``lm_step_launches``: K4 121 for LLaVA, 129 for Mamba-2 (ln1 and
   the gated norm at d_inner 5120), 161 for Hymba (ln1, the gated norm
   at 3200, the two mixing norms, ln2), none for Whisper (LayerNorm);
   K5's split and combine 60, 0, 32 (the ring, ``kv_len`` min(pos + 1,
   1024)) and 48 (self and cross) each), the step repeated bitwise (the
   SSD state restored first), one graph, the trace; the step's bound
   counts the float32 state read and written, the ring's rows and
   Whisper's cross K/V.  Decode against forward: one step for LLaVA and
   Whisper, every one of the 32 steps for Mamba-2 and Hymba (the
   forward over the 1056 tokens ``generate`` produced, whose SSD chunk
   is 32 and whose window wraps the ring); every layer of every run but
   the MoE ones teacher-forced (``layer_gaps``: the layer's decode on
   the forward's own input and history against the forward's output of
   the layer) and held to 5e-2; the end-to-end gap held to 5e-2 but for
   LLaVA, Mamba-2 and Hymba (``DRIFTING``: printed; their bfloat16
   forward lies as far from float32, ``tools/bf16_drift.py``); float32
   at depth 2 within 1e-4 end to end and by layer.  K4 at (8, D) and
   (8192, D) for D 7168, 2560 and 5120, 1600 and 3200; K5 at (8, 56, 8,
   1056, 128), the ring (8, 25, 5, 1024, 64), Whisper's self (8, 16,
   16, 224, 64) and cross (8, 16, 16, 1500, 64): each against its plain
   version with a bitwise repeat, and timed;
   train: ``train_run`` builds the state (``launch.train.build_state``:
   float32 masters, the bfloat16 copy, float32 moments), holds K7's
   per-row losses on the first step's logits against its plain version
   (1e-3, bitwise repeat, ``F.cross_entropy`` 2e-2 on the unmasked
   rows) and times it, then runs the 8 steps with the counts set to 0
   just before and read just after (K4, K6, K7 must launch; the launches
   of one step), each step's ms, tokens a second, the peak, the bf16
   matmul flops counted from the code (``train_matmul_flops``) over the
   dense peak, the losses (the last below the first), one more step
   traced (``trace``: busy share, device time by kernel); K6 on the first
   step's first MLP leaf against its plain version (1e-5) and timed on
   the largest leaf beside its bound, its plain version and fused
   ``torch.optim.AdamW``; the int8-moment run; the K4 and K7 backward
   against autograd through the plain versions at (8192, 4096) and
   (8192, 128256) bfloat16 (1e-3, ``train_backward``); each ``lm`` and
   ``train`` line prints ``launch.costmodel``'s bound on one card beside
   the smoke's own bound and the measured step (not held);
   ckpt: on the int8 run (``ckpt_check``), the state saved after step 2
   under a temporary directory (removed after): bytes on disk (~12.0
   GB), the stall on the caller's thread, the writer's seconds and GB/s,
   restore's seconds, the free bytes there; a state built from another
   seed restored at step 2 trains steps 2-3 again, the counts set to 0
   just before (K4, K6, K7 must launch): masters, the bf16 copy,
   moments, ``step`` and both losses bitwise the run's; one byte of a
   small leaf's file flipped, ``restore`` must raise ``IOError``;
   spmd (``spmd_phase``, run first after the build, while this process
   holds nothing on the card): the int8 run's configuration trained 3 steps
   on ``torch.cuda.device_count()`` NCCL ranks spawned over a
   ``FileStore`` (``dist.spmd.run_ranks``; one card: world 1, said so):
   rank 0 first runs the steps unsharded (``launch.train``'s path) and
   keeps the state on the host, then every rank runs them sharded
   (``make_host_mesh(1)``, FSDP2, the counts set to 0 just before and
   read just after; K4, K6, K7 must launch), the state saved after step
   2 by ``AsyncCheckpointer(shardings=)``; losses, ``grad_norm``,
   masters, the bf16 copy, moments and ``step`` must be bitwise the
   unsharded run's at world 1 (on more ranks, bfloat16 gradients summed
   in another order: losses and gradient norms 1e-3 relative, masters
   and the bf16 copy 2e-2 norm-relative, the moments printed); the
   group ends and rank 0 restores the checkpoint into a single-device
   state with no process group, whose step 3 must be bitwise the run's;
   step ms sharded beside unsharded, the peak per rank, the bytes
   FSDP2's gathers and reduce-scatters carry a step, the launches; on 2
   or more GPUs DeepSeek-V2-Lite at full width, depth 2, its experts
   over ``model`` (``moe_impl="shard_map"``, (1, N)); then tensor
   parallelism (``spmd_tp_rank``, the ``"spmd_tp"`` lines): the same
   configuration's steps with the forward split over ``model`` (heads,
   MLP columns, the vocabulary through K7's block entry, the residual
   stream cut along the sequence), on NCCL ranks over (1, 2) and, on
   four cards, (2, 2) and (1, 4); on one card over (1, 2) on two gloo
   ranks that share it (gloo carries CUDA tensors; its step time is not
   NCCL's), the counts set to 0 just before the steps and read just
   after (K4, K6 and K7's block entry must launch), losses and gradient
   norms 1e-3 relative to the unsharded run, masters and the bf16 copy
   5e-2 norm-relative (``SPMD_TP_RTOL``: the ranks add bf16 partial
   sums), step ms and the peak per rank printed; then K4,
   K6 and K7 at the sharded path's shapes against their plain versions
   and timed, and K7's block entry at (8192, 128256) bfloat16 cut into
   2, 4 and 16 blocks (column slices) against its plain version (1e-5
   norm-relative each part of the triple), the blocks' triples combined
   against the whole rows' K7 (1e-5), and timed on one rank's block of
   the (1, 2) run (``"time"`` lines with ``"path": "spmd"``);
   serve_tp (``serve_tp_phase``, right after spmd, while this process
   still holds nothing on the card): ``serve --arch --model-parallel``'s
   path (``launch.serve.generate`` under ``train.steps.serving_spmd``,
   each rank holding its blocks of the weights, ``load_model``'s ``tp``,
   and of the decode cache) for Llama-3-8B at full width and depth (B
   8, P 32, 32 greedy tokens), LLaVA-NeXT-34B at full width (P 608:
   its 576 patches and 32 tokens; one card: 8 of its 60 layers),
   Granite-34B at full width and depth 8 (its one KV head on both
   ranks), Llama at depth 4 in float32, DeepSeek-V2-Lite (MLA, 64
   experts, 32 a rank) at full width and depth 8 (on 2 or more cards
   its full 27), Grok-1 (GQA, 8 experts) at full width and depth 2 (on
   4 or more cards depth 4 on (1, 4)), DeepSeek at depth 2 in float32
   and DeepSeek's smoke shapes with 3 experts in float32 (each expert's
   hidden columns split, the F-split), Mamba-2-2.7B (80 SSD heads, 40
   a rank, tied embeddings) and Whisper-medium (its encoder over 1500
   frames and its cross-attention split by heads) at full width and
   depth (on four cards also on (1, 4)) and each at depth 4 in float32
   (``SERVE_TP_RUNS``), on
   ranks spawned over a ``FileStore``: one card, (1, 2) on two gloo
   ranks that share it, every step eager (gloo cannot be captured; the
   line says so); on 2 or more cards NCCL ranks, one a card, the step
   with its collectives replayed as one CUDA graph (four cards: LLaVA
   at full depth on (1, 4), the float32 run on (2, 2)).  Rank 0 first
   serves the run unsharded on its card; the counts are set to 0 just
   before the split run's ``generate`` and read just after (K4 (2L + 1)
   a pass, Mamba-2's L + 1 and K4's block entry 2L, its gated norm's
   sums and scale; K5's split and combine L a step, Whisper's 2L, none
   for MLA or the SSD mixer; ``serve_tp_launches``); the prefill's
   and every step's logits, teacher-forced on the one-card tokens with
   every plain version forbidden (a MoE run's tokens also routed to
   the one-card run's experts, ``serve_tp_routes``: the flips of near
   ties are printed), within 5e-2 norm-relative of the one-card
   run's in bfloat16 (``SERVE_TP_RTOL``; LLaVA and Mamba-2 at their
   full depth printed, as in phase lm), 1e-4 in float32, printed beside
   the one-card run's own floor (its logits computed on two halves of its
   rows); the first step whose greedy tokens differ from the one-card
   tokens, printed (a bfloat16 near-tie may flip); each
   rank's weight bytes equal to its blocks' (``dist.sharding.
   rank_param_bytes``), its peak and step ms, ``costmodel.tp_decode``'s
   bound; then K5 at a rank's shapes with ``kv_len`` in device memory
   (Whisper's cross-attention over its 1500 frames too), K4 at its
   decode and prefill rows and K4's block entry at Mamba-2's rank rows
   ((8, 2560) and (256, 2560) of 2 ranks: each block against its plain
   version, the blocks combined against whole-row K4 at (8, 5120) and
   (256, 5120)) against their plain versions (1e-3, bitwise repeats),
   and timed (``"time"`` lines with ``"path": "serve_tp"``);
3. kernel: every K1 group's kernel against K1's plain tiled version on
   the same inputs on the card, and a second launch of it bitwise equal
   to the first (the groups whose reduce axes K1 cuts into slices
   combine their partials in a fixed order, with no atomics); each
   record gives the group's work units and slices per phase;
4. main: every program's outputs against its numpy reference in
   float64, and the launch counts of that run, which must show every
   group of every plan launched once;
5. hand: K2-K7 against their plain versions (``kernels.ref``) on the
   card, at the main shapes and at odd ones: K2/K3 at a non-square
   (4096, 6144) and an odd (1000, 1531); RMSNorm rows of (1, 4096),
   (7, 33), (2, 8) and (3, 20000) (longer than K4's register path),
   each with the path K4 takes, its rows a CTA and a bitwise repeat; K5
   at (2, 16, 1, 256, 128) (one KV head), (3, 12, 4, 1000, 80) (odd S
   and d), granite_34b's (1, 48, 1, 1000, 128) and hymba_1p5b's (2, 25,
   5, 777, 64) head layouts and (1, 1, 1, 131072, 48)
   (``LM_DECODE_ATTN``'s shape), its split and combine kernels each
   against their own plain versions too, each with its chunk count and
   length, the split's ring stages, shared memory, CTAs an SM and head
   groups, and a bitwise repeat; K6 at steps 3 and 7 and at N =
   1,000,003; K7 at (7, 1000) and (33, 50257), per-row losses and their
   mean;
6. hand_main: the ``ops`` path, counts set to 0 just before it and read
   just after: every hand kernel launched, outputs against float64;
7. serve: ``serve_blas`` for GEMVER at n = 4096, 100 requests, in
   ``best`` and ``unfused`` (CUDA events): µs per request replaying the
   plan's CUDA graph and on the eager path (a Python call a group) side
   by side, and the device time of each;
8. engine: the ``ServingEngine`` on one mixed stream of 64 requests
   from ``--seed`` at full width: GEMVER and BiCGK with n from 1000 to
   4096 (buckets 1024, 2048, 4096), AXPYDOT with n from 2**20 to 2**24,
   LM_DECODE_ATTN at ragged KV lengths from 100,000 to 131,072 (masked,
   d = 48); max_batch 8, max_pack 8; inputs on the card.  The stream is
   drawn by ``launch.serve.engine_stream``, the ``--engine`` CLI's
   generator, and drained twice to warm it, then once measured with the
   counts set to 0 just before and read just after (every engine kernel
   launched, no graph captured); its results are held across the next
   drain and must keep their bits; the stream again open loop at 2000
   requests a second, every result kept: no graph held, none captured
   twice for one input set, every result with the closed loop's bits;
   every request against float64 numpy (norm-relative, and AXPYDOT's
   dot product, whose terms cancel, relative to the sum of its terms'
   magnitudes); every result bitwise equal to
   eager single-request launches of its bucket's plan (so every batched
   and packed replay is); the packed drain bitwise equal to the same
   stream unpacked (max_pack 1); a graph replay bitwise equal to the
   eager run of the same staged batch; each engine kernel on one staged
   batch against its plain batched version (the group's dense function,
   request by request), and timed; then sharded (``sharded_phase``):
   the same stream through ``ShardedServingEngine`` over
   ``make_data_mesh()`` (one replica on one card: the base engine's
   programs under its keys) and over ``make_mesh((2,), ("data",),
   [cuda:0, cuda:0])`` (each dispatch two row blocks, each its
   replica's batched K1 launches), each warmed, then one drain counted:
   every request bitwise the base engine's, every engine kernel
   launched, ``replica_rows`` front-loaded as ``replica_fill`` gives, µs
   a request beside the base engine's;
9. fp16: AXPYDOT (2**24) and GEMVER (4096, A and the u, v vectors scaled
   by n**-0.5 to stay inside float16's range) in float16 through K1,
   ``best`` and ``unfused``: launches counted (each group once), outputs
   against float64, each group against its plain version (K1's tiled
   version, in float32 and rounded where the kernel stores), times
   beside the bound;
10. series: the paper's comparison for GEMVER, BiCGK, LM_RMSNORM (n =
   4096), AXPYDOT, FUSED_ADAMW (n = 2**24) and LM_DECODE_ATTN (n =
   131072) — compiler ``best`` and ``unfused``, the hand kernels (none
   for AXPYDOT), the ``torch`` backend, for FUSED_ADAMW the port's
   ``optim.fused_adamw_update``, and the library calls the paper
   measures against (cuBLAS matvecs and rank-1 updates; ``addcmul`` and
   ``dot``; ``F.rms_norm``; ``F.scaled_dot_product_attention``;
   ``torch.optim.AdamW(fused=True)``), timed only, never used by the
   port — outputs cross-checked first, then µs per request back to back
   (``*_us``) and as device time (``*_device_us``), beside the hand
   kernels' bounds; the compiler's programs run as their callers run
   them, one CUDA graph replay a request (``best`` also eager);
11. time: each kernel's time beside its bound (compulsory bytes over
   3.35 TB/s, or float32 operations over 67 TFLOP/s), the plain
   version's time, and one PyTorch call computing the same function
   where there is one (checked against the kernel once, timed here
   only, never used by the port).  ``ms`` and ``library_ms`` are device
   times by CUDA graph replay (``core.timing.graph_ms``: about 1 ms of
   back-to-back calls captured in one graph, so no host path lies
   between them, the least of 3 replays; a call that cannot be captured
   is queued behind a spinning kernel instead, ``"timed_by": "spin"``).
   For K1 ``ms`` excludes the fold of ``partial`` outputs after the
   kernel; for K2-K4 it is the wrapper's
   whole device work (the kernel and the sum of its partials); K5's
   split and combine kernels are timed one by one, and K5 as a whole
   (both, with ``F.scaled_dot_product_attention`` as its library call)
   on a line of its own, and the three again at ``LM_DECODE_ATTN``'s
   shape.  ``wrapper_ms`` is the wrapper's whole path per
   call, launched back to back (checks, output allocation, the ctypes
   call, the combine): where it exceeds ``ms``, the host is the limit;
12. calibrate: ``autotune.calibrate_hardware`` on the card — the
   streaming rate fitted over 256 MiB to 1 GiB arrays, the per-kernel
   cost of tiny kernels replayed in one CUDA graph and the f32 matmul
   rate (8192³, TF32 off), rounded and unrounded, with the per-size
   sweep and the card's ``nvidia-smi`` line;
13. autotune: every program compiled with ``mode="autotune"`` under
   ``hw="calibrate"`` at the main widths, ``--budget`` candidates each
   (every candidate group built first, one ``nvcc`` a distinct source,
   in parallel), each group timed by graph replay on the card: each
   candidate's ``t_pred`` and ``t_meas``, the winner's rank (never
   slower than candidate 0, ``best``), groups measured and the pass's
   build seconds and peak memory; counts set to 0 before the passes
   (the measured groups must launch) and again before one run of the
   winners (one launch a group); the winner's outputs against float64
   and its whole-program time by graph replay beside ``best``'s and
   beside its summed group times (all three by ``core.timing.replay_s``
   at the autotune's discipline: 8 calls a graph, least of 3); each winner group against its plain
   version and timed, as in phase 11; a second pass over the same
   cache must measure nothing (group hit rate 1.00); then ``refit``
   over the measured groups, the constants before and after;
14. verify: the full static verifier (``repro_torch.analysis``) over
   the 30 ``best``/``unfused`` plans and the 15 autotune winners, 0
   errors; and a plan entry corrupted on disk on purpose (two input refs
   swapped) that the compile path rejects, drops, recompiles and
   republishes, with outputs within 1e-4 of float64.

Tolerances: float32 sums over 4096 to 2**24 terms run in another order
in the kernels, the plain versions and numpy, so float32 results are
held to a norm-relative error of 1e-4 (``||got - want|| <= 1e-4 *
||want||``).  The bfloat16 outputs of K4-K6 and their plain versions
both accumulate in float32 and round once to bfloat16, so they differ
only where the rounding of an output flips by one unit: they are held to
1e-3 against their plain versions.  K7's mean loss is held to 1e-5
relative.  Against float64, and against the library's bfloat16 calls,
bfloat16 outputs (8 bits of mantissa) are held to 2e-2.

float16 outputs (11 bits of mantissa) are held to 1e-2 against float64;
K1 and its plain version both compute a float16 group in float32 and
round where the kernel stores, so a float16 kernel is held to 1e-3
against its plain version.  Bitwise checks compare the bits of the
outputs.

The last lines are the ``{"kernels": [...]}`` record (the main path's
K1 groups and hand kernels, then the engine's, the float16 path's and
the autotune winners' K1 groups, then K4 and K5 on the LM serving path,
K6 and K7 on the training path, K4, K6 and K7 on the sharded path and
K4, K4's block entry and K5 on the tensor-parallel serving path,
each with the launches of its own counted run) and
``{"ok": true, "device": {...}}``; the card's ``nvidia-smi`` line is in
the first (``device``) record.  Any failed
phase ends the run with exit code 1 and no result line; so does a
machine without CUDA, or a directory without the repository.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

MODES = ("best", "unfused")
#: programs over 2**24-long vectors
BLAS1 = ("AXPYDOT", "VADD", "WAXPBY", "SSCAL", "FUSED_ADAMW")
LM = ("LM_RMSNORM", "LM_BLOCK", "LM_DECODE_ATTN", "FUSED_ADAMW")
#: the paper's three-way comparison (``benchmarks/fused_kernels.py``)
SERIES = ("GEMVER", "BiCGK", "AXPYDOT", "LM_RMSNORM", "LM_DECODE_ATTN",
          "FUSED_ADAMW")
#: the series programs with a hand kernel behind ``ops``
HANDED = tuple(name for name in SERIES if name != "AXPYDOT")
RTOL = 1e-4
#: bfloat16 kernel against its plain version (one rounding each)
BF16_KERNEL_RTOL = 1e-3
#: K7's mean loss against its plain version and float64
MEAN_RTOL = 1e-5
#: bfloat16 output against float64 or another bfloat16 computation
BF16_RTOL = 2e-2
#: GEMVER's scalars in the hand phase
ALPHA, BETA = 1.3, 0.7
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
REPLACES = "src/repro/core/codegen.py:96"
SOURCE = "src/repro_torch/core/cuda_codegen.py"
#: hand kernels by launch-counter name: (CUDA source, TPU kernel replaced)
HAND = {
    "K2/bicgk": ("src/repro_torch/csrc/bicgk.cu",
                 "src/repro/kernels/bicgk.py:20"),
    "K3/gemver_k1": ("src/repro_torch/csrc/gemver.cu",
                     "src/repro/kernels/gemver.py:26"),
    "K3/gemver_k2": ("src/repro_torch/csrc/gemver.cu",
                     "src/repro/kernels/gemver.py:38"),
    "K4/rmsnorm_f32": ("src/repro_torch/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:18"),
    "K4/rmsnorm_bf16": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:18"),
    # K4's block entry: rows split over tensor-parallel ranks
    **{f"K4/block_{k}_{dt}": ("src/repro_torch/csrc/rmsnorm.cu",
                              "src/repro/kernels/rmsnorm.py:18")
       for k in ("sumsq", "scale") for dt in ("f32", "bf16")},
    **{f"K5/{k}_{dt}": ("src/repro_torch/csrc/decode_attention.cu",
                        "src/repro/kernels/decode_attention.py:20")
       for k in ("split", "combine") for dt in ("f32", "bf16")},
    **{f"K6/adamw_{dt}": ("src/repro_torch/csrc/adamw.cu",
                          "src/repro/kernels/adamw.py:24")
       for dt in ("f32", "bf16")},
    **{f"K7/xent_{kind}{dt}": ("src/repro_torch/csrc/softmax_xent.cu",
                               "src/repro/kernels/softmax_xent.py:17")
       for kind in ("", "block_") for dt in ("f32", "bf16")},
}
#: RMSNorm prefill rows: 8192 tokens at Llama-3-8B's d_model
#: (src/repro/configs/llama3_8b.py:6)
PREFILL = (8192, 4096)
#: decode attention (B, Hq, Hkv, S, d): one Llama-3-8B layer (32 heads, 8
#: KV heads, d 128; src/repro/configs/llama3_8b.py:5-8) decoding 8
#: sequences at an 8k context
DECODE = (8, 32, 8, 8192, 128)
#: decode attention at the head layouts of granite_34b (MQA: 48 query
#: heads on one KV head, d 128; src/repro/configs/granite_34b.py:7) and
#: hymba_1p5b (25 heads on 5, d 64; src/repro/configs/hymba_1p5b.py:12)
GRANITE_34B_DECODE = (1, 48, 1, 1000, 128)
HYMBA_DECODE = (2, 25, 5, 777, 64)
#: LM_DECODE_ATTN's shape as K5 sees it: one head of d = 48 over a 128k
#: context (src/repro/programs/models.py:37)
LM_ATTN = (1, 1, 1, 131072, 48)
#: AdamW over one Llama-3-8B decoder layer's parameters:
#: 4096 (2 4096 + 2 1024) attention + 3 4096 14336 MLP
ADAMW_N = 4096 * (2 * 4096 + 2 * 1024) + 3 * 4096 * 14336
#: the hyperparameters of ``FUSED_ADAMW``'s inputs, the step apart
K6_HYPERS = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.01)
#: cross-entropy (T, V): 8192 tokens over Llama-3-8B's vocabulary
XENT = (8192, 128256)
#: the engine phase: requests, largest batch, most members a pack
ENGINE_REQUESTS, ENGINE_BATCH, ENGINE_PACK = 64, 8, 8
#: rounds of the sharded phase's timed drains, each engine in turn
SHARDED_ROUNDS = 5
#: arrival rate of the engine phase's open-loop run (requests a second)
OPEN_LOOP_HZ = 2000.0
#: float16 through K1: AXPYDOT over 2**24, GEMVER at 4096
FP16 = ("AXPYDOT", "GEMVER")
#: candidates the autotune phase measures for each program (2, not 8:
#: its candidates' builds and passes took ~190 s of the whole script's
#: ~1000 s on one H100; at 2 the run stays well inside its time limit)
AUTOTUNE_BUDGET = 2
#: the lm phase: ``serve --arch``'s loop at Llama-3-8B's full width and
#: depth (32 layers, d_model 4096, 32 heads over 8 KV heads, d_ff 14336,
#: vocab 128256; src/repro/configs/llama3_8b.py:5-8) in bfloat16, for
#: 8 sequences of 1024-token prompts and 32 greedy tokens
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "llama3_8b", 8, 1024, 32
#: ... and a second architecture at full width, depth cut to 2:
#: qwen2_7b's 28 heads over 4 KV heads (G = 7) with QKV bias
#: (src/repro/configs/qwen2_7b.py:5-9)
LM_ARCH2, LM_DEPTH2 = "qwen2_7b", 2
#: the MoE family: DeepSeek-V2-Lite at full width and depth (27 layers,
#: the first dense with d_ff 10944; d_model 2048, 16 heads with MLA:
#: kv_lora_rank 512, rope 64, nope 128, v 128; 64 routed experts top-6
#: and 2 shared, d_ff_moe 1408; src/repro/configs/deepseek_v2_lite.py:6-13)
#: and Grok-1 at full width (d_model 6144, 48 heads over 8 KV heads, 8
#: experts top-2 of d_ff 32768; src/repro/configs/grok1_314b.py:9-14),
#: its depth cut 64 -> 2 to fit one card
MOE_ARCH, MOE_ARCH2, MOE_DEPTH2 = "deepseek_v2_lite", "grok1_314b", 2
#: DeepSeek's float32 decode-against-forward check: the dense head layer
#: and 2 MoE layers
MOE_F32_DEPTH = 3
#: the last four families at full width and depth: LLaVA-NeXT-34B (vlm:
#: 60 layers, d_model 7168, 56 heads over 8, d_ff 20480, vocab 64000, 576
#: patch embeddings over the first positions;
#: src/repro/configs/llava_next_34b.py:6-9), Mamba-2-2.7B (ssm: 64 layers,
#: d_model 2560, d_inner 5120, 80 SSD heads of 64, state 128, tied;
#: src/repro/configs/mamba2_2p7b.py:5-9), Hymba-1.5B (hybrid: 32 layers,
#: d_model 1600, 25 heads over 5 of d 64 with a 1024-token window beside
#: 50 SSD heads of state 16; src/repro/configs/hymba_1p5b.py:10-14) and
#: Whisper-medium (encdec: 24 + 24 layers, d_model 1024, 16 heads of d
#: 64, LayerNorm, GELU, 1500 encoder frames;
#: src/repro/configs/whisper_medium.py:7-11)
VLM_ARCH, SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH = (
    "llava_next_34b", "mamba2_2p7b", "hymba_1p5b", "whisper_medium")
#: the lm phase's runs: (arch, depth or None for the full depth)
LM_RUNS = ((LM_ARCH, None), (LM_ARCH2, LM_DEPTH2), (MOE_ARCH, None),
           (MOE_ARCH2, MOE_DEPTH2), (VLM_ARCH, None), (SSM_ARCH, None),
           (HYBRID_ARCH, None), (ENCDEC_ARCH, None))
#: a run's prompt length where it is not ``LM_PROMPT``: Whisper's decoder
#: takes 448 positions, so 192 + 32 generated
LM_PROMPTS = {ENCDEC_ARCH: 192}
#: ... and its float32 decode-against-forward checks (the new families
#: at depth 2, Whisper's encoder cut to 2 layers too)
LM_F32_RUNS = ((LM_ARCH, None), (MOE_ARCH, MOE_F32_DEPTH), (VLM_ARCH, 2),
               (SSM_ARCH, 2), (HYBRID_ARCH, 2), (ENCDEC_ARCH, 2))
#: the families whose decode keeps a recurrent state: decode against
#: forward runs all 32 steps of ``generate`` (prefill of 1024, the
#: forward over 1056 = 32 · 33, whose SSD chunk is 32, not 1), and a
#: repeated step starts from the state the first one read
STATEFUL = ("ssm", "hybrid")
#: the runs whose bfloat16 decode-against-forward gap at full depth is
#: printed, not held to the reference's bound: these random models
#: amplify bfloat16 rounding with depth in the forward itself, which
#: lies as far from float32 as the decode does (``tools/bf16_drift.py``);
#: every layer of every run is held to the bound instead, teacher-forced
#: (``layer_gaps``)
DRIFTING = (VLM_ARCH, SSM_ARCH, HYBRID_ARCH)
#: decode against forward on the logits, the reference's bound for the
#: same check (tests/test_models.py:64-88)
DECODE_VS_FORWARD = 5e-2
#: decode steps of the eager path held against ``generate``'s replay
EAGER_STEPS = 4
#: the train phase: Llama-3-8B at full width (d_model 4096, 32 heads over
#: 8, d_ff 14336, vocab 128256), its depth cut 32 -> 4 (the float32
#: masters, the bfloat16 copy and the float32 moments of 32 layers need
#: about 160 GB), B 8 sequences of 1024 tokens from the synthetic
#: pipeline at ``--seed``, 8 steps at ``launch.train``'s default rate
TRAIN_ARCH, TRAIN_DEPTH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = (
    "llama3_8b", 4, 8, 1024, 8)
TRAIN_LR = 3e-3
#: ... and the int8 moments (Grok-1's setting, which cannot train on one
#: card): the same model at depth 2 for 4 steps
TRAIN_INT8_DEPTH, TRAIN_INT8_STEPS = 2, 4
#: the ckpt phase on that run: ``AsyncCheckpointer.save`` after step 2,
#: a fresh state restored there trains steps 2-3 again (depth 4 with
#: float32 moments would write 26.9 GB)
CKPT_AT = 2
#: the leaf whose file the ckpt phase corrupts: a small one (4096 int8
#: moments), early in ``restore``'s order
CKPT_VICTIM = "opt/m/final_g/q"
#: K6 on the first step against its plain version, float32
K6_TRAIN_RTOL = 1e-5
#: H100 SXM bfloat16 on the tensor cores, dense
BF16_OPS_PER_S = 989e12
#: float16 output against float64: 11 bits of mantissa
FP16_RTOL = 1e-2
#: float16 kernel against its plain version (one rounding each)
FP16_KERNEL_RTOL = 1e-3
ES = {"float32": 4, "bfloat16": 2}
SHORT = {"float32": "f32", "bfloat16": "bf16"}


def engine_ranges(args) -> dict:
    """The engine phase's size range per sequence: GEMVER and BiCGK with
    n from 1000/4096 of ``--n2`` up to it (buckets 1024, 2048, 4096 at
    the default; A is 64 MiB at 4096), AXPYDOT with n from ``--n1``/16
    to ``--n1`` (2**20 to 2**24), and LM_DECODE_ATTN at ragged KV
    lengths from 100000/131072 of ``--n-attn`` up to it (one bucket,
    served through per-lane masking).  The stream is drawn from them by
    ``launch.serve.engine_stream``, the generator ``--engine`` serves."""
    return {"GEMVER": (args.n2 * 1000 // 4096, args.n2),
            "BiCGK": (args.n2 * 1000 // 4096, args.n2),
            "AXPYDOT": (args.n1 // 16, args.n1),
            "LM_DECODE_ATTN": (args.n_attn * 100000 // 131072, args.n_attn)}


#: outputs that are sums whose terms cancel, by (sequence, output index):
#: the float64 sum of the terms' magnitudes, from a request's float64
#: inputs (AXPYDOT's r = (w - alpha v) . u)
CANCELLING = {("AXPYDOT", 1): lambda w, v, u, alpha:
              float(abs((w - alpha * v) * u).sum())}


def sharded_phase(engine, reqs, results, base_us: float, failures: list,
                  smi_line: str):
    """Phase ``sharded``: the engine phase's stream through
    ``ShardedServingEngine`` on the engine's compiler, first over
    ``make_data_mesh()`` (every GPU: one replica on one card, which must
    be the base engine: the same programs under the same keys), then
    over ``make_mesh((2,), ("data",), [cuda:0, cuda:0])`` (two replicas
    on the one card: each dispatch split into two row blocks, each
    block its replica's batched K1 launches).  Each engine is warmed as
    the base engine is (``warm``, two drains), then one drain run with
    the counts set to 0 just before and read just after: every request
    bitwise the base engine's, every engine kernel launched,
    ``replica_rows`` the front-loaded fill ``replica_fill`` gives.  Then
    ``SHARDED_ROUNDS`` rounds of one closed-loop drain on each engine in
    turn (the base engine first): µs a request, each engine's median
    beside the base engine's (no limit set)."""
    import torch

    from repro_torch.core import LAUNCHES
    from repro_torch.launch.mesh import make_data_mesh, make_mesh
    from repro_torch.serving import ShardedServingEngine, replica_fill

    meshes = {"data_mesh": make_data_mesh(),
              "two_on_cuda0": make_mesh((2,), ("data",),
                                        devices=["cuda:0", "cuda:0"])}
    line = {"phase": "sharded", "nvidia_smi": smi_line,
            "requests": len(reqs), "base_us_per_request": base_us}
    engines = {}
    for tag, mesh in meshes.items():
        eng = ShardedServingEngine(mesh, compiler=engine.compiler,
                                   max_batch=ENGINE_BATCH, min_bucket=64,
                                   registry=engine.registry)
        t0 = time.perf_counter()
        for s_ in sorted({s_ for s_, _, _ in reqs}):
            eng.warm(s_, [n for t, n, _ in reqs if t == s_],
                     trace_packs=False)
        for _ in range(2):
            eng.serve(reqs)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        rows0 = list(eng.replica_rows)
        disp0 = eng.n_dispatches
        LAUNCHES.reset()
        base_rid = eng._rid
        out = eng.serve(reqs)
        launches = dict(LAUNCHES.by_kernel)
        got = {r.rid - base_rid: r for r in out}
        bitwise = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for i, r in enumerate(results)
            for a, b in zip(r.outputs, got[i].outputs))
        rows = [a - b for a, b in zip(eng.replica_rows, rows0)]
        # the fill each dispatch's chunk gives, key by key
        want_rows = [0] * eng.n_replicas
        counts = {}
        for s_, n, _ in reqs:
            key = (s_, eng.bucket_of(n))
            counts[key] = counts.get(key, 0) + 1
        for k in counts.values():
            for i in range(0, k, eng.max_batch):
                c = min(eng.max_batch, k - i)
                for j, f in enumerate(replica_fill(
                        c, eng._dispatch_batch(c), eng.n_replicas)):
                    want_rows[j] += f
        used = {fn.__self__.name for p in eng._programs.values()
                for fn in p.group_fns}
        never = sorted(k for k in used if not launches.get(k))
        same_programs = (sorted(eng._programs) == sorted(engine._programs)
                         and all(eng._programs[k] is engine._programs[k]
                                 for k in engine._programs))
        st = eng.stats()
        rec = {"n_replicas": eng.n_replicas, "max_batch": eng.max_batch,
               "devices": [str(d) for d in mesh.devices], "warm_s": warm_s,
               "n_dispatches": eng.n_dispatches - disp0,
               "replica_rows": rows, "replica_rows_expected": want_rows,
               "bitwise_vs_base": bitwise, "launches": launches,
               "kernels_never_launched": never,
               "graph_captures": st["graph_captures"],
               "graphs_per_input_set": st["graphs_per_input_set"]}
        if eng.n_replicas == 1:
            rec["same_programs_as_base"] = same_programs
        line[tag] = rec
        if not (bitwise and not never and rows == want_rows
                and rows == sorted(rows, reverse=True)
                and (eng.n_replicas > 1 or same_programs)):
            failures.append(f"sharded {tag}: bitwise {bitwise}, never "
                            f"launched {never}, rows {rows} (want "
                            f"{want_rows}), same programs {same_programs}")
        engines[tag] = eng
        del out, got
    us = {tag: [] for tag in ("base", *engines)}
    for _ in range(SHARDED_ROUNDS):
        for tag, eng in (("base", engine), *engines.items()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve(reqs)
            us[tag].append((time.perf_counter() - t0) / len(reqs) * 1e6)
    line["us_per_request"] = us
    line["us_per_request_median"] = {k: sorted(v)[len(v) // 2]
                                     for k, v in us.items()}
    del engines
    torch.cuda.empty_cache()
    emit(line)


def fp16_inputs(name: str, n: int, seed: int = 0) -> dict:
    """float16 inputs: ``make_inputs``, with GEMVER's A, u1, v1, u2 and v2
    scaled by n**-0.5 so that B = A + u1 v1ᵀ + u2 v2ᵀ has a norm of O(1)
    and w = α B x stays inside float16's ±65504 (unscaled, v1·x grows as
    n and w overflows from n = 1024 on)."""
    import numpy as np
    from repro_torch.programs import REGISTRY, make_inputs
    env = make_inputs(REGISTRY[name], n, seed=seed)
    if name == "GEMVER":
        for k in ("A", "u1", "v1", "u2", "v2"):
            env[k] = env[k] / np.float32(np.sqrt(n))
    return {k: np.asarray(v).astype(np.float16) for k, v in env.items()}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def norm_rel(got, want) -> float:
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = float(np.linalg.norm(want.ravel()))
    num = float(np.linalg.norm((got - want).ravel()))
    return num / den if den > 0 else num


def library_call(im, args, batched: bool = False):
    """One PyTorch call computing a lone group's (or the RMSNorm
    group's, ``F.rms_norm``) function, or None; with
    ``batched``, over a leading batch axis of every argument (matrix
    products as ``matmul``, scalars broadcast along the batch)."""
    import torch
    calls = im.fusion.calls
    ext = list(im.fusion.external_inputs)     # x*x reads x once
    if [c.elem.name for c in calls] == ["ew_mul", "sum_reduce",
                                        "rms_scale"] and not batched \
            and hasattr(torch.nn.functional, "rms_norm"):
        # x * rsqrt(sum(x^2) / n + eps) * gamma, with inv_d = 1 / n
        x, gamma = (args[ext.index(v)] for v in calls[2].args[2:])
        return lambda: torch.nn.functional.rms_norm(
            x[None], (x.shape[0],), gamma, eps=1e-6)[0]
    if len(calls) != 1:
        return None
    name = calls[0].elem.name
    args = [args[ext.index(v)] for v in calls[0].args]
    if batched:
        if name in ("gemv", "attn_score"):
            return lambda: torch.matmul(args[0], args[1][..., None])[..., 0]
        if name in ("gemtv", "attn_out"):
            return lambda: torch.matmul(args[0].transpose(1, 2),
                                        args[1][..., None])[..., 0]
        if name in ("sum_reduce", "max_reduce"):
            red = torch.sum if name == "sum_reduce" else torch.amax
            return lambda: red(args[0], dim=-1)
        # elementwise: a batch of scalars as a column
        args = [a[:, None] if a.dim() == 1 else a for a in args]
    if name == "gemv":
        return lambda: torch.mv(args[0], args[1])
    if name == "gemtv":
        return lambda: torch.mv(args[0].T, args[1])
    if name in ("ew_add", "madd"):
        return lambda: torch.add(args[0], args[1])
    if name in ("scal", "ew_mul"):
        return lambda: torch.mul(args[0], args[1])
    if name in ("axpy", "xpay"):                  # a*x + y
        return lambda: torch.addcmul(args[2], args[0], args[1])
    if name == "axmy":                            # w - a*v
        return lambda: torch.addcmul(args[1], args[0], args[2], value=-1)
    if name == "sum_reduce":
        return lambda: torch.sum(args[0])
    if name == "max_reduce":
        return lambda: torch.amax(args[0])
    if name == "attn_score":                      # K q
        return lambda: torch.mv(args[0], args[1])
    if name == "attn_out":                        # V^T w
        return lambda: torch.mv(args[0].T, args[1])
    if name == "div_by":                          # e / z
        return lambda: torch.div(args[1], args[0])
    return None


def bound_of(nbytes: float, ops: float, peak: float = F32_OPS_PER_S):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over the peak rate (float32 outside the tensor
    cores by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(im):
    """Least time for the group's work: each input read once, each output
    written once, against the float32 operations it does."""
    f = im.fusion
    nbytes = sum(v.nbytes for v in f.external_inputs) + \
        sum(v.nbytes for v in f.outputs)
    return bound_of(nbytes, sum(c.elem.flops(c.axis_sizes) for c in f.calls))


def hand_bound(kernel: str, shape):
    """Least time for K2-K4's function at ``shape``: its inputs read
    once and its outputs written once (float32 vectors and scalars),
    against its float32 operations."""
    a, b = shape
    if kernel == "K2/bicgk":                # A, p, r -> q, s
        return bound_of(4 * (a * b + 2 * a + 2 * b), 4 * a * b)
    if kernel == "K3/gemver_k1":            # A, u1, v1, u2, v2, y -> B, t
        return bound_of(4 * (2 * a * b + 3 * a + 3 * b), 6 * a * b)
    if kernel == "K3/gemver_k2":            # B, x, alpha -> w
        return bound_of(4 * (a * b + b + 1 + a), 2 * a * b + a)
    es = 2 if kernel.endswith("bf16") else 4    # x -> out, gamma float32
    return bound_of(2 * es * a * b + 4 * b, 4 * a * b)


def k5_bounds(shape, dtype: str, chunks: int):
    """Least times of K5's split kernel (q, K, V -> float32 partials per
    chunk), its combine kernel (partials -> o) and the whole function (q,
    K, V -> o), with ``chunks`` chunks of S per (b, h_kv)."""
    B, Hq, Hkv, S, d = shape
    es, G = ES[dtype], Hq // Hkv
    q_o = B * Hq * d * es
    kv = 2 * B * S * Hkv * d * es
    part = B * Hkv * chunks * (G * d + 2 * G) * 4
    ops = 4 * B * Hq * S * d + 4 * B * Hq * S     # q.k, p v; the softmax
    return (bound_of(q_o + kv + part, ops),
            bound_of(part + q_o, 3 * B * Hq * chunks * d),
            bound_of(2 * q_o + kv, ops))


def k6_bound(n: int, dtype: str):
    """AdamW with p and g in ``dtype``: p, g, m, v read, p', m', v'
    written; 16 float32 operations a parameter."""
    es = ES[dtype]
    return bound_of(n * (3 * es + 16), 16 * n)


def k7_bound(T: int, V: int, dtype: str, label_bytes: int = 8):
    """Softmax cross-entropy: the logits and labels read, T losses
    written; a max, an exp, a sum and a compare a logit."""
    return bound_of(T * V * ES[dtype] + T * (label_bytes + 4), 4 * T * V)


def k7_block_bound(T: int, Vb: int, dtype: str, label_bytes: int = 4):
    """K7's block entry: one block of the logits and the labels read, the
    (max, sum, x[label]) triple written, 12 bytes a row; a max, an exp,
    a sum and a compare a logit."""
    return bound_of(T * Vb * ES[dtype] + T * (label_bytes + 12), 4 * T * Vb)


def bits(t):
    """A tensor's bits as integers of its width, for bitwise compares."""
    import torch
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def tensor_err(got, want):
    """(norm-relative error, max abs error) of tensors, in float64 on
    their device."""
    g, w = got.double(), want.double()
    den = float(w.norm())
    num = float((g - w).norm())
    return (num / den if den > 0 else num), float((g - w).abs().max())


def hand_calls(name, d):
    """The ``ops`` call serving program ``name`` (one of ``HANDED``) on
    device inputs ``d``, with the program's outputs in order."""
    from repro_torch.kernels import ops
    if name == "GEMVER":
        return lambda: ops.gemver(d["A"], d["u1"], d["v1"], d["u2"], d["v2"],
                                  d["y"], d["z"], d["alpha"], d["beta"])
    if name == "BiCGK":
        return lambda: ops.bicgk(d["A"], d["p"], d["r"])
    if name == "LM_DECODE_ATTN":        # Hq = Hkv = 1, B = 1
        return lambda: (ops.decode_attention(
            d["q"][None, None], d["K"][None, :, None],
            d["V"][None, :, None])[0, 0],)
    if name == "FUSED_ADAMW":
        from repro_torch.programs.models import ADAMW_HYPERS as H
        return lambda: ops.adamw_update(
            d["p"], d["grad"], d["m"], d["v"], lr=H["lr"],
            beta1=H["beta1"], beta2=H["beta2"], eps=H["eps"],
            weight_decay=H["weight_decay"], step=H["step"])
    return lambda: (ops.rmsnorm(d["x"][None], d["gamma"])[0],)


def fused_adamw_step(p, g, m, v, step: int):
    """One step of ``torch.optim.AdamW(fused=True)`` from (p, g, m, v) at
    ``step`` with ``ADAMW_HYPERS``, as a function returning (p', m', v').
    It updates its own copies in place, so only its first call gives
    the step's result; later calls are for timing."""
    import torch
    from repro_torch.programs.models import ADAMW_HYPERS as H
    pl = p.clone()
    pl.grad = g.clone()
    opt = torch.optim.AdamW([pl], lr=H["lr"], betas=(H["beta1"], H["beta2"]),
                            eps=H["eps"], weight_decay=H["weight_decay"],
                            fused=True)
    st = opt.state[pl]
    st["step"] = torch.tensor(float(step - 1), device=p.device)
    st["exp_avg"], st["exp_avg_sq"] = m.clone(), v.clone()

    def run():
        opt.step()
        return pl, st["exp_avg"], st["exp_avg_sq"]
    return run


def library_sequence(name, d):
    """The library calls the paper measures a program against: cuBLAS
    matvecs and rank-1 updates, ``addcmul`` and ``dot``, one
    ``F.rms_norm``, one ``F.scaled_dot_product_attention``, or one step of
    ``torch.optim.AdamW(fused=True)`` (the same update: decoupled decay,
    then ``lr c1 m / (sqrt(v c2) + eps)``; it updates its own copies in
    place).  Timed here only; the port never calls them.  None where the
    library has no call."""
    import torch
    F = torch.nn.functional
    if name == "GEMVER":
        alpha, beta = float(d["alpha"]), float(d["beta"])

        def gemver():
            B = torch.addr(d["A"], d["u1"], d["v1"])
            B = torch.addr(B, d["u2"], d["v2"])
            x = torch.addmv(d["z"], B.T, d["y"], alpha=beta)
            return B, x, torch.mv(B, x).mul_(alpha)
        return gemver
    if name == "BiCGK":
        return lambda: (torch.mv(d["A"], d["p"]), torch.mv(d["A"].T, d["r"]))
    if name == "AXPYDOT":               # z = w - alpha v; r = z . u
        def axpydot():
            z = torch.addcmul(d["w"], d["alpha"], d["v"], value=-1)
            return z, torch.dot(z, d["u"])
        return axpydot
    if name == "LM_DECODE_ATTN":        # (B, Hkv, S, d) views
        return lambda: (F.scaled_dot_product_attention(
            d["q"][None, None, None], d["K"][None, None],
            d["V"][None, None], enable_gqa=True)[0, 0, 0],)
    if name == "FUSED_ADAMW":
        from repro_torch.programs.models import ADAMW_HYPERS as H
        return fused_adamw_step(d["p"], d["grad"], d["m"], d["v"],
                                H["step"])
    if not hasattr(F, "rms_norm"):
        return None
    n = d["x"].shape[0]
    return lambda: (F.rms_norm(d["x"][None], (n,), d["gamma"], eps=1e-6)[0],)


def lm_step_bound(cfg, B: int, kv_len: int, experts=None):
    """Least time of one bfloat16 decode step of ``cfg`` for B sequences
    at KV length ``kv_len``: every weight the step uses read once (each
    decoder layer's, the final norm's and ``unembed``; ``embed`` only at
    the B tokens' rows; no encoder weight, nor a Whisper decoder's
    cross-attention ``x_wk``/``x_wv``, whose K/V the cache holds), the
    cache read up to ``kv_len`` (K and V, or MLA's latent and rope key:
    r + rd elements a row; a hybrid's ring up to ``min(kv_len, W)``
    rows; a Whisper decoder's cross K/V, all F frames), the SSD state
    read and written in float32, the new rows and the logits written,
    against the matmuls', attention's and the state update's operations
    on the tensor cores (MLA's absorbed attention: the latent scores,
    the rope scores and the latent values).  An MoE layer reads the
    weights of ``experts[i]`` distinct experts (its router's choices in
    one step; all E where None: the reference's formulation, whose
    expert batch multiplies every expert) and computes k of them a
    token.  Returns (ms, what bounds it, bytes)."""
    from repro_torch.models import model_shapes
    shapes = model_shapes(cfg)
    L, E, fam = cfg.n_layers, cfg.n_experts, cfg.family
    stacks = [(shapes.get("head_layers", {}), "dense"),
              (shapes["layers"], "moe" if fam == "moe" else "dense")]
    cached = ("x_wk", "x_wv") if fam == "encdec" else ()
    weights = ops = 0
    moe_i = 0
    for stack, kind in stacks:
        n = next(iter(stack.values()))[0] if stack else 0
        for _ in range(n):
            for name, s in stack.items():
                size = math.prod(s[1:])
                if name in cached:
                    continue
                if kind == "moe" and name in ("wg", "wu", "wd"):
                    used = E if experts is None else experts[moe_i]
                    weights += size // E * used
                    ops += 2 * B * cfg.topk * (size // E)
                else:
                    weights += size
                    ops += 2 * B * size if len(s) == 3 else 0
            moe_i += kind == "moe"
    head = math.prod(shapes.get("unembed", shapes["embed"]))
    norms = sum(math.prod(s) for k, s in shapes.items()
                if k.startswith("final_"))
    rows, attn, state = kv_len, 0, 0
    if cfg.kv_lora_rank:
        row = cfg.kv_lora_rank + cfg.qk_rope_dim
        attn = 2 * B * cfg.n_heads * kv_len * (2 * cfg.kv_lora_rank
                                               + cfg.qk_rope_dim)
    elif fam == "ssm":
        row = 0
    else:
        row = cfg.n_kv_heads * cfg.dh * 2        # one position's k and v
        if fam == "hybrid":
            rows = min(kv_len, cfg.window)
        if fam == "encdec":                      # the cross K/V, F rows
            rows += cfg.encoder_frames
        attn = 4 * B * cfg.n_heads * rows * cfg.dh
    if fam in STATEFUL:                          # mul, fma, the readout
        state = B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
    nbytes = (2 * (weights + head + norms + B * cfg.d_model)
              + 2 * L * B * rows * row + 2 * L * B * row
              + 2 * 4 * L * state + 2 * B * cfg.vocab)
    ms, by = bound_of(nbytes, ops + 2 * B * head + L * (attn + 5 * state),
                      BF16_OPS_PER_S)
    return ms, by, nbytes


def cost_terms(cfg, seq: int, batch: int, kind: str) -> dict:
    """``launch.costmodel.estimate(cfg, shape).terms(1)`` in ms: the
    closed-form step bound on one card (the data sheet's 989 TFLOP/s
    bf16 and 3.35 TB/s), printed beside the smoke's own bounds and the
    measured step, not held."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.costmodel import estimate
    t = estimate(cfg, ShapeConfig("chip", seq, batch, kind)).terms(1)
    return {"kind": kind, "seq": seq, "batch": batch,
            "t_compute_ms": t["t_compute_s"] * 1e3,
            "t_memory_ms": t["t_memory_s"] * 1e3,
            "step_lower_bound_ms": t["step_lower_bound_s"] * 1e3,
            "dominant": t["dominant"],
            "roofline_fraction": t["roofline_fraction"]}


def device_busy(prof) -> dict:
    """From a ``torch.profiler`` run: the device's busy time (the union of
    its kernels' intervals, µs) and the kernels' device time by name,
    largest first; an empty record where the trace shows no device
    work."""
    import torch
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"kernels": len(evs), "busy_us": busy if evs else None,
            "by_kernel_us": dict(top[:12]),
            "other_kernels_us": sum(t for _, t in top[12:])}


class forbid_plain:
    """Within the block, a call of any plain version in ``kernels.ref``
    raises: the decode step counted there must run the kernels alone."""

    NAMES = ("rmsnorm", "rmsnorm_block_sumsq", "rmsnorm_block_scale",
             "decode_attention", "decode_attention_split",
             "decode_attention_combine")

    def __init__(self, ref):
        self.ref, self.saved = ref, {}

    def __enter__(self):
        def plain(*a, **k):
            raise AssertionError("the counted step reached a plain version")
        for n in self.NAMES:
            self.saved[n] = getattr(self.ref, n)
            setattr(self.ref, n, plain)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.ref, n, f)


def lm_phase(args, failures: list, smi_line: str) -> list:
    """Phase 2: ``serve --arch``'s loop on the card for each of
    ``LM_RUNS`` (``lm_run``), then decode against forward in float32 for
    each of ``LM_F32_RUNS``; returns the kernel records of the runs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import draw_inputs, load_model

    records = []
    for arch, depth in LM_RUNS:
        records += lm_run(args, arch, depth, failures, smi_line)

    # the same check in float32 (TF32 off): the gap of the two algorithms
    # without bfloat16's rounding
    for arch, depth in LM_F32_RUNS:
        cfg, reduced = lm_config(get_config(arch), depth)
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        P = LM_PROMPTS.get(arch, LM_PROMPT)
        model = load_model(cfg, args.seed, "cuda")
        x = draw_inputs(cfg, LM_BATCH, P, args.seed)
        seq, steps = x["prompts"], 1
        if cfg.family in STATEFUL:      # random tokens stand for generated
            seq = np.concatenate([seq, np.random.default_rng(
                args.seed + 1).integers(0, cfg.vocab, (LM_BATCH, LM_GEN))
                .astype(np.int32)], axis=1)
            steps = LM_GEN
        dvf = decode_vs_forward(cfg, model, seq, steps, x["patches"],
                                x["frames"])
        del model
        torch.cuda.empty_cache()
        emit({"phase": "lm", "arch": arch, "dtype": "float32",
              "reduced": reduced, "n_layers": cfg.n_layers,
              "nvidia_smi": smi_line, **dvf})
        # in float32 the two passes route every token alike
        if not (dvf["decode_vs_forward_checked"] <= RTOL
                and dvf.get("layer_gap_max", 0.0) <= RTOL
                and not dvf.get("routing_flips")):
            failures.append(f"lm {arch} float32: decode against forward "
                            f"{dvf['decode_vs_forward_checked']:.3g}, "
                            f"largest layer gap {dvf.get('layer_gap_max')}"
                            f" (bound {RTOL}), routing flips "
                            f"{dvf.get('routing_flips')}")
    return records


def lm_config(cfg, depth):
    """(``cfg`` at ``depth`` layers, its encoder too, and the ``reduced``
    record), or (cfg, None) at its full depth."""
    import dataclasses
    if depth is None:
        return cfg, None
    cut = {"n_layers": depth}
    if cfg.family == "encdec":
        cut["encoder_layers"] = depth
    return (dataclasses.replace(cfg, **cut),
            {k: [getattr(cfg, k), n] for k, n in cut.items()})


def lm_step_launches(cfg) -> dict:
    """The hand kernels' launches in one bfloat16 decode step of ``cfg``:
    K4 for every RMSNorm (``ln1`` and, but for the SSD mixer alone,
    ``ln2`` a layer, the SSD mixer's gated norm, a hybrid's two mixing
    norms, the final norm; none with LayerNorm), K5's split and combine
    for every GQA attention (a hybrid's ring, a Whisper decoder's self-
    and cross-attention; none with MLA or the SSD mixer alone).  A
    prefill launches K4 as often."""
    L, fam = cfg.n_layers, cfg.family
    k4 = {"ssm": 2, "hybrid": 5}.get(fam, 2) * L + 1
    k5 = 0 if cfg.kv_lora_rank or fam == "ssm" else L
    if fam == "encdec":
        k4, k5 = 0, 2 * L
    out = {"K4/rmsnorm_bf16": k4} if k4 else {}
    if k5:
        out |= {"K5/split_bf16": k5, "K5/combine_bf16": k5}
    return out


def lm_k5_shapes(cfg, B: int, P: int, G: int) -> list:
    """K5's calls in ``cfg``'s decode steps as (where, (B, Hq, Hkv, S,
    d), the steps' mean ``kv_len``): the cache at its horizon P + G, a
    hybrid's ring of W slots (full from the first step when P >= W), a
    Whisper decoder's cross K/V over its F frames."""
    if cfg.kv_lora_rank or cfg.family == "ssm":
        return []
    heads = (B, cfg.n_heads, cfg.n_kv_heads)
    if cfg.family == "hybrid":
        W = cfg.window
        return [("decode ring", heads + (W, cfg.dh),
                 min(P + G // 2, W))]
    out = [("decode", heads + (P + G, cfg.dh), P + G // 2)]
    if cfg.family == "encdec":
        F = cfg.encoder_frames
        out.append(("decode cross", heads + (F, cfg.dh), F))
    return out


def lm_run(args, arch: str, depth, failures: list, smi_line: str) -> list:
    """``launch.serve.generate`` for ``arch`` (at ``depth`` layers where
    given) from ``--seed``: 8 prompts of 1024 tokens (``LM_PROMPTS``
    apart; a VLM's patches, an encoder-decoder's frames, drawn after
    them as ``serve --arch`` draws them), 32 greedy tokens, the counts
    set to 0 just before and read just after (``lm_step_launches`` a
    step, K4 as often in the prefill).  Then one more step counted with
    every plain version forbidden, the same step repeated (bitwise equal
    logits; a recurrent state restored to what the first read, and the
    states they leave bitwise equal), timed as one CUDA graph and
    traced; for an MoE model the share of assignments the prefill drops
    and the distinct experts of one step (which the step's bound
    counts); decode against forward; K5 and K4 at the run's shapes
    against their plain versions, with bitwise repeats.  Returns the
    kernel records (``lm_records``; none for ``LM_ARCH2``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import LAUNCHES
    from repro_torch.core.timing import graph_ms
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import draw_inputs, generate, load_model
    from repro_torch.models import prefill
    from repro_torch.train.steps import make_decode_step

    B, P, G = LM_BATCH, LM_PROMPTS.get(arch, LM_PROMPT), LM_GEN
    cfg, reduced = lm_config(get_config(arch), depth)
    L, fam, moe = cfg.n_layers, cfg.family, cfg.family == "moe"
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = load_model(cfg, args.seed, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak_load = torch.cuda.max_memory_allocated() - base
    n_params = sum(p.numel() for p in model.parameters())
    x = draw_inputs(cfg, B, P, args.seed)
    prompts, extra = x["prompts"], {k: x[k] for k in ("patches", "frames")}
    warm = dict(extra)
    if warm["patches"] is not None:             # 8 patches in 16 tokens
        warm["patches"] = warm["patches"][:, :8]
    generate(cfg, model, prompts[:, :16], 2, **warm)        # warm-up
    # the eager path's first steps, held against the replay below
    eager = eager_steps(cfg, model, prompts, G, extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before, read just after; the
    # first step eager, the rest replaying its one CUDA graph
    LAUNCHES.reset()
    res = generate(cfg, model, prompts, G, **extra)
    torch.cuda.synchronize()
    main_launches = dict(LAUNCHES.by_kernel)
    peak_serve = torch.cuda.max_memory_allocated() - base
    toks, prefill_ms, steps_ms = res["tokens"], res["prefill_ms"], \
        res["step_ms"][1:]
    first_ms, captures = res["step_ms"][0], res["captures"]
    decode_s = sum(res["step_ms"]) / 1e3
    tokens_ok = toks.shape == (B, G) and bool(
        ((toks >= 0) & (toks < cfg.vocab)).all())
    if captures != 1:
        failures.append(f"lm {arch}: generate captured {captures} graphs, "
                        f"want 1")
    replay_vs_eager = bool(np.array_equal(toks[:, :EAGER_STEPS + 1],
                                          eager["tokens"]))
    if not replay_vs_eager:
        failures.append(f"lm {arch}: the replayed tokens differ from the "
                        f"eager path's over the first {EAGER_STEPS} steps")

    # one more step at the cache's last row: counted, with every plain
    # version forbidden, repeated, then timed as one graph, then traced
    cache = res["cache"]
    tok = torch.as_tensor(toks[:, -1], device="cuda")
    pos = P + G - 1
    step = make_decode_step(cfg)
    state0 = cache["state"].clone() if fam in STATEFUL else None
    with forbid_plain(ref):
        LAUNCHES.reset()
        _, step_logits, _ = step(model, cache, tok, pos)
        torch.cuda.synchronize()
        step_launches = dict(LAUNCHES.by_kernel)
    state_same = True
    if state0 is not None:          # the repeat reads the same state
        state1 = cache["state"].clone()
        cache["state"].copy_(state0)
    _, again, _ = step(model, cache, tok, pos)
    if state0 is not None:
        state_same = torch.equal(bits(cache["state"]), bits(state1))
        del state0, state1
    repeat_bitwise = torch.equal(bits(step_logits), bits(again)) \
        and state_same
    want_launches = lm_step_launches(cfg)
    if step_launches != want_launches:
        failures.append(f"lm {arch}: one decode step launched "
                        f"{step_launches}, want {want_launches}")
    # the main run: the prefill's K4 launches, then G - 1 steps
    want_main = {k: n * (G if k.startswith("K4") else G - 1)
                 for k, n in want_launches.items()}
    if main_launches != want_main:
        failures.append(f"lm {arch}: the main run launched "
                        f"{main_launches}, want {want_main}")
    logits_finite = bool(torch.isfinite(step_logits).all())
    step_dev_ms, step_how = graph_ms(lambda: step(model, cache, tok, pos))
    if step_how != "graph":
        failures.append(f"lm {arch}: the decode step could not be "
                        f"captured as one CUDA graph")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, cache, tok, pos)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    trace = device_busy(prof)
    busy_us = trace.pop("busy_us")

    moe_rec, experts = {}, None
    if moe:
        with moe_routes() as routes:
            prefill(cfg, model, torch.as_tensor(prompts, device=model.device))
        dropped = [int((~keep).sum()) for *_, keep in routes]
        total = [keep.numel() for *_, keep in routes]
        with moe_routes() as routes:
            step(model, cache, tok, pos)
        experts = [int(torch.unique(idx).numel()) for _, idx, _ in routes]
        moe_rec = {"n_experts": cfg.n_experts, "topk": cfg.topk,
                   "n_shared_experts": cfg.n_shared_experts,
                   "first_dense_layers": cfg.first_dense_layers,
                   "d_ff_moe": cfg.d_ff_moe,
                   "capacity_factor": cfg.capacity_factor,
                   "prefill_dropped_share": sum(dropped) / sum(total),
                   "prefill_dropped_by_layer": [
                       d / n for d, n in zip(dropped, total)],
                   "step_experts_by_layer": experts,
                   "step_experts_mean": sum(experts) / len(experts)}
    kv_lens = [P + i + 1 for i in range(G - 1)]
    bounds = [lm_step_bound(cfg, B, n, experts)[0] for n in kv_lens]
    bound_ms = sum(bounds) / len(bounds)
    last = lm_step_bound(cfg, B, kv_lens[-1], experts)
    cost = cost_terms(cfg, kv_lens[-1], B, "decode") | {
        "lm_step_bound_ms": last[0]}
    if moe:
        all_e = lm_step_bound(cfg, B, kv_lens[-1])
        moe_rec.update(bound_bytes=last[2],
                       reference_formulation_bytes=all_e[2],
                       reference_formulation_bound_ms=all_e[0])
    del res, cache, step_logits, again
    torch.cuda.empty_cache()

    if fam in STATEFUL:     # every step of the run against the forward
        dvf = decode_vs_forward(cfg, model, np.concatenate(
            [prompts, toks], axis=1), G, **extra)
    else:
        dvf = decode_vs_forward(cfg, model, prompts, 1, **extra)
    held = arch not in DRIFTING
    if not ((dvf["decode_vs_forward_checked"] <= DECODE_VS_FORWARD
             or not held)
            and dvf.get("layer_gap_max", 0.0) <= DECODE_VS_FORWARD
            and tokens_ok and logits_finite and repeat_bitwise):
        failures.append(f"lm {arch}: decode against forward "
                        f"{dvf['decode_vs_forward_checked']:.3g} (held "
                        f"{held}), largest layer gap "
                        f"{dvf.get('layer_gap_max')} (bound "
                        f"{DECODE_VS_FORWARD}), tokens ok {tokens_ok}, "
                        f"logits finite {logits_finite}, repeat bitwise "
                        f"{repeat_bitwise}")
    dvf["decode_vs_forward_held"] = held
    emit({"phase": "lm", "arch": arch, "family": fam, "nvidia_smi": smi_line,
          "reduced": reduced, "n_layers": L, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "kv_lora_rank": cfg.kv_lora_rank, "d_ff": cfg.d_ff,
          "d_inner": cfg.d_inner if fam in STATEFUL else None,
          "ssm_state": cfg.ssm_state, "window": cfg.window,
          "encoder_layers": cfg.encoder_layers if fam == "encdec" else None,
          "encoder_frames": cfg.encoder_frames if fam == "encdec" else None,
          "n_patches": cfg.n_patches, "vocab": cfg.vocab, "params": n_params,
          "dtype": cfg.compute_dtype, "batch": B, "prompt": P, "gen": G,
          "load_s": load_s, "peak_load_bytes": peak_load,
          "peak_serve_bytes": peak_serve, "base_bytes": base,
          "prefill_ms": prefill_ms,
          "step_ms_median": float(np.median(steps_ms)),
          "step_ms_min": min(steps_ms), "step_ms_max": max(steps_ms),
          "step_ms": steps_ms, "first_step_ms": first_ms,
          "captures": captures,
          "eager_step_ms_median": float(np.median(eager["step_ms"])),
          "eager_step_ms": eager["step_ms"],
          "replay_vs_eager_tokens_equal": replay_vs_eager,
          "replay_over_bound": float(np.median(steps_ms)) / bound_ms,
          "decode_tok_s": B * (len(steps_ms) + 1) / decode_s,
          "bound_ms_per_step": bound_ms, "bound_tok_s": B / bound_ms * 1e3,
          "bound_by": last[1], "bound_bytes_last_step": last[2], **moe_rec,
          "costmodel_last_step": cost,
          "step_device_ms": step_dev_ms, "step_timed_by": step_how,
          "traced_step_ms": traced_s * 1e3,
          "traced_busy_ms": None if busy_us is None else busy_us / 1e3,
          "traced_busy_share": None if busy_us is None
          else busy_us / 1e6 / traced_s,
          "device_share_of_step": step_dev_ms / float(np.median(steps_ms)),
          "trace": trace, "main_launches": main_launches,
          "step_launches": step_launches,
          "step_repeat_bitwise": repeat_bitwise, **dvf,
          "tokens_ok": tokens_ok, "sample": toks[0][:16].tolist()})
    k5_shapes = lm_k5_shapes(cfg, B, P, G)
    if arch == LM_ARCH:
        shape = k5_shapes[0][1]
        checks = [(shape, n, dt) for n, dt in ((P + 1, "bfloat16"),
                                               (P + G, "bfloat16"),
                                               (777, "float32"))]
    elif arch == LM_ARCH2:
        checks = [(k5_shapes[0][1], P + 1, "bfloat16")]
    else:
        checks = [(shape, kv_len, "bfloat16")
                  for _, shape, kv_len in k5_shapes]
    del model
    torch.cuda.empty_cache()

    # K5 and K4 at the decode's shapes against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # ... and with kv_len in device memory, as the replayed step reads
    # it: every shape the decode gives K5, at the steps' mean kv_len and
    # at half a chunk (all chunks but the first empty)
    for _, shape, kv_len in k5_shapes:
        b, hq, hkv, S, d = shape
        c5 = k5.config(hq // hkv, d, torch.bfloat16, torch.device("cuda"))
        length = k5.chunk_plan(k5.ctas_per_chunk(b, hkv, c5), S,
                               c5["ctas_per_sm"] * c5["sms"], c5["tile"])[1]
        checks += [(shape, kv_len, "bfloat16", "device"),
                   (shape, max(1, length // 2), "bfloat16", "device")]
    for shape, kv_len, dt, *where in checks:
        b, hq, hkv, S, d = shape
        tdt = getattr(torch, dt)
        q, kk, vv = (randn(b, hq, d, dtype=tdt),
                     randn(b, S, hkv, d, dtype=tdt),
                     randn(b, S, hkv, d, dtype=tdt))
        tol = BF16_KERNEL_RTOL if dt == "bfloat16" else RTOL
        kl = (torch.full((), kv_len, dtype=torch.int32, device="cuda")
              if where else kv_len)
        got = k5.decode_attention(q, kk, vv, kv_len=kl)
        again = k5.decode_attention(q, kk, vv, kv_len=kl)
        rel, mabs = tensor_err(got, ref.decode_attention(
            q, kk, vv, kv_len=kl))
        same = torch.equal(bits(got), bits(again))
        rec = {"phase": "lm_kernel", "arch": arch, "kernel": "K5",
               "shape": list(shape), "kv_len": kv_len, "dtype": dt,
               "kv_len_on_device": bool(where), "norm_rel_err": rel,
               "max_abs_err": mabs, "repeat_bitwise": same}
        if where:
            acc, mm, ll, length = k5.split(q, kk, vv, kv_len=kl)
            rows = acc.shape[0] // (b * hkv)
            e_split = max(tensor_err(x[torch.isfinite(y)],
                                     y[torch.isfinite(y)])[1]
                          for x, y in zip((acc, mm, ll),
                                          ref.decode_attention_split(
                                              q, kk, vv, length, kv_len=kl)))
            empty = rows - -(-kv_len // length)
            rec.update(chunks=rows, chunk_len=length, empty_chunks=empty,
                       split_max_abs_err=e_split)
            same = same and e_split <= BF16_KERNEL_RTOL
        emit(rec)
        if not (rel <= tol and same):
            failures.append(f"lm_kernel K5 {shape} kv_len {kv_len} {dt} "
                            f"{where}: error {rel:.3g} (tol {tol}), bitwise "
                            f"repeat and split {same}")
    k4_inputs = lm_k4_checks(cfg, P, randn, failures)
    if arch == LM_ARCH2:
        return []
    return lm_records(cfg, randn, k4_inputs, k5_shapes, main_launches,
                      failures, label="" if arch == LM_ARCH else f"{arch} ",
                      device_kv=arch == LM_ARCH)


def eager_steps(cfg, model, prompts, G: int, extra: dict) -> dict:
    """``generate``'s first ``EAGER_STEPS`` decode steps on the eager path:
    the same prefill, the cache grown to the same horizon P + G (so K5
    plans the same chunks), ``train.steps.DecodeReplay`` with no capture;
    the (B, EAGER_STEPS + 1) tokens and each step's ms (CUDA events)."""
    import torch

    from repro_torch.launch.serve import grow_cache
    from repro_torch.train import steps

    batch = {"tokens": torch.as_tensor(prompts, device=model.device)}
    batch |= {k: torch.as_tensor(a, device=model.device)
              for k, a in extra.items() if a is not None}
    logits, cache = steps.make_prefill_step(cfg)(model, batch)
    cache = grow_cache(cfg, cache, prompts.shape[1] + G)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    replay = steps.DecodeReplay(cfg, model, cache, tok, prompts.shape[1])
    out, ms = [tok], []
    for _ in range(EAGER_STEPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out.append(replay())
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return {"tokens": torch.stack(out, 1).cpu().numpy(), "step_ms": ms}


def train_matmul_flops(cfg, B: int, S: int) -> dict:
    """The bfloat16 matmul flops of one train step of ``cfg`` on B
    sequences of S tokens, counted from the code: each decoder layer's
    2-D weights (2 T · size a forward pass) and the unembedding; the
    backward twice the forward; the layers' forward once more (the
    backward's recompute under ``cfg.remat``).  The blockwise attention's
    float32 matmuls (q kᵀ and p v over every (query, key) block: 4 B S²
    Hq dh a layer a pass) are counted apart."""
    from repro_torch.models import model_shapes
    shapes = model_shapes(cfg)
    T = B * S
    layer = sum(math.prod(s[1:]) for s in shapes["layers"].values()
                if len(s) == 3)
    fwd_layers = 2 * T * layer * shapes["layers"]["wq"][0]
    fwd_head = 2 * T * math.prod(shapes.get("unembed", shapes["embed"]))
    passes = 3 + bool(cfg.remat)
    attn = 4 * B * S * S * cfg.n_heads * cfg.dh * cfg.n_layers * passes
    return {"bf16_matmul_flops": 3 * (fwd_layers + fwd_head)
            + (fwd_layers if cfg.remat else 0),
            "f32_attention_flops": attn}


def train_run(args, depth: int, steps: int, moments: str, failures: list,
              smi_line: str, checks: bool, ckpt=None) -> tuple[dict, list]:
    """``TRAIN_ARCH`` at full width and ``depth`` layers with
    ``opt_moment_dtype=moments``: ``launch.train.build_state`` from
    ``--seed``, ``steps`` steps of ``train.steps.make_train_step`` on the
    synthetic pipeline's batches (B ``TRAIN_BATCH`` x ``TRAIN_SEQ``), the
    counts set to 0 just before the steps and read just after; each
    step's ms (CUDA events, the host reading the loss as the launcher
    does), tokens a second, the peak, the launches of one step, the
    matmul flop share of the dense bfloat16 peak, the losses.  With
    ``checks``, before the first step K7's per-row losses on the step's
    logits against its plain version (and timed beside its bound, its
    plain version and ``F.cross_entropy``), and on the first step K6 on
    the first MLP leaf against its plain version; after the steps K6
    timed on the largest leaf, and one more step traced by
    ``torch.profiler`` (busy share, device time by kernel).  ``ckpt`` (a
    ``ckpt_check``) sees the state after every step and the run's end.
    Returns (the phase line, the kernel records)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import LAUNCHES
    from repro_torch.core.timing import device_ms, graph_ms, time_ms
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.kernels import adamw as k6
    from repro_torch.kernels import ref
    from repro_torch.kernels import softmax_xent as k7
    from repro_torch.launch.train import build_state
    from repro_torch.models import forward_lm
    from repro_torch.optim import AdamWHyper
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.train.steps import make_train_step

    F = torch.nn.functional
    cfg, reduced = lm_config(get_config(TRAIN_ARCH), depth)
    cfg = dataclasses.replace(cfg, opt_moment_dtype=moments)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = build_state(cfg, args.seed, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in state["params"].values())
    hyper = AdamWHyper(lr=TRAIN_LR, warmup_steps=max(1, steps // 20),
                       total_steps=steps)
    step = make_train_step(cfg, hyper)
    get = make_batch_fn(cfg, ShapeConfig("chip", S, B, "train"))
    batches = [shard_batch(get(i), "cuda") for i in range(steps)]
    records, line = [], {}
    if checks:      # K7 on the first step's logits
        with torch.no_grad():
            logits = forward_lm(cfg, state["params_c"], batches[0]["tokens"]
                                )[0].reshape(-1, cfg.vocab)
        labels = batches[0]["labels"].reshape(-1)
        rows = k7.softmax_xent_rows(logits, labels)
        again = k7.softmax_xent_rows(logits, labels)
        rel, mabs = tensor_err(rows, ref.softmax_xent_rows(logits, labels))
        same = torch.equal(bits(rows), bits(again))
        valid = labels >= 0
        lab64 = labels.long()
        lib = F.cross_entropy(logits, lab64, ignore_index=-1,
                              reduction="none")
        lib_err = tensor_err(lib[valid], rows[valid])[0]
        b_ms, b_by = k7_bound(*logits.shape, "bfloat16", label_bytes=4)
        ms, how = graph_ms(lambda: k7.softmax_xent_rows(logits, labels))
        rec7 = {"name": "K7/xent_bf16 (train, lm_loss)", "route": "cuda",
                "source": HAND["K7/xent_bf16"][0],
                "replaces": HAND["K7/xent_bf16"][1], "max_abs_err": mabs,
                "ms": ms,
                "plain_ms": time_ms(lambda: ref.softmax_xent_rows(
                    logits, labels), max_reps=5),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": graph_ms(lambda: F.cross_entropy(
                    logits, lab64, ignore_index=-1, reduction="none"))[0]}
        emit({"phase": "train_kernel", "kernel": "K7/xent_bf16",
              "shape": list(logits.shape), "norm_rel_err": rel,
              "repeat_bitwise": same, "library_norm_rel_err": lib_err,
              "timed_by": how, "bound_share": b_ms / ms,
              "masked_rows": int((~valid).sum())})
        if not (rel <= BF16_KERNEL_RTOL and same and lib_err <= BF16_RTOL):
            failures.append(f"train K7: error {rel:.3g}, bitwise repeat "
                            f"{same}, against the library {lib_err:.3g}")
        del logits, rows, again, lib

    tap = {}
    update = adamw_mod._update

    def tapped(p, g, m, v, *rest):
        out = update(p, g, m, v, *rest)
        if checks and not tap and tuple(p.shape) == (cfg.d_model,
                                                     cfg.d_ff):
            tap.update(args=[t.clone() for t in (p, g, m, v)],
                       lr=rest[1].clone(), step=rest[2].clone(),
                       out=[t.clone() for t in out])
        return out

    ms, losses, per_step = [], [], {}
    adamw_mod._update = tapped
    try:
        LAUNCHES.reset()
        for i in range(steps):
            before = dict(LAUNCHES.by_kernel)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            state, met = step(state, batches[i])
            b.record()
            losses.append(float(met["loss"]))
            ms.append(a.elapsed_time(b))
            if ckpt is not None:
                ckpt.after_step(i, cfg, state)
            if i == 1:
                per_step = {k: n - before.get(k, 0)
                            for k, n in LAUNCHES.by_kernel.items()
                            if n - before.get(k, 0)}
        torch.cuda.synchronize()
        main_launches = dict(LAUNCHES.by_kernel)
    finally:
        adamw_mod._update = update
    trace = None
    if checks:      # one more step, traced: where a step's time goes
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, batches[-1])
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        trace = device_busy(prof)
        busy_us = trace.pop("busy_us")
        trace.update(traced_step_ms=traced_s * 1e3,
                     traced_busy_share=None if busy_us is None
                     else busy_us / 1e6 / traced_s)
    peak = torch.cuda.max_memory_allocated() - base
    flops = train_matmul_flops(cfg, B, S)
    step_ms = float(np.median(ms[1:]))
    for k in ("K4/rmsnorm_bf16", "K6/adamw_f32", "K7/xent_bf16"):
        if not main_launches.get(k):
            failures.append(f"train depth {depth}: {k} was not launched")
    if not losses[-1] < losses[0] or not all(map(math.isfinite, losses)):
        failures.append(f"train depth {depth} {moments}: the loss did not "
                        f"fall: {losses}")
    line = {"phase": "train", "arch": TRAIN_ARCH, "nvidia_smi": smi_line,
            "reduced": reduced, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "params": n_params, "opt_moment_dtype": moments,
            "batch": B, "seq": S, "steps": steps, "lr": TRAIN_LR,
            "build_s": build_s, "step_ms": ms,
            "step_ms_median": step_ms, "first_step_ms": ms[0],
            "tokens_per_s": B * S / step_ms * 1e3,
            "peak_bytes": peak, "base_bytes": base, **flops,
            "bf16_peak_share": flops["bf16_matmul_flops"]
            / (step_ms / 1e3 * BF16_OPS_PER_S),
            "launches_per_step": per_step, "main_launches": main_launches,
            "losses": losses, "trace": trace,
            "costmodel": cost_terms(cfg, S, B, "train") | {
                "measured_step_ms": step_ms}}
    if checks:      # K6 on the first step, then timed on the largest leaf
        p, g, m, v = tap["args"]
        want = ref.adamw(p, g, m, v, lr=tap["lr"], beta1=hyper.beta1,
                         beta2=hyper.beta2, eps=hyper.eps,
                         weight_decay=hyper.weight_decay, step=tap["step"])
        errs = [tensor_err(x, y) for x, y in zip(tap["out"], want)]
        line["k6_first_step"] = {"shape": list(p.shape),
                                 "norm_rel_err": [e[0] for e in errs],
                                 "max_abs_err": [e[1] for e in errs]}
        if not max(e[0] for e in errs) <= K6_TRAIN_RTOL:
            failures.append(f"train K6: error {errs} against its plain "
                            f"version")
        del tap, p, g, m, v, want
        name = max(state["params"], key=lambda n: state["params"][n].numel())
        p = state["params"][name].reshape(-1)
        m, v = (state["opt"][k][name].reshape(-1) for k in ("m", "v"))
        g = torch.randn_like(p).mul_(1e-3)
        h = k6.hyper(lr=TRAIN_LR, beta1=hyper.beta1, beta2=hyper.beta2,
                     eps=hyper.eps, weight_decay=hyper.weight_decay,
                     step=steps + 1, device=p.device)
        got = k6.adamw(p, g, m, v, h)
        want = ref.adamw(p, g, m, v, lr=TRAIN_LR, beta1=hyper.beta1,
                         beta2=hyper.beta2, eps=hyper.eps,
                         weight_decay=hyper.weight_decay, step=steps + 1)
        mabs = max(tensor_err(x, y)[1] for x, y in zip(got, want))
        del got, want
        k6_ms, how = graph_ms(lambda: k6.adamw(p, g, m, v, h))
        b_ms, b_by = k6_bound(p.numel(), "float32")
        lib = fused_adamw_step(p, g, m, v, steps + 1)
        records.append({
            "name": f"K6/adamw_f32 (train, {name})", "route": "cuda",
            "source": HAND["K6/adamw_f32"][0],
            "replaces": HAND["K6/adamw_f32"][1],
            "launches": main_launches.get("K6/adamw_f32", 0),
            "max_abs_err": mabs, "ms": k6_ms,
            "plain_ms": time_ms(lambda: ref.adamw(
                p, g, m, v, lr=TRAIN_LR, beta1=hyper.beta1,
                beta2=hyper.beta2, eps=hyper.eps,
                weight_decay=hyper.weight_decay, step=steps + 1),
                max_reps=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(lib)})
        emit({"phase": "time", "path": "train", **records[-1],
              "timed_by": how, "bound_share": b_ms / k6_ms,
              "numel": p.numel()})
        del lib, g
        rec7["launches"] = main_launches.get("K7/xent_bf16", 0)
        emit({"phase": "time", "path": "train", **rec7,
              "bound_share": rec7["bound_ms"] / rec7["ms"]})
        records.append(rec7)
    if ckpt is not None:
        ckpt.finish(args, cfg, state, step, batches, losses, failures)
    del state, batches
    torch.cuda.empty_cache()
    return line, records


def train_backward_checks(args, failures: list) -> dict:
    """The K4 and K7 backward of the training forward (``kernels.grad``:
    the kernel forward, a plain float32 backward) against autograd
    through the plain versions, at the train step's shapes: K4 on
    (B·S, d_model) bfloat16, K7 on (B·S, vocab) bfloat16 with the
    pipeline's masked last positions and ``lm_loss``'s mean weights;
    both sides compute in float32 and round the gradients once to
    bfloat16, so they are held to ``BF16_KERNEL_RTOL``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import grad, ref

    cfg = get_config(TRAIN_ARCH)
    T = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)

    out = {}
    x, gam, dy = randn(T, cfg.d_model), 1 + randn(cfg.d_model, scale=0.1), \
        randn(T, cfg.d_model)
    # autograd through a plain version takes its gradients in float32
    # and rounds them once to the bfloat16 inputs' dtype, as the kernels'
    # backward does
    xk, gk = x.clone().requires_grad_(), gam.clone().requires_grad_()
    grad.rmsnorm(xk, gk).backward(dy)
    xr, gr = x.clone().requires_grad_(), gam.clone().requires_grad_()
    ref.rmsnorm(xr, gr).backward(dy)
    out["K4"] = [tensor_err(xk.grad, xr.grad)[0],
                 tensor_err(gk.grad, gr.grad)[0]]
    del x, dy, xk, xr
    logits = randn(T, cfg.vocab, scale=2.0)
    labels = torch.randint(0, cfg.vocab, (T,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[TRAIN_SEQ - 1::TRAIN_SEQ] = -1
    mask = (labels >= 0).float()
    dl = mask / mask.sum()
    lk = logits.clone().requires_grad_()
    grad.softmax_xent_rows(lk, labels).backward(dl)
    lr_ = logits.clone().requires_grad_()
    ref.softmax_xent_rows(lr_, labels).backward(dl)
    out["K7"] = [tensor_err(lk.grad, lr_.grad)[0]]
    emit({"phase": "train_backward", "k4_shape": [T, cfg.d_model],
          "k7_shape": [T, cfg.vocab], "norm_rel_err": out})
    worst = max(max(v) for v in out.values())
    if not worst <= BF16_KERNEL_RTOL:
        failures.append(f"train backward: {out} against autograd through "
                        f"the plain versions")
    return out


class ckpt_check:
    """Phase ``ckpt`` on the train phase's int8 run (``train_run`` calls
    ``after_step`` and ``finish``): after step ``at`` the state goes to
    ``AsyncCheckpointer.save`` under a temporary directory (the stall on
    this thread timed), and the run trains on; at its end the writer is
    closed (its seconds and GB/s from ``timings``), a state built from
    another seed is restored at ``at`` (timed) and trains the same
    steps: masters, the bf16 copy, moments, ``step`` and the losses must
    be bitwise the run's, and the restored steps launch K4, K6 and K7.
    Then one byte of ``CKPT_VICTIM``'s file is flipped and ``restore``
    must raise ``IOError``.  ``cleanup`` removes the directory."""

    def __init__(self, at: int, smi_line: str):
        self.at, self.dir, self.ck = at, None, None
        self.line = {"phase": "ckpt", "nvidia_smi": smi_line, "at": at}

    def after_step(self, i: int, cfg, state):
        import shutil
        import tempfile

        import torch

        from repro_torch.ckpt import AsyncCheckpointer
        if i + 1 != self.at:
            return
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        self.line.update(dir=self.dir,
                         free_bytes=shutil.disk_usage(self.dir).free)
        self.ck = AsyncCheckpointer(os.path.join(self.dir, "ck"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.ck.save(self.at, state, {"arch": cfg.name})
        self.line["stall_ms"] = (time.perf_counter() - t0) * 1e3

    def finish(self, args, cfg, state, step, batches, losses, failures):
        import json

        import torch

        from repro_torch.ckpt import restore
        from repro_torch.ckpt.checkpoint import _flatten
        from repro_torch.core import LAUNCHES
        from repro_torch.launch.train import build_state
        t0 = time.perf_counter()
        self.ck.close()
        close_s = time.perf_counter() - t0
        d = os.path.join(self.dir, "ck", f"step_{self.at:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        sizes = {k: os.path.getsize(os.path.join(d, m["file"]))
                 for k, m in manifest["leaves"].items()}
        timing = self.ck.timings[self.at]
        total = sum(sizes.values())
        part = {name: sum(n for k, n in sizes.items()
                          if k.startswith(prefix))
                for name, prefix in (("masters", "params/"),
                                     ("bf16_copy", "params_c/"),
                                     ("moments", "opt/m/"),
                                     ("moments_v", "opt/v/"))}
        torch.cuda.empty_cache()
        fresh = build_state(cfg, args.seed + 1, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh, at, extra = restore(os.path.join(self.dir, "ck"), fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        LAUNCHES.reset()
        again = []
        for i in range(at, len(losses)):
            fresh, met = step(fresh, batches[i])
            again.append(float(met["loss"]))
        torch.cuda.synchronize()
        launches = dict(LAUNCHES.by_kernel)

        def bits(t):
            t = t.detach()
            return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        a, b = dict(_flatten(state)), dict(_flatten(fresh))
        differ = [k for k in a if not torch.equal(bits(a[k]), bits(b[k]))]
        groups = {g: all(k not in differ for k in a if k.startswith(p))
                  for g, p in (("masters", "params/"),
                               ("bf16_copy", "params_c/"),
                               ("moments", "opt/m/"), ("moments_v", "opt/v/"),
                               ("step", "opt/step"))}
        del fresh, a, b
        torch.cuda.empty_cache()
        victim = os.path.join(d, manifest["leaves"][CKPT_VICTIM]["file"])
        with open(victim, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
        raised = None
        try:
            restore(os.path.join(self.dir, "ck"),
                    {"opt": {"m": {"final_g": {
                        "q": torch.empty(state["opt"]["m"]["final_g"]["q"]
                                         .shape, dtype=torch.int8,
                                         device="cuda")}}}})
        except IOError as e:
            raised = str(e)
        losses_equal = again == losses[at:]
        self.line.update(
            bytes_on_disk=total, gb_on_disk=total / 1e9,
            gb_by_part={k: v / 1e9 for k, v in part.items()},
            leaves=len(sizes), snapshot_wait_s=timing["snapshot_s"],
            write_s=timing["write_s"],
            write_gb_s=total / 1e9 / timing["write_s"],
            close_wait_s=close_s, restore_s=restore_s,
            restore_gb_s=total / 1e9 / restore_s, restored_step=at,
            extra=extra, losses=losses[at:], restored_losses=again,
            losses_bitwise=losses_equal, bitwise=groups,
            leaves_differing=differ[:8], restored_launches=launches,
            corruption_raised=raised)
        if not (losses_equal and not differ and at == self.at):
            failures.append(f"ckpt: the restored run differs: losses "
                            f"{again} against {losses[at:]}, leaves "
                            f"{differ[:8]}")
        for k in ("K4/rmsnorm_bf16", "K6/adamw_f32", "K7/xent_bf16"):
            if not launches.get(k):
                failures.append(f"ckpt: {k} was not launched after the "
                                f"restore")
        if raised is None:
            failures.append(f"ckpt: restore of a corrupted "
                            f"{CKPT_VICTIM} raised no IOError")

    def cleanup(self):
        import shutil
        if self.ck is not None:
            self.ck.close()
        if self.dir is not None:
            shutil.rmtree(self.dir)


def train_phase(args, failures: list, smi_line: str) -> list:
    """Phase ``train``: ``train_run`` at ``TRAIN_DEPTH`` with float32
    moments and the checks, at ``TRAIN_INT8_DEPTH`` with int8 moments,
    and ``train_backward_checks``; returns the kernel records."""
    line, records = train_run(args, TRAIN_DEPTH, TRAIN_STEPS, "float32",
                              failures, smi_line, checks=True)
    emit(line)
    ckpt = ckpt_check(CKPT_AT, smi_line)
    try:
        line, _ = train_run(args, TRAIN_INT8_DEPTH, TRAIN_INT8_STEPS, "int8",
                            failures, smi_line, checks=False, ckpt=ckpt)
    finally:
        ckpt.cleanup()
    emit(line)
    emit(ckpt.line)
    train_backward_checks(args, failures)
    return records


# ---------------------------------------------------------------------------
# phase spmd: sharded training over NCCL ranks
# ---------------------------------------------------------------------------

#: the spmd phase: the int8 train run's configuration, 3 steps, the
#: sharded state saved after step 2
SPMD_STEPS, SPMD_SAVE_AT = 3, 2
#: ... and on 2 or more GPUs DeepSeek-V2-Lite at full width, depth 2,
#: its experts over the ``model`` axis
SPMD_EP_ARCH, SPMD_EP_DEPTH = "deepseek_v2_lite", 2
#: the bounds across 2 or more ranks: each rank rounds its rows'
#: gradients to bfloat16 and the ranks sum them in bfloat16 (as the
#: reference's FSDP reduces on bf16 wires), where one device rounds the
#: whole batch's once; where the rows' gradients cancel, an element's
#: sum keeps little of its relative precision.  Held: losses and
#: gradient norms 1e-3 relative, the masters and the bf16 copy
#: ``BF16_RTOL`` norm-relative; the moments, linear in those gradients
#: element by element, are printed (four H100s: m 0.067, v 0.038)
SPMD_LOSS_RTOL = 1e-3
#: tensor parallelism: the ``model`` axes the spmd phase splits the
#: forward over on 2 or more cards (the data axis takes the other ranks)
SPMD_TP_MPS = {2: (2,), 4: (2, 4)}
#: ... and its bound on the masters and the bf16 copy (losses and
#: gradient norms: ``SPMD_LOSS_RTOL``).  Each rank rounds its partial
#: sum of a row-split matmul (``wo``, ``wd``) and its partial gradient
#: of the gathered stream to bfloat16 before the ranks add them, where
#: one device rounds the whole sum once: on the CPU at the smoke size the
#: first step's gradients lie up to 9.7e-3 from the unsharded step's,
#: leaf by leaf, against 3.3e-3 for FSDP over the same four ranks, and
#: within 4.7e-7 in float32 (``tools/tp_grad_noise.py``); one H100, (1,
#: 2) on two gloo ranks: the masters 2.74e-2 after 3 steps
SPMD_TP_RTOL = 5e-2
#: K7's block entry: the numbers of blocks the (8192, 128256) bfloat16
#: logits are cut into
XENT_BLOCKS = (2, 4, 16)


def _spmd_steps(step, state, batches, lo: int, hi: int, hook=None):
    """Steps ``lo``..``hi - 1`` of ``step``: (state, losses, grad norms,
    ms a step by CUDA events, the host reading the loss as the
    launcher does)."""
    import torch
    losses, norms, ms = [], [], []
    for i in range(lo, hi):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        state, met = step(state, batches[i])
        b.record()
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        ms.append(a.elapsed_time(b))
        if hook is not None:
            hook(i, state)
    torch.cuda.synchronize()
    return state, losses, norms, ms


def _spmd_compare(got: dict, want: dict, bitwise: bool) -> dict:
    """Leaf by leaf (keys of ``want``, host tensors): bitwise, or the
    largest norm-relative error of each part of the state (``params``,
    ``params_c``, ``opt/m``, ``opt/v``; an int8 moment dequantized with
    its block scales)."""
    import torch
    differ, worst, leaf = [], {}, {}
    for k, w in want.items():
        g = got[k]
        if bitwise:
            if not torch.equal(bits(g), bits(w.to(g.device))):
                differ.append(k)
            continue
        if k.endswith("/scale") or k == "opt/step":
            continue
        w = w.to(g.device)
        if k.endswith("/q"):
            def deq(q, sc):
                return (q.float().reshape(*q.shape[:-1], -1, 128)
                        * sc[..., None].float())
            g = deq(g, got[k[:-2] + "/scale"])
            w = deq(w, want[k[:-2] + "/scale"].to(g.device))
        part = "/".join(k.split("/")[:2 if k.startswith("opt/") else 1])
        err = tensor_err(g.float(), w.float())[0]
        if err >= worst.get(part, 0.0):
            worst[part], leaf[part] = err, k
    return {"bitwise": bitwise, "differ": differ,
            "max_norm_rel_err": max(worst.values(), default=0.0),
            "max_norm_rel_err_by_part": worst, "worst_leaf_by_part": leaf}


def spmd_rank(rank: int, world: int, seed: int, ckdir: str) -> dict:
    """One NCCL rank of phase ``spmd`` (``spmd_phase``): rank 0 first
    runs the unsharded steps (``launch.train``'s path) and keeps their
    state on the host; then every rank runs the same steps sharded
    (``make_host_mesh(1)``, FSDP2, the counts set to 0 just before and
    read just after), the state saved after step 2 through
    ``AsyncCheckpointer(shardings=)``; on 2 or more ranks DeepSeek's
    experts over ``model`` too.  Then the group ends, and rank 0
    restores the saved state into a single-device state, with no
    process group, and trains step 3 from it."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import AsyncCheckpointer, restore
    from repro_torch.ckpt.checkpoint import _flatten, _leaves
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import LAUNCHES
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_state
    from repro_torch.optim import AdamWHyper
    from repro_torch.train import steps as steps_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, reduced = lm_config(get_config(TRAIN_ARCH), TRAIN_INT8_DEPTH)
    cfg = dataclasses.replace(cfg, opt_moment_dtype="int8")
    hyper = AdamWHyper(lr=TRAIN_LR, warmup_steps=max(1, SPMD_STEPS // 20),
                       total_steps=SPMD_STEPS)
    get = make_batch_fn(cfg, ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    batches = [shard_batch(get(i), "cuda") for i in range(SPMD_STEPS)]
    out = {"world": world, "reduced": reduced, "n_layers": cfg.n_layers}
    t0 = time.perf_counter()
    host = None
    if rank == 0:           # the unsharded run, kept on the host
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state = build_state(cfg, seed, "cuda")
        step = steps_lib.make_train_step(cfg, hyper)
        state, losses, norms, ms = _spmd_steps(step, state, batches, 0,
                                               SPMD_STEPS)
        host = {k: t.detach().cpu() for k, t in _flatten(state)}
        out["unsharded"] = {"losses": losses, "grad_norms": norms,
                            "step_ms": ms, "peak_bytes":
                            torch.cuda.max_memory_allocated() - base}
        del state, step
        torch.cuda.empty_cache()
    dist.barrier()
    out["unsharded_s"] = time.perf_counter() - t0

    # the same steps sharded
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = build_state(cfg, seed, "cuda")
    state, sh = steps_lib.shard_train_state(cfg, state, make_host_mesh(1))
    step = steps_lib.make_train_step(cfg, hyper, shardings=sh)
    writer = AsyncCheckpointer(ckdir, shardings=sh)

    def save_at(i, st):
        if i + 1 == SPMD_SAVE_AT:
            writer.save(SPMD_SAVE_AT, st, {"arch": cfg.name})
    LAUNCHES.reset()
    state, losses, norms, ms = _spmd_steps(step, state, batches, 0,
                                           SPMD_STEPS, save_at)
    launches = dict(LAUNCHES.by_kernel)
    sp = sh.spmd
    out["sharded"] = {
        "mesh": sp.describe(), "losses": losses, "grad_norms": norms,
        "step_ms": ms, "peak_bytes": torch.cuda.max_memory_allocated()
        - base, "launches": launches}
    out["sharded"].update(_fsdp_bytes(state, sh))
    # the kernels' shapes on this path (this rank's rows and leaves)
    blocks = sp.dpn if TRAIN_BATCH % sp.dpn == 0 else 1
    rows = TRAIN_BATCH * TRAIN_SEQ // blocks
    big = max(state["params"], key=lambda n: state["params"][n].numel())
    out["shapes"] = {"K4": [rows, cfg.d_model], "K7": [rows, cfg.vocab],
                     "K6": [state["params"][big].numel(), big]}
    full = {k: v for k, v in _leaves(state, sh)}
    if rank == 0:
        out["sharded_vs_unsharded"] = _spmd_compare(full, host, world == 1)
        out["sharded_vs_unsharded"]["losses_equal"] = \
            losses == out["unsharded"]["losses"]
        out["sharded_vs_unsharded"]["grad_norms_equal"] = \
            norms == out["unsharded"]["grad_norms"]
    writer.close()          # the compare above ran while it wrote
    if rank == 0:
        out["sharded"]["write_s"] = writer.timings[SPMD_SAVE_AT]["write_s"]
    del full, state, step, writer
    torch.cuda.empty_cache()
    out["sharded_s"] = time.perf_counter() - t0
    if world > 1:
        out["ep"] = _spmd_ep(rank, world, seed)
    dist.barrier()
    dist.destroy_process_group()

    if rank == 0:           # restore with no process group, step 3
        t0 = time.perf_counter()
        fresh = build_state(cfg, seed + 1, "cuda")
        fresh, at, _ = restore(ckdir, fresh, step=SPMD_SAVE_AT)
        restore_s = time.perf_counter() - t0
        fresh, losses3, _, _ = _spmd_steps(
            steps_lib.make_train_step(cfg, hyper), fresh, batches,
            SPMD_SAVE_AT, SPMD_STEPS)
        got = dict(_flatten(fresh))
        out["restored"] = _spmd_compare(got, host, world == 1) | {
            "at": at, "restore_s": restore_s, "losses": losses3,
            "loss_equal": losses3 == losses[SPMD_SAVE_AT:]}
    return out


def _tp_run(cfg, hyper, seed: int, batches, mp: int, device_type,
            host) -> dict:
    """``SPMD_STEPS`` sharded steps of ``cfg`` over ``make_host_mesh(mp,
    device_type)``, the forward split over ``model``, the counts set to 0
    just before and read just after: the run's line (losses, gradient
    norms, ms a step, peak, launches, this rank's pieces' largest leaf)
    and, on rank 0, the gathered state held to ``host``, the unsharded
    run's (``_spmd_compare``)."""
    import torch

    from repro_torch.ckpt.checkpoint import _leaves
    from repro_torch.core import LAUNCHES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_state
    from repro_torch.train import steps as steps_lib

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = build_state(cfg, seed, "cuda")
    state, sh = steps_lib.shard_train_state(
        cfg, state, make_host_mesh(mp, device_type))
    step = steps_lib.make_train_step(cfg, hyper, shardings=sh)
    LAUNCHES.reset()
    state, losses, norms, ms = _spmd_steps(step, state, batches, 0,
                                           SPMD_STEPS)
    launches = dict(LAUNCHES.by_kernel)
    sp, tp = sh.spmd, sh.tp
    big = max(state["params"], key=lambda n: state["params"][n].numel())
    run = {"mesh": sp.describe(), "losses": losses, "grad_norms": norms,
           "step_ms": ms, "peak_bytes": torch.cuda.max_memory_allocated()
           - base, "launches": launches,
           "largest_piece": [state["params"][big].numel(), big],
           "tensor_parallel": [tp.n, tp.rank]}
    full = {k: v for k, v in _leaves(state, sh)}
    if host is not None:
        routed = {k for k in host if cfg.n_experts and ROUTED.search(k)}
        run["vs_unsharded"] = _spmd_compare(
            full, {k: v for k, v in host.items() if k not in routed}, False)
        if routed:
            run["routed_vs_unsharded"] = _spmd_compare(
                full, {k: host[k] for k in routed}, False)
    del full, state, step
    torch.cuda.empty_cache()
    return run


def _unsharded(cfg, hyper, seed: int, batches) -> tuple:
    """``SPMD_STEPS`` unsharded steps of ``cfg``: (their line, the state
    on the host by checkpoint key)."""
    import torch

    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.launch.train import build_state
    from repro_torch.train import steps as steps_lib
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = build_state(cfg, seed, "cuda")
    state, losses, norms, ms = _spmd_steps(
        steps_lib.make_train_step(cfg, hyper), state, batches, 0,
        SPMD_STEPS)
    host = {k: t.detach().cpu() for k, t in _flatten(state)}
    line = {"losses": losses, "grad_norms": norms, "step_ms": ms,
            "peak_bytes": torch.cuda.max_memory_allocated() - base}
    del state
    torch.cuda.empty_cache()
    return line, host


def spmd_tp_rank(rank: int, world: int, seed: int, mps, device_type) -> dict:
    """One rank of phase ``spmd``'s tensor-parallel runs: rank 0 first
    runs the steps of ``spmd_rank``'s configuration unsharded and keeps
    the state on the host; then for each ``model`` axis of ``mps`` every
    rank runs them sharded (``_tp_run``)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.optim import AdamWHyper

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _ = lm_config(get_config(TRAIN_ARCH), TRAIN_INT8_DEPTH)
    cfg = dataclasses.replace(cfg, opt_moment_dtype="int8")
    hyper = AdamWHyper(lr=TRAIN_LR, warmup_steps=max(1, SPMD_STEPS // 20),
                       total_steps=SPMD_STEPS)
    get = make_batch_fn(cfg, ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    batches = [shard_batch(get(i), "cuda") for i in range(SPMD_STEPS)]
    out = {"backend": dist.get_backend(), "world": world, "runs": []}
    host = None
    if rank == 0:
        out["unsharded"], host = _unsharded(cfg, hyper, seed, batches)
    dist.barrier()
    for mp in mps:
        run = _tp_run(cfg, hyper, seed, batches, mp, device_type, host)
        lo, hi = _vocab_block(cfg.vocab, mp, run["tensor_parallel"][1])
        rows = TRAIN_BATCH * TRAIN_SEQ // (world // mp)
        run["shapes"] = {"K7_block": [rows, hi - lo],
                         "K4": [rows // mp, cfg.d_model]}
        out["runs"].append(run)
        dist.barrier()
    return out


def _vocab_block(vocab: int, n: int, rank: int) -> tuple:
    """A tensor-parallel rank's ``[lo, hi)`` of the vocabulary."""
    from repro_torch.dist.spmd import TensorParallel
    return TensorParallel(None, n, rank).block(vocab)


#: phase ``spmd``'s MoE tensor-parallel runs, ``moe_impl="gspmd"``:
#: DeepSeek-V2-Lite at full width, depth 2 (its dense first layer and
#: one MoE layer) in bfloat16, its 64 experts over ``model`` (expert
#: parallelism); DeepSeek's smoke shapes in float32, B 8 x 64, with its
#: 4 experts (expert parallelism) and with ``SPMD_TP_MOE_F_EXPERTS``,
#: which 2 ranks do not divide (the F-split: each rank its block of
#: every expert's hidden columns); and on four or more cards Grok-1 at
#: full width, depth 1, over (1, 4)
SPMD_TP_MOE_F_EXPERTS, SPMD_TP_MOE_SMOKE_SEQ = 3, 64
SPMD_TP_MOE_GROK_DEPTH = 1
#: ... their bounds against the unsharded steps: the bfloat16 run's
#: losses ``SPMD_LOSS_RTOL``, gradient norms ``SPMD_TP_MOE_GNORM_RTOL``,
#: masters and copy ``SPMD_TP_RTOL`` but the routed leaves'
#: (``ROUTED``: the routers and the routed experts),
#: ``SPMD_TP_ROUTED_RTOL``.  A token whose top-k choice flips between
#: the two runs (bfloat16 streams that differ in their last bits) moves
#: the router's gradient and two experts' by its whole contribution:
#: AdamW's normalised step turns that into a change the size of the
#: step, and the next step's gradient norm moves with it.  The one-card
#: run's own gradient norm moves by up to 2.5e-4 between runs of one
#: seed (the backward's scatter-adds are not deterministic).  Five runs
#: on H100s, (1, 2) on gloo and (1, 4) on NCCL: losses within 1.65e-4,
#: gradient norms 1.09e-3, routed leaves 6.38e-2, the rest 2.74e-2.
#: The float32 runs hold the split itself: losses and gradient norms
#: ``MEAN_RTOL``, every master ``F32_TP_RTOL`` (the CPU tests' bound;
#: measured up to 7.2e-5)
SPMD_TP_MOE_GNORM_RTOL = 5e-3
SPMD_TP_ROUTED_RTOL = 1e-1
F32_TP_RTOL = 1e-4
#: the routed leaves of a MoE state, by checkpoint key
ROUTED = re.compile(r"(^|/)layers\.\d+\.(router|wg|wu|wd)(/|$)")


def spmd_tp_moe_rank(rank: int, world: int, seed: int, mp: int,
                     device_type, impl: str) -> dict:
    """One rank of phase ``spmd``'s MoE tensor-parallel runs
    (``SPMD_TP_MOE_*``, under ``moe_impl=impl``): for each configuration
    rank 0 first runs its steps unsharded and keeps the state on the
    host (but Grok-1's, which one card does not hold), then every rank
    runs them sharded over (1, ``mp``) (``_tp_run``)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config, smoke_config
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.optim import AdamWHyper

    torch.backends.cuda.matmul.allow_tf32 = False
    hyper = AdamWHyper(lr=TRAIN_LR, warmup_steps=1, total_steps=SPMD_STEPS)
    deepseek, reduced = lm_config(get_config(SPMD_EP_ARCH), SPMD_EP_DEPTH)
    smoke = dataclasses.replace(smoke_config(SPMD_EP_ARCH),
                                compute_dtype="float32", fsdp_only=False)
    runs = [("deepseek_v2_lite", deepseek, reduced, TRAIN_SEQ, True),
            ("deepseek_v2_lite_smoke_f32", smoke, None,
             SPMD_TP_MOE_SMOKE_SEQ, True),
            ("deepseek_v2_lite_smoke_f32_fsplit", dataclasses.replace(
                smoke, n_experts=SPMD_TP_MOE_F_EXPERTS), None,
             SPMD_TP_MOE_SMOKE_SEQ, True)]
    if mp >= 4:
        grok, greduced = lm_config(get_config("grok1_314b"),
                                   SPMD_TP_MOE_GROK_DEPTH)
        runs.append(("grok1_314b", grok, greduced, TRAIN_SEQ, False))
    out = {"backend": dist.get_backend(), "world": world, "runs": []}
    for name, cfg, cut, seq, unsharded in runs:
        cfg = dataclasses.replace(cfg, moe_impl=impl)
        get = make_batch_fn(cfg, ShapeConfig("chip", seq, TRAIN_BATCH,
                                             "train"))
        batches = [shard_batch(get(i), "cuda") for i in range(SPMD_STEPS)]
        line, host = None, None
        if rank == 0 and unsharded:
            line, host = _unsharded(cfg, hyper, seed, batches)
        dist.barrier()
        t0 = time.perf_counter()
        run = _tp_run(cfg, hyper, seed, batches, mp, device_type, host)
        run.update({"arch": name, "reduced": cut, "n_layers": cfg.n_layers,
                    "n_experts": cfg.n_experts, "seq": seq,
                    "compute_dtype": cfg.compute_dtype,
                    "expert_split": "E" if cfg.n_experts % mp == 0
                    else "F", "unsharded": line,
                    "seconds": time.perf_counter() - t0})
        lo, hi = _vocab_block(cfg.vocab, mp, run["tensor_parallel"][1])
        rows = TRAIN_BATCH * seq
        run["shapes"] = {"K7_block": [rows, hi - lo],
                         "K4": [rows // mp, cfg.d_model]}
        out["runs"].append(run)
        del host, batches
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def _fsdp_bytes(state, sh) -> dict:
    """The bytes FSDP2's collectives carry a step on this rank, counted
    from its units: the root's parameters gathered once (kept from the
    forward to the backward), each layer's twice (forward, and again
    for the backward: resharded after the forward), every gradient
    reduce-scattered once; the share that crosses between ranks is
    (n - 1) / n of each, n the data-parallel ranks."""
    model = state["params_c"]

    def full_bytes(mods):
        n = 0
        for m in mods:
            for p in m.parameters(recurse=m is not model):
                if hasattr(p, "to_local"):
                    n += p.numel() * p.element_size()
        return n
    root = full_bytes([model])
    layers = full_bytes([lp for s in (model.head_layers, model.layers,
                                      model.enc_layers) for lp in s])
    n = sh.spmd.dpn
    gathered, scattered = root + 2 * layers, root + layers
    return {"all_gather_bytes_per_step": gathered,
            "reduce_scatter_bytes_per_step": scattered,
            "bytes_between_ranks_per_step": (gathered + scattered)
            * (n - 1) // n, "data_parallel_ranks": n}


def _spmd_ep(rank: int, world: int, seed: int) -> dict:
    """DeepSeek-V2-Lite at full width, depth 2, ``moe_impl="shard_map"``
    on a (1, world) mesh: 3 sharded steps; rank 0 then runs the same
    steps unsharded (``moe_layer``) and holds the losses to bfloat16's
    bound (the expert matmuls run at other batch shapes)."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core import LAUNCHES
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_state
    from repro_torch.optim import AdamWHyper
    from repro_torch.train import steps as steps_lib

    cfg, reduced = lm_config(get_config(SPMD_EP_ARCH), SPMD_EP_DEPTH)
    cfg = dataclasses.replace(cfg, moe_impl="shard_map")
    hyper = AdamWHyper(lr=TRAIN_LR, warmup_steps=1, total_steps=SPMD_STEPS)
    get = make_batch_fn(cfg, ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    batches = [shard_batch(get(i), "cuda") for i in range(SPMD_STEPS)]
    state = build_state(cfg, seed, "cuda")
    state, sh = steps_lib.shard_train_state(cfg, state,
                                            make_host_mesh(world))
    LAUNCHES.reset()
    state, losses, norms, ms = _spmd_steps(
        steps_lib.make_train_step(cfg, hyper, shardings=sh), state,
        batches, 0, SPMD_STEPS)
    out = {"arch": SPMD_EP_ARCH, "reduced": reduced,
           "mesh": sh.spmd.describe(), "losses": losses,
           "grad_norms": norms, "step_ms": ms,
           "launches": dict(LAUNCHES.by_kernel)}
    del state
    torch.cuda.empty_cache()
    if rank == 0:
        one = build_state(dataclasses.replace(cfg, moe_impl="gspmd"), seed,
                          "cuda")
        _, want, _, _ = _spmd_steps(steps_lib.make_train_step(cfg, hyper),
                                    one, batches, 0, SPMD_STEPS)
        out["unsharded_losses"] = want
        out["max_loss_rel_err"] = max(abs(a - b) / abs(b)
                                      for a, b in zip(losses, want))
        del one
        torch.cuda.empty_cache()
    return out


def spmd_phase(args, failures: list, smi_line: str) -> list:
    """Phase ``spmd``: ``spmd_rank`` on ``torch.cuda.device_count()`` NCCL
    ranks (``dist.spmd.run_ranks``, a ``FileStore`` and the checkpoint
    in a temporary directory, removed after); at world 1 the sharded
    steps, the restored step 3 and their losses must be bitwise the
    unsharded run's, on more ranks within ``SPMD_LOSS_RTOL`` and
    ``BF16_RTOL``.  Then K4, K6
    and K7 at this path's shapes against their plain versions, timed
    beside their bounds, plain versions and library calls; returns their
    records (``"path": "spmd"``)."""
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F

    from repro_torch.core.timing import device_ms, graph_ms, time_ms
    from repro_torch.dist.spmd import run_ranks
    from repro_torch.kernels import adamw as k6
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as k4
    from repro_torch.kernels import softmax_xent as k7

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    here = {"allocated_bytes": torch.cuda.memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved()}
    d = tempfile.mkdtemp(prefix="spmd_")
    try:
        res = run_ranks(spmd_rank, world, args.seed, os.path.join(d, "ck"),
                        backend="nccl", timeout_s=600, tmpdir=d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    r0 = res[0]
    sh = r0["sharded"]
    line = {"phase": "spmd", "nvidia_smi": smi_line, "world": world,
            "arch": TRAIN_ARCH, "reduced": r0["reduced"],
            "n_layers": r0["n_layers"], "opt_moment_dtype": "int8",
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": SPMD_STEPS,
            "saved_at": SPMD_SAVE_AT, "unsharded": r0["unsharded"],
            "sharded": sh,
            "sharded_vs_unsharded": r0["sharded_vs_unsharded"],
            "restored": r0["restored"],
            "step_ms_sharded": sh["step_ms"],
            "step_ms_unsharded": r0["unsharded"]["step_ms"],
            "peak_gb_per_rank": [r["sharded"]["peak_bytes"] / 1e9
                                 for r in res],
            "spawning_process": here,
            "seconds": {"unsharded": r0["unsharded_s"],
                        "sharded": r0["sharded_s"],
                        "phase": time.perf_counter() - t0}}
    if world > 1:
        line["ep"] = [r["ep"] for r in res]
    else:
        line["ep"] = ("expert parallelism ran only in the CPU tests "
                      "(tests/test_torch_moe_ep.py, test_torch_spmd.py): "
                      "NCCL puts one rank on a GPU, and this machine has "
                      "one")
    cmp_, rest = r0["sharded_vs_unsharded"], r0["restored"]
    if world == 1:
        ok = (not cmp_["differ"] and cmp_["losses_equal"]
              and cmp_["grad_norms_equal"] and not rest["differ"]
              and rest["loss_equal"])
    else:
        un = r0["unsharded"]

        def held(c):
            return max(v for k, v in c["max_norm_rel_err_by_part"].items()
                       if not k.startswith("opt/"))
        ok = (held(cmp_) <= BF16_RTOL and held(rest) <= BF16_RTOL and all(
            abs(a - b) <= SPMD_LOSS_RTOL * abs(b) for a, b in zip(
                sh["losses"] + sh["grad_norms"],
                un["losses"] + un["grad_norms"])))
        for ep in line["ep"]:
            if not all(map(math.isfinite, ep["losses"])) or \
                    ep.get("max_loss_rel_err", 0.0) > BF16_RTOL:
                failures.append(f"spmd ep: {ep}")
    if not ok:
        failures.append(f"spmd: sharded {cmp_}, restored {rest}")
    launches = sh["launches"]
    for k in ("K4/rmsnorm_bf16", "K6/adamw_f32", "K7/xent_bf16"):
        if not launches.get(k):
            failures.append(f"spmd: {k} was not launched in the sharded "
                            f"steps: {launches}")
    emit(line)
    tp_launches, tp_shapes = spmd_tp_runs(args, world, failures, smi_line)
    moe_launches, moe_shapes, moe_piece = spmd_tp_moe_runs(
        args, world, failures, smi_line)

    # K4, K6 and K7 at the sharded path's shapes
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    records = []

    def record(kernel, what, shape, wrapper, plain, lib, bound, err,
               counted=launches):
        ms, how = graph_ms(wrapper)
        rec = {"name": f"{kernel} (spmd, {what})", "route": "cuda",
               "source": HAND[kernel][0], "replaces": HAND[kernel][1],
               "launches": counted.get(kernel, 0), "max_abs_err": err,
               "ms": ms, "plain_ms": time_ms(plain, max_reps=3),
               "bound_ms": bound[0], "bound_by": bound[1],
               "library_ms": None if lib is None else lib()}
        emit({"phase": "time", "path": "spmd", **rec, "timed_by": how,
              "shape": shape, "bound_share": bound[0] / ms})
        records.append(rec)

    T, D = r0["shapes"]["K4"]
    x, g = randn(T, D, dtype=torch.bfloat16), 1 + randn(D, scale=0.1)
    rel4, mabs = tensor_err(k4.rmsnorm(x, g), ref.rmsnorm(x, g))
    rms_norm = getattr(F, "rms_norm", None)
    g_lib = g.to(x.dtype)
    record("K4/rmsnorm_bf16", "every RMSNorm, this rank's rows", [T, D],
           lambda: k4.rmsnorm(x, g), lambda: ref.rmsnorm(x, g),
           None if rms_norm is None else
           lambda: graph_ms(lambda: rms_norm(x, (D,), g_lib, eps=1e-6))[0],
           hand_bound("K4/rmsnorm_bf16", (T, D)), mabs)
    del x, g, g_lib
    T, V = r0["shapes"]["K7"]
    logits = randn(T, V, dtype=torch.bfloat16, scale=2.0)
    labels = torch.randint(0, V, (T,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[TRAIN_SEQ - 1::TRAIN_SEQ] = -1
    rel7, mabs = tensor_err(k7.softmax_xent_rows(logits, labels),
                            ref.softmax_xent_rows(logits, labels))
    lab64 = labels.long()
    record("K7/xent_bf16", "lm_loss, this rank's rows", [T, V],
           lambda: k7.softmax_xent_rows(logits, labels),
           lambda: ref.softmax_xent_rows(logits, labels),
           lambda: graph_ms(lambda: F.cross_entropy(
               logits, lab64, ignore_index=-1, reduction="none"))[0],
           k7_bound(T, V, "bfloat16", label_bytes=4), mabs)
    del logits, labels, lab64
    worst7b = xent_block_checks(args, randn, gen, record, tp_launches,
                                tp_shapes["K7_block"], failures)
    n, leaf = r0["shapes"]["K6"]
    p, gr = randn(n), randn(n, scale=1e-3)
    m, v = randn(n, scale=1e-3), randn(n, scale=1e-3).abs_().square_()
    h = k6.hyper(lr=TRAIN_LR, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.1, step=SPMD_STEPS, device=p.device)
    want = ref.adamw(p, gr, m, v, lr=TRAIN_LR, beta1=0.9, beta2=0.95,
                     eps=1e-8, weight_decay=0.1, step=SPMD_STEPS)
    errs = [tensor_err(a, b) for a, b in zip(k6.adamw(p, gr, m, v, h),
                                               want)]
    lib = fused_adamw_step(p, gr, m, v, SPMD_STEPS)
    record("K6/adamw_f32", f"this rank's piece of {leaf}", [n],
           lambda: k6.adamw(p, gr, m, v, h),
           lambda: ref.adamw(p, gr, m, v, lr=TRAIN_LR, beta1=0.9,
                             beta2=0.95, eps=1e-8, weight_decay=0.1,
                             step=SPMD_STEPS),
           lambda: device_ms(lib), k6_bound(n, "float32"),
           max(e[1] for e in errs))
    del p, gr, m, v, want, lib
    torch.cuda.empty_cache()
    worst_moe = moe_tp_records(randn, gen, record, moe_launches, moe_shapes,
                               moe_piece)
    worst = {"K4": rel4, "K7": rel7, "K6": max(e[0] for e in errs),
             "K7_block": worst7b, "moe_tp": worst_moe}
    emit({"phase": "spmd_kernel", "norm_rel_err": worst})
    if not (rel4 <= BF16_KERNEL_RTOL and rel7 <= BF16_KERNEL_RTOL
            and worst["K6"] <= K6_TRAIN_RTOL
            and worst_moe["K4"] <= BF16_KERNEL_RTOL
            and worst_moe["K7_block"] <= MEAN_RTOL
            and worst_moe["K6"] <= K6_TRAIN_RTOL):
        failures.append(f"spmd kernels against their plain versions: "
                        f"{worst}")
    return records


def spmd_tp_runs(args, world: int, failures: list, smi_line: str):
    """Phase ``spmd``'s tensor-parallel runs (``spmd_tp_rank``): on 2 or
    more cards NCCL ranks, one a card, over the ``model`` axes of
    ``SPMD_TP_MPS``; on one card two gloo ranks that share it, over (1,
    2).  One ``"spmd_tp"`` line a run, held to the unsharded run
    (``SPMD_LOSS_RTOL``, ``SPMD_TP_RTOL``);
    returns the launches and the kernels' shapes of the (1, 2) or (2,
    2) run (the first)."""
    import shutil
    import tempfile

    from repro_torch.dist.spmd import run_ranks

    t0 = time.perf_counter()
    if world >= 2:
        nproc, backend, device_type = world, "nccl", None
        mps = SPMD_TP_MPS[4 if world >= 4 else 2]
    else:
        nproc, backend, device_type, mps = 2, "gloo", "cuda", (2,)
    d = tempfile.mkdtemp(prefix="spmd_tp_")
    try:
        res = run_ranks(spmd_tp_rank, nproc, args.seed, mps, device_type,
                        backend=backend, timeout_s=900, tmpdir=d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    r0, un = res[0], res[0]["unsharded"]
    for i, run in enumerate(r0["runs"]):
        cmp_ = run["vs_unsharded"]
        held = max(v for k, v in cmp_["max_norm_rel_err_by_part"].items()
                   if not k.startswith("opt/"))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(
            run["losses"] + run["grad_norms"],
            un["losses"] + un["grad_norms"]))
        line = {"phase": "spmd_tp", "nvidia_smi": smi_line,
                "arch": TRAIN_ARCH, "n_layers": TRAIN_INT8_DEPTH,
                "opt_moment_dtype": "int8", "batch": TRAIN_BATCH,
                "seq": TRAIN_SEQ, "steps": SPMD_STEPS, "backend": backend,
                "ranks": nproc, "cards": world, "mesh": run["mesh"],
                "losses": run["losses"], "grad_norms": run["grad_norms"],
                "unsharded": un, "max_loss_grad_norm_rel_err": loss_err,
                "vs_unsharded": cmp_, "step_ms": run["step_ms"],
                "peak_gb_per_rank": [r["runs"][i]["peak_bytes"] / 1e9
                                     for r in res],
                "launches": run["launches"], "shapes": run["shapes"],
                "seconds": time.perf_counter() - t0}
        if backend == "gloo":
            line["note"] = ("two ranks share the one card over gloo, which "
                            "stages CUDA tensors through the host: the "
                            "step time is not NCCL's")
        emit(line)
        if not (loss_err <= SPMD_LOSS_RTOL and held <= SPMD_TP_RTOL):
            failures.append(f"spmd_tp {run['mesh']}: losses and gradient "
                            f"norms {loss_err}, state {cmp_}")
        for k in ("K4/rmsnorm_bf16", "K6/adamw_f32", "K7/xent_block_bf16"):
            if not run["launches"].get(k):
                failures.append(f"spmd_tp {run['mesh']}: {k} was not "
                                f"launched: {run['launches']}")
    first = r0["runs"][0]
    return first["launches"], first["shapes"]


def spmd_tp_moe_runs(args, world: int, failures: list, smi_line: str,
                     impl: str = "gspmd"):
    """Phase ``spmd``'s MoE tensor-parallel runs (``spmd_tp_moe_rank``):
    on one card two gloo ranks that share it over (1, 2), on more cards
    NCCL ranks over (1, world).  One ``"spmd_tp_moe"`` line a run, held
    to its unsharded run (``SPMD_TP_ROUTED_RTOL`` says how; Grok-1,
    which one card does not hold, to finite losses); a line saying why
    Grok-1 did not run on fewer than four cards.  ``impl``: the
    ``moe_impl`` of every run (the phase runs the reference's default;
    ``"shard_map"`` times ``dist.moe_ep``'s all-to-all beside it).
    Returns DeepSeek's launches, its kernels' shapes and its largest
    piece."""
    import shutil
    import tempfile

    from repro_torch.dist.spmd import run_ranks

    t0 = time.perf_counter()
    if world >= 2:
        nproc, backend, device_type = world, "nccl", None
    else:
        nproc, backend, device_type = 2, "gloo", "cuda"
    d = tempfile.mkdtemp(prefix="spmd_tp_moe_")
    try:
        res = run_ranks(spmd_tp_moe_rank, nproc, args.seed, nproc,
                        device_type, impl, backend=backend, timeout_s=900,
                        tmpdir=d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    r0 = res[0]
    for i, run in enumerate(r0["runs"]):
        line = {"phase": "spmd_tp_moe", "nvidia_smi": smi_line,
                **{k: v for k, v in run.items()
                   if k not in ("tensor_parallel",)},
                "moe_impl": impl, "batch": TRAIN_BATCH,
                "steps": SPMD_STEPS, "backend": backend, "ranks": nproc,
                "cards": world,
                "peak_gb_per_rank": [r["runs"][i]["peak_bytes"] / 1e9
                                     for r in res],
                "phase_seconds": time.perf_counter() - t0}
        un = run["unsharded"]
        ok = all(map(math.isfinite, run["losses"] + run["grad_norms"]))
        if un is not None:
            f32 = run["compute_dtype"] == "float32"
            bounds = dict(zip(
                ("losses", "grad_norms", "held", "routed"),
                (MEAN_RTOL, MEAN_RTOL, F32_TP_RTOL, F32_TP_RTOL) if f32 else
                (SPMD_LOSS_RTOL, SPMD_TP_MOE_GNORM_RTOL, SPMD_TP_RTOL,
                 SPMD_TP_ROUTED_RTOL)))

            def held(c):
                return max(v for k, v in c["max_norm_rel_err_by_part"].items()
                           if not k.startswith("opt/"))
            errs = {k: max(abs(a - b) / abs(b) for a, b in zip(run[k], un[k]))
                    for k in ("losses", "grad_norms")}
            errs["held"] = held(run["vs_unsharded"])
            errs["routed"] = held(run["routed_vs_unsharded"])
            line["max_rel_err"], line["bounds"] = errs, bounds
            ok = ok and all(errs[k] <= bounds[k] for k in bounds)
        if backend == "gloo":
            line["note"] = ("two ranks share the one card over gloo, which "
                            "stages CUDA tensors through the host: the "
                            "step time is not NCCL's")
        emit(line)
        if not ok:
            failures.append(f"spmd_tp_moe {run['arch']} {run['mesh']}: "
                            f"{line}")
        dt = "f32" if run["compute_dtype"] == "float32" else "bf16"
        for k in (f"K4/rmsnorm_{dt}", "K6/adamw_f32", f"K7/xent_block_{dt}"):
            if not run["launches"].get(k):
                failures.append(f"spmd_tp_moe {run['arch']}: {k} was not "
                                f"launched: {run['launches']}")
    if nproc < 4:
        emit({"phase": "spmd_tp_moe", "arch": "grok1_314b",
              "skipped": f"{world} card(s): Grok-1 at full width, depth "
              f"{SPMD_TP_MOE_GROK_DEPTH}, holds ~5.8e9 parameters; one card "
              f"would need ~70 GB for its masters, copy, int8 moments and "
              f"gradients, plus whole-weight gathers; it runs over (1, 4) "
              f"on four or more cards"})
    first = r0["runs"][0]
    return first["launches"], first["shapes"], first["largest_piece"]


def moe_tp_records(randn, gen, record, launches, shapes, piece) -> dict:
    """K4, K7's block entry and K6 at the shapes of the MoE
    tensor-parallel run (``spmd_tp_moe_runs``: DeepSeek-V2-Lite over (1,
    2) or (1, world)), each against its plain version and timed beside
    its bound, plain version and library call (``record``, counted from
    that run's ``launches``); returns their norm-relative errors."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import adamw as k6
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as k4
    from repro_torch.kernels import softmax_xent as k7

    from repro_torch.core.timing import device_ms, graph_ms
    T, D = shapes["K4"]
    x, g = randn(T, D, dtype=torch.bfloat16), 1 + randn(D, scale=0.1)
    rel4, mabs = tensor_err(k4.rmsnorm(x, g), ref.rmsnorm(x, g))
    rms_norm = getattr(F, "rms_norm", None)
    g_lib = g.to(x.dtype)
    record("K4/rmsnorm_bf16", "MoE TP, every RMSNorm on this rank's "
           "sequence block", [T, D], lambda: k4.rmsnorm(x, g),
           lambda: ref.rmsnorm(x, g),
           None if rms_norm is None else
           lambda: graph_ms(lambda: rms_norm(x, (D,), g_lib, eps=1e-6))[0],
           hand_bound("K4/rmsnorm_bf16", (T, D)), mabs, counted=launches)
    del x, g, g_lib
    rows, Vb = shapes["K7_block"]
    blk = randn(rows, Vb, dtype=torch.bfloat16, scale=2.0)
    lab = torch.randint(0, Vb, (rows,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lab[TRAIN_SEQ - 1::TRAIN_SEQ] = -1
    got = k7.softmax_xent_block(blk, lab, 0)
    want = ref.softmax_xent_block(blk, lab, 0)
    rel7 = max(tensor_err(a, b)[0] for a, b in zip(got, want))
    record("K7/xent_block_bf16", "MoE TP, lm_loss over a vocabulary split, "
           "one rank's block", [rows, Vb],
           lambda: k7.softmax_xent_block(blk, lab, 0),
           lambda: ref.softmax_xent_block(blk, lab, 0), None,
           k7_block_bound(rows, Vb, "bfloat16"),
           max(tensor_err(a, b)[1] for a, b in zip(got, want)),
           counted=launches)
    del blk, lab, got, want
    n, leaf = piece
    p, gr = randn(n), randn(n, scale=1e-3)
    m, v = randn(n, scale=1e-3), randn(n, scale=1e-3).abs_().square_()
    h = k6.hyper(lr=TRAIN_LR, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.1, step=SPMD_STEPS, device=p.device)
    want = ref.adamw(p, gr, m, v, lr=TRAIN_LR, beta1=0.9, beta2=0.95,
                     eps=1e-8, weight_decay=0.1, step=SPMD_STEPS)
    errs = [tensor_err(a, b) for a, b in zip(k6.adamw(p, gr, m, v, h),
                                               want)]
    lib = fused_adamw_step(p, gr, m, v, SPMD_STEPS)
    record("K6/adamw_f32", f"MoE TP, this rank's piece of {leaf}", [n],
           lambda: k6.adamw(p, gr, m, v, h),
           lambda: ref.adamw(p, gr, m, v, lr=TRAIN_LR, beta1=0.9,
                             beta2=0.95, eps=1e-8, weight_decay=0.1,
                             step=SPMD_STEPS),
           lambda: device_ms(lib), k6_bound(n, "float32"),
           max(e[1] for e in errs), counted=launches)
    del p, gr, m, v, want, lib
    torch.cuda.empty_cache()
    return {"K4": rel4, "K7_block": rel7, "K6": max(e[0] for e in errs)}


def xent_block_checks(args, randn, gen, record, launches, shape,
                      failures: list) -> float:
    """K7's block entry at ``XENT`` (8192, 128256) bfloat16, the logits
    cut into ``XENT_BLOCKS`` blocks of columns (as ``torch.tensor_split``
    cuts them, each read in place as a slice): each block's triple
    against its plain version, the triples combined against the whole
    rows' K7; then timed on one rank's block of the tensor-parallel run
    (``shape``), ``launches`` its counts.  Returns the largest
    norm-relative error."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import softmax_xent as k7

    T, V = XENT
    logits = randn(T, V, dtype=torch.bfloat16, scale=2.0)
    labels = torch.randint(0, V, (T,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[TRAIN_SEQ - 1::TRAIN_SEQ] = -1
    whole = k7.softmax_xent_rows(logits, labels)
    worst, line = 0.0, {"phase": "spmd_kernel", "kernel":
                        "K7/xent_block_bf16", "shape": [T, V], "blocks": {}}
    for n in XENT_BLOCKS:
        cuts = [(int(b[0]), int(b[-1]) + 1) for b in
                torch.tensor_split(torch.arange(V), n)]
        triples, errs = [], []
        for lo, hi in cuts:
            got = k7.softmax_xent_block(logits[:, lo:hi], labels, lo)
            want = ref.softmax_xent_block(logits[:, lo:hi], labels, lo)
            errs.append(max(tensor_err(a, b)[0] for a, b in zip(got, want)))
            triples.append(got)
        comb = tensor_err(ref.combine_xent_blocks(triples), whole)
        line["blocks"][n] = {"widths": sorted({hi - lo for lo, hi in cuts}),
                             "triple_norm_rel_err": max(errs),
                             "combined_vs_whole_k7": comb[0],
                             "combined_max_abs_err": comb[1]}
        worst = max(worst, max(errs), comb[0])
        del triples
    emit(line)
    if worst > MEAN_RTOL:
        failures.append(f"spmd: K7's block entry against its plain "
                        f"version or the whole rows: {line}")
    rows, Vb = shape
    blk = logits[:rows, :Vb].contiguous()
    lab = labels[:rows].contiguous()
    got = k7.softmax_xent_block(blk, lab, 0)
    mabs = max(tensor_err(a, b)[1] for a, b in
               zip(got, ref.softmax_xent_block(blk, lab, 0)))
    record("K7/xent_block_bf16", "lm_loss over a vocabulary split, one "
           "rank's block", [rows, Vb],
           lambda: k7.softmax_xent_block(blk, lab, 0),
           lambda: ref.softmax_xent_block(blk, lab, 0), None,
           k7_block_bound(rows, Vb, "bfloat16"), mabs, counted=launches)
    del logits, labels, whole, blk, lab, got
    torch.cuda.empty_cache()
    return worst


class moe_routes:
    """Within the block, every MoE layer records (router probabilities
    (G, Tg, E), expert ids (G, Tg, k), kept assignments (G, Tg·k)) of its
    routing, in call order: the router and the dispatch computed once
    more beside the layer's own, for the check alone."""

    def __enter__(self):
        from repro_torch.models import common
        from repro_torch.models import model as mm
        self.mm, self.layer, routes = mm, mm.moe_layer, []

        def tapped(cfg, x, p):
            probs, _, idx = common.route(cfg, x, p["router"])
            routes.append((probs, idx, common.dispatch(cfg, idx)[-1]))
            return self.layer(cfg, x, p)
        mm.moe_layer = tapped
        return routes

    def __exit__(self, *exc):
        self.mm.moe_layer = self.layer


class layer_gaps:
    """Within the block, each decoder layer the forward runs is also
    decoded, teacher-forced, at position ``pos``: the layer's prefill
    over the forward's own input to it at positions ``[0, pos)`` fills a
    one-layer cache (``forward.write_layer``), then ``forward.
    decode_layer`` runs on the forward's input at ``pos``; its output is
    held against the forward's output of the layer at ``pos`` (norm-
    relative, one entry a layer).  Each layer's decode algorithm then
    meets its forward on the same input and history, with one layer's
    rounding between them, however far the stack amplifies the rounding
    of the layers before it.  MoE layers are not checked (their
    capacity drops differ between a sequence and one token, and an MLA
    prefill leaves ``kr`` unroped)."""

    def __init__(self, cfg, pos: int):
        self.cfg, self.pos = cfg, pos

    def __enter__(self):
        import dataclasses

        import torch

        from repro_torch.models import forward as fw
        self.fw, gaps, pos = fw, [], self.pos
        self.saved = (fw.decoder_layer, fw.whisper_decoder_layer)
        one = dataclasses.replace(self.cfg, n_layers=1)

        def check(layer, x, lp, kind):
            out = layer(x)
            cache = {k: torch.zeros(shape, dtype=fw.cache_dtype(one, k),
                                    device=x.device)
                     for k, shape in fw.cache_shapes(
                         one, x.shape[0], pos + 1).items()}
            fw.write_layer(one, cache, 0, layer(x[:, :pos])[1], pos)
            got = fw.decode_layer(one, x[:, pos:pos + 1].contiguous(), lp,
                                  kind, cache, 0, pos)
            gaps.append(tensor_err(got[:, 0].float(),
                                   out[0][:, pos].float())[0])
            return out

        dec, whisper = self.saved
        fw.decoder_layer = lambda cfg, x, lp, kind="dense": check(
            lambda xs: dec(cfg, xs, lp, kind), x, lp, kind)
        fw.whisper_decoder_layer = lambda cfg, x, lp, enc_out: check(
            lambda xs: whisper(cfg, xs, lp, enc_out), x, lp, "dec")
        return gaps

    def __exit__(self, *exc):
        self.fw.decoder_layer, self.fw.whisper_decoder_layer = self.saved


# ---------------------------------------------------------------------------
# phase serve_tp: tensor-parallel serving over ranks of a process group
# ---------------------------------------------------------------------------

#: the serve_tp phase: 8 sequences, 32 greedy tokens
SERVE_TP_BATCH, SERVE_TP_GEN = 8, 32
#: its runs by the cards present (1; 2 or 3; 4 or more), in groups of
#: ranks spawned together: (ranks, ((arch, depth or None for the full
#: depth, model axis, prompt length, compute dtype[, config overrides,
#: ``"smoke"`` for the arch's smoke shapes]), ...)).  Llama-3-8B at full
#: width and depth, a prompt of 32, on (1, 2); LLaVA-NeXT-34B at full
#: width, its 576 patches then 32 tokens (608 positions, which 2, 4 and
#: 8 divide), on one card at 8 of its 60 layers (the unsharded run
#: beside the ranks holds ~11 GB), on more its full 60 ((1, 2), and on
#: four cards (1, 4)); Granite-34B at full width, its one KV head held
#: whole by both ranks (K5 with G = 24 a rank), 8 of its 88 layers, on
#: (1, 2); and Llama at depth 4 in float32, the split's exactness
#: without bfloat16's rounding ((1, 2), on four cards (2, 2): the rows
#: over data too).  The MoE family: DeepSeek-V2-Lite at full width, on
#: one card 8 of its 27 layers (~1.17 GB a layer; ~9.9 GB unsharded,
#: ~5.7 GB a rank), on more its full depth (~31 GB unsharded, ~16 GB a
#: rank); Grok-1 at full width, depth 2 (~22.9 GB unsharded, ~12.3 GB a
#: rank beside one whole leaf drawn at a time), on four cards depth 4
#: over (1, 4) (~43 GB unsharded on rank 0's card before its ranks
#: load); DeepSeek at depth 2 in float32; and DeepSeek's smoke shapes
#: in float32 with 3 experts, which 2 ranks do not divide (the F-split).
#: The ssm and encdec families: Mamba-2-2.7B (64 layers, d_model 2560,
#: 80 SSD heads of 64, state 128, tied; ~5.4 GB) and Whisper-medium (24 +
#: 24 layers, 16 heads, 1500 frames) at full width and depth, and each
#: at depth 4 in float32 (Whisper's encoder cut to 4 too); Mamba-2 at
#: depth 4 in bfloat16 too, where the bound holds it (its random model
#: amplifies bfloat16 roundings with depth: 1.2e-2 from one card at
#: depth 4, 4.8e-2 at 8, 0.18 at 16, 0.93 at 64, PERF.md); on four
#: cards the full-depth ones also on (1, 4)
_SERVE_TP_MOE = (("grok1_314b", 2, 2, 32, "bfloat16"),
                 ("deepseek_v2_lite", 2, 2, 32, "float32"),
                 ("deepseek_v2_lite", None, 2, 32, "float32",
                  {"smoke": True, "n_experts": 3}))
_SERVE_TP_SSM_ENCDEC = (("mamba2_2p7b", None, 2, 32, "bfloat16"),
                        ("whisper_medium", None, 2, 32, "bfloat16"),
                        ("mamba2_2p7b", 4, 2, 32, "float32"),
                        ("whisper_medium", 4, 2, 32, "float32"),
                        ("mamba2_2p7b", 4, 2, 32, "bfloat16"))
SERVE_TP_RUNS = {
    1: ((2, (("llama3_8b", None, 2, 32, "bfloat16"),
             ("llava_next_34b", 8, 2, 608, "bfloat16"),
             ("granite_34b", 8, 2, 32, "bfloat16"),
             ("llama3_8b", 4, 2, 32, "float32"),
             ("deepseek_v2_lite", 8, 2, 32, "bfloat16")) + _SERVE_TP_MOE
         + _SERVE_TP_SSM_ENCDEC),),
    2: ((2, (("llama3_8b", None, 2, 32, "bfloat16"),
             ("llava_next_34b", None, 2, 608, "bfloat16"),
             ("granite_34b", 8, 2, 32, "bfloat16"),
             ("llama3_8b", 4, 2, 32, "float32"),
             ("deepseek_v2_lite", None, 2, 32, "bfloat16"))
         + _SERVE_TP_MOE + _SERVE_TP_SSM_ENCDEC),),
    4: ((2, (("llama3_8b", None, 2, 32, "bfloat16"),
             ("granite_34b", 8, 2, 32, "bfloat16"),
             ("deepseek_v2_lite", None, 2, 32, "bfloat16"))
         + _SERVE_TP_MOE[1:] + _SERVE_TP_SSM_ENCDEC),
        (4, (("llava_next_34b", None, 4, 608, "bfloat16"),
             ("llama3_8b", 4, 2, 32, "float32"),
             ("grok1_314b", 4, 4, 32, "bfloat16"),
             ("mamba2_2p7b", None, 4, 32, "bfloat16"),
             ("whisper_medium", None, 4, 32, "bfloat16")))),
}
#: the logits of the split model against the one-card run on the same
#: seed, norm-relative, every step teacher-forced on the one-card run's
#: tokens, in bfloat16 (float32: ``RTOL``).  The ranks add float32
#: partial sums and round once, as one card's matmul does, but their
#: matmuls and K5 run at other shapes, so their float32 sums add in
#: another order and a few bfloat16 roundings flip; these random models
#: amplify such flips with depth (the one-card run served in two halves
#: of its rows, ``one_card_floor``, lies as far from itself), so a
#: ``DRIFTING`` config at its full depth is printed, not held, as in
#: phase ``lm``
SERVE_TP_RTOL = 5e-2


def forced_logits(cfg, model, x, tokens, spmd=None, rows=None):
    """The prefill's logits and each decode step's, the steps fed
    ``tokens`` (B, G) (teacher forcing), as float32 on the host: (G,
    rows, V) for the batch's ``rows`` (``(lo, hi)``; all of them where
    None)."""
    import torch

    from repro_torch.launch.serve import grow_cache
    from repro_torch.train import steps

    lo, hi = rows or (0, tokens.shape[0])
    P, G = x["prompts"].shape[1], tokens.shape[1]
    dev = model.device
    batch = {"tokens": torch.as_tensor(x["prompts"][lo:hi], device=dev)}
    for name in ("patches", "frames"):
        if x[name] is not None:
            batch[name] = torch.as_tensor(x[name][lo:hi], device=dev)
    logits, cache = steps.make_prefill_step(cfg, spmd)(model, batch)
    cache = grow_cache(cfg, cache, P + G)
    step = steps.make_decode_step(cfg, spmd)
    out = [logits.float().cpu()]
    for i in range(G - 1):
        _, logits, cache = step(model, cache, torch.as_tensor(
            tokens[lo:hi, i], device=dev), P + i)
        out.append(logits.float().cpu())
    del cache
    return torch.stack(out)


def serve_tp_config(arch, depth, dtype, over=None):
    """A ``SERVE_TP_RUNS`` run's config: ``arch``'s (its smoke shapes
    where ``over`` says ``"smoke"``) with ``over`` and the compute
    ``dtype``, at ``depth`` layers (``lm_config``: with its ``reduced``
    record)."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    over = dict(over or {})
    cfg = smoke_config(arch) if over.pop("smoke", False) else \
        get_config(arch)
    return lm_config(dataclasses.replace(cfg, compute_dtype=dtype, **over),
                     depth)


class serve_tp_routes:
    """Within the block, every MoE layer's router (``common.route``)
    records its expert ids, on the host, in call order (``ids``); with
    ``pinned`` (another run's ``ids``, call for call) the tokens go to
    those experts instead, gated by this router's own probabilities
    renormalised over them, and each token whose own experts differ
    adds the relative gap of its k-th and (k+1)-th probabilities to
    ``flips`` (a near tie flips under bfloat16 noise).  The check's
    routing, never the serving path's."""

    def __init__(self, pinned=None):
        self.pinned, self.ids, self.flips = pinned, [], []

    def __enter__(self):
        from repro_torch.models import common
        self.common, self.route = common, common.route
        pinned = None if self.pinned is None else iter(self.pinned)

        def tapped(cfg, x, router):
            probs, gate, idx = self.route(cfg, x, router)
            own = idx.cpu()
            self.ids.append(own)
            if pinned is None:
                return probs, gate, idx
            want = next(pinned)
            differ = (own.sort(-1).values != want.sort(-1).values).any(-1)
            if differ.any():
                k = cfg.topk
                ps = probs.sort(-1, descending=True).values.cpu()
                gap = (ps[..., k - 1] - ps[..., k]) / ps[..., k - 1]
                self.flips += gap[differ].tolist()
            want = want.to(idx.device)
            g = probs.gather(-1, want)
            return probs, g / g.sum(-1, keepdim=True).clamp_min(1e-9), want
        common.route = tapped
        return self

    def __exit__(self, *exc):
        self.common.route = self.route


def serve_tp_rank(rank: int, world: int, seed: int, runs,
                  device_type) -> dict:
    """One rank of phase ``serve_tp``: for each of ``runs`` ((arch,
    depth, model axis, prompt, dtype[, overrides])), rank 0 first serves
    it on its card unsharded (``launch.serve.generate``) and keeps the
    tokens, the logits teacher-forced on them (a MoE model's routing
    recorded, ``serve_tp_routes``) and, as the one-card run's own floor,
    the same logits computed in two halves of the rows; then every rank
    serves it split over ``make_host_mesh(mp, device_type)``
    (``load_model`` at the rank's blocks, one warm-up prefill and step,
    then the counts set to 0 just before ``generate`` and read just
    after), and computes the logits teacher-forced on the one-card
    tokens at its rows, routed to the one-card run's experts, with every
    plain version forbidden."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import LAUNCHES
    from repro_torch.dist.sharding import rank_param_bytes, serving_rows
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import draw_inputs, generate, load_model
    from repro_torch.models.model import tp_heads
    from repro_torch.train.steps import serving_spmd

    torch.backends.cuda.matmul.allow_tf32 = False
    B, G = SERVE_TP_BATCH, SERVE_TP_GEN
    dev = "cpu" if device_type == "cpu" else "cuda"
    out = {"backend": dist.get_backend(), "runs": []}

    def held(model):
        return sum(p.numel() * p.element_size() for p in model.parameters())

    for arch, depth, mp, P, dtype, *over in runs:
        cfg, reduced = serve_tp_config(arch, depth, dtype, *over)
        x = draw_inputs(cfg, B, P, seed)
        run = {"arch": arch, "config": cfg.name, "reduced": reduced,
               "n_layers": cfg.n_layers, "prompt": P, "dtype": dtype}
        box = [None, None]
        if rank == 0:           # the one-card run, kept on the host
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            model = load_model(cfg, seed, dev)
            res = generate(cfg, model, x["prompts"], G,
                           patches=x["patches"], frames=x["frames"])
            box[0] = res["tokens"]
            run["unsharded"] = {
                "step_ms": res["step_ms"][1:], "captures": res["captures"],
                "param_bytes": held(model),
                "peak_bytes": torch.cuda.max_memory_allocated() - base}
            del res
            with serve_tp_routes() as routes:
                whole = forced_logits(cfg, model, x, box[0])
            box[1] = routes.ids
            halves = torch.cat([forced_logits(cfg, model, x, box[0],
                                              rows=r)
                                for r in ((0, B // 2), (B // 2, B))], 1)
            run["one_card_floor"] = [tensor_err(h, w)[0]
                                     for h, w in zip(halves, whole)]
            del model, halves
            torch.cuda.empty_cache()
        dist.broadcast_object_list(box, src=0)
        tokens, routed = box

        spmd = serving_spmd(cfg, make_host_mesh(mp, device_type))
        rows = serving_rows(cfg, B, spmd)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = load_model(cfg, seed, dev, spmd.tp)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        generate(cfg, model, x["prompts"], 2, patches=x["patches"],
                 frames=x["frames"], spmd=spmd)              # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        LAUNCHES.reset()
        res = generate(cfg, model, x["prompts"], G, patches=x["patches"],
                       frames=x["frames"], spmd=spmd)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES.by_kernel)
        peak = torch.cuda.max_memory_allocated() - base
        with forbid_plain(ref), serve_tp_routes(routed) as routes:
            logits = forced_logits(cfg, model, x, tokens, spmd, rows)
        tp = spmd.tp
        (q0, q1), (kv0, kv1) = tp_heads(cfg, tp)
        b = rows[1] - rows[0]
        k5 = []                 # (where, shape, mean kv_len) of K5's calls
        if cfg.n_heads and not cfg.kv_lora_rank:
            heads = [b, q1 - q0, kv1 - kv0]
            k5.append(["decode", heads + [P + G, cfg.dh], P + G // 2])
            if cfg.family == "encdec":
                F = cfg.encoder_frames
                k5.append(["decode cross", heads + [F, cfg.dh], F])
        k4 = [] if cfg.norm == "layernorm" else \
            [[b, cfg.d_model], [b * P // mp, cfg.d_model]]
        # K4's block entry: the gated norm over the rank's d_inner block,
        # at a decode step's rows and over the prefill's whole sequence
        k4_block = [[b, cfg.d_inner // mp], [b * P, cfg.d_inner // mp]] \
            if cfg.family == "ssm" else []
        run["tp"] = {
            "mesh": spmd.describe(), "coords": [spmd.dp_rank,
                                                spmd.model_rank],
            "rows": list(rows), "backend": res["backend"],
            "graph": res["graph"], "captures": res["captures"],
            "tokens": res["tokens"], "prefill_ms": res["prefill_ms"],
            "first_step_ms": res["step_ms"][0],
            "step_ms": res["step_ms"][1:], "load_s": load_s,
            "peak_bytes": peak, "param_bytes": held(model),
            "param_bytes_want": rank_param_bytes(cfg, tp, ES[dtype]),
            "launches": launches,
            "moe_calls_routed": len(routes.ids),
            "routing_flip_gaps": routes.flips,
            "shapes": {"K5": k5, "K4": k4, "K4_block": k4_block,
                       "model_parallel": mp}}
        if rank == 0:
            run["one_card_tokens"] = tokens
            want = whole[:, rows[0]:rows[1]]
            run["vs_unsharded"] = [tensor_err(g, w)[0]
                                   for g, w in zip(logits, want)]
            del whole, want
        out["runs"].append(run)
        del model, res, logits
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def serve_tp_phase(args, failures: list, smi_line: str) -> list:
    """Phase ``serve_tp``: ``serve_tp_rank`` over ``SERVE_TP_RUNS``, on 2
    or more cards NCCL ranks, one a card, the decode step replayed as
    one CUDA graph with its collectives; on one card two gloo ranks that
    share it, every step eager (gloo cannot be captured).  One
    ``"serve_tp"`` line a run: the logits of every step within
    ``SERVE_TP_RTOL`` (float32: ``RTOL``) of the one-card run, the first
    step at which the greedy tokens differ from its tokens (printed: a
    bfloat16 near-tie may flip; a MoE run's logits are taken with its
    tokens routed to the one-card run's experts, and the near ties its
    own router flipped are printed), K4, K4's block entry and K5
    launched as often as the path launches them (``serve_tp_launches``),
    each rank's weight bytes its blocks', its peak and step ms, the cost
    model's bound beside them.  Then K4, K4's block entry and K5 at each
    bfloat16 run's shapes on a rank against their plain versions, and
    timed; returns their records (``"path": "serve_tp"``)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.dist.spmd import run_ranks
    from repro_torch.launch.costmodel import tp_decode

    world = torch.cuda.device_count()
    B, G = SERVE_TP_BATCH, SERVE_TP_GEN
    cards = 1 if world == 1 else (4 if world >= 4 else 2)
    backend, device_type = ("gloo", "cuda") if world == 1 else ("nccl",
                                                                None)
    t0 = time.perf_counter()
    done = []
    for nproc, runs in SERVE_TP_RUNS[cards]:
        d = tempfile.mkdtemp(prefix="serve_tp_")
        try:
            res = run_ranks(serve_tp_rank, nproc, args.seed, runs,
                            device_type, backend=backend, timeout_s=900,
                            tmpdir=d)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        done += [(nproc, run, [r["runs"][i] for r in res])
                 for i, run in enumerate(runs)]
    records, checked = [], set()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for nproc, (arch, depth, mp, P, dtype, *over), by_rank in done:
        r0 = by_rank[0]
        tp0, un = r0["tp"], r0["unsharded"]
        cfg, _ = serve_tp_config(arch, depth, dtype, *over)
        L, short = cfg.n_layers, SHORT[dtype]
        want_launches = serve_tp_launches(cfg, G, short)
        toks = tp0["tokens"]
        differ = np.argwhere((toks != r0["one_card_tokens"]).any(0))
        kv_mean = P + G // 2
        cost = tp_decode(cfg, B, kv_mean, mp, nproc // mp)
        one_cost = tp_decode(cfg, B, kv_mean, 1)
        bound = SERVE_TP_RTOL if dtype == "bfloat16" else RTOL
        held = dtype != "bfloat16" or not (arch in DRIFTING
                                           and depth is None)
        line = {"phase": "serve_tp", "nvidia_smi": smi_line, "arch": arch,
                "config": cfg.name, "overrides": over[0] if over else None,
                "reduced": r0["reduced"], "n_layers": L, "dtype": dtype,
                "batch": B, "prompt": P, "gen": G, "backend": backend,
                "ranks": nproc, "cards": world, "mesh": tp0["mesh"],
                "graph": tp0["graph"], "captures": tp0["captures"],
                "max_norm_rel_err_vs_one_card": max(r0["vs_unsharded"]),
                "bound": bound, "held": held,
                "norm_rel_err_by_step": r0["vs_unsharded"],
                "one_card_floor_max": max(r0["one_card_floor"]),
                "one_card_floor_by_step": r0["one_card_floor"],
                "rows_compared": tp0["rows"],
                "moe_calls_routed_to_one_card": tp0["moe_calls_routed"],
                "routing_flip_gaps_by_rank": [r["tp"]["routing_flip_gaps"]
                                              for r in by_rank],
                "first_token_differing_step": int(differ[0, 0])
                if len(differ) else None,
                "tokens_ok": toks.shape == (B, G) and bool(
                    ((toks >= 0) & (toks < cfg.vocab)).all()),
                "launches": tp0["launches"],
                "launches_want": want_launches,
                "step_ms_median_by_rank": [
                    float(np.median(r["tp"]["step_ms"])) for r in by_rank],
                "step_ms": tp0["step_ms"],
                "first_step_ms": tp0["first_step_ms"],
                "prefill_ms": tp0["prefill_ms"],
                "unsharded_step_ms_median": float(np.median(un["step_ms"])),
                "unsharded_captures": un["captures"],
                "param_gb_by_rank": [r["tp"]["param_bytes"] / 1e9
                                     for r in by_rank],
                "param_gb_unsharded": un["param_bytes"] / 1e9,
                "peak_gb_by_rank": [r["tp"]["peak_bytes"] / 1e9
                                    for r in by_rank],
                "peak_gb_unsharded": un["peak_bytes"] / 1e9,
                "load_s_by_rank": [r["tp"]["load_s"] for r in by_rank],
                "costmodel_rank_bound_ms": cost["step_lower_bound_s"] * 1e3,
                "costmodel": cost,
                "costmodel_one_card_bound_ms":
                    one_cost["step_lower_bound_s"] * 1e3,
                "shapes": tp0["shapes"],
                "seconds": time.perf_counter() - t0}
        if backend == "gloo":
            line["note"] = ("two ranks share the one card over gloo, which "
                            "stages CUDA tensors through the host and "
                            "cannot be captured: every step runs eagerly, "
                            "and the step time is not NCCL's")
        emit(line)
        ok = ((line["max_norm_rel_err_vs_one_card"] <= bound or not held)
              and line["tokens_ok"] and tp0["launches"] == want_launches
              and all(r["tp"]["param_bytes"] == r["tp"]["param_bytes_want"]
                      for r in by_rank)
              and (tp0["graph"] and tp0["captures"] == 1
                   if backend == "nccl" else not tp0["graph"]))
        if not ok:
            failures.append(f"serve_tp {arch} {dtype} {tp0['mesh']}: {line}")
        if dtype == "bfloat16" and (arch, mp) not in checked:
            # a model's kernels once a split, at its first run's shapes
            checked.add((arch, mp))
            records += serve_tp_kernels(cfg, tp0["shapes"], tp0["launches"],
                                        randn, failures, f"{arch} {mp}-way ")
    return records


def serve_tp_launches(cfg, G: int, short: str) -> dict:
    """The hand kernels' launches in a tensor-parallel ``generate`` of
    ``G`` tokens on a rank (the prefill and G - 1 decode steps): K4 at
    every whole-row RMSNorm, 2L + 1 a pass (the ssm family L + 1: ``ln1``
    and the final norm), K4's block entry 2L a pass for the SSD mixer's
    gated norm (the sums, then the scale), none with LayerNorm; K5's
    split and combine L a step (a Whisper decoder 2L: self- and
    cross-attention), none for MLA's decode or the SSD mixer."""
    L, fam = cfg.n_layers, cfg.family
    out = {}
    if cfg.norm != "layernorm":
        out[f"K4/rmsnorm_{short}"] = ((L if fam == "ssm" else 2 * L) + 1) * G
    if fam == "ssm":
        out |= {f"K4/block_sumsq_{short}": L * G,
                f"K4/block_scale_{short}": L * G}
    k5 = 0 if cfg.kv_lora_rank or fam == "ssm" else \
        (2 * L if fam == "encdec" else L)
    if k5:
        out |= {f"K5/split_{short}": k5 * (G - 1),
                f"K5/combine_{short}": k5 * (G - 1)}
    return out


def serve_tp_kernels(cfg, shapes: dict, launches: dict, randn,
                     failures: list, label: str) -> list:
    """K5 (``kv_len`` in device memory, as the decode reads it) at each
    of a rank's shapes (a Whisper decoder's cross-attention too), K4 at
    its decode and prefill rows (``d_model``; none with LayerNorm) and
    K4's block entry at its gated-norm rows (``k4_block_checks``), each
    against its plain version with a bitwise repeat, then timed
    (``lm_time``); no K5 where MLA's decode or the SSD mixer launch
    none."""
    import torch

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import ref

    decode = []
    for where, shape, kv_len in shapes["K5"]:
        b, hq, hkv, S, d = shape
        q, kk, vv = (randn(b, hq, d), randn(b, S, hkv, d),
                     randn(b, S, hkv, d))
        kl = torch.full((), kv_len, dtype=torch.int32, device="cuda")
        got = k5.decode_attention(q, kk, vv, kv_len=kl)
        again = k5.decode_attention(q, kk, vv, kv_len=kl)
        rel, mabs = tensor_err(got, ref.decode_attention(q, kk, vv,
                                                         kv_len=kl))
        same = torch.equal(bits(got), bits(again))
        emit({"phase": "serve_tp_kernel", "arch": cfg.name, "kernel": "K5",
              "where": where, "shape": shape, "kv_len": kv_len,
              "dtype": "bfloat16", "kv_len_on_device": True,
              "norm_rel_err": rel, "max_abs_err": mabs,
              "repeat_bitwise": same})
        if not (rel <= BF16_KERNEL_RTOL and same):
            failures.append(f"serve_tp_kernel K5 {shape}: error "
                            f"{rel:.3g}, bitwise repeat {same}")
        del q, kk, vv, got, again
        decode.append((where, tuple(shape), kv_len))
    k4_checked = lm_k4_checks(cfg, 0, randn, failures,
                              rows=[T for T, _ in shapes["K4"]],
                              phase="serve_tp_kernel",
                              widths=[cfg.d_model]) if shapes["K4"] else []
    decode_rows = shapes["K5"][0][1][0] if shapes["K5"] else \
        shapes["K4"][0][0]
    recs = lm_records(cfg, randn, k4_checked, decode, launches, failures,
                      label=label, device_kv=True, host_kv=False,
                      path="serve_tp", decode_rows=decode_rows)
    if shapes["K4_block"]:
        recs += lm_time(k4_block_checks(cfg, shapes, randn, failures),
                        launches, failures, label, "serve_tp")
    return recs


def k4_block_bounds(T: int, Db: int) -> tuple:
    """The bounds of K4's block entry on a (T, Db) bfloat16 block: the
    sums read the block and write T float32 sums (2 operations an
    element); the scale reads the block, the sums and the block's
    bfloat16 gamma and writes the block (3 an element)."""
    return (bound_of(2 * T * Db + 4 * T, 2 * T * Db),
            bound_of(2 * 2 * T * Db + 4 * T + 2 * Db, 3 * T * Db))


def k4_block_checks(cfg, shapes: dict, randn, failures: list) -> list:
    """K4's block entry at a rank's gated-norm rows (``shapes
    ["K4_block"]``, (T, d_inner / mp), bfloat16): whole rows (T,
    d_inner) cut into the ``mp`` ranks' blocks of columns, each block's
    sums of squares and its scaled block against their plain versions
    (1e-3 norm-relative, bitwise repeats), the blocks' sums added and
    the blocks joined against whole-row K4 (1e-3); one
    ``serve_tp_kernel`` line a shape.  Returns ``lm_time`` entries for
    the first block (no PyTorch call computes a block's statistics:
    ``library_ms`` null)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as k4

    mp, D = shapes["model_parallel"], cfg.d_inner
    timed = []
    for T, Db in shapes["K4_block"]:
        x, g = randn(T, D), randn(D)
        blocks = [(x[:, r * Db:(r + 1) * Db].contiguous(),
                   g[r * Db:(r + 1) * Db]) for r in range(mp)]
        errs, same, sums = [], True, []
        for blk, _ in blocks:
            ss = k4.rmsnorm_block_sumsq(blk)
            errs.append(tensor_err(ss, ref.rmsnorm_block_sumsq(blk)))
            same &= torch.equal(ss, k4.rmsnorm_block_sumsq(blk))
            sums.append(ss)
        total = torch.stack(sums).sum(0)
        outs = []
        for blk, gb in blocks:
            got = k4.rmsnorm_block_scale(blk, total, gb, D)
            errs.append(tensor_err(got, ref.rmsnorm_block_scale(
                blk, total, gb, D)))
            same &= torch.equal(bits(got), bits(k4.rmsnorm_block_scale(
                blk, total, gb, D)))
            outs.append(got)
        whole = tensor_err(torch.cat(outs, 1), k4.rmsnorm(x, g))
        rel = max(e[0] for e in errs)
        emit({"phase": "serve_tp_kernel", "arch": cfg.name,
              "kernel": "K4/block_bf16", "shape": [T, Db], "rows": [T, D],
              "blocks": mp, "dtype": "bfloat16", "norm_rel_err": rel,
              "max_abs_err": max(e[1] for e in errs),
              "combined_vs_whole_k4": whole[0],
              "combined_max_abs_err": whole[1], "repeat_bitwise": same})
        if not (rel <= BF16_KERNEL_RTOL and whole[0] <= BF16_KERNEL_RTOL
                and same):
            failures.append(f"serve_tp_kernel K4 block entry ({T}, {Db}) "
                            f"of {mp}: error {rel:.3g}, against whole "
                            f"rows {whole[0]:.3g}, bitwise repeat {same}")
        blk, gb = blocks[0]
        where = "decode" if T == shapes["K4_block"][0][0] else "prefill"
        b_sum, b_scale = k4_block_bounds(T, Db)
        timed += [
            dict(counter="K4/block_sumsq_bf16", where=f"{where} D {Db}",
                 shape=[T, Db], err=errs[0][1], lib=None,
                 wrapper=lambda blk=blk: k4.rmsnorm_block_sumsq(blk),
                 plain=lambda blk=blk: ref.rmsnorm_block_sumsq(blk),
                 bound=b_sum),
            dict(counter="K4/block_scale_bf16", where=f"{where} D {Db}",
                 shape=[T, Db], err=errs[mp][1], lib=None,
                 wrapper=lambda blk=blk, gb=gb, t=total:
                 k4.rmsnorm_block_scale(blk, t, gb, D),
                 plain=lambda blk=blk, gb=gb, t=total:
                 ref.rmsnorm_block_scale(blk, t, gb, D),
                 bound=b_scale)]
    return timed


def decode_vs_forward(cfg, model, seq, steps: int = 1, patches=None,
                      frames=None) -> dict:
    """The reference's serving check (``tests/test_models.py:64-88``) on
    the card, over ``seq`` (B, S) tokens (and a VLM's ``patches``, an
    encoder-decoder's ``frames``, the same on both passes): prefill(S -
    ``steps``) and ``steps`` decode steps at S - steps ... S - 1 (over a
    cache grown to S - steps + 32 rows) against the forward over all S
    at each step's position: norm- and max-relative error of the logits
    (the largest over the steps, and each step's), and each sequence's
    at the last step.  One step over the prompt (S = 1024) for the
    stateless families; a recurrent state's family runs the 32 steps of
    ``generate`` over its 1056 tokens.  The check's own fix-ups, none
    of them in the serving path:

    * an MoE model's capacity factor is replaced by E / k on both
      passes, so that no pass drops an assignment (the forward's 16
      groups and the decode's one group hold C = Tg);
    * with MLA the check is made as the reference computes it (the
      prefill's ``kr`` before rope) and again with the prefill's ``kr``
      rows roped in place;
    * an MoE model's last token may choose other experts in the decode
      than in the forward where its router's k-th and (k+1)-th choices
      lie closer than the two passes' bfloat16 noise (``routing_flips``
      lists them, with the forward's gap); the check is made once more
      with the decode routed to the forward's experts (gates from its
      own router), ``*_routing_pinned``.

    The last of these is the one held to the bound
    (``decode_vs_forward_checked``)."""
    import dataclasses

    import torch

    from repro_torch.launch.serve import grow_cache
    from repro_torch.models import common, decode_step, forward_lm, prefill
    out = {}
    moe = cfg.family == "moe"
    if moe:
        replaced = cfg.n_experts / cfg.topk
        out["replaced"] = {"capacity_factor": [cfg.capacity_factor,
                                               replaced]}
        cfg = dataclasses.replace(cfg, capacity_factor=replaced)
    B, S = seq.shape
    Pf = S - steps
    dev = model.device
    extra = {k: torch.as_tensor(a, device=dev) for k, a in
             (("patches", patches), ("frames", frames)) if a is not None}
    seq = torch.as_tensor(seq, device=dev)
    with moe_routes() as fwd, (contextlib.nullcontext([]) if moe
                               else layer_gaps(cfg, S - 1)) as gaps:
        want = forward_lm(cfg, model, seq, **extra)[0][:, Pf:].float()
    if gaps:
        out.update(layer_gaps=gaps, layer_gap_max=max(gaps))
    _, cache = prefill(cfg, model, seq[:, :Pf], **extra)
    cache = grow_cache(cfg, cache, Pf + LM_GEN)
    out["decode_vs_forward_steps"] = steps

    def errs(key: str, tap: bool = True):
        rels = []
        for i in range(steps):
            with moe_routes() if tap else contextlib.nullcontext() as dec:
                got = decode_step(cfg, model, cache, seq[:, Pf + i],
                                  Pf + i)[0].float()
            w = want[:, i]
            rels.append(tensor_err(got, w)[0])
        out[f"{key}_norm_rel"] = max(rels)
        if steps > 1:
            out[f"{key}_by_step"] = rels
        out[f"{key}_max_rel"] = float((got - w).abs().max() / w.abs().max())
        out[f"{key}_by_sequence"] = ((got - w).norm(dim=-1)
                                     / w.norm(dim=-1)).tolist()
        return max(rels), dec

    key = "decode_vs_forward"
    checked, dec = errs(key)
    if cfg.kv_lora_rank:
        positions = torch.arange(Pf, device=dev)[None, :]
        for kr in cache["kr"]:
            kr[:, :Pf] = common.rope(kr[:, :Pf, None, :], positions,
                                     cfg.rope_theta)[..., 0, :]
        key += "_kr_roped"
        checked, dec = errs(key)
    if moe:
        out.update(routing_flips(cfg, fwd, dec, B, S))
        with pinned_routes(fwd, B, S):
            checked, _ = errs(key + "_routing_pinned", tap=False)
    out["decode_vs_forward_checked"] = checked
    return out


class pinned_routes:
    """Within the block, the i-th MoE layer called sends its tokens (one
    a sequence: a decode step) to the experts that ``fwd``'s i-th layer
    (``moe_routes`` over B sequences of P tokens) chose for each
    sequence's last token, with gates from its own router renormalised
    over them: the check's routing, never the serving path's."""

    def __init__(self, fwd: list, B: int, P: int):
        self.fwd, self.B, self.P = fwd, B, P

    def __enter__(self):
        import torch

        from repro_torch.models import common
        self.common, self.route = common, common.route
        calls = iter(self.fwd)

        def pinned(cfg, x, router):
            probs = self.route(cfg, x, router)[0]
            idx = next(calls)[1]
            last = torch.arange(self.B, device=idx.device) * self.P \
                + self.P - 1
            idx = idx.reshape(self.B * self.P, -1)[last].reshape(
                *probs.shape[:2], -1)
            gate = probs.gather(-1, idx)
            return probs, gate / gate.sum(-1, keepdim=True), idx
        common.route = pinned

    def __exit__(self, *exc):
        self.common.route = self.route


def routing_flips(cfg, fwd: list, dec: list, B: int, P: int) -> dict:
    """The last token's experts in each MoE layer of the forward
    (``moe_routes`` over B sequences of P tokens) against the decode's:
    the (layer, sequence) pairs whose expert sets differ, and for each
    the gap of the forward's k-th and (k+1)-th router probabilities
    relative to the k-th (a near tie flips under bfloat16 noise)."""
    import torch
    k = cfg.topk
    flips, gaps = [], []
    for l, ((probs, idx, _), (_, didx, _)) in enumerate(zip(fwd, dec)):
        last = torch.arange(B, device=idx.device) * P + P - 1
        f_idx = idx.reshape(B * P, k)[last].sort(-1).values
        ps = probs.reshape(B * P, -1)[last].sort(-1, descending=True).values
        differ = (f_idx != didx.reshape(B, k).sort(-1).values).any(-1)
        for b in differ.nonzero()[:, 0].tolist():
            flips.append([l, b])
            gaps.append(float((ps[b, k - 1] - ps[b, k]) / ps[b, k - 1]))
    return {"routing_flips": flips, "routing_flip_gaps": gaps,
            "moe_layers": len(fwd)}


def lm_k4_widths(cfg) -> list:
    """The row widths K4 normalises in ``cfg``'s model: d_model, and the
    SSD mixer's gated norm at d_inner; none with LayerNorm."""
    if cfg.norm == "layernorm":
        return []
    return [cfg.d_model] + ([cfg.d_inner] if cfg.family in STATEFUL else [])


def lm_k4_checks(cfg, P: int, randn, failures: list, rows=None,
                 phase: str = "lm_kernel", widths=None) -> list:
    """K4 at ``cfg``'s decode (B, D) and prefill (B·P, D) shapes (or at
    each of ``rows``) for each of ``lm_k4_widths`` (or ``widths``) in
    bfloat16 against its plain version, with a bitwise repeat; returns
    ``(T, x, gamma, max_abs_err)`` for each."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as k4

    out = []
    for D in widths or lm_k4_widths(cfg):
        for T in rows or (LM_BATCH, LM_BATCH * P):
            x, g = randn(T, D), randn(D)
            got, again = k4.rmsnorm(x, g), k4.rmsnorm(x, g)
            rel, mabs = tensor_err(got, ref.rmsnorm(x, g))
            same = torch.equal(bits(got), bits(again))
            emit({"phase": phase, "arch": cfg.name,
                  "kernel": "K4/rmsnorm_bf16", "shape": [T, D],
                  "dtype": "bfloat16", "norm_rel_err": rel,
                  "max_abs_err": mabs, "repeat_bitwise": same,
                  **k4.plan(D, x.dtype, x.device)})
            if not (rel <= BF16_KERNEL_RTOL and same):
                failures.append(f"lm_kernel K4 {cfg.name} ({T}, {D}): "
                                f"error {rel:.3g}, bitwise repeat {same}")
            out.append((T, x, g, mabs))
    return out


def lm_records(cfg, randn, k4_checked: list, k5_shapes: list,
               launches: dict, failures: list, label: str = "",
               device_kv: bool = False, host_kv: bool = True,
               path: str = "lm", decode_rows: int = LM_BATCH) -> list:
    """K4 (on ``lm_k4_checks``' inputs; ``decode_rows`` rows at decode)
    and K5 at each of ``k5_shapes`` (``lm_k5_shapes``) with a host
    ``kv_len`` where ``host_kv``, with ``kv_len`` read from device
    memory where ``device_kv``, each timed: the kernel records, named
    ``<counter> (<path> <label><where>)``, with the main run's
    ``launches`` of each kernel (prefill and decode together)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as k4

    F = torch.nn.functional
    B = decode_rows
    timed = []
    for T, x, g, mabs in k4_checked:
        D = x.shape[1]
        where = "decode" if T == B else "prefill"
        if D != cfg.d_model:
            where += f" D {D}"
        # gamma in bfloat16, as the cast model holds it
        timed.append(
            dict(counter="K4/rmsnorm_bf16", where=where, shape=[T, D],
                 err=mabs,
                 wrapper=lambda x=x, g=g: k4.rmsnorm(x, g),
                 plain=lambda x=x, g=g: ref.rmsnorm(x, g),
                 lib=lambda x=x, g=g, D=D: F.rms_norm(x, (D,), g, eps=1e-6),
                 bound=bound_of(2 * 2 * T * D + 2 * D, 4 * T * D)))
    for where, shape, kv_len in k5_shapes:
        if host_kv:
            timed += k5_timed(shape, kv_len, where, randn)
        if device_kv:
            timed += k5_timed(shape, kv_len, where + ", kv_len on device",
                              randn, on_device=True)
    return lm_time(timed, launches, failures, label, path)


def k5_timed(shape, kv_len: int, where: str, randn,
             on_device: bool = False) -> list:
    """K5's split, combine and the whole at ``shape`` (B, Hq, Hkv, S, d)
    over ``kv_len`` rows, bfloat16, as ``lm_time`` entries: each with its
    max abs error against its plain version, its bound and (the whole)
    SDPA as its library call.  ``on_device``: ``kv_len`` read from device
    memory, the chunks planned for all S (those past it empty), as the
    replayed decode step runs K5."""
    import torch

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import ref

    F = torch.nn.functional
    b, hq, hkv, S, d = shape
    q, kk, vv = randn(b, hq, d), randn(b, S, hkv, d), randn(b, S, hkv, d)
    host_len = kv_len
    if on_device:
        kv_len = torch.full((), kv_len, dtype=torch.int32, device="cuda")
    acc, mm, ll, length = k5.split(q, kk, vv, kv_len=kv_len)
    chunks = acc.shape[0] // (b * hkv)
    e_split = max(tensor_err(x[torch.isfinite(y)], y[torch.isfinite(y)])[1]
                  for x, y in zip((acc, mm, ll), ref.decode_attention_split(
                      q, kk, vv, length, kv_len=kv_len)))
    part = (acc, mm, ll, b, hq, torch.bfloat16)
    o = k5.combine(*part)
    e_comb = tensor_err(o, ref.decode_attention_combine(*part))[1]
    e_whole = tensor_err(k5.decode_attention(q, kk, vv, kv_len=kv_len),
                         ref.decode_attention(q, kk, vv, kv_len=kv_len))[1]
    b_split, b_comb, b_whole = k5_bounds(
        (b, hq, hkv, host_len, d), "bfloat16", chunks)
    qkv = (q, kk, vv)
    extra = dict(where=where, shape=list(shape), kv_len=host_len,
                 chunks=chunks, chunk_len=length)
    return [
        dict(extra, counter="K5/split_bf16", err=e_split, lib=None,
             wrapper=lambda: k5.split(*qkv, kv_len=kv_len),
             plain=lambda: ref.decode_attention_split(*qkv, length,
                                                      kv_len=kv_len),
             bound=b_split),
        dict(extra, counter="K5/combine_bf16", err=e_comb, lib=None,
             wrapper=lambda: k5.combine(*part),
             plain=lambda: ref.decode_attention_combine(*part),
             bound=b_comb),
        # K5 as a whole: a time line only, beside the library's attention
        dict(extra, counter=None, err=e_whole,
             wrapper=lambda: k5.decode_attention(*qkv, kv_len=kv_len),
             plain=lambda: ref.decode_attention(*qkv, kv_len=kv_len),
             lib=lambda: F.scaled_dot_product_attention(
                 q[:, :, None], kk[:, :host_len].transpose(1, 2),
                 vv[:, :host_len].transpose(1, 2), enable_gqa=True)[:, :, 0],
             bound=b_whole)]


def lm_time(timed: list, launches: dict, failures: list, label: str,
            path: str = "lm") -> list:
    """Each of ``lm_records``' kernels timed beside its bound, its plain
    version and its library call: a ``time`` line each (``"path":
    path``), and the records of those with a launch counter."""
    from repro_torch.core.timing import graph_ms, time_ms
    records = []
    for e in timed:
        name = (f"{e['counter'] or 'K5/split+combine_bf16'} "
                f"({path} {label}{e['where']})")
        ms, how = graph_ms(e["wrapper"])
        lib_ms = lib_err = None
        if e["lib"] is not None:
            out = e["wrapper"]()
            lib_err = tensor_err(e["lib"](), out)[0]
            if not lib_err <= BF16_RTOL:
                failures.append(f"library call for {name} disagrees with "
                                f"the kernel: {lib_err:.3g}")
            lib_ms = graph_ms(e["lib"])[0]
        b_ms, b_by = e["bound"]
        src, replaces = HAND[e["counter"] or "K5/split_bf16"]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": launches.get(e["counter"], 0),
               "max_abs_err": e["err"], "ms": ms,
               "plain_ms": time_ms(e["plain"]), "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib_ms}
        emit({"phase": "time", "path": path, **rec, "timed_by": how,
              "wrapper_ms": time_ms(e["wrapper"]),
              "library_norm_rel_err": lib_err, "bound_share": b_ms / ms,
              **{k: e[k] for k in ("shape", "kv_len", "chunks", "chunk_len")
                 if k in e}})
        if e["counter"] is not None:
            records.append(rec)
    return records


def heal_corrupt_plan(FusionCompiler, PlanCache, REGISTRY, make_inputs,
                      n: int) -> dict:
    """Compile AXPYDOT at ``n`` against a disk cache, swap two input refs
    of its plan entry on disk (a plan that still resolves but routes the
    wrong values), compile again under the full verifier: the served
    entry must be rejected, dropped and republished, and the outputs
    right."""
    import logging
    import tempfile

    import numpy as np
    seq = REGISTRY["AXPYDOT"]
    shapes = seq.shapes(n)
    warnings = []

    class Catch(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    log = logging.getLogger("repro_torch.compiler")
    handler = Catch(level=logging.WARNING)
    log.addHandler(handler)
    try:
        with tempfile.TemporaryDirectory() as d:
            FusionCompiler(cache=PlanCache(disk_dir=d), verify=False).compile(
                seq.script, shapes)
            (entry,) = [os.path.join(d, f) for f in os.listdir(d)
                        if f.endswith(".plan.json")]
            with open(entry) as f:
                plan = json.load(f)
            refs = plan["groups"][0]["inputs"]
            a, b = (i for i, r in enumerate(refs)
                    if r[0] == "input" and r[1] in ("w", "v"))
            refs[a], refs[b] = refs[b], refs[a]
            with open(entry, "w") as f:
                json.dump(plan, f)
            cache = PlanCache(disk_dir=d)
            prog = FusionCompiler(cache=cache, verify=True).compile(
                seq.script, shapes)
            inputs = make_inputs(seq, n, seed=1)
            got = prog(**inputs)
            want = seq.reference(**{k: np.asarray(x, np.float64)
                                    for k, x in inputs.items()})
            err = max(norm_rel(x.cpu().numpy(), y) for x, y in zip(got, want))
            with open(entry) as f:
                republished = json.load(f)
    finally:
        log.removeHandler(handler)
    rejected = any("rejected by static verification" in w for w in warnings)
    return {"corrupted": "AXPYDOT: two input refs swapped",
            "rejected": rejected, "disk_writes": cache.stats.disk_writes,
            "republished_fixed": republished != plan,
            "heal_norm_rel_err": err,
            "healed": rejected and cache.stats.disk_writes == 1
            and republished != plan and err <= RTOL}


def main(argv=None):
    ap = argparse.ArgumentParser(description="port smoke run on one GPU")
    ap.add_argument("--n2", type=int, default=4096,
                    help="size of the BLAS-2 sequences, the LM programs "
                         "and the hand kernels' square matrices")
    ap.add_argument("--n1", type=int, default=1 << 24,
                    help="size of the BLAS-1 sequences and FUSED_ADAMW")
    ap.add_argument("--n-attn", type=int, default=131072,
                    help="KV length of LM_DECODE_ATTN")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--engine-requests", type=int, default=ENGINE_REQUESTS,
                    help="requests in the engine phase's stream")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the engine phase's stream and inputs")
    ap.add_argument("--budget", type=int, default=AUTOTUNE_BUDGET,
                    help="candidates the autotune phase measures a program")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    try:
        from repro_torch.core import (LAUNCHES, FusionCompiler, PlanCache,
                                      tiled_reference)
        from repro_torch.kernels import adamw as k6
        from repro_torch.kernels import bicgk as k2
        from repro_torch.kernels import decode_attention as k5
        from repro_torch.kernels import gemver as k3
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels import rmsnorm as k4
        from repro_torch.kernels import softmax_xent as k7
        from repro_torch.core.codegen import _batched_dense_fn
        from repro_torch.core.cuda_codegen import torch_dtype
        from repro_torch.core.masking import MASK_INPUT, mask_row
        from repro_torch.core.timing import (device_ms, graph_ms, replay_s,
                                             time_ms)
        from repro_torch.analysis import verify_plan
        from repro_torch.core import autotune, scheduler
        from repro_torch.kernels import _build
        from repro_torch.launch.serve import engine_stream, serve_blas
        from repro_torch.optim import fused_adamw_update
        from repro_torch.programs import BLAS, REGISTRY, make_inputs
        from repro_torch.serving import Request, ServingEngine
    except ImportError as e:
        fail(f"cannot import the port from {ROOT}/src: {e}")
    if any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
           for m in sys.modules):
        fail("the port imported jax or the reference package")
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    dev_name = torch.cuda.get_device_name(0)
    failures: list[str] = []
    n2 = args.n2

    def size(name):
        if name == "LM_DECODE_ATTN":
            return args.n_attn
        return args.n1 if name in BLAS1 else n2

    # -- 1. plan every program, build every kernel in parallel ---------------
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    keys = [(name, mode) for name in list(BLAS) + list(LM) for mode in MODES]
    t0 = time.perf_counter()
    progs = {k: cc.compile(REGISTRY[k[0]].script,
                           REGISTRY[k[0]].shapes(size(k[0])),
                           mode=k[1], label=f"{k[0]}/{k[1]}") for k in keys}
    # the engine's programs: one per (sequence, bucket) of the stream
    stream = engine_stream(engine_ranges(args), args.engine_requests,
                           args.seed)
    engine = ServingEngine(
        FusionCompiler(backend="cuda", device="cuda", cache=PlanCache()),
        max_batch=ENGINE_BATCH, min_bucket=64, registry=REGISTRY,
        max_pack=ENGINE_PACK)
    engine_keys = sorted({(s_, engine.bucket_of(n)) for s_, n in stream})
    engine_progs = {k: engine._get_program(*k) for k in engine_keys}
    # float16 programs
    cc16 = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache(),
                          dtype=np.float16)
    keys16 = [(name, mode) for name in FP16 for mode in MODES]
    progs16 = {k: cc16.compile(REGISTRY[k[0]].script,
                               REGISTRY[k[0]].shapes(size(k[0])), mode=k[1],
                               label=f"fp16/{k[0]}/{k[1]}") for k in keys16}
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        futs = {k: pool.submit(p.module.build) for k, p in progs.items()}
        for k, p in [*engine_progs.items(), *progs16.items()]:
            futs[("build",) + k] = pool.submit(p.module.build)
        hand_sources = (("bicgk.cu", k2._launchers),
                        ("gemver.cu", k3._launchers),
                        ("rmsnorm.cu", k4._launcher),
                        ("decode_attention.cu", k5._launchers),
                        ("adamw.cu", k6._launcher),
                        ("softmax_xent.cu", k7._launcher))
        for src, launcher in hand_sources:
            futs[src] = pool.submit(launcher)
        for k, fut in futs.items():
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — reported, then fail
                failures.append(f"build {k}: {e}")
    t_build = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi_line, "device": dev_name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "plans": len(keys), "engine_plans": len(engine_progs),
          "fp16_plans": len(progs16), "hand_sources": len(hand_sources),
          "plan_s": t_plan, "build_s": t_build, "n_blas2": n2,
          "n_blas1": args.n1, "n_attn": args.n_attn})
    if failures:
        fail("; ".join(failures))

    # -- spmd: the int8 train run sharded over NCCL ranks, and restored,
    # first, while this process holds nothing on the card: the ranks are
    # processes of their own, each with the whole card to itself
    spmd_recs = spmd_phase(args, failures, smi_line)
    if failures:
        fail("; ".join(failures))
    # -- serve_tp: serve --arch split over ranks, while this process still
    # holds nothing on the card
    spmd_recs += serve_tp_phase(args, failures, smi_line)
    if failures:
        fail("; ".join(failures))
    # -- 2. lm: serve --arch at Llama-3-8B's full width and depth, while the
    # card holds nothing else (the float32 check loads 32 GB of weights)
    lm_recs = lm_phase(args, failures, smi_line)
    if failures:
        fail("; ".join(failures))
    # -- train: Llama-3-8B's full width at depth 4, then int8 moments
    lm_recs += train_phase(args, failures, smi_line) + spmd_recs
    if failures:
        fail("; ".join(failures))

    names = list(BLAS) + list(LM)
    inputs = {name: make_inputs(REGISTRY[name], size(name), seed=0)
              for name in names}
    dev_inputs = {k: progs[k].prepare(**inputs[k[0]]) for k in keys}

    def group_args(prog, outs_so_far, gp, ins):
        vals = dict(zip(prog.plan.input_names, ins))
        return [vals[r[1]] if r[0] == "input" else outs_so_far[r[1]][r[2]]
                for r in gp.inputs]

    # -- 3. kernel phase: each group against the plain tiled version ---------
    kernel_err, group_in, kernel_out = {}, {}, {}
    for k in keys:
        prog = progs[k]
        outs_so_far = []
        for gi, (gp, fn, im) in enumerate(zip(prog.plan.groups,
                                              prog.group_fns,
                                              prog.group_impls)):
            a = group_args(prog, outs_so_far, gp, dev_inputs[k])
            try:
                got = fn.launch(*a)
                again = fn.launch(*a)
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001
                failures.append(f"kernel {fn.name}: {e}")
                got = None
            want = tiled_reference(prog.graph, im, *a)
            if got is not None:
                errs = [norm_rel(x.cpu().numpy(), y.cpu().numpy())
                        for x, y in zip(got, want)]
                mabs = max(float((x - y).abs().max()) for x, y in
                           zip(got, want))
                bitwise = all(torch.equal(x.view(torch.int32),
                                          y.view(torch.int32))
                              for x, y in zip(got, again))
                kernel_err[fn.name] = mabs
                kernel_out[fn.name] = got
                emit({"phase": "kernel", "kernel": fn.name,
                      "max_abs_err": mabs, "norm_rel_err": max(errs),
                      "repeat_bitwise": bitwise,
                      "units": [ph.units for ph in fn.layout.phases],
                      "slices": [ph.S for ph in fn.layout.phases]})
                if not max(errs) <= RTOL:
                    failures.append(f"kernel {fn.name}: norm-relative error "
                                    f"{max(errs):.3g} > {RTOL}")
                if not bitwise:
                    failures.append(f"kernel {fn.name}: a second launch "
                                    f"differs from the first")
            group_in[fn.name] = (prog, im, a)
            outs_so_far.append(want)
    if failures:
        fail("; ".join(failures))

    # -- 4. main path: programs against float64 numpy, counting launches -----
    outs = {}
    LAUNCHES.reset()
    for k in keys:
        outs[k] = progs[k](**inputs[k[0]])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES.by_kernel)
    for k in keys:
        name, mode = k
        prog = progs[k]
        got = outs[k] if isinstance(outs[k], tuple) else (outs[k],)
        ref64 = REGISTRY[name].reference(
            **{n: np.asarray(x, np.float64) for n, x in inputs[name].items()})
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        errs = [norm_rel(x.cpu().numpy(), r) for x, r in zip(got, ref64)]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        shapes = all(tuple(x.shape) == np.shape(r) for x, r in zip(got, ref64))
        counts = [launches.get(fn.name, 0) for fn in prog.group_fns]
        emit({"phase": "main", "program": name, "mode": mode,
              "n": size(name), "groups": prog.n_groups, "launches": counts,
              "norm_rel_err": max(errs), "finite": finite})
        if not (max(errs) <= RTOL and finite and shapes):
            failures.append(f"main {name}/{mode}: error {max(errs):.3g}, "
                            f"finite {finite}, shapes {shapes}")
        if counts != [1] * prog.n_groups:
            failures.append(f"main {name}/{mode}: launch counts {counts}, "
                            f"want one per group")
    if failures:
        fail("; ".join(failures))

    # -- 5. hand kernels against their plain versions ------------------------
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def check(kernel, shape, dtype, got, want, tol=RTOL):
        errs = [tensor_err(x, y) for x, y in zip(got, want)]
        rel, mabs = max(e[0] for e in errs), max(e[1] for e in errs)
        emit({"phase": "hand", "kernel": kernel, "shape": list(shape),
              "dtype": dtype, "max_abs_err": mabs, "norm_rel_err": rel})
        if not rel <= tol:
            failures.append(f"hand {kernel} {shape} {dtype}: norm-relative "
                            f"error {rel:.3g} > {tol}")
        return mabs

    def kernel_tol(dt):
        return BF16_KERNEL_RTOL if dt == "bfloat16" else RTOL

    def repeat_bitwise(kernel, shape, dtype, first, again):
        """A second launch must give the same bits as the first."""
        same = all(torch.equal(bits(x), bits(y))
                   for x, y in zip(first, again))
        if not same:
            failures.append(f"hand {kernel} {shape} {dtype}: a second "
                            f"launch differs from the first")
        return same

    #: the timed hand kernels, by launch-counter name: shape, dtype, the
    #: wrapper, its plain version, a library call or None (with the
    #: tolerance it is held to against the wrapper), the bound and the
    #: error against the plain version
    hand_in: dict[str, dict] = {}
    #: K5 as a whole (split and combine), and K5 at LM_DECODE_ATTN's
    #: shape, timed on lines of their own
    whole_in: dict[str, dict] = {}
    #: the full-width inputs the ``ops`` path of phase 6 reuses
    hand_data: dict = {}
    alpha = torch.tensor(ALPHA, device="cuda")
    beta = torch.tensor(BETA, device="cuda")
    for shape in ((n2, n2), (4096, 6144), (1000, 1531)):
        m, n = shape
        A, p, r = randn(m, n), randn(n), randn(m)
        u1, u2, y, v1, v2, z = (randn(m), randn(m), randn(m), randn(n),
                                randn(n), randn(n))
        err = {
            "K2/bicgk": check("K2/bicgk", shape, "float32",
                              k2.bicgk(A, p, r), ref.bicgk(A, p, r)),
            "K3/gemver_k1": check(
                "K3/gemver_k1", shape, "float32",
                k3.gemver_k1(A, u1, v1, u2, v2, y),
                ref.gemver_k1(A, u1, v1, u2, v2, y)),
        }
        B, x, _ = ref.gemver(A, u1, v1, u2, v2, y, z, alpha, beta)
        err["K3/gemver_k2"] = check("K3/gemver_k2", shape, "float32",
                                    (k3.gemver_k2(B, x, alpha),),
                                    (ref.gemver_k2(B, x, alpha),))
        check("K3/gemver", shape, "float32",
              k3.gemver(A, u1, v1, u2, v2, y, z, alpha, beta),
              ref.gemver(A, u1, v1, u2, v2, y, z, alpha, beta))
        if shape == (n2, n2):
            k1_in = (A, u1, v1, u2, v2, y)
            w0 = torch.zeros(m, device="cuda")    # ignored at beta=0
            for kernel, wrapper, plain, lib in (
                    ("K2/bicgk", lambda a=(A, p, r): k2.bicgk(*a),
                     lambda a=(A, p, r): ref.bicgk(*a), None),
                    ("K3/gemver_k1", lambda a=k1_in: k3.gemver_k1(*a),
                     lambda a=k1_in: ref.gemver_k1(*a), None),
                    ("K3/gemver_k2", lambda a=(B, x, alpha): k3.gemver_k2(*a),
                     lambda a=(B, x, alpha): ref.gemver_k2(*a),
                     lambda a=(w0, B, x): torch.addmv(*a, beta=0,
                                                      alpha=ALPHA))):
                hand_in[kernel] = dict(
                    shape=shape, dtype="float32", wrapper=wrapper,
                    plain=plain, lib=lib, lib_tol=RTOL,
                    bound=hand_bound(kernel, shape), err=err[kernel])
    rms_norm = getattr(F, "rms_norm", None)
    for T, D, dt in ((*PREFILL, "float32"), (*PREFILL, "bfloat16"),
                     (1, n2, "float32"), (7, 33, "float32"),
                     (7, 33, "bfloat16"), (3, 20000, "bfloat16"),
                     (2, 8, "float32"), (2, 8, "bfloat16")):
        xx, g = randn(T, D, dtype=getattr(torch, dt)), randn(D)
        kernel = k4.NAMES[xx.dtype]
        got = k4.rmsnorm(xx, g)
        mabs = check(kernel, (T, D), dt, (got,), (ref.rmsnorm(xx, g),),
                     kernel_tol(dt))
        emit({"phase": "hand", "kernel": kernel, "shape": [T, D],
              "dtype": dt, **k4.plan(D, xx.dtype, xx.device),
              "repeat_bitwise": repeat_bitwise(kernel, (T, D), dt, (got,),
                                               (k4.rmsnorm(xx, g),))})
        del got
        if (T, D) == PREFILL:
            g_lib = g.to(xx.dtype)      # the library takes gamma in x's type
            hand_in[kernel] = dict(
                shape=(T, D), dtype=dt,
                wrapper=lambda xx=xx, g=g: k4.rmsnorm(xx, g),
                plain=lambda xx=xx, g=g: ref.rmsnorm(xx, g),
                lib=None if rms_norm is None else
                lambda xx=xx, g=g_lib, D=D: rms_norm(xx, (D,), g, eps=1e-6),
                lib_tol=BF16_RTOL if dt == "bfloat16" else RTOL,
                bound=hand_bound(kernel, (T, D)), err=mabs)

    # K5: each kernel against its own plain version, then the whole; the
    # split's configuration and chunks, and a bitwise repeat
    for shape, dt in ((DECODE, "bfloat16"), (DECODE, "float32"),
                      ((2, 16, 1, 256, 128), "float32"),
                      ((3, 12, 4, 1000, 80), "float32"),
                      ((3, 12, 4, 1000, 80), "bfloat16"),
                      (GRANITE_34B_DECODE, "bfloat16"),
                      (HYMBA_DECODE, "bfloat16"),
                      (LM_ATTN, "float32")):
        B, Hq, Hkv, S, d = shape
        tdt = getattr(torch, dt)
        q, kk, vv = (randn(B, Hq, d, dtype=tdt),
                     randn(B, S, Hkv, d, dtype=tdt),
                     randn(B, S, Hkv, d, dtype=tdt))
        split_name, comb_name = k5.NAMES[tdt]
        acc, mm, ll, length = k5.split(q, kk, vv)
        chunks = acc.shape[0] // (B * Hkv)
        o = k5.combine(acc, mm, ll, B, Hq, tdt)
        e_split = check(split_name, shape, dt, (acc, mm, ll),
                        ref.decode_attention_split(q, kk, vv, length))
        e_comb = check(comb_name, shape, dt, (o,),
                       (ref.decode_attention_combine(acc, mm, ll, B, Hq,
                                                     tdt),),
                       kernel_tol(dt))
        e_whole = check("K5", shape, dt, (k5.decode_attention(q, kk, vv),),
                        (ref.decode_attention(q, kk, vv),), kernel_tol(dt))
        again = k5.split(q, kk, vv)
        emit({"phase": "hand", "kernel": "K5", "shape": list(shape),
              "dtype": dt, "chunks": chunks, "chunk_len": length,
              **k5.config(Hq // Hkv, d, tdt, q.device),
              "repeat_bitwise": repeat_bitwise(
                  "K5", shape, dt, (acc, mm, ll, o),
                  (*again[:3], k5.combine(*again[:3], B, Hq, tdt)))})
        del again
        if shape not in (DECODE, LM_ATTN):
            continue
        b_split, b_comb, b_whole = k5_bounds(shape, dt, chunks)
        qkv, part = (q, kk, vv), (acc, mm, ll, B, Hq, tdt)
        whole = f"K5/split+combine_{SHORT[dt]}"
        timed = {
            split_name: dict(
                shape=shape, dtype=dt, chunks=chunks, chunk_len=length,
                wrapper=lambda a=qkv: k5.split(*a),
                plain=lambda a=qkv, n=length: ref.decode_attention_split(
                    *a, n),
                lib=None, bound=b_split, err=e_split),
            comb_name: dict(
                shape=shape, dtype=dt, chunks=chunks,
                wrapper=lambda a=part: k5.combine(*a),
                plain=lambda a=part: ref.decode_attention_combine(*a),
                lib=None, bound=b_comb, err=e_comb),
            whole: dict(
                shape=shape, dtype=dt, chunks=chunks,
                wrapper=lambda a=qkv: k5.decode_attention(*a),
                plain=lambda a=qkv: ref.decode_attention(*a),
                lib=lambda q=q, kk=kk, vv=vv: F.scaled_dot_product_attention(
                    q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2),
                    enable_gqa=True)[:, :, 0],
                lib_tol=BF16_RTOL if dt == "bfloat16" else RTOL,
                bound=b_whole, err=e_whole)}
        if shape == DECODE:     # the main shape: split and combine records
            whole_in[whole] = timed.pop(whole)
            hand_in.update(timed)
            hand_data["K5", dt] = qkv
        else:                   # LM_DECODE_ATTN's: lines only
            whole_in.update({f"{k} (LM_DECODE_ATTN)": e
                             for k, e in timed.items()})

    # K6: steps 3 and 7; p' against its plain version at the type's
    # tolerance, m' and v' (float32) at RTOL
    for n, dt in ((ADAMW_N, "float32"), (ADAMW_N, "bfloat16"),
                  (1_000_003, "float32"), (1_000_003, "bfloat16")):
        tdt = getattr(torch, dt)
        p, g = randn(n, dtype=tdt), randn(n, dtype=tdt)
        mm, vv = randn(n).mul_(0.1), randn(n).abs_().mul_(0.01)
        name = k6.NAMES[tdt]
        mabs = 0.0
        for step in (3, 7):
            got = k6.adamw_update(p, g, mm, vv, step=step, **K6_HYPERS)
            want = ref.adamw(p, g, mm, vv, step=step, **K6_HYPERS)
            mabs = max(mabs, check(name, (n,), dt, got[:1], want[:1],
                                   kernel_tol(dt)),
                       check(name, (n,), dt, got[1:], want[1:]))
            del got, want
        if n != ADAMW_N:
            continue
        args4 = (p, g, mm, vv)
        hand_in[name] = dict(
            shape=(n,), dtype=dt,
            wrapper=lambda a=args4: k6.adamw_update(*a, step=7,
                                                    **K6_HYPERS),
            plain=lambda a=args4: ref.adamw(*a, step=7, **K6_HYPERS),
            # the library keeps m and v in p's type: float32 only
            lib=fused_adamw_step(*args4, 7) if dt == "float32" else None,
            lib_tol=RTOL, bound=k6_bound(n, dt), err=mabs)
        hand_data["K6", dt] = args4

    # K7: per-row losses against the plain version, and their mean
    for (T, V), dt in ((XENT, "float32"), (XENT, "bfloat16"),
                       ((7, 1000), "float32"), ((33, 50257), "float32"),
                       ((33, 50257), "bfloat16")):
        tdt = getattr(torch, dt)
        logits = randn(T, V).mul_(3.0).to(tdt)
        labels = torch.randint(0, V, (T,), generator=gen, device="cuda")
        name = k7.NAMES[tdt]
        mabs = check(name, (T, V), dt,
                     (k7.softmax_xent_rows(logits, labels),),
                     (ref.softmax_xent_rows(logits, labels),))
        got, want = (float(k7.softmax_xent(logits, labels)),
                     float(ref.softmax_xent(logits, labels)))
        rel = abs(got - want) / abs(want)
        emit({"phase": "hand", "kernel": name, "shape": [T, V],
              "dtype": dt, "mean": got, "mean_rel_err": rel})
        if not rel <= MEAN_RTOL:
            failures.append(f"hand {name} {(T, V)} {dt}: mean loss "
                            f"relative error {rel:.3g} > {MEAN_RTOL}")
        if (T, V) != XENT:
            continue
        lg_lb = (logits, labels)
        hand_in[name] = dict(
            shape=(T, V), dtype=dt,
            wrapper=lambda a=lg_lb: k7.softmax_xent_rows(*a),
            plain=lambda a=lg_lb: ref.softmax_xent_rows(*a),
            lib=lambda a=lg_lb: F.cross_entropy(*a, reduction="none"),
            lib_tol=BF16_RTOL if dt == "bfloat16" else RTOL,
            bound=k7_bound(T, V, dt), err=mabs)
        hand_data["K7", dt] = lg_lb
    torch.cuda.synchronize()
    if failures:
        fail("; ".join(failures))

    # -- 6. the hand kernels' path through ops, counting launches -----------
    series_dev = {name: {k: torch.as_tensor(np.asarray(v)).cuda()
                         for k, v in inputs[name].items()} for name in SERIES}
    prefill = {dt: randn(*PREFILL, dtype=getattr(torch, dt))
               for dt in ("float32", "bfloat16")}
    gamma = randn(PREFILL[1])
    LAUNCHES.reset()
    hand_out = {name: hand_calls(name, series_dev[name])()
                for name in HANDED}
    prefill_out = {dt: ops.rmsnorm(x, gamma) for dt, x in prefill.items()}
    attn_out = ops.decode_attention(*hand_data["K5", "bfloat16"])
    adamw_out = ops.adamw_update(*hand_data["K6", "bfloat16"], step=7,
                                 **K6_HYPERS)
    xent_out = {dt: ops.softmax_xent(*hand_data["K7", dt])
                for dt in ("float32", "bfloat16")}
    torch.cuda.synchronize()
    hand_launches = dict(LAUNCHES.by_kernel)
    want_counts = {"K2/bicgk": 1, "K3/gemver_k1": 1, "K3/gemver_k2": 1,
                   "K4/rmsnorm_f32": 2, "K4/rmsnorm_bf16": 1,
                   "K5/split_f32": 1, "K5/combine_f32": 1,
                   "K5/split_bf16": 1, "K5/combine_bf16": 1,
                   "K6/adamw_f32": 1, "K6/adamw_bf16": 1,
                   "K7/xent_f32": 1, "K7/xent_bf16": 1}

    def hand_main(rec, got, want, tol):
        rel = max(tensor_err(x, y)[0] for x, y in zip(got, want))
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        shapes = all(x.shape == y.shape for x, y in zip(got, want))
        emit({"phase": "hand_main", **rec, "norm_rel_err": rel,
              "finite": finite})
        if not (rel <= tol and finite and shapes):
            failures.append(f"hand_main {rec}: error {rel:.3g}, finite "
                            f"{finite}, shapes {shapes}")

    for name in HANDED:
        ref64 = REGISTRY[name].reference(
            **{n: np.asarray(x, np.float64) for n, x in inputs[name].items()})
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        hand_main({"program": name, "n": size(name)}, hand_out[name],
                  [torch.from_numpy(np.asarray(r)).cuda() for r in ref64],
                  RTOL)
    for dt, x in prefill.items():
        x64, g64 = x.double(), gamma.double()
        want = x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + 1e-6) \
            * g64
        hand_main({"program": "rmsnorm", "shape": list(PREFILL),
                   "dtype": dt}, (prefill_out[dt],), (want,),
                  BF16_RTOL if dt == "bfloat16" else RTOL)
        if prefill_out[dt].dtype != x.dtype:
            failures.append(f"hand_main rmsnorm {dt}: output dtype "
                            f"{prefill_out[dt].dtype}")
    q, kk, vv = (t.double() for t in hand_data["K5", "bfloat16"])
    B, Hq, Hkv, S, d = DECODE
    w = torch.softmax(torch.einsum(
        "bhgd,bshd->bhgs", q.reshape(B, Hkv, Hq // Hkv, d), kk) / d ** 0.5,
        dim=-1)
    want = torch.einsum("bhgs,bshd->bhgd", w, vv).reshape(B, Hq, d)
    hand_main({"program": "decode_attention", "shape": list(DECODE),
               "dtype": "bfloat16"}, (attn_out,), (want,), BF16_RTOL)
    del q, kk, vv, w, want
    p, g, mm, vv = (t.double() for t in hand_data["K6", "bfloat16"])
    H = K6_HYPERS
    m2 = H["beta1"] * mm + (1 - H["beta1"]) * g
    v2 = H["beta2"] * vv + (1 - H["beta2"]) * g * g
    p2 = p - H["lr"] * ((m2 / (1 - H["beta1"] ** 7))
                        / (torch.sqrt(v2 / (1 - H["beta2"] ** 7)) + H["eps"])
                        + H["weight_decay"] * p)
    hand_main({"program": "adamw_update", "shape": [ADAMW_N],
               "dtype": "bfloat16", "output": "p"}, adamw_out[:1], (p2,),
              BF16_RTOL)
    hand_main({"program": "adamw_update", "shape": [ADAMW_N],
               "dtype": "bfloat16", "output": "m, v"}, adamw_out[1:],
              (m2, v2), RTOL)
    del p, g, mm, vv, m2, v2, p2
    for dt, mean in xent_out.items():
        logits, labels = hand_data["K7", dt]
        rows = torch.cat([torch.logsumexp(c.double(), dim=-1)
                          for c in logits.split(1024)])
        rows -= torch.gather(logits, 1, labels[:, None])[:, 0].double()
        want = float(rows.mean())
        rel = abs(float(mean) - want) / abs(want)
        emit({"phase": "hand_main", "program": "softmax_xent",
              "shape": list(XENT), "dtype": dt, "mean_rel_err": rel})
        if not rel <= MEAN_RTOL:
            failures.append(f"hand_main softmax_xent {dt}: mean loss "
                            f"relative error {rel:.3g} > {MEAN_RTOL}")
    emit({"phase": "hand_main", "launches": hand_launches})
    if hand_launches != want_counts:
        failures.append(f"hand_main: launch counts {hand_launches}, want "
                        f"{want_counts}")
    if failures:
        fail("; ".join(failures))

    # -- 7. serving: one request a call, graph replay beside eager ------------
    for mode in MODES:
        res = serve_blas(argparse.Namespace(
            blas="GEMVER", n=n2, requests=args.requests, mode=mode,
            backend="cuda", device="cuda", seed=0, autotune=False,
            refit=False, budget=args.budget))
        p, a = progs[("GEMVER", mode)], dev_inputs[("GEMVER", mode)]
        replay_ms = device_ms(lambda: p.run(*a))
        eager_ms = device_ms(lambda: p.fn(*a))
        kernels_ms, how = graph_ms(lambda: p.fn(*a))
        emit({"phase": "serve", "program": "GEMVER", "n": n2,
              "mode": mode, "requests": args.requests,
              "us_per_request": res["us_per_request"],
              "eager_us_per_request": res["eager_us_per_request"],
              "device_us": replay_ms * 1e3,
              "eager_device_us": eager_ms * 1e3,
              "kernels_device_us": kernels_ms * 1e3, "kernels_timed_by": how,
              "kernel_launches": res["kernel_launches"],
              "eager_kernel_launches": res["eager_kernel_launches"],
              "groups": res["n_groups"]})
        for key in ("kernel_launches", "eager_kernel_launches"):
            if res[key] != args.requests * res["n_groups"]:
                failures.append(f"serve GEMVER/{mode}: {res[key]} {key}")
    if failures:
        fail("; ".join(failures))

    #: kernel records of the engine and float16 paths, for the last line
    path_records = []

    # -- 8. the engine: a mixed stream, batched, packed, replayed ------------
    t0 = time.perf_counter()
    host_in = [make_inputs(REGISTRY[s_], n, seed=args.seed + 1000 + i)
               for i, (s_, n) in enumerate(stream)]
    reqs = [(s_, n, {k: torch.as_tensor(np.asarray(v)).cuda()
                     for k, v in env.items()})
            for (s_, n), env in zip(stream, host_in)]
    t_inputs = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s_ in sorted({s_ for s_, _ in stream}):
        engine.warm(s_, [n for t, n in stream if t == s_], trace_packs=False)
    engine.warm_packs()
    t_warm = time.perf_counter() - t0

    def serve_stream(eng, rate_hz=None):
        """Results of the stream, in stream order: one drain, or (with a
        rate) as many as the arrivals make."""
        base = eng._rid
        out = [None] * len(reqs)
        for r in eng.serve(reqs, rate_hz=rate_hz):
            out[r.rid - base] = r
        return out

    # two drains make the stream's own pack compositions and staging
    # sets warm (seen, then captured); the third is measured and counted
    serve_stream(engine)
    serve_stream(engine)
    torch.cuda.synchronize()
    n_disp0, n_pack0 = engine.n_dispatches, engine.n_packed_dispatches
    n_members0 = engine.n_packed_members
    caps0 = sum(p.replays.n_captures for p in engine_progs.values()
                if p.replays is not None)
    LAUNCHES.reset()
    t0 = time.perf_counter()
    results = serve_stream(engine)
    t_serve = time.perf_counter() - t0
    eng_launches = dict(LAUNCHES.by_kernel)
    caps1 = sum(p.replays.n_captures for p in engine_progs.values()
                if p.replays is not None)
    n_disp = engine.n_dispatches - n_disp0
    n_pack = engine.n_packed_dispatches - n_pack0
    n_members = engine.n_packed_members - n_members0
    waits = sorted(r.queue_wait_s for r in results)
    lat = sorted(r.latency_s for r in results)

    # a result held across the next drain keeps its bits
    held = [tuple(o.clone() for o in r.outputs) for r in results]
    serve_stream(engine)
    torch.cuda.synchronize()
    held_ok = all(torch.equal(bits(o), bits(c)) for r, h in
                  zip(results, held) for o, c in zip(r.outputs, h))
    del held
    # open loop: the stream arriving at OPEN_LOOP_HZ, drained as it
    # comes, every result kept to the end.  Results are copies, so no
    # graph is held: no call runs eagerly for want of a free graph, no
    # input set has a second graph, and every result keeps the bits of
    # the closed-loop drain (a batch gives the bits of single requests)
    held0 = engine.stats()["graph_held_calls"]
    disp_open0 = engine.n_dispatches
    t0 = time.perf_counter()
    open_res = serve_stream(engine, rate_hz=OPEN_LOOP_HZ)
    t_open = time.perf_counter() - t0
    torch.cuda.synchronize()
    open_st = engine.stats()
    open_ok = (open_st["graph_held_calls"] == held0
               and open_st["graphs_per_input_set"] == 1
               and all(torch.equal(bits(o), bits(c)) for r, q in
                       zip(results, open_res)
                       for o, c in zip(r.outputs, q.outputs)))
    del open_res
    # every request's unpadded output against float64 numpy, and the
    # batched (and packed) replay against single-request eager launches
    refs64 = []
    for (s_, n), env in zip(stream, host_in):
        ref64 = REGISTRY[s_].reference(
            **{k: np.asarray(v, np.float64) for k, v in env.items()})
        refs64.append(ref64 if isinstance(ref64, tuple) else (ref64,))
    # every output is held to RTOL of its own norm; a sum whose terms
    # cancel (CANCELLING) to RTOL of the sum of its terms' magnitudes
    # instead, the scale of its float32 rounding: AXPYDOT's r over 10**6
    # terms of ~1 can cancel to 10**-3 and keep no float32 digits
    singles, rel_max, cancel_max, single_ok = {}, 0.0, 0.0, True
    for i, ((s_, n), ref64, r) in enumerate(zip(stream, refs64, results)):
        for j, (o, w) in enumerate(zip(r.outputs, ref64)):
            got = o.cpu().numpy().astype(np.float64)
            if (s_, j) in CANCELLING:
                scale = CANCELLING[s_, j](**{
                    k: np.asarray(v, np.float64)
                    for k, v in host_in[i].items()})
                rel = float(np.linalg.norm(np.ravel(got - w))) / scale
                cancel_max = max(cancel_max, rel)
            else:
                rel = norm_rel(got, w)
                rel_max = max(rel_max, rel)
            if not (rel <= RTOL and tuple(o.shape) == np.shape(w)):
                failures.append(f"engine {s_} n={n} output {j}: error "
                                f"{rel:.3g}")
        key = (s_, r.bucket)
        script, shapes, pads, masked = engine._compile_specs(*key)
        if key not in singles:
            singles[key] = engine.compiler.compile(script, shapes)
        one = singles[key]
        padded = {}
        for name, shape in shapes.items():
            v = one.graph.inputs[one.plan.input_names.index(name)]
            if masked and name == MASK_INPUT:
                padded[name] = torch.from_numpy(mask_row(shape[0], n)).cuda()
                continue
            t = torch.full(shape, float(pads[name]), device="cuda",
                           dtype=torch_dtype(v.dtype))
            x = reqs[i][2][name]
            t[tuple(slice(d) for d in x.shape)] = x
            padded[name] = t
        outs = one.fn(*one.prepare(**padded))
        for o, w in zip(r.outputs, outs):
            w = w[tuple(slice(n) if d == r.bucket else slice(None)
                        for d in w.shape)]
            single_ok &= torch.equal(bits(o), bits(w))
    # the packed dispatches against the same stream unpacked
    unpacked = serve_stream(ServingEngine(
        engine.compiler, max_batch=ENGINE_BATCH, min_bucket=64,
        registry=REGISTRY, max_pack=1))
    packed_ok = all(torch.equal(bits(o), bits(u)) for r, q in
                    zip(results, unpacked) for o, u in zip(r.outputs,
                                                            q.outputs))
    del unpacked
    # a graph replay against the eager run of the same staged batch
    replay_ok = True
    for (s_, b), prog in engine_progs.items():
        stage = engine._staging[(s_, b, max(bs for s2, b2, bs in
                                            engine._staging
                                            if (s2, b2) == (s_, b)))]
        ins = [stage[v.name] for v in prog.graph.inputs]
        eager = prog.fn(*ins)
        replayed = prog.run(*ins)
        replay_ok &= all(torch.equal(bits(x), bits(y))
                         for x, y in zip(eager, replayed))
    torch.cuda.synchronize()
    used = {fn.__self__.name for k, p in engine_progs.items()
            for fn in p.group_fns}
    never = sorted(k for k in used if not eng_launches.get(k))
    emit({"phase": "engine", "requests": len(stream),
          "max_batch": ENGINE_BATCH, "max_pack": ENGINE_PACK,
          "programs": [f"{s_}/{b}" for s_, b in engine_keys],
          "n_dispatches": n_disp, "n_packed_dispatches": n_pack,
          "n_packed_members": n_members,
          "us_per_request": t_serve / len(stream) * 1e6,
          "serve_s": t_serve, "warm_s": t_warm, "inputs_s": t_inputs,
          "queue_wait_p50_ms": waits[len(waits) // 2] * 1e3,
          "queue_wait_p99_ms": waits[min(len(waits) - 1,
                                         int(len(waits) * 0.99))] * 1e3,
          "latency_p50_ms": lat[len(lat) // 2] * 1e3,
          "captures_in_drain": caps1 - caps0,
          "open_loop_hz": OPEN_LOOP_HZ, "open_loop_s": t_open,
          "open_loop_dispatches": open_st["n_dispatches"] - disp_open0,
          "graph_captures": open_st["graph_captures"],
          "graph_held_calls": open_st["graph_held_calls"],
          "graphs_per_input_set": open_st["graphs_per_input_set"],
          "gpu_reserved_gib": torch.cuda.memory_reserved() / 2**30,
          "launches": sum(eng_launches.values()),
          "kernels_launched": len(eng_launches),
          "max_norm_rel_err": rel_max, "max_cancelling_err": cancel_max,
          "batched_vs_single_bitwise": single_ok,
          "packed_vs_unpacked_bitwise": packed_ok,
          "replay_vs_eager_bitwise": replay_ok,
          "held_result_unchanged": held_ok})
    for ok, what in ((single_ok, "a batched result differs from its "
                      "single-request launches"),
                     (packed_ok, "a packed dispatch differs from the "
                      "unpacked one"),
                     (replay_ok, "a graph replay differs from the eager "
                      "run"),
                     (held_ok, "a held result changed in the next drain"),
                     (caps1 == caps0, f"the measured drain captured "
                      f"{caps1 - caps0} graphs"),
                     (open_ok, "the open-loop run held a graph, captured "
                      "a second one for an input set, or changed a "
                      "result's bits"),
                     (not never, f"kernels never launched: {never}")):
        if not ok:
            failures.append(f"engine: {what}")
    if failures:
        fail("; ".join(failures))
    # -- sharded: the same stream over a replica mesh -----------------------
    sharded_phase(engine, reqs, results, t_serve / len(stream) * 1e6,
                  failures, smi_line)
    del results
    if failures:
        fail("; ".join(failures))

    # each engine kernel on one staged batch of its key's requests:
    # against the group's plain batched version (the dense group function,
    # request by request), then timed
    for (s_, b), prog in engine_progs.items():
        chunk = [i for i, (t, n) in enumerate(stream)
                 if (t, engine.bucket_of(n)) == (s_, b)][:ENGINE_BATCH]
        nb = 1 << (len(chunk).bit_length() - 1)
        stage = engine._assemble(
            [Request(rid=i, sequence=s_, n=stream[i][1], inputs=reqs[i][2])
             for i in chunk[:nb]], s_, b, nb)
        vals = {v.name: stage[v.name] for v in prog.graph.inputs}
        outs_so_far = []
        for gp, fn, im in zip(prog.plan.groups, prog.group_fns,
                              prog.group_impls):
            gk = fn.__self__
            a = [vals[r[1]] if r[0] == "input" else outs_so_far[r[1]][r[2]]
                 for r in gp.inputs]
            got = gk.batched(*a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = _batched_dense_fn(im.fusion)(*a)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3
            rel = max(tensor_err(x, y)[0] for x, y in zip(got, want))
            mabs = max(tensor_err(x, y)[1] for x, y in zip(got, want))
            if not rel <= RTOL:
                failures.append(f"engine kernel {gk.name}: norm-relative "
                                f"error {rel:.3g} against its plain version")
            raw, ws = gk.buffers(a[0].device, nb)
            ms, how = graph_ms(lambda: gk.launch_into(a, raw, ws, nb))
            lib = library_call(im, a, batched=True)
            lib_ms = None
            if lib is not None:
                lib_err = tensor_err(lib(), got[0])[0]
                if not lib_err <= RTOL:
                    failures.append(f"library call for {gk.name} disagrees "
                                    f"with the kernel: {lib_err:.3g}")
                lib_ms = graph_ms(lib)[0]
            b_ms, b_by = bound(im)
            rec = {"name": gk.name, "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES,
                   "launches": eng_launches.get(gk.name, 0),
                   "max_abs_err": mabs, "ms": ms, "plain_ms": plain,
                   "bound_ms": nb * b_ms, "bound_by": b_by,
                   "library_ms": lib_ms}
            path_records.append(rec)
            emit({"phase": "time", "path": "engine", **rec,
                  "program": f"{s_}/{b}", "batch": nb, "timed_by": how,
                  "norm_rel_err": rel, "bound_share": nb * b_ms / ms,
                  "units": [ph.units for ph in gk.layout.phases],
                  "slices": [ph.S for ph in gk.layout.phases]})
            outs_so_far.append(want)
    if failures:
        fail("; ".join(failures))

    # -- 9. float16 through K1 ------------------------------------------------
    inputs16 = {name: fp16_inputs(name, size(name), seed=0) for name in FP16}
    dev16 = {k: progs16[k].prepare(**inputs16[k[0]]) for k in keys16}
    LAUNCHES.reset()
    outs16 = {k: progs16[k].fn(*dev16[k]) for k in keys16}
    torch.cuda.synchronize()
    launches16 = dict(LAUNCHES.by_kernel)
    for k in keys16:
        name, mode = k
        prog = progs16[k]
        ref64 = REGISTRY[name].reference(
            **{n: np.asarray(x, np.float64) for n, x in
               inputs16[name].items()})
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        errs = [norm_rel(x.float().cpu().numpy(), r)
                for x, r in zip(outs16[k], ref64)]
        finite = all(bool(torch.isfinite(x).all()) for x in outs16[k])
        counts = [launches16.get(fn.name, 0) for fn in prog.group_fns]
        dev_ms, how = graph_ms(lambda p=prog, a=dev16[k]: p.fn(*a))
        b_ms = sum(bound(im)[0] for im in prog.group_impls)
        emit({"phase": "fp16", "program": name, "mode": mode,
              "n": size(name), "groups": prog.n_groups, "launches": counts,
              "norm_rel_err": max(errs), "finite": finite,
              "device_us": dev_ms * 1e3, "timed_by": how,
              "bound_us": b_ms * 1e3, "bound_share": b_ms / dev_ms})
        if not (max(errs) <= FP16_RTOL and finite):
            failures.append(f"fp16 {name}/{mode}: error {max(errs):.3g}, "
                            f"finite {finite}")
        if counts != [1] * prog.n_groups:
            failures.append(f"fp16 {name}/{mode}: launch counts {counts}")
        outs_so_far = []
        for gp, fn, im in zip(prog.plan.groups, prog.group_fns,
                              prog.group_impls):
            a = group_args(prog, outs_so_far, gp, dev16[k])
            got = fn.launch(*a)
            torch.cuda.synchronize()
            # the plain version computes in float32 and rounds to float16
            # where the kernel stores, so the two differ only where an
            # output's rounding flips
            t0 = time.perf_counter()
            want = tiled_reference(prog.graph, im, *a)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3
            rel = max(tensor_err(x, y)[0] for x, y in zip(got, want))
            mabs = max(tensor_err(x, y)[1] for x, y in zip(got, want))
            if not (rel <= FP16_KERNEL_RTOL
                    and all(x.dtype == torch.float16 for x in got)):
                failures.append(f"fp16 kernel {fn.name}: norm-relative "
                                f"error {rel:.3g} against its plain version")
            raw, ws = fn.buffers(a[0].device)
            ms, how = graph_ms(lambda: fn.launch_into(a, raw, ws))
            b_ms, b_by = bound(im)
            rec = {"name": fn.name, "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES,
                   "launches": launches16.get(fn.name, 0),
                   "max_abs_err": mabs, "ms": ms, "plain_ms": plain,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            path_records.append(rec)
            emit({"phase": "time", "path": "fp16", **rec, "timed_by": how,
                  "norm_rel_err": rel, "bound_share": b_ms / ms,
                  "units": [ph.units for ph in fn.layout.phases],
                  "slices": [ph.S for ph in fn.layout.phases]})
            outs_so_far.append(got)
    if failures:
        fail("; ".join(failures))

    # -- 10. the series: compiler, hand, torch backend, library -------------
    series_bounds = {
        "GEMVER": {k: hand_bound(k, (n2, n2))[0]
                   for k in ("K3/gemver_k1", "K3/gemver_k2")},
        "BiCGK": {"K2/bicgk": hand_bound("K2/bicgk", (n2, n2))[0]},
        # no hand kernel: the program's own bound (w, v, u read; z written)
        "AXPYDOT": {"program": bound_of(16 * args.n1, 4 * args.n1)[0]},
        "LM_RMSNORM": {"K4/rmsnorm_f32":
                       hand_bound("K4/rmsnorm_f32", (1, n2))[0]},
        "LM_DECODE_ATTN": {"K5": k5_bounds((1, 1, 1, args.n_attn, 48),
                                           "float32", 1)[2][0]},
        "FUSED_ADAMW": {"K6/adamw_f32": k6_bound(args.n1, "float32")[0]},
    }
    for name in SERIES:
        tprog = FusionCompiler(backend="torch", device="cuda",
                               cache=PlanCache()).compile(
            REGISTRY[name].script, REGISTRY[name].shapes(size(name)))
        t_in = tprog.prepare(**inputs[name])
        d = series_dev[name]
        # the compiler's programs as their callers run them (a CUDA graph
        # replay each), and `best` eager (a Python call a group) beside
        runs = {
            "compiler_best": lambda p=progs[(name, "best")],
            a=dev_inputs[(name, "best")]: p.run(*a),
            "compiler_best_eager": lambda p=progs[(name, "best")],
            a=dev_inputs[(name, "best")]: p.fn(*a),
            "compiler_unfused": lambda p=progs[(name, "unfused")],
            a=dev_inputs[(name, "unfused")]: p.run(*a),
            "torch": lambda p=tprog, a=t_in: p.run(*a),
        }
        if name in HANDED:
            runs["hand"] = hand_calls(name, d)
        if name == "FUSED_ADAMW":       # the port's optimizer entry point
            runs["optim_fused"] = lambda d=d: fused_adamw_update(
                d["p"], d["grad"], d["m"], d["v"], step=3, **K6_HYPERS)
        lib = library_sequence(name, d)
        if lib is not None:
            runs["library_seq"] = lib
        want = runs["torch"]()
        rec = {"phase": "series", "program": name, "n": size(name),
               "groups_best": progs[(name, "best")].n_groups}
        for key, fn in runs.items():
            got = fn()
            rel = max(tensor_err(x, y)[0] for x, y in zip(got, want))
            rec[f"{key}_norm_rel_err"] = rel
            if not rel <= RTOL:
                failures.append(f"series {name} {key}: disagrees with the "
                                f"torch backend, {rel:.3g}")
        for key, fn in runs.items():
            rec[f"{key}_us"] = time_ms(fn) * 1e3
            ms, how = graph_ms(fn)
            rec[f"{key}_device_us"] = ms * 1e3
            if how != "graph":
                rec[f"{key}_timed_by"] = how
        for key in ("hand", "library_seq"):
            if key not in runs:
                rec[f"{key}_us"] = rec[f"{key}_device_us"] = None
        rec["hand_bound_us"] = {k: ms * 1e3
                                for k, ms in series_bounds[name].items()}
        emit(rec)
    if failures:
        fail("; ".join(failures))

    # -- 11. times -----------------------------------------------------------
    def time_k1(fn, graph, im, a, out, err, launches, **extra):
        """The time record of one K1 group (``out``: its outputs on
        ``a``), emitted as a ``time`` line with ``extra``."""
        raw, ws = fn.buffers(a[0].device)
        ms, how = graph_ms(lambda: fn.launch_into(a, raw, ws))
        wrapper_ms = time_ms(lambda: fn.launch(*a))
        plain_ms = time_ms(lambda: tiled_reference(graph, im, *a),
                           max_reps=1, warmup=False)
        lib = library_call(im, a)
        lib_ms = lib_err = None
        if lib is not None:
            lib_err = norm_rel(lib().cpu().numpy(), out[0].cpu().numpy())
            if not lib_err <= RTOL:
                failures.append(f"library call for {fn.name} disagrees "
                                f"with the kernel: {lib_err:.3g}")
            lib_ms = graph_ms(lib)[0]
        b_ms, b_by = bound(im)
        rec = {"name": fn.name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES, "launches": launches.get(fn.name, 0),
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        emit({"phase": "time", **extra, **rec, "timed_by": how,
              "wrapper_ms": wrapper_ms, "library_norm_rel_err": lib_err,
              "grid": list(im.grid), "blocks": list(im.blocks),
              "units": [ph.units for ph in fn.layout.phases],
              "slices": [ph.S for ph in fn.layout.phases],
              "bound_share": b_ms / ms})
        return rec

    records = []
    for k in keys:
        for fn in progs[k].group_fns:
            prog, im, a = group_in[fn.name]
            records.append(time_k1(fn, prog.graph, im, a, kernel_out[fn.name],
                                   kernel_err[fn.name], launches))

    def tensors_of(x):
        return tuple(t for t in (x if isinstance(x, tuple) else (x,))
                     if isinstance(t, torch.Tensor))

    def time_hand(kernel, e):
        """The time record of one hand-kernel entry."""
        ms, how = graph_ms(e["wrapper"])
        wrapper_ms = time_ms(e["wrapper"])
        plain_ms = time_ms(e["plain"])
        lib_ms = lib_err = None
        extra_how = {}
        if e["lib"] is not None:
            lib_err = max(tensor_err(x, y)[0] for x, y in
                          zip(tensors_of(e["lib"]()),
                              tensors_of(e["wrapper"]())))
            if not lib_err <= e["lib_tol"]:
                failures.append(f"library call for {kernel} disagrees with "
                                f"the kernel: {lib_err:.3g}")
            lib_ms, lib_how = graph_ms(e["lib"])
            extra_how = {} if lib_how == "graph" else {
                "library_timed_by": lib_how}
        b_ms, b_by = e["bound"]
        source, replaces = HAND[kernel.split(" ")[0].replace(
            "split+combine", "split")]
        rec = {"name": kernel, "route": "cuda", "source": source,
               "replaces": replaces, "launches": hand_launches.get(kernel, 0),
               "max_abs_err": e["err"], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        extra = {k: e[k] for k in ("chunks", "chunk_len") if k in e}
        emit({"phase": "time", **rec, "shape": list(e["shape"]),
              "dtype": e["dtype"], "timed_by": how, **extra_how,
              "wrapper_ms": wrapper_ms,
              "library_norm_rel_err": lib_err, "bound_share": b_ms / ms,
              **extra})
        return rec

    for kernel, e in hand_in.items():
        records.append(time_hand(kernel, e))
    for kernel, e in whole_in.items():
        time_hand(kernel, e)
    if failures:
        fail("; ".join(failures))

    # -- 12. calibrate: the card's constants for the cost model -------------
    cal_cache = PlanCache()
    t0 = time.perf_counter()
    hw_cal = autotune.calibrate_hardware("cuda", cache=cal_cache)
    cal_rec = cal_cache.get_measurement(autotune.calibration_key("cuda"))
    emit({"phase": "calibrate", "nvidia_smi": smi_line, "name": hw_cal.name,
          "hbm_bw": hw_cal.hbm_bw,
          "launch_overhead_s": hw_cal.launch_overhead_s,
          "peak_flops": hw_cal.peak_flops,
          "unrounded": cal_rec.get("unrounded"),
          "bw_sweep": cal_rec.get("bw_sweep"),
          "seconds": time.perf_counter() - t0})
    if not all(math.isfinite(x) and x > 0 for x in
               (hw_cal.hbm_bw, hw_cal.launch_overhead_s, hw_cal.peak_flops)):
        fail(f"calibrate: constants not finite and positive: {hw_cal}")

    # -- 13. autotune: every program, measured on the card -------------------
    at_cache = PlanCache()
    cc_at = FusionCompiler(hw="calibrate", backend="cuda", device="cuda",
                           cache=at_cache, autotune_budget=args.budget)
    # build every candidate group of every program at once, one nvcc a
    # distinct source, so each pass finds its kernels built
    traces = {name: cc_at.trace(REGISTRY[name].script,
                                REGISTRY[name].shapes(size(name)))
              for name in names}
    t0 = time.perf_counter()
    sources = set()
    for name, g in traces.items():
        for combo in scheduler.enumerate_combinations(cc_at.space(g),
                                                      limit=args.budget):
            sources |= {autotune.group_source(g, im) for im in combo.impls}
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        for fut in [pool.submit(_build.build, src) for src in sources]:
            fut.result()
    emit({"phase": "autotune_build", "sources": len(sources),
          "build_s": time.perf_counter() - t0})
    winners, at_lines = {}, {}
    LAUNCHES.reset()
    for name in names:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        winners[name] = cc_at.compile(REGISTRY[name].script,
                                      REGISTRY[name].shapes(size(name)),
                                      mode="autotune",
                                      label=f"autotune/{name}")
        rep_ = cc_at.last_autotune
        at_lines[name] = {
            "phase": "autotune", "program": name, "n": size(name),
            "budget": args.budget, "winner_rank": rep_.winner_index,
            "candidates": [{"rank_pred": c.rank_pred, "t_pred": c.t_pred,
                            "t_meas": c.t_meas, "groups": c.n_groups}
                           for c in rep_.candidates],
            "n_groups_measured": rep_.n_groups_measured,
            "n_groups_cached": rep_.n_groups_cached,
            "build_s": rep_.build_s, "pass_s": time.perf_counter() - t0,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_allocated_before": held}
        if rep_.winner.t_meas > rep_.candidates[0].t_meas:
            failures.append(f"autotune {name}: the winner's t_meas is above "
                            f"candidate 0's")
    measure_launches = dict(LAUNCHES.by_kernel)
    if not any(k.startswith("autotune[") and v > 0
               for k, v in measure_launches.items()):
        failures.append("autotune: no group was launched to be measured")
    # the winners' kernels (most are best's, built in phase 1)
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        for fut in [pool.submit(p.module.build) for p in winners.values()]:
            fut.result()
    at_inputs = {name: winners[name].prepare(**inputs[name])
                 for name in names}
    LAUNCHES.reset()
    at_outs = {name: winners[name].fn(*at_inputs[name]) for name in names}
    torch.cuda.synchronize()
    at_launches = dict(LAUNCHES.by_kernel)
    for name in names:
        prog = winners[name]
        ref64 = REGISTRY[name].reference(
            **{n: np.asarray(x, np.float64) for n, x in inputs[name].items()})
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        err = max(norm_rel(x.cpu().numpy(), r)
                  for x, r in zip(at_outs[name], ref64))
        counts = [at_launches.get(fn.name, 0) for fn in prog.group_fns]
        # both replays and the summed group times by one timer at one
        # discipline (``replay_s``, ``GROUP_INNER`` calls a graph)
        win_ms = replay_s(lambda p=prog, a=at_inputs[name]: p.fn(*a),
                          inner=autotune.GROUP_INNER,
                          reps=autotune.MEAS_REPS) * 1e3
        best_ms = replay_s(lambda p=progs[(name, "best")],
                           a=dev_inputs[(name, "best")]: p.fn(*a),
                           inner=autotune.GROUP_INNER,
                           reps=autotune.MEAS_REPS) * 1e3
        sum_ms = at_lines[name]["candidates"][
            at_lines[name]["winner_rank"]]["t_meas"] * 1e3
        emit({**at_lines[name], "winner_groups": prog.n_groups,
              "launches": counts, "norm_rel_err": err,
              "winner_replay_ms": win_ms, "best_replay_ms": best_ms,
              "winner_vs_best": win_ms / best_ms,
              "winner_sum_group_ms": sum_ms,
              "sum_vs_replay": sum_ms / win_ms})
        if not err <= RTOL:
            failures.append(f"autotune {name}: winner's error {err:.3g}")
        if counts != [1] * prog.n_groups:
            failures.append(f"autotune {name}: launch counts {counts}")
    # the winners' groups on the kernels line
    for name in names:
        prog = winners[name]
        outs_so_far = []
        for gp, fn, im in zip(prog.plan.groups, prog.group_fns,
                              prog.group_impls):
            a = group_args(prog, outs_so_far, gp, at_inputs[name])
            got = fn.launch(*a)
            want = tiled_reference(prog.graph, im, *a)
            torch.cuda.synchronize()
            rel = max(tensor_err(x, y)[0] for x, y in zip(got, want))
            mabs = max(float((x - y).abs().max()) for x, y in zip(got, want))
            if not rel <= RTOL:
                failures.append(f"autotune kernel {fn.name}: error {rel:.3g} "
                                f"against its plain version")
            path_records.append(time_k1(fn, prog.graph, im, a, got, mabs,
                                        at_launches, path="autotune",
                                        norm_rel_err=rel))
            outs_so_far.append(want)
    # a second pass against the same cache measures nothing
    for name in names:
        cc_at.search(cc_at.space(traces[name]), "autotune")
        rep_ = cc_at.last_autotune
        emit({"phase": "autotune_warm", "program": name,
              "n_groups_measured": rep_.n_groups_measured,
              "n_measured": rep_.n_measured,
              "group_table_hit_rate": rep_.group_table_hit_rate,
              "winner_rank": rep_.winner_index})
        if rep_.n_groups_measured or rep_.group_table_hit_rate != 1.0 \
                or rep_.winner_index != at_lines[name]["winner_rank"]:
            failures.append(f"autotune_warm {name}: measured "
                            f"{rep_.n_groups_measured} groups, hit rate "
                            f"{rep_.group_table_hit_rate:.2f}")
    hw_before = cc_at.hw
    cc_at.refit_hardware()
    constants = ("name", "hbm_bw", "peak_flops", "f32_scale",
                 "launch_overhead_s")
    emit({"phase": "refit", "records": len(at_cache.group_records()),
          "before": {k: getattr(hw_before, k) for k in constants},
          "after": {k: getattr(cc_at.hw, k) for k in constants}})
    if failures:
        fail("; ".join(failures))
    winner_plans = {name: (p.plan, p.graph) for name, p in winners.items()}
    del winners, at_inputs, at_outs

    # -- 14. verify: the full verifier over every plan, and one heal -------
    n_plans = n_err = 0
    for k in keys:
        diags = verify_plan(progs[k].plan, progs[k].graph, hw=cc.hw)
        n_plans += 1
        n_err += sum(d.is_error for d in diags)
    for plan, g in winner_plans.values():
        diags = verify_plan(plan, g, hw=hw_before)
        n_plans += 1
        n_err += sum(d.is_error for d in diags)
    heal = heal_corrupt_plan(FusionCompiler, PlanCache, REGISTRY, make_inputs,
                             args.n1)
    emit({"phase": "verify", "plans": n_plans, "errors": n_err, **heal})
    if n_err or not heal["healed"]:
        fail(f"verify: {n_err} errors over {n_plans} plans, heal {heal}")


    emit({"kernels": records + path_records + lm_recs})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
