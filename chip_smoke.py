#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each, any failed check raises (non-zero exit):

1. the card: ``nvidia-smi`` name and power limit;
2. the kernel build from ``horovod_tpu_torch/csrc`` (nvcc, sm_90a);
3. K1, the flash-attention forward kernel, against its plain PyTorch
   version at the GPT-2-small path shape (B=4, S=2048, H=12, D=64, bf16,
   causal, q/k/v as strided views of one qkv tensor) and at two small
   shapes, causal and not: D=64 (B=2, S=200, H=2) with a padded mask and
   one fully masked sequence, and D=128 (B=2, S=320, H=2) with and without
   that mask; o and lse bitwise-equal over two launches at the path shape;
   kernel, plain and library (scaled_dot_product_attention, a yardstick
   the port never calls) times from CUDA events, achieved TFLOP/s and the
   share of the bound;
4. K2, the two backward kernels, against autograd of the plain version on
   the same shapes, dq, dk and dv bitwise-equal over two launches; times,
   TFLOP/s and shares of each kernel and of the pair, beside the aten flash
   backward (``library_pair_ms``) and the function's own 5-product bound;
5. K3 and K4, the fused BN + ReLU + 1x1-conv + stats kernels (x- and
   w-stationary), against their plain PyTorch version at the four ResNet-50
   stage shapes at B=256, 224x224, at the ragged M=300, Cin 64 -> 256
   (beta shifted there so that padding rows entering the stats would
   show) and at shapes on the edges of the kernels' tiles, among them
   four where each persistent block walks several row tiles and the last
   ends on a ragged one, two shaped for K3's grid and two for K4's (y, s1,
   s2 at the JAX tests' tolerances), with bitwise-equal stats over two
   launches; both kernels' grids; kernel, plain and library (the bf16
   product alone, ``torch.matmul``) times, TFLOP/s, GB/s and shares of the
   bound at the path shape (stage 1), and K4's x re-reads, what its
   schedule would move if no re-read came from L2, and its time on the
   same walk with all of those bytes compulsory;
6. the GPT-2 slice: ``hvd.init()`` (NCCL), ``create_mesh({"dp": 1})``,
   GPT-2-small (12 x 768, vocab 50257) with flash attention and bf16
   logits, ``DistributedOptimizer(AdamW)``, parameter broadcast, then 5
   training steps at B=4, S=2048 on seeded synthetic ids. The forward loss
   is first held against the same weights with dense attention; the kernel
   launch counts of the 5 steps must be exactly 12 per kernel per step;
7. the ResNet slice: ResNet-50 with ``fuse_bn_conv_stages=(1,)``,
   ``DistributedOptimizer(SGD(0.01, momentum=0.9))``, 5 steps at B=256,
   224x224 on bench.py's seeded images and labels. The forward loss is
   first held against the unfused ResNet-50 carrying the same weights; the
   5 steps must launch K3 exactly 4 times a step and K4 never; then the
   unfused model takes the same 5 steps for ``fused_bn_delta_ms``;
8. the collectives: every collective of the port on CUDA tensors of f32,
   bf16, uint8 and bool against closed forms (allgather; alltoall with
   ``splits=[n]`` and without; reducescatter under SUM, AVERAGE, MIN and
   MAX; the PRODUCT all-reduce, async and grouped, with pre- and
   postscale; each ``*_async`` through ``poll`` and ``synchronize``;
   ``broadcast_object`` and ``allgather_object``) in this process's world;
   with two cards or more, one spawned NCCL rank per card checks ragged
   allgather, uneven alltoall, reducescatter and PRODUCT across ranks
   (n!) and times a 64 MiB bf16
   allreduce, allgather and reducescatter (algorithm bandwidth). At one card
   the line says ``"world": 1``;
9. the BERT slice: BERT-base (12 x 768, vocab 30522) with flash attention
   and bf16 logits at B=256, S=128 on seeded ids, under a key padding mask
   (sequence b attends to its first L_b tokens, L_b uniform in [64, 128]
   from numpy seed 42). The forward loss is first held against dense
   attention on the same weights and mask; then 5 AdamW steps whose
   gradients come from ``hvd.distributed_value_and_grad(...,
   compression=hvd.Compression.fp16)``, which must launch each flash kernel
   exactly 12 times a step and no fused-BN kernel; then the same 5 steps
   with dense attention as the control. K1 and the K2 pair are held against
   their plain versions and timed alone at that shape (non-causal, that
   mask), beside scaled_dot_product_attention with the same boolean mask;
10. the scaled data-parallel path (``zero``): GPT-2-small at full width and
   depth, B=4 a rank, S=2048, AdamW through ``make_train_step``, 5 steps of
   each variant from the same weights on the same batches: (a) the
   all-reduce after backward in one grouped buffer, (a2) after backward in
   the buckets of (b), (b) overlapped with backward, (c) ``zero=1``, (d)
   ``zero=2, error_feedback=True`` with ``HOROVOD_WIRE_COMPRESSION=bf16``,
   (e) Adasum where the world is a power of two of at least 2. Each must
   launch each flash kernel 12 times a step, hold its optimizer-state bytes
   to the closed form, and keep its losses near (a)'s ((a2), (b) and (c)
   bitwise at world 1 and within 1e-5 relative past it, (d) within 1e-3);
   (b) must be bitwise (a2) on every world, and the step-1 gradients of
   (a2) and (b) within the rounding bound of two summation orders of (a)'s;
   step ms, peak memory and the largest parameter error against (a) are
   recorded. With two cards or more it runs again on one spawned NCCL
   rank per card (global batch 4·n), checks that a mismatched allreduce
   raises on the card, and records the weak-scaling efficiency. What (b)
   saves over (a) is timed apart, from 5 steps of each in turns (a, b, b,
   a) three times;
11. sequence parallelism (``sp``): attention at B=2, S=8192, H=12, D=64,
   bf16, causal, forward and backward on a one-rank sp line: Ulysses through
   flash (``ulysses_attention(use_flash=True)``) must be bitwise the port's
   ``flash_attention`` (o, dq, dk, dv) and launch K1 and each K2 kernel
   once; ``ring_attention`` must match flash within the k1/k2 tolerances;
   the ms of each and the ring's peak memory;
12. expert parallelism (``moe``): GPT-2-small at full width and depth with
   8 Switch experts in every other FFN (capacity factor 1.25: the layout of
   Switch-Base-8), flash attention, B=4, S=2048, 5 AdamW steps through
   ``make_train_step(moe_aux_weight=0.01)``: finite losses, each flash
   kernel 12 times a step, the dispatch and combine by index bitwise equal
   to the one-hot einsum formulation at that shape; dropped tokens and the
   auxiliary loss a step, step ms, tokens/s, peak memory;
13. with two cards or more (``sp_multi``), one NCCL rank per card against
   world-1 controls run here on the same global batch: (s1) sp=n, Ulysses
   through flash, ``shard_seq``, B=2, S=8192, against flash; (s2) the same
   with the ring, against the ring's own arithmetic on one card
   (``ring_on_one_card``: the n sequence blocks folded in the ring's order
   by its block update; the port's ring is bitwise the JAX ring in bf16);
   against dense attention with remat and against flash it is printed, not
   gated; (e1) ep=n with phase 12's configuration, against phase
   12; (se) on four cards ep=2 x sp=2 with MoE and Ulysses-flash at B=2,
   S=8192 against MoE with flash. Each: step-1 loss within 2e-3 relative
   and the 5 steps' within 1e-2; step-1 gradients, experts gathered to full
   shape, within 1e-2 in relative norm; 12 launches of each flash kernel a
   step on every rank (0 for the ring); step-1 dropped tokens within 0.1%
   of the control's; replicated parameters bitwise equal on every rank.
   n must divide 12 for sp and 8 for ep;
14. pipeline parallelism (``pp``): GPT-2 1.3B (24 x 2048, 16 heads of
   head dim 128, d_ff 8192, vocab 50257) at B=8, S=2048, bf16, flash, remat,
   AdamW: ``TransformerLM`` takes one step; ``PipelinedLM`` on a pp=1 mesh
   from the same seed takes 5, bitwise the LM's at step 1 (loss and every
   gradient), the last loss below the first, 48 launches of K1 and 24 of
   each K2 kernel a step (remat runs each forward twice); remat bitwise no
   remat at B=1; K1 and the K2 pair at (8, 2048, 16, 128) and (1, 2048, 16, 128)
   against their plain versions, timed beside SDPA and the aten flash
   backward; step ms, tokens/s, model TFLOP/s against 989, peak memory;
15. with two cards or more (``pp_multi``), one NCCL rank per card against
   phase 14's run: (p1) pp=n for n in {2, 4} with 8 microbatches, (p2) on
   four cards pp=2 x dp=2 with 4 microbatches and remat. Gates as in 13,
   the stages' gradients gathered to the full model; (24/n)·M launches of
   each kernel a step per rank (K1 twice that with remat); pp-replicated
   parameters bitwise on every rank; the step ms beside GPipe's bubble.
   With one card its line says "not measured";
16. tensor parallelism (``tp``): GPT-2 1.3B as in 14, ``TransformerLM``
   built on a dp=1 x tp=1 mesh through the tp layers (``parallel/
   tensor.py``), 5 steps whose step-1 loss and gradients must be bitwise
   phase 14's, 48 launches of K1 and 24 of each K2 kernel a step; K1 and
   the K2 pair at the tp path's (8, 2048, 8, 128) and (8, 2048, 4, 128)
   against their plain versions, timed beside SDPA and the aten flash
   backward; the vocab-parallel cross-entropy at tp=1 against ``lm_loss``
   on (8, 2048, 50257) bf16 logits (loss within 1e-5, gradient within one
   bf16 ulp);
17. with two cards or more (``tp_multi``), one NCCL rank per card against
   phase 14's run: (t1) tp=2, and tp=4 on four cards; (t2) dp=2 x tp=2 on
   four cards; beside each mesh an f32 witness (dense attention, one step)
   against the same model in f32 on one card (``f32_control``). Losses as
   in 15; the step-1 gradients, the tp shards joined to the full model
   (``tp_join``), by ``grad_gates``: each witness within 1e-4 of the f32
   control in relative norm over the whole model and in every tensor; each
   bf16 variant's distance e_v from the f32 control at most twice e_1,
   phase 14's distance from it (the distance from phase 14's own bf16
   gradients is printed, not gated: a bf16 backward of 24 layers amplifies
   any last-bits change near its top to ~1.7%); 48 launches of K1 and 24
   of each K2 kernel a step per rank; the tp-replicated parameters bitwise
   on every rank of their tp line, every parameter on its dp line; per
   rank the step ms, tokens/s, peak memory and parameters held. With one
   card its line says "not measured";
18. sharded training state on one card (``zero_mesh``): GPT-2 1.3B as in
   14 on a dp=1 x tp=1 mesh, 5 steps each of (z0) ``make_train_step(
   zero=True)`` with a plain AdamW and (f0) the model and step under
   ``FSDP_RULES``: step-1 loss and gradients and the 5 losses bitwise
   phase 14's, 48 launches of K1 and 24 of each K2 kernel a step, the
   parameter, gradient and optimizer-state bytes at their closed forms;
   step ms, tokens/s, peak memory;
19. with two cards or more (``zero_mesh_multi``), one NCCL rank per card
   against phase 14's run: (f1) ``FSDP_RULES`` on dp=2 and dp=4; on four
   cards (f2) ``FSDP_RULES`` on dp=2 x tp=2 and its f32 witness, (z1)
   ``zero=True`` on dp=2 x tp=2, (z2) ``zero=True`` on dp=2 x pp=2 with 4
   microbatches (ZeRO over the dp line of a ``PipelinedLM``); beside each
   mesh its replicated run in the same world. Losses as in 15; step-1
   gradients (under ZeRO the slices it reduced, gathered over the line)
   joined to the full model (``fsdp_join``, ``tp_join``) within
   1e-2 of phase 14's for dp and pp, by 17's gates where tp > 1; launches
   per rank; replicas bitwise on every line of copies; per-rank
   parameter, gradient and optimizer-state bytes at their closed forms
   (``held_closed_form``); per rank the step ms, tokens/s and peak memory
   beside the replicated run's. With one card its line says "not
   measured";
20. tp under pp (``pp_tp``): GPT-2 1.3B as in 14, ``PipelinedLM`` on a pp=1
   x dp=1 x tp=1 mesh built through the tp-aware stage (the tp layers on a
   line of one member, the column-parallel head), 5 steps whose step-1
   loss and gradients must be bitwise 14's, 48 launches of K1 and 24 of
   each K2 kernel a step; K1 and the K2 pair at the pp x tp path's
   microbatch shape (1, 2048, 8, 128) against their plain versions, timed
   beside SDPA and the aten flash backward;
21. with four cards (``pp_tp_multi``), one NCCL rank per card on pp=2 x
   tp=2 with 8 microbatches against 14's run: (pt1) bf16, flash, remat, 5
   steps, (pt1f) the same in f32 with dense attention, one step, against
   the f32 control of 17. Losses as in 15; the step-1 gradients, the
   stages' tp shards joined to the full model, by 17's gates; per rank 192
   launches of K1 and 96 of each K2 kernel a step (none in f32), the
   parameters held at their closed form, every line of copies bitwise (the
   tp-replicated tensors on their tp line, the pp-replicated ones on their
   pp line); per rank the step ms, tokens/s and peak memory beside the
   pp=2 and tp=2 steps PERF.md records (context, no gain claimed). With fewer
   cards its line says "not measured";
22. tp composed with sp (``tp_sp``): GPT-2 1.3B as in 14 with ``max_len``
   8192 at B=2, S=8192 (the same 16,384 tokens a step), on a dp=1 x sp=1 x
   tp=1 mesh through the tp x sp code, 5 steps each with flash and with
   the ring (dense attention on a line of one member), each bitwise the
   model built with no mesh (losses and step-1 gradients); 48 launches of
   K1 and 24 of each K2 kernel a step with flash; the world-1 controls of
   23 (flash; the ring's arithmetic on one card over 2 blocks,
   ``ring_on_one_card``, in bf16 and, one step, in f32); K1 and the K2
   pair at (2, 8192, H, 128) for H in 16, 8 and 4 against their plain
   versions (at B=1 where their f32 scores pass 4 GiB), timed beside SDPA
   and the aten flash backward;
23. with four cards (``tp_sp_multi``), one NCCL rank per card on dp=1 x
   sp=2 x tp=2 against 22's controls: (ts1) the ring, (ts2) Ulysses through
   flash (K1/K2 at (2, 8192, 4, 128) a rank), (ts3) the gathered flash
   ((2, 8192, 8, 128) a rank), (ts1f) the ring in f32, one step. Losses as
   in 15; the step-1 gradients joined over tp by ``grad_gates``: the f32
   witness within 1e-4 of the f32 control over the whole model and in
   every tensor, each bf16 variant's distance e_v from the f32 control at
   most twice its control's e_1; 48/24/24 launches a step per rank with
   flash, none with the ring; the parameters held at their closed form,
   replicas bitwise on every tp and sp line; per rank the step ms,
   tokens/s and peak memory. With fewer cards its line says "not
   measured";
24. MoE under tensor parallelism (``tp_moe``): GPT-2 1.3B with 8 Switch
   experts in every other block (capacity 1.25, auxiliary loss 0.01;
   4,237,295,616 parameters, whose AdamW state does not fit one card) at
   full width and 16 layers, B=8, S=2048, bf16, flash, remat, AdamW, built
   on a dp=1 x ep=1 x sp=1 x tp=1 mesh through the MoE-under-tp code and
   with no mesh, 5 steps each: losses, step-1 gradients and dropped tokens
   bitwise equal, 32 launches of K1 and 16 of each K2 kernel a step; then
   the full-depth world-1 controls of 25, one forward and backward each
   with no optimizer: bf16 with flash, and f32 with dense attention;
25. with four cards (``tp_moe_multi``), each variant on its own world of
   one NCCL rank per card, at full depth: (tm1) tp=2 x ep=2, (tm2) tp=4,
   (tm3) dp=2 x tp=2, (tm4) ep=4 (13's (e1) path at this size, the
   reference of the others' 5 losses), (tm1f) tp=2 x ep=2 in f32 with
   dense attention, one step. Step-1 loss within 2e-3 of the full-depth
   control, the 5 losses within 1e-2 of (tm4)'s; the step-1 gradients,
   joined over tp and ep, by 17's gates; step-1 dropped tokens within 0.1%
   of the control's; per rank 48/24/24 launches a step (none in f32), the
   parameters held at their closed form, every Switch FFN's routes
   bitwise on every tp and ep line after every step (an all-gather), the
   replicas bitwise on every line of copies; per rank the step ms,
   tokens/s and peak memory. With fewer cards its line says "not
   measured";
26. ViT-L/16 (``vit``; BASELINE.json's "ViT-L/16 ImageNet DP": 24 x 1024,
   16 heads, d_ff 4096, 224x224, patch 16, 197 tokens, 1000 classes,
   dense attention as the JAX ViT runs) on one card at 32 images
   (``examples/jax_synthetic_benchmark.py``'s per-chip default): its
   parameters against the JAX tree's closed form (304,326,632), the bf16
   forward loss within 2e-2 of the same weights in f32, then 5 steps of
   ``make_train_step`` with SGD(0.01, momentum 0.9) on bench.py's seeded
   images and labels; no launch of K1-K4; step ms, images/s, peak memory;
27. with four cards (``vit_multi``), one NCCL rank per card over dp=4 at 32
   images a card against a world-1 control on the global 128, by 13's
   gates (step-1 loss, 5 losses, step-1 gradients, replicas bitwise);
28. ``train_mnist`` (``mnist``; ``examples/jax_mnist.py``'s example) for one
   epoch of the synthetic set on one card: the loss falls, no launch;
29. with two cards (``mnist_multi``), ``train_mnist`` on two NCCL ranks, one
   step and then one epoch: the step-1 parameters within 1e-5 of a
   world-1 control fed the mean of the two shards' gradients (cuDNN's
   deterministic algorithms on both sides), replicas bitwise, the loss
   falls;
30. with four cards (``adasum_1p3b_multi``), GPT-2 1.3B as in 14 over dp=4
   at B=8 a card under ``DistributedOptimizer(AdamW, op=Adasum)`` at its
   defaults (each gradient combined on its own), beside (a2) the mean
   after backward at the same shape: 48/24/24 launches a step, replicas
   bitwise, and the step-1 combined gradient of the token embedding, block
   0's qkv kernel and ``ln_f``'s scale against ``adasum_numpy`` (f64) of the
   four ranks' raw gradients, elementwise within 1e-4 relative plus 1e-5
   of the tensor's largest element; step ms, tokens/s, peak memory. With
   fewer cards, 27, 29 and 30 say "not measured";
31. Adasum's pair combination as the default runs it (each gradient's
   range apart, ``adasum_combine``) on one card at GPT-2 1.3B's 293
   gradients (5.67 GB of f32 a side), three ranges against the same
   combination in f64 numpy by 30's rule; its ms beside the one-vector
   combination's and the bytes bound;
32. the eager engine (``engine``, run right after 8): 8's closed forms
   again, each through the engine (its response count moves), ``join()``
   0, a steady named tensor served by the response cache from its second
   pass, the eager latency of a 4 KB and a 64 MiB bf16 all-reduce through
   the engine against the direct path in turns; a spawned one-card world
   with ``HOROVOD_TIMELINE`` whose file loads with the expected events;
33. with four cards (``engine_multi``), GPT-2 1.3B as in 14 over dp=4 at
   B=8 a card, every gradient reduced by name through the engine on NCCL
   by ``horovod_tpu_torch.torch.DistributedOptimizer(AdamW,
   named_parameters=...)``: (e1) step-1 reduced gradients within the
   rounding bound of two orders of the top-level overlapped optimizer's on
   the same batches, 5 losses within 1e-4 (1e-5 did not hold for two
   summation orders at this size), and with fusion off on both sides the
   step-1 gradients and 5 losses bitwise; replicas bitwise, 48/24/24
   launches a step, no device-to-host copy past the loss in a profiled
   step; (e2) rank-rotated submission by name within the same bound; (e3)
   rank 3 joins after 2 steps, ranks 0-2's step-3 gradients are their sum
   over 4, ``join()`` 3; (e4) a gradient held back 5 s on rank 1 draws the
   stall warning naming it and rank 1, the step completes; (e5) rank 0's
   timeline has every gradient's negotiation and op; step ms in turns
   with the overlapped optimizer, the engine's cycles, fused responses,
   bytes a response and cache hits a step, peak memory;
34. the launcher and elastic training (``elastic``, one card, run after 10):
   GPT-2-small as in 6 under ``@hvd.elastic.run`` with ``TorchState(model,
   optimizer, batch=0)``, AdamW under the binding's hook optimizer, a commit
   after every step, each step's ids drawn from a generator seeded by (step,
   rank), each started by ``python -m horovod_tpu_torch.runner.launch``: (a)
   ``-np 1`` static, 5 steps, losses bitwise the same steps run in this
   process on 6's model and seed; (b) elastic (``--min-np 1 --max-np 1``, a
   discovery script of one host), HorovodInternalError raised in step 5
   after the commit of step 4, the state after the restore bitwise that
   commit, reset, synced, 8 steps; (c) the same without the error: (b)'s
   final parameters and AdamW state bitwise (c)'s; 12 launches of each flash
   kernel a step; the commit's ms, the device bytes ``TorchState`` holds,
   the reset's seconds by part;
35. with two cards or more (``elastic_multi``; four in PERF.md's runs),
   fake hosts ``card0``..``card<n-1>`` (HVDRUN_FORCE_LOCAL=1, each worker
   bound to its card before torch loads), a discovery script that prints a
   file: steps 1-4 at np=n; ``kill:step=5:rank=<n-1>`` ends that worker
   (its host leaves the file with it); the survivors raise
   HorovodInternalError, restore the commit of step 4 bitwise, reset to
   n-1 and train on; after step 8 rank 0 lists the host again, the next
   commit raises HostsUpdatedInterrupt, the world resets to n and a fresh
   worker on that card is synced from rank 0; the job ends at step 12 with
   the launcher's exit 0 and no worker left, every sync's replicas bitwise
   (a checksum broadcast from rank 0), all under ``timeout 300``; the
   seconds from the kill to the first step at n-1 by part (detection,
   restore, shutdown, the driver's epoch, re-init, sync), from the host's
   return to the first step at n, step ms at n and n-1, peak GB a card;
   then, on one spawned NCCL rank per card, the last rank dies while the
   others wait on a direct NCCL reduce-scatter (no engine) that needs it:
   each survivor's wait ends, its next collective raises
   HorovodInternalError, its shutdown() takes under 10 s, and the
   survivors form a world of n-1 in the same processes on the same cards;
36. the durability plane, one card (``durable_plan``, run before 34,
   which then runs (c) for EL_STEPS steps and (b) for 8; ``durable``,
   after 34): in process, GPT-2-small as in 34 under ``TorchState`` with a
   ``CheckpointManager``: a blocking checkpoint of the whole state (with
   fsync and without), then step ms with checkpoints off and on (one a
   commit, a write always in flight) in turns, the extra device bytes
   while a write is in flight, and the interval I (a write ends within
   it) and the kill step 3I+1 that the runs take; then, each started by
   the launcher with HOROVOD_CHECKPOINT_DIR: (d) ``kill:step=3I+1`` ends
   the job, with two complete manifests left; (e) a fresh launch restores
   the newest, bitwise its shards, and ends bitwise 34's (c); (f)
   ``preempt:step=2`` drains: the drain commit is a complete manifest,
   the worker exits cleanly within the grace, and (f2) a relaunch resumes
   at exactly that step; no tmp debris, no orphan shard directory; the
   seconds from the kill to the first step of the relaunch by part
   (launch, init, model, restore, sync, first step), the writes' seconds
   and skips, the drain's seconds;
37. with two cards or more (``durable_multi``, four in PERF.md's runs,
   after 35): first ``c7_multi``, GPT-2-small's state (~450 tensors)
   broadcast batched 20 times beside the hook optimizer's step on one
   NCCL rank per card, the engine's launch order the same on every rank;
   then under the launcher, fusion off: (m0) an uninterrupted np=n run;
   (m1) every rank killed at step 3I+1; (m2) a restart at np=n, bitwise
   the manifest and at its end bitwise (m0); (m3) a restart at np=2 from
   a copy, bitwise the manifest, replicas bitwise after 4 steps; (m4)
   ``preempt:step=5:rank=n-1``: the drain commit a complete manifest of n
   shards, the drained worker's clean exit, the survivors at n-1 from
   that commit with no restore from disk; the drain barrier's ms a commit
   and the drain's seconds from the notice to the exit to the first step
   at n-1;
38. the metrics plane, one card (``metrics``, on 34's launch (a), which
   runs with HOROVOD_METRICS_PORT on a free port, HOROVOD_METRICS_FILE and
   HOROVOD_METRICS_SYNC_SECONDS=1, and averages each step's loss over the
   world through the engine): /metrics scraped after steps 2 and 5 and
   parsed with the port's ``parse_prometheus``; the responses, tensors and
   bytes equal the engine's ``counters()`` at that point; one op-latency
   observation (CUDA events on the channel's stream) an executed
   response; the all-reduce bytes of steps 3-5 the closed form (the loss;
   past one rank every gradient and the drain flag too), the latencies'
   sum above 0 and within those steps' wall time; after the run rank 0's
   /metrics.json fleet view holds each rank's own values, the JSON file
   is written; the losses bitwise (c)'s, run with the exporters off; step
   ms with the exporters on and off in turns in the worker (no gate);
39. with two cards or more (``metrics_multi``, four in PERF.md's runs):
   38's launch at ``-np n`` with HOROVOD_FUSION_THRESHOLD=0, each gradient
   all-reduced alone through the engine on NCCL: 38's gates on every rank,
   the fleet view holding all n ranks with equal all-reduce bytes, and
   the launch logs equal on every rank with the telemetry rounds on;
40. the ``{"kernels": [...]}`` line (with ``launches_sp``,
   ``launches_moe``, ``launches_pp``, ``launches_tp``,
   ``launches_zero_mesh``, ``launches_tp_sp``, ``launches_tp_moe``,
   ``launches_vit``, ``launches_vit_multi``, ``launches_mnist``,
   ``launches_mnist_multi``, ``launches_adasum_1p3b_multi``,
   ``launches_pp_tp``, ``launches_pp_tp_multi``, ``launches_engine``,
   ``launches_engine_multi``, ``launches_elastic``, ``launches_elastic_multi``,
   ``launches_durable``, ``launches_durable_multi``, ``launches_metrics``,
   ``launches_metrics_multi`` and the D=128 records
   ``pp_d128``, ``tp_d128``, ``tp_sp_d128`` and ``pp_tp_d128``); then the card line
   from nvidia-smi and the last line ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is not available.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense), used for bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SOURCE = {
    "flash_fwd": "horovod_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd_dkdv": "horovod_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd_dq": "horovod_tpu_torch/csrc/flash_attention.cu",
    "fused_bn_conv_scratch": "horovod_tpu_torch/csrc/fused_bn_conv.cu",
    "fused_bn_conv_revisit": "horovod_tpu_torch/csrc/fused_bn_conv.cu",
}
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:66",       # _kernel
    "flash_bwd_dkdv": "horovod_tpu/ops/flash_attention.py:267",  # _dqkv_kernel
    "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:267",
    # fused_bn_relu_matmul's kernel for accum="scratch" and for "revisit"
    "fused_bn_conv_scratch": "horovod_tpu/ops/fused_bn_conv.py:99",
    "fused_bn_conv_revisit": "horovod_tpu/ops/fused_bn_conv.py:166",
}
B, S, H, D = 4, 2048, 12, 64
STEPS = 5
O_ATOL = 2e-2        # bf16 output: a few ulp at |o| ~ 1
LSE_ATOL = 1e-3      # f32 logsumexp; the two differ in summation order only
GRAD_TOL = 2e-2      # bf16 dq/dk/dv, atol and rtol
LOSS_RTOL = 2e-2     # flash vs dense, fused vs unfused forward loss, bf16 models
# ResNet-50 at B=256, 224x224: (M, Cin, Cout) of the bottleneck's last 1x1
# conv in each stage; stage 3's M = 12,544 is padded to 12,800 by the module.
BN_STAGES = [(802816, 64, 256), (200704, 128, 512), (50176, 256, 1024), (12800, 512, 2048)]
BN_PATH_STAGE = 1
# A ragged shape (M not a multiple of either kernel's row tile) that
# fused_bn_relu_matmul accepts: its block_m clamps to M.
BN_RAGGED = (300, 64, 256)
# Rows per tile of K3 and K4.
ROW_TILE = {"scratch": 128, "revisit": 128}
# Edges of the kernels' tiles and boxes: M below one tile, Cout below one
# 64-column box or not a multiple of it, Cin of three boxes. The next two
# give each of K3's blocks (one per SM, 132 on the H100) two or three row
# tiles, the last of them ragged, with Cout not a multiple of 128: at Cin
# 512 through its one x buffer, at Cin 192 through its two. The last two
# give each of K4's row partitions (132 // (Cout tiles) of them) four to
# six row tiles, the last partition ending on a ragged one: at Cin 512
# (the fullest shared memory: a 128 KB w tile, three ring stages) with
# Cout 392, whose last Cout tile is 8 columns wide, and at Cin 128 with
# Cout 200.
BN_EDGES = [(1, 64, 8), (100, 64, 40), (129, 192, 136), (1000, 128, 200),
            (132 * 128 * 2 + 77, 512, 264), (132 * 128 * 3 + 5, 192, 200),
            (33 * 128 * 5 + 3, 512, 392), (66 * 128 * 4 + 100, 128, 200)]
BN_TOL = {"y": (2e-2, 2e-2), "s1": (2e-2, 2.0), "s2": (3e-2, 3.0)}   # (rtol, atol)
RESNET_B, RESNET_HW = 256, 224
# BERT-base as bench.py's transformer_mfu trains it (bench.py:565).
BERT_B, BERT_S = 256, 128
BERT_MIN_LEN = 64
COLL_BYTES = 64 * 2**20      # the multi-card timing buffer, bf16
COLL_ITERS = 20


def full_precision_products() -> None:
    """f32 accumulation in every matrix product, as XLA computes the JAX
    reference's: no TF32, and no bf16 reductions in cuBLAS's split-K
    (PyTorch allows them by default; they raised the step-1 gradient noise
    of GPT-2-small between token cuts from 0.49% to 1.03%, PERF.md §6 PR 9).
    The sp/ep phases, which hold one card's gradients against n cards',
    set it; the earlier phases keep the settings their records were taken
    with."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over `iters` calls, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                atol: float, rtol: float = 0.0) -> float:
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    excess = (got.float() - want.float()).abs() - (atol + rtol * want.float().abs())
    if float(excess.max()) > 0:
        raise AssertionError(f"{name}: max abs err {max_err(got, want)} above "
                             f"atol {atol} rtol {rtol}")
    return max_err(got, want)


def valid_pairs(Bn: int, Sn: int, Hn: int, mask, causal: bool) -> int:
    """(query, key) pairs the kernels compute: what this run's data needs."""
    if mask is None:
        per = Sn * (Sn + 1) // 2 if causal else Sn * Sn
        return Bn * Hn * per
    total = 0
    for row in (mask > 0).cpu().numpy():
        keys = np.nonzero(row)[0]
        total += int(np.sum(Sn - keys)) if causal else Sn * len(keys)
    return total * Hn


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def qkv_views(Bn, Sn, Hn, Dn, gen, dev):
    """q, k, v as the model makes them: strided views of one (B,S,3,H,D)."""
    qkv = torch.randn(Bn, Sn, 3, Hn, Dn, generator=gen, device=dev).to(torch.bfloat16)
    return qkv.unbind(dim=2)


# Small shapes (B, S, H, D, mask kinds) checked beside the path shape, each
# causal and not: S not a multiple of the kernels' 128-row tiles, D = 64 and
# the D = 128 of gpt2-1p3b.
SMALL = [(2, 200, 2, 64, ("padded",)), (2, 320, 2, 128, (None, "padded"))]


def padded_mask(kind, Bn, Sn, dev):
    """None, or a (B, S) key mask with batch 0 padded after 3/4 of S and
    batch 1 fully masked."""
    if kind is None:
        return None
    mask = torch.ones(Bn, Sn, device=dev)
    mask[0, Sn * 3 // 4:] = 0
    mask[1, :] = 0
    return mask


def rates(rec: dict, prefix: str = "") -> None:
    """Achieved TFLOP/s and the share of the bound from a record's own
    flops, kernel time and bound."""
    ms = rec[f"{prefix}kernel_ms"]
    rec[f"{prefix}tflops"] = rec[f"{prefix}flops"] / (ms * 1e-3) / 1e12
    rec[f"{prefix}bound_share"] = rec[f"{prefix}bound_ms"] / ms


def check_repeat(name: str, first, second) -> bool:
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    return True


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    emit({"phase": "card", "nvidia_smi": out[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return out[0]


def phase_build():
    from horovod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_info["ptxas"].splitlines()
             if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info["seconds"],
          "cached": _build.build_info["cached"], "ptxas": ptxas})


def phase_k1(fa, gen, dev):
    """K1 against the plain version; returns the path-shape record."""
    import torch.nn.functional as F

    q, k, v = qkv_views(B, S, H, D, gen, dev)
    o, lse = fa.flash_fwd_cuda(q, k, v, None, True)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, None, True)
    torch.cuda.synchronize()
    err_o = check_close("K1 o (path)", o, o_ref, O_ATOL)
    err_lse = check_close("K1 lse (path)", lse, lse_ref, LSE_ATOL)
    rec = {"phase": "k1", "shape": [B, S, H, D], "causal": True,
           "o_max_abs_err": err_o, "lse_max_abs_err": err_lse,
           "tolerance": {"o_atol": O_ATOL, "lse_atol": LSE_ATOL}}

    rec["bitwise_repeat"] = check_repeat(
        "K1 o, lse", (o, lse), fa.flash_fwd_cuda(q, k, v, None, True))

    for Bn, Sn, Hn, Dn, kinds in SMALL:
        qs, ks, vs = qkv_views(Bn, Sn, Hn, Dn, gen, dev)
        for kind in kinds:
            mask = padded_mask(kind, Bn, Sn, dev)
            for causal in (True, False):
                o_s, lse_s = fa.flash_fwd_cuda(qs, ks, vs, mask, causal)
                o_sr, lse_sr = fa._flash_fwd_plain(qs, ks, vs, mask, causal)
                tag = f"D={Dn} S={Sn} {kind or 'unmasked'} causal={causal}"
                rec[f"o_max_abs_err {tag}"] = check_close(f"K1 o ({tag})", o_s, o_sr, O_ATOL)
                rec[f"lse_max_abs_err {tag}"] = check_close(
                    f"K1 lse ({tag})", lse_s, lse_sr, LSE_ATOL)
                if mask is not None and float(o_s[1].float().abs().max()) != 0.0:
                    raise AssertionError(f"K1 ({tag}): the fully masked sequence is not zero")

    rec["kernel_ms"] = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, None, True), 50)
    rec["plain_ms"] = time_ms(lambda: fa._flash_fwd_plain(q, k, v, None, True), 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 50)
    pairs = valid_pairs(B, S, H, None, True)
    n = B * S * H * D
    rec["flops"] = 4 * D * pairs
    rec["bytes"] = 4 * n * 2 + B * H * S * 4
    rec["bound_ms"], rec["bound_by"] = bound(rec["flops"], rec["bytes"])
    rates(rec)
    emit(rec)
    return rec, (q, k, v, o, lse)


def _library_bwd_ms(q, k, v, dout):
    """One aten call computing dq, dk, dv (PyTorch's own flash backward), as
    a yardstick; None when this PyTorch's op has another signature."""
    fwd = torch.ops.aten._scaled_dot_product_flash_attention.default
    bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward.default
    names = [a.name for a in bwd._schema.arguments]
    expected = ["grad_out", "query", "key", "value", "out", "logsumexp",
                "cum_seq_q", "cum_seq_k", "max_q", "max_k", "dropout_p",
                "is_causal", "philox_seed", "philox_offset", "scale"]
    if names != expected:
        return None
    qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, dout))
    out, lse, cq, ck, mq, mk, seed, offset, _ = fwd(qt, kt, vt, 0.0, True)
    return time_ms(lambda: bwd(gt, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0,
                               True, seed, offset), 50)


def phase_k2(fa, gen, dev, fwd_out):
    q, k, v, o, lse = fwd_out
    dout = torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
    delta = (dout.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, None, dout, lse, delta, True)
    dq = fa.flash_bwd_dq_cuda(q, k, v, None, dout, lse, delta, True)
    dq_r, dk_r, dv_r = fa._flash_bwd_plain(q, k, v, None, dout, True)
    torch.cuda.synchronize()
    rec = {"phase": "k2", "shape": [B, S, H, D], "causal": True,
           "tolerance": {"atol": GRAD_TOL, "rtol": GRAD_TOL}}
    for name, got, want in (("dq", dq, dq_r), ("dk", dk, dk_r), ("dv", dv, dv_r)):
        rec[f"{name}_max_abs_err"] = check_close(f"K2 {name} (path)", got, want,
                                                 GRAD_TOL, GRAD_TOL)
        rec[f"{name}_max_abs_ref"] = float(want.float().abs().max())

    rec["bitwise_repeat"] = check_repeat(
        "K2 dq, dk, dv", (dq, dk, dv),
        (fa.flash_bwd_dq_cuda(q, k, v, None, dout, lse, delta, True),
         *fa.flash_bwd_dkdv_cuda(q, k, v, None, dout, lse, delta, True)))

    for Bn, Sn, Hn, Dn, kinds in SMALL:
        qs, ks, vs = qkv_views(Bn, Sn, Hn, Dn, gen, dev)
        dos = torch.randn(Bn, Sn, Hn, Dn, generator=gen, device=dev).to(torch.bfloat16)
        for kind in kinds:
            mask = padded_mask(kind, Bn, Sn, dev)
            for causal in (True, False):
                o_s, lse_s = fa.flash_fwd_cuda(qs, ks, vs, mask, causal)
                dlt = (dos.float() * o_s.float()).sum(-1).permute(0, 2, 1).contiguous()
                dk_s, dv_s = fa.flash_bwd_dkdv_cuda(qs, ks, vs, mask, dos, lse_s, dlt, causal)
                dq_s = fa.flash_bwd_dq_cuda(qs, ks, vs, mask, dos, lse_s, dlt, causal)
                refs = fa._flash_bwd_plain(qs, ks, vs, mask, dos, causal)
                tag = f"D={Dn} S={Sn} {kind or 'unmasked'} causal={causal}"
                for name, got, want in zip(("dq", "dk", "dv"), (dq_s, dk_s, dv_s), refs):
                    rec[f"{name}_max_abs_err {tag}"] = check_close(
                        f"K2 {name} ({tag})", got, want, GRAD_TOL, GRAD_TOL)

    rec["dkdv_kernel_ms"] = time_ms(
        lambda: fa.flash_bwd_dkdv_cuda(q, k, v, None, dout, lse, delta, True), 30)
    rec["dq_kernel_ms"] = time_ms(
        lambda: fa.flash_bwd_dq_cuda(q, k, v, None, dout, lse, delta, True), 30)
    rec["plain_ms"] = time_ms(lambda: fa._flash_bwd_plain(q, k, v, None, dout, True), 3)
    rec["library_pair_ms"] = _library_bwd_ms(q, k, v, dout)
    pairs = valid_pairs(B, S, H, None, True)
    n = B * S * H * D
    rows = B * H * S * 4
    rec["dkdv_flops"], rec["dkdv_bytes"] = 8 * D * pairs, 4 * n * 2 + 2 * rows + 2 * n * 2
    rec["dq_flops"], rec["dq_bytes"] = 6 * D * pairs, 4 * n * 2 + 2 * rows + n * 2
    rec["dkdv_bound_ms"], rec["dkdv_bound_by"] = bound(rec["dkdv_flops"], rec["dkdv_bytes"])
    rec["dq_bound_ms"], rec["dq_bound_by"] = bound(rec["dq_flops"], rec["dq_bytes"])
    # The pair as designed (7 tile products: p and dP in both kernels) and
    # the function itself (5 products: S, dP, dV, dK, dQ; q, k, v, dO, lse
    # and delta read once, dq, dk, dv written once).
    rec["pair_kernel_ms"] = rec["dkdv_kernel_ms"] + rec["dq_kernel_ms"]
    rec["pair_flops"] = rec["dkdv_flops"] + rec["dq_flops"]
    rec["pair_bound_ms"] = rec["dkdv_bound_ms"] + rec["dq_bound_ms"]
    rec["function_flops"], rec["function_bytes"] = 10 * D * pairs, 4 * n * 2 + 2 * rows + 3 * n * 2
    rec["function_bound_ms"], rec["function_bound_by"] = bound(rec["function_flops"],
                                                               rec["function_bytes"])
    for prefix in ("dkdv_", "dq_", "pair_"):
        rates(rec, prefix)
    rec["function_tflops"] = rec["function_flops"] / (rec["pair_kernel_ms"] * 1e-3) / 1e12
    rec["function_bound_share"] = rec["function_bound_ms"] / rec["pair_kernel_ms"]
    emit(rec)
    return rec


def bn_inputs(M, cin, cout, gen, dev):
    """x, mu, var, gamma, beta, w drawn as tests/test_fused_bn_conv.py draws
    them: bf16 x and w, f32 per-channel vectors."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    return (randn(M, cin).to(torch.bfloat16), randn(cin) * 0.1, rand(cin) + 0.5,
            rand(cin) + 0.5, randn(cin) * 0.1,
            (randn(cin, cout) / math.sqrt(cin)).to(torch.bfloat16))


def bn_ragged(fb, kernels, gen, dev) -> dict:
    """K3 and K4 at BN_RAGGED against the plain version, with beta shifted
    by +1 so that a zero-filled row past M would normalise to about 1, not
    0: the record shows, for each kernel's row tile, by how much the stats
    would miss the tolerance if the padding rows entered them."""
    M, cin, cout = BN_RAGGED
    x, mu, var, gamma, beta, w = bn_inputs(M, cin, cout, gen, dev)
    args = (x, mu, var, gamma, beta + 1.0, w)
    want = fb._reference_bn_relu_matmul(*args)
    row = {"M": M, "Cin": cin, "Cout": cout, "beta_shift": 1.0}
    for name, tile in ROW_TILE.items():
        pad = -M % tile
        wrong = fb._reference_bn_relu_matmul(torch.cat([x, x.new_zeros(pad, cin)]), *args[1:])
        for part, idx in (("s1", 1), ("s2", 2)):
            rtol, atol = BN_TOL[part]
            excess = float(((wrong[idx] - want[idx]).abs()
                            - (atol + rtol * want[idx].abs())).max())
            if excess <= 0:
                raise AssertionError(f"ragged {name}: {pad} padding rows would not show in {part}")
            row[f"{name}_pad_rows"] = pad
            row[f"{name}_pad_{part}_excess"] = excess
    for name, fn in kernels.items():
        got, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        for part, g, want_part in zip(("y", "s1", "s2"), got, want):
            rtol, atol = BN_TOL[part]
            row[f"{name}_{part}_max_abs_err"] = check_close(
                f"K{3 if name == 'scratch' else 4} {part} (ragged)", g, want_part, atol, rtol)
        row[f"{name}_bitwise_repeat"] = check_repeat(f"{name} (ragged)", got, again)
    return row


def bn_grids(M: int, cout: int) -> dict:
    """Both kernels' grids at one shape, from the library: workspace
    partitions (two a block for K3, two a row partition for K4), blocks,
    row tiles, and K4's Cout tile and row partitions."""
    from horovod_tpu_torch.ops._build import library

    lib = library()
    parts = lib.hvd_fused_bn_conv_scratch_parts(M, cout)
    k4_parts = lib.hvd_fused_bn_conv_revisit_parts(M, cout)
    tile_n = lib.hvd_fused_bn_conv_revisit_tile_n()
    return {"scratch_partitions": parts, "scratch_blocks": parts // 2,
            "scratch_row_tiles": -(-M // ROW_TILE["scratch"]),
            "revisit_partitions": k4_parts, "revisit_row_partitions": k4_parts // 2,
            "revisit_tile_n": tile_n,
            "revisit_blocks": -(-cout // tile_n) * (k4_parts // 2),
            "revisit_row_tiles": -(-M // ROW_TILE["revisit"])}


def bn_shape_row(fb, kernels, args, want, tag: str) -> dict:
    """Both kernels against the plain version's (y, s1, s2) on one shape,
    each launched twice: the errors and the bitwise repeat; their grids."""
    M, cin = args[0].shape
    cout = args[5].shape[1]
    row = {"M": M, "Cin": cin, "Cout": cout, **bn_grids(M, cout)}
    for name, fn in kernels.items():
        got, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        for part, g, w in zip(("y", "s1", "s2"), got, want):
            rtol, atol = BN_TOL[part]
            row[f"{name}_{part}_max_abs_err"] = check_close(
                f"K{3 if name == 'scratch' else 4} {part} ({tag})", g, w, atol, rtol)
        row[f"{name}_bitwise_repeat"] = check_repeat(f"{name} ({tag})", got, again)
    return row


def phase_k34(fb, gen, dev):
    """K3 and K4 against the plain version at the four stage shapes, at
    BN_RAGGED and at BN_EDGES, stats bitwise-equal over two launches;
    times, rates and shares of the bound at the path shape."""
    rec = {"phase": "k34", "batch": RESNET_B, "image": RESNET_HW,
           "tolerance": {k: {"rtol": r, "atol": a} for k, (r, a) in BN_TOL.items()},
           "shapes": []}
    kernels = {"scratch": fb.fused_bn_conv_scratch_cuda,
               "revisit": fb.fused_bn_conv_revisit_cuda}
    for stage, (M, cin, cout) in enumerate(BN_STAGES):
        args = bn_inputs(M, cin, cout, gen, dev)
        want = fb._reference_bn_relu_matmul(*args)
        row = {"stage": stage, **bn_shape_row(fb, kernels, args, want, f"stage {stage}")}
        row["s1_max_abs_ref"] = float(want[1].abs().max())
        row["s2_max_abs_ref"] = float(want[2].abs().max())
        rec["shapes"].append(row)
        if stage == BN_PATH_STAGE:
            for key in ("scratch_partitions", "scratch_blocks", "revisit_partitions",
                        "revisit_row_partitions", "revisit_blocks", "revisit_tile_n"):
                rec[key] = row[key]
            for name, fn in kernels.items():
                rec[f"{name}_ms"] = time_ms(lambda: fn(*args), 20)
                rec[f"{name}_max_abs_err"] = row[f"{name}_y_max_abs_err"]
            rec["plain_ms"] = time_ms(lambda: fb._reference_bn_relu_matmul(*args), 5)
            x, mu, var, gamma, beta, w = args
            a = torch.relu((x.float() - mu) * torch.rsqrt(var + 1e-5) * gamma + beta).to(x.dtype)
            # No one PyTorch call computes the fused function; the product
            # alone is the least a library takes for part of it.
            rec["library_ms"] = time_ms(lambda: torch.matmul(a, w), 20)
            rec["library_is"] = "torch.matmul(a, w): the bf16 product alone"
            rec["flops"] = 2 * M * cin * cout
            rec["bytes"] = (M * cin + M * cout + cin * cout) * 2 + 4 * cin * 4 + 2 * cout * 4
            rec["bound_ms"], rec["bound_by"] = bound(rec["flops"], rec["bytes"])
            for name in kernels:
                ms = rec[f"{name}_ms"]
                rec[f"{name}_tflops"] = rec["flops"] / (ms * 1e-3) / 1e12
                rec[f"{name}_gbps"] = rec["bytes"] / (ms * 1e-3) / 1e9
                rec[f"{name}_bound_share"] = rec["bound_ms"] / ms
            # K4 reads x once per Cout tile. Had none of those reads come
            # from L2, its schedule would move this many bytes; the bound
            # above counts x once, whatever implements the function.
            rec["revisit_x_reads"] = -(-cout // row["revisit_tile_n"])
            rec["revisit_no_reuse_bytes"] = (rec["bytes"]
                                             + (rec["revisit_x_reads"] - 1) * M * cin * 2)
            rec["revisit_no_reuse_floor_ms"] = rec["revisit_no_reuse_bytes"] / PEAK_BYTES * 1e3
            rec["revisit_no_reuse_floor_share"] = (rec["revisit_no_reuse_floor_ms"]
                                                   / rec["revisit_ms"])
            # The same walk with every one of those bytes compulsory: M times
            # the re-reads rows into one Cout tile, so each block walks as many
            # row tiles and does the same work, and the kernel moves the
            # no-reuse bytes from device memory.
            walk = bn_inputs(M * rec["revisit_x_reads"], cin, row["revisit_tile_n"], gen, dev)
            rec["revisit_compulsory_shape"] = [M * rec["revisit_x_reads"], cin,
                                               row["revisit_tile_n"]]
            rec["revisit_compulsory_ms"] = time_ms(
                lambda: fb.fused_bn_conv_revisit_cuda(*walk), 20)
            del walk
            del a
        del args, want
        torch.cuda.empty_cache()
    rec["ragged"] = bn_ragged(fb, kernels, gen, dev)
    rec["edges"] = []
    for M, cin, cout in BN_EDGES:
        args = bn_inputs(M, cin, cout, gen, dev)
        want = fb._reference_bn_relu_matmul(*args)
        rec["edges"].append(bn_shape_row(fb, kernels, args, want, f"{M}, {cin}, {cout}"))
    emit(rec)
    return rec


def steps(step_fn, state, inputs, labels):
    """STEPS training steps; (state, losses, step ms by host clock)."""
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, loss = step_fn(state, inputs, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    return state, losses, step_ms


def check_loss(name: str, got: float, want: float):
    if not (math.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(want)):
        raise AssertionError(f"{name}: forward loss {got} vs {want}")


def phase_slice(fa, fb):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    mesh = create_mesh({"dp": 1})
    spec = get_model("gpt2-small")
    gen = torch.Generator(device=hvd.device()).manual_seed(0)
    model = spec.make_model(device=hvd.device(), generator=gen, attn_impl="flash",
                            logits_dtype=torch.bfloat16, max_len=S)
    cfg = model.cfg
    ids = torch.from_numpy(spec.make_batch(B, seed=42, seq_len=S)[0]).to(hvd.device())

    # The forward loss through the kernels against dense attention on the
    # same weights.
    dense = spec.make_model(device=hvd.device(), attn_impl="dense",
                            logits_dtype=torch.bfloat16, max_len=S)
    dense.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_flash = float(lm_loss(model(ids), ids))
        loss_dense = float(lm_loss(dense(ids), ids))
    del dense
    check_loss("gpt2-small flash vs dense", loss_flash, loss_dense)

    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8))
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh)
    state = init_fn()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()

    fa.reset_launches()
    fb.reset_launches()
    state, losses, step_ms = steps(step_fn, state, ids, ids)
    launches, other = fa.launches(), fb.launches()
    want = cfg.n_layers * STEPS
    if launches != {name: want for name in launches} or any(other.values()):
        raise AssertionError(f"launch counts {launches} {other}, expected {want} "
                             "of each flash kernel and no fused-BN launch")
    steady = statistics.median(step_ms[1:])
    rec = {"phase": "slice", "model": "gpt2-small", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads, "vocab": cfg.vocab_size,
           "batch": B, "seq": S, "world": hvd.size(), "device": str(hvd.device()),
           "loss_flash_fwd": loss_flash, "loss_dense_fwd": loss_dense,
           "losses": losses, "step_ms": step_ms, "median_step_ms_2_to_5": steady,
           "tokens_per_s": B * S / (steady / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_per_step": {
               k: v / STEPS for k, v in launches.items()}}
    emit(rec)
    return rec


def phase_resnet(fa, fb):
    """ResNet-50 with the stage-1 fused tail: forward loss against the
    unfused model on the same weights, 5 steps through K3, then the unfused
    model's 5 steps from the same weights for fused_bn_delta_ms."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import resnet_unfused_state_dict
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import make_train_step, softmax_xent

    dev = hvd.device()
    mesh = create_mesh({"dp": 1})
    spec = get_model("resnet50")
    # No device argument: make_model builds on hvd.device().
    model = spec.make_model(generator=torch.Generator(device=dev).manual_seed(0),
                            fuse_bn_conv_stages=(1,))
    if next(model.parameters()).device != dev:
        raise AssertionError(f"make_model() built on {next(model.parameters()).device}")
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    # bench.py's synthetic batch: numpy seed 42, images then labels.
    rng = np.random.RandomState(42)
    images = torch.from_numpy(
        rng.rand(RESNET_B, RESNET_HW, RESNET_HW, 3).astype(np.float32)).to(dev)
    labels = torch.from_numpy(
        rng.randint(0, 1000, size=(RESNET_B,), dtype=np.int32)).to(dev)

    # Forward loss through K3 against the unfused model on the same weights.
    # The last norm of each block starts at scale 0, which would hide the
    # fused tail's output, so both models get scale 0.25 there for this check.
    unfused = spec.make_model(fuse_bn_conv_stages=())
    check_sd = {k: v.clone() for k, v in init_sd.items()}
    for k, v in check_sd.items():
        if k.endswith("bn3.weight"):
            v.fill_(0.25)
    model.load_state_dict(check_sd)
    unfused.load_state_dict(resnet_unfused_state_dict(check_sd))
    model.train()
    unfused.train()
    fb.reset_launches()
    with torch.no_grad():
        logits_fused, logits_unfused = model(images), unfused(images)
        loss_fused = float(softmax_xent(logits_fused, labels))
        loss_unfused = float(softmax_xent(logits_unfused, labels))
    check_launches = fb.launches()["fused_bn_conv_scratch"]
    if check_launches != 4:
        raise AssertionError(f"the fused forward launched K3 {check_launches} times, not 4")
    check_loss("resnet50 fused vs unfused", loss_fused, loss_unfused)
    logits_diff = max_err(logits_fused, logits_unfused)
    del logits_fused, logits_unfused
    model.load_state_dict(init_sd)
    unfused.load_state_dict(resnet_unfused_state_dict(init_sd))

    def train(net, name):
        opt = hvd.DistributedOptimizer(torch.optim.SGD(net.parameters(), lr=0.01,
                                                       momentum=0.9))
        init_fn, step_fn = make_train_step(net, opt, softmax_xent, mesh=mesh)
        state = init_fn()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        fa.reset_launches()
        fb.reset_launches()
        state, losses, step_ms = steps(step_fn, state, images, labels)
        steady = statistics.median(step_ms[1:])
        return {f"{name}_losses": losses, f"{name}_step_ms": step_ms,
                f"{name}_median_step_ms_2_to_5": steady,
                f"{name}_images_per_s": RESNET_B / (steady / 1e3),
                f"{name}_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}, \
            {**fa.launches(), **fb.launches()}

    del unfused
    rec = {"phase": "resnet", "model": "resnet50", "fuse_bn_conv_stages": [1],
           "batch": RESNET_B, "image": RESNET_HW, "world": hvd.size(), "device": str(dev),
           "loss_fused_fwd": loss_fused, "loss_unfused_fwd": loss_unfused,
           "logits_max_abs_diff_fwd": logits_diff, "k3_launches_fwd": check_launches}
    fused_rec, launches = train(model, "fused")
    want = {name: 0 for name in launches}
    want["fused_bn_conv_scratch"] = 4 * STEPS
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    rec.update(fused_rec, launches=launches,
               launches_per_step={k: v / STEPS for k, v in launches.items()})
    del model
    torch.cuda.empty_cache()

    unfused = spec.make_model(fuse_bn_conv_stages=())
    unfused.load_state_dict(resnet_unfused_state_dict(init_sd))
    unfused_rec, launches = train(unfused, "unfused")
    if any(launches.values()):
        raise AssertionError(f"the unfused model launched kernels: {launches}")
    rec.update(unfused_rec)
    # bench.py's definition: positive = the fused kernel made the step faster.
    rec["fused_bn_delta_ms"] = (rec["unfused_median_step_ms_2_to_5"]
                                - rec["fused_median_step_ms_2_to_5"])
    emit(rec)
    del unfused
    torch.cuda.empty_cache()
    return rec


def _closed_form_checks(hvd, dev) -> dict:
    """Every collective of the port on this process's world, each rank
    holding the same tensors, against closed forms in n = hvd.size()."""
    n, r = hvd.size(), hvd.rank()
    checked = {}

    def same(name, got, want):
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"collectives: {name} differs from its closed form")
        checked[name] = True

    for dtype in (torch.float32, torch.bfloat16, torch.uint8, torch.bool):
        tag = str(dtype).removeprefix("torch.")
        x = (torch.arange(6 * n * 4, device=dev) % 7).reshape(6 * n, 4)
        x = x.to(dtype) if dtype != torch.bool else x > 3
        same(f"allgather {tag}", hvd.allgather(x), x.repeat(n, 1))
        same(f"allgather_async {tag}", hvd.synchronize(hvd.allgather_async(x)),
             x.repeat(n, 1))
        per = x.shape[0] // n
        # Rank p sends rows [p*per, (p+1)*per) of the same x to each peer.
        a2a_want = x[r * per:(r + 1) * per].repeat(n, 1)
        for splits in (None, [per] * n):
            got, recv = hvd.alltoall(x, splits=splits)
            same(f"alltoall {tag} splits={splits}", got, a2a_want)
            if recv != [per] * n:
                raise AssertionError(f"alltoall {tag}: recv_splits {recv}")
        got, recv = hvd.synchronize(hvd.alltoall_async(x, [per] * n))
        same(f"alltoall_async {tag}", got, a2a_want)
        same(f"broadcast_async {tag}", hvd.synchronize(hvd.broadcast_async(x, 0)), x)
        rows = x[r * per:(r + 1) * per]
        for op in ("SUM", "AVERAGE", "MIN", "MAX"):
            got = hvd.reducescatter(x, op=getattr(hvd.ReduceOp, op))
            # n copies of small integers: SUM is n times the rows (a logical
            # or for bool), and AVERAGE gives the rows back exactly when n is
            # a power of two, as card counts are.
            want = rows * n if op == "SUM" and dtype != torch.bool else rows
            same(f"reducescatter {tag} {op}", got, want)
        h = hvd.allreduce_async(x, op=hvd.Max)
        while not hvd.poll(h):
            pass
        same(f"allreduce_async {tag}", hvd.synchronize(h), x)
        # PRODUCT: n copies of integers up to 6 multiply exactly in f32 and
        # bf16 (6^4 = 1296 has 7 significant bits); scales of powers of two.
        if dtype.is_floating_point:
            same(f"allreduce {tag} PRODUCT", hvd.allreduce(
                x, op=hvd.Product, prescale_factor=0.5, postscale_factor=2.0),
                (x * 0.5) ** n * 2)
            same(f"allreduce_async {tag} PRODUCT",
                 hvd.synchronize(hvd.allreduce_async(x, op=hvd.Product)), x ** n)
            same(f"grouped_allreduce {tag} PRODUCT",
                 hvd.grouped_allreduce([x, x[:1]], op=hvd.Product)[1], x[:1] ** n)
        elif dtype == torch.bool:
            same("allreduce bool PRODUCT", hvd.allreduce(x, op=hvd.Product), x)
    obj = {"rank": r, "bytes": bytes(range(256)), "nested": [1.5, None, "bert"]}
    if hvd.broadcast_object(obj if r == 0 else None, root_rank=0) != dict(obj, rank=0):
        raise AssertionError("broadcast_object")
    if hvd.allgather_object(obj) != [dict(obj, rank=p) for p in range(n)]:
        raise AssertionError("allgather_object")
    checked["broadcast_object"] = checked["allgather_object"] = True
    return checked


def _rank_checks(hvd, dev) -> dict:
    """What differs by rank: ragged allgather (rank r gives r + 1 rows),
    alltoall with rank r sending r + 1 rows to each peer (as
    tests/test_engine.py:138-156), reducescatter of rank-dependent rows."""
    n, r = hvd.size(), hvd.rank()
    x = torch.full((r + 1, 3), float(r), device=dev, dtype=torch.bfloat16)
    want = torch.cat([torch.full((p + 1, 3), float(p), device=dev, dtype=torch.bfloat16)
                      for p in range(n)])
    if not torch.equal(hvd.allgather(x), want):
        raise AssertionError("ragged allgather")
    send = torch.arange(n * (r + 1), device=dev, dtype=torch.float32) + 100 * r
    got, recv = hvd.alltoall(send, splits=[r + 1] * n)
    want = torch.cat([torch.arange(r * (p + 1), (r + 1) * (p + 1), device=dev,
                                   dtype=torch.float32) + 100 * p for p in range(n)])
    if recv != [p + 1 for p in range(n)] or not torch.equal(got, want):
        raise AssertionError(f"uneven alltoall: {recv}")
    rows = torch.arange(2 * n, device=dev, dtype=torch.float32)[:, None] * (r + 1)
    got = hvd.reducescatter(rows, op=hvd.Sum)
    want = torch.arange(2 * r, 2 * r + 2, device=dev, dtype=torch.float32)[:, None] \
        * (n * (n + 1) // 2)
    if not torch.equal(got, want):
        raise AssertionError("reducescatter across ranks")
    # PRODUCT of the ranks' r + 1: n!.
    got = hvd.allreduce(torch.full((3,), float(r + 1), device=dev), op=hvd.Product)
    if not torch.equal(got, torch.full((3,), float(math.factorial(n)), device=dev)):
        raise AssertionError(f"PRODUCT across ranks: {got}")
    return {"ragged_allgather": True, "uneven_alltoall": True, "reducescatter": True,
            "product": True}


def _collective_times(hvd, dev) -> dict:
    """CUDA-event ms and algorithm bandwidth (COLL_BYTES over the time) of a
    COLL_BYTES bf16 allreduce, an allgather into COLL_BYTES and a
    reducescatter of COLL_BYTES, each through the port's entry point."""
    n = hvd.size()
    elems = COLL_BYTES // 2
    full = torch.ones(elems, dtype=torch.bfloat16, device=dev)
    part = torch.ones(elems // n, dtype=torch.bfloat16, device=dev)
    calls = {"allreduce": lambda: hvd.allreduce(full, op=hvd.Sum),
             "allgather": lambda: hvd.allgather(part),
             "reducescatter": lambda: hvd.reducescatter(full)}
    out = {"bytes": COLL_BYTES, "iters": COLL_ITERS}
    for name, fn in calls.items():
        ms = time_ms(fn, COLL_ITERS)
        out[f"{name}_ms"] = ms
        out[f"{name}_algbw_gbps"] = COLL_BYTES / (ms * 1e-3) / 1e9
    return out


def collectives_rank(rank: int, size: int, init_file: str, queue) -> None:
    """One spawned NCCL rank of the multi-card collectives check."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd

        hvd.init(init_method=f"file://{init_file}")
        try:
            dev = hvd.device()
            rec = {"closed_forms": _closed_form_checks(hvd, dev),
                   **_rank_checks(hvd, dev), **_collective_times(hvd, dev)}
            hvd.barrier()
            queue.put((rank, rec))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def spawn_cards(target, cards: int, timeout: float = 300) -> list:
    """``target(rank, cards, init_file, queue)`` on one spawned process per
    card; each rank's record, in rank order. A rank that failed sends its
    traceback, which raises here."""
    import multiprocessing as mp
    import tempfile

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target, args=(r, cards, f"{tmp}/store", queue))
                 for r in range(cards)]
        for proc in procs:
            proc.start()
        try:
            results = dict(queue.get(timeout=timeout) for _ in procs)
        finally:
            for proc in procs:
                proc.join(timeout=60)
                if proc.is_alive():
                    proc.kill()
    name = getattr(target, "func", target).__name__     # a functools.partial names its func
    for r, res in results.items():
        if not isinstance(res, dict):
            raise AssertionError(f"{name} rank {r} failed:\n{res}")
    return [results[r] for r in range(cards)]


def phase_collectives(dev):
    """The closed forms in this process's world; with two cards or more, one
    spawned NCCL rank per card."""
    import horovod_tpu_torch as hvd

    rec = {"phase": "collectives", "world": hvd.size(), "backend": "nccl",
           "checked": sorted(_closed_form_checks(hvd, dev))}
    cards = torch.cuda.device_count()
    if cards >= 2:
        rec["world"] = cards
        rec["ranks"] = spawn_cards(collectives_rank, cards)
    emit(rec)
    return rec


def bert_batch(dev):
    """Seeded ids (the registry's draw, numpy seed 42) and the key padding
    mask: sequence b attends to its first L_b tokens, L_b uniform in
    [BERT_MIN_LEN, BERT_S] from numpy seed 42."""
    from horovod_tpu_torch.models.registry import get_model

    ids = get_model("bert-base").make_batch(BERT_B, seed=42, seq_len=BERT_S)[0]
    lengths = np.random.RandomState(42).randint(BERT_MIN_LEN, BERT_S + 1, size=BERT_B)
    mask = (np.arange(BERT_S)[None, :] < lengths[:, None]).astype(np.int32)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev), lengths


def bert_kernels(fa, gen, dev, mask) -> dict:
    """K1 and the K2 pair at the BERT shape (B=256, S=128, H=12, D=64,
    non-causal, the padding mask) against their plain versions, timed
    alone, with the bound from the mask's valid pairs; SDPA with the same
    boolean mask as a yardstick the port never calls."""
    import torch.nn.functional as F

    Hn, Dn = 12, 64
    q, k, v = qkv_views(BERT_B, BERT_S, Hn, Dn, gen, dev)
    maskf = mask.float()
    o, lse = fa.flash_fwd_cuda(q, k, v, maskf, False)
    o_ref, lse_ref = fa._flash_fwd_plain(q, k, v, maskf, False)
    dout = torch.randn(BERT_B, BERT_S, Hn, Dn, generator=gen, device=dev).to(torch.bfloat16)
    delta = (dout.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, maskf, dout, lse, delta, False)
    dq = fa.flash_bwd_dq_cuda(q, k, v, maskf, dout, lse, delta, False)
    refs = fa._flash_bwd_plain(q, k, v, maskf, dout, False)
    torch.cuda.synchronize()
    rec = {"shape": [BERT_B, BERT_S, Hn, Dn], "causal": False,
           "o_max_abs_err": check_close("K1 o (bert)", o, o_ref, O_ATOL),
           "lse_max_abs_err": check_close("K1 lse (bert)", lse, lse_ref, LSE_ATOL)}
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        rec[f"{name}_max_abs_err"] = check_close(f"K2 {name} (bert)", got, want,
                                                 GRAD_TOL, GRAD_TOL)
    del o_ref, lse_ref, refs
    rec["fwd_ms"] = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, maskf, False), 50)
    rec["fwd_plain_ms"] = time_ms(lambda: fa._flash_fwd_plain(q, k, v, maskf, False), 5)
    rec["dkdv_ms"] = time_ms(
        lambda: fa.flash_bwd_dkdv_cuda(q, k, v, maskf, dout, lse, delta, False), 30)
    rec["dq_ms"] = time_ms(
        lambda: fa.flash_bwd_dq_cuda(q, k, v, maskf, dout, lse, delta, False), 30)
    rec["pair_ms"] = rec["dkdv_ms"] + rec["dq_ms"]
    rec["bwd_plain_ms"] = time_ms(lambda: fa._flash_bwd_plain(q, k, v, maskf, dout, False), 3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    keep = (mask > 0)[:, None, None, :]
    with torch.no_grad():
        rec["sdpa_fwd_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep), 50)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
    gt = dout.transpose(1, 2)
    rec["sdpa_bwd_ms"] = time_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True), 30)
    pairs = valid_pairs(BERT_B, BERT_S, Hn, mask, False)
    n = BERT_B * BERT_S * Hn * Dn
    rows = BERT_B * Hn * BERT_S * 4
    rec["valid_pairs"] = pairs
    rec["fwd_flops"], rec["fwd_bytes"] = 4 * Dn * pairs, 4 * n * 2 + rows + BERT_B * BERT_S * 4
    rec["dkdv_flops"], rec["dkdv_bytes"] = 8 * Dn * pairs, 4 * n * 2 + 2 * rows + 2 * n * 2
    rec["dq_flops"], rec["dq_bytes"] = 6 * Dn * pairs, 4 * n * 2 + 2 * rows + n * 2
    for part in ("fwd", "dkdv", "dq"):
        rec[f"{part}_bound_ms"], rec[f"{part}_bound_by"] = bound(rec[f"{part}_flops"],
                                                                 rec[f"{part}_bytes"])
        rec[f"{part}_bound_share"] = rec[f"{part}_bound_ms"] / rec[f"{part}_ms"]
    rec["pair_bound_ms"] = rec["dkdv_bound_ms"] + rec["dq_bound_ms"]
    return rec


def phase_bert(fa, fb, gen):
    """BERT-base through ``distributed_value_and_grad`` with
    ``Compression.fp16`` on the flash kernels under a padding mask."""
    from torch.func import functional_call

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.train import lm_loss

    dev = hvd.device()
    spec = get_model("bert-base")
    model = spec.make_model(generator=torch.Generator(device=dev).manual_seed(0),
                            attn_impl="flash", logits_dtype=torch.bfloat16)
    cfg = model.cfg
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    ids, mask, lengths = bert_batch(dev)

    # The forward loss through the kernels against dense attention on the
    # same weights and mask.
    dense = spec.make_model(attn_impl="dense", logits_dtype=torch.bfloat16)
    dense.load_state_dict(init_sd)
    fa.reset_launches()
    with torch.no_grad():
        loss_flash = float(lm_loss(model(ids, mask), ids))
        loss_dense = float(lm_loss(dense(ids, mask), ids))
    fwd_launches = fa.launches()["flash_fwd"]
    if fwd_launches != cfg.n_layers:
        raise AssertionError(f"the flash forward launched K1 {fwd_launches} times")
    check_loss("bert-base flash vs dense", loss_flash, loss_dense)
    del dense
    torch.cuda.empty_cache()

    def train(net):
        """STEPS AdamW steps, the gradients from distributed_value_and_grad
        with fp16 (bf16) compression; (losses, step ms)."""
        hvd.broadcast_parameters(net, root_rank=0)
        opt = torch.optim.AdamW(net.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)

        def loss_fn(params, x, m):
            return lm_loss(functional_call(net, params, (x, m)), x)

        value_and_grad = hvd.distributed_value_and_grad(
            loss_fn, compression=hvd.Compression.fp16)
        losses, step_ms = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            loss, grads = value_and_grad(dict(net.named_parameters()), ids, mask)
            for name, p in net.named_parameters():
                p.grad = grads[name]
            opt.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite losses {losses}")
        return losses, step_ms

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fb.reset_launches()
    losses, step_ms = train(model)
    launches, other = fa.launches(), fb.launches()
    want = cfg.n_layers * STEPS
    if launches != {name: want for name in launches} or any(other.values()):
        raise AssertionError(f"launch counts {launches} {other}, expected {want} "
                             "of each flash kernel and no fused-BN launch")
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = statistics.median(step_ms[1:])
    rec = {"phase": "bert", "model": "bert-base", "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads, "vocab": cfg.vocab_size,
           "batch": BERT_B, "seq": BERT_S, "world": hvd.size(), "device": str(dev),
           "compression": "fp16 (bf16 on the wire)",
           "mask_valid_tokens": int(lengths.sum()),
           "mask_lengths_min_max": [int(lengths.min()), int(lengths.max())],
           "loss_flash_fwd": loss_flash, "loss_dense_fwd": loss_dense,
           "losses": losses, "step_ms": step_ms, "median_step_ms_2_to_5": steady,
           "sequences_per_s": BERT_B / (steady / 1e3),
           "tokens_per_s": BERT_B * BERT_S / (steady / 1e3), "peak_mem_gb": peak,
           "launches": launches,
           "launches_per_step": {k: v / STEPS for k, v in launches.items()}}
    del model
    torch.cuda.empty_cache()

    dense = spec.make_model(attn_impl="dense", logits_dtype=torch.bfloat16)
    dense.load_state_dict(init_sd)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    dense_losses, dense_ms = train(dense)
    if any(fa.launches().values()):
        raise AssertionError(f"dense attention launched kernels: {fa.launches()}")
    rec.update(dense_losses=dense_losses, dense_step_ms=dense_ms,
               dense_median_step_ms_2_to_5=statistics.median(dense_ms[1:]),
               dense_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del dense, init_sd
    torch.cuda.empty_cache()
    rec["kernels_at_bert_shape"] = bert_kernels(fa, gen, dev, mask)
    emit(rec)
    torch.cuda.empty_cache()
    return rec


# The zero phase's variants: DistributedOptimizer keywords and wire knobs.
# (a) and (a2) are the after-backward references the overlap (b) is held
# against, through the optimizer's private ``_schedule``: (a2) launches
# (b)'s buckets in step(), so (b) must be bitwise (a2) on any world.
ZERO_VARIANTS = {
    "a_after_backward": ({"_schedule": "grouped"}, {}),
    "a2_after_backward_buckets": ({"_schedule": "buckets"}, {}),
    "b_overlapped": ({}, {}),
    "c_zero1": ({"zero": 1}, {}),
    "d_zero2_ef_bf16": ({"zero": 2, "error_feedback": True},
                        {"HOROVOD_WIRE_COMPRESSION": "bf16"}),
    "e_adasum": ({"op": "adasum"}, {}),
}
# Each variant's losses against (a)'s, relative; Adasum combines the
# gradients otherwise and is held to finite losses only. At world 1 (a2),
# (b) and (c) must be bitwise (a). Past one card NCCL sums each bucket, and
# each reduce-scatter, in another order than the one grouped buffer of (a):
# the step-1 gradients of (a2) and (b) must then lie within the rounding
# bound of two orders of an n-term sum (``grad_order_bound``), and the
# losses within 1e-5 of (a)'s (four H100s: 2.6e-6 at step 3).
ZERO_LOSS_RTOL = {"a2_after_backward_buckets": 1e-5, "b_overlapped": 1e-5,
                  "c_zero1": 1e-5, "d_zero2_ef_bf16": 1e-3}
ZERO_BITWISE_AT_WORLD_1 = ("a2_after_backward_buckets", "b_overlapped", "c_zero1")
ZERO_REPLICATED = ("a_after_backward", "a2_after_backward_buckets", "b_overlapped")


def grad_order_bound(abs_sum: torch.Tensor, world: int, dtype: torch.dtype) -> torch.Tensor:
    """Per element, how far two all-reduces of the same gradients may land
    apart when they add the world's n terms in other orders: each side
    rounds n-1 partial sums, each by at most u·Σ_r|g_r| (u the unit
    roundoff of ``dtype``), and AVERAGE divides both by n."""
    u = torch.finfo(dtype).eps / 2
    return abs_sum * (2 * (world - 1) * u / world)


def _capture_step_1(hvd, opt, keep_abs_sum: bool, got: dict) -> None:
    """Wrap ``opt`` so that its first step records into ``got`` the
    reduced gradients (``grads``, flat, as the inner optimizer gets them)
    and, with ``keep_abs_sum``, Σ_r|g_r| of the ranks' own gradients
    (``abs_sum``), both in host memory, so that they stay out of the
    variant's peak device memory."""
    params = [p for g in opt.param_groups for p in g["params"]]
    inner_step, reduce = opt._inner.step, opt._reduce

    def step(*args, **kw):
        if "grads" not in got:
            got["grads"] = torch.cat([p.grad.detach().reshape(-1).cpu() for p in params])
        return inner_step(*args, **kw)

    def reduce_first():
        if "abs_sum" not in got:
            got["abs_sum"] = torch.cat([hvd.allreduce(p.grad.detach().abs(), op=hvd.Sum)
                                        .reshape(-1).cpu() for p in params])
        return reduce()

    opt._inner.step = step
    if keep_abs_sum:
        opt._reduce = reduce_first


def zero_variants(hvd, fa, world: int) -> dict:
    """GPT-2-small at full width and depth, B=4 a rank (global batch 4·world),
    S=2048, bf16, AdamW(1e-4, wd 1e-4, eps 1e-8) through
    ``make_train_step``: STEPS steps of each variant from the same weights
    on the same batches. Checks each variant's flash launches (12 of K1 and
    of each K2 kernel a step), its optimizer-state bytes against the closed
    form (8·P replicated, 8·⌈P/n⌉ sharded, 4·⌈P/n⌉ more for the residual)
    and its losses against (a)'s; (a2), (b) and (c) bitwise (a) at world 1;
    (b) bitwise (a2) on every world; the step-1 gradients of (a2) and (b)
    within ``grad_order_bound`` of (a)'s."""
    import gc
    import os

    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.mesh import create_mesh
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    dev = hvd.device()
    spec = get_model("gpt2-small")
    model = spec.make_model(device=dev, generator=torch.Generator(device=dev).manual_seed(0),
                            attn_impl="flash", logits_dtype=torch.bfloat16, max_len=S)
    n_layers = model.cfg.n_layers
    n_params = sum(p.numel() for p in model.parameters())
    shard = -(-n_params // world)
    closed = {"a_after_backward": 8 * n_params, "a2_after_backward_buckets": 8 * n_params,
              "b_overlapped": 8 * n_params,
              "c_zero1": 8 * shard, "d_zero2_ef_bf16": 12 * shard, "e_adasum": 8 * n_params}
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}
    ids = torch.from_numpy(spec.make_batch(B * world, seed=42, seq_len=S)[0]).to(dev)
    mesh = create_mesh({"dp": world})
    names = [v for v in ZERO_VARIANTS
             if v != "e_adasum" or (world >= 2 and world & (world - 1) == 0)]
    out, ref, a2 = {"world": world, "params": n_params, "variants": {}}, None, None

    def train(name, capture=None):
        """STEPS steps of variant ``name`` from the initial weights, no
        gradient left from an earlier run; (optimizer, losses, step ms).
        ``capture`` gets the step-1 record of ``_capture_step_1``."""
        kw, knobs = ZERO_VARIANTS[name]
        kw = dict(kw, op=hvd.Adasum) if kw.get("op") == "adasum" else kw
        os.environ.update(knobs)
        try:
            model.load_state_dict(init_sd)
            model.zero_grad(set_to_none=True)
            opt = hvd.DistributedOptimizer(torch.optim.AdamW(
                model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), **kw)
            if capture is not None:
                _capture_step_1(hvd, opt, name == "a_after_backward", capture)
            init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh)
            state = init_fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, losses, step_ms = steps(step_fn, state, ids, ids)
            return opt, losses, step_ms
        finally:
            for key in knobs:
                os.environ.pop(key)

    for name in names:
        fa.reset_launches()
        step1 = {} if name in ZERO_REPLICATED else None
        opt, losses, step_ms = train(name, step1)
        launches = fa.launches()
        want = n_layers * STEPS
        if launches != {k: want for k in launches}:
            raise AssertionError(f"zero {name}: launch counts {launches}, expected {want}")
        held = opt.state_bytes()
        if held != closed[name]:
            raise AssertionError(f"zero {name}: {held} optimizer-state bytes, "
                                 f"closed form {closed[name]}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        # The parameters in host memory, as the step-1 records are.
        flat = torch.cat([p.detach().reshape(-1).cpu() for p in model.parameters()])
        v = {"losses": losses, "step_ms": step_ms,
             "median_step_ms_2_to_5": statistics.median(step_ms[1:]),
             "peak_mem_gb": peak,
             "state_bytes": held, "state_bytes_closed_form": closed[name],
             "launches": launches,
             "launches_per_step": {k: c / STEPS for k, c in launches.items()}}
        if ref is None:
            ref = (flat, losses, step1["grads"],
                   grad_order_bound(step1.pop("abs_sum"), world, step1["grads"].dtype))
        else:
            v["max_param_err_vs_a"] = max_err(flat, ref[0])
            v["max_loss_rel_err_vs_a"] = max(abs(x - y) / abs(y) for x, y in zip(losses, ref[1]))
            tol = ZERO_LOSS_RTOL.get(name)
            if tol is not None and v["max_loss_rel_err_vs_a"] > tol:
                raise AssertionError(f"zero {name}: losses {losses} vs (a) {ref[1]}")
            if name in ZERO_BITWISE_AT_WORLD_1 and world == 1 and not (
                    losses == ref[1] and torch.equal(flat, ref[0])):
                raise AssertionError(f"zero {name}: not bitwise (a) at world 1")
            if step1 is not None:
                # The step-1 gradients against (a)'s: the same weights and
                # batch, so only the order of the sums may differ.
                diff = (step1["grads"] - ref[2]).abs()
                over = diff > ref[3]
                v["step1_grad_max_abs_err_vs_a"] = float(diff.max())
                v["step1_grad_rel_norm_err_vs_a"] = float(diff.norm() / ref[2].norm())
                v["step1_grad_err_over_bound_vs_a"] = float(
                    (diff / ref[3].clamp_min(torch.finfo(diff.dtype).tiny)).max())
                if over.any():
                    raise AssertionError(
                        f"zero {name}: {int(over.sum())} step-1 gradient elements past the "
                        f"rounding bound of (a)'s, largest {v['step1_grad_err_over_bound_vs_a']}x")
        if name == "a2_after_backward_buckets":
            a2 = (flat, losses, step1["grads"])
        if name == "b_overlapped" and not (
                losses == a2[1] and torch.equal(flat, a2[0]) and torch.equal(step1["grads"], a2[2])):
            raise AssertionError("zero b_overlapped: not bitwise (a2), the same buckets "
                                 "launched after backward")
        out["variants"][name] = v
        del opt, flat, step1
        gc.collect()
        torch.cuda.empty_cache()
    # What the overlap saves, from runs in turns (a, b, b, a) x 3: step times
    # move by several ms between runs of one process.
    pairs = {"a_after_backward": [], "b_overlapped": []}
    for _ in range(3):
        for name in ("a_after_backward", "b_overlapped", "b_overlapped", "a_after_backward"):
            opt, _, step_ms = train(name)
            pairs[name].append(statistics.median(step_ms[1:]))
            del opt
            gc.collect()
    out["turns_median_step_ms"] = pairs
    out["overlap_saves_ms"] = (statistics.median(pairs["a_after_backward"])
                               - statistics.median(pairs["b_overlapped"]))
    del model, init_sd, ref, a2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mismatch_on_card(hvd) -> str:
    """A 2-element allreduce on rank 0 against 3 elements elsewhere must
    raise HorovodInternalError naming both shapes; the group works after."""
    dev = hvd.device()
    try:
        hvd.allreduce(torch.zeros(2 if hvd.rank() == 0 else 3, device=dev))
    except hvd.HorovodInternalError as e:
        msg = str(e)
    else:
        raise AssertionError("a mismatched allreduce did not raise")
    if "(2,)" not in msg or "(3,)" not in msg:
        raise AssertionError(f"the mismatch error does not name both shapes: {msg}")
    if float(hvd.allreduce(torch.ones(1, device=dev), op=hvd.Sum)) != hvd.size():
        raise AssertionError("the group does not work after the mismatch")
    return msg


def zero_rank(rank: int, size: int, init_file: str, queue) -> None:
    """One spawned NCCL rank of the multi-card zero phase."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa

        torch.backends.cuda.matmul.allow_tf32 = False
        hvd.init(init_method=f"file://{init_file}")
        try:
            rec = {"mismatch": _mismatch_on_card(hvd), **zero_variants(hvd, fa, size)}
            hvd.barrier()
            queue.put((rank, rec))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_zero(fa):
    """The scaled data-parallel path: the variants of ``zero_variants`` in
    this process (world 1); with two cards or more, again on one spawned
    NCCL rank per card, with the step times, the weak-scaling efficiency
    (one card's step ms over n cards') and what overlapping saves."""
    import horovod_tpu_torch as hvd

    one = zero_variants(hvd, fa, hvd.size())
    rec = {"phase": "zero", "model": "gpt2-small", "batch_per_rank": B, "seq": S, **one}
    cards = torch.cuda.device_count()
    if cards >= 2:
        ranks = spawn_cards(zero_rank, cards, timeout=600)
        multi = {"world": cards, "mismatch": ranks[0]["mismatch"],
                 "variants": ranks[0]["variants"],
                 "median_step_ms_by_rank": {v: [r["variants"][v]["median_step_ms_2_to_5"]
                                                for r in ranks]
                                            for v in ranks[0]["variants"]}}
        steady = {v: max(ms) for v, ms in multi["median_step_ms_by_rank"].items()}
        multi["weak_scaling_efficiency"] = {
            v: one["variants"][v]["median_step_ms_2_to_5"] / steady[v]
            for v in steady if v in one["variants"]}
        multi["turns_median_step_ms_rank0"] = ranks[0]["turns_median_step_ms"]
        multi["overlap_saves_ms_by_rank"] = [r["overlap_saves_ms"] for r in ranks]
        rec["multi"] = multi
    else:
        rec["multi"] = f"{cards} card: not measured"
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# Sequence and expert parallelism (phases ``sp``, ``moe`` and, with two
# cards or more, ``sp_multi``).
SP_B, SP_S = 2, 8192
MOE_B, MOE_S = 4, 2048
MOE_CFG = {"n_experts": 8, "moe_every": 2, "capacity_factor": 1.25}   # Switch-Base-8
MOE_AUX = 0.01
F32 = {"dtype": torch.float32, "logits_dtype": torch.float32}
SP_LOSS1_RTOL = 2e-3       # step-1 loss against the world-1 control
SP_LOSS_RTOL = 1e-2        # the 5 steps' losses
SP_GRAD_RTOL = 1e-2        # step-1 gradients, relative norm of the difference
DROP_RTOL = 1e-3           # step-1 dropped tokens against the control's
# The multi-card variants: mesh for n cards, model overrides, global batch,
# whether the flash kernels run, the world-1 control they are held against.
SP_VARIANTS = {
    "s1_ulysses_flash": (lambda n: {"sp": n}, {"attn_impl": "ulysses", "sp_use_flash": True},
                         (SP_B, SP_S), True, "control_flash_s8192"),
    # The port's ring is bitwise the JAX ring in bf16 (tests/
    # test_torch_port_sp.py::test_sp_ring_bf16_matches_jax), whose blocked
    # f32 accumulation rounds otherwise than dense or flash attention: its
    # control is the ring's own arithmetic on one card (``ring_on_one_card``).
    # Against dense attention with remat and against flash it is printed.
    "s2_ring": (lambda n: {"sp": n}, {"attn_impl": "ring"}, (SP_B, SP_S), False,
                "control_ring1_s8192"),
    "e1_moe": (lambda n: {"ep": n}, {"attn_impl": "flash", **MOE_CFG}, (MOE_B, MOE_S), True,
               "control_moe"),
    "se_moe_ulysses_flash": (lambda n: {"ep": 2, "sp": 2},
                             {"attn_impl": "ulysses", "sp_use_flash": True, **MOE_CFG},
                             (SP_B, SP_S), True, "control_moe_s8192"),
    # A witness in f32 (no flash: the kernels take bf16), at S=2048 where
    # the dense control's saved probabilities fit: the sp path's gradients
    # without bf16's rounding noise.
    "s2f_ring_f32_s2048": (lambda n: {"sp": n}, {"attn_impl": "ring", **F32},
                           (SP_B, MOE_S), False, "control_dense_f32_s2048"),
}
SP_CONTROLS = {
    "control_dense_f32_s2048": ({"attn_impl": "dense", **F32}, (SP_B, MOE_S)),
    "control_flash_s8192": ({"attn_impl": "flash"}, (SP_B, SP_S)),
    "control_dense_s8192": ({"attn_impl": "dense", "remat": True}, (SP_B, SP_S)),
    # attn_impl "ring" on a mesh with no sp line, its attention replaced by
    # the ring's block updates in the ring's order (``world1_ring``).
    "control_ring1_s8192": ({"attn_impl": "ring"}, (SP_B, SP_S)),
    "control_moe": ({"attn_impl": "flash", **MOE_CFG}, (MOE_B, MOE_S)),
    "control_moe_s8192": ({"attn_impl": "flash", **MOE_CFG}, (SP_B, SP_S)),
}


# Controls a variant is printed against, not gated.
SP_PRINTED = {"s2_ring": ("control_dense_s8192", "control_flash_s8192")}


def ring_on_one_card(q, k, v, n: int, causal: bool):
    """The ring's arithmetic at sp=n on one card: the sequence in n blocks;
    query block i folds key block (i - t) mod n at step t = 0..n-1 into its
    (o, m, l) state with the port's ``_flash_block_update`` (recomputed in
    backward, as the ring does), then o / l in q's dtype, the blocks
    concatenated. What a ring rank computes from its own q block and the
    K/V blocks it receives, in the same order."""
    from torch.utils.checkpoint import checkpoint

    from horovod_tpu_torch.parallel.ring import _flash_block_update

    B, S, H, Dn = q.shape
    Sb = S // n
    scale = 1.0 / math.sqrt(Dn)
    outs = []
    for i in range(n):
        qi = q[:, i * Sb:(i + 1) * Sb]
        qpos = i * Sb + torch.arange(Sb, device=q.device)
        o = torch.zeros(B, Sb, H, Dn, dtype=torch.float32, device=q.device)
        m = torch.full((B, H, Sb), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros(B, H, Sb, dtype=torch.float32, device=q.device)
        for t in range(n):
            src = (i - t) % n
            blk = slice(src * Sb, (src + 1) * Sb)
            kpos = src * Sb + torch.arange(Sb, device=q.device)
            o, m, l = checkpoint(_flash_block_update, o, m, l, qi, k[:, blk], v[:, blk], qpos,
                                 kpos, scale, causal, None, use_reentrant=False)
        outs.append((o / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


@contextlib.contextmanager
def world1_ring(n: int):
    """While the block runs, the model's attention is ``ring_on_one_card``
    at sp=n (the control of (s2))."""
    from horovod_tpu_torch.models import transformer

    dispatch = transformer._attention_dispatch

    def ring(cfg, q, k, v, mask, mesh=None):
        if mask is not None:
            raise ValueError("world1_ring takes no mask")
        return ring_on_one_card(q, k, v, n, cfg.causal)

    transformer._attention_dispatch = ring
    try:
        yield
    finally:
        transformer._attention_dispatch = dispatch


def sp_variants_for(cards: int) -> list:
    """The variants a world of ``cards`` runs: n must divide the 12 heads
    for sp and the 8 experts for ep; (se) needs four cards."""
    out = []
    if 12 % cards == 0:
        out += ["s1_ulysses_flash", "s2_ring", "s2f_ring_f32_s2048"]
    if 8 % cards == 0:
        out.append("e1_moe")
    if cards == 4:
        out.append("se_moe_ulysses_flash")
    return out


def full_mesh(shape: dict):
    """A dp x ep x sp x tp mesh with every axis named (size 1 where not
    given)."""
    import horovod_tpu_torch as hvd

    return hvd.create_mesh({a: shape.get(a, 1) for a in ("dp", "ep", "sp", "tp")})


def gpt2_on(mesh, seq: int, **overrides):
    """GPT-2-small at full width and depth from torch seed 0 on ``mesh``
    (every ep layout of one seed holds the same experts)."""
    from horovod_tpu_torch.models.registry import get_model

    dev = mesh.device
    return get_model("gpt2-small").make_model(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0), mesh=mesh,
        max_len=max(1024, seq), **{"logits_dtype": torch.bfloat16, **overrides})


def flat_grads(hvd, model) -> torch.Tensor:
    """Every parameter's gradient flattened into host memory, the experts
    gathered along ep to their full (E, ...) shape."""
    parts = []
    for p in model.parameters():
        g = p.grad.detach()
        if hasattr(p, "expert_parallel") and model.mesh.shape.get("ep", 1) > 1:
            g = hvd.allgather(g, axis_name="ep")
        parts.append(g.float().reshape(-1).cpu())
    return torch.cat(parts)


def flat_by_name(grads: dict) -> torch.Tensor:
    """Gradients by name, flattened in f32 in name order."""
    return torch.cat([g.float().reshape(-1) for _, g in sorted(grads.items())])


def train_sp(hvd, fa, fb, mesh, overrides: dict, batch, keep_grads: bool) -> dict:
    """STEPS AdamW steps (lr 1e-4, wd 1e-4, eps 1e-8) of GPT-2-small on
    ``mesh`` through ``make_train_step`` (``shard_seq`` where sp > 1, the
    MoE auxiliary loss at 0.01 where there are experts, the gradients
    averaged over the ("dp", "sp") line) on the global batch of numpy seed
    42. Returns the record, the model and, with ``keep_grads``, the reduced
    step-1 gradients in host memory."""
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    Bn, Sn = batch
    model = gpt2_on(mesh, Sn, **overrides)
    ids = torch.from_numpy(get_model("gpt2-small").make_batch(Bn, seed=42, seq_len=Sn)[0])
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), axis_name=("dp", "sp"))
    moe = bool(overrides.get("n_experts"))
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh,
                                       shard_seq=mesh.shape["sp"] > 1,
                                       moe_aux_weight=MOE_AUX if moe else 0.0)
    got = {}
    inner_step = opt._inner.step

    def step(*a, **kw):     # the reduced step-1 gradients, as AdamW gets them
        if keep_grads and "grads" not in got:
            got["grads"] = flat_grads(hvd, model)
        return inner_step(*a, **kw)

    opt._inner.step = step
    state = init_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fb.reset_launches()
    losses, step_ms, dropped, aux = [], [], [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, loss = step_fn(state, ids, ids)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if moe:
            dropped.append(sum(int(d) for d in model.moe_dropped()))
            aux.append(float(model.moe_aux_loss().detach()))
    launches, other = fa.launches(), fb.launches()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if any(other.values()):
        raise AssertionError(f"fused-BN kernels launched: {other}")
    steady = statistics.median(step_ms[1:])
    rec = {"mesh": dict(mesh.shape), "batch": Bn, "seq": Sn,
           "overrides": {k: str(v) if isinstance(v, torch.dtype) else v
                         for k, v in overrides.items()},
           "losses": losses, "step_ms": step_ms, "median_step_ms_2_to_5": steady,
           "tokens_per_s": Bn * Sn / (steady / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / STEPS for k, v in launches.items()}}
    if moe:
        tokens = Bn * Sn
        rec.update(dropped_per_step=dropped, aux_per_step=aux, tokens_per_layer=tokens,
                   moe_layers=len(model.moe_blocks()),
                   capacity=max(1, int(MOE_CFG["capacity_factor"] * tokens
                                       / MOE_CFG["n_experts"])))
    layout = [(n, p.numel() * (model.mesh.shape.get("ep", 1)
                                if hasattr(p, "expert_parallel") else 1))
              for n, p in model.named_parameters()]
    return {"rec": rec, "model": model, "grads": got.get("grads"), "ids": ids,
            "layout": layout}


def flash_launches(blocks: int, remat: bool = False) -> dict:
    """The flash launches of a step that runs ``blocks`` attention blocks
    (layers times microbatches): K1 once a block, twice where ``remat``
    recomputes the forward in backward; each K2 kernel once."""
    return {"flash_fwd": blocks * (2 if remat else 1), "flash_bwd_dkdv": blocks,
            "flash_bwd_dq": blocks}


def check_launches(name: str, rec: dict, want: dict) -> None:
    got = {k: rec["launches_per_step"].get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches per step {rec['launches_per_step']}, "
                             f"expected {want}")


def moe_dispatch_bitwise(model, ids) -> dict:
    """The first Switch FFN's dispatch and combine by index against the
    one-hot einsum formulation (``dispatch_combine_einsum``) on that FFN's
    own input from a forward of the trained model on the path batch (B=4,
    S=2048): both must be bitwise equal. Times each."""
    from horovod_tpu_torch.models.transformer import (combine_by_index, dispatch_by_index,
                                                      dispatch_combine_einsum)

    mod = model.moe_blocks()[0]
    cfg = mod.cfg
    seen = []
    hook = mod.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach()))
    with torch.no_grad():
        model(ids.to(model.mesh.device))
    hook.remove()
    x = seen[0]
    with torch.no_grad():
        tokens, _, idx, gate, pos, keep, C, _, _ = mod.route(x)
        tok = tokens.to(cfg.dtype)
        slots = torch.where(keep, idx * C + pos, cfg.n_experts * C)

        def by_index():
            expert_in = dispatch_by_index(tok, slots, cfg.n_experts, C)
            return expert_in, combine_by_index(mod.experts(expert_in), slots, gate)

        def by_einsum():
            return dispatch_combine_einsum(tok, idx, gate, pos, keep, cfg.n_experts, C,
                                           mod.experts, cfg.dtype)

        got, want = by_index(), by_einsum()
        for name, a, b in (("expert_in", got[0], want[0]), ("out", got[1], want[1])):
            if not torch.equal(a, b):
                raise AssertionError(f"moe {name}: the index form differs from the einsum "
                                     f"form by {max_err(a, b)}")
        return {"input": "the first Switch FFN's own, after 5 steps",
                "tokens": tok.shape[0], "capacity": C, "kept": int(keep.sum()),
                "bitwise": True, "index_ms": time_ms(by_index, 5, 1),
                "einsum_ms": time_ms(by_einsum, 5, 1)}


def phase_moe(fa, fb):
    """GPT-2-small with eight Switch experts in every other FFN on one card:
    5 steps through make_train_step with the auxiliary loss; the flash
    kernels 12 times a step; the dispatch and combine bitwise against the
    einsum formulation. Its record is the control of the (e1) variant."""
    import horovod_tpu_torch as hvd

    out = train_sp(hvd, fa, fb, full_mesh({}), {"attn_impl": "flash", **MOE_CFG},
                   (MOE_B, MOE_S), keep_grads=torch.cuda.device_count() >= 2)
    rec, model = out.pop("rec"), out.pop("model")
    check_launches("moe", rec, flash_launches(model.cfg.n_layers))
    rec["dropped_share_step1"] = rec["dropped_per_step"][0] / (
        rec["tokens_per_layer"] * rec["moe_layers"])
    rec.update(phase="moe", model="gpt2-small", n_layers=model.cfg.n_layers,
               params=sum(p.numel() for p in model.parameters()),
               dispatch=moe_dispatch_bitwise(model, out.pop("ids")))
    emit(rec)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec, (out["grads"], out["layout"])


def phase_sp(fa, gen, dev):
    """Attention at B=2, S=8192, H=12, D=64, bf16, causal, forward and
    backward on a one-rank sp line: Ulysses through flash must be bitwise
    the port's flash_attention (o, dq, dk, dv) and launch K1 and the K2
    pair once; ring attention must match flash within the k1/k2 phases'
    tolerances. The ms of each."""
    import horovod_tpu_torch as hvd

    line = hvd.create_mesh({"sp": 1}).comm("sp")
    Hn = 12
    q, k, v = qkv_views(SP_B, SP_S, Hn, D, gen, dev)
    dout = torch.randn(SP_B, SP_S, Hn, D, generator=gen, device=dev).to(torch.bfloat16)

    def run(fn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves)
        o.backward(dout)
        return [o.detach()] + [t.grad for t in leaves]

    impls = {
        "flash": lambda a, b, c: fa.flash_attention(a, b, c, causal=True),
        "ulysses_flash": lambda a, b, c: hvd.ulysses_attention(a, b, c, line, causal=True,
                                                               use_flash=True),
        "ring": lambda a, b, c: hvd.ring_attention(a, b, c, line, causal=True),
    }
    want = run(impls["flash"])
    fa.reset_launches()
    uly = run(impls["ulysses_flash"])
    launches = fa.launches()
    if launches != {name: 1 for name in launches}:
        raise AssertionError(f"sp: Ulysses launched {launches}, expected each kernel once")
    names = ("o", "dq", "dk", "dv")
    for name, a, b in zip(names, uly, want):
        if not torch.equal(a, b):
            raise AssertionError(f"sp: Ulysses {name} not bitwise flash ({max_err(a, b)})")
    del uly
    ring = run(impls["ring"])
    rec = {"phase": "sp", "shape": [SP_B, SP_S, Hn, D], "causal": True, "sp": 1,
           "launches": launches, "ulysses_bitwise_flash": True}
    for name, a, b in zip(names, ring, want):
        tol = (O_ATOL, 0.0) if name == "o" else (GRAD_TOL, GRAD_TOL)
        rec[f"ring_{name}_max_abs_err"] = check_close(f"sp: ring {name}", a, b, *tol)
    del ring, want
    torch.cuda.empty_cache()
    for name, fn in impls.items():
        rec[f"{name}_fwd_bwd_ms"] = time_ms(lambda: run(fn), 3, 1)
    torch.cuda.reset_peak_memory_stats()
    run(impls["ring"])
    rec["ring_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def sp_rank(rank: int, size: int, init_file: str, queue, variants, tmp) -> None:
    """One spawned NCCL rank of the multi-card sp/ep variants: each
    variant's record; rank 0 writes its step-1 gradients under ``tmp``;
    every rank checks that its replicated parameters equal rank 0's
    bitwise after the 5 steps."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            recs = {}
            for name in variants:
                shape, overrides, batch, flash, _ = SP_VARIANTS[name]
                mesh = full_mesh(shape(size))
                out = train_sp(hvd, fa, fb, mesh, overrides, batch, keep_grads=True)
                rec, model = out["rec"], out["model"]
                check_launches(name, rec, flash_launches(model.cfg.n_layers if flash else 0))
                flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()
                                  if not hasattr(p, "expert_parallel")])
                root = hvd.broadcast(flat, root_rank=0)
                rec["replicated_bitwise_rank0"] = bool(torch.equal(flat, root))
                if not rec["replicated_bitwise_rank0"]:
                    raise AssertionError(f"{name}: replicated parameters differ from rank 0's")
                if rank == 0:
                    torch.save(out["grads"], os.path.join(tmp, f"{name}.pt"))
                recs[name] = rec
                del out, model, flat, root
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def worst_params(got: torch.Tensor, want: torch.Tensor, layout, top: int = 6) -> list:
    """The parameters that carry most of the squared gradient difference:
    [name, relative norm of its difference, share of the squared total]."""
    rows, off = [], 0
    total = float(((got - want) ** 2).sum())
    for name, n in layout:
        d = float(((got[off:off + n] - want[off:off + n]) ** 2).sum())
        rows.append([name, (d / max(float((want[off:off + n] ** 2).sum()), 1e-30)) ** 0.5,
                     d / max(total, 1e-30)])
        off += n
    return sorted(rows, key=lambda r: -r[2])[:top]


def split_noise(hvd, fa, fb, overrides: dict, batch, want: torch.Tensor) -> float:
    """The bf16 noise floor of the step-1 gradients on one card: the same
    global batch as two micro-batches of half its rows
    (``backward_passes_per_step=2``), against ``want``, the whole batch's,
    in relative norm."""
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    Bn, Sn = batch
    mesh = full_mesh({})
    model = gpt2_on(mesh, Sn, **overrides)
    ids = torch.from_numpy(get_model("gpt2-small").make_batch(Bn, seed=42, seq_len=Sn)[0])
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), backward_passes_per_step=2)
    got = {}
    inner_step = opt._inner.step

    def step(*a, **kw):
        got.setdefault("grads", flat_grads(hvd, model))
        return inner_step(*a, **kw)

    opt._inner.step = step
    init_fn, step_fn = make_train_step(model, opt, lm_loss, mesh=mesh)
    state = init_fn()
    for half in (ids[: Bn // 2], ids[Bn // 2:]):
        state, _ = step_fn(state, half, half)
    err = rel_norm(got["grads"], want)
    del model, opt, got, inner_step, step
    gc.collect()
    torch.cuda.empty_cache()
    return err


def phase_sp_multi(fa, fb, moe_rec, moe_grads) -> dict:
    """With two cards or more: the world-1 controls in this process, then
    the variants of ``sp_variants_for`` on one spawned NCCL rank per card,
    each held against its control (and printed against ``SP_PRINTED``'s): step-1 loss within 2e-3 relative and
    the 5 steps' within 1e-2, step-1 gradients (experts gathered) within
    1e-2 in relative norm, 12 launches of each flash kernel a step on every
    rank (0 for the ring), step-1 dropped tokens within 0.1% of the
    control's, and the replicated parameters bitwise equal on every rank."""
    import functools
    import tempfile

    import horovod_tpu_torch as hvd

    cards = torch.cuda.device_count()
    variants = sp_variants_for(cards)
    rec = {"phase": "sp_multi", "cards": cards, "variants": {}, "controls": {}}
    controls = {"control_moe": (moe_rec, *moe_grads)}
    wanted = {SP_VARIANTS[v][4] for v in variants}
    wanted |= {c for v in variants for c in SP_PRINTED.get(v, ())}
    for name in sorted(wanted - set(controls)):
        overrides, batch = SP_CONTROLS[name]
        attention = (world1_ring(cards) if name == "control_ring1_s8192"
                     else contextlib.nullcontext())
        with attention:
            out = train_sp(hvd, fa, fb, full_mesh({}), overrides, batch, keep_grads=True)
            controls[name] = (out["rec"], out["grads"], out["layout"])
            rec["controls"][name] = out["rec"]
            del out
            gc.collect()    # the step-1 capture closes a cycle through the optimizer
            torch.cuda.empty_cache()
            if "n_experts" not in overrides:
                rec["controls"][name]["step1_grad_rel_norm_split_in_two"] = split_noise(
                    hvd, fa, fb, overrides, batch, controls[name][1])
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(sp_rank, variants=variants, tmp=tmp), cards,
                            timeout=900)
        for name in variants:
            ctrl, ctrl_grads, *layout = controls[SP_VARIANTS[name][4]]
            got = ranks[0][name]
            v = {"rank0": got,
                 "median_step_ms_by_rank": [r[name]["median_step_ms_2_to_5"] for r in ranks],
                 "peak_mem_gb_by_rank": [r[name]["peak_mem_gb"] for r in ranks],
                 "launches_per_step_by_rank": [r[name]["launches_per_step"] for r in ranks],
                 "control_median_step_ms_2_to_5": ctrl["median_step_ms_2_to_5"],
                 "control_peak_mem_gb": ctrl["peak_mem_gb"]}
            slowest = max(v["median_step_ms_by_rank"])
            v["tokens_per_s_per_card"] = got["batch"] * got["seq"] / (slowest / 1e3) / cards
            v["loss1_rel_err"] = abs(got["losses"][0] - ctrl["losses"][0]) / abs(ctrl["losses"][0])
            v["loss_max_rel_err"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(got["losses"], ctrl["losses"]))
            grads = torch.load(f"{tmp}/{name}.pt")
            v["step1_grad_rel_norm_err"] = rel_norm(grads, ctrl_grads)
            if layout:
                v["step1_grad_worst_params"] = worst_params(grads, ctrl_grads, layout[0])
            del grads
            if "dropped_per_step" in ctrl:
                v["dropped_step1"] = got["dropped_per_step"][0]
                v["control_dropped_step1"] = ctrl["dropped_per_step"][0]
            rec["variants"][name] = v
            if v["loss1_rel_err"] > SP_LOSS1_RTOL or v["loss_max_rel_err"] > SP_LOSS_RTOL:
                failed.append(f"{name}: losses {got['losses']} vs {ctrl['losses']}")
            if v["step1_grad_rel_norm_err"] > SP_GRAD_RTOL:
                failed.append(f"{name}: step-1 gradients {v['step1_grad_rel_norm_err']} off "
                              "the control's in relative norm")
            if "dropped_step1" in v and abs(v["dropped_step1"] - v["control_dropped_step1"]) \
                    > DROP_RTOL * v["control_dropped_step1"]:
                failed.append(f"{name}: {v['dropped_step1']} tokens dropped at step 1, "
                              f"control {v['control_dropped_step1']}")
        for name in variants:
            # Not gated: the variant against controls that round otherwise
            # (ROADMAP C1).
            for ctrl in SP_PRINTED.get(name, ()):
                rec["variants"][name][f"step1_grad_rel_norm_vs_{ctrl}"] = rel_norm(
                    torch.load(f"{tmp}/{name}.pt"), controls[ctrl][1])
        if {"s1_ulysses_flash", "s2_ring"} <= set(variants):
            # The two sp variants cut the tokens alike and attend otherwise:
            # what they share against the control is the cut's bf16 noise.
            a, b = (torch.load(f"{tmp}/{n}.pt") for n in ("s1_ulysses_flash", "s2_ring"))
            rec["s1_vs_s2_step1_grad_rel_norm"] = rel_norm(b, a)
            del a, b
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    return rec


# ---------------------------------------------------------------------------
# Pipeline parallelism (phases ``pp`` and, with two cards or more,
# ``pp_multi``): GPT-2 1.3B ("GPT-2 1.3B + Adasum" of BASELINE.json;
# ``examples/jax_gpt2_train.py --pp --remat``) at full width and depth.
PP_MODEL = "gpt2-1p3b"
PP_B, PP_S = 8, 2048
PP_M = 8                   # microbatches of (p1)
PP_REMAT_B = 1             # remat against no remat, where both fit one card
PP_KERNEL_SHAPES = [(PP_B, PP_S), (1, PP_S)]   # K1/K2 at the path's batches
# The multi-card variants: mesh (its world is that many cards), microbatches
# (dp=2 leaves 4 rows a dp rank), remat.
PP_VARIANTS = {
    "p1_pp2": ({"pp": 2, "dp": 1}, PP_M, False),
    "p1_pp4": ({"pp": 4, "dp": 1}, PP_M, False),
    "p2_pp2_dp2": ({"pp": 2, "dp": 2}, 4, True),
}


def pp_worlds_for(cards: int) -> dict:
    """The variants by world size, each world no larger than the cards:
    (p1) pp=n for n in {2, 4}, (p2) pp=2 x dp=2 on four cards."""
    out = {}
    for name, (shape, _, _) in PP_VARIANTS.items():
        world = shape["pp"] * shape["dp"]
        if world <= cards:
            out.setdefault(world, []).append(name)
    return out


def gpt2_1p3b(mesh, pipelined: bool, seq: int = PP_S, bare: bool = False, **overrides):
    """GPT-2 1.3B from torch seed 0 (flash, bf16 logits, the scan-stacked
    layout, ``max_len`` the larger of its 2048 and ``seq``): ``PipelinedLM``
    or ``TransformerLM`` on ``mesh`` (``bare``: a ``TransformerLM`` built
    with no mesh); every pp and every tp layout of the seed holds the same
    weights."""
    import dataclasses

    from horovod_tpu_torch.models.pipelined import PipelinedLM
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS

    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = {"attn_impl": "flash", "logits_dtype": torch.bfloat16, "scan_layers": True,
          "max_len": max(GPT2_CONFIGS[PP_MODEL].max_len, seq), **overrides}
    num_microbatches = kw.pop("num_microbatches", None)
    if pipelined:
        return PipelinedLM(dataclasses.replace(GPT2_CONFIGS[PP_MODEL], **kw), mesh,
                           num_microbatches=num_microbatches, device=dev, generator=gen)
    return get_model(PP_MODEL).make_model(device=dev, generator=gen,
                                          mesh=None if bare else mesh, **kw)


def pp_ids(batch: int = PP_B, seq: int = PP_S):
    from horovod_tpu_torch.models.registry import get_model

    return torch.from_numpy(get_model(PP_MODEL).make_batch(batch, seed=42, seq_len=seq)[0])


def model_flops(cfg, Bn: int, Sn: int) -> float:
    """The model's training operations a step (forward and backward, 3x the
    forward; remat's recomputation not counted): 6 · (the matrix products'
    parameters a token runs through: one expert and the router in a Switch
    FFN) · tokens plus the causal attention products."""
    from horovod_tpu_torch.models.transformer import uses_moe

    d, L = cfg.d_model, cfg.n_layers
    moe = sum(uses_moe(cfg, i) for i in range(L))
    matmul_params = (L * (4 * d * d + 2 * d * cfg.d_ff) + moe * d * cfg.n_experts
                     + d * cfg.vocab_size)
    return (6 * matmul_params * Bn * Sn
            + 3 * L * 4 * cfg.head_dim * valid_pairs(Bn, Sn, cfg.n_heads, None, True))


def warm_pp(mesh) -> None:
    """One small gpipe forward and backward: NCCL creates the pp line's
    point-to-point communicators at their first send, outside the timing."""
    from horovod_tpu_torch.parallel.pipeline import gpipe

    x = torch.ones(mesh.shape["pp"], 8, device=mesh.device, requires_grad=True)
    gpipe(lambda p, a: a * 1.0, None, x, mesh=mesh).sum().backward()
    torch.cuda.synchronize()


def zero_reduced_grads(sharder, names: dict, chunk: int = 1 << 23) -> dict:
    """The gradient a ``ZeroSharder`` reduced, by parameter name, in host
    memory: each group's shard gradient (the reduce-scattered, averaged
    slice its shard optimizer steps on) all-gathered over the sharder's
    line ``chunk`` elements at a time, cut to the group's parameters."""
    from horovod_tpu_torch.parallel.collectives import all_gather

    n, out = sharder.comm.size, {}
    for g, shard in zip(sharder.groups, sharder.shards):
        full = torch.empty(n * g.k, dtype=shard.grad.dtype)
        for c in range(0, g.k, chunk):
            part = shard.grad[c: c + chunk]
            got = all_gather(part, sharder.comm).cpu().view(n, -1)
            full.view(n, g.k)[:, c: c + part.numel()] = got
        for p, piece in zip(g.params, torch.split(full[:g.total], g.sizes)):
            out[names[p]] = piece.view(p.shape)
    return out


def train_pp(hvd, fa, fb, mesh, pipelined: bool, overrides: dict, keep_grads: bool,
             steps: int = STEPS, loss_fn=None, zero: bool = False, rules=None,
             batch=(PP_B, PP_S), bare: bool = False, each_step=None, opt_kw=None,
             setup=None) -> dict:
    """``steps`` AdamW steps (lr 1e-4, wd 1e-4, eps 1e-8) of GPT-2 1.3B on
    ``mesh`` through ``make_train_step`` on the global ``batch`` (B, S) of
    numpy seed 42 (by default B=8, S=2048; the sequence cut over sp where
    the mesh has sp > 1), the optimizer reducing over the ("dp", "sp")
    line, the loss ``loss_fn`` (by default ``lm_loss``); ``bare``: the
    model built with no mesh (``gpt2_1p3b``). With Switch experts the
    auxiliary loss enters at MOE_AUX and the record holds each step's
    dropped tokens; ``each_step(model)``, where given, runs after each
    step, outside its time; ``setup(model, opt)``, once the optimizer is
    built. The optimizer is a ``DistributedOptimizer`` (with ``opt_kw``),
    or with ``zero`` or ``rules`` the plain AdamW,
    which the step wraps (``zero=True``: ZeRO-1 over the data line;
    ``rules=FSDP_RULES``: the model built under them). Returns the record
    (with the parameter, gradient and optimizer-state bytes this rank
    holds), the model and, with ``keep_grads``, this rank's step-1
    gradients by name, reduced over the data line, in host memory (out of
    the peak); under ZeRO, the reduced slices its shard optimizer stepped
    on, joined over the line (``zero_reduced_grads``)."""
    from horovod_tpu_torch.parallel.train import lm_loss, make_train_step

    Bn, Sn = batch
    model = gpt2_1p3b(mesh, pipelined, seq=Sn, bare=bare, **overrides,
                      **({"rules": rules} if rules else {}))
    ids = pp_ids(Bn, Sn)
    inner = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    plain = zero or rules is not None
    opt = inner if plain else hvd.DistributedOptimizer(inner, axis_name=("dp", "sp"),
                                                       **(opt_kw or {}))
    moe = bool(model.cfg.n_experts)
    if setup is not None:
        setup(model, opt)
    init_fn, step_fn = make_train_step(model, opt, loss_fn or lm_loss, mesh=mesh, zero=zero,
                                       rules=rules, shard_seq=mesh.shape.get("sp", 1) > 1,
                                       moe_aux_weight=MOE_AUX if moe else 0.0)
    got = {}
    inner_step = inner.step

    def step(*a, **kw):     # the reduced step-1 gradients, as AdamW gets them
        if keep_grads and "grads" not in got:
            got["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        return inner_step(*a, **kw)

    inner.step = step
    state = init_fn()
    if zero:
        # ZeRO steps its shard optimizer on this rank's slice of the reduced
        # gradient and leaves each rank's own gradients in .grad: record, at
        # step 1, the slices the shard optimizer gets, joined over the line.
        sharder = state.optimizer._zero
        shard_step = sharder.inner.step
        names = {p: n for n, p in model.named_parameters()}

        def zstep(*a, **kw):
            if keep_grads and "grads" not in got:
                got["grads"] = zero_reduced_grads(sharder, names)
            return shard_step(*a, **kw)

        sharder.inner.step = zstep
    if pipelined and mesh.shape["pp"] > 1:
        warm_pp(mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fb.reset_launches()
    losses, step_ms, dropped = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, ids, ids)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if moe:
            dropped.append(sum(int(d) for d in model.moe_dropped()))
        if each_step is not None:
            each_step(model)
    launches, other = fa.launches(), fb.launches()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if any(other.values()):
        raise AssertionError(f"fused-BN kernels launched: {other}")
    steady = statistics.median(step_ms[1:]) if steps > 1 else step_ms[0]
    flops = model_flops(model.cfg, Bn, Sn)
    params = list(model.parameters())
    rec = {"mesh": dict(mesh.shape), "batch": Bn, "seq": Sn,
           "pipelined": pipelined, "remat": model.cfg.remat,
           "microbatches": getattr(model, "num_microbatches", None),
           "zero": zero, "rules": "FSDP_RULES" if rules is not None else None,
           "params_held": sum(p.numel() for p in params),
           "param_bytes": sum(p.numel() * p.element_size() for p in params),
           "grad_bytes": sum(p.grad.numel() * p.grad.element_size() for p in params
                             if p.grad is not None),
           "state_bytes": state.optimizer.state_bytes(),
           "losses": losses, "step_ms": step_ms, "median_step_ms_2_to_5": steady,
           "tokens_per_s": Bn * Sn / (steady / 1e3),
           "model_tflops_per_step": flops / 1e12,
           "model_tflops_per_s": flops / (steady / 1e3) / 1e12,
           "model_flops_share_of_989": flops / (steady / 1e3) / PEAK_BF16_FLOPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()}}
    if moe:
        rec["dropped_per_step"] = dropped
    del opt, inner, inner_step, step, state, params
    return {"rec": rec, "model": model, "grads": got.get("grads")}


# The plain version materialises (B, H, S, S) f32 scores, and its backward
# several such tensors: above this many bytes of one, it is held and timed
# on the first batch row alone (rows are independent).
PLAIN_SCORE_BYTES = 2 ** 32


def flash_at(fa, gen, dev, Bn: int, Sn: int, Hn: int, Dn: int) -> dict:
    """K1 and the K2 pair at (Bn, Sn, Hn, Dn), causal, against their plain
    versions (O_ATOL, LSE_ATOL, GRAD_TOL), timed alone beside SDPA and the
    aten flash backward (yardsticks the port never calls), with bounds. The
    plain version runs on ``plain_batch`` rows: all of them, or the first
    where their f32 scores pass PLAIN_SCORE_BYTES."""
    import torch.nn.functional as F

    q, k, v = qkv_views(Bn, Sn, Hn, Dn, gen, dev)
    pb = Bn if Bn * Hn * Sn * Sn * 4 <= PLAIN_SCORE_BYTES else 1
    qp, kp, vp = q[:pb], k[:pb], v[:pb]
    o, lse = fa.flash_fwd_cuda(q, k, v, None, True)
    o_ref, lse_ref = fa._flash_fwd_plain(qp, kp, vp, None, True)
    dout = torch.randn(Bn, Sn, Hn, Dn, generator=gen, device=dev).to(torch.bfloat16)
    delta = (dout.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, None, dout, lse, delta, True)
    dq = fa.flash_bwd_dq_cuda(q, k, v, None, dout, lse, delta, True)
    torch.cuda.synchronize()
    tag = f"({Bn}, {Sn}, {Hn}, {Dn})"
    rec = {"shape": [Bn, Sn, Hn, Dn], "causal": True, "plain_batch": pb,
           "tolerance": {"o_atol": O_ATOL, "lse_atol": LSE_ATOL, "grad_tol": GRAD_TOL},
           "o_max_abs_err": check_close(f"K1 o {tag}", o[:pb], o_ref, O_ATOL),
           "lse_max_abs_err": check_close(f"K1 lse {tag}", lse[:pb], lse_ref, LSE_ATOL)}
    del o_ref, lse_ref
    torch.cuda.empty_cache()
    refs = fa._flash_bwd_plain(qp, kp, vp, None, dout[:pb], True)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        rec[f"{name}_max_abs_err"] = check_close(f"K2 {name} {tag}", got[:pb], want,
                                                 GRAD_TOL, GRAD_TOL)
    del refs
    torch.cuda.empty_cache()
    rec["fwd_ms"] = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, None, True), 30)
    rec["fwd_plain_ms"] = time_ms(lambda: fa._flash_fwd_plain(qp, kp, vp, None, True), 3)
    rec["dkdv_ms"] = time_ms(
        lambda: fa.flash_bwd_dkdv_cuda(q, k, v, None, dout, lse, delta, True), 20)
    rec["dq_ms"] = time_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, None, dout, lse, delta, True),
                           20)
    rec["pair_ms"] = rec["dkdv_ms"] + rec["dq_ms"]
    rec["bwd_plain_ms"] = time_ms(
        lambda: fa._flash_bwd_plain(qp, kp, vp, None, dout[:pb], True), 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec["sdpa_fwd_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 30)
    rec["library_pair_ms"] = _library_bwd_ms(q, k, v, dout)
    pairs = valid_pairs(Bn, Sn, Hn, None, True)
    n = Bn * Sn * Hn * Dn
    rows = Bn * Hn * Sn * 4
    rec["fwd_flops"], rec["fwd_bytes"] = 4 * Dn * pairs, 4 * n * 2 + rows
    rec["dkdv_flops"], rec["dkdv_bytes"] = 8 * Dn * pairs, 4 * n * 2 + 2 * rows + 2 * n * 2
    rec["dq_flops"], rec["dq_bytes"] = 6 * Dn * pairs, 4 * n * 2 + 2 * rows + n * 2
    for part in ("fwd", "dkdv", "dq"):
        rec[f"{part}_bound_ms"], rec[f"{part}_bound_by"] = bound(rec[f"{part}_flops"],
                                                                 rec[f"{part}_bytes"])
        rec[f"{part}_bound_share"] = rec[f"{part}_bound_ms"] / rec[f"{part}_ms"]
        rec[f"{part}_tflops"] = rec[f"{part}_flops"] / (rec[f"{part}_ms"] * 1e-3) / 1e12
    rec["pair_bound_ms"] = rec["dkdv_bound_ms"] + rec["dq_bound_ms"]
    rec["pair_bound_share"] = rec["pair_bound_ms"] / rec["pair_ms"]
    del q, k, v, o, lse, dout, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return rec


def remat_bitwise(mesh) -> dict:
    """GPT-2 1.3B with and without remat at B=1, S=2048 on the same weights:
    the loss and every gradient of one forward and backward bitwise equal."""
    from horovod_tpu_torch.parallel.train import lm_loss

    ids = pp_ids(PP_REMAT_B).to(mesh.device)
    out = {}
    for remat in (True, False):
        model = gpt2_1p3b(mesh, False, remat=remat)
        torch.cuda.reset_peak_memory_stats()
        loss = lm_loss(model(ids), ids)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in model.parameters()],
                      torch.cuda.max_memory_allocated() / 1e9)
        del model, loss
    (l1, g1, m1), (l0, g0, m0) = out[True], out[False]
    bad = [i for i, (a, b) in enumerate(zip(g1, g0)) if not torch.equal(a, b)]
    if not torch.equal(l1, l0) or bad:
        raise AssertionError(f"pp: remat is not bitwise no remat (loss {float(l1)} vs "
                             f"{float(l0)}, {len(bad)} gradients differ)")
    del out, g1, g0
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": PP_REMAT_B, "seq": PP_S, "bitwise": True, "loss": float(l1),
            "peak_mem_gb_remat": m1, "peak_mem_gb_no_remat": m0}


def phase_pp(fa, fb, gen, dev):
    """GPT-2 1.3B (24 x 2048, 16 heads of 128, d_ff 8192, vocab 50257) at
    B=8, S=2048, bf16, flash, remat, AdamW: ``TransformerLM`` takes one step
    through ``make_train_step``; ``PipelinedLM`` on a pp=1 mesh (the
    degenerate gpipe) from the same seed holds the same weights and takes 5
    steps, whose step-1 loss and gradients must be bitwise the LM's, whose
    last loss must be below the first, and which must launch K1 48 times a
    step and each K2 kernel 24 times. Then remat against no remat at B=1 (bitwise), and K1
    and the K2 pair at the path's D=128 shapes against their plain
    versions. The record's pipelined run is the control of ``pp_multi``."""
    import horovod_tpu_torch as hvd

    mesh = hvd.create_mesh({"pp": 1, "dp": 1, "sp": 1})
    lm = train_pp(hvd, fa, fb, mesh, False, {"remat": True}, keep_grads=True, steps=1)
    lm_rec, lm_grads = lm["rec"], lm["grads"]
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    pp = train_pp(hvd, fa, fb, mesh, True, {"remat": True}, keep_grads=True)
    rec, model = pp["rec"], pp["model"]
    n_layers = model.cfg.n_layers
    check_launches("pp", rec, flash_launches(n_layers, remat=True))
    if rec["losses"][0] != lm_rec["losses"][0]:
        raise AssertionError(f"pp: step-1 loss {rec['losses'][0]} is not the LM's "
                             f"{lm_rec['losses'][0]}")
    differ = [n for n, g in pp["grads"].items() if not torch.equal(g, lm_grads[n])]
    if set(pp["grads"]) != set(lm_grads) or differ:
        raise AssertionError(f"pp: step-1 gradients not bitwise the LM's: {differ[:4]}")
    # Falling as the JAX package's pipeline test asserts it: the last loss
    # below the first (AdamW on one batch need not fall at every step).
    if not rec["losses"][-1] < rec["losses"][0]:
        raise AssertionError(f"pp: losses do not fall: {rec['losses']}")
    rec.update(phase="pp", model=PP_MODEL, n_layers=n_layers, d_model=model.cfg.d_model,
               n_heads=model.cfg.n_heads, head_dim=model.cfg.head_dim,
               vocab=model.cfg.vocab_size, lm_step1_bitwise=True,
               lm_step_ms=lm_rec["step_ms"][0], lm_peak_mem_gb=lm_rec["peak_mem_gb"])
    layout = [(n, g.numel()) for n, g in sorted(pp["grads"].items())]
    flat = flat_by_name(pp["grads"])
    del pp, model, lm_grads
    gc.collect()
    torch.cuda.empty_cache()
    rec["remat_vs_no_remat"] = remat_bitwise(mesh)
    rec["kernels_d128"] = {f"{Bn}x{Sn}": flash_at(fa, gen, dev, Bn, Sn, 16, 128)
                           for Bn, Sn in PP_KERNEL_SHAPES}
    emit(rec)
    return rec, (flat, layout)


def pp_rank(rank: int, size: int, init_file: str, queue, variants, tmp) -> None:
    """One spawned NCCL rank of ``pp_multi``: each variant's record; the
    ranks of dp index 0 write their step-1 gradients by name under ``tmp``;
    every rank checks that its pp-replicated parameters equal rank 0's, and
    its stage's blocks those of its dp replicas, bitwise after 5 steps."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            recs = {}
            for name in variants:
                shape, M, remat = PP_VARIANTS[name]
                mesh = hvd.create_mesh({**shape, "sp": 1})
                out = train_pp(hvd, fa, fb, mesh, True,
                               {"remat": remat, "num_microbatches": M}, keep_grads=True)
                rec, model = out["rec"], out["model"]
                blocks = model.cfg.n_layers // mesh.shape["pp"] * M
                check_launches(name, rec, flash_launches(blocks, remat))
                params = dict(model.named_parameters())
                repl = torch.cat([p.detach().reshape(-1) for n, p in params.items()
                                  if not n.startswith("stack.")])
                stage = torch.cat([p.detach().reshape(-1) for n, p in params.items()
                                   if n.startswith("stack.")])
                rec["replicated_bitwise_rank0"] = bool(torch.equal(
                    repl, hvd.broadcast(repl, root_rank=0)))
                rec["stage_bitwise_dp_replicas"] = bool(torch.equal(
                    stage, hvd.broadcast(stage, root_rank=0, axis_name="dp")))
                if not (rec["replicated_bitwise_rank0"] and rec["stage_bitwise_dp_replicas"]):
                    raise AssertionError(f"{name}: replicas differ: {rec}")
                rec["coords"] = dict(mesh.coords)
                rec["layers"] = [model.layer_range.start, model.layer_range.stop]
                if mesh.coords["dp"] == 0:
                    save_grads(tmp, name, mesh.coords, out["grads"])
                recs[name] = rec
                del out, model, params, repl, stage
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_pp_multi(pp_rec, control) -> dict:
    """With two cards or more: the variants of ``pp_variants_for`` on one
    spawned NCCL rank per card, each against the world-1 control (phase
    ``pp``: the same model, weights and global batch): step-1 loss within
    2e-3 relative and the 5 steps' within 1e-2, step-1 gradients (the
    stages' gathered to the full model) within 1e-2 in relative norm, the
    exact flash launches per rank, pp-replicated parameters bitwise on
    every rank; the step ms beside GPipe's bubble (S-1)/(M+S-1)."""
    cards = torch.cuda.device_count()
    ctrl_flat, layout = control
    rec = {"phase": "pp_multi", "cards": cards, "variants": {},
           "control_median_step_ms_2_to_5": pp_rec["median_step_ms_2_to_5"],
           "control_losses": pp_rec["losses"]}
    failed = []
    for world, variants in sorted(pp_worlds_for(cards).items()):
        failed += _pp_world(world, variants, rec, pp_rec, ctrl_flat, layout)
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    return rec


def _pp_world(world: int, variants, rec: dict, pp_rec: dict, ctrl_flat, layout) -> list:
    """``variants`` on one spawned NCCL rank per card of a world of
    ``world`` cards, each held against the control; the failed gates."""
    import functools
    import tempfile

    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(pp_rank, variants=variants, tmp=tmp), world,
                            timeout=900)
        for name in variants:
            got = ranks[0][name]
            S, M = got["mesh"]["pp"], got["microbatches"]
            grads = joined_grads(tmp, name, got["mesh"], False, layout)
            v = {"rank0": got,
                 "median_step_ms_by_rank": [r[name]["median_step_ms_2_to_5"] for r in ranks],
                 "peak_mem_gb_by_rank": [r[name]["peak_mem_gb"] for r in ranks],
                 "params_held_by_rank": [r[name]["params_held"] for r in ranks],
                 "launches_per_step_by_rank": [r[name]["launches_per_step"] for r in ranks],
                 "bubble": (S - 1) / (M + S - 1)}
            slowest = max(v["median_step_ms_by_rank"])
            dp = got["mesh"]["dp"]
            # The step at pp=S x dp if the stages split the control's work
            # evenly and only the bubble were added.
            v["control_split_with_bubble_ms"] = (pp_rec["median_step_ms_2_to_5"] / (S * dp)
                                                 * (M + S - 1) / M)
            v["tokens_per_s"] = PP_B * PP_S / (slowest / 1e3)
            v["loss1_rel_err"] = abs(got["losses"][0] - pp_rec["losses"][0]) / abs(
                pp_rec["losses"][0])
            v["loss_max_rel_err"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(got["losses"], pp_rec["losses"]))
            v["step1_grad_rel_norm_err"] = rel_norm(grads, ctrl_flat)
            v["step1_grad_worst_params"] = worst_params(grads, ctrl_flat, layout)
            del grads
            rec["variants"][name] = v
            if v["loss1_rel_err"] > SP_LOSS1_RTOL or v["loss_max_rel_err"] > SP_LOSS_RTOL:
                failed.append(f"{name}: losses {got['losses']} vs {pp_rec['losses']}")
            if v["step1_grad_rel_norm_err"] > SP_GRAD_RTOL:
                failed.append(f"{name}: step-1 gradients {v['step1_grad_rel_norm_err']} off "
                              "the control's in relative norm")
    return failed


# ---------------------------------------------------------------------------
# Tensor parallelism (phases ``tp`` and, with two cards or more,
# ``tp_multi``): GPT-2 1.3B (``examples/jax_gpt2_train.py:9-11``, ``--dp 8
# --tp 4`` at gpt2-1p3b) at full width and depth, flash at H/tp heads.
TP_HEADS = (8, 4)          # the local heads at tp=2 and tp=4
XENT_LOSS_RTOL = 1e-5      # f32 sums of 16,376 rows in two orders
XENT_GRAD_RTOL = 2 ** -7   # the logits' gradient is bf16: one ulp
# In f32 with dense attention (the kernels take bf16): the tp path without
# bf16's rounding.
TP_F32 = {"dtype": torch.float32, "logits_dtype": torch.float32, "attn_impl": "dense"}
# The gates of a variant with tp > 1 (ROADMAP C3): an f32 witness's step-1
# gradients within WITNESS_RTOL of the f32 control, over the whole model
# and in every tensor; a bf16 variant's distance from the f32 control at
# most BF16_AMPLIFICATION times the world-1 bf16 run's (phase pp's).
WITNESS_RTOL = 1e-4
BF16_AMPLIFICATION = 2.0
# The multi-card variants: mesh (its world is that many cards), model
# overrides (beside remat), steps, the world-1 control: "pp" is phase pp's
# run, "f32" the same model in f32 with dense attention, one step.
TP_VARIANTS = {
    "t1_tp2": ({"dp": 1, "tp": 2}, {}, STEPS, "pp"),
    "t1_tp4": ({"dp": 1, "tp": 4}, {}, STEPS, "pp"),
    "t2_dp2_tp2": ({"dp": 2, "tp": 2}, {}, STEPS, "pp"),
    "t1f_tp2_f32": ({"dp": 1, "tp": 2}, TP_F32, 1, "f32"),
    "t1f_tp4_f32": ({"dp": 1, "tp": 4}, TP_F32, 1, "f32"),
    "t2f_dp2_tp2_f32": ({"dp": 2, "tp": 2}, TP_F32, 1, "f32"),
}


def tp_worlds_for(cards: int) -> dict:
    """The variants by world size, each world no larger than the cards:
    (t1) tp=2, and tp=4 on four cards; (t2) dp=2 x tp=2 on four cards; each
    beside its f32 witness."""
    out = {}
    for name, (shape, _, _, _) in TP_VARIANTS.items():
        world = shape["dp"] * shape["tp"]
        if world <= cards:
            out.setdefault(world, []).append(name)
    return out


def xent_at_one_rank(dev) -> dict:
    """``vocab_parallel_lm_loss`` on a tp line of one member against
    ``lm_loss`` at the full vocabulary, on bf16 logits of the path's shape
    (8, 2048, 50257) from torch seed 7 and the path's ids: the loss within
    XENT_LOSS_RTOL, the logits' gradient within one bf16 ulp; each timed
    forward and backward."""
    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS
    from horovod_tpu_torch.parallel.mesh import Comm
    from horovod_tpu_torch.parallel.tensor import vocab_parallel_lm_loss
    from horovod_tpu_torch.parallel.train import lm_loss

    V = GPT2_CONFIGS[PP_MODEL].vocab_size
    gen = torch.Generator(device=dev).manual_seed(7)
    logits = torch.randn(PP_B, PP_S, V, generator=gen, device=dev).to(torch.bfloat16)
    ids = pp_ids().to(dev)
    one = Comm(None, 1, 0, (0,))
    fns = {"vocab_parallel": lambda z: vocab_parallel_lm_loss(z, ids, one, V),
           "lm_loss": lambda z: lm_loss(z, ids)}

    def run(fn):
        z = logits.detach().requires_grad_(True)
        loss = fn(z)
        loss.backward()
        return loss.detach(), z.grad

    (la, ga), (lb, gb) = run(fns["vocab_parallel"]), run(fns["lm_loss"])
    rec = {"shape": list(logits.shape), "loss": float(la), "loss_lm_loss": float(lb),
           "loss_rel_err": abs(float(la) - float(lb)) / abs(float(lb)),
           "grad_max_abs_err": max_err(ga, gb),
           "tolerance": {"loss_rtol": XENT_LOSS_RTOL, "grad_rtol": XENT_GRAD_RTOL}}
    if rec["loss_rel_err"] > XENT_LOSS_RTOL:
        raise AssertionError(f"tp: vocab-parallel loss {rec['loss']} vs lm_loss {rec['loss_lm_loss']}")
    bad = ((ga.float() - gb.float()).abs() > XENT_GRAD_RTOL * gb.float().abs()).sum()
    if int(bad):
        raise AssertionError(f"tp: {int(bad)} logit gradients past one bf16 ulp of lm_loss's "
                             f"(max abs err {rec['grad_max_abs_err']})")
    del ga, gb
    for name, fn in fns.items():
        rec[f"{name}_fwd_bwd_ms"] = time_ms(lambda: run(fn), 5, 1)
    del logits
    torch.cuda.empty_cache()
    return rec


def vocab_loss_spread(hvd, fa, fb, mesh, ctrl_flat) -> dict:
    """One step of the world-1 model with ``vocab_parallel_lm_loss`` on a tp
    line of one member: its step-1 loss and the relative norm of its step-1
    gradients against ``ctrl_flat`` (``lm_loss``'s)."""
    import functools

    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS
    from horovod_tpu_torch.parallel.mesh import Comm
    from horovod_tpu_torch.parallel.tensor import vocab_parallel_lm_loss

    loss_fn = functools.partial(vocab_parallel_lm_loss, axis=Comm(None, 1, 0, (0,)),
                                vocab_size=GPT2_CONFIGS[PP_MODEL].vocab_size)
    out = train_pp(hvd, fa, fb, mesh, False, {"remat": True}, keep_grads=True, steps=1,
                   loss_fn=loss_fn)
    flat = flat_by_name(out["grads"])
    rec = {"loss1": out["rec"]["losses"][0], "step1_grad_rel_norm_vs_pp": rel_norm(flat, ctrl_flat)}
    del out, flat
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_tp(fa, fb, gen, dev, pp_rec, control) -> dict:
    """GPT-2 1.3B at B=8, S=2048, bf16, flash, remat, AdamW: ``TransformerLM``
    built on a dp=1 x tp=1 mesh through the tp layers takes 5 steps, whose
    step-1 loss and gradients must be bitwise phase ``pp``'s (the
    pipelined run, itself bitwise the LM's), with 48 launches of K1 and 24
    of each K2 kernel a step. Then K1 and the K2 pair at the tp path's
    shapes (8, 2048, 8, 128) and (8, 2048, 4, 128) against their plain
    versions, and the vocab-parallel cross-entropy at tp=1 against
    ``lm_loss``. Printed, not gated: the step-1 gradients of one step with
    the vocab-parallel loss at tp=1 against phase pp's, the spread a bf16
    backward gives a change in the last bits of the logits' gradient."""
    import horovod_tpu_torch as hvd

    ctrl_flat, layout = control
    mesh = hvd.create_mesh({"dp": 1, "sp": 1, "tp": 1})
    out = train_pp(hvd, fa, fb, mesh, False, {"remat": True}, keep_grads=True)
    rec, model = out["rec"], out["model"]
    check_launches("tp", rec, flash_launches(model.cfg.n_layers, remat=True))
    if rec["losses"][0] != pp_rec["losses"][0]:
        raise AssertionError(f"tp: step-1 loss {rec['losses'][0]} is not phase pp's "
                             f"{pp_rec['losses'][0]}")
    if [(n, g.numel()) for n, g in sorted(out["grads"].items())] != layout:
        raise AssertionError("tp: the parameters are not phase pp's")
    flat = flat_by_name(out["grads"])
    if not torch.equal(flat, ctrl_flat):
        raise AssertionError(f"tp: step-1 gradients not bitwise phase pp's "
                             f"({rel_norm(flat, ctrl_flat)} in relative norm)")
    rec.update(phase="tp", model=PP_MODEL, step1_bitwise_pp=True,
               losses_equal_pp=rec["losses"] == pp_rec["losses"])
    del out, model, flat
    gc.collect()
    torch.cuda.empty_cache()
    rec["world1_vocab_parallel_loss"] = vocab_loss_spread(hvd, fa, fb, mesh, ctrl_flat)
    rec["kernels_d128"] = {f"{PP_B}x{PP_S}x{Hn}": flash_at(fa, gen, dev, PP_B, PP_S, Hn, 128)
                           for Hn in TP_HEADS}
    rec["xent_tp1"] = xent_at_one_rank(dev)
    emit(rec)
    return rec


def tp_rank(rank: int, size: int, init_file: str, queue, variants, tmp) -> None:
    """One spawned NCCL rank of ``tp_multi``: each variant's record; the
    ranks of dp index 0 write their step-1 gradients by name under ``tmp``;
    every rank checks after 5 steps that its tp-replicated parameters equal
    those of its tp line's first rank, and all its parameters those of its
    dp line's first rank, bitwise."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            recs = {}
            for name in variants:
                shape, overrides, steps, _ = TP_VARIANTS[name]
                mesh = hvd.create_mesh({**shape, "sp": 1})
                out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, **overrides},
                               keep_grads=True, steps=steps)
                rec, model = out["rec"], out["model"]
                flash = model.cfg.attn_impl == "flash"
                check_launches(name, rec, flash_launches(model.cfg.n_layers if flash else 0,
                                                         remat=True))
                params = list(model.parameters())
                repl = torch.cat([p.detach().reshape(-1) for p in params
                                  if not hasattr(p, "tensor_parallel")])
                mine = torch.cat([p.detach().reshape(-1) for p in params])
                rec["tp_replicated_bitwise"] = bool(torch.equal(
                    repl, hvd.broadcast(repl, root_rank=0, axis_name="tp")))
                rec["dp_replicas_bitwise"] = bool(torch.equal(
                    mine, hvd.broadcast(mine, root_rank=0, axis_name="dp")))
                if not (rec["tp_replicated_bitwise"] and rec["dp_replicas_bitwise"]):
                    raise AssertionError(f"{name}: replicas differ: {rec}")
                rec["coords"] = dict(mesh.coords)
                rec["tp_replicated_params"] = repl.numel()
                if mesh.coords["dp"] == 0:
                    save_grads(tmp, name, mesh.coords, out["grads"])
                recs[name] = rec
                del out, model, params, repl, mine
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def f32_control(hvd, fa, fb) -> tuple:
    """One step of the world-1 model in f32 with dense attention (the f32
    witnesses' control, and the reference a bf16 variant's distance is
    taken from): its record and its step-1 gradients, flat in name order."""
    mesh = hvd.create_mesh({"dp": 1, "sp": 1, "tp": 1})
    out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, **TP_F32}, keep_grads=True,
                   steps=1)
    flat = flat_by_name(out["grads"])
    rec = out["rec"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return rec, flat


def multi_controls(pp_rec, control, f32) -> dict:
    """The world-1 controls of the multi-card phases: phase pp's bf16 run,
    the f32 run, and e_1, the bf16 run's distance from the f32 one (the
    relative norm of the difference of their step-1 gradients)."""
    return {"pp": (pp_rec, control[0]), "f32": f32,
            "e_1": rel_norm(control[0], f32[1])}


def param_rel_norms(got: torch.Tensor, want: torch.Tensor, layout) -> dict:
    """Each parameter's relative norm of ``got - want``."""
    out, off = {}, 0
    for name, n in layout:
        w = want[off:off + n]
        out[name] = float((got[off:off + n] - w).norm() / max(float(w.norm()), 1e-30))
        off += n
    return out


def grad_gates(name: str, kind: str, grads: torch.Tensor, controls: dict, layout) -> tuple:
    """The step-1 gradient gate of a multi-card variant: ``kind`` "pp"
    within SP_GRAD_RTOL of phase pp's in relative norm; "bf16" (tp > 1) its
    distance e_v from the f32 control at most BF16_AMPLIFICATION · e_1, the
    distance from phase pp's printed; "f32" (a witness) within WITNESS_RTOL
    of the f32 control over the whole model and in every tensor. Returns
    the record's fields and the failures."""
    want = controls["f32" if kind == "f32" else "pp"][1]
    v = {"grad_gate": kind, "step1_grad_rel_norm_err": rel_norm(grads, want),
         "step1_grad_worst_params": worst_params(grads, want, layout)}
    failed = []
    if kind == "pp" and v["step1_grad_rel_norm_err"] > SP_GRAD_RTOL:
        failed.append(f"{name}: step-1 gradients {v['step1_grad_rel_norm_err']} off the "
                      "control's in relative norm")
    if kind == "bf16":
        v["e_v"], v["e_1"] = rel_norm(grads, controls["f32"][1]), controls["e_1"]
        v["e_v_over_e_1"] = v["e_v"] / v["e_1"]
        if v["e_v"] > BF16_AMPLIFICATION * v["e_1"]:
            failed.append(f"{name}: step-1 gradients {v['e_v']} from the f32 control, past "
                          f"{BF16_AMPLIFICATION} x world 1's {v['e_1']}")
    if kind == "f32":
        per = param_rel_norms(grads, want, layout)
        worst = max(per, key=per.get)
        v["step1_grad_max_param_rel_norm_err"] = [worst, per[worst]]
        if v["step1_grad_rel_norm_err"] > WITNESS_RTOL or per[worst] > WITNESS_RTOL:
            failed.append(f"{name}: step-1 gradients {v['step1_grad_rel_norm_err']} off the "
                          f"f32 control ({worst}: {per[worst]}), past {WITNESS_RTOL}")
    return v, failed


def phase_tp_multi(pp_rec, control, f32) -> dict:
    """With two cards or more: the variants of ``tp_worlds_for`` on one
    spawned NCCL rank per card, each against its world-1 control (the same
    model, weights and global batch): phase ``pp``'s run, or for the f32
    witnesses ``f32``, the same model in f32 with dense attention, one
    step. Gates: step-1 loss within 2e-3 relative and the steps' within
    1e-2; step-1 gradients (the tp shards joined to the full model by
    ``tp_join``) by ``grad_gates``: a witness within 1e-4 of the f32
    control over the whole model and in every tensor, a bf16 variant's
    distance from the f32 control at most twice phase pp's (the distance
    from phase pp's printed); 48 launches of K1 and 24 of each K2 kernel a
    step per rank (none in f32), the tp-replicated parameters bitwise on
    every rank of their tp line; per rank the step ms, tokens/s, peak
    memory and parameters held."""
    cards = torch.cuda.device_count()
    controls = multi_controls(pp_rec, control, f32)
    rec = {"phase": "tp_multi", "cards": cards, "variants": {}, "controls": {
        "pp": {k: pp_rec[k] for k in ("median_step_ms_2_to_5", "peak_mem_gb", "losses")},
        "f32": {k: f32[0][k] for k in ("step_ms", "peak_mem_gb", "losses")},
        "e_1": controls["e_1"]}}
    failed = []
    for world, variants in sorted(tp_worlds_for(cards).items()):
        failed += _tp_world(world, variants, rec, controls, control[1])
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    return rec


def _tp_world(world: int, variants, rec: dict, controls: dict, layout) -> list:
    """``variants`` on one spawned NCCL rank per card of a world of
    ``world`` cards, each held against its control; the failed gates."""
    import functools
    import tempfile

    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(tp_rank, variants=variants, tmp=tmp), world,
                            timeout=900)
        for name in variants:
            kind = TP_VARIANTS[name][3]
            ctrl_rec = controls[kind][0]
            got = ranks[0][name]
            grads = joined_grads(tmp, name, got["mesh"], False, layout)
            v = {"rank0": got,
                 "median_step_ms_by_rank": [r[name]["median_step_ms_2_to_5"] for r in ranks],
                 "tokens_per_s_by_rank": [r[name]["tokens_per_s"] for r in ranks],
                 "peak_mem_gb_by_rank": [r[name]["peak_mem_gb"] for r in ranks],
                 "params_held_by_rank": [r[name]["params_held"] for r in ranks],
                 "launches_per_step_by_rank": [r[name]["launches_per_step"] for r in ranks]}
            slowest = max(v["median_step_ms_by_rank"])
            v["tokens_per_s"] = PP_B * PP_S / (slowest / 1e3)
            v["loss1_rel_err"] = abs(got["losses"][0] - ctrl_rec["losses"][0]) / abs(
                ctrl_rec["losses"][0])
            v["loss_max_rel_err"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(got["losses"], ctrl_rec["losses"]))
            fields, bad = grad_gates(name, "f32" if kind == "f32" else "bf16", grads,
                                     controls, layout)
            v.update(fields)
            del grads
            rec["variants"][name] = v
            if v["loss1_rel_err"] > SP_LOSS1_RTOL or v["loss_max_rel_err"] > SP_LOSS_RTOL:
                failed.append(f"{name}: losses {got['losses']} vs {ctrl_rec['losses']}")
            failed += bad
    return failed


# ---------------------------------------------------------------------------
# Sharded training state on the mesh (phases ``zero_mesh`` and, with two
# cards or more, ``zero_mesh_multi``): GPT-2 1.3B as phases pp and tp run it,
# trained through ``make_train_step(zero=True)`` (ZeRO-1 over the data line)
# and under ``FSDP_RULES`` (the parameters cut over dp, ``parallel/fsdp.py``).
# One card: variant -> make_train_step's zero= and whether FSDP_RULES.
ZERO_MESH_ONE = {"z0_zero": (True, False), "f0_fsdp": (False, True)}
# The multi-card variants: mesh (its world is that many cards), "zero",
# "fsdp" or "replicated" (the same mesh's DistributedOptimizer run, the
# yardstick of memory and time), model overrides (beside remat), steps, and
# the step-1 gradient gate (``grad_gates``; None: not compared).
ZERO_MESH_VARIANTS = {
    "f1_fsdp_dp2": ({"dp": 2}, "fsdp", {}, STEPS, "pp"),
    "r_dp2": ({"dp": 2}, "replicated", {}, STEPS, None),
    "f1_fsdp_dp4": ({"dp": 4}, "fsdp", {}, STEPS, "pp"),
    "r_dp4": ({"dp": 4}, "replicated", {}, STEPS, None),
    "f2_fsdp_dp2_tp2": ({"dp": 2, "tp": 2}, "fsdp", {}, STEPS, "bf16"),
    "f2f_fsdp_dp2_tp2_f32": ({"dp": 2, "tp": 2}, "fsdp", TP_F32, 1, "f32"),
    "z1_zero_dp2_tp2": ({"dp": 2, "tp": 2}, "zero", {}, STEPS, "bf16"),
    "r_dp2_tp2": ({"dp": 2, "tp": 2}, "replicated", {}, STEPS, None),
    "z2_zero_dp2_pp2": ({"pp": 2, "dp": 2}, "zero", {"num_microbatches": 4}, STEPS, "pp"),
    "r_dp2_pp2": ({"pp": 2, "dp": 2}, "replicated", {"num_microbatches": 4}, STEPS, None),
}


def zero_mesh_worlds_for(cards: int) -> dict:
    """The variants by world size, each world no larger than the cards:
    (f1) FSDP on dp=2 and dp=4; on four cards (f2) FSDP on dp=2 x tp=2 and
    its f32 witness, (z1) ZeRO on dp=2 x tp=2, (z2) ZeRO on dp=2 x pp=2;
    each mesh's replicated run beside them."""
    out = {}
    for name, (shape, _, _, _, _) in ZERO_MESH_VARIANTS.items():
        world = math.prod(shape.values())
        if world <= cards:
            out.setdefault(world, []).append(name)
    return out


def held_closed_form(cfg, mesh, fsdp: bool, pipelined: bool) -> int:
    """The parameters a rank holds, from the configuration: per block the
    LayerNorms and the row-parallel biases (6 d_model, over dp under FSDP),
    the four kernels (4 d² + 2 d·d_ff, over tp, and over dp under FSDP), the
    qkv and wi biases (3 d + d_ff, over tp); per Switch block instead of the
    FFN's kernels and biases the router (E·d) and its E/ep experts' two
    kernels at its tp rank's d_ff/tp each (5 d_model of LayerNorms and
    bias); the token embedding and the head (its tp rank's ⌈V/tp⌉-split
    rows each), the positions and ln_f, over dp under FSDP; a pipeline
    stage's L/pp blocks. sp cuts no parameter: under FSDP on a dp x sp mesh
    the sp members of a dp index hold the same shard. Under FSDP a Switch
    block's LayerNorms and out bias, attention kernels, router and experts
    are over dp too (the qkv bias whole), on a dp x ep mesh beside the ep
    slice."""
    from horovod_tpu_torch.models.transformer import uses_moe

    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    tp, n = mesh.shape.get("tp", 1), (mesh.shape.get("dp", 1) if fsdp else 1)
    per = -(-cfg.vocab_size // tp)
    r = mesh.coords.get("tp", 0)
    rows = min(cfg.vocab_size, (r + 1) * per) - r * per
    blocks = L // mesh.shape.get("pp", 1) if pipelined else L
    block = 6 * d // n + (4 * d * d + 2 * d * f) // (tp * n) + (3 * d + f) // tp
    moe = sum(uses_moe(cfg, i) for i in range(blocks))
    f_local = min(f, (r + 1) * -(-f // tp)) - r * -(-f // tp)
    switch = ((5 * d + 4 * d * d // tp + cfg.n_experts * d
               + 2 * cfg.n_experts // mesh.shape.get("ep", 1) * d * f_local) // n
              + 3 * d // tp)
    return ((blocks - moe) * block + moe * switch
            + (2 * rows * d + cfg.max_len * d + 2 * d) // n)


def check_bytes(name: str, rec: dict, cfg, mesh, kind: str, pipelined: bool) -> dict:
    """The parameter, gradient and optimizer-state bytes a rank holds (all
    f32) against their closed forms: 4 bytes a held parameter, 4 a
    gradient, 8 for AdamW's two moments, over ⌈held / n⌉ elements under
    ZeRO on a data line of n."""
    held = held_closed_form(cfg, mesh, kind == "fsdp", pipelined)
    n = mesh.shape.get("dp", 1) * mesh.shape.get("sp", 1) if kind == "zero" else 1
    want = {"params_held": held, "param_bytes": 4 * held, "grad_bytes": 4 * held,
            "state_bytes": 8 * -(-held // n)}
    got = {k: rec[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: bytes {got}, closed form {want}")
    return want


def phase_zero_mesh(fa, fb, pp_rec, control) -> dict:
    """GPT-2 1.3B at B=8, S=2048, bf16, flash, remat, AdamW on a dp=1 x tp=1
    mesh, 5 steps each of (z0) ``make_train_step(zero=True)`` with the
    plain AdamW and (f0) the model and step under ``FSDP_RULES``: the step-1
    loss and every step-1 gradient, and the 5 losses, bitwise phase
    ``pp``'s; 48 launches of K1 and 24 of each K2 kernel a step; parameter,
    gradient and optimizer-state bytes at their closed forms; step ms,
    tokens/s and peak memory."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.sharding import FSDP_RULES

    ctrl_flat, layout = control
    mesh = hvd.create_mesh({"dp": 1, "sp": 1, "tp": 1})
    rec = {"phase": "zero_mesh", "model": PP_MODEL, "control_losses": pp_rec["losses"],
           "control_median_step_ms_2_to_5": pp_rec["median_step_ms_2_to_5"],
           "control_peak_mem_gb": pp_rec["peak_mem_gb"], "variants": {}}
    for name, (zero, fsdp) in ZERO_MESH_ONE.items():
        out = train_pp(hvd, fa, fb, mesh, False, {"remat": True}, keep_grads=True, zero=zero,
                       rules=FSDP_RULES if fsdp else None)
        r, model = out["rec"], out["model"]
        check_launches(name, r, flash_launches(model.cfg.n_layers, remat=True))
        if r["losses"] != pp_rec["losses"]:
            raise AssertionError(f"{name}: losses {r['losses']} are not phase pp's "
                                 f"{pp_rec['losses']}")
        if [(n, g.numel()) for n, g in sorted(out["grads"].items())] != layout:
            raise AssertionError(f"{name}: the parameters are not phase pp's")
        flat = flat_by_name(out["grads"])
        if not torch.equal(flat, ctrl_flat):
            raise AssertionError(f"{name}: step-1 gradients not bitwise phase pp's "
                                 f"({rel_norm(flat, ctrl_flat)} in relative norm)")
        r["closed_form"] = check_bytes(name, r, model.cfg, mesh,
                                       "zero" if zero else "fsdp", False)
        r.update(step1_bitwise_pp=True, losses_bitwise_pp=True)
        rec["variants"][name] = r
        del out, model, flat
        gc.collect()
        torch.cuda.empty_cache()
    emit(rec)
    return rec


def replicas_bitwise(hvd, model, mesh) -> dict:
    """Every parameter against the first member of its line of copies (the
    mesh axes its cuts do not follow under the model's rules), one
    broadcast a line: True where every parameter on that line is bitwise
    its first member's."""
    from horovod_tpu_torch.parallel.sharding import logical_axes, mesh_axes

    by_line = {}
    for name, p in model.named_parameters():
        cut = {a for logical in logical_axes(name, p)
               for a in mesh_axes(logical, model.rules, mesh)}
        line = tuple(a for a in mesh.axis_names if a not in cut and mesh.shape[a] > 1)
        if line:
            by_line.setdefault(line, []).append(p.detach().reshape(-1))
    out = {}
    for line in sorted(by_line):
        flat = torch.cat(by_line[line])
        out["+".join(line)] = bool(torch.equal(
            flat, hvd.broadcast(flat, root_rank=0, axis_name=line)))
        del flat
    return out


def zero_mesh_rank(rank: int, size: int, init_file: str, queue, variants, tmp) -> None:
    """One spawned NCCL rank of ``zero_mesh_multi``: each variant's record
    (bytes against their closed forms, replicas bitwise on every line of
    copies, launches); the step-1 gradients by name under ``tmp``, from
    every rank under FSDP, from the ranks of dp index 0 otherwise."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb
        from horovod_tpu_torch.parallel.sharding import FSDP_RULES

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            recs = {}
            for name in variants:
                shape, kind, overrides, steps, gate = ZERO_MESH_VARIANTS[name]
                pipelined = "pp" in shape
                mesh = hvd.create_mesh({**shape, "sp": 1})
                rules = FSDP_RULES if kind == "fsdp" else None
                out = train_pp(hvd, fa, fb, mesh, pipelined, {"remat": True, **overrides},
                               keep_grads=gate is not None, steps=steps, zero=kind == "zero",
                               rules=rules)
                rec, model = out["rec"], out["model"]
                blocks = model.cfg.n_layers // mesh.shape.get("pp", 1) * (
                    overrides.get("num_microbatches", 1))
                flash = model.cfg.attn_impl == "flash"
                check_launches(name, rec, flash_launches(blocks if flash else 0, remat=True))
                rec["closed_form"] = check_bytes(name, rec, model.cfg, mesh, kind, pipelined)
                rec["replicas_bitwise"] = replicas_bitwise(hvd, model, mesh)
                if not all(rec["replicas_bitwise"].values()):
                    raise AssertionError(f"{name}: replicas differ: {rec['replicas_bitwise']}")
                rec["coords"] = dict(mesh.coords)
                if gate is not None and (kind == "fsdp" or mesh.coords["dp"] == 0):
                    save_grads(tmp, name, mesh.coords, out["grads"])
                recs[name] = rec
                del out, model
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def save_grads(tmp: str, name: str, coords: dict, grads: dict) -> None:
    """This rank's step-1 gradients by name, in f32, under ``tmp``, keyed
    by the variant and the rank's dp, tp, pp and ep coordinates."""
    torch.save({n: g.float() for n, g in grads.items()},
               f"{tmp}/{name}.{coords.get('dp', 0)}.{coords.get('tp', 0)}."
               f"{coords.get('pp', 0)}.{coords.get('ep', 0)}.pt")


def joined_grads(tmp: str, name: str, shape: dict, fsdp: bool, layout) -> torch.Tensor:
    """A variant's step-1 gradients (``save_grads``) as the full model's,
    flat in name order: each tp rank's dp shards joined (``fsdp_join``;
    without ``fsdp`` dp index 0's alone), the tp ranks' joined
    (``tp_join``), the ep ranks' experts put together (``ep_join``), the
    pipeline stages' taken together."""
    from horovod_tpu_torch.models.convert import ep_join, fsdp_join, tp_join
    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS

    full = {}
    for s in range(shape.get("pp", 1)):
        per_ep = []
        for e in range(shape.get("ep", 1)):
            tps = [fsdp_join([torch.load(f"{tmp}/{name}.{d}.{t}.{s}.{e}.pt")
                              for d in range(shape["dp"] if fsdp else 1)])
                   for t in range(shape.get("tp", 1))]
            per_ep.append(tps[0] if len(tps) == 1 else tp_join(tps, GPT2_CONFIGS[PP_MODEL]))
            del tps
        full.update(ep_join(per_ep))
        del per_ep
    got = [(n, full[n].numel() if n in full else None) for n, _ in layout]
    if got != layout or len(full) != len(layout):
        bad = [(g, w) for g, w in zip(got, layout) if g != w][:4]
        raise AssertionError(f"{name}: the joined gradients are not the full model's: "
                             f"{len(full)} tensors for {len(layout)}; {bad}")
    return torch.cat([full.pop(n).reshape(-1) for n, _ in layout])


def phase_zero_mesh_multi(pp_rec, control, f32) -> dict:
    """With two cards or more: the variants of ``zero_mesh_worlds_for`` on
    one spawned NCCL rank per card, against phase ``pp``'s run (the f32
    witness against ``f32``). Gates: the losses as ``pp_multi``'s (step 1
    within 2e-3, the steps within 1e-2; a witness against the f32 control);
    step-1 gradients, joined to the full model, by ``grad_gates`` ("pp":
    1e-2 in relative norm for dp and pp; tp > 1: e_v at most twice e_1, the
    witness within 1e-4 over the model and in every tensor); launches per
    rank; replicas bitwise on every line of copies; per-rank parameter,
    gradient and optimizer-state bytes at their closed forms. Per rank the
    step ms, tokens/s and peak memory, beside the replicated run of the
    same mesh."""
    import functools
    import tempfile

    cards = torch.cuda.device_count()
    controls = multi_controls(pp_rec, control, f32)
    layout = control[1]
    rec = {"phase": "zero_mesh_multi", "cards": cards, "variants": {}, "controls": {
        "pp": {k: pp_rec[k] for k in ("median_step_ms_2_to_5", "peak_mem_gb", "losses")},
        "f32": {k: f32[0][k] for k in ("step_ms", "peak_mem_gb", "losses")},
        "e_1": controls["e_1"]}}
    failed = []
    for world, variants in sorted(zero_mesh_worlds_for(cards).items()):
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn_cards(functools.partial(zero_mesh_rank, variants=variants, tmp=tmp),
                                world, timeout=900)
            for name in variants:
                shape, kind, _, _, gate = ZERO_MESH_VARIANTS[name]
                got = ranks[0][name]
                v = {"rank0": got, "kind": kind,
                     "by_rank": {k: [r[name][k] for r in ranks] for k in (
                         "median_step_ms_2_to_5", "tokens_per_s", "peak_mem_gb",
                         "params_held", "param_bytes", "grad_bytes", "state_bytes",
                         "launches_per_step")}}
                v["tokens_per_s"] = PP_B * PP_S / (max(v["by_rank"]["median_step_ms_2_to_5"])
                                                   / 1e3)
                ctrl_rec = controls["f32" if gate == "f32" else "pp"][0]
                v["loss1_rel_err"] = abs(got["losses"][0] - ctrl_rec["losses"][0]) / abs(
                    ctrl_rec["losses"][0])
                v["loss_max_rel_err"] = max(abs(a - b) / abs(b)
                                            for a, b in zip(got["losses"], ctrl_rec["losses"]))
                if v["loss1_rel_err"] > SP_LOSS1_RTOL or v["loss_max_rel_err"] > SP_LOSS_RTOL:
                    failed.append(f"{name}: losses {got['losses']} vs {ctrl_rec['losses']}")
                if gate is not None:
                    grads = joined_grads(tmp, name, shape, kind == "fsdp", layout)
                    fields, bad = grad_gates(name, gate, grads, controls, layout)
                    v.update(fields)
                    failed += bad
                    del grads
                rec["variants"][name] = v
    for name, v in rec["variants"].items():     # beside the same mesh's replicated run
        shape = ZERO_MESH_VARIANTS[name][0]
        mate = next((m for m, (sh, kind, *_) in ZERO_MESH_VARIANTS.items()
                     if sh == shape and kind == "replicated" and m != name), None)
        if mate in rec["variants"]:
            r = rec["variants"][mate]
            v["beside_replicated"] = {
                "variant": mate,
                "step_ms_ratio": (max(v["by_rank"]["median_step_ms_2_to_5"])
                                  / max(r["by_rank"]["median_step_ms_2_to_5"])),
                "peak_mem_gb_ratio": max(v["by_rank"]["peak_mem_gb"])
                / max(r["by_rank"]["peak_mem_gb"]),
                "state_bytes_ratio": v["by_rank"]["state_bytes"][0]
                / r["by_rank"]["state_bytes"][0]}
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    return rec


# ---------------------------------------------------------------------------
# tp under pp (phases ``pp_tp`` and, with four cards, ``pp_tp_multi``): GPT-2
# 1.3B as phase pp runs it, ``examples/jax_gpt2_train.py --model gpt2-1p3b
# --pp 2 --tp 2 --remat`` (its ``--dp 8 --tp 4`` line, :9-11, with --pp) cut
# to one node: ``PipelinedLM``'s stages on the tp layers, the vocab-parallel
# embedding, head and loss on each pp rank's tp line.
PT_KERNEL_SHAPE = (1, PP_S, 8, 128)    # a microbatch of B=8 over 8, 16 heads over tp=2
PT_CARDS = 4
# The four-card variants on pp=2 x tp=2: model overrides (beside remat),
# steps, the world-1 control (``multi_controls``: "pp" phase pp's run, "f32"
# the f32 control).
PT_MESH = {"pp": 2, "dp": 1, "tp": 2}
PT_VARIANTS = {
    "pt1_pp2_tp2": ({"num_microbatches": PP_M}, STEPS, "pp"),
    "pt1f_pp2_tp2_f32": ({"num_microbatches": PP_M, **TP_F32}, 1, "f32"),
}
# Context, not gates: the four-card steps PERF.md records for pp=2 (8
# microbatches, no remat) and tp=2 (NVIDIA H100 80GB HBM3, 700.00 W).
PT_CONTEXT_MS = {"pp2": 477.0, "tp2": 459.3}


def phase_pp_tp(fa, fb, gen, dev, pp_rec, control) -> dict:
    """GPT-2 1.3B as phase pp runs it (B=8, S=2048, bf16, flash, remat,
    AdamW): ``PipelinedLM`` on a pp=1 x dp=1 x tp=1 mesh, built through the
    tp-aware stage (the tp layers on a line of one member, the
    column-parallel head), takes 5 steps whose step-1 loss and gradients
    must be bitwise phase pp's, with 48 launches of K1 and 24 of each K2
    kernel a step. Then K1 and the K2 pair at the pp x tp path's microbatch
    shape (1, 2048, 8, 128) against their plain versions, timed beside SDPA
    and the aten flash backward."""
    import horovod_tpu_torch as hvd

    ctrl_flat, layout = control
    mesh = hvd.create_mesh({"pp": 1, "dp": 1, "sp": 1, "tp": 1})
    out = train_pp(hvd, fa, fb, mesh, True, {"remat": True}, keep_grads=True)
    rec, model = out["rec"], out["model"]
    check_launches("pp_tp", rec, flash_launches(model.cfg.n_layers, remat=True))
    if rec["losses"][0] != pp_rec["losses"][0]:
        raise AssertionError(f"pp_tp: step-1 loss {rec['losses'][0]} is not phase pp's "
                             f"{pp_rec['losses'][0]}")
    if [(n, g.numel()) for n, g in sorted(out["grads"].items())] != layout:
        raise AssertionError("pp_tp: the parameters are not phase pp's")
    flat = flat_by_name(out["grads"])
    if not torch.equal(flat, ctrl_flat):
        raise AssertionError(f"pp_tp: step-1 gradients not bitwise phase pp's "
                             f"({rel_norm(flat, ctrl_flat)} in relative norm)")
    rec.update(phase="pp_tp", model=PP_MODEL, mesh=dict(mesh.shape),
               head=type(model.lm_head).__name__, step1_bitwise_pp=True,
               losses_equal_pp=rec["losses"] == pp_rec["losses"])
    del out, model, flat
    gc.collect()
    torch.cuda.empty_cache()
    Bn, Sn, Hn, Dn = PT_KERNEL_SHAPE
    rec["kernels_d128"] = {f"{Bn}x{Sn}x{Hn}": flash_at(fa, gen, dev, Bn, Sn, Hn, Dn)}
    emit(rec)
    return rec


def pp_tp_rank(rank: int, size: int, init_file: str, queue, variants, tmp) -> None:
    """One spawned NCCL rank of ``pp_tp_multi``: each variant's record (the
    parameters held at their closed form, the exact launches, every line of
    copies bitwise after its steps); every rank writes its step-1
    gradients by name under ``tmp``."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            recs = {}
            for name in variants:
                overrides, steps, _ = PT_VARIANTS[name]
                mesh = hvd.create_mesh({**PT_MESH, "sp": 1})
                out = train_pp(hvd, fa, fb, mesh, True, {"remat": True, **overrides},
                               keep_grads=True, steps=steps)
                rec, model = out["rec"], out["model"]
                blocks = model.cfg.n_layers // mesh.shape["pp"] * overrides["num_microbatches"]
                flash = model.cfg.attn_impl == "flash"
                check_launches(name, rec, flash_launches(blocks if flash else 0, remat=True))
                rec["closed_form"] = check_bytes(name, rec, model.cfg, mesh, "replicated", True)
                rec["replicas_bitwise"] = replicas_bitwise(hvd, model, mesh)
                if not all(rec["replicas_bitwise"].values()):
                    raise AssertionError(f"{name}: replicas differ: {rec['replicas_bitwise']}")
                rec["coords"] = dict(mesh.coords)
                rec["layers"] = [model.layer_range.start, model.layer_range.stop]
                save_grads(tmp, name, mesh.coords, out["grads"])
                recs[name] = rec
                del out, model
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_pp_tp_multi(pp_rec, control, f32) -> dict:
    """On four cards: the PT_VARIANTS on one spawned NCCL rank per card
    (pp=2 x tp=2, 8 microbatches), against phase pp's run (the f32 witness
    against ``f32``). Gates: step-1 loss within 2e-3 relative and the
    steps' within 1e-2; step-1 gradients, the stages' tp shards joined to
    the full model, by ``grad_gates`` (the witness within 1e-4 of the f32
    control over the whole model and in every tensor, the bf16 e_v at most
    twice e_1); per rank 2·(24/2)·8 = 192 launches of K1 and 96 of each K2
    kernel a step (none in f32), the parameters held at their closed form,
    every line of copies bitwise (the tp-replicated tensors on their tp
    line, the pp-replicated ones on their pp line). Per rank the step ms,
    tokens/s and peak memory, beside the recorded pp=2 and tp=2 steps as
    context (no gain is claimed). Returns the bf16 variant's launches
    on rank 0 (or "not measured")."""
    import functools
    import tempfile

    cards = torch.cuda.device_count()
    if cards < PT_CARDS:
        rec = {"phase": "pp_tp_multi", "cards": cards,
               "result": f"not measured: needs {PT_CARDS} cards"}
        emit(rec)
        return {"launches": rec["result"]}
    controls = multi_controls(pp_rec, control, f32)
    layout = control[1]
    rec = {"phase": "pp_tp_multi", "cards": PT_CARDS, "mesh": PT_MESH, "variants": {},
           "context_step_ms": PT_CONTEXT_MS, "controls": {
               "pp": {k: pp_rec[k] for k in ("median_step_ms_2_to_5", "peak_mem_gb", "losses")},
               "f32": {k: f32[0][k] for k in ("step_ms", "peak_mem_gb", "losses")},
               "e_1": controls["e_1"]}}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(pp_tp_rank, variants=list(PT_VARIANTS),
                                              tmp=tmp), PT_CARDS, timeout=900)
        for name, (overrides, _, kind) in PT_VARIANTS.items():
            got = ranks[0][name]
            ctrl_rec = controls[kind][0]
            S, M = PT_MESH["pp"], overrides["num_microbatches"]
            v = {"rank0": got, "bubble": (S - 1) / (M + S - 1),
                 "by_rank": {k: [r[name][k] for r in ranks] for k in (
                     "median_step_ms_2_to_5", "tokens_per_s", "peak_mem_gb", "params_held",
                     "launches_per_step")}}
            v["tokens_per_s"] = PP_B * PP_S / (max(v["by_rank"]["median_step_ms_2_to_5"])
                                               / 1e3)
            v["loss1_rel_err"] = abs(got["losses"][0] - ctrl_rec["losses"][0]) / abs(
                ctrl_rec["losses"][0])
            v["loss_max_rel_err"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(got["losses"], ctrl_rec["losses"]))
            if v["loss1_rel_err"] > SP_LOSS1_RTOL or v["loss_max_rel_err"] > SP_LOSS_RTOL:
                failed.append(f"{name}: losses {got['losses']} vs {ctrl_rec['losses']}")
            grads = joined_grads(tmp, name, PT_MESH, False, layout)
            fields, bad = grad_gates(name, "f32" if kind == "f32" else "bf16", grads,
                                     controls, layout)
            v.update(fields)
            failed += bad
            del grads
            rec["variants"][name] = v
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    return {"launches": ranks[0]["pt1_pp2_tp2"]["launches"]}


# ---------------------------------------------------------------------------
# tp composed with sp (phases ``tp_sp`` and, with four cards, ``tp_sp_multi``):
# GPT-2 1.3B at S=8192 over tp=2 x sp=2, ``examples/jax_gpt2_train.py:9-11``
# (``--dp 8 --tp 4 --sp 2 --attn ring --remat`` at gpt2-1p3b) cut to one
# node. B=2 x S=8192 is the 16,384 tokens a step of phases pp and tp.
TS_B, TS_S = 2, 8192
TS_HEADS = (16, 8, 4)      # K1/K2 at world 1, the gathered flash and Ulysses-flash
TS_BLOCKS = 2              # the sp line of the four-card variants
# The f32 control and witness: the ring's arithmetic in f32 (the kernels
# take no f32, and dense attention's f32 scores at S=8192 crowd one card).
TS_F32 = {"dtype": torch.float32, "logits_dtype": torch.float32, "attn_impl": "ring"}
# The four-card variants on dp=1 x sp=2 x tp=2: model overrides (beside
# remat), steps, the world-1 control of ``phase_tp_sp``: "ring1" the ring's
# arithmetic on one card over TS_BLOCKS blocks, "flash" the flash run, "f32"
# the f32 ring arithmetic, one step.
TS_VARIANTS = {
    "ts1_ring": ({"attn_impl": "ring"}, STEPS, "ring1"),
    "ts2_ulysses_flash": ({"attn_impl": "ulysses", "sp_use_flash": True}, STEPS, "flash"),
    "ts3_flash": ({"attn_impl": "flash"}, STEPS, "flash"),
    "ts1f_ring_f32": (TS_F32, 1, "f32"),
}


def phase_tp_sp(fa, fb, gen, dev) -> tuple:
    """GPT-2 1.3B (``max_len`` 8192) at B=2, S=8192, bf16, remat, AdamW on a
    dp=1 x sp=1 x tp=1 mesh through the tp x sp code, with flash and with
    the ring (dense attention on a line of one member): each 5 steps whose
    losses and step-1 gradients must be bitwise those of the model built
    with no mesh; 48 launches of K1 and 24 of each K2 kernel a step with
    flash, none with the ring. Then the world-1 controls of
    ``tp_sp_multi``: the ring's arithmetic on one card over 2 blocks in bf16
    (5 steps) and in f32 (one step), and K1 and the K2 pair at (2, 8192, H,
    128) for H in 16, 8 and 4 (world 1, the gathered flash at tp=2, Ulysses
    at tp=2 x sp=2) against their plain versions. Returns the record and
    the controls: (record, step-1 gradients flat in name order) by name,
    and the layout."""
    import horovod_tpu_torch as hvd

    mesh = hvd.create_mesh({"dp": 1, "sp": 1, "tp": 1})
    rec = {"phase": "tp_sp", "model": PP_MODEL, "batch": TS_B, "seq": TS_S, "configs": {}}
    controls = {}
    for attn in ("flash", "ring"):
        runs = {}
        for bare in (True, False):
            out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, "attn_impl": attn},
                           keep_grads=True, batch=(TS_B, TS_S), bare=bare)
            runs[bare] = (out["rec"], flat_by_name(out["grads"]), out["model"].cfg.n_layers)
            del out
            gc.collect()
            torch.cuda.empty_cache()
        (r, flat, n_layers), (bare_rec, bare_flat, _) = runs[False], runs[True]
        check_launches(f"tp_sp {attn}", r,
                       flash_launches(n_layers if attn == "flash" else 0, remat=True))
        if r["losses"] != bare_rec["losses"] or not torch.equal(flat, bare_flat):
            raise AssertionError(f"tp_sp {attn}: not bitwise the model with no mesh (losses "
                                 f"{r['losses']} vs {bare_rec['losses']}, step-1 gradients "
                                 f"{rel_norm(flat, bare_flat)} in relative norm)")
        r.update(bitwise_no_mesh=True,
                 no_mesh_median_step_ms_2_to_5=bare_rec["median_step_ms_2_to_5"])
        rec["configs"][attn] = r
        if attn == "flash":
            controls["flash"] = (r, flat)
        del runs, flat, bare_flat
    controls = tp_sp_controls(hvd, fa, fb, controls)
    for name in ("ring1", "f32"):
        rec[f"control_{name}"] = controls[name][0]
    rec["e_1"] = {name: rel_norm(controls[name][1], controls["f32"][1])
                  for name in ("flash", "ring1")}
    rec["ring1_vs_flash_step1_grad_rel_norm"] = rel_norm(controls["ring1"][1],
                                                         controls["flash"][1])
    rec["kernels_d128"] = {f"{TS_B}x{TS_S}x{Hn}": flash_at(fa, gen, dev, TS_B, TS_S, Hn, 128)
                           for Hn in TS_HEADS}
    rec["launches"] = rec["configs"]["flash"]["launches"]
    emit(rec)
    return rec, controls


def tp_sp_controls(hvd, fa, fb, controls=None) -> dict:
    """The world-1 controls of ``tp_sp_multi`` at B=2, S=8192 on one card,
    beside those given: "flash" (5 steps), "ring1" (the ring's arithmetic
    over TS_BLOCKS blocks, ``world1_ring``, 5 steps) and "f32" (the same in
    f32, one step), each (record, step-1 gradients flat in name order);
    "layout" the parameters' (name, size) in that order."""
    mesh = hvd.create_mesh({"dp": 1, "sp": 1, "tp": 1})
    controls = dict(controls or {})
    for name, overrides, steps in (("flash", {"attn_impl": "flash"}, STEPS),
                                   ("ring1", {"attn_impl": "ring"}, STEPS),
                                   ("f32", TS_F32, 1)):
        if name in controls:
            continue
        attention = world1_ring(TS_BLOCKS) if name != "flash" else contextlib.nullcontext()
        with attention:
            out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, **overrides},
                           keep_grads=True, steps=steps, batch=(TS_B, TS_S))
        controls[name] = (out["rec"], flat_by_name(out["grads"]))
        controls["layout"] = [(n, g.numel()) for n, g in sorted(out["grads"].items())]
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return controls


def tp_sp_rank(rank: int, size: int, init_file: str, queue, variants, tmp) -> None:
    """One spawned NCCL rank of ``tp_sp_multi`` on dp=1 x sp=2 x tp=2: each
    variant's record (the parameters held against their closed form,
    replicas bitwise on every line of copies, launches); the ranks of sp
    index 0 write their step-1 gradients by name under ``tmp``."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            recs = {}
            for name in variants:
                overrides, steps, _ = TS_VARIANTS[name]
                mesh = hvd.create_mesh({"dp": 1, "sp": TS_BLOCKS, "tp": 2})
                out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, **overrides},
                               keep_grads=True, steps=steps, batch=(TS_B, TS_S))
                rec, model = out["rec"], out["model"]
                cfg = model.cfg
                flash = cfg.attn_impl == "flash" or (cfg.attn_impl == "ulysses"
                                                     and cfg.sp_use_flash)
                check_launches(name, rec, flash_launches(cfg.n_layers if flash else 0,
                                                         remat=True))
                rec["params_closed_form"] = held_closed_form(cfg, mesh, False, False)
                if rec["params_held"] != rec["params_closed_form"]:
                    raise AssertionError(f"{name}: {rec['params_held']} parameters held, "
                                         f"closed form {rec['params_closed_form']}")
                rec["replicas_bitwise"] = replicas_bitwise(hvd, model, mesh)
                if not all(rec["replicas_bitwise"].values()):
                    raise AssertionError(f"{name}: replicas differ: {rec['replicas_bitwise']}")
                rec["coords"] = dict(mesh.coords)
                if mesh.coords["sp"] == 0:
                    save_grads(tmp, name, mesh.coords, out["grads"])
                recs[name] = rec
                del out, model
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_tp_sp_multi(controls) -> dict:
    """On four cards: the TS_VARIANTS on one spawned NCCL rank per card
    (dp=1 x sp=2 x tp=2), each against its world-1 control from
    ``phase_tp_sp``. Gates: step-1 loss within 2e-3 relative and the steps'
    within 1e-2; step-1 gradients, the tp shards joined to the full model,
    by ``grad_gates``: the f32 witness within 1e-4 of the f32 control over
    the whole model and in every tensor, a bf16 variant's distance e_v from
    the f32 control at most twice e_1, its world-1 control's distance from
    it; the exact launches, the parameters held at their closed form and
    the replicas bitwise on every line, per rank. Per rank the step ms,
    tokens/s and peak memory."""
    import functools
    import tempfile

    cards = torch.cuda.device_count()
    world = TS_BLOCKS * 2
    if cards < world:
        rec = {"phase": "tp_sp_multi", "cards": cards,
               "result": f"not measured: needs {world} cards"}
        emit(rec)
        return rec
    layout = controls["layout"]
    rec = {"phase": "tp_sp_multi", "cards": world, "mesh": {"dp": 1, "sp": TS_BLOCKS, "tp": 2},
           "variants": {}, "controls": {
               name: {k: controls[name][0][k] for k in ("median_step_ms_2_to_5",
                                                         "peak_mem_gb", "losses")}
               for name in ("flash", "ring1", "f32")}}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(tp_sp_rank, variants=list(TS_VARIANTS),
                                              tmp=tmp), world, timeout=1200)
        for name, (_, _, kind) in TS_VARIANTS.items():
            ctrl_rec, ctrl_flat = controls[kind]
            got = ranks[0][name]
            grads = joined_grads(tmp, name, got["mesh"], False, layout)
            v = {"rank0": got, "control": kind,
                 "by_rank": {k: [r[name][k] for r in ranks] for k in (
                     "median_step_ms_2_to_5", "tokens_per_s", "peak_mem_gb", "params_held",
                     "launches_per_step")}}
            v["tokens_per_s"] = TS_B * TS_S / (max(v["by_rank"]["median_step_ms_2_to_5"]) / 1e3)
            v["loss1_rel_err"] = abs(got["losses"][0] - ctrl_rec["losses"][0]) / abs(
                ctrl_rec["losses"][0])
            v["loss_max_rel_err"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(got["losses"], ctrl_rec["losses"]))
            if v["loss1_rel_err"] > SP_LOSS1_RTOL or v["loss_max_rel_err"] > SP_LOSS_RTOL:
                failed.append(f"{name}: losses {got['losses']} vs {ctrl_rec['losses']}")
            gate = {"pp": (ctrl_rec, ctrl_flat), "f32": controls["f32"],
                    "e_1": rel_norm(ctrl_flat, controls["f32"][1])}
            fields, bad = grad_gates(name, "f32" if kind == "f32" else "bf16", grads, gate,
                                     layout)
            v.update(fields)
            failed += bad
            del grads
            rec["variants"][name] = v
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    return rec


# ---------------------------------------------------------------------------
# pp under sp (phases ``pp_sp`` and, with four cards, ``pp_sp_multi``): GPT-2
# 1.3B at S=8192 over pp=2 x sp=2, ``examples/jax_gpt2_train.py``'s pp x sp
# mesh (its ``--dp 8 --tp 4 --sp 2 --attn ring --remat`` line, :9-11, with
# --pp 2 for --tp) cut to one node: ``PipelinedLM``'s stages attending over
# the rank's sp line, M=2 microbatches of one sequence, the 16,384 tokens a
# step of phases tp_sp and tp_sp_multi.
PS_MESH = {"pp": 2, "dp": 1, "sp": 2}
PS_M = 2
# K1/K2 at one sequence after Ulysses' head exchange: 16 heads over sp=2.
PS_KERNEL_SHAPE = (1, TS_S, 8, 128)
# The four-card variants: model overrides (beside remat and PS_M), steps,
# the world-1 control of ``tp_sp_controls`` (as TS_VARIANTS name them).
PS_VARIANTS = {
    "ps1_ulysses_flash": ({"attn_impl": "ulysses", "sp_use_flash": True}, STEPS, "flash"),
    "ps2_ring": ({"attn_impl": "ring"}, STEPS, "ring1"),
    "ps1f_ring_f32": (TS_F32, 1, "f32"),
}
# Context, not a gate: (ts2) Ulysses-flash over tp=2 x sp=2 (PERF.md §5,
# NVIDIA H100 80GB HBM3, 700.00 W).
PS_CONTEXT_MS = {"ts2_ulysses_flash_tp2_sp2": [374.30, 381.8]}


def phase_pp_sp(fa, fb, gen, dev) -> tuple:
    """GPT-2 1.3B at B=2, S=8192, bf16, remat, AdamW through ``PipelinedLM``
    on a pp=1 x dp=1 x sp=1 mesh, the stage built on the sp line (the
    positions of its block, the sequence-sharded loss' code): 5 steps whose
    losses and step-1 gradients must be bitwise those of the model built
    with no mesh, 48 launches of K1 and 24 of each K2 kernel a step. The
    attention is flash: on a line of one member Ulysses falls back to dense
    attention (as in JAX), and Ulysses-flash's attention per head group is
    flash. Then K1 and the K2 pair at one sequence after Ulysses' head
    exchange at sp=2, (1, 8192, 8, 128), against their plain versions,
    timed beside SDPA and the aten flash backward. Returns the record and
    the no-mesh run (its record, its step-1 gradients flat in name order),
    the control of phase ``fsdp_sp``."""
    import horovod_tpu_torch as hvd

    mesh = hvd.create_mesh({"pp": 1, "dp": 1, "sp": 1})
    runs = {}
    for pipelined in (True, False):
        out = train_pp(hvd, fa, fb, mesh, pipelined, {"remat": True}, keep_grads=True,
                       batch=(TS_B, TS_S), bare=not pipelined)
        runs[pipelined] = (out["rec"], flat_by_name(out["grads"]), type(out["model"]).__name__,
                           out["model"].cfg.n_layers)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    (rec, flat, kind, n_layers), (bare_rec, bare_flat, bare_kind, _) = runs[True], runs[False]
    check_launches("pp_sp", rec, flash_launches(n_layers, remat=True))
    if rec["losses"] != bare_rec["losses"] or not torch.equal(flat, bare_flat):
        raise AssertionError(f"pp_sp: not bitwise the model with no mesh (losses "
                             f"{rec['losses']} vs {bare_rec['losses']}, step-1 gradients "
                             f"{rel_norm(flat, bare_flat)} in relative norm)")
    rec.update(phase="pp_sp", model=PP_MODEL, models=[kind, bare_kind], bitwise_no_mesh=True,
               no_mesh_median_step_ms_2_to_5=bare_rec["median_step_ms_2_to_5"])
    del runs, flat
    Bn, Sn, Hn, Dn = PS_KERNEL_SHAPE
    rec["kernels_d128"] = {f"{Bn}x{Sn}x{Hn}": flash_at(fa, gen, dev, Bn, Sn, Hn, Dn)}
    emit(rec)
    return rec, (bare_rec, bare_flat)


def pp_sp_rank(rank: int, size: int, init_file: str, queue, variants, tmp) -> None:
    """One spawned NCCL rank of ``pp_sp_multi`` on pp=2 x sp=2: each
    variant's record (the parameters held at their closed form, the exact
    launches, every line of copies bitwise after its steps); the ranks of
    sp index 0 write their step-1 gradients by name under ``tmp``."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            recs = {}
            for name in variants:
                overrides, steps, _ = PS_VARIANTS[name]
                mesh = hvd.create_mesh(PS_MESH)
                out = train_pp(hvd, fa, fb, mesh, True,
                               {"remat": True, "num_microbatches": PS_M, **overrides},
                               keep_grads=True, steps=steps, batch=(TS_B, TS_S))
                rec, model = out["rec"], out["model"]
                cfg = model.cfg
                blocks = cfg.n_layers // mesh.shape["pp"] * PS_M
                check_launches(name, rec, flash_launches(blocks if cfg.sp_use_flash else 0,
                                                         remat=True))
                rec["params_closed_form"] = held_closed_form(cfg, mesh, False, True)
                if rec["params_held"] != rec["params_closed_form"]:
                    raise AssertionError(f"{name}: {rec['params_held']} parameters held, "
                                         f"closed form {rec['params_closed_form']}")
                rec["replicas_bitwise"] = replicas_bitwise(hvd, model, mesh)
                if not all(rec["replicas_bitwise"].values()):
                    raise AssertionError(f"{name}: replicas differ: {rec['replicas_bitwise']}")
                rec["coords"] = dict(mesh.coords)
                rec["layers"] = [model.layer_range.start, model.layer_range.stop]
                if mesh.coords["sp"] == 0:
                    save_grads(tmp, name, mesh.coords, out["grads"])
                recs[name] = rec
                del out, model
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_pp_sp_multi(controls) -> dict:
    """On four cards: the PS_VARIANTS on one spawned NCCL rank per card
    (pp=2 x sp=2, M=2 microbatches of one sequence), each against its
    world-1 control from ``phase_tp_sp`` (the same model, weights and
    16,384 tokens). Gates, those of ``tp_sp_multi``: step-1 loss within
    2e-3 relative and the steps' within 1e-2; step-1 gradients, the stages
    joined to the full model, by ``grad_gates`` (the f32 witness within
    1e-4 of the f32 control over the whole model and in every tensor, a
    bf16 variant's e_v at most twice e_1, its control's distance from the
    f32 control); per rank 2·(24/2)·2 = 48 launches of K1 and 24 of each K2
    kernel a step with Ulysses-flash, none with the ring; the parameters
    held at their closed form; every line of copies bitwise. Per rank the
    step ms, tokens/s and peak memory, beside (ts2) as context (no gain is
    claimed). Returns the record, with (ps1)'s launches on rank 0 (or "not
    measured")."""
    import functools
    import tempfile

    cards = torch.cuda.device_count()
    world = PS_MESH["pp"] * PS_MESH["sp"]
    if cards < world:
        rec = {"phase": "pp_sp_multi", "cards": cards,
               "result": f"not measured: needs {world} cards"}
        emit(rec)
        return {"launches": rec["result"]}
    layout = controls["layout"]
    S, M = PS_MESH["pp"], PS_M
    rec = {"phase": "pp_sp_multi", "cards": world, "mesh": PS_MESH, "microbatches": M,
           "bubble": (S - 1) / (M + S - 1), "variants": {},
           "context_step_ms": PS_CONTEXT_MS, "controls": {
               name: {k: controls[name][0][k] for k in ("median_step_ms_2_to_5",
                                                         "peak_mem_gb", "losses")}
               for name in ("flash", "ring1", "f32")}}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(pp_sp_rank, variants=list(PS_VARIANTS),
                                              tmp=tmp), world, timeout=1200)
        for name, (_, _, kind) in PS_VARIANTS.items():
            ctrl_rec, ctrl_flat = controls[kind]
            got = ranks[0][name]
            grads = joined_grads(tmp, name, got["mesh"], False, layout)
            v = {"rank0": got, "control": kind,
                 "by_rank": {k: [r[name][k] for r in ranks] for k in (
                     "median_step_ms_2_to_5", "tokens_per_s", "peak_mem_gb", "params_held",
                     "launches_per_step", "layers")}}
            v["tokens_per_s"] = TS_B * TS_S / (max(v["by_rank"]["median_step_ms_2_to_5"]) / 1e3)
            v["loss1_rel_err"] = abs(got["losses"][0] - ctrl_rec["losses"][0]) / abs(
                ctrl_rec["losses"][0])
            v["loss_max_rel_err"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(got["losses"], ctrl_rec["losses"]))
            if v["loss1_rel_err"] > SP_LOSS1_RTOL or v["loss_max_rel_err"] > SP_LOSS_RTOL:
                failed.append(f"{name}: losses {got['losses']} vs {ctrl_rec['losses']}")
            gate = {"pp": (ctrl_rec, ctrl_flat), "f32": controls["f32"],
                    "e_1": rel_norm(ctrl_flat, controls["f32"][1])}
            fields, bad = grad_gates(name, "f32" if kind == "f32" else "bf16", grads, gate,
                                     layout)
            v.update(fields)
            failed += bad
            del grads
            rec["variants"][name] = v
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    rec["launches"] = ranks[0]["ps1_ulysses_flash"]["launches"]
    return rec


# ---------------------------------------------------------------------------
# FSDP under sp (phases ``fsdp_sp`` and, with four cards, ``fsdp_sp_multi``):
# GPT-2 1.3B at S=8192 under ``FSDP_RULES`` over dp=2 x sp=2, the long-context
# recipe of ``examples/jax_gpt2_train.py``'s sp mesh (``--sp 2 --attn ring
# --remat`` at gpt2-1p3b, :9-11) with the parameters, gradients and AdamW
# moments cut over dp (the JAX "embed" row, ``horovod_tpu/parallel/
# sharding.py:46-58``) and replicated over sp; the 16,384 tokens a step of
# phases tp_sp and pp_sp.
FS_MESH = {"dp": 2, "sp": 2}
# The four-card variants on dp=2 x sp=2: model overrides (beside remat),
# steps, the world-1 control of ``tp_sp_controls``, "fsdp" (FSDP_RULES) or
# "replicated" (DEFAULT_RULES on the same mesh, the yardstick of memory and
# time), and whether its step-1 gradients are gated. The FSDP and the
# replicated Ulysses-flash runs take turns (fsdp, replicated, replicated,
# fsdp); the second turn is timed and gated on its losses and bytes only.
FS_VARIANTS = {
    "fs1_ulysses_flash": ({"attn_impl": "ulysses", "sp_use_flash": True}, STEPS, "flash",
                          "fsdp", True),
    "r1_ulysses_flash": ({"attn_impl": "ulysses", "sp_use_flash": True}, STEPS, "flash",
                         "replicated", True),
    "r1b_ulysses_flash": ({"attn_impl": "ulysses", "sp_use_flash": True}, STEPS, "flash",
                          "replicated", False),
    "fs1b_ulysses_flash": ({"attn_impl": "ulysses", "sp_use_flash": True}, STEPS, "flash",
                           "fsdp", False),
    "fs2_ring": ({"attn_impl": "ring"}, 2, "ring1", "fsdp", True),
    "fs1f_ring_f32": (TS_F32, 1, "f32", "fsdp", True),
}


def phase_fsdp_sp(fa, fb, control) -> dict:
    """GPT-2 1.3B at B=2, S=8192, bf16, remat, AdamW under ``FSDP_RULES`` on
    a dp=1 x sp=1 mesh, the sp attention's code with its sp line of one
    member: 5 steps whose losses and step-1 gradients must be bitwise
    ``control``'s, phase ``pp_sp``'s run of the model built with no mesh;
    48 launches of K1 and 24 of each K2 kernel a step; the parameter,
    gradient and optimizer-state bytes at their closed form. The attention
    is flash, as in phase ``pp_sp``: on a line of one member Ulysses falls
    back to dense attention (as in JAX), and Ulysses-flash's attention per
    head group is flash."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.sharding import FSDP_RULES

    ctrl_rec, ctrl_flat = control
    mesh = hvd.create_mesh({"dp": 1, "sp": 1})
    out = train_pp(hvd, fa, fb, mesh, False, {"remat": True}, keep_grads=True,
                   rules=FSDP_RULES, batch=(TS_B, TS_S))
    rec, model = out["rec"], out["model"]
    check_launches("fsdp_sp", rec, flash_launches(model.cfg.n_layers, remat=True))
    flat = flat_by_name(out["grads"])
    if rec["losses"] != ctrl_rec["losses"] or not torch.equal(flat, ctrl_flat):
        raise AssertionError(f"fsdp_sp: not bitwise the model with no mesh (losses "
                             f"{rec['losses']} vs {ctrl_rec['losses']}, step-1 gradients "
                             f"{rel_norm(flat, ctrl_flat)} in relative norm)")
    rec["closed_form"] = check_bytes("fsdp_sp", rec, model.cfg, mesh, "fsdp", False)
    rec.update(phase="fsdp_sp", model=PP_MODEL, bitwise_no_mesh=True,
               no_mesh_median_step_ms_2_to_5=ctrl_rec["median_step_ms_2_to_5"])
    del out, model, flat
    gc.collect()
    torch.cuda.empty_cache()
    emit(rec)
    return rec


def beside_replicated(rec: dict, pairs) -> list:
    """Each FSDP variant of ``pairs`` (fsdp, replicated) beside the
    replicated run it took turns with, in its record: the step, peak
    memory and byte ratios. Returns the failures: the FSDP run's state
    bytes or peak memory not below the replicated run's."""
    failed = []
    for fsdp, rep in pairs:
        f, r = rec["variants"][fsdp]["by_rank"], rec["variants"][rep]["by_rank"]
        side = {"variant": rep,
                "step_ms_ratio": (max(f["median_step_ms_2_to_5"])
                                  / max(r["median_step_ms_2_to_5"])),
                "peak_mem_gb_ratio": max(f["peak_mem_gb"]) / max(r["peak_mem_gb"]),
                "peak_mem_gb_saved": max(r["peak_mem_gb"]) - max(f["peak_mem_gb"]),
                "state_bytes_ratio": f["state_bytes"][0] / r["state_bytes"][0],
                "param_bytes_ratio": f["param_bytes"][0] / r["param_bytes"][0],
                "grad_bytes_ratio": f["grad_bytes"][0] / r["grad_bytes"][0]}
        rec["variants"][fsdp]["beside_replicated"] = side
        if (max(f["state_bytes"]) >= min(r["state_bytes"])
                or max(f["peak_mem_gb"]) >= min(r["peak_mem_gb"])):
            failed.append(f"{fsdp}: state bytes {f['state_bytes']} and peak memory "
                          f"{f['peak_mem_gb']} GB not below {rep}'s {r['state_bytes']}, "
                          f"{r['peak_mem_gb']} GB")
    return failed


def fsdp_sp_rank(rank: int, size: int, init_file: str, queue, variants, tmp) -> None:
    """One spawned NCCL rank of ``fsdp_sp_multi`` on dp=2 x sp=2: each
    variant's record (the parameter, gradient and optimizer-state bytes at
    their closed form, the exact launches, every line of copies bitwise
    after its steps: the sp members of each dp shard, every rank for the
    uncut tensors); the ranks of sp index 0 write their step-1 gradients
    by name under ``tmp`` (under DEFAULT_RULES dp index 0's alone)."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb
        from horovod_tpu_torch.parallel.sharding import FSDP_RULES

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            recs = {}
            for name in variants:
                overrides, steps, _, kind, gated = FS_VARIANTS[name]
                mesh = hvd.create_mesh(FS_MESH)
                out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, **overrides},
                               keep_grads=gated, steps=steps, batch=(TS_B, TS_S),
                               rules=FSDP_RULES if kind == "fsdp" else None)
                rec, model = out["rec"], out["model"]
                cfg = model.cfg
                check_launches(name, rec, flash_launches(
                    cfg.n_layers if cfg.sp_use_flash else 0, remat=True))
                rec["closed_form"] = check_bytes(name, rec, cfg, mesh, kind, False)
                rec["replicas_bitwise"] = replicas_bitwise(hvd, model, mesh)
                if not all(rec["replicas_bitwise"].values()):
                    raise AssertionError(f"{name}: replicas differ: {rec['replicas_bitwise']}")
                rec["coords"] = dict(mesh.coords)
                if gated and mesh.coords["sp"] == 0 and (kind == "fsdp"
                                                         or mesh.coords["dp"] == 0):
                    save_grads(tmp, name, mesh.coords, out["grads"])
                recs[name] = rec
                del out, model
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_fsdp_sp_multi(controls) -> dict:
    """On four cards: the FS_VARIANTS on one spawned NCCL rank per card
    (dp=2 x sp=2, B=1 a dp rank of S=8192 cut over sp), each against its
    world-1 control from ``tp_sp_controls`` (the same model, weights and
    16,384 tokens). Gates, those of ``zero_mesh_multi`` and
    ``pp_sp_multi``: step-1 loss within 2e-3 relative and the steps' within
    1e-2; step-1 gradients, the dp shards joined to the full model, by
    ``grad_gates`` (the f32 witness within 1e-4 of the f32 control over the
    whole model and in every tensor, a bf16 variant's e_v at most twice e_1,
    its control's distance from the f32 control); per rank 48 launches of
    K1 and 24 of each K2 kernel a step with Ulysses-flash, none with the
    ring; the parameter, gradient and optimizer-state bytes at their closed
    form; every line of copies bitwise; the FSDP run's state bytes and peak
    memory below the replicated run's on the same mesh. Per rank the step
    ms, tokens/s and peak memory, the FSDP and the replicated runs in turns.
    Returns the record, with (fs1)'s launches on rank 0 (or "not
    measured")."""
    import functools
    import tempfile

    cards = torch.cuda.device_count()
    world = math.prod(FS_MESH.values())
    if cards < world:
        rec = {"phase": "fsdp_sp_multi", "cards": cards,
               "result": f"not measured: needs {world} cards"}
        emit(rec)
        return {"launches": rec["result"]}
    layout = controls["layout"]
    rec = {"phase": "fsdp_sp_multi", "cards": world, "mesh": FS_MESH, "variants": {},
           "controls": {name: {k: controls[name][0][k] for k in (
               "median_step_ms_2_to_5", "peak_mem_gb", "losses")}
               for name in ("flash", "ring1", "f32")}}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(fsdp_sp_rank, variants=list(FS_VARIANTS),
                                              tmp=tmp), world, timeout=1200)
        for name, (_, _, ctrl, kind, gated) in FS_VARIANTS.items():
            ctrl_rec, ctrl_flat = controls[ctrl]
            got = ranks[0][name]
            v = {"rank0": got, "control": ctrl, "kind": kind,
                 "by_rank": {k: [r[name][k] for r in ranks] for k in (
                     "median_step_ms_2_to_5", "tokens_per_s", "peak_mem_gb", "params_held",
                     "param_bytes", "grad_bytes", "state_bytes", "launches_per_step")}}
            v["tokens_per_s"] = TS_B * TS_S / (max(v["by_rank"]["median_step_ms_2_to_5"]) / 1e3)
            v["loss1_rel_err"] = abs(got["losses"][0] - ctrl_rec["losses"][0]) / abs(
                ctrl_rec["losses"][0])
            v["loss_max_rel_err"] = max(abs(a - b) / abs(b)
                                        for a, b in zip(got["losses"], ctrl_rec["losses"]))
            if v["loss1_rel_err"] > SP_LOSS1_RTOL or v["loss_max_rel_err"] > SP_LOSS_RTOL:
                failed.append(f"{name}: losses {got['losses']} vs {ctrl_rec['losses']}")
            if gated:
                grads = joined_grads(tmp, name, FS_MESH, kind == "fsdp", layout)
                gate = {"pp": (ctrl_rec, ctrl_flat), "f32": controls["f32"],
                        "e_1": rel_norm(ctrl_flat, controls["f32"][1])}
                fields, bad = grad_gates(name, "f32" if ctrl == "f32" else "bf16", grads,
                                         gate, layout)
                v.update(fields)
                failed += bad
                del grads
            rec["variants"][name] = v
    failed += beside_replicated(rec, (("fs1_ulysses_flash", "r1_ulysses_flash"),
                                      ("fs1b_ulysses_flash", "r1b_ulysses_flash")))
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    rec["launches"] = ranks[0]["fs1_ulysses_flash"]["launches"]
    return rec


# ---------------------------------------------------------------------------
# MoE under tensor parallelism (phases ``tp_moe`` and, with four cards,
# ``tp_moe_multi``): GPT-2 1.3B with 8 Switch experts in every other block
# (MOE_CFG, Switch-Base-8's layout; ``examples/jax_gpt2_train.py --model
# gpt2-1p3b --tp 2 --ep 2 --n-experts 8 --remat``), 4,237,295,616
# parameters, at B=8, S=2048 (phases pp and tp's 16,384 tokens a step).
# Its AdamW state (16 bytes a parameter, 67.8 GB) does not fit one card:
# the one-card run trains the largest even depth whose state and
# activations fit (2,894,880,768 parameters, 46.3 GB of state), and the
# full depth takes one forward and backward there, with no optimizer, as
# the four-card variants' control.
TM_DEPTH = 16
# The four-card variants: mesh, model overrides (beside remat and
# MOE_CFG), steps, the step-1 gradient gate (``grad_gates``: "bf16" e_v
# at most twice e_1, "f32" the witness within 1e-4 of the f32 control).
TM_VARIANTS = {
    "tm1_tp2_ep2": ({"ep": 2, "tp": 2}, {}, STEPS, "bf16"),
    "tm2_tp4": ({"tp": 4}, {}, STEPS, "bf16"),
    "tm3_dp2_tp2": ({"dp": 2, "tp": 2}, {}, STEPS, "bf16"),
    # sp_multi's expert-parallel path (e1) at this size: the reference of
    # the other variants' 5 losses, since the full depth cannot take 5
    # AdamW steps on one card.
    "tm4_ep4": ({"ep": 4}, {}, STEPS, "bf16"),
    "tm1f_tp2_ep2_f32": ({"ep": 2, "tp": 2}, TP_F32, 1, "f32"),
}
TM_REFERENCE = "tm4_ep4"


def routes_agree(hvd, model, mesh) -> bool:
    """Whether every Switch FFN's routes (``expert_idx`` of the last
    forward) are bitwise equal on every rank of this rank's tp line and of
    its ep line: one all-gather a block and line."""
    ok = True
    for axis in ("tp", "ep"):
        if mesh.shape.get(axis, 1) == 1:
            continue
        for block in model.moe_blocks():
            got = hvd.allgather(block.expert_idx[None], axis_name=axis)
            ok = ok and bool(torch.equal(got, got[:1].expand_as(got)))
    return ok


def world1_fwd_bwd(hvd, fa, fb, overrides: dict) -> tuple:
    """One forward and backward, with no optimizer (so no AdamW state), of
    the full-depth model (MOE_CFG, remat, ``overrides``) built with no mesh
    on one card: ``lm_loss`` plus MOE_AUX times the auxiliary loss on the
    global batch of numpy seed 42, as a step-1 of ``make_train_step``
    computes it. Each gradient moves to host memory as backward completes
    it, so that the card holds the f32 weights and the activations alone
    (the f32 run with dense attention would not fit beside its
    gradients). Returns (record, gradients flat in name order, layout)."""
    from horovod_tpu_torch.parallel.train import lm_loss

    mesh = full_mesh({})
    model = gpt2_1p3b(mesh, False, seq=PP_S, bare=True, remat=True, **MOE_CFG, **overrides)
    ids = pp_ids(PP_B, PP_S).to(mesh.device)
    grads = {}

    def to_host(name):
        def hook(p):
            g = p.grad.detach().cpu()
            grads[name] = grads[name] + g if name in grads else g
            p.grad = None
        return hook

    hooks = [p.register_post_accumulate_grad_hook(to_host(n))
             for n, p in model.named_parameters()]
    model.train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fb.reset_launches()
    t0 = time.perf_counter()
    loss = lm_loss(model(ids), ids) + MOE_AUX * model.moe_aux_loss()
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    for h in hooks:
        h.remove()
    rec = {"overrides": {k: str(v) if isinstance(v, torch.dtype) else v
                         for k, v in overrides.items()},
           "batch": PP_B, "seq": PP_S, "n_layers": model.cfg.n_layers,
           "params": sum(p.numel() for p in model.parameters()),
           "losses": [float(loss.detach())],
           "dropped_per_step": [sum(int(d) for d in model.moe_dropped())],
           "fwd_bwd_ms": ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": fa.launches()}
    if len(grads) != len(list(model.parameters())):
        raise AssertionError(f"tp_moe control: {len(grads)} gradients reached the host")
    layout = [(n, g.numel()) for n, g in sorted(grads.items())]
    flat = flat_by_name(grads)
    del model, loss, grads
    gc.collect()
    torch.cuda.empty_cache()
    return rec, flat, layout


def phase_tp_moe(fa, fb) -> tuple:
    """GPT-2 1.3B with 8 Switch experts at full width and TM_DEPTH layers,
    B=8, S=2048, bf16, flash, remat, AdamW with the auxiliary loss: built
    on a dp=1 x ep=1 x sp=1 x tp=1 mesh through the MoE-under-tp code and
    with no mesh, 5 steps each, whose losses, step-1 gradients and dropped
    tokens must be bitwise equal; 2·L launches of K1 and L of each K2
    kernel a step. Then the full-depth world-1 controls of ``tp_moe_multi``
    (``world1_fwd_bwd``): bf16 with flash, and f32 with dense attention.
    Returns the record, the controls: "bf16" and "f32" (record, step-1
    gradients flat in name order), "layout" and "e_1", the bf16 control's
    distance from the f32 one; and the no-mesh run (its record, its step-1
    gradients flat in name order), the control of phase ``fsdp_moe``."""
    import horovod_tpu_torch as hvd

    mesh = full_mesh({})
    rec = {"phase": "tp_moe", "model": PP_MODEL, "moe": MOE_CFG, "n_layers": TM_DEPTH,
           "batch": PP_B, "seq": PP_S}
    runs = {}
    for bare in (True, False):
        out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, "n_layers": TM_DEPTH,
                                                  **MOE_CFG},
                       keep_grads=True, bare=bare)
        runs[bare] = (out["rec"], flat_by_name(out["grads"]))
        del out
        gc.collect()
        torch.cuda.empty_cache()
    (r, flat), (bare_rec, bare_flat) = runs[False], runs[True]
    check_launches("tp_moe", r, flash_launches(TM_DEPTH, remat=True))
    if (r["losses"] != bare_rec["losses"] or not torch.equal(flat, bare_flat)
            or r["dropped_per_step"] != bare_rec["dropped_per_step"]):
        raise AssertionError(f"tp_moe: not bitwise the model with no mesh (losses "
                             f"{r['losses']} vs {bare_rec['losses']}, dropped "
                             f"{r['dropped_per_step']} vs {bare_rec['dropped_per_step']}, "
                             f"step-1 gradients {rel_norm(flat, bare_flat)} in relative norm)")
    if r["losses"][-1] >= r["losses"][0]:
        raise AssertionError(f"tp_moe: the loss did not fall: {r['losses']}")
    r.update(bitwise_no_mesh=True,
             no_mesh_median_step_ms_2_to_5=bare_rec["median_step_ms_2_to_5"],
             no_mesh_peak_mem_gb=bare_rec["peak_mem_gb"])
    rec.update(r)
    del runs, flat
    controls = tp_moe_controls(hvd, fa, fb)
    rec.update(control_bf16=controls["bf16"][0], control_f32=controls["f32"][0],
               e_1=controls["e_1"])
    emit(rec)
    return rec, controls, (bare_rec, bare_flat)


def tp_moe_controls(hvd, fa, fb) -> dict:
    """The full-depth world-1 controls of ``tp_moe_multi``
    (``world1_fwd_bwd``): "bf16" with flash (48/24/24 launches) and "f32"
    with dense attention, each (record, step-1 gradients flat in name
    order); "layout" the parameters' (name, size) in that order, and
    "e_1" the bf16 control's distance from the f32 one."""
    controls = {}
    for kind, overrides in (("bf16", {}), ("f32", TP_F32)):
        ctrl, ctrl_flat, layout = world1_fwd_bwd(hvd, fa, fb, overrides)
        controls[kind] = (ctrl, ctrl_flat)
        controls["layout"] = layout
    check_launches("tp_moe control", {"launches_per_step": controls["bf16"][0]["launches"]},
                   flash_launches(controls["bf16"][0]["n_layers"], remat=True))
    controls["e_1"] = rel_norm(controls["bf16"][1], controls["f32"][1])
    return controls


def tp_moe_rank(rank: int, size: int, init_file: str, queue, name: str, tmp) -> None:
    """One spawned NCCL rank of ``tp_moe_multi``'s variant ``name``: its
    record (launches, the parameters held against their closed form, the
    routes bitwise on every tp and ep line after every step, the replicas
    bitwise on every line of copies); the ranks of dp index 0 write their
    step-1 gradients by name under ``tmp``, each once (17 GB a variant)."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models.convert import EXPERT_PARAMS
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb
        from horovod_tpu_torch.parallel.tensor import tp_cut

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            shape, overrides, steps, _ = TM_VARIANTS[name]
            mesh = full_mesh(shape)
            routes = []
            out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, **MOE_CFG, **overrides},
                           keep_grads=True, steps=steps,
                           each_step=lambda m: routes.append(routes_agree(hvd, m, mesh)))
            rec, model = out["rec"], out["model"]
            cfg = model.cfg
            check_launches(name, rec, flash_launches(
                cfg.n_layers if cfg.attn_impl == "flash" else 0, remat=True))
            rec["params_closed_form"] = held_closed_form(cfg, mesh, False, False)
            if rec["params_held"] != rec["params_closed_form"]:
                raise AssertionError(f"{name}: {rec['params_held']} parameters held, "
                                     f"closed form {rec['params_closed_form']}")
            rec["routes_bitwise_by_step"] = routes
            if not all(routes):
                raise AssertionError(f"{name}: routes differ on a tp or ep line: {routes}")
            rec["replicas_bitwise"] = replicas_bitwise(hvd, model, mesh)
            if not all(rec["replicas_bitwise"].values()):
                raise AssertionError(f"{name}: replicas differ: {rec['replicas_bitwise']}")
            rec["coords"] = c = dict(mesh.coords)
            if c["dp"] == 0:
                # Each gradient once: the experts from every ep rank, the
                # tp-cut ones from every tp rank, the rest from the first.
                save_grads(tmp, name, c, {
                    n: g for n, g in out["grads"].items()
                    if (n.endswith(EXPERT_PARAMS) or c["ep"] == 0)
                    and (tp_cut(n, cfg, mesh.shape["tp"], c["tp"]) is not None or c["tp"] == 0)})
            del out, model
            gc.collect()
            torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, rec))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_tp_moe_multi(controls) -> dict:
    """On four cards: each TM_VARIANTS variant on its own world of one
    spawned NCCL rank per card (its step-1 gradients joined and dropped
    before the next), against ``phase_tp_moe``'s full-depth controls.
    Gates: step-1 loss within 2e-3 relative of the control's; the 5 losses
    of every bf16 variant within 1e-2 of (tm4)'s, the ep path sp_multi holds
    against world 1; step-1 gradients, joined over tp and ep to the full
    model, by ``grad_gates`` (the f32 witness within 1e-4 of the f32
    control over the whole model and in every tensor, each bf16 variant's
    e_v at most twice e_1); step-1 dropped tokens within 0.1% of the
    control's; and per rank (``tp_moe_rank``) the exact launches, the
    parameters held at their closed form, the routes bitwise on every tp
    and ep line at every step, the replicas bitwise on every line. Per
    rank the step ms, tokens/s and peak memory, read on the slowest.
    Returns the record, whose (tm4) losses ``fsdp_moe_multi`` holds its
    own against."""
    import functools
    import tempfile

    cards = torch.cuda.device_count()
    if cards < 4:
        rec = {"phase": "tp_moe_multi", "cards": cards, "result": "not measured: needs 4 cards"}
        emit(rec)
        return rec
    layout = controls["layout"]
    rec = {"phase": "tp_moe_multi", "cards": 4, "variants": {}, "e_1": controls["e_1"],
           "controls": {k: {f: controls[k][0][f] for f in (
               "fwd_bwd_ms", "peak_mem_gb", "losses", "dropped_per_step")}
               for k in ("bf16", "f32")}}
    failed = []
    for name, (shape, _, _, gate) in TM_VARIANTS.items():
        ctrl_rec = controls["f32" if gate == "f32" else "bf16"][0]
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn_cards(functools.partial(tp_moe_rank, name=name, tmp=tmp), 4,
                                timeout=900)
            grads = joined_grads(tmp, name, {a: shape.get(a, 1) for a in ("dp", "ep", "tp")},
                                 False, layout)
        got = ranks[0]
        v = {"rank0": got, "mesh": shape,
             "by_rank": {k: [r[k] for r in ranks] for k in (
                 "median_step_ms_2_to_5", "tokens_per_s", "peak_mem_gb", "params_held",
                 "launches_per_step", "routes_bitwise_by_step")}}
        v["tokens_per_s"] = PP_B * PP_S / (max(v["by_rank"]["median_step_ms_2_to_5"]) / 1e3)
        v["loss1_rel_err"] = abs(got["losses"][0] - ctrl_rec["losses"][0]) / abs(
            ctrl_rec["losses"][0])
        if v["loss1_rel_err"] > SP_LOSS1_RTOL:
            failed.append(f"{name}: step-1 loss {got['losses'][0]} vs {ctrl_rec['losses'][0]}")
        v["dropped_step1"] = got["dropped_per_step"][0]
        v["control_dropped_step1"] = ctrl_rec["dropped_per_step"][0]
        if abs(v["dropped_step1"] - v["control_dropped_step1"]) \
                > DROP_RTOL * v["control_dropped_step1"]:
            failed.append(f"{name}: {v['dropped_step1']} tokens dropped at step 1, control "
                          f"{v['control_dropped_step1']}")
        fields, bad = grad_gates(name, gate, grads, {"pp": controls["bf16"],
                                                     "f32": controls["f32"],
                                                     "e_1": controls["e_1"]}, layout)
        v.update(fields)
        failed += bad
        del grads
        gc.collect()
        rec["variants"][name] = v
    ref = rec["variants"][TM_REFERENCE]["rank0"]["losses"]
    for name, v in rec["variants"].items():
        if TM_VARIANTS[name][3] == "bf16" and name != TM_REFERENCE:
            got = v["rank0"]["losses"]
            v["loss_max_rel_err_vs_tm4"] = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
            if v["loss_max_rel_err_vs_tm4"] > SP_LOSS_RTOL:
                failed.append(f"{name}: losses {got} vs {TM_REFERENCE}'s {ref}")
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    return rec

# ---------------------------------------------------------------------------
# FSDP with Switch experts and ep (phases ``fsdp_moe`` and, with four cards,
# ``fsdp_moe_multi``): tp_moe's GPT-2 1.3B with 8 Switch experts (MOE_CFG,
# Switch-Base-8's layout) at full depth, B=8, S=2048, under ``FSDP_RULES``
# over dp=2 x ep=2: the router's and each rank's E/ep experts' d_model cut
# over dp beside every dense parameter's (the JAX "embed" row, placing the
# router kernel ``P('dp', None)``, ``moe.wi`` ``P('ep', 'dp', None)`` and
# ``moe.wo`` ``P('ep', None, 'dp')``), the dense parameters and the router
# replicated over ep.
FM_MESH = {"dp": 2, "ep": 2}
# The four-card variants on dp=2 x ep=2: model overrides (beside remat and
# MOE_CFG), steps, the world-1 control of ``tp_moe_controls``, "fsdp"
# (FSDP_RULES) or "replicated" (DEFAULT_RULES on the same mesh, the
# yardstick of memory and time), and whether its step-1 gradients are
# gated. The FSDP and the replicated runs take turns (fsdp, replicated,
# replicated, fsdp); the second turn is timed and gated on its losses,
# dropped tokens, routes and bytes only.
FM_VARIANTS = {
    "fm1": ({}, STEPS, "bf16", "fsdp", True),
    "rm1": ({}, STEPS, "bf16", "replicated", True),
    "rm1b": ({}, STEPS, "bf16", "replicated", False),
    "fm1b": ({}, STEPS, "bf16", "fsdp", False),
    "fm1f": (TP_F32, 1, "f32", "fsdp", True),
}


def phase_fsdp_moe(fa, fb, control) -> dict:
    """GPT-2 1.3B with 8 Switch experts at TM_DEPTH layers, B=8, S=2048,
    bf16, flash, remat, AdamW with the auxiliary loss, under ``FSDP_RULES``
    on a dp=1 x ep=1 x sp=1 x tp=1 mesh (the experts' gathers on a dp line
    of one member): 5 steps whose losses, dropped tokens and step-1
    gradients must be bitwise ``control``'s, phase ``tp_moe``'s run of the
    model built with no mesh; 2·L launches of K1 and L of each K2 kernel a
    step; the parameter, gradient and optimizer-state bytes at their closed
    form."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.sharding import FSDP_RULES

    ctrl_rec, ctrl_flat = control
    mesh = full_mesh({})
    out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, "n_layers": TM_DEPTH, **MOE_CFG},
                   keep_grads=True, rules=FSDP_RULES)
    rec, model = out["rec"], out["model"]
    check_launches("fsdp_moe", rec, flash_launches(TM_DEPTH, remat=True))
    flat = flat_by_name(out["grads"])
    if (rec["losses"] != ctrl_rec["losses"] or not torch.equal(flat, ctrl_flat)
            or rec["dropped_per_step"] != ctrl_rec["dropped_per_step"]):
        raise AssertionError(f"fsdp_moe: not bitwise the model with no mesh (losses "
                             f"{rec['losses']} vs {ctrl_rec['losses']}, dropped "
                             f"{rec['dropped_per_step']} vs {ctrl_rec['dropped_per_step']}, "
                             f"step-1 gradients {rel_norm(flat, ctrl_flat)} in relative norm)")
    rec["closed_form"] = check_bytes("fsdp_moe", rec, model.cfg, mesh, "fsdp", False)
    rec.update(phase="fsdp_moe", model=PP_MODEL, moe=MOE_CFG, n_layers=TM_DEPTH,
               bitwise_no_mesh=True,
               no_mesh_median_step_ms_2_to_5=ctrl_rec["median_step_ms_2_to_5"])
    del out, model, flat
    gc.collect()
    torch.cuda.empty_cache()
    emit(rec)
    return rec


def fsdp_moe_rank(rank: int, size: int, init_file: str, queue, variants, tmp) -> None:
    """One spawned NCCL rank of ``fsdp_moe_multi`` on dp=2 x ep=2: each
    variant's record (the exact launches, the parameter, gradient and
    optimizer-state bytes at their closed form, the routes bitwise on the
    ep line after every step, every line of copies bitwise after its
    steps); the ranks write their step-1 gradients by name under ``tmp``,
    each once: the experts from every ep rank, the rest from ep index 0,
    every dp shard under FSDP_RULES (dp index 0's alone under
    DEFAULT_RULES)."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models.convert import EXPERT_PARAMS
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb
        from horovod_tpu_torch.parallel.sharding import FSDP_RULES

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            recs = {}
            for name in variants:
                overrides, steps, _, kind, gated = FM_VARIANTS[name]
                mesh = full_mesh(FM_MESH)
                routes = []
                out = train_pp(hvd, fa, fb, mesh, False, {"remat": True, **MOE_CFG, **overrides},
                               keep_grads=gated, steps=steps,
                               rules=FSDP_RULES if kind == "fsdp" else None,
                               each_step=lambda m: routes.append(routes_agree(hvd, m, mesh)))
                rec, model = out["rec"], out["model"]
                cfg = model.cfg
                check_launches(name, rec, flash_launches(
                    cfg.n_layers if cfg.attn_impl == "flash" else 0, remat=True))
                rec["closed_form"] = check_bytes(name, rec, cfg, mesh, kind, False)
                rec["routes_bitwise_by_step"] = routes
                if not all(routes):
                    raise AssertionError(f"{name}: routes differ on the ep line: {routes}")
                rec["replicas_bitwise"] = replicas_bitwise(hvd, model, mesh)
                if not all(rec["replicas_bitwise"].values()):
                    raise AssertionError(f"{name}: replicas differ: {rec['replicas_bitwise']}")
                rec["coords"] = c = dict(mesh.coords)
                if gated and (kind == "fsdp" or c["dp"] == 0):
                    save_grads(tmp, name, c, {n: g for n, g in out["grads"].items()
                                              if n.endswith(EXPERT_PARAMS) or c["ep"] == 0})
                recs[name] = rec
                del out, model
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_fsdp_moe_multi(controls, tm_multi) -> dict:
    """On four cards: the FM_VARIANTS on one spawned NCCL rank per card
    (dp=2 x ep=2, B=4 a dp rank), each against its full-depth world-1
    control from ``tp_moe_controls`` (the same model, weights and 16,384
    tokens) and, for the bf16 variants, against (tm4)'s 5 losses from
    ``tm_multi``, phase ``tp_moe_multi``'s record. Gates, those of
    ``tp_moe_multi`` and ``fsdp_sp_multi``: step-1 loss within 2e-3
    relative of the control's and the 5 within 1e-2 of (tm4)'s; step-1
    gradients, the dp shards and the ep ranks' experts joined to the full
    model, by ``grad_gates`` (the f32 witness within 1e-4 of the f32
    control over the whole model and in every tensor, a bf16 variant's e_v
    at most twice e_1); step-1 dropped tokens within 0.1% of the control's;
    per rank 48 launches of K1 and 24 of each K2 kernel a step with flash;
    the routes bitwise on every ep line at every step; every line of
    copies bitwise; the parameter, gradient and optimizer-state bytes at
    their closed form; the FSDP runs' state bytes and peak memory below
    the replicated runs' on the same mesh. Per rank the step ms, tokens/s
    and peak memory, the FSDP and the replicated runs in turns. Returns the
    record, with (fm1)'s launches on rank 0 (or "not measured")."""
    import functools
    import glob
    import os
    import tempfile

    cards = torch.cuda.device_count()
    world = math.prod(FM_MESH.values())
    if cards < world or "variants" not in tm_multi:
        rec = {"phase": "fsdp_moe_multi", "cards": cards,
               "result": f"not measured: needs {world} cards"}
        emit(rec)
        return {"launches": rec["result"]}
    layout = controls["layout"]
    ref = tm_multi["variants"][TM_REFERENCE]["rank0"]["losses"]
    rec = {"phase": "fsdp_moe_multi", "cards": world, "mesh": FM_MESH, "model": PP_MODEL,
           "moe": MOE_CFG, "variants": {}, "e_1": controls["e_1"],
           "reference": {"variant": TM_REFERENCE, "losses": ref},
           "controls": {k: {f: controls[k][0][f] for f in (
               "fwd_bwd_ms", "peak_mem_gb", "losses", "dropped_per_step")}
               for k in ("bf16", "f32")}}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(fsdp_moe_rank, variants=list(FM_VARIANTS),
                                              tmp=tmp), world, timeout=1200)
        for name, (_, _, ctrl, kind, gated) in FM_VARIANTS.items():
            ctrl_rec = controls[ctrl][0]
            got = ranks[0][name]
            v = {"rank0": got, "control": ctrl, "kind": kind,
                 "by_rank": {k: [r[name][k] for r in ranks] for k in (
                     "median_step_ms_2_to_5", "tokens_per_s", "peak_mem_gb", "params_held",
                     "param_bytes", "grad_bytes", "state_bytes", "launches_per_step",
                     "routes_bitwise_by_step")}}
            v["tokens_per_s"] = PP_B * PP_S / (max(v["by_rank"]["median_step_ms_2_to_5"]) / 1e3)
            v["loss1_rel_err"] = abs(got["losses"][0] - ctrl_rec["losses"][0]) / abs(
                ctrl_rec["losses"][0])
            if v["loss1_rel_err"] > SP_LOSS1_RTOL:
                failed.append(f"{name}: step-1 loss {got['losses'][0]} vs "
                              f"{ctrl_rec['losses'][0]}")
            if ctrl == "bf16":
                v["loss_max_rel_err_vs_tm4"] = max(abs(a - b) / abs(b)
                                                   for a, b in zip(got["losses"], ref))
                if v["loss_max_rel_err_vs_tm4"] > SP_LOSS_RTOL:
                    failed.append(f"{name}: losses {got['losses']} vs {TM_REFERENCE}'s {ref}")
            v["dropped_step1"] = got["dropped_per_step"][0]
            v["control_dropped_step1"] = ctrl_rec["dropped_per_step"][0]
            if abs(v["dropped_step1"] - v["control_dropped_step1"]) \
                    > DROP_RTOL * v["control_dropped_step1"]:
                failed.append(f"{name}: {v['dropped_step1']} tokens dropped at step 1, "
                              f"control {v['control_dropped_step1']}")
            if gated:
                grads = joined_grads(tmp, name, FM_MESH, kind == "fsdp", layout)
                for path in glob.glob(f"{tmp}/{name}.*.pt"):   # 17 GB a variant
                    os.remove(path)
                fields, bad = grad_gates(name, ctrl, grads, {"pp": controls["bf16"],
                                                             "f32": controls["f32"],
                                                             "e_1": controls["e_1"]}, layout)
                v.update(fields)
                failed += bad
                del grads
                gc.collect()
            rec["variants"][name] = v
    failed += beside_replicated(rec, (("fm1", "rm1"), ("fm1b", "rm1b")))
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    rec["launches"] = ranks[0]["fm1"]["launches"]
    return rec


# ---------------------------------------------------------------------------
# The configurations of record not yet run (phases ``vit``, ``mnist`` and,
# with cards enough, ``vit_multi``, ``mnist_multi``, ``adasum_1p3b_multi``):
# BASELINE.json's "ViT-L/16 ImageNet DP" at
# ``examples/jax_synthetic_benchmark.py``'s 32 images a card, its 2-process
# MNIST allreduce (``examples/jax_mnist.py``) and "GPT-2 1.3B + Adasum".
VIT_MODEL = "vit-l16"
VIT_B = 32                  # a card's batch
VIT_PARAMS = 304_326_632    # the JAX ViT-L/16 tree (tests/test_torch_port_vit.py)
VIT_CARDS = 4
MNIST_CARDS = 2
MNIST_STEP1_ATOL = 1e-5
ADASUM_CARDS = 4
# The combined gradient is held against adasum_numpy on these tensors.
ADASUM_TENSORS = ("embed.embedding", "stack.layers.0.attn.qkv.weight", "ln_f.weight")
# tests/test_adasum.py's rtol, and its atol on O(1) values scaled by the
# tensor's largest element.
ADASUM_RTOL, ADASUM_ATOL = 1e-4, 1e-5


def vit_params_closed_form(cfg) -> int:
    """The JAX ViT's parameters from its shapes: the patch kernel and bias,
    the CLS token, the positions, L blocks (two LayerNorms, qkv and out with
    biases, wi and wo with biases), ``ln_f`` and the head with its bias."""
    D, F, p = cfg.d_model, cfg.d_ff, cfg.patch_size
    block = 4 * D + (3 * D * D + 3 * D) + (D * D + D) + (D * F + F) + (F * D + D)
    return ((p * p * 3 * D + D) + D + (cfg.n_patches + 1) * D + cfg.n_layers * block
            + 2 * D + D * cfg.num_classes + cfg.num_classes)


def vit_flops(cfg, Bn: int) -> float:
    """A training step's operations (3x the forward): the matrix products'
    parameters times the tokens, and the two attention products."""
    T, D, L = cfg.n_patches + 1, cfg.d_model, cfg.n_layers
    matmul = (cfg.patch_size ** 2 * 3 * D * cfg.n_patches / T
              + L * (4 * D * D + 2 * D * cfg.d_ff))
    return 6 * matmul * Bn * T + 3 * L * 4 * T * T * D * Bn + 6 * D * cfg.num_classes * Bn


def vit_batch(batch: int):
    """bench.py's synthetic batch: numpy seed 42, images, then labels (for
    ViT-L/16, 224x224 and [0, 1000))."""
    from horovod_tpu_torch.models.vit import VIT_CONFIGS

    cfg = VIT_CONFIGS[VIT_MODEL]
    rng = np.random.RandomState(42)
    images = rng.rand(batch, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(
        rng.randint(0, cfg.num_classes, size=(batch,), dtype=np.int32))


def train_vit(hvd, fa, fb, mesh, batch: int, keep_grads: bool) -> dict:
    """STEPS SGD(0.01, momentum 0.9) steps of ViT-L/16 from torch seed 0
    through ``make_train_step`` over ``mesh``'s dp on the global ``batch``;
    no flash or fused-BN launch. Returns the record, the model and, with
    ``keep_grads``, the reduced step-1 gradients (what SGD gets), flat in
    host memory."""
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.train import make_train_step, softmax_xent

    dev = mesh.device
    model = get_model(VIT_MODEL).make_model(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    images, labels = (t.to(dev) for t in vit_batch(batch))
    inner = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    got, inner_step = {}, inner.step

    def step(*a, **kw):
        if keep_grads and "grads" not in got:
            got["grads"] = torch.cat([p.grad.detach().reshape(-1).cpu()
                                      for p in model.parameters()])
        return inner_step(*a, **kw)

    inner.step = step
    init_fn, step_fn = make_train_step(model, inner, softmax_xent, mesh=mesh)
    state = init_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fb.reset_launches()
    state, losses, step_ms = steps(step_fn, state, images, labels)
    launches = {**fa.launches(), **fb.launches()}
    if any(launches.values()):
        raise AssertionError(f"ViT launched kernels: {launches}")
    steady = statistics.median(step_ms[1:])
    per_card = batch // mesh.shape["dp"]
    flops = vit_flops(model.cfg, per_card)
    rec = {"model": VIT_MODEL, "mesh": dict(mesh.shape), "batch": batch,
           "batch_per_card": per_card, "losses": losses, "step_ms": step_ms,
           "median_step_ms_2_to_5": steady, "images_per_s": per_card / (steady / 1e3),
           "model_tflops_per_s": flops / (steady / 1e3) / 1e12,
           "model_flops_share_of_989": flops / (steady / 1e3) / PEAK_BF16_FLOPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
           "launches_per_step": {k: v / STEPS for k, v in launches.items()}}
    del inner, inner_step, step, state, images, labels
    return {"rec": rec, "model": model, "grads": got.get("grads")}


def phase_vit(fa, fb) -> dict:
    """ViT-L/16 on one card: its parameters against the JAX tree's closed
    form, the bf16 forward loss within 2e-2 of the same weights in f32, then
    5 SGD-momentum steps at B=32; no kernel of K1-K4 runs."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.registry import get_model
    from horovod_tpu_torch.parallel.train import softmax_xent

    dev = hvd.device()
    mesh = hvd.create_mesh({"dp": 1})
    spec = get_model(VIT_MODEL)
    model = spec.make_model(device=dev, generator=torch.Generator(device=dev).manual_seed(0),
                            mesh=mesh)
    held = sum(p.numel() for p in model.parameters())
    closed = vit_params_closed_form(model.cfg)
    if not held == closed == VIT_PARAMS:
        raise AssertionError(f"vit: {held} parameters, closed form {closed}, JAX {VIT_PARAMS}")
    f32 = spec.make_model(device=dev, mesh=mesh, dtype=torch.float32)
    f32.load_state_dict(model.state_dict())
    images, labels = (t.to(dev) for t in vit_batch(VIT_B))
    with torch.no_grad():
        loss_bf16 = float(softmax_xent(model(images), labels))
        loss_f32 = float(softmax_xent(f32(images), labels))
    check_loss("vit-l16 bf16 vs f32", loss_bf16, loss_f32)
    del model, f32, images, labels
    torch.cuda.empty_cache()
    out = train_vit(hvd, fa, fb, mesh, VIT_B, keep_grads=False)
    rec = {"phase": "vit", "params": held, "params_closed_form": closed,
           "loss_bf16_fwd": loss_bf16, "loss_f32_fwd": loss_f32, **out["rec"]}
    emit(rec)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def vit_rank(rank: int, size: int, init_file: str, queue, tmp) -> None:
    """One spawned NCCL rank of ``vit_multi``: ViT-L/16 over dp=size at
    VIT_B a card; rank 0 writes the reduced step-1 gradients under
    ``tmp``; every rank checks its parameters bitwise rank 0's."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            out = train_vit(hvd, fa, fb, hvd.create_mesh({"dp": size}), VIT_B * size,
                            keep_grads=rank == 0)
            rec = out["rec"]
            flat = torch.cat([p.detach().reshape(-1) for p in out["model"].parameters()])
            rec["replicas_bitwise"] = bool(torch.equal(flat, hvd.broadcast(flat, 0)))
            if not rec["replicas_bitwise"]:
                raise AssertionError(f"vit_multi rank {rank}: replicas differ")
            if rank == 0:
                torch.save(out["grads"], f"{tmp}/vit_grads.pt")
            hvd.barrier()
            queue.put((rank, rec))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_vit_multi(fa, fb) -> dict:
    """With four cards: ViT-L/16 over dp=4 at 32 images a card against a
    world-1 control on the global 128: step-1 loss within 2e-3, the 5
    losses within 1e-2, step-1 gradients within 1e-2 in relative norm,
    replicas bitwise (the gates of ``sp_multi``)."""
    import functools
    import tempfile

    import horovod_tpu_torch as hvd

    cards = torch.cuda.device_count()
    if cards < VIT_CARDS:
        emit({"phase": "vit_multi", "cards": cards,
              "result": f"not measured: needs {VIT_CARDS} cards"})
        return {"launches": "not measured"}
    ctrl = train_vit(hvd, fa, fb, hvd.create_mesh({"dp": 1}), VIT_B * VIT_CARDS,
                     keep_grads=True)
    ctrl_rec, ctrl_grads = ctrl["rec"], ctrl["grads"]
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(vit_rank, tmp=tmp), VIT_CARDS, timeout=900)
        grads = torch.load(f"{tmp}/vit_grads.pt")
    got = ranks[0]
    rec = {"phase": "vit_multi", "cards": cards, "control": ctrl_rec, "rank0": got,
           "median_step_ms_by_rank": [r["median_step_ms_2_to_5"] for r in ranks],
           "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in ranks],
           "launches_per_step_by_rank": [r["launches_per_step"] for r in ranks],
           "replicas_bitwise_by_rank": [r["replicas_bitwise"] for r in ranks]}
    slowest = max(rec["median_step_ms_by_rank"])
    rec["images_per_s_per_card"] = VIT_B / (slowest / 1e3)
    rec["weak_scaling_efficiency_vs_control"] = (ctrl_rec["median_step_ms_2_to_5"] / VIT_CARDS
                                                 / slowest)
    rec["loss1_rel_err"] = abs(got["losses"][0] - ctrl_rec["losses"][0]) / abs(
        ctrl_rec["losses"][0])
    rec["loss_max_rel_err"] = max(abs(a - b) / abs(b)
                                  for a, b in zip(got["losses"], ctrl_rec["losses"]))
    rec["step1_grad_rel_norm_err"] = rel_norm(grads, ctrl_grads)
    emit(rec)
    if rec["loss1_rel_err"] > SP_LOSS1_RTOL or rec["loss_max_rel_err"] > SP_LOSS_RTOL:
        raise AssertionError(f"vit_multi: losses {got['losses']} vs {ctrl_rec['losses']}")
    if rec["step1_grad_rel_norm_err"] > SP_GRAD_RTOL:
        raise AssertionError(f"vit_multi: step-1 gradients {rec['step1_grad_rel_norm_err']} "
                             "off the control's in relative norm")
    return {"launches": got["launches"]}


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms: one shard's gradients are then the
    same bits on a rank and in the control."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def mnist_args(*extra: str):
    from horovod_tpu_torch import train_mnist

    return train_mnist.parse_args(["--epochs", "1", *extra])


def mnist_record(out: dict, world: int) -> dict:
    losses = out["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise AssertionError(f"mnist: the loss did not fall: {first} -> {last}")
    per_step = out["seconds"] * 1e3 / len(losses)
    return {"world": world, "steps": len(losses), "batch_per_rank": 64,
            "loss_first10": first, "loss_last10": last, "epoch_losses": out["epoch_losses"],
            "accuracy_first_1024": out["accuracy"], "seconds": out["seconds"],
            "ms_per_step": per_step, "images_per_s_per_rank": 64 / (per_step / 1e3)}


def phase_mnist(fa, fb) -> dict:
    """``train_mnist`` for one epoch of the synthetic set on this card (128
    steps of 64 images, Adam): the loss falls; no kernel of K1-K4 runs."""
    from horovod_tpu_torch import train_mnist

    fa.reset_launches()
    fb.reset_launches()
    with deterministic_convolutions():
        out = train_mnist.train(mnist_args())
    launches = {**fa.launches(), **fb.launches()}
    if any(launches.values()):
        raise AssertionError(f"mnist launched kernels: {launches}")
    rec = {"phase": "mnist", **mnist_record(out, 1), "launches": launches}
    emit(rec)
    return rec


def mnist_rank(rank: int, size: int, init_file: str, queue) -> None:
    """One spawned NCCL rank of ``mnist_multi``: ``train_mnist`` one step,
    then one epoch; both runs' final parameters, bitwise rank 0's."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import train_mnist
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb

        full_precision_products()      # no TF32 convolutions, as in the control
        hvd.init(init_method=f"file://{init_file}")
        try:
            with deterministic_convolutions():
                one = train_mnist.train(mnist_args("--steps", "1"))
                fa.reset_launches()
                fb.reset_launches()
                epoch = train_mnist.train(mnist_args())
            rec = {"step1_params": {k: v.numpy() for k, v in one["final"].items()},
                   **mnist_record(epoch, size), "launches": {**fa.launches(), **fb.launches()}}
            if any(rec["launches"].values()):
                raise AssertionError(f"mnist_multi launched kernels: {rec['launches']}")
            flat = torch.cat([v.reshape(-1) for v in epoch["final"].values()]).to(hvd.device())
            rec["replicas_bitwise"] = bool(torch.equal(flat, hvd.broadcast(flat, 0)))
            hvd.barrier()
            queue.put((rank, rec))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def mnist_control(size: int) -> dict:
    """The step-1 parameters of a world-1 ``MnistCNN`` from torch seed 0
    fed the mean of the ``size`` shards' first-batch gradients, Adam at
    lr · size (what ``train_mnist``'s first step does on ``size`` ranks)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import train_mnist
    from horovod_tpu_torch.models.mnist import MnistCNN
    from horovod_tpu_torch.parallel.train import softmax_xent

    dev = hvd.device()
    args = mnist_args()
    x, y = train_mnist.synthetic_mnist()
    model = MnistCNN(device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=args.lr * size)
    grads = []
    with deterministic_convolutions():
        for r in range(size):
            xs, ys = x[r::size], y[r::size]
            idx = np.random.RandomState(0).permutation(len(xs))[:args.batch_size]
            model.zero_grad(set_to_none=True)
            softmax_xent(model(torch.from_numpy(xs[idx]).to(dev)),
                         torch.from_numpy(ys[idx]).to(dev)).backward()
            grads.append([p.grad.clone() for p in model.parameters()])
    for p, *gs in zip(model.parameters(), *grads):
        p.grad = sum(gs) / size
    opt.step()
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def phase_mnist_multi() -> dict:
    """With two cards: ``train_mnist`` on two NCCL ranks, one step and then
    one epoch: replicas bitwise, the step-1 parameters within 1e-5 of
    ``mnist_control``, the loss falls. Both sides run cuDNN's deterministic
    algorithms without TF32 (``full_precision_products``): with TF32 on one
    side, Adam's first step moves the coordinates whose two shard gradients
    nearly cancel by ±lr on either side (four H100s: 0.004, 2 lr · 2)."""
    cards = torch.cuda.device_count()
    if cards < MNIST_CARDS:
        emit({"phase": "mnist_multi", "cards": cards,
              "result": f"not measured: needs {MNIST_CARDS} cards"})
        return {"launches": "not measured"}
    full_precision_products()
    want = mnist_control(MNIST_CARDS)
    ranks = spawn_cards(mnist_rank, MNIST_CARDS)
    step1_err = max(float(np.abs(r["step1_params"][k] - w).max())
                    for r in ranks for k, w in want.items())
    step1_bitwise = all(np.array_equal(r["step1_params"][k], w)
                        for r in ranks for k, w in want.items())
    rec = {"phase": "mnist_multi", "cards": cards, "world": MNIST_CARDS,
           "step1_max_abs_err_vs_control": step1_err, "step1_bitwise_control": step1_bitwise,
           "ranks": [{k: v for k, v in r.items() if k != "step1_params"} for r in ranks]}
    emit(rec)
    if step1_err > MNIST_STEP1_ATOL:
        raise AssertionError(f"mnist_multi: step-1 parameters {step1_err} off the control")
    if not all(r["replicas_bitwise"] for r in ranks):
        raise AssertionError("mnist_multi: replicas differ")
    return {"launches": ranks[0]["launches"]}


def phase_adasum_combine(dev) -> dict:
    """Adasum's pair combination as the default runs it (``ops/adasum.py``
    ``_combine`` with each gradient's range apart) on this card, at GPT-2
    1.3B's 293 gradients, 5.67 GB of f32 a side (seeded normals, b = 0.5 a
    + noise, so the projections matter): ADASUM_TENSORS' ranges against the
    same combination in f64 numpy, by ``adasum_1p3b_multi``'s rule; its
    time beside the one-vector combination's and the bound of reading both
    sides and writing the result once."""
    import dataclasses

    from horovod_tpu_torch.models.transformer import GPT2_CONFIGS, TransformerLM
    from horovod_tpu_torch.ops.adasum import _combine

    layout = [(n, p.numel()) for n, p in TransformerLM(
        dataclasses.replace(GPT2_CONFIGS[PP_MODEL], attn_impl="flash"),
        device="meta").named_parameters()]
    sizes = [k for _, k in layout]
    total = sum(sizes)
    gen = torch.Generator(device=dev).manual_seed(7)
    a = torch.randn(total, generator=gen, device=dev)
    b = torch.randn(total, generator=gen, device=dev).mul_(0.5).add_(a, alpha=0.5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = _combine(a, b, sizes)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    checks, offsets = {}, dict(zip((n for n, _ in layout), np.cumsum([0] + sizes[:-1])))
    sizes_by = dict(layout)
    for n in ADASUM_TENSORS:
        lo, k = int(offsets[n]), sizes_by[n]
        x, y = (t[lo: lo + k].cpu().numpy().astype(np.float64) for t in (a, b))
        dot, na, nb = float(x @ y), float(x @ x), float(y @ y)
        want = (1 - dot / (2 * na)) * x + (1 - dot / (2 * nb)) * y
        err = np.abs(got[lo: lo + k].cpu().numpy().astype(np.float64) - want)
        scale = float(np.abs(want).max())
        checks[n] = {"numel": k, "max_abs_err": float(err.max()), "max_abs": scale,
                     "rel_norm_err": float(np.linalg.norm(err) / np.linalg.norm(want)),
                     "within_tolerance": bool(
                         (err <= ADASUM_RTOL * np.abs(want) + ADASUM_ATOL * scale).all())}
    del got
    ms = time_ms(lambda: _combine(a, b, sizes), 5, warmup=1)
    ms_one = time_ms(lambda: _combine(a, b), 5, warmup=1)
    # Reading both sides and writing the result, f32; its ~9 operations an
    # element take 0.19 ms even at f32's 67 TFLOP/s.
    bound_ms, bound_by = 3 * 4 * total / PEAK_BYTES * 1e3, "bytes"
    rec = {"phase": "adasum_combine", "model": PP_MODEL, "tensors": len(sizes),
           "elements": total, "per_tensor_ms": ms, "one_vector_ms": ms_one,
           "bound_ms": bound_ms, "bound_by": bound_by, "peak_mem_gb": peak,
           "checks": checks}
    emit(rec)
    del a, b
    torch.cuda.empty_cache()
    bad = [n for n, c in checks.items() if not c["within_tolerance"]]
    if bad:
        raise AssertionError(f"adasum_combine: {bad} off the f64 combination: {checks}")
    return rec


def adasum_rank(rank: int, size: int, init_file: str, queue, tmp) -> None:
    """One spawned NCCL rank of ``adasum_1p3b_multi``: GPT-2 1.3B over
    dp=size, B=8 a card, remat, (a2) the mean after backward and then
    ``DistributedOptimizer(AdamW, op=Adasum)`` at its defaults. Under
    Adasum each rank writes the raw step-1 gradients of ADASUM_TENSORS
    under ``tmp``, and rank 0 the combined ones."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        try:
            mesh = full_mesh({"dp": size})

            def capture(model, opt):
                named = dict(model.named_parameters())
                reduce, inner_step, done = opt._reduce, opt._inner.step, set()

                def save(kind):
                    if kind not in done:
                        done.add(kind)
                        for n in ADASUM_TENSORS:
                            torch.save(named[n].grad.detach().float().cpu(),
                                       f"{tmp}/{kind}_{n}.pt")

                def reduce_first():
                    save(f"raw{rank}")
                    return reduce()

                def step(*a, **kw):
                    if rank == 0:
                        save("combined")
                    return inner_step(*a, **kw)

                opt._reduce, opt._inner.step = reduce_first, step

            recs = {}
            for name, kw in (("a2_mean_after_backward", {"_schedule": "buckets"}),
                             ("adasum", {"op": hvd.Adasum})):
                out = train_pp(hvd, fa, fb, mesh, False, {"remat": True}, keep_grads=False,
                               batch=(PP_B * size, PP_S), opt_kw=kw,
                               setup=capture if name == "adasum" else None)
                rec, model = out["rec"], out["model"]
                check_launches(name, rec, flash_launches(model.cfg.n_layers, remat=True))
                rec["replicas_bitwise"] = replicas_bitwise(hvd, model, mesh)
                if not all(rec["replicas_bitwise"].values()):
                    raise AssertionError(f"{name}: replicas differ: {rec['replicas_bitwise']}")
                rec["tokens_per_s_per_card"] = PP_B * PP_S / (rec["median_step_ms_2_to_5"]
                                                              / 1e3)
                recs[name] = rec
                del out, model
                gc.collect()
                torch.cuda.empty_cache()
            hvd.barrier()
            queue.put((rank, recs))
        finally:
            hvd.shutdown()
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_adasum_1p3b_multi() -> dict:
    """With four cards: GPT-2 1.3B (flash, remat, bf16 logits) at B=8 a card
    over dp=4, beside (a2) the mean after backward at the same shape, under
    ``DistributedOptimizer(AdamW, op=Adasum)`` at its defaults: 48/24/24
    launches a step, replicas bitwise, and the step-1 combined gradient of
    ADASUM_TENSORS against ``adasum_numpy`` (f64) of the four ranks' raw
    gradients, each tensor apart: |got - want| <= 1e-4 |want| + 1e-5
    max|want| elementwise."""
    import functools
    import tempfile

    from horovod_tpu_torch.ops.adasum import adasum_numpy

    cards = torch.cuda.device_count()
    if cards < ADASUM_CARDS:
        emit({"phase": "adasum_1p3b_multi", "cards": cards,
              "result": f"not measured: needs {ADASUM_CARDS} cards"})
        return {"launches": "not measured"}
    checks, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(adasum_rank, tmp=tmp), ADASUM_CARDS,
                            timeout=1200)
        for n in ADASUM_TENSORS:
            raw = [torch.load(f"{tmp}/raw{r}_{n}.pt").numpy() for r in range(ADASUM_CARDS)]
            want = adasum_numpy(raw)[0].astype(np.float64)
            got = torch.load(f"{tmp}/combined_{n}.pt").numpy().astype(np.float64)
            scale = float(np.abs(want).max())
            excess = np.abs(got - want) - (ADASUM_RTOL * np.abs(want) + ADASUM_ATOL * scale)
            checks[n] = {"numel": int(want.size), "max_abs": scale,
                         "max_abs_err": float(np.abs(got - want).max()),
                         "rel_norm_err": float(np.linalg.norm(got - want)
                                               / np.linalg.norm(want)),
                         "mean_rel_norm_err": float(np.linalg.norm(got - np.mean(raw, 0))
                                                    / np.linalg.norm(want)),
                         "within_tolerance": bool(excess.max() <= 0)}
            if not checks[n]["within_tolerance"]:
                failed.append(f"{n}: combined step-1 gradient off adasum_numpy by "
                              f"{checks[n]['max_abs_err']}")
            del raw, want, got, excess
    rec = {"phase": "adasum_1p3b_multi", "cards": cards, "batch_per_card": PP_B, "seq": PP_S,
           "step1_vs_adasum_numpy": checks, "variants": {}}
    for name in ranks[0]:
        rec["variants"][name] = {
            "rank0": ranks[0][name],
            "median_step_ms_by_rank": [r[name]["median_step_ms_2_to_5"] for r in ranks],
            "peak_mem_gb_by_rank": [r[name]["peak_mem_gb"] for r in ranks],
            "tokens_per_s_per_card": PP_B * PP_S / (
                max(r[name]["median_step_ms_2_to_5"] for r in ranks) / 1e3)}
    emit(rec)
    if failed:
        raise AssertionError("; ".join(failed))
    return {"launches": ranks[0]["adasum"]["launches"]}


# ---------------------------------------------------------------------------
# The eager engine: every world collective negotiated by name
ENGINE_CARDS = 4
ENGINE_LAT_BYTES = (4096, COLL_BYTES)       # the eager all-reduce's two sizes
ENGINE_LAT_ITERS = 20
ENGINE_STEADY = 5                           # passes of the steady-state tensor
ENGINE_STALL_S = 5.0                        # (e4): rank 1 holds one gradient back
ENGINE_STALL_CHECK_S = "2"
ENGINE_JOINER = 3                           # (e3): the rank that joins after 2 steps
ENGINE_DTOH_LIMIT = 1 << 16                 # bytes a step may copy to the host (the loss)
# (e1)'s 5 losses against the overlapped optimizer at the default fusion:
# the two sum the gradients in other orders (other fused buffers), and at
# the 1.3B that order alone moved step 4's loss by 1.6e-5 relative on an
# H100 (PERF.md §6, the engine); the exact check is the unfused pair, bitwise.
ENGINE_LOSS_RTOL = 1e-4


def engine_latency(hvd, dev) -> dict:
    """CUDA-event ms of one eager SUM all-reduce of 4 KB and of COLL_BYTES
    (bf16) through the engine (``hvd.allreduce``, a named tensor: the
    response cache serves it after the first) and through the direct path
    (``ops._allreduce`` on the default group), in turns engine, direct,
    direct, engine."""
    from horovod_tpu_torch import ops

    out = {}
    for nbytes in ENGINE_LAT_BYTES:
        x = torch.ones(nbytes // 2, dtype=torch.bfloat16, device=dev)
        calls = {"engine": lambda: hvd.allreduce(x, op=hvd.Sum, name=f"latency.{nbytes}"),
                 "direct": lambda: ops._allreduce(x, hvd.ReduceOp.SUM)}
        turns = {"engine": [], "direct": []}
        for which in ("engine", "direct", "direct", "engine"):
            turns[which].append(time_ms(calls[which], ENGINE_LAT_ITERS))
        out[str(nbytes)] = {**{f"{k}_ms": statistics.mean(v) for k, v in turns.items()},
                            **{f"{k}_ms_turns": v for k, v in turns.items()}}
        del x
    return out


def timeline_lanes(path: str, tids: dict) -> dict:
    """Each tensor's event names in a HOROVOD_TIMELINE file, by its name."""
    from horovod_tpu_torch.utils import chrome_trace

    by_tid = {}
    for ev in chrome_trace.trace_events(chrome_trace.read_trace_file(path)):
        if ev.get("ph") in ("B", "i") and "name" in ev:
            by_tid.setdefault(ev.get("tid"), set()).add(ev["name"])
    return {name: by_tid.get(tid, set()) for name, tid in tids.items()}


def engine_one_rank(rank: int, size: int, init_file: str, queue, tmp) -> None:
    """The spawned one-card world of phase ``engine``, with HOROVOD_TIMELINE:
    a steady named all-reduce, a fused group, an allgather and a broadcast
    through the engine, ``join``; the timeline's lanes after shutdown."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    os.environ["HOROVOD_TIMELINE"] = f"{tmp}/timeline.json"
    try:
        import horovod_tpu_torch as hvd

        hvd.init(init_method=f"file://{init_file}")
        dev = hvd.device()
        x = torch.arange(1024, dtype=torch.float32, device=dev)
        for _ in range(ENGINE_STEADY):
            if not torch.equal(hvd.allreduce(x, name="steady", op=hvd.Sum), x):
                raise AssertionError("engine: steady all-reduce")
        group = hvd.grouped_allreduce([x, x[:7], x[:100]], name="group", op=hvd.Sum)
        if not all(torch.equal(g, x[:g.numel()]) for g in group):
            raise AssertionError("engine: grouped all-reduce")
        hvd.allgather(x, name="gather")
        hvd.broadcast(x, 0, name="bcast")
        last = hvd.join()
        eng = hvd.common.basics.engine()
        counters, tids = eng.counters(), dict(eng.timeline._tids)
        hvd.shutdown()
        lanes = timeline_lanes(f"{tmp}/timeline.json", tids)
        queue.put((rank, {"join": last, "counters": counters,
                          "lanes": {k: sorted(v) for k, v in lanes.items()}}))
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_engine(dev) -> dict:
    """On one card, through the eager engine (a world of one: the local ops,
    no process group): every world collective against its closed form in
    f32, bf16, uint8 and bool (the engine's response count must move by at
    least one a check it routes: all but reducescatter); ``join()`` returns 0; a steady named tensor is
    served by the response cache from its second pass; the eager latency of
    a 4 KB and a COLL_BYTES all-reduce against the direct path, in turns.
    A spawned one-card world with HOROVOD_TIMELINE: the file loads as JSON
    with NEGOTIATE_ALLREDUCE, ALLREDUCE and LOCAL_ALLREDUCE on the steady
    tensor's lane, MEMCPY_IN_FUSION_BUFFER and MEMCPY_OUT_FUSION_BUFFER on
    the fused group's first tensor."""
    import functools
    import tempfile

    import horovod_tpu_torch as hvd

    eng = hvd.common.basics.engine()
    before = eng.counters()
    checked = _closed_form_checks(hvd, dev)
    moved = eng.counters()["responses"] - before["responses"]
    # reducescatter runs directly; the object collectives send nothing at
    # a world of one.
    routed = [c for c in checked if not c.startswith("reducescatter")
              and not (c.endswith("_object") and hvd.size() == 1)]
    if moved < len(routed):
        raise AssertionError(f"engine: {moved} responses for {len(routed)} checks")
    if hvd.join() != hvd.size() - 1:
        raise AssertionError("engine: join() is not the last rank")
    x = torch.ones(16, device=dev)
    before = eng.counters()
    for _ in range(ENGINE_STEADY):
        hvd.allreduce(x, name="engine.steady")
    hits = eng.counters()["cache_hits"] - before["cache_hits"]
    if hits < ENGINE_STEADY - 1:
        raise AssertionError(f"engine: {hits} cache hits in {ENGINE_STEADY} steady passes")
    latency = engine_latency(hvd, dev)
    with tempfile.TemporaryDirectory() as tmp:
        child = spawn_cards(functools.partial(engine_one_rank, tmp=tmp), 1)[0]
    lanes = child["lanes"]
    want = {"allreduce.steady": {"NEGOTIATE_ALLREDUCE", "ALLREDUCE", "LOCAL_ALLREDUCE"},
            "allreduce.group.0": {"NEGOTIATE_ALLREDUCE", "ALLREDUCE",
                                  "MEMCPY_IN_FUSION_BUFFER", "MEMCPY_OUT_FUSION_BUFFER"},
            "allgather.gather": {"NEGOTIATE_ALLGATHER", "ALLGATHER", "LOCAL_ALLGATHER"},
            "broadcast.bcast": {"NEGOTIATE_BROADCAST", "BROADCAST", "LOCAL_BROADCAST"}}
    for name, names in want.items():
        if not names <= set(lanes.get(name, ())):
            raise AssertionError(f"engine: timeline lane {name} has {lanes.get(name)}")
    if child["join"] != 0 or child["counters"]["cache_hits"] < ENGINE_STEADY - 1:
        raise AssertionError(f"engine: one-card world {child}")
    rec = {"phase": "engine", "world": hvd.size(), "checked": sorted(checked),
           "responses_for_checks": moved, "steady_cache_hits": hits,
           "latency_ms": latency, "timeline_world": child}
    emit(rec)
    return {"launches": {}}


def engine_step(hvd, model, opt, x, takes_det: bool, before_sync=None):
    """One step of the binding's optimizer: forward, ``lm_loss``, backward
    (the hooks enqueue each gradient by name), ``before_sync(model)`` where
    given, ``opt.step()``; the loss averaged through the engine."""
    from horovod_tpu_torch.parallel.train import lm_loss

    model.train()
    opt.zero_grad()
    logits = model(x, deterministic=True) if takes_det else model(x)
    loss = lm_loss(logits, x)
    loss.backward()
    if before_sync is not None:
        before_sync(model)
    opt.step()
    return hvd.allreduce(loss.detach(), name="loss")


def engine_model(hvd, mesh):
    """GPT-2 1.3B (flash, remat) under the binding's ``DistributedOptimizer``
    (AdamW 1e-4, wd 1e-4, eps 1e-8, ``named_parameters``), its parameters
    broadcast from rank 0 through the engine; this rank's batch."""
    import inspect

    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.parallel.train import _cut

    model = gpt2_1p3b(mesh, False, seq=PP_S, remat=True)
    inner = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    opt = hvd_torch.DistributedOptimizer(inner, named_parameters=model.named_parameters())
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
    x = _cut(pp_ids(PP_B * hvd.size(), PP_S), mesh, False).to(mesh.device)
    takes_det = "deterministic" in inspect.signature(model.forward).parameters
    return model, opt, x, takes_det


def train_engine(hvd, fa, mesh, steps: int = STEPS, keep_grads: bool = False,
                 fusion_threshold=None) -> dict:
    """``steps`` engine steps of ``engine_model``: losses, step ms, the
    engine's counters over steps 2 on (cycles, negotiations, responses,
    fused responses, tensors, bytes, cache hits), peak GB, flash launches;
    with ``keep_grads`` the step-1 raw and reduced gradients and Σ_r|g_r|
    (through the engine) by name in host memory. ``fusion_threshold``, where
    given, is the coordinator's for the run (0: every response one tensor)."""
    model, opt, x, takes_det = engine_model(hvd, mesh)
    eng = hvd.common.basics.engine()
    saved = eng.controller.fusion_threshold
    if fusion_threshold is not None:
        eng.controller.fusion_threshold = fusion_threshold
    got = {}

    def capture(m):
        got["raw"] = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
        got["abs_sum"] = {n: hvd.allreduce(p.grad.detach().abs(), op=hvd.Sum,
                                           name=f"abs.{n}").cpu()
                          for n, p in m.named_parameters()}
        opt.synchronize()
        got["reduced"] = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_ms, counters = [], [], None
    for i in range(steps):
        if i == 1:
            counters = eng.counters()
        t0 = time.perf_counter()
        if i == 0 and keep_grads:
            loss = engine_step(hvd, model, opt, x, takes_det, capture)
        else:
            loss = engine_step(hvd, model, opt, x, takes_det)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    eng.controller.fusion_threshold = saved
    after = eng.counters()
    launches = fa.launches()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"engine: non-finite losses {losses}")
    delta = {k: after[k] - counters[k] for k in after} if counters else after
    rec = {"losses": losses, "step_ms": step_ms,
           "median_step_ms_2_to_5": statistics.median(step_ms[1:]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "engine_steps_2_on": delta,
           "per_step_2_on": {k: v / max(steps - 1, 1) for k, v in delta.items()},
           "bytes_per_response": delta["bytes"] / max(delta["responses"], 1),
           "gradients": sum(1 for _ in model.parameters())}
    return {"rec": rec, "model": model, "opt": opt, "x": x, "takes_det": takes_det,
            "grads": got}


def grads_within(got: dict, want: dict, abs_sum: dict, world: int) -> dict:
    """Every tensor of ``got`` within ``grad_order_bound`` of ``want``; the
    largest error over its bound, and the largest absolute error."""
    worst, worst_abs = 0.0, 0.0
    for n, w in want.items():
        g, a = got[n].float(), abs_sum[n].float()
        err = (g - w.float()).abs()
        bound = grad_order_bound(a, world, w.dtype)
        over = err - bound
        if float(over.max()) > 0:
            raise AssertionError(f"engine: {n} off by {float(err.max())}, above the "
                                 f"rounding bound of two orders")
        nz = bound > 0
        if bool(nz.any()):
            worst = max(worst, float((err[nz] / bound[nz]).max()))
        worst_abs = max(worst_abs, float(err.max()))
    return {"max_err_over_bound": worst, "max_abs_err": worst_abs}


def dtoh_bytes_of_step(hvd, run, tmp: str, rank: int) -> dict:
    """One engine step under ``torch.profiler``: the device-to-host copies
    it made (count, bytes) and its kernels, from the exported trace."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.utils import chrome_trace

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine_step(hvd, run["model"], run["opt"], run["x"], run["takes_det"])
        torch.cuda.synchronize()
    path = f"{tmp}/engine_step_rank{rank}.json"
    prof.export_chrome_trace(path)
    events = chrome_trace.trace_events(chrome_trace.read_trace_file(path))
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]

    def total(kind):
        moved = [e for e in copies if kind in e.get("name", "")]
        return len(moved), sum(int(e.get("args", {}).get("bytes", 0)) for e in moved)

    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [e for e in kernels if "nccl" in e.get("name", "").lower()]
    (dtoh, dtoh_bytes), (dtod, dtod_bytes) = total("DtoH"), total("DtoD")
    return {"dtoh_copies": dtoh, "dtoh_bytes": dtoh_bytes, "dtod_copies": dtod,
            "dtod_bytes": dtod_bytes, "kernels": len(kernels), "nccl_kernels": len(nccl)}


def engine_multi_rank(rank: int, size: int, init_file: str, queue, tmp) -> None:
    """One spawned NCCL rank of ``engine_multi``. World A: (c) the top-level
    overlapped ``DistributedOptimizer`` through ``train_pp`` and (e1) the
    binding's through the engine, 5 steps each from seed 0 on the same
    batches, then one profiled engine step, (e2) the step-1 raw gradients
    all-reduced again by name in a rank-rotated order, the latency turns,
    (c0)/(e1) unfused on both sides (bitwise), and (e1)/(c) again for the
    step time in turns. World B (HOROVOD_TIMELINE
    on rank 0, HOROVOD_STALL_CHECK_TIME_SECONDS=2): (e3) the joiner takes 2
    steps and joins, the others 3; (e4) rank 1 holds one gradient back for
    ENGINE_STALL_S; (e5) rank 0's timeline."""
    import logging
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.ops import fused_bn_conv as fb
        from horovod_tpu_torch.utils.logging import get_logger

        full_precision_products()
        out = {}
        hvd.init(init_method=f"file://{init_file}")
        try:
            mesh = full_mesh({"dp": size})
            dev = mesh.device
            # (c), then (e1), at the default fusion.
            ctrl = train_pp(hvd, fa, fb, mesh, False, {"remat": True}, keep_grads=True,
                            batch=(PP_B * size, PP_S))
            out["c_overlapped"] = ctrl["rec"]
            want = ctrl["grads"]
            del ctrl
            gc.collect()
            torch.cuda.empty_cache()
            run = train_engine(hvd, fa, mesh, keep_grads=True)
            rec = run["rec"]
            check_launches("engine e1", rec, flash_launches(24, remat=True))
            got = run["grads"]
            rec["step1_vs_overlapped"] = grads_within(got["reduced"], want, got["abs_sum"],
                                                      size)
            rec["max_loss_rel_err_vs_overlapped"] = max(
                abs(a - b) / abs(b) for a, b in zip(rec["losses"], out["c_overlapped"]["losses"]))
            if rec["max_loss_rel_err_vs_overlapped"] > ENGINE_LOSS_RTOL:
                raise AssertionError(f"engine e1: losses {rec['losses']} vs "
                                     f"{out['c_overlapped']['losses']}")
            rec["replicas_bitwise"] = replicas_bitwise(hvd, run["model"], mesh)
            if not all(rec["replicas_bitwise"].values()):
                raise AssertionError(f"engine e1: replicas differ {rec['replicas_bitwise']}")
            rec["profiled_step"] = dtoh_bytes_of_step(hvd, run, tmp, rank)
            if rec["profiled_step"]["nccl_kernels"] == 0:
                raise AssertionError(f"engine e1: the profiler saw no NCCL kernel "
                                     f"{rec['profiled_step']}")
            if rec["profiled_step"]["dtoh_bytes"] > ENGINE_DTOH_LIMIT:
                raise AssertionError(f"engine e1: device-to-host copies in a step "
                                     f"{rec['profiled_step']}")
            out["e1_engine"] = rec
            # (e2): the raw step-1 gradients again, each rank in its own order.
            import horovod_tpu_torch.torch as hvd_torch

            names = [n for n, _ in run["model"].named_parameters()]
            k = rank * len(names) // size
            order = names[k:] + names[:k]
            handles = {n: hvd_torch.allreduce_async(got["raw"][n].to(dev), name=f"grad.{n}")
                       for n in order}
            perm = {n: hvd_torch.synchronize(handles[n]).cpu() for n in names}
            out["e2_permuted"] = {"first": order[0],
                                  **grads_within(perm, got["reduced"], got["abs_sum"], size)}
            del perm, handles, got, want
            out["latency_ms"] = engine_latency(hvd, dev)
            del run
            gc.collect()
            torch.cuda.empty_cache()
            # (e1) unfused on both sides: one gradient a bucket and a
            # response, so both sum each gradient in NCCL's one order.
            ctrl = train_pp(hvd, fa, fb, mesh, False, {"remat": True}, keep_grads=True,
                            batch=(PP_B * size, PP_S), opt_kw={"fuse": False})
            out["c0_overlapped_unfused"] = ctrl["rec"]
            want = ctrl["grads"]
            del ctrl
            gc.collect()
            torch.cuda.empty_cache()
            run = train_engine(hvd, fa, mesh, keep_grads=True, fusion_threshold=0)
            rec = run["rec"]
            got = run["grads"]["reduced"]
            rec["step1_bitwise"] = all(torch.equal(got[n], want[n]) for n in want)
            rec["losses_bitwise"] = rec["losses"] == out["c0_overlapped_unfused"]["losses"]
            if not (rec["step1_bitwise"] and rec["losses_bitwise"]):
                raise AssertionError(
                    f"engine e1 unfused: step-1 gradients bitwise {rec['step1_bitwise']}, "
                    f"losses {rec['losses']} vs {out['c0_overlapped_unfused']['losses']}")
            out["e1_engine_unfused"] = rec
            del run, got, want
            gc.collect()
            torch.cuda.empty_cache()
            # The step time in turns: (c), (e1) above; (e1), (c) again.
            again = train_engine(hvd, fa, mesh)
            out["e1_engine_again"] = again["rec"]
            del again
            gc.collect()
            torch.cuda.empty_cache()
            ctrl = train_pp(hvd, fa, fb, mesh, False, {"remat": True}, keep_grads=False,
                            batch=(PP_B * size, PP_S))
            out["c_overlapped_again"] = ctrl["rec"]
            del ctrl
            gc.collect()
            torch.cuda.empty_cache()
            hvd.barrier()
        finally:
            hvd.shutdown()

        # World B.
        os.environ["HOROVOD_STALL_CHECK_TIME_SECONDS"] = ENGINE_STALL_CHECK_S
        if rank == 0:
            os.environ["HOROVOD_TIMELINE"] = f"{tmp}/timeline.json"
        hvd.init(init_method=f"file://{init_file}.b")
        try:
            import torch.distributed as dist

            mesh = full_mesh({"dp": size})
            others = dist.new_group([r for r in range(size) if r != ENGINE_JOINER])
            model, opt, x, takes_det = engine_model(hvd, mesh)
            rec = {}

            def check_join_step(m):
                raw = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
                opt.synchronize()
                worst = 0.0
                for n, p in m.named_parameters():
                    want = raw[n].clone()
                    dist.all_reduce(want, group=others)
                    abs_sum = raw[n].abs()
                    dist.all_reduce(abs_sum, group=others)
                    err = (p.grad - want * 0.25).abs()
                    bound = grad_order_bound(abs_sum, size, want.dtype)
                    if float((err - bound).max()) > 0:
                        raise AssertionError(f"engine e3: {n} is not the three ranks' sum / 4")
                    worst = max(worst, float(err.max()))
                rec["step3_max_abs_err_vs_sum_of_three_over_4"] = worst

            steps = 2 if rank == ENGINE_JOINER else 3
            for i in range(steps):
                if i == 2:
                    engine_step(hvd, model, opt, x, takes_det, check_join_step)
                else:
                    engine_step(hvd, model, opt, x, takes_det)
            rec["join"] = hvd.join()
            if rec["join"] != ENGINE_JOINER:
                raise AssertionError(f"engine e3: join() returned {rec['join']}")
            out["e3_join"] = rec
            # (e4): rank 1 holds one gradient back.
            held = "ln_f.weight" if "ln_f.weight" in dict(model.named_parameters()) \
                else next(n for n, _ in model.named_parameters())
            warnings = []

            class Keep(logging.Handler):
                def emit(self, record):
                    warnings.append(record.getMessage())

            keep = Keep(level=logging.WARNING)
            get_logger().addHandler(keep)
            if rank == 1:
                launch = opt._allreduce_grad_async

                def late(p):
                    if opt._names[p] == held:
                        time.sleep(ENGINE_STALL_S)
                    return launch(p)

                opt._allreduce_grad_async = late
            t0 = time.perf_counter()
            loss = float(engine_step(hvd, model, opt, x, takes_det))
            torch.cuda.synchronize()
            get_logger().removeHandler(keep)
            stalled = [w for w in warnings if f"allreduce.grad.{held}" in w]
            out["e4_stall"] = {"held": f"allreduce.grad.{held}", "step_s": time.perf_counter() - t0,
                               "loss": loss, "warnings": stalled[:2]}
            if rank == 0 and not any("[missing ranks: [1]]" in w for w in stalled):
                raise AssertionError(f"engine e4: no stall warning for {held}: {warnings}")
            if not math.isfinite(loss):
                raise AssertionError("engine e4: the step did not complete")
            eng = hvd.common.basics.engine()
            tids = dict(eng.timeline._tids)
            fused = eng.counters()["fused_responses"]
            grads = [f"allreduce.grad.{n}" for n, _ in model.named_parameters()]
            hvd.barrier()
        finally:
            hvd.shutdown()
        if rank == 0:
            lanes = timeline_lanes(f"{tmp}/timeline.json", tids)
            missing = [g for g in grads
                       if not {"NEGOTIATE_ALLREDUCE", "ALLREDUCE"} <= lanes.get(g, set())]
            memcpy = sorted(g for g in grads if "MEMCPY_IN_FUSION_BUFFER" in lanes.get(g, ()))
            out["e5_timeline"] = {"gradients": len(grads), "missing": missing,
                                  "memcpy_in_lanes": len(memcpy), "fused_responses": fused,
                                  "nccl_lanes": sum("NCCL_ALLREDUCE" in lanes.get(g, ())
                                                    for g in grads)}
            if missing or (fused and not memcpy):
                raise AssertionError(f"engine e5: timeline {out['e5_timeline']}")
        queue.put((rank, out))
    except Exception:  # report to the parent instead of leaving it waiting
        queue.put((rank, traceback.format_exc()))


def phase_engine_multi() -> dict:
    """With four cards: GPT-2 1.3B (flash, remat, bf16 logits) at B=8 a card
    over dp=4, every gradient reduced by name through the eager engine on
    NCCL by the binding's hook ``DistributedOptimizer`` (``engine_multi_rank``).
    Gates: (e1) the step-1 reduced gradients within ``grad_order_bound`` of
    the top-level overlapped optimizer's on the same batches, the 5 losses
    within ENGINE_LOSS_RTOL, and, with fusion off on both sides (one
    gradient a bucket and a response: one summation order), the step-1
    gradients and the 5 losses bitwise; the replicas bitwise after step 5,
    48/24/24 flash launches a step, no device-to-host copy past the loss in
    a profiled step; (e2) rank-rotated submission within the same bound; (e3)
    the step-3 gradients of ranks 0-2 their sum over 4 after rank 3 joined,
    ``join()`` 3 everywhere; (e4) the stall warning names the held tensor and
    rank 1, and the step completes; (e5) every gradient's lane in rank 0's
    timeline has NEGOTIATE_ALLREDUCE and ALLREDUCE, and MEMCPY_IN_FUSION_BUFFER
    where responses fused (on a fused response's first tensor, the JAX
    package's layout)."""
    import functools
    import tempfile

    cards = torch.cuda.device_count()
    if cards < ENGINE_CARDS:
        emit({"phase": "engine_multi", "cards": cards,
              "result": f"not measured: needs {ENGINE_CARDS} cards"})
        return {"launches": "not measured"}
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_cards(functools.partial(engine_multi_rank, tmp=tmp), ENGINE_CARDS,
                            timeout=1500)
    rec = {"phase": "engine_multi", "cards": cards, "batch_per_card": PP_B, "seq": PP_S,
           "rank0": ranks[0],
           "by_rank": {k: [r[k].get("median_step_ms_2_to_5") for r in ranks]
                       for k in ("c_overlapped", "e1_engine", "e1_engine_again",
                                 "c_overlapped_again", "c0_overlapped_unfused",
                                 "e1_engine_unfused")},
           "peak_mem_gb_by_rank": [r["e1_engine"]["peak_mem_gb"] for r in ranks],
           "e2_by_rank": [r["e2_permuted"] for r in ranks],
           "e3_by_rank": [r["e3_join"] for r in ranks],
           "e4_by_rank": [r["e4_stall"] for r in ranks]}
    emit(rec)
    return {"launches": ranks[0]["e1_engine"]["launches"]}


# ---------------------------------------------------------------------------
# The launcher and elastic training: GPT-2-small on the flash kernels
# under ``@hvd.elastic.run`` with ``TorchState``, started by the port's own
# launcher (``python -m horovod_tpu_torch.runner.launch``), never by
# spawn_cards. The workers are this module's ``elastic_worker``, run from a
# three-line script that first binds a fake host ``card<i>`` to card i.
EL_MODEL = "gpt2-small"
EL_B_STEPS = 8            # (b); (c) runs EL_STEPS, set by durable_plan (8 without it)
EL_STEPS = 8
EL_RAISE_AT = 5           # (b): HorovodInternalError in step 5, after the commit of step 4
EL_MULTI_STEPS = 12
EL_KILL_STEP = 5          # elastic_multi: kill:step=5 on the last rank
EL_RETURN_AFTER = 8       # elastic_multi: the host is listed again after step 8
EL_TIMEOUT = 300          # seconds, around each launch
# The metrics plane (phases ``metrics`` and ``metrics_multi``): /metrics
# scraped after these steps; each rank's push every EL_METRICS_SYNC
# seconds; step times with the exporters on and off in EL_TURNS turns of
# EL_TURN_STEPS steps each.
EL_SCRAPE_STEPS = (2, STEPS)
EL_METRICS_SYNC = 1.0
EL_TURNS = 3
EL_TURN_STEPS = 4
EL_WORKER_SCRIPT = (
    "import os, sys\n"
    "host = os.environ.get('HOROVOD_HOSTNAME', '')\n"
    "if host.startswith('card'):\n"
    "    cards = os.environ.get('CUDA_VISIBLE_DEVICES')\n"
    "    cards = cards.split(',') if cards else None\n"
    "    i = int(host[4:])\n"
    "    os.environ['CUDA_VISIBLE_DEVICES'] = cards[i] if cards else str(i)\n"
    "sys.path.insert(0, {repo!r})\n"
    "import chip_smoke\n"
    "chip_smoke.elastic_worker()\n")


def el_batch(batch: int, rank: int, dev, vocab: int):
    """The ids of step ``batch + 1`` on ``rank``, from a generator seeded by
    (batch, rank): a replayed step sees the same data."""
    rng = np.random.RandomState(1000 * batch + rank)
    return torch.from_numpy(rng.randint(0, vocab, size=(B, S)).astype(np.int64)).to(dev)


def el_model(dev):
    """phase ``slice``'s model and seed, and AdamW under the binding's hook
    optimizer (through the engine)."""
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.models.registry import get_model

    gen = torch.Generator(device=dev).manual_seed(0)
    model = get_model(EL_MODEL).make_model(device=dev, generator=gen, attn_impl="flash",
                                           logits_dtype=torch.bfloat16, max_len=S)
    opt = hvd_torch.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8),
        named_parameters=model.named_parameters())
    return model, opt


def el_step(model, opt, ids) -> float:
    from horovod_tpu_torch.parallel.train import lm_loss

    opt.zero_grad(set_to_none=True)
    loss = lm_loss(model(ids), ids)
    loss.backward()
    opt.step()
    return float(loss.detach())


def state_checksum(model, opt) -> torch.Tensor:
    """Two int64 words a tensor (the sum of its bit patterns and of their
    squares, wrapping) over the parameters and the optimizer state, in one
    order on every rank, on the card: equal vectors for bitwise-equal
    states."""
    tensors = [t for _, t in sorted(model.state_dict().items())]
    state = opt.state_dict()["state"]
    tensors += [state[pid][key] for pid in sorted(state) for key in sorted(state[pid])
                if isinstance(state[pid][key], torch.Tensor)]
    dev = next(model.parameters()).device
    words = []
    for t in tensors:
        t = t.detach().to(dev).reshape(-1)
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
            t.element_size()]
        x = t.contiguous().view(bits).to(torch.int64)
        words += [x.sum(), (x * x).sum()]
    return torch.stack(words)


def metrics_samples(reg) -> dict:
    """A registry's series as a scrape of it reads them (no buckets)."""
    from horovod_tpu_torch.common import metrics_export

    samples = metrics_export.parse_prometheus(metrics_export.to_prometheus(reg))[0]
    return {k: v for k, v in samples.items() if "_bucket{" not in k}


def http_get(port: int, path: str) -> str:
    """A GET of the rank-0 endpoint; an exporter that did not bind fails
    the phase here."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read().decode()


def data_series(samples: dict) -> dict:
    """The engine's data-plane series (responses, tensors and bytes of
    each type and a response, the op latencies), keyed as a scrape or as a
    fleet push keys them."""
    import re

    def family(key):
        return re.sub(r"\{.*\}", "", key)

    return {k: v for k, v in samples.items() if family(k) == "horovod_responses_total"
            or family(k).endswith(("_tensors_total", "_bytes_total")) or family(k).startswith((
                "horovod_op_latency_seconds_", "horovod_response_tensors_",
                "horovod_response_bytes_"))}


def latency_due(samples: dict) -> tuple:
    """(observations of horovod_op_latency_seconds, what the executed
    responses owe it): one an all-reduce response and one an all-gather,
    broadcast or all-to-all tensor, none a barrier (the worker joins
    nothing)."""
    got = sum(v for k, v in samples.items()
              if k.startswith("horovod_op_latency_seconds_count"))
    want = samples.get("horovod_responses_total", 0) - samples.get(
        "horovod_barrier_tensors_total", 0)
    return got, want


def settle_latency(eng, timeout: float = 10.0) -> bool:
    """Wait (host sleeps, no device wait) until the background loop has
    read the timing events of every executed response; the caller has
    already waited for the card."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        got, want = latency_due(metrics_samples(eng.registry))
        if got == want:
            return True
        time.sleep(0.01)
    return False


def metrics_point(hvd, step: int, port: int) -> dict:
    """At a synchronised point (the step's commit done, the card idle):
    the engine's ``counters()`` and, read just after, rank 0's scraped
    /metrics (every other rank's own registry)."""
    from horovod_tpu_torch.common import metrics_export

    eng = hvd.common.basics.engine()
    settled = settle_latency(eng)
    counters = eng.counters()
    if hvd.rank() == 0:
        samples = metrics_export.parse_prometheus(http_get(port, "/metrics"))[0]
    else:
        samples = metrics_samples(eng.registry)
    return {"step": step, "t": time.time(), "settled": settled, "counters": counters,
            "samples": data_series(samples)}


def metrics_quiet(hvd, dev, port: int) -> dict:
    """Every rank past one last all-reduce, each reads its own
    ``hvd.metrics()`` and launch log; after three push intervals of idle
    cycles rank 0 reads its /metrics.json (the fleet view); a broadcast
    then holds every rank until it has."""
    eng = hvd.common.basics.engine()
    hvd.allreduce(torch.zeros(1, device=dev), name="metrics.quiet")
    torch.cuda.synchronize()
    settled = settle_latency(eng)
    own = hvd.metrics()
    out = {"settled": settled, "own": own["metrics"], "mode": own["mode"],
           "launch_log": eng.launch_log(), "t": time.time()}
    time.sleep(3 * EL_METRICS_SYNC)
    if hvd.rank() == 0:
        out["metrics_json"] = json.loads(http_get(port, "/metrics.json"))
        out["status"] = json.loads(http_get(port, "/status"))
    hvd.broadcast(torch.zeros(1, device=dev), 0, name="metrics.read")
    return out


def metrics_turns(hvd, model, opt, vocab: int, dev) -> dict:
    """Step ms with the exporters on (the HTTP and file exporters running,
    each rank pushing every EL_METRICS_SYNC s) and off (stopped, no push),
    in turns in this process: the registry's own counting stays on."""
    eng = hvd.common.basics.engine()
    ctrl = eng.controller
    times = {"on": [], "off": []}
    batch = 1000
    for _ in range(EL_TURNS):
        for label in ("on", "off"):
            if label == "on":
                if not eng._exporters:
                    eng.start_exporters()
                ctrl._metrics_sync_s = EL_METRICS_SYNC
            else:
                eng.stop_exporters()
                ctrl._metrics_sync_s = 0.0
            for _ in range(EL_TURN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                el_step(model, opt, el_batch(batch, hvd.rank(), dev, vocab))
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) * 1e3)
                batch += 1
    return times


def elastic_worker() -> None:
    """One worker of phases ``elastic`` and ``elastic_multi``: GPT-2-small
    under ``@hvd.elastic.run`` with ``TorchState(model, optimizer, batch=0)``,
    a commit after every step. The environment says what to do (EL_*); the
    record goes to EL_OUT/<host>.<pid>.json."""
    import faulthandler
    import os

    t_proc = time.time()
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.backend.elastic_env import spawn_identity
    from horovod_tpu_torch.common import checkpoint, drain, fault_injection
    from horovod_tpu_torch.common.exceptions import WorkerPreempted
    from horovod_tpu_torch.ops import flash_attention as fa

    # A worker still running near the launch's time limit shows where.
    faulthandler.dump_traceback_later(EL_TIMEOUT - 60)
    out_dir = os.environ["EL_OUT"]
    total = int(os.environ["EL_TOTAL"])
    raise_at = int(os.environ.get("EL_RAISE_AT", "0"))
    hosts_file = os.environ.get("EL_HOSTS_FILE")
    return_after = int(os.environ.get("EL_RETURN_AFTER", "0"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full_precision_products()
    rec = {"identity": spawn_identity(), "pid": os.getpid(), "steps": [], "syncs": [],
           "restores": [], "reinit": [], "t_proc": t_proc, "ckpt": [], "barrier_ms": [],
           "scrapes": []}
    # Phases metrics and metrics_multi: the exporters are on, and every
    # step also averages its loss over the world through the engine, as a
    # training script logs it.
    metrics_port = int(os.environ.get("HOROVOD_METRICS_PORT", "0"))
    path = os.path.join(out_dir, f"{rec['identity'].replace(':', '_')}.{os.getpid()}.json")

    def dump():
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)

    def on_exit():
        # A clean interpreter exit (a SystemExit, WorkerPreempted's code 0
        # among them); os._exit (the kill rule) skips it.
        rec["exit_at"] = time.time()
        dump()

    import atexit

    atexit.register(on_exit)
    dump()
    t0 = time.time()
    hvd.init()
    rec["init_s"] = time.time() - t0
    dev = hvd.device()
    rec["device"] = str(dev)
    model, opt = el_model(dev)
    vocab = model.cfg.vocab_size
    state = hvd.elastic.TorchState(model, opt, batch=0)
    rec["built_s"] = time.time() - t0
    rec["grads"] = sum(p.requires_grad for p in model.parameters())
    rec["grad_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters()
                            if p.requires_grad)
    rules = fault_injection.parse_spec(os.environ.get("HOROVOD_FAULT_INJECT", ""))
    kill = [r for r in rules if r.action == "kill"]
    preempt = [r for r in rules if r.action == "preempt"]
    barrier = drain.commit_barrier

    def timed_barrier(st):
        # The drain barrier's time a commit (its all-reduce past one rank).
        t = time.perf_counter()
        try:
            barrier(st)
        finally:
            rec["barrier_ms"].append((time.perf_counter() - t) * 1e3)

    drain.commit_barrier = timed_barrier

    def on_reset():
        # After the restore (or the interrupt) and the next world's init,
        # before the sync: the state as restored.
        rec["restores"].append({"batch": state.batch, "rank": hvd.rank(),
                                "size": hvd.size(), "t": time.time(),
                                "checksum": state_checksum(model, opt).tolist()})

    state.register_reset_callbacks([on_reset])
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    attempts = [0]

    @hvd.elastic.run
    def train(state):
        if hvd.elastic.resume_log and "resume" not in rec:
            # The state as restored from the checkpoint, in the checkpoint's
            # leaf order, against the manifest's shards in the harness.
            rec["resume"] = dict(hvd.elastic.resume_log[-1], batch=state.batch,
                                 digest=leaves_digest(state.checkpoint_trees()))
        # Every entry follows a sync: rank 0's checksum against ours.
        mine = state_checksum(model, opt)
        root = hvd.broadcast(mine.clone(), root_rank=0, name="el.checksum")
        rec["syncs"].append({"batch": state.batch, "rank": hvd.rank(), "size": hvd.size(),
                             "t": time.time(), "equal": bool(torch.equal(mine, root))})
        while state.batch < total:
            step = state.batch + 1
            if preempt and preempt[0].rank in (None, hvd.rank()) and "notice_at" not in rec \
                    and fault_injection.get_injector().step + 1 >= preempt[0].step:
                rec["notice_at"] = time.time()
            if kill and kill[0].rank in (None, hvd.rank()) and \
                    fault_injection.get_injector().step + 1 >= kill[0].step:
                # This worker's host goes away with it: discovery stops
                # listing it, and the kill rule ends the process.
                if hosts_file:
                    with open(hosts_file) as f:
                        lines = [ln for ln in f.read().split() if
                                 ln.split(":")[0] != rec["identity"].split(":")[0]]
                    with open(hosts_file, "w") as f:
                        f.write("\n".join(lines) + "\n")
                rec["killed_at"] = time.time()
                dump()
            fault_injection.advance_step()
            if step == raise_at and not os.path.exists(os.path.join(out_dir, "raised")):
                open(os.path.join(out_dir, "raised"), "w").close()
                rec["raised_at"] = time.time()
                raise hvd.HorovodInternalError("injected by the elastic phase")
            attempts[0] += 1
            t0 = time.perf_counter()
            loss = el_step(model, opt, el_batch(state.batch, hvd.rank(), dev, vocab))
            t1 = time.perf_counter()
            state.batch = step
            try:
                state.commit()
            except WorkerPreempted:
                rec["drained_at"] = time.time()
                rec["drained_step"] = step
                rec["drain_s"] = drain.coordinator.seconds_since_notice()
                dump()
                raise
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rec["steps"].append({"step": step, "rank": hvd.rank(), "size": hvd.size(),
                                 "loss": loss, "ms": (t1 - t0) * 1e3,
                                 "commit_ms": (t2 - t1) * 1e3, "t": time.time()})
            if metrics_port:
                rec["steps"][-1]["mean_loss"] = float(hvd.allreduce(
                    torch.tensor([loss], device=dev), name="loss", op=hvd.Average))
                if step in EL_SCRAPE_STEPS:
                    torch.cuda.synchronize()
                    rec["scrapes"].append(metrics_point(hvd, step, metrics_port))
            mgr = checkpoint.current()
            if mgr is not None:
                st = mgr.status()
                rec["ckpt"].append({"step": step, "pending": st["pending_step"],
                                    "write_s": st["last_write_s"],
                                    "commit_s": st["last_commit_s"],
                                    "writes": st["writes"], "skipped": st["skipped"],
                                    "bytes": st["bytes"], "commits": st["commits"],
                                    "allocated": torch.cuda.memory_allocated()})
            if step == EL_RAISE_AT - 1 or step == EL_KILL_STEP - 1:
                rec[f"commit{step}"] = state_checksum(model, opt).tolist()
            if step == int(os.environ.get("EL_MARK", "0")):
                rec["mark"] = state_checksum(model, opt).tolist()
            if step == return_after and hosts_file and "returned_at" not in rec \
                    and hvd.size() < int(os.environ["EL_CARDS"]):
                if hvd.rank() == 0:
                    # The host comes back; wait for the driver's notification,
                    # so the next commit resets every rank to the new world.
                    with open(hosts_file, "w") as f:
                        f.write("".join(f"card{i}:1\n"
                                        for i in range(int(os.environ["EL_CARDS"]))))
                    rec["returned_at"] = time.time()
                    t0 = time.time()
                    while not state._host_messages and time.time() - t0 < 120:
                        time.sleep(0.05)
                rec["returned_at"] = rec.get("returned_at", time.time())
                state.commit()
            dump()
        return state.batch

    train(state)
    torch.cuda.synchronize()
    rec["final"] = state_checksum(model, opt).tolist()
    rec["final_batch"] = state.batch
    rec["final_rank"], rec["final_size"] = hvd.rank(), hvd.size()
    rec["attempts"] = attempts[0]
    rec["launches"] = fa.launches()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["saved_gb"] = state.saved_bytes("cuda") / 1e9
    rec["reset_log"] = list(hvd.elastic.reset_log)
    if metrics_port:
        rec["quiet"] = metrics_quiet(hvd, dev, metrics_port)
        rec["turns_ms"] = metrics_turns(hvd, model, opt, vocab, dev)
    rec["done"] = True
    dump()
    hvd.shutdown()


def read_records(out: str) -> dict:
    import os

    recs = {}
    for fn in sorted(os.listdir(out)):
        if fn.endswith(".json"):
            with open(os.path.join(out, fn)) as f:
                recs[fn] = json.load(f)
    return recs


def pid_alive(pid: int) -> bool:
    import os

    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def run_launcher(tmp: str, name: str, args: list, env: dict,
                 killed_job: bool = False) -> tuple:
    """``python -m horovod_tpu_torch.runner.launch <args> python worker.py``
    under ``timeout``; (exit code, seconds, {file: record}, log tail,
    wall-clock start). A worker process left behind fails the phase, and
    so does an exit code other than 0, unless ``killed_job``: then every
    worker that recorded ``killed_at`` dies, the launcher (and its
    rendezvous server and store) is ended as soon as they are gone if it
    has not ended itself, and its exit code must not be 0."""
    import os
    import signal

    out = os.path.join(tmp, name)
    os.makedirs(out)
    repo = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(tmp, "el_worker.py")
    with open(worker, "w") as f:
        f.write(EL_WORKER_SCRIPT.format(repo=repo))
    full = dict(os.environ)
    full.update(PYTHONPATH=repo, EL_OUT=out, **env)
    log = os.path.join(tmp, f"{name}.log")
    wall0 = time.time()
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(["timeout", "-k", "10", str(EL_TIMEOUT), sys.executable,
                                 "-m", "horovod_tpu_torch.runner.launch", *args,
                                 sys.executable, worker], cwd=repo, env=full, stdout=f,
                                stderr=subprocess.STDOUT, start_new_session=True)
        while proc.poll() is None:
            time.sleep(0.2)
            if not killed_job:
                continue
            victims = [r for r in read_records(out).values() if "killed_at" in r]
            if victims and not any(pid_alive(r["pid"]) for r in victims):
                # The driver ends a job whose every worker failed; past 10 s
                # the launcher goes the way its workers went.
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
        rc = proc.wait()
    seconds = time.perf_counter() - t0
    with open(log) as f:
        tail = f.read()[-12000:]
    recs = read_records(out)
    left = []
    for r in recs.values():
        try:
            os.kill(r["pid"], 0)
            left.append(r["pid"])
            os.kill(r["pid"], 9)
        except ProcessLookupError:
            pass
    if (left or (rc != 0) != killed_job) and os.environ.get("EL_KEEP_LOGS"):
        # The whole log and the workers' records, for a look afterwards.
        import shutil

        keep = os.path.join(os.environ["EL_KEEP_LOGS"], f"el_{name}")
        shutil.rmtree(keep, ignore_errors=True)
        shutil.copytree(out, keep)
        shutil.copy(log, keep)
    if left:
        raise AssertionError(f"{name}: worker processes {left} outlived the launcher "
                             f"(exit {rc} after {seconds:.1f} s):\n{tail}")
    if (rc != 0) != killed_job:
        raise AssertionError(f"{name}: the launcher exited {rc} after {seconds:.1f} s:\n{tail}")
    return rc, seconds, recs, tail, wall0


def el_launches(recs: dict, name: str, want: int) -> dict:
    """Each finished worker's launches per attempted step (a forward run):
    ``want`` of K1 a step; of each K2 kernel ``want`` a step that finished,
    and at most ``want`` in a step a failure cut short."""
    per = {}
    for r in recs.values():
        if not r.get("done"):
            continue
        got, tried, done = r["launches"], r["attempts"], len(r["steps"])
        ok = got["flash_fwd"] == want * tried and all(
            want * done <= got[k] <= want * tried for k in ("flash_bwd_dkdv", "flash_bwd_dq"))
        if not ok:
            raise AssertionError(f"{name} {r['identity']}: launches {got} over {tried} "
                                 f"steps ({done} finished), expected {want} a step")
        per = {k: v / tried for k, v in got.items()}
    return per


def el_one(recs: dict, name: str) -> dict:
    done = [r for r in recs.values() if r.get("done")]
    if len(done) != 1:
        raise AssertionError(f"{name}: {len(done)} finished workers: {list(recs)}")
    return done[0]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def metrics_env(tmp: str) -> dict:
    """The knobs that turn the metrics plane on for a launch: rank 0's
    endpoint on a free port, every rank's JSON file, the push interval."""
    import os

    return {"HOROVOD_METRICS_PORT": str(free_port()),
            "HOROVOD_METRICS_FILE": os.path.join(tmp, "metrics.{rank}.json"),
            "HOROVOD_METRICS_FILE_INTERVAL": "1",
            "HOROVOD_METRICS_SYNC_SECONDS": str(EL_METRICS_SYNC)}


def metrics_files(tmp: str, recs: dict) -> None:
    """Each finished worker's last JSON dump, into its record."""
    import os

    for r in recs.values():
        if r.get("done"):
            with open(os.path.join(tmp, f"metrics.{r['final_rank']}.json")) as f:
                r["metrics_file"] = json.load(f)


def phase_elastic(fa) -> tuple:
    """One card. (a) ``-np 1`` static, 5 steps, its losses bitwise the same
    steps run here in process on phase ``slice``'s model and seed, with the
    metrics plane on (phase ``metrics`` reads its record); (b)
    elastic (``--min-np 1 --max-np 1``, a discovery script of one host):
    HorovodInternalError in step 5 after the commit of step 4, restored
    bitwise to that commit, reset, synced, 8 steps; (c) the same without the
    error. (b)'s final state is bitwise (c)'s."""
    import os
    import tempfile

    import horovod_tpu_torch as hvd

    dev = hvd.device()
    model, opt = el_model(dev)
    fa.reset_launches()
    control = [el_step(model, opt, el_batch(b, 0, dev, model.cfg.vocab_size))
               for b in range(STEPS)]
    control_launches = fa.launches()
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        disc = os.path.join(tmp, "discover.sh")
        with open(disc, "w") as f:
            f.write("#!/bin/sh\necho localhost:1\n")
        os.chmod(disc, 0o755)
        elastic = ["--min-np", "1", "--max-np", "1", "--host-discovery-script", disc]
        _, sec_a, recs_a, _, _ = run_launcher(tmp, "a_static", ["-np", "1"],
                                              {"EL_TOTAL": str(STEPS), **metrics_env(tmp)})
        metrics_files(tmp, recs_a)
        _, sec_b, recs_b, _, _ = run_launcher(tmp, "b_raised", elastic,
                                              {"EL_TOTAL": str(EL_B_STEPS),
                                               "EL_RAISE_AT": str(EL_RAISE_AT)})
        _, sec_c, recs_c, _, _ = run_launcher(tmp, "c_plain", elastic,
                                              {"EL_TOTAL": str(EL_STEPS),
                                               "EL_MARK": str(EL_B_STEPS)})
    a, b, c = el_one(recs_a, "(a)"), el_one(recs_b, "(b)"), el_one(recs_c, "(c)")
    want = flash_launches(12)["flash_fwd"]
    launches = {n: el_launches(r, n, want) for n, r in
                (("a", recs_a), ("b", recs_b), ("c", recs_c))}
    losses = {n: [s["loss"] for s in r["steps"]] for n, r in (("a", a), ("b", b), ("c", c))}
    if losses["a"] != control:
        raise AssertionError(f"(a): static launch losses {losses['a']} are not the "
                             f"in-process run's {control}")
    if losses["b"] != losses["c"][:EL_B_STEPS] or losses["c"][:STEPS] != control:
        raise AssertionError(f"(b)/(c) losses {losses['b']} / {losses['c']}")
    if [s["step"] for s in b["steps"]] != list(range(1, EL_B_STEPS + 1)):
        raise AssertionError(f"(b): steps {[s['step'] for s in b['steps']]}")
    if len(b["restores"]) != 1 or b["restores"][0]["batch"] != EL_RAISE_AT - 1 or \
            b["restores"][0]["checksum"] != b[f"commit{EL_RAISE_AT - 1}"]:
        raise AssertionError(f"(b): the restored state is not the commit of step "
                             f"{EL_RAISE_AT - 1}: {b['restores']}")
    if b["final"] != c["mark"]:
        raise AssertionError(f"(b)'s final parameters and AdamW state are not (c)'s at "
                             f"step {EL_B_STEPS}")
    if not all(s["equal"] for r in (a, b, c) for s in r["syncs"]):
        raise AssertionError("a sync left unequal replicas")
    reset = b["reset_log"][0]
    commit_ms = [s["commit_ms"] for s in c["steps"]]
    rec = {"phase": "elastic", "model": EL_MODEL, "batch": B, "seq": S, "world": 1,
           "control_launches": control_launches,
           "launches": launches["c"], "launches_a_b": [launches["a"], launches["b"]],
           "losses": losses["c"], "static_bitwise_in_process": True,
           "restore_bitwise_commit": True, "interrupted_bitwise_uninterrupted": True,
           "launcher_s": {"a": sec_a, "b": sec_b, "c": sec_c},
           "step_ms_median": statistics.median(s["ms"] for s in c["steps"][1:]),
           "commit_ms": commit_ms, "commit_ms_median": statistics.median(commit_ms[1:]),
           "torchstate_saved_gb": c["saved_gb"], "peak_gb": c["peak_gb"],
           "reset_s": {k: v for k, v in reset.items() if k.endswith("_s")},
           "raise_to_next_step_s": b["steps"][EL_RAISE_AT - 1]["t"] - b["raised_at"]}
    emit(rec)
    return rec, c["final"], a


def as_scalars(snapshot: dict) -> dict:
    """``hvd.metrics()["metrics"]`` keyed as a fleet push keys it."""
    out = {}
    for k, v in snapshot.items():
        if isinstance(v, dict):
            out[f"{k}_count"], out[f"{k}_sum"] = v["count"], v["sum"]
        else:
            out[k] = v
    return out


def metrics_gates(name: str, recs: dict, n: int) -> dict:
    """The metrics plane's gates on a launch of ``n`` workers with the
    exporters on (EL_SCRAPE_STEPS, ``metrics_quiet``). Each rank, at both
    scrapes: the scraped (rank 0) or own (the others) responses, tensors
    and bytes equal the engine's ``counters()`` read at that point, and
    the op latency holds one observation an executed response; between
    the scrapes the all-reduce tensors and bytes are the closed form of a
    step (every gradient and the drain flag past one rank, the averaged
    loss always) times the steps, and the latencies sum to at most the
    wall time (a local all-reduce runs no kernel: at one rank the sum of
    those steps may be 0). Quiet: the total all-reduce bytes are that
    closed form of the whole run and the last all-reduce, the whole run's
    latencies sum to more than 0 and at most its wall time; rank 0's
    /metrics.json fleet view holds every rank with each rank's own
    values, and its min and max of the all-reduce bytes are equal; the
    launch logs are equal on every rank; each rank's JSON file is its."""
    done = {r["final_rank"]: r for r in recs.values() if r.get("done")}
    if sorted(done) != list(range(n)):
        raise AssertionError(f"{name}: finished ranks {sorted(done)}")
    ar_b, ar_t = "horovod_allreduce_bytes_total", "horovod_allreduce_tensors_total"
    lat_sum = "horovod_op_latency_seconds_sum"
    out = {"ranks": {}}
    for rank, r in done.items():
        pts = {p["step"]: p for p in r["scrapes"]}
        if sorted(pts) != list(EL_SCRAPE_STEPS):
            raise AssertionError(f"{name} rank {rank}: scrapes at {sorted(pts)}")
        for step, p in pts.items():
            smp, cnt = p["samples"], p["counters"]
            got = {"responses": smp.get("horovod_responses_total", 0),
                   "tensors": sum(v for k, v in smp.items() if k.endswith("_tensors_total")),
                   "bytes": sum(v for k, v in smp.items() if k.endswith("_bytes_total"))}
            want = {k: cnt[k] for k in got}
            lat, due = latency_due(smp)
            if got != want or not p["settled"] or lat != due:
                raise AssertionError(f"{name} rank {rank} step {step}: scraped {got}, "
                                     f"counters() {want}, latency {lat} of {due}")
        first, last = pts[EL_SCRAPE_STEPS[0]], pts[EL_SCRAPE_STEPS[-1]]
        k = EL_SCRAPE_STEPS[-1] - EL_SCRAPE_STEPS[0]
        step_bytes = (r["grad_bytes"] + 4) * (n > 1) + 4
        step_tensors = (r["grads"] + 1) * (n > 1) + 1

        def delta(key):
            return last["samples"].get(key, 0) - first["samples"].get(key, 0)

        lat_s = sum(v for key, v in last["samples"].items() if key.startswith(lat_sum)) - \
            sum(v for key, v in first["samples"].items() if key.startswith(lat_sum))
        wall = last["t"] - first["t"]
        if (delta(ar_b), delta(ar_t)) != (k * step_bytes, k * step_tensors) or \
                not 0 <= lat_s <= wall:
            raise AssertionError(
                f"{name} rank {rank}: steps {EL_SCRAPE_STEPS[0] + 1}-{EL_SCRAPE_STEPS[-1]} "
                f"all-reduced {delta(ar_t)} tensors, {delta(ar_b)} bytes (closed form "
                f"{k * step_tensors}, {k * step_bytes}); latency {lat_s} s in {wall} s")
        q = r["quiet"]
        own = as_scalars(q["own"])
        lat_run = sum(v for key, v in own.items()
                      if key.startswith("horovod_op_latency_seconds{") and key.endswith("_sum"))
        run_wall = q["t"] - r["t_proc"]
        if not q["settled"] or own.get(ar_b, 0) != STEPS * step_bytes + 4 or \
                q["mode"] != "process" or not 0 < lat_run <= run_wall:
            raise AssertionError(f"{name} rank {rank}: quiet all-reduce bytes "
                                 f"{own.get(ar_b)} against {STEPS * step_bytes + 4}; "
                                 f"latency {lat_run} s in {run_wall} s")
        mf = r["metrics_file"]
        if mf["rank"] != rank or mf["metrics"].get("horovod_responses_total", 0) < \
                last["samples"]["horovod_responses_total"]:
            raise AssertionError(f"{name} rank {rank}: its metrics file {mf.get('rank')}")
        out["ranks"][rank] = {"allreduce_bytes": own[ar_b], "step_bytes": step_bytes,
                              "step_tensors": step_tensors, "latency_s_steps": lat_s,
                              "wall_s_steps": wall, "latency_s_run": lat_run,
                              "wall_s_run": run_wall,
                              "responses": own.get("horovod_responses_total")}
    q0 = done[0]["quiet"]
    fleet = q0["metrics_json"]["fleet"]
    if sorted(fleet["ranks"]) != [str(i) for i in range(n)] or fleet["size"] != n:
        raise AssertionError(f"{name}: the fleet view holds ranks {sorted(fleet['ranks'])}")
    for rank, r in done.items():
        own = data_series(as_scalars(r["quiet"]["own"]))
        theirs = fleet["ranks"][str(rank)]["metrics"]
        wrong = {k: (v, theirs.get(k)) for k, v in own.items() if theirs.get(k) != v}
        if wrong:
            raise AssertionError(f"{name}: rank {rank}'s fleet values differ from its own: "
                                 f"{wrong}")
    agg = fleet["aggregate"][ar_b]
    if agg["min"] != agg["max"] or agg["count"] != n:
        raise AssertionError(f"{name}: the fleet's all-reduce bytes {agg}")
    logs = [done[i]["quiet"]["launch_log"] for i in range(n)]
    if any(log != logs[0] for log in logs) or [x[0] for x in logs[0]] != list(
            range(len(logs[0]))):
        raise AssertionError(f"{name}: the ranks' launch logs differ")
    r0 = done[0]
    out.update(fleet_ranks=len(fleet["ranks"]), launches_logged=len(logs[0]),
               status_keys=sorted(q0["status"]),
               step_ms_on_median=statistics.median(r0["turns_ms"]["on"]),
               step_ms_off_median=statistics.median(r0["turns_ms"]["off"]),
               turns_ms=r0["turns_ms"])
    return out


def phase_metrics(a: dict, el: dict) -> dict:
    """One card, on phase ``elastic``'s launch (a) (``-np 1``, the hook
    optimizer over the engine, GPT-2-small at B=4, S=2048 on the flash
    kernels) with HOROVOD_METRICS_PORT on a free port, HOROVOD_METRICS_FILE
    and HOROVOD_METRICS_SYNC_SECONDS=1: ``metrics_gates``; its 5 losses
    bitwise those of (c), launched with the exporters off; step ms with
    them on and off in turns in that worker (no gate)."""
    want = flash_launches(12)["flash_fwd"]
    launches = el_launches({"a": a}, "metrics", want)
    losses = [s["loss"] for s in a["steps"]]
    if losses != el["losses"][:STEPS]:
        raise AssertionError(f"metrics: the losses with the exporters on {losses} are not "
                             f"those with them off {el['losses'][:STEPS]}")
    rec = {"phase": "metrics", "model": EL_MODEL, "batch": B, "seq": S, "world": 1,
           "launches": launches, "losses_bitwise_exporters_off": True,
           **metrics_gates("metrics", {"a": a}, 1)}
    emit(rec)
    return rec


def phase_metrics_multi() -> dict:
    """n cards (four in PERF.md's runs): the launch of phase ``metrics`` at
    ``-np n`` with HOROVOD_FUSION_THRESHOLD=0, each gradient all-reduced
    alone through the engine on NCCL: ``metrics_gates``, with the fleet
    view of every rank and the launch logs equal on every rank with the
    telemetry rounds in the mix."""
    import tempfile

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        rec = {"phase": "metrics_multi", "cards": n, "launches": "not measured: needs two "
               "cards or more", "result": "not measured: needs two cards or more"}
        emit(rec)
        return rec
    with tempfile.TemporaryDirectory() as tmp:
        _, seconds, recs, _, _ = run_launcher(
            tmp, "metrics_multi", ["-np", str(n)],
            {"EL_TOTAL": str(STEPS), "HOROVOD_FUSION_THRESHOLD": "0", **metrics_env(tmp)})
        metrics_files(tmp, recs)
    want = flash_launches(12)["flash_fwd"]
    launches = el_launches({k: r for k, r in recs.items() if r.get("done")},
                           "metrics_multi", want)
    r0 = next(r for r in recs.values() if r.get("final_rank") == 0)
    rec = {"phase": "metrics_multi", "cards": n, "model": EL_MODEL, "batch": B, "seq": S,
           "launcher_s": seconds, "launches": launches,
           "step_ms_median": statistics.median(s["ms"] for s in r0["steps"][1:]),
           **metrics_gates("metrics_multi", recs, n)}
    emit(rec)
    return rec


def nccl_dead_peer_rank(rank: int, size: int, init_file: str, queue) -> None:
    """One spawned rank of the dead-peer check on NCCL: the last rank dies
    while the others wait on a direct NCCL reduce-scatter (no engine) that
    needs it; each survivor's wait must end (the engine's control round
    sees the death and aborts the world's groups), its next collective
    raise HorovodInternalError, its shutdown() stay local, and a world of
    the survivors form in the same process on the same card."""
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd

        hvd.init(init_method=f"file://{init_file}")
        dev = hvd.device()
        x = torch.ones(size * (1 << 24), device=dev)       # 64 MiB a rank after the cut
        hvd.reducescatter(x)
        torch.cuda.synchronize()
        hvd.barrier()
        if rank == size - 1:
            queue.put((rank, {"died": True}))
            queue.close()
            queue.join_thread()
            time.sleep(0.5)
            os._exit(1)
        rec = {"rank": rank, "device": str(dev)}
        t0 = time.perf_counter()
        try:
            # On NCCL the call returns and its kernel waits on the card for
            # the dead rank (gloo raises in the call itself).
            hvd.reducescatter(x)
            torch.cuda.synchronize()
            rec["wait_ended_s"] = time.perf_counter() - t0
            hvd.allreduce(torch.ones(4, device=dev), name="after_death")
            rec["raised"] = "nothing"
        except hvd.HorovodInternalError:
            rec["raised"] = "HorovodInternalError"
        rec["raised_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        hvd.shutdown()
        rec["shutdown_s"] = time.perf_counter() - t1
        os.environ["HOROVOD_SIZE"] = str(size - 1)
        t1 = time.perf_counter()
        hvd.init(init_method=f"file://{init_file}.survivors")
        rec["reinit_s"] = time.perf_counter() - t1
        rec["same_card"] = str(hvd.device()) == rec["device"]
        got = hvd.allreduce(torch.full((4,), float(rank + 1), device=hvd.device()),
                            op=hvd.Sum, name="survivors")
        rec["sum_ok"] = got.tolist() == [float(sum(range(1, size)))] * 4
        rec["direct_ok"] = hvd.reducescatter(
            torch.ones(size - 1, device=hvd.device()), op=hvd.Sum).tolist() == [size - 1.0]
        hvd.shutdown()
        queue.put((rank, rec))
    except Exception:
        queue.put((rank, traceback.format_exc()))


def nccl_dead_peer(n: int) -> dict:
    """``nccl_dead_peer_rank`` on n cards; the survivors' records."""
    ranks = spawn_cards(nccl_dead_peer_rank, n, timeout=240)
    survivors = [r for r in ranks if not r.get("died")]
    bad = [r for r in survivors if r["raised"] != "HorovodInternalError" or
           r["shutdown_s"] > 10 or not (r["same_card"] and r["sum_ok"] and r["direct_ok"])]
    if len(survivors) != n - 1 or bad:
        raise AssertionError(f"nccl_dead_peer: {ranks}")
    return {k: max(r.get(k, -1.0) for r in survivors)
            for k in ("wait_ended_s", "raised_s", "shutdown_s", "reinit_s")}


def el_sizes_ok(sizes: list, n: int) -> bool:
    """n at steps 1-4, then at least 3 steps at n - 1, then n to the end."""
    if sizes[:EL_KILL_STEP - 1] != [n] * (EL_KILL_STEP - 1) or sizes[-1] != n:
        return False
    rest = sizes[EL_KILL_STEP - 1:]
    shrunk = next((i for i, size in enumerate(rest) if size != n - 1), len(rest))
    return shrunk >= 3 and all(size == n for size in rest[shrunk:])


def phase_elastic_multi() -> dict:
    """n cards (four in PERF.md's runs), fake hosts card0..card<n-1>
    with one slot each, a discovery script that prints a file. The fault
    rule kill:step=5 on rank n-1 ends its worker (its host leaves the file
    with it); the survivors raise HorovodInternalError, restore the commit
    of step 4, reset to n-1 and train on; after step 8 rank 0 lists the
    host again, the next commit raises HostsUpdatedInterrupt, the world
    resets to n and the new worker is synced from rank 0; the job ends at
    step 12."""
    import os
    import tempfile

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        rec = {"phase": "elastic_multi", "cards": n, "launches": "not measured: needs two "
               "cards or more", "result": "not measured: needs two cards or more"}
        emit(rec)
        return rec
    with tempfile.TemporaryDirectory() as tmp:
        hosts_file = os.path.join(tmp, "hosts")
        with open(hosts_file, "w") as f:
            f.write("".join(f"card{i}:1\n" for i in range(n)))
        disc = os.path.join(tmp, "discover.sh")
        with open(disc, "w") as f:
            f.write(f"#!/bin/sh\ncat {hosts_file}\n")
        os.chmod(disc, 0o755)
        _, seconds, recs, tail, _ = run_launcher(
            tmp, "multi", ["--min-np", str(n - 1), "--max-np", str(n),
                           "--host-discovery-script", disc],
            {"EL_TOTAL": str(EL_MULTI_STEPS), "EL_HOSTS_FILE": hosts_file,
             "EL_RETURN_AFTER": str(EL_RETURN_AFTER), "EL_CARDS": str(n),
             "HVDRUN_FORCE_LOCAL": "1", "HOROVOD_FAULT_INJECT":
             f"kill:step={EL_KILL_STEP}:rank={n - 1}",
             "HOROVOD_BLACKLIST_COOLDOWN_SECONDS": "1",
             "HOROVOD_ELASTIC_DISCOVERY_INTERVAL": "0.5"})
    victim = [r for r in recs.values() if "killed_at" in r]
    if len(victim) != 1 or victim[0].get("done"):
        raise AssertionError(f"elastic_multi: the killed worker: {victim}")
    killed_at = victim[0]["killed_at"]
    survivors = [r for r in recs.values() if r.get("done") and r["pid"] != victim[0]["pid"]
                 and r["identity"] != victim[0]["identity"]]
    joiner = [r for r in recs.values() if r.get("done") and r["identity"] ==
              victim[0]["identity"]]
    if len(survivors) != n - 1 or len(joiner) != 1:
        raise AssertionError(f"elastic_multi: {len(survivors)} survivors, {len(joiner)} "
                             f"joiners: {sorted(recs)}\n{tail}")
    for r in survivors:
        sizes = [s["size"] for s in r["steps"]]
        ranks = {s["size"]: s["rank"] for s in r["steps"]}
        if [s["step"] for s in r["steps"]] != list(range(1, EL_MULTI_STEPS + 1)) or \
                not el_sizes_ok(sizes, n) or len(set(ranks.values())) != 1:
            raise AssertionError(f"elastic_multi {r['identity']}: history "
                                 f"{[(s['rank'], s['size']) for s in r['steps']]}")
        restored = [x for x in r["restores"] if x["size"] == n - 1]
        if not restored or restored[0]["batch"] != EL_KILL_STEP - 1 or \
                restored[0]["checksum"] != r[f"commit{EL_KILL_STEP - 1}"]:
            raise AssertionError(f"elastic_multi {r['identity']}: the restore is not the "
                                 f"commit of step {EL_KILL_STEP - 1}")
    j = joiner[0]
    if [(s["rank"], s["size"]) for s in j["steps"]] != \
            [(n - 1, n)] * (EL_MULTI_STEPS - EL_RETURN_AFTER):
        raise AssertionError(f"elastic_multi: the new worker's steps {j['steps']}")
    syncs = [s for r in survivors + [j] for s in r["syncs"]]
    if not all(s["equal"] for s in syncs):
        raise AssertionError(f"elastic_multi: replicas differ after a sync: {syncs}")
    finals = {json.dumps(r["final"]) for r in survivors + [j]}
    if len(finals) != 1:
        raise AssertionError("elastic_multi: the final replicas differ")
    want = flash_launches(12)["flash_fwd"]
    launches = el_launches({k: r for k, r in recs.items() if r.get("done")},
                           "elastic_multi", want)
    r0 = min(survivors, key=lambda r: r["final_rank"])
    first = {size: next(s for s in r0["steps"] if s["size"] == size and s["t"] >
                        (killed_at if size == n - 1 else r0["returned_at"]))
             for size in (n - 1, n)}
    fail = next(x for x in r0["reset_log"] if x["cause"] == "collective failure")
    back = [x for x in r0["reset_log"] if x["cause"] == "hosts updated"][-1]
    rec = {"phase": "elastic_multi", "cards": n, "model": EL_MODEL, "batch": B, "seq": S,
           "launcher_s": seconds, "launches": launches,
           "histories": {r["identity"]: [(s["rank"], s["size"]) for s in r["steps"]]
                         for r in survivors + [j]},
           "syncs_bitwise": len(syncs), "restores_bitwise_commit": len(survivors),
           "kill_to_first_step_s": first[n - 1]["t"] - killed_at,
           "kill_split_s": {"detection": fail["t_caught"] - killed_at,
                            "restore": fail["restore_s"], "shutdown": fail["shutdown_s"],
                            "driver_epoch": fail["rendezvous_s"], "reinit": fail["init_s"],
                            "sync": fail.get("sync_s")},
           "return_to_first_step_s": first[n]["t"] - r0["returned_at"],
           "return_split_s": {k: v for k, v in back.items() if k.endswith("_s")},
           "step_ms_median": {str(size): statistics.median(
               s["ms"] for s in r0["steps"] if s["size"] == size and s is not first[size]
               and s["step"] > 1) for size in (n, n - 1)},
           "commit_ms_median": statistics.median(s["commit_ms"] for s in r0["steps"][1:]),
           "peak_gb": {r["identity"]: r["peak_gb"] for r in survivors + [j]},
           "torchstate_saved_gb": r0["saved_gb"],
           "nccl_dead_peer_max_s": nccl_dead_peer(n)}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# The durability plane: GPT-2-small of phase ``elastic`` with durable
# checkpoints (HOROVOD_CHECKPOINT_DIR) through the death of the whole job
# and through an announced preemption, and the C7 check of the engine.
DU_TURN_MIN_STEPS = 20    # steps a turn, checkpoints off and on in turns
DU_MULTI_EXTRA = 4        # (m3): steps past the restore at np=2
DU_PREEMPT_STEP = 2       # (f): preempt:step=2
DU_PREEMPT_RANK_STEP = 5  # (m4): preempt:step=5:rank=3
C7_RUNS = 20              # batched broadcasts of GPT-2-small's state beside the step


def leaves_digest(trees: dict) -> str:
    """sha256 over a state's checkpoint leaves in the checkpoint's order
    (attrs sorted), each as a shard holds it (dtype, shape, bytes): equal
    for bitwise-equal states."""
    import hashlib

    from horovod_tpu_torch.common.checkpoint import host_leaf

    h = hashlib.sha256()
    for attr in sorted(trees):
        for leaf in trees[attr]:
            a = np.asarray(host_leaf(leaf))
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def manifest_digest(root: str, manifest: dict) -> str:
    from horovod_tpu_torch.common.checkpoint import load_checkpoint_arrays

    return leaves_digest(load_checkpoint_arrays(root, manifest)[1])


def checkpoint_dir_clean(root: str) -> dict:
    """No ``*.tmp.*`` debris anywhere under ``root``, and every shard
    directory has its manifest."""
    import os

    from horovod_tpu_torch.common import checkpoint as ck

    debris = [os.path.join(d, n) for d, _, names in os.walk(root) for n in names
              if ck.atomic_file.is_tmp_debris(n)]
    manifested = {s for s, _ in ck.list_manifests(root)}
    orphans = [n for n in os.listdir(root) if n.startswith(ck.STEP_DIR_PREFIX) and
               int(n[len(ck.STEP_DIR_PREFIX):]) not in manifested]
    if debris or orphans:
        raise AssertionError(f"{root}: tmp debris {debris}, orphan shard dirs {orphans}")
    return {"manifests": sorted(manifested)}


def ckpt_writes(rec: dict) -> dict:
    """A worker's checkpoint writes from its per-step manager status: the
    write and commit seconds each new write took, skips, shard bytes."""
    writes, commits = {}, {}
    for c in rec["ckpt"]:
        if c["writes"]:
            writes.setdefault(c["writes"], c["write_s"])
        if c["commits"]:
            commits.setdefault(c["commits"], c["commit_s"])
    last = rec["ckpt"][-1] if rec["ckpt"] else {}
    return {"write_s": list(writes.values()), "commit_s": list(commits.values()),
            "skipped": last.get("skipped", 0),
            "shard_bytes": last.get("bytes", 0) / max(last.get("writes", 0), 1)}


def fs_type(path: str) -> str:
    """The type of the filesystem ``path`` is on, from /proc/mounts."""
    import os

    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) > 2 and os.path.realpath(path).startswith(parts[1]) and \
                        len(parts[1]) > len(best):
                    best, kind = parts[1], parts[2]
    except OSError:
        pass
    return kind


def durable_plan(dev) -> dict:
    """In this process, on phase ``elastic``'s model under ``TorchState``
    with a ``CheckpointManager`` in a temporary directory: one blocking
    checkpoint of the whole state (its seconds and bytes, and without
    fsync for the record), then steps with
    checkpoints off and on (one a commit: a write always in flight, the
    rest skipped) in turns, off, on, on, off, each at least a write long
    (1.2 W): step ms, the writes' seconds under training, the extra device
    bytes while a write is in flight. From them the plan of the durable
    phases: an interval I in which a write ends (I = ceil(1.5 W / T) + 1
    for the longest write W at T ms a step), the kill at 3I + 1 (two
    manifests committed, the third write cut off), and EL_STEPS (phase
    ``elastic``'s (b) and (c) and the durable runs) at 3I + 4."""
    import os
    import tempfile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.checkpoint import CheckpointManager

    global EL_STEPS
    model, opt = el_model(dev)
    vocab = model.cfg.vocab_size
    state = hvd.elastic.TorchState(model, opt, batch=0)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"), interval_steps=1)

        def run(n: int, on: bool) -> list:
            state.set_checkpoint_manager(mgr if on else None)
            out = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                el_step(model, opt, el_batch(state.batch, 0, dev, vocab))
                state.batch += 1
                state.commit()
                torch.cuda.synchronize()
                st = mgr.status()
                out.append({"ms": (time.perf_counter() - t0) * 1e3,
                            "allocated": torch.cuda.memory_allocated(),
                            "pending": st["pending_step"] if on else None,
                            "write_s": st["last_write_s"], "writes": st["writes"]})
            state.set_checkpoint_manager(None)
            return out

        run(3, False)
        t0 = time.perf_counter()
        mgr.save(state, step=0, blocking=True)
        blocking_s = time.perf_counter() - t0
        shard_bytes = mgr.counts["bytes"]
        unsynced = CheckpointManager(os.path.join(tmp, "nofsync"), interval_steps=0,
                                     fsync=False)
        t0 = time.perf_counter()
        unsynced.save(state, step=0, blocking=True)
        no_fsync_s = time.perf_counter() - t0
        unsynced.stop()
        step_ms = statistics.median(r["ms"] for r in run(5, False)[1:])
        turn = max(DU_TURN_MIN_STEPS, math.ceil(1.2 * blocking_s * 1e3 / step_ms))
        turns = []
        for on in (False, True, True, False):
            turns.append((on, run(turn, on)))
            mgr.flush()
        mgr.stop()
        status = mgr.status()
    off = [r for on, rs in turns if not on for r in rs[1:]]
    on = [r for on_, rs in turns if on_ for r in rs[1:]]
    write_s = sorted({(r["writes"], r["write_s"]) for r in on if r["write_s"]})
    longest = max([blocking_s] + [w for _, w in write_s])
    t_off = statistics.median(r["ms"] for r in off)
    interval = math.ceil(1.5 * longest * 1e3 / t_off) + 1
    kill = 3 * interval + 1
    EL_STEPS = kill + 3
    baseline = statistics.median(r["allocated"] for r in off)
    in_flight = [r["allocated"] for r in on if r["pending"] is not None]
    del model, opt, state
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "durable_plan", "model": EL_MODEL, "batch": B, "seq": S,
           "shard_bytes": shard_bytes, "blocking_write_s": blocking_s,
           "blocking_write_no_fsync_s": no_fsync_s, "checkpoint_fs": fs_type(tempfile.gettempdir()),
           "writes_under_training_s": [w for _, w in write_s],
           "skipped": status["skipped"], "turn_steps": turn,
           "step_ms_turns": [{"checkpoints": "on" if o else "off",
                              "median": statistics.median(r["ms"] for r in rs[1:])}
                             for o, rs in turns],
           "step_ms_off": t_off, "step_ms_on": statistics.median(r["ms"] for r in on),
           "extra_device_bytes_in_flight": (max(in_flight) - baseline) if in_flight else 0,
           "interval": interval, "kill_step": kill, "el_steps": EL_STEPS}
    emit(rec)
    return rec


def phase_durable(plan: dict, control_final: list) -> dict:
    """One card. (d) an elastic launch of one slot with checkpoints every
    I commits; kill:step=K ends the worker; the launcher and its
    rendezvous server end (the driver stops a job whose every worker
    failed; the harness ends it otherwise): only the files remain, with
    at least two complete manifests. (e) a fresh launch on the directory
    restores the newest complete step S <= K, bitwise the manifest's
    shards, and trains to EL_STEPS: its final parameters and AdamW state
    bitwise phase ``elastic``'s (c). (f) preempt:step=2 in a fresh
    directory: the drain commit of that step is durable, the worker exits
    cleanly (SystemExit(0)) within the grace, and (f2) a relaunch resumes
    at exactly that step and takes two steps. Both directories end with no
    tmp debris and no orphan shard directory."""
    import os
    import tempfile

    from horovod_tpu_torch.common import checkpoint as ck, env as env_cfg

    interval, kill = plan["interval"], plan["kill_step"]
    preempt = DU_PREEMPT_STEP
    with tempfile.TemporaryDirectory() as tmp:
        disc = os.path.join(tmp, "discover.sh")
        with open(disc, "w") as f:
            f.write("#!/bin/sh\necho localhost:1\n")
        os.chmod(disc, 0o755)
        elastic = ["--min-np", "1", "--max-np", "1", "--host-discovery-script", disc]
        dirs = {k: os.path.join(tmp, f"ckpt_{k}") for k in "df"}

        def env(k, **more):
            return {"EL_TOTAL": str(EL_STEPS), "HOROVOD_CHECKPOINT_DIR": dirs[k],
                    "HOROVOD_CHECKPOINT_INTERVAL_STEPS": str(interval), **more}

        _, sec_d, recs_d, _, _ = run_launcher(
            tmp, "d_killed", elastic, env("d", HOROVOD_FAULT_INJECT=f"kill:step={kill}"),
            killed_job=True)
        d = [r for r in recs_d.values() if "killed_at" in r]
        if len(d) != 1 or [s["step"] for s in d[0]["steps"]] != list(range(1, kill)):
            raise AssertionError(f"(d): the killed worker {sorted(recs_d)}")
        d = d[0]
        complete = [s for s, p in ck.list_manifests(dirs["d"])
                    if ck.is_complete(dirs["d"], ck.load_manifest(p))]
        found = ck.find_latest_manifest(dirs["d"])
        if len(complete) < 2 or found is None or found[0] > kill:
            raise AssertionError(f"(d): complete manifests {complete} before the kill at "
                                 f"step {kill}")
        step_s, man, _ = found
        digest = manifest_digest(dirs["d"], man)
        _, sec_e, recs_e, _, wall_e = run_launcher(tmp, "e_resumed", elastic, env("d"))
        e = el_one(recs_e, "(e)")
        if e["resume"]["step"] != step_s or e["resume"]["batch"] != step_s or \
                e["resume"]["digest"] != digest:
            raise AssertionError(f"(e): restored {e['resume']} from step {step_s} "
                                 f"(manifest digest {digest})")
        if [s["step"] for s in e["steps"]] != list(range(step_s + 1, EL_STEPS + 1)):
            raise AssertionError(f"(e): steps {[s['step'] for s in e['steps']]}")
        if e["final"] != control_final:
            raise AssertionError("(e)'s final parameters and AdamW state are not (c)'s")
        _, sec_f, recs_f, _, _ = run_launcher(
            tmp, "f_preempted", elastic,
            env("f", HOROVOD_FAULT_INJECT=f"preempt:step={preempt}"))
        f = [r for r in recs_f.values() if "drained_at" in r]
        grace = env_cfg.drain_grace_seconds()
        if len(f) != 1 or f[0]["drained_step"] != preempt or "exit_at" not in f[0] or \
                f[0]["exit_at"] - f[0]["notice_at"] > grace:
            raise AssertionError(f"(f): the drained worker {list(recs_f.values())}")
        f = f[0]
        found_f = ck.find_latest_manifest(dirs["f"])
        if found_f is None or found_f[0] != preempt:
            raise AssertionError(f"(f): the newest complete manifest is {found_f} after a "
                                 f"drain at step {preempt}")
        digest_f = manifest_digest(dirs["f"], found_f[1])
        _, sec_f2, recs_f2, _, _ = run_launcher(tmp, "f2_resumed", elastic,
                                                env("f", EL_TOTAL=str(preempt + 2)))
        f2 = el_one(recs_f2, "(f2)")
        if f2["resume"]["step"] != preempt or f2["resume"]["digest"] != digest_f or \
                [s["step"] for s in f2["steps"]] != [preempt + 1, preempt + 2]:
            raise AssertionError(f"(f2): restored {f2['resume']} after the drain at step "
                                 f"{preempt}, steps {[s['step'] for s in f2['steps']]}")
        clean = {k: checkpoint_dir_clean(v) for k, v in dirs.items()}
    want = flash_launches(12)["flash_fwd"]
    launches = {n: el_launches(r, n, want) for n, r in
                (("e", recs_e), ("f2", recs_f2))}
    first = e["steps"][0]["t"]
    res = e["resume"]
    rec = {"phase": "durable", "model": EL_MODEL, "batch": B, "seq": S, "world": 1,
           "interval": interval, "kill_step": kill, "el_steps": EL_STEPS,
           "complete_manifests_at_kill": complete, "restored_step": step_s,
           "restore_bitwise_manifest": True, "resumed_bitwise_uninterrupted": True,
           "launches": launches["e"], "launches_f2": launches["f2"],
           "writes_d": ckpt_writes(d), "writes_e": ckpt_writes(e),
           "launcher_s": {"d": sec_d, "e": sec_e, "f": sec_f, "f2": sec_f2},
           "kill_to_first_step_s": first - d["killed_at"],
           "kill_split_s": {"harness": wall_e - d["killed_at"],
                            "launch": e["t_proc"] - wall_e, "init": e["init_s"],
                            "model": e["built_s"] - e["init_s"],
                            "restore": res["restore_s"], "sync": res["sync_s"],
                            "other": (res["t"] - e["t_proc"] - e["built_s"] -
                                      res["restore_s"] - res["sync_s"]),
                            "first_step": first - res["t"]},
           "drain_step": preempt, "drain_notice_to_exit_s": f["exit_at"] - f["notice_at"],
           "drain_commit_s": f["drain_s"], "drain_grace_s": grace,
           "step_ms_median_e": statistics.median(s["ms"] for s in e["steps"][1:]),
           "commit_ms_median_e": statistics.median(s["commit_ms"] for s in e["steps"][1:]),
           "dirs": clean}
    emit(rec)
    return rec


def c7_rank(rank: int, size: int, init_file: str, queue) -> None:
    """One spawned NCCL rank of the C7 check: GPT-2-small under the
    binding's hook optimizer; C7_RUNS times a step, then
    ``broadcast_parameters`` of the model and ``broadcast_optimizer_state``
    of AdamW (every tensor enqueued before any is waited on), under the
    caller's time limit. The engine's launch order must be the same on
    every rank, and the state bitwise on every rank after each run."""
    import hashlib
    import os
    import traceback

    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common import basics

        full_precision_products()
        hvd.init(init_method=f"file://{init_file}")
        dev = hvd.device()
        model, opt = el_model(dev)
        vocab = model.cfg.vocab_size
        n_tensors = len(model.state_dict())
        bcast_ms, step_ms = [], []
        for i in range(C7_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            el_step(model, opt, el_batch(i, rank, dev, vocab))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            hvd.broadcast_optimizer_state(opt, root_rank=0)
            torch.cuda.synchronize()
            step_ms.append((t1 - t0) * 1e3)
            bcast_ms.append((time.perf_counter() - t1) * 1e3)
        n_tensors += sum(isinstance(v, torch.Tensor) for st in opt.state_dict()["state"].values()
                         for v in st.values())
        mine = state_checksum(model, opt)
        same = bool(torch.equal(mine, hvd.broadcast(mine.clone(), 0, name="c7.sum")))
        log = basics.engine().launch_log()
        order = hashlib.sha256(json.dumps(log).encode()).hexdigest()
        orders = hvd.allgather_object(order, name="c7.order")
        hvd.shutdown()
        queue.put((rank, {"rank": rank, "tensors": n_tensors, "launches": len(log),
                          "channels": sorted({c for _, c, _ in log}),
                          "order_equal": len(set(orders)) == 1, "replicas_bitwise": same,
                          "bcast_ms": bcast_ms, "step_ms": step_ms}))
    except Exception:
        queue.put((rank, traceback.format_exc()))


def phase_c7_multi(n: int) -> dict:
    """C7: the batched broadcast of GPT-2-small's state (~450 tensors)
    C7_RUNS times beside the hook optimizer's step on n NCCL ranks, under
    a time limit; the launch order across channels the same on every rank."""
    ranks = spawn_cards(c7_rank, n, timeout=240)
    bad = [r for r in ranks if not (r["order_equal"] and r["replicas_bitwise"])]
    if bad:
        raise AssertionError(f"c7: {ranks}")
    rec = {"phase": "c7_multi", "cards": n, "runs": C7_RUNS, "tensors": ranks[0]["tensors"],
           "launches_logged": ranks[0]["launches"], "channels": ranks[0]["channels"],
           "order_equal": True, "replicas_bitwise": True,
           "bcast_ms_median": max(statistics.median(r["bcast_ms"]) for r in ranks),
           "step_ms_median": max(statistics.median(r["step_ms"][1:]) for r in ranks)}
    emit(rec)
    return rec


def phase_durable_multi(plan: dict) -> dict:
    """n cards (four). First the C7 check (``phase_c7_multi``); then fake
    hosts card0..card<n-1>, the engine's fusion off (every run reduces each
    gradient in one order), checkpoints every I commits, I from the
    one-card plan's longest write and the C7 check's step: (m0) the
    uninterrupted np=n run, checkpoints off; (m1) np=n,
    kill:step=3I+1 on every rank,
    the job ends: at least two complete manifests of n shards; (m2) a
    restart at np=n restores the newest, bitwise its shards, and ends
    bitwise (m0); (m3) a restart at np=2 from a copy of (m1)'s directory
    restores bitwise the same manifest and its replicas are bitwise after
    DU_MULTI_EXTRA steps; (m4) preempt:step=5:rank=n-1 at np=n: the drain
    commit of step 5 is a complete manifest of n shards, the drained
    worker exits cleanly, the driver re-meshes at its exit (no ready
    deadline) and the survivors go on at np=n-1 from the commit of step
    5, with no restore from the checkpoint. Records the
    drain barrier's ms a commit, the writes, and the drain's seconds from
    the notice to the exit to the first step at n-1."""
    import os
    import shutil
    import tempfile

    from horovod_tpu_torch.common import checkpoint as ck

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        rec = {"phase": "durable_multi", "cards": n, "launches": "not measured: needs two "
               "cards or more", "result": "not measured: needs two cards or more"}
        emit(rec)
        return rec
    with tempfile.TemporaryDirectory() as tmp:
        hosts_file = os.path.join(tmp, "hosts")
        with open(hosts_file, "w") as f:
            f.write("".join(f"card{i}:1\n" for i in range(n)))
        disc = os.path.join(tmp, "discover.sh")
        with open(disc, "w") as f:
            f.write(f"#!/bin/sh\ncat {hosts_file}\n")
        os.chmod(disc, 0o755)
        # Fusion off: each gradient is reduced alone, so its summation order
        # is the same in every run and (m2) can end bitwise (m0); fused
        # buffers hold what each cycle found ready.
        base = {"EL_CARDS": str(n), "HVDRUN_FORCE_LOCAL": "1",
                "HOROVOD_ELASTIC_DISCOVERY_INTERVAL": "0.5",
                "HOROVOD_FUSION_THRESHOLD": "0"}

        def launch(name, np_, total, killed_job=False, min_np=None, **env):
            return run_launcher(tmp, name, ["--min-np", str(min_np or np_), "--max-np", str(np_),
                                            "--host-discovery-script", disc],
                                {**base, "EL_TOTAL": str(total), **env},
                                killed_job=killed_job)

        # C7 first; its step (the hook optimizer's, no commit) is a floor
        # of the launched workers' step T4, which sets the interval
        # I = ceil(1.5 W / T4) + 1 for the one-card plan's longest write W
        # (the n shards carry the whole state through one disk, as one
        # card's write does).
        c7 = phase_c7_multi(n)
        longest = max([plan["blocking_write_s"]] + plan["writes_under_training_s"])
        interval = math.ceil(1.5 * longest * 1e3 / c7["step_ms_median"]) + 1
        kill = 3 * interval + 1
        total = kill + 3
        _, sec_m0, m0, _, _ = launch("m0", n, total)
        dirs = {k: os.path.join(tmp, f"ckpt_{k}") for k in ("m", "m3", "m4")}
        ck_env = {"HOROVOD_CHECKPOINT_DIR": dirs["m"],
                  "HOROVOD_CHECKPOINT_INTERVAL_STEPS": str(interval)}
        _, sec_m1, m1, _, _ = launch("m1", n, total, killed_job=True,
                                     HOROVOD_FAULT_INJECT=f"kill:step={kill}", **ck_env)
        killed = [r for r in m1.values() if "killed_at" in r]
        complete = [s for s, p in ck.list_manifests(dirs["m"])
                    if ck.is_complete(dirs["m"], ck.load_manifest(p))]
        found = ck.find_latest_manifest(dirs["m"])
        if len(killed) != n or len(complete) < 2 or found is None or \
                len(found[1]["shards"]) != n:
            raise AssertionError(f"(m1): {len(killed)} killed, complete manifests {complete}")
        step_s, man, _ = found
        digest = manifest_digest(dirs["m"], man)
        shutil.copytree(dirs["m"], dirs["m3"])
        _, sec_m2, m2, _, wall_m2 = launch("m2", n, total, **ck_env)
        _, sec_m3, m3, _, _ = launch("m3", 2, step_s + DU_MULTI_EXTRA,
                                     HOROVOD_CHECKPOINT_DIR=dirs["m3"],
                                     HOROVOD_CHECKPOINT_INTERVAL_STEPS=str(interval))
        # (m4) keeps every manifest, so the drain commit's is still there.
        _, sec_m4, m4, _, _ = launch(
            "m4", n, EL_MULTI_STEPS, min_np=n - 1, HOROVOD_CHECKPOINT_DIR=dirs["m4"],
            HOROVOD_CHECKPOINT_INTERVAL_STEPS=str(interval),
            HOROVOD_CHECKPOINT_KEEP=str(EL_MULTI_STEPS),
            HOROVOD_FAULT_INJECT=f"preempt:step={DU_PREEMPT_RANK_STEP}:rank={n - 1}")
        drain_man = ck.load_manifest(ck.manifest_path(dirs["m4"], DU_PREEMPT_RANK_STEP))
        if drain_man is None or len(drain_man["shards"]) != n or \
                not ck.is_complete(dirs["m4"], drain_man):
            raise AssertionError(f"(m4): the drain commit's manifest {drain_man}")
        clean = {k: checkpoint_dir_clean(v) for k, v in dirs.items()}
    finals0 = {json.dumps(r["final"]) for r in m0.values() if r.get("done")}
    done2 = [r for r in m2.values() if r.get("done")]
    if len(finals0) != 1 or len(done2) != n:
        raise AssertionError(f"(m0)/(m2): {len(finals0)} distinct finals, {len(done2)} done")
    for r in done2:
        if r["resume"]["step"] != step_s or r["resume"]["digest"] != digest or \
                json.dumps(r["final"]) not in finals0:
            raise AssertionError(f"(m2) {r['identity']}: restored {r['resume']} from step "
                                 f"{step_s}, or its end is not (m0)'s")
    done3 = [r for r in m3.values() if r.get("done")]
    if len(done3) != 2 or any(r["resume"]["step"] != step_s or r["resume"]["digest"] != digest
                              for r in done3) or len({json.dumps(r["final"])
                                                      for r in done3}) != 1:
        raise AssertionError(f"(m3): {[(r['identity'], r.get('resume')) for r in done3]}")
    drained = [r for r in m4.values() if "drained_at" in r]
    survivors = [r for r in m4.values() if r.get("done")]
    if len(drained) != 1 or drained[0]["drained_step"] != DU_PREEMPT_RANK_STEP or \
            "exit_at" not in drained[0] or len(survivors) != n - 1:
        raise AssertionError(f"(m4): drained {drained}, {len(survivors)} survivors")
    for r in survivors:
        hist = [(s["step"], s["size"]) for s in r["steps"]]
        # Step 5's commit is the drain's: the drained rank leaves before its
        # host-update broadcast, which then fails on the survivors; they
        # restore that same commit and go on at n-1.
        want = [(i, n) for i in range(1, DU_PREEMPT_RANK_STEP)] + \
            [(i, n - 1) for i in range(DU_PREEMPT_RANK_STEP + 1, EL_MULTI_STEPS + 1)]
        if hist != want or "resume" in r or \
                any(x["batch"] != DU_PREEMPT_RANK_STEP for x in r["restores"]):
            raise AssertionError(f"(m4) {r['identity']}: history {hist}, restores "
                                 f"{r['restores']}, resume {r.get('resume')}")
    if len({json.dumps(r["final"]) for r in survivors}) != 1:
        raise AssertionError("(m4): the survivors' final replicas differ")
    dr = drained[0]
    r0 = min(survivors, key=lambda r: r["final_rank"])
    first3 = next(s for s in r0["steps"] if s["size"] == n - 1)
    want = flash_launches(12)["flash_fwd"]
    launches = el_launches({k: r for k, r in m2.items() if r.get("done")}, "durable_multi",
                           want)
    r2 = min(done2, key=lambda r: r["final_rank"])
    first2 = r2["steps"][0]["t"]
    kill_at = max(r["killed_at"] for r in killed)
    rec = {"phase": "durable_multi", "cards": n, "model": EL_MODEL, "batch": B, "seq": S,
           "interval": interval, "kill_step": kill, "steps": total,
           "complete_manifests_at_kill": complete, "restored_step": step_s,
           "m2_bitwise_m0": True, "m3_np2_bitwise_manifest": True, "launches": launches,
           "launcher_s": {"m0": sec_m0, "m1": sec_m1, "m2": sec_m2, "m3": sec_m3,
                          "m4": sec_m4},
           "writes_m1_rank0": ckpt_writes(min(killed, key=lambda r: r["steps"][0]["rank"])),
           "step_ms_median": {
               "m0_off": statistics.median(s["ms"] for r in m0.values() for s in r["steps"][1:]),
               "m2_on": statistics.median(s["ms"] for r in done2 for s in r["steps"][1:])},
           "barrier_ms_median": statistics.median(x for r in done2 for x in r["barrier_ms"]),
           "commit_ms_median": {"m0": statistics.median(
               s["commit_ms"] for r in m0.values() for s in r["steps"][1:]),
               "m2": statistics.median(s["commit_ms"] for r in done2 for s in r["steps"][1:])},
           "kill_to_first_step_s": first2 - kill_at,
           "kill_split_s": {"harness": wall_m2 - kill_at, "launch": r2["t_proc"] - wall_m2,
                            "init": r2["init_s"], "model": r2["built_s"] - r2["init_s"],
                            "restore": r2["resume"]["restore_s"],
                            "sync": r2["resume"]["sync_s"],
                            "first_step": first2 - r2["resume"]["t"]},
           "drain_manifest_shards": len(drain_man["shards"]),
           "drain_notice_to_exit_s": dr["exit_at"] - dr["notice_at"],
           "drain_exit_to_first_step_np3_s": first3["t"] - dr["exit_at"],
           "drain_commit_s": dr["drain_s"], "dirs": clean, "c7": c7}
    emit(rec)
    return rec


def kernels_line(k1, k2, k34, sl, rn, bert, zero, sp, moe, pp, tp, zm, ts, tm, pt,
                 later) -> list:
    """The ``kernels`` line from the phases' records: each kernel's
    launches on the GPT-2 slice (and per path), error, times and bound.
    ``later``: the records of the vit, vit_multi, mnist, mnist_multi,
    adasum_1p3b_multi, pp_tp, pp_tp_multi, pp_sp, pp_sp_multi, fsdp_sp,
    fsdp_sp_multi, fsdp_moe, fsdp_moe_multi, engine,
    engine_multi, elastic, elastic_multi, durable, durable_multi, metrics
    and metrics_multi phases by name (launches "not measured" where a phase
    had too few cards; the elastic, durable and metrics phases' are a
    worker's per attempted step)."""
    kernels = [
        {"name": "flash_fwd", "launches": sl["launches"]["flash_fwd"],
         "max_abs_err": k1["o_max_abs_err"], "ms": k1["kernel_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "flash_bwd_dkdv", "launches": sl["launches"]["flash_bwd_dkdv"],
         "max_abs_err": max(k2["dk_max_abs_err"], k2["dv_max_abs_err"]),
         "ms": k2["dkdv_kernel_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["dkdv_bound_ms"], "bound_by": k2["dkdv_bound_by"],
         "library_ms": None, "library_pair_ms": k2["library_pair_ms"]},
        {"name": "flash_bwd_dq", "launches": sl["launches"]["flash_bwd_dq"],
         "max_abs_err": k2["dq_max_abs_err"], "ms": k2["dq_kernel_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["dq_bound_ms"],
         "bound_by": k2["dq_bound_by"], "library_ms": None,
         "library_pair_ms": k2["library_pair_ms"]},
    ]
    for accum in ("scratch", "revisit"):
        name = f"fused_bn_conv_{accum}"
        kernels.append({"name": name, "launches": rn["launches"][name],
                        "max_abs_err": k34[f"{accum}_max_abs_err"], "ms": k34[f"{accum}_ms"],
                        "plain_ms": k34["plain_ms"], "bound_ms": k34["bound_ms"],
                        "bound_by": k34["bound_by"], "library_ms": k34["library_ms"]})
    kb = bert["kernels_at_bert_shape"]
    for kern, part in zip(kernels[:3], ("fwd", "dkdv", "dq")):
        kern["launches_bert"] = bert["launches"][kern["name"]]
        kern["launches_zero"] = {v: rec["launches"][kern["name"]]
                                 for v, rec in zero["variants"].items()}
        kern["bert"] = {"shape": kb["shape"], "causal": False, "ms": kb[f"{part}_ms"],
                        "bound_ms": kb[f"{part}_bound_ms"],
                        "bound_by": kb[f"{part}_bound_by"],
                        "plain_ms": kb["fwd_plain_ms" if part == "fwd" else "bwd_plain_ms"],
                        "sdpa_ms": kb["sdpa_fwd_ms" if part == "fwd" else "sdpa_bwd_ms"]}
    def d128(records, part):
        return [
            {"shape": r["shape"], "causal": True, "ms": r[f"{part}_ms"],
             "bound_ms": r[f"{part}_bound_ms"], "bound_by": r[f"{part}_bound_by"],
             "plain_ms": r["fwd_plain_ms" if part == "fwd" else "bwd_plain_ms"],
             "library_ms": r["sdpa_fwd_ms"] if part == "fwd" else None,
             "library_pair_ms": None if part == "fwd" else r["library_pair_ms"],
             "plain_batch": r["plain_batch"],
             "max_abs_err": (r["o_max_abs_err"] if part == "fwd" else
                             max(r["dk_max_abs_err"], r["dv_max_abs_err"])
                             if part == "dkdv" else r["dq_max_abs_err"])}
            for r in records.values()]

    for kern, part in zip(kernels[:3], ("fwd", "dkdv", "dq")):
        kern["pp_d128"] = d128(pp["kernels_d128"], part)
        kern["tp_d128"] = d128(tp["kernels_d128"], part)
        kern["tp_sp_d128"] = d128(ts["kernels_d128"], part)
        kern["pp_tp_d128"] = d128(pt["kernels_d128"], part)
        kern["pp_sp_d128"] = d128(later["pp_sp"]["kernels_d128"], part)
    for kern in kernels:
        kern["launches_sp"] = sp["launches"].get(kern["name"], 0)
        kern["launches_moe"] = moe["launches"].get(kern["name"], 0)
        kern["launches_pp"] = pp["launches"].get(kern["name"], 0)
        kern["launches_tp"] = tp["launches"].get(kern["name"], 0)
        kern["launches_zero_mesh"] = {v: rec["launches"].get(kern["name"], 0)
                                      for v, rec in zm["variants"].items()}
        kern["launches_tp_sp"] = ts["launches"].get(kern["name"], 0)
        kern["launches_tp_moe"] = tm["launches"].get(kern["name"], 0)
        for phase, rec in later.items():
            got = rec["launches"]
            kern[f"launches_{phase}"] = got if isinstance(got, str) else got.get(
                kern["name"], 0)
        kern.update(route="cuda", source=SOURCE[kern["name"]], replaces=REPLACES[kern["name"]])
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card",
              file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import fused_bn_conv as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_card()
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(1234)
    k1, fwd_out = phase_k1(fa, gen, dev)
    k2 = phase_k2(fa, gen, dev, fwd_out)
    del fwd_out
    torch.cuda.empty_cache()
    k34 = phase_k34(fb, gen, dev)

    hvd.init()
    try:
        if hvd.device().type != "cuda":
            raise AssertionError(f"hvd.init() chose {hvd.device()}")
        phase_collectives(dev)
        en = phase_engine(dev)
        sl = phase_slice(fa, fb)
        torch.cuda.empty_cache()
        rn = phase_resnet(fa, fb)
        bert = phase_bert(fa, fb, gen)
        zero = phase_zero(fa)
        full_precision_products()
        plan = durable_plan(dev)
        el, el_final, el_a = phase_elastic(fa)
        me = phase_metrics(el_a, el)
        du = phase_durable(plan, el_final)
        el_multi = phase_elastic_multi()
        me_multi = phase_metrics_multi()
        du_multi = phase_durable_multi(plan)
        gc.collect()
        torch.cuda.empty_cache()
        sp = phase_sp(fa, gen, dev)
        moe, moe_grads = phase_moe(fa, fb)
        if torch.cuda.device_count() >= 2:
            phase_sp_multi(fa, fb, moe, moe_grads)
        del moe_grads
        gc.collect()
        torch.cuda.empty_cache()
        pp, pp_grads = phase_pp(fa, fb, gen, dev)
        if torch.cuda.device_count() >= 2:
            phase_pp_multi(pp, pp_grads)
        else:
            emit({"phase": "pp_multi", "cards": torch.cuda.device_count(),
                  "result": "not measured: needs two cards or more"})
        gc.collect()
        torch.cuda.empty_cache()
        tp = phase_tp(fa, fb, gen, dev, pp, pp_grads)
        multi = torch.cuda.device_count() >= 2
        f32 = f32_control(hvd, fa, fb) if multi else None
        if multi:
            phase_tp_multi(pp, pp_grads, f32)
        else:
            emit({"phase": "tp_multi", "cards": torch.cuda.device_count(),
                  "result": "not measured: needs two cards or more"})
        gc.collect()
        torch.cuda.empty_cache()
        zm = phase_zero_mesh(fa, fb, pp, pp_grads)
        if multi:
            phase_zero_mesh_multi(pp, pp_grads, f32)
        else:
            emit({"phase": "zero_mesh_multi", "cards": torch.cuda.device_count(),
                  "result": "not measured: needs two cards or more"})
        gc.collect()
        torch.cuda.empty_cache()
        pt = phase_pp_tp(fa, fb, gen, dev, pp, pp_grads)
        pt_multi = phase_pp_tp_multi(pp, pp_grads, f32)
        del pp_grads, f32
        gc.collect()
        torch.cuda.empty_cache()
        ts, ts_controls = phase_tp_sp(fa, fb, gen, dev)
        phase_tp_sp_multi(ts_controls)
        ps_multi = phase_pp_sp_multi(ts_controls)
        fs_multi = phase_fsdp_sp_multi(ts_controls)
        del ts_controls
        gc.collect()
        torch.cuda.empty_cache()
        ps, ps_control = phase_pp_sp(fa, fb, gen, dev)
        fs = phase_fsdp_sp(fa, fb, ps_control)
        del ps_control
        gc.collect()
        torch.cuda.empty_cache()
        tm, tm_controls, tm_bare = phase_tp_moe(fa, fb)
        tm_multi = phase_tp_moe_multi(tm_controls)
        fm_multi = phase_fsdp_moe_multi(tm_controls, tm_multi)
        del tm_controls
        gc.collect()
        torch.cuda.empty_cache()
        fm = phase_fsdp_moe(fa, fb, tm_bare)
        del tm_bare
        gc.collect()
        torch.cuda.empty_cache()
        later = {"vit": phase_vit(fa, fb), "vit_multi": phase_vit_multi(fa, fb),
                 "mnist": phase_mnist(fa, fb), "mnist_multi": phase_mnist_multi(),
                 "adasum_1p3b_multi": phase_adasum_1p3b_multi(), "pp_tp": pt,
                 "pp_tp_multi": pt_multi, "pp_sp": ps, "pp_sp_multi": ps_multi,
                 "fsdp_sp": fs, "fsdp_sp_multi": fs_multi, "fsdp_moe": fm,
                 "fsdp_moe_multi": fm_multi, "engine": en,
                 "engine_multi": phase_engine_multi(), "elastic": el,
                 "elastic_multi": el_multi, "durable": du, "durable_multi": du_multi,
                 "metrics": me, "metrics_multi": me_multi}
        phase_adasum_combine(dev)
    finally:
        hvd.shutdown()

    emit({"kernels": kernels_line(k1, k2, k34, sl, rn, bert, zero, sp, moe, pp, tp, zm,
                                  ts, tm, pt, later)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
