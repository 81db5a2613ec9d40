#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built for CUDA, and
imports nothing of JAX or of the JAX package. Phases, each fatal on
failure:

1. the card: its name and power limit as ``nvidia-smi`` reports them;
2. build: every hand-written kernel from ``tensorflowonspark_tpu_torch/
   csrc/`` with ``nvcc`` (one process per source, started together);
   the ptxas spill bytes of each tensor-core instantiation (the bf16
   flash forward, fused backward, split dK/dV and split dQ at padded head
   widths 64 and 128, and the wgmma body of GELU->matmul and of
   LN->matmul; none may spill)
   and their ``HGMMA`` / ``HMMA`` / ``FFMA`` counts from ``cuobjdump
   -sass`` (each must show HGMMA);
3. kernels against their plain PyTorch versions on the card, at the
   shapes the serving and training paths give them, with times (CUDA
   events), the least time the card could take (``bound``) and one
   PyTorch library call computing the same function as a yardstick: the
   LayerNorm and flash-attention forwards, then their backwards (each run
   twice and required to give the same bits), then the fused LN->matmul
   and GELU->matmul products (their yardstick is the unfused pair of
   library calls; each case logs the body its dispatcher runs, bf16 with K
   and N multiples of 8 on wgmma, is run twice and must give the same
   bits; their device time from ``torch.profiler`` is taken at the end of
   6c, so that no profiler session precedes the serving run, where the
   profiled kernel's name must be that body's instantiated for the op's
   prologue; the LayerNorm kernels' device times, the backward's pass 1
   and pass 2 apart, and the yardstick's, are taken there too),
   LayerNorm rows wider than 8192 and fused products whose K and N are
   not multiples of 8; (3b) head dims other than 64 and 128: the
   forward, the fused backward and the split backward at head_dim 32 and
   96 (bf16 and f32; MHA, grouped, a window, a ragged offset block)
   against their plain versions, timed beside SDPA;
4. the serving main path at full width: the flagship
   ``TransformerConfig()`` (vocab 32000, 12 layers, 12 heads, d_model
   768, d_ff 3072, bf16) with random weights from a seed, served by
   ``ServingEngine(num_slots=8, horizon=4)``: 16 requests of 17-600
   prompt tokens, 32 new tokens each. The kernels' launch counts are
   zeroed just before and read just after, and must show both forward
   kernels on the path; then (4b) one decode dispatch and one 512-token
   prefill chunk under ``torch.profiler``: device-busy time against the
   host's wall clock, the top kernels and every port kernel's device time;
5. serving parity: the same model in f32 (TF32 off) — every engine
   output must equal the single-request ``greedy_generate_kv`` decode, or
   differ only at a genuine near-tie (top-2 logit gap under 1e-4);
6. the training main path at full width: the same model and weights
   (f32 master weights, bf16 compute, remat), ``make_optimizer(3e-4,
   clip_norm=1.0)``, one fixed 16 x 1024 token batch: 2 warm-up steps, 4
   ``make_train_step`` steps, then one ``make_train_loop(unroll=4)`` slab.
   Losses must be finite and fall, and each path must launch exactly 24
   flash forwards, 12 flash backwards, 49 LayerNorm forwards and 25
   LayerNorm backwards per optimizer step (and no fused product); prints
   tokens/s, ms per step, peak memory and one step under
   ``torch.profiler``; (6b) the grouped-KV configuration
   (``num_kv_heads=4``) takes a warm-up and 2 timed steps at 8 x 1024 and
   must launch the grouped flash backward 12 times per step; (6c) the
   all-fused flagship (``fuse_qkv`` + ``ln_matmul_impl="fused"`` +
   ``act_matmul_impl="fused"``, ``bench.py``'s ``b16_s1024_allfused``)
   runs like 6 with exactly 48 LN->matmul, 24 GELU->matmul, 24 flash
   forwards, 12 flash backwards and one LayerNorm forward and backward
   per step, beside 6's numbers; then its grouped-KV variant like 6b;
   [6b] also profiles one grouped step (the grouped flash backward's
   device time in a step);
   (6d) long-context grouped-KV training through the port's
   ``examples/train_gpt.py``: a handful of seeded TFRecord files of token
   rows are written with the port's writer under ``build/``, then the
   flagship with ``num_kv_heads=4`` at B1 x S16384 reads them through the
   FILES-mode pipeline and ``device_prefetch`` — a warm-up and 2 timed
   steps with exactly 24 flash forwards, 12 split dQ and 12 grouped split
   dK/dV backwards (the reference's plan rule sends this length to the
   split plan), no fused flash backward, 49 LayerNorm forwards and 25
   backwards per step, then one profiled step; (6h) the same
   configuration through the port's cluster runtime:
   ``cluster.run(LocalEngine(num_executors=1), main_fn, tf_args,
   input_mode=InputMode.TENSORFLOW, chips_per_node=1, max_restarts=0)``
   brings up one executor through the rendezvous, gives it one card
   (``CUDA_VISIBLE_DEVICES`` from ``nvidia-smi``), and the executor
   trains ``train_gpt`` 4 steps from 6d's files with exactly 6d's launch
   counts per step, finite losses and no supervisor restart; then, on the
   same engine, a main fn that raises must bring its traceback to
   ``shutdown()``, and a bring-up asking for one card more than
   ``nvidia-smi`` counts must fail before the fn runs, naming the count;
   the engine-start, reservation and shutdown seconds and the ms/step
   beside 6d's are logged; (6k) 6d's configuration checkpointed and
   resumed: the driver trains it 5 steps from 6d's files through
   ``checkpointable_input`` and ``device_prefetch``, then
   ``cluster.run(LocalEngine(1, env={"TOS_CHAOS_KILL": "train-step@0#3"}),
   ..., InputMode.FILES, max_restarts=1)`` runs the same steps in an
   executor that saves each step through ``ctx.checkpoint_manager`` (with
   the input position of the batch the step consumed), is SIGKILLed by
   the kill point after step 2 is durable, is relaunched by the
   supervisor, resumes at step 3 and exports its weights with
   ``ctx.export_model``: exactly one restart, the 5 losses equal to the
   driver's to the bit, the export's ``params_fingerprint`` equal to the
   driver's final weights', 6d's launch counts in every step; the bytes
   of one checkpoint, the save, restore and kill-to-resume seconds and
   the ms/step of each incarnation are logged; (6i) [6]'s training fed through the engine
   feed plane: the driver first runs 4 steps through the per-step path of
   ``make_train_loop(unroll=4)`` and 2 of its slabs on 192 seeded int32
   token rows
   (B16 x S1024, from a plain iterator), then ``cluster.run(LocalEngine(
   num_executors=1), main_fn, args, input_mode=InputMode.SPARK,
   chips_per_node=1, max_restarts=0)`` (transport "auto": the shm ring)
   and ``Cluster.train`` feed the same rows in 6 partitions of 32 to an
   executor that runs the same steps from ``device_prefetch(feed_batches(
   feed, 16))`` and ``slab_batches(feed, 16, unroll=4)``, and the driver
   runs them directly once more: exactly [6]'s launch counts per step,
   the 12 losses equal to both direct runs' to the bit, every chunk columnar, the input carried by the ring, no restart;
   ms/step of both, one profiled step of each, the feed's fetch / decode
   / assemble ms per batch and the cluster seconds are logged; then the
   feed's own ceiling, 1024 rows (4 MiB) drained onto the card with no
   step, on the shm ring and on the hub queue; then a consumer that fails
   after its first batch must bring its traceback to ``train`` or
   ``shutdown()``; (6j) ``Cluster.inference`` of 64 rows in 4 partitions
   of 16: the executor runs the bf16 forward at full width per batch
   (exactly 12 flash forwards and 25 LayerNorm forwards each) and returns
   one (mean next-token loss, last-position argmax) per row, which must
   equal the driver's forward on the same batches, in partition order;
   (6o) the observability plane: (a) 6i's fed run again with
   ``TOS_OBS=1`` and ``TOS_OBS_DIR`` under ``build/``, fatal unless its
   12 losses and per-step launch counts equal 6i's, the driver's sink
   aggregates ``feed.rows`` = ``feed.wire_rows`` = 192 and
   ``train.steps`` = 12, ``device.peak_bytes`` lies within 1% below the
   executor's ``max_memory_allocated``, ``xla.compiles`` does not move
   after each path's first step, no shipper failed or lost a span and
   the sink dropped none, a ``HEALTH`` request mid-run carries the
   executor's obs summary, the detector raised no alert, and the merged
   JSONL logs give a Chrome trace with driver, executor and feeder tracks,
   6 ``train.slab`` and 6 ``feed.batch`` spans (192 rows), every executor
   span inside the driver's ``cluster.run`` window; the feed's fetch /
   decode / assemble shares, ms/step on and off and MFU are logged; (b)
   [4]'s 16 requests with the port's registry and recorder on in the
   driver: outputs equal to [4]'s to the bit, ``serve.completed`` 16,
   ``serve.tokens`` + ``serve.prefills`` = the tokens generated, one
   ``serve.decode`` span per dispatch, the ``serve.ttft_ms`` sketch's p50
   and p99 within its rank error of the exact TTFTs, no SLO burn with
   ``TOS_SLO_TTFT_MS`` above the worst, and ``prometheus_text`` of the
   registry parsing line by line;
   (6p) the serving fleet, in the driver on the one card: (a) [4]'s 16
   requests through a bare ``ServingEngine(num_slots=8, horizon=4)`` (its
   outputs equal to [4]'s in the full run); (b) the same through
   ``ServingFleet(factory, num_replicas=2)`` of [4]'s engines, both on the
   card, with the registry on: every output equal to (a)'s to the bit,
   both replicas prefilling requests, exactly 12 flash forwards a prefill
   (192, as in (a)) and 25 LayerNorm forwards a forward (the prefill
   chunks, as in (a), plus both replicas' decode steps), the ``fleet.*``
   counters and gauges the detector and the SLO tracker read (16
   submitted, dispatched and completed, nothing rejected, shed or failed
   over, 2 of 2 replicas active, queue and occupancy 0) and no alert from
   the detector; (d) the 16 again with ``rolling_swap`` to a factory of
   the same weights while they are in flight: 2 replicas swapped, all
   drained, nothing shed, outputs equal to (a)'s; (c) a fresh fleet under
   ``TOS_CHAOS_FLEET=dispatch@1#3:kill``: request 0 lands on replica 0,
   request 1 on replica 1 and is read through ``stream()``; after its 2nd
   token the other 14 are submitted, and replica 1's 3rd dispatch consult
   kills it with request 1 mid-decode: replica 1 ejected, failovers >= 1,
   shed 0, replay mismatches 0, the detector raising ``fleet_degraded``,
   every output equal to (a)'s, and the stream giving each of request 1's
   32 positions once across its hop from replica 1 to 0; (e) a bare engine
   under ``TOS_CHAOS_SERVE=decode#3:raise``: exactly one restart, the
   in-flight requests replayed, outputs equal to (a)'s. Logged beside the
   card's name and power limit: tokens/s and TTFT p50 / p99 of (a) and
   (b) (two replicas share one card and one host process), the seconds
   from the kill to the last replayed completion, the swap's seconds and
   the peak memory with one and with two replicas;
   (6q) the registry, the deploy controller and cross-host serving:
   v1 (seed 0) published to a ``ModelRegistry`` with ``cfg_wire(cfg)``
   and [4]'s engine options in its manifest; two ServingHost processes
   (spawned; each builds its engine on the card from the registry) and a
   ``ServingFleet(remote_engine_factory(plane), num_replicas=2,
   health_probe=wire_health_probe(addr))`` behind a rendezvous server
   with the serving plane attached; (a) [4]'s 16 requests across the
   wire: every output equal to a bare engine's on v1 in the driver to the
   bit, both hosts prefilling, the hosts' summed launches exactly 12
   flash forwards a prefill and 25 LayerNorm forwards a forward (each
   host process counts its own, zeroed and read through files in the
   phase's temp dir), none in the driver, the ``fleet.*`` counters exact
   and no alert; (b) v2 (seed 1) published and driven through
   ``DeploymentController``: CANARY on host 0, VERIFY with 2 parity spot
   checks against a bare engine on v2 in the driver (one request at a
   time), PROMOTE: shed 0, one promotion, no rollback, then [4]'s first 8
   equal to the bare v2 engine's to the bit with both hosts on v2; (c)
   v3 (seed 2) under ``TOS_CHAOS_DEPLOY=canary:poison``: the poisoned
   params (staged for the host, which builds versions from the registry)
   fail VERIFY's parity, the controller rolls back, v3 is quarantined,
   ``latest()`` stays 2, [4]'s first 8 equal v2's to the bit with shed 0, and
   the detector, read as the controller's SLO source, raises
   ``canary_degraded``; (d) a fresh pair with
   ``TOS_CHAOS_HOST=decode@1#3:kill`` in host 1's env: request 1 lands
   on host 1 and is read through ``stream()``, host 1 SIGKILLs itself on
   its 3rd sync round with requests in flight (exit -9), its replica is
   ejected after ``TOS_HOST_TIMEOUT``, every output equals (a)'s, shed
   0, replay mismatches 0, the stream gives each of its 32 positions once
   across the hop, and the detector raises ``host_lost``. Logged beside
   the card's name and power limit: tokens/s and TTFT p50 / p99 against
   the bare engine's, the hosts' peak memory, the seconds from publish to
   promoted and from the kill to the last replayed completion;
   (6l) data parallelism across processes: (6l-a) [6]'s steps (2 warm-up,
   4 ``make_train_step``, one unroll-4 slab, one profiled) with no mesh
   and then over the data axis of a 1-rank NCCL group
   (``build_mesh(MeshSpec(data=-1))``, ``create_sharded_state``): the
   losses equal to the bit, [6]'s launch counts on both, one bucketed
   all-reduce per gradient bucket a step moving every weight's f32
   gradient (and one for the losses), both paths' ms/step and the
   all-reduce's device time in the profiled step; (6l-b) ``cluster.run(
   LocalEngine(num_executors=2), ..., InputMode.FILES, chips_per_node=0,
   max_restarts=0)``: both executors on the one card join a gloo group
   (NCCL refuses two ranks on one card) and run ``train_gpt``'s pieces at
   full width with ``--batch 16 --dp 2`` (4 steps, then an unroll-2 slab)
   from seeded TFRecord files, against the same flags at ``--dp 1`` in the
   driver: equal losses and weights' prints on both ranks, [6]'s launch
   counts per step on each, no restart, every loss within 2e-3 relative of
   the 1-process run's; each rank's ms/step (labelled: gloo over the host,
   two ranks sharing one card), all-reduce seconds a step and peak memory;
   each rank then holds ``psum_mean``, ``all_reduce``, ``all_gather``,
   ``reduce_scatter`` and ``broadcast_from`` on CUDA tensors over gloo to
   their exact values; then NCCL's answer to a 2-rank group on one card, untimed; (6l-c)
   ``Cluster.train`` feeds 88 seeded rows in partitions of 48 and 40 to
   two ranks training B8 each from ``next_batch_synced(8)``: both stop
   after 5 steps, having trained exactly the vote-passed batches, with
   equal weights, and the driver's one-process steps on each step's global
   batch (reassembled from the row ids the ranks wrote) give losses within
   2e-3;
   (6s) the mesh axes fsdp, sequence and tensor: the flash kernels at the
   ring's block cases (q ``[1, 8192, 12, 64]`` against an 8192-key block
   wholly in the past, on the diagonal, wholly in the future; Hk 4 and
   12; every backward with an lse cotangent on every row) and LN->matmul
   and GELU->matmul at ``--tp 2``'s local widths, each against its plain
   version, timed, with its bound and the SDPA / two-call yardstick; a
   future block must give out 0, lse -1e30 and zero gradients in under a
   fifth of the past block's time. Then ``train_gpt``'s pieces in spawned
   ranks that share the card over gloo (NCCL refuses two ranks on one
   card), each case against the same flags in one process on the same
   batches and weights: (a) ``--sp 2`` on 6d's B1 x S16384 Hk 4 from its
   TFRecords under the split backward, (b) ``--tp 2 --fused``, (c)
   ``--fsdp 2`` at B16 x S1024, 12 layers, on 2 ranks; (d) ``--sp 2 --tp
   2`` at 2 layers on 4 ranks. 3 bf16 steps (the last profiled): every
   rank's losses equal, within 2e-3 relative of one process's, exact
   launch counts per rank and step; the same at 2 layers in f32 under SGD:
   losses within 1e-5, the first step's gradients within 1e-5 of each
   tensor's largest and the final gathered weights within 1e-5; (c) a
   rank's weights and optimizer state exactly half one process's but the
   whole LayerNorm scales; each rank's ms a step, device-busy ms, peak
   memory and collectives a step (``collectives.COUNTS``), labelled: gloo
   over the host, ranks sharing one card. The ranks are spawned before the
   one-process runs and pay their imports and the device tracer's start
   while they wait; a rank's profiled step records the device alone;
   (6t) the pipeline and expert axes, as more jobs of 6s's rank groups,
   each against one process on the same batches and weights (full width,
   bf16): (a) ``train_gpt --pp 2 --microbatches 4`` (12 layers, B16) and
   (b) MoE layers (8 experts, top-2, every 2nd layer; B8, 12 layers) on
   ``MeshSpec(expert=2)`` through ``create_sharded_state`` +
   ``make_train_step`` on 2 ranks; (c) ``--pp 2 --dp 2 --microbatches 4
   --fused --kv_heads 4 --layers 4`` and (d) MoE on ``MeshSpec(expert=4)``
   with the all-to-all dispatch at capacity factor 4.0 (E/k: nothing may
   drop), 2 layers, B8, on 4 ranks; 6s's gates, with launch counts per
   pipeline stage, the embedding on stage 0 alone and the loss on the last
   stage alone, the permutes and all-to-alls a step, and (b)/(d) a rank's
   expert weights and moments a half / a quarter of one process's; the
   MoE cases hold their first f32 step's update at 6s's 1e-4 and the
   3-step update within 1e-5 (past the first step, an expert unit's
   pre-ReLU activation within ~1e-6 of zero may take the other sign in
   one process than on the ranks: the routing log below shows it), and
   their f32 runs log every routing decision of steps 1-3 on each rank
   and in one process (each token's top-2 experts and its 2nd-to-3rd
   router gap): where the two first differ, and each differing token's
   id, target, experts and gaps. (e)
   one process: (b)'s model in f32 decodes 4 prompts x 16 tokens with
   ``greedy_generate_kv``, exact launches, each token the argmax of the
   non-cached forward (near-ties aside);
   (6v) checkpoints of cut states, as more work of 6s's and 6t's jobs:
   after its bf16 steps every rank of (b) ``--tp 2 --fused``, (c)
   ``--fsdp 2`` and 6t's (d) MoE on ``expert=4`` calls
   ``CheckpointManager.save`` (the ranks gather, rank 0 writes the whole
   state); (a) each of (b) and (c)'s ranks restores its own checkpoint
   into a state of zeros and takes the next step, and one card restores
   it (the weights on disk bitwise the ranks' ``gather_state_params``)
   and takes the same step: within 2e-3 of the ranks'; (b) (b)'s ranks
   restore its checkpoint onto ``--fsdp 2`` and take the step, within
   2e-3; (c) one card restores the MoE checkpoint and every expert
   weight and moment equals each rank's block bitwise; (d)
   ``compat.export_model`` of (b)'s state on both ranks, imported into a
   one-card serving Transformer whose ``greedy_generate_kv`` of 4 x 16
   tokens (exact launches of rows 1 and 2) equals the gathered weights'
   model token for token; bytes, gather / host / write / commit and
   restore seconds and [6v]'s seconds are logged;
   (6w) serving over a mesh, on [6v]'s ranks (sharing the card over
   gloo) right after their saves: (a) (b)'s export cut onto a
   ``tensor=2`` serving mesh decodes [6v](d)'s 4 prompts of 128 tokens x
   16 in bf16: first-step logits within 3e-2 of max |logit| of one
   card's, tokens one card's up to a first near-tie under that bound,
   exactly 12 flash forwards and 400 LayerNorm forwards a rank; (b) the
   same weights in f32 (TF32 off), tokens one card's up to a near-tie
   under 1e-4; (c) (d)'s whole MoE checkpoint on ``data=2 x expert=2``
   in f32, tokens one card's up to such a near-tie; every rank's tokens
   alike; (d) ``serve_gpt --tensor 2`` (2 executors, each serving over a
   2-rank serving group) serves the rows of ``--tensor 1``, and every
   follower seen is gone 30 s after the engine stops;
   (6u) elastic multi-group training (``parallel.groups``), after 6l on
   its LocalEngine(2): groups are threads of the driver sharing the card's
   stream. (a) 2 groups of the flagship at B16 x S1024 with sync off, 4
   steps each: each group's losses equal its batches run alone through one
   ``TrainLoop`` to the bit, launches exactly twice one group's, ms a step
   beside one alone; (b) the widest Transformer whose packed f32 weights
   fit one rendezvous frame (vocab 2048, d_model 128, 2 heads of 64, d_ff
   512, 2 layers; B8 x S256), 2 groups synced every 4 of 16 steps: after
   each round both groups hold the same bits, the f64 weighted mean of the
   two pre-sync weights recomputed here; 4 rounds, exact launches, the
   loss falls; the sync's ms and its overhead in paired synced / unsynced
   runs; (c) ``TOS_CHAOS_GROUP=kill@1#2`` (sync_timeout 1 s, miss_limit
   2, 24 steps): group 0 completes with denominator 1, group 1 lost,
   HEALTH carries ``groups``, the detector fires ``group_lost`` under
   ``TOS_OBS=1``, then ``readmit(1)`` catches up past step 20 and
   completes; (d) ``stall@1#1:2.0`` (0.5 s, miss_limit 1): the straggler
   is evicted and re-admits itself; (e) saved at 2 groups, restored at 3
   and at 1: next step 9, the saved bits in every group, the chief's
   losses equal across the two; (f) ``cluster.run(..., group_map={0: 0,
   1: 1}, elastic=True, max_restarts=0)``, each executor training (b)'s
   model on the card through a ``GroupSyncClient``, executor 1 SIGKILLed
   mid round 2: ``resize-shrink`` for group 1, executor 0 finishing with
   denominator 1, ``shutdown()`` not raising;
   (6m) the pipeline layer on one ``LocalEngine(num_executors=2)`` whose
   executors share the card: (a) ``TFEstimator.fit`` (InputMode.SPARK)
   feeds 4 partitions of 24 seeded token rows; each node trains the
   flagship at full width 3 steps of B8 x S1024 from ``next_batch_arrays``
   (exactly [6]'s launches a step on both), then ``terminate()``s its
   feed, and the chief exports a bundle (the bf16 serving weights,
   ``make_serving_predict_fn(cfg, 32)``, a signature); (b)
   ``TFModel.transform`` (``chips_per_node=1``: both executors claim card
   0) of 2 partitions of 16 prompts of 128 tokens, batch 8, collected:
   every row equal to the driver's ``greedy_generate_kv`` on the weights
   from ``load_bundle`` (the same 8-row batches) to the bit, and each
   executor launching 12 flash and 25 LayerNorm forwards a prefill (800
   LayerNorm forwards a batch); (c) one partition of 16 prompts of 17-600
   tokens, lazy (``collect=False``): equal to the driver's
   ``ServingEngine`` at the same slots to the bit, the executor's engine
   cache built once and hit on the second batch; (d) sampled serving at T
   0.8, top-40: two serves of one batch differ, every token lies in its
   step's top 40 (replayed through the same decode path), top-1 equals
   greedy in every row whose maxima never tied; (e) ``runner.run(...,
   use_barrier=True, chips_per_node=1)`` of 2 tasks, each serving its
   shard through the bundle on the card: rows equal to (b)'s, both ctxs
   carrying the same 2 addresses; (f) ``dfutil.save_as_tfrecords`` on
   the executors writes (b)'s prompts, which read back with their
   inferred schema, and ``python -m tensorflowonspark_tpu_torch.
   inference_cli --num_executors 1`` over them writes JSONL lines, named
   by the signature, equal to (b)'s rows; (g) the port's
   ``examples/serve_gpt.py`` at its defaults, ``mnist_pipeline.py`` and
   ``mnist_parallel_inference.py`` at 512 samples, started together as
   subprocesses, each exiting 0;
   (6e) the flagship MHA at
   B16 x S1024 like 6 under ``TFOS_TPU_FLASH_BWD=split`` (12 dQ + 12 dK/dV
   per step, no fused backward), beside 6's fused plan; (6f) the port's
   ``train_gpt`` at its default model flags (4 layers, d_model 256, 8
   heads: head_dim 32, seq 512, vocab 1024, batch 8) through its ``run``
   from seeded TFRecord files: finite losses and exactly 8 flash
   forwards, 4 fused flash backwards, 17 LayerNorm forwards and 9
   backwards per step; (6g) one request through ``ServingEngine`` at the
   JAX package's ``serve_gpt.py`` config (2 layers, 4 heads, 2 KV heads,
   d_model 128: head_dim 32), in bf16 with launch counts and in f32
   equal to ``greedy_generate_kv``;
7. training parity: one f32 step (TF32 off) of a 2-layer full-width model
   on 2 x 256 tokens, unfused and all-fused, and under the split plan MHA
   and grouped-KV, on the card with the kernels and on the CPU with the
   plain versions: the loss to 1e-4 relative, every gradient within 1e-3
   of its largest magnitude;
   (6r) the decode-speed stack at [4]'s full width, on [4]'s weights with
   the out and down projections of layers 3-11 scaled by 0.005 (the
   reference serve_bench's ``_soften_exit_layers``: a random network's
   shallow self-draft would accept ~1/vocab): 32 requests, each one of 4
   system prompts of 512 tokens (Zipf-drawn) plus a Zipf-drawn tail of
   8-64 tokens, 32 new tokens each, horizon 4, through five warmed engines
   timed over the whole workload: ``baseline`` (8 slots, contiguous),
   ``paged`` (16 slots, 16-token pages, 1025 pages: the contiguous slab's
   bytes), ``paged_prefix`` (and a 256-page prefix cache), ``full_stack``
   (and ``spec_depth=4``, ``spec_layers=3``) and ``int8`` (8 slots,
   ``kv_cache_dtype="int8"``). Gates: (a) in f32 (TF32 off) every leg's
   outputs on the first 8 requests at 16 new tokens equal the
   single-request ``greedy_generate_kv`` of its config, or differ first at
   a near-tie (top-2 gap under 1e-4, measured along the reference's own
   decode path); a later chunk of an int8 prefill attends the quantized
   cache, so the timed int8 engine (default buckets) is held against
   greedy decoding whose prefill runs in the engine's own chunks, and an
   int8 engine that prefills each prompt in one chunk against
   ``greedy_generate_kv`` itself; (b) the paged pool's KV bytes within a page of the
   contiguous slab's, the int8 leaves int8 with f32 scales, the int8 slab
   at most 0.55 of the bf16 slab's bytes; (c) in each leg 12 flash
   forwards a prefill not resumed from a prefix hit, and 25 LayerNorm
   forwards a full forward plus 7 a draft forward (forwards counted by a
   pre-hook on the engine's model); (d) a paged engine at 8 slots gives
   baseline's outputs to the bit on the first 8 requests, paged_prefix
   records at least 28 prefix hits, full_stack accepts draft tokens, and
   after the last completion the pool holds exactly the trie's pages; (e)
   the full_stack engine under ``TOS_CHAOS_SERVE=decode#3:raise``, armed
   after its warm-up: one restart, outputs equal to its fault-free run's
   to the bit, no replay mismatch, the rebuilt pool balanced. Logged for
   each leg beside the card's name and power limit: tokens/s, TTFT p50 and
   p99, decode ms a dispatch, prefills, prefix hits and evictions, pages
   in use at peak, the spec acceptance rate, peak memory, KV bytes and the
   share of requests equal to baseline's tokens.

Phase 3 also holds the flash forward at the long-context shape B1 x
S16384 (Hk 4) against its plain version on three 512-row chunks (the
last included), and the split backward's dQ and dK/dV kernels against
their plain versions (each twice, bitwise) at 6's cases, a long grouped
window and the long-context shape, where they are also held against the
fused kernel and timed beside it; it ends with one line per redesigned
tensor-core kernel: ms, the factor over SDPA (forward), SDPA's whole
backward (the fused backward, dK/dV, dQ) or the ``F.gelu`` + matmul pair
(GELU->matmul), and the share of the bound. [3b] also runs the split
backward twice at each head dim and requires the same bits.

The last two lines of output are JSON: ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. A copy of the measurements goes to
``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --layer-norm-only`` runs phases 1, 2 and phase
3's LayerNorm forward and backward checks with their device times, and
prints them as one JSON line; like ``--serving-only``, a copy run from
another checkout's root measures that checkout's kernels.

``python3 chip_smoke.py --cluster-only`` runs phases 1 and 6h alone (6d's
TFRecord files are written first; the executor builds each kernel at its
first use) and prints its measurements as one JSON line.

``python3 chip_smoke.py --ckpt-only`` runs phases 1 and 6k alone (6d's
TFRecord files are written first) and prints its measurements as one JSON
line.

``python3 chip_smoke.py --dp-only`` runs phases 1 and 6l alone (the driver
builds each kernel at its first use, the executors load them) and prints
its measurements as one JSON line.

``python3 chip_smoke.py --pipeline-only`` runs phases 1 and 6m alone (the
driver builds every kernel first; the nodes and executors load them) and
prints its measurements as one JSON line.

``python3 chip_smoke.py --feed-only`` runs phases 1, 6i and 6j alone (the
driver builds each kernel at its first use, the executors load them) and
prints its measurements as one JSON line.

``python3 chip_smoke.py --obs-only`` runs phases 1 and 6o alone (the
driver builds every kernel first), with an obs-off fed run and an obs-off
serving run of its own as the references, then 3 more interleaved
off/on pairs of the fed run and the median obs overhead per step against
the 3% budget (reported, not gated), then (d) where an overhead would
come from: the host ms of one memory sample and one ship with the card
busy, and [6]'s per-step ms/step in the driver with the plane off, its
step seams alone, the seams and a shipper at ten times the default
cadence, and the seams and the memory sampler alone at that cadence,
interleaved; it prints its measurements as one JSON line.

``python3 chip_smoke.py --fleet-only`` runs phases 1 and 6p alone (the
driver builds every kernel first) at [4]'s sizes and prints its
measurements as one JSON line.

``python3 chip_smoke.py --deploy-only`` runs phases 1 and 6q alone (the
driver builds every kernel first; the host processes load them) at [4]'s
sizes and prints its measurements as one JSON line.

``python3 chip_smoke.py --decode-stack-only`` runs phases 1 and 6r alone (the
script builds every kernel first) and prints its measurements as one JSON
line.

``python3 chip_smoke.py --spmd-only`` runs phases 1, 2 and 6s alone (6d's
TFRecord files are written first; the ranks load the built kernels) and
prints its measurements as one JSON line; ``--pp-ep-only`` runs phases 1,
2 and 6t alone the same way.

``python3 chip_smoke.py --groups-only`` runs phases 1, 2 and 6u alone (6u's
cluster leg on a LocalEngine(2) of its own) and prints its measurements as
one JSON line.

``python3 chip_smoke.py --cut-ckpt-only`` runs phases 1, 2, the three cases
of 6s and 6t that 6v saves (with their one-process runs), 6v and 6w, and
prints their measurements as one JSON line; ``--serving-mesh-only`` runs
the two of them 6w serves from, 6v and 6w the same way.

``python3 chip_smoke.py --serving-ab OTHER_CHECKOUT N`` runs phases 1 and 2,
then phase 4 for the package of the checkout at OTHER_CHECKOUT (copied
under ``build/`` under another name) and this one in the same process,
alternated N times each way, and prints both sides' tokens/s as one JSON
line.

``python3 chip_smoke.py --serving-only N`` runs phases 1, 2 and 4 alone:
the serving main path N times in one process, then the host time of one
flash-forward wrapper call at the prefill chunks' shapes and the wall time
of a 512-token prefill chunk; it prints them as one JSON line. A copy of
this script run from another checkout's root measures that checkout's
package the same way, so two trees can alternate in one chip call.
"""

import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor cores
              "float32": 67e12}    # CUDA cores, no TF32
ELEMENTWISE_FLOPS = 67e12          # f32 arithmetic outside the tensor cores
LN_FLOPS_PER_ELEM = 8              # sum, centre, square, sum, scale x2, ...
LN_BWD_FLOPS_PER_ELEM = 20         # statistics, xhat, dy, two sums, dx, dw
SEED = 0


#: (monotonic time, tag) of each top-level phase's first line ("[6s] ...")
PHASE_STARTS = []


def log(*args):
  head = args[0] if args and isinstance(args[0], str) else ""
  if head.startswith("[") and "]" in head:
    tag = head[1:head.index("]")].split("-")[0]       # [6l-a] is [6l]'s
    if not PHASE_STARTS or PHASE_STARTS[-1][1] != tag:
      PHASE_STARTS.append((time.monotonic(), tag))
  print(*args, flush=True)


def cache_bytecode():
  """Keep the bytecode Python compiles under ``build/pycache`` for this
  run and every process it starts. Where the environment sets
  ``PYTHONDONTWRITEBYTECODE``, each fresh process (an executor, a rank,
  a host) would compile PyTorch's modules from source again, seconds a
  process, most of it at its first step or profiler session, where
  ``torch.utils.checkpoint`` and ``torch.profiler`` import
  ``torch._dynamo``."""
  prefix = os.path.join(HERE, "build", "pycache")
  os.makedirs(prefix, exist_ok=True)
  sys.pycache_prefix = prefix
  sys.dont_write_bytecode = False
  os.environ["PYTHONPYCACHEPREFIX"] = prefix
  os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def phase_seconds() -> dict:
  """Seconds from each top-level phase's first line to the next phase's,
  summed by phase: where the script's time limit goes."""
  out = {}
  ends = [t for t, _ in PHASE_STARTS[1:]] + [time.monotonic()]
  for (t0, tag), t1 in zip(PHASE_STARTS, ends):
    out[tag] = round(out.get(tag, 0.0) + t1 - t0, 1)
  return out


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True,
      timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs=25, inner=10):
  """Median over ``runs`` CUDA-event windows of ``inner`` back-to-back
  calls, per call, after a warm-up."""
  import torch
  for _ in range(3):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(runs):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
      fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end) / inner)
  return statistics.median(times)


# -- phase 2: what the tensor-core kernels compiled to -----------------------

# (library, substring of the mangled name, what it is, instantiations): the
# bf16 kernels that run their products on the tensor cores, the flash
# kernels at a padded head width of 64 and 128, the GEMM with its GELU and
# its LayerNorm prologue
TENSOR_CORE_KERNELS = (
    ("flash_attention", "flash_fwd_kernel_wgmma", "flash forward bf16",
     ("64", "128")),
    ("flash_attention_bwd", "flash_bwd_kernel_wgmma", "fused backward bf16",
     ("64", "128")),
    ("flash_attention_bwd_split", "flash_bwd_dkv_kernel_wgmma",
     "split dK/dV bf16", ("64", "128")),
    ("flash_attention_bwd_split", "flash_bwd_dkv_gqa_kernel_wgmma",
     "split grouped dK/dV bf16", ("64", "128")),
    ("flash_attention_bwd_split", "flash_bwd_dq_kernel_wgmma",
     "split dQ bf16", ("64", "128")),
    ("act_matmul", "prologue_gemm_wgmma", "GELU->matmul bf16", ("kGelu",)),
    ("ln_matmul", "prologue_gemm_wgmma", "LN->matmul bf16", ("kLayerNorm",)))
SASS_OPS = ("HGMMA", "HMMA", "FFMA")


def _cuobjdump():
  found = shutil.which("cuobjdump")
  if found:
    return found
  nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
  return os.path.join(os.path.dirname(nvcc), "cuobjdump")


def _prologue(symbol):
  """The prologue a fused-product kernel's symbol (mangled, or demangled
  as the profiler names it) was instantiated for: "kGelu", "kLayerNorm",
  or None for a symbol that names neither (``Prologue`` is an enum:
  kLayerNorm is 0, kGelu 1)."""
  for name, code in (("kLayerNorm", "0"), ("kGelu", "1")):
    if name in symbol or "PrologueE" + code in symbol \
        or "Prologue)" + code in symbol:
      return name
  return None


def _instance(mangled):
  """The template argument a mangled tensor-core kernel was built for:
  its padded head width, or its GEMM prologue."""
  return _prologue(mangled) or ("128" if "ILi128E" in mangled else "64")


def _is(part, mangled):
  """``mangled`` is the kernel ``part`` names (the MHA dK/dV entry is a
  prefix of the grouped one's)."""
  return part in mangled and (part != "flash_bwd_dkv_kernel_wgmma"
                              or "gqa" not in mangled)


def sass_counts(_build):
  """HGMMA / HMMA / FFMA instructions in each tensor-core kernel's SASS
  (``cuobjdump -sass`` of the built library), one line per
  instantiation. Fails if one has no HGMMA: their products must run on
  wgmma. The libraries are disassembled side by side (one ``cuobjdump``
  process each)."""
  from concurrent.futures import ThreadPoolExecutor
  libs = sorted({k[0] for k in TENSOR_CORE_KERNELS})

  def disassemble(lib):
    return subprocess.run(
        [_cuobjdump(), "-sass", str(_build.library_path(lib))],
        capture_output=True, text=True, timeout=300, check=True).stdout

  with ThreadPoolExecutor(len(libs)) as pool:
    texts = list(pool.map(disassemble, libs))
  out = {}
  for lib, text in zip(libs, texts):
    func = None
    for line in text.splitlines():
      if "Function :" in line:
        func = line.split("Function :", 1)[1].strip()
        continue
      if func is None or "*/" not in line:
        continue
      ins = line.split("*/", 1)[1].strip()
      if ins.startswith("@"):
        ins = ins.split(None, 1)[1] if " " in ins else ""
      op = ins.split(" ", 1)[0].split(".", 1)[0]
      if op in SASS_OPS:
        slot = out.setdefault((lib, func), dict.fromkeys(SASS_OPS, 0))
        slot[op] += 1
  rows = []
  for lib, part, what, insts in TENSOR_CORE_KERNELS:
    funcs = sorted(f for (l, f) in out if l == lib and _is(part, f))
    if sorted(_instance(f) for f in funcs) != sorted(insts):
      raise AssertionError("%s (%s) in the SASS of %s: %s, want %s"
                           % (what, part, lib, [_instance(f) for f in funcs],
                              list(insts)))
    for f in funcs:
      c = out[(lib, f)]
      rows.append({"kernel": "%s<%s>" % (part, _instance(f)), "what": what,
                   **c})
      log("  sass %-36s HGMMA %4d  HMMA %4d  FFMA %5d"
          % (rows[-1]["kernel"], c["HGMMA"], c["HMMA"], c["FFMA"]))
      if c["HGMMA"] == 0:
        raise AssertionError("%s: no HGMMA in %s" % (what, f))
  return rows


def tensor_core_spills(build_log):
  """Spill bytes of each tensor-core kernel from the ptxas report; fails
  on any spill."""
  spills = {}
  for lib, part, what, _ in TENSOR_CORE_KERNELS:
    if lib not in build_log:
      log("  %s: loaded from an earlier build, no ptxas report" % lib)
      continue
    func = None
    for line in build_log[lib].splitlines():
      if "Function properties for" in line:
        func = line.split("Function properties for", 1)[1].strip()
      elif "spill stores" in line and func and _is(part, func):
        words = line.replace(",", " ").split()
        stores = int(words[words.index("spill") - 2])
        loads = int(words[words.index("loads") - 3])
        spills["%s<%s>" % (part, _instance(func))] = stores + loads
  log("  spill bytes of the tensor-core kernels: %s" % spills)
  want = sum(len(insts) for lib, _, _, insts in TENSOR_CORE_KERNELS
             if lib in build_log)
  if len(spills) < want:
    raise AssertionError("ptxas reported %d of the %d tensor-core kernels"
                         % (len(spills), want))
  bad = {k: v for k, v in spills.items() if v}
  if bad:
    raise AssertionError("tensor-core kernels spill registers: %s" % bad)
  return spills


# -- phase 3: kernels against their plain versions ---------------------------


# (rows, H, dtype, tol): rows 8 = one decode step of 8 slots, 512 = the
# largest prefill chunk, 16384 = the training batch; H 770 takes the
# kernel's unvectorised path, H 12288 and 9001 the block-per-row kernel
# (rows wider than 8192; 9001 also unvectorised).
# Tolerances: f32 sums in another order (1e-5); bf16 outputs may round
# one ulp apart (2e-2 at |y| <= 4).
LN_CASES = ((8, 768, "bfloat16", 2e-2), (512, 768, "bfloat16", 2e-2),
            (8, 768, "float32", 1e-5), (512, 768, "float32", 1e-5),
            (33, 770, "bfloat16", 2e-2), (16384, 768, "bfloat16", 2e-2),
            (256, 12288, "bfloat16", 2e-2), (64, 9001, "float32", 1e-5))
# (rows, H, dtype, tol): 16384 rows = the training batch B16 x S1024, and
# 16387 rows, not a multiple of the rows a block holds; H 770 takes the
# unvectorised path, H 12288 and 9001 the block-per-row kernel. dx: bf16
# output rounding (one ulp, 2^-8 relative) or f32 sums in another order;
# dw: f32 sums over the rows in another order in both dtypes.
LN_BWD_CASES = ((16384, 768, "bfloat16", 1e-2), (16384, 768, "float32", 1e-5),
                (16387, 768, "bfloat16", 1e-2), (33, 770, "bfloat16", 1e-2),
                (256, 12288, "bfloat16", 1e-2), (64, 9001, "float32", 1e-5))


def _ln_inputs(torch, cases, index, backward, device="cuda"):
  """x, w (and g for the backward) of ``cases[index]`` on ``device``, from
  a seed of their own."""
  rows, h, dt, _ = cases[index]
  dtype = getattr(torch, dt)
  g = torch.Generator(device=device).manual_seed(
      SEED + (40 if backward else 20) + index)
  x = (torch.randn(rows, h, device=device, generator=g) * 2 + 0.5).to(dtype)
  w = torch.rand(h, device=device, generator=g) + 0.5
  if not backward:
    return x, w
  return x, w, torch.randn(rows, h, device=device, generator=g).to(dtype)


def _ln_calls(ops, torch, F, index):
  """(kernel, plain version, yardstick) closures of LN_CASES[index]."""
  x, w = _ln_inputs(torch, LN_CASES, index, False)
  h, wl = x.shape[-1], w.to(x.dtype)
  return (lambda: ops.layer_norm(x, w),
          lambda: ops.layer_norm_reference(x, w),
          lambda: F.layer_norm(x, (h,), wl, None, 1e-6))


def _ln_bwd_calls(ops, torch, F, index):
  """(kernel, plain version, yardstick) closures of LN_BWD_CASES[index]:
  the yardstick is PyTorch's LayerNorm backward through autograd."""
  x, w, gy = _ln_inputs(torch, LN_BWD_CASES, index, True)
  xl = x.detach().clone().requires_grad_()
  wl = w.to(x.dtype).requires_grad_()
  yl = F.layer_norm(xl, (x.shape[-1],), wl, None, 1e-6)
  return (lambda: ops.layer_norm_bwd(x, w, gy),
          lambda: ops.layer_norm_bwd_reference(x, w, gy),
          lambda: torch.autograd.grad(yl, (xl, wl), gy, retain_graph=True))


def _bound(nbytes, flops):
  """(bound ms, what bounds it) of a kernel moving ``nbytes`` and doing
  ``flops`` f32 operations outside the tensor cores."""
  bound_b = nbytes / HBM_BYTES_PER_S * 1e3
  bound_o = flops / ELEMENTWISE_FLOPS * 1e3
  return max(bound_b, bound_o), "bytes" if bound_b >= bound_o else "operations"


def check_layer_norm(ops, torch, F):
  """The LayerNorm forward against its plain version at LN_CASES, timed
  by CUDA events beside ``F.layer_norm``; device times come later
  (:func:`layer_norm_device_ms`)."""
  rows_out, worst = [], 0.0
  for i, (rows, h, dt, tol) in enumerate(LN_CASES):
    fn, plain, lib = _ln_calls(ops, torch, F, i)
    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
      raise AssertionError("layer_norm %s rows=%d H=%d: max abs err %.3g "
                           "over tol %g" % (dt, rows, h, err, tol))
    worst = max(worst, err)
    isz = got.element_size()
    bound, by = _bound(2 * rows * h * isz + h * 4,
                       LN_FLOPS_PER_ELEM * rows * h)
    row = {"rows": rows, "H": h, "dtype": dt, "max_abs_err": err,
           "ms": time_ms(fn), "plain_ms": time_ms(plain),
           "library_ms": time_ms(lib), "bound_ms": bound, "bound_by": by}
    rows_out.append(row)
    log("  layer_norm %-8s rows=%-4d H=%d err=%.3g ms=%.5f plain=%.5f "
        "lib=%.5f bound=%.5f" % (dt, rows, h, err, row["ms"],
                                 row["plain_ms"], row["library_ms"],
                                 row["bound_ms"]))
    del fn, plain, lib, got, want
  return rows_out, worst


def _visible_pairs(sq, sk, q_base, kv_base, window):
  """(q, k) pairs the causal (+ window) mask keeps: the work this run's
  inputs need."""
  total = 0
  for i in range(sq):
    qpos = q_base + i
    hi = min(sk, qpos - kv_base + 1)                  # keys with pos <= qpos
    lo = 0 if window is None else max(0, qpos - window + 1 - kv_base)
    total += max(0, hi - lo)
  return total


def check_flash(ops, torch, F):
  rows_out, worst = [], 0.0
  g = torch.Generator(device="cuda").manual_seed(SEED + 1)
  bf, f32 = torch.bfloat16, torch.float32
  # (name, B, Sq, Sk, H, Hk, D, q_base, kv_base, window, dtype): the
  # first prefill chunks of the main path (16/32/128/512), grouped KV, a window, a chunk at an
  # offset, rows that see no key, head_dim 128, and the f32 parity path
  cases = [("s16", 1, 16, 16, 12, 12, 64, 0, 0, None, bf),
           ("s32", 1, 32, 32, 12, 12, 64, 0, 0, None, bf),
           ("s128", 1, 128, 128, 12, 12, 64, 0, 0, None, bf),
           ("s512", 1, 512, 512, 12, 12, 64, 0, 0, None, bf),
           ("gqa_hk4", 1, 512, 512, 12, 4, 64, 0, 0, None, bf),
           ("window128", 1, 512, 512, 12, 12, 64, 0, 0, 128, bf),
           ("q_offset", 1, 256, 512, 12, 12, 64, 256, 0, None, bf),
           ("kv_ahead", 1, 128, 128, 12, 12, 64, 0, 64, None, bf),
           ("d128", 1, 256, 256, 6, 6, 128, 0, 0, None, bf),
           ("s512_f32", 1, 512, 512, 12, 12, 64, 0, 0, None, f32),
           ("train", 16, 1024, 1024, 12, 12, 64, 0, 0, None, bf)]
  for name, b, sq, sk, h, hk, d, qb, kb, win, dtype in cases:
    q = torch.randn(b, sq, h, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(b, sk, hk, d, device="cuda", generator=g).to(dtype)
    v = torch.randn(b, sk, hk, d, device="cuda", generator=g).to(dtype)
    out, lse = ops.flash_attention_fwd(q, k, v, qb, kb, True, win)
    ro, rl = ops.flash_attention_reference(q, k, v, qb, kb, True, win)
    torch.cuda.synchronize()
    # bf16: outputs round to bf16 (one ulp ~ 8e-3 at |o| ~ 1); lse is f32
    # from identical inputs. f32: summation order only.
    otol, ltol = (2e-2, 1e-4) if dtype == bf else (2e-5, 2e-5)
    err = (out.float() - ro.float()).abs().max().item()
    lerr = (lse - rl).abs().max().item()
    if not (torch.allclose(out.float(), ro.float(), atol=otol, rtol=otol)
            and torch.allclose(lse, rl, atol=ltol, rtol=ltol)):
      raise AssertionError("flash %s: out err %.3g (tol %g), lse err %.3g "
                           "(tol %g)" % (name, err, otol, lerr, ltol))
    if name == "kv_ahead":
      dead = kb - qb
      if not ((lse[:, :, :dead] == -1e30).all()
              and (out[:, :dead] == 0).all()):
        raise AssertionError("flash kv_ahead: rows with no visible key must "
                             "give lse -1e30 and out 0")
    worst = max(worst, err, lerr)
    dt = "bfloat16" if dtype == bf else "float32"
    pairs = b * h * _visible_pairs(sq, sk, qb, kb, win)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + lse.numel() * 4
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = 4.0 * pairs * d / PEAK_FLOPS[dt] * 1e3
    lib = None
    if qb == 0 and kb == 0 and win is None and sq == sk:
      # the yardstick gets K/V already expanded to the query heads
      qt = q.transpose(1, 2)
      kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
                for t in (k, v))
      lib = time_ms(lambda: F.scaled_dot_product_attention(
          qt, kt, vt, is_causal=True), runs=7 if b > 1 else 25)
    row = {"case": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "Hk": hk, "D": d,
           "q_base": qb, "kv_base": kb, "window": win, "dtype": dt,
           "max_abs_err": max(err, lerr),
           "ms": time_ms(lambda: ops.flash_attention_fwd(q, k, v, qb, kb,
                                                         True, win)),
           "plain_ms": time_ms(lambda: ops.flash_attention_reference(
               q, k, v, qb, kb, True, win), runs=5 if b > 1 else 25,
                               inner=2 if b > 1 else 10),
           "library_ms": lib, "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations"}
    rows_out.append(row)
    log("  flash %-9s Sq=%-3d Sk=%-3d H=%-2d Hk=%-2d D=%-3d err=%.3g "
        "ms=%.4f plain=%.4f lib=%s bound=%.5f" % (
            name, sq, sk, h, hk, d, max(err, lerr), row["ms"],
            row["plain_ms"], "-" if lib is None else "%.4f" % lib,
            row["bound_ms"]))
  row = check_flash_long(ops, torch, F, g)
  rows_out.append(row)
  worst = max(worst, row["max_abs_err"])
  return rows_out, worst


# query-row chunks of the long case held against the plain version: the
# first, one in the middle and the last (the plain version is dense, a
# [B, H, Sq, Sk] f32 tensor: ~13 GB for the whole long case)
LONG_CHUNK = 512
# the long case's out error over the largest |out| of its chunk
LONG_OUT_REL = 1e-2


def check_flash_long(ops, torch, F, g):
  """The forward at the long-context training shape (B1 S16384 H12 Hk4
  D64 bf16): the kernel's rows [i0, i0 + 512) against the plain version of
  those rows (its own ``q_base``) for three chunks, the last included;
  times beside SDPA on K/V expanded to the query heads."""
  b, s, h, hk, d = LONG_B, LONG_S, 12, 4, 64
  bf = torch.bfloat16
  q = torch.randn(b, s, h, d, device="cuda", generator=g).to(bf)
  k = torch.randn(b, s, hk, d, device="cuda", generator=g).to(bf)
  v = torch.randn(b, s, hk, d, device="cuda", generator=g).to(bf)
  out, lse = ops.flash_attention_fwd(q, k, v, 0, 0, True, None)
  err, rel = 0.0, []
  chunks = (0, s // 2, s - LONG_CHUNK)
  for i0 in chunks:
    i1 = i0 + LONG_CHUNK
    ro, rl = ops.flash_attention_reference(q[:, i0:i1], k, v, q_base=i0)
    got, glse = out[:, i0:i1], lse[:, :, i0:i1]
    torch.cuda.synchronize()
    oerr = (got.float() - ro.float()).abs().max().item()
    lerr = (glse - rl).abs().max().item()
    # a row that sees n keys averages n random V rows: |out| ~ sqrt(e / n),
    # ~0.013 in the last chunk, under the flat 2e-2; so out is also held to
    # 1e-2 of the chunk's own largest |out| (bf16 rounds it to 2^-9)
    scale = ro.float().abs().max().item()
    rel.append(oerr / scale)
    if not (torch.allclose(got.float(), ro.float(), atol=2e-2, rtol=2e-2)
            and oerr <= LONG_OUT_REL * scale
            and torch.allclose(glse, rl, atol=1e-4, rtol=1e-4)):
      raise AssertionError(
          "flash long rows [%d, %d): out err %.3g (tol 2e-2 and %g x max "
          "|out| %.3g), lse err %.3g (tol 1e-4)"
          % (i0, i1, oerr, LONG_OUT_REL, scale, lerr))
    err = max(err, oerr, lerr)
  pairs = b * h * _visible_pairs(s, s, 0, 0, None)
  nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + lse.numel() * 4
  bound_b = nbytes / HBM_BYTES_PER_S * 1e3
  bound_o = 4.0 * pairs * d / PEAK_FLOPS["bfloat16"] * 1e3
  qt = q.transpose(1, 2)
  kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
            for t in (k, v))
  lib = time_ms(lambda: F.scaled_dot_product_attention(
      qt, kt, vt, is_causal=True), runs=5, inner=3)
  del qt, kt, vt
  row = {"case": "long", "B": b, "Sq": s, "Sk": s, "H": h, "Hk": hk, "D": d,
         "q_base": 0, "kv_base": 0, "window": None, "dtype": "bfloat16",
         "max_abs_err": err, "checked_rows": [[i0, i0 + LONG_CHUNK]
                                              for i0 in chunks],
         "out_err_over_max_out": rel,
         "ms": time_ms(lambda: ops.flash_attention_fwd(q, k, v, 0, 0, True,
                                                       None), runs=5, inner=3),
         # the plain version over one chunk of rows, times the chunks
         "plain_ms": time_ms(lambda: ops.flash_attention_reference(
             q[:, :LONG_CHUNK], k, v, q_base=0), runs=3, inner=1)
         * (s // LONG_CHUNK),
         "plain": "one %d-row chunk x %d" % (LONG_CHUNK, s // LONG_CHUNK),
         "library_ms": lib, "bound_ms": max(bound_b, bound_o),
         "bound_by": "bytes" if bound_b >= bound_o else "operations"}
  log("  flash long      B=%d S=%d H=%d Hk=%d D=%d err=%.3g (rows %s; out "
      "err / max |out| %s) ms=%.4f plain~%.2f lib=%.4f bound=%.5f" % (
          b, s, h, hk, d, err, row["checked_rows"],
          ", ".join("%.3g" % x for x in rel), row["ms"], row["plain_ms"],
          lib, row["bound_ms"]))
  del q, k, v, out, lse
  torch.cuda.empty_cache()
  return row


def _rel_check(what, got, want, tol):
  """Max |got - want| (f32), raising when it exceeds ``tol`` times the
  largest |want|: gradients sum many terms, so the tolerance scales with
  the tensor's own size."""
  err = (got.float() - want.float()).abs().max().item()
  scale = max(want.float().abs().max().item(), 1e-30)
  if err > tol * scale:
    raise AssertionError("%s: max abs err %.3g over %g x max |ref| %.3g"
                         % (what, err, tol, scale))
  return err


def check_layer_norm_bwd(ops, torch, F):
  """The LayerNorm backward against its plain version at LN_BWD_CASES,
  twice and bitwise equal, timed by CUDA events beside PyTorch's LayerNorm
  backward; device times come later (:func:`layer_norm_device_ms`)."""
  rows_out, worst = [], 0.0
  for i, (rows, h, dt, tol) in enumerate(LN_BWD_CASES):
    fn, plain, lib = _ln_bwd_calls(ops, torch, F, i)
    (dx, dw), (rdx, rdw) = fn(), plain()
    torch.cuda.synchronize()
    err = max(_rel_check("layer_norm_bwd dx %s rows=%d H=%d" % (dt, rows, h),
                         dx, rdx, tol),
              _rel_check("layer_norm_bwd dw %s rows=%d H=%d" % (dt, rows, h),
                         dw, rdw, 1e-5))
    dx2, dw2 = fn()
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
      raise AssertionError("layer_norm_bwd rows=%d H=%d: two runs differ"
                           % (rows, h))
    worst = max(worst, err)
    isz = dx.element_size()
    bound, by = _bound(3 * rows * h * isz + 2 * h * 4,    # x, g, dx; w, dw
                       LN_BWD_FLOPS_PER_ELEM * rows * h)
    row = {"rows": rows, "H": h, "dtype": dt, "max_abs_err": err,
           "ms": time_ms(fn), "plain_ms": time_ms(plain, runs=10),
           "library_ms": time_ms(lib), "bound_ms": bound, "bound_by": by}
    rows_out.append(row)
    log("  layer_norm_bwd %-8s rows=%-5d H=%d err=%.3g ms=%.5f plain=%.5f "
        "lib=%.5f bound=%.5f deterministic" % (
            dt, rows, h, err, row["ms"], row["plain_ms"], row["library_ms"],
            row["bound_ms"]))
    del fn, plain, lib, dx, dw, rdx, rdw, dx2, dw2
  return rows_out, worst


def layer_norm_device_ms(ops, torch, F, ln_rows, lnb_rows):
  """The device time per call of each LayerNorm case, the port's kernels
  (the backward split by kernel: pass 1 and pass 2) and the yardstick's,
  from torch.profiler, into the rows of :func:`check_layer_norm` and
  :func:`check_layer_norm_bwd`; and the host's share of the CUDA-event
  time (``ms`` over ``device_ms``). Like :func:`fused_device_ms`, run
  after the serving phases."""
  for what, rows_out, calls in (("layer_norm", ln_rows, _ln_calls),
                                ("layer_norm_bwd", lnb_rows, _ln_bwd_calls)):
    for i, row in enumerate(rows_out):
      fn, _, lib = calls(ops, torch, F, i)
      per = {}
      row["device_ms"] = device_ms(torch, fn, per_kernel=per)
      row["device_ms_by_kernel"] = {k.split("(")[0][:80]: v
                                    for k, v in per.items()}
      row["library_device_ms"] = device_ms(torch, lib)
      del fn, lib
      if row["device_ms"] is None:
        log("  %s %s rows=%d H=%d: device time not measured (the profiler "
            "recorded no kernel in 3 sessions)" % (what, row["dtype"],
                                                  row["rows"], row["H"]))
        continue
      log("  %s %-8s rows=%-5d H=%-5d device=%.5f ms (events %.5f, %.0f%% "
          "of bound) lib device=%s | %s" % (
              what, row["dtype"], row["rows"], row["H"], row["device_ms"],
              row["ms"], 100.0 * row["bound_ms"] / row["device_ms"],
              "%.5f" % row["library_device_ms"]
              if row["library_device_ms"] is not None else "not measured",
              ", ".join("%s %.5f" % kv for kv in
                        row["device_ms_by_kernel"].items())))


def check_flash_bwd(ops, torch, F):
  rows_out, worst = [], 0.0
  g = torch.Generator(device="cuda").manual_seed(SEED + 6)
  bf, f32 = torch.bfloat16, torch.float32
  # (name, B, Sq, Sk, H, Hk, D, q_base, kv_base, window, lse cotangent,
  # dtype): the training shape (B16 S1024, 12 heads), the GQA training
  # shape (B8, Hk 4), a window, an offset block with an lse cotangent,
  # rows that see no key, head_dim 128, and f32
  cases = [("train", 16, 1024, 1024, 12, 12, 64, 0, 0, None, False, bf),
           ("gqa_hk4", 8, 1024, 1024, 12, 4, 64, 0, 0, None, False, bf),
           ("window128", 4, 1024, 1024, 12, 12, 64, 0, 0, 128, False, bf),
           ("offset_lse", 2, 512, 1024, 12, 4, 64, 512, 0, None, True, bf),
           ("kv_ahead", 2, 256, 256, 12, 12, 64, 0, 64, None, True, bf),
           ("d128", 2, 512, 512, 6, 6, 128, 0, 0, None, False, bf),
           ("train_f32", 4, 1024, 1024, 12, 12, 64, 0, 0, None, False, f32)]
  for name, b, sq, sk, h, hk, d, qb, kb, win, with_lse, dtype in cases:
    mk = lambda *shape: torch.randn(*shape, device="cuda",  # noqa: E731
                                    generator=g).to(dtype)
    q, k, v = mk(b, sq, h, d), mk(b, sk, hk, d), mk(b, sk, hk, d)
    go = mk(b, sq, h, d)
    out, lse = ops.flash_attention_fwd(q, k, v, qb, kb, True, win)
    gl = None
    if with_lse:
      gl = torch.randn(b, h, sq, device="cuda", generator=g)
      gl = torch.where(lse <= -1e29, 0.0, gl)
    got = ops.flash_attention_bwd(q, k, v, out, lse, go, gl, qb, kb, True, win)
    want = ops.flash_attention_bwd_reference(q, k, v, out, lse, go, gl, qb, kb,
                                             True, win)
    torch.cuda.synchronize()
    # bf16: outputs round to bf16 (2^-8 relative); f32: sums over up to
    # 1024 rows or keys in another order
    tol = 1e-2 if dtype == bf else 1e-4
    err = max(_rel_check("flash_bwd %s d%s" % (name, t), a, r, tol)
              for t, a, r in zip("qkv", got, want))
    again = ops.flash_attention_bwd(q, k, v, out, lse, go, gl, qb, kb, True,
                                    win)
    if not all(torch.equal(a, r) for a, r in zip(got, again)):
      raise AssertionError("flash_bwd %s: two runs differ" % name)
    if name == "kv_ahead" and not (got[0][:, :kb - qb] == 0).all():
      raise AssertionError("flash_bwd kv_ahead: rows with no visible key "
                           "must get dq 0")
    worst = max(worst, err)
    dt = "bfloat16" if dtype == bf else "float32"
    pairs = b * h * _visible_pairs(sq, sk, qb, kb, win)
    isz = q.element_size()
    nbytes = (3 * q.numel() + 2 * k.numel()) * isz \
        + (2 if with_lse else 1) * lse.numel() * 4 \
        + (q.numel() + 2 * k.numel()) * isz     # dq, dk, dv
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = 10.0 * pairs * d / PEAK_FLOPS[dt] * 1e3
    lib = None
    if qb == 0 and kb == 0 and win is None and sq == sk:
      # the yardstick: SDPA's backward alone, K/V expanded to the heads
      qt = q.transpose(1, 2).detach().requires_grad_()
      kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
                .detach().requires_grad_() for t in (k, v))
      ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
      gt = go.transpose(1, 2)
      lib = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                                retain_graph=True),
                    runs=7, inner=3)
    row = {"case": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "Hk": hk, "D": d,
           "q_base": qb, "kv_base": kb, "window": win, "lse_cotangent":
           with_lse, "dtype": dt, "max_abs_err": err,
           "ms": time_ms(lambda: ops.flash_attention_bwd(
               q, k, v, out, lse, go, gl, qb, kb, True, win), runs=7, inner=3),
           "plain_ms": time_ms(lambda: ops.flash_attention_bwd_reference(
               q, k, v, out, lse, go, gl, qb, kb, True, win), runs=3, inner=2),
           "library_ms": lib, "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations"}
    rows_out.append(row)
    log("  flash_bwd %-10s B=%-2d Sq=%-4d Sk=%-4d H=%-2d Hk=%-2d D=%-3d "
        "err=%.3g ms=%.4f plain=%.4f lib=%s bound=%.5f deterministic" % (
            name, b, sq, sk, h, hk, d, err, row["ms"], row["plain_ms"],
            "-" if lib is None else "%.4f" % lib, row["bound_ms"]))
    del q, k, v, go, out, lse, got, want, again
  return rows_out, worst


def check_flash_bwd_split(ops, torch, F):
  """The split backward's dQ and dK/dV kernels against their plain
  versions, twice each (bitwise), and against the fused kernel, with
  times. Returns one row per (case, kernel)."""
  fa = sys.modules["tensorflowonspark_tpu_torch.ops.flash_attention"]
  rows_out, worst = [], {"dq": 0.0, "dkv": 0.0}
  g = torch.Generator(device="cuda").manual_seed(SEED + 7)
  bf, f32 = torch.bfloat16, torch.float32
  # check_flash_bwd's cases, a long grouped window (the reference's own
  # gate case, tools/mosaic_gate.py:159) and the long-context training
  # shape, where the reference's plan rule takes the split plan
  cases = [("train", 16, 1024, 1024, 12, 12, 64, 0, 0, None, False, bf),
           ("gqa_hk4", 8, 1024, 1024, 12, 4, 64, 0, 0, None, False, bf),
           ("window128", 4, 1024, 1024, 12, 12, 64, 0, 0, 128, False, bf),
           ("offset_lse", 2, 512, 1024, 12, 4, 64, 512, 0, None, True, bf),
           ("kv_ahead", 2, 256, 256, 12, 12, 64, 0, 64, None, True, bf),
           ("d128", 2, 512, 512, 6, 6, 128, 0, 0, None, False, bf),
           ("train_f32", 4, 1024, 1024, 12, 12, 64, 0, 0, None, False, f32),
           ("gqa_long_window", 1, 4096, 4096, 12, 4, 64, 0, 0, 1024, False,
            bf),
           ("long", LONG_B, LONG_S, LONG_S, 12, 4, 64, 0, 0, None, False, bf)]
  for name, b, sq, sk, h, hk, d, qb, kb, win, with_lse, dtype in cases:
    long = name == "long"
    mk = lambda *shape: torch.randn(*shape, device="cuda",  # noqa: E731
                                    generator=g).to(dtype)
    q, k, v = mk(b, sq, h, d), mk(b, sk, hk, d), mk(b, sk, hk, d)
    go = mk(b, sq, h, d)
    out, lse = ops.flash_attention_fwd(q, k, v, qb, kb, True, win)
    gl = None
    if with_lse:
      gl = torch.randn(b, h, sq, device="cuda", generator=g)
      gl = torch.where(lse <= -1e29, 0.0, gl)
    args = (q, k, v, out, lse, go, gl, qb, kb, True, win)
    got = ops.flash_attention_bwd(*args, bwd="split")
    again = ops.flash_attention_bwd(*args, bwd="split")
    fused = fa._fused_bwd(*args)
    delta = fa._bwd_delta(out, go, gl)
    plain_dq = ops.flash_attention_bwd_dq_reference(q, k, v, go, lse, delta,
                                                    qb, kb, True, win)
    plain_dkv = ops.flash_attention_bwd_dkv_reference(q, k, v, go, lse,
                                                      delta, qb, kb, True, win)
    torch.cuda.synchronize()
    if not all(torch.equal(a, r) for a, r in zip(got, again)):
      raise AssertionError("flash_bwd_split %s: two runs differ" % name)
    # bf16: outputs round to bf16 (2^-8 relative); f32: sums over up to
    # 16384 rows or keys in another order
    tol = 1e-2 if dtype == bf else 1e-4
    err = {"dq": _rel_check("flash_bwd_split %s dq" % name, got[0],
                            plain_dq, tol),
           "dkv": max(_rel_check("flash_bwd_split %s d%s" % (name, t), a, r,
                                 tol)
                      for t, a, r in zip("kv", got[1:], plain_dkv))}
    fused_err = max(_rel_check("flash_bwd_split %s d%s vs fused" % (name, t),
                               a, r, tol)
                    for t, a, r in zip("qkv", got, fused))
    if name == "kv_ahead" and not (got[0][:, :kb - qb] == 0).all():
      raise AssertionError("flash_bwd_split kv_ahead: rows with no visible "
                           "key must get dq 0")
    for kern in err:
      worst[kern] = max(worst[kern], err[kern])
    dt = "bfloat16" if dtype == bf else "float32"
    pairs = b * h * _visible_pairs(sq, sk, qb, kb, win)
    isz = q.element_size()
    # each kernel reads q, dO, k, v once and lse, Delta (f32) once
    read = (2 * q.numel() + 2 * k.numel()) * isz + 2 * lse.numel() * 4
    written = {"dq": q.numel() * isz, "dkv": 2 * k.numel() * isz}
    flops = {"dq": 6.0 * pairs * d, "dkv": 8.0 * pairs * d}
    runs, inner, plain_runs = (3, 1, 1) if long else (7, 3, 3)
    lib = None
    if qb == 0 and kb == 0 and win is None and sq == sk:
      # SDPA's backward computes (dQ, dK, dV) together, K/V expanded
      qt = q.transpose(1, 2).detach().requires_grad_()
      kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
                .detach().requires_grad_() for t in (k, v))
      ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
      gt = go.transpose(1, 2)
      lib = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                                retain_graph=True),
                    runs=runs, inner=inner)
      del qt, kt, vt, ot, gt
    ms = {"dq": time_ms(lambda: ops.flash_attention_bwd_dq(
              q, k, v, go, lse, delta, qb, kb, True, win), runs=runs,
                        inner=inner),
          "dkv": time_ms(lambda: ops.flash_attention_bwd_dkv(
              q, k, v, go, lse, delta, qb, kb, True, win), runs=runs,
                         inner=inner)}
    plain_ms = {"dq": time_ms(lambda: ops.flash_attention_bwd_dq_reference(
                    q, k, v, go, lse, delta, qb, kb, True, win),
                              runs=plain_runs, inner=1),
                "dkv": time_ms(lambda: ops.flash_attention_bwd_dkv_reference(
                    q, k, v, go, lse, delta, qb, kb, True, win),
                               runs=plain_runs, inner=1)}
    # the fused kernel on the same inputs (one CTA per query head: ~0.5 s
    # a call at the long shape, so few repeats there)
    fused_ms = time_ms(lambda: fa._fused_bwd(*args), runs=2 if long else runs,
                       inner=1 if long else inner)
    # the fused kernel's bound on the same inputs: 5 products per pair, q,
    # dO, k, v, lse, Delta read and dq, dk, dv written once
    fused_bound = max((read + written["dq"] + written["dkv"])
                      / HBM_BYTES_PER_S,
                      10.0 * pairs * d / PEAK_FLOPS[dt]) * 1e3
    for kern in ("dq", "dkv"):
      bound_b = (read + written[kern]) / HBM_BYTES_PER_S * 1e3
      bound_o = flops[kern] / PEAK_FLOPS[dt] * 1e3
      rows_out.append({
          "case": name, "kernel": kern, "B": b, "Sq": sq, "Sk": sk, "H": h,
          "Hk": hk, "D": d, "q_base": qb, "kv_base": kb, "window": win,
          "lse_cotangent": with_lse, "dtype": dt, "max_abs_err": err[kern],
          "vs_fused_max_rel_err": fused_err, "ms": ms[kern],
          "plain_ms": plain_ms[kern], "bound_ms": max(bound_b, bound_o),
          "bound_by": "bytes" if bound_b >= bound_o else "operations",
          "library_ms": None, "library_whole_bwd_ms": lib,
          "library": "none computes %s alone; SDPA's backward computes "
                     "(dQ, dK, dV) together (library_whole_bwd_ms, beside "
                     "split_pair_ms)" % ("dQ" if kern == "dq" else "dK/dV"),
          "split_pair_ms": ms["dq"] + ms["dkv"], "fused_ms": fused_ms,
          "fused_bound_ms": fused_bound})
    log("  flash_bwd_split %-15s B=%-2d Sq=%-5d H=%-2d Hk=%-2d D=%-3d err "
        "dq %.3g dkv %.3g (vs fused %.3g) ms dq %.4f dkv %.4f = %.4f, fused "
        "%.4f, plain %.3f+%.3f, SDPA bwd %s, bound %.5f+%.5f deterministic"
        % (name, b, sq, h, hk, d, err["dq"], err["dkv"], fused_err, ms["dq"],
           ms["dkv"], ms["dq"] + ms["dkv"], fused_ms, plain_ms["dq"],
           plain_ms["dkv"], "-" if lib is None else "%.4f" % lib,
           rows_out[-2]["bound_ms"], rows_out[-1]["bound_ms"]))
    del q, k, v, go, out, lse, got, again, fused, delta, plain_dq, plain_dkv
    torch.cuda.empty_cache()
  return rows_out, worst


# (name, B, Sq, Sk, H, Hk, D, q_base, kv_base, window, dtype): head dims
# the kernels pad inside (32 in a 64-wide tile, 96 in a 128-wide one):
# train_gpt's defaults (d_model 256, 8 heads, seq 512, batch 8), a grouped
# window, a wider model's 96, a ragged offset block (Sq != Sk), and f32
HEAD_DIM_CASES = (
    ("d32_train_gpt", 8, 512, 512, 8, 8, 32, 0, 0, None, "bfloat16"),
    ("d32_gqa_window", 2, 1024, 1024, 8, 2, 32, 0, 0, 256, "bfloat16"),
    ("d96", 4, 1024, 1024, 8, 8, 96, 0, 0, None, "bfloat16"),
    ("d96_gqa_ragged", 2, 300, 700, 8, 4, 96, 400, 0, None, "bfloat16"),
    ("d32_f32", 2, 256, 256, 4, 2, 32, 0, 0, None, "float32"),
    ("d96_f32", 2, 256, 300, 4, 4, 96, 44, 0, 64, "float32"))


def check_head_dims(ops, torch, F):
  """The forward, the fused backward (twice, bitwise) and the split
  backward at head_dim 32 and 96 against their plain versions (the
  backward plans also against each other), timed beside SDPA's forward
  and backward where SDPA computes the same function."""
  rows_out, worst = [], {"fwd": 0.0, "bwd": 0.0, "split": 0.0}
  g = torch.Generator(device="cuda").manual_seed(SEED + 12)
  for name, b, sq, sk, h, hk, d, qb, kb, win, dt in HEAD_DIM_CASES:
    dtype = getattr(torch, dt)
    mk = lambda *shape: torch.randn(*shape, device="cuda",  # noqa: E731
                                    generator=g).to(dtype)
    q, k, v, go = mk(b, sq, h, d), mk(b, sk, hk, d), mk(b, sk, hk, d), \
        mk(b, sq, h, d)
    out, lse = ops.flash_attention_fwd(q, k, v, qb, kb, True, win)
    ro, rl = ops.flash_attention_reference(q, k, v, qb, kb, True, win)
    args = (q, k, v, out, lse, go, None, qb, kb, True, win)
    fused = ops.flash_attention_bwd(*args, bwd="fused")
    again = ops.flash_attention_bwd(*args, bwd="fused")
    split = ops.flash_attention_bwd(*args, bwd="split")
    split_again = ops.flash_attention_bwd(*args, bwd="split")
    want = ops.flash_attention_bwd_reference(*args)
    torch.cuda.synchronize()
    bf = dt == "bfloat16"
    otol, ltol = (2e-2, 1e-4) if bf else (2e-5, 2e-5)
    ferr = (out.float() - ro.float()).abs().max().item()
    lerr = (lse - rl).abs().max().item()
    if not (torch.allclose(out.float(), ro.float(), atol=otol, rtol=otol)
            and torch.allclose(lse, rl, atol=ltol, rtol=ltol)):
      raise AssertionError("head_dim %s forward: out err %.3g (tol %g), lse "
                           "err %.3g (tol %g)" % (name, ferr, otol, lerr,
                                                  ltol))
    if not all(torch.equal(x, y) for x, y in zip(fused, again)):
      raise AssertionError("head_dim %s fused backward: two runs differ"
                           % name)
    if not all(torch.equal(x, y) for x, y in zip(split, split_again)):
      raise AssertionError("head_dim %s split backward: two runs differ"
                           % name)
    # bf16: outputs round to bf16 (2^-8 relative); f32: sums in another order
    tol = 1e-2 if bf else 1e-4
    berr = max(_rel_check("head_dim %s fused d%s" % (name, t), x, r, tol)
               for t, x, r in zip("qkv", fused, want))
    serr = max(max(_rel_check("head_dim %s split d%s" % (name, t), x, r,
                              tol),
                   _rel_check("head_dim %s split d%s vs fused" % (name, t),
                              x, f, tol))
               for t, x, r, f in zip("qkv", split, want, fused))
    worst["fwd"] = max(worst["fwd"], ferr, lerr)
    worst["bwd"] = max(worst["bwd"], berr)
    worst["split"] = max(worst["split"], serr)
    pairs = b * h * _visible_pairs(sq, sk, qb, kb, win)
    isz = q.element_size()
    fwd_bytes = (2 * q.numel() + k.numel() + v.numel()) * isz + lse.numel() * 4
    bwd_bytes = (5 * q.numel() + 4 * k.numel()) * isz + lse.numel() * 4
    fwd_bound = max(fwd_bytes / HBM_BYTES_PER_S,
                    4.0 * pairs * d / PEAK_FLOPS[dt]) * 1e3
    bwd_bound = max(bwd_bytes / HBM_BYTES_PER_S,
                    10.0 * pairs * d / PEAK_FLOPS[dt]) * 1e3
    lib_fwd = lib_bwd = None
    if qb == 0 and kb == 0 and win is None and sq == sk:
      qt = q.transpose(1, 2).detach().requires_grad_()
      kt, vt = (t.repeat_interleave(h // hk, dim=2).transpose(1, 2)
                .detach().requires_grad_() for t in (k, v))
      lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
          qt, kt, vt, is_causal=True), runs=7, inner=3)
      ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
      gt = go.transpose(1, 2)
      lib_bwd = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                                    retain_graph=True),
                        runs=7, inner=3)
      del qt, kt, vt, ot, gt
    row = {"case": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "Hk": hk, "D": d,
           "q_base": qb, "kv_base": kb, "window": win, "dtype": dt,
           "fwd_max_abs_err": max(ferr, lerr), "bwd_max_abs_err": berr,
           "split_max_abs_err": serr,
           "fwd_ms": time_ms(lambda: ops.flash_attention_fwd(
               q, k, v, qb, kb, True, win), runs=7, inner=3),
           "fused_bwd_ms": time_ms(lambda: ops.flash_attention_bwd(
               *args, bwd="fused"), runs=7, inner=3),
           "split_bwd_ms": time_ms(lambda: ops.flash_attention_bwd(
               *args, bwd="split"), runs=7, inner=3),
           "plain_fwd_ms": time_ms(lambda: ops.flash_attention_reference(
               q, k, v, qb, kb, True, win), runs=3, inner=1),
           "plain_bwd_ms": time_ms(lambda: ops.flash_attention_bwd_reference(
               *args), runs=3, inner=1),
           "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
           "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd}
    rows_out.append(row)
    log("  head_dim %-15s B=%d Sq=%-4d Sk=%-4d H=%d Hk=%d D=%-3d %s err fwd "
        "%.3g fused %.3g split %.3g; ms fwd %.4f fused %.4f split %.4f "
        "(SDPA fwd %s bwd %s; bound fwd %.5f bwd %.5f) deterministic"
        % (name, b, sq, sk, h, hk, d, dt, max(ferr, lerr), berr, serr,
           row["fwd_ms"], row["fused_bwd_ms"], row["split_bwd_ms"],
           "-" if lib_fwd is None else "%.4f" % lib_fwd,
           "-" if lib_bwd is None else "%.4f" % lib_bwd, fwd_bound,
           bwd_bound))
    del q, k, v, go, out, lse, ro, rl, fused, again, split, split_again, want
  torch.cuda.empty_cache()
  return rows_out, worst


def pick(table, **kw):
  """The row of ``table`` whose fields equal ``kw``."""
  return next(r for r in table if all(r[k] == v for k, v in kw.items()))


def device_ms(torch, fn, calls=5, per_kernel=None):
  """Device time per call of ``fn`` (every kernel it launches), from
  torch.profiler over ``calls`` calls after a warm-up; each kernel's name
  and device ms per call go into the dict ``per_kernel`` when one is
  given. A session in which the profiler records no kernel at all (it
  sometimes drops a short session's device activity) is taken again, up
  to 3 times; None if none recorded one."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  for _ in range(3):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      for _ in range(calls):
        fn()
      torch.cuda.synchronize()
    rows = _kernel_rows(torch, prof)
    total = sum(r[1] for r in rows)
    if total > 0:
      if per_kernel is not None:
        per_kernel.update((r[0], r[1] / calls) for r in rows)
      return total / calls
  return None


# (op, case, rows, K, N, dtype): the training shapes (B16 x S1024 rows:
# fused QKV 768 -> 2304, its grouped width 1280, MLP up 768 -> 3072, down
# 3072 -> 768), train_gpt's (4096 rows, d_model 256: QKV 768, up 1024), f32
# at the parity phase's rows, and ragged rows into N 1280 plus ragged
# rows/K/N against the 128 x 256 x 64 tiles, rows whose mean is large
# against their spread (x = 100 + N(0, 1): a prologue that drops the
# centred subtraction loses their digits), K 64 (one K step: the time a
# CTA spends outside its K loop, filling the ring and writing its tile),
# and K and N that are not multiples of 8 (rows off a 16-byte boundary:
# element loads)
FUSED_CASES = (("ln_matmul", "qkv", 16384, 768, 2304, "bfloat16"),
               ("ln_matmul", "qkv_gqa", 16384, 768, 1280, "bfloat16"),
               ("ln_matmul", "up", 16384, 768, 3072, "bfloat16"),
               ("ln_matmul", "gpt_up", 4096, 256, 1024, "bfloat16"),
               ("ln_matmul", "qkv_f32", 512, 768, 2304, "float32"),
               ("ln_matmul", "ragged33", 33, 768, 1280, "bfloat16"),
               ("ln_matmul", "ragged_kn", 100, 776, 200, "bfloat16"),
               ("ln_matmul", "large_mean", 512, 768, 2304, "bfloat16"),
               ("ln_matmul", "k64", 16384, 64, 2304, "bfloat16"),
               ("gelu_matmul", "down", 16384, 3072, 768, "bfloat16"),
               ("gelu_matmul", "down_f32", 512, 3072, 768, "float32"),
               ("gelu_matmul", "ragged33", 33, 768, 1280, "bfloat16"),
               ("gelu_matmul", "ragged_kn", 100, 776, 200, "bfloat16"),
               ("ln_matmul", "k_n_odd", 100, 771, 203, "bfloat16"),
               ("gelu_matmul", "k_n_odd", 100, 771, 203, "bfloat16"),
               ("ln_matmul", "k_n_odd_f32", 33, 301, 131, "float32"))


def _fused_calls(ops, torch, F, index):
  """(kernel, plain version, yardstick) closures over case ``index``'s
  inputs, made from a seed of their own."""
  op, case, rows, k, n, dt = FUSED_CASES[index]
  dtype = getattr(torch, dt)
  g = torch.Generator(device="cuda").manual_seed(SEED + 8 + index)
  scale, shift = (1.0, 100.0) if case == "large_mean" else (2.0, 0.5)
  x = (torch.randn(rows, k, device="cuda", generator=g) * scale
       + shift).to(dtype)
  W = (torch.randn(k, n, device="cuda", generator=g) / k ** 0.5).to(dtype)
  if op == "ln_matmul":
    w = torch.rand(k, device="cuda", generator=g) + 0.5
    wl = w.to(dtype)
    return (lambda: ops.ln_matmul(x, w, W),
            lambda: ops.ln_matmul_reference(x, w, W),
            lambda: F.layer_norm(x, (k,), wl, None, 1e-6) @ W)
  return (lambda: ops.gelu_matmul(x, W),
          lambda: ops.gelu_matmul_reference(x, W),
          lambda: F.gelu(x, approximate="tanh") @ W)


def _fused_module(op):
  """The port's module of fused product ``op`` (the package re-exports the
  function under the module's name)."""
  return sys.modules["tensorflowonspark_tpu_torch.ops." + (
      "ln_matmul" if op == "ln_matmul" else "act_matmul")]


def check_fused_matmul(ops, torch, F):
  """ln_matmul and gelu_matmul against their plain versions. The
  yardstick is the unfused pair of PyTorch calls (``F.layer_norm`` or
  ``F.gelu``, then ``torch.matmul``): no single library call computes the
  fused function. Device times come later (:func:`fused_device_ms`)."""
  rows_out, worst = [], 0.0
  for i, (op, case, rows, k, n, dt) in enumerate(FUSED_CASES):
    fn, plain, lib = _fused_calls(ops, torch, F, i)
    # the body the kernel's dispatcher runs
    body = _fused_module(op).kernel_body(k, n, getattr(torch, dt))
    got, want = fn(), plain()
    torch.cuda.synchronize()
    # bf16: outputs may round one ulp apart (f32 sums in another order);
    # f32: summation order only. Both relative to the output's scale.
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if err > tol * scale:
      raise AssertionError("%s %s: max abs err %.3g over %g x max |ref| %.3g"
                           % (op, case, err, tol, scale))
    worst = max(worst, err)
    if not torch.equal(got, fn()):
      raise AssertionError("%s %s: two runs differ" % (op, case))
    # share of outputs whose bits differ from the plain version's
    differ = (got != want).float().mean().item()
    isz = got.element_size()
    nbytes = (rows * k + k * n + rows * n) * isz + (k * 4 if op == "ln_matmul"
                                                    else 0)
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = 2.0 * rows * k * n / PEAK_FLOPS[dt] * 1e3
    row = {"op": op, "case": case, "rows": rows, "K": k, "N": n, "dtype": dt,
           "body": body, "max_abs_err": err, "max_abs_ref": scale,
           "differ": differ, "ms": time_ms(fn),
           "plain_ms": time_ms(plain, runs=7 if rows > 1000 else 25),
           "library_ms": time_ms(lib),
           "library": ("F.layer_norm + torch.matmul" if op == "ln_matmul"
                       else "F.gelu + torch.matmul") + " (two calls)",
           "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations"}
    rows_out.append(row)
    log("  %-11s %-9s %-8s %-5s rows=%-5d K=%-4d N=%-4d err=%.3g "
        "differ=%.2e ms=%.4f plain=%.4f lib(2 calls)=%.4f bound=%.5f"
        % (op, case, dt, body, rows, k, n, err, differ, row["ms"],
           row["plain_ms"], row["library_ms"], row["bound_ms"]))
    del fn, plain, lib, got, want
  return rows_out, worst


def _ran_instance(names, body, prologue):
  """The fused-product kernels among the profiler's ``names``, and whether
  one of them is ``body``'s kernel instantiated for ``prologue``."""
  symbol = {"wgmma": "prologue_gemm_wgmma", "wmma": "prologue_gemm_bf16",
            "f32": "prologue_gemm_f32"}[body]
  ran = sorted({n for n in names if "prologue_gemm" in n})
  return ran, any(symbol in n and _prologue(n) == prologue for n in ran)


def fused_device_ms(ops, torch, F, rows_out):
  """Each fused case's device time under torch.profiler, into its row of
  :func:`check_fused_matmul`. Run after the serving phases: the
  profiler's first session is left where the serving path had it, after
  the timed serving run."""
  for i, row in enumerate(rows_out):
    fn = _fused_calls(ops, torch, F, i)[0]
    per = {}
    row["device_ms"] = device_ms(torch, fn, per_kernel=per)
    row["device_ms_by_kernel"] = {k.split("(")[0][:80]: v
                                  for k, v in per.items()}
    del fn
    # the profiler names the body that ran: it must be the one the
    # dispatcher gives these widths, instantiated for this op's prologue
    want = "kLayerNorm" if row["op"] == "ln_matmul" else "kGelu"
    ran, ok = _ran_instance(per, row["body"], want)
    row["kernels_seen"] = ran
    if ran and not ok:
      raise AssertionError("%s %s: expected the %s body for %s, the profiler "
                           "saw %s" % (row["op"], row["case"], row["body"],
                                       want, ran))
    if row["device_ms"] is None:
      row["tflops"] = None
      log("  %-11s %-9s %-8s device time not measured: the profiler "
          "recorded no kernel in 3 sessions" % (row["op"], row["case"],
                                                row["dtype"]))
      continue
    row["tflops"] = 2.0 * row["rows"] * row["K"] * row["N"] / \
        row["device_ms"] / 1e9
    log("  %-11s %-9s %-8s device=%.4f ms (%.1f TFLOP/s), ran %s"
        % (row["op"], row["case"], row["dtype"], row["device_ms"],
           row["tflops"], ", ".join(
               "%s<%s> %.4f" % (n.split("<")[0].split("::")[-1],
                                _prologue(n), per[n]) for n in ran)))


# -- phases 4 and 5: the serving path ----------------------------------------

MAIN_LENGTHS = (600, 517, 512, 470, 300, 260, 200, 150, 128, 97, 64, 45, 33,
                32, 20, 17)
MAIN_NEW = 32
PARITY_LENGTHS = (600, 300, 130, 97, 40, 33, 17, 5)
PARITY_NEW = 16


def _prompts(lengths, vocab, seed):
  import numpy as np
  rng = np.random.default_rng(seed)
  return [rng.integers(1, vocab, size=n) for n in lengths]


def serve_main_path(torch, ops, tfm, ServingEngine, slots, params, cfg,
                    device=None, warm=True):
  eng = ServingEngine(params, cfg, num_slots=8, horizon=4,
                      max_new_tokens=MAIN_NEW, device=device).start()
  try:
    if warm:
      # warm-up: cuBLAS handles, allocator pools, first launches
      eng.generate(_prompts((40, 130), cfg.vocab_size, SEED + 7),
                   max_new_tokens=4, timeout=600)
    prompts = _prompts(MAIN_LENGTHS, cfg.vocab_size, SEED + 2)
    before = dict(eng.stats)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.monotonic()
    rids = [eng.submit(p) for p in prompts]
    handles = [eng.request(r) for r in rids]
    outs = [eng.result(r, timeout=600) for r in rids]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
  finally:
    eng.stop()                     # joins the loop: no forward runs after
  launches = dict(ops.LAUNCHES)
  after = dict(eng.stats)
  for p, o in zip(prompts, outs):
    if len(o) != len(p) + MAIN_NEW or not (o[:len(p)] == p).all():
      raise AssertionError("request of %d tokens returned %d tokens"
                           % (len(p), len(o)))
    if o.min() < 0 or o.max() >= cfg.vocab_size:
      raise AssertionError("token ids out of the vocabulary")
  steps = after["steps"] - before["steps"]
  chunks = sum(len(slots.chunk_plan(len(p), eng.buckets)) for p in prompts)
  per_forward = 2 * cfg.num_layers + 1
  want_ln = per_forward * (chunks + steps)
  want_flash = cfg.num_layers * len(prompts)
  if launches["layer_norm"] != want_ln:
    raise AssertionError("layer_norm launched %d times, the path needs %d "
                         "(25 per forward x %d forwards)"
                         % (launches["layer_norm"], want_ln, chunks + steps))
  if launches["flash_attention_fwd"] != want_flash:
    raise AssertionError("flash attention launched %d times, the path needs "
                         "%d (12 layers x %d fresh prefills)"
                         % (launches["flash_attention_fwd"], want_flash,
                            len(prompts)))
  with torch.inference_mode():
    logits = eng.model(torch.as_tensor(prompts[-1][None]))
  if not torch.isfinite(logits).all():
    raise AssertionError("non-finite logits at full width")
  ttft = sorted(h.ttft * 1e3 for h in handles)
  generated = sum(len(o) - len(p) for p, o in zip(prompts, outs))
  decode_s = after["decode_s"] - before["decode_s"]
  res = {"requests": len(prompts), "generated_tokens": generated,
         "wall_s": wall, "tokens_per_s": generated / wall,
         "ttft_ms_p50": statistics.median(ttft),
         "ttft_ms_p99": ttft[min(len(ttft) - 1,
                                 int(math.ceil(0.99 * len(ttft))) - 1)],
         "decode_steps": steps, "decode_ms_per_step": decode_s / steps * 1e3,
         "prefill_chunks": chunks, "launches": launches,
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
         "ttft_ms_exact": ttft, "outputs": [o.tolist() for o in outs]}
  log("  served %d requests, %d tokens in %.3f s: %.1f tok/s, TTFT p50 %.1f "
      "ms p99 %.1f ms, %.3f ms/decode step, launches %s" % (
          len(prompts), generated, wall, res["tokens_per_s"],
          res["ttft_ms_p50"], res["ttft_ms_p99"], res["decode_ms_per_step"],
          launches))
  return res, eng.model


def _kernel_rows(torch, prof):
  """(name, device ms) per kernel the profiler saw, largest first."""
  cuda = torch.autograd.DeviceType.CUDA
  rows = []
  for evt in prof.key_averages():
    if getattr(evt, "device_type", None) != cuda:
      continue
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    rows.append((evt.key, us / 1e3, evt.count))
  return sorted(rows, key=lambda r: -r[1])


# (substring of a device symbol, the port kernel whose wrapper launches it);
# the fused products share one template, told apart by its prologue. The
# Delta pre-pass (both backward plans) counts apart; the fused backward's
# kernels count as flash_attention_bwd in MHA and grouped steps alike
_PORT_SYMBOLS = (("ln_matmul_stats_kernel", "ln_matmul"),
                 ("flash_fwd_kernel", "flash_attention_fwd"),
                 ("flash_bwd_dq_kernel", "flash_attention_bwd_dq"),
                 ("flash_bwd_dkv_kernel", "flash_attention_bwd_dkv"),
                 ("flash_bwd_dkv_gqa_kernel", "flash_attention_bwd_dkv_gqa"),
                 ("flash_bwd_delta_kernel", "flash_attention_bwd_delta"),
                 ("flash_bwd", "flash_attention_bwd"),
                 ("layer_norm_fwd_kernel", "layer_norm"),
                 ("layer_norm_bwd_kernel", "layer_norm_bwd"),
                 ("layer_norm_bwd_wide_kernel", "layer_norm_bwd"),
                 ("layer_norm_dw_kernel", "layer_norm_bwd"))


def _port_kernel(symbol):
  """The port kernel whose wrapper launches device symbol ``symbol``, or
  None for a symbol of no port kernel."""
  if "prologue_gemm" in symbol:
    return "gelu_matmul" if _prologue(symbol) == "kGelu" else "ln_matmul"
  return next((name for part, name in _PORT_SYMBOLS if part in symbol), None)


def port_kernel_ms(rows):
  """Device ms and kernel launches per port kernel, summed over every
  symbol the profiler saw (not only the top rows)."""
  out = {}
  for key, ms, count in rows:
    name = _port_kernel(key)
    if name is not None:
      slot = out.setdefault(name, {"device_ms": 0.0, "kernels": 0})
      slot["device_ms"] += ms
      slot["kernels"] += count
  return out


def _log_port_kernels(per):
  for name, v in sorted(per.items()):
    log("    port %-20s %9.3f ms device, %d kernel launches"
        % (name, v["device_ms"], v["kernels"]))


def profile_serving(torch, slots, model):
  """Where one decode dispatch (8 live slots, horizon 4) and one
  512-token prefill chunk spend their time: device-busy ms from
  torch.profiler against the host wall clock, and the top kernels."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  cfg = model.cfg
  dec = slots.SlotDecoder(model, 8)
  prompts = _prompts(MAIN_LENGTHS[:8], cfg.vocab_size, SEED + 4)
  slabs = dec.init_slabs()
  for i, p in enumerate(prompts):
    row, _ = dec.prefill(p)
    dec.insert(slabs, row, i)
  last = np.ones(8, np.int64)
  active = np.ones(8, bool)
  budget = np.full(8, 1000, np.int64)
  long_prompt = prompts[2][:512]
  phases = {"decode_h4": lambda: dec.step_many(slabs, last, active, budget,
                                               4),
            "prefill_512": lambda: dec.prefill(long_prompt)}
  out = {}
  for name, fn in phases.items():
    fn()                                   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.monotonic()
      fn()
      torch.cuda.synchronize()
      wall_ms = (time.monotonic() - t0) * 1e3
    rows = _kernel_rows(torch, prof)
    busy = sum(r[1] for r in rows)
    out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                 "kernel_launches": sum(r[2] for r in rows),
                 "top": [{"kernel": k[:90], "ms": ms, "count": n}
                         for k, ms, n in rows[:8]],
                 "port_kernels": port_kernel_ms(rows)}
    log("  %s: wall %.2f ms, device busy %.2f ms (idle %.0f%%), %d kernel "
        "launches" % (name, wall_ms, busy,
                      100.0 * (1 - busy / wall_ms) if wall_ms else 0.0,
                      out[name]["kernel_launches"]))
    for r in out[name]["top"]:
      log("    %8.3f ms x%-5d %s" % (r["ms"], r["count"], r["kernel"]))
    _log_port_kernels(out[name]["port_kernels"])
  return out


def serve_parity_f32(torch, tfm, ServingEngine, params, cfg, device=None):
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  prompts = _prompts(PARITY_LENGTHS, cfg.vocab_size, SEED + 3)
  eng = ServingEngine(params, cfg, num_slots=8, horizon=4,
                      device=device).start()
  try:
    outs = eng.generate(prompts, max_new_tokens=PARITY_NEW, timeout=600)
  finally:
    eng.stop()
  model, exact, ties = eng.model, 0, []
  for p, out in zip(prompts, outs):
    ref = tfm.greedy_generate_kv(model, p[None], PARITY_NEW).cpu().numpy()[0]
    if (ref == out).all():
      exact += 1
      continue
    pos = int(next(i for i in range(len(ref)) if ref[i] != out[i]))
    with torch.inference_mode():
      logits = model(torch.as_tensor(ref[None, :pos]))[0, -1]
    top2 = torch.topk(logits, 2).values
    gap = float(top2[0] - top2[1])
    log("  prompt %d: first difference at position %d, top-2 gap %.3g"
        % (len(p), pos, gap))
    if gap >= 1e-4:
      raise AssertionError("engine output differs from greedy_generate_kv "
                           "at position %d of a %d-token prompt (top-2 gap "
                           "%.3g: not a near-tie)" % (pos, len(p), gap))
    ties.append({"prompt_len": len(p), "position": pos, "gap": gap})
  log("  f32 parity: %d/%d requests token-identical, %d near-ties"
      % (exact, len(prompts), len(ties)))
  return {"requests": len(prompts), "identical": exact, "near_ties": ties}


# -- phases 6, 6b, 6c and 7: the training path --------------------------------

TRAIN_B, TRAIN_S = 16, 1024        # bench.py's batch x sequence
GQA_B = 8
WANT_PER_STEP = {"flash_attention_fwd": 24, "flash_attention_bwd": 12,
                 "layer_norm": 49, "layer_norm_bwd": 25,
                 "flash_attention_bwd_gqa": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0,
                 "flash_attention_bwd_dkv_gqa": 0, "ln_matmul": 0,
                 "gelu_matmul": 0}
# TFOS_TPU_FLASH_BWD=split: the dQ and dK/dV kernels replace the fused one
WANT_SPLIT_PER_STEP = dict(WANT_PER_STEP, flash_attention_bwd=0,
                           flash_attention_bwd_dq=12,
                           flash_attention_bwd_dkv=12)
# the long-context grouped-KV slice (train_gpt.py --kv_heads 4 --seq_len
# 16384 --batch 1): the reference's plan rule takes the split plan there
LONG_B, LONG_S = 1, 16384
LONG_ARGS = ["--layers", "12", "--d_model", "768", "--heads", "12",
             "--kv_heads", "4", "--seq_len", str(LONG_S), "--vocab", "32000",
             "--batch", str(LONG_B)]
WANT_LONG_PER_STEP = dict(WANT_PER_STEP, flash_attention_bwd=0,
                          flash_attention_bwd_dq=12,
                          flash_attention_bwd_dkv_gqa=12)
# bench.py's b16_s1024_allfused / train_gpt.py --fused: ln1 + QKV and ln2 +
# up as LN->matmul, GELU + down as GELU->matmul; only ln_f stays a LayerNorm
ALL_FUSED = dict(fuse_qkv=True, ln_matmul_impl="fused",
                 act_matmul_impl="fused")
WANT_FUSED_PER_STEP = dict(WANT_PER_STEP, layer_norm=1, layer_norm_bwd=1,
                           ln_matmul=48, gelu_matmul=24)


def _synthetic_batch(batch, seq, vocab):
  """train_gpt.py's synthetic stream: one fixed batch, repeated."""
  import numpy as np
  return np.random.RandomState(SEED).randint(0, vocab, (batch, seq)).astype(
      "int32")


def _lm_loss(tfm):
  return lambda model, tokens: tfm.causal_lm_loss(model(tokens), tokens)


def _per_step_launches(launches, steps, want, what):
  per = {}
  for name, n in want.items():
    if launches[name] != n * steps:
      raise AssertionError("%s: %s launched %d times in %d steps, the path "
                           "needs %d per step" % (what, name, launches[name],
                                                  steps, n))
    per[name] = launches[name] / steps
  return per


def _profile_step(torch, step, state, batch, cuda_only=False):
  """One optimizer step under torch.profiler, unlogged: (state, loss, its
  wall and device-busy ms, the top kernels, every port kernel's device
  ms). ``cuda_only`` records the device's activity alone: the kernels'
  times are the same, and the trace holds no host op to process (seconds
  a step of a rank's host time otherwise)."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  activities = [ProfilerActivity.CUDA] if cuda_only else [
      ProfilerActivity.CPU, ProfilerActivity.CUDA]
  with profile(activities=activities) as prof:
    t0 = time.monotonic()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
  rows = _kernel_rows(torch, prof)
  if not rows:
    raise AssertionError("the profiled step shows no device kernel")
  busy = sum(r[1] for r in rows)
  nccl = [r for r in rows if "nccl" in r[0].lower()]
  res = {"wall_ms": wall_ms, "device_busy_ms": busy,
         "kernel_launches": sum(r[2] for r in rows),
         "nccl_ms": sum(r[1] for r in nccl),
         "nccl_kernels": sum(r[2] for r in nccl),
         "gemm_kernels": gemm_kernels(rows),
         "gemm_by_kernel": gemm_by_kernel(rows),
         "top": [{"kernel": k[:90], "ms": ms, "count": n}
                 for k, ms, n in rows[:12]],
         "port_kernels": port_kernel_ms(rows)}
  return state, loss, res


def profile_train_step(torch, step, state, batch):
  """One optimizer step under torch.profiler: device-busy ms against the
  host's wall clock, the top kernels and every port kernel's device ms."""
  state, loss, res = _profile_step(torch, step, state, batch)
  wall_ms, busy = res["wall_ms"], res["device_busy_ms"]
  log("  profiled step: wall %.2f ms, device busy %.2f ms (idle %.0f%%), %d "
      "kernel launches" % (wall_ms, busy, 100.0 * (1 - busy / wall_ms),
                           res["kernel_launches"]))
  for r in res["top"]:
    log("    %8.3f ms x%-5d %s" % (r["ms"], r["count"], r["kernel"]))
  _log_port_kernels(res["port_kernels"])
  return state, float(loss), res


def train_main_path(torch, ops, tfm, optim, sharding, Slab, params, cfg,
                    want):
  """Warm-up, 4 ``make_train_step`` steps, one ``make_train_loop(unroll=
  4)`` slab and one profiled step of ``cfg`` at B16 x S1024, with exact
  launch counts per step (``want``) on both paths."""
  import numpy as np
  state = tfm.create_state(cfg, params, tx=optim.make_optimizer(
      learning_rate=3e-4, clip_norm=1.0))
  batch = _synthetic_batch(TRAIN_B, TRAIN_S, cfg.vocab_size)
  loss_fn = _lm_loss(tfm)
  step = sharding.make_train_step(loss_fn)
  loop = sharding.make_train_loop(loss_fn, unroll=4)
  losses = []
  for _ in range(2):                               # warm-up
    state, loss = step(state, batch)
    losses.append(float(loss))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  ops.reset_launches()
  t0 = time.monotonic()
  step_losses = []
  for _ in range(4):
    state, loss = step(state, batch)
    step_losses.append(loss)
  torch.cuda.synchronize()
  wall_step = time.monotonic() - t0
  per_step = _per_step_launches(dict(ops.LAUNCHES), 4, want, "per-step path")
  losses += [float(x) for x in step_losses]
  ops.reset_launches()
  t0 = time.monotonic()
  state, loop_losses = loop(state, Slab(np.stack([batch] * 4)))
  torch.cuda.synchronize()
  wall_loop = time.monotonic() - t0
  per_loop = _per_step_launches(dict(ops.LAUNCHES), 4, want, "fused loop")
  losses += loop_losses.tolist()
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  if not all(math.isfinite(x) for x in losses):
    raise AssertionError("non-finite training loss: %s" % losses)
  if not losses[-1] < losses[0]:
    raise AssertionError("training loss did not fall: %s" % losses)
  state, prof_loss, prof = profile_train_step(torch, step, state, batch)
  tokens = TRAIN_B * TRAIN_S * 4
  res = {"batch": TRAIN_B, "seq": TRAIN_S, "losses": losses + [prof_loss],
         "per_step": {"wall_s": wall_step, "ms_per_step": wall_step / 4 * 1e3,
                      "tokens_per_s": tokens / wall_step,
                      "launches_per_step": per_step},
         "fused_loop": {"wall_s": wall_loop, "ms_per_step": wall_loop / 4 * 1e3,
                        "tokens_per_s": tokens / wall_loop,
                        "launches_per_step": per_loop},
         "peak_mem_gib": peak, "profile": prof}
  log("  losses %s" % " ".join("%.4f" % x for x in res["losses"]))
  log("  per-step: %.1f ms/step, %.0f tokens/s; fused loop (unroll 4): %.1f "
      "ms/step, %.0f tokens/s; peak memory %.2f GiB" % (
          res["per_step"]["ms_per_step"], res["per_step"]["tokens_per_s"],
          res["fused_loop"]["ms_per_step"], res["fused_loop"]["tokens_per_s"],
          peak))
  log("  launches per step (both paths): %s" % per_step)
  return res


def train_gqa(torch, ops, tfm, optim, sharding, init_params, want, **kw):
  """The grouped-KV configuration (``num_kv_heads=4``, plus ``kw``) at
  B8 x S1024: one warm-up step, then 2 timed steps with exact launch
  counts, then one profiled step (the grouped fused backward's device
  time: its kernels are the only flash backward there)."""
  cfg = tfm.TransformerConfig(num_kv_heads=4, **kw)
  state = tfm.create_state(cfg, init_params(cfg, seed=SEED),
                           tx=optim.make_optimizer(learning_rate=3e-4,
                                                   clip_norm=1.0))
  batch = _synthetic_batch(GQA_B, TRAIN_S, cfg.vocab_size)
  step = sharding.make_train_step(_lm_loss(tfm))
  state, first = step(state, batch)                # warm-up
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.monotonic()
  losses = []
  for _ in range(2):
    state, loss = step(state, batch)
    losses.append(loss)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  want = dict(want, flash_attention_bwd=0, flash_attention_bwd_gqa=12)
  per = _per_step_launches(dict(ops.LAUNCHES), 2, want, "GQA training")
  losses = [float(first)] + [float(x) for x in losses]
  if not all(math.isfinite(x) for x in losses):
    raise AssertionError("non-finite GQA training loss: %s" % losses)
  log("  GQA (Hk 4) B%d: losses %s, %.1f ms/step (after a warm-up step), "
      "launches per step %s" % (GQA_B, losses, wall / 2 * 1e3, per))
  state, prof_loss, prof = profile_train_step(torch, step, state, batch)
  kernels = prof["port_kernels"]
  if "flash_attention_bwd" in kernels:
    kernels["flash_attention_bwd_gqa"] = kernels.pop("flash_attention_bwd")
  return {"batch": GQA_B, "losses": losses + [prof_loss],
          "ms_per_step": wall / 2 * 1e3,
          "tokens_per_s": GQA_B * TRAIN_S * 2 / wall,
          "launches_per_step": per, "profile": prof}


@contextlib.contextmanager
def env_var(name, value):
  """Environment variable ``name`` set to ``value`` inside the block."""
  before = os.environ.get(name)
  os.environ[name] = value
  try:
    yield
  finally:
    if before is None:
      os.environ.pop(name, None)
    else:
      os.environ[name] = before


def flash_bwd_env(mode):
  """``TFOS_TPU_FLASH_BWD`` set to ``mode`` inside the block, as the
  reference's executors read it (``scripts/submit_train.sh``)."""
  return env_var("TFOS_TPU_FLASH_BWD", mode)


def write_token_files(directory, vocab, seq, files=4, rows=4):
  """``files`` TFRecord files of ``rows`` seeded token rows each (schema
  ``struct<tokens:array<long>>``, lengths ``seq`` down to ``seq - 60``,
  so the collate pads some), written with the port's writer into a fresh
  ``directory``. Returns the glob pattern."""
  import numpy as np
  from tensorflowonspark_tpu_torch.data import example_codec, tfrecord
  shutil.rmtree(directory, ignore_errors=True)
  os.makedirs(directory)
  rng = np.random.default_rng(SEED + 9)
  for f in range(files):
    with tfrecord.TFRecordWriter(
        os.path.join(directory, "part-%05d.tfrecord" % f)) as w:
      for _ in range(rows):
        n = seq - int(rng.integers(0, 61))
        w.write(example_codec.encode_example(
            {"tokens": rng.integers(0, vocab, n).tolist()}))
  return os.path.join(directory, "part-*.tfrecord")


def train_long_gqa(torch, ops, sharding, readers, train_gpt):
  """Long-context grouped-KV training through the port's train_gpt: its
  config, state, loss and TFRecord batch stream, one batch staged ahead by
  ``device_prefetch``; a warm-up step, 2 timed steps with exact launch
  counts, then one profiled step."""
  t0 = time.monotonic()
  pattern = write_token_files(os.path.join(HERE, "build", "chip_smoke_tokens"),
                              32000, LONG_S)
  write_s = time.monotonic() - t0
  args = train_gpt.parse_args(LONG_ARGS + ["--data", pattern, "--steps", "4"])
  cfg = train_gpt.make_config(args)
  state = train_gpt.make_state(args, cfg)
  step = sharding.make_train_step(train_gpt.make_loss_fn(args))
  t0 = time.monotonic()
  batches = readers.device_prefetch(train_gpt.batch_stream(args), size=2)
  state, first = step(state, next(batches))          # warm-up
  torch.cuda.synchronize()
  warm_s = time.monotonic() - t0
  torch.cuda.reset_peak_memory_stats()
  ops.reset_launches()
  t0 = time.monotonic()
  losses = []
  for _ in range(2):
    state, loss = step(state, next(batches))
    losses.append(loss)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  per = _per_step_launches(dict(ops.LAUNCHES), 2, WANT_LONG_PER_STEP,
                           "long-context GQA training")
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  state, prof_loss, prof = profile_train_step(torch, step, state,
                                              next(batches))
  losses = [float(first)] + [float(x) for x in losses] + [prof_loss]
  if not all(math.isfinite(x) for x in losses):
    raise AssertionError("non-finite long-context training loss: %s"
                         % losses)
  tokens = LONG_B * LONG_S * 2
  res = {"batch": LONG_B, "seq": LONG_S, "num_kv_heads": cfg.num_kv_heads,
         "data": pattern, "write_s": write_s,
         "first_step_s_with_data": warm_s, "losses": losses,
         "ms_per_step": wall / 2 * 1e3, "tokens_per_s": tokens / wall,
         "launches_per_step": per, "peak_mem_gib": peak, "profile": prof}
  log("  TFRecords written in %.1f s; warm-up step (reader start included) "
      "%.1f s; losses %s" % (write_s, warm_s,
                             " ".join("%.4f" % x for x in losses)))
  log("  B%d x S%d Hk %d: %.1f ms/step, %.0f tokens/s, peak memory %.2f GiB, "
      "launches per step %s" % (LONG_B, LONG_S, cfg.num_kv_heads,
                                res["ms_per_step"], res["tokens_per_s"],
                                peak, per))
  return res


# -- phase 6h: [6d]'s training through the cluster runtime --------------------

CLUSTER_STEPS = 4
CLUSTER_MARK = "chip-smoke-deliberate-failure-6h"


def cluster_train_main(args, ctx):
  """[6h]'s main fn, run by ``cluster.run`` inside a LocalEngine executor:
  checks that the node was given one card, the driver's, then trains the
  port's ``train_gpt`` at ``LONG_ARGS`` for ``CLUSTER_STEPS`` steps from
  the TFRecord files at ``args["data"]`` (an absolute glob) and writes
  its losses, per-step launch counts, times, peak memory and card to the
  JSON file ``args["out"]``. Torch and the port are imported here, after
  the node exported ``CUDA_VISIBLE_DEVICES``."""
  t_enter = time.monotonic()
  import torch
  from tensorflowonspark_tpu_torch import ops
  from tensorflowonspark_tpu_torch.data import readers
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.parallel import sharding
  visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
  if not visible or "," in visible:
    raise AssertionError("the node should see one card, got "
                         "CUDA_VISIBLE_DEVICES=%r" % visible)
  card = torch.cuda.get_device_name()
  if card != args["card"]:
    raise AssertionError("the node runs on %r, the driver on %r"
                         % (card, args["card"]))
  t0 = time.monotonic()
  import_s = t0 - t_enter       # torch and the port, CUDA's first call
  ops.reset_launches()
  targs = train_gpt.parse_args(LONG_ARGS + ["--data", args["data"],
                                            "--steps", str(CLUSTER_STEPS)])
  cfg = train_gpt.make_config(targs)
  state = train_gpt.make_state(targs, cfg)
  step = sharding.make_train_step(train_gpt.make_loss_fn(targs))
  torch.cuda.synchronize()
  state_s = time.monotonic() - t0
  t0 = time.monotonic()
  batches = readers.device_prefetch(train_gpt.batch_stream(targs), size=2)
  losses, per_step = [], []

  def one_step(state):
    before = dict(ops.LAUNCHES)
    state, loss = step(state, next(batches))
    losses.append(loss)
    per_step.append({k: ops.LAUNCHES[k] - before[k] for k in before})
    return state

  state = one_step(state)                     # reader start included
  torch.cuda.synchronize()
  first_s = time.monotonic() - t0
  torch.cuda.reset_peak_memory_stats()
  t0 = time.monotonic()
  for _ in range(CLUSTER_STEPS - 1):
    state = one_step(state)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  timed = CLUSTER_STEPS - 1
  res = {"card": card, "cuda_visible_devices": visible,
         "executor_id": ctx.executor_id, "job_name": ctx.job_name,
         "losses": [float(x) for x in losses],
         "launches_per_step": per_step,
         "import_s": import_s, "state_s": state_s,
         "first_step_s_with_data": first_s,
         "ms_per_step": wall / timed * 1e3,
         "tokens_per_s": LONG_B * LONG_S * timed / wall,
         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
         "t_end_wall": time.time()}
  with open(args["out"], "w") as f:
    json.dump(res, f)


def cluster_failing_main(args, ctx):
  """A main fn that fails on purpose: its traceback must reach the
  driver's ``shutdown()``."""
  raise RuntimeError(CLUSTER_MARK)


def cluster_long_gqa(torch, pattern, long_res=None):
  """[6h]: ``cluster.run`` brings up one LocalEngine executor through the
  rendezvous with one card, and the executor trains [6d]'s configuration
  (``cluster_train_main``); then the failure paths on the same engine."""
  from tensorflowonspark_tpu_torch import cluster
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  from tensorflowonspark_tpu_torch.utils import gpu_info
  card = torch.cuda.get_device_name(0)
  out = os.path.join(HERE, "build", "chip_smoke_cluster.json")
  refused_out = os.path.join(HERE, "build", "chip_smoke_cluster_refused.json")
  for path in (out, refused_out):
    if os.path.exists(path):
      os.remove(path)
  args = {"data": os.path.abspath(pattern), "out": out, "card": card}
  t0 = time.monotonic()
  engine = LocalEngine(num_executors=1)
  engine_s = time.monotonic() - t0
  try:
    t0 = time.monotonic()
    c = cluster.run(engine, cluster_train_main, args,
                    input_mode=cluster.InputMode.TENSORFLOW,
                    chips_per_node=1, max_restarts=0,
                    reservation_timeout=300)
    reserve_s = time.monotonic() - t0
    t0, t0_wall = time.monotonic(), time.time()
    c.shutdown(timeout=900)
    shutdown_s = time.monotonic() - t0
    end_wall = time.time()
    if c.supervisor.restarts:
      raise AssertionError("the supervisor relaunched a node: %s"
                           % c.supervisor.restarts)
    with open(out) as f:
      res = json.load(f)
    for i, got in enumerate(res["launches_per_step"]):
      _per_step_launches(got, 1, WANT_LONG_PER_STEP,
                         "cluster step %d" % i)
    if len(res["losses"]) != CLUSTER_STEPS or not all(
        math.isfinite(x) for x in res["losses"]):
      raise AssertionError("cluster training losses: %s" % res["losses"])
    res.update(engine_start_s=engine_s, reserve_s=reserve_s,
               shutdown_call_s=shutdown_s,
               # the shutdown call waits for the fn; its own cost is the
               # tail after the fn's last write
               shutdown_after_fn_s=end_wall - max(t0_wall,
                                                  res["t_end_wall"]))
    log("  engine start %.3f s, cluster.run (spawn, hub, register, await) "
        "%.2f s, shutdown %.2f s after the fn returned (call %.1f s)"
        % (engine_s, reserve_s, res["shutdown_after_fn_s"], shutdown_s))
    log("  executor on %s (CUDA_VISIBLE_DEVICES=%s): imports %.1f s, "
        "weights from a seed %.1f s, first step with the reader %.2f s "
        "([6d]: %s s); losses %s" % (
            res["card"], res["cuda_visible_devices"], res["import_s"],
            res["state_s"], res["first_step_s_with_data"],
            "%.2f" % long_res["first_step_s_with_data"] if long_res
            else "not run",
            " ".join("%.4f" % x for x in res["losses"])))
    log("  B%d x S%d: %.1f ms/step, %.0f tokens/s, peak memory %.2f GiB; "
        "[6d] in this call: %s ms/step; launches per step %s" % (
            LONG_B, LONG_S, res["ms_per_step"], res["tokens_per_s"],
            res["peak_mem_gib"],
            "%.1f" % long_res["ms_per_step"] if long_res else "not run",
            res["launches_per_step"][-1]))

    c = cluster.run(engine, cluster_failing_main, None,
                    input_mode=cluster.InputMode.TENSORFLOW,
                    chips_per_node=1, max_restarts=0,
                    reservation_timeout=300)
    try:
      c.shutdown(timeout=300)
    except RuntimeError as e:
      if CLUSTER_MARK not in str(e) or "Traceback" not in str(e):
        raise AssertionError("shutdown raised without the executor's "
                             "traceback: %s" % e)
      log("  a failing main fn: shutdown() raised with the executor's "
          "traceback (%d chars)" % len(str(e)))
    else:
      raise AssertionError("shutdown() of a failing main fn did not raise")
    res["failure_traceback_at_driver"] = True

    count = len(gpu_info.query_gpus())
    t0 = time.monotonic()
    try:
      c = cluster.run(engine, cluster_train_main,
                      dict(args, out=refused_out),
                      input_mode=cluster.InputMode.TENSORFLOW,
                      chips_per_node=count + 1, max_restarts=0,
                      reservation_timeout=300)
      c.shutdown(timeout=300)
    except RuntimeError as e:
      want = "nvidia-smi counts %d card(s)" % count
      if want not in str(e):
        raise AssertionError("over-asked bring-up failed without %r: %s"
                             % (want, e))
    else:
      raise AssertionError("chips_per_node=%d on a host with %d card(s) "
                           "was not refused" % (count + 1, count))
    if os.path.exists(refused_out):
      raise AssertionError("the user fn ran although bring-up was refused")
    res["over_ask_refused_s"] = time.monotonic() - t0
    log("  chips_per_node=%d with %d card(s): bring-up refused in %.2f s, "
        "before the fn ran" % (count + 1, count, res["over_ask_refused_s"]))
  finally:
    engine.stop()
  return res


# -- phase 6k: [6d] checkpointed, killed and resumed under cluster.run -------

CKPT_STEPS = 5
CKPT_KILL = "train-step@0#3"          # executor 0, after step 2 is durable
CKPT_SCHEMA = "struct<tokens:array<long>>"


def ckpt_train(pattern, mgr=None, ctx=None, out=None):
  """[6d]'s configuration trained ``CKPT_STEPS`` steps from ``pattern``
  through ``checkpointable_input`` and ``device_prefetch``. With ``mgr``
  (in an executor): ``restore_or`` first, then after each step ``save``
  with the input position of the batch the step consumed, ``wait`` and
  the ``train-step`` kill point; each step's record goes to the JSON file
  ``out`` before the kill point. Returns (state, record)."""
  import collections
  import torch
  from tensorflowonspark_tpu_torch import ops
  from tensorflowonspark_tpu_torch.data import indexed, readers
  from tensorflowonspark_tpu_torch.data.schema import parse_schema
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils import chaos, checkpoint
  ops.reset_launches()
  t0 = t_start = time.monotonic()
  targs = train_gpt.parse_args(LONG_ARGS + ["--data", pattern, "--steps",
                                            str(CKPT_STEPS)])
  state = train_gpt.make_state(targs, train_gpt.make_config(targs))
  step = sharding.make_train_step(train_gpt.make_loss_fn(targs))
  it = indexed.checkpointable_input(
      pattern, batch_size=LONG_B, schema=parse_schema(CKPT_SCHEMA),
      seed=SEED, collate=functools.partial(
          train_gpt.pad_tokens, seq_len=targs.seq_len, vocab=targs.vocab))
  torch.cuda.synchronize()
  res = {"t_start": t_start, "state_s": time.monotonic() - t0,
         "start_step": 0, "steps": [], "restore_s": None}
  if mgr is not None:
    t0 = time.monotonic()
    state, res["start_step"] = mgr.restore_or(state, data_iterator=it)
    torch.cuda.synchronize()
    res["restore_s"] = time.monotonic() - t0
  # device_prefetch reads ahead: the position saved with a step is the one
  # after the batch that step consumed, not the reader's
  positions = collections.deque()

  def tracked():
    for batch in it:
      positions.append(it.get_state())
      yield batch

  batches = readers.device_prefetch(tracked(), size=2)
  for s in range(res["start_step"], CKPT_STEPS):
    before = dict(ops.LAUNCHES)
    t0 = time.monotonic()
    state, loss = step(state, next(batches))
    rec = {"step": s, "loss": float(loss), "position": positions.popleft(),
           "launches": {k: ops.LAUNCHES[k] - before[k] for k in before}}
    rec["step_s"] = time.monotonic() - t0
    rec["t_loss"] = time.monotonic()
    res["steps"].append(rec)
    if mgr is None:
      continue
    ctx.report_progress(s)
    t0 = time.monotonic()
    mgr.save(s, state, data_state=rec["position"])
    mgr.wait()
    rec["save_s"] = time.monotonic() - t0
    rec["save"] = mgr.last_save
    rec["t_saved"] = time.monotonic()
    checkpoint.atomic_write_json(out, res)
    chaos.kill_point("train-step", ctx.executor_id)
  return state, res


def ckpt_main(args, ctx):
  """[6k]'s main fn, run by ``cluster.run`` inside a LocalEngine executor
  armed with ``TOS_CHAOS_KILL``: checks it was given the driver's card,
  trains through ``ckpt_train`` with ``ctx.checkpoint_manager``, and the
  chief exports the final weights with ``ctx.export_model``."""
  t_enter = time.monotonic()
  import torch
  from tensorflowonspark_tpu_torch.utils import checkpoint
  visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
  if not visible or "," in visible:
    raise AssertionError("the node should see one card, got "
                         "CUDA_VISIBLE_DEVICES=%r" % visible)
  if torch.cuda.get_device_name() != args["card"]:
    raise AssertionError("the node runs on %r, the driver on %r"
                         % (torch.cuda.get_device_name(), args["card"]))
  out = args["out"] % ctx.restart_count
  mgr = ctx.checkpoint_manager(args["ckpt"], save_interval_steps=1,
                               max_to_keep=2)
  state, res = ckpt_train(args["data"], mgr, ctx, out)
  res.update(t_enter=t_enter, restart_count=ctx.restart_count,
             is_chief=ctx.is_chief)
  if ctx.is_chief:
    t0 = time.monotonic()
    res["export_dir"] = ctx.export_model(state.params, args["export"])
    res["export_s"] = time.monotonic() - t0
  mgr.close()
  checkpoint.atomic_write_json(out, res)


def ckpt_resume(torch, pattern, long_res=None):
  """[6k]: [6d]'s configuration trained ``CKPT_STEPS`` steps in the driver,
  then under ``cluster.run`` in an executor SIGKILLed after step 2 is
  durable, relaunched by the supervisor and resumed from its checkpoint;
  the losses must equal the driver's to the bit, the export its weights'
  fingerprint, and each step's launch counts [6d]'s."""
  from tensorflowonspark_tpu_torch import cluster
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  from tensorflowonspark_tpu_torch.utils import chaos, checkpoint, compat
  card = torch.cuda.get_device_name(0)
  build = os.path.join(HERE, "build")
  ckpt_dir = os.path.join(build, "chip_smoke_ckpt")
  export_dir = os.path.join(build, "chip_smoke_export")
  out = os.path.join(build, "chip_smoke_ckpt_%d.json")
  for path in (ckpt_dir, export_dir):
    shutil.rmtree(path, ignore_errors=True)
  for i in (0, 1):
    if os.path.exists(out % i):
      os.remove(out % i)
  data = os.path.abspath(pattern)

  state, direct = ckpt_train(data)
  want_fp = checkpoint.params_fingerprint(state.params)
  del state
  torch.cuda.empty_cache()
  direct_losses = [r["loss"] for r in direct["steps"]]
  for r in direct["steps"]:
    _per_step_launches(r["launches"], 1, WANT_LONG_PER_STEP,
                       "[6k] direct step %d" % r["step"])
  direct_ms = statistics.median(r["step_s"] for r in direct["steps"][1:]) * 1e3
  log("  direct: %d steps in the driver, losses %s, %.1f ms/step (median "
      "after the first, each step synchronised), weights %s" % (
          CKPT_STEPS, " ".join("%.6f" % x for x in direct_losses), direct_ms,
          want_fp))

  args = {"data": data, "ckpt": ckpt_dir, "export": export_dir, "out": out,
          "card": card}
  engine = LocalEngine(num_executors=1, env={chaos.ENV_KILL: CKPT_KILL})
  try:
    t0 = time.monotonic()
    c = cluster.run(engine, ckpt_main, args,
                    input_mode=cluster.InputMode.FILES, chips_per_node=1,
                    max_restarts=1, heartbeat_interval=2.0,
                    restart_backoff=0.5, restart_backoff_cap=2.0,
                    reservation_timeout=300)
    c.shutdown(timeout=900)
    cluster_s = time.monotonic() - t0
    restarts, events = dict(c.supervisor.restarts), list(c.supervisor.events)
  finally:
    engine.stop()
  if restarts != {0: 1}:
    raise AssertionError("supervisor restarts %s, want {0: 1}; events %s"
                         % (restarts, events))
  inc = []
  for i in (0, 1):
    with open(out % i) as f:
      inc.append(json.load(f))
  first, second = inc
  if [r["step"] for r in first["steps"]] != [0, 1, 2] or \
      second["start_step"] != 3 or second["restart_count"] != 1:
    raise AssertionError("killed after steps %s, resumed at step %s"
                         % ([r["step"] for r in first["steps"]],
                            second["start_step"]))
  losses = [r["loss"] for r in first["steps"] + second["steps"]]
  if losses != direct_losses:
    raise AssertionError("resumed losses %s differ from the direct run's %s"
                         % (losses, direct_losses))
  for r in first["steps"] + second["steps"]:
    _per_step_launches(r["launches"], 1, WANT_LONG_PER_STEP,
                       "[6k] step %d" % r["step"])
  got_fp = checkpoint.params_fingerprint(compat.import_model(export_dir))
  if got_fp != want_fp:
    raise AssertionError("exported weights %s, direct run's %s"
                         % (got_fp, want_fp))
  kinds = [e["kind"] for e in events]
  ev = {e["kind"]: e["t"] for e in events}
  t_kill = first["steps"][-1]["t_saved"]
  saves = [r["save_s"] for r in first["steps"] + second["steps"]]
  res = {"card": card, "losses": losses, "fingerprint": got_fp,
         "restarts": restarts, "events": kinds,
         "checkpoint_bytes": first["steps"][-1]["save"]["bytes"],
         "save_wait_s": saves,
         "save_split_s": {k: [r["save"][k] for r in first["steps"]
                              + second["steps"]]
                          for k in ("host_s", "write_s", "commit_s")},
         "restore_s": second["restore_s"],
         "kill_to_detected_s": ev["detected-dead"] - t_kill,
         "detected_to_relaunched_s": ev["relaunched"] - ev["detected-dead"],
         "relaunched_to_fn_s": second["t_enter"] - ev["relaunched"],
         "imports_s": second["t_start"] - second["t_enter"],
         "state_s": second["state_s"],
         "first_step_s": second["steps"][0]["step_s"],
         "kill_to_first_loss_s": second["steps"][0]["t_loss"] - t_kill,
         "export_s": second["export_s"], "cluster_s": cluster_s,
         "direct_ms_per_step": direct_ms,
         "ms_per_step": [statistics.median(r["step_s"] for r in x["steps"][1:])
                         * 1e3 for x in inc],
         "step_ms": {"direct": [r["step_s"] * 1e3 for r in direct["steps"]],
                     "incarnations": [[r["step_s"] * 1e3 for r in x["steps"]]
                                      for x in inc]},
         "launches_per_step": [r["launches"] for r in first["steps"]
                               + second["steps"]]}
  log("  killed after step 2, resumed at step 3 (restarts %s, events %s); "
      "%d losses equal the direct run's to the bit; export %s" % (
          restarts, kinds, len(losses), got_fp))
  log("  one checkpoint %d bytes; save + wait %s s (copy to the host %s, "
      "write %s, commit %s); restore %.2f s" % (
          res["checkpoint_bytes"], " ".join("%.2f" % s for s in saves),
          *(" ".join("%.2f" % s for s in res["save_split_s"][k])
            for k in ("host_s", "write_s", "commit_s")), res["restore_s"]))
  log("  kill -> first resumed loss %.1f s: detection %.1f s, backoff and "
      "relaunch %.1f s, spawn and bring-up to the fn %.1f s, imports %.1f s, "
      "weights from the seed %.1f s, restore %.1f s, first step %.2f s" % (
          res["kill_to_first_loss_s"], res["kill_to_detected_s"],
          res["detected_to_relaunched_s"], res["relaunched_to_fn_s"],
          res["imports_s"], res["state_s"], res["restore_s"],
          res["first_step_s"]))
  log("  ms/step (median after each incarnation's first, synchronised): "
      "incarnations %s, direct %.1f, [6d] in this call %s; launches per step "
      "%s" % (" ".join("%.1f" % x for x in res["ms_per_step"]), direct_ms,
              "%.1f" % long_res["ms_per_step"] if long_res else "not run",
              res["launches_per_step"][-1]))
  log("  each step's ms: direct %s; incarnations %s" % (
      " ".join("%.1f" % x for x in res["step_ms"]["direct"]),
      " | ".join(" ".join("%.1f" % x for x in xs)
                 for xs in res["step_ms"]["incarnations"])))
  shutil.rmtree(ckpt_dir)
  shutil.rmtree(export_dir)
  return res


# -- phase 6n: [6d] with Adafactor, remat "dots" and the native codec --------

OPTIONS_STEPS = 2
OPTIONS_REMAT = ("off", "none", "dots")
# remat off: no block re-runs its forward (flash, ln1, ln2) in the backward
WANT_LONG_OFF_PER_STEP = dict(WANT_LONG_PER_STEP, flash_attention_fwd=12,
                              layer_norm=25)
# the products "dots" saves and "none" recomputes: q, k, v, out and up of
# each of 12 layers (the recompute stops before down under both policies:
# the backward never reads down's output)
DOTS_SAVED_GEMMS = 5 * 12
DOTS_LOSS_REL = 1e-3
_GEMM_PARTS = ("gemm", "nvjet", "xmma", "cutlass")


def gemm_by_kernel(rows):
  """Launches of each library matrix-product kernel among the profiler's
  rows (the port's own kernels excluded), by kernel name."""
  return {key: count for key, _, count in rows if _port_kernel(key) is None
          and any(p in key.lower() for p in _GEMM_PARTS)}


def gemm_kernels(rows):
  """Launches of library matrix-product kernels among the profiler's
  rows (the port's own kernels excluded)."""
  return sum(gemm_by_kernel(rows).values())


def state_bytes(tree):
  """Bytes of every tensor in an optimizer state (host counters aside)."""
  from tensorflowonspark_tpu_torch.parallel import collectives
  return sum(t.numel() * t.element_size()
             for t in collectives.tensors_of(tree))


def codec_check(pattern):
  """[6n-a]: every record of ``pattern``'s files read by the native codec
  and by the pure-Python framing (byte-equal lists), the first file framed
  again by the Python writer (byte-equal file), and the host ms a row of
  each reader and of the Example decode."""
  import glob
  from tensorflowonspark_tpu_torch.data import dfutil, tfrecord
  from tensorflowonspark_tpu_torch.data.schema import parse_schema
  sch = parse_schema(CKPT_SCHEMA)
  files = sorted(glob.glob(pattern))
  secs = {"native": 0.0, "python": 0.0, "decode": 0.0}
  rows = tokens = nbytes = 0
  for i, path in enumerate(files):
    t0 = time.perf_counter()
    native = list(tfrecord.NativeTFRecordReader(path))
    t1 = time.perf_counter()
    plain = list(tfrecord.PyTFRecordReader(path))
    t2 = time.perf_counter()
    decoded = [dfutil.from_example(r, sch) for r in native]
    t3 = time.perf_counter()
    secs["native"] += t1 - t0
    secs["python"] += t2 - t1
    secs["decode"] += t3 - t2
    if native != plain or not native:
      raise AssertionError("%s: the native and the Python readers disagree "
                           "(%d and %d records)" % (path, len(native),
                                                    len(plain)))
    if i == 0:
      again = path + ".python"
      with tfrecord.PyTFRecordWriter(again) as w:
        for r in plain:
          w.write(r)
      with open(path, "rb") as a, open(again, "rb") as b:
        if a.read() != b.read():
          raise AssertionError("%s: the Python writer frames other bytes "
                               "than the native codec" % path)
      os.remove(again)
    rows += len(native)
    tokens += sum(len(d[0]) for d in decoded)
    nbytes += sum(len(r) for r in native)
  per_row = {k: v * 1e3 / rows for k, v in secs.items()}
  res = {"files": len(files), "rows": rows, "tokens": tokens,
         "record_bytes": nbytes, "ms_per_row": per_row,
         "tokens_per_row": tokens / rows}
  log("  %d rows (%.0f tokens, %.0f bytes a row) byte-equal through both "
      "readers; host ms a row: native framing + CRC %.3f, Python framing + "
      "CRC %.3f, Example decode %.3f" % (
          rows, tokens / rows, nbytes / rows, per_row["native"],
          per_row["python"], per_row["decode"]))
  return res


def options_run(torch, ops, sharding, readers, train_gpt, pattern, remat):
  """[6n-b]: [6d]'s configuration through train_gpt with ``--optimizer
  adafactor`` and remat ``remat`` ("off": ``cfg.remat`` False): a warm-up
  step, 2 timed steps with exact launch counts and the peak memory, one
  profiled step."""
  import dataclasses
  policy = "none" if remat == "off" else remat
  args = train_gpt.parse_args(LONG_ARGS + [
      "--data", pattern, "--steps", "4", "--optimizer", "adafactor",
      "--remat_policy", policy])
  cfg = train_gpt.make_config(args)
  if remat == "off":
    cfg = dataclasses.replace(cfg, remat=False)
  state = train_gpt.make_state(args, cfg)
  step = sharding.make_train_step(train_gpt.make_loss_fn(args))
  batches = readers.device_prefetch(train_gpt.batch_stream(args), size=2)
  state, first = step(state, next(batches))          # warm-up
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  ops.reset_launches()
  t0 = time.monotonic()
  losses = []
  for _ in range(OPTIONS_STEPS):
    state, loss = step(state, next(batches))
    losses.append(loss)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  launches = dict(ops.LAUNCHES)
  peak = torch.cuda.max_memory_allocated()
  state, prof_loss, prof = _profile_step(torch, step, state, next(batches))
  losses = [float(first)] + [float(x) for x in losses] + [float(prof_loss)]
  res = {"remat": remat, "losses": losses,
         "ms_per_step": wall / OPTIONS_STEPS * 1e3,
         "tokens_per_s": LONG_B * LONG_S * OPTIONS_STEPS / wall,
         "peak_mem_bytes": peak, "opt_state_bytes": state_bytes(
             state.opt_state), "gemm_kernels": prof["gemm_kernels"],
         "profile": prof}
  log("  remat %-4s: %.1f ms/step, %.0f tokens/s, peak %.3f GiB, profiled "
      "step %d library GEMM kernels (wall %.1f ms, device busy %.1f ms), "
      "losses %s" % (remat, res["ms_per_step"], res["tokens_per_s"],
                     peak / 2 ** 30, res["gemm_kernels"], prof["wall_ms"],
                     prof["device_busy_ms"],
                     " ".join(repr(x) for x in losses)))
  want = WANT_LONG_OFF_PER_STEP if remat == "off" else WANT_LONG_PER_STEP
  res["launches_per_step"] = _per_step_launches(
      launches, OPTIONS_STEPS, want, "[6n] adafactor, remat %s" % remat)
  if not all(math.isfinite(x) for x in losses):
    raise AssertionError("[6n] remat %s: non-finite loss %s"
                         % (remat, losses))
  return res


def train_options(torch, ops, sharding, readers, train_gpt):
  """[6n]: [6d]'s TFRecord files written by the native codec and checked
  against the Python framing (a), then [6d] trained with Adafactor under
  remat off, "none" and "dots" (b); the "dots" losses against "none"'s
  (c), the peak memory and the optimizer state's bytes against AdamW's
  (d), the launches and the profiled step's library GEMMs (e), ms/step
  and tokens/s (f)."""
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.data import tfrecord
  from tensorflowonspark_tpu_torch.utils.params import param_specs
  t0 = time.monotonic()
  pattern = write_token_files(
      os.path.join(HERE, "build", "chip_smoke_tokens_6n"), 32000, LONG_S)
  write_s = time.monotonic() - t0
  log("[6n-a] TFRecords written by the native codec (%s) in %.3f s"
      % (tfrecord.library_path().name, write_s))
  codec = codec_check(pattern)
  codec["write_s"] = write_s
  log("[6n-b] train_gpt --optimizer adafactor, remat off / none / dots, "
      "B%d x S%d Hk 4, from those files" % (LONG_B, LONG_S))
  runs = {}
  for remat in OPTIONS_REMAT:
    runs[remat] = options_run(torch, ops, sharding, readers, train_gpt,
                              pattern, remat)
    torch.cuda.empty_cache()
  off, none, dots = (runs[k] for k in OPTIONS_REMAT)
  rel = max(abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(dots["losses"], none["losses"]))
  log("[6n-c] dots losses %s none's (largest relative difference %r); "
      "off %s none's" % (
          "equal to the bit to" if dots["losses"] == none["losses"]
          else "differ from", rel,
          "equal to the bit to" if off["losses"] == none["losses"]
          else "differ from"))
  if rel > DOTS_LOSS_REL:
    raise AssertionError("[6n] dots losses %s against none's %s"
                         % (dots["losses"], none["losses"]))
  cfg = train_gpt.make_config(train_gpt.parse_args(LONG_ARGS))
  meta = {n: torch.empty(spec[0], device="meta")
          for n, spec in param_specs(cfg).items()}
  adamw_bytes = state_bytes(optim.make_optimizer(
      learning_rate=3e-4, clip_norm=1.0).init(meta))
  peaks = {k: r["peak_mem_bytes"] for k, r in runs.items()}
  log("[6n-d] peak memory off %d, dots %d, none %d bytes; optimizer state "
      "of %d weights: Adafactor %d bytes, AdamW %d" % (
          peaks["off"], peaks["dots"], peaks["none"],
          sum(t.numel() for t in meta.values()), dots["opt_state_bytes"],
          adamw_bytes))
  if not peaks["off"] > peaks["dots"] > peaks["none"]:
    raise AssertionError("[6n] peak memory not in the order off > dots > "
                         "none: %s" % peaks)
  gemms = {k: r["gemm_kernels"] for k, r in runs.items()}
  log("[6n-e] library GEMM kernels in the profiled step: off %d, none %d, "
      "dots %d (none - dots = %d; want %d)"
      % (gemms["off"], gemms["none"], gemms["dots"],
         gemms["none"] - gemms["dots"], DOTS_SAVED_GEMMS))
  if gemms["none"] - gemms["dots"] != DOTS_SAVED_GEMMS \
      or gemms["dots"] != gemms["off"]:
    for k in OPTIONS_REMAT:
      prof = runs[k]["profile"]
      log("  remat %s: %d kernel launches in the profiled step; library "
          "GEMMs by kernel %s" % (k, prof["kernel_launches"], sorted(
              (n, name[:120]) for name, n in prof["gemm_by_kernel"].items())))
    raise AssertionError("[6n] the profiled steps' GEMMs %s: dots must "
                         "launch %d fewer than none and as many as off"
                         % (gemms, DOTS_SAVED_GEMMS))
  log("[6n-f] ms/step: off %.1f, none %.1f, dots %.1f; tokens/s: off %.0f, "
      "none %.0f, dots %.0f" % tuple(
          [runs[k]["ms_per_step"] for k in OPTIONS_REMAT]
          + [runs[k]["tokens_per_s"] for k in OPTIONS_REMAT]))
  return {"codec": codec, "runs": runs, "adamw_state_bytes": adamw_bytes,
          "dots_max_rel_loss_diff": rel}


def options_launches(res, name):
  """[6n]'s launches of kernel ``name`` in each run's timed steps."""
  return {"train_options_%s_%d_steps" % (k, OPTIONS_STEPS):
          int(r["launches_per_step"][name] * OPTIONS_STEPS)
          for k, r in res["runs"].items()}


def options_summary(res):
  return {"codec_ms_per_row": res["codec"]["ms_per_row"],
          "adamw_state_bytes": res["adamw_state_bytes"],
          "runs": {k: {f: r[f] for f in ("ms_per_step", "tokens_per_s",
                                         "peak_mem_bytes", "opt_state_bytes",
                                         "gemm_kernels", "losses")}
                   for k, r in res["runs"].items()}}


# -- phases 6i and 6j: the flagship fed through the engine feed plane --------

# 6 partitions of 32 rows: 4 steps of B16, then 2 slabs of 4 steps
FEED_PER_STEP, FEED_UNROLL, FEED_SLABS = 4, 4, 2
FEED_PARTS, FEED_PART_ROWS = 6, 2 * TRAIN_B
FEED_CEILING_PARTS, FEED_CEILING_PART_ROWS = 4, 256     # 1024 rows, 4 MiB
INFER_PARTS, INFER_PART_ROWS = 4, TRAIN_B
WANT_INFER_PER_FORWARD = {"flash_attention_fwd": 12, "layer_norm": 25}
FEED_MARK = "chip-smoke-deliberate-failure-6i"


def feed_rows(n, seed):
  """``n`` seeded int32 token rows of length TRAIN_S, one array per row (so
  every feed chunk is columnar)."""
  import numpy as np
  rng = np.random.default_rng(seed)
  return list(rng.integers(0, 32000, (n, TRAIN_S), dtype=np.int32))


def _split(rows, size):
  return [rows[i:i + size] for i in range(0, len(rows), size)]


def _no_tf32(torch):
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False


def feed_train_pieces(torch):
  """[6]'s training pieces: the flagship at full width with weights from
  SEED, ``make_optimizer(3e-4, clip_norm=1.0)``, the train step and the
  unroll-4 loop. The driver's direct run and the executor build the same."""
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils.params import init_params
  cfg = tfm.TransformerConfig()
  state = tfm.create_state(cfg, init_params(cfg, seed=SEED),
                           tx=optim.make_optimizer(learning_rate=3e-4,
                                                   clip_norm=1.0))
  loss_fn = _lm_loss(tfm)
  return (state, sharding.make_train_step(loss_fn),
          sharding.make_train_loop(loss_fn, unroll=FEED_UNROLL))


def feed_steps(torch, ops, pieces, batches, slabs):
  """FEED_PER_STEP steps on ``batches`` through the unroll loop's per-step
  path (the first takes the kernels' and the allocator's start, the next
  FEED_PER_STEP - 2 are timed, the last is profiled), then FEED_SLABS
  slabs of ``slabs`` through its fused path, timed. Launch counts per
  optimizer step on both paths; losses, ms/step and the profile, unlogged.
  Under the obs plane also the process's ``xla.compiles`` after each
  batch."""
  from torch.profiler import ProfilerActivity, profile
  from tensorflowonspark_tpu_torch.obs import metrics as obs_metrics
  state, _, loop = pieces
  reg = obs_metrics.active()
  compiles = []

  def step(state, batch):
    state, got = loop(state, batch)
    return state, got[0]

  def after_batch():
    if reg is not None:
      compiles.append(reg.counter("xla.compiles").value)

  losses, launches = [], []
  # a process's first profiler session starts CUPTI inside its window (a
  # fresh executor's profiled step ran 42% idle against [6]'s 13%): open
  # and close one first, so the profiled step measures the step
  t0 = time.monotonic()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    torch.cuda.synchronize()
  profiler_start_s = time.monotonic() - t0
  ops.reset_launches()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.monotonic()
  for i in range(FEED_PER_STEP):
    before = dict(ops.LAUNCHES)
    if i == FEED_PER_STEP - 1:
      state, loss, prof = _profile_step(torch, step, state, next(batches))
    else:
      state, loss = step(state, next(batches))
    losses.append(loss)
    launches.append({k: ops.LAUNCHES[k] - before[k] for k in before})
    after_batch()
    if i == 0:
      torch.cuda.synchronize()
      first_s = time.monotonic() - t0
      t0 = time.monotonic()
    elif i == FEED_PER_STEP - 2:
      torch.cuda.synchronize()
      step_wall = time.monotonic() - t0
  t0 = time.monotonic()
  for _ in range(FEED_SLABS):
    before = dict(ops.LAUNCHES)
    state, got = loop(state, next(slabs))
    losses += list(got)
    launches.append({k: (ops.LAUNCHES[k] - before[k]) / FEED_UNROLL
                     for k in before})
    after_batch()
  torch.cuda.synchronize()
  slab_wall = time.monotonic() - t0
  steps, slab_steps = FEED_PER_STEP - 2, FEED_SLABS * FEED_UNROLL
  return {"losses": [float(x) for x in losses], "launches_per_step": launches,
          "profiler_start_s": profiler_start_s, "first_step_s": first_s,
          "compiles_by_batch": compiles,
          "timed_ms_per_step": (step_wall + slab_wall) / (steps + slab_steps)
          * 1e3,
          "ms_per_step": step_wall / steps * 1e3,
          "tokens_per_s": TRAIN_B * TRAIN_S * steps / step_wall,
          "slab_ms_per_step": slab_wall / slab_steps * 1e3,
          "slab_tokens_per_s": TRAIN_B * TRAIN_S * slab_steps / slab_wall,
          "rows_per_s": TRAIN_B * slab_steps / slab_wall,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "profile": prof}


def _node_card(torch, args):
  visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
  if not visible or "," in visible:
    raise AssertionError("the node should see one card, got "
                         "CUDA_VISIBLE_DEVICES=%r" % visible)
  card = torch.cuda.get_device_name()
  if card != args["card"]:
    raise AssertionError("the node runs on %r, the driver on %r"
                         % (card, args["card"]))
  return card


def feed_train_main(args, ctx):
  """[6i]'s main fn, run in a LocalEngine executor's background process
  (InputMode.SPARK): [6]'s training on the rows the driver's
  ``Cluster.train`` feeds, read through ``ctx.get_data_feed()`` —
  FEED_PER_STEP steps from ``device_prefetch(feed_batches(...))``, then
  FEED_SLABS slabs from ``slab_batches``, then the end of feed that
  ``shutdown()`` sends. Writes its losses, launch counts, times, the
  feed's stats and channels to the JSON file ``args["out"]``."""
  import itertools
  t_enter = time.monotonic()
  import torch
  from tensorflowonspark_tpu_torch import ops
  from tensorflowonspark_tpu_torch.data import readers
  _no_tf32(torch)
  card = _node_card(torch, args)
  t0 = time.monotonic()
  import_s = t0 - t_enter
  pieces = feed_train_pieces(torch)
  torch.cuda.synchronize()
  state_s = time.monotonic() - t0
  feed = ctx.get_data_feed()
  batches = readers.device_prefetch(itertools.islice(
      readers.feed_batches(feed, TRAIN_B), FEED_PER_STEP), size=2)
  slabs = readers.slab_batches(feed, TRAIN_B, unroll=FEED_UNROLL)
  res = feed_steps(torch, ops, pieces, batches, slabs)
  for _ in slabs:                      # the end of feed from shutdown()
    raise AssertionError("the feed gave more than %d slabs" % FEED_SLABS)
  from tensorflowonspark_tpu_torch.obs import device as obs_device
  res.update(card=card, import_s=import_s, state_s=state_s,
             peak_bytes=torch.cuda.max_memory_allocated(),
             sentinel_errors=obs_device.SENTINEL_ERRORS["count"],
             stats=dict(feed.stats), channels=feed.channel_chunks(),
             ring_name=ctx.hub.get("ring_name"), batches=len(
                 res["losses"]), t_end_wall=time.time())
  with open(args["out"], "w") as f:
    json.dump(res, f)


def feed_ceiling_main(args, ctx):
  """The feed's own ceiling: every row the driver feeds, through
  ``device_prefetch(feed_batches(feed, TRAIN_B))`` onto the card, no
  step. Rows/s from the first batch on the card to the last."""
  import torch
  from tensorflowonspark_tpu_torch.data import readers
  _node_card(torch, args)
  feed = ctx.get_data_feed()
  rows = nbytes = 0
  t_first = t_last = None
  for batch in readers.device_prefetch(readers.feed_batches(feed, TRAIN_B),
                                       size=2):
    torch.cuda.synchronize()
    t_last = time.monotonic()
    if t_first is None:
      t_first = t_last                 # the clock starts at the first batch
    else:
      rows += batch.shape[0]
      nbytes += batch.numel() * batch.element_size()
  span = t_last - t_first
  with open(args["out"], "w") as f:
    json.dump({"rows_after_first": rows, "seconds": span,
               "rows_per_s": rows / span, "mb_per_s": nbytes / span / 1e6,
               "stats": dict(feed.stats), "channels": feed.channel_chunks()},
              f)


def feed_failing_main(args, ctx):
  """A consumer that fails after its first batch: its traceback must reach
  the driver's ``train`` or ``shutdown()``."""
  ctx.get_data_feed().next_batch_arrays(TRAIN_B)
  raise RuntimeError(FEED_MARK)


def infer_rows(torch, model, batch):
  """[6j]'s per-row result of one bf16 forward: (mean next-token loss,
  last-position argmax) for each row of ``batch``."""
  import numpy as np
  import torch.nn.functional as F
  with torch.inference_mode():
    tokens = torch.from_numpy(np.array(batch)).to(model.device)
    logits = model(tokens)
    b, s, v = logits.shape
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, v),
                         tokens[:, 1:].reshape(-1).long(), reduction="none")
    loss = ce.view(b, s - 1).mean(1)
    top = logits[:, -1].argmax(-1)
    return list(zip(loss.tolist(), top.tolist()))


def feed_infer_main(args, ctx):
  """[6j]'s main fn: the flagship's bf16 forward at full width on each
  batch ``ctx.get_data_feed(train_mode=False)`` gives (a partition's rows),
  one result per row back through ``batch_results``; writes the launch
  counts per forward to ``args["out"]``."""
  import torch
  from tensorflowonspark_tpu_torch import ops
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils.params import init_params
  _no_tf32(torch)
  _node_card(torch, args)
  cfg = tfm.TransformerConfig()
  model = tfm.Transformer(cfg, init_params(cfg, seed=SEED))
  feed = ctx.get_data_feed(train_mode=False)
  launches = []
  ops.reset_launches()
  while not feed.should_stop():
    batch = feed.next_batch_arrays(INFER_PART_ROWS)
    if len(batch):
      before = dict(ops.LAUNCHES)
      results = infer_rows(torch, model, batch)
      launches.append({k: ops.LAUNCHES[k] - before[k] for k in before})
      feed.batch_results(results)
  with open(args["out"], "w") as f:
    json.dump({"launches_per_forward": launches,
               "channels": feed.channel_chunks()}, f)


def _fresh(path):
  if os.path.exists(path):
    os.remove(path)
  return path


def _cluster(cluster, engine, fn, args, **kw):
  t0 = time.monotonic()
  c = cluster.run(engine, fn, args, input_mode=cluster.InputMode.SPARK,
                  chips_per_node=1, max_restarts=0, reservation_timeout=300,
                  **kw)
  return c, time.monotonic() - t0


def _check_steps(res, what):
  for i, got in enumerate(res["launches_per_step"]):
    _per_step_launches(got, 1, WANT_PER_STEP, "%s step %d" % (what, i))
  if len(res["losses"]) != FEED_PER_STEP + FEED_SLABS * FEED_UNROLL or \
      not all(math.isfinite(x) for x in res["losses"]):
    raise AssertionError("%s losses: %s" % (what, res["losses"]))


def feed_direct(torch, ops, rows):
  """[6i]'s direct run in the driver: [6]'s steps on ``rows`` from a plain
  iterator, the per-step batches through ``device_prefetch``."""
  import numpy as np
  from tensorflowonspark_tpu_torch.data import readers
  from tensorflowonspark_tpu_torch.data.readers import Slab
  step_rows = FEED_PER_STEP * TRAIN_B
  batches = readers.device_prefetch(
      iter([np.stack(b) for b in _split(rows[:step_rows], TRAIN_B)]), size=2)
  slabs = iter([Slab(np.stack(s).reshape(FEED_UNROLL, TRAIN_B, TRAIN_S))
                for s in _split(rows[step_rows:], TRAIN_B * FEED_UNROLL)])
  direct = feed_steps(torch, ops, feed_train_pieces(torch), batches, slabs)
  _check_steps(direct, "direct run")
  torch.cuda.empty_cache()
  return direct


def feed_ceiling(cluster, engine, args, transport, rows):
  """The feed's ceiling on one transport: ``rows`` drained onto the card
  by ``feed_ceiling_main``, with the driver's ``train`` seconds."""
  out = _fresh(os.path.join(HERE, "build", "chip_smoke_feed_ceiling.json"))
  c, _ = _cluster(cluster, engine, feed_ceiling_main, dict(args, out=out),
                  feed_transport=transport)
  t0 = time.monotonic()
  c.train(_split(rows, FEED_CEILING_PART_ROWS), num_epochs=1)
  train_s = time.monotonic() - t0
  c.shutdown(timeout=600)
  with open(out) as f:
    got = json.load(f)
  if got["rows_after_first"] != len(rows) - TRAIN_B:
    raise AssertionError("%s ceiling: %d rows after the first batch"
                         % (transport, got["rows_after_first"]))
  got["train_call_s"] = train_s
  return got


def feed_train(torch, ops, cluster, engine, card, rows, direct,
               train_res=None):
  """[6i]: ``rows`` through ``cluster.run(..., InputMode.SPARK)`` and
  ``Cluster.train`` between two direct runs (``direct`` before, one more
  after: the host's pace drifts within a call); the feed's ceiling on the
  shm ring (with and without the codec's wire encodings) and on the hub
  queue; a consumer that fails."""
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  out = _fresh(os.path.join(HERE, "build", "chip_smoke_feed.json"))
  args = {"out": out, "card": card}
  c, run_s = _cluster(cluster, engine, feed_train_main, args)
  if c.cluster_meta["feed_transport"] != "shm":
    raise AssertionError("feed_transport 'auto' resolved to %r on a "
                         "LocalEngine" % c.cluster_meta["feed_transport"])
  t0 = time.monotonic()
  c.train(_split(rows, FEED_PART_ROWS), num_epochs=1)
  train_s = time.monotonic() - t0
  t0, t0_wall = time.monotonic(), time.time()
  c.shutdown(timeout=900)
  shutdown_s = time.monotonic() - t0
  end_wall = time.time()
  if c.supervisor.restarts:
    raise AssertionError("the supervisor relaunched a node: %s"
                         % c.supervisor.restarts)
  with open(out) as f:
    res = json.load(f)
  _check_steps(res, "fed")
  after = feed_direct(torch, ops, rows)
  for run in (res, after):
    if run["losses"] != direct["losses"]:
      raise AssertionError("losses differ from the first direct run's:\n%s"
                           "\n%s" % (run["losses"], direct["losses"]))
  stats = res["stats"]
  if stats["chunks"] != FEED_PARTS or \
      stats["columnar_chunks"] != stats["chunks"]:
    raise AssertionError("feed chunks: %s (want %d, all columnar)"
                         % (stats, FEED_PARTS))
  chan = res["channels"]
  if not res["ring_name"] or chan is None or chan["queue"] or \
      chan["ring"] < FEED_PARTS + 1:
    raise AssertionError("the shm ring did not carry the input: ring %r, "
                         "channels %s" % (res["ring_name"], chan))
  batches = FEED_PER_STEP + FEED_SLABS
  res.update(direct=direct, direct_after=after, cluster_run_s=run_s,
             train_call_s=train_s,
             shutdown_call_s=shutdown_s,
             shutdown_after_fn_s=end_wall - max(t0_wall, res["t_end_wall"]),
             per_batch_ms={k: stats[k] / batches * 1e3
                           for k in ("fetch_s", "decode_s", "assemble_s")})
  pe = res["profile"]
  for what, run in (("before", direct), ("after", after)):
    pd = run["profile"]
    log("  direct run in the driver, %s the fed run: first step %.2f s, "
        "%.1f ms/step (%.0f tokens/s), unroll-4 slabs %.1f ms/step; "
        "profiled step wall %.2f ms, device busy %.2f ms (idle %.0f%%)" % (
            what, run["first_step_s"], run["ms_per_step"],
            run["tokens_per_s"], run["slab_ms_per_step"], pd["wall_ms"],
            pd["device_busy_ms"],
            100.0 * (1 - pd["device_busy_ms"] / pd["wall_ms"])))
  log("  fed, in the executor on %s: imports %.1f s, weights %.1f s, a "
      "first profiler session %.2f s, first step %.2f s; %.1f ms/step (%.0f "
      "tokens/s), slabs %.1f ms/step (%.0f tokens/s, %.0f rows/s); profiled "
      "step wall %.2f ms, device busy %.2f ms (idle %.0f%%); peak memory "
      "%.2f GiB" % (
          res["card"], res["import_s"], res["state_s"],
          res["profiler_start_s"], res["first_step_s"],
          res["ms_per_step"], res["tokens_per_s"], res["slab_ms_per_step"],
          res["slab_tokens_per_s"], res["rows_per_s"], pe["wall_ms"],
          pe["device_busy_ms"],
          100.0 * (1 - pe["device_busy_ms"] / pe["wall_ms"]),
          res["peak_mem_gib"]))
  log("  %d losses equal to both direct runs' to the bit; launches per step "
      "%s on both paths; %d chunks, all columnar, over ring %s (%s); feed "
      "per batch: fetch %.3f ms (the fetch thread's reads, waits for the "
      "feeder included), decode %.3f ms, assemble %.3f ms" % (
          len(res["losses"]), res["launches_per_step"][0], stats["chunks"],
          res["ring_name"], chan, res["per_batch_ms"]["fetch_s"],
          res["per_batch_ms"]["decode_s"], res["per_batch_ms"]["assemble_s"]))
  log("  cluster.run %.2f s, train %.2f s, shutdown %.2f s after the fn "
      "returned (call %.1f s); [6] in this call: %s ms/step" % (
          run_s, train_s, res["shutdown_after_fn_s"], shutdown_s,
          "%.1f" % train_res["per_step"]["ms_per_step"] if train_res
          else "not run"))

  ceiling_rows = feed_rows(FEED_CEILING_PARTS * FEED_CEILING_PART_ROWS,
                           SEED + 11)
  res["ceiling"] = {t: feed_ceiling(cluster, engine, args, t, ceiling_rows)
                    for t in ("shm", "queue")}
  # the same on the ring with the codec's wire encodings off (the
  # driver's partition encode and the executor's feeder both read the
  # variable): how much of the ceiling is the zlib probe of token ids
  with env_var("TOS_FEED_WIRE_ENCODINGS", "none"):
    raw_engine = LocalEngine(num_executors=1)
    try:
      res["ceiling"]["shm_raw"] = feed_ceiling(cluster, raw_engine, args,
                                               "shm", ceiling_rows)
    finally:
      raw_engine.stop()
  for transport, got in res["ceiling"].items():
    log("  feed ceiling, %s: %d rows (%.0f MiB) at %.0f rows/s, %.1f MB/s "
        "(%.1fx the rows/s the fed slabs consume; the fetch thread waited "
        "%.2f of %.2f s; driver's train call %.2f s)" % (
            transport, len(ceiling_rows), len(ceiling_rows) * TRAIN_S * 4
            / 2 ** 20, got["rows_per_s"], got["mb_per_s"],
            got["rows_per_s"] / res["rows_per_s"], got["stats"]["fetch_s"],
            got["seconds"], got["train_call_s"]))

  c, _ = _cluster(cluster, engine, feed_failing_main, args)
  errors = []
  for call in (lambda: c.train(_split(rows, FEED_PART_ROWS)),
               lambda: c.shutdown(timeout=300)):
    try:
      call()
    except RuntimeError as e:
      errors.append(str(e))
  if not errors or not any(FEED_MARK in e and "Traceback" in e
                           for e in errors):
    raise AssertionError("a failing consumer's traceback did not reach the "
                         "driver: %s" % errors)
  res["failure_traceback_at_driver"] = len(errors)
  log("  a consumer failing after its first batch: %d of train/shutdown "
      "raised with its traceback" % len(errors))
  return res


def feed_inference(torch, ops, tfm, cluster, engine, card, params, cfg):
  """[6j]: ``Cluster.inference`` over INFER_PARTS x INFER_PART_ROWS rows;
  per-row results in partition order, equal to the same forward in the
  driver on the same batches."""
  rows = feed_rows(INFER_PARTS * INFER_PART_ROWS, SEED + 12)
  parts = _split(rows, INFER_PART_ROWS)
  out = _fresh(os.path.join(HERE, "build", "chip_smoke_feed_infer.json"))
  c, run_s = _cluster(cluster, engine, feed_infer_main,
                      {"out": out, "card": card})
  t0 = time.monotonic()
  got = c.inference(parts)
  infer_s = time.monotonic() - t0
  c.shutdown(timeout=600)
  with open(out) as f:
    res = json.load(f)
  for i, per in enumerate(res["launches_per_forward"]):
    _per_step_launches(per, 1, dict({k: 0 for k in per},
                                    **WANT_INFER_PER_FORWARD),
                       "fed forward %d" % i)
  model = tfm.Transformer(cfg, params)
  want = [r for p in parts for r in infer_rows(torch, model, p)]
  del model
  torch.cuda.empty_cache()
  got = [tuple(r) for r in got]
  if len(got) != len(rows) or got != want:
    raise AssertionError("inference through the feed: %d results, first "
                         "difference at %s" % (len(got), next(
                             (i for i, (a, b) in enumerate(zip(got, want))
                              if a != b), None)))
  res.update(results=len(got), cluster_run_s=run_s, inference_call_s=infer_s,
             rows_per_s=len(rows) / infer_s)
  log("  %d results in partition order, equal to the driver's forward to the "
      "bit; %d forwards of %s launches; inference call %.2f s (%.0f rows/s, "
      "the executor's cold start included); cluster.run %.2f s" % (
          len(got), len(res["launches_per_forward"]), WANT_INFER_PER_FORWARD,
          infer_s, res["rows_per_s"], run_s))
  return res


def feed_phases(torch, ops, tfm, card, params, cfg, train_res=None):
  """[6i] and [6j]: the direct run first, then one LocalEngine(1)."""
  from tensorflowonspark_tpu_torch import cluster
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  torch.cuda.empty_cache()
  log("[6i] [6]'s training fed through cluster.run(LocalEngine(1), ..., "
      "InputMode.SPARK) and Cluster.train, beside a direct run")
  rows = feed_rows(FEED_PARTS * FEED_PART_ROWS, SEED + 10)
  direct = feed_direct(torch, ops, rows)
  engine = LocalEngine(num_executors=1)
  try:
    train = feed_train(torch, ops, cluster, engine, card, rows, direct,
                       train_res)
    log("[6j] inference through Cluster.inference, bf16, full width")
    infer = feed_inference(torch, ops, tfm, cluster, engine, card, params,
                           cfg)
  finally:
    engine.stop()
  return {"train": train, "inference": infer}


# -- phase 6o: the observability plane ----------------------------------------

OBS_PAIRS = 3                      # --obs-only: interleaved off/on fed runs
OBS_BUDGET = 0.03                  # docs/OBSERVABILITY.md: at most 3% a step


class _DropLedger(object):
  """Wraps a driver sink's ``ingest``: the last ``drops`` each (executor,
  shipper label) sent. The sink keeps one executor's newest message only,
  and a node's and a feeder's shipper share the executor id."""

  def __init__(self, sink):
    self.last = {}
    inner = sink.ingest

    def ingest(msg):
      self.last[(msg.get("executor_id"), msg.get("label"))] = dict(
          msg.get("drops") or {})
      return inner(msg)

    sink.ingest = ingest


def obs_feed_run(torch, cluster, card_name, rows, obs_dir=None):
  """[6i]'s fed run — ``feed_train_main`` on ``rows`` through
  ``cluster.run(LocalEngine(1), ..., InputMode.SPARK)`` and
  ``Cluster.train`` — with the obs plane on (``TOS_OBS=1``, JSONL logs
  under ``obs_dir``) or off. Returns the executor's record, plus the
  driver's sink, detector, ``HEALTH`` reply and drop ledger when on."""
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  from tensorflowonspark_tpu_torch.obs import metrics, spans
  os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
  out = _fresh(os.path.join(HERE, "build", "chip_smoke_obs_feed.json"))
  env = {} if obs_dir is None else {"TOS_OBS": "1", "TOS_OBS_DIR": obs_dir}
  with contextlib.ExitStack() as stack:
    for k, v in env.items():
      stack.enter_context(env_var(k, v))
    engine = LocalEngine(num_executors=1, env=env)
    try:
      t0 = time.monotonic()
      c, _ = _cluster(cluster, engine, feed_train_main,
                      {"out": out, "card": card_name})
      ledger = _DropLedger(c.obs_sink) if c.obs_sink is not None else None
      c.train(_split(rows, FEED_PART_ROWS), num_epochs=1)
      health = None
      if obs_dir is not None:
        # the run is still on: the executor waits for the end of feed
        from tensorflowonspark_tpu_torch.control import rendezvous
        client = rendezvous.Client(tuple(c.server.addr), timeout=30)
        health = client._request({"type": "HEALTH"})
        client.close()
      c.shutdown(timeout=900)
      run_s = time.monotonic() - t0
    finally:
      engine.stop()
      metrics.deactivate()        # the driver's registry and recorder
      spans.deactivate()
  if c.supervisor.restarts:
    raise AssertionError("the supervisor relaunched a node: %s"
                         % c.supervisor.restarts)
  with open(out) as f:
    res = json.load(f)
  _check_steps(res, "fed (obs %s)" % ("on" if obs_dir else "off"))
  res["run_s"] = run_s
  return res, (c, health, ledger)


def _check_same_run(res, ref, what):
  if res["losses"] != ref["losses"]:
    raise AssertionError("%s: losses differ from the obs-off run's:\n%s\n%s"
                         % (what, res["losses"], ref["losses"]))
  if res["launches_per_step"] != ref["launches_per_step"]:
    raise AssertionError("%s: launches per step %s, obs off %s" % (
        what, res["launches_per_step"], ref["launches_per_step"]))


def _spans_by_name(trace):
  by = {}
  for e in trace["traceEvents"]:
    if e.get("ph") == "X":
      by.setdefault(e["name"], []).append(e)
  return by


def obs_feed_gates(res, ref, plane, obs_dir):
  """[6o](a)'s fatal gates on an obs-on fed run ``res`` against the
  obs-off run ``ref``; returns the feed's stage shares and the trace's
  span counts."""
  from tensorflowonspark_tpu_torch.obs import export
  c, health, ledger = plane
  what = "[6o] fed run, obs on"
  _check_same_run(res, ref, what)
  sink, rows = c.obs_sink, FEED_PARTS * FEED_PART_ROWS
  steps = FEED_PER_STEP + FEED_SLABS * FEED_UNROLL
  batches = FEED_PER_STEP + FEED_SLABS
  got = {k: sink.aggregate(k) for k in ("feed.rows", "feed.wire_rows",
                                        "train.steps", "device.peak_bytes",
                                        "xla.compiles", "feed.fetch_s",
                                        "feed.decode_s", "feed.assemble_s")}
  want = {"feed.rows": rows, "feed.wire_rows": rows, "train.steps": steps}
  for k, v in want.items():
    if got[k] != v:
      raise AssertionError("%s: sink %s = %s, want %s" % (what, k, got[k], v))
  peak = got["device.peak_bytes"]
  if not res["peak_bytes"] * 0.99 <= peak <= res["peak_bytes"]:
    raise AssertionError("%s: device.peak_bytes %d against the executor's "
                         "max_memory_allocated %d" % (what, peak,
                                                      res["peak_bytes"]))
  comp = res["compiles_by_batch"]
  if len(comp) != batches or comp[1:FEED_PER_STEP] != \
      [comp[0]] * (FEED_PER_STEP - 1) or \
      comp[FEED_PER_STEP + 1:] != [comp[FEED_PER_STEP]] * (FEED_SLABS - 1):
    raise AssertionError("%s: xla.compiles advanced after a path's first "
                         "step: %s" % (what, comp))
  drops = {k: v for k, v in ledger.last.items()}
  bad = {k: v for k, v in drops.items()
         if v.get("ship_failures") or v.get("spans_lost")
         or v.get("spans_dropped")}
  if bad or sink.spans_dropped or res["sentinel_errors"] or \
      len(drops) != 2:
    raise AssertionError("%s: drops %s, sink spans_dropped %d, sentinel "
                         "errors %d" % (what, drops, sink.spans_dropped,
                                        res["sentinel_errors"]))
  entry = (health or {}).get("obs", {}).get("0")
  if entry is None or not entry["ships"] or \
      "feed.rows" not in entry["metrics"]:
    raise AssertionError("%s: HEALTH during the run carried no obs summary "
                         "of executor 0: %s" % (what, health))
  if c.alerts() or c.detector.summary()["eval_failures"]:
    raise AssertionError("%s: alerts on a healthy run: %s (%s)" % (
        what, c.alerts(), c.detector.summary()))
  procs = export.merge_jsonl(export.find_logs(obs_dir))
  trace = export.chrome_trace(procs)
  tracks = sorted(e["args"]["name"] for e in trace["traceEvents"]
                  if e.get("name") == "process_name")
  if tracks != ["driver0", "exec0", "feeder0"]:
    raise AssertionError("%s: trace tracks %s" % (what, tracks))
  by = _spans_by_name(trace)
  # one feed.batch per batch the loop took (a slab's rows come in one)
  fed = [e for e in by.get("feed.batch", []) if e["args"].get("rows")]
  counts = {"train.slab": len(by.get("train.slab", [])),
            "feed.batch": len(fed),
            "feed.batch rows": sum(e["args"]["rows"] for e in fed)}
  if counts != {"train.slab": batches, "feed.batch": batches,
                "feed.batch rows": rows}:
    raise AssertionError("%s: trace spans %s, want %d train.slab and "
                         "feed.batch, %d rows" % (what, counts, batches, rows))
  lo = min(e["ts"] for e in by["cluster.assemble"])
  hi = max(e["ts"] + e["dur"] for e in by["cluster.shutdown"])
  outside = [e["name"] for e in by["train.slab"] + fed
             if e["ts"] < lo or e["ts"] + e["dur"] > hi]
  if outside:
    raise AssertionError("%s: %d executor spans outside the driver's "
                         "cluster.run window" % (what, len(outside)))
  stages = {k: got["feed.%s" % k] for k in ("fetch_s", "decode_s",
                                            "assemble_s")}
  total = sum(stages.values())
  return {"sink": got, "stage_s": stages,
          "stage_share": {k: v / total for k, v in stages.items()},
          "trace_spans": counts, "tracks": tracks,
          "health_ships": entry["ships"]}


def obs_mfu(ms_per_step):
  """MFU of [6]'s step at ``ms_per_step`` by ``obs.profiler.mfu`` against
  the card's dense bf16 peak."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.obs import profiler
  from tensorflowonspark_tpu_torch.utils.params import init_params
  cfg = tfm.TransformerConfig()
  n = sum(int(v.size) for v in init_params(cfg, seed=SEED).values())
  fpt = profiler.transformer_flops_per_token(n, cfg.num_layers, cfg.d_model,
                                             TRAIN_S)
  return profiler.mfu(fpt, TRAIN_B * TRAIN_S / (ms_per_step / 1e3),
                      profiler.PEAK_BF16_FLOPS["h100"])


def obs_serving(torch, ops, tfm, ServingEngine, slots, params, cfg, ref):
  """[6o](b): [4]'s 16 requests with the registry and the recorder active
  in the driver (no warm-up: the engine's handles are cached at
  construction, and warm-up requests would join the counts). ``ref`` is
  [4]'s obs-off result."""
  from tensorflowonspark_tpu_torch.obs import export, metrics, quantiles
  from tensorflowonspark_tpu_torch.obs import slo, spans
  reg, rec = metrics.activate(), spans.activate()
  try:
    res, model = serve_main_path(torch, ops, tfm, ServingEngine, slots,
                                 params, cfg, warm=False)
  finally:
    metrics.deactivate()
    spans.deactivate()
  del model
  what = "[6o] serving, obs on"
  if res["outputs"] != ref["outputs"]:
    raise AssertionError("%s: outputs differ from [4]'s obs-off outputs"
                         % what)
  snap, records = reg.snapshot(), rec.drain(None)
  n = len(ref["outputs"])
  names = [r["name"] for r in records]
  lanes = [r["attrs"]["tokens"] for r in records
           if r["name"] == "serve.decode.slot"]
  counts = {k: snap[k]["value"] for k in ("serve.completed", "serve.tokens",
                                          "serve.prefills", "serve.steps")}
  if counts["serve.completed"] != n or \
      counts["serve.tokens"] + counts["serve.prefills"] != \
      res["generated_tokens"] or sum(lanes) != counts["serve.tokens"]:
    raise AssertionError("%s: %s, %d generated tokens, %d by the lane "
                         "spans" % (what, counts, res["generated_tokens"],
                                    sum(lanes)))
  dispatches = res["decode_steps"] // 4
  if names.count("serve.decode") != dispatches or \
      snap["serve.decode_ms"]["count"] != dispatches:
    raise AssertionError("%s: %d serve.decode spans, %d decode_ms, %d "
                         "dispatches" % (what, names.count("serve.decode"),
                                         snap["serve.decode_ms"]["count"],
                                         dispatches))
  sk = quantiles.QuantileSketch.from_dict(snap["serve.ttft_ms"]["data"])
  exact = res["ttft_ms_exact"]
  if sk.count != n:
    raise AssertionError("%s: serve.ttft_ms counts %d" % (what, sk.count))
  for q in (0.5, 0.99):
    # the sketch's answer must sit within its stated rank error of q
    rank = sum(1 for v in exact if v <= sk.quantile(q))
    if abs(rank - q * n) > sk.rank_error + 1:
      raise AssertionError("%s: p%g %.3f ms at rank %d of %d (error %d)"
                           % (what, 100 * q, sk.quantile(q), rank, n,
                              sk.rank_error))
  with env_var(slo.ENV_SLO_TTFT_MS, "%d" % (2 * max(exact) + 1)):
    objs = slo.objectives_from_env()
  tracker = slo.SLOTracker(objectives=objs, window=60.0, min_events=1)
  tracker.sample(0.0, {0: {}})
  tracker.sample(1.0, {0: snap})
  verdicts = tracker.evaluate(1.0)
  if any(v["burning"] for v in verdicts) or \
      not any(v["name"].startswith("ttft") for v in verdicts):
    raise AssertionError("%s: SLO verdicts %s" % (what, verdicts))
  text = export.prometheus_text(snap, labels={"proc": "driver"})
  for line in text.splitlines():
    head, _, value = line.rpartition(" ")
    if not (line.startswith("# TYPE tos_") or
            (head.startswith("tos_") and math.isfinite(float(value)))):
      raise AssertionError("%s: prometheus line %r" % (what, line))
  res.update(obs={"counts": counts, "decode_spans": dispatches,
                  "ttft_p50_sketch": sk.quantile(0.5),
                  "ttft_p99_sketch": sk.quantile(0.99),
                  "rank_error": sk.rank_error,
                  "slo": [{k: v.get(k) for k in ("name", "burning",
                                                 "burn_fast")}
                          for v in verdicts],
                  "prometheus_lines": len(text.splitlines())})
  log("  %d requests served with the obs plane on: outputs equal [4]'s to "
      "the bit; %s; %d serve.decode spans = dispatches; TTFT sketch p50 "
      "%.1f ms p99 %.1f ms (exact %.1f / %.1f, rank error %d); no SLO burn "
      "at TTFT <= %d ms; %d Prometheus lines; launches %s" % (
          n, counts, dispatches, sk.quantile(0.5), sk.quantile(0.99),
          res["ttft_ms_p50"], res["ttft_ms_p99"], sk.rank_error,
          2 * max(exact) + 1, len(text.splitlines()), res["launches"]))
  return res


OBS_FAST_INTERVAL = 0.2          # (d): ten times the default ship cadence
OBS_SEAM_ROUNDS, OBS_SEAM_STEPS = 3, 10


def _sink_server(addr_q, stop):
  """A rendezvous server with an ``ObsSink``, in a process of its own (the
  driver's side of the wire, as in a cluster run)."""
  sys.path.insert(0, HERE)
  from tensorflowonspark_tpu_torch.control import rendezvous
  from tensorflowonspark_tpu_torch.obs import collector
  server = rendezvous.Server(1)
  server.obs_sink = collector.ObsSink()
  addr_q.put(server.start())
  stop.wait(900)
  server.stop()


def _busy_ms(torch, fn, a, calls=20):
  """Median host ms of ``fn`` called with ~30 ms of matmuls queued on the
  card (busy, as under a training step)."""
  out = []
  for _ in range(calls):
    for _ in range(20):
      a @ a
    t0 = time.perf_counter()
    fn()
    out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
  return statistics.median(out)


def obs_seam_costs(torch, tfm, card):
  """(d) Where an obs overhead would come from, in the driver: the host ms
  of one memory sample (and of the driver calls in it) and of one ship,
  each with the card busy; then [6]'s per-step training in rounds of
  OBS_SEAM_STEPS steps, interleaved over OBS_SEAM_ROUNDS rounds: the plane
  off; its step seams (registry and recorder active: ``note_trace``, the
  loop's counter and span); the seams and a shipper with the memory
  sampler every OBS_FAST_INTERVAL s into a sink in another process; the
  seams and the memory sampler alone at that cadence."""
  import multiprocessing as mp
  import threading
  import numpy as np
  from tensorflowonspark_tpu_torch.obs import collector
  from tensorflowonspark_tpu_torch.obs import device as obs_device
  from tensorflowonspark_tpu_torch.obs import metrics, profiler, spans
  from tensorflowonspark_tpu_torch.parallel import sharding
  ctx = mp.get_context("spawn")
  addr_q, stop = ctx.Queue(), ctx.Event()
  proc = ctx.Process(target=_sink_server, args=(addr_q, stop), daemon=True)
  proc.start()
  res = {}
  try:
    addr = tuple(addr_q.get(timeout=120))
    state = feed_train_pieces(torch)[0]
    loss_fn = _lm_loss(tfm)
    batch = np.random.default_rng(SEED).integers(
        0, state.model.cfg.vocab_size, (TRAIN_B, TRAIN_S), dtype=np.int32)
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    reg = metrics.MetricsRegistry()
    shipper = collector.ObsShipper(addr, 0, registry=reg,
                                   recorder=spans.SpanRecorder(),
                                   interval=60, label="exec")
    sample = obs_device.make_memory_sampler(reg)
    for i in range(40):                  # an executor's registry, roughly
      reg.counter("bench.c%d" % i).inc(i)
      reg.histogram("bench.h%d" % (i % 4)).observe(float(i))
    res["host_ms"] = {
        "memory_sample": _busy_ms(torch, profiler.device_memory_stats, a),
        "mem_get_info": _busy_ms(torch, lambda: torch.cuda.mem_get_info(0),
                                 a),
        "memory_stats": _busy_ms(torch, lambda: torch.cuda.memory_stats(0),
                                 a),
        "ship": _busy_ms(torch, lambda: (reg.counter("bench.tick").inc(),
                                         shipper.ship(timeout=10)), a)}
    shipper.stop(timeout=5)
    del a

    def run(state, variant):
      """One round of ``variant``: (state, ms/step)."""
      if variant != "off":
        metrics.activate()
        spans.activate()
      loop = sharding.make_train_loop(loss_fn, unroll=FEED_UNROLL)
      halt = threading.Event()
      ship = thread = None
      if variant == "seams+shipper":
        ship = collector.ObsShipper(addr, 0, interval=OBS_FAST_INTERVAL,
                                    label="exec")
        ship.add_sampler(obs_device.make_memory_sampler(ship.registry))
        ship.start()
      elif variant == "seams+sampler":
        tick = obs_device.make_memory_sampler(metrics.active())

        def sampling():
          while not halt.wait(OBS_FAST_INTERVAL):
            tick()

        thread = threading.Thread(target=sampling, daemon=True)
        thread.start()
      try:
        state, _ = loop(state, batch)                # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OBS_SEAM_STEPS):
          state, _ = loop(state, batch)
        torch.cuda.synchronize()
        return state, (time.perf_counter() - t0) / OBS_SEAM_STEPS * 1e3
      finally:
        halt.set()
        if ship is not None:
          ship.stop(timeout=5)
        if thread is not None:
          thread.join(timeout=5)
        metrics.deactivate()
        spans.deactivate()

    variants = ("off", "seams", "seams+shipper", "seams+sampler")
    times = {v: [] for v in variants}
    for r in range(OBS_SEAM_ROUNDS):
      for v in (variants if r % 2 == 0 else variants[::-1]):
        state, ms = run(state, v)
        times[v].append(ms)
    res["ms_per_step"] = {v: statistics.median(t) for v, t in times.items()}
    res["rounds"] = times
  finally:
    stop.set()
    proc.join(timeout=30)
  off = res["ms_per_step"]["off"]
  log("  (d) host ms with the card busy: a memory sample %.3f (mem_get_info "
      "%.3f, memory_stats %.3f), a ship %.3f; [6]'s per-step ms/step, "
      "median of %d rounds of %d: %s (against off: %s); %s" % (
          res["host_ms"]["memory_sample"], res["host_ms"]["mem_get_info"],
          res["host_ms"]["memory_stats"], res["host_ms"]["ship"],
          OBS_SEAM_ROUNDS, OBS_SEAM_STEPS,
          ", ".join("%s %.2f" % kv for kv in res["ms_per_step"].items()),
          ", ".join("%s %+.2f%%" % (v, 100 * (t / off - 1))
                    for v, t in res["ms_per_step"].items() if v != "off"),
          card))
  return res


def obs_phase(torch, ops, tfm, ServingEngine, slots, card, params, cfg,
              feed_ref=None, serve_ref=None, pairs=0):
  """[6o]: (a) [6i]'s fed training under ``TOS_OBS=1`` against an obs-off
  fed run (``feed_ref``: [6i]'s, or one made here), (b) [4]'s serving
  with the registry on against ``serve_ref`` ([4]'s, or one made here),
  (c) with ``pairs``, that many more interleaved off/on fed runs and the
  median obs overhead per step."""
  from tensorflowonspark_tpu_torch import cluster
  torch.cuda.empty_cache()
  log("[6o] the observability plane: [6i]'s fed training under TOS_OBS=1, "
      "[4]'s serving with the registry on")
  rows = feed_rows(FEED_PARTS * FEED_PART_ROWS, SEED + 10)
  name = torch.cuda.get_device_name(0)      # what the node must run on
  if feed_ref is None:
    feed_ref, _ = obs_feed_run(torch, cluster, name, rows)
  obs_dir = os.path.join(HERE, "build", "chip_smoke_obs")
  shutil.rmtree(obs_dir, ignore_errors=True)
  on, plane = obs_feed_run(torch, cluster, name, rows, obs_dir)
  gates = obs_feed_gates(on, feed_ref, plane, obs_dir)
  share = gates["stage_share"]
  log("  fed run under TOS_OBS=1: 12 losses and per-step launches equal to "
      "the obs-off run's; sink feed.rows %d = feed.wire_rows, train.steps "
      "%d, device.peak_bytes %d (executor's max_memory_allocated %d); "
      "xla.compiles %d, none after a path's first step; no drop, no "
      "alert; HEALTH carried executor 0 (%d ships); tracks %s, spans %s" % (
          gates["sink"]["feed.rows"], gates["sink"]["train.steps"],
          gates["sink"]["device.peak_bytes"], on["peak_bytes"],
          gates["sink"]["xla.compiles"], gates["health_ships"],
          gates["tracks"], gates["trace_spans"]))
  log("  feed stages (sink feed.* seconds): fetch %.3f s (%.1f%%), decode "
      "%.3f s (%.1f%%), assemble %.3f s (%.1f%%)" % (
          gates["stage_s"]["fetch_s"], 100 * share["fetch_s"],
          gates["stage_s"]["decode_s"], 100 * share["decode_s"],
          gates["stage_s"]["assemble_s"], 100 * share["assemble_s"]))
  log("  ms/step obs on %.1f (per-step) %.1f (slabs) %.1f (all 10 timed), "
      "obs off %.1f / %.1f / %.1f; MFU %.3f on, %.3f off (obs.profiler.mfu, "
      "989e12 peak); %s" % (
          on["ms_per_step"], on["slab_ms_per_step"], on["timed_ms_per_step"],
          feed_ref["ms_per_step"], feed_ref["slab_ms_per_step"],
          feed_ref["timed_ms_per_step"], obs_mfu(on["timed_ms_per_step"]),
          obs_mfu(feed_ref["timed_ms_per_step"]), card))
  res = {"feed_on": on, "feed_off": feed_ref, "gates": gates,
         "mfu_on": obs_mfu(on["timed_ms_per_step"]),
         "mfu_off": obs_mfu(feed_ref["timed_ms_per_step"])}
  if serve_ref is None:
    serve_ref, model = serve_main_path(torch, ops, tfm, ServingEngine, slots,
                                       params, cfg)
    del model
  torch.cuda.empty_cache()
  res["serve"] = obs_serving(torch, ops, tfm, ServingEngine, slots, params,
                             cfg, serve_ref)
  torch.cuda.empty_cache()
  if pairs:
    over = []
    for i in range(pairs):
      off, _ = obs_feed_run(torch, cluster, name, rows)
      shutil.rmtree(obs_dir, ignore_errors=True)
      on_i, plane = obs_feed_run(torch, cluster, name, rows, obs_dir)
      obs_feed_gates(on_i, feed_ref, plane, obs_dir)
      _check_same_run(off, feed_ref, "[6o](c) obs-off run %d" % i)
      over.append(on_i["timed_ms_per_step"] / off["timed_ms_per_step"] - 1)
      log("  pair %d: obs off %.2f ms/step, on %.2f ms/step (%+.2f%%)" % (
          i, off["timed_ms_per_step"], on_i["timed_ms_per_step"],
          100 * over[-1]))
    med = statistics.median(over)
    res["overhead"] = {"per_pair": over, "median": med,
                       "budget": OBS_BUDGET}
    log("  obs overhead, median of %d interleaved pairs: %+.2f%% per step "
        "(budget %.0f%%, reported, not gated); %s" % (
            pairs, 100 * med, 100 * OBS_BUDGET, card))
    torch.cuda.empty_cache()
    res["seams"] = obs_seam_costs(torch, tfm, card)
  return res


# -- phase 6p: the serving fleet and the chaos fault sites -------------------

FLEET_REPLICAS = 2
FLEET_KILL = "dispatch@1#3:kill"     # (c): replica 1's 3rd dispatch consult
FLEET_CRASH = "decode#3:raise"       # (e): the bare engine's 3rd decode
FLEET_STREAMED = 1                   # (c): the request read through stream()


def _fleet_factory(ServingEngine, params, cfg):
  """The replicas' factory: [4]'s engine on [4]'s weights, on the card."""
  return lambda: ServingEngine(params, cfg, num_slots=8, horizon=4,
                               max_new_tokens=MAIN_NEW)


def _warm_replicas(fl, cfg):
  """[4]'s warm-up on each replica directly (no fleet dispatch, so no chaos
  consult): cuBLAS handles and first launches of each loop thread."""
  for rep in fl._replicas.values():
    rep.engine.generate(_prompts((40, 130), cfg.vocab_size, SEED + 7),
                        max_new_tokens=4, timeout=600)


def _engine_counts(engines):
  return {id(e): (e.stats["prefills"], e.stats["steps"]) for e in engines}


def _fleet_launch_check(what, launches, engines, before, cfg, chunks=None):
  """The launch rule of [4] over every engine a fleet phase ran: 12 flash
  forwards a prefill (the fresh-cache first chunk) and 25 LayerNorm
  forwards a forward, prefill chunk or decode step. ``chunks`` (the prefill
  chunks of the phase's prompts, each prefilled once) makes the LayerNorm
  count exact; without it (a replay prefills some prompts again) it is a
  floor."""
  prefills = sum(e.stats["prefills"] - before.get(id(e), (0, 0))[0]
                 for e in engines)
  steps = sum(e.stats["steps"] - before.get(id(e), (0, 0))[1]
              for e in engines)
  per_forward = 2 * cfg.num_layers + 1
  want_flash = cfg.num_layers * prefills
  if launches["flash_attention_fwd"] != want_flash:
    raise AssertionError("%s: flash attention launched %d times, %d "
                         "prefills need %d" % (
                             what, launches["flash_attention_fwd"], prefills,
                             want_flash))
  if chunks is not None:
    want_ln = per_forward * (chunks + steps)
    if launches["layer_norm"] != want_ln:
      raise AssertionError("%s: layer_norm launched %d times, the path needs "
                           "%d (25 x (%d chunks + %d steps))" % (
                               what, launches["layer_norm"], want_ln, chunks,
                               steps))
  elif launches["layer_norm"] < per_forward * steps:
    raise AssertionError("%s: layer_norm launched %d times, under 25 a "
                         "step for %d steps" % (what, launches["layer_norm"],
                                                steps))
  return {"prefills": prefills, "steps": steps}


def _ttft_ms(freqs):
  ttft = sorted(f.ttft * 1e3 for f in freqs)
  return (statistics.median(ttft),
          ttft[min(len(ttft) - 1, int(math.ceil(0.99 * len(ttft))) - 1)])


def _same_outputs(what, outs, want):
  bad = [i for i, (o, w) in enumerate(zip(outs, want)) if o != w]
  if len(outs) != len(want) or bad:
    raise AssertionError("%s: outputs of requests %s differ from (a)'s bare "
                         "engine" % (what, bad or "(count)"))


def fleet_served(torch, ops, fl, prompts, cfg, chunks, what):
  """(b): the requests through a running fleet, launch counts zeroed just
  before and read just after."""
  engines = [rep.engine for rep in fl._replicas.values()]
  before = _engine_counts(engines)
  decode_s = [e.stats["decode_s"] for e in engines]
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.monotonic()
  frids = [fl.submit(p) for p in prompts]
  freqs = [fl.request(f) for f in frids]
  outs = [fl.result(f, timeout=600).tolist() for f in frids]
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  launches = dict(ops.LAUNCHES)
  counts = _fleet_launch_check(what, launches, engines, before, cfg, chunks)
  generated = sum(len(o) - len(p) for p, o in zip(prompts, outs))
  p50, p99 = _ttft_ms(freqs)
  steps = [e.stats["steps"] - before[id(e)][1] for e in engines]
  return outs, {"wall_s": wall, "tokens_per_s": generated / wall,
                "ttft_ms_p50": p50, "ttft_ms_p99": p99,
                "launches": launches, **counts,
                "prefills_by_replica": [
                    e.stats["prefills"] - before[id(e)][0] for e in engines],
                "steps_by_replica": steps,
                # wall ms of a decode step in each replica's loop thread
                # (a dispatch ends in its host harvest): against (a)'s,
                # what sharing the card and the process costs a replica
                "decode_ms_per_step_by_replica": [
                    (e.stats["decode_s"] - d) / max(1, n) * 1e3
                    for e, d, n in zip(engines, decode_s, steps)]}


def fleet_gauges(metrics, anomaly, reg, fl, n, what="[6p](b)"):
  """(b)'s obs gates: the fleet's counters and gauges under the names the
  port's detector and SLO tracker read, and no alert from the detector."""
  time.sleep(4 * fl._poll)           # the monitor's next gauge pass
  snap = reg.snapshot()
  got = {k: snap[k]["value"] for k in snap if k.startswith("fleet.")}
  want = {"fleet.submitted": n, "fleet.dispatched": n, "fleet.completed": n,
          "fleet.rejected": 0, "fleet.failovers": 0, "fleet.shed": 0,
          "fleet.ejections": 0, "fleet.replay_mismatches": 0,
          "fleet.replicas_total": FLEET_REPLICAS,
          "fleet.replicas_active": FLEET_REPLICAS,
          "fleet.replicas_draining": 0, "fleet.queue_depth": 0,
          "fleet.occupancy": 0}
  bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
  if bad:
    raise AssertionError("%s: fleet metrics (got, want) %s" % (what, bad))
  det = anomaly.AnomalyDetector(_OneExecutorSink(reg), interval=0.05,
                                window=0.2,
                                registry=metrics.MetricsRegistry())
  t = time.monotonic()
  alerts = det.poll(t) + det.poll(t + 1.0)
  if alerts:
    raise AssertionError("%s: the detector raised %s"
                         % (what, [a["alert"] for a in alerts]))
  return got


class _OneExecutorSink(object):
  """The detector's view of one process's registry (the driver-side sink
  a cluster would feed): executor 0's metrics are this registry's."""

  def __init__(self, reg):
    self.executors = {0: None}
    self._reg = reg

  def metrics(self, executor_id=None):
    return self._reg.snapshot()


def fleet_failover(torch, ops, fleet_mod, fl, prompts, cfg, want, det):
  """(c): request 0 goes to replica 0 and request 1 to replica 1 (the idle
  one scores first); request 1 is read through ``stream()``, and after its
  2nd token the other 14 are submitted, so replica 1's 3rd dispatch consult
  kills it with request 1 mid-decode. Every output must equal (a)'s and the
  streamed one must give each position exactly once."""
  engines = [rep.engine for rep in fl._replicas.values()]
  before = _engine_counts(engines)
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.monotonic()
  frids = [fl.submit(prompts[0]), fl.submit(prompts[FLEET_STREAMED])]
  x = fl.request(frids[1])
  streamed = []
  for tok in fl.stream(frids[1], timeout=600):
    streamed.append(tok)
    if len(streamed) == 2:
      frids[2:] = [fl.submit(p) for p in prompts[2:]]
  # the stream consumer recorded request 1's verdict and popped its entry
  freqs = [x if f == frids[1] else fl.request(f) for f in frids]
  outs = [x.output.tolist() if f == frids[1] else
          fl.result(f, timeout=600).tolist() for f in frids]
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  launches = dict(ops.LAUNCHES)
  counts = _fleet_launch_check("[6p](c)", launches, engines, before, cfg)
  states = fl.replica_states()
  stats = dict(fl.stats)
  eject = next(e for e in fl.events if e["event"] == "eject")
  replayed = [f for f in freqs if f.failovers]
  kill_to_done = max(f.finished_at for f in replayed) - eject["t"]
  alerts = det.poll(time.monotonic() + 2.0) + det.poll(time.monotonic()
                                                         + 3.0)
  what = "[6p](c) failover under TOS_CHAOS_FLEET=%s" % FLEET_KILL
  _same_outputs(what, outs, want)
  x_want = want[FLEET_STREAMED][len(prompts[FLEET_STREAMED]):]
  if streamed != x_want or len(streamed) != MAIN_NEW:
    raise AssertionError("%s: stream() gave %d tokens, not each of the %d "
                         "positions once" % (what, len(streamed), MAIN_NEW))
  hop = [rid for rid, _ in x.attempts]
  if states[1] != fleet_mod.EJECTED or states[0] != fleet_mod.ACTIVE or \
      hop != [1, 0] or "InjectedFault" not in eject["cause"]:
    raise AssertionError("%s: replica states %s, the streamed request's "
                         "replicas %s, eject %s" % (what, states, hop, eject))
  if stats["failovers"] < 1 or stats["shed"] or stats["replay_mismatches"] \
      or stats["completed"] != len(prompts):
    raise AssertionError("%s: stats %s" % (what, stats))
  if "fleet_degraded" not in [a["alert"] for a in alerts]:
    raise AssertionError("%s: the detector did not read the ejection as "
                         "fleet_degraded: %s" % (what, alerts))
  return {"wall_s": wall, "kill_to_last_replay_s": kill_to_done,
          "failovers": stats["failovers"], "replays": stats["replays"],
          "replayed_requests": len(replayed), "shed": stats["shed"],
          "replay_mismatches": stats["replay_mismatches"],
          "streamed_tokens": len(streamed), "streamed_hop": hop,
          "states": {str(k): v for k, v in states.items()},
          "alerts": sorted({a["alert"] for a in alerts}),
          "launches": launches, **counts}


def fleet_swap(torch, ops, fl, prompts, cfg, factory, want):
  """(d): the 16 requests submitted, then ``rolling_swap`` to a factory with
  the same weights while they are in flight."""
  engines = [rep.engine for rep in fl._replicas.values()]
  before = _engine_counts(engines)
  torch.cuda.synchronize()
  ops.reset_launches()
  frids = [fl.submit(p) for p in prompts]
  t0 = time.monotonic()
  report = fl.rolling_swap(timeout=600.0, engine_factory=factory)
  swap_s = time.monotonic() - t0
  outs = [fl.result(f, timeout=600).tolist() for f in frids]
  torch.cuda.synchronize()
  launches = dict(ops.LAUNCHES)
  engines += [rep.engine for rep in fl._replicas.values()]
  counts = _fleet_launch_check("[6p](d)", launches, engines, before, cfg)
  stats = dict(fl.stats)
  what = "[6p](d) rolling swap mid-flight"
  _same_outputs(what, outs, want)
  if report["swapped"] != FLEET_REPLICAS or stats["shed"] or \
      not all(r["drained"] for r in report["replicas"]):
    raise AssertionError("%s: report %s, stats %s" % (what, report, stats))
  return {"swap_s": swap_s, "swapped": report["swapped"],
          "shed": stats["shed"], "swaps": stats["swaps"],
          "launches": launches, **counts}


def fleet_crash_replay(torch, ops, chaos, ServingEngine, params, cfg, prompts,
                       want):
  """(e): the bare engine under ``TOS_CHAOS_SERVE=decode#3:raise``."""
  chaos.reset()
  with env_var(chaos.ENV_SERVE, FLEET_CRASH):
    eng = ServingEngine(params, cfg, num_slots=8, horizon=4,
                        max_new_tokens=MAIN_NEW).start()
    try:
      torch.cuda.synchronize()
      ops.reset_launches()
      rids = [eng.submit(p) for p in prompts]
      handles = [eng.request(r) for r in rids]
      outs = [eng.result(r, timeout=600).tolist() for r in rids]
      torch.cuda.synchronize()
    finally:
      eng.stop()
  chaos.reset()
  launches = dict(ops.LAUNCHES)
  replays = sum(h.replays for h in handles)
  counts = _fleet_launch_check("[6p](e)", launches, [eng], {}, cfg)
  what = "[6p](e) crash replay under TOS_CHAOS_SERVE=%s" % FLEET_CRASH
  _same_outputs(what, outs, want)
  if eng.stats["engine_restarts"] != 1 or eng.stats["replay_mismatches"] \
      or eng.stats["poisoned"] or not replays:
    raise AssertionError("%s: stats %s, %d replays" % (what, eng.stats,
                                                       replays))
  return {"engine_restarts": eng.stats["engine_restarts"],
          "replayed_requests": replays,
          "restart_s": eng.restart_log[0]["duration_s"],
          "launches": launches, **counts}


def fleet_phase(torch, ops, tfm, ServingEngine, slots, card, params, cfg,
                serve_ref=None):
  """[6p]: [4]'s 16 requests through a 2-replica ``ServingFleet`` sharing
  the card, against a bare engine, with a replica killed, a rolling swap
  and a crash replay (module docstring). ``serve_ref`` is [4]'s result in
  the full run, whose outputs (a) must equal."""
  from tensorflowonspark_tpu_torch.obs import anomaly, metrics
  from tensorflowonspark_tpu_torch.serving import ServingFleet
  from tensorflowonspark_tpu_torch.serving import fleet as fleet_mod
  from tensorflowonspark_tpu_torch.utils import chaos
  prompts = _prompts(MAIN_LENGTHS, cfg.vocab_size, SEED + 2)
  chunks = sum(len(slots.chunk_plan(len(p), slots.DEFAULT_BUCKETS))
               for p in prompts)
  factory = _fleet_factory(ServingEngine, params, cfg)
  res = {"card": card}

  log("  (a) the bare engine")
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  bare, model = serve_main_path(torch, ops, tfm, ServingEngine, slots,
                                params, cfg)
  del model
  want = bare.pop("outputs")
  bare.pop("ttft_ms_exact")
  if serve_ref is not None and want != serve_ref["outputs"]:
    raise AssertionError("[6p](a): the bare engine's outputs differ from "
                         "[4]'s")
  res["bare"] = bare

  log("  (b) ServingFleet(factory, num_replicas=%d), both on the card"
      % FLEET_REPLICAS)
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  reg = metrics.activate()
  try:
    fl = ServingFleet(factory, num_replicas=FLEET_REPLICAS).start()
  finally:
    metrics.deactivate()             # the fleet and engines keep handles
  try:
    _warm_replicas(fl, cfg)
    outs, served = fleet_served(torch, ops, fl, prompts, cfg, chunks,
                                "[6p](b)")
    served["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    _same_outputs("[6p](b) fleet", outs, want)
    if not all(served["prefills_by_replica"]):
      raise AssertionError("[6p](b): a replica took no request: %s"
                           % served["prefills_by_replica"])
    if served["launches"]["flash_attention_fwd"] != \
        bare["launches"]["flash_attention_fwd"] or \
        served["prefills"] != len(prompts):
      raise AssertionError("[6p](b): %d flash forwards for %d prefills, "
                           "(a) launched %d" % (
                               served["launches"]["flash_attention_fwd"],
                               served["prefills"],
                               bare["launches"]["flash_attention_fwd"]))
    served["metrics"] = fleet_gauges(metrics, anomaly, reg, fl,
                                     len(prompts))
    res["fleet"] = served
    log("  (b) %d requests over %d replicas (prefills %s): outputs equal "
        "(a)'s to the bit; %.1f tok/s (bare %.1f), decode ms/step by replica "
        "%s (bare %.3f), TTFT p50 %.1f ms p99 %.1f ms (bare %.1f / %.1f); "
        "peak %.2f GiB (bare %.2f); launches %s; no alert; %s" % (
            len(prompts), FLEET_REPLICAS, served["prefills_by_replica"],
            served["tokens_per_s"], bare["tokens_per_s"],
            ["%.3f" % x for x in served["decode_ms_per_step_by_replica"]],
            bare["decode_ms_per_step"],
            served["ttft_ms_p50"], served["ttft_ms_p99"], bare["ttft_ms_p50"],
            bare["ttft_ms_p99"], served["peak_mem_gib"], bare["peak_mem_gib"],
            served["launches"], card))

    log("  (d) rolling_swap mid-flight to a factory with the same weights")
    res["swap"] = fleet_swap(torch, ops, fl, prompts, cfg, factory, want)
    log("  (d) swapped %d replicas in %.2f s with %d requests in flight, "
        "shed %d, outputs equal (a)'s to the bit; %s" % (
            res["swap"]["swapped"], res["swap"]["swap_s"], len(prompts),
            res["swap"]["shed"], card))
  finally:
    fl.stop()
  del fl
  torch.cuda.empty_cache()

  log("  (c) the same under TOS_CHAOS_FLEET=%s, request %d streamed"
      % (FLEET_KILL, FLEET_STREAMED))
  chaos.reset()
  reg = metrics.activate()
  try:
    with env_var(chaos.ENV_FLEET, FLEET_KILL):
      fl = ServingFleet(factory, num_replicas=FLEET_REPLICAS,
                        poll_interval=0.02).start()
      try:
        _warm_replicas(fl, cfg)
        det = anomaly.AnomalyDetector(_OneExecutorSink(reg), interval=0.05,
                                      window=0.2,
                                      registry=metrics.MetricsRegistry())
        det.poll(time.monotonic())
        res["failover"] = fleet_failover(torch, ops, fleet_mod, fl, prompts,
                                         cfg, want, det)
      finally:
        fl.stop()
  finally:
    metrics.deactivate()
    chaos.reset()
  del fl
  torch.cuda.empty_cache()
  f = res["failover"]
  log("  (c) replica 1 ejected at its 3rd dispatch; %d failovers, %d "
      "requests replayed, shed %d, replay mismatches %d; outputs equal (a)'s "
      "to the bit; the streamed request hopped %s and gave %d positions "
      "once each; kill to the last replayed completion %.3f s; alerts %s; "
      "%s" % (f["failovers"], f["replayed_requests"], f["shed"],
              f["replay_mismatches"], f["streamed_hop"], f["streamed_tokens"],
              f["kill_to_last_replay_s"], f["alerts"], card))

  log("  (e) the bare engine under TOS_CHAOS_SERVE=%s" % FLEET_CRASH)
  res["crash_replay"] = fleet_crash_replay(torch, ops, chaos, ServingEngine,
                                           params, cfg, prompts, want)
  log("  (e) one restart, %d requests replayed, outputs equal (a)'s to the "
      "bit; %s" % (res["crash_replay"]["replayed_requests"], card))
  torch.cuda.empty_cache()
  return res


def fleet_launches(res, name):
  """[6p]'s launches of one kernel, by path, for the kernels line."""
  return {"fleet_bare": res["bare"]["launches"][name],
          "fleet_2_replicas": res["fleet"]["launches"][name],
          "fleet_failover": res["failover"]["launches"][name],
          "fleet_rolling_swap": res["swap"]["launches"][name],
          "fleet_crash_replay": res["crash_replay"]["launches"][name]}


# -- phase 6q: the registry, the deploy controller and cross-host serving ----

DEPLOY_HOSTS = 2
#: [4]'s engine options, as every published manifest carries them
DEPLOY_SERVE_OPTS = {"num_slots": 8, "horizon": 4, "max_new_tokens": MAIN_NEW}
DEPLOY_SPOT_CHECKS = 2
#: (b), (c): the first of [4]'s requests served again after the promote and
#: the rollback, against the bare v2 engine
DEPLOY_RESERVED = 8
DEPLOY_POISON = "canary:poison"      # (c): the candidate poisoned at canary
DEPLOY_KILL = "decode@1#3:kill"      # (d): host 1's 3rd round mid-decode
DEPLOY_STREAMED = 1                  # (d): the request read through stream()


def _write_json(path, payload):
  tmp = path + ".tmp"
  with open(tmp, "w") as f:
    json.dump(payload, f)
  os.replace(tmp, path)


def _deploy_host_main(addr, hid, root, stage, outdir, env):
  """The spawn target of a [6q] serving host: ``ServingHost.run()`` on the
  card in a process of its own, building its engines from the registry at
  ``root``, plus two things only this script needs. Launch windows: a side
  thread zeroes the port's launch counts when the driver drops
  ``reset-<n>`` into ``outdir`` (answering ``ack-<n>.<hid>``) and writes
  this host's counts, its engines' prefills and decode steps since the
  reset, its peak memory and its engines' devices as
  ``counts-<n>.<hid>.json`` when the driver drops ``read-<n>`` (the
  counters are per process, so the driver cannot read them). The poisoned
  canary: the ``TOS_CHAOS_DEPLOY`` poison corrupts the params the
  controller hands its engine factory, which a remote factory does not
  ship, so the driver stages them as ``<stage>/v-<version>.npz`` and a
  build of that version here serves them instead of the registry's."""
  os.environ.update({str(k): str(v) for k, v in env.items()})
  sys.path.insert(0, HERE)
  import threading
  import numpy as np
  import torch
  from tensorflowonspark_tpu_torch import ops
  from tensorflowonspark_tpu_torch.serving import host as host_mod
  from tensorflowonspark_tpu_torch.serving import registry as registry_mod
  host = host_mod.ServingHost(tuple(addr), int(hid), registry_root=root)
  engines = []
  registry_build = host._build_engine

  def build(version):
    staged = None if version is None else os.path.join(
        stage, "v-%06d.npz" % int(version))
    if staged is not None and os.path.exists(staged):
      with np.load(staged) as z:
        params = {k: z[k] for k in z.files}
      manifest = registry_mod.ModelRegistry(root).manifest(int(version))
      eng, v = host_mod.build_engine_from_manifest(params, manifest), \
          int(version)
    else:
      eng, v = registry_build(version)
    engines.append(eng)
    return eng, v

  host._build_engine = build
  base = {"prefills": 0, "steps": 0, "decode_s": 0.0}

  def totals():
    return {k: sum(e.stats[k] for e in list(engines))
            for k in ("prefills", "steps", "decode_s")}

  def counts():
    torch.cuda.synchronize()
    now = totals()
    return {"launches": dict(ops.LAUNCHES),
            "prefills": now["prefills"] - base["prefills"],
            "steps": now["steps"] - base["steps"],
            "decode_s": now["decode_s"] - base["decode_s"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "devices": sorted({str(e.model.device) for e in engines}),
            "pid": os.getpid()}

  stop, seen = threading.Event(), set()

  def windows():
    while not stop.is_set():
      for name in sorted(os.listdir(outdir)):
        if name in seen or "." in name:
          continue
        kind, _, n = name.partition("-")
        if kind == "reset":
          seen.add(name)
          torch.cuda.synchronize()
          ops.reset_launches()
          base.update(totals())
          _write_json(os.path.join(outdir, "ack-%s.%d" % (n, hid)), {})
        elif kind == "read":
          seen.add(name)
          _write_json(os.path.join(outdir, "counts-%s.%d.json" % (n, hid)),
                      counts())
      stop.wait(0.02)

  watcher = threading.Thread(target=windows, daemon=True)
  watcher.start()
  try:
    host.run()
  finally:
    stop.set()
    watcher.join(timeout=5)


def _start_deploy_hosts(addr, root, stage, outdir, env_by_host=None):
  """Two serving host processes (spawn: the driver holds a CUDA context)."""
  import multiprocessing as mp
  ctx = mp.get_context("spawn")
  procs = []
  for hid in range(DEPLOY_HOSTS):
    p = ctx.Process(target=_deploy_host_main,
                    args=(list(addr), hid, root, stage, outdir,
                          dict((env_by_host or {}).get(hid, {}))),
                    name="chip-smoke-serving-host-%d" % hid, daemon=True)
    p.start()
    procs.append(p)
  return procs


def _stop_deploy_hosts(plane, procs):
  for hid in plane.host_ids():
    plane.enqueue(hid, {"op": "exit"})
  for p in procs:
    p.join(timeout=60)
    if p.is_alive():
      p.terminate()
      p.join(timeout=10)


def _await_files(paths, what, timeout=120.0):
  deadline = time.monotonic() + timeout
  while not all(os.path.exists(p) for p in paths):
    if time.monotonic() >= deadline:
      raise AssertionError("%s: no answer from the hosts within %.0f s "
                           "(%s)" % (what, timeout, paths))
    time.sleep(0.02)


def _host_window(outdir, n, hids):
  """Zero every host's launch counts (window ``n``)."""
  open(os.path.join(outdir, "reset-%d" % n), "w").close()
  _await_files([os.path.join(outdir, "ack-%d.%d" % (n, h)) for h in hids],
               "[6q] launch window %d" % n)


def _host_counts(outdir, n, hids):
  """Every host's counts since window ``n`` was opened, by host id."""
  open(os.path.join(outdir, "read-%d" % n), "w").close()
  paths = {h: os.path.join(outdir, "counts-%d.%d.json" % (n, h))
           for h in hids}
  _await_files(list(paths.values()), "[6q] launch counts %d" % n)
  out = {}
  for h, p in paths.items():
    with open(p) as f:
      out[h] = json.load(f)
  return out


def deploy_served(torch, ops, fl, prompts, cfg, chunks, outdir, window):
  """[4]'s requests through the fleet of remote replicas, each host's
  launch counts zeroed just before and read just after; the driver's own
  counts must stay 0 (no kernel of the path runs in the driver)."""
  hids = sorted(r.engine.host_id for r in fl._replicas.values())
  _host_window(outdir, window, hids)
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.monotonic()
  frids = [fl.submit(p) for p in prompts]
  # each remote submit waits for its host's admission ack (a sync round
  # trip), so the driver's submits run in series
  submit_s = time.monotonic() - t0
  freqs = [fl.request(f) for f in frids]
  outs = [fl.result(f, timeout=600).tolist() for f in frids]
  wall = time.monotonic() - t0
  hosts = _host_counts(outdir, window, hids)
  driver = {k: v for k, v in ops.LAUNCHES.items() if v}
  if driver:
    raise AssertionError("[6q](a): the driver launched kernels %s" % driver)
  launches = {}
  for h in hosts.values():
    for k, v in h["launches"].items():
      launches[k] = launches.get(k, 0) + v
  stand_in = [types.SimpleNamespace(stats={"prefills": h["prefills"],
                                           "steps": h["steps"]})
              for h in hosts.values()]
  counts = _fleet_launch_check("[6q](a)", launches, stand_in, {}, cfg, chunks)
  generated = sum(len(o) - len(p) for p, o in zip(prompts, outs))
  p50, p99 = _ttft_ms(freqs)
  return outs, {"wall_s": wall, "tokens_per_s": generated / wall,
                "ttft_ms_p50": p50, "ttft_ms_p99": p99, "submit_s": submit_s,
                "launches": launches, **counts,
                "prefills_by_host": [hosts[h]["prefills"] for h in hids],
                "steps_by_host": [hosts[h]["steps"] for h in hids],
                # wall ms of a decode step in each host's loop thread, in a
                # process of its own (against [6p]'s threads in one)
                "decode_ms_per_step_by_host": [
                    hosts[h]["decode_s"] / max(1, hosts[h]["steps"]) * 1e3
                    for h in hids],
                "host_peak_mem_gib": [hosts[h]["peak_mem_gib"] for h in hids],
                "host_devices": [hosts[h]["devices"] for h in hids],
                "host_launches": [hosts[h]["launches"] for h in hids]}


def _fleet_outputs(fl, prompts):
  frids = [fl.submit(p) for p in prompts]
  freqs = [fl.request(f) for f in frids]
  return [fl.result(f, timeout=600).tolist() for f in frids], freqs


def deploy_phase(torch, ops, tfm, ServingEngine, slots, card, init_params,
                 cfg, serve_ref=None):
  """[6q]: the registry, the deploy controller and cross-host serving
  across two ServingHost processes on the card (module docstring).
  ``serve_ref`` is [4]'s result in the full run, whose outputs the bare
  engine's must equal."""
  import tempfile
  from tensorflowonspark_tpu_torch.control import rendezvous
  from tensorflowonspark_tpu_torch.obs import anomaly, metrics
  from tensorflowonspark_tpu_torch.serving import (
      DeploymentController, ModelRegistry, ServingFleet, cfg_wire, remote)
  from tensorflowonspark_tpu_torch.serving import fleet as fleet_mod
  from tensorflowonspark_tpu_torch.utils import chaos
  from tensorflowonspark_tpu_torch.utils.checkpoint import params_fingerprint
  import numpy as np
  prompts = _prompts(MAIN_LENGTHS, cfg.vocab_size, SEED + 2)
  chunks = sum(len(slots.chunk_plan(len(p), slots.DEFAULT_BUCKETS))
               for p in prompts)
  probes = [(p, MAIN_NEW) for p in prompts[:DEPLOY_SPOT_CHECKS]]
  os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
  tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_",
                         dir=os.path.join(HERE, "build"))
  root, stage = os.path.join(tmp, "registry"), os.path.join(tmp, "stage")
  out1, out2 = os.path.join(tmp, "hosts1"), os.path.join(tmp, "hosts2")
  for d in (stage, out1, out2):
    os.makedirs(d)
  extra = {"model_cfg": cfg_wire(cfg), "serve_opts": DEPLOY_SERVE_OPTS}
  res = {"card": card, "host_sync_s": float(os.environ.get(
      "TOS_HOST_SYNC", "0.02"))}
  t_phase = time.monotonic()
  reg = ModelRegistry(root, keep=8)
  t0 = time.monotonic()
  v1 = reg.publish(init_params(cfg, seed=SEED), step=1, extra=extra)
  res["publish_s"] = time.monotonic() - t0
  res["version_bytes"] = os.path.getsize(
      os.path.join(reg._dir(v1), "params.npz"))

  log("  (a) the bare engine on v1 in the driver")
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  params1, _ = reg.get(v1)
  bare, model = serve_main_path(torch, ops, tfm, ServingEngine, slots,
                                params1, cfg)
  del model, params1
  want = bare.pop("outputs")
  bare.pop("ttft_ms_exact")
  if serve_ref is not None and want != serve_ref["outputs"]:
    raise AssertionError("[6q](a): the bare engine's outputs differ from "
                         "[4]'s")
  res["bare"] = bare
  torch.cuda.empty_cache()

  staged = []

  def make_factory(params, manifest):
    # a remote replica builds its version from the registry; params that
    # are not the version's (the chaos poison) are staged for the host
    version = int(manifest["version"])
    if params_fingerprint(params) != manifest["fingerprint"]:
      path = os.path.join(stage, "v-%06d.npz" % version)
      with open(path, "wb") as f:
        np.savez(f, **params)
      staged.append(path)
    return remote.remote_engine_factory(plane, version=version)

  refs = {}

  def reference_decode(params, prompt, budget):
    # the parity oracle: a bare [4] engine on the candidate's params in
    # the driver, one request at a time
    if id(params) not in refs:
      refs[id(params)] = (params, ServingEngine(
          params, cfg, num_slots=8, horizon=4,
          max_new_tokens=MAIN_NEW).start())
    return refs[id(params)][1].generate([prompt], max_new_tokens=budget,
                                        timeout=600)[0]

  det_clock = [time.monotonic()]
  alerts = []

  def detector_pass(det):
    # the detector spaced one second a pass, as [6p] polls it
    det_clock[0] += 1.0
    alerts.extend(det.poll(det_clock[0]))
    return {"objectives": []}

  mreg = metrics.activate()
  server = rendezvous.Server(1)
  procs = []
  fl = None
  try:
    addr = server.start()
    plane = remote.attach_serving_plane(server)
    t0 = time.monotonic()
    procs = _start_deploy_hosts(addr, root, stage, out1)
    plane.await_hosts(DEPLOY_HOSTS, timeout=300)
    res["hosts_up_s"] = time.monotonic() - t0
    log("  (a) ServingFleet(remote_engine_factory(plane), num_replicas=%d) "
        "over %d ServingHost processes" % (DEPLOY_HOSTS, DEPLOY_HOSTS))
    t0 = time.monotonic()
    fl = ServingFleet(remote.remote_engine_factory(plane, version=v1),
                      num_replicas=DEPLOY_HOSTS,
                      health_probe=remote.wire_health_probe(addr)).start()
    res["fleet_start_s"] = time.monotonic() - t0
    for rid in fl.replica_states():
      fl.set_replica_version(rid, v1)
    _warm_replicas(fl, cfg)
    outs, served = deploy_served(torch, ops, fl, prompts, cfg, chunks, out1,
                                 1)
    _same_outputs("[6q](a) across the wire", outs, want)
    if not all(served["prefills_by_host"]) or \
        served["prefills"] != len(prompts):
      raise AssertionError("[6q](a): prefills by host %s"
                           % served["prefills_by_host"])
    if any(not d or any(not x.startswith("cuda") for x in d)
           for d in served["host_devices"]):
      raise AssertionError("[6q](a): a host served off the card: %s"
                           % served["host_devices"])
    served["metrics"] = fleet_gauges(metrics, anomaly, mreg, fl,
                                     len(prompts), "[6q](a)")
    res["served"] = served
    log("  (a) %d requests over %d hosts (prefills %s): outputs equal the "
        "bare engine's to the bit; %.1f tok/s (bare %.1f), TTFT p50 %.1f "
        "ms p99 %.1f ms (bare %.1f / %.1f); decode ms/step by host %s "
        "(bare %.3f); host peak %s GiB (bare %.2f); hosts' launches %s, the "
        "driver's none; no alert; %s" % (
            len(prompts), DEPLOY_HOSTS, served["prefills_by_host"],
            served["tokens_per_s"], bare["tokens_per_s"],
            served["ttft_ms_p50"], served["ttft_ms_p99"], bare["ttft_ms_p50"],
            bare["ttft_ms_p99"],
            ["%.3f" % x for x in served["decode_ms_per_step_by_host"]],
            bare["decode_ms_per_step"],
            ["%.2f" % x for x in served["host_peak_mem_gib"]],
            bare["peak_mem_gib"], served["launches"], card))

    log("  (b) publish v2, DeploymentController.deploy(v2)")
    det = anomaly.AnomalyDetector(_OneExecutorSink(mreg), interval=0.05,
                                  window=0.2,
                                  registry=metrics.MetricsRegistry())
    ctl = DeploymentController(
        fl, reg, make_factory, reference_decode, probes,
        baseline_version=v1, traffic_slice=0.5, bake_seconds=0.0,
        spot_checks=DEPLOY_SPOT_CHECKS, swap_timeout=600.0,
        slo_source=lambda: detector_pass(det))
    det.poll(det_clock[0])
    snap = fl.stats_snapshot()
    t0 = time.monotonic()
    v2 = reg.publish(init_params(cfg, seed=SEED + 1), step=2, extra=extra)
    verdict = ctl.deploy(v2)
    promote_s = time.monotonic() - t0
    shed = snap.delta().get("shed", 0)
    (ref_params, ref_eng), = refs.values()
    again = prompts[:DEPLOY_RESERVED]
    want2 = [o.tolist() for o in ref_eng.generate(again, timeout=600)]
    outs2, freqs2 = _fleet_outputs(fl, again)
    what = "[6q](b) deploy of v2"
    if not (verdict["ok"] and verdict.get("promoted")) or \
        verdict["parity"] != {"checked": DEPLOY_SPOT_CHECKS,
                              "mismatches": 0} or shed or \
        ctl.stats["promotions"] != 1 or ctl.stats["rollbacks"] or \
        fl.served_versions() != {0: v2, 1: v2}:
      raise AssertionError("%s: verdict %s, stats %s, shed %d, served %s"
                           % (what, verdict, ctl.stats, shed,
                              fl.served_versions()))
    _same_outputs(what + " after the promote", outs2, want2)
    stamps = {f.timing()["model_version"] for f in freqs2}
    rows = plane.status()
    if stamps != {v2} or {r["version"] for r in rows.values()} != {v2}:
      raise AssertionError("%s: stamps %s, hosts %s" % (what, stamps, rows))
    if any(a["alert"] == "canary_degraded" for a in alerts):
      raise AssertionError("%s: canary_degraded on a clean canary" % what)
    res["deploy"] = {"publish_to_promoted_s": promote_s,
                     "verdict": {k: verdict[k] for k in (
                         "ok", "parity", "ttft_ratio", "canary_samples",
                         "baseline_samples", "bake_s")},
                     "stats": dict(ctl.stats), "shed": shed,
                     "host_versions": {k: r["version"]
                                       for k, r in rows.items()}}
    log("  (b) CANARY -> VERIFY (parity %d/%d, %d canary samples, TTFT "
        "ratio %s) -> PROMOTE: promotions %d, rollbacks %d, shed %d; [4]'s "
        "first %d requests equal the bare v2 engine's to the bit, both hosts "
        "on v2; publish to promoted %.2f s; %s" % (
            verdict["parity"]["checked"] - verdict["parity"]["mismatches"],
            verdict["parity"]["checked"], verdict["canary_samples"],
            verdict["ttft_ratio"], ctl.stats["promotions"],
            ctl.stats["rollbacks"], shed, len(again), promote_s, card))
    for _, eng in refs.values():
      eng.stop()
    refs.clear()
    del ref_eng, ref_params
    torch.cuda.empty_cache()

    log("  (c) publish v3, deploy under TOS_CHAOS_DEPLOY=%s" % DEPLOY_POISON)
    snap = fl.stats_snapshot()
    v3 = reg.publish(init_params(cfg, seed=SEED + 2), step=3, extra=extra)
    chaos.reset()
    t0 = time.monotonic()
    with env_var(chaos.ENV_DEPLOY, DEPLOY_POISON):
      verdict3 = ctl.deploy(v3)
    rollback_s = time.monotonic() - t0
    chaos.reset()
    outs3, _ = _fleet_outputs(fl, again)
    shed3 = snap.delta().get("shed", 0)
    what = "[6q](c) a poisoned v3"
    if verdict3["ok"] or not verdict3["parity"]["mismatches"] or \
        not verdict3.get("rollback_bit_identical") or \
        not reg.is_quarantined(v3) or reg.latest() != v2 or shed3 or \
        ctl.stats["rollbacks"] != 1 or not staged or \
        set(fl.served_versions().values()) != {v2}:
      raise AssertionError("%s: verdict %s, quarantined %s, latest %s, "
                           "shed %d, stats %s, staged %s" % (
                               what, verdict3, reg.is_quarantined(v3),
                               reg.latest(), shed3, ctl.stats, staged))
    _same_outputs(what + " after the rollback", outs3, want2)
    degraded = [a for a in alerts if a["alert"] == "canary_degraded"]
    if not degraded:
      raise AssertionError("%s: the detector did not raise canary_degraded: "
                           "%s" % (what, alerts))
    res["poison"] = {"verdict": {k: verdict3[k] for k in (
        "ok", "parity", "reason", "rollback_bit_identical")},
                     "deploy_to_rolled_back_s": rollback_s,
                     "quarantine": reg.quarantine_record(v3)["verdict"][
                         "reason"],
                     "latest": reg.latest(), "shed": shed3,
                     "alerts": sorted({a["alert"] for a in alerts})}
    for _, eng in refs.values():
      eng.stop()
    refs.clear()
    log("  (c) VERIFY parity %d/%d diverged -> ROLLBACK, v3 quarantined "
        "(%s), latest %d, [4]'s first %d requests equal v2's to the bit, "
        "shed %d, canary_degraded raised; deploy to rolled back %.2f s; %s" % (
            verdict3["parity"]["mismatches"], verdict3["parity"]["checked"],
            res["poison"]["quarantine"], reg.latest(), len(again), shed3,
            rollback_s, card))
  finally:
    if fl is not None:
      fl.stop()
    for _, eng in refs.values():
      eng.stop()
    _stop_deploy_hosts(plane, procs)
    server.stop()
    metrics.deactivate()
  del fl
  torch.cuda.empty_cache()

  log("  (d) a fresh pair, host 1 under TOS_CHAOS_HOST=%s, request %d "
      "streamed" % (DEPLOY_KILL, DEPLOY_STREAMED))
  mreg = metrics.activate()
  server = rendezvous.Server(1)
  procs, fl = [], None
  try:
    addr = server.start()
    plane = remote.attach_serving_plane(server)
    procs = _start_deploy_hosts(addr, root, stage, out2,
                                {1: {chaos.ENV_HOST: DEPLOY_KILL}})
    plane.await_hosts(DEPLOY_HOSTS, timeout=300)
    fl = ServingFleet(remote.remote_engine_factory(plane, version=v1),
                      num_replicas=DEPLOY_HOSTS, poll_interval=0.02,
                      health_probe=remote.wire_health_probe(addr)).start()
    det = anomaly.AnomalyDetector(_OneExecutorSink(mreg), interval=0.05,
                                  window=0.2,
                                  registry=metrics.MetricsRegistry())
    det.poll(time.monotonic())
    res["kill"] = deploy_host_kill(fl, fleet_mod, plane, procs, prompts,
                                   want, det)
  finally:
    if fl is not None:
      fl.stop()
    _stop_deploy_hosts(plane, procs)
    server.stop()
    metrics.deactivate()
  k = res["kill"]
  log("  (d) host 1 SIGKILLed (exit %d) mid-decode, its replica ejected "
      "%.3f s after its last sync; %d failovers, shed %d, replay mismatches "
      "%d; outputs equal (a)'s to the bit; the streamed request hopped %s "
      "after %s tokens and gave %d positions once each; kill to the last "
      "replayed completion %.3f s; alerts %s; %s" % (
          k["exitcode"], k["kill_to_eject_s"], k["failovers"], k["shed"],
          k["replay_mismatches"], k["streamed_hop"],
          k["streamed_before_hop"], k["streamed_tokens"],
          k["kill_to_last_replay_s"], k["alerts"], card))
  shutil.rmtree(tmp, ignore_errors=True)
  res["total_s"] = time.monotonic() - t_phase
  torch.cuda.empty_cache()
  return res


def deploy_host_kill(fl, fleet_mod, plane, procs, prompts, want, det):
  """(d): request 0 lands on host 0 and request 1 on host 1 (the idle one
  scores first), then the other 14 follow while request 1 is read through
  ``stream()``; host 1 SIGKILLs itself on its 3rd sync round with requests
  in flight. Every output must equal (a)'s and the stream must give each
  position exactly once across the hop."""
  frids = [fl.submit(prompts[0]), fl.submit(prompts[DEPLOY_STREAMED])]
  x = fl.request(frids[1])
  frids[2:] = [fl.submit(p) for p in prompts[2:]]
  streamed = list(fl.stream(frids[1], timeout=600))
  freqs = [x if f == frids[1] else fl.request(f) for f in frids]
  outs = [x.output.tolist() if f == frids[1] else
          fl.result(f, timeout=600).tolist() for f in frids]
  procs[1].join(timeout=60)
  states = fl.replica_states()
  stats = dict(fl.stats)
  eject = next(e for e in fl.events if e["event"] == "eject")
  last_sync = plane._hosts[1].last_sync
  replayed = [f for f in freqs if f.failovers]
  hop_emitted = [e.get("emitted") for e in fl.events
                 if e["event"] == "failover" and e.get("frid") == x.frid]
  alerts = det.poll(time.monotonic() + 2.0) + det.poll(time.monotonic()
                                                         + 3.0)
  what = "[6q](d) host 1 under TOS_CHAOS_HOST=%s" % DEPLOY_KILL
  _same_outputs(what, outs, want)
  x_want = want[DEPLOY_STREAMED][len(prompts[DEPLOY_STREAMED]):]
  if streamed != x_want or len(streamed) != MAIN_NEW:
    raise AssertionError("%s: stream() gave %d tokens, not each of the %d "
                         "positions once" % (what, len(streamed), MAIN_NEW))
  hop = [rid for rid, _ in x.attempts]
  if procs[1].exitcode != -9 or states[1] != fleet_mod.EJECTED or \
      states[0] != fleet_mod.ACTIVE or hop != [1, 0] or not replayed:
    raise AssertionError("%s: exit code %s, replica states %s, the streamed "
                         "request's replicas %s, eject %s" % (
                             what, procs[1].exitcode, states, hop, eject))
  if stats["failovers"] < 1 or stats["shed"] or stats["replay_mismatches"] \
      or stats["completed"] != len(prompts):
    raise AssertionError("%s: stats %s" % (what, stats))
  if "host_lost" not in [a["alert"] for a in alerts]:
    raise AssertionError("%s: the detector did not raise host_lost: %s"
                         % (what, alerts))
  return {"exitcode": procs[1].exitcode,
          "kill_to_eject_s": eject["t"] - last_sync,
          "kill_to_last_replay_s": max(f.finished_at for f in replayed)
                                   - last_sync,
          "failovers": stats["failovers"], "replays": stats["replays"],
          "replayed_requests": len(replayed), "shed": stats["shed"],
          "replay_mismatches": stats["replay_mismatches"],
          "retries": stats["retries"],
          "streamed_tokens": len(streamed), "streamed_hop": hop,
          "streamed_before_hop": hop_emitted,
          "states": {str(k): v for k, v in states.items()},
          "alerts": sorted({a["alert"] for a in alerts})}


def deploy_summary(res):
  """[6q]'s numbers for one JSON line."""
  keys = ("tokens_per_s", "ttft_ms_p50", "ttft_ms_p99")
  return {"bare": {k: res["bare"][k] for k in keys + ("peak_mem_gib",
                                                      "decode_ms_per_step")},
          "served": {k: res["served"][k] for k in keys + (
              "submit_s", "wall_s", "prefills_by_host", "steps_by_host",
              "decode_ms_per_step_by_host", "host_peak_mem_gib")},
          "deploy": {k: res["deploy"][k] for k in (
              "publish_to_promoted_s", "shed", "verdict")},
          "poison": {k: res["poison"][k] for k in (
              "deploy_to_rolled_back_s", "latest", "shed", "alerts")},
          "kill": {k: res["kill"][k] for k in (
              "kill_to_eject_s", "kill_to_last_replay_s", "failovers",
              "replayed_requests", "shed", "replay_mismatches",
              "streamed_hop", "streamed_before_hop", "alerts")},
          "setup_s": {k: res[k] for k in ("publish_s", "hosts_up_s",
                                          "fleet_start_s")},
          "total_s": res["total_s"],
          "launches": res["served"]["launches"]}


# -- phase 6r: the decode-speed stack ------------------------------------------

DECODE_PREFIXES = 4                 # system prompts
DECODE_PREFIX_LEN = 512
DECODE_REQUESTS = 32
DECODE_TAILS = (8, 12, 16, 24, 32, 48, 64)
DECODE_NEW = 32
DECODE_HORIZON = 4
DECODE_PAGE = 16
DECODE_BASE_SLOTS = 8
DECODE_PAGED_SLOTS = 16
DECODE_PREFIX_PAGES = 256
DECODE_SPEC_DEPTH = 4
DECODE_SPEC_LAYERS = 3
DECODE_SOFTEN = 0.005               # the out/down scale past the draft's exit
DECODE_CRASH = "decode#3:raise"     # (e): the 3rd decode dispatch after arming
DECODE_PARITY_REQUESTS = 8          # (a): the first 8 requests,
DECODE_PARITY_NEW = 16              # 16 new tokens each
DECODE_MIN_HITS = DECODE_REQUESTS - DECODE_PREFIXES
DECODE_INT8_MAX_RATIO = 0.55
DECODE_SEED = SEED + 41


def soften_exit_layers(params, cfg, spec_layers, scale=DECODE_SOFTEN):
  """The port's copy of the reference serve_bench's ``_soften_exit_layers``
  on the flat weight names: the out and down projections of the layers
  past the draft's exit scaled by ``scale``. Random weights give a
  shallow self-draft ~1/vocab acceptance; scaled late layers emulate a
  trained network's, whose late layers refine and rarely overturn. Every
  leg and every parity reference uses the same softened weights."""
  out = dict(params)
  for i in range(spec_layers, cfg.num_layers):
    for name in ("layers.%d.attn.out" % i, "layers.%d.mlp.down" % i):
      out[name] = params[name] * scale
  return out


def _zipf_pick(rng, options, a=1.3):
  """Zipf-ish draw over ``options`` sorted ascending (the reference
  serve_bench's): small values common, large ones rare."""
  import numpy as np
  ranks = 1.0 / (1.0 + np.arange(len(options))) ** a
  return options[rng.choice(len(options), p=ranks / ranks.sum())]


def make_prefix_workload(vocab, seed):
  """The reference serve_bench's ``make_prefix_workload`` at [6r]'s
  shape: DECODE_PREFIXES system prompts of DECODE_PREFIX_LEN tokens, and
  DECODE_REQUESTS requests, each a Zipf-drawn system prompt plus a
  Zipf-drawn tail of DECODE_TAILS tokens (DECODE_NEW new tokens each)."""
  import numpy as np
  rng = np.random.RandomState(seed)
  prefixes = [rng.randint(0, vocab, (DECODE_PREFIX_LEN,)).astype(np.int64)
              for _ in range(DECODE_PREFIXES)]
  reqs = []
  for _ in range(DECODE_REQUESTS):
    pi = _zipf_pick(rng, list(range(DECODE_PREFIXES)))
    tail = rng.randint(0, vocab, (_zipf_pick(rng, sorted(DECODE_TAILS)),))
    reqs.append(np.concatenate([prefixes[pi], tail.astype(np.int64)]))
  return reqs


def decode_legs(cfg):
  """(leg, engine options, int8): every leg holds the contiguous slab's
  KV bytes except int8 (the reference serve_bench's ``_equal_hbm_pages``:
  DECODE_BASE_SLOTS x max_seq_len tokens of pages, plus the trash page)."""
  paged = dict(num_slots=DECODE_PAGED_SLOTS, page_size=DECODE_PAGE,
               num_pages=DECODE_BASE_SLOTS * cfg.max_seq_len // DECODE_PAGE
               + 1)
  prefix = dict(paged, prefix_pages=DECODE_PREFIX_PAGES)
  return [("baseline", dict(num_slots=DECODE_BASE_SLOTS), False),
          ("paged", paged, False),
          ("paged_prefix", prefix, False),
          ("full_stack", dict(prefix, spec_depth=DECODE_SPEC_DEPTH,
                              spec_layers=DECODE_SPEC_LAYERS), False),
          ("int8", dict(num_slots=DECODE_BASE_SLOTS), True)]


def _leg_cfg(cfg, int8):
  return dataclasses.replace(cfg, kv_cache_dtype="int8") if int8 else cfg


def _kv_leaves(slabs):
  return (slabs.k + slabs.v + (slabs.k_scale or [])
          + (slabs.v_scale or []))


def _count_forwards(model):
  """Forward calls of ``model`` by kind (full, or a draft's shallow exit),
  counted by a pre-hook: the host's side of gate (c)."""
  counts = {"full": 0, "draft": 0}

  def hook(_mod, _args, kwargs):
    counts["draft" if kwargs.get("exit_layer") is not None
           else "full"] += 1

  return counts, model.register_forward_pre_hook(hook, with_kwargs=True)


def decode_engine(ServingEngine, params, cfg, opts, int8, **kw):
  """One leg's engine, started, with an exact peak of allocated pages
  (taken at each allocation, the only place the count rises)."""
  eng = ServingEngine(params, _leg_cfg(cfg, int8), horizon=DECODE_HORIZON,
                      max_new_tokens=DECODE_NEW, **dict(opts, **kw))
  eng.peak_pages = 0
  real = eng._alloc_pages

  def alloc(req):
    got = real(req)
    eng.peak_pages = max(eng.peak_pages, eng.kv_pages_in_use)
    return got

  eng._alloc_pages = alloc
  return eng.start()


def _decode_warm(eng, cfg):
  # warm-up on prompts that share nothing with the workload's: cuBLAS
  # handles, allocator pools, the first launches of every path
  eng.generate(_prompts((40, 130), cfg.vocab_size, SEED + 7),
               max_new_tokens=8, timeout=600)


def decode_timed(torch, ops, eng, prompts):
  """The workload through a warmed engine: outputs, launch and forward
  counts, stats deltas and timings."""
  counts, hook = _count_forwards(eng.model)
  before = dict(eng.stats)
  eng.peak_pages = eng.kv_pages_in_use
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.monotonic()
  try:
    rids = [eng.submit(p) for p in prompts]
    handles = [eng.request(r) for r in rids]
    outs = [eng.result(r, timeout=600).tolist() for r in rids]
    torch.cuda.synchronize()
  finally:
    hook.remove()
  wall = time.monotonic() - t0
  delta = {k: eng.stats[k] - before[k] for k in before}
  return {"outs": outs, "handles": handles, "wall_s": wall,
          "launches": dict(ops.LAUNCHES), "forwards": dict(counts),
          "delta": delta}


def _pct(values, q):
  values = sorted(values)
  return values[min(len(values) - 1, int(math.ceil(q * len(values))) - 1)]


def decode_leg(torch, ops, ServingEngine, params, cfg, name, opts, int8,
               prompts):
  """One leg: warm, time the workload, hold gates (b) and (c) and read
  the page state after the last completion."""
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  eng = decode_engine(ServingEngine, params, cfg, opts, int8)
  try:
    _decode_warm(eng, cfg)
    run = decode_timed(torch, ops, eng, prompts)
    leaves = _kv_leaves(eng._slabs)
    kv_bytes = sum(t.numel() * t.element_size() for t in leaves)
    dtypes = sorted({str(t.dtype) for t in leaves})
    # pages are released before a request's waiter wakes, so after the
    # last result the pool holds exactly the trie's pages
    in_use = eng.kv_pages_in_use
    held = eng._prefix.pages_held if eng._prefix is not None else 0
    peak_mem = torch.cuda.max_memory_allocated() / 2 ** 30
    drained = eng.drain(timeout=120)
  finally:
    eng.stop()
  what = "[6r] %s" % name
  if not drained:
    raise AssertionError("%s: drain did not finish" % what)
  outs, d = run["outs"], run["delta"]
  for p, o in zip(prompts, outs):
    if len(o) != len(p) + DECODE_NEW or o[:len(p)] != p.tolist() \
        or min(o) < 0 or max(o) >= cfg.vocab_size:
      raise AssertionError("%s: a request of %d tokens returned %d tokens "
                           "or ids outside the vocabulary"
                           % (what, len(p), len(o)))
  if d["replay_mismatches"] or d["engine_restarts"]:
    raise AssertionError("%s: stats %s" % (what, d))
  # (c) launches: 12 flash forwards a prefill whose first chunk starts at
  # cursor 0 (a prefix hit resumes past it), 25 LayerNorm forwards a full
  # forward and 2 x spec_layers + 1 a draft forward
  fw, ln = run["forwards"], run["launches"]
  spec = eng.spec_depth
  want_flash = cfg.num_layers * (d["prefills"] - d["prefix_hits"])
  want_ln = (2 * cfg.num_layers + 1) * fw["full"] \
      + (2 * eng.decoder.spec_layers + 1) * fw["draft"]
  if ln["flash_attention_fwd"] != want_flash:
    raise AssertionError("%s: flash attention launched %d times, the path "
                         "needs %d (12 x (%d prefills - %d prefix hits))"
                         % (what, ln["flash_attention_fwd"], want_flash,
                            d["prefills"], d["prefix_hits"]))
  if ln["layer_norm"] != want_ln:
    raise AssertionError("%s: layer_norm launched %d times, the path needs "
                         "%d (25 x %d full + %d x %d draft forwards)"
                         % (what, ln["layer_norm"], want_ln, fw["full"],
                            2 * eng.decoder.spec_layers + 1, fw["draft"]))
  if fw["draft"] != (d["steps"] if spec else 0):
    raise AssertionError("%s: %d draft forwards for %d spec slot-steps"
                         % (what, fw["draft"], d["steps"]))
  if in_use != held:
    raise AssertionError("%s: %d pages in use after the last completion, "
                         "the trie holds %d" % (what, in_use, held))
  per_dispatch = DECODE_HORIZON if not spec else spec * eng._spec_rounds
  dispatches = d["steps"] // per_dispatch
  ttft = sorted(h.ttft * 1e3 for h in run["handles"])
  generated = sum(len(o) - len(p) for p, o in zip(prompts, outs))
  judged = d["spec_accepted"] + d["spec_rejected"]
  res = {"options": dict(opts, kv_cache_dtype="int8" if int8 else "model"),
         "requests": len(prompts), "generated_tokens": generated,
         "wall_s": run["wall_s"], "tokens_per_s": generated / run["wall_s"],
         "ttft_ms_p50": statistics.median(ttft),
         "ttft_ms_p99": _pct(ttft, 0.99), "dispatches": dispatches,
         "decode_ms_per_dispatch": d["decode_s"] / dispatches * 1e3,
         "prefills": d["prefills"], "prefix_hits": d["prefix_hits"],
         "prefix_evictions": d["prefix_evictions"],
         "spec_accepted": d["spec_accepted"],
         "spec_rejected": d["spec_rejected"],
         "spec_accept_rate": d["spec_accepted"] / judged if judged else None,
         "peak_pages_in_use": eng.peak_pages, "pages_after": in_use,
         "trie_pages_after": held, "peak_mem_gib": peak_mem,
         "kv_bytes": kv_bytes, "kv_dtypes": dtypes,
         "launches": ln, "forwards": fw, "outputs": outs}
  log("  %-12s %7.1f tok/s  TTFT p50 %7.1f p99 %7.1f ms  %6.2f ms/dispatch "
      "(%d)  prefills %d  hits %d  evictions %d  peak pages %d  accept %s  "
      "peak %.2f GiB  KV %d B  launches flash %d LN %d" % (
          name, res["tokens_per_s"], res["ttft_ms_p50"], res["ttft_ms_p99"],
          res["decode_ms_per_dispatch"], dispatches, res["prefills"],
          res["prefix_hits"], res["prefix_evictions"], res["peak_pages_in_use"],
          "%.3f" % res["spec_accept_rate"] if judged else "-", peak_mem,
          kv_bytes, ln["flash_attention_fwd"], ln["layer_norm"]))
  return res


def _greedy_path(torch, model, tokens, plan):
  """``(logits, cache)`` after ``tokens`` along a single-request greedy
  decode's own path: the prompt's prefill in ``plan``'s chunks into a
  fresh cache, then one token a step."""
  with torch.inference_mode():
    cache, off = model.init_cache(1), 0
    for seg in plan:
      logits = model(torch.as_tensor(tokens[None, off:off + seg]), cache)
      off += seg
    for t in tokens[off:]:
      logits = model(torch.as_tensor([[int(t)]]), cache)
  return logits[0, -1].float(), cache


def _greedy_chunked(torch, model, prompt, num_new, plan):
  """``greedy_generate_kv``'s greedy decode with the prefill cut into
  ``plan``'s chunks, as an engine's ``chunk_plan`` cuts it: the plain
  reference of an int8 engine's chunked prefill, whose later chunks
  attend the quantized cache (one pass attends the raw projections)."""
  import numpy as np
  logits, cache = _greedy_path(torch, model, prompt, plan)
  out = []
  with torch.inference_mode():
    for _ in range(num_new):
      out.append(int(logits.argmax()))
      logits = model(torch.as_tensor([out[-1:]]), cache)[0, -1].float()
  return np.concatenate([prompt, np.asarray(out, prompt.dtype)])


def _parity_against(torch, what, model, prompts, outs, refs, plans):
  """Each output against its greedy reference: equal, or first different
  at a near-tie (top-2 gap under 1e-4, along the reference's own path:
  the prefill in ``plans``' chunks, then one token a step); raises
  otherwise."""
  import numpy as np
  exact, ties, off = 0, [], []
  for p, out, ref, plan in zip(prompts, outs, refs, plans):
    out = np.asarray(out)
    if len(out) == len(ref) and (out == ref).all():
      exact += 1
      continue
    pos = int(np.argmax(out[:len(ref)] != ref[:len(out)]))
    logits, _ = _greedy_path(torch, model, ref[:pos], plan)
    top2 = torch.topk(logits, 2).values
    gap = float(top2[0] - top2[1])
    rec = {"prompt_len": len(p), "position": pos - len(p), "gap": gap}
    (ties if gap < 1e-4 else off).append(rec)
  if off:
    raise AssertionError("%s: outputs differ from the greedy reference away "
                         "from a near-tie: %s" % (what, off))
  return {"requests": len(prompts), "identical": exact, "near_ties": ties,
          "not_ties": off}


def decode_parity_f32(torch, tfm, slots, ServingEngine, params, cfg32,
                      prompts):
  """(a): every leg in f32 (TF32 off) on the first requests against the
  single-request greedy decode of the same config and weights.

  The reference is ``greedy_generate_kv``, except for the timed int8
  engine: a later chunk of an int8 prefill attends the quantized cache
  where one pass attends the raw projections, so chunking changes an
  int8 engine's values at the quantization's scale (the reference's own
  design on its chip). That engine (default buckets) is held against a
  greedy decode whose prefill runs in the engine's own ``chunk_plan``
  chunks, and an int8 engine whose buckets are the prompts' lengths (one
  chunk each) against ``greedy_generate_kv``."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  prompts = prompts[:DECODE_PARITY_REQUESTS]
  models = {int8: tfm.Transformer(_leg_cfg(cfg32, int8), params)
            for int8 in (False, True)}
  greedy = {int8: [tfm.greedy_generate_kv(
      model, p[None], DECODE_PARITY_NEW).cpu().numpy()[0] for p in prompts]
            for int8, model in models.items()}
  one_chunk = tuple(sorted({len(p) for p in prompts}, reverse=True))
  runs = [(name, opts, int8, None) for name, opts, int8 in decode_legs(cfg32)]
  runs.append(("int8_one_chunk", dict(num_slots=DECODE_BASE_SLOTS), True,
               one_chunk))
  res = {}
  for name, opts, int8, buckets in runs:
    extra = {} if buckets is None else {"buckets": buckets}
    eng = decode_engine(ServingEngine, params, cfg32, opts, int8, **extra)
    try:
      outs = [o.tolist() for o in eng.generate(
          prompts, max_new_tokens=DECODE_PARITY_NEW, timeout=600)]
    finally:
      eng.stop()
    model = models[int8]
    if int8 and buckets is None:
      plans = [slots.chunk_plan(len(p)) for p in prompts]
      refs = [_greedy_chunked(torch, model, p, DECODE_PARITY_NEW, plan)
              for p, plan in zip(prompts, plans)]
    else:
      plans, refs = [[len(p)] for p in prompts], greedy[int8]
    res[name] = _parity_against(torch, "[6r](a) %s" % name, model, prompts,
                                outs, refs, plans)
    log("  (a) %-14s f32: %d/%d token-identical, near-ties %d"
        % (name, res[name]["identical"], len(prompts),
           len(res[name]["near_ties"])))
    torch.cuda.empty_cache()
  return res


def decode_crash(torch, ops, chaos, ServingEngine, params, cfg, opts,
                 prompts, want):
  """(e): the full_stack engine under ``TOS_CHAOS_SERVE=decode#3:raise``,
  armed after the warm-up and counted from a ``chaos.reset()``: outputs
  equal to its fault-free run's to the bit, one restart, replays without
  a mismatch, the pool rebuilt with the slab."""
  what = "[6r](e) full_stack under TOS_CHAOS_SERVE=%s" % DECODE_CRASH
  eng = decode_engine(ServingEngine, params, cfg, opts, False,
                      restart_backoff=0.01, poison_crashes=3)
  try:
    _decode_warm(eng, cfg)
    with env_var(chaos.ENV_SERVE, DECODE_CRASH):
      chaos.reset()
      run = decode_timed(torch, ops, eng, prompts)
    chaos.reset()
    in_use, held = eng.kv_pages_in_use, eng._prefix.pages_held
  finally:
    eng.stop()
  d = run["delta"]
  replays = sum(h.replays for h in run["handles"])
  bad = [i for i, (o, w) in enumerate(zip(run["outs"], want)) if o != w]
  if bad:
    raise AssertionError("%s: outputs of requests %s differ from the "
                         "fault-free run" % (what, bad))
  if d["engine_restarts"] != 1 or d["replay_mismatches"] or not replays \
      or in_use != held:
    raise AssertionError("%s: stats %s, %d replays, %d pages in use for "
                         "%d in the trie" % (what, d, replays, in_use, held))
  log("  (e) crash replay: 1 restart, %d requests replayed, outputs equal "
      "to the fault-free run, %d pages in use = the rebuilt trie's"
      % (replays, in_use))
  return {"engine_restarts": d["engine_restarts"],
          "replayed_requests": replays, "replays": d["replays"],
          "replay_mismatches": d["replay_mismatches"],
          "restart_s": eng.restart_log[0]["duration_s"],
          "pages_in_use": in_use, "trie_pages": held,
          "launches": run["launches"]}


def decode_stack_phase(torch, ops, tfm, ServingEngine, card, params, cfg):
  """[6r]: the decode-speed stack at full width (module docstring)."""
  from tensorflowonspark_tpu_torch.serving import slots
  from tensorflowonspark_tpu_torch.utils import chaos
  t_phase = time.monotonic()
  chaos.reset()
  soft = soften_exit_layers(params, cfg, DECODE_SPEC_LAYERS)
  prompts = make_prefix_workload(cfg.vocab_size, DECODE_SEED)
  log("  workload: %d requests over %d system prompts of %d tokens, tails "
      "%s, %d new tokens, horizon %d" % (
          len(prompts), len({tuple(p[:DECODE_PREFIX_LEN]) for p in prompts}),
          DECODE_PREFIX_LEN, sorted({len(p) - DECODE_PREFIX_LEN
                                     for p in prompts}),
          DECODE_NEW, DECODE_HORIZON))
  legs, opts = {}, {}
  for name, leg_opts, int8 in decode_legs(cfg):
    opts[name] = leg_opts
    legs[name] = decode_leg(torch, ops, ServingEngine, soft, cfg, name,
                            leg_opts, int8, prompts)
  base = legs["baseline"]
  # (b) bytes
  page_bytes = legs["paged"]["kv_bytes"] // opts["paged"]["num_pages"]
  if abs(legs["paged"]["kv_bytes"] - base["kv_bytes"]) > page_bytes:
    raise AssertionError("[6r](b): the paged pool holds %d KV bytes, the "
                         "contiguous slab %d: more than a page apart"
                         % (legs["paged"]["kv_bytes"], base["kv_bytes"]))
  if legs["int8"]["kv_dtypes"] != ["torch.float32", "torch.int8"]:
    raise AssertionError("[6r](b): the int8 cache's leaves are %s"
                         % legs["int8"]["kv_dtypes"])
  ratio = legs["int8"]["kv_bytes"] / float(base["kv_bytes"])
  if ratio > DECODE_INT8_MAX_RATIO:
    raise AssertionError("[6r](b): the int8 slab is %.3f of the bf16 "
                         "slab's bytes" % ratio)
  log("  (b) KV bytes: contiguous %d, paged pool %d (a page is %d), int8 %d "
      "= %.4f of bf16" % (base["kv_bytes"], legs["paged"]["kv_bytes"],
                          page_bytes, legs["int8"]["kv_bytes"], ratio))
  # (d) counters, and the paged arithmetic against the contiguous slab's
  eng = decode_engine(ServingEngine, soft, cfg,
                      dict(opts["paged"], num_slots=DECODE_BASE_SLOTS), False)
  try:
    first = prompts[:DECODE_BASE_SLOTS]
    paged8 = [o.tolist() for o in eng.generate(first, timeout=600)]
  finally:
    eng.stop()
  bad = [i for i, (o, w) in enumerate(zip(paged8, base["outputs"])) if o != w]
  if bad:
    raise AssertionError("[6r](d): a paged engine with %d slots differs "
                         "from baseline's outputs on requests %s"
                         % (DECODE_BASE_SLOTS, bad))
  if legs["paged_prefix"]["prefix_hits"] < DECODE_MIN_HITS:
    raise AssertionError("[6r](d): paged_prefix recorded %d prefix hits, "
                         "fewer than %d" % (legs["paged_prefix"]
                                            ["prefix_hits"], DECODE_MIN_HITS))
  if not legs["full_stack"]["spec_accepted"] > 0:
    raise AssertionError("[6r](d): full_stack accepted no draft token")
  for name, leg in legs.items():
    leg["equal_to_baseline"] = sum(
        o == w for o, w in zip(leg["outputs"], base["outputs"])) / float(
            len(prompts))
  log("  (d) paged at %d slots equals baseline's first %d to the bit; share "
      "equal to baseline: %s; paged_prefix hits %d; full_stack accepted %d"
      % (DECODE_BASE_SLOTS, len(first), {n: round(l["equal_to_baseline"], 3)
                                         for n, l in legs.items()},
         legs["paged_prefix"]["prefix_hits"],
         legs["full_stack"]["spec_accepted"]))
  crash = decode_crash(torch, ops, chaos, ServingEngine, soft, cfg,
                       opts["full_stack"], prompts,
                       legs["full_stack"]["outputs"])
  torch.cuda.empty_cache()
  parity = decode_parity_f32(torch, tfm, slots, ServingEngine, soft,
                             dataclasses.replace(cfg, dtype=torch.float32),
                             prompts)
  torch.cuda.empty_cache()
  for leg in legs.values():
    leg.pop("outputs")
  return {"card": card, "legs": legs, "crash": crash, "parity_f32": parity,
          "int8_bytes_ratio": ratio,
          "total_s": time.monotonic() - t_phase}


def decode_summary(res):
  """[6r]'s numbers for one JSON line."""
  keys = ("tokens_per_s", "ttft_ms_p50", "ttft_ms_p99",
          "decode_ms_per_dispatch", "prefills", "prefix_hits",
          "prefix_evictions", "peak_pages_in_use", "spec_accept_rate",
          "peak_mem_gib", "kv_bytes", "equal_to_baseline")
  return {"legs": {n: {k: leg[k] for k in keys}
                   for n, leg in res["legs"].items()},
          "crash": {k: res["crash"][k] for k in (
              "engine_restarts", "replayed_requests", "replay_mismatches")},
          "parity_near_ties": {n: len(p["near_ties"])
                               for n, p in res["parity_f32"].items()},
          "total_s": res["total_s"]}


def decode_launches(res, name):
  """[6r]'s launches of kernel ``name`` by leg, for the kernels line."""
  return {"decode_stack_" + leg: r["launches"][name]
          for leg, r in res["legs"].items()}


def decode_stack_only(torch, ops, tfm, ServingEngine, init_params, _build,
                      card):
  """``--decode-stack-only``: phase 6r alone, at full width (the script
  builds every kernel first)."""
  log("  built %s" % _build.build_all())
  cfg = tfm.TransformerConfig()
  res = decode_stack_phase(torch, ops, tfm, ServingEngine, card,
                           init_params(cfg, seed=SEED), cfg)
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out", "chip_smoke_decode.json"),
            "w") as f:
    json.dump(res, f, indent=1)
  log(card)
  log(json.dumps({"decode_stack": decode_summary(res), "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


# -- phase 6l: data parallelism across processes -----------------------------

DP_STEPS, DP_UNROLL = 4, 2          # [6l-b]: per-step steps, then one slab
DP_REL = 2e-3                       # 2 ranks against 1 process, bf16
DP_ARGS = ["--layers", "12", "--d_model", "768", "--heads", "12", "--vocab",
           "32000", "--seq_len", str(TRAIN_S), "--batch", str(TRAIN_B)]
# [6l-c]: 88 seeded rows in partitions of 48 and 40, 8 rows a rank a
# step (B16 global): the short rank runs dry after 5 batches, and the
# vote stops both there. A partition may run at most one batch past the
# shortest: the long rank must have taken all its rows when it waits in
# the failing vote, or its feeder waits for rows no one takes while the
# short rank waits for the end of feed that shutdown() sends after
# train() returns
DP_FEED_ROWS, DP_FEED_SPLIT, DP_FEED_B = 56, 32, TRAIN_B // 2
DP_FEED_SEED = SEED + 13
DP_LABEL = "gloo over host, two ranks sharing one card"


def dp_reassemble(ids_by_rank, rows):
  """Each step's global batch from the row ids each rank trained: rank
  0's rows, then rank 1's, ... (what ``shard_batch`` of that batch gives
  each rank back). The ranks must have trained the same number of
  steps."""
  import numpy as np
  steps = {len(ids) for ids in ids_by_rank}
  if len(steps) != 1:
    raise AssertionError("the ranks trained %s steps" % sorted(steps))
  return [np.stack([rows[i] for ids in ids_by_rank for i in ids[s]])
          for s in range(steps.pop())]


def dp_vote_passed(part_rows, per_rank):
  """The row ids a 2-rank ``next_batch_synced(per_rank)`` run trains when
  partition ``p`` (``part_rows[p]`` rows, ids numbered through the
  partitions) feeds one rank: full batches of each partition, up to the
  step where the shortest partition runs dry."""
  steps = min(n // per_rank for n in part_rows)
  out, first = [], 0
  for n in part_rows:
    out.append([list(range(first + s * per_rank, first + (s + 1) * per_rank))
                for s in range(steps)])
    first += n
  return out


def dp_max_rel(got, want):
  """The largest relative difference of two loss lists of one length."""
  if len(got) != len(want):
    raise AssertionError("%d losses against %d" % (len(got), len(want)))
  return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))


def _dp_run(torch, ops, tfm, optim, sharding, Slab, params, cfg, mesh):
  """[6]'s steps on its fixed batch over ``mesh`` (None: no mesh): 2
  warm-up steps, 4 ``make_train_step`` steps and one unroll-4 slab with
  exact launch counts and the collectives' counts, then one profiled
  step."""
  import numpy as np
  from tensorflowonspark_tpu_torch.parallel import collectives
  tx = optim.make_optimizer(learning_rate=3e-4, clip_norm=1.0)
  state = tfm.create_state(cfg, params, tx=tx) if mesh is None else \
      tfm.create_sharded_state(cfg, params, mesh, tx=tx)[0]
  batch = _synthetic_batch(TRAIN_B, TRAIN_S, cfg.vocab_size)
  loss_fn = _lm_loss(tfm)
  step = sharding.make_train_step(loss_fn, mesh)
  loop = sharding.make_train_loop(loss_fn, mesh, unroll=4)
  losses = []
  for _ in range(2):                               # warm-up
    state, loss = step(state, batch)
    losses.append(loss)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  res = {}
  for path in ("per_step", "fused_loop"):
    ops.reset_launches()
    collectives.reset_counts()
    t0 = time.monotonic()
    if path == "per_step":
      for _ in range(4):
        state, loss = step(state, batch)
        losses.append(loss)
    else:
      state, got = loop(state, Slab(np.stack([batch] * 4)))
      losses += list(got)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    res[path] = {"ms_per_step": wall / 4 * 1e3,
                 "tokens_per_s": TRAIN_B * TRAIN_S * 4 / wall,
                 "launches_per_step": _per_step_launches(
                     dict(ops.LAUNCHES), 4, WANT_PER_STEP,
                     "[6l-a] %s %s" % ("mesh" if mesh else "no mesh", path)),
                 "collectives": dict(collectives.COUNTS)}
  res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
  state, loss, res["profile"] = _profile_step(torch, step, state, batch)
  res["losses"] = [float(x) for x in losses + [loss]]
  weights = list(state.params.values())
  res["weights"] = sum(w.numel() for w in weights)
  res["buckets_per_step"] = len(collectives._buckets(
      weights, collectives.BUCKET_BYTES))
  return res


def _check_dp_collectives(res):
  """One bucketed all-reduce per bucket each step, every weight's f32
  gradient once; plus one all-reduce of the loss a step (per-step path)
  or of the slab's [4] losses."""
  per, nbytes = res["buckets_per_step"], 4 * res["weights"]
  for path, loss_reduces in (("per_step", 4), ("fused_loop", 1)):
    got = res[path]["collectives"]
    want = {"sync_gradients": 4, "buckets": 4 * per,
            "bucket_bytes": 4 * nbytes, "all_reduce": 4 * per + loss_reduces}
    if any(got[k] != v for k, v in want.items()):
      raise AssertionError("[6l-a] %s collectives %s, want %s"
                           % (path, got, want))


def dp_nccl_degree1(torch, ops, tfm, optim, sharding, Slab, params, cfg):
  """[6l-a]: [6]'s steps with no mesh, then over a 1-rank NCCL group's
  data axis (the bucket, the collective and the divide on the card):
  the losses equal to the bit, [6]'s launch counts on both, the
  collectives counted."""
  import torch.distributed as dist
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
  plain = _dp_run(torch, ops, tfm, optim, sharding, Slab, params, cfg, None)
  torch.cuda.empty_cache()
  if any(plain["per_step"]["collectives"].values()):
    raise AssertionError("[6l-a] the no-mesh path ran a collective: %s"
                         % plain["per_step"]["collectives"])
  torch.cuda.set_device(0)
  t0 = time.monotonic()
  dist.init_process_group("nccl", init_method="tcp://localhost:%d"
                          % get_free_port(), rank=0, world_size=1)
  init_s = time.monotonic() - t0
  try:
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=-1))
    if mesh.shape["data"] != 1 or mesh.group("data") is None:
      raise AssertionError("[6l-a] mesh %s" % mesh)
    dp = _dp_run(torch, ops, tfm, optim, sharding, Slab, params, cfg, mesh)
  finally:
    dist.destroy_process_group()
  torch.cuda.empty_cache()
  _check_dp_collectives(dp)
  if dp["losses"] != plain["losses"]:
    raise AssertionError("[6l-a] NCCL degree-1 losses %s differ from the "
                         "no-mesh path's %s" % (dp["losses"],
                                                plain["losses"]))
  res = {"plain": plain, "nccl": dp, "init_s": init_s}
  log("  NCCL init %.2f s; %d weights, %d buckets a step (%.1f MB of f32 "
      "gradients); losses equal to the no-mesh path's to the bit: %s"
      % (init_s, dp["weights"], dp["buckets_per_step"],
         4 * dp["weights"] / 1e6, " ".join("%.6f" % x for x in dp["losses"])))
  for path in ("per_step", "fused_loop"):
    log("  %-10s no mesh %.1f ms/step | NCCL data axis (1 rank) %.1f ms/step;"
        " collectives %s" % (path, plain[path]["ms_per_step"],
                             dp[path]["ms_per_step"],
                             dp[path]["collectives"]))
  log("  profiled step: no mesh device busy %.2f ms, NCCL %.2f ms, of it "
      "the all-reduce %.3f ms (%d NCCL kernels); peak memory %.2f / %.2f "
      "GiB" % (plain["profile"]["device_busy_ms"],
               dp["profile"]["device_busy_ms"],
               dp["profile"]["nccl_ms"], dp["profile"]["nccl_kernels"],
               plain["peak_mem_gib"], dp["peak_mem_gib"]))
  return res


def dp_train(torch, ops, train_gpt, sharding, argv):
  """train_gpt's pieces at ``argv`` (its mesh, state, loss and stream):
  DP_STEPS steps through ``device_prefetch``, then one unroll-DP_UNROLL
  slab from the same stream; per-step launch counts, losses and ms, the
  gradient all-reduce's seconds, peak memory and the final weights'
  print."""
  import itertools
  import numpy as np
  from tensorflowonspark_tpu_torch.data import readers
  from tensorflowonspark_tpu_torch.data.readers import Slab
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.utils.checkpoint import params_fingerprint
  args = train_gpt.parse_args(argv)
  mesh = train_gpt.make_mesh(args)
  cfg = train_gpt.make_config(args)
  state = train_gpt.make_state(args, cfg, mesh)
  loss_fn = train_gpt.make_loss_fn(args)
  step = sharding.make_train_step(loss_fn, mesh)
  loop = sharding.make_train_loop(loss_fn, mesh, unroll=DP_UNROLL)
  stream = train_gpt.batch_stream(args)
  mine = (lambda b: b) if mesh is None else \
      (lambda b: sharding.shard_batch(b, mesh))
  batches = readers.device_prefetch(
      (mine(b) for b in itertools.islice(stream, DP_STEPS)), size=2)
  sync_s, real_sync = [], collectives.sync_gradients

  def timed_sync(grads, mesh, **kw):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = real_sync(grads, mesh, **kw)
    torch.cuda.synchronize()
    sync_s.append(time.monotonic() - t0)
    return out

  collectives.sync_gradients = timed_sync
  try:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, launches, step_ms = [], [], []
    for batch in batches:
      before = dict(ops.LAUNCHES)
      t0 = time.monotonic()
      state, loss = step(state, batch)
      losses.append(float(loss))
      step_ms.append((time.monotonic() - t0) * 1e3)
      launches.append({k: ops.LAUNCHES[k] - before[k] for k in before})
    slab = Slab(np.stack([np.asarray(b, "int32") for b in
                          itertools.islice(stream, DP_UNROLL)]))
    if mesh is not None:
      slab = sharding.shard_slab(slab, mesh)
    before = dict(ops.LAUNCHES)
    t0 = time.monotonic()
    state, got = loop(state, slab)
    losses += got.float().tolist()
    slab_ms = (time.monotonic() - t0) * 1e3 / DP_UNROLL
    launches.append({k: (ops.LAUNCHES[k] - before[k]) / DP_UNROLL
                     for k in before})
  finally:
    collectives.sync_gradients = real_sync
  return {"rank": mesh.rank if mesh is not None else 0,
          "ranks": mesh.size if mesh is not None else 1,
          "losses": losses, "launches_per_step": launches,
          "step_ms": step_ms, "ms_per_step": statistics.median(step_ms[1:]),
          "slab_ms_per_step": slab_ms, "all_reduce_s": sync_s,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "print": params_fingerprint(state)}


def dp_check_collectives(torch):
  """The data axis's collectives on CUDA tensors in a 2-rank gloo group:
  each rank holds ``arange(8).view(4, 2) + 10 * rank``; every result must
  be exact and on the card. Returns the helpers checked."""
  from tensorflowonspark_tpu_torch.parallel import collectives
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=2))
  base = torch.arange(8.0, device="cuda").view(4, 2)
  x = base + 10 * mesh.rank
  total = 2 * base + 10
  want = {"psum_mean": (collectives.psum_mean(x, mesh), total / 2),
          "all_reduce": (collectives.all_reduce(x, mesh), total),
          "all_gather": (collectives.all_gather(x, mesh),
                         torch.cat([base, base + 10])),
          "reduce_scatter": (collectives.reduce_scatter(x, mesh),
                             total[2 * mesh.rank:2 * mesh.rank + 2]),
          "broadcast_from": (collectives.broadcast_from(x, mesh, src_index=1),
                             base + 10)}
  for name, (got, exact) in want.items():
    if not got.is_cuda or not torch.equal(got, exact):
      raise AssertionError("[6l-b] %s over gloo on the card gave %s, want %s"
                           % (name, got.cpu().tolist(), exact.cpu().tolist()))
  return sorted(want)


def dp_files_main(args, ctx):
  """[6l-b]'s main fn in each of two LocalEngine executors on the one
  card: join the gloo group, run ``dp_train`` at ``args["argv"]``
  (``--dp 2``) and write the result to ``args["out"] % rank``."""
  import torch
  import torch.distributed as dist
  from tensorflowonspark_tpu_torch import ops
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.parallel import sharding
  _no_tf32(torch)
  ctx.initialize_distributed(backend="gloo")
  try:
    res = dp_train(torch, ops, train_gpt, sharding, args["argv"])
    res["card"] = torch.cuda.get_device_name()
    res["collectives_on_card"] = dp_check_collectives(torch)
    with open(args["out"] % ctx.process_id, "w") as f:
      json.dump(res, f)
  finally:
    dist.destroy_process_group()
    torch.cuda.empty_cache()


def dp_feed_main(args, ctx):
  """[6l-c]'s main fn in each of two LocalEngine executors' background
  processes (InputMode.SPARK): the flagship (``args["layers"]`` deep)
  from rank 0's weights, trained from ``feed.next_batch_synced`` in the
  gloo group until the vote fails; writes each step's row ids, loss and
  launch counts and the final weights' print to ``args["out"] % rank``."""
  import numpy as np
  import torch
  from tensorflowonspark_tpu_torch import ops, optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils.checkpoint import params_fingerprint
  from tensorflowonspark_tpu_torch.utils.params import init_params
  _no_tf32(torch)
  with open(args["ready"] % ctx.executor_id, "w"):
    pass
  ctx.initialize_distributed(backend="gloo")
  mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=-1))
  cfg = tfm.TransformerConfig(num_layers=args["layers"])
  state, _ = tfm.create_sharded_state(
      cfg, init_params(cfg, seed=SEED), mesh,
      tx=optim.make_optimizer(learning_rate=3e-4, clip_norm=1.0))
  step = sharding.make_train_step(_lm_loss(tfm), mesh)
  ids = {r.tobytes(): i for i, r in enumerate(feed_rows(DP_FEED_ROWS,
                                                        DP_FEED_SEED))}
  feed = ctx.get_data_feed()
  trained, losses, launches, step_ms = [], [], [], []
  while not feed.should_stop():
    batch = feed.next_batch_synced(DP_FEED_B)
    if len(batch) < DP_FEED_B:
      break
    tokens = np.stack([np.asarray(r, np.int32) for r in batch])
    trained.append([ids[r.tobytes()] for r in tokens])
    before = dict(ops.LAUNCHES)
    t0 = time.monotonic()
    state, loss = step(state, tokens)
    losses.append(float(loss))
    step_ms.append((time.monotonic() - t0) * 1e3)
    launches.append({k: ops.LAUNCHES[k] - before[k] for k in before})
  with open(args["out"] % mesh.rank, "w") as f:
    json.dump({"rank": mesh.rank, "trained": trained, "losses": losses,
               "launches_per_step": launches, "step_ms": step_ms,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "print": params_fingerprint(state)}, f)


def _nccl_two_ranks(rank, port, out):
  """One rank of a 2-rank NCCL group on card 0: its first all-reduce's
  outcome, written to ``out % rank``."""
  import datetime
  import torch
  import torch.distributed as dist
  try:
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="tcp://localhost:%d" % port,
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    t = torch.ones(1, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    msg = "no refusal: the all-reduce gave %s" % t.item()
  except Exception as e:  # noqa: BLE001 - the refusal is what is recorded
    msg = "%s: %s" % (type(e).__name__, e)
  with open(out % rank, "w") as f:
    f.write(msg)


def nccl_refusal_start():
  """NCCL's answer to two ranks on one card: two spawned processes try
  one all-reduce. Returns their handle for :func:`nccl_refusal`."""
  import multiprocessing as mp
  from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
  out = os.path.join(HERE, "build", "chip_smoke_nccl_rank%d.txt")
  for r in range(2):
    _fresh(out % r)
  ctx = mp.get_context("spawn")
  port = get_free_port()
  procs = [ctx.Process(target=_nccl_two_ranks, args=(r, port, out))
           for r in range(2)]
  for p in procs:
    p.start()
  return procs, out, time.monotonic()


def nccl_refusal(started):
  """Whatever each of :func:`nccl_refusal_start`'s processes reported
  (killed 120 s after their start)."""
  procs, out, t0 = started
  for p in procs:
    p.join(timeout=max(1.0, t0 + 120 - time.monotonic()))
  msgs = []
  for r, p in enumerate(procs):
    if p.is_alive():
      p.kill()
      p.join()
    msgs.append(open(out % r).read() if os.path.exists(out % r) else
                "no answer (exit code %s)" % p.exitcode)
  return msgs


def _dp_cluster_done(c, what):
  c.shutdown(timeout=900)
  if c.supervisor.restarts:
    raise AssertionError("%s: the supervisor relaunched a node: %s"
                         % (what, c.supervisor.restarts))


def dp_two_ranks_files(torch, ops, train_gpt, sharding, cluster, engine):
  """[6l-b]: ``train_gpt --dp 2`` in two executors sharing the card over
  gloo, against the same flags at ``--dp 1`` in the driver."""
  pattern = write_token_files(os.path.join(HERE, "build",
                                           "chip_smoke_dp_tokens"),
                              32000, TRAIN_S, files=4, rows=16)
  argv = DP_ARGS + ["--data", os.path.abspath(pattern), "--steps",
                    str(DP_STEPS)]
  one = dp_train(torch, ops, train_gpt, sharding, argv + ["--dp", "1"])
  torch.cuda.empty_cache()
  for i, got in enumerate(one["launches_per_step"]):
    _per_step_launches(got, 1, WANT_PER_STEP, "[6l-b] one process step %d"
                       % i)
  out = os.path.join(HERE, "build", "chip_smoke_dp_rank%d.json")
  for r in range(2):
    _fresh(out % r)
  log("[6l-b] NCCL's answer to two ranks on one card (one attempt, "
      "untimed), beside the cluster run")
  refusal_procs = nccl_refusal_start()
  t0 = time.monotonic()
  c = cluster.run(engine, dp_files_main, {"argv": argv + ["--dp", "2"],
                                          "out": out},
                  input_mode=cluster.InputMode.FILES, chips_per_node=0,
                  max_restarts=0, reservation_timeout=300)
  _dp_cluster_done(c, "[6l-b]")
  cluster_s = time.monotonic() - t0
  ranks = []
  for r in range(2):
    with open(out % r) as f:
      ranks.append(json.load(f))
  for rank in ranks:
    for i, got in enumerate(rank["launches_per_step"]):
      _per_step_launches(got, 1, WANT_PER_STEP, "[6l-b] rank %d step %d"
                         % (rank["rank"], i))
    if len(rank["collectives_on_card"]) != 5:
      raise AssertionError("[6l-b] rank %d checked %s"
                           % (rank["rank"], rank["collectives_on_card"]))
  if ranks[0]["losses"] != ranks[1]["losses"] or \
      ranks[0]["print"] != ranks[1]["print"]:
    raise AssertionError("[6l-b] the ranks disagree: losses %s / %s, "
                         "weights %s / %s" % (
                             ranks[0]["losses"], ranks[1]["losses"],
                             ranks[0]["print"], ranks[1]["print"]))
  rel = dp_max_rel(ranks[0]["losses"], one["losses"])
  if not rel <= DP_REL or not all(math.isfinite(x) for x in one["losses"]):
    raise AssertionError("[6l-b] 2 ranks %s against 1 process %s: %.3g "
                         "relative" % (ranks[0]["losses"], one["losses"],
                                       rel))
  refusal = nccl_refusal(refusal_procs)
  res = {"one_process": one, "ranks": ranks, "max_rel_loss_diff": rel,
         "cluster_s": cluster_s, "nccl_two_ranks_one_card": refusal,
         "label": DP_LABEL}
  log("  losses: 2 ranks %s; 1 process %s; largest relative difference "
      "%.3g (limit %g); weights' print %s on both ranks" % (
          " ".join("%.5f" % x for x in ranks[0]["losses"]),
          " ".join("%.5f" % x for x in one["losses"]), rel, DP_REL,
          ranks[0]["print"]))
  for rank in ranks:
    log("  rank %d (%s): %.1f ms/step, slab %.1f ms/step, all-reduce %s s "
        "a step, peak memory %.2f GiB; 1 process B%d: %.1f ms/step, slab "
        "%.1f, peak %.2f GiB" % (
            rank["rank"], DP_LABEL, rank["ms_per_step"],
            rank["slab_ms_per_step"],
            " ".join("%.3f" % s for s in rank["all_reduce_s"]),
            rank["peak_mem_gib"], TRAIN_B, one["ms_per_step"],
            one["slab_ms_per_step"], one["peak_mem_gib"]))
  log("  %s exact on CUDA tensors over gloo on both ranks; cluster.run to "
      "shutdown %.1f s; NCCL, rank 0: %s" % (
          ", ".join(ranks[0]["collectives_on_card"]), cluster_s,
          refusal[0][:400]))
  return res


def dp_two_ranks_feed(torch, ops, tfm, optim, sharding, cluster, engine,
                      layers=12):
  """[6l-c]: DP_FEED_ROWS rows fed by ``Cluster.train`` in uneven
  partitions to two ranks that train from ``next_batch_synced``; the
  driver replays each step's reassembled global batch in one process."""
  from tensorflowonspark_tpu_torch.utils.params import init_params
  rows = feed_rows(DP_FEED_ROWS, DP_FEED_SEED)
  out = os.path.join(HERE, "build", "chip_smoke_dp_feed_rank%d.json")
  ready = os.path.join(HERE, "build", "chip_smoke_dp_ready%d")
  for r in range(2):
    _fresh(out % r)
    _fresh(ready % r)
  t0 = time.monotonic()
  c = cluster.run(engine, dp_feed_main, {"out": out, "ready": ready,
                                         "layers": layers},
                  input_mode=cluster.InputMode.SPARK, chips_per_node=0,
                  max_restarts=0, reservation_timeout=300)
  # feed once both nodes run their fn: a node still starting would leave
  # both partitions to the other
  deadline = time.monotonic() + 300
  while not all(os.path.exists(ready % r) for r in range(2)):
    if time.monotonic() > deadline:
      raise AssertionError("[6l-c] a node never started its fn")
    time.sleep(0.05)
  parts = [rows[:DP_FEED_SPLIT], rows[DP_FEED_SPLIT:]]
  c.train(parts, num_epochs=1)
  _dp_cluster_done(c, "[6l-c]")
  cluster_s = time.monotonic() - t0
  ranks = []
  for r in range(2):
    with open(out % r) as f:
      ranks.append(json.load(f))
  want = _want_per_layer(layers)
  for rank in ranks:
    for i, got in enumerate(rank["launches_per_step"]):
      _per_step_launches(got, 1, want, "[6l-c] rank %d step %d"
                         % (rank["rank"], i))
  passed = dp_vote_passed([len(p) for p in parts], DP_FEED_B)
  trained = sorted((r["trained"] for r in ranks), key=lambda t: t[0][0])
  if trained != passed:
    raise AssertionError("[6l-c] the ranks trained %s, the vote passed %s"
                         % (trained, passed))
  if ranks[0]["losses"] != ranks[1]["losses"] or \
      ranks[0]["print"] != ranks[1]["print"]:
    raise AssertionError("[6l-c] the ranks disagree: %s / %s"
                         % (ranks[0]["print"], ranks[1]["print"]))
  cfg = tfm.TransformerConfig(num_layers=layers)
  state = tfm.create_state(cfg, init_params(cfg, seed=SEED),
                           tx=optim.make_optimizer(learning_rate=3e-4,
                                                   clip_norm=1.0))
  step = sharding.make_train_step(_lm_loss(tfm))
  one = []
  for batch in dp_reassemble([r["trained"] for r in ranks], rows):
    state, loss = step(state, batch)
    one.append(float(loss))
  del state
  torch.cuda.empty_cache()
  rel = dp_max_rel(ranks[0]["losses"], one)
  if not rel <= DP_REL:
    raise AssertionError("[6l-c] 2 ranks %s against 1 process %s: %.3g "
                         "relative" % (ranks[0]["losses"], one, rel))
  res = {"ranks": ranks, "one_process": one, "max_rel_loss_diff": rel,
         "steps": len(one), "cluster_s": cluster_s, "layers": layers,
         "label": DP_LABEL}
  log("  partitions of %d and %d rows, %d a rank a step: both ranks stopped "
      "after %d steps, exactly the vote-passed batches; losses %s; 1 process "
      "on the reassembled batches %s; largest relative difference %.3g; "
      "weights' print %s on both" % (
          len(parts[0]), len(parts[1]), DP_FEED_B, len(one),
          " ".join("%.5f" % x for x in ranks[0]["losses"]),
          " ".join("%.5f" % x for x in one), rel, ranks[0]["print"]))
  log("  %s: rank 0 %.1f ms/step, rank 1 %.1f ms/step (median after the "
      "first); cluster.run to shutdown %.1f s" % (
          DP_LABEL, statistics.median(ranks[0]["step_ms"][1:]),
          statistics.median(ranks[1]["step_ms"][1:]), cluster_s))
  return res


def dp_phases(torch, ops, tfm, optim, sharding, Slab, train_gpt, params,
              cfg, then=None):
  """[6l]: the data axis over NCCL at degree 1 in the driver, then two
  executors sharing the card over gloo in InputMode.FILES and SPARK;
  ``then(engine)``, if given, runs on the same LocalEngine(2) after [6l]
  (its warm executors), its result under ``"then"``."""
  from tensorflowonspark_tpu_torch import cluster
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  t0 = time.monotonic()
  log("[6l-a] [6] over the data axis of a 1-rank NCCL group, beside the "
      "no-mesh path")
  nccl = dp_nccl_degree1(torch, ops, tfm, optim, sharding, Slab, params,
                         cfg)
  engine = LocalEngine(num_executors=2)
  try:
    log("[6l-b] train_gpt --dp 2 in cluster.run(LocalEngine(2), ..., "
        "InputMode.FILES): %s" % DP_LABEL)
    files = dp_two_ranks_files(torch, ops, train_gpt, sharding, cluster,
                               engine)
    log("[6l-c] Cluster.train in uneven partitions to 2 ranks training from "
        "next_batch_synced (InputMode.SPARK): %s" % DP_LABEL)
    feed = dp_two_ranks_feed(torch, ops, tfm, optim, sharding, cluster,
                             engine)
    res = {"nccl_degree1": nccl, "files": files, "feed": feed,
           "seconds": time.monotonic() - t0}
    log("  [6l] %.1f s" % res["seconds"])
    if then is not None:
      res["then"] = then(engine)
  finally:
    engine.stop()
  return res


def dp_launches(dp_res, name):
  """[6l]'s launches of kernel ``name``: the NCCL per-step path's 4 steps,
  and rank 0's steps in [6l-b] (slab steps counted once each) and
  [6l-c]."""
  nccl = int(dp_res["nccl_degree1"]["nccl"]["per_step"][
      "launches_per_step"][name] * 4)
  per = dp_res["files"]["ranks"][0]["launches_per_step"]
  files = int(sum(p[name] for p in per[:-1]) + DP_UNROLL * per[-1][name])
  feed = sum(p[name] for p in dp_res["feed"]["ranks"][0]["launches_per_step"])
  return {"dp_nccl_degree1_4_steps": nccl,
          "dp_files_rank0_%d_steps" % (DP_STEPS + DP_UNROLL): files,
          "dp_feed_rank0_%d_steps" % dp_res["feed"]["steps"]: feed}


def dp_only(torch, ops, tfm, optim, sharding, Slab, train_gpt, init_params,
            card):
  """``--dp-only``: phase 6l alone."""
  cfg = tfm.TransformerConfig()
  res = dp_phases(torch, ops, tfm, optim, sharding, Slab, train_gpt,
                  init_params(cfg, seed=SEED), cfg)
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out", "chip_smoke_dp.json"),
            "w") as f:
    json.dump({"dp": res, "card": card}, f, indent=1)
  log(card)
  log(json.dumps({"dp": {
      "nccl_ms_per_step": [res["nccl_degree1"][k]["per_step"]["ms_per_step"]
                           for k in ("plain", "nccl")],
      "files_ms_per_step": [r["ms_per_step"]
                            for r in res["files"]["ranks"]],
      "files_one_process_ms_per_step": res["files"]["one_process"][
          "ms_per_step"],
      "files_max_rel": res["files"]["max_rel_loss_diff"],
      "feed_max_rel": res["feed"]["max_rel_loss_diff"],
      "launches": {n: dp_launches(res, n) for n in (
          "flash_attention_fwd", "flash_attention_bwd", "layer_norm",
          "layer_norm_bwd")},
      "seconds": res["seconds"]}, "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


# -- phase 6s: the SPMD mesh axes (fsdp, sequence, tensor) -------------------

SPMD_STEPS = 3
SPMD_REL = 2e-3                     # bf16 losses, ranks against one process
SPMD_F32_TOL = 1e-5                 # f32 losses and gathered weights
# f32 first-step gradients, over each tensor's largest |g|: sums over up
# to 16384 positions in another order
SPMD_GRAD_REL = 1e-5
# f32 updates after SPMD_STEPS steps (final minus initial weights), over
# each tensor's largest |update|, plus 4 units in the last place of the
# weight for the steps' f32 roundings
SPMD_UPDATE_REL = 1e-4
SPMD_F32_LAYERS = 2
# the f32 runs take SGD, whose update is linear in the gradient (AdamW's
# per-element normalization turns f32 rounding in gradients below its
# epsilon into whole steps), at an lr large enough that 3 clipped steps
# move the weights far past the 1e-5 weight gate and the ulps of f32
SPMD_F32_FLAGS = ["--layers", str(SPMD_F32_LAYERS), "--optimizer", "sgd",
                  "--lr", "0.1"]
SPMD_LABEL = "gloo over host, ranks sharing one card"
# per rank and step: (a) the ring runs 2 flash forwards a layer, twice
# (remat), and the split backward's dQ and grouped dK/dV once a ring step
WANT_SPMD_LONG = dict(WANT_LONG_PER_STEP, flash_attention_fwd=48,
                      flash_attention_bwd_dq=24,
                      flash_attention_bwd_dkv_gqa=24)
# (d) 2 layers at sequence 2: 2 ring steps a layer, twice; the fused MHA
# backward once a ring step; LayerNorm 2 a layer, twice, and ln_f
WANT_SPMD_SMALL = dict(WANT_PER_STEP, flash_attention_fwd=8,
                       flash_attention_bwd=4, layer_norm=9, layer_norm_bwd=5)
WANT_ONE_SMALL = dict(WANT_PER_STEP, flash_attention_fwd=4,
                      flash_attention_bwd=2, layer_norm=9, layer_norm_bwd=5)
# (name, ranks, mesh flags, model flags (the one-process run's), the
# TFOS_TPU_FLASH_BWD plan, launches a rank a step, launches of the
# one-process run a step); (a) reads [6d]'s TFRecords
SPMD_CASES = (
    ("a_sp2_long", 2, ["--sp", "2"], LONG_ARGS, "split", WANT_SPMD_LONG,
     WANT_LONG_PER_STEP, None),
    ("b_tp2_fused", 2, ["--tp", "2"], DP_ARGS + ["--fused"], "fused",
     WANT_FUSED_PER_STEP, WANT_FUSED_PER_STEP, None),
    ("c_fsdp2", 2, ["--fsdp", "2"], DP_ARGS, "fused", WANT_PER_STEP,
     WANT_PER_STEP, None),
    ("d_sp2_tp2", 4, ["--sp", "2", "--tp", "2"], DP_ARGS + ["--layers", "2"],
     "fused", WANT_SPMD_SMALL, WANT_ONE_SMALL, None))
# -- [6t]: the pipeline and expert axes, as more jobs of the same groups
PPEP_MICRO = 4
PPEP_MOE = {"moe_experts": 8, "moe_top_k": 2, "moe_every": 2}
# (d): capacity factor E / k, so an expert's capacity is the whole slice
PPEP_A2A = dict(PPEP_MOE, moe_capacity_factor=4.0)
MOE_ARGS = ["--layers", "12", "--d_model", "768", "--heads", "12", "--vocab",
            "32000", "--seq_len", str(TRAIN_S), "--batch", "8"]
PP_FUSED_ARGS = DP_ARGS + ["--fused", "--kv_heads", "4", "--layers", "4"]


def _pp_stage_want(base, layers, stages, micro, last_ln):
  """Launches a pipeline stage makes a step: per microbatch its forward
  slot (no grad), its backward slot's forward under remat and the
  recompute (so a block's forward kernels 3 times) and the backward's
  kernels once, for its ``layers / stages`` blocks; the last stage adds
  ``ln_f``'s forward and backward (``last_ln``) per microbatch. ``base``:
  one block's forward and backward kernels."""
  k = layers // stages
  per = {n: micro * k * (3 * v if n in _FWD_KERNELS else v)
         for n, v in base.items()}
  last = dict(per, layer_norm=per["layer_norm"] + micro * last_ln,
              layer_norm_bwd=per["layer_norm_bwd"] + micro * last_ln)
  return tuple([per] * (stages - 1) + [last])


_FWD_KERNELS = ("flash_attention_fwd", "layer_norm", "ln_matmul",
                "gelu_matmul")
# one block, forward kernels once and backward kernels once
_BLOCK = dict({n: 0 for n in WANT_PER_STEP}, flash_attention_fwd=1,
              flash_attention_bwd=1, layer_norm=2, layer_norm_bwd=2)
_BLOCK_FUSED_GQA = dict({n: 0 for n in WANT_PER_STEP}, flash_attention_fwd=1,
                        flash_attention_bwd_gqa=1, ln_matmul=2,
                        gelu_matmul=1)
WANT_PP_A = _pp_stage_want(_BLOCK, 12, 2, PPEP_MICRO, 1)
WANT_PP_C = _pp_stage_want(_BLOCK_FUSED_GQA, 4, 2, PPEP_MICRO, 1)
WANT_ONE_C = dict(WANT_FUSED_PER_STEP, flash_attention_fwd=8,
                  flash_attention_bwd=0, flash_attention_bwd_gqa=4,
                  ln_matmul=16, gelu_matmul=8)
# (name, ranks, mesh flags, model flags (the one-process run's), the
# flash backward plan, launches a rank a step (a tuple: by pipeline
# stage), launches of the one-process run a step, MoE (config fields,
# expert degree) or None)
PPEP_CASES = (
    ("t_a_pp2", 2, ["--pp", "2", "--microbatches", str(PPEP_MICRO)],
     DP_ARGS, "fused", WANT_PP_A, WANT_PER_STEP, None),
    ("t_b_moe_e2", 2, [], MOE_ARGS, "fused", WANT_PER_STEP, WANT_PER_STEP,
     (PPEP_MOE, 2)),
    ("t_c_pp2_dp2_fused", 4, ["--pp", "2", "--dp", "2", "--microbatches",
                              str(PPEP_MICRO)], PP_FUSED_ARGS, "fused",
     WANT_PP_C, WANT_ONE_C, None),
    ("t_d_moe_e4_a2a", 4, [], MOE_ARGS + ["--layers", "2"], "fused",
     WANT_ONE_SMALL, WANT_ONE_SMALL, (PPEP_A2A, 4)))
PPEP_DECODE_PROMPTS, PPEP_DECODE_LEN, PPEP_DECODE_NEW = 4, 128, 16
# the ring's block cases for the kernel rows: queries of rank 1 (q_base
# 8192) against rank 0's keys (past) and its own (diagonal), and rank 0
# against rank 1's (future: every row masked)
RING_S, RING_H, RING_D = 8192, 12, 64
RING_FUTURE_SHARE = 0.2             # a future block's time over the past's
RING_BLOCKS = (("past", RING_S, 0), ("diagonal", RING_S, RING_S),
               ("future", 0, RING_S))
# rows 9-10 at --tp 2's local widths: QKV 1152 and up 1536 columns, the
# down projection's 1536 rows
TP_FUSED_CASES = (("ln_matmul", "qkv_tp2", 16384, 768, 1152, "bfloat16"),
                  ("ln_matmul", "up_tp2", 16384, 768, 1536, "bfloat16"),
                  ("gelu_matmul", "down_tp2", 16384, 1536, 768, "bfloat16"))


def _first_grads(torch, state, loss_fn, batch, mesh, pipe=None):
  """The whole gradients of the global batch's loss at ``state`` (the
  step's own sync over the mesh, then each block gathered; with ``pipe``,
  a 1F1B step's gradients of every stage), as f32 numpy arrays by
  parameter name."""
  from tensorflowonspark_tpu_torch.parallel import sharding
  params = state.params
  if pipe is not None:
    _, grads = pipe(params, batch)
    return {n: g.float().cpu().numpy() for n, g in grads.items()}
  device = next(state.model.parameters()).device
  loss = loss_fn(state.model, torch.as_tensor(batch).to(device))
  grads = torch.autograd.grad(loss, list(params.values()))
  if mesh is not None:
    grads = sharding.sync_state_gradients(grads, list(params),
                                          state.sharding, mesh)
    grads = [sharding.gather_array(g, state.sharding.spec(n), mesh)
             for n, g in zip(params, grads)]
  out = {n: g.float().cpu().numpy() for n, g in zip(params, grads)}
  return state.model.unpermute_params(out)


def _mesh_and_config(torch, train_gpt, args, moe):
  """``train_gpt``'s mesh and config at ``args``; with ``moe`` (MoE
  config fields, expert degree), its config with MoE layers on a mesh of
  ``expert`` over the process group (``train_gpt`` has no MoE flag, as
  the reference's has none)."""
  import torch.distributed as dist
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  cfg = train_gpt.make_config(args)
  if moe is None:
    return train_gpt.make_mesh(args), cfg
  mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(data=1, expert=moe[1])) \
      if dist.is_initialized() else None
  return mesh, dataclasses.replace(cfg, **moe[0])


class _EdgeCalls(object):
  """Calls of the embedding lookup (``TiedEmbed.forward`` on a real
  tensor; the pipeline's shape probe runs on the meta device) and of the
  LM loss in this process while it is entered: where a pipeline's edge
  work runs."""

  def __init__(self, tfm):
    self.tfm, self.counts = tfm, {"embed": 0, "loss": 0}

  def __enter__(self):
    tfm, counts = self.tfm, self.counts
    self._embed, self._loss = tfm.TiedEmbed.forward, tfm.causal_lm_loss
    embed, loss = self._embed, self._loss

    def counted_embed(module, tokens):
      if tokens.device.type != "meta":
        counts["embed"] += 1
      return embed(module, tokens)

    def counted_loss(*a, **kw):
      counts["loss"] += 1
      return loss(*a, **kw)

    tfm.TiedEmbed.forward, tfm.causal_lm_loss = counted_embed, counted_loss
    return self

  def __exit__(self, *exc):
    self.tfm.TiedEmbed.forward = self._embed
    self.tfm.causal_lm_loss = self._loss


class _RouteLog(object):
  """Each top-k routing decision of the MoE layers in this process while
  entered (``expert_parallel._topk_dispatch``: the router's forward, its
  remat recompute and the all-to-all path's own slice): per call, the
  step it ran in (``step``, set by the caller; None records nothing), its
  tokens' top-k experts and the gap between their k-th and (k+1)-th
  router probabilities. And the sign of each expert unit's pre-ReLU
  activation in the dense dispatch's first call of each step
  (``expert_parallel._experts``: the forward, not the recompute), with
  the values of those within RELU_NEAR of zero. [6t]'s routing check
  compares the ranks' calls with one process's."""

  def __init__(self):
    self.step = None
    self.calls = []            # (step, top-k [T, k] int16, gap [T] f32)
    self.relu = []             # (step, packed signs, shape, near idx, vals)

  def __enter__(self):
    import numpy as np
    from tensorflowonspark_tpu_torch.parallel import expert_parallel as ep
    self._ep, orig = ep, ep._topk_dispatch
    self._orig, self._orig_experts = orig, ep._experts
    orig_experts = ep._experts

    def logged_experts(x, dispatch, combine, w_up, w_down):
      if self.step is not None and self.step not in [r[0] for r in self.relu]:
        # the product _experts makes, made again: the same op on the same
        # inputs, so the same bits
        with torch.no_grad():      # nothing saved for a remat recompute
          pre = torch.bmm(dispatch.t()[:, :, None] * x.detach().float()[None],
                          w_up.detach().float())
        near = (pre.abs() < RELU_NEAR) & (pre != 0)
        self.relu.append((self.step,
                          np.packbits((pre > 0).cpu().numpy()),
                          np.asarray(pre.shape),
                          near.nonzero().to(torch.int32).cpu().numpy(),
                          pre[near].cpu().numpy()))
      return orig_experts(x, dispatch, combine, w_up, w_down)

    def logged(probs, top_k):
      if self.step is not None:
        srt = probs.detach().sort(dim=-1, descending=True, stable=True)
        self.calls.append((
            self.step,
            srt.indices[:, :top_k].to(dtype=self._int16).cpu().numpy(),
            (srt.values[:, top_k - 1] - srt.values[:, top_k]).float()
            .cpu().numpy()))
      return orig(probs, top_k)

    import torch
    self._int16 = torch.int16
    ep._topk_dispatch = logged
    ep._experts = logged_experts
    return self

  def __exit__(self, *exc):
    self._ep._topk_dispatch = self._orig
    self._ep._experts = self._orig_experts

  def arrays(self):
    """The calls as flat numpy arrays by name (for an ``.npz``)."""
    out = {}
    for i, (step, idx, gap) in enumerate(self.calls):
      out["%03d_%s_idx" % (i, step)] = idx
      out["%03d_%s_gap" % (i, step)] = gap
    for step, signs, shape, near, vals in self.relu:
      for key, v in (("signs", signs), ("shape", shape), ("near", near),
                     ("vals", vals)):
        out["relu_%s_%s" % (step, key)] = v
    return out


RELU_NEAR = 1e-5                    # |pre-ReLU| recorded with its value


def _route_calls(arrays):
  """:meth:`_RouteLog.arrays` back into [(step, idx, gap)] in call order."""
  keys = sorted(k for k in arrays
                if k.endswith("_idx") and not k.startswith("relu_"))
  return [(k.split("_")[1], arrays[k], arrays[k[:-4] + "_gap"])
          for k in keys]


def _relu_calls(arrays):
  """The ReLU records of :meth:`_RouteLog.arrays` by step: (signs [E, T,
  F] bool, {(e, t, f): value} of those near zero)."""
  import numpy as np
  out = {}
  for k in arrays:
    if k.startswith("relu_") and k.endswith("_signs"):
      step = k.split("_")[1]
      shape = tuple(int(x) for x in arrays["relu_%s_shape" % step])
      signs = np.unpackbits(arrays[k])[:int(np.prod(shape))].reshape(
          shape).astype(bool)
      near = {tuple(int(i) for i in ix): float(v) for ix, v in zip(
          arrays["relu_%s_near" % step], arrays["relu_%s_vals" % step])}
      out[step] = (signs, near)
  return out


def relu_diff(ranks, one, tokens, experts_per_rank, watch=(7, 2913)):
  """Where the signs of the experts' pre-ReLU activations in the ranks'
  first forward of each step (each rank its block of experts) differ
  from one process's: per step the count of flipped (expert, token,
  unit) entries, the first few and those of unit ``watch[1]`` of expert
  ``watch[0]``, each with its token's id and both sides' values where
  recorded (within RELU_NEAR of zero). None for a step no rank recorded
  (the all-to-all path does not run ``_experts``)."""
  import numpy as np
  out = {}
  for step, (signs1, near1) in sorted(one.items()):
    count, picked = 0, []
    recorded = False
    for r, calls in enumerate(ranks):
      if step not in calls:
        continue
      recorded = True
      signs_r, near_r = calls[step]
      lo = r * experts_per_rank
      idx = np.argwhere(signs_r != signs1[lo:lo + signs_r.shape[0]])
      count += len(idx)
      hit = idx[(idx[:, 0] + lo == watch[0]) & (idx[:, 2] == watch[1])]
      for tag, rows in (("first", idx[:12]), ("watched", hit[:8])):
        for e, t, f in rows:
          row, col = divmod(int(t), tokens[int(step)].shape[1])
          picked.append((tag, {
              "expert": lo + int(e), "token": int(t), "unit": int(f),
              "id": int(tokens[int(step)][row, col]),
              "pre_ranks": near_r.get((int(e), int(t), int(f))),
              "pre_one": near1.get((lo + int(e), int(t), int(f)))}))
    out[step] = None if not recorded else {
        "flips": count, "near_zero_one": len(near1),
        "first": [d for tag, d in picked if tag == "first"][:12],
        "watched": [d for tag, d in picked if tag == "watched"]}
  return out


def route_diff(ranks, one, tokens, world):
  """Where the ranks' top-k choices first differ from one process's, at
  steps 0-2 of an f32 MoE run. ``ranks``: each rank's calls, ``one``: the
  one process's (:func:`_route_calls`), ``tokens``: the steps' batches.
  A step's calls over all its tokens are compared in order; a call over
  a ``1 / world`` slice (the all-to-all path's own routing) against the
  one process's rows of that rank's slice. Returns per step the tokens
  whose expert sets differ, each with its id, its target, both expert
  sets and both gaps, and the smallest gap of any token."""
  import numpy as np
  out = {"steps": {}, "first": None}
  for step in ("0", "1", "2"):
    mine = [(i, g) for s, i, g in one if s == step]
    if not mine:
      continue
    full = mine[0][0].shape[0]
    diffs, compared = [], 0
    for r, calls in enumerate(ranks):
      at = [(i, g) for s, i, g in calls if s == step]
      fulls = [c for c in at if c[0].shape[0] == full]
      slices = [c for c in at if c[0].shape[0] == full // world]
      pairs = [(c, m, 0) for c, m in zip(fulls, mine)]
      lo = r * (full // world)
      pairs += [(c, (m[0][lo:lo + c[0].shape[0]], m[1][lo:lo + c[0].shape[0]]),
                 lo) for c, m in zip(slices, mine)]
      for (idx_r, gap_r), (idx_1, gap_1), lo in pairs:
        compared += 1
        a, b = np.sort(idx_r, axis=1), np.sort(idx_1, axis=1)
        for t in np.nonzero((a != b).any(axis=1))[0]:
          tok = lo + int(t)
          row, col = divmod(tok, tokens[int(step)].shape[1])
          diffs.append({
              "rank": r, "token": tok, "id": int(tokens[int(step)][row, col]),
              "target": (int(tokens[int(step)][row, col + 1])
                         if col + 1 < tokens[int(step)].shape[1] else None),
              "experts_ranks": a[t].tolist(), "experts_one": b[t].tolist(),
              "gap_ranks": float(gap_r[t]), "gap_one": float(gap_1[t])})
    uniq = {(d["token"], tuple(d["experts_ranks"]), tuple(d["experts_one"]))
            for d in diffs}
    out["steps"][step] = {
        "calls_compared": compared, "tokens_differ": len(uniq),
        "differ": diffs[:16],
        "smallest_gap_one": float(np.min(mine[0][1])),
        "max_gap_of_differing": max([max(d["gap_ranks"], d["gap_one"])
                                     for d in diffs] or [0.0])}
    if diffs and out["first"] is None:
      out["first"] = dict(diffs[0], step=int(step))
  return out


def spmd_train(torch, argv, f32=False, profile=False, weights=False,
               moe=None, in_rank=False, then=None):
  """``train_gpt``'s pieces at ``argv`` over the process group's mesh (or
  one process outside a group): SPMD_STEPS steps on the stream's first
  batches, each rank's block of them (with ``--pp``, the global batches
  through ``train_gpt.make_pp_step``), with launches, collectives, the
  embedding and loss calls and ms a step; the last step profiled with
  ``profile`` (the device's activity alone ``in_rank``); the config made
  f32 with ``f32``; MoE layers over the expert axis with ``moe``
  (:func:`_mesh_and_config`); ``then(argv, state, args, cfg, mesh,
  extra)`` after the last step, its record under ``cut_ckpt`` ([6v]).
  Returns (record, None or, with ``weights``, the first step's whole
  gradients, the whole weights before the first step (one process only,
  else None), the gathered weights after the last and, with ``moe``,
  after the first)."""
  import itertools
  import numpy as np
  from tensorflowonspark_tpu_torch import ops
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import collectives, sharding
  t_enter = time.monotonic()
  args = train_gpt.parse_args(argv)
  mesh, cfg = _mesh_and_config(torch, train_gpt, args, moe)
  if f32:
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
  state = train_gpt.make_state(args, cfg, mesh)
  pp = args.pp > 1
  extra = train_gpt.SEQUENCE_AXES if mesh is not None and not pp else ()
  if pp:
    step = train_gpt.make_pp_step(args, cfg, mesh)
  else:
    step = sharding.make_train_step(train_gpt.make_loss_fn(args), mesh,
                                    state.sharding, batch_extra_axes=extra)
  batches = [np.asarray(b, "int32") for b in
             itertools.islice(train_gpt.batch_stream(args), args.steps)]
  if mesh is not None and not pp:
    batches = [sharding.shard_batch(b, mesh, extra) for b in batches]
  device = next(state.model.parameters()).device
  batches = [torch.as_tensor(b).to(device) for b in batches]
  pipe = tfm.make_pipeline_train_step(cfg, mesh, args.microbatches) \
      if pp else None
  routes = _RouteLog() if weights and moe is not None else None
  if routes is not None:
    routes.__enter__()
  grads = _first_grads(torch, state, train_gpt.make_loss_fn(args),
                       batches[0], mesh, pipe) if weights else None
  w0 = sharding.gather_state_params(state) if weights and mesh is None \
      else None
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  rec = {"losses": [], "launches_per_step": [], "step_ms": [],
         "collectives_per_step": [], "edge_calls_per_step": [],
         "profile": None, "setup_s": time.monotonic() - t_enter}
  for i, batch in enumerate(batches):
    if routes is not None:
      routes.step = str(i)
    before = dict(ops.LAUNCHES)
    collectives.reset_counts()
    t0 = time.monotonic()
    with _EdgeCalls(tfm) as edges:
      if profile and i == len(batches) - 1:
        state, loss, rec["profile"] = _profile_step(torch, step, state,
                                                    batch, in_rank)
      else:
        state, loss = step(state, batch)
    rec["losses"].append(float(loss))
    rec["step_ms"].append((time.monotonic() - t0) * 1e3)
    rec["launches_per_step"].append({k: ops.LAUNCHES[k] - before[k]
                                     for k in before})
    rec["collectives_per_step"].append(dict(collectives.COUNTS))
    rec["edge_calls_per_step"].append(dict(edges.counts))
    if weights and moe is not None and i == 0:
      first = sharding.gather_state_params(state)
  if routes is not None:
    routes.__exit__(None, None, None)
    rec["routes"] = routes.arrays()
    rec["route_tokens"] = [b.cpu().numpy() for b in batches]
  if moe is not None:
    rec["moe_dropped"] = [int(b.moe.dropped) for b in state.model.layers
                          if b.use_moe and b.moe.dropped is not None]
  rec.update(rank=mesh.rank if mesh is not None else 0,
             stage=mesh.coord("pipeline") if mesh is not None else 0,
             mesh=dict(mesh.shape) if mesh is not None else None,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             param_bytes=state_bytes(state.params),
             opt_bytes=state_bytes(state.opt_state))
  if then is not None:
    rec["cut_ckpt"] = then(argv, state, args, cfg, mesh, extra)
  got = (grads, w0, sharding.gather_state_params(state),
         first if moe is not None else {}) if weights else None
  del state
  torch.cuda.empty_cache()
  rec["run_s"] = time.monotonic() - t_enter
  return rec, got


def _spmd_argv(base, pattern):
  argv = list(base) + ["--steps", str(SPMD_STEPS)]
  return argv + ["--data", pattern] if base is LONG_ARGS else argv


SPMD_GROUP_S = 900                  # a group's limit, from its start


@contextlib.contextmanager
def _weight_memo(drawn=()):
  """``utils.params.init_params`` drawn once per seed and widths in this
  process while inside: the seeded draw fills the parameters in order
  (the embedding, then layer by layer), so a model of fewer layers takes
  the first layers of a deeper draw of the same widths, to the bit (the
  f32 runs' 2 layers from the bf16 runs' 12). Models take their weights
  from it through ``create_state`` / ``create_sharded_state``. ``drawn``:
  ``(cfg, seed, weights)`` already drawn in this process."""
  from tensorflowonspark_tpu_torch.utils import params as params_mod
  draw, store = params_mod.init_params, {}

  def key_of(cfg, seed):
    return (cfg.vocab_size, cfg.d_model, cfg.num_heads, cfg.kv_heads,
            cfg.d_ff, cfg.fuse_qkv, cfg.moe_experts,
            cfg.moe_every if cfg.moe_experts else 0, int(seed))

  for cfg, seed, weights in drawn:
    store[key_of(cfg, seed)] = (cfg.num_layers, weights)

  def init_params(cfg, seed):
    key = key_of(cfg, seed)
    have = store.get(key)
    if have is None or have[0] < cfg.num_layers:
      have = store[key] = (cfg.num_layers, draw(cfg, seed))
    return {n: v for n, v in have[1].items()
            if not n.startswith("layers.")
            or int(n.split(".")[1]) < cfg.num_layers}

  params_mod.init_params = init_params
  try:
    yield
  finally:
    params_mod.init_params = draw


def _job_weights(job):
  """Draw a job's seeded weights (through the weight memo, which keeps
  them for the job's runs)."""
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.utils import params as params_mod
  cfg = train_gpt.make_config(train_gpt.parse_args(job["argv"]))
  if job.get("moe") is not None:
    cfg = dataclasses.replace(cfg, **job["moe"][0])
  params_mod.init_params(cfg, 0)


def _rank_warm_up(torch):
  """What a fresh process's first step and first profiler session pay
  for once, paid while the rank waits for its group: the ``torch._dynamo``
  imports of ``torch.utils.checkpoint`` and ``torch.profiler``, and the
  device tracer's start."""
  from torch.profiler import ProfilerActivity, profile
  from torch.utils.checkpoint import checkpoint
  import warnings
  x = torch.ones(8, device="cuda", requires_grad=True)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      checkpoint(torch.sin, x, use_reentrant=False).sum().backward()
      torch.cuda.synchronize()
    prof.key_averages()


def spmd_rank_main(rank, world, go, jobs, out):
  """One rank of a ``world``-rank gloo group on card 0: started ahead,
  it imports, makes its CUDA context, warms up (:func:`_rank_warm_up`)
  and draws its jobs' seeded weights, then waits for the file ``go`` (the
  group's port) before it joins the group; then each job's bf16 run (its
  last step profiled) and its f32 run at SPMD_F32_FLAGS; the records to
  ``out % rank`` (JSON) and the f32 run's first gradients and final
  gathered weights to ``<out % rank>.<job>.npz``. A job of
  CUT_CKPT_CASES saves its bf16 state after its steps
  (:func:`cut_ckpt_rank`, [6v])."""
  import datetime
  import numpy as np
  import torch
  import torch.distributed as dist
  torch.cuda.set_device(0)
  _no_tf32(torch)
  with _weight_memo():
    t0 = time.monotonic()
    _rank_warm_up(torch)
    for job in jobs:
      _job_weights(job)
    res = {"warm_s": time.monotonic() - t0}
    deadline = time.monotonic() + SPMD_GROUP_S
    while not os.path.exists(go):
      if time.monotonic() > deadline:
        raise RuntimeError("[6s] rank %d of %d: no start after %d s"
                           % (rank, world, SPMD_GROUP_S))
      time.sleep(0.05)
    with open(go) as f:
      port = int(f.read())
    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
      for job in jobs:
        moe = job.get("moe")
        then = functools.partial(cut_ckpt_rank, torch, job["name"]) \
            if job["name"] in CUT_CKPT_CASES else None
        with flash_bwd_env(job["bwd"]):
          res[job["name"]], _ = spmd_train(torch, job["argv"], profile=True,
                                           moe=moe, in_rank=True, then=then)
          res[job["name"] + "_f32"], got = spmd_train(
              torch, job["argv"] + SPMD_F32_FLAGS, f32=True, weights=True,
              moe=moe, in_rank=True)
        routes = res[job["name"] + "_f32"].pop("routes", None)
        res[job["name"] + "_f32"].pop("route_tokens", None)
        if routes:
          np.savez((out % rank) + "." + job["name"] + ".route.npz", **routes)
        if rank == 0:
          np.savez((out % rank) + "." + job["name"] + ".npz",
                   **{"grad/" + k: v for k, v in got[0].items()},
                   **{"weight/" + k: v for k, v in got[2].items()},
                   **{"first/" + k: v for k, v in got[3].items()})
        res[job["name"]]["card"] = torch.cuda.get_device_name()
    finally:
      dist.destroy_process_group()
  with open(out % rank, "w") as f:
    json.dump(res, f)


def _spmd_spawn(world, jobs):
  """``world`` ranks for ``jobs`` started ahead (:func:`spmd_rank_main`):
  they import and make their contexts while the card runs other work,
  and wait for :func:`_spmd_go`. Returns the group's handle."""
  import multiprocessing as mp
  out = os.path.join(HERE, "build", "chip_smoke_spmd_w%d_rank%%d.json"
                     % world)
  for r in range(world):
    _fresh(out % r)
  go = _fresh(os.path.join(HERE, "build", "chip_smoke_spmd_w%d.go" % world))
  ctx = mp.get_context("spawn")
  procs = [ctx.Process(target=spmd_rank_main, args=(r, world, go, jobs, out))
           for r in range(world)]
  for p in procs:
    p.start()
  return {"world": world, "jobs": jobs, "procs": procs, "out": out,
          "go": go, "t_spawn": time.monotonic()}


def _spmd_stop(group):
  for p in group["procs"]:
    if p.is_alive():
      p.kill()
    p.join()


def _spmd_go(group):
  """Start ``group``'s ranks on a free port and wait for them (at most
  SPMD_GROUP_S from their spawn): each rank's records and rank 0's f32
  weights by job, and the seconds from the start to the end."""
  import numpy as np
  from tensorflowonspark_tpu_torch.utils.hostinfo import get_free_port
  world, jobs, out, procs = (group[k] for k in ("world", "jobs", "out",
                                                "procs"))
  t0 = time.monotonic()
  with open(group["go"] + ".tmp", "w") as f:
    f.write(str(get_free_port()))
  os.replace(group["go"] + ".tmp", group["go"])
  for p in procs:
    p.join(timeout=max(1.0, group["t_spawn"] + SPMD_GROUP_S
                       - time.monotonic()))
  seconds = time.monotonic() - t0
  alive = [p.is_alive() for p in procs]
  _spmd_stop(group)
  codes = [None if a else p.exitcode for a, p in zip(alive, procs)]
  if codes != [0] * world:
    raise AssertionError("[6s] %d ranks exited %s (None: still running "
                         "at the limit, killed)" % (world, codes))
  ranks = []
  for r in range(world):
    with open(out % r) as f:
      ranks.append(json.load(f))
    ranks[-1]["_routes"], ranks[-1]["_relu"] = {}, {}
    for job in jobs:
      path = (out % r) + "." + job["name"] + ".route.npz"
      if os.path.exists(path):
        arrays = dict(np.load(path))
        ranks[-1]["_routes"][job["name"]] = _route_calls(arrays)
        ranks[-1]["_relu"][job["name"]] = _relu_calls(arrays)
  weights = {}
  for job in jobs:
    saved = np.load((out % 0) + "." + job["name"] + ".npz")
    weights[job["name"]] = tuple(
        {k.split("/", 1)[1]: saved[k] for k in saved.files
         if k.startswith(tag)} for tag in ("grad/", "weight/", "first/"))
  return ranks, weights, seconds


def _case_gates(case, ranks):
  """[6t]'s gates of a case beyond [6s]'s, on each rank's bf16 run: where
  the embedding and the loss run (a pipeline's stage 0 embeds each
  microbatch twice, its last stage takes the loss once a microbatch, no
  other stage either), the permutes a pipeline step makes (two a global
  step, ``n_micro + 2S - 1`` global steps) and the all-to-alls and
  dropped assignments of the MoE all-to-all dispatch."""
  name, _, flags = case[:3]
  moe = case[7]
  if "--pp" in flags:
    stages = int(flags[flags.index("--pp") + 1])
    micro = int(flags[flags.index("--microbatches") + 1])
    for r in ranks:
      rec = r[name]
      want = {"embed": 2 * micro if rec["stage"] == 0 else 0,
              "loss": micro if rec["stage"] == stages - 1 else 0}
      for i, got in enumerate(rec["edge_calls_per_step"]):
        if got != want:
          raise AssertionError("[6t] %s rank %d (stage %d) step %d: "
                               "embedding and loss calls %s, want %s"
                               % (name, rec["rank"], rec["stage"], i, got,
                                  want))
      for i, got in enumerate(rec["collectives_per_step"]):
        if got["ring_permute"] != 2 * (micro + 2 * stages - 1):
          raise AssertionError("[6t] %s rank %d step %d: %d permutes, want "
                               "%d" % (name, rec["rank"], i,
                                       got["ring_permute"],
                                       2 * (micro + 2 * stages - 1)))
  if moe is not None and moe[0].get("moe_capacity_factor"):
    for r in ranks:
      rec = r[name]
      if any(rec["moe_dropped"]):
        raise AssertionError("[6t] %s rank %d: %s assignments dropped at "
                             "capacity factor E/k" % (name, rec["rank"],
                                                      rec["moe_dropped"]))
      for i, got in enumerate(rec["collectives_per_step"]):
        # each MoE layer: 2 all-to-alls forward, again in the remat
        # recompute, and their 2 conjugates in the backward
        layers = sum(1 for b in range(int(_flag(case[3], "--layers")))
                     if b % moe[0]["moe_every"] == moe[0]["moe_every"] - 1)
        if got["all_to_all"] != 6 * layers:
          raise AssertionError("[6t] %s rank %d step %d: %d all-to-alls, "
                               "want %d" % (name, rec["rank"], i,
                                            got["all_to_all"], 6 * layers))


def _flag(argv, flag):
  """The last value ``flag`` takes in ``argv`` (argparse's rule)."""
  return [argv[i + 1] for i, a in enumerate(argv) if a == flag][-1]


def _expert_bytes(case):
  """Bytes of a MoE case's expert weights (f32) in one process."""
  moe, argv = case[7][0], case[3]
  layers = int(_flag(argv, "--layers"))
  d = int(_flag(argv, "--d_model"))
  n = sum(1 for b in range(layers)
          if b % moe["moe_every"] == moe["moe_every"] - 1)
  return n * 2 * moe["moe_experts"] * d * 4 * d * 4


def _spmd_gates(case, ranks, one, one32, w_ranks, w_one):
  """[6s]'s gates for one case ([6t]'s too, :func:`_case_gates`); its
  summary."""
  import numpy as np
  name, _, flags, base, _, want, _, moe = case
  tag = "[6t]" if name.startswith("t_") else "[6s]"
  for rank in ranks:
    stage_want = want[rank[name]["stage"]] if isinstance(want, tuple) \
        else want
    for i, got in enumerate(rank[name]["launches_per_step"]):
      _per_step_launches(got, 1, stage_want, "%s %s rank %d step %d"
                         % (tag, name, rank[name]["rank"], i))
  _case_gates(case, ranks)
  for key in (name, name + "_f32"):
    losses = {tuple(r[key]["losses"]) for r in ranks}
    if len(losses) != 1:
      raise AssertionError("[6s] %s: the ranks disagree: %s" % (key, losses))
  got = ranks[0][name]["losses"]
  rel = dp_max_rel(got, one["losses"])
  if not rel <= SPMD_REL or not all(math.isfinite(x) for x in got):
    raise AssertionError("[6s] %s: ranks %s against one process %s: %.3g "
                         "relative (limit %g)" % (name, got, one["losses"],
                                                  rel, SPMD_REL))
  rel32 = dp_max_rel(ranks[0][name + "_f32"]["losses"], one32["losses"])
  if not rel32 <= SPMD_F32_TOL:
    raise AssertionError("[6s] %s f32: ranks %s against one process %s: "
                         "%.3g relative" % (name, ranks[0][name + "_f32"][
                             "losses"], one32["losses"], rel32))
  g_ranks, w_ranks, w1_ranks = w_ranks
  g_one, w0, w_one, w1_one = w_one
  worst, worst_g, worst_u, share, u_sizes = 0.0, 0.0, 0.0, 0.0, []
  over_u, grad_rels, moe_gap3 = [], {}, 0.0
  for k, want_g in g_one.items():
    grel = float(np.abs(g_ranks[k] - want_g).max()) / max(
        float(np.abs(want_g).max()), 1e-30)
    worst_g = max(worst_g, grel)
    grad_rels[k] = grel
    if grel > SPMD_GRAD_REL:
      raise AssertionError("[6s] %s f32: the first step's gradient of %s is "
                           "off by %.3g of its largest |g| (limit %g)"
                           % (name, k, grel, SPMD_GRAD_REL))
  for k, want_w in w_one.items():
    diff = np.abs(w_ranks[k] - want_w)
    over = diff - SPMD_F32_TOL * (1 + np.abs(want_w))
    worst = max(worst, float(diff.max()))
    if (over > 0).any():
      raise AssertionError("[6s] %s f32: gathered %s off by %.3g"
                           % (name, k, float(diff.max())))
    # the update itself: a rank that skipped a step or clipped by another
    # norm moves its weights otherwise, however small the steps are. With
    # MoE layers, the steps after the first run at weights that differ
    # in their last bits, where an expert unit's pre-ReLU activation
    # within ~1e-6 of zero takes the other sign in one process than on
    # the ranks (the routing log shows such flips, and no routing one):
    # the first step's update (both at equal weights) is held so, and
    # the 3-step update within SPMD_F32_TOL of the one process's
    up_one, up_ranks = want_w - w0[k], w_ranks[k] - w0[k]
    if moe is not None:
      gap3 = float(np.abs(up_ranks - up_one).max())
      moe_gap3 = max(moe_gap3, gap3)
      if gap3 > SPMD_F32_TOL:
        over_u.append("%s's 3-step update by %.3g (limit %g)"
                      % (k, gap3, SPMD_F32_TOL))
      want_w, up_one, up_ranks = w1_one[k], w1_one[k] - w0[k], \
          w1_ranks[k] - w0[k]
    size = float(np.abs(up_one).max())
    gap = np.abs(up_ranks - up_one)
    limit = SPMD_UPDATE_REL * size + 4 * np.spacing(
        np.abs(want_w).astype(np.float32))
    u_sizes.append(size)
    worst_u = max(worst_u, float(gap.max()) / max(size, 1e-30))
    share = max(share, float((gap / limit).max()))
    if (gap > limit).any():
      at = np.unravel_index(int(np.argmax(gap / limit)), gap.shape)
      over_u.append("%s by %.3g of its largest |update| %.3g at %s (%d "
                    "entries over; weight %.6g, update %.3g against %.3g)"
                    % (k, float(gap.max()) / max(size, 1e-30), size,
                       tuple(int(i) for i in at), int((gap > limit).sum()),
                       float(want_w[at]), float(up_ranks[at]),
                       float(up_one[at])))
  if over_u:
    raise AssertionError("%s %s f32: the updates differ (limit %g of the "
                         "largest and 4 ulp of the weight): %s"
                         % (tag, name, SPMD_UPDATE_REL, "; ".join(over_u)))
  mine = ranks[0][name]["param_bytes"] + ranks[0][name]["opt_bytes"]
  whole = one["param_bytes"] + one["opt_bytes"]
  ln_bytes = (2 * int(_flag(base, "--layers")) + 1) * int(
      _flag(base, "--d_model")) * 4
  if name == "c_fsdp2" and 2 * mine - whole != 3 * ln_bytes:
    raise AssertionError("[6s] %s: a rank holds %d bytes of weights and "
                         "optimizer state, one process %d: not half, give or "
                         "take the %d bytes of whole LayerNorm scales and "
                         "their two moments" % (name, mine, whole, ln_bytes))
  if "--pp" in flags and mine != whole:
    raise AssertionError("[6t] %s: a stage holds %d bytes of weights and "
                         "optimizer state, one process %d: not the whole "
                         "state" % (name, mine, whole))
  if moe is not None:
    # the experts and their two moments are cut over the expert axis
    cut = 3 * _expert_bytes(case) * (moe[1] - 1) // moe[1]
    if whole - mine != cut:
      raise AssertionError("[6t] %s: a rank holds %d bytes of weights and "
                           "optimizer state, one process %d: want %d fewer "
                           "(the experts and their moments but a 1/%d)"
                           % (name, mine, whole, cut, moe[1]))
  per = [r[name] for r in ranks]
  return {"ranks": len(ranks), "losses": got, "one_process": one["losses"],
          "max_rel": rel, "f32_max_rel": rel32, "f32_max_abs_weight": worst,
          "f32_max_rel_grad": worst_g, "f32_max_rel_update": worst_u,
          "f32_rel_grad_by_tensor": grad_rels,
          "f32_update_gate": "first step" if moe is not None else "3 steps",
          "f32_moe_3_step_update_max_abs_gap": moe_gap3,
          "f32_update_gap_over_limit": share,
          "f32_update_max_abs": [min(u_sizes), max(u_sizes)],
          "ms_per_step": [r["step_ms"][1] for r in per],
          "profiled_wall_ms": [r["profile"]["wall_ms"] for r in per],
          "device_busy_ms": [r["profile"]["device_busy_ms"] for r in per],
          "one_ms_per_step": one["step_ms"][1],
          "peak_mem_gib": [r["peak_mem_gib"] for r in per],
          "one_peak_mem_gib": one["peak_mem_gib"],
          "state_bytes": [r["param_bytes"] + r["opt_bytes"] for r in per],
          "one_state_bytes": whole,
          "collectives_per_step": [r["collectives_per_step"][1]
                                   for r in per],
          "launches_per_step": [r["launches_per_step"][1] for r in per],
          "edge_calls_per_step": [r["edge_calls_per_step"][1] for r in per],
          # (setup, whole run) seconds: rank 0's bf16 and f32 runs, and
          # the one process's
          "seconds": {"rank0": [[r["setup_s"], r["run_s"]] for r in (
              per[0], ranks[0][name + "_f32"])],
                      "one_process": [[r["setup_s"], r["run_s"]]
                                      for r in (one, one32)]},
          "label": SPMD_LABEL}


def _ring_inputs(torch, hk, g):
  mk = lambda *shape: torch.randn(*shape, device="cuda",  # noqa: E731
                                  generator=g).to(torch.bfloat16)
  q, k, v = (mk(1, RING_S, RING_H, RING_D), mk(1, RING_S, hk, RING_D),
             mk(1, RING_S, hk, RING_D))
  return q, k, v, mk(1, RING_S, RING_H, RING_D), torch.randn(
      1, RING_H, RING_S, device="cuda", generator=g)


def _block_through_wrapper(ops, torch, q, k, v, go, gl, qb, kb, plan):
  """``ops.flash_attention_block`` at one ring block under backward plan
  ``plan``, differentiated by autograd with cotangents ``go`` (out) and
  ``gl`` (lse), as the ring's step runs it: out, lse and (dq, dk, dv).
  Raises unless it launched the forward and the plan's backward kernels
  once each."""
  mha = q.shape[2] == k.shape[2]
  want = {"flash_attention_fwd": 1}
  if plan == "fused":
    want["flash_attention_bwd" if mha else "flash_attention_bwd_gqa"] = 1
  else:
    want["flash_attention_bwd_dq"] = 1
    want["flash_attention_bwd_dkv" if mha else
         "flash_attention_bwd_dkv_gqa"] = 1
  before = dict(ops.LAUNCHES)
  leaves = [t.detach().requires_grad_() for t in (q, k, v)]
  out, lse = ops.flash_attention_block(*leaves, qb, kb, True, bwd=plan)
  torch.autograd.backward((out, lse), (go, gl))
  got = {n: c - before[n] for n, c in ops.LAUNCHES.items() if c != before[n]}
  if got != want:
    raise AssertionError("[6s] flash_attention_block at (%d, %d) under %s "
                         "launched %s, not %s" % (qb, kb, plan, got, want))
  return out.detach(), lse.detach(), tuple(t.grad for t in leaves)


def check_ring_blocks(ops, torch, F):
  """The flash kernels at the ring's block cases (rows 1, 3-7): q ``[1,
  8192, 12, 64]`` against an 8192-key block with Hk 4 (forward, fused
  grouped backward, split dQ and grouped dK/dV) and Hk 12 (fused MHA
  backward and MHA dK/dV), every backward with a nonzero lse cotangent
  on every row. Each is held against its plain version through the
  ring's own call, ``ops.flash_attention_block`` differentiated by
  autograd under the fused and the split plan, then timed alone, with
  its bound from the visible pairs and SDPA where one call computes the
  same function. The future block must give out 0, lse -1e30 and zero
  gradients, and cost under RING_FUTURE_SHARE of the past block's time."""
  fa = sys.modules["tensorflowonspark_tpu_torch.ops.flash_attention"]
  g = torch.Generator(device="cuda").manual_seed(SEED + 51)
  rows, worst = [], 0.0
  isz = 2
  for hk in (4, RING_H):
    q, k, v, go, gl = _ring_inputs(torch, hk, g)
    for case, qb, kb in RING_BLOCKS:
      ro, rl = ops.flash_attention_reference(q, k, v, qb, kb, True, None)
      grads = {}
      for plan in ("fused", "split"):
        out, lse, grads[plan] = _block_through_wrapper(
            ops, torch, q, k, v, go, gl, qb, kb, plan)
      want = ops.flash_attention_bwd_reference(q, k, v, out, lse, go, gl, qb,
                                               kb, True, None)
      delta = fa._bwd_delta(out, go, gl)
      torch.cuda.synchronize()
      err = (out.float() - ro.float()).abs().max().item()
      lerr = (lse - rl).abs().max().item()
      if not (torch.allclose(out.float(), ro.float(), atol=2e-2, rtol=2e-2)
              and torch.allclose(lse, rl, atol=1e-4, rtol=1e-4)):
        raise AssertionError("[6s] ring %s Hk %d forward: out err %.3g, lse "
                             "err %.3g" % (case, hk, err, lerr))
      for plan, got in grads.items():
        for t, a, r in zip("qkv", got, want):
          if not torch.isfinite(a).all():
            raise AssertionError("[6s] ring %s Hk %d %s d%s is not finite"
                                 % (case, hk, plan, t))
          if case == "future":
            if a.any():
              raise AssertionError("[6s] ring future Hk %d %s d%s is not 0"
                                   % (hk, plan, t))
          else:
            worst = max(worst, _rel_check("[6s] ring %s Hk %d %s d%s" % (
                case, hk, plan, t), a, r, 1e-2))
      if case == "future" and not ((out == 0).all() and (lse == -1e30).all()):
        raise AssertionError("[6s] ring future Hk %d: out 0 and lse -1e30 "
                             "expected" % hk)
      worst = max(worst, err, lerr)
      pairs = RING_H * _visible_pairs(RING_S, RING_S, qb, kb, None)
      qn, kn = q.numel(), k.numel()
      fwd_bytes = (2 * qn + 2 * kn) * isz + lse.numel() * 4
      read = (2 * qn + 2 * kn) * isz + 2 * lse.numel() * 4
      bwd_cost = {"fwd": (fwd_bytes, 4.0),
                  "fused_bwd": (read + qn * isz + (qn + 2 * kn) * isz,
                                10.0),
                  "dq": (read + qn * isz, 6.0),
                  "dkv": (read + 2 * kn * isz, 8.0)}
      calls = {"fwd": lambda: fa._forward(q, k, v, qb, kb, True, None),
               "fused_bwd": lambda: fa._fused_bwd(q, k, v, out, lse, go, gl,
                                                  qb, kb, True, None),
               "dq": lambda: ops.flash_attention_bwd_dq(
                   q, k, v, go, lse, delta, qb, kb, True, None),
               "dkv": lambda: ops.flash_attention_bwd_dkv(
                   q, k, v, go, lse, delta, qb, kb, True, None)}
      plains = {"fwd": lambda: ops.flash_attention_reference(
                    q, k, v, qb, kb, True, None),
                "fused_bwd": lambda: ops.flash_attention_bwd_reference(
                    q, k, v, out, lse, go, gl, qb, kb, True, None),
                "dq": lambda: ops.flash_attention_bwd_dq_reference(
                    q, k, v, go, lse, delta, qb, kb, True, None),
                "dkv": lambda: ops.flash_attention_bwd_dkv_reference(
                    q, k, v, go, lse, delta, qb, kb, True, None)}
      # SDPA computes the past block (no mask) and the diagonal (causal)
      # with K/V expanded; no call computes a block of masked rows
      lib = {}
      if case != "future":
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (t.repeat_interleave(RING_H // hk, dim=2).transpose(1, 2)
                  .detach().requires_grad_() for t in (k, v))
        causal = case == "diagonal"
        lib["fwd"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), runs=7, inner=3)
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        gt = go.transpose(1, 2)
        lib["bwd"] = time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), gt, retain_graph=True), runs=5, inner=2)
        del qt, kt, vt, ot, gt
      kernels = ("fwd", "fused_bwd", "dq", "dkv") if hk == 4 else \
          ("fused_bwd", "dkv")
      for kern in kernels:
        nbytes, per_pair = bwd_cost[kern]
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = per_pair * pairs * RING_D / PEAK_FLOPS["bfloat16"] * 1e3
        name = {"fwd": "flash_attention_fwd",
                "fused_bwd": "flash_attention_bwd" if hk == RING_H else
                "flash_attention_bwd_gqa",
                "dq": "flash_attention_bwd_dq",
                "dkv": "flash_attention_bwd_dkv" if hk == RING_H else
                "flash_attention_bwd_dkv_gqa"}[kern]
        row = {"kernel": name, "case": case, "Hk": hk, "B": 1, "Sq": RING_S,
               "Sk": RING_S, "H": RING_H, "D": RING_D, "q_base": qb,
               "kv_base": kb, "lse_cotangent": True, "pairs": pairs,
               "ms": time_ms(calls[kern], runs=7, inner=3),
               "plain_ms": time_ms(plains[kern], runs=2, inner=1),
               "bound_ms": max(bound_b, bound_o),
               "bound_by": "bytes" if bound_b >= bound_o else "operations",
               "library_ms": lib.get("fwd" if kern == "fwd" else "bwd"),
               "library": None if case == "future" else (
                   "SDPA" + (" backward (dQ, dK, dV together)"
                             if kern != "fwd" else ""))}
        rows.append(row)
        log("  ring %-8s Hk %-2d %-27s ms=%.4f plain=%.3f lib=%s "
            "bound=%.5f (%s)" % (case, hk, name, row["ms"], row["plain_ms"],
                                 "-" if row["library_ms"] is None else
                                 "%.4f" % row["library_ms"], row["bound_ms"],
                                 row["bound_by"]))
      del out, lse, ro, rl, grads, want, delta
      torch.cuda.empty_cache()
  # a future block's window is the host's launch time (30-80 us a call)
  # and its zero stores; a kernel that visited its tiles would take at
  # least the past block's time
  for name in {r["kernel"] for r in rows}:
    past = pick(rows, kernel=name, case="past")["ms"]
    future = pick(rows, kernel=name, case="future")["ms"]
    if future > RING_FUTURE_SHARE * past:
      raise AssertionError("[6s] ring future block %s: %.4f ms against the "
                           "past block's %.4f: its loop bounds must skip "
                           "every tile" % (name, future, past))
  return rows, worst


def check_tp_widths(ops, torch, F):
  """Rows 9-10 at ``--tp 2``'s local widths, as phase 3 checks the whole
  widths."""
  rows, worst = [], 0.0
  for op, case, n_rows, k, n, dt in TP_FUSED_CASES:
    g = torch.Generator(device="cuda").manual_seed(SEED + 53)
    x = (torch.randn(n_rows, k, device="cuda", generator=g) * 2.0
         + 0.5).to(torch.bfloat16)
    W = (torch.randn(k, n, device="cuda", generator=g) / k ** 0.5).to(
        torch.bfloat16)
    if op == "ln_matmul":
      w = torch.rand(k, device="cuda", generator=g) + 0.5
      fn = lambda: ops.ln_matmul(x, w, W)  # noqa: E731
      plain = lambda: ops.ln_matmul_reference(x, w, W)  # noqa: E731
      wl = w.to(torch.bfloat16)
      lib = lambda: F.layer_norm(x, (k,), wl, None, 1e-6) @ W  # noqa: E731
    else:
      fn = lambda: ops.gelu_matmul(x, W)  # noqa: E731
      plain = lambda: ops.gelu_matmul_reference(x, W)  # noqa: E731
      lib = lambda: F.gelu(x, approximate="tanh") @ W  # noqa: E731
    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if err > 2e-2 * scale or not torch.equal(got, fn()):
      raise AssertionError("[6s] %s %s: err %.3g over 2e-2 x %.3g, or two "
                           "runs differ" % (op, case, err, scale))
    worst = max(worst, err)
    nbytes = (n_rows * k + k * n + n_rows * n) * 2 + (
        k * 4 if op == "ln_matmul" else 0)
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = 2.0 * n_rows * k * n / PEAK_FLOPS["bfloat16"] * 1e3
    row = {"op": op, "case": case, "rows": n_rows, "K": k, "N": n,
           "dtype": dt, "body": _fused_module(op).kernel_body(
               k, n, torch.bfloat16), "max_abs_err": err,
           "ms": time_ms(fn), "plain_ms": time_ms(plain, runs=7),
           "library_ms": time_ms(lib), "bound_ms": max(bound_b, bound_o),
           "bound_by": "bytes" if bound_b >= bound_o else "operations",
           "library": ("F.layer_norm + torch.matmul" if op == "ln_matmul"
                       else "F.gelu + torch.matmul") + " (two calls)"}
    rows.append(row)
    log("  %-11s %-8s %-5s rows=%d K=%d N=%d err=%.3g ms=%.4f plain=%.4f "
        "lib(2 calls)=%.4f bound=%.5f" % (op, case, row["body"], n_rows, k,
                                          n, err, row["ms"], row["plain_ms"],
                                          row["library_ms"], row["bound_ms"]))
  return rows, worst


def _one_process_runs(torch, cases, pattern, memo):
  """Each case's one-process runs (bf16, and f32 at SPMD_F32_FLAGS with
  its weights), in this process, on the batches and weights its ranks
  take; runs of equal flags are made once (``memo``)."""
  out = {}
  for name, _, _, base, bwd, _, want_one, moe in cases:
    argv = _spmd_argv(base, pattern)
    key = (tuple(argv), bwd, json.dumps(moe, sort_keys=True))
    if key not in memo:
      with flash_bwd_env(bwd):
        one, _ = spmd_train(torch, argv, moe=moe)
        one32, w_one = spmd_train(torch, argv + SPMD_F32_FLAGS, f32=True,
                                  weights=True, moe=moe)
      arrays = one32.pop("routes", {})
      routes = (_route_calls(arrays), one32.pop("route_tokens", None),
                _relu_calls(arrays))
      memo[key] = (one, one32, w_one, routes)
    out[name] = memo[key]
    for i, got in enumerate(out[name][0]["launches_per_step"]):
      _per_step_launches(got, 1, want_one, "%s one process step %d"
                         % (name, i))
  return out


def moe_decode(torch, ops, tfm):
  """[6t] (e): t_b_moe_e2's model in f32 on one card decodes
  PPEP_DECODE_PROMPTS prompts of PPEP_DECODE_LEN tokens by
  ``greedy_generate_kv`` with exact launches (one flash prefill, LayerNorm
  25 a forward); each new token is the argmax of the non-cached forward
  of the decoded sequence at its position, but where the top two logits
  lie within 1e-4 (a near-tie)."""
  import numpy as np
  from tensorflowonspark_tpu_torch.utils import params as params_mod
  t0 = time.monotonic()
  cfg = tfm.TransformerConfig(dtype=torch.float32, **PPEP_MOE)
  model = tfm.Transformer(cfg, params_mod.init_params(cfg, SEED))
  setup_s = time.monotonic() - t0
  prompts = np.random.default_rng(SEED + 47).integers(
      1, cfg.vocab_size, (PPEP_DECODE_PROMPTS, PPEP_DECODE_LEN))
  tfm.greedy_generate_kv(model, prompts[:, :8], 2)          # warm-up
  torch.cuda.synchronize()
  before = dict(ops.LAUNCHES)
  t0 = time.monotonic()
  out = tfm.greedy_generate_kv(model, prompts, PPEP_DECODE_NEW)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
  want = dict({k: 0 for k in launches}, flash_attention_fwd=cfg.num_layers,
              layer_norm=(2 * cfg.num_layers + 1) * PPEP_DECODE_NEW)
  if launches != want:
    raise AssertionError("[6t] (e) MoE decode launches %s, want %s"
                         % (launches, want))
  before = dict(ops.LAUNCHES)
  with torch.inference_mode():
    logits = model(out[:, :-1])[:, PPEP_DECODE_LEN - 1:]
  forward = {k: ops.LAUNCHES[k] - before[k] for k in before}
  if forward != dict(want, layer_norm=2 * cfg.num_layers + 1):
    raise AssertionError("[6t] (e) the non-cached forward launched %s"
                         % forward)
  got = out[:, PPEP_DECODE_LEN:]
  ties = []
  for b, t in zip(*torch.nonzero(logits.argmax(-1) != got,
                                 as_tuple=True)):
    top2 = torch.topk(logits[b, t], 2).values
    gap = float(top2[0] - top2[1])
    if gap >= 1e-4:
      raise AssertionError("[6t] (e) row %d token %d: decoded %d, the "
                           "forward's argmax %d (top-2 gap %.3g: not a "
                           "near-tie)" % (b, t, int(got[b, t]), int(
                               logits[b, t].argmax()), gap))
    ties.append({"row": int(b), "token": int(t), "gap": gap})
  res = {"prompts": PPEP_DECODE_PROMPTS, "prompt_len": PPEP_DECODE_LEN,
         "new_tokens": PPEP_DECODE_NEW, "launches": launches,
         "forward_launches": forward, "near_ties": ties,
         "decode_wall_s": wall, "setup_s": setup_s,
         "tokens_per_s": PPEP_DECODE_PROMPTS * PPEP_DECODE_NEW / wall,
         "card": torch.cuda.get_device_name()}
  log("  (e) MoE greedy_generate_kv, f32, 12 layers (6 MoE, 8 experts, "
      "top-2): %d prompts x %d new tokens in %.3f s (%.1f tokens/s); "
      "launches %s; every token the non-cached forward's argmax, %d "
      "near-ties" % (PPEP_DECODE_PROMPTS, PPEP_DECODE_NEW, wall,
                     res["tokens_per_s"], {k: v for k, v in launches.items()
                                           if v}, len(ties)))
  return res


# -- [6v]: checkpoints of cut states, as more jobs of [6s]/[6t]'s groups

#: the cases whose ranks save their state after their bf16 steps
CUT_CKPT_CASES = ("b_tp2_fused", "c_fsdp2", "t_d_moe_e4_a2a")
#: (b): b_tp2_fused's checkpoint restored onto --fsdp 2 by its own ranks
CUT_CKPT_OTHER = {"b_tp2_fused": ["--tp", "1", "--fsdp", "2"]}
CUT_CKPT_EXPORT = "b_tp2_fused"     # (d): exported, decoded on one card
CUT_CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_cut_ckpt")
CUT_DECODE_PROMPTS, CUT_DECODE_LEN, CUT_DECODE_NEW = 4, 128, 16


def _crc(x):
  """crc32 of a tensor's or an array's bytes: bitwise equality across
  processes without moving the tensor."""
  import zlib
  import numpy as np
  import torch
  if torch.is_tensor(x):
    x = x.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy()
  return zlib.crc32(np.ascontiguousarray(x).reshape(-1).view(np.uint8))


def _zero_weights(cfg):
  """Zero weights of ``cfg``'s shapes: a template for a restore, which
  overwrites every one (a restore that did not would train from zeros
  and miss the loss gate)."""
  import numpy as np
  from tensorflowonspark_tpu_torch.utils.params import param_specs
  return {n: np.zeros(shape, "float32")
          for n, (shape, _, _) in param_specs(cfg).items()}


def _cut_restore(torch, args, cfg, mesh, path):
  """A state of zero weights on ``mesh`` (None: one card) with
  ``train_gpt``'s optimizer at ``args``, restored from the checkpoint
  at ``path``; its record (restore seconds, next step)."""
  from tensorflowonspark_tpu_torch import optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils import checkpoint
  tx = optim.make_optimizer(learning_rate=args.lr, clip_norm=1.0,
                            optimizer=args.optimizer,
                            grad_accum_steps=args.grad_accum)
  zeros = _zero_weights(cfg)
  state = tfm.create_sharded_state(cfg, zeros, mesh, tx=tx)[0] \
      if mesh is not None else tfm.create_state(cfg, zeros, tx=tx)
  torch.cuda.synchronize()
  t0 = time.monotonic()
  state, nxt = checkpoint.CheckpointManager(
      path, save_interval_steps=1).restore_or(state)
  torch.cuda.synchronize()
  return state, {"restore_s": time.monotonic() - t0, "next": nxt,
                 "cut": bool(state.sharding is not None
                             and state.sharding.sharded)}


def _cut_step(torch, args, mesh, state, batch, extra):
  """One step of ``state`` on the global ``batch`` (this rank's block of
  it over a mesh): the global batch's loss."""
  import numpy as np
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.parallel import sharding
  step = sharding.make_train_step(train_gpt.make_loss_fn(args), mesh,
                                  state.sharding, batch_extra_axes=extra)
  if mesh is not None:
    batch = sharding.shard_batch(batch, mesh, extra)
  state, loss = step(state, np.asarray(batch, "int32"))
  return float(loss)


def _next_batch(args):
  import itertools
  from tensorflowonspark_tpu_torch.examples import train_gpt
  return next(itertools.islice(train_gpt.batch_stream(args), SPMD_STEPS,
                               None))


def cut_ckpt_rank(torch, name, argv, state, args, cfg, mesh, extra):
  """[6v] on a rank of case ``name``, after its bf16 steps: every rank
  calls ``CheckpointManager.save`` (the ranks gather, rank 0 writes the
  whole state). Then (c) for the expert case this rank's blocks of every
  expert-cut tensor by crc32; else the gathered whole weights by crc32,
  (a) a state of zeros on this mesh restores the checkpoint and takes the
  next step, (b) for ``CUT_CKPT_OTHER`` the same on another mesh, and
  (d) for ``CUT_CKPT_EXPORT`` ``compat.export_model`` on every rank (the
  other rank's throwaway copy removed). Then [6w] on the same ranks
  (:func:`serve_mesh_rank`): the export served on a ``tensor=2`` serving
  mesh in bf16 and f32, the expert case's whole checkpoint on
  SERVE_MESH_MOE in f32."""
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils import checkpoint, compat
  t_enter = time.monotonic()
  path = os.path.join(CUT_CKPT_DIR, name)
  mgr = checkpoint.CheckpointManager(path, save_interval_steps=1)
  torch.cuda.synchronize()
  t0 = time.monotonic()
  if not mgr.save(SPMD_STEPS - 1, state):
    raise AssertionError("[6v] %s rank %d: the save did not fire"
                         % (name, mesh.rank))
  rec = {"save_s": time.monotonic() - t0, "last_save": mgr.last_save,
         "rank": mesh.rank}
  if name.startswith("t_"):
    layout = sharding.state_layout(state)
    rec["coord"] = mesh.coord("expert")
    rec["experts"] = mesh.shape["expert"]
    rec["expert_blocks"] = {
        "/".join(str(k) for k in p): _crc(t)
        for p, t in sharding._state_tensors(state)
        if "expert" in layout[p].spec}
    whole = checkpoint.load_tree(mgr._step_dir(SPMD_STEPS - 1))["params"]
    rec["serve_mesh"] = serve_mesh_rank(torch, name, cfg, whole,
                                        SERVE_MESH_MOE, (torch.float32,))
    del whole
  else:
    rec["gathered_crc"] = {n: _crc(v) for n, v in
                           sharding.gather_state_params(state).items()}
    batch = _next_batch(args)
    own, rec["own"] = _cut_restore(torch, args, cfg, mesh, path)
    rec["own"]["loss"] = _cut_step(torch, args, mesh, own, batch, extra)
    del own
    if name in CUT_CKPT_OTHER:
      oargs = train_gpt.parse_args(list(argv) + CUT_CKPT_OTHER[name])
      omesh = train_gpt.make_mesh(oargs)
      other, rec["other"] = _cut_restore(torch, oargs, cfg, omesh, path)
      rec["other"]["mesh"] = {a: n for a, n in omesh.shape.items() if n > 1}
      rec["other"]["loss"] = _cut_step(torch, oargs, omesh, other, batch,
                                       train_gpt.SEQUENCE_AXES)
      del other
    if name == CUT_CKPT_EXPORT:
      t0 = time.monotonic()
      out = compat.export_model(state, os.path.join(path, "export"),
                                mesh.rank == 0)
      rec["export_s"] = time.monotonic() - t0
      if mesh.rank != 0:
        shutil.rmtree(out, ignore_errors=True)
      torch.distributed.barrier()       # rank 0's export is whole
      whole = compat.import_model(os.path.join(path, "export"))["params"]
      rec["serve_mesh"] = serve_mesh_rank(
          torch, name, cfg, whole, {"data": -1, "tensor": 2},
          (torch.bfloat16, torch.float32))
      del whole
  torch.cuda.empty_cache()
  rec["seconds"] = time.monotonic() - t_enter
  return rec


def _cut_case(name):
  return [c for c in SPMD_CASES + PPEP_CASES if c[0] == name][0]


def _cut_decode(torch, ops, tfm, model, prompts, want_layers):
  """``greedy_generate_kv`` of ``prompts`` x CUT_DECODE_NEW tokens with
  exact launches (one flash prefill a layer, 2L + 1 LayerNorm forwards a
  token); the tokens, the launches and the wall seconds."""
  tfm.greedy_generate_kv(model, prompts[:, :8], 2)          # warm-up
  torch.cuda.synchronize()
  before = dict(ops.LAUNCHES)
  t0 = time.monotonic()
  out = tfm.greedy_generate_kv(model, prompts, CUT_DECODE_NEW)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
  want = dict({k: 0 for k in launches}, flash_attention_fwd=want_layers,
              layer_norm=(2 * want_layers + 1) * CUT_DECODE_NEW)
  if launches != want:
    raise AssertionError("[6v] (d) decode launches %s, want %s"
                         % (launches, want))
  return out, launches, wall


def cut_ckpt_phase(torch, ops, cases, pattern):
  """[6v] in the driver, after the ranks of [6s]/[6t] saved: (a) one
  card restores b_tp2_fused's and c_fsdp2's checkpoints (their weights
  bitwise the ranks' gathered ones) and takes the next step, within
  SPMD_REL of the ranks' own restored step, as (b)'s restore onto
  --fsdp 2 is; (c) one card restores t_d_moe_e4_a2a's and every expert
  weight and moment equals each rank's block bitwise; (d) the export of
  b_tp2_fused's state loads into a one-card serving Transformer, whose
  greedy decode (flash forward and LayerNorm forward, rows 1 and 2)
  equals the one-process model's at the gathered weights, token for
  token. The checkpoints stay for [6w] (:func:`serve_mesh_phase`), which
  removes them."""
  import numpy as np
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils import compat
  t_start = time.monotonic()
  res = {"cases": {}}
  log("[6v] checkpoints of cut states: the ranks' saves restored on one "
      "card and onto another mesh, an expert-cut save, an export decoded "
      "on one card")
  for name in CUT_CKPT_CASES:
    if name not in cases:
      continue
    case = _cut_case(name)
    ranks = [r["cut_ckpt"] for r in cases[name]["per_rank"]]
    args = train_gpt.parse_args(_spmd_argv(case[3], pattern))
    cfg = train_gpt.make_config(args)
    if case[7] is not None:
      cfg = dataclasses.replace(cfg, **case[7][0])
    path = os.path.join(CUT_CKPT_DIR, name)
    one, rec = _cut_restore(torch, args, cfg, None, path)
    rec["ranks"] = ranks
    save = ranks[0]["last_save"]
    if rec["next"] != SPMD_STEPS:
      raise AssertionError("[6v] %s: one card restored next step %d, want "
                           "%d" % (name, rec["next"], SPMD_STEPS))
    if name.startswith("t_"):
      # (c) each rank's blocks of the expert weights and their moments
      from tensorflowonspark_tpu_torch.parallel import sharding
      mine = {"/".join(str(k) for k in p): t
              for p, t in sharding._state_tensors(one)}
      differ = []
      for r in ranks:
        for p, crc in r["expert_blocks"].items():
          per = mine[p].shape[0] // r["experts"]
          if _crc(mine[p].narrow(0, r["coord"] * per, per)) != crc:
            differ.append((r["rank"], p))
      rec["expert_tensors"] = len(ranks[0]["expert_blocks"])
      if differ or not rec["expert_tensors"]:
        raise AssertionError("[6v] (c) %s: blocks differ from the ranks' "
                             "%s (%d tensors)" % (name, differ[:4],
                                                  rec["expert_tensors"]))
      log("  (c) %s: %d expert tensors (weights and moments), each rank's "
          "block equal bitwise in one card's restore; %d bytes, rank 0's "
          "save %.2f s (gather %.2f, host %.2f, write %.2f, commit %.2f); "
          "one card's restore %.2f s" % (
              name, rec["expert_tensors"], save["bytes"], ranks[0]["save_s"],
              save["gather_s"], save["host_s"], save["write_s"],
              save["commit_s"], rec["restore_s"]))
      res["cases"][name] = rec
      del one
      torch.cuda.empty_cache()
      continue
    got = {n: _crc(p) for n, p in one.params.items()}
    if got != ranks[0]["gathered_crc"]:
      raise AssertionError("[6v] (a) %s: the whole weights on disk differ "
                           "from gather_state_params at %s" % (name, sorted(
                               n for n in got
                               if got[n] != ranks[0]["gathered_crc"][n])[:4]))
    ref = tfm.Transformer(cfg, {n: p.detach() for n, p in
                                one.params.items()}) \
        if name == CUT_CKPT_EXPORT else None
    rec["loss"] = _cut_step(torch, args, None, one, _next_batch(args), ())
    del one
    own = [r["own"]["loss"] for r in ranks]
    if len(set(own)) != 1:
      raise AssertionError("[6v] (a) %s: the ranks' restored steps disagree"
                           ": %s" % (name, own))
    rel = abs(rec["loss"] - own[0]) / abs(own[0])
    rec["rel"] = rel
    if rel > SPMD_REL:
      raise AssertionError("[6v] (a) %s: one card's restored step %.6f "
                           "against the ranks' %.6f: %.3g over %g"
                           % (name, rec["loss"], own[0], rel, SPMD_REL))
    log("  (a) %s: %d bytes (%.1f MB); rank 0's save %.2f s (gather %.2f, "
        "host %.2f, write %.2f, commit %.2f); restored next step %d: the "
        "ranks' %.6f (restore %s s), one card's %.6f (restore %.2f s), rel "
        "%.3g (limit %g); weights on disk bitwise the gathered ones" % (
            name, save["bytes"], save["bytes"] / 1e6, ranks[0]["save_s"],
            save["gather_s"], save["host_s"], save["write_s"],
            save["commit_s"], rec["next"], own[0], " / ".join(
                "%.2f" % r["own"]["restore_s"] for r in ranks), rec["loss"],
            rec["restore_s"], rel, SPMD_REL))
    if "other" in ranks[0]:
      other = [r["other"]["loss"] for r in ranks]
      orel = abs(other[0] - own[0]) / abs(own[0])
      rec["other_rel"] = orel
      if len(set(other)) != 1 or orel > SPMD_REL or \
          not ranks[0]["other"]["cut"]:
        raise AssertionError("[6v] (b) %s onto %s: %s against %.6f"
                             % (name, ranks[0]["other"]["mesh"], other,
                                own[0]))
      log("  (b) %s restored onto %s by its ranks: %.6f, rel %.3g (limit "
          "%g), restore %s s" % (name, ranks[0]["other"]["mesh"], other[0],
                                 orel, SPMD_REL, " / ".join(
                                     "%.2f" % r["other"]["restore_s"]
                                     for r in ranks)))
    if ref is not None:
      # (d) the export, decoded on one card
      t0 = time.monotonic()
      tree = compat.import_model(os.path.join(path, "export"))
      rec["import_s"] = time.monotonic() - t0
      crc = {n: _crc(t) for n, t in tree["params"].items()}
      if crc != ranks[0]["gathered_crc"]:
        raise AssertionError("[6v] (d) %s: the export's weights differ from "
                             "the gathered ones" % name)
      served = tfm.Transformer(cfg, tree["params"])
      del tree
      prompts = np.random.default_rng(SEED + 53).integers(
          1, cfg.vocab_size, (CUT_DECODE_PROMPTS, CUT_DECODE_LEN))
      got, launches, wall = _cut_decode(torch, ops, tfm, served, prompts,
                                        cfg.num_layers)
      want, _, _ = _cut_decode(torch, ops, tfm, ref, prompts,
                               cfg.num_layers)
      del served, ref
      if not torch.equal(got, want):
        raise AssertionError("[6v] (d) %s: the export's decode differs from "
                             "the gathered weights' at %d tokens"
                             % (name, int((got != want).sum())))
      res["decode"] = {"launches": launches, "wall_s": wall,
                       "tokens_per_s": CUT_DECODE_PROMPTS * CUT_DECODE_NEW
                                       / wall}

      log("  (d) %s: export on both ranks %s s, import %.2f s; %d prompts "
          "x %d new tokens on one card equal to the gathered weights' "
          "model, %.1f tokens/s, launches %s" % (
              name, " / ".join("%.2f" % r["export_s"] for r in ranks),
              rec["import_s"], CUT_DECODE_PROMPTS, CUT_DECODE_NEW,
              res["decode"]["tokens_per_s"],
              {k: v for k, v in launches.items() if v}))
    res["cases"][name] = rec
    torch.cuda.empty_cache()
  res["driver_s"] = time.monotonic() - t_start
  res["ranks_s"] = {n: max(r["seconds"] for r in c["ranks"])
                    for n, c in res["cases"].items()}
  res["seconds"] = res["driver_s"] + sum(res["ranks_s"].values())
  log("  [6v] %.1f s: the driver %.1f s, the ranks' jobs %s s" % (
      res["seconds"], res["driver_s"], " / ".join(
          "%s %.1f" % kv for kv in res["ranks_s"].items())))
  return res


# -- [6w]: serving over a mesh, as more work of [6v]'s ranks -----------------

#: (a): the ranks' first-step logits against one card's, of max |logit|;
#: tokens equal up to a first position whose one-card top-2 gap is under
#: this bound times that row's max |logit|
SERVE_MESH_REL = 3e-2
NEAR_TIE_F32 = 1e-4                # (b), (c): [5]'s f32 rule
#: (c): the MoE checkpoint's serving mesh
SERVE_MESH_MOE = {"data": 2, "expert": 2}
SERVE_MESH_LABEL = "gloo over host, ranks sharing one card"
#: (d): serve_gpt's flags, --tensor 1 and 2 on the card
SERVE_GPT_FLAGS = ["--prompts", "32", "--steps", "8"]


def _cut_prompts(vocab):
  """[6v](d)'s prompts: 4 x 128 tokens."""
  import numpy as np
  return np.random.default_rng(SEED + 53).integers(
      1, vocab, (CUT_DECODE_PROMPTS, CUT_DECODE_LEN))


def _first_logits(torch, tfm, model, prompts):
  """The whole batch's logits after the prompt (a fresh-cache prefill),
  whole over the vocabulary, f32 on the host; over a mesh every rank's
  rows gathered."""
  with torch.inference_mode():
    mine = tfm._my_rows(torch.as_tensor(prompts).long().to(model.device),
                        model.mesh)
    logits = model.whole_logits(model(mine, model.init_cache(
        mine.shape[0]))[:, -1])
    return tfm._all_rows(logits, model.mesh, len(prompts)).float().cpu()


def serve_mesh_rank(torch, tag, cfg, params, degrees, dtypes):
  """[6w] on a rank of [6v]'s case: ``params`` (whole weights) cut onto
  a serving mesh of ``degrees`` (every rank of the group builds it),
  then for each dtype in ``dtypes`` ``greedy_generate_kv`` of [6v](d)'s
  prompts x CUT_DECODE_NEW tokens after a short warm-up: the tokens (and
  a crc of them, to hold the ranks to each other), this rank's launches
  zeroed just before and read just after, the wall seconds, and on rank
  0 the first-step logits to ``<CUT_CKPT_DIR>/<tag>_<dtype>.pt``."""
  from tensorflowonspark_tpu_torch import ops
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib
  t0 = time.monotonic()
  mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**degrees))
  prompts = _cut_prompts(cfg.vocab_size)
  rec = {"mesh": {a: n for a, n in mesh.shape.items() if n > 1},
         "rank": mesh.rank, "by_dtype": {}}
  for dtype in dtypes:
    name = str(dtype).replace("torch.", "")
    model = tfm.Transformer(dataclasses.replace(cfg, dtype=dtype), params,
                            mesh=mesh)
    tfm.greedy_generate_kv(model, prompts[:, :8], 2)         # warm-up
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    t1 = time.monotonic()
    out = tfm.greedy_generate_kv(model, prompts, CUT_DECODE_NEW)
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    first = _first_logits(torch, tfm, model, prompts)
    if mesh.rank == 0:
      torch.save(first, os.path.join(CUT_CKPT_DIR, "%s_%s.pt" % (tag, name)))
    rec["by_dtype"][name] = {
        "tokens": out.cpu().tolist(), "crc": _crc(out), "wall_s": wall,
        "launches": launches, "kv_heads": model.plan.local_kv_heads(),
        "tokens_per_s": CUT_DECODE_PROMPTS * CUT_DECODE_NEW / wall}
    del model
  torch.cuda.empty_cache()
  rec["seconds"] = time.monotonic() - t0
  return rec


def _decode_gaps(torch, tfm, model, prompts):
  """One card's greedy decode of ``prompts`` x CUT_DECODE_NEW tokens,
  the ops of ``greedy_generate_kv`` step by step, keeping each position's
  top-2 logit gap and its row's max |logit|: (tokens [B, plen + new],
  gaps [B, new], scale [B, new], first-step logits)."""
  with torch.inference_mode():
    tok = torch.as_tensor(prompts).long().cuda()
    cache = model.init_cache(tok.shape[0])
    logits = model(tok, cache)[:, -1].float()
    first = logits.cpu()
    out, gaps, scale = [], [], []
    for i in range(CUT_DECODE_NEW):
      top = torch.topk(logits, 2, dim=-1).values
      gaps.append((top[:, 0] - top[:, 1]).cpu())
      scale.append(logits.abs().amax(dim=-1).cpu())
      nxt = logits.argmax(dim=-1)
      out.append(nxt)
      if i + 1 < CUT_DECODE_NEW:
        logits = model(nxt[:, None], cache)[:, -1].float()
    gen = torch.stack(out, dim=1)
    return (torch.cat([tok, gen], dim=1).cpu(), torch.stack(gaps, dim=1),
            torch.stack(scale, dim=1), first)


def _tie_gate(what, got, want, gaps, bound):
  """Tokens ``got`` equal ``want`` in each row up to its first position
  where one card's top-2 gap is under ``bound`` (a [B, new] tensor or a
  number); after it they may part. Returns (positions under the bound,
  rows that parted after one)."""
  import torch
  plen = want.shape[1] - gaps.shape[1]
  near = gaps < bound
  parted = 0
  for r in range(want.shape[0]):
    diff = (got[r, plen:] != want[r, plen:]).nonzero()
    if not len(diff):
      continue
    first = int(diff[0])
    ties = near[r].nonzero()
    if not len(ties) or int(ties[0]) > first:
      raise AssertionError(
          "%s row %d: token %d differs from one card's (%d against %d) with "
          "no near-tie at or before it (gap %.3g, bound %.3g)" % (
              what, r, first, int(got[r, plen + first]),
              int(want[r, plen + first]), float(gaps[r, first]),
              float(bound if not torch.is_tensor(bound)
                    else bound[r, first])))
    parted += 1
  return int(near.sum()), parted


def _check_launches(what, ranks, want):
  for r in ranks:
    got = {k: v for k, v in r["launches"].items() if v}
    if got != want:
      raise AssertionError("[6w] %s rank %d launches %s, want %s"
                           % (what, r["rank"], got, want))


def serve_mesh_gates(torch, ops, tfm, name, cfg, ranks, one_params):
  """[6w] in the driver, after [6v]'s ranks served their case over a
  mesh (``ranks``: each rank's :func:`serve_mesh_rank` record): every
  rank's tokens the same, each rank's launches exactly one card's (one
  flash prefill a layer, 2L + 1 LayerNorm forwards a token), and against
  one card's decode of the same weights (``one_params``): (a) bf16 first
  logits within SERVE_MESH_REL of max |logit| and tokens equal up to a
  near-tie under that bound, (b)/(c) f32 tokens equal up to a near-tie
  under NEAR_TIE_F32. Returns the phase's record."""
  layers = cfg.num_layers
  want_l = {"flash_attention_fwd": layers,
            "layer_norm": (2 * layers + 1) * CUT_DECODE_NEW}
  prompts = _cut_prompts(cfg.vocab_size)
  res = {"mesh": ranks[0]["mesh"], "ranks_s": [r["seconds"] for r in ranks],
         "by_dtype": {}}
  for dname in ranks[0]["by_dtype"]:
    per = [dict(r["by_dtype"][dname], rank=r["rank"]) for r in ranks]
    if len({p["crc"] for p in per}) != 1:
      raise AssertionError("[6w] %s %s: the ranks' tokens differ"
                           % (name, dname))
    _check_launches("%s %s" % (name, dname), per, want_l)
    dtype = getattr(torch, dname)
    one = tfm.Transformer(dataclasses.replace(cfg, dtype=dtype), one_params)
    want, gaps, scale, first = _decode_gaps(torch, tfm, one, prompts)
    check = tfm.greedy_generate_kv(one, prompts, CUT_DECODE_NEW).cpu()
    del one
    if not torch.equal(check, want):
      raise AssertionError("[6w] %s %s: the step-by-step decode is not "
                           "greedy_generate_kv's" % (name, dname))
    got = torch.as_tensor(per[0]["tokens"])
    rec = {"tokens_per_s": [p["tokens_per_s"] for p in per],
           "wall_s": [p["wall_s"] for p in per],
           "launches": per[0]["launches"],
           "kv_heads": per[0]["kv_heads"],
           "tokens_equal": bool(torch.equal(got, want))}
    if dtype == torch.bfloat16:
      ranks_first = torch.load(os.path.join(
          CUT_CKPT_DIR, "%s_%s.pt" % (name, dname)))
      err = float((ranks_first - first).abs().max())
      rel = err / float(first.abs().max())
      rec.update(first_logits_max_abs=err, first_logits_rel=rel)
      if rel > SERVE_MESH_REL:
        raise AssertionError("[6w] (a) %s: first-step logits off by %.3g of "
                             "max |logit| (limit %g)"
                             % (name, rel, SERVE_MESH_REL))
      bound = SERVE_MESH_REL * scale
    else:
      bound = NEAR_TIE_F32
    rec["near_ties"], rec["rows_parted"] = _tie_gate(
        "[6w] %s %s" % (name, dname), got, want, gaps, bound)
    rec["min_gap"] = float(gaps.min())
    res["by_dtype"][dname] = rec
    torch.cuda.empty_cache()
  return res


def _descendants(pid):
  """{pid: (ppid, cmdline)} of every process whose parent chain reaches
  ``pid``."""
  procs = {}
  for d in os.listdir("/proc"):
    if not d.isdigit():
      continue
    try:
      with open("/proc/%s/stat" % d) as f:
        ppid = int(f.read().rsplit(")", 1)[1].split()[1])
      with open("/proc/%s/cmdline" % d, "rb") as f:
        cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
    except (OSError, ValueError, IndexError):
      continue
    procs[int(d)] = (ppid, cmd)
  out, frontier = {}, {pid}
  while frontier:
    kids = {p for p, (pp, _) in procs.items() if pp in frontier}
    kids -= set(out)
    for k in kids:
      out[k] = procs[k]
    frontier = kids
  return out


def _alive(pid):
  try:
    with open("/proc/%d/stat" % pid) as f:
      return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
  except OSError:
    return False


def serve_gpt_mesh(torch):
  """[6w](d): ``serve_gpt --tensor 1`` then ``--tensor 2`` on the card
  (2 executors; with --tensor 2 each serves over its own serving group
  of 2 ranks sharing the card over gloo): the served rows equal, every
  rank 1 seen while the bundle served (processes this process's
  executors spawned) gone once the engine stopped."""
  import threading
  from tensorflowonspark_tpu_torch.examples import serve_gpt
  res = {}
  outdir = os.path.join(HERE, "build", "chip_smoke_serve_gpt_mesh")
  shutil.rmtree(outdir, ignore_errors=True)
  rows = {}
  for n in (1, 2):
    seen, stop = set(), threading.Event()

    def watch():
      while not stop.is_set():
        for pid, (ppid, cmd) in _descendants(os.getpid()).items():
          if ppid != os.getpid() and "spawn_main" in cmd:
            seen.add(pid)
        stop.wait(0.2)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    t0 = time.monotonic()
    try:
      rows[n] = serve_gpt.run(serve_gpt.parse_args(
          SERVE_GPT_FLAGS + ["--tensor", str(n), "--export_dir",
                             os.path.join(outdir, "t%d" % n)]))
    finally:
      stop.set()
      watcher.join()
    res["tensor_%d_s" % n] = time.monotonic() - t0
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in seen) and time.monotonic() < deadline:
      time.sleep(0.2)
    res["tensor_%d_followers_seen" % n] = len(seen)
    left = [p for p in seen if _alive(p)]
    if left:
      raise AssertionError("[6w] (d) --tensor %d: followers %s still alive "
                           "30 s after the engine stopped" % (n, left))
  if res["tensor_2_followers_seen"] < 2 or res["tensor_1_followers_seen"]:
    raise AssertionError("[6w] (d) followers seen: %d with --tensor 1, %d "
                         "with --tensor 2 (want 0 and one an executor)"
                         % (res["tensor_1_followers_seen"],
                            res["tensor_2_followers_seen"]))
  if sorted(rows[1]) != sorted(rows[2]):
    differ = sum(a != b for a, b in zip(sorted(rows[1]), sorted(rows[2])))
    raise AssertionError("[6w] (d) serve_gpt --tensor 2 served %d rows "
                         "other than --tensor 1's" % differ)
  res["rows"] = len(rows[2])
  shutil.rmtree(outdir, ignore_errors=True)
  return res


def serve_mesh_phase(torch, ops, cases, pattern):
  """[6w] in the driver, after [6v]: the gates of the ranks' serving over
  a mesh (:func:`serve_mesh_gates`) against one card's decode of the
  same weights (b_tp2_fused's export; t_d_moe_e4_a2a's whole checkpoint),
  then (d) serve_gpt over each executor's serving group
  (:func:`serve_gpt_mesh`). Removes [6v]'s checkpoints."""
  from tensorflowonspark_tpu_torch.examples import train_gpt
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.utils import checkpoint, compat
  t_start = time.monotonic()
  log("[6w] serving over a mesh: [6v]'s export on tensor=2 (bf16, f32) "
      "and its MoE checkpoint on data=2 x expert=2 (f32) by the ranks, "
      "against one card; serve_gpt --tensor 2 (%s)" % SERVE_MESH_LABEL)
  res = {}
  try:
    for name in (CUT_CKPT_EXPORT, "t_d_moe_e4_a2a"):
      if name not in cases:
        continue
      case = _cut_case(name)
      args = train_gpt.parse_args(_spmd_argv(case[3], pattern))
      cfg = train_gpt.make_config(args)
      if case[7] is not None:
        cfg = dataclasses.replace(cfg, **case[7][0])
      path = os.path.join(CUT_CKPT_DIR, name)
      if name == CUT_CKPT_EXPORT:
        params = compat.import_model(os.path.join(path, "export"))["params"]
      else:
        params = checkpoint.load_tree(os.path.join(
            path, str(SPMD_STEPS - 1)))["params"]
      t0 = time.monotonic()
      res[name] = serve_mesh_gates(
          torch, ops, tfm, name, cfg,
          [r["cut_ckpt"]["serve_mesh"] for r in cases[name]["per_rank"]],
          params)
      res[name]["driver_s"] = time.monotonic() - t0
      del params
      torch.cuda.empty_cache()
  finally:
    shutil.rmtree(CUT_CKPT_DIR, ignore_errors=True)
  res["serve_gpt"] = serve_gpt_mesh(torch)
  serve_mesh_summary(res)
  res["driver_s"] = time.monotonic() - t_start
  res["ranks_s"] = {n: max(res[n]["ranks_s"]) for n in
                    (CUT_CKPT_EXPORT, "t_d_moe_e4_a2a") if n in res}
  log("  [6w] %.1f s in the driver, the ranks' serving %s s" % (
      res["driver_s"], " / ".join("%s %.1f" % kv
                                  for kv in res["ranks_s"].items())))
  return res


def serve_mesh_summary(res):
  """[6w]'s record, logged."""
  for case in ("b_tp2_fused", "t_d_moe_e4_a2a"):
    if case not in res:
      continue
    c = res[case]
    for dname, r in c["by_dtype"].items():
      log("  %s %s on %s (%s): tokens equal to one card's: %s (near-ties "
          "under the bound %d, rows parted after one %d, smallest top-2 "
          "gap %.3g)%s; launches a rank %s; %s tokens/s (ranks; not a "
          "multi-card speed); the ranks' serving s %s" % (
              case, dname, c["mesh"], SERVE_MESH_LABEL, r["tokens_equal"],
              r["near_ties"], r["rows_parted"], r["min_gap"],
              "; first logits within %.3g of max |logit| (limit %g)" % (
                  r["first_logits_rel"], SERVE_MESH_REL)
              if "first_logits_rel" in r else "",
              {k: v for k, v in r["launches"].items() if v},
              " / ".join("%.1f" % x for x in r["tokens_per_s"]),
              " / ".join("%.1f" % x for x in c["ranks_s"])))
  d = res["serve_gpt"]
  log("  (d) serve_gpt --tensor 2: %d rows equal to --tensor 1's; %d "
      "followers seen, all gone after the engine stopped; %.1f s against "
      "%.1f s" % (d["rows"], d["tensor_2_followers_seen"], d["tensor_2_s"],
                  d["tensor_1_s"]))


def spmd_phase(torch, ops, F, pattern, spmd=True, ppep=True, drawn=(),
               only=None):
  """[6s] and [6t]: with ``spmd``, the kernels at the ring's block cases
  and at --tp 2's widths; then train_gpt over the mesh axes in ranks
  sharing the card over gloo, each case against one process on the same
  batches and weights: [6s] (a) --sp 2 on [6d]'s long context (split
  backward), (b) --tp 2 --fused, (c) --fsdp 2 at [6]'s shape, 12 layers,
  on 2 ranks; (d) --sp 2 --tp 2 at 2 layers on 4 ranks; with ``ppep``,
  [6t]'s PPEP_CASES in the same groups and the MoE decode (e). The
  groups are spawned once the kernel timings are done: their ranks'
  imports, warm-up and seeded weights overlap the one-process runs.
  Then [6v] (:func:`cut_ckpt_phase`) on the checkpoints of
  CUT_CKPT_CASES, and [6w] (:func:`serve_mesh_phase`) on what their ranks
  served over a mesh, with its serve_gpt leg.
  ``drawn``: seeded weights this process drew already
  (:func:`_weight_memo`). ``only``: the names of the cases to run, without
  the kernel cases or the MoE decode."""
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  t_start = time.monotonic()
  res = {"cases": {}, "groups_s": {}, "max_abs_err": 0.0,
         "ring_blocks": [], "tp_widths": []}
  shutil.rmtree(CUT_CKPT_DIR, ignore_errors=True)
  if spmd and only is None:
    log("[6s] the flash kernels at the ring's block cases (q [1, %d, %d, "
        "%d] against %d keys; lse cotangent on every row)"
        % (RING_S, RING_H, RING_D, RING_S))
    res["ring_blocks"], ring_err = check_ring_blocks(ops, torch, F)
    log("[6s] LN->matmul and GELU->matmul at --tp 2's local widths")
    res["tp_widths"], tp_err = check_tp_widths(ops, torch, F)
    res["max_abs_err"] = max(ring_err, tp_err)
    torch.cuda.empty_cache()
  cases = tuple(c for c in (SPMD_CASES if spmd else ()) +
                (PPEP_CASES if ppep else ()) if only is None or c[0] in only)
  groups = [_spmd_spawn(world, [
      {"name": name, "argv": _spmd_argv(base, pattern) + flags, "bwd": bwd,
       "moe": moe}
      for name, ranks, flags, base, bwd, _, _, moe in cases
      if ranks == world]) for world in (2, 4)]
  try:
    memo, one = {}, {}
    t0 = time.monotonic()
    with _weight_memo(drawn):
      if spmd:
        log("[6s] the one-process runs of the mesh-axes cases")
        one.update(_one_process_runs(torch, [c for c in SPMD_CASES
                                             if c in cases], pattern, memo))
      res["one_process_s"] = time.monotonic() - t0
      if ppep:
        t1 = time.monotonic()
        log("[6t] the one-process runs of the pipeline and expert cases, "
            "and the MoE decode")
        one.update(_one_process_runs(torch, [c for c in PPEP_CASES
                                             if c in cases], pattern, memo))
        res["ppep_one_process_s"] = time.monotonic() - t1
        if only is None:
          res["moe_decode"] = moe_decode(torch, ops, tfm)
    torch.cuda.empty_cache()
    res.update(_spmd_cases(groups, cases, one))
    if any(c[0] in CUT_CKPT_CASES for c in cases):
      res["cut_ckpt"] = cut_ckpt_phase(torch, ops, res["cases"], pattern)
      res["serve_mesh"] = serve_mesh_phase(torch, ops, res["cases"], pattern)
  finally:
    for group in groups:
      _spmd_stop(group)
  res["seconds"] = time.monotonic() - t_start
  log("  [6s/6t] %.1f s (before the ranks %.1f s, ranks %s s; rank 0's "
      "seconds by job %s; ranks' warm-up and weights while they waited %s "
      "s)" % (res["seconds"], res["seconds"] - sum(
          res["groups_s"].values()), " / ".join(
              "%.1f" % s for s in res["groups_s"].values()), " ".join(
                  "%s %.1f" % kv for kv in res["jobs_s"].items()), " / ".join(
                      "%.1f" % max(w) for w in res["warm_s"].values())))
  return res


def _spmd_cases(groups, cases, one):
  """Each group of ranks in turn, its cases gated against the one
  process's runs; the summaries, each group's seconds and its ranks'
  warm-up seconds."""
  res = {"cases": {}, "groups_s": {}, "warm_s": {}, "jobs_s": {}}
  failed = []
  for group in groups:
    world = group["world"]
    log("[6st] %s in %d ranks: %s" % (", ".join(
        j["name"] for j in group["jobs"]), world, SPMD_LABEL))
    ranks, weights, seconds = _spmd_go(group)
    res["groups_s"][world] = seconds
    res["warm_s"][world] = [r["warm_s"] for r in ranks]
    for case in cases:
      name = case[0]
      if case[1] != world:
        continue
      # rank 0's seconds in the job: its bf16 and f32 runs
      res["jobs_s"][name] = ranks[0][name]["run_s"] + \
          ranks[0][name + "_f32"]["run_s"]
      one_p, one32, w_one, one_routes = one[name]
      try:
        summary = _spmd_gates(case, ranks, one_p, one32, weights[name],
                              w_one)
      except AssertionError as e:
        # every group and case still runs: the phase fails at its end
        log("  %s FAILED: %s" % (name, e))
        failed.append(str(e))
        continue
      summary["per_rank"] = [r[name] for r in ranks]
      if case[7] is not None:
        summary["routing"] = route_diff(
            [r["_routes"].get(name, []) for r in ranks], one_routes[0],
            one_routes[1], case[7][1])
        summary["relu"] = relu_diff(
            [r["_relu"].get(name, {}) for r in ranks], one_routes[2],
            one_routes[1], case[7][0]["moe_experts"] // case[7][1])
        _log_routing(name, summary["routing"], summary["relu"])
      res["cases"][name] = summary
      log("  %s: losses %s; one process %s; max rel %.3g (limit %g); f32 "
          "%d layers, SGD: max rel %.3g, first gradients within %.3g of "
          "their largest (limit %g), gathered weights within %.3g (limit "
          "%g), updates (largest |update| a tensor %.3g to %.3g) within %.3g "
          "of their largest, %.3g of their limit (%g of the largest plus 4 "
          "ulp of the weight)"
          % (name, " ".join("%.5f" % x for x in summary["losses"]),
             " ".join("%.5f" % x for x in summary["one_process"]),
             summary["max_rel"], SPMD_REL, SPMD_F32_LAYERS,
             summary["f32_max_rel"], summary["f32_max_rel_grad"],
             SPMD_GRAD_REL, summary["f32_max_abs_weight"], SPMD_F32_TOL,
             summary["f32_update_max_abs"][0],
             summary["f32_update_max_abs"][1],
             summary["f32_max_rel_update"],
             summary["f32_update_gap_over_limit"], SPMD_UPDATE_REL))
      if summary["f32_update_gate"] == "first step":
        log("    MoE: the update gate holds the first step's; the 3-step "
            "update within %.3g of one process's (limit %g)"
            % (summary["f32_moe_3_step_update_max_abs_gap"], SPMD_F32_TOL))
      log("    ms a step by rank %s (one process %.1f); profiled step wall "
          "%s, device busy %s ms; peak memory %s GiB (one process %.2f); "
          "weights + optimizer bytes %s (one process %d)" % (
              " ".join("%.1f" % x for x in summary["ms_per_step"]),
              summary["one_ms_per_step"],
              " ".join("%.1f" % x for x in summary["profiled_wall_ms"]),
              " ".join("%.1f" % x for x in summary["device_busy_ms"]),
              " ".join("%.2f" % x for x in summary["peak_mem_gib"]),
              summary["one_peak_mem_gib"],
              " ".join(str(x) for x in summary["state_bytes"]),
              summary["one_state_bytes"]))
      for r, (lc, cc, ec) in enumerate(zip(
          summary["launches_per_step"], summary["collectives_per_step"],
          summary["edge_calls_per_step"])):
        log("    rank %d a step: launches %s; collectives %s; embedding / "
            "loss calls %d / %d" % (
                r, {k: v for k, v in lc.items() if v},
                {k: v for k, v in cc.items() if v}, ec["embed"],
                ec["loss"]))
      log("    seconds (setup / whole run): rank 0 bf16 %.1f / %.1f, f32 "
          "%.1f / %.1f; one process bf16 %.1f / %.1f, f32 %.1f / %.1f" % (
              *summary["seconds"]["rank0"][0], *summary["seconds"]["rank0"][1],
              *summary["seconds"]["one_process"][0],
              *summary["seconds"]["one_process"][1]))
  if failed:
    raise AssertionError("[6s/6t] %d case(s) failed: %s"
                         % (len(failed), " | ".join(failed)))
  return res


def _log_routing(name, rd, relu):
  """[6t]'s routing check of an f32 MoE case, logged step by step."""
  for step, st in sorted(rd["steps"].items()):
    log("    routing, ranks against one process, step %d: %d of the "
        "tokens' top-2 sets differ (%d calls compared); smallest top-2 "
        "to 3rd gap of any token %.3g; largest gap of a differing token "
        "%.3g" % (int(step) + 1, st["tokens_differ"], st["calls_compared"],
                  st["smallest_gap_one"], st["max_gap_of_differing"]))
    for d in st["differ"][:4]:
      log("      rank %d token %d (id %d, target %s): experts %s on the "
          "ranks, %s in one process; gaps %.3g / %.3g"
          % (d["rank"], d["token"], d["id"], d["target"],
             d["experts_ranks"], d["experts_one"], d["gap_ranks"],
             d["gap_one"]))
  for step, st in sorted(relu.items()):
    if st is None:
      continue
    log("    expert pre-ReLU signs, ranks against one process, step %d: %d "
        "flipped (%d entries of one process within %g of zero); expert 7 "
        "unit 2913: %s" % (int(step) + 1, st["flips"], st["near_zero_one"],
                           RELU_NEAR, st["watched"] or "none"))
    for d in st["first"][:6]:
      log("      expert %d token %d (id %d) unit %d: pre-ReLU %s on the "
          "ranks, %s in one process" % (d["expert"], d["token"], d["id"],
                                        d["unit"], d["pre_ranks"],
                                        d["pre_one"]))
  first = rd["first"]
  log("    routing first differs: %s" % (
      "nowhere in steps 1-3" if first is None else
      "step %d, token %d (id %d, target %s), experts %s against %s, gap "
      "%.3g / %.3g" % (first["step"] + 1, first["token"], first["id"],
                       first["target"], first["experts_ranks"],
                       first["experts_one"], first["gap_ranks"],
                       first["gap_one"])))


def spmd_launches(res, name):
  """[6s]'s and [6t]'s launches of kernel ``name`` on rank 0 of each
  case (a pipeline's stage 0), in [6t]'s MoE decode, in [6v]'s decode
  of an export and in [6w]'s decodes over a mesh (each rank's)."""
  out = {"%s_%s_rank0_%d_steps" % ("ppep" if case.startswith("t_")
                                   else "spmd", case, SPMD_STEPS): int(sum(
      step[name] for step in res["cases"][case]["per_rank"][0][
          "launches_per_step"])) for case in res["cases"]}
  if "moe_decode" in res:
    out["ppep_moe_decode_%dx%d" % (PPEP_DECODE_PROMPTS, PPEP_DECODE_NEW)] = \
        res["moe_decode"]["launches"][name]
  if "decode" in res.get("cut_ckpt", {}):
    out["cut_ckpt_export_decode_%dx%d" % (CUT_DECODE_PROMPTS,
                                          CUT_DECODE_NEW)] = \
        res["cut_ckpt"]["decode"]["launches"][name]
  for case in (CUT_CKPT_EXPORT, "t_d_moe_e4_a2a"):
    for dname, r in res.get("serve_mesh", {}).get(case, {}).get(
        "by_dtype", {}).items():
      out["serve_mesh_%s_%s_%dx%d_a_rank" % (
          case, dname, CUT_DECODE_PROMPTS, CUT_DECODE_NEW)] = \
          r["launches"][name]
  return out


def spmd_kernel_rows(res, name):
  """The ring block rows of kernel ``name``, for the kernels line."""
  return [{k: r[k] for k in ("case", "Hk", "q_base", "kv_base", "ms",
                             "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}
          for r in res["ring_blocks"] if r["kernel"] == name]


def spmd_only(torch, ops, F, _build, card, spmd=True, only=None,
              tag=None):
  """``--spmd-only``: phase 2's build, [6d]'s TFRecords, then [6s];
  ``--pp-ep-only`` (``spmd`` False): the build, then [6t];
  ``--cut-ckpt-only`` (``only``: CUT_CKPT_CASES): the build, those
  cases of [6s]/[6t], [6v] and [6w]; ``--serving-mesh-only`` (``only``:
  the two cases [6w] serves from): the same for those. [6v] and [6w]
  follow whichever of their cases ran."""
  log("[2] build")
  build_s = _build.build_all()
  log("  built %s" % ", ".join("%s %.1fs" % kv for kv in build_s.items()))
  pattern = write_token_files(os.path.join(
      HERE, "build", "chip_smoke_tokens"), 32000, LONG_S) \
      if spmd and only is None else None
  res = spmd_phase(torch, ops, F, pattern, spmd=spmd,
                   ppep=not spmd or only is not None, only=only)
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out", "chip_smoke_%s.json" % (
      tag or ("cut_ckpt" if only else "spmd" if spmd else "pp_ep"))),
            "w") as f:
    json.dump({"spmd": res, "card": card}, f, indent=1)
  log(card)
  log(json.dumps({"spmd": {
      case: {k: v for k, v in s.items() if k != "per_rank"}
      for case, s in res["cases"].items()}, "seconds": res["seconds"],
      "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


# -- phase 6u: elastic multi-group training --------------------------------------

GROUPS_FULL_STEPS = 4
# (b)-(f): the widest Transformer whose packed f32 weights fit one
# rendezvous frame (4 MiB): 656,000 weights, 2,624,000 bytes
GROUPS_SMALL = dict(vocab_size=2048, d_model=128, num_heads=2, d_ff=512,
                    num_layers=2, max_seq_len=256)
GROUPS_B, GROUPS_S = 8, 256
GROUPS_SYNC_EVERY = 4
GROUPS_SYNC_STEPS = 16
GROUPS_OVERHEAD_REPS = 2            # (b): paired sync-on / sync-off runs
GROUPS_KILL, GROUPS_STALL = "kill@1#2", "stall@1#1:2.0"
GROUPS_KILL_STEPS, GROUPS_STALL_STEPS = 24, 8
GROUPS_EXEC_STEPS = 12              # (f): each executor's steps
GROUPS_EXEC_KILL = "group-step@1#6"  # executor 1, mid round 2
GROUPS_EXEC_SYNC_TIMEOUT = "10"
GROUPS_LR = 3e-3


GROUPS_BATCHES = 4                  # distinct batches a group cycles through


def _groups_batch_fn(vocab, batch, seq):
  """``batch_fn(group_id, step)``: seeded tokens keyed by both, each
  group cycling through GROUPS_BATCHES batches (which it learns: the
  loss falls)."""
  import numpy as np

  def batch_fn(gid, step):
    return np.random.RandomState(
        SEED + 1000 * gid + step % GROUPS_BATCHES).randint(
            0, vocab, (batch, seq)).astype("int32")

  return batch_fn


def _groups_build_fn(tfm, optim, cfg, params):
  """``build_fn(device)``: ``cfg``'s state from ``params`` (a seed or a
  weight dict) with clipped AdamW, and the LM loss."""

  def build_fn(device):
    state = tfm.create_state(cfg, params, device=device,
                             tx=optim.make_optimizer(learning_rate=GROUPS_LR,
                                                     clip_norm=1.0))
    return state, _lm_loss(tfm)

  return build_fn


def _groups_small_cfg(tfm, torch):
  return tfm.TransformerConfig(dtype=torch.bfloat16, **GROUPS_SMALL)


def _sync_log(G, gs):
  """Each group's ``sync`` calls recorded: (group, round, weight, the
  packed weights before and after the merge, the members)."""
  calls = []
  for g in gs.groups.values():
    orig = g.sync.sync

    def logged(rnd, tree, weight=1.0, step=0, timeout=60.0, _o=orig,
               _g=g.group_id, **kw):
      pre = G.pack_tree(tree)
      out = _o(rnd, tree, weight=weight, step=step, timeout=timeout, **kw)
      calls.append((_g, rnd, weight, pre, G.pack_tree(tree), out[1]))
      return out

    g.sync.sync = logged
  return calls


def _check_rounds(calls, rounds, what):
  """(b)'s gate: after each round both groups hold the same bits, and
  those are the f64 weighted mean of the two pre-sync weights, cast to
  each leaf's dtype, recomputed here."""
  import numpy as np
  by_round = {}
  for gid, rnd, weight, pre, post, members in calls:
    by_round.setdefault(rnd, {})[gid] = (weight, pre, post, members)
  if sorted(by_round) != list(range(1, rounds + 1)):
    raise AssertionError("%s: rounds %s, want 1..%d" % (what, sorted(by_round),
                                                       rounds))
  for rnd, got in sorted(by_round.items()):
    if sorted(got) != [0, 1] or any(m[3] != [0, 1] for m in got.values()):
      raise AssertionError("%s round %d: members %s" % (
          what, rnd, {g: m[3] for g, m in got.items()}))
    (w0, pre0, post0, _), (w1, pre1, post1, _) = got[0], got[1]
    if any(a["data"] != b["data"] for a, b in zip(post0, post1)):
      raise AssertionError("%s round %d: the groups' weights differ after "
                           "the merge" % (what, rnd))
    for a, b, out in zip(pre0, pre1, post0):
      xa = np.frombuffer(a["data"], a["dtype"]).astype(np.float64)
      xb = np.frombuffer(b["data"], b["dtype"]).astype(np.float64)
      want = ((w0 * xa + w1 * xb) / (w0 + w1)).astype(a["dtype"]).tobytes()
      if out["data"] != want:
        raise AssertionError("%s round %d: a merged leaf of shape %s is not "
                             "the f64 weighted mean" % (what, rnd,
                                                        out["shape"]))


def _groups_run(gs, steps, what, timeout=300.0):
  t0 = time.monotonic()
  gs.run(steps)
  if not gs.wait(timeout=timeout):
    raise AssertionError("%s: a group still runs after %d s" % (what, timeout))
  return time.monotonic() - t0


def _groups_exits(gs, want, what):
  got = {gid: (g.exit_reason, g.steps) for gid, g in gs.groups.items()}
  if got != want:
    raise AssertionError("%s: groups ended %s, want %s" % (what, got, want))


def _denominators(gs, gid):
  return [e["denominator"] for e in gs.events
          if e["event"] == "sync" and e["group"] == gid]


def groups_full_width(torch, ops, tfm, optim, G, params, cfg):
  """(a): 2 groups of the flagship at [6]'s shape, sync off, against the
  same batches run alone through one TrainLoop each."""
  from tensorflowonspark_tpu_torch.parallel import sharding
  build = _groups_build_fn(tfm, optim, cfg, params)
  batch_fn = _groups_batch_fn(cfg.vocab_size, TRAIN_B, TRAIN_S)
  gs = G.GroupSet(build, batch_fn, num_groups=2, sync_every=0)
  try:
    # each group's batches alone through a TrainLoop of its own, from the
    # group's initial state: the loop copies the state (donate_state
    # off), so the group starts from the same bits afterwards
    alone, t_alone = {}, 0.0
    for gid, g in gs.groups.items():
      loop = sharding.make_train_loop(_lm_loss(tfm), donate_state=False)
      if gid == 0:
        # untimed: the process's first steps pay for cuBLAS and the
        # allocator
        loop(g.state, batch_fn(gid, 0))
      ops.reset_launches()
      torch.cuda.synchronize()
      t0 = time.monotonic()
      state, losses = g.state, []
      for step in range(GROUPS_FULL_STEPS):
        state, loss = loop(state, batch_fn(gid, step))
        losses.extend(loss.float().cpu().tolist())
      torch.cuda.synchronize()
      t_alone += time.monotonic() - t0
      _per_step_launches(dict(ops.LAUNCHES), GROUPS_FULL_STEPS,
                         WANT_PER_STEP, "[6u](a) group %d alone" % gid)
      alone[gid] = losses
      del state, loop
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    wall = _groups_run(gs, GROUPS_FULL_STEPS, "[6u](a)")
    launches = dict(ops.LAUNCHES)
    _groups_exits(gs, {0: ("completed", GROUPS_FULL_STEPS),
                       1: ("completed", GROUPS_FULL_STEPS)}, "[6u](a)")
    _per_step_launches(launches, 2 * GROUPS_FULL_STEPS, WANT_PER_STEP,
                       "[6u](a) two groups")
    for gid, g in gs.groups.items():
      if g.losses != alone[gid]:
        raise AssertionError("[6u](a) group %d: losses %s, alone %s"
                             % (gid, g.losses, alone[gid]))
      if not all(math.isfinite(x) for x in g.losses):
        raise AssertionError("[6u](a): non-finite losses %s" % g.losses)
    res = {"losses": {gid: g.losses for gid, g in gs.groups.items()},
           "ms_per_step_each": wall / GROUPS_FULL_STEPS * 1e3,
           "ms_per_step_alone": t_alone / (2 * GROUPS_FULL_STEPS) * 1e3,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches}
  finally:
    gs.close()
  del gs
  torch.cuda.empty_cache()
  log("  (a) 2 groups of the flagship, B%d x S%d, sync off, %d steps each: "
      "losses equal to each group's batches run alone to the bit (%s); "
      "launches exactly twice one group's (%s); %.1f ms a step for each of "
      "two groups sharing the card's stream, %.1f alone; peak memory %.2f "
      "GiB" % (TRAIN_B, TRAIN_S, GROUPS_FULL_STEPS, " | ".join(
          " ".join("%.4f" % x for x in res["losses"][g]) for g in (0, 1)),
               {k: v for k, v in res["launches"].items() if v},
               res["ms_per_step_each"], res["ms_per_step_alone"],
               res["peak_mem_gib"]))
  return res


def groups_synced(torch, ops, tfm, optim, G, rendezvous):
  """(b): 2 groups of the small model synced every GROUPS_SYNC_EVERY
  steps, each round gated; then the sync's overhead in paired runs."""
  from tensorflowonspark_tpu_torch.control import _msgpack
  cfg = _groups_small_cfg(tfm, torch)
  build = _groups_build_fn(tfm, optim, cfg, SEED)
  batch_fn = _groups_batch_fn(cfg.vocab_size, GROUPS_B, GROUPS_S)
  gs = G.GroupSet(build, batch_fn, num_groups=2,
                  sync_every=GROUPS_SYNC_EVERY, sync_timeout=30.0)
  try:
    packed = G.pack_tree(gs.groups[0].state.params)
    frame = len(_msgpack.packb({"type": "SYNC", "group_id": 0, "round": 1,
                                "payload": packed, "weight": 4.0,
                                "step": 4}))
    weights = sum(p.numel() for p in gs.groups[0].state.params.values())
    calls = _sync_log(G, gs)
    ops.reset_launches()
    wall = _groups_run(gs, GROUPS_SYNC_STEPS, "[6u](b)")
    launches = dict(ops.LAUNCHES)
    _groups_exits(gs, {0: ("completed", GROUPS_SYNC_STEPS),
                       1: ("completed", GROUPS_SYNC_STEPS)}, "[6u](b)")
    _per_step_launches(launches, 2 * GROUPS_SYNC_STEPS, WANT_ONE_SMALL,
                       "[6u](b) two groups")
    rounds = GROUPS_SYNC_STEPS // GROUPS_SYNC_EVERY
    if gs.plane.status()["rounds_completed"] != rounds:
      raise AssertionError("[6u](b): %s" % gs.plane.status())
    _check_rounds(calls, rounds, "[6u](b)")
    for g in gs.groups.values():
      if not (all(math.isfinite(x) for x in g.losses)
              and g.losses[-1] < g.losses[0]):
        raise AssertionError("[6u](b) group %d: losses %s" % (g.group_id,
                                                             g.losses))
    sync_ms = [e["sync_ms"] for e in gs.events if e["event"] == "sync"]
    res = {"weights": weights, "payload_bytes": sum(len(r["data"])
                                                    for r in packed),
           "frame_bytes": frame,
           "max_message_bytes": rendezvous.MAX_MESSAGE_BYTES,
           "losses": {gid: g.losses for gid, g in gs.groups.items()},
           "rounds": rounds, "sync_ms": sync_ms, "wall_s": wall,
           "launches": launches}
  finally:
    gs.close()
  # the sync's overhead: the same 2 groups synced and not, alternated
  walls = {"on": [], "off": []}
  for _ in range(GROUPS_OVERHEAD_REPS):
    for mode, every in (("on", GROUPS_SYNC_EVERY), ("off", 0)):
      gs = G.GroupSet(build, batch_fn, num_groups=2, sync_every=every,
                      sync_timeout=30.0)
      try:
        walls[mode].append(_groups_run(gs, GROUPS_SYNC_STEPS,
                                       "[6u](b) %s" % mode))
      finally:
        gs.close()
  res["overhead_walls_s"] = walls
  res["overhead"] = statistics.median(walls["on"]) / statistics.median(
      walls["off"]) - 1.0
  log("  (b) 2 groups, %d layers d_model %d (%d weights, %d bytes packed, a "
      "SYNC frame of %d bytes against MAX_MESSAGE_BYTES %d), sync every %d "
      "of %d steps: %d rounds, each merging both groups, bit-identical "
      "after it and equal to the f64 weighted mean; launches exactly %d "
      "steps' (%s); losses %s -> %s; sync ms %s; wall synced %s s, unsynced "
      "%s s (paired): overhead %+.1f%%" % (
          GROUPS_SMALL["num_layers"], GROUPS_SMALL["d_model"], res["weights"],
          res["payload_bytes"], frame, rendezvous.MAX_MESSAGE_BYTES,
          GROUPS_SYNC_EVERY, GROUPS_SYNC_STEPS, rounds,
          2 * GROUPS_SYNC_STEPS, {k: v for k, v in launches.items() if v},
          "%.4f" % res["losses"][0][0], "%.4f" % res["losses"][0][-1],
          " ".join("%.1f" % x for x in sync_ms),
          " ".join("%.3f" % x for x in walls["on"]),
          " ".join("%.3f" % x for x in walls["off"]),
          100.0 * res["overhead"]))
  return res


def groups_kill(torch, tfm, optim, G, rendezvous, chaos):
  """(c): group 1 killed at its 2nd boundary; group 0 finishes alone,
  the plane marks group 1 lost, HEALTH carries the topology and the
  detector fires ``group_lost``; then ``readmit(1)``."""
  from tensorflowonspark_tpu_torch.obs import anomaly, metrics
  cfg = _groups_small_cfg(tfm, torch)
  build = _groups_build_fn(tfm, optim, cfg, SEED)
  batch_fn = _groups_batch_fn(cfg.vocab_size, GROUPS_B, GROUPS_S)
  with env_var("TOS_OBS", "1"), env_var(chaos.ENV_GROUP, GROUPS_KILL):
    chaos.reset()
    reg = metrics.activate()
    gs = G.GroupSet(build, batch_fn, num_groups=2,
                    sync_every=GROUPS_SYNC_EVERY, sync_timeout=1.0,
                    miss_limit=2)
    try:
      wall = _groups_run(gs, GROUPS_KILL_STEPS, "[6u](c)")
      _groups_exits(gs, {0: ("completed", GROUPS_KILL_STEPS),
                         1: ("chaos-kill", GROUPS_SYNC_EVERY)}, "[6u](c)")
      denoms = _denominators(gs, 0)
      if denoms[0] != 2 or denoms[-1] != 1 or 1 not in gs.plane.lost:
        raise AssertionError("[6u](c): group 0's denominators %s, lost %s"
                             % (denoms, gs.plane.lost))
      client = rendezvous.Client(gs.server.addr, timeout=10.0)
      try:
        health = client._request({"type": "HEALTH"})
      finally:
        client.close()
      if health.get("groups", {}).get("lost") != [1]:
        raise AssertionError("[6u](c): HEALTH carries %s"
                             % health.get("groups"))
      det = anomaly.AnomalyDetector(_OneExecutorSink(reg), interval=0.05,
                                    window=0.2,
                                    registry=metrics.MetricsRegistry())
      t = time.monotonic()
      alerts = det.poll(t) + det.poll(t + 1.0)
      if "group_lost" not in [a["alert"] for a in alerts]:
        raise AssertionError("[6u](c): the detector raised %s"
                             % [a["alert"] for a in alerts])
      os.environ.pop(chaos.ENV_GROUP)
      chaos.reset()
      t0 = time.monotonic()
      g = gs.readmit(1)
      caught_up = g.steps
      if not gs.wait(timeout=120) or caught_up < GROUPS_KILL_STEPS - 4:
        raise AssertionError("[6u](c): re-admitted at step %d" % caught_up)
      readmit_s = time.monotonic() - t0
      _groups_exits(gs, {0: ("completed", GROUPS_KILL_STEPS),
                         1: ("completed", GROUPS_KILL_STEPS)},
                    "[6u](c) re-admitted")
      res = {"wall_s": wall, "denominators": denoms,
             "lost": dict(gs.plane.lost), "health_groups": health["groups"],
             "alerts": sorted({a["alert"] for a in alerts}),
             "readmitted_at_step": caught_up, "readmit_s": readmit_s,
             "status": gs.plane.status()}
    finally:
      gs.close()
      metrics.deactivate()
      chaos.reset()
  log("  (c) TOS_CHAOS_GROUP=%s, sync_timeout 1.0 s, miss_limit 2, %d "
      "steps: group 1 killed at step %d, group 0 completed with "
      "denominators %s in %.2f s, group 1 lost; HEALTH groups %s; detector "
      "%s; readmit(1) caught up at step %d and completed in %.2f s" % (
          GROUPS_KILL, GROUPS_KILL_STEPS, GROUPS_SYNC_EVERY, denoms, wall,
          {k: health["groups"][k] for k in ("active", "lost",
                                           "groups_active", "groups_total")},
          res["alerts"], caught_up, readmit_s))
  return res


def groups_stall(torch, tfm, optim, G, chaos):
  """(d): group 1 stalls 2 s at its first boundary, past a 0.5 s round
  deadline with miss_limit 1: evicted, it re-admits itself."""
  cfg = _groups_small_cfg(tfm, torch)
  build = _groups_build_fn(tfm, optim, cfg, SEED)
  batch_fn = _groups_batch_fn(cfg.vocab_size, GROUPS_B, GROUPS_S)
  with env_var(chaos.ENV_GROUP, GROUPS_STALL):
    chaos.reset()
    gs = G.GroupSet(build, batch_fn, num_groups=2,
                    sync_every=GROUPS_SYNC_EVERY, sync_timeout=0.5,
                    miss_limit=1)
    try:
      wall = _groups_run(gs, GROUPS_STALL_STEPS, "[6u](d)")
      _groups_exits(gs, {0: ("completed", GROUPS_STALL_STEPS),
                         1: ("completed", GROUPS_STALL_STEPS)}, "[6u](d)")
      kinds = [e["event"] for e in gs.events]
      if "plane-lost" not in kinds or "group-readmitted" not in kinds:
        raise AssertionError("[6u](d): events %s" % kinds)
      res = {"wall_s": wall, "denominators": _denominators(gs, 0),
             "events": [k for k in kinds if k != "sync"]}
    finally:
      gs.close()
      chaos.reset()
  log("  (d) TOS_CHAOS_GROUP=%s, sync_timeout 0.5 s, miss_limit 1: group 1 "
      "evicted (plane-lost), re-admitted itself, both completed %d steps in "
      "%.2f s; group 0's denominators %s" % (
          GROUPS_STALL, GROUPS_STALL_STEPS, wall, res["denominators"]))
  return res


def groups_reshard(torch, tfm, optim, G):
  """(e): saved at 2 groups after 8 steps, restored at 3 and at 1."""
  from tensorflowonspark_tpu_torch.utils.checkpoint import CheckpointManager
  cfg = _groups_small_cfg(tfm, torch)
  build = _groups_build_fn(tfm, optim, cfg, SEED)
  batch_fn = _groups_batch_fn(cfg.vocab_size, GROUPS_B, GROUPS_S)
  ckdir = os.path.join(HERE, "build", "chip_smoke_groups_ckpt")
  shutil.rmtree(ckdir, ignore_errors=True)
  gs = G.GroupSet(build, batch_fn, num_groups=2,
                  sync_every=GROUPS_SYNC_EVERY, sync_timeout=30.0)
  try:
    _groups_run(gs, 2 * GROUPS_SYNC_EVERY, "[6u](e)")
    mgr = CheckpointManager(ckdir, save_interval_steps=1)
    t0 = time.monotonic()
    if not gs.save(mgr, force=True):
      raise AssertionError("[6u](e): the save did not happen")
    save_s = time.monotonic() - t0
    manifest = mgr.manifest()
    if manifest != {"schema": 1, "kind": "groupset", "num_groups": 2,
                    "groups": [0, 1], "step": 8, "sync_every": 4,
                    "sync_round": 2}:
      raise AssertionError("[6u](e): manifest %s" % manifest)
    saved = G.pack_tree(gs.groups[0].state.params)
  finally:
    gs.close()
  trajectories = {}
  for n in (3, 1):
    gs = G.GroupSet(build, batch_fn, num_groups=n,
                    sync_every=GROUPS_SYNC_EVERY, sync_timeout=30.0)
    try:
      nxt = gs.restore_or(CheckpointManager(ckdir, save_interval_steps=1))
      if nxt != 9:
        raise AssertionError("[6u](e) %d groups: next step %d" % (n, nxt))
      for g in gs.groups.values():
        if g.steps != 8 or any(a["data"] != b["data"] for a, b in zip(
            saved, G.pack_tree(g.state.params))):
          raise AssertionError("[6u](e) %d groups: group %d restored at "
                               "step %d, weights not the saved bits"
                               % (n, g.group_id, g.steps))
      _groups_run(gs, 3 * GROUPS_SYNC_EVERY, "[6u](e) %d groups" % n)
      _groups_exits(gs, {gid: ("completed", 12) for gid in range(n)},
                    "[6u](e) %d groups" % n)
      trajectories[n] = list(gs.groups[0].losses)
    finally:
      gs.close()
  if trajectories[3] != trajectories[1]:
    raise AssertionError("[6u](e): the chief's losses differ across "
                         "topologies: %s" % trajectories)
  shutil.rmtree(ckdir, ignore_errors=True)
  log("  (e) saved at 2 groups after 8 steps (manifest %s, %.2f s), "
      "restored at 3 and at 1: next step 9, every group's weights the "
      "saved bits; the chief's losses of steps 9-12 bit-identical across "
      "the two (%s)" % (manifest, save_s,
                        " ".join("%.4f" % x for x in trajectories[1])))
  return {"manifest": manifest, "save_s": save_s,
          "chief_losses": trajectories[1]}


def groups_exec_main(args, ctx):
  """[6u](f)'s main fn, one executor of an elastic group set: (b)'s
  model on the card as group ``args["group_map"][executor_id]``, synced
  through the driver's plane every GROUPS_SYNC_EVERY steps, with a
  ``kill_point("group-step")`` before each step (``args["kill"]`` armed
  here: the engine's executors outlive the phase's env). Writes its
  losses, launches a step and denominators to ``args["out"] %
  executor_id``."""
  import torch
  from tensorflowonspark_tpu_torch import ops, optim
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import groups as G
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils import chaos
  os.environ[chaos.ENV_KILL] = args["kill"]
  chaos.reset()
  gid = int(args["group_map"][ctx.executor_id])
  cfg = _groups_small_cfg(tfm, torch)
  state, loss_fn = _groups_build_fn(tfm, optim, cfg, SEED)(
      torch.device("cuda"))
  loop = sharding.make_train_loop(loss_fn, donate_state=False)
  batch_fn = _groups_batch_fn(cfg.vocab_size, GROUPS_B, GROUPS_S)
  client = G.GroupSyncClient(ctx.server_addr, gid, request_timeout=30.0)
  rec = {"group": gid, "losses": [], "launches_per_step": [],
         "denominators": [], "card": torch.cuda.get_device_name()}
  try:
    client.join()
    # a round's members are frozen when it opens: wait for the set
    deadline = time.monotonic() + 120.0
    while client.state()["groups_active"] < len(args["group_map"]):
      if time.monotonic() > deadline:
        raise TimeoutError("the group set did not assemble")
      time.sleep(0.02)
    for step in range(args["steps"]):
      chaos.kill_point("group-step", ctx.executor_id)
      before = dict(ops.LAUNCHES)
      state, losses = loop(state, batch_fn(gid, step))
      rec["losses"].extend(losses.float().cpu().tolist())
      rec["launches_per_step"].append({k: ops.LAUNCHES[k] - before[k]
                                       for k in before})
      if (step + 1) % GROUPS_SYNC_EVERY == 0:
        _, members = client.sync((step + 1) // GROUPS_SYNC_EVERY,
                                 state.params, weight=GROUPS_SYNC_EVERY,
                                 step=step + 1, timeout=60.0)
        rec["denominators"].append(len(members))
  finally:
    client.close()
  with open(args["out"] % ctx.executor_id, "w") as f:
    json.dump(rec, f)


def groups_cluster(cluster, engine):
  """(f): ``cluster.run(engine, ..., group_map={0: 0, 1: 1},
  elastic=True, max_restarts=0)`` on a LocalEngine(2) whose executors
  share the card; executor 1 SIGKILLed mid round 2."""
  out = os.path.join(HERE, "build", "chip_smoke_groups_exec%d.json")
  for r in range(2):
    _fresh(out % r)
  t0 = time.monotonic()
  with env_var("TOS_GROUP_SYNC_TIMEOUT", GROUPS_EXEC_SYNC_TIMEOUT):
    c = cluster.run(engine, groups_exec_main,
                    {"group_map": {0: 0, 1: 1}, "steps": GROUPS_EXEC_STEPS,
                     "kill": GROUPS_EXEC_KILL, "out": out},
                    input_mode=cluster.InputMode.TENSORFLOW,
                    chips_per_node=0, group_map={0: 0, 1: 1}, elastic=True,
                    max_restarts=0, heartbeat_interval=1.0,
                    reservation_timeout=300)
  plane = c.server.sync_plane
  c.shutdown(timeout=300)            # raises on a failure but the shrink
  cluster_s = time.monotonic() - t0
  shrink = [e for e in c.supervisor.events if e["kind"] == "resize-shrink"]
  if len(shrink) != 1 or shrink[0]["group"] != 1 \
      or shrink[0]["executor_id"] != 1:
    raise AssertionError("[6u](f): supervisor events %s"
                         % c.supervisor.events)
  with open(out % 0) as f:
    rec = json.load(f)
  rounds = GROUPS_EXEC_STEPS // GROUPS_SYNC_EVERY
  if rec["denominators"] != [2] + [1] * (rounds - 1) \
      or 1 not in plane.lost or os.path.exists(out % 1):
    raise AssertionError("[6u](f): executor 0's denominators %s, lost %s"
                         % (rec["denominators"], plane.lost))
  for i, got in enumerate(rec["launches_per_step"]):
    _per_step_launches(got, 1, WANT_ONE_SMALL, "[6u](f) executor 0 step %d"
                       % i)
  if not rec["losses"][-1] < rec["losses"][0]:
    raise AssertionError("[6u](f): losses %s" % rec["losses"])
  res = {"denominators": rec["denominators"], "losses": rec["losses"],
         "shrink": {k: v for k, v in shrink[0].items() if k != "t"},
         "events": [e["kind"] for e in c.supervisor.events],
         "cluster_s": cluster_s, "card": rec["card"],
         "launches_per_step": rec["launches_per_step"]}
  log("  (f) cluster.run(LocalEngine(2), ..., group_map={0: 0, 1: 1}, "
      "elastic=True, max_restarts=0): executor 1 SIGKILLed at %s; the "
      "supervisor's events %s (%s); executor 0 trained %d steps on the card "
      "with denominators %s, launches %s a step; shutdown() did not raise; "
      "%.1f s" % (GROUPS_EXEC_KILL, res["events"], res["shrink"],
                  GROUPS_EXEC_STEPS, rec["denominators"],
                  {k: v for k, v in rec["launches_per_step"][0].items() if v},
                  cluster_s))
  return res


def groups_phase(torch, ops, tfm, optim, card, params, cfg, engine=None):
  """[6u]: elastic multi-group training (module docstring); (f) runs on
  ``engine`` (a LocalEngine(2) of an earlier phase) or one of its own."""
  from tensorflowonspark_tpu_torch import cluster
  from tensorflowonspark_tpu_torch.control import rendezvous
  from tensorflowonspark_tpu_torch.parallel import groups as G
  from tensorflowonspark_tpu_torch.utils import chaos
  t0 = time.monotonic()
  log("[6u] elastic multi-group training: groups as threads sharing the "
      "card, synced over the rendezvous plane")
  res = {"card": card}
  res["full_width"] = groups_full_width(torch, ops, tfm, optim, G, params,
                                        cfg)
  res["synced"] = groups_synced(torch, ops, tfm, optim, G, rendezvous)
  res["kill"] = groups_kill(torch, tfm, optim, G, rendezvous, chaos)
  res["stall"] = groups_stall(torch, tfm, optim, G, chaos)
  res["reshard"] = groups_reshard(torch, tfm, optim, G)
  torch.cuda.empty_cache()
  own = engine is None
  if own:
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    engine = LocalEngine(num_executors=2)
  try:
    res["cluster"] = groups_cluster(cluster, engine)
  finally:
    if own:
      engine.stop()
  res["seconds"] = time.monotonic() - t0
  log("  [6u] %.1f s; %s" % (res["seconds"], card))
  return res


def groups_launches(res, name):
  """[6u]'s launches of kernel ``name``: (a)'s two groups and (b)'s."""
  return {"groups_full_width_2x%d_steps" % GROUPS_FULL_STEPS:
          res["full_width"]["launches"][name],
          "groups_synced_2x%d_steps" % GROUPS_SYNC_STEPS:
          res["synced"]["launches"][name]}


def groups_only(torch, ops, tfm, optim, _build, card, init_params):
  """``--groups-only``: phase 2's build, then [6u] alone."""
  log("[2] build")
  build_s = _build.build_all()
  log("  built %s" % ", ".join("%s %.1fs" % kv for kv in build_s.items()))
  cfg = tfm.TransformerConfig()
  res = groups_phase(torch, ops, tfm, optim, card,
                     init_params(cfg, seed=SEED), cfg)
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out", "chip_smoke_groups.json"),
            "w") as f:
    json.dump({"groups": res, "card": card}, f, indent=1)
  log(card)
  log(json.dumps({"groups": {
      "ms_per_step_each_of_2": res["full_width"]["ms_per_step_each"],
      "ms_per_step_alone": res["full_width"]["ms_per_step_alone"],
      "sync_ms": res["synced"]["sync_ms"],
      "sync_overhead": res["synced"]["overhead"],
      "kill_denominators": res["kill"]["denominators"],
      "cluster_denominators": res["cluster"]["denominators"]},
                  "seconds": res["seconds"], "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


# -- phase 6m: the pipeline layer ----------------------------------------------

PIPE_B = 8                              # rows a training step and a serve batch
PIPE_STEPS = 3                          # training steps on each node
PIPE_PARTS = 4
PIPE_PART_ROWS = PIPE_B * PIPE_STEPS    # a partition is one node's 3 steps
PIPE_SEED = SEED + 29
PIPE_PROMPTS = 32
PIPE_PLEN = 128
PIPE_SLOTS = 8                          # [4]'s slot count
PIPE_TEMP = 0.8
PIPE_TOP_K = 40
PIPE_SCHEMA = "struct<prompt:array<long>>"
# the decode path of one rectangular batch: one prefill (12 flash forwards,
# 25 LayerNorm forwards), then MAIN_NEW - 1 one-token forwards (25 LayerNorm
# forwards each, dense attention against the cache)
WANT_PER_PREFILL = {"flash_attention_fwd": 12, "layer_norm": 25}


def pipe_train_main(args, ctx):
  """[6m-a]'s train fn, run by ``TFEstimator.fit`` in each node's
  background process (InputMode.SPARK): [6]'s training of the flagship at
  full width on PIPE_STEPS batches of PIPE_B rows from the feed, then
  ``feed.terminate()``; the chief exports the bundle (the bf16 serving
  weights, ``make_serving_predict_fn(cfg, MAIN_NEW)`` and a signature).
  Writes its record to ``args["out"] % executor_id``."""
  t_enter = time.time()
  import numpy as np
  import torch
  from tensorflowonspark_tpu_torch import ops, optim, pipeline
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import sharding
  from tensorflowonspark_tpu_torch.utils.params import init_params
  _no_tf32(torch)
  t_import = time.time()
  cfg = tfm.TransformerConfig()
  state = tfm.create_state(cfg, init_params(cfg, seed=SEED),
                           tx=optim.make_optimizer(learning_rate=3e-4,
                                                   clip_norm=1.0))
  step = sharding.make_train_step(_lm_loss(tfm))
  torch.cuda.synchronize()
  t_state = time.time()
  feed = ctx.get_data_feed()
  losses, launches, step_s = [], [], []
  ops.reset_launches()
  while len(losses) < PIPE_STEPS:
    batch = feed.next_batch_arrays(PIPE_B)
    if len(batch) != PIPE_B:
      raise AssertionError("executor %d got a batch of %d rows after %d "
                           "steps" % (ctx.executor_id, len(batch),
                                      len(losses)))
    before = dict(ops.LAUNCHES)
    t0 = time.monotonic()
    state, loss = step(state, batch)
    losses.append(float(loss))
    step_s.append(time.monotonic() - t0)
    launches.append({k: ops.LAUNCHES[k] - before[k] for k in before})
  t_trained = time.time()
  feed.terminate()
  export = None
  if ctx.is_chief:
    t0 = time.monotonic()
    target = pipeline.export_bundle(
        state.model.serving_params(),
        tfm.make_serving_predict_fn(cfg, MAIN_NEW, num_slots=PIPE_SLOTS),
        args["export_dir"], is_chief=True,
        example_batch={"prompt": np.zeros((1, PIPE_PLEN), np.int32)})
    export = {"seconds": time.monotonic() - t0, "dir": target}
  with open(args["out"] % ctx.executor_id, "w") as f:
    json.dump({"executor": ctx.executor_id, "chief": ctx.is_chief,
               "losses": losses, "launches_per_step": launches,
               "step_s": step_s, "t_enter": t_enter,
               "import_s": t_import - t_enter, "state_s": t_state - t_import,
               "train_s": t_trained - t_state, "export": export,
               "card": torch.cuda.get_device_name(), "t_end": time.time(),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30},
              f)


class PipeCounts(object):
  """An engine task that reports its executor's launch counts, serving
  cache stats and transform stats (module-level: pickled by name)."""

  def __call__(self, it):
    from tensorflowonspark_tpu_torch import ops, pipeline
    from tensorflowonspark_tpu_torch.models import transformer as tfm
    return {"slot": int(os.environ.get("TOS_EXECUTOR_SLOT", "-1")),
            "pid": os.getpid(), "launches": dict(ops.LAUNCHES),
            "serving": dict(tfm.SERVING_STATS),
            "transform": dict(pipeline.TRANSFORM_STATS),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _pipe_counts(engine):
  return engine.run_on_executors(PipeCounts()).wait(timeout=300)


def _pipe_delta(before, after):
  """Per executor: the launch counts and serving stats a phase added."""
  out = []
  for b, a in zip(before, after):
    if a["pid"] != b["pid"]:
      raise AssertionError("executor slot %d was replaced (pid %d -> %d)"
                           % (a["slot"], b["pid"], a["pid"]))
    out.append({"slot": a["slot"], "visible": a["visible"],
                "launches": {k: a["launches"][k] - b["launches"][k]
                             for k in a["launches"]},
                "serving": {k: a["serving"][k] - b["serving"][k]
                            for k in a["serving"]},
                "transform": a["transform"]})
  return out


def _check_prefills(delta, what, calls_each=None):
  """Each executor that served launched exactly WANT_PER_PREFILL per
  rectangular batch (one prefill and MAIN_NEW - 1 one-token forwards)."""
  for d in delta:
    calls = d["serving"]["rect_calls"]
    if calls_each is not None and calls != calls_each:
      raise AssertionError("%s: executor %d served %d batches, want %d"
                           % (what, d["slot"], calls, calls_each))
    want = {"flash_attention_fwd": 12 * calls,
            "layer_norm": 25 * MAIN_NEW * calls}
    got = {k: d["launches"][k] for k in want}
    if got != want or any(v for k, v in d["launches"].items()
                           if k not in want):
      raise AssertionError("%s: executor %d launched %s for %d batches, "
                           "the path needs %s" % (what, d["slot"],
                                                  d["launches"], calls, want))


def pipe_infer_main(args, ctx):
  """[6m-e]'s map fn under ``runner.run``: this task's shard of the
  prompts, served batch by batch through the bundle's predict fn on the
  card."""
  import numpy as np
  import torch
  from tensorflowonspark_tpu_torch import pipeline
  params, predict = pipeline.load_bundle(args["export_dir"])
  n = len(ctx.cluster_spec["worker"])
  per = len(args["prompts"]) // n
  shard = args["prompts"][ctx.task_index * per:(ctx.task_index + 1) * per]
  rows = []
  for i in range(0, len(shard), PIPE_B):
    rows += predict(params, {"prompt": np.asarray(shard[i:i + PIPE_B],
                                                  np.int32)})[
                                                      "tokens"].tolist()
  return {"task": ctx.task_index, "addresses": ctx.cluster_spec["worker"],
          "rows": rows, "card": torch.cuda.get_device_name(),
          "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _replay_top_k(torch, model, prompts, out, k, temp):
  """The drawn tokens replayed through the same decode path (the same
  logits, bit for bit): each must lie in its step's top ``k`` of the
  logits over ``temp``. Returns per row whether a step's k-th largest was
  tied (bf16 logits tie; a tie is kept, as the reference keeps it)."""
  plen = prompts.shape[1]
  out = torch.as_tensor(out, device=model.device).long()
  tied = torch.zeros(out.shape[0], dtype=torch.bool, device=model.device)
  with torch.inference_mode():
    cache = model.init_cache(out.shape[0])
    logits = model(torch.as_tensor(prompts, device=model.device), cache)[:, -1]
    for i in range(out.shape[1] - plen):
      tok = out[:, plen + i]
      scaled = logits.float() / temp
      kth = torch.topk(scaled, k, dim=-1).values[:, -1:]
      if not bool((scaled.gather(1, tok[:, None]) >= kth).all()):
        raise AssertionError("step %d drew a token outside its top %d"
                             % (i, k))
      tied |= (scaled >= kth).sum(-1) > k
      logits = model(tok[:, None], cache)[:, -1]
  return tied.cpu().numpy()


def _bytes_under(path):
  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, fs in os.walk(path) for f in fs)


def pipe_fit(torch, pipeline, engine, export_dir):
  """[6m-a]: ``TFEstimator.fit`` of PIPE_PARTS partitions of
  PIPE_PART_ROWS token rows on the two executors."""
  rows = feed_rows(PIPE_PARTS * PIPE_PART_ROWS, PIPE_SEED)
  out = os.path.join(HERE, "build", "chip_smoke_pipe_node%d.json")
  for i in range(2):
    _fresh(out % i)
  shutil.rmtree(export_dir, ignore_errors=True)
  est = pipeline.TFEstimator(pipe_train_main, {"export_dir": export_dir,
                                               "out": out})
  est.setEpochs(1).setGraceSecs(1).setReservationTimeout(300)
  t0 = time.time()
  model = est.fit(engine, _split(rows, PIPE_PART_ROWS))
  t_end = time.time()
  nodes = []
  for i in range(2):
    with open(out % i) as f:
      nodes.append(json.load(f))
  for n in nodes:
    if len(n["losses"]) != PIPE_STEPS or \
        not all(math.isfinite(x) for x in n["losses"]):
      raise AssertionError("[6m-a] executor %d losses %s"
                           % (n["executor"], n["losses"]))
    for i, got in enumerate(n["launches_per_step"]):
      _per_step_launches(got, 1, WANT_PER_STEP, "[6m-a] executor %d step %d"
                         % (n["executor"], i))
  chief = [n for n in nodes if n["chief"]]
  if len(chief) != 1 or chief[0]["export"] is None:
    raise AssertionError("[6m-a] no chief export: %s" % nodes)
  for name in ("predict.pkl", "signature.json", "model"):
    if not os.path.exists(os.path.join(export_dir, name)):
      raise AssertionError("[6m-a] the bundle has no %s" % name)
  res = {"nodes": nodes, "fit_s": t_end - t0,
         "bringup_s": min(n["t_enter"] for n in nodes) - t0,
         "shutdown_s": t_end - max(n["t_end"] for n in nodes),
         "export_s": chief[0]["export"]["seconds"],
         "bundle_bytes": _bytes_under(export_dir),
         "signature": pipeline.load_signature(export_dir)}
  log("  fit %.1f s: cluster bring-up to the fns' start %.1f s, imports "
      "%s s, state %s s, training %s s (3 steps each; ms/step %s), export "
      "%.1f s of %.3f GB (bf16 serving weights), shutdown %.1f s" % (
          res["fit_s"], res["bringup_s"],
          "/".join("%.1f" % n["import_s"] for n in nodes),
          "/".join("%.1f" % n["state_s"] for n in nodes),
          "/".join("%.1f" % n["train_s"] for n in nodes),
          " | ".join(" ".join("%.0f" % (s * 1e3) for s in n["step_s"])
                     for n in nodes),
          res["export_s"], res["bundle_bytes"] / 1e9, res["shutdown_s"]))
  log("  losses %s; [6]'s 24/12/49/25 launches per step in both executors; "
      "signature %s" % (" | ".join(" ".join("%.4f" % x for x in n["losses"])
                                   for n in nodes),
                        res["signature"]["outputs"]))
  return res, model


def pipe_transform(torch, np, tfm, pipeline, engine, export_dir, cfg):
  """[6m-b] and [6m-c]: rectangular and ragged transforms, each against
  the driver's decode of the bundle's weights."""
  from tensorflowonspark_tpu_torch.serving import ServingEngine
  prompts = [p.astype(np.int32) for p in
             np.random.default_rng(PIPE_SEED + 1).integers(
                 1, cfg.vocab_size, (PIPE_PROMPTS, PIPE_PLEN))]
  half = PIPE_PROMPTS // 2
  model = pipeline.TFModel({"export_dir": export_dir, "batch_size": PIPE_B,
                            "chips_per_node": 1})
  before = _pipe_counts(engine)
  t0 = time.monotonic()
  rows = model.transform(engine, [[(p,) for p in prompts[:half]],
                                  [(p,) for p in prompts[half:]]])
  rect_s = time.monotonic() - t0
  rect = _pipe_delta(before, _pipe_counts(engine))
  _check_prefills(rect, "[6m-b]", calls_each=half // PIPE_B)
  if [d["visible"] for d in rect] != ["0", "0"]:
    raise AssertionError("[6m-b] executors claimed cards %s"
                         % [d["visible"] for d in rect])
  t0 = time.monotonic()
  params, _ = pipeline.load_bundle(export_dir)
  load_s = time.monotonic() - t0
  ref = tfm.Transformer(cfg, params)
  want = []
  for i in range(0, PIPE_PROMPTS, PIPE_B):
    want += tfm.greedy_generate_kv(ref, np.stack(prompts[i:i + PIPE_B]),
                                   MAIN_NEW).cpu().numpy().astype(
                                       np.int32).tolist()
  if rows != want:
    bad = [i for i, (a, b) in enumerate(zip(rows, want)) if a != b]
    raise AssertionError("[6m-b] transform rows %s differ from the driver's "
                         "greedy_generate_kv" % bad[:8])
  log("  [6m-b] 2 partitions x %d prompts of %d tokens, batch %d: every row "
      "equal to the driver's greedy_generate_kv to the bit; %.1f rows/s "
      "(%.2f s, bundle loads included); first batch %s s after its task "
      "started (card claim + bundle load %s s + model build + decode); "
      "launches per executor %s; the driver's bundle load %.2f s" % (
          half, PIPE_PLEN, PIPE_B, PIPE_PROMPTS / rect_s, rect_s,
          "/".join("%.2f" % d["transform"]["first_batch_s"] for d in rect),
          "/".join("%.2f" % d["transform"]["load_s"] for d in rect),
          [{k: v for k, v in d["launches"].items() if v} for d in rect],
          load_s))

  ragged = [p.tolist() for p in _prompts(MAIN_LENGTHS, cfg.vocab_size,
                                         PIPE_SEED + 2)]
  before = _pipe_counts(engine)
  t0 = time.monotonic()
  stream = model.transform(engine, [[(p,) for p in ragged]], collect=False)
  if isinstance(stream, list):
    raise AssertionError("[6m-c] collect=False returned a list")
  got = list(stream)
  ragged_s = time.monotonic() - t0
  rag = _pipe_delta(before, _pipe_counts(engine))
  stats = {k: sum(d["serving"][k] for d in rag) for k in rag[0]["serving"]}
  if (stats["ragged_calls"], stats["engine_builds"],
      stats["engine_hits"]) != (2, 1, 1):
    raise AssertionError("[6m-c] the engine cache: %s" % stats)
  eng = ServingEngine(params, cfg, num_slots=PIPE_SLOTS,
                      max_new_tokens=MAIN_NEW, max_queue=0,
                      max_queued_tokens=0).start()
  try:
    want_r = []
    for i in range(0, len(ragged), PIPE_B):
      outs = eng.generate([np.asarray(p, np.int32)
                           for p in ragged[i:i + PIPE_B]],
                          max_new_tokens=MAIN_NEW)
      width = max(len(o) for o in outs)
      want_r += [list(o) + [0] * (width - len(o)) for o in outs]
  finally:
    eng.stop()
  want_r = [[int(x) for x in r] for r in want_r]
  if got != want_r:
    bad = [i for i, (a, b) in enumerate(zip(got, want_r)) if a != b]
    raise AssertionError("[6m-c] ragged rows %s differ from the driver's "
                         "ServingEngine" % bad[:8])
  log("  [6m-c] 1 partition of %d prompts of %d-%d tokens, lazy: equal to "
      "the driver's ServingEngine(num_slots=%d) to the bit; the engine "
      "cache built once and hit on the second batch; %.0f new tokens/s "
      "(%.2f s)" % (len(ragged), min(MAIN_LENGTHS), max(MAIN_LENGTHS),
                    PIPE_SLOTS, len(ragged) * MAIN_NEW / ragged_s,
                    ragged_s))
  res = {"rect_s": rect_s, "rows_per_s": PIPE_PROMPTS / rect_s,
         "first_batch_s": [d["transform"]["first_batch_s"] for d in rect],
         "executor_load_s": [d["transform"]["load_s"] for d in rect],
         "driver_load_s": load_s, "rect": rect, "ragged": rag,
         "ragged_s": ragged_s,
         "ragged_tokens_per_s": len(ragged) * MAIN_NEW / ragged_s}
  return res, prompts, want, params, ref


def pipe_sampled(torch, np, tfm, params, ref, cfg, prompts, want):
  """[6m-d]: sampled serving through the predict fn in the driver."""
  batch = {"prompt": np.stack(prompts[:PIPE_B])}
  fn = tfm.make_serving_predict_fn(cfg, MAIN_NEW, temperature=PIPE_TEMP,
                                   top_k=PIPE_TOP_K)
  a = fn(params, batch)["tokens"]
  b = fn(params, batch)["tokens"]
  if np.array_equal(a, b):
    raise AssertionError("[6m-d] two sampled serves of one batch are equal")
  for out in (a, b):
    _replay_top_k(torch, ref, batch["prompt"], out, PIPE_TOP_K, PIPE_TEMP)
  one = tfm.make_serving_predict_fn(cfg, MAIN_NEW, temperature=PIPE_TEMP,
                                    top_k=1)(params, batch)["tokens"]
  tied = _replay_top_k(torch, ref, batch["prompt"], one, 1, PIPE_TEMP)
  greedy = np.asarray(want[:PIPE_B], np.int32)
  if not np.array_equal(one[~tied], greedy[~tied]):
    raise AssertionError("[6m-d] top_k=1 differs from greedy in an untied "
                         "row")
  differ = int((a != b).any(1).sum())
  log("  [6m-d] T %.1f top-%d: two serves of one batch differ in %d of %d "
      "rows, every token in its step's top %d; top_k=1 equal to greedy to "
      "the bit in the %d rows whose maxima never tied (%d rows met a bf16 "
      "tie at the top and drew among the tied)" % (
          PIPE_TEMP, PIPE_TOP_K, differ, PIPE_B, PIPE_TOP_K,
          int((~tied).sum()), int(tied.sum())))
  return {"rows_differ": differ, "top1_untied_rows": int((~tied).sum())}


def pipe_runner(runner, engine, export_dir, prompts, want, card_name):
  """[6m-e]: ``runner.run`` of 2 barrier tasks, each serving its shard."""
  before = _pipe_counts(engine)
  t0 = time.monotonic()
  results = runner.run(engine, pipe_infer_main,
                       {"export_dir": export_dir,
                        "prompts": [p.tolist() for p in prompts]},
                       num_tasks=2, use_barrier=True, chips_per_node=1,
                       timeout=600)
  run_s = time.monotonic() - t0
  delta = _pipe_delta(before, _pipe_counts(engine))
  _check_prefills(delta, "[6m-e]", calls_each=PIPE_PROMPTS // 2 // PIPE_B)
  results = sorted(results, key=lambda r: r["task"])
  per = PIPE_PROMPTS // 2
  for r in results:
    if r["rows"] != want[r["task"] * per:(r["task"] + 1) * per]:
      raise AssertionError("[6m-e] task %d's rows differ from [6m-b]'s"
                           % r["task"])
    if r["card"] != card_name or r["visible"] != "0":
      raise AssertionError("[6m-e] task %d ran on %s (%s)"
                           % (r["task"], r["card"], r["visible"]))
  if results[0]["addresses"] != results[1]["addresses"] or \
      len(results[0]["addresses"]) != 2:
    raise AssertionError("[6m-e] the gang's addresses: %s"
                         % [r["addresses"] for r in results])
  log("  [6m-e] runner.run(use_barrier=True) x2: each task served its %d "
      "prompts on the card, rows equal to [6m-b]'s, both ctxs carry %s; "
      "%.2f s" % (per, results[0]["addresses"], run_s))
  return {"seconds": run_s, "delta": delta,
          "addresses": results[0]["addresses"]}


def pipe_cli(dfutil, parse_schema, pipeline, engine, export_dir, prompts,
             want):
  """[6m-f]: the prompts written as TFRecords by the executors, then the
  inference CLI as a subprocess over them."""
  data_dir = os.path.join(HERE, "build", "chip_smoke_pipe_prompts")
  shutil.rmtree(data_dir, ignore_errors=True)
  half = PIPE_PROMPTS // 2
  t0 = time.monotonic()
  dfutil.save_as_tfrecords([[(p.tolist(),) for p in prompts[:half]],
                            [(p.tolist(),) for p in prompts[half:]]],
                           parse_schema(PIPE_SCHEMA), data_dir,
                           engine=engine)
  write_s = time.monotonic() - t0
  parts, schema = dfutil.load_tfrecords(data_dir)
  if str(schema) != PIPE_SCHEMA or \
      [r[0] for p in parts for r in p] != [p.tolist() for p in prompts]:
    raise AssertionError("[6m-f] the files read back as %s" % schema)
  out = _fresh(os.path.join(HERE, "build", "chip_smoke_pipe_preds.jsonl"))
  t0 = time.monotonic()
  proc = subprocess.run(
      [sys.executable, "-m", "tensorflowonspark_tpu_torch.inference_cli",
       "--export_dir", export_dir, "--input", data_dir, "--output", out,
       "--num_executors", "1", "--batch_size", str(PIPE_B)],
      cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
      text=True, timeout=600)
  cli_s = time.monotonic() - t0
  if proc.returncode != 0:
    raise AssertionError("[6m-f] the CLI exited %d: %s"
                         % (proc.returncode, proc.stderr[-3000:]))
  names = pipeline.signature_output_names(export_dir)
  with open(out) as f:
    lines = [json.loads(line) for line in f]
  if names != ["tokens"] or any(sorted(l) != names for l in lines) or \
      [l["tokens"] for l in lines] != want:
    raise AssertionError("[6m-f] the CLI's %d lines differ from [6m-b]'s "
                         "rows" % len(lines))
  log("  [6m-f] save_as_tfrecords on the executors %.2f s (2 part files, "
      "read back with the inferred %s); python -m ...inference_cli "
      "--num_executors 1: %d JSONL lines named by the signature %s, equal "
      "to [6m-b]'s rows; %.1f s" % (write_s, schema, len(lines), names,
                                    cli_s))
  return {"write_s": write_s, "cli_s": cli_s, "lines": len(lines)}


PIPE_EXAMPLES = (
    ("serve_gpt", ["--export_dir", os.path.join(
        HERE, "build", "chip_smoke_serve_gpt")]),
    ("mnist_pipeline", ["--num_samples", "512", "--export_dir",
                        os.path.join(HERE, "build", "chip_smoke_mnist")]),
    ("mnist_parallel_inference", ["--num_samples", "512", "--warm_steps",
                                  "20"]))


def start_examples():
  """[6m-g]: the port's serving and MNIST examples, as subprocesses
  started together on the card (and beside [6m]'s other parts, which
  share neither a process nor a port with them): (start time, [(name,
  process)]), for :func:`pipe_examples`."""
  return time.monotonic(), [(name, subprocess.Popen(
      [sys.executable, "-m", "tensorflowonspark_tpu_torch.examples." + name]
      + argv, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
      for name, argv in PIPE_EXAMPLES]


def pipe_examples(started):
  """[6m-g]: the examples of :func:`start_examples`; each must exit 0."""
  t0, procs = started
  res = {}
  try:
    for name, proc in procs:
      out, err = proc.communicate(timeout=600)
      res[name] = {"rc": proc.returncode, "seconds": time.monotonic() - t0,
                   "last": out.strip().splitlines()[-1:]}
      if proc.returncode != 0:
        raise AssertionError("[6m-g] %s exited %d: %s"
                             % (name, proc.returncode, err[-3000:]))
  finally:
    for _, proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  for name, r in res.items():
    log("  [6m-g] %s exited 0 after %.1f s: %s" % (name, r["seconds"],
                                                   r["last"]))
  return res


def pipeline_phase(torch, card_name):
  """[6m]: the pipeline layer at full width on one LocalEngine(2) whose
  executors share the card."""
  import numpy as np
  from tensorflowonspark_tpu_torch import pipeline
  from tensorflowonspark_tpu_torch.data import dfutil
  from tensorflowonspark_tpu_torch.data.schema import parse_schema
  from tensorflowonspark_tpu_torch.engine import LocalEngine
  from tensorflowonspark_tpu_torch.models import transformer as tfm
  from tensorflowonspark_tpu_torch.parallel import runner
  t_start = time.monotonic()
  cfg = tfm.TransformerConfig()
  export_dir = os.path.join(HERE, "build", "chip_smoke_pipe_bundle")
  log("[6m-g] examples/serve_gpt.py, mnist_pipeline.py and "
      "mnist_parallel_inference.py started, beside [6m-a..f]")
  started = start_examples()
  t0 = time.monotonic()
  engine = LocalEngine(num_executors=2)
  engine_s = time.monotonic() - t0
  try:
    log("[6m-a] TFEstimator.fit: the flagship trained %d steps of B%d x "
        "S%d on each of 2 executors sharing the card (InputMode.SPARK); "
        "the chief exports a bundle" % (PIPE_STEPS, PIPE_B, TRAIN_S))
    fit, _ = pipe_fit(torch, pipeline, engine, export_dir)
    fit["engine_s"] = engine_s
    log("  engine start %.2f s (the executors spawn in the background)"
        % engine_s)
    log("[6m-b/c] TFModel.transform: rectangular (collected), ragged (lazy)")
    tr, prompts, want, params, ref = pipe_transform(
        torch, np, tfm, pipeline, engine, export_dir, cfg)
    log("[6m-d] sampled serving through make_serving_predict_fn")
    sampled = pipe_sampled(torch, np, tfm, params, ref, cfg, prompts, want)
    del ref
    torch.cuda.empty_cache()
    log("[6m-e] the TFParallel runner")
    run = pipe_runner(runner, engine, export_dir, prompts, want, card_name)
    log("[6m-f] TFRecords and the inference CLI")
    cli = pipe_cli(dfutil, parse_schema, pipeline, engine, export_dir,
                   prompts, want)
  except BaseException:
    for _, proc in started[1]:
      proc.kill()
      proc.wait()
    raise
  finally:
    engine.stop()
  log("[6m-g] the examples")
  examples = pipe_examples(started)
  res = {"fit": fit, "transform": tr, "sampled": sampled, "runner": run,
         "cli": cli, "examples": examples,
         "seconds": time.monotonic() - t_start}
  log("  [6m] %.1f s" % res["seconds"])
  return res


def pipe_launches(res, name):
  """[6m]'s launches of kernel ``name`` on its main path: both nodes'
  training steps, the rectangular transform and the runner, per path."""
  fit = sum(step[name] for n in res["fit"]["nodes"]
            for step in n["launches_per_step"])
  out = {"pipeline_fit_%d_steps" % (2 * PIPE_STEPS): fit}
  for key, delta in (("pipeline_transform_%d_batches", res["transform"][
      "rect"]), ("pipeline_runner_%d_batches", res["runner"]["delta"])):
    batches = sum(d["serving"]["rect_calls"] for d in delta)
    n = sum(d["launches"][name] for d in delta)
    if n:
      out[key % batches] = n
  return out


def pipeline_only(torch, _build, card):
  """``--pipeline-only``: phase 6m alone (the driver builds every kernel
  first; the nodes and executors load them)."""
  t0 = time.monotonic()
  _build.build_all()
  log("  built the kernels in %.1f s" % (time.monotonic() - t0))
  res = pipeline_phase(torch, torch.cuda.get_device_name(0))
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out", "chip_smoke_pipeline.json"),
            "w") as f:
    json.dump({"pipeline": res, "card": card}, f, indent=1)
  log(card)
  log(json.dumps({"pipeline": pipe_summary(res), "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


def pipe_summary(res):
  fit, tr = res["fit"], res["transform"]
  return {
      "fit_s": fit["fit_s"], "engine_s": fit["engine_s"],
      "bringup_s": fit["bringup_s"],
      "train_s": [n["train_s"] for n in fit["nodes"]],
      "ms_per_step": [[s * 1e3 for s in n["step_s"]] for n in fit["nodes"]],
      "export_s": fit["export_s"], "shutdown_s": fit["shutdown_s"],
      "bundle_bytes": fit["bundle_bytes"],
      "transform_rows_per_s": tr["rows_per_s"],
      "first_batch_s": tr["first_batch_s"],
      "executor_load_s": tr["executor_load_s"],
      "driver_load_s": tr["driver_load_s"],
      "ragged_tokens_per_s": tr["ragged_tokens_per_s"],
      "runner_s": res["runner"]["seconds"], "cli_s": res["cli"]["cli_s"],
      "examples_s": {k: v["seconds"] for k, v in res["examples"].items()},
      "launches": {n: pipe_launches(res, n) for n in (
          "flash_attention_fwd", "flash_attention_bwd", "layer_norm",
          "layer_norm_bwd")},
      "seconds": res["seconds"]}


# train_gpt.py's default model flags (4 layers, d_model 256, 8 heads:
# head_dim 32, seq 512, vocab 1024, batch 8): 2 flash forwards per layer
# (forward and remat recompute), one fused backward, 4 LayerNorm forwards
# per layer (2 and their recompute) + ln_f, 2 backwards + ln_f's
GPT_DEFAULT_STEPS = 5


def _want_per_layer(layers):
  return dict(WANT_PER_STEP, flash_attention_fwd=2 * layers,
              flash_attention_bwd=layers, layer_norm=4 * layers + 1,
              layer_norm_bwd=2 * layers + 1)


def train_gpt_defaults(torch, ops, train_gpt):
  """The port's train_gpt at its default model flags through its ``run``,
  batches from seeded TFRecord files: finite losses, exact launch counts
  per step (the fused backward at head_dim 32 among them)."""
  args = train_gpt.parse_args(["--steps", str(GPT_DEFAULT_STEPS)])
  pattern = write_token_files(
      os.path.join(HERE, "build", "chip_smoke_gpt_tokens"), args.vocab,
      args.seq_len)
  args = train_gpt.parse_args(["--data", pattern, "--steps",
                               str(GPT_DEFAULT_STEPS)])
  cfg = train_gpt.make_config(args)
  torch.cuda.synchronize()
  ops.reset_launches()
  t0 = time.monotonic()
  losses = train_gpt.run(args)
  torch.cuda.synchronize()
  wall = time.monotonic() - t0
  per = _per_step_launches(dict(ops.LAUNCHES), GPT_DEFAULT_STEPS,
                           _want_per_layer(cfg.num_layers),
                           "train_gpt default flags")
  if len(losses) != GPT_DEFAULT_STEPS or not all(
      math.isfinite(x) for x in losses):
    raise AssertionError("train_gpt default flags: losses %s" % losses)
  res = {"layers": cfg.num_layers, "d_model": cfg.d_model,
         "heads": cfg.num_heads, "head_dim": cfg.head_dim,
         "seq": args.seq_len, "batch": args.batch, "vocab": args.vocab,
         "steps": GPT_DEFAULT_STEPS, "losses": losses,
         "wall_s_with_first_step": wall, "launches_per_step": per}
  log("  %d layers, d_model %d, %d heads (head_dim %d), B%d x S%d: losses %s"
      "; %d steps in %.2f s (first step and reader start included); "
      "launches per step %s" % (cfg.num_layers, cfg.d_model, cfg.num_heads,
                                cfg.head_dim, args.batch, args.seq_len,
                                " ".join("%.4f" % x for x in losses),
                                GPT_DEFAULT_STEPS, wall, per))
  return res


# the JAX package's examples/transformer/serve_gpt.py config: head_dim 32,
# 2 KV heads
SERVE_GPT_CFG = dict(vocab_size=256, num_layers=2, num_heads=4,
                     num_kv_heads=2, d_model=128, d_ff=256, max_seq_len=64)


def serve_gpt_config(torch, ops, tfm, ServingEngine, init_params):
  """One request through ServingEngine at serve_gpt's config: in bf16 with
  the flash forward's launches counted, and in f32 (TF32 off) equal to the
  single-request greedy_generate_kv decode."""
  import numpy as np
  prompt = np.random.default_rng(SEED + 13).integers(1, 256, size=20)
  res = {}
  for dt in ("bfloat16", "float32"):
    cfg = tfm.TransformerConfig(dtype=getattr(torch, dt), remat=False,
                                **SERVE_GPT_CFG)
    eng = ServingEngine(init_params(cfg, seed=SEED), cfg, num_slots=2,
                        horizon=4).start()
    try:
      ops.reset_launches()
      out = eng.generate([prompt], max_new_tokens=16, timeout=600)[0]
      torch.cuda.synchronize()
      launches = dict(ops.LAUNCHES)
    finally:
      eng.stop()
    if len(out) != len(prompt) + 16 or not (out[:len(prompt)] == prompt).all() \
        or out.min() < 0 or out.max() >= cfg.vocab_size:
      raise AssertionError("serve_gpt config %s: bad output %s" % (dt, out))
    if launches["flash_attention_fwd"] != cfg.num_layers:
      raise AssertionError("serve_gpt config %s: flash forward launched %d "
                           "times, one prefill of %d layers needs %d"
                           % (dt, launches["flash_attention_fwd"],
                              cfg.num_layers, cfg.num_layers))
    if dt == "float32":
      ref = tfm.greedy_generate_kv(eng.model, prompt[None], 16)
      ref = ref.cpu().numpy()[0]
      if not (ref == out).all():
        raise AssertionError("serve_gpt config f32: engine %s vs "
                             "greedy_generate_kv %s" % (out, ref))
    res[dt] = {"prompt_len": len(prompt), "tokens": out.tolist(),
               "launches": {k: v for k, v in launches.items() if v}}
    log("  serve_gpt config %s (head_dim %d, Hk %d): %d tokens out, "
        "launches %s%s" % (dt, cfg.head_dim, cfg.num_kv_heads, len(out),
                           res[dt]["launches"],
                           ", equal to greedy_generate_kv" if dt == "float32"
                           else ""))
  return res


def train_parity_f32(torch, tfm, init_params, **kw):
  """One step's loss and gradients of a 2-layer full-width f32 model
  (``TransformerConfig(**kw)``) on a 2 x 256 batch: the card with the
  kernels against the CPU with the plain versions, from the same weights
  (TF32 off)."""
  cfg = tfm.TransformerConfig(dtype=torch.float32, num_layers=2, **kw)
  params = init_params(cfg, seed=SEED)
  tokens = torch.from_numpy(_synthetic_batch(2, 256, cfg.vocab_size))
  out = {}
  for where in ("cuda", "cpu"):
    model = tfm.Transformer(cfg, params, device=None if where == "cuda"
                            else "cpu", trainable=True)
    loss = tfm.causal_lm_loss(model(tokens), tokens.to(model.device))
    names, weights = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, weights)
    out[where] = (float(loss.detach()), {n: g.detach().cpu()
                                for n, g in zip(names, grads)})
  (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
  rel = abs(lc - lh) / abs(lh)
  if rel > 1e-4:
    raise AssertionError("f32 training loss: card %.7f vs CPU %.7f (rel "
                         "%.3g > 1e-4)" % (lc, lh, rel))
  worst, worst_name = 0.0, None
  for name, want in gh.items():
    err = (gc[name] - want).abs().max().item()
    ratio = err / max(want.abs().max().item(), 1e-30)
    if ratio > 1e-3:
      raise AssertionError("f32 gradient %s: card vs CPU max abs err %.3g is "
                           "%.3g of its max |value| (> 1e-3)"
                           % (name, err, ratio))
    if ratio >= worst:
      worst, worst_name = ratio, name
  log("  f32 training parity: loss card %.7f CPU %.7f (rel %.2g); worst "
      "gradient %s at %.3g of its max |value|, over %d tensors"
      % (lc, lh, rel, worst_name, worst, len(gh)))
  return {"loss_card": lc, "loss_cpu": lh, "loss_rel_diff": rel,
          "worst_grad": worst_name, "worst_grad_rel": worst,
          "tensors": len(gh)}


def serving_only(torch, ops, tfm, ServingEngine, slots, init_params,
                 repeats):
  """The serving main path ``repeats`` times, then the host side of the
  prefill: microseconds from entering to leaving one flash-forward wrapper
  call (no synchronise inside; the median of 200) at the first chunk sizes
  16 and 512, and the wall ms of a whole 512-token prefill chunk (median of
  10, synchronised)."""
  cfg = tfm.TransformerConfig()
  params = init_params(cfg, seed=SEED)
  runs = []
  for _ in range(repeats):
    res, model = serve_main_path(torch, ops, tfm, ServingEngine, slots,
                                 params, cfg)
    runs.append({k: res[k] for k in ("tokens_per_s", "ttft_ms_p50",
                                     "ttft_ms_p99", "decode_ms_per_step")})
  g = torch.Generator(device="cuda").manual_seed(SEED + 11)
  host_us = {}
  for s in (16, 512):
    q, k, v = (torch.randn(1, s, cfg.num_heads, cfg.head_dim, device="cuda",
                           generator=g).to(torch.bfloat16) for _ in range(3))
    for _ in range(10):
      ops.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    times = []
    for _ in range(200):
      t0 = time.perf_counter()
      ops.flash_attention_fwd(q, k, v)
      times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    host_us["S%d" % s] = statistics.median(times)
  dec = slots.SlotDecoder(model, 8)
  prompt = _prompts((512,), cfg.vocab_size, SEED + 4)[0]
  walls = []
  with torch.inference_mode():
    for _ in range(12):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      dec.prefill(prompt)
      torch.cuda.synchronize()
      walls.append((time.perf_counter() - t0) * 1e3)
  out = {"runs": runs, "flash_fwd_host_us": host_us,
         "prefill_512_wall_ms": statistics.median(walls[2:]),
         "tokens_per_s": [r["tokens_per_s"] for r in runs]}
  log("  tokens/s %s; flash fwd host us %s; 512-token prefill chunk wall "
      "%.2f ms" % (", ".join("%.1f" % x for x in out["tokens_per_s"]),
                   ", ".join("%s %.1f" % kv for kv in host_us.items()),
                   out["prefill_512_wall_ms"]))
  log(json.dumps({"serving_only": out}))
  return 0


def serving_ab(torch, ops, tfm, ServingEngine, slots, init_params, other,
               rounds):
  """[4] in ONE process for two checkouts' packages, so the spread
  between processes (10-20% of [4]'s tokens/s) stays out of the
  comparison: ``other``'s package is copied under ``build/serving_ab``
  as ``tensorflowonspark_tpu_torch_ab`` (its own imports renamed) and
  its kernels built there; [4] then alternates other / this / this /
  other ``rounds`` times. Prints every run's tokens/s and decode ms a
  step and each side's median and quartiles as one JSON line."""
  import importlib
  import re
  name = "tensorflowonspark_tpu_torch_ab"
  root = os.path.join(HERE, "build", "serving_ab")
  shutil.rmtree(root, ignore_errors=True)
  shutil.copytree(os.path.join(other, "tensorflowonspark_tpu_torch"),
                  os.path.join(root, name),
                  ignore=shutil.ignore_patterns("__pycache__"))
  for d, _, files in os.walk(os.path.join(root, name)):
    for f in files:
      if f.endswith(".py"):
        with open(os.path.join(d, f)) as fh:
          text = re.sub(r"\btensorflowonspark_tpu_torch\b", name, fh.read())
        with open(os.path.join(d, f), "w") as fh:
          fh.write(text)
  sys.path.insert(0, root)
  mod = lambda m: importlib.import_module(name + m)  # noqa: E731
  log("  built %s's kernels %s" % (other, mod(".ops._build").build_all()))
  sides = {"other": (mod(".ops"), mod(".models.transformer"),
                     mod(".serving").ServingEngine, mod(".serving.slots")),
           "this": (ops, tfm, ServingEngine, slots)}
  params = init_params(tfm.TransformerConfig(), seed=SEED)
  runs = {"other": [], "this": []}
  for side in ("other", "this", "this", "other") * rounds:
    o, t, e, s = sides[side]
    res, _ = serve_main_path(torch, o, t, e, s, params, t.TransformerConfig())
    runs[side].append((res["tokens_per_s"], res["decode_ms_per_step"]))
  out = {"other_checkout": other}
  for side, v in runs.items():
    tps = [r[0] for r in v]
    out[side] = {"tokens_per_s": tps, "median": statistics.median(tps),
                 "quartiles": statistics.quantiles(tps, n=4),
                 "decode_ms_per_step": [r[1] for r in v]}
  log(json.dumps({"serving_ab": out}))
  return 0


def layer_norm_only(torch, ops, F):
  """Phase 3's LayerNorm forward and backward checks, then their device
  times; prints them as one JSON line."""
  ln_rows, _ = check_layer_norm(ops, torch, F)
  lnb_rows, _ = check_layer_norm_bwd(ops, torch, F)
  layer_norm_device_ms(ops, torch, F, ln_rows, lnb_rows)
  log(json.dumps({"layer_norm_only": {"layer_norm": ln_rows,
                                      "layer_norm_bwd": lnb_rows}}))
  return 0


def cluster_only(torch):
  """``--cluster-only``: phase 6h alone, after 6d's TFRecord files."""
  pattern = write_token_files(os.path.join(HERE, "build", "chip_smoke_tokens"),
                              32000, LONG_S)
  log("[6h] train_gpt through cluster.run(LocalEngine(1), ..., "
      "InputMode.TENSORFLOW, chips_per_node=1)")
  res = cluster_long_gqa(torch, pattern)
  card = card_line()
  log(card)
  log(json.dumps({"cluster": res, "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


def ckpt_only(torch):
  """``--ckpt-only``: phase 6k alone, after 6d's TFRecord files."""
  pattern = write_token_files(os.path.join(HERE, "build", "chip_smoke_tokens"),
                              32000, LONG_S)
  log("[6k] train_gpt checkpointed under cluster.run(LocalEngine(1), ..., "
      "InputMode.FILES), SIGKILLed after step 2, resumed")
  res = ckpt_resume(torch, pattern)
  card = card_line()
  log(card)
  log(json.dumps({"ckpt": res, "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


def feed_only(torch, ops, tfm, init_params, card):
  """``--feed-only``: phases 6i and 6j alone."""
  cfg = tfm.TransformerConfig()
  res = feed_phases(torch, ops, tfm, torch.cuda.get_device_name(0),
                    init_params(cfg, seed=SEED), cfg)
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out", "chip_smoke_feed.json"),
            "w") as f:
    json.dump({"feed": res, "card": card}, f, indent=1)
  log(card)
  log(json.dumps({"feed": {
      "ms_per_step": res["train"]["ms_per_step"],
      "direct_ms_per_step": [res["train"][k]["ms_per_step"]
                             for k in ("direct", "direct_after")],
      "slab_ms_per_step": res["train"]["slab_ms_per_step"],
      "direct_slab_ms_per_step": [res["train"][k]["slab_ms_per_step"]
                                  for k in ("direct", "direct_after")],
      "ceiling_rows_per_s": {k: v["rows_per_s"] for k, v in
                             res["train"]["ceiling"].items()},
      "inference_rows_per_s": res["inference"]["rows_per_s"]},
      "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


def train_options_only(torch, ops, sharding, readers, train_gpt, _build,
                       card):
  """``--train-options-only``: phase 6n alone, after the build."""
  t0 = time.monotonic()
  build_s = _build.build_all()
  log("  built %s in %.1f s wall" % (
      ", ".join("%s %.1fs" % kv for kv in build_s.items()),
      time.monotonic() - t0))
  res = train_options(torch, ops, sharding, readers, train_gpt)
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out",
                         "chip_smoke_train_options.json"), "w") as f:
    json.dump({"train_options": res, "card": card}, f, indent=1)
  log(card)
  log(json.dumps({"train_options": options_summary(res), "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


def obs_only(torch, ops, tfm, ServingEngine, slots, init_params, _build,
             card):
  """``--obs-only``: phase 6o alone, with its obs-off references made here
  and OBS_PAIRS interleaved off/on fed runs for the overhead (the driver
  builds every kernel first; the executors load them)."""
  log("  built %s" % _build.build_all())
  cfg = tfm.TransformerConfig()
  res = obs_phase(torch, ops, tfm, ServingEngine, slots, card,
                  init_params(cfg, seed=SEED), cfg, pairs=OBS_PAIRS)
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out", "chip_smoke_obs.json"),
            "w") as f:
    json.dump({"obs": res, "card": card}, f, indent=1)
  log(card)
  log(json.dumps({"obs": {
      "ms_per_step_on": res["feed_on"]["timed_ms_per_step"],
      "ms_per_step_off": res["feed_off"]["timed_ms_per_step"],
      "overhead_median": res["overhead"]["median"],
      "overhead_per_pair": res["overhead"]["per_pair"],
      "feed_stage_share": res["gates"]["stage_share"],
      "mfu_on": res["mfu_on"],
      "serve_counts": res["serve"]["obs"]["counts"]}, "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


def fleet_only(torch, ops, tfm, ServingEngine, slots, init_params, _build,
               card):
  """``--fleet-only``: phase 6p alone, at [4]'s sizes (the driver builds
  every kernel first)."""
  log("  built %s" % _build.build_all())
  cfg = tfm.TransformerConfig()
  t0 = time.monotonic()
  res = fleet_phase(torch, ops, tfm, ServingEngine, slots, card,
                    init_params(cfg, seed=SEED), cfg)
  res["total_s"] = time.monotonic() - t0
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out", "chip_smoke_fleet.json"),
            "w") as f:
    json.dump(res, f, indent=1)
  log(card)
  log(json.dumps({"fleet": fleet_summary(res), "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


def deploy_only(torch, ops, tfm, ServingEngine, slots, init_params, _build,
                card):
  """``--deploy-only``: phase 6q alone, at [4]'s sizes (the driver builds
  every kernel first; the hosts load them)."""
  log("  built %s" % _build.build_all())
  cfg = tfm.TransformerConfig()
  res = deploy_phase(torch, ops, tfm, ServingEngine, slots, card,
                     init_params, cfg)
  os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
  with open(os.path.join(HERE, "chiprun_out", "chip_smoke_deploy.json"),
            "w") as f:
    json.dump(res, f, indent=1)
  log(card)
  log(json.dumps({"deploy": deploy_summary(res), "card": card}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


def fleet_summary(res):
  """[6p]'s numbers for one JSON line."""
  keys = ("tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "peak_mem_gib")
  return {"bare": {k: res["bare"][k] for k in keys + (
      "decode_ms_per_step",)},
          "fleet": {k: res["fleet"][k] for k in keys + (
              "prefills_by_replica", "decode_ms_per_step_by_replica")},
          "failover": {k: res["failover"][k] for k in (
              "kill_to_last_replay_s", "failovers", "replayed_requests",
              "shed", "replay_mismatches", "streamed_tokens",
              "streamed_hop", "alerts")},
          "swap": {k: res["swap"][k] for k in ("swap_s", "swapped", "shed")},
          "crash_replay": {k: res["crash_replay"][k] for k in (
              "engine_restarts", "replayed_requests")},
          "launches": {k: fleet_launches(res, k) for k in (
              "flash_attention_fwd", "layer_norm")}}


def main(argv):
  repeats, ln_only = 0, argv == ["--layer-norm-only"]
  only_cluster = argv == ["--cluster-only"]
  only_feed = argv == ["--feed-only"]
  only_ckpt = argv == ["--ckpt-only"]
  only_dp = argv == ["--dp-only"]
  only_pipeline = argv == ["--pipeline-only"]
  only_options = argv == ["--train-options-only"]
  only_obs = argv == ["--obs-only"]
  only_fleet = argv == ["--fleet-only"]
  only_deploy = argv == ["--deploy-only"]
  only_decode = argv == ["--decode-stack-only"]
  only_spmd = argv == ["--spmd-only"]
  only_ppep = argv == ["--pp-ep-only"]
  only_groups = argv == ["--groups-only"]
  only_cut = argv == ["--cut-ckpt-only"]
  only_serving_mesh = argv == ["--serving-mesh-only"]
  ab = argv[1:] if argv[:1] == ["--serving-ab"] and len(argv) == 3 else None
  if argv[:1] == ["--serving-only"] and len(argv) == 2:
    repeats = int(argv[1])
  elif argv and ab is None and not (ln_only or only_cluster or only_feed or only_ckpt
                     or only_dp or only_pipeline or only_options
                     or only_obs or only_fleet or only_deploy
                     or only_decode or only_spmd or only_ppep
                     or only_groups or only_cut or only_serving_mesh):
    log("usage: python3 chip_smoke.py [--serving-only N | "
        "--serving-ab OTHER_CHECKOUT N | "
        "--layer-norm-only | --cluster-only | --feed-only | --ckpt-only | "
        "--dp-only | --pipeline-only | --train-options-only | --obs-only | "
        "--fleet-only | --deploy-only | --decode-stack-only | --spmd-only | "
        "--pp-ep-only | --groups-only | --cut-ckpt-only | "
        "--serving-mesh-only]")
    return 2
  cache_bytecode()
  try:
    import torch
    import torch.nn.functional as F
  except ImportError as e:
    log("chip_smoke: FAIL: PyTorch is not importable: %s" % e)
    return 2
  if not torch.cuda.is_available():
    log("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() is "
        "False)")
    return 2
  sys.path.insert(0, HERE)
  try:
    from tensorflowonspark_tpu_torch import ops, optim
    from tensorflowonspark_tpu_torch.data import readers
    from tensorflowonspark_tpu_torch.data.readers import Slab
    from tensorflowonspark_tpu_torch.examples import train_gpt
    from tensorflowonspark_tpu_torch.models import transformer as tfm
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.parallel import sharding
    from tensorflowonspark_tpu_torch.serving import ServingEngine, slots
    from tensorflowonspark_tpu_torch.utils.params import init_params
  except ImportError as e:
    log("chip_smoke: FAIL: the port is not next to chip_smoke.py: %s" % e)
    return 2
  t_start = time.monotonic()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  log("[1] card")
  card = card_line()
  log(card)
  log("  torch %s, CUDA %s, %s x%d" % (
      torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
      torch.cuda.device_count()))

  if only_cluster:
    return cluster_only(torch)
  if only_feed:
    return feed_only(torch, ops, tfm, init_params, card)
  if only_ckpt:
    return ckpt_only(torch)
  if only_dp:
    return dp_only(torch, ops, tfm, optim, sharding, Slab, train_gpt,
                   init_params, card)
  if only_pipeline:
    return pipeline_only(torch, _build, card)
  if only_options:
    return train_options_only(torch, ops, sharding, readers, train_gpt,
                              _build, card)
  if only_obs:
    return obs_only(torch, ops, tfm, ServingEngine, slots, init_params,
                    _build, card)
  if only_deploy:
    return deploy_only(torch, ops, tfm, ServingEngine, slots, init_params,
                       _build, card)
  if only_decode:
    return decode_stack_only(torch, ops, tfm, ServingEngine, init_params,
                             _build, card)
  if only_fleet:
    return fleet_only(torch, ops, tfm, ServingEngine, slots, init_params,
                      _build, card)
  if only_spmd or only_ppep:
    return spmd_only(torch, ops, F, _build, card, spmd=only_spmd)
  if only_cut:
    return spmd_only(torch, ops, F, _build, card, only=CUT_CKPT_CASES)
  if only_serving_mesh:
    return spmd_only(torch, ops, F, _build, card,
                     only=(CUT_CKPT_EXPORT, "t_d_moe_e4_a2a"),
                     tag="serving_mesh")
  if only_groups:
    return groups_only(torch, ops, tfm, optim, _build, card, init_params)

  log("[2] build")
  t0 = time.monotonic()
  build_s = _build.build_all()
  log("  built %s in %.1f s wall" % (
      ", ".join("%s %.1fs" % kv for kv in build_s.items()),
      time.monotonic() - t0))
  for name, text in sorted(_build.BUILD_LOG.items()):
    for line in text.splitlines():
      # register use, spills, and wgmma products ptxas had to serialize
      if "Used" in line or "spill" in line or "Performance Loss" in line:
        log("  ptxas %s: %s" % (name, line.strip()))
  if ab is not None:
    log("[4] serving main path, %s's package and this one alternated in one "
        "process, %s rounds" % tuple(ab))
    return serving_ab(torch, ops, tfm, ServingEngine, slots, init_params,
                      ab[0], int(ab[1]))
  if repeats:
    log("[4] serving main path x%d, then the prefill's host time" % repeats)
    return serving_only(torch, ops, tfm, ServingEngine, slots, init_params,
                        repeats)
  if ln_only:
    log("[3] the LayerNorm kernels alone, with device times")
    return layer_norm_only(torch, ops, F)
  spills = tensor_core_spills(_build.BUILD_LOG)
  sass = sass_counts(_build)

  log("[3] kernels against their plain versions")
  ln_rows, ln_err = check_layer_norm(ops, torch, F)
  fa_rows, fa_err = check_flash(ops, torch, F)
  lnb_rows, lnb_err = check_layer_norm_bwd(ops, torch, F)
  fab_rows, fab_err = check_flash_bwd(ops, torch, F)
  split_rows, split_err = check_flash_bwd_split(ops, torch, F)
  fm_rows, fm_err = check_fused_matmul(ops, torch, F)
  torch.cuda.empty_cache()
  for what, row, lib, yard in (
      ("flash fwd B16 S1024", pick(fa_rows, case="train"), "library_ms",
       "SDPA"),
      ("flash fwd B1 S16384 Hk4", pick(fa_rows, case="long"), "library_ms",
       "SDPA"),
      ("fused bwd B16 S1024", pick(fab_rows, case="train"), "library_ms",
       "SDPA bwd"),
      ("fused bwd B8 S1024 Hk4", pick(fab_rows, case="gqa_hk4"),
       "library_ms", "SDPA bwd"),
      ("split dK/dV B16 S1024", pick(split_rows, case="train", kernel="dkv"),
       "library_whole_bwd_ms", "SDPA whole bwd"),
      ("split dK/dV B1 S16384 Hk4", pick(split_rows, case="long",
                                         kernel="dkv"),
       "library_whole_bwd_ms", "SDPA whole bwd"),
      ("split dQ B16 S1024", pick(split_rows, case="train", kernel="dq"),
       "library_whole_bwd_ms", "SDPA whole bwd"),
      ("split dQ B1 S16384 Hk4", pick(split_rows, case="long", kernel="dq"),
       "library_whole_bwd_ms", "SDPA whole bwd"),
      ("GELU->matmul 16384x3072x768", pick(fm_rows, op="gelu_matmul",
                                           case="down"),
       "library_ms", "F.gelu + matmul"),
      ("LN->matmul 16384x768x2304", pick(fm_rows, op="ln_matmul",
                                         case="qkv"),
       "library_ms", "F.layer_norm + matmul"),
      ("LN->matmul 16384x768x3072", pick(fm_rows, op="ln_matmul", case="up"),
       "library_ms", "F.layer_norm + matmul"),
      ("LN bwd 16384x768", pick(lnb_rows, rows=16384, dtype="bfloat16"),
       "library_ms", "LayerNorm bwd")):
    log("  %-26s %.4f ms = %.2f x %s (%.4f ms), %.1f%% of bound"
        % (what, row["ms"], row["ms"] / row[lib], yard, row[lib],
           100.0 * row["bound_ms"] / row["ms"]))

  log("[3b] head dims 32 and 96: forward, fused and split backward")
  hd_rows, hd_err = check_head_dims(ops, torch, F)

  log("[4] main path: full-width ServingEngine, bf16")
  t0 = time.monotonic()
  cfg = tfm.TransformerConfig()
  params = init_params(cfg, seed=SEED)
  log("  weights from seed %d in %.1f s" % (SEED, time.monotonic() - t0))
  main_res, model = serve_main_path(torch, ops, tfm, ServingEngine, slots,
                                    params, cfg)

  log("[4b] where the main path's time goes (torch.profiler)")
  with torch.inference_mode():
    prof_res = profile_serving(torch, slots, model)
  del model

  log("[5] parity: full width, f32, engine vs greedy_generate_kv")
  parity = serve_parity_f32(torch, tfm, ServingEngine, params,
                            tfm.TransformerConfig(dtype=torch.float32))
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.cuda.empty_cache()

  log("[6] main path: full-width training, bf16, B%d x S%d"
      % (TRAIN_B, TRAIN_S))
  train_res = train_main_path(torch, ops, tfm, optim, sharding, Slab, params,
                              cfg, WANT_PER_STEP)
  torch.cuda.empty_cache()

  log("[6b] grouped-KV training: num_kv_heads 4, full width and depth")
  gqa_res = train_gqa(torch, ops, tfm, optim, sharding, init_params,
                      WANT_PER_STEP)
  torch.cuda.empty_cache()

  log("[6c] all-fused training (fuse_qkv + ln_matmul + gelu_matmul), bf16, "
      "B%d x S%d" % (TRAIN_B, TRAIN_S))
  fcfg = tfm.TransformerConfig(**ALL_FUSED)
  fused_res = train_main_path(torch, ops, tfm, optim, sharding, Slab,
                              init_params(fcfg, seed=SEED), fcfg,
                              WANT_FUSED_PER_STEP)
  for path in ("per_step", "fused_loop"):
    log("  %-10s unfused [6] %.1f ms/step %.0f tokens/s | all-fused %.1f "
        "ms/step %.0f tokens/s" % (
            path, train_res[path]["ms_per_step"],
            train_res[path]["tokens_per_s"], fused_res[path]["ms_per_step"],
            fused_res[path]["tokens_per_s"]))
  log("  peak memory: unfused %.2f GiB, all-fused %.2f GiB"
      % (train_res["peak_mem_gib"], fused_res["peak_mem_gib"]))
  torch.cuda.empty_cache()
  fgqa_res = train_gqa(torch, ops, tfm, optim, sharding, init_params,
                       WANT_FUSED_PER_STEP, **ALL_FUSED)
  torch.cuda.empty_cache()
  log("  device time of phase 3's fused products and LayerNorm kernels "
      "(torch.profiler)")
  fused_device_ms(ops, torch, F, fm_rows)
  layer_norm_device_ms(ops, torch, F, ln_rows, lnb_rows)
  torch.cuda.empty_cache()

  log("[6d] long-context grouped-KV training from TFRecords: train_gpt "
      "--kv_heads 4 --seq_len %d --batch %d, bf16" % (LONG_S, LONG_B))
  long_res = train_long_gqa(torch, ops, sharding, readers, train_gpt)
  torch.cuda.empty_cache()

  log("[6h] the same through cluster.run(LocalEngine(1), ..., "
      "InputMode.TENSORFLOW, chips_per_node=1)")
  cluster_res = cluster_long_gqa(torch, long_res["data"], long_res)
  torch.cuda.empty_cache()

  log("[6k] the same checkpointed under cluster.run(LocalEngine(1), ..., "
      "InputMode.FILES), SIGKILLed after step 2, resumed")
  ckpt_res = ckpt_resume(torch, long_res["data"], long_res)
  torch.cuda.empty_cache()

  log("[6n] [6d] with Adafactor and remat off / none / dots, from "
      "TFRecords framed by the native codec")
  options_res = train_options(torch, ops, sharding, readers, train_gpt)
  torch.cuda.empty_cache()
  feed_res = feed_phases(torch, ops, tfm, torch.cuda.get_device_name(0),
                         params, cfg, train_res)
  torch.cuda.empty_cache()
  obs_res = obs_phase(torch, ops, tfm, ServingEngine, slots, card, params,
                      cfg, feed_ref=feed_res["train"], serve_ref=main_res)
  torch.cuda.empty_cache()
  log("[6p] the serving fleet: [4]'s requests over %d replicas sharing the "
      "card, a replica killed, a rolling swap, a crash replay"
      % FLEET_REPLICAS)
  fleet_res = fleet_phase(torch, ops, tfm, ServingEngine, slots, card, params,
                          cfg, serve_ref=main_res)
  torch.cuda.empty_cache()
  log("[6q] the registry, the deploy controller and cross-host serving: "
      "[4]'s requests over %d ServingHost processes, v2 canaried and "
      "promoted, a poisoned v3 rolled back, a host killed mid-decode"
      % DEPLOY_HOSTS)
  deploy_res = deploy_phase(torch, ops, tfm, ServingEngine, slots, card,
                            init_params, cfg, serve_ref=main_res)
  log("  [6q] %s" % json.dumps(deploy_summary(deploy_res)))
  dp_res = dp_phases(
      torch, ops, tfm, optim, sharding, Slab, train_gpt, params, cfg,
      then=lambda engine: groups_phase(torch, ops, tfm, optim, card, params,
                                       cfg, engine=engine))
  groups_res = dp_res.pop("then")
  torch.cuda.empty_cache()
  spmd_res = spmd_phase(torch, ops, F, long_res["data"],
                        drawn=[(cfg, SEED, params)])
  torch.cuda.empty_cache()
  log("[6m] the pipeline layer: TFEstimator.fit -> export_bundle -> "
      "TFModel.transform, the runner, the CLI and the examples")
  pipe_res = pipeline_phase(torch, torch.cuda.get_device_name(0))
  torch.cuda.empty_cache()

  log("[6e] the flagship MHA under TFOS_TPU_FLASH_BWD=split, B%d x S%d"
      % (TRAIN_B, TRAIN_S))
  with flash_bwd_env("split"):
    split_res = train_main_path(torch, ops, tfm, optim, sharding, Slab,
                                params, cfg, WANT_SPLIT_PER_STEP)
  for path in ("per_step", "fused_loop"):
    log("  %-10s fused plan [6] %.1f ms/step | split plan %.1f ms/step"
        % (path, train_res[path]["ms_per_step"],
           split_res[path]["ms_per_step"]))
  torch.cuda.empty_cache()

  log("[6f] train_gpt at its default model flags (head_dim 32) from "
      "TFRecords")
  gpt_res = train_gpt_defaults(torch, ops, train_gpt)
  torch.cuda.empty_cache()

  log("[6g] one request at serve_gpt's config (head_dim 32, 2 KV heads)")
  serve_gpt_res = serve_gpt_config(torch, ops, tfm, ServingEngine,
                                   init_params)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.cuda.empty_cache()

  log("[7] parity: f32 training step, card kernels vs CPU plain versions")
  train_parity = train_parity_f32(torch, tfm, init_params)
  fused_parity = train_parity_f32(torch, tfm, init_params, **ALL_FUSED)
  with flash_bwd_env("split"):
    split_parity = train_parity_f32(torch, tfm, init_params)
    split_gqa_parity = train_parity_f32(torch, tfm, init_params,
                                        num_kv_heads=4)
  torch.cuda.empty_cache()

  log("[6r] the decode-speed stack: the int8 cache, the paged slab with the "
      "shared-prefix cache and self-speculative decode, %d requests over %d "
      "system prompts" % (DECODE_REQUESTS, DECODE_PREFIXES))
  decode_res = decode_stack_phase(torch, ops, tfm, ServingEngine, card,
                                  params, cfg)
  log("  [6r] %s" % json.dumps(decode_summary(decode_res)))

  def launches(res, steps, name):
    return int(res["launches_per_step"][name] * steps)

  def cluster_launches(name):
    return sum(step[name] for step in cluster_res["launches_per_step"])

  def ckpt_launches(name):
    return sum(step[name] for step in ckpt_res["launches_per_step"])

  def feed_launches(name):
    per = feed_res["train"]["launches_per_step"]
    return int(sum(p[name] for p in per[:FEED_PER_STEP]) + FEED_UNROLL * sum(
        p[name] for p in per[FEED_PER_STEP:]))

  def infer_launches(name):
    return sum(p[name] for p in feed_res["inference"]["launches_per_forward"])

  def obs_launches(name):
    per = obs_res["feed_on"]["launches_per_step"]
    return int(sum(p[name] for p in per[:FEED_PER_STEP]) + FEED_UNROLL * sum(
        p[name] for p in per[FEED_PER_STEP:]))

  def entry(name, source, replaces, by_path, err, row, **extra):
    return dict({"name": name, "route": "cuda",
                 "source": "tensorflowonspark_tpu_torch/csrc/" + source,
                 "replaces": "tensorflowonspark_tpu/ops/" + replaces,
                 "launches": max(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": err, "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"]}, **extra)

  serve_l = main_res["launches"]
  step_l = {n: int(v * 4) for n, v in
            train_res["per_step"]["launches_per_step"].items()}
  fused_l = {n: int(v * 4) for n, v in
             fused_res["per_step"]["launches_per_step"].items()}
  split_l = {n: int(v * 4) for n, v in
             split_res["per_step"]["launches_per_step"].items()}
  fa_train, fa_long = pick(fa_rows, case="train"), pick(fa_rows, case="long")
  kernels = [
      entry("flash_attention_fwd", "flash_attention.cu",
            "flash_attention.py:124",
            {"serve": serve_l["flash_attention_fwd"],
             "train_4_steps": step_l["flash_attention_fwd"],
             "train_fused_4_steps": fused_l["flash_attention_fwd"],
             "train_long_gqa_2_steps": launches(long_res, 2,
                                                "flash_attention_fwd"),
             "cluster_train_gpt_long_4_steps": cluster_launches(
                 "flash_attention_fwd"),
             "ckpt_resume_%d_steps" % CKPT_STEPS: ckpt_launches("flash_attention_fwd"),
             **options_launches(options_res, "flash_attention_fwd"),
             "feed_train_12_steps": feed_launches("flash_attention_fwd"),
             "feed_inference_4_forwards": infer_launches(
                 "flash_attention_fwd"),
             "obs_feed_train_12_steps": obs_launches("flash_attention_fwd"),
             "obs_serve": obs_res["serve"]["launches"][
                 "flash_attention_fwd"],
             **fleet_launches(fleet_res, "flash_attention_fwd"),
             "deploy_2_hosts": deploy_res["served"]["launches"][
                 "flash_attention_fwd"],
             **decode_launches(decode_res, "flash_attention_fwd"),
             "train_gpt_defaults_%d_steps" % GPT_DEFAULT_STEPS: launches(
                 gpt_res, GPT_DEFAULT_STEPS, "flash_attention_fwd"),
             "serve_gpt_config_bf16": serve_gpt_res["bfloat16"]["launches"][
                 "flash_attention_fwd"],
             **dp_launches(dp_res, "flash_attention_fwd"),
             **groups_launches(groups_res, "flash_attention_fwd"),
             **spmd_launches(spmd_res, "flash_attention_fwd"),
             **pipe_launches(pipe_res, "flash_attention_fwd")},
            max(fa_err, hd_err["fwd"], spmd_res["max_abs_err"]),
            pick(fa_rows, case="s512"),
            ring_blocks=spmd_kernel_rows(spmd_res, "flash_attention_fwd"),
            design="wgmma+tma", head_dims="8..128 (d % 8 == 0)",
            train={k: fa_train[k] for k in ("ms", "plain_ms", "library_ms",
                                            "bound_ms")},
            long={k: fa_long[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms")}),
      entry("layer_norm", "layer_norm.cu", "layer_norm.py:33",
            {"serve": serve_l["layer_norm"],
             "train_4_steps": step_l["layer_norm"],
             "train_fused_4_steps": fused_l["layer_norm"],
             "cluster_train_gpt_long_4_steps": cluster_launches("layer_norm"),
             "ckpt_resume_%d_steps" % CKPT_STEPS: ckpt_launches("layer_norm"),
             **options_launches(options_res, "layer_norm"),
             "feed_train_12_steps": feed_launches("layer_norm"),
             "feed_inference_4_forwards": infer_launches("layer_norm"),
             "obs_feed_train_12_steps": obs_launches("layer_norm"),
             "obs_serve": obs_res["serve"]["launches"]["layer_norm"],
             **fleet_launches(fleet_res, "layer_norm"),
             "deploy_2_hosts": deploy_res["served"]["launches"]["layer_norm"],
             **decode_launches(decode_res, "layer_norm"),
             "train_gpt_defaults_%d_steps" % GPT_DEFAULT_STEPS: launches(
                 gpt_res, GPT_DEFAULT_STEPS, "layer_norm"),
             **dp_launches(dp_res, "layer_norm"),
             **groups_launches(groups_res, "layer_norm"),
             **spmd_launches(spmd_res, "layer_norm"),
             **pipe_launches(pipe_res, "layer_norm")},
            ln_err, pick(ln_rows, rows=512, dtype="bfloat16"),
            train={k: pick(ln_rows, rows=16384)[k]
                   for k in ("ms", "device_ms", "library_ms", "bound_ms")}),
      entry("flash_attention_bwd", "flash_attention_bwd.cu",
            "flash_attention.py:232",
            {"train_4_steps": step_l["flash_attention_bwd"],
             "train_fused_4_steps": fused_l["flash_attention_bwd"],
             "feed_train_12_steps": feed_launches("flash_attention_bwd"),
             "obs_feed_train_12_steps": obs_launches("flash_attention_bwd"),
             "train_gpt_defaults_%d_steps" % GPT_DEFAULT_STEPS: launches(
                 gpt_res, GPT_DEFAULT_STEPS, "flash_attention_bwd"),
             **dp_launches(dp_res, "flash_attention_bwd"),
             **groups_launches(groups_res, "flash_attention_bwd"),
             **spmd_launches(spmd_res, "flash_attention_bwd"),
             **pipe_launches(pipe_res, "flash_attention_bwd")},
            max(fab_err, hd_err["bwd"]), pick(fab_rows, case="train"),
            design="wgmma+tma", head_dims="8..128 (d % 8 == 0)",
            ring_blocks=spmd_kernel_rows(spmd_res, "flash_attention_bwd")),
      entry("flash_attention_bwd_gqa", "flash_attention_bwd.cu",
            "flash_attention.py:332",
            {"train_gqa_2_steps": launches(gqa_res, 2,
                                           "flash_attention_bwd_gqa"),
             "train_fused_gqa_2_steps": launches(fgqa_res, 2,
                                                 "flash_attention_bwd_gqa"),
             **spmd_launches(spmd_res, "flash_attention_bwd_gqa")},
            max(fab_err, hd_err["bwd"]), pick(fab_rows, case="gqa_hk4"),
            design="wgmma+tma", head_dims="8..128 (d % 8 == 0)",
            ring_blocks=spmd_kernel_rows(spmd_res,
                                         "flash_attention_bwd_gqa")),
      entry("layer_norm_bwd", "layer_norm.cu", "layer_norm.py:40",
            {"train_4_steps": step_l["layer_norm_bwd"],
             "train_fused_4_steps": fused_l["layer_norm_bwd"],
             "cluster_train_gpt_long_4_steps": cluster_launches(
                 "layer_norm_bwd"),
             "ckpt_resume_%d_steps" % CKPT_STEPS: ckpt_launches("layer_norm_bwd"),
             **options_launches(options_res, "layer_norm_bwd"),
             "feed_train_12_steps": feed_launches("layer_norm_bwd"),
             "obs_feed_train_12_steps": obs_launches("layer_norm_bwd"),
             "train_gpt_defaults_%d_steps" % GPT_DEFAULT_STEPS: launches(
                 gpt_res, GPT_DEFAULT_STEPS, "layer_norm_bwd"),
             **dp_launches(dp_res, "layer_norm_bwd"),
             **groups_launches(groups_res, "layer_norm_bwd"),
             **spmd_launches(spmd_res, "layer_norm_bwd"),
             **pipe_launches(pipe_res, "layer_norm_bwd")},
            lnb_err, pick(lnb_rows, rows=16384, dtype="bfloat16"),
            design="row in registers, grid from the SM count"),
      entry("ln_matmul", "ln_matmul.cu", "ln_matmul.py:31",
            {"train_fused_4_steps": fused_l["ln_matmul"],
             "train_fused_gqa_2_steps": launches(fgqa_res, 2, "ln_matmul"),
             **spmd_launches(spmd_res, "ln_matmul")},
            fm_err, pick(fm_rows, op="ln_matmul", case="qkv"),
            tp_widths=[r for r in spmd_res["tp_widths"]
                       if r["op"] == "ln_matmul"],
            library="F.layer_norm + torch.matmul (two calls)",
            design="wgmma+tma (bf16, h and n multiples of 8; WMMA for "
                   "other widths) + prologue_gemm_wgmma.cuh, LayerNorm in "
                   "registers"),
      entry("gelu_matmul", "act_matmul.cu", "act_matmul.py:55",
            {"train_fused_4_steps": fused_l["gelu_matmul"],
             "train_fused_gqa_2_steps": launches(fgqa_res, 2, "gelu_matmul"),
             **spmd_launches(spmd_res, "gelu_matmul")},
            fm_err, pick(fm_rows, op="gelu_matmul", case="down"),
            tp_widths=[r for r in spmd_res["tp_widths"]
                       if r["op"] == "gelu_matmul"],
            library="F.gelu + torch.matmul (two calls)",
            design="wgmma+tma (bf16, f and n multiples of 8; WMMA for "
                   "other widths) + prologue_gemm_wgmma.cuh"),
  ]
  # the split kernels: no single PyTorch call computes dQ or dK/dV alone;
  # SDPA's whole backward stands beside the pair's time
  for kern, name, replaces, by_path, case in (
      ("dq", "flash_attention_bwd_dq", "flash_attention.py:166",
       {"train_long_gqa_2_steps": launches(long_res, 2,
                                           "flash_attention_bwd_dq"),
        "cluster_train_gpt_long_4_steps": cluster_launches(
            "flash_attention_bwd_dq"),
        "ckpt_resume_%d_steps" % CKPT_STEPS: ckpt_launches("flash_attention_bwd_dq"),
        **options_launches(options_res, "flash_attention_bwd_dq"),
        **spmd_launches(spmd_res, "flash_attention_bwd_dq"),
        "train_split_4_steps": split_l["flash_attention_bwd_dq"]}, "long"),
      ("dkv", "flash_attention_bwd_dkv", "flash_attention.py:197",
       {"train_split_4_steps": split_l["flash_attention_bwd_dkv"],
        **spmd_launches(spmd_res, "flash_attention_bwd_dkv")}, "train"),
      ("dkv", "flash_attention_bwd_dkv_gqa", "flash_attention.py:281",
       {"train_long_gqa_2_steps": launches(long_res, 2,
                                           "flash_attention_bwd_dkv_gqa"),
        "cluster_train_gpt_long_4_steps": cluster_launches(
            "flash_attention_bwd_dkv_gqa"),
        "ckpt_resume_%d_steps" % CKPT_STEPS: ckpt_launches("flash_attention_bwd_dkv_gqa"),
        **options_launches(options_res, "flash_attention_bwd_dkv_gqa"),
        **spmd_launches(spmd_res, "flash_attention_bwd_dkv_gqa")},
       "long")):
    row = pick(split_rows, case=case, kernel=kern)
    kernels.append(entry(
        name, "flash_attention_bwd_split.cu", replaces, by_path,
        max(split_err[kern], hd_err["split"]), row, design="wgmma+tma",
        head_dims="8..128 (d % 8 == 0)", library=row["library"],
        library_whole_bwd_ms=row["library_whole_bwd_ms"],
        split_pair_ms=row["split_pair_ms"], fused_ms=row["fused_ms"],
        shape="B%d S%d H%d Hk%d D%d" % (row["B"], row["Sq"], row["H"],
                                        row["Hk"], row["D"]),
        ring_blocks=spmd_kernel_rows(spmd_res, name)))
  record = {"card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "sass_counts": sass, "tensor_core_spill_bytes": spills,
            "layer_norm": ln_rows, "flash_attention": fa_rows,
            "layer_norm_bwd": lnb_rows, "flash_attention_bwd": fab_rows,
            "flash_attention_bwd_split": split_rows, "fused_matmul": fm_rows,
            "head_dims": hd_rows, "train_gpt_defaults": gpt_res,
            "serve_gpt_config": serve_gpt_res,
            "main_path": main_res, "profile": prof_res,
            "parity_f32": parity, "train": train_res, "train_gqa": gqa_res,
            "train_fused": fused_res, "train_fused_gqa": fgqa_res,
            "train_long_gqa": long_res, "cluster_long_gqa": cluster_res,
            "ckpt_resume": ckpt_res, "train_options": options_res,
            "feed": feed_res, "obs": obs_res, "fleet": fleet_res,
            "deploy": deploy_res, "decode_stack": decode_res,
            "dp": dp_res, "groups": groups_res, "spmd": spmd_res,
            "pipeline": pipe_res,
            "train_split": split_res,
            "train_parity_f32": train_parity,
            "train_fused_parity_f32": fused_parity,
            "train_split_parity_f32": split_parity,
            "train_split_gqa_parity_f32": split_gqa_parity,
            "phase_s": phase_seconds(),
            "total_s": time.monotonic() - t_start}
  out_dir = os.path.join(HERE, "chiprun_out")
  os.makedirs(out_dir, exist_ok=True)
  with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
    json.dump(record, f, indent=1)
  log("  seconds by phase: %s" % " ".join(
      "[%s] %.1f" % kv for kv in record["phase_s"].items()))
  log("  total %.1f s" % record["total_s"])
  log(card)
  log(json.dumps({"kernels": kernels}))
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
