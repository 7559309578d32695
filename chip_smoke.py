"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``torchft_tpu_torch/ops/csrc`` (one
   nvcc per source, started together), times the build, and prints per
   kernel what ptxas reported (registers, stack, spills, wgmma serialized)
   and its HGMMA (wgmma), TF32 (tensor-core products from tf32 operands)
   and UTMALDG (TMA load) SASS instructions. Every instance
   of ``attention.cu`` (the forward with and without p_split, dq and dK/dV,
   each in bf16 and in f16) and of ``attention_tf32x3.cu`` (the f32
   forward, dq and dK/dV) must be built at every head dim, run on wgmma
   (TF32 wgmma for the f32 ones) fed by TMA, compile at the 168 registers
   its setmaxnreg split assumes, and not spill at head dim 128.
2. Holds each fp8 kernel against its plain PyTorch version on the card, bit
   for bit, from a single element up to the full bench_1b gradient count,
   and times kernel, plain version and the device-memory bound at that
   size; quantize is also timed at the reduced-chunk shape the two-replica
   allreduce gives its second launch.
3. Checks the serial fp8-quantized allreduce on CUDA tensors against the
   same allreduce on CPU tensors (the plain versions), bit for bit. Holds
   the host-rule quantize kernel (``quantize_fp8_rowwise_kernel<true>``,
   the codec of every streamed bucket) against its plain version, bit for
   bit, on bench_1b's largest gradient bucket and on a ragged tail, each
   with a zero row, overflow rows, a non-finite row and a subnormal row,
   and times it at the largest bucket. Times each stage of the serial
   quantized allreduce alone on one rank's chunk of the bench_1b gradient
   (D2H, pickle.dumps, pickle.loads, the loopback socket, the landing), and
   each stage of the streamed one on bench_1b's largest bucket (pack, a
   hop's socket and arithmetic, the landing). Checks the
   streamed allreduce of CUDA tensors against the same calls on CPU
   tensors, bit for bit: fp8 with error feedback over 3 steps, and raw
   bf16. Then the fp8 allreduce of bench_1b's gradient tree over two
   replica Managers, serial and streamed, 2 turns each in alternation,
   with the streamed stage sums, ``overlap_efficiency`` and the wire's
   bytes and busy seconds; the serial engine's quantize launches are read
   from this phase.
4. Holds the attention kernels (forward, dq, dkv) of K1 (splash) and K2
   (flash) against their plain versions at the bench_1b shapes (GQA 16/8,
   also with K/V as strided views of one fused tensor, and 16/16 for K2),
   at S 384 (an odd number of tiles) and at head dims 64 and 256 with
   batch 2, in bf16, f16 and f32 (``ATTN_DTYPES`` names each kernel's
   source: ``attention.cu`` on the tensor cores runs bf16 and f16,
   ``attention_tf32x3.cu`` on the tensor cores by split operands f32).
   bf16 and f16: each kernel
   output's max abs error against an f32 evaluation of the same inputs
   must be at most twice the plain version's in that dtype, and at most
   ``SHARE_BAR`` of the f16 forward's outputs may differ from the plain
   version's (bf16's share is printed, not gated). f32: at most 4x the plain f32
   version's against an f64 evaluation (autograd through a softmax
   attention in f64; 4x because the forward's online softmax rescales its
   sums once per key tile, which the plain version never does, and the
   split operands drop lo*lo), with TF32 matmuls off. lse within 1e-3
   everywhere. Times each kernel, its plain version and torch's
   scaled_dot_product_attention in the same dtype (the yardstick only) at
   the bench_1b GQA shape beside its bound (f32: at the 3xTF32 rate, 495/3
   TFLOP/s), by device time (``device_ms``), K1's f32 kernels at head dim
   256 (``hd256_b2``), and the bf16 kernels and the f16 forward beside SDPA
   alone at the llama3_8b attention shape.
5. Checks that a model left to its default attention reads
   ``TORCHFT_TPU_ATTENTION`` (removed from the script's own environment at
   start): a 2-layer bf16 model under ``xla`` launches no attention kernel.
   Drives the model paths of the attention kernels, each with the launch
   counts set to 0 just before it and read just after: a 2-layer
   bench_1b-width Llama, forward and backward, through K2 in bf16
   (``attention="flash"``, loss within 2% of ``attention="xla"``), and in
   f32 and f16 through ``attention="auto"`` (which resolves to splash) and
   ``"flash"``; f32 losses within 1e-4 (relative) of ``"xla"`` in f32, f16
   within 0.25%; a profile of each run shows that exactly the kernel
   instances of ``ATTN_INSTANCE`` ran (in f32 the three 3xTF32 kernels).
   Then times one replica's full bench_1b forward + backward through the
   materialized attention and through the kernels, in turns.
6. Trains Llama bench_1b at full width and depth as two fault-tolerant
   replica groups (threads on one card) with an in-process lighthouse, the
   fp8-quantized managed allreduce at the Manager's defaults (streamed
   1 GiB buckets coded on the card, with error feedback) and a scripted
   crash of replica 1 at step 3 that restarts and heals over HTTP; each
   step's line carries the pipeline's stage sums and its wire. It checks
   finite losses, the discarded step, the heal, bitwise-equal replicas,
   that attention dispatched to splash, and that the host-rule quantize,
   the dequantize and K1's three kernels launched on this run.
7. Heals bench_1b over ``PGTransport``: the same training, 5 steps with the
   crash at step 2, the heal received in place into the restarting
   replica's live model and AdamW state on the card through a recovery
   process group of its own. Checks bitwise-equal replicas after the heal
   and prints ``heal_send_s``, ``heal_recv_s``, ``heal_chunks`` and
   ``heal_mb_per_s`` beside the HTTP run's, with both runs' peak device
   memory. Before it, PGTransport and the host PG's point-to-point
   ``recv_into`` land CUDA tensors in place (``data_ptr()`` kept), bit for
   bit.
8. Runs the ``train_ddp`` example as processes on the card: the lighthouse
   CLI and two replicas of ``python -m
   torchft_tpu_torch.examples.train_ddp --quantize --grad-accum 2
   --transport pg --steps 10``, replica 1 SIGKILLed once it printed its
   step-3 line and restarted. Checks that every process exits with 0, that
   the restarted replica joined mid-run and healed, that both replicas'
   parameter checksums agree, and that the host-rule quantize and the
   dequantize launched in each child (their ``done:`` lines carry the
   counts); prints each replica's step times and heal seconds. The policy
   plane observes: the lighthouse CLI runs with ``--policy builtin`` and
   the lighthouse and both replicas with ``TORCHFT_POLICY=observe``, so
   the builtin "calm" rule's frame reaches both; each ``done:`` line must
   show ``policy_intents`` >= 1, ``policy_applies`` 0 and the same
   ``policy_seq``. A failed check raises with the end of the processes'
   transcript.
9. Trains bench_1b semi-synchronously (``--diloco``): full width, a
   quarter of its depth (``QUARTER_LAYERS``: 5 of its 20 layers),
   batch 1, seq 2048, two replica threads, inner AdamW steps, one of two
   fragments synced every 10 inner steps (sync every 20, delay 1) with its
   fp8 pseudogradient through the streamed allreduce, the outer Nesterov
   SGD and the merge, 30 inner steps; replica 1 crashes after inner step
   14 (after fragment 0's first sync, before fragment 1's prepare),
   restarts and heals over PGTransport into its live model, AdamW state,
   fragment globals and momentum (``data_ptr()`` kept). Checks finite
   losses, splash attention, the fragments' globals and momentum bitwise
   equal across replicas, K1 bf16, K3-host and K4 launched and K3
   ``<false>`` not; prints the inner-step ms, each sync's allreduce ms per
   fragment, tokens/s per replica, the heal's seconds, chunks and MiB/s
   and the peak device memory.
10. Runs the ``train_diloco`` example as processes on the card: the
   lighthouse CLI and two replicas of ``python -m
   torchft_tpu_torch.examples.train_diloco --quantize`` (HTTP heal, so the
   CPU-to-card load into fragment globals runs), replica 1 SIGKILLed once
   it printed its outer-step-4 line and restarted. Checks every exit code,
   the heal, equal fragment digests and the fp8 launches in each child.
   Every process phase leaves its transcript in ``chiprun_out/``.
11. LocalSGD on the card: two replica threads average trees of CUDA
   tensors, bitwise equal to the same call on CPU tensors.
12. A whole-job outage of the ``train_llama_hsdp`` counterpart on the card
   at bench_1b width and half depth (``CUT_LAYERS``: 10 of its 20 layers,
   cut for time: the saves, the restores and the heal move half the
   bytes), run as an operator would (``python -m
   torchft_tpu_torch.examples.train_llama_hsdp --outage-demo --config
   bench_1b --layers 10 --batch-size 1 --seq-len 2048 --attention ulysses
   --transport pg --steps 7 --kill-at-step 2 --ckpt-dir
   chiprun_out/ckpt_hsdp --ckpt-every 3``; 7 steps, so that step 6's save waits for step 3's
   to land and the outage always finds both groups training): the lighthouse CLI as the root, the pod aggregator's
   CLI in front of it (every worker has ``TORCHFT_LIGHTHOUSE_AGGREGATOR``),
   and ``python -m torchft_tpu_torch.launcher --replica-groups 2
   --max-restarts 2`` over two groups of one rank each (a world-1 NCCL
   in-group process group per process, FSDP2 over it; the unquantized bf16
   gradient allreduce), each saving a durable checkpoint of its whole state
   (parameters and AdamW's moments, 3.62 GB a group at 10 layers) on DCP
   at step 3. The
   punisher kills group 1's leader after its step-2 line (the launcher
   restarts it; it heals over PG into its live local shards), then every
   group once both landed step 3, between two quorum rounds (the launcher
   restarts both; each restores step 3 in place); after the first commit
   that follows, the aggregator gets SIGTERM and the Managers fail over to
   the root. Checks the launcher's exit 0 with restarts [1, 2], the heal
   with its storage kept, each restored digest equal to the one its save
   landed with, equal final digests, splash attention and K1's forward, dq
   and dK/dV launched in every incarnation, ``via_aggregator`` 1 before the
   aggregator's death and ``aggregator_failovers`` at least 1 after it,
   with no failed commit, and the aggregator's exit 0; it fails first
   when the filesystem holds less than twice the two groups' checkpoints,
   and removes them at the end. Prints the free space, each save's issue
   and issue-to-landed seconds and GB/s, each restore's seconds and GB/s,
   every incarnation's step times (the saving step marked), the time from
   the outage to the first commit after it, the PG heal's numbers and each
   final process's peak device memory; the transcript stays in
   ``chiprun_out/train_llama_hsdp.log``.
13. The rest of the Manager and the collectives. (a)
   ``reduce_scatter_quantized`` over two ``ProcessGroupHost`` ranks
   (threads, loopback): on CUDA tensors (one K3 ``<false>`` launch over
   the padded buffer, one K4 over the received chunks) against the same
   call on CPU tensors (the plain versions), bit for bit, at 2^24 + 777
   elements with a zero row, an overflow row, a non-finite row and a
   subnormal row, for SUM and AVG; then the call at bench_1b's full
   gradient count in 3 turns, each also split into its stages (K3, the
   slicing onto the host wire, the alltoall, the landing and K4, the sum);
   K3's and K4's launches are read from those turns. (b) bench_1b at full
   width, a quarter of its depth (5 layers), as three replica groups
   (threads on one card), the unquantized
   bf16 allreduce, 3 steps healed over HTTP wire v3 in place, with the
   reference's resilient-heal fault script (each fault fires at the start
   of its step, as the reference's ``EventInjector``): replica 2 crashes
   at step 2 and restarts, its assigned source (replica 0) drops every serve of
   chunk 0 mid-body so the heal fails over to replica 1's standby
   snapshot, which corrupts chunk 0 once (caught by its crc32, fetched
   again), and one should_commit RPC flakes at step 2 (retried under
   ``TORCHFT_RETRY_MAX_ATTEMPTS=2``; the HTTP transport's timeout 30 s).
   Checks finite losses, every replica
   at step 3, bitwise-equal replicas, on replica 2 a failover, a crc
   failure and no error, a retried RPC, the healed tensors' storage kept,
   splash attention and K1's three kernels launched; prints the median
   steady step split as the trainer's, tokens/s per replica, both
   sources' staging seconds, the heal's seconds, chunks and MiB/s, and
   the peak device memory.
14. The model layer. (a) One replica's bench_1b forward + backward (full
   width and depth, batch 1, seq 2048) under the remat modes in turns
   (none, none, dots, attn, full): per mode the median of 3 steps, the
   step's peak device memory above the resting model and K1's launches in
   one step. Checks K1's forward at 20 launches a step under none, dots
   and attn and 40 under full (dq and dK/dV 20), the loss bitwise equal
   across modes and every gradient bitwise equal to none's (or, if two
   runs of none differ, within their spread). (b) The MoE at bench_moe
   width, half depth (12 of its 24 layers; head dim 64) as the trainer's
   ``--model moe --config bench_moe --layers 12 --batch-size 1 --seq-len
   2048 --no-quantize --steps 3 --fail-at 1`` runs it: two replica threads,
   full remat, the unquantized bf16 allreduce, replica 1 crashing after
   step 1's backward pass and healing over HTTP in place. Checks finite
   losses, the discarded step, the heal, bitwise-equal replicas with their
   storage kept, splash attention and K1's head-dim-64 kernels launched
   (and no other); prints the median steady step split as the trainer's,
   tokens/s per replica, the aux loss, the dropped share, the heal's
   seconds, chunks and MiB/s and the peak memory. (c) K1's bf16 kernels at
   bench_moe's attention shape (B 1, S 2048, Hq 16, Hkv 8, hd 64) against
   their plain versions, timed beside their bound and SDPA.
15. The redundancy plane at bench_1b (full width, a quarter of its depth: 5 layers, B 1, S 2048,
   AdamW, full remat): three replica threads and one hot spare, the fp8
   allreduce at the Manager's defaults, HTTP heals, the shard directory
   beside the lighthouse, ``--redundancy 2,1`` with retain 1 and
   a generation every ``RED_INTERVAL`` (2) commits, 7 steps, the
   allocator's segments expandable (the card is ~92% full). Replica 2
   crashes at the start of step 3, once the other members have staged
   that step's generation, and restarts (at the start, not after the
   backward pass: one more member staging at the crash took the host past
   its 96 GiB, PERF.md): as its store died with it, its heal reconstructs
   through the parity shard (``reconstructs`` 1, ``reconstruct_failures`` 0 in the
   rejoined incarnation, two shards ok and one failed), in place. Replica
   1 dies at the start of step 5, once replica 0 has staged that step's
   generation and the spare has prefetched it; the death notice makes the
   directory promote the spare, whose ``promote()`` loads that generation
   in place and joins with no heal; the quorum of replicas 0 and 2 and
   the spare trains to the end. Checks finite losses, every member left
   and the spare at step 7 with no error, bitwise equal, storage kept, no step committed twice
   within an incarnation and the committed frontier never moving back,
   no shard put to a dead store (the directory retires the crashed
   incarnation and leaves the dead out of placement), splash attention,
   and K1's three kernels, K3-host and K4 launched in the
   phase. Prints the reconstruct's seconds and MB/s beside phase 6's HTTP
   pull of the same 6.45 GB, the steady step split as phase 6's, the
   staging's hot path (``shard_stage_hot_s``), snapshot, encode and put
   seconds per replica, the spare's promotion step and the time and steps
   from the death to its first commit, the device peak, the host's
   MemAvailable before and during the phase and this process's peak RSS.
   Each Manager dumps its span ring into ``chiprun_out/trace_redundancy/``
   (merged there into ``merged_trace.json``), and the phase prints each
   incarnation's ``reconstruct`` and ``shard_stage`` spans.
16. The health and tracing planes at bench_1b (full width, half depth: 10 layers, B 1, S
   2048, AdamW, full remat): three replica threads, the fp8 allreduce at
   the Manager's defaults, HTTP heals, tracing on (the default) with every
   span ring dumped and merged into ``chiprun_out/trace_health/``, the
   lighthouse's history recorded there, every Manager serving
   ``/metrics`` (``TORCHFT_METRICS_PORT=0``), and the health plane
   ejecting (``--health eject``) with shortened knobs: ``MIN_SAMPLES`` 3,
   ``EJECT_STEPS`` 2, ``PROBE_OK`` 2 and ``PROBATION_MS`` twice phase 6's
   steady step. Replica 2 runs ``slow`` from step 3 (a host sleep before
   each allreduce, twice its least ``step_s - wire_s`` so far) until it
   sees itself ejected; it is then honest. Replica 0's step 1 runs under
   ``torch.profiler`` (CPU and CUDA). A thread scrapes the lighthouse's
   and each Manager's ``/metrics`` every second. Checks finite losses;
   replica 2 out of the quorum within ``min_samples + eject_steps + 2`` of
   its scored steps; replicas 0 and 1 committing at least 2 steps while it
   is out; its readmission and heal over HTTP in place; the three bitwise
   equal; its ``ejections`` and ``readmissions`` 1 each and the peers'
   ``ejections`` 0; ``eject`` and ``readmit`` in the lighthouse's
   ``recent_events``; the recorded telemetry replayed (``history_script``)
   through the Python ``HealthLedger`` and the native ``health_replay``
   to the same transitions, an ejection among them; the merged trace
   holding each replica's ``quorum_rpc``, ``pack``/``wire``/``unpack``
   and ``commit_vote`` and replica 2's ``heal_recv``; ``trace_dropped`` 0;
   every scrape answered; the profiled step's Kineto trace holding
   ``torchft::manager::wait_quorum`` and K1's forward kernel; the tracing
   and telemetry cost (spans a step x the cost of one span + the
   telemetry's publish, ``tracing_cost_us``, over the steady step) under
   1%; K1's three kernels, K3-host and K4 launched. Prints the steady step
   split, the ejected quorum's step, the heal on readmission, spans a
   step, microseconds a span, the cost's share and the launches.
17. The serving plane at bench_1b (full width, half depth: 10 layers, B 1, S 2048,
   AdamW, full remat): two replica threads on the fp8 allreduce (as phase
   6), the lighthouse co-hosting the snapshot registry, each replica's
   Manager publishing every committed step through a ``SnapshotPublisher``
   (the 10-layer model's parameters as one f32 flat on the card: the delta
   against ``R`` coded by K3-host, replayed into ``R`` by K4, its codes and
   scales pickled on the host, ``R`` staged for full pulls), two
   ``ServeWorker``s on the card (``max_lag`` 8) answering four closed-loop
   ``/infer`` threads, a thread sampling each worker's lag in steps, 6
   steps. The workers' pulls are held from replica 0's commit of step 1
   until its source died; replica 0 crashes after step 3's backward pass,
   once its publisher announced step 2 (its source sorts first among equal
   versions: the registry breaks ties by replica id), restarts, heals over
   HTTP (the quorum bump lands mid-traffic) and its new publisher
   bootstraps from the registry. Checks zero failed requests, every
   worker's final flat bitwise equal to both publishers' ``R`` (and their
   sha256 digests equal), each publisher's versions strictly increasing
   with no announce rejected, the healed replica's publisher bootstrapped,
   the workers failing over at least one pull from the dead source, a
   delta at least 3x smaller than a full pull, and K3-host and K4 launched
   by the serving path (its own counts, within the phase's), K1's three
   kernels in the trainers. Prints the commit path's ``serve_publish_s``,
   the publisher thread's split (delta + K3-host, K4 replay, codes to the
   host, pickle, staging ``R``, announce), the skipped versions, a full
   pull's seconds and MB/s, a delta pull's ms, lag p50 / p99 in steps,
   ``/infer`` p50 / p99 ms and requests/s (one process: the trainers, the
   publishers' and workers' HTTP servers and the request threads share
   its GIL), the steady step split and the device and host peaks.
18. Heals bench_1b (full width and depth, B 1, S 2048, AdamW, full remat)
   over a Baby recovery PG: the trainer's ``transport="pg-baby"``,
   ``PGTransport`` over a ``ProcessGroupBabyHost`` whose ``ProcessGroupHost``
   runs in a child made by the ``spawn`` context (anew at every quorum
   change), its op timeout ``RECOVERY_TIMEOUT_S`` (30 s). Two replica
   threads, the fp8 allreduce as phase 6, 7 steps; replica 1 crashes after
   step 2's backward pass and heals 6.45 GB through the children's pipes,
   then after step 4's, and that heal's source (replica 0) has its Baby
   child SIGKILLed once 60 leaf messages are submitted
   (``kill_recovery_child``). Checks: exactly one child killed; the
   healer's Baby showing ``errored()`` within the recovery timeout; the
   step the kill struck discarded; one failed heal attempt, then a heal on
   fresh children; every replica at step 7, bitwise equal, finite losses;
   no child alive at the end; every step run in this process on its one
   CUDA context (``cuCtxGetCurrent`` from the replica threads); K1's three
   kernels, K3-host and K4 launched. Prints ``heal_send_s``,
   ``heal_recv_s`` and MB/s beside phase 7's heal over the plain PG, the
   time from the kill to each Baby's ``errored()``, the peak device
   memory, and the pids ``nvidia-smi`` saw on the card during the phase.
   It runs right after phase 7.
19. Runs ``python -m torchft_tpu_torch.analysis --ci`` (fleetlint's five
   checkers over the port against its baseline) and then ``python -m
   torchft_tpu_torch.doctor`` on the card, each with a 300 s timeout,
   beside phases 8, 10 and 21 (all are processes that barely load the
   card), and prints fleetlint's summary line and seconds and the doctor's
   lines. Checks fleetlint's exit 0, the doctor's exit 0, its 19 checks
   all ``ok`` (no ``warn``, no ``FAIL``), ``fleetlint`` among them, and the
   accelerator check naming the H100.
20. The policy plane in enforce mode at bench_1b (full width, a quarter of
   its depth: 5 layers, B 1, S 2048): two replica threads as phase 6 (fp8
   streamed buckets, HTTP heal, the lighthouse's history recorded) under
   ``TORCHFT_POLICY=enforce``, ``TORCHFT_POLICY_INTERVAL_S=0.25`` and
   ``TORCHFT_POLICY_WINDOW_S=8``, with a spec of one rule on
   ``churn_per_min``: above 7.5 (one replica's replacement is 2 membership
   units in 8 s, 15 a minute) it sets ``TORCHFT_HEALTH_EJECT_Z=9.0``
   (clamped to [3, 12]); at 0.5 or below it releases. Replica 1 crashes
   after step 3's backward pass, restarts and heals; the run goes on until
   both replicas have applied the release frame, at most 60 steps. Checks:
   the lighthouse published seq 1 (the rule fired), then seq 2 (released);
   every live Manager applied each at a ``start_quorum`` once (its
   ``torchft_policy`` records and the flight recorder's, their count its
   ``policy_applies``); the override layer held ``EJECT_Z`` 9.0 while both
   replicas were at seq 1 and nothing once both were at seq 2; the
   ledger's ``eject_z`` 9.0 after seq 1 and still 9.0 after the release
   (the reference's release retunes nothing back); the lighthouse's
   ``torchft_lighthouse_policy_seq`` equal to the last seq; finite losses,
   the discarded step, the heal, replicas bitwise equal; K1's three
   kernels, K3-host and K4 launched. Then replays the phase's history
   through ``python -m torchft_tpu_torch.policy replay --policy builtin
   <the spec>`` and checks its exit 0 and its winner. Prints the step at
   which each replica applied each frame, the fold's seconds a pass and
   the ranking. The trainers, the lighthouse and its policy controller are
   built inside the port's lock-order detector (``with
   lockgraph.watch()``: every Python ``Lock`` and ``RLock`` created in the
   run is instrumented): ``lockgraph.assert_clean`` must find no
   acquisition-order cycle. Prints the detector's locks, nodes (creation
   sites), edges, cycles and three longest holds, and the steady step
   beside the phase's without the detector (615.9-671.4 ms on an H100
   80GB HBM3 at 700.00 W).
21. The orchestrator on the card, beside phases 8, 10 and 19: ``python -m
   torchft_tpu_torch.examples.orchestrator --replicas 2 --steps
   ORCH_STEPS --inject-kill-after ORCH_KILL_AFTER_S`` with
   ``TORCHFT_COMPRESS=fp8`` (every worker's streamed gradient buckets on
   K3-host and K4): its lighthouse, two actors each supervising a ``python
   -m torchft_tpu_torch.examples.train_ddp`` worker on the card, and its
   failure controller killing one worker through the lighthouse; the
   transcript, each line with its seconds, stays in
   ``chiprun_out/orchestrator.log``. Checks, on the evidence of the
   transcript: exit 0; one ``[chaos] killed`` line, landing after at least
   5 committed steps of the victim and at least 20 steps before the end;
   that actor's ``worker died rc=`` line with ``restart 1/3``; both actors
   ``succeeded`` (0 and 1 restarts); the restarted incarnation's ``done:``
   line with a heal; equal parameter digests; K3-host and K4 launched in
   each final incarnation. Prints the time from the kill to the supervisor
   seeing the death, to the restarted worker up and to its first commit,
   each worker's median step and the restarts per actor.
22. The device plane at bench_1b (full width and depth, B 1, S 2048,
   AdamW, full remat). First, the fp8 allreduce of bench_1b's gradient
   tree (random bf16 leaves from a seed) over two ``ProcessGroupDevice``
   rank threads (the packed device wire) against the same inputs over two
   ``ProcessGroupHost`` ranks (the host tuple wire): bitwise equal, each
   timed. Then the trainer with ``--plane device``: two replica threads,
   fp8 (the whole tree through ``allreduce_quantized``'s packed wire, K3
   ``<false>`` and K4 on the card, never streamed), ``DP_STEPS`` steps,
   replica 1 crashing after step 3's backward pass and healing over
   ``PGTransport`` on a host recovery group; replica 0's last step runs
   under ``torch.profiler``. Checks: the crashed step discarded, a heal,
   replicas bitwise equal, finite losses, no step's bytes on the host
   wire, no device-to-host copy over ``DP_D2H_BAR`` in the profiled step
   (which must show K3), K1's three kernels, K3 and K4 launched and
   K3-host not. Then FIXED_WITH_SPARES at a quarter depth: three replica
   threads, one forward and backward each, the world pinned at 2, every
   replica's reduced gradient the participants' mean bitwise (the spare's
   zeros made on the card). Then the distributed mode with one NCCL rank,
   configured at two quorum ids and aborted: each allreduce returns its
   input, ``device_world_epoch`` 2, the abort within ``DP_ABORT_BOUND_S``.
   Prints the steady step split, ``heal_recv_s``, the launches and the
   profiled step's copies beside phase 6's host-plane step and heals and
   the two wires' times.

Any failed check raises, so the exit code is non-zero. The last line of
stdout is ``{"ok": true, "device": {...}}``; the line before the card's
name and power limit is the kernel table as JSON. In it every ``ms``,
``plain_ms`` and ``library_ms`` is device time by ``device_ms``, and
``call_ms`` is one call through the kernel's wrapper by CUDA events around
it, the host's time to launch included. Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import logging
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet peak
# phases 12, 14 (b), 16 and 17 run their model at half its depth, full
# width (cut for time when phase 12 grew the whole-job outage, and phase
# 12 itself when phase 18 came): bench_1b 10 of its 20 layers, bench_moe
# 12 of its 24; phases 9, 13 (b) and 15, whose cost is the host's (heals,
# staging, the bf16 wire), and phase 20 (chosen for time), at a quarter:
# bench_1b 5 layers
CUT_LAYERS = {"bench_1b": 10, "bench_moe": 12}
QUARTER_LAYERS = 5
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 and fp16 tensor-core peak
# f32 products on the tensor cores by split operands: three TF32 products
# (H100 SXM dense TF32 peak 495 TFLOP/s) per f32 one
TF32X3_FLOPS_PER_S = 495e12 / 3
ROW = 512


_LAST_MARK = [time.perf_counter()]


def mark(phase: str) -> None:
    """Log the seconds since the previous mark: one line a phase."""
    now = time.perf_counter()
    log(f"phase time {phase}: {now - _LAST_MARK[0]:.1f} s")
    _LAST_MARK[0] = now


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events
    around each run: the device time plus whatever the host adds."""
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


def device_ms(fn, launches: int, reps: int = 3) -> float:
    """Device milliseconds of one ``fn``: the median over ``reps`` of CUDA
    events around ``launches`` back-to-back runs, divided by their count.
    Each group is queued behind a ~20 ms spin of the card, so the host's
    own time to launch them (the Python wrapper, tile maps, ctypes) is not
    counted as long as it stays under the spin."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(40_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ, NaN payloads aside (a NaN equals a NaN)."""
    if a.dtype in (torch.float8_e4m3fn, torch.uint8):
        return int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
    differ = a.view(torch.int32) != b.view(torch.int32)
    return int((differ & ~(torch.isnan(a) & torch.isnan(b))).sum())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors of any dtype hold the same shape and bytes."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max())


def make_input(kind: str, n: int, device: torch.device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(1234 + n)
    x = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    if kind == "zero_rows":
        x.view(-1, ROW)[::2] = 0.0
    elif kind == "wide_range":
        # magnitudes spread log-uniformly over 1e-8..1e8 within each row
        u = torch.rand(n, generator=g, device=device)
        x = x.sign() * torch.exp(math.log(1e-8) + u * (math.log(1e8) - math.log(1e-8)))
    elif kind == "non_finite":
        rows = x.view(-1, ROW)
        rows[0, 3] = float("inf")
        rows[1, 5] = float("-inf")
        rows[2, 7] = float("nan")
        rows[3, 0] = 1e5
        rows[3, 9] = float("nan")
    elif kind == "specials":
        # a zero row, an overflow row (3e38, and -inf), a NaN row, a row of
        # subnormals; n may be ragged
        x[:ROW] = 0.0
        x[ROW + 3], x[ROW + 4] = 3e38, -3e38
        x[2 * ROW + 1] = float("-inf")
        x[3 * ROW + 7] = float("nan")
        x[4 * ROW:5 * ROW] *= 1e-40
    return x


def chunk_elems(n: int, world: int) -> int:
    """Elements of one rank's reduced chunk in the quantized allreduce of
    ``n`` values over ``world`` ranks (``collectives.py``'s partition)."""
    per_rank = -(-n // world)
    return max(1, -(-per_rank // ROW)) * ROW


# SASS instructions counted per kernel: Hopper's tensor-core product
# (wgmma), tensor-core products from tf32 operands (wgmma or mma.sync), and
# the TMA tile load
SASS_OPS = {
    "HGMMA": lambda line: "HGMMA" in line,
    "TF32": lambda line: "MMA" in line and ".TF32" in line,
    "UTMALDG": lambda line: "UTMALDG" in line,
}


def _demangle(names):
    """``attention_fwd_kernel<128, true>`` for each mangled kernel name."""
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return [re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", n) for n in out]


def _cuobjdump() -> str:
    """The toolkit's cuobjdump, or the one Triton bundles."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if os.path.exists(cand):
        return cand
    if shutil.which("cuobjdump"):
        return shutil.which("cuobjdump")
    import triton

    return os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump")


def kernel_build_report(sources) -> dict:
    """Per kernel of the built libraries: what ptxas reported (registers,
    stack and spill bytes, wgmma serialized for want of registers) and the
    count of each of ``SASS_OPS`` in its SASS (cuobjdump). Logs a line per
    kernel."""
    from torchft_tpu_torch.ops._build import build, build_log

    report = {}
    for source in sources:
        mangled, current = {}, None
        for line in build_log(source).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = mangled.setdefault(m.group(1), {"serialized": False})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and current is not None:
                current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and current is not None:
                current["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                current["static_smem"] = int(sm.group(1)) if sm else 0
            if "C7512" in line:
                for name, entry in mangled.items():
                    if name in line:
                        entry["serialized"] = True
        sass = subprocess.run([_cuobjdump(), "-sass", build(source)], capture_output=True,
                              text=True, check=True).stdout
        counts, current = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0))
            elif current is not None:
                for op, found in SASS_OPS.items():
                    current[op] += found(line)
        for name, short in zip(mangled, _demangle(list(mangled))):
            report[short] = {**mangled[name], **counts.get(name, dict.fromkeys(SASS_OPS, 0))}
    for name, r in report.items():
        log(f"ptxas {name}: {r.get('registers')} registers, {r.get('static_smem')} bytes static smem, "
            f"{r.get('stack')} bytes stack, spill stores {r.get('spill_stores')} loads "
            f"{r.get('spill_loads')} bytes{', wgmma serialized' if r['serialized'] else ''}; "
            + ", ".join(f"{op} {r[op]}" for op in SASS_OPS))
    return report


# the kernel instance each path runs at the bench_1b head dim, per dtype
ATTN_INSTANCE = {
    torch.bfloat16: {"fwd": "attention_fwd_kernel<128, {split}, __nv_bfloat16>",
                     "dq": "attention_dq_kernel<128, __nv_bfloat16>",
                     "dkv": "attention_dkv_kernel<128, __nv_bfloat16>"},
    torch.float16: {"fwd": "attention_fwd_kernel<128, {split}, __half>",
                    "dq": "attention_dq_kernel<128, __half>",
                    "dkv": "attention_dkv_kernel<128, __half>"},
    torch.float32: {"fwd": "tf32x3_fwd_kernel<128>",
                    "dq": "tf32x3_dq_kernel<128>",
                    "dkv": "tf32x3_dkv_kernel<128>"},
}


def sass_counts(entry: dict) -> dict:
    return {op.lower(): entry[op] for op in SASS_OPS}


# every instance of attention.cu: the forward with and without p_split,
# dq and dK/dV, in bf16 and f16, at each head dim
HOPPER_CTYPES = ("__nv_bfloat16", "__half")
HOPPER_INSTANCES = tuple(
    [f"attention_fwd_kernel<{d}, {split}, {ctype}>" for d in (64, 128, 256)
     for split in ("true", "false") for ctype in HOPPER_CTYPES]
    + [f"attention_{k}_kernel<{d}, {ctype}>" for k in ("dq", "dkv") for d in (64, 128, 256)
       for ctype in HOPPER_CTYPES])
# every instance of attention_tf32x3.cu: the f32 forward, dq and dK/dV at
# each head dim
TF32X3_INSTANCES = tuple(f"tf32x3_{k}_kernel<{d}>" for k in ("fwd", "dq", "dkv")
                         for d in (64, 128, 256))
# what __launch_bounds__(384, 1) gives and the setmaxnreg splits (24 + 2 x
# 240 and 56 + 2 x 224 a thread) assume
HOPPER_REGISTERS = 168


def check_hopper_kernels(report: dict) -> None:
    """Every instance of attention.cu and attention_tf32x3.cu is built,
    runs on wgmma (on tf32 operands, for attention_tf32x3.cu) fed by TMA,
    compiles at the registers its setmaxnreg split assumes, and does not
    spill at the bench_1b head dim 128."""
    missing = [name for name in HOPPER_INSTANCES + TF32X3_INSTANCES if name not in report]
    if missing:
        raise RuntimeError(f"no {missing} in the build report")
    for names, ops in ((HOPPER_INSTANCES, ("HGMMA", "UTMALDG")),
                       (TF32X3_INSTANCES, ("HGMMA", "TF32", "UTMALDG"))):
        for name in names:
            r = report[name]
            if not all(r[op] for op in ops):
                raise RuntimeError(f"{name} has no {'/'.join(op for op in ops if not r[op])} "
                                   "instruction in its SASS")
            if r["registers"] != HOPPER_REGISTERS:
                raise RuntimeError(f"{name} compiled at {r['registers']} registers, not "
                                   f"{HOPPER_REGISTERS}")
            if "<128" in name and (r["spill_stores"] or r["spill_loads"]):
                raise RuntimeError(f"{name} spills registers: {r}")


def heal_numbers(results: list) -> dict:
    """The crash heal's numbers of a training run: replica 0 sends, replica
    1 (the restarted one) receives."""
    sent, got = results[0]["timings"], results[1]["timings"]
    return {"heal_send_s": sent.get("heal_send_s", float("nan")),
            "heal_recv_s": got.get("heal_recv_s", float("nan")),
            "heal_chunks": got.get("heal_chunks", float("nan")),
            "heal_mb_per_s": got.get("heal_mb_per_s", float("nan"))}


def check_kernels(device: torch.device, full_n: int, world: int):
    from torchft_tpu_torch.ops import quantization as q

    cases = [
        ("single", 1), ("ragged", 511), ("ragged", ROW * 256 + 7),
        ("zero_rows", ROW * 64), ("wide_range", ROW * 1024 + 3),
        ("non_finite", ROW * 8), ("bench_1b_grads", full_n),
    ]
    stats = {"quantize": {"mismatch": 0, "err": 0.0}, "dequantize": {"mismatch": 0, "err": 0.0}}
    timing = {}
    for kind, n in cases:
        x = make_input(kind, n, device)
        qk, sk, nk = q.fused_quantize_fp8(x)
        qp, sp, np_ = q.quantize_fp8_plain(x)
        torch.cuda.synchronize()
        if nk != np_ or qk.shape != qp.shape or sk.shape != sp.shape:
            raise RuntimeError(f"quantize shapes differ for {kind} n={n}")
        mq = bits_differ(qk, qp) + bits_differ(sk, sp)
        deq_k = q.fused_dequantize_fp8(qk, sk, nk)
        deq_p = q.dequantize_fp8_plain(qk, sk, nk)
        torch.cuda.synchronize()
        md = bits_differ(deq_k, deq_p)
        # quantize error: the two versions' codes decoded the same way
        eq = max_abs_err(q.dequantize_fp8_plain(qk, sk, nk), q.dequantize_fp8_plain(qp, sp, np_))
        ed = max_abs_err(deq_k, deq_p)
        stats["quantize"]["mismatch"] += mq
        stats["dequantize"]["mismatch"] += md
        stats["quantize"]["err"] = max(stats["quantize"]["err"], eq)
        stats["dequantize"]["err"] = max(stats["dequantize"]["err"], ed)
        log(f"kernel check {kind:>14} n={n:>10}: quantize mismatches={mq} "
            f"dequantize mismatches={md}")
        if kind == "bench_1b_grads":
            rows = qk.shape[0]
            chunk = x[:chunk_elems(n, world)]
            timing["quantize"] = {
                "ms": device_ms(lambda: q.fused_quantize_fp8(x), 10),
                "call_ms": timed_ms(lambda: q.fused_quantize_fp8(x), 10),
                "plain_ms": device_ms(lambda: q.quantize_fp8_plain(x), 3),
                "bytes": 4 * n + rows * ROW + 4 * rows,
                "chunk_n": chunk.numel(),
                "chunk_ms": device_ms(lambda: q.fused_quantize_fp8(chunk), 10),
            }
            del chunk
            timing["dequantize"] = {
                "ms": device_ms(lambda: q.fused_dequantize_fp8(qk, sk, nk), 10),
                "call_ms": timed_ms(lambda: q.fused_dequantize_fp8(qk, sk, nk), 10),
                "plain_ms": device_ms(lambda: q.dequantize_fp8_plain(qk, sk, nk), 3),
                "bytes": rows * ROW + 4 * rows + 4 * n,
            }
        del x, qk, sk, qp, sp, deq_k, deq_p
        torch.cuda.empty_cache()
    for name, s in stats.items():
        if s["mismatch"]:
            raise RuntimeError(f"{name} kernel disagrees with its plain version "
                               f"in {s['mismatch']} elements")
    return stats, timing


def check_allreduce(device: torch.device) -> None:
    """Quantized allreduce of CUDA tensors (the kernels) against the same
    call on CPU tensors (the plain versions): bitwise equal."""
    from torchft_tpu_torch.collectives import allreduce_quantized
    from torchft_tpu_torch.coordination import KvStoreServer
    from torchft_tpu_torch.process_group import ProcessGroupHost, ReduceOp

    rng = np.random.RandomState(7)
    inputs = [[rng.randn(37, 129).astype(np.float32), rng.randn(1000).astype(np.float32)]
              for _ in range(2)]
    store = KvStoreServer("127.0.0.1:0")
    try:
        for dev in (device, torch.device("cpu")):
            out = [None, None]

            def rank(r: int, dev=dev, out=out, prefix=str(dev)) -> None:
                pg = ProcessGroupHost(timeout=60)
                pg.configure(f"127.0.0.1:{store.port}/{prefix}", r, 2)
                try:
                    leaves = [torch.from_numpy(a).to(dev) for a in inputs[r]]
                    res = allreduce_quantized(leaves, ReduceOp.AVG, pg).get_future().wait(60)
                    out[r] = [t.cpu() for t in res]
                finally:
                    pg.shutdown()

            threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            if any(o is None for o in out):
                raise RuntimeError(f"quantized allreduce on {dev} did not finish")
            if dev.type == "cuda":
                cuda_out = out
            else:
                cpu_out = out
    finally:
        store.shutdown()
    for r in range(2):
        for a, b in zip(cuda_out[r], cpu_out[r]):
            if bits_differ(a, b):
                raise RuntimeError("quantized allreduce: CUDA and CPU results differ")
    log("quantized allreduce: CUDA kernels == CPU plain versions, bitwise (world 2, AVG)")


def comm_pair(prefix: str):
    """Two connected ``_Comm``s (ranks 0 and 1 of one mesh) and the store
    they met through; ``close_pair`` ends them."""
    from torchft_tpu_torch import process_group as pgm
    from torchft_tpu_torch.coordination import KvStoreServer

    store = KvStoreServer("127.0.0.1:0")
    comms = [None] * 2

    def make(r: int) -> None:
        comms[r] = pgm._Comm(r, 2, f"127.0.0.1:{store.port}/{prefix}", 0, 60.0)

    threads = [threading.Thread(target=make, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if None in comms:
        close_pair(comms, store)
        raise RuntimeError("the two _Comms did not connect")
    return comms, store


def close_pair(comms, store) -> None:
    for c in comms:
        if c is not None:
            c.abort()
    store.shutdown()


def time_serial_split(device: torch.device, n: int, world: int, reps: int = 3) -> dict:
    """Each stage of the serial quantized allreduce (``collectives.py``'s
    device engine) alone, on one rank's chunk of an ``n``-element gradient
    over ``world`` ranks: the D2H of its codes and scales
    (``_wire_from_device``), ``pickle.dumps`` and ``pickle.loads`` of that
    wire tuple, its bytes through the loopback socket between two connected
    ``_Comm``s (sender and receiver threads, the receiver's time), and
    ``_device_from_wire`` of ``world`` such wires (np.stack + H2D + one
    dequantize launch). Median ms of ``reps`` each; logs one line per
    stage."""
    import pickle

    from torchft_tpu_torch import process_group as pgm
    from torchft_tpu_torch.collectives import _device_from_wire, _wire_from_device
    from torchft_tpu_torch.ops.quantization import fused_quantize_fp8

    chunk = chunk_elems(n, world)
    x = make_input("random", chunk, device)
    q, scales, _ = fused_quantize_fp8(x)
    del x
    torch.cuda.synchronize()

    def med(fn) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {"chunk_elems": chunk}
    out["d2h_ms"] = med(lambda: _wire_from_device(q, scales, chunk))
    wire = _wire_from_device(q, scales, chunk)
    del q, scales
    payload = pickle.dumps(wire, protocol=pickle.HIGHEST_PROTOCOL)
    out["wire_bytes"] = len(payload)
    out["pickle_dumps_ms"] = med(lambda: pickle.dumps(wire, protocol=pickle.HIGHEST_PROTOCOL))
    out["pickle_loads_ms"] = med(lambda: pickle.loads(payload))

    comms, store = comm_pair("split")
    try:
        def transfer() -> None:
            sender = threading.Thread(target=pgm._send_msg, args=(comms[0].peers[1], payload))
            sender.start()
            pgm._recv_msg(comms[1].peers[0])
            sender.join()

        out["socket_ms"] = med(transfer)
    finally:
        close_pair(comms, store)
    del payload

    def land() -> None:
        _device_from_wire([wire] * world, device)
        torch.cuda.synchronize()

    out["device_from_wire_ms"] = med(land)
    log(f"serial allreduce split (one rank's chunk of {chunk} elements, {out['wire_bytes']} "
        f"pickled bytes, world {world}, median of {reps}, ms):")
    for key in ("d2h_ms", "pickle_dumps_ms", "pickle_loads_ms", "socket_ms",
                "device_from_wire_ms"):
        log(f"  serial split {key[:-3]}: {out[key]:.1f} ms")
    torch.cuda.empty_cache()
    return out


def check_pg_transport_on_card(device: torch.device) -> None:
    """PGTransport's ranged receive into a CUDA template, and the host PG's
    point-to-point ``recv_into`` of CUDA buffers: both land in the template
    tensors' own storage (``data_ptr()`` kept), bit for bit."""
    from torchft_tpu_torch.checkpointing import PGTransport
    from torchft_tpu_torch.coordination import KvStoreServer
    from torchft_tpu_torch.process_group import ProcessGroupHost

    gen = torch.Generator(device=device).manual_seed(3)
    state = {"w": torch.randn(3000, 1000, generator=gen, device=device).to(torch.bfloat16),
             "m": torch.randn(1000, 77, generator=gen, device=device),
             "step": torch.tensor(4.0), "lr": 0.1}
    template = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0.0)
                for k, v in state.items()}
    ptrs = {k: v.data_ptr() for k, v in template.items() if isinstance(v, torch.Tensor)}
    store = KvStoreServer("127.0.0.1:0")
    pgs = [ProcessGroupHost(timeout=60) for _ in range(2)]
    try:
        with ThreadPoolExecutor(2) as ex:
            list(ex.map(lambda r: pgs[r].configure(f"127.0.0.1:{store.port}/pgt", r, 2), (0, 1)))
            sender = PGTransport(pgs[0], timeout=60)
            receiver = PGTransport(pgs[1], timeout=60, state_dict_template=lambda: template)
            fs = ex.submit(sender.send_checkpoint, [1], 5, state, 60)
            got = receiver.recv_checkpoint(0, sender.metadata(), 5, 60)
            fs.result(60)
        for k, ptr in ptrs.items():
            if got[k].data_ptr() != ptr or not same_bits(got[k], state[k].to(got[k].device)):
                raise RuntimeError(f"PGTransport into a CUDA template: leaf {k} moved or differs")
        if got["lr"] != 0.1:
            raise RuntimeError("PGTransport lost a pickled leaf")
        store2 = KvStoreServer("127.0.0.1:0")
        try:
            p2p = [ProcessGroupHost(timeout=60) for _ in range(2)]
            with ThreadPoolExecutor(2) as ex:
                list(ex.map(lambda r: p2p[r].configure(f"127.0.0.1:{store2.port}/p2p", r, 2),
                            (0, 1)))
            out = [torch.empty_like(state["w"]), torch.empty_like(state["m"])]
            sent = p2p[0].send([state["w"], state["m"]], 1, tag=3)
            back = p2p[1].recv_into(out, 0, tag=3).get_future().wait(60)
            sent.wait(60)
            if back[0] is not out[0] or back[1] is not out[1] or not same_bits(
                    out[0], state["w"]) or not same_bits(out[1], state["m"]):
                raise RuntimeError("p2p recv_into of CUDA buffers did not land in place")
            for pg in p2p:
                pg.shutdown()
        finally:
            store2.shutdown()
    finally:
        for pg in pgs:
            pg.shutdown()
        store.shutdown()
    log("PGTransport into a CUDA template and p2p recv_into CUDA buffers: in place "
        "(data_ptr kept), bitwise")


# phase 18: replica 1 crashes after these steps' backward passes; the
# second crash's heal loses its source's Baby child once BABY_KILL_LEAVES
# leaf messages are submitted (of ~550: the leaves are in flight)
BABY_CRASHES = (2, 4)
BABY_STEPS = 7
BABY_KILL_LEAVES = 60


def _cuda_context() -> int:
    """The calling thread's current CUDA context (the driver's handle)."""
    ctx = ctypes.c_void_p()
    if ctypes.CDLL("libcuda.so.1").cuCtxGetCurrent(ctypes.byref(ctx)) != 0:
        raise RuntimeError("cuCtxGetCurrent failed")
    return ctx.value or 0


def _card_pids() -> list:
    """The processes nvidia-smi sees on the card (its own pid namespace)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return sorted(int(x) for x in out.stdout.split() if x.strip().isdigit())


def check_baby_heal_bench_1b(device: torch.device, cfg, pg_heal: dict, pg_peak: int) -> dict:
    """bench_1b healed over a Baby recovery PG, its source's child killed
    in a second heal (docstring, 18); returns the phase's launches."""
    import multiprocessing

    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.train import RECOVERY_TIMEOUT_S, Fault, run_replicas

    first, second = BABY_CRASHES
    baby_cfg = dataclasses.replace(cfg, steps=BABY_STEPS, transport="pg-baby", faults=(
        Fault(1, first, "crash", at="backward"),
        Fault(1, second, "crash", at="backward"),
        Fault(0, second, "kill_recovery_child", chunk=BABY_KILL_LEAVES)))
    contexts = set()
    seen_pids: set = set()
    stop = threading.Event()

    def sample_card() -> None:
        while not stop.wait(2.0):
            try:
                seen_pids.update(_card_pids())
            except (OSError, subprocess.SubprocessError):
                pass

    def on_step(e: dict) -> None:
        # from the replica threads: the process and context they train in
        contexts.add((os.getpid(), _cuda_context()))
        log(f"baby step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
            f"participants={e['participants']} committed={e['committed']} "
            f"healed={e['healed']} step_ms={e['step_ms']:.1f} at={e['at']:.3f}")

    sampler = threading.Thread(target=sample_card, daemon=True)
    sampler.start()
    q.reset_launches()
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    fleet: dict = {}
    t0 = time.perf_counter()
    try:
        results = run_replicas(baby_cfg, device, on_step=on_step, fleet=fleet)
    finally:
        stop.set()
        sampler.join()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    left = multiprocessing.active_children()
    kills = fleet["recovery_child_kills"]
    log(f"baby heal bench_1b ({elapsed:.1f} s, {BABY_STEPS} steps, crashes after steps "
        f"{BABY_CRASHES}, the second heal's source child killed after {BABY_KILL_LEAVES} leaf "
        f"messages): kills {kills}; children alive at the end {left}; contexts "
        f"{sorted(contexts)} (main pid {os.getpid()}, main context {_cuda_context()}); "
        f"nvidia-smi's compute pids during the phase {sorted(seen_pids)}; launches {launches}")
    if len(kills) != 1:
        raise RuntimeError(f"baby heal: {len(kills)} children killed, not one: {kills}")
    kill = kills[0]
    errored = kill["errored_after_s"]
    if 1 not in errored or errored[1] >= RECOVERY_TIMEOUT_S:
        raise RuntimeError(f"baby heal: the healer's Baby showed no errored() within "
                           f"{RECOVERY_TIMEOUT_S} s of the kill: {errored}")
    if left:
        raise RuntimeError(f"baby heal: children left alive: {left}")
    if contexts != {(os.getpid(), _cuda_context())}:
        raise RuntimeError(f"baby heal: the trainers ran in {contexts}, not in this process's "
                           "one CUDA context")
    r0, r1 = results
    if any(r["step"] != BABY_STEPS for r in results):
        raise RuntimeError(f"baby heal: replicas stopped at {[r['step'] for r in results]}")
    # the aborted heal: replica 0's first step to end after the kill was
    # discarded, and replica 1 made exactly one heal attempt that failed
    after = [e for e in r0["log"] if e["at"] > kill["t_kill"]]
    if not after or after[0]["committed"]:
        raise RuntimeError(f"baby heal: the step the kill struck was not discarded: {after[:1]}")
    attempts, heals = r1["timings"].get("heal_attempts", 0), r1["metrics"]["heals"]
    if r1["restarts"] != 2 or heals < 3 or attempts != heals + 1:
        raise RuntimeError(f"baby heal: replica 1 restarts {r1['restarts']}, heals {heals}, "
                           f"attempts {attempts}: not one failed heal then a heal on fresh "
                           "children")
    p0, p1 = r0["params"], r1["params"]
    unequal = [k for k in p0 if not torch.equal(p0[k].view(torch.int16), p1[k].view(torch.int16))]
    if unequal:
        raise RuntimeError(f"baby heal: replicas differ in {unequal[:5]}")
    losses = [e["loss"] for r in results for e in r["log"]]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"baby heal: non-finite loss: {losses}")
    for kernel in ("quantize_fp8_rowwise_host", "dequantize_fp8_rowwise",
                   "splash_fwd", "splash_dq", "splash_dkv"):
        if launches[kernel] == 0:
            raise RuntimeError(f"baby heal: {kernel} never launched")
    baby = heal_numbers(results)
    # what a heal moves: the parameters and AdamW's two moments, one dtype
    state_mb = 3 * sum(t.numel() * t.element_size() for t in p0.values()) / 1e6
    for label, h, pk in (("pg", pg_heal, pg_peak), ("pg-baby", baby, peak)):
        log(f"bench_1b heal {label}: heal_send_s {h['heal_send_s']:.3f} heal_recv_s "
            f"{h['heal_recv_s']:.3f}, {state_mb / h['heal_recv_s']:.1f} MB/s ({state_mb:.1f} MB "
            f"over heal_recv_s; the ranged wire's own heal_mb_per_s {h['heal_mb_per_s']:.1f}); "
            f"peak device memory {pk / 2**30:.2f} GiB")
    log(f"baby heal: kill to errored() {', '.join(f'replica {j} {s * 1e3:.1f} ms' for j, s in sorted(errored.items()))} "
        f"(recovery timeout {RECOVERY_TIMEOUT_S:.0f} s); replicas bitwise equal over {len(p0)} "
        f"tensors; replica 1 heals {heals} of {attempts:.0f} attempts; storage kept "
        f"{[r['storage_kept'] for r in results]}")
    return launches


def check_doctor_on_card() -> list:
    """``python -m torchft_tpu_torch.analysis --ci``, then ``python -m
    torchft_tpu_torch.doctor`` on the card (docstring, 19); returns the
    doctor's lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    lint = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.analysis", "--ci"], cwd=root,
                          capture_output=True, text=True, timeout=300)
    summary = [ln for ln in lint.stdout.splitlines() if ln.startswith("fleetlint: ")]
    log(f"fleetlint --ci: exit {lint.returncode} in {time.perf_counter() - t0:.2f} s; "
        f"{summary[-1] if summary else 'no summary line'}")
    if lint.returncode != 0 or not summary:
        raise RuntimeError(f"fleetlint --ci exited {lint.returncode}:\n{lint.stdout[-3000:]}\n"
                           f"{lint.stderr[-3000:]}")
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.doctor"], cwd=root,
                             capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError("doctor: no end within 300 s") from e
    lines = [ln for ln in out.stdout.splitlines() if re.match(r"^(ok  |warn|FAIL) ", ln)]
    for ln in lines:
        log(f"doctor: {ln}")
    log(f"doctor: exit {out.returncode} in {time.perf_counter() - t0:.1f} s")
    if out.returncode != 0:
        raise RuntimeError(f"doctor exited {out.returncode}:\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    status = {ln.split()[1]: ln[:4].strip() for ln in lines}
    if len(lines) != 19 or set(status.values()) != {"ok"} or "fleetlint" not in status:
        raise RuntimeError(f"doctor: {len(lines)} checks, not 19 all ok with fleetlint: {status}")
    accel = next(ln for ln in lines if ln.split()[1] == "accelerator")
    if "H100" not in accel:
        raise RuntimeError(f"doctor: the accelerator check does not name the H100: {accel!r}")
    return lines


def check_train_ddp_processes() -> dict:
    """The train_ddp example as processes on the card, the policy plane
    observing (docstring, 8)."""
    from torchft_tpu_torch.examples.train_ddp import Fleet

    steps, kill_at = 10, 3
    fleet = Fleet(
        ["--steps", str(steps), "--batch-size", "8", "--quantize", "--grad-accum", "2",
         "--transport", "pg", "--device", "cuda"],
        # min 2 holds the survivor in quorum until the restarted replica
        # joins, so the rejoin always goes through a heal
        ["--min-replicas", "2", "--join-timeout-ms", "500", "--quorum-tick-ms", "20",
         "--heartbeat-timeout-ms", "2000", "--policy", "builtin"],
        env=dict(os.environ, TORCHFT_POLICY="observe", TORCHFT_POLICY_INTERVAL_S="0.25"),
    )
    t0 = time.perf_counter()

    def fail(msg: str) -> RuntimeError:
        return RuntimeError(msg + "\n--- transcript ---\n" + "\n".join(fleet.transcript[-80:]))

    try:
        for rid in (0, 1):
            fleet.spawn(rid)
        fleet.wait_line(1, f"] step={kill_at} ", 300)
        fleet.kill(1)
        t_kill = time.perf_counter()
        fleet.spawn(1)
        rcs = fleet.wait(300)
        done = {rid: fleet.done(rid) for rid in (0, 1)}
    except Exception as e:  # noqa: BLE001 - reported with the transcript
        raise fail(f"train_ddp processes: {e!r}") from e
    finally:
        lighthouse_rc = fleet.close()
        save_transcript("train_ddp.log", fleet.transcript)
    log(f"train_ddp processes: {time.perf_counter() - t0:.1f} s, killed replica 1 at "
        f"{t_kill - t0:.1f} s; exit codes {rcs}, lighthouse {lighthouse_rc}")
    if any(rcs.values()) or lighthouse_rc != 0:
        raise fail(f"train_ddp processes exited with {rcs}, lighthouse {lighthouse_rc}")
    first = next((line for line in fleet.lines[1] if "] step=" in line), "step=0")
    first_step = int(first.split("step=", 1)[1].split()[0])
    if done[1]["metrics"]["heals"] < 1 or first_step <= kill_at:
        raise fail(f"the restarted replica did not heal mid-run (first line {first!r}, "
                   f"metrics {done[1]['metrics']})")
    if done[0]["params_sha256"] != done[1]["params_sha256"]:
        raise fail(f"train_ddp replicas differ: {done[0]['params_sha256']} vs "
                   f"{done[1]['params_sha256']}")
    if not any("policy engine attached (spec=builtin mode=observe)" in line
               for line in fleet.transcript):
        raise fail("train_ddp: the lighthouse attached no policy engine")
    counters = {rid: (d["policy_seq"], d["policy_intents"], d["policy_applies"])
                for rid, d in done.items()}
    if len({c[0] for c in counters.values()}) != 1 or any(
            seq < 1 or intents < 1 or applies for seq, intents, applies in counters.values()):
        raise fail(f"train_ddp: observe mode's (policy_seq, intents, applies): {counters}")
    log("train_ddp policy (observe): " + ", ".join(
        f"replica {rid} policy_seq {d['policy_seq']} intents {d['policy_intents']} applies "
        f"{d['policy_applies']}" for rid, d in done.items()))
    for rid, d in done.items():
        for kernel in ("quantize_fp8_rowwise_host", "dequantize_fp8_rowwise"):
            if d["launches"][kernel] == 0:
                raise fail(f"{kernel} never launched in train_ddp replica {rid}")
        t = d["timings"]
        step_ms = [float(line.split("step_ms=", 1)[1]) for line in fleet.lines[rid]
                   if "step_ms=" in line]
        log(f"train_ddp replica {rid}: steps {d['step']}, step_ms median "
            f"{d['step_ms_median']:.2f} (each: {', '.join(f'{x:.2f}' for x in step_ms)}), "
            f"heal_send_s {t.get('heal_send_s', float('nan')):.4f}, heal_recv_s "
            f"{t.get('heal_recv_s', float('nan')):.4f}, heal_chunks {t.get('heal_chunks', 0):.0f}, "
            f"metrics {d['metrics']}, launches {d['launches']}, params sha256 "
            f"{d['params_sha256'][:16]}")
    return {rid: d["launches"] for rid, d in done.items()}


# phase 21: the orchestrator's workers train this many steps, and its
# failure controller kills one this many seconds after the start. On the
# card beside phases 8, 10 and 19 (H100 80GB HBM3, 700.00 W): the workers'
# first lines came 27.5-28.8 s after the start, paired steps ran ~11-13 ms
# (median), the survivor alone ~8-9 ms, and the killed worker's restart
# took 18.7-25.3 s, in which the survivor trained 1,780-1,915 steps alone.
# The kill lands well after the workers' start, and the steps outlast the
# restart (else the restarted worker starts over alone and never heals)
ORCH_STEPS = 4000
ORCH_KILL_AFTER_S = 40.0
ORCH_TIMEOUT_S = 420


def check_orchestrator_processes() -> dict:
    """Phase 21: the orchestrator supervising two train_ddp workers on the
    card, fp8 buckets, one worker killed through the lighthouse (docstring,
    21). Returns each final incarnation's fp8 launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torchft_tpu_torch.examples.orchestrator", "--replicas", "2",
           "--steps", str(ORCH_STEPS), "--inject-kill-after", str(ORCH_KILL_AFTER_S)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=dict(os.environ, TORCHFT_COMPRESS="fp8"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)

    def kill_group() -> None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    timer = threading.Timer(ORCH_TIMEOUT_S, kill_group)
    timer.start()
    lines = []  # (seconds since the start, line)
    try:
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
        rc = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            kill_group()
            proc.wait()
        save_transcript("orchestrator.log", [f"{t:9.3f} {ln}" for t, ln in lines])
    elapsed = time.perf_counter() - t0
    text = [ln for _, ln in lines]

    def fail(msg: str) -> RuntimeError:
        keep = [ln for ln in text if ln.startswith(("[orchestrator]", "[chaos]", "[actor",
                                                     "  replica", "[replica"))
                and "] step=" not in ln]
        return RuntimeError(f"orchestrator: {msg}\n--- transcript (chiprun_out/"
                            "orchestrator.log) ---\n" + "\n".join(keep[-40:]))

    if rc != 0:
        raise fail(f"exit {rc} after {elapsed:.1f} s")
    # the workers share the orchestrator's stdout: a long line (a done:
    # line's JSON) can be written in pieces, so another process's line may
    # start inside it; every record is found wherever it starts
    def find(pattern: str) -> list:
        return [(i, m) for i, ln in enumerate(text) for m in re.finditer(pattern, ln)]

    def step_of(m) -> int:
        return int(m.group(2))

    steps = find(r"\[replica (\d+)\] step=(\d+) ")
    kills = find(r"\[chaos\] killed train_ddp_(\d+):")
    if len(kills) != 1:
        raise fail(f"{len(kills)} [chaos] killed lines")
    k, km = kills[0]
    victim = int(km.group(1))
    survivor = 1 - victim
    before = [m for i, m in steps if i < k and int(m.group(1)) == victim]
    last = step_of(before[-1]) if before else 0
    if len(before) < 5 or last > ORCH_STEPS - 20:
        raise fail(f"the kill landed after {len(before)} committed steps of replica {victim} "
                   f"(last step {last} of {ORCH_STEPS}): not mid-run")
    died = next((i for i, m in find(rf"\[actor {victim}\] worker died rc=\S+; restart 1/3")
                 if i >= k), None)
    if died is None:
        raise fail(f"no death and restart 1/3 of actor {victim} after the kill")
    up = next((i for i, _ in find(rf"\[replica {victim}\] starting at step") if i > died),
              None)
    first = next(((i, m) for i, m in steps if up is not None and i > up
                  and int(m.group(1)) == victim), None)
    if up is None or first is None:
        raise fail(f"the restarted replica {victim} never started or never committed")
    summary = {int(m.group(1)): (m.group(2), int(m.group(3))) for _, m in
               find(r"^  replica (\d+): (\w+) after (\d+) restart\(s\)$")}
    if summary != {survivor: ("succeeded", 0), victim: ("succeeded", 1)}:
        raise fail(f"the summary says {summary}")
    done = {}
    decoder = json.JSONDecoder()
    for i, m in find(r"\[replica (\d+)\] done: "):
        try:  # the last incarnation's line wins
            done[int(m.group(1))] = decoder.raw_decode(text[i], m.end())[0]
        except ValueError as e:
            raise fail(f"an unreadable done: line ({e}): {text[i][:200]}") from e
    if sorted(done) != [0, 1] or any(d["step"] != ORCH_STEPS for d in done.values()):
        raise fail(f"done lines of {sorted(done)} at steps {[d['step'] for d in done.values()]}")
    if done[victim]["metrics"]["heals"] < 1:
        raise fail(f"the restarted replica {victim} did not heal: {done[victim]['metrics']}")
    if done[0]["params_sha256"] != done[1]["params_sha256"]:
        raise fail(f"digests differ: {done[0]['params_sha256']} vs {done[1]['params_sha256']}")
    for rid, d in done.items():
        for kernel in ("quantize_fp8_rowwise_host", "dequantize_fp8_rowwise"):
            if d["launches"][kernel] == 0:
                raise fail(f"{kernel} never launched in the final incarnation of replica {rid}")
    t_kill = lines[k][0]
    restarts = {rid: summary[rid][1] for rid in sorted(summary)}
    log(f"orchestrator ({elapsed:.1f} s, 2 train_ddp workers, {ORCH_STEPS} steps, fp8 "
        f"buckets, kill after {ORCH_KILL_AFTER_S:.0f} s): killed replica {victim} at "
        f"{t_kill:.1f} s after {len(before)} committed steps (its step {last}); from the kill "
        f"{lines[died][0] - t_kill:.2f} s to the supervisor seeing the death, "
        f"{lines[up][0] - t_kill:.2f} s to the restarted worker up, "
        f"{lines[first[0]][0] - t_kill:.2f} s to its first commit (step {step_of(first[1])}, "
        f"{step_of(first[1]) - last} steps after the victim's last); restarts {restarts}")
    for rid in sorted(done):
        d = done[rid]
        n = sum(1 for _, m in steps if int(m.group(1)) == rid)
        log(f"orchestrator replica {rid}: step_ms median {d['step_ms_median']:.2f} over the final "
            f"incarnation's steps ({n} step lines in all), heals {d['metrics']['heals']}, "
            f"launches {d['launches']}, params sha256 {d['params_sha256'][:16]}")
    return {rid: d["launches"] for rid, d in done.items()}


def save_transcript(name: str, lines: list) -> None:
    """A process phase's transcript, kept in chiprun_out/ beside the script."""
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, name), "w") as f:
        f.write("\n".join(lines) + "\n")


def check_diloco_bench_1b(device: torch.device, cfg) -> dict:
    """bench_1b trained semi-synchronously with a crash and a PG heal
    (docstring, 9); returns the run's launches."""
    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.train import Fault, run_replicas

    crash_at = 14
    # 30 inner steps (40 before phase 16 needed the time): three syncs, the
    # second cycle's 20-29 measured
    dcfg = dataclasses.replace(cfg, steps=30, faults=(Fault(1, crash_at, "crash", at="backward"),),
                               transport="pg", diloco=True, layers=QUARTER_LAYERS,
                               sync_every=20, num_fragments=2, fragment_sync_delay=1)
    q.reset_launches()
    ta.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = run_replicas(dcfg, device, on_step=lambda e: log(
        f"diloco replica={e['replica']} inner={e['inner_step']} outer={e['outer_step']} "
        f"loss={e['loss']:.4f} sync={','.join(e['sync']) or '-'} healed={e['healed']} "
        f"attention={e['attention']} step_ms={e['step_ms']:.1f} inner_ms={e['inner_ms']:.1f} "
        f"diloco_ms={e['diloco_ms']:.1f} tokens_per_s={e['tokens_per_s']:.1f}"
        + (f" committed={e['committed']} participants={e['participants']} "
           f"sync_allreduce_ms={e['sync_allreduce_ms']:.1f} sync_wait_ms={e['sync_wait_ms']:.1f} "
           f"pack_ms={e['allreduce_pack_s'] * 1e3:.1f} wire_ms={e['allreduce_wire_s'] * 1e3:.1f} "
           f"unpack_ms={e['allreduce_unpack_s'] * 1e3:.1f} "
           f"buckets={int(e['allreduce_buckets'])}" if "committed" in e else "")))
    peak = torch.cuda.max_memory_allocated()
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    elapsed = time.perf_counter() - t0
    log_entries = [e for r in results for e in r["log"]]
    losses = [e["loss"] for e in log_entries]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"DiLoCo run: non-finite loss: {losses}")
    if results[1]["restarts"] != 1 or results[1]["metrics"]["heals"] < 1:
        raise RuntimeError(f"DiLoCo run: replica 1 did not crash and heal: {results[1]['metrics']}")
    if any(r["inner_steps"] < dcfg.steps for r in results) or \
            results[0]["step"] != results[1]["step"]:
        raise RuntimeError(f"DiLoCo run: replicas stopped at inner "
                           f"{[r['inner_steps'] for r in results]}, outer "
                           f"{[r['step'] for r in results]}")
    if not all(r["storage_kept"] for r in results):
        raise RuntimeError("DiLoCo run: the PG heal moved a live tensor's storage")
    state0, state1 = results[0]["fragment_state"], results[1]["fragment_state"]
    n_tensors = len(state0)
    if len(state1) != n_tensors or not all(same_bits(a, b) for a, b in zip(state0, state1)):
        raise RuntimeError("DiLoCo run: fragment globals or momentum differ across replicas")
    dispatch = {e["attention"] for e in log_entries}
    if dispatch != {"splash"}:
        raise RuntimeError(f"DiLoCo run: attention dispatched to {dispatch}, not splash")
    for kernel in ("splash_fwd", "splash_dq", "splash_dkv", "quantize_fp8_rowwise_host",
                   "dequantize_fp8_rowwise"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} never launched on the DiLoCo path")
    if launches["quantize_fp8_rowwise"] != 0:
        raise RuntimeError("quantize_fp8_rowwise<false> launched on the DiLoCo path")
    # replica 0's steps from its second cycle on, both replicas healthy
    r0 = [e for e in results[0]["log"] if e["inner_step"] >= 20]
    plain = [e["step_ms"] for e in r0 if not e["sync"]]
    per_inner = sum(e["step_ms"] for e in r0) / len(r0)
    for e in log_entries:
        if "committed" in e:
            log(f"diloco sync replica={e['replica']} {e['sync'][-1]} "
                f"inner={e['inner_step']} committed={e['committed']} "
                f"allreduce_ms={e['sync_allreduce_ms']:.1f} wait_ms={e['sync_wait_ms']:.1f}")
    heal = heal_numbers(results)
    tokens = dcfg.batch_size * dcfg.seq_len
    log(f"bench_1b DiLoCo ({elapsed:.1f} s, {dcfg.layers} layers, {dcfg.steps} inner steps, "
        f"crash after inner "
        f"{crash_at}, heal over pg): fragment globals and momentum bitwise equal over "
        f"{n_tensors} tensors; replica 0 inner steps 20-{dcfg.steps - 1}: median step without a "
        f"sync "
        f"{statistics.median(plain):.1f} ms, mean of all {per_inner:.1f} ms "
        f"({tokens / per_inner * 1e3:.1f} tokens/s per replica; median inner_ms "
        f"{statistics.median(e['inner_ms'] for e in r0):.1f}); heal_send_s "
        f"{heal['heal_send_s']:.3f} heal_recv_s {heal['heal_recv_s']:.3f} heal_chunks "
        f"{heal['heal_chunks']:.0f} heal_mb_per_s {heal['heal_mb_per_s']:.1f}; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    del results, log_entries
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_train_diloco_processes() -> dict:
    """The train_diloco example as processes on the card (docstring, 10)."""
    from torchft_tpu_torch.examples.train_ddp import Fleet

    kill_at = 4
    fleet = Fleet(
        ["--steps", "40", "--batch-size", "16", "--quantize", "--device", "cuda"],
        # min 2: the rejoin always goes through a heal
        ["--min-replicas", "2", "--join-timeout-ms", "500", "--quorum-tick-ms", "20",
         "--heartbeat-timeout-ms", "2000"],
        module="torchft_tpu_torch.examples.train_diloco",
    )
    t0 = time.perf_counter()

    def fail(msg: str) -> RuntimeError:
        return RuntimeError(msg + "\n--- transcript ---\n" + "\n".join(fleet.transcript[-80:]))

    try:
        for rid in (0, 1):
            fleet.spawn(rid)
        fleet.wait_line(1, f"] outer_step={kill_at} ", 300)
        fleet.kill(1)
        fleet.spawn(1)
        rcs = fleet.wait(300)
        done = {rid: fleet.done(rid) for rid in (0, 1)}
    except Exception as e:  # noqa: BLE001 - reported with the transcript
        raise fail(f"train_diloco processes: {e!r}") from e
    finally:
        lighthouse_rc = fleet.close()
        save_transcript("train_diloco.log", fleet.transcript)
    log(f"train_diloco processes: {time.perf_counter() - t0:.1f} s; exit codes {rcs}, "
        f"lighthouse {lighthouse_rc}")
    if any(rcs.values()) or lighthouse_rc != 0:
        raise fail(f"train_diloco processes exited with {rcs}, lighthouse {lighthouse_rc}")
    first = next((line for line in fleet.lines[1] if "] outer_step=" in line), "outer_step=0")
    first_step = int(first.split("outer_step=", 1)[1].split()[0])
    if done[1]["metrics"]["heals"] < 1 or first_step <= kill_at:
        raise fail(f"the restarted replica did not heal mid-run (first line {first!r}, "
                   f"metrics {done[1]['metrics']})")
    if done[0]["fragments_sha256"] != done[1]["fragments_sha256"]:
        raise fail("train_diloco replicas' fragment state differs")
    for rid, d in done.items():
        for kernel in ("quantize_fp8_rowwise_host", "dequantize_fp8_rowwise"):
            if d["launches"][kernel] == 0:
                raise fail(f"{kernel} never launched in train_diloco replica {rid}")
        t = d["timings"]
        log(f"train_diloco replica {rid}: outer steps {d['step']}, local steps {d['local']}, "
            f"global_l1[frag0] {d['global_l1[frag0]']:.6f}, heal_send_s "
            f"{t.get('heal_send_s', float('nan')):.4f}, heal_recv_s "
            f"{t.get('heal_recv_s', float('nan')):.4f}, metrics {d['metrics']}, launches "
            f"{d['launches']}, fragments sha256 {d['fragments_sha256'][:16]}")
    return {rid: d["launches"] for rid, d in done.items()}


def check_local_sgd_on_card(device: torch.device) -> None:
    """LocalSGD of CUDA parameter trees over two replica threads, bitwise
    equal to the same call on CPU tensors (docstring, 11)."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.local_sgd import LocalSGD
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupHost

    def run(dev: torch.device) -> list:
        lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=5000,
                                      quorum_tick_ms=20, heartbeat_timeout_ms=5000)

        def replica(rid: int) -> dict:
            gen = torch.Generator().manual_seed(100 + rid)
            params = {"w": torch.randn(1000, 257, generator=gen).to(dev),
                      "b": torch.randn(4099, generator=gen).to(dev, torch.bfloat16)}
            manager = Manager(pg=ProcessGroupHost(timeout=60), load_state_dict=lambda sd: None,
                              state_dict=lambda: {}, min_replica_size=2, init_sync=False,
                              replica_id=f"local_sgd_{rid}",
                              lighthouse_addr=f"127.0.0.1:{lighthouse.port}", timeout=60)
            try:
                local_sgd = LocalSGD(manager, params, sync_every=2)
                for _ in range(4):
                    with torch.no_grad():
                        params["w"].mul_(0.5 + rid)
                        params["b"].add_(rid)
                    local_sgd.step(params)
                return {k: v.cpu() for k, v in params.items()}
            finally:
                manager.shutdown(wait=False)

        try:
            with ThreadPoolExecutor(2) as ex:
                return list(ex.map(replica, (0, 1)))
        finally:
            lighthouse.shutdown()

    card, host = run(device), run(torch.device("cpu"))
    for rid in (0, 1):
        for k in host[rid]:
            if not same_bits(card[rid][k], host[rid][k]) or not same_bits(card[rid][k], card[0][k]):
                raise RuntimeError(f"LocalSGD on the card: replica {rid} leaf {k} differs")
    log("LocalSGD of CUDA trees over two replica threads: bitwise equal to the CPU call")


# phase 12: a whole-job outage of train_llama_hsdp under the launcher
# (docstring, 12). A save of bench_1b's 6.45 GB took 14.9-19.5 s to land
# (H100 80GB HBM3, 700 W), longer than two steps: 7 steps, so that step 6's
# save waits for step 3's and the outage always finds both groups training
HSDP_STEPS, HSDP_KILL_AT, HSDP_CKPT_EVERY = 7, 2, 3


def check_train_llama_hsdp_processes(n_params: int) -> dict:
    """The train_llama_hsdp counterpart at bench_1b width and half depth
    (``n_params`` the cut model's) under the launcher, the aggregator and
    the punisher, through a kill of group 1 and a whole-job outage
    (docstring, 12); returns K1's launches: the first incarnations'
    (``hsdp``) and the restarted ones' (``hsdp_restart``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "chiprun_out")
    ckpt = os.path.join(out_dir, "ckpt_hsdp")
    os.makedirs(out_dir, exist_ok=True)
    from torchft_tpu_torch.models.llama import CONFIGS

    # a durable step of both groups: the parameters and AdamW's two moments,
    # in the model's dtype; each group keeps up to two (steps 3 and 6)
    itemsize = torch.empty((), dtype=CONFIGS["bench_1b"].dtype).element_size()
    need = 2 * 2 * n_params * 3 * itemsize
    free = shutil.disk_usage(out_dir).free
    log(f"train_llama_hsdp: {free / 1e9:.1f} GB free on the checkpoints' filesystem before the "
        f"phase; the two groups' durable steps take up to {need / 1e9:.1f} GB")
    if free < 2 * need:
        raise RuntimeError(f"train_llama_hsdp: {free / 1e9:.1f} GB free under {out_dir}, less "
                           f"than twice the {need / 1e9:.1f} GB the durable checkpoints take")
    argv = [sys.executable, "-m", "torchft_tpu_torch.examples.train_llama_hsdp", "--outage-demo",
            "--config", "bench_1b", "--layers", str(CUT_LAYERS["bench_1b"]),
            "--batch-size", "1", "--seq-len", "2048",
            "--attention", "ulysses", "--transport", "pg", "--steps", str(HSDP_STEPS),
            "--kill-at-step", str(HSDP_KILL_AT), "--ckpt-dir", ckpt,
            "--ckpt-every", str(HSDP_CKPT_EVERY), "--device", "cuda", "--timeout", "120"]
    t0 = time.perf_counter()
    try:
        try:
            out = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=900)
        except subprocess.TimeoutExpired as e:
            save_transcript("train_llama_hsdp.log", (e.stdout or b"").decode().splitlines())
            raise RuntimeError("train_llama_hsdp outage demo: no end within 900 s") from e
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    lines = (out.stdout + out.stderr).splitlines()
    save_transcript("train_llama_hsdp.log", lines)
    elapsed = time.perf_counter() - t0

    def fail(msg: str) -> RuntimeError:
        return RuntimeError(msg + "\n--- transcript ---\n" + "\n".join(lines[-80:]))

    line = next((ln for ln in lines if ln.startswith("outage demo summary: ")), None)
    if line is None:
        raise fail(f"train_llama_hsdp outage demo exited {out.returncode} with no summary")
    summary = json.loads(line.split(": ", 1)[1])
    # the demo's gates: launcher rc 0 with restarts [1, 2], the PG heal in
    # place, the landed digests restored, equal final digests, K1 in every
    # incarnation, the aggregator's failover with no failed commit
    if out.returncode != 0 or summary["failures"]:
        raise fail(f"train_llama_hsdp outage demo exited {out.returncode}: "
                   f"{summary['failures']}")
    restored = {k: r["step"] for k, r in summary["restored"].items()}
    if set(restored.values()) != {str(HSDP_CKPT_EVERY)}:
        raise fail(f"train_llama_hsdp: restored steps {restored}, not {HSDP_CKPT_EVERY}")
    steps = summary["step_lines"]
    healed = [e for e in steps["group 1 incarnation 1"] if e["healed"] == "True"]
    sent = [e for e in steps["group 0 incarnation 0"] if "heal_send_s" in e]
    # past each incarnation's first step, both groups in, no heal, no save
    steady = [float(e["step_ms"]) for es in steps.values() for e in es[1:]
              if e["participants"] == "2" and e["healed"] == "False" and "save_issue_s" not in e]
    saving = [(k, e["step"], float(e["step_ms"]), float(e["save_issue_s"]))
              for k, es in steps.items() for e in es if "save_issue_s" in e]
    for key, rec in sorted(summary["landed"].items()):
        b, land = int(rec["bytes"]), float(rec["land_s"])
        log(f"train_llama_hsdp durable save group/rank {key} step {rec['step']}: "
            f"{b / 1e9:.3f} GB, issued in {float(rec['issue_s']):.3f} s (the training thread's "
            f"copy to host memory), landed {land:.3f} s after the call ({b / land / 1e9:.3f} GB/s; "
            f"DCP's write {float(rec['write_s']):.3f} s beside the digest "
            f"{float(rec['digest_s']):.3f} s)")
    for key, rec in sorted(summary["restored"].items()):
        b, sec = int(rec["bytes"]), float(rec["restore_s"])
        log(f"train_llama_hsdp durable restore group/rank {key}: step {rec['step']}, "
            f"{b / 1e9:.3f} GB in {sec:.3f} s ({b / sec / 1e9:.3f} GB/s, read, digest and copy "
            f"into the live tensors on the card)")
    for key, es in sorted(steps.items()):
        each = ", ".join(f"{e['step']}:{float(e['step_ms']):.1f}"
                         + ("(save)" if "save_issue_s" in e else "")
                         + ("(healed)" if e["healed"] == "True" else "") for e in es)
        log(f"train_llama_hsdp {key} step ms: {each}")
    med = statistics.median(steady) if steady else float("nan")
    log(f"train_llama_hsdp bench_1b ({elapsed:.1f} s, 2 groups x 1 rank under the launcher, "
        f"ulysses -> splash, {HSDP_STEPS} steps, group 1 killed after step {HSDP_KILL_AT} and "
        f"healed over PG in place, a whole-job outage after step {HSDP_CKPT_EVERY} landed): "
        f"saving steps {[(k, st, round(ms, 1), round(iss, 3)) for k, st, ms, iss in saving]} "
        f"(group, step, step ms, save issue s) beside the restarted incarnations' other steady "
        f"steps, median {med:.1f} ms ({len(steady)}); outage to the first commit after it "
        f"{summary['outage_to_first_commit_s']:.3f} s; heal over PG: heal_send_s "
        f"{[e['heal_send_s'] for e in sent]}, heal_recv_s {healed[0].get('heal_recv_s')}, "
        f"heal_chunks {healed[0].get('heal_chunks')}, heal_mb_per_s "
        f"{healed[0].get('heal_mb_per_s')}; restarts {summary['restarts']}; aggregator exit "
        f"{summary['aggregator_rc']}; final digests {summary['group_sha256']}")
    for key, d in sorted(summary["done"].items()):
        log(f"train_llama_hsdp final group/rank {key}: step {d['step']}, restored in "
            f"{d['restore_s']:.3f} s, peak device memory {d['peak_memory_bytes'] / 2**30:.2f} GiB, "
            f"via_aggregator {d['timings'].get('via_aggregator')}, aggregator_failovers "
            f"{d['timings'].get('aggregator_failovers')}, metrics {d['metrics']}")
    keys = ("splash_fwd", "splash_dq", "splash_dkv")
    first, restart = {}, {}
    for name, counts in summary["launches"].items():
        target = first if name.endswith("incarnation 0") else restart
        target[name.replace(" rank 0", "")] = dict(zip(keys, counts))
    return {"hsdp": first, "hsdp_restart": restart}


def two_ranks(store, prefix: str, fn) -> list:
    """``fn(rank, pg)`` on ranks 0 and 1 of a ``ProcessGroupHost`` mesh
    (threads); returns their results, raising the first failure."""
    from torchft_tpu_torch.process_group import ProcessGroupHost

    out, errs = [None, None], []

    def rank(r: int) -> None:
        pg = ProcessGroupHost(timeout=300)
        try:
            pg.configure(f"127.0.0.1:{store.port}/{prefix}", r, 2)
            out[r] = fn(r, pg)
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)
        finally:
            pg.shutdown()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errs:
        raise errs[0]
    if None in out:
        raise RuntimeError(f"{prefix}: a rank did not finish")
    return out


def rs_stages(x: torch.Tensor, pg) -> dict:
    """One reduce_scatter_quantized (SUM) through the device engine's own
    steps, with the card synchronized between them: K3 over the padded
    buffer, the slicing of its codes onto the host wire, the alltoall, the
    landing with K4 (np.stack, H2D, one launch), the f32 sum in rank
    order. Milliseconds per stage."""
    from torchft_tpu_torch.collectives import (
        _ceil_div, _device_from_wire, _sum_ranks, _wire_from_device)
    from torchft_tpu_torch.ops.quantization import fused_quantize_fp8

    world = pg.size()
    chunk_rows = max(1, _ceil_div(_ceil_div(x.numel(), world), ROW))
    marks = [time.perf_counter()]

    def mark() -> None:
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    q, scales, _ = fused_quantize_fp8(x, rows=world * chunk_rows)
    mark()
    sends = [_wire_from_device(q[r * chunk_rows:(r + 1) * chunk_rows],
                               scales[r * chunk_rows:(r + 1) * chunk_rows], chunk_rows * ROW)
             for r in range(world)]
    del q, scales
    mark()
    recvd = pg.alltoall(sends).get_future().wait(300)
    mark()
    deq = _device_from_wire(list(recvd), x.device)
    mark()
    _sum_ranks(deq)
    mark()
    names = ("k3_ms", "slice_ms", "wire_ms", "land_k4_ms", "sum_ms")
    return {k: (b - a) * 1e3 for k, a, b in zip(names, marks, marks[1:])}


def check_reduce_scatter_on_card(device: torch.device, full_n: int, turns: int = 3) -> dict:
    """Phase 13 (a): reduce_scatter_quantized of CUDA tensors bitwise
    against the same call on CPU tensors, then timed at ``full_n`` with
    its stages; returns every counter of ``LAUNCHES`` after the timed turns."""
    from torchft_tpu_torch.collectives import reduce_scatter_quantized
    from torchft_tpu_torch.coordination import KvStoreServer
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.process_group import ReduceOp

    n = 2 ** 24 + 777
    # rank 0: a zero row, an overflow row, a non-finite row, a subnormal row
    inputs = [make_input("specials", n, device), make_input("wide_range", n, device)]
    store = KvStoreServer("127.0.0.1:0")
    try:
        for op in (ReduceOp.SUM, ReduceOp.AVG):
            # the card's call, then the CPU's
            outs = [two_ranks(store, f"rs_{op.name}_{i}",
                              lambda r, pg, dev=dev: reduce_scatter_quantized(
                                  [inputs[r].to(dev)], op, pg).get_future().wait(300).cpu())
                    for i, dev in enumerate((device, torch.device("cpu")))]
            for r in range(2):
                a, b = outs[0][r], outs[1][r]
                if a.shape != b.shape or bits_differ(a, b):
                    raise RuntimeError(f"reduce_scatter_quantized {op.name} rank {r}: CUDA and "
                                       f"CPU chunks differ ({a.shape} vs {b.shape})")
            log(f"reduce_scatter_quantized {op.name} (world 2, n={n}, specials): CUDA kernels "
                f"== CPU plain versions, bitwise; chunk {outs[0][0].numel()} elements")
        del inputs, outs
        torch.cuda.empty_cache()

        # the timed turns at bench_1b's gradient count: this phase's path
        big = [make_input("random", full_n, device), make_input("wide_range", full_n, device)]
        torch.cuda.synchronize()
        q.reset_launches()
        calls, stages = [], []
        for turn in range(turns):
            def call(r, pg):
                pg.alltoall([np.zeros(1, np.float32)] * 2).get_future().wait(60)  # line up
                t0 = time.perf_counter()
                out = reduce_scatter_quantized([big[r]], ReduceOp.SUM, pg).get_future().wait(300)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3, out.numel()

            res = two_ranks(store, f"rs_time_{turn}", call)
            calls.append(max(ms for ms, _ in res))
            chunk = res[0][1]
            launches = dict(q.LAUNCHES)
            st = two_ranks(store, f"rs_stages_{turn}", lambda r, pg: rs_stages(big[r], pg))
            # the stage launches are not the path's
            q.LAUNCHES.update(launches)
            stages.append({k: max(s[k] for s in st) for k in st[0]})
            log(f"reduce_scatter_quantized bench_1b turn {turn}: call {calls[-1]:.1f} ms "
                f"(slower rank); stages " + " ".join(f"{k} {v:.1f}" for k, v in stages[-1].items()))
        launches = dict(q.LAUNCHES)
    finally:
        store.shutdown()
    del big
    gc.collect()
    torch.cuda.empty_cache()
    # the device engine runs K3 <false> and K4, never the host rule's K3
    if (launches["quantize_fp8_rowwise"] == 0 or launches["dequantize_fp8_rowwise"] == 0
            or launches["quantize_fp8_rowwise_host"] != 0):
        raise RuntimeError(f"reduce_scatter_quantized on the card launched {launches}")
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    log(f"reduce_scatter_quantized bench_1b (n={full_n}, world 2, SUM, chunk {chunk}, "
        f"{turns} turns): call median {statistics.median(calls):.1f} ms (each "
        f"{', '.join(f'{c:.1f}' for c in calls)}); stage medians "
        + " ".join(f"{k} {v:.1f}" for k, v in med.items()) + f"; launches {launches}")
    return launches


class _Env:
    """Environment variables set for a phase, restored after it."""

    def __init__(self, values: dict) -> None:
        self._values = values
        self._saved = {}

    def __enter__(self) -> "_Env":
        self._saved = {k: os.environ.get(k) for k in self._values}
        os.environ.update(self._values)
        return self

    def __exit__(self, *exc) -> None:
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_resilient_heal_bench_1b(device: torch.device, cfg) -> dict:
    """Phase 13 (b): bench_1b as three replica groups with the reference's
    resilient-heal fault script, healed over HTTP v3 in place (docstring,
    13)."""
    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.train import Fault, run_replicas

    rcfg = dataclasses.replace(
        # 3 steps (6 before phase 14, 5 before phase 16 needed the time):
        # step 1 is the steady one, step 2 takes the crash, the heal's two
        # faults and the flake
        cfg, replicas=3, steps=3, quantize=False, transport="http",
        layers=QUARTER_LAYERS,
        # the serve side's lock wait must outlast staging 6.45 GB (up to
        # 9.9 s on the H100): a 3 s one answered a healer's metadata request
        # 503 mid-staging, failing the init heal. The serving window's grace
        # stays at its 10 s cap.
        http_timeout=30.0, faults=(
            Fault(2, 2, "crash"),
            # the assigned source drops every serve of chunk 0: failover
            Fault(0, 2, "kill_heal_chunk", chunk=0, times=-1),
            # the standby then serves chunk 0 corrupted once
            Fault(1, 2, "corrupt_heal_chunk", chunk=0, times=1),
            Fault(0, 2, "flake_rpc", method="should_commit"),
        ))
    q.reset_launches()
    ta.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Env({"TORCHFT_RETRY_MAX_ATTEMPTS": "2", "TORCHFT_RETRY_BASE_S": "0.01"}):
        results = run_replicas(rcfg, device, on_step=lambda e: log(
            f"resilient step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
            f"participants={e['participants']} committed={e['committed']} healed={e['healed']} "
            f"attention={e['attention']} step_ms={e['step_ms']:.1f} "
            f"compute_ms={e['compute_ms']:.1f} allreduce_ms={e['allreduce_ms']:.1f} "
            f"tokens_per_s={e['tokens_per_s']:.1f} buckets={int(e['allreduce_buckets'])} "
            f"wire_ms={e['allreduce_wire_s'] * 1e3:.1f}"))
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    entries = [e for r in results for e in r["log"]]
    losses = [e["loss"] for e in entries]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"resilient heal: non-finite loss: {losses}")
    if any(r["step"] != rcfg.steps for r in results):
        raise RuntimeError(f"resilient heal: replicas stopped at {[r['step'] for r in results]}")
    healed = results[2]
    t2 = healed["timings"]
    if healed["restarts"] != 1 or healed["metrics"]["heals"] < 1:
        raise RuntimeError(f"resilient heal: replica 2 did not crash and heal: {healed['metrics']}")
    if t2["heal_failovers"] < 1 or t2["chunk_crc_failures"] < 1 or healed["metrics"]["errors"]:
        raise RuntimeError(f"resilient heal: replica 2 failovers {t2['heal_failovers']}, crc "
                           f"failures {t2['chunk_crc_failures']}, errors "
                           f"{healed['metrics']['errors']}")
    retries = sum(r["timings"]["rpc_retries"] for r in results)
    if retries < 1:
        raise RuntimeError("resilient heal: no RPC was retried")
    if not all(r["storage_kept"] for r in results):
        raise RuntimeError("resilient heal: the HTTP heal moved a live tensor's storage")
    p0 = results[0]["params"]
    for i in (1, 2):
        unequal = [k for k in p0 if not same_bits(p0[k], results[i]["params"][k])]
        if unequal:
            raise RuntimeError(f"resilient heal: replica {i} differs in {unequal[:5]}")
    dispatch = {e["attention"] for e in entries}
    if dispatch != {"splash"}:
        raise RuntimeError(f"resilient heal: attention dispatched to {dispatch}, not splash")
    for kernel in ("splash_fwd", "splash_dq", "splash_dkv"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} never launched on the resilient-heal path")
    steady = [e for e in entries if e["committed"] and e["participants"] == 3
              and not e["healed"] and e["step"] > 0]
    if not steady:
        raise RuntimeError("resilient heal: no steady step")
    med = {k: statistics.median(e[k] for e in steady)
           for k in ("step_ms", "compute_ms", "allreduce_ms", "tokens_per_s")}
    t0_, t1_ = results[0]["timings"], results[1]["timings"]
    log(f"resilient heal bench_1b ({elapsed:.1f} s, {rcfg.layers} layers, 3 replicas, "
        f"{rcfg.steps} steps, bf16 "
        f"allreduce, HTTP v3 in place): replicas bitwise equal over {len(p0)} tensors; median of "
        f"{len(steady)} steady steps: step {med['step_ms']:.1f} ms = quorum+fwd+bwd "
        f"{med['compute_ms']:.1f} ms + allreduce {med['allreduce_ms']:.1f} ms + commit+optimizer "
        f"{med['step_ms'] - med['compute_ms'] - med['allreduce_ms']:.1f} ms; "
        f"{med['tokens_per_s']:.1f} tokens/s per replica")
    log(f"resilient heal: replica 2 heal_recv_s {t2.get('heal_recv_s', float('nan')):.3f} "
        f"heal_chunks {t2.get('heal_chunks', 0):.0f} heal_mb_per_s "
        f"{t2.get('heal_mb_per_s', float('nan')):.1f} heal_attempts {t2['heal_attempts']:.0f} "
        f"heal_failovers {t2['heal_failovers']:.0f} chunk_crc_failures "
        f"{t2['chunk_crc_failures']:.0f}; replica 0 (assigned source) heal_send_s "
        f"{t0_.get('heal_send_s', float('nan')):.3f}, replica 1 (standby) standby_send_s "
        f"{t1_.get('standby_send_s', float('nan')):.3f}; rpc_retries "
        f"{[r['timings']['rpc_retries'] for r in results]}; storage kept; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    del results, p0, entries
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 14 (a): the remat modes in their turns (none twice: the second
# gives the spread between two runs of one mode), and the K1 forward
# launches each makes in a bench_1b step: one a layer, two under "full"
REMAT_TURNS = ("none", "none", "dots", "attn", "full")
REMAT_FWD_PER_LAYER = {"none": 1, "dots": 1, "attn": 1, "full": 2}
# phase 14 (c): K1 at bench_moe's attention shape (B, S, Hq, Hkv, hd)
BENCH_MOE_ATTN = (1, 2048, 16, 8, 64)
# the instances the MoE's attention runs at head dim 64 (bf16, splash)
HD64_INSTANCE = {"fwd": "attention_fwd_kernel<64, true, __nv_bfloat16>",
                 "dq": "attention_dq_kernel<64, __nv_bfloat16>",
                 "dkv": "attention_dkv_kernel<64, __nv_bfloat16>"}


def check_remat_bench_1b(device: torch.device) -> dict:
    """Phase 14 (a): one replica's bench_1b forward + backward (full width
    and depth, batch 1, seq 2048, K1) under each remat mode in turns:
    per mode the median of 3 steps by CUDA events, the step's peak device
    memory above the resting model, and K1's launches in one step. The
    loss is bitwise equal across modes and every gradient bitwise equal to
    "none"'s; K1's forward launches once a layer, twice under "full".
    Returns per mode its numbers."""
    from torchft_tpu_torch.models.llama import CONFIGS, Llama
    from torchft_tpu_torch.ops import attention as ta

    cfg = CONFIGS["bench_1b"]
    model = Llama(cfg, device=device, remat="none")
    model.init_weights(torch.Generator(device=device).manual_seed(21))
    g = torch.Generator(device=device).manual_seed(22)
    toks = torch.randint(0, cfg.vocab_size, (1, 2049), generator=g, device=device)

    def step() -> torch.Tensor:
        model.zero_grad(set_to_none=True)
        loss = model.loss(toks[:, :-1], toks[:, 1:])
        loss.backward()
        return loss.detach()

    out, base = {}, None
    for mode in REMAT_TURNS:
        model.remat = mode
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.synchronize()
        resting = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ta.reset_launches()
        loss = step()
        torch.cuda.synchronize()
        launches = {k: ta.LAUNCHES[f"splash_{k}"] for k in ATTN_MATMULS}
        peak = torch.cuda.max_memory_allocated() - resting
        grads = [p.grad for p in model.parameters()]
        if base is None:
            base = (loss, [x.clone() for x in grads])
            diff, unequal = 0.0, []
        else:
            unequal = [i for i, (a, b) in enumerate(zip(grads, base[1])) if not same_bits(a, b)]
            diff = max((max_abs_err(grads[i].float(), base[1][i].float()) for i in unequal),
                       default=0.0)
        ms = timed_ms(step, 3)
        r = out.setdefault(mode, {"ms": [], "peak_gib": 0.0})
        r["ms"].append(ms)
        r["peak_gib"] = max(r["peak_gib"], peak / 2**30)
        r.update(launches=launches, loss_equal=same_bits(loss, base[0]),
                 grads_unequal=len(unequal), grads_max_diff=diff)
        log(f"remat {mode} (bench_1b, one replica, B 1, S 2048): forward+backward {ms:.1f} ms, "
            f"peak above the resting model {peak / 2**30:.2f} GiB, K1 launches {launches}, loss "
            f"{loss.item():.6f} (bitwise equal to none: {r['loss_equal']}), gradients unlike "
            f"none's first run: {len(unequal)} of {len(grads)} (max abs diff {diff:.3e})")
    spread = out["none"]["grads_max_diff"]
    for mode, r in out.items():
        want = REMAT_FWD_PER_LAYER[mode] * cfg.n_layers
        if r["launches"] != {"fwd": want, "dq": cfg.n_layers, "dkv": cfg.n_layers}:
            raise RuntimeError(f"remat {mode}: K1 launched {r['launches']} in a step, not fwd "
                               f"{want}, dq and dkv {cfg.n_layers}")
        if not r["loss_equal"]:
            raise RuntimeError(f"remat {mode}: the loss differs from none's")
        # bitwise, unless two runs of "none" already differ: then within their spread
        if r["grads_unequal"] and not r["grads_max_diff"] <= spread:
            raise RuntimeError(f"remat {mode}: {r['grads_unequal']} gradients differ from none's "
                               f"(max abs {r['grads_max_diff']:.3e}, none-vs-none {spread:.3e})")
    del model, base
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_moe_bench_moe(device: torch.device) -> dict:
    """Phase 14 (b): the MoE at bench_moe width and depth as the trainer's
    ``--model moe --config bench_moe --batch-size 1 --seq-len 2048
    --no-quantize --steps 3 --fail-at 1`` runs it: two replica threads,
    full remat, the unquantized bf16 allreduce, replica 1 crashing after
    step 1's backward pass and healing over HTTP in place. Returns the
    run's launches."""
    from torchft_tpu_torch.models.moe import MOE_CONFIGS
    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.train import Fault, TrainConfig, run_replicas

    # 3 steps (5 before phase 16 needed the time): the crash after step 1's
    # backward pass, its heal on the redo, step 2 the steady one
    mcfg = TrainConfig(model="moe", config="bench_moe", steps=3, batch_size=1, seq_len=2048,
                       quantize=False, transport="http", remat="full",
                       layers=CUT_LAYERS["bench_moe"],
                       faults=(Fault(1, 1, "crash", at="backward"),))
    model_cfg = dataclasses.replace(MOE_CONFIGS[mcfg.config], n_layers=mcfg.layers)
    if model_cfg.head_dim != 64:
        raise RuntimeError(f"bench_moe's head dim is {model_cfg.head_dim}, not 64")
    q.reset_launches()
    ta.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = run_replicas(mcfg, device, on_step=lambda e: log(
        f"moe step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
        f"aux_loss={e['aux_loss']:.4f} dropped={e['dropped']:.4f} "
        f"participants={e['participants']} committed={e['committed']} healed={e['healed']} "
        f"attention={e['attention']} step_ms={e['step_ms']:.1f} compute_ms={e['compute_ms']:.1f} "
        f"allreduce_ms={e['allreduce_ms']:.1f} tokens_per_s={e['tokens_per_s']:.1f} "
        f"buckets={int(e['allreduce_buckets'])} wire_ms={e['allreduce_wire_s'] * 1e3:.1f}"))
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    entries = [e for r in results for e in r["log"]]
    losses = [e["loss"] for e in entries]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"bench_moe: non-finite loss: {losses}")
    if any(r["step"] != mcfg.steps for r in results):
        raise RuntimeError(f"bench_moe: replicas stopped at {[r['step'] for r in results]}")
    if results[1]["restarts"] != 1 or results[1]["metrics"]["heals"] < 1:
        raise RuntimeError(f"bench_moe: replica 1 did not crash and heal: {results[1]['metrics']}")
    if results[0]["metrics"]["commit_failures"] < 1:
        raise RuntimeError(f"bench_moe: no step was discarded: {results[0]['metrics']}")
    if not all(r["storage_kept"] for r in results):
        raise RuntimeError("bench_moe: the HTTP heal moved a live tensor's storage")
    p0, p1 = results[0]["params"], results[1]["params"]
    unequal = [k for k in p0 if not same_bits(p0[k], p1[k])]
    if unequal:
        raise RuntimeError(f"bench_moe: replicas differ in {unequal[:5]}")
    dispatch = {e["attention"] for e in entries}
    if dispatch != {"splash"}:
        raise RuntimeError(f"bench_moe: attention dispatched to {dispatch}, not splash")
    for kernel in ("splash_fwd", "splash_dq", "splash_dkv"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} (head dim 64) never launched on the bench_moe path")
    others = {k: n for k, n in launches.items()
              if n and k not in ("splash_fwd", "splash_dq", "splash_dkv")}
    if others:
        raise RuntimeError(f"bench_moe: other kernels launched: {others}")
    steady = [e for e in entries if e["committed"] and e["participants"] == 2
              and not e["healed"] and e["step"] > 0]
    if not steady:
        raise RuntimeError("bench_moe: no steady step")
    med = {k: statistics.median(e[k] for e in steady)
           for k in ("step_ms", "compute_ms", "allreduce_ms", "tokens_per_s", "aux_loss",
                     "dropped")}
    h = heal_numbers(results)
    n_params = model_cfg.num_params()
    log(f"bench_moe ({elapsed:.1f} s, {mcfg.layers} layers, {n_params:,} params, 2 replicas, "
        f"{mcfg.steps} steps, bf16 "
        f"allreduce, HTTP heal in place): replicas bitwise equal over {len(p0)} tensors; median "
        f"of {len(steady)} steady steps: step {med['step_ms']:.1f} ms = quorum+fwd+bwd "
        f"{med['compute_ms']:.1f} ms + allreduce {med['allreduce_ms']:.1f} ms + "
        f"commit+optimizer {med['step_ms'] - med['compute_ms'] - med['allreduce_ms']:.1f} ms; "
        f"{med['tokens_per_s']:.1f} tokens/s per replica; aux loss {med['aux_loss']:.4f}, "
        f"dropped {med['dropped']:.4f}; heal: heal_send_s {h['heal_send_s']:.3f} heal_recv_s "
        f"{h['heal_recv_s']:.3f} heal_chunks {h['heal_chunks']:.0f} heal_mb_per_s "
        f"{h['heal_mb_per_s']:.1f}; storage kept; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    del results, p0, p1, entries
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_bench_moe_attention(device: torch.device):
    """Phase 14 (c): K1's bf16 forward, dq and dK/dV at bench_moe's
    attention shape (head dim 64) against their plain versions, timed
    beside their bound and SDPA; returns (stats, timing) keyed as
    ``LAUNCHES``."""
    from torchft_tpu_torch.ops import attention as ta

    B, S, hq, hkv, hd = BENCH_MOE_ATTN
    g = torch.Generator(device=device).manual_seed(64)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=device).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    stats = {f"splash_{kernel}": {"err": 0.0, "ratio": 0.0, "share": 0.0}
             for kernel in ATTN_MATMULS}
    timing = {}
    check_attention_case(ta, "bench_moe", "splash", q, k, v, "", stats, timing)
    return stats, timing


def bench_1b_grad_specs() -> dict:
    """{name: (shape, dtype)} of bench_1b's parameters (a model on the meta
    device: no memory)."""
    from torchft_tpu_torch.models.llama import CONFIGS, Llama

    model = Llama(CONFIGS["bench_1b"], device="meta")
    return {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}


def bench_1b_buckets(specs: dict) -> list:
    """Element counts of the buckets the Manager's default plan (1 GiB cap)
    cuts bench_1b's gradient tree into."""
    from torchft_tpu_torch import bucketing

    leaves, _ = bucketing.tree_flatten(
        {n: torch.empty(shape, dtype=dt, device="meta") for n, (shape, dt) in specs.items()})
    return bucketing.build_plan(leaves, bucketing.DEFAULT_BUCKET_CAP_BYTES).sizes


def check_host_rule_kernel(device: torch.device, largest: int, serving_flat: int) -> dict:
    """The host-rule quantize kernel (quantize_fp8_rowwise_kernel<true>)
    against its plain version, bit for bit (codes and scales, and their
    dequantized values), on a ragged tail, bench_1b's largest gradient
    bucket and the serving plane's flat (every parameter, one publish's
    delta), each with a zero row, overflow rows, a non-finite row and a
    subnormal row; timed at the largest bucket and at the serving flat
    (under ``serving_flat``)."""
    from torchft_tpu_torch.ops import quantization as q

    out = {"mismatch": 0, "err": 0.0}
    for label, n in (("ragged_tail", ROW * 4096 + 77), ("bench_1b_largest_bucket", largest),
                     ("serving_flat", serving_flat)):
        x = make_input("specials", n, device)
        qk, sk, nk = q.fused_quantize_fp8_host(x)
        qp, sp, _ = q.quantize_fp8_host_plain(x)
        torch.cuda.synchronize()
        if qk.shape != qp.shape or sk.shape != sp.shape:
            raise RuntimeError(f"host-rule quantize shapes differ for {label}")
        mismatch = bits_differ(qk, qp) + bits_differ(sk, sp)
        err = max_abs_err(q.dequantize_fp8_plain(qk, sk, nk), q.dequantize_fp8_plain(qp, sp, nk))
        out["mismatch"] += mismatch
        out["err"] = max(out["err"], err)
        log(f"host-rule quantize check {label:>24} n={n:>10}: mismatches={mismatch}")
        if label != "ragged_tail":
            rows = qk.shape[0]
            t = {
                "n": n,
                "ms": device_ms(lambda: q.fused_quantize_fp8_host(x), 10),
                "call_ms": timed_ms(lambda: q.fused_quantize_fp8_host(x), 10),
                "plain_ms": device_ms(lambda: q.quantize_fp8_host_plain(x), 3),
                "bytes": 4 * n + rows * ROW + 4 * rows,
            }
            if label == "serving_flat":
                out["serving_flat"] = {**t, "mismatch": mismatch, "max_abs_err": err,
                                       "bound_ms": t["bytes"] / HBM_BYTES_PER_S * 1e3}
            else:
                out.update(t)
        del x, qk, sk, qp, sp
        torch.cuda.empty_cache()
    if out["mismatch"]:
        raise RuntimeError(f"the host-rule quantize kernel disagrees with its plain version in "
                           f"{out['mismatch']} elements")
    return out


def time_streamed_split(device: torch.device, n: int, reps: int = 3) -> dict:
    """Each stage of the streamed fp8 allreduce of one ``n``-element bf16
    bucket at world 2, alone: the pack (``Manager._compress_bucket_ef``'s
    EF add, host-rule quantize and residual update on the card, and the D2H
    of the codes and scales), one ring hop's raw frames of n/2 code bytes
    between two connected ``_Comm``s, a hop's arithmetic (two decodes of
    n/2 codes, each an H2D and a dequantize, the f32 add, the recode and
    its D2H), and the landing (``decompress_bucket``: H2D of n codes and a
    dequantize, the bf16 cast, the AVG divide). Median ms of ``reps`` each; logs one line per
    stage."""
    from torchft_tpu_torch import bucketing
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.utils import true_divide

    flat = make_input("random", n, device).to(torch.bfloat16)
    owner = type("Owner", (), {"_buffer_pool": bucketing.BufferPool()})()
    store = [None]
    Manager._compress_bucket_ef(owner, flat, "fp8", torch.bfloat16, store, 0)
    torch.cuda.synchronize()

    def med(fn) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {"n": n}
    out["pack_ms"] = med(lambda: Manager._compress_bucket_ef(
        owner, flat, "fp8", torch.bfloat16, store, 0))
    wire = Manager._compress_bucket_ef(owner, flat, "fp8", torch.bfloat16, store, 0)
    del flat
    half_rows = wire.payload.shape[0] // 2
    half_q, half_s = wire.payload[:half_rows], wire.scales[:half_rows]
    recv_q, recv_s = np.empty_like(half_q), np.empty_like(half_s)

    comms, kv = comm_pair("ssplit")
    try:
        def hop() -> None:
            sender = threading.Thread(target=comms[0].send_hop,
                                      args=(1, ("cseg", 0, 0, 0), half_q, half_s))
            sender.start()
            comms[1].recv_from(0)
            comms[1].recv_raw_into(0, recv_q)
            comms[1].recv_raw_into(0, recv_s)
            sender.join()

        out["hop_socket_ms"] = med(hop)
    finally:
        close_pair(comms, kv)

    seg = half_rows * ROW

    def arithmetic() -> None:
        acc = q.decode_fp8_on_card(half_q, half_s, seg, device)
        acc += q.decode_fp8_on_card(recv_q, recv_s, seg, device)
        q.encode_fp8_on_card(acc)

    out["hop_arithmetic_ms"] = med(arithmetic)
    out["landing_ms"] = med(lambda: true_divide(q.decompress_bucket(wire), 2))
    log(f"streamed allreduce split (one bf16 bucket of {n} elements, world 2, median of "
        f"{reps}, ms; a bucket takes the pack, two hops' sockets, one hop's arithmetic and "
        f"the landing):")
    for key in ("pack_ms", "hop_socket_ms", "hop_arithmetic_ms", "landing_ms"):
        log(f"  streamed split {key[:-3]}: {out[key]:.1f} ms")
    del wire, store
    torch.cuda.empty_cache()
    return out


class Fleet:
    """Two replica Managers over ProcessGroupHost against an in-process
    lighthouse (init_sync off: both participate from step 0); ``step``
    drives one allreduce on each, from two threads, and votes."""

    def __init__(self, **manager_kwargs) -> None:
        from torchft_tpu_torch.coordination import LighthouseServer
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.process_group import ProcessGroupHost

        self.lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=2,
                                           join_timeout_ms=5000, quorum_tick_ms=20,
                                           heartbeat_timeout_ms=10000)
        self.managers = [
            Manager(pg=ProcessGroupHost(timeout=300), load_state_dict=lambda sd: None,
                    state_dict=lambda: {}, min_replica_size=2, replica_id=f"fleet_{r}",
                    lighthouse_addr=f"127.0.0.1:{self.lighthouse.port}", timeout=300,
                    quorum_timeout=300, init_sync=False, **manager_kwargs)
            for r in range(2)
        ]

    def step(self, trees, quantize: bool, reduce_op=None) -> list:
        """Per replica: (reduced tree, allreduce ms to the synchronized
        result, vote, timings, this step's wire bytes sent, busy s)."""
        from torchft_tpu_torch.process_group import ReduceOp

        op = ReduceOp.AVG if reduce_op is None else reduce_op

        def replica(r: int):
            m = self.managers[r]
            m.start_quorum()
            m.wait_quorum()
            wire0 = m._pg.wire_stats()
            t0 = time.perf_counter()
            out = m.allreduce(trees[r], should_quantize=quantize, reduce_op=op).get_future().wait(600)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            wire1 = m._pg.wire_stats()
            vote = m.should_commit()
            return (out, ms, vote, m.timings(), wire1["bytes_sent"] - wire0["bytes_sent"],
                    wire1["busy_s"] - wire0["busy_s"])

        with ThreadPoolExecutor(2) as ex:
            results = list(ex.map(replica, range(2)))
        if not all(r[2] for r in results):
            raise RuntimeError("a fleet step was not committed")
        return results

    def shutdown(self) -> None:
        for m in self.managers:
            m.shutdown(wait=False)
        self.lighthouse.shutdown()


def check_streamed_on_card(device: torch.device) -> None:
    """The streamed allreduce of CUDA tensors (the codec on the card)
    against the same calls on CPU tensors (the plain versions), bit for bit:
    fp8 with error feedback, AVG, over 3 steps (the residuals carried), and
    uncompressed bf16. World 2, a 4 MiB cap (several buckets per dtype)."""

    def tree(r: int, step: int) -> dict:
        g = np.random.RandomState(100 * r + step)
        spread = lambda k: (g.randn(k) * np.exp(g.randn(k))).astype(np.float32)  # noqa: E731
        return {"w_b": spread(1 << 20).reshape(1024, 1024), "e": spread(3 * (1 << 19) + 77),
                "a": spread(5000), "f32": spread(600_001)}

    for quantize in (True, False):
        outs = []
        for dev in (device, torch.device("cpu")):
            fleet = Fleet(bucket_cap_bytes=4 << 20)
            outs.append([])
            try:
                for step in range(3):
                    trees = [{k: torch.from_numpy(v).to(dev, torch.float32 if k == "f32"
                                                        else torch.bfloat16)
                              for k, v in tree(r, step).items()} for r in range(2)]
                    res = fleet.step(trees, quantize)
                    outs[-1].append([{k: t.cpu() for k, t in r[0].items()} for r in res])
                    buckets = res[0][3]["allreduce_buckets"]
            finally:
                fleet.shutdown()
        # bf16 -> f32 is exact, so f32 bits compare bf16 values too
        differ = sum(bits_differ(a[k].float(), b[k].float())
                     for sa, sb in zip(*outs) for a, b in zip(sa, sb) for k in a)
        name = "fp8 with error feedback, AVG, 3 steps" if quantize else "uncompressed bf16, AVG, 3 steps"
        log(f"streamed allreduce ({name}, {int(buckets)} buckets): CUDA vs CPU elements that "
            f"differ: {differ}")
        if differ:
            raise RuntimeError(f"streamed allreduce ({name}): CUDA and CPU results differ")


def time_streamed_vs_serial(device: torch.device, specs: dict, turns: int = 2) -> dict:
    """The fp8-quantized allreduce of bench_1b's gradient tree (random bf16
    leaves of its parameter shapes, seeded) over two replica Managers:
    serial (``stream_buckets=False``) and streamed (the default: 1 GiB fp8
    buckets with error feedback), ``turns`` each in alternation. Logs each
    turn and the medians; returns the medians and the launches of the fp8
    kernels over the phase."""
    from torchft_tpu_torch.ops import quantization as q

    g = torch.Generator(device=device).manual_seed(31)
    trees = [{n: torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dt)
              for n, (shape, dt) in specs.items()} for _ in range(2)]
    fleets = {"serial": Fleet(stream_buckets=False), "streamed": Fleet()}
    runs = {mode: [] for mode in fleets}
    q.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(turns):
            for mode, fleet in fleets.items():
                res = fleet.step(trees, quantize=True)
                ms = max(r[1] for r in res)
                t = res[0][3]
                runs[mode].append({"ms": ms, "bytes": res[0][4], "busy_s": res[0][5], **t})
                extra = ""
                if mode == "streamed":
                    extra = (f", pack {t['allreduce_pack_s'] * 1e3:.1f} ms, wire "
                             f"{t['allreduce_wire_s'] * 1e3:.1f} ms, unpack "
                             f"{t['allreduce_unpack_s'] * 1e3:.1f} ms (sums over "
                             f"{int(t['allreduce_buckets'])} buckets), overlap_efficiency "
                             f"{t['overlap_efficiency']:.3f}")
                log(f"bench_1b quantized allreduce, {mode}: {ms:.1f} ms (replica 0 sent "
                    f"{res[0][4]} bytes, wire busy {res[0][5] * 1e3:.1f} ms){extra}")
    finally:
        for fleet in fleets.values():
            fleet.shutdown()
    launches = dict(q.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {mode: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for mode, rs in runs.items()}
    s = med["streamed"]
    log(f"bench_1b quantized allreduce medians of {turns} (two replicas on one card): serial "
        f"{med['serial']['ms']:.1f} ms, streamed {s['ms']:.1f} ms (pack "
        f"{s['allreduce_pack_s'] * 1e3:.1f} ms, wire {s['allreduce_wire_s'] * 1e3:.1f} ms, "
        f"unpack {s['allreduce_unpack_s'] * 1e3:.1f} ms, overlap_efficiency "
        f"{s['overlap_efficiency']:.3f}); replica 0 bytes sent: serial "
        f"{med['serial']['bytes']:.0f}, streamed {s['bytes']:.0f}; wire busy: serial "
        f"{med['serial']['busy_s'] * 1e3:.1f} ms, streamed {s['busy_s'] * 1e3:.1f} ms; "
        f"peak memory {peak:.1f} GiB; fp8 launches {launches}")
    del trees
    torch.cuda.empty_cache()
    return {"medians": med, "launches": launches, "peak_gib": peak}


# attention shapes: (label, B, S, Hq, Hkv, hd, paths, K/V as strided views
# of one fused [B, S, 2 Hkv, hd] tensor); bench_1b first, and its GQA shape
# is the one timed
BOTH = ("splash", "flash")
ATTN_SHAPES = (
    ("bench_1b", 1, 2048, 16, 8, 128, BOTH, False),
    ("bench_1b_fused_kv", 1, 2048, 16, 8, 128, BOTH, True),
    ("bench_1b_mha", 1, 2048, 16, 16, 128, ("flash",), False),
    ("s384", 1, 384, 16, 8, 128, BOTH, False),  # an odd number of 128-row tiles
    ("hd64_b2", 2, 256, 4, 2, 64, BOTH, False),
    ("hd256_b2", 2, 256, 4, 2, 256, BOTH, False),
)
# the dtypes the kernels take, with the suffix of their launch counts and
# the source of each kernel: attention.cu on the tensor cores (bf16, f16),
# attention_tf32x3.cu on the tensor cores by split operands (f32)
HOPPER, TF32X3 = "attention.cu", "attention_tf32x3.cu"
ATTN_DTYPES = {
    torch.bfloat16: ("", {"fwd": HOPPER, "dq": HOPPER, "dkv": HOPPER}),
    torch.float16: ("_f16", {"fwd": HOPPER, "dq": HOPPER, "dkv": HOPPER}),
    torch.float32: ("_f32", {"fwd": TF32X3, "dq": TF32X3, "dkv": TF32X3}),
}
# the most of the f16 forward's outputs that may differ from the plain
# version's at a shape. The rounding of O to f16 hides from a max-abs bar
# where P is rounded, and this share shows it: on an H100 a kernel that
# rounds P where the plain version does not differs in ~30% of its outputs
# at bench_1b (K2 against the untiled plain version, printed). K1 against
# the plain version (P kept in f32): ~0.4% on an H100, where wgmma's f32
# sums, not P, bound it. K2 against the plain version over the kernel's key
# tiles (FWD_KEY_TILE: P rounded at each tile's running max, as the kernel
# and the reference's flash kernel round it): ~3.6%, where the MUFU exp2
# and the sums still flip some of P's f16 roundings.
SHARE_BAR = {"splash": 0.01, "flash": 0.05}
# timed only (the plain versions would materialize ~8.6 GB f32 scores per
# tensor): the attention of the repo's llama3_8b config
LLAMA3_8B_ATTN = (1, 8192, 32, 8, 128)
# K1 (splash_attention_tpu) and K2 (flash_attention_tpu) in the reference
ATTN_REPLACES = {"splash": 144, "flash": 55}
# matmuls of causal size each kernel does (2 * B * Hq * hd flops per
# (query, key) pair each): fwd Q K^T, P V; dq Q K^T, dO V^T, dS K; dkv
# K Q^T, P^T dO, V dO^T, dS^T Q
ATTN_MATMULS = {"fwd": 2, "dq": 3, "dkv": 4}


def attention_bound_ms(kernel: str, B: int, S: int, hq: int, hkv: int, hd: int,
                       dtype: torch.dtype = torch.bfloat16):
    """(ms, "operations" | "bytes"): the larger of the kernel's causal flops
    over the card's peak for that work and its bytes (inputs read once,
    outputs written once) over the memory rate. The peak: bf16/f16 the
    tensor-core peak; f32 the 3xTF32 rate (three TF32 tensor-core products
    per f32 one keep f32 accuracy)."""
    pairs = B * hq * S * (S + 1) // 2
    flops = ATTN_MATMULS[kernel] * 2 * hd * pairs
    el = torch.finfo(dtype).bits // 8
    q_bytes, kv_bytes, stat_bytes = el * B * S * hq * hd, el * B * S * hkv * hd, 4 * B * hq * S
    nbytes = {
        "fwd": q_bytes + 2 * kv_bytes + q_bytes + stat_bytes,
        "dq": 2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + q_bytes,
        "dkv": 2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + 2 * kv_bytes,
    }[kernel]
    peak = TF32X3_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_f64(q, k, v, do, sm: float):
    """(o, lse, (dq, dk, dv)) in f64: autograd through a causal softmax
    attention (K/V repeated per group) on the f64 values of the inputs,
    the f32 kernels' reference."""
    group = q.shape[2] // k.shape[2]
    leaves = [x.detach().double().requires_grad_() for x in (q, k, v)]
    qf = leaves[0].transpose(1, 2)
    kf, vf = (x.transpose(1, 2).repeat_interleave(group, 1) for x in leaves[1:])
    s = (qf @ kf.transpose(-1, -2)) * sm
    S = s.shape[-1]
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=s.device).tril(), float("-inf"))
    o = (torch.softmax(s, -1) @ vf).transpose(1, 2)
    grads = torch.autograd.grad(o, leaves, do.double())
    return o.detach(), torch.logsumexp(s, -1).detach(), grads


def check_attention(device: torch.device):
    """Each attention kernel against its plain version in each dtype;
    returns per (path, kernel, dtype) stats (max abs error against the
    plain version, worst error ratio against the reference) and the
    bench_1b GQA timings, keyed as ``LAUNCHES`` is."""
    from torchft_tpu_torch.ops import attention as ta

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the plain f32 versions would not be f32")
    stats = {f"{impl}_{kernel}{suffix}": {"err": 0.0, "ratio": 0.0, "share": 0.0}
             for suffix, _ in ATTN_DTYPES.values() for impl in BOTH for kernel in ATTN_MATMULS}
    timing = {}
    for label, B, S, hq, hkv, hd, paths, fused in ATTN_SHAPES:
        for dtype, (suffix, _) in ATTN_DTYPES.items():
            g = torch.Generator(device=device).manual_seed(S + 10 * hq + hkv + hd + B)
            q = torch.randn(B, S, hq, hd, generator=g, device=device).to(dtype)
            if fused:
                kv = torch.randn(B, S, 2 * hkv, hd, generator=g, device=device).to(dtype)
                k, v = kv[:, :, :hkv], kv[:, :, hkv:]
            else:
                k, v = (torch.randn(B, S, hkv, hd, generator=g, device=device).to(dtype)
                        for _ in range(2))
            for impl in paths:
                check_attention_case(ta, label, impl, q, k, v, suffix, stats,
                                     timing if label == "bench_1b" else None)
            if label == "hd256_b2" and dtype == torch.float32:
                time_f32_hd256(ta, q, k, v)
    for key, st in stats.items():
        log(f"attention {key}: max abs error vs plain {st['err']:.3e}, "
            f"worst error ratio vs plain (against the reference) {st['ratio']:.3f}"
            + (f", most outputs differing from plain {st['share']:.4%}" if "_fwd" in key
               and not key.endswith("_f32") else ""))
    time_llama3_8b_attention(device)
    return stats, timing


def check_attention_case(ta, label, impl, q, k, v, suffix, stats, timing) -> None:
    """One (shape, dtype, path): the three kernels against their plain
    versions, each output's error against the reference within its bar;
    with ``timing``, also times them beside their bound and SDPA."""
    B, S, hq, hd = q.shape
    hkv, dtype = k.shape[2], q.dtype
    if impl == "splash":
        qi, sm = q * ta.splash_scale(hd, dtype), 1.0
    else:
        qi, sm = q, 1.0 / math.sqrt(hd)
    o_k, lse_k = ta.attention_fwd(qi, k, v, sm, impl)
    o_p, lse_p = ta.attention_fwd_plain(qi, k, v, sm, impl == "splash")
    # the gradient of sum(out.float() ** 2)
    do = (2 * o_p.float()).to(dtype)
    delta = ta.attention_delta(o_p, do)
    args = (qi, k, v, lse_p, delta, do, sm)
    if dtype == torch.float32:
        # f32 against f64; 4x: one more rounding of the sums per key tile
        ref_name, bar = "f64", 4
        o_r, lse_r, (dq_r, dk_r, dv_r) = attention_f64(qi, k, v, do, sm)
    else:
        ref_name, bar = "f32", 2
        f32 = [x.float() for x in (qi, k, v)]
        o_r, lse_r = ta.attention_fwd_plain(*f32, sm, True)
        args_32 = (*f32, lse_r, ta.attention_delta(o_r, do.float()), do.float(), sm)
        dq_r = ta.attention_dq_plain(*args_32)
        dk_r, dv_r = ta.attention_dkv_plain(*args_32)
    dq_k = ta.attention_dq(*args, impl)
    dk_k, dv_k = ta.attention_dkv(*args, impl)
    dq_p = ta.attention_dq_plain(*args)
    dk_p, dv_p = ta.attention_dkv_plain(*args)
    torch.cuda.synchronize()
    lse_err = max_abs_err(lse_k.double(), lse_r.double())
    if not lse_err <= 1e-3:
        raise RuntimeError(f"{impl} lse at {label} {dtype}: max abs error {lse_err} > 1e-3")
    if dtype != torch.float32:
        check_fwd_share(ta, label, impl, qi, k, v, sm, o_k, o_p, stats[f"{impl}_fwd{suffix}"])
    for kernel, outs in (("fwd", [(o_k, o_p, o_r)]),
                         ("dq", [(dq_k, dq_p, dq_r)]),
                         ("dkv", [(dk_k, dk_p, dk_r), (dv_k, dv_p, dv_r)])):
        key = f"{impl}_{kernel}{suffix}"
        for got, plain, ref in outs:
            if got.shape != plain.shape or not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{key} at {label}: bad shape or non-finite")
            ref = ref.double()
            e_k, e_p = max_abs_err(got.double(), ref), max_abs_err(plain.double(), ref)
            ratio = e_k / e_p if e_p > 0 else (0.0 if e_k == 0 else math.inf)
            e_kp = max_abs_err(got.double(), plain.double())
            st = stats[key]
            st["err"] = max(st["err"], e_kp)
            st["ratio"] = max(st["ratio"], ratio)
            log(f"attention {key} {label} B={B} S={S} Hq={hq} Hkv={hkv} hd={hd}: kernel err "
                f"{e_k:.3e}, plain {str(dtype).replace('torch.', '')} err {e_p:.3e} (vs "
                f"{ref_name}), kernel-plain {e_kp:.3e}")
            if not e_k <= bar * e_p:
                raise RuntimeError(
                    f"{key} at {label}: error {e_k} against {ref_name} exceeds {bar}x the plain "
                    f"version's {e_p}")
    del o_k, o_p, o_r, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p, dq_r, dk_r, dv_r
    torch.cuda.empty_cache()
    if timing is None:
        return
    fns = {
        "fwd": (lambda: ta.attention_fwd(qi, k, v, sm, impl),
                lambda: ta.attention_fwd_plain(qi, k, v, sm, impl == "splash")),
        "dq": (lambda: ta.attention_dq(*args, impl),
               lambda: ta.attention_dq_plain(*args)),
        "dkv": (lambda: ta.attention_dkv(*args, impl),
                lambda: ta.attention_dkv_plain(*args)),
    }
    sdpa_fwd, sdpa_bwd = sdpa_ms(qi, k, v, do, sm)
    for kernel, (fn, plain_fn) in fns.items():
        key = f"{impl}_{kernel}{suffix}"
        bound, by = attention_bound_ms(kernel, B, S, hq, hkv, hd, dtype)
        r = timing[key] = {
            "ms": device_ms(fn, 20), "call_ms": timed_ms(fn, 20),
            "plain_ms": device_ms(plain_fn, 3), "bound_ms": bound, "bound_by": by,
            # SDPA's backward computes dq, dk and dv in one call
            "library_ms": sdpa_fwd if kernel == "fwd" else sdpa_bwd,
        }
        log(f"attention {key} {label} timing: kernel {r['ms']:.4f} ms "
            f"(one call with its host time {r['call_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.3f} ms, sdpa {'fwd' if kernel == 'fwd' else 'bwd'} "
            f"{r['library_ms']:.4f} ms in the same dtype, bound {bound:.4f} ms ({by}, "
            f"{bound / r['ms']:.1%})")


def time_f32_hd256(ta, q, k, v) -> None:
    """Logs the device ms of K1's f32 kernels at head dim 256 (whose
    instances may spill: the ptxas lines say) beside their bound."""
    B, S, hq, hd = q.shape
    hkv = k.shape[2]
    qi = q * ta.splash_scale(hd, q.dtype)
    o, lse = ta.attention_fwd(qi, k, v, 1.0, "splash")
    do = 2 * o
    args = (qi, k, v, lse, ta.attention_delta(o, do), do, 1.0)
    fns = {"fwd": lambda: ta.attention_fwd(qi, k, v, 1.0, "splash"),
           "dq": lambda: ta.attention_dq(*args, "splash"),
           "dkv": lambda: ta.attention_dkv(*args, "splash")}
    parts = []
    for kernel, fn in fns.items():
        ms = device_ms(fn, 20)
        bound, by = attention_bound_ms(kernel, B, S, hq, hkv, hd, q.dtype)
        parts.append(f"{kernel} {ms:.4f} ms (bound {bound:.4f} ms, {by}, {bound / ms:.1%})")
    log(f"attention splash f32 at hd256_b2 (B={B} S={S} Hq={hq} Hkv={hkv} hd={hd}), device "
        "time: " + ", ".join(parts))


def share_differing(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of elements of ``a`` and ``b`` that are not equal."""
    return float((a != b).float().mean())


def check_fwd_share(ta, label, impl, q, k, v, sm, o_k, o_p, st) -> None:
    """The share of the forward kernel's outputs ``o_k`` that differ from
    the plain version's: K1's from ``o_p``, K2's from the plain version
    over the kernel's key tiles (and, printed, from the untiled ``o_p``).
    At most ``SHARE_BAR`` in f16; printed in bf16."""
    hd, dtype = q.shape[3], q.dtype
    if impl == "splash":
        share, note = share_differing(o_k, o_p), ""
    else:
        tile = ta.FWD_KEY_TILE[hd]
        share = share_differing(o_k, ta.attention_fwd_plain(q, k, v, sm, False, tile)[0])
        note = (f" over the kernel's {tile}-key tiles ({share_differing(o_k, o_p):.4%} from the "
                "untiled plain version)")
    gated = dtype == torch.float16
    st["share"] = max(st["share"], share)
    log(f"attention {impl}_fwd {str(dtype).replace('torch.', '')} {label}: {share:.4%} of the "
        f"outputs differ from the plain version's{note}"
        + (f", bar {SHARE_BAR[impl]:.0%}" if gated else ", not gated"))
    if gated and not share <= SHARE_BAR[impl]:
        raise RuntimeError(f"{impl} f16 forward at {label}: {share:.4%} of its outputs differ from "
                           f"the plain version's, above {SHARE_BAR[impl]:.0%}")


def sdpa_ms(q, k, v, do, sm: float):
    """Device ms of torch's scaled_dot_product_attention forward and of its
    backward (dq, dk and dv in one call) on the same [B, S, H, hd] inputs:
    the yardstick, never called by the port."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=sm, enable_gqa=True), 20)
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=sm, enable_gqa=True)
    do_t = do.transpose(1, 2)
    bwd = device_ms(lambda: torch.autograd.grad(out, leaves, do_t, retain_graph=True), 20)
    return fwd, bwd


def time_llama3_8b_attention(device: torch.device) -> dict:
    """Times K1's and K2's bf16 forward, dq and dkv and their f16 forward
    at the llama3_8b attention shape beside SDPA in the same dtype (no
    reference there: the plain versions would need tens of GB)."""
    from torchft_tpu_torch.ops import attention as ta

    B, S, hq, hkv, hd = LLAMA3_8B_ATTN
    sm = 1.0 / math.sqrt(hd)
    out = {}
    for dtype, suffix, kernels in ((torch.bfloat16, "", ATTN_MATMULS), (torch.float16, "_f16", ("fwd",))):
        g = torch.Generator(device=device).manual_seed(8)
        q, k, v = (torch.randn(B, S, h, hd, generator=g, device=device).to(dtype)
                   for h in (hq, hkv, hkv))
        o, lse = ta.attention_fwd(q, k, v, sm, "flash")
        do = torch.randn_like(o)
        delta = ta.attention_delta(o, do)
        fns = {"fwd": lambda impl: ta.attention_fwd(q, k, v, sm, impl),
               "dq": lambda impl: ta.attention_dq(q, k, v, lse, delta, do, sm, impl),
               "dkv": lambda impl: ta.attention_dkv(q, k, v, lse, delta, do, sm, impl)}
        for impl in ("splash", "flash"):
            for kernel in kernels:
                bound, _ = attention_bound_ms(kernel, B, S, hq, hkv, hd, dtype)
                ms = device_ms(lambda: fns[kernel](impl), 5)
                out[f"{impl}_{kernel}{suffix}"] = {"ms": ms, "bound_ms": bound}
        out[f"sdpa_fwd{suffix}"], out[f"sdpa_bwd{suffix}"] = sdpa_ms(q, k, v, do, sm)
        del q, k, v, o, lse, do, delta
    log(f"attention at llama3_8b (B={B} S={S} Hq={hq} Hkv={hkv} hd={hd}), device ms: " + ", ".join(
        f"{key} {r['ms']:.4f} (bound {r['bound_ms']:.4f}, {r['bound_ms'] / r['ms']:.1%})"
        for key, r in out.items() if isinstance(r, dict))
        + f"; sdpa bf16 fwd {out['sdpa_fwd']:.4f}, bwd {out['sdpa_bwd']:.4f}; "
        f"sdpa f16 fwd {out['sdpa_fwd_f16']:.4f}")
    return out


# the model paths of the attention kernels: (dtype, impl, the path the
# dispatch resolves to, the loss's relative bar against attention="xla" in
# the same dtype). bf16 activations round at other places on the two paths
# (as the port's bf16 Llama against the reference's,
# tests/test_torch_llama.py); f16 rounds 8x finer than bf16; f32 differs
# only in the order of its f32 sums.
MODEL_PATHS = (
    (torch.bfloat16, "flash", "flash", 2e-2),
    (torch.float32, "auto", "splash", 1e-4),
    (torch.float32, "flash", "flash", 1e-4),
    (torch.float16, "auto", "splash", 2.5e-3),
    (torch.float16, "flash", "flash", 2.5e-3),
)


# an attention kernel instance in a profiler key (any source's; simt_: the
# CUDA-core kernels of older trees, which attention_ab.py may time)
ATTN_KERNEL = re.compile(r"(?:attention|simt|tf32x3)_(?:fwd|dq|dkv)_kernel<[^>]*>")


def attention_instances(prof) -> set:
    """The attention kernel instances (``attention_dq_kernel<128,__half>``,
    ..., spaces dropped) that ran on the card under ``prof``."""
    found = set()
    for e in prof.key_averages():
        m = ATTN_KERNEL.search(e.key)
        if m and e.self_device_time_total > 0:
            found.add(m.group(0).replace(" ", ""))
    return found


def check_model_path(device: torch.device, dtype: torch.dtype, impl: str, want: str,
                     tol: float) -> dict:
    """A 2-layer bench_1b-width Llama in ``dtype`` through
    ``attention=impl``, forward and backward, against attention="xla";
    returns the launches of the dtype's kernels on that run (counts set to
    0 just before it and read just after), each of which must be > 0. The
    run is profiled, and the attention kernels that ran on the card must be
    exactly the dtype's instances in ``ATTN_INSTANCE``."""
    from torch.profiler import ProfilerActivity, profile
    from torchft_tpu_torch.models.llama import CONFIGS, Llama
    from torchft_tpu_torch.ops import attention as ta

    cfg = dataclasses.replace(CONFIGS["bench_1b"], n_layers=2, dtype=dtype)
    model = Llama(cfg, device=device, attention=impl, remat="none")
    model.init_weights(torch.Generator(device=device).manual_seed(11))
    g = torch.Generator(device=device).manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (1, 2049), generator=g, device=device)
    inputs, targets = toks[:, :-1], toks[:, 1:]
    suffix = ATTN_DTYPES[dtype][0]
    ta.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss = model.loss(inputs, targets)
        loss.backward()
        torch.cuda.synchronize()
    ran = attention_instances(prof)
    want_ran = {ATTN_INSTANCE[dtype][kernel].format(split=str(want == "splash").lower()).replace(" ", "")
                for kernel in ATTN_MATMULS}
    launches = {f"{want}_{kernel}{suffix}": ta.LAUNCHES[f"{want}_{kernel}{suffix}"]
                for kernel in ATTN_MATMULS}
    others = {k: n for k, n in ta.LAUNCHES.items() if n and k not in launches}
    dispatch = ta.LAST_DISPATCH
    grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    for layer in model.layers:
        layer.attention = "xla"
    with torch.no_grad():
        ref = model.loss(inputs, targets)
    diff = abs(loss.item() - ref.item())
    name = str(dtype).replace("torch.", "")
    log(f"model path (2-layer bench_1b, {name}, attention={impl} -> {dispatch}): loss "
        f"{loss.item():.6f}, xla {ref.item():.6f}, |diff| {diff:.2e} "
        f"({diff / abs(ref.item()):.1e} relative, bar {tol:g}), launches {launches}, "
        f"kernels {sorted(ran)}")
    if ran != want_ran:
        raise RuntimeError(f"{name} {impl} model path ran the attention kernels {sorted(ran)}, "
                           f"not {sorted(want_ran)}")
    if dispatch != want or not grads_finite or others:
        raise RuntimeError(f"{name} {impl} model path: dispatch {dispatch}, finite grads "
                           f"{grads_finite}, other kernels launched {others}")
    if not diff <= tol * abs(ref.item()):
        raise RuntimeError(f"{name} {impl} model loss {loss.item()} differs from xla {ref.item()}")
    for kernel, count in launches.items():
        if count == 0:
            raise RuntimeError(f"{kernel} never launched on the {name} {impl} model path")
    del model
    torch.cuda.empty_cache()
    return launches


def check_attention_env(device: torch.device) -> None:
    """A 2-layer bench_1b-width bf16 Llama left to its default attention
    reads ``TORCHFT_TPU_ATTENTION`` on each call: under ``xla`` its forward
    and backward resolve to the materialized path and launch no attention
    kernel; with the variable removed again its forward resolves to
    splash."""
    from torchft_tpu_torch.models.llama import CONFIGS, Llama
    from torchft_tpu_torch.ops import attention as ta

    cfg = dataclasses.replace(CONFIGS["bench_1b"], n_layers=2)
    model = Llama(cfg, device=device, remat="none")
    model.init_weights(torch.Generator(device=device).manual_seed(15))
    g = torch.Generator(device=device).manual_seed(16)
    toks = torch.randint(0, cfg.vocab_size, (1, 2049), generator=g, device=device)
    os.environ[ta.ATTENTION_ENV] = "xla"
    try:
        ta.reset_launches()
        loss = model.loss(toks[:, :-1], toks[:, 1:])
        loss.backward()
        torch.cuda.synchronize()
        dispatch, launched = ta.LAST_DISPATCH, {k: n for k, n in ta.LAUNCHES.items() if n}
    finally:
        del os.environ[ta.ATTENTION_ENV]
    with torch.no_grad():
        model.loss(toks[:, :-1], toks[:, 1:])
    unset = ta.LAST_DISPATCH
    log(f"default attention under {ta.ATTENTION_ENV}=xla (2-layer bench_1b, bf16): dispatch "
        f"{dispatch}, attention launches {launched}, loss {loss.item():.6f}; with the variable "
        f"unset: {unset}")
    if dispatch != "xla" or launched or not math.isfinite(loss.item()) or unset != "splash":
        raise RuntimeError(f"{ta.ATTENTION_ENV}=xla: dispatch {dispatch}, launches {launched}, "
                           f"loss {loss.item()}; unset: {unset}")
    del model
    torch.cuda.empty_cache()


def time_model_fwd_bwd(device: torch.device) -> dict:
    """One replica's bench_1b forward + backward at full width and depth
    (batch 1, seq 2048, per-layer remat, as the trainer runs it) through
    the materialized attention ("xla") and the kernels ("auto" -> splash),
    in turns xla, auto, auto, xla; each turn the median of 5 steps by CUDA
    events after a warm-up step. Then one step of each under
    torch.profiler: device busy time, the attention kernels' share and the
    kernel count. Also each path's peak device memory."""
    from torch.profiler import ProfilerActivity, profile
    from torchft_tpu_torch.models.llama import CONFIGS, Llama

    cfg = CONFIGS["bench_1b"]
    model = Llama(cfg, device=device, remat=True)
    model.init_weights(torch.Generator(device=device).manual_seed(13))
    g = torch.Generator(device=device).manual_seed(14)
    toks = torch.randint(0, cfg.vocab_size, (1, 2049), generator=g, device=device)

    def step(impl: str) -> None:
        for layer in model.layers:
            layer.attention = impl
        model.zero_grad(set_to_none=True)
        model.loss(toks[:, :-1], toks[:, 1:]).backward()

    out = {impl: {"ms": [], "peak_gib": 0.0} for impl in ("xla", "auto")}
    for impl in ("xla", "auto", "auto", "xla"):
        torch.cuda.reset_peak_memory_stats()
        out[impl]["ms"].append(timed_ms(lambda: step(impl), 5))
        out[impl]["peak_gib"] = max(out[impl]["peak_gib"],
                                    torch.cuda.max_memory_allocated() / 2**30)
    for impl, r in out.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(impl)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        r["busy_ms"] = sum(e.self_device_time_total for e in events) / 1e3
        r["attention_ms"] = sum(e.self_device_time_total for e in events
                                if ATTN_KERNEL.search(e.key)) / 1e3
        r["kernels"] = sum(e.count for e in events if e.self_device_time_total > 0)
        log(f"one replica bench_1b forward+backward, attention={impl}: "
            f"turns {[round(t, 1) for t in r['ms']]} ms, peak {r['peak_gib']:.2f} GiB; "
            f"profiled step: wall {wall:.1f} ms, device busy {r['busy_ms']:.1f} ms "
            f"({r['kernels']} kernels), attention kernels {r['attention_ms']:.1f} ms")
    del model
    torch.cuda.empty_cache()
    return out


# phase 15: the redundancy plane at bench_1b (docstring, 15)
# 7 steps (8 before phase 16 needed the time): the spare commits steps 5 and 6
RED_MEMBERS, RED_STEPS = 3, 7
RED_CRASH = (2, 3)  # crashes at the step's start and restarts: healed by reconstruct
RED_DEATH = (1, 5)  # dies at the step's start, for good: the spare takes its place
# a generation every second commit: the host (101 GB on the H100 machine)
# holds the stores' 29 GB, each stager's blob and parity, the spare's
# resident generation and a heal's snapshots, not every member's staging
# of every commit at once (PERF.md, PR 15)
RED_INTERVAL = 2


class HostMemory:
    """Samples this process's resident set and the host's MemAvailable
    every 0.2 s on a thread, for a phase's host peak."""

    def __init__(self) -> None:
        self.peak_rss = 0
        self.min_available = self.available()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def available() -> int:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
        return -1

    @staticmethod
    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self) -> None:
        while not self._stop.wait(0.2):
            self.peak_rss = max(self.peak_rss, self.rss())
            self.min_available = min(self.min_available, self.available())

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def check_redundancy_bench_1b(device: torch.device, cfg, http_heal: dict) -> dict:
    """Phase 15: bench_1b as three replica threads and one hot spare with
    the redundancy plane on (k 2, m 1, retain 1, a generation staged every
    RED_INTERVAL commits); replica 2 crashes and heals by reconstruct through
    the parity shard, replica 1 dies and the spare takes its place
    (docstring, 15).
    Returns the phase's launches."""
    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.train import Fault, run_replicas

    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                             "trace_redundancy")
    shutil.rmtree(trace_dir, ignore_errors=True)
    rcfg = dataclasses.replace(
        cfg, replicas=RED_MEMBERS, steps=RED_STEPS, quantize=True, transport="http",
        layers=QUARTER_LAYERS, redundancy=(2, 1), redundancy_retain=1,
        redundancy_interval=RED_INTERVAL, spares=1,
        trace_dir=trace_dir,
        faults=(Fault(RED_CRASH[0], RED_CRASH[1], "crash"),
                Fault(RED_DEATH[0], RED_DEATH[1], "die")))
    gc.collect()
    torch.cuda.empty_cache()
    # the earlier phases' freed heap and cached page-locked blocks go back
    # to the host before the phase's ~80 GB peak
    empty_host = getattr(torch._C, "_host_emptyCache", None)
    if empty_host is not None:
        empty_host()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    log(f"redundancy: host MemAvailable {HostMemory.available() / 2**30:.1f} GiB, this process's "
        f"RSS {HostMemory.rss() / 2**30:.1f} GiB before the phase")
    q.reset_launches()
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    # four bench_1b replicas and a promotion fill the card to ~70 GiB of
    # its 79: a cache of fixed segments failed a 1 GiB request with 5.8
    # GiB reserved but free (an H100 80GB, the crash after a backward
    # pass), and segments that grow serve it. The phase runs last; it sets
    # them back
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    host = HostMemory()
    t0 = time.perf_counter()
    try:
        results = run_replicas(rcfg, device, on_step=lambda e: log(
            f"redundancy step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
            f"participants={e['participants']} committed={e['committed']} healed={e['healed']} "
            f"attention={e['attention']} step_ms={e['step_ms']:.1f} "
            f"compute_ms={e['compute_ms']:.1f} allreduce_ms={e['allreduce_ms']:.1f} "
            f"stage_hot_ms={e['stage_hot_ms']:.1f} tokens_per_s={e['tokens_per_s']:.1f}"))
    finally:
        host.stop()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    died, spare, rejoined = results[RED_DEATH[0]], results[RED_MEMBERS], results[RED_CRASH[0]]
    alive = [r for i, r in enumerate(results) if i != RED_DEATH[0]]
    entries = [e for r in results for e in r["log"]]
    losses = [e["loss"] for e in entries]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"redundancy: non-finite loss: {losses}")
    # the crash healed by reconstruct, through the parity shard
    last = rejoined.get("last_incarnation", {})
    if rejoined.get("restarts") != 1 or last.get("reconstructs") != 1 \
            or last.get("reconstruct_failures") != 0:
        raise RuntimeError(f"redundancy: replica {RED_CRASH[0]}'s rejoin did not heal by "
                           f"reconstruct: restarts {rejoined.get('restarts')}, {last}")
    red = rejoined["redundancy"]
    if red.get("reconstruct_shards_ok") != 2 or rejoined["timings"]["shard_fetch_failed"] < 1:
        raise RuntimeError(f"redundancy: the reconstruct did not decode through parity: {red}")
    # the death covered by the spare
    if not died.get("died") or spare.get("promotion", {}).get("replaces") != died["replica_id"]:
        raise RuntimeError(f"redundancy: the spare did not replace replica {RED_DEATH[0]}: "
                           f"{spare.get('promotion')}, {died.get('replica_id')}")
    bad = [(r["step"], r["metrics"]["errors"]) for r in alive
           if r["step"] != RED_STEPS or r["metrics"]["errors"]]
    if bad:
        raise RuntimeError(f"redundancy: members at (step, errors) {bad}")
    # the dead stores: the crashed incarnation retired, the dead left out
    # of placement
    put_failed = [r["timings"]["shard_put_failed"] for r in alive]
    if any(put_failed):
        raise RuntimeError(f"redundancy: shards put to a dead store: {put_failed}")
    p0 = alive[0]["params"]
    for r in alive[1:]:
        unequal = [k for k in p0 if not same_bits(p0[k], r["params"][k])]
        if unequal:
            raise RuntimeError(f"redundancy: members differ in {unequal[:5]}")
    if not all(r["storage_kept"] for r in alive):
        raise RuntimeError("redundancy: a heal or the promotion moved a live tensor's storage")
    # no committed step lost: within an incarnation each step commits once,
    # and the fleet's committed frontier never moves back
    for r in results:
        for inc in _incarnations(r["log"]):
            steps = [e["step"] for e in inc if e["committed"]]
            if steps != sorted(set(steps)):
                raise RuntimeError(f"redundancy: a step committed twice: {steps}")
    frontier = -1
    for e in sorted((e for e in entries if e["committed"]), key=lambda e: e["at"]):
        if e["step"] < frontier - 1:
            raise RuntimeError(f"redundancy: step {e['step']} committed behind the frontier "
                               f"{frontier}")
        frontier = max(frontier, e["step"])
    if frontier != RED_STEPS - 1:
        raise RuntimeError(f"redundancy: the frontier ended at {frontier}")

    # the spare started from its prefetched generation of the death's
    # step: no heal, so no peer pull
    st = spare["timings"]
    if spare["redundancy"].get("spare_promote_step") != RED_DEATH[1] or st["heal_attempts"] \
            or st["reconstruct_failures"]:
        raise RuntimeError(f"redundancy: the spare did not join from its prefetch of step "
                           f"{RED_DEATH[1]}: {spare['redundancy']}, heal_attempts "
                           f"{st['heal_attempts']}")
    spare_commits = [e for e in spare["log"] if e["committed"]]
    death_ms = (spare_commits[0]["at"] - died["died_at"]) * 1e3
    death_steps = spare_commits[0]["step"] - RED_DEATH[1]
    steady = [e for e in entries if e["committed"] and e["participants"] == RED_MEMBERS
              and not e["healed"] and e["step"] > 0]
    med = {k: statistics.median(e[k] for e in steady)
           for k in ("step_ms", "compute_ms", "allreduce_ms", "tokens_per_s")}
    staged = [e["stage_hot_ms"] for e in steady if e["stage_hot_ms"] > 0]
    unstaged = [e["step_ms"] for e in steady if e["stage_hot_ms"] == 0]
    log(f"redundancy bench_1b ({elapsed:.1f} s, {rcfg.layers} layers, {RED_MEMBERS} replicas "
        f"+ 1 spare, {RED_STEPS} "
        f"steps, fp8 allreduce, k 2 m 1 retain 1 interval {RED_INTERVAL}): members and the promoted spare "
        f"bitwise equal over {len(p0)} tensors; median of {len(steady)} steady steps: step "
        f"{med['step_ms']:.1f} ms = quorum+fwd+bwd {med['compute_ms']:.1f} ms (the staging's hot "
        f"path within it) + allreduce {med['allreduce_ms']:.1f} ms + commit+optimizer "
        f"{med['step_ms'] - med['compute_ms'] - med['allreduce_ms']:.1f} ms; "
        f"{med['tokens_per_s']:.1f} tokens/s per replica; staged steps' hot path "
        f"shard_stage_hot_s median {statistics.median(staged) if staged else float('nan'):.1f} ms "
        f"over {len(staged)}; steady steps that staged nothing: "
        f"{len(unstaged)}")
    for i, r in enumerate(results):
        if "redundancy" in r:
            rr = r["redundancy"]
            log(f"redundancy replica {i}: " + ", ".join(
                f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in rr.items()))
    log(f"redundancy heal: replica {RED_CRASH[0]} reconstruct_s {red['reconstruct_s']:.3f} "
        f"({red['reconstruct_mb_per_s']:.1f} MB/s), shards ok {red['reconstruct_shards_ok']:.0f}, "
        f"failed {rejoined['timings']['shard_fetch_failed']:.0f}, corrupt "
        f"{rejoined['timings']['shard_corrupt']:.0f}; phase 6's HTTP peer pull of the "
        f"full-depth state (twice the bytes) in this call: heal_recv_s "
        f"{http_heal['heal_recv_s']:.3f} "
        f"({http_heal['heal_mb_per_s']:.1f} MiB/s), the source staging in "
        f"{http_heal['heal_send_s']:.3f} s")
    log(f"redundancy spare: promoted in place of {died['replica_id']} at prefetched step "
        f"{spare['redundancy'].get('spare_promote_step', float('nan')):.0f}; from the death to "
        f"the spare's first commit {death_ms:.1f} ms and {death_steps} step(s) (it committed "
        f"step {spare_commits[0]['step']}; replica {RED_DEATH[0]} died at the start of step "
        f"{RED_DEATH[1]}, once the spare held that step's generation; no heal); promote() "
        f"waited {spare['promotion']['promote_s']:.1f} s from the spare's start")
    # the plane's spans, from the merged trace of every incarnation's dump
    with open(os.path.join(trace_dir, "merged_trace.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"
                 and e["name"] in ("reconstruct", "shard_stage")]
    for rid in sorted({e["args"]["replica_id"] for e in spans}):
        mine = [e for e in spans if e["args"]["replica_id"] == rid]
        log(f"redundancy spans {rid}: " + ", ".join(
            f"{e['name']} step {e['args'].get('step')} {e['dur'] / 1e3:.1f} ms" for e in mine))
    log(f"redundancy memory: device peak {peak / 2**30:.2f} GiB; host: this process's peak RSS "
        f"{host.peak_rss / 2**30:.1f} GiB, MemAvailable at least {host.min_available / 2**30:.1f} "
        f"GiB during the phase; launches {launches}")
    dispatch = {e["attention"] for e in entries}
    if dispatch != {"splash"}:
        raise RuntimeError(f"redundancy: attention dispatched to {dispatch}, not splash")
    for kernel in ("splash_fwd", "splash_dq", "splash_dkv", "quantize_fp8_rowwise_host",
                   "dequantize_fp8_rowwise"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} never launched on the redundancy path")
    del results, p0, entries, alive
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _incarnations(log_entries: list) -> list:
    """A replica's log cut where its step went back (a restart)."""
    out, cur, last = [], [], None
    for e in log_entries:
        if last is not None and e["step"] < last:
            out.append(cur)
            cur = []
        cur.append(e)
        last = e["step"]
    return out + [cur] if cur else out


# phase 16: the health and tracing planes at bench_1b (docstring, 16)
# the run goes on past HW_STEPS until a step all three take part in
HW_REPLICAS, HW_STEPS = 3, 11
# replica 2 sleeps before each allreduce from this step (its warm-up
# before: step 0's init heal, steps 1 and 2 its compute samples, step 1
# under the profiler) until it sees itself ejected
HW_SLOW = (2, 3)
# the shortened healthwatch knobs of the phase (PROBATION_MS, set in the
# phase: about two of its own steps, HW_PROBATION_STEPS of phase 6's; an
# ejection lands just after a quorum, and a probation shorter than the
# phase's step readmits the straggler before any quorum excludes it)
HW_KNOBS = {"TORCHFT_HEALTH_MIN_SAMPLES": "3", "TORCHFT_HEALTH_EJECT_STEPS": "2",
            "TORCHFT_HEALTH_PROBE_OK": "2", "TORCHFT_METRICS_PORT": "0"}
# three replicas' fp8 step ran 2.5-2.75x phase 6's two-replica one (H100
# 80GB HBM3, 700 W)
HW_PROBATION_STEPS = 5
HW_PROFILE_STEP = 1  # replica 0's step under torch.profiler
# the tracing and telemetry cost's share of the steady step (bench.py:574-620)
HW_COST_BAR = 0.01


class Scraper:
    """Scrapes every ``/metrics`` of a run (the lighthouse's and each live
    Manager's, as ``fleet`` names them) every ``every`` seconds on a thread;
    counts the answers and the failures per endpoint. A scrape that fails
    after its endpoint left ``fleet`` (a Manager or the lighthouse shutting
    down) is not counted."""

    def __init__(self, fleet: dict, every: float = 1.0) -> None:
        self.ok: dict = {}
        self.failed: dict = {}
        self._fleet = fleet
        self._every = every
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _scrape(self, name: str, url: str, live) -> None:
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=10.0) as resp:
                body = resp.read().decode()
            if "# TYPE" not in body:
                raise RuntimeError(f"no exposition from {url}")
            self.ok[name] = self.ok.get(name, 0) + 1
        except Exception as e:  # noqa: BLE001 - counted, gated after the run
            if live():
                self.failed.setdefault(name, []).append(repr(e)[:200])

    def _run(self) -> None:
        while not self._stop.wait(self._every):
            lh = self._fleet.get("lighthouse")
            if lh is None:
                continue
            self._scrape("lighthouse", f"http://{lh}/metrics",
                         lambda: self._fleet.get("lighthouse") == lh)
            ports = self._fleet.get("metrics_ports", {})
            for rid, port in list(ports.items()):
                self._scrape(f"replica {rid}", f"http://127.0.0.1:{port}/metrics",
                             lambda rid=rid, port=port: ports.get(rid) == port)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def tracing_cost_us(calls: int = 20000) -> dict:
    """The port's per-span record cost (span, record_rel and instant in
    turns, as bench.py:574-620) and the telemetry's per-step cost (a
    publish to the heartbeat and the summary read back, on a live
    ManagerServer), in microseconds."""
    from torchft_tpu_torch.coordination import LighthouseServer, ManagerServer
    from torchft_tpu_torch.tracing import SpanRecorder, TraceConfig

    rec = SpanRecorder("cost", TraceConfig(buffer=4096))
    rec.set_context(quorum_id=1, step=1)
    t0 = time.perf_counter()
    for i in range(calls):
        with rec.span("bench_span", cat="commit"):
            pass
        pc = time.perf_counter()
        rec.record_rel("bench_rel", cat="allreduce", t0_pc=pc - 1e-4, t1_pc=pc, bucket=i)
        rec.instant("bench_instant", cat="rpc")
    span_us = (time.perf_counter() - t0) / (3 * calls) * 1e6
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1)
    server = ManagerServer(replica_id="cost", lighthouse_addr=f"127.0.0.1:{lh.port}",
                           bind="127.0.0.1:0", heartbeat_interval=0.1)
    try:
        n = 2000
        t0 = time.perf_counter()
        for i in range(n):
            server.publish_telemetry({"step": i, "step_s": 1.0, "wire_s": 0.5,
                                      "heal_attempts": 0.0, "rpc_retries": 0.0,
                                      "collective_reroute": 0.0, "chunk_crc_failures": 0.0})
            server.health()
        telemetry_us = (time.perf_counter() - t0) / n * 1e6
    finally:
        server.shutdown()
        lh.shutdown()
    return {"span_us": span_us, "telemetry_us": telemetry_us}


def check_health_tracing_bench_1b(device: torch.device, cfg, steady_step_ms: float) -> dict:
    """Phase 16: bench_1b as three replica threads with the health plane
    ejecting and tracing on; replica 2 runs slow until ejected, is
    readmitted after probation and heals (docstring, 16). Returns the
    phase's launches."""
    from torchft_tpu_torch.coordination import health_replay
    from torchft_tpu_torch.healthwatch import HealthConfig, HealthLedger, history_script
    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.tracing import load_history
    from torchft_tpu_torch.train import Fault, run_replicas

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                           "trace_health")
    shutil.rmtree(out_dir, ignore_errors=True)
    probation_ms = int(HW_PROBATION_STEPS * steady_step_ms)
    hcfg = dataclasses.replace(
        cfg, replicas=HW_REPLICAS, steps=HW_STEPS, quantize=True, transport="http",
        layers=CUT_LAYERS["bench_1b"], health="eject", trace_dir=out_dir,
        profile_step=HW_PROFILE_STEP,
        faults=(Fault(HW_SLOW[0], HW_SLOW[1], "slow", at="backward", times=-1),))
    q.reset_launches()
    ta.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # Kineto initializes on the first profiler's thread, and must on this
    # one: replica 0's thread profiles its step
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
    fleet: dict = {}
    t0 = time.perf_counter()
    with _Env({**HW_KNOBS, "TORCHFT_HEALTH_PROBATION_MS": str(probation_ms)}):
        health_cfg = HealthConfig.from_env()
        scraper = Scraper(fleet)
        try:
            results = run_replicas(hcfg, device, fleet=fleet, on_step=lambda e: log(
                f"health step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
                f"participants={e['participants']} committed={e['committed']} "
                f"healed={e['healed']} health_state={e['health_state']:.0f} "
                f"step_ms={e['step_ms']:.1f} compute_ms={e['compute_ms']:.1f} "
                f"allreduce_ms={e['allreduce_ms']:.1f} slow_ms={e['slow_ms']:.1f} "
                f"wire_ms={e['allreduce_wire_s'] * 1e3:.1f}"))
        finally:
            scraper.stop()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    entries = [e for r in results for e in r["log"]]
    losses = [e["loss"] for e in entries]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"health: non-finite loss: {losses}")
    slow = results[HW_SLOW[0]]
    peers = [r for i, r in enumerate(results) if i != HW_SLOW[0]]
    st = slow["timings"]

    # the straggler: ejected within min_samples + eject_steps + 2 of its
    # scored steps (its committed steps from the first slow one up to its
    # exclusion, which its heal on readmission ends)
    slow_log = slow["log"]
    first_slow = next(i for i, e in enumerate(slow_log) if e["slow_ms"] > 0)
    back = next((i for i, e in enumerate(slow_log) if i > first_slow and e["healed"]), None)
    if back is None:
        raise RuntimeError(f"health: replica {HW_SLOW[0]} was not readmitted and healed: "
                           f"{fleet['health'].get('recent_events')}")
    scored = sum(1 for e in slow_log[first_slow:back] if e["committed"])
    bar = health_cfg.min_samples + health_cfg.eject_steps + 2
    if scored > bar:
        raise RuntimeError(f"health: ejected after {scored} scored steps, more than {bar}")
    out = [[e for e in r["log"] if e["committed"] and e["participants"] == HW_REPLICAS - 1]
           for r in peers]
    if min(len(o) for o in out) < 2:
        raise RuntimeError(f"health: the peers committed {[len(o) for o in out]} steps while "
                           "replica 2 was out, fewer than 2")
    if slow_log[back]["slow_ms"] or not slow["storage_kept"] or slow["metrics"]["errors"]:
        raise RuntimeError(f"health: replica {HW_SLOW[0]} did not heal in place after its "
                           f"readmission: {slow['metrics']}, storage kept {slow['storage_kept']}")
    if (st["ejections"], st["readmissions"]) != (1.0, 1.0) or any(
            r["timings"]["ejections"] for r in peers):
        raise RuntimeError(f"health: ejections/readmissions {st['ejections']}/"
                           f"{st['readmissions']}, peers' ejections "
                           f"{[r['timings']['ejections'] for r in peers]}")
    kinds = [e["kind"] for e in fleet["health"].get("recent_events", [])]
    if "eject" not in kinds or "readmit" not in kinds:
        raise RuntimeError(f"health: the lighthouse's recent_events hold {kinds}")
    p0 = results[0]["params"]
    for i in range(1, HW_REPLICAS):
        unequal = [k for k in p0 if not same_bits(p0[k], results[i]["params"][k])]
        if unequal:
            raise RuntimeError(f"health: replica {i} differs in {unequal[:5]}")
    # the recorded telemetry through both ledgers: the same transitions
    history = load_history(os.path.join(out_dir, "lighthouse_history.jsonl"))
    script = history_script(history)
    opts = dict(health_cfg.to_json(), mode="eject", heartbeat_timeout_ms=2000,
                min_replicas=HW_REPLICAS - 1)
    native = [(e["t_ms"], e["kind"], e["replica_id"]) for e in health_replay(script, opts)["events"]]
    ledger = HealthLedger(dataclasses.replace(health_cfg, mode="eject"), heartbeat_timeout_ms=2000,
                          min_replicas=HW_REPLICAS - 1)
    python = []
    for x in script:
        evs = (ledger.tick(x["t_ms"]) if x.get("tick")
               else ledger.on_heartbeat(x["replica_id"], x.get("telemetry"), x["t_ms"]))
        python += [(x["t_ms"], e["kind"], e["replica_id"]) for e in evs]
    if native != python or not any(k == "eject" for _, k, _ in python):
        raise RuntimeError(f"health: the replayed telemetry's transitions differ or hold no "
                           f"eject: native {native}, python {python}")
    live = [(e["kind"], e["replica_id"].split(":")[0]) for e in history
            if e.get("kind") in ("straggler_warn", "eject", "readmit")]

    # tracing: the merged trace's spans, the rings' losses, the scrapes
    with open(fleet["trace"]) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    want = {"quorum_rpc", "pack", "wire", "unpack", "commit_vote"}
    for i in range(HW_REPLICAS):
        names = {e["name"] for e in spans if e["args"]["replica_id"].startswith(f"replica_{i}:")}
        if not want <= names:
            raise RuntimeError(f"health: replica {i}'s merged spans lack {want - names}")
    if not any(e["name"] == "heal_recv" and e["args"]["replica_id"].startswith(
            f"replica_{HW_SLOW[0]}:") for e in spans):
        raise RuntimeError(f"health: no heal_recv span of replica {HW_SLOW[0]}")
    dropped = [r["timings"]["trace_dropped"] for r in results]
    if any(dropped):
        raise RuntimeError(f"health: spans dropped {dropped}")
    if scraper.failed or len(scraper.ok) != HW_REPLICAS + 1:
        raise RuntimeError(f"health: /metrics scrapes answered {scraper.ok}, failed "
                           f"{ {k: v[:2] for k, v in scraper.failed.items()} }")
    prof_path = os.path.join(out_dir, f"profile_step{HW_PROFILE_STEP}.json")
    with open(prof_path) as f:
        prof = json.load(f)["traceEvents"]
    # every kernel of three replicas' step: too large to bring back
    os.remove(prof_path)
    k1_fwd = ATTN_INSTANCE[torch.bfloat16]["fwd"].format(split="true").replace(" ", "")
    kernels = {m.group(0).replace(" ", "") for e in prof if e.get("cat") == "kernel"
               for m in [ATTN_KERNEL.search(e.get("name", ""))] if m}
    ranges = {e.get("name") for e in prof if str(e.get("name", "")).startswith("torchft::")}
    if "torchft::manager::wait_quorum" not in ranges or k1_fwd not in kernels:
        raise RuntimeError(f"health: the profiled step lacks wait_quorum or K1's forward: "
                           f"ranges {sorted(ranges)}, attention kernels {sorted(kernels)}")

    # the cost: spans a step x the cost of one + the telemetry's, over the
    # steady step
    slept = {e["step"] for e in slow_log if e["slow_ms"] > 0}
    steady = [e for e in entries if e["committed"] and e["participants"] == HW_REPLICAS
              and not e["healed"] and e["step"] > 0 and e["step"] not in slept]
    if not steady:
        raise RuntimeError("health: no steady step")
    med = {k: statistics.median(e[k] for e in steady)
           for k in ("step_ms", "compute_ms", "allreduce_ms", "tokens_per_s")}
    per_step = [sum(1 for e in spans if e["args"]["replica_id"].startswith(f"replica_{i}:"))
                / max(1, sum(1 for e in results[i]["log"] if e["committed"]))
                for i in range(HW_REPLICAS)]
    cost = tracing_cost_us()
    share = (max(per_step) * cost["span_us"] + cost["telemetry_us"]) / (med["step_ms"] * 1e3)
    if share >= HW_COST_BAR:
        raise RuntimeError(f"health: tracing and telemetry cost {share:.4%} of the step")
    out_ms = statistics.median(e["step_ms"] for o in out for e in o)
    h = slow["timings"]
    log(f"health bench_1b ({elapsed:.1f} s, {hcfg.layers} layers, {HW_REPLICAS} replicas, fp8 "
        f"allreduce, health eject: "
        f"min_samples {health_cfg.min_samples}, eject_steps {health_cfg.eject_steps}, probation "
        f"{health_cfg.probation_ms} ms, probe_ok {health_cfg.probe_ok}): replicas bitwise equal "
        f"over {len(p0)} tensors at step {results[0]['step']}; median of {len(steady)} steady "
        f"steps: step {med['step_ms']:.1f} ms = quorum+fwd+bwd {med['compute_ms']:.1f} ms + "
        f"allreduce {med['allreduce_ms']:.1f} ms + commit+optimizer "
        f"{med['step_ms'] - med['compute_ms'] - med['allreduce_ms']:.1f} ms; "
        f"{med['tokens_per_s']:.1f} tokens/s per replica")
    log(f"health straggler: replica {HW_SLOW[0]} slept "
        f"{[round(e['slow_ms'], 1) for e in slow_log if e['slow_ms'] > 0]} ms before its "
        f"allreduces, ejected after {scored} scored steps (bar {bar}); the ejected quorum's "
        f"step {out_ms:.1f} ms median over {sum(len(o) for o in out)} peer steps "
        f"({[len(o) for o in out]}); readmitted and healed: heal_recv_s "
        f"{h.get('heal_recv_s', float('nan')):.3f} ({h.get('heal_mb_per_s', float('nan')):.1f} "
        f"MiB/s, {h.get('heal_chunks', 0):.0f} chunks); ejections {st['ejections']:.0f}, "
        f"readmissions {st['readmissions']:.0f}; live transitions {live}; replayed through both "
        f"ledgers: {[(k, r.split(':')[0]) for _, k, r in python]}")
    log(f"health tracing: {len(spans)} spans merged, spans per step "
        f"{[round(x, 2) for x in per_step]}, {cost['span_us']:.3f} us a span, telemetry "
        f"{cost['telemetry_us']:.3f} us a step: {share:.5%} of the steady step (bar "
        f"{HW_COST_BAR:.0%}); trace_dropped {dropped}; /metrics scrapes answered {scraper.ok}; "
        f"profiled step {HW_PROFILE_STEP} of replica 0 holds torchft::manager::wait_quorum and "
        f"{k1_fwd} in one Kineto trace; device peak {peak / 2**30:.2f} GiB; launches {launches}")
    for kernel in ("splash_fwd", "splash_dq", "splash_dkv", "quantize_fp8_rowwise_host",
                   "dequantize_fp8_rowwise"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} never launched on the health path")
    del results, p0, entries
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 17: the serving plane at bench_1b (docstring, 17)
SV_STEPS, SV_WORKERS = 6, 2
# replica 0 crashes after this step's backward pass (its source sorts first
# among equal versions, so workers held behind it dial it first)
SV_CRASH = (0, 3)
# a delta's bytes against a full pull's: at least this many times fewer
SV_DELTA_SAVING = 3.0


def _pct(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q)) if xs else float("nan")


def check_serving_bench_1b(device: torch.device, cfg, steady_step_ms: float) -> dict:
    """Phase 17: bench_1b as two replica threads publishing every commit to
    two serve workers on the card under closed-loop /infer traffic, through
    a crash, a heal and a bootstrap (docstring, 17). Its steady step is
    logged beside ``steady_step_ms``, the same trainers' without the plane
    (phase 6, this call). Returns the phase's launches and the serving
    path's own."""
    from torchft_tpu_torch import serving
    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.train import SERVE_REQUESTS, Fault, run_replicas

    scfg = dataclasses.replace(
        cfg, steps=SV_STEPS, quantize=True, transport="http", serve_workers=SV_WORKERS,
        serve_compress="fp8", layers=CUT_LAYERS["bench_1b"],
        faults=(Fault(SV_CRASH[0], SV_CRASH[1], "crash", at="backward"),))
    crasher, crash_step = SV_CRASH
    hold, released = threading.Event(), threading.Event()
    held_pulls = [0]

    def hook(event: str, info: dict):
        # the workers' pulls wait while held: they stay behind the version
        # the dying source announces last
        if event == "worker_pull" and hold.is_set() and not released.is_set():
            held_pulls[0] += 1
            while not released.wait(0.01):
                pass
        return None

    def on_step(e: dict) -> None:
        log(f"serve step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
            f"participants={e['participants']} committed={e['committed']} healed={e['healed']} "
            f"step_ms={e['step_ms']:.1f} compute_ms={e['compute_ms']:.1f} "
            f"allreduce_ms={e['allreduce_ms']:.1f} serve_publish_ms={e['serve_publish_ms']:.3f}")
        if e["replica"] == crasher and e["step"] == crash_step - 2 and e["committed"]:
            hold.set()
        if (e["replica"] != crasher and e["step"] == crash_step and not e["committed"]) \
                or e["step"] > crash_step:
            released.set()

    q.reset_launches()
    ta.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    torch.cuda.reset_peak_memory_stats()
    # two trainers, two publishers and two workers fill an H100 80GB HBM3
    # (700 W) to 74.1 GiB at the peak: segments that grow, as phase 15's
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    host = HostMemory()
    fleet: dict = {}
    t0 = time.perf_counter()
    serving.set_serve_fault_hook(hook)
    try:
        results = run_replicas(scfg, device, on_step=on_step, fleet=fleet)
    finally:
        serving.set_serve_fault_hook(None)
        released.set()
        host.stop()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    sv = fleet["serving"]
    entries = [e for r in results for e in r["log"]]
    losses = [e["loss"] for e in entries]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"serving: non-finite loss: {losses}")
    if any(r["step"] != scfg.steps for r in results):
        raise RuntimeError(f"serving: replicas stopped at {[r['step'] for r in results]}")
    if results[crasher]["restarts"] != 1 or results[crasher]["metrics"]["heals"] < 1:
        raise RuntimeError(f"serving: replica {crasher} did not crash and heal: "
                           f"{results[crasher]['metrics']}")
    p0, p1 = results[0]["params"], results[1]["params"]
    unequal = [k for k in p0 if not same_bits(p0[k], p1[k])]
    if unequal:
        raise RuntimeError(f"serving: replicas differ in {unequal[:5]}")
    req = sv["requests"]
    if req["failed"] or req["ok"] == 0:
        raise RuntimeError(f"serving: {len(req['failed'])} failed requests of "
                           f"{req['ok'] + len(req['failed'])}: {req['failed'][:3]}")
    digests = {p["ref_sha256"] for p in sv["publishers"]} | {w["flat_sha256"]
                                                              for w in sv["workers"]}
    if not sv["equal"] or len(digests) != 1 or len(sv["publishers"]) != 2:
        raise RuntimeError(f"serving: workers and publishers not bitwise equal: equal "
                           f"{sv['equal']}, digests {sorted(digests)}")
    for p in sv["publishers"]:
        ring = [tuple(v) for v in p["ring"]]
        if ring != sorted(set(ring)) or p["counters"]["announce_rejected_total"]:
            raise RuntimeError(f"serving: publisher {p['replica']}'s versions {ring} not "
                               f"strictly increasing or rejected: {p['counters']}")
    healed = next(p for p in sv["publishers"] if p["replica"] == crasher)
    if healed["counters"]["bootstrap_pulls_total"] < 1:
        raise RuntimeError(f"serving: the healed replica's publisher did not bootstrap: "
                           f"{healed['counters']}")
    failovers = sum(w["counters"]["pull_failovers_total"] for w in sv["workers"])
    if failovers < 1 or held_pulls[0] < 1:
        raise RuntimeError(f"serving: no pull failed over from the dead source (failovers "
                           f"{failovers}, held pulls {held_pulls[0]})")
    wc = [w["counters"] for w in sv["workers"]]
    full_b = sum(c["full_bytes_total"] for c in wc) / max(1, sum(c["full_pulls_total"] for c in wc))
    delta_b = sum(c["delta_bytes_total"] for c in wc) / max(1, sum(c["delta_pulls_total"]
                                                                   for c in wc))
    if not sum(c["delta_pulls_total"] for c in wc) or full_b < SV_DELTA_SAVING * delta_b:
        raise RuntimeError(f"serving: a delta moves {delta_b:.0f} B against a full pull's "
                           f"{full_b:.0f} B (bar {SV_DELTA_SAVING}x)")
    serve_k3 = sum(p["counters"]["k3_host_launches"] for p in sv["publishers"])
    serve_k4 = sum(p["counters"]["k4_launches"] for p in sv["publishers"]) + \
        sum(c["k4_launches"] for c in wc)
    if not (1 <= serve_k3 <= launches["quantize_fp8_rowwise_host"]) or \
            not (1 <= serve_k4 <= launches["dequantize_fp8_rowwise"]):
        raise RuntimeError(f"serving: the serving path launched K3-host {serve_k3}, K4 "
                           f"{serve_k4} (phase: {launches})")
    for kernel in ("splash_fwd", "splash_dq", "splash_dkv"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} never launched on the serving phase's trainers")

    steady = [e for e in entries if e["committed"] and e["participants"] == 2
              and not e["healed"] and e["step"] > 0]
    med = {k: statistics.median(e[k] for e in steady)
           for k in ("step_ms", "compute_ms", "allreduce_ms", "tokens_per_s")} if steady else {}
    publish_ms = [e["serve_publish_ms"] for e in entries if e["committed"]]
    splits = [s_ for p in sv["publishers"] for s_ in p["splits"]]
    split_med = {k: statistics.median(s_[k] for s_ in splits) * 1e3
                 for k in serving.PUBLISH_SPLITS} if splits else {}
    full_s = [s_ for w in sv["workers"] for s_ in w["full_pull_s"]]
    delta_ms = [s_ * 1e3 for w in sv["workers"] for s_ in w["delta_pull_s"]]
    lags = [x for w in sv["workers"] for x in w["lag_steps"]]
    lat = req["latency_ms"]
    skipped = [p["counters"]["skipped_total"] for p in sv["publishers"]]
    log(f"serving bench_1b ({elapsed:.1f} s, {scfg.layers} layers, 2 replicas, fp8 allreduce, "
        f"{SV_WORKERS} workers on "
        f"the card, {SERVE_REQUESTS} request threads, crash of replica {crasher} after step "
        f"{crash_step}'s backward): every worker's flat bitwise equal to both publishers' R at "
        f"{sv['target']} (sha256 {next(iter(digests))[:16]}); "
        + (f"median of {len(steady)} steady steps: step {med['step_ms']:.1f} ms = "
           f"quorum+fwd+bwd {med['compute_ms']:.1f} ms + allreduce {med['allreduce_ms']:.1f} "
           f"ms + commit+optimizer "
           f"{med['step_ms'] - med['compute_ms'] - med['allreduce_ms']:.1f} ms; "
           f"{med['tokens_per_s']:.1f} tokens/s per replica; without the plane (phase 6, "
           f"full depth) {steady_step_ms:.1f} ms, {med['step_ms'] / steady_step_ms:.2f}x"
           if med else "no steady step"))
    log(f"serving commit path: serve_publish_s median {statistics.median(publish_ms):.3f} ms, "
        f"max {max(publish_ms):.3f} ms over {len(publish_ms)} commits; publisher thread per "
        f"version (median of {len(splits)}): "
        + ", ".join(f"{k[:-2]} {v:.1f} ms" for k, v in split_med.items())
        + f"; published {[p['counters']['published_total'] for p in sv['publishers']]}, "
        f"skipped {skipped}, bootstrap pulls "
        f"{[p['counters']['bootstrap_pulls_total'] for p in sv['publishers']]}")
    log(f"serving pulls: full pull {statistics.median(full_s):.3f} s median of {len(full_s)} "
        f"({full_b / 1e6 / statistics.median(full_s):.1f} MB/s, {full_b / 1e6:.1f} MB), delta "
        f"pull {statistics.median(delta_ms) if delta_ms else float('nan'):.1f} ms median of "
        f"{len(delta_ms)} ({delta_b / 1e6:.1f} MB, {full_b / max(delta_b, 1):.2f}x fewer "
        f"bytes); failovers {[c['pull_failovers_total'] for c in wc]} (held pulls "
        f"{held_pulls[0]}); lag p50 {_pct(lags, 50):.1f} / p99 {_pct(lags, 99):.1f} steps "
        f"over {len(lags)} samples; /infer p50 {_pct(lat, 50):.2f} / p99 {_pct(lat, 99):.2f} "
        f"ms, {req['ok'] / max(req['seconds'], 1e-9):.1f} requests/s ({req['ok']} ok, 0 failed, "
        f"{req['seconds']:.1f} s; one process's GIL)")
    log(f"serving memory: device peak {peak / 2**30:.2f} GiB, host peak RSS "
        f"{host.peak_rss / 2**30:.2f} GiB, host MemAvailable min "
        f"{host.min_available / 2**30:.2f} GiB; launches {launches}; serving path K3-host "
        f"{serve_k3}, K4 {serve_k4}")
    del results, p0, p1, entries
    gc.collect()
    torch.cuda.empty_cache()
    return {**launches, "serving_quantize_fp8_rowwise_host": serve_k3,
            "serving_dequantize_fp8_rowwise": serve_k4}


# phase 20: the policy plane in enforce mode at bench_1b (docstring, 20)
PL_CRASH = (1, 3)  # replica 1 crashes after this step's backward pass
PL_MAX_STEPS = 60
PL_KNOBS = {"TORCHFT_POLICY": "enforce", "TORCHFT_POLICY_INTERVAL_S": "0.25",
            "TORCHFT_POLICY_WINDOW_S": "8"}
# one replica's replacement is 2 membership units (a departure and a join)
# in the 8 s window, 15 a minute: the rule fires at half that and releases
# once the replacement has left the window
PL_SPEC = {
    "name": "churn-widen-eject",
    "rules": [{"name": "churn-widen-eject", "signal": "churn_per_min", "op": ">",
               "threshold": 7.5, "release": 0.5,
               "actions": {"TORCHFT_HEALTH_EJECT_Z": "9.0"}}],
    "clamps": {"TORCHFT_HEALTH_EJECT_Z": [3.0, 12.0]},
}


class _Records(logging.Handler):
    """Keeps every record of a structured event stream, parsed."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.events: list = []

    def emit(self, record: logging.LogRecord) -> None:
        self.events.append(json.loads(record.getMessage()))


def check_policy_bench_1b(device: torch.device, cfg) -> dict:
    """Phase 20: bench_1b as two replica threads under the policy plane in
    enforce mode, replica 1 crashing and healing, until both applied the
    release frame (docstring, 20). Returns the phase's launches."""
    import urllib.request

    from torchft_tpu_torch import flight_recorder as fr
    from torchft_tpu_torch import knobs
    from torchft_tpu_torch.analysis import lockgraph
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
    from torchft_tpu_torch.observability import POLICY_EVENTS, get_event_drain
    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.policy import PolicyController
    from torchft_tpu_torch.train import Fault, run_replicas

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                           "trace_policy")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    spec_path = os.path.join(out_dir, "policy_spec.json")
    with open(spec_path, "w") as f:
        json.dump(PL_SPEC, f)
    pcfg = dataclasses.replace(
        cfg, replicas=2, steps=PL_CRASH[1] + 2, quantize=True, transport="http",
        layers=QUARTER_LAYERS, trace_dir=out_dir, policy=spec_path,
        faults=(Fault(PL_CRASH[0], PL_CRASH[1], "crash", at="backward"),))

    # the harness's view: each frame the lighthouse publishes, each pass of
    # its loop timed, the Managers' torchft_policy records
    published: list = []
    passes: list = []
    set_policy, step_pass = LighthouseServer.set_policy, PolicyController.step

    def recording_set_policy(self, frame):
        published.append(dict(frame))
        set_policy(self, frame)

    def timed_pass(self, now_ms=None):
        t = time.perf_counter()
        try:
            return step_pass(self, now_ms)
        finally:
            passes.append(time.perf_counter() - t)

    records = _Records()
    stream = logging.getLogger(POLICY_EVENTS)
    level, propagate = stream.level, stream.propagate
    fleet: dict = {}
    lock = threading.Lock()
    latest: dict = {}  # replica -> the policy_seq in force at its last step
    layers: list = []  # the override layer after each change (the process's)
    ledger: dict = {}  # seq -> the ledger's eject_z when a replica first ran under it
    fr_policy: dict = {}  # (replica id, kind, seq) -> the flight recorder's record
    scraped: dict = {}
    set_override = knobs.set_override

    def recording_set_override(name, value):
        set_override(name, value)
        with lock:
            layers.append(knobs.get_overrides())

    def on_step(e: dict) -> None:
        log(f"policy step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
            f"participants={e['participants']} committed={e['committed']} "
            f"healed={e['healed']} policy_seq={e['policy_seq']:.0f} step_ms={e['step_ms']:.1f}")
        with lock:
            latest[e["replica"]] = seq = e["policy_seq"]
            if seq not in ledger:
                ledger[seq] = LighthouseClient(fleet["lighthouse"]).health()["opts"]["eject_z"]
        with fr.recorder._lock:
            ring = list(fr.recorder._events)
        for ev in ring:
            if ev["kind"].startswith("policy_"):
                fr_policy[(ev["replica"], ev["kind"], ev["policy_seq"])] = ev

    def until(step: int) -> bool:
        # every live Manager applied the release frame
        with lock:
            done = len(latest) == 2 and set(latest.values()) == {2.0}
        if done:
            with urllib.request.urlopen(f"http://{fleet['lighthouse']}/metrics",
                                        timeout=10.0) as r:
                m = re.search(r"^torchft_lighthouse_policy_seq (\S+)$", r.read().decode(), re.M)
            scraped["policy_seq"] = float(m.group(1)) if m else None
        return done

    q.reset_launches()
    ta.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stream.addHandler(records)
    stream.setLevel(logging.INFO)
    stream.propagate = False
    LighthouseServer.set_policy = recording_set_policy
    PolicyController.step = timed_pass
    knobs.set_override = recording_set_override
    t0 = time.perf_counter()
    try:
        # the trainers, the lighthouse and its policy controller are built
        # inside the detector: every Python lock they create is instrumented
        with _Env(PL_KNOBS), lockgraph.watch() as graph:
            results = run_replicas(pcfg, device, on_step=on_step, fleet=fleet, until=until,
                                   max_steps=PL_MAX_STEPS)
        get_event_drain().flush()
    finally:
        LighthouseServer.set_policy, PolicyController.step = set_policy, step_pass
        knobs.set_override = set_override
        stream.removeHandler(records)
        stream.setLevel(level)
        stream.propagate = propagate
        knobs.clear_overrides()
    elapsed = time.perf_counter() - t0
    launches = {**q.LAUNCHES, **ta.LAUNCHES}

    # the lock-order detector: no acquisition-order cycle (a cycle is a
    # port fault, fixed with a CPU test of its edge pair, never waived)
    report = graph.report()
    nodes = set(report["max_hold_ms"]) | {site for edge in graph.edges() for site in edge}
    holds = sorted(report["max_hold_ms"].items(), key=lambda kv: -kv[1])[:3]
    log(f"policy lockgraph: {report['locks']} locks instrumented, {report['acquires']} "
        f"acquisitions, {len(nodes)} nodes (creation sites), {report['edges']} edges, "
        f"{len(report['cycles'])} cycles; longest holds "
        + ", ".join(f"{site} {ms:.1f} ms" for site, ms in holds))
    lockgraph.assert_clean(graph)

    # the frames: seq 0 (nothing active), 1 (the rule fired), 2 (released)
    seqs = [f["policy_seq"] for f in published]
    if seqs[-2:] != [1, 2] or published[-2]["knob_overrides"] != {
            "TORCHFT_HEALTH_EJECT_Z": "9.0"} or published[-1]["knob_overrides"]:
        raise RuntimeError(f"policy: the lighthouse published {published}")
    if fleet["policy"] != published[-1] or scraped.get("policy_seq") != 2.0:
        raise RuntimeError(f"policy: the last frame {fleet['policy']}, /metrics policy_seq "
                           f"{scraped.get('policy_seq')}")
    # each live Manager applied each frame once, at a start_quorum (the
    # stream's records come from there alone)
    applies: dict = {}  # replica id -> [(seq, step)]
    for ev in records.events:
        if ev["action"] != "apply":
            raise RuntimeError(f"policy: a Manager in enforce mode only observed: {ev}")
        applies.setdefault(ev["replica_id"], []).append((ev["policy_seq"], ev["step"]))
    steps_at = {}
    for i, r in enumerate(results):
        mine = {rid: a for rid, a in applies.items() if rid.startswith(f"replica_{i}:")}
        live = [(rid, a) for rid, a in mine.items() if 2 in dict(a)]
        if len(live) != 1:
            raise RuntimeError(f"policy: replica {i}'s incarnations applied {mine}")
        rid, seen = live[0][0], [s for s, _ in live[0][1]]
        if seen != sorted(set(seen)) or not {1, 2} <= set(seen):
            raise RuntimeError(f"policy: replica {i}'s live Manager applied {live[0][1]}")
        missing = [s for s in seen if (rid, "policy_apply", s) not in fr_policy]
        # policy_applies sums the incarnations', as every counter of a result
        n = sum(len(a) for a in mine.values())
        if missing or r["timings"]["policy_applies"] != n:
            raise RuntimeError(f"policy: replica {i}: the flight recorder lacks seqs {missing}; "
                               f"policy_applies {r['timings']['policy_applies']} against {n} "
                               "torchft_policy records")
        steps_at[i] = dict(live[0][1])
    # the layer is the process's: each Manager sets the knob at seq 1 and
    # clears it at seq 2, so it held 9.0 from the first apply of seq 1 to the
    # first of seq 2, and nothing after
    changes = [x for i, x in enumerate(layers) if i == 0 or x != layers[i - 1]]
    if changes != [{"TORCHFT_HEALTH_EJECT_Z": "9.0"}, {}] or knobs.get_overrides():
        raise RuntimeError(f"policy: the override layer went {layers}")
    kept = fleet["health"]["opts"]["eject_z"]
    if ledger.get(1.0) != 9.0 or ledger.get(2.0) != 9.0 or kept != 9.0:
        raise RuntimeError(f"policy: the ledger's eject_z {ledger} at seq 1 and 2, {kept} at the "
                           "end (the reference's release retunes nothing back: 9.0)")
    history = [json.loads(line) for line in open(os.path.join(out_dir,
                                                              "lighthouse_history.jsonl"))]
    retunes = [e["opts"]["eject_z"] for e in history if e.get("kind") == "health_retune"]
    if retunes != [9.0]:
        raise RuntimeError(f"policy: the history's health retunes {retunes}")
    # the fold sees the replacement only while the last quorum before the
    # crash is inside the window with it
    quorums = [e for e in history if e.get("kind") == "quorum"]
    swap = next(i for i in range(1, len(quorums))
                if quorums[i]["participants"] != quorums[i - 1]["participants"])
    gap_s = (quorums[swap]["ts_ms"] - quorums[swap - 1]["ts_ms"]) / 1e3

    # the run itself: finite losses, the discarded step, the heal, equal bits
    losses = [e["loss"] for r in results for e in r["log"]]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"policy: non-finite loss: {losses}")
    if results[1]["restarts"] != 1 or results[1]["metrics"]["heals"] < 1:
        raise RuntimeError(f"policy: replica 1 did not crash and heal: {results[1]['metrics']}")
    if results[0]["metrics"]["commit_failures"] < 1:
        raise RuntimeError(f"policy: no step was discarded: {results[0]['metrics']}")
    if results[0]["step"] != results[1]["step"] or results[0]["step"] > PL_MAX_STEPS:
        raise RuntimeError(f"policy: replicas stopped at {[r['step'] for r in results]}")
    p0, p1 = results[0]["params"], results[1]["params"]
    unequal = [k for k in p0 if not same_bits(p0[k], p1[k])]
    if unequal:
        raise RuntimeError(f"policy: replicas differ in {unequal[:5]}")
    for kernel in ("splash_fwd", "splash_dq", "splash_dkv", "quantize_fp8_rowwise_host",
                   "dequantize_fp8_rowwise"):
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} never launched on the policy path")

    # the recorded history replayed against the builtin spec
    replay = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.policy", "replay", "--history",
         os.path.join(out_dir, "lighthouse_history.jsonl"), "--policy", "builtin", spec_path],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=120)
    winner = [ln for ln in replay.stdout.splitlines() if ln.startswith("winner: ")]
    if replay.returncode != 0 or len(winner) != 1:
        raise RuntimeError(f"policy replay exited {replay.returncode}:\n{replay.stdout}\n"
                           f"{replay.stderr[-2000:]}")
    for ln in replay.stdout.splitlines():
        log(f"policy replay: {ln.strip()}")
    steady = [e["step_ms"] for r in results for e in r["log"]
              if e["committed"] and e["participants"] == 2 and not e["healed"] and e["step"] > 0]
    log(f"policy bench_1b ({elapsed:.1f} s, {pcfg.layers} layers, 2 replicas, fp8 allreduce, "
        f"enforce, window {PL_KNOBS['TORCHFT_POLICY_WINDOW_S']} s, a pass every "
        f"{PL_KNOBS['TORCHFT_POLICY_INTERVAL_S']} s): {gap_s:.3f} s from the last quorum before "
        f"the crash to the replacement's; frames published {seqs}; applied at steps "
        f"{steps_at} (replica: {{seq: step}}); "
        f"the override layer {changes[0]} from seq 1, {changes[1]} from seq 2 ({len(layers)} "
        f"writes); the ledger's eject_z {ledger.get(1.0)} at seq 1, {kept} after the release; "
        f"/metrics "
        f"policy_seq {scraped['policy_seq']:.0f}; "
        f"{len(passes)} passes of the fold, median {statistics.median(passes) * 1e3:.3f} ms, "
        f"max {max(passes) * 1e3:.3f} ms; replicas bitwise equal over {len(p0)} tensors at step "
        f"{results[0]['step']}; steady step median "
        f"{statistics.median(steady) if steady else float('nan'):.1f} ms over {len(steady)} "
        f"under the lock-order detector (without it, on an H100 80GB HBM3 at 700.00 W: "
        f"615.9-671.4 ms); "
        f"device peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
    del results, p0, p1
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 22: the device plane at bench_1b (docstring, 22)
DP_STEPS = 7
DP_CRASH = (1, 3)  # replica 1 crashes after step 3's backward pass
# replica 0's last step, steady, runs under torch.profiler
DP_PROFILE_STEP = DP_STEPS - 1
DP_D2H_BAR = 1 << 20  # bytes: no larger device-to-host copy in that step
DP_SPARE_REPLICAS = 3  # FIXED_WITH_SPARES: three replicas, the world pinned at 2
DP_ABORT_BOUND_S = 10.0  # the one-rank NCCL group's abort returns within this


def _two_ranks_on(pg_cls, store, prefix: str, fn) -> list:
    """``fn(rank, pg)`` on two rank threads of ``pg_cls`` groups; their
    results."""
    out: list = [None, None]
    errors: list = []

    def rank(r: int) -> None:
        pg = pg_cls(timeout=120)
        try:
            pg.configure(f"127.0.0.1:{store.port}/{prefix}", r, 2, quorum_id=1)
            out[r] = fn(r, pg)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            pg.shutdown()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(o is None for o in out):
        raise RuntimeError(f"{prefix}: the two ranks failed: {errors}")
    return out


def check_device_wire(device: torch.device, specs: dict) -> dict:
    """Gate 2 of phase 22: the fp8 allreduce of bench_1b's gradient tree
    (random bf16 leaves made from a seed) over two ProcessGroupDevice ranks
    (the packed device wire) against the same inputs over two
    ProcessGroupHost ranks (the host tuple wire): bitwise equal, since both
    carry the same K3 <false> codes. Returns each wire's seconds."""
    from torchft_tpu_torch.collectives import allreduce_quantized
    from torchft_tpu_torch.coordination import KvStoreServer
    from torchft_tpu_torch.process_group import ProcessGroupHost, ReduceOp
    from torchft_tpu_torch.process_group_device import ProcessGroupDevice

    def leaves(r: int) -> list:
        g = torch.Generator(device=device).manual_seed(2200 + r)
        return [torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dt)
                for shape, dt in specs.values()]

    store = KvStoreServer("127.0.0.1:0")
    results, seconds = {}, {}
    try:
        for label, cls in (("device", ProcessGroupDevice), ("host", ProcessGroupHost)):
            inputs = [leaves(0), leaves(1)]
            torch.cuda.synchronize()

            def run(r: int, pg, inputs=inputs) -> tuple:
                t0 = time.perf_counter()
                out = allreduce_quantized(inputs[r], ReduceOp.SUM, pg).get_future().wait(300)
                torch.cuda.synchronize()
                return out, time.perf_counter() - t0

            got = _two_ranks_on(cls, store, f"wire_{label}", run)
            results[label] = [o for o, _s in got]
            seconds[label] = max(s for _o, s in got)
            del inputs, got
    finally:
        store.shutdown()
    for r in range(2):
        for a, b in zip(results["device"][r], results["host"][r]):
            if not same_bits(a, b):
                raise RuntimeError("device wire: the packed device wire's reduced gradient "
                                   "differs from the host tuple wire's")
    if not all(t.is_cuda for t in results["device"][0]):
        raise RuntimeError("device wire: a reduced leaf left the card")
    n = sum(math.prod(shape) for shape, _dt in specs.values())
    del results
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device wire: bench_1b's gradient tree ({n} elements, fp8, world 2) over the packed "
        f"device wire == over the host tuple wire, bitwise, every leaf; one allreduce "
        f"{seconds['device'] * 1e3:.1f} ms on the device wire, {seconds['host'] * 1e3:.1f} ms on "
        "the host wire (two rank threads on one card, wall clock)")
    return seconds


def _d2h_copies(path: str) -> tuple:
    """(device-to-host copies' bytes, kernel names) of a profiled step's
    chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    d2h = [int(e.get("args", {}).get("bytes", 0)) for e in events
           if e.get("cat") in ("gpu_memcpy", "Memcpy") and "DtoH" in str(e.get("name", ""))]
    kernels = {str(e.get("name", "")) for e in events if e.get("cat") == "kernel"}
    return d2h, kernels


def check_device_plane_spares(device: torch.device) -> None:
    """Gate 4 of phase 22: FIXED_WITH_SPARES on the device plane at
    bench_1b's width and a quarter of its depth (``_dryrun_fixed_with_spares``,
    ``__graft_entry__.py:537``): three replica threads, each one
    forward and backward of its own model, the world pinned at 2; the spare
    contributes zeros on the card, so every replica gets the participants'
    mean."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager, WorldSizeMode
    from torchft_tpu_torch.models.llama import CONFIGS, Llama
    from torchft_tpu_torch.process_group_device import ProcessGroupDevice

    mcfg = dataclasses.replace(CONFIGS["bench_1b"], n_layers=QUARTER_LAYERS)
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=DP_SPARE_REPLICAS,
                          join_timeout_ms=10000, quorum_tick_ms=20, heartbeat_timeout_ms=5000)

    def replica(rid: int) -> tuple:
        model = Llama(mcfg, device=device, remat="full")
        gen = torch.Generator(device=device).manual_seed(rid)
        model.init_weights(gen)
        toks = torch.randint(0, mcfg.vocab_size, (1, 2049), generator=gen, device=device)
        model.loss(toks[:, :-1], toks[:, 1:]).backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        manager = Manager(pg=ProcessGroupDevice(timeout=120, mode="local"),
                          load_state_dict=lambda sd: None, state_dict=lambda: {},
                          min_replica_size=2, use_async_quorum=False,
                          replica_id=f"dp_spares_{rid}", lighthouse_addr=f"127.0.0.1:{lh.port}",
                          timeout=120, quorum_timeout=120,
                          world_size_mode=WorldSizeMode.FIXED_WITH_SPARES)
        try:
            manager.start_quorum()
            out = manager.allreduce(grads).get_future().wait(120)
            return manager.num_participants(), manager.is_participating(), grads, out
        finally:
            manager.shutdown(wait=False)

    try:
        with ThreadPoolExecutor(DP_SPARE_REPLICAS) as pool:
            results = list(pool.map(replica, range(DP_SPARE_REPLICAS)))
    finally:
        lh.shutdown()
    if any(n != 2 for n, _p, _g, _o in results):
        raise RuntimeError(f"spares: participants {[n for n, *_ in results]}, not 2 each")
    spares = [i for i, (_n, p, _g, _o) in enumerate(results) if not p]
    if len(spares) != 1:
        raise RuntimeError(f"spares: {len(spares)} spares, not one")
    a, b = (results[i][2] for i in range(DP_SPARE_REPLICAS) if i not in spares)
    for name in a:
        want = torch.stack([a[name], b[name]]).sum(0, dtype=a[name].dtype) / 2
        for _n, _p, _g, out in results:
            if not out[name].is_cuda or not same_bits(out[name], want):
                raise RuntimeError(f"spares: {name} is not the participants' mean on the card")
    log(f"device plane FIXED_WITH_SPARES ({QUARTER_LAYERS} layers, {DP_SPARE_REPLICAS} replicas, "
        f"the world pinned at 2): replica {spares[0]} the spare, its zeros in the sum; every "
        f"replica's {len(a)} reduced tensors == the participants' mean on the card, bitwise")
    del results, a, b
    gc.collect()
    torch.cuda.empty_cache()


def check_device_plane_nccl(device: torch.device) -> float:
    """Gate 5 of phase 22: ProcessGroupDevice's distributed mode with one
    NCCL rank (all one card allows), configured at two quorum ids (a
    rebuild) and then aborted: the allreduce returns its input, the abort
    returns within DP_ABORT_BOUND_S. Returns the abort's seconds."""
    from torchft_tpu_torch.coordination import KvStoreServer
    from torchft_tpu_torch.process_group_device import NCCL_ERROR_HANDLING, ProcessGroupDevice

    store = KvStoreServer("127.0.0.1:0")
    pg = ProcessGroupDevice(timeout=60, mode="distributed")
    try:
        x = torch.randn(1 << 20, device=device)
        for qid in (1, 2):
            pg.configure(f"127.0.0.1:{store.port}/nccl_one", 0, 1, quorum_id=qid)
            if "nccl" not in pg._world.groups:
                raise RuntimeError("nccl: no NCCL group was built")
            out = pg.allreduce([x]).get_future().wait(60)
            if not out[0].is_cuda or not same_bits(out[0], x):
                raise RuntimeError(f"nccl: quorum {qid}'s one-rank allreduce changed its input")
        if pg.device_world_epoch != 2:
            raise RuntimeError(f"nccl: device_world_epoch {pg.device_world_epoch}, not 2")
        if os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING") != NCCL_ERROR_HANDLING:
            raise RuntimeError("nccl: the group's error handling was not set")
        t0 = time.perf_counter()
        pg.abort()
        abort_s = time.perf_counter() - t0
    finally:
        pg.shutdown()
        store.shutdown()
    if abort_s >= DP_ABORT_BOUND_S or pg.errored() is None:
        raise RuntimeError(f"nccl: abort took {abort_s:.3f} s (bound {DP_ABORT_BOUND_S} s) or "
                           "left the group unerrored")
    log(f"device plane distributed mode: one NCCL rank configured at quorum ids 1 and 2 "
        f"(device_world_epoch 2), each allreduce returned its input bitwise, error handling "
        f"TORCH_NCCL_ASYNC_ERROR_HANDLING={NCCL_ERROR_HANDLING}; abort {abort_s * 1e3:.1f} ms")
    return abort_s


def check_device_plane_bench_1b(device: torch.device, cfg, host: dict) -> dict:
    """Phase 22: bench_1b on the device plane (docstring, 22). ``host`` is
    phase 6's steady medians and phase 6's and 7's heals, printed beside
    this phase's. Returns the main run's launches."""
    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.train import Fault, run_replicas

    wire_s = check_device_wire(device, bench_1b_grad_specs())
    out_dir = os.path.join("chiprun_out", "device_plane")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    dp_cfg = dataclasses.replace(
        cfg, steps=DP_STEPS, plane="device", transport="pg", trace_dir=out_dir,
        profile_step=DP_PROFILE_STEP, faults=(Fault(*DP_CRASH, "crash", at="backward"),))
    q.reset_launches()
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = run_replicas(dp_cfg, device, on_step=lambda e: log(
        f"device step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
        f"participants={e['participants']} committed={e['committed']} healed={e['healed']} "
        f"step_ms={e['step_ms']:.1f} compute_ms={e['compute_ms']:.1f} "
        f"allreduce_ms={e['allreduce_ms']:.1f} wire_bytes_sent={e['wire_bytes_sent']}"))
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    d2h, kernels = _d2h_copies(os.path.join(out_dir, f"profile_step{DP_PROFILE_STEP}.json"))
    shutil.rmtree(out_dir, ignore_errors=True)
    r0, r1 = results
    if any(r["step"] != DP_STEPS for r in results):
        raise RuntimeError(f"device plane: replicas stopped at {[r['step'] for r in results]}")
    if r1["restarts"] != 1 or r1["metrics"]["heals"] < 1:
        raise RuntimeError(f"device plane: replica 1 did not crash and heal: {r1['metrics']}")
    crashed = [e for e in r0["log"] if e["step"] == DP_CRASH[1] and not e["committed"]]
    if not crashed or r0["metrics"]["commit_failures"] < 1:
        raise RuntimeError("device plane: the crashed step was not discarded on replica 0")
    p0, p1 = r0["params"], r1["params"]
    unequal = [k for k in p0 if not torch.equal(p0[k].view(torch.int16), p1[k].view(torch.int16))]
    if unequal:
        raise RuntimeError(f"device plane: replicas differ in {unequal[:5]}")
    losses = [e["loss"] for r in results for e in r["log"]]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"device plane: non-finite loss: {losses}")
    if any(e["wire_bytes_sent"] for r in results for e in r["log"]):
        raise RuntimeError("device plane: a step's allreduce rode the host wire")
    for kernel in ("quantize_fp8_rowwise", "dequantize_fp8_rowwise",
                   "splash_fwd", "splash_dq", "splash_dkv"):
        if launches[kernel] == 0:
            raise RuntimeError(f"device plane: {kernel} never launched")
    if launches["quantize_fp8_rowwise_host"]:
        raise RuntimeError("device plane: the host codec (K3-host) ran: a bucket was streamed")
    if not any("quantize_fp8_rowwise_kernel" in k for k in kernels):
        raise RuntimeError(f"device plane: the profiled step saw no K3 launch: {len(kernels)} "
                           "kernels")
    big = [b for b in d2h if b > DP_D2H_BAR]
    if big:
        raise RuntimeError(f"device plane: device-to-host copies over {DP_D2H_BAR} bytes in the "
                           f"profiled steady step: {sorted(big)[-5:]}")
    steady = [e for r in results for e in r["log"]
              if e["committed"] and e["participants"] == 2 and not e["healed"] and e["step"] > 0]
    if not steady:
        raise RuntimeError("device plane: no steady step")
    med = {k: statistics.median(e[k] for e in steady)
           for k in ("step_ms", "compute_ms", "allreduce_ms", "tokens_per_s")}
    heal = heal_numbers(results)
    log(f"device plane bench_1b ({elapsed:.1f} s, {DP_STEPS} steps, fp8, PG heal, replica 1 "
        f"crashing after step {DP_CRASH[1]}'s backward pass): replicas bitwise equal over "
        f"{len(p0)} tensors, the crashed step discarded, storage kept "
        f"{[r['storage_kept'] for r in results]}; profiled step {DP_PROFILE_STEP}: "
        f"{len(d2h)} device-to-host copies, largest {max(d2h, default=0)} bytes (bar "
        f"{DP_D2H_BAR}); device peak {peak / 2**30:.2f} GiB; launches {launches}")
    log(f"device plane steady steps (median of {len(steady)}): step {med['step_ms']:.1f} ms = "
        f"quorum+fwd+bwd {med['compute_ms']:.1f} ms + allreduce {med['allreduce_ms']:.1f} ms + "
        f"commit+optimizer {med['step_ms'] - med['compute_ms'] - med['allreduce_ms']:.1f} ms, "
        f"{med['tokens_per_s']:.1f} tokens/s per replica; heal_send_s {heal['heal_send_s']:.3f} "
        f"heal_recv_s {heal['heal_recv_s']:.3f}")
    hm = host["med"]
    log(f"host plane in this call (phase 6, fp8 streamed buckets on the TCP ring): step "
        f"{hm['step_ms']:.1f} ms = {hm['compute_ms']:.1f} + allreduce {hm['allreduce_ms']:.1f} + "
        f"{hm['step_ms'] - hm['compute_ms'] - hm['allreduce_ms']:.1f} ms, "
        f"{hm['tokens_per_s']:.1f} tokens/s; heal_recv_s HTTP {host['http']['heal_recv_s']:.3f}, "
        f"PG (phase 7) {host['pg']['heal_recv_s']:.3f}; the fp8 allreduce alone: device wire "
        f"{wire_s['device'] * 1e3:.1f} ms, host wire {wire_s['host'] * 1e3:.1f} ms")
    del results, p0, p1
    gc.collect()
    torch.cuda.empty_cache()
    check_device_plane_spares(device)
    check_device_plane_nccl(device)
    return launches


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # what runs is the script's choice alone, whatever the caller exported
    os.environ.pop("TORCHFT_TPU_ATTENTION", None)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchft_tpu_torch.models.llama import CONFIGS
    from torchft_tpu_torch.ops import attention as ta
    from torchft_tpu_torch.ops import quantization as q
    from torchft_tpu_torch.ops._build import build
    from torchft_tpu_torch.train import REPLICAS, Fault, TrainConfig, run_replicas

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    sources = ("fp8_rowwise.cu", "attention.cu", "attention_tf32x3.cu")
    # one nvcc per source, started together; a failed build raises here
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build, sources))
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, {len(sources)} sources "
        "in parallel)")
    mark("1 kernel build")
    build_report = kernel_build_report(sources)
    check_hopper_kernels(build_report)
    routed = {key: source for key, (source, _) in ta.ROUTES.items()}
    stated = {(kernel, dtype): source for dtype, (_, sources) in ATTN_DTYPES.items()
              for kernel, source in sources.items()}
    if routed != stated:
        raise RuntimeError(f"ops/attention.py routes {routed}, chip_smoke.py expects {stated}")

    cfg = TrainConfig(config="bench_1b", steps=6, batch_size=1, seq_len=2048,
                      quantize=True, faults=(Fault(1, 3, "crash", at="backward"),))
    n_params = CONFIGS[cfg.config].num_params()
    stats, timing = check_kernels(device, n_params, world=REPLICAS)
    log(f"quantize at the reduced-chunk shape (n={timing['quantize']['chunk_n']}): "
        f"{timing['quantize']['chunk_ms']:.3f} ms; at the full gradient: "
        f"{timing['quantize']['ms']:.3f} ms, dequantize {timing['dequantize']['ms']:.3f} ms "
        f"(device ms; one call with its host time: quantize {timing['quantize']['call_ms']:.3f} ms, "
        f"dequantize {timing['dequantize']['call_ms']:.3f} ms)")
    check_allreduce(device)
    specs = bench_1b_grad_specs()
    buckets = bench_1b_buckets(specs)
    host_rule = check_host_rule_kernel(device, max(buckets), n_params)
    log(f"host-rule quantize at bench_1b's largest bucket (n={host_rule['n']}, buckets {buckets}): "
        f"{host_rule['ms']:.3f} ms device, {host_rule['call_ms']:.3f} ms one call with its host "
        f"time, plain version {host_rule['plain_ms']:.3f} ms")
    sf = host_rule["serving_flat"]
    log(f"host-rule quantize at the serving flat (n={sf['n']}, one publish's delta): "
        f"{sf['ms']:.3f} ms device against a {sf['bound_ms']:.3f} ms bound, {sf['call_ms']:.3f} ms "
        f"one call with its host time, plain version {sf['plain_ms']:.3f} ms; bitwise equal")
    time_serial_split(device, n_params, REPLICAS)
    time_streamed_split(device, max(buckets))
    check_streamed_on_card(device)
    # the serial engine's own path: its launches are read from this phase
    serial_vs_streamed = time_streamed_vs_serial(device, specs)
    attn_stats, attn_timing = check_attention(device)
    check_attention_env(device)
    # each model path's launches, from its own run
    path_launches = {}
    for dtype, impl, want, tol in MODEL_PATHS:
        path_launches.update(check_model_path(device, dtype, impl, want, tol))
    time_model_fwd_bwd(device)
    mark("1-5 kernels, allreduces, attention, model paths")

    q.reset_launches()
    ta.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = run_replicas(cfg, device, on_step=lambda e: log(
        f"step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
        f"participants={e['participants']} committed={e['committed']} "
        f"healed={e['healed']} attention={e['attention']} step_ms={e['step_ms']:.1f} "
        f"compute_ms={e['compute_ms']:.1f} allreduce_ms={e['allreduce_ms']:.1f} "
        f"tokens_per_s={e['tokens_per_s']:.1f} pack_ms={e['allreduce_pack_s'] * 1e3:.1f} "
        f"wire_ms={e['allreduce_wire_s'] * 1e3:.1f} unpack_ms={e['allreduce_unpack_s'] * 1e3:.1f} "
        f"buckets={int(e['allreduce_buckets'])} overlap_efficiency={e['overlap_efficiency']:.3f} "
        f"wire_bytes_sent={e['wire_bytes_sent']} wire_busy_ms={e['wire_busy_s'] * 1e3:.1f}"))
    launches = {**q.LAUNCHES, **ta.LAUNCHES}
    dispatch = {e["attention"] for r in results for e in r["log"]}
    log(f"training: {time.perf_counter() - t0:.1f} s, attention {sorted(dispatch)}, "
        f"launches {launches}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # steady: both replicas contributing, no heal served or received (step
    # 0 carries the init_sync heal)
    steady = [e for r in results for e in r["log"]
              if e["committed"] and e["participants"] == 2 and not e["healed"]
              and e["step"] > 0]
    if not steady:
        raise RuntimeError("training: no steady step")
    med = {k: statistics.median(e[k] for e in steady)
           for k in ("step_ms", "compute_ms", "allreduce_ms", "tokens_per_s")}
    # phase 16's probation is HW_PROBATION_STEPS of these steps
    ddp_step_ms = med["step_ms"]
    log("steady steps (2 participants, median of "
        f"{len(steady)}): step {med['step_ms']:.1f} ms = quorum+fwd+bwd "
        f"{med['compute_ms']:.1f} ms + allreduce {med['allreduce_ms']:.1f} ms + "
        f"commit+optimizer {med['step_ms'] - med['compute_ms'] - med['allreduce_ms']:.1f} ms; "
        f"{med['tokens_per_s']:.1f} tokens/s per replica")
    losses = [e["loss"] for r in results for e in r["log"]]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    if any(r["step"] != cfg.steps for r in results):
        raise RuntimeError(f"replicas stopped at steps {[r['step'] for r in results]}")
    if results[1]["restarts"] != 1 or results[1]["metrics"]["heals"] < 1:
        raise RuntimeError(f"replica 1 did not crash and heal: {results[1]['metrics']}")
    if results[0]["metrics"]["commit_failures"] < 1:
        raise RuntimeError(f"no step was discarded: {results[0]['metrics']}")
    p0, p1 = results[0]["params"], results[1]["params"]
    unequal = [k for k in p0 if not torch.equal(p0[k].view(torch.int16), p1[k].view(torch.int16))]
    if unequal:
        raise RuntimeError(f"replicas differ in {unequal[:5]}")
    http_peak = torch.cuda.max_memory_allocated()
    log(f"replicas bitwise equal over {len(p0)} tensors; heal after the crash: "
        f"replica 0 staged its state in "
        f"{results[0]['timings'].get('heal_send_s', float('nan')):.2f} s, replica 1 "
        f"received it in {results[1]['timings'].get('heal_recv_s', float('nan')):.2f} s")
    if dispatch != {"splash"}:
        raise RuntimeError(f"training attention dispatched to {dispatch}, not splash")
    on_path = ("quantize_fp8_rowwise_host", "dequantize_fp8_rowwise",
               "splash_fwd", "splash_dq", "splash_dkv")
    for kernel in on_path:
        if launches[kernel] == 0:
            raise RuntimeError(f"{kernel} never launched on the training path")
    http_heal = heal_numbers(results)
    del results, p0, p1
    gc.collect()
    torch.cuda.empty_cache()
    mark("6 DDP with an HTTP heal")

    check_pg_transport_on_card(device)
    pg_crash = 2
    pg_cfg = dataclasses.replace(cfg, steps=5, faults=(Fault(1, pg_crash, "crash", at="backward"),),
                                 transport="pg")
    q.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pg_results = run_replicas(pg_cfg, device, on_step=lambda e: log(
        f"pg step replica={e['replica']} step={e['step']} loss={e['loss']:.4f} "
        f"participants={e['participants']} committed={e['committed']} healed={e['healed']} "
        f"step_ms={e['step_ms']:.1f}"))
    pg_peak = torch.cuda.max_memory_allocated()
    if pg_results[1]["restarts"] != 1 or pg_results[1]["metrics"]["heals"] < 1:
        raise RuntimeError(f"PG run: replica 1 did not crash and heal: {pg_results[1]['metrics']}")
    if any(r["step"] != pg_cfg.steps for r in pg_results):
        raise RuntimeError(f"PG run: replicas stopped at {[r['step'] for r in pg_results]}")
    p0, p1 = pg_results[0]["params"], pg_results[1]["params"]
    unequal = [k for k in p0 if not torch.equal(p0[k].view(torch.int16), p1[k].view(torch.int16))]
    if unequal:
        raise RuntimeError(f"PG run: replicas differ in {unequal[:5]}")
    pg_heal = heal_numbers(pg_results)
    log(f"bench_1b heal over PGTransport ({time.perf_counter() - t0:.1f} s, {pg_cfg.steps} "
        f"steps, crash at {pg_crash}): replicas bitwise equal over {len(p0)} tensors; "
        f"launches {dict(q.LAUNCHES)}")
    for label, h, peak in (("http", http_heal, http_peak), ("pg", pg_heal, pg_peak)):
        log(f"bench_1b heal {label}: heal_send_s {h['heal_send_s']:.3f} heal_recv_s "
            f"{h['heal_recv_s']:.3f} heal_chunks {h['heal_chunks']:.0f} heal_mb_per_s "
            f"{h['heal_mb_per_s']:.1f}; peak device memory {peak / 2**30:.2f} GiB")
    del pg_results, p0, p1
    gc.collect()
    torch.cuda.empty_cache()
    mark("7 PG heal")
    baby_launches = check_baby_heal_bench_1b(device, cfg, pg_heal, pg_peak)
    gc.collect()
    torch.cuda.empty_cache()
    mark("18 Baby recovery PG heal")
    # the two small examples' processes barely load the card or the host:
    # they run side by side, each with its own lighthouse, and beside them
    # fleetlint and the doctor (phase 19), whose checks are loopback probes
    # and subprocesses, and the orchestrator's two workers (phase 21)
    with ThreadPoolExecutor(4) as pool:
        ddp_run = pool.submit(check_train_ddp_processes)
        diloco_proc_run = pool.submit(check_train_diloco_processes)
        doctor_run = pool.submit(check_doctor_on_card)
        orch_run = pool.submit(check_orchestrator_processes)
        ddp_launches, diloco_proc_launches = ddp_run.result(), diloco_proc_run.result()
        doctor_run.result()
        orch_launches = orch_run.result()
    mark("8 and 10 example processes, 19 fleetlint and the doctor, 21 the orchestrator")
    diloco_launches = check_diloco_bench_1b(device, cfg)
    mark("9 DiLoCo")
    check_local_sgd_on_card(device)
    mark("11 LocalSGD")
    hsdp_launches = check_train_llama_hsdp_processes(dataclasses.replace(
        CONFIGS["bench_1b"], n_layers=CUT_LAYERS["bench_1b"]).num_params())
    mark("12 train_llama_hsdp's whole-job outage")
    rs_launches = check_reduce_scatter_on_card(device, n_params)
    mark("13 (a) reduce-scatter")
    check_resilient_heal_bench_1b(device, cfg)
    mark("13 (b) resilient heal")
    remat = check_remat_bench_1b(device)
    mark("14 (a) remat")
    moe_launches = check_moe_bench_moe(device)
    mark("14 (b) bench_moe")
    moe_stats, moe_timing = check_bench_moe_attention(device)
    mark("14 (c) K1 at hd 64")
    red_launches = check_redundancy_bench_1b(device, cfg, http_heal)
    mark("15 redundancy")
    health_launches = check_health_tracing_bench_1b(device, cfg, ddp_step_ms)
    mark("16 health and tracing")
    serve_launches = check_serving_bench_1b(device, cfg, ddp_step_ms)
    mark("17 serving")
    policy_launches = check_policy_bench_1b(device, cfg)
    mark("20 policy plane")
    device_launches = check_device_plane_bench_1b(
        device, cfg, {"med": med, "http": http_heal, "pg": pg_heal})
    mark("22 device plane")

    # the serial engine's quantize runs on its own path (stream_buckets=False)
    serial_launches = serial_vs_streamed["launches"]["quantize_fp8_rowwise"]
    if serial_launches == 0:
        raise RuntimeError("quantize_fp8_rowwise never launched on the serial allreduce path")

    kernels = []
    for t, err, kname, instance, line, count in (
        (timing["quantize"], stats["quantize"]["err"], "quantize_fp8_rowwise",
         "quantize_fp8_rowwise_kernel<false>", 279, serial_launches),
        (timing["dequantize"], stats["dequantize"]["err"], "dequantize_fp8_rowwise",
         "dequantize_fp8_rowwise_kernel", 316, launches["dequantize_fp8_rowwise"]),
        (host_rule, host_rule["err"], "quantize_fp8_rowwise_host",
         "quantize_fp8_rowwise_kernel<true>", 279, launches["quantize_fp8_rowwise_host"]),
    ):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "torchft_tpu_torch/ops/csrc/fp8_rowwise.cu",
            "replaces": f"torchft_tpu/ops/quantization.py:{line}",
            "launches": count,
            "max_abs_err": err,
            "ms": t["ms"],
            "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
            # the train_ddp example's children (none runs the serial engine)
            "launches_train_ddp": {f"replica {rid}": d[kname] for rid, d in ddp_launches.items()},
            # phase 21: the orchestrator's workers, each final incarnation
            "launches_orchestrator": {f"replica {rid}": d[kname]
                                      for rid, d in orch_launches.items()},
            # bench_1b under DiLoCo, and the train_diloco example's children
            "launches_diloco": {"bench_1b": diloco_launches[kname], **{
                f"train_diloco replica {rid}": d[kname]
                for rid, d in diloco_proc_launches.items()}},
            # phase 13's reduce_scatter_quantized turns
            "launches_reduce_scatter": rs_launches[kname],
            # phase 15: bench_1b with the redundancy plane
            "launches_redundancy": red_launches[kname],
            # phase 16: bench_1b with the health and tracing planes
            "launches_health": health_launches[kname],
            # phase 17: bench_1b with the serving plane, and of it the
            # serving path's own (its publishers and workers; 0 for K3)
            "launches_serving": {"phase": serve_launches[kname],
                                 "serving_path": serve_launches.get(f"serving_{kname}", 0)},
            # phase 18: bench_1b healed over a Baby recovery PG
            "launches_baby": baby_launches[kname],
            # phase 20: bench_1b under the policy plane in enforce mode
            "launches_policy": policy_launches[kname],
            # phase 22: bench_1b on the device plane (K3 <false> on its
            # packed wire; K3-host 0: no bucket is streamed)
            "launches_device_plane": device_launches[kname],
            # K3-host checked and timed at the serving plane's flat too
            **({"serving_flat": {k: v for k, v in host_rule["serving_flat"].items()
                                 if k != "bytes"}}
               if kname == "quantize_fp8_rowwise_host" else {}),
            **sass_counts(build_report[instance]),
        })
    for dtype, (suffix, sources) in ATTN_DTYPES.items():
        for impl in ("splash", "flash"):
            for kernel in ATTN_MATMULS:
                key = f"{impl}_{kernel}{suffix}"
                kernels.append({
                    "name": f"{ATTN_INSTANCE[dtype][kernel].split('<')[0]} ({impl}"
                            f"{', ' + str(dtype).replace('torch.', '') if suffix else ''})",
                    "route": "cuda",
                    "source": f"torchft_tpu_torch/ops/csrc/{sources[kernel]}",
                    "replaces": f"torchft_tpu/ops/attention.py:{ATTN_REPLACES[impl]}",
                    # K1 in bf16 runs in training, every other one on its
                    # model path (check_model_path)
                    "launches": launches[key] if key in on_path else path_launches[key],
                    # bench_1b under DiLoCo and the HSDP counterpart run K1
                    # in bf16 only
                    **({"launches_diloco": {"bench_1b": diloco_launches[key]},
                        # train_llama_hsdp under the launcher (phase 12):
                        # each group's first incarnation, then each restarted
                        # one (group 1 after its kill, both after the outage)
                        "launches_hsdp": {g: d[key] for g, d in hsdp_launches["hsdp"].items()},
                        "launches_hsdp_restart": {g: d[key] for g, d in
                                                  hsdp_launches["hsdp_restart"].items()},
                        # one bench_1b step under each remat mode (phase 14)
                        "launches_remat": {mode: r["launches"][kernel]
                                           for mode, r in remat.items()},
                        # phase 15: bench_1b with the redundancy plane
                        "launches_redundancy": red_launches[key],
                        # phase 16: bench_1b with the health and tracing planes
                        "launches_health": health_launches[key],
                        # phase 17: bench_1b with the serving plane
                        "launches_serving": serve_launches[key],
                        # phase 18: bench_1b healed over a Baby recovery PG
                        "launches_baby": baby_launches[key],
                        # phase 20: bench_1b under the policy plane
                        "launches_policy": policy_launches[key],
                        # phase 22: bench_1b on the device plane
                        "launches_device_plane": device_launches[key]}
                       if key in on_path else {}),
                    "max_abs_err": attn_stats[key]["err"],
                    **attn_timing[key],
                    # the head-dim-128 instance that bench_1b runs
                    **sass_counts(build_report[ATTN_INSTANCE[dtype][kernel].format(
                        split=str(impl == "splash").lower())]),
                })
    for kernel in ATTN_MATMULS:
        key = f"splash_{kernel}"
        kernels.append({
            "name": f"{HD64_INSTANCE[kernel].split('<')[0]} (splash, head dim 64: bench_moe)",
            "route": "cuda",
            "source": f"torchft_tpu_torch/ops/csrc/{HOPPER}",
            "replaces": f"torchft_tpu/ops/attention.py:{ATTN_REPLACES['splash']}",
            # the bench_moe training run (phase 14 (b))
            "launches": moe_launches[key],
            "max_abs_err": moe_stats[key]["err"],
            **moe_timing[key],
            **sass_counts(build_report[HD64_INSTANCE[kernel]]),
        })
    log(f"chip_smoke.py: {time.perf_counter() - started:.1f} s from start to the kernels line")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
