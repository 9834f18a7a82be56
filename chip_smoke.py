#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device — a CUDA card must be present; prints its name, the device
   count and ``nvidia-smi``'s name and power limit;
2. build — builds every kernel of the path from ``csrc/`` (``nvcc``, in
   parallel) and prints the build time and ``ptxas`` report; reads each
   library's SASS (``cuobjdump``) and checks that the tensor-core kernels
   (flash forward, dQ, dK/dV) issue TF32 ``HMMA`` and ``cp.async``
   (``LDGSTS``) instructions, their bf16 instantiations
   ``HMMA.16816.F32.BF16`` and ``LDGSTS``, and every instantiation of the
   ragged kernel ``LDGSTS``;
3. kernels vs plain — each kernel against its plain PyTorch version on
   the card, at the serving slice's shapes (the prefill's fused-qkv views
   at d = 8, 40, 64, 128, and a one-row query; the ragged decode over fp32
   and int8 pages, with and without cur, contiguous and strided q, rows of
   length 0, 1, 15, 16, 17 and full, one row alone, rows longer than one
   chunk per warp, at every splits choice, two runs
   bit for bit) and at edge cases (max abs error against the fp32
   tolerance, 1e-4: the summation order differs), then the flash forward
   with ``lse`` and the dQ and dK/dV backward kernels at the MT training
   sites ([32, 8, 200, 64] fixture batches: encoder self-attention, causal
   decoder self-attention, cross-attention) and at edge cases (strided
   fused-projection views, a strided dO, fully masked rows, all keys
   masked, one query row, masked keys whose dK/dV must be exactly zero,
   whole masked key blocks, lengths that are not tile multiples; every
   warps per block the wrappers may pick; dQ and dK/dV twice, bit for
   bit), each within 1e-4 relative; then the forward (no ``lse``) at the
   KV-cache decoders' one-query-row sites as the model passes them (the
   eval/BLEU decode's self-attention over a 200-position cache at steps
   0, 31, 32, 33, 99 and 198, with and without pads inside the written
   prefix, its cross-attention and its priming call; the beam engine's
   16-row grid over a reordered cache and over the memory), at every
   launch choice, within 1e-4 relative, two runs the same bits; then all
   of phase 3 again on bf16 inputs against the bf16 instantiations (the
   same sites, edge cases and launch choices, bf16 and int8 pages under a
   bf16 query): outputs within two bf16 ulps of the largest value
   (``BF16_TOL``), ``lse`` within 1e-5 relative;
4. serving — the reference MT model at full width (d_model 512, ffn 1024,
   8 heads of 64, 1 layer, max_len 200, ~8,000-word vocabularies, random
   weights from a seed in the JAX package's Flax layout, through the
   weight bridge) served by ``Translator.serve``: 64 concurrent requests,
   some repeated, by the paged engine with fp32 pages and with int8
   pages and by the padded engine (fp32, 32 rows a batch); the first 16
   by a beam engine (4 beams, 4 prompts a batch). Checks that every
   request completes, that the pools drain, that each engine's kernels
   ran, and the token agreement (each >= 0.99) of the paged fp32 engine
   with the one-shot greedy decoder on the CPU (plain versions), of the
   int8 engine and of the padded engine with the paged fp32 engine, of
   the one-shot ``Translator`` (KV-cache greedy) with the uncached
   ``greedy_translate`` on the card, and of the beam engine with
   ``beam_translate`` on the CPU; then that sampling from one CUDA
   generator seed repeats and that sampling at temperature 0 is greedy.
   Every engine captures its programs as CUDA graphs at warmup (paged:
   one prefill per chunk width and the 4-step launch; padded and beam:
   the whole decode of each bucket): each must hold the JAX engine's
   program count, read ``recompiles_after_warmup == 0`` after its run,
   and launch each kernel exactly as often as eager execution of the
   same replays would (every capture's recorded launches equal its eager
   warm run's). Then one paged launch (fp32 and int8 pages) and one
   bucket decode (padded and beam), replayed, must equal an eager call of
   the same function on cloned stores and inputs bit for bit. The one-shot
   ``Translator`` keeps one CUDA graph per call shape: greedy and beam at
   32 and 16 rows, a second call captures nothing and its ids equal an
   eager call of the decoder bit for bit, with the same launches; then
   ``Translator.save`` -> ``load`` on the card gives the same tokens;
5. training — ``recipes.translation.train_translator`` on the card at the
   reference recipe's full width (dropout 0.1, Adam 1e-3, batch 32, one
   epoch over the 400 fixture pairs in ``assets/fixtures``: 12 steps), then
   ``evaluate`` and BLEU (the KV-cache greedy decoder) over the 80
   validation pairs. Checks finite, falling loss and that the dQ and dK/dV
   kernels ran exactly 3 sites x steps x layers times; decodes the
   validation pairs once more on the card and on the CPU (token agreement
   >= 0.99, both BLEU figures). Then a parity run: dropout 0, random
   weights in the Flax layout bridged in, 4 steps on the card and the
   same 4 on the CPU (plain versions): per-step losses within 1e-3
   relative, step-0 gradients within 1e-4 relative. Then the recipe's
   fixture epoch twice (dropout 0.1) at 1, 4 and 5 steps per call (one
   CUDA graph per group; 5 leaves a tail of 2 single steps): every
   parameter and step loss bit for bit against 1 step per call, one
   program per (K, accumulation phase) and none new in the second epoch,
   a replay's launches equal to its eager first call's (3 sites x K of
   each training kernel). Then 2 epochs with ``checkpoint_dir`` and a
   resumed run of 2 more, at 4 steps per call, equal bit for bit to 4
   epochs in one run; with the newest payload torn the newest valid step
   is the one before, and the ``latest`` pointer names a complete step
   throughout;
6. the model zoo — every zoo recipe through its entry point at the
   reference widths on the committed fixtures: ``train_mlp`` (the libsvm
   sample, layers 4-5-4-3, SGD 0.03, batch 30, its 100 epochs),
   ``train_cnn`` on CIFAR-10 (32x32x3) and on FashionMNIST (28x28x1)
   (TinyVGG, hidden 10, SGD 0.01, batch 32) and ``train_lstm`` on AG_NEWS
   (embed 32, hidden 32, 2 layers, dropout 0.5, ``max_seq_len`` 128, Adam
   1e-3, batch 32) reading the last and the last valid position, one
   epoch each: finite losses, and none of the attention kernels launched.
   The CNN (CIFAR-10) and both LSTM recipes at 4 steps per call (one CUDA
   graph) against 1: every parameter and step loss bit for bit, one
   program; 1 + 1 resumed CNN epochs against 2 in one run. Each recipe
   with dropout off on the card and on the CPU: per-epoch losses within
   1e-3 relative, step-0 gradients within 1e-4 of the largest (the four
   largest per-parameter differences printed). ``Classifier.save`` ->
   ``load`` on the card predicts the same classes (LSTM, CNN). The MLlib
   ``MultilayerPerceptronClassifier`` (L-BFGS, maxIter 100) on the card
   and on the CPU: the first 10 losses within 1e-4 relative, the same
   test accuracy; fit wall, iterations and final loss. Then per recipe at
   1 and 4 steps per call: ms per step (CUDA events), samples/s (non-pad
   tokens/s for the LSTM), device ms per step and the idle share of a
   profiled window, peak memory above the state; one LSTM layer's
   forward + backward, the port's recurrence eager and as one CUDA graph
   against ``torch.nn.LSTM`` (cuDNN) over the same weights; the CNN step
   with cuDNN's deterministic algorithms on and off;
7. the translation recipe's options, at the reference width on the
   fixture: ``examples/advanced_translator.py``'s run (4 experts,
   warmup-cosine over 20 steps, clipping 1.0, accumulation 2, BLEU,
   checkpoints): finite losses and ``moe_aux``, dQ and dK/dV launched 3 x
   steps; ``Translator.save`` -> ``load`` of the MoE translator served by
   the paged fp32 engine (the ragged kernel launched) against the CPU's
   one-shot greedy decoder and a beam-4 decode against the CPU's (token
   agreement >= 0.99; the engine against the one-shot decoder at its own
   prefill width, since an MoE encoder's expert capacity follows the
   width); 4 steps per call against 1 bit for bit; the epoch card vs CPU
   (dropout 0, every step's loss within 1e-3 relative) and the MoE parity
   run (4 steps, step-0 gradients within 1e-4 relative, router and
   experts included). remat
   against none at 1 and 4 steps per call bit for bit with dropout 0.1,
   the forward launched once more per site and step; one step's
   gradients with dropout from one seed bit for bit, and the peak memory
   and time of each. ``bucket_by_length`` (boundaries 50, 100, 200): an
   epoch card vs CPU within 1e-3, the padding efficiency, a step's ms at
   each width. ``pack_sequences`` (batches of 7 packed rows): an epoch
   card vs CPU within 1e-3, no flash launch in training, 4 steps per call
   bit for bit over two epochs, packed against unpacked scored tokens/s.
   ``fit(profile_dir=, profile_window=(2, 5))`` at 1 and 4 steps per call:
   one Chrome trace each, the flash kernels named at 1, what the trace
   holds at 4. The fixture pipelines' native text encoding: ids equal to
   the Python chain, both times. (Phase 3 also holds the training kernels
   at the buckets' widths, 50/50, 50/49, 100/100 and 100/99, at every
   launch choice.)
7b. the distributed path — the reference's flagship run as users run it:
   ``Session.builder.appName("DistributedCNN").config(
   "spark.executor.instances", "2").getOrCreate()`` ->
   ``Distributor(num_processes=2, local_mode=True).run(
   "...recipes.cnn:train_cnn", data_root=..., dataset="cifar10")``: two
   rank processes on the one card over gloo (the backend rule prints its
   choice), rank 0's result with ``world_processes == 2``, finite
   ``test_loss`` and ``accuracy``, and each rank's backend, device and
   parameters' device read from its telemetry file. Then the MT recipe at
   reference width (dropout 0) as a 2-rank gang at per-replica batch 16
   with ``MLSPARK_TELEMETRY_DIR`` set: rank 0's per-step losses within
   1e-5 relative and each of its final parameter tensors against one
   process on the card fed the same global batches (both ranks' batches
   in rank order; a tensor whose float noise Adam amplifies beyond 1e-5
   is held to 10 x a control run's, the same batches with the ranks'
   rows in the other order), ``assert_replicas_in_sync`` (its divergence
   printed), each rank's flash forward, dQ and dK/dV launches (3 x its
   steps, plus the eval forward), and the merged gang report with both
   ranks' step spans (its skew and comms reports printed), and the report
   CLIs over that directory as a user runs them after a run:
   ``tools/torch_telemetry_report.py`` (exit 0, every rank, its JSON the
   in-process report) and ``tools/torch_trace_report.py --perfetto``
   (exit 0, a process row for every rank), their seconds printed. Then the CNN
   gang again, with rank 1 raising at step 3 while rank 0 goes into that
   step's all-reduce: a ``GangFailure`` naming rank 1 and the message, no
   stray process group and a flight dump;
7c. the gang that survives a crash and reports its health — the MT
   recipe at reference width (dropout 0, 16 a replica) as a 2-rank gang
   with ``checkpoint_dir``, 2 epochs of 12 steps a rank, once unfaulted
   and once with rank 1 crashed at step 18 (``MLSPARK_FAULTS``) under
   ``Distributor(max_restarts=1)``: the crash fired, every rank of the
   retried gang resumed step 12, and its step losses after the resume and
   its final parameters equal the unfaulted gang's bit for bit; each
   rank's flash launches 3 x the steps it ran (+ the eval's forwards);
   both spawn-to-result walls and their difference, the time to recover.
   Then rank 1's newest payload cut in half and its pointer set back to
   step 12: the next run resumes step 12 on both ranks and again ends on
   the unfaulted gang's bits. The MLlib estimator (4-5-4-3, maxIter 5,
   the libsvm sample's 60 % split) in the same 2-rank gang, after that
   run, against one process on the card (atol 1e-5 after rtol 1e-4,
   JAX's ``TestMeshFit`` bound): the gang's first fit wall and again
   after it, one process's, all-reduces per iteration. The live plane: a
   paged (fp32) and a padded engine behind the HTTP plane on an
   ephemeral port, ``/healthz`` 200 -> 503 on a launch quarantined by a
   ``decode_batch`` fault -> 200 after the next, ``/statusz``'s
   ``serving`` (and ``prefix_cache``) sections, ``/metrics``' live
   gauges, and ``/tracez?id=`` of a served request rooted at its
   ``serving.submit`` span;
7d. bf16 compute — the MT recipe at the reference width with
   ``dtype="bfloat16"``, one fixture epoch at 1 and 4 steps per call:
   float32 parameters, step losses and parameters bit for bit, the bf16
   dQ and dK/dV launched 3 x 12 each and no float32 kernel; the card's
   bf16 losses over 2 steps against the CPU port's bf16 run (within one
   bf16 ulp; the step-0 gradients within 2^-5 of the largest); that model
   saved (``"dtype": "bfloat16"``), loaded and served by the paged engine
   over bf16 pages and over int8 pages, the padded and the beam engine
   (program counts, zero recompiles, replays equal to eager calls bit
   for bit), the bf16 paged engine against the bf16 one-shot decoder on
   the card (token agreement >= 0.99) and, as readings, int8 against
   bf16 pages, padded against paged, the beam engine against the one-shot
   beam decoder and bf16 against the float32 model on the same weights;
   TinyVGG on the CIFAR-10 fixture at bf16 and the MoE options at bf16,
   4 steps per call against 1 bit for bit;
7e. ZeRO-1 on the data axis and the gang's K steps — ``Session`` ->
   ``Distributor(dp_mode="zero1")`` -> the MT recipe at reference width
   (dropout 0, 16 a replica, one fixture epoch) as a 2-rank gang, 13
   recipe runs in one gang: ZeRO-1 against the replicated gang on the
   same global batches (step losses and each parameter tensor within
   1e-5 relative, the key biases within 2 x lr x steps; whether the bits
   are equal is printed), overlap off against on bit for bit, the bf16
   wire (step losses within 2 x 2^-8 of the float32 wire's, and falling)
   and the int8 wire (losses falling), the optimizer bytes per rank
   (exactly 2 x 4 x the padded shard + 4) beside the replicated gang's
   and both peaks, each rank's flash forward, dQ and dK/dV launches equal
   to the replicated gang's, the replicated gang at 4 steps per call
   against 1 bit for bit, and ZeRO-1 checkpoints: 1 + 1 epochs against 2
   (losses, parameters and the ranks' moment shards bit for bit). Then
   each rank's step times over 20 steps after 5: the replicated step,
   ZeRO-1 (overlap on and off, the bf16 and int8 wires) and the
   replicated step again, with the host-timed reduce-scatter, all-gather
   and all-reduce windows per step, and ``fit``'s dispatch at 1 and 4
   steps per call;
7f-7l. Phases 7f, 7g, 7h, 7i and 7l share one 4-rank gang
   (``run_shared_gang``: each phase's work in this process up to its gang
   job, the jobs in turn in one ``Session`` -> ``Distributor`` gang over
   gloo, then each phase's gates), since a gang's start costs ~15 s on
   the card's machine (importing torch). Each rank serves its HTTP plane
   (``telemetry_http=0``, its sidecar in the gang's telemetry directory),
   and ``tools/torch_gang_status.py`` scrapes the running gang once from
   a thread beside it: exit 0, every rank scraped;
7f. tensor parallelism on the model axis — ``Session`` -> ``Distributor``
   -> the 4-rank gang sharing the card over gloo, every mesh a view of
   its process group: the MT model at reference width (dropout 0, Adam,
   global batch 32, the fixture's first epoch and its eval) on (a)
   ``{data: 4}``, (b) ``{data: 1, model: 4}`` (2 heads a rank), (c)
   ``{data: 2, model: 2}``, (d) (c) under ZeRO-1 (float32 overlapped and
   serial, the bf16 wire), (e) (c) with checkpoints, 1 + 1 epochs
   against 2, and a resume under (b) that must raise
   ``TopologyMismatch``, (f) ``train_translator(model_parallel=2)``
   returning a gathered ``Translator``, whose paged engine serves 64
   fixture sentences. Gates: (b) and (c) step losses within 1e-4
   relative of one process on the same global batches; (d) float32 the
   bits of (c), parameters and each rank's moment shards, the bf16 wire's
   losses within 2 x 2^-8 of float32's; (d)'s optimizer bytes per rank
   exactly 2 x 4 x its shard + 4 and at most the replicated model's / 4
   + 64; (e) bit for bit; (f) gathered parameters the shards
   concatenated, paged engine against its one-shot decode >= 0.99 and no
   recompile after warmup; every rank 45 / 36 / 36 flash launches a
   fixture epoch with eval; the training kernels against their plain
   versions at the TP shapes ``[32,4,..]``, ``[16,4,..]``, ``[32,2,..]``.
   Printed: each mesh's step ms beside one process's, the model axis's
   ``comms.tp_allreduce`` window and bytes per step, the data axis's
   window, each rank's peak and optimizer bytes;
7g. pipeline parallelism on the pipeline axis — ``Session`` ->
   ``Distributor`` -> one 4-rank gang sharing the card over gloo: the MT
   model at reference width and ``num_layers = S`` (dropout 0, Adam,
   global batch 32, the fixture's first 8 batches and its eval) on (a)
   ``{pipeline: 4}`` at M = 4 and (b) M = 8 (num_layers 4), (c) ``{data:
   2, pipeline: 2}`` at M = 2 (num_layers 2), (c) at 4 steps per call and
   (d) at bf16; (e) ``train_translator(pipeline_parallel=2,
   pipeline_microbatches=4, remat=True)`` with checkpoints, 1 + 1 epochs
   against 2; ZeRO-1 on (c) must raise the JAX ``ValueError``. Gates:
   (a)-(c) step losses within 1e-4 relative of one process at the same
   depth on the same global batches, each parameter tensor within 1e-4
   (relative norm; key biases within 2 x lr x steps), every rank's
   parameters and moments the same bits; K = 4 and (e) bit for bit; (d)
   within the bf16 gate of one process at bf16; each rank's flash
   forward, dQ and dK/dV launches exactly 3 x (L/S) x M a step (twice the
   forwards under remat) and 3 x L an eval batch; (e)'s Translator agrees
   >= 0.99 with one process's on the same weights; the training kernels
   against their plain versions at the microbatch shapes ``[8,8,..]`` and
   ``[4,8,..]``, fp32 and bf16. Printed: each mesh's step ms beside one
   process's at the same depth, the bubble ``(S-1)/(M+S-1)``, the hops'
   (``pp_send``, ``pp_recv``, ``pp_bcast``, ``pp_allreduce``) bytes and
   windows per step, the gradient sync's, each rank's peak;
7h. the sequence axis — (a) the flash forward with ``lse`` and the dQ
   and dK/dV kernels at the ring's hop shapes ``[32, 8, 50, 64]``,
   ``[32, 8, 100, 64]`` and ``[2, 8, 512, 64]``, fp32 and bf16: the
   diagonal hop (causal) and a hop behind (unmasked, rows with no valid
   key) against their plain versions, the two merged by ``lse`` against
   the forward over both chunks at once, and each hop's dQ and dK/dV with
   the merged ``lse`` and ``delta`` against their plain versions (the
   hops' dQ summed against the whole backward's); (b) ``Session`` ->
   ``Distributor`` -> one 4-rank gang sharing the card over gloo: the MT
   model at reference width (1 layer, dropout 0, Adam, the fixture's
   first epoch at global batch 32, targets one pad longer, and its eval)
   under ``sequence_parallel`` on ``{seq: 4}`` (ring, then Ulysses) and
   ``{data: 2, seq: 2}`` (ring): step losses and each parameter tensor
   within max(1e-4, 10 x a control's distance: one process on the same
   batches in two microbatches a step) of one process on the same global
   batches, every seq line the same bits after every
   step, each rank's flash forward, dQ and dK/dV launches as the hop
   schedule says (ring: n + (r + 1) + n a step on seq index r, the chunks
   ahead of the causal decoder skipped; Ulysses: 3); (c)
   ``train_translator(sequence_parallel=2)`` under ring and under Ulysses
   with checkpoints and BLEU (a falling loss, a finite BLEU, each rank's
   checkpoint, dQ and dK/dV launches per the schedule); (d) one train
   step at 2,048 positions (batch 2, remat, the published 8004 vocabulary,
   ids from the seed) on ``{seq: 4}`` under ring against one process:
   the loss within 1e-4 relative, each gradient tensor within max(1e-4,
   10 x the dense path's distance from the flash path in one process),
   the key biases' (true gradient 0) within 1e-4 of the largest gradient,
   each rank's peak beside one process's under ``attention_impl("flash")``
   and ``("dense")``.
   Printed: each mesh's step ms beside one process's, the seq line's
   ``comms.sp_ring`` / ``sp_a2a`` / ``sp_gather`` windows and bytes per
   step, each rank's launches and peak; the phase's own seconds;
7i. the MoE expert axis — ``Session`` -> ``Distributor`` -> one 4-rank
   gang sharing the card over gloo: the MT model at reference width (1
   layer, 8 experts, capacity factor 1.25, dropout 0, the published
   8004-word vocabularies, 4 of the fixture's global batches of 32) on
   ``{expert: 4}`` (a), ``{data: 2, expert: 2}`` (b) and ``{expert: 2,
   model: 2}`` (c), each against one process (rank 0 alone, before the
   meshes) from the same weights: one forward's logits and ``moe_aux``
   within 1e-4; 4 SGD steps, each tensor's displacement within max(1e-4,
   10 x a control's: one process on the same batches with 16 rows of
   padding after them, the same loss at other matmul shapes) — this gate
   carries correctness; 4 Adam steps, each tensor within max(1e-4, 10 x
   the control's), a noise gate (Adam turns float noise into lr-sized
   steps); every data line in sync, 12 flash
   forward / dQ / dK/dV launches a fit on every rank, each rank's
   expert-weight bytes 1/(N·M) of one process's 67,108,864; (d)
   ``train_translator(moe_experts=8, expert_parallel=2)`` on ``{data: 2,
   expert: 2}`` with checkpoints and BLEU on the gathered model, and a
   second run resumed from the first's last step (dQ and dK/dV 3 a step).
   Printed: each mesh's step ms (Adam, 3 after 1) beside one process's,
   the ``comms.ep_allreduce`` (and ``tp_allreduce``) calls, bytes and
   window per step, the peak per rank; the phase's own seconds;
7k. the serving fleet — ``ReplicaGang("chip_smoke:fleet_replica_rank",
   platform=None)``: 2 replica processes on the card, each phase 4's
   translator (reference width, the 8,000-word vocabularies, weights from
   the seed) served by ``fleet.serve_replica`` with phase 4's paged knobs,
   behind ``FleetRouter(policy="affinity")``. (a) phase 4's 64 prompts
   routed from 16 client threads: every request completes, token agreement
   with phase 4's in-process paged engine >= 0.99 (mismatches printed),
   the router ledger balances, every replica scrapes 0 in flight and 0
   recompiles after warmup, both replicas served, and each replica
   launched the flash forward and the ragged decode (read off its
   ``/statusz``: ``tools/torch_fleet_bench.serve_counted``) over this pass
   and a second of 8 x the prompts from 16 closed-loop clients, which is
   timed against one engine in this process on the same work; (b)
   ``kill_rank(1)`` under 8 closed-loop clients: only rank 1's in-flight
   requests lost, rank 0 serves through the outage, rank 1 restarts and
   serves again, the ledger balances; (c) a ``FleetAutoscaler`` on the
   router's scrape loop takes the gang 2 -> 3 under queue-depth load (16
   closed-loop clients; the added replica must scrape healthy and then be
   dispatched to: the router counts its own dispatches not yet answered
   into each replica's load, where the JAX router reads the scraped load
   alone and herds a burst onto one replica) and back to 2 by draining the
   coldest replica under 1 client, no request lost, every decision with
   its inputs. Printed: each replica's start-up
   seconds (spawn to first healthy scrape, graph capture included), the
   time to recover (kill to rank 1 serving a routed request again), the
   added replica's start-up, the requests routed to it and their share of
   the hot load's, requests/s and
   tokens/s through the fleet beside one engine, the skew
   (``replica_skew``), each replica's launches and peak memory, the
   decisions; no throughput gate (the replicas share one card and host);
7m. the drills — the scenario functions of ``tools/torch_fault_drill.py``
   and ``tools/torch_ingest_bench.py`` on the card: (a)
   ``serving_poison`` on phase 4's translator in this process (decode
   launch 0 raises; at most 4 rows decode together): its JAX invariant
   (0 < poisoned <= 4, the rest served, every poisoned request
   quarantined, no loop restart, no recompile after warmup, no KV slot
   leaked, a non-empty flight dump), and the flash forward and the ragged
   decode launched; (b) ``straggler_hedge`` (rank 1's sticky 1.5 s wire
   delay, hedged duplicates, the losers cancelled) then
   ``torn_response_retry`` (rank 1's first response torn, booked lost,
   never replayed), each on its own 2-replica fleet of
   ``fleet_replica_rank`` at phase 4's knobs, one after the other: each
   scenario's JAX invariant, and every replica on the card launched both
   serving kernels in the scenario's traffic (its ``/statusz`` before and
   after); (c) the ingest bench's smoke entry (1,200 records x 32
   features, batch 32, width 64, the python parser, buffer 4, 2 epochs)
   with the model and ``stream_on``'s device stage on the card: its three
   gates (the stream's batches the sync loader's, two epochs the same, no
   thread left) and ``stream_on``'s batches copied to the card. Printed:
   each part's seconds, each replica's start-up seconds and launches, the
   hedge's and the torn response's ledgers, the ingest arms' epoch
   seconds and steady step ms;
7l. the seq axis beside the model and expert axes — the flash forward
   with ``lse``, dQ and dK/dV against their plain versions at the shapes
   this path gives them (``LC_SHAPES``: the ring hop at [32, 4, 100, 64]
   on ``{model: 2, seq: 2}``, Ulysses' inner attention at [32, 2, 200,
   64], the 2,048-position hop at [2, 4, 1024, 64]; diagonal and behind,
   merged by ``lse``, as 7h's, whose [32, 8, 100, 64] hop is the one on
   ``{expert: 2, seq: 2}``); then in the 4-rank gang over gloo on the card, the reference MT
   model at full width (1 layer, the published 8004-word vocabularies,
   dropout 0, 4 of the fixture's global batches of 32, targets one pad
   longer) on (a) ``{model: 2, seq: 2}`` under ring, (b) the same under
   Ulysses, (c) ``{expert: 2, seq: 2}`` under ring with 8 experts: 1
   Adam step then 3 timed, the step losses within 1e-4 of one process's
   on the same batches, every seq line the same bits after every step,
   the launches the hop schedule gives; (d) one step at 2,048 positions
   (batch 2, remat) on ``{model: 2, seq: 2}`` under ring, its loss within
   1e-4 of phase 7h's one process; (e) ``train_translator(
   sequence_parallel=2, model_parallel=2)`` for one epoch with
   checkpoints and BLEU on the gathered model (dQ and dK/dV as the ring
   schedule gives). Printed: each mesh's step ms beside one process's, the
   peak per rank, the ``comms.sp_*``, ``tp_allreduce`` and
   ``ep_allreduce`` calls, bytes and windows per step; the long step's
   peak per rank beside one process's; the phase's own seconds;
8. times — requests/s, generated tokens/s and peak device memory of each
   engine (paged fp32 and int8, padded, beam); each engine's requests/s
   and device idle share over one profiled window; the host time of the
   paged engines' decode thread per launch, split by activity (staging,
   replay, read-back, the Python fold of the emits, the engine's
   bookkeeping, admission and prefill, the loop's waits); each kernel's time
   (CUDA events) beside its bound, its plain version's time and one
   library call's, at the serving shapes (the ragged kernel at the
   decode's cross-attention over fp32 and int8 pages and its
   self-attention with cur over fp32 and int8 pages), at the three
   training sites (and at one sequence of the encoder site, fixture keys
   and all keys valid, where the rules pick dQ's and the forward's key
   split, and at the ring's hop shapes of phase 7h and the shapes of
   phase 7l, diagonal and behind) and at the KV-cache decoders'
   one-query-row sites, and each
   kernel at each of its launch choices; the recipe's evaluate and BLEU
   decode once more under the profiler, for the forward's launches (which
   must equal the recipe run's), device time and bound over the whole
   decode; the BLEU decode of one epoch eager and through the recipe's
   programs (capturing, then replaying): wall and device time, the same
   ids and launches; the train step at 1 and 4 steps per call, in one
   process: ms per step, steps/s, target tokens/s, peak memory, the
   device idle share of one profiled window of steps and the memory the
   4-step program holds; the 2-rank gangs, timed at the end of phase
   7e's gang (MT at per-replica batch 16 on
   the fixture's vocabularies and on the published 8004, TinyVGG on
   CIFAR-10 at 32) against one process at the same global batch over 20
   steps after warm-up: ms per step, non-pad target tokens/s or
   samples/s, the gradient all-reduce's host-timed ms per step (from the
   first bucket's launch to the last one's completion, and summed over
   its buckets) and each rank's device idle share over a profiled
   window; every bf16 instantiation's time at the same sites beside its
   bound (bf16 bytes, the bf16 tensor-core rate), its plain version and
   SDPA at bf16; the MT step (1 and 4 steps per call) and the TinyVGG
   step at fp32 beside bf16: ms, tokens/s or samples/s, idle share and
   peak memory. The profiler's device times at the serving and decode
   sites are over ``PROFILE_CALLS`` calls a session (cut from 50 to pay
   for phase 7m); each part's seconds are printed. (The
   one-shot ``Translator``'s latency, eager
   and replayed, and the memory its programs hold are taken in phase 4.)

The line before the last is ``nvidia-smi``'s name and power limit; before
it, one JSON line with every kernel's numbers. The last line is
``{"ok": true, "device": {...}}``. Without a card it exits nonzero and
prints no result.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TOL = 1e-4  # fp32, kernel vs plain: the two sum in different orders
# bf16 kernels vs their plain versions, relative to the largest value:
# both round at the reference's points (P, dS and the outputs to bf16),
# but sum in other orders and, in the forward, round P against the running
# max of its key tile instead of the row's final max, so an output may
# land one or two bf16 ulps away (2^-8 to 2^-7 of the largest value).
BF16_TOL = 2.0 ** -6
# lse at bf16: float32 sums of exact products of bf16 values, in other
# orders (no rounding to bf16 anywhere on its path).
BF16_LSE_TOL = 1e-5
AGREEMENT_MIN = 0.99
SEED = 0

# The reference MT model (models/transformer.py defaults; the MT driver's
# d_model 512, ffn 1024, 8 heads, 1 layer, max_len 200), dropout off.
MODEL = dict(
    d_model=512, ffn_hidden=1024, num_heads=8, num_layers=1, max_len=200,
    dropout=0.0,
)
VOCAB_WORDS = 8000
SERVE = dict(
    kv_mode="paged", max_active=32, page_size=16, boundaries=(32, 64),
    max_new_tokens=64,
)
N_REQUESTS = 64
N_UNIQUE = 48  # the rest repeat earlier prompts, so the prefix cache hits
# The padded engine at the paged engine's concurrency, and a beam engine
# (4 prompts x 4 beams = 16 rows a batch) over the first N_BEAM prompts.
SERVE_PADDED = dict(
    kv_mode="padded", max_batch=32, boundaries=(32, 64), max_new_tokens=64,
)
SERVE_BEAM = dict(
    method="beam", beam_size=4, max_batch=4, boundaries=(32, 64),
    max_new_tokens=64,
)
N_BEAM = 16

REPLACES = {
    "flash_attention_fwd": "machine_learning_apache_spark_tpu/ops/pallas_attention.py:40",
    "flash_attention_bwd_dq": "machine_learning_apache_spark_tpu/ops/pallas_attention.py:270",
    "flash_attention_bwd_dkv": "machine_learning_apache_spark_tpu/ops/pallas_attention.py:336",
    "ragged_paged_attention": "machine_learning_apache_spark_tpu/ops/pallas_attention.py:638",
}
SOURCES = {
    "flash_attention_fwd": "machine_learning_apache_spark_tpu_torch/csrc/flash_attention_fwd.cu",
    "flash_attention_bwd_dq": "machine_learning_apache_spark_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "machine_learning_apache_spark_tpu_torch/csrc/flash_attention_bwd.cu",
    "ragged_paged_attention": "machine_learning_apache_spark_tpu_torch/csrc/ragged_paged_attention.cu",
}
SERVING_KERNELS = ("flash_attention_fwd", "ragged_paged_attention")

# The training slice: the reference recipe (recipes/translation.py
# defaults) on the fixture corpus, and the parity run's length.
FIXTURES = Path(__file__).resolve().parent / "assets" / "fixtures"
TRAIN = dict(data_root=str(FIXTURES), compute_bleu=True, log_every=1)
PARITY_STEPS = 4
PARITY_RTOL = 1e-3  # card vs CPU losses: summation order, through Adam
GRAD_RTOL = 1e-4  # step-0 gradients, card vs CPU
TIMED_STEPS = 20

# Published peaks of one H100 SXM (NVIDIA data sheet): the HBM rate; the
# fp32 rate outside the tensor cores, which the ragged kernel uses; and
# the effective rate of the tensor-core kernels (flash forward, dQ,
# dK/dV), whose 3xTF32 products take three TF32 passes at 495 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32X3_FLOPS_PER_S = 495e12 / 3
# The bf16 instantiations of the tensor-core kernels take bf16 products at
# the dense bf16 rate; the ragged kernel's bf16 one computes in fp32 on
# the CUDA cores as its fp32 one does.
BF16_FLOPS_PER_S = 989e12
TENSOR_CORE_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# The tensor-core kernels' (warps per block, splits) launch choices,
# checked and timed beside the wrappers' picks.
LAUNCH_CHOICES = ((1, 1), (2, 1), (4, 1), (2, 2), (4, 2))
# Calls one profiler session times at the serving and decode sites
# (phase 8), for the kernel, its plain version, the library call and each
# launch choice: once 50, cut to pay for phase 7m; the device times agree
# at both counts (PERF.md's kernel table). Below 20 calls the sessions
# under-read (PERF.md §6).
PROFILE_CALLS = 20


def scratch_dir() -> Path:
    """Where the smoke writes checkpoints and a saved translator: the
    checkout's ``build/`` (ignored by git)."""
    d = Path(__file__).resolve().parent / "build"
    d.mkdir(exist_ok=True)
    return d


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- phase 1: device ------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 2: build ---------------------------------------------------------------


def sass_opcodes(library: str) -> dict[str, dict[str, int]]:
    """Per kernel function of a built library, how often each tensor-core
    (``HMMA...``) and ``cp.async`` (``LDGSTS...``) opcode occurs in its
    SASS, read with the toolkit's ``cuobjdump``."""
    from machine_learning_apache_spark_tpu_torch.ops.cuda_build import find_nvcc

    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run(
        [str(cuobjdump), "-sass", library], capture_output=True, text=True,
        check=True, timeout=300,
    ).stdout
    found: dict[str, dict[str, int]] = {}
    fn = None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            found[fn] = {}
        elif fn is not None:
            for word in line.replace(";", " ").split():
                if word.startswith(("HMMA", "LDGSTS")):
                    found[fn][word] = found[fn].get(word, 0) + 1
    return found


def check_tensor_core_sass(built: dict) -> dict:
    """Every instantiation of the flash forward, dQ and dK/dV kernels must
    issue HMMA (TF32 in the fp32 kernels, ``HMMA.16816.F32.BF16`` in the
    bf16 ones) and LDGSTS (cp.async) instructions; every instantiation of
    the ragged kernel (fp32, int8 and bf16 pages; fp32 and bf16 queries)
    LDGSTS."""
    libs = sorted({kb.library for kb in built.values()})
    report = {}
    shorts = ("flash_fwd_bf16_kernel", "flash_bwd_dkv_bf16_kernel", "flash_bwd_dq_bf16_kernel",
              "flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel", "ragged_paged_kernel")
    for lib in libs:
        for fn, ops in sass_opcodes(lib).items():
            short = next((k for k in shorts if k in fn), fn)
            log(f"  SASS {short} ({fn[:60]}): {ops or 'no HMMA/LDGSTS'}")
            report.setdefault(short, []).append(ops)
    for short, n_inst, hmma in (("flash_fwd_kernel", 2, "TF32"), ("flash_bwd_dq_kernel", 2, "TF32"),
                                ("flash_bwd_dkv_kernel", 2, "TF32"),
                                ("flash_fwd_bf16_kernel", 2, "HMMA.16816.F32.BF16"),
                                ("flash_bwd_dq_bf16_kernel", 2, "HMMA.16816.F32.BF16"),
                                ("flash_bwd_dkv_bf16_kernel", 2, "HMMA.16816.F32.BF16"),
                                ("ragged_paged_kernel", 8, None)):
        insts = report.get(short, [])
        if len(insts) < n_inst:
            fail(f"expected {n_inst} instantiations of {short} in the SASS, found {len(insts)}")
        for ops in insts:
            if hmma == "TF32" and not any(op.startswith("HMMA") and "TF32" in op for op in ops):
                fail(f"{short}: no TF32 HMMA instruction in its SASS")
            if hmma and hmma != "TF32" and not any(op.startswith(hmma) for op in ops):
                fail(f"{short}: no {hmma} instruction in its SASS")
            if not any(op.startswith("LDGSTS") for op in ops):
                fail(f"{short}: no LDGSTS (cp.async) instruction in its SASS")
    return report


# -- phase 3: kernels vs plain -------------------------------------------------


def _flash_case(torch, rng, b, h, sq, sk, d, *, causal, valid_frac, dev,
                strided=False, empty_batch=None, n_valid=None, dtype=None):
    def t(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        return x if dtype is None else x.to(dtype)

    if strided:
        # Head-split views of a fused [B, S, H*d] projection, as the
        # model passes them: non-contiguous, head dim stride 1.
        q = t(b, sq, 3 * h * d)[..., : h * d].view(b, sq, h, d).transpose(1, 2)
        kv = t(b, sk, 2 * h * d)
        k = kv[..., : h * d].view(b, sk, h, d).transpose(1, 2)
        v = kv[..., h * d:].view(b, sk, h, d).transpose(1, 2)
    else:
        q, k, v = t(b, h, sq, d), t(b, h, sk, d), t(b, h, sk, d)
    kv_valid = None
    if n_valid is not None:  # a padded prompt: its first n_valid keys
        kv_valid = torch.from_numpy(np.arange(sk)[None, :] < np.full((b, 1), n_valid)).to(dev)
    if valid_frac is not None:
        valid = rng.random((b, sk)) < valid_frac
        valid[:, 0] = True
        if empty_batch is not None:
            valid[empty_batch] = False  # rows of this batch see no key
        kv_valid = torch.from_numpy(valid).to(dev)
    return q, k, v, kv_valid


def check_kernels(torch, hop, dev, dtype=None) -> dict:
    """Every kernel against its plain version on the card; returns the
    largest error per kernel instantiation. At ``dtype`` bf16 the inputs
    are bf16 (the bf16 instantiations) and the gate is ``BF16_TOL`` of
    the largest value, not ``TOL`` absolute."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    fwd = hop.kernel_name("flash_attention_fwd", dtype)
    rng = np.random.default_rng(SEED)
    errs = {}
    flash_cases = [
        ("prefill encoder 1x8x64x64, kv_valid", dict(b=1, h=8, sq=64, sk=64, d=64, causal=False, valid_frac=0.6)),
        ("prefill cross 1x64, kv_valid", dict(b=1, h=8, sq=1, sk=64, d=64, causal=False, valid_frac=0.6)),
        ("causal Sq!=Sk 24x70, kv_valid, strided", dict(b=2, h=8, sq=24, sk=70, d=64, causal=True, valid_frac=0.8, strided=True)),
        ("causal Sq>Sk 40x30 (rows see nothing)", dict(b=2, h=4, sq=40, sk=30, d=64, causal=True, valid_frac=None)),
        ("fully masked batch, Sk=45 not a tile multiple", dict(b=3, h=2, sq=17, sk=45, d=128, causal=False, valid_frac=0.5, empty_batch=1)),
        ("d=40, no mask", dict(b=2, h=3, sq=33, sk=65, d=40, causal=False, valid_frac=None)),
        ("greedy decode 64x65x8, causal+kv_valid", dict(b=64, h=8, sq=65, sk=65, d=64, causal=True, valid_frac=0.9, strided=True)),
    ]
    # The serving prefill as the model hands it over: head-split views of
    # a fused qkv, a 64-key chunk with 45 valid keys; and a one-row query
    # against it; at every head dim the kernels build for.
    for d in (8, 40, 64, 128):
        for sq in (64, 1):
            flash_cases.append((
                f"prefill fused qkv {sq}x64, 45/64 valid, d={d}",
                dict(b=1, h=8, sq=sq, sk=64, d=d, causal=False, valid_frac=None, strided=True, n_valid=45),
            ))
    worst = 0.0
    for label, kw in flash_cases:
        causal = kw.pop("causal")
        q, k, v, kv_valid = _flash_case(torch, rng, causal=causal, dev=dev, dtype=dtype, **kw)
        got = hop.flash_attention(q, k, v, causal=causal, kv_valid=kv_valid)
        want = hop.flash_attention_plain(q, k, v, causal=causal, kv_valid=kv_valid)
        # every warps-per-block the wrapper may pick, on the same inputs
        others = [hop.flash_attention_fwd(q, k, v, causal=causal, kv_valid=kv_valid, warps=w, splits=c)
                  for w, c in LAUNCH_CHOICES]
        torch.cuda.synchronize()
        err = max((x.float() - want.float()).abs().max().item() for x in [got, *others])
        rel = max(_rel(x.float(), want.float()) for x in [got, *others])
        nan = any(bool(torch.isnan(x).any().item()) for x in [got, *others])
        choice = hop.flash_fwd_launch_params(*q.shape[:3], k.shape[2], q.shape[3], hop.device_sm_count(dev))
        gate = (f"rel {rel:.3e} (tol {BF16_TOL:.3e} of the largest)" if bf16 else f"(tol {TOL:.0e}")
        log(f"  {fwd:24s} {label:48s} max_abs_err {err:.3e} {gate}; "
            f"(warps, splits) {choice[:2]} "
            f"and each of {LAUNCH_CHOICES}{')' if not bf16 else ''}")
        if nan or not (rel <= BF16_TOL if bf16 else err <= TOL):
            fail(f"{fwd} disagrees with its plain version on {label}")
        if kw.get("empty_batch") is not None:
            if got[kw["empty_batch"]].abs().max().item() != 0.0:
                fail(f"{fwd}: rows that see no key must be zeros")
        worst = max(worst, err)
    errs[fwd] = worst

    # The ragged decode at the serving slice's shapes (32 rows x 8 heads of
    # 64, pages of 16, four per row, lengths 0, 1, 15, 16, 17 and full
    # among random ones), then rows of up to 208 positions (13 pages: a
    # warp walks several chunks, two in flight), then one row alone; each
    # at the wrapper's launch choice and at every splits choice.
    worst = 0.0
    for geometry, R, P in (("serving decode", 32, 4), ("rows of 13 pages", 8, 13)):
        worst = max(worst, _check_ragged(torch, hop, rng, dev, geometry, R, P, dtype=dtype))
    errs[hop.kernel_name("ragged_paged_attention", dtype)] = worst
    return errs


def _check_ragged(torch, hop, rng, dev, geometry, R, P, H=8, dh=64, page=16, dtype=None) -> float:
    D = H * dh
    num_pages = 1 + R * P
    lengths = rng.integers(1, P * page + 1, R).astype(np.int32)
    lengths[:6] = [0, 1, 15, 16, 17, P * page]
    table = np.zeros((R, P), np.int32)
    nxt = 1
    for r in range(R - 1):
        used = -(-int(lengths[r]) // page)
        table[r, :used] = np.arange(nxt, nxt + used)
        nxt += used
    # The last row shares the previous row's pages (a prefix-cache hit):
    # same pages, same length, same query → identical output.
    table[R - 1], lengths[R - 1] = table[R - 2], lengths[R - 2]
    query = rng.standard_normal((R, H, dh)).astype(np.float32)
    query[R - 1] = query[R - 2]

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    name = hop.kernel_name("ragged_paged_attention", dtype)

    def to(x):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return t.to(dtype) if t.dtype == torch.float32 else t

    pages_f32 = [to(rng.standard_normal((num_pages, page, D)).astype(np.float32)) for _ in range(2)]
    pages_i8 = [to(rng.integers(-127, 128, (num_pages, page, D)).astype(np.int8)) for _ in range(2)]
    scales = [to((rng.random((num_pages, page)) * 0.02 + 1e-3).astype(np.float32)).float() for _ in range(2)]
    qkv = to(rng.standard_normal((R, 3 * D)).astype(np.float32))
    q_rows = qkv[:, :D].reshape(R, H, dh)  # strided rows, as the model passes them
    cur_k, cur_v = qkv[:, D:2 * D], qkv[:, 2 * D:]
    tbl, lens = to(table), to(lengths)
    worst = 0.0
    float_store = "bfloat16" if bf16 else "float32"
    for store in (float_store, "int8"):
        kp, vp = pages_f32 if store == float_store else pages_i8
        ks, vs = (None, None) if store == float_store else scales
        for with_cur in (False, True):
            for qname, qq in (("contiguous q", to(query)), ("strided q", q_rows)):
                ck, cv = (cur_k, cur_v) if with_cur else (None, None)
                kw = dict(k_scale=ks, v_scale=vs, cur_k=ck, cur_v=cv)
                want = hop.ragged_paged_attention_plain(qq, kp, vp, tbl, lens, **kw)
                got = hop.ragged_paged_attention(qq, kp, vp, tbl, lens, **kw)
                again = hop.ragged_paged_attention(qq, kp, vp, tbl, lens, **kw)
                others = [hop.ragged_paged_attention(qq, kp, vp, tbl, lens, splits=sp, **kw)
                          for sp in hop.RAGGED_SPLITS]
                # one row alone: the full-length row 5
                one = hop.ragged_paged_attention(
                    qq[5:6], kp, vp, tbl[5:6], lens[5:6], k_scale=ks, v_scale=vs,
                    cur_k=None if ck is None else ck[5:6], cur_v=None if cv is None else cv[5:6])
                torch.cuda.synchronize()
                want = want.float()
                err = max((x.float() - want).abs().max().item() for x in [got, *others])
                err = max(err, (one.float() - want[5:6]).abs().max().item())
                rel = max(_rel(x.float(), want) for x in [got, *others])
                rel = max(rel, _rel(one.float(), want[5:6]))
                choice = hop.ragged_launch_params(dh, P * page, store == "int8", page_bytes=kp.element_size())
                label = f"{geometry}, {store} pages, cur={with_cur}, {qname}"
                gate = (f"rel {rel:.3e} (tol {BF16_TOL:.3e} of the largest;" if bf16
                        else f"(tol {TOL:.0e};")
                log(f"  {name} {label:62s} max_abs_err {err:.3e} {gate} "
                    f"(splits, stages) {choice} and splits {hop.RAGGED_SPLITS})")
                if not (rel <= BF16_TOL if bf16 else err <= TOL):
                    fail(f"{name} disagrees with its plain version ({label})")
                if not torch.equal(got, again):
                    fail(f"{name}: a second run gave other bits ({label})")
                for x in [got, *others]:
                    if not with_cur and x[0].abs().max().item() != 0.0:
                        fail(f"{name}: a length-0 row without cur must be zeros")
                    # (with cur, or strided q, the two rows' own inputs differ)
                    if not with_cur and qname == "contiguous q" and not torch.equal(x[R - 1], x[R - 2]):
                        fail(f"{name}: rows sharing prefix pages differ")
                worst = max(worst, err)
    return worst



# -- phase 3b: the training kernels vs plain -----------------------------------


def fixture_data():
    """The recipe's fixture corpus through the port's pipelines: the two
    pipelines and the train dataset (ids, max_len 200)."""
    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
    from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
    from machine_learning_apache_spark_tpu_torch.data.text import translation_pipelines

    pairs = load_multi30k(str(FIXTURES), "train")
    src_pipe, trg_pipe = translation_pipelines(pairs, max_len=200)
    train_ds = ArrayDataset(
        src_pipe([s for s, _ in pairs]), trg_pipe([t for _, t in pairs])
    )
    return src_pipe, trg_pipe, train_ds


def train_batches(train_ds, n: int):
    """The first ``n`` batches of the recipe's train loader (batch 32,
    shuffled from seed 0, drop_last), as host arrays."""
    from machine_learning_apache_spark_tpu_torch.data.loader import DataLoader

    batches = []
    for b in DataLoader(train_ds, 32, shuffle=True, seed=SEED):
        batches.append(b)
        if len(batches) == n:
            break
    return batches


def training_sites(torch, rng, dev, src, trg_in, heads=8, head_dim=64, dtype=None) -> dict:
    """q, k, v and dO of the three attention sites of one training step at
    the model's width, as the model hands them to the kernels: head-split
    views of the fused ``qkv``/``kv`` projections (and of the cross
    query's), dO the strided view that the backward of
    ``out.transpose(1, 2).reshape(b, s, d)`` gives; ``kv_valid`` from the
    fixture batch's tokens."""
    b, s_src = src.shape
    s_trg = trg_in.shape[1]
    width = heads * head_dim

    def randn(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        return x if dtype is None else x.to(dtype)

    def split(x, s):
        return x.view(b, s, heads, head_dim).transpose(1, 2)

    enc, dec = randn(b, s_src, 3 * width), randn(b, s_trg, 3 * width)
    xq, mem = randn(b, s_trg, width), randn(b, s_src, 2 * width)
    src_valid = torch.from_numpy(src != 0).to(dev)
    trg_valid = torch.from_numpy(trg_in != 0).to(dev)
    return {
        "encoder self": dict(
            q=split(enc[..., :width], s_src), k=split(enc[..., width:2 * width], s_src),
            v=split(enc[..., 2 * width:], s_src), g=split(randn(b, s_src, width), s_src),
            causal=False, kv_valid=src_valid,
        ),
        "decoder self": dict(
            q=split(dec[..., :width], s_trg), k=split(dec[..., width:2 * width], s_trg),
            v=split(dec[..., 2 * width:], s_trg), g=split(randn(b, s_trg, width), s_trg),
            causal=True, kv_valid=trg_valid,
        ),
        "cross": dict(
            q=split(xq, s_trg), k=split(mem[..., :width], s_src),
            v=split(mem[..., width:], s_src), g=split(randn(b, s_trg, width), s_trg),
            causal=False, kv_valid=src_valid,
        ),
    }


def one_sequence_sites(torch, encoder: dict) -> dict:
    """Where the rules pick dQ's and the forward's key split (the rows
    leave the card part empty): one sequence of the encoder site, with the
    fixture's keys (one live key tile) and with all 200 keys valid."""
    one = {k: (x[:1] if torch.is_tensor(x) else x) for k, x in encoder.items()}
    return {
        "encoder self, one sequence": one,
        "one sequence, all keys valid": one | {"kv_valid": torch.ones_like(one["kv_valid"])},
    }


def _edge_case(torch, rng, dev, b, h, sq, sk, d, *, causal, valid_frac, empty_batch=None,
               n_valid=None, dtype=None):
    def randn(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        return x if dtype is None else x.to(dtype)

    valid = None
    if n_valid is not None:  # the first n_valid keys of each batch row
        valid = torch.from_numpy(np.arange(sk)[None, :] < np.full((b, 1), n_valid)).to(dev)
    if valid_frac is not None:
        mask = rng.random((b, sk)) < valid_frac
        mask[:, 0] = True
        if empty_batch is not None:
            mask[empty_batch] = False  # every row of this batch sees no key
        valid = torch.from_numpy(mask).to(dev)
    return dict(
        q=randn(b, h, sq, d), k=randn(b, h, sk, d), v=randn(b, h, sk, d),
        g=randn(b, sq, h, d).transpose(1, 2), causal=causal, kv_valid=valid,
    )


def _rel(got, want) -> float:
    if want.numel() == 0:
        return 0.0
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def check_training_kernels(torch, hop, sites: dict, dev, dtype=None, edges: bool = True) -> dict:
    """The forward with ``lse``, dQ and dK/dV against their plain versions
    on the same inputs, at the training sites and (``edges``) at edge cases. Returns
    each kernel instantiation's largest absolute and relative error. At
    ``dtype`` bf16 (sites made in bf16) the gates are ``BF16_TOL`` of the
    largest value (``BF16_LSE_TOL`` for ``lse``)."""
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    fwd, dq_name, dkv_name = (hop.kernel_name(n, dtype) for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
    rng = np.random.default_rng(SEED + 3)
    cases = list(sites.items()) + ([] if not edges else [
        ("edge: fully masked batch row, Sk=45, d=128",
         _edge_case(torch, rng, dev, 3, 2, 37, 45, 128, causal=False, valid_frac=0.5, empty_batch=1, dtype=dtype)),
        ("edge: causal Sq>Sk 40x30 (rows see nothing), d=16",
         _edge_case(torch, rng, dev, 2, 4, 40, 30, 16, causal=True, valid_frac=None, dtype=dtype)),
        ("edge: causal Sq<Sk 24x70, masked keys, d=64",
         _edge_case(torch, rng, dev, 2, 8, 24, 70, 64, causal=True, valid_frac=0.7, dtype=dtype)),
        ("edge: d=40, 33x65, no mask",
         _edge_case(torch, rng, dev, 2, 3, 33, 65, 40, causal=False, valid_frac=None, dtype=dtype)),
        ("edge: keys 10-199 masked (dead 64-key blocks), d=64",
         _edge_case(torch, rng, dev, 2, 8, 77, 200, 64, causal=False, valid_frac=None, n_valid=10, dtype=dtype)),
        ("edge: d=8, causal 50x50, masked keys",
         _edge_case(torch, rng, dev, 2, 4, 50, 50, 8, causal=True, valid_frac=0.6, dtype=dtype)),
        ("edge: all keys masked, 33x70, d=64",
         _edge_case(torch, rng, dev, 2, 4, 33, 70, 64, causal=False, valid_frac=None, n_valid=0, dtype=dtype)),
        ("edge: one query row, 1x65, masked keys, d=64",
         _edge_case(torch, rng, dev, 2, 8, 1, 65, 64, causal=False, valid_frac=0.8, dtype=dtype)),
    ])
    worst = {n: [0.0, 0.0] for n in (fwd, dq_name, dkv_name)}

    def record(name, label, got, want, tol=BF16_TOL if bf16 else TOL):
        got, want = got.float(), want.float()
        err, rel = (got - want).abs().max().item(), _rel(got, want)
        log(f"  {name:29s} {label:46s} max_abs_err {err:.3e}, rel {rel:.3e} (tol {tol:.3e} relative)")
        if not rel <= tol or bool(torch.isnan(got).any().item()):
            fail(f"{name} disagrees with its plain version on {label}")
        worst[name][0] = max(worst[name][0], err)
        worst[name][1] = max(worst[name][1], rel)

    for label, c in cases:
        q, k, v, g = c["q"], c["k"], c["v"], c["g"]
        kw = dict(causal=c["causal"], kv_valid=c["kv_valid"])
        out, lse = hop.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        want_out, want_lse = hop.flash_attention_lse_plain(q, k, v, **kw)
        finite = want_lse > hop.NEG_INF / 2
        if not torch.equal(lse > hop.NEG_INF / 2, finite):
            fail(f"{fwd}: lse marks other rows as empty than its plain version ({label})")
        record(fwd, label + " (out)", out, want_out)
        if bool(finite.any().item()):
            record(fwd, label + " (lse)", lse[finite], want_lse[finite],
                   tol=BF16_LSE_TOL if bf16 else TOL)
        delta = (g.float() * out.float()).sum(-1)
        dq = hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw)
        dk, dv = hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
        want = hop.flash_attention_backward_plain(q, k, v, out, lse, g, **kw)
        torch.cuda.synchronize()
        record(dq_name, label, dq, want[0])
        record(dkv_name, label + " (dk)", dk, want[1])
        record(dkv_name, label + " (dv)", dv, want[2])
        again = hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw)
        if not (torch.equal(again[0], dk) and torch.equal(again[1], dv)):
            fail(f"{dkv_name}: a second run gave other bits ({label})")
        if not torch.equal(hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw), dq):
            fail(f"{dq_name}: a second run gave other bits ({label})")
        if label.startswith(("edge", "bucket")):  # every launch choice, same inputs
            for fw, fc in LAUNCH_CHOICES:
                o_w, lse_w = hop.flash_attention_fwd(q, k, v, return_lse=True, warps=fw, splits=fc, **kw)
                torch.cuda.synchronize()
                record(fwd, f"{label} (out, {fw}x{fc})", o_w, want_out)
                if not torch.equal(lse_w > hop.NEG_INF / 2, finite):
                    fail(f"{fwd}: lse marks other rows as empty at {fw}x{fc} ({label})")
            for w, sc in LAUNCH_CHOICES:
                dq_w = hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, warps=w, splits=sc, **kw)
                torch.cuda.synchronize()
                record(dq_name, f"{label} ({w}x{sc})", dq_w, want[0])
                if not bool(finite.all().item()) and dq_w[~finite].abs().max().item() != 0.0:
                    fail(f"{dq_name}: rows that see no key must get zero dQ ({w}x{sc}, {label})")
                dk_w, dv_w = hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, warps=w, splits=sc, **kw)
                torch.cuda.synchronize()
                record(dkv_name, f"{label} (dk, {w}x{sc})", dk_w, want[1])
                record(dkv_name, f"{label} (dv, {w}x{sc})", dv_w, want[2])
                if c["kv_valid"] is not None:
                    masked = ~c["kv_valid"][:, None, :, None].expand_as(dk_w)
                    if bool(masked.any().item()) and (dk_w[masked].abs().max().item() != 0.0
                                                      or dv_w[masked].abs().max().item() != 0.0):
                        fail(f"{dkv_name}: masked keys must get exactly zero dK/dV ({w}x{sc}, {label})")
        if c["kv_valid"] is not None:
            masked = ~c["kv_valid"][:, None, :, None].expand_as(dk)
            if bool(masked.any().item()) and (dk[masked].abs().max().item() != 0.0 or dv[masked].abs().max().item() != 0.0):
                fail(f"{dkv_name}: masked keys must get exactly zero dK/dV ({label})")
        if not bool(finite.all().item()):
            empty = ~finite
            if out[empty].abs().max().item() != 0.0 or dq[empty].abs().max().item() != 0.0:
                fail(f"rows that see no key must give zero output and zero dQ ({label})")
    log("  masked keys: dK/dV exactly 0; rows that see no key: output, dQ exactly 0, lse NEG_INF")
    return {n: dict(max_abs_err=a, max_rel_err=r) for n, (a, r) in worst.items()}


# -- phase 3c: the forward at the KV-cache decoders' sites (one query row) ------


def bleu_val_valid() -> np.ndarray:
    """Key validity of the eval/BLEU decode's first batch of sources (the
    first 32 validation pairs through the recipe's pipelines, width 200)."""
    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k

    src_pipe, _, _ = fixture_data()
    pairs = load_multi30k(str(FIXTURES), "valid")
    return np.asarray(src_pipe([s for s, _ in pairs[:32]])) != 0


def _decode_site(torch, rng, dev, rows, sk, kv_valid, *, step_qkv=False, reorder=False, h=8, dh=64,
                 dtype=None):
    """q, k, v of one decode-step attention call as the model passes them:
    q a head-split view of the step's fused qkv ``[rows, 1, 3 h dh]``; K/V
    head-split views of cache buffers ``[rows, sk, h dh]`` (the self
    cache or the memory K/V; with ``reorder``, buffers whose rows beam
    search has gathered by ``index_select``), or, with ``step_qkv``, of
    the step's own qkv (the priming call's self-attention: one key, no
    mask)."""
    d = h * dh

    def randn(*shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        return x if dtype is None else x.to(dtype)

    def heads(t, n):
        return t.view(rows, n, h, dh).transpose(1, 2)

    qkv = randn(rows, 1, 3 * d)
    q = heads(qkv[..., :d], 1)
    if step_qkv:
        k, v = heads(qkv[..., d:2 * d], 1), heads(qkv[..., 2 * d:], 1)
    else:
        order = torch.from_numpy(rng.permutation(rows)).to(dev)
        bufs = [randn(1, rows, sk, d)[0] for _ in range(2)]
        if reorder:
            bufs = [b.index_select(0, order) for b in bufs]
        k, v = (heads(b, sk) for b in bufs)
    valid = None if kv_valid is None else torch.from_numpy(np.ascontiguousarray(kv_valid)).to(dev)
    return dict(q=q, k=k, v=v, kv_valid=valid)


def _prefix_valid(rng, rows, gen_len, t, pads: bool) -> np.ndarray:
    """The self cache's validity at step ``t``: the written prefix (t + 1
    positions); with ``pads``, half the rows finished at a random earlier
    step, so the positions after their eos hold pad (invalid)."""
    valid = np.broadcast_to(np.arange(gen_len) < t + 1, (rows, gen_len)).copy()
    if pads and t >= 2:
        for r in range(0, rows, 2):
            eos_at = int(rng.integers(1, t))
            valid[r, eos_at + 1:] = False
    return valid


def decode_sites(torch, dev, bleu_src_valid: np.ndarray, dtype=None) -> dict:
    """The forward's one-query-row sites of the KV-cache decoders. The
    eval/BLEU decode (32 rows, 8 heads of 64, the cache sized to gen_len
    200): the self-attention at steps 0, 31, 32, 33 (a 32-key tile
    boundary), 99 and 198 (gen_len - 2, the last step), with and without
    pads inside the prefix, the cross-attention over the batch's sources,
    and the priming call (one key, no mask). The beam engine's grid (4
    prompts x 4 beams = 16 rows, gen_len 65, a 64-wide bucket): the
    self-attention at step 40 over a reordered cache and the
    cross-attention."""
    rng = np.random.default_rng(SEED + 6)
    rows, gen_len = bleu_src_valid.shape[0], 200
    sites = {}
    for t in (0, 31, 32, 33, 99, 198):
        for pads in ((False, True) if t else (False,)):
            label = f"BLEU self, step {t}" + (", pads in the prefix" if pads else "")
            sites[label] = _decode_site(torch, rng, dev, rows, gen_len,
                                        _prefix_valid(rng, rows, gen_len, t, pads), dtype=dtype)
    sites["BLEU cross"] = _decode_site(torch, rng, dev, rows, bleu_src_valid.shape[1], bleu_src_valid,
                                       dtype=dtype)
    sites["BLEU priming self"] = _decode_site(torch, rng, dev, rows, 1, None, step_qkv=True, dtype=dtype)
    sites["beam self, step 40"] = _decode_site(
        torch, rng, dev, 16, 65, _prefix_valid(rng, 16, 65, 40, True), reorder=True, dtype=dtype)
    lens = rng.integers(6, 62, 16)
    sites["beam cross"] = _decode_site(torch, rng, dev, 16, 64, np.arange(64)[None, :] < lens[:, None],
                                       dtype=dtype)
    return sites


def check_decode_forward(torch, hop, sites: dict, dev) -> float:
    """The forward (no ``lse``) at every one-query-row site against its
    plain version, at the wrapper's launch choice and at every other, each
    within 1e-4 relative (``BF16_TOL`` for bf16 sites); two runs the same
    bits. Returns the largest relative error."""
    worst = 0.0
    for label, c in sites.items():
        bf16 = c["q"].dtype == torch.bfloat16
        tol = BF16_TOL if bf16 else TOL
        fwd = hop.kernel_name("flash_attention_fwd", c["q"].dtype)
        q, k, v, valid = c["q"], c["k"], c["v"], c["kv_valid"]
        for t in (q, k, v):
            if not hop.kernel_layout_ok(t):
                fail(f"decode site {label}: a view the kernel cannot read without a copy")
        want = hop.flash_attention_plain(q, k, v, kv_valid=valid)
        got = hop.flash_attention_fwd(q, k, v, kv_valid=valid)
        again = hop.flash_attention_fwd(q, k, v, kv_valid=valid)
        others = [hop.flash_attention_fwd(q, k, v, kv_valid=valid, warps=w, splits=c_)
                  for w, c_ in LAUNCH_CHOICES]
        torch.cuda.synchronize()
        rel = max(_rel(x.float(), want.float()) for x in [got, *others])
        choice = hop.flash_fwd_launch_params(*q.shape[:3], k.shape[2], q.shape[3], hop.device_sm_count(dev))
        n_valid = "all" if valid is None else int(valid.sum().item())
        log(f"  {fwd:24s} {label:36s} q {list(q.shape)} k {list(k.shape)} valid {n_valid}: "
            f"max_rel_err {rel:.3e} (tol {tol:.3e} relative; (warps, splits) {choice[:2]} "
            f"and each of {LAUNCH_CHOICES})")
        if not rel <= tol or any(bool(torch.isnan(x).any().item()) for x in [got, *others]):
            fail(f"{fwd} disagrees with its plain version at decode site {label}")
        if not torch.equal(got, again):
            fail(f"{fwd}: a second run gave other bits at decode site {label}")
        worst = max(worst, rel)
    return worst


# -- phase 4: serving -----------------------------------------------------------


def make_vocab_texts(prefix: str) -> tuple[list[str], list[str]]:
    words = [f"{prefix}{i:04d}" for i in range(VOCAB_WORDS)]
    corpus = [" ".join(words[i:i + 50]) for i in range(0, VOCAB_WORDS, 50)]
    return words, corpus


def serving_pipes():
    """The serving slice's words and its source and target pipelines over
    the ``VOCAB_WORDS``-word vocabularies."""
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline

    src_words, src_corpus = make_vocab_texts("s")
    _, trg_corpus = make_vocab_texts("t")
    width = SERVE["boundaries"][-1] - 1
    return src_words, TextPipeline.fit(src_corpus, max_seq_len=width), TextPipeline.fit(
        trg_corpus, max_seq_len=width)


def make_prompts(words: list[str]) -> list[str]:
    rng = np.random.default_rng(SEED + 1)
    unique = [
        " ".join(rng.choice(words, size=int(n)))
        for n in rng.integers(3, 61, N_UNIQUE)
    ]
    repeats = [unique[int(i)] for i in rng.integers(0, N_UNIQUE, N_REQUESTS - N_UNIQUE)]
    prompts = unique + repeats
    order = rng.permutation(len(prompts))
    return [prompts[int(i)] for i in order]


def build_translator(device, params, src_pipe, trg_pipe):
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.models import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab.itos),
        trg_vocab_size=len(trg_pipe.vocab.itos),
        **MODEL,
    )
    model = load_flax_params(Transformer(cfg), params)
    return Translator(model, src_pipe, trg_pipe, device=device)


def model_params(src_pipe, trg_pipe):
    """Random weights from the seed, in the Flax tree layout."""
    from machine_learning_apache_spark_tpu_torch.data.text import PAD_ID
    from machine_learning_apache_spark_tpu_torch.models import TransformerConfig
    from machine_learning_apache_spark_tpu_torch.weights import random_flax_params

    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab.itos),
        trg_vocab_size=len(trg_pipe.vocab.itos),
        **MODEL,
    )
    params = random_flax_params(cfg, SEED)
    # A trained model never emits <pad>; an untrained one would, at random,
    # and the paged engine ends a row on an emitted pad where the one-shot
    # decoder carries on. Pushing the pad logit down keeps the comparison
    # about the kernels, not about that rule.
    params["lm_head"]["bias"][PAD_ID] = -30.0
    return params


def agreement(a: list[str], b: list[str]) -> tuple[float, list[str]]:
    """Share of generated token positions that agree, and the mismatches."""
    same = total = 0
    notes = []
    for i, (x, y) in enumerate(zip(a, b)):
        xs, ys = x.split(), y.split()
        n = max(len(xs), len(ys))
        s = sum(1 for p, q in zip(xs, ys) if p == q)
        same += s
        total += n
        if s != n:
            first = next((j for j, (p, q) in enumerate(zip(xs, ys)) if p != q), min(len(xs), len(ys)))
            notes.append(f"request {i}: {n - s} of {n} positions differ, first at {first}")
    return (same / total if total else 1.0), notes


def expected_programs(eng, engine_kw: dict) -> int:
    """The JAX engine's program count for this configuration: paged, one
    prefill per chunk width and the launch; padded and beam, one decoder
    per bucket."""
    if eng.runtime is not None:
        return eng.runtime.max_chunks + 1
    return len(engine_kw["boundaries"])


def check_programs(label: str, eng, engine_kw: dict, before: list, launches: dict) -> dict:
    """The compile-at-warmup contract over one run: the engine holds the
    JAX engine's program count and built none after warmup; every capture
    recorded the launches its eager warm run made; and the run's launches
    equal what eager execution of the same calls gives (each program's
    replays in the run times its eager launches). Returns each program's
    replays in the run."""
    n, recompiles = eng.compile_count(), eng.recompiles_after_warmup
    if n != expected_programs(eng, engine_kw):
        fail(f"{label} engine holds {n} programs, the JAX engine {expected_programs(eng, engine_kw)}")
    if recompiles != 0:
        fail(f"{label} engine: recompiles_after_warmup {recompiles}")
    after = eng.programs().stats()
    eager = dict.fromkeys(launches, 0)
    replays = {}
    for b, a in zip(before, after):
        if a["launches"] != a["eager_launches"]:
            fail(f"{label} engine: program {a['name']} {a['signature']} recorded "
                 f"{a['launches']} in its capture, {a['eager_launches']} eagerly")
        runs = a["replays"] - b["replays"]
        replays[f"{a['name']} {a['signature'][0][0]}"] = runs
        for k, m in a["eager_launches"].items():
            eager[k] += runs * m
    if launches != eager:
        fail(f"{label} engine launched {launches}, eager execution of its replays {eager}")
    return replays


def serve_once(torch, hop, translator, prompts, label: str, **engine_kw) -> dict:
    """One engine over all prompts; returns outputs, counts and times.
    Checks that every request completes, that the pools drain, that each
    kernel of the engine's path launched (paged: the flash forward and the
    ragged decode; padded and beam: the flash forward), and the
    compile-at-warmup contract (``check_programs``)."""
    eng = translator.serve(**engine_kw)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = eng.programs().stats()
        hop.reset_launches()
        t0 = time.perf_counter()
        futs = [eng.submit(p) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(hop.LAUNCHES)
        paged = eng.runtime is not None
        stats = eng.runtime.stats() if paged else {}
        rows_in_use = eng.pool.in_use
        metrics = eng.metrics.summary()
        eng.metrics.check_conservation(in_flight=0)
        peak = torch.cuda.max_memory_allocated()
        replays = check_programs(label, eng, engine_kw, before, launches)
        programs = eng.compile_count()
    finally:
        eng.stop()
    if metrics["completed"] != len(prompts):
        fail(f"{label} engine completed {metrics['completed']} of {len(prompts)}")
    if rows_in_use or stats.get("active_rows") or stats.get("self_pages_in_use"):
        fail(f"{label} engine pools not back at baseline: rows {rows_in_use}, {stats}")
    dtype = translator.model.cfg.dtype
    for name in SERVING_KERNELS if paged else ("flash_attention_fwd",):
        if launches[hop.kernel_name(name, dtype)] <= 0:
            fail(f"{label} engine never launched {hop.kernel_name(name, dtype)}")
    if dtype != torch.float32 and any(launches[n] for n in hop.KERNELS):
        fail(f"{label} engine (a {dtype} model) launched a float32 kernel: {launches}")
    return dict(
        outs=outs, wall=wall, launches=launches, stats=stats,
        tokens=metrics["tokens_out"], peak=peak, kv_mode=eng.kv_mode,
        hits=stats["prefix_cache"]["hits"] if paged else None,
        programs=programs, replays=replays,
    )


def replay_vs_eager(torch, hop, translator, prompts, prefix: str = "") -> None:
    """One paged launch (fp32 and int8 pages, rows of real prompts two
    launches in) and one bucket decode (padded and beam, a rectangle of
    real prompts) replayed from the programs captured at warmup, against
    an eager call of the same function on cloned stores and inputs: the
    outputs and the stores bit for bit, and the replay's launches equal
    to the eager call's."""
    from machine_learning_apache_spark_tpu_torch.serving import ServeRequest

    dev = translator.device

    def compare(label, replay, eager):
        hop.reset_launches()
        want = eager()
        torch.cuda.synchronize()
        eager_n = dict(hop.LAUNCHES)
        hop.reset_launches()
        got = replay()
        torch.cuda.synchronize()
        if dict(hop.LAUNCHES) != eager_n:
            fail(f"{label}: the replay launched {dict(hop.LAUNCHES)}, the eager call {eager_n}")
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                diff = (g.double() - w.double()).abs().max().item()
                fail(f"{label}: replay and eager call differ (max abs {diff:.3e})")
        log(f"  {label}: replay == eager call bit for bit over {len(got)} tensors, "
            f"launches {eager_n}")

    for kv in ("float32", "int8"):
        eng = translator.serve(start=False, kv_dtype=kv, **SERVE)
        eng.warmup()
        rt = eng.runtime
        for row, p in enumerate(prompts[: rt.max_active]):
            if rt.admit(ServeRequest(p, translator.src_pipe.ragged([p])[0], 0.0), row) is None:
                fail(f"paged {kv}: no pages for prompt {row}")
        for _ in range(2):
            rt.grow()
            rt.launch()
        rt.grow()
        inputs = [t.to(dev) for t in rt._stage()]
        stores = [None if t is None else t.clone() for t in rt.stores()]

        def eager(stores=stores, inputs=inputs, rt=rt):
            return [rt._decode(stores, *inputs), *(t for t in stores if t is not None)]

        def replay(rt=rt):
            return [rt._replay(rt._stage()), *(t for t in rt.stores() if t is not None)]

        compare(f"{prefix}paged {kv} launch", replay, eager)
    pad = translator.model.cfg.pad_id
    for label, kw, n in (("padded", SERVE_PADDED, None), ("beam", SERVE_BEAM, N_BEAM)):
        eng = translator.serve(start=False, **kw)
        eng.warmup()
        b = kw["boundaries"][-1]
        src = np.full((eng.max_batch, b), pad, np.int64)
        for i, p in enumerate(prompts[:n][: eng.max_batch]):
            ids = translator.src_pipe.ragged([p])[0][:b]
            src[i, : len(ids)] = ids
        host = torch.from_numpy(src)
        compare(f"{prefix}{label} bucket {b} decode",
                lambda eng=eng, host=host: [eng._decode(host).clone()],
                lambda eng=eng, host=host: [eng._decode_body(host.to(dev))])


def one_shot(torch, hop, label: str, decode, dtype=None) -> tuple[list[str], dict]:
    """``decode()`` (a one-shot decoder on the card, of a model computing
    in ``dtype``) with the launch counts set to 0 just before and read
    just after; it must have launched the flash forward of its dtype, and
    a bf16 model no float32 kernel."""
    dtype = dtype or torch.float32
    torch.cuda.synchronize()
    hop.reset_launches()
    outs = decode()
    torch.cuda.synchronize()
    launches = dict(hop.LAUNCHES)
    fwd = hop.kernel_name("flash_attention_fwd", dtype)
    if launches[fwd] <= 0:
        fail(f"{label} never launched {fwd}")
    if dtype != torch.float32 and any(launches[n] for n in hop.KERNELS):
        fail(f"{label} (a {dtype} model) launched a float32 kernel: {launches}")
    return outs, launches


def uncached_greedy(torch, translator, prompts) -> list[str]:
    """The uncached ``greedy_translate`` over the prompts, as text: the
    decoder the one-shot ``Translator`` used before the KV cache."""
    from machine_learning_apache_spark_tpu_torch.data.text import EOS_ID, SOS_ID
    from machine_learning_apache_spark_tpu_torch.models import greedy_translate
    from machine_learning_apache_spark_tpu_torch.train.metrics import strip_special_ids

    src = torch.as_tensor(translator.src_pipe(prompts), dtype=torch.long, device=translator.device)
    ys = greedy_translate(translator.model, src, max_new_tokens=SERVE["max_new_tokens"],
                          sos_id=SOS_ID, eos_id=EOS_ID)
    rows = strip_special_ids(ys, pad_id=translator.model.cfg.pad_id, sos_id=SOS_ID, eos_id=EOS_ID)
    return [" ".join(translator.trg_pipe.vocab.lookup_tokens(r)) for r in rows]


# -- phase 5: times ---------------------------------------------------------------


def cuda_time_ms(torch, fn, n: int = 200, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device_us(evt) -> float:
    """Self device time of one profiler row, in microseconds."""
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else getattr(evt, "self_cuda_time_total", 0.0))


def profile_device(torch, fn) -> list:
    """``fn()`` under ``torch.profiler`` with device activity only (no
    host-op recording, so little added host cost); returns ``(name,
    calls, device_us)`` rows, busiest first. Empty when the profiler saw
    no device work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()]
    return sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])


def device_ms_per_call(torch, fn, n: int | None = None) -> float | None:
    """Device time of one call (all its kernels), from the profiler over
    ``n`` calls (default ``PROFILE_CALLS``); None when the profiler saw no
    device work."""
    n = PROFILE_CALLS if n is None else n
    fn()

    def many():
        for _ in range(n):
            fn()

    rows = profile_device(torch, many)
    return sum(r[2] for r in rows) / 1e3 / n if rows else None


def serve_window(torch, eng, prompts) -> float:
    """Submit every prompt at once and wait for all: the window's wall
    seconds, from a synchronised card to a synchronised card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in [eng.submit(p) for p in prompts]:
        f.result(timeout=600)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled_window(torch, eng, prompts, window=serve_window) -> dict:
    """One serving window under the profiler (device activity only):
    wall, device busy seconds and idle share, the profiler's rows, and the
    outer time with its start and stop. ``busy`` is None when the profiler
    saw no device work."""
    out = {}

    def run():
        out["wall"] = window(torch, eng, prompts)

    t0 = time.perf_counter()
    rows = profile_device(torch, run)
    out["outer"] = time.perf_counter() - t0
    out["rows"] = rows
    out["busy"] = sum(r[2] for r in rows) / 1e6 if rows else None
    out["idle_share"] = None if out["busy"] is None else 1 - out["busy"] / out["wall"]
    return out


#: The paged engine's decode-thread activities that ``host_split`` times:
#: (label, engine or runtime, method). A method a tree lacks is left out.
HOST_ACTIVITIES = (
    ("admission", "engine", "_paged_admit"),
    ("take", "batcher", "take"),
    ("prefill", "runtime", "_prefill"),
    ("step", "engine", "_paged_step"),
    ("launch", "runtime", "launch"),
    ("launch_device", "runtime", "_launch_device"),
    ("stage", "runtime", "_stage"),
    ("replay", "runtime", "_replay"),
    ("read_back", "runtime", "_read_back"),
)


def host_split(torch, translator, engine_kw: dict, prompts, window=serve_window) -> dict:
    """Host time of a paged engine's decode thread over one window, by
    activity, in ms per launch: a fresh engine is warmed up, each method
    of ``HOST_ACTIVITIES`` is wrapped on the instance with a clock, and
    the engine starts and serves the window. Derived: the
    Python ``fold`` of the emits (launch - launch_device), the engine's
    ``step_bookkeeping`` around the launch (page growth, the deadline
    sweep, retirement, metrics: step - launch), its
    ``admission_bookkeeping`` (admission - prefill - take, where ``take``
    also waits for requests while no row is active) and ``loop_other``
    (wall - step - prefill - admission_bookkeeping: the waits for
    requests, expiry sweeps and thread hand-offs)."""
    eng = translator.serve(start=False, **engine_kw)
    eng.warmup()
    totals, calls, wrapped = {}, {}, []
    for label, owner, name in HOST_ACTIVITIES:
        obj = {"engine": eng, "runtime": eng.runtime, "batcher": eng.paged_batcher}[owner]
        fn = getattr(obj, name, None)
        if fn is None:
            continue
        totals[label], calls[label] = 0.0, 0

        def timed(*a, _fn=fn, _label=label, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                totals[_label] += time.perf_counter() - t0
                calls[_label] += 1

        setattr(obj, name, timed)
        wrapped.append((obj, name))
    try:
        with eng.start(warmup=False):
            wall = window(torch, eng, prompts)
    finally:
        for obj, name in wrapped:
            delattr(obj, name)
    n = max(calls["launch"], 1)
    t = dict(totals)
    t["fold"] = t["launch"] - t["launch_device"]
    t["step_bookkeeping"] = t["step"] - t["launch"]
    t["admission_bookkeeping"] = t["admission"] - t["prefill"] - t["take"]
    t["loop_other"] = wall - t["step"] - t["prefill"] - t["admission_bookkeeping"]
    order = ("stage", "replay", "read_back", "launch_device", "fold", "launch", "step_bookkeeping",
             "step", "prefill", "admission_bookkeeping", "loop_other")
    return dict(
        wall=wall, launches=calls["launch"], prefills=calls["prefill"],
        per_launch_ms={k: (t[k] * 1e3 / n if k in t else None) for k in order},
    )


def bound_ms(name: str, bytes_moved: float, flops: float) -> tuple[float, str]:
    base = name.removesuffix("_bf16")
    rate = FP32_FLOPS_PER_S
    if base in TENSOR_CORE_KERNELS:
        rate = BF16_FLOPS_PER_S if name.endswith("_bf16") else TF32X3_FLOPS_PER_S
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(torch, hop, dev, prompt_lens: list[int], dtype=None) -> dict:
    """Each serving kernel at the serving slice's sites: kernel, plain
    version, one library call, and the bound; kernel instantiation ->
    site -> times. ``dtype`` bf16 times the bf16 instantiations (bf16
    inputs, so half the bytes of q, k, v and out)."""
    import torch.nn.functional as F

    dtype = dtype or torch.float32
    rng = np.random.default_rng(SEED + 2)
    out = {}
    # Flash: the prefill encoder self-attention of one 64-token prompt
    # (the largest chunk width), 8 heads of 64, with its kv_valid. q, k, v
    # are head-split views of one fused qkv projection, as the model
    # passes them (stride 3*h*d between positions).
    b, h, s, d = 1, 8, 64, 64
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)).to(dev).to(dtype)
    q, k, v = (t.view(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    valid = torch.from_numpy(np.arange(s)[None, :] < 45).to(dev)
    mask = valid[:, None, None, :]
    n_valid = int(valid.sum().item())
    t_kernel = cuda_time_ms(torch, lambda: hop.flash_attention(q, k, v, kv_valid=valid))
    t_plain = cuda_time_ms(torch, lambda: hop.flash_attention_plain(q, k, v, kv_valid=valid))
    t_lib = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    dev_ms = {
        "kernel": device_ms_per_call(torch, lambda: hop.flash_attention(q, k, v, kv_valid=valid)),
        "plain": device_ms_per_call(torch, lambda: hop.flash_attention_plain(q, k, v, kv_valid=valid)),
        "library": device_ms_per_call(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)),
    }
    # q read and out written for every row; K and V only for the valid
    # keys (masked keys do not touch the output); kv_valid read once.
    nbytes = q.element_size() * b * h * d * (2 * s + 2 * n_valid) + b * s
    flops = 4.0 * b * h * s * n_valid * d  # QK^T and PV over the valid keys
    fwd = hop.kernel_name("flash_attention_fwd", dtype)
    bnd, by = bound_ms(fwd, nbytes, flops)
    out[fwd] = {"prefill": dict(
        ms=t_kernel, plain_ms=t_plain, library_ms=t_lib, bound_ms=bnd, bound_by=by,
        library_name="F.scaled_dot_product_attention, bool mask", nbytes=nbytes, flops=flops,
        device_ms=dev_ms, warps=hop.flash_fwd_launch_params(b, h, s, s, d, hop.device_sm_count(dev))[:2],
        warps_sweep={f"{w}x{c}": device_ms_per_call(
            torch, lambda w=w, c=c: hop.flash_attention_fwd(q, k, v, kv_valid=valid, warps=w, splits=c))
            for w, c in LAUNCH_CHOICES},
        shape=f"q,k,v [{b},{h},{s},{d}] {_dtype_name(q)} views of a fused qkv, kv_valid {n_valid}/{s}",
    )}
    out[hop.kernel_name("ragged_paged_attention", dtype)] = time_ragged(
        torch, hop, dev, ragged_sites(torch, rng, dev, prompt_lens, dtype))
    return out


def ragged_sites(torch, rng, dev, prompt_lens: list[int], dtype=None) -> dict:
    """The decode step's two ragged calls over a full batch (32 rows, 8
    heads of 64, pages of 16, 4 per row), each over fp32 and over int8
    pages: cross-attention over the memory store (lengths = the prompts'
    token counts; the int8 engine's quantised store) and self-attention
    over the decode carry with this step's own K/V as cur (lengths = the
    rows' decode cursors, 1-64; int8 as ``quantize_self=True`` stores it).
    q and cur are strided slices of fused projections, as the model passes
    them. Returns site -> (args, kwargs) of ``ragged_paged_attention``."""
    R, H, dh, page = SERVE["max_active"], 8, 64, SERVE["page_size"]
    P = SERVE["boundaries"][-1] // page
    D = H * dh
    store = "bf16" if dtype == torch.bfloat16 else "fp32"

    def to(x):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return t.to(dtype) if dtype is not None and t.dtype == torch.float32 else t

    def table_for(lens):
        table = np.zeros((R, P), np.int32)
        pid = 1
        for r in range(R):
            used = -(-int(lens[r]) // page)
            table[r, :used] = np.arange(pid, pid + used)
            pid += used
        return table

    num_pages = 1 + R * P
    f32 = [to(rng.standard_normal((num_pages, page, D)).astype(np.float32)) for _ in range(2)]
    i8 = [to(rng.integers(-127, 128, (num_pages, page, D)).astype(np.int8)) for _ in range(2)]
    scales = [to((rng.random((num_pages, page)) * 0.02 + 1e-3).astype(np.float32)).float() for _ in range(2)]
    qkv = to(rng.standard_normal((R, 3 * D)).astype(np.float32))
    q_self, cur_k, cur_v = qkv[:, :D].reshape(R, H, dh), qkv[:, D:2 * D], qkv[:, 2 * D:]
    q_cross = to(rng.standard_normal((R, H, dh)).astype(np.float32))
    cross_lens = np.asarray(prompt_lens[:R], np.int32)
    self_lens = rng.integers(1, P * page + 1, R).astype(np.int32)
    sites = {}
    for name, q, lens, cur in (("cross", q_cross, cross_lens, None), ("self + cur", q_self, self_lens, (cur_k, cur_v))):
        tbl, ln = to(table_for(lens)), to(lens)
        for kind, pages, sc in ((store, f32, (None, None)), ("int8", i8, scales)):
            kw = dict(k_scale=sc[0], v_scale=sc[1])
            if cur is not None:
                kw.update(cur_k=cur[0], cur_v=cur[1])
            sites[f"{name}, {kind} pages"] = ((q, pages[0], pages[1], tbl, ln), kw)
    return sites


def time_ragged(torch, hop, dev, sites: dict) -> dict:
    """The ragged kernel at each decode site: CUDA-event ms and profiler
    device time for the kernel, its plain version and gather + SDPA, its
    bound from the site's lengths, and the device time of each launch
    choice."""
    import torch.nn.functional as F

    out = {}
    for site, (args, kw) in sites.items():
        query, kp, vp, tbl, lens = args
        R, H, dh = query.shape
        P, page = tbl.shape[1], kp.shape[1]
        D = H * dh
        quant = kp.dtype == torch.int8
        tbl_long = tbl.long()
        key_mask = (torch.arange(P * page, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        cur = kw.get("cur_k") is not None
        if cur:
            key_mask = torch.cat([key_mask, torch.ones_like(key_mask[..., :1])], dim=-1)

        def library(kp=kp, vp=vp, kw=kw, tbl_long=tbl_long, key_mask=key_mask, query=query, cur=cur):
            kk, vv = kp[tbl_long], vp[tbl_long]
            if quant:
                kk = kk.float() * kw["k_scale"][tbl_long][..., None]
                vv = vv.float() * kw["v_scale"][tbl_long][..., None]
                kk, vv = kk.to(query.dtype), vv.to(query.dtype)
            kk = kk.reshape(R, P * page, H, dh).transpose(1, 2)
            vv = vv.reshape(R, P * page, H, dh).transpose(1, 2)
            if cur:
                kk = torch.cat([kk, kw["cur_k"].reshape(R, H, 1, dh)], dim=2)
                vv = torch.cat([vv, kw["cur_v"].reshape(R, H, 1, dh)], dim=2)
            return F.scaled_dot_product_attention(query[:, :, None, :], kk, vv, attn_mask=key_mask)

        def kernel(args=args, kw=kw):
            return hop.ragged_paged_attention(*args, **kw)

        def plain(args=args, kw=kw):
            return hop.ragged_paged_attention_plain(*args, **kw)

        lens_np = lens.cpu().numpy()
        n_pos = int(lens_np.sum())
        n_pages_read = int(sum(-(-int(x) // page) for x in lens_np))
        elem = kp.element_size()
        qe = query.element_size()
        nbytes = (qe * R * D * 2  # query read, out written
                  + 2 * elem * n_pos * D  # K and V of every cached position
                  + (2 * 4 * n_pos if quant else 0)  # their scales
                  + (2 * qe * R * D if cur else 0)  # cur_k, cur_v
                  + 4 * n_pages_read + 4 * R)  # table entries walked, lengths
        flops = 4.0 * (n_pos + (R if cur else 0)) * D
        bnd, by = bound_ms(hop.kernel_name("ragged_paged_attention", query.dtype), nbytes, flops)
        out[site] = dict(
            ms=cuda_time_ms(torch, kernel), plain_ms=cuda_time_ms(torch, plain),
            library_ms=cuda_time_ms(torch, library), library_name="gather + SDPA",
            bound_ms=bnd, bound_by=by, nbytes=nbytes, flops=flops,
            device_ms={
                "kernel": device_ms_per_call(torch, kernel),
                "plain": device_ms_per_call(torch, plain),
                "library": device_ms_per_call(torch, library),
            },
            warps=hop.ragged_launch_params(dh, P * page, quant, page_bytes=elem),
            warps_sweep={f"splits {sp}": device_ms_per_call(
                torch, lambda sp=sp: hop.ragged_paged_attention(*args, splits=sp, **kw))
                for sp in hop.RAGGED_SPLITS},
            shape=f"{R} rows x {H} heads x {dh}, {_dtype_name(query)} query, "
                  f"{'int8' if quant else _dtype_name(kp)} pages of {page}, "
                  f"{n_pos} cached positions{', + cur' if cur else ''}",
        )
    return out


# -- phase 5: training -----------------------------------------------------------


class _Lines(logging.Handler):
    """Keeps the messages of one logger."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def train_slice(torch, hop) -> dict:
    """The reference recipe on the card through ``train_translator``:
    one epoch with dropout, then ``evaluate`` and BLEU. Checks the loss
    and that the backward kernels ran 3 sites x steps x layers times."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        TranslationRecipe,
        train_translator,
    )

    lines = _Lines()
    logger = logging.getLogger("machine_learning_apache_spark_tpu_torch.train.loop")
    logger.addHandler(lines)
    try:
        hop.reset_launches()
        t0 = time.perf_counter()
        out = train_translator(_return_state=True, **TRAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(hop.LAUNCHES)
    finally:
        logger.removeHandler(lines)
    state = out["state"]
    steps, layers = state.step, TranslationRecipe().num_layers
    step_losses = [
        float(m.split("| loss: ")[1].split(" ")[0])
        for m in lines.messages if m.startswith("epoch 0 step ")
    ]
    log(f"  recipe: {TranslationRecipe().__dict__ | TRAIN}")
    log(f"  {steps} steps, {layers} layer(s); logged running-mean losses {step_losses}")
    log(f"  history {out['history']}; test_loss {out['test_loss']:.6f} over "
        f"{out['eval_samples']} pairs; BLEU {out['bleu']:.6f}; train_seconds "
        f"{out['train_seconds']:.3f}; recipe call {wall:.2f} s (eval and BLEU decode included)")
    log(f"  launches over the recipe call: {launches}")
    if len(step_losses) != steps or not all(np.isfinite(step_losses)):
        fail(f"training losses not all finite or not logged per step: {step_losses}")
    if not step_losses[-1] < step_losses[0]:
        fail(f"the loss did not fall: last logged {step_losses[-1]} vs first step {step_losses[0]}")
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if launches[name] != 3 * steps * layers:
            fail(f"{name} launched {launches[name]} times, not 3 x {steps} steps x {layers} layer(s)")
    if launches["flash_attention_fwd"] < 3 * steps * layers:
        fail("the flash forward did not run at every training site")
    if not (np.isfinite(out["test_loss"]) and 0.0 <= out["bleu"] <= 1.0):
        fail(f"eval gave test_loss {out['test_loss']} and BLEU {out['bleu']}")
    if out["eval_samples"] != 80:
        fail(f"eval scored {out['eval_samples']} of 80 validation pairs")
    return dict(out=out, state=state, launches=launches, steps=steps, layers=layers,
                step_losses=step_losses)


def step0_grads(model, batch, loss_fn):
    """One forward and backward: the gradients as (name, flat CPU tensor)."""
    loss, _ = loss_fn(model, batch, None)
    loss.backward()
    named = [(n, p.grad.detach().flatten().cpu()) for n, p in model.named_parameters()]
    model.zero_grad(set_to_none=True)
    return named


def parity_run(torch, hop, src_pipe, trg_pipe, train_ds, steps=PARITY_STEPS, rtol=PARITY_RTOL,
               grad_rtol=GRAD_RTOL, **overrides) -> dict:
    """Dropout 0, random weights in the Flax layout bridged in: the same
    ``steps`` Adam steps on the card (kernels) and on the CPU (plain
    versions), and the step-0 gradients of both; every step's loss within
    ``rtol``, the gradients within ``grad_rtol``. ``overrides`` change the
    model's config (the MoE run, the bf16 run)."""
    from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import make_train_step, to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params, random_flax_params

    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab), trg_vocab_size=len(trg_pipe.vocab),
        **{**MODEL, **overrides},
    )
    params = random_flax_params(cfg, SEED)
    batches = train_batches(train_ds, steps)
    loss_fn = make_translation_loss(cfg.pad_id)
    step = make_train_step(loss_fn)
    runs = {}
    for dev in ("cuda", "cpu"):
        device = torch.device(dev)
        model = load_flax_params(Transformer(cfg), params).to(device)
        named = step0_grads(model, to_device(batches[0], device), loss_fn)
        state = TrainState.create(model=model, tx=make_optimizer("adam", 1e-3))
        t0 = time.perf_counter()
        losses = [step(state, to_device(b, device), None)[1] for b in batches]
        losses = [x.item() for x in losses]
        runs[dev] = dict(losses=losses, named=named, seconds=time.perf_counter() - t0)
    card, cpu = np.array(runs["cuda"]["losses"]), np.array(runs["cpu"]["losses"])
    rel = np.abs(card - cpu) / np.abs(cpu)
    card_g = torch.cat([g for _, g in runs["cuda"]["named"]])
    cpu_g = torch.cat([g for _, g in runs["cpu"]["named"]])
    g_rel = ((card_g - cpu_g).abs().max() / cpu_g.abs().max()).item()
    log(f"  parity, {steps} Adam steps, dropout 0, random Flax-layout weights (seed {SEED})"
        + (f", {overrides}" if overrides else "") + ":")
    log(f"    card losses {card.tolist()}")
    log(f"    CPU  losses {cpu.tolist()} (plain versions, {runs['cpu']['seconds']:.1f} s)")
    log(f"    per-step relative difference {rel.tolist()} (gate <= {rtol:.3e})")
    log(f"    step-0 gradients: max |card - CPU| / max |CPU| = {g_rel:.3e} over all "
        f"parameters (gate <= {grad_rtol:.3e})")
    g_max = cpu_g.abs().max()
    worst = sorted(
        ((((a - b).abs().max() / g_max).item(), (b.abs().max() / g_max).item(), n)
         for (n, a), (_, b) in zip(runs["cuda"]["named"], runs["cpu"]["named"])),
        reverse=True,
    )[:4]
    log("    largest per parameter (|card - CPU| / max |CPU|, own max |CPU| / max |CPU|): "
        + "; ".join(f"{n} {e:.2e} ({m:.2e})" for e, m, n in worst))
    if not np.isfinite(card).all() or not (rel <= rtol).all():
        fail("card and CPU training losses disagree")
    if not g_rel <= grad_rtol:
        fail("card and CPU step-0 gradients disagree")
    return dict(card=card.tolist(), cpu=cpu.tolist(), rel=rel.tolist(), grad_rel=g_rel)


# -- phase 5: steps per program, checkpoint and resume -----------------------------

MULTI_K = (4, 5)  # 12 fixture steps an epoch: 3 groups; 2 groups and a tail of 2
MULTI_EPOCHS = 2
RESUME_K = 4
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def recipe_run(torch, hop, **kw) -> dict:
    """``train_translator`` on the fixture at the reference recipe's width
    (dropout 0.1), with the launch counts set to 0 just before and read
    just after."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    torch.cuda.synchronize()
    hop.reset_launches()
    t0 = time.perf_counter()
    out = train_translator(data_root=str(FIXTURES), log_every=0, _return_state=True, **kw)
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["launches"] = dict(hop.LAUNCHES)
    return out


def same_training(torch, a: dict, b: dict, b_losses=None) -> tuple[bool, int]:
    """Whether two runs' parameters are equal bit for bit, and how many
    step losses differ (``b_losses`` in place of ``b``'s own)."""
    params = all(torch.equal(x, y) for x, y in zip(a["state"].params, b["state"].params))
    want = b["fit_result"].step_losses if b_losses is None else b_losses
    got = a["fit_result"].step_losses
    return params, sum(x != y for x, y in zip(got, want)) + abs(len(got) - len(want))


def multistep_slice(torch, hop) -> dict:
    """The recipe's fixture epoch with dropout, twice, at 1 step per call
    and at each K of ``MULTI_K`` (one CUDA graph per group): parameters
    and every step's loss bit for bit against K = 1; one program per (K,
    accumulation phase), every group of the second epoch a replay; a
    replay's launches equal its eager first call's, 3 sites x K of each
    training kernel; the run's launches equal K = 1's."""
    runs = {k: recipe_run(torch, hop, epochs=MULTI_EPOCHS, steps_per_call=k) for k in (1, *MULTI_K)}
    base = runs[1]
    steps = base["state"].step
    layers = base["state"].model.cfg.num_layers
    log(f"  steps_per_call 1: {steps} steps over {MULTI_EPOCHS} epochs, {base['wall']:.2f} s "
        f"(evaluate included), launches {base['launches']}")
    for k in MULTI_K:
        run = runs[k]
        params_equal, loss_diffs = same_training(torch, run, base)
        programs = run["fit_result"].programs
        groups = steps // MULTI_EPOCHS // k * MULTI_EPOCHS
        log(f"  steps_per_call {k}: parameters equal to steps_per_call 1 bit for bit: {params_equal}; "
            f"step losses differing: {loss_diffs} of {steps}; {run['wall']:.2f} s; programs "
            + "; ".join(f"{p['signature'][0][0]} phase {p['signature'][-1]}: {p['calls']} calls, "
                        f"{p['replays']} replays, launches per replay {p['launches']}, eager first "
                        f"call {p['eager_launches']}" for p in programs))
        if not params_equal or loss_diffs:
            fail(f"steps_per_call={k} did not train bit for bit like steps_per_call=1")
        if len(programs) != 1:
            fail(f"steps_per_call={k} made {len(programs)} programs, not 1 per (K, phase)")
        p = programs[0]
        if p["calls"] != groups or p["replays"] != groups - 1:
            fail(f"steps_per_call={k}: {p['calls']} calls and {p['replays']} replays of its program, "
                 f"not {groups} and {groups - 1}: a later epoch captured anew")
        for name in TRAIN_KERNELS:
            if not p["launches"].get(name) == p["eager_launches"].get(name) == 3 * k * layers:
                fail(f"steps_per_call={k}: {name} launched {p['launches'].get(name)} times a replay, "
                     f"{p['eager_launches'].get(name)} in the eager first call, not 3 x {k} x {layers}")
        if run["launches"] != base["launches"]:
            fail(f"steps_per_call={k} launched {run['launches']}, steps_per_call=1 {base['launches']}")
    return dict(runs=runs, steps=steps)


def check_pointer(d: str, label: str) -> int:
    """The ``latest`` pointer names a complete step: its payload directory
    and its sidecar exist. Returns the step."""
    from machine_learning_apache_spark_tpu_torch.train import checkpoint as ck

    pointed = ck.pointed_step_of(d)
    durable = sorted(ck.durable_steps_of(d))
    sidecars = sorted(ck.sidecar_steps_of(d))
    log(f"  {label}: pointer -> {pointed}, complete steps {durable}, sidecars {sidecars}")
    if pointed is None or pointed not in durable or pointed not in sidecars:
        fail(f"{label}: the pointer names {pointed}, not a complete step")
    return pointed


def resume_slice(torch, hop) -> dict:
    """Two epochs at ``RESUME_K`` steps per call with ``checkpoint_dir``,
    then a second run over the directory (resume) for two more: equal bit
    for bit to four epochs in one run. Then the newest payload torn: the
    newest valid step is the one before it, and the pointer still names a
    complete step."""
    import os
    import tempfile

    from machine_learning_apache_spark_tpu_torch.train import checkpoint as ck

    whole = recipe_run(torch, hop, epochs=4, steps_per_call=RESUME_K)
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as d:
        first = recipe_run(torch, hop, epochs=2, steps_per_call=RESUME_K, checkpoint_dir=d)
        check_pointer(d, "after 2 epochs")
        second = recipe_run(torch, hop, epochs=2, steps_per_call=RESUME_K, checkpoint_dir=d)
        newest = check_pointer(d, "after the resumed run")
        params_equal, loss_diffs = same_training(
            torch, second, whole, whole["fit_result"].step_losses[len(first["fit_result"].step_losses):])
        log(f"  2 epochs + resume for 2 (steps_per_call {RESUME_K}): resumed_from_step "
            f"{second.get('resumed_from_step')}; parameters equal to 4 epochs in one run: {params_equal}; "
            f"step losses differing: {loss_diffs}; runs {first['wall']:.2f} + {second['wall']:.2f} s "
            f"vs {whole['wall']:.2f} s")
        if second.get("resumed_from_step") != first["state"].step:
            fail(f"the second run resumed from {second.get('resumed_from_step')}, not {first['state'].step}")
        if not params_equal or loss_diffs:
            fail("the resumed run did not train bit for bit like the uninterrupted one")
        with open(os.path.join(d, str(newest), ck.PAYLOAD), "r+b") as f:
            f.truncate(64)
        os.makedirs(os.path.join(d, f"{newest + 12}.tmp-0"))  # a writer killed mid-save
        restored = ck.CheckpointManager(d).restore_latest_valid(second["state"])
        step = None if restored is None else restored[1]
        pointed = check_pointer(d, "newest payload torn, a step half written")
        log(f"  restore_latest_valid with step {newest}'s payload torn: step {step}")
        if step != newest - 12 or pointed != newest:
            fail(f"a torn newest payload restored step {step}, not {newest - 12}")
    return dict(resumed_from=second.get("resumed_from_step"), fallback=step, whole=whole)


def translator_programs(torch, hop, translator, prompts, card) -> dict:
    """The one-shot ``Translator``: greedy and beam at 32 and 16 rows.
    The first call of a shape runs eagerly and captures; a second replays
    and captures nothing, and its ids equal an eager call of the decoder on
    the card bit for bit, with the same launches. Then each call's
    latency, eager and replayed (median of 5, tokenizing to ids on the
    host), and the device memory the programs hold. Then ``save`` and
    ``load`` on the card: token-identical greedy and beam outputs."""
    import statistics
    import tempfile

    from machine_learning_apache_spark_tpu_torch.data.text import EOS_ID, SOS_ID
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.models import beam_translate, greedy_translate_cached

    mnt, beam = SERVE["max_new_tokens"], SERVE_BEAM["beam_size"]
    dec = dict(max_new_tokens=mnt, sos_id=SOS_ID, eos_id=EOS_ID)
    programs = translator.programs()
    out = {}

    def eager_ids(texts, method):
        src = torch.as_tensor(translator.src_pipe(texts), dtype=torch.long, device=translator.device)
        if method == "greedy":
            return greedy_translate_cached(translator.model, src, **dec).cpu()
        return beam_translate(translator.model, src, beam_size=beam, length_penalty=0.6, **dec).cpu()

    def median_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    for method in ("greedy", "beam"):
        for rows in (32, 16):
            texts = prompts[:rows]
            kw = dict(method=method, max_new_tokens=mnt, beam_size=beam)
            size = programs.size()
            first, *held = held_memory(torch, lambda: translator.translate_ids(texts, **kw))
            if programs.size() != size + 1:
                fail(f"the first {method} call at {rows} rows made {programs.size() - size} programs, not 1")
            hop.reset_launches()
            replay = translator.translate_ids(texts, **kw)
            torch.cuda.synchronize()
            replay_n = dict(hop.LAUNCHES)
            hop.reset_launches()
            eager = eager_ids(texts, method)
            eager_n = dict(hop.LAUNCHES)
            if programs.size() != size + 1:
                fail(f"a second {method} call at {rows} rows captured again")
            if not (torch.equal(replay, eager) and torch.equal(first, eager)) or replay_n != eager_n:
                fail(f"the replayed {method} decode at {rows} rows differs from an eager call "
                     f"(launches {replay_n} vs {eager_n})")
            t = dict(eager_ms=median_ms(lambda: eager_ids(texts, method)),
                     graph_ms=median_ms(lambda: translator.translate_ids(texts, **kw)),
                     held_mib=held[0] / 2**20, reserved_mib=held[1] / 2**20, launches=replay_n)
            out[f"{method} {rows}"] = t
            log(f"  Translator {method} at {rows} rows ({mnt} new tokens{', beam ' + str(beam) if method == 'beam' else ''}): "
                f"replay ids == eager ids bit for bit, launches {replay_n}; latency eager "
                f"{t['eager_ms']:.3f} ms, graph {t['graph_ms']:.3f} ms (median of 5, ids on the host); "
                f"the program holds {t['held_mib']:.1f} MiB allocated, {t['reserved_mib']:.1f} MiB "
                f"reserved [{card}]")
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as d:
        translator.save(d)
        loaded = Translator.load(d)
        for method in ("greedy", "beam"):
            kw = dict(method=method, max_new_tokens=mnt, beam_size=beam)
            a, b = translator(prompts[:16], **kw), loaded(prompts[:16], **kw)
            if a != b:
                fail(f"Translator.save -> load changed the {method} outputs")
        log(f"  Translator.save -> Translator.load on the card: greedy and beam outputs token-identical "
            f"over 16 prompts; {len(loaded.src_pipe.vocab.itos)} / {len(loaded.trg_pipe.vocab.itos)} vocab")
    return out


# -- phase 6: training times -----------------------------------------------------


def held_memory(torch, fn):
    """``fn()`` (which captures programs) and the device memory it left
    held, in bytes: allocated, and reserved with the allocator's free
    cache emptied before and after — the programs' pools cannot be given
    back, so the reserved difference is what the graphs hold."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, torch.cuda.memory_allocated() - before[0], torch.cuda.memory_reserved() - before[1]


def profiled_call(torch, fn) -> dict:
    """``fn()`` once under the profiler: its wall seconds (synchronised,
    timed inside the profiler), device busy seconds (None when the
    profiler saw no device work) and result."""
    out = {}

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["result"] = fn()
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0

    out["rows"] = profile_device(torch, run)
    out["busy"] = sum(r[2] for r in out["rows"]) / 1e6 if out["rows"] else None
    return out


def time_bleu_decode(torch, hop, state, card) -> dict:
    """The recipe's BLEU decode of one epoch (the 80 validation pairs in
    batches of 32, 32 and 16) on the trained state, eager (the decoder
    called from Python) and through the recipe's programs (the first
    epoch runs eagerly and captures each batch shape, a later one
    replays): wall and device time per epoch. All three give the same
    ids, with the same forward launches."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import bleu_decode as recipe_bleu
    from machine_learning_apache_spark_tpu_torch.utils.graph_cache import ProgramCache

    val_loader, gen = eval_loader()
    model = state.model
    programs = ProgramCache(next(model.parameters()).device, eager_first_call=True)
    runs = {}
    for label, fn in (("eager", lambda: bleu_decode(model, val_loader, gen)),
                      ("graphs, first epoch (capturing)", lambda: recipe_bleu(model, val_loader, gen, programs)),
                      ("graphs, later epoch (replaying)", lambda: recipe_bleu(model, val_loader, gen, programs))):
        hop.reset_launches()
        run = profiled_call(torch, fn)
        run["launches"] = hop.LAUNCHES["flash_attention_fwd"]
        runs[label] = run
        busy = "not measured" if run["busy"] is None else f"{run['busy'] * 1e3:.3f} ms"
        log(f"  BLEU decode per epoch, {label}: wall {run['wall'] * 1e3:.3f} ms, device busy {busy}, "
            f"forward launches {run['launches']} [{card}]")
    ids = [r["result"][0] for r in runs.values()]
    if not ids[0] == ids[1] == ids[2]:
        fail("the graphed BLEU decode gave other ids than the eager one")
    launches = {r["launches"] for r in runs.values()}
    if len(launches) != 1:
        fail(f"the BLEU decode's forward launches differ between eager and graphed runs: {launches}")
    if programs.size() != 2:
        fail(f"the BLEU decode made {programs.size()} programs, not 2 (32 and 16 rows)")
    return {k: dict(wall=v["wall"], busy=v["busy"], launches=v["launches"]) for k, v in runs.items()}


def time_train_dispatch(torch, state, train_ds, card, label: str = "") -> dict:
    """The recipe's train step (dropout 0.1) on the trained state, over
    device-resident fixture batches, one step per call and ``RESUME_K``
    steps per call (a replayed CUDA graph), in one process and on one
    ``StepDispatch`` as ``fit`` runs them: ms per step from CUDA events
    over ``TIMED_STEPS`` steps, steps/s, non-pad target tokens/s, peak
    memory, the device idle share of one profiled window of 12 steps, and
    the memory the K-step program holds."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import StepDispatch, to_device

    dev = next(state.model.parameters()).device
    batches = [to_device(b, dev) for b in train_batches(train_ds, 12)]
    pad = state.model.cfg.pad_id
    tokens = [int((b[1][:, 1:] != pad).sum().item()) for b in batches]
    dispatch = StepDispatch(state, make_translation_loss(pad), torch.Generator(device=dev).manual_seed(SEED))
    out = {}
    for k in (1, RESUME_K):
        def run(n, offset=0, k=k):
            for i in range(0, n, k):
                group = [batches[(offset + i + j) % len(batches)] for j in range(k)]
                if k == 1:
                    dispatch.single(group[0])
                else:
                    dispatch.group(group)

        # k > 1: the first group runs eagerly and captures, the second replays.
        _, *held = held_memory(torch, lambda: run(2 * k))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(TIMED_STEPS, 3)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / TIMED_STEPS
        n_tok = sum(tokens[(3 + i) % len(batches)] for i in range(TIMED_STEPS)) / TIMED_STEPS
        window = profiled_call(torch, lambda: run(12, 100))
        t = dict(ms=ms, steps_per_s=1e3 / ms, tokens_per_s=n_tok * 1e3 / ms, tokens_per_step=n_tok,
                 peak=torch.cuda.max_memory_allocated(), peak_above=torch.cuda.max_memory_allocated() - base,
                 peak_reserved=torch.cuda.max_memory_reserved(), held=held[0], held_reserved=held[1],
                 wall=window["wall"], busy=window["busy"],
                 idle=None if window["busy"] is None else 1 - window["busy"] / window["wall"])
        out[k] = t
        idle = "not measured" if t["idle"] is None else f"{t['idle']:.4f}"
        log(f"  {label}train step, {k} step(s) per call (batch 32, [32, 200] src, [32, 199] decoder input, "
            f"dropout 0.1): {ms:.3f} ms/step (CUDA events over {TIMED_STEPS} steps), "
            f"{t['steps_per_s']:.2f} steps/s, {t['tokens_per_s']:.1f} non-pad target tokens/s "
            f"({n_tok:.1f} per step), peak max_memory_allocated {t['peak'] / 2**20:.1f} MiB "
            f"({t['peak_above'] / 2**20:.1f} above the state and everything else alive; a replay's "
            f"work is in its pool, which the allocator does not count), peak reserved "
            f"{t['peak_reserved'] / 2**20:.1f} MiB; "
            f"profiled window of 12 steps: wall {t['wall']:.4f} s, device idle share {idle}"
            + (f"; the {k}-step program holds {held[0] / 2**20:.1f} MiB allocated, "
               f"{held[1] / 2**20:.1f} MiB reserved" if k > 1 else "") + f" [{card}]")
        for name, calls, us in window["rows"][:12]:
            log(f"    {us / 1e3:10.3f} ms  {calls:6d} calls  {name[:90]}")
    if len(dispatch.programs.stats()) != 1:
        fail(f"the timed dispatch made {len(dispatch.programs.stats())} programs, not 1")
    return out


def _pairs(valid, sq: int, causal: bool) -> int:
    """(query, key) pairs the masks leave visible, summed over the batch:
    each valid key j is seen by every row under causality from j - (Sk -
    Sq) on, by all Sq rows otherwise."""
    b, sk = valid.shape
    if not causal:
        return int(sq * valid.sum())
    first_row = np.maximum(np.arange(sk) - (sk - sq), 0)
    seen_by = np.maximum(sq - first_row, 0)
    return int((valid * seen_by[None, :]).sum())


def time_training_kernels(torch, hop, sites: dict) -> dict:
    """Each training kernel at each site: CUDA-event ms and profiler device
    time for the kernel, its plain version and a library yardstick, and its
    bound from the site's inputs (K/V of valid keys only)."""
    import torch.nn.functional as F

    out = {}
    for site, c in sites.items():
        q, k, v, g = c["q"], c["k"], c["v"], c["g"]
        causal, valid = c["causal"], c["kv_valid"]
        kw = dict(causal=causal, kv_valid=valid)
        b, h, sq, d = q.shape
        sk = k.shape[2]
        mask = valid[:, None, None, :]
        if causal:
            mask = mask & torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        o, lse = hop.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        delta = (g.float() * o.float()).sum(-1)
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
        valid_np = valid.cpu().numpy()
        n_valid, pairs = int(valid_np.sum()), _pairs(valid_np, sq, causal)
        e = q.element_size()  # 4 fp32, 2 bf16: the bytes of q, k, v, dO and the outputs
        rows, kv = e * b * h * sq * d, e * h * d * n_valid  # one [B,H,Sq,d] tensor; K or V of valid keys
        stats = 4 * b * h * sq  # one [B,H,Sq] fp32 tensor (lse or delta)
        work = {
            "flash_attention_fwd": dict(
                kernel=lambda: hop.flash_attention_fwd(q, k, v, return_lse=True, **kw),
                plain=lambda: hop.flash_attention_lse_plain(q, k, v, **kw),
                library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                library_name="F.scaled_dot_product_attention, bool mask",
                nbytes=2 * rows + 2 * kv + stats + b * sk, flops=4.0 * d * h * pairs,
            ),
            "flash_attention_bwd_dq": dict(
                kernel=lambda: hop.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw),
                plain=lambda: hop.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
                library=lambda: torch.autograd.grad(lib_out, (lq,), g, retain_graph=True),
                library_name="SDPA backward, dQ only (autograd.grad, retained graph)",
                nbytes=3 * rows + 2 * kv + 2 * stats + b * sk, flops=6.0 * d * h * pairs,
            ),
            "flash_attention_bwd_dkv": dict(
                kernel=lambda: hop.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw),
                plain=lambda: hop.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, **kw),
                library=lambda: torch.autograd.grad(lib_out, (lk, lv), g, retain_graph=True),
                library_name="SDPA backward, dK and dV (autograd.grad, retained graph)",
                nbytes=2 * rows + 2 * kv + 2 * stats + b * sk + 2 * e * b * h * sk * d,
                flops=8.0 * d * h * pairs,
            ),
        }
        work = {hop.kernel_name(n, q.dtype): w for n, w in work.items()}
        sweep = {
            hop.kernel_name("flash_attention_fwd", q.dtype): (
                hop.flash_fwd_launch_params(b, h, sq, sk, d, hop.device_sm_count(q.device))[:2],
                {f"{w}x{c}": (lambda w=w, c=c: hop.flash_attention_fwd(
                    q, k, v, return_lse=True, warps=w, splits=c, **kw)) for w, c in LAUNCH_CHOICES},
            ),
            hop.kernel_name("flash_attention_bwd_dq", q.dtype): (
                hop.dq_launch_params(b, h, sq, sk, d, hop.device_sm_count(q.device))[:2],
                {f"{w}x{c}": (lambda w=w, c=c: hop.flash_attention_bwd_dq(
                    q, k, v, g, lse, delta, warps=w, splits=c, **kw)) for w, c in LAUNCH_CHOICES},
            ),
            hop.kernel_name("flash_attention_bwd_dkv", q.dtype): (
                hop.dkv_launch_params(b, h, sq, sk, d)[:2],
                {f"{w}x{c}": (lambda w=w, c=c: hop.flash_attention_bwd_dkv(
                    q, k, v, g, lse, delta, warps=w, splits=c, **kw)) for w, c in LAUNCH_CHOICES},
            ),
        }
        for name, w in work.items():
            bnd, by = bound_ms(name, w["nbytes"], w["flops"])
            r = dict(
                site=site,
                shape=f"q [{b},{h},{sq},{d}], k/v [{b},{h},{sk},{d}] {_dtype_name(q)} views of fused projections, "
                      f"{'causal + ' if causal else ''}kv_valid {n_valid}/{b * sk} keys, {pairs} visible pairs per head",
                ms=cuda_time_ms(torch, w["kernel"], n=50, warmup=5),
                plain_ms=cuda_time_ms(torch, w["plain"], n=20, warmup=3),
                library_ms=cuda_time_ms(torch, w["library"], n=50, warmup=5),
                library_name=w["library_name"],
                bound_ms=bnd, bound_by=by, nbytes=w["nbytes"], flops=w["flops"],
                device_ms={
                    "kernel": device_ms_per_call(torch, w["kernel"], n=20),
                    "plain": device_ms_per_call(torch, w["plain"], n=10),
                    "library": device_ms_per_call(torch, w["library"], n=20),
                },
            )
            if name in sweep:
                r["warps"], calls = sweep[name]
                r["warps_sweep"] = {n: device_ms_per_call(torch, fn, n=20) for n, fn in calls.items()}
            out.setdefault(name, {})[site] = r
    return out


def _dtype_name(t) -> str:
    return "bf16" if t.element_size() == 2 else "fp32"


def _fwd_work(q_shape, sk: int, causal: bool, valid_np, elem: int = 4) -> tuple[int, float]:
    """Bytes and operations of one forward launch (no ``lse``): q read and
    out written, K and V of the valid keys (``elem`` bytes each), kv_valid;
    QKᵀ and P·V over the visible pairs."""
    b, h, sq, d = q_shape
    n_valid = int(valid_np.sum()) if valid_np is not None else b * sk
    pairs = _pairs(valid_np if valid_np is not None else np.ones((b, sk), bool), sq, causal)
    nbytes = 2 * elem * b * h * sq * d + 2 * elem * h * d * n_valid + (b * sk if valid_np is not None else 0)
    return nbytes, 4.0 * d * h * pairs


def _fwd_bound(q_shape, sk: int, causal: bool, valid_np) -> tuple[float, str]:
    return bound_ms("flash_attention_fwd", *_fwd_work(q_shape, sk, causal, valid_np))


#: The one-query-row sites timed in phase 6 (all are checked in phase 3).
TIMED_DECODE_SITES = (
    "BLEU self, step 0", "BLEU self, step 99", "BLEU self, step 198",
    "BLEU self, step 99, pads in the prefix", "BLEU cross", "BLEU priming self",
    "beam self, step 40", "beam cross",
)


def time_decode_forward(torch, hop, sites: dict) -> dict:
    """The forward without ``lse`` at the KV-cache decoders' one-query-row
    sites: CUDA-event ms and profiler device time for the kernel, its
    plain version and SDPA with a bool mask, the bound from the site's
    inputs, and the device time at each launch choice."""
    import torch.nn.functional as F

    out = {}
    for label in TIMED_DECODE_SITES:
        c = sites[label]
        q, k, v, valid = c["q"], c["k"], c["v"], c["kv_valid"]
        b, h, sq, d = q.shape
        sk = k.shape[2]
        mask = None if valid is None else valid[:, None, None, :]
        valid_np = None if valid is None else valid.cpu().numpy()
        nbytes, flops = _fwd_work(tuple(q.shape), sk, False, valid_np, q.element_size())
        bnd, by = bound_ms(hop.kernel_name("flash_attention_fwd", q.dtype), nbytes, flops)
        work = dict(
            kernel=lambda: hop.flash_attention_fwd(q, k, v, kv_valid=valid),
            plain=lambda: hop.flash_attention_plain(q, k, v, kv_valid=valid),
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        )
        out[label] = dict(
            shape=f"q [{b},{h},{sq},{d}], k/v [{b},{h},{sk},{d}] {_dtype_name(q)} views of the step's qkv "
                  f"and the cache, kv_valid {'none' if valid_np is None else int(valid_np.sum())} keys",
            ms=cuda_time_ms(torch, work["kernel"], n=100, warmup=10),
            plain_ms=cuda_time_ms(torch, work["plain"], n=50, warmup=5),
            library_ms=cuda_time_ms(torch, work["library"], n=100, warmup=10),
            library_name="F.scaled_dot_product_attention, bool mask",
            bound_ms=bnd, bound_by=by, nbytes=nbytes, flops=flops,
            device_ms={name: device_ms_per_call(torch, fn) for name, fn in work.items()},
            warps=hop.flash_fwd_launch_params(b, h, sq, sk, d, hop.device_sm_count(q.device))[:2],
            warps_sweep={f"{w}x{c_}": device_ms_per_call(
                torch, lambda w=w, c_=c_: hop.flash_attention_fwd(q, k, v, kv_valid=valid, warps=w, splits=c_))
                for w, c_ in LAUNCH_CHOICES},
        )
    return out


def eval_loader():
    """The recipe's validation loader (the 80 fixture pairs in batches of
    32, 32 and 16) and its BLEU decode's length, as ``train_translator``
    builds them."""
    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
    from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
    from machine_learning_apache_spark_tpu_torch.recipes._common import make_loaders
    from machine_learning_apache_spark_tpu_torch.recipes.translation import TranslationRecipe

    r = TranslationRecipe()
    src_pipe, trg_pipe, _ = fixture_data()
    val_pairs = load_multi30k(str(FIXTURES), "valid")
    val_ds = ArrayDataset(src_pipe([s for s, _ in val_pairs]), trg_pipe([t for _, t in val_pairs]))
    _, val_loader = make_loaders(None, val_ds, batch_size=r.batch_size, seed=r.seed)
    return val_loader, min(val_ds[:1][1].shape[1], r.max_len) - 1


def bleu_decode(model, val_loader, gen: int) -> tuple[list[list[int]], float]:
    """The recipe's BLEU decode on the model's device:
    ``greedy_translate_cached`` over the eval loader's batches. Returns
    the candidates' ids (specials stripped) and the corpus BLEU."""
    from machine_learning_apache_spark_tpu_torch.data.text import EOS_ID, SOS_ID
    from machine_learning_apache_spark_tpu_torch.models import greedy_translate_cached
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device
    from machine_learning_apache_spark_tpu_torch.train.metrics import corpus_bleu, strip_special_ids

    dev = next(model.parameters()).device
    kw = dict(pad_id=model.cfg.pad_id, sos_id=SOS_ID, eos_id=EOS_ID)
    cands, refs = [], []
    for src_b, trg_b in val_loader:
        (src,) = to_device((src_b,), dev)
        ids = greedy_translate_cached(model, src, max_new_tokens=gen, sos_id=SOS_ID, eos_id=EOS_ID)
        cands.extend(strip_special_ids(ids, **kw))
        refs.extend(strip_special_ids(trg_b, **kw))
    return cands, corpus_bleu(cands, refs)


def eval_decode_parity(torch, trained: dict) -> dict:
    """The recipe's BLEU decode of the trained model once more on the card
    and on the CPU (a copy of the model, plain versions): the token
    agreement of the two and both BLEU figures."""
    import copy

    val_loader, gen = eval_loader()
    model = trained["state"].model
    t0 = time.perf_counter()
    card_ids, card_bleu = bleu_decode(model, val_loader, gen)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_ids, cpu_bleu = bleu_decode(copy.deepcopy(model).cpu(), val_loader, gen)
    cpu_s = time.perf_counter() - t0
    share, notes = agreement([" ".join(map(str, r)) for r in card_ids],
                             [" ".join(map(str, r)) for r in cpu_ids])
    log(f"  eval/BLEU decode (greedy_translate_cached, {len(card_ids)} pairs, {gen} steps): "
        f"card vs CPU token agreement {share:.6f} (gate >= {AGREEMENT_MIN}); BLEU card "
        f"{card_bleu:.6f}, CPU {cpu_bleu:.6f}, recipe run {trained['out']['bleu']:.6f}; "
        f"{card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU")
    for n in notes:
        log(f"    mismatch: {n}")
    if share < AGREEMENT_MIN:
        fail(f"the eval decode agrees card vs CPU at {share:.4f} < {AGREEMENT_MIN}")
    return dict(agreement=share, bleu_card=card_bleu, bleu_cpu=cpu_bleu)


def profile_eval_decode(torch, hop, state) -> dict:
    """``train_translator``'s evaluate and BLEU decode once more, on the
    trained state and with the recipe's own loader and calls (the test-loss
    pass, then ``greedy_translate_cached`` per batch), under the profiler.
    Returns the flash forward's launches and device time summed over the
    whole call (the profiler's ``flash_fwd_kernel`` rows), and its bound
    summed over the launches, each from its own inputs (a shim around the
    wrapper records every launch's shapes and valid keys)."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import evaluate

    val_loader, gen = eval_loader()
    result = {}

    def run():
        evaluate(state, make_translation_loss(state.model.cfg.pad_id, train=False), val_loader,
                 emit=lambda _: None)
        result["bleu"] = bleu_decode(state.model, val_loader, gen)[1]

    launches = []
    real = hop.flash_attention_fwd

    def recording(query, key, value, **kw):
        valid = kw.get("kv_valid")
        launches.append((tuple(query.shape), key.shape[2], bool(kw.get("causal")),
                         None if valid is None else valid.clone()))
        return real(query, key, value, **kw)

    before = hop.LAUNCHES["flash_attention_fwd"]
    hop.flash_attention_fwd = recording
    try:
        rows = profile_device(torch, run)
    finally:
        hop.flash_attention_fwd = real
    counted = hop.LAUNCHES["flash_attention_fwd"] - before
    fwd_rows = [row for row in rows if "flash_fwd_kernel" in row[0]]
    bounds = [_fwd_bound(shape, sk, causal, None if valid is None else valid.cpu().numpy())[0]
              for shape, sk, causal, valid in launches]
    return dict(
        launches=counted, recorded=len(launches),
        profiled_launches=sum(row[1] for row in fwd_rows) if fwd_rows else None,
        device_ms=sum(row[2] for row in fwd_rows) / 1e3 if fwd_rows else None,
        bound_ms=float(sum(bounds)), bleu=result["bleu"],
    )


def log_site_times(name: str, site: str, t: dict, card: str) -> None:
    dm = {k: ("not measured" if v is None else f"{v * 1e3:.2f} us") for k, v in t["device_ms"].items()}
    log(f"  {name} @ {site}: {t['shape']}")
    log(f"    kernel {t['ms']:.5f} ms (device {dm['kernel']}), bound {t['bound_ms']:.5f} ms "
        f"({t['bound_by']}: {t['nbytes']} B, {t['flops']:.4g} flop), plain {t['plain_ms']:.5f} ms "
        f"(device {dm['plain']}), library {t['library_ms']:.5f} ms (device {dm['library']}; "
        f"{t['library_name']}) [{card}]")
    if "warps_sweep" in t:
        log(f"    launch: {t['warps']} chosen; device us per call at each: "
            + ", ".join(f"{w}: {'not measured' if x is None else f'{x * 1e3:.2f}'}"
                        for w, x in t["warps_sweep"].items()))


# -- phase 6: the model zoo (MLP, TinyVGG, LSTM, MLlib L-BFGS) ---------------------

SAMPLE_LIBSVM = Path(__file__).resolve().parent / "assets" / "sample_multiclass_classification_data.txt"
# The zoo's recipes at the reference widths on the committed fixtures:
# (recipe module, its train function, the recipe's fields).
ZOO = {
    "mlp": ("mlp", "train_mlp", dict(data_path=str(SAMPLE_LIBSVM), layers=(4, 5, 4, 3),
                                     learning_rate=0.03, batch_size=30)),
    "cnn cifar10": ("cnn", "train_cnn", dict(data_root=str(FIXTURES), dataset="cifar10",
                                             hidden_units=10, learning_rate=0.01, batch_size=32)),
    "cnn fashion_mnist": ("cnn", "train_cnn", dict(data_root=str(FIXTURES), dataset="fashion_mnist",
                                                   hidden_units=10, learning_rate=0.01, batch_size=32)),
    "lstm last": ("lstm", "train_lstm", dict(data_root=str(FIXTURES), embed_dim=32, hidden_size=32,
                                             num_layers=2, dropout=0.5, max_seq_len=128,
                                             learning_rate=1e-3, batch_size=32, classify_from="last")),
    "lstm last_valid": ("lstm", "train_lstm", dict(data_root=str(FIXTURES), embed_dim=32, hidden_size=32,
                                                   num_layers=2, dropout=0.5, max_seq_len=128,
                                                   learning_rate=1e-3, batch_size=32,
                                                   classify_from="last_valid")),
}
# Epochs of the card-vs-CPU runs: the MLP's reference 100 (3 steps each),
# one for the others.
ZOO_PARITY_EPOCHS = {"mlp": 100}
ZOO_K = 4
ZOO_WINDOW = 8  # steps in each profiled window (an eager LSTM step is ~9,000 launches)
LBFGS_RTOL = 1e-4  # card vs CPU, the first 10 L-BFGS iterations


def zoo_run(torch, hop, name: str, device=None, **kw) -> dict:
    """One zoo recipe through its entry point, with the launch counts set
    to 0 just before and read just after, and its wall time."""
    import importlib

    module, fn, fields = ZOO[name]
    train = getattr(importlib.import_module(f"machine_learning_apache_spark_tpu_torch.recipes.{module}"), fn)
    if device is None:
        torch.cuda.synchronize()
    hop.reset_launches()
    t0 = time.perf_counter()
    out = train(device=device, _return_state=True, **{**fields, **kw})
    if device is None:
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["launches"] = dict(hop.LAUNCHES)
    return out


def zoo_batches(name: str, n: int) -> tuple:
    """The recipe's first ``n`` training batches (its loader, its seed) and
    its training loss: what the step-0 gradients and the timings take."""
    from machine_learning_apache_spark_tpu_torch.data import datasets
    from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
    from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
    from machine_learning_apache_spark_tpu_torch.data.text import PAD_ID, classification_pipeline
    from machine_learning_apache_spark_tpu_torch.recipes import cnn, lstm, mlp
    from machine_learning_apache_spark_tpu_torch.recipes._common import make_loaders
    from machine_learning_apache_spark_tpu_torch.train.loop import classification_loss

    fields = ZOO[name][2]
    if name == "mlp":
        r = mlp.MLPRecipe(**fields)
        train, _ = read_libsvm(r.data_path).random_split([r.train_fraction, 1 - r.train_fraction], seed=r.seed)
        ds, loss = ArrayDataset(*train.arrays()), classification_loss()
    elif name.startswith("cnn"):
        r = cnn.CNNRecipe(**fields)
        load = datasets.load_cifar10 if r.dataset == "cifar10" else datasets.load_fashion_mnist
        ds, loss = ArrayDataset(*load(r.data_root, train=True).arrays()), classification_loss()
    else:
        r = lstm.LSTMRecipe(**fields)
        texts, labels = datasets.load_ag_news(r.data_root, train=True)
        pipe = classification_pipeline(texts, max_seq_len=r.max_seq_len, fixed_len=r.max_seq_len + 1)
        ds = ArrayDataset(pipe(texts), labels)
        pad = PAD_ID if r.classify_from == "last_valid" else None
        loss = classification_loss(last_timestep=True, pad_id=pad)
    loader, _ = make_loaders(ds, None, batch_size=r.batch_size, seed=r.seed)
    batches = []
    for b in loader:
        batches.append(b)
        if len(batches) == n:
            break
    return batches, loss


def zoo_parity(torch, hop, name: str) -> dict:
    """Dropout 0, the recipe's seeded weights on both: its epochs on the
    card and on the CPU, per-epoch losses within ``PARITY_RTOL`` relative;
    the step-0 gradients of the recipe's first batch within
    ``GRAD_RTOL`` of the largest, the four largest per-parameter
    differences printed."""
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    kw = dict(epochs=ZOO_PARITY_EPOCHS.get(name, 1))
    if name.startswith("lstm"):
        kw["dropout"] = 0.0
    runs = {dev: zoo_run(torch, hop, name, device=dev, **kw) for dev in (None, "cpu")}
    card = np.array([h["loss"] for h in runs[None]["history"]])
    cpu = np.array([h["loss"] for h in runs["cpu"]["history"]])
    rel = np.abs(card - cpu) / np.abs(cpu)
    steps_card = np.array(runs[None]["fit_result"].step_losses)
    steps_cpu = np.array(runs["cpu"]["fit_result"].step_losses)
    step_rel = np.abs(steps_card - steps_cpu) / np.abs(steps_cpu)

    batches, loss_fn = zoo_batches(name, 1)
    fresh = {dev: zoo_run(torch, hop, name, device=dev, epochs=0, **{k: v for k, v in kw.items() if k != "epochs"})
             for dev in (None, "cpu")}
    named = {}
    for dev, out in fresh.items():
        model = out["state"].model
        device = next(model.parameters()).device
        named[dev] = step0_grads(model, to_device(batches[0], device), loss_fn)
    card_g = torch.cat([g for _, g in named[None]])
    cpu_g = torch.cat([g for _, g in named["cpu"]])
    g_max = cpu_g.abs().max()
    g_rel = ((card_g - cpu_g).abs().max() / g_max).item()
    worst = sorted(
        ((((a - b).abs().max() / g_max).item(), (b.abs().max() / g_max).item(), n)
         for (n, a), (_, b) in zip(named[None], named["cpu"])),
        reverse=True,
    )[:4]
    log(f"  {name}: card vs CPU, dropout 0, {len(card)} epoch(s) of {len(steps_card) // len(card)} steps: "
        f"epoch losses card {card[-3:].tolist()} CPU {cpu[-3:].tolist()} (last up to 3), max relative "
        f"difference {rel.max():.3e} (gate <= {PARITY_RTOL:.0e}); step losses max relative "
        f"{step_rel.max():.3e}; step-0 gradients max |card - CPU| / max |CPU| {g_rel:.3e} "
        f"(gate <= {GRAD_RTOL:.0e}); largest per parameter: "
        + "; ".join(f"{n} {e:.2e} ({m:.2e})" for e, m, n in worst))
    if not np.isfinite(card).all() or not (rel <= PARITY_RTOL).all():
        fail(f"{name}: card and CPU epoch losses disagree")
    if not g_rel <= GRAD_RTOL:
        fail(f"{name}: card and CPU step-0 gradients disagree")
    return dict(epoch_rel=float(rel.max()), step_rel=float(step_rel.max()), grad_rel=g_rel)


def zoo_multistep(torch, hop, name: str, runs: dict) -> None:
    """``runs[1]`` and ``runs[ZOO_K]`` (the recipe's epoch with dropout):
    parameters and every step's loss bit for bit, one program."""
    base, run = runs[1], runs[ZOO_K]
    params_equal, loss_diffs = same_training(torch, run, base)
    programs = run["fit_result"].programs
    log(f"  {name}: steps_per_call {ZOO_K} vs 1 over {base['state'].step} steps: parameters equal bit for "
        f"bit: {params_equal}; step losses differing: {loss_diffs}; programs "
        + "; ".join(f"{p['calls']} calls, {p['replays']} replays" for p in programs))
    if not params_equal or loss_diffs:
        fail(f"{name}: steps_per_call={ZOO_K} did not train bit for bit like steps_per_call=1")
    if len(programs) != 1:
        fail(f"{name}: steps_per_call={ZOO_K} made {len(programs)} programs, not 1 per (K, phase)")


def zoo_resume(torch, hop, name: str, whole: dict) -> dict:
    """1 epoch with ``checkpoint_dir``, then a resumed run of 1 more, at
    ``ZOO_K`` steps per call: equal bit for bit to ``whole`` (2 epochs in
    one run)."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as d:
        first = zoo_run(torch, hop, name, epochs=1, steps_per_call=ZOO_K, checkpoint_dir=d)
        second = zoo_run(torch, hop, name, epochs=1, steps_per_call=ZOO_K, checkpoint_dir=d)
        check_pointer(d, f"{name} after the resumed run")
    params_equal, loss_diffs = same_training(
        torch, second, whole, whole["fit_result"].step_losses[len(first["fit_result"].step_losses):])
    log(f"  {name}: 1 epoch + resume for 1 (steps_per_call {ZOO_K}): resumed_from_step "
        f"{second.get('resumed_from_step')}; parameters equal to 2 epochs in one run: {params_equal}; "
        f"step losses differing: {loss_diffs}")
    if second.get("resumed_from_step") != first["state"].step:
        fail(f"{name}: resumed from {second.get('resumed_from_step')}, not {first['state'].step}")
    if not params_equal or loss_diffs:
        fail(f"{name}: the resumed run did not train bit for bit like the uninterrupted one")
    return dict(resumed_from=second.get("resumed_from_step"))


def zoo_classifier(torch, out: dict, inputs, label: str) -> None:
    """``Classifier.save`` -> ``load`` on the card: the same predictions."""
    import tempfile

    from machine_learning_apache_spark_tpu_torch.inference import Classifier

    clf = out["classifier"]
    want = clf.predict(inputs)
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as d:
        clf.save(d)
        loaded = Classifier.load(d)
        got = loaded.predict(inputs)
    log(f"  {label}: Classifier.save -> load on the card: {len(inputs)} predictions identical "
        f"{torch.equal(got, want)} ({loaded.model.__class__.__name__} on {loaded.device})")
    if not torch.equal(got, want):
        fail(f"{label}: the loaded Classifier predicts otherwise")


def zoo_mllib(torch, card: str) -> dict:
    """``MultilayerPerceptronClassifier(layers=[4, 5, 4, 3], maxIter=100,
    seed=1234).fit`` on the sample's 60 % split, on the card and on the
    CPU from the same seeded weights: the first 10 L-BFGS iterations'
    losses within ``LBFGS_RTOL``, the test accuracy equal; then
    ``transform`` and the evaluator (accuracy, macro F1). Fit wall,
    iterations and the final loss printed."""
    from machine_learning_apache_spark_tpu_torch.data.reader import DataReader
    from machine_learning_apache_spark_tpu_torch.mllib import (
        MulticlassClassificationEvaluator,
        MultilayerPerceptronClassifier,
    )

    frame = DataReader().format("libsvm").load(str(SAMPLE_LIBSVM))
    train, test = frame.randomSplit([0.6, 0.4], seed=1234)
    fits, scores = {}, {}
    for dev in (None, "cpu"):
        est = MultilayerPerceptronClassifier(layers=[4, 5, 4, 3], blockSize=30, seed=1234, maxIter=100)
        model = est.fit(train, device=dev)
        pred = model.transform(test)
        fits[dev] = model
        scores[dev] = {m: MulticlassClassificationEvaluator(m).evaluate(pred) for m in ("accuracy", "f1")}
    h_card, h_cpu = fits[None].loss_history, fits["cpu"].loss_history
    rel = np.abs(h_card[:10] - h_cpu[:10]) / np.abs(h_cpu[:10])
    for dev, label in ((None, "card"), ("cpu", "CPU")):
        m = fits[dev]
        log(f"  MLlib L-BFGS on the {label}: fit wall {m.fit_seconds:.4f} s, {m.iterations} iterations "
            f"updated the weights (of maxIter 100), final loss {float(m.loss_history[-1]):.6e}, "
            f"test accuracy {scores[dev]['accuracy']:.4f}, macro F1 {scores[dev]['f1']:.4f}"
            + (f" [{card}]" if dev is None else ""))
    log(f"  MLlib L-BFGS card vs CPU: first 10 losses max relative difference {rel.max():.3e} "
        f"(gate <= {LBFGS_RTOL:.0e}); test accuracy {scores[None]['accuracy']} vs {scores['cpu']['accuracy']}")
    if not (rel <= LBFGS_RTOL).all():
        fail("MLlib L-BFGS: card and CPU losses disagree over the first 10 iterations")
    if scores[None]["accuracy"] != scores["cpu"]["accuracy"]:
        fail("MLlib L-BFGS: card and CPU test accuracies differ")
    if not np.isfinite(h_card).all() or not h_card[-1] < h_card[0]:
        fail("MLlib L-BFGS: the loss did not fall")
    return dict(fit_seconds=fits[None].fit_seconds, iterations=fits[None].iterations,
                final_loss=float(h_card[-1]), lbfgs_rel=float(rel.max()), **scores[None])


def time_zoo_dispatch(torch, name: str, state, card: str, label: str = "") -> dict:
    """The recipe's train step on its trained state, over its first
    training batches held on the card, at 1 and ``ZOO_K`` steps per call
    (one ``StepDispatch``, as ``fit`` runs them): ms per step from CUDA
    events, samples/s, device ms per step and the idle share of one
    profiled window of ``ZOO_WINDOW`` steps, peak memory above the state
    (for the LSTM also non-pad tokens/s)."""
    from machine_learning_apache_spark_tpu_torch.train.loop import StepDispatch, to_device

    dev = next(state.model.parameters()).device
    host, loss_fn = zoo_batches(name, 8)
    batches = [to_device(b, dev) for b in host]
    rows = batches[0][0].shape[0]
    tokens = [int((b[0] != 0).sum().item()) for b in batches] if name.startswith("lstm") else None
    dispatch = StepDispatch(state, loss_fn, torch.Generator(device=dev).manual_seed(SEED))
    out = {}
    for k in (1, ZOO_K):
        def run(n, offset=0, k=k):
            for i in range(0, n, k):
                group = [batches[(offset + i + j) % len(batches)] for j in range(k)]
                if k == 1:
                    dispatch.single(group[0])
                else:
                    dispatch.group(group)

        run(2 * k)  # k > 1: the first group captures, the second replays
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(TIMED_STEPS, 3)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / TIMED_STEPS
        window = profiled_call(torch, lambda: run(ZOO_WINDOW, 5))
        t = dict(ms=ms, samples_per_s=rows * 1e3 / ms, peak_above=torch.cuda.max_memory_allocated() - base,
                 device_ms=None if window["busy"] is None else window["busy"] * 1e3 / ZOO_WINDOW,
                 idle=None if window["busy"] is None else 1 - window["busy"] / window["wall"])
        if tokens is not None:
            n_tok = sum(tokens[(3 + i) % len(batches)] for i in range(TIMED_STEPS)) / TIMED_STEPS
            t["tokens_per_s"] = n_tok * 1e3 / ms
        out[k] = t
        dms = "not measured" if t["device_ms"] is None else f"{t['device_ms']:.4f} ms"
        idle = "not measured" if t["idle"] is None else f"{t['idle']:.4f}"
        log(f"  {name}{label} train step, {k} step(s) per call (batch {rows}): {ms:.4f} ms/step "
            f"(CUDA events over {TIMED_STEPS} steps), {t['samples_per_s']:.1f} samples/s"
            + (f", {t['tokens_per_s']:.1f} non-pad tokens/s" if tokens is not None else "")
            + f", device {dms}/step, device idle share {idle} (profiled window of {ZOO_WINDOW} steps), "
            f"peak above the state {t['peak_above'] / 2**20:.2f} MiB [{card}]")
        if k == ZOO_K:
            for row_name, calls, us in window["rows"][:6]:
                log(f"    {us / 1e3:10.3f} ms  {calls:6d} calls  {row_name[:90]}")
    return out


def time_lstm_recurrence(torch, card: str) -> dict:
    """One LSTM layer at the recipe's width ([32, 129, 32] in, hidden 32),
    forward + backward: the port's recurrence (eager, and replayed as one
    CUDA graph) against one single-layer ``torch.nn.LSTM`` (cuDNN) over
    the same weights (``weight_ih = w_xᵀ``, ``weight_hh = w_hᵀ``,
    ``bias_ih = bias``, ``bias_hh = 0``). Outputs must agree within
    ``TOL``."""
    from machine_learning_apache_spark_tpu_torch.models.lstm import LSTMLayer
    from machine_learning_apache_spark_tpu_torch.utils.graph_cache import ProgramCache

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    layer = LSTMLayer(32, 32)
    layer.reset_parameters(gen)
    layer.to(dev)
    ref = torch.nn.LSTM(32, 32, batch_first=True).to(dev)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(layer.w_x.T)
        ref.weight_hh_l0.copy_(layer.w_h.T)
        ref.bias_ih_l0.copy_(layer.bias)
        ref.bias_hh_l0.zero_()
    x = torch.randn(32, 129, 32, generator=gen).to(dev)
    probe = torch.randn(32, 129, 32, generator=gen).to(dev)
    with torch.no_grad():  # no autograd graph outlives this check (a capture follows)
        err = (layer(x)[0] - ref(x)[0]).abs().max().item()

    # Each call makes its own input leaf: a leaf made outside a capture
    # would tie the captured backward to the default stream.
    def port():
        xx = x.detach().requires_grad_(True)
        y, _ = layer(xx)
        return torch.autograd.grad((y * probe).sum(), (xx, layer.w_x, layer.w_h, layer.bias))

    def cudnn():
        xx = x.detach().requires_grad_(True)
        y, _ = ref(xx)
        return torch.autograd.grad((y * probe).sum(), (xx, *ref.parameters()))

    programs = ProgramCache(dev)
    graphed = lambda: programs("lstm_layer", port)  # noqa: E731
    out = {}
    for label, fn in (("port recurrence, eager", port), ("port recurrence, one CUDA graph", graphed),
                      ("torch.nn.LSTM (cuDNN)", cudnn)):
        out[label] = dict(ms=cuda_time_ms(torch, fn, n=20, warmup=3), device_ms=device_ms_per_call(torch, fn, n=5))
    log(f"  one LSTM layer [32, 129, 32] -> hidden 32, forward + backward; port vs nn.LSTM outputs "
        f"max |diff| {err:.2e} (gate <= {TOL:.0e}): "
        + "; ".join(f"{k} {v['ms']:.4f} ms (device "
                    + ("not measured" if v["device_ms"] is None else f"{v['device_ms']:.4f} ms") + ")"
                    for k, v in out.items()) + f" [{card}]")
    if not err <= TOL:
        fail(f"the port's LSTM layer and nn.LSTM disagree by {err:.2e}")
    return out


def time_cnn_determinism(torch, state, card: str) -> dict:
    """The CNN train step (CIFAR-10 batch, 1 step per call) with cuDNN's
    deterministic algorithms (the card path's setting) and without:
    device ms per step, for what bit-for-bit training costs."""
    from machine_learning_apache_spark_tpu_torch.train.loop import StepDispatch, to_device

    dev = next(state.model.parameters()).device
    host, loss_fn = zoo_batches("cnn cifar10", 1)
    batch = to_device(host[0], dev)
    dispatch = StepDispatch(state, loss_fn, torch.Generator(device=dev).manual_seed(SEED))
    out = {}
    try:
        for det in (True, False, True):
            torch.backends.cudnn.deterministic = det
            step = lambda: dispatch.single(batch)  # noqa: E731
            out.setdefault(det, []).append(
                dict(ms=cuda_time_ms(torch, step, n=50), device_ms=device_ms_per_call(torch, step, n=20)))
    finally:
        torch.backends.cudnn.deterministic = True
    log("  cnn cifar10 train step, cuDNN deterministic on / off / on: "
        + ", ".join(f"{'on' if d else 'off'}: " + " and ".join(
            f"{r['ms']:.4f} ms (device " + ("not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms")
            + ")" for r in rs) for d, rs in out.items()) + f" [{card}]")
    return {("on" if d else "off"): rs for d, rs in out.items()}


def zoo_slice(torch, hop, card: str) -> dict:
    """Every zoo recipe on the card at its reference widths: its epoch (the
    MLP's 100) with dropout, checked finite with its test accuracy; card
    vs CPU with dropout off; the CNN (CIFAR-10) and both LSTM recipes at
    ``ZOO_K`` steps per call bit for bit against 1; 1 + 1 resumed CNN
    epochs against 2; ``Classifier`` save and load; the MLlib fit; then
    the times."""
    from machine_learning_apache_spark_tpu_torch.data.datasets import load_ag_news, load_cifar10

    zero = {n: 0 for n in hop.LAUNCHES}
    runs, paths = {}, {}
    for name in ZOO:
        epochs = ZOO_PARITY_EPOCHS.get(name, 1)
        k1 = zoo_run(torch, hop, name, epochs=epochs, _return_classifier=name != "mlp")
        runs[name] = {1: k1}
        paths[name] = k1["launches"]
        losses = k1["fit_result"].step_losses
        log(f"  {name}: {k1['state'].step} steps ({epochs} epoch(s)), {k1['wall']:.3f} s (evaluate "
            f"included), train_seconds {k1['train_seconds']:.3f}; final_loss {k1['final_loss']:.6f}, "
            f"test_loss {k1['test_loss']:.6f}, accuracy {k1['accuracy']:.3f} % over "
            f"{k1['eval_samples']} rows; Hopper kernel launches {k1['launches']}")
        if not np.isfinite(losses).all() or not np.isfinite(k1["test_loss"]):
            fail(f"{name}: losses not finite")
        if k1["launches"] != zero:
            fail(f"{name}: the zoo path launched attention kernels: {k1['launches']}")
    for name in ("cnn cifar10", "lstm last", "lstm last_valid"):
        runs[name][ZOO_K] = zoo_run(torch, hop, name, epochs=1, steps_per_call=ZOO_K)
        zoo_multistep(torch, hop, name, runs[name])
    whole = zoo_run(torch, hop, "cnn cifar10", epochs=2, steps_per_call=ZOO_K)
    resumed = zoo_resume(torch, hop, "cnn cifar10", whole)
    parity = {name: zoo_parity(torch, hop, name) for name in ZOO}
    test_texts, _ = load_ag_news(str(FIXTURES), train=False)
    zoo_classifier(torch, runs["lstm last_valid"][1], test_texts, "lstm last_valid")
    zoo_classifier(torch, runs["cnn cifar10"][1], load_cifar10(str(FIXTURES), train=False).features,
                   "cnn cifar10")
    mllib = zoo_mllib(torch, card)
    # One LSTM recipe is timed: the two differ only in the head's gather.
    times = {name: time_zoo_dispatch(torch, name, runs[name][1]["state"], card)
             for name in ZOO if name != "lstm last_valid"}
    recurrence = time_lstm_recurrence(torch, card)
    determinism = time_cnn_determinism(torch, runs["cnn cifar10"][1]["state"], card)
    return dict(paths=paths, parity=parity, resumed=resumed, mllib=mllib, times=times,
                recurrence=recurrence, determinism=determinism)


# The site whose numbers head each kernel's entry of the JSON line.
# -- phase 7: the translation recipe's options -------------------------------------

# examples/advanced_translator.py's options: 4 switch-routed experts, a
# warmup-cosine schedule, clipping and accumulation.
ADVANCED = dict(moe_experts=4, schedule="warmup_cosine", warmup_steps=20, grad_clip=1.0, grad_accum=2)
OPTION_K = 4
# The 400 fixture pairs pack into 29 rows of 200: batches of 7 give 4
# steps an epoch, one group of OPTION_K.
PACK_BATCH = 7
BUCKETS = (50, 100, 200)  # the default boundaries at max_len 200
FLASH_KERNELS = {"flash_attention_fwd": "flash_fwd", "flash_attention_bwd_dq": "flash_bwd_dq",
                 "flash_attention_bwd_dkv": "flash_bwd_dkv"}


def bucket_sites(torch, rng, dev, src, trg_in, dtype=None) -> dict:
    """The training sites at the default buckets' widths below 200, as a
    bucketed batch gives them (source and decoder input both ``w`` wide)
    and one shorter on the decoder side (``w - 1``): the fixture batch's
    tokens cut to the width (its sentences are shorter than 50)."""
    sites = {}
    for w in BUCKETS[:-1]:
        for t in (w, w - 1):
            for name, site in training_sites(torch, rng, dev, src[:, :w], trg_in[:, :t], dtype=dtype).items():
                sites[f"bucket {w}/{t}: {name}"] = site
    return sites


def dispatch_ms(torch, state, loss_fn, batches, k: int) -> float:
    """ms per train step of one ``StepDispatch`` on ``state`` over
    ``batches`` (device tensors, cycled), ``k`` steps per call (``k`` > 1:
    a replayed CUDA graph), dropout drawn from a seeded card generator:
    CUDA events over ``TIMED_STEPS`` steps after ``2 k`` warm ones (the
    first group captures)."""
    from machine_learning_apache_spark_tpu_torch.train.loop import StepDispatch

    dispatch = StepDispatch(state, loss_fn, torch.Generator(device="cuda").manual_seed(SEED))

    def run(n):
        for i in range(0, n, k):
            group = [batches[(i + j) % len(batches)] for j in range(k)]
            if k == 1:
                dispatch.single(group[0])
            else:
                dispatch.group(group)

    run(2 * k)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(TIMED_STEPS)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_STEPS


def card_vs_cpu(torch, hop, label: str, **kw) -> tuple[dict, dict]:
    """The recipe on the card and on the CPU (plain versions) with dropout
    0: every step's loss within ``PARITY_RTOL`` relative."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    card = recipe_run(torch, hop, dropout=0.0, **kw)
    t0 = time.perf_counter()
    cpu = train_translator(device="cpu", data_root=str(FIXTURES), log_every=0, dropout=0.0,
                           _return_state=True, **kw)
    a, b = np.array(card["fit_result"].step_losses), np.array(cpu["fit_result"].step_losses)
    rel = np.abs(a - b) / np.abs(b)
    log(f"  {label}, card vs CPU ({len(a)} steps, dropout 0; CPU {time.perf_counter() - t0:.1f} s): "
        f"step losses card {a.tolist()}, CPU {b.tolist()}; largest relative difference "
        f"{rel.max():.3e} (gate <= {PARITY_RTOL:.0e})")
    if len(a) != len(b) or not np.isfinite(a).all() or not (rel <= PARITY_RTOL).all():
        fail(f"{label}: card and CPU step losses disagree")
    return card, cpu


def k_steps_like_one(torch, hop, label: str, epochs: int = 2, **kw) -> dict:
    """``OPTION_K`` steps per call against 1 over ``epochs`` epochs,
    dropout 0.1: parameters and step losses bit for bit, one program
    (per accumulation phase), replayed, its launches those of its eager
    first call. Returns both runs."""
    one = recipe_run(torch, hop, epochs=epochs, **kw)
    many = recipe_run(torch, hop, epochs=epochs, steps_per_call=OPTION_K, **kw)
    params_equal, loss_diffs = same_training(torch, many, one)
    programs = many["fit_result"].programs
    log(f"  {label}: steps_per_call {OPTION_K} vs 1 over {one['state'].step} steps: parameters equal "
        f"bit for bit: {params_equal}; step losses differing: {loss_diffs}; programs "
        + "; ".join(f"{p['calls']} calls, {p['replays']} replays, launches per replay {p['launches']}"
                    for p in programs))
    if not params_equal or loss_diffs:
        fail(f"{label}: steps_per_call={OPTION_K} did not train bit for bit like 1")
    if len(programs) != 1 or programs[0]["replays"] < 1:
        fail(f"{label}: {len(programs)} programs, not 1 replayed")
    if programs[0]["launches"] != programs[0]["eager_launches"] or many["launches"] != one["launches"]:
        fail(f"{label}: a replay's launches differ from its eager first call's or from steps_per_call 1's")
    return dict(one=one, many=many)


def moe_slice(torch, hop, card: str, train_ds, src_pipe, trg_pipe) -> dict:
    """``examples/advanced_translator.py``'s run through the port: MoE with
    warmup-cosine, clipping, accumulation 2, BLEU and checkpoints; then
    ``Translator.save`` -> ``load`` on the card, served by the paged fp32
    engine (the ragged kernel launched) against the CPU's one-shot greedy
    decoder over the prompts at the engine's prefill width, and the
    card's one-shot greedy and beam decoders against the CPU's. Then K = 4
    vs 1 bit for bit, the epoch card vs CPU, and the parity run with 4
    experts (step-0 gradients, router and experts included).

    An MoE encoder routes each sequence with ``ceil(1.25 * width / 4)``
    slots per expert, so a prompt padded to the engine's 32-wide prefill
    can drop tokens that the one-shot decoder's 200-wide rows keep (the
    JAX engines and decoders alike): the engine is held against the
    one-shot decoder at its own width, and its agreement with the 200-wide
    one is printed."""
    import tempfile

    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
    from machine_learning_apache_spark_tpu_torch.data.text import TextPipeline
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as d:
        adv = recipe_run(torch, hop, compute_bleu=True, checkpoint_dir=f"{d}/ckpt",
                         _return_translator=True, **ADVANCED)
        check_pointer(f"{d}/ckpt", "the MoE run's checkpoint")
        (epoch,) = adv["history"]
        log(f"  advanced_translator options {ADVANCED}: history {adv['history']}; test_loss "
            f"{adv['test_loss']:.6f}, eval moe_aux {adv['moe_aux']:.6f}; BLEU {adv['bleu']:.6f}; "
            f"{adv['wall']:.2f} s (evaluate and BLEU included); launches {adv['launches']}")
        if not all(np.isfinite([epoch["loss"], epoch["moe_aux"], adv["test_loss"], adv["moe_aux"]])):
            fail(f"the MoE run's losses are not finite: {adv['history']}")
        steps = adv["state"].step
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            if adv["launches"][name] != 3 * steps:
                fail(f"MoE: {name} launched {adv['launches'][name]} times, not 3 x {steps} steps")
        adv["translator"].save(f"{d}/moe")
        loaded = Translator.load(f"{d}/moe")
        oracle = Translator.load(f"{d}/moe", device="cpu")
    if loaded.model.cfg.moe_experts != 4:
        fail("the loaded translator lost its experts")
    prompts = [s for s, _ in load_multi30k(str(FIXTURES), "valid")][:32]
    width = SERVE["boundaries"][0]
    if max(len(loaded.src_pipe.ragged([p])[0]) for p in prompts) > width:
        fail(f"a MoE prompt is longer than the engine's first prefill width {width}")
    served = serve_once(torch, hop, loaded, prompts, "MoE paged fp32", kv_dtype="float32", **SERVE)
    mnt = SERVE["max_new_tokens"]
    spec = oracle.src_pipe.spec
    narrow = Translator(oracle.model, TextPipeline(
        oracle.src_pipe.vocab, spec["tokenizer"], max_seq_len=width - 1, fixed_len=width,
    ), oracle.trg_pipe, device="cpu")
    want = narrow(prompts, max_new_tokens=mnt)
    greedy, greedy_launches = one_shot(torch, hop, "the MoE greedy Translator",
                                       lambda: loaded(prompts, max_new_tokens=mnt))
    greedy_cpu = oracle(prompts, max_new_tokens=mnt)
    beam_kw = dict(method="beam", beam_size=4, max_new_tokens=mnt)
    beam, beam_launches = one_shot(torch, hop, "the MoE beam Translator",
                                   lambda: loaded(prompts[:N_BEAM], **beam_kw))
    beam_cpu = oracle(prompts[:N_BEAM], **beam_kw)
    wide_share, _ = agreement(served["outs"], greedy_cpu)
    log(f"  MoE paged engine (prefill width {width}) vs the one-shot greedy decoder's {spec['fixed_len']}-wide "
        f"rows on the CPU, for reference (expert capacity differs with the width): {wide_share:.6f}")
    for label, got, ref in (
        (f"MoE paged fp32 engine vs one-shot greedy on the CPU at width {width}", served["outs"], want),
        ("MoE one-shot greedy on the card vs on the CPU", greedy, greedy_cpu),
        ("MoE beam 4 on the card vs beam_translate on the CPU", beam, beam_cpu),
    ):
        share, notes = agreement(got, ref)
        same = sum(g == w for g, w in zip(got, ref))
        log(f"  token agreement, {label}: {share:.6f} (gate >= {AGREEMENT_MIN}); {same} of "
            f"{len(ref)} outputs identical")
        for n in notes:
            log(f"    mismatch: {n}")
        if share < AGREEMENT_MIN:
            fail(f"token agreement {share:.4f} < {AGREEMENT_MIN} ({label})")
    log(f"  MoE paged engine: {len(served['outs'])} requests in {served['wall']:.3f} s, launches "
        f"{served['launches']}, {served['programs']} programs, recompiles_after_warmup 0; "
        f"one-shot greedy launches {greedy_launches}, beam {beam_launches} [{card}]")
    runs = k_steps_like_one(torch, hop, "MoE (advanced_translator options)", **ADVANCED)
    one = runs["one"]
    batches = [to_device(b, torch.device("cuda")) for b in train_batches(train_ds, 4)]
    step_ms = {k: dispatch_ms(torch, runs["many"]["state"], make_translation_loss(0), batches, k)
               for k in (1, OPTION_K)}
    log("  MoE train step (4 experts, accumulation 2, dropout 0.1; batch 32, [32, 200] / [32, 199]): "
        + ", ".join(f"{k} step(s) per call {ms:.3f} ms" for k, ms in step_ms.items())
        + f" (CUDA events over {TIMED_STEPS} steps) [{card}]")
    eval_batches = -(-80 // 32)
    if one["launches"]["flash_attention_fwd"] != 3 * one["state"].step + 3 * eval_batches:
        fail(f"MoE: the forward launched {one['launches']['flash_attention_fwd']} times, not 3 x "
             f"{one['state'].step} steps + 3 x {eval_batches} eval batches")
    card_vs_cpu(torch, hop, "MoE (advanced_translator options)", **ADVANCED)
    parity = parity_run(torch, hop, src_pipe, trg_pipe, train_ds, moe_experts=4)
    return dict(adv=adv, served=served, one_shot_launches=[greedy_launches, beam_launches], k=runs,
                parity=parity, step_ms=step_ms)


def remat_slice(torch, hop, card: str, train_ds, src_pipe, trg_pipe) -> dict:
    """The recipe's fixture epoch (dropout 0.1) with ``remat`` against
    without, at 1 and ``OPTION_K`` steps per call: bit for bit, the
    forward launched once more per site and step (the recompute), the
    backward kernels as often. Then one step's gradients with dropout
    from one generator seed, bit for bit, and the peak memory and time of
    a forward + backward of each."""
    import dataclasses

    from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params, random_flax_params

    runs = {}
    for k in (1, OPTION_K):
        base = recipe_run(torch, hop, steps_per_call=k)
        remat = recipe_run(torch, hop, steps_per_call=k, remat=True)
        params_equal, loss_diffs = same_training(torch, remat, base)
        extra = {n: remat["launches"][n] - base["launches"][n] for n in TRAIN_KERNELS}
        steps = base["state"].step
        log(f"  remat vs none, steps_per_call {k}: parameters equal bit for bit: {params_equal}; step "
            f"losses differing: {loss_diffs} of {steps}; launches added by remat {extra}")
        if not params_equal or loss_diffs:
            fail(f"remat=True did not train bit for bit like remat=False at steps_per_call={k}")
        if extra != {"flash_attention_fwd": 3 * steps, "flash_attention_bwd_dq": 0,
                     "flash_attention_bwd_dkv": 0}:
            fail(f"remat at steps_per_call={k} added launches {extra}, not one forward per site and step")
        runs[k] = dict(base=base, remat=remat)
    batches = [to_device(b, torch.device("cuda")) for b in train_batches(train_ds, 4)]
    step_ms = {}
    for label in ("base", "remat"):
        state = runs[OPTION_K][label]["state"]
        step_ms[label] = {k: dispatch_ms(torch, state, make_translation_loss(0), batches, k)
                          for k in (1, OPTION_K)}
    log("  train step (dropout 0.1; batch 32, [32, 200] / [32, 199]), dense without / with remat: "
        + "; ".join(f"{k} step(s) per call {step_ms['base'][k]:.3f} / {step_ms['remat'][k]:.3f} ms"
                    for k in (1, OPTION_K)) + f" (CUDA events over {TIMED_STEPS} steps) [{card}]")
    cfg = TransformerConfig(src_vocab_size=len(src_pipe.vocab), trg_vocab_size=len(trg_pipe.vocab),
                            **{**MODEL, "dropout": 0.1})
    params = random_flax_params(cfg, SEED)
    batch = to_device(train_batches(train_ds, 1)[0], torch.device("cuda"))
    loss_fn = make_translation_loss(cfg.pad_id)
    out = {}
    for remat in (False, True):
        model = load_flax_params(Transformer(dataclasses.replace(cfg, remat=remat)), params).cuda()

        def step(model=model):
            rng = torch.Generator(device="cuda").manual_seed(SEED)
            loss, _ = loss_fn(model, batch, rng)
            loss.backward()
            return loss

        step()
        model.zero_grad(set_to_none=False)  # the gradients stay allocated
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_mem
        grads = [p.grad.clone() for p in model.parameters()]
        ms = cuda_time_ms(torch, lambda: (model.zero_grad(set_to_none=False), step()), n=20, warmup=2)
        out[remat] = dict(loss=loss.item(), grads=grads, peak=peak, ms=ms)
        log(f"  forward + backward, remat {remat}, dropout 0.1 (batch 32, [32, 200] / [32, 199]): "
            f"peak {peak / 2**20:.1f} MiB above the model and its gradients, {ms:.3f} ms (CUDA events, "
            f"20 calls) [{card}]")
    same = out[False]["loss"] == out[True]["loss"] and all(
        torch.equal(a, b) for a, b in zip(out[False]["grads"], out[True]["grads"]))
    log(f"  step gradients with dropout from one seed, remat vs none: equal bit for bit {same}; remat "
        f"saves {(out[False]['peak'] - out[True]['peak']) / 2**20:.1f} MiB of peak and adds "
        f"{out[True]['ms'] - out[False]['ms']:.3f} ms [{card}]")
    if not same:
        fail("remat=True gave other gradients than remat=False with dropout on")
    return dict(runs=runs, peak={k: v["peak"] for k, v in out.items()}, ms={k: v["ms"] for k, v in out.items()},
                step_ms=step_ms)


def bucket_slice(torch, hop, card: str) -> dict:
    """One epoch with ``bucket_by_length`` at the default boundaries, on
    the card and on the CPU: step losses within ``PARITY_RTOL``; the
    padding efficiency; then a train step's ms at each bucket width (the
    fixture's width-50 batches padded out to 100 and 200) against the
    unbucketed [32, 200] step."""
    from machine_learning_apache_spark_tpu_torch.data.bucketing import BucketByLengthPairsLoader
    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
    from machine_learning_apache_spark_tpu_torch.data.text import translation_pipelines
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    card_run, _ = card_vs_cpu(torch, hop, "bucket_by_length", bucket_by_length=True)
    steps = card_run["state"].step
    log(f"  bucketed epoch: padding_efficiency {card_run['padding_efficiency']:.6f}, {steps} steps, "
        f"launches {card_run['launches']}")
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if card_run["launches"][name] != 3 * steps:
            fail(f"bucketed: {name} launched {card_run['launches'][name]} times, not 3 x {steps}")
    pairs = load_multi30k(str(FIXTURES), "train")
    src_pipe, trg_pipe = translation_pipelines(pairs, max_len=200)
    loader = BucketByLengthPairsLoader(src_pipe.ragged([s for s, _ in pairs]),
                                       trg_pipe.ragged([t for _, t in pairs]),
                                       batch_size=32, boundaries=BUCKETS, seed=SEED)
    narrow = [b for b in loader][:4]
    state = card_run["state"]
    pad = state.model.cfg.pad_id
    times = {}
    for w in BUCKETS:
        batches = []
        for src, trg in narrow:
            s = np.full((len(src), w), pad, src.dtype)
            t = np.full((len(trg), w + 1), pad, trg.dtype)
            s[:, : src.shape[1]] = src
            t[:, : trg.shape[1]] = trg
            batches.append(to_device((s, t), torch.device("cuda")))
        times[f"bucket {w}"] = batches
    times["unbucketed [32, 200]"] = [to_device(b, torch.device("cuda"))
                                     for b in train_batches(fixture_data()[2], 4)]
    loss_fn = make_translation_loss(pad)
    times = {label: {k: dispatch_ms(torch, state, loss_fn, batches, k) for k in (1, OPTION_K)}
             for label, batches in times.items()}
    log(f"  train step ms by width (dropout 0.1, CUDA events over {TIMED_STEPS} steps), at 1 / "
        f"{OPTION_K} steps per call: "
        + ", ".join(f"{label} {t[1]:.3f} / {t[OPTION_K]:.3f}" for label, t in times.items()) + f" [{card}]")
    return dict(run=card_run, padding_efficiency=card_run["padding_efficiency"], step_ms=times)


def packing_slice(torch, hop, card: str) -> dict:
    """One epoch with ``pack_sequences`` (batches of ``PACK_BATCH`` packed
    rows), on the card and on the CPU: step losses within ``PARITY_RTOL``,
    no flash launch in training (the segment masks are dense: the plain
    path), K = 4 bit for bit like 1 over two epochs; then packed against
    unpacked non-pad target tokens per second."""
    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
    from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
    from machine_learning_apache_spark_tpu_torch.data.packing import pack_translation_pairs
    from machine_learning_apache_spark_tpu_torch.data.text import translation_pipelines
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_packed_translation_loss,
        make_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    kw = dict(pack_sequences=True, batch_size=PACK_BATCH)
    card_run, _ = card_vs_cpu(torch, hop, "pack_sequences", **kw)
    eval_batches = -(-80 // PACK_BATCH)
    log(f"  packed epoch: packing_token_efficiency {card_run['packing_token_efficiency']} (unpacked "
        f"{card_run['unpacked_token_efficiency']}), packed_rows {card_run['packed_rows']}, packed_pairs "
        f"{card_run['packed_pairs']}, {card_run['state'].step} steps; launches {card_run['launches']} "
        f"(the evaluation's {eval_batches} unpacked batches: 3 forwards each)")
    want = {"flash_attention_fwd": 3 * eval_batches, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    if {n: card_run["launches"][n] for n in TRAIN_KERNELS} != want:
        fail(f"packed training launched flash kernels: {card_run['launches']}, want {want}")
    runs = k_steps_like_one(torch, hop, "pack_sequences", **kw)
    # Packed against unpacked training steps on the trained state.
    pairs = load_multi30k(str(FIXTURES), "train")
    src_pipe, trg_pipe = translation_pipelines(pairs, max_len=200)
    packed = pack_translation_pairs(src_pipe.ragged([s for s, _ in pairs]),
                                    trg_pipe.ragged([t for _, t in pairs]), src_len=200, trg_len=200)
    ds = ArrayDataset(*packed.arrays())
    state = card_run["state"]
    dev = torch.device("cuda")
    out = {}
    for label, loss_fn, batches in (
        ("packed", make_packed_translation_loss(0),
         [to_device(ds[np.arange(i * PACK_BATCH, (i + 1) * PACK_BATCH)], dev) for i in range(4)]),
        ("unpacked", make_translation_loss(0),
         [to_device(b, dev) for b in train_batches(fixture_data()[2], 4)]),
    ):
        if label == "packed":
            scored = [int(((b[4][:, 1:] == b[4][:, :-1]) & (b[4][:, :-1] > 0)).sum().item()) for b in batches]
        else:
            scored = [int((b[1][:, 1:] != 0).sum().item()) for b in batches]
        tok = sum(scored[i % len(batches)] for i in range(TIMED_STEPS)) / TIMED_STEPS
        for k in (1, OPTION_K):
            ms = dispatch_ms(torch, state, loss_fn, batches, k)
            out[f"{label}, {k} step(s) per call"] = dict(
                ms=ms, tokens_per_step=tok, tokens_per_s=tok * 1e3 / ms, rows=int(batches[0][0].shape[0]))
    log(f"  packed vs unpacked train steps (CUDA events over {TIMED_STEPS} steps; scored target "
        "tokens): "
        + "; ".join(f"{k}: {v['rows']} rows of 200, {v['ms']:.3f} ms/step, {v['tokens_per_step']:.1f} "
                    f"tokens/step, {v['tokens_per_s']:.1f} tokens/s" for k, v in out.items())
        + f" [{card}]")
    return dict(run=card_run, k=runs, steps=out)


def profiler_slice(torch, hop, card: str, train_ds) -> dict:
    """``fit(profile_dir=, profile_window=(2, 5))`` over the fixture epoch
    at the reference width, at 1 and ``OPTION_K`` steps per call: one
    Chrome trace each, whose kernel events are counted by name. At 1 the
    trace must name the three flash kernels; at 4 what it holds is
    reported (a replayed CUDA graph)."""
    import glob
    import tempfile

    from machine_learning_apache_spark_tpu_torch.data.loader import DataLoader
    from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    src_pipe, trg_pipe, _ = fixture_data()
    out = {}
    for k in (1, OPTION_K):
        cfg = TransformerConfig(src_vocab_size=len(src_pipe.vocab), trg_vocab_size=len(trg_pipe.vocab),
                                **{**MODEL, "dropout": 0.1})
        model = Transformer(cfg, generator=torch.Generator().manual_seed(SEED)).cuda()
        state = TrainState.create(model=model, tx=make_optimizer("adam", 1e-3))
        with tempfile.TemporaryDirectory(dir=scratch_dir()) as d:
            hop.reset_launches()
            fit(state, make_translation_loss(0), DataLoader(train_ds, 32, shuffle=True, seed=SEED),
                epochs=1, log_every=0, steps_per_call=k, profile_dir=d, profile_window=(2, 5))
            launches = dict(hop.LAUNCHES)
            traces = glob.glob(f"{d}/*.pt.trace.json")
            if len(traces) != 1:
                fail(f"fit(profile_dir=) at steps_per_call={k} wrote {len(traces)} traces, not 1")
            size = Path(traces[0]).stat().st_size
            events = json.loads(Path(traces[0]).read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        named = {n: sum(1 for e in kernels if frag in e.get("name", "")) for n, frag in FLASH_KERNELS.items()}
        graphs = sum(1 for e in events if "cudaGraphLaunch" in e.get("name", ""))
        out[k] = dict(bytes=size, events=len(events), kernel_events=len(kernels), flash=named,
                      graph_launches=graphs, launches=launches)
        log(f"  profiled fit, steps_per_call {k}, window [2, 5): trace {size} bytes, {len(events)} events, "
            f"{len(kernels)} kernel events, flash kernels by name {named}, cudaGraphLaunch calls {graphs}; "
            f"the run's launches {launches}")
        if not events or not kernels:
            fail(f"the profiled fit at steps_per_call={k} traced no device work")
        if k == 1 and not all(named.values()):
            fail(f"the profiled window of 3 single steps does not name every flash kernel: {named} "
                 "(the run launched each 3 sites x 3 steps times in it)")
    return out


def native_text_slice(torch, card: str) -> dict:
    """The fixture pipelines and ``text_encode.cpp``: a batch goes native
    when every sentence is ASCII (the JAX package's gate), as the English
    side's are; the German side's ASCII sentences go native too, its
    whole corpus through the Python chain. The ids equal the Python
    chain's; times over each side's texts ten times over (host only)."""
    import os

    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
    from machine_learning_apache_spark_tpu_torch.data.text import translation_pipelines

    pairs = load_multi30k(str(FIXTURES), "train")
    pipes = translation_pipelines(pairs, max_len=200)
    out = {}
    for side, pipe, texts in zip(("source", "target"), pipes, ([s for s, _ in pairs], [t for _, t in pairs])):
        ascii_texts = [t for t in texts if t.isascii()]
        for label, batch in ((f"{side}, all", texts * 10), (f"{side}, ASCII", ascii_texts * 10)):
            native = pipe._encode_native(batch) is not None
            t0 = time.perf_counter()
            ids = pipe(batch)
            t_call = time.perf_counter() - t0
            os.environ["MLSPARK_NO_NATIVE_TEXT"] = "1"
            try:
                t0 = time.perf_counter()
                python = pipe(batch)
                t_python = time.perf_counter() - t0
            finally:
                del os.environ["MLSPARK_NO_NATIVE_TEXT"]
            if not np.array_equal(ids, python):
                fail(f"the pipeline's ids differ from the Python chain's ({label})")
            out[label] = dict(sentences=len(batch), native=native, ms=t_call * 1e3, python_ms=t_python * 1e3)
    if not (out["source, all"]["native"] and out["target, ASCII"]["native"]):
        fail(f"the native encoder did not take the ASCII batches: {out}")
    log("  text encoding, ids equal to the Python chain: " + "; ".join(
        f"{label} ({v['sentences']} sentences, {'native' if v['native'] else 'Python: non-ASCII'}) "
        f"{v['ms']:.2f} ms vs {v['python_ms']:.2f} ms Python" for label, v in out.items()) + " (host)")
    return out


def options_slice(torch, hop, card: str) -> dict:
    src_pipe, trg_pipe, train_ds = fixture_data()
    t0 = time.perf_counter()
    out = dict(
        moe=moe_slice(torch, hop, card, train_ds, src_pipe, trg_pipe),
        remat=remat_slice(torch, hop, card, train_ds, src_pipe, trg_pipe),
        buckets=bucket_slice(torch, hop, card),
        packing=packing_slice(torch, hop, card),
        profiler=profiler_slice(torch, hop, card, train_ds),
        native_text=native_text_slice(torch, card),
    )
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")
    return out


MAIN_SITE = {
    "flash_attention_fwd": "prefill",
    "ragged_paged_attention": "cross, fp32 pages",
    "flash_attention_bwd_dq": "encoder self",
    "flash_attention_bwd_dkv": "encoder self",
}


# -- phase 7b: the distributed path ------------------------------------------------

GANG = 2
# The MT recipe at reference width as a gang: per-replica batch 16, so the
# global batch is the one-process recipe's 32; dropout off for parity.
GANG_MT = dict(data_root=str(FIXTURES), batch_size=16, dropout=0.0, log_every=0)
GANG_RTOL = 1e-5
# A tensor whose difference Adam's float noise lifts above GANG_RTOL is
# held to this many times the control run's (gang_slice).
GANG_NOISE_X = 10
# The CNN recipe's per-replica batch (recipes/cnn.py), the flagship's.
GANG_CNN_BATCH = 32
GANG_WARMUP = 5


def _gather(obj) -> list:
    """Every rank's ``obj``, in rank order (inside a gang rank)."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def gang_mt_rank(kw: dict) -> dict:
    """One rank of the MT gang: ``train_translator`` under the gang (its
    ``fit(mesh=)``), this rank's launch counts from its own process, the
    replicas' divergence, and every rank's backend, device and parameters'
    device. Rank 0's step losses and parameters (on the host) come back."""
    import torch.distributed as dist

    from machine_learning_apache_spark_tpu_torch.launcher.coordinator import (
        current_backend,
        current_device,
    )
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import assert_replicas_in_sync
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    hop.reset_launches()
    out = train_translator(_return_state=True, **kw)
    launches = dict(hop.LAUNCHES)
    state, result = out.pop("state"), out.pop("fit_result")
    divergence = assert_replicas_in_sync(state)
    rank = dist.get_rank()
    ranks = _gather(dict(
        rank=rank, backend=current_backend(), device=str(current_device()),
        param_device=str(next(state.model.parameters()).device), launches=launches,
        steps=state.step, eval_samples=out["eval_samples"], comms=result.comms,
    ))
    params = ({k: v.detach().cpu() for k, v in state.model.state_dict().items()}
              if rank == 0 else None)
    return dict(out=out, step_losses=result.step_losses, params=params,
                divergence=divergence, ranks=ranks)


def _mt_model(torch, dev, seed=SEED, vocab: int | None = None):
    """The recipe's model on the fixture vocabularies, built as
    ``train_translator`` builds it (dropout 0); ``vocab`` sets both
    vocabularies instead (the published 8004: the fixture's ids are all
    below it)."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import TranslationRecipe

    src_pipe, trg_pipe, train_ds = fixture_data()
    r = TranslationRecipe(**GANG_MT)
    cfg = TransformerConfig(
        src_vocab_size=vocab or len(src_pipe.vocab), trg_vocab_size=vocab or len(trg_pipe.vocab),
        d_model=r.d_model, ffn_hidden=r.ffn_hidden, num_heads=r.num_heads,
        num_layers=r.num_layers, dropout=r.dropout, max_len=r.max_len,
    )
    return Transformer(cfg, generator=torch.Generator().manual_seed(seed)).to(dev), train_ds, r


def _rank_batches(train_ds, batch: int, rank: int, seed=SEED) -> list:
    """Rank ``rank``'s first-epoch batches, as the recipe's loader under a
    2-rank gang makes them (``recipes._common.make_loaders``)."""
    from machine_learning_apache_spark_tpu_torch.data.loader import DataLoader
    from machine_learning_apache_spark_tpu_torch.data.sampler import DistributedSampler

    loader = DataLoader(
        train_ds, batch, sampler=DistributedSampler(len(train_ds), GANG, rank, seed=seed),
        drop_last=True, seed=seed,
    )
    loader.set_epoch(0)
    return list(loader)


def gang_reference(torch, dev, ranks_batches: list, order=(0, 1)) -> dict:
    """One process on the card fed the gang's global batches (each step's
    rank batches concatenated in ``order``: rank order for the reference,
    reversed for the control, the same sums in another order): step
    losses and final parameters."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    model, _, r = _mt_model(torch, dev)
    global_batches = [tuple(np.concatenate(parts) for parts in zip(*(step[r] for r in order)))
                      for step in zip(*ranks_batches)]
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    res = fit(state, make_translation_loss(model.cfg.pad_id), global_batches, epochs=1,
              rng=torch.Generator().manual_seed(r.seed), log_every=0)
    return dict(step_losses=res.step_losses, params=model.state_dict(),
                rows=[len(b[0]) for b in global_batches])


def _rank_events(directory: str) -> dict:
    """Per rank, the ``launcher.rendezvous`` annotation and the
    ``train.fit`` span's attributes from its telemetry file."""
    from machine_learning_apache_spark_tpu_torch.telemetry import aggregate

    out = {}
    for rank, path in aggregate.find_rank_files(directory).items():
        evs = aggregate.load_jsonl(path)
        rdv = [e["attrs"] for e in evs if e.get("name") == "launcher.rendezvous"]
        fits = [e["attrs"] for e in evs
                if e.get("name") == "train.fit" and e.get("kind") == "span_start"]
        out[rank] = dict(rendezvous=rdv[-1] if rdv else {}, fit=fits[-1] if fits else {})
    return out


def _key_bias(name: str, d_model: int):
    """The key slice of an attention projection's bias (the ``k`` third of
    a fused ``qkv``, the ``k`` half of a cross-attention ``kv``), or None."""
    if name.endswith("self_attn.qkv.bias"):
        return slice(d_model, 2 * d_model)
    if name.endswith("cross_attn.kv.bias"):
        return slice(0, d_model)
    return None


def gang_slice(torch, hop, card: str) -> dict:
    """Phase 7b: the flagship CNN gang, the MT gang against one process,
    its merged telemetry, and a failing gang."""
    import shutil

    from machine_learning_apache_spark_tpu_torch import Session
    from machine_learning_apache_spark_tpu_torch.launcher import (
        Distributor,
        GangFailure,
        choose_backend,
        kill_stray_gangs,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import TranslationRecipe
    from machine_learning_apache_spark_tpu_torch.telemetry import aggregate

    root = scratch_dir() / "gang"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    rule = choose_backend("cuda", GANG, torch.cuda.device_count())
    log(f"  backend rule: {GANG} ranks on {torch.cuda.device_count()} card(s) -> {rule} "
        f"(NCCL only when every rank has a card of its own; gloo over CUDA tensors, staged "
        f"through host memory, when ranks share one)")

    # 1. The flagship path, literally as examples/distributed_cnn.py runs it.
    tdir = root / "cnn"
    spark = Session.builder.appName("DistributedCNN").config(
        "spark.executor.instances", str(GANG)).getOrCreate()
    try:
        t0 = time.perf_counter()
        cnn = Distributor(
            num_processes=spark.conf.executor_instances, local_mode=True, timeout=600,
            env={"MLSPARK_TELEMETRY_DIR": str(tdir)},
        ).run("machine_learning_apache_spark_tpu_torch.recipes.cnn:train_cnn",
              data_root=str(FIXTURES), dataset="cifar10", log_every=0)
        wall = time.perf_counter() - t0
    finally:
        spark.stop()
    ranks = _rank_events(str(tdir))
    log(f"  flagship CNN gang ({spark.conf.app_name}, executor_instances "
        f"{spark.conf.executor_instances}): {wall:.2f} s (spawn to result); rank 0: world_processes "
        f"{cnn['world_processes']}, devices {cnn['devices']}, test_loss {cnn['test_loss']:.6f}, "
        f"accuracy {cnn['accuracy']:.4f}, eval_samples {cnn['eval_samples']}, history {cnn['history']}")
    for rank, ev in sorted(ranks.items()):
        log(f"    rank {rank}: backend {ev['rendezvous'].get('backend')}, device "
            f"{ev['rendezvous'].get('device')}, parameters on {ev['fit'].get('device')}, "
            f"fit world {ev['fit'].get('world')}")
    if cnn["world_processes"] != GANG or not np.isfinite(cnn["test_loss"]) or "accuracy" not in cnn:
        fail(f"the flagship CNN gang returned {cnn}")
    if sorted(ranks) != list(range(GANG)) or any(
            ev["rendezvous"].get("backend") != rule or ev["rendezvous"].get("device") != "cuda:0"
            or ev["fit"].get("device") != "cuda:0" for ev in ranks.values()):
        fail(f"the CNN gang's ranks were not each on cuda:0 over {rule}: {ranks}")
    if kill_stray_gangs() != 0:
        fail("the CNN gang left a stray process group")
    out["cnn"] = dict(wall=wall, result={k: cnn[k] for k in ("test_loss", "accuracy", "world_processes")})

    # 2. MT data parallel at full width, against one process on the same
    # global batches.
    tdir = root / "mt"
    t0 = time.perf_counter()
    mt = Distributor(num_processes=GANG, timeout=600, env={"MLSPARK_TELEMETRY_DIR": str(tdir)}).run(
        "chip_smoke:gang_mt_rank", GANG_MT)
    wall = time.perf_counter() - t0
    if kill_stray_gangs() != 0:
        fail("the MT gang left a stray process group")
    _, _, train_ds = fixture_data()
    rank_batches = [_rank_batches(train_ds, GANG_MT["batch_size"], r) for r in range(GANG)]
    ref = gang_reference(torch, torch.device("cuda"), rank_batches)
    control = gang_reference(torch, torch.device("cuda"), rank_batches, order=(1, 0))
    got, want = np.asarray(mt["step_losses"]), np.asarray(ref["step_losses"])
    loss_rel = float(np.max(np.abs(got - want) / np.abs(want))) if len(got) == len(want) else float("inf")
    # Each tensor is gated on its own. The attention key biases' true
    # gradient is exactly zero (softmax is invariant to a per-row
    # constant), so Adam turns their float noise, which differs with the
    # summation order, into steps of up to lr each way: those slices are
    # held to that bound. Every other tensor's relative difference is held
    # to GANG_RTOL, or, where Adam amplifies float noise beyond it (small
    # gradients), to GANG_NOISE_X times the control's: one process fed the
    # same global batches with the ranks' rows in the other order, a sound
    # run whose only difference is the order of the sums.
    d_model = TranslationRecipe().d_model

    def tensor_diffs(run):
        rel, noise = {}, {}
        for k, v in ref["params"].items():
            want_p = v.detach().cpu().double().reshape(-1)
            diff = run[k].detach().cpu().double().reshape(-1) - want_p
            key_bias = _key_bias(k, d_model)
            if key_bias is not None:
                noise[k] = float(diff[key_bias].abs().max())
                keep = torch.ones_like(diff, dtype=torch.bool)
                keep[key_bias] = False
                diff, want_p = diff[keep], want_p[keep]
            rel[k] = float(diff.norm() / want_p.norm().clamp_min(1e-30))
        return rel, noise

    rel, noise = tensor_diffs(mt["params"])
    ctrl_rel, ctrl_noise = tensor_diffs(control["params"])
    limit = {k: max(GANG_RTOL, GANG_NOISE_X * ctrl_rel[k]) for k in rel}
    over = {k: (rel[k], limit[k]) for k in rel if rel[k] > limit[k]}
    noise_max = max(noise.values()) if noise else 0.0
    noise_bound = 2 * TranslationRecipe().learning_rate * len(want)
    worst = sorted(((v / limit[k], k) for k, v in rel.items()), reverse=True)[:4]
    ctrl_loss_rel = float(np.max(np.abs(np.asarray(control["step_losses"]) - want) / np.abs(want)))
    log(f"  MT gang ({GANG} ranks x batch {GANG_MT['batch_size']}, dropout 0): {wall:.2f} s; "
        f"{len(got)} steps; rank 0 step losses {[round(float(x), 6) for x in got]}")
    log(f"    one process on the same global batches ({ref['rows'][0]} rows): step losses "
        f"{[round(float(x), 6) for x in want]}; max relative difference {loss_rel:.3e} (gate {GANG_RTOL}); "
        f"the control (rows in the other rank order) {ctrl_loss_rel:.3e}")
    log(f"    final parameters, per tensor (key-bias slices apart): relative norm of the difference "
        f"to the one process, gate max({GANG_RTOL}, {GANG_NOISE_X} x the control's); the four "
        f"nearest their gate {[(k, f'{rel[k]:.2e}', f'{limit[k]:.2e}') for _, k in worst]}; "
        f"the control's readings above {GANG_RTOL / GANG_NOISE_X:.0e} "
        f"{[(k, f'{v:.2e}') for k, v in sorted(ctrl_rel.items(), key=lambda kv: -kv[1]) if v > GANG_RTOL / GANG_NOISE_X]}")
    log(f"    the attention key biases (true gradient 0, Adam steps of float noise): max abs "
        f"difference {noise_max:.3e}, the control's {max(ctrl_noise.values(), default=0.0):.3e} (bound 2 x lr x "
        f"steps = {noise_bound:.3e}) {[(k, f'{v:.2e}') for k, v in noise.items()]}")
    log(f"    assert_replicas_in_sync divergence {mt['divergence']!r}; eval: test_loss "
        f"{mt['out']['test_loss']:.6f}, eval_samples {mt['out']['eval_samples']} per rank")
    if loss_rel > GANG_RTOL:
        fail(f"the MT gang's step losses differ from one process by {loss_rel:.3e} relative")
    if over:
        fail(f"the MT gang's final parameters differ from one process beyond their gates: {over}")
    if not len(noise) == 3 * TranslationRecipe().num_layers or noise_max > noise_bound:
        fail(f"the MT gang's key biases differ from one process by {noise_max:.3e}, beyond Adam's bound")
    for rk in mt["ranks"]:
        n = rk["launches"]
        fwd_eval = n["flash_attention_fwd"] - 3 * rk["steps"]
        log(f"    rank {rk['rank']}: backend {rk['backend']}, device {rk['device']}, parameters on "
            f"{rk['param_device']}, {rk['steps']} steps, launches {n} (forward: 3 x steps + "
            f"{fwd_eval} in eval), gradient all-reduce {rk['comms']}")
        if rk["device"] != "cuda:0" or rk["param_device"] != "cuda:0" or rk["backend"] != rule:
            fail(f"MT gang rank {rk['rank']} ran on {rk['device']} / {rk['param_device']} over {rk['backend']}")
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            if n[name] != 3 * rk["steps"]:
                fail(f"MT gang rank {rk['rank']}: {name} launched {n[name]} times, not 3 x {rk['steps']}")
        if fwd_eval <= 0 or n["ragged_paged_attention"]:
            fail(f"MT gang rank {rk['rank']}: forward launches {n}")
    report = aggregate.merge_gang_dir(str(tdir))
    step_ranks = sorted(report["phases"].get("train.step", {}).get("ranks", {}))
    log(f"    merged gang report ({report['event_count']} events from ranks {report['ranks']}): "
        f"train.step ranks {step_ranks}")
    log(f"    skew_report: {json.dumps(report['skew'])}")
    log(f"    comms_report: {json.dumps(report['comms'])}")
    if step_ranks != list(range(GANG)):
        fail(f"the merged gang report holds train.step spans of ranks {step_ranks}")
    offline_reports(tdir, report, list(range(GANG)), card)
    out["mt"] = dict(wall=wall, loss_rel=loss_rel, param_rel=max(rel.values()), key_bias_abs=noise_max,
                     divergence=mt["divergence"], ranks=mt["ranks"], skew=report["skew"],
                     comms=report["comms"])

    # 3. A failing gang: the flagship CNN recipe, in which rank 1 raises
    # at step 3 (a fault plan) while rank 0 goes on into that step's
    # all-reduce and fails there too once rank 1 is gone.
    tdir = root / "boom"
    try:
        Distributor(num_processes=GANG, timeout=600, env={
            "MLSPARK_TELEMETRY_DIR": str(tdir),
            "MLSPARK_FAULTS": "raise@train_step:rank=1,step=3",
        }).run("machine_learning_apache_spark_tpu_torch.recipes.cnn:train_cnn",
               data_root=str(FIXTURES), dataset="cifar10", log_every=0)
        fail("the failing gang returned")
    except GangFailure as e:
        msg = str(e)
        flights = sorted(p.name for p in tdir.glob("flight_*.json"))
        log(f"  failing gang (CNN recipe, rank 1 raises at step 3): GangFailure rank {e.rank}, "
            f"cause {e.cause}: {msg.splitlines()[0]} ...; the blamed rank's error "
            f"{[ln for ln in msg.splitlines() if ln.strip()][-1]!r}; flight dumps {flights}")
        if e.rank != 1 or "injected fault raise_train_step_r1" not in msg:
            fail(f"the failing gang's GangFailure does not name rank 1 and its message: {msg}")
        if not flights:
            fail("the failing gang left no flight dump")
    stray = kill_stray_gangs()
    log(f"  kill_stray_gangs() after the failing gang: {stray}")
    if stray:
        fail("the failing gang left a stray process group")
    return out


# -- the report CLIs over the smoke's own telemetry ---------------------------------

# Wall seconds the report CLIs took: the offline reports run between 7b's
# gates, the live gang status beside the running gang of 7f-7l.
REPORT_CLI_SECONDS: dict[str, float] = {}


def _report_cli(name: str, *argv, timeout: float = 120.0) -> tuple[subprocess.CompletedProcess, float]:
    """``python tools/<name>.py *argv``, as a user runs it: the completed
    process and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "tools" / f"{name}.py"), *map(str, argv)],
        capture_output=True, text=True, timeout=timeout)
    return proc, time.perf_counter() - t0


def offline_reports(tdir: Path, report: dict, ranks: list[int], card: str) -> None:
    """``tools/torch_telemetry_report.py`` and ``tools/torch_trace_report.py``
    over a gang's telemetry directory after its run: each must exit 0 and
    report every rank, and the telemetry report's JSON must be the report
    ``aggregate.merge_gang_dir`` built in this process."""
    rep, t_rep = _report_cli("torch_telemetry_report", tdir, "--json", tdir / "cli_report.json",
                             "--md", tdir / "cli_report.md")
    got = json.loads((tdir / "cli_report.json").read_text()) if rep.returncode == 0 else {}
    trace, t_trace = _report_cli("torch_trace_report", tdir, "--perfetto", tdir / "cli_perfetto.json")
    procs = sorted(
        e["args"]["name"] for e in json.loads((tdir / "cli_perfetto.json").read_text())["traceEvents"]
        if e["ph"] == "M" and e["name"] == "process_name") if trace.returncode == 0 else []
    REPORT_CLI_SECONDS["offline reports (7b)"] = t_rep + t_trace
    log(f"    tools/torch_telemetry_report.py over the MT gang's telemetry: exit {rep.returncode} in "
        f"{t_rep:.2f} s, ranks {got.get('ranks')}, {got.get('event_count')} events, "
        f"{len(got.get('phases', {}))} phases; tools/torch_trace_report.py --perfetto: exit "
        f"{trace.returncode} in {t_trace:.2f} s, process rows {procs} [{card}]")
    want = [f"rank {r}" for r in ranks]
    if rep.returncode or got.get("ranks") != ranks or got != json.loads(json.dumps(report)):
        fail(f"tools/torch_telemetry_report.py exit {rep.returncode}, ranks {got.get('ranks')} "
             f"(want {ranks}, the in-process report): {rep.stderr[-2000:]}")
    if trace.returncode or [p for p in procs if p.startswith("rank ")] != want:
        fail(f"tools/torch_trace_report.py exit {trace.returncode}, process rows {procs} (want {want}): "
             f"{trace.stderr[-2000:]}")


def live_gang_status(tdir: Path, world: int, result: dict, wait_s: float = 240.0) -> None:
    """Thread body beside a running gang: once every rank has published its
    HTTP sidecar in ``tdir``, ``tools/torch_gang_status.py`` scrapes the
    gang live, once."""
    from machine_learning_apache_spark_tpu_torch.telemetry.http import find_port_sidecars

    try:
        t0 = time.monotonic()
        while len(find_port_sidecars(str(tdir))) < world and time.monotonic() - t0 < wait_s:
            time.sleep(0.2)
        result["waited"] = time.monotonic() - t0
        proc, took = _report_cli("torch_gang_status", tdir, "--json", tdir / "gang_status.json",
                                 timeout=60.0)
        rows = json.loads((tdir / "gang_status.json").read_text())["rows"] if proc.returncode == 0 else []
        result.update(rc=proc.returncode, rows=rows, seconds=took, err=proc.stderr[-2000:])
    except Exception as e:  # noqa: BLE001 - the gate reports it
        result["error"] = repr(e)


# -- phase 7c: the gang that survives a crash and reports its health ------------

# The fault drill: the MT recipe at reference width as a 2-rank gang, 2
# epochs of 12 steps per rank (per-replica batch 16), a checkpoint at each
# epoch's end. Rank 1 crashes at step 18, inside epoch 2, after the
# step-12 checkpoint.
DRILL_EPOCHS = 2
DRILL_CRASH_STEP = 18
DRILL_RESUME_STEP = 12
# The MLlib baseline under a gang: the reference's estimator on the libsvm
# sample's 60 % split; JAX's TestMeshFit bound at maxIter 5.
MLLIB_GANG = dict(layers=[4, 5, 4, 3], maxIter=5)
MLLIB_ATOL, MLLIB_RTOL = 1e-5, 1e-4
LIVE_GAUGES = ("queue_depth_live", "kv_page_occupancy", "kv_mem_bytes_in_use", "active_rows")


def drill_mt_rank(kw: dict) -> dict:
    """One rank of the drill's MT gang: ``train_translator`` with
    ``checkpoint_dir`` under the gang, this rank's launches counted in its
    own process. Every rank's resumed step, steps run and launches; rank
    0's step losses and final parameters (on the host)."""
    import torch.distributed as dist

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    hop.reset_launches()
    out = train_translator(_return_state=True, **kw)
    launches = dict(hop.LAUNCHES)
    state, result = out.pop("state"), out.pop("fit_result")
    rank = dist.get_rank()
    ranks = _gather(dict(rank=rank, resumed=out.get("resumed_from_step"), final_step=state.step,
                         steps_run=len(result.step_losses), launches=launches))
    params = ({k: v.detach().cpu() for k, v in state.model.state_dict().items()}
              if rank == 0 else None)
    return dict(out=out, step_losses=result.step_losses, params=params, ranks=ranks)


def mllib_gang_rank(data_path: str, layers: list, max_iter: int) -> dict:
    """``fit(mesh=data_parallel_mesh())`` of MLlib in this gang on the
    sample's 60 % split, twice (the first the gang's first fit, the
    second after it). Rank 0's parameters, both fit walls, iterations and
    all-reduce count, and whether every rank ended on the same bits."""
    import torch

    from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
    from machine_learning_apache_spark_tpu_torch.mllib import MultilayerPerceptronClassifier
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh

    train, _ = read_libsvm(data_path).random_split([0.6, 0.4], seed=1234)
    mesh = data_parallel_mesh()
    est = MultilayerPerceptronClassifier(layers=list(layers), maxIter=max_iter)
    first = est.fit(train, mesh=mesh)
    model = est.fit(train, mesh=mesh)
    flat = torch.cat([p.detach().reshape(-1).cpu() for p in model.mlp.parameters()])
    gathered = _gather(flat)
    return dict(params=model.params, fit_seconds=model.fit_seconds,
                first_fit_seconds=first.fit_seconds, iterations=model.iterations,
                evaluations=model.evaluations, allreduces=model.allreduces,
                device=str(next(model.mlp.parameters()).device),
                ranks_agree=all(torch.equal(gathered[0], g) for g in gathered))


def torn_then_mllib_rank(kw: dict, data_path: str, layers: list, max_iter: int) -> dict:
    """One rank of phase 7c's second gang: the MT run over the torn
    checkpoint group (``drill_mt_rank``), then the MLlib fits
    (``mllib_gang_rank``), each part's seconds on the rank's clock; one
    gang for both spares the smoke a spawn."""
    t0 = time.perf_counter()
    torn = drill_mt_rank(kw)
    t1 = time.perf_counter()
    mllib = mllib_gang_rank(data_path, layers, max_iter)
    return dict(torn=torn, mllib=mllib, seconds=dict(torn=t1 - t0, mllib=time.perf_counter() - t1))


def _drill_run(label: str, directory: Path, env: dict | None = None, **kw) -> tuple[dict, float]:
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs

    t0 = time.perf_counter()
    out = Distributor(num_processes=GANG, timeout=600, env=env or {}, **kw).run(
        "chip_smoke:drill_mt_rank", dict(GANG_MT, epochs=DRILL_EPOCHS, checkpoint_dir=str(directory)))
    wall = time.perf_counter() - t0
    if kill_stray_gangs() != 0:
        fail(f"the {label} gang left a stray process group")
    return out, wall


def _same_run(label: str, got: dict, want: dict, from_step: int) -> None:
    """Fail unless ``got``'s step losses equal ``want``'s from
    ``from_step`` on and its final parameters equal ``want``'s, bit for
    bit."""
    import torch

    if list(got["step_losses"]) != list(want["step_losses"][from_step:]):
        fail(f"{label}: step losses after the resume {got['step_losses']} are not the unfaulted "
             f"gang's {want['step_losses'][from_step:]}")
    differ = [k for k, v in want["params"].items() if not torch.equal(got["params"][k], v)]
    if differ:
        fail(f"{label}: final parameters differ from the unfaulted gang's in {differ}")


def _check_drill_launches(label: str, run: dict, eval_fwd: int) -> None:
    for rk in run["ranks"]:
        n, steps = rk["launches"], rk["steps_run"]
        if n["flash_attention_bwd_dq"] != 3 * steps or n["flash_attention_bwd_dkv"] != 3 * steps \
                or n["flash_attention_fwd"] != 3 * steps + eval_fwd:
            fail(f"{label} rank {rk['rank']}: launches {n} are not 3 x its {steps} steps "
                 f"(+ {eval_fwd} forwards in eval)")


def _http_json(url: str) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _http_text(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def _wait_health(url: str, code: int, seconds: float = 10.0) -> tuple[int, dict]:
    deadline = time.monotonic() + seconds
    while True:
        got = _http_json(url)
        if got[0] == code or time.monotonic() > deadline:
            return got
        time.sleep(0.01)


def live_plane(torch, hop, translator, prompts, card: str) -> dict:
    """Phase 7c's live plane: a paged engine (fp32 pages) and a padded one
    on the card behind the HTTP plane on an ephemeral port. /healthz 200,
    503 on a quarantined launch (an injected ``decode_batch`` fault), 200
    after the next good one; /statusz's sections, /metrics' live gauges,
    and /tracez of a served request rooted at its ``serving.submit``."""
    from machine_learning_apache_spark_tpu_torch import telemetry
    from machine_learning_apache_spark_tpu_torch.serving import InternalError
    from machine_learning_apache_spark_tpu_torch.utils import faults

    srv = telemetry.start_http_server(port=0)
    if srv is None:
        fail("the HTTP plane did not start (is MLSPARK_TELEMETRY=0 set?)")
    out = {}
    try:
        for label, kw in (("paged fp32", dict(kv_dtype="float32", **SERVE)), ("padded", SERVE_PADDED)):
            eng = translator.serve(**kw)
            hop.reset_launches()
            faults.install(faults.FaultPlan.from_spec("raise@decode_batch:batch=0"))
            try:
                before = _http_json(srv.url("/healthz"))
                victim = eng.submit(prompts[0])
                try:
                    victim.result(timeout=120)
                    fail(f"{label}: the request of the faulted launch completed")
                except InternalError:
                    pass
                degraded = _wait_health(srv.url("/healthz"), 503)
                served = [eng.submit(p) for p in prompts[1:9]]
                texts = [f.result(timeout=120) for f in served]
                recovered = _wait_health(srv.url("/healthz"), 200)
                status = _http_json(srv.url("/statusz"))
                metrics = _http_text(srv.url("/metrics"))
                tid = served[0].trace.trace_id
                tree = _http_json(srv.url(f"/tracez?id={tid}"))
            finally:
                faults.clear()
                eng.stop()
            launches = dict(hop.LAUNCHES)
            sections = sorted(status[1].get("sections", {}))
            gauges = [g for g in LIVE_GAUGES if f"serving_{g}" in metrics]
            roots = [n["name"] for n in tree[1].get("roots", [])]
            check = degraded[1].get("checks", {}).get("serving", {})
            log(f"  live plane, {label} engine: /healthz {before[0]} -> {degraded[0]} "
                f"({degraded[1].get('status')}, quarantined {check.get('quarantined')}) on the "
                f"quarantined launch -> {recovered[0]} after the next good one; /statusz sections "
                f"{sections}; /metrics live gauges {gauges}; /tracez?id={tid}: roots {roots}, "
                f"orphans {len(tree[1].get('orphans', []))}, annotations "
                f"{len(tree[1].get('annotations', []))}, spans {tree[1].get('span_count')}; "
                f"{len(texts)} requests served; launches {launches} [{card}]")
            want_sections = {"serving"} | ({"prefix_cache"} if eng.runtime is not None else set())
            want_gauges = LIVE_GAUGES if eng.runtime is not None else LIVE_GAUGES[:1]
            if (before[0], degraded[0], recovered[0]) != (200, 503, 200):
                fail(f"{label}: /healthz read {before[0]} -> {degraded[0]} -> {recovered[0]}, "
                     "not 200 -> 503 -> 200")
            if not want_sections <= set(sections) or tuple(gauges) != tuple(want_gauges):
                fail(f"{label}: /statusz sections {sections}, /metrics gauges {gauges}")
            if tree[0] != 200 or roots != ["serving.submit"] or tree[1].get("orphans") \
                    or "annotations" not in tree[1]:
                fail(f"{label}: /tracez of a served request returned {tree}")
            if not all(isinstance(t, str) for t in texts):
                fail(f"{label}: the requests after the quarantine did not complete")
            kernels = ("flash_attention_fwd", "ragged_paged_attention") \
                if eng.runtime is not None else ("flash_attention_fwd",)
            if not all(launches[k] for k in kernels):
                fail(f"{label}: the engine's kernels did not launch: {launches}")
            out[label] = dict(healthz=[before[0], degraded[0], recovered[0]], sections=sections,
                              gauges=gauges, tracez_roots=roots, launches=launches)
    finally:
        telemetry.stop_http_server()
    return out


def recovery_slice(torch, hop, translator, prompts, card: str) -> dict:
    """Phase 7c: the MT gang crashed and retried against the unfaulted
    gang, group agreement over a torn payload, the MLlib baseline under a
    gang, and the serving engine's live plane."""
    import shutil

    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.mllib import MultilayerPerceptronClassifier
    from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
    from machine_learning_apache_spark_tpu_torch.train import checkpoint as ckpt

    root = scratch_dir() / "drill"
    shutil.rmtree(root, ignore_errors=True)
    out = {}

    # a. The fault drill: unfaulted, then crashed at step 18 and retried.
    want, wall_ok = _drill_run("unfaulted drill", root / "unfaulted")
    markers = root / "markers"
    got, wall_crash = _drill_run(
        "crashed drill", root / "crashed", max_restarts=1, backoff_base=0.05, term_grace=2.0,
        env={"MLSPARK_FAULTS": f"crash@train_step:rank=1,step={DRILL_CRASH_STEP}",
             "MLSPARK_FAULTS_DIR": str(markers)})
    fired = sorted(p.name for p in markers.iterdir()) if markers.exists() else []
    steps = len(want["step_losses"])
    eval_fwd = want["ranks"][0]["launches"]["flash_attention_fwd"] - 3 * steps
    log(f"  MT gang, {DRILL_EPOCHS} epochs of {steps // DRILL_EPOCHS} steps per rank with "
        f"checkpoint_dir: unfaulted {wall_ok:.2f} s spawn to result; rank 1 crashed at step "
        f"{DRILL_CRASH_STEP} (markers {fired}) and the gang retried (max_restarts=1): "
        f"{wall_crash:.2f} s spawn to result; time to recover (the difference) "
        f"{wall_crash - wall_ok:.2f} s [{card}]")
    log(f"    retried gang: resumed_from_step {got['out'].get('resumed_from_step')}, ranks "
        f"{[(r['rank'], r['resumed'], r['steps_run'], r['final_step']) for r in got['ranks']]} "
        f"(rank, resumed, steps run, final step); step losses after the resume "
        f"{[round(float(x), 6) for x in got['step_losses']]}")
    if not fired:
        fail("the drill's crash fault never fired")
    if got["out"].get("resumed_from_step") != DRILL_RESUME_STEP or any(
            r["resumed"] != DRILL_RESUME_STEP or r["final_step"] != steps for r in got["ranks"]):
        fail(f"the retried gang did not resume every rank at step {DRILL_RESUME_STEP}: {got['ranks']}")
    _same_run("the retried gang", got, want, DRILL_RESUME_STEP)
    _check_drill_launches("unfaulted drill", want, eval_fwd)
    _check_drill_launches("retried drill", got, eval_fwd)
    log(f"    the retried gang's step losses and final parameters equal the unfaulted gang's bit "
        f"for bit (torch.equal on all {len(want['params'])} tensors); launches per rank "
        f"{[r['launches'] for r in got['ranks']]}")
    out["drill"] = dict(wall_unfaulted=wall_ok, wall_crashed=wall_crash,
                        time_to_recover=wall_crash - wall_ok,
                        resumed_from_step=got["out"].get("resumed_from_step"),
                        launches=[r["launches"] for r in got["ranks"]])

    # b. Group agreement: rank 1's newest payload torn and its pointer back
    # at the older step, as a rank killed mid-save leaves them. A new run
    # of one more epoch resumes the older step on both ranks.
    r1 = root / "unfaulted" / "ckpt_r1"
    newest, older = ckpt.pointed_step_of(str(r1)), DRILL_RESUME_STEP
    payload = r1 / str(newest) / ckpt.PAYLOAD
    with open(payload, "r+b") as f:
        f.truncate(payload.stat().st_size // 2)
    (r1 / ckpt.LATEST_POINTER).write_text(json.dumps({"step": older}))
    # b and c run in one gang: the torn group's run, then the MLlib fits.
    data = str(Path(__file__).resolve().parent / "assets" / "sample_multiclass_classification_data.txt")
    pointed0 = ckpt.pointed_step_of(str(root / "unfaulted" / "ckpt_r0"))
    t0 = time.perf_counter()
    both = Distributor(num_processes=GANG, timeout=600).run(
        "chip_smoke:torn_then_mllib_rank", dict(GANG_MT, epochs=1, checkpoint_dir=str(root / "unfaulted")),
        data, MLLIB_GANG["layers"], MLLIB_GANG["maxIter"])
    wall_both = time.perf_counter() - t0
    if kill_stray_gangs() != 0:
        fail("the torn-payload and MLlib gang left a stray process group")
    torn, mg, wall_torn = both["torn"], both["mllib"], both["seconds"]["torn"]
    log(f"  torn payload: rank 1's step {newest} cut to half and its pointer set to {older}, rank "
        f"0's pointer at {pointed0} before the run; "
        f"the next run resumed {[(r['rank'], r['resumed'], r['final_step']) for r in torn['ranks']]} "
        f"(rank, resumed, final step), {wall_torn:.2f} s in rank 0 (the gang, with the MLlib fits "
        f"after it: {wall_both:.2f} s spawn to result)")
    if any(r["resumed"] != older or r["final_step"] != steps for r in torn["ranks"]):
        fail(f"the torn-payload gang did not agree on step {older} on both ranks: {torn['ranks']}")
    _same_run("the torn-payload gang", torn, want, older)
    out["torn"] = dict(resumed=[r["resumed"] for r in torn["ranks"]], wall=wall_torn)

    # c. The MLlib baseline under a gang, against one process on the card.
    wall_gang = both["seconds"]["mllib"]
    train, _ = read_libsvm(data).random_split([0.6, 0.4], seed=1234)
    one = MultilayerPerceptronClassifier(**MLLIB_GANG).fit(train)
    worst = 0.0
    for name, leaf in one.params.items():
        for key, want_p in leaf.items():
            diff = np.abs(np.asarray(mg["params"][name][key]) - want_p)
            worst = max(worst, float(np.max(diff - MLLIB_RTOL * np.abs(want_p))))
    per_iter = mg["allreduces"] / max(mg["iterations"], 1)
    log(f"  MLlib gang ({GANG} ranks on {mg['device']}, layers {MLLIB_GANG['layers']}, maxIter "
        f"{MLLIB_GANG['maxIter']}, the sample's 60 % split): fit {mg['fit_seconds']:.4f} s, "
        f"{mg['iterations']} iterations, {mg['evaluations']} loss-and-gradient evaluations, "
        f"{mg['allreduces']} all-reduces ({per_iter:.2f} per iteration); the gang's first fit "
        f"{mg['first_fit_seconds']:.4f} s; {wall_gang:.2f} s in rank 0 after the torn-payload "
        f"run; one process on the card: fit {one.fit_seconds:.4f} s; parameters: max(|diff| - "
        f"{MLLIB_RTOL} x |want|) {worst:.3e} (gate {MLLIB_ATOL}); ranks agree {mg['ranks_agree']} "
        f"[{card}]")
    if worst > MLLIB_ATOL or not mg["ranks_agree"] or mg["allreduces"] != mg["evaluations"]:
        fail("the MLlib gang's parameters are outside the TestMeshFit bound or its ranks disagree")
    out["mllib"] = dict(fit_seconds=mg["fit_seconds"], first_fit_seconds=mg["first_fit_seconds"],
                        one_fit_seconds=one.fit_seconds,
                        allreduces_per_iteration=per_iter, worst=worst, wall=wall_gang)

    # d. The live plane.
    out["live"] = live_plane(torch, hop, translator, prompts, card)
    return out


# The reference recipe's vocabularies (pytorch_machine_translator.py's
# 8004 tokens each side): 17,559,364 parameters, where the fixture's make
# the same model a third of that.
MT_PUBLISHED_VOCAB = 8004


def _timed_steps(torch, step, state, batches, n: int) -> float:
    """Host seconds per step over ``n`` steps, the card synchronised at
    both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(state, batches[i % len(batches)], None)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def _step_times(torch, kind: str, mesh, rank: int, world: int, dev) -> dict:
    """One rank's (or one process's) timing of a model's train step:
    ``GANG_WARMUP`` steps, then ``TIMED_STEPS`` timed, then a profiled
    window of 12 steps. With a mesh the step is the data-parallel one at
    the per-replica batch; without, the one-process step at the global
    batch; both take host batches, as ``fit`` hands them. MT: the
    recipe's model (dropout 0), Adam, on the fixture's vocabularies
    ("mt") or the published ones ("mt8004"); CNN: TinyVGG on CIFAR-10,
    SGD 0.01."""
    from machine_learning_apache_spark_tpu_torch.parallel import make_data_parallel_step
    from machine_learning_apache_spark_tpu_torch.train.loop import make_train_step, to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    if kind.startswith("mt"):
        from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss

        model, train_ds, r = _mt_model(torch, dev, vocab=MT_PUBLISHED_VOCAB if kind == "mt8004" else None)
        loss_fn = make_translation_loss(model.cfg.pad_id)
        tx = make_optimizer("adam", r.learning_rate)
        per = GANG_MT["batch_size"]
        units = "non-pad target tokens"
        count = lambda b: int((b[1][:, 1:] != model.cfg.pad_id).sum())  # noqa: E731
    else:
        from machine_learning_apache_spark_tpu_torch.data.datasets import load_cifar10
        from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset
        from machine_learning_apache_spark_tpu_torch.models.cnn import TinyVGG
        from machine_learning_apache_spark_tpu_torch.train.loop import classification_loss

        frame = load_cifar10(str(FIXTURES), train=True)
        train_ds = ArrayDataset(*frame.arrays())
        model = TinyVGG(hidden_units=10, num_classes=10, input_shape=frame.features.shape[1:],
                        generator=torch.Generator().manual_seed(SEED)).to(dev)
        loss_fn = classification_loss()
        tx = make_optimizer("sgd", 0.01)
        per = GANG_CNN_BATCH
        units = "samples"
        count = lambda b: len(b[0])  # noqa: E731
    per_rank = [_rank_batches(train_ds, per, rk) for rk in range(GANG)]
    global_host = [tuple(np.concatenate(parts) for parts in zip(*s)) for s in zip(*per_rank)]
    units_per_step = float(np.mean([count(b) for b in global_host]))
    if mesh is not None:
        batches = per_rank[rank]
        step = make_data_parallel_step(loss_fn, mesh)
    else:
        batches = global_host
        one_step = make_train_step(loss_fn)

        def step(state, batch, rng):
            return one_step(state, to_device(batch, dev), rng)
    state = TrainState.create(model=model, tx=tx)
    n_params = sum(p.numel() for p in model.parameters())
    _timed_steps(torch, step, state, batches, GANG_WARMUP)
    comms = getattr(step, "comms", None)
    before = comms.stats() if comms is not None else None
    sec = _timed_steps(torch, step, state, batches, TIMED_STEPS)
    reduce = {}
    if comms is not None:
        after = comms.stats()
        steps = after["allreduce_steps"] - before["allreduce_steps"]
        reduce = dict(
            window_ms=1e3 * (after["allreduce_window_seconds"] - before["allreduce_window_seconds"]) / steps,
            sum_ms=1e3 * (after["allreduce_seconds"] - before["allreduce_seconds"]) / steps,
            buckets=(after["allreduce_calls"] - before["allreduce_calls"]) / steps,
            bytes=(after["allreduce_bytes"] - before["allreduce_bytes"]) // steps,
        )
    try:
        window = profiled_call(torch, lambda: _timed_steps(torch, step, state, batches, 12))
    except RuntimeError as e:  # a second process's profiler on a shared card
        log(f"  the profiler failed in rank {rank}: {e!r}; idle share not measured")
        window = dict(wall=None, busy=None)
    return dict(kind=kind, rank=rank, world=world, batch=len(batches[0][0]), ms=1e3 * sec,
                params=n_params, units=units, units_per_step=units_per_step,
                units_per_s=units_per_step / sec, reduce=reduce,
                wall=window["wall"], busy=window["busy"],
                idle=None if window["busy"] is None else 1 - window["busy"] / window["wall"])


# Phase 8's gang timings: the MT model on the fixture's vocabularies and
# on the published ones, and TinyVGG.
GANG_TIMED = ("mt", "mt8004", "cnn")


def time_gang(torch, card: str, gang: list) -> dict:
    """Phase 8's gang numbers: the 2-rank gang's step against one process
    at the same global batch, MT and CNN. ``gang`` is each rank's rows,
    timed at the end of phase 7e's gang (``zero1_gang_rank``): a gang of
    its own cost one more spawn of the smoke's time."""
    one = {kind: _step_times(torch, kind, None, 0, 1, torch.device("cuda")) for kind in GANG_TIMED}
    out = {}
    for kind in GANG_TIMED:
        ranks = [r for rows in gang for r in rows if r["kind"] == kind]
        o = one[kind]
        for t in ranks:
            idle = "not measured" if t["idle"] is None else f"{t['idle']:.4f} (wall {t['wall']:.4f} s)"
            rd = t["reduce"]
            log(f"  {kind} gang rank {t['rank']} of {t['world']} ({t['params']} parameters; batch "
                f"{t['batch']} per replica, global {t['batch'] * t['world']}): {t['ms']:.3f} ms/step "
                f"(host-timed over {TIMED_STEPS} steps after {GANG_WARMUP}), {t['units_per_s']:.1f} "
                f"{t['units']}/s of the global batch, gradient all-reduce {rd['window_ms']:.3f} ms/step "
                f"from the first bucket's launch to the last one's completion ({rd['sum_ms']:.3f} ms "
                f"summed over {rd['buckets']:.0f} buckets, {rd['bytes']} bytes), profiled window of "
                f"12 steps: device idle share {idle} [{card}]")
        idle = "not measured" if o["idle"] is None else f"{o['idle']:.4f}"
        log(f"  {kind} one process ({o['params']} parameters; batch {o['batch']}): {o['ms']:.3f} ms/step, {o['units_per_s']:.1f} "
            f"{o['units']}/s, profiled window of 12 steps: device idle share {idle} [{card}]")
        out[kind] = dict(gang=ranks, one=o)
    return out


# -- phase 7e: ZeRO-1 on the data axis and the gang's K steps -----------------

# The replicated gang's K steps per call: K eager data-parallel steps (a
# gloo collective cannot sit inside a CUDA graph).
ZERO1_K = 4
# The bf16 wire against the float32 one: two bf16 roundings a step (each
# rank's bucket, then the sum) move a step's gradient by at most 2u of its
# largest coordinate (u = 2^-8); the step losses held to 2u relative.
ZERO1_BF16_LOSS_RTOL = 2 * 2.0 ** -8
ZERO1_WIRES = ("bfloat16", "int8")


def _zero1_recipe(torch, env: dict, **kw) -> tuple[dict, object]:
    """One ``train_translator`` run in this gang rank under ``env`` (the
    data-parallel contract variables, over the Distributor's): its step
    losses, launches, peak memory, optimizer bytes, comms totals, the
    replicas' divergence; and the trained state."""
    import gc
    import os

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import assert_replicas_in_sync, zero
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hop.reset_launches()
        out = train_translator(_return_state=True, **{**GANG_MT, **kw})
        torch.cuda.synchronize()
        launches = dict(hop.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    state, res = out.pop("state"), out.pop("fit_result")
    return dict(
        type=type(state).__name__, step_losses=res.step_losses, launches=launches, peak=peak,
        opt_bytes=zero.opt_state_bytes_per_chip(state), comms=res.comms, steps=state.step,
        resumed=out.get("resumed_from_step"), test_loss=out["test_loss"],
        divergence=assert_replicas_in_sync(state),
        layout=zero.plan_layout(state.plan) if hasattr(state, "plan") else None,
    ), state


def _param_gate(torch, got: dict, want: dict, steps: int) -> dict:
    """Per tensor, PR 10's gang gate: the relative norm of the difference
    (key-bias slices apart) within ``GANG_RTOL``, the key biases (true
    gradient 0, Adam steps of float noise) within 2 x lr x steps; and
    whether every tensor is the same bits."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import TranslationRecipe

    r = TranslationRecipe(**GANG_MT)
    rel, noise, same = {}, 0.0, True
    for k, w in want.items():
        g = got[k]
        same = same and bool(torch.equal(g, w))
        diff = (g.double() - w.double()).reshape(-1)
        ref = w.double().reshape(-1)
        kb = _key_bias(k, r.d_model)
        if kb is not None:
            noise = max(noise, float(diff[kb].abs().max()))
            keep = torch.ones_like(diff, dtype=torch.bool)
            keep[kb] = False
            diff, ref = diff[keep], ref[keep]
        rel[k] = float(diff.norm() / ref.norm().clamp_min(1e-30))
    bound = 2 * r.learning_rate * steps
    over = {k: v for k, v in rel.items() if v > GANG_RTOL}
    return dict(same_bits=same, max_rel=max(rel.values()), over=over, key_bias_abs=noise,
                key_bias_bound=bound, ok=not over and noise <= bound, rel=rel)


def _zero1_step_times(torch, rank: int) -> dict:
    """This rank's step on the fixture batches (the recipe's model, Adam,
    16 a replica), ``GANG_WARMUP`` steps then ``TIMED_STEPS`` timed: the
    replicated step and the ZeRO-1 step (overlap on and off, the bf16 and
    int8 wires) with their collectives' host-timed windows per step; then
    the replicated gang through ``fit``'s dispatch at 1 and ``ZERO1_K``
    steps per call."""
    import gc

    from machine_learning_apache_spark_tpu_torch.parallel import (
        data_parallel_mesh,
        make_data_parallel_step,
        zero,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import StepDispatch
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    mesh = data_parallel_mesh()
    dev = mesh.device
    out = {}
    # The replicated step is timed first and again last: a call's first
    # gang timing can read slower than the rest.
    variants = [("replicated", None), ("zero1", zero.Zero1Config()),
                ("zero1 serial", zero.Zero1Config(overlap=False)),
                *((f"zero1 {w}", zero.Zero1Config(comms_dtype=w)) for w in ZERO1_WIRES),
                ("replicated again", None)]
    for label, config in variants:
        gc.collect()
        torch.cuda.empty_cache()
        model, train_ds, r = _mt_model(torch, dev)
        loss_fn = make_translation_loss(model.cfg.pad_id)
        batches = _rank_batches(train_ds, GANG_MT["batch_size"], rank)
        state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
        if config is None:
            step = make_data_parallel_step(loss_fn, mesh)
        else:
            state = zero.init_sharded(model=model, tx=state.tx, mesh=mesh, config=config)
            step = zero.make_zero1_step(loss_fn, mesh, state)
        _timed_steps(torch, step, state, batches, GANG_WARMUP)
        before = step.comms.stats()
        sec = _timed_steps(torch, step, state, batches, TIMED_STEPS)
        after = step.comms.stats()
        per = {k: (after[k] - before[k]) for k in after if isinstance(after[k], (int, float))}
        if config is None:
            windows = dict(allreduce_ms=1e3 * per["allreduce_window_seconds"] / per["allreduce_steps"])
        else:
            windows = {f"{k}_ms": 1e3 * per[f"{k}_window_seconds"] / per["zero1_steps"]
                       for k in zero.Zero1Comms.KINDS}
            windows["buckets"] = len(state.plan.buckets)
        out[label] = dict(ms=1e3 * sec, **windows)
        del state, step, model
    # The replicated gang through fit's dispatch at 1 and K steps per call.
    gc.collect()
    model, train_ds, r = _mt_model(torch, dev)
    loss_fn = make_translation_loss(model.cfg.pad_id)
    batches = _rank_batches(train_ds, GANG_MT["batch_size"], rank)
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    step_fn = make_data_parallel_step(loss_fn, mesh)
    step_fn.replica(model)
    dispatch = StepDispatch(state, loss_fn, torch.Generator(device=dev).manual_seed(SEED),
                            step_fn=step_fn)

    def timed(k: int, n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            group = [batches[(i * k + j) % len(batches)] for j in range(k)]
            if k == 1:
                dispatch.single(group[0])
            else:
                dispatch.group(group)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (n * k)

    timed(1, GANG_WARMUP)
    out["dispatch"] = {"k1_ms": timed(1, TIMED_STEPS), f"k{ZERO1_K}_ms": timed(ZERO1_K, TIMED_STEPS // ZERO1_K)}
    return out


def zero1_gang_rank(root: str) -> dict:
    """One rank of phase 7e's gang (``Distributor(dp_mode="zero1")``): the
    MT recipe at reference width under ZeRO-1 (the gang's mode), then
    replicated, ZeRO-1 serial, on the bf16 and int8 wires, replicated at
    ``ZERO1_K`` steps per call, and a ZeRO-1 checkpoint resume (1 + 1
    epochs against 2); rank 0 holds every run against the replicated
    one (and the resume against the whole run) in its own process. Then
    the step times, and phase 8's gang timings (``time_gang``). Every
    rank's numbers, in rank order."""
    import os

    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    runs, states = {}, {}
    plan = {
        "zero1": {},
        "replicated": {"MLSPARK_DP_MODE": "replicated"},
        "zero1 serial": {"MLSPARK_ZERO1_OVERLAP": "0"},
        **{f"zero1 {w}": {"MLSPARK_COMMS_DTYPE": w} for w in ZERO1_WIRES},
    }
    for label, env in plan.items():
        runs[label], st = _zero1_recipe(torch, env)
        states[label] = {k: v.detach().cpu() for k, v in st.model.state_dict().items()}
        del st
    runs["replicated k4"], st = _zero1_recipe(
        torch, {"MLSPARK_DP_MODE": "replicated"}, steps_per_call=ZERO1_K)
    states["replicated k4"] = {k: v.detach().cpu() for k, v in st.model.state_dict().items()}
    gang_run = os.environ.get("MLSPARK_GANG_RUN", "zero1")
    for name, sub, epochs in (("first", "split", 1), ("second", "split", 1), ("whole", "whole", 2)):
        os.environ["MLSPARK_GANG_RUN"] = f"{gang_run}-{name}"
        runs[f"ckpt {name}"], st = _zero1_recipe(
            torch, {}, epochs=epochs, checkpoint_dir=os.path.join(root, sub))
        states[f"ckpt {name}"] = {k: v.detach().cpu() for k, v in st.model.state_dict().items()}
        states[f"ckpt {name} moments"] = {k: v.detach().cpu() for k, v in st.opt_state.items()
                                          if getattr(v, "ndim", 0)}
        del st
    gates = {}
    if rank == 0:
        ref = states["replicated"]
        for label in ("zero1", "zero1 serial", "replicated k4", *(f"zero1 {w}" for w in ZERO1_WIRES)):
            gates[label] = _param_gate(torch, states[label], ref, runs[label]["steps"])
        gates["overlap on vs off"] = _param_gate(torch, states["zero1 serial"], states["zero1"],
                                                 runs["zero1"]["steps"])
        gates["resume"] = _param_gate(torch, states["ckpt second"], states["ckpt whole"],
                                      runs["ckpt whole"]["steps"])
        gates["resume moments"] = all(
            bool(torch.equal(states["ckpt second moments"][k], v))
            for k, v in states["ckpt whole moments"].items())
    del states
    times = _zero1_step_times(torch, rank)
    # Phase 8's gang timings, in this gang: its replicated data-parallel
    # step (no ZeRO-1) of each of ``GANG_TIMED``.
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh

    mesh = data_parallel_mesh()
    timing = [_step_times(torch, kind, mesh, rank, mesh.size, mesh.device) for kind in GANG_TIMED]
    return _gather(dict(rank=rank, runs=runs, gates=gates, times=times, timing=timing))


def zero1_slice(torch, hop, card: str) -> dict:
    """Phase 7e: the MT recipe's ZeRO-1 gang against the replicated gang,
    its schedules, wires, memory, collectives and checkpoints, and the
    replicated gang's K steps per call."""
    import shutil

    from machine_learning_apache_spark_tpu_torch import Session
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs

    root = scratch_dir() / "zero1"
    shutil.rmtree(root, ignore_errors=True)
    spark = Session.builder.appName("Zero1Translation").config(
        "spark.executor.instances", str(GANG)).getOrCreate()
    try:
        t0 = time.perf_counter()
        ranks = Distributor(
            num_processes=spark.conf.executor_instances, dp_mode="zero1", timeout=900,
        ).run("chip_smoke:zero1_gang_rank", str(root))
        wall = time.perf_counter() - t0
    finally:
        spark.stop()
    if kill_stray_gangs() != 0:
        fail("the ZeRO-1 gang left a stray process group")
    r0 = ranks[0]
    runs, gates = r0["runs"], r0["gates"]
    rep, z = runs["replicated"], runs["zero1"]
    steps = z["steps"]
    log(f"  Session -> Distributor(dp_mode='zero1') -> train_translator, {GANG} ranks x batch "
        f"{GANG_MT['batch_size']} (dropout 0): {wall:.2f} s spawn to result (13 recipe runs, "
        f"the step times and phase 8's gang timings); state {z['type']} (replicated run: {rep['type']}), {steps} steps")
    if z["type"] != "Zero1State" or rep["type"] != "TrainState":
        fail(f"the gang's recipe ran {z['type']} under dp_mode='zero1' and {rep['type']} replicated")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(z["step_losses"], rep["step_losses"]))
    g = gates["zero1"]
    log(f"    ZeRO-1 against the replicated gang (same global batches): step losses max relative "
        f"difference {loss_rel:.3e} (gate {GANG_RTOL}); parameters per tensor max relative "
        f"{g['max_rel']:.3e} (gate {GANG_RTOL}), key biases {g['key_bias_abs']:.3e} (bound "
        f"{g['key_bias_bound']:.3e}); the same bits: {g['same_bits']}")
    if loss_rel > GANG_RTOL or not g["ok"]:
        fail(f"the ZeRO-1 gang differs from the replicated gang: losses {loss_rel:.3e}, {g}")
    ov = gates["overlap on vs off"]
    log(f"    overlap on vs off: step losses equal {runs['zero1 serial']['step_losses'] == z['step_losses']}, "
        f"parameters the same bits {ov['same_bits']}")
    if not ov["same_bits"] or runs["zero1 serial"]["step_losses"] != z["step_losses"]:
        fail("ZeRO-1 with overlap on and off trained different bits")
    for w in ZERO1_WIRES:
        run = runs[f"zero1 {w}"]
        first, last = np.mean(run["step_losses"][:4]), np.mean(run["step_losses"][-4:])
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["step_losses"], z["step_losses"]))
        gw = gates[f"zero1 {w}"]
        log(f"    {w} wire: step losses {first:.5f} -> {last:.5f} (first / last 4), max relative "
            f"difference to the float32 wire {rel:.3e}"
            + (f" (gate {ZERO1_BF16_LOSS_RTOL:.3e})" if w == "bfloat16" else "")
            + f"; parameters per tensor max relative {gw['max_rel']:.3e} to the replicated gang, "
            f"largest key-bias difference {gw['key_bias_abs']:.3e}; wire bytes {run['comms'].get('reduce_scatter_bytes')} "
            f"reduce-scattered over {run['comms'].get('reduce_scatter_calls')} buckets x steps")
        if not last < first or (w == "bfloat16" and rel > ZERO1_BF16_LOSS_RTOL):
            fail(f"the {w} wire's losses: {first} -> {last}, {rel:.3e} from the float32 wire")
    n_params = z["layout"]["total"]
    for rk in ranks:
        zr, rr = rk["runs"]["zero1"], rk["runs"]["replicated"]
        want_bytes = 2 * 4 * zr["layout"]["shard_len"] + 4
        log(f"    rank {rk['rank']}: optimizer bytes {zr['opt_bytes']} ({zr['opt_bytes'] / 2**20:.3f} MiB; "
            f"replicated {rr['opt_bytes']}, {rr['opt_bytes'] / 2**20:.3f} MiB, ratio "
            f"{zr['opt_bytes'] / rr['opt_bytes']:.4f}); peak max_memory_allocated {zr['peak'] / 2**20:.1f} "
            f"MiB (replicated {rr['peak'] / 2**20:.1f}); launches ZeRO-1 {zr['launches']}, replicated "
            f"{rr['launches']}; divergence {zr['divergence']!r} [{card}]")
        if zr["opt_bytes"] != want_bytes:
            fail(f"rank {rk['rank']}'s ZeRO-1 optimizer holds {zr['opt_bytes']} bytes, not {want_bytes}")
        for name in TENSOR_CORE_KERNELS:
            if zr["launches"][name] != rr["launches"][name] or zr["launches"][name] < 3 * zr["steps"]:
                fail(f"rank {rk['rank']}: {name} launched {zr['launches'][name]} times under ZeRO-1, "
                     f"{rr['launches'][name]} replicated")
    gk = gates["replicated k4"]
    k4 = runs["replicated k4"]
    log(f"    replicated gang at {ZERO1_K} steps per call against 1: step losses equal "
        f"{k4['step_losses'] == rep['step_losses']}, parameters the same bits {gk['same_bits']}")
    if k4["step_losses"] != rep["step_losses"] or not gk["same_bits"]:
        fail(f"the replicated gang at {ZERO1_K} steps per call trained other bits than at 1")
    first, second, whole = runs["ckpt first"], runs["ckpt second"], runs["ckpt whole"]
    same_losses = first["step_losses"] + second["step_losses"] == whole["step_losses"]
    log(f"    ZeRO-1 checkpoints (ckpt_r<rank>, each rank its flat moment shard): 1 + 1 epochs "
        f"(resumed from step {second['resumed']}) against 2: step losses equal {same_losses}, "
        f"parameters the same bits {gates['resume']['same_bits']}, moments the same bits "
        f"{gates['resume moments']}")
    if second["resumed"] != first["steps"] or not same_losses or not gates["resume"]["same_bits"] \
            or not gates["resume moments"]:
        fail("the ZeRO-1 gang's 1 + 1 epochs did not train the bits of 2")
    for rk in ranks:
        t = rk["times"]
        log(f"    rank {rk['rank']} step times (host-timed, {TIMED_STEPS} after {GANG_WARMUP}; "
            f"{n_params} parameters, 16 a replica): "
            + "; ".join(f"{label} {v['ms']:.3f} ms/step ("
                        + ", ".join(f"{k} {x:.3f}" if isinstance(x, float) else f"{k} {x}"
                                    for k, x in v.items() if k != "ms") + ")"
                        for label, v in t.items() if label != "dispatch")
            + f"; fit's dispatch K = 1 {t['dispatch']['k1_ms']:.3f}, K = {ZERO1_K} "
            f"{t['dispatch'][f'k{ZERO1_K}_ms']:.3f} ms/step [{card}]")
    return dict(wall=wall, ranks=ranks)


# -- phase 7f: tensor parallelism on the model axis ------------------------------

TP_GANG = 4
TP_MESHES = {
    "a {data: 4}": {"data": 4},
    "b {data: 1, model: 4}": {"data": 1, "model": 4},
    "c {data: 2, model: 2}": {"data": 2, "model": 2},
}
TP_RTOL = 1e-4
TP_BF16_LOSS_RTOL = 2 * 2.0 ** -8
# Flash forward / dQ / dK/dV launches per rank over the fixture's first
# epoch with its eval: 3 sites x 12 steps, + 3 sites x 3 eval batches.
TP_LAUNCHES = (45, 36, 36)
TP_WARMUP, TP_TIMED = 2, 5


def tp_sites(torch, dev, src, trg_in) -> dict:
    """The training sites at the shapes a rank hands the kernels under
    tensor parallelism: ``[32, 4, ..]`` (M = 2 of a full batch), ``[16,
    4, ..]`` (M = 2 of a data half) and ``[32, 2, ..]`` (M = 4)."""
    out = {}
    for rows, heads in ((32, 4), (16, 4), (32, 2)):
        sites = training_sites(torch, np.random.default_rng(SEED + rows + heads), dev,
                               src[:rows], trg_in[:rows], heads=heads)
        out |= {f"TP [{rows},{heads}] {k}": v for k, v in sites.items()}
    return out


def _data_rows(batch, index: int, ways: int):
    """Data index ``index``'s contiguous rows of a global batch."""
    n = len(batch[0]) // ways
    return tuple(np.asarray(a)[index * n:(index + 1) * n] for a in batch)


def _tp_fit(torch, axes: dict, batches, val_batches, *, epochs=1, ckpt=None, resume=False,
            **fit_kw) -> tuple[dict, object]:
    """One ``fit(mesh=)`` + ``evaluate(mesh=)`` of the reference MT model
    in this rank on ``axes``, each data index on its rows of the global
    batches: step losses, launches, peak, optimizer bytes, comms."""
    import gc

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh, zero
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import CheckpointManager
    from machine_learning_apache_spark_tpu_torch.train.loop import evaluate, fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    mesh = make_mesh(axes)
    d, ways = mesh.index("data"), mesh.axis_size("data")
    model, _, r = _mt_model(torch, mesh.device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hop.reset_launches()
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    mgr = CheckpointManager(ckpt) if ckpt else None
    try:
        res = fit(state, make_translation_loss(model.cfg.pad_id),
                  [_data_rows(b, d, ways) for b in batches], epochs=epochs, mesh=mesh,
                  log_every=0, rng=torch.Generator().manual_seed(r.seed), checkpointer=mgr,
                  resume=resume, **fit_kw)
    finally:
        if mgr is not None:
            mgr.close()
    metrics = evaluate(res.state, make_translation_loss(model.cfg.pad_id, train=False),
                       [_data_rows(b, d, ways) for b in val_batches], mesh=mesh, emit=lambda s: None)
    torch.cuda.synchronize()
    return dict(
        step_losses=res.step_losses, launches=dict(hop.LAUNCHES),
        peak=torch.cuda.max_memory_allocated(), opt_bytes=zero.opt_state_bytes_per_chip(res.state),
        comms=res.comms, test_loss=metrics["test_loss"], steps=res.state.step,
        type=type(res.state).__name__, resumed=res.resumed_step,
        shard_len=getattr(getattr(res.state, "plan", None), "shard_len", None),
    ), res.state


def _full_params(torch, state, keep: bool = True) -> dict | None:
    """``state``'s parameters gathered over the model axis (a collective:
    every rank calls it), on the host where ``keep``."""
    from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import gather_params

    full = gather_params(state.model)
    return {k: v.detach().cpu() for k, v in full.items()} if keep else None


def _moments_match(torch, zstate, ref) -> bool:
    """Whether this rank's ZeRO-1 moment shards are, bit for bit, the
    slices of the replicated hybrid state ``ref``'s moments its plan
    assigns it."""
    ok = True
    for key in ("exp_avg", "exp_avg_sq"):
        by_param = [ref.optimizer.state[p][key] for p in ref.params]
        flat = torch.zeros(zstate.plan.padded, device=zstate.shard.device)
        for i, o, n in zip(zstate.order, zstate.plan.offsets, zstate.plan.sizes):
            flat[o:o + n] = by_param[i].reshape(-1)
        want = torch.cat([flat[zstate.bucket_span(k)[0]] for k in range(len(zstate.plan.buckets))])
        ok = ok and bool(torch.equal(want, zstate.opt_state[key]))
    return ok


def _tp_step_times(torch, axes: dict, batches, config=None) -> dict:
    """This rank's step on ``axes`` (``config``: ZeRO-1's), ``TP_WARMUP``
    steps then ``TP_TIMED`` timed, host-timed with the card synchronised
    at both ends; the model axis's all-reduce window and bytes per step
    and the data axis's gradient window per step."""
    import gc

    from machine_learning_apache_spark_tpu_torch.parallel import (
        make_data_parallel_step,
        make_mesh,
        tensor_parallel,
        zero,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(axes)
    d, ways = mesh.index("data"), mesh.axis_size("data")
    model, _, r = _mt_model(torch, mesh.device)
    loss_fn = make_translation_loss(model.cfg.pad_id)
    local = [to_device(_data_rows(b, d, ways), mesh.device) for b in batches]
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    if config is None:
        state = tensor_parallel.shard_state(state, mesh)
        step = make_data_parallel_step(loss_fn, mesh)
    else:
        state = zero.init_sharded(model=model, tx=state.tx, mesh=mesh, config=config)
        step = zero.make_zero1_step(loss_fn, mesh, state)
    _timed_steps(torch, step, state, local, TP_WARMUP)
    tp_axis = getattr(state.model, "tp_axis", None)
    before = (step.comms.stats(), tp_axis.comms.stats() if tp_axis else {})
    sec = _timed_steps(torch, step, state, local, TP_TIMED)
    after = (step.comms.stats(), tp_axis.comms.stats() if tp_axis else {})
    per = [{k: a[k] - b.get(k, 0) for k in a if isinstance(a[k], (int, float))}
           for a, b in zip(after, before)]
    out = dict(ms=1e3 * sec)
    if tp_axis is not None:
        out["tp_allreduce_ms"] = 1e3 * per[1]["tp_allreduce_window_seconds"] / TP_TIMED
        out["tp_allreduce_bytes"] = per[1]["tp_allreduce_bytes"] / TP_TIMED
        out["tp_allreduce_calls"] = per[1]["tp_allreduce_calls"] / TP_TIMED
    if config is None and ways > 1:
        out["data_allreduce_ms"] = 1e3 * per[0]["allreduce_window_seconds"] / TP_TIMED
    elif config is not None:
        out |= {f"data_{k}_ms": 1e3 * per[0][f"{k}_window_seconds"] / TP_TIMED
                for k in zero.Zero1Comms.KINDS}
    del state, step, model
    return out


def _rel_to(got: dict, want: dict) -> float:
    """The largest per-tensor max |got - want| / max |want|."""
    return max(float((got[k].double() - v.double()).abs().max() / v.double().abs().max().clamp_min(1e-30))
               for k, v in want.items())


def _same_bits(torch, got: dict, want: dict) -> bool:
    return all(bool(torch.equal(got[k], v)) for k, v in want.items())


def tp_gang_rank(root: str, batches, val_batches, serve_prompts, ref_params) -> dict:
    """One rank of phase 7f's 4-rank gang: runs (a)-(f) (see the module
    docstring), then the step times on each mesh. Every rank's numbers,
    in rank order; rank 0's gates hold the gathered parameters against
    one process's (``ref_params``) and against each other, and its
    served requests."""
    import os

    import torch
    import torch.distributed as dist

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import tensor_parallel as tp
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import TopologyMismatch

    rank = dist.get_rank()
    runs, params, gates = {}, {}, {}
    c_label = "c {data: 2, model: 2}"
    for label, axes in TP_MESHES.items():
        runs[label], st = _tp_fit(torch, axes, batches, val_batches)
        params[label] = _full_params(torch, st, keep=rank == 0)
        if label == c_label:
            ref_state = st
    zero_runs = {"d ZeRO-1 fp32": dict(dp_overlap=True), "d ZeRO-1 fp32 serial": dict(dp_overlap=False),
                 "d ZeRO-1 bf16 wire": dict(dp_comms_dtype="bfloat16")}
    for label, kw in zero_runs.items():
        runs[label], st = _tp_fit(torch, TP_MESHES[c_label], batches, val_batches, dp_mode="zero1",
                                  dp_bucket_bytes=4 * 2**20, **kw)
        params[label] = _full_params(torch, st, keep=rank == 0)
        if "bf16" not in label:
            gates[f"{label} moments"] = _moments_match(torch, st, ref_state)
        del st
    del ref_state
    for name, sub, epochs, resume in (("e first", "split", 1, False), ("e second", "split", 2, True),
                                      ("e whole", "whole", 2, False)):
        ckpt = os.path.join(root, sub, f"ckpt_r{rank}")
        runs[name], st = _tp_fit(torch, TP_MESHES[c_label], batches, val_batches, epochs=epochs,
                                 ckpt=ckpt, resume=resume)
        params[name] = _full_params(torch, st, keep=rank == 0)
        del st
    try:
        _tp_fit(torch, TP_MESHES["b {data: 1, model: 4}"], batches, val_batches, epochs=3,
                ckpt=os.path.join(root, "split", f"ckpt_r{rank}"), resume=True)
        gates["crossed resume"] = "no error"
    except TopologyMismatch as e:
        gates["crossed resume"] = str(e)
    # (f) the recipe with model_parallel=2 on {data: 2, model: 2}.
    hop.reset_launches()
    out = train_translator(data_root=str(FIXTURES), batch_size=16, dropout=0.0, log_every=0,
                           model_parallel=2, _return_state=True, _return_translator=True)
    recipe_launches = dict(hop.LAUNCHES)
    sharded, translator = out["state"].model, out["translator"]
    gathered = tp.gather_params(sharded)
    concat = True
    for name, p in sharded.named_parameters():
        if not getattr(p, "shards", ()):
            concat = concat and bool(torch.equal(gathered[name], p.detach()))
            continue
        ((axis, dim, parts),) = p.shards
        pieces = axis.pieces(p.detach())
        concat = concat and bool(torch.equal(pieces[axis.index], p.detach()))
        concat = concat and bool(torch.equal(gathered[name], tp.unshard(pieces, dim, parts)))
    runs["f recipe"] = dict(step_losses=out["fit_result"].step_losses, launches=recipe_launches,
                            test_loss=out["test_loss"], logit_pad=sharded.cfg.logit_pad,
                            mesh=dict(out["state"].mesh.shape), concat=concat,
                            translator_sharded=translator.model.tp_axis is not None)
    served = None
    if rank == 0:
        served = serve_once(torch, hop, translator, serve_prompts, "TP gathered paged fp32",
                            kv_dtype="float32", **SERVE)
        one = translator(serve_prompts, max_new_tokens=SERVE["max_new_tokens"])
        served = dict(agreement=agreement(served["outs"], one)[0], programs=served["programs"],
                      replays=served["replays"], launches=served["launches"], wall=served["wall"])
        for label in TP_MESHES:
            gates[f"{label} params rel"] = _rel_to(params[label], ref_params)
        for label in ("d ZeRO-1 fp32", "d ZeRO-1 fp32 serial"):
            gates[f"{label} same bits"] = _same_bits(torch, params[label], params[c_label])
        gates["e same bits"] = _same_bits(torch, params["e second"], params["e whole"])
    del out, sharded, translator, gathered, params
    times = {label: _tp_step_times(torch, axes, batches) for label, axes in TP_MESHES.items()}
    from machine_learning_apache_spark_tpu_torch.parallel import zero

    times["d ZeRO-1 fp32"] = _tp_step_times(torch, TP_MESHES[c_label], batches,
                                            zero.Zero1Config(bucket_bytes=4 * 2**20))
    times["d ZeRO-1 bf16 wire"] = _tp_step_times(
        torch, TP_MESHES[c_label], batches,
        zero.Zero1Config(bucket_bytes=4 * 2**20, comms_dtype="bfloat16"))
    return _gather(dict(rank=rank, runs=runs, gates=gates, times=times, served=served))


def _tp_reference(torch, batches, val_batches) -> dict:
    """One process on the card over the same global batches: step losses,
    parameters, the eval loss, the replicated optimizer bytes and the
    step time (one process, host-timed as the gang's)."""
    from machine_learning_apache_spark_tpu_torch.parallel import zero
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import evaluate, fit, make_train_step, to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    dev = torch.device("cuda")
    model, _, r = _mt_model(torch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    res = fit(state, make_translation_loss(model.cfg.pad_id), batches, epochs=1,
              rng=torch.Generator().manual_seed(r.seed), log_every=0)
    metrics = evaluate(state, make_translation_loss(model.cfg.pad_id, train=False), val_batches,
                       emit=lambda s: None)
    out = dict(step_losses=res.step_losses, test_loss=metrics["test_loss"],
               params={k: v.detach().cpu() for k, v in model.state_dict().items()},
               opt_bytes=zero.opt_state_bytes(state.optimizer), peak=torch.cuda.max_memory_allocated(),
               n_params=sum(p.numel() for p in model.parameters()))
    model, _, r = _mt_model(torch, dev)
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    step = make_train_step(make_translation_loss(model.cfg.pad_id))
    local = [to_device(b, dev) for b in batches]
    _timed_steps(torch, step, state, local, TP_WARMUP)
    out["ms"] = 1e3 * _timed_steps(torch, step, state, local, TP_TIMED)
    return out


def _max_rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def tp_slice(torch, hop, card: str, dev) -> dict:
    """Phase 7f: the training kernels at the TP shapes, the one-process
    reference, then one 4-rank gang over every mesh (``tp_gang_rank``)
    and its gates."""
    import shutil

    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k

    t_phase = time.perf_counter()
    src_pipe, _, train_ds = fixture_data()
    batches = train_batches(train_ds, 12)
    src0, trg0 = batches[0]
    errs = check_training_kernels(torch, hop, tp_sites(torch, dev, src0, trg0[:, :-1]), dev, edges=False)
    val_loader, _ = eval_loader()
    val_batches = list(val_loader)
    serve_prompts = [s for s, _ in load_multi30k(str(FIXTURES), "valid")][:N_REQUESTS]
    ref = _tp_reference(torch, batches, val_batches)
    log(f"  one process on the same {len(batches)} global batches of 32: {ref['ms']:.3f} ms/step "
        f"(host-timed over {TP_TIMED} after {TP_WARMUP}), peak {ref['peak'] / 2**20:.1f} MiB, "
        f"{ref['n_params']} parameters, Adam state {ref['opt_bytes']} bytes [{card}]")
    root = scratch_dir() / "tp"
    shutil.rmtree(root, ignore_errors=True)
    # The rank function runs in the shared gang of phases 7f-7l
    # (``run_shared_gang``): this phase's time there comes back as ``wall``.
    t_pre = time.perf_counter() - t_phase
    ranks, wall = yield "chip_smoke:tp_gang_rank", (str(root), batches, val_batches, serve_prompts, ref["params"])
    t_post = time.perf_counter()
    r0 = ranks[0]
    runs, gates = r0["runs"], r0["gates"]
    log(f"  Session -> Distributor, {TP_GANG} ranks on one card over gloo, the shared gang of phases "
        f"7f-7l: {wall:.2f} s of it ran this phase (meshes a-f and the step times)")
    for label in TP_MESHES:
        rel = _max_rel(runs[label]["step_losses"], ref["step_losses"])
        pmax = gates[f"{label} params rel"]
        log(f"    {label}: step losses max relative difference to one process {rel:.3e} (gate "
            f"{TP_RTOL}), parameters largest relative difference {pmax:.3e}, eval loss "
            f"{runs[label]['test_loss']:.6f} (one process {ref['test_loss']:.6f})")
        if rel > TP_RTOL:
            fail(f"{label}: step losses {rel:.3e} from one process")
    c = "c {data: 2, model: 2}"
    for label in ("d ZeRO-1 fp32", "d ZeRO-1 fp32 serial"):
        same = gates[f"{label} same bits"]
        moments = [rk["gates"][f"{label} moments"] for rk in ranks]
        log(f"    {label} against (c): step losses equal {runs[label]['step_losses'] == runs[c]['step_losses']}, "
            f"parameters the same bits {same}, each rank's moment shards the slices of (c)'s: {moments}")
        if not same or runs[label]["step_losses"] != runs[c]["step_losses"] or not all(moments):
            fail(f"{label} did not train the bits of the replicated hybrid mesh")
    rel = _max_rel(runs["d ZeRO-1 bf16 wire"]["step_losses"], runs["d ZeRO-1 fp32"]["step_losses"])
    log(f"    d ZeRO-1 bf16 wire: step losses within {rel:.3e} of the float32 wire's (gate {TP_BF16_LOSS_RTOL:.3e})")
    if rel > TP_BF16_LOSS_RTOL:
        fail(f"the hybrid bf16 wire's losses {rel:.3e} from the float32 wire's")
    for rk in ranks:
        z, zr = rk["runs"]["d ZeRO-1 fp32"], rk["runs"][c]
        want = 2 * 4 * z["shard_len"] + 4
        log(f"    rank {rk['rank']}: optimizer bytes ZeRO-1 {z['opt_bytes']} (2 x 4 x {z['shard_len']} + 4; "
            f"replicated hybrid {zr['opt_bytes']}, one process {ref['opt_bytes']}, bound one process / 4 + 64 = "
            f"{ref['opt_bytes'] / 4 + 64:.0f}); peak max_memory_allocated "
            + ", ".join(f"{k.split()[0]} {v['peak'] / 2**20:.1f}" for k, v in rk["runs"].items()
                        if k[0] in "abcd") + f" MiB (one process {ref['peak'] / 2**20:.1f}) [{card}]")
        if z["opt_bytes"] != want or z["opt_bytes"] > ref["opt_bytes"] / 4 + 64:
            fail(f"rank {rk['rank']}'s hybrid ZeRO-1 optimizer holds {z['opt_bytes']} bytes")
        for label, run in rk["runs"].items():
            if label[0] not in "abcdf" or label == "e first":
                continue
            got = tuple(run["launches"][n] for n in TENSOR_CORE_KERNELS)
            if got != TP_LAUNCHES:
                fail(f"rank {rk['rank']} {label}: flash launches {got}, not {TP_LAUNCHES}")
    log(f"    every rank, every run (a-d, f): flash forward / dQ / dK/dV launches {TP_LAUNCHES}")
    first, second, whole = runs["e first"], runs["e second"], runs["e whole"]
    same = gates["e same bits"]
    log(f"    e checkpoints on (c): 1 + 1 epochs (resumed from step {second['resumed']}) against 2: "
        f"step losses equal {first['step_losses'] + second['step_losses'] == whole['step_losses']}, "
        f"parameters the same bits {same}; resuming them on (b): {gates['crossed resume'][:160]}")
    if second["resumed"] != first["steps"] or not same or \
            first["step_losses"] + second["step_losses"] != whole["step_losses"]:
        fail("the hybrid mesh's 1 + 1 epochs did not train the bits of 2")
    if "written by a different topology" not in gates["crossed resume"]:
        fail("resuming (c)'s checkpoints on (b) did not raise TopologyMismatch")
    f, served = runs["f recipe"], r0["served"]
    log(f"    f train_translator(model_parallel=2) on {f['mesh']}: logit_pad {f['logit_pad']}, eval loss "
        f"{f['test_loss']:.6f}, gathered parameters the shards concatenated {all(rk['runs']['f recipe']['concat'] for rk in ranks)}, "
        f"Translator unsharded {not f['translator_sharded']}; its paged engine: {len(serve_prompts)} "
        f"prompts in {served['wall']:.3f} s, agreement with its one-shot decode {served['agreement']:.6f} "
        f"(gate >= {AGREEMENT_MIN}), {served['programs']} programs, recompiles_after_warmup 0")
    if not all(rk["runs"]["f recipe"]["concat"] for rk in ranks) or f["translator_sharded"] \
            or f["mesh"] != {"data": 2, "model": 2}:
        fail("the recipe's gathered Translator is not the shards concatenated")
    if served["agreement"] < AGREEMENT_MIN:
        fail(f"the gathered Translator's paged engine agrees {served['agreement']:.4f} with its one-shot decode")
    for rk in ranks:
        log(f"    rank {rk['rank']} step times (host-timed, {TP_TIMED} after {TP_WARMUP}; one process "
            f"{ref['ms']:.3f} ms): " + "; ".join(
                f"{label} {t['ms']:.3f} ms/step (" + ", ".join(
                    f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in t.items() if k != "ms") + ")"
                for label, t in rk["times"].items()) + f" [{card}]")
    log(f"  phase 7f took {t_pre + wall + time.perf_counter() - t_post:.1f} s")
    return dict(wall=wall, ranks=ranks, ref={k: ref[k] for k in ("ms", "peak", "opt_bytes", "n_params")},
                errs=errs, served=served)


# -- phase 7g: pipeline parallelism on the pipeline axis --------------------------

PP_GANG = 4
# label: (mesh axes, num_layers, microbatches). The reference MT model's
# widths; num_layers = S, the least depth the pipeline admits.
PP_MESHES = {
    "a {pipeline: 4} M=4": ({"pipeline": 4}, 4, 4),
    "b {pipeline: 4} M=8": ({"pipeline": 4}, 4, 8),
    "c {data: 2, pipeline: 2} M=2": ({"data": 2, "pipeline": 2}, 2, 2),
}
PP_C = "c {data: 2, pipeline: 2} M=2"
PP_RTOL = 1e-4
PP_WARMUP, PP_TIMED = 1, 3
# Global batches of 32 a fit on each mesh (a-d) and in its references: the
# first 8 of the fixture epoch's 12, two full groups at 4 steps per call;
# the recipe (e) still trains whole epochs.
PP_BATCHES = 8
# train_translator(pipeline_parallel=2) in the 4-rank gang: {data: 2,
# pipeline: 2}, 16 rows a data replica (global batch 32), 4 microbatches.
PP_RECIPE = dict(data_root=str(FIXTURES), batch_size=16, dropout=0.0, log_every=0, num_layers=2,
                 pipeline_parallel=2, pipeline_microbatches=4, remat=True)
PP_EVAL_BATCHES = 3  # the 80 validation pairs: 32, 32, 16 (halves under a data axis)


def pp_sites(torch, dev, src, trg_in, dtype=None) -> dict:
    """The training sites at the microbatch shapes the pipeline hands the
    kernels: ``[8, 8, ..]`` (M = 4 of a 32-row batch, M = 2 of a 16-row
    data half) and ``[4, 8, ..]`` (M = 8 of 32, M = 4 of 16)."""
    out = {}
    for rows in (8, 4):
        sites = training_sites(torch, np.random.default_rng(SEED + 200 + rows), dev,
                               src[:rows], trg_in[:rows], dtype=dtype)
        out |= {f"PP [{rows},8] {k}": v for k, v in sites.items()}
    return out


def _pp_model(torch, dev, layers: int, dtype=None, *, max_len: int | None = None,
              vocab: int | None = None, remat: bool = False, moe_experts: int = 0):
    """The reference MT model at ``layers`` layers on the fixture
    vocabularies (dropout 0), built as ``_mt_model`` builds it; ``max_len``,
    ``vocab`` (both vocabularies) and ``remat`` for the long-context step,
    ``moe_experts`` (capacity factor 1.25) for the expert axis."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import TranslationRecipe

    src_pipe, trg_pipe, _ = fixture_data()
    r = TranslationRecipe(**GANG_MT)
    cfg = TransformerConfig(
        src_vocab_size=vocab or len(src_pipe.vocab), trg_vocab_size=vocab or len(trg_pipe.vocab),
        d_model=r.d_model, ffn_hidden=r.ffn_hidden, num_heads=r.num_heads, num_layers=layers,
        dropout=r.dropout, max_len=max_len or r.max_len, remat=remat, dtype=dtype or torch.float32,
        moe_experts=moe_experts,
    )
    return Transformer(cfg, generator=torch.Generator().manual_seed(SEED)).to(dev), r


def _pp_state_equal(torch, mesh, state) -> bool:
    """Whether this rank's parameters and moments are rank 0's, bit for bit
    (each broadcast from rank 0 over the whole mesh and compared)."""
    same = True
    tensors = [*state.model.parameters()]
    for st in state.optimizer.state.values():
        tensors += [v for v in st.values() if torch.is_tensor(v) and v.dim()]
    for t in tensors:
        theirs = t.detach().clone()
        mesh.broadcast_(theirs, src=0)
        same = same and bool(torch.equal(theirs, t.detach()))
    return same


def _pp_fit(torch, axes: dict, layers: int, n_micro: int, batches, val_batches, *, dtype=None,
            steps_per_call: int = 1) -> tuple[dict, dict | None]:
    """One pipelined ``fit(mesh=)`` + ``evaluate(mesh=)`` of the reference
    MT model in this rank, each data index on its rows of the global
    batches: step losses, launches, peak, comms, whether every rank holds
    the same state; and rank 0's parameters on the host."""
    import gc

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_pipeline_translation_loss,
        make_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import evaluate, fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    mesh = make_mesh(axes)
    d, ways = mesh.index("data"), mesh.axis_size("data")
    model, r = _pp_model(torch, mesh.device, layers, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hop.reset_launches()
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    res = fit(state, make_pipeline_translation_loss(model.cfg.pad_id, mesh, n_micro=n_micro),
              [_data_rows(b, d, ways) for b in batches], epochs=1, mesh=mesh, log_every=0,
              rng=torch.Generator().manual_seed(r.seed), steps_per_call=steps_per_call)
    metrics = evaluate(res.state, make_translation_loss(model.cfg.pad_id, train=False),
                       [_data_rows(b, d, ways) for b in val_batches], mesh=mesh, emit=lambda s: None)
    torch.cuda.synchronize()
    out = dict(step_losses=res.step_losses, launches=dict(hop.LAUNCHES),
               peak=torch.cuda.max_memory_allocated(), comms=res.comms,
               test_loss=metrics["test_loss"], steps=res.state.step,
               ranks_equal=_pp_state_equal(torch, mesh, res.state))
    params = ({k: v.detach().cpu() for k, v in model.state_dict().items()}
              if mesh.rank == 0 else None)
    return out, params


def _pp_step_times(torch, axes: dict, layers: int, n_micro: int, batches) -> dict:
    """This rank's pipelined step, ``PP_WARMUP`` steps then ``PP_TIMED``
    timed, host-timed with the card synchronised at both ends; the hops'
    bytes and windows per step and the gradient sync's, and the peak."""
    import gc

    from machine_learning_apache_spark_tpu_torch.parallel import make_data_parallel_step, make_mesh
    from machine_learning_apache_spark_tpu_torch.parallel.pipeline_parallel import pipeline_line
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_pipeline_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(axes)
    d, ways = mesh.index("data"), mesh.axis_size("data")
    model, r = _pp_model(torch, mesh.device, layers)
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    step = make_data_parallel_step(
        make_pipeline_translation_loss(model.cfg.pad_id, mesh, n_micro=n_micro), mesh)
    step.replica(model)
    local = [to_device(_data_rows(b, d, ways), mesh.device) for b in batches]
    line = pipeline_line(mesh)
    torch.cuda.reset_peak_memory_stats()
    _timed_steps(torch, step, state, local, PP_WARMUP)
    before = (step.comms.stats(), line.comms.stats())
    sec = _timed_steps(torch, step, state, local, PP_TIMED)
    after = (step.comms.stats(), line.comms.stats())
    per = [{k: (a[k] - b[k]) / PP_TIMED for k in a} for a, b in zip(after, before)]
    out = dict(ms=1e3 * sec, peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               grad_sync_ms=1e3 * per[0]["allreduce_window_seconds"],
               grad_sync_bytes=per[0]["allreduce_bytes"])
    for kind in ("pp_send", "pp_recv", "pp_bcast", "pp_allreduce"):
        out[f"{kind}_ms"] = 1e3 * per[1][f"{kind}_window_seconds"]
        out[f"{kind}_bytes"] = per[1][f"{kind}_bytes"]
    del state, step, model
    return out


def pp_gang_rank(root: str, batches, val_batches, prompts) -> dict:
    """One rank of phase 7g's 4-rank gang: the fits on each mesh (a-c),
    (c) at 4 steps per call and at bf16, the recipe with checkpoints and
    remat (1 + 1 epochs and 2), the ZeRO-1 refusal, then the step times.
    Every rank's numbers, in rank order; rank 0's parameters of each run
    and its translator's tokens on ``prompts``."""
    import os

    import torch
    import torch.distributed as dist

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_pipeline_translation_loss,
        train_translator,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    rank = dist.get_rank()
    runs, params = {}, {}
    for label, (axes, layers, m) in PP_MESHES.items():
        runs[label], params[label] = _pp_fit(torch, axes, layers, m, batches, val_batches)
    axes, layers, m = PP_MESHES[PP_C]
    runs["c K=4"], k4 = _pp_fit(torch, axes, layers, m, batches, val_batches, steps_per_call=4)
    same = {"c K=4": k4 is None or all(bool(torch.equal(k4[k], v)) for k, v in params[PP_C].items())}
    runs["d bf16"], _ = _pp_fit(torch, axes, layers, m, batches, val_batches, dtype=torch.bfloat16)
    recipe, kept = {}, {}
    gang_run = os.environ.get("MLSPARK_GANG_RUN", "pp")
    for name, sub, epochs in (("whole", "whole", 2), ("first", "split", 1), ("second", "split", 1)):
        # Each call its own run: one run id would make the second call
        # finish the first's run (a retried attempt) instead of adding one.
        os.environ["MLSPARK_GANG_RUN"] = f"{gang_run}-{name}"
        hop.reset_launches()
        out = train_translator(checkpoint_dir=os.path.join(root, sub), epochs=epochs,
                               _return_state=True, _return_translator=True, **PP_RECIPE)
        res, state = out["fit_result"], out["state"]
        recipe[name] = dict(step_losses=res.step_losses, launches=dict(hop.LAUNCHES),
                            steps=state.step, resumed=out.get("resumed_from_step"),
                            mesh=dict(state.mesh.shape), test_loss=out["test_loss"],
                            ranks_equal=_pp_state_equal(torch, state.mesh, state),
                            translator_is_model=out["translator"].model is state.model)
        if rank == 0 and name != "first":
            kept[name] = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        if name == "whole" and rank == 0:
            recipe["tokens"] = out["translator"](list(prompts), max_new_tokens=32)
        del out, res, state
    if rank == 0:
        same["recipe"] = all(bool(torch.equal(kept["second"][k], v)) for k, v in kept["whole"].items())
        params["recipe whole"] = kept["whole"]
    del kept
    mesh = make_mesh(PP_MESHES[PP_C][0])
    model, r = _pp_model(torch, mesh.device, 2)
    try:
        fit(TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate)),
            make_pipeline_translation_loss(model.cfg.pad_id, mesh), batches, epochs=1, mesh=mesh,
            dp_mode="zero1", log_every=0)
        zero1 = "no error"
    except ValueError as e:
        zero1 = str(e)
    del model
    times = {label: _pp_step_times(torch, axes, layers, m, batches)
             for label, (axes, layers, m) in PP_MESHES.items()}
    ranks = _gather(dict(rank=rank, runs=runs, recipe={k: v for k, v in recipe.items() if k != "tokens"},
                         times=times))
    return dict(ranks=ranks, params=params if rank == 0 else None, zero1=zero1,
                tokens=recipe.get("tokens"), same=same)


def _microbatched_loss(torch, pad_id: int, chunks: int, drop: bool = False):
    """The translation loss over ``chunks`` microbatches of the batch, each
    through its own forward (so the gradients add up microbatch by
    microbatch, as on a pipeline), the token mean of the whole batch.
    With ``drop`` the last microbatch's logits are detached: the loss is
    the same, its gradient lacks that microbatch's part (the size of fault
    the gates must see)."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import token_losses
    from machine_learning_apache_spark_tpu_torch.train.losses import masked_mean

    def loss_fn(model, batch, rng):
        src, trg = batch
        parts = [model(s, t[:, :-1]) for s, t in zip(src.chunk(chunks), trg.chunk(chunks))]
        if drop:
            parts[-1] = parts[-1].detach()
        logits = torch.cat(parts)
        return masked_mean(token_losses(model, logits, trg[:, 1:]), trg[:, 1:], pad_id), {}

    return loss_fn


def _pp_reference(torch, layers: int, batches, val_batches, dtype=None, timed: bool = True,
                  chunks: int = 1, drop: bool = False) -> dict:
    """One process on the card at ``layers`` layers over the same global
    batches: step losses, parameters, the eval loss, the peak and the
    step time (host-timed as the gang's). With ``chunks``, a control: the
    same batches in that many microbatches (``_microbatched_loss``), the
    same sums in the pipeline's order; with ``drop`` too, a faulty run
    whose gradients lack one microbatch a step."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import evaluate, fit, make_train_step, to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    dev = torch.device("cuda")
    model, r = _pp_model(torch, dev, layers, dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    loss = (make_translation_loss(model.cfg.pad_id) if chunks == 1
            else _microbatched_loss(torch, model.cfg.pad_id, chunks, drop))
    res = fit(state, loss, batches, epochs=1, rng=torch.Generator().manual_seed(r.seed), log_every=0)
    metrics = evaluate(state, make_translation_loss(model.cfg.pad_id, train=False), val_batches,
                       emit=lambda s: None)
    out = dict(step_losses=res.step_losses, test_loss=metrics["test_loss"],
               params={k: v.detach().cpu() for k, v in model.state_dict().items()},
               peak=torch.cuda.max_memory_allocated(), model=model)
    if timed:
        model2, _ = _pp_model(torch, dev, layers, dtype)
        state2 = TrainState.create(model=model2, tx=make_optimizer("adam", r.learning_rate))
        step = make_train_step(make_translation_loss(model2.cfg.pad_id))
        local = [to_device(b, dev) for b in batches]
        _timed_steps(torch, step, state2, local, PP_WARMUP)
        out["ms"] = 1e3 * _timed_steps(torch, step, state2, local, PP_TIMED)
    return out


def pp_slice(torch, hop, card: str, dev) -> dict:
    """Phase 7g: the training kernels at the microbatch shapes, the
    one-process references, then one 4-rank gang over every pipeline mesh
    (``pp_gang_rank``) and its gates."""
    import shutil

    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.parallel.pipeline_parallel import bubble_fraction

    t_phase = time.perf_counter()
    src_pipe, trg_pipe, train_ds = fixture_data()
    batches = train_batches(train_ds, PP_BATCHES)
    src0, trg0 = batches[0]
    sites = pp_sites(torch, dev, src0, trg0[:, :-1])
    errs = check_training_kernels(torch, hop, sites, dev, edges=False)
    bf16_errs = check_training_kernels(torch, hop, pp_sites(torch, dev, src0, trg0[:, :-1], torch.bfloat16),
                                       dev, dtype=torch.bfloat16, edges=False)
    val_loader, _ = eval_loader()
    val_batches = list(val_loader)
    prompts = [s for s, _ in load_multi30k(str(FIXTURES), "valid")][:32]
    refs = {layers: _pp_reference(torch, layers, batches, val_batches) for layers in (4, 2)}
    # A control per mesh: one process on the gang's microbatches (M per
    # data replica), whose only difference from one process on the whole
    # batch is the order of the sums: the gates allow the gang 10 times
    # the control's distance where that exceeds PP_RTOL.
    ctrls = {label: _pp_reference(torch, layers, batches, val_batches, timed=False,
                                  chunks=m * axes.get("data", 1))
             for label, (axes, layers, m) in PP_MESHES.items()}
    # A fault the gates must see, on (c), whose control reads the most:
    # one process whose gradient lacks one of the gang's microbatches a
    # step. The loss gate and the per-tensor gates, max(PP_RTOL, 10 x the
    # control's), are read against its distance, and fail the phase if
    # neither sees it. (Adam normalises a gradient's scale away: these
    # Adam gates are noise gates, the SGD tests hold the scale.)
    axes_c, layers_c, m_c = PP_MESHES[PP_C]
    fault = _pp_reference(torch, layers_c, batches, val_batches, timed=False,
                          chunks=m_c * axes_c["data"], drop=True)
    ref16 = _pp_reference(torch, 2, batches, val_batches, dtype=torch.bfloat16)
    for layers, ref in refs.items():
        log(f"  one process at num_layers {layers} on the same {len(batches)} global batches of 32: "
            f"{ref['ms']:.3f} ms/step (host-timed over {PP_TIMED} after {PP_WARMUP}), peak "
            f"{ref['peak'] / 2**20:.1f} MiB [{card}]")
        del ref["model"]
    for ctrl in (*ctrls.values(), fault):
        del ctrl["model"]
    del ref16["model"]
    root = scratch_dir() / "pp"
    shutil.rmtree(root, ignore_errors=True)
    # The rank function runs in the shared gang of phases 7f-7l
    # (``run_shared_gang``): this phase's time there comes back as ``wall``.
    t_pre = time.perf_counter() - t_phase
    got, wall = yield "chip_smoke:pp_gang_rank", (str(root), batches, val_batches, prompts)
    t_post = time.perf_counter()
    ranks, params = got["ranks"], got["params"]
    r0 = ranks[0]
    log(f"  Session -> Distributor, {PP_GANG} ranks on one card over gloo, the shared gang of phases "
        f"7f-7l: {wall:.2f} s of it ran this phase (meshes a-c, K = 4, bf16, the recipe three times, the step times)")
    steps = len(batches)
    for label, (axes, layers, m) in PP_MESHES.items():
        ref = refs[layers]
        run = r0["runs"][label]
        rel = _max_rel(run["step_losses"], ref["step_losses"])
        # The step losses within PP_RTOL of one process, or, where the
        # microbatches' order of sums alone moves them further through
        # Adam, within GANG_NOISE_X times the control's distance.
        ctrl_loss = _max_rel(ctrls[label]["step_losses"], ref["step_losses"])
        loss_gate = max(PP_RTOL, GANG_NOISE_X * ctrl_loss)
        # The gangs' per-tensor gate: each tensor's relative difference within
        # PP_RTOL, or, where Adam lifts float noise above it, within
        # GANG_NOISE_X times the control's (one process on the same
        # microbatches); the key biases within 2 x lr x steps.
        gate = _param_gate(torch, params[label], ref["params"], steps)
        ctrl = _param_gate(torch, ctrls[label]["params"], ref["params"], steps)["rel"]
        limit = {k: max(PP_RTOL, GANG_NOISE_X * ctrl[k]) for k in gate["rel"]}
        over = {k: v for k, v in gate["rel"].items() if v > limit[k]}
        worst = sorted(gate["rel"].items(), key=lambda kv: -kv[1] / limit[kv[0]])[:3]
        equal = all(rk["runs"][label]["ranks_equal"] for rk in ranks)
        log(f"    {label} (num_layers {layers}): step losses max relative difference to one process "
            f"{rel:.3e}, gate max({PP_RTOL}, {GANG_NOISE_X} x the control's {ctrl_loss:.3e}), to the "
            f"control {_max_rel(run['step_losses'], ctrls[label]['step_losses']):.3e}; parameters per "
            f"tensor largest relative difference "
            f"{gate['max_rel']:.3e}, gate max({PP_RTOL}, {GANG_NOISE_X} x the control's), the three "
            f"nearest their gate " + ", ".join(f"{k} {v:.2e} (control {ctrl[k]:.2e})" for k, v in worst)
            + f"; against the control itself {_param_gate(torch, params[label], ctrls[label]['params'], steps)['max_rel']:.3e}"
            + f"; key biases {gate['key_bias_abs']:.3e} (bound {gate['key_bias_bound']:.3e}); every "
            f"rank the same parameters and moments {equal}; eval loss {run['test_loss']:.6f} (one "
            f"process {ref['test_loss']:.6f})")
        if rel > loss_gate or over or gate["key_bias_abs"] > gate["key_bias_bound"] or not equal:
            fail(f"{label}: the pipelined gang did not train as one process does ({over})")
        if label == PP_C:
            f_loss = _max_rel(fault["step_losses"], ref["step_losses"])
            f_rel = _param_gate(torch, fault["params"], ref["params"], steps)["rel"]
            seen = {k: v for k, v in f_rel.items() if v > limit[k]}
            log(f"    {label}: a fault, one process without one microbatch's gradient a step: step "
                f"losses {f_loss:.3e} from one process ({f_loss / loss_gate:.1f} x the loss gate "
                f"{loss_gate:.3e}); {len(seen)} of {len(f_rel)} tensors over their gate, the "
                f"largest {max(f_rel.values()):.3e}")
            if f_loss <= loss_gate and not seen:
                fail(f"{label}: the gates cannot see a dropped microbatch ({f_loss:.3e} against {loss_gate:.3e})")
    k4, c = r0["runs"]["c K=4"], r0["runs"][PP_C]
    same = k4["step_losses"] == c["step_losses"] and got["same"]["c K=4"]
    log(f"    (c) at 4 steps per call against 1: the same bits {same}")
    if not same:
        fail("the pipelined gang's 4 steps per call did not train the bits of 1")
    bf = r0["runs"]["d bf16"]
    rel16 = _max_rel(bf["step_losses"], ref16["step_losses"])
    log(f"    d (c) at dtype bfloat16: step losses within {rel16:.3e} of one process at bf16 (gate "
        f"{BF16_LOSS_RTOL:.3e}); every rank the same state {all(rk['runs']['d bf16']['ranks_equal'] for rk in ranks)}")
    if rel16 > BF16_LOSS_RTOL or not all(rk["runs"]["d bf16"]["ranks_equal"] for rk in ranks):
        fail(f"the bf16 pipelined gang's losses {rel16:.3e} from one process at bf16")
    # Launches: each rank 3 sites x its L/S layers x M microbatches a step,
    # and the sequential eval's 3 x L a batch.
    for rk in ranks:
        for label, (axes, layers, m) in {**PP_MESHES, "c K=4": PP_MESHES[PP_C],
                                         "d bf16": PP_MESHES[PP_C]}.items():
            s = axes["pipeline"]
            train = 3 * (layers // s) * m * steps
            want = (train + 3 * layers * PP_EVAL_BATCHES, train, train)
            names = TENSOR_CORE_KERNELS if label != "d bf16" else tuple(f"{n}_bf16" for n in TENSOR_CORE_KERNELS)
            got_l = tuple(rk["runs"][label]["launches"][n] for n in names)
            if got_l != want:
                fail(f"rank {rk['rank']} {label}: flash launches {got_l}, not {want}")
    log("    every rank, every run: flash forward / dQ / dK/dV launches 3 x (L/S) x M a step and "
        f"3 x L an eval batch: " + ", ".join(
            f"{label} {tuple(r0['runs'][label]['launches'][n] for n in TENSOR_CORE_KERNELS)}"
            for label in PP_MESHES))
    rec = r0["recipe"]
    first, second, whole = rec["first"], rec["second"], rec["whole"]
    same = first["step_losses"] + second["step_losses"] == whole["step_losses"] and got["same"]["recipe"]
    log(f"    e train_translator(pipeline_parallel=2, pipeline_microbatches=4, remat=True) on "
        f"{whole['mesh']}: 1 + 1 epochs (resumed from step {second['resumed']}) against 2 with "
        f"checkpoints: the same bits {same}; eval loss {whole['test_loss']:.6f}; every rank the same "
        f"state {all(rk['recipe'][n]['ranks_equal'] for rk in ranks for n in ('whole', 'second'))}; "
        f"its Translator is the trained model {whole['translator_is_model']}")
    if not same or second["resumed"] != first["steps"] or whole["mesh"] != {"data": 2, "pipeline": 2}:
        fail("the pipelined recipe's 1 + 1 epochs did not train the bits of 2")
    if not all(rk["recipe"][n]["ranks_equal"] for rk in ranks for n in ("whole", "second")):
        fail("the pipelined recipe's ranks hold different states")
    for rk in ranks:
        for name in ("whole", "first", "second"):
            run = rk["recipe"][name]
            n_steps = len(run["step_losses"])
            train = 3 * (2 // 2) * PP_RECIPE["pipeline_microbatches"] * n_steps
            got_l = tuple(run["launches"][n] for n in TENSOR_CORE_KERNELS)
            # remat: each layer's forward again in the backward; then the
            # sequential eval.
            if got_l != (2 * train + 3 * 2 * PP_EVAL_BATCHES, train, train):
                fail(f"rank {rk['rank']} recipe {name}: flash launches {got_l}, train {train}")
    full, _ = _pp_model(torch, dev, 2)
    full.load_state_dict({k: v.to(dev) for k, v in params["recipe whole"].items()})
    one = Translator(full, src_pipe, trg_pipe, device=dev)(prompts, max_new_tokens=32)
    share = agreement(got["tokens"], one)[0]
    log(f"    the recipe's Translator (rank 0 of the gang) against one process's on the same weights: "
        f"agreement {share:.6f} over {len(prompts)} validation sentences (gate >= {AGREEMENT_MIN})")
    if share < AGREEMENT_MIN:
        fail(f"the pipelined recipe's Translator agrees {share:.4f} with one process's")
    log(f"    ZeRO-1 on {PP_MESHES[PP_C][0]}: {got['zero1'][:150]}")
    if "Pipeline/sequence/expert axes restructure the step" not in got["zero1"]:
        fail("dp_mode='zero1' on a pipeline mesh did not raise the JAX ValueError")
    for rk in ranks:
        log(f"    rank {rk['rank']} step times (host-timed, {PP_TIMED} after {PP_WARMUP}): " + "; ".join(
            f"{label} {t['ms']:.3f} ms/step against one process at num_layers "
            f"{PP_MESHES[label][1]} {refs[PP_MESHES[label][1]]['ms']:.3f} ms, bubble "
            f"{bubble_fraction(PP_MESHES[label][0]['pipeline'], PP_MESHES[label][2]):.3f} of the ticks ("
            + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in t.items() if k != "ms") + ")"
            for label, t in rk["times"].items()) + f" [{card}]")
    log(f"  phase 7g took {t_pre + wall + time.perf_counter() - t_post:.1f} s")
    return dict(wall=wall, ranks=ranks, errs=errs, bf16_errs=bf16_errs, sites=sites,
                refs={k: {f: v[f] for f in ("ms", "peak", "test_loss")} for k, v in refs.items()})


# -- phase 7h: the sequence axis ---------------------------------------------------

SP_GANG = 4
# label: (mesh axes, method). The reference MT model (1 layer) at full
# width on the fixture's global batches of 32, targets one pad longer (the
# recipe's SP padding) so that all three attention sites split.
SP_MESHES = {
    "a {seq: 4} ring": ({"seq": 4}, "ring"),
    "b {seq: 4} ulysses": ({"seq": 4}, "ulysses"),
    "c {data: 2, seq: 2} ring": ({"data": 2, "seq": 2}, "ring"),
}
SP_RTOL = 1e-4
SP_WARMUP, SP_TIMED = 1, 3
# The ring's hop shapes: {seq: 4} and {seq: 2} at S = 200 (batch 32), and
# {seq: 4} at S = 2048 (batch 2).
SP_HOP_SHAPES = ((32, 8, 50, 64), (32, 8, 100, 64), (2, 8, 512, 64))
# train_translator(sequence_parallel=2) in the 4-rank gang: {data: 2, seq:
# 2}, 16 rows a data replica (global batch 32), BLEU and checkpoints.
SP_RECIPE = dict(data_root=str(FIXTURES), batch_size=16, dropout=0.0, log_every=0, compute_bleu=True,
                 sequence_parallel=2)
SP_LONG = dict(seq=2048, batch=2)


def _sp_pad(batch):
    """A fixture batch with its targets one pad longer: the decoder input
    then has the source's 200 positions, as the recipe's SP pipelines make
    it."""
    src, trg = batch
    return src, np.pad(np.asarray(trg), ((0, 0), (0, 1)))


def sp_hop_cases(torch, dev, dtype=None, shapes: dict | None = None) -> dict:
    """At each hop shape ``[b, H, S/n, d]`` (``shapes``: label → shape, by
    default phase 7h's ``SP_HOP_SHAPES``): the local queries, the diagonal
    chunk's K/V and validity (some keys masked) and a chunk behind's
    (every key of the first batch row masked), and dO."""
    if shapes is None:
        shapes = {f"SP hop [{b},{h},{c},{d}]": (b, h, c, d) for b, h, c, d in SP_HOP_SHAPES}
    out = {}
    for label, (b, h, c, d) in shapes.items():
        rng = np.random.default_rng(SEED + 300 + c + (0 if h == 8 else 1000 * h))

        def randn(*shape):
            x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
            return x if dtype is None else x.to(dtype)

        diag = rng.random((b, c)) < 0.8
        behind = rng.random((b, c)) < 0.8
        behind[0] = False
        out[label] = dict(
            q=randn(b, h, c, d), k0=randn(b, h, c, d), v0=randn(b, h, c, d),
            valid0=torch.from_numpy(diag).to(dev), k1=randn(b, h, c, d), v1=randn(b, h, c, d),
            valid1=torch.from_numpy(behind).to(dev), g=randn(b, h, c, d))
    return out


def sp_hop_sites(torch, dev, dtype=None, shapes: dict | None = None) -> dict:
    """The hops as training sites (for the timings): the diagonal, causal
    with its validity, and a hop behind, unmasked, with its."""
    sites = {}
    for label, c in sp_hop_cases(torch, dev, dtype, shapes).items():
        sites[f"{label} diagonal"] = dict(q=c["q"], k=c["k0"], v=c["v0"], g=c["g"], causal=True,
                                          kv_valid=c["valid0"])
        sites[f"{label} behind"] = dict(q=c["q"], k=c["k1"], v=c["v1"], g=c["g"], causal=False,
                                        kv_valid=c["valid1"])
    return sites


def check_hop_kernels(torch, hop, dev, dtype=None, shapes: dict | None = None) -> dict:
    """Phase 7h (a): at each hop shape, the flash forward with ``lse`` on the
    diagonal hop (causal) and on a hop behind (unmasked, rows with no valid
    key) against the plain version; the two merged by ``lse``
    (``ring_attention.merge_hop``) against the forward over both chunks at
    once (bottom-right causal over ``[behind | diagonal]``); then dQ and
    dK/dV of each hop with the MERGED ``lse`` and ``delta`` against their
    plain versions, and the hops' dQ summed against the whole backward's.
    Each within ``TOL`` relative (``BF16_TOL`` at bf16). ``shapes`` as
    ``sp_hop_cases`` takes them."""
    from machine_learning_apache_spark_tpu_torch.parallel.ring_attention import (
        finish_merge,
        hop_backward,
        hop_forward,
        merge_hop,
    )

    dtype = dtype or torch.float32
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL
    names = {n: hop.kernel_name(n, dtype) for n in TENSOR_CORE_KERNELS}
    worst = {n: [0.0, 0.0] for n in names.values()}

    def record(kernel, label, got, want, tol=tol):
        got, want = got.float(), want.float()
        err, rel = (got - want).abs().max().item(), _rel(got, want)
        log(f"  {names[kernel]:29s} {label:52s} max_abs_err {err:.3e}, rel {rel:.3e} (tol {tol:.3e} relative)")
        if not rel <= tol or bool(torch.isnan(got).any().item()):
            fail(f"{names[kernel]} disagrees with its plain version on {label}")
        worst[names[kernel]][0] = max(worst[names[kernel]][0], err)
        worst[names[kernel]][1] = max(worst[names[kernel]][1], rel)

    for label, c in sp_hop_cases(torch, dev, dtype, shapes).items():
        q, g = c["q"], c["g"]
        hops = ((c["k0"], c["v0"], c["valid0"], "diagonal"), (c["k1"], c["v1"], c["valid1"], "behind"))
        acc = None
        for k, v, valid, kind in hops:
            o, lse = hop_forward(q, k, v, valid, kind)
            want_o, want_lse = hop.flash_attention_lse_plain(q, k, v, causal=kind == "diagonal", kv_valid=valid)
            record("flash_attention_fwd", f"{label} {kind} (out)", o, want_o)
            live = want_lse > hop.NEG_INF / 2
            record("flash_attention_fwd", f"{label} {kind} (lse)", lse[live], want_lse[live],
                   tol=BF16_LSE_TOL if dtype == torch.bfloat16 else TOL)
            acc = merge_hop(acc, o, lse)
        out, lse = finish_merge(acc, dtype)
        k_all = torch.cat([c["k1"], c["k0"]], dim=2)
        v_all = torch.cat([c["v1"], c["v0"]], dim=2)
        valid_all = torch.cat([c["valid1"], c["valid0"]], dim=1)
        whole, whole_lse = hop.flash_attention_lse_plain(q, k_all, v_all, causal=True, kv_valid=valid_all)
        record("flash_attention_fwd", f"{label} merged (out)", out, whole)
        live = whole_lse > hop.NEG_INF / 2
        if not torch.equal(lse > hop.NEG_INF / 2, live):
            fail(f"the merged lse marks other rows as empty than the whole forward ({label})")
        record("flash_attention_fwd", f"{label} merged (lse)", lse[live], whole_lse[live],
               tol=BF16_LSE_TOL if dtype == torch.bfloat16 else TOL)
        delta = (g.float() * out.float()).sum(-1)
        dq_sum = torch.zeros(q.shape, dtype=torch.float32, device=dev)
        for k, v, valid, kind in hops:
            dq, dk, dv = hop_backward(q, k, v, g, lse, delta, valid, kind)
            kw = dict(causal=kind == "diagonal", kv_valid=valid)
            want_dq = hop.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, **kw)
            want_dk, want_dv = hop.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, **kw)
            torch.cuda.synchronize()
            record("flash_attention_bwd_dq", f"{label} {kind}, merged lse", dq, want_dq)
            record("flash_attention_bwd_dkv", f"{label} {kind}, merged lse (dk)", dk, want_dk)
            record("flash_attention_bwd_dkv", f"{label} {kind}, merged lse (dv)", dv, want_dv)
            dq_sum += dq.float()
        want_whole = hop.flash_attention_backward_plain(q, k_all, v_all, whole, whole_lse, g,
                                                        causal=True, kv_valid=valid_all)
        record("flash_attention_bwd_dq", f"{label} hops summed vs whole", dq_sum, want_whole[0])
    return {n: dict(max_abs_err=a, max_rel_err=r) for n, (a, r) in worst.items()}


def _sp_launches(method: str, n: int, r: int) -> int:
    """Each training kernel's launches at one step's three sites on the
    rank at seq index ``r`` (the forward's at one eval batch): the ring n
    hops at the encoder and the cross-attention, ``r + 1`` at the causal
    decoder (the chunks ahead skipped); Ulysses one inner attention a
    site."""
    return n + (r + 1) + n if method == "ring" else 3


def _sp_fit(torch, axes: dict, method: str, batches, val_batches) -> tuple[dict, dict | None]:
    """One ``fit(mesh=)`` + ``evaluate(mesh=)`` of the reference MT model
    (Adam) in this rank under ``sequence_parallel(mesh, method=)``, each
    data index on its rows of the global batches: step losses, launches,
    peak, comms, the eval loss, whether the seq line holds the same bits
    (``assert_replicas_in_sync``); and rank 0's parameters."""
    import gc

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.ops.attention import sequence_parallel
    from machine_learning_apache_spark_tpu_torch.parallel import assert_replicas_in_sync, make_mesh
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import evaluate, fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    mesh = make_mesh(axes)
    d, ways = mesh.index("data"), mesh.axis_size("data")
    model, r = _pp_model(torch, mesh.device, 1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hop.reset_launches()
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    with sequence_parallel(mesh, method=method):
        res = fit(state, make_translation_loss(model.cfg.pad_id),
                  [_data_rows(b, d, ways) for b in batches], epochs=1, mesh=mesh, log_every=0,
                  rng=torch.Generator().manual_seed(r.seed))
        metrics = evaluate(res.state, make_translation_loss(model.cfg.pad_id, train=False),
                           [_data_rows(b, d, ways) for b in val_batches], mesh=mesh, emit=lambda s: None)
    torch.cuda.synchronize()
    try:
        assert_replicas_in_sync(res.state, mesh=mesh)
        in_sync = "ok"
    except AssertionError as e:
        in_sync = str(e)
    out = dict(step_losses=res.step_losses, launches=dict(hop.LAUNCHES), seq=mesh.index("seq"),
               peak=torch.cuda.max_memory_allocated(), comms=res.comms,
               test_loss=metrics["test_loss"], steps=res.state.step, in_sync=in_sync)
    params = ({k: v.detach().cpu() for k, v in model.state_dict().items()} if mesh.rank == 0 else None)
    return out, params


def _sp_step_times(torch, axes: dict, method: str, batches) -> dict:
    """This rank's SP step, ``SP_WARMUP`` steps then ``SP_TIMED`` timed, each
    synchronised at both ends; after every step the seq line's bits are
    compared (``assert_replicas_in_sync``, outside the timed window); the
    seq line's collectives' windows and bytes per step, and the peak."""
    import gc

    from machine_learning_apache_spark_tpu_torch.ops.attention import sequence_parallel
    from machine_learning_apache_spark_tpu_torch.parallel import (
        assert_replicas_in_sync,
        make_data_parallel_step,
        make_mesh,
    )
    from machine_learning_apache_spark_tpu_torch.parallel.sequence import sequence_line
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(axes)
    d, ways = mesh.index("data"), mesh.axis_size("data")
    model, r = _pp_model(torch, mesh.device, 1)
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    step = make_data_parallel_step(make_translation_loss(model.cfg.pad_id), mesh)
    step.replica(model)
    local = [to_device(_data_rows(b, d, ways), mesh.device) for b in batches]
    line = sequence_line(mesh)
    torch.cuda.reset_peak_memory_stats()
    seconds, every_step_equal = 0.0, True
    with sequence_parallel(mesh, method=method):
        for i in range(SP_WARMUP + SP_TIMED):
            if i == SP_WARMUP:
                before = line.comms.stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, local[i % len(local)], None)
            torch.cuda.synchronize()
            if i >= SP_WARMUP:
                seconds += time.perf_counter() - t0
            try:
                assert_replicas_in_sync(state, mesh=mesh)
            except AssertionError:
                every_step_equal = False
    after = line.comms.stats()
    out = dict(ms=1e3 * seconds / SP_TIMED, peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               every_step_same_bits=every_step_equal)
    for kind in line.comms.KINDS:
        out[f"{kind}_ms"] = 1e3 * (after[f"{kind}_window_seconds"] - before[f"{kind}_window_seconds"]) / SP_TIMED
        out[f"{kind}_bytes"] = (after[f"{kind}_bytes"] - before[f"{kind}_bytes"]) / SP_TIMED
    del state, step, model
    return out


def sp_long_batch(seq: int, batch: int) -> tuple:
    """Token ids drawn from ``SEED`` for the long-context step: sources of
    ``seq`` and targets of ``seq + 1`` positions over the published 8004
    vocabulary, the second row padded from three quarters on."""
    rng = np.random.default_rng(SEED + 7)
    src = rng.integers(4, MT_PUBLISHED_VOCAB, (batch, seq))
    trg = rng.integers(4, MT_PUBLISHED_VOCAB, (batch, seq + 1))
    src[1, 3 * seq // 4:] = 0
    trg[1, 3 * seq // 4:] = 0
    return src, trg


def _long_step(torch, model, batch, dev) -> dict:
    """One train step's loss and gradients (a warm step first, then one
    timed), the peak above the model."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    loss_fn = make_translation_loss(model.cfg.pad_id)
    local = to_device(batch, dev)
    for p in model.parameters():
        p.grad = None
    loss_fn(model, local, None)[0].backward()
    for p in model.parameters():
        p.grad = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loss = loss_fn(model, local, None)[0]
    loss.backward()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return dict(loss=loss.item(), ms=ms, peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,
                grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def _sp_long_rank(torch, batch) -> dict:
    """Phase 7h (d) in this rank: one train step of the reference-width
    model at ``SP_LONG["seq"]`` positions (remat) on ``{seq: 4}`` under
    ring, with the launches it made."""
    import gc

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.ops.attention import sequence_parallel
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh({"seq": SP_GANG})
    model, _ = _pp_model(torch, mesh.device, 1, max_len=SP_LONG["seq"], vocab=MT_PUBLISHED_VOCAB,
                         remat=True)
    hop.reset_launches()
    with sequence_parallel(mesh, method="ring"):
        out = _long_step(torch, model, batch, mesh.device)
    out["launches"] = dict(hop.LAUNCHES)
    if mesh.rank != 0:
        del out["grads"]
    del model
    return out


def sp_gang_rank(root: str, batches, val_batches, long_batch) -> dict:
    """One rank of phase 7h's 4-rank gang: the fits on each mesh (a-c), the
    recipe with ``sequence_parallel=2`` under ring and Ulysses (BLEU,
    checkpoints), the long-context step, then the step times. Every rank's
    numbers, in rank order; rank 0's parameters and long-step gradients."""
    import os

    import torch
    import torch.distributed as dist

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    rank = dist.get_rank()
    runs, params = {}, {}
    for label, (axes, method) in SP_MESHES.items():
        runs[label], params[label] = _sp_fit(torch, axes, method, batches, val_batches)
    recipe = {}
    gang_run = os.environ.get("MLSPARK_GANG_RUN", "sp")
    for method in ("ring", "ulysses"):
        os.environ["MLSPARK_GANG_RUN"] = f"{gang_run}-{method}"
        hop.reset_launches()
        out = train_translator(checkpoint_dir=os.path.join(root, method), sequence_parallel_method=method,
                               _return_state=True, **SP_RECIPE)
        state = out["state"]
        recipe[method] = dict(step_losses=out["fit_result"].step_losses, launches=dict(hop.LAUNCHES),
                              mesh=dict(state.mesh.shape), test_loss=out["test_loss"], bleu=out["bleu"],
                              comms=out["fit_result"].comms, seq=state.mesh.index("seq"),
                              pointer=os.path.exists(os.path.join(root, method, f"ckpt_r{rank}", "latest")))
        del out, state
    long = _sp_long_rank(torch, long_batch)
    times = {label: _sp_step_times(torch, axes, method, batches)
             for label, (axes, method) in SP_MESHES.items()}
    grads = long.pop("grads", None)
    ranks = _gather(dict(rank=rank, runs=runs, recipe=recipe, long=long, times=times))
    return dict(ranks=ranks, params=params if rank == 0 else None, long_grads=grads)


def _grad_gate(torch, got: dict, want: dict) -> dict:
    """Per gradient tensor the relative norm of the difference, the key
    biases' slices apart: their true gradient is 0 (softmax is blind to a
    shift shared by a row's scores), so both sides hold float noise there,
    held to ``SP_RTOL`` x the largest gradient element instead."""
    from machine_learning_apache_spark_tpu_torch.recipes.translation import TranslationRecipe

    d_model = TranslationRecipe(**GANG_MT).d_model
    scale = max(float(v.abs().max()) for v in want.values())
    rel, noise = {}, 0.0
    for k, w in want.items():
        diff = (got[k].double() - w.double()).reshape(-1)
        ref = w.double().reshape(-1)
        kb = _key_bias(k, d_model)
        if kb is not None:
            noise = max(noise, float(diff[kb].abs().max()))
            keep = torch.ones_like(diff, dtype=torch.bool)
            keep[kb] = False
            diff, ref = diff[keep], ref[keep]
        rel[k] = float(diff.norm() / ref.norm().clamp_min(1e-30))
    return dict(rel=rel, key_bias_abs=noise, key_bias_bound=SP_RTOL * scale)


def _sp_long_reference(torch, dev, batch, impl: str) -> dict:
    """The long-context step in one process under ``attention_impl(impl)``
    (``"flash"``: the kernels; ``"dense"``: the plain path's [S, S]
    scores)."""
    import gc

    from machine_learning_apache_spark_tpu_torch.ops.attention import attention_impl

    gc.collect()
    torch.cuda.empty_cache()
    model, _ = _pp_model(torch, dev, 1, max_len=SP_LONG["seq"], vocab=MT_PUBLISHED_VOCAB, remat=True)
    with attention_impl(impl):
        out = _long_step(torch, model, batch, dev)
    del model
    return out


def sp_slice(torch, hop, card: str, dev) -> dict:
    """Phase 7h: the kernels at the ring's hop shapes, the one-process
    references, then one 4-rank gang over every SP mesh (``sp_gang_rank``)
    and its gates."""
    import shutil


    t_phase = time.perf_counter()
    errs = check_hop_kernels(torch, hop, dev)
    bf16_errs = check_hop_kernels(torch, hop, dev, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    _, _, train_ds = fixture_data()
    batches = [_sp_pad(b) for b in train_batches(train_ds, 12)]
    val_loader, _ = eval_loader()
    val_batches = [_sp_pad(b) for b in val_loader]
    long_batch = sp_long_batch(**SP_LONG)
    # One process (1 layer) on the same global batches, and a control: the
    # same batches in two microbatches a step, the same sums in another
    # order (the gates allow the gang 10 times its distance).
    ref = _pp_reference(torch, 1, batches, val_batches)
    ctrl = _pp_reference(torch, 1, batches, val_batches, timed=False, chunks=2)
    del ref["model"], ctrl["model"]
    long_ref = _sp_long_reference(torch, dev, long_batch, "flash")
    long_dense = _sp_long_reference(torch, dev, long_batch, "dense")
    log(f"  one process on the same {len(batches)} global batches of 32 (targets 201 wide): "
        f"{ref['ms']:.3f} ms/step (host-timed over {SP_TIMED} after {SP_WARMUP}), peak "
        f"{ref['peak'] / 2**20:.1f} MiB [{card}]")
    root = scratch_dir() / "sp"
    shutil.rmtree(root, ignore_errors=True)
    # The rank function runs in the shared gang of phases 7f-7l
    # (``run_shared_gang``): this phase's time there comes back as ``wall``.
    t_pre = time.perf_counter() - t_phase
    got, wall = yield "chip_smoke:sp_gang_rank", (str(root), batches, val_batches, long_batch)
    t_post = time.perf_counter()
    ranks, params = got["ranks"], got["params"]
    r0 = ranks[0]
    log(f"  Session -> Distributor, {SP_GANG} ranks on one card over gloo, the shared gang of phases "
        f"7f-7l: {wall:.2f} s of it ran this phase (meshes a-c, the recipe twice, the long step, the step times)")
    steps = len(batches)
    ctrl_loss = _max_rel(ctrl["step_losses"], ref["step_losses"])
    loss_gate = max(SP_RTOL, GANG_NOISE_X * ctrl_loss)
    ctrl_rel = _param_gate(torch, ctrl["params"], ref["params"], steps)["rel"]
    limit = {k: max(SP_RTOL, GANG_NOISE_X * v) for k, v in ctrl_rel.items()}
    for label, (axes, method) in SP_MESHES.items():
        run = r0["runs"][label]
        rel = _max_rel(run["step_losses"], ref["step_losses"])
        gate = _param_gate(torch, params[label], ref["params"], steps)
        over = {k: v for k, v in gate["rel"].items() if v > limit[k]}
        worst = sorted(gate["rel"].items(), key=lambda kv: -kv[1] / limit[kv[0]])[:3]
        synced = all(rk["runs"][label]["in_sync"] == "ok" for rk in ranks)
        log(f"    {label}: step losses max relative difference to one process {rel:.3e}, gate "
            f"max({SP_RTOL}, {GANG_NOISE_X} x the microbatched control's {ctrl_loss:.3e}); parameters per "
            f"tensor largest relative difference {gate['max_rel']:.3e}, the three nearest their gate "
            + ", ".join(f"{k} {v:.2e} (control {ctrl_rel[k]:.2e})" for k, v in worst)
            + f"; key biases {gate['key_bias_abs']:.3e} (bound {gate['key_bias_bound']:.3e}); every "
            f"seq line the same bits {synced}; eval loss {run['test_loss']:.6f} (one process "
            f"{ref['test_loss']:.6f})")
        if rel > loss_gate or over or gate["key_bias_abs"] > gate["key_bias_bound"] or not synced:
            fail(f"{label}: the sequence-parallel gang did not train as one process does "
                 f"({over}, {[rk['runs'][label]['in_sync'] for rk in ranks]})")
    # Launches: each rank's kernels at the three sites, every step and
    # eval batch (the ring's chunks ahead skipped, per seq index).
    for rk in ranks:
        for label, (axes, method) in SP_MESHES.items():
            run = rk["runs"][label]
            per = _sp_launches(method, axes["seq"], run["seq"])
            want = (per * (steps + len(val_batches)), per * steps, per * steps)
            got_l = tuple(run["launches"][n] for n in TENSOR_CORE_KERNELS)
            if got_l != want:
                fail(f"rank {rk['rank']} {label}: flash launches {got_l}, not {want}")
    log("    every rank, every mesh: flash forward / dQ / dK/dV launches as the hop schedule says "
        "(ring: n + (r + 1) + n a step on seq index r; Ulysses: 3): "
        + "; ".join(f"rank {rk['rank']} " + ", ".join(
            f"{label[:1]} {tuple(rk['runs'][label]['launches'][n] for n in TENSOR_CORE_KERNELS)}"
            for label in SP_MESHES) for rk in ranks))
    for method in ("ring", "ulysses"):
        recs = [rk["recipe"][method] for rk in ranks]
        rec = recs[0]
        losses = rec["step_losses"]
        log(f"    c train_translator(sequence_parallel=2, sequence_parallel_method={method!r}) on "
            f"{rec['mesh']}: {len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, eval loss "
            f"{rec['test_loss']:.6f}, BLEU {rec['bleu']:.6f}, checkpoints on every rank "
            f"{all(x['pointer'] for x in recs)}; dQ launches per rank {[x['launches']['flash_attention_bwd_dq'] for x in recs]}")
        if (rec["mesh"] != {"data": 2, "seq": 2} or not np.all(np.isfinite(losses))
                or not losses[-1] < losses[0] or not np.isfinite(rec["bleu"])
                or not all(x["pointer"] for x in recs)):
            fail(f"the SP recipe ({method}) did not train, evaluate, decode and checkpoint")
        for x in recs:
            per = _sp_launches(method, 2, x["seq"]) * len(x["step_losses"])
            if (x["launches"]["flash_attention_bwd_dq"], x["launches"]["flash_attention_bwd_dkv"]) != (per, per):
                fail(f"the SP recipe ({method}): dQ/dK/dV launches {x['launches']}, not {per} each")
    rel_r = _max_rel(ranks[0]["recipe"]["ulysses"]["step_losses"], ranks[0]["recipe"]["ring"]["step_losses"])
    log(f"    the recipe under Ulysses against ring: step losses within {rel_r:.3e} (reading)")
    # (d) the long-context step.
    lg = r0["long"]
    rel_l = abs(lg["loss"] - long_ref["loss"]) / abs(long_ref["loss"])
    grads = _grad_gate(torch, got["long_grads"], long_ref["grads"])
    # The control: one process through the dense path, the same step's
    # sums in another order; each tensor's gate max(SP_RTOL, GANG_NOISE_X
    # x the control's distance) (the decoder FFN's up projection, behind
    # its ReLU, amplifies last-digit differences over 4,096 positions).
    ctrl_g = _grad_gate(torch, long_dense.pop("grads"), long_ref["grads"])["rel"]
    g_limit = {k: max(SP_RTOL, GANG_NOISE_X * v) for k, v in ctrl_g.items()}
    g_over = {k: v for k, v in grads["rel"].items() if v > g_limit[k]}
    g_rel = max(grads["rel"].values())
    worst = sorted(grads["rel"].items(), key=lambda kv: -kv[1] / g_limit[kv[0]])[:3]
    log(f"    d one train step at {SP_LONG['seq']} positions, batch {SP_LONG['batch']}, remat, vocab "
        f"{MT_PUBLISHED_VOCAB}: {{seq: 4}} ring loss {lg['loss']:.6f} against one process (flash) "
        f"{long_ref['loss']:.6f}, relative {rel_l:.3e}; gradients' largest relative norm difference "
        f"{g_rel:.3e}, the three nearest their gate max({SP_RTOL}, {GANG_NOISE_X} x the dense "
        f"control's) " + ", ".join(f"{k} {v:.2e} (control {ctrl_g[k]:.2e})" for k, v in worst)
        + f"), the key biases' (true gradient 0) largest {grads['key_bias_abs']:.3e} (gate "
        f"{SP_RTOL} x the largest gradient, {grads['key_bias_bound']:.3e}); step ms {lg['ms']:.1f} (rank 0) against {long_ref['ms']:.1f}; peak "
        f"above the model per rank " + ", ".join(f"{rk['long']['peak_mib']:.1f}" for rk in ranks)
        + f" MiB against one process {long_ref['peak_mib']:.1f} MiB (flash) and "
        f"{long_dense['peak_mib']:.1f} MiB (dense, attention_impl('dense'), {long_dense['ms']:.1f} ms) [{card}]")
    if rel_l > SP_RTOL or g_over or grads["key_bias_abs"] > grads["key_bias_bound"]:
        fail(f"the long-context ring step differs from one process (loss {rel_l:.3e}, grads {g_over})")
    for rk in ranks:
        per = _sp_launches("ring", SP_GANG, rk["rank"])
        # Two steps (a warm one, then the timed one); remat runs each
        # layer's forward again in the backward.
        want = (4 * per, 2 * per, 2 * per)
        got_l = tuple(rk["long"]["launches"][n] for n in TENSOR_CORE_KERNELS)
        if got_l != want:
            fail(f"rank {rk['rank']} long step: flash launches {got_l}, not {want}")
    for rk in ranks:
        for label, t in rk["times"].items():
            if not t["every_step_same_bits"]:
                fail(f"rank {rk['rank']} {label}: a step left the seq line holding different bits")
        log(f"    rank {rk['rank']} step times (host-timed, {SP_TIMED} after {SP_WARMUP}; the seq line's "
            f"bits equal after every step): " + "; ".join(
                f"{label} {t['ms']:.3f} ms/step against one process {ref['ms']:.3f} ms ("
                + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                            for k, v in t.items() if k != "ms") + ")"
                for label, t in rk["times"].items()) + f"; fit peak per mesh "
            + ", ".join(f"{rk['runs'][label]['peak'] / 2**20:.1f}" for label in SP_MESHES) + f" MiB [{card}]")
    took = t_pre + wall + time.perf_counter() - t_post
    log(f"  phase 7h took {took:.1f} s")
    return dict(wall=wall, ranks=ranks, errs=errs, bf16_errs=bf16_errs, seconds=took,
                ref={f: ref[f] for f in ("ms", "peak", "test_loss")},
                long_ref={f: long_ref[f] for f in ("loss", "ms", "peak_mib")},
                long_dense={f: long_dense[f] for f in ("loss", "ms", "peak_mib")})


# -- phase 7i: the MoE expert axis ------------------------------------------------

EP_GANG = 4
EP_EXPERTS = 8
# label: mesh axes. The reference MT model (1 layer) at full width with 8
# experts (capacity factor 1.25), on the published 8004-word vocabularies
# (the fixture's ids are all below them), the fixture's global batches of 32.
EP_MESHES = {
    "a {expert: 4}": {"expert": 4},
    "b {data: 2, expert: 2}": {"data": 2, "expert": 2},
    "c {expert: 2, model: 2}": {"expert": 2, "model": 2},
}
EP_STEPS = 4
EP_SGD_LR = 0.1
EP_RTOL = 1e-4
EP_WARMUP, EP_TIMED = 1, 3
# One process's expert weights: 2 MoE sites x (w_up + w_down) x 8 x 512 x 1024 x 4 B.
EP_EXPERT_BYTES = 2 * 2 * EP_EXPERTS * 512 * 1024 * 4
# train_translator(moe_experts=8, expert_parallel=2) in the 4-rank gang:
# {data: 2, expert: 2}, 16 rows a data replica (global batch 32),
# checkpoints, BLEU on the gathered model.
EP_RECIPE = dict(data_root=str(FIXTURES), batch_size=16, dropout=0.0, log_every=0, compute_bleu=True,
                 moe_experts=EP_EXPERTS, expert_parallel=2)


def _ep_launches(steps: int) -> int:
    """Each training kernel's launches over ``steps`` steps on a rank: the
    three attention sites a step, every rank running all of them."""
    return 3 * steps


def _ep_model(torch, dev):
    """The phase's model (``_pp_model`` at one layer with ``EP_EXPERTS``
    experts on the published vocabularies), and the recipe's fields."""
    return _pp_model(torch, dev, 1, vocab=MT_PUBLISHED_VOCAB, moe_experts=EP_EXPERTS)


def _ep_batch(batch, control: bool):
    """A global batch, or (the control) the same rows with half as many
    rows of padding after them: the same loss, routing and gradients, the
    pad rows adding exact zeros, computed at other matmul shapes (as the
    gang's rank computes its share), so with other roundings."""
    if not control:
        return batch
    return tuple(np.concatenate([a, np.zeros_like(a[:len(a) // 2])]) for a in batch)


def _ep_displacement(torch, start: dict, got: dict, want: dict, d_model: int) -> dict:
    """Per tensor the relative norm of the difference of two SGD
    displacements from ``start``, ``|(got - start) - (want - start)| /
    |want - start|``; the key biases' slices apart (true gradient 0: both
    sides float noise), their largest absolute difference."""
    rel, noise = {}, 0.0
    for k, w in want.items():
        diff = (got[k].double() - w.double()).reshape(-1)
        ref = (w.double() - start[k].double()).reshape(-1)
        kb = _key_bias(k, d_model)
        if kb is not None:
            noise = max(noise, float(diff[kb].abs().max()))
            keep = torch.ones_like(diff, dtype=torch.bool)
            keep[kb] = False
            diff, ref = diff[keep], ref[keep]
        rel[k] = float(diff.norm() / ref.norm().clamp_min(1e-30))
    scale = max(float((w.double() - start[k].double()).abs().max()) for k, w in want.items())
    return dict(rel=rel, key_bias_abs=noise, key_bias_bound=EP_RTOL * scale)


def _ep_reference(torch, base, batches, r) -> dict:
    """One process (this rank alone, no mesh) on the global batches: the
    SGD and Adam fits from ``base``'s weights, each beside its control
    (``_ep_batch``), on the host; the one-process step ms (Adam,
    ``EP_TIMED`` after ``EP_WARMUP``)."""
    import copy

    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit, make_train_step, to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    out = {}
    for opt, lr in (("sgd", EP_SGD_LR), ("adam", r.learning_rate)):
        for control in (False, True):
            model = copy.deepcopy(base)
            res = fit(TrainState.create(model=model, tx=make_optimizer(opt, lr)),
                      make_translation_loss(model.cfg.pad_id), [_ep_batch(b, control) for b in batches],
                      epochs=1, log_every=0)
            out[(opt, control)] = dict(step_losses=res.step_losses,
                                    params={k: v.detach().cpu() for k, v in model.state_dict().items()})
            del model, res
    model = copy.deepcopy(base)
    state = TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate))
    step = make_train_step(make_translation_loss(model.cfg.pad_id))
    local = [to_device(b, base.lm_head.weight.device) for b in batches]
    _timed_steps(torch, step, state, local, EP_WARMUP)
    out["ms"] = 1e3 * _timed_steps(torch, step, state, local, EP_TIMED)
    return out


def _ep_forward(torch, base, mesh, batch) -> dict:
    """One forward of ``base``'s weights sharded on ``mesh`` (no grad),
    this data index's rows of ``batch``, against one process's (the whole
    model on the whole batch, in this rank): the logits' largest
    difference relative to their largest value, and the two ``moe_aux``."""
    import copy

    from machine_learning_apache_spark_tpu_torch.parallel.data_parallel import bind_batch_line
    from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import shard_params
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device

    d, ways = mesh.index("data"), mesh.axis_size("data")
    src, trg = to_device(batch, mesh.device)
    rows = slice(d * len(src) // ways, (d + 1) * len(src) // ways)
    with torch.no_grad():
        aux_ref: list = []
        want = base(src, trg[:, :-1], aux_losses=aux_ref)[rows]
        model = shard_params(copy.deepcopy(base), mesh)
        bind_batch_line(model, mesh)
        aux: list = []
        got = model(src[rows], trg[rows, :-1], aux_losses=aux)
        if model.vocab_shard is not None:
            got = model.vocab_shard[0].all_gather(got, dim=-1)
        rel = float((got - want).abs().max() / want.abs().max())
    return dict(logits_rel=rel, aux=[float(a) for a in aux], aux_ref=[float(a) for a in aux_ref])


def _ep_fit(torch, base, mesh, opt: str, lr: float, batches) -> tuple[dict, dict | None]:
    """A ``fit(mesh=)`` of ``base``'s weights on ``mesh``, each data index
    on its rows of the global batches: step losses, launches, comms, the
    replica check, this rank's expert-weight bytes; the parameters
    gathered to full (on rank 0's host)."""
    import copy

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import assert_replicas_in_sync
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    d, ways = mesh.index("data"), mesh.axis_size("data")
    model = copy.deepcopy(base)
    hop.reset_launches()
    res = fit(TrainState.create(model=model, tx=make_optimizer(opt, lr)),
              make_translation_loss(model.cfg.pad_id), [_data_rows(b, d, ways) for b in batches],
              epochs=1, mesh=mesh, log_every=0)
    torch.cuda.synchronize()
    launches = dict(hop.LAUNCHES)
    try:
        assert_replicas_in_sync(res.state, mesh=mesh)
        in_sync = "ok"
    except AssertionError as e:
        in_sync = str(e)
    expert_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                       if n.endswith(("w_up", "w_down")))
    out = dict(step_losses=res.step_losses, launches=launches, comms=res.comms, in_sync=in_sync,
               expert_bytes=expert_bytes)
    full = _full_params(torch, res.state, keep=mesh.rank == 0)
    del model, res
    return out, full


def _ep_step_times(torch, base, mesh, batches, r) -> dict:
    """This rank's Adam step on ``mesh``, ``EP_WARMUP`` steps then
    ``EP_TIMED`` timed, the card synchronised at both ends: ms, the expert
    line's all-reduces (count, bytes, window) and the model line's per
    step, the peak."""
    import copy
    import gc

    from machine_learning_apache_spark_tpu_torch.parallel import make_data_parallel_step, tensor_parallel
    from machine_learning_apache_spark_tpu_torch.parallel.data_parallel import bind_batch_line
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    d, ways = mesh.index("data"), mesh.axis_size("data")
    model = copy.deepcopy(base)
    state = tensor_parallel.shard_state(
        TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate)), mesh)
    bind_batch_line(model, mesh)
    step = make_data_parallel_step(make_translation_loss(model.cfg.pad_id), mesh)
    step.replica(model)
    local = [to_device(_data_rows(b, d, ways), mesh.device) for b in batches]
    torch.cuda.reset_peak_memory_stats()
    _timed_steps(torch, step, state, local, EP_WARMUP)
    lines = tensor_parallel.model_lines(model)
    before = [line.comms.stats() for line in lines]
    sec = _timed_steps(torch, step, state, local, EP_TIMED)
    out = dict(ms=1e3 * sec, peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    for line, b in zip(lines, before):
        a, kind = line.comms.stats(), line.KIND
        out[f"{kind}_calls"] = (a[f"{kind}_calls"] - b[f"{kind}_calls"]) / EP_TIMED
        out[f"{kind}_bytes"] = (a[f"{kind}_bytes"] - b[f"{kind}_bytes"]) / EP_TIMED
        out[f"{kind}_ms"] = 1e3 * (a[f"{kind}_window_seconds"] - b[f"{kind}_window_seconds"]) / EP_TIMED
    del state, step, model
    return out


def ep_gang_rank(root: str, batches) -> dict:
    """One rank of phase 7i's 4-rank gang: rank 0's one-process references
    (the others wait at a barrier), then on each mesh (a-c) a forward, an
    SGD fit and an Adam fit from the same weights, the step times; then
    (d) the recipe with ``moe_experts=8, expert_parallel=2``, checkpoints
    and BLEU, and its resumed second run. Every rank's numbers, in rank
    order, with rank 0's gates (per tensor, against its references)."""
    import os

    import torch
    import torch.distributed as dist

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    from machine_learning_apache_spark_tpu_torch.launcher.coordinator import current_device

    rank = dist.get_rank()
    base, r = _ep_model(torch, current_device())
    start = {k: v.detach().cpu() for k, v in base.state_dict().items()}
    ref = _ep_reference(torch, base, batches, r) if rank == 0 else None
    dist.barrier()
    runs, gates = {}, {}
    for label, axes in EP_MESHES.items():
        mesh = make_mesh(axes)
        run = dict(forward=_ep_forward(torch, base, mesh, batches[0]))
        torch.cuda.reset_peak_memory_stats()
        for opt, lr in (("sgd", EP_SGD_LR), ("adam", r.learning_rate)):
            run[opt], full = _ep_fit(torch, base, mesh, opt, lr, batches)
            if rank == 0:
                want, ctrl = ref[(opt, False)], ref[(opt, True)]
                if opt == "sgd":
                    g = _ep_displacement(torch, start, full, want["params"], r.d_model)
                    c = _ep_displacement(torch, start, ctrl["params"], want["params"], r.d_model)
                else:
                    g = _param_gate(torch, full, want["params"], EP_STEPS)
                    c = _param_gate(torch, ctrl["params"], want["params"], EP_STEPS)
                    g["key_bias_bound"] = 2 * r.learning_rate * EP_STEPS
                limit = {k: max(EP_RTOL, GANG_NOISE_X * v) for k, v in c["rel"].items()}
                gates[f"{label} {opt}"] = dict(
                    over={k: (v, limit[k]) for k, v in g["rel"].items() if v > limit[k]},
                    worst=sorted(((k, v, c["rel"][k]) for k, v in g["rel"].items()),
                                 key=lambda kv: -kv[1] / limit[kv[0]])[:3],
                    key_bias=(g["key_bias_abs"], g["key_bias_bound"]),
                    loss_rel=_max_rel(run[opt]["step_losses"], want["step_losses"]),
                    ctrl_loss_rel=_max_rel(ctrl["step_losses"], want["step_losses"]))
            del full
        run["peak"] = torch.cuda.max_memory_allocated()
        run["times"] = _ep_step_times(torch, base, mesh, batches, r)
        runs[label] = run
    del base
    recipe = {}
    gang_run = os.environ.get("MLSPARK_GANG_RUN", "ep")
    for name in ("first", "second"):
        os.environ["MLSPARK_GANG_RUN"] = f"{gang_run}-{name}"
        hop.reset_launches()
        out = train_translator(checkpoint_dir=str(root), _return_state=True, **EP_RECIPE)
        state = out["state"]
        w_up = state.model.encoder.layers[0].ffn.w_up
        recipe[name] = dict(
            step_losses=out["fit_result"].step_losses, launches=dict(hop.LAUNCHES),
            mesh=dict(state.mesh.shape), test_loss=out["test_loss"], bleu=out["bleu"],
            moe_aux=out["moe_aux"], comms=out["fit_result"].comms,
            resumed=out.get("resumed_from_step"), w_up_shape=tuple(w_up.shape),
            pointer=os.path.exists(os.path.join(root, f"ckpt_r{rank}", "latest")))
        del out, state, w_up
    ranks = _gather(dict(rank=rank, runs=runs, recipe=recipe))
    return dict(ranks=ranks, gates=gates if rank == 0 else None,
                ref=dict(ms=ref["ms"], sgd_losses=ref[("sgd", False)]["step_losses"],
                         adam_losses=ref[("adam", False)]["step_losses"]) if rank == 0 else None)


def ep_slice(torch, hop, card: str) -> dict:
    """Phase 7i: one 4-rank gang over every expert mesh (``ep_gang_rank``)
    and its gates."""
    import shutil


    t_phase = time.perf_counter()
    _, _, train_ds = fixture_data()
    batches = train_batches(train_ds, EP_STEPS)
    root = scratch_dir() / "ep"
    shutil.rmtree(root, ignore_errors=True)
    # The rank function runs in the shared gang of phases 7f-7l
    # (``run_shared_gang``): this phase's time there comes back as ``wall``.
    t_pre = time.perf_counter() - t_phase
    got, wall = yield "chip_smoke:ep_gang_rank", (str(root), batches)
    t_post = time.perf_counter()
    ranks, gates, ref = got["ranks"], got["gates"], got["ref"]
    # Every reading is printed before the phase fails on the first gate
    # missed.
    failed: list[str] = []
    log(f"  Session -> Distributor, {EP_GANG} ranks on one card over gloo, the shared gang of phases "
        f"7f-7l: {wall:.2f} s of it ran this phase (rank 0's one-process references, meshes a-c, the recipe twice); one process "
        f"{ref['ms']:.3f} ms/step (Adam, {EP_TIMED} after {EP_WARMUP}) [{card}]")
    for label, axes in EP_MESHES.items():
        for opt in ("sgd", "adam"):
            g = gates[f"{label} {opt}"]
            log(f"    {label} {opt.upper()} x {EP_STEPS}: step losses max relative difference to one "
                f"process {g['loss_rel']:.3e} (control {g['ctrl_loss_rel']:.3e}); per tensor "
                + ("displacement" if opt == "sgd" else "parameter")
                + f" relative difference, the three nearest their gate max("
                f"{EP_RTOL}, {GANG_NOISE_X} x the control's): "
                + ", ".join(f"{k} {v:.2e} (control {c:.2e})" for k, v, c in g["worst"])
                + f"; key biases {g['key_bias'][0]:.3e} (bound {g['key_bias'][1]:.3e})"
                + ("" if opt == "sgd" else " [a noise gate: Adam's steps turn float noise into lr]"))
            loss_gate = max(EP_RTOL, GANG_NOISE_X * g["ctrl_loss_rel"])
            if g["over"] or g["key_bias"][0] > g["key_bias"][1] or g["loss_rel"] > loss_gate:
                failed.append(f"{label} {opt}: the expert-parallel gang did not train as one process does "
                     f"({g['over']}, key biases {g['key_bias']}, losses {g['loss_rel']:.3e})")
        n, m = axes["expert"], axes.get("model", 1)
        for rk in ranks:
            run = rk["runs"][label]
            fw = run["forward"]
            aux_rel = max(abs(a - b) / abs(b) for a, b in zip(fw["aux"], fw["aux_ref"]))
            if fw["logits_rel"] > EP_RTOL or aux_rel > EP_RTOL:
                failed.append(f"rank {rk['rank']} {label}: one forward's logits {fw['logits_rel']:.3e} / moe_aux "
                     f"{aux_rel:.3e} from one process's")
            if run["sgd"]["expert_bytes"] * n * m != EP_EXPERT_BYTES:
                failed.append(f"rank {rk['rank']} {label}: {run['sgd']['expert_bytes']} expert-weight bytes, not "
                     f"1/{n * m} of {EP_EXPERT_BYTES}")
            for opt in ("sgd", "adam"):
                if run[opt]["in_sync"] != "ok":
                    failed.append(f"rank {rk['rank']} {label} {opt}: {run[opt]['in_sync']}")
                got_l = tuple(run[opt]["launches"][k] for k in TENSOR_CORE_KERNELS)
                if got_l != (_ep_launches(EP_STEPS),) * 3:
                    failed.append(f"rank {rk['rank']} {label} {opt}: flash launches {got_l}, not "
                         f"{_ep_launches(EP_STEPS)} each")
        fw = [rk["runs"][label]["forward"] for rk in ranks]
        log(f"    {label}: one forward's logits against one process's, largest difference relative to "
            f"the largest logit per rank " + ", ".join(f"{f['logits_rel']:.2e}" for f in fw)
            + f" (gate {EP_RTOL}); moe_aux rank 0 {fw[0]['aux']} against {fw[0]['aux_ref']}; "
            f"expert-weight bytes per rank {ranks[0]['runs'][label]['sgd']['expert_bytes']} "
            f"(one process {EP_EXPERT_BYTES}, 1/{n * m}); every rank in sync; flash forward / dQ / "
            f"dK/dV launches per fit {_ep_launches(EP_STEPS)} each on every rank")
    for rk in ranks:
        log(f"    rank {rk['rank']} step times (Adam, host-timed, {EP_TIMED} after {EP_WARMUP}; one "
            f"process {ref['ms']:.3f} ms): " + "; ".join(
                f"{label} {run['times']['ms']:.3f} ms/step (" + ", ".join(
                    f"{k} {v:.3f}" for k, v in run["times"].items() if k != "ms")
                + f"; fit peak {run['peak'] / 2**20:.1f} MiB)"
                for label, run in rk["runs"].items()) + f" [{card}]")
    recs = [rk["recipe"] for rk in ranks]
    first, second = recs[0]["first"], recs[0]["second"]
    for name, rec in (("first", first), ("second", second)):
        losses = rec["step_losses"]
        log(f"    d train_translator(moe_experts={EP_EXPERTS}, expert_parallel=2) on {rec['mesh']}, "
            f"{name} run: {len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, eval loss "
            f"{rec['test_loss']:.6f}, moe_aux {rec['moe_aux']:.6f}, BLEU (the gathered model) "
            f"{rec['bleu']:.6f}, resumed from {rec['resumed']}, w_up per rank {rec['w_up_shape']}, "
            f"ep_allreduce {rec['comms'].get('ep_allreduce_calls')} calls; launches per rank "
            + ", ".join(str(tuple(x[name]["launches"][k] for k in TENSOR_CORE_KERNELS)) for x in recs))
        if (rec["mesh"] != {"data": 2, "expert": 2} or not np.all(np.isfinite(losses))
                or not np.isfinite(rec["bleu"]) or rec["w_up_shape"][0] != EP_EXPERTS // 2
                or not all(x[name]["pointer"] for x in recs)):
            failed.append(f"the EP recipe's {name} run did not train, evaluate, decode and checkpoint")
        for x in recs:
            per = _ep_launches(len(x[name]["step_losses"]))
            if (x[name]["launches"]["flash_attention_bwd_dq"], x[name]["launches"]["flash_attention_bwd_dkv"]) != (per, per):
                failed.append(f"the EP recipe ({name}): dQ/dK/dV launches {x[name]['launches']}, not {per} each")
    if first["resumed"] is not None or second["resumed"] != len(first["step_losses"]):
        failed.append(f"the EP recipe's second run resumed from {second['resumed']}, not step "
             f"{len(first['step_losses'])}")
    took = t_pre + wall + time.perf_counter() - t_post
    log(f"  phase 7i took {took:.1f} s")
    if failed:
        fail("; ".join(failed))
    return dict(wall=wall, ranks=ranks, seconds=took, ref=ref,
                gates={k: {f: v[f] for f in ("loss_rel", "ctrl_loss_rel", "key_bias")} for k, v in gates.items()})


# -- phases 7f-7l: one gang for the parallel axes ---------------------------------

SHARED_GANG = 4


def _to_host(obj):
    """``obj`` with every tensor in it copied to the host."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def shared_gang_rank(jobs: list) -> list:
    """One rank of the gang that phases 7f, 7g, 7h, 7i and 7l share: each
    phase's rank function (``"chip_smoke:<name>"``, its arguments) in
    turn, each result (on the host, so that it holds no device memory
    through the later phases) with the seconds it took and the device
    memory this rank held when the phase began. One start of the gang's
    processes serves five phases: on the card's machine a start is ~15 s
    (importing torch)."""
    import gc

    import torch

    out = []
    for fn, args in jobs:
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        result = _to_host(globals()[fn.split(":", 1)[1]](*args))
        out.append((result, time.perf_counter() - t0, held))
    return out


def run_shared_gang(phases: list) -> list:
    """Phases 7f-7l: each phase, a header and a generator, runs its work in
    this process up to its gang job (what it yields); one ``Session`` ->
    ``Distributor`` gang of ``SHARED_GANG`` ranks over gloo runs every
    job in turn (``shared_gang_rank``); then each phase gets rank 0's
    result and its seconds in the gang back and runs its gates. Returns
    what each phase returns."""
    import shutil
    import threading

    from machine_learning_apache_spark_tpu_torch import Session
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs

    jobs = []
    for header, phase in phases:
        log(header)
        jobs.append(next(phase))
    # Every rank serves its observability plane (an HTTP server on an
    # ephemeral port, its sidecar in tdir): tools/torch_gang_status.py
    # scrapes the running gang once from a thread beside it.
    tdir = scratch_dir() / "shared_gang"
    shutil.rmtree(tdir, ignore_errors=True)
    status: dict = {}
    watcher = threading.Thread(target=live_gang_status, args=(tdir, SHARED_GANG, status), daemon=True)
    watcher.start()
    spark = Session.builder.appName("ParallelAxesTranslation").config(
        "spark.executor.instances", str(SHARED_GANG)).getOrCreate()
    try:
        t0 = time.perf_counter()
        results = Distributor(num_processes=spark.conf.executor_instances, timeout=2400, telemetry_http=0,
                              env={"MLSPARK_TELEMETRY_DIR": str(tdir)}).run(
            "chip_smoke:shared_gang_rank", jobs)
        wall = time.perf_counter() - t0
    finally:
        spark.stop()
    watcher.join(timeout=90.0)
    if kill_stray_gangs() != 0:
        fail("the gang of phases 7f-7l left a stray process group")
    rows = status.get("rows", [])
    REPORT_CLI_SECONDS["live gang status (beside the gang of 7f-7l)"] = status.get("seconds", 0.0)
    log(f"  tools/torch_gang_status.py against the running {SHARED_GANG}-rank gang, "
        f"{status.get('waited', float('nan')):.1f} s after its start: exit {status.get('rc')} in "
        f"{status.get('seconds', float('nan')):.2f} s, ranks {[r.get('rank') for r in rows]}, status "
        f"{[r.get('status') for r in rows]}, phase {[r.get('phase') for r in rows]}")
    if (status.get("rc") != 0 or [r.get("rank") for r in rows] != list(range(SHARED_GANG))
            or any(r.get("status") not in ("ok", "degraded") for r in rows)):
        fail(f"tools/torch_gang_status.py did not scrape every rank of the running gang: {status}")
    names = [header.split(":")[0].removeprefix("== ") for header, _ in phases]
    log(f"== {names[0]} to {names[-1]}: one {SHARED_GANG}-rank gang ran each phase's gang work in turn, "
        f"{wall:.2f} s spawn to result: " + ", ".join(
            f"{n} {w:.1f} s (rank 0 held {held / 2**20:.1f} MiB of device memory as it began)"
            for n, (_, w, held) in zip(names, results)))
    out = []
    for name, (_, phase), (result, seconds, _) in zip(names, phases, results):
        log(f"== {name}, its gates")
        try:
            phase.send((result, seconds))
        except StopIteration as done:
            out.append(done.value)
        else:
            fail(f"{name} asked for a second gang job")
    return out


# -- phase 7j: the streaming ingest pipeline and elastic resume -----------------------

INGEST_BATCH = 32
INGEST_K = 4
INGEST_PER_EPOCH = 3 * INGEST_BATCH  # a mixture epoch of 3 steps: checkpoints inside a fixture pass
INGEST_EPOCHS = 4
ELASTIC_GANG = 4
ELASTIC_MIN_WORLD = 2
ELASTIC_GLOBAL = 48  # 12 rows a rank at 4 ranks, 16 at 3
ELASTIC_STEPS = 8  # one global batch a fit epoch: a checkpoint every step
ELASTIC_CRASH = f"crash@train_step:world={ELASTIC_GANG},rank=3,step=5"
ELASTIC_LAYERS = 2
ELASTIC_RTOL = 1e-5  # step losses, the shrunken run against the unfaulted one


def fixture_pairs() -> tuple[list, tuple[int, int]]:
    """The fixture's training pairs as ragged id lists (no pads) and the
    widths the recipe pads them to."""
    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k

    src_pipe, trg_pipe, _ = fixture_data()
    pairs = load_multi30k(str(FIXTURES), "train")
    src, trg = [s for s, _ in pairs], [t for _, t in pairs]
    widths = (src_pipe(src[:1]).shape[1], trg_pipe(trg[:1]).shape[1])
    return list(zip(src_pipe.ragged(src), trg_pipe.ragged(trg))), widths


def _pad_pair(widths):
    def pad(rec):
        out = []
        for ids, w in zip(rec, widths):
            row = np.zeros(w, np.int32)
            row[:len(ids)] = ids
            out.append(row)
        return tuple(out)
    return pad


def ingest_pipe(pairs, widths, batch: int, *, per_epoch: int | None = None, pack=None, **kw):
    """``StreamingPipeline(PairSource(fixture pairs))`` (through a
    one-source mixture when ``per_epoch`` is given, whose position rides
    the checkpoints), ``shard="records"``, padded to the recipe's widths
    in the producer thread unless packing."""
    from machine_learning_apache_spark_tpu_torch.ingest import MixtureSampler, PairSource, StreamingPipeline

    source = PairSource(pairs)
    if per_epoch is not None:
        source = MixtureSampler({"fixture": source}, records_per_epoch=per_epoch, seed=SEED)
    return StreamingPipeline(source, batch, shard="records", tail="drop", pack=pack,
                             transform=None if pack else _pad_pair(widths), **kw)


def _ingest_state(torch, dev, layers: int = 1, dropout: float = 0.1):
    """The reference recipe's model (width, Adam 1e-3) on the fixture
    vocabularies, random weights from the seed, and its training loss."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import Transformer, TransformerConfig
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        TranslationRecipe,
        make_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    src_pipe, trg_pipe, _ = fixture_data()
    r = TranslationRecipe(data_root=str(FIXTURES))
    cfg = TransformerConfig(
        src_vocab_size=len(src_pipe.vocab), trg_vocab_size=len(trg_pipe.vocab), d_model=r.d_model,
        ffn_hidden=r.ffn_hidden, num_heads=r.num_heads, num_layers=layers, dropout=dropout,
        max_len=r.max_len,
    )
    model = Transformer(cfg, generator=torch.Generator().manual_seed(SEED)).to(dev)
    return TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate)), make_translation_loss(cfg.pad_id)


def _ingest_threads() -> list[str]:
    import threading

    from machine_learning_apache_spark_tpu_torch.ingest import WORKER_PREFIX

    time.sleep(0.05)
    return [t.name for t in threading.enumerate() if t.name.startswith(WORKER_PREFIX) and t.is_alive()]


def _ingest_fit(torch, hop, data, k: int = 1, epochs: int = 1, **kw) -> dict:
    """One ``fit`` of a fresh reference model over ``data``, the launch
    counts set to 0 just before and read just after, and what reached the
    step: each batch's fields on the card or not, and the copies
    ``to_device`` made (``stack_batches`` for K steps a call)."""
    from machine_learning_apache_spark_tpu_torch.train import loop as tloop

    state, loss_fn = _ingest_state(torch, torch.device("cuda"))
    seen = dict(batches=0, on_card=0, copies=0, stacks=0)
    to_device, stack = tloop.to_device, tloop.stack_batches

    def there(batch, device) -> bool:
        return all(isinstance(t, torch.Tensor) and t.device == device for t in batch)

    def counted_to_device(batch, device):
        out = to_device(batch, device)
        seen["batches"] += 1
        seen["on_card"] += there(batch, device)
        seen["copies"] += sum(o is not t for o, t in zip(out, batch))
        return out

    def counted_stack(batches, device):
        seen["stacks"] += 1
        seen["batches"] += len(batches)
        seen["on_card"] += sum(there(b, device) for b in batches)
        return stack(batches, device)

    tloop.to_device, tloop.stack_batches = counted_to_device, counted_stack
    try:
        torch.cuda.synchronize()
        hop.reset_launches()
        res = tloop.fit(state, loss_fn, data=data, epochs=epochs, steps_per_call=k, log_every=0,
                        rng=torch.Generator().manual_seed(SEED), **kw)
        torch.cuda.synchronize()
    finally:
        tloop.to_device, tloop.stack_batches = to_device, stack
    return dict(state=res.state, res=res, launches=dict(hop.LAUNCHES), seen=seen, threads=_ingest_threads(),
                ms=1e3 * res.train_seconds / max(res.state.step - (res.resumed_step or 0), 1))


def _same_fit(torch, a: dict, b: dict, b_losses=None) -> tuple[bool, int]:
    params = all(torch.equal(x, y) for x, y in zip(a["state"].params, b["state"].params))
    want = b["res"].step_losses if b_losses is None else b_losses
    got = a["res"].step_losses
    return params, sum(x != y for x, y in zip(got, want)) + abs(len(got) - len(want))


def _data_events() -> dict:
    """The ``data.*`` spans and the H2D byte counter the ingest stage
    recorded since the last ``telemetry.reset()``."""
    from machine_learning_apache_spark_tpu_torch import telemetry

    spans: dict = {}
    for ev in telemetry.get_log().snapshot():
        if ev.kind == "span_end" and ev.name.startswith("data."):
            spans.setdefault(ev.name, []).append(float(ev.value))
    return dict(spans=spans, bytes_h2d=telemetry.get_registry().counter("data", "bytes_h2d").value)


def ingest_slice(torch, hop, card: str) -> dict:
    """Phase 7j (a): the reference model through ``fit(data=
    StreamingPipeline(...))`` with the device stage on the card, against
    the same fit over a plain list of the same host batches."""
    import tempfile

    from machine_learning_apache_spark_tpu_torch import telemetry
    from machine_learning_apache_spark_tpu_torch.data.packing import pack_translation_pairs
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    pairs, widths = fixture_pairs()
    host_batches = list(ingest_pipe(pairs, widths, INGEST_BATCH, device=False))
    steps = len(host_batches)
    failed: list[str] = []
    _ingest_fit(torch, hop, host_batches[:2])  # untimed: the first fit's one-time costs
    runs = {"list K=1": _ingest_fit(torch, hop, host_batches)}
    pipes = {}
    for k in (1, INGEST_K):
        telemetry.reset()
        pipes[k] = ingest_pipe(pairs, widths, INGEST_BATCH)
        runs[f"pipeline K={k}"] = _ingest_fit(torch, hop, pipes[k], k)
        runs[f"pipeline K={k}"]["data"] = _data_events()
    runs[f"list K={INGEST_K}"] = _ingest_fit(torch, hop, host_batches, INGEST_K)
    layers = runs["list K=1"]["state"].model.cfg.num_layers
    base = runs["list K=1"]
    for label, run in runs.items():
        params, losses = _same_fit(torch, run, base)
        seen = run["seen"]
        got_l = tuple(run["launches"][n] for n in TRAIN_KERNELS)
        log(f"  {label}: {run['state'].step} steps, parameters equal to the list at K=1 bit for bit: "
            f"{params}, step losses differing {losses}; batches reaching the step on the card "
            f"{seen['on_card']} of {seen['batches']}, to_device copies {seen['copies']}, K-step stacks "
            f"{seen['stacks']}; flash fwd / dQ / dK/dV launches {got_l}; ingest threads after: {run['threads']}")
        if not params or losses or run["state"].step != steps:
            failed.append(f"{label} did not train bit for bit like the list at K=1")
        if got_l != (3 * layers * steps,) * 3:
            failed.append(f"{label}: flash launches {got_l}, not {3 * layers * steps} each")
        if run["threads"]:
            failed.append(f"{label}: ingest threads {run['threads']} outlived fit")
        if label.startswith("pipeline") and (seen["on_card"] != steps or seen["copies"]):
            failed.append(f"{label}: {seen['on_card']} of {steps} batches reached the step on the card, "
                          f"{seen['copies']} copied again in to_device")
    for k, pipe in pipes.items():
        if pipe.h2d_copies != 2 * steps:
            failed.append(f"pipeline K={k}: {pipe.h2d_copies} host-to-card copies, not 2 a batch")
    for k in (1, INGEST_K):
        run, lst = runs[f"pipeline K={k}"], runs[f"list K={k}"]
        d = run["data"]
        wait = sum(d["spans"].get("data.wait", []))
        h2d = d["spans"].get("data.h2d", [])
        log(f"  K={k}: {run['ms']:.3f} ms/step through the pipeline, {lst['ms']:.3f} ms/step over the "
            f"list (each fit's wall over its {steps} steps, one epoch; K={INGEST_K}'s first group "
            f"captures its graph); data.wait {wait:.6f} s = {wait / run['res'].train_seconds:.6f} of the "
            f"fit's wall; data.h2d mean {1e3 * float(np.mean(h2d)) if h2d else float('nan'):.4f} ms over "
            f"{len(h2d)} batches (the copies' enqueue); data.bytes_h2d {d['bytes_h2d']:.0f} [{card}]")

    # Packing: the pipeline's rows (through the card) equal the one-shot packer's.
    pack = dict(src_len=widths[0], trg_len=widths[1], pad_id=0)
    packed = [tuple(t.cpu().numpy() for t in b) for b in ingest_pipe(pairs, widths, 2, pack=pack)]
    want = pack_translation_pairs([s for s, _ in pairs], [t for _, t in pairs], **pack).arrays()
    rows = 2 * len(packed)
    pack_equal = bool(packed) and all(
        np.array_equal(np.concatenate([b[i] for b in packed]), w[:rows]) for i, w in enumerate(want))
    log(f"  pack=: {rows} packed rows through the card equal the one-shot packer's first {rows} "
        f"(of {len(want[0])}): {pack_equal}")
    if not pack_equal:
        failed.append("the pipeline's packed rows differ from pack_translation_pairs'")

    # A run checkpointed inside the fixture pass, stopped and resumed,
    # replays the stream: the uninterrupted run's parameters, bit for bit.
    whole = _ingest_fit(torch, hop, ingest_pipe(pairs, widths, INGEST_BATCH, per_epoch=INGEST_PER_EPOCH),
                        epochs=INGEST_EPOCHS)
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as d:
        with CheckpointManager(d) as ck:
            first = _ingest_fit(torch, hop, ingest_pipe(pairs, widths, INGEST_BATCH, per_epoch=INGEST_PER_EPOCH),
                                epochs=INGEST_EPOCHS // 2, checkpointer=ck)
        with CheckpointManager(d) as ck:
            second = _ingest_fit(torch, hop, ingest_pipe(pairs, widths, INGEST_BATCH, per_epoch=INGEST_PER_EPOCH),
                                 epochs=INGEST_EPOCHS, checkpointer=ck, resume=True)
    split = first["res"].step_losses + second["res"].step_losses
    params, _ = _same_fit(torch, second, whole)
    replayed = params and split == whole["res"].step_losses
    log(f"  {INGEST_EPOCHS // 2} + {INGEST_EPOCHS // 2} mixture epochs of {INGEST_PER_EPOCH} records "
        f"(checkpoints every {INGEST_PER_EPOCH // INGEST_BATCH} steps, inside the fixture's pass), resumed "
        f"from step {second['res'].resumed_step}: parameters and step losses equal to {INGEST_EPOCHS} "
        f"in one run bit for bit: {replayed}; ingest threads after {second['threads']}")
    if not replayed or second["res"].resumed_step != first["state"].step or second["threads"]:
        failed.append("the resumed run did not replay the stream bit for bit")
    took = time.perf_counter() - t0
    log(f"  phase 7j (a) took {took:.1f} s")
    if failed:
        fail("; ".join(failed))
    paths = {label: run["launches"] for label, run in runs.items()}
    paths["resume: whole, first, second"] = {
        n: whole["launches"][n] + first["launches"][n] + second["launches"][n] for n in hop.LAUNCHES}
    return dict(seconds=took, paths=paths, ms={label: run["ms"] for label, run in runs.items()},
                data={k: dict(wait=sum(runs[f"pipeline K={k}"]["data"]["spans"].get("data.wait", [])),
                              bytes_h2d=runs[f"pipeline K={k}"]["data"]["bytes_h2d"]) for k in pipes})


def _logical_flat(stored: dict, plan) -> np.ndarray:
    """A ZeRO-1 flat vector in the parameters' order, pads taken out, from
    the ranks' stored runs ``{data index: vector}``, read through
    ``Zero1State.bucket_span`` (the map the step itself uses)."""
    import types

    from machine_learning_apache_spark_tpu_torch.parallel.zero import Zero1State

    full = np.zeros(plan.padded, np.float32)
    for d, vec in stored.items():
        for k in range(len(plan.buckets)):
            in_flat, in_shard = Zero1State.bucket_span(types.SimpleNamespace(plan=plan, rank=d, model_rank=0), k)
            full[in_flat] = np.asarray(vec)[in_shard]
    return np.concatenate([full[o:o + n] for o, n in zip(plan.offsets, plan.sizes)])


def elastic_gang_rank(root: str, pairs, widths) -> dict:
    """One rank of phase 7j (b)'s gang: the reference model (2 layers,
    dropout 0) under ZeRO-1 and Adam through ``fit(data=StreamingPipeline)``
    over the gang's data axis, one global batch a fit epoch and a
    checkpoint each, ``resume=True`` (elastic through the launcher's
    ``MLSPARK_ELASTIC``). The state ``elastic_restore`` hands ``fit`` is
    kept; rank 0 holds every rank's against the old group's checkpoint
    (the flat moments through both layouts, the parameters). Rank 0's
    result: step losses, parameters, the resumed step, every rank's
    launches, steps and elastic events."""
    import os

    import torch
    import torch.distributed as dist

    from machine_learning_apache_spark_tpu_torch import telemetry
    from machine_learning_apache_spark_tpu_torch.launcher.coordinator import current_device
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh
    from machine_learning_apache_spark_tpu_torch.parallel.zero import make_flat_plan, plan_layout
    from machine_learning_apache_spark_tpu_torch.train import checkpoint as ck
    from machine_learning_apache_spark_tpu_torch.train import reshard
    from machine_learning_apache_spark_tpu_torch.train.loop import fit

    rank, world = dist.get_rank(), dist.get_world_size()
    state, loss_fn = _ingest_state(torch, current_device(), layers=ELASTIC_LAYERS, dropout=0.0)
    pipe = ingest_pipe(pairs, widths, ELASTIC_GLOBAL // world, per_epoch=ELASTIC_GLOBAL)
    captured: dict = {}
    restore = reshard.elastic_restore

    def keep(checkpointer, template, **kwargs):
        # The restored state, and the old group's step it came from, read
        # before this run's own checkpoints prune that step.
        out = restore(checkpointer, template, **kwargs)
        if out is not None:
            st, step = out[0], out[1]
            old_dir = os.path.join(root, "ckpt_r0")
            stamp = ck.read_meta_at(old_dir, step)["topology"]
            captured.update(step=step, plan=st.plan, stamp=stamp, params={
                k: v.detach().to("cpu", copy=True) for k, v in st.model.state_dict().items()},
                moments={k: v.detach().to("cpu", copy=True) for k, v in st.opt_state.items()
                         if getattr(v, "ndim", 0)},
                old=[ck.read_raw_payload(os.path.join(root, f"ckpt_r{r}"), step)
                     for r in (range(stamp["world_size"]) if rank == 0 else (0,))])
        return out

    reshard.elastic_restore = keep
    try:
        with ck.CheckpointManager(os.path.join(root, f"ckpt_r{rank}")) as mgr:
            torch.cuda.synchronize()
            hop.reset_launches()
            res = fit(state, loss_fn, data=pipe, epochs=ELASTIC_STEPS, mesh=data_parallel_mesh(),
                      dp_mode="zero1", checkpointer=mgr, resume=True, log_every=0,
                      rng=torch.Generator().manual_seed(SEED))
            torch.cuda.synchronize()
            launches = dict(hop.LAUNCHES)
    finally:
        reshard.elastic_restore = restore
    events = [dict(name=e.name, **(e.attrs or {})) for e in telemetry.get_log().snapshot()
              if e.name in ("train.elastic_restore", "train.elastic_resume")]
    gate = None
    moments = _gather(captured.get("moments"))
    if captured:
        old = captured["old"]
        all_params = _gather([k for k, v in old[0]["model"].items() if not torch.equal(captured["params"][k], v)])
        if rank == 0:
            old_world = captured["stamp"]["world_size"]
            old_plan = make_flat_plan(list(res.state.model.parameters()), old_world, res.state.config.bucket_bytes)
            equal = {key: bool(np.array_equal(
                _logical_flat({r: old[r]["optimizer"][key].numpy() for r in range(old_world)}, old_plan),
                _logical_flat({r: m[key].numpy() for r, m in enumerate(moments)}, captured["plan"])))
                for key in sorted(captured["moments"])}
            gate = dict(step=captured["step"], old_world=old_world,
                        layout_ok=plan_layout(old_plan) == captured["stamp"]["layout"],
                        buckets=(len(old_plan.buckets), len(captured["plan"].buckets)),
                        moments=equal, params=not any(all_params), params_differing=all_params)
        del old
    ranks = _gather(dict(rank=rank, world=world, launches=launches, steps=len(res.step_losses),
                         events=events, threads=_ingest_threads(), resumed=res.resumed_step))
    if rank != 0:
        return None
    return dict(ranks=ranks, gate=gate, world=world, resumed=res.resumed_step,
                step_losses=res.step_losses,
                params={k: v.detach().cpu() for k, v in res.state.model.state_dict().items()})


def elastic_slice(torch, hop, card: str) -> dict:
    """Phase 7j (b): ``Session`` -> ``Distributor(elastic=True)`` gangs of
    ``elastic_gang_rank`` over gloo — an unfaulted 4-rank run and one whose
    rank 3 crashes past a durable checkpoint and which shrinks to 3. The
    shrunken run is held to the unfaulted one: step losses within 1e-5
    relative, each tensor within phase 7e's ZeRO-1 gate."""
    import shutil

    from machine_learning_apache_spark_tpu_torch import Session
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    pairs, widths = fixture_pairs()
    root = scratch_dir() / "elastic"
    shutil.rmtree(root, ignore_errors=True)
    spark = Session.builder.appName("ElasticIngest").config(
        "spark.executor.instances", str(ELASTIC_GANG)).getOrCreate()
    walls, out = {}, {}
    try:
        for label, env in (("unfaulted", {}), ("faulted", {faults.ENV_PLAN: ELASTIC_CRASH,
                                                            faults.ENV_MARKER_DIR: str(root / "markers")})):
            t0 = time.perf_counter()
            out[label] = Distributor(
                num_processes=spark.conf.executor_instances, timeout=900, env=env, elastic=True,
                rank_restart_budget=0, elastic_min_world=ELASTIC_MIN_WORLD,
            ).run("chip_smoke:elastic_gang_rank", str(root / label), pairs, widths)
            walls[label] = time.perf_counter() - t0
    finally:
        spark.stop()
    if kill_stray_gangs() != 0:
        fail("an elastic gang left a stray process group")
    whole, shrunk = out["unfaulted"], out["faulted"]
    failed: list[str] = []
    resumed, gate = shrunk["resumed"], shrunk["gate"]
    restore_ev = [e for r in shrunk["ranks"] for e in r["events"] if e["name"] == "train.elastic_restore"]
    log(f"  Session -> Distributor, {ELASTIC_GANG} ranks on one card over gloo, ZeRO-1, Adam, global batch "
        f"{ELASTIC_GLOBAL}, {ELASTIC_STEPS} steps with a checkpoint each: unfaulted {walls['unfaulted']:.2f} s "
        f"spawn to result; with {ELASTIC_CRASH}: {walls['faulted']:.2f} s, the gang shrank to "
        f"{shrunk['world']} ranks and resumed elastically from step {resumed}; time to recover (the "
        f"faulted run's wall beyond the unfaulted one's) {walls['faulted'] - walls['unfaulted']:.2f} s [{card}]")
    log("    elastic_restore per rank: " + ", ".join(
        f"{e['seconds']:.3f} s, {e['bytes_read']} payload bytes read" for e in restore_ev) + f" [{card}]")
    if shrunk["world"] != ELASTIC_GANG - 1 or resumed is None or len(restore_ev) != ELASTIC_GANG - 1:
        failed.append(f"the gang did not shrink {ELASTIC_GANG} -> {ELASTIC_GANG - 1} and resume elastically "
                      f"(world {shrunk['world']}, resumed {resumed}, {len(restore_ev)} restores)")
    if whole["world"] != ELASTIC_GANG or whole["resumed"] is not None:
        failed.append("the unfaulted gang did not run whole")
    log(f"    the resharded state (as elastic_restore handed it to fit) against the old "
        f"{gate and gate['old_world']}-rank group's step {gate and gate['step']}: flat moments through "
        f"both layouts (buckets {gate and gate['buckets']}) bit for bit {gate and gate['moments']}; every "
        f"rank's parameters bit for bit {gate and gate['params']}; stamp layout = the plan's "
        f"{gate and gate['layout_ok']}")
    if not gate or not gate["params"] or not gate["layout_ok"] or not all(gate["moments"].values()) \
            or not gate["moments"]:
        failed.append(f"the resharded state differs from the old group's ({gate})")
    want_losses = whole["step_losses"][resumed or 0:]
    loss_rel = _max_rel(shrunk["step_losses"], want_losses) if shrunk["step_losses"] else float("inf")
    pg = _param_gate(torch, shrunk["params"], whole["params"], ELASTIC_STEPS)
    worst = sorted(pg["rel"].items(), key=lambda kv: -kv[1])[:3]
    log(f"    the shrunken run against the unfaulted one on the same global batches: step losses max "
        f"relative difference {loss_rel:.3e} (gate {ELASTIC_RTOL}); per tensor relative difference "
        f"(phase 7e's gate {GANG_RTOL}, the key biases apart), the three largest: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst)
        + f"; same bits {pg['same_bits']}; key biases {pg['key_bias_abs']:.3e} (bound {pg['key_bias_bound']:.3e})")
    if len(shrunk["step_losses"]) != len(want_losses) or loss_rel > ELASTIC_RTOL or not pg["ok"]:
        failed.append(f"the shrunken run left the unfaulted run's trajectory (losses {loss_rel:.3e}, "
                      f"parameters {pg['over']}, key biases {pg['key_bias_abs']:.3e})")
    for label, run in out.items():
        for r in run["ranks"]:
            got_l = tuple(r["launches"][n] for n in TRAIN_KERNELS)
            want_l = 3 * ELASTIC_LAYERS * r["steps"]
            if got_l != (want_l,) * 3 or r["threads"]:
                failed.append(f"{label} rank {r['rank']}: flash launches {got_l} over {r['steps']} steps "
                              f"(not {want_l} each), ingest threads {r['threads']}")
        log(f"    {label}: per rank (steps, flash fwd / dQ / dK/dV launches) " + ", ".join(
            f"{r['rank']}: ({r['steps']}, {tuple(r['launches'][n] for n in TRAIN_KERNELS)})" for r in run["ranks"]))
    took = time.perf_counter() - t_phase
    log(f"  phase 7j (b) took {took:.1f} s")
    if failed:
        fail("; ".join(failed))
    return dict(walls=walls, seconds=took, resumed=resumed, loss_rel=loss_rel, gate=gate,
                restore=restore_ev, ranks={k: v["ranks"] for k, v in out.items()},
                params=dict(max_rel=pg["max_rel"], key_bias=pg["key_bias_abs"]))


# -- phase 7k: the serving fleet ---------------------------------------------------

# Two replicas of phase 4's paged engine, each its own process on the card
# (``ReplicaGang(platform=None)``), behind one ``FleetRouter(policy=
# "affinity")``; a third added and one drained by the autoscaler.
FLEET_REPLICAS = 2
FLEET_CLIENTS = 16  # client threads routing phase 4's prompts (half its engine's rows)
FLEET_KILL_CLIENTS = 8  # closed-loop clients while rank 1 is killed
FLEET_REPEATS = 8  # the prompts over again, for the throughput windows
FLEET_HOT_AFTER_S = 5.0  # the hot load on, once the added replica is healthy
FLEET_HOT_CLIENTS = 16  # closed-loop load that trips the queue-depth trigger
FLEET_WAIT_S = 180.0  # a replica's start-up (import, weights, graph capture) or a drain, at most
FLEET_AUTOSCALE = dict(min_replicas=2, max_replicas=3, burn_up=0.5, burn_down=0.05, queue_up=1.5,
                       queue_down=0.5, hysteresis_ticks=2, cooldown_s=2.0, drain_deadline_s=30.0,
                       drain_batch_shed=0.5)


def fleet_replica_rank(knobs: dict, max_s: float = 900.0) -> dict:
    """One replica of phase 7k's gang: phase 4's translator (the reference
    model at full width, the ``VOCAB_WORDS``-word vocabularies, weights
    from the seed) on ``fleet.replica.replica_device()`` — the card —
    served behind the fleet's data plane until the gang stops it. Its
    kernel launches and memory ride its ``/statusz`` (the smoke cannot
    read another process's counters) and its result."""
    import torch_fleet_bench as fb

    from machine_learning_apache_spark_tpu_torch.fleet.replica import replica_device

    _, src_pipe, trg_pipe = serving_pipes()
    translator = build_translator(replica_device(), model_params(src_pipe, trg_pipe), src_pipe, trg_pipe)
    return fb.serve_counted(translator, knobs, max_s=max_s)


def _fleet_wait(pred, seconds: float = FLEET_WAIT_S, poll: float = 0.05) -> float | None:
    """Seconds until ``pred()`` held, or None if it never did."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        if pred():
            return time.monotonic() - t0
        time.sleep(poll)
    return None


def _fleet_healthy(router) -> dict:
    return {r: s for r, s in router._scrape.snapshots().items() if s.healthy}


def _fleet_load(fb, router, prompts, clients: int) -> tuple:
    """Closed-loop load in a thread until the returned event is set."""
    import threading

    stop, result = threading.Event(), {}
    thread = threading.Thread(target=lambda: result.update(fb.drive_load(
        router, prompts, clients=clients, stop=stop, tier="interactive", deadline_s=120.0)), daemon=True)
    thread.start()
    return stop, thread, result


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def fleet_slice(torch, hop, card: str, translator, prompts, single: dict) -> dict:
    """Phase 7k: (a) two replicas on the card behind the router route phase
    4's prompts; (b) rank 1 killed under closed-loop load and restarted;
    (c) one autoscale cycle 2 -> 3 -> 2. ``single`` is phase 4's paged fp32
    run over the same prompts, the in-process oracle and baseline."""
    import shutil

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import torch_fleet_bench as fb

    from machine_learning_apache_spark_tpu_torch.fleet import AutoscaleConfig, FleetAutoscaler
    from machine_learning_apache_spark_tpu_torch.fleet.scrape import find_fleet_sidecars
    from machine_learning_apache_spark_tpu_torch.launcher import kill_stray_gangs
    from machine_learning_apache_spark_tpu_torch.telemetry.aggregate import replica_skew

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the replicas share the card with this process
    root = scratch_dir() / "fleet"
    shutil.rmtree(root, ignore_errors=True)
    knobs = dict(SERVE)
    failed, out = [], {}
    t_spawn = time.monotonic()
    gang, router = fb.start_fleet(
        FLEET_REPLICAS, str(root), "chip_smoke:fleet_replica_rank", knobs, platform=None,
        key_fn=fb.make_key_fn(translator), gang_kw=dict(backoff_base=0.1))
    try:
        # (a) Start-up: spawn to the first healthy scrape (import, weights,
        # the engine's graph capture), each replica.
        startup = {}

        def all_up():
            for r in _fleet_healthy(router):
                startup.setdefault(r, time.monotonic() - t_spawn)
            return len(startup) >= FLEET_REPLICAS

        if _fleet_wait(all_up) is None:
            fail(f"the fleet never came healthy: {gang.status()}")
        log(f"  (a) {FLEET_REPLICAS} replicas of phase 4's paged engine on the card, start-up s (spawn to "
            f"first healthy scrape, graph capture included): "
            + ", ".join(f"rank {r} {t:.2f}" for r, t in sorted(startup.items())) + f" [{card}]")
        base = fb.replica_sections(router)
        devices = {r: (s or {}).get("device") for r, s in base.items()}
        if any(d is None or not d.startswith("cuda") for d in devices.values()):
            failed.append(f"a replica is not on the card: {devices}")
        routed = fb.route(router, prompts, clients=FLEET_CLIENTS, deadline_s=120.0)
        share, notes = agreement(routed["outs"], single["outs"])
        # Throughput: the same closed-loop work through the fleet and
        # through one engine in this process, both after their first pass.
        work = prompts * FLEET_REPEATS
        steady = fb.route(router, work, clients=FLEET_CLIENTS, deadline_s=120.0)
        after = fb.replica_sections(router)
        serving = fb.replica_sections(router, "serving")
        conservation = fb.conservation_gate(router)
        launches = {r: _delta(after[r]["launches"], base[r]["launches"]) for r in after}
        local = fb.local_route(translator, knobs, work, clients=FLEET_CLIENTS)
        words, local_words = (sum(len(o.split()) for o in r["outs"] if o) for r in (steady, local))
        single_words = sum(len(o.split()) for o in single["outs"])
        skew = replica_skew(router._scrape.rows())
        per_replica = router.stats()["per_replica"]
        log(f"  (a) {len(prompts)} prompts routed from {FLEET_CLIENTS} client threads: "
            f"{len(prompts) - len(routed['errors'])} completed in {routed['wall']:.3f} s [{card}]")
        log(f"    throughput, {len(work)} requests ({FLEET_REPEATS} x the prompts) from {FLEET_CLIENTS} "
            f"closed-loop clients: fleet of {FLEET_REPLICAS} {len(work) / steady['wall']:.2f} requests/s, "
            f"{words / steady['wall']:.1f} generated tokens/s (words of the outputs); one engine in this "
            f"process {len(work) / local['wall']:.2f} requests/s, {local_words / local['wall']:.1f} "
            f"tokens/s; phase 4's engine, all {len(prompts)} submitted at once: "
            f"{len(single['outs']) / single['wall']:.2f} requests/s, {single_words / single['wall']:.1f} "
            f"tokens/s [{card}]")
        log(f"    per replica: completed {({r: v['completed'] for r, v in sorted(per_replica.items())})}, "
            f"skew {json.dumps(skew)}; launches in (a) "
            f"{({r: {k: v for k, v in d.items() if v} for r, d in launches.items()})}; peak memory "
            f"{({r: after[r].get('peak_bytes') for r in after})} B; recompiles_after_warmup "
            f"{({r: s.get('recompiles_after_warmup') for r, s in serving.items()})} [{card}]")
        log(f"    token agreement with phase 4's paged fp32 engine: {share:.6f} (gate >= {AGREEMENT_MIN})")
        for n in notes:
            log(f"      mismatch: {n}")
        log(f"    router ledger {conservation['router_ledger']}, scraped in_flight "
            f"{conservation['replica_in_flight']}")
        if routed["errors"] or steady["errors"]:
            failed.append(f"routed requests failed: {(routed['errors'] + steady['errors'])[:4]}")
        if share < AGREEMENT_MIN:
            failed.append(f"fleet token agreement {share:.4f} < {AGREEMENT_MIN}")
        if not conservation["ok"]:
            failed.append(f"a replica kept requests in flight: {conservation['replica_in_flight']}")
        if any(s.get("recompiles_after_warmup") != 0 for s in serving.values()):
            failed.append("a replica recompiled after warmup")
        if fb.served_ranks(router) != list(range(FLEET_REPLICAS)):
            failed.append(f"not every replica served: {per_replica}")
        for r, d in launches.items():
            for name in SERVING_KERNELS:
                if d.get(name, 0) <= 0:
                    failed.append(f"replica {r} never launched {name} in (a)")
        out["a"] = dict(startup_s=startup, wall=routed["wall"], agreement=share,
                        requests_per_s=len(work) / steady["wall"], tokens_per_s=words / steady["wall"],
                        local_requests_per_s=len(work) / local["wall"],
                        local_tokens_per_s=local_words / local["wall"],
                        single_requests_per_s=len(single["outs"]) / single["wall"],
                        single_tokens_per_s=single_words / single["wall"], skew=skew,
                        peak_bytes={r: after[r].get("peak_bytes") for r in after}, launches=launches,
                        ledger=conservation["router_ledger"])

        # (b) Kill rank 1 under closed-loop load; time until it scrapes
        # healthy again (a new process) and serves a routed request.
        stop, thread, load = _fleet_load(fb, router, prompts, FLEET_KILL_CLIENTS)
        time.sleep(2.0)
        old_pid = find_fleet_sidecars(str(root))[1]["pid"]
        per = router.stats()["per_replica"]
        rank0_at_kill, rank1_at_kill = per[0]["completed"], per[1]["completed"]
        t_kill = time.monotonic()
        if not gang.kill_rank(1):
            fail("kill_rank(1) found no live rank 1")
        marks = {}

        def rank1_back():
            side = find_fleet_sidecars(str(root)).get(1)
            snap = router._scrape.snapshots().get(1)
            if side and side.get("pid") != old_pid and snap is not None and snap.healthy:
                marks.setdefault("healthy", time.monotonic() - t_kill)
                marks.setdefault("rank0", router.stats()["per_replica"][0]["completed"])
            return "healthy" in marks and router.stats()["per_replica"][1]["completed"] > rank1_at_kill

        recover = _fleet_wait(rank1_back)
        time.sleep(1.0)
        stop.set()
        thread.join()
        drained = _fleet_wait(lambda: router.ledger()["in_flight"] == 0, 60.0)
        conservation = fb.conservation_gate(router)
        status = gang.status()
        outage = marks.get("rank0", rank0_at_kill) - rank0_at_kill
        log(f"  (b) rank 1 SIGKILLed under {FLEET_KILL_CLIENTS} closed-loop clients: time to recover (kill to "
            f"rank 1 serving a routed request again) "
            f"{'never' if recover is None else f'{recover:.2f} s'}, healthy again after "
            f"{marks.get('healthy', float('nan')):.2f} s; rank 0 completed {outage} during the outage; "
            f"load {json.dumps({k: load.get(k) for k in ('completed', 'failed', 'failed_by_rank', 'failures', 'rejected', 'unavailable', 'expired', 'requests_per_sec', 'tokens_per_sec')})}; "
            f"restarts {status['restarts']} [{card}]")
        if recover is None:
            failed.append(f"rank 1 did not come back: {status}")
        if set(load.get("failed_by_rank", {})) - {1} or load.get("failed", 0) > FLEET_KILL_CLIENTS:
            failed.append(f"requests lost beyond rank 1's in-flight: {load}")
        if load.get("rejected") or load.get("unavailable") or load.get("expired"):
            failed.append(f"the kill cost more than rank 1's in-flight: {load}")
        if outage <= 0:
            failed.append("rank 0 served nothing while rank 1 was down")
        if drained is None or not conservation["ok"]:
            failed.append(f"the ledger did not balance after the kill: {conservation}")
        out["b"] = dict(time_to_recover_s=recover, healthy_s=marks.get("healthy"), rank0_during_outage=outage,
                        load=load, restarts=status["restarts"], ledger=conservation["router_ledger"])

        # (c) One autoscale cycle on the router's scrape loop: queue-depth
        # load takes the gang 2 -> 3, a light load back to 2 by draining
        # the coldest replica, whose accepted work must complete.
        # Every control step logs its decision at INFO, ten a second here;
        # the phase prints the decisions that act.
        logging.getLogger(FleetAutoscaler.__module__).setLevel(logging.WARNING)
        scaler = FleetAutoscaler(gang, config=AutoscaleConfig(**FLEET_AUTOSCALE),
                                 admission=router.admission).attach(router._scrape)
        stop, thread, hot = _fleet_load(fb, router, prompts, FLEET_HOT_CLIENTS)
        up = _fleet_wait(lambda: scaler.scale_ups >= 1, 60.0)
        added = next((d["rank"] for d in scaler.decisions if d["action"] == "scale_up"), None)
        added_up = None if up is None else _fleet_wait(lambda: added in _fleet_healthy(router))
        time.sleep(FLEET_HOT_AFTER_S)  # the hot load on three replicas
        seen = {r: (s.status, s.in_flight, s.consecutive_failures)
                for r, s in sorted(router._scrape.snapshots().items())}
        per_replica = router.stats()["per_replica"]
        stop.set()
        thread.join()
        stop, thread, light = _fleet_load(fb, router, prompts, 1)
        down = _fleet_wait(lambda: scaler.scale_downs >= 1 and len(gang.live_ranks()) == 2)
        stop.set()
        thread.join()
        drained = _fleet_wait(lambda: router.ledger()["in_flight"] == 0, 60.0)
        conservation = fb.conservation_gate(router)
        decisions = list(scaler.decisions)
        victim = next((d["rank"] for d in decisions if d["action"] == "scale_down_start"), None)
        actions = [d["action"] for d in decisions]
        log(f"  (c) autoscaler {FLEET_AUTOSCALE}: scale-up after {'never' if up is None else f'{up:.2f} s'} of "
            f"{FLEET_HOT_CLIENTS} closed-loop clients, rank {added} start-up (decision to healthy scrape) "
            f"{'never' if added_up is None else f'{added_up:.2f} s'}; drain of rank {victim} complete after "
            f"{'never' if down is None else f'{down:.2f} s'} of 1 client; hot load "
            f"{json.dumps({k: hot.get(k) for k in ('completed', 'failed', 'failed_by_rank', 'failures', 'rejected', 'requests_per_sec', 'tokens_per_sec')})}, "
            f"light load {json.dumps({k: light.get(k) for k in ('completed', 'failed', 'failed_by_rank', 'failures', 'rejected')})}; "
            f"live {gang.live_ranks()}, gang {json.dumps({k: v for k, v in gang.status().items() if k != 'workdir'})} "
            f"[{card}]")
        log(f"    at the end of the hot load: scraped (status, in_flight, failures) {seen}; the router's "
            f"per-replica outcomes {per_replica}")
        holds = {}
        for d in decisions:
            if d["action"].startswith("hold"):
                holds[d["action"]] = holds.get(d["action"], 0) + 1
            else:
                log(f"    decision: {json.dumps(d)}")
        log(f"    and {sum(holds.values())} holds {holds}")
        if up is None or added_up is None:
            failed.append(f"the autoscaler did not scale 2 -> 3 to a healthy rank: {actions}")
        if down is None or "scale_down_complete" not in actions:
            failed.append(f"the autoscaler did not drain back to 2: {actions}")
        lost = {k: hot.get(k, 0) + light.get(k, 0) for k in ("failed", "unavailable", "expired")}
        if any(lost.values()):
            failed.append(f"the autoscale cycle lost requests: {lost}")
        if any(k not in d for d in decisions for k in ("action", "burn", "queue_depth", "live", "target")):
            failed.append("an autoscaler decision lacks its inputs")
        if drained is None or not conservation["ok"]:
            failed.append(f"the ledger did not balance after the autoscale cycle: {conservation}")
        # The router's herd (fixed in the port only): the added replica must
        # take dispatches once it scrapes healthy. Its share is of the hot
        # load's completed requests (the router counted them by then).
        added_dispatched = per_replica.get(added, {}).get("dispatched", 0)
        added_share = added_dispatched / hot["completed"] if hot.get("completed") else None
        log(f"    the added rank {added} took {added_dispatched} dispatches in the hot load's last "
            f"{FLEET_HOT_AFTER_S:.0f} s, a share {added_share} of its {hot.get('completed')} requests "
            f"at {hot.get('requests_per_sec')} requests/s [{card}]")
        if added_dispatched <= 0:
            failed.append(f"the added rank {added} scraped healthy but got no dispatch: {per_replica}")
        out["c"] = dict(scale_up_s=up, added=added, added_startup_s=added_up, drain_s=down, victim=victim,
                        added_dispatched=added_dispatched, added_share=added_share,
                        hot=hot, light=light, decisions=decisions, ledger=conservation["router_ledger"])
    finally:
        router.stop()
        gang.stop(drain_s=30.0)
    if kill_stray_gangs() != 0:
        failed.append("the fleet left a stray process group")
    took = time.perf_counter() - t_phase
    log(f"  phase 7k took {took:.1f} s")
    if failed:
        fail("; ".join(failed))
    out["seconds"] = took
    return out


# -- phase 7m: the drills -------------------------------------------------------------

# Through the drills' own scenario functions (tools/torch_{fault_drill,
# ingest_bench}.py): (a) ``serving_poison`` on phase 4's translator in this
# process; (b) ``straggler_hedge`` then ``torn_response_retry``, each on a
# 2-replica fleet of ``fleet_replica_rank`` at phase 4's knobs on the card,
# one after the other (the hedge's timing is what it reads); (c) the ingest
# bench's smoke entry with its device stage on the card.


def _launch_delta(probe: dict) -> dict:
    """Each replica's kernel launches between the scenario's two probes."""
    before, after = probe["before"], probe["after"]
    return {r: _delta(after[r]["launches"], before[r]["launches"]) for r in after}


def drills_slice(torch, hop, card: str, translator, prompts) -> dict:
    import shutil

    here = Path(__file__).resolve().parent
    for d in (here / "tools", here / "tests"):
        if str(d) not in sys.path:
            sys.path.insert(0, str(d))
    import torch_fault_drill as fd
    import torch_fleet_bench as fb
    import torch_ingest_bench as ib

    from machine_learning_apache_spark_tpu_torch.launcher import kill_stray_gangs

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the replicas share the card with this process
    root = scratch_dir() / "drills"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    failed, out, seconds = [], {}, {}

    # (a) Decode launch 0 raises in phase 4's engine; only its rows fail.
    t0 = time.perf_counter()
    hop.reset_launches()
    poison = fd.scenario_serving_poison(str(root / "poison"), translator=translator, texts=prompts[:12],
                                        knobs=fd.card_poison_knobs(SERVE))
    launches = dict(hop.LAUNCHES)
    seconds["a"] = time.perf_counter() - t0
    log(f"  (a) serving_poison ({poison['plan']}) on phase 4's translator in this process: "
        + json.dumps({k: poison[k] for k in ("submitted", "served", "poisoned", "quarantined", "loop_restarts",
                                             "recompiles_after_warmup", "kv_slots_leaked")})
        + f", flight dump {poison['flight']['events']} events, launches "
        f"{({k: v for k, v in launches.items() if v})}, {seconds['a']:.1f} s [{card}]")
    if not poison["ok"]:
        failed.append(f"serving_poison's invariant failed: {poison}")
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            failed.append(f"serving_poison's engine never launched {name}")
    out["a"] = dict(poison={k: v for k, v in poison.items() if k != "flight"}, launches=launches)

    # (b) The wire faults, each on its own fleet of phase 4's engine.
    fleet = fb.ReplicaBody("chip_smoke:fleet_replica_rank", (dict(SERVE),), None, prompts,
                           fb.make_key_fn(translator))
    for part, scenario in (("b hedge", fd.scenario_straggler_hedge), ("b torn", fd.scenario_torn_response_retry)):
        t0 = time.perf_counter()
        rec = scenario(str(root / part.replace(" ", "_")), fleet, probe=fb.replica_sections)
        seconds[part] = time.perf_counter() - t0
        deltas = _launch_delta(rec["probe"])
        devices = {r: (s or {}).get("device") for r, s in rec["probe"]["after"].items()}
        log(f"  ({part}) {rec['scenario']} ({rec['plan']}): ok {rec['ok']}, {seconds[part]:.1f} s; replica "
            f"start-up s (spawn to first healthy scrape) "
            + ", ".join(f"rank {r} {t:.2f}" for r, t in sorted(rec["startup_s"].items()))
            + f"; launches in the scenario's traffic {({r: {k: v for k, v in d.items() if v} for r, d in deltas.items()})}; "
            f"ledger {rec['ledger']}; router retries {rec.get('router_retries')}; winners "
            f"{rec.get('winner_ranks')}; client retries {rec.get('client_retries')} [{card}]")
        if not rec["ok"]:
            failed.append(f"{rec['scenario']}'s invariant failed: "
                          + json.dumps({k: v for k, v in rec.items() if k not in ("probe", "per_replica")},
                                       default=str)[:1500])
        if any(d is None or not d.startswith("cuda") for d in devices.values()):
            failed.append(f"{rec['scenario']}: a replica is not on the card: {devices}")
        for r, d in deltas.items():
            for name in SERVING_KERNELS:
                if d.get(name, 0) <= 0:
                    failed.append(f"{rec['scenario']}: replica {r} never launched {name}")
        out[part] = dict(ok=rec["ok"], ledger=rec["ledger"], startup_s=rec["startup_s"], launches=deltas,
                         router_retries=rec.get("router_retries"), hedged=rec.get("hedged"),
                         cancelled=rec.get("cancelled"), failures=rec.get("failures"))
    if kill_stray_gangs() != 0:
        failed.append("the drills' fleets left a stray process group")

    # (c) The ingest bench's smoke entry, the model and the device stage
    # on the card.
    t0 = time.perf_counter()
    art = ib.run(ib.SMOKE_ENTRIES, 2, 600, torch.device("cuda"), smoke=True)
    seconds["c"] = time.perf_counter() - t0
    entry = art["sweep"][0]
    on = entry["stream_on"]
    log(f"  (c) the ingest bench's smoke entry ({json.dumps({k: entry[k] for k in ('records', 'features', 'batch', 'width', 'parser', 'buffer_on', 'epochs')})}): "
        f"gates {art['gates']}; epoch s sync {entry['sync']['epoch_s']}, stream_off "
        f"{entry['stream_off']['epoch_s']}, stream_on {on['epoch_s']} (speed-up on/off "
        f"{entry['speedup_on_vs_off']}, on/sync {entry['speedup_on_vs_sync']}); steady step ms "
        f"{entry['sync']['step_p50_ms']} / {entry['stream_off']['step_p50_ms']} / {on['step_p50_ms']}; "
        f"stream_on device {on['device']}, {on['h2d_copies']} copies; {seconds['c']:.1f} s [{card}]")
    if not art["ok"]:
        failed.append(f"the ingest bench's gates failed: {art['gates']}")
    if not on["device"].startswith("cuda") or on["h2d_copies"] <= 0:
        failed.append(f"stream_on did not copy its batches to the card: {on}")
    out["c"] = dict(gates=art["gates"], sweep=art["sweep"], packing=art["packing"])

    took = time.perf_counter() - t_phase
    log("  phase 7m parts: " + ", ".join(f"({k}) {v:.1f} s" for k, v in seconds.items())
        + f"; phase 7m took {took:.1f} s")
    if failed:
        fail("; ".join(failed))
    out["seconds"] = took
    return out


# -- phase 7l: the seq axis beside the model and expert axes -------------------------

LC_GANG = 4
# label: (mesh axes, method, experts). The reference MT model (1 layer) at
# full width on the published 8004-word vocabularies (the fixture's ids all
# below them; 8004 divides over the model axis), the fixture's global
# batches of 32, targets one pad longer (phase 7h's padding), dropout 0;
# (c) with phase 7i's 8 experts.
LC_MESHES = {
    "a {model: 2, seq: 2} ring": ({"model": 2, "seq": 2}, "ring", 0),
    "b {model: 2, seq: 2} ulysses": ({"model": 2, "seq": 2}, "ulysses", 0),
    "c {expert: 2, seq: 2} ring": ({"expert": 2, "seq": 2}, "ring", EP_EXPERTS),
}
# The kernels' shapes on 7l's path, as a rank launches them: a ring hop on
# {model: 2, seq: 2} (the rank's 4 heads, 100 positions a chunk), Ulysses'
# inner attention on {model: 2, seq: 2} (2 of the rank's 4 heads over all
# 200 positions), and a ring hop of the 2,048-position step on {model: 2,
# seq: 2}. The hop on {expert: 2, seq: 2} (every head, [32, 8, 100, 64])
# is phase 7h's {seq: 2} hop, checked and timed there ("SP hop
# [32,8,100,64]", the same inputs).
LC_SHAPES = {
    "SPxTP ring hop [32,4,100,64]": (32, 4, 100, 64),
    "SPxTP Ulysses inner [32,2,200,64]": (32, 2, 200, 64),
    "SPxTP ring hop [2,4,1024,64]": (2, 4, 1024, 64),
}
LC_LONG_MESH = {"model": 2, "seq": 2}
# train_translator(sequence_parallel=2, model_parallel=2) in the 4-rank
# gang: {data: 1, seq: 2, model: 2}, the global batch of 32 on every rank,
# BLEU (the gathered model) and checkpoints, one epoch.
LC_RECIPE = dict(data_root=str(FIXTURES), batch_size=32, dropout=0.0, log_every=0, compute_bleu=True,
                 sequence_parallel=2, model_parallel=2)


def _lc_model(torch, dev, experts: int):
    """The phase's model (``_pp_model`` at one layer on the published
    vocabularies, with ``experts``), and the recipe's fields."""
    return _pp_model(torch, dev, 1, vocab=MT_PUBLISHED_VOCAB, moe_experts=experts)


def _lc_reference(torch, batches, experts: int) -> dict:
    """One process on the card over the same global batches: the step
    losses of ``SP_WARMUP + SP_TIMED`` Adam steps, the step ms (host
    timed, ``SP_TIMED`` after ``SP_WARMUP``) and the peak above what the
    process held before (a gang rank holds nothing else)."""
    import gc

    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit, make_train_step, to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    n = SP_WARMUP + SP_TIMED
    model, r = _lc_model(torch, dev, experts)
    res = fit(TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate)),
              make_translation_loss(model.cfg.pad_id), batches[:n], epochs=1, log_every=0)
    losses = res.step_losses
    del model, res
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model2, _ = _lc_model(torch, dev, experts)
    state2 = TrainState.create(model=model2, tx=make_optimizer("adam", r.learning_rate))
    step = make_train_step(make_translation_loss(model2.cfg.pad_id))
    local = [to_device(b, dev) for b in batches[:n]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _timed_steps(torch, step, state2, local, SP_WARMUP)
    ms = 1e3 * _timed_steps(torch, step, state2, local[SP_WARMUP:], SP_TIMED)
    out = dict(step_losses=losses, ms=ms, peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20)
    del model2, state2, step, local
    return out


def _lc_steps(torch, axes: dict, method: str, experts: int, batches) -> dict:
    """This rank's Adam steps on ``axes`` under ``sequence_parallel(mesh,
    method=)``: the phase's model sharded over the model and expert axes
    (``shard_state``), ``SP_WARMUP`` steps then ``SP_TIMED`` timed, each
    synchronised at both ends; after every step the seq line's bits are
    compared (``assert_replicas_in_sync``, outside the timed window). The
    step losses, the launches, the peak above what the rank held before,
    and per step the seq line's,
    the model line's and the expert line's collectives (calls, bytes,
    window)."""
    import gc

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.ops.attention import sequence_parallel
    from machine_learning_apache_spark_tpu_torch.parallel import (
        assert_replicas_in_sync,
        make_data_parallel_step,
        make_mesh,
        tensor_parallel,
    )
    from machine_learning_apache_spark_tpu_torch.parallel.data_parallel import bind_batch_line
    from machine_learning_apache_spark_tpu_torch.parallel.sequence import sequence_line
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    mesh = make_mesh(axes)
    d, ways = mesh.index("data"), mesh.axis_size("data")
    model, r = _lc_model(torch, mesh.device, experts)
    state = tensor_parallel.shard_state(
        TrainState.create(model=model, tx=make_optimizer("adam", r.learning_rate)), mesh)
    bind_batch_line(model, mesh)
    step = make_data_parallel_step(make_translation_loss(model.cfg.pad_id), mesh)
    step.replica(model)
    local = [to_device(_data_rows(b, d, ways), mesh.device) for b in batches]
    lines = [sequence_line(mesh), *tensor_parallel.model_lines(model)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hop.reset_launches()
    losses, seconds, every_step_equal = [], 0.0, True
    with sequence_parallel(mesh, method=method):
        for i in range(SP_WARMUP + SP_TIMED):
            if i == SP_WARMUP:
                before = [line.comms.stats() for line in lines]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, loss, _ = step(state, local[i], None)
            torch.cuda.synchronize()
            if i >= SP_WARMUP:
                seconds += time.perf_counter() - t0
            losses.append(float(loss))
            try:
                assert_replicas_in_sync(state, mesh=mesh)
            except AssertionError:
                every_step_equal = False
    out = dict(ms=1e3 * seconds / SP_TIMED, peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,
               step_losses=losses, every_step_same_bits=every_step_equal,
               launches=dict(hop.LAUNCHES), seq=mesh.index("seq"))
    for line, b in zip(lines, before):
        a = line.comms.stats()
        for kind in line.comms.KINDS:
            out[f"{kind}_calls"] = (a[f"{kind}_calls"] - b[f"{kind}_calls"]) / SP_TIMED
            out[f"{kind}_bytes"] = (a[f"{kind}_bytes"] - b[f"{kind}_bytes"]) / SP_TIMED
            out[f"{kind}_ms"] = 1e3 * (a[f"{kind}_window_seconds"] - b[f"{kind}_window_seconds"]) / SP_TIMED
    del state, step, model
    return out


def _lc_long_rank(torch, batch) -> dict:
    """Phase 7l (d) in this rank: one train step of the reference-width
    model at ``SP_LONG["seq"]`` positions (remat) sharded over the model
    axis of ``LC_LONG_MESH`` under ring, with the launches it made; the
    peak above the model."""
    import gc

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.ops.attention import sequence_parallel
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh, tensor_parallel
    from machine_learning_apache_spark_tpu_torch.parallel.data_parallel import bind_batch_line

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(LC_LONG_MESH)
    model, _ = _pp_model(torch, mesh.device, 1, max_len=SP_LONG["seq"], vocab=MT_PUBLISHED_VOCAB,
                         remat=True)
    tensor_parallel.shard_params(model, mesh)
    bind_batch_line(model, mesh)
    hop.reset_launches()
    with sequence_parallel(mesh, method="ring"):
        out = _long_step(torch, model, batch, mesh.device)
    out["launches"] = dict(hop.LAUNCHES)
    out["seq"] = mesh.index("seq")
    out["model_mib"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**20
    del out["grads"], model
    return out


def lc_gang_rank(root: str, batches, long_batch) -> dict:
    """One rank of phase 7l's 4-rank gang: the steps on each mesh (a-c),
    the long-context step (d), then the recipe with ``sequence_parallel=2,
    model_parallel=2`` (e: BLEU, checkpoints). Every rank's numbers, in
    rank order."""
    import os

    import torch
    import torch.distributed as dist

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    rank = dist.get_rank()
    runs = {label: _lc_steps(torch, axes, method, experts, batches)
            for label, (axes, method, experts) in LC_MESHES.items()}
    long = _lc_long_rank(torch, long_batch)
    os.environ["MLSPARK_GANG_RUN"] = os.environ.get("MLSPARK_GANG_RUN", "lc") + "-recipe"
    hop.reset_launches()
    out = train_translator(checkpoint_dir=str(root), _return_state=True, **LC_RECIPE)
    state = out["state"]
    recipe = dict(step_losses=out["fit_result"].step_losses, launches=dict(hop.LAUNCHES),
                  mesh=dict(state.mesh.shape), test_loss=out["test_loss"], bleu=out["bleu"],
                  comms=out["fit_result"].comms, seq=state.mesh.index("seq"),
                  pointer=os.path.exists(os.path.join(root, f"ckpt_r{rank}", "latest")))
    del out, state
    return _gather(dict(rank=rank, runs=runs, long=long, recipe=recipe))


def lc_slice(torch, hop, card: str, dev):
    """Phase 7l: the kernels at the shapes the seq axis beside the model
    and expert axes gives them, the one-process references (the step at
    2,048 positions is phase 7h's), then (a)-(e) in the shared gang
    (``lc_gang_rank``) and their gates."""
    import shutil


    t_phase = time.perf_counter()
    errs = check_hop_kernels(torch, hop, dev, shapes=LC_SHAPES)
    torch.cuda.empty_cache()
    _, _, train_ds = fixture_data()
    batches = [_sp_pad(b) for b in train_batches(train_ds, SP_WARMUP + SP_TIMED)]
    long_batch = sp_long_batch(**SP_LONG)
    long_ref = _sp_long_reference(torch, dev, long_batch, "flash")
    del long_ref["grads"]
    refs = {experts: _lc_reference(torch, batches, experts) for experts in (0, EP_EXPERTS)}
    root = scratch_dir() / "lc"
    shutil.rmtree(root, ignore_errors=True)
    # The rank function runs in the shared gang of phases 7f-7l
    # (``run_shared_gang``): this phase's time there comes back as ``wall``.
    t_pre = time.perf_counter() - t_phase
    ranks, wall = yield "chip_smoke:lc_gang_rank", (str(root), batches, long_batch)
    t_post = time.perf_counter()
    # Every reading is printed before the phase fails on the first gate
    # missed.
    failed: list[str] = []
    log(f"  Session -> Distributor, {LC_GANG} ranks on one card over gloo, the shared gang of phases "
        f"7f-7l: {wall:.2f} s of it ran this phase (meshes a-c, the long step, the recipe); one process {refs[0]['ms']:.3f} ms/step, "
        f"with {EP_EXPERTS} experts {refs[EP_EXPERTS]['ms']:.3f} ms/step (Adam, host-timed, {SP_TIMED} "
        f"after {SP_WARMUP}) [{card}]")
    steps = SP_WARMUP + SP_TIMED
    for label, (axes, method, experts) in LC_MESHES.items():
        ref = refs[experts]
        n = axes["seq"]
        rels = [_max_rel(rk["runs"][label]["step_losses"], ref["step_losses"]) for rk in ranks]
        log(f"    {label}{f' ({experts} experts)' if experts else ''}: {steps} Adam steps' losses "
            f"against one process, largest relative difference per rank "
            + ", ".join(f"{x:.3e}" for x in rels) + f" (gate {SP_RTOL}); the seq line's bits equal "
            f"after every step on every rank {all(rk['runs'][label]['every_step_same_bits'] for rk in ranks)}")
        if max(rels) > SP_RTOL:
            failed.append(f"{label}: step losses {max(rels):.3e} from one process's (gate {SP_RTOL})")
        for rk in ranks:
            run = rk["runs"][label]
            if not run["every_step_same_bits"]:
                failed.append(f"rank {rk['rank']} {label}: a step left the seq line holding different bits")
            per = _sp_launches(method, n, run["seq"]) * steps
            got_l = tuple(run["launches"][k] for k in TENSOR_CORE_KERNELS)
            if got_l != (per,) * 3:
                failed.append(f"rank {rk['rank']} {label}: flash launches {got_l}, not {per} each")
            log(f"      rank {rk['rank']} (seq index {run['seq']}): {run['ms']:.3f} ms/step against one "
                f"process {ref['ms']:.3f} ms, peak {run['peak_mib']:.1f} MiB (one process "
                f"{ref['peak_mib']:.1f}); flash forward / dQ / dK/dV launches {got_l}; per step "
                + ", ".join(f"{k} {v:.3f}" for k, v in run.items() if k.endswith(("_calls", "_bytes", "_ms"))
                            and k != "ms") + f" [{card}]")
    # (d) the long-context step on {model: 2, seq: 2}.
    longs = [rk["long"] for rk in ranks]
    rel_l = max(abs(lg["loss"] - long_ref["loss"]) / abs(long_ref["loss"]) for lg in longs)
    log(f"    d one train step at {SP_LONG['seq']} positions, batch {SP_LONG['batch']}, remat, vocab "
        f"{MT_PUBLISHED_VOCAB} on {LC_LONG_MESH} ring: loss {longs[0]['loss']:.6f} against one process "
        f"{long_ref['loss']:.6f} (phase 7h's reference), largest relative difference over the ranks {rel_l:.3e} (gate "
        f"{SP_RTOL}); step ms per rank " + ", ".join(f"{lg['ms']:.1f}" for lg in longs)
        + f" against {long_ref['ms']:.1f}; peak above the model per rank "
        + ", ".join(f"{lg['peak_mib']:.1f}" for lg in longs)
        + f" MiB (the model's shard {longs[0]['model_mib']:.1f} MiB) against one process "
        f"{long_ref['peak_mib']:.1f} MiB (phase 7h's reference; PR 16's {{seq: 4}}: 536.1 MiB on every "
        f"rank) [{card}]")
    if rel_l > SP_RTOL:
        failed.append(f"the long step on {LC_LONG_MESH} differs from one process's loss ({rel_l:.3e})")
    for rk in ranks:
        per = _sp_launches("ring", LC_LONG_MESH["seq"], rk["long"]["seq"])
        # Two steps (a warm one, then the timed one); remat runs each
        # layer's forward again in the backward.
        want = (4 * per, 2 * per, 2 * per)
        got_l = tuple(rk["long"]["launches"][k] for k in TENSOR_CORE_KERNELS)
        if got_l != want:
            failed.append(f"rank {rk['rank']} long step: flash launches {got_l}, not {want}")
    # (e) the recipe.
    recs = [rk["recipe"] for rk in ranks]
    rec = recs[0]
    losses = rec["step_losses"]
    log(f"    e train_translator(sequence_parallel=2, model_parallel=2) on {rec['mesh']}: {len(losses)} "
        f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, eval loss {rec['test_loss']:.6f}, BLEU (the "
        f"gathered model) {rec['bleu']:.6f}, checkpoints on every rank {all(x['pointer'] for x in recs)}; "
        f"sp_ring / tp_allreduce calls {rec['comms'].get('sp_ring_calls')} / "
        f"{rec['comms'].get('tp_allreduce_calls')}; dQ launches per rank "
        f"{[x['launches']['flash_attention_bwd_dq'] for x in recs]}")
    if (rec["mesh"] != {"data": 1, "seq": 2, "model": 2} or not np.all(np.isfinite(losses))
            or not losses[-1] < losses[0] or not np.isfinite(rec["bleu"])
            or not all(x["pointer"] for x in recs)):
        failed.append("the seq x model recipe did not train, evaluate, decode and checkpoint")
    for x in recs:
        per = _sp_launches("ring", 2, x["seq"]) * len(x["step_losses"])
        if (x["launches"]["flash_attention_bwd_dq"], x["launches"]["flash_attention_bwd_dkv"]) != (per, per):
            failed.append(f"the seq x model recipe: dQ/dK/dV launches {x['launches']}, not {per} each")
    took = t_pre + wall + time.perf_counter() - t_post
    log(f"  phase 7l took {took:.1f} s")
    if failed:
        fail("; ".join(failed))
    return dict(wall=wall, ranks=ranks, errs=errs, seconds=took,
                refs={str(k): v for k, v in refs.items()})


# -- phase 7d: bf16 compute ------------------------------------------------------

BF16 = "bfloat16"
# The card's bf16 run against the CPU port's bf16 run (plain versions) on
# the same weights and batches, 2 Adam steps: both round at the same
# points, in bf16, but sum in other orders (cuBLAS and the kernels against
# the CPU's matmuls), so a logit may land a bf16 ulp apart; each step's
# loss, a float32 mean over ~6,000 tokens, within one bf16 ulp (2^-7).
BF16_LOSS_RTOL = 2.0 ** -7
# Step-0 gradients: each a bf16 backward's products rounded at several
# points on either side, within four bf16 ulps of the largest (2^-5).
BF16_GRAD_RTOL = 2.0 ** -5
BF16_PARITY_STEPS = 2
BF16_KERNELS = tuple(f"{n}_bf16" for n in (
    "flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "ragged_paged_attention"))


def fp32_twin(torch, translator):
    """The same weights in a float32 model, a translator on the same
    device."""
    import dataclasses

    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.models import Transformer

    cfg = dataclasses.replace(translator.model.cfg, dtype=torch.float32)
    model = Transformer(cfg)
    model.load_state_dict(translator.model.state_dict())
    return Translator(model, translator.src_pipe, translator.trg_pipe, device=translator.device)


def bf16_slice(torch, hop, card: str, src_pipe, trg_pipe, train_ds) -> dict:
    """bf16 compute through the port's entry points. The MT recipe at the
    reference width, ``dtype="bfloat16"``, one fixture epoch at 1 and 4
    steps per call: float32 parameters, step losses and parameters bit for
    bit, the bf16 kernels launched 3 x steps each (dQ, dK/dV) and the fp32
    ones never. The card's bf16 step-0 loss against the CPU port's bf16
    run. The trained model saved, loaded and served by the paged engine
    over bf16 pages and over int8 pages, the padded engine and the beam
    engine (the JAX program counts, zero recompiles, replays equal to
    eager calls bit for bit); the bf16 paged engine against the bf16
    one-shot decoder on the card (token agreement >= 0.99); bf16 against
    the float32 model on the same weights (a reading). TinyVGG on the
    CIFAR-10 fixture at bf16, 4 steps per call against 1, bit for bit. The
    MoE options (``ADVANCED``) at bf16, 4 steps per call against 1."""
    import tempfile

    from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
    from machine_learning_apache_spark_tpu_torch.inference import Translator

    t0 = time.perf_counter()
    one = recipe_run(torch, hop, epochs=1, dtype=BF16, compute_bleu=True, _return_translator=True)
    many = recipe_run(torch, hop, epochs=1, dtype=BF16, steps_per_call=OPTION_K)
    steps = one["state"].step
    params_equal, loss_diffs = same_training(torch, many, one)
    programs = many["fit_result"].programs
    dtypes = {p.dtype for p in one["state"].params}
    log(f"  MT recipe at bf16 (reference width, dropout 0.1, Adam 1e-3, batch 32): {steps} steps, "
        f"history {one['history']}, test_loss {one['test_loss']:.6f}, BLEU {one['bleu']:.6f}, "
        f"{one['wall']:.2f} s; parameters {sorted(str(d) for d in dtypes)}")
    log(f"  steps_per_call {OPTION_K} vs 1: parameters equal bit for bit: {params_equal}; step losses "
        f"differing: {loss_diffs}; programs "
        + "; ".join(f"{p['calls']} calls, {p['replays']} replays, launches per replay {p['launches']}"
                    for p in programs))
    for label, run in (("1 step per call", one), (f"{OPTION_K} steps per call", many)):
        lc = run["launches"]
        log(f"  launches, {label}: dQ bf16 {lc['flash_attention_bwd_dq_bf16']}, dK/dV bf16 "
            f"{lc['flash_attention_bwd_dkv_bf16']} (3 x {steps} = {3 * steps}), forward bf16 "
            f"{lc['flash_attention_fwd_bf16']}; fp32 kernels {sum(lc[n] for n in hop.KERNELS)}")
        for name in ("flash_attention_bwd_dq_bf16", "flash_attention_bwd_dkv_bf16"):
            if lc[name] != 3 * steps:
                fail(f"bf16 recipe ({label}): {name} launched {lc[name]} times, not 3 x {steps}")
        if any(lc[n] for n in hop.KERNELS):
            fail(f"bf16 recipe ({label}) launched a float32 kernel: {lc}")
    if dtypes != {torch.float32}:
        fail(f"bf16 compute must keep float32 parameters, got {dtypes}")
    if not params_equal or loss_diffs:
        fail(f"bf16: steps_per_call={OPTION_K} did not train bit for bit like 1")
    if len(programs) != 1 or programs[0]["launches"] != programs[0]["eager_launches"]:
        fail(f"bf16: {len(programs)} programs, or a replay's launches differ from its eager call's")
    if not np.isfinite(one["fit_result"].step_losses).all():
        fail("bf16 recipe: losses not finite")

    parity = parity_run(torch, hop, src_pipe, trg_pipe, train_ds, steps=BF16_PARITY_STEPS,
                        rtol=BF16_LOSS_RTOL, grad_rtol=BF16_GRAD_RTOL, dtype=torch.bfloat16)

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as d:
        one["translator"].save(f"{d}/bf16")
        config = json.loads(Path(f"{d}/bf16/translator.json").read_text())["config"]
        loaded = Translator.load(f"{d}/bf16")
    if config["dtype"] != "bfloat16" or loaded.model.cfg.dtype != torch.bfloat16:
        fail(f"the saved bf16 translator came back as {config['dtype']} / {loaded.model.cfg.dtype}")
    prompts = [s for s, _ in load_multi30k(str(FIXTURES), "valid")][:N_REQUESTS]
    runs = {kv: serve_once(torch, hop, loaded, prompts, f"bf16 paged {kv}", kv_dtype=kv, **SERVE)
            for kv in ("float32", "int8")}
    runs["padded"] = serve_once(torch, hop, loaded, prompts, "bf16 padded", **SERVE_PADDED)
    runs["beam"] = serve_once(torch, hop, loaded, prompts[:N_BEAM], "bf16 beam", **SERVE_BEAM)
    for label, run in runs.items():
        log(f"  bf16 {label:7s} engine ({run['kv_mode']}): {len(run['outs'])} completed in "
            f"{run['wall']:.3f} s, launches {run['launches']}, {run['programs']} programs at warmup, "
            f"recompiles_after_warmup 0")
    replay_vs_eager(torch, hop, loaded, prompts, prefix="bf16 ")
    mnt = SERVE["max_new_tokens"]
    greedy, greedy_launches = one_shot(torch, hop, "the bf16 one-shot Translator",
                                       lambda: loaded(prompts, max_new_tokens=mnt), torch.bfloat16)
    beam_kw = dict(method="beam", beam_size=SERVE_BEAM["beam_size"], max_new_tokens=mnt)
    beam = loaded(prompts[:N_BEAM], **beam_kw)
    twin = fp32_twin(torch, loaded)
    fp32_greedy = twin(prompts, max_new_tokens=mnt)
    share, notes = agreement(runs["float32"]["outs"], greedy)
    log(f"  token agreement, bf16 paged engine (bf16 pages) vs the bf16 one-shot greedy decoder on the "
        f"card: {share:.6f} (gate >= {AGREEMENT_MIN})")
    for n in notes:
        log(f"    mismatch: {n}")
    if share < AGREEMENT_MIN:
        fail(f"token agreement {share:.4f} < {AGREEMENT_MIN} (bf16 paged engine vs one-shot)")
    readings = {
        "bf16 int8 pages vs bf16 pages": (runs["int8"]["outs"], runs["float32"]["outs"]),
        "bf16 padded vs bf16 paged": (runs["padded"]["outs"], runs["float32"]["outs"]),
        "bf16 beam engine vs bf16 one-shot beam": (runs["beam"]["outs"], beam),
        "bf16 one-shot greedy vs the float32 model's on the same weights": (greedy, fp32_greedy),
    }
    for label, (got, ref) in readings.items():
        log(f"  token agreement (a reading), {label}: {agreement(got, ref)[0]:.6f}")

    cnn = {k: zoo_run(torch, hop, "cnn cifar10", epochs=1, dtype=BF16, steps_per_call=k) for k in (1, ZOO_K)}
    zoo_multistep(torch, hop, "cnn cifar10 at bf16", cnn)
    zero = {n: 0 for n in hop.LAUNCHES}
    if any(r["launches"] != zero for r in cnn.values()):
        fail("TinyVGG at bf16 launched attention kernels")
    log(f"  TinyVGG (CIFAR-10 fixture, hidden 10) at bf16: final_loss {cnn[1]['final_loss']:.6f}, "
        f"test_loss {cnn[1]['test_loss']:.6f}, accuracy {cnn[1]['accuracy']:.3f} %")
    moe = k_steps_like_one(torch, hop, "MoE (advanced_translator options) at bf16", epochs=1,
                           dtype=BF16, **ADVANCED)
    for run in moe.values():
        if any(run["launches"][n] for n in hop.KERNELS):
            fail(f"MoE at bf16 launched a float32 kernel: {run['launches']}")
    log(f"  phase 7d took {time.perf_counter() - t0:.1f} s")
    return dict(
        one=one, many=many, parity=parity, runs=runs, cnn=cnn, moe=moe,
        one_shot_launches=greedy_launches,
        paths={
            "bf16 training, 1 and 4 steps per call": [one["launches"], many["launches"]],
            "bf16 paged serving (bf16 and int8 pages)": [runs["float32"]["launches"], runs["int8"]["launches"]],
            "bf16 padded serving": [runs["padded"]["launches"]],
            "bf16 beam serving": [runs["beam"]["launches"]],
            "bf16 one-shot greedy": [greedy_launches],
            "bf16 MoE training, 1 and 4 steps per call": [moe["one"]["launches"], moe["many"]["launches"]],
        },
    )


def log_bf16_steps(mt32: dict, mt16: dict, cnn32: dict, cnn16: dict, card: str) -> None:
    """The MT step (1 and 4 steps per call) and the TinyVGG step at fp32
    beside bf16, measured in this process."""
    for label, a, b in (("MT", mt32, mt16), ("TinyVGG", cnn32, cnn16)):
        for k in sorted(set(a) & set(b)):
            x, y = a[k], b[k]
            idle = {n: ("not measured" if t.get("idle") is None else f"{t['idle']:.4f}") for n, t in (("fp32", x), ("bf16", y))}
            rate = "tokens_per_s" if "tokens_per_s" in x else "samples_per_s"
            extra = (f", {rate.replace('_per_s', '')}/s fp32 {x[rate]:.1f}, bf16 {y[rate]:.1f}"
                     if rate in x and rate in y else "")
            peak = "peak" if "peak" in x else "peak_above"
            log(f"  {label} step at {k} step(s) per call: fp32 {x['ms']:.4f} ms, bf16 {y['ms']:.4f} ms "
                f"({x['ms'] / y['ms']:.3f}x){extra}; idle share fp32 {idle['fp32']}, bf16 {idle['bf16']}; "
                f"{peak} fp32 {x[peak] / 2**20:.1f} MiB, bf16 {y[peak] / 2**20:.1f} MiB [{card}]")


# -- main -----------------------------------------------------------------------


def cache_bytecode() -> Path:
    """Keep this process's and every worker's compiled Python under the
    checkout's ``build/pycache``. Where the environment turns bytecode
    writing off (``PYTHONDONTWRITEBYTECODE``) and the installed packages
    ship none, each of the smoke's ~80 gang and replica processes would
    compile torch again on import: on the card's machine ~12 s an import
    against ~5.4 s from the cache. The workers inherit the environment."""
    prefix = Path(__file__).resolve().parent / "build" / "pycache"
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(prefix)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(prefix)
    return prefix


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    no_bytecode = os.environ.get("PYTHONDONTWRITEBYTECODE")
    pycache = cache_bytecode()
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.ops.cuda_build import LIBRARY
    from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    log("== phase 1: device")
    dev = resolve_device(None)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; device {kind}; count {count}")
    log(f"  nvidia-smi: {card}")
    log(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")
    log(f"  compiled Python cached for this process and its workers in {pycache} "
        f"(PYTHONDONTWRITEBYTECODE was {no_bytecode!r})")

    log("== phase 2: build")
    t0 = time.perf_counter()
    built = LIBRARY.kernels()
    log(f"  built {len(built)} kernels from {len({kb.source for kb in built.values()})} "
        f"sources in {time.perf_counter() - t0:.2f} s (wall, parallel nvcc)")
    reported = set()
    for name, kb in built.items():
        log(f"  {name}: csrc/{kb.source}.cu, nvcc {kb.seconds:.2f} s -> {kb.library}")
        if kb.source in reported:
            continue
        reported.add(kb.source)
        for line in kb.compiler_output.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line or "smem" in line:
                log(f"    {line.strip()}")
    check_tensor_core_sass(built)

    log("== phase 3: kernels vs plain (on the card)")
    errs = check_kernels(torch, hop, dev)
    src_pipe_t, trg_pipe_t, train_ds = fixture_data()
    src0, trg0 = train_batches(train_ds, 1)[0]

    def make_sites(dtype=None):
        return training_sites(torch, np.random.default_rng(SEED + 4), dev, src0, trg0[:, :-1], dtype=dtype)

    # Made anew for the timings of phase 6: held here they would sit in
    # device memory through the serving and training peaks.
    train_errs = check_training_kernels(
        torch, hop,
        make_sites() | bucket_sites(torch, np.random.default_rng(SEED + 5), dev, src0, trg0[:, :-1]),
        dev,
    )
    bleu_valid = bleu_val_valid()
    decode_err = check_decode_forward(torch, hop, decode_sites(torch, dev, bleu_valid), dev)
    # The bf16 instantiations at the same sites and edge cases.
    bf16 = torch.bfloat16
    errs |= check_kernels(torch, hop, dev, dtype=bf16)
    train_errs |= check_training_kernels(
        torch, hop,
        make_sites(bf16) | bucket_sites(torch, np.random.default_rng(SEED + 5), dev, src0, trg0[:, :-1], dtype=bf16),
        dev, dtype=bf16,
    )
    decode_err_bf16 = check_decode_forward(torch, hop, decode_sites(torch, dev, bleu_valid, dtype=bf16), dev)
    torch.cuda.empty_cache()

    log("== phase 4: serving slice at full width")
    src_words, src_pipe, trg_pipe = serving_pipes()
    prompts = make_prompts(src_words)
    prompt_lens = [len(src_pipe.ragged([p])[0]) for p in prompts]
    log(f"  vocab {len(src_pipe.vocab.itos)} / {len(trg_pipe.vocab.itos)}; "
        f"{len(prompts)} prompts ({len(set(prompts))} distinct), "
        f"{min(prompt_lens)}-{max(prompt_lens)} ids; model {MODEL}")
    params = model_params(src_pipe, trg_pipe)
    translator = build_translator(None, params, src_pipe, trg_pipe)
    runs = {kv: serve_once(torch, hop, translator, prompts, f"paged {kv}", kv_dtype=kv, **SERVE)
            for kv in ("float32", "int8")}
    runs["padded"] = serve_once(torch, hop, translator, prompts, "padded fp32", **SERVE_PADDED)
    beam_prompts = prompts[:N_BEAM]
    runs["beam"] = serve_once(torch, hop, translator, beam_prompts, "beam", **SERVE_BEAM)
    for label, run in runs.items():
        pools = (f"pools {{active_rows: {run['stats']['active_rows']}, self_pages_in_use: "
                 f"{run['stats']['self_pages_in_use']}}}, prefix-cache hits {run['hits']}"
                 if run["kv_mode"] == "paged" else "KV slots all free")
        log(f"  {label:7s} engine ({run['kv_mode']}): {len(run['outs'])} completed in "
            f"{run['wall']:.3f} s, launches {run['launches']}, {pools}")
        log(f"          {run['programs']} programs captured at warmup, recompiles_after_warmup 0, "
            f"launches == eager execution of the replays {run['replays']}")
    replay_vs_eager(torch, hop, translator, prompts)

    mnt = SERVE["max_new_tokens"]
    one_shot_launches = {}
    cached, one_shot_launches["Translator greedy (cached)"] = one_shot(
        torch, hop, "the one-shot Translator", lambda: translator(prompts, max_new_tokens=mnt))
    uncached, one_shot_launches["greedy_translate (uncached)"] = one_shot(
        torch, hop, "greedy_translate", lambda: uncached_greedy(torch, translator, prompts))
    samples = []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        out, one_shot_launches["Translator sample"] = one_shot(
            torch, hop, "the sampling Translator", lambda: translator(
                prompts, method="sample", rng=gen, top_p=0.9, max_new_tokens=mnt))
        samples.append(out)
    sample_t0 = translator(prompts, method="sample", rng=torch.Generator(device=dev).manual_seed(SEED),
                           temperature=0.0, max_new_tokens=mnt)
    log(f"  one-shot decoders on the card, launches: {one_shot_launches}")
    if samples[0] != samples[1]:
        fail("two sampling runs from one CUDA generator seed gave different outputs")
    if sample_t0 != cached:
        fail("sampling at temperature 0 differs from greedy decoding")
    log(f"  sampling (top_p 0.9): two runs from one CUDA generator seed identical; "
        f"temperature 0 identical to greedy; agreement with greedy {agreement(samples[0], cached)[0]:.6f}")

    t0 = time.perf_counter()
    oracle_t = build_translator("cpu", params, src_pipe, trg_pipe)
    oracle = oracle_t(prompts, max_new_tokens=mnt)
    beam_oracle = oracle_t(beam_prompts, method="beam", beam_size=SERVE_BEAM["beam_size"],
                           max_new_tokens=mnt)
    log(f"  one-shot greedy and beam on the CPU (plain versions): {time.perf_counter() - t0:.1f} s")
    checks = [
        ("paged fp32 engine vs one-shot greedy on the CPU", runs["float32"]["outs"], oracle),
        ("paged int8 engine vs paged fp32 engine", runs["int8"]["outs"], runs["float32"]["outs"]),
        ("padded fp32 engine vs paged fp32 engine", runs["padded"]["outs"], runs["float32"]["outs"]),
        ("one-shot Translator (cached) vs uncached greedy_translate, both on the card", cached, uncached),
        ("beam engine (beam 4) vs beam_translate on the CPU", runs["beam"]["outs"], beam_oracle),
    ]
    for label, got, want in checks:
        share, notes = agreement(got, want)
        log(f"  token agreement, {label}: {share:.6f} (gate >= {AGREEMENT_MIN})")
        for n in notes:
            log(f"    mismatch: {n}")
        if share < AGREEMENT_MIN:
            fail(f"token agreement {share:.4f} < {AGREEMENT_MIN} ({label})")
    n_tokens = sum(len(o.split()) for o in runs["float32"]["outs"])
    if n_tokens == 0:
        fail("the engine generated no tokens")
    one_shot_graphs = translator_programs(torch, hop, translator, prompts, card)

    log("== phase 5: training slice at full width")
    trained = train_slice(torch, hop)
    eval_parity = eval_decode_parity(torch, trained)
    parity = parity_run(torch, hop, src_pipe_t, trg_pipe_t, train_ds)
    multi = multistep_slice(torch, hop)
    resumed = resume_slice(torch, hop)

    log("== phase 6: the model zoo at the reference widths (MLP, TinyVGG, LSTM, MLlib L-BFGS)")
    zoo = zoo_slice(torch, hop, card)

    log("== phase 7: the translation recipe's options (MoE, remat, length buckets, packing, "
        "the profiler window, native text)")
    options = options_slice(torch, hop, card)

    log("== phase 7b: the distributed path (Session -> Distributor gang over torch.distributed, "
        "data-parallel fit(mesh=), the gang's telemetry, a failing gang)")
    t0 = time.perf_counter()
    gangs = gang_slice(torch, hop, card)
    log(f"  phase 7b took {time.perf_counter() - t0:.1f} s")

    log("== phase 7c: the gang that survives a crash and reports its health (gang checkpoints "
        "and a Distributor retry, group agreement, MLlib fit(mesh=), /healthz, /statusz, /tracez)")
    t0 = time.perf_counter()
    recovery = recovery_slice(torch, hop, translator, prompts, card)
    log(f"  phase 7c took {time.perf_counter() - t0:.1f} s")

    log("== phase 7d: bf16 compute (the MT recipe, its engines, TinyVGG and MoE at dtype=\"bfloat16\")")
    bf = bf16_slice(torch, hop, card, src_pipe_t, trg_pipe_t, train_ds)

    log("== phase 7e: ZeRO-1 on the data axis (Distributor(dp_mode='zero1'): reduce-scatter, "
        "the shard's update, all-gather; bf16 and int8 wires; its checkpoints) and the gang's "
        "K steps per call")
    t0 = time.perf_counter()
    zero1 = zero1_slice(torch, hop, card)
    log(f"  phase 7e took {time.perf_counter() - t0:.1f} s")

    tp, pp, sp, ep, lc = run_shared_gang([
        ("== phase 7f: tensor parallelism on the model axis ({data: 4}, {data: 1, model: 4}, "
         "{data: 2, model: 2}, its ZeRO-1, checkpoints, train_translator(model_parallel=2))",
         tp_slice(torch, hop, card, dev)),
        ("== phase 7g: pipeline parallelism on the pipeline axis ({pipeline: 4} at M = 4 and 8, "
         "{data: 2, pipeline: 2}, K = 4, bf16, train_translator(pipeline_parallel=2) with checkpoints "
         "and remat)", pp_slice(torch, hop, card, dev)),
        ("== phase 7h: the sequence axis ({seq: 4} ring and Ulysses, {data: 2, seq: 2} ring, "
         "train_translator(sequence_parallel=2) under ring and Ulysses, one step at "
         f"{SP_LONG['seq']} positions)", sp_slice(torch, hop, card, dev)),
        ("== phase 7i: the MoE expert axis ({expert: 4}, {data: 2, expert: 2}, {expert: 2, model: 2} "
         f"at {EP_EXPERTS} experts, train_translator(moe_experts={EP_EXPERTS}, expert_parallel=2) with "
         "checkpoints, a resume and BLEU)", ep_slice(torch, hop, card)),
        ("== phase 7l: the seq axis beside the model and expert axes ({model: 2, seq: 2} ring and "
         f"Ulysses, {{expert: 2, seq: 2}} ring at {EP_EXPERTS} experts, one step at {SP_LONG['seq']} "
         "positions on {model: 2, seq: 2}, train_translator(sequence_parallel=2, model_parallel=2) "
         "with checkpoints and BLEU)", lc_slice(torch, hop, card, dev)),
    ])
    for name, e in [*tp["errs"].items(), *pp["errs"].items(), *pp["bf16_errs"].items(),
                    *sp["errs"].items(), *sp["bf16_errs"].items(), *lc["errs"].items()]:
        if name in train_errs:
            train_errs[name]["max_abs_err"] = max(train_errs[name]["max_abs_err"], e["max_abs_err"])
            train_errs[name]["max_rel_err"] = max(train_errs[name]["max_rel_err"], e["max_rel_err"])

    log("== phase 7j: the streaming ingest pipeline and elastic resume ((a) fit(data=StreamingPipeline) "
        "on the card at K = 1 and 4, packing, a resumed stream; (b) a 4-rank ZeRO-1 gang that loses "
        "rank 3 and shrinks to 3 onto resharded checkpoints)")
    ingest = ingest_slice(torch, hop, card)
    elastic = elastic_slice(torch, hop, card)

    log(f"== phase 7k: the serving fleet ({FLEET_REPLICAS} replicas of phase 4's paged engine on the card "
        "behind FleetRouter(policy='affinity'): routed prompts, rank 1 killed and restarted, one "
        "autoscale cycle 2 -> 3 -> 2)")
    fleet = fleet_slice(torch, hop, card, translator, prompts, runs["float32"])

    log("== phase 7m: the drills (tools/torch_{fault_drill,ingest_bench}.py on the card: serving_poison in "
        "process, straggler_hedge and torn_response_retry each on a 2-replica fleet, the ingest bench's "
        "smoke entry)")
    drills = drills_slice(torch, hop, card, translator, prompts)

    log("== phase 8: times")
    # Each part's wall: where phase 8's time goes.
    p8, t_p8 = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        p8[name] = time.perf_counter() - t_p8[0]
        t_p8[0] = time.perf_counter()

    for label, run in runs.items():
        log(f"  {label:7s} engine ({run['kv_mode']}): {len(run['outs']) / run['wall']:.2f} requests/s, "
            f"{run['tokens'] / run['wall']:.1f} generated tokens/s "
            f"({len(run['outs'])} requests, {run['tokens']} tokens), peak max_memory_allocated "
            f"{run['peak'] / 2**20:.1f} MiB [{card}]")
    # Where a serving run's time goes: each engine once more, its programs
    # captured at warmup, with the profiler recording device activity.
    # Busy time and wall time come from one window, submit to drain, timed
    # inside the profiler so that its start and stop stay outside. Then
    # the paged fp32 engine's decode thread, split by host activity.
    windows = (("paged fp32", dict(kv_dtype="float32", **SERVE), prompts),
               ("paged int8", dict(kv_dtype="int8", **SERVE), prompts),
               ("padded", SERVE_PADDED, prompts), ("beam", SERVE_BEAM, beam_prompts))
    for label, kw, window_prompts in windows:
        eng = translator.serve(**kw)
        try:
            prof = profiled_window(torch, eng, window_prompts)
        finally:
            eng.stop()
        split = host_split(torch, translator, kw, window_prompts) if eng.runtime is not None else None
        if prof["busy"] is None:
            log(f"  profiled {label} serving run: device time not measured (the profiler saw no device work)")
        else:
            log(f"  profiled {label} serving run (CUDA graphs): {len(window_prompts) / prof['wall']:.2f} "
                f"requests/s, submit-to-drain wall {prof['wall']:.4f} s, device busy "
                f"{prof['busy']:.4f} s, device idle share {prof['idle_share']:.4f} (one window; "
                f"profiler start and stop outside it, {prof['outer'] - prof['wall']:.4f} s) [{card}]")
        if label == "paged fp32":
            for name, calls, us in prof["rows"][:10]:
                log(f"    {us / 1e3:10.3f} ms  {calls:6d} calls  {name[:90]}")
        if split is not None:
            log(f"  host time of the {label} decode thread per launch ({split['launches']} launches, "
                f"window wall {split['wall']:.4f} s), ms: "
                + ", ".join(f"{k} {v:.4f}" for k, v in split["per_launch_ms"].items() if v is not None)
                + f" [{card}]")
    # The eval/BLEU decode's forward launches of the recipe run: all of its
    # forward launches but the training steps' (one per site and layer).
    eval_launches = trained["launches"]["flash_attention_fwd"] - 3 * trained["steps"] * trained["layers"]
    eval_decode = profile_eval_decode(torch, hop, trained["state"])
    dm = eval_decode["device_ms"]
    log(f"  eval/BLEU decode, profiled once more on the trained state: flash_attention_fwd "
        f"{eval_decode['launches']} launches (recipe run {eval_launches}; profiler "
        f"{eval_decode['profiled_launches']}), device "
        f"{'not measured' if dm is None else f'{dm:.4f} ms'}, bound {eval_decode['bound_ms']:.4f} ms "
        f"(summed over its launches); BLEU {eval_decode['bleu']:.6f} (recipe run "
        f"{trained['out']['bleu']:.6f}) [{card}]")
    if eval_decode["launches"] != eval_launches or eval_decode["recorded"] != eval_launches:
        fail(f"the profiled eval/BLEU decode launched the forward {eval_decode['launches']} times "
             f"({eval_decode['recorded']} recorded), the recipe run's {eval_launches}")
    lap("serving windows and the eval decode")
    gang_times = time_gang(torch, card, [r["timing"] for r in zero1["ranks"]])
    lap("the 2-rank gang's timings (timed in phase 7e's gang) against one process")
    times = time_kernels(torch, hop, dev, prompt_lens)
    times |= time_kernels(torch, hop, dev, prompt_lens, dtype=bf16)
    lap("serving sites")
    train_times = time_train_dispatch(torch, trained["state"], train_ds, card)
    train_times_bf16 = time_train_dispatch(torch, bf["one"]["state"], train_ds, card, label="bf16 ")
    cnn_times_bf16 = time_zoo_dispatch(torch, "cnn cifar10", bf["cnn"][1]["state"], card, label=" at bf16")
    bleu_times = time_bleu_decode(torch, hop, trained["state"], card)
    lap("step dispatch and the BLEU decode")
    timed_sites = make_sites()
    timed_sites |= one_sequence_sites(torch, timed_sites["encoder self"])
    timed_sites |= pp_sites(torch, dev, src0, trg0[:, :-1])
    timed_sites |= sp_hop_sites(torch, dev)
    timed_sites |= sp_hop_sites(torch, dev, shapes=LC_SHAPES)
    site_times = time_training_kernels(torch, hop, timed_sites)
    site_times |= time_training_kernels(torch, hop, make_sites(bf16))
    lap("training sites")
    decode_times = time_decode_forward(torch, hop, decode_sites(torch, dev, bleu_valid))
    decode_times_bf16 = time_decode_forward(torch, hop, decode_sites(torch, dev, bleu_valid, dtype=bf16))
    lap("decode sites")
    log(f"  phase 8 parts (profiler sessions of {PROFILE_CALLS} calls at the serving and decode sites): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in p8.items()))
    for name, by_site in [*times.items(), *site_times.items(), ("flash_attention_fwd", decode_times),
                          ("flash_attention_fwd_bf16", decode_times_bf16)]:
        for site, t in by_site.items():
            log_site_times(name, site, t, card)
    log_bf16_steps(train_times, train_times_bf16, zoo["times"]["cnn cifar10"], cnn_times_bf16, card)

    # Launches per path, each read from its own run (counts set to 0 just
    # before it): the paged engines (fp32 and int8), the padded and beam
    # engines, the one-shot decoders, the training recipe.
    paths = {
        "paged serving": [runs["float32"]["launches"], runs["int8"]["launches"]],
        "padded serving": [runs["padded"]["launches"]],
        "beam serving": [runs["beam"]["launches"]],
        "one-shot decoders": list(one_shot_launches.values()),
        "one-shot programs (replays)": [t["launches"] for t in one_shot_graphs.values()],
        "training": [trained["launches"]],
        f"training, {MULTI_K} steps per call": [multi["runs"][k]["launches"] for k in MULTI_K],
        f"training, {RESUME_K} steps per call, resumed": [resumed["whole"]["launches"]],
        **{f"zoo: {name}": [launches] for name, launches in zoo["paths"].items()},
        "training, MoE (advanced_translator options, BLEU, checkpoints)": [options["moe"]["adv"]["launches"]],
        f"training, MoE, 1 and {OPTION_K} steps per call": [
            options["moe"]["k"][r]["launches"] for r in ("one", "many")],
        "MoE paged serving (saved and loaded)": [options["moe"]["served"]["launches"]],
        "MoE one-shot greedy and beam": options["moe"]["one_shot_launches"],
        f"training, remat, 1 and {OPTION_K} steps per call": [
            r["remat"]["launches"] for r in options["remat"]["runs"].values()],
        "training, bucket_by_length": [options["buckets"]["run"]["launches"]],
        f"training, pack_sequences, 1 and {OPTION_K} steps per call": [
            options["packing"]["run"]["launches"],
            *(options["packing"]["k"][r]["launches"] for r in ("one", "many"))],
        f"profiled fit, 1 and {OPTION_K} steps per call": [
            p["launches"] for p in options["profiler"].values()],
        # Each rank counts in its own process; the gang's path sums them.
        f"gang: MT data parallel, {GANG} ranks on one card": [
            r["launches"] for r in gangs["mt"]["ranks"]],
        "gang: MT fault drill, the retried attempt": recovery["drill"]["launches"],
        f"gang: MT ZeRO-1, {GANG} ranks on one card": [
            r["runs"]["zero1"]["launches"] for r in zero1["ranks"]],
        f"gang: MT TP, {TP_GANG} ranks on one card ({{data: 1, model: 4}}, {{data: 2, model: 2}}, "
        "train_translator(model_parallel=2))": [
            r["runs"][k]["launches"] for r in tp["ranks"]
            for k in ("b {data: 1, model: 4}", "c {data: 2, model: 2}", "f recipe")],
        f"gang: MT TP ZeRO-1, {TP_GANG} ranks on one card ({{data: 2, model: 2}})": [
            r["runs"]["d ZeRO-1 fp32"]["launches"] for r in tp["ranks"]],
        f"gang: MT PP, {PP_GANG} ranks on one card ({{pipeline: 4}} at M = 4 and 8, "
        "{data: 2, pipeline: 2}, train_translator(pipeline_parallel=2))": [
            r["runs"][k]["launches"] for r in pp["ranks"] for k in PP_MESHES]
        + [r["recipe"]["whole"]["launches"] for r in pp["ranks"]],
        f"gang: MT PP bf16, {PP_GANG} ranks on one card ({{data: 2, pipeline: 2}})": [
            r["runs"]["d bf16"]["launches"] for r in pp["ranks"]],
        f"gang: MT SP, {SP_GANG} ranks on one card ({{seq: 4}} ring and Ulysses, {{data: 2, seq: 2}} "
        "ring, train_translator(sequence_parallel=2) ring and Ulysses, the long-context step)": [
            r["runs"][k]["launches"] for r in sp["ranks"] for k in SP_MESHES]
        + [r["recipe"][m]["launches"] for r in sp["ranks"] for m in ("ring", "ulysses")]
        + [r["long"]["launches"] for r in sp["ranks"]],
        f"gang: MT EP, {EP_GANG} ranks on one card ({{expert: 4}}, {{data: 2, expert: 2}}, "
        f"{{expert: 2, model: 2}} at {EP_EXPERTS} experts, SGD and Adam; "
        f"train_translator(moe_experts={EP_EXPERTS}, expert_parallel=2) and its resume)": [
            r["runs"][k][opt]["launches"] for r in ep["ranks"] for k in EP_MESHES for opt in ("sgd", "adam")]
        + [r["recipe"][n]["launches"] for r in ep["ranks"] for n in ("first", "second")],
        "ingest: fit(data=StreamingPipeline) and over its host batches, K = 1 and 4, resumed": list(
            ingest["paths"].values()),
        f"gang: MT SP beside TP and EP, {LC_GANG} ranks on one card ({{model: 2, seq: 2}} ring and "
        f"Ulysses, {{expert: 2, seq: 2}} ring, the long-context step, "
        "train_translator(sequence_parallel=2, model_parallel=2))": [
            r["runs"][k]["launches"] for r in lc["ranks"] for k in LC_MESHES]
        + [r["long"]["launches"] for r in lc["ranks"]] + [r["recipe"]["launches"] for r in lc["ranks"]],
        f"gang: elastic ZeRO-1, {ELASTIC_GANG} ranks on one card, unfaulted and shrunk to "
        f"{ELASTIC_GANG - 1}": [r["launches"] for rs in elastic["ranks"].values() for r in rs],
        f"fleet: {FLEET_REPLICAS} paged replicas behind the router, phase 7k (a)": list(
            fleet["a"]["launches"].values()),
        "drills: serving_poison on phase 4's engine in process, phase 7m (a)": [drills["a"]["launches"]],
        "drills: straggler_hedge and torn_response_retry, 2 paged replicas each, phase 7m (b)": [
            d for part in ("b hedge", "b torn") for d in drills[part]["launches"].values()],
        "live plane: paged fp32 engine": [recovery["live"]["paged fp32"]["launches"]],
        "live plane: padded engine": [recovery["live"]["padded"]["launches"]],
        **bf["paths"],
    }
    path_launches = {p: {n: sum(x[n] for x in xs) for n in hop.LAUNCHES} for p, xs in paths.items()}
    kernels = []
    for name in ("flash_attention_fwd", "ragged_paged_attention",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv", *BF16_KERNELS):
        # Serving-shape numbers for the serving kernels; the encoder
        # self-attention site for the backward kernels; every training
        # site under "training_sites".
        base = name.removesuffix("_bf16")
        site = MAIN_SITE[base] if name == base else MAIN_SITE[base].replace("fp32", "bf16")
        main_t = (times.get(name) or site_times[name])[site]
        err = errs.get(name, 0.0)
        if name in train_errs:
            err = max(err, train_errs[name]["max_abs_err"])
        entry = {
            "name": name,
            "route": "cuda",
            "source": SOURCES[base],
            "replaces": REPLACES[base],
            "launches": sum(x[name] for x in path_launches.values()),
            "launches_by_path": {p: x[name] for p, x in path_launches.items()},
            "max_abs_err": err,
            "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"],
            "device_ms": main_t["device_ms"],
        }
        if name in train_errs:
            entry["max_rel_err"] = train_errs[name]["max_rel_err"]
        if base == "flash_attention_fwd":  # the decode sites are held relative
            entry["max_rel_err"] = max(entry["max_rel_err"], decode_err if name == base else decode_err_bf16)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "warps", "warps_sweep")
        for label, by_site in (("serving_sites", times.get(name)), ("training_sites", site_times.get(name))):
            if by_site:
                entry[label] = {site: {k: t[k] for k in keys if k in t} for site, t in by_site.items()}
        if name == "flash_attention_fwd_bf16":
            entry["decode_sites"] = {site: {k: t[k] for k in keys if k in t}
                                     for site, t in decode_times_bf16.items()}
        if name == "flash_attention_fwd":
            entry["eval_bleu_decode"] = dict(
                decoder="greedy_translate_cached", launches=eval_launches,
                device_ms=eval_decode["device_ms"], bound_ms=eval_decode["bound_ms"],
                card_vs_cpu_agreement=eval_parity["agreement"])
            entry["decode_sites"] = {site: {k: t[k] for k in keys if k in t}
                                     for site, t in decode_times.items()}
        kernels.append(entry)
    log(f"  training, steps per call -> numbers: {json.dumps(train_times)}")
    log(f"  BLEU decode per epoch: {json.dumps(bleu_times)}")
    log(f"  one-shot Translator programs: {json.dumps(one_shot_graphs)}")
    log(f"  zoo: {json.dumps({k: zoo[k] for k in ('parity', 'resumed', 'mllib', 'times', 'recurrence', 'determinism')}, default=str)} [{card}]")
    log("  recipe options: " + json.dumps(dict(
        moe_parity=options["moe"]["parity"], remat_peak_bytes=options["remat"]["peak"],
        remat_ms=options["remat"]["ms"], bucket_step_ms=options["buckets"]["step_ms"],
        padding_efficiency=options["buckets"]["padding_efficiency"],
        packed_steps=options["packing"]["steps"],
        profiler={k: {f: v[f] for f in ("bytes", "kernel_events", "flash", "graph_launches")}
                  for k, v in options["profiler"].items()},
        native_text=options["native_text"]), default=str) + f" [{card}]")
    log("  gang: " + json.dumps(dict(
        cnn=gangs["cnn"], mt={k: v for k, v in gangs["mt"].items() if k not in ("skew", "comms")},
        launches_by_rank={r["rank"]: r["launches"] for r in gangs["mt"]["ranks"]},
        times=gang_times), default=str) + f" [{card}]")
    log("  recovery: " + json.dumps(recovery, default=str) + f" [{card}]")
    log("  zero1: " + json.dumps(dict(wall=zero1["wall"], ranks=[dict(
        rank=r["rank"], times=r["times"], gates=r["gates"],
        runs={k: {f: v[f] for f in ("steps", "opt_bytes", "peak", "comms", "launches")}
              for k, v in r["runs"].items()}) for r in zero1["ranks"]]), default=str)
        + f" [{card}]")
    log("  tp: " + json.dumps(dict(
        wall=tp["wall"], ref=tp["ref"], errs=tp["errs"],
        served={k: v for k, v in tp["served"].items() if k != "launches"},
        ranks=[dict(rank=r["rank"], times=r["times"],
                    runs={k: {f: v.get(f) for f in ("steps", "opt_bytes", "peak", "comms", "launches")}
                          for k, v in r["runs"].items()}) for r in tp["ranks"]]), default=str)
        + f" [{card}]")
    log("  pp: " + json.dumps(dict(
        wall=pp["wall"], refs=pp["refs"], errs=pp["errs"], bf16_errs=pp["bf16_errs"],
        ranks=[dict(rank=r["rank"], times=r["times"],
                    runs={k: {f: v.get(f) for f in ("steps", "peak", "comms", "launches")}
                          for k, v in r["runs"].items()}) for r in pp["ranks"]]), default=str)
        + f" [{card}]")
    log("  sp: " + json.dumps(dict(
        wall=sp["wall"], seconds=sp["seconds"], ref=sp["ref"], long_ref=sp["long_ref"],
        long_dense=sp["long_dense"], errs=sp["errs"], bf16_errs=sp["bf16_errs"],
        ranks=[dict(rank=r["rank"], times=r["times"], long=r["long"],
                    runs={k: {f: v.get(f) for f in ("steps", "peak", "comms", "launches")}
                          for k, v in r["runs"].items()},
                    recipe={k: {f: v.get(f) for f in ("comms", "launches", "bleu")}
                            for k, v in r["recipe"].items()}) for r in sp["ranks"]]), default=str)
        + f" [{card}]")
    log("  ep: " + json.dumps(dict(
        wall=ep["wall"], seconds=ep["seconds"], ref=ep["ref"], gates=ep["gates"],
        ranks=[dict(rank=r["rank"], runs={k: dict(
            times=v["times"], peak=v["peak"], forward=v["forward"],
            **{opt: {f: v[opt][f] for f in ("comms", "launches", "expert_bytes")} for opt in ("sgd", "adam")})
            for k, v in r["runs"].items()},
            recipe={k: {f: v.get(f) for f in ("comms", "launches", "bleu", "moe_aux", "resumed")}
                    for k, v in r["recipe"].items()}) for r in ep["ranks"]]), default=str)
        + f" [{card}]")
    log("  lc: " + json.dumps(dict(
        wall=lc["wall"], seconds=lc["seconds"], refs=lc["refs"], errs=lc["errs"],
        ranks=[dict(rank=r["rank"], runs=r["runs"], long=r["long"],
                    recipe={f: r["recipe"].get(f) for f in ("comms", "launches", "bleu", "test_loss")})
               for r in lc["ranks"]]), default=str) + f" [{card}]")
    log("  ingest: " + json.dumps(dict(seconds=ingest["seconds"], ms=ingest["ms"], data=ingest["data"]),
                                default=str) + f" [{card}]")
    log("  elastic: " + json.dumps({k: v for k, v in elastic.items() if k != "ranks"}, default=str)
        + f" [{card}]")
    log("  bf16: " + json.dumps(dict(
        parity=bf["parity"], train_step={"fp32": train_times, "bf16": train_times_bf16},
        tinyvgg_step={"fp32": zoo["times"]["cnn cifar10"], "bf16": cnn_times_bf16}), default=str)
        + f" [{card}]")
    log("  fleet: " + json.dumps({k: {f: v for f, v in part.items() if f not in ("decisions", "launches")}
                                  if isinstance(part, dict) else part for k, part in fleet.items()},
                                 default=str) + f" [{card}]")
    log("  drills: " + json.dumps({k: v for k, v in drills.items() if k != "c"}, default=str)
        + f" [{card}]")
    log("  report CLIs (tools/torch_{telemetry_report,trace_report,gang_status}.py): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in REPORT_CLI_SECONDS.items())
        + f"; wall added to the smoke {REPORT_CLI_SECONDS.get('offline reports (7b)', 0.0):.2f} s (the live "
        "status runs beside the gang)")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
