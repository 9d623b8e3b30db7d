#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, runtime,
shared-prefix serving, decode-variant, serving-artifact, sharded
training, expert-parallel, pipeline, sharded-decode, tensor-parallel
serving and runner-across-cards slices on one NVIDIA GPU, the agent's
device layer with four tenants sharing that GPU, the agent's device
plugins and container injection with a tenant started from what they
inject, the node agent itself across a restart, with a tenant served
from a binding it restored, the agent's observability plane read
around a tenant, the agent's runtime activation: its NRI server and
the OCI hook chain, each starting a tenant, with a card-failure
eviction, the agent's utilization sampler, drain and migration
handshake around a runner tenant that is drained, reclaimed early and
resumed, the agent's live re-partitioning and goodput ledger around
three tenants that report their own device-busy shares, the agent's
multi-host slice orchestration: two agents whose slice re-forms around a
runner tenant when a member leaves and when one returns, and the agent's
fleet simulator: a fleet of the port's agents whose node 0 is the card,
with a tenant served from one of its binds.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``; without a device it prints no result and exits
2. A failed check is printed and the run goes on, so that every reading
shows; it then exits 1 before the summary lines. Phases:

1. build the hand-written CUDA kernels from ``elastic_tpu_agent_torch/
   csrc`` (nvcc, sm_90a) into the git-ignored ``_build/`` directory;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (and at a few edges: q/k/v as strided views of one
   fused projection, a paged row of length 0, the largest query group at
   head_dim 128 and block 64, paged tables whose rows name the same first
   8 blocks as a prefix-cache hit maps them (timed too), the backward at
   1024 positions, one kv head,
   windows 1 and 64, 17 positions and batch 1, a misaligned bf16 dO view
   that must raise), and time the kernel, the plain version and one
   PyTorch library call that computes the same function (for the flash
   backward kernels: the backward of scaled_dot_product_attention), all
   three by device time: CUDA events around calls queued behind a sleep
   kernel, so that the host's gaps are not timed (the kernel also by
   CUDA events around calls the host paces);
3. the flagship forward at the full width of the runner's ``small``
   preset, through the flash kernel, against the same model forced onto
   the reference attention;
4. the ServingEngine at the same preset: 16 requests (admit and enqueue,
   greedy and sampled) through the paged-decode kernel; then a float32
   two-layer copy whose kernel-path greedy streams must equal the gather
   path's and ``generate()``'s;
5. the train step at the same preset (batch 8, seq 256, lr 1e-3, f32
   params computed in bf16: the JAX runner's defaults) for 20 steps on
   one fixed batch, through the flash forward and both backward kernels,
   against the same run on the reference attention; then a float32
   two-layer copy whose kernel-path gradients must equal the reference
   path's; a short torch.profiler pass gives the device-busy share
   (reported as not measured when the profiler sees no device time);
6. the in-pod runtime: ``runner.main`` in this process on the card at the
   same preset, each report read from its printed JSON line. Train: 20
   steps with evals and checkpoints on a Zipf-distributed token file,
   launch counts of the three attention kernels over exactly that run
   (its warm-up pass included), eval loss falling, a flight-recorder
   record per step; decode mode from that checkpoint; resume: 10 steps,
   then the same command again, whose final loss must equal the
   uninterrupted run's within RESUME_TOL; pre-copy drain: an alloc spec
   with the drain already stamped, delta rounds while training goes on
   (each split into the copy to the host and the rest), a final delta, an
   ack whose digest is the verified chain, and a resume from that chain;
7. MoE (the same preset with 4 experts in every second layer, the
   repo's MoE count): the layer held against the JAX layer's one-hot
   einsum form on the card (float32: outputs, aux loss, routes and
   gradients; bf16: outputs); the forward at ``[8,256]`` through the
   flash kernel against reference attention; 20 train steps through the
   flash forward and both backward kernels against the same run on
   reference attention, with the aux loss, drop rate and imbalance; 16
   requests on the kernel-path engine; a float32 two-layer copy whose
   kernel-path streams must equal the gather path's (and, at the
   drop-free capacity factor, ``generate()``'s) and whose gradients must
   match the reference path's (routes that differ between the runs are
   counted);
8. int8 at the dense preset: ``quantize_params`` on the card byte-equal
   to the CPU's, ``generate`` on the int8 weights (tokens/s, greedy
   agreement with the bf16 stream), a ``kv_int8`` engine over 16 requests
   (the gather path: no paged-decode launch), ``runner --mode decode
   --int8``;
9. the engine's flight recorder and lifecycle drain: 16 admitted
   requests give one ``serving_admit`` record each and one
   ``serving_step`` per step; then a drain stamped into the alloc spec
   refuses admission, ``drain_serving`` finishes the streams and writes
   the ack;
10. shared prefixes at the dense preset: 16 requests sharing a 128-token
   system prompt (tails of 8-64 tokens; admit and enqueue, greedy and
   sampled) on the kernel-path engine without and with ``prefix_cache``
   (prefilled tokens, hits, TTFT p50 from the admission call to the first
   token, tokens/s, paged launches = layers x decode steps, the pool
   holding only the cache's blocks after every release and none after
   ``clear()``); ``register_prefix`` and 8 ``admit(prefix=)`` on the same
   engine; a prefill-role and a decode-role engine over one
   ``SharedKVPool`` sharing one ``RequestObservatory`` (16 adoptions, at
   most a block of decode-side prefill each, conservation within 1 ms,
   one id per request, TTFT/TPOT per SLO class); 8 streams decoded 10
   steps, then ``drain_serving(handoff=True)`` acked through a watcher
   and a peer engine adopting and finishing them; a float32 two-layer
   copy whose greedy streams must be the same over the uncached, cached,
   explicit-prefix, disaggregated and handed-off runs and ``generate()``;
11. speculative decoding at the dense preset with a draft of the runner's
   ``tiny`` widths at the same vocabulary, gamma 4: solo (a 32-token
   prompt, 128 new tokens) beside ``generate()``, and the serving cell's
   16 requests (sampled ones at temperature 0.8 without top-k, which spec
   mode refuses) on a speculative engine beside the plain engine, both at
   a ``max_len`` of 256 that the longest requests reach (tokens/s,
   acceptance rate; the speculative engine's fallback steps launch the
   paged kernel layers x steps times); float32 two-layer copies whose
   solo and engine greedy streams must equal ``generate()``'s, a
   self-draft that must commit every round in full, and a run near
   ``max_len`` whose fallback steps launch the paged kernel layers x
   steps times, with streams equal to the same engine's on the gather
   path;
12. beam search at the dense preset: beam 4, a 32-token prompt, 64 new
   tokens, without and with eos; beam 1 on a float32 copy equal to
   ``generate()``;
13. streaming ring-cache decode at the dense preset's widths with rope and
   a 256-token window (no preset sets one): 8 rows, a 64-token prompt, 768
   new tokens; the ring's bytes and the peak allocation must not grow with
   the length; a float32 copy streams as ``generate()``'s full cache does;
14. LoRA on the frozen bf16 dense preset: rank 8 on ``wqkv`` and ``wo``
   (196,608 adapter params), 20 steps at batch 8, seq 256, lr 1e-3 through
   the flash forward and both backward kernels (8 launches each a step)
   against reference attention (each loss within ``LORA_TRAIN_BF16_TOL``);
   the base bit-unchanged and the merged forward equal to the adapted one;
15. serving artifacts: phase 5's trained f32 params saved as a port
   train checkpoint and exported by the export CLI (f32 and ``--int8``)
   and by ``save_artifact`` (bf16); each artifact's bytes, save ms and
   load ms, reloaded bit for bit; ``runner --mode decode --params-dir`` on
   the bf16 and int8 artifacts, whose greedy tokens must equal
   ``generate()``'s on the in-memory params;
16. the sharded train step over a one-rank NCCL world (``make_mesh(1)``,
   a file store in a temp directory): 20 steps at phase 5's weights and
   tokens, then 20 with zero1 and master weights, each run's losses equal
   to phase 5's (MESH_TOL), 8 launches a step of each flash kernel, and
   the device time of the gradient all-reduce; NCCL puts one rank on a
   card, so cross-card runs need more cards;
17. ring attention: the three flash kernels against their plain versions
   at the ring's call patterns (non-causal blocks, causal blocks with an
   lse cotangent, 1024 positions a chunk at head_dim 128 f32 and 64
   bf16); the stacked ring (``ring_attention_stacked``, sp 4) at 4096
   positions: ``[1,4096,1,128]`` f32 against plain full attention
   (RING_F32_TOL, the dryrun's), ``[2,4096,8,64]`` bf16 against the same
   ring run on the kernels' plain versions on the CPU, 4 launches of each
   kernel a ring, and the ring's forward and forward + backward device
   times beside one flash call over the whole 4096 and SDPA;
18. the summary, printed after phases 19-31: the device time of the
   whole bf16 backward (delta, dK/dV and dQ) against SDPA's whole
   backward, each phase's host seconds, a
   ``paths`` JSON line, a ``kernels`` JSON line (each kernel's launches
   summed over the paths it lies on: forward, LoRA, the sharded step, the
   ring, the MoE mesh step, both pipeline schedules, the runner's mesh
   runs and the train tenants of phases 24, 29, 30 and 31 for flash_fwd;
   train, LoRA, the sharded step, the ring, the MoE mesh step, both
   pipeline schedules, the runner's mesh runs and the train tenants for
   the backward pair; serving, the speculative fallback and the serving
   tenants of phases 24-30 for paged_decode),
   the card's name and power limit as
   nvidia-smi reports them, and the result line;
19. MoE over a one-rank NCCL mesh: phase 7's MoE preset, weights and
   tokens through ``make_train_step(mesh=make_mesh(1))`` for 20 steps;
   the losses, the step-0 aux loss and drop rate equal phase 7's
   (MOE_MESH_TOL), 8 launches a step of each flash kernel, step p50
   beside phase 7's (cross-card ep needs more cards);
20. the pipelined flagship: the small preset on a ``StackedPipe`` at pp
   4, 4 microbatches of 2 (phase 5's tokens), bf16 compute on f32 params
   restacked from phase 5's weights; GPipe and 1F1B, 20 steps each: the
   step-0 losses equal phase 5's (PIPE_STEP0_TOL) and 1F1B's losses
   GPipe's (PIPE_SCHEDULE_TOL), launches over exactly each run (GPipe 640
   of each kernel; 1F1B 1120 flash_fwd: the recompute, and a graph-free
   forward on every stage but the last, and 640 of each backward kernel),
   step p50 and peak allocation (1F1B's no larger than GPipe's); a
   float32 two-layer copy at pp 2 whose 1F1B gradients, through
   ``pipeline_loss_and_grads``, equal the unpipelined reference-attention
   gradients (TRAIN_GRAD_F32_TOL);
21. sharded decode over a one-rank NCCL mesh: the small preset with rope
   and 2 kv heads, ``generate(..., mesh=make_mesh(1))``, batch 8, a
   32-token prompt, 128 new tokens; greedy streams equal ``generate()``'s
   in bf16, on a float32 copy and on int8 weights; tokens/s of both;
22. tensor-parallel serving over a one-rank NCCL mesh
   (``make_serving_mesh(mp=1)``): phase 4's 16 requests on the TP engine,
   streams equal to a plain engine's on the same gather path, in bf16 and
   on a float32 two-layer copy, tokens/s beside it and phase 4's; the
   paged-kernel rule's ratio and decision at phase 4's shape, through
   which phase 4's engine must have resolved on;
23. the runner across cards at world 1: ``runner.main`` through the join
   path over a one-rank NCCL group on phase 6's token file, phase 6's
   flags (losses and evals equal to phase 6's, MESH_TOL), then with
   ``--zero1 --master-weights`` (equal to the same flags on the
   single-device path), 200/168/168 flash launches each; decode ``--dp 1
   --tp 1`` from the first run's checkpoint gives phase 6's tail;
   ``devices``/``mesh`` and ``step_time_ms`` beside phase 6's; ``--pp 2``
   is refused on one card and not measured;
24. the device layer, then a functional check of the quota and of four
   tenants co-located on the card (a mix of this script's own phases 4
   and 6, no deployment's traffic; its utilization readings are shown,
   not judged):
   ``NvidiaOperator("/dev")`` in a child process that never imports
   torch (its card's uuid, SMs and memory against torch's, health, the
   nvidia-smi call's ms); a virtual link under a temp dev root aimed at
   the card's ``/dev/nvidia<minor>`` that resolves back to its index and
   is deleted; a child with a 10% grant (its env file from the port's
   ``qos_env`` and ``visibility_env``, applied by ``runner.load_alloc_env``
   and ``runner.apply_hbm_quota``) that allocates the quota less 512 MiB
   and must raise ``OutOfMemoryError`` at the quota plus 256 MiB; then
   tenants of 25 core units and a quarter of the memory units each, in
   child processes started together at a barrier: T1 alone, then T1 and
   T2 (``runner.main`` with phase 6's flags on phase 6's token file, each
   in its own directories) beside T3 and T4 (phase 4's 16 requests on the
   kernel-path engine). T1 and T2's losses and evals must equal phase 6's
   and T3 and T4's streams phase 4's; each tenant's launches, reserved
   memory (at most its fraction of torch's ``total_memory``) and
   ``step_time_ms`` or tokens/s; ``nvidia-smi``'s ``utilization.gpu``
   and used memory, polled every 0.5 s, for the idle, T1-alone and
   all-four windows (and for the span in which their tenants worked);
25. the device-plugin path, with no kubelet or apiserver and without
   grpc or protobuf: in-script stand-ins play the kubelet's pod-resources
   and the apiserver (``_Kubelet``, ``_Apiserver``) and a dict the agent's
   storage (``_Store``). ``NvidiaOperator("/dev")`` discovers the card in
   a child without torch; the port's ``GPUSharePlugin`` proposes, allocates
   and binds 25 gpu-core units and a quarter of the card's gpu-memory
   units for one annotated pod (links under a temp dev root, specs under a
   temp alloc dir); ``nri.plain_adjustment`` injects the spec: the card
   at ``/dev/nvidia<minor>`` with the host node's major:minor, the control
   nodes, ``CUDA_VISIBLE_DEVICES`` = the card's uuid and the quota env of
   ``qos_env``. Tenants running phase 4's 16 requests start from the
   container's env alone (this process's visibility and quota keys
   stripped), at once: one plainly, one (``unshare -m``, root) in a new
   mount namespace whose /dev holds only the injected nodes (mknod) and
   the OCI defaults; each must see exactly the allocated card, serve phase 4's
   streams with its paged launches and stay under the injected cap. Then
   whole-card Allocate through ``ExclusiveOperator`` (the card's node, the
   control nodes, its uuid), the pod's deletion and the GC sweep (no link,
   spec, record or intent left); host ms of each plugin call;
26. the node agent across a restart, with no kubelet, grpc or protobuf:
   ``tests/fake_apiserver.py`` serves the apiserver over HTTP on
   127.0.0.1 (a JSON kubeconfig points at it) with four pods annotated
   for the card; a stand-in for the kubelet's pod-resources API
   (``_PodResources``) is handed to the manager, and the script plays the
   kubelet through the plugins' plain methods. The port's
   ``NodeManager`` runs in child processes without torch (``python3
   chip_smoke.py --agent A|B``) on a temp sqlite db, dev root and alloc
   dir, with ``NvidiaOperator`` on /dev, its gRPC servers left out. Boot A
   syncs, restores nothing and starts the supervised sitter, GC, health
   and reconciler loops (period 3600 s); four pods of 25 gpu-core and a
   quarter of the card's gpu-memory units are bound (links to
   ``/dev/nvidia<minor>``, merged specs with the card's nodes, its uuid,
   the quota and the trace id, records), pod 3's memory PreStart killed
   at ``bind.post_create``. Then the links are wiped, as a reboot clears
   /dev, and pod 4 is deleted. Boot B's ``restore()`` must re-create
   pods 1-3's links, resolve pod 3's open intent as
   ``tests/test_torch_reconciler.py`` pins it (rolled back, replayed) and
   reclaim pod 4. A tenant started from pod 1's restored spec env alone
   serves phase 4's 16 requests (its streams, 1352 paged launches, one
   card, under the cap); pod 1's deletion at the apiserver must be
   reclaimed by GC through the sitter within 10 s; the health loop must
   have polled nvidia-smi with every id still Healthy. Host ms of each
   bind call, sync, restore and GC, and the db's size;
27. the agent's observability plane: the port's CLI ``main`` (``python3
   chip_smoke.py --agent C``, a child without torch; phase 26's
   operator and pod-resources stand-ins handed to the manager it builds,
   its gRPC servers left out) with the event bus, a 0.005 s group-commit
   window, Events and the ElasticTPU recorder against the fake apiserver,
   ``--metrics-port`` on loopback and the profiler at 5 Hz (the rate the
   agent pins its overhead at; the flag's default is off). It binds two
   pods; pod 1's spec trace id must be in ``/debug/traces`` and on its
   ``bind_intent`` before its ``bind_commit`` in ``/debug/timeline``. A
   tenant from pod 1's spec alone (``--tenant serve_obs``) serves phase
   4's 16 requests through the paged kernel (its streams, 1352 launches)
   with its own AgentMetrics on a loopback port: the serving families
   must equal ``engine.stats()`` and ``/debug/requests`` hold 16
   records. Pod 2 deleted at the apiserver: its journal must show the
   reclaim, both its ElasticTPU objects go Released and are removed
   within 10 s, pod 1's stay Bound, each pod has a ``TPUBound`` Event.
   ``/metrics`` must lint clean with 4 Allocate and 4 PreStart
   observations, 1 bound allocation, 1 card, 1 healthy; ``/healthz``
   200; ``/debug/latency``'s phases plus residual equal each bind's
   total; ``/debug/profile`` has samples at under 1% overhead;
   ``node-doctor profile`` (live) and ``node-doctor timeline`` (the
   stopped agent's db) exit 0; the agent imports no torch. Prints the
   bind host ms beside phase 26's, deletion-to-reclaim ms with the
   detection lag's loop and trigger, the residual's share, the db's
   bytes and the sinks' merged and dropped, beside the card's name and
   power limit;
28. the agent's runtime activation: the port's native helpers built from
   ``elastic_tpu_agent_torch/native`` (g++/gcc, ``native/build.py``);
   the CLI ``main`` (``python3 chip_smoke.py --agent D``, a child without
   torch, phase 26's stand-ins, its health read through a flag file the
   script controls on top of nvidia-smi) with ``--nri-socket`` and
   ``--nri-evict-on-chip-failure``, its dev root a view of /dev holding
   the card's nodes beside its links. A runtime stand-in on the port's
   mux and ttrpc (``tests/torch_nri_runtime.py``) takes its
   registration, Configure (CREATE and REMOVE subscribed) and
   Synchronize; the agent binds two pods of 25 gpu-core units and a
   quarter of the card's gpu-memory units. CreateContainer with
   ``GPU=<pod 1's hash>`` must inject the card at ``/dev/nvidia<minor>``
   with its major:minor, the control nodes and the spec's env; a tenant
   runs in a /dev of those nodes alone from the adjustment's env. A
   bundle with ``GPU=<pod 2's hash>`` goes through ``elastic-gpu-hook``
   (the OCI state on stdin): the same nodes and the spec's env in the
   rootfs's ``/run/elastic-tpu/env``; with the spec moved away the
   dev-scan fallback injects the same nodes and the card's uuid; a tenant
   runs with the rootfs's /dev bound over /dev and its env from that file
   alone. Both tenants serve phase 4's 16 requests (its streams, 1352
   paged launches, one card, under the cap). The flag marks the card
   unhealthy: within two health periods the stand-in must get one
   UpdateContainers evicting the NRI tenant's container; the flag
   cleared, a second CreateContainer is injected and not evicted. The
   stand-in restarts: the agent re-registers within its first backoff
   and synchronizes. Prints the host ms of the CreateContainer round
   trips, hook + toolkit, flag to UpdateContainers and re-registration,
   beside the card's name and power limit;
29. the agent's utilization sampler, drain and migration handshake: the
   CLI ``main`` (``python3 chip_smoke.py --agent E``, a child without
   torch, phase 26's stand-ins) with ``--metrics-port`` on loopback,
   ``--sampler-period 1``, ``--drain-period 0.5``, ``--migration-period
   0.5`` and ``--drain-deadline 120`` binds pod T (50 gpu-core units and
   half the card's gpu-memory units) and pod S (25 gpu-core units). A
   tenant from T's spec env (and the pod's mount of the alloc dir) runs
   the runner in train mode on phase 6's preset and token file, 30 steps
   (under torch.profiler), beside one from S's that serves phase 4's 16
   requests on the paged kernel (under torch.profiler); meanwhile
   ``/debug/allocations`` must list both pods with the card's duty and
   their 1m windows, and the sampler's duty p50 and each pod's
   attributed share are printed beside each tenant's device-busy share
   (shown, not judged); ``node-doctor`` (live) and ``--validate`` exit 0.
   S's pod is deleted and reclaimed; ``elasticgpu.io/drain`` set on the
   node at the fake apiserver must take the agent to cordoned, then
   draining (the cordon journaled) and stamp ``ELASTIC_TPU_DRAIN`` and
   its deadline into T's spec; T's tenant then runs the same 30 steps
   with pre-copy rounds every 3 steps and a checkpoint dir: the
   coordinator must stamp the cutover, the runner ship the final delta
   and ack, and the coordinator reclaim T before the deadline (the drain
   ``drained_acked``, ``elastic_tpu_drain_early_reclaims_total`` 1) and
   publish a ``Migrated`` ElasticTPU object carrying the step, the chain
   digest and T's bind trace id, with ``TPUNodeDraining`` and
   ``TPUMigrationRecorded`` Events. The annotation cleared and T deleted,
   a replacement pod of T's name binds; its spec must gain
   ``ELASTIC_TPU_RESTORE_DIR``/``_STEP``, and a tenant from it alone
   resumes from the delta chain to step 30 at the first run's final loss
   (RESUME_TOL); its resume ack must give ``TPUMigrationCompleted``,
   ``elastic_tpu_migrations_completed_total`` 1 and a ``migration``
   completed row with T's trace id. Prints the host ms of cordon ->
   signaled -> acked -> reclaimed beside the deadline, the pre-copy
   rounds with their bytes and the cutover ms, replacement bind ->
   verified and the flash launches of the runs, beside the card's name
   and power limit; the agent imports no torch;
30. the agent's live re-partitioning and goodput ledger: the CLI ``main``
   (``python3 chip_smoke.py --agent F``, a child without torch, phase
   26's stand-ins) with ``--metrics-port`` on loopback, the sampler,
   repartition and goodput periods 1 s, migration 0.5 s, reconcile 1 s
   and ``--qos-evict-after 60`` binds three pods opted in through
   ``elasticgpu.io/repartition``: D (high priority, 40 gpu-core units and
   a quarter of the memory) whose tenant serves phase 4's 16 requests on
   the paged kernel and then idles, O (low, 1 unit) whose runner then
   trains at the small preset, batch 32, seq 512 with a checkpoint dir
   until it is stopped, and B (high, a quarter of the memory and the
   gpu-core units that centre the growth band on its workload's share:
   the p50 of its shares over a 150-step run of it alone, outside any
   pod, just before, the start-up window left out) whose runner then
   trains 300 steps at phase 6's preset and token file, batch 2, and
   idles. Each tenant starts from its spec's env alone and writes its
   own device-busy share every 2 s through
   ``telemetry.write_usage_report``: the device time torch.profiler
   (CUPTI, device activity only) saw of it in the window over the
   window's wall time, the windows turning in the tenant's working
   thread. O over its grant must be throttled (the throttle keys
   stamped, ``TPUThrottled``), its runner checkpoint and ack, and the
   controller evict it before the deadline with a ``Migrated`` record of
   reason ``qos_evict``, reclaim its links and specs, count 1 throttle
   and 1 eviction, post ``TPUQoSEvicted``, and replay nothing for 3
   reconcile periods while the kubelet stand-in still lists O; O's
   tenant is then stopped (SIGTERM) and B starts. D idle and B busy
   must move core units D -> B (both specs restamped, their sum the sum
   of the grants, ``direction="grow"`` counted, ``TPURepartitioned``
   posted, a ``repartition`` row, the edge in ``/debug/allocations``, no
   unit to low O); B's run ending must unwind the edge (specs back to
   the grants, ``direction="shrink"``).
   ``/debug/goodput`` must hold the
   three pods, each conserved, O's partition queued, productive and
   checkpointing (its cause the throttle; the ack's checkpointing and
   migrating claims outrank ``throttled``), every cause resolving in the
   timeline, ``elastic_tpu_downtime_seconds_total{cause="qos_throttle"}``
   above 0 and a goodput-ratio series for each live pod; ``node-doctor``
   (live) and ``--validate`` exit 0; after SIGTERM ``node-doctor goodput
   --db-file`` gives O's intervals as the last live read. Prints each
   tenant's measured share beside the sampler's card duty p50, host ms
   from B's first busy report to its restamped spec and from its idle
   report to the unwind, throttle -> ack -> evict beside the deadline,
   each pod's goodput ratio and O's downtime by cause, and the phase's
   launches, beside the card's name and power limit.
   ``ELASTIC_TPU_CORE_UNITS`` is a hint on this card (nothing time-slices
   SMs by it): the restamps are shown as restamps;
31. the agent's multi-host slice orchestration: two CLI ``main``s
   (``python3 chip_smoke.py --agent G``, children without torch, phase
   26's stand-ins, reconcile 0.5 s, ``--slice-membership-ttl 0.5``) over
   one fake apiserver: agent A (node ``h100-a``, host h0) on the card,
   agent B (node ``h100-b``, host h1) on a port StubOperator of one stub
   H100. Slice ``s31`` (``h100-sxm5-16``, hosts annotated ``h1,h0``, 50
   gpu-core units a member): p0 on A and p1 on B must stamp
   ``TPU_WORKER_HOSTNAMES=h0,h1``, ids 0 and 1, epoch 0, no ICI bounds,
   with empty validation problems, a ``slice_formed`` row on each agent,
   ``elastic_tpu_slice_members{slice="s31"}`` 2 and one packing-span
   observation a bind. ``elasticgpu.io/drain`` on B's node: B marks p1
   ``elasticgpu.io/draining`` and A must re-form p0 to ``h0`` at epoch 1
   (a ``TPUSliceReformed`` Event, a ``slice_reformed`` row losing h1). A
   runner tenant trains from p0's env (world 1, the small preset, batch
   8, seq 256, a checkpoint dir); p1 deleted, B's drain cancelled and a
   replacement p1b bound on B, A must re-form p0 to ``h0,h1`` at epoch 2,
   the tenant stop on ``reform``, save and ack at epoch 2, and p0's
   goodput ledger close a ``checkpointing`` interval of cause
   ``slice_reform`` at the ack. A runner restores from that checkpoint at
   world 1 (one card cannot host NCCL's two ranks) at the acked step + 1
   and its final loss must equal an uninterrupted run's (RESUME_TOL).
   Prints the host ms from B's draining patch to A's restamp and from the
   restamp to the ack, beside the card's name and power limit; the agents
   import no torch;
32. the agent's fleet simulator (``elastic_tpu_agent_torch/sim/``): in this
   process, complete port agents (``NodeManager`` with its gpushare
   plugins and real gRPC servers, each over its own fake kubelet,
   ``tests/torch_fake_kubelet.py``, and a private metrics endpoint), all
   sharing one ``tests/fake_apiserver.py``. Node 0 of each fleet is the
   card: an ``NvidiaOperator`` over the host's /dev (links under the
   node's dev root, its nvidia-smi calls counted, maintenance and
   preemption answered from settable state, never the metadata server);
   its listing must be exactly torch's device. 32a, ``bench.py``'s fleet
   leg size (``bench.py:543-546``): 8 nodes, reconcile 2 s, 2 binders a
   node, 25 sampled traces; nodes 1-7 ``stub:8`` with 125 pods each;
   node 0 admits only what its one card's gpu-core units hold (100 units
   over 10 a pod: 10 pods), so the fleet holds 885 pods. Every bind must
   land (stored binds equal the admissions a node; node 0's records on
   the card), the scraped fleet bind p50/p99 (merged histograms) beside
   the driver's stopwatch, every node's reconcile convergence after the
   churn, kubelet Lists, apiserver requests and sink writes a bind
   within the structural checker's bounds, each sampled admission trace
   id on its binding node, and node 0's nvidia-smi calls at most one a
   2 s TTL (the card node is never polled through ``op.resolve``). 32b: a
   serving tenant started from the env and spec node 0 stamped for its
   first pod (``nri.plain_adjustment``) serves phase 4's 16 requests and
   must give phase 4's streams with its paged launches. 32c: the chaos
   tests' compound scenario on a 2-node fleet (node 0 the card, node 1
   ``stub:4``): a slice across both, node 1's maintenance drain (the
   slice's reform on node 0) over a throttle on node 0, under a brownout,
   a flaky group commit and a kubelet flap, over trace-driven traffic;
   ``scale_problems`` must find nothing, the survivor must reach epoch 1,
   and a sabotaged run (stub nodes) must trip the checker with its repro
   line. 32d: ``ScaleHarness`` at 2 stub nodes x 32 pods, batched, with
   its 10,500-series cardinality storm, clean under ``scale_problems``. Each leg's seconds go to the phase seconds
   line.

``--profile`` adds a torch.profiler pass over one forward, 20 decode
steps and 3 train steps (device-busy share and top device ops, printed).
``--out DIR``
writes the full report to ``DIR/chip_smoke.json`` and, with
``--profile``, the profiler tables and chrome traces to ``DIR/profile/``.

Weights are random, in the JAX ``init_params`` layout, made with numpy
from ``SEED`` and loaded through the weight bridge. Nothing of JAX or of
the JAX package is imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import stat
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

SEED = 0
# elastic_tpu_agent/workloads/runner.py PRESETS["small"]
SMALL = dict(vocab=32768, d_model=512, n_heads=8, n_layers=8, d_ff=2048)
# H100 SXM data sheet: memory rate and dense peaks by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# max |kernel - plain| on the card. float32 outputs differ by summation
# order only. bf16 limits sit between the sound kernels' readings and
# those of kernels with a planted fault, run the same way (PERF.md):
# flash_fwd o gave 3.9e-3 (one ulp near 1; the plain version rounds p to
# bf16 as the kernel does) and 1.6e-2 without the kernel's cast of p;
# paged_decode keeps its math in f32 and rounds only the output: up to
# 4.9e-4 (one output ulp in [1/16, 1/8)), and 4.4e-2 attending one
# position short of the length.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
PAGED_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
LSE_TOL = 1e-3
# bf16 logits, flash kernel vs reference attention through 8 layers: the
# two round at different places (the reference rounds scores and
# normalised probabilities to bf16, the kernel keeps f32 scores). Sound
# kernels gave 0.027; a causal mask dropped or shifted in the kernel gave
# 2.3 to 2.8.
FORWARD_BF16_TOL = 0.06
FORWARD_F32_TOL = 1e-3  # same comparison in float32
# flash backward kernels, for each of dq, dk, dv: max |kernel - plain|
# over max |plain| (BWD_TOL), and mean |kernel - plain| over mean |plain|
# (BWD_MEAN_TOL), which sees a rounding fault that moves every element by
# less than the largest element's ulp. float32 differs by summation order
# only. In bf16 one rounding that lands the other way on the largest
# element is an ulp, up to 2^-8 = 3.9e-3 of it, so the max limit is two
# ulps; the mean limit sits between the sound kernels' readings and those
# of kernels with a planted fault (PERF.md, Findings): the sound wgmma
# kernels gave up to 2.6e-3 (max) and 4.6e-6 (mean); the planted faults
# 0.95 or more (max) and 0.18 or more (mean). (The FMA kernels' fault "ds
# not rounded before dK", 1.6e-3 mean, cannot be planted in the wgmma
# ones: ds reaches the product only as a bf16 register operand.)
BWD_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
BWD_MEAN_TOL = {"float32": 1e-5, "bfloat16": 1e-5}
# bf16 training losses over 20 steps, flash kernels vs reference attention
# (they round scores and probabilities at different places): sound
# kernels gave 0.045-0.046; delta dropped in dQ gave 0.235, the q-tile lower
# bound one tile late 1.26, lse/delta read by row 2.17 (PERF.md, Findings).
TRAIN_BF16_TOL = 0.2
# float32 two-layer gradients, kernel path vs reference path, relative to
# each leaf's largest gradient (summation order only)
TRAIN_GRAD_F32_TOL = 1e-4
TRAIN_STEPS = 20
# |final loss of a run resumed at step 10 - the uninterrupted run's|: none
# at all. The resumed run restores the f32 params and optimizer state bit
# for bit and reads the same batches at the same schedule counts, so it
# repeats the same computation with the same kernels on the same shapes,
# and no op on the path sums in thread order (the flash backward has no
# atomics; the embedding gradient's index_put sorts its indices; cuBLAS is
# deterministic on one stream): every sound run gave a gap of exactly 0.
# Restore faults planted in the runner (planted_faults.py F13-F15) gave:
# optimizer state left at its init 0.051, step count reset 0.036, second
# moment reset 51.8.
RESUME_TOL = 0.0
RUNTIME_STEPS = 20
EVAL_BATCHES = 2
# the MoE cell: the small preset with the repo's MoE count
# (__graft_entry__.py's MoE leg) and the config's defaults (every second
# layer, capacity factor 1.25, aux coefficient 0.01)
MOE_EXPERTS = 4
# moe_mlp against the JAX layer's one-hot einsum form on the same inputs:
# each slot holds one token, so the einsums' sums have one nonzero term
# and the two forms differ only where the expert matmuls sum in another
# order; relative to the largest element (outputs, aux, each gradient).
# Sound: outputs and aux exactly equal, gradients 5.7e-7 at most; the MoE
# faults planted in moe.py (PERF.md, Findings): the gate dropped 1.18 or
# more, capacity C + 1 0.0495 or more (and a route differing)
MOE_LAYER_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# bf16 MoE model, flash kernels vs reference attention. A route that
# flips between the two runs (29-48 of 8,192 with sound kernels) changes
# that token's MLP output outright, so the forward's logits are compared
# on their mean |difference|: sound attention 0.0043-0.0083, the causal
# mask one column late (F9) 0.0495. Train losses over 20 steps drift apart
# as flipped routes compound: with sound attention kernels 0.110-0.258
# (the sound tree and the runs with MoE faults, whose kernels are sound),
# with backward or forward faults 0.594 (F9), 1.65 (F8), 1.90 (F12); F6
# (0.337) sits below the limit and fails the dQ check and the dense gap.
MOE_FORWARD_BF16_MEAN_TOL = 0.02
MOE_TRAIN_BF16_TOL = 0.5
# float32 two-layer gradients, as the dense cell's: sound 1.10e-6 to
# 1.14e-6 with no route flipped; no planted fault reaches the f32 kernels
MOE_GRAD_F32_TOL = 1e-4


FAILURES: list = []
# seconds each phase took (host clock), printed with the summary
PHASE_SECONDS: dict = {}


def fail(msg: str) -> None:
    """Record a failed check; the run goes on so that every reading is
    printed, and exits non-zero at the end."""
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    FAILURES.append(msg)


def timed(name: str, fn, *args):
    """fn(*args), its host seconds kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 2)
    return out


def cuda_ms(fn, warmup: int = 5, iters: int = 50) -> float:
    """Mean time of fn() in ms over ``iters`` back-to-back calls (CUDA
    events, after warm-up): device time plus any gap the host leaves."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, reps: int = 20) -> tuple:
    """Device time of one fn() in ms: CUDA events around ``reps`` calls
    that the host queued while a sleep kernel held the card, so that the
    calls run back to back on the card and the host's gaps between them
    are not timed (CUDA events around host-bound calls would time them).
    Returns (ms, queued): ``queued`` is False when the host had not queued
    every call before the card reached the first, even after a longer
    sleep and fewer calls; the time then includes host gaps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0      # the host's time to queue reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = int(host_s * 4e9) + 2_000_000  # ~2x that at <= 2 GHz
    for _ in range(3):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()          # the card still sleeping
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        if queued:
            break
        cycles *= 4
        reps = max(5, reps // 2)            # fewer launches in the queue
    return ms, queued


def timings(torch, fn, plain, library=None) -> dict:
    """Device ms of the kernel, its plain version and the library call
    (the kernels line), with the kernel's CUDA-event ms over calls the
    host paces (``unqueued_ms``) beside."""
    out = {}
    for key, f in (("ms", fn), ("plain_ms", plain), ("library_ms", library)):
        if f is None:
            out[key] = None
            continue
        out[key], queued = device_ms(torch, f)
        if not queued:
            print(f"chip_smoke: {key} could not be queued ahead of the card; "
                  "it includes host gaps", file=sys.stderr)
    out["unqueued_ms"] = cuda_ms(fn)
    return out


def randn(torch, rng, shape, dtype, dev):
    return torch.tensor(rng.normal(size=shape), dtype=dtype, device=dev)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash(torch, A, dev):
    """Flash forward vs its plain version; returns the kernel's record."""
    rng = np.random.default_rng(SEED)
    b, s, n, h = 8, 256, 8, 64     # the forward phase's attention shape
    cases = [
        ("bf16 causal", torch.bfloat16, A.FlashConfig()),
        ("bf16 window 96", torch.bfloat16, A.FlashConfig(window=96)),
        ("bf16 fused-view", torch.bfloat16, A.FlashConfig()),
        ("bf16 causal batch 2", torch.bfloat16, A.FlashConfig()),
        ("f32 causal", torch.float32, A.FlashConfig()),
        ("f32 non-causal", torch.float32, A.FlashConfig(causal=False)),
    ]
    err_max = 0.0
    for label, dtype, fc in cases:
        bc = 2 if "batch 2" in label else b   # a pipeline microbatch
        if "fused" in label:   # views of one [b, s, 3, n, h] projection
            qkv = randn(torch, rng, (bc, s, 3, n, h), dtype, dev)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (randn(torch, rng, (bc, s, n, h), dtype, dev)
                       for _ in range(3))
        o, lse = A.flash_attention_with_lse(q, k, v, fc)
        o_ref, lse_ref = A.flash_attention_plain(q, k, v, fc)
        torch.cuda.synchronize()
        e_o = (o.float() - o_ref.float()).abs().max().item()
        e_l = (lse - lse_ref).abs().max().item()
        name = str(dtype).split(".")[-1]
        print(f"flash_fwd {label} [{bc},{s},{n},{h}]: max|o| err {e_o:.3g}, "
              f"max|lse| err {e_l:.3g}")
        if not (e_o <= FLASH_TOL[name] and e_l <= LSE_TOL):
            fail(f"flash_fwd {label}: o err {e_o}, lse err {e_l}")
        err_max = max(err_max, e_o, e_l)
    # timing at the main path's shape
    q, k, v = (randn(torch, rng, (b, s, n, h), torch.bfloat16, dev)
               for _ in range(3))
    fc = A.FlashConfig()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    times = timings(
        torch, lambda: A.flash_attention_with_lse(q, k, v, fc),
        lambda: A.flash_attention_plain(q, k, v, fc),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    nbytes = 4 * b * s * n * h * 2 + b * n * s * 4      # q, k, v, o + lse
    flops = 4 * b * n * h * (s * (s + 1) // 2)          # QK^T and PV, causal
    t, by = bound(nbytes, flops, "bfloat16")
    return dict(
        name="flash_fwd", route="cuda",
        source="elastic_tpu_agent_torch/csrc/flash_fwd.cu",
        replaces="elastic_tpu_agent/workloads/attention.py:100",
        launches=None, max_abs_err=err_max, bound_ms=t, bound_by=by,
        shape=f"[{b},{s},{n},{h}] bf16 causal", **times,
    )


def _bwd_inputs(torch, A, rng, dev, shape, dtype, fc, dlse):
    b, s, n, g, h = shape
    q, do = (randn(torch, rng, (b, s, n, h), dtype, dev) for _ in range(2))
    k, v = (randn(torch, rng, (b, s, g, h), dtype, dev) for _ in range(2))
    o, lse = A.flash_attention_plain(q, k, v, fc)
    dl = randn(torch, rng, (b, n, s), torch.float32, dev) if dlse else None
    return q, k, v, do, lse, A.flash_bwd_delta(o, do, dl)


def _bwd_check(torch, label, got, want, name) -> list:
    """Gradients (one tensor or a tuple) against their plain version:
    prints max |err|, relative max and relative mean, fails past BWD_TOL
    or BWD_MEAN_TOL for dtype ``name``; returns the max |err|s."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    errs, rels, means = [], [], []
    for x, y in zip(got, want):
        d, y = (x.float() - y.float().to(x.device)).abs(), y.float().abs()
        errs.append(d.max().item())
        rels.append(errs[-1] / y.max().item())
        means.append((d.mean() / y.mean().to(d.device)).item())
    print(f"{label}: max|err| " + ", ".join(f"{e:.3g}" for e in errs)
          + "; relative max " + ", ".join(f"{r:.3g}" for r in rels)
          + "; relative mean " + ", ".join(f"{r:.3g}" for r in means))
    if not (max(rels) <= BWD_TOL[name] and max(means) <= BWD_MEAN_TOL[name]):
        fail(f"{label}: relative max {rels}, mean {means}")
    return errs


def check_flash_bwd(torch, A, dev):
    """The backward kernels vs their plain versions; returns their
    records (dK/dV, dQ)."""
    rng = np.random.default_rng(SEED + 6)
    b, s, n, h = 8, 256, 8, 64     # the training phase's attention shape
    fc = A.FlashConfig()
    cases = [
        ("bf16 causal", torch.bfloat16, (b, s, n, n, h), fc, False),
        ("bf16 window 37", torch.bfloat16, (b, s, n, n, h),
         A.FlashConfig(window=37), False),
        ("bf16 GQA g2", torch.bfloat16, (b, s, n, 2, h), fc, False),
        ("bf16 dlse", torch.bfloat16, (b, s, n, n, h), fc, True),
        ("bf16 h128 s200", torch.bfloat16, (2, 200, n, n, 128), fc, False),
        # the wgmma instances' edges: 16 tiles queued per CTA (each ring's
        # phase wraps), one kv head for 8 query heads, windows of 1 and of
        # one tile, one ragged tile, batch 1. Window 1 leaves a row only
        # itself (p = 1, dp = delta up to rounding), so without an lse
        # cotangent its dq and dk would be rounding noise.
        ("bf16 s1024", torch.bfloat16, (2, 1024, n, n, h), fc, False),
        ("bf16 GQA g1", torch.bfloat16, (b, s, n, 1, h), fc, False),
        ("bf16 window 1", torch.bfloat16, (b, s, n, n, h),
         A.FlashConfig(window=1), True),
        ("bf16 window 64", torch.bfloat16, (b, s, n, 2, h),
         A.FlashConfig(window=64), True),
        ("bf16 s17", torch.bfloat16, (b, 17, n, n, h), fc, False),
        ("bf16 batch 1", torch.bfloat16, (1, s, n, n, h), fc, False),
        # a pipeline stage's microbatch (phase 20)
        ("bf16 batch 2", torch.bfloat16, (2, s, n, n, h), fc, False),
        ("f32 causal", torch.float32, (b, s, n, n, h), fc, False),
        ("f32 non-causal GQA h128 s200", torch.float32, (2, 200, n, 2, 128),
         A.FlashConfig(causal=False), True),
    ]
    plains = {"flash_bwd_dkdv": A.flash_bwd_dkdv_plain,
              "flash_bwd_dq": A.flash_bwd_dq_plain}
    kerns = {"flash_bwd_dkdv": A.flash_bwd_dkdv,
             "flash_bwd_dq": A.flash_bwd_dq}
    abs_max = dict.fromkeys(kerns, 0.0)
    for label, dtype, shape, cfg, dlse in cases:
        args = _bwd_inputs(torch, A, rng, dev, shape, dtype, cfg, dlse)
        for kname, kern in kerns.items():
            errs = _bwd_check(torch, f"{kname} {label} {list(shape)}",
                              kern(*args, cfg), plains[kname](*args, cfg),
                              str(dtype).split(".")[-1])
            abs_max[kname] = max(abs_max[kname], *errs)
    # a bf16 dO view whose head stride (68 elements) is no 16-byte
    # multiple: TMA cannot read it, so both wrappers raise before a launch
    args = _bwd_inputs(torch, A, rng, dev, (b, s, n, n, h), torch.bfloat16,
                       fc, False)
    pad = torch.zeros((b, s, n, h + 4), dtype=torch.bfloat16, device=dev)
    pad[..., :h] = args[3]
    bad = args[:3] + (pad[..., :h],) + args[4:]
    counters = (A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    before = [c.launches for c in counters]
    raised = []
    for kname, kern in kerns.items():
        try:
            kern(*bad, fc)
        except ValueError:
            raised.append(kname)
    torch.cuda.synchronize()
    launched = [c.launches - n0 for c, n0 in zip(counters, before)]
    print(f"flash_bwd misaligned bf16 dO view: ValueError from {raised}, "
          f"launches {launched}")
    if len(raised) != len(kerns) or any(launched):
        fail(f"misaligned bf16 dO: raised {raised}, launches {launched}")

    # timing at the main path's shape, bf16 causal
    args = _bwd_inputs(torch, A, rng, dev, (b, s, n, n, h), torch.bfloat16,
                       fc, False)
    q, k, v, do = args[:4]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()

    def library():                     # dq, dk and dv together
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    pairs = b * n * (s * (s + 1) // 2)                 # causal (q, key) pairs
    in_bytes = 4 * b * s * n * h * 2 + 2 * b * n * s * 4  # q,k,v,dO; lse,delta
    out_bytes = {"flash_bwd_dkdv": 2 * b * s * n * h * 2,
                 "flash_bwd_dq": b * s * n * h * 2}
    flops = {"flash_bwd_dkdv": 4 * 2 * h * pairs,  # QK^T dO.V^T P^T.dO dS^T.Q
             "flash_bwd_dq": 3 * 2 * h * pairs}    # QK^T dO.V^T dS.K
    line = {"flash_bwd_dkdv": "attention.py:188", "flash_bwd_dq":
            "attention.py:249"}
    out_recs = []
    for kname, kern in kerns.items():
        times = timings(torch, lambda: kern(*args, fc),
                        lambda: plains[kname](*args, fc), library)
        t, by = bound(in_bytes + out_bytes[kname], flops[kname], "bfloat16")
        out_recs.append(dict(
            name=kname, route="cuda",
            source="elastic_tpu_agent_torch/csrc/flash_bwd.cu",
            replaces=f"elastic_tpu_agent/workloads/{line[kname]}",
            launches=None, max_abs_err=abs_max[kname], bound_ms=t,
            bound_by=by, shape=f"[{b},{s},{n},{h}] bf16 causal; library_ms "
            "is SDPA's whole backward (dq, dk, dv)", **times,
        ))
    # the whole bf16 backward as the autograd Function runs it: delta, then
    # both kernels
    o = A.flash_attention_plain(q, k, v, fc)[0]

    def whole():
        delta = A.flash_bwd_delta(o, do)
        A.flash_bwd_dkdv(q, k, v, do, args[4], delta, fc)
        A.flash_bwd_dq(q, k, v, do, args[4], delta, fc)

    whole_rec = dict(shape=f"[{b},{s},{n},{h}] bf16 causal",
                     ms=device_ms(torch, whole)[0],
                     delta_ms=device_ms(
                         torch, lambda: A.flash_bwd_delta(o, do))[0],
                     sdpa_backward_ms=out_recs[0]["library_ms"])
    return (*out_recs, whole_rec)


def _paged_inputs(torch, rng, dev, dtype, g, r, full, h=64, bs=16, nb=32,
                  shared=0):
    """q, pools, table and lengths for 8 slots. Every row's table is its
    own blocks, except that with ``shared`` the first ``shared`` entries
    of every row name row 0's blocks, as a prefix-cache hit maps them."""
    slots = 8                    # serving phase: max_len 512 / bs 16
    n_blocks = slots * nb + 1
    q = randn(torch, rng, (slots, g * r, h), dtype, dev)
    pk, pv = (randn(torch, rng, (n_blocks, bs, g, h), dtype, dev)
              for _ in range(2))
    table = rng.permutation(np.arange(1, n_blocks)).reshape(slots, nb)
    table[1:, :shared] = table[0, :shared]
    lengths = (np.full(slots, nb * bs) if full
               else rng.integers(1, nb * bs + 1, slots))
    if not full:
        lengths[3] = 0           # attends nothing: the mean of V, as JAX
    return (q, pk, pv,
            torch.tensor(table.astype(np.int32), device=dev),
            torch.tensor(lengths.astype(np.int32), device=dev))


def check_paged(torch, PA, dev):
    """Paged decode vs its plain version; returns the kernel's record."""
    rng = np.random.default_rng(SEED + 1)
    err_max = 0.0
    # the last two cases: the prefix cell's tables, whose rows name the
    # same 8 physical blocks (the 128-token system prompt) first
    for dtype in (torch.bfloat16, torch.float32):
        for g, r, window, h, bs, nb, shared in ((8, 1, 0, 64, 16, 32, 0),
                                                (2, 4, 0, 64, 16, 32, 0),
                                                (2, 4, 100, 64, 16, 32, 0),
                                                (1, 16, 0, 128, 64, 8, 0),
                                                (8, 1, 0, 64, 16, 32, 8),
                                                (2, 4, 100, 64, 16, 32, 8)):
            q, pk, pv, table, lengths = _paged_inputs(
                torch, rng, dev, dtype, g, r, False, h, bs, nb, shared
            )
            got = PA.paged_decode_attention(
                q, pk, pv, table, lengths, g, window=window)
            want = PA.paged_decode_attention_reference(
                q, pk, pv, table, lengths, g, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = str(dtype).split(".")[-1]
            label = (f"paged_decode {name} g{g} r{r} h{h} bs{bs} window "
                     f"{window} shared {shared} splits "
                     f"{PA.paged_splits(8, g, nb)}")
            print(f"{label}: max err {err:.3g}")
            if not err <= PAGED_TOL[name]:
                fail(f"{label}: {err}")
            err_max = max(err_max, err)
    # timing: 8 slots x 512 positions x 8 kv heads x 64, bf16
    q, pk, pv, table, lengths = _paged_inputs(
        torch, rng, dev, torch.bfloat16, 8, 1, full=True
    )
    times = timings(
        torch, lambda: PA.paged_decode_attention(q, pk, pv, table, lengths, 8),
        lambda: PA.paged_decode_attention_reference(
            q, pk, pv, table, lengths, 8))
    tr = PA.kernel_traffic(8, 32, 16, 8, 64, 2, n_heads=8,
                           lengths=lengths.tolist())  # the H100's grid
    # the bound counts what the function must move: K/V rows, q, out and
    # the table once; the partials (tr["partial_bytes"]) are the kernel's
    t, by = bound(tr["bytes"], tr["flops"], "bfloat16")
    # the same shape with every row's first 8 entries naming row 0's
    # blocks (a prefix-cache hit on the 128-token system prompt)
    q, pk, pv, table, lengths = _paged_inputs(
        torch, rng, dev, torch.bfloat16, 8, 1, full=True, shared=8
    )
    shared_ms = device_ms(torch, lambda: PA.paged_decode_attention(
        q, pk, pv, table, lengths, 8))[0]
    print(f"paged_decode shared table (8 rows x 8 shared blocks): device ms "
          f"{shared_ms:.4g}")
    return dict(
        name="paged_decode", route="cuda",
        source="elastic_tpu_agent_torch/csrc/paged_decode.cu",
        replaces="elastic_tpu_agent/workloads/paged_attention.py:38",
        launches=None, max_abs_err=err_max, bound_ms=t, bound_by=by,
        shape=f"8 slots x 512 positions, g 8, r 1, h 64, bs 16, bf16; grid "
        f"{tr['grid']}, kernel bytes {tr['kernel_bytes']}",
        shared_table_ms=shared_ms, **times,
    )


def run_forward(torch, W, A, cfg, params, dev):
    """The flagship forward through the flash kernel: launches counted
    over exactly one main-path call, logits against attn='reference'."""
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 256)),
                          device=dev)
    A.FLASH_FWD.launches = 0
    logits = W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    launches = A.FLASH_FWD.launches
    if launches != cfg.n_layers:
        fail(f"forward launched flash_fwd {launches}x, want {cfg.n_layers}")
    ref = W.forward(params, tokens, dataclasses.replace(cfg, attn="reference"),
                    device=dev)
    if tuple(logits.shape) != (8, 256, cfg.vocab):
        fail(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        fail("non-finite logits")
    if logits.requires_grad:
        fail("the serving forward recorded an autograd graph")
    err = (logits.float() - ref.float()).abs().max().item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"forward small preset [8,256] bf16: flash_fwd launches {launches}, "
          f"max|logits - reference| {err:.3g}, argmax agreement {agree:.4f}")
    if not err <= FORWARD_BF16_TOL:
        fail(f"forward logits vs reference: {err}")
    for _ in range(3):
        W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / reps * 1e3
    ref_cfg = dataclasses.replace(cfg, attn="reference")
    ref_ms = cuda_ms(lambda: W.forward(params, tokens, ref_cfg, device=dev),
                     2, 10)
    return launches, dict(
        batch=8, seq=256, ms=fwd_ms, reference_attention_ms=ref_ms,
        max_abs_err_vs_reference=err, argmax_agreement=agree,
        flash_launches=launches,
    )


def forward_f32_check(torch, W, cfg32, params32, dev):
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.tensor(rng.integers(0, cfg32.vocab, size=(4, 200)),
                          device=dev)
    got = W.forward(params32, tokens, cfg32, device=dev)
    ref = W.forward(params32, tokens,
                    dataclasses.replace(cfg32, attn="reference"), device=dev)
    err = (got - ref).abs().max().item()
    print(f"forward f32 2-layer [4,200]: max|logits - reference| {err:.3g}")
    if not err <= FORWARD_F32_TOL:
        fail(f"f32 forward vs reference: {err}")
    return err


def serve(W, eng, prompts, kinds, new_tokens, step_times=None, ttft=None):
    """Run ``prompts`` through ``eng`` (kinds[i] = (admit?, request
    kwargs)), releasing each request at ``new_tokens`` tokens; returns
    the streams in request order. ``ttft`` (a dict) gets each request's
    host seconds from its admission call to its first token."""
    queue = list(range(len(prompts)))
    rid_of, streams, t_admit = {}, {}, {}
    while queue or rid_of:
        st = eng.stats()
        free = st["slots"] - st["live_requests"] - st["pending_prefills"]
        while queue and free > 0:
            i = queue.pop(0)
            use_admit, kw = kinds[i]
            fn = eng.admit if use_admit else eng.enqueue
            t_admit[i] = time.perf_counter()
            rid = fn(prompts[i], **kw)
            rid_of[rid] = i
            if ttft is not None and eng.stream(rid):
                ttft[i] = time.perf_counter() - t_admit[i]
            free -= 1
        t0 = time.perf_counter()
        out = eng.step()
        if step_times is not None:
            step_times.append(time.perf_counter() - t0)
        if ttft is not None:
            for rid in out:
                if rid_of.get(rid) is not None and rid_of[rid] not in ttft:
                    ttft[rid_of[rid]] = time.perf_counter() - t_admit[
                        rid_of[rid]]
        for rid, i in list(rid_of.items()):
            if rid in eng.finish_reason or len(eng.stream(rid)) >= new_tokens:
                streams[i] = eng.release(rid)
                del rid_of[rid]
    return [streams[i] for i in range(len(prompts))]


def _serving_requests(cfg, seed):
    """16 prompts of 16-200 tokens and their kinds (admit or enqueue,
    greedy or sampled), as phase 4 draws them."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(16, 201, size=16)]
    kinds = [(i % 4 < 2, {} if i % 2 == 0 else dict(temperature=0.8,
                                                     top_k=50))
             for i in range(16)]
    return prompts, kinds


def run_serving(torch, W, PA, cfg, params, tree, dev):
    n_req, new_tokens = 16, 64
    prompts, kinds = _serving_requests(cfg, SEED + 4)
    from elastic_tpu_agent_torch.workloads import serving as SV

    # the auto default resolves through the traffic model's rule: record
    # its calls while the engine is built
    rule, asked = SV.recommend_paged_kernel, []
    SV.recommend_paged_kernel = lambda *a, **kw: asked.append(
        (kw, rule(*a, **kw))) or asked[-1][1]
    try:
        eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                              prompt_buckets=(16, 64, 256), device=dev)
    finally:
        SV.recommend_paged_kernel = rule
    if not eng.paged_kernel:
        fail("paged_kernel auto did not resolve ON on the card")
    step_times = []
    PA.PAGED_DECODE.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = serve(W, eng, prompts, kinds, new_tokens, step_times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.PAGED_DECODE.launches
    steps = eng.decode_steps_total
    if launches != cfg.n_layers * steps or steps == 0:
        fail(f"paged_decode launched {launches}x over {steps} decode steps")
    for i, s in enumerate(streams):
        if len(s) != new_tokens or not all(0 <= t < cfg.vocab for t in s):
            fail(f"request {i}: stream of {len(s)} tokens {s[:4]}...")
    if eng.used_blocks != 0:
        fail(f"{eng.used_blocks} pool blocks leaked")
    tokens = n_req * new_tokens
    st_ms = np.asarray(step_times) * 1e3
    print(f"serving small preset: {n_req} requests x {new_tokens} tokens, "
          f"{steps} decode steps, paged_decode launches {launches}, "
          f"{tokens / wall:.1f} tokens/s, step p50 {np.median(st_ms):.2f} ms")

    # float32 two-layer copy: kernel path vs gather path vs generate()
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    tree32 = dict(tree, layers=tree["layers"][:2])
    params32 = W.params_from_jax(tree32, cfg32, device=dev)
    f32_err = forward_f32_check(torch, W, cfg32, params32, dev)
    few = [p[:40] for p in prompts[:8]]
    greedy = [(i % 2 == 0, {}) for i in range(8)]
    runs = {}
    for paged in (True, False):
        e = W.ServingEngine(params32, cfg32, slots=8, max_len=512,
                            prompt_buckets=(16, 64, 256), paged_kernel=paged,
                            device=dev)
        runs[paged] = serve(W, e, few, greedy, 32)
    oracle = [W.generate(params32, [p], cfg32, 32, device=dev)[0, len(p):]
              .tolist() for p in few]
    same = runs[True] == runs[False] == oracle
    print("serving f32 2-layer: kernel path == gather path == generate(): "
          f"{same}")
    if not same:
        fail("f32 kernel-path streams differ from gather path / generate()")
    return launches, dict(
        requests=n_req, new_tokens=new_tokens, decode_steps=steps,
        wall_s=wall, tokens_per_s=tokens / wall,
        step_ms_mean=float(st_ms.mean()), step_ms_p50=float(np.median(st_ms)),
        paged_launches=launches, f32_forward_err=f32_err,
        f32_streams_equal=same, paged_kernel=eng.paged_kernel,
        paged_rule_calls=[dict(kw, resolved=got) for kw, got in asked],
        block_size=eng.block_size, streams=streams,
    )


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _train(torch, W, cfg, tree, dev, tokens, steps):
    """``steps`` train steps from the bridged f32 params; returns the
    losses, the host-clock step times (each ends in the loss's copy to
    the host), a closure that runs one more step and the params it
    trains."""
    params = W.params_from_jax(tree, cfg, device=dev, dtype=torch.float32)
    step, _, opt = W.make_train_step(cfg, learning_rate=1e-3, device=dev)
    state = opt.init(params)
    losses, times = [], []

    def one():
        loss = step(params, state, tokens)[2].item()
        losses.append(loss)
        return loss

    for _ in range(steps):
        t0 = time.perf_counter()
        one()
        times.append(time.perf_counter() - t0)
    return losses, times, one, params


def run_train(torch, W, A, cfg, tree, dev):
    """The train step through the flash kernels: launches counted over
    exactly the TRAIN_STEPS main-path steps, losses against the same run on
    reference attention, f32 gradients against the reference path's."""
    rng = np.random.default_rng(SEED + 7)
    batch, seq = 8, 256
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(batch, seq + 1)),
                          device=dev)
    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    for kern in kerns:
        kern.launches = 0
    losses, times, one, params = _train(torch, W, cfg, tree, dev, tokens,
                                        TRAIN_STEPS)
    trained = dict(tokens=tokens, losses=losses[:TRAIN_STEPS],
                   params=params)
    torch.cuda.synchronize()
    launches = {kern.symbol: kern.launches for kern in kerns}
    want = cfg.n_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        fail(f"train launches {launches}, want {want} each")
    if not all(np.isfinite(losses)):
        fail(f"non-finite train losses {losses}")
    if not losses[-1] < 0.9 * losses[0]:
        fail(f"train loss {losses[0]} -> {losses[-1]}: not falling")
    step_ms = np.asarray(times) * 1e3
    p50 = float(np.median(step_ms))
    busy = _profiled(torch, one, 3)[1] or None   # None: no device time seen
    ref_losses, ref_times, _, _ = _train(
        torch, W, dataclasses.replace(cfg, attn="reference"), tree, dev,
        tokens, TRAIN_STEPS)
    gap = float(np.max(np.abs(np.asarray(losses[:TRAIN_STEPS])
                              - np.asarray(ref_losses))))
    print(f"train small preset [{batch},{seq}] bf16, {TRAIN_STEPS} steps: "
          f"loss {losses[0]:.4f} -> {losses[TRAIN_STEPS - 1]:.4f}, "
          f"launches {launches}, step p50 {p50:.2f} ms, "
          f"{batch * seq / p50 * 1e3:.0f} tokens/s, device busy "
          f"{'not measured' if busy is None else f'{busy:.3f}'}; "
          "reference attention step p50 "
          f"{np.median(ref_times) * 1e3:.2f} ms, max|loss - reference| "
          f"{gap:.4g}")
    print("train losses " + " ".join(f"{x:.4f}" for x in losses[:TRAIN_STEPS]))
    print("reference losses " + " ".join(f"{x:.4f}" for x in ref_losses))
    if not gap <= TRAIN_BF16_TOL:
        fail(f"bf16 train losses vs reference attention: {gap}")

    # float32 two-layer copy: one step's gradients, kernels vs reference
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    tree32 = dict(tree, layers=tree["layers"][:2])
    p32 = W.params_from_jax(tree32, cfg32, device=dev, dtype=torch.float32)
    tok32 = torch.tensor(rng.integers(0, cfg.vocab, size=(4, 201)),
                         device=dev)
    _, g_k = W.loss_and_grads(p32, tok32, cfg32, dev)
    _, g_r = W.loss_and_grads(
        p32, tok32, dataclasses.replace(cfg32, attn="reference"), dev)
    grad_err = max(
        ((a - b).abs().max() / b.abs().max()).item()
        for a, b in zip(_flat(g_k), _flat(g_r)))
    print(f"train f32 2-layer [4,200]: max leaf gradient error vs reference "
          f"{grad_err:.3g} (relative to the leaf's largest)")
    if not grad_err <= TRAIN_GRAD_F32_TOL:
        fail(f"f32 kernel-path gradients vs reference: {grad_err}")
    return launches, dict(
        batch=batch, seq=seq, steps=TRAIN_STEPS, loss_first=losses[0],
        loss_last=losses[TRAIN_STEPS - 1], step_ms_p50=p50,
        step_ms_mean=float(step_ms.mean()),
        tokens_per_s=batch * seq / p50 * 1e3, device_busy_share=busy,
        reference_step_ms_p50=float(np.median(ref_times) * 1e3),
        max_abs_loss_gap_vs_reference=gap, f32_grad_rel_err=grad_err,
        launches=launches,
    ), trained


def _zipf_tokens(rng, vocab: int, n: int, a: float = 1.1):
    """n tokens with a Zipf(a) unigram law over a random permutation of
    the vocabulary: text-like frequencies, so that losses fall."""
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return rng.permutation(vocab)[rng.choice(vocab, size=n, p=p / p.sum())]


# env the runner reads; the runtime phase sets it per run and restores it
RUNTIME_ENV = ("TPU", "GPU", "ELASTIC_TPU_ALLOC_DIR", "TPU_WORKER_HOSTNAMES",
               "ELASTIC_TPU_HBM_FRACTION", "ELASTIC_TPU_ENV_FILE",
               "ELASTIC_TPU_RESTORE_WAIT_S", "ELASTIC_TPU_RESTORE_DIR",
               "ELASTIC_TPU_RESTORE_STEP", "ELASTIC_TPU_FLIGHT_RECORDER",
               "ELASTIC_TPU_TRACE_ID")


# phase 6's train flags: 20 steps, evals at steps 9 and 19
RUNTIME_TRAIN = (f"--steps {RUNTIME_STEPS} --warmup-steps 5 --total-steps "
                 f"{RUNTIME_STEPS} --eval-every 10 --eval-batches "
                 f"{EVAL_BATCHES}")


def _runtime_data(D, path: str) -> str:
    """Phase 6's token file at ``path`` (2^20 Zipf tokens, seed SEED + 9)
    and the runner flags that read it."""
    D.write_token_file(path, _zipf_tokens(
        np.random.default_rng(SEED + 9), SMALL["vocab"], 1 << 20))
    return f"--preset small --batch 8 --seq 256 --data {path}"


def _runner(R, argv: str, dev) -> dict:
    """runner.main(argv) in this process; the report is its printed last
    line, which is echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = R.main(argv.split(), device=dev)
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"runner {argv}: {line}")
    if rc != 0:
        fail(f"runner {argv}: exit {rc}")
    return json.loads(line)


def run_runtime(torch, A, dev, tmp) -> dict:
    """Phase 6: the runner's train and decode modes, resume, and the
    pre-copy drain, in this process on the card (``tmp`` holds the data
    file and checkpoints; each checkpoint directory goes when its checks
    are done)."""
    import shutil

    from elastic_tpu_agent_torch.workloads import checkpointing as C
    from elastic_tpu_agent_torch.workloads import data as D
    from elastic_tpu_agent_torch.workloads import lifecycle as L
    from elastic_tpu_agent_torch.workloads import runner as R
    from elastic_tpu_agent_torch.workloads import telemetry as T

    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    saved = {k: os.environ.pop(k, None) for k in RUNTIME_ENV}
    os.environ["ELASTIC_TPU_ENV_FILE"] = os.path.join(tmp, "no-env-file")
    out = {}
    try:
        data = os.path.join(tmp, "tokens.bin")
        base = _runtime_data(D, data)

        # train: 20 steps, evals at steps 9 and 19, saves at 9 and 19
        a = os.path.join(tmp, "a")
        fr = os.path.join(tmp, "fr.jsonl")
        for kern in kerns:
            kern.launches = 0
        rep = _runner(R, f"{base} {RUNTIME_TRAIN} --checkpoint-dir {a} "
                      f"--checkpoint-every 10 --flight-recorder {fr}", dev)
        torch.cuda.synchronize()
        launches = {k.symbol: k.launches for k in kerns}
        n_layers = SMALL["n_layers"]
        # one forward and backward of the warm-up, then the steps and the
        # two evals
        want = {"flash_fwd": n_layers * (1 + RUNTIME_STEPS + 2 * EVAL_BATCHES),
                "flash_bwd_dkdv": n_layers * (1 + RUNTIME_STEPS),
                "flash_bwd_dq": n_layers * (1 + RUNTIME_STEPS)}
        if launches != want:
            fail(f"runner train launches {launches}, want {want}")
        ev = [e["loss"] for e in rep.get("eval", [])]
        recs = T.load_jsonl(fr)
        steps = [r for r in recs if r["kind"] == "step"]
        saves = [r["duration_ms"] for r in recs
                 if r["kind"] == "checkpoint_save"]
        print(f"runtime train: step_time_ms {rep['step_time_ms']:.2f} with "
              f"checkpoint saves of {saves} ms in the window; step records "
              + ", ".join(f"{r['duration_ms']:.1f}" for r in steps) + " ms")
        if rep["steps"] != RUNTIME_STEPS or rep["platform"] != "gpu":
            fail(f"runner train: {rep['steps']} steps on {rep['platform']}")
        if not np.isfinite(rep["final_loss"] or np.nan):
            fail(f"runner train final loss {rep['final_loss']}")
        if len(ev) != 2 or not ev[1] < ev[0]:
            fail(f"runner eval losses {ev}: not two, falling")
        if len(steps) != RUNTIME_STEPS:
            fail(f"flight recorder: {len(steps)} step records")
        mem = steps[-1].get("device_memory") if steps else None
        out["train"] = dict(
            steps=rep["steps"], step_time_ms=rep["step_time_ms"],
            tokens_per_s=rep["tokens_per_s"], final_loss=rep["final_loss"],
            eval_losses=ev, launches=launches, checkpoint_save_ms=saves,
            flight_mean_step_ms=rep["flight_recorder"].get("mean_step_ms"),
            step_ms=[r["duration_ms"] for r in steps], device_memory=mem,
        )

        # decode from that checkpoint (generate's cached attention: no
        # hand-written kernel on this path)
        for kern in kerns:
            kern.launches = 0
        dec = _runner(R, f"--mode decode --preset small --batch 8 "
                      f"--prompt-len 32 --new-tokens 64 --checkpoint-dir {a}",
                      dev)
        if dec["restored_step"] != RUNTIME_STEPS - 1:
            fail(f"decode restored step {dec['restored_step']}")
        if dec["decode_tokens_per_s"] is None:
            fail("decode_tokens_per_s is null")
        out["decode"] = {k: dec[k] for k in (
            "restored_step", "prefill_ms", "decode_tokens_per_s",
            "ms_per_token", "end_to_end_s", "sample_tail")}
        out["decode"]["launches"] = {k.symbol: k.launches for k in kerns}
        shutil.rmtree(a)

        # resume: 10 steps, then the same command resumes at step 10
        b = os.path.join(tmp, "b")
        cmd = (f"{base} --steps 10 --warmup-steps 5 --total-steps "
               f"{RUNTIME_STEPS} --checkpoint-dir {b} --checkpoint-every 10")
        first = _runner(R, cmd, dev)
        second = _runner(R, cmd, dev)
        gap = abs(second["final_loss"] - rep["final_loss"])
        print(f"runtime resume: start_step {first['start_step']} then "
              f"{second['start_step']}, final loss {second['final_loss']:.6f}"
              f" vs uninterrupted {rep['final_loss']:.6f}: gap {gap:.3g} "
              f"(limit {RESUME_TOL})")
        if (first["start_step"], second["start_step"]) != (0, 10):
            fail(f"resume start steps {first['start_step']}, "
                 f"{second['start_step']}")
        if not gap <= RESUME_TOL:
            fail(f"resumed final loss off the uninterrupted run by {gap}")
        out["resume"] = dict(start_step=second["start_step"],
                             final_loss=second["final_loss"], gap=gap,
                             step_time_ms=second["step_time_ms"])
        shutil.rmtree(b)

        # pre-copy drain: the spec carries the drain stamp from the start
        alloc, h = os.path.join(tmp, "alloc"), "chipsmoke0"
        os.makedirs(alloc)
        with open(os.path.join(alloc, f"{h}.json"), "w") as f:
            json.dump({"env": {"ELASTIC_TPU_DRAIN": "maintenance:smoke",
                               "ELASTIC_TPU_DRAIN_DEADLINE":
                               str(time.time() + 3600)}}, f)
        os.environ.update(TPU=h, ELASTIC_TPU_ALLOC_DIR=alloc,
                          ELASTIC_TPU_RESTORE_WAIT_S="0")
        c = os.path.join(tmp, "c")
        fr_c = os.path.join(tmp, "fr_c.jsonl")
        pre = _runner(R, f"{base} --steps 10 --precopy-every 5 "
                      f"--checkpoint-every 0 --checkpoint-dir {c} "
                      f"--flight-recorder {fr_c}", dev)
        ack = L.read_checkpoint_ack(alloc, h) or {}
        chain = C.DeltaCheckpointer(c).verify()
        rounds = [r for r in T.load_jsonl(fr_c)
                  if r["kind"] in ("precopy_round", "cutover")]
        print("runtime pre-copy: " + "; ".join(
            f"{r['kind']} {r['round']} at step {r['step']}: "
            f"{r['delta_bytes']} of {r['total_bytes']} bytes in "
            f"{r['duration_ms']:.1f} ms (copy to the host "
            f"{r['copy_ms']:.1f})" for r in rounds)
            + f"; ack cutover_ms {ack.get('cutover_ms')}; step_time_ms "
            f"{pre['step_time_ms']:.2f}")
        if pre["precopy_rounds"] < 1 or ack.get("precopy_rounds") is None:
            fail(f"pre-copy rounds {pre['precopy_rounds']}, ack {ack}")
        if not (chain["ok"] and ack.get("digest") == chain["chain"]
                and ack.get("kind") == "checkpoint"):
            fail(f"pre-copy ack {ack} vs verified chain {chain}")
        for k in ("TPU", "ELASTIC_TPU_ALLOC_DIR"):
            os.environ.pop(k)
        back = _runner(R, f"{base} --steps 1 --checkpoint-every 0 "
                       f"--checkpoint-dir {c}", dev)
        if back["start_step"] != 10:
            fail(f"resume from the delta chain at {back['start_step']}")
        out["precopy"] = dict(
            rounds=pre["precopy_rounds"], payload_bytes=chain["total_bytes"],
            round_log=rounds, cutover_ms=ack.get("cutover_ms"),
            final_delta_bytes=ack.get("delta_bytes"),
            resumed_start_step=back["start_step"],
            step_time_ms=pre["step_time_ms"],
        )
        shutil.rmtree(c)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def moe_onehot(torch, x, params, factor):
    """The JAX MoE layer's one-hot einsum form
    (elastic_tpu_agent/workloads/moe.py:160-207) in torch: the plain
    version ``moe_mlp`` is held against. Returns (y, aux, expert, kept)."""
    F = torch.nn.functional
    b, s, d = x.shape
    n_exp = params["wg"].shape[1]
    dtype = x.dtype
    xt = x.reshape(b * s, d)
    cap = max(1, math.ceil(b * s * factor / n_exp))
    probs = torch.softmax(xt.float() @ params["wg"].float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)
    mask = F.one_hot(expert, n_exp).float()
    aux = n_exp * torch.sum(mask.mean(0) * probs.mean(0))
    imask = mask.to(torch.int32)
    position = torch.cumsum(imask, dim=0) * imask
    imask = imask * (position <= cap)
    mask = imask.float()
    gate = torch.sum(probs * mask, dim=-1)
    slot = torch.sum((position - 1) * imask, dim=-1)
    dispatch = mask[:, :, None] * F.one_hot(slot, cap).float()[:, None, :]
    combine = (dispatch * gate[:, None, None]).to(dtype)
    dispatch = dispatch.to(dtype)
    xin = torch.einsum("tec,td->ecd", dispatch, xt)
    h = F.gelu(torch.einsum("ecd,edf->ecf", xin, params["w1"].to(dtype)),
               approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, params["w2"].to(dtype))
    y = torch.einsum("tec,ecd->td", combine, out)
    return y.reshape(b, s, d), aux, expert, imask.sum(-1) > 0


def check_moe_layer(torch, M, layer, dev):
    """moe_mlp against its one-hot einsum form at the MoE cell's layer
    shape (8 x 256 tokens, d 512, ff 2048, 4 experts), on the bridged
    weights of the preset's first MoE layer: float32 outputs, aux loss,
    routes and gradients of sum(y * r) + aux, at the cell's factor 1.25
    and at 1.0, where some expert must overflow (so that drops are
    checked); bf16 outputs at 1.25."""
    rng = np.random.default_rng(SEED + 10)
    d = layer["wg"].shape[0]
    out = {}
    for name, factor in (("float32", 1.25), ("float32", 1.0),
                         ("bfloat16", 1.25)):
        dtype = getattr(torch, name)
        x = randn(torch, rng, (8, 256, d), dtype, dev)
        r = randn(torch, rng, (8, 256, d), dtype, dev)
        params = {k: v.detach().float().clone() for k, v in layer.items()}
        leaves = [x] + [params[k] for k in ("wg", "w1", "w2")]
        for t in leaves:
            t.requires_grad_(name == "float32")
        with torch.enable_grad():
            y, aux = M.moe_mlp(x, params, factor)
            y_ref, aux_ref, expert_ref, kept_ref = moe_onehot(
                torch, x, params, factor)
            _, expert, _, kept, _ = M.route(
                x.detach().reshape(-1, d), params["wg"], factor)
            errs = {
                "y": ((y.float() - y_ref.float()).abs().max()
                      / y_ref.float().abs().max()).item(),
                "aux": abs(aux.item() - aux_ref.item()) / aux_ref.item(),
            }
            if name == "float32":
                g = torch.autograd.grad((y * r).sum() + aux, leaves)
                g_ref = torch.autograd.grad(
                    (y_ref * r).sum() + aux_ref, leaves)
                for k, a, b in zip(("dx", "dwg", "dw1", "dw2"), g, g_ref):
                    errs[k] = ((a - b).abs().max() / b.abs().max()).item()
        routes = int((expert != expert_ref).sum().item()
                     + (kept != kept_ref).sum().item())
        dropped = int((~kept_ref).sum().item())
        label = f"moe layer {name} factor {factor}"
        print(f"{label} [8,256,{d}] E{MOE_EXPERTS} vs one-hot einsum form: "
              "relative max err "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; routes differing {routes}; dropped {dropped} of 2048")
        if routes or max(errs.values()) > MOE_LAYER_TOL[name]:
            fail(f"{label}: errors {errs}, routes differing {routes}")
        if factor == 1.0 and not dropped:
            fail(f"{label}: no token dropped, the capacity went unchecked")
        out[f"{name} factor {factor}"] = dict(
            errors=errs, routes_differing=routes, dropped=dropped)
    return out


class RouteLog:
    """While active, records each ``moe.route`` call's inputs and
    decisions (read-only instrumentation: the call's results are
    returned unchanged)."""

    def __init__(self, M):
        self.M = M
        self.calls = []

    def __enter__(self):
        self.real = real = self.M.route

        def logged(xt, wg, factor, **mesh):
            res = real(xt, wg, factor, **mesh)
            self.calls.append(dict(xt=xt.detach(), wg=wg.detach(),
                                   factor=factor, expert=res[1], kept=res[3]))
            return res

        self.M.route = logged
        return self

    def __exit__(self, *exc):
        self.M.route = self.real


def routes_differing(a: "RouteLog", b: "RouteLog") -> int:
    return sum(int((x["expert"] != y["expert"]).sum().item())
               for x, y in zip(a.calls, b.calls))


def routing_stats(M, log: "RouteLog", aux=None) -> dict:
    st = M.MoeRoutingStats()
    for c in log.calls:
        st.observe(c["xt"], {"wg": c["wg"]}, c["factor"])
    out = st.stats()
    out["aux_loss"] = aux
    return out


def _moe_batch(torch, cfg, dev):
    """(the generator after the draw, phase 7's train tokens [8, 257])."""
    rng = np.random.default_rng(SEED + 12)
    return rng, torch.tensor(rng.integers(0, cfg.vocab, size=(8, 257)),
                             device=dev)


def run_moe(torch, W, A, PA, M, tree, dev):
    """The MoE cell: the layer against its one-hot form, the forward, 20
    train steps, 16 requests on the kernel-path engine and a float32
    two-layer copy. Each path's kernel counts are set to 0 just before it
    and read just after."""
    cfg = W.ModelConfig(**SMALL, max_seq=1024, dtype=torch.bfloat16,
                        moe_experts=MOE_EXPERTS)
    n_params = sum(int(np.prod(x.shape)) for x in _flat(tree))
    params = W.params_from_jax(tree, cfg, device=dev)
    moe_layers = [i for i in range(cfg.n_layers) if cfg.is_moe_layer(i)]
    out = dict(params=n_params, moe_layers=moe_layers,
               layer=check_moe_layer(torch, M, params["layers"][
                   moe_layers[0]]["moe"], dev))
    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)

    # forward [8, 256] through the flash kernel vs reference attention
    rng = np.random.default_rng(SEED + 11)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 256)),
                          device=dev)
    A.FLASH_FWD.launches = 0
    with RouteLog(M) as got_log:
        logits, aux = W.forward_with_aux(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    fwd_launches = A.FLASH_FWD.launches
    ref_cfg = dataclasses.replace(cfg, attn="reference")
    with RouteLog(M) as ref_log:
        ref = W.forward(params, tokens, ref_cfg, device=dev)
    d = (logits.float() - ref.float()).abs()
    flips = routes_differing(got_log, ref_log)
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    for _ in range(3):
        W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"moe forward small preset E{MOE_EXPERTS} [8,256] bf16 "
          f"({n_params} params): flash_fwd launches {fwd_launches}, "
          f"{fwd_ms:.2f} ms, aux {aux.item():.4f}; vs reference attention: "
          f"max|logits diff| {d.max().item():.3g}, mean {d.mean().item():.3g}"
          f", argmax agreement {agree:.4f}, routes differing {flips} of "
          f"{len(moe_layers) * 2048}")
    if fwd_launches != cfg.n_layers:
        fail(f"moe forward launched flash_fwd {fwd_launches}x")
    if tuple(logits.shape) != (8, 256, cfg.vocab) or not torch.isfinite(
            logits).all():
        fail(f"moe forward logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    if not d.mean().item() <= MOE_FORWARD_BF16_MEAN_TOL:
        fail(f"moe forward logits vs reference: mean {d.mean().item()}")
    out["forward"] = dict(ms=fwd_ms, flash_launches=fwd_launches,
                          aux=aux.item(), max_abs_err=d.max().item(),
                          mean_abs_err=d.mean().item(), argmax_agreement=agree,
                          routes_differing=flips)

    # 20 train steps at [8, 256]
    rng, batch = _moe_batch(torch, cfg, dev)
    for kern in kerns:
        kern.launches = 0
    losses, times, _, _ = _train(torch, W, cfg, tree, dev, batch,
                                 TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kerns}
    want = cfg.n_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        fail(f"moe train launches {launches}, want {want} each")
    if not all(np.isfinite(losses)) or not losses[-1] < 0.9 * losses[0]:
        fail(f"moe train losses {losses[0]} -> {losses[-1]}")
    ref_losses, ref_times, _, _ = _train(torch, W, ref_cfg, tree, dev, batch,
                                      TRAIN_STEPS)
    gaps = np.abs(np.asarray(losses) - np.asarray(ref_losses))
    gap = float(gaps.max())
    p50 = float(np.median(times) * 1e3)
    p32 = W.params_from_jax(tree, cfg, device=dev, dtype=torch.float32)
    with torch.no_grad(), RouteLog(M) as log0:
        aux0 = W.forward_with_aux(p32, batch[:, :-1], cfg, dev)[1].item()
    stats0 = routing_stats(M, log0, aux0)
    print(f"moe train small preset [8,256] bf16, {TRAIN_STEPS} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches}, step "
          f"p50 {p50:.2f} ms ({8 * 256 / p50 * 1e3:.0f} tokens/s); reference"
          f" attention step p50 {np.median(ref_times) * 1e3:.2f} ms, "
          f"max|loss - reference| {gap:.4g} (steps 0-9 "
          f"{gaps[:10].max():.4g}, mean {gaps.mean():.4g}); at step 0: aux "
          f"{aux0:.4f}, "
          f"drop rate {stats0['drop_rate']}, imbalance "
          f"{stats0['imbalance']}, expert load {stats0['expert_load']}")
    print("moe train losses " + " ".join(f"{x:.4f}" for x in losses))
    print("moe reference losses " + " ".join(f"{x:.4f}" for x in ref_losses))
    if not gap <= MOE_TRAIN_BF16_TOL:
        fail(f"moe bf16 train losses vs reference attention: {gap}")
    out["train"] = dict(steps=TRAIN_STEPS, losses=losses,
                        loss_first=losses[0],
                        loss_last=losses[-1], step_ms_p50=p50,
                        tokens_per_s=8 * 256 / p50 * 1e3,
                        reference_step_ms_p50=float(
                            np.median(ref_times) * 1e3),
                        max_abs_loss_gap_vs_reference=gap,
                        mean_abs_loss_gap=float(gaps.mean()),
                        max_abs_loss_gap_first10=float(gaps[:10].max()),
                        launches=launches,
                        routing_step0=stats0)
    del p32

    # 16 requests on the kernel-path engine
    n_req, new_tokens = 16, 64
    prompts, kinds = _serving_requests(cfg, SEED + 4)
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), device=dev)
    PA.PAGED_DECODE.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = serve(W, eng, prompts, kinds, new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paged = PA.PAGED_DECODE.launches
    steps = eng.decode_steps_total
    if paged == 0 or paged != cfg.n_layers * steps:
        fail(f"moe serving: paged_decode launched {paged}x over {steps} "
             "decode steps")
    if any(len(x) != new_tokens for x in streams) or eng.used_blocks:
        fail("moe serving streams or pool blocks")
    print(f"moe serving small preset: {n_req} requests x {new_tokens} "
          f"tokens, {steps} decode steps, paged_decode launches {paged}, "
          f"{n_req * new_tokens / wall:.1f} tokens/s")
    out["serving"] = dict(requests=n_req, new_tokens=new_tokens,
                          decode_steps=steps, paged_launches=paged,
                          tokens_per_s=n_req * new_tokens / wall)
    out["launches"] = dict(launches, flash_fwd_forward=fwd_launches,
                           paged_decode=paged)
    del eng, params

    # float32 two-layer copy (layer 1 is MoE): streams and gradients. The
    # engine's prefill routes a bucket-padded row, or a block-sized chunk,
    # with the training factor, as the JAX engine does, so where a prompt
    # drops tokens there its stream may leave generate()'s (whose prefill
    # routes the bare prompt): at factor 1.25 the two engine paths must
    # agree, and generate() must agree with both at the drop-free factor E
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    tree32 = dict(tree, layers=tree["layers"][:2])
    params32 = W.params_from_jax(tree32, cfg32, device=dev)
    few = [p[:40] for p in prompts[:8]]
    greedy = [(i % 2 == 0, {}) for i in range(8)]
    same, agree_125 = True, None
    for factor in (cfg.moe_capacity_factor, float(MOE_EXPERTS)):
        c = dataclasses.replace(cfg32, moe_capacity_factor=factor)
        runs = {}
        for paged_path in (True, False):
            e = W.ServingEngine(params32, c, slots=8, max_len=512,
                                prompt_buckets=(16, 64, 256),
                                paged_kernel=paged_path, device=dev)
            runs[paged_path] = serve(W, e, few, greedy, 32)
        oracle = [W.generate(params32, [p], c, 32, device=dev)[0, len(p):]
                  .tolist() for p in few]
        if factor == cfg.moe_capacity_factor:
            same &= runs[True] == runs[False]
            agree_125 = sum(a == b for a, b in zip(runs[False], oracle))
        else:
            same &= runs[True] == runs[False] == oracle
    tok32 = torch.tensor(rng.integers(0, cfg.vocab, size=(4, 201)),
                         device=dev)
    with RouteLog(M) as k_log:
        _, g_k = W.loss_and_grads(params32, tok32, cfg32, dev)
    with RouteLog(M) as r_log:
        _, g_r = W.loss_and_grads(
            params32, tok32, dataclasses.replace(cfg32, attn="reference"),
            dev)
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(_flat(g_k), _flat(g_r)))
    flips32 = routes_differing(k_log, r_log)
    print(f"moe f32 2-layer: kernel path == gather path (factor 1.25, and "
          f"== generate() at the drop-free factor {MOE_EXPERTS}): {same} "
          f"({agree_125} of 8 streams equal generate()'s at 1.25); "
          "gradients [4,200] max leaf error vs reference "
          f"{grad_err:.3g} (relative to the leaf's largest), routes "
          f"differing {flips32} of 800")
    if not same:
        fail("moe f32 kernel-path streams differ from gather path / "
             "generate()")
    if not grad_err <= MOE_GRAD_F32_TOL:
        fail(f"moe f32 kernel-path gradients vs reference: {grad_err}")
    out["f32"] = dict(streams_equal=same, grad_rel_err=grad_err,
                      routes_differing=flips32,
                      generate_agreement_at_factor_1_25=agree_125)
    return out


def _bytes_of(Q, tree) -> dict:
    """{path: bytes} over an int8 tree's arrays, copied to the host."""
    out = {}

    def add(path, leaf):
        for k, t in (leaf.items() if Q.is_quantized(leaf) else [("", leaf)]):
            out[(*path, k)] = t.cpu().numpy().tobytes()

    Q._tree_map(add, tree)
    return out


def run_int8(torch, W, PA, Q, R, cfg, tree, params, dev):
    """int8 at the dense preset: the quantized tree on the card against
    the CPU's, generate on int8 weights, a kv_int8 engine, runner --int8."""
    p32 = W.params_from_jax(tree, cfg, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = Q.quantize_params(p32)
    torch.cuda.synchronize()
    q_ms = (time.perf_counter() - t0) * 1e3
    del p32
    q_cpu = Q.quantize_params(
        W.params_from_jax(tree, cfg, device="cpu", dtype=torch.float32))
    got, want = _bytes_of(Q, q), _bytes_of(Q, q_cpu)
    differ = sorted(k for k in want if got.get(k) != want[k])
    same = got.keys() == want.keys() and not differ
    nbytes = Q.quantized_bytes(q)
    print(f"int8 quantize_params on the card: {q_ms:.1f} ms, byte-equal to "
          f"the CPU's: {same} ({len(want)} arrays, differing {differ[:6]}); "
          f"{nbytes} bytes stored vs {Q.quantized_bytes(params)} in bf16")
    if not same:
        fail(f"int8 tree on the card differs from the CPU's: {differ}")
    del q_cpu

    rng = np.random.default_rng(SEED + 13)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 32)),
                          device=dev)
    rates, toks = {}, {}
    for name, p in (("int8", q), ("bf16", params)):
        W.generate(p, prompt, cfg, 64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks[name] = W.generate(p, prompt, cfg, 64, device=dev)[:, 32:]
        torch.cuda.synchronize()
        rates[name] = 8 * 64 / (time.perf_counter() - t0)
    agree = (toks["int8"] == toks["bf16"]).float().mean().item()
    print(f"int8 generate [8, 32 + 64] greedy: {rates['int8']:.1f} tokens/s "
          f"(bf16 weights {rates['bf16']:.1f}); greedy tokens agreeing with "
          f"the bf16 stream {agree:.4f}")
    if not bool(((toks["int8"] >= 0) & (toks["int8"] < cfg.vocab)).all()):
        fail("int8 generate tokens out of range")
    del q

    prompts, kinds = _serving_requests(cfg, SEED + 4)
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), kv_int8=True,
                          device=dev)
    PA.PAGED_DECODE.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = serve(W, eng, prompts, kinds, 64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paged = PA.PAGED_DECODE.launches
    print(f"kv_int8 serving small preset: 16 requests x 64 tokens, "
          f"paged_kernel {eng.paged_kernel}, paged_decode launches {paged}, "
          f"{16 * 64 / wall:.1f} tokens/s")
    if paged or eng.paged_kernel or not eng.stats()["kv_int8"]:
        fail(f"kv_int8 engine: paged_kernel {eng.paged_kernel}, launches "
             f"{paged}")
    if any(len(x) != 64 for x in streams) or eng.used_blocks:
        fail("kv_int8 serving streams or pool blocks")
    del eng

    saved = {k: os.environ.pop(k, None) for k in RUNTIME_ENV}
    os.environ["ELASTIC_TPU_ENV_FILE"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "no-env-file")
    try:
        rep = _runner(R, "--mode decode --preset small --batch 8 "
                      "--prompt-len 32 --new-tokens 64 --int8", dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rep.get("int8") is not True or rep.get("decode_tokens_per_s") is None:
        fail(f"runner --int8 report {rep}")
    return dict(quantize_ms=q_ms, byte_equal=same, stored_bytes=nbytes,
                generate_tokens_per_s=rates, greedy_agreement=agree,
                kv_int8_tokens_per_s=16 * 64 / wall,
                kv_int8_paged_launches=paged,
                runner={k: rep.get(k) for k in (
                    "int8", "prefill_ms", "decode_tokens_per_s",
                    "ms_per_token", "sample_tail")})


def run_drain(torch, W, L, T, cfg, params, dev, tmp):
    """The engine's recorder and lifecycle: 16 admitted requests on the
    kernel-path engine with a FlightRecorder and a LifecycleWatcher over
    an alloc spec; then a drain stamped into the spec."""
    alloc, h = os.path.join(tmp, "alloc_serving"), "chipsmokesrv"
    os.makedirs(alloc)
    spec = os.path.join(alloc, f"{h}.json")
    with open(spec, "w") as f:
        json.dump({"env": {}}, f)
    watcher = L.LifecycleWatcher(alloc, h, poll_interval_s=0.0)
    rec = T.FlightRecorder(path="", trace_id="")
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), recorder=rec,
                          lifecycle=watcher, device=dev)
    prompts, kinds = _serving_requests(cfg, SEED + 14)
    kinds = [(True, kw) for _, kw in kinds]       # every request admitted
    step_times = []
    serve(W, eng, prompts, kinds, 32, step_times)
    kinds_ = [r["kind"] for r in rec.records]
    admits = kinds_.count("serving_admit")
    steps = kinds_.count("serving_step")
    print(f"recorder: {admits} serving_admit records for 16 admissions, "
          f"{steps} serving_step records for {len(step_times)} steps")
    if admits != 16 or steps != len(step_times):
        fail(f"recorder: {admits} admit and {steps} step records")

    live = [eng.admit(p[:50]) for p in prompts[:4]]
    for _ in range(3):
        eng.step()
    with open(spec, "w") as f:
        json.dump({"env": {"ELASTIC_TPU_DRAIN": "maintenance:smoke"}}, f)
    refused = []
    for fn in (eng.admit, eng.enqueue):
        try:
            fn(prompts[5][:20])
        except ValueError:
            refused.append(fn.__name__)
    summary = L.drain_serving(eng, watcher)
    ack = L.read_checkpoint_ack(alloc, h) or {}
    finished = [eng.finish_reason.get(r) for r in live]
    print(f"drain: admission refused by {refused}; drain_serving {summary}; "
          f"finish reasons {finished}; ack kind {ack.get('kind')}")
    if refused != ["admit", "enqueue"]:
        fail(f"drain: refused {refused}")
    if summary["live_requests"] or None in finished or ack.get(
            "kind") != "drained":
        fail(f"drain: summary {summary}, finished {finished}, ack {ack}")
    return dict(admit_records=admits, step_records=steps,
                steps=len(step_times), refused=refused,
                drain_steps=summary["steps"],
                drained_tokens=summary["drained_tokens"],
                ack_kind=ack.get("kind"))


SYSTEM_TOKENS = 128          # the prefix cell's shared system prompt


def _prefix_requests(cfg, seed, n=16):
    """The prefix cell's requests: one 128-token system prompt (8 full
    blocks at block 16) followed by user tails of 8-64 tokens, drawn with
    numpy from ``seed``; half admitted and half enqueued, half greedy and
    half sampled, the SLO classes in turn. Returns (system, prompts,
    kinds, slos)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, size=SYSTEM_TOKENS).tolist()
    prompts = [system + rng.integers(0, cfg.vocab, size=int(t)).tolist()
               for t in rng.integers(8, 65, size=n)]
    kinds = [(i % 4 < 2, {} if i % 2 == 0 else dict(temperature=0.8,
                                                     top_k=50))
             for i in range(n)]
    slos = [("ttft", "tpot", "batch")[i % 3] for i in range(n)]
    return system, prompts, kinds, slos


def _index_of(prompts, tokens) -> int:
    """The request whose prompt the handoff record's tokens start with."""
    tokens = [int(t) for t in tokens]
    return next(i for i, p in enumerate(prompts) if tokens[:len(p)] == p)


def serve_disaggregated(pre, dec, prompts, kinds, slos, new_tokens):
    """The prompts through a prefill-role engine, each handed to the
    decode-role engine by its cache hit as soon as its prefill lands;
    decode runs every tick. One publication is pending at a time: a
    cache-hit admission of either role adopts whichever record was
    published last under its covered chain's last digest, so with two
    pending, requests that share the system prompt would pair wrongly
    (the JAX engine's rule, pinned by tests/test_torch_disagg.py).
    Returns the streams and each decode admission's prefilled tokens."""
    queue = list(range(len(prompts)))
    at_pre, at_dec, streams, tail = {}, {}, {}, {}

    def hand_over():
        for rid, i in list(at_pre.items()):
            if pre.finish_reason.get(rid) == "prefilled":
                pre.release(rid)
                del at_pre[rid]
                before = dec.prefilled_tokens_total
                at_dec[dec.admit(prompts[i], **kinds[i][1])] = i
                tail[i] = dec.prefilled_tokens_total - before

    while queue or at_pre or at_dec:
        while (queue and len(at_pre) < pre.slots
               and len(at_pre) + len(at_dec) < dec.slots):
            i = queue.pop(0)
            fn = pre.admit if kinds[i][0] else pre.enqueue
            at_pre[fn(prompts[i], slo=slos[i])] = i
            hand_over()
        pre.step()
        hand_over()
        dec.step()
        for rid, i in list(at_dec.items()):
            if rid in dec.finish_reason or len(dec.stream(rid)) >= new_tokens:
                streams[i] = dec.release(rid)
                del at_dec[rid]
    return [streams[i] for i in range(len(prompts))], tail


def serve_handed_off(L, src, peer, prompts, kinds, new_tokens, steps,
                     watcher=None):
    """Open the prompts on ``src`` (admit or enqueue), decode ``steps``
    steps, then ``drain_serving(handoff=True)``: every open stream is
    published through the shared pool; ``peer`` adopts each record and
    decodes it to ``new_tokens``. Returns the streams and the drain's
    summary."""
    for i, p in enumerate(prompts):
        (src.admit if kinds[i][0] else src.enqueue)(p, **kinds[i][1])
    for _ in range(steps):
        src.step()
    summary = L.drain_serving(src, watcher, handoff=True)
    pool, rid_of = src.shared_pool, {}
    while True:
        rec = pool.claim_stream()
        if rec is None:
            break
        rid_of[peer.adopt_stream(rec)] = _index_of(prompts, rec["tokens"])
    streams = {}
    while rid_of:
        peer.step()
        for rid, i in list(rid_of.items()):
            if (rid in peer.finish_reason
                    or len(peer.stream(rid)) >= new_tokens):
                streams[i] = peer.release(rid)
                del rid_of[rid]
    return [streams.get(i) for i in range(len(prompts))], summary


def _leak_check(label, used, cached, cache):
    """After every release a pool holds only its prefix cache's blocks,
    and nothing after the cache is cleared."""
    cache.clear()
    print(f"{label}: used_blocks {used} == cached blocks {cached}; after "
          f"clear() {cache._alloc.used}")
    if used != cached or cache._alloc.used != 0:
        fail(f"{label}: used {used}, cached {cached}, after clear "
             f"{cache._alloc.used}")


def run_prefix(torch, W, PA, L, RO, cfg, params, tree, dev, tmp):
    """The prefix cache, the shared pool with prefill/decode roles, the
    mid-stream handoff drain and the request observatory at the small
    preset (bf16), then token-exact checks on a float32 two-layer copy."""
    new_tokens = 64
    system, prompts, kinds, slos = _prefix_requests(cfg, SEED + 15)
    eng_kw = dict(slots=8, max_len=512, prompt_buckets=(16, 64, 256),
                  device=dev)
    out = {}
    # prefix cell: the same 16 requests without and with the cache, on
    # the kernel path
    for cached in (False, True):
        eng = W.ServingEngine(params, cfg, prefix_cache=cached, **eng_kw)
        if not eng.paged_kernel:
            fail("prefix cell: paged_kernel auto did not resolve ON")
        ttft = {}
        PA.PAGED_DECODE.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = serve(W, eng, prompts, kinds, new_tokens, ttft=ttft)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = PA.PAGED_DECODE.launches
        steps = eng.decode_steps_total
        if launches != cfg.n_layers * steps or steps == 0:
            fail(f"prefix cell: paged_decode launched {launches}x over "
                 f"{steps} decode steps")
        if any(len(x) != new_tokens for x in streams):
            fail("prefix cell: a stream is short")
        st = eng.stats()
        pc = st.get("prefix_cache", {})
        rec = dict(prefilled_tokens_total=st["prefilled_tokens_total"],
                   admitted_tokens_total=st["admitted_tokens_total"],
                   hits=pc.get("hits"), misses=pc.get("misses"),
                   hit_tokens=pc.get("hit_tokens"), decode_steps=steps,
                   paged_launches=launches, wall_s=wall,
                   tokens_per_s=16 * new_tokens / wall,
                   ttft_p50_ms=float(np.median(list(ttft.values()))) * 1e3,
                   ttft_p90_ms=float(np.percentile(list(ttft.values()), 90))
                   * 1e3)
        print(f"prefix cell cache={cached}: prefilled "
              f"{rec['prefilled_tokens_total']} of "
              f"{rec['admitted_tokens_total']} tokens, hits {rec['hits']},"
              f" misses {rec['misses']}, TTFT p50 {rec['ttft_p50_ms']:.2f} ms"
              f" (p90 {rec['ttft_p90_ms']:.2f}), {rec['tokens_per_s']:.1f} "
              f"tokens/s, {steps} decode steps, paged_decode launches "
              f"{launches}")
        out["cached" if cached else "uncached"] = rec
    if not (out["cached"]["prefilled_tokens_total"]
            < out["uncached"]["prefilled_tokens_total"]):
        fail("prefix cell: the cache did not cut prefilled tokens")
    cache = eng._prefix_cache
    used, cached_blocks = eng.used_blocks, cache.cached_blocks
    # explicit prefix on the same engine: register the system prompt and
    # admit 8 tails with prefix=
    pid = eng.register_prefix(system)
    tails = [p[SYSTEM_TOKENS:] for p in prompts[:8]]
    PA.PAGED_DECODE.launches = 0
    steps0 = eng.decode_steps_total
    explicit = serve(W, eng, tails,
                     [(True, dict(kw, prefix=pid)) for _, kw in kinds[:8]],
                     new_tokens)
    launches = PA.PAGED_DECODE.launches
    if launches != cfg.n_layers * (eng.decode_steps_total - steps0):
        fail(f"explicit prefix: {launches} paged_decode launches")
    if any(len(x) != new_tokens for x in explicit):
        fail("explicit prefix: a stream is short")
    eng.release_prefix(pid)
    print(f"explicit prefix: 8 admissions on the registered system prompt, "
          f"paged_decode launches {launches}")
    out["explicit"] = dict(requests=8, paged_launches=launches)
    if eng.used_blocks != cache.cached_blocks:
        fail(f"explicit prefix: {eng.used_blocks} blocks held, cache "
             f"{cache.cached_blocks}")
    _leak_check("prefix cell", used, cached_blocks, cache)
    del eng, cache

    # disaggregated pair over one SharedKVPool (the gather path), with one
    # observatory shared by both roles
    def pair(cfg_, params_, obs=None, handoff=False):
        """Two engines over one pool: prefill (4 slots) and decode (8),
        or for a handoff two decode-role engines of 8 slots."""
        pool = W.SharedKVPool(cfg_, block_size=16,
                              pool_blocks=1 + (8 + 8 + 2) * 32, device=dev)
        kw = dict(eng_kw, pool=pool, observatory=obs)
        first = (dict(kw, role="decode") if handoff
                 else dict(kw, role="prefill", slots=4))
        return (pool, W.ServingEngine(params_, cfg_, **first),
                W.ServingEngine(params_, cfg_, role="decode", **kw))

    obs = RO.RequestObservatory()
    pool, pre, dec = pair(cfg, params, obs)
    t0 = time.perf_counter()
    streams, tail = serve_disaggregated(pre, dec, prompts, kinds, slos,
                                        new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ds = W.disaggregated_status(pre, dec)
    adoptions = dec.stats()["adoptions_total"]
    print(f"disaggregated: {len(prompts)} requests, decode adoptions "
          f"{adoptions}, decode-role prefill per request max "
          f"{max(tail.values())} tokens (block 16), prefill role prefilled "
          f"{ds['roles']['prefill']['prefilled_tokens_total']}, "
          f"{16 * new_tokens / wall:.1f} tokens/s")
    if adoptions != 16 or max(tail.values()) > 16 or min(tail.values()) < 1:
        fail(f"disaggregated: adoptions {adoptions}, tails {tail}")
    if any(len(x) != new_tokens for x in streams):
        fail("disaggregated: a stream is short")
    st = obs.status()
    recs = st["requests"]
    worst = max(abs(sum(r["phases_ms"].values()) + r["residual_ms"]
                    - r["wall_ms"]) for r in recs)
    ids = [r["id"] for r in recs]
    print(f"observatory: {st['finished']} finished, {st['stitched']} "
          f"stitched, {len(set(ids))} ids, worst |sum(phases) + residual - "
          f"wall| {worst:.4f} ms, worst residual "
          f"{st['conservation']['worst_residual_ms']} ms")
    for c, v in st["classes"].items():
        print(f"observatory {c}: TTFT p50 {v['ttft_p50_ms']} p99 "
              f"{v['ttft_p99_ms']} ms, TPOT p50 {v['tpot_p50_ms']} p99 "
              f"{v['tpot_p99_ms']} ms, attainment {v['attainment']}")
    if (st["finished"] != 16 or st["stitched"] != 16 or len(ids) != 16
            or len(set(ids)) != 16 or worst > 1.0
            or abs(st["conservation"]["worst_residual_ms"]) > 1.0
            or st["live"] or st["pending_handoff"]):
        fail(f"observatory: {st['finished']} finished, {st['stitched']} "
             f"stitched, ids {ids}, worst {worst}")
    out["disaggregated"] = dict(
        adoptions=adoptions, decode_prefill_max=max(tail.values()),
        prefill_role_prefilled=ds["roles"]["prefill"][
            "prefilled_tokens_total"],
        tokens_per_s=16 * new_tokens / wall,
        observatory={c: {k: v[k] for k in ("ttft_p50_ms", "ttft_p99_ms",
                                           "tpot_p50_ms", "tpot_p99_ms")}
                     for c, v in st["classes"].items()},
        worst_conservation_ms=worst)
    _leak_check("disaggregated", pool.used_blocks,
                pool.prefix_cache.cached_blocks, pool.prefix_cache)
    del pool, pre, dec

    # mid-stream handoff: 8 live streams, 10 steps, a handoff drain acked
    # through a watcher, a peer finishing them
    alloc, h = os.path.join(tmp, "alloc_handoff"), "chipsmokehandoff"
    os.makedirs(alloc)
    with open(os.path.join(alloc, f"{h}.json"), "w") as f:
        json.dump({"env": {"ELASTIC_TPU_DRAIN": "maintenance:smoke"}}, f)
    watcher = L.LifecycleWatcher(alloc, h, poll_interval_s=0.0)
    pool, src, peer = pair(cfg, params, handoff=True)
    streams, summary = serve_handed_off(
        L, src, peer, prompts[:8], [(i % 4 != 3, kw) for i, (_, kw)
                                    in enumerate(kinds[:8])],
        new_tokens, 10, watcher)
    ack = L.read_checkpoint_ack(alloc, h) or {}
    ps = pool.stats()
    print(f"handoff drain: {summary}; ack kind {ack.get('kind')} "
          f"handoff_streams {ack.get('handoff_streams')}; published "
          f"{ps['published_streams']}, adopted {ps['adopted_streams']}, "
          f"expired {ps['expired_streams']}")
    if (ack.get("kind") != "drained" or ack.get("handoff_streams") != 8
            or summary["handoff_streams"] != 8
            or ps["published_streams"] != ps["adopted_streams"]
            or ps["expired_streams"] or ps["pending_streams"]
            or any(s is None or len(s) != new_tokens for s in streams)):
        fail(f"handoff drain: summary {summary}, ack {ack}, pool {ps}")
    out["handoff"] = dict(summary, ack_kind=ack.get("kind"),
                          published=ps["published_streams"],
                          adopted=ps["adopted_streams"])
    _leak_check("handoff", pool.used_blocks, pool.prefix_cache.cached_blocks,
                pool.prefix_cache)
    del pool, src, peer

    # float32 two-layer copy, greedy: every route gives the same streams
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params32 = W.params_from_jax(dict(tree, layers=tree["layers"][:2]),
                                 cfg32, device=dev)
    few, n32 = prompts[:8], 32
    greedy = [(i % 2 == 0, {}) for i in range(8)]
    runs = {}
    for cached in (False, True):
        e = W.ServingEngine(params32, cfg32, prefix_cache=cached, **eng_kw)
        runs["cached" if cached else "uncached"] = serve(W, e, few, greedy,
                                                         n32)
    pid = e.register_prefix(system)
    runs["explicit"] = serve(W, e, [p[SYSTEM_TOKENS:] for p in few],
                             [(True, dict(prefix=pid))] * 8, n32)
    _, pre, dec = pair(cfg32, params32)
    runs["disaggregated"] = serve_disaggregated(
        pre, dec, few, greedy, ["batch"] * 8, n32)[0]
    _, src, peer = pair(cfg32, params32, handoff=True)
    runs["handed_off"] = serve_handed_off(L, src, peer, few, greedy, n32,
                                          10)[0]
    runs["generate"] = [W.generate(params32, [p], cfg32, n32, device=dev)[
        0, len(p):].tolist() for p in few]
    same = {k: v == runs["generate"] for k, v in runs.items()}
    print(f"prefix f32 2-layer, greedy streams equal to generate(): {same}")
    if not all(same.values()):
        fail(f"prefix f32 streams differ: {same}")
    out["f32_streams_equal"] = all(same.values())
    return out


# -- the decode variants (phases 11-14) ----------------------------------
#
# The speculative cell's draft: the runner's ``tiny`` preset widths
# (elastic_tpu_agent/workloads/runner.py PRESETS["tiny"]) at the small
# preset's vocabulary, since draft and target must share one.
DRAFT = dict(vocab=32768, d_model=256, n_heads=4, n_layers=2, d_ff=1024)
GAMMA = 4
# the speculative cell's engines: the serving cell's requests reach it
SPEC_MAX_LEN = 256
# the streaming cell: no preset sets a window; the cell takes 256 with
# rope (transformer.py's window and pos fields)
STREAM_WINDOW = 256
LORA_RANK = 8
LORA_STEPS = 20
# LoRA losses over 20 steps, flash kernels vs reference attention. The
# adapters move the loss only ~0.9 in the run, so the train cell's 0.2
# would pass a wrong backward: sound kernels gave 0.001845 (four runs);
# delta dropped in dQ 0.0355, the q-tile lower bound one tile late 0.131,
# lse/delta read by row 0.755 (the GQA fault F7 is a no-op at the preset's
# 8 kv heads and fails the GQA kernel checks; PERF.md, Findings).
LORA_TRAIN_BF16_TOL = 0.01


def _f32_copy(torch, W, cfg, tree, dev, n_layers=2):
    cfg32 = dataclasses.replace(cfg, n_layers=n_layers, dtype=torch.float32)
    tree32 = dict(tree, layers=tree["layers"][:n_layers])
    return cfg32, W.params_from_jax(tree32, cfg32, device=dev)


def _oracle(W, params, cfg, prompt, n, dev, **kw):
    return W.generate(params, [prompt], cfg, n, device=dev, **kw)[
        0, len(prompt):].tolist()


def run_speculative(torch, W, PA, cfg, params, tree, dev):
    """Speculative decoding at the small preset (bf16) with the tiny-width
    draft: solo (a 32-token prompt, 128 new tokens) beside generate(), and
    the serving cell's 16 requests (temperature 0.8 where the serving cell
    samples; spec mode refuses top-k) through a speculative engine beside
    the plain one, at a max_len the longest requests reach: its fallback
    steps launch the paged kernel layers x steps times, counted from 0
    just before the speculative run. Then float32 two-layer copies: solo
    and engine greedy streams against generate(), a self-draft that must
    commit every round in full, and a fallback run near max_len whose
    paged-kernel launches are layers x fallback steps, with streams equal
    to the same engine's on the gather path."""
    dcfg = W.ModelConfig(**DRAFT, max_seq=cfg.max_seq, dtype=cfg.dtype)
    dtree = W.random_tree(dcfg, SEED + 20)
    dparams = W.params_from_jax(dtree, dcfg, device=dev)
    rng = np.random.default_rng(SEED + 21)
    prompt = rng.integers(0, cfg.vocab, size=(1, 32)).tolist()
    n = 128
    W.speculative_generate(params, dparams, cfg, dcfg, prompt, 8,
                           gamma=GAMMA, device=dev)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = W.speculative_generate(params, dparams, cfg, dcfg, prompt,
                                        n, gamma=GAMMA, device=dev)
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = W.generate(params, prompt, cfg, n, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if tuple(out.shape) != (1, 32 + n) or not (
            0 <= int(out.min()) and int(out.max()) < cfg.vocab):
        fail(f"speculative solo: output {tuple(out.shape)}")
    agree = float((out[0, 32:] == ref[0, 32:]).float().mean())
    solo = dict(new_tokens=n, gamma=GAMMA, tokens_per_s=n / solo_s,
                generate_tokens_per_s=n / gen_s, stats=stats.stats(),
                greedy_agreement_with_generate=agree)
    print(f"speculative solo small preset bf16, tiny draft, gamma {GAMMA}: "
          f"{n / solo_s:.1f} tokens/s (generate {n / gen_s:.1f}), "
          f"{stats.rounds} rounds, acceptance "
          f"{stats.stats()['acceptance_rate']}, greedy agreement with "
          f"generate {agree:.4f}")

    prompts, kinds = _serving_requests(cfg, SEED + 4)
    kinds = [(a, {k: v for k, v in kw.items() if k != "top_k"})
             for a, kw in kinds]
    # max_len SPEC_MAX_LEN: the longest prompts reach it within their 64
    # tokens, so the speculative engine falls back to plain steps through
    # the paged kernel on this run (rows within gamma of the row end)
    eng_kw = dict(slots=8, max_len=SPEC_MAX_LEN,
                  prompt_buckets=(16, 64, 256), device=dev)
    engine, launches = {}, 0
    for spec in (False, True):
        draft = dict(draft_params=dparams, draft_cfg=dcfg,
                     gamma=GAMMA) if spec else {}
        eng = W.ServingEngine(params, cfg, **eng_kw, **draft)
        if not eng.paged_kernel:
            fail(f"speculative engine={spec}: paged_kernel auto did not "
                 "resolve ON")
        torch.cuda.synchronize()
        PA.PAGED_DECODE.launches = 0
        t0 = time.perf_counter()
        streams = serve(W, eng, prompts, kinds, 64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(s) for s in streams)
        # a stream ends at 64 tokens or at the row end (prompt + stream
        # fill max_len)
        if any(not (len(s) >= 64 or len(p) + len(s) >= SPEC_MAX_LEN)
               or not all(0 <= t < cfg.vocab for t in s)
               for p, s in zip(prompts, streams)) or eng.used_blocks:
            fail(f"speculative engine={spec}: short or bad streams or "
                 f"{eng.used_blocks} leaked blocks")
        steps = eng.decode_steps_total
        engine["spec" if spec else "plain"] = dict(
            tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
            decode_steps=steps, paged_launches=PA.PAGED_DECODE.launches,
            speculative=eng.stats().get("speculative"))
        if spec:
            launches = PA.PAGED_DECODE.launches
            if steps == 0 or launches != cfg.n_layers * steps:
                fail(f"speculative engine: paged_decode launched "
                     f"{launches}x over {steps} fallback steps")
    print(f"speculative engine small preset: 16 requests, max_len "
          f"{SPEC_MAX_LEN}, {engine['spec']['tokens_per_s']:.1f} tokens/s "
          f"(plain engine {engine['plain']['tokens_per_s']:.1f}), "
          f"{engine['spec']['decode_steps']} fallback steps, paged_decode "
          f"launches {launches}, {engine['spec']['speculative']}")

    # float32 two-layer copies
    cfg32, params32 = _f32_copy(torch, W, cfg, tree, dev)
    dcfg32 = dataclasses.replace(dcfg, dtype=torch.float32)
    dparams32 = W.params_from_jax(dtree, dcfg32, device=dev)
    few = [p[:40] for p in prompts[:4]]
    same = True
    for p in few[:2]:
        got, _ = W.speculative_generate(params32, dparams32, cfg32, dcfg32,
                                        [p], 48, gamma=GAMMA, device=dev)
        same &= got[0, len(p):].tolist() == _oracle(
            W, params32, cfg32, p, 48, dev, max_len=len(p) + 48 + GAMMA + 1)
    # 1 + 9 (gamma + 1) new tokens: nine full rounds, none cut by the end
    n_self = 1 + 9 * (GAMMA + 1)
    _, self_st = W.speculative_generate(params32, params32, cfg32, cfg32,
                                        [few[0]], n_self, gamma=GAMMA,
                                        device=dev)
    full_rounds = (self_st.accepted == self_st.drafted
                   and self_st.rounds == 9)
    f32_kw = dict(slots=4, max_len=512, prompt_buckets=(16, 64, 256),
                  device=dev)
    eng = W.ServingEngine(params32, cfg32, draft_params=dparams32,
                          draft_cfg=dcfg32, gamma=GAMMA, **f32_kw)
    streams = serve(W, eng, few, [(i % 2 == 0, {}) for i in range(4)], 32)
    same &= all(s == _oracle(W, params32, cfg32, p, len(s), dev)
                for p, s in zip(few, streams))
    eng = W.ServingEngine(params32, cfg32, draft_params=params32,
                          draft_cfg=cfg32, gamma=GAMMA, **f32_kw)
    serve(W, eng, few, [(True, {})] * 4, 32)
    self_eng = eng.stats()["speculative"]
    full_rounds &= self_eng["accepted_tokens"] == self_eng["drafted_tokens"]
    print(f"speculative f32 2-layer: solo and engine streams == generate(): "
          f"{same}; self-draft acceptance solo "
          f"{self_st.stats()['acceptance_rate']}, engine "
          f"{self_eng['acceptance_rate']}, every round full: {full_rounds}")
    if not same:
        fail("speculative f32 streams differ from generate()")
    if not full_rounds:
        fail(f"speculative self-draft did not commit full rounds: "
             f"{self_st.stats()}, {self_eng}")
    # near max_len: fallback steps through the paged kernel, against the
    # same engine on the gather path (the kernel's plain version)
    fb_kw = dict(slots=2, max_len=64, prompt_buckets=(16, 64),
                 draft_params=dparams32, draft_cfg=dcfg32, gamma=GAMMA,
                 device=dev)
    fb = {}
    for paged in (True, False):
        eng = W.ServingEngine(params32, cfg32, paged_kernel=paged, **fb_kw)
        PA.PAGED_DECODE.launches = 0
        streams = serve(W, eng, few[:2], [(True, {})] * 2, 64)
        torch.cuda.synchronize()
        fb[paged] = (streams, eng.decode_steps_total,
                     PA.PAGED_DECODE.launches)
    (kernel_streams, steps, fb_launches), gather = fb[True], fb[False]
    fb_same = kernel_streams == gather[0] and steps == gather[1]
    print(f"speculative f32 fallback near max_len: {steps} fallback steps, "
          f"paged_decode launches {fb_launches} (gather path "
          f"{gather[2]}), streams == the gather path's: {fb_same}")
    if steps == 0 or fb_launches != cfg32.n_layers * steps or gather[2]:
        fail(f"speculative fallback: paged_decode launched {fb_launches}x "
             f"over {steps} fallback steps (gather path {gather[2]}x)")
    if not fb_same:
        fail("speculative fallback streams differ from the gather path's")
    return launches, dict(
        solo=solo, engine=engine, f32_streams_equal=bool(same),
        self_draft_full_rounds=bool(full_rounds),
        self_draft_acceptance=self_st.stats()["acceptance_rate"],
        f32_fallback_steps=steps, f32_fallback_paged_launches=fb_launches,
    )


def run_beam(torch, W, cfg, params, tree, dev):
    """Beam search at the small preset (bf16): beam 4, a 32-token prompt,
    64 new tokens, without and with eos; beam 1 on a float32 two-layer
    copy against generate()."""
    rng = np.random.default_rng(SEED + 22)
    prompt = rng.integers(0, cfg.vocab, size=(1, 32)).tolist()
    n, k = 64, 4
    eos = int(W.generate(params, prompt, cfg, n, device=dev)[0, 32 + 2])
    out = {}
    for label, eos_id in (("no_eos", None), ("eos", eos)):
        W.beam_search(params, prompt, cfg, 4, beam_size=k, eos_id=eos_id,
                      device=dev)                             # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seqs, scores = W.beam_search(params, prompt, cfg, n, beam_size=k,
                                     eos_id=eos_id, device=dev)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        sc = scores.float().cpu().numpy()
        ok = (tuple(seqs.shape) == (k, 32 + n) and np.isfinite(sc).all()
              and (sc[:-1] >= sc[1:]).all())
        if eos_id is not None:
            for row in seqs[:, 32:].tolist():
                if eos_id in row and set(row[row.index(eos_id):]) != {eos_id}:
                    ok = False
        if not ok:
            fail(f"beam {label}: shape {tuple(seqs.shape)}, scores {sc}")
        out[label] = dict(seconds=s, tokens_per_s=k * n / s,
                          best_score=float(sc[0]))
        print(f"beam small preset bf16 {label}: beam {k}, {n} new tokens in "
              f"{s * 1e3:.1f} ms ({k * n / s:.1f} beam tokens/s), scores "
              f"{np.round(sc, 3).tolist()}")
    cfg32, params32 = _f32_copy(torch, W, cfg, tree, dev)
    same = True
    for p in (prompt[0][:20], prompt[0][5:37]):
        seqs, _ = W.beam_search(params32, [p], cfg32, 32, beam_size=1,
                                device=dev)
        same &= seqs[0, len(p):].tolist() == _oracle(W, params32, cfg32, p,
                                                     32, dev)
    print(f"beam f32 2-layer: beam 1 == generate(): {same}")
    if not same:
        fail("beam 1 differs from generate() in float32")
    out["f32_beam1_equals_generate"] = bool(same)
    return out


def run_streaming(torch, W, S, cfg, dev):
    """Streaming decode at the small preset's widths with rope and a
    256-token window: 8 rows, a 64-token prompt, 768 new tokens (three
    times the ring). The ring's bytes are those of a window-slot cache
    whatever the length, and the device's peak memory does not grow with
    it; a float32 two-layer copy streams exactly as generate()'s full
    cache does."""
    scfg = dataclasses.replace(cfg, pos="rope", window=STREAM_WINDOW)
    stree = W.random_tree(scfg, SEED + 23)
    sparams = W.params_from_jax(stree, scfg, device=dev)
    rng = np.random.default_rng(SEED + 24)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 64)),
                          device=dev)
    caches = []
    real = S.KVCache.empty.__func__

    def empty(cls, *a, **kw):
        cache = real(cls, *a, **kw)
        caches.append(cache.k.numel() * cache.k.element_size() * 2)
        return cache

    S.KVCache.empty = classmethod(empty)
    try:
        peaks = {}
        for n in (2, 32, 768):      # 2: the warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = S.streaming_generate(sparams, prompt, scfg, n, device=dev)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            peaks[n] = torch.cuda.max_memory_allocated() - base
    finally:
        S.KVCache.empty = classmethod(real)
    # generate() over the same rows, its cache growing with the length
    t0 = time.perf_counter()
    W.generate(sparams, prompt, scfg, 64, device=dev)
    torch.cuda.synchronize()
    gen_tps = 8 * 64 / (time.perf_counter() - t0)
    ring_bytes = caches[-1]
    want_bytes = (2 * scfg.n_layers * 8 * STREAM_WINDOW * scfg.kv_heads
                  * scfg.head_dim * 2)
    # what may grow: the emitted tokens (8 x 768 int64 tensors of one
    # allocator block each, under 0.4 MiB), not the cache
    grew = peaks[768] - peaks[32]
    print(f"streaming small preset rope window {STREAM_WINDOW} bf16: 8 rows, "
          f"768 new tokens in {s:.2f} s ({8 * 768 / s:.1f} tokens/s; "
          f"generate() over the same rows {gen_tps:.1f}), ring bytes "
          f"{ring_bytes} at every length ({sorted(set(caches))}), peak "
          f"allocation {peaks[32]} B at 32 tokens, {peaks[768]} B at 768")
    if set(caches) != {want_bytes}:
        fail(f"streaming ring bytes {sorted(set(caches))}, want {want_bytes}")
    if grew > 1 << 20:
        fail(f"streaming peak memory grew {grew} B from 32 to 768 tokens")
    if tuple(out.shape) != (8, 64 + 768) or not (
            0 <= int(out.min()) and int(out.max()) < cfg.vocab):
        fail(f"streaming output {tuple(out.shape)}")
    cfg32 = dataclasses.replace(scfg, n_layers=2, dtype=torch.float32,
                                window=64)
    p32 = W.params_from_jax(dict(stree, layers=stree["layers"][:2]), cfg32,
                            device=dev)
    short = prompt[:2, :40]
    got = S.streaming_generate(p32, short, cfg32, 160, device=dev)
    same = got.tolist() == W.generate(p32, short, cfg32, 160,
                                      device=dev).tolist()
    print(f"streaming f32 2-layer window 64: 200 positions (3 ring wraps) "
          f"== generate(): {same}")
    if not same:
        fail("streaming f32 stream differs from generate()")
    return dict(rows=8, new_tokens=768, seconds=s, tokens_per_s=8 * 768 / s,
                generate_tokens_per_s=gen_tps, ring_bytes=ring_bytes,
                peak_bytes={str(n): peaks[n] for n in (32, 768)},
                f32_equals_generate=bool(same))


def _lora_run(torch, W, cfg, params, dev, tokens, steps):
    step, init = W.make_lora_train_step(cfg, rank=LORA_RANK,
                                        learning_rate=1e-3, device=dev)
    lora, opt = init(params, torch.Generator().manual_seed(SEED))
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lora, opt, loss = step(params, lora, opt, tokens)
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    return lora, losses, times


def run_lora(torch, W, A, LR, cfg, params, dev):
    """LoRA on the frozen bf16 small preset: rank 8 on the default targets
    (wqkv, wo), lr 1e-3, batch 8, seq 256, 20 steps on one fixed batch
    through the flash forward and both backward kernels, against the same
    run on reference attention; the base bit-unchanged, and the merged
    forward equal to the adapted one."""
    rng = np.random.default_rng(SEED + 25)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 257)),
                          device=dev)
    before = [t.clone() for t in _flat(params)]
    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    for kern in kerns:
        kern.launches = 0
    lora, losses, times = _lora_run(torch, W, cfg, params, dev, tokens,
                                    LORA_STEPS)
    torch.cuda.synchronize()
    launches = {kern.symbol: kern.launches for kern in kerns}
    n_params = LR.lora_param_count(lora)
    _, ref_losses, ref_times = _lora_run(
        torch, W, dataclasses.replace(cfg, attn="reference"), params, dev,
        tokens, LORA_STEPS)
    gap = float(np.max(np.abs(np.asarray(losses) - np.asarray(ref_losses))))
    unchanged = all(torch.equal(a, b) for a, b in zip(_flat(params), before))
    toks = tokens[:2, :64]
    merged = W.forward(W.merge_lora(params, lora), toks, cfg, device=dev)
    with torch.no_grad():
        adapted = W.forward(LR.apply_lora(params, lora), toks, cfg,
                            device=dev)
    merged_equal = torch.equal(merged, adapted)
    p50 = float(np.median(times) * 1e3)
    print(f"lora small preset bf16 base, rank {LORA_RANK}, {n_params} adapter"
          f" params, [8,256], {LORA_STEPS} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, launches {launches}, step p50 {p50:.2f} ms; "
          f"reference attention step p50 {np.median(ref_times) * 1e3:.2f} ms,"
          f" max|loss - reference| {gap:.4g}; base unchanged {unchanged}, "
          f"merged forward == adapted {merged_equal}")
    print("lora losses " + " ".join(f"{x:.4f}" for x in losses))
    print("lora reference losses " + " ".join(f"{x:.4f}" for x in ref_losses))
    want = cfg.n_layers * LORA_STEPS
    if any(n != want for n in launches.values()):
        fail(f"lora launches {launches}, want {want} each")
    if n_params != 196_608:
        fail(f"lora adapter params {n_params}, want 196608")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"lora losses {losses[0]} -> {losses[-1]}")
    if not gap <= LORA_TRAIN_BF16_TOL:
        fail(f"lora losses vs reference attention: {gap}")
    if not unchanged:
        fail("lora training changed the frozen base")
    if not merged_equal:
        fail("lora merged forward differs from the adapted forward")
    return launches, dict(
        rank=LORA_RANK, adapter_params=n_params, batch=8, seq=256,
        steps=LORA_STEPS, loss_first=losses[0], loss_last=losses[-1],
        step_ms_p50=p50,
        reference_step_ms_p50=float(np.median(ref_times) * 1e3),
        max_abs_loss_gap_vs_reference=gap, base_unchanged=unchanged,
        merged_equals_adapted=merged_equal, launches=launches,
    )


# phase 17: ring attention, stacked over RING_SP chunks of RING_SEQ
# positions (the dryrun's leg: sp 4 at seq 4096)
RING_SP = 4
RING_SEQ = 4096
# the ring against plain full attention in f32: JAX's dryrun asserts 1e-4
# on the output; the gradients differ by summation order only, relative to
# each one's largest element, as TRAIN_GRAD_F32_TOL
RING_F32_TOL = 1e-4
RING_GRAD_F32_TOL = 1e-4
# phase 16: the sharded step at world 1 against phase 5's losses: none at
# all. It runs the same kernels and products on the same shapes; its
# collectives, over groups of one rank, return their input; the loss at
# tp 1 is the cross entropy's sum over the token count, which the mean
# computes; and zero1 at dp 1 is a no-op. With master weights the masters
# start from the same f32 weights, and the live bf16 leaves hold the values
# phase 5's casts make at each use.
MESH_TOL = 0.0
EXPORT_NEW_TOKENS = 64


def run_export(torch, W, E, R, cfg, trained, dev, tmp) -> dict:
    """Phase 15: phase 5's trained f32 params through a port train
    checkpoint and the export CLI into an f32 and an ``--int8`` artifact,
    and through ``save_artifact`` as bf16; each reloaded bit for bit; the
    runner's decode mode on the bf16 and int8 artifacts (``--params-dir``)
    must give ``generate()``'s greedy tokens on the in-memory params."""
    import contextlib
    import io
    import shutil

    from elastic_tpu_agent_torch.workloads import checkpointing as C
    from elastic_tpu_agent_torch.workloads import quantize as Q

    params = trained["params"]
    bf16 = Q._tree_map(lambda path, t: t.to(cfg.dtype), params)
    want = {"f32": params, "int8": Q.quantize_params(params), "bf16": bf16}
    ck = os.path.join(tmp, "export_ck")
    c = C.TrainCheckpointer(ck)
    c.save(len(trained["losses"]), params,
           {"count": torch.zeros((), dtype=torch.int32)})
    c.close()
    saved = {k: os.environ.pop(k, None) for k in RUNTIME_ENV}
    os.environ["ELASTIC_TPU_ENV_FILE"] = os.path.join(tmp, "no-env-file")
    out, dirs = {}, {}
    try:
        for label in ("f32", "int8", "bf16"):
            d = dirs[label] = os.path.join(tmp, f"artifact_{label}")
            t0 = time.perf_counter()
            if label == "bf16":
                E.save_artifact(d, bf16, cfg)
            else:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = E.main(["--checkpoint-dir", ck, "--out", d,
                                 "--preset", "small", "--seq",
                                 str(cfg.max_seq)]
                                + (["--int8"] if label == "int8" else []),
                                device=dev)
                summary = json.loads(buf.getvalue().strip().splitlines()[-1])
                if rc != 0 or summary["int8"] != (label == "int8"):
                    fail(f"export CLI {label}: rc {rc}, {summary}")
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            loaded, lcfg = E.load_artifact(d, device=dev)
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
            a, b = (dict(C._flatten(t)) for t in (loaded, want[label]))
            exact = a.keys() == b.keys() and all(
                a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                for k in b)
            nbytes = E.tree_bytes(loaded)
            print(f"export {label}: {nbytes} bytes, save {save_ms:.1f} ms "
                  f"(the CLI's includes the checkpoint restore), load "
                  f"{load_ms:.1f} ms, reloaded bit for bit {exact}, config "
                  f"{'equal' if lcfg == cfg else 'DIFFERENT'}")
            if not exact or lcfg != cfg:
                fail(f"export {label}: reload exact {exact}, cfg {lcfg}")
            out[label] = dict(bytes=nbytes, save_ms=save_ms, load_ms=load_ms)
        prompt = torch.as_tensor(R.decode_prompt(cfg, 8, 32), device=dev)
        for label in ("bf16", "int8"):
            rep = _runner(R, f"--mode decode --params-dir {dirs[label]} "
                          f"--batch 8 --prompt-len 32 --new-tokens "
                          f"{EXPORT_NEW_TOKENS}", dev)
            ref = want[label]
            if label == "int8":     # the runner's cast of the float leaves
                ref = Q._tree_map(
                    lambda path, t: t if Q.is_quantized(t) else t.to(
                        cfg.dtype), ref)
            toks = W.generate(ref, prompt, cfg,
                              max_new_tokens=EXPORT_NEW_TOKENS,
                              max_len=32 + EXPORT_NEW_TOKENS, device=dev)
            tail = [int(t) for t in toks[0, -5:]]
            print(f"export runner --params-dir {label}: sample_tail "
                  f"{rep['sample_tail']}, generate() {tail}, decode "
                  f"{rep['decode_tokens_per_s']} tokens/s")
            if rep["sample_tail"] != tail or rep["restored_step"] != "artifact":
                fail(f"runner on the {label} artifact: {rep['sample_tail']} "
                     f"vs generate() {tail}, restored {rep['restored_step']}")
            out[label].update(decode_tokens_per_s=rep["decode_tokens_per_s"],
                              sample_tail=rep["sample_tail"])
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        for d in (ck, *dirs.values()):
            shutil.rmtree(d, ignore_errors=True)
    return out


def run_mesh(torch, W, A, P, cfg, tree, trained, dev, tmp):
    """Phase 16: the sharded train step over a one-rank NCCL world
    (``make_mesh(1)``): 20 steps at phase 5's weights and tokens, then 20
    with zero1 and master weights (masters from the same f32 weights); the
    losses must equal phase 5's. Launches of the three flash kernels over
    each run; the device time of the step's gradient all-reduce."""
    import torch.distributed as dist

    from elastic_tpu_agent_torch.workloads import quantize as Q
    from elastic_tpu_agent_torch.workloads import transformer as T

    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'mesh_store')}",
        rank=0, world_size=1)
    out = {"launches": dict.fromkeys((k.symbol for k in kerns), 0)}
    try:
        mesh = P.make_mesh(1)
        out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        for label, opts in (("plain", {}), ("zero1+master_weights",
                                            dict(zero1=True,
                                                 master_weights=True))):
            step, _, opt = W.make_train_step(cfg, learning_rate=1e-3,
                                             device=dev, mesh=mesh, **opts)
            params = P.shard_params(W.params_from_jax(
                tree, cfg, device=dev, dtype=torch.float32), mesh, cfg)
            state = opt.init(params)
            if opts:                # live leaves in cfg.dtype
                params = Q._tree_map(lambda path, t: t.to(cfg.dtype), params)
            for kern in kerns:
                kern.launches = 0
            losses, times = [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                losses.append(step(params, state, trained["tokens"])[2]
                              .item())
                times.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            launches = {k.symbol: k.launches for k in kerns}
            for k, n in launches.items():
                out["launches"][k] += n
            gap = float(np.max(np.abs(np.asarray(losses)
                                      - np.asarray(trained["losses"]))))
            p50 = float(np.median(times) * 1e3)
            print(f"mesh world 1 {label}, small preset [8,256] bf16, "
                  f"{TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, max|loss - phase 5| {gap:.4g}, step "
                  f"p50 {p50:.2f} ms, launches {launches}")
            if not gap <= MESH_TOL:
                fail(f"mesh {label} losses vs phase 5: {gap}")
            want = cfg.n_layers * TRAIN_STEPS
            if any(n != want for n in launches.values()):
                fail(f"mesh {label} launches {launches}, want {want} each")
            out[label] = dict(loss_first=losses[0], loss_last=losses[-1],
                              max_abs_loss_gap_vs_phase5=gap,
                              step_ms_p50=p50, launches=launches)
        view = P.local_view(mesh)
        grads = [torch.zeros(x.shape, dtype=torch.float32, device=dev)
                 for x in T._leaves(params)]
        out["grad_all_reduce_ms"] = device_ms(
            torch, lambda: P.all_reduce_(grads, (view.dp, view.sp)))[0]
        print(f"mesh gradient all-reduce over dp and sp (world 1, "
              f"{sum(g.numel() for g in grads)} elements): device ms "
              f"{out['grad_all_reduce_ms']:.4g}")
        # where the sharded step's time goes: host ms (synchronized) of
        # the loss and gradients, single-device and sharded, of the
        # gradient all-reduce, on the last run's params, and of one
        # activation all-reduce
        tokens = trained["tokens"]
        parts = {
            "loss_and_grads": lambda: W.loss_and_grads(params, tokens, cfg,
                                                       dev),
            "sharded_loss_and_grads": lambda: T._local_loss_and_grads(
                params, tokens, cfg, dev, view),
            "grad_all_reduce": lambda: P.all_reduce_(grads,
                                                     (view.dp, view.sp)),
        }
        # one tp all-reduce of a layer's activations (reduce_from's call)
        act = torch.zeros((8, 256, cfg.d_model), dtype=cfg.dtype, device=dev)
        parts["activation_all_reduce"] = lambda: dist.all_reduce(
            act, group=view.tp)
        out["host_ms"] = {}
        for name, fn in parts.items():
            ts = []
            for i in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            out["host_ms"][name] = float(np.median(ts[2:]))
        print("mesh step parts, host ms (median of 5) "
              + json.dumps(out["host_ms"]))
    finally:
        dist.destroy_process_group()
    return out


def run_ring(torch, A, RA, dev) -> dict:
    """Phase 17: the three flash kernels against their plain versions at
    the ring's call patterns (a non-causal block, a causal block with an
    lse cotangent; s_loc 1024 at h 128 f32 and h 64 bf16), then the
    stacked ring (sp 4) at seq 4096: [1,4096,1,128] f32 against plain
    full attention, [2,4096,8,64] bf16 against the same ring on the CPU
    (its kernels' plain versions), launches counted over those two
    forward and backward passes, and at both shapes device times beside
    one flash call over the whole sequence and SDPA."""
    rng = np.random.default_rng(SEED + 30)
    s_loc = RING_SEQ // RING_SP
    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    errs = dict.fromkeys((k.symbol for k in kerns), 0.0)
    for label, dtype, shape, causal in (
            ("f32 non-causal", torch.float32, (1, s_loc, 1, 1, 128), False),
            ("f32 causal dlse", torch.float32, (1, s_loc, 1, 1, 128), True),
            ("bf16 non-causal", torch.bfloat16, (2, s_loc, 8, 8, 64), False),
            ("bf16 causal dlse", torch.bfloat16, (2, s_loc, 8, 8, 64), True)):
        name = str(dtype).split(".")[-1]
        fc = A.FlashConfig(causal=causal)
        b, s, n, g, h = shape
        q = randn(torch, rng, (b, s, n, h), dtype, dev)
        k, v = (randn(torch, rng, (b, s, g, h), dtype, dev) for _ in range(2))
        o, lse = A.flash_attention_with_lse(q, k, v, fc)
        o_ref, lse_ref = A.flash_attention_plain(q, k, v, fc)
        torch.cuda.synchronize()
        e_o = (o.float() - o_ref.float()).abs().max().item()
        e_l = (lse - lse_ref).abs().max().item()
        print(f"ring block flash_fwd {label} {list(shape)}: max|o| err "
              f"{e_o:.3g}, max|lse| err {e_l:.3g}")
        if not (e_o <= FLASH_TOL[name] and e_l <= LSE_TOL):
            fail(f"ring block flash_fwd {label}: o {e_o}, lse {e_l}")
        errs["flash_fwd"] = max(errs["flash_fwd"], e_o, e_l)
        args = _bwd_inputs(torch, A, rng, dev, shape, dtype, fc, causal)
        for kname, kern, plain in (
                ("flash_bwd_dkdv", A.flash_bwd_dkdv, A.flash_bwd_dkdv_plain),
                ("flash_bwd_dq", A.flash_bwd_dq, A.flash_bwd_dq_plain)):
            e = _bwd_check(torch, f"ring block {kname} {label} {list(shape)}",
                           kern(*args, fc), plain(*args, fc), name)
            errs[kname] = max(errs[kname], *e)

    def ring_grads(q, k, v, do):
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        o = RA.ring_attention_stacked(q, k, v, RING_SP)
        return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))

    for kern in kerns:
        kern.launches = 0
    out = {}
    # the dryrun's shape, f32, against plain full attention
    f32 = q, k, v, do = [randn(torch, rng, (1, RING_SEQ, 1, 128),
                               torch.float32, dev) for _ in range(4)]
    got = ring_grads(q, k, v, do)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    o_ref = A.reference_attention(qr, kr, vr)
    ref = (o_ref.detach(), *torch.autograd.grad(o_ref, (qr, kr, vr), do))
    e_o = (got[0] - ref[0]).abs().max().item()
    e_g = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(got[1:], ref[1:])]
    print(f"ring sp {RING_SP} [1,{RING_SEQ},1,128] f32 vs plain full "
          f"attention: max|o| err {e_o:.3g}; gradient errors relative to "
          f"the largest " + ", ".join(f"{x:.3g}" for x in e_g))
    if not (e_o < RING_F32_TOL and max(e_g) <= RING_GRAD_F32_TOL):
        fail(f"ring f32: o {e_o}, grads {e_g}")
    out["f32"] = dict(max_abs_err=e_o, grad_rel_err=e_g)
    # the small preset's heads, bf16: the ring's forward and backward
    # kernels against their plain versions (the same ring on the CPU) on
    # the same inputs: the backward from the card's forward output and lse
    shape = (2, RING_SEQ, 8, 64)
    b, s, n, h = shape
    q, k, v, do = (randn(torch, rng, shape, torch.bfloat16, dev)
                   for _ in range(4))
    ring = RA.StackedRing(RING_SP)
    cut = [x.reshape(b, RING_SP, s_loc, n, h).transpose(0, 1).contiguous()
           for x in (q, k, v, do)]
    fc, use_flash = RA.resolve(q)
    o, lse = RA.ring_forward(*cut[:3], ring, True, fc, use_flash)
    grads = RA.ring_backward(*cut[:3], o, lse, cut[3], ring, True, fc,
                             use_flash)
    torch.cuda.synchronize()
    launches = {kern.symbol: kern.launches for kern in kerns}
    host = [x.cpu() for x in (*cut[:3], o, lse, cut[3])]
    o_p, lse_p = RA.ring_forward(*host[:3], ring, True, fc, use_flash)
    plain = RA.ring_backward(*host, ring, True, fc, use_flash)
    e_o = (o.float().cpu() - o_p.float()).abs().max().item()
    e_l = (lse.cpu() - lse_p).abs().max().item()
    print(f"ring sp {RING_SP} {list(shape)} bf16 forward vs its plain "
          f"blocks: max|o| err {e_o:.3g}, max|lse| err {e_l:.3g}")
    if not (e_o <= FLASH_TOL["bfloat16"] and e_l <= LSE_TOL):
        fail(f"ring bf16 forward vs plain: o {e_o}, lse {e_l}")
    e_g = _bwd_check(torch, f"ring sp {RING_SP} {list(shape)} bf16 dq, dk, "
                     "dv vs its plain blocks", tuple(grads), tuple(plain),
                     "bfloat16")
    # each side from its own forward: delta = rowsum(dO * O) then takes
    # the forwards' one-ulp differences of O into dS (reported, not held
    # to the kernel bounds)
    own = RA.ring_backward(*host[:3], o_p, lse_p, host[5], ring, True, fc,
                           use_flash)
    own_mean = [((a.float().cpu() - c.float()).abs().mean()
                 / c.float().abs().mean()).item()
                for a, c in zip(grads, own)]
    print("ring bf16 gradients against the plain ring's from its own "
          "forward: relative mean " + ", ".join(f"{x:.3g}" for x in own_mean))
    out["bf16"] = dict(max_abs_err=e_o, grad_max_abs_err=e_g,
                       own_forward_grad_rel_mean=own_mean)
    want = 2 * RING_SP            # two rings, sp blocks of each kernel
    print(f"ring launches over the two rings' forward and backward: "
          f"{launches} (want {want} each)")
    if any(n != want for n in launches.values()):
        fail(f"ring launches {launches}, want {want} each")
    out["launches"] = launches
    out["kernel_errs"] = errs

    out["times"] = [ring_times(torch, A, RA, *x) for x in (
        f32, (q, k, v, do))]
    return out


def ring_times(torch, A, RA, q, k, v, do) -> dict:
    """Device ms of the stacked ring (sp 4) over q/k/v [b, s, n, h],
    forward and forward + backward, beside one flash call over the whole
    sequence and SDPA, with the forward's bound."""
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    fc = A.FlashConfig()
    with torch.no_grad():
        ring_fwd = device_ms(torch, lambda: RA.ring_attention_stacked(
            q, k, v, RING_SP))[0]
        flash_fwd = device_ms(torch, lambda: A.flash_attention_with_lse(
            q, k, v, fc))[0]
        sdpa_fwd = device_ms(torch, lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True))[0]

    def fwd_bwd(fn, *xs):
        def call():
            ys = [x.detach().requires_grad_() for x in xs[:3]]
            return torch.autograd.grad(fn(*ys), ys, xs[3])
        return device_ms(torch, call)[0]

    ring_fb = fwd_bwd(lambda a, b, c: RA.ring_attention_stacked(
        a, b, c, RING_SP), q, k, v, do)
    flash_fb = fwd_bwd(lambda a, b, c: A.flash_attention(a, b, c, fc),
                       q, k, v, do)
    sdpa_fb = fwd_bwd(lambda a, b, c: torch.nn.functional
                      .scaled_dot_product_attention(a, b, c, is_causal=True),
                      qt, kt, vt, dot)
    b, s, n, h = q.shape
    name = str(q.dtype).split(".")[-1]
    t, by = bound(4 * b * s * n * h * q.element_size() + b * n * s * 4,
                  4 * b * n * h * (s * (s + 1) // 2), name)
    rec = dict(
        shape=f"[{b},{s},{n},{h}] {name} causal, sp {RING_SP}",
        ring_fwd_ms=ring_fwd, flash_fwd_ms=flash_fwd, sdpa_fwd_ms=sdpa_fwd,
        ring_fwd_bwd_ms=ring_fb, flash_fwd_bwd_ms=flash_fb,
        sdpa_fwd_bwd_ms=sdpa_fb, fwd_bound_ms=t, fwd_bound_by=by)
    print("ring times (device ms) " + json.dumps(rec))
    return rec


# phase 19: the MoE step over a one-rank mesh against phase 7's: none at
# all, as phase 16's dense step (MESH_TOL). Routing is one code path with
# or without a mesh; at one rank its id gathers return their input without
# a collective, and the aux loss's and experts' reduces run over groups of
# one rank and return their input, so the step computes phase 7's
# products on its shapes.
MOE_MESH_TOL = 0.0
PIPE_PP = 4
PIPE_MICRO = 4                  # microbatches of 2: phase 5's batch of 8
# phase 20: each schedule's step-0 loss against phase 5's: none at all.
# The stages run phase 5's kernels and products on its weights and tokens,
# a microbatch's rows at a time, and both read 0 on the H100. At random
# init every variant's loss sits near ln(vocab), so a skipped stage or a
# head on the wrong microbatch could stay inside phase 5's
# kernel-vs-reference bound.
PIPE_STEP0_TOL = 0.0
# 1F1B's 20 losses against GPipe's: the same products, in another order
# for the embedding's scatter-add and the gradients' sums; read 4.77e-7
# at most on the H100
PIPE_SCHEDULE_TOL = 1e-4
DECODE_PROMPT = 32
DECODE_NEW = 128
DECODE_BATCH = 8


@contextlib.contextmanager
def one_rank_world(tmp, name):
    """A one-rank NCCL process group (a file store in ``tmp``), destroyed
    on the way out."""
    import torch.distributed as dist

    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, name)}", rank=0,
        world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_moe_mesh(torch, W, A, M, P, TR, tree, moe, dev, tmp) -> dict:
    """Phase 19: the MoE train step over a one-rank NCCL mesh
    (``make_mesh(1)``) at phase 7's weights and tokens for 20 steps: the
    losses, the step-0 aux loss and drop rate must equal phase 7's; 8
    launches a step of each flash kernel."""
    cfg = W.ModelConfig(**SMALL, max_seq=1024, dtype=torch.bfloat16,
                        moe_experts=MOE_EXPERTS)
    _, batch = _moe_batch(torch, cfg, dev)
    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    with one_rank_world(tmp, "moe_mesh_store"):
        mesh = P.make_mesh(1)
        step, _, opt = W.make_train_step(cfg, learning_rate=1e-3,
                                         device=dev, mesh=mesh)
        params = P.shard_params(W.params_from_jax(
            tree, cfg, device=dev, dtype=torch.float32), mesh, cfg)
        view = P.local_view(mesh)
        with torch.no_grad(), RouteLog(M) as log0:
            aux0 = TR._forward(params, batch[:, :-1], cfg, dev, view,
                               0)[1].item()
        stats0 = routing_stats(M, log0, aux0)
        state = opt.init(params)
        for kern in kerns:
            kern.launches = 0
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(step(params, state, batch)[2].item())
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        launches = {k.symbol: k.launches for k in kerns}
        mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    want = moe["train"]
    gap = float(np.max(np.abs(np.asarray(losses)
                              - np.asarray(want["losses"]))))
    aux_gap = abs(aux0 - want["routing_step0"]["aux_loss"])
    drops = (stats0["drop_rate"], want["routing_step0"]["drop_rate"])
    p50 = float(np.median(times) * 1e3)
    print(f"moe mesh world 1 {mesh_shape}, small preset E{MOE_EXPERTS} "
          f"[8,256] bf16, {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, max|loss - phase 7| {gap:.4g}, step-0 aux "
          f"{aux0:.6f} (phase 7 {want['routing_step0']['aux_loss']:.6f}), "
          f"drop rate {drops[0]} (phase 7 {drops[1]}), step p50 {p50:.2f} ms "
          f"(phase 7 {want['step_ms_p50']:.2f}), launches {launches}; NCCL "
          "puts one rank on a card, so experts split over ep across cards "
          "wait for more cards")
    if not (gap <= MOE_MESH_TOL and aux_gap <= MOE_MESH_TOL
            and drops[0] == drops[1]):
        fail(f"moe mesh vs phase 7: losses {gap}, aux {aux_gap}, drop "
             f"rates {drops}")
    want_n = cfg.n_layers * TRAIN_STEPS
    if any(n != want_n for n in launches.values()):
        fail(f"moe mesh launches {launches}, want {want_n} each")
    return dict(mesh=mesh_shape, losses=losses, loss_first=losses[0],
                loss_last=losses[-1], max_abs_loss_gap_vs_phase7=gap,
                aux_step0=aux0, routing_step0=stats0, step_ms_p50=p50,
                phase7_step_ms_p50=want["step_ms_p50"], launches=launches)


def run_pipeline(torch, W, A, PL, TP, WT, cfg, tree, trained, train,
                 dev) -> dict:
    """Phase 20: the pipelined flagship on a ``StackedPipe`` at pp 4, 4
    microbatches of 2 (phase 5's tokens), bf16 compute on f32 params
    restacked from phase 5's weights: GPipe and 1F1B, 20 steps each, with
    each run's launches, step times and peak allocation; then a float32
    two-layer copy at pp 2 whose 1F1B gradients must equal the unpipelined
    reference-attention gradients."""
    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    pipe = PL.StackedPipe(PIPE_PP)
    stacked = WT.restack_for_pipeline(tree, cfg, PIPE_PP)
    tokens = trained["tokens"].view(PIPE_MICRO, -1, trained[
        "tokens"].shape[-1])
    out = {"pp": PIPE_PP, "micro": PIPE_MICRO, "mb": tokens.shape[1]}
    per_mb = cfg.n_layers * PIPE_MICRO * TRAIN_STEPS
    want_launches = {
        "gpipe": dict.fromkeys((k.symbol for k in kerns), per_mb),
        "1f1b": {kerns[0].symbol: 2 * per_mb - per_mb // PIPE_PP,
                 kerns[1].symbol: per_mb, kerns[2].symbol: per_mb},
    }
    for schedule in ("gpipe", "1f1b"):
        params = WT.pipeline_params_from_jax(stacked, cfg, PIPE_PP,
                                             device=dev)
        step, _ = TP.make_pipeline_transformer_step(
            cfg, pipe, n_micro=PIPE_MICRO, schedule=schedule, device=dev)
        state = W.AdamW(1e-3).init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in kerns:
            kern.launches = 0
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(step(params, state, tokens)[2].item())
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        launches = {k.symbol: k.launches for k in kerns}
        peak = torch.cuda.max_memory_allocated()
        del params, state
        # the schedule's own live set: one loss-and-gradients pass from
        # fresh params, its peak above them (no optimizer state)
        params = WT.pipeline_params_from_jax(stacked, cfg, PIPE_PP,
                                             device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        TP.pipeline_loss_and_grads(pipe, cfg, params, tokens, schedule)
        torch.cuda.synchronize()
        pass_peak = torch.cuda.max_memory_allocated() - base
        del params
        p50 = float(np.median(times) * 1e3)
        gap0 = abs(losses[0] - trained["losses"][0])
        print(f"pipeline {schedule} pp {PIPE_PP}, {PIPE_MICRO} x "
              f"[{tokens.shape[1]},256] bf16, {TRAIN_STEPS} steps: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, |step-0 loss - phase 5| "
              f"{gap0:.4g}, step p50 {p50:.2f} ms (phase 5 "
              f"{train['step_ms_p50']:.2f}), peak allocation "
              f"{peak / 2**20:.1f} MiB (one loss-and-gradients pass: "
              f"{pass_peak / 2**20:.1f} MiB above the params), launches "
              f"{launches}")
        print(f"pipeline {schedule} losses "
              + " ".join(f"{x:.4f}" for x in losses))
        if launches != want_launches[schedule]:
            fail(f"pipeline {schedule} launches {launches}, want "
                 f"{want_launches[schedule]}")
        if not gap0 <= PIPE_STEP0_TOL:
            fail(f"pipeline {schedule} step-0 loss vs phase 5: {gap0}")
        if not all(np.isfinite(losses)) or not losses[-1] < 0.9 * losses[0]:
            fail(f"pipeline {schedule} losses {losses[0]} -> {losses[-1]}")
        out[schedule] = dict(losses=losses, loss_first=losses[0],
                             loss_last=losses[-1],
                             step0_gap_vs_phase5=gap0, step_ms_p50=p50,
                             peak_allocated_bytes=peak,
                             grad_pass_peak_above_params_bytes=pass_peak,
                             launches=launches)
    gap = float(np.max(np.abs(np.asarray(out["1f1b"]["losses"])
                              - np.asarray(out["gpipe"]["losses"]))))
    peaks = (out["1f1b"]["peak_allocated_bytes"],
             out["gpipe"]["peak_allocated_bytes"])
    print(f"pipeline 1f1b vs gpipe: max|loss gap| {gap:.4g}, peak "
          f"allocation {peaks[0] / 2**20:.1f} vs {peaks[1] / 2**20:.1f} MiB")
    if not gap <= PIPE_SCHEDULE_TOL:
        fail(f"pipeline 1f1b losses vs gpipe: {gap}")
    if not peaks[0] <= peaks[1]:
        fail(f"pipeline 1f1b peak allocation {peaks[0]} > gpipe's "
             f"{peaks[1]}")
    out["max_abs_loss_gap_1f1b_vs_gpipe"] = gap

    # float32 two-layer copy at pp 2: 1F1B's gradients against the
    # unpipelined reference-attention ones
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    tree32 = dict(tree, layers=tree["layers"][:2])
    rng = np.random.default_rng(SEED + 20)
    tok32 = torch.tensor(rng.integers(0, cfg.vocab, size=(4, 201)),
                         device=dev)
    flat = W.params_from_jax(tree32, cfg32, device=dev, dtype=torch.float32)
    ref_loss, g_ref = W.loss_and_grads(
        flat, tok32, dataclasses.replace(cfg32, attn="reference"), dev)
    g_ref = WT.restack_for_pipeline(g_ref, cfg32, 2)
    p2 = WT.pipeline_params_from_jax(WT.restack_for_pipeline(tree32, cfg32,
                                                             2),
                                     cfg32, 2, device=dev)
    loss, got = TP.pipeline_loss_and_grads(
        PL.StackedPipe(2), cfg32, p2, tok32.view(2, 2, -1), "1f1b")
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(_flat({k: got[k] for k in g_ref}),
                                   _flat(g_ref)))
    loss_gap = abs(loss.item() - ref_loss.item())
    print(f"pipeline f32 2-layer pp 2, 2 x [2,200], 1f1b: |loss - "
          f"reference| {loss_gap:.3g}, max leaf gradient error vs the "
          f"unpipelined reference path {grad_err:.3g} (relative to the "
          "leaf's largest)")
    if not (grad_err <= TRAIN_GRAD_F32_TOL
            and loss_gap <= TRAIN_GRAD_F32_TOL * ref_loss.item()):
        fail(f"pipeline f32 1f1b vs reference: gradients {grad_err}, loss "
             f"{loss_gap}")
    out["f32"] = dict(grad_rel_err=grad_err, loss_gap=loss_gap)
    out["launches"] = {k.symbol: out["gpipe"]["launches"][k.symbol]
                       + out["1f1b"]["launches"][k.symbol] for k in kerns}
    return out


def run_sharded_decode(torch, W, P, Q, G, cfg, dev, tmp) -> dict:
    """Phase 21: ``generate(..., mesh=make_mesh(1))`` at the small preset
    with rope and GQA (2 kv heads): batch 8, a 32-token prompt, 128 new
    tokens; greedy streams equal ``generate()``'s on the same params, in
    bf16, on a float32 copy and on int8 weights; tokens/s of both."""
    c16 = dataclasses.replace(cfg, pos="rope", n_kv_heads=2)
    tree = W.random_tree(c16, SEED)
    c32 = dataclasses.replace(c16, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 21)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, size=(
        DECODE_BATCH, DECODE_PROMPT)), device=dev)
    runs = (
        ("bf16", c16, lambda: W.params_from_jax(tree, c16, device=dev)),
        ("f32", c32, lambda: W.params_from_jax(tree, c32, device=dev)),
        ("int8", c16, lambda: Q.quantize_params(W.params_from_jax(
            tree, c16, device=dev, dtype=torch.float32))),
    )
    out = {}

    def rate(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = fn()
        torch.cuda.synchronize()
        return toks, DECODE_BATCH * DECODE_NEW / (time.perf_counter() - t0)

    with one_rank_world(tmp, "decode_store"):
        mesh = P.make_mesh(1)
        for label, c, load in runs:
            params = load()
            local = P.shard_params(params, mesh, c,
                                   G.decode_shardings(mesh, c, params)[0])
            want, plain = rate(lambda: W.generate(params, prompt, c,
                                                  DECODE_NEW, device=dev))
            got, sharded = rate(lambda: W.generate(
                local, prompt, c, DECODE_NEW, device=dev, mesh=mesh))
            same = bool(torch.equal(got, want))
            print(f"sharded decode {label} world 1, small preset rope GQA "
                  f"g2 [{DECODE_BATCH}, {DECODE_PROMPT} + {DECODE_NEW}] "
                  f"greedy: equal to generate(): {same}; {sharded:.1f} "
                  f"tokens/s (generate() {plain:.1f})")
            if not same or tuple(got.shape) != (
                    DECODE_BATCH, DECODE_PROMPT + DECODE_NEW):
                fail(f"sharded decode {label}: stream differs from "
                     "generate()'s")
            out[label] = dict(streams_equal=same, tokens_per_s=sharded,
                              generate_tokens_per_s=plain)
            del params, local
        # what a decode step adds: 2 reduce_from a layer (after wo and w2),
        # each a one-rank all-reduce of the rows' activations
        view = P.local_view(mesh)
        x = torch.zeros((DECODE_BATCH, 1, cfg.d_model), dtype=cfg.dtype,
                        device=dev)
        ts = []
        for _ in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            P.reduce_from(x, view.tp)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out["reduce_from_host_ms"] = float(np.median(ts[5:]))
        out["reduce_from_a_step"] = 2 * cfg.n_layers
    print(f"sharded decode: one reduce_from of [{DECODE_BATCH},1,"
          f"{cfg.d_model}] {out['reduce_from_host_ms']:.4g} ms of host time "
          f"(synchronized, median of 20), {out['reduce_from_a_step']} a "
          "decode step")
    return out


def _streams_and_rate(torch, W, eng, prompts, kinds, new_tokens):
    """(streams, tokens/s) of ``prompts`` served on ``eng``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = serve(W, eng, prompts, kinds, new_tokens)
    torch.cuda.synchronize()
    return streams, len(prompts) * new_tokens / (time.perf_counter() - t0)


def run_tp_serving(torch, W, PT, SP, cfg, tree, srv, dev, tmp) -> dict:
    """Phase 22: the tensor-parallel ServingEngine over a one-rank NCCL
    mesh (``make_serving_mesh(mp=1)``): phase 4's 16 requests, whose
    streams must equal a plain engine's on the same gather path
    (``paged_kernel=False``), in bf16 at the small preset and on a float32
    two-layer copy; tokens/s beside that engine's and phase 4's. Then the
    paged-kernel rule at phase 4's shape, which phase 4's engine must have
    resolved on through."""
    n_req, new_tokens = 16, 64
    prompts, kinds = _serving_requests(cfg, SEED + 4)
    out = {}
    with one_rank_world(tmp, "tp_serving_store"):
        mesh = PT.make_serving_mesh(mp=1)
        out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        for label, c, n_layers in (("bf16", cfg, cfg.n_layers),
                                   ("f32", dataclasses.replace(
                                       cfg, n_layers=2, dtype=torch.float32),
                                    2)):
            params = W.params_from_jax(
                dict(tree, layers=tree["layers"][:n_layers]), c, device=dev)
            rows = {}
            for name, kw in (("tp", dict(mesh=mesh)),
                             ("gather", dict(paged_kernel=False))):
                eng = W.ServingEngine(params, c, slots=8, max_len=512,
                                      prompt_buckets=(16, 64, 256),
                                      device=dev, **kw)
                if eng.paged_kernel:
                    fail(f"tp serving {label} {name}: the paged kernel is on")
                rows[name] = _streams_and_rate(torch, W, eng, prompts, kinds,
                                               new_tokens)
                if eng.used_blocks != 0:
                    fail(f"tp serving {label} {name}: {eng.used_blocks} "
                         "pool blocks leaked")
                del eng
            same = rows["tp"][0] == rows["gather"][0]
            gap = sum(a != b for x, y in zip(rows["tp"][0], rows["gather"][0])
                      for a, b in zip(x, y))
            print(f"tp serving {label} world 1 (mp 1), small preset width, "
                  f"{n_layers} layers, {n_req} requests x {new_tokens} "
                  f"tokens: streams equal to the gather-path engine's: "
                  f"{same} (tokens that differ: {gap}); {rows['tp'][1]:.1f} "
                  f"tokens/s (gather engine {rows['gather'][1]:.1f}, phase 4 "
                  f"paged {srv['tokens_per_s']:.1f})")
            if not same:
                fail(f"tp serving {label}: streams differ from the "
                     "gather-path engine's")
            for i, st in enumerate(rows["tp"][0]):
                if len(st) != new_tokens or not all(
                        0 <= t < c.vocab for t in st):
                    fail(f"tp serving {label} request {i}: stream {st[:4]}")
            out[label] = dict(streams_equal=same, tokens_differing=gap,
                              tokens_per_s=rows["tp"][1],
                              gather_tokens_per_s=rows["gather"][1],
                              phase4_paged_tokens_per_s=srv["tokens_per_s"])
            del params
    est = SP.decode_step_traffic(cfg, slots=8, seq_len=512,
                                 block_size=srv["block_size"], max_len=512)
    rule = SP.recommend_paged_kernel(cfg, interpret=False, slots=8,
                                     seq_len=512,
                                     block_size=srv["block_size"])
    calls = srv["paged_rule_calls"]
    print(f"paged-kernel rule at phase 4's shape (8 slots, max_len 512, "
          f"block {srv['block_size']}, bf16): modeled gather/paged KV-byte "
          f"ratio {est['kv_bytes_ratio']} (threshold "
          f"{SP.PAGED_DEFAULT_MIN_RATIO}): {'on' if rule else 'off'}; "
          f"phase 4's engine asked it {len(calls)}x and resolved "
          f"{srv['paged_kernel']}")
    if not (rule and srv["paged_kernel"] and len(calls) == 1
            and calls[0]["resolved"] and not calls[0]["interpret"]):
        fail(f"phase 4's paged_kernel did not resolve on through the rule: "
             f"{calls}")
    out["paged_rule"] = dict(kv_bytes_ratio=est["kv_bytes_ratio"],
                             decision=rule, phase4_calls=calls)
    return out


def run_runner_mesh(torch, A, R, D, runtime, dev, tmp) -> dict:
    """Phase 23: ``runner.main`` through the join path over a one-rank
    NCCL group, on phase 6's token file: phase 6's train flags (losses
    and evals equal to phase 6's), the same with ``--zero1
    --master-weights`` (equal to that run on the single-device path,
    since master weights start from the bf16-rounded params as JAX's
    do), and decode ``--dp 1 --tp 1`` from the first run's checkpoint
    (phase 6's decode tail). ``--pp 2`` needs two cards: refused here,
    and not measured."""
    import io
    import shutil

    from elastic_tpu_agent_torch.workloads import telemetry as T

    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    saved = {k: os.environ.pop(k, None) for k in RUNTIME_ENV}
    os.environ["ELASTIC_TPU_ENV_FILE"] = os.path.join(tmp, "no-env-file")
    out = {"launches": dict.fromkeys((k.symbol for k in kerns), 0)}
    ph6 = runtime["train"]
    n_layers = SMALL["n_layers"]
    want = {"flash_fwd": n_layers * (1 + RUNTIME_STEPS + 2 * EVAL_BATCHES),
            "flash_bwd_dkdv": n_layers * (1 + RUNTIME_STEPS),
            "flash_bwd_dq": n_layers * (1 + RUNTIME_STEPS)}

    def joined(argv, label):
        for kern in kerns:
            kern.launches = 0
        rep = _runner(R, argv, dev)
        torch.cuda.synchronize()
        launches = {k.symbol: k.launches for k in kerns}
        if launches != want:
            fail(f"runner mesh {label} launches {launches}, want {want}")
        for k, n in launches.items():
            out["launches"][k] += n
        if rep["devices"] != 1 or rep["mesh"] != {
                "dp": 1, "sp": 1, "tp": 1, "ep": 1}:
            fail(f"runner mesh {label}: devices {rep['devices']}, mesh "
                 f"{rep['mesh']}")
        return rep

    def gaps(a, b):
        ev = [abs(x - y) for x, y in zip(a["eval_losses"], b["eval_losses"])]
        return max([abs(a["final_loss"] - b["final_loss"])] + ev)

    def losses(rep):
        return dict(final_loss=rep["final_loss"],
                    eval_losses=[e["loss"] for e in rep.get("eval", [])],
                    step_time_ms=rep["step_time_ms"])

    try:
        base = _runtime_data(D, os.path.join(tmp, "tokens.bin"))
        ck = os.path.join(tmp, "ck")
        fr = os.path.join(tmp, "fr_mesh.jsonl")
        with one_rank_world(tmp, "runner_store"):
            plain = joined(f"{base} {RUNTIME_TRAIN} --checkpoint-dir {ck} "
                           f"--checkpoint-every 10 --flight-recorder {fr}",
                           "plain")
            mw = joined(f"{base} {RUNTIME_TRAIN} --zero1 --master-weights",
                        "zero1+master_weights")
            dec = _runner(R, "--mode decode --preset small --batch 8 "
                          f"--prompt-len 32 --new-tokens 64 --checkpoint-dir "
                          f"{ck} --dp 1 --tp 1", dev)
            # refused for its launch shape: two stages need two cards
            err = io.StringIO()
            try:
                with contextlib.redirect_stderr(err):
                    R.main(f"{base} --steps 1 --pp 2".split(), device=dev)
                fail("runner --pp 2 ran on one card")
            except SystemExit as e:
                if e.code != 2 or "one process per card" not in (
                        err.getvalue()):
                    fail(f"runner --pp 2 exited {e.code} without the "
                         f"launch-shape refusal: {err.getvalue()[-300:]}")
        # the same master-weight run on the single-device path (no group)
        mw_one = _runner(R, f"{base} {RUNTIME_TRAIN} --zero1 "
                         "--master-weights", dev)
        shutil.rmtree(ck)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # the saves gather leaf by leaf into pinned host memory (phase 6's
    # copy the whole trees from the card at once)
    saves = [r["duration_ms"] for r in T.load_jsonl(fr)
             if r["kind"] == "checkpoint_save"]
    out["plain"], out["zero1+master_weights"] = losses(plain), losses(mw)
    out["plain"]["checkpoint_save_ms"] = saves
    out["single_device_zero1+master_weights"] = losses(mw_one)
    gap_plain = gaps(out["plain"], ph6)
    gap_mw = gaps(out["zero1+master_weights"],
                  out["single_device_zero1+master_weights"])
    print(f"runner mesh (join path, world 1): devices {plain['devices']}, "
          f"mesh {plain['mesh']}; phase 6's flags: final loss "
          f"{plain['final_loss']:.6f}, evals {out['plain']['eval_losses']}, "
          f"max gap to phase 6 {gap_plain:.3g} (limit {MESH_TOL}); "
          f"step_time_ms {plain['step_time_ms']:.2f} (phase 6 "
          f"{ph6['step_time_ms']:.2f}), checkpoint saves {saves} ms (phase "
          f"6 {ph6['checkpoint_save_ms']})")
    print(f"runner mesh --zero1 --master-weights: final loss "
          f"{mw['final_loss']:.6f}, max gap to the single-device run "
          f"{gap_mw:.3g} (limit {MESH_TOL}); step_time_ms "
          f"{mw['step_time_ms']:.2f} (single-device "
          f"{mw_one['step_time_ms']:.2f})")
    if not gap_plain <= MESH_TOL:
        fail(f"runner mesh losses vs phase 6: {gap_plain}")
    if not gap_mw <= MESH_TOL:
        fail(f"runner mesh zero1+master_weights vs single device: {gap_mw}")
    same = dec["sample_tail"] == runtime["decode"]["sample_tail"]
    print(f"runner mesh decode --dp 1 --tp 1: mesh {dec['mesh']}, tail "
          f"{dec['sample_tail']} equal to phase 6's: {same}; "
          f"{dec['decode_tokens_per_s']} tokens/s (phase 6 "
          f"{runtime['decode']['decode_tokens_per_s']})")
    if not same or dec["restored_step"] != RUNTIME_STEPS - 1:
        fail(f"runner mesh decode tail {dec['sample_tail']} (step "
             f"{dec['restored_step']}) vs phase 6's "
             f"{runtime['decode']['sample_tail']}")
    print("runner --pp 2: refused on one card (two stages need two cards); "
          "its step time is not measured")
    out.update(max_gap_vs_phase6=gap_plain, max_gap_mw=gap_mw,
               decode=dict(mesh=dec["mesh"], sample_tail=dec["sample_tail"],
                           tail_equal=same,
                           tokens_per_s=dec["decode_tokens_per_s"]),
               pp2="not measured: one card", devices=plain["devices"],
               mesh=plain["mesh"])
    return out


# -- phase 24: the device layer; the quota and four co-located tenants -------

SHARE_TENANTS = 4               # two phase-6 train runs, two phase-4 engines
PROBE_PERCENT = 10              # the quota probe's grant, in % of the card
SAMPLE_PERIOD_S = 0.5           # nvidia-smi utilization polls
IDLE_WINDOW_S = 3.0
TENANT_TIMEOUT_S = 300.0
# env keys a tenant must not inherit from this process: its env file
# carries the allocation
TENANT_ENV_STRIP = RUNTIME_ENV + ("CUDA_VISIBLE_DEVICES",
                                  "ELASTIC_TPU_CORE_UNITS",
                                  "ELASTIC_TPU_HBM_LIMIT_BYTES")
KERNEL_NAMES = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                "paged_decode")


def _uuid_key(uuid) -> str:
    """nvidia-smi's "GPU-<uuid>" and torch's "<uuid>" compare equal."""
    s = str(uuid).strip().lower()
    return s[4:] if s.startswith("gpu-") else s


def _quota() -> dict:
    """This process's allocation, as its env file set it."""
    env = os.environ
    return dict(visible=env.get("CUDA_VISIBLE_DEVICES"),
                core_units=int(env.get("ELASTIC_TPU_CORE_UNITS", "0")),
                hbm_limit_bytes=int(env.get("ELASTIC_TPU_HBM_LIMIT_BYTES",
                                            "0")),
                hbm_fraction=float(env.get("ELASTIC_TPU_HBM_FRACTION",
                                           "0")))


def _await_go(barrier: str, poll=None) -> float:
    """Announce this tenant ready in ``barrier`` and wait for the parent's
    ``go`` (so that the tenants of a window start their work together),
    calling ``poll`` meanwhile; returns the wall time of the start. No
    barrier: start at once."""
    if barrier:
        open(os.path.join(barrier, f"{os.getpid()}.ready"), "w").close()
        deadline = time.time() + TENANT_TIMEOUT_S
        while not os.path.exists(os.path.join(barrier, "go")):
            if time.time() > deadline:
                raise TimeoutError(f"no go in {barrier}")
            if poll is not None:
                poll()
            time.sleep(0.01)
    return time.time()


def _tenant_tail(torch, dev, launches, work_start) -> dict:
    props = torch.cuda.get_device_properties(dev)
    return dict(launches=launches, work_start=work_start,
                work_end=time.time(), device_uuid=_uuid_key(props.uuid),
                dev_nodes=sorted(n for n in os.listdir("/dev")
                                 if n.startswith("nvidia")),
                device_count=torch.cuda.device_count(),
                total_memory=props.total_memory,
                max_memory_reserved=torch.cuda.max_memory_reserved(dev),
                max_memory_allocated=torch.cuda.max_memory_allocated(dev))


@contextlib.contextmanager
def _busy_profile(torch, on: bool):
    """With ``on``, torch.profiler around the block: yields a dict that
    gets the block's wall-clock start and end and the device time of its
    kernels (``busy_us``, and ``busy_share`` of the wall time; None when
    the profiler saw no device time). Without, an empty dict. Device
    activity only: a trace of every host op of a whole run takes the
    profiler minutes to fold."""
    out: dict = {}
    if not on:
        yield out
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out["start"] = time.time()
        yield out
        torch.cuda.synchronize()
        out["end"] = time.time()
    busy_us = sum(_device_us(e) for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU)
    out["busy_us"] = busy_us
    out["busy_share"] = (busy_us / ((out["end"] - out["start"]) * 1e6)
                         if busy_us else None)


REP_REPORT_S = 2.0              # a phase-30 tenant's usage report period


def _busy_ns(prof) -> int:
    """Nanoseconds in which any device activity of this process ran during
    a stopped torch.profiler window (the union of its kernels' and copies'
    spans, as CUPTI timed them)."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() != DeviceType.CPU)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


class _UsageReporter:
    """A phase-30 tenant's own device-busy share, written at least
    REP_REPORT_S apart through ``telemetry.write_usage_report`` into the
    pod's alloc dir: the device time torch.profiler (CUPTI, device
    activity only) saw of this process in the window, over the window's
    wall time, x 100. A step timed by CUDA events would not do: the steps
    are host-bound, so events around one span the host's launches and the
    device's idle gaps between them. The windows turn in the thread that
    does the work, between its steps (``poll``); turning one (the
    profiler's stop) is not timed by any window."""

    def __init__(self):
        self.alloc = os.environ["ELASTIC_TPU_ALLOC_DIR"]
        self.hash = os.environ["TPU"]
        self.reports = []
        self._start()

    def _start(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.time()

    def poll(self, restart=True):
        """Close the window once REP_REPORT_S has passed (at once with
        ``restart`` False) and write its share."""
        from elastic_tpu_agent_torch.workloads import telemetry as T

        if restart and time.time() - self._t0 < REP_REPORT_S:
            return
        self._prof.stop()
        t1 = time.time()
        share = 100.0 * _busy_ns(self._prof) / ((t1 - self._t0) * 1e9)
        T.write_usage_report(self.alloc, self.hash, share, ts=t1)
        self.reports.append((round(t1, 3), round(share, 3)))
        if restart:
            self._start()

    def close(self) -> list:
        self.poll(restart=False)
        return self.reports


def _hold(hold, rep, reporter) -> None:
    """Phase 30: the work's report in ``hold/<pid>.done``, then stay up
    (idle, still reporting) until ``hold/stop`` exists."""
    _write_json(os.path.join(hold, f"{os.getpid()}.done"), rep)
    deadline = time.time() + TENANT_TIMEOUT_S
    while not os.path.exists(os.path.join(hold, "stop")):
        if time.time() > deadline:
            raise TimeoutError(f"no stop in {hold}")
        reporter.poll()
        time.sleep(0.05)


def tenant_main(args) -> int:
    """A child of phases 24-30: prints one JSON line. ``discover`` runs
    ``NvidiaOperator("/dev")`` without torch; the others wait at
    ``--barrier`` (if given) and then apply the env file named by
    $ELASTIC_TPU_ENV_FILE as the runner does, before CUDA starts:
    ``probe`` allocates below and above its HBM quota, ``train`` runs
    ``runner.main`` on ``--runner-args``, ``train2`` (phase 29) runs it on
    ``--runner-args``, waits at ``--barrier2`` and runs it on
    ``--runner-args2``, ``serve`` runs phase 4's 16 requests on the
    kernel-path engine. ``--profile-busy`` puts torch.profiler around the
    first run or the requests (``_busy_profile``). ``--usage-report``
    (phase 30) writes the tenant's measured device-busy share every
    REP_REPORT_S (``_UsageReporter``), and ``--hold DIR`` keeps a train or
    serve tenant up after its work until ``DIR/stop`` (``_hold``)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.tenant == "discover":
        from elastic_tpu_agent_torch.device import NvidiaOperator

        op = NvidiaOperator("/dev", maintenance=lambda: None,
                            preemption=lambda: None)
        t0 = time.perf_counter()
        chips = op.devices()
        smi_ms = (time.perf_counter() - t0) * 1e3
        topo = op.topology
        torch_mod = sys.modules.get("torch")
        print(json.dumps(dict(
            chips=[dict(dataclasses.asdict(c), minor=op.minor_of(c.index))
                   for c in chips],
            healthy=sorted(op.healthy_indexes()),
            reasons=op.health_reasons(), utilization=op.utilization(),
            driver=op.driver_version, smi_ms=smi_ms,
            topology=None if topo is None else dict(
                dataclasses.asdict(topo), is_multi_host=topo.is_multi_host),
            torch_imported=torch_mod is not None,
            cuda_initialized=bool(torch_mod is not None
                                  and torch_mod.cuda.is_initialized()))))
        return 0

    import io

    import torch

    from elastic_tpu_agent_torch import workloads as W
    from elastic_tpu_agent_torch.workloads import attention as A
    from elastic_tpu_agent_torch.workloads import paged_attention as PA
    from elastic_tpu_agent_torch.workloads import runner as R

    torch.backends.cuda.matmul.allow_tf32 = False
    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ, PA.PAGED_DECODE)
    reporter = None
    if args.usage_report:
        # the card's context first (the visibility env is the process's
        # own); the reports start before the work, and turn with the
        # runner's steps and the engine's
        from elastic_tpu_agent_torch.workloads import telemetry as T

        R.load_alloc_env()
        torch.zeros(1, device="cuda")
        reporter = _UsageReporter()
        step = T.FlightRecorder.step

        @contextlib.contextmanager
        def polled(self, *a, **k):
            with step(self, *a, **k) as timer:
                yield timer
            reporter.poll()

        T.FlightRecorder.step = polled
    work_start = _await_go(args.barrier,
                           reporter.poll if reporter is not None else None)
    if args.tenant == "train2":
        runs = []
        for i, argv in enumerate((args.runner_args, args.runner_args2)):
            if i:
                _await_go(args.barrier2)
            for k in kerns:
                k.launches = 0
            buf = io.StringIO()
            with _busy_profile(torch, args.profile_busy and not i) as busy:
                with contextlib.redirect_stdout(buf):
                    rc = R.main(argv.split())   # device "cuda"
                torch.cuda.synchronize()
            runs.append(dict(
                rc=rc, busy=busy,
                report=json.loads(buf.getvalue().strip().splitlines()[-1]),
                launches={k.symbol: k.launches for k in kerns}))
        total = {k.symbol: sum(r["launches"][k.symbol] for r in runs)
                 for k in kerns}
        print(json.dumps(dict(runs=runs, quota=_quota(), **_tenant_tail(
            torch, torch.device("cuda", 0), total, work_start))))
        return max(r["rc"] for r in runs)
    if args.tenant == "train":
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = R.main(args.runner_args.split())   # device "cuda"
        torch.cuda.synchronize()
        rep = dict(rc=rc, report=json.loads(
            buf.getvalue().strip().splitlines()[-1]), quota=_quota(),
            **_tenant_tail(torch, torch.device("cuda", 0),
                           {k.symbol: k.launches for k in kerns}, work_start))
        if args.hold:
            _hold(args.hold, rep, reporter)
        if reporter is not None:
            rep["usage_reports"] = reporter.close()
        print(json.dumps(rep))
        return rc

    R.load_alloc_env()
    dev = torch.device("cuda", 0)
    R.apply_hbm_quota(dev)
    quota = _quota()
    if args.tenant == "probe":
        mib = 1 << 20
        out = dict(quota=quota)
        below = quota["hbm_limit_bytes"] - 512 * mib
        above = quota["hbm_limit_bytes"] + 256 * mib
        x = torch.empty(below, dtype=torch.uint8, device=dev)
        torch.cuda.synchronize()
        out["below_bytes"], out["below_ok"] = below, True
        del x
        torch.cuda.empty_cache()
        out["above_bytes"], out["above_raised"] = above, False
        try:
            y = torch.empty(above, dtype=torch.uint8, device=dev)
            torch.cuda.synchronize()
            del y
        except torch.cuda.OutOfMemoryError as e:
            out["above_raised"] = True
            out["above_error"] = str(e).splitlines()[0][:200]
        out.update(_tenant_tail(torch, dev, {}, work_start))
        print(json.dumps(out))
        return 0

    cfg = W.ModelConfig(**SMALL, max_seq=1024, dtype=torch.bfloat16)
    params = W.params_from_jax(W.random_tree(cfg, SEED), cfg, device=dev)
    prompts, kinds = _serving_requests(cfg, SEED + 4)
    obs = metrics = None
    if args.tenant == "serve_obs":
        # phase 27: the engine's stats and request observatory on the
        # port's AgentMetrics, served on a loopback port of its own
        from prometheus_client import CollectorRegistry

        from elastic_tpu_agent_torch.metrics import AgentMetrics
        from elastic_tpu_agent_torch.workloads import request_obs as RO

        obs = RO.RequestObservatory()
        metrics = AgentMetrics(registry=CollectorRegistry())
        metrics.attach_requests(obs)
        metrics.serve(0)
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), device=dev,
                          observatory=obs)
    if reporter is not None:
        engine_step = eng.step

        def step_polled(*a, **k):
            out = engine_step(*a, **k)
            reporter.poll()
            return out

        eng.step = step_polled
    for k in kerns:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _busy_profile(torch, args.profile_busy) as busy:
        streams = serve(W, eng, prompts, kinds, 64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    extra = {"busy": busy} if busy else {}
    if metrics is not None:
        metrics.attach_serving(eng.stats)
        base = f"http://127.0.0.1:{metrics.http_port}"
        got = _samples(_http(base + "/metrics")[1])
        st = eng.stats()
        extra["serving_families"] = {
            name: [got.get((name, ())), _stat(st, path)]
            for name, path in SERVING_FAMILIES.items()}
        reqs = _http_json(base + "/debug/requests?limit=1000")
        extra["requests"] = dict(records=len(reqs["requests"]),
                                 finished=reqs["finished"],
                                 total=reqs["requests_total"])
        metrics.close()
    rep = dict(
        streams=streams, tokens_per_s=sum(map(len, streams)) / wall,
        wall_s=wall, decode_steps=eng.decode_steps_total,
        paged_kernel=eng.paged_kernel, quota=quota, **extra,
        **_tenant_tail(torch, dev, {k.symbol: k.launches for k in kerns},
                       work_start))
    if args.hold:
        _hold(args.hold, dict(wall_s=wall, work_end=rep["work_end"]),
              reporter)
    if reporter is not None:
        rep["usage_reports"] = reporter.close()
    print(json.dumps(rep))
    return 0


class _Tenant:
    """One child process of phase 24, its output in files under ``tmp``."""

    def __init__(self, name, kind, tmp, env_file=None, runner_args=None,
                 barrier=None, env=None, strip=TENANT_ENV_STRIP, wrap=None,
                 runner_args2=None, barrier2=None, profile_busy=False,
                 usage_report=False, hold=None):
        self.name = name
        self.out = os.path.join(tmp, f"{name}.out")
        self.err = os.path.join(tmp, f"{name}.err")
        child_env = {k: v for k, v in os.environ.items() if k not in strip}
        child_env.update(env or {})
        child_env["ELASTIC_TPU_ENV_FILE"] = env_file or os.path.join(
            tmp, "no-env-file")
        env = child_env
        argv = [sys.executable, os.path.abspath(__file__), "--tenant", kind]
        if runner_args:
            argv += ["--runner-args", runner_args]
        if barrier:
            argv += ["--barrier", barrier]
        if runner_args2:
            argv += ["--runner-args2", runner_args2]
        if barrier2:
            argv += ["--barrier2", barrier2]
        if profile_busy:
            argv += ["--profile-busy"]
        if usage_report:
            argv += ["--usage-report"]
        if hold:
            argv += ["--hold", hold]
        if wrap:
            argv = wrap(argv)
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(argv, stdout=out, stderr=err,
                                         env=env, cwd=os.path.dirname(
                                             os.path.abspath(__file__)))
        self.t0 = time.perf_counter()

    def result(self, deadline: float) -> dict:
        """Wait until ``deadline`` (perf_counter), kill on a timeout; the
        child's JSON line, or {} after a failure (recorded)."""
        try:
            rc = self.proc.wait(timeout=max(1.0,
                                            deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            self.kill()
            rc = "timeout"
        seconds = time.perf_counter() - self.t0
        with open(self.out) as f:
            lines = f.read().strip().splitlines()
        if rc != 0 or not lines:
            with open(self.err) as f:
                tail = f.read()[-1500:]
            fail(f"tenant {self.name} exited {rc}: {tail}")
            return {}
        rep = json.loads(lines[-1])
        rep["seconds"] = seconds
        return rep

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class _Sampler:
    """Polls ``op.utilization()`` about every SAMPLE_PERIOD_S in a thread,
    each sample tagged with the window it fell in."""

    def __init__(self, op, index):
        import threading

        self.op, self.index = op, index
        self.window = "idle"
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            entry = self.op.utilization().get(self.index, {})
            self.samples.append((self.window, time.time(), entry))
            self._stop.wait(max(0.0, SAMPLE_PERIOD_S
                                - (time.perf_counter() - t0)))

    def close(self):
        self._stop.set()
        self._thread.join(timeout=60)

    def stats(self, window, span=None) -> dict:
        """Duty-cycle p50 and max and hbm_used max over the window's
        samples, or over those inside ``span`` (wall-clock start, end)."""
        got = [e for w, t, e in self.samples if w == window
               and (span is None or span[0] <= t <= span[1])]
        duty = [e["duty_cycle_percent"] for e in got
                if "duty_cycle_percent" in e]
        used = [e["hbm_used_bytes"] for e in got if "hbm_used_bytes" in e]
        return dict(samples=len(got), errors=len(got) - len(duty),
                    duty_p50=float(np.median(duty)) if duty else None,
                    duty_max=max(duty) if duty else None,
                    hbm_used_max=max(used) if used else None)


def _write_env(path, env: dict) -> None:
    with open(path, "w") as f:
        f.writelines(f"{k}={v}\n" for k, v in env.items())


def run_device_share(torch, D, srv, streams, runtime, dev) -> dict:
    """Phase 24: the port's device layer on the card, then four tenants
    sharing it under fractional quotas (module docstring)."""
    import tempfile

    from elastic_tpu_agent_torch.device import NvidiaOperator
    from elastic_tpu_agent_torch.device import qos as QOS

    mib = 1 << 20
    props = torch.cuda.get_device_properties(dev)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_share_") as tmp:
        # discovery in a process that never starts CUDA
        disc = _Tenant("discover", "discover", tmp).result(
            time.perf_counter() + 120)
        chips = [c for c in disc.get("chips", [])
                 if _uuid_key(c["uuid"]) == _uuid_key(props.uuid)]
        if len(chips) != 1:
            fail(f"no discovered card has torch's uuid {props.uuid}: "
                 f"{disc.get('chips')}")
            return out
        chip = chips[0]
        idx = chip["index"]
        print(f"device discovery (nvidia-smi {disc['driver']}, one -q -x "
              f"call {disc['smi_ms']:.1f} ms): index {idx}, minor "
              f"{chip['minor']}, {chip['device_path']}, {chip['uuid']}, "
              f"{chip['cores']} SMs, hbm {chip['hbm_bytes']} B (torch "
              f"total_memory {props.total_memory}), extra "
              f"{chip['extra_paths']}, healthy {disc['healthy']}, reasons "
              f"{disc['reasons']}, topology {disc['topology']}; torch "
              f"imported {disc['torch_imported']}, CUDA initialized "
              f"{disc['cuda_initialized']}")
        if disc["cuda_initialized"] or disc["torch_imported"]:
            fail("the discovering process imported torch or started CUDA")
        if chip["cores"] != props.multi_processor_count:
            fail(f"cores {chip['cores']} vs {props.multi_processor_count}")
        if not chip["hbm_bytes"] >= props.total_memory:
            fail(f"hbm {chip['hbm_bytes']} < torch's {props.total_memory}")
        if set(disc["healthy"]) != {c["index"] for c in disc["chips"]} or \
                disc["reasons"]:
            fail(f"health {disc['healthy']}, reasons {disc['reasons']}")

        # links under a temp dev root, aimed at the card's node
        links = os.path.join(tmp, "dev")
        os.makedirs(links)
        op = NvidiaOperator(links, host_dev_scan_root="/dev", smi_ttl_s=0.0,
                            maintenance=lambda: None,
                            preemption=lambda: None)
        op.create(idx, "smoke-0")
        target = os.readlink(os.path.join(links, "elastic-tpu-smoke-0"))
        back = op.resolve("smoke-0")
        op.delete("smoke-0")
        gone = not op.check("smoke-0")
        print(f"device link: elastic-tpu-smoke-0 -> {target}, resolves to "
              f"{back}, deleted: {gone}")
        if target != f"/dev/nvidia{chip['minor']}" or back != idx or \
                not gone:
            fail(f"link {target} -> {back}, deleted {gone}")

        def env_file(name, percent, units):
            grant = chip["hbm_bytes"] // mib * percent // 100
            env = QOS.qos_env({}, hbm_limit_bytes=grant * mib,
                              chip_hbm_bytes=chip["hbm_bytes"],
                              core_units=units)
            env.update(QOS.visibility_env([SimpleNamespace(uuid=chip["uuid"])]))
            path = os.path.join(tmp, f"{name}.env")
            _write_env(path, env)
            return path

        # the quota probe: 10% of the card
        probe = _Tenant("probe", "probe", tmp, env_file(
            "probe", PROBE_PERCENT, PROBE_PERCENT)).result(
            time.perf_counter() + 120)
        if probe:
            q = probe["quota"]
            cap = q["hbm_fraction"] * probe["total_memory"]
            print(f"quota probe: {PROBE_PERCENT}% grant "
                  f"{q['hbm_limit_bytes']} B (fraction {q['hbm_fraction']}"
                  f", the allocator's cap {cap:.0f} B of torch's "
                  f"{probe['total_memory']}): {probe['below_bytes']} B "
                  f"allocated {probe['below_ok']}, {probe['above_bytes']} B "
                  f"raised OutOfMemoryError {probe['above_raised']}; sees "
                  f"{probe['device_count']} card, uuid matches "
                  f"{probe['device_uuid'] == _uuid_key(chip['uuid'])}")
            if not (probe["below_ok"] and probe["above_raised"]):
                fail("quota probe: the allocation above the quota did not "
                     "raise" if probe["below_ok"] else "below the quota "
                     "failed")
            if probe["device_uuid"] != _uuid_key(chip["uuid"]) or \
                    probe["device_count"] != 1:
                fail(f"probe saw {probe['device_count']} cards, "
                     f"{probe['device_uuid']}")
        out["probe"] = probe

        # four tenants at 25 core units and a quarter of the memory each
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        parent_reserved = torch.cuda.memory_reserved(dev)
        base = _runtime_data(D, os.path.join(tmp, "tokens.bin"))
        envs = {n: env_file(n, 100 // SHARE_TENANTS, 100 // SHARE_TENANTS)
                for n in ("T1", "T2", "T3", "T4")}

        def train(name, run):
            d = os.path.join(tmp, f"{name}-{run}")
            return _Tenant(name, "train", tmp, envs[name], (
                f"{base} {RUNTIME_TRAIN} --checkpoint-dir {d}/ckpt "
                f"--checkpoint-every 10 --flight-recorder {d}/fr.jsonl"),
                barrier=os.path.join(tmp, run))

        def start(tenants, run):
            """Release ``tenants`` together once each has imported."""
            barrier = os.path.join(tmp, run)
            deadline = time.perf_counter() + TENANT_TIMEOUT_S
            while len([f for f in os.listdir(barrier)
                       if f.endswith(".ready")]) < len(tenants):
                if time.perf_counter() > deadline or any(
                        t.proc.poll() is not None for t in tenants):
                    break
                time.sleep(0.01)
            open(os.path.join(barrier, "go"), "w").close()

        sampler = _Sampler(NvidiaOperator(
            os.path.join(tmp, "dev"), host_dev_scan_root="/dev",
            smi_ttl_s=0.0, maintenance=lambda: None,
            preemption=lambda: None), idx)
        alive = []
        try:
            for run in ("alone", "shared"):
                os.makedirs(os.path.join(tmp, run))
            time.sleep(IDLE_WINDOW_S)
            sampler.window = "t1_alone"
            alive = [train("T1", "alone")]
            start(alive, "alone")
            alone = alive[0].result(time.perf_counter() + TENANT_TIMEOUT_S)
            sampler.window = "all_four"
            alive = [train("T1", "shared"), train("T2", "shared")] + [
                _Tenant(n, "serve", tmp, envs[n],
                        barrier=os.path.join(tmp, "shared"))
                for n in ("T3", "T4")]
            start(alive, "shared")
            deadline = time.perf_counter() + TENANT_TIMEOUT_S
            reps = {t.name: t.result(deadline) for t in alive}
            sampler.window = "after"
        finally:
            for t in alive:
                t.kill()
            sampler.close()
        def span(reps):
            """From the first tenant's start of work to the last's end."""
            got = [r for r in reps if r]
            return (min(r["work_start"] for r in got),
                    max(r["work_end"] for r in got)) if got else (0, 0)

        windows = {w: sampler.stats(w) for w in ("idle", "t1_alone",
                                                 "all_four")}
        for w, reps_w in (("t1_alone", [alone]),
                          ("all_four", list(reps.values()))):
            windows[w]["working"] = sampler.stats(w, span(reps_w))
            windows[w]["working_s"] = span(reps_w)[1] - span(reps_w)[0]
        out.update(tenants={"T1_alone": alone, **reps}, windows=windows,
                   parent_reserved=parent_reserved)
        ph6 = runtime["train"]
        want6 = [ph6["final_loss"]] + ph6["eval_losses"]
        t1_ms = alone.get("report", {}).get("step_time_ms")
        for name, rep in out["tenants"].items():
            if not rep:
                continue
            q = rep["quota"]
            cap = q["hbm_fraction"] * rep["total_memory"]
            launches = rep["launches"]
            line = (f"tenant {name}: {q['core_units']} core units, quota "
                    f"{q['hbm_limit_bytes']} B (fraction "
                    f"{q['hbm_fraction']}), max reserved "
                    f"{rep['max_memory_reserved']} B of a cap of {cap:.0f} "
                    f"B, launches {launches}, {rep['seconds']:.1f} s")
            if rep["max_memory_reserved"] > cap:
                fail(f"tenant {name} reserved {rep['max_memory_reserved']} "
                     f"B over its cap {cap:.0f}")
            if rep["device_uuid"] != _uuid_key(chip["uuid"]):
                fail(f"tenant {name} ran on {rep['device_uuid']}")
            if "report" in rep:
                r = rep["report"]
                got = [r["final_loss"]] + [e["loss"] for e in r.get(
                    "eval", [])]
                gap = max(abs(a - b) for a, b in zip(got, want6)) \
                    if len(got) == len(want6) else float("inf")
                want = {"flash_fwd": SMALL["n_layers"] * (
                    1 + RUNTIME_STEPS + 2 * EVAL_BATCHES),
                    "flash_bwd_dkdv": SMALL["n_layers"] * (1 + RUNTIME_STEPS),
                    "flash_bwd_dq": SMALL["n_layers"] * (1 + RUNTIME_STEPS),
                    "paged_decode": 0}
                print(f"{line}; step_time_ms {r['step_time_ms']:.2f} (T1 "
                      f"alone {t1_ms:.2f}, phase 6 {ph6['step_time_ms']:.2f})"
                      f", losses {got}, max gap to phase 6 {gap:.3g} "
                      f"(limit {RESUME_TOL})")
                if not gap <= RESUME_TOL:
                    fail(f"tenant {name} losses {got} vs phase 6 {want6}")
                if launches != want or r["platform"] != "gpu":
                    fail(f"tenant {name} launches {launches}, want {want}")
            else:
                same = rep["streams"] == streams
                print(f"{line}; {rep['tokens_per_s']:.1f} tokens/s (phase "
                      f"4 {srv['tokens_per_s']:.1f}), streams equal phase "
                      f"4's: {same}")
                if not same:
                    fail(f"tenant {name} streams differ from phase 4's")
                if launches["paged_decode"] != SMALL["n_layers"] * rep[
                        "decode_steps"] or rep["decode_steps"] == 0:
                    fail(f"tenant {name} paged launches {launches}")
        reserved = sum(rep.get("max_memory_reserved", 0)
                       for n, rep in reps.items())
        for w, s in windows.items():
            work = s.get("working")
            print(f"card window {w}: {s['samples']} samples "
                  f"({s['errors']} errors), nvidia-smi utilization.gpu p50 "
                  f"{s['duty_p50']} max {s['duty_max']} %, hbm_used max "
                  f"{s['hbm_used_max']} B" + ("" if work is None else (
                      f"; while the tenants worked ({s['working_s']:.1f} "
                      f"s, {work['samples']} samples): p50 "
                      f"{work['duty_p50']} max {work['duty_max']} %, "
                      f"hbm_used max {work['hbm_used_max']} B")))
        print(f"hbm: the four tenants' max reserved sum to {reserved} B; "
              f"this process reserves {parent_reserved} B besides its CUDA "
              "context; nvidia-smi's used memory also holds each process's "
              "context")
        if any(s["samples"] == 0 or s["duty_p50"] is None
               for s in windows.values()):
            fail(f"utilization windows {windows}")
        out["launches"] = {k: sum(r.get("launches", {}).get(k, 0)
                                  for r in out["tenants"].values())
                           for k in KERNEL_NAMES}
        out["tenants_reserved_sum"] = reserved
    for rep in out.get("tenants", {}).values():
        rep.pop("streams", None)
    return out


# -- phase 25: the device-plugin path; a tenant from nothing but the injection -

PLUGIN_CORE_UNITS = 25          # the pod's gpu-core request
PLUGIN_MEM_SHARE = 4            # and a quarter of the card's gpu-memory units
# the quota keys a tenant must get from the injection alone
PLUGIN_ENV_STRIP = TENANT_ENV_STRIP + ("ELASTIC_TPU_HBM_FRACTION",
                                       "ELASTIC_TPU_PRIORITY")
# the nodes every OCI container gets whatever it asked for (runc's
# defaults), made beside the injected ones in the mount-namespace leg
OCI_DEFAULT_NODES = (("null", 1, 3), ("zero", 1, 5), ("random", 1, 8),
                     ("urandom", 1, 9))


class _Apiserver:
    """Phase 25's stand-in for the apiserver: the pods the elastic
    scheduler annotated, read through the sitter's ``get_pod`` and
    ``get_pod_from_api``."""

    def __init__(self):
        self.pods = {}

    def get_pod(self, namespace, name):
        return self.pods.get((namespace, name))

    get_pod_from_api = get_pod


class _Kubelet:
    """Phase 25's stand-in for the kubelet's pod-resources API: which
    container holds which device ids, read through the locator's
    ``locate``."""

    def __init__(self):
        self.owners = {}

    def assign(self, owner, device):
        self.owners[device.hash] = owner

    def locator(self, resource):  # noqa: ARG002 - one view for both
        return self

    def locate(self, device):
        from elastic_tpu_agent_torch.plugins.base import LocateError

        if device.hash not in self.owners:
            raise LocateError(f"no pod owns device set {device.hash}")
        return self.owners[device.hash]


class _Store:
    """Phase 25's stand-in for the agent's storage: pod records in a dict,
    with the intent journal's calls."""

    def __init__(self):
        self.pods = {}
        self.intents = {}

    def load(self, namespace, name):
        return self.pods.get(f"{namespace}/{name}")

    def mutate(self, namespace, name, fn):
        from elastic_tpu_agent_torch.types import PodInfo

        fn(self.pods.setdefault(f"{namespace}/{name}",
                                PodInfo(namespace, name)))

    def items(self):
        return list(self.pods.items())

    def delete(self, namespace, name):
        self.pods.pop(f"{namespace}/{name}", None)

    def journal_intent(self, pod_key, container, resource, alloc_hash,
                       payload):
        self.intents[len(self.intents) + 1] = (pod_key, alloc_hash)
        return len(self.intents)

    def journal_commit(self, intent_id):
        self.intents.pop(intent_id, None)

    journal_remove = journal_commit

    def intent_done(self, intent_id):
        pass


def _in_device_namespace(devices):
    """An argv wrapper: run the command in a new mount namespace whose /dev
    is an empty tmpfs holding only ``devices`` (the adjustment's, by
    mknod with their major:minor) and the OCI defaults."""
    nodes = [(d["path"], d["major"], d["minor"]) for d in devices] + [
        (f"/dev/{n}", ma, mi) for n, ma, mi in OCI_DEFAULT_NODES]
    script = " && ".join(
        ["mount -t tmpfs -o mode=755 none /dev"]
        + [f"mknod -m 660 {p} c {ma} {mi}" for p, ma, mi in nodes]
        + ['exec "$@"'])
    return lambda argv: ["unshare", "-m", "--propagation", "private", "sh",
                         "-c", script, "sh"] + argv


def run_plugin_path(torch, srv, streams, dev) -> dict:
    """Phase 25: the port's device plugins and injection on the card, and
    a serving tenant started from the injected env alone (module
    docstring)."""
    import tempfile

    from elastic_tpu_agent_torch.common import (
        AnnotationAssumed, BytesPerMemoryUnit, container_annotation)
    from elastic_tpu_agent_torch.device import (
        ExclusiveOperator, NvidiaOperator)
    from elastic_tpu_agent_torch.device import qos as QOS
    from elastic_tpu_agent_torch.device.operator import CONTROL_NODES
    from elastic_tpu_agent_torch.nri import plugin as NRI
    from elastic_tpu_agent_torch.plugins import gpushare as GS
    from elastic_tpu_agent_torch.plugins.base import PluginConfig
    from elastic_tpu_agent_torch.types import Device, PodContainer

    props = torch.cuda.get_device_properties(dev)
    out = {}
    ms = {}

    def clock(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return got

    with tempfile.TemporaryDirectory(prefix="chip_smoke_plugin_") as tmp:
        disc = _Tenant("discover", "discover", tmp).result(
            time.perf_counter() + 120)
        chips = [c for c in disc.get("chips", [])
                 if _uuid_key(c["uuid"]) == _uuid_key(props.uuid)]
        if len(chips) != 1 or disc["torch_imported"]:
            fail(f"plugin discovery: {disc}")
            return out
        chip = chips[0]
        idx, node = chip["index"], f"/dev/nvidia{chip['minor']}"
        units = chip["hbm_bytes"] // BytesPerMemoryUnit
        dev_root = os.path.join(tmp, "dev")
        alloc_dir = os.path.join(tmp, "alloc")
        os.makedirs(dev_root)
        op = NvidiaOperator(dev_root, host_dev_scan_root="/dev",
                            maintenance=lambda: None, preemption=lambda: None)
        kubelet, api, store = _Kubelet(), _Apiserver(), _Store()
        config = PluginConfig(operator=op, sitter=api, storage=store,
                              locator_factory=kubelet.locator,
                              extra={"alloc_spec_dir": alloc_dir})
        bundle = GS.GPUSharePlugin(config)
        core, mem = bundle.core, bundle.memory

        # the kubelet's part: preferred ids, Allocate, PreStart
        core_ids = clock("preferred_core", core.preferred_ids,
                         [i for i, _ in core.device_list()], [],
                         PLUGIN_CORE_UNITS)
        mem_ids = clock("preferred_mem", mem.preferred_ids,
                        [i for i, _ in mem.device_list()], [],
                        units // PLUGIN_MEM_SHARE)
        on_card = {GS.chip_of_device_id(i) for i in core_ids + mem_ids}
        ca = clock("allocate_core", core.allocate_container, core_ids)
        ma = clock("allocate_mem", mem.allocate_container, mem_ids)
        control = [GS.DeviceSpec(p, p) for p in chip["extra_paths"]]
        print(f"plugin allocation: card {idx} ({node}), {len(core_ids)} core "
              f"ids and {len(mem_ids)} memory ids of {units} on cards "
              f"{sorted(on_card)}; Allocate envs {ca.envs} and {ma.envs}; "
              f"device specs {[d.host_path for d in ca.devices]} and "
              f"{[d.host_path for d in ma.devices]}")
        if on_card != {idx} or len(core_ids) != PLUGIN_CORE_UNITS:
            fail(f"preferred ids on cards {on_card}")
        if ca.envs.get("ELASTIC_TPU_CORE_UNITS") != str(PLUGIN_CORE_UNITS) \
                or "CUDA_VISIBLE_DEVICES" in ca.envs or ca.devices != control \
                or ma.devices or not control:
            fail(f"shared Allocate: {ca} {ma}")
        owner = PodContainer("default", "tenant", "main")
        api.pods[("default", "tenant")] = {"metadata": {
            "namespace": "default", "name": "tenant", "annotations": {
                AnnotationAssumed: "true",
                container_annotation("main"): str(idx)}}}
        for plugin, ids in ((core, core_ids), (mem, mem_ids)):
            kubelet.assign(owner, Device(ids))
            clock(f"prestart_{'core' if plugin is core else 'mem'}",
                  plugin.pre_start, ids)
        hashes = [Device(core_ids).hash, Device(mem_ids).hash]
        links = [os.readlink(os.path.join(dev_root, f"elastic-tpu-{h}-0"))
                 for h in hashes]
        if links != [node, node]:
            fail(f"plugin links {links}, want {node}")

        # the runtime's part: the container's env (the kubelet merges both
        # Allocate answers), its hash, the spec, the adjustment
        env = dict(ca.envs, **ma.envs)
        h = NRI.hash_from_env([f"{k}={v}" for k, v in env.items()])
        spec_path = os.path.join(alloc_dir, f"{h}.json")
        spec = core.read_alloc_spec(h)
        adj = clock("adjustment", NRI.plain_adjustment, spec, os.stat,
                    "/dev", spec_path)
        injected = dict(adj["env"])
        st = os.stat(node)
        want_quota = QOS.qos_env(
            {}, hbm_limit_bytes=len(mem_ids) * BytesPerMemoryUnit,
            chip_hbm_bytes=units * BytesPerMemoryUnit,
            core_units=PLUGIN_CORE_UNITS)
        # the quota keys; the bind's trace id is checked on its own
        trace = injected.get("ELASTIC_TPU_TRACE_ID", "")
        quota = {k: v for k, v in injected.items()
                 if k.startswith("ELASTIC_TPU_")
                 and k != "ELASTIC_TPU_TRACE_ID"}
        devices = [(d["path"], d["major"], d["minor"]) for d in adj["devices"]]
        print(f"plugin adjustment: hash {h} of {hashes}, devices {devices} "
              f"({node} is {os.major(st.st_rdev)}:{os.minor(st.st_rdev)}), "
              f"CUDA_VISIBLE_DEVICES {injected.get('CUDA_VISIBLE_DEVICES')}, "
              f"quota {quota}, mounts {[m['destination'] for m in adj['mounts']]}")
        if devices[:1] != [(node, os.major(st.st_rdev), os.minor(st.st_rdev))]:
            fail(f"injected card {devices[:1]}, want {node}")
        if [p for p, _, _ in devices[1:]] != chip["extra_paths"]:
            fail(f"injected control nodes {devices[1:]}, want "
                 f"{chip['extra_paths']}")
        # every node under /dev of a control node's name, as the host
        # holds it; the injected ones must be character devices at the
        # host's major:minor
        hosted = {}
        for name in CONTROL_NODES:
            try:
                cst = os.stat(f"/dev/{name}")
            except OSError:
                continue
            hosted[f"/dev/{name}"] = (stat.filemode(cst.st_mode),
                                      os.major(cst.st_rdev),
                                      os.minor(cst.st_rdev))
        print(f"plugin control nodes on the host: {hosted}")
        for p, major, minor in devices[1:]:
            mode, hmaj, hmin = hosted.get(p, ("", None, None))
            if not mode.startswith("c") or (major, minor) != (hmaj, hmin) \
                    or major == 0:
                fail(f"injected control node {p} {major}:{minor}, host "
                     f"{hosted.get(p)}")
        if _uuid_key(injected.get("CUDA_VISIBLE_DEVICES")) != \
                _uuid_key(chip["uuid"]):
            fail(f"injected CUDA_VISIBLE_DEVICES {injected}")
        if quota != want_quota:
            fail(f"injected quota {quota}, want qos_env's {want_quota}")
        if len(trace) != 16 or any(ch not in "0123456789abcdef"
                                   for ch in trace):
            fail(f"injected trace id {trace!r}, want 16 hex digits")

        # tenants started from the container's env alone: plainly, and in
        # a mount namespace whose /dev holds the injected nodes alone (the
        # proof that CUDA finds the card by the injected names)
        tenant_env = dict(env, **injected)
        legs = {"tenant": None,
                "tenant_ns": _in_device_namespace(adj["devices"])}
        alive = [_Tenant(name, "serve", tmp, env=tenant_env,
                         strip=PLUGIN_ENV_STRIP, wrap=wrap)
                 for name, wrap in legs.items()]
        try:
            deadline = time.perf_counter() + TENANT_TIMEOUT_S
            reps = {t.name: t.result(deadline) for t in alive}
        finally:
            for t in alive:
                t.kill()
        for name, rep in reps.items():
            if not rep:
                continue
            q = rep["quota"]
            cap = q["hbm_fraction"] * rep["total_memory"]
            same = rep["streams"] == streams
            print(f"plugin {name}: sees {rep['device_count']} card "
                  f"{rep['device_uuid']}, nvidia nodes {rep['dev_nodes']}, "
                  f"streams equal phase 4's: {same}, launches "
                  f"{rep['launches']}, max reserved "
                  f"{rep['max_memory_reserved']} B of a cap of {cap:.0f} B "
                  f"(quota {q}), {rep['tokens_per_s']:.1f} tokens/s (phase 4 "
                  f"{srv['tokens_per_s']:.1f}), {rep['seconds']:.1f} s")
            if rep["device_count"] != 1 or \
                    rep["device_uuid"] != _uuid_key(chip["uuid"]):
                fail(f"plugin {name} saw {rep['device_count']} cards, "
                     f"{rep['device_uuid']}")
            if not same:
                fail(f"plugin {name} streams differ from phase 4's")
            if rep["launches"]["paged_decode"] != srv["paged_launches"] or \
                    rep["launches"]["paged_decode"] != SMALL["n_layers"] * \
                    rep["decode_steps"]:
                fail(f"plugin {name} paged launches {rep['launches']}")
            if rep["max_memory_reserved"] > cap or \
                    q["hbm_limit_bytes"] != int(want_quota[
                        "ELASTIC_TPU_HBM_LIMIT_BYTES"]):
                fail(f"plugin {name} reserved {rep['max_memory_reserved']} "
                     f"B, cap {cap:.0f}, quota {q}")
            if name == "tenant_ns" and rep["dev_nodes"] != sorted(
                    os.path.basename(p) for p, _, _ in devices):
                fail(f"namespace /dev holds {rep['dev_nodes']}")

        # whole-card mode: the card's own nodes at Allocate
        whole = GS.GPUShareCorePlugin(PluginConfig(
            operator=ExclusiveOperator(op), sitter=api, storage=store,
            locator_factory=kubelet.locator,
            extra={"alloc_spec_dir": alloc_dir}))
        xa = clock("allocate_whole", whole.allocate_container,
                   [GS.core_device_id(idx, 0)])
        print(f"plugin whole-card: {len(whole.device_list())} id, device "
              f"specs {[d.host_path for d in xa.devices]}, envs {xa.envs}")
        if xa.devices != [GS.DeviceSpec(node, node)] + control or \
                _uuid_key(xa.envs.get("CUDA_VISIBLE_DEVICES")) != \
                _uuid_key(chip["uuid"]) or \
                xa.envs.get("ELASTIC_TPU_CORE_UNITS") != "100":
            fail(f"whole-card Allocate {xa}")

        # release: the pod is deleted, the GC sweeps
        del api.pods[("default", "tenant")]
        reclaimed = clock("gc", bundle.gc_once)
        left = (os.listdir(dev_root), sorted(
            f for f in os.listdir(alloc_dir) if f.endswith(".json")),
            store.items(), store.intents)
        print(f"plugin release: {reclaimed} pod reclaimed; left: links "
              f"{left[0]}, specs {left[1]}, records {left[2]}, intents "
              f"{left[3]}")
        if reclaimed != 1 or any(left):
            fail(f"plugin release left {left}")
        print("plugin host ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items()))
        out.update(card=idx, node=node, hashes=hashes, devices=devices,
                   quota=quota, host_ms=ms, tenants=reps)
    for rep in out.get("tenants", {}).values():
        rep.pop("streams", None)
    out["launches"] = {k: sum(r.get("launches", {}).get(k, 0)
                              for r in out.get("tenants", {}).values())
                       for k in KERNEL_NAMES}
    return out


# -- phase 26: the port's node agent across a restart, a tenant from it ------

AGENT_PODS = 4                  # pods of PLUGIN_CORE_UNITS and a quarter of
#                                 the card's memory units each
AGENT_FAULT = "bind.post_create"     # pod 3's memory PreStart dies here
# The boot pass's resolution of that crash (an open intent, links made, no
# record, the kubelet's assignment standing): rolled back, then replayed.
# tests/test_torch_reconciler.py pins it as CRASH_OUTCOME["bind.post_create"]
# and holds the port's report equal to the agent's there.
AGENT_CRASH_OUTCOME = {"intents_committed": 0, "intents_rolled_back": 1,
                       "replayed_binds": 1}
AGENT_GC_DEADLINE_S = 10.0
AGENT_WAIT_S = 300.0


def _load_tests_module(name):
    """``tests/<name>.py`` of this checkout: the stand-ins the tests share
    (``fake_apiserver``, standard library only; ``torch_nri_runtime``, the
    port's NRI transport)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_json(path, obj) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _read_json(path, wait_s=0.0):
    """The JSON at ``path``, waiting up to ``wait_s`` for it to appear;
    None when it does not."""
    deadline = time.time() + wait_s
    while not os.path.exists(path):
        if time.time() > deadline:
            return None
        time.sleep(0.02)
    with open(path) as f:
        return json.load(f)


class _PodResources:
    """Phase 26's stand-in for the kubelet's pod-resources API, handed to
    the manager as ``pod_resources_client``: List reads the assignments
    the kubelet recorded in ``path`` ({"ns/pod": {container: {resource:
    ids}}}); GetAllocatableResources answers what the plugins advertise,
    as a kubelet that consumed their ListAndWatch would."""

    def __init__(self, path, advertised):
        self.path = path
        self.advertised = advertised
        self.lists = 0

    def list(self, timeout_s=5.0):  # noqa: ARG002 - the client's signature
        self.lists += 1
        pods = _read_json(self.path) or {}
        return SimpleNamespace(pod_resources=[SimpleNamespace(
            namespace=key.split("/")[0], name=key.split("/")[1],
            containers=[SimpleNamespace(name=c, devices=[SimpleNamespace(
                resource_name=r, device_ids=ids) for r, ids in by.items()])
                for c, by in containers.items()])
            for key, containers in pods.items()])

    def get_allocatable_resources(self, timeout_s=5.0):  # noqa: ARG002
        return SimpleNamespace(devices=[SimpleNamespace(
            resource_name=r, device_ids=ids())
            for r, ids in self.advertised.items()])


def _agent_operator(dev_root, flag_dir=None):
    """NvidiaOperator over the host's /dev, links under ``dev_root``,
    counting its nvidia-smi calls and health polls; the metadata fetchers
    of the drain (not on this path) answer nothing. With ``flag_dir``
    (phase 28), the cards listed in its ``unhealthy.json`` read unhealthy
    on top of nvidia-smi's view, and each poll appends its wall time and
    healthy cards to ``polls.jsonl`` there."""
    from elastic_tpu_agent_torch.device import NvidiaOperator
    from elastic_tpu_agent_torch.device.nvidia import run_nvidia_smi

    class Counting(NvidiaOperator):
        smi_calls = 0
        health_polls = 0

        def _flagged(self):
            return (_read_json(os.path.join(flag_dir, "unhealthy.json"))
                    or {}) if flag_dir else {}

        def healthy_indexes(self):
            Counting.health_polls += 1
            healthy = set(super().healthy_indexes())
            if flag_dir:
                healthy -= set(self._flagged().get("cards", []))
                with open(os.path.join(flag_dir, "polls.jsonl"), "a") as f:
                    f.write(json.dumps({"at": time.time(),
                                        "healthy": sorted(healthy)}) + "\n")
            return healthy

        def health_reasons(self):
            reasons = dict(super().health_reasons())
            flagged = self._flagged()
            for c in flagged.get("cards", []):
                reasons[c] = flagged.get("reason", "flagged")
            return reasons

    def smi():
        Counting.smi_calls += 1
        return run_nvidia_smi()

    return Counting(dev_root, host_dev_scan_root="/dev", smi=smi,
                    maintenance=lambda: None, preemption=lambda: None)


def _agent_manager(d, card):
    """The port's NodeManager for phase 26's children on ``d``'s db, dev
    root and alloc dir, the apiserver through ``d``'s kubeconfig; its
    gRPC servers are left out (the only change to the manager), in the
    bind-path configuration (no event bus, Events, CRD, sampler or
    migration coordinator; the drain, as the agent's, is always on)."""
    from elastic_tpu_agent_torch.manager import ManagerOptions, NodeManager

    op = _agent_operator(os.path.join(d, "dev"))
    holder = {}

    def advertised(kind):
        return lambda: [i for i, _ in getattr(
            holder["m"].plugin, kind).device_list()]

    pr = _PodResources(os.path.join(d, "assign.json"), {
        card["core_resource"]: advertised("core"),
        card["mem_resource"]: advertised("memory")})
    mgr = NodeManager(ManagerOptions(
        node_name=card["node"], db_path=os.path.join(d, "meta.db"),
        kubeconfig=os.path.join(d, "kubeconfig"),
        dev_root=os.path.join(d, "dev"),
        alloc_spec_dir=os.path.join(d, "alloc"), reconcile_period_s=3600.0,
        operator=op, pod_resources_client=pr, enable_event_bus=False,
        enable_events=False, enable_crd=False, enable_sampler=False,
        enable_migration=False))
    holder["m"] = mgr
    mgr.plugin.servers = []
    return mgr, op, pr


def _pod_view(mgr, op, d, pod, hashes) -> dict:
    """What the node holds for one pod: links and their targets and
    indexes, its spec files, its record and its open intents."""
    links = {}
    for h in hashes:
        for link_id in op.list_links():
            if link_id.startswith(h):
                links[link_id] = (os.readlink(op.link_path(link_id)),
                                  op.resolve(link_id))
    specs = {h: mgr.plugin.core.read_alloc_spec(h) for h in hashes}
    info = mgr.storage.load("default", pod)
    return dict(links=links, specs=specs,
                record=None if info is None else json.loads(info.to_json()),
                intents=[i for i in mgr.storage.open_intents()
                         if i["pod_key"] == f"default/{pod}"])


def agent_main(args) -> int:
    """A child of phase 26 (``run_agent_restart``): the port's node agent
    in a process without torch, on ``--agent-dir``. ``A`` boots it, plays
    the kubelet for four pods (pod 3's memory bind killed at AGENT_FAULT)
    and stops; ``B`` boots it again on the same db after the links were
    wiped, reports its restore, then waits for pod 1's deletion and times
    GC. Prints one JSON line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from elastic_tpu_agent_torch import faults
    from elastic_tpu_agent_torch.common import HEALTHY
    from elastic_tpu_agent_torch.types import Device

    d = args.agent_dir
    card = _read_json(os.path.join(d, "card.json"))
    mgr, op, pr = _agent_manager(d, card)
    out = {}
    t0 = time.monotonic()
    mgr.run(block=False)
    out["run_ms"] = (time.monotonic() - t0) * 1e3
    # the sitter's last contact: its sync, as no pod changes during boot
    out["synced_ms"] = (time.monotonic() - mgr.sitter.sync_age_s() - t0) * 1e3
    report = mgr.reconciler.status()["last_report"]
    out["restore"] = report
    out["restore_ms"] = report["duration_s"] * 1e3
    core, mem = mgr.plugin.core, mgr.plugin.memory
    pods = [f"pod-{i}" for i in range(1, AGENT_PODS + 1)]
    if args.agent == "A":
        ms = {}
        assigned = {}
        used = {"core": set(), "mem": set()}
        hashes = {}

        def clock(name, fn, *a):
            t = time.perf_counter()
            got = fn(*a)
            ms.setdefault(name, []).append((time.perf_counter() - t) * 1e3)
            return got

        for pod in pods:
            key = f"default/{pod}"
            ids = {}
            for kind, plugin, n in (("core", core, card["core_units"]),
                                    ("mem", mem, card["mem_units"])):
                free = [i for i, _ in plugin.device_list()
                        if i not in used[kind]]
                ids[kind] = clock(f"preferred_{kind}", plugin.preferred_ids,
                                  free, [], n)
                used[kind].update(ids[kind])
                clock(f"allocate_{kind}", plugin.allocate_container,
                      ids[kind])
                # the kubelet records the assignment after Allocate
                assigned.setdefault(key, {}).setdefault("main", {})[
                    plugin.resource] = ids[kind]
                _write_json(os.path.join(d, "assign.json"), assigned)
            hashes[pod] = [Device(ids["core"]).hash, Device(ids["mem"]).hash]
            for kind, plugin in (("core", core), ("mem", mem)):
                if pod == "pod-3" and kind == "mem":
                    with faults.armed(AGENT_FAULT, "die-thread:1"):
                        try:
                            clock(f"prestart_{kind}", plugin.pre_start,
                                  ids[kind])
                            out["died"] = False
                        except faults.DieThread:
                            out["died"] = True
                    continue
                clock(f"prestart_{kind}", plugin.pre_start, ids[kind])
        out["hashes"] = hashes
        out["pods"] = {p: _pod_view(mgr, op, d, p, hashes[p]) for p in pods}
        out["bind_ms"] = ms
    else:
        hashes = card["hashes"]
        out["pods"] = {p: _pod_view(mgr, op, d, p, hashes[p]) for p in pods}
        _write_json(os.path.join(d, "restored.json"), out)
        go = _read_json(os.path.join(d, "delete-pod-1.json"), AGENT_WAIT_S)
        if go is not None:
            gone = [False]
            deadline = go["at"] + AGENT_GC_DEADLINE_S
            h1 = hashes["pod-1"]
            while time.time() < deadline:
                # the record, links and specs only: _pod_view resolves the
                # links, which can wait on an nvidia-smi call of its own
                if mgr.storage.load("default", "pod-1") is None and \
                        not any(link.startswith(h) for link in
                                op.list_links() for h in h1) and \
                        not any(mgr.plugin.core.read_alloc_spec(h)
                                for h in h1):
                    gone = [True]
                    break
                time.sleep(0.005)
            out["gc_reclaimed"] = gone[0]
            out["gc_ms"] = (time.time() - go["at"]) * 1e3
            # the split: apiserver delete -> the sitter's deletion mark,
            # and the mark -> GC's reclaim (the detection-lag tracker's)
            recent = (mgr.lag_tracker.status()["classes"].get(
                "reclaimed_pod") or {}).get("recent") or []
            if recent:
                last = recent[-1]
                out["gc_split_ms"] = dict(
                    to_sitter=(last["ts"] - last["lag_s"] - go["at"]) * 1e3,
                    sitter_to_gc=last["lag_s"] * 1e3,
                    trigger=last.get("trigger"))
            out["pod_1_after_gc"] = _pod_view(mgr, op, d, "pod-1",
                                              hashes["pod-1"])
        out["health_polls"] = op.health_polls
        out["smi_calls"] = op.smi_calls
        out["unhealthy"] = sorted(core.unhealthy_chips())
        out["all_healthy"] = all(h == HEALTHY for p in (core, mem)
                                 for _, h in p.device_list())
        out["allocatable_drift"] = mgr.check_allocatable_drift()
        out["kubelet_lists"] = pr.lists
    out["subsystems"] = {k: v["state"] for k, v in
                         mgr.supervisor.status().items()}
    mgr.stop()
    out["db_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                          for f in os.listdir(d) if f.startswith("meta.db"))
    out["torch_imported"] = "torch" in sys.modules
    print(json.dumps(out))
    return 0


class _AgentChild(_Tenant):
    """One agent child of phase 26 (``--agent A|B``), its output in files
    under the phase's directory."""

    def __init__(self, gen, d):
        self.name = f"agent {gen}"
        self.out = os.path.join(d, f"agent-{gen}.out")
        self.err = os.path.join(d, f"agent-{gen}.err")
        here = os.path.dirname(os.path.abspath(__file__))
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--agent", gen,
                 "--agent-dir", d], stdout=out, stderr=err, cwd=here)
        self.t0 = time.perf_counter()


def run_agent_restart(torch, srv, streams, dev) -> dict:
    """Phase 26: the port's node agent binds pods on the card, is stopped,
    has its links wiped and restarts; a tenant serves from a restored spec
    and GC reclaims a deleted pod (module docstring)."""
    import shutil
    import tempfile

    from elastic_tpu_agent_torch.common import (
        AnnotationAssumed, BytesPerMemoryUnit, ResourceGPUCore,
        ResourceGPUMemory, container_annotation)
    from elastic_tpu_agent_torch.device import NvidiaOperator
    from elastic_tpu_agent_torch.nri import plugin as NRI

    props = torch.cuda.get_device_properties(dev)
    out = {}
    d = tempfile.mkdtemp(prefix="cs26", dir="/tmp")
    api = None
    alive = []
    try:
        chips = [c for c in NvidiaOperator(
            "/dev", maintenance=lambda: None,
            preemption=lambda: None).devices()
            if _uuid_key(c.uuid) == _uuid_key(props.uuid)]
        if len(chips) != 1:
            fail(f"agent: no single card of uuid {props.uuid}: {chips}")
            return out
        chip = chips[0]
        node = chip.device_path
        units = chip.hbm_bytes // BytesPerMemoryUnit
        api = _load_tests_module("fake_apiserver").FakeAPIServer()
        url = api.start()
        os.makedirs(os.path.join(d, "dev"))
        _write_json(os.path.join(d, "kubeconfig"), {
            "current-context": "c",
            "contexts": [{"name": "c", "context": {"cluster": "local",
                                                   "user": "agent"}}],
            "clusters": [{"name": "local", "cluster": {"server": url}}],
            "users": [{"name": "agent", "user": {"token": "phase-26"}}]})
        card = dict(node="h100-node", core_units=PLUGIN_CORE_UNITS,
                    mem_units=units // PLUGIN_MEM_SHARE,
                    core_resource=ResourceGPUCore,
                    mem_resource=ResourceGPUMemory)
        _write_json(os.path.join(d, "card.json"), card)
        pods = [f"pod-{i}" for i in range(1, AGENT_PODS + 1)]
        for pod in pods:
            api.upsert_pod({"metadata": {
                "namespace": "default", "name": pod, "annotations": {
                    AnnotationAssumed: "true",
                    container_annotation("main"): str(chip.index)}},
                "spec": {"nodeName": card["node"],
                         "containers": [{"name": "main"}]}})

        # 1. boot A binds the four pods; pod 3's memory bind dies
        a = _AgentChild("A", d)
        alive.append(a)
        rep_a = a.result(time.perf_counter() + AGENT_WAIT_S)
        if not rep_a:
            return out
        bound = rep_a["pods"]
        print(f"agent boot A: run {rep_a['run_ms']:.1f} ms (synced "
              f"{rep_a['synced_ms']:.1f} ms, restore "
              f"{rep_a['restore_ms']:.2f} ms, "
              f"{rep_a['restore']['repaired_total']} repairs); pod 3's "
              f"memory PreStart died at {AGENT_FAULT}: {rep_a.get('died')}; "
              f"links {[sorted(set(t for t, _ in v['links'].values())) for v in bound.values()]}")
        for pod in pods:
            v = bound[pod]
            full = pod != "pod-3"
            links = {t for t, _ in v["links"].values()}
            indexes = {i for _, i in v["links"].values()}
            allocs = (v["record"] or {}).get("allocations", {}).get(
                "main", {})
            spec = v["specs"][rep_a["hashes"][pod][0]] or {}
            env = spec.get("env", {})
            quota = {k for k in env if k.startswith("ELASTIC_TPU_")}
            # pod 3's memory link was made before its bind died
            if links != {node} or indexes != {chip.index} or \
                    len(v["links"]) != 2 or len(allocs) != (2 if full else 1):
                fail(f"agent boot A {pod}: links {v['links']}, records "
                     f"{sorted(allocs)}")
            if spec.get("device_paths") != [node] or \
                    spec.get("control_paths") != chip.extra_paths or \
                    _uuid_key(env.get("CUDA_VISIBLE_DEVICES")) != \
                    _uuid_key(chip.uuid) or not {
                        "ELASTIC_TPU_CORE_UNITS", "ELASTIC_TPU_TRACE_ID"} \
                    <= quota or (full and "ELASTIC_TPU_HBM_LIMIT_BYTES"
                                 not in quota):
                fail(f"agent boot A {pod} spec {spec}")
            if len(v["intents"]) != (0 if full else 1):
                fail(f"agent boot A {pod} intents {v['intents']}")
        if rep_a.get("died") is not True or rep_a["torch_imported"]:
            fail(f"agent boot A: died {rep_a.get('died')}, torch "
                 f"{rep_a['torch_imported']}")

        # 2. between the runs: a reboot clears /dev; pod 4 is deleted
        for name in os.listdir(os.path.join(d, "dev")):
            os.unlink(os.path.join(d, "dev", name))
        api.delete_pod("default", "pod-4")
        assigned = _read_json(os.path.join(d, "assign.json"))
        assigned.pop("default/pod-4")
        _write_json(os.path.join(d, "assign.json"), assigned)
        card["hashes"] = rep_a["hashes"]
        _write_json(os.path.join(d, "card.json"), card)

        # 3. boot B restores
        b = _AgentChild("B", d)
        alive.append(b)
        restored = _read_json(os.path.join(d, "restored.json"), AGENT_WAIT_S)
        if restored is None:
            b.result(time.perf_counter() + 1)
            fail("agent boot B never restored")
            return out
        rep = restored["restore"]
        print(f"agent boot B restore: {json.dumps(rep)}")
        got = {k: rep[k] for k in AGENT_CRASH_OUTCOME}
        if got != AGENT_CRASH_OUTCOME or rep["reclaimed_pods"] != 1 or \
                rep["restored_links"] != 5 or rep["snapshot_error"]:
            fail(f"agent restore report {rep}, want {AGENT_CRASH_OUTCOME}, "
                 "1 reclaimed pod, 5 restored links")
        for pod in pods:
            v = restored["pods"][pod]
            if pod == "pod-4":
                if v["links"] or any(v["specs"].values()) or v["record"] \
                        or v["intents"]:
                    fail(f"agent restore left pod 4: {v}")
                continue
            allocs = (v["record"] or {}).get("allocations", {}).get(
                "main", {})
            if {t for t, _ in v["links"].values()} != {node} or \
                    {i for _, i in v["links"].values()} != {chip.index} or \
                    len(v["links"]) != 2 or len(allocs) != 2 or \
                    v["intents"] or not all(v["specs"].values()):
                fail(f"agent restore {pod}: {v['links']}, records "
                     f"{sorted(allocs)}, intents {v['intents']}")

        # 4. a tenant from pod 1's restored spec env alone
        h = rep_a["hashes"]["pod-1"][0]
        spec_path = os.path.join(d, "alloc", f"{h}.json")
        with open(spec_path) as f:
            spec = json.load(f)
        adj = NRI.plain_adjustment(spec, os.stat, "/dev", spec_path)
        injected = dict(adj["env"])
        tenant = _Tenant("agent_tenant", "serve", d,
                         env=dict(injected, TPU=h), strip=PLUGIN_ENV_STRIP)
        alive.append(tenant)
        trep = tenant.result(time.perf_counter() + TENANT_TIMEOUT_S)
        if trep:
            q = trep["quota"]
            cap = q["hbm_fraction"] * trep["total_memory"]
            same = trep["streams"] == streams
            print(f"agent tenant: sees {trep['device_count']} card "
                  f"{trep['device_uuid']}, streams equal phase 4's: {same}, "
                  f"launches {trep['launches']}, max reserved "
                  f"{trep['max_memory_reserved']} B of a cap of {cap:.0f} B "
                  f"(quota {q}), {trep['tokens_per_s']:.1f} tokens/s, "
                  f"{trep['seconds']:.1f} s")
            if trep["device_count"] != 1 or \
                    trep["device_uuid"] != _uuid_key(chip.uuid):
                fail(f"agent tenant saw {trep['device_count']} cards, "
                     f"{trep['device_uuid']}")
            if not same:
                fail("agent tenant streams differ from phase 4's")
            if trep["launches"]["paged_decode"] != srv["paged_launches"] or \
                    trep["launches"]["paged_decode"] != SMALL["n_layers"] \
                    * trep["decode_steps"]:
                fail(f"agent tenant paged launches {trep['launches']}")
            if trep["max_memory_reserved"] > cap or not cap:
                fail(f"agent tenant reserved {trep['max_memory_reserved']} "
                     f"B, cap {cap:.0f}")

        # 5. pod 1 deleted at the apiserver: the sitter, GC queue and loop
        api.delete_pod("default", "pod-1")
        _write_json(os.path.join(d, "delete-pod-1.json"), {"at": time.time()})
        rep_b = b.result(time.perf_counter() + AGENT_WAIT_S)
        if rep_b:
            print(f"agent boot B: GC reclaimed pod 1 "
                  f"{rep_b.get('gc_reclaimed')} in {rep_b.get('gc_ms', 0):.1f}"
                  f" ms (delete to the sitter's mark, mark to GC's reclaim: "
                  f"{json.dumps(rep_b.get('gc_split_ms'))}); health polls {rep_b['health_polls']}, nvidia-smi "
                  f"calls {rep_b['smi_calls']}, all ids Healthy "
                  f"{rep_b['all_healthy']}; allocatable drift "
                  f"{rep_b['allocatable_drift']}; kubelet Lists "
                  f"{rep_b['kubelet_lists']}; subsystems "
                  f"{rep_b['subsystems']}")
            if not rep_b.get("gc_reclaimed") or \
                    rep_b["gc_ms"] > AGENT_GC_DEADLINE_S * 1e3:
                fail(f"agent GC of pod 1: {rep_b.get('pod_1_after_gc')}")
            if rep_b["health_polls"] < 1 or rep_b["smi_calls"] < 1 or \
                    not rep_b["all_healthy"] or rep_b["unhealthy"]:
                fail(f"agent health: {rep_b['health_polls']} polls, "
                     f"{rep_b['smi_calls']} nvidia-smi calls, unhealthy "
                     f"{rep_b['unhealthy']}")
            if rep_b["allocatable_drift"] != {} or rep_b["torch_imported"]:
                fail(f"agent boot B: drift {rep_b['allocatable_drift']}, "
                     f"torch {rep_b['torch_imported']}")

        # 6. host readings
        ms = {k: [round(x, 3) for x in v]
              for k, v in rep_a["bind_ms"].items()}
        print("agent host ms: boot A synced "
              f"{rep_a['synced_ms']:.1f}, boot B synced "
              f"{restored['synced_ms']:.1f}, restore "
              f"{restored['restore_ms']:.2f}, GC "
              f"{(rep_b or {}).get('gc_ms', 0):.1f}; binds {json.dumps(ms)}; "
              f"db {(rep_b or {}).get('db_bytes')} B")
        out.update(card=chip.index, node=node, hashes=rep_a["hashes"],
                   restore=rep, bind_ms=ms,
                   synced_ms=[rep_a["synced_ms"], restored["synced_ms"]],
                   restore_ms=restored["restore_ms"],
                   gc_ms=(rep_b or {}).get("gc_ms"),
                   gc_split_ms=(rep_b or {}).get("gc_split_ms"),
                   db_bytes=(rep_b or {}).get("db_bytes"),
                   tenant={k: v for k, v in (trep or {}).items()
                           if k != "streams"})
    finally:
        for t in alive:
            t.kill()
        if api is not None:
            api.stop()
        shutil.rmtree(d, ignore_errors=True)
    out["launches"] = {k: out.get("tenant", {}).get("launches", {}).get(k, 0)
                       for k in KERNEL_NAMES}
    return out


# -- phase 27: the agent's observability plane around a tenant ---------------

OBS_PODS = 2
OBS_BATCH_WINDOW_S = 0.005
# The agent's profiler pins its overhead under 1% at the rate its latency
# smoke runs, 5 Hz; the CLI's default, as the agent's, is 0 (off).
OBS_PROFILE_HZ = 5.0
OBS_OVERHEAD_LIMIT = 0.01
OBS_RELEASE_DEADLINE_S = 10.0
# attach_serving's gauges, each with the engine.stats() path it reads
SERVING_FAMILIES = {
    "elastic_tpu_serving_pool_blocks": ("pool_blocks",),
    "elastic_tpu_serving_pool_used_blocks": ("used_blocks",),
    "elastic_tpu_serving_prefilled_tokens": ("prefilled_tokens_total",),
    "elastic_tpu_serving_admitted_tokens": ("admitted_tokens_total",),
    "elastic_tpu_serving_prefix_cache_hits": ("prefix_cache", "hits"),
    "elastic_tpu_serving_prefix_cache_misses": ("prefix_cache", "misses"),
    "elastic_tpu_serving_prefix_cache_evictions": ("prefix_cache",
                                                   "evictions"),
    "elastic_tpu_serving_prefix_cache_hit_rate": ("prefix_cache",
                                                  "hit_rate"),
}


def _http(url, timeout_s=10.0):
    """(status, body text) of a GET; an HTTP error's body too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _http_json(url):
    return json.loads(_http(url)[1])


def _samples(text) -> dict:
    """{(sample name, sorted labels): value} of a Prometheus exposition."""
    from prometheus_client.parser import text_string_to_metric_families

    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for fam in text_string_to_metric_families(text)
            for s in fam.samples}


def _stat(stats, path) -> float:
    """The engine.stats() value at ``path`` as attach_serving reads it."""
    node = stats or {}
    for key in path[:-1]:
        node = node.get(key) or {}
    value = node.get(path[-1])
    return float(value) if value is not None else 0.0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _PhaseLogged(dict):
    """An ElasticTPU object in the fake apiserver's store that logs each
    status it is given."""

    def __init__(self, obj, name, log):
        super().__init__(obj)
        self._name, self._log = name, log
        log.append((time.time(), name, (obj.get("status") or {}).get(
            "phase")))

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if key == "status":
            self._log.append((time.time(), self._name,
                              (value or {}).get("phase")))


class _CRDLog(dict):
    """The fake apiserver's ElasticTPU store, logging every object's
    phases and its removal as (wall time, name, phase or None)."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __setitem__(self, name, obj):
        super().__setitem__(name, _PhaseLogged(obj, name, self.log))

    def pop(self, name, *default):
        if name in self:
            self.log.append((time.time(), name, None))
        return super().pop(name, *default)

    def phases(self, name) -> list:
        """The phases ``name`` went through, None for its removal, with
        repeats folded."""
        out = []
        for _, n, phase in self.log:
            if n == name and (not out or out[-1] != phase):
                out.append(phase)
        return out


def _cli_agent(d, argv_file, pods, flag_dir=None, follow=False,
               operator=None, setup=None):
    """The port's CLI ``main`` on the flags in ``d/argv_file``, in this
    process (a child without torch), with phase 26's stand-ins handed to
    the manager the CLI builds (``_agent_operator``, with ``flag_dir``, and
    ``_PodResources``; its gRPC servers left out). A thread plays the
    kubelet for ``pods`` once the agent is up and writes ``bound.json``;
    ``pods`` is a list (each pod card.json's units) or a dict of pod ->
    (core units, memory units; 0: no memory). With ``follow``, the thread
    then binds the pods of each ``bind-<n>.json`` the parent writes (n =
    1, 2, ...) and answers in ``bound-<n>.json``. ``operator(dev_root)``
    replaces the counting NvidiaOperator, and ``setup(manager)`` runs once
    the manager is built (phase 31's stub agent). SIGTERM ends ``main``.
    Returns (exit code, the manager)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import threading

    from elastic_tpu_agent_torch import cli
    from elastic_tpu_agent_torch.types import Device

    card = _read_json(os.path.join(d, "card.json"))
    holder = {}

    class Manager(cli.NodeManager):
        def __init__(self, opts):
            def advertised(kind):
                return lambda: [i for i, _ in getattr(
                    self.plugin, kind).device_list()]

            opts.operator = (operator(opts.dev_root) if operator
                             else _agent_operator(opts.dev_root, flag_dir))
            opts.pod_resources_client = _PodResources(
                os.path.join(d, "assign.json"), {
                    card["core_resource"]: advertised("core"),
                    card["mem_resource"]: advertised("memory")})
            super().__init__(opts)
            self.plugin.servers = []
            if setup is not None:
                setup(self)
            holder["m"] = self

    def drive():
        n = 0
        try:
            deadline = time.time() + AGENT_WAIT_S
            while "allocatable-check" not in (
                    holder["m"].supervisor.status() if "m" in holder
                    else {}):
                if time.time() > deadline:
                    raise TimeoutError("the agent never came up")
                time.sleep(0.01)
            mgr = holder["m"]
            core, mem = mgr.plugin.core, mgr.plugin.memory
            used = {"core": set(), "mem": set()}

            def bind(pods):
                ms, hashes = {}, {}
                assigned = _read_json(os.path.join(d, "assign.json")) or {}

                def clock(name, fn, *a):
                    t = time.perf_counter()
                    got = fn(*a)
                    ms.setdefault(name, []).append(
                        (time.perf_counter() - t) * 1e3)
                    return got

                for pod in pods:
                    units = (pods[pod] if isinstance(pods, dict) else
                             (card["core_units"], card["mem_units"]))
                    ids = {}
                    for kind, plugin, n in (("core", core, units[0]),
                                            ("mem", mem, units[1])):
                        if not n:
                            continue
                        free = [i for i, _ in plugin.device_list()
                                if i not in used[kind]]
                        ids[kind] = plugin.preferred_ids(free, [], n)
                        used[kind].update(ids[kind])
                        clock(f"allocate_{kind}", plugin.allocate_container,
                              ids[kind])
                        assigned.setdefault(f"default/{pod}", {}).setdefault(
                            "main", {})[plugin.resource] = ids[kind]
                        _write_json(os.path.join(d, "assign.json"), assigned)
                    hashes[pod] = [Device(ids[k]).hash for k in ids]
                    for kind, plugin in (("core", core), ("mem", mem)):
                        if kind in ids:
                            clock(f"prestart_{kind}", plugin.pre_start,
                                  ids[kind])
                return dict(hashes=hashes, bind_ms=ms)

            _write_json(os.path.join(d, "bound.json"), bind(pods))
            n = 1
            while follow:
                req = _read_json(os.path.join(d, f"bind-{n}.json"), 3600.0)
                if req is None:
                    return
                _write_json(os.path.join(d, f"bound-{n}.json"),
                            dict(bind(req["pods"]), at=time.time()))
                n += 1
        except Exception as e:  # noqa: BLE001 - reported to the parent
            _write_json(os.path.join(
                d, f"bound-{n}.json" if n else "bound.json"),
                {"error": repr(e)})

    cli.NodeManager = Manager
    threading.Thread(target=drive, daemon=True, name="kubelet").start()
    rc = cli.main(_read_json(os.path.join(d, argv_file))["argv"])
    return rc, holder.get("m")


def _db_bytes(d) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if f.startswith("meta.db"))


def agent_obs_main(args) -> int:
    """Phase 27's agent (``--agent C``): ``_cli_agent`` on ``obs.json``'s
    flags, binding OBS_PODS pods. Prints one JSON line."""
    d = args.agent_dir
    rc, mgr = _cli_agent(d, "obs.json",
                         [f"pod-{i}" for i in range(1, OBS_PODS + 1)])
    sinks = {}
    for name, rec in (("crd", getattr(mgr, "crd_recorder", None)),
                      ("events", getattr(mgr, "events", None))):
        if rec is not None:
            sinks[name] = dict(merged=rec._sink.merged,
                               dropped=rec._sink.dropped,
                               writes=rec._sink.writes_total)
    print(json.dumps(dict(
        rc=rc, sinks=sinks, torch_imported="torch" in sys.modules,
        db_bytes=_db_bytes(d))))
    return 0


def _doctor(args) -> tuple:
    """``python3 -m elastic_tpu_agent_torch.cli node-doctor ARGS``: (exit
    code, stdout, stderr)."""
    res = subprocess.run(
        [sys.executable, "-m", "elastic_tpu_agent_torch.cli", "node-doctor",
         *args], capture_output=True, text=True, timeout=60,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return res.returncode, res.stdout, res.stderr


def run_observability(torch, srv, streams, dev, agent26) -> dict:
    """Phase 27: the port's agent with its observability plane on, read
    through its endpoint, journal and sinks around a tenant that serves
    through the paged kernel (module docstring)."""
    import shutil
    import signal
    import tempfile

    from elastic_tpu_agent_torch.common import (
        AnnotationAssumed, BytesPerMemoryUnit, ResourceGPUCore,
        ResourceGPUMemory, container_annotation)
    from elastic_tpu_agent_torch.device import NvidiaOperator
    from elastic_tpu_agent_torch.metrics import lint_exposition
    from elastic_tpu_agent_torch.nri import plugin as NRI

    props = torch.cuda.get_device_properties(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    out = {}
    d = tempfile.mkdtemp(prefix="cs27", dir="/tmp")
    api = None
    alive = []
    trep = {}
    try:
        chips = [c for c in NvidiaOperator(
            "/dev", maintenance=lambda: None,
            preemption=lambda: None).devices()
            if _uuid_key(c.uuid) == _uuid_key(props.uuid)]
        if len(chips) != 1:
            fail(f"observability: no single card of uuid {props.uuid}")
            return out
        chip = chips[0]
        api = _load_tests_module("fake_apiserver").FakeAPIServer()
        crds = api._crds = _CRDLog()
        url = api.start()
        os.makedirs(os.path.join(d, "dev"))
        _write_json(os.path.join(d, "kubeconfig"), {
            "current-context": "c",
            "contexts": [{"name": "c", "context": {"cluster": "local",
                                                   "user": "agent"}}],
            "clusters": [{"name": "local", "cluster": {"server": url}}],
            "users": [{"name": "agent", "user": {"token": "phase-27"}}]})
        card = dict(node="h100-node", core_units=PLUGIN_CORE_UNITS,
                    mem_units=chip.hbm_bytes // BytesPerMemoryUnit
                    // PLUGIN_MEM_SHARE,
                    core_resource=ResourceGPUCore,
                    mem_resource=ResourceGPUMemory)
        _write_json(os.path.join(d, "card.json"), card)
        pods = [f"pod-{i}" for i in range(1, OBS_PODS + 1)]
        for pod in pods:
            api.upsert_pod({"metadata": {
                "namespace": "default", "name": pod, "uid": f"uid-{pod}",
                "annotations": {
                    AnnotationAssumed: "true",
                    container_annotation("main"): str(chip.index)}},
                "spec": {"nodeName": card["node"],
                         "containers": [{"name": "main"}]}})
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        db = os.path.join(d, "meta.db")
        _write_json(os.path.join(d, "obs.json"), {"argv": [
            "--node-name", card["node"], "--db-file", db,
            "--kubeconf", os.path.join(d, "kubeconfig"),
            "--operator", "nvidia", "--dev-root", os.path.join(d, "dev"),
            "--alloc-spec-dir", os.path.join(d, "alloc"),
            "--device-plugin-dir", os.path.join(d, "dp"),
            "--pod-resources-socket", os.path.join(d, "pr.sock"),
            "--metrics-port", str(port),
            "--storage-batch-window", str(OBS_BATCH_WINDOW_S),
            "--profile-hz", str(OBS_PROFILE_HZ)]})
        agent = _AgentChild("C", d)
        alive.append(agent)
        bound = _read_json(os.path.join(d, "bound.json"), AGENT_WAIT_S)
        if not bound or "error" in bound:
            agent.kill()
            agent.result(time.perf_counter() + 1)
            fail(f"observability agent never bound: {bound}")
            return out
        hashes = bound["hashes"]

        # the bind's trace id: spec env, /debug/traces, /debug/timeline
        h1 = hashes["pod-1"][0]
        spec_path = os.path.join(d, "alloc", f"{h1}.json")
        with open(spec_path) as f:
            spec = json.load(f)
        tid = spec["env"].get("ELASTIC_TPU_TRACE_ID", "")
        traced = {t["trace_id"] for t in _http_json(
            base + "/debug/traces?limit=1000")["traces"]}
        events1 = _http_json(base + "/debug/timeline?pod=default/pod-1")[
            "events"]
        seqs = {k: [e["seq"] for e in events1 if e["kind"] == k
                    and e["keys"].get("trace") == tid]
                for k in ("bind_intent", "bind_commit")}
        trace_ok = bool(tid in traced and seqs["bind_intent"]
                        and seqs["bind_commit"]
                        and min(seqs["bind_intent"]) < min(seqs["bind_commit"]))
        print(f"observability trace: pod 1's ELASTIC_TPU_TRACE_ID {tid} in "
              f"/debug/traces {tid in traced}, its bind_intent seqs "
              f"{seqs['bind_intent']} before bind_commit seqs "
              f"{seqs['bind_commit']}: {trace_ok}")
        if not trace_ok:
            fail(f"observability trace id {tid}: {seqs}")

        # the tenant from pod 1's spec alone, with its own AgentMetrics
        adj = NRI.plain_adjustment(spec, os.stat, "/dev", spec_path)
        tenant = _Tenant("obs_tenant", "serve_obs", d,
                         env=dict(adj["env"], TPU=h1), strip=PLUGIN_ENV_STRIP)
        alive.append(tenant)
        trep = tenant.result(time.perf_counter() + TENANT_TIMEOUT_S)
        if trep:
            fams = trep["serving_families"]
            differ = {k: v for k, v in fams.items() if v[0] != v[1]}
            same = trep["streams"] == streams
            print(f"observability tenant: streams equal phase 4's {same}, "
                  f"launches {trep['launches']}, its /metrics serving "
                  f"families equal engine.stats() "
                  f"{not differ} ({len(fams)} families), /debug/requests "
                  f"{trep['requests']}, {trep['tokens_per_s']:.1f} tokens/s")
            if not same:
                fail("observability tenant streams differ from phase 4's")
            if trep["launches"]["paged_decode"] != srv["paged_launches"]:
                fail(f"observability tenant launches {trep['launches']}")
            if differ or len(fams) != len(SERVING_FAMILIES):
                fail(f"observability tenant serving families {fams}")
            if trep["requests"]["records"] != 16 or \
                    trep["requests"]["finished"] != 16:
                fail(f"observability tenant requests {trep['requests']}")

        # pod 2 deleted at the apiserver (and the kubelet drops it)
        t_del = time.time()
        api.delete_pod("default", "pod-2")
        assigned = _read_json(os.path.join(d, "assign.json"))
        assigned.pop("default/pod-2", None)
        _write_json(os.path.join(d, "assign.json"), assigned)
        names2 = [f"{card['node']}-{h}" for h in hashes["pod-2"]]
        reclaim = None
        released = False
        while time.time() < t_del + OBS_RELEASE_DEADLINE_S:
            if reclaim is None:
                for e in _http_json(
                        base + "/debug/timeline?pod=default/pod-2")["events"]:
                    if e["kind"] == "pod_reclaimed" or (
                            e["kind"] == "reconcile_repair"
                            and e["attrs"].get("class") == "reclaimed_pod"):
                        reclaim = e
            released = all(crds.phases(n)[-2:] == ["Released", None]
                           for n in names2)
            if reclaim is not None and released:
                break
            time.sleep(0.01)
        released_s = max((t for t, n, p in crds.log if n in names2
                          and p is None), default=float("nan")) - t_del
        events2 = _http_json(base + "/debug/timeline?pod=default/pod-2")[
            "events"]
        kinds2 = [e["kind"] for e in events2 if not e.get("related")]
        reclaim_ms = (reclaim["ts"] - t_del) * 1e3 if reclaim else None
        lat = _http_json(base + "/debug/latency?top=512")
        lag = ((lat.get("detection_lag") or {}).get("classes") or {}).get(
            "reclaimed_pod", {})
        last_lag = (lag.get("recent") or [{}])[-1]
        print(f"observability deletion: pod 2's journal {kinds2}; reclaim "
              f"event {reclaim and reclaim['kind']} "
              f"{reclaim and reclaim['attrs'].get('source', '')} at "
              f"{reclaim_ms} ms after the delete; detection lag "
              f"loop {last_lag.get('loop')} trigger {last_lag.get('trigger')} "
              f"{last_lag.get('lag_s')} s; ElasticTPU objects "
              f"{ {n: crds.phases(n) for n in names2} } removed "
              f"{released_s * 1e3:.1f} ms after the delete [{smi}]")
        if reclaim is None or "bind_intent" not in kinds2 or \
                "bind_commit" not in kinds2:
            fail(f"observability: pod 2's journal {kinds2}")
        if not released:
            fail(f"observability: pod 2's objects "
                 f"{ {n: crds.phases(n) for n in names2} }")
        if last_lag.get("trigger") not in ("event", "poll"):
            fail(f"observability: detection lag {lag}")
        names1 = [f"{card['node']}-{h}" for h in hashes["pod-1"]]
        phases1 = {n: (crds.get(n) or {}).get("status", {}).get("phase")
                   for n in names1}
        if set(phases1.values()) != {"Bound"}:
            fail(f"observability: pod 1's objects {phases1}")
        bound_events = {(e["involvedObject"].get("name"), e["reason"])
                        for e in api.core_events}
        want_events = {(p, "TPUBound") for p in pods}
        if not want_events <= bound_events:
            fail(f"observability Events {sorted(bound_events)}")

        # the agent's /metrics and /healthz
        code, text = _http(base + "/metrics")
        problems = lint_exposition(text)
        got = _samples(text)
        reads = {k: got.get((k, ())) for k in (
            "elastic_tpu_allocate_seconds_count",
            "elastic_tpu_prestart_seconds_count",
            "elastic_tpu_bound_allocations", "elastic_tpu_chips",
            "elastic_tpu_chips_healthy")}
        want = {"elastic_tpu_allocate_seconds_count": 2.0 * OBS_PODS,
                "elastic_tpu_prestart_seconds_count": 2.0 * OBS_PODS,
                "elastic_tpu_bound_allocations": 1.0,
                "elastic_tpu_chips": 1.0, "elastic_tpu_chips_healthy": 1.0}
        hz_code, _ = _http(base + "/healthz")
        print(f"observability /metrics: {code}, {len(text)} B, lint "
              f"problems {problems[:3]}, {json.dumps(reads)}; /healthz "
              f"{hz_code}")
        if code != 200 or problems or reads != want or hz_code != 200:
            fail(f"observability /metrics {reads} (want {want}), lint "
                 f"{problems[:5]}, healthz {hz_code}")

        # /debug/latency: phases + residual = each bind's total
        binds = lat["bind"]["slowest"]
        bad = [b for b in binds if abs(sum(b["phases_ms"].values())
                                       + b["residual_ms"] - b["total_ms"])
               > 1e-3 * (len(b["phases_ms"]) + 2)]
        share = lat["bind"]["residual_share"]
        print(f"observability /debug/latency: {len(binds)} binds, phases + "
              f"residual = total for all {not bad}, residual share {share}, "
              f"total p50 {lat['bind']['total_p50_ms']} ms [{smi}]")
        if len(binds) != 2 * OBS_PODS or bad:
            fail(f"observability latency: {len(binds)} binds, {bad[:2]}")

        # /debug/profile and node-doctor profile
        prof = _http_json(base + "/debug/profile")
        rc_prof, prof_out, prof_err = _doctor(["profile", "--agent-url",
                                               base])
        print(f"observability /debug/profile: {prof['samples_total']} "
              f"samples at {prof['hz']} Hz, overhead "
              f"{prof['overhead_ratio']}, {prof['unique_stacks']} stacks; "
              f"node-doctor profile exit {rc_prof}: "
              f"{prof_out.splitlines()[:1]} [{smi}]")
        if not prof["samples_total"] or \
                prof["overhead_ratio"] >= OBS_OVERHEAD_LIMIT or rc_prof:
            fail(f"observability profile {prof['samples_total']} samples, "
                 f"overhead {prof['overhead_ratio']}, doctor {rc_prof} "
                 f"{prof_err[-300:]}")

        # the agent stops; its db read by node-doctor timeline
        agent.proc.send_signal(signal.SIGTERM)
        rep = agent.result(time.perf_counter() + 60)
        rc_tl, tl_out, tl_err = _doctor(["timeline", "--db-file", db,
                                         "--pod", "default/pod-1"])
        tl_events = json.loads(tl_out)["events"] if rc_tl == 0 else []
        ms = {k: [round(x, 3) for x in v] for k, v in bound["bind_ms"].items()}
        print(f"observability node-doctor timeline exit {rc_tl}: "
              f"{len(tl_events)} events for pod 1 from the stopped agent's "
              f"db; agent exit {rep.get('rc')}, torch imported "
              f"{rep.get('torch_imported')}")
        print(f"observability host ms [{smi}]: binds with the plane on "
              f"{json.dumps(ms)}; phase 26's (plane off) "
              f"{json.dumps((agent26 or {}).get('bind_ms'))}; db "
              f"{rep.get('db_bytes')} B; sinks {json.dumps(rep.get('sinks'))}")
        if rc_tl or not tl_events:
            fail(f"observability node-doctor timeline {rc_tl} {tl_err[-300:]}")
        if not rep or rep.get("torch_imported") or rep.get("rc") != 0:
            fail(f"observability agent: {rep}")
        out.update(card=chip.index, smi=smi, hashes=hashes, bind_ms=ms,
                   reclaim_ms=reclaim_ms, detection_lag=last_lag,
                   released_ms=released_s * 1e3, residual_share=share,
                   profile={k: prof[k] for k in (
                       "samples_total", "hz", "overhead_ratio",
                       "unique_stacks")},
                   metrics=reads, db_bytes=rep.get("db_bytes"),
                   sinks=rep.get("sinks"),
                   tenant={k: v for k, v in trep.items() if k != "streams"})
    finally:
        for t in alive:
            t.kill()
        if api is not None:
            api.stop()
        shutil.rmtree(d, ignore_errors=True)
    out["launches"] = {k: trep.get("launches", {}).get(k, 0)
                       for k in KERNEL_NAMES}
    return out


# -- phase 28: runtime activation; tenants started by NRI and by the hook ----

ACT_PODS = ("pod-1", "pod-2")    # the NRI tenant's pod, the hook tenant's
ACT_FLAG_REASON = "marked unhealthy by the script's flag file"
# the eviction must reach the runtime within two health polls
ACT_EVICT_DEADLINE_S = 2 * 5.0   # 2 x plugins/gpushare.py HEALTH_PERIOD_S
ACT_QUIET_S = 1.0                # no eviction of the second container


def agent_act_main(args) -> int:
    """Phase 28's agent (``--agent D``): ``_cli_agent`` on ``act.json``'s
    flags (an NRI socket, the eviction policy), binding ACT_PODS, health
    read through the flag file in its directory. Prints one JSON line."""
    d = args.agent_dir
    rc, mgr = _cli_agent(d, "act.json", list(ACT_PODS), flag_dir=d)
    nri = getattr(mgr, "nri_plugin", None)
    print(json.dumps(dict(
        rc=rc, torch_imported="torch" in sys.modules,
        nri_injected=nri and nri.injected_count,
        hooked=bool(mgr and mgr.plugin.on_chips_failed is not None),
        subsystems={k: v["state"] for k, v in
                    (mgr.supervisor.status() if mgr else {}).items()})))
    return 0


def _char_nodes(root) -> dict:
    """{path under ``root``: (major, minor)} of its character devices."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            st = os.lstat(os.path.join(dirpath, name))
            if stat.S_ISCHR(st.st_mode):
                rel = "/" + os.path.relpath(os.path.join(dirpath, name),
                                            root)
                out[rel] = (os.major(st.st_rdev), os.minor(st.st_rdev))
    return out


def _in_rootfs_dev(dev_dir):
    """An argv wrapper: run the command in a new mount namespace with
    ``dev_dir`` (a rootfs's /dev) bound over /dev."""
    script = f'mount --bind {dev_dir} /dev && exec "$@"'
    return lambda argv: ["unshare", "-m", "--propagation", "private", "sh",
                         "-c", script, "sh"] + argv


def _bundle(root, name, env, mounts):
    """An OCI bundle: config.json with ``env`` and a rootfs whose /dev is
    a tmpfs, as a runtime mounts one (the script's temp directory need
    not allow device nodes); the mount point is added to ``mounts``."""
    bundle = os.path.join(root, name)
    dev_dir = os.path.join(bundle, "rootfs", "dev")
    os.makedirs(dev_dir)
    subprocess.run(["mount", "-t", "tmpfs", "-o", "mode=755", "none",
                    dev_dir], check=True, timeout=60)
    mounts.append(dev_dir)
    _write_json(os.path.join(bundle, "config.json"), {
        "ociVersion": "1.0.2", "process": {"env": env},
        "root": {"path": "rootfs"}})
    return bundle


def _run_hook(bins, bundle, alloc_dir, dev_dir):
    """The OCI createRuntime call: the state on stdin; (exit code, stderr,
    host ms of hook + toolkit)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ELASTIC_GPU_")}
    env.update(ELASTIC_GPU_TOOLKIT=bins["elastic-gpu-container-toolkit"],
               ELASTIC_GPU_ALLOC_DIR=alloc_dir, ELASTIC_GPU_DEV_DIR=dev_dir)
    t0 = time.perf_counter()
    res = subprocess.run([bins["elastic-gpu-hook"], "--verbose"],
                         input=json.dumps({"ociVersion": "1.0.2", "id": "h",
                                           "pid": os.getpid(),
                                           "bundle": bundle}).encode(),
                         env=env, capture_output=True, timeout=60)
    return res.returncode, res.stderr.decode()[-800:], \
        (time.perf_counter() - t0) * 1e3


def _check_tenant(name, rep, srv, streams, chip, want_nodes):
    """Phase 4's checks on a served tenant's report: its streams, the
    paged launches, one card (the allocated one), under its cap, and its
    /dev's nvidia nodes."""
    q = rep["quota"]
    cap = q["hbm_fraction"] * rep["total_memory"]
    same = rep["streams"] == streams
    print(f"activation {name}: sees {rep['device_count']} card "
          f"{rep['device_uuid']}, nvidia nodes {rep['dev_nodes']}, streams "
          f"equal phase 4's: {same}, launches {rep['launches']}, max "
          f"reserved {rep['max_memory_reserved']} B of a cap of {cap:.0f} B "
          f"(quota {q}), {rep['tokens_per_s']:.1f} tokens/s, "
          f"{rep['seconds']:.1f} s")
    if rep["device_count"] != 1 or \
            rep["device_uuid"] != _uuid_key(chip.uuid):
        fail(f"activation {name} saw {rep['device_count']} cards, "
             f"{rep['device_uuid']}")
    if not same:
        fail(f"activation {name} streams differ from phase 4's")
    if rep["launches"]["paged_decode"] != srv["paged_launches"] or \
            rep["launches"]["paged_decode"] != SMALL["n_layers"] * \
            rep["decode_steps"]:
        fail(f"activation {name} paged launches {rep['launches']}")
    if rep["max_memory_reserved"] > cap or not cap or \
            not q["hbm_limit_bytes"]:
        fail(f"activation {name} reserved {rep['max_memory_reserved']} B, "
             f"cap {cap:.0f}, quota {q}")
    if rep["dev_nodes"] != want_nodes:
        fail(f"activation {name}'s /dev holds {rep['dev_nodes']}, want "
             f"{want_nodes}")


def run_runtime_activation(torch, srv, streams, dev) -> dict:
    """Phase 28: the agent's runtime activation on the card: the NRI
    server (a runtime stand-in on the port's mux and ttrpc), the OCI hook
    chain built from the port's sources, a tenant started by each, the
    eviction of the NRI tenant's container when its card is flagged, and
    the re-registration after the runtime restarts (module docstring)."""
    import shutil
    import signal
    import tempfile

    from elastic_tpu_agent_torch.common import (
        AnnotationAssumed, BytesPerMemoryUnit, ResourceGPUCore,
        ResourceGPUMemory, container_annotation)
    from elastic_tpu_agent_torch.device import NvidiaOperator
    from elastic_tpu_agent_torch.gen import nri_pb2 as pb
    from elastic_tpu_agent_torch.native import build as native_build
    from elastic_tpu_agent_torch.nri import NRIPlugin
    from elastic_tpu_agent_torch.nri.plugin import event_mask

    props = torch.cuda.get_device_properties(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    out = {}
    ms = {"create_container": []}
    d = tempfile.mkdtemp(prefix="cs28", dir="/tmp")
    api = rt = None
    alive = []
    mounts = []
    reps = {}
    try:
        t0 = time.perf_counter()
        bins = native_build.build()
        ms["native_build"] = (time.perf_counter() - t0) * 1e3
        chips = [c for c in NvidiaOperator(
            "/dev", maintenance=lambda: None,
            preemption=lambda: None).devices()
            if _uuid_key(c.uuid) == _uuid_key(props.uuid)]
        if len(chips) != 1:
            fail(f"activation: no single card of uuid {props.uuid}")
            return out
        chip = chips[0]
        nvidia = _load_tests_module("torch_nri_runtime")
        rt = nvidia.NRIRuntime(os.path.join(d, "nri.sock"),
                               accept_timeout_s=AGENT_WAIT_S)
        api = _load_tests_module("fake_apiserver").FakeAPIServer()
        url = api.start()
        # the agent's view of the host's /dev (its DaemonSet's /host/dev):
        # the card's and control nodes (links to this host's), beside
        # which the agent makes its links
        dev_view = os.path.join(d, "dev")
        os.makedirs(dev_view)
        for path in [chip.device_path] + list(chip.extra_paths):
            os.symlink(path, os.path.join(dev_view, os.path.basename(path)))
        _write_json(os.path.join(d, "kubeconfig"), {
            "current-context": "c",
            "contexts": [{"name": "c", "context": {"cluster": "local",
                                                   "user": "agent"}}],
            "clusters": [{"name": "local", "cluster": {"server": url}}],
            "users": [{"name": "agent", "user": {"token": "phase-28"}}]})
        card = dict(node="h100-node", core_units=PLUGIN_CORE_UNITS,
                    mem_units=chip.hbm_bytes // BytesPerMemoryUnit
                    // PLUGIN_MEM_SHARE,
                    core_resource=ResourceGPUCore,
                    mem_resource=ResourceGPUMemory)
        _write_json(os.path.join(d, "card.json"), card)
        for pod in ACT_PODS:
            api.upsert_pod({"metadata": {
                "namespace": "default", "name": pod, "uid": f"uid-{pod}",
                "annotations": {
                    AnnotationAssumed: "true",
                    container_annotation("main"): str(chip.index)}},
                "spec": {"nodeName": card["node"],
                         "containers": [{"name": "main"}]}})
        alloc = os.path.join(d, "alloc")
        _write_json(os.path.join(d, "act.json"), {"argv": [
            "--node-name", card["node"], "--db-file",
            os.path.join(d, "meta.db"),
            "--kubeconf", os.path.join(d, "kubeconfig"),
            "--operator", "nvidia", "--plugin", "gpushare",
            "--dev-root", dev_view, "--alloc-spec-dir", alloc,
            "--device-plugin-dir", os.path.join(d, "dp"),
            "--pod-resources-socket", os.path.join(d, "pr.sock"),
            "--metrics-port", "0", "--reconcile-period", "3600",
            "--no-event-bus", "--no-events", "--no-crd",
            "--nri-socket", rt.socket_path, "--nri-evict-on-chip-failure"]})
        agent = _AgentChild("D", d)
        alive.append(agent)

        # the runtime takes the agent's registration, configures, syncs
        rt.accept()
        if not rt.registered.wait(AGENT_WAIT_S):
            fail("activation: the agent never registered over NRI")
            return out
        events = rt.configure().events
        rt.synchronize()
        bound = _read_json(os.path.join(d, "bound.json"), AGENT_WAIT_S)
        if not bound or "error" in bound:
            fail(f"activation agent never bound: {bound}")
            return out
        h_nri, h_hook = (bound["hashes"][p][0] for p in ACT_PODS)
        subscribed = events == event_mask(pb.CREATE_CONTAINER,
                                          pb.REMOVE_CONTAINER)
        print(f"activation NRI: registered as "
              f"{rt.register_request.plugin_idx}-"
              f"{rt.register_request.plugin_name}, Configure events "
              f"{events} (CREATE_CONTAINER and REMOVE_CONTAINER: "
              f"{subscribed})")
        if not subscribed:
            fail(f"activation NRI Configure events {events}")

        def create(cid, alloc_hash):
            t = time.perf_counter()
            resp = rt.create_container([f"GPU={alloc_hash}", "PATH=/bin"],
                                       pod_name=ACT_PODS[0],
                                       namespace="default",
                                       container_id=cid)
            ms["create_container"].append((time.perf_counter() - t) * 1e3)
            return resp.adjust

        adj = create("nri-1", h_nri)
        devices = [dict(path=x.path, major=x.major, minor=x.minor)
                   for x in adj.linux.devices]
        nri_env = {kv.key: kv.value for kv in adj.env}
        with open(os.path.join(alloc, f"{h_nri}.json")) as f:
            spec_nri = json.load(f)
        st = os.stat(chip.device_path)
        want_card = dict(path=chip.device_path, major=os.major(st.st_rdev),
                         minor=os.minor(st.st_rdev))
        print(f"activation NRI adjustment: devices "
              f"{[(x['path'], x['major'], x['minor']) for x in devices]}, "
              f"env {sorted(nri_env)}, mounts "
              f"{[(m.destination, m.source) for m in adj.mounts]}")
        if devices[:1] != [want_card] or nri_env != spec_nri["env"] or \
                [x["path"] for x in devices[1:]] != chip.extra_paths:
            fail(f"activation NRI adjustment {devices} {nri_env}")

        # the hook chain over the same view of /dev: a bundle, the hook
        # with the OCI state on stdin
        bundle = _bundle(d, "bundle", [f"GPU={h_hook}", "PATH=/bin"],
                         mounts)
        rootfs = os.path.join(bundle, "rootfs")
        rc, err, ms["hook_spec"] = _run_hook(bins, bundle, alloc, dev_view)
        hook_nodes = _char_nodes(rootfs)
        env_path = os.path.join(rootfs, "run", "elastic-tpu", "env")
        with open(env_path) as f:
            hook_env = dict(line.rstrip("\n").split("=", 1) for line in f)
        with open(os.path.join(alloc, f"{h_hook}.json")) as f:
            spec_hook = json.load(f)
        want_nodes = {x["path"]: (x["major"], x["minor"]) for x in devices}
        print(f"activation hook: exit {rc}, {ms['hook_spec']:.1f} ms, "
              f"nodes {hook_nodes}, env {sorted(hook_env)}")
        if rc != 0 or hook_nodes != want_nodes or \
                hook_env != spec_hook["env"]:
            fail(f"activation hook: exit {rc} {err}, nodes {hook_nodes} "
                 f"(want {want_nodes}), env {hook_env}")
        # the dev-scan fallback: the spec moved away, the same nodes and
        # the card's uuid from the agent's links
        moved = os.path.join(d, "moved.json")
        os.replace(os.path.join(alloc, f"{h_hook}.json"), moved)
        try:
            scan = _bundle(d, "bundle-scan", [f"GPU={h_hook}"], mounts)
            rc2, err2, ms["hook_devscan"] = _run_hook(bins, scan, alloc,
                                                      dev_view)
        finally:
            os.replace(moved, os.path.join(alloc, f"{h_hook}.json"))
        scan_nodes = _char_nodes(os.path.join(scan, "rootfs"))
        scan_env = {}
        scan_env_path = os.path.join(scan, "rootfs", "run", "elastic-tpu",
                                     "env")
        if os.path.exists(scan_env_path):
            with open(scan_env_path) as f:
                scan_env = dict(line.rstrip("\n").split("=", 1)
                                for line in f)
        print(f"activation dev-scan fallback: exit {rc2}, "
              f"{ms['hook_devscan']:.1f} ms, nodes {scan_nodes}, env "
              f"{scan_env}")
        if rc2 != 0 or scan_nodes != hook_nodes or scan_env != {
                "CUDA_VISIBLE_DEVICES": spec_hook["env"][
                    "CUDA_VISIBLE_DEVICES"]}:
            fail(f"activation dev-scan: exit {rc2} {err2}, nodes "
                 f"{scan_nodes}, env {scan_env}")

        # both tenants at once: the NRI one in a /dev of the adjustment's
        # nodes, the hook one with the rootfs's /dev over /dev and its env
        # from the rootfs's env file alone
        for n, ma, mi in OCI_DEFAULT_NODES:
            os.mknod(os.path.join(rootfs, "dev", n), 0o666 | stat.S_IFCHR,
                     os.makedev(ma, mi))
        tenants = [
            _Tenant("nri_tenant", "serve", d,
                    env=dict(nri_env, GPU=h_nri), strip=PLUGIN_ENV_STRIP,
                    wrap=_in_device_namespace(devices)),
            _Tenant("hook_tenant", "serve", d, env_file=env_path,
                    strip=PLUGIN_ENV_STRIP,
                    wrap=_in_rootfs_dev(os.path.join(rootfs, "dev")))]
        alive += tenants
        deadline = time.perf_counter() + TENANT_TIMEOUT_S
        reps = {t.name: t.result(deadline) for t in tenants}
        names = sorted(os.path.basename(p) for p in want_nodes)
        for name, rep in reps.items():
            if rep:
                _check_tenant(name, rep, srv, streams, chip, names)

        # the card flagged unhealthy: one UpdateContainers evicting the
        # NRI tenant's container, which the script then stops
        t_flag = time.perf_counter()
        _write_json(os.path.join(d, "unhealthy.json"),
                    {"cards": [chip.index], "reason": ACT_FLAG_REASON})
        got = rt.wait_updates(1, ACT_EVICT_DEADLINE_S)
        ms["flag_to_update"] = (rt.update_times[0] - t_flag) * 1e3 \
            if got else None
        evicted = rt.evicted_ids()
        reason = got and rt.update_requests[0].evict[0].reason
        tenants[0].kill()
        rt.state_change(pb.REMOVE_CONTAINER, "nri-1")
        print(f"activation eviction: UpdateContainers {len(evicted)} "
              f"evicting {evicted} ({reason!r}) "
              f"{ms['flag_to_update']} ms after the flag [{smi}]")
        if not got or evicted != ["nri-1"] or \
                ACT_FLAG_REASON not in (reason or ""):
            fail(f"activation eviction: {evicted} {reason!r}")

        # the flag cleared: once a health poll has completed after it, a
        # second container on the card is injected and not evicted
        t_clear = time.time()
        os.unlink(os.path.join(d, "unhealthy.json"))
        deadline = time.time() + ACT_EVICT_DEADLINE_S + 5.0
        polls = []
        while time.time() < deadline:
            with open(os.path.join(d, "polls.jsonl")) as f:
                polls = [json.loads(line) for line in f
                         if json.loads(line)["at"] > t_clear]
            # a second poll's start: the first, hooks included, is done
            if len(polls) >= 2:
                break
            time.sleep(0.05)
        adj2 = create("nri-2", h_nri)
        time.sleep(ACT_QUIET_S)
        print(f"activation recovery: {len(polls)} polls after the clear, "
              f"card healthy {polls and chip.index in polls[0]['healthy']}; "
              f"second CreateContainer injected "
              f"{len(adj2.linux.devices)} devices, evictions now "
              f"{rt.evicted_ids()}")
        if len(polls) < 2 or chip.index not in polls[0]["healthy"] or \
                len(adj2.linux.devices) != len(devices) or \
                rt.evicted_ids() != ["nri-1"]:
            fail(f"activation recovery: polls {polls}, devices "
                 f"{len(adj2.linux.devices)}, evictions {rt.evicted_ids()}")

        # the runtime restarts: the agent re-registers within its first
        # backoff and synchronizes
        t_restart = time.perf_counter()
        rt.restart()
        rt.accept()
        again = rt.registered.wait(AGENT_WAIT_S)
        ms["reregister"] = (rt.registered_at - t_restart) * 1e3 \
            if again else None
        rt.configure()
        sync = rt.synchronize(containers=[pb.Container(
            id="nri-2", name="main", env=[f"GPU={h_nri}"])])
        print(f"activation restart: re-registered {again} in "
              f"{ms['reregister']} ms (first backoff "
              f"{NRIPlugin.RECONNECT_MIN_S} s), Synchronize answered "
              f"{list(sync.update)}")
        if not again or ms["reregister"] > (
                NRIPlugin.RECONNECT_MIN_S + 1.0) * 1e3:
            fail(f"activation restart: re-registered {again} in "
                 f"{ms['reregister']} ms")

        agent.proc.send_signal(signal.SIGTERM)
        rep = agent.result(time.perf_counter() + 60)
        print(f"activation agent: exit {rep.get('rc')}, NRI injections "
              f"{rep.get('nri_injected')}, eviction hooked "
              f"{rep.get('hooked')}, torch imported "
              f"{rep.get('torch_imported')}, subsystems "
              f"{rep.get('subsystems')}")
        if rep.get("rc") != 0 or rep.get("torch_imported") or \
                rep.get("nri_injected") != 2 or not rep.get("hooked"):
            fail(f"activation agent: {rep}")
        print(f"activation host ms [{smi}]: CreateContainer round trips "
              f"{[round(x, 3) for x in ms['create_container']]}, hook + "
              f"toolkit {ms['hook_spec']:.3f} (spec) "
              f"{ms['hook_devscan']:.3f} (dev scan), flag to "
              f"UpdateContainers {ms['flag_to_update']}, re-registration "
              f"{ms['reregister']}, native build {ms['native_build']:.1f}")
        out.update(card=chip.index, smi=smi, hashes=[h_nri, h_hook],
                   host_ms=ms, devices=devices, evicted=evicted,
                   tenants={k: {x: y for x, y in v.items() if x != "streams"}
                            for k, v in reps.items()})
    finally:
        for t in alive:
            t.kill()
        if rt is not None:
            rt.close()
        if api is not None:
            api.stop()
        for path in mounts:
            subprocess.run(["umount", "-l", path], timeout=60)
        shutil.rmtree(d, ignore_errors=True)
    out["launches"] = {k: sum(r.get("launches", {}).get(k, 0)
                              for r in reps.values() if r)
                       for k in KERNEL_NAMES}
    return out


MIG_PODS = {"pod-t": (50, 2),    # core units, memory share divisor
            "pod-s": (25, 0)}    # core units only
MIG_DEADLINE_S = 120.0           # --drain-deadline
MIG_STEPS = 30                   # the runner's schedule and step budget
MIG_PRECOPY_EVERY = 3            # a pre-copy round every 3 steps
MIG_WAIT_S = 120.0               # each wait of the phase on the agent
MIG_FLAGS = ["--sampler-period", "1", "--drain-period", "0.5",
             "--migration-period", "0.5",
             "--drain-deadline", str(MIG_DEADLINE_S)]


def agent_mig_main(args) -> int:
    """Phase 29's agent (``--agent E``): ``_cli_agent`` on ``mig.json``'s
    flags, binding the pods of ``pods.json`` and then those of each bind
    request. Prints one JSON line."""
    d = args.agent_dir
    pods = {k: tuple(v) for k, v in _read_json(
        os.path.join(d, "pods.json")).items()}
    rc, mgr = _cli_agent(d, "mig.json", pods, follow=True)
    print(json.dumps(dict(
        rc=rc, torch_imported="torch" in sys.modules,
        subsystems={k: v["state"] for k, v in
                    mgr.supervisor.status().items()} if mgr else {})))
    return 0


class _AllocPoller:
    """GETs ``/debug/allocations`` about twice a second in a thread:
    (wall time, the card's duty, {pod: attributed core %}) each."""

    def __init__(self, base):
        import threading

        self.base, self.rows, self.last = base, [], None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            code, text = _http(self.base + "/debug/allocations")
            if code == 200:
                table = json.loads(text)
                self.last = table
                chips = table.get("chips") or [{}]
                self.rows.append((time.time(), chips[0].get(
                    "duty_cycle_percent"), {
                    p["pod"]: p.get("used_core_percent")
                    for p in table.get("pods", [])}))
            self._stop.wait(0.5)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def window(self, start, end) -> dict:
        """Duty p50 and each pod's attributed p50 over [start, end]."""
        rows = [r for r in self.rows if start <= r[0] <= end]
        duty = [r[1] for r in rows if r[1] is not None]
        pods = sorted({p for r in rows for p in r[2]})
        return dict(samples=len(rows),
                    duty_p50=float(np.median(duty)) if duty else None,
                    pods={p: float(np.median(v)) if v else None
                          for p in pods for v in [[
                              r[2][p] for r in rows
                              if r[2].get(p) is not None]]})


def _wait(what, fn, timeout_s=MIG_WAIT_S, period_s=0.02, phase="migration"):
    """fn()'s first truthy value within ``timeout_s``; None (a failed
    check) after it."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(period_s)
    fail(f"{phase}: {what} within {timeout_s:.0f} s")
    return None


def _spec(d, h) -> dict:
    try:
        with open(os.path.join(d, "alloc", f"{h}.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def run_migration(torch, D, srv, streams, dev) -> dict:
    """Phase 29: the port's agent drains a runner tenant, which streams
    pre-copy rounds until the coordinator's cutover, is reclaimed early on
    its ack, recorded, and resumed by a replacement pod from the restore
    env the agent stamps (module docstring)."""
    import shutil
    import signal
    import tempfile

    from elastic_tpu_agent_torch.common import (
        AnnotationAssumed, AnnotationDrain, BytesPerMemoryUnit,
        EnvDrain, EnvDrainDeadline, EnvRestoreDir, EnvRestoreStep,
        ResourceGPUCore, ResourceGPUMemory, container_annotation)
    from elastic_tpu_agent_torch.device import NvidiaOperator
    from elastic_tpu_agent_torch.migration import migration_object_name
    from elastic_tpu_agent_torch.nri import plugin as NRI
    from elastic_tpu_agent_torch.workloads import telemetry as T

    props = torch.cuda.get_device_properties(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"launches": {k: 0 for k in KERNEL_NAMES}}
    d = tempfile.mkdtemp(prefix="cs29", dir="/tmp")
    api = poller = None
    alive = []
    try:
        chips = [c for c in NvidiaOperator(
            "/dev", maintenance=lambda: None,
            preemption=lambda: None).devices()
            if _uuid_key(c.uuid) == _uuid_key(props.uuid)]
        if len(chips) != 1:
            fail(f"migration: no single card of uuid {props.uuid}")
            return out
        chip = chips[0]
        units = chip.hbm_bytes // BytesPerMemoryUnit
        pods = {p: (core, units // share if share else 0)
                for p, (core, share) in MIG_PODS.items()}
        api = _load_tests_module("fake_apiserver").FakeAPIServer()
        url = api.start()
        node = "h100-node"
        api.add_node(node)
        os.makedirs(os.path.join(d, "dev"))
        _write_json(os.path.join(d, "kubeconfig"), {
            "current-context": "c",
            "contexts": [{"name": "c", "context": {"cluster": "local",
                                                   "user": "agent"}}],
            "clusters": [{"name": "local", "cluster": {"server": url}}],
            "users": [{"name": "agent", "user": {"token": "phase-29"}}]})
        _write_json(os.path.join(d, "card.json"), dict(
            node=node, core_units=0, mem_units=0,
            core_resource=ResourceGPUCore, mem_resource=ResourceGPUMemory))
        _write_json(os.path.join(d, "pods.json"), pods)

        def admit(pod, uid):
            api.upsert_pod({"metadata": {
                "namespace": "default", "name": pod, "uid": uid,
                "annotations": {
                    AnnotationAssumed: "true",
                    container_annotation("main"): str(chip.index)}},
                "spec": {"nodeName": node,
                         "containers": [{"name": "main"}]}})

        for pod in pods:
            admit(pod, f"uid-{pod}")
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        db = os.path.join(d, "meta.db")
        _write_json(os.path.join(d, "mig.json"), {"argv": [
            "--node-name", node, "--db-file", db,
            "--kubeconf", os.path.join(d, "kubeconfig"),
            "--operator", "nvidia", "--dev-root", os.path.join(d, "dev"),
            "--alloc-spec-dir", os.path.join(d, "alloc"),
            "--device-plugin-dir", os.path.join(d, "dp"),
            "--pod-resources-socket", os.path.join(d, "pr.sock"),
            "--metrics-port", str(port), *MIG_FLAGS]})
        agent = _AgentChild("E", d)
        alive.append(agent)
        bound = _read_json(os.path.join(d, "bound.json"), AGENT_WAIT_S)
        if not bound or "error" in bound:
            agent.kill()
            agent.result(time.perf_counter() + 1)
            fail(f"migration agent never bound: {bound}")
            return out
        hashes = bound["hashes"]
        ht, hs = hashes["pod-t"][0], hashes["pod-s"][0]
        trace_t = _spec(d, ht)["env"].get("ELASTIC_TPU_TRACE_ID", "")

        def pod_env(h):
            """The tenant's env from the pod's spec alone: the injection's
            env, its hash, and the pod's mount of the alloc dir."""
            spec_path = os.path.join(d, "alloc", f"{h}.json")
            adj = NRI.plain_adjustment(_spec(d, h), os.stat, "/dev",
                                       spec_path)
            return dict(adj["env"], TPU=h,
                        ELASTIC_TPU_ALLOC_DIR=os.path.join(d, "alloc"),
                        ELASTIC_TPU_RESTORE_WAIT_S="0")

        data = _runtime_data(D, os.path.join(d, "tokens.bin"))
        ref = (f"{data} --steps {MIG_STEPS} --warmup-steps 5 "
               f"--total-steps {MIG_STEPS}")
        ck = os.path.join(d, "ckpt")
        fr = os.path.join(d, "fr.jsonl")
        drained_args = (f"{ref} --precopy-every {MIG_PRECOPY_EVERY} "
                        f"--checkpoint-every 0 --checkpoint-dir {ck} "
                        f"--flight-recorder {fr}")
        b1, b2 = os.path.join(d, "b1"), os.path.join(d, "b2")
        os.makedirs(b1)
        os.makedirs(b2)
        t_ten = _Tenant("mig_t", "train2", d, env=pod_env(ht),
                        strip=PLUGIN_ENV_STRIP, runner_args=ref,
                        runner_args2=drained_args, barrier=b1, barrier2=b2,
                        profile_busy=True)
        s_ten = _Tenant("mig_s", "serve", d, env=pod_env(hs),
                        strip=PLUGIN_ENV_STRIP, barrier=b1,
                        profile_busy=True)
        alive += [t_ten, s_ten]
        poller = _AllocPoller(base)
        _wait("both tenants ready", lambda: len(os.listdir(b1)) >= 2,
              timeout_s=TENANT_TIMEOUT_S)
        open(os.path.join(b1, "go"), "w").close()
        srep = s_ten.result(time.perf_counter() + TENANT_TIMEOUT_S)
        _wait("tenant T's uninterrupted run", lambda: os.listdir(b2),
              timeout_s=TENANT_TIMEOUT_S)
        table = poller.last or {}
        poller.close()

        # the sampler while both worked, beside each tenant's profiler
        listed = sorted(p["pod"] for p in table.get("pods", []))
        chip_rows = table.get("chips") or [{}]
        have_1m = chip_rows[0].get("duty_cycle_percent") is not None and all(
            (p.get("windows") or {}).get("1m", {}).get("samples", 0) > 0
            for p in table.get("pods", []))
        if srep:
            if srep["streams"] != streams:
                fail("migration: serving tenant streams differ from "
                     "phase 4's")
            if srep["launches"]["paged_decode"] != srv["paged_launches"]:
                fail(f"migration: serving launches {srep['launches']}")
            out["launches"]["paged_decode"] += srep["launches"][
                "paged_decode"]
        if listed != ["default/pod-s", "default/pod-t"] or not have_1m:
            fail(f"migration: /debug/allocations pods {listed}, card row "
                 f"{chip_rows[0]}")
        rc, bundle_out, err = _doctor([
            "--agent-url", base, "--operator", "nvidia", "--dev-root",
            "/dev", "--db-file", db, "--alloc-spec-dir",
            os.path.join(d, "alloc"), "--samples", "1"])
        bundle_path = os.path.join(d, "bundle.json")
        with open(bundle_path, "w") as f:
            f.write(bundle_out)
        rc_v, _, err_v = _doctor(["--validate", bundle_path])
        print(f"migration doctor: node-doctor (live) exit {rc}, --validate "
              f"exit {rc_v}")
        if rc or rc_v:
            fail(f"migration node-doctor: {err[-500:]} {err_v[-500:]}")

        # S done: its pod goes, and GC reclaims it before the drain
        api.delete_pod("default", "pod-s")
        assigned = _read_json(os.path.join(d, "assign.json"))
        assigned.pop("default/pod-s", None)
        _write_json(os.path.join(d, "assign.json"), assigned)
        _wait("pod S reclaimed", lambda: "default/pod-s" not in {
            p["pod"] for p in _http_json(
                base + "/debug/allocations").get("pods", [])})

        # the drain: the node annotation at the apiserver
        t_ann = time.time()
        api.annotate_node(node, AnnotationDrain, "true")
        stamped = _wait("T's spec signalled", lambda: {
            k: v for k, v in _spec(d, ht).get("env", {}).items()
            if k in (EnvDrain, EnvDrainDeadline)} or None, period_s=0.005)
        t_signal_seen = time.time()
        open(os.path.join(b2, "go"), "w").close()   # T's drained run
        trep = t_ten.result(time.perf_counter() + TENANT_TIMEOUT_S)
        mig_name = migration_object_name("default", "pod-t")
        rec_obj = _wait("T's MigrationRecord", lambda: api._crds.get(
            mig_name)) or {}
        mig = _wait("T reclaimed early", lambda: (lambda m: m if m.get(
            "early_reclaims_total") else None)(_http_json(
                base + "/debug/allocations").get("migration") or {})) or {}
        drain = _wait("the drain drained", lambda: (lambda x: x if x.get(
            "state") == "drained" else None)(_http_json(
                base + "/debug/allocations").get("drain") or {})) or {}
        metrics_text = _http(base + "/metrics")[1]
        sm = _samples(metrics_text)
        rows = _http_json(base + "/debug/timeline?pod=default/pod-t"
                          "&limit=1000")["events"]
        node_rows = _http_json(base + "/debug/timeline?limit=1000")["events"]
        trans = [(e["ts"], e["attrs"].get("state")) for e in node_rows
                 if e["kind"] == "drain_transition"]
        cordons = [e["attrs"].get("cordoned") for e in node_rows
                   if e["kind"] == "cordon"]
        early = [e for e in rows if e["kind"] == "migration"
                 and e["attrs"].get("action") == "early_reclaim"]
        record = (rec_obj.get("spec") or {}).get("migration") or {}
        pre = record.get("precopy") or {}
        runs = (trep or {}).get("runs") or [{}, {}]
        first, second = runs[0].get("report", {}), runs[1].get("report", {})
        t_cordon = next((ts for ts, st in trans if st == "cordoned"), None)
        signal_s = sm.get(("elastic_tpu_drain_phase_seconds_sum",
                           (("phase", "cordon_to_signaled"),)))
        ack_ts = record.get("ack_ts")
        ms = {}
        if t_cordon is not None and signal_s is not None and ack_ts:
            ms = dict(cordon_to_signaled=signal_s * 1e3,
                      signaled_to_acked=(ack_ts - t_cordon - signal_s) * 1e3,
                      acked_to_reclaimed=((early[-1]["ts"] - ack_ts) * 1e3
                                          if early else None),
                      annotation_to_cordon=(t_cordon - t_ann) * 1e3,
                      annotation_to_spec_seen=(t_signal_seen - t_ann) * 1e3)
        flight = [r for r in (T.load_jsonl(fr) if os.path.exists(fr)
                              else []) if r["kind"] in ("precopy_round",
                                                        "cutover")]
        events = {(e["involvedObject"].get("name"), e["reason"])
                  for e in api.core_events}
        print(f"migration drain ({smi}): annotation -> cordoned "
              f"{ms.get('annotation_to_cordon', float('nan')):.1f} ms; "
              f"cordon -> signaled {ms.get('cordon_to_signaled', 0):.1f} ms, "
              f"signaled -> acked {ms.get('signaled_to_acked', 0):.1f} ms, "
              f"acked -> reclaimed {ms.get('acked_to_reclaimed') or 0:.1f} "
              f"ms, beside the {MIG_DEADLINE_S:.0f} s deadline; states "
              f"{[st for _, st in trans]}, cordon rows {cordons}")
        print(f"migration pre-copy ({smi}): " + "; ".join(
            f"{r['kind']} {r['round']} at step {r['step']}: "
            f"{r['delta_bytes']} of {r['total_bytes']} bytes in "
            f"{r['duration_ms']:.1f} ms" for r in flight)
            + f"; the coordinator saw {pre.get('rounds')} round(s), cut "
            f"over on {pre.get('cutover_reason')!r}, cutover_ms "
            f"{pre.get('cutover_ms')}; the run stopped at step "
            f"{second.get('start_step', 0) + second.get('steps', 0)} of "
            f"{MIG_STEPS}")
        checks = {
            "states": [st for _, st in trans][:2] == ["cordoned", "draining"],
            "cordoned": bool(cordons) and cordons[0] is True,
            "stamped": (stamped or {}).get(EnvDrain) == "operator:annotation"
            and EnvDrainDeadline in (stamped or {}),
            "drained run": second.get("lifecycle_signal") == "drain"
            and second.get("precopy_rounds", 0) >= 1,
            # the coordinator's stamp (converged, the round cap or the
            # deadline margin), not the runner's own end of budget
            "cutover by the coordinator": (mig.get("cutovers_total") or 0)
            >= 1 and pre.get("cutover_reason") in (
                "converged", "rounds", "deadline"),
            "record": rec_obj.get("status", {}).get("phase") == "Migrated"
            and record.get("trace") == trace_t and bool(trace_t)
            and record.get("digest") and record.get("step") is not None
            and record.get("mode") == "precopy",
            "early": bool(early) and ack_ts is not None
            and early[-1]["ts"] < t_cordon + MIG_DEADLINE_S,
            "outcome": drain.get("outcome") == "drained_acked",
            "early metric": sm.get((
                "elastic_tpu_drain_early_reclaims_total", ())) == 1.0,
            "events": {(node, "TPUNodeDraining"),
                       ("pod-t", "TPUMigrationRecorded")} <= events,
        }
        print(f"migration record: {mig_name} phase "
              f"{rec_obj.get('status', {}).get('phase')}, step "
              f"{record.get('step')}, digest {record.get('digest')}, trace "
              f"{record.get('trace')} (T's bind {trace_t}); outcome "
              f"{drain.get('outcome')}; checks {checks}")
        for k, ok in checks.items():
            if not ok:
                fail(f"migration drain check {k!r} failed")

        # the replacement: the annotation cleared, T deleted, a new pod
        # of T's namespace and name bound
        api.annotate_node(node, AnnotationDrain, None)
        _wait("the drain cancelled", lambda: (_http_json(
            base + "/debug/allocations").get("drain") or {}).get(
            "state") == "active")
        api.delete_pod("default", "pod-t")
        assigned = _read_json(os.path.join(d, "assign.json"))
        assigned.pop("default/pod-t", None)
        _write_json(os.path.join(d, "assign.json"), assigned)
        admit("pod-t", "uid-pod-t-2")
        t_req = time.time()
        _write_json(os.path.join(d, "bind-1.json"),
                    {"pods": {"pod-t": pods["pod-t"]}})
        bound2 = _read_json(os.path.join(d, "bound-1.json"), MIG_WAIT_S)
        if not bound2 or "error" in bound2:
            fail(f"migration replacement never bound: {bound2}")
            return out
        h2 = bound2["hashes"]["pod-t"][0]
        restore = _wait("the restore stamp", lambda: {
            k: v for k, v in _spec(d, h2).get("env", {}).items()
            if k in (EnvRestoreDir, EnvRestoreStep)} if EnvRestoreStep in
            _spec(d, h2).get("env", {}) else None, period_s=0.005) or {}
        t_stamped = time.time()
        step = int(restore.get(EnvRestoreStep, "-1"))
        r_ten = _Tenant("mig_t2", "train", d, env=pod_env(h2),
                        strip=PLUGIN_ENV_STRIP, runner_args=(
                            f"{data} --steps {MIG_STEPS - step - 1} "
                            f"--warmup-steps 5 --total-steps {MIG_STEPS}"))
        alive.append(r_ten)
        rrep = r_ten.result(time.perf_counter() + TENANT_TIMEOUT_S)
        resumed = (rrep or {}).get("report", {})
        done = _wait("the verified resume", lambda: (lambda m: m if m.get(
            "completed_total") else None)(_http_json(
                base + "/debug/allocations").get("migration") or {})) or {}
        t_done = time.time()
        sm2 = _samples(_http(base + "/metrics")[1])
        rows2 = _http_json(base + "/debug/timeline?pod=default/pod-t"
                           "&limit=1000")["events"]
        completed = [e for e in rows2 if e["kind"] == "migration"
                     and e["attrs"].get("action") == "completed"]
        events = {(e["involvedObject"].get("name"), e["reason"])
                  for e in api.core_events}
        gap = (abs(resumed.get("final_loss", float("nan"))
                   - first.get("final_loss", float("nan")))
               if resumed and first else float("nan"))
        launches = {"t_reference": runs[0].get("launches"),
                    "t_drained": runs[1].get("launches"),
                    "t_resumed": (rrep or {}).get("launches")}
        for run in launches.values():
            for k in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
                out["launches"][k] += (run or {}).get(k, 0)
        print(f"migration resume ({smi}): replacement bind -> restore "
              f"stamped {(t_stamped - t_req) * 1e3:.1f} ms, -> verified "
              f"{(t_done - t_req) * 1e3:.1f} ms (the resumed run's tenant "
              f"{rrep.get('seconds', 0) if rrep else 0:.1f} s of it); "
              f"resumed at step {resumed.get('start_step')} from "
              f"{restore.get(EnvRestoreDir)}, final loss "
              f"{resumed.get('final_loss')} vs uninterrupted "
              f"{first.get('final_loss')}: gap {gap:.3g} (limit "
              f"{RESUME_TOL}); flash launches {launches}")
        rchecks = {
            "resumed": resumed.get("resumed_from_migration") is True
            and resumed.get("start_step") == step + 1
            and resumed.get("platform") == "gpu",
            "loss": gap <= RESUME_TOL,
            "completed": done.get("completed_total") == 1
            and sm2.get(("elastic_tpu_migrations_completed_total", ()))
            == 1.0,
            "event": ("pod-t", "TPUMigrationCompleted") in events,
            "timeline": bool(completed) and completed[-1]["keys"].get(
                "trace") == trace_t,
        }
        print(f"migration resume checks {rchecks}")
        for k, ok in rchecks.items():
            if not ok:
                fail(f"migration resume check {k!r} failed")

        # the sampler's window beside the profilers' busy shares
        tb = runs[0].get("busy") or {}
        sb = (srep or {}).get("busy") or {}
        win = {}
        if tb.get("start") and sb.get("start"):
            win = poller.window(max(tb["start"], sb["start"]),
                                min(tb["end"], sb["end"]))
        spans = [b.get("end", 0) - b.get("start", 0) for b in (tb, sb)]
        print(f"migration sampler ({smi}): while both tenants worked, "
              f"{win.get('samples')} sample(s) of /debug/allocations: card "
              f"duty p50 {win.get('duty_p50')}%, attributed core % p50 "
              f"{win.get('pods')}; the profilers' device-busy shares: T "
              f"{tb.get('busy_share')} over {spans[0]:.2f} s, S "
              f"{sb.get('busy_share')} over {spans[1]:.2f} s (shown, not "
              "judged)")
        agent.proc.send_signal(signal.SIGTERM)
        arep = agent.result(time.perf_counter() + 60)
        print(f"migration agent: exit {arep.get('rc')}, torch imported "
              f"{arep.get('torch_imported')}, subsystems "
              f"{arep.get('subsystems')}")
        if arep.get("rc") != 0 or arep.get("torch_imported") is not False:
            fail(f"migration agent: {arep}")
        out.update(
            card=smi, host_ms=ms, deadline_s=MIG_DEADLINE_S,
            precopy=dict(rounds_seen=pre.get("rounds"),
                         cutover_reason=pre.get("cutover_reason"),
                         cutover_ms=pre.get("cutover_ms"),
                         runner_rounds=second.get("precopy_rounds"),
                         flight=flight),
            record=dict(step=record.get("step"), digest=record.get("digest"),
                        trace=record.get("trace")),
            outcome=drain.get("outcome"),
            resume=dict(start_step=resumed.get("start_step"),
                        final_loss=resumed.get("final_loss"),
                        reference_loss=first.get("final_loss"), gap=gap,
                        bind_to_stamped_ms=(t_stamped - t_req) * 1e3,
                        bind_to_verified_ms=(t_done - t_req) * 1e3),
            sampler=dict(window=win, t_busy=tb, s_busy=sb),
            run_launches=launches, checks=checks, resume_checks=rchecks,
            runs={k: {f: r.get(f) for f in (
                "steps", "start_step", "final_loss", "step_time_ms",
                "tokens_per_s", "precopy_rounds", "lifecycle_signal")}
                for k, r in (("t_reference", first), ("t_drained", second),
                             ("t_resumed", resumed))})
    finally:
        if poller is not None:
            poller.close()
        for p in alive:
            p.kill()
        if api is not None:
            api.stop()
        shutil.rmtree(d, ignore_errors=True)
    return out


# Phase 30: three pods opted into live re-partitioning, each a tenant
# that reports its own measured device-busy share.
# core units (None: sized by a run of B's workload beside O's), memory
# share divisor (0: no memory), QoS priority
REP_PODS = {"pod-d": (40, 4, "high"),
            "pod-b": (None, 4, "high"),
            "pod-o": (1, 0, "low")}
REP_EVICT_AFTER_S = 60.0          # --qos-evict-after
REP_B_STEPS = 300                 # B's run: phase 6's preset and file,
REP_B_SHAPE = "--batch 2"         # at a batch that keeps its share small
REP_SIZING_STEPS = 150            # the sizing run of B's workload
REP_O_SHAPE = "--batch 32 --seq 512"   # O's run: the small preset, busier
REP_O_STEPS = 100000              # O trains until it is stopped
REP_REPLAY_PERIODS = 3            # reconcile periods O's assignment stays
REP_FLAGS = ["--sampler-period", "1", "--repartition-period", "1",
             "--migration-period", "0.5", "--goodput-period", "1",
             "--reconcile-period", "1",
             "--qos-evict-after", str(REP_EVICT_AFTER_S)]


def agent_rep_main(args) -> int:
    """Phase 30's agent (``--agent F``): ``_cli_agent`` on ``rep.json``'s
    flags, binding the pods of ``pods.json`` and then those of each bind
    request. Prints one JSON line."""
    d = args.agent_dir
    pods = {k: tuple(v) for k, v in _read_json(
        os.path.join(d, "pods.json")).items()}
    rc, mgr = _cli_agent(d, "rep.json", pods, follow=True)
    print(json.dumps(dict(
        rc=rc, torch_imported="torch" in sys.modules,
        subsystems={k: v["state"] for k, v in
                    mgr.supervisor.status().items()} if mgr else {})))
    return 0


class _RepWatch:
    """Polls each pod's spec env (the quota and throttle keys), usage
    report and ack file every 10 ms in a thread; keeps (wall time, value)
    at each change (None: no file)."""

    KEYS = ("ELASTIC_TPU_CORE_UNITS", "ELASTIC_TPU_HBM_LIMIT_BYTES",
            "ELASTIC_TPU_HBM_FRACTION", "ELASTIC_TPU_THROTTLE",
            "ELASTIC_TPU_THROTTLE_DEADLINE")

    def __init__(self, d, hashes):
        import threading

        self.d, self.hashes = d, hashes
        self.spec = {p: [] for p in hashes}
        self.report = {p: [] for p in hashes}
        self.ack = {p: [] for p in hashes}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _file(self, sub, h):
        try:
            with open(os.path.join(self.d, "alloc", sub, f"{h}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def _note(series, now, value):
        if not series or series[-1][1] != value:
            series.append((now, value))

    def _run(self):
        while not self._stop.is_set():
            for p, h in self.hashes.items():
                now = time.time()
                spec = _spec(self.d, h)
                self._note(self.spec[p], now, {
                    k: v for k, v in spec.get("env", {}).items()
                    if k in self.KEYS} if spec else None)
                rep = self._file("usage", h)
                self._note(self.report[p], now, None if rep is None else (
                    rep.get("ts"), rep.get("duty_cycle_percent")))
                ack = self._file("ack", h)
                self._note(self.ack[p], now, None if ack is None else (
                    ack.get("ts"), ack.get("step"), ack.get("signal")))
            self._stop.wait(0.01)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def units(self, pod):
        """The pod's stamped core units now (None: no spec)."""
        env = self.spec[pod][-1][1] if self.spec[pod] else None
        return None if env is None else int(env.get(
            "ELASTIC_TPU_CORE_UNITS", "-1"))

    def first(self, series, pred, after=0.0):
        """The first (wall, value) of ``series`` after ``after`` whose
        value satisfies ``pred``; None when none does."""
        return next(((t, v) for t, v in series
                     if t >= after and pred(v)), None)


def run_repartition(torch, D, srv, streams, dev) -> dict:
    """Phase 30: the port's agent moves gpu-core quota between two tenants
    and back, throttles and evicts an overcommitting runner with its work
    kept, and accounts every second of each pod's life (module
    docstring)."""
    import shutil
    import signal
    import tempfile

    from elastic_tpu_agent_torch.common import (
        AnnotationAssumed, BytesPerMemoryUnit, ResourceGPUCore,
        ResourceGPUMemory, container_annotation)
    from elastic_tpu_agent_torch.device import NvidiaOperator
    from elastic_tpu_agent_torch.device.qos import (
        AnnotationQoSPriority, AnnotationRepartition)
    from elastic_tpu_agent_torch.migration import migration_object_name
    from elastic_tpu_agent_torch.nri import plugin as NRI
    from elastic_tpu_agent_torch.repartition import (
        DEFAULT_BUSY_FRAC as BUSY, DEFAULT_OVERCOMMIT_MARGIN as MARGIN)

    props = torch.cuda.get_device_properties(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"launches": {k: 0 for k in KERNEL_NAMES}}
    d = tempfile.mkdtemp(prefix="cs30", dir="/tmp")
    api = poller = watch = None
    alive = []

    def wait(what, fn, timeout_s=MIG_WAIT_S, period_s=0.02):
        return _wait(what, fn, timeout_s, period_s, phase="repartition")

    try:
        chips = [c for c in NvidiaOperator(
            "/dev", maintenance=lambda: None,
            preemption=lambda: None).devices()
            if _uuid_key(c.uuid) == _uuid_key(props.uuid)]
        if len(chips) != 1:
            fail(f"repartition: no single card of uuid {props.uuid}")
            return out
        chip = chips[0]
        units = chip.hbm_bytes // BytesPerMemoryUnit
        pods = {p: (core, units // share if share else 0)
                for p, (core, share, _) in REP_PODS.items()
                if core is not None}
        grants = {p: core for p, (core, _, _) in REP_PODS.items()}
        api = _load_tests_module("fake_apiserver").FakeAPIServer()
        url = api.start()
        node = "h100-node"
        api.add_node(node)
        os.makedirs(os.path.join(d, "dev"))
        _write_json(os.path.join(d, "kubeconfig"), {
            "current-context": "c",
            "contexts": [{"name": "c", "context": {"cluster": "local",
                                                   "user": "agent"}}],
            "clusters": [{"name": "local", "cluster": {"server": url}}],
            "users": [{"name": "agent", "user": {"token": "phase-30"}}]})
        _write_json(os.path.join(d, "card.json"), dict(
            node=node, core_units=0, mem_units=0,
            core_resource=ResourceGPUCore, mem_resource=ResourceGPUMemory))
        _write_json(os.path.join(d, "pods.json"), pods)
        for pod, (_, _, priority) in REP_PODS.items():
            api.upsert_pod({"metadata": {
                "namespace": "default", "name": pod, "uid": f"uid-{pod}",
                "annotations": {
                    AnnotationAssumed: "true",
                    container_annotation("main"): str(chip.index),
                    AnnotationRepartition: "true",
                    AnnotationQoSPriority: priority}},
                "spec": {"nodeName": node,
                         "containers": [{"name": "main"}]}})
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        db = os.path.join(d, "meta.db")
        _write_json(os.path.join(d, "rep.json"), {"argv": [
            "--node-name", node, "--db-file", db,
            "--kubeconf", os.path.join(d, "kubeconfig"),
            "--operator", "nvidia", "--dev-root", os.path.join(d, "dev"),
            "--alloc-spec-dir", os.path.join(d, "alloc"),
            "--device-plugin-dir", os.path.join(d, "dp"),
            "--pod-resources-socket", os.path.join(d, "pr.sock"),
            "--metrics-port", str(port), *REP_FLAGS]})
        agent = _AgentChild("F", d)
        alive.append(agent)
        data = _runtime_data(D, os.path.join(d, "tokens.bin"))
        b_args = (f"{data} {REP_B_SHAPE} --steps {REP_B_STEPS} "
                  f"--warmup-steps 5 --total-steps {REP_B_STEPS} "
                  f"--checkpoint-every 0")
        o_args = (f"{data} {REP_O_SHAPE} --steps {REP_O_STEPS} "
                  f"--warmup-steps 5 --total-steps {REP_O_STEPS} "
                  f"--checkpoint-every 0")
        # B's grant is its request sized to what its workload uses on this
        # card (its share moved 1.7x between calls, and read 0.6-1.3x the
        # p50 of a run just before while O trained beside it; alone, run
        # to run within 9%): a short run of B's workload alone, outside
        # any pod, its shares written into a scratch dir. The growth band
        # [busy_frac x grant, grant + margin] is centred, as a factor, on
        # the p50 of B's shares, its first window (the runner's start-up)
        # left out (in the pods B read 0.78-1.28x that p50);
        # B's small batch keeps its share, and so its grant, small, where
        # that band is widest (its top is 2.5x its floor at 4 units, 1.57x
        # at 12). In the pods B trains alone too: D has served its
        # requests and O has been stopped before B starts
        os.makedirs(os.path.join(d, "sizing"))
        sized = _Tenant("rep_size_b", "train", d, env=dict(
            CUDA_VISIBLE_DEVICES=chip.uuid, TPU="sizing-b",
            ELASTIC_TPU_ALLOC_DIR=os.path.join(d, "sizing"),
            ELASTIC_TPU_RESTORE_WAIT_S="0"), strip=PLUGIN_ENV_STRIP,
            runner_args=(f"{data} {REP_B_SHAPE} --steps {REP_SIZING_STEPS} "
                         f"--warmup-steps 5 --total-steps {REP_SIZING_STEPS} "
                         f"--checkpoint-every 0"), usage_report=True)
        alive.append(sized)
        size_rep = sized.result(time.perf_counter() + TENANT_TIMEOUT_S)
        size_shares = [v for t, v in size_rep.get("usage_reports", [])
                       if size_rep["work_start"] < t
                       <= size_rep["work_end"] + REP_REPORT_S][1:]
        size = float(np.median(size_shares)) if size_shares else 0.0
        # g with busy_frac x g x (g + margin) = p50^2: the p50 as far
        # (as a factor) from the band's floor as from its top
        grants["pod-b"] = max(2, round((math.sqrt(
            (BUSY * MARGIN) ** 2 + 4 * BUSY * size ** 2)
            - BUSY * MARGIN) / (2 * BUSY)))
        for k in KERNEL_NAMES:
            out["launches"][k] += size_rep.get("launches", {}).get(k, 0)
        print(f"repartition sizing ({smi}): B's workload alone, outside "
              f"any pod: shares {size_shares}, p50 "
              f"{size:.3f}%: B requests {grants['pod-b']} gpu-core units "
              f"(growth band {BUSY * grants['pod-b']:.1f}-"
              f"{grants['pod-b'] + MARGIN:.1f}%)")
        bound = _read_json(os.path.join(d, "bound.json"), AGENT_WAIT_S)
        if not bound or "error" in bound:
            agent.kill()
            agent.result(time.perf_counter() + 1)
            fail(f"repartition agent never bound: {bound}")
            return out
        _write_json(os.path.join(d, "bind-1.json"), {"pods": {
            "pod-b": (grants["pod-b"], units // REP_PODS["pod-b"][1])}})
        bound_b = _read_json(os.path.join(d, "bound-1.json"), AGENT_WAIT_S)
        if not bound_b or "error" in bound_b:
            fail(f"repartition: B never bound: {bound_b}")
            return out
        hashes = {p: (bound_b if p == "pod-b" else bound)["hashes"][p][0]
                  for p in REP_PODS}
        keys = {p: f"default/{p}" for p in REP_PODS}

        def pod_env(h):
            """The tenant's env from the pod's spec alone (phase 29's)."""
            spec_path = os.path.join(d, "alloc", f"{h}.json")
            adj = NRI.plain_adjustment(_spec(d, h), os.stat, "/dev",
                                       spec_path)
            return dict(adj["env"], TPU=h,
                        ELASTIC_TPU_ALLOC_DIR=os.path.join(d, "alloc"),
                        ELASTIC_TPU_RESTORE_WAIT_S="0")

        o_args += f" --checkpoint-dir {os.path.join(d, 'ckpt-o')}"
        hold = os.path.join(d, "hold")
        go = {p: os.path.join(d, f"go-{p}") for p in REP_PODS}
        for sub in (hold, *go.values()):
            os.makedirs(sub)
        watch = _RepWatch(d, hashes)
        poller = _AllocPoller(base)
        tenants = {
            "pod-d": _Tenant("rep_d", "serve", d, env=pod_env(
                hashes["pod-d"]), strip=PLUGIN_ENV_STRIP,
                barrier=go["pod-d"], usage_report=True, hold=hold),
            "pod-b": _Tenant("rep_b", "train", d, env=pod_env(
                hashes["pod-b"]), strip=PLUGIN_ENV_STRIP,
                barrier=go["pod-b"], runner_args=b_args, usage_report=True,
                hold=hold),
            "pod-o": _Tenant("rep_o", "train", d, env=pod_env(
                hashes["pod-o"]), strip=PLUGIN_ENV_STRIP,
                barrier=go["pod-o"], runner_args=o_args, usage_report=True),
        }
        alive += list(tenants.values())
        wait("the tenants ready and reporting", lambda: all(
            os.listdir(go[p]) and watch.report[p] and watch.report[p][-1][1]
            for p in REP_PODS), timeout_s=TENANT_TIMEOUT_S)
        # D serves its requests, then O trains, then B: each tenant's
        # share is its own, not its neighbour's
        t_go = time.time()
        open(os.path.join(go["pod-d"], "go"), "w").close()
        wait("D's requests served", lambda: any(
            n.endswith(".done") for n in os.listdir(hold)),
             timeout_s=TENANT_TIMEOUT_S)
        open(os.path.join(go["pod-o"], "go"), "w").close()

        def allocations():
            return _http_json(base + "/debug/allocations")

        def edges():
            return (allocations().get("repartition") or {}).get("edges", [])

        # throttle -> ack -> evict: O over its grant on its own reports
        throttled = wait("O's spec throttled", lambda: watch.first(
            watch.spec["pod-o"], lambda v: v is not None
            and "ELASTIC_TPU_THROTTLE" in v))
        acked = wait("O's ack", lambda: watch.first(
            watch.ack["pod-o"], lambda v: v is not None),
            timeout_s=REP_EVICT_AFTER_S)
        evicted = wait("O evicted", lambda: watch.first(
            watch.spec["pod-o"], lambda v: v is None,
            after=throttled[0] if throttled else 0.0),
            timeout_s=REP_EVICT_AFTER_S + 30)
        t_evicted = time.time()
        mig_name = migration_object_name("default", "pod-o")
        rec_obj = wait("O's MigrationRecord", lambda: api._crds.get(
            mig_name)) or {}
        record = (rec_obj.get("spec") or {}).get("migration") or {}
        # the kubelet still lists O's assignment: no replay for 3 periods
        time.sleep(REP_REPLAY_PERIODS * 1.25 + 0.5)
        table = allocations()
        rep_status = table.get("repartition") or {}
        rows_o = _http_json(base + "/debug/timeline?pod=default/pod-o"
                            "&limit=1000")["events"]
        sm = _samples(_http(base + "/metrics")[1])
        events = {(e["involvedObject"].get("name"), e["reason"])
                  for e in api.core_events}
        deadline = (float(throttled[1]["ELASTIC_TPU_THROTTLE_DEADLINE"])
                    if throttled else None)
        links_o = [n for n in os.listdir(os.path.join(d, "dev"))
                   if hashes["pod-o"] in n]
        ms_o = {}
        if throttled and acked and evicted:
            ms_o = dict(throttle_to_ack=(acked[1][0] - throttled[0]) * 1e3,
                        ack_to_evict=(evicted[0] - acked[1][0]) * 1e3,
                        evict_before_deadline_s=deadline - evicted[0])
        ochecks = {
            "stamped": bool(throttled) and bool(throttled[1].get(
                "ELASTIC_TPU_THROTTLE_DEADLINE")),
            "acked": bool(acked) and acked[1][2] == "overcommit",
            "before the deadline": bool(evicted) and deadline is not None
            and evicted[0] < deadline,
            "record": rec_obj.get("status", {}).get("phase") == "Migrated"
            and record.get("reason") == "qos_evict",
            "reclaimed": not links_o and keys["pod-o"] not in {
                p["pod"] for p in table.get("pods", [])},
            "counters": sm.get(("elastic_tpu_throttles_total", ())) == 1.0
            and sm.get(("elastic_tpu_qos_evictions_total", ())) == 1.0,
            "events": {("pod-o", "TPUThrottled"),
                       ("pod-o", "TPUQoSEvicted")} <= events,
            "no replay": keys["pod-o"] in rep_status.get("evicted_pods", [])
            and not any(e["kind"] == "bind_replay" for e in rows_o)
            and keys["pod-o"] in (_read_json(os.path.join(
                d, "assign.json")) or {}),
        }
        print(f"repartition throttle ({smi}): O throttled "
              f"{throttled[1] if throttled else None}; host ms throttle -> "
              f"ack {ms_o.get('throttle_to_ack')}, ack -> evicted "
              f"{ms_o.get('ack_to_evict')}, evicted "
              f"{ms_o.get('evict_before_deadline_s')} s before the "
              f"{REP_EVICT_AFTER_S:.0f} s deadline; record {mig_name} "
              f"reason {record.get('reason')} step {record.get('step')}; "
              f"checks {ochecks}")
        for k, ok in ochecks.items():
            if not ok:
                fail(f"repartition throttle check {k!r} failed")

        # O's pod is killed as a kubelet would: SIGTERM; then B trains
        tenants["pod-o"].proc.send_signal(signal.SIGTERM)
        orep = tenants["pod-o"].result(time.perf_counter() + 120)
        open(os.path.join(go["pod-b"], "go"), "w").close()

        # grow: D idle, B busy -> core units D -> B, in both specs
        sum_grants = grants["pod-d"] + grants["pod-b"]
        grown = wait("the grow restamped in both specs", lambda: (
            lambda b, dd: (b, dd) if b is not None and dd is not None
            and b > grants["pod-b"] and b + dd == sum_grants else None)(
                watch.units("pod-b"), watch.units("pod-d")),
            timeout_s=60, period_s=0.005) or (None, None)
        t_grown = time.time()
        grow_edges = wait("the edge D -> B listed", lambda: [
            e for e in edges() if e["donor"] == keys["pod-d"]
            and e["borrower"] == keys["pod-b"]], timeout_s=10) or []
        # the move's trail follows its restamps: the row, the counter,
        # then the Event through the async sink
        wait("the grow's row, counter and Event", lambda: (
            ("pod-b", "TPURepartitioned") in {
                (e["involvedObject"].get("name"), e["reason"])
                for e in api.core_events}), timeout_s=10)
        rows_b = _http_json(base + "/debug/timeline?pod=default/pod-b"
                            "&limit=1000")["events"]
        sm = _samples(_http(base + "/metrics")[1])
        events = {(e["involvedObject"].get("name"), e["reason"])
                  for e in api.core_events}
        busy = watch.first(watch.report["pod-b"], lambda v: v is not None
                           and v[1] >= BUSY * grants["pod-b"])
        restamp = watch.first(watch.spec["pod-b"], lambda v: v is not None
                              and int(v.get("ELASTIC_TPU_CORE_UNITS", "0"))
                              > grants["pod-b"])
        grow_ms = ((restamp[0] - busy[1][0]) * 1e3
                   if busy and restamp else None)
        gchecks = {
            "both specs": grown[0] is not None,
            "metric": (sm.get(("elastic_tpu_repartitions_total",
                               (("direction", "grow"),))) or 0) >= 1,
            "event": ("pod-b", "TPURepartitioned") in events,
            "timeline": any(e["kind"] == "repartition"
                            and e["attrs"].get("direction") == "grow"
                            for e in rows_b),
            "edge listed": bool(grow_edges),
            "no unit to O": not any(e["borrower"] == keys["pod-o"]
                                    for e in edges()),
        }
        print(f"repartition grow ({smi}): ELASTIC_TPU_CORE_UNITS restamped "
              f"B {grants['pod-b']} -> {grown[0]}, D {grants['pod-d']} -> "
              f"{grown[1]} (a hint on this card: nothing time-slices SMs by "
              f"it); edge {grow_edges}; B's first busy report "
              f"{busy[1][1] if busy else None}% -> B's restamped spec "
              f"{grow_ms if grow_ms is None else round(grow_ms, 1)} ms "
              f"(host); checks {gchecks}")
        for k, ok in gchecks.items():
            if not ok:
                fail(f"repartition grow check {k!r} failed")

        # shrink: B's run ends, its reports go idle, the edge unwinds
        done_b = wait("B's run", lambda: [
            n for n in os.listdir(hold) if n.endswith(".done")
            and _read_json(os.path.join(hold, n)).get("report")],
            timeout_s=TENANT_TIMEOUT_S)
        b_run = _read_json(os.path.join(hold, done_b[0])) if done_b else {}
        unwound = wait("the edge unwound in both specs", lambda: (
            not edges() and watch.units("pod-b") == grants["pod-b"]
            and watch.units("pod-d") == grants["pod-d"]))
        t_unwound = time.time()
        # the last unwind, and B's last report before it: the one the
        # controller unwound on (below half its grown units)
        b_units = [(t, int(v.get("ELASTIC_TPU_CORE_UNITS", "0")))
                   for t, v in watch.spec["pod-b"] if v is not None]
        back = next((t for (t, u), (_, prev) in zip(
            reversed(b_units), reversed([(0, None)] + b_units[:-1]))
            if u == grants["pod-b"] and prev is not None
            and prev > grants["pod-b"]), None)
        trigger = next((v for _, v in reversed(watch.report["pod-b"])
                        if v is not None and back is not None
                        and v[0] < back), None)
        unwind_ms = (back - trigger[0]) * 1e3 if trigger else None
        shrunk = wait("the shrink counted", lambda: (_samples(_http(
            base + "/metrics")[1]).get(("elastic_tpu_repartitions_total", (
                ("direction", "shrink"),))) or 0) >= 1, timeout_s=10)
        sm = _samples(_http(base + "/metrics")[1])
        moves = {d_: sm.get(("elastic_tpu_repartitions_total", (
            ("direction", d_),))) for d_ in ("grow", "shrink")}
        schecks = {"specs at grants": bool(unwound), "metric": bool(shrunk)}
        print(f"repartition shrink ({smi}): B's report "
              f"{trigger[1] if trigger else None}% -> the unwind "
              f"{unwind_ms if unwind_ms is None else round(unwind_ms, 1)} "
              f"ms (host), B's run ending at {b_run.get('work_end')}; moves "
              f"{moves}; B's stamped units {b_units}; specs back to D "
              f"{watch.units('pod-d')}, B {watch.units('pod-b')}; checks "
              f"{schecks}")
        for k, ok in schecks.items():
            if not ok:
                fail(f"repartition shrink check {k!r} failed")
        time.sleep(2.5)          # two goodput periods past the last row
        good = _http_json(base + "/debug/goodput")
        node_rows = _http_json(base + "/debug/timeline?limit=100000")[
            "events"]
        known = {(e["keys"].get("node", ""), e["seq"]) for e in node_rows}
        sm = _samples(_http(base + "/metrics")[1])
        gp = good.get("pods", {})
        o_entry = gp.get(keys["pod-o"], {})
        o_states = {itv["state"] for itv in o_entry.get("intervals", [])}
        o_ck = [itv for itv in o_entry.get("intervals", [])
                if itv["state"] == "checkpointing"]
        unresolved = [(p, itv["state"]) for p, e in gp.items()
                      for itv in e.get("intervals", [])
                      if itv["state"] not in ("productive", "unattributed")
                      and (itv.get("cause") is None or (
                          itv["cause"].get("node", ""),
                          itv["cause"].get("seq")) not in known)]
        sums = {p: abs(sum(i["end"] - i["start"] for i in e["intervals"])
                       - e["lifetime_s"]) for p, e in gp.items()}
        ratios = {p: v for (n, lab), v in sm.items()
                  if n == "elastic_tpu_goodput_ratio"
                  for k, p in lab if k == "pod"}
        live = {p for p, e in gp.items() if e.get("live")}
        gchecks2 = {
            "pods": set(keys.values()) <= set(gp),
            "conserved": not good.get("conservation_problems")
            and all(v < 1e-6 for v in sums.values()),
            "O's states": {"queued", "productive", "checkpointing"}
            <= o_states and not o_entry.get("live")
            and bool(o_ck) and all(itv["cause"]["category"]
                                   == "qos_throttle" for itv in o_ck),
            "causes resolve": not unresolved,
            "downtime metric": (sm.get((
                "elastic_tpu_downtime_seconds_total",
                (("cause", "qos_throttle"),))) or 0) > 0,
            "ratio series": live == {keys["pod-d"], keys["pod-b"]}
            and live <= set(ratios),
        }
        o_down = {}
        for itv in o_entry.get("intervals", []):
            if itv["state"] != "productive" and itv.get("cause"):
                cat = itv["cause"]["category"]
                o_down[cat] = round(o_down.get(cat, 0.0) + itv["end"]
                                    - itv["start"], 6)
        print(f"repartition goodput ({smi}): ratios " + ", ".join(
            f"{p} {e.get('goodput_ratio')} over {e.get('lifetime_s')} s"
            for p, e in sorted(gp.items())) + f"; O's states "
            f"{o_entry.get('states')}, its downtime by cause {o_down}; "
            f"the node's {good.get('downtime_by_cause')}; checks "
            f"{gchecks2}")
        for k, ok in gchecks2.items():
            if not ok:
                fail(f"repartition goodput check {k!r} failed")
        rc, bundle_out, err = _doctor([
            "--agent-url", base, "--operator", "nvidia", "--dev-root",
            "/dev", "--db-file", db, "--alloc-spec-dir",
            os.path.join(d, "alloc"), "--samples", "1"])
        bundle_path = os.path.join(d, "bundle.json")
        with open(bundle_path, "w") as f:
            f.write(bundle_out)
        rc_v, _, err_v = _doctor(["--validate", bundle_path])
        bundle = json.loads(bundle_out) if rc == 0 else {}
        has_blocks = "goodput" in bundle and "repartition" in (
            bundle.get("agent") or {}).get("allocations", {})
        print(f"repartition doctor: node-doctor (live) exit {rc}, "
              f"--validate exit {rc_v}, goodput and repartition blocks "
              f"{has_blocks}")
        if rc or rc_v or not has_blocks:
            fail(f"repartition node-doctor: {err[-500:]} {err_v[-500:]}")

        # D and B stop; then the agent; then the dead agent's db
        open(os.path.join(hold, "stop"), "w").close()
        drep = tenants["pod-d"].result(time.perf_counter() + 60)
        brep = tenants["pod-b"].result(time.perf_counter() + 60)
        win = poller.window(t_go, t_unwound)
        poller.close()
        agent.proc.send_signal(signal.SIGTERM)
        arep = agent.result(time.perf_counter() + 60)
        if arep.get("rc") != 0 or arep.get("torch_imported") is not False:
            fail(f"repartition agent: {arep}")
        rc_g, g_out, g_err = _doctor(["goodput", "--db-file", db, "--pod",
                                      keys["pod-o"]])
        dead = (json.loads(g_out)["goodput"]["pods"].get(keys["pod-o"], {})
                if rc_g == 0 else {})
        same = bool(dead) and dead.get("intervals") == o_entry.get(
            "intervals")
        print(f"repartition dead db: node-doctor goodput exit {rc_g}, O's "
              f"intervals equal the last live read {same}")
        if rc_g or not same:
            fail(f"repartition node-doctor goodput: {g_err[-500:]}")
        if drep:
            if drep["streams"] != streams:
                fail("repartition: D's streams differ from phase 4's")
            if drep["launches"]["paged_decode"] != srv["paged_launches"]:
                fail(f"repartition: D's launches {drep['launches']}")
        for rep in (drep, brep, orep):
            for k in KERNEL_NAMES:
                out["launches"][k] += (rep or {}).get("launches", {}).get(
                    k, 0)

        def p50(rep):
            """The tenant's reports over its work, p50 and range."""
            rep = rep or {}
            vals = [v for t, v in rep.get("usage_reports", [])
                    if rep.get("work_start", 0) < t <= rep.get(
                        "work_end", float("inf")) + REP_REPORT_S]
            return ((float(np.median(vals)), min(vals), max(vals))
                    if vals else None)

        shares = {p: p50(r) for p, r in (("pod-d", drep), ("pod-b", brep),
                                         ("pod-o", orep))}
        print(f"repartition shares ({smi}): each tenant's measured device-"
              f"busy share over its work (its usage reports: p50, min, "
              f"max) D {shares['pod-d']}%, B {shares['pod-b']}%, O "
              f"{shares['pod-o']}%, beside the sampler's card duty p50 "
              f"{win.get('duty_p50')}% ({win.get('samples')} reads); "
              f"launches {out['launches']}")
        out.update(
            card=smi, grants=grants, sizing=size_shares,
            grown=dict(b=grown[0], d=grown[1]),
            host_ms=dict(grow=grow_ms, unwind=unwind_ms, **ms_o),
            moves=moves, b_units=b_units,
            deadline_s=REP_EVICT_AFTER_S, record=dict(
                reason=record.get("reason"), step=record.get("step")),
            goodput={p: dict(ratio=e.get("goodput_ratio"),
                             lifetime_s=e.get("lifetime_s"),
                             states=e.get("states"))
                     for p, e in gp.items()},
            downtime_by_cause=good.get("downtime_by_cause"),
            o_downtime_by_cause=o_down,
            shares=shares, sampler=win,
            reports={p: (r or {}).get("usage_reports") for p, r in (
                ("pod-d", drep), ("pod-b", brep), ("pod-o", orep))},
            b_run={f: ((brep or {}).get("report") or {}).get(f) for f in (
                "steps", "final_loss", "step_time_ms")},
            o_run={f: ((orep or {}).get("report") or {}).get(f) for f in (
                "steps", "final_loss", "step_time_ms", "preempted")},
            checks=dict(grow=gchecks, throttle=ochecks, shrink=schecks,
                        goodput=gchecks2))
    finally:
        for x in (poller, watch):
            if x is not None:
                x.close()
        for p in alive:
            p.kill()
        if api is not None:
            api.stop()
        shutil.rmtree(d, ignore_errors=True)
    return out


# Phase 31: a two-host slice over two port agents, one on the card and one
# on a stub card, re-formed when a member leaves and when one returns.
SL_HOSTS = "h1,h0"               # the slice's hosts, deliberately unsorted
SL_TYPE = "h100-sxm5-16"         # 16 cards, 8 a host: 2 hosts
SL_CORE_UNITS = 50               # each member's gpu-core request
SL_STEPS = 1500                  # the tenant's step budget (a reform ends it)
SL_RESUME_STEPS = 10             # the resumed run's steps
SL_WAIT_S = 60.0                 # each wait of the phase on an agent
SL_FLAGS = ["--reconcile-period", "0.5", "--slice-membership-ttl", "0.5",
            "--event-safety-net-factor", "1", "--drain-period", "0.5",
            "--drain-deadline", "300", "--migration-period", "0.5",
            "--goodput-period", "0.5", "--sampler-period", "1"]


def agent_slice_main(args) -> int:
    """Phase 31's agents (``--agent G``): ``_cli_agent`` on ``slice.json``'s
    flags, binding the pods of ``pods.json`` and then those of each bind
    request; ``card.json``'s ``stub`` gives the agent a port StubOperator
    of one card in place of the card, and a drain that reads its node's
    annotation every period. Prints one JSON line."""
    from elastic_tpu_agent_torch.device import StubOperator

    d = args.agent_dir
    card = _read_json(os.path.join(d, "card.json"))
    pods = {k: tuple(v) for k, v in _read_json(
        os.path.join(d, "pods.json")).items()}
    operator = setup = None
    if card.get("stub"):
        def operator(dev_root):
            return StubOperator(dev_root, num_chips=1)

        def setup(mgr):
            mgr.drain.node_poll_ttl_s = 0.5
    rc, mgr = _cli_agent(d, "slice.json", pods, follow=True,
                         operator=operator, setup=setup)
    print(json.dumps(dict(
        rc=rc, torch_imported="torch" in sys.modules,
        subsystems={k: v["state"] for k, v in
                    mgr.supervisor.status().items()} if mgr else {})))
    return 0


def run_slices(torch, D, dev) -> dict:
    """Phase 31: agent A (the card, host h0) and agent B (a stub card,
    host h1) form slice s31 from members p0 and p1; B's drain makes A
    re-form p0 at world 1; a runner tenant trains from p0's env; a
    replacement p1b on B makes A re-form p0 at world 2, which the tenant
    checkpoints and acks; a runner resumes from that checkpoint (module
    docstring)."""
    import shutil
    import signal
    import tempfile

    from elastic_tpu_agent_torch.common import (
        AnnotationAssumed, AnnotationDrain, AnnotationDraining,
        AnnotationSliceID, AnnotationSliceName, AnnotationSliceWorkerHosts,
        AnnotationSliceWorkerID, EnvSliceEpoch, ResourceGPUCore,
        ResourceGPUMemory, container_annotation)
    from elastic_tpu_agent_torch.device import NvidiaOperator
    from elastic_tpu_agent_torch.migration import read_checkpoint_ack
    from elastic_tpu_agent_torch.nri import plugin as NRI
    from elastic_tpu_agent_torch.workloads import telemetry as T

    props = torch.cuda.get_device_properties(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"launches": {k: 0 for k in KERNEL_NAMES}}
    d = tempfile.mkdtemp(prefix="cs31", dir="/tmp")
    api = None
    alive = []
    try:
        chips = [c for c in NvidiaOperator(
            "/dev", maintenance=lambda: None,
            preemption=lambda: None).devices()
            if _uuid_key(c.uuid) == _uuid_key(props.uuid)]
        if len(chips) != 1:
            fail(f"slices: no single card of uuid {props.uuid}")
            return out
        FA = _load_tests_module("fake_apiserver")

        class Api(FA.FakeAPIServer):
            """The fake apiserver, noting when each pod first carried
            the draining annotation."""

            draining_at: dict = {}

            def _notify(self, event):
                obj = event.get("object") or {}
                meta = obj.get("metadata") or {}
                if (meta.get("annotations") or {}).get(AnnotationDraining):
                    self.draining_at.setdefault(meta.get("name"), time.time())
                super()._notify(event)

        api = Api()
        url = api.start()
        agents = {"a": ("h100-a", chips[0].index, False),
                  "b": ("h100-b", 0, True)}
        dirs, bases = {}, {}
        for side, (node, index, stub) in agents.items():
            api.add_node(node)
            sd = dirs[side] = os.path.join(d, side)
            os.makedirs(os.path.join(sd, "dev"))
            _write_json(os.path.join(sd, "kubeconfig"), {
                "current-context": "c",
                "contexts": [{"name": "c", "context": {"cluster": "local",
                                                       "user": "agent"}}],
                "clusters": [{"name": "local", "cluster": {"server": url}}],
                "users": [{"name": "agent", "user": {"token": "phase-31"}}]})
            _write_json(os.path.join(sd, "card.json"), dict(
                node=node, core_units=0, mem_units=0, stub=stub,
                core_resource=ResourceGPUCore,
                mem_resource=ResourceGPUMemory))
            port = _free_port()
            bases[side] = f"http://127.0.0.1:{port}"
            _write_json(os.path.join(sd, "slice.json"), {"argv": [
                "--node-name", node, "--db-file", os.path.join(sd, "meta.db"),
                "--kubeconf", os.path.join(sd, "kubeconfig"),
                "--operator", "stub:1" if stub else "nvidia",
                "--dev-root", os.path.join(sd, "dev"),
                "--alloc-spec-dir", os.path.join(sd, "alloc"),
                "--device-plugin-dir", os.path.join(sd, "dp"),
                "--pod-resources-socket", os.path.join(sd, "pr.sock"),
                "--metrics-port", str(port), *SL_FLAGS]})

        def admit(pod, side, wid):
            node, index, _ = agents[side]
            api.upsert_pod({"metadata": {
                "namespace": "default", "name": pod, "uid": f"uid-{pod}",
                "annotations": {
                    AnnotationAssumed: "true",
                    container_annotation("main"): str(index),
                    AnnotationSliceID: "s31", AnnotationSliceName: SL_TYPE,
                    AnnotationSliceWorkerID: str(wid),
                    AnnotationSliceWorkerHosts: SL_HOSTS}},
                "spec": {"nodeName": node, "containers": [{"name": "main"}]}})

        # worker ids index SL_HOSTS: p0 is h0 (A), p1 is h1 (B)
        admit("p0", "a", 1)
        admit("p1", "b", 0)
        _write_json(os.path.join(dirs["a"], "pods.json"),
                    {"p0": [SL_CORE_UNITS, 0]})
        _write_json(os.path.join(dirs["b"], "pods.json"),
                    {"p1": [SL_CORE_UNITS, 0]})
        children = {side: _AgentChild("G", dirs[side]) for side in agents}
        alive += list(children.values())
        bound = {side: _read_json(os.path.join(dirs[side], "bound.json"),
                                  AGENT_WAIT_S) for side in agents}
        if any(not b or "error" in b for b in bound.values()):
            fail(f"slices: the agents never bound: {bound}")
            return out
        ha = bound["a"]["hashes"]["p0"][0]
        hb = bound["b"]["hashes"]["p1"][0]

        def env_of(side, h):
            return _spec(dirs[side], h).get("env", {})

        def world(env):
            return {k: env.get(k) for k in (
                "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", EnvSliceEpoch)}

        def slices_block(side):
            return (_http_json(bases[side] + "/debug/allocations").get(
                "slices") or {}).get("s31") or {}

        def rows(side, pod, kind):
            return [e for e in _http_json(
                f"{bases[side]}/debug/timeline?pod=default/{pod}&limit=1000"
            )["events"] if e["kind"] == kind]

        # 1. formation
        formed = {"a": world(env_of("a", ha)), "b": world(env_of("b", hb))}
        blocks = {s: slices_block(s) for s in agents}
        sm = {s: _samples(_http(bases[s] + "/metrics")[1]) for s in agents}
        members = {s: sm[s].get(("elastic_tpu_slice_members",
                                 (("slice", "s31"),))) for s in agents}
        packed = {s: sm[s].get(("elastic_tpu_packing_ici_span_count", ()))
                  for s in agents}
        fchecks = {
            "worlds": formed == {
                "a": {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "h0,h1",
                      EnvSliceEpoch: "0"},
                "b": {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "h0,h1",
                      EnvSliceEpoch: "0"}},
            "type": env_of("a", ha).get("TPU_ACCELERATOR_TYPE") == SL_TYPE
            and "TPU_HOST_BOUNDS" not in env_of("a", ha),
            "validation": all(b.get("validation_problems") == []
                              and b.get("world_size") == 2
                              for b in blocks.values()),
            "slice_formed rows": bool(rows("a", "p0", "slice_formed"))
            and bool(rows("b", "p1", "slice_formed")),
            "members gauge": members == {"a": 2.0, "b": 2.0},
            "packing histogram": packed == {"a": 1.0, "b": 1.0},
        }
        print(f"slices formation ({smi}): p0 on A {formed['a']}, p1 on B "
              f"{formed['b']}; members gauge {members}, packing spans "
              f"counted {packed}; checks {fchecks}")
        for k, ok in fchecks.items():
            if not ok:
                fail(f"slices formation check {k!r} failed")

        # 2. proactive loss: B's drain marks p1 draining, A re-forms p0
        t_drain = time.time()
        api.annotate_node("h100-b", AnnotationDrain, "true")
        lost = _wait("A's re-form to world 1", lambda: (
            lambda e: e if e.get(EnvSliceEpoch) == "1" else None)(
                env_of("a", ha)), timeout_s=SL_WAIT_S, period_s=0.005,
            phase="slices") or {}
        t_lost = time.time()
        reformed1 = rows("a", "p0", "slice_reformed")
        events = {(e["involvedObject"].get("name"), e["reason"])
                  for e in api.core_events}
        t_patch = api.draining_at.get("p1")
        lchecks = {
            "world 1": world(lost) == {"TPU_WORKER_ID": "0",
                                       "TPU_WORKER_HOSTNAMES": "h0",
                                       EnvSliceEpoch: "1"},
            "draining patch": t_patch is not None,
            "row": bool(reformed1)
            and reformed1[-1]["attrs"].get("lost") == ["h1"],
            "event": ("p0", "TPUSliceReformed") in events,
        }
        loss_ms = dict(
            annotation_to_draining_patch=((t_patch - t_drain) * 1e3
                                          if t_patch else None),
            draining_patch_to_restamp=((t_lost - t_patch) * 1e3
                                       if t_patch else None),
            draining_patch_to_reform_row=(
                (reformed1[-1]["ts"] - t_patch) * 1e3
                if t_patch and reformed1 else None))
        print(f"slices loss ({smi}): node annotation -> B's draining patch "
              f"{loss_ms['annotation_to_draining_patch']} ms, draining "
              f"patch -> A's restamp seen "
              f"{loss_ms['draining_patch_to_restamp']} ms (-> A's "
              f"slice_reformed row "
              f"{loss_ms['draining_patch_to_reform_row']} ms) at reconcile "
              f"0.5 s and membership TTL 0.5 s; p0 now {world(lost)}; checks "
              f"{lchecks}")
        for k, ok in lchecks.items():
            if not ok:
                fail(f"slices loss check {k!r} failed")

        # 3. the tenant: the runner from p0's env, world 1 on the card
        def pod_env(h, **over):
            spec_path = os.path.join(dirs["a"], "alloc", f"{h}.json")
            adj = NRI.plain_adjustment(_spec(dirs["a"], h), os.stat, "/dev",
                                       spec_path)
            return dict(adj["env"], TPU=h,
                        ELASTIC_TPU_ALLOC_DIR=os.path.join(dirs["a"], "alloc"),
                        ELASTIC_TPU_RESTORE_WAIT_S="0", **over)

        data = _runtime_data(D, os.path.join(d, "tokens.bin"))
        sched = f"--warmup-steps 5 --total-steps {SL_STEPS}"
        ck = os.path.join(d, "ckpt")
        fr = os.path.join(d, "fr.jsonl")
        t_ten = _Tenant("sl_t", "train", d, env=pod_env(ha),
                        strip=PLUGIN_ENV_STRIP, runner_args=(
                            f"{data} --steps {SL_STEPS} {sched} "
                            f"--checkpoint-every 0 --checkpoint-dir {ck} "
                            f"--flight-recorder {fr}"))
        alive.append(t_ten)
        # three step records: the watcher has read epoch 1 as its baseline
        _wait("the tenant's steps", lambda: os.path.exists(fr) and sum(
            r["kind"] == "step" for r in T.load_jsonl(fr)) >= 3,
            timeout_s=TENANT_TIMEOUT_S, phase="slices")

        # 4. the return: p1 goes, B's drain is cancelled, p1b binds on B
        api.delete_pod("default", "p1")
        assigned = _read_json(os.path.join(dirs["b"], "assign.json")) or {}
        assigned.pop("default/p1", None)
        _write_json(os.path.join(dirs["b"], "assign.json"), assigned)
        api.annotate_node("h100-b", AnnotationDrain, None)
        _wait("B's drain cancelled", lambda: (_http_json(
            bases["b"] + "/debug/allocations").get("drain") or {}).get(
            "state") == "active", timeout_s=SL_WAIT_S, phase="slices")
        admit("p1b", "b", 0)
        _write_json(os.path.join(dirs["b"], "bind-1.json"),
                    {"pods": {"p1b": [SL_CORE_UNITS, 0]}})
        bound2 = _read_json(os.path.join(dirs["b"], "bound-1.json"),
                            SL_WAIT_S) or {}
        back = _wait("A's re-form to world 2", lambda: (
            lambda e: e if e.get(EnvSliceEpoch) == "2" else None)(
                env_of("a", ha)), timeout_s=SL_WAIT_S, period_s=0.005,
            phase="slices") or {}
        t_back = time.time()
        trep = t_ten.result(time.perf_counter() + TENANT_TIMEOUT_S)
        ack = read_checkpoint_ack(os.path.join(dirs["a"], "alloc"), ha) or {}
        report = (trep or {}).get("report", {})
        hb2 = ((bound2.get("hashes") or {}).get("p1b") or [""])[0]
        steps_done = report.get("start_step", 0) + report.get("steps", 0)

        def ledger():
            entry = (_http_json(bases["a"] + "/debug/goodput").get("pods")
                     or {}).get("default/p0") or {}
            closed = [i for i in entry.get("intervals", [])
                      if i["state"] == "checkpointing"
                      and (i.get("cause") or {}).get("category")
                      == "slice_reform" and ack.get("ts") is not None
                      and abs(i["end"] - ack["ts"]) < 1e-3]
            return (entry, closed) if closed else None

        entry, closed = _wait("p0's checkpointing closed by the ack",
                              ledger, timeout_s=SL_WAIT_S, period_s=0.1,
                              phase="slices") or ({}, [])
        reformed2 = rows("a", "p0", "slice_reformed")
        rchecks = {
            "world 2": world(back) == {"TPU_WORKER_ID": "0",
                                       "TPU_WORKER_HOSTNAMES": "h0,h1",
                                       EnvSliceEpoch: "2"},
            "p1b bound": bool(hb2) and world(env_of("b", hb2)) == {
                "TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "h0,h1",
                EnvSliceEpoch: "0"},
            "row": len(reformed2) >= 2
            and reformed2[-1]["attrs"].get("joined") == ["h1"],
            "reform signal": report.get("lifecycle_signal") == "reform"
            and report.get("platform") == "gpu",
            "ack": ack.get("epoch") == 2 and ack.get("step") is not None
            and ack.get("step") == steps_done - 1
            and ack.get("checkpoint_dir") == ck,
            "flash launches": all((trep or {}).get("launches", {}).get(k, 0)
                                  > 0 for k in KERNEL_NAMES[:3]),
            "goodput": bool(closed),
        }
        back_ms = dict(
            restamp_to_ack=((ack["ts"] - t_back) * 1e3
                            if ack.get("ts") else None),
            bind_to_restamp=((t_back - bound2["at"]) * 1e3
                             if bound2.get("at") else None))
        print(f"slices return ({smi}): p1b bound on B -> A's restamp seen "
              f"{back_ms['bind_to_restamp']} ms, restamp -> the tenant's "
              f"ack {back_ms['restamp_to_ack']} ms (the runner's watcher "
              f"polls every 1 s, then saves); the tenant stopped on "
              f"{report.get('lifecycle_signal')!r} after {steps_done} steps "
              f"at {report.get('step_time_ms')} ms a step, acked step "
              f"{ack.get('step')} at epoch {ack.get('epoch')}; p0's "
              f"checkpointing interval {closed[-1] if closed else None}; "
              f"checks {rchecks}")
        for k, ok in rchecks.items():
            if not ok:
                fail(f"slices return check {k!r} failed")

        # 5. the resume, at world 1: NCCL refuses two ranks on one card
        print("slices resume: the restore runs at world 1 "
              "(TPU_WORKER_HOSTNAMES=h0): the one card cannot host the "
              "world of 2 the slice now has, since NCCL refuses two ranks "
              "on one device")
        step = ack.get("step")
        resumed = ref = {}
        if step is not None:
            r_ten = _Tenant(
                "sl_r", "train2", d, strip=PLUGIN_ENV_STRIP,
                env=pod_env(ha, TPU_WORKER_HOSTNAMES="h0", TPU_WORKER_ID="0"),
                runner_args=(f"{data} --steps {SL_RESUME_STEPS} {sched} "
                             f"--checkpoint-every 0 --checkpoint-dir {ck}"),
                runner_args2=(f"{data} --steps "
                              f"{step + 1 + SL_RESUME_STEPS} {sched}"))
            alive.append(r_ten)
            rrep = r_ten.result(time.perf_counter() + TENANT_TIMEOUT_S)
            runs = (rrep or {}).get("runs") or [{}, {}]
            resumed = runs[0].get("report", {})
            ref = runs[1].get("report", {})
            for run in (trep or {}, rrep or {}):
                for k in KERNEL_NAMES[:3]:
                    out["launches"][k] += (run.get("launches") or {}).get(k, 0)
        gap = (abs(resumed.get("final_loss", float("nan"))
                   - ref.get("final_loss", float("nan")))
               if resumed and ref else float("nan"))
        uchecks = {
            "start step": step is not None
            and resumed.get("start_step") == step + 1
            and resumed.get("steps") == SL_RESUME_STEPS
            and resumed.get("devices") == 1,
            "parameters": gap <= RESUME_TOL,
        }
        print(f"slices resume ({smi}): restored at step "
              f"{resumed.get('start_step')} (acked {step}), "
              f"{resumed.get('steps')} "
              f"steps to final loss {resumed.get('final_loss')} vs the "
              f"uninterrupted run's {ref.get('final_loss')}: gap {gap:.3g} "
              f"(limit {RESUME_TOL}); phase launches {out['launches']}; "
              f"checks {uchecks}")
        for k, ok in uchecks.items():
            if not ok:
                fail(f"slices resume check {k!r} failed")
        arep = {}
        for side, child in children.items():
            child.proc.send_signal(signal.SIGTERM)
            arep[side] = child.result(time.perf_counter() + 60)
        print(f"slices agents: {arep}")
        if any(r.get("rc") != 0 or r.get("torch_imported") is not False
               for r in arep.values()):
            fail(f"slices agents: {arep}")
        out.update(
            card=smi, formation=dict(worlds=formed, members=members,
                                     packing_counted=packed, checks=fchecks),
            loss=dict(world=world(lost), host_ms=loss_ms, checks=lchecks),
            back=dict(world=world(back), host_ms=back_ms, ack=ack,
                      steps=steps_done, step_time_ms=report.get(
                          "step_time_ms"), checks=rchecks),
            resume=dict(start_step=resumed.get("start_step"),
                        final_loss=resumed.get("final_loss"),
                        reference_loss=ref.get("final_loss"), gap=gap,
                        checks=uchecks))
    finally:
        for p in alive:
            p.kill()
        if api is not None:
            api.stop()
        shutil.rmtree(d, ignore_errors=True)
    return out


# -- phase 32: the port's fleet simulator, node 0 on the card ----------------

# 32a at bench.py's fleet leg size (bench.py:543-546)
FL_NODES = 8
FL_PODS = 125                    # pods a stub node
FL_RECONCILE_S = 2.0
FL_WORKERS = 2                   # concurrent binders a node
FL_TRACES = 25                   # admissions followed to their node
FL_STUB_KIND = "stub:8"
# the structural checker's amplification bounds (sim/scale.py
# scale_problems), held for 32a's fleet leg
FL_AMP_BOUNDS = {"kubelet_lists_per_bind": 2.0,
                 "apiserver_requests_per_bind": 6.0,
                 "sink_writes_per_bind": 4.0}
# 32c: the chaos tests' fleet settings (tests/test_chaos.py _chaos_fleet)
# and their compound program: node 1's drain (the slice's reform on node
# 0) over node 0's throttle, under a brownout, a flaky group commit and a
# kubelet flap
FL_CHAOS_FLEET = dict(
    reconcile_period_s=0.5, slice_membership_ttl_s=0.25,
    drain_deadline_s=30.0, drain_period_s=0.25, migration_period_s=0.1,
    goodput_period_s=3600.0, enable_sampler=True, sampler_period_s=3600.0,
    repartition_period_s=3600.0, storage_batch_window_s=0.004,
    sink_flush_window_s=0.02)
FL_CHAOS_ACTIONS = [
    {"kind": "failpoint", "t": 0.2, "duration_s": 1.5,
     "point": "storage.batch_flush", "spec": "prob:0.1:11"},
    {"kind": "apiserver_brownout", "t": 0.3, "duration_s": 1.2,
     "error_rate": 0.2, "latency_s": 0.001, "seed": 7},
    {"kind": "throttle", "t": 0.4, "duration_s": 2.2, "node": 0},
    {"kind": "maintenance_drain", "t": 0.5, "duration_s": 2.5, "node": 1},
    {"kind": "kubelet_flap", "t": 1.0, "node": 0},
]
FL_CHAOS_FLOORS = {"min_goodput_percent": 10.0, "min_slo_attainment": 0.5}
# 32d: 2 nodes, batched; 32 pods a node and the harness's own storm of
# 10,500 series (at the agent's tests' 16 pods both packages read 5.9-6.4
# apiserver requests a bind against the checker's bound of 6.0, and at
# their storm of 1,200 series the agents' start-up memory read 69 KB a
# series on the card against its ceiling of 64 KiB: fixed costs over a
# small count)
FL_SCALE = dict(nodes=2, pods_per_node=32, admission_waves=2,
                drain_nodes=1, slice_world=2,
                storage_batch_window_s=0.005, sink_flush_window_s=0.02,
                reconcile_period_s=1.0, convergence_timeout_s=60.0,
                phase_timeout_s=60.0)


def _card_fleet(uuid):
    """A FleetSim class whose ``nvidia`` nodes hold the host's cards: an
    NvidiaOperator over the host's /dev, links under the node's dev root,
    its nvidia-smi calls counted (``smi_calls``), and maintenance and
    preemption answered from its own settable state (the sim's
    ``trigger_maintenance``/``trigger_preemption`` set them; the metadata
    server is never asked)."""
    from elastic_tpu_agent_torch.device import NvidiaOperator
    from elastic_tpu_agent_torch.device.nvidia import run_nvidia_smi
    from elastic_tpu_agent_torch.sim import FleetSim

    class Card(NvidiaOperator):
        def __init__(self, dev_root):
            self.smi_calls = 0
            self.state = {"maintenance": "NONE", "preempted": "FALSE"}

            def smi():
                self.smi_calls += 1
                return run_nvidia_smi()

            super().__init__(dev_root, host_dev_scan_root="/dev", smi=smi,
                             maintenance=lambda: self.state["maintenance"],
                             preemption=lambda: self.state["preempted"],
                             maintenance_poll_ttl_s=0.0)

        def set_maintenance_event(self, event):
            self.state["maintenance"] = event

        def set_preempted(self, flag):
            self.state["preempted"] = "TRUE" if flag else "FALSE"

    class CardFleet(FleetSim):
        def _operator_for(self, node):
            if node.operator_kind != "nvidia":
                return None
            return Card(os.path.join(node.root, "dev"))

        def card(self, idx=0):
            """The card node's one card, None unless its listing is
            exactly torch's device."""
            chips = self.nodes[idx].manager.operator.devices()
            if len(chips) != 1 or _uuid_key(chips[0].uuid) != _uuid_key(uuid):
                return None
            return chips[0]

    return CardFleet


def run_fleet(torch, srv, streams, dev) -> dict:
    """Phase 32: the port's fleet simulator (module docstring)."""
    import shutil
    import tempfile

    from elastic_tpu_agent_torch import faults
    from elastic_tpu_agent_torch.common import EnvSliceEpoch, ResourceGPUCore
    from elastic_tpu_agent_torch.nri import plugin as NRI
    from elastic_tpu_agent_torch.sim import (
        ChaosMatrix, ChaosProgram, FleetAggregator, ScaleHarness,
        ScenarioRunner, TraceGenerator, repro_line, scale_problems)
    from elastic_tpu_agent_torch.sim.fleet import CONTAINER

    props = torch.cuda.get_device_properties(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    CardFleet = _card_fleet(props.uuid)
    out = {"card": smi, "launches": {k: 0 for k in KERNEL_NAMES}}
    d = tempfile.mkdtemp(prefix="cs32", dir="/tmp")
    tenant = None
    try:
        # 32a: 8 nodes, node 0 the card; bench.py's fleet leg
        t0 = time.perf_counter()
        sim = CardFleet(os.path.join(d, "a"), nodes=FL_NODES,
                        reconcile_period_s=FL_RECONCILE_S,
                        operator_kinds=["nvidia"] + [FL_STUB_KIND] * (
                            FL_NODES - 1))
        os.makedirs(sim.base_dir)
        sim.start()
        try:
            startup_s = time.perf_counter() - t0
            card = sim.card(0)
            if card is None:
                fail(f"fleet: node 0 lists "
                     f"{[c.uuid for c in sim.nodes[0].manager.operator.devices()]}"
                     f", not the one card {props.uuid}")
                return out
            op0 = sim.nodes[0].manager.operator
            # node 0 admits what its one card's gpu-core units hold
            units = len(sim.nodes[0].manager.plugin.core.device_list())
            card_pods = units // sim.core_units_per_pod
            agg = FleetAggregator(sim.targets())
            refs = (sim.admit_pods(card_pods, node_idxs=[0])
                    + sim.admit_pods(FL_PODS, node_idxs=list(
                        range(1, FL_NODES))))
            sim.wait_synced(refs)
            driver = sim.churn(refs, workers_per_node=FL_WORKERS)
            t_churned = time.perf_counter()
            convergence = agg.convergence_summary(agg.wait_converged(
                driver["churn_end_ts"], timeout_s=60.0))
            rollup = agg.rollup()
            fleet = rollup["fleet"]
            binds = fleet["binds_total"] or 0
            api_total = sim.apiserver.requests_total()
            amp = dict(
                kubelet_lists_per_bind=fleet["request_amplification"][
                    "kubelet_lists_per_bind"],
                apiserver_requests_per_bind=(
                    round(api_total / binds, 4) if binds else None),
                sink_writes_per_bind=fleet["request_amplification"][
                    "sink_writes_per_bind"])
            stride = max(1, len(refs) // FL_TRACES)
            sample = refs[::stride][:FL_TRACES]
            continuity = agg.check_continuity([
                (sim.nodes[r.node_idx].name, r.trace_id, r.pod_key)
                for r in sample])
            stored = sim.stored_binds()
            admitted = {}
            for r in refs:
                admitted[sim.nodes[r.node_idx].name] = admitted.get(
                    sim.nodes[r.node_idx].name, 0) + 1
            placed = {}
            for r in refs[:card_pods]:
                info = sim.nodes[0].storage.load(r.namespace, r.name)
                rec = info and info.allocations[CONTAINER][ResourceGPUCore]
                placed[r.pod_key] = rec and (list(rec.chip_indexes),
                                             len(rec.device.ids))
            leg_s = time.perf_counter() - t0
            smi_calls = op0.smi_calls
            print(f"fleet 32a ({smi}): {FL_NODES} nodes (node 0 the card "
                  f"{card.uuid}, index {card.index}, {units} gpu-core units: "
                  f"{card_pods} pods; nodes 1-{FL_NODES - 1} {FL_STUB_KIND}, "
                  f"{FL_PODS} pods each), {len(refs)} pods admitted, started "
                  f"in {startup_s:.2f} s; churn {driver['bound']}/"
                  f"{driver['pods']} bound by {driver['workers']} workers in "
                  f"{driver['wall_s']:.2f} s ({driver['binds_per_s']:.1f} "
                  f"binds/s), {driver['error_count']} errors; bind p50/p99 "
                  f"scraped {fleet['fleet_bind_p50_ms']}/"
                  f"{fleet['fleet_bind_p99_ms']} ms, stopwatch "
                  f"{driver['bind_p50_ms']:.3f}/{driver['bind_p99_ms']:.3f} "
                  f"ms")
            print(f"fleet 32a convergence after the churn (s): "
                  f"{convergence['per_node']} (median "
                  f"{convergence['median_s']}, max {convergence['max_s']}, "
                  f"unconverged {convergence['unconverged_nodes']}); per "
                  f"bind: kubelet Lists {amp['kubelet_lists_per_bind']}, "
                  f"apiserver requests {amp['apiserver_requests_per_bind']} "
                  f"({api_total} of "
                  f"{dict(sorted(sim.apiserver.request_counts.items()))}), "
                  f"sink writes {amp['sink_writes_per_bind']}; trace "
                  f"continuity {continuity['continuous']}/"
                  f"{continuity['sampled']} (broken {continuity['broken']});"
                  f" stored binds {stored} beside admitted {admitted}; node "
                  f"0's records {sorted(set(map(str, placed.values())))}; "
                  f"node 0's nvidia-smi calls {smi_calls} in {leg_s:.1f} s")
            checks = {
                "every bind": driver["bound"] == driver["pods"] == len(refs)
                and driver["error_count"] == 0
                and driver["timed_out_workers"] == 0,
                "stored binds": stored == admitted,
                "on the card": all(v == ([card.index],
                                         sim.core_units_per_pod)
                                   for v in placed.values())
                and len(placed) == card_pods > 0,
                "scraped quantiles": binds == len(refs)
                and fleet["fleet_bind_p50_ms"] is not None
                and fleet["fleet_bind_p99_ms"]
                >= fleet["fleet_bind_p50_ms"],
                "convergence": not convergence["unconverged_nodes"]
                and convergence["converged_nodes"] == FL_NODES,
                "amplification": all(
                    v is not None and v <= FL_AMP_BOUNDS[k]
                    for k, v in (
                        ("kubelet_lists_per_bind",
                         amp["kubelet_lists_per_bind"]),
                        ("apiserver_requests_per_bind",
                         amp["apiserver_requests_per_bind"]))
                ) and all(v is not None
                          and v <= FL_AMP_BOUNDS["sink_writes_per_bind"]
                          for v in amp["sink_writes_per_bind"].values()),
                "continuity": continuity["fraction"] == 1.0
                and continuity["sampled"] == FL_TRACES
                and any(r.node_idx == 0 for r in sample),
                # one nvidia-smi -q -x serves every read of its 2 s TTL
                "nvidia-smi calls": 1 <= smi_calls
                <= math.ceil(leg_s / 2.0) + 2,
            }
            for k, ok in checks.items():
                if not ok:
                    fail(f"fleet 32a check {k!r} failed")
            PHASE_SECONDS["fleet_32a"] = round(leg_s, 2)
            out["a"] = dict(
                startup_s=startup_s, pods=len(refs), card_pods=card_pods,
                driver={k: driver[k] for k in (
                    "pods", "bound", "error_count", "workers",
                    "bind_p50_ms", "bind_p99_ms", "binds_per_s", "wall_s")},
                scraped_p50_ms=fleet["fleet_bind_p50_ms"],
                scraped_p99_ms=fleet["fleet_bind_p99_ms"],
                convergence=convergence, amplification=amp,
                apiserver_requests=api_total, continuity=continuity,
                stored=stored, smi_calls=smi_calls, seconds=leg_s,
                checks=checks)

            # 32b: a serving tenant from the env and spec node 0 stamped
            # for its first pod
            t1 = time.perf_counter()
            ref = refs[0]
            h = sim.alloc_hash_of(ref)
            alloc = sim.nodes[0].opts.alloc_spec_dir
            spec = sim.nodes[0].manager.plugin.core.read_alloc_spec(h)
            adj = NRI.plain_adjustment(spec, os.stat, "/dev",
                                       os.path.join(alloc, f"{h}.json"))
            env = dict(adj["env"], TPU=h, ELASTIC_TPU_ALLOC_DIR=alloc)
            tenant = _Tenant("fl_serve", "serve", d, env=env,
                             strip=PLUGIN_ENV_STRIP)
            rep = tenant.result(time.perf_counter() + TENANT_TIMEOUT_S)
        finally:
            if tenant is not None:
                tenant.kill()
            sim.stop()
        b_s = time.perf_counter() - t1
        PHASE_SECONDS["fleet_32b"] = round(b_s, 2)
        if rep:
            q = rep["quota"]
            bchecks = {
                "one card": rep["device_count"] == 1
                and rep["device_uuid"] == _uuid_key(props.uuid)
                and _uuid_key(q["visible"]) == _uuid_key(props.uuid),
                "streams": rep["streams"] == streams,
                "launches": rep["launches"]["paged_decode"]
                == srv["paged_launches"]
                == SMALL["n_layers"] * rep["decode_steps"],
                "grant": q["core_units"] == sim.core_units_per_pod,
            }
            print(f"fleet 32b ({smi}): a tenant from {ref.pod_key}'s spec on "
                  f"node 0 (hash {h}): sees {rep['device_count']} card "
                  f"{rep['device_uuid']}, streams equal phase 4's: "
                  f"{bchecks['streams']}, launches {rep['launches']}, quota "
                  f"{q}, {rep['tokens_per_s']:.1f} tokens/s (phase 4 "
                  f"{srv['tokens_per_s']:.1f}), {rep['seconds']:.1f} s; "
                  f"checks {bchecks}")
            for k, ok in bchecks.items():
                if not ok:
                    fail(f"fleet 32b check {k!r} failed")
            for k in KERNEL_NAMES:
                out["launches"][k] += rep["launches"].get(k, 0)
            out["b"] = dict(hash=h, launches=rep["launches"],
                            tokens_per_s=rep["tokens_per_s"], quota=q,
                            seconds=b_s, checks=bchecks)

        # 32c: the compound scenario on a 2-node fleet, node 0 the card
        t2 = time.perf_counter()
        sim = CardFleet(os.path.join(d, "c"), nodes=2,
                        operator_kinds=["nvidia", "stub:4"],
                        **FL_CHAOS_FLEET)
        os.makedirs(sim.base_dir)
        sim.start()
        try:
            if sim.card(0) is None:
                fail("fleet 32c: node 0 does not list the one card")
                return out
            slice_refs = sim.admit_slice("cx", [0, 1])
            sim.wait_synced(slice_refs)
            for r in slice_refs:
                sim.bind_pod(r)
            trace = TraceGenerator(seed=1001, duration_s=2.0, base_rps=10.0,
                                   train_pods=1).generate()
            program = ChaosProgram(2001, [dict(a) for a in FL_CHAOS_ACTIONS],
                                   {"chaos_seed": 2001, "duration_s": 3.0,
                                    "nodes": 2})
            report = ScenarioRunner(sim, trace, program,
                                    name="drain-reform-throttle").run()
            problems = scale_problems(report, FL_CHAOS_FLOORS)
            epoch = -1
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                epoch = int(sim.slice_env_of(slice_refs[0]).get(
                    EnvSliceEpoch, -1))
                if epoch >= 1:
                    break
                time.sleep(0.1)
            c_smi = sim.nodes[0].manager.operator.smi_calls
        finally:
            faults.get_registry().disarm()
            sim.stop()
        comp = report["compound"]
        with tempfile.TemporaryDirectory(prefix="st", dir=d) as st:
            matrix = ChaosMatrix(trace_seed=1, chaos_seed=1)
            matrix.scenarios = [{
                "name": "self-test", "index": 0,
                "trace": {"duration_s": 1.0, "base_rps": 10.0,
                          "flash_crowds": 0, "train_pods": 0},
                "program": {"duration_s": 1.0, "include_drain": False}}]
            verdict = matrix.self_test(st)
        c_s = time.perf_counter() - t2
        cchecks = {
            "scale_problems": problems == [],
            "streams": comp["streams"]["admitted"] > 0
            and comp["streams"]["client_visible_drops"] == 0,
            "throttled on the card": comp["throttled"].get("node-0") is True,
            "reformed": epoch >= 1,
            "repro": report["repro"] == repro_line(
                1001, 2001, "drain-reform-throttle"),
            "sabotage trips": verdict["tripped"]
            and any("drops" in p for p in verdict["problems"])
            and verdict["repro"] == repro_line(1, 1, "self-test"),
        }
        print(f"fleet 32c ({smi}): drain on node 1 during the slice's reform "
              f"during a throttle on the card node, {report['wall_s']} s: "
              f"problems {problems}; streams {comp['streams']}, handoffs "
              f"{comp['handoffs']}, tokens {comp['tokens']}, binds "
              f"{comp['binds']}, open intents {comp['open_intents']}, "
              f"throttled {comp['throttled']}; goodput "
              f"{report['goodput']['goodput_percent']}% (downtime by cause "
              f"{report['goodput']['downtime_by_cause']}); SLO attainment "
              f"{ {k: v.get('attainment') for k, v in report['slo'].items()} };"
              f" the survivor's epoch {epoch}; node 0's nvidia-smi calls "
              f"{c_smi}; sabotage: tripped {verdict['tripped']}, "
              f"{verdict['problems']}, repro {verdict['repro']!r}; checks "
              f"{cchecks}")
        for k, ok in cchecks.items():
            if not ok:
                fail(f"fleet 32c check {k!r} failed")
        PHASE_SECONDS["fleet_32c"] = round(c_s, 2)
        out["c"] = dict(problems=problems, compound=comp,
                        goodput=report["goodput"], slo=report["slo"],
                        epoch=epoch, smi_calls=c_smi, sabotage=verdict,
                        seconds=c_s, checks=cchecks)

        # 32d: ScaleHarness, stub nodes, batched
        t3 = time.perf_counter()
        harness = ScaleHarness(os.path.join(d, "d"), **FL_SCALE)
        os.makedirs(os.path.join(d, "d"))
        srep = harness.run()
        sproblems = scale_problems(srep)
        d_s = time.perf_counter() - t3
        print(f"fleet 32d: ScaleHarness {FL_SCALE['nodes']} x "
              f"{FL_SCALE['pods_per_node']} batched: problems {sproblems}; "
              f"pods {srep['pods']}, stored {srep['stored_binds']}, bind "
              f"p50/p99 {srep['fleet_bind_p50_ms']}/"
              f"{srep['fleet_bind_p99_ms']} ms, amplification "
              f"{ {k: v for k, v in srep['amplification'].items() if k.endswith('per_bind')} },"
              f" convergence {srep['reconcile_convergence_s']['max_s']} s, "
              f"slice reform {srep['phases']['slice_reform']}, memory "
              f"{srep['memory']['rss_delta_per_series_bytes']} B/series, "
              f"{d_s:.1f} s")
        if sproblems or srep["pods"] != srep["stored_binds"]:
            fail(f"fleet 32d: {sproblems}")
        PHASE_SECONDS["fleet_32d"] = round(d_s, 2)
        out["d"] = dict(problems=sproblems, pods=srep["pods"],
                        stored=srep["stored_binds"],
                        p50_ms=srep["fleet_bind_p50_ms"],
                        p99_ms=srep["fleet_bind_p99_ms"],
                        amplification=srep["amplification"],
                        seconds=d_s)
    finally:
        if tenant is not None:
            tenant.kill()
        shutil.rmtree(d, ignore_errors=True)
    return out


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0)


def _profiled(torch, fn, reps):
    """torch.profiler over ``reps`` calls of fn (after one warm call):
    (the profile, device-busy share of the host wall time, wall us, device
    busy us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(_device_us(e) for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU)
    return prof, busy_us / wall_us, wall_us, busy_us


def profile_paths(torch, W, cfg, params, dev, out_dir, train_step):
    """torch.profiler over one forward, over 20 steady decode steps (8
    live greedy rows at ~128 positions) and over 3 train steps
    (``train_step`` runs one): device-busy share of the host wall time
    and the top device ops; tables and traces go to ``out_dir`` unless it
    is None."""
    from torch.autograd import DeviceType

    rng = np.random.default_rng(SEED + 5)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 256)),
                          device=dev)
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), device=dev)
    for _ in range(8):
        eng.admit(rng.integers(0, cfg.vocab, size=128).tolist())
    for _ in range(3):
        eng.step()
    out = {}
    for name, fn, reps in (
        ("forward", lambda: W.forward(params, tokens, cfg, device=dev), 3),
        ("decode_step", eng.step, 20),
        ("train_step", train_step, 3),
    ):
        prof, _, wall_us, busy_us = _profiled(torch, fn, reps)
        avg = prof.key_averages()
        kernels_ = [e for e in avg if e.device_type != DeviceType.CPU]
        top = sorted(kernels_, key=_device_us, reverse=True)[:8]
        out[name] = dict(
            wall_ms_per_call=wall_us / reps / 1e3,
            device_busy_share=busy_us / wall_us,
            device_ms_per_call=busy_us / reps / 1e3,
            top_device_ops=[
                (e.key[:60], _device_us(e) / reps / 1e3, e.count // reps)
                for e in top
            ],
        )
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
                f.write(avg.table(sort_by=(
                    "self_device_time_total"
                    if hasattr(avg[0], "self_device_time_total")
                    else "self_cuda_time_total"), row_limit=40))
            prof.export_chrome_trace(
                os.path.join(out_dir, f"{name}_trace.json"))
    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler pass over forward and decode")
    ap.add_argument("--out", default=None,
                    help="directory for the full report and profiler files")
    ap.add_argument("--tenant", choices=("discover", "probe", "train",
                                         "train2", "serve", "serve_obs"),
                    help="run as one of phases 24-30's child processes")
    ap.add_argument("--runner-args", default="",
                    help="a train tenant's runner flags")
    ap.add_argument("--runner-args2", default="",
                    help="a train2 tenant's second runner flags")
    ap.add_argument("--barrier", default="",
                    help="a tenant's start barrier directory")
    ap.add_argument("--barrier2", default="",
                    help="a train2 tenant's barrier before its second run")
    ap.add_argument("--profile-busy", action="store_true",
                    help="a tenant's work under torch.profiler")
    ap.add_argument("--usage-report", action="store_true",
                    help="a tenant writes its measured device-busy share "
                         "as usage reports (phase 30)")
    ap.add_argument("--hold", default="",
                    help="a tenant stays up after its work until "
                         "HOLD/stop exists (phase 30)")
    ap.add_argument("--agent", choices=("A", "B", "C", "D", "E", "F", "G"),
                    help="run as one of phase 26's agent processes (A, B), "
                         "phase 27's (C), 28's (D), 29's (E), 30's (F) or "
                         "31's (G)")
    ap.add_argument("--agent-dir", default="",
                    help="phase 26's to 31's agent directory (db, dev root, "
                         "alloc dir)")
    args = ap.parse_args()
    if args.tenant:
        return tenant_main(args)
    if args.agent == "C":
        return agent_obs_main(args)
    if args.agent == "D":
        return agent_act_main(args)
    if args.agent == "E":
        return agent_mig_main(args)
    if args.agent == "F":
        return agent_rep_main(args)
    if args.agent == "G":
        return agent_slice_main(args)
    if args.agent:
        return agent_main(args)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from elastic_tpu_agent_torch import kernels
    from elastic_tpu_agent_torch import workloads as W
    from elastic_tpu_agent_torch.workloads import attention as A
    from elastic_tpu_agent_torch.workloads import export as E
    from elastic_tpu_agent_torch.workloads import lifecycle as L
    from elastic_tpu_agent_torch.workloads import lora as LR
    from elastic_tpu_agent_torch.workloads import moe as M
    from elastic_tpu_agent_torch.workloads import paged_attention as PA
    from elastic_tpu_agent_torch.workloads import parallel as P
    from elastic_tpu_agent_torch.workloads import quantize as Q
    from elastic_tpu_agent_torch.workloads import request_obs as RO
    from elastic_tpu_agent_torch.workloads import ring_attention as RA
    from elastic_tpu_agent_torch.workloads import runner as R
    from elastic_tpu_agent_torch.workloads import streaming as S
    from elastic_tpu_agent_torch.workloads import telemetry as T
    from elastic_tpu_agent_torch.workloads import transformer as TR
    from elastic_tpu_agent_torch.workloads import pipeline as PL
    from elastic_tpu_agent_torch.workloads import data as D
    from elastic_tpu_agent_torch.workloads import partitioner as PT
    from elastic_tpu_agent_torch.workloads import serving_proxy as SP
    from elastic_tpu_agent_torch.workloads import transformer_pipeline as TP
    from elastic_tpu_agent_torch.workloads import weights as WT
    import importlib     # the package's generate() shadows the module

    G = importlib.import_module("elastic_tpu_agent_torch.workloads.generate")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card {card}")

    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build_seconds {time.perf_counter() - t0:.2f}")

    flash = timed("check_flash", check_flash, torch, A, dev)
    paged = timed("check_paged", check_paged, torch, PA, dev)
    dkdv, dq, bwd_whole = timed("check_flash_bwd", check_flash_bwd, torch,
                                A, dev)

    cfg = W.ModelConfig(**SMALL, max_seq=1024, dtype=torch.bfloat16)
    tree = W.random_tree(cfg, SEED)
    params = W.params_from_jax(tree, cfg, device=dev)
    flash["launches"], fwd = timed("forward", run_forward, torch, W, A, cfg,
                                   params, dev)
    paged["launches"], srv = timed("serving", run_serving, torch, W, PA, cfg,
                                   params, tree, dev)
    srv_streams = srv.pop("streams")
    launches, train, trained = timed("train", run_train, torch, W, A, cfg,
                                     tree, dev)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_runtime_") as tmp:
        runtime = timed("runtime", run_runtime, torch, A, dev, tmp)
        drain = timed("drain", run_drain, torch, W, L, T, cfg, params, dev,
                      tmp)
        prefix = timed("prefix", run_prefix, torch, W, PA, L, RO, cfg,
                       params, tree, dev, tmp)
    int8 = timed("int8", run_int8, torch, W, PA, Q, R, cfg, tree, params,
                 dev)
    moe_cfg = dataclasses.replace(cfg, moe_experts=MOE_EXPERTS)
    moe = timed("moe", run_moe, torch, W, A, PA, M,
                W.random_tree(moe_cfg, SEED), dev)
    spec_launches, spec = timed("speculative", run_speculative, torch, W, PA,
                                cfg, params, tree, dev)
    beam = timed("beam", run_beam, torch, W, cfg, params, tree, dev)
    stream = timed("streaming", run_streaming, torch, W, S, cfg, dev)
    lora_launches, lora = timed("lora", run_lora, torch, W, A, LR, cfg,
                                params, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        export = timed("export", run_export, torch, W, E, R, cfg, trained,
                       dev, tmp)
        mesh = timed("mesh", run_mesh, torch, W, A, P, cfg, tree, trained,
                     dev, tmp)
    ring = timed("ring", run_ring, torch, A, RA, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_mesh_") as tmp:
        moe_mesh = timed("moe_mesh", run_moe_mesh, torch, W, A, M, P, TR,
                         W.random_tree(moe_cfg, SEED), moe, dev, tmp)
    pipeline = timed("pipeline", run_pipeline, torch, W, A, PL, TP, WT, cfg,
                     tree, trained, train, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_decode_") as tmp:
        decode = timed("sharded_decode", run_sharded_decode, torch, W, P, Q,
                       G, cfg, dev, tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_serving_") as tmp:
        tp_serving = timed("tp_serving", run_tp_serving, torch, W, PT, SP,
                           cfg, tree, srv, dev, tmp)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_mesh_") as tmp:
        runner_mesh = timed("runner_mesh", run_runner_mesh, torch, A, R, D,
                            runtime, dev, tmp)
    share = timed("device_share", run_device_share, torch, D, srv,
                  srv_streams, runtime, dev)
    plugin = timed("plugin_path", run_plugin_path, torch, srv, srv_streams,
                   dev)
    agent = timed("agent_restart", run_agent_restart, torch, srv,
                  srv_streams, dev)
    observability = timed("observability", run_observability, torch, srv,
                          srv_streams, dev, agent)
    activation = timed("runtime_activation", run_runtime_activation, torch,
                       srv, srv_streams, dev)
    migration = timed("migration", run_migration, torch, D, srv,
                      srv_streams, dev)
    repartition = timed("repartition", run_repartition, torch, D, srv,
                        srv_streams, dev)
    slices = timed("slices", run_slices, torch, D, dev)
    fleet = timed("fleet", run_fleet, torch, srv, srv_streams, dev)
    # each kernel's launches over the main paths it lies on, each path
    # counted from 0 just before it: forward + LoRA + the sharded step +
    # the ring + the MoE mesh step + both pipeline schedules + the
    # runner's mesh runs + the tenants of phases 24, 29, 30 and 31,
    # serving + the spec engine's fallback steps + the tenants of phases
    # 24-30 and 32, train + LoRA + the sharded step + the ring + the MoE
    # mesh step + both pipeline schedules + the runner's mesh runs + the
    # tenants
    tenants = {k: sum(x.get("launches", {}).get(k, 0)
                      for x in (share, plugin, agent, observability,
                                activation, migration, repartition, slices,
                                fleet))
               for k in KERNEL_NAMES}
    extra = (lora_launches, mesh["launches"], ring["launches"],
             moe_mesh["launches"], pipeline["launches"],
             runner_mesh["launches"])
    flash["launches"] += sum(x["flash_fwd"] for x in extra) + tenants[
        "flash_fwd"]
    paged["launches"] += spec_launches + tenants["paged_decode"]
    for rec in (dkdv, dq):
        k = rec["name"]
        rec["launches"] = launches[k] + sum(x[k] for x in extra) + tenants[k]
    for rec in (flash, dkdv, dq):   # the ring's call patterns too
        rec["ring"] = dict(launches=ring["launches"][rec["name"]],
                           max_abs_err=ring["kernel_errs"][rec["name"]])
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 ring["kernel_errs"][rec["name"]])
    kernel_recs = [flash, paged, dkdv, dq]
    for x in kernel_recs:
        print(f"{x['name']} timing: device ms {x['ms']:.4g} (host-paced "
              f"{x['unqueued_ms']:.4g}), plain {x['plain_ms']:.4g}, library "
              f"{x['library_ms']}, bound {x['bound_ms']:.3g} ({x['bound_by']})")
    print(f"flash_bwd whole bf16 backward {bwd_whole['shape']} (delta + "
          f"dK/dV + dQ): device ms {bwd_whole['ms']:.4g} (delta alone "
          f"{bwd_whole['delta_ms']:.4g}), SDPA's whole backward "
          f"{bwd_whole['sdpa_backward_ms']:.4g}")

    print(f"phase seconds {json.dumps(PHASE_SECONDS)}")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    report = {"card": card, "forward": fwd, "serving": srv, "train": train,
              "runtime": runtime, "drain": drain, "int8": int8, "moe": moe,
              "prefix": prefix, "speculative": spec, "beam": beam,
              "streaming": stream, "lora": lora, "export": export,
              "mesh": mesh, "ring": ring, "moe_mesh": moe_mesh,
              "pipeline": pipeline, "sharded_decode": decode,
              "tp_serving": tp_serving, "runner_mesh": runner_mesh,
              "device_share": share, "plugin_path": plugin,
              "agent_restart": agent, "observability": observability,
              "runtime_activation": activation, "migration": migration,
              "repartition": repartition, "slices": slices,
              "fleet": fleet, "kernels": kernel_recs,
              "phase_seconds": PHASE_SECONDS,
              "flash_bwd_whole": bwd_whole}
    if args.profile:
        rng = np.random.default_rng(SEED + 8)
        tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 257)),
                              device=dev)
        one = _train(torch, W, cfg, tree, dev, tokens, 0)[2]
        report["profile"] = profile_paths(
            torch, W, cfg, params, dev,
            args.out and os.path.join(args.out, "profile"), one)
        print(json.dumps({"profile": report["profile"]}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"paths": {"forward": fwd, "serving": srv,
                                "train": train, "runtime": runtime,
                                "drain": drain, "int8": int8, "moe": moe,
                                "prefix": prefix, "speculative": spec,
                                "beam": beam, "streaming": stream,
                                "lora": lora, "export": export,
                                "mesh": mesh, "ring": ring,
                                "moe_mesh": moe_mesh, "pipeline": pipeline,
                                "sharded_decode": decode,
                                "tp_serving": tp_serving,
                                "runner_mesh": runner_mesh,
                                "device_share": share,
                                "plugin_path": plugin,
                                "agent_restart": agent,
                                "observability": observability,
                                "runtime_activation": activation,
                                "migration": migration,
                                "repartition": repartition,
                                "slices": slices, "fleet": fleet}},
                     default=str))
    print(json.dumps(
        {"kernels": [{k: x[k] for k in keys} for x in kernel_recs]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
