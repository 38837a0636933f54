#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (spark_rapids_ml_tpu_torch) on one NVIDIA
GPU and check it, kernel by kernel and end to end.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device, nvcc and PyTorch
built for CUDA, and nothing of JAX. It exits non-zero, printing no result,
when there is no CUDA device or the port is not importable.

Phases (any failure raises and the script exits non-zero):

1. Environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for matmuls and cuDNN, so every f32 product is full f32;
   incidents start no profiler capture unless a phase asks for one
   (``SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_CAPTURE_S`` defaults to 0 here;
   phase 11 sets its own).
2. Build: every kernel of the path from the checkout's sources, fresh,
   with the registers, shared memory and spills ``ptxas -v`` reports for
   the prep, FFMA and tensor-core kernels, and each Gram launch's dynamic
   shared memory. Fails if ptxas reports a spill, if the SASS
   (``cuobjdump -sass``) of either tensor-core instantiation lacks wgmma
   (``HGMMA``) or TMA loads (``UTMALDG``), or if the FFMA pipeline's lacks
   ``UTMALDG`` or ``FFMA`` or holds a tensor-core instruction (``HGMMA``,
   ``HMMA``).
3. Each kernel against its plain PyTorch version on the card, per
   precision, at the main-path bucket (8192 × 4096), with a masked tail, at
   a ragged shape, at 5 × 129 and on a row view with an odd stride, within
   its bar (``ops/fused_gram.PLAIN_RTOL``); each precision's prep pass must
   equal its plain version bit for bit on each. At the bucket, controls
   that compute in another precision must miss that bar, so the bar can
   tell a wrong precision. Timed with CUDA events at the bucket (the whole
   call, and the prep pass alone) beside its plain version, a library
   yardstick and its bound; the Gram launch's share (call − prep) is
   logged as a rate against the operand type's peak. Then phase 14's new
   shapes, each checked (prep bit for bit, Gram within its bar) and timed
   the same way: bfloat16_3x on the streamed LinearRegression's bucket of
   Z = [X | y] (7936 × 4097, one tile column past 4096) and highest on
   65,536 × 4096 with a √weight row multiplier.
4. The PCA slice at the north-star width (4096 features, k = 256; rows cut
   from 10,485,760 to fit the run's time), data with a decaying spectrum
   made per chunk from a seed on the card:
   (a) two-pass streamed fit from a factory of 65,536-row chunks,
       262,144 rows → 32 buckets of 8192 rows, default gramPrecision;
   (b) one-pass streamed fit from a one-shot generator, 65,536 rows → 8
       buckets, gramPrecision 'highest';
   (c) one-shot fit of a 32,768 × 4096 array (1 GiB as float64, not above
       the streaming threshold) → 1 launch, gramPrecision 'bfloat16'.
   Each fit runs with the launch counts set to 0 just before it and read
   just after, must launch its kernel exactly that often, and is held
   against the same fit computed with the kernel's plain version on the
   card. Then a few 4096-row transform requests, and save → load →
   transform again. A small fit is held against a float64 numpy oracle.
5. Serving fit (c)'s model (4096 features, k = 256) through the port's
   registry, ``ServeEngine`` (max_batch_rows 1024, pipeline depth 2, the
   default bucket ladder 8…1024) and HTTP server, once per precision ladder
   (native, bf16, int8), with ``torch.set_float32_matmul_precision("high")``
   set for the whole phase (the TF32 trap, which native must survive).
   Per ladder: warmup (bf16 and int8 print the offline max-error check,
   which must end in a verdict; bf16 must pass it and serve bf16; a
   refused int8 serves native, counted), then 256 requests in the binary
   wire format from 8 client threads over HTTP, row counts log-uniform
   over 1…1024 from SEED, rows with bench.py's 1/(1+j) column variances,
   and after them 32 JSON requests of at most 64 rows (JSON text of
   4096-wide rows costs far more host time than the serve path, so the
   serving numbers are the binary pass's). Every response is held against
   the float64 host product (native ≤ 1e-5, bf16 / int8 ≤ 0.05, max |Δ| /
   max |ref| per response); the degraded, retry and error counters
   (``serving_program`` included) must not move; every batch must have
   run a ``ServingProgram`` on a CUDA tensor. The int8 program on the card
   must equal its CPU twin bit for bit on every shape the traffic gives
   it (each request alone, the requests coalesced up to 1024 rows, the
   offline check's batch). Prints, all on the host clock: requests/s,
   rows/s, client p50/p99, batches, rows per batch and padding waste per
   ladder; an ``engine.predict`` loop at 1, 64 and 1024 rows; and 4096
   rows through the engine (four 1024-row requests at once) beside
   ``PCAModel.transform`` on the same rows. The serve path launches no
   hand kernel: the launch counts are set to 0 before the phase and must
   read 0 after it.
6. Multi-tenant serving of the same model, native ladder, under the same
   TF32 trap: one ``ServeEngine`` per run (queue depth 8, 1024 rows per
   batch, 5 ms linger, pipeline depth 2; tenant ``greedy`` quota 2,000
   rows/s with a burst of 4,000, ``compliant`` unlimited, weights 1:1;
   shed thresholds queue wait 20 ms and depth fraction 0.25, all through
   the constructor) behind the HTTP server, binary frames with
   ``X-Tenant`` / ``X-Priority``. Traffic for 8 s, from pools of bodies
   made from SEED, each tenant's client threads in a child process of
   their own (so the load does not share the server's GIL):
   ``compliant`` 2 clients, interactive, 64-row requests paced at 20
   requests/s each; ``greedy`` 8 closed-loop clients, batch, 512-row
   requests back to back. Run (A) compliant alone, (B) both
   tenants with the fair queue and shedding, (C) both with the kill
   switches (``SPARK_RAPIDS_ML_TORCH_SERVE_SCHED=fifo``, ``..._SHED=0``).
   Every 200 is held to the native bar against the float64 host product.
   Run (B) also fails unless every compliant request returns 200; the
   greedy tenant gets at least one 503 with ``"shed": true`` and a
   ``Retry-After`` of at least 1 and nothing but 200, shed 503 and 429
   (with ``Retry-After``); ``sparkml_serve_shed_total`` is 0 for
   compliant and equals the greedy clients' shed 503s (admission sheds,
   pre-parse fast sheds and preemptions together); the errors counter
   moves by the ``load_shed`` sheds only; and ``/readyz`` returns to 200
   on probes alone within the hold time plus 2 s. Every run: no degraded
   answer, no retry, no CPU program run, one CUDA program run per batch,
   no hand-kernel launch. Prints per tenant requests, 200 / 429 / 503
   counts, rows/s and the 200s' client p50 / p99 (host clock), the
   highest shed level, the peak queue-wait estimate and the sheds by
   reason.
7. PCA across ranks: ``parallel.initialize_multihost`` joins a world of one
   rank in this process (coordinator 127.0.0.1 on a free port), which must
   run NCCL. On fit (a)'s 262,144 × 4096 float32 rows, k = 256, default
   gramPrecision: ``distributed_pca_fit`` two pass and one pass,
   ``DistributedStreamingPCA`` over the four chunks, and
   ``feature_sharded_pca_fit`` on a 1 × 1 grid, ring + eigh and all-gather
   + randomized. Each run, with the launch counts set to 0 just before it
   and read just after, must launch the kernel as often as the code says
   (1 / 1 / 4 / 1 / 0) and agree with fit (a)'s model at the bar of phase
   4 (components, EVR) and in its mean (1e-5 relative); its wall time is
   printed (host clock). Then the kernel on the whole shard (bfloat16_3x)
   against its plain version (``PLAIN_RTOL``) and float64, timed with CUDA
   events beside its plain version, the ``torch.matmul`` yardstick, its
   bound and the same rows as 8192-row launches summed. The process group
   is destroyed at the end of the phase.
8. The debug plane: a fresh history sampler at 100 ms
   (``obs.tsdb.start_sampling``), then fit (c)'s model on the native
   ladder behind ``start_serve_server``, phase 5's 256 binary requests
   from 8 clients (the launch counts set to 0 just before them), every
   response held to the native bar. Fails unless the traffic launched no
   hand kernel; ``sparkml_serve_device_batch_seconds_total{device=
   "cuda:0"}`` equals the batcher's ``sparkml_serve_device_busy_seconds_
   total``, in total and over the traffic; ``/debug/history`` holds
   ``sparkml_device_mem_bytes_in_use{device="cuda:0",source="cuda"}``
   whose last point equals ``torch.cuda.memory_allocated(0)`` read at a
   quiescent sweep, and ``bytes_limit`` equals the card's
   ``total_memory``; ``/debug/slo`` has exactly the ported sections (no
   replicas, rollout or autoscale) with no degraded answer,
   retry, restart or armed fault; ``/debug/traces?limit=20`` gives 20
   trees rooted at ``serve:http:predict``, at least one with a linked
   batch span; and the sampler swept at least 10 times and at least half
   as often as its cadence allows. Prints, on the
   host clock: requests/s beside phase 5's native, the serving busy share
   (Δ batch seconds / traffic wall: the union of dispatch to completion,
   an upper bound on device time) and idle share, and the sampler's cost
   per sweep (``sparkml_obs_overhead_seconds_total{component="sampler"}``
   / sweeps).
9. Profiling and the flight recorder: fit (c)'s model on the native ladder
   behind ``start_serve_server``, the history sampler at 100 ms, the
   flight recorder's dumps in a fresh temporary directory. ``POST
   /debug/profile?seconds=60&label=smoke`` starts a ``torch.profiler``
   capture ([CPU, CUDA], ``profile_all_threads``) and a second POST must
   get 409; once the trace runs (its start latency printed), phase 5's
   256 binary requests from 8 clients (the launch counts set to 0 before
   the POST), every response held to the native bar, then
   ``profiler.stop_capture()`` and ``wait``. Fails unless ``GET
   /debug/profile`` reports ``torch_outcome`` ``ok`` with a torch trace;
   the artifacts are that torch trace and the span trace, both JSON; the
   torch trace holds cuBLAS GEMM ``kernel`` events and HtoD and DtoH
   ``gpu_memcpy`` events; the capture counters moved ``started`` 1 and
   ``completed`` 1; no hand kernel launched; and the device's busy seconds
   (the union of every kernel, memcpy and memset interval) are at most
   the batcher's busy seconds over the capture. Prints, each beside the
   card's name and power limit: device busy seconds, the device busy
   share of the traffic wall beside the window occupancy (here and phase
   8's), per batch the device seconds and the host seconds (occupancy
   less device), the unions of HtoD, GEMM and DtoH, the copy/compute
   overlap (memcpy ∩ kernel over memcpy), kernels per batch, the host
   time of the launch and copy calls, and the device's gaps between
   merged intervals. Then ``flight.dump("chip_smoke:phase9")`` with the
   server up must write whole JSON holding ``thread_stacks``,
   ``open_spans``, ``active_traces``, ``breaker_events``,
   ``metrics_history`` (with ``sparkml_device_mem_*{source="cuda"}``
   series) and ``metrics``, counted once in
   ``sparkml_flight_dumps_total{reason="chip_smoke"}``; its size and
   time to write are printed.
10. Tiering on the card: fit (c)'s model as A and three copies loaded from
    one save as B, C and D (each 4096 × 256 float64 weights, 8,388,608
    B staged) behind one ``ServeEngine`` (native, pipeline depth 2, 1024
    rows) and ``start_serve_server``, with a ``TieringController`` on an
    injected clock (budget three models' weights, flap floor 30 s) bound
    into admission. D answers one request (its reference), then phase
    5's binary traffic goes to A, B and C in turn from 8 clients. A tick
    (``evaluate_once``) must park D and only D, leave the accounted bytes
    within the budget, and ``torch.cuda.memory_allocated(0)`` (after
    ``gc.collect()`` and a synchronize) must fall by at least D's
    weights; ``/debug/costs`` shows D at 0 ``weights`` bytes and
    ``/debug/tiering`` shows it ``cold``. Then, while A-C traffic runs
    again, one request to D over HTTP: it must answer 200 within the
    native bar, with one ``sparkml_serve_tiering_first_hit_seconds``
    observation, every A-C response 200 within the native bar and at
    least one landing inside D's first hit, and ``memory_allocated``
    back up by D's weights within 4 MiB: the raw reading, so a cuBLAS
    workspace a reactivation made (PyTorch keeps one per handle and
    stream; every serving program shares one stream pair per device so
    that a rebuild meets the ones it has) fails it. A second tick parks D
    again (``memory_allocated`` falls by ≥ its weights), and 8
    concurrent first hits must all answer 200 within the bar with
    exactly one reactivation and seven ``gate_wait`` events, and raise
    ``memory_allocated`` by D's weights within 4 MiB. Finally
    ``ledger.reconcile()`` (the ledger's device seconds against
    devmon's, per model) must read ``ok``, no tiering or ledger error is
    counted, and the phase launches no hand kernel. Prints, with the
    card's name and power limit, the deactivation's time (its
    ``serve:tiering:deactivate`` span), the first hit's client latency
    and reactivation time, the 8 hits' p50, the allocated and reserved
    bytes around each transition, and A-C's requests/s beside phase
    5's.
11. The auto-incident engine on the card: fit (c)'s model as
    ``pca_inc`` (native, pipeline depth 2) behind ``start_serve_server``,
    in a fresh metrics registry (``MetricsRegistry.reset``: phases 5-10's
    slowest requests would otherwise be the exemplars the bundle starts
    from; the singletons that bound families, the fit monitor's among
    them, are made anew), with the incident engine on the process-wide
    sampler, whose thread is stopped: the phase sweeps it itself
    (``sample_once``) on an injected clock, and counts its sweeps from
    there. Baseline: 20 sweeps, two binary requests of 64 rows before
    each; then a ``latency`` fault on the model whose delay is read
    off the store's baseline p99 (3 x that p99, never below 150 ms), and
    four requests under it, each held to the native bar. Fails unless
    exactly the second sweep after the fault opens exactly one incident,
    ``serve_p99_spike``, kind ``latency``, labelled with the model, and a
    third sweep dedups into it; its guarded ``torch.profiler`` capture
    starts, and with two requests served under it ends ``ok`` with at
    least two GEMM kernels, every kernel on ``cuda:0``, in its trace; the
    bundle holds ``history.json`` with the implicated series' points, a
    flight dump, and ``traces.json`` with a trace tree holding a
    ``serve:`` span seeded from an exemplar, the slowest exemplar an
    injected request whose trace ``GET /debug/traces?trace_id=``
    resolves; ``/metrics`` carries
    ``# exemplar: sparkml_serve_request_latency_seconds`` lines; with the
    fault cleared, sweeps resolve it within the lookback and
    ``incident.json`` reads ``resolved``; no thread is named for
    incidents or anomalies; the phase leaves no hook or dump section
    behind and launches no hand kernel. Prints the baseline p99 and the
    delay, the sweeps to open and to resolve, the bundle's file sizes,
    the capture's device events, the anomaly sweep's cost per sweep beside
    the sampler's own (host clock) and the phase's seconds.
12. Fit and transform reports, and the dashboard. Fit (c)'s
    ``fit_report_`` (made in phase 4) must read platform ``cuda``, the
    card count, ``healthy``, a ``cuda``-sourced allocator watermark of
    at least its float32 input's 536,870,912 B, and phases equal to
    ``fit_timings_``'s plus ``total``; a 4096-row ``transform`` of its
    model must report ``device_put`` / ``compute`` / ``host_sync``, 4096
    rows and a numerics verdict over 4096 rows with no NaN or Inf row.
    Then phase 5's 256 binary requests, native, from 8 clients over HTTP:
    each batch must add exactly one ``sparkml_transforms_total``, one
    ``sparkml_numerics_checks_total``, one ``sparkml_transform_seconds``
    observation and one ``transform:pca`` span, and ``/metrics`` must hold
    the ``# exemplar:`` line of ``sparkml_transform_latency_seconds`` with
    quantile labels exactly 0.5, 0.95 and 0.99. A ``nan`` fault on two
    calls: four requests, the first answered 200 after two retries, the
    rest without, none degraded, every answer within the native bar; two
    ``NumericsError`` transform errors, no numerics anomaly and one check
    per batch (the NaN guard fails a corrupted batch before the sentinel
    sees it), as ``tests/test_torch_serve_records.py`` fixes for both
    packages. ``GET /dashboard`` must answer 200 ``text/html`` holding
    the page's markers, every URL it fetches that the port serves (and
    ``/debug/costs``) 200 (``/debug/fit`` among them), ``/debug/fleet``
    404; no hand kernel launches.
    Prints the reports' phases (host clock), the watermark and the
    sentinel's host cost (median of 200 calls on a 1024 x 256 float64
    output) beside the median batch wall, each with the card's name and
    power limit.
13. The fit-path monitor on the card (``obs.fitmon``). In a fresh metrics
    registry with fresh singletons (as phase 11), ``start_serve_server``
    (fit (c)'s model, no traffic) starts the process-wide sampler, whose
    thread is stopped: the phase sweeps it itself on an injected clock,
    the incident engine on its post-sweep hook (its capture off). A fresh
    one-rank NCCL world (phase 7 destroyed its own; if it cannot start
    again the phase fails). On fit (a)'s 262,144 × 4096 float32 rows, k =
    256: ``distributed_pca_fit`` two pass and one pass, and
    ``distributed_streaming_pca_fit`` over four 65,536-row chunks, each
    with the launch counts set to 0 just before it: 1 / 1 / 4 launches,
    agreement with fit (a)'s model at phase 7's bar, the report's phases
    (``prepare`` / ``placement`` / ``execute``, or ``stream`` /
    ``finalize``, and ``total``) and collective bytes, and a ``FitRun``
    with the steps ``covariance_eigh``, or ``stream_fold`` × 4 and
    ``finalize``, whose rows are the fit's, every device time > 0, the
    run's FLOPs the Gram formula rows·n·(n+1) summed over its calls, each
    step's MFU FLOPs / device seconds / the card's table peak (relative
    1e-9, in (0, 1]; the card must be in the table), ``covariance_eigh``
    compute-bound. ``sparkml_fit_device_seconds_total`` must equal
    devmon's ``fit:<algo>`` device seconds exactly. ``GET /debug/fit``
    must hold the JAX key set, the table's peaks and a watchdog verdict
    ``cuda``, ok, with a canary time; of the URLs ``/dashboard`` fetches
    only ``/debug/fleet`` may answer 404. Then two watchdog drills through
    the sampler, the builtin detector and the incident engine: an
    expected platform ``cpu`` on the card, and a canary that blocks; each
    must open exactly one ``fit_backend_degraded`` incident, keep it on
    two more sweeps, and resolve it once the watchdog recovers. Prints the
    peaks beside the card's power limit (and a note below 700 W), each
    fit's phases and step table (rows, wall and device ms, GFLOP, FLOP/B,
    MFU, bound), MFU per step, fitmon's cost per step
    (``component="fitmon"``) and the watchdog's per check, and the
    streamed fit's wall beside phase 7's unmonitored one (host clock).
14. The Gram kernel's other callers at 4096 features, each run with the
    launch counts set to 0 just before it and read just after, each
    launching exactly what its code says. (i) ``RowMatrix`` over fit (a)'s
    262,144 rows as 4 partitions (``use_xla_dot``, ``use_xla_svd``): 4
    launches; its 256 principal components against fit (a)'s model at
    phase 4's bar; ``multiply(pc)`` against the float64 product on the
    host at the transform bar (1e-5). (ii) ``TruncatedSVD(k=256)`` on
    65,536 of those rows shifted by 1.0 per column: 1 launch of the
    uncentred Gram; against the same fit with the kernel's plain version
    on the card, |cos| ≥ 0.999 over the top 64 components and σ within
    1e-3 relative; the zero columns (σ = 0) the randomized solve leaves
    in the tail are counted. (iii) ``LinearRegression`` on a Gaussian design
    (N(0, 1), planted coefficients, intercept 3.0, noise 0.1), against
    float64 normal equations on the card (cuBLAS DGEMM, no kernel),
    relative error of (coefficients, intercept): one-shot on 65,536 rows
    (the streaming threshold raised for it) and weighted (w ~ U(0.5, 2),
    the √w route), 1 launch each at highest, ≤ 1e-4; elastic net
    (regParam 0.01, elasticNetParam 0.5) against FISTA on the oracle's
    moments, ≤ 1e-3; streamed from a generator of 4 chunks of 65,536
    (Z = [X | y], 34 buckets of 7936 rows at the default precision),
    ≤ 1e-4; ``distributed_linreg_fit`` on a fresh one-rank NCCL world
    against the one-shot fit, ≤ 1e-6, with one all-reduce of
    (n² + 2n + 3) float32. Prints each run's host seconds, errors and
    ``fit_timings_``.
15. KMeans, StandardScaler and the fused pipeline. (i) 2,097,152 × 64
    rows in 64 blobs (centres N(0, 100²) per coordinate, σ = 1, made on
    the card from a seed; 1 GiB as float64, not above the streaming
    threshold): ``KMeans().setK(64).fit`` one-shot; every row's label
    must equal its blob's under one permutation, the centres lie within
    1e-5 (max |Δ| / max |c|) of ``lloyd_iterations`` in float64 on the
    card from the same initial centres, and ``training_cost_`` within
    1e-5 of the float64 host cost of the returned centres. (ii)
    ``kmeans_fit_kernel`` on device rows at 2,097,152 × 64 and × 512
    (bench_models.py's shape), k = 64, 10 iterations at tol 0: seconds per
    pass (the statistics pass; the final cost is one more), rows/s per
    pass and the share of the bound (2·rows·n·k operations of the cross
    term at the float32 peak, or the rows' bytes read once). (iii) The
    same blobs streamed as 8 re-iterable chunks of 262,144 rows, and
    ``distributed_kmeans_fit`` (float32) on a fresh one-rank NCCL world,
    each to (i)'s label bar; the fit monitor's ``lloyd`` step is logged.
    (iv) ``Pipeline([StandardScaler(withMean), PCA(k=256),
    KMeans(k=64)]).fit`` on fit (c)'s 32,768 × 4096 rows: exactly one
    Gram launch; saved, loaded through ``ModelRegistry.load`` and served
    by one engine beside fit (c)'s PCA model and a KMeans(k=64) model of
    the same rows: phase 5's 256 binary requests from 8 clients to the
    pipeline, and 32 of them to the other two. Every pipeline response
    must equal ``run_staged_pipeline`` on its rows bit for bit; the
    labels may differ from ``PipelineModel.transform`` (host float64
    scaler) on at most 1e-3 of the rows, and on none with every stage at
    float64; ``sparkml_serve_program_runs_total`` must gain series for
    ``pipeline``, ``kmeans`` and ``pca`` on ``cuda``; a ``torch.profiler``
    capture over 8 pipeline requests must show one device→host copy per
    batch. Prints requests/s and client p50. (v) The pipeline's bf16 and
    int8 ladders through the engine's offline check: error (the label
    mismatch fraction), verdict and the ladder served; a refused ladder
    must serve native.
16. LogisticRegression and the classifier chain, each fit with the launch
    counts set to 0 just before it and read just after. (i) Phase 14
    (iii)'s design (65,536 × 4096 N(0, 1) rows), labels Bernoulli(σ(x·w* +
    0.5)) with w* ~ N(0, 4/4096) from a seed: one-shot, weighted (w ~
    U(0.5, 2)), ``fitIntercept=False``, each one highest launch per
    Newton iteration, against the same Newton in float64 on the card
    (``logreg_fit_kernel`` on float64 tensors), ≤ 1e-4 relative; the first
    iteration's Hessian on its own √s rows against its plain version and
    timed beside ``torch.matmul`` (f32, TF32 off) and the bound; elastic
    net (0.01 / 0.5, two prox-Newton steps: their FISTA on the 4097² system
    runs on the host) against the same fit at float64, ≤ 1e-3; streamed
    from 4 chunks of 65,536 (32 buckets of 8192 a pass, 6 passes), ≤ 1e-4
    against float64 Newton on the 262,144 rows; ``distributed_logreg_fit``
    on a fresh one-rank NCCL world, ≤ 1e-6 against the one-shot fit, its
    fit-monitor step ``newton`` and its all-reduce record. (ii)
    Multinomial, K = 4 (argmax of planted logits + Gumbel noise), maxIter
    25: at 4096 features (K(K+1)/2 = 10 launches an iteration), against
    the same fit with the Gram's plain version (≤ 1e-4 on [W | b] less its
    class mean) and at float64 (class mismatch ≤ 1e-3, probabilities
    ≤ 2e-3); streamed at 256 features (the first 256 columns, new labels;
    the host float64 solve stays small) against an in-memory float64 fit.
    (iii) ``Pipeline([StandardScaler(withMean), PCA(k=256),
    LogisticRegression()])`` on fit (c)'s rows with binary labels planted
    on the scaled rows: one bfloat16_3x and one highest launch per Newton
    iteration; saved, loaded through ``ModelRegistry.load`` and served
    over HTTP (phase 5's 256 binary requests from 8 clients): every
    response bit-equal to ``run_staged_pipeline``, within 1e-5 of
    ``PipelineModel.transform`` (1e-12 with every stage at float64), one
    device→host copy per batch in a ``torch.profiler`` capture (a capture
    with fewer copies than batches lost a record and is taken again, up
    to 3 times; one with more fails); (iv) the
    one-shot model of (i) served alone to the same traffic, within 1e-5
    relative of float64 σ(Xw + b) on the host; (v) the chain's bf16 and
    int8 ladders through the offline check. Prints each fit's n_iter and
    whether it converged, wall and ``fit_timings_``, requests/s and client
    p50 / p99 beside the card's name and power limit.
17. The other stage families (``models/feature_scalers.py``,
    ``models/feature_transformers.py``) on fit (c)'s 32,768 × 4096 rows
    with every 16th column set to 2.5 (256 constant columns). (ii)
    ``Pipeline([MinMaxScaler, ElementwiseProduct (N(0, 1) scalingVec),
    VectorSlicer (3840 permuted indices), PCA(k=256),
    LogisticRegression()])`` with labels planted on the rows its PCA sees:
    one bfloat16_3x and one highest launch per Newton iteration; (iii)
    ``Pipeline([RobustScaler(withCentering), MaxAbsScaler, Normalizer,
    VarianceThresholdSelector, PCA(k=256), KMeans(k=64)])``: one
    bfloat16_3x launch, the selector keeping 3840 columns. Each chain is
    saved, loaded through ``ModelRegistry.load`` (same stage classes and
    state), warmed with no ``n_features`` (the head gives 4096) and served
    over HTTP in one engine (phase 5's 256 binary requests from 8
    clients): every response bit-equal to ``run_staged_pipeline``; (ii)'s
    probabilities within 1e-5 of ``PipelineModel.transform`` on the first
    8192 served rows and 1e-12 with every stage at float64, (iii)'s labels
    mismatched on at most 1e-3 of them and on none at float64; one
    device→host copy per batch in a ``torch.profiler`` capture (retaken as
    phase 16's); one CUDA program run per batch, no error, degraded
    answer or retry. (i) Each family's body as a one-stage program on the
    card (MinMax and Robust the chains' heads; MaxAbs, the variance
    selector, which must drop exactly the 256 planted columns, Normalizer
    p = 2 and ∞, Binarizer 0.25, ElementwiseProduct, VectorSlicer, a
    ChiSqSelectorModel of 1024 indices) against the model's host
    transform: float64 on 4096 rows bit-equal (Normalizer 1e-12
    relative), float32 on the first 8192 rows equal for the gathers and
    the Binarizer, within 1e-6 (Normalizer p = 2 1e-5) for the rest; each
    body timed at float32 on all 32,768 rows with CUDA events beside its
    bound (the bytes
    read and written over 3.35 TB/s), printed as a ``{"stage_bodies":
    [...]}`` line. (iv) Both chains' bf16 and int8 ladders through the
    offline check; a refused ladder must serve native.
18. LinearSVC and GeneralizedLinearRegression at 4096 features on phase
    14's design (65,536 × 4096 N(0, 1), made on the card from the seed),
    each float32 Newton Hessian and IRLS XᵀWX one highest launch (per
    bucket when streamed), the counts set to 0 before each fit and held
    exactly after it. (i) LinearSVC, labels 1[x·w* + 0.5 + ε > 0]:
    one-shot, weighted (w ~ U(0.5, 2)), no intercept, standardization on,
    streamed (4 × 65,536 rows in buckets of 8192, 3 Newton passes: cut),
    each within 1e-4 of the same generalized Newton in float64 on the
    card (``svc_fit_kernel`` on float64 tensors); ``distributed_svc_fit``
    on one NCCL rank within 1e-6 of the one-shot fit, its fit-monitor
    step and all-reduce bytes. (ii) GLM Poisson / log: one-shot and with
    weights and an offset, within 1e-4 of the same IRLS at float64;
    streamed at maxIter 2 within 1e-5 of the in-memory fit at maxIter 2
    (a fit at maxIter launches once more, for its final deviance);
    ``distributed_glm_fit`` at maxIter 2 within 1e-6 of that in-memory
    fit, its ``irls_pass`` steps and all-reduce bytes. (iii) GLM at
    the first 512 columns: gamma / log, tweedie p = 1.5 / log, binomial /
    probit, gaussian / identity, each within 1e-4 of float64. Each fit's
    wall split on the host clock into Gram launches, device and host
    solves and host → device copies; the first Hessians (and the SVC's
    last, on its active set) timed beside ``torch.matmul`` and the bound.
    Every model saved, loaded by ``load_model`` and ``ModelRegistry.load``,
    and (but the offset model) served 32 requests of ≤ 64 rows through
    ``ServeEngine``'s blocking path: labels equal to the float64 host
    margin's, margins within 1e-5 of ‖x‖·‖w‖ + |b|, μ within 1e-5
    relative.
19. NearestNeighbors and DBSCAN (``models/nearest_neighbors.py``,
    ``models/dbscan.py``, ``parallel/distributed_{knn,ivf,dbscan}.py``), no
    hand kernel (asserted: the launch counts are set to 0 at the start and
    must read 0 at the end). Data of SIFT1M's shape made on the card from
    the seed: 1,000,000 × 128 float32 items in 1,024 Gaussian blobs
    (centres N(0, 0.5²), σ = 1), 10,000 fresh queries from the same blobs,
    k = 10. (i) Brute force: the card's ``kneighbors`` against the same
    search at float64 on the card (k = 11) for all queries and against
    ``_host_kneighbors`` for 256: index sets equal except rows whose
    float64 10th and 11th distances lie within 1e-5 relative (counted),
    distances within 1e-5 relative; bit-equal under
    ``set_float32_matmul_precision("high")`` and in chunks of 97; queries/s
    (host clock), one chunk's CUDA-event ms against its bound (the cross
    term's operations at 67 TFLOP/s, or the items' bytes) split into
    distances and selection, and the peak memory. (ii) IVF-Flat at nlist
    √n = 1000: the build's seconds (k-means++, Lloyd, assignment, layout),
    Lloyd's ms a pass at 1,000,000 × 1000 and the build's peak memory;
    recall@10 against (i) and queries/s at nprobe 8 and 32; 256 queries'
    ids and distances equal to the same search of a CPU copy of the card's
    index; on 65,536 of the items at nlist 64 and nprobe 64, 1,024 queries
    (cut) equal to float64 brute as in (i). (iii) IVF-PQ on the same
    coarse quantizer, auto pqM (32 subspaces, dsub 4), pqBits 8: build
    seconds, the uint8 codes' bytes (n·M) and padded layout, recall@10 and
    queries/s at nprobe 8 and 32 with refineRatio 2 and 0; re-rank recall
    ≥ recall without − 1e-9, recall at 32 ≥ recall at 8 − 0.05. (iv)
    DBSCAN on 131,072 lattice rows (64 blobs in 16 dimensions, integer
    centres N(0, 10²), N(0, 1) offsets rounded to 1/4, 2 % uniform noise):
    dense on the first 16,384 rows equal to ``_host_dbscan`` in float64;
    tiled (blockRows 4096) at 16,384 equal to dense, at 131,072 float32
    equal to float64; sweeps and seconds a sweep. (v) On a fresh one-rank
    NCCL world: ``distributed_kneighbors`` equal to (i),
    ``distributed_ivf_search`` equal to the model's ivfflat (nprobe 8) and
    ivfpq (nprobe 8, no re-rank) searches, ``distributed_dbscan_labels``
    equal to the tiled float32 fit. (vi) A 16,384-item model saved, loaded
    through ``load_model``, its ``kneighbors`` equal.
20. The tree family (``models/{random_forest,decision_tree,gbt}.py``,
    ``ops/forest_kernel.py``, ``parallel/distributed_{forest,gbt}.py``),
    no hand kernel (asserted). Data made on the host from the seed:
    HIGGS's shape, 2,097,152 training rows (cut from 11 M so the host's
    quantile binning stays at seconds) and 262,144 held out, 28 float32
    features, a binary label from a planted nonlinear rule plus noise;
    YearPredictionMSD's shape and published split, 463,715 + 51,630 rows
    of 90 features, a planted year. (i) RandomForestClassifier at Spark's
    defaults (20 trees, depth 5, 32 bins; subset 'auto'), float32: the
    fit's densify / binning / grow seconds, trees a group, peak memory,
    held-out accuracy and transform rows/s; the float64 fit on the card
    grows the same trees (asserted) and agrees on ≥ 0.999 of the labels;
    with ``maxMemoryInMB`` 8192 (20 trees a group) the same trees; one
    deepest-level histogram contraction for 1 and 20 trees against its
    bounds (bytes; the dense float64 GEMM's operations at 67 TFLOP/s).
    (ii) DecisionTreeClassifier at depth 10 on (i)'s rows: seconds, peak,
    ``depth_`` 10 and ``num_nodes_`` 2047. (iii) RandomForestRegressor on
    the YearPredictionMSD rows ('auto': 30 of 90): the split, peak and
    held-out RMSE (below the mean's). (iv) GBTClassifier on (i)'s rows
    (maxIter 20, depth 5, stepSize 0.1, 10 % validation rows) and
    GBTRegressor on (iii)'s: rounds kept, each round's grow against its
    host time. (v) On a fresh one-rank NCCL world, ``distributed_forest_fit``
    (10 trees) and ``distributed_gbt_fit`` (5 rounds) on all of (i)'s rows,
    timed with their collective accounting; on the first 65,536 rows at
    float64 each equals the same function in a one-rank gloo world on the
    CPU (a subprocess): features and thresholds equal, leaves within 1e-9.
    (vi) On those rows at float64, 4 trees of depth 5, the card against
    the CPU: the classifier's trees identical, the regressor's predictions
    within 1e-9 (trees that differ counted). (vii) A forest, a tree and a
    GBT model saved, loaded through ``load_model``, transform bit-equal.

Then one JSON line ``{"stage_bodies": [...]}``, one ``{"knn_dbscan":
{...}}`` (phase 19's numbers), one ``{"trees": {...}}`` (phase 20's),
one ``{"kernels": [...]}``
(each kernel with its launches per phase and, under ``extra_shapes``,
phase 3's timings of phase 14's shapes and phases 16 and 18's Hessians),
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FEATURES = 4096
K = 256
BUCKET_ROWS = 8192
CHUNK_ROWS = 65536
NORTH_STAR_ROWS = 10_485_760
SEED = 0

# NVIDIA's published H100 SXM peaks (dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "f64": 67e12}

# per precision: kernel instantiation, operand type and bf16 passes
PRECISIONS = {
    "bfloat16_3x": ("fused_centered_gram_bf16x3", "bf16", 3),
    "bfloat16": ("fused_centered_gram_bf16", "bf16", 1),
    "highest": ("fused_centered_gram_f32", "f32", 1),
}
SOURCE = "spark_rapids_ml_tpu_torch/csrc/fused_gram.cu"
REPLACES = "spark_rapids_ml_tpu/ops/pallas_gram.py:200"

# Phase 14's new kernel shapes, checked and timed in phase 3: label →
# (precision, rows, n, row multiplier). The streamed LinearRegression's
# bucket of Z = [X | y] (auto_batch_rows(4097) = 7936 rows, one tile column
# past 4096 wide) and its one-shot Gram (√weight rows, full f32).
SLICE_14_SHAPES = {
    "streamed Z bucket": ("bfloat16_3x", 7936, N_FEATURES + 1, "ones"),
    "root-weight rows": ("highest", CHUNK_ROWS, N_FEATURES, "root_weights"),
}

# Fit vs plain-version fit: components whose spectral gap is well above
# f32 rounding (the first 64 of a 1/(1+j) spectrum) and their EVR.
TOP_COMPONENTS = 64
COS_BAR = 0.999
EVR_RTOL = 1e-3


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {message}")


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def bound(rows: int, n: int, operand: str, passes: int):
    """Least time for the Gram on this input: each input byte read once and
    G written once over the memory rate, vs the upper triangle's
    multiply-adds (2 operations each) per pass over the operand type's
    peak. Returns (ms, 'bytes' | 'operations')."""
    bytes_moved = 4 * (rows * n + n + rows + n * n)
    ops = passes * 2.0 * rows * n * (n + 1) / 2
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[operand] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def ptxas_entries(ptxas: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    ``ptxas -v`` report of a build."""
    entries = {}
    for block in ptxas.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        entries[name] = (int(regs.group(1)) if regs else -1,
                         *(int(v) for v in (spill.groups() if spill else (-1, -1))))
    return entries


def check_ptxas(ptxas: str) -> None:
    """Every kernel of the path is in the report, with no spill."""
    entries = ptxas_entries(ptxas)
    for kernel in ("gram_prep_f32_kernel", "gram_ffma_kernel",
                   "gram_prep_kernel", "gram_tc_kernel"):
        found = [e for name, e in entries.items() if kernel in name]
        check(bool(found), f"{kernel} not in the ptxas report")
        for regs, stores, loads in found:
            check(stores == 0 and loads == 0,
                  f"{kernel} spills: {stores} B stored, {loads} B loaded")
    log(f"  ptxas: {len(entries)} kernels, no spills")


def check_sass(cuda_build, path: str) -> None:
    """Fail unless each tensor-core instantiation's SASS holds wgmma
    (HGMMA) and TMA tile loads (UTMALDG), and the FFMA pipeline's holds TMA
    tile loads and FFMA and no tensor-core instruction."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found = {"gram_tc_kernel": 0, "gram_ffma_kernel": 0}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        kernel = next((k for k in found if k in name), None)
        if kernel is None:
            continue
        found[kernel] += 1
        counts = {op: block.count(op)
                  for op in ("HGMMA", "HMMA", "UTMALDG", "FFMA")}
        log(f"  SASS {name}: {counts}")
        if kernel == "gram_tc_kernel":
            check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                  f"{name} has no wgmma or no TMA load in its SASS")
        else:
            check(counts["UTMALDG"] > 0 and counts["FFMA"] > 0,
                  f"{name} has no TMA load or no FFMA in its SASS")
            check(counts["HGMMA"] == 0 and counts["HMMA"] == 0,
                  f"{name} runs on the tensor cores")
    check(found == {"gram_tc_kernel": 2, "gram_ffma_kernel": 1},
          f"instantiations in the SASS: {found}, expected 2 tensor-core "
          f"and 1 FFMA")


def mirrored(torch, g):
    return torch.triu(g) + torch.triu(g, 1).T


def controls(torch, fg, x, mean, rowmul, precision):
    """What a kernel that computed ``precision`` in another precision would
    return on these inputs: {label: G}."""
    xc = (x - mean[None, :]) * rowmul[:, None]
    if precision == "highest":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = mirrored(torch, xc.T @ xc)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        return {"TF32 product": tf32,
                "bfloat16_3x kernel": fg.fused_centered_gram(
                    x, mean, rowmul, "bfloat16_3x")}
    if precision == "bfloat16_3x":
        hi = xc.to(torch.bfloat16).to(torch.float32)
        lo = (xc - hi).to(torch.bfloat16).to(torch.float32)
        return {"one bf16 pass": fg.fused_centered_gram_reference(
                    x, mean, rowmul, "bfloat16"),
                "lo·hi dropped": mirrored(torch, hi.T @ hi + hi.T @ lo)}
    return {"full f32": fg.fused_centered_gram_reference(
                x, mean, rowmul, "highest"),
            "bfloat16_3x kernel": fg.fused_centered_gram(
                x, mean, rowmul, "bfloat16_3x")}


def bits(torch, t):
    """The tensor's bits as integers, to compare floats bit for bit (signed
    zeros included)."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def check_prep(torch, fg, x, mean, rowmul, precision, label) -> None:
    """The prep pass's scratch equals its plain version's bit for bit,
    padding included."""
    got = fg.gram_prep(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    want = fg.gram_prep_reference(x, mean, rowmul, precision)
    same = got.shape == want.shape and got.dtype == want.dtype and \
        torch.equal(bits(torch, got), bits(torch, want))
    log(f"  prep pass {precision} {label} {tuple(x.shape)} → "
        f"{tuple(got.shape)} {got.dtype}: bit-equal to its plain version "
        f"{same}")
    check(same, f"prep pass {precision} {label} differs from its plain version")


def log_gemm_share(fg, rows, n, precision, operand, passes, gemm_ms) -> None:
    """The Gram launch's share of a call (call time − prep time): its rate
    on the upper triangle's products against the operand type's peak, and
    the panel bytes its 128 × 128 tiles read through L2 (each upper tile
    reads its two panels of every plane over the whole padded depth) over
    that time."""
    tiles = -(-n // 128)
    planes = fg.scratch_shape(rows, n, precision)[0] if operand == "bf16" else 1
    elem = 2 if operand == "bf16" else 4
    panel_bytes = (tiles * (tiles + 1) // 2 * 2 * planes * 128
                   * fg.padded_depth(rows) * elem)
    tflops = passes * 2.0 * rows * n * (n + 1) / 2 / gemm_ms * 1e-9
    peak = PEAK_OPS_PER_S[operand] * 1e-12
    unit = "FFMA" if operand == "f32" else "tensor-core"
    log(f"    {unit} launch (call − prep) {gemm_ms:.4f} ms: {tflops:.1f} "
        f"TFLOP/s of {operand} products, {tflops / peak:.3f} of {peak:g} "
        f"TFLOP/s; panels read through L2 {panel_bytes / 1e9:.2f} GB, "
        f"{panel_bytes / gemm_ms * 1e-9:.2f} TB/s")


def make_inputs(torch, device, rows, n, masked=0, extra=0, seed=SEED):
    """x (rows, n) with a masked tail of garbage rows and, with ``extra``,
    as a row view of a wider parent from column 1; its masked mean and
    rowmul = mask / √(valid − 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, n + extra, generator=gen, device=device) + 0.5
    if extra:
        x = x[:, 1:n + 1]
    mask = torch.ones(rows, device=device)
    if masked:
        mask[rows - masked:] = 0.0
        x[rows - masked:] = 1e6  # padding garbage the mask must hide
    valid = int(mask.sum())
    mean = (x * mask[:, None]).sum(0) / valid
    rowmul = (mask / (valid - 1) ** 0.5).contiguous()
    return x, mean.contiguous(), rowmul


def phase_kernels(torch, fg, device):
    """Phase 3. Returns {kernel name: measurements}."""
    # label: (rows, n, masked tail rows, extra columns of the parent whose
    # row view x is, starting at column 1: an odd row stride, unaligned)
    shapes = {
        "bucket": (BUCKET_ROWS, N_FEATURES, 0, 0),
        "masked tail": (BUCKET_ROWS, N_FEATURES, 3000, 0),
        "ragged": (1000, 1100, 0, 0),
        "tiny": (5, 129, 0, 0),
        "odd-stride view": (3000, 1000, 0, 3),
    }
    inputs = {label: make_inputs(torch, device, *shape, seed=SEED + i)
              for i, (label, shape) in enumerate(shapes.items())}

    results = {}
    for precision, (name, operand, passes) in PRECISIONS.items():
        bar = fg.PLAIN_RTOL[name]
        worst = worst_rel = 0.0
        for label, (x, mean, rowmul) in inputs.items():
            check_prep(torch, fg, x, mean, rowmul, precision, label)
            got = fg.fused_centered_gram(x, mean, rowmul, precision)
            torch.cuda.synchronize()
            want = fg.fused_centered_gram_reference(x, mean, rowmul, precision)
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            xc64 = (x.double() - mean.double()) * rowmul.double()[:, None]
            truth = xc64.T @ xc64
            k_true = (got.double() - truth).abs().max().item() / scale
            p_true = (want.double() - truth).abs().max().item() / scale
            log(f"  {name} {label} {tuple(x.shape)}: max_abs_err {err:.3e} "
                f"rel {err / scale:.3e} (bar {bar:g}); vs float64: "
                f"kernel {k_true:.3e}, plain {p_true:.3e}")
            check(bool(torch.isfinite(got).all()), f"{name} {label} finite")
            check(bool(torch.equal(got, got.T)), f"{name} {label} symmetric")
            check(err <= bar * scale,
                  f"{name} {label} kernel vs plain {err / scale:.3e}")
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / scale)

        x, mean, rowmul = inputs["bucket"]
        want = fg.fused_centered_gram_reference(x, mean, rowmul, precision)
        scale = want.abs().max().item()
        nearest = float("inf")
        for label, g in controls(torch, fg, x, mean, rowmul, precision).items():
            rel = (g - want).abs().max().item() / scale
            nearest = min(nearest, rel)
            log(f"  {name} control at the bucket, {label}: rel {rel:.3e} "
                f"(must exceed the bar {bar:g})")
        check(worst_rel < bar < nearest,
              f"{name}: bar {bar:g} does not lie between the kernel's "
              f"{worst_rel:.3e} and the nearest control's {nearest:.3e}")

        x, mean, rowmul = inputs["bucket"]
        rows, n = x.shape
        xc = (x - mean[None, :]) * rowmul[:, None]
        lib_in = xc.to(torch.bfloat16) if precision == "bfloat16" else xc
        ms = time_ms(torch, lambda: fg.fused_centered_gram(
            x, mean, rowmul, precision), iters=20)
        prep_ms = time_ms(torch, lambda: fg.gram_prep(
            x, mean, rowmul, precision), iters=20)
        plain_ms = time_ms(torch, lambda: fg.fused_centered_gram_reference(
            x, mean, rowmul, precision), iters=5)
        library_ms = time_ms(torch, lambda: torch.matmul(lib_in.T, lib_in),
                             iters=20)
        bound_ms, bound_by = bound(rows, n, operand, passes)
        log(f"  {name} at {rows}x{n}: kernel {ms:.4f} ms (prep pass "
            f"{prep_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, torch.matmul yardstick {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of "
            f"the bound")
        log_gemm_share(fg, rows, n, precision, operand, passes, ms - prep_ms)
        results[name] = {
            "max_abs_err": worst, "ms": ms, "prep_ms": prep_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "extra_shapes": {},
        }
    for label, (precision, rows, n, rowmul_kind) in SLICE_14_SHAPES.items():
        name = PRECISIONS[precision][0]
        results[name]["extra_shapes"][label] = slice_14_shape(
            torch, fg, device, label, precision, rows, n, rowmul_kind)
    return results


def slice_14_shape(torch, fg, device, label, precision, rows, n, rowmul_kind):
    """One of phase 14's new kernel shapes: the prep pass bit for bit and
    the Gram within its bar against their plain versions, then timed as the
    bucket is, beside ``torch.matmul`` on the same scaled rows and the
    bound."""
    name, operand, passes = PRECISIONS[precision]
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    x = torch.randn(rows, n, generator=gen, device=device)
    mean = torch.zeros(n, device=device)
    if rowmul_kind == "root_weights":
        rowmul = torch.sqrt(0.5 + 1.5 * torch.rand(rows, generator=gen,
                                                   device=device))
    else:
        rowmul = torch.ones(rows, device=device)
    check_prep(torch, fg, x, mean, rowmul, precision, label)
    got = fg.fused_centered_gram(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    want = fg.fused_centered_gram_reference(x, mean, rowmul, precision)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    bar = fg.PLAIN_RTOL[name]
    log(f"  {name} {label} {rows}x{n}: max_abs_err {err:.3e} rel "
        f"{err / scale:.3e} (bar {bar:g})")
    check(bool(torch.isfinite(got).all()) and bool(torch.equal(got, got.T)),
          f"{name} {label} finite and symmetric")
    check(err <= bar * scale, f"{name} {label} kernel vs plain "
          f"{err / scale:.3e}")
    xs = x * rowmul[:, None]
    ms = time_ms(torch, lambda: fg.fused_centered_gram(
        x, mean, rowmul, precision), iters=10)
    plain_ms = time_ms(torch, lambda: fg.fused_centered_gram_reference(
        x, mean, rowmul, precision), iters=3)
    library_ms = time_ms(torch, lambda: torch.matmul(xs.T, xs), iters=10)
    bound_ms, bound_by = bound(rows, n, operand, passes)
    log(f"  {name} {label} {rows}x{n}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.matmul yardstick {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of the "
        f"bound")
    return {"rows": rows, "n": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def chunk(torch, device, index: int, rows: int = CHUNK_ROWS) -> np.ndarray:
    """One chunk of the decaying-spectrum data (variance of column j is
    1/(1+j), as bench.py's synthetic batch), made on the card from
    SEED + index and handed over as a host float32 array, as a user's
    loader would."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1 + index)
    scale = (1.0 + torch.arange(N_FEATURES, device=device)) ** -0.5
    x = torch.randn(rows, N_FEATURES, generator=gen, device=device) * scale
    return x.cpu().numpy()


def plain_fit(torch, fg, source, k, precision, device, one_pass, x_oneshot=None):
    """The same fit as the port's PCA, with the Gram computed by the
    kernel's plain version on the card."""
    from spark_rapids_ml_tpu_torch.ops.covariance import covariance_from_stats
    from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance_gated

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()

    n = N_FEATURES
    zeros = torch.zeros(n, device=device)
    if x_oneshot is not None:
        x = dev(x_oneshot)
        mean = x.mean(0)
        rowmul = torch.full((x.shape[0],), (x.shape[0] - 1) ** -0.5,
                            device=device)
        cov = fg.fused_centered_gram_reference(x, mean, rowmul, precision)
    elif one_pass:
        g = torch.zeros(n, n, device=device)
        s = torch.zeros(n, device=device)
        count = 0
        for batch, mask in source.batches():
            m = torch.ones(batch.shape[0], device=device) if mask is None \
                else dev(mask)
            b = dev(batch)
            g += fg.fused_centered_gram_reference(b, zeros, m, precision)
            s += (b * m[:, None]).sum(0)
            count += int(m.sum())
        cov = covariance_from_stats(g, s, torch.tensor(count, device=device))
    else:
        s = torch.zeros(n, device=device)
        count = 0
        for batch, mask in source.batches():
            m = torch.ones(batch.shape[0], device=device) if mask is None \
                else dev(mask)
            s += (dev(batch) * m[:, None]).sum(0)
            count += int(m.sum())
        mean = s / count
        g = torch.zeros(n, n, device=device)
        for batch, mask in source.batches():
            m = torch.ones(batch.shape[0], device=device) if mask is None \
                else dev(mask)
            g += fg.fused_centered_gram_reference(dev(batch), mean, m, precision)
        cov = g / (count - 1)
    pc, evr, used = pca_from_covariance_gated(cov, k, solver="auto")
    return pc.cpu().numpy(), evr.cpu().numpy(), used


def compare_fits(label, model, pc, evr, used):
    cos = np.abs(np.sum(model.pc * pc, axis=0))
    evr_rel = np.abs(model.explained_variance - evr) / np.abs(evr)
    log(f"  {label}: |cos| min over top {TOP_COMPONENTS} "
        f"{cos[:TOP_COMPONENTS].min():.6f} (bar {COS_BAR}), over all {K} "
        f"{cos.min():.6f}; EVR max rel err top {TOP_COMPONENTS} "
        f"{evr_rel[:TOP_COMPONENTS].max():.3e} (bar {EVR_RTOL:g}), all "
        f"{evr_rel.max():.3e}; solver kernel fit {model.svd_solver_used_}, "
        f"plain fit {used}")
    check(np.isfinite(model.pc).all() and model.pc.shape == (N_FEATURES, K),
          f"{label} components finite, shape {model.pc.shape}")
    check(cos[:TOP_COMPONENTS].min() >= COS_BAR, f"{label} component |cos|")
    check(evr_rel[:TOP_COMPONENTS].max() <= EVR_RTOL, f"{label} EVR")


def counted_fit(fg, label, estimator, data, kernel, expected):
    """One fit with the launch counts set to 0 just before and read just
    after. Returns (model, launches of ``kernel``)."""
    fg.reset_launches()
    t0 = time.perf_counter()
    model = estimator.fit(data)
    seconds = time.perf_counter() - t0
    counts = dict(fg.launches)
    log(f"  {label}: {seconds:.2f} s, launches {counts}, svd_solver_used_ "
        f"{model.svd_solver_used_}, fit_timings_ "
        f"{ {k: round(v, 4) for k, v in model.fit_timings_.items()} }")
    check(counts[kernel] == expected,
          f"{label}: {kernel} launched {counts[kernel]} times, expected "
          f"{expected}")
    check(sum(counts.values()) == expected,
          f"{label}: other kernels launched: {counts}")
    return model, counts[kernel]


def phase_slice(torch, fg, device):
    """Phase 4. Returns {kernel name: launches on the main path}."""
    from spark_rapids_ml_tpu_torch import PCA, PCAModel
    from spark_rapids_ml_tpu_torch.data.batches import BatchSource

    n_chunks = 4
    rows = n_chunks * CHUNK_ROWS
    log(f"  rows cut from {NORTH_STAR_ROWS:,} (north star) to {rows:,} "
        f"streamed and {CHUNK_ROWS // 2:,} one-shot to fit the run's time; "
        f"{N_FEATURES} features, k = {K}")
    launches = {}

    def factory():
        return (chunk(torch, device, i) for i in range(n_chunks))

    # (a) two-pass streamed, default precision
    kernel = fg.kernel_name(None)
    model_a, launches[kernel] = counted_fit(
        fg, "(a) two-pass streamed", PCA().setK(K), factory, kernel,
        rows // BUCKET_ROWS)
    compare_fits("(a) vs plain", model_a,
                 *plain_fit(torch, fg, BatchSource(factory), K, None, device,
                            one_pass=False))

    # (b) one-pass streamed from a one-shot generator, 'highest'
    kernel = fg.kernel_name("highest")
    model_b, launches[kernel] = counted_fit(
        fg, "(b) one-pass streamed",
        PCA().setK(K).setGramPrecision("highest"),
        iter([chunk(torch, device, 10)]), kernel, CHUNK_ROWS // BUCKET_ROWS)
    compare_fits("(b) vs plain", model_b,
                 *plain_fit(torch, fg,
                            BatchSource(iter([chunk(torch, device, 10)])),
                            K, "highest", device, one_pass=True))

    # (c) one-shot ndarray, 'bfloat16'
    kernel = fg.kernel_name("bfloat16")
    x_c = chunk(torch, device, 20, rows=CHUNK_ROWS // 2)
    model_c, launches[kernel] = counted_fit(
        fg, "(c) one-shot", PCA().setK(K).setGramPrecision("bfloat16"),
        x_c, kernel, 1)
    compare_fits("(c) vs plain", model_c,
                 *plain_fit(torch, fg, None, K, "bfloat16", device,
                            one_pass=False, x_oneshot=x_c))

    # requests: transform 4096-row batches, then save → load → transform
    requests = [chunk(torch, device, 30 + i, rows=4096) for i in range(4)]
    outputs = []
    for i, batch in enumerate(requests):
        t0 = time.perf_counter()
        out = np.asarray(model_a.transform(batch).column("pca_features"))
        seconds = time.perf_counter() - t0
        want = batch.astype(np.float64) @ model_a.pc
        err = np.abs(out - want).max() / np.abs(want).max()
        log(f"  transform request {i}: {batch.shape} → {out.shape} in "
            f"{seconds * 1e3:.2f} ms, rel err vs float64 {err:.3e}")
        check(out.shape == (4096, K) and np.isfinite(out).all(),
              "transform output shape/finite")
        check(err <= 1e-5, f"transform rel err {err:.3e}")
        outputs.append(out)
    with tempfile.TemporaryDirectory() as tmp:
        model_a.save(f"{tmp}/pca")
        loaded = PCAModel.load(f"{tmp}/pca")
    check(np.array_equal(loaded.pc, model_a.pc)
          and np.array_equal(loaded.explained_variance,
                             model_a.explained_variance),
          "components after save/load")
    worst = 0.0
    for batch, out in zip(requests, outputs):
        again = np.asarray(loaded.transform(batch).column("pca_features"))
        worst = max(worst, np.abs(again - out).max() / np.abs(out).max())
    log(f"  save → load: identical components; transform again, max rel "
        f"diff {worst:.3e}")
    check(worst <= 1e-6, "transform after save/load")

    # a small fit on the card against a float64 numpy oracle
    rng = np.random.default_rng(SEED)
    q, _ = np.linalg.qr(rng.normal(size=(64, 64)))
    x = rng.normal(size=(4000, 64)) @ (q * 2.0 ** (-np.arange(64) / 4)) + 3.0
    small = PCA().setK(8).fit(x)
    xc = x - x.mean(0)
    evals, evecs = np.linalg.eigh(xc.T @ xc / (x.shape[0] - 1))
    evals, evecs = evals[::-1], evecs[:, ::-1]
    cos = np.abs(np.sum(small.pc * evecs[:, :8], axis=0))
    evr_err = np.abs(small.explained_variance - evals[:8] / evals.sum()).max()
    log(f"  small fit vs float64 oracle: |cos| min {cos.min():.8f}, EVR max "
        f"abs err {evr_err:.3e}")
    check(cos.min() >= 0.9999 and evr_err <= 1e-5, "small fit vs oracle")
    return launches, model_a, model_c


SERVE_LADDERS = ("native", "bf16", "int8")
SERVE_REQUESTS = 256
SERVE_JSON_REQUESTS = 32
SERVE_JSON_MAX_ROWS = 64
SERVE_CLIENTS = 8
SERVE_MAX_ROWS = 1024
SERVE_BARS = {"native": 1e-5,   # PERF.md §2's transform bar
              "bf16": 0.05,     # the engine's default precision_max_err
              "int8": 0.05}


def serve_rows(rng, n):
    """n float32 rows with bench.py's 1/(1+j) column variances
    (bench.py:210)."""
    scale = ((1.0 + np.arange(N_FEATURES)) ** -0.5).astype(np.float32)
    return rng.standard_normal((int(n), N_FEATURES), dtype=np.float32) * scale


@functools.lru_cache(maxsize=1)
def serve_traffic():
    """Phase 5's binary requests, made once and sent to every ladder (and
    again in phases 8 and 9): row counts log-uniform over 1…1024 from
    SEED."""
    rng = np.random.default_rng(SEED)
    sizes = np.exp(rng.uniform(0.0, np.log(SERVE_MAX_ROWS + 1),
                               SERVE_REQUESTS))
    sizes = np.clip(np.floor(sizes), 1, SERVE_MAX_ROWS).astype(int)
    return [serve_rows(rng, n) for n in sizes]


def json_body(rows) -> bytes:
    """A JSON predict body; '%.9g' carries every float32 exactly."""
    import io

    text = io.StringIO()
    np.savetxt(text, rows, fmt="%.9g", delimiter=",", newline="],[")
    return ('{"model": "pca", "rows": [[' + text.getvalue()[:-3]
            + "]]}").encode()


def metric_sum(snapshot, name, **match) -> float:
    """Sum of a counter family's samples whose labels match."""
    family = snapshot.get(name, {"samples": []})
    return sum(s["value"] for s in family["samples"]
               if all(s["labels"].get(k) == v for k, v in match.items()))


SERVE_COUNTERS = {
    "ok": ("sparkml_serve_requests_total", {"outcome": "ok"}),
    "batches": ("sparkml_serve_batches_total", {}),
    "batch_rows": ("sparkml_serve_batch_rows_total", {}),
    "bucket_rows": ("sparkml_serve_bucket_rows_total", {}),
    "errors": ("sparkml_serve_errors_total", {}),
    "serving_program": ("sparkml_serve_errors_total",
                        {"error": "serving_program"}),
    "degraded": ("sparkml_serve_degraded_total", {}),
    "retries": ("sparkml_serve_retries_total", {}),
    "runs_cuda": ("sparkml_serve_program_runs_total", {"device": "cuda"}),
    "runs_cpu": ("sparkml_serve_program_runs_total", {"device": "cpu"}),
}


def serve_counters(registry) -> dict:
    snap = registry.snapshot()
    return {key: metric_sum(snap, name, **match)
            for key, (name, match) in SERVE_COUNTERS.items()}


def http_clients(port, bodies):
    """Send ``bodies`` [(index, body, content type)] from SERVE_CLIENTS
    threads, each on one keep-alive connection. Returns ({index: (seconds,
    status, content type, response bytes)}, wall seconds)."""
    import http.client
    import threading

    results, failures = {}, []

    def client(mine):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i, body, ctype in mine:
                t0 = time.perf_counter()
                conn.request("POST", "/predict", body=body,
                             headers={"Content-Type": ctype})
                resp = conn.getresponse()
                data = resp.read()
                results[i] = (time.perf_counter() - t0, resp.status, ctype,
                              data)
        except Exception as exc:  # noqa: BLE001 - reported by the caller
            failures.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=client,
                                args=(bodies[t::SERVE_CLIENTS],))
               for t in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not failures and not any(t.is_alive() for t in threads),
          f"HTTP clients failed: {failures[:3]}")
    return results, wall


def predict_loop(engine, rows, iters) -> tuple:
    """(mean ms, p50 ms) of ``iters`` engine.predict calls, host clock."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        engine.predict("pca", rows)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times)), float(np.median(times))


def warm_engine(registry, precision, label):
    """A warmed engine at ``precision``; prints the offline max-error
    check of a reduced ladder, which must end in a verdict (a crashed
    check fails the smoke) and must pass for bf16. Returns (engine, the
    precision it serves)."""
    from spark_rapids_ml_tpu_torch.serve import ServeEngine

    engine = ServeEngine(registry, max_batch_rows=SERVE_MAX_ROWS,
                         pipeline_depth=2, precision=precision)
    t0 = time.perf_counter()
    report = engine.warmup("pca")
    serving = engine.stats()["queues"]["pca@1"]["precision"]
    log(f"  {label}: warmup {time.perf_counter() - t0:.2f} s over buckets "
        f"{sorted(report['buckets'])}, serving precision {serving}")
    if precision != "native":
        checked = engine.precision_checks[("pca", 1, precision)]
        log(f"  {label}: offline max-error check (seeded standard-normal "
            f"batch at the top bucket): error {checked['error']:.4e}, "
            f"verdict {checked['verdict']} (bar {checked['bar']:g})")
        check(checked["verdict"] in ("pass", "fail"),
              f"{label}: the offline check ended {checked['verdict']}")
        # bf16 keeps 8 bits of every operand: a refusal at 0.05 means a
        # wrong product, not this model's spectrum
        check(precision != "bf16" or checked["verdict"] == "pass",
              f"{label} refused by its offline check")
        want = precision if checked["verdict"] == "pass" else "native"
        check(serving == want, f"{label} serves {serving}, expected {want}")
    return engine, serving


def check_responses(label, results, traffic, refs, bar):
    """Decode every HTTP response and hold it to its float64 reference.
    Returns (worst max|Δ|/max|ref|, client latencies in ms)."""
    from spark_rapids_ml_tpu_torch.serve import wire

    worst, latencies = 0.0, []
    for i, (seconds, status, ctype, data) in sorted(results.items()):
        check(status == 200, f"{label} request {i}: HTTP {status} "
              f"{data[:200]!r}")
        if ctype == wire.BINARY_CONTENT_TYPE:
            out = wire.decode_response(data)
        else:
            out = np.asarray(json.loads(data)["outputs"])
        check(out.shape == (traffic[i].shape[0], K) and np.isfinite(out).all(),
              f"{label} request {i}: shape {out.shape}")
        worst = max(worst, relative_error(out, refs[i]))
        latencies.append(seconds * 1e3)
    check(worst <= bar, f"{label} responses outside the bar {bar:g}: "
          f"{worst:.3e}")
    return worst, np.asarray(latencies)


def relative_error(out, ref) -> float:
    """max |Δ| / max |ref| of one response."""
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def serve_ladder(registry, precision, traffic, bodies, refs, metrics,
                 device):
    """One ladder: warm an engine, drive the binary traffic and then the
    JSON requests over HTTP, check every response and the counters, print
    the measurements (the serving numbers are the binary pass's).

    A reduced ladder whose offline check refuses it at the engine's bar
    (``precision_max_err`` 0.05) serves native, as the engine promises:
    the fallback must be counted and the responses are held to the native
    bar. The int8 program is then held against its CPU twin on the card
    (``int8_against_cpu``) whether or not it serves. Returns the binary
    pass's requests/s."""
    from spark_rapids_ml_tpu_torch.serve import start_serve_server

    start = serve_counters(metrics)
    fallback = ("sparkml_serve_precision_fallback_total",
                {"precision": precision})
    before = metric_sum(metrics.snapshot(), fallback[0], **fallback[1])
    engine, serving = warm_engine(registry, precision, precision)
    if serving != precision:
        moved = metric_sum(metrics.snapshot(), fallback[0],
                           **fallback[1]) - before
        log(f"  {precision}: refused by the offline check, the ladder "
            f"serves native (precision fallback counter +{moved:.0f}); its "
            f"responses are held to the native bar")
        check(moved == 1, f"{precision} fallback counted {moved}")
    bar = SERVE_BARS[serving]
    server = None
    try:
        server = start_serve_server(engine, port=0, addr="127.0.0.1")
        port = server.server_address[1]
        before = serve_counters(metrics)
        results, wall = http_clients(port, bodies["binary"])
        after = serve_counters(metrics)
        delta = {k: after[k] - before[k] for k in after}
        check(len(results) == SERVE_REQUESTS,
              f"{precision}: {len(results)} binary responses")
        worst, lat = check_responses(f"{precision} binary", results, traffic,
                                     refs, bar)
        total_rows = sum(r.shape[0] for r in traffic)
        rps = SERVE_REQUESTS / wall
        log(f"  {precision}: {SERVE_REQUESTS} binary requests ({total_rows} "
            f"rows) in {wall:.3f} s: {SERVE_REQUESTS / wall:.1f} "
            f"requests/s, {total_rows / wall:.0f} rows/s; client latency "
            f"p50 {np.percentile(lat, 50):.2f} ms, p99 "
            f"{np.percentile(lat, 99):.2f} ms; {delta['batches']:.0f} "
            f"batches, {delta['batch_rows'] / max(delta['batches'], 1):.1f} "
            f"rows per batch, padding waste "
            f"{1 - delta['batch_rows'] / max(delta['bucket_rows'], 1):.4f}; "
            f"worst max|Δ|/max|ref| {worst:.3e} (bar {bar:g})")

        results, wall = http_clients(port, bodies["json"])
        check(len(results) == SERVE_JSON_REQUESTS,
              f"{precision}: {len(results)} JSON responses")
        worst, lat = check_responses(f"{precision} JSON", results, traffic,
                                     refs, bar)
        log(f"  {precision}: {SERVE_JSON_REQUESTS} JSON requests of at most "
            f"{SERVE_JSON_MAX_ROWS} rows in {wall:.3f} s: client latency p50 "
            f"{np.percentile(lat, 50):.2f} ms, p99 "
            f"{np.percentile(lat, 99):.2f} ms; worst max|Δ|/max|ref| "
            f"{worst:.3e}")
        after = serve_counters(metrics)
        delta = {k: after[k] - before[k] for k in after}
        log(f"  {precision}: counters over both passes {delta}")
        check(delta["ok"] == SERVE_REQUESTS + SERVE_JSON_REQUESTS,
              f"{precision} ok {delta['ok']}")
        check(delta["batches"] > 0 and delta["runs_cuda"] == delta["batches"],
              f"{precision}: {delta['runs_cuda']} program runs on cuda for "
              f"{delta['batches']} batches")

        rng = np.random.default_rng(SEED + 7)
        for n, iters in ((1, 50), (64, 50), (1024, 20)):
            mean, p50 = predict_loop(engine, serve_rows(rng, n), iters)
            log(f"  {precision}: engine.predict {n} rows x {iters}: mean "
                f"{mean:.3f} ms, p50 {p50:.3f} ms")
        if precision == "native":
            compare_4096(engine, registry.resolve("pca"))
        end = serve_counters(metrics)
        moved = {key: end[key] - start[key] for key in (
            "errors", "serving_program", "degraded", "retries", "runs_cpu")}
        log(f"  {precision}: over the whole ladder (warmup, traffic, "
            f"predict loops{', 4096 rows' if precision == 'native' else ''})"
            f": {moved}")
        for key, value in moved.items():
            check(value == 0, f"{precision}: {key} moved by {value}")
        if precision == "int8":
            # after the counters: its CPU twin counts runs on the cpu
            int8_against_cpu(registry.resolve("pca"), traffic, refs, device)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.shutdown()
    return rps


def int8_against_cpu(model, traffic, refs, device):
    """The int8 program on the card against the same program on the CPU,
    bit for bit (int32 sums are exact, the rescale is one f32 product),
    on every shape the traffic gives it: each request alone at its bucket,
    the requests coalesced in order up to 1024 rows as the engine batches
    them (one quantization scale per batch), and the offline check's own
    batch. Prints each response's error against the float64 product in
    both layouts."""
    import torch
    from spark_rapids_ml_tpu_torch.utils.padding import pad_to_bucket

    card = model.serving_transform_program("int8")
    plain = model.serving_transform_program("int8",
                                            device=torch.device("cpu"))
    check(card.device == device and plain.device.type == "cpu",
          f"int8 programs on {card.device} and {plain.device}")
    buckets = set()

    def on_both(rows):
        padded, n = pad_to_bucket(rows)
        got = card.fetch(card.run(card.put(padded)))
        want = plain.fetch(plain.run(plain.put(padded)))
        check(np.array_equal(got, want), f"int8 on the card differs from "
              f"its CPU twin at bucket {padded.shape[0]}: max |Δ| "
              f"{np.abs(got - want).max():.3e}")
        buckets.add(padded.shape[0])
        return got[:n]

    alone = [relative_error(on_both(rows), ref)
             for rows, ref in zip(traffic, refs)]
    groups, group, rows_in = [], [], 0
    for i, rows in enumerate(traffic):
        if group and rows_in + rows.shape[0] > SERVE_MAX_ROWS:
            groups.append(group)
            group, rows_in = [], 0
        group.append(i)
        rows_in += rows.shape[0]
    groups.append(group)
    coalesced = []
    for group in groups:
        out = on_both(np.concatenate([traffic[i] for i in group]))
        edges = np.cumsum([0] + [traffic[i].shape[0] for i in group])
        coalesced += [relative_error(out[lo:hi], refs[i])
                      for i, lo, hi in zip(group, edges[:-1], edges[1:])]
    # the batch of the engine's _precision_ok
    on_both(np.random.default_rng(7).standard_normal(
        (SERVE_MAX_ROWS, N_FEATURES)).astype(np.float32))
    log(f"  int8 program on the card = its CPU twin bit for bit on "
        f"{len(traffic) + len(groups) + 1} batches, buckets {sorted(buckets)}")
    for label, errors in (("each request alone", alone),
                          (f"coalesced into {len(groups)} batches",
                           coalesced)):
        errors = np.asarray(errors)
        log(f"  int8 program, {label}: max|Δ|/max|ref| per response median "
            f"{np.median(errors):.3e}, p90 {np.percentile(errors, 90):.3e}, "
            f"worst {errors.max():.3e}; "
            f"{int((errors > SERVE_BARS['int8']).sum())} of {len(errors)} "
            f"above {SERVE_BARS['int8']:g}")


def compare_4096(engine, model):
    """4096 rows through the engine (four 1024-row requests at once,
    several batches) beside PCAModel.transform on the same rows."""
    from concurrent.futures import ThreadPoolExecutor

    rows = serve_rows(np.random.default_rng(SEED + 99), 4096)
    ref = rows.astype(np.float64) @ model.pc
    parts = np.split(rows, 4096 // SERVE_MAX_ROWS)
    engine_ms, transform_ms = [], []
    with ThreadPoolExecutor(len(parts)) as pool:
        for _ in range(5):
            t0 = time.perf_counter()
            out = np.concatenate(list(pool.map(
                lambda p: engine.predict("pca", p), parts)))
            engine_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            direct = np.asarray(model.transform(rows).column("pca_features"))
            transform_ms.append((time.perf_counter() - t0) * 1e3)
    for label, got in (("engine", out), ("transform", direct)):
        err = np.abs(got - ref).max() / np.abs(ref).max()
        check(err <= SERVE_BARS["native"], f"4096 rows {label} err {err:.3e}")
    log(f"  4096 rows: engine (4 x 1024 at once) median "
        f"{np.median(engine_ms):.2f} ms {[round(t, 2) for t in engine_ms]}; "
        f"PCAModel.transform median {np.median(transform_ms):.2f} ms "
        f"{[round(t, 2) for t in transform_ms]}")


def phase_serve(torch, model, device):
    """Phase 5: serve ``model`` per ladder over HTTP under the TF32 trap.
    Returns each ladder's binary requests/s."""
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.serve import ModelRegistry
    from spark_rapids_ml_tpu_torch.serve import wire

    t0 = time.perf_counter()
    traffic = serve_traffic()
    small = [i for i, rows in enumerate(traffic)
             if rows.shape[0] <= SERVE_JSON_MAX_ROWS][:SERVE_JSON_REQUESTS]
    check(len(small) == SERVE_JSON_REQUESTS,
          f"only {len(small)} requests of at most {SERVE_JSON_MAX_ROWS} rows")
    bodies = {
        "binary": [(i, wire.encode_request("pca", rows),
                    wire.BINARY_CONTENT_TYPE)
                   for i, rows in enumerate(traffic)],
        "json": [(i, json_body(traffic[i]), wire.JSON_CONTENT_TYPE)
                 for i in small],
    }
    refs = [rows.astype(np.float64) @ model.pc for rows in traffic]
    sizes = [r.shape[0] for r in traffic]
    log(f"  traffic: {len(traffic)} binary requests, rows min {min(sizes)} "
        f"median {int(np.median(sizes))} max {max(sizes)}, total "
        f"{sum(sizes)}; JSON: {len(small)} of them, "
        f"{sum(sizes[i] for i in small)} rows; made and encoded in "
        f"{time.perf_counter() - t0:.1f} s")
    registry = ModelRegistry()
    registry.register("pca", model)
    torch.set_float32_matmul_precision("high")
    try:
        check(torch.backends.cuda.matmul.allow_tf32 or device.type != "cuda",
              "the TF32 trap is not set")
        rows = serve_rows(np.random.default_rng(SEED + 5), SERVE_MAX_ROWS)
        ref = rows.astype(np.float64) @ model.pc
        pc32 = torch.as_tensor(model.pc, dtype=torch.float32, device=device)
        tf32 = (torch.as_tensor(rows, device=device) @ pc32).double()
        err = np.abs(tf32.cpu().numpy() - ref).max() / np.abs(ref).max()
        log(f"  TF32 trap set (allow_tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32}): a plain float32 "
            f"product of 1024 rows is off by {err:.3e} (native bar "
            f"{SERVE_BARS['native']:g})")
        check(err > SERVE_BARS["native"] or device.type != "cuda",
              "the TF32 trap does not bite: the native check proves nothing")
        metrics = get_registry()
        return {precision: serve_ladder(registry, precision, traffic, bodies,
                                        refs, metrics, device)
                for precision in SERVE_LADDERS}
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False


# -- phase 6: multi-tenant serving ----------------------------------------------

MT_SECONDS = 8.0
MT_QUEUE_DEPTH = 8
MT_GREEDY = {"clients": 8, "rows": 512, "priority": "batch",
             "quota": (2000.0, 4000.0)}          # rows/s, burst
MT_COMPLIANT = {"clients": 2, "rows": 64, "priority": "interactive",
                "rate": 20.0}                    # requests/s per client
MT_SHED = {"queue_wait_target_s": 0.020, "depth_frac_target": 0.25}
MT_POOL = {"greedy": 16, "compliant": 32}        # distinct bodies per tenant
MT_KILL_SWITCHES = {"SPARK_RAPIDS_ML_TORCH_SERVE_SCHED": "fifo",
                    "SPARK_RAPIDS_ML_TORCH_SERVE_SHED": "0"}
MT_COUNTERS = {
    "batches": ("sparkml_serve_batches_total", {}),
    "errors": ("sparkml_serve_errors_total", {}),
    "load_shed": ("sparkml_serve_errors_total", {"error": "load_shed"}),
    "degraded": ("sparkml_serve_degraded_total", {}),
    "retries": ("sparkml_serve_retries_total", {}),
    "runs_cuda": ("sparkml_serve_program_runs_total", {"device": "cuda"}),
    "runs_cpu": ("sparkml_serve_program_runs_total", {"device": "cpu"}),
    "shed_compliant": ("sparkml_serve_shed_total", {"tenant": "compliant"}),
    "shed_greedy": ("sparkml_serve_shed_total", {"tenant": "greedy"}),
    "shed_over_quota": ("sparkml_serve_shed_total",
                        {"tenant": "greedy", "reason": "over_quota"}),
    "shed_over_quota_batch": ("sparkml_serve_shed_total",
                              {"tenant": "greedy",
                               "reason": "over_quota_batch"}),
    "shed_preempted": ("sparkml_serve_shed_total",
                       {"tenant": "greedy", "reason": "preempted"}),
}


def mt_counters(registry) -> dict:
    """MT_COUNTERS, plus the server's (count, seconds) of POST /predict
    handling per HTTP status (``http_<status>``), so a run's mean server
    time per reply kind is a difference of two reads."""
    snap = registry.snapshot()
    out = {key: metric_sum(snap, name, **match)
           for key, (name, match) in MT_COUNTERS.items()}
    family = snap.get("sparkml_http_request_latency_seconds",
                      {"samples": []})
    for sample in family["samples"]:
        if sample["labels"]["path"] == "/predict":
            out["http_" + sample["labels"]["status"]] = np.array(
                [sample["count"], sample["sum"]])
    return out


def mt_traffic(model):
    """Per tenant, a pool of binary request bodies made from SEED, cycled
    by the clients, and each body's float64 host product."""
    from spark_rapids_ml_tpu_torch.serve import wire

    rng = np.random.default_rng(SEED + 6)
    pools = {}
    for tenant, spec in (("greedy", MT_GREEDY), ("compliant", MT_COMPLIANT)):
        rows = [serve_rows(rng, spec["rows"]) for _ in range(MT_POOL[tenant])]
        pools[tenant] = [(wire.encode_request("pca", r),
                          r.astype(np.float64) @ model.pc) for r in rows]
    return pools


def mt_client(port, tenant, spec, bodies, offset, t_end, records, failures,
              content_type):
    """One client on one keep-alive connection: the compliant tenant's
    requests paced at spec["rate"] per second, the greedy tenant's back to
    back, until t_end. Appends (seconds, status, headers, body, ref index)
    per response, and what it raised, if anything, to ``failures``."""
    import http.client

    headers = {"Content-Type": content_type,
               "X-Tenant": tenant, "X-Priority": spec["priority"]}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t_start, sent = time.perf_counter(), 0
    try:
        while True:
            if "rate" in spec:
                due = t_start + sent / spec["rate"]
                if due >= t_end:
                    break
                time.sleep(max(due - time.perf_counter(), 0.0))
            elif time.perf_counter() >= t_end:
                break
            index = (offset + sent) % len(bodies)
            t0 = time.perf_counter()
            conn.request("POST", "/predict", body=bodies[index],
                         headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            records.append((time.perf_counter() - t0, resp.status,
                            {k.lower(): v for k, v in resp.getheaders()},
                            data, index))
            sent += 1
    except Exception as exc:  # noqa: BLE001 - reported by the caller
        failures.append(f"{tenant}: {exc!r}")
    finally:
        conn.close()


def mt_tenant_process(port, tenant, spec, bodies, content_type, start,
                      out_path):
    """A child process holding one tenant's clients, so that the load
    generator's Python work (sending 8 MiB bodies, reading replies) runs
    under its own GIL and not the server's. Waits on the ``start``
    barrier, runs spec["clients"] client threads for MT_SECONDS, and
    pickles (records, failures, wall seconds) to ``out_path``."""
    import pickle
    import threading

    records, failures = [], []
    start.wait(timeout=120)
    t0 = time.perf_counter()
    t_end = t0 + MT_SECONDS
    threads = [threading.Thread(
        target=mt_client, daemon=True,
        args=(port, tenant, spec, bodies, c * (len(bodies) // spec["clients"]),
              t_end, records, failures, content_type))
        for c in range(spec["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        failures.append(f"{tenant}: a client did not finish")
    with open(out_path, "wb") as f:
        pickle.dump((records, failures, time.perf_counter() - t0), f)


def mt_check_responses(label, tenant, records, pool, strict):
    """Hold every 200 to the native bar; with ``strict`` (run B), every
    other reply must be a 503 shed or a 429, each with Retry-After >= 1.
    Returns the tenant's summary."""
    from spark_rapids_ml_tpu_torch.serve import wire

    worst, lat_ok, lat_shed, rows_ok = 0.0, [], [], 0
    counts = {"200": 0, "429": 0, "503": 0, "503_shed": 0, "other": 0}
    for seconds, status, headers, data, index in records:
        if status == 200:
            out = wire.decode_response(data)
            ref = pool[index][1]
            check(out.shape == ref.shape and np.isfinite(out).all(),
                  f"{label} {tenant}: shape {out.shape}")
            worst = max(worst, relative_error(out, ref))
            lat_ok.append(seconds * 1e3)
            rows_ok += out.shape[0]
            counts["200"] += 1
            continue
        doc = json.loads(data)
        retry_after = int(headers.get("retry-after", "0"))
        if status == 503 and doc.get("shed") is True:
            counts["503_shed"] += 1
            counts["503"] += 1
            lat_shed.append(seconds * 1e3)
            check(retry_after >= 1, f"{label} {tenant}: shed 503 with "
                  f"Retry-After {retry_after}")
        elif status == 429:
            counts["429"] += 1
            check(retry_after >= 1, f"{label} {tenant}: 429 with "
                  f"Retry-After {retry_after}")
        else:
            counts["other"] += 1
            check(not strict, f"{label} {tenant}: HTTP {status} {doc}")
    check(worst <= SERVE_BARS["native"], f"{label} {tenant}: responses "
          f"outside the native bar: {worst:.3e}")
    lat = np.asarray(lat_ok) if lat_ok else np.asarray([np.nan])
    shed = np.asarray(lat_shed) if lat_shed else np.asarray([np.nan])
    return {"requests": len(records), **counts, "rows_ok": rows_ok,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "shed_p50_ms": float(np.percentile(shed, 50)),
            "shed_p99_ms": float(np.percentile(shed, 99)), "worst": worst}


def mt_run(label, registry, pools, tenants, kill_switches=False):
    """One run of phase 6: a fresh engine (the constructor's admission and
    scheduler, or with the kill switches set in the environment), the
    tenants' clients for MT_SECONDS over HTTP, each tenant's clients in a
    child process of their own, and a sampler of the shed level and the
    queue-wait estimate. Returns (engine, server, per-tenant summaries,
    counter deltas, samples, wall seconds)."""
    import multiprocessing
    import pickle
    import threading

    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.serve import (
        ServeEngine,
        ShedController,
        start_serve_server,
        wire,
    )

    saved = {k: os.environ.get(k) for k in MT_KILL_SWITCHES}
    if kill_switches:
        os.environ.update(MT_KILL_SWITCHES)
    try:
        kwargs = dict(
            max_queue_depth=MT_QUEUE_DEPTH, max_batch_rows=SERVE_MAX_ROWS,
            max_wait_ms=5.0, pipeline_depth=2, precision="native",
            tenant_quotas={"greedy": MT_GREEDY["quota"]},
            tenant_weights={"greedy": 1.0, "compliant": 1.0})
        if not kill_switches:
            kwargs.update(fair_scheduling=True,
                          shed=ShedController(**MT_SHED))
        engine = ServeEngine(registry, **kwargs)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(engine.fair_scheduling == (not kill_switches)
          and engine.admission.shed.enabled == (not kill_switches),
          f"{label}: fair {engine.fair_scheduling}, shed "
          f"{engine.admission.shed.enabled}")
    engine.warmup("pca")
    server = start_serve_server(engine, port=0, addr="127.0.0.1")
    metrics = get_registry()
    batcher = engine._batchers[("pca", 1)]
    samples = {"level": 0, "wait": 0.0, "stop": threading.Event()}

    def sampler():
        while not samples["stop"].wait(0.02):
            samples["level"] = max(samples["level"],
                                   engine.admission.shed.level())
            samples["wait"] = max(samples["wait"],
                                  batcher.queue_wait_estimate())

    ctx = multiprocessing.get_context("spawn")
    start = ctx.Barrier(len(tenants) + 1)
    port = server.server_address[1]
    records, failures, walls = {}, [], []
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for tenant in tenants:
            spec = MT_GREEDY if tenant == "greedy" else MT_COMPLIANT
            procs[tenant] = ctx.Process(
                target=mt_tenant_process, daemon=True,
                args=(port, tenant, spec, [b for b, _ in pools[tenant]],
                      wire.BINARY_CONTENT_TYPE, start,
                      os.path.join(tmp, tenant + ".pkl")))
        try:
            for proc in procs.values():
                proc.start()
            before = mt_counters(metrics)
            sampler_thread = threading.Thread(target=sampler, daemon=True)
            sampler_thread.start()
            start.wait(timeout=120)
            for proc in procs.values():
                proc.join(timeout=MT_SECONDS + 300)
        finally:
            for proc in procs.values():
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        samples["stop"].set()
        sampler_thread.join(timeout=5)
        after = mt_counters(metrics)
        for tenant, proc in procs.items():
            check(proc.exitcode == 0,
                  f"{label}: {tenant}'s clients exited {proc.exitcode}")
            with open(os.path.join(tmp, tenant + ".pkl"), "rb") as f:
                records[tenant], failed, wall = pickle.load(f)
            failures += failed
            walls.append(wall)
    check(not failures, f"{label}: clients failed: {failures[:3]}")
    wall = max(walls)
    delta = {k: after[k] - before.get(k, 0) for k in after}
    summaries = {t: mt_check_responses(label, t, records[t], pools[t],
                                       strict=label.startswith("(B)"))
                 for t in tenants}
    for tenant, s in summaries.items():
        log(f"  {label} {tenant}: {s['requests']} requests, 200 "
            f"{s['200']}, 429 {s['429']}, 503 {s['503']} (shed "
            f"{s['503_shed']}), other {s['other']}; "
            f"{s['rows_ok'] / wall:.0f} rows/s served; client latency of "
            f"the 200s p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms"
            f"{'' if not s['503_shed'] else ', of the shed 503s p50 %.2f ms, p99 %.2f ms' % (s['shed_p50_ms'], s['shed_p99_ms'])}; "
            f"worst max|Δ|/max|ref| {s['worst']:.3e}")
    split = ", ".join(
        f"{key[5:]}: {int(v[0])} replies, mean {v[1] / v[0] * 1e3:.2f} ms"
        for key, v in sorted(delta.items())
        if key.startswith("http_") and v[0] > 0)
    log(f"  {label}: server time per POST /predict reply by status "
        f"({split})")
    log(f"  {label}: {wall:.2f} s; highest shed level {samples['level']}, "
        f"peak queue-wait estimate {samples['wait'] * 1e3:.2f} ms; sheds "
        f"by reason: over_quota {delta['shed_over_quota']:.0f}, "
        f"over_quota_batch {delta['shed_over_quota_batch']:.0f}, "
        f"preempted {delta['shed_preempted']:.0f}; batches "
        f"{delta['batches']:.0f}, program runs on cuda "
        f"{delta['runs_cuda']:.0f}")
    return engine, server, summaries, delta, samples, wall


def mt_readyz_recovery(engine, server) -> float:
    """Seconds until /readyz answers 200 again, probing every 50 ms with
    no predict traffic."""
    import http.client

    shed = engine.admission.shed
    budget = shed.hold_seconds + 2.0
    t0 = time.perf_counter()
    statuses = []
    while True:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=30)
        try:
            conn.request("GET", "/readyz")
            resp = conn.getresponse()
            resp.read()
            statuses.append(resp.status)
        finally:
            conn.close()
        elapsed = time.perf_counter() - t0
        if statuses[-1] == 200 or elapsed > budget + 5.0:
            break
        time.sleep(0.05)
    log(f"  (B): /readyz {statuses[0]} when the flood stopped, 200 after "
        f"{elapsed:.2f} s of probes alone (hold {shed.hold_seconds:g} s, "
        f"bar {budget:g} s); signals then {shed.snapshot()['signals']}")
    check(statuses[-1] == 200 and elapsed <= budget,
          f"/readyz not back to 200 within {budget:g} s: {statuses[-5:]}")
    return elapsed


def phase_multitenant(torch, model, device):
    """Phase 6: multi-tenant serving of ``model`` over HTTP."""
    from spark_rapids_ml_tpu_torch.serve import ModelRegistry

    t0 = time.perf_counter()
    pools = mt_traffic(model)
    log(f"  traffic pools: {MT_POOL['greedy']} greedy bodies of "
        f"{MT_GREEDY['rows']} rows, {MT_POOL['compliant']} compliant "
        f"bodies of {MT_COMPLIANT['rows']} rows, made in "
        f"{time.perf_counter() - t0:.2f} s")
    registry = ModelRegistry()
    registry.register("pca", model)
    p99 = {}
    torch.set_float32_matmul_precision("high")
    try:
        for label, tenants, kill in (
                ("(A) compliant alone", ("compliant",), False),
                ("(B) both, fair + shed", ("compliant", "greedy"), False),
                ("(C) both, kill switches", ("compliant", "greedy"), True)):
            engine, server, summaries, delta, samples, _ = mt_run(
                label, registry, pools, tenants, kill_switches=kill)
            try:
                p99[label[:3]] = summaries["compliant"]["p99_ms"]
                for key in ("degraded", "retries", "runs_cpu"):
                    check(delta[key] == 0, f"{label}: {key} moved by "
                          f"{delta[key]}")
                check(delta["runs_cuda"] == delta["batches"] > 0,
                      f"{label}: {delta['runs_cuda']} cuda runs for "
                      f"{delta['batches']} batches")
                if label.startswith("(B)"):
                    compliant, greedy = (summaries["compliant"],
                                         summaries["greedy"])
                    check(compliant["200"] == compliant["requests"] > 0,
                          f"(B) compliant availability {compliant}")
                    check(greedy["503_shed"] > 0, "(B) greedy never shed")
                    check(greedy["other"] == 0 and compliant["other"] == 0,
                          "(B) replies other than 200, 503 shed and 429")
                    check(delta["shed_compliant"] == 0,
                          f"(B) compliant shed {delta['shed_compliant']}")
                    check(delta["shed_greedy"] == greedy["503_shed"],
                          f"(B) shed counter {delta['shed_greedy']} vs "
                          f"{greedy['503_shed']} shed 503s")
                    check(delta["load_shed"] == greedy["503_shed"]
                          and delta["errors"] == delta["load_shed"],
                          f"(B) errors {delta['errors']}, load_shed "
                          f"{delta['load_shed']}")
                    mt_readyz_recovery(engine, server)
                else:
                    check(delta["errors"] == delta["load_shed"] == 0,
                          f"{label}: errors {delta['errors']}")
            finally:
                server.shutdown()
                server.server_close()
                engine.shutdown()
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  compliant p99 (host clock, not asserted): (A) "
        f"{p99['(A)']:.2f} ms, (B) {p99['(B)']:.2f} ms, (C) "
        f"{p99['(C)']:.2f} ms; phase 6 {time.perf_counter() - t0:.1f} s")


# -- phase 7: PCA across ranks ---------------------------------------------------

MEAN_RTOL = 1e-5  # max |Δ| / max |mean| against fit (a)'s mean


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def compare_to_fit_a(label, result, model_a):
    """A sharded fit against fit (a)'s model at PERF.md §2's bar."""
    pc = result.components.cpu().numpy()
    evr = result.explained_variance.cpu().numpy()
    mean = result.mean.cpu().numpy()
    check(pc.shape == (N_FEATURES, K) and np.isfinite(pc).all()
          and np.isfinite(evr).all() and np.isfinite(mean).all(),
          f"{label}: components {pc.shape}, finite")
    cos = np.abs(np.sum(model_a.pc * pc, axis=0))
    evr_rel = np.abs(evr - model_a.explained_variance) / np.abs(
        model_a.explained_variance)
    mean_rel = np.abs(mean - model_a.mean).max() / np.abs(model_a.mean).max()
    log(f"    vs fit (a): |cos| min over top {TOP_COMPONENTS} "
        f"{cos[:TOP_COMPONENTS].min():.6f} (bar {COS_BAR}), over all {K} "
        f"{cos.min():.6f}; EVR max rel err top {TOP_COMPONENTS} "
        f"{evr_rel[:TOP_COMPONENTS].max():.3e} (bar {EVR_RTOL:g}); mean "
        f"rel err {mean_rel:.3e} (bar {MEAN_RTOL:g})")
    check(cos[:TOP_COMPONENTS].min() >= COS_BAR, f"{label} component |cos|")
    check(evr_rel[:TOP_COMPONENTS].max() <= EVR_RTOL, f"{label} EVR")
    check(mean_rel <= MEAN_RTOL, f"{label} mean")


def whole_shard_kernel(torch, fg, x_dev):
    """The kernel on a rank's whole shard (fit (a)'s rows, bfloat16_3x, the
    default precision) against its plain version and float64, timed beside
    the ``torch.matmul`` yardstick and its bound, as phase 3 does, and
    beside the same rows as bucket launches summed."""
    precision = "bfloat16_3x"
    name, operand, passes = PRECISIONS[precision]
    rows, n = x_dev.shape
    mean = x_dev.mean(0)
    rowmul = torch.full((rows,), (rows - 1) ** -0.5, device=x_dev.device)
    got = fg.fused_centered_gram(x_dev, mean, rowmul, precision)
    torch.cuda.synchronize()
    want = fg.fused_centered_gram_reference(x_dev, mean, rowmul, precision)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    xc = (x_dev - mean) * rowmul[:, None]
    xc64 = xc.double()
    truth = xc64.T @ xc64
    del xc64
    k_true = (got.double() - truth).abs().max().item() / scale
    p_true = (want.double() - truth).abs().max().item() / scale
    del truth, want
    log(f"  {name} whole shard {rows}x{n}: max_abs_err {err:.3e} rel "
        f"{err / scale:.3e} (bar {fg.PLAIN_RTOL[name]:g}); vs float64: kernel "
        f"{k_true:.3e}, plain {p_true:.3e}")
    check(bool(torch.isfinite(got).all()) and bool(torch.equal(got, got.T)),
          "whole-shard Gram finite and symmetric")
    check(err <= fg.PLAIN_RTOL[name] * scale,
          f"whole-shard kernel vs plain {err / scale:.3e}")
    ms = time_ms(torch, lambda: fg.fused_centered_gram(
        x_dev, mean, rowmul, precision), iters=5, warmup=1)
    plain_ms = time_ms(torch, lambda: fg.fused_centered_gram_reference(
        x_dev, mean, rowmul, precision), iters=1, warmup=1)
    library_ms = time_ms(torch, lambda: torch.matmul(xc.T, xc), iters=3,
                         warmup=1)

    def bucketed():
        g = fg.fused_centered_gram(x_dev[:BUCKET_ROWS], mean,
                                   rowmul[:BUCKET_ROWS], precision)
        for i in range(BUCKET_ROWS, rows, BUCKET_ROWS):
            g += fg.fused_centered_gram(x_dev[i:i + BUCKET_ROWS], mean,
                                        rowmul[i:i + BUCKET_ROWS], precision)
        return g

    bucketed_ms = time_ms(torch, bucketed, iters=3, warmup=1)
    bound_ms, bound_by = bound(rows, n, operand, passes)
    log(f"  {name} whole shard {rows}x{n}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.matmul yardstick {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of the "
        f"bound; the same rows as {rows // BUCKET_ROWS} launches of "
        f"{BUCKET_ROWS} rows summed {bucketed_ms:.4f} ms")


def phase_distributed(torch, fg, device, model_a):
    """Phase 7. Returns the default precision's kernel launches and the
    streamed run's host seconds."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.parallel import (
        DistributedStreamingPCA,
        data_mesh,
        distributed_pca_fit,
        feature_sharded_pca_fit,
        grid_mesh,
        initialize_multihost,
    )

    t_phase = time.perf_counter()
    # a one-rank world on this host: NCCL's bootstrap stays on loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    coordinator = f"127.0.0.1:{free_port()}"
    joined = initialize_multihost(coordinator, num_processes=1, process_id=0)
    log(f"  initialize_multihost({coordinator!r}, 1 process): several ranks "
        f"{joined}, backend {dist.get_backend()}, rank {dist.get_rank()} of "
        f"{dist.get_world_size()} on cuda:{torch.cuda.current_device()}")
    check(dist.get_backend() == "nccl", "the card's world runs NCCL")
    kernel = fg.kernel_name(None)
    launched = 0
    walls = {}
    try:
        x = np.concatenate([chunk(torch, device, i) for i in range(4)])
        log(f"  fit (a)'s data, {x.shape[0]:,} x {x.shape[1]} float32, "
            f"k = {K}, default gramPrecision ({kernel})")
        mesh = data_mesh(1)
        grid = grid_mesh(1, 1)

        def streamed():
            acc = DistributedStreamingPCA(N_FEATURES, mesh)
            for i in range(0, x.shape[0], CHUNK_ROWS):
                acc.partial_fit(x[i:i + CHUNK_ROWS])
            check(acc.rows_seen == x.shape[0], "rows seen")
            return acc.finalize(K)

        # label, fit, kernel launches worked out from the code: one per
        # rank's whole-shard Gram, one per streamed chunk, one for the
        # ring's diagonal block, none for the all-gather schedule's product
        runs = (
            ("distributed_pca_fit two pass",
             lambda: distributed_pca_fit(x, K, mesh), 1),
            ("distributed_pca_fit one pass",
             lambda: distributed_pca_fit(x, K, mesh, one_pass=True), 1),
            ("DistributedStreamingPCA, 4 chunks", streamed, 4),
            ("feature_sharded_pca_fit 1x1 ring + eigh",
             lambda: feature_sharded_pca_fit(x, K, grid), 1),
            ("feature_sharded_pca_fit 1x1 all-gather + randomized",
             lambda: feature_sharded_pca_fit(
                 x, K, grid, schedule="allgather", solver="randomized"), 0),
        )
        for label, fit, expected in runs:
            torch.cuda.synchronize()
            fg.reset_launches()
            t0 = time.perf_counter()
            result = fit()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = dict(fg.launches)
            walls[label] = seconds
            log(f"  {label}: {seconds:.2f} s (host clock), launches {counts}")
            check(counts[kernel] == expected and
                  sum(counts.values()) == expected,
                  f"{label}: launches {counts}, expected {expected} of "
                  f"{kernel}")
            launched += counts[kernel]
            compare_to_fit_a(label, result, model_a)
            del result
        x_dev = torch.as_tensor(x, device=device)
        del x
        whole_shard_kernel(torch, fg, x_dev)
        del x_dev
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log(f"  phase 7 {time.perf_counter() - t_phase:.1f} s")
    return launched, walls["DistributedStreamingPCA, 4 chunks"]


# -- phase 8: the debug plane ----------------------------------------------------

DEBUG_SAMPLE_S = 0.1      # the sampler's cadence in this phase
DEBUG_MIN_SWEEPS = 10
DEBUG_SLO_SECTIONS = {"slos", "alerts", "queue_depth", "models", "closed",
                      "breakers", "faults", "degraded_total", "retries_total",
                      "worker_restarts_total", "overload", "tiering"}
DEBUG_UNPORTED = {"replicas", "rollout", "autoscale"}


def http_get_raw(port, path):
    """(status, content type, body bytes) of one GET."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def http_get(port, path):
    """(status, decoded JSON) of one GET."""
    status, _, body = http_get_raw(port, path)
    return status, json.loads(body)


def wait_sweeps(sampler, n, timeout=30.0):
    """Block until the background sampler has swept ``n`` more times."""
    target = sampler.sweeps + n
    end = time.monotonic() + timeout
    while sampler.sweeps < target:
        check(time.monotonic() < end and sampler.running,
              f"the sampler stopped sweeping at {sampler.sweeps}")
        time.sleep(DEBUG_SAMPLE_S / 4)


def quiescent_allocation(torch, sampler):
    """``torch.cuda.memory_allocated(0)`` at a sweep with nothing changing
    on the card: the same reading before and after two sweeps."""
    for _ in range(10):
        before = torch.cuda.memory_allocated(0)
        wait_sweeps(sampler, 2)
        if torch.cuda.memory_allocated(0) == before:
            return before
    check(False, "device memory never settled between two sweeps")


def linked_batch(tree) -> bool:
    """Whether a trace tree holds a batch span grafted in by its links."""
    stack = list(tree["spans"])
    while stack:
        node = stack.pop()
        if node.get("link") and node["name"].startswith("serve:batch:"):
            return True
        stack.extend(node["children"])
    return False


def phase_debug(torch, fg, model, device, phase5_rps):
    """Phase 8: fit (c)'s model on the native ladder behind the HTTP server
    with the history sampler at 100 ms, phase 5's binary traffic, then the
    debug plane read back over HTTP and held to the card. Returns the
    serving busy share (the window's occupancy)."""
    from spark_rapids_ml_tpu_torch.obs import devmon, tsdb
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        start_serve_server,
        wire,
    )

    t_phase = time.perf_counter()
    traffic = serve_traffic()
    bodies = [(i, wire.encode_request("pca", rows), wire.BINARY_CONTENT_TYPE)
              for i, rows in enumerate(traffic)]
    refs = [rows.astype(np.float64) @ model.pc for rows in traffic]
    registry = ModelRegistry()
    registry.register("pca", model)
    metrics = get_registry()
    # a fresh history for this phase (phases 5 and 6 started the sampler
    # at its default cadence)
    tsdb.reset_tsdb()
    overhead = metrics.counter("sparkml_obs_overhead_seconds_total", "",
                               ("component",))
    sampler_s0 = overhead.value(component="sampler")
    sampler = tsdb.start_sampling(interval_seconds=DEBUG_SAMPLE_S)
    t_sampler = time.perf_counter()
    engine, serving = warm_engine(registry, "native", "debug")
    check(serving == "native", f"phase 8 serves {serving}")
    server = start_serve_server(engine, port=0, addr="127.0.0.1")
    port = server.server_address[1]
    label = str(device)

    def counters():
        batch = metrics.counter("sparkml_serve_device_batch_seconds_total",
                                "", ("model", "device"))
        return {
            "batch_s": batch.value(model="pca", device=label),
            "busy_s": metrics.counter(
                "sparkml_serve_device_busy_seconds_total", "",
                ("model",)).value(model="pca"),
        }

    try:
        wait_sweeps(sampler, 1)
        fg.reset_launches()
        before = counters()
        results, wall = http_clients(port, bodies)
        after = counters()
        launched = dict(fg.launches)
        check(len(results) == SERVE_REQUESTS,
              f"phase 8: {len(results)} responses")
        worst, lat = check_responses("debug", results, traffic, refs,
                                     SERVE_BARS["native"])
        rps = SERVE_REQUESTS / wall
        delta = {k: after[k] - before[k] for k in after}
        log(f"  {SERVE_REQUESTS} binary requests in {wall:.3f} s: "
            f"{rps:.1f} requests/s (phase 5 native: "
            f"{phase5_rps['native']:.1f}), client p50 "
            f"{np.percentile(lat, 50):.2f} ms, p99 "
            f"{np.percentile(lat, 99):.2f} ms; worst max|Δ|/max|ref| "
            f"{worst:.3e}")
        log(f"  kernel launches during the traffic: {launched}")
        check(sum(launched.values()) == 0, "phase 8 launched a hand kernel")
        check(after["batch_s"] == after["busy_s"]
              and delta["batch_s"] == delta["busy_s"] > 0,
              f"batch seconds {after['batch_s']!r} (+{delta['batch_s']!r}) "
              f"!= the batcher's busy seconds {after['busy_s']!r} "
              f"(+{delta['busy_s']!r})")
        busy = delta["batch_s"] / wall
        log(f"  serving busy share {busy:.4f}, idle share {1 - busy:.4f} "
            f"(Δ sparkml_serve_device_batch_seconds_total {{device="
            f"\"{label}\"}} {delta['batch_s']:.4f} s over {wall:.3f} s of "
            f"traffic; host-clock union of dispatch to completion, an "
            f"upper bound on device time)")
        log(f"  device occupancy from the history store (rate over 60 s): "
            f"{devmon.get_device_monitor().occupancy(window=60.0)}")

        allocated = quiescent_allocation(torch, sampler)
        status, doc = http_get(
            port, "/debug/history?name=sparkml_device_mem_bytes_in_use")
        series = {tuple(sorted(s["labels"].items())): s["points"]
                  for s in doc["series"]}
        key = (("device", label), ("source", "cuda"))
        check(status == 200 and key in series,
              f"/debug/history has no {dict(key)} series: {list(series)}")
        last = series[key][-1][1]
        log(f"  /debug/history device memory {dict(key)}: "
            f"{len(series[key])} points, last {last:.0f} B; "
            f"torch.cuda.memory_allocated(0) at a quiescent sweep "
            f"{allocated} B")
        check(last == allocated, f"device memory {last} != {allocated}")
        status, doc = http_get(
            port, "/debug/history?name=sparkml_device_mem_bytes_limit")
        limit = [s["points"][-1][1] for s in doc["series"]
                 if s["labels"] == dict(key)]
        total = torch.cuda.get_device_properties(0).total_memory
        check(status == 200 and limit == [total],
              f"bytes_limit {limit} != total_memory {total}")

        status, slo = http_get(port, "/debug/slo")
        log(f"  /debug/slo sections: {sorted(slo)}")
        check(status == 200 and set(slo) == DEBUG_SLO_SECTIONS,
              f"/debug/slo sections {sorted(slo)}")
        check(not DEBUG_UNPORTED & set(slo), "an unported /debug/slo section")
        check(slo["degraded_total"] == 0 and slo["retries_total"] == 0
              and slo["worker_restarts_total"] == 0 and slo["faults"] == []
              and slo["breakers"]["pca"]["state"] == "closed",
              f"/debug/slo totals {slo['degraded_total']} / "
              f"{slo['retries_total']} / {slo['worker_restarts_total']}")
        status, doc = http_get(port, "/debug/traces?limit=20")
        traces = doc["traces"]
        linked = sum(linked_batch(t) for t in traces)
        log(f"  /debug/traces?limit=20: {len(traces)} trees, {linked} with "
            f"a linked batch span")
        check(status == 200 and len(traces) == 20 and linked > 0
              and all(t["spans"][0]["name"] == "serve:http:predict"
                      for t in traces), "/debug/traces trees")

        sweeps = sampler.sweeps  # this phase's sampler: every sweep
        elapsed = time.perf_counter() - t_sampler
        cost = (overhead.value(component="sampler") - sampler_s0) / sweeps
        status, hist = http_get(port, "/debug/history")
        log(f"  sampler: {sweeps} sweeps at {DEBUG_SAMPLE_S * 1e3:.0f} ms "
            f"in {elapsed:.2f} s, {cost * 1e3:.4f} ms per sweep "
            f"(sparkml_obs_overhead_seconds_total{{component=\"sampler\"}} "
            f"/ sweeps, host clock); {hist['sampler']['series_count']} "
            f"series, {hist['sampler']['dropped_series']} dropped")
        # at least 10, and at least half the cadence's count: a sampler
        # that fell behind its interval fails too
        check(sweeps >= max(DEBUG_MIN_SWEEPS,
                            0.5 * elapsed / DEBUG_SAMPLE_S),
              f"the sampler swept {sweeps} times in {elapsed:.2f} s")
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
    log(f"  phase 8 {time.perf_counter() - t_phase:.1f} s")
    return busy


# -- phase 9: profiling and the flight recorder ----------------------------------

PROFILE_SECONDS = 60      # the capture's window; the phase ends it early
DUMP_SECTIONS = ("thread_stacks", "open_spans", "active_traces",
                 "breaker_events", "metrics_history", "metrics")


def http_post(port, path):
    """(status, decoded JSON) of one POST without a body."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=b"",
                     headers={"Content-Length": "0"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def merged(intervals):
    """The union of [start, end) intervals as sorted disjoint pairs."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def length(pairs) -> float:
    return sum(end - start for start, end in pairs)


def overlap(a, b) -> float:
    """The length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_split(events) -> dict:
    """The device side of a torch trace's events (µs): the unions of every
    kernel, memcpy and memset interval and of each kind, their overlap, the
    kernel and launch-call counts, and the gaps between merged device
    intervals. Seconds throughout."""
    def spans(pred):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("ph") == "X" and pred(e)]

    from spark_rapids_ml_tpu_torch.obs.profiler import DEVICE_CATEGORIES

    kernel = merged(spans(lambda e: e.get("cat") == "kernel"))
    memcpy = merged(spans(lambda e: e.get("cat") == "gpu_memcpy"))
    htod = merged(spans(lambda e: e.get("cat") == "gpu_memcpy"
                        and "HtoD" in e["name"]))
    dtoh = merged(spans(lambda e: e.get("cat") == "gpu_memcpy"
                        and "DtoH" in e["name"]))
    device = merged(spans(lambda e: e.get("cat") in DEVICE_CATEGORIES))
    names = {}
    for e in events:
        if e.get("cat") == "kernel":
            names[e["name"][:60]] = names.get(e["name"][:60], 0) + 1
    gemms = sum(1 for e in events if e.get("cat") == "kernel"
                and "gemm" in e["name"].lower())
    launch_calls = [e["dur"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and e.get("name") in ("cudaLaunchKernel",
                                          "cuLaunchKernel",
                                          "cudaLaunchKernelExC",
                                          "cudaMemcpyAsync")]
    gaps = [b[0] - a[1] for a, b in zip(device, device[1:])]
    return {
        "device_s": length(device) * 1e-6,
        "kernel_s": length(kernel) * 1e-6,
        "htod_s": length(htod) * 1e-6,
        "dtoh_s": length(dtoh) * 1e-6,
        "memcpy_s": length(memcpy) * 1e-6,
        "copy_compute_s": overlap(memcpy, kernel) * 1e-6,
        "kernels": sum(names.values()),
        "gemms": gemms,
        "kernel_names": sorted(names.items(), key=lambda kv: -kv[1])[:4],
        "htod": sum(1 for e in events if e.get("cat") == "gpu_memcpy"
                    and "HtoD" in e["name"]),
        "htod_bytes": sum(e.get("args", {}).get("bytes", 0) for e in events
                          if e.get("cat") == "gpu_memcpy"
                          and "HtoD" in e["name"]),
        "dtoh": sum(1 for e in events if e.get("cat") == "gpu_memcpy"
                    and "DtoH" in e["name"]),
        "launch_calls": len(launch_calls),
        "launch_call_s": sum(launch_calls) * 1e-6,
        "gaps_us": np.asarray(gaps, dtype=np.float64),
    }


def check_dump(path, seconds, device_label) -> None:
    """A flight dump must be whole JSON with every section, and its
    metrics history must carry the allocator's device memory series."""
    size = os.path.getsize(path)
    with open(path) as f:
        doc = json.load(f)
    missing = [k for k in DUMP_SECTIONS if k not in doc]
    check(not missing, f"the flight dump lacks {missing}")
    history = doc["metrics_history"] or {}
    mem = sorted(k for k in history if k.startswith("sparkml_device_mem_")
                 and f"device={device_label}" in k and "source=cuda" in k)
    check(mem, f"the dump's metrics_history has no device memory series "
          f"({sorted(history)[:8]})")
    log(f"  flight dump {os.path.basename(path)}: {size} B written in "
        f"{seconds * 1e3:.2f} ms (host clock), {len(doc['thread_stacks'])} "
        f"thread stacks, {len(doc['open_spans'])} open spans, "
        f"{len(doc['active_traces'])} active traces, "
        f"{len(doc['breaker_events']['states'])} breaker states, "
        f"{len(history)} history series ({', '.join(mem)})")


def phase_profile(torch, fg, model, device, occupancy8):
    """Phase 9: fit (c)'s model on the native ladder behind the HTTP server,
    a ``torch.profiler`` capture over ``/debug/profile`` around phase 5's
    binary traffic, the device-side split of a served batch read from its
    trace, and a flight dump while the server is up."""
    import shutil

    from spark_rapids_ml_tpu_torch.obs import flight, profiler, tsdb
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        start_serve_server,
        wire,
    )

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    traffic = serve_traffic()
    bodies = [(i, wire.encode_request("pca", rows), wire.BINARY_CONTENT_TYPE)
              for i, rows in enumerate(traffic)]
    refs = [rows.astype(np.float64) @ model.pc for rows in traffic]
    registry = ModelRegistry()
    registry.register("pca", model)
    metrics = get_registry()
    saved = {k: os.environ.pop(k, None)
             for k in (flight.DUMP_DIR_ENV, profiler.PROFILE_DIR_ENV)}
    dump_root = tempfile.mkdtemp(prefix="chip_smoke_dumps_")
    os.environ[flight.DUMP_DIR_ENV] = dump_root
    tsdb.reset_tsdb()
    sampler = tsdb.start_sampling(interval_seconds=DEBUG_SAMPLE_S)
    engine, serving = warm_engine(registry, "native", "profile")
    check(serving == "native", f"phase 9 serves {serving}")
    server = start_serve_server(engine, port=0, addr="127.0.0.1")
    port = server.server_address[1]
    captures = metrics.counter("sparkml_obs_profile_captures_total", "",
                               ("outcome",))
    dumps = metrics.counter("sparkml_flight_dumps_total", "", ("reason",))

    def counters():
        return {
            "busy_s": metrics.counter(
                "sparkml_serve_device_busy_seconds_total", "",
                ("model",)).value(model="pca"),
            "batches": metrics.counter(
                "sparkml_serve_batches_total", "", ("model",)).value(
                    model="pca"),
            "started": captures.value(outcome="started"),
            "completed": captures.value(outcome="completed"),
        }

    try:
        wait_sweeps(sampler, 1)
        fg.reset_launches()
        before = counters()
        t0 = time.perf_counter()
        status, started = http_post(
            port, f"/debug/profile?seconds={PROFILE_SECONDS}&label=smoke")
        check(status == 200 and started["started"]["torch_enabled"],
              f"POST /debug/profile: {status} {started}")
        status, again = http_post(port, "/debug/profile?seconds=1")
        check(status == 409 and again["active"]["id"]
              == started["started"]["id"],
              f"a second POST /debug/profile: {status} {again}")
        end = time.monotonic() + 120.0
        while not (profiler.capture_active() or {}).get("torch_trace"):
            check(time.monotonic() < end and profiler.capture_active(),
                  f"torch.profiler never started: {profiler.last_capture()}")
            time.sleep(0.001)
        start_s = time.perf_counter() - t0
        log(f"  torch.profiler start ([CPU, CUDA], profile_all_threads, "
            f"from the POST to the trace running): {start_s:.3f} s "
            f"(host clock; {smi})")
        results, wall = http_clients(port, bodies)
        t_stop = time.perf_counter()
        profiler.stop_capture()
        last = profiler.wait(60.0)
        stop_s = time.perf_counter() - t_stop
        after = counters()
        launched = dict(fg.launches)
        check(len(results) == SERVE_REQUESTS,
              f"phase 9: {len(results)} responses")
        worst, lat = check_responses("profile", results, traffic, refs,
                                     SERVE_BARS["native"])
        delta = {k: after[k] - before[k] for k in after}
        log(f"  {SERVE_REQUESTS} binary requests under the capture in "
            f"{wall:.3f} s: {SERVE_REQUESTS / wall:.1f} requests/s, client "
            f"p50 {np.percentile(lat, 50):.2f} ms, p99 "
            f"{np.percentile(lat, 99):.2f} ms; worst max|Δ|/max|ref| "
            f"{worst:.3e}; stop + export {stop_s:.3f} s")

        status, doc = http_get(port, "/debug/profile")
        check(status == 200 and set(doc) == {"active", "last", "dir"},
              f"GET /debug/profile: {status} {sorted(doc)}")
        last = doc["last"]
        log(f"  /debug/profile last: torch_outcome {last['torch_outcome']}, "
            f"torch_trace {last['torch_trace']}, "
            f"{len(last['artifacts'])} artifacts "
            f"({sum(a['bytes'] for a in last['artifacts'])} B)")
        check(doc["active"] is None and last["torch_outcome"] == "ok"
              and last["torch_trace"], f"the capture ended {last}")
        names = sorted(os.path.basename(a["path"])
                       for a in last["artifacts"])
        torch_path = profiler.torch_trace_path(last["path"], last["id"])
        check(names == sorted([os.path.basename(torch_path),
                               os.path.basename(last["spans_trace"])]),
              f"capture artifacts {names}")
        with open(last["spans_trace"]) as f:
            span_events = json.load(f)["traceEvents"]
        with open(torch_path) as f:
            events = json.load(f)["traceEvents"]
        split = device_split(events)
        check(delta["started"] == 1 and delta["completed"] == 1,
              f"capture counters moved started {delta['started']}, "
              f"completed {delta['completed']}")
        log(f"  kernel launches during the capture: {launched}")
        check(sum(launched.values()) == 0, "phase 9 launched a hand kernel")
        check(split["gemms"] > 0 and split["htod"] > 0
              and split["dtoh"] > 0,
              f"the torch trace lacks device events: {split['gemms']} "
              f"GEMM kernels, {split['htod']} HtoD, {split['dtoh']} DtoH")
        batches = delta["batches"]
        occupancy = delta["busy_s"]
        device_s = split["device_s"]
        log(f"  torch trace: {len(events)} events, {split['kernels']} "
            f"kernels ({split['gemms']} GEMM; two are the profiler's "
            f"probe) {split['kernel_names']}, {split['htod']} HtoD, "
            f"{split['dtoh']} DtoH; span trace: {len(span_events)} spans")
        check(device_s <= occupancy,
              f"device busy {device_s:.6f} s > the batcher's busy "
              f"{occupancy:.6f} s over the capture")
        log(f"  device busy {device_s:.6f} s (union of kernel, memcpy and "
            f"memset intervals) <= the batcher's busy {occupancy:.6f} s "
            f"(Δ sparkml_serve_device_busy_seconds_total) over {batches:.0f} "
            f"batches; {smi}")
        log(f"  device busy share {device_s / wall:.4f} of the "
            f"{wall:.3f} s traffic wall, beside the window occupancy "
            f"{occupancy / wall:.4f} here and {occupancy8:.4f} in phase 8 "
            f"({smi})")
        log(f"  per batch: device {device_s / batches * 1e3:.4f} ms, host "
            f"{(occupancy - device_s) / batches * 1e3:.4f} ms (window "
            f"occupancy less device) ({smi})")
        log(f"  unions: HtoD {split['htod_s']:.6f} s "
            f"({split['htod_bytes'] / split['htod_s'] / 1e9:.2f} GB/s over "
            f"{split['htod_bytes']} B), GEMM (kernels) "
            f"{split['kernel_s']:.6f} s, DtoH {split['dtoh_s']:.6f} s; "
            f"copy/compute overlap {split['copy_compute_s']:.6f} s of "
            f"{split['memcpy_s']:.6f} s copying = "
            f"{split['copy_compute_s'] / split['memcpy_s']:.4f} ({smi})")
        gaps = split["gaps_us"]
        short = gaps[gaps < 100.0]
        log(f"  launches per batch: {split['kernels'] / batches:.3f} "
            f"kernels; launch and copy calls {split['launch_calls']} "
            f"({split['launch_call_s'] * 1e3:.3f} ms of host time, "
            f"{split['launch_call_s'] / batches * 1e6:.2f} µs per batch); "
            f"device gaps between merged intervals: {len(gaps)}, median "
            f"{np.median(gaps) if len(gaps) else 0:.2f} µs, "
            f"{len(short)} under 100 µs summing "
            f"{short.sum() / batches:.2f} µs per batch ({smi})")

        wait_sweeps(sampler, 1)
        t_dump = time.perf_counter()
        path = flight.dump("chip_smoke:phase9")
        dump_s = time.perf_counter() - t_dump
        check(path is not None and os.path.exists(path),
              "flight.dump wrote nothing")
        check_dump(path, dump_s, str(device))
        check(dumps.value(reason="chip_smoke") == 1,
              f"sparkml_flight_dumps_total{{reason=\"chip_smoke\"}} = "
              f"{dumps.value(reason='chip_smoke')}")
    finally:
        profiler.wait(60.0)
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        os.environ.pop(flight.DUMP_DIR_ENV, None)
        for key, value in saved.items():
            if value is not None:
                os.environ[key] = value
        shutil.rmtree(dump_root, ignore_errors=True)
    log(f"  phase 9 {time.perf_counter() - t_phase:.1f} s")


# -- phase 10: tiering on the card -------------------------------------------

TIER_MODELS = ("A", "B", "C", "D")   # A fit (c)'s model, B-D save/load copies
TIER_COLD = "D"
TIER_FLAP_S = 30.0     # the flap floor, on the phase's injected clock
TIER_STEP_S = 60.0     # each clock step passes it
TIER_HITS = 8          # concurrent first hits
TIER_MIN_OVERLAP = 1   # A-C responses that must land inside D's first hit
# a reactivation's rise in allocated bytes may differ from D's weights by
# the small tensors the batchers' last batches leave (at most 704 KiB in
# the runs so far): half D's 8 MiB, so a missed or a doubled restage, or
# a new 32 MiB cuBLAS workspace, still fails
TIER_ALLOC_SLACK = 4 << 20


def settled_memory(torch):
    """(memory_allocated, memory_reserved) of card 0 once every reference
    dropped so far is collected and the card is idle."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(0), torch.cuda.memory_reserved(0)


def post_predict(port, body, conn=None):
    """(status, seconds, response bytes) of one binary POST /predict;
    ``conn`` an open connection to reuse, else a new one."""
    import http.client

    from spark_rapids_ml_tpu_torch.serve import wire

    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/predict", body=body,
                     headers={"Content-Type": wire.BINARY_CONTENT_TYPE})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, time.perf_counter() - t0, data
    finally:
        if own:
            conn.close()


def traffic_until(port, bodies, stop, records, failures):
    """SERVE_CLIENTS client threads, each on one keep-alive connection,
    cycling over its share of ``bodies`` until ``stop`` is set (and each
    has sent its share once). Each response lands in ``records`` as
    (index, start, end, status, response bytes). Returns the threads."""
    import http.client
    import threading

    def client(mine):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            sent = 0
            while sent < len(mine) or not stop.is_set():
                i, body = mine[sent % len(mine)]
                t0 = time.perf_counter()
                status, _, data = post_predict(port, body, conn)
                records.append((i, t0, time.perf_counter(), status, data))
                sent += 1
        except Exception as exc:  # noqa: BLE001 - reported by the caller
            failures.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=client,
                                args=(bodies[t::SERVE_CLIENTS],))
               for t in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    return threads


def check_records(label, records, traffic, refs):
    """Every record a 200 within the native bar; returns the worst error."""
    from spark_rapids_ml_tpu_torch.serve import wire

    worst = 0.0
    for i, _t0, _t1, status, data in records:
        check(status == 200, f"{label} request {i}: HTTP {status} "
              f"{data[:200]!r}")
        out = wire.decode_response(data)
        check(out.shape == (traffic[i].shape[0], K)
              and np.isfinite(out).all(), f"{label} request {i}: shape "
              f"{out.shape}")
        worst = max(worst, relative_error(out, refs[i]))
    check(worst <= SERVE_BARS["native"], f"{label}: worst max|Δ|/max|ref| "
          f"{worst:.3e} above {SERVE_BARS['native']:g}")
    return worst


def wait_records(records, n, threads, timeout=300.0):
    end = time.monotonic() + timeout
    while len(records) < n:
        check(time.monotonic() < end and any(t.is_alive() for t in threads),
              f"background traffic stalled at {len(records)} responses")
        time.sleep(0.002)


def phase_tiering(torch, fg, model, device, phase5_rps):
    """Phase 10: four copies of fit (c)'s model behind one engine with a
    tiering controller whose budget holds three; traffic to A-C parks D,
    whose first hits reactivate it while A-C keep serving. Checks that
    D's weights really leave the card and come back."""
    import http.client
    import shutil
    import threading

    from spark_rapids_ml_tpu_torch.obs import accounting, spans, tsdb
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        ServeEngine,
        TieringController,
        start_serve_server,
        wire,
    )
    from spark_rapids_ml_tpu_torch.serve.tiering import ACTIVE, COLD

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    traffic = serve_traffic()
    refs = [rows.astype(np.float64) @ model.pc for rows in traffic]
    live = TIER_MODELS[:3]
    bodies = [(i, wire.encode_request(live[i % 3], rows))
              for i, rows in enumerate(traffic)]
    d_rows = serve_rows(np.random.default_rng(SEED + 10), SERVE_JSON_MAX_ROWS)
    d_ref = d_rows.astype(np.float64) @ model.pc
    d_body = wire.encode_request(TIER_COLD, d_rows)
    metrics = get_registry()
    events = metrics.counter("sparkml_serve_tiering_total", "", ("event",))
    first_hit = metrics.summary("sparkml_serve_tiering_first_hit_seconds",
                                "", ("model",))
    errors = metrics.counter("sparkml_serve_errors_total", "",
                             ("model", "error"))
    ledger = accounting.get_ledger()
    held = ledger.memory_bytes()
    check(not any(held.values()), f"the ledger still charges {held} B "
          f"after phases 5-9 shut their engines down")
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_tier_")
    registry = ModelRegistry()
    registry.register("A", model)
    t0 = time.perf_counter()
    model.save(os.path.join(model_dir, "pca"))
    for name in TIER_MODELS[1:]:
        registry.load(name, os.path.join(model_dir, "pca"))
    log(f"  registered {list(TIER_MODELS)}: A fit (c)'s model, B-D loaded "
        f"from one save ({time.perf_counter() - t0:.2f} s)")
    now = [0.0]
    tsdb.reset_tsdb()
    engine = ServeEngine(registry, max_batch_rows=SERVE_MAX_ROWS,
                         pipeline_depth=2, precision="native")
    server = None
    try:
        t0 = time.perf_counter()
        for name in TIER_MODELS:
            engine.warmup(name)
        weights = ledger.memory_bytes(component=accounting.COMPONENT_WEIGHTS)
        weight = weights.get(TIER_COLD, 0)
        check(weight == N_FEATURES * K * 8 and all(
            weights.get(n) == weight for n in TIER_MODELS),
              f"staged weights {weights}, expected {N_FEATURES * K * 8} "
              f"bytes each")
        budget = 3 * weight
        ctl = TieringController(engine, hbm_budget_bytes=budget,
                                flap_floor_s=TIER_FLAP_S,
                                clock=lambda: now[0])
        engine.attach_tiering(ctl)
        server = start_serve_server(engine, port=0, addr="127.0.0.1")
        port = server.server_address[1]
        log(f"  warmed {len(TIER_MODELS)} models in "
            f"{time.perf_counter() - t0:.2f} s: {weight} B of weights "
            f"each, budget {budget} B (3 models), accounted "
            f"{sum(ledger.memory_bytes().values())} B")

        # D's reference answer, then A-C take phase 5's traffic
        status, _, data = post_predict(port, d_body)
        check(status == 200, f"D's first request: HTTP {status}")
        d_warm = wire.decode_response(data)
        check(relative_error(d_warm, d_ref) <= SERVE_BARS["native"],
              f"D's answer off by {relative_error(d_warm, d_ref):.3e}")
        results, wall = http_clients(port, [
            (i, body, wire.BINARY_CONTENT_TYPE) for i, body in bodies])
        check(len(results) == SERVE_REQUESTS,
              f"phase 10: {len(results)} responses")
        worst, lat = check_responses("tiering A-C", results, traffic, refs,
                                     SERVE_BARS["native"])
        rps = SERVE_REQUESTS / wall
        log(f"  A-C: {SERVE_REQUESTS} binary requests in {wall:.3f} s: "
            f"{rps:.1f} requests/s (phase 5 native, one model: "
            f"{phase5_rps['native']:.1f}), client p50 "
            f"{np.percentile(lat, 50):.2f} ms, p99 "
            f"{np.percentile(lat, 99):.2f} ms; worst max|Δ|/max|ref| "
            f"{worst:.3e}")

        # deactivate: the budget parks the coldest model, D
        alloc0, reserved0 = settled_memory(torch)
        now[0] += TIER_STEP_S
        actions = ctl.evaluate_once()
        alloc1, reserved1 = settled_memory(torch)
        parked = [e for e in spans.get_recorder().events()
                  if e.name == "serve:tiering:deactivate"
                  and e.args.get("model") == TIER_COLD]
        deactivate_ms = parked[-1].dur_us / 1e3 if parked else float("nan")
        check([a["model"] for a in actions] == [TIER_COLD],
              f"evaluate_once parked {actions}, expected D alone")
        states = ctl.states()
        check(states == {**{n: ACTIVE for n in live}, TIER_COLD: COLD},
              f"states after the tick {states}")
        resident = sum(ledger.memory_bytes().values())
        check(resident <= budget, f"accounted {resident} B > budget "
              f"{budget} B")
        check(alloc0 - alloc1 >= weight,
              f"memory_allocated fell {alloc0 - alloc1} B on deactivation, "
              f"less than D's {weight} B of weights")
        status, costs = http_get(port, "/debug/costs")
        status2, tier = http_get(port, "/debug/tiering")
        check(status == 200 and costs["models"][TIER_COLD]["hbm_bytes"][
            accounting.COMPONENT_WEIGHTS] == 0,
              f"/debug/costs D: {costs['models'].get(TIER_COLD)}")
        check(status2 == 200 and tier["states"][TIER_COLD] == COLD
              and tier["resident_bytes"] == resident,
              f"/debug/tiering {tier['states']}, {tier['resident_bytes']}")
        log(f"  deactivate D: {deactivate_ms:.3f} ms (the "
            f"serve:tiering:deactivate span: drain, close, release); "
            f"accounted {resident} B of budget {budget} B; "
            f"memory_allocated {alloc0} -> {alloc1} B (-{alloc0 - alloc1}, "
            f"D's weights {weight}); memory_reserved {reserved0} -> "
            f"{reserved1} B ({smi})")

        # D's first hit while A-C keep their traffic
        stop, records, failures = threading.Event(), [], []
        sketch = first_hit.sketch(model=TIER_COLD)
        hits0, hit_s0 = sketch.count, sketch.sum
        t_traffic = time.perf_counter()
        threads = traffic_until(port, bodies, stop, records, failures)
        wait_records(records, 4 * SERVE_CLIENTS, threads)
        t_d0 = time.perf_counter()
        status, d_seconds, data = post_predict(port, d_body)
        t_d1 = time.perf_counter()
        mark = len(records)
        wait_records(records, mark + 4 * SERVE_CLIENTS, threads)
        stop.set()
        for t in threads:
            t.join(timeout=300)
        traffic_wall = time.perf_counter() - t_traffic
        check(not failures and not any(t.is_alive() for t in threads),
              f"A-C clients failed: {failures[:3]}")
        check(status == 200, f"D's first hit: HTTP {status} {data[:200]!r}")
        d_out = wire.decode_response(data)
        d_err = relative_error(d_out, d_ref)
        check(d_err <= SERVE_BARS["native"], f"D's first hit off by "
              f"{d_err:.3e}")
        check(sketch.count == hits0 + 1,
              f"first-hit observations {sketch.count - hits0}")
        hits1, hit_s1 = sketch.count, sketch.sum
        worst = check_records("A-C during D's first hit", records, traffic,
                              refs)
        inside = sum(1 for _i, r0, r1, _s, _d in records
                     if r1 > t_d0 and r1 < t_d1)
        check(inside >= TIER_MIN_OVERLAP, f"no A-C response landed inside "
              f"D's first hit ({d_seconds * 1e3:.1f} ms)")
        alloc2, reserved2 = settled_memory(torch)
        rise = alloc2 - alloc1
        check(abs(rise - weight) <= TIER_ALLOC_SLACK,
              f"memory_allocated rose {rise} B on reactivation, D's "
              f"weights are {weight} B")
        same = ("bit-equal" if np.array_equal(d_out, d_warm) else
                f"max |Δ| {float(np.abs(d_out - d_warm).max()):.3e}")
        log(f"  D's first hit: HTTP 200 in {d_seconds * 1e3:.3f} ms (client), "
            f"reactivation {(hit_s1 - hit_s0) * 1e3:.3f} ms "
            f"(sparkml_serve_tiering_first_hit_seconds{{model=\"D\"}}, 1 "
            f"observation); answer vs its pre-cold answer: "
            f"{same}, vs float64 {d_err:.3e}; A-C meanwhile: {len(records)} "
            f"responses, all 200, {inside} inside D's first hit, "
            f"{len(records) / traffic_wall:.1f} requests/s, worst "
            f"{worst:.3e}; memory_allocated {alloc1} -> {alloc2} B "
            f"(+{rise}), memory_reserved {reserved1} -> {reserved2} B "
            f"({smi})")

        # park D again; 8 concurrent first hits share one reactivation
        now[0] += TIER_STEP_S
        actions = ctl.evaluate_once()
        check([a["model"] for a in actions] == [TIER_COLD],
              f"the second tick parked {actions}, expected D alone")
        alloc3, reserved3 = settled_memory(torch)
        check(alloc2 - alloc3 >= weight, f"memory_allocated fell "
              f"{alloc2 - alloc3} B when D was parked again")
        counts0 = {e: events.value(event=e)
                   for e in ("cold_hit", "reactivate", "gate_wait")}
        conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                 for _ in range(TIER_HITS)]
        for conn in conns:
            conn.connect()
        barrier = threading.Barrier(TIER_HITS)
        hits = [None] * TIER_HITS

        def hit(j):
            barrier.wait()
            hits[j] = post_predict(port, d_body, conns[j])

        workers = [threading.Thread(target=hit, args=(j,))
                   for j in range(TIER_HITS)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        for conn in conns:
            conn.close()
        check(all(h is not None and h[0] == 200 for h in hits),
              f"concurrent first hits: {[h and h[0] for h in hits]}")
        for h in hits:
            out = wire.decode_response(h[2])
            check(relative_error(out, d_ref) <= SERVE_BARS["native"],
                  "a concurrent first hit outside the native bar")
        moved = {e: events.value(event=e) - counts0[e] for e in counts0}
        check(moved == {"cold_hit": 1, "reactivate": 1,
                        "gate_wait": TIER_HITS - 1}
              and sketch.count == hits1 + 1,
              f"tiering events over the {TIER_HITS} first hits: {moved}, "
              f"first-hit observations {sketch.count - hits1}")
        hit_ms = sorted(h[1] * 1e3 for h in hits)
        alloc4, reserved4 = settled_memory(torch)
        check(abs(alloc4 - alloc3 - weight) <= TIER_ALLOC_SLACK,
              f"memory_allocated rose {alloc4 - alloc3} B on the second "
              f"reactivation, D's weights are {weight} B")
        log(f"  {TIER_HITS} concurrent first hits: all 200, events {moved}; "
            f"client latency p50 {np.percentile(hit_ms, 50):.3f} ms, max "
            f"{hit_ms[-1]:.3f} ms; reactivation "
            f"{(sketch.sum - hit_s1) * 1e3:.3f} ms; memory_allocated "
            f"{alloc2} -> {alloc3} (parked, -{alloc2 - alloc3}) -> {alloc4} "
            f"B (+{alloc4 - alloc3}), memory_reserved {reserved3} -> "
            f"{reserved4} B ({smi})")

        # the ledger against devmon at the batcher's completion seam
        report = ledger.reconcile()
        log(f"  reconcile: verdict {report['verdict']}, worst drift "
            f"{report['worst_drift_ratio']:.3e}, {report['models_checked']} "
            f"models checked: " + ", ".join(
                f"{name} {doc.get('drift_ratio', 'skipped')}"
                for name, doc in sorted(report["models"].items())))
        check(report["verdict"] == "ok", f"reconcile verdict "
              f"{report['verdict']}")
        check(all(report["models"][n].get("drift_ratio", 0.0)
                  <= report["tolerance"] for n in TIER_MODELS
                  if n in report["models"]), "a model drifted")
        errs = sum(errors.value(model=n, error=e) for n in TIER_MODELS
                   for e in ("deactivate", "reactivate", "ledger_charge",
                             "ledger_release", "tiering_audit"))
        check(errs == 0, f"tiering / ledger errors counted: {errs}")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        shutil.rmtree(model_dir, ignore_errors=True)
    log(f"  phase 10 {time.perf_counter() - t_phase:.1f} s")


# -- phase 11: the auto-incident engine on the card ----------------------------

INC_MODEL = "pca_inc"
INC_ROWS = 64
INC_SWEEPS = 20           # baseline sweeps, one per injected second
INC_PER_SWEEP = 2         # healthy requests per baseline sweep
INC_SLOW = 4              # requests under the latency fault before its sweeps
INC_CAPTURED = 2          # requests served under the guarded capture
INC_MIN_DELAY_S = 0.15
INC_DELAY_FACTOR = 3.0    # the delay against the store's baseline p99
INC_CAPTURE_S = 60.0      # the capture's window; the phase ends it early
INC_RECOVERY_SWEEPS = 70  # ages the jump out of the 60 s lookback
BUNDLE_FILES = ("incident.json", "history.json", "traces.json",
                "breakers.json")


def inc_predict(conn, body):
    """(status, seconds, trace id, response bytes) of one binary POST
    /predict on an open connection."""
    from spark_rapids_ml_tpu_torch.serve import wire

    t0 = time.perf_counter()
    conn.request("POST", "/predict", body=body,
                 headers={"Content-Type": wire.BINARY_CONTENT_TYPE})
    resp = conn.getresponse()
    data = resp.read()
    return (resp.status, time.perf_counter() - t0,
            resp.getheader("X-Trace-Id"), data)


def tree_names(nodes):
    """Every span name of an assembled trace tree."""
    names, stack = [], list(nodes)
    while stack:
        node = stack.pop()
        names.append(node["name"])
        stack.extend(node["children"])
    return names


def phase_incidents(torch, fg, model, device):
    """Phase 11: fit (c)'s model behind the HTTP server with the
    auto-incident engine on the process-wide sampler, driven by
    ``sample_once`` on an injected clock. An injected latency opens one
    incident with its bundle and a guarded capture of the card, and the
    incident resolves once the fault clears."""
    import gc
    import http.client
    import shutil
    import threading

    from spark_rapids_ml_tpu_torch.obs import (
        accounting,
        devmon,
        fitmon,
        flight,
        incidents,
        profiler,
        tsdb,
    )
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        ServeEngine,
        fault_plane,
        reset_fault_plane,
        start_serve_server,
        wire,
    )

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    rng = np.random.default_rng(SEED + 11)
    n_requests = INC_SWEEPS * INC_PER_SWEEP + INC_SLOW + INC_CAPTURED
    rows = [serve_rows(rng, INC_ROWS) for _ in range(n_requests)]
    refs = [r.astype(np.float64) @ model.pc for r in rows]
    bodies = [wire.encode_request(INC_MODEL, r) for r in rows]
    saved = {k: os.environ.pop(k, None)
             for k in (flight.DUMP_DIR_ENV, profiler.PROFILE_DIR_ENV,
                       incidents.ENABLED_ENV, incidents.CAPTURE_ENV)}
    dump_root = tempfile.mkdtemp(prefix="chip_smoke_incidents_")
    os.environ[flight.DUMP_DIR_ENV] = dump_root
    os.environ[incidents.CAPTURE_ENV] = str(INC_CAPTURE_S)
    # A fresh registry, as a freshly started server has: the bundle seeds
    # its trace trees from the registry's slowest exemplars, and phases
    # 5-10's slow requests would otherwise be those. Every object that
    # bound a family of the old registry is dropped with it.
    get_registry().reset()
    gc.collect()  # dead engines publish no SLO gauges
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    reset_fault_plane()
    accounting.reset_ledger()
    incidents.reset_incident_engine()
    fitmon.reset_fitmon()
    metrics = get_registry()
    registry = ModelRegistry()
    registry.register(INC_MODEL, model)
    engine = ServeEngine(registry, max_batch_rows=SERVE_MAX_ROWS,
                         pipeline_depth=2, precision="native")
    server = conn = None
    sampler = None
    try:
        t0 = time.perf_counter()
        engine.warmup(INC_MODEL)
        server = start_serve_server(engine, port=0, addr="127.0.0.1")
        port = server.server_address[1]
        # own the cadence: the same process-wide sampler, the incident
        # engine on its post-sweep hook, swept on an injected clock set in
        # the past, so every point lies inside the windows a flight dump
        # reads on the wall clock
        sampler = tsdb.get_sampler()
        sampler.stop()
        inc_engine = incidents.get_incident_engine()
        check(sampler._post_hooks == [inc_engine._post_sweep],
              f"start_serve_server installed {sampler._post_hooks}")
        # the thread's first sweep may have run the engine once, if it
        # ended after start_serve_server installed it: count from here
        sweeps0 = inc_engine.sweeps
        store = tsdb.get_tsdb()
        overhead = metrics.counter("sparkml_obs_overhead_seconds_total", "",
                                   ("component",))
        costs = {"sampler": [], "anomaly": []}

        def sweep(ts):
            before = {c: overhead.value(component=c) for c in costs}
            sampler.sample_once(now=ts)
            for c in costs:
                costs[c].append(overhead.value(component=c) - before[c])

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        served = []

        def request(i):
            status, seconds, tid, data = inc_predict(conn, bodies[i])
            check(status == 200, f"request {i}: HTTP {status} {data[:200]!r}")
            err = relative_error(wire.decode_response(data), refs[i])
            check(err <= SERVE_BARS["native"], f"request {i} off by {err:.3e}")
            served.append((i, seconds, tid))
            return seconds, tid

        t_base = time.time() - 120.0
        log(f"  {INC_MODEL}: fit (c)'s model, native, warmed and served in "
            f"{time.perf_counter() - t0:.2f} s; incident engine installed "
            f"on the sampler ({len(inc_engine.detectors)} detectors)")

        # -- baseline -----------------------------------------------------
        i = 0
        for s in range(INC_SWEEPS):
            for _ in range(INC_PER_SWEEP):
                request(i)
                i += 1
            sweep(t_base + s)
        status, doc = http_get(port, "/debug/incidents")
        check(status == 200 and doc["open"] == [] and doc["sweeps"]
              == sweeps0 + INC_SWEEPS, f"after the baseline: {status} open "
              f"{doc.get('open')}, sweeps {doc.get('sweeps')} from "
              f"{sweeps0}")
        (p99,) = store.range_query(
            "sparkml_serve_request_latency_seconds",
            {"model": INC_MODEL, "quantile": "0.99"}, 60.0,
            now=t_base + INC_SWEEPS - 1)
        baseline_p99 = p99["points"][-1][1]
        delay = max(INC_DELAY_FACTOR * baseline_p99, INC_MIN_DELAY_S)
        base_lat = [sec for _i, sec, _t in served]
        log(f"  baseline: {len(served)} binary requests of {INC_ROWS} rows "
            f"over {INC_SWEEPS} sweeps, client p50 "
            f"{np.percentile(base_lat, 50) * 1e3:.3f} ms; the store's "
            f"baseline p99 {baseline_p99 * 1e3:.3f} ms -> injected delay "
            f"{delay * 1e3:.3f} ms (max({INC_DELAY_FACTOR:g} x p99, "
            f"{INC_MIN_DELAY_S * 1e3:.0f} ms)) ({smi})")

        # -- the fault ----------------------------------------------------
        fault_plane().inject(INC_MODEL, "latency", count=None, seconds=delay)
        slow = [request(i + j) for j in range(INC_SLOW)]
        i += INC_SLOW
        injected = metrics.counter("sparkml_serve_faults_injected_total", "",
                                   ("model", "kind")).value(
                                       model=INC_MODEL, kind="latency")
        check(injected == INC_SLOW, f"latency fired {injected} times for "
              f"{INC_SLOW} requests")
        check(all(sec >= delay for sec, _t in slow),
              f"slow requests took {[sec for sec, _t in slow]} s")
        to_open = 0
        for s in range(1, 3):
            sweep(t_base + INC_SWEEPS + s)
            to_open += 1
            status, doc = http_get(port, "/debug/incidents")
            if doc["open"]:
                break
        check(to_open == 2 and len(doc["open"]) == 1
              and doc["opened_total"] == 1,
              f"{to_open} sweeps after the fault: open {doc['open']}")
        incident = doc["open"][0]
        check(incident["detector"] == "serve_p99_spike"
              and incident["kind"] == "latency"
              and incident["labels"].get("model") == INC_MODEL
              and incident["opened_ts"] == t_base + INC_SWEEPS + 2,
              f"the incident {incident}")
        log(f"  opened after {to_open} sweeps: {incident['id']} "
            f"({incident['severity']}), p99 {incident['value'] * 1e3:.3f} ms "
            f"against {incident['baseline'] * 1e3:.3f} ms; the opening "
            f"sweep's anomaly cost {costs['anomaly'][-1] * 1e3:.3f} ms "
            f"(evidence bundle, flight dump and capture start included)")
        evidence = incident["evidence"]
        bundle = evidence["dir"]
        started = evidence.get("profile", {}).get("started")
        check(started is not None, f"the guarded capture: "
              f"{evidence.get('profile')}")

        # -- the capture: served GEMMs under it ---------------------------
        end = time.monotonic() + 120.0
        while not (profiler.capture_active() or {}).get("torch_trace"):
            check(time.monotonic() < end and profiler.capture_active(),
                  f"the incident's capture never ran: "
                  f"{profiler.last_capture()}")
            time.sleep(0.001)
        for j in range(INC_CAPTURED):
            request(i + j)
        i += INC_CAPTURED
        profiler.stop_capture()
        last = profiler.wait(60.0)
        check(last is not None and last["id"] == started["id"]
              and last["torch_outcome"] == "ok",
              f"the incident's capture ended {last}")
        with open(profiler.torch_trace_path(last["path"], last["id"])) as f:
            events = json.load(f)["traceEvents"]
        dev = device_split(events)
        devices = sorted({str(e.get("args", {}).get("device"))
                          for e in events if e.get("cat") == "kernel"})
        check(dev["gemms"] >= INC_CAPTURED
              and devices == [str(device.index)],
              f"the capture's device events: {dev['kernel_names']}, "
              f"{dev['gemms']} GEMM kernels on devices {devices}")
        log(f"  guarded capture {last['id']}: torch_outcome ok, "
            f"{dev['kernels']} kernels ({dev['gemms']} GEMM), "
            f"{dev['htod']} HtoD, {dev['dtoh']} DtoH on device {devices}, "
            f"device busy {dev['device_s'] * 1e3:.3f} ms, over "
            f"{INC_CAPTURED} served requests ({smi})")

        # a third sweep dedups into the same incident
        sweep(t_base + INC_SWEEPS + 3)
        status, doc = http_get(port, "/debug/incidents")
        check(len(doc["open"]) == 1 and doc["opened_total"] == 1
              and doc["open"][0]["id"] == incident["id"]
              and doc["open"][0]["updates"] == 1,
              f"the third sweep: {doc['open']}")

        # -- the bundle ---------------------------------------------------
        sizes = {name: os.path.getsize(os.path.join(bundle, name))
                 for name in BUNDLE_FILES
                 if os.path.isfile(os.path.join(bundle, name))}
        check(set(sizes) >= {"incident.json", "history.json", "traces.json"},
              f"bundle files {sorted(sizes)}")
        with open(os.path.join(bundle, "history.json")) as f:
            history = json.load(f)
        implicated = history["implicated"]["series"]
        check(history["implicated"]["metric"]
              == "sparkml_serve_request_latency_seconds" and implicated
              and all(s["points"] for s in implicated),
              f"history.json's implicated series: {implicated}")
        dump_path = evidence["flight_dump"]
        check(dump_path and os.path.isfile(dump_path),
              f"the incident's flight dump: {dump_path}")
        sizes[os.path.basename(dump_path)] = os.path.getsize(dump_path)
        with open(os.path.join(bundle, "traces.json")) as f:
            traces = json.load(f)
        check(traces["trees"] and any(
            n.startswith("serve:") for n in tree_names(
                traces["trees"][0]["spans"])),
              f"traces.json trees: {len(traces['trees'])}")
        exemplar_ids = [e["trace_id"] for e in traces["exemplars"]]
        slowest = traces["exemplars"][0]
        check(traces["trees"][0]["trace_id"] in exemplar_ids
              and slowest["value"] >= delay
              and slowest["trace_id"] in {t for _s, t in slow},
              f"traces.json exemplars {traces['exemplars'][:2]}")
        status, tree = http_get(
            port, f"/debug/traces?trace_id={slowest['trace_id']}")
        check(status == 200 and tree["span_count"] >= 1,
              f"/debug/traces?trace_id={slowest['trace_id']}: {status}")
        status, text = 0, b""
        text_conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=60)
        try:
            text_conn.request("GET", "/metrics")
            resp = text_conn.getresponse()
            status, text = resp.status, resp.read().decode()
        finally:
            text_conn.close()
        lines = [ln for ln in text.splitlines() if ln.startswith(
            "# exemplar: sparkml_serve_request_latency_seconds")]
        check(status == 200 and lines, "no exemplar line in /metrics")
        log(f"  bundle {os.path.basename(bundle)}: " + ", ".join(
            f"{name} {size} B" for name, size in sorted(sizes.items()))
            + f"; {len(traces['trees'])} trace trees from "
            f"{len(traces['exemplars'])} exemplars, the slowest "
            f"{slowest['value'] * 1e3:.3f} ms resolving through "
            f"/debug/traces ({tree['span_count']} spans); /metrics: "
            f"{lines[0][:100]}")

        # -- recovery -----------------------------------------------------
        fault_plane().clear()
        to_resolve = 0
        for s in range(INC_RECOVERY_SWEEPS):
            sweep(t_base + INC_SWEEPS + 4 + s)
            to_resolve += 1
            if inc_engine.manager.resolved_total:
                break
        status, doc = http_get(port, "/debug/incidents")
        recent = [r for r in doc["recent"] if r["id"] == incident["id"]]
        check(doc["open"] == [] and doc["resolved_total"] == 1 and recent
              and recent[0]["state"] == "resolved",
              f"after {to_resolve} recovery sweeps: open {doc['open']}")
        with open(os.path.join(bundle, "incident.json")) as f:
            final = json.load(f)
        check(final["state"] == "resolved", f"incident.json reads "
              f"{final['state']}")
        check(not [t.name for t in threading.enumerate()
                   if "incident" in t.name.lower()
                   or "anomaly" in t.name.lower()],
              "a thread named for incidents or anomalies")
        ms = {c: np.asarray(v) * 1e3 for c, v in costs.items()}
        opening = len(costs["anomaly"]) - to_resolve - 2
        quiet = np.delete(ms["anomaly"], opening)
        log(f"  resolved after {to_resolve} sweeps with the fault cleared "
            f"(resolve_after {inc_engine.manager.resolve_after}); "
            f"incident.json resolved, {final['duration_seconds']:g} s on "
            f"the injected clock")
        log(f"  per sweep over {len(ms['anomaly'])} sweeps: anomaly sweep "
            f"median {np.median(quiet):.4f} ms, max {quiet.max():.4f} ms "
            f"(the opening sweep {ms['anomaly'][opening]:.3f} ms) beside the "
            f"sampler's own median {np.median(ms['sampler']):.4f} ms, max "
            f"{ms['sampler'].max():.4f} ms, at {store.series_count()} series "
            f"(host clock; {smi})")
    finally:
        if conn is not None:
            conn.close()
        fault_plane().clear()
        profiler.wait(60.0)
        if sampler is not None:
            incidents.get_incident_engine().uninstall(sampler)
        incidents.reset_incident_engine()
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        for key in (flight.DUMP_DIR_ENV, incidents.CAPTURE_ENV):
            os.environ.pop(key, None)
        for key, value in saved.items():
            if value is not None:
                os.environ[key] = value
        shutil.rmtree(dump_root, ignore_errors=True)
    check(sampler._post_hooks == [] and "incidents" not in
          flight._dump_sections, "the phase left its incident hook behind")
    log(f"  phase 11 {time.perf_counter() - t_phase:.1f} s")


# -- phase 12: fit and transform reports, the dashboard ----------------------

FIT_C_BYTES = (CHUNK_ROWS // 2) * N_FEATURES * 4  # fit (c)'s float32 input
REPORT_TRANSFORM_ROWS = 4096
NAN_REQUESTS = 4          # requests after a nan fault on NAN_FAULTS calls
NAN_FAULTS = 2            # below the engine's default retries (2): answered
SENTINEL_CALLS = 200
LATENCY_QUANTILE_LABELS = ["0.5", "0.95", "0.99"]
DASHBOARD_SERVED = ("/debug/slo", "/healthz", "/debug/history",
                    "/debug/incidents", "/debug/traces?limit=10",
                    "/debug/costs", "/debug/fit")
DASHBOARD_NOT_YET = ("/debug/fleet",)


def record_counters(metrics) -> dict:
    """The transform record's counters for algo pca, and the batches."""
    snap = metrics.snapshot()

    def count(name, **match):
        family = snap.get(name, {"samples": []})
        return sum(s.get("value", s.get("count", 0))
                   for s in family["samples"]
                   if all(s["labels"].get(k) == v for k, v in match.items()))

    return {
        "transforms": count("sparkml_transforms_total", algo="pca"),
        "checks": count("sparkml_numerics_checks_total", algo="pca"),
        "seconds_count": count("sparkml_transform_seconds", algo="pca"),
        "anomalies": count("sparkml_numerics_anomalies_total", algo="pca"),
        "numerics_errors": count("sparkml_transform_errors_total",
                                 algo="pca", error="NumericsError"),
        "batches": count("sparkml_serve_batches_total", model="pca"),
        "retries": count("sparkml_serve_retries_total", model="pca"),
        "degraded": count("sparkml_serve_degraded_total", model="pca"),
    }


def phase_reports(torch, model, device):
    """Phase 12: fit (c)'s report, a transform's report, the served
    batches' records over HTTP, a nan fault, and the dashboard."""
    import http.client

    from spark_rapids_ml_tpu_torch.obs import spans, tsdb
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.obs.serving import check_output_numerics
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        fault_plane,
        reset_fault_plane,
        start_serve_server,
        wire,
    )

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()

    # -- fit (c)'s report -------------------------------------------------
    rep = model.fit_report_
    check(rep.device_platform == "cuda"
          and rep.device_count == torch.cuda.device_count()
          and rep.healthy is True,
          f"fit (c): platform {rep.device_platform}, devices "
          f"{rep.device_count}, healthy {rep.healthy} ({rep.health})")
    check(rep.memory["source"] == "cuda",
          f"fit (c): memory source {rep.memory['source']}")
    check(rep.peak_device_bytes >= FIT_C_BYTES,
          f"fit (c): peak {rep.peak_device_bytes} B below its input's "
          f"{FIT_C_BYTES} B")
    check(set(rep.phases) == set(model.fit_timings_) | {"total"},
          f"fit (c): phases {sorted(rep.phases)} against fit_timings_ "
          f"{sorted(model.fit_timings_)}")
    check((rep.rows, rep.features, rep.bytes_processed)
          == (CHUNK_ROWS // 2, N_FEATURES, FIT_C_BYTES),
          f"fit (c): rows {rep.rows}, features {rep.features}, bytes "
          f"{rep.bytes_processed}")
    phases = ", ".join(f"{k} {v * 1e3:.3f} ms"
                       for k, v in sorted(rep.phases.items()))
    log(f"  fit (c)'s report: {phases} (host clock); peak device bytes "
        f"{rep.peak_device_bytes} (allocator watermark, {rep.memory['source']}"
        f"), health probe {rep.health['probe_seconds'] * 1e3:.3f} ms on "
        f"{rep.health['devices']} ({smi})")

    # -- one transform's report -------------------------------------------
    x = chunk(torch, device, 40, rows=REPORT_TRANSFORM_ROWS)
    out = np.asarray(model.transform(x).column("pca_features"))
    t_rep = model.transform_report_
    check(out.shape == (REPORT_TRANSFORM_ROWS, K) and np.isfinite(out).all(),
          f"transform output {out.shape}")
    check(set(t_rep.phases) == {"device_put", "compute", "host_sync",
                                "total"},
          f"transform phases {sorted(t_rep.phases)}")
    check(t_rep.rows == REPORT_TRANSFORM_ROWS, f"transform rows {t_rep.rows}")
    check(t_rep.numerics is not None
          and t_rep.numerics["checked_rows"] == REPORT_TRANSFORM_ROWS
          and t_rep.numerics["nan_rows"] == 0
          and t_rep.numerics["inf_rows"] == 0,
          f"transform numerics {t_rep.numerics}")
    phases = ", ".join(f"{k} {t_rep.phases[k] * 1e3:.3f} ms" for k in (
        "device_put", "compute", "host_sync", "total"))
    log(f"  {REPORT_TRANSFORM_ROWS}-row transform's report: {phases} (host "
        f"clock; compute is the launch, host_sync holds the product), "
        f"numerics {t_rep.numerics} ({smi})")

    # -- phase 5's traffic: one record per served batch -------------------
    traffic = serve_traffic()
    bodies = [(i, wire.encode_request("pca", rows), wire.BINARY_CONTENT_TYPE)
              for i, rows in enumerate(traffic)]
    refs = [rows.astype(np.float64) @ model.pc for rows in traffic]
    registry = ModelRegistry()
    registry.register("pca", model)
    metrics = get_registry()
    reset_fault_plane()
    engine, serving = warm_engine(registry, "native", "reports")
    check(serving == "native", f"phase 12 serves {serving}")
    server = start_serve_server(engine, port=0, addr="127.0.0.1")
    port = server.server_address[1]
    try:
        before = record_counters(metrics)
        t_traffic = time.perf_counter()
        results, wall = http_clients(port, bodies)
        after = record_counters(metrics)
        check(len(results) == SERVE_REQUESTS,
              f"phase 12: {len(results)} responses")
        worst, lat = check_responses("reports", results, traffic, refs,
                                     SERVE_BARS["native"])
        delta = {k: after[k] - before[k] for k in after}
        batches = delta["batches"]
        check(batches > 0 and delta["transforms"] == batches
              and delta["checks"] == batches
              and delta["seconds_count"] == batches,
              f"per batch records: {delta}")
        check(delta["anomalies"] == 0 and delta["numerics_errors"] == 0,
              f"numerics moved on clean traffic: {delta}")
        walls = [e.dur_us / 1e6 for e in spans.get_recorder().events()
                 if e.name == "transform:pca" and e.args.get("pipelined")
                 and e.ts_us >= t_traffic * 1e6]
        check(len(walls) == batches,
              f"{len(walls)} transform:pca spans for {batches} batches")
        status, ctype, text = http_get_raw(port, "/metrics")
        text = text.decode()
        name = "sparkml_transform_latency_seconds"
        quantiles = sorted(set(re.findall(
            rf'^{name}\{{algo="pca",quantile="([^"]+)"\}}', text,
            flags=re.M)))
        check(status == 200 and quantiles == LATENCY_QUANTILE_LABELS,
              f"/metrics {status}: {name} quantiles {quantiles}")
        exemplar = re.search(rf'^# exemplar: {name}\{{algo="pca"\}} '
                             r'trace_id="([0-9a-f]+)"', text, flags=re.M)
        check(exemplar is not None, f"/metrics has no exemplar for {name}")
        # the top bucket's output, as the batcher hands it to the sentinel
        sample = serve_rows(np.random.default_rng(SEED + 12),
                            SERVE_MAX_ROWS).astype(np.float64) @ model.pc
        costs = []
        for _ in range(SENTINEL_CALLS):
            t0 = time.perf_counter()
            check_output_numerics(sample)
            costs.append(time.perf_counter() - t0)
        log(f"  phase 5's {SERVE_REQUESTS} binary requests: {batches:.0f} "
            f"batches, each one transform, one sparkml_transform_seconds "
            f"observation and one numerics check; {len(walls)} transform:pca "
            f"spans; worst max|Δ|/max|ref| {worst:.3e}; /metrics quantiles "
            f"{quantiles} with the exemplar line; {SERVE_REQUESTS / wall:.1f} "
            f"requests/s, client p50 {np.percentile(lat, 50):.2f} ms (host "
            f"clock)")
        log(f"  numerics sentinel: median of {SENTINEL_CALLS} "
            f"check_output_numerics calls on a {SERVE_MAX_ROWS} x {K} float64 "
            f"output {np.median(costs) * 1e3:.4f} ms, beside the median batch "
            f"wall {np.median(walls) * 1e3:.4f} ms (stage to completion) "
            f"(host clock, {smi})")

        # -- a nan fault: the guard fails the batch, the retry answers -----
        before = record_counters(metrics)
        fault_plane().inject("pca", "nan", count=NAN_FAULTS)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        answers = []
        try:
            for i in range(NAN_REQUESTS):
                conn.request("POST", "/predict", body=bodies[i][1],
                             headers={"Content-Type":
                                      wire.BINARY_CONTENT_TYPE})
                resp = conn.getresponse()
                data = resp.read()
                check(resp.status == 200, f"nan fault request {i}: HTTP "
                      f"{resp.status} {data[:200]!r}")
                err = relative_error(wire.decode_response(data), refs[i])
                check(err <= SERVE_BARS["native"],
                      f"nan fault request {i} off by {err:.3e}")
                answers.append((int(resp.getheader("X-Retries")),
                                int(resp.getheader("X-Degraded"))))
        finally:
            conn.close()
        after = record_counters(metrics)
        delta = {k: after[k] - before[k] for k in after}
        want = [(NAN_FAULTS, 0)] + [(0, 0)] * (NAN_REQUESTS - 1)
        check(answers == want, f"nan fault answers (retries, degraded) "
              f"{answers}, expected {want}")
        check(delta["numerics_errors"] == NAN_FAULTS
              and delta["anomalies"] == 0
              and delta["checks"] == delta["transforms"] == NAN_REQUESTS
              and delta["batches"] == NAN_REQUESTS
              and delta["retries"] == NAN_FAULTS and delta["degraded"] == 0,
              f"nan fault counters {delta}")
        log(f"  nan fault on {NAN_FAULTS} calls: {NAN_REQUESTS} requests "
            f"answered 200 within the native bar, (retries, degraded) "
            f"{answers}; counters {delta}")

        # -- the dashboard ------------------------------------------------
        status, ctype, body = http_get_raw(port, "/dashboard")
        page = body.decode("utf-8")
        check(status == 200 and ctype == "text/html; charset=utf-8",
              f"/dashboard: {status} {ctype}")
        for marker in ("/debug/history", "sparkSvg", "svg.spark",
                       'id="history"'):
            check(marker in page, f"/dashboard lacks {marker!r}")
        fetched = set(re.findall(r'fetch\("([^"]+)"\)', page))
        check(fetched == (set(DASHBOARD_SERVED) | set(DASHBOARD_NOT_YET))
              - {"/debug/costs"},
              f"the page fetches {sorted(fetched)}")
        answered = {}
        for url in DASHBOARD_SERVED + DASHBOARD_NOT_YET:
            answered[url] = http_get_raw(port, url)[0]
        want = {url: 200 for url in DASHBOARD_SERVED}
        want.update({url: 404 for url in DASHBOARD_NOT_YET})
        check(answered == want, f"the page's URLs answer {answered}")
        log(f"  /dashboard: 200 text/html, {len(body)} B; its URLs answer "
            f"{answered}")
    finally:
        reset_fault_plane()
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
    log(f"  phase 12 {time.perf_counter() - t_phase:.1f} s")


# -- phase 13: the fit-path monitor on the card -------------------------------

FITMON_DOC_KEYS = {"enabled", "active", "recent", "rollup", "watchdog",
                   "straggler_ratio", "peaks"}
FITMON_PHASES = {"distributed_pca": {"prepare", "placement", "execute",
                                     "total"},
                 "distributed_streaming_pca": {"stream", "finalize",
                                               "total"}}
MFU_RTOL = 1e-9
DRILL_MAX_SWEEPS = 20     # sweeps a drill may take to open, then to resolve
WATCHDOG_CHECKS = 5       # direct checks timed for the cost per check
FULL_POWER_W = 700.0      # the power limit NVIDIA's published peaks assume


def gram_flops(rows_list, n):
    """The Gram formula summed over the calls: rows·n·(n+1) each."""
    return sum(rows * n * (n + 1) for rows in rows_list)


def fitmon_fit(torch, fg, fitmon, label, fit, expected, kernel):
    """One monitored fit with the launch counts set to 0 just before it;
    returns (result, its FitRun, host seconds, launches)."""
    torch.cuda.synchronize()
    fg.reset_launches()
    t0 = time.perf_counter()
    result = fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(fg.launches)
    check(counts[kernel] == expected and sum(counts.values()) == expected,
          f"{label}: launches {counts}, expected {expected} of {kernel}")
    run = fitmon.get_fit_monitor().recent_runs()[0]
    return result, run, seconds, counts[kernel]


def drill(fitmon, inc_engine, sweep, ts, watchdog, recover, label):
    """Degrade the fit monitor's watchdog, sweep until exactly one
    ``fit_backend_degraded`` incident opens, recover it, sweep until it
    resolves. Returns (sweeps to open, sweeps to resolve, next timestamp)."""
    manager = inc_engine.manager
    opened0, resolved0 = manager.opened_total, manager.resolved_total
    fitmon.get_fit_monitor().watchdog = watchdog
    to_open = 0
    while manager.opened_total == opened0:
        check(to_open < DRILL_MAX_SWEEPS, f"{label}: no incident after "
              f"{to_open} sweeps ({watchdog.last_verdict()})")
        sweep(ts)
        ts += 1.0
        to_open += 1
    opened = manager.open_incidents()
    check(len(opened) == 1 and opened[0]["detector"] == fitmon.INCIDENT_NAME
          and manager.opened_total == opened0 + 1,
          f"{label}: open incidents {opened}")
    verdict = watchdog.last_verdict()
    for _ in range(2):  # still degraded: the same incident, no second one
        sweep(ts)
        ts += 1.0
    check(manager.opened_total == opened0 + 1
          and len(manager.open_incidents()) == 1,
          f"{label}: {manager.opened_total - opened0} incidents opened")
    recover()
    to_resolve = 0
    while manager.resolved_total == resolved0:
        check(to_resolve < DRILL_MAX_SWEEPS, f"{label}: not resolved after "
              f"{to_resolve} sweeps ({watchdog.last_verdict()})")
        sweep(ts)
        ts += 1.0
        to_resolve += 1
    recent = [r for r in manager.recent_incidents()
              if r["id"] == opened[0]["id"]]
    check(manager.open_incidents() == [] and recent
          and recent[0]["state"] == "resolved"
          and manager.opened_total == opened0 + 1,
          f"{label}: after recovery open {manager.open_incidents()}")
    check(watchdog.last_verdict()["ok"] is True,
          f"{label}: recovered verdict {watchdog.last_verdict()}")
    log(f"  drill {label}: verdict {verdict['reason']} (platform "
        f"{verdict['platform']}, canary {verdict['canary']}); one "
        f"{fitmon.INCIDENT_NAME} incident ({opened[0]['severity']}) after "
        f"{to_open} sweeps, resolved {to_resolve} sweeps after recovery")
    return to_open, to_resolve, ts


def phase_fitmon(torch, fg, device, model_a, model_c, streamed7_s):
    """Phase 13: the data-parallel PCA fits under the fit-path monitor in a
    fresh one-rank NCCL world, ``GET /debug/fit`` and the dashboard over
    HTTP, and the watchdog's two incident drills through the process-wide
    sampler, the builtin detector and the incident engine on an injected
    clock. Returns the kernel launches."""
    import gc
    import shutil
    import threading

    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.data.batches import BatchSource
    from spark_rapids_ml_tpu_torch.obs import (
        accounting,
        devmon,
        fitmon,
        flight,
        incidents,
        tsdb,
    )
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_pca_fit,
        distributed_streaming_pca_fit,
        initialize_multihost,
    )
    from spark_rapids_ml_tpu_torch.parallel.mesh import collective_nbytes
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        ServeEngine,
        reset_fault_plane,
        start_serve_server,
    )
    from spark_rapids_ml_tpu_torch.serve.dashboard import DASHBOARD_HTML
    from spark_rapids_ml_tpu_torch.utils.platform import (
        PEAK_FLOPS_BF16,
        PEAK_HBM_BYTES_PER_SECOND,
    )

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    check(kind in PEAK_FLOPS_BF16, f"{kind!r} has no entry in the peak "
          f"table: MFU would be absent")
    peak_flops = PEAK_FLOPS_BF16[kind]
    peak_bw = PEAK_HBM_BYTES_PER_SECOND[kind]
    limit_w = float(smi.rsplit(",", 1)[1].strip().split()[0])
    log(f"  peaks for {kind}: {peak_flops:.4g} FLOP/s bf16 dense, "
        f"{peak_bw:.4g} B/s (NVIDIA's published figures at "
        f"{FULL_POWER_W:.0f} W); this card's power limit {limit_w:.2f} W")
    if limit_w < FULL_POWER_W:
        log(f"  the power limit is below {FULL_POWER_W:.0f} W: the peaks "
            f"assume {FULL_POWER_W:.0f} W, so MFU here reads low")
    saved = {k: os.environ.pop(k, None)
             for k in (flight.DUMP_DIR_ENV, incidents.ENABLED_ENV,
                       incidents.CAPTURE_ENV)}
    dump_root = tempfile.mkdtemp(prefix="chip_smoke_fitmon_")
    os.environ[flight.DUMP_DIR_ENV] = dump_root
    os.environ[incidents.CAPTURE_ENV] = "0"  # the drills need no capture
    # a fresh registry and fresh singletons, as phase 11 makes: the device
    # seconds of fitmon and devmon then start from 0 together
    get_registry().reset()
    gc.collect()
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    reset_fault_plane()
    accounting.reset_ledger()
    incidents.reset_incident_engine()
    fitmon.reset_fitmon()
    metrics = get_registry()
    registry = ModelRegistry()
    registry.register("pca", model_c)
    engine = ServeEngine(registry, max_batch_rows=SERVE_MAX_ROWS,
                         pipeline_depth=2, precision="native")
    server = sampler = None
    release = threading.Event()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    coordinator = f"127.0.0.1:{free_port()}"
    try:
        initialize_multihost(coordinator, num_processes=1, process_id=0)
    except Exception as exc:
        # phase 7 destroyed its world; a second world in one process that
        # cannot start fails the phase, and with it the smoke
        raise RuntimeError(f"phase 13: the one-rank NCCL world did not "
                           f"start again at {coordinator}: {exc!r}") from exc
    kernel = fg.kernel_name(None)
    launched = 0
    try:
        check(dist.get_backend() == ("nccl" if device.type == "cuda"
                                     else "gloo"),
              f"the world runs {dist.get_backend()} on {device}")
        server = start_serve_server(engine, port=0, addr="127.0.0.1")
        port = server.server_address[1]
        sampler = tsdb.get_sampler()
        sampler.stop()  # the phase sweeps it itself, on an injected clock
        monitor = fitmon.get_fit_monitor()
        inc_engine = incidents.get_incident_engine()
        check(monitor.watchdog_collector in sampler._collectors
              and sampler._post_hooks == [inc_engine._post_sweep],
              f"collectors {sampler._collectors}, hooks "
              f"{sampler._post_hooks}")

        x = np.concatenate([chunk(torch, device, i) for i in range(4)])
        rows, n = x.shape
        mesh = data_mesh(1)
        log(f"  fit (a)'s data, {rows:,} x {n} float32, k = {K}, default "
            f"gramPrecision ({kernel}); world rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, backend {dist.get_backend()}")
        two = [collective_nbytes((n + 2,), np.float32),
               collective_nbytes((n, n), np.float32)]
        packed = [collective_nbytes((n * n + n + 2,), np.float32)]
        # label, algo, fit, launches, steps, Gram rows per call, collectives
        fits = (
            ("distributed_pca_fit two pass", "distributed_pca",
             lambda: distributed_pca_fit(x, K, mesh), 1,
             ["covariance_eigh"], [rows], two),
            ("distributed_pca_fit one pass", "distributed_pca",
             lambda: distributed_pca_fit(x, K, mesh, one_pass=True), 1,
             ["covariance_eigh"], [rows], packed),
            ("distributed_streaming_pca_fit, 4 chunks",
             "distributed_streaming_pca",
             lambda: distributed_streaming_pca_fit(
                 BatchSource(x, batch_rows=CHUNK_ROWS), K, mesh), 4,
             ["stream_fold"] * 4 + ["finalize"], [CHUNK_ROWS] * 4, packed),
        )
        overhead = metrics.counter("sparkml_obs_overhead_seconds_total", "",
                                   ("component",))
        mfus = []
        walls = {}
        for label, algo, fit, expected, steps, gram_rows, coll in fits:
            result, run, seconds, count = fitmon_fit(
                torch, fg, fitmon, label, fit, expected, kernel)
            launched += count
            walls[label] = seconds
            compare_to_fit_a(label, result, model_a)
            rep = result.fit_report_
            check(run.algo == rep.algo == algo and not run.active,
                  f"{label}: run {run.algo}, report {rep.algo}")
            check(set(rep.phases) == FITMON_PHASES[algo],
                  f"{label}: phases {sorted(rep.phases)}")
            check(rep.collectives == {"all_reduce": {
                "count": len(coll), "bytes": sum(coll)}},
                f"{label}: collectives {rep.collectives}")
            table = list(run.steps)
            check([s["step"] for s in table] == steps,
                  f"{label}: steps {[s['step'] for s in table]}")
            if algo == "distributed_pca":
                check(table[0]["rows"] == rows, f"{label}: rows "
                      f"{table[0]['rows']}")
            else:
                check(sum(s["rows"] for s in table[:-1]) == rows
                      and table[-1]["rows"] == rows,
                      f"{label}: rows {[s['rows'] for s in table]}")
            check(all(s["device_seconds"] > 0 and not s["failed"]
                      for s in table), f"{label}: a step without device "
                  f"time or failed")
            want = gram_flops(gram_rows, n)
            check(run.flops_total == want == rep.analytic_flops,
                  f"{label}: FLOPs {run.flops_total} (report "
                  f"{rep.analytic_flops}), the Gram formula {want}")
            check(run.report is not None and run.report["rows"] == rows
                  and run.report["collective_bytes"] == sum(coll),
                  f"{label}: the run's joined report {run.report}")
            log(f"  {label}: {seconds:.3f} s (host clock), {count} launch"
                f"{'es' if count > 1 else ''}, phases " + ", ".join(
                    f"{k} {v * 1e3:.3f} ms" for k, v in sorted(
                        rep.phases.items()))
                + f"; analytic MFU over the fit's wall "
                f"{rep.analytic_mfu:.3e}")
            log(f"    {'step':<16}{'rows':>9}{'wall ms':>12}{'device ms':>12}"
                f"{'GFLOP':>10}{'FLOP/B':>9}{'MFU':>11}  bound")
            for s in table:
                flops = s["flops"]
                if flops:
                    mfu = flops / s["device_seconds"] / peak_flops
                    check(abs(s["mfu"] - mfu) <= MFU_RTOL * mfu
                          and 0 < s["mfu"] <= 1.0,
                          f"{label} {s['step']}: MFU {s['mfu']} against "
                          f"{mfu}")
                    mfus.append((label, s["step"], s["mfu"]))
                else:
                    check(s["mfu"] is None, f"{label} {s['step']}: an MFU "
                          f"without FLOPs")
                intensity = (flops / s["bytes_accessed"] if flops else None)
                if flops:
                    # at 4096 features ≈ 1008 FLOP/B against a ridge of
                    # ≈ 295: compute-bound
                    want = ("compute" if intensity >= peak_flops / peak_bw
                            else "memory")
                    check(s["bound"] == want, f"{label}: roofline "
                          f"{s['bound']} at {intensity} FLOP/B")
                log(f"    {s['step']:<16}{s['rows']:>9}"
                    f"{s['wall_seconds'] * 1e3:>12.3f}"
                    f"{s['device_seconds'] * 1e3:>12.3f}"
                    f"{(flops or 0) / 1e9:>10.1f}"
                    f"{intensity or 0:>9.1f}"
                    f"{s['mfu'] if s['mfu'] is not None else 0:>11.3e}  "
                    f"{s['bound']}")
            del result
        log(f"  ridge point {peak_flops / peak_bw:.1f} FLOP/B; the streamed "
            f"fit {walls[fits[2][0]]:.3f} s here (4 steps, each ending in a "
            f"device sync) against phase 7's DistributedStreamingPCA over "
            f"the same chunks {streamed7_s:.3f} s (no monitor), host clock "
            f"({smi})")
        steps_total = sum(len(f[4]) for f in fits)
        per_step = overhead.value(component="fitmon") / steps_total
        log(f"  fitmon's own cost: {per_step * 1e3:.4f} ms per step over "
            f"{steps_total} steps (sparkml_obs_overhead_seconds_total"
            f"{{component=\"fitmon\"}}, host clock; the step's sync is "
            f"not in it)")

        # fitmon's and devmon's device seconds: one measured duration each
        fit_s = metrics.counter("sparkml_fit_device_seconds_total", "",
                                ("algo", "step"))
        batch_s = metrics.counter("sparkml_serve_device_batch_seconds_total",
                                  "", ("model", "device"))
        for algo in FITMON_PHASES:
            ours = sum(fit_s.value(algo=algo, step=step)
                       for step in sorted({s for f in fits if f[1] == algo
                                           for s in f[4]}))
            theirs = batch_s.value(
                model=f"fit:{algo}",
                device=devmon.get_device_monitor().default_device_label())
            check(ours > 0 and ours - theirs == 0.0,
                  f"{algo}: fitmon {ours!r} s, devmon {theirs!r} s")
            log(f"  {algo}: sparkml_fit_device_seconds_total {ours:.6f} s = "
                f"devmon fit:{algo} {theirs:.6f} s (drift 0)")

        # the watchdog, read through the sampler; then /debug/fit over HTTP.
        # The injected clock runs ahead of the wall clock: the sampler's
        # thread swept once at its start, and a series keeps its points in
        # time order (an earlier point would be dropped)
        t_base = time.time() + 60.0

        def sweep(ts):
            sampler.sample_once(now=ts)

        sweep(t_base)
        status, doc = http_get(port, "/debug/fit")
        check(status == 200 and set(doc) == FITMON_DOC_KEYS,
              f"/debug/fit: {status} keys {sorted(doc)}")
        verdict = doc["watchdog"]
        check(verdict is not None and verdict["ok"] is True
              and verdict["platform"] == "cuda"
              and verdict["device_kind"] == kind
              and verdict["device_count"] == torch.cuda.device_count()
              and verdict["canary"] == "ok"
              and verdict["canary_seconds"] > 0,
              f"/debug/fit watchdog {verdict}")
        check(doc["peaks"] == {"flops_per_second": peak_flops,
                               "hbm_bytes_per_second": peak_bw},
              f"/debug/fit peaks {doc['peaks']}")
        check(len(doc["recent"]) == 3 and doc["active"] == []
              and set(doc["rollup"]) == set(FITMON_PHASES)
              and doc["rollup"]["distributed_pca"]["runs"] == 2,
              f"/debug/fit runs: recent {len(doc['recent'])}, rollup "
              f"{sorted(doc['rollup'])}")
        fetched = sorted(set(re.findall(r'fetch\("([^"]+)"\)',
                                        DASHBOARD_HTML)))
        answered = {url: http_get_raw(port, url)[0] for url in fetched}
        check(answered["/debug/fit"] == 200
              and [u for u, s in answered.items() if s != 200]
              == ["/debug/fleet"] and answered["/debug/fleet"] == 404,
              f"the dashboard's URLs answer {answered}")
        log(f"  /debug/fit: 200, keys {sorted(doc)}; watchdog "
            f"{verdict['platform']} ({verdict['device_kind']}, "
            f"{verdict['device_count']} card) ok, canary "
            f"{verdict['canary_seconds'] * 1e3:.3f} ms; peaks "
            f"{doc['peaks']}; the dashboard's URLs {answered}")
        wd = fitmon.BackendWatchdog()
        costs = []
        for _ in range(WATCHDOG_CHECKS):
            t0 = time.perf_counter()
            check(wd.check()["ok"], "a direct watchdog check on the card")
            costs.append(time.perf_counter() - t0)
        log(f"  the watchdog's cost per check (the canary on a helper "
            f"thread included): median {np.median(costs) * 1e3:.3f} ms, "
            f"max {max(costs) * 1e3:.3f} ms over {WATCHDOG_CHECKS} checks "
            f"(host clock, {smi})")

        # -- the drills: through the sampler, detector and engine ----------
        clock = {"t": t_base + 1.0}

        def clocked_sweep(ts):
            clock["t"] = ts
            sweep(ts)

        mismatch = fitmon.BackendWatchdog(
            expected_platform="cpu", interval_s=1.0,
            clock=lambda: clock["t"])

        def fix_expectation():
            mismatch.expected_platform = None

        _o, _r, ts = drill(fitmon, inc_engine, clocked_sweep, clock["t"],
                           mismatch, fix_expectation,
                           "expected_platform='cpu' on the card")
        wedged = {"on": True}

        def canary():
            if wedged["on"]:
                release.wait(120.0)  # a card that stopped answering
            else:
                torch.zeros(8, device=device).sum().item()

        blocked = fitmon.BackendWatchdog(
            interval_s=1.0, canary_timeout_s=0.05, canary_fn=canary,
            clock=lambda: clock["t"])

        def unblock():
            wedged["on"] = False
            release.set()

        # past the incident key's cooldown on the injected clock
        ts += inc_engine.manager.cooldown_seconds + 1.0
        drill(fitmon, inc_engine, clocked_sweep, ts, blocked, unblock,
              "a canary that blocks")
        check(inc_engine.manager.opened_total == 2
              and inc_engine.manager.resolved_total == 2,
              f"incidents opened {inc_engine.manager.opened_total}, "
              f"resolved {inc_engine.manager.resolved_total}: another "
              f"detector fired")
    finally:
        release.set()
        dist.destroy_process_group()
        if sampler is not None:
            incidents.get_incident_engine().uninstall(sampler)
        incidents.reset_incident_engine()
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        fitmon.reset_fitmon()
        for key in (flight.DUMP_DIR_ENV, incidents.CAPTURE_ENV):
            os.environ.pop(key, None)
        for key, value in saved.items():
            if value is not None:
                os.environ[key] = value
        shutil.rmtree(dump_root, ignore_errors=True)
    mfu_text = ", ".join(f"{label.split(',')[0]} {step} {m:.3e}"
                         for label, step, m in mfus)
    log(f"  MFU per step against {peak_flops:.4g} FLOP/s: {mfu_text} "
        f"({smi})")
    log(f"  phase 13 {time.perf_counter() - t_phase:.1f} s")
    return launched


# -- phase 14: the Gram kernel's other callers ------------------------------------

SVD_ROWS = CHUNK_ROWS
SVD_SHIFT = 1.0            # per column: the uncentred Gram is not the centred one
SIGMA_RTOL = 1e-3          # σ relative error against the plain-version fit
TRANSFORM_RTOL = 1e-5      # PERF.md §2's transform bar
LINREG_INTERCEPT = 3.0
LINREG_NOISE = 0.1
LINREG_CHUNKS = 4          # the streamed fit: a generator of 4 chunks
ENET = (0.01, 0.5)         # (regParam, elasticNetParam)
# ‖[ŵ, b̂] − [w*, b*]‖ / ‖[w*, b*]‖ against the float64 oracle on the card,
# set from PERF.md §2's error analysis before the first run
LINREG_RTOL = 1e-4         # one-shot, weighted, streamed
ENET_RTOL = 1e-3           # elastic net, against FISTA on the oracle's moments
DIST_RTOL = 1e-6           # one NCCL rank, against the one-shot fit


def planted_coefficients(torch, device):
    gen = torch.Generator(device=device).manual_seed(SEED + 1400)
    return torch.randn(N_FEATURES, generator=gen, device=device,
                       dtype=torch.float64)


def linreg_chunk(torch, device, index, coef, label_dtype=np.float64):
    """(X, y): X ~ N(0, 1) as a host float32 array, y = X·w + 3.0 + 0.1·ε
    (computed in float64, handed over as ``label_dtype``), made on the card
    from SEED + 1401 + index."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1401 + index)
    x = torch.randn(CHUNK_ROWS, N_FEATURES, generator=gen, device=device)
    eps = torch.randn(CHUNK_ROWS, generator=gen, device=device,
                      dtype=torch.float64)
    y = x.double() @ coef + LINREG_INTERCEPT + LINREG_NOISE * eps
    return x.cpu().numpy(), y.cpu().numpy().astype(label_dtype)


def oracle_moments(torch, device, chunks, weights=None):
    """Centred float64 normal-equation operands (A, b, μx, μy) of the
    weighted rows, on the card (cuBLAS DGEMM), which never reaches the
    kernel."""
    n = N_FEATURES
    f64 = torch.float64
    gxx = torch.zeros(n, n, dtype=f64, device=device)
    gxy = torch.zeros(n, dtype=f64, device=device)
    sx = torch.zeros(n, dtype=f64, device=device)
    sy = torch.zeros((), dtype=f64, device=device)
    sw = torch.zeros((), dtype=f64, device=device)
    for x, y in chunks:
        xd = torch.as_tensor(x, device=device).double()
        yd = torch.as_tensor(y, device=device).double()
        w = torch.ones(xd.shape[0], dtype=f64, device=device) \
            if weights is None else torch.as_tensor(weights, device=device)
        xw = xd * w[:, None]
        gxx += xw.T @ xd
        gxy += xw.T @ yd
        sx += xw.sum(0)
        sy += (w * yd).sum()
        sw += w.sum()
        del xd, xw
    mu_x, mu_y = sx / sw, sy / sw
    return gxx / sw - torch.outer(mu_x, mu_x), gxy / sw - mu_x * mu_y, \
        mu_x, mu_y


def oracle_solve(torch, moments):
    a, b, mu_x, mu_y = moments
    coef = torch.linalg.solve(a, b)
    return coef.cpu().numpy(), float(mu_y - mu_x @ coef)


def linreg_error(coef, intercept, want) -> float:
    got = np.append(np.asarray(coef, dtype=np.float64), intercept)
    ref = np.append(want[0], want[1])
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def counted_run(torch, fg, label, fn, expected):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; fails unless exactly ``expected`` ({kernel: launches}, or a
    function of the result giving it) ran. Returns (result, counts)."""
    torch.cuda.synchronize()
    fg.reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in fg.launches.items() if v}
    if callable(expected):
        expected = expected(result)
    log(f"  {label}: {seconds:.2f} s (host clock), launches {counts}")
    check(counts == expected, f"{label}: launches {counts}, expected "
          f"{expected}")
    return result, counts


def plain_svd(torch, fg, x, k, device):
    """TruncatedSVD's device fit with the Gram computed by the kernel's
    plain version on the card: the same solve, σ the Rayleigh quotient."""
    from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance_gated

    xd = torch.as_tensor(x, dtype=torch.float32, device=device)
    rows, n = xd.shape
    g = fg.fused_centered_gram_reference(
        xd, torch.zeros(n, device=device), torch.ones(rows, device=device))
    v, _, used = pca_from_covariance_gated(g, k, solver="auto")
    s = torch.sqrt(torch.clamp(torch.sum(v * (g @ v), dim=0), min=0))
    return v.cpu().numpy(), s.cpu().numpy(), used


def phase_gram_callers(torch, fg, device, model_a):
    """Phase 14: RowMatrix, TruncatedSVD and LinearRegression through their
    entry points at 4096 features, and ``distributed_linreg_fit`` on one
    NCCL rank. Returns {kernel: launches}."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch import (
        LinearRegression,
        RowMatrix,
        TruncatedSVD,
    )
    from spark_rapids_ml_tpu_torch.data.batches import (
        STREAM_THRESHOLD_ENV,
        auto_batch_rows,
    )
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.models.linear_regression import (
        _elastic_net_solve,
    )
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_linreg_fit,
        initialize_multihost,
    )

    t_phase = time.perf_counter()
    default = fg.kernel_name(None)
    highest = fg.kernel_name("highest")
    launched = {}

    def add(counts):
        for name, count in counts.items():
            launched[name] = launched.get(name, 0) + count

    # (i) RowMatrix: fit (a)'s rows as 4 partitions
    parts = [chunk(torch, device, i) for i in range(4)]
    mat = RowMatrix(parts, use_xla_dot=True, use_xla_svd=True)
    (pc, evr), counts = counted_run(
        torch, fg, f"(i) RowMatrix {mat.num_rows():,} x {mat.num_cols()} in "
        f"{mat.num_partitions} partitions, principal components k = {K}",
        lambda: mat.compute_principal_components_and_explained_variance(K),
        {default: len(parts)})
    add(counts)
    check(pc.shape == (N_FEATURES, K) and np.isfinite(pc).all()
          and np.isfinite(evr).all(), f"RowMatrix components {pc.shape}")
    cos = np.abs(np.sum(model_a.pc * pc, axis=0))
    evr_rel = np.abs(evr - model_a.explained_variance) / np.abs(
        model_a.explained_variance)
    log(f"    vs fit (a): |cos| min over top {TOP_COMPONENTS} "
        f"{cos[:TOP_COMPONENTS].min():.6f} (bar {COS_BAR}), over all {K} "
        f"{cos.min():.6f}; EVR max rel err top {TOP_COMPONENTS} "
        f"{evr_rel[:TOP_COMPONENTS].max():.3e} (bar {EVR_RTOL:g})")
    check(cos[:TOP_COMPONENTS].min() >= COS_BAR, "RowMatrix component |cos|")
    check(evr_rel[:TOP_COMPONENTS].max() <= EVR_RTOL, "RowMatrix EVR")
    projected, counts = counted_run(
        torch, fg, "(i) RowMatrix.multiply(pc)", lambda: mat.multiply(pc), {})
    worst = 0.0
    for part, out in zip(parts, projected._parts):
        want = part.astype(np.float64) @ pc
        worst = max(worst, float(np.abs(out - want).max() / np.abs(want).max()))
    log(f"    multiply: {projected.num_rows():,} x {projected.num_cols()}, "
        f"max rel err vs float64 on the host {worst:.3e} (bar "
        f"{TRANSFORM_RTOL:g})")
    check(projected.num_cols() == K and worst <= TRANSFORM_RTOL,
          f"RowMatrix.multiply rel err {worst:.3e}")
    del parts, mat, projected

    # (ii) TruncatedSVD: 65,536 of those rows, shifted off zero
    x = chunk(torch, device, 0, rows=SVD_ROWS) + np.float32(SVD_SHIFT)
    model, counts = counted_run(
        torch, fg, f"(ii) TruncatedSVD(k={K}) on {SVD_ROWS:,} x {N_FEATURES}, "
        f"columns shifted by {SVD_SHIFT}",
        lambda: TruncatedSVD().setK(K).fit(x), {default: 1})
    add(counts)
    v, s, used = plain_svd(torch, fg, x, K, device)
    check(model.components.shape == (N_FEATURES, K)
          and np.isfinite(model.components).all()
          and np.isfinite(model.singular_values).all(),
          f"TruncatedSVD components {model.components.shape}")
    cos = np.abs(np.sum(model.components * v, axis=0))
    top = slice(0, TOP_COMPONENTS)
    s_rel = np.abs(model.singular_values[top] - s[top]) / np.abs(s[top])
    # the randomized solve's whitening drops the tail directions ~1e6 below
    # the top eigenvalue as exactly-zero columns, and the residual gate
    # passes them, as the JAX package's does (ROADMAP queue 3): counted,
    # not held to a bar, which covers the top components
    zeros = [int((np.abs(c).max(axis=0) == 0).sum())
             for c in (model.components, v)]
    log(f"    vs the plain-version fit: |cos| min over top {TOP_COMPONENTS} "
        f"{cos[top].min():.6f} (bar {COS_BAR}), over all {K} "
        f"{cos.min():.6f}; σ max rel err top {TOP_COMPONENTS} "
        f"{s_rel.max():.3e} (bar {SIGMA_RTOL:g}); zero columns "
        f"{zeros[0]} (plain fit {zeros[1]}) of {K}; σ₁ "
        f"{model.singular_values[0]:.6g}, σ_{TOP_COMPONENTS} "
        f"{model.singular_values[TOP_COMPONENTS - 1]:.6g}, σ_{K} "
        f"{model.singular_values[K - 1]:.6g}; solver "
        f"{model.svd_solver_used_} (plain {used}); fit_timings_ "
        f"{ {k: round(t, 4) for k, t in model.fit_timings_.items()} }")
    check(cos[top].min() >= COS_BAR, "TruncatedSVD |cos|")
    check(s_rel.max() <= SIGMA_RTOL, "TruncatedSVD σ")
    del x, model

    # (iii) LinearRegression at 4096 features, Gaussian design
    coef = planted_coefficients(torch, device)
    x, y = linreg_chunk(torch, device, 0, coef)
    rng = np.random.default_rng(SEED + 1400)
    w = rng.uniform(0.5, 2.0, CHUNK_ROWS)
    threshold = os.environ.get(STREAM_THRESHOLD_ENV)
    # the one-shot route: 65,536 float64 rows are 2 GiB, above the 1 GiB
    # default at which an in-memory fit streams
    os.environ[STREAM_THRESHOLD_ENV] = str(4 << 30)
    try:
        one_shot, counts = counted_run(
            torch, fg, f"(iii) LinearRegression one-shot {CHUNK_ROWS:,} x "
            f"{N_FEATURES}", lambda: LinearRegression().fit(x, labels=y),
            {highest: 1})
        add(counts)
        weighted, counts = counted_run(
            torch, fg, "(iii) LinearRegression weighted, w ~ U(0.5, 2)",
            lambda: LinearRegression().setWeightCol("w").fit(
                VectorFrame({"features": x, "label": y, "w": w})),
            {highest: 1})
        add(counts)
        enet, counts = counted_run(
            torch, fg, f"(iii) LinearRegression elastic net regParam "
            f"{ENET[0]}, elasticNetParam {ENET[1]}",
            lambda: LinearRegression().setRegParam(ENET[0])
            .setElasticNetParam(ENET[1]).fit(x, labels=y), {highest: 1})
        add(counts)
    finally:
        if threshold is None:
            os.environ.pop(STREAM_THRESHOLD_ENV, None)
        else:
            os.environ[STREAM_THRESHOLD_ENV] = threshold
    plain = oracle_moments(torch, device, [(x, y)])
    runs = [("one-shot", one_shot, oracle_solve(torch, plain), LINREG_RTOL),
            ("weighted", weighted, oracle_solve(torch, oracle_moments(
                torch, device, [(x, y)], weights=w)), LINREG_RTOL)]
    a, b, mu_x, mu_y = (t.cpu().numpy() for t in plain)
    enet_coef = _elastic_net_solve(a, b, *ENET)
    runs.append(("elastic net", enet,
                 (enet_coef, float(mu_y - mu_x @ enet_coef)), ENET_RTOL))
    bucket = auto_batch_rows(N_FEATURES + 1)
    rows = LINREG_CHUNKS * CHUNK_ROWS
    buckets = -(-rows // bucket)
    # float32 labels: Z = [X | y] stays float32 on the host (float64 labels
    # promote every chunk to float64, converted back per bucket)
    streamed, counts = counted_run(
        torch, fg, f"(iii) LinearRegression streamed from a generator of "
        f"{LINREG_CHUNKS} chunks of {CHUNK_ROWS:,} (Z = [X | y] float32, "
        f"width {N_FEATURES + 1}, {buckets} buckets of {bucket} rows)",
        lambda: LinearRegression().fit(
            linreg_chunk(torch, device, i, coef, np.float32)
            for i in range(LINREG_CHUNKS)), {default: buckets})
    add(counts)
    runs.append(("streamed", streamed, oracle_solve(torch, oracle_moments(
        torch, device, (linreg_chunk(torch, device, i, coef, np.float32)
                        for i in range(LINREG_CHUNKS)))), LINREG_RTOL))
    for label, model, want, bar in runs:
        check(np.isfinite(model.coefficients).all()
              and np.isfinite(model.intercept), f"{label} finite")
        err = linreg_error(model.coefficients, model.intercept, want)
        log(f"    {label}: rel err vs the float64 oracle {err:.3e} (bar "
            f"{bar:g}); intercept {model.intercept:.6f} (oracle "
            f"{want[1]:.6f}); fit_timings_ "
            f"{ {k: round(t, 4) for k, t in model.fit_timings_.items()} }")
        check(err <= bar, f"LinearRegression {label} rel err {err:.3e}")

    # distributed_linreg_fit on one NCCL rank, against the one-shot fit
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    coordinator = f"127.0.0.1:{free_port()}"
    try:
        initialize_multihost(coordinator, num_processes=1, process_id=0)
    except Exception as exc:
        raise RuntimeError(f"phase 14: the one-rank NCCL world did not "
                           f"start at {coordinator}: {exc!r}") from exc
    try:
        check(dist.get_backend() == "nccl", "the card's world runs NCCL")
        result, counts = counted_run(
            torch, fg, "(iii) distributed_linreg_fit, one NCCL rank",
            lambda: distributed_linreg_fit(x, y, data_mesh(1)), {highest: 1})
        add(counts)
        err = linreg_error(result.coefficients.cpu().numpy(),
                           float(result.intercept),
                           (one_shot.coefficients, one_shot.intercept))
        report = result.fit_report_
        log(f"    vs the one-shot fit: rel err {err:.3e} (bar "
            f"{DIST_RTOL:g}); report phases "
            f"{ {k: round(t, 4) for k, t in report.phases.items()} }, "
            f"collectives {report.collectives}")
        check(err <= DIST_RTOL, f"distributed_linreg_fit rel err {err:.3e}")
        n = N_FEATURES
        check(report.collectives == {"all_reduce": {
            "count": 1, "bytes": (n * n + 2 * n + 3) * 4}},
            f"distributed_linreg_fit collectives {report.collectives}")
    finally:
        dist.destroy_process_group()
    del x, y
    torch.cuda.empty_cache()
    log(f"  phase 14 launches {launched}; {time.perf_counter() - t_phase:.1f} s")
    return launched


# -- phase 15: KMeans, StandardScaler and the fused pipeline --------------------

KM_ROWS = 2_097_152
KM_FEATURES = 64
KM_K = 64
KM_CENTRE_SD = 100.0
KM_WIDE = 512              # (ii)'s second width (bench_models.py:42-66)
KM_PASSES = 10
KM_CHUNKS = 8
KM_CENTRE_RTOL = 1e-5
KM_COST_RTOL = 1e-5
PIPE_SIDE_REQUESTS = 32    # to the PCA and KMeans models beside the pipeline
PIPE_MISMATCH = 1e-3
PIPE_F64_ROWS = 4096
PIPE_PROFILED = 8


def km_blobs(torch, device):
    """(i)'s rows, float64 on the host, and each row's blob."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1500)
    centres = torch.randn(KM_K, KM_FEATURES, generator=gen, device=device,
                          dtype=torch.float64) * KM_CENTRE_SD
    truth = torch.randint(0, KM_K, (KM_ROWS,), generator=gen, device=device)
    x = centres[truth] + torch.randn(KM_ROWS, KM_FEATURES, generator=gen,
                                     device=device, dtype=torch.float64)
    return x.cpu().numpy(), truth.cpu().numpy()


def one_permutation(labels, truth) -> bool:
    """Whether every row's label equals its blob's under one permutation."""
    labels = np.asarray(labels, dtype=np.int64)
    pairs = np.unique(truth.astype(np.int64) * KM_K + labels)
    return (pairs.size == KM_K and np.unique(labels).size == KM_K
            and np.unique(truth).size == KM_K)


def km_labels(model, x) -> np.ndarray:
    return np.asarray(model.transform(x).column("prediction"))


def phase_kmeans(torch, fg, device, model_c):
    """Phase 15: KMeans, StandardScaler and the fused pipeline. Returns
    {kernel: launches}."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch import (
        KMeans,
        KMeansModel,
        PCA,
        Pipeline,
        PipelineModel,
        StandardScaler,
    )
    from spark_rapids_ml_tpu_torch.models._serving import run_staged_pipeline
    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernel as kk
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_kmeans_fit,
        initialize_multihost,
    )
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        ServeEngine,
        start_serve_server,
        wire,
    )

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()

    def launched():
        return {k: v for k, v in fg.launches.items() if v}

    # (i) one-shot fit on the blobs
    t0 = time.perf_counter()
    x, truth = km_blobs(torch, device)
    log(f"  (i) {KM_ROWS:,} x {KM_FEATURES} rows in {KM_K} blobs (centres "
        f"N(0, {KM_CENTRE_SD:g}²), σ = 1), {x.nbytes / 2**30:.2f} GiB as "
        f"float64, made in {time.perf_counter() - t0:.2f} s")
    fg.reset_launches()
    t0 = time.perf_counter()
    model = KMeans().setK(KM_K).fit(x)
    fit_s = time.perf_counter() - t0
    check(launched() == {}, f"KMeans launched {launched()}")
    t0 = time.perf_counter()
    labels = km_labels(model, x)
    transform_s = time.perf_counter() - t0
    x32 = torch.as_tensor(x, dtype=torch.float32, device=device)
    init = kk.kmeans_plus_plus_init(x32, KM_K, model.getSeed())
    ref = kk.lloyd_iterations(x32.double(), init.double(), None,
                              model.getMaxIter(), model.getTol())
    ref_c = ref.centers.cpu().numpy()
    centre_err = float(np.abs(model.cluster_centers - ref_c).max()
                       / np.abs(ref_c).max())
    host_cost = model.compute_cost(x)
    cost_err = abs(model.training_cost_ - host_cost) / host_cost
    log(f"  (i) KMeans().setK({KM_K}).fit: {fit_s:.3f} s, {model.n_iter_} "
        f"iterations (float64 Lloyd from the same centres: "
        f"{int(ref.n_iter)}); fit_timings_ "
        f"{ {k: round(t, 4) for k, t in model.fit_timings_.items()} }; "
        f"transform {transform_s:.3f} s; labels one permutation of the "
        f"blobs: {one_permutation(labels, truth)}; centres vs float64 "
        f"Lloyd {centre_err:.3e} (bar {KM_CENTRE_RTOL:g}); cost "
        f"{model.training_cost_:.10g} vs float64 host {host_cost:.10g}: "
        f"{cost_err:.3e} (bar {KM_COST_RTOL:g})")
    check(one_permutation(labels, truth), "(i) labels are not the blobs'")
    check(centre_err <= KM_CENTRE_RTOL, f"(i) centres {centre_err:.3e}")
    check(cost_err <= KM_COST_RTOL, f"(i) cost {cost_err:.3e}")
    del x32, init, ref

    # (ii) Lloyd's throughput on device rows
    for n in (KM_FEATURES, KM_WIDE):
        gen = torch.Generator(device=device).manual_seed(SEED + 1510 + n)
        xd = torch.randn(KM_ROWS, n, generator=gen, device=device)
        start = xd[:KM_K].clone()
        kk.kmeans_fit_kernel(xd[:65_536], start, max_iter=1, tol=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wide = xd.double()
        torch.cuda.synchronize()
        widen_s = time.perf_counter() - t0
        del wide
        t0 = time.perf_counter()
        result = kk.kmeans_fit_kernel(xd, start, max_iter=KM_PASSES, tol=0.0)
        cost = float(result.cost)
        seconds = time.perf_counter() - t0
        passes = int(result.n_iter) + 1
        pass_ms = (seconds - widen_s) * 1e3 / passes
        flops = 2.0 * KM_ROWS * n * KM_K
        nbytes = float(KM_ROWS * n * 4)
        by_ops = flops / PEAK_OPS_PER_S["f32"] * 1e3
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound_ms = max(by_ops, by_bytes)
        log(f"  (ii) kmeans_fit_kernel {KM_ROWS:,} x {n} float32, k = {KM_K}: "
            f"{int(result.n_iter)} iterations + the final cost = {passes} "
            f"statistics passes in {seconds:.4f} s (the one float64 widening "
            f"of the rows {widen_s * 1e3:.3f} ms of it): {pass_ms:.4f} ms "
            f"per pass, {KM_ROWS / pass_ms * 1e3:.6g} rows/s per pass; bound "
            f"{bound_ms:.4f} ms ({'operations' if by_ops >= by_bytes else 'bytes'}"
            f": {flops / 1e9:.4g} GFLOP of the cross term at "
            f"{PEAK_OPS_PER_S['f32'] / 1e12:g} TFLOP/s, {nbytes / 2**20:.0f} "
            f"MiB read at {PEAK_BYTES_PER_S / 1e12:g} TB/s), "
            f"{bound_ms / pass_ms:.4f} of the bound; {smi}")
        check(int(result.n_iter) >= 1 and np.isfinite(cost),
              f"(ii) Lloyd at width {n}")
        del xd, start, result
    torch.cuda.empty_cache()

    # (iii) streamed and distributed fits on (i)'s blobs
    per = KM_ROWS // KM_CHUNKS

    def chunks():
        return (x[i * per:(i + 1) * per] for i in range(KM_CHUNKS))

    fg.reset_launches()
    t0 = time.perf_counter()
    streamed = KMeans().setK(KM_K).fit(chunks)
    streamed_s = time.perf_counter() - t0
    check(launched() == {}, f"streamed KMeans launched {launched()}")
    ok = one_permutation(km_labels(streamed, x), truth)
    log(f"  (iii) streamed from {KM_CHUNKS} chunks of {per:,}: "
        f"{streamed_s:.3f} s, {streamed.n_iter_} iterations, fit_timings_ "
        f"{ {k: round(t, 4) for k, t in streamed.fit_timings_.items()} }; "
        f"labels one permutation of the blobs: {ok}")
    check(ok, "(iii) streamed labels are not the blobs'")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    coordinator = f"127.0.0.1:{free_port()}"
    try:
        initialize_multihost(coordinator, num_processes=1, process_id=0)
    except Exception as exc:
        raise RuntimeError(f"phase 15: the one-rank NCCL world did not "
                           f"start at {coordinator}: {exc!r}") from exc
    try:
        check(dist.get_backend() == "nccl", "the card's world runs NCCL")
        t0 = time.perf_counter()
        result = distributed_kmeans_fit(x, KM_K, data_mesh(1),
                                        dtype=np.float32)
        dist_s = time.perf_counter() - t0
        step = fitmon.get_fit_monitor().recent_runs()[0].steps[-1]
        centres = result.centers.cpu().numpy().astype(np.float64)
        ok = one_permutation(km_labels(KMeansModel(cluster_centers=centres),
                                       x), truth)
        report = result.fit_report_
        log(f"  (iii) distributed_kmeans_fit, one NCCL rank, float32: "
            f"{dist_s:.3f} s, {int(result.n_iter)} iterations; fit monitor "
            f"step {step['step']!r}: rows {step['rows']}, wall "
            f"{step['wall_seconds']:.4f} s, scalars {step['scalars']}; "
            f"collectives {report.collectives}; labels one permutation of "
            f"the blobs: {ok}")
        check(ok, "(iii) distributed labels are not the blobs'")
        check(step["step"] == "lloyd"
              and step["scalars"]["n_iter"] == int(result.n_iter),
              f"(iii) fit monitor step {step}")
    finally:
        dist.destroy_process_group()
    del x, truth, labels

    # (iv) the pipeline on fit (c)'s rows, served beside PCA and KMeans
    x_c = chunk(torch, device, 20, rows=CHUNK_ROWS // 2)
    default = fg.kernel_name(None)
    fg.reset_launches()
    t0 = time.perf_counter()
    pipe = Pipeline([
        StandardScaler().setWithMean(True).setOutputCol("scaled"),
        PCA().setK(K).setInputCol("scaled").setOutputCol("reduced"),
        KMeans().setK(KM_K).setInputCol("reduced"),
    ]).fit(x_c)
    pipe_fit_s = time.perf_counter() - t0
    pipe_launches = launched()
    log(f"  (iv) Pipeline([StandardScaler(withMean), PCA(k={K}), "
        f"KMeans(k={KM_K})]).fit on {x_c.shape[0]:,} x {x_c.shape[1]}: "
        f"{pipe_fit_s:.3f} s, launches {pipe_launches}; stage fit_timings_ "
        f"{[{k: round(t, 3) for k, t in s.fit_timings_.items()} for s in pipe.stages]}")
    check(pipe_launches == {default: 1},
          f"the pipeline fit launched {pipe_launches}, expected one {default}")
    t0 = time.perf_counter()
    km_c = KMeans().setK(KM_K).fit(x_c)
    log(f"  (iv) KMeans(k={KM_K}) on the same rows: "
        f"{time.perf_counter() - t0:.3f} s, {km_c.n_iter_} iterations")
    registry = ModelRegistry()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pipe.save(f"{tmp}/pipeline")
        registry.load("pipeline", f"{tmp}/pipeline")
        log(f"  (iv) save → ModelRegistry.load: "
            f"{time.perf_counter() - t0:.3f} s")
    loaded = registry.resolve("pipeline")
    check([type(s).__name__ for s in loaded.stages]
          == ["StandardScalerModel", "PCAModel", "KMeansModel"]
          and np.array_equal(loaded.stages[1].pc, pipe.stages[1].pc),
          "the loaded pipeline")
    registry.register("pca", model_c)
    registry.register("kmeans", km_c)
    del x_c
    metrics = get_registry()
    traffic = serve_traffic()
    engine = ServeEngine(registry, max_batch_rows=SERVE_MAX_ROWS,
                         pipeline_depth=2)
    server = None
    try:
        t0 = time.perf_counter()
        for name in ("pipeline", "pca", "kmeans"):
            engine.warmup(name)
        spec = engine._async_specs[("pipeline", 1)]
        check(spec is not None and spec.algo == "pipeline",
              "the pipeline serves no fused program")
        log(f"  (iv) warmup of the three models: "
            f"{time.perf_counter() - t0:.2f} s")
        server = start_serve_server(engine, port=0, addr="127.0.0.1")
        port = server.server_address[1]
        bodies = [(i, wire.encode_request("pipeline", rows),
                   wire.BINARY_CONTENT_TYPE)
                  for i, rows in enumerate(traffic)]
        side = [(i, wire.encode_request(("pca", "kmeans")[i % 2], traffic[i]),
                 wire.BINARY_CONTENT_TYPE)
                for i in range(PIPE_SIDE_REQUESTS)]
        before = serve_counters(metrics)
        runs_before = {a: metric_sum(metrics.snapshot(),
                                     "sparkml_serve_program_runs_total",
                                     algo=a, device="cuda")
                       for a in ("pipeline", "kmeans", "pca")}
        results, wall = http_clients(port, bodies)
        delta = {k: v - before[k] for k, v in serve_counters(metrics).items()}
        side_results, _ = http_clients(port, side)
        runs = {a: metric_sum(metrics.snapshot(),
                              "sparkml_serve_program_runs_total", algo=a,
                              device="cuda") - runs_before[a]
                for a in runs_before}
        check(len(results) == SERVE_REQUESTS,
              f"{len(results)} pipeline responses")
        lat = np.asarray([results[i][0] * 1e3 for i in sorted(results)])
        served = []
        staged_t0 = time.perf_counter()
        unequal = 0
        for i in sorted(results):
            _, status, _, data = results[i]
            check(status == 200, f"pipeline request {i}: HTTP {status}")
            out = wire.decode_response(data)
            check(out.dtype == np.int32 and out.shape == (len(traffic[i]),),
                  f"pipeline request {i}: {out.dtype} {out.shape}")
            unequal += not np.array_equal(
                out, run_staged_pipeline(loaded, traffic[i]))
            served.append(out)
        staged_s = time.perf_counter() - staged_t0
        rows_all = np.concatenate(traffic)
        served = np.concatenate(served)
        t0 = time.perf_counter()
        frame = km_labels(loaded, rows_all)
        frame_s = time.perf_counter() - t0
        mismatch = float(np.mean(served != frame))
        f64 = PipelineModel(stages=[s.copy({"dtype": "float64"})
                                    for s in loaded.stages])
        prog64 = f64.serving_transform_program()
        sample = rows_all[:PIPE_F64_ROWS]
        mismatch64 = float(np.mean(
            prog64.fetch(prog64.run(prog64.put(sample)))
            != km_labels(f64, sample)))
        total_rows = rows_all.shape[0]
        log(f"  (iv) {SERVE_REQUESTS} binary requests ({total_rows} rows) to "
            f"the pipeline over HTTP from {SERVE_CLIENTS} clients in "
            f"{wall:.3f} s: {SERVE_REQUESTS / wall:.1f} requests/s, "
            f"{total_rows / wall:.0f} rows/s; client p50 "
            f"{np.percentile(lat, 50):.2f} ms, p99 "
            f"{np.percentile(lat, 99):.2f} ms; {delta['batches']:.0f} "
            f"batches; responses unequal to run_staged_pipeline on their "
            f"rows: {unequal} of {SERVE_REQUESTS} (staged references "
            f"{staged_s:.2f} s); label mismatch vs PipelineModel.transform "
            f"{mismatch:.3e} (bar {PIPE_MISMATCH:g}; the frame loop "
            f"{frame_s:.2f} s), every stage at float64 on "
            f"{PIPE_F64_ROWS} rows {mismatch64:.3e} (bar 0); program runs "
            f"on cuda {runs}")
        check(unequal == 0, f"{unequal} pipeline responses differ from "
              f"run_staged_pipeline")
        check(mismatch <= PIPE_MISMATCH, f"label mismatch {mismatch:.3e}")
        check(mismatch64 == 0.0, f"float64 label mismatch {mismatch64:.3e}")
        check(all(v > 0 for v in runs.values()),
              f"program runs on cuda by algo {runs}")
        check(delta["runs_cuda"] == delta["batches"] > 0,
              f"{delta['runs_cuda']} cuda runs for {delta['batches']} batches")
        for i, (_, status, _, data) in sorted(side_results.items()):
            check(status == 200, f"side request {i}: HTTP {status}")
            out = wire.decode_response(data)
            if i % 2:
                want = km_labels(km_c, traffic[i])
                check(np.mean(out != want) <= PIPE_MISMATCH,
                      f"kmeans request {i}")
            else:
                ref = traffic[i].astype(np.float64) @ model_c.pc
                check(relative_error(out, ref) <= SERVE_BARS["native"],
                      f"pca request {i}")

        # one device→host copy per batch
        from torch.profiler import ProfilerActivity, profile

        before = serve_counters(metrics)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(PIPE_PROFILED):
                engine.predict("pipeline", traffic[i])
            torch.cuda.synchronize()
        batches = serve_counters(metrics)["batches"] - before["batches"]
        copies = sum(1 for e in prof.events() if "DtoH" in e.name
                     and "Memcpy" in e.name)
        log(f"  (iv) torch.profiler over {PIPE_PROFILED} pipeline requests: "
            f"{batches:.0f} batches, {copies} device→host copies")
        check(batches == PIPE_PROFILED and copies == batches,
              f"{copies} device→host copies for {batches} batches")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.shutdown()

    # (v) the pipeline's reduced ladders through the offline check
    only = ModelRegistry()
    only.register("pipeline", loaded)
    for precision in ("bf16", "int8"):
        engine = ServeEngine(only, max_batch_rows=SERVE_MAX_ROWS,
                             pipeline_depth=2, precision=precision)
        try:
            engine.warmup("pipeline")
            checked = engine.precision_checks[("pipeline", 1, precision)]
            serving = engine.stats()["queues"]["pipeline@1"]["precision"]
            log(f"  (v) {precision}: offline check label mismatch "
                f"{checked['error']}, verdict {checked['verdict']} (bar "
                f"{checked['bar']:g}), serves {serving}")
            check(checked["verdict"] in ("pass", "fail"),
                  f"(v) {precision} check ended {checked['verdict']}")
            check(checked["verdict"] == "pass" or serving == "native",
                  f"(v) a refused {precision} ladder serves {serving}")
        finally:
            engine.shutdown()
    torch.cuda.empty_cache()
    log(f"  phase 15 launches {pipe_launches}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return pipe_launches


# -- phase 16: LogisticRegression and the classifier chain ---------------------

LR_SCALE = 2.0             # sd of the planted logits: w* ~ N(0, LR_SCALE²/n)
LR_INTERCEPT = 0.5
LR_CHUNKS = 4              # the streamed fits: 4 chunks of CHUNK_ROWS
LR_STREAM_ITER = 6         # Newton passes of the streamed binary fit
LR_ENET = (0.01, 0.5)      # (regParam, elasticNetParam)
LR_ENET_ITER = 2           # prox-Newton steps, each one FISTA on 4097² on the host
LR_K = 4                   # classes of the multinomial fits
LR_MN_ITER = 25
LR_MN_STREAM_FEATURES = 256
# bars, set in PERF.md §2 before the first run
LOGREG_RTOL = 1e-4         # one-shot, weighted, no intercept, streamed
LOGREG_ENET_RTOL = 1e-3
LOGREG_DIST_RTOL = 1e-6    # one NCCL rank, against the one-shot fit
MN_PLAIN_RTOL = 1e-4       # against the plain-Gram fit, modulo the gauge
MN_MISMATCH = 1e-3         # against the float64 fit: classes ...
MN_PROBA_ATOL = 2e-3       # ... and probabilities
CHAIN_F32_ATOL = 1e-5      # served probabilities vs the frame loop
CHAIN_F64_ATOL = 1e-12     # every stage at float64
LR_SERVED_RTOL = 1e-5      # the binary model served alone
PROFILE_ATTEMPTS = 3       # captures of the copies per batch (see phase_logreg)
PROFILE_PAUSE_S = 0.1      # from a copy capture's start to its traffic


def logreg_design(torch, device, index):
    """Phase 14 (iii)'s Gaussian design, X ~ N(0, 1), CHUNK_ROWS ×
    N_FEATURES: the same draws as ``linreg_chunk``'s, on the card."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1401 + index)
    return torch.randn(CHUNK_ROWS, N_FEATURES, generator=gen, device=device)


def planted_logits(torch, x, w, b):
    """x·wᵀ + b in float64 on the card, on the host."""
    wt = torch.as_tensor(np.asarray(w).T, device=x.device)
    return (x.double() @ wt).cpu().numpy() + b


def binary_labels(torch, x, w, rng):
    """y ~ Bernoulli(σ(x·w* + LR_INTERCEPT)) as float32 (so a streamed
    Z = [X | y] stays float32)."""
    p = 1.0 / (1.0 + np.exp(-planted_logits(torch, x, w, LR_INTERCEPT)))
    return (rng.random(p.shape[0]) < p).astype(np.float32)


def class_labels(torch, x, w, b, rng):
    """argmax(x·W*ᵀ + b* + Gumbel noise) as float32."""
    z = planted_logits(torch, x, w, b)
    return np.argmax(z + rng.gumbel(size=z.shape), axis=1).astype(np.float32)


def newton64(torch, x, y, weights=None, reg=0.0, fit_intercept=True):
    """The oracle: the port's Newton (``logreg_fit_kernel``) on float64
    tensors on the card, which never reaches the kernel. Returns
    ((coefficients, intercept), n_iter)."""
    from spark_rapids_ml_tpu_torch.ops.logreg_kernel import logreg_fit_kernel

    dev = x.device
    result = logreg_fit_kernel(
        x.double(), torch.as_tensor(y, device=dev).double(),
        None if weights is None else torch.as_tensor(weights, device=dev),
        reg_param=reg, fit_intercept=fit_intercept)
    return ((result.coefficients.cpu().numpy(), float(result.intercept)),
            int(result.n_iter))


def gauge_free(model) -> np.ndarray:
    """A multinomial model's [W | b] less its mean over the classes: the
    softmax is invariant to that shift, which only the gauge ridge pins."""
    wb = np.column_stack([model.coefficient_matrix, model.intercept_vector])
    return wb - wb.mean(axis=0, keepdims=True)


def fit_line(model, seconds) -> str:
    stopped = ("converged" if model.n_iter_ < model.getMaxIter()
               else "ran to maxIter")
    return (f"{seconds:.3f} s, n_iter {model.n_iter_} ({stopped}), "
            f"fit_timings_ {({k: round(t, 4) for k, t in model.fit_timings_.items()})}")


def hessian_shape(torch, fg, label, x, rowmul):
    """The first Newton iteration's Hessian (w = 0, so s = valid/4) on its
    own √s rows: the kernel within its bar of the plain version, timed
    beside ``torch.matmul`` on the same scaled rows (f32, TF32 off) and
    the bound, as phase 3 times its shapes."""
    name, operand, passes = PRECISIONS["highest"]
    rows, n = x.shape
    mean = torch.zeros(n, device=x.device)
    got = fg.fused_centered_gram(x, mean, rowmul, "highest")
    want = fg.fused_centered_gram_reference(x, mean, rowmul, "highest")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= fg.PLAIN_RTOL[name] * scale,
          f"{label} Hessian kernel vs plain {err / scale:.3e}")
    xs = x * rowmul[:, None]
    ms = time_ms(torch, lambda: fg.fused_centered_gram(
        x, mean, rowmul, "highest"), iters=10)
    plain_ms = time_ms(torch, lambda: fg.fused_centered_gram_reference(
        x, mean, rowmul, "highest"), iters=3)
    library_ms = time_ms(torch, lambda: torch.matmul(xs.T, xs), iters=10)
    bound_ms, bound_by = bound(rows, n, operand, passes)
    log(f"    {label} Hessian {rows}x{n} on √s rows: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul (f32, TF32 "
        f"off) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"rel err vs plain {err / scale:.3e}")
    return {"rows": rows, "n": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_logreg(torch, fg, device, model_c):
    """Phase 16: LogisticRegression (binary, multinomial, streamed,
    elastic net, one NCCL rank) at 4096 features and the StandardScaler
    → PCA → LogisticRegression chain served. Returns ({kernel: launches},
    {label: the Hessian shapes' timings})."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch import (
        LogisticRegression,
        PCA,
        Pipeline,
        PipelineModel,
        StandardScaler,
    )
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.models._serving import run_staged_pipeline
    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.ops import covariance as cov_ops
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_logreg_fit,
        initialize_multihost,
    )
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        ServeEngine,
        start_serve_server,
        wire,
    )

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    highest = fg.kernel_name("highest")
    launched, shapes = {}, {}

    def add(counts):
        for name, count in counts.items():
            launched[name] = launched.get(name, 0) + count

    def per_iter(factor=1):
        return lambda m: {highest: factor * m.n_iter_} if m.n_iter_ else {}

    # (i) binary at full width
    rng = np.random.default_rng(SEED + 1600)
    n = N_FEATURES
    w_star = rng.normal(scale=LR_SCALE / np.sqrt(n), size=n)
    x_dev = logreg_design(torch, device, 0)
    y = binary_labels(torch, x_dev, w_star, rng)
    x = x_dev.cpu().numpy()
    weights = rng.uniform(0.5, 2.0, CHUNK_ROWS)
    log(f"  (i) {CHUNK_ROWS:,} x {n} N(0, 1) rows (phase 14's design), "
        f"labels Bernoulli(σ(x·w* + {LR_INTERCEPT})) with w* ~ N(0, "
        f"{LR_SCALE:g}²/{n}): {y.mean():.4f} positive")
    fits = {}
    for label, est, data, oracle_kw in (
            ("one-shot", LogisticRegression(), (x, y), {}),
            ("weighted", LogisticRegression().setWeightCol("w"),
             (VectorFrame({"features": x, "label": y, "w": weights}),),
             {"weights": weights}),
            ("no intercept", LogisticRegression().setFitIntercept(False),
             (x, y), {"fit_intercept": False})):
        t0 = time.perf_counter()
        model, counts = counted_run(
            torch, fg, f"(i) LogisticRegression {label}",
            lambda: est.fit(*data), per_iter())
        seconds = time.perf_counter() - t0
        add(counts)
        want, oracle_iter = newton64(torch, x_dev, y, **oracle_kw)
        err = linreg_error(model.coefficients, model.intercept, want)
        log(f"    {label}: {fit_line(model, seconds)}; rel err vs float64 "
            f"Newton on the card {err:.3e} (bar {LOGREG_RTOL:g}; oracle "
            f"n_iter {oracle_iter})")
        check(np.isfinite(model.coefficients).all(), f"{label} finite")
        check(err <= LOGREG_RTOL, f"LogisticRegression {label} rel err "
              f"{err:.3e}")
        fits[label] = model
    shapes["logreg Hessian, s = 1/4 (phase 16)"] = hessian_shape(
        torch, fg, "one-shot first", x_dev, torch.full((CHUNK_ROWS,), 0.5,
                                                 device=device))
    shapes["logreg Hessian, s = w/4 (phase 16)"] = hessian_shape(
        torch, fg, "weighted first", x_dev, torch.sqrt(torch.as_tensor(
            weights / 4, dtype=torch.float32, device=device)))

    # elastic net against the same prox-Newton on float64 device statistics
    enet = LogisticRegression().setRegParam(LR_ENET[0]).setElasticNetParam(
        LR_ENET[1]).setMaxIter(LR_ENET_ITER)
    t0 = time.perf_counter()
    model, counts = counted_run(
        torch, fg, f"(i) LogisticRegression elastic net regParam "
        f"{LR_ENET[0]}, elasticNetParam {LR_ENET[1]}, maxIter {LR_ENET_ITER}",
        lambda: enet.fit(x, y), per_iter())
    seconds = time.perf_counter() - t0
    add(counts)
    oracle, _ = counted_run(
        torch, fg, "(i) the same elastic net at float64 (no kernel)",
        lambda: enet.copy({"dtype": "float64"}).fit(x, y), {})
    err = linreg_error(model.coefficients, model.intercept,
                       (oracle.coefficients, oracle.intercept))
    log(f"    elastic net: {fit_line(model, seconds)}; rel err vs float64 "
        f"{err:.3e} (bar {LOGREG_ENET_RTOL:g}); zero coefficients "
        f"{int((model.coefficients == 0).sum())} (float64 "
        f"{int((oracle.coefficients == 0).sum())}) of {n}")
    check(err <= LOGREG_ENET_RTOL, f"elastic net rel err {err:.3e}")

    # streamed: 4 chunks of 65,536 rows, buckets of auto_batch_rows(4096)
    chunks = [(x, y)]
    for i in range(1, LR_CHUNKS):
        xi = logreg_design(torch, device, i)
        chunks.append((xi.cpu().numpy(), binary_labels(torch, xi, w_star,
                                                       rng)))
        del xi
    from spark_rapids_ml_tpu_torch.data.batches import auto_batch_rows

    bucket = auto_batch_rows(n)
    buckets = -(-LR_CHUNKS * CHUNK_ROWS // bucket)
    t0 = time.perf_counter()
    model, counts = counted_run(
        torch, fg, f"(i) LogisticRegression streamed, {LR_CHUNKS} chunks of "
        f"{CHUNK_ROWS:,} ({buckets} buckets of {bucket} rows), maxIter "
        f"{LR_STREAM_ITER}",
        lambda: LogisticRegression().setMaxIter(LR_STREAM_ITER).fit(
            lambda: iter(chunks)), per_iter(buckets))
    seconds = time.perf_counter() - t0
    add(counts)
    x_all = torch.cat([torch.as_tensor(c[0], device=device) for c in chunks])
    want, oracle_iter = newton64(torch, x_all, np.concatenate(
        [c[1] for c in chunks]))
    del x_all
    torch.cuda.empty_cache()
    err = linreg_error(model.coefficients, model.intercept, want)
    log(f"    streamed: {fit_line(model, seconds)}; rel err vs float64 "
        f"Newton on the {LR_CHUNKS * CHUNK_ROWS:,} rows {err:.3e} (bar "
        f"{LOGREG_RTOL:g}; oracle n_iter {oracle_iter})")
    check(err <= LOGREG_RTOL, f"streamed rel err {err:.3e}")

    # distributed_logreg_fit on one NCCL rank, against the one-shot fit
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    coordinator = f"127.0.0.1:{free_port()}"
    try:
        initialize_multihost(coordinator, num_processes=1, process_id=0)
    except Exception as exc:
        raise RuntimeError(f"phase 16: the one-rank NCCL world did not "
                           f"start at {coordinator}: {exc!r}") from exc
    try:
        check(dist.get_backend() == "nccl", "the card's world runs NCCL")
        one_shot = fits["one-shot"]
        t0 = time.perf_counter()
        result, counts = counted_run(
            torch, fg, "(i) distributed_logreg_fit, one NCCL rank",
            lambda: distributed_logreg_fit(x, y, data_mesh(1)),
            lambda r: {highest: int(r.n_iter)})
        seconds = time.perf_counter() - t0
        add(counts)
        n_iter = int(result.n_iter)
        err = linreg_error(result.coefficients.cpu().numpy(),
                           float(result.intercept),
                           (one_shot.coefficients, one_shot.intercept))
        report = result.fit_report_
        step = fitmon.get_fit_monitor().recent_runs()[0].steps[-1]
        log(f"    distributed: {seconds:.3f} s, n_iter {n_iter}, converged "
            f"{bool(result.converged)}; vs the one-shot fit: rel err "
            f"{err:.3e} (bar {LOGREG_DIST_RTOL:g}); report phases "
            f"{ {k: round(t, 4) for k, t in report.phases.items()} }, "
            f"collectives {report.collectives}; fit monitor step "
            f"{step['step']!r} scalars {step['scalars']}")
        check(err <= LOGREG_DIST_RTOL, f"distributed_logreg_fit rel err "
              f"{err:.3e}")
        check(step["step"] == "newton"
              and step["scalars"] == {"n_iter": float(n_iter),
                                      "converged": float(result.converged)},
              f"fit monitor step {step}")
        d = n + 1
        check(report.collectives == {"all_reduce": {
            "count": n_iter, "bytes": (d * d + d) * 4 * n_iter}},
            f"distributed_logreg_fit collectives {report.collectives}")
    finally:
        dist.destroy_process_group()

    # (ii) multinomial, K = 4
    w_k = rng.normal(scale=LR_SCALE / np.sqrt(n), size=(LR_K, n))
    b_k = rng.normal(size=LR_K)
    y4 = class_labels(torch, x_dev, w_k, b_k, rng)
    k_blocks = LR_K * (LR_K + 1) // 2
    est = LogisticRegression().setMaxIter(LR_MN_ITER)
    t0 = time.perf_counter()
    mn, counts = counted_run(
        torch, fg, f"(ii) multinomial K = {LR_K} at {n} features (a "
        f"{LR_K * (n + 1):,}² system), maxIter {LR_MN_ITER}",
        lambda: est.fit(x, y4), per_iter(k_blocks))
    seconds = time.perf_counter() - t0
    add(counts)
    log(f"    multinomial: {fit_line(mn, seconds)}; {k_blocks} launches per "
        f"iteration")
    real_gram = cov_ops.fused_centered_gram
    cov_ops.fused_centered_gram = fg.fused_centered_gram_reference
    try:
        t0 = time.perf_counter()
        plain, _ = counted_run(
            torch, fg, "(ii) the same fit with the Gram's plain version",
            lambda: est.fit(x, y4), {})
        plain_s = time.perf_counter() - t0
    finally:
        cov_ops.fused_centered_gram = real_gram
    f64, _ = counted_run(torch, fg, "(ii) the same fit at float64",
                         lambda: est.copy({"dtype": "float64"}).fit(x, y4),
                         {})
    err = float(np.linalg.norm(gauge_free(mn) - gauge_free(plain))
                / np.linalg.norm(gauge_free(plain)))
    p32, p64 = mn.predict_proba(x), f64.predict_proba(x)
    mismatch = float(np.mean(p32.argmax(1) != p64.argmax(1)))
    dp = float(np.abs(p32 - p64).max())
    log(f"    vs the plain-Gram fit ({plain_s:.3f} s, n_iter "
        f"{plain.n_iter_}): [W | b] modulo the gauge rel err {err:.3e} "
        f"(bar {MN_PLAIN_RTOL:g}); vs float64 (n_iter {f64.n_iter_}): "
        f"class mismatch {mismatch:.3e} (bar {MN_MISMATCH:g}), "
        f"probabilities max |Δ| {dp:.3e} (bar {MN_PROBA_ATOL:g}); train "
        f"accuracy {np.mean(p32.argmax(1) == y4):.4f}")
    check(err <= MN_PLAIN_RTOL, f"multinomial vs plain {err:.3e}")
    check(mismatch <= MN_MISMATCH, f"multinomial mismatch {mismatch:.3e}")
    check(dp <= MN_PROBA_ATOL, f"multinomial probabilities {dp:.3e}")
    del p32, p64, plain, f64

    # streamed multinomial at 256 features: the host solve stays small
    ns = min(LR_MN_STREAM_FEATURES, n)
    w_s = rng.normal(scale=LR_SCALE / np.sqrt(ns), size=(LR_K, ns))
    narrow = []
    for xi, _ in chunks:
        xs = np.ascontiguousarray(xi[:, :ns])
        narrow.append((xs, class_labels(
            torch, torch.as_tensor(xs, device=device), w_s, b_k, rng)))
    s_bucket = auto_batch_rows(ns)
    s_buckets = -(-LR_CHUNKS * CHUNK_ROWS // s_bucket)
    t0 = time.perf_counter()
    smn, counts = counted_run(
        torch, fg, f"(ii) multinomial streamed at {ns} features, "
        f"{LR_CHUNKS} chunks ({s_buckets} buckets of {s_bucket} rows)",
        lambda: est.fit(lambda: iter(narrow)), per_iter(k_blocks * s_buckets))
    seconds = time.perf_counter() - t0
    add(counts)
    xs_all = np.concatenate([c[0] for c in narrow])
    ys_all = np.concatenate([c[1] for c in narrow])
    sf64 = est.copy({"dtype": "float64"}).fit(xs_all, ys_all)
    p32, p64 = smn.predict_proba(xs_all), sf64.predict_proba(xs_all)
    mismatch = float(np.mean(p32.argmax(1) != p64.argmax(1)))
    dp = float(np.abs(p32 - p64).max())
    log(f"    streamed multinomial: {fit_line(smn, seconds)}; vs the "
        f"in-memory float64 fit (n_iter {sf64.n_iter_}): class mismatch "
        f"{mismatch:.3e} (bar {MN_MISMATCH:g}), probabilities max |Δ| "
        f"{dp:.3e} (bar {MN_PROBA_ATOL:g})")
    check(mismatch <= MN_MISMATCH, f"streamed mismatch {mismatch:.3e}")
    check(dp <= MN_PROBA_ATOL, f"streamed probabilities {dp:.3e}")
    del narrow, xs_all, chunks, x_dev
    torch.cuda.empty_cache()

    # (iii) the classifier chain on fit (c)'s rows
    x_c = chunk(torch, device, 20, rows=CHUNK_ROWS // 2)
    mu = x_c.mean(axis=0, dtype=np.float64)
    sd = x_c.std(axis=0, ddof=1, dtype=np.float64)
    z = ((x_c - mu) / sd) @ w_star + LR_INTERCEPT
    y_c = (rng.random(z.shape[0]) < 1.0 / (1.0 + np.exp(-z))).astype(
        np.float64)
    default = fg.kernel_name(None)
    t0 = time.perf_counter()
    pipe, counts = counted_run(
        torch, fg, f"(iii) Pipeline([StandardScaler(withMean), PCA(k={K}), "
        f"LogisticRegression()]).fit on {x_c.shape[0]:,} x {n}",
        lambda: Pipeline([
            StandardScaler().setWithMean(True).setOutputCol("scaled"),
            PCA().setK(K).setInputCol("scaled").setOutputCol("reduced"),
            LogisticRegression().setInputCol("reduced"),
        ]).fit(VectorFrame({"features": x_c, "label": y_c})),
        lambda p: {default: 1, highest: p.stages[2].n_iter_})
    add(counts)
    log(f"    chain fit: {time.perf_counter() - t0:.3f} s; stage "
        f"fit_timings_ {[{k: round(t, 3) for k, t in s.fit_timings_.items()} for s in pipe.stages]}; "
        f"LogisticRegression n_iter {pipe.stages[2].n_iter_}")
    registry = ModelRegistry()
    with tempfile.TemporaryDirectory() as tmp:
        pipe.save(f"{tmp}/chain")
        registry.load("chain", f"{tmp}/chain")
    loaded = registry.resolve("chain")
    check([type(s).__name__ for s in loaded.stages]
          == ["StandardScalerModel", "PCAModel", "LogisticRegressionModel"]
          and np.array_equal(loaded.stages[2].coefficients,
                             pipe.stages[2].coefficients),
          "the loaded chain")
    registry.register("logreg", fits["one-shot"])
    del x_c
    metrics = get_registry()
    traffic = serve_traffic()
    engine = ServeEngine(registry, max_batch_rows=SERVE_MAX_ROWS,
                         pipeline_depth=2)
    server = None
    try:
        for name in ("chain", "logreg"):
            engine.warmup(name)
        spec = engine._async_specs[("chain", 1)]
        check(spec is not None and spec.algo == "pipeline",
              "the chain serves no fused program")
        server = start_serve_server(engine, port=0, addr="127.0.0.1")
        port = server.server_address[1]
        served = {}
        for name in ("chain", "logreg"):
            bodies = [(i, wire.encode_request(name, rows),
                       wire.BINARY_CONTENT_TYPE)
                      for i, rows in enumerate(traffic)]
            before = serve_counters(metrics)
            results, wall = http_clients(port, bodies)
            delta = {k: v - before[k]
                     for k, v in serve_counters(metrics).items()}
            check(len(results) == SERVE_REQUESTS, f"{len(results)} {name} "
                  f"responses")
            outs = []
            for i in sorted(results):
                _, status, _, data = results[i]
                check(status == 200, f"{name} request {i}: HTTP {status}")
                out = wire.decode_response(data)
                check(out.dtype == np.float64
                      and out.shape == (len(traffic[i]),)
                      and np.isfinite(out).all(),
                      f"{name} request {i}: {out.dtype} {out.shape}")
                outs.append(out)
            lat = np.asarray([results[i][0] * 1e3 for i in sorted(results)])
            rows_total = sum(len(t) for t in traffic)
            log(f"  ({'iii' if name == 'chain' else 'iv'}) {SERVE_REQUESTS} "
                f"binary requests ({rows_total} rows) to {name!r} over HTTP "
                f"from {SERVE_CLIENTS} clients in {wall:.3f} s: "
                f"{SERVE_REQUESTS / wall:.1f} requests/s, "
                f"{rows_total / wall:.0f} rows/s; client p50 "
                f"{np.percentile(lat, 50):.2f} ms, p99 "
                f"{np.percentile(lat, 99):.2f} ms; {delta['batches']:.0f} "
                f"batches; {smi}")
            check(delta["runs_cuda"] == delta["batches"] > 0
                  and delta["errors"] == delta["degraded"]
                  == delta["retries"] == 0,
                  f"{name}: counters {delta}")
            served[name] = outs

        unequal = sum(not np.array_equal(out, run_staged_pipeline(loaded, t))
                      for out, t in zip(served["chain"], traffic))
        rows_all = np.concatenate(traffic)
        chain_out = np.concatenate(served["chain"])
        t0 = time.perf_counter()
        frame = np.asarray(loaded.transform(rows_all).column("probability"))
        frame_s = time.perf_counter() - t0
        d32 = float(np.abs(chain_out - frame).max())
        f64 = PipelineModel(stages=[s.copy({"dtype": "float64"})
                                    for s in loaded.stages])
        prog64 = f64.serving_transform_program()
        sample = rows_all[:PIPE_F64_ROWS]
        d64 = float(np.abs(prog64.fetch(prog64.run(prog64.put(sample)))
                           - np.asarray(f64.transform(sample).column(
                               "probability"))).max())
        log(f"  (iii) responses unequal to run_staged_pipeline on their "
            f"rows: {unequal} of {SERVE_REQUESTS}; probabilities vs "
            f"PipelineModel.transform max |Δ| {d32:.3e} (bar "
            f"{CHAIN_F32_ATOL:g}; the frame loop {frame_s:.2f} s), every "
            f"stage at float64 on {PIPE_F64_ROWS} rows {d64:.3e} (bar "
            f"{CHAIN_F64_ATOL:g})")
        check(unequal == 0, f"{unequal} chain responses differ from "
              f"run_staged_pipeline")
        check(d32 <= CHAIN_F32_ATOL, f"chain vs frame loop {d32:.3e}")
        check(d64 <= CHAIN_F64_ATOL, f"float64 chain {d64:.3e}")
        lr = fits["one-shot"]
        worst = 0.0
        for out, t in zip(served["logreg"], traffic):
            want = 1.0 / (1.0 + np.exp(-(t.astype(np.float64)
                                         @ lr.coefficients + lr.intercept)))
            worst = max(worst, float(np.max(np.abs(out - want) / want)))
        log(f"  (iv) the one-shot model served alone: max relative error "
            f"vs float64 σ(Xw + b) on the host {worst:.3e} (bar "
            f"{LR_SERVED_RTOL:g})")
        check(worst <= LR_SERVED_RTOL, f"served logreg {worst:.3e}")

        # one device→host copy per batch
        copies_per_batch(torch, engine, metrics, "chain", traffic, "(iii)")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.shutdown()

    # (v) the chain's reduced ladders through the offline check
    only = ModelRegistry()
    only.register("chain", loaded)
    for precision in ("bf16", "int8"):
        engine = ServeEngine(only, max_batch_rows=SERVE_MAX_ROWS,
                             pipeline_depth=2, precision=precision)
        try:
            engine.warmup("chain")
            checked = engine.precision_checks[("chain", 1, precision)]
            serving = engine.stats()["queues"]["chain@1"]["precision"]
            log(f"  (v) {precision}: offline check max |Δ| / max |ref| "
                f"{checked['error']}, verdict {checked['verdict']} (bar "
                f"{checked['bar']:g}), serves {serving}")
            check(checked["verdict"] in ("pass", "fail"),
                  f"(v) {precision} check ended {checked['verdict']}")
            check(checked["verdict"] == "pass" or serving == "native",
                  f"(v) a refused {precision} ladder serves {serving}")
        finally:
            engine.shutdown()
    torch.cuda.empty_cache()
    log(f"  phase 16 launches {launched}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched, shapes


# -- phase 17: the other stage families and their chains ----------------------

STAGE_CONSTANT = 2.5       # planted in every STAGE_CONSTANT_EVERY-th column
STAGE_CONSTANT_EVERY = 16
STAGE_THRESHOLD = 0.25     # the Binarizer's; float32 holds it exactly
STAGE_TIMED = 20           # CUDA-event runs of each body, after 3 warm-up
STAGE_FRAME_ROWS = 8192    # served rows held against the frame loop
STAGE_CHECK_ROWS = 8192    # rows each float32 body is held to its host on
CLUSTER_K = 64
# bars, set in PERF.md §2 before the first run
STAGE_F64_NORM_RTOL = 1e-12   # Normalizer at float64; the rest bit-equal
STAGE_F32_RTOL = 1e-6         # arithmetic families at float32
STAGE_F32_NORM2_RTOL = 1e-5   # Normalizer p = 2 at float32
STAGE_EXACT = ("binarizer", "vector_slicer", "variance_selector",
               "chisq_selector")   # equal to the host at float32 too


def planted_rows(torch, device):
    """Fit (c)'s 32,768 × 4096 float32 rows with every 16th column set to
    2.5, and the indices of the columns left varying."""
    x = chunk(torch, device, 20, rows=CHUNK_ROWS // 2)
    x[:, ::STAGE_CONSTANT_EVERY] = STAGE_CONSTANT
    varying = np.asarray([j for j in range(x.shape[1])
                          if j % STAGE_CONSTANT_EVERY])
    return x, varying


def same_state(a, b) -> bool:
    """Whether two stages hold equal learned state and equal params."""
    for attr in ("original_min", "original_max", "max_abs", "median",
                 "qrange", "selected_features", "pc", "explained_variance",
                 "mean", "std", "cluster_centers", "coefficients"):
        u, v = getattr(a, attr, None), getattr(b, attr, None)
        if (u is None) != (v is None) or (
                u is not None and not np.array_equal(np.asarray(u),
                                                      np.asarray(v))):
            return False
    return a.param_map_for_metadata() == b.param_map_for_metadata()


def copies_per_batch(torch, engine, metrics, name, traffic, label) -> None:
    """One device→host copy per batch over PIPE_PROFILED requests to
    ``name``, read from a ``torch.profiler`` capture of every thread. A
    card program's fetch runs inside the ``FETCH_RANGE`` profiler range
    and its put inside ``PUT_RANGE`` (``models/_serving.py``); the model's
    batcher worker runs them one at a time. So the capture must hold one
    host-side fetch range and one put range a batch, each holding exactly
    one ``cudaMemcpy*`` runtime call: a skipped copy shows as a range with
    none, a doubled one as a range with two. The memcpy activity records
    and the ranges' device-side annotations are logged beside (each batch
    lacking one named) and may not exceed one a batch: they went missing
    for a capture's first batches (ROADMAP queue 3 item 16), so the
    traffic starts PROFILE_PAUSE_S after the capture does. A capture
    holding fewer host-side ranges than batches lost records and is taken
    again (up to PROFILE_ATTEMPTS)."""
    import bisect

    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_ml_tpu_torch.models._serving import (
        FETCH_RANGE,
        PUT_RANGE,
    )

    def split(events, range_name, calls):
        """(memcpy calls inside each host-side range, batches whose
        device-side annotation is missing, device-side annotations)"""
        host = sorted((e for e in events if e.name == range_name
                       and e.device_type == DeviceType.CPU),
                      key=lambda e: e.time_range.start)
        inside = [sum(r.time_range.start <= c.time_range.start
                      and c.time_range.end <= r.time_range.end
                      for c in calls) for r in host]
        starts = [r.time_range.start for r in host]
        device = [bisect.bisect_right(starts, e.time_range.start) - 1
                  for e in events if e.name == range_name
                  and e.device_type != DeviceType.CPU]
        return (inside, sorted(set(range(len(host))) - set(device)),
                len(device))

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        before = serve_counters(metrics)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            time.sleep(PROFILE_PAUSE_S)
            for i in range(PIPE_PROFILED):
                engine.predict(name, traffic[i])
            torch.cuda.synchronize()
        batches = serve_counters(metrics)["batches"] - before["batches"]
        events = list(prof.events())
        calls = [e for e in events if e.name.startswith("cudaMemcpy")]
        fetches, fetch_lost, fetch_dev = split(events, FETCH_RANGE, calls)
        puts, put_lost, put_dev = split(events, PUT_RANGE, calls)
        dtoh = sum("Memcpy" in e.name and "DtoH" in e.name for e in events)
        htod = sum("Memcpy" in e.name and "HtoD" in e.name for e in events)
        log(f"  {label} torch.profiler over {PIPE_PROFILED} {name} requests "
            f"(capture {attempt}, every thread, traffic {PROFILE_PAUSE_S} s "
            f"after its start): {batches:.0f} batches, {len(fetches)} fetch "
            f"ranges holding {fetches} cudaMemcpy* calls, {len(puts)} put "
            f"ranges holding {puts}; {len(calls)} cudaMemcpy* calls in all; "
            f"activity records {dtoh} device→host and {htod} host→device; "
            f"device-side annotations {fetch_dev} fetch (none for batches "
            f"{fetch_lost}) and {put_dev} put (none for batches {put_lost})")
        check(batches == PIPE_PROFILED and len(fetches) <= batches
              and len(puts) <= batches
              and all(n == 1 for n in fetches + puts)
              and max(dtoh, htod, fetch_dev, put_dev) <= batches,
              f"{name}: fetch ranges {fetches}, put ranges {puts}, "
              f"{dtoh} device→host and {htod} host→device records for "
              f"{batches} batches")
        if len(fetches) == len(puts) == batches:
            return
    check(False, f"{name}: fewer fetch or put ranges than batches in each "
          f"of {PROFILE_ATTEMPTS} captures")


def stage_bodies(torch, device, x, varying, fits):
    """(i): each family's body as a one-stage program on the card against
    its host transform, float32 on STAGE_CHECK_ROWS of ``x``'s rows and
    float64 on PIPE_F64_ROWS of them, and each body timed at float32 on
    all of ``x`` beside its bound."""
    from spark_rapids_ml_tpu_torch import (
        Binarizer,
        ChiSqSelectorModel,
        ElementwiseProduct,
        Normalizer,
        PipelineModel,
        VectorSlicer,
    )
    from spark_rapids_ml_tpu_torch.models._serving import (
        build_fused_pipeline_program,
    )

    rng = np.random.default_rng(SEED + 1700)
    n = x.shape[1]
    stages = {
        "min_max_scaler": fits["min_max_scaler"],
        "max_abs_scaler": fits["max_abs_scaler"],
        "robust_scaler": fits["robust_scaler"],
        "normalizer p=2": Normalizer(),
        "normalizer p=inf": Normalizer().setP(float("inf")),
        "binarizer": Binarizer().setThreshold(STAGE_THRESHOLD),
        "elementwise_product": ElementwiseProduct(
            scalingVec=rng.standard_normal(n).tolist()),
        "vector_slicer": VectorSlicer(
            indices=[int(i) for i in rng.permutation(n)[:varying.size]]),
        "variance_selector": fits["variance_selector"],
        "chisq_selector": ChiSqSelectorModel(
            selected=rng.choice(n, n // 4, replace=False)),
    }
    x32 = x[:STAGE_CHECK_ROWS]
    x64 = x[:PIPE_F64_ROWS].astype(np.float64)
    xd = torch.as_tensor(x, device=device)
    timings = []
    for label, stage in stages.items():
        family = label.split(" ")[0]
        prog = PipelineModel(stages=[stage]).serving_transform_program()
        check(prog is not None and prog.device.type == "cuda"
              and prog.dtype == np.float32,
              f"(i) {label}: one-stage program on "
              f"{getattr(prog, 'device', None)}")
        out = prog.fetch(prog.run(prog.put(x32)))
        host = np.asarray(stage.transform(x32).column(stage.getOutputCol()))
        check(out.shape == host.shape, f"(i) {label}: {out.shape} vs "
              f"{host.shape}")
        err32 = float(np.abs(out - host).max() / np.abs(host).max())
        if family in STAGE_EXACT:
            bar32 = 0.0
        elif label == "normalizer p=2":
            bar32 = STAGE_F32_NORM2_RTOL
        else:
            bar32 = STAGE_F32_RTOL
        spec = stage.serving_stage(device=device, dtype=torch.float64)
        prog64 = build_fused_pipeline_program(
            device=device, dtype=torch.float64, stages=[spec],
            precision="native")
        out64 = prog64.fetch(prog64.run(prog64.put(x64)))
        host64 = np.asarray(stage.transform(x64).column(
            stage.getOutputCol()))
        err64 = float(np.abs(out64 - host64).max() / np.abs(host64).max())
        bar64 = STAGE_F64_NORM_RTOL if family == "normalizer" else 0.0
        spec32 = stage.serving_stage(device=device, dtype=torch.float32)
        body = spec32.fn(xd, *spec32.weights)
        ms = time_ms(torch, lambda: spec32.fn(xd, *spec32.weights),
                     STAGE_TIMED)
        moved = xd.nbytes + body.nbytes + sum(w.nbytes
                                              for w in spec32.weights)
        bound_ms = moved / PEAK_BYTES_PER_S * 1e3
        timings.append({"name": label, "algo": spec32.algo, "ms": ms,
                        "bound_ms": bound_ms, "bound_by": "bytes",
                        "out_shape": list(body.shape),
                        "max_rel_err_f32": err32, "max_rel_err_f64": err64})
        log(f"  (i) {label} ({spec32.algo}): float32 {x32.shape[0]:,} rows "
            f"max |Δ| / max |ref| {err32:.3e} (bar {bar32:g}), float64 "
            f"{PIPE_F64_ROWS} rows {err64:.3e} (bar {bar64:g}); body on "
            f"{x.shape[0]:,} rows {ms:.4f} ms (CUDA events, {STAGE_TIMED} "
            f"runs), bound "
            f"{bound_ms:.4f} ms ({moved:,} B at {PEAK_BYTES_PER_S:g} B/s), "
            f"{bound_ms / ms:.3f} of it")
        check(err32 <= bar32, f"(i) {label} float32 {err32:.3e}")
        check(err64 <= bar64, f"(i) {label} float64 {err64:.3e}")
        del body
    del xd
    torch.cuda.empty_cache()
    return timings


def phase_stages(torch, fg, device):
    """Phase 17: the other stage families (models/feature_scalers.py,
    models/feature_transformers.py) on the card, and two chains of them in
    front of PCA served as one fused program each. Returns ({kernel:
    launches}, [stage body timings])."""
    from spark_rapids_ml_tpu_torch import (
        ElementwiseProduct,
        KMeans,
        LogisticRegression,
        MaxAbsScaler,
        MinMaxScaler,
        Normalizer,
        PCA,
        Pipeline,
        PipelineModel,
        RobustScaler,
        VarianceThresholdSelector,
        VectorSlicer,
    )
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.models._serving import run_staged_pipeline
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        ServeEngine,
        start_serve_server,
        wire,
    )
    from spark_rapids_ml_tpu_torch.serve.registry import _infer_features

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    default, highest = fg.kernel_name(None), fg.kernel_name("highest")
    launched = {}

    def add(counts):
        for name, count in counts.items():
            launched[name] = launched.get(name, 0) + count

    x, varying = planted_rows(torch, device)
    n = x.shape[1]
    kept = varying.size
    log(f"  {x.shape[0]:,} x {n} float32 rows (fit (c)'s), every "
        f"{STAGE_CONSTANT_EVERY}th column set to {STAGE_CONSTANT}: "
        f"{n - kept} constant columns")

    # (ii) and (iii): the two chains, fitted with the launch counts read;
    # their head stages serve (i) too (fitted on the same rows)
    rng = np.random.default_rng(SEED + 1701)
    scaling = rng.standard_normal(n)
    indices = [int(i) for i in rng.permutation(n)[:kept]]
    # labels planted on the rows the classifier's PCA sees: MinMax is
    # affine per column and ElementwiseProduct a per-column scale, so once
    # standardized those rows are the sliced columns (up to sign)
    seen = x[:, indices].astype(np.float64)
    sd = seen.std(axis=0, ddof=1)
    seen = (seen - seen.mean(axis=0)) / np.where(sd > 0, sd, 1.0)
    w_star = rng.normal(scale=LR_SCALE / np.sqrt(kept), size=kept)
    z = seen @ w_star + LR_INTERCEPT
    del seen
    y = (rng.random(z.shape[0]) < 1.0 / (1.0 + np.exp(-z))).astype(
        np.float64)
    chains = {
        "classifier": (Pipeline([
            MinMaxScaler().setOutputCol("boxed"),
            ElementwiseProduct(scalingVec=scaling.tolist())
            .setInputCol("boxed").setOutputCol("weighted"),
            VectorSlicer(indices=indices).setInputCol("weighted")
            .setOutputCol("sliced"),
            PCA().setK(K).setInputCol("sliced").setOutputCol("reduced"),
            LogisticRegression().setInputCol("reduced"),
        ]), VectorFrame({"features": x, "label": y}),
            lambda p: {default: 1, highest: p.stages[4].n_iter_}),
        "clustering": (Pipeline([
            RobustScaler().setWithCentering(True).setOutputCol("robust"),
            MaxAbsScaler().setInputCol("robust").setOutputCol("boxed"),
            Normalizer().setInputCol("boxed").setOutputCol("normed"),
            VarianceThresholdSelector().setInputCol("normed")
            .setOutputCol("selected"),
            PCA().setK(K).setInputCol("selected").setOutputCol("reduced"),
            KMeans().setK(CLUSTER_K).setInputCol("reduced"),
        ]), x, {default: 1}),
    }
    registry = ModelRegistry()
    fitted = {}
    for name, (pipeline, data, expected) in chains.items():
        label = "(ii)" if name == "classifier" else "(iii)"
        t0 = time.perf_counter()
        pipe, counts = counted_run(
            torch, fg, f"{label} the {name} chain "
            f"{[type(s).__name__ for s in pipeline.getStages()]}.fit on "
            f"{x.shape[0]:,} x {n}", lambda: pipeline.fit(data), expected)
        add(counts)
        log(f"    {name} chain fit {time.perf_counter() - t0:.3f} s; stage "
            f"fit_timings_ "
            f"{[{k: round(t, 3) for k, t in getattr(s, 'fit_timings_', {}).items()} for s in pipe.stages]}")
        if name == "classifier":
            log(f"    LogisticRegression n_iter {pipe.stages[4].n_iter_}")
        else:
            kept_chain = pipe.stages[3].selected_features.size
            log(f"    RobustScaler fit {pipe.stages[0].fit_timings_['fit']:.3f} "
                f"s (exact np.nanquantile); the selector keeps {kept_chain} "
                f"columns")
            check(kept_chain == kept, f"(iii) the selector keeps "
                  f"{kept_chain}, expected {kept}")
        with tempfile.TemporaryDirectory() as tmp:
            pipe.save(f"{tmp}/{name}")
            registry.load(name, f"{tmp}/{name}")
        loaded = registry.resolve(name)
        check([type(s).__name__ for s in loaded.stages]
              == [type(s).__name__ for s in pipe.stages]
              and all(same_state(a, b) for a, b in zip(loaded.stages,
                                                       pipe.stages)),
              f"{label} the loaded {name} chain")
        check(_infer_features(loaded) == n, f"{label} {name}: inferred "
              f"{_infer_features(loaded)} features")
        fitted[name] = loaded
    log(f"  (ii)-(iii) fits, saves and loads: "
        f"{time.perf_counter() - t_phase:.1f} s into the phase")

    # (i) each family's body: the chains' MinMax and Robust heads, and
    # MaxAbs and the variance selector fitted on the raw rows
    fits = {"min_max_scaler": fitted["classifier"].stages[0],
            "robust_scaler": fitted["clustering"].stages[0]}
    for label, est in (("max_abs_scaler", MaxAbsScaler()),
                       ("variance_selector", VarianceThresholdSelector())):
        fits[label], _ = counted_run(torch, fg, f"(i) {label} fit",
                                     lambda: est.fit(x), {})
    selected = fits["variance_selector"].selected_features
    check(np.array_equal(selected, varying), f"(i) the variance selector "
          f"kept {selected.size} columns, not the {kept} varying ones")
    t0 = time.perf_counter()
    timings = stage_bodies(torch, device, x, varying, fits)
    log(f"  (i) {len(timings)} bodies checked and timed: "
        f"{time.perf_counter() - t0:.1f} s")
    del x, y, z
    metrics = get_registry()
    traffic = serve_traffic()
    rows_all = np.concatenate(traffic)
    engine = ServeEngine(registry, max_batch_rows=SERVE_MAX_ROWS,
                         pipeline_depth=2)
    server = None
    try:
        for name in chains:
            report = engine.warmup(name)  # no n_features: the head gives it
            spec = engine._async_specs[(name, 1)]
            check("pipeline" in report and spec is not None
                  and spec.algo == "pipeline",
                  f"{name}: no fused program after warmup")
        server = start_serve_server(engine, port=0, addr="127.0.0.1")
        port = server.server_address[1]
        for name, loaded in fitted.items():
            label = "(ii)" if name == "classifier" else "(iii)"
            bodies = [(i, wire.encode_request(name, rows),
                       wire.BINARY_CONTENT_TYPE)
                      for i, rows in enumerate(traffic)]
            before = serve_counters(metrics)
            results, wall = http_clients(port, bodies)
            delta = {k: v - before[k]
                     for k, v in serve_counters(metrics).items()}
            check(len(results) == SERVE_REQUESTS, f"{len(results)} {name} "
                  f"responses")
            want = np.float64 if name == "classifier" else np.int32
            served, unequal = [], 0
            for i in sorted(results):
                _, status, _, data = results[i]
                check(status == 200, f"{name} request {i}: HTTP {status}")
                out = wire.decode_response(data)
                check(out.dtype == want and out.shape == (len(traffic[i]),)
                      and np.isfinite(out).all(),
                      f"{name} request {i}: {out.dtype} {out.shape}")
                unequal += not np.array_equal(
                    out, run_staged_pipeline(loaded, traffic[i]))
                served.append(out)
            lat = np.asarray([results[i][0] * 1e3 for i in sorted(results)])
            log(f"  {label} {SERVE_REQUESTS} binary requests "
                f"({rows_all.shape[0]} rows) to {name!r} over HTTP from "
                f"{SERVE_CLIENTS} clients in {wall:.3f} s: "
                f"{SERVE_REQUESTS / wall:.1f} requests/s, "
                f"{rows_all.shape[0] / wall:.0f} rows/s; client p50 "
                f"{np.percentile(lat, 50):.2f} ms, p99 "
                f"{np.percentile(lat, 99):.2f} ms; {delta['batches']:.0f} "
                f"batches; responses unequal to run_staged_pipeline on "
                f"their rows: {unequal}; {smi}")
            check(unequal == 0, f"{unequal} {name} responses differ from "
                  f"run_staged_pipeline")
            check(delta["runs_cuda"] == delta["batches"] > 0
                  and delta["errors"] == delta["degraded"]
                  == delta["retries"] == 0, f"{name}: counters {delta}")
            served = np.concatenate(served)
            f64 = PipelineModel(stages=[
                s.copy({"dtype": "float64"}) if s.has_param("dtype") else s
                for s in loaded.stages])
            prog64 = f64.serving_transform_program()
            sample = rows_all[:PIPE_F64_ROWS]
            fused64 = prog64.fetch(prog64.run(prog64.put(sample)))
            # the frame loop densifies every stage's output to float64 on
            # the host: on the first STAGE_FRAME_ROWS served rows
            framed, served = rows_all[:STAGE_FRAME_ROWS], \
                served[:STAGE_FRAME_ROWS]
            t0 = time.perf_counter()
            if name == "classifier":
                frame = np.asarray(loaded.transform(framed).column(
                    "probability"))
                d32 = float(np.abs(served - frame).max())
                d64 = float(np.abs(fused64 - np.asarray(
                    f64.transform(sample).column("probability"))).max())
                bars = (CHAIN_F32_ATOL, CHAIN_F64_ATOL)
                what = "probabilities max |Δ|"
            else:
                frame = km_labels(loaded, framed)
                d32 = float(np.mean(served != frame))
                d64 = float(np.mean(fused64 != km_labels(f64, sample)))
                bars = (PIPE_MISMATCH, 0.0)
                what = "label mismatch"
            log(f"  {label} {what} vs PipelineModel.transform on the first "
                f"{framed.shape[0]} served rows {d32:.3e} "
                f"(bar {bars[0]:g}; the frame loop "
                f"{time.perf_counter() - t0:.2f} s), every stage at float64 "
                f"on {PIPE_F64_ROWS} rows {d64:.3e} (bar {bars[1]:g})")
            check(d32 <= bars[0], f"{name} vs the frame loop {d32:.3e}")
            check(d64 <= bars[1], f"{name} at float64 {d64:.3e}")
            copies_per_batch(torch, engine, metrics, name, traffic, label)
        log(f"  (ii)-(iii) served: {time.perf_counter() - t_phase:.1f} s "
            f"into the phase")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        engine.shutdown()

    # (iv) both chains' reduced ladders through the offline check
    for name, loaded in fitted.items():
        only = ModelRegistry()
        only.register(name, loaded)
        for precision in ("bf16", "int8"):
            engine = ServeEngine(only, max_batch_rows=SERVE_MAX_ROWS,
                                 pipeline_depth=2, precision=precision)
            try:
                engine.warmup(name)
                checked = engine.precision_checks[(name, 1, precision)]
                serving = engine.stats()["queues"][f"{name}@1"]["precision"]
                log(f"  (iv) {name} {precision}: offline check error "
                    f"{checked['error']}, verdict {checked['verdict']} (bar "
                    f"{checked['bar']:g}), serves {serving}")
                check(checked["verdict"] in ("pass", "fail"),
                      f"(iv) {name} {precision} check ended "
                      f"{checked['verdict']}")
                check(checked["verdict"] == "pass" or serving == "native",
                      f"(iv) a refused {precision} ladder serves {serving}")
            finally:
                engine.shutdown()
    torch.cuda.empty_cache()
    log(f"  phase 17 launches {launched}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched, timings


# -- phase 18: LinearSVC and GeneralizedLinearRegression -----------------------

SVC_NOISE = 1.0            # sd of ε in the labels 1[x·w* + 0.5 + ε > 0]
SVC_STREAM_ITER = 3        # Newton passes of the streamed fit (cut)
GLM_SCALE = 0.5            # sd of the planted η: w* ~ N(0, GLM_SCALE²/n)
GLM_INTERCEPT = 0.5
GLM_STREAM_ITER = 2        # IRLS passes of the streamed and one-rank fits
                           # (cut), + 1 for the final deviance
GLM_NARROW = 512           # (iii)'s width: the first 512 columns
GLM_SERVED = 32            # requests of at most SERVE_JSON_MAX_ROWS rows
# bars, set in PERF.md §2 before the first run
SVC_RTOL = 1e-4            # every LinearSVC route vs float64 Newton
SVC_DIST_RTOL = 1e-6       # one NCCL rank, against the one-shot fit
GLM_RTOL = 1e-4            # every GLM fit vs the same IRLS in float64
GLM_STREAM_RTOL = 1e-5     # streamed vs the in-memory fit at the same cut
GLM_DIST_RTOL = 1e-6       # one NCCL rank, against the in-memory fit at
                           # the same cut
SERVED_RTOL = 1e-5         # margins (of ‖x‖·‖w‖ + |b|) and μ served vs the
                           # float64 host product


class WallSplit:
    """A wall split on the host clock: each of ``targets`` ((module,
    attribute, name) triples) timed between two synchronisations of the
    card while the context is open, its calls counted and its last result
    kept. By default a fit's split: the Gram launches, the device solves
    (``_cho_solve``), the host solves (``np.linalg.solve``) and the host →
    device copies (``torch.as_tensor`` of a host array onto the card)."""

    def __init__(self, torch, targets=None):
        if targets is None:
            from spark_rapids_ml_tpu_torch.ops import covariance as cov_ops
            from spark_rapids_ml_tpu_torch.ops import svm_kernel

            targets = ((cov_ops, "fused_centered_gram", "gram"),
                       (svm_kernel, "_cho_solve", "device solve"),
                       (np.linalg, "solve", "host solve"),
                       (torch, "as_tensor", "h2d"))
        self.torch = torch
        self.targets = targets
        self.seconds = {name: 0.0 for _, _, name in self.targets}
        self.calls = {name: 0 for _, _, name in self.targets}
        self.last = {}

    def _timed(self, real, name):
        torch = self.torch

        def wrapper(*args, **kwargs):
            if name == "h2d" and not (
                    isinstance(args[0], np.ndarray)
                    and str(kwargs.get("device", "cpu")).startswith("cuda")):
                return real(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            self.last[name] = out
            return out

        return wrapper

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr))
                      for mod, attr, _ in self.targets]
        for (mod, attr, real), (_, _, name) in zip(self.saved, self.targets):
            setattr(mod, attr, self._timed(real, name))
        return self

    def __exit__(self, *exc):
        for mod, attr, real in self.saved:
            setattr(mod, attr, real)

    def line(self, wall) -> str:
        parts = [f"{name} {self.seconds[name]:.3f} s ({self.calls[name]})"
                 for name in self.seconds if self.calls[name]]
        rest = wall - sum(self.seconds.values())
        return "split " + ", ".join(parts + [f"the rest {rest:.3f} s"])


def split_run(torch, fg, label, fn, expected):
    """``counted_run`` with the wall split: (result, counts, wall seconds,
    the split's line)."""
    t0 = time.perf_counter()
    with WallSplit(torch) as split:
        result, counts = counted_run(torch, fg, label, fn, expected)
    wall = time.perf_counter() - t0
    return result, counts, wall, split.line(wall)


def svc64(torch, x, y, weights=None, fit_intercept=True, max_iter=100):
    """The oracle: the port's generalized Newton (``svc_fit_kernel``) on
    float64 tensors on the card, which never reaches the kernel. Returns
    ((coefficients, intercept), n_iter)."""
    from spark_rapids_ml_tpu_torch.ops.svm_kernel import svc_fit_kernel

    dev = x.device
    result = svc_fit_kernel(
        x.double(), torch.as_tensor(y, device=dev).double(),
        None if weights is None else torch.as_tensor(weights, device=dev),
        fit_intercept=fit_intercept, max_iter=max_iter)
    return ((result.coefficients.cpu().numpy(), float(result.intercept)),
            int(result.n_iter))


def glm_line(model, seconds) -> str:
    stopped = ("converged" if model.num_iterations_ < model.getMaxIter()
               else "ran to maxIter")
    return (f"{seconds:.3f} s, {model.num_iterations_} iterations "
            f"({stopped}), deviance {model.deviance_:.6f}")


def glm_passes(kernel, buckets=1):
    """Expected launches of a float32 GLM fit: one per bucket and pass, the
    passes its iterations and, at maxIter, the final deviance's."""
    def expected(model):
        n = model.num_iterations_
        return {kernel: buckets * (n + (n == model.getMaxIter()))}
    return expected


def tweedie_draws(rng, mu, p, phi=1.0):
    """Tweedie(μ, φ, p), 1 < p < 2: a Poisson number of Gamma jumps."""
    lam = mu ** (2.0 - p) / (phi * (2.0 - p))
    alpha = (2.0 - p) / (p - 1.0)
    gamma = phi * (p - 1.0) * mu ** (p - 1.0)
    n = rng.poisson(lam)
    return np.where(n > 0, rng.gamma(np.maximum(n * alpha, 1e-12), gamma),
                    0.0)


def phase_linear_models(torch, fg, device):
    """Phase 18: LinearSVC and GeneralizedLinearRegression at 4096 features
    (and the GLM grid at 512) through their entry points, every float32
    Newton Hessian and IRLS XᵀWX on the kernel; the models saved, loaded
    and served. Returns ({kernel: launches}, {label: Hessian timings})."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch import (
        GeneralizedLinearRegression,
        LinearSVC,
    )
    from spark_rapids_ml_tpu_torch.data.batches import auto_batch_rows
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.io.persistence import load_model
    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.ops.glm_kernel import link_funcs
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_glm_fit,
        distributed_svc_fit,
        initialize_multihost,
    )
    from spark_rapids_ml_tpu_torch.serve import ModelRegistry, ServeEngine

    t_phase = time.perf_counter()
    highest = fg.kernel_name("highest")
    launched, shapes, models = {}, {}, {}
    n = N_FEATURES

    def add(counts):
        for name, count in counts.items():
            launched[name] = launched.get(name, 0) + count

    def per_iter(factor=1):
        return lambda m: {highest: factor * m.n_iter_} if m.n_iter_ else {}

    # (i) LinearSVC at full width
    rng = np.random.default_rng(SEED + 1800)
    w_star = rng.normal(scale=LR_SCALE / np.sqrt(n), size=n)
    x_dev = logreg_design(torch, device, 0)
    x = x_dev.cpu().numpy()

    def svc_labels(xd):
        z = planted_logits(torch, xd, w_star, LR_INTERCEPT)
        return (z + rng.normal(scale=SVC_NOISE, size=z.shape[0])
                > 0).astype(np.float32)

    y = svc_labels(x_dev)
    weights = rng.uniform(0.5, 2.0, CHUNK_ROWS)
    sd = x.std(axis=0, ddof=1, dtype=np.float64)
    log(f"  (i) {CHUNK_ROWS:,} x {n} N(0, 1) rows (phase 14's design), "
        f"labels 1[x·w* + {LR_INTERCEPT} + ε > 0], w* ~ N(0, "
        f"{LR_SCALE:g}²/{n}), ε ~ N(0, {SVC_NOISE:g}²): {y.mean():.4f} "
        f"positive")
    fits = {}
    for label, est, data, oracle in (
            ("one-shot", LinearSVC().setStandardization(False), (x, y),
             lambda: svc64(torch, x_dev, y)),
            ("weighted", LinearSVC().setStandardization(False)
             .setWeightCol("w"),
             (VectorFrame({"features": x, "label": y, "w": weights}),),
             lambda: svc64(torch, x_dev, y, weights=weights)),
            ("no intercept", LinearSVC().setStandardization(False)
             .setFitIntercept(False), (x, y),
             lambda: svc64(torch, x_dev, y, fit_intercept=False)),
            ("standardization", LinearSVC(), (x, y),
             lambda: svc64(torch, x_dev / torch.as_tensor(
                 sd, device=device), y))):
        model, counts, wall, split = split_run(
            torch, fg, f"(i) LinearSVC {label}", lambda: est.fit(*data),
            per_iter())
        add(counts)
        (want_w, want_b), oracle_iter = oracle()
        if label == "standardization":
            want_w = want_w / sd
        err = linreg_error(model.coefficients, model.intercept,
                           (want_w, want_b))
        log(f"    {label}: {fit_line(model, wall)}; {split}; rel err vs "
            f"float64 Newton on the card {err:.3e} (bar {SVC_RTOL:g}; "
            f"oracle n_iter {oracle_iter})")
        check(np.isfinite(model.coefficients).all(), f"{label} finite")
        check(err <= SVC_RTOL, f"LinearSVC {label} rel err {err:.3e}")
        fits[label] = model
        models[f"svc {label}"] = model
    margin = 1.0 - (2.0 * torch.as_tensor(y, device=device) - 1.0) * (
        x_dev @ torch.as_tensor(fits["one-shot"].coefficients,
                                dtype=torch.float32, device=device)
        + fits["one-shot"].intercept)
    active = (margin > 0).float()
    log(f"    one-shot active set at the solution: {int(active.sum())} of "
        f"{CHUNK_ROWS} rows")
    shapes["svc Hessian, s = 1 (phase 18)"] = hessian_shape(
        torch, fg, "LinearSVC first", x_dev,
        torch.ones(CHUNK_ROWS, device=device))
    shapes["svc Hessian, s = the active set (phase 18)"] = hessian_shape(
        torch, fg, "LinearSVC last (s = its active set)", x_dev, active)
    del margin, active

    # streamed: 4 chunks of 65,536 rows, buckets of auto_batch_rows(4096)
    chunks = [(x, y)]
    for i in range(1, LR_CHUNKS):
        xi = logreg_design(torch, device, i)
        chunks.append((xi.cpu().numpy(), svc_labels(xi)))
        del xi
    bucket = auto_batch_rows(n)
    buckets = -(-LR_CHUNKS * CHUNK_ROWS // bucket)
    model, counts, wall, split = split_run(
        torch, fg, f"(i) LinearSVC streamed, {LR_CHUNKS} chunks of "
        f"{CHUNK_ROWS:,} ({buckets} buckets of {bucket} rows), maxIter "
        f"{SVC_STREAM_ITER}",
        lambda: LinearSVC().setStandardization(False).setMaxIter(
            SVC_STREAM_ITER).fit(lambda: iter(chunks)), per_iter(buckets))
    add(counts)
    x_all = torch.cat([torch.as_tensor(c[0], device=device) for c in chunks])
    want, oracle_iter = svc64(torch, x_all, np.concatenate(
        [c[1] for c in chunks]), max_iter=SVC_STREAM_ITER)
    del x_all
    torch.cuda.empty_cache()
    err = linreg_error(model.coefficients, model.intercept, want)
    log(f"    streamed: {fit_line(model, wall)}; {split}; rel err vs "
        f"float64 Newton on the {LR_CHUNKS * CHUNK_ROWS:,} rows at maxIter "
        f"{SVC_STREAM_ITER} {err:.3e} (bar {SVC_RTOL:g}; oracle n_iter "
        f"{oracle_iter})")
    check(err <= SVC_RTOL, f"streamed LinearSVC rel err {err:.3e}")
    models["svc streamed"] = model
    del chunks

    # (ii) GLM Poisson / log at full width
    w_glm = rng.normal(scale=GLM_SCALE / np.sqrt(n), size=n)
    eta = planted_logits(torch, x_dev, w_glm, GLM_INTERCEPT)
    counts_y = rng.poisson(np.exp(eta)).astype(np.float32)
    offset = rng.normal(scale=0.1, size=CHUNK_ROWS)
    counts_o = rng.poisson(np.exp(eta + offset)).astype(np.float32)
    log(f"  (ii) Poisson labels at {n} features, η = x·w* + "
        f"{GLM_INTERCEPT}, w* ~ N(0, {GLM_SCALE:g}²/{n}): mean "
        f"{counts_y.mean():.4f}; with an offset ~ N(0, 0.1²) and weights "
        f"~ U(0.5, 2)")
    poisson = GeneralizedLinearRegression(family="poisson")
    weighted = GeneralizedLinearRegression(family="poisson").setWeightCol(
        "w").setOffsetCol("off")
    frame_o = VectorFrame({"features": x, "label": counts_o, "w": weights,
                           "off": offset})
    for label, est, data in (
            ("one-shot", poisson, (x,)),
            ("weights and offset", weighted, (frame_o,))):
        kw = {"labels": counts_y} if label == "one-shot" else {}
        model, counts, wall, split = split_run(
            torch, fg, f"(ii) GLM Poisson {label}",
            lambda: est.fit(*data, **kw), glm_passes(highest))
        add(counts)
        f64, _, _, split64 = split_run(
            torch, fg, "(ii) the same fit at float64 (no kernel)",
            lambda: est.copy({"dtype": "float64"}).fit(*data, **kw), {})
        err = linreg_error(model.coefficients, model.intercept,
                           (f64.coefficients, f64.intercept))
        log(f"    {label}: {glm_line(model, wall)}; {split}; float64: "
            f"{f64.num_iterations_} iterations, deviance "
            f"{f64.deviance_:.6f}, {split64}; rel err {err:.3e} (bar "
            f"{GLM_RTOL:g})")
        check(np.isfinite(model.coefficients).all(), f"GLM {label} finite")
        check(err <= GLM_RTOL, f"GLM Poisson {label} rel err {err:.3e}")
        models[f"glm poisson {label}"] = model
    mu0 = torch.as_tensor(counts_y + 0.1, device=device)
    shapes["glm XᵀWX, W = μ from mustart (phase 18)"] = hessian_shape(
        torch, fg, "GLM Poisson first (W = μ₀ = y + 0.1)", x_dev,
        torch.sqrt(mu0))
    del mu0

    # streamed at a cut maxIter, against the in-memory fit at the same cut
    gchunks = [(x[i:i + CHUNK_ROWS // 4], counts_y[i:i + CHUNK_ROWS // 4])
               for i in range(0, CHUNK_ROWS, CHUNK_ROWS // 4)]
    g_buckets = -(-CHUNK_ROWS // bucket)
    cut = GeneralizedLinearRegression(family="poisson").setMaxIter(
        GLM_STREAM_ITER)
    model, counts, wall, split = split_run(
        torch, fg, f"(ii) GLM Poisson streamed, 4 chunks of "
        f"{CHUNK_ROWS // 4:,} ({g_buckets} buckets of {bucket} rows), "
        f"maxIter {GLM_STREAM_ITER}",
        lambda: cut.fit(lambda: iter(gchunks)),
        glm_passes(highest, g_buckets))
    add(counts)
    memory, counts, _, _ = split_run(
        torch, fg, "(ii) the same fit in memory", lambda: cut.fit(
            x, labels=counts_y), glm_passes(highest))
    add(counts)
    err = linreg_error(model.coefficients, model.intercept,
                       (memory.coefficients, memory.intercept))
    log(f"    streamed: {glm_line(model, wall)}; {split}; rel err vs "
        f"the in-memory fit at maxIter {GLM_STREAM_ITER} {err:.3e} (bar "
        f"{GLM_STREAM_RTOL:g})")
    check(err <= GLM_STREAM_RTOL, f"streamed GLM rel err {err:.3e}")
    models["glm poisson streamed"] = model
    del gchunks

    # distributed_svc_fit and distributed_glm_fit on one NCCL rank
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    coordinator = f"127.0.0.1:{free_port()}"
    try:
        initialize_multihost(coordinator, num_processes=1, process_id=0)
    except Exception as exc:
        raise RuntimeError(f"phase 18: the one-rank NCCL world did not "
                           f"start at {coordinator}: {exc!r}") from exc
    try:
        check(dist.get_backend() == "nccl", "the card's world runs NCCL")
        result, counts, wall, split = split_run(
            torch, fg, "(i) distributed_svc_fit, one NCCL rank",
            lambda: distributed_svc_fit(x, y, data_mesh(1)),
            lambda r: {highest: int(r.n_iter)})
        add(counts)
        n_iter = int(result.n_iter)
        one_shot = fits["one-shot"]
        err = linreg_error(result.coefficients.cpu().numpy(),
                           float(result.intercept),
                           (one_shot.coefficients, one_shot.intercept))
        report = result.fit_report_
        step = fitmon.get_fit_monitor().recent_runs()[0].steps[-1]
        log(f"    distributed_svc_fit: {wall:.3f} s, n_iter {n_iter}, "
            f"converged {bool(result.converged)}; {split}; vs the one-shot "
            f"fit: rel "
            f"err {err:.3e} (bar {SVC_DIST_RTOL:g}); collectives "
            f"{report.collectives}; fit monitor step {step['step']!r} "
            f"scalars {step['scalars']}")
        check(err <= SVC_DIST_RTOL, f"distributed_svc_fit rel err {err:.3e}")
        check(step["step"] == "newton"
              and step["scalars"] == {"n_iter": float(n_iter),
                                      "converged": float(result.converged)},
              f"fit monitor step {step}")
        d = n + 1
        check(report.collectives == {"all_reduce": {
            "count": n_iter, "bytes": (d * d + d) * 4 * n_iter}},
            f"distributed_svc_fit collectives {report.collectives}")
        dist_glm, counts, wall, split = split_run(
            torch, fg, f"(ii) distributed_glm_fit Poisson, one NCCL rank, "
            f"maxIter {GLM_STREAM_ITER}",
            lambda: distributed_glm_fit(x, counts_y, data_mesh(1),
                                        family="poisson",
                                        max_iter=GLM_STREAM_ITER),
            glm_passes(highest))
        add(counts)
        err = linreg_error(dist_glm.coefficients, dist_glm.intercept,
                           (memory.coefficients, memory.intercept))
        report = dist_glm.fit_report_
        run = fitmon.get_fit_monitor().recent_runs()[0]
        passes = counts[highest]
        log(f"    distributed_glm_fit: {glm_line(dist_glm, wall)}; "
            f"{split}; vs the in-memory fit at maxIter {GLM_STREAM_ITER}: "
            f"rel err {err:.3e} (bar "
            f"{GLM_DIST_RTOL:g}); collectives {report.collectives}; fit "
            f"monitor steps {[s['step'] for s in run.steps]}")
        check(err <= GLM_DIST_RTOL, f"distributed_glm_fit rel err {err:.3e}")
        check([s["step"] for s in run.steps] == ["irls_pass"] * passes,
              f"fit monitor steps {[s['step'] for s in run.steps]}")
        check(report.collectives == {"all_reduce": {
            "count": passes, "bytes": (n * n + n + 6) * 4 * passes}},
            f"distributed_glm_fit collectives {report.collectives}")
        models["glm poisson one rank"] = dist_glm
    finally:
        dist.destroy_process_group()

    # (iii) the GLM grid at 512 features
    ns = GLM_NARROW
    x_n = x_dev[:, :ns].contiguous()
    xs = x_n.cpu().numpy()
    w_n = rng.normal(scale=1.0 / np.sqrt(ns), size=ns)
    eta_n = planted_logits(torch, x_n, w_n, 0.0)
    mu_n = np.exp(0.3 * eta_n + GLM_INTERCEPT)
    grid = (
        ("gamma / log", GeneralizedLinearRegression(family="gamma")
         .setLink("log"), rng.gamma(5.0, mu_n / 5.0)),
        ("tweedie p = 1.5 / log", GeneralizedLinearRegression(
            family="tweedie").setVariancePower(1.5).setLinkPower(0.0),
         tweedie_draws(rng, mu_n, 1.5)),
        ("binomial / probit", GeneralizedLinearRegression(
            family="binomial").setLink("probit"),
         (rng.random(CHUNK_ROWS) < torch.special.ndtr(
             torch.as_tensor(eta_n)).numpy()).astype(np.float64)),
        ("gaussian / identity", GeneralizedLinearRegression(),
         eta_n + GLM_INTERCEPT + rng.normal(size=CHUNK_ROWS)),
    )
    log(f"  (iii) the GLM grid at {ns} features (the first {ns} columns)")
    for label, est, labels in grid:
        labels = labels.astype(np.float32)
        model, counts, wall, split = split_run(
            torch, fg, f"(iii) GLM {label}",
            lambda: est.fit(xs, labels=labels), glm_passes(highest))
        add(counts)
        f64, _, _, _ = split_run(
            torch, fg, "(iii) the same fit at float64 (no kernel)",
            lambda: est.copy({"dtype": "float64"}).fit(xs, labels=labels),
            {})
        err = linreg_error(model.coefficients, model.intercept,
                           (f64.coefficients, f64.intercept))
        log(f"    {label}: {glm_line(model, wall)}; {split}; float64 "
            f"{f64.num_iterations_} iterations; rel err {err:.3e} (bar "
            f"{GLM_RTOL:g})")
        check(np.isfinite(model.coefficients).all(), f"GLM {label} finite")
        check(err <= GLM_RTOL, f"GLM {label} rel err {err:.3e}")
        models[f"glm {label}"] = model
    del x_n, x_dev
    torch.cuda.empty_cache()

    # save → load (load_model and ModelRegistry) → serve on the host path
    traffic = serve_traffic()
    small = [t for t in traffic
             if t.shape[0] <= SERVE_JSON_MAX_ROWS][:GLM_SERVED]
    check(len(small) == GLM_SERVED, f"{len(small)} small requests")
    registry = ModelRegistry()
    names = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, model) in enumerate(models.items()):
            path = f"{tmp}/m{i}"
            model.save(path)
            back = load_model(path)
            check(type(back) is type(model)
                  and np.array_equal(back.coefficients, model.coefficients)
                  and back.intercept == model.intercept,
                  f"{label}: load_model")
            names[label] = f"m{i}"
            registry.load(f"m{i}", path)
    engine = ServeEngine(registry, max_batch_rows=SERVE_MAX_ROWS,
                         pipeline_depth=2)
    worst = {}
    try:
        for label, model in models.items():
            name = names[label]
            loaded = registry.resolve(name)
            check(np.array_equal(loaded.coefficients, model.coefficients),
                  f"{label}: ModelRegistry.load")
            if model.get_or_default("offsetCol") if label.startswith(
                    "glm") else False:
                continue   # its rows must carry the offset: not a matrix
            width = model.coefficients.shape[0]
            for rows in small:
                rows = np.ascontiguousarray(rows[:, :width])
                served = np.asarray(engine.predict(name, rows))
                ref = rows.astype(np.float64) @ model.coefficients \
                    + model.intercept
                if label.startswith("svc"):
                    check(np.array_equal(served, (ref > 0).astype(
                        np.float64)), f"{label}: served labels")
                    # a margin can lie as near 0 as it likes: its error is
                    # taken against the dot product's scale ‖x‖·‖w‖ + |b|
                    got = loaded.decision_function(rows)
                    scale = np.linalg.norm(rows.astype(np.float64), axis=1) \
                        * np.linalg.norm(model.coefficients) \
                        + abs(model.intercept)
                    err = float(np.max(np.abs(got - ref) / scale))
                else:
                    _, link, _, lp = model._resolved_family_link()
                    mu = link_funcs(link, lp)[1](np, ref)
                    err = float(np.max(np.abs(served - mu) / np.abs(mu)))
                worst[label] = max(worst.get(label, 0.0), err)
        log(f"  saved and loaded (load_model, ModelRegistry) "
            f"{len(models)} models; served {len(worst)} (the offset model "
            f"needs its column) {GLM_SERVED} requests of ≤ "
            f"{SERVE_JSON_MAX_ROWS} rows each ({sum(len(t) for t in small)} "
            f"rows) through ServeEngine's host path: labels equal; max "
            f"relative error of margins / μ vs the float64 host product "
            f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } (bar "
            f"{SERVED_RTOL:g})")
        for label, err in worst.items():
            check(err <= SERVED_RTOL, f"{label}: served rel err {err:.3e}")
    finally:
        engine.shutdown()
    log(f"  phase 18 launches {launched}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched, shapes


# -- phase 19: NearestNeighbors and DBSCAN --------------------------------------

NN_ITEMS = 1_000_000       # SIFT1M's shape: 1,000,000 × 128 float32
NN_DIM = 128
NN_QUERIES = 10_000
NN_K = 10                  # the ANN-benchmarks default
NN_BLOBS = 1024
NN_CENTRE_SD = 0.5         # blob centres N(0, 0.5²) per coordinate, σ = 1
NN_HOST_QUERIES = 256      # held against _host_kneighbors
NN_OTHER_STEP = 97         # another chunking of the same queries
NN_TIMED = 5               # CUDA-event runs of one chunk, after 3 warm-up
NN_NPROBES = (8, 32)
NN_REFINE = (2.0, 0.0)
NN_CPU_QUERIES = 256       # the card-built index searched on the CPU
NN_EXACT_ITEMS = 65_536
NN_EXACT_NLIST = 64
NN_EXACT_QUERIES = 1024    # (cut from 10,000)
NN_SAVE_ITEMS = 16_384     # the saved model (cut: a JSON payload)
NN_PQ_M = 32               # auto pqM at 128 features: dsub 4
# bars, set in PERF.md §2 before the first run
NN_TIE_RTOL = 1e-5         # float64 k-th and (k+1)-th within: a near-tie
NN_DIST_RTOL = 1e-5        # distances vs float64 on the card
PQ_RERANK_SLACK = 1e-9     # re-rank recall ≥ recall without − this
PQ_NPROBE_SLACK = 0.05     # recall at nprobe 32 ≥ recall at 8 − this
DB_BLOBS = 64
DB_DIM = 16
DB_NOISE = 0.02            # of the rows, uniform on the lattice
DB_ROWS = 131_072
DB_DENSE_ROWS = 16_384     # the dense kernel's envelope
DB_BLOCK = 4096
DB_MIN_PTS = 10
DB_CENTRE_SD = 10.0        # blob centres N(0, 10²), rounded to integers
DB_NOISE_BOX = 40.0
# coordinates are multiples of 1/4, so every d² is a multiple of 1/16,
# exact in float32 and float64; ε² lies 1/32 from the nearest level
DB_EPS = float(np.sqrt(20.0 + 1.0 / 32.0))


def nn_data(torch, device):
    """(items, queries), float32 numpy: 1024 Gaussian blobs (centres
    N(0, NN_CENTRE_SD²), σ = 1) made on the card from the seed; the
    queries are fresh draws from the same blobs."""
    g = torch.Generator(device=device).manual_seed(SEED + 1900)
    centres = NN_CENTRE_SD * torch.randn(NN_BLOBS, NN_DIM, generator=g,
                                         device=device)

    def draw(rows):
        which = torch.randint(0, NN_BLOBS, (rows,), generator=g,
                              device=device)
        return (centres[which] + torch.randn(rows, NN_DIM, generator=g,
                                             device=device)).cpu().numpy()

    return draw(NN_ITEMS), draw(NN_QUERIES)


def db_data():
    """DB_ROWS lattice rows: 64 blobs in 16 dimensions (integer centres,
    N(0, 1) offsets rounded to 1/4) plus 2 % uniform noise on the lattice,
    shuffled; float32 holds every coordinate exactly."""
    rng = np.random.default_rng(SEED + 1919)
    centres = np.round(rng.normal(scale=DB_CENTRE_SD, size=(DB_BLOBS,
                                                             DB_DIM)))
    n_noise = int(DB_ROWS * DB_NOISE)
    n_blob = DB_ROWS - n_noise
    x = (centres[rng.integers(0, DB_BLOBS, n_blob)]
         + np.round(4 * rng.normal(size=(n_blob, DB_DIM))) / 4)
    noise = np.round(4 * rng.uniform(-DB_NOISE_BOX, DB_NOISE_BOX,
                                     size=(n_noise, DB_DIM))) / 4
    return np.concatenate([x, noise])[rng.permutation(DB_ROWS)].astype(
        np.float32)


class SweepCounter:
    """Counts and times DBSCAN's propagation sweeps (``dbscan_kernel.
    _propagate``'s ``neighbor_min`` calls) while the context is open."""

    def __init__(self, torch, dbscan_kernel):
        self.torch, self.module = torch, dbscan_kernel
        self.sweeps, self.seconds = 0, 0.0

    def __enter__(self):
        real = self.real = self.module._propagate

        def counted(labels, core, neighbor_min):
            def sweep(labels):
                self.sweeps += 1
                return neighbor_min(labels)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(labels, core, sweep)
            self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out

        self.module._propagate = counted
        return self

    def __exit__(self, *exc):
        self.module._propagate = self.real


def recall(got, want, k=NN_K) -> float:
    return float(np.mean([len(set(g[:k]) & set(w[:k])) / k
                          for g, w in zip(got, want)]))


def sets_outside_ties(label, got_i, want_i, want_d, k=NN_K) -> int:
    """Fails unless each row's k ids equal the reference's as a set, except
    rows whose reference k-th and (k+1)-th distances lie within
    NN_TIE_RTOL; returns how many rows are such near-ties."""
    near = np.isclose(want_d[:, k - 1], want_d[:, k], rtol=NN_TIE_RTOL,
                      atol=0)
    bad = [r for r in range(len(got_i)) if not near[r]
           and set(got_i[r, :k]) != set(want_i[r, :k])]
    log(f"    {label}: {len(bad)} rows differ outside {int(near.sum())} "
        f"near-ties (k-th and (k+1)-th within {NN_TIE_RTOL:g})")
    check(not bad, f"{label}: index sets differ in rows {bad[:10]}")
    return int(near.sum())


def dist_rel(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(np.asarray(got, dtype=np.float64) - want)
                        / np.maximum(want, 1e-30)))


def timed_search(torch, model, queries, k=None):
    """(result, host seconds) of ``model.kneighbors``, the card
    synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.kneighbors(queries, k=k)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def knn_bound(rows, n, d, k):
    """Least time for one brute chunk: the cross term's 2·rows·n·d
    operations at the float32 peak (the float64 product runs on the FP64
    tensor cores at the same 67 TFLOP/s), or the items, the chunk and its
    (distance, index) output moved once. Returns (ms, by)."""
    ops_ms = 2.0 * rows * n * d / PEAK_OPS_PER_S["f32"] * 1e3
    bytes_ms = (4 * (n * d + rows * d) + 12 * rows * k) / PEAK_BYTES_PER_S \
        * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")


def phase_knn(torch, fg, device):
    """Phase 19: NearestNeighbors (brute, IVF-Flat, IVF-PQ) at SIFT1M's
    shape and DBSCAN at 16,384 and 131,072 rows through their entry
    points, their sharded searches on one NCCL rank, and a save and load.
    No hand kernel runs. Returns a summary for the JSON line."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch import DBSCAN, NearestNeighbors
    from spark_rapids_ml_tpu_torch.io.persistence import load_model
    from spark_rapids_ml_tpu_torch.models.dbscan import (
        _host_dbscan,
        _relabel_consecutive,
    )
    from spark_rapids_ml_tpu_torch.models.nearest_neighbors import (
        _host_kneighbors,
    )
    from spark_rapids_ml_tpu_torch.ops import (
        dbscan_kernel,
        kmeans_kernel,
        knn_kernel,
    )
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_dbscan_labels,
        distributed_ivf_search,
        distributed_kneighbors,
        initialize_multihost,
    )

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    fg.reset_launches()
    summary = {"card": smi}
    gib = 1024 ** 3
    f32 = torch.float32
    kmeans_split = ((kmeans_kernel, "kmeans_plus_plus_init", "k-means++"),
                    (kmeans_kernel, "kmeans_fit_kernel", "lloyd"),
                    (kmeans_kernel, "assign_clusters", "assign"))

    # (i) brute force
    t0 = time.perf_counter()
    items, queries = nn_data(torch, device)
    model = NearestNeighbors().setK(NN_K).fit(items)
    log(f"  {smi}; data {NN_ITEMS:,} x {NN_DIM} items in {NN_BLOBS} blobs "
        f"(centres N(0, {NN_CENTRE_SD:g}²), σ = 1), {NN_QUERIES:,} fresh "
        f"queries, k = {NN_K}: made and fitted in "
        f"{time.perf_counter() - t0:.2f} s")
    step = knn_kernel.query_step(NN_ITEMS)
    model.kneighbors(queries[:step])               # stages the items
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (d32, i32), wall = timed_search(torch, model, queries)
    peak = torch.cuda.max_memory_allocated()
    log(f"  (i) brute, float32: {wall:.3f} s, {NN_QUERIES / wall:,.0f} "
        f"queries/s (host clock), chunks of {step}; peak "
        f"{peak / gib:.3f} GiB allocated ({base / gib:.3f} GiB before: the "
        f"items)")
    summary["brute"] = {"queries_per_s": NN_QUERIES / wall, "chunk": step,
                        "peak_bytes": peak}
    model64 = model.copy().setDtype("float64")
    (d64, i64), wall64 = timed_search(torch, model64, queries, k=NN_K + 1)
    del model64
    torch.cuda.empty_cache()
    log(f"    float64 on the card (k = {NN_K + 1}): {wall64:.3f} s")
    ties = sets_outside_ties("float32 vs float64 on the card", i32, i64,
                             d64)
    err = dist_rel(d32, d64[:, :NN_K])
    log(f"    distances vs float64: max rel {err:.3e} (bar "
        f"{NN_DIST_RTOL:g})")
    check(err <= NN_DIST_RTOL, f"brute distances rel {err:.3e}")
    summary["brute"].update(near_ties=ties, dist_rel=err)
    t0 = time.perf_counter()
    hd, hi = _host_kneighbors(queries[:NN_HOST_QUERIES], model.items,
                              NN_K + 1)
    log(f"    _host_kneighbors on {NN_HOST_QUERIES}: "
        f"{time.perf_counter() - t0:.2f} s")
    sets_outside_ties("float32 vs the host", i32[:NN_HOST_QUERIES], hi, hd)
    err = dist_rel(d32[:NN_HOST_QUERIES], hd[:, :NN_K])
    check(err <= NN_DIST_RTOL, f"brute vs host distances rel {err:.3e}")
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        (dh, ih), wall_h = timed_search(torch, model, queries)
    finally:
        torch.set_float32_matmul_precision(saved)
    check(np.array_equal(dh, d32) and np.array_equal(ih, i32),
          "brute under set_float32_matmul_precision('high') differs")
    items_dev = model._items_on_device(device, f32)
    do, io = model._stream_queries(
        queries, NN_K, NN_OTHER_STEP, device, f32,
        lambda q: knn_kernel.knn_kernel(q, items_dev, NN_K))
    check(np.array_equal(do, d32) and np.array_equal(io, i32),
          f"brute in chunks of {NN_OTHER_STEP} differs")
    log(f"    equal bit for bit under 'high' ({wall_h:.3f} s) and in "
        f"chunks of {NN_OTHER_STEP}")
    qc = torch.as_tensor(queries[:step], device=device)
    ms = time_ms(torch, lambda: knn_kernel.knn_kernel(qc, items_dev, NN_K),
                 NN_TIMED)
    ms_dist = time_ms(torch, lambda: knn_kernel.pairwise_sqdist(
        qc, items_dev), NN_TIMED)
    d2 = knn_kernel.pairwise_sqdist(qc, items_dev)
    ms_topk = time_ms(torch, lambda: torch.topk(d2, NN_K, dim=1,
                                                largest=False), NN_TIMED)
    ms_select = time_ms(torch, lambda: knn_kernel._smallest_k(d2, NN_K),
                        NN_TIMED)
    del d2
    torch.cuda.empty_cache()
    b_ms, b_by = knn_bound(step, NN_ITEMS, NN_DIM, NN_K)
    log(f"    one chunk of {step} (CUDA events, {smi}): {ms:.4f} ms "
        f"against a bound of {b_ms:.4f} ms ({b_by}), share "
        f"{b_ms / ms:.4f}; distances {ms_dist:.4f} ms, selection "
        f"{ms_select:.4f} ms (torch.topk alone {ms_topk:.4f} ms)")
    summary["brute"].update(chunk_ms=ms, bound_ms=b_ms, bound_by=b_by,
                            dist_ms=ms_dist, select_ms=ms_select,
                            topk_ms=ms_topk)

    # (ii) IVF-Flat at the default nlist
    ivf = model.copy().setAlgorithm("ivfflat")
    nlist = ivf._resolve_nlist()
    torch.cuda.reset_peak_memory_stats()
    with WallSplit(torch, kmeans_split) as split:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cent, b_items, b_ids, b_mask, _ = ivf._ivf_index(device, f32)
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_iter = int(split.last["lloyd"].n_iter)
    lloyd = split.seconds["lloyd"]
    coarse = sum(split.seconds.values())
    max_size = int(b_ids.shape[1])
    log(f"  (ii) ivfflat index, nlist {nlist}: {build:.3f} s (coarse "
        f"k-means {coarse:.3f} s; {split.line(build)}: the layout); Lloyd "
        f"{n_iter} iterations + the final "
        f"cost, {lloyd / (n_iter + 1) * 1e3:.2f} ms a pass at {NN_ITEMS:,} x "
        f"{nlist}; peak {peak / gib:.3f} GiB allocated; largest list "
        f"{max_size}")
    summary["ivfflat"] = {"nlist": nlist, "build_s": build,
                          "coarse_s": coarse, "lloyd_iter": n_iter,
                          "lloyd_ms_per_pass": lloyd / (n_iter + 1) * 1e3,
                          "peak_bytes": peak, "max_list": max_size}
    by_probe = {}
    for nprobe in NN_NPROBES:
        (di, ii), wall = timed_search(torch, ivf.setNprobe(nprobe), queries)
        r = recall(ii, i32)
        by_probe[nprobe] = (di, ii)
        log(f"    nprobe {nprobe}: recall@{NN_K} {r:.4f} against (i), "
            f"{NN_QUERIES / wall:,.0f} queries/s (host clock)")
        summary["ivfflat"][f"nprobe{nprobe}"] = {
            "recall": r, "queries_per_s": NN_QUERIES / wall}
    q_cpu = torch.as_tensor(queries[:NN_CPU_QUERIES])
    cd, ci = knn_kernel.ivf_search(q_cpu, cent.cpu(), b_items.cpu(),
                                   b_ids.cpu(), b_mask.cpu(), NN_K,
                                   NN_NPROBES[0])
    di, ii = by_probe[NN_NPROBES[0]]
    check(np.array_equal(ci.numpy(), ii[:NN_CPU_QUERIES]),
          "ivfflat on the card differs from its index searched on the CPU")
    # the squared distances agree; torch's CPU float32 square root is not
    # correctly rounded, so the roots may differ by an ulp
    err = dist_rel(torch.sqrt(cd).numpy(), di[:NN_CPU_QUERIES])
    check(err <= NN_DIST_RTOL, f"ivfflat distances vs the CPU search's "
          f"rel {err:.3e}")
    log(f"    {NN_CPU_QUERIES} queries at nprobe {NN_NPROBES[0]}: ids equal "
        f"to the same search of a CPU copy of the index, distances within "
        f"{err:.3e} relative")
    del cd, ci, q_cpu
    sub = items[:NN_EXACT_ITEMS]
    qs = queries[:NN_EXACT_QUERIES]
    exact = (NearestNeighbors().setK(NN_K).setAlgorithm("ivfflat")
             .setNlist(NN_EXACT_NLIST).setNprobe(NN_EXACT_NLIST).fit(sub))
    (ed, ei), _ = timed_search(torch, exact, qs)
    (bd, bi), _ = timed_search(
        torch, NearestNeighbors().setK(NN_K).setDtype("float64").fit(sub),
        qs, k=NN_K + 1)
    sets_outside_ties(f"ivfflat at nprobe = nlist = {NN_EXACT_NLIST} on "
                      f"{NN_EXACT_ITEMS:,} items vs float64 brute", ei, bi,
                      bd)
    err = dist_rel(ed, bd[:, :NN_K])
    check(err <= NN_DIST_RTOL, f"exact ivfflat distances rel {err:.3e}")
    del exact
    torch.cuda.empty_cache()

    # (iii) IVF-PQ on the same coarse quantizer
    pq = ivf.setAlgorithm("ivfpq")
    torch.cuda.reset_peak_memory_stats()
    with WallSplit(torch, kmeans_split) as split:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, books, codes, _, _, _ = pq._ivfpq_index(device, f32)
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    m_sub, ksub, dsub = books.shape
    check((m_sub, ksub, dsub) == (NN_PQ_M, 256, NN_DIM // NN_PQ_M),
          f"auto pqM at {NN_DIM}: codebooks {tuple(books.shape)}")
    check(codes.dtype == torch.uint8, f"codes stored as {codes.dtype}")
    resident = codes.numel() * codes.element_size()
    log(f"  (iii) ivfpq index (coarse quantizer shared): {build:.3f} s "
        f"({split.line(build)}); M = {m_sub}, dsub {dsub}, ksub {ksub}; codes "
        f"uint8, {NN_ITEMS * m_sub:,} B of codes (n·M) in a "
        f"{resident:,} B padded layout; peak {peak / gib:.3f} GiB")
    summary["ivfpq"] = {"build_s": build, "code_bytes": NN_ITEMS * m_sub,
                        "layout_bytes": resident, "peak_bytes": peak}
    pq_runs = {}
    for nprobe in NN_NPROBES:
        for refine in NN_REFINE:
            (dq, iq), wall = timed_search(
                torch, pq.setNprobe(nprobe).setRefineRatio(refine), queries)
            r = recall(iq, i32)
            pq_runs[(nprobe, refine)] = (r, dq, iq)
            log(f"    nprobe {nprobe}, refineRatio {refine:g}: "
                f"recall@{NN_K} {r:.4f}, {NN_QUERIES / wall:,.0f} "
                f"queries/s (host clock)")
            summary["ivfpq"][f"nprobe{nprobe}_refine{refine:g}"] = {
                "recall": r, "queries_per_s": NN_QUERIES / wall}
    for nprobe in NN_NPROBES:
        check(pq_runs[(nprobe, 2.0)][0] >= pq_runs[(nprobe, 0.0)][0]
              - PQ_RERANK_SLACK, f"re-rank lowered recall at nprobe {nprobe}")
    for refine in NN_REFINE:
        check(pq_runs[(32, refine)][0] >= pq_runs[(8, refine)][0]
              - PQ_NPROBE_SLACK, f"recall at nprobe 32 below nprobe 8 "
              f"(refineRatio {refine:g})")

    # (iv) DBSCAN on lattice blobs
    x = db_data()
    x16 = x[:DB_DENSE_ROWS]
    with SweepCounter(torch, dbscan_kernel) as sweeps:
        t0 = time.perf_counter()
        dense = DBSCAN().setEps(DB_EPS).setMinPts(DB_MIN_PTS).fit(x16)
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    hl, hc = _host_dbscan(x16, DB_EPS, DB_MIN_PTS)
    host_s = time.perf_counter() - t0
    check(np.array_equal(dense.labels_, _relabel_consecutive(hl))
          and np.array_equal(dense.core_mask_, hc),
          "dense DBSCAN differs from the float64 host BFS")
    log(f"  (iv) DBSCAN, {DB_BLOBS} lattice blobs in {DB_DIM} dimensions + "
        f"{DB_NOISE:.0%} noise, eps² = {DB_EPS ** 2:g}, minPts "
        f"{DB_MIN_PTS}: dense at {DB_DENSE_ROWS:,}: {wall:.3f} s, "
        f"{sweeps.sweeps} sweeps, {dense.n_clusters_} clusters, "
        f"{int((dense.labels_ < 0).sum())} noise, "
        f"{int(dense.core_mask_.sum())} core; equal to the float64 host "
        f"BFS ({host_s:.2f} s)")
    blocked16 = DBSCAN().setEps(DB_EPS).setMinPts(DB_MIN_PTS).setBlockRows(
        DB_BLOCK).fit(x16)
    check(np.array_equal(blocked16.labels_, dense.labels_)
          and np.array_equal(blocked16.core_mask_, dense.core_mask_),
          "blocked DBSCAN at 16,384 rows differs from dense")
    fits = {}
    for label, dtype in (("float32", "float32"), ("float64", "float64")):
        with SweepCounter(torch, dbscan_kernel) as sweeps:
            t0 = time.perf_counter()
            fits[label] = (DBSCAN().setEps(DB_EPS).setMinPts(DB_MIN_PTS)
                           .setBlockRows(DB_BLOCK).setDtype(dtype).fit(x))
            wall = time.perf_counter() - t0
        log(f"    blocked ({DB_BLOCK}) at {DB_ROWS:,}, {label}: {wall:.3f} "
            f"s, {sweeps.sweeps} sweeps, {sweeps.seconds / sweeps.sweeps:.3f}"
            f" s a sweep (host clock, {smi}), {fits[label].n_clusters_} "
            f"clusters")
        summary[f"dbscan_{label}"] = {"seconds": wall,
                                      "sweeps": sweeps.sweeps,
                                      "s_per_sweep":
                                          sweeps.seconds / sweeps.sweeps}
    check(np.array_equal(fits["float32"].labels_, fits["float64"].labels_)
          and np.array_equal(fits["float32"].core_mask_,
                             fits["float64"].core_mask_),
          "blocked DBSCAN at float32 differs from float64")
    log(f"    equal to dense at {DB_DENSE_ROWS:,}; float32 equal to float64 "
        f"at {DB_ROWS:,}")

    # (v) the sharded searches and DBSCAN on one NCCL rank
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    coordinator = f"127.0.0.1:{free_port()}"
    try:
        initialize_multihost(coordinator, num_processes=1, process_id=0)
    except Exception as exc:
        raise RuntimeError(f"phase 19: the one-rank NCCL world did not "
                           f"start at {coordinator}: {exc!r}") from exc
    try:
        check(dist.get_backend() == "nccl", "the card's world runs NCCL")
        mesh = data_mesh(1)
        t0 = time.perf_counter()
        dd, di = distributed_kneighbors(queries, items, NN_K, mesh)
        t_knn = time.perf_counter() - t0
        check(np.array_equal(di, i32) and np.array_equal(
            dd.astype(np.float64), d32), "distributed_kneighbors differs")
        pq.setAlgorithm("ivfflat").setNprobe(NN_NPROBES[0])
        t0 = time.perf_counter()
        vd, vi = distributed_ivf_search(pq, queries, mesh)
        t_ivf = time.perf_counter() - t0
        want_d, want_i = by_probe[NN_NPROBES[0]]
        check(np.array_equal(vi, want_i) and np.array_equal(
            vd.astype(np.float64), want_d), "distributed ivfflat differs")
        pq.setAlgorithm("ivfpq").setRefineRatio(0.0)
        t0 = time.perf_counter()
        pd_, pi = distributed_ivf_search(pq, queries, mesh)
        t_pq = time.perf_counter() - t0
        _, want_d, want_i = pq_runs[(NN_NPROBES[0], 0.0)]
        check(np.array_equal(pi, want_i) and np.array_equal(
            pd_.astype(np.float64), want_d), "distributed ivfpq differs")
        t0 = time.perf_counter()
        labels, core = distributed_dbscan_labels(x, DB_EPS, DB_MIN_PTS, mesh)
        t_db = time.perf_counter() - t0
        check(np.array_equal(_relabel_consecutive(labels),
                             fits["float32"].labels_)
              and np.array_equal(core, fits["float32"].core_mask_),
              "distributed_dbscan_labels differs from the blocked fit")
        log(f"  (v) one NCCL rank, each equal to its one-device search: "
            f"distributed_kneighbors {t_knn:.3f} s, distributed_ivf_search "
            f"ivfflat {t_ivf:.3f} s and ivfpq {t_pq:.3f} s, "
            f"distributed_dbscan_labels {t_db:.3f} s (host clock)")
    finally:
        dist.destroy_process_group()

    # (vi) save and load
    small = NearestNeighbors().setK(NN_K).fit(items[:NN_SAVE_ITEMS])
    want = small.kneighbors(queries[:NN_EXACT_QUERIES])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "knn")
        t0 = time.perf_counter()
        small.save(path)
        loaded = load_model(path)
        save_s = time.perf_counter() - t0
        got = loaded.kneighbors(queries[:NN_EXACT_QUERIES])
    check(type(loaded).__name__ == "NearestNeighborsModel"
          and np.array_equal(got[0], want[0])
          and np.array_equal(got[1], want[1]),
          "the loaded NearestNeighborsModel answers differently")
    log(f"  (vi) a {NN_SAVE_ITEMS:,}-item model saved and loaded through "
        f"load_model in {save_s:.2f} s; kneighbors equal")
    launched = {k: v for k, v in fg.launches.items() if v}
    check(not launched, f"phase 19 launched a hand kernel: {launched}")
    del model, ivf, pq, items_dev
    torch.cuda.empty_cache()
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 19 launches {launched}; {summary['seconds']:.1f} s")
    return summary


TREE_FIT_ROWS = 2_097_152   # HIGGS's 28 features; 11 M rows cut (binning)
TREE_TEST_ROWS = 262_144
TREE_FEATURES = 28
MSD_FIT_ROWS = 463_715      # YearPredictionMSD's published train / test split
MSD_TEST_ROWS = 51_630
MSD_FEATURES = 90
TREE_SMALL_ROWS = 65_536    # (v)'s and (vi)'s float64 comparisons
TREE_AGREE = 0.999          # f32 vs f64 held-out labels that must agree
TREE_F64_ATOL = 1e-9        # card vs CPU, NCCL vs gloo at float64
GLOO_TIMEOUT_S = 300


def higgs_rows(rng, rows):
    """HIGGS-shaped rows: 28 float32 features, a binary label from a
    planted nonlinear rule of the first six plus N(0, 0.5²) noise."""
    x = rng.standard_normal((rows, TREE_FEATURES), dtype=np.float32)
    z = (x[:, 0] * x[:, 1] + np.sin(2.0 * x[:, 2]) + 0.5 * x[:, 3] ** 2
         - 0.5 + 0.5 * x[:, 4] - 0.3 * np.abs(x[:, 5])
         + 0.5 * rng.standard_normal(rows, dtype=np.float32))
    return x, (z > 0).astype(np.float64)


def msd_rows(rng, rows):
    """YearPredictionMSD-shaped rows: 90 float32 features and a planted
    year: linear in 12 of them, two nonlinear terms, N(0, 3²) noise."""
    x = rng.standard_normal((rows, MSD_FEATURES), dtype=np.float32)
    w = np.linspace(2.0, 0.5, 12)
    y = (1998.0 + x[:, :12].astype(np.float64) @ w
         + 4.0 * np.sin(x[:, 12]) + 3.0 * x[:, 13] * x[:, 14]
         + 3.0 * rng.standard_normal(rows))
    return x, y


def fit_split(model) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in model.fit_timings_.items())


def same_trees(a, b) -> bool:
    return (np.array_equal(a.feature, b.feature)
            and np.array_equal(a.threshold, b.threshold))


def trees_differing(a, b) -> int:
    return int(sum(not (np.array_equal(fa, fb) and np.array_equal(ta, tb))
                   for fa, fb, ta, tb in zip(a.feature, b.feature,
                                             a.threshold, b.threshold)))


def peak_fit(torch, fit):
    """(result, seconds, peak bytes allocated during it)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fit()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def histogram_bound(rows, d, n_bins, trees, nodes, channels) -> dict:
    """The least time of one level's histogram contraction: its inputs
    read once (int32 bins, int64 node ids, float64 channels) and the
    float64 histogram written once over 3.35 TB/s, against the dense
    float64 GEMM's operations (2 per multiply-add, the one-hots' zeros
    included) over 67 TFLOP/s."""
    nbytes = (rows * d * 4 + trees * rows * 8 + trees * rows * channels * 8
              + trees * channels * nodes * d * n_bins * 8)
    ops = 2.0 * rows * trees * nodes * channels * d * n_bins
    return {"bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "dense_ops_ms": ops / PEAK_OPS_PER_S["f64"] * 1e3}


def sharded_tree_fits(x, y, small_x, small_y):
    """(v) on a fresh one-rank NCCL world: both sharded fits on all rows
    (timed, with their fit reports' collectives), then on the small rows
    at float64. Returns (small ensembles, forest s, gbt s, collectives)."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_forest_fit,
        distributed_gbt_fit,
        initialize_multihost,
    )

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    coordinator = f"127.0.0.1:{free_port()}"
    try:
        initialize_multihost(coordinator, num_processes=1, process_id=0)
    except Exception as exc:
        raise RuntimeError(f"phase 20: the one-rank NCCL world did not "
                           f"start at {coordinator}: {exc!r}") from exc
    try:
        check(dist.get_backend() == "nccl", "the card's world runs NCCL")
        mesh = data_mesh(1)
        t0 = time.perf_counter()
        forest = distributed_forest_fit(x, y, mesh, n_trees=10, max_depth=5,
                                        classification=True)
        t_forest = time.perf_counter() - t0
        t0 = time.perf_counter()
        gbt = distributed_gbt_fit(x, y, mesh, max_iter=5, max_depth=5,
                                  classification=True)
        t_gbt = time.perf_counter() - t0
        coll = {name: r.fit_report_.collectives
                for name, r in (("forest", forest), ("gbt", gbt))}
        small = {
            "forest": distributed_forest_fit(
                small_x, small_y, mesh, n_trees=10, max_depth=5,
                classification=True, dtype=np.float64)[0],
            "gbt": distributed_gbt_fit(
                small_x, small_y, mesh, max_iter=5, max_depth=5,
                classification=True, dtype=np.float64)[0]}
    finally:
        dist.destroy_process_group()
    return small, t_forest, t_gbt, coll


GLOO_SCRIPT = """
import sys
import numpy as np
import torch.distributed as dist
from spark_rapids_ml_tpu_torch.parallel import (data_mesh,
    distributed_forest_fit, distributed_gbt_fit)
d = sys.argv[1]
x, y = np.load(d + '/x.npy'), np.load(d + '/y.npy')
dist.init_process_group('gloo', init_method='file://' + d + '/store',
                        rank=0, world_size=1)
mesh = data_mesh(1)
ens = distributed_forest_fit(x, y, mesh, n_trees=10, max_depth=5,
                             classification=True, dtype=np.float64)[0]
gbt = distributed_gbt_fit(x, y, mesh, max_iter=5, max_depth=5,
                          classification=True, dtype=np.float64)[0]
dist.destroy_process_group()
np.savez(d + '/gloo.npz', **{f'forest/{k}': v for k, v in
                             zip(ens._fields, ens)},
         **{f'gbt/{k}': v for k, v in zip(gbt._fields, gbt)})
"""


def phase_trees(torch, fg, device):
    """Phase 20: the tree family (RandomForest, DecisionTree, GBT) through
    its entry points at HIGGS's and YearPredictionMSD's shapes, the
    one-rank sharded fits, card against CPU, and a save and load. No hand
    kernel runs. Returns a summary for the JSON line."""
    from spark_rapids_ml_tpu_torch import (
        DecisionTreeClassifier,
        GBTClassifier,
        GBTRegressor,
        RandomForestClassifier,
        RandomForestRegressor,
    )
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.io.persistence import load_model
    from spark_rapids_ml_tpu_torch.ops import forest_kernel as fk
    from spark_rapids_ml_tpu_torch.utils.resources import PLATFORM_ENV

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    fg.reset_launches()
    gib = 1024 ** 3
    summary = {"card": smi}
    rng = np.random.default_rng(SEED + 20)
    t0 = time.perf_counter()
    hx, hy = higgs_rows(rng, TREE_FIT_ROWS + TREE_TEST_ROWS)
    hx_fit, hy_fit = hx[:TREE_FIT_ROWS], hy[:TREE_FIT_ROWS]
    hx_test, hy_test = hx[TREE_FIT_ROWS:], hy[TREE_FIT_ROWS:]
    mx, my = msd_rows(rng, MSD_FIT_ROWS + MSD_TEST_ROWS)
    mx_fit, my_fit = mx[:MSD_FIT_ROWS], my[:MSD_FIT_ROWS]
    mx_test, my_test = mx[MSD_FIT_ROWS:], my[MSD_FIT_ROWS:]
    log(f"  {smi}; HIGGS-shaped {TREE_FIT_ROWS:,} + {TREE_TEST_ROWS:,} x "
        f"{TREE_FEATURES} (positives {hy.mean():.4f}) and "
        f"YearPredictionMSD-shaped {MSD_FIT_ROWS:,} + {MSD_TEST_ROWS:,} x "
        f"{MSD_FEATURES} made in {time.perf_counter() - t0:.2f} s (host)")

    # (i) RandomForestClassifier, Spark's defaults but the subset 'auto'
    est = RandomForestClassifier().setNumTrees(20).setMaxDepth(5) \
        .setMaxBins(32).setFeatureSubsetStrategy("auto").setSeed(SEED)
    rf32, fit_s, peak = peak_fit(torch, lambda: est.fit(hx_fit, hy_fit))
    t0 = time.perf_counter()
    proba = rf32.predict_proba(hx_test)
    apply_s = time.perf_counter() - t0
    acc = float((rf32.classes_[proba.argmax(1)] == hy_test).mean())
    rf64 = est.copy().setDtype("float64").fit(hx_fit, hy_fit)
    proba64 = rf64.predict_proba(hx_test)
    agree = float((proba.argmax(1) == proba64.argmax(1)).mean())
    differ = trees_differing(rf32.ensemble_, rf64.ensemble_)
    dp = float(np.abs(proba - proba64).max())
    log(f"  (i) RandomForestClassifier, 20 trees, depth 5, 32 bins, 'auto' "
        f"(5 of 28), float32: fit {fit_s:.3f} s ({fit_split(rf32)}), "
        f"{rf32.trees_per_group_} tree(s) a group; peak "
        f"{peak / gib:.3f} GiB allocated; held-out accuracy {acc:.4f}, "
        f"transform {TREE_TEST_ROWS / apply_s:,.0f} rows/s (host clock, "
        f"binning included); against the float64 fit on the card: "
        f"{differ} of 20 trees differ, labels agree {agree:.6f}, "
        f"max |Δp| {dp:.3e}")
    check(acc > 0.6, f"held-out accuracy {acc} of the forest")
    check(differ == 0, f"{differ} trees of the float32 forest differ from "
          "the float64 forest's (both select splits on float64 histograms "
          "of the same exact class counts)")
    check(agree >= TREE_AGREE, f"float32 and float64 forests agree on "
          f"{agree} of the held-out labels")
    # the same fit with a budget that holds all 20 trees in one group:
    # the same trees, one contraction a level for the whole forest
    grouped, fit_g, peak_g = peak_fit(torch, lambda: est.copy()
                                      .setMaxMemoryInMB(8192)
                                      .fit(hx_fit, hy_fit))
    dleaf = float(np.abs(grouped.ensemble_.leaf_value
                         - rf32.ensemble_.leaf_value).max())
    log(f"    maxMemoryInMB 8192: {grouped.trees_per_group_} trees a group, "
        f"fit {fit_g:.3f} s (grow {grouped.fit_timings_['grow']:.3f} s), "
        f"peak {peak_g / gib:.3f} GiB; trees equal to the default fit's, "
        f"leaves max |Δ| {dleaf:.3e}")
    check(same_trees(grouped.ensemble_, rf32.ensemble_) and dleaf <= 1e-6,
          "the forest depends on its group size")
    # the histogram contraction alone at (i)'s deepest level (16 nodes,
    # 2 channels), for one tree and for a group of 20, against its bounds
    binned = torch.as_tensor(fk.apply_bin_edges(hx_fit, rf32.edges_),
                             device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    hist = {}
    for trees in (1, 20):
        node = torch.randint(0, 16, (trees, TREE_FIT_ROWS), generator=gen,
                             device=device)
        chans = torch.rand((trees, TREE_FIT_ROWS, 2), generator=gen,
                           dtype=torch.float64, device=device)
        ms = time_ms(torch, lambda: fk.channel_histograms(
            node, 16, binned, chans, 32), iters=5, warmup=1)
        hbound = histogram_bound(TREE_FIT_ROWS, TREE_FEATURES, 32, trees,
                                 16, 2)
        hist[trees] = {"ms": ms, **hbound}
        log(f"    histogram, deepest level (16 nodes × 2 channels), "
            f"{trees} tree(s): {ms:.3f} ms (CUDA events) against "
            f"{hbound['bytes_ms']:.3f} ms by bytes, "
            f"{hbound['dense_ops_ms']:.3f} ms by the dense float64 GEMM's "
            f"operations at 67 TFLOP/s")
        del node, chans
    del binned
    summary["rf_classifier"] = {
        "fit_s": fit_s, "split_s": rf32.fit_timings_,
        "trees_per_group": rf32.trees_per_group_, "peak_bytes": peak,
        "accuracy": acc, "transform_rows_per_s": TREE_TEST_ROWS / apply_s,
        "f64_trees_differing": differ, "f64_label_agreement": agree,
        "f64_max_abs_dp": dp, "histogram": hist,
        "grouped": {"trees_per_group": grouped.trees_per_group_,
                    "fit_s": fit_g, "grow_s": grouped.fit_timings_["grow"],
                    "peak_bytes": peak_g, "max_abs_dleaf": dleaf}}
    del rf64, proba64, grouped

    # (ii) DecisionTreeClassifier at depth 10 on the same rows
    dt, fit_s, peak = peak_fit(torch, lambda: DecisionTreeClassifier(
        maxDepth=10).fit(hx_fit, hy_fit))
    dt_acc = float((dt.classes_[dt.predict_proba(hx_test).argmax(1)]
                    == hy_test).mean())
    log(f"  (ii) DecisionTreeClassifier, depth 10: fit {fit_s:.3f} s "
        f"({fit_split(dt)}); peak {peak / gib:.3f} GiB allocated; depth_ "
        f"{dt.depth_}, num_nodes_ {dt.num_nodes_}; held-out accuracy "
        f"{dt_acc:.4f}")
    check(dt.depth_ == 10 and dt.num_nodes_ == 2 ** 11 - 1,
          "the decision tree's depth and node count")
    summary["decision_tree"] = {"fit_s": fit_s, "split_s": dt.fit_timings_,
                                "peak_bytes": peak, "accuracy": dt_acc}

    # (iii) RandomForestRegressor at YearPredictionMSD's shape
    rfr, fit_s, peak = peak_fit(torch, lambda: RandomForestRegressor()
                                .setNumTrees(20).setMaxDepth(5)
                                .setFeatureSubsetStrategy("auto")
                                .setSeed(SEED).fit(mx_fit, my_fit))
    pred = np.asarray(rfr.transform(mx_test).column("prediction"))
    rmse = float(np.sqrt(np.mean((pred - my_test) ** 2)))
    rmse0 = float(np.sqrt(np.mean((my_fit.mean() - my_test) ** 2)))
    log(f"  (iii) RandomForestRegressor, 20 trees, depth 5, 'auto' (30 of "
        f"90), float32: fit {fit_s:.3f} s ({fit_split(rfr)}), "
        f"{rfr.trees_per_group_} tree(s) a group; peak {peak / gib:.3f} GiB "
        f"allocated; held-out RMSE {rmse:.4f} (the training mean's "
        f"{rmse0:.4f})")
    check(rmse < rmse0, "the forest regressor beats the mean")
    summary["rf_regressor"] = {"fit_s": fit_s, "split_s": rfr.fit_timings_,
                               "peak_bytes": peak, "rmse": rmse,
                               "rmse_of_mean": rmse0}

    # (iv) GBT: a classifier with 10 % validation rows, a regressor
    val = np.random.default_rng(SEED + 21).random(TREE_FIT_ROWS) < 0.1
    frame = VectorFrame({"features": hx_fit, "label": hy_fit, "val": val})
    gbc, fit_s, peak = peak_fit(torch, lambda: GBTClassifier()
                                .setMaxIter(20).setMaxDepth(5)
                                .setStepSize(0.1)
                                .setValidationIndicatorCol("val")
                                .fit(frame))
    gbc_acc = float((np.asarray(gbc.transform(hx_test).column("prediction"))
                     == hy_test).mean())
    gbr, fit_r, peak_r = peak_fit(torch, lambda: GBTRegressor()
                                  .setMaxIter(20).setMaxDepth(5)
                                  .fit(mx_fit, my_fit))
    gbr_pred = np.asarray(gbr.transform(mx_test).column("prediction"))
    gbr_rmse = float(np.sqrt(np.mean((gbr_pred - my_test) ** 2)))
    for label, m, secs, pk in (("GBTClassifier (validation 10 %)", gbc,
                                fit_s, peak),
                               ("GBTRegressor", gbr, fit_r, peak_r)):
        rounds = m.boost_rounds_
        log(f"  (iv) {label}: fit {secs:.3f} s ({fit_split(m)}); "
            f"{m.ensemble_.feature.shape[0]} rounds kept of {len(rounds)} "
            f"grown; peak {pk / gib:.3f} GiB; per round grow (card) / "
            f"host (residuals, refit, validation): "
            + ", ".join(f"{r['grow_s'] * 1e3:.0f}/{r['host_s'] * 1e3:.0f}"
                        for r in rounds) + " ms")
    log(f"    held-out accuracy {gbc_acc:.4f}; regressor RMSE "
        f"{gbr_rmse:.4f}")
    check(gbc_acc > 0.6 and gbr_rmse < rmse0, "the GBT models learn")
    summary["gbt"] = {
        "classifier_rounds_kept": int(gbc.ensemble_.feature.shape[0]),
        "classifier_rounds": gbc.boost_rounds_, "classifier_fit_s": fit_s,
        "classifier_accuracy": gbc_acc, "regressor_fit_s": fit_r,
        "regressor_rounds": gbr.boost_rounds_, "regressor_rmse": gbr_rmse}
    del frame

    # (v) the sharded fits on one NCCL rank; a one-rank gloo world on the
    # CPU fits the first rows meanwhile, in a process of its own
    small_x, small_y = hx_fit[:TREE_SMALL_ROWS], hy_fit[:TREE_SMALL_ROWS]
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "x.npy"), small_x)
        np.save(os.path.join(tmp, "y.npy"), small_y)
        env = dict(os.environ, **{PLATFORM_ENV: "cpu"},
                   CUDA_VISIBLE_DEVICES="")
        gloo = subprocess.Popen([sys.executable, "-c", GLOO_SCRIPT, tmp],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            small, t_forest, t_gbt, coll = sharded_tree_fits(
                hx_fit, hy_fit, small_x, small_y)
            out, _ = gloo.communicate(timeout=GLOO_TIMEOUT_S)
        finally:
            if gloo.poll() is None:
                gloo.kill()
                gloo.communicate()
        check(gloo.returncode == 0, f"the gloo world failed: {out[-2000:]}")
        with np.load(os.path.join(tmp, "gloo.npz")) as z:
            for name, ens in small.items():
                check(np.array_equal(ens.feature, z[f"{name}/feature"])
                      and np.array_equal(ens.threshold,
                                         z[f"{name}/threshold"])
                      and np.abs(ens.leaf_value
                                 - z[f"{name}/leaf_value"]).max()
                      <= TREE_F64_ATOL,
                      f"distributed {name} on NCCL differs from gloo")
    log(f"  (v) one NCCL rank, all {TREE_FIT_ROWS:,} rows: "
        f"distributed_forest_fit (10 trees, depth 5) {t_forest:.3f} s, "
        f"distributed_gbt_fit (5 rounds) {t_gbt:.3f} s (host clock); "
        f"collectives {coll}; on the first {TREE_SMALL_ROWS:,} rows at "
        f"float64 both equal a one-rank gloo world on the CPU (features, "
        f"thresholds; leaves within {TREE_F64_ATOL:g})")
    summary["sharded"] = {"forest_s": t_forest, "gbt_s": t_gbt,
                          "collectives": coll}

    # (vi) the card against the CPU, float64, 4 trees of depth 5
    cx, cy = hx_fit[:TREE_SMALL_ROWS], hy_fit[:TREE_SMALL_ROWS]
    rx, ry = mx_fit[:TREE_SMALL_ROWS], my_fit[:TREE_SMALL_ROWS]

    def small_fits():
        return (RandomForestClassifier().setNumTrees(4).setMaxDepth(5)
                .setFeatureSubsetStrategy("auto").setDtype("float64")
                .fit(cx, cy),
                RandomForestRegressor().setNumTrees(4).setMaxDepth(5)
                .setFeatureSubsetStrategy("auto").setDtype("float64")
                .fit(rx, ry))

    card_cls, card_reg = small_fits()
    saved = os.environ.get(PLATFORM_ENV)
    os.environ[PLATFORM_ENV] = "cpu"
    try:
        cpu_cls, cpu_reg = small_fits()
        cpu_pred = np.asarray(cpu_reg.transform(mx_test).column("prediction"))
    finally:
        if saved is None:
            del os.environ[PLATFORM_ENV]
        else:
            os.environ[PLATFORM_ENV] = saved
    card_pred = np.asarray(card_reg.transform(mx_test).column("prediction"))
    reg_differ = trees_differing(card_reg.ensemble_, cpu_reg.ensemble_)
    dpred = float(np.abs(card_pred - cpu_pred).max())
    log(f"  (vi) float64 on the card against the CPU, first "
        f"{TREE_SMALL_ROWS:,} rows, 4 trees of depth 5: classifier trees "
        f"identical {same_trees(card_cls.ensemble_, cpu_cls.ensemble_)}; "
        f"regressor: {reg_differ} of 4 trees differ, held-out predictions "
        f"max |Δ| {dpred:.3e}")
    check(same_trees(card_cls.ensemble_, cpu_cls.ensemble_),
          "the classifier's trees differ between the card and the CPU")
    check(dpred <= TREE_F64_ATOL, f"the regressor's predictions differ "
          f"between the card and the CPU by {dpred}")
    summary["card_vs_cpu"] = {"regressor_trees_differing": reg_differ,
                              "max_abs_dpred": dpred}

    # (vii) save → load_model → transform, one model of each family
    with tempfile.TemporaryDirectory() as d:
        for name, model, rows in (("forest", card_cls, hx_test),
                                  ("tree", dt, hx_test),
                                  ("gbt", gbr, mx_test)):
            want = model.transform(rows)
            path = os.path.join(d, name)
            t0 = time.perf_counter()
            model.save(path)
            loaded = load_model(path)
            save_s = time.perf_counter() - t0
            got = loaded.transform(rows)
            check(type(loaded) is type(model), f"{name} loads as another "
                  "class")
            for col in ("prediction", "probability"):
                if col in want.columns:
                    check(np.array_equal(np.asarray(got.column(col)),
                                         np.asarray(want.column(col))),
                          f"the loaded {name} model's {col} differs")
            log(f"  (vii) {type(model).__name__} saved and loaded through "
                f"load_model in {save_s:.2f} s; transform bit-equal")
    launched = {k: v for k, v in fg.launches.items() if v}
    check(not launched, f"phase 20 launched a hand kernel: {launched}")
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 20 launches {launched}; {summary['seconds']:.1f} s")
    return summary

def build_fresh(cuda_build):
    """Build the Gram library anew, so ``ptxas -v`` reports on it."""
    path = cuda_build.library_path("fused_gram")
    if os.path.exists(path):
        os.remove(path)
    return cuda_build.build("fused_gram")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from spark_rapids_ml_tpu_torch.obs.incidents import CAPTURE_ENV
    from spark_rapids_ml_tpu_torch.ops import fused_gram as fg
    from spark_rapids_ml_tpu_torch.utils import cuda_build

    # Incident-triggered profiler captures only where phase 11 tests them:
    # the servers of phases 5-6 leave the sampler sweeping, and a capture
    # its memory detector started while phase 7 fitted on an NCCL world
    # hung the process on the H100.
    os.environ.setdefault(CAPTURE_ENV, "0")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log("[1] environment")
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    log("[2] build")
    t0 = time.perf_counter()
    result = build_fresh(cuda_build)
    log(f"  {result.name}: nvcc {result.seconds:.2f} s → {result.path}")
    for line in result.ptxas.splitlines():
        if any(key in line for key in ("Compiling entry", "registers",
                                       "spill", "wgmma", "setmaxnreg")):
            log("   ", line.strip())
    check_ptxas(result.ptxas)
    for precision in ("highest", "bfloat16", "bfloat16_3x"):
        log(f"  {fg.kernel_name(precision)} Gram launch: "
            f"{fg.dynamic_smem_bytes(precision)} B dynamic shared memory")
    check_sass(cuda_build, result.path)
    log(f"  build phase {time.perf_counter() - t0:.2f} s")

    log("[3] kernels vs plain versions")
    measured = phase_kernels(torch, fg, device)

    log("[4] PCA slice at full width")
    launches, model_a, model_c = phase_slice(torch, fg, device)

    log("[5] serving fit (c)'s model")
    fg.reset_launches()
    served_rps = phase_serve(torch, model_c, device)
    served = dict(fg.launches)
    log(f"  kernel launches in the serve phase: {served} (the serve path "
        f"runs no hand kernel)")
    check(sum(served.values()) == 0, "the serve phase launched a kernel")

    log("[6] multi-tenant serving")
    fg.reset_launches()
    phase_multitenant(torch, model_c, device)
    served = dict(fg.launches)
    log(f"  kernel launches in the multi-tenant phase: {served}")
    check(sum(served.values()) == 0, "the multi-tenant phase launched a "
          "kernel")

    log("[7] PCA across ranks")
    launched7, streamed7_s = phase_distributed(torch, fg, device, model_a)
    distributed = {fg.kernel_name(None): launched7}

    log("[8] the debug plane")
    occupancy8 = phase_debug(torch, fg, model_c, device, served_rps)

    log("[9] profiling and the flight recorder")
    phase_profile(torch, fg, model_c, device, occupancy8)

    log("[10] tiering on the card")
    fg.reset_launches()
    phase_tiering(torch, fg, model_c, device, served_rps)
    tiered = dict(fg.launches)
    log(f"  kernel launches in the tiering phase: {tiered}")
    check(sum(tiered.values()) == 0, "the tiering phase launched a kernel")

    log("[11] the auto-incident engine on the card")
    fg.reset_launches()
    phase_incidents(torch, fg, model_c, device)
    incident_launches = dict(fg.launches)
    log(f"  kernel launches in the incident phase: {incident_launches}")
    check(sum(incident_launches.values()) == 0,
          "the incident phase launched a kernel")

    log("[12] fit and transform reports, the dashboard")
    fg.reset_launches()
    phase_reports(torch, model_c, device)
    report_launches = dict(fg.launches)
    log(f"  kernel launches in the reports phase: {report_launches}")
    check(sum(report_launches.values()) == 0,
          "the reports phase launched a kernel")

    log("[13] the fit-path monitor on the card")
    monitored = {fg.kernel_name(None): phase_fitmon(
        torch, fg, device, model_a, model_c, streamed7_s)}

    log("[14] RowMatrix, TruncatedSVD and LinearRegression at full width")
    gram_callers = phase_gram_callers(torch, fg, device, model_a)

    log("[15] KMeans, StandardScaler and the fused pipeline")
    pipeline_launches = phase_kmeans(torch, fg, device, model_c)

    log("[16] LogisticRegression and the classifier chain")
    logreg_launches, logreg_shapes = phase_logreg(torch, fg, device, model_c)
    measured[fg.kernel_name("highest")]["extra_shapes"].update(logreg_shapes)

    log("[17] the other stage families and their chains")
    stage_launches, stage_timings = phase_stages(torch, fg, device)

    log("[18] LinearSVC and GeneralizedLinearRegression")
    linear_launches, linear_shapes = phase_linear_models(torch, fg, device)
    measured[fg.kernel_name("highest")]["extra_shapes"].update(linear_shapes)

    log("[19] NearestNeighbors and DBSCAN")
    knn_summary = phase_knn(torch, fg, device)

    log("[20] the tree family")
    tree_summary = phase_trees(torch, fg, device)

    kernels = []
    for name, m in measured.items():
        check(launches.get(name, 0) > 0, f"{name} not launched on the main path")
        by_phase = {"4": launches[name], "7": distributed.get(name, 0),
                    "13": monitored.get(name, 0),
                    "14": gram_callers.get(name, 0),
                    "15": pipeline_launches.get(name, 0),
                    "16": logreg_launches.get(name, 0),
                    "17": stage_launches.get(name, 0),
                    "18": linear_launches.get(name, 0),
                    "19": 0, "20": 0}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "prep_ms": m["prep_ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "extra_shapes": m["extra_shapes"],
        })
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"stage_bodies": stage_timings}))
    print(json.dumps({"knn_dbscan": knn_summary}))
    print(json.dumps({"trees": tree_summary}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
