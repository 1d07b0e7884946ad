#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``quorum_intersection_tpu_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one NVIDIA card
    python3 chip_smoke.py --stress 400   # build, then only compare_packed's and compare_warp's repeats
    python3 chip_smoke.py --frontier     # build, then only the frontier's phases (19-22, 36) and their certificates
    python3 chip_smoke.py --pagerank     # build, then only the PageRank phases (14-16)
    python3 chip_smoke.py --bitset       # build, then only the bitset engine's phases (23-26) and their certificates
    python3 chip_smoke.py --pagerank --k12-parent DIR   # ... and DIR's K12 and this one's launch shapes in turns
    python3 chip_smoke.py --bitset --k8-parent DIR      # ... and DIR's K8 in turns with this one on every shape
    python3 chip_smoke.py --observe      # build, then only observe, faults and query (27-29) and their certificates
    python3 chip_smoke.py --delta        # build, then only incremental re-analysis (30) and its certificates
    python3 chip_smoke.py --serve        # build, then only the serve subcommand's phase (31) and its certificates
    python3 chip_smoke.py --fleet        # build, then only the replicated serve tier's phase (32) and its certificates
    python3 chip_smoke.py --native       # build, then only the native host layer and the tooling (33-34), certificates
    python3 chip_smoke.py --mesh         # build, then only the mesh phases (35-36) and their certificates
    python3 chip_smoke.py --mesh --k1-parent DIR        # ... and DIR's K1 in turns with this one on the mesh window
    python3 chip_smoke.py --frontier-mesh    # build, then only the frontier's mesh phase (36) and its certificates
    python3 chip_smoke.py --frontier --frontier-parent DIR  # ... and DIR's frontier kernels in turns with this one's

Phases, one line each, each with its wall ``seconds`` (any failure exits
non-zero and prints no ``ok`` line):

1. device   — CUDA must be available; the card's name and power limit;
2. build    — the CUDA kernels, built from ``kernels/csrc`` with ``nvcc``
              (one process per source, all started together);
3. kernels  — the kernels this script launches and the TPU kernels they replace;
4. compare  — the fused kernel, both instances (tables resident in shared
              memory and streamed through it), against its plain PyTorch
              version on the card, on the same candidate windows (hits
              included): exact equality, since the result is an integer hit
              index.  On the fixtures' SCCs, the wide decode, multi-edge
              circuits, a 390-unit and a 1240-unit circuit (hits among its
              windows) and a 3000-unit one whose tables only stream;
   compare_warp — the fused kernel 32 times on each of four cases and the
              guard on each of two, both instances, each launch against the
              plain result (the warp cases of ``--stress N``);
   timing   — ms per 2^20-candidate window of the fused kernel at the
              snapshot's, the full-width and the 1240-unit shape, both
              instances, beside the plain version's ms and the bound;
5. main     — the verdict path through the entry points a user calls:
              ``solve`` on all seven vendored fixtures (launch counts reset
              before, read after; every ``false`` witness re-checked as two
              disjoint quorums) and ``python -m quorum_intersection_tpu_torch``
              on each fixture (verdict and exit code against MANIFEST.json);
6. full     — ``benchmark_fbas(256, core=34)``, correct and broken twins:
              2^33 candidates through SCC restriction and the wide decode;
              the correct twin once more under the profiler;
7. batch    — the batch path: ``check_many`` on 16 snapshot-shaped sources in
              one call, once with the default engine and once with
              ``engine="bitset"`` (launch counts reset before each run, read
              after).  Verdicts against MANIFEST.json or the generator's
              ``broken`` flag, every ``false`` witness re-checked, and every
              hit index equal to the unpacked ``solve`` of the same source.
              Each engine once more under the profiler: device busy and idle
              share, device ms per kernel;
   batch_units — ``check_many`` on ``inner_set_ring_fbas(30|24, 12)``, both
              variants, both engines: jobs whose lane-only window split would
              pass the packed kernels' 1024 units; packs within it, the
              unpacked ``solve``'s verdicts and hit indices;
8. compare_packed — the two packed kernels against their plain version,
              exact, on every
              pack the default batch run swept (the backend's ``pack_plans``:
              a depth-1 pack and windows with hits among them), a pack with
              vote counts up to 3, and two 1024-unit nested packs (the dense
              kernel's streamed instance on the densely nested one); 3000
              rows a program (a ragged last tile); then the dense kernel
              32 times on each of six cases (the odd packs, the streamed
              ones among them), each launch against the plain version;
   timing_packed  — ms per 2^20-row program of each packed kernel at the
              widest packed shape (the pack
              ``check_many`` forms for ``benchmark_fbas(256, core=31)`` alone:
              4 window groups) and at the shape of the batch's first pack,
              beside the plain version's ms and the bound (the dense
              kernel's time on these 0/1 packs is the u8 evaluator's time
              on the bitset kernel's function); ptxas's registers and spills
              per kernel instance;
9. prune    — block-guard pruning on the unpacked path: ``solve`` with
              ``GpuSweepBackend(prune=True)`` on the seven fixtures and on
              ``near_disjoint_cores(12, 1)`` and ``(15, 1)``, correct and
              broken (2^24 and 2^30 candidates; the widest enumeration the
              planner takes).  Verdicts, witnesses, every hit index equal to
              the unpruned ``solve``'s, and on ``true`` checked + pruned ==
              the enumeration; guard launches counted (reset before, read
              after);
10. batch_pruned — ``check_many`` with pruning, default and bitset engines,
              on the batch's 16 sources plus ``near_disjoint_cores(6, 1)`` at
              three seeds and ``(10, 1)`` correct and broken: the batch's
              checks, and each guard instance launched; then each engine once
              more under the profiler (the guards' device ms);
11. compare_guard — both guard encodings, each on both instances, against
              their plain version, exact, on the masks of every plan the two
              runs above built, a multi-edge circuit, a 390-unit and a
              1240-unit circuit (dense);
    timing_guard  — ms per 16384-row guard call at ``near_disjoint_cores(15,
              1)``'s and the snapshot's shape, both instances, beside the
              plain version's ms, the bound and the guard's share of the
              pruned ``solve``;
12. route   — the auto router's constants measured on this card, beside the
              ones committed in ``backends/calibration.py``: the native and
              Python oracles' seconds per branch-and-bound call (their own
              stats over the fixtures and ``stellar_like_fbas`` cores), the
              sweep's first-solve overhead in a fresh process with the
              kernels built and with an empty build directory, K1's rate at
              full width (phase full), and the batch packed against
              per-problem sweeps on both engines (the pack gate);
13. auto    — the default backend: ``python -m quorum_intersection_tpu_torch``
              on one source per route (the oracle: ``snapshot_broken.json``;
              the sweep: the full-width correct twin; the SCC guard:
              ``nested_broken.json``), racing, with ``--no-race`` and with
              ``--backend gpu-sweep`` (verdicts and exit codes equal, race
              winner, ``loser_joined``, process seconds); the cold CLI alone
              on ``snapshot_correct.json`` under ``auto``; then ``solve`` through
              ``AutoBackend`` in process, race on and off (launch counts
              reset before, read after: the seven fixtures and the full-width
              twins; the correct twin must be decided by K1 in the race), and
              ``check_many`` through it;
14. compare_pagerank — the PageRank power-loop kernel (K12, one cooperative
              launch) against its plain version (sparse form) and against
              ``pagerank_np`` on the fixtures, the C15 quirk graphs (parallel
              edges, a self-loop, a dangling vertex; ``max_iterations`` 0, 1
              and 7), the dump-scale shape ``stellar_like_fbas(n_watchers=2800,
              n_null=150, n_dangling=40, seed=7)`` and ``stellar_like_fbas(
              n_watchers=200000, seed=7)`` (about 200k nodes and a million
              edges), then 60 forced iterations at that width: every rank
              within rtol 1e-3 + atol 1e-3*m/n and the JAX tolerance, max abs error and both
              iteration counts; on the two stellar graphs the check must
              refuse two planted faults (the unreached vertices zeroed, the
              base term dropped); also ``heavy_row_fbas(100000)`` (a hub row
              of 100 003 entries beside rows of 0-3; its count held to
              NumPy's, whose rows sum in float64), every case bit for bit
              the CPU model of the schedule
              (``tests/_torch_pagerank_schedule.py``), and 21 launches on the
              heavy-row and 200k graphs giving the same bits;
15. timing_pagerank — per ``stellar_like_fbas(seed=7)`` graph from 30 to
              200k watchers: the warm call (CSR built and uploaded, one
              launch, one readback), the kernel alone, ms per iteration (201
              against 1 forced iterations), the iterations, the bound (the
              call's bytes and float32 operations), the plain version's and
              NumPy's ms, the call on the device alone; a fresh process's
              first-call overhead (and its profiler's view of a warm call);
              the ``pagerank_min_edges`` these give beside the committed one;
              at 200k and the dump's shape the timed instance's clock64()
              split of an iteration and the grid barriers it counted and,
              with ``--k12-parent DIR``, three launch shapes in turns and
              DIR's K12 (the C interface of the three-barrier kernel, a
              segment pointer built by the caller) in turns with this one,
              per call (launch alone, and through this tree's wrapper and a
              copy of what DIR's wrapper did a call) and per iteration;
16. pagerank_cli — the main path: ``power_iteration`` (the library's
              entry point under ``pagerank``) on the dump and the 200k graph
              on the card, launch count reset before and read after, each
              call timed by CUDA events around it, ``pagerank_auto`` on both
              routed by the committed floor; the 200k call once more under
              the profiler beside a control reduction, and one wrapper call
              (K12 alone, no host-to-device copy); then ``python -m
              quorum_intersection_tpu_torch -p`` on the dump and on the 200k
              graph (the floor's route; on NumPy's the lines byte-equal to
              ``format_pagerank(pagerank_np)``);
17. analysis — ``--top-tier``, ``--blocking-set``, ``--splitting-set`` and
              the sanitizer (default, ``--compat``, ``--report-dangling``)
              against the lines ``tests/_torch_analysis_lines.json`` pins to
              the JAX CLI: one process a flag set (``ANALYSIS_PROCESSES``),
              every other pinned case through the same entry point in this
              process;
18. rank    — ``order="rank"``: ``solve`` on the fixtures, the full-width
              twins (2^33 through K1) and the batch's sources, then the
              16-source ``check_many`` on both engines (every hit index equal
              to the unpacked rank-ordered ``solve``'s; K1, K3 and K4
              launches counted), and the CLI under ``QI_SWEEP_ORDER=rank``
              (gpu-sweep and auto) with ``provenance.order`` checked;
19. compare_frontier — the frontier's chunk loop (K9, one cooperative
              launch a chunk) against its plain version chunk for chunk from
              the seed state: arena rows [0, top), counters and flags exact,
              and the flag filter (K10) against its plain version on every
              chunk's flags; ``majority_fbas(14)`` and its broken twin,
              ``hierarchical_fbas(5, 3)`` on both evaluator instances (also at 3
              iterations a chunk), four ``random_fbas(14)``, the spill
              configuration ``hierarchical_fbas(4, 3)`` at arena 64 / pop 16 on
              both instances, the restricted ``benchmark_fbas(64, 14, seed=1)``
              and three default chunks of the wide networks (s 24 to 64), two
              of each network past 64 lanes (the broken stellar 22x3 and 42x3
              on both instances, stellar 30x3, random_fbas(96 | 128)).  Each
              chunk's exit (empty stack, chunk_iters, flag_exit, the overflow
              guard): every one on each instance, or the phase fails.  K10 also
              on a block of sets over 16 members, off a multiple of 16
              (``tests/_torch_frontier_blocks.wide_flag_block``), on every
              network past 16 lanes;
20. frontier — ``python -m quorum_intersection_tpu_torch --backend
              gpu-frontier --cert-out`` on the broken ``stellar_like_fbas(21 |
              42, 3)`` (scc 63, past the sweep's reach, and 126, two words a
              state) and ``--checkpoint`` on
              ``hierarchical_fbas(6, 4)``, as processes; then
              ``GpuFrontierBackend`` in process on the seven fixtures,
              ``majority_fbas(18)`` and its broken twin, ``hierarchical_fbas(6,
              4)`` and ``(8, 4)`` (scc 32, full size) and the broken
              ``stellar_like_fbas(16 | 21 | 22 | 42, 3)`` (scc 48, 63, 66
              and 126), then the pinned JAX cases past 64 lanes and under
              ``pad_shapes=False`` at their constants, every pinned count
              equal (``FRONTIER_PINNED``) (K9 and K10
              launch counts reset before, read after, and
              CUDA events around every launch): verdicts, witnesses re-checked,
              popped and flagged counts equal to the enumeration's exact ones,
              states/s, chunks, first and steady chunk seconds; a kill and a
              resume on the card;
21. frontier_route — ``gpu-frontier`` against the native oracle on the same
              host (the oracle cut at ``ORACLE_CAP_S``) on hier 6x4, 7x4, 8x4 and
              the broken stellar 16x3, 21x3 and 42x3; the win region by the JAX rule beside
              the one committed in ``backends/calibration.py``;
22. timing_frontier — at ``hierarchical_fbas(8, 4)``'s shape (s 32, K 2048):
              K9 by CUDA events per 1-, 33- and 512-iteration chunk from a
              mid-search state; the clock64() breakdown of an iteration by K9's
              timed instance; K10 per 10 240-flag block of its own flags (on
              the device alone and back to back) and its event ms inside the
              hier-8x4 solve; with ``--frontier-parent DIR``, DIR's frontier
              kernels in turns with this tree's (K9's 33-iteration chunk, the
              mesh-chunk instance's iteration on 4 ranks, K10's body on a
              side stream) and both builds' ptxas registers and spills; the
              plain versions' ms and each bound (the fixpoint passes the rows
              take times the nonzero votes at the int8 peak, against the
              chunk's source rows read once and its rows and flags written
              once); then K9 and K10 at two words a state, at the broken
              stellar 42x3's shape (s 126, s_dev 128, 192 units), from its
              own search, beside their plain versions and bounds;
23. compare_bitset — the unpacked bitset sweep (K8) against its plain
              version, exact, on every instance that takes the case (the
              lane instance up to 128 units, the warp instance resident
              where its tables fit one block, streamed always): the
              fixtures' SCCs, ``sparse_giant(400)``
              restricted (a hi row, chunk tails whose rows alias),
              ``near_disjoint_cores(6, 1)`` restricted and whole, a whole
              graph with a frozen row, full width (30 low bits, hi rows past
              bit 32), the 390-unit ring and the densely nested 993- and
              3001-unit circuits (the latter streamed), correct and broken
              twins (``tests/_torch_bitset_cases.card_problems``); the host's
              choice of instance held to the shape rule;
24. timing_bitset — K8 and K1 a 2^20-candidate window in turns (K8, K1,
              K1, K8; events over 30 launches and on the device alone) at the
              full-width, snapshot and ``sparse_giant`` shapes and (fewer
              launches) the 390-unit ring and the 993- and 3001-unit
              circuits, beside the plain version's ms (narrow shapes) and the
              bound (``window_bound_ms``), the launches on each path, the
              instance and ptxas's registers and spills per instance; with
              ``--k8-parent DIR``, DIR's K8 (``ParentK8``, on this tree's
              warp tables) in turns with them (parent, K8, K1, K1, K8,
              parent);
25. bitset_route — warm ``solve`` under ``QI_SWEEP_ENGINE=bitset`` against
              the default engine in turns, on ``sparse_giant()`` (10 000
              nodes, once), ``sparse_giant(400)``, ``benchmark_fbas(256,
              core=34)``, ``majority_fbas(18)`` and
              ``inner_set_ring_fbas(30, 12)``, correct and broken (neither
              ring intersects; its verdict is the default engine's):
              verdicts, hit indices and witnesses equal, K8's launches on
              this main path (reset before, read after), the rows (scc,
              density, speedup, verdict_ok) and the win region
              ``calibration.bitset_region`` gives, beside the committed one;
              one bitset solve under the profiler (K8's device ms);
26. checkpoint — a full-width ``gpu-sweep`` solve stopped after a few
              programs, then resumed from its file in a fresh solve
              (``resumed_from`` > 0, checked + resumed == the enumeration,
              the checker's "checkpoint-resumed" note), written and resumed
              by the default engine, and across engines both ways;
27. observe — ``python -m quorum_intersection_tpu_torch`` on the snapshot
              fixtures under ``gpu-sweep`` and ``auto`` with ``--timing
              --metrics-json --metrics-prom --trace-out --cert-out`` at once:
              verdicts and exit codes, the ``--timing`` lines before the
              ``[telemetry]`` ones, the JSONL opening with its meta line and
              rendered by ``tools/metrics_report.py``, the ``sweep.window``
              events' candidates summing to ``cert.windows_enumerated`` and
              the certificate's ledger where the sweep answered, the Chrome
              trace loading with its spans, every counter in the Prometheus
              file; then the full-width twin warm in one process without and
              with a ``JsonlSink``, in turns, three times each (both medians;
              K1's launches counted);
28. faults  — ``QI_FAULTS`` through the CLI, one process a way a fault
              ends one (started in phase observe's wave): ``sweep.dispatch`` exits with the point's name on
              stderr and no verdict line; ``checkpoint.write`` and
              ``cert.write`` keep the verdict and exit code and raise their
              counters.  In this process, each under its plan: a fired
              ``sweep.compile``, ``sweep.bitset`` (the bitset engine),
              ``sweep.prune`` (pruning) and ``frontier.chunk`` fails the solve
              on the card; a ``FaultPreempted`` at the 33rd window of a
              checkpointed 2^30 sweep (``benchmark_fbas(256, core=31)``, and
              ``late_hit_fbas(29)`` whose first hit lies at 2^28 + 15), then
              a fresh backend on the file: resumed past zero, the
              uninterrupted run's verdict and hit index;
29. query   — ``python -m quorum_intersection_tpu_torch query`` on the card
              against ``--device cpu``: ``relaxed`` on both
              ``two_family_preset`` twins (the broken one a process, the
              other in this process), ``whatif`` (``max_k`` 1, 16 variants)
              on ``nested_correct.json`` under ``gpu-sweep`` and ``auto``
              (the CPU run a process under ``cpp``), ``analytics`` for all four metrics on
              ``nested_correct.json`` (processes; their CPU runs in this
              process): equal lines and exit codes, each call's wall time;
              then the ``gpu-sweep`` what-if of the default 16 candidates (137
              variants) in process with K3's and K4's launches counted (K3
              must launch);
30. delta   — incremental re-analysis on the card: three churn traces,
              each through one ``DeltaEngine`` (one store) a snapshot a
              call and through ``check_many`` from scratch, in turns —
              ``dump_scale_correct`` (``churn_trace_steps(16, seed=3,
              max_diff=2)``) under ``auto``, ``benchmark_fbas(256, core=34)``
              (8 steps, seed 5) under ``gpu-sweep``, ``hierarchical_fbas(8,
              4)`` (4 steps, seed 6) under ``gpu-frontier`` — then
              ``snapshot_correct.json``'s 15-step trace twice over in one
              ``DeltaEngine.check_many`` under ``gpu-sweep`` against one
              scratch ``check_many`` of the same list.  Every verdict and
              witness pair equal to the scratch run's; the backend solves
              equal to the ground truth of the generator's metas; scans
              reused and fresh, ``delta.scc_reuse_pct``, the median step
              seconds each way, the kernel launches (counts set to 0 before
              each call, read after) and ``sweep.window`` events each way.
              Two faults: ``sweep.dispatch`` under the engine on a step that
              dirties the full-width core fails the call (and the step then
              solves once), ``delta.diff`` degrades to the scratch verdicts
              with ``delta.diff_faults`` counted;
31. serve   — ``python -m quorum_intersection_tpu_torch serve`` as processes
              on the card (through ``SERVE_LAUNCHER``, which calls the CLI's
              ``main`` and reports the process's kernel launches, counted
              from 0, at exit), four streams: A, the default server
              (``auto``, delta on, ``--emit-certs``) on 32 requests from three
              clients — the dump's 8-step churn trace (seed 3, max_diff 2),
              the snapshot's 8-step trace and the seven fixtures twice —
              every verdict against the manifest or the scratch
              ``check_many`` of the trace on the card; B, the batch phase's
              16 sources (the 2^30 twin first) as 16 requests from four
              clients to ``gpu-sweep`` under ``QI_SERVE_FUSE_WINDOW_MS`` 5,
              verdicts, witnesses and hit indices equal to ``check_many``'s,
              a cross-request pack, cost conserved per pack, in the counters and in
              the tenant table, the run under the profiler (device busy
              ms, idle share); C, a deadline inside a pack:
              ``benchmark_fbas(48, core=31)`` (2^30 windows) with
              ``deadline_s`` 0.35 co-packed with three small requests
              (typed ``deadline_exceeded``; the co-packed ones' verdicts, hit
              indices and certificates; the windows it retired between 1
              and 2^30 - 1); D, a ``--journal`` server SIGKILLed after its
              first response, ``--replay-only`` on its journal and
              a restart on a copy (at once), every journaled request answered with the uninterrupted
              verdict; a fired ``sweep.dispatch`` (a typed error line, no
              verdict, exit 0) and ``serve.drain`` (per-request solves on the
              card).  Per stream: requests, wall, requests per second, p50 /
              p99 of the responses' ``seconds``, first response, launches;
32. fleet   — the replicated serve tier on the card, three streams.  F1, a
              pipe fleet: ``python -m quorum_intersection_tpu_torch fleet -n
              2 --backend gpu-sweep --emit-certs`` as a process fed the seven
              fixtures twice, a zipfian churn of the snapshot (15 steps), the
              2^30 twin and a key-renamed pair routed to the two workers
              (both workers live; each repeated snapshot answered on one
              worker, from its cache or coalesced; the pair's second
              certificate composed from the fragment the other worker
              banked); wall, requests per second, p50 / p99 of ``seconds``,
              first response, ``fleet.store_hit_pct``, ``fleet.e2e_p99_ms``,
              each worker's K1 and K3 launches (its ``launches`` line in the
              shared ``QI_METRICS_JSON`` stream).  F2, a ``FleetEngine`` of
              two worker processes on the card: the worker holding the 2^30
              twin SIGKILLed in flight, zero lost or duplicated, the
              re-routed verdicts the uninterrupted ones, one respawn,
              ``/readyz`` 503 until the replay ends.  F3, a ``serve
              --socket`` process on the card joined under ``QI_FLEET_TOKEN``
              (``hello_ok``; a wrong token a typed ``bad_token`` and
              ``MeshHandshakeError``), a request the peer answers on the
              card, a peer's store miss fetched through the front door's
              store gateway into a composed certificate, and a lease lapse
              (SIGSTOP of the peer, SIGCONT once evicted) that ships its
              journal and replays its pending requests on the survivor;
33. native  — the native host layer on the card's host: the per-SCC scan
              (``pipeline.scan_scc_quorums``'s Python loop and
              ``backends.cpp.native_scc_scan``) in turns (``SCAN_TURNS``) on
              the dump, ``stellar_like_fbas(n_watchers=30000, seed=7)`` and
              (once each way) the 200k network, equal quorums, medians and
              spreads; the same on one SCC of 16-256 members
              (``benchmark_fbas(s, s)``) and the SCC size, if any, from
              which the native scan is the faster (the pipeline keeps the
              Python loop); the dump's ``gpu-sweep`` solve on the card (K1
              launched, its certificate checked) beside the native scan of
              its SCCs (the same quorum-bearing SCC); the native binary (``build_native_cli``) on the seven
              fixtures, stdout and exit equal to phase main's ``gpu-sweep``
              CLI processes, ``-v`` equal to the port's CLI on the same
              native search; ``native_candidate_rate`` beside K1's rate;
34. tooling — the build cache: a process with ``QI_NO_COMPILE_CACHE=1``
              builds all six kernel libraries into a private directory
              (``compile_cache.misses`` 6), then one with the cache finds
              them (``compile_cache.hits`` 6) in at most 10% of the cold
              build's seconds; beside the second, ``--profile-dir`` on the
              2^30 twin as a CLI process: its Chrome trace holds K1's kernel
              events and the ``qi-trace:<trace_id>`` range of the metrics
              stream's ``trace_id``; then the unprofiled solve in process;
35. mesh    — the mesh sweep K11 (one launch of the fused kernel a card
              and program over the card's contiguous share, the cards'
              minimum taken on the home card) against its plain version
              (K1's plain contiguous program over the same range) and K1's
              contiguous program, on 1, 2, 4 and 8 ranks of the one card
              and, on a host of four, on cuda:0-3 and on two cards of two
              ranks each (narrow, restricted with D thresholds, wide with a
              hi row, both table instances, a clean miss; one launch a card
              and program); then at the main path's sizes (4 ranks,
              _auto_batch(34) / 4 rows a rank, 8 blocks): the broken twin's
              first program, the correct twin's, and late_hit_fbas(29)'s
              first hit placed at each card share's first and last row,
              inside card 2's share (or the one card's) and at the
              program's last row; the processes below solve and time only
              after this comparison; the full-width twins on 4 ranks (K11's
              launches counted from 0, one a program and card, verdict,
              witness and hit index equal to the unsharded solve's,
              certificates checked); ``--backend gpu-sweep --mesh all`` as a
              CLI process; a world-size-1 NCCL group and two processes of two
              ranks joined by ``distributed.initialize`` (NCCL on two cards,
              gloo on one), in waves of their own, their verdicts equal to
              the single-process solve's; the 2^20 window on 1, 2 and 4
              ranks (and 4 cards) through the wrapper and on the device
              alone beside K1's window (and ``--k1-parent``'s K1 in turns)
              and the bound, the collective alone; on several cards the full
              width on 1, 2 and 4 of them (one line saying skipped on one
              card);
36. frontier_mesh — K9's iteration instance (the frontier under a mesh)
              against its plain version rank by rank on 1, 2 and 4 ranks of
              the one card (hier-8x4 and random_fbas(64) at the defaults, 3
              chunks, and hier-4x3 through its spills; every rank's arena
              rows, counters and flags equal), and a chunk across the cards
              where there are several; GpuFrontierBackend on 4 ranks of the
              card on hier-8x4 and the broken stellar 16x3 (scc 48), its
              verdict, witness and counts equal to K9's single-card solve,
              the launches counted from 0 (the iteration instance's only,
              K9's none), certificates checked; ``--backend gpu-frontier
              --mesh all --cert-out`` as a CLI process; two processes of
              two ranks joined by ``distributed.initialize`` (gloo on one
              card, NCCL on two), their solves equal to the single-process
              solve's; the iteration's time on 1, 2 and 4 ranks beside K9's
              per iteration, the plain version, the gather alone and the
              bound; the broken stellar 42x3 (126 lanes, two words a state)
              in the comparison, the 4-rank solves, the two processes and
              both instances' time an iteration on 4 ranks;
37. cert    — every certificate the runs above produced (CLI ``--cert-out``
              under auto, gpu-sweep and gpu-frontier, ``solve`` and
              ``check_many`` on both engines, pruned, rank-ordered and
              frontier runs with every block, incremental re-analysis's
              composed and fresh ones, the served ones) checked by the
              unmodified ``tools/check_cert.py`` in a subprocess, from raw
              JSON.

The line before the last is the kernels' JSON record (launches on the main
path of each, error against the plain version, times, bound, device ms on
the main path under the profiler, ptxas registers and spills per instance,
launches on the incremental path of phase delta, on the serve path of
phase serve and on the fleet path of phase fleet);
the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gzip
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "fixtures"
PORT = "quorum_intersection_tpu_torch"
INT8_TOPS = 1979e12  # H100 SXM dense int8 tensor-core peak, operations/s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
WINDOW = 1 << 20  # candidates per timed window
STRESS_REPEATS = 32  # launches per case of compare_packed's repeats
# The per-pack stats the batch phases print.
PACK_KEYS = ("pack_jobs", "pack_groups", "pack_slot", "pack_shape", "pack_fill_pct", "pack_engine",
             "pack_rows_dispatched", "pack_seconds")


def fail(phase: str, msg: str) -> None:
    # On both streams: a caller that keeps only the end of one still sees
    # which check failed.
    print(f"FAIL {phase}: {msg}", flush=True)
    print(f"FAIL {phase}: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


_last_line = [time.perf_counter()]


def phase_line(phase: str, **fields) -> None:
    """One phase's line.  Every line carries ``seconds``: the phase's own
    wall where it passes it, else the wall since the previous line (the
    phases run one after the other)."""
    now = time.perf_counter()
    fields.setdefault("seconds", round(now - _last_line[0], 3))
    _last_line[0] = now
    print(f"{phase}: " + json.dumps(fields, default=str), flush=True)


def fixture_text(name: str) -> str:
    raw = (FIXTURES / name).read_bytes()
    return (gzip.decompress(raw) if name.endswith(".gz") else raw).decode()


def sweep_problem(text: str):
    """The quorum-bearing SCC's sweep problem as the backend builds it:
    ``(circuit, circuit_d, local, scc_mask, frozen)``, the circuit restricted
    whenever the graph is wider than the SCC; ``local`` lists the SCC's node
    indices in the circuit (``local[0]`` is fixed out of the enumeration)."""
    import numpy as np

    from quorum_intersection_tpu_torch.encode.circuit import encode_circuit, restrict_circuit_pair
    from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.fbas.semantics import max_quorum

    graph = build_graph(parse_fbas(text))
    count, comp = tarjan_scc(graph.n, graph.succ)
    sccs = group_sccs(graph.n, comp, count)
    scc = next(m for m in sccs if max_quorum(graph, m, [v in set(m) for v in range(graph.n)]))
    circuit = encode_circuit(graph)
    circuit_d = None
    if circuit.n > len(scc):
        circuit, circuit_d = restrict_circuit_pair(circuit, scc)
        local = list(range(len(scc)))
    else:
        local = list(scc)
    scc_mask = np.zeros(circuit.n, dtype=np.int32)
    scc_mask[local] = 1
    frozen = None if circuit_d is not None else 1 - scc_mask
    return circuit, circuit_d, local, scc_mask, frozen


def multi_edge_circuit(seed: int = 5):
    """A hand-made 12-node circuit with vote counts up to 3, two inner units
    each repeated up to twice in a qset, and some thresholds <= 0."""
    import numpy as np

    from quorum_intersection_tpu_torch.encode.circuit import Circuit

    rng = np.random.default_rng(seed)
    n, u = 12, 14
    members = rng.integers(0, 4, size=(u, n)).astype(np.uint8)
    members[np.arange(n), np.arange(n)] = np.maximum(members[np.arange(n), np.arange(n)], 1)
    child = np.zeros((u, u), dtype=np.uint8)
    child[:n, n:] = rng.integers(0, 3, size=(n, u - n))
    votes = members.sum(axis=1).astype(np.int64) + child.sum(axis=1)
    thresholds = (votes * 11 // 20).astype(np.int32)
    thresholds[[3, 9]] = [0, -2]
    unit_depth = np.where(child.any(axis=1), 1, 0).astype(np.int32)
    return Circuit(n=n, n_units=u, depth=1, thresholds=thresholds, members=members,
                   child=child, unit_depth=unit_depth)


def dense_child_circuit(n: int = 31, units: int = 993, seed: int = 7, quorum=(3, 5)):
    """A 31-node circuit whose units nest densely (a 1024-unit pack): every
    root and every unit of the upper inner level counts children spread over
    all inner units below it (depth 2), so the dense kernel's byte tables
    exceed one block and stream.  Each unit's threshold is the fraction
    ``quorum`` of its votes.  The card tests build the same circuit
    (``tests/_torch_circuits.py``; a CPU test holds the two equal)."""
    import numpy as np

    from quorum_intersection_tpu_torch.encode.circuit import Circuit

    rng = np.random.default_rng(seed)
    upper = n + (units - n) // 3
    members = (rng.random((units, n)) < 0.2).astype(np.uint8)
    members[np.arange(n), np.arange(n)] = 1
    child = np.zeros((units, units), dtype=np.uint8)
    child[:n, n:] = rng.random((n, units - n)) < 0.01
    child[n:upper, upper:] = rng.random((upper - n, units - upper)) < 0.01
    votes = members.sum(axis=1).astype(np.int64) + child.sum(axis=1)
    unit_depth = np.zeros(units, dtype=np.int32)
    unit_depth[n:upper] = child[n:upper].any(axis=1)
    unit_depth[:n] = np.where(child[:n].any(axis=1), 1 + unit_depth[n:upper].max(), 0)
    return Circuit(n=n, n_units=units, depth=2,
                   thresholds=(votes * quorum[0] // quorum[1]).astype(np.int32),
                   members=members, child=child, unit_depth=unit_depth)


def stress_packed(device, repeats: int):
    """The dense kernel launched ``repeats`` times on each case, the plain
    version recomputed beside every launch: a pack with vote counts up to 3,
    the resident 1024-unit ring pack and the two densely nested 1024-unit
    packs (thresholds 3/5 and 1/2 of the votes; the streamed instance) at
    the card tests' program shape (2 x 1000 rows from two start vectors in
    turn), and the densely nested packs also at 2 x 8192 rows (256 tiles)
    over four windows.  Per case: launches whose result differed from the
    plain one, from the kernel's own first result for that window, plain
    results that differed from the first plain one, group windows with a
    hit, and the kernel's mean ms a launch (CUDA events around it)."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.encode.circuit import (
        encode_circuit,
        pack_circuits,
        restrict_circuit_pair,
    )
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels.packed_cuda import PackedSweep
    from quorum_intersection_tpu_torch.kernels.packed_ref import PackedRef
    from quorum_intersection_tpu_torch.kernels.sweep_ref import INT32_MAX

    ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12))))
    packs = {
        "multi-plane (votes up to 3)": pack_circuits([(multi_edge_circuit(), None)] * 3),
        "inner_set_ring_fbas(30,12) x2": pack_circuits([restrict_circuit_pair(ring, list(range(ring.n)))] * 2),
        "densely nested 3/5": pack_circuits([(dense_child_circuit(), None)]),
        "densely nested 1/2": pack_circuits([(dense_child_circuit(quorum=(1, 2)), None)]),
    }
    cases = []
    for name, pk in packs.items():
        cases.append((f"{name}, 2000 rows", pk, 1000,
                      [np.zeros(pk.groups, dtype=np.int64), np.asarray([(1 << (s - 1)) // 3 for s in pk.sizes])]))
        if name.startswith("densely"):
            cases.append((f"{name}, 16384 rows", pk, 8192,
                          [np.asarray([s]) for s in (0, 1 << 28, (1 << 29) + 12345, (1 << 30) // 3)]))
    out = {}
    for label, pk, batch, windows in cases:
        tables = pk.decode_tables()
        kernel = PackedSweep(pk.circuit, pk.circuit_d, *tables, batch, engine="dense", device=device)
        plain = PackedRef(pk.circuit, pk.circuit_d, *tables, batch, "dense", device)
        first_kernel, first_plain = {}, {}
        vs_plain = vs_first = plain_moved = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        kernel_ms = 0.0
        for i in range(repeats):
            w = i % len(windows)
            start.record()
            launched = kernel.program(windows[w], 2)
            end.record()
            got = launched.cpu().numpy()
            kernel_ms += start.elapsed_time(end)
            want = plain.program(windows[w], 2).cpu().numpy()
            vs_plain += int(not np.array_equal(got, want))
            vs_first += int(not np.array_equal(got, first_kernel.setdefault(w, got)))
            plain_moved += int(not np.array_equal(want, first_plain.setdefault(w, want)))
        out[label] = {"streamed": kernel.tables.stream, "launches": repeats, "kernel_vs_plain": vs_plain,
                      "kernel_vs_its_first": vs_first, "plain_vs_its_first": plain_moved,
                      "group_windows_with_hits": sum(int((v != INT32_MAX).sum()) for v in first_plain.values()),
                      "kernel_ms_mean": kernel_ms / repeats}
    return out


def stress_warp(device, repeats: int):
    """The warp kernels launched ``repeats`` times on each case, each launch
    against the plain result of its window: the fused sweep on both
    instances at the full-width shape (a window with a hit) and on the
    1240-unit ring (resident and streamed), and the dense guard on that
    ring's 3000 rows, both instances.  Per case as ``stress_packed``."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
    from quorum_intersection_tpu_torch.kernels.guard_cuda import BlockGuard
    from quorum_intersection_tpu_torch.kernels.guard_ref import guard_counts
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import FusedSweep, mask_bits

    full = sweep_problem(json.dumps(synth.benchmark_fbas(256, 34, broken=True)))
    ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30, broken=True))))
    ring_problem = (ring, None, list(range(40)), np.ones(40, dtype=np.int32), None)
    cases = []  # (label, stream, launch(window) -> numpy, plain(window) -> numpy, windows)
    for name, (circuit, circuit_d, local, scc_mask, frozen), lo_bits, hi, starts in (
            ("full width broken", full, 30, 0, [0, (1 << 29) + 12345]),
            ("ring(40,30) broken, 1240 units", ring_problem, 20, 0x55555, [0, 400])):
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(circuit.n, dtype=np.int32)
        for j, v in enumerate(local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, 3000, circuit_d, device)
        for stream in (False, True):
            fused = FusedSweep(circuit, lo_nodes, scc_mask, frozen, 3000, circuit_d, device, stream=stream)
            cases.append((f"sweep {name}, {'streamed' if stream else 'resident'}", stream,
                          lambda st, f=fused, h=mask_bits(hi_row): f.program(st, 2, h).cpu().numpy(),
                          lambda st, pl=plain, h=hi_row: pl.program(st, 2, h if h.any() else None).cpu().numpy(),
                          starts))
    rng = np.random.default_rng(3)
    masks = [(rng.random((3000, ring.n)) < rng.random((3000, 1))).astype(np.int8) for _ in range(2)]
    for stream in (False, True):
        guard = BlockGuard(ring, "dense", device, stream=stream)
        cases.append((f"guard ring(40,30), {'streamed' if stream else 'resident'}", stream,
                      lambda w, gd=guard: gd.counts(masks[w]),
                      lambda w: guard_counts(ring, masks[w], "dense", device).cpu().numpy(), [0, 1]))
    out = {}
    for label, stream, launch, plain_of, windows in cases:
        want = {w: plain_of(w) for w in windows}
        first = {}
        vs_plain = vs_first = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ms = 0.0
        for i in range(repeats):
            w = windows[i % len(windows)]
            start.record()
            got = launch(w)
            end.record()
            end.synchronize()
            ms += start.elapsed_time(end)
            vs_plain += int(not np.array_equal(got, want[w]))
            vs_first += int(not np.array_equal(got, first.setdefault(w, got)))
        out[label] = {"streamed": stream, "launches": repeats, "kernel_vs_plain": vs_plain,
                      "kernel_vs_its_first": vs_first, "plain_vs_its_first": 0,
                      "windows_with_hits": sum(int(np.any(v != ref.INT32_MAX)) for v in want.values())
                      if label.startswith("sweep") else None,
                      "ms_mean": ms / repeats}
    return out


def stress_failed(cases) -> bool:
    return any(r["kernel_vs_plain"] or r["kernel_vs_its_first"] or r["plain_vs_its_first"]
               for r in cases.values())


def batch_sources(fixture_names):
    """The batch phase's 16 sources, ``(label, source, expected verdict)``:
    the vendored fixtures, snapshot-shaped stellar networks (a 21-node and a
    27-node org core with inner sets), the widest packable majority core
    (31 nodes, 2^30 candidates) and a nested 1024-node network — the shape
    of a queue of snapshot checks from validator operators or an explorer
    replaying history."""
    from quorum_intersection_tpu_torch.fbas import synth

    manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
    out = [(name, fixture_text(name), manifest[name]["verdict"]) for name in fixture_names]
    for seed in (0, 1):
        for broken in (False, True):
            out.append((f"stellar_like_fbas(7,3,seed={seed},broken={broken})",
                        synth.stellar_like_fbas(7, 3, seed=seed, broken=broken), not broken))
    for broken in (False, True):
        out.append((f"stellar_like_fbas(9,3,n_watchers=300,seed=2,broken={broken})",
                    synth.stellar_like_fbas(9, 3, n_watchers=300, seed=2, broken=broken), not broken))
    for broken in (False, True):
        out.append((f"benchmark_fbas(256,core=31,broken={broken})",
                    synth.benchmark_fbas(256, 31, broken=broken), not broken))
    out.append(("benchmark_fbas(1024,core=24,nested_watchers=True)",
                synth.benchmark_fbas(1024, 24, nested_watchers=True), True))
    return out


def macs_per_pass(circuit) -> int:
    """MACs one fixpoint pass needs: one per nonzero member vote, then one
    per nonzero child vote at each child pass (a zero vote adds nothing, and
    the kernels skip the all-zero k-slabs)."""
    import numpy as np

    depth = circuit.depth if circuit.n_units > circuit.n else 0
    return int(np.count_nonzero(circuit.members)) + depth * int(np.count_nonzero(circuit.child))


def fixpoint_work(circuit, circuit_d, lo_nodes, scc_mask, frozen, start, rows, hi_row, device,
                  chunk: int = 1 << 17):
    """The fixpoint passes one sweep over candidates ``start + [0, rows)``
    needs (Q for every row, the D probe for rows with Q != 0), counted by
    the plain version ``chunk`` rows at a time."""
    import torch

    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref

    tq = ref.CircuitTables(circuit, device)
    td = tq if circuit_d is None else ref.CircuitTables(circuit_d, device)
    pos = torch.from_numpy(ref.bit_positions(lo_nodes, circuit.n)).to(device)
    passes = 0
    chunk = min(chunk, rows)
    frozen_row = None if frozen is None else tq.cast(frozen)
    scc = tq.cast(scc_mask).to(torch.int32)
    for lo in range(start, start + rows, chunk):
        avail = ref.decode_masks(lo, chunk, pos, tq.dtype)
        if hi_row is not None:
            avail = torch.maximum(avail, tq.cast(hi_row))
        q, q_passes = ref.fixpoint_passes(tq, avail)
        has_q = q.sum(dim=1) > 0
        comp = torch.clamp(scc - q[has_q].to(torch.int32), 0, 1)
        passes += int(q_passes.sum()) + int(ref.fixpoint_passes(td, comp, frozen_row)[1].sum())
    return passes


def bound(macs: int, nbytes: int):
    """``(ms, bound_by)``: the int8 MACs at the tensor-core peak against
    the bytes at the memory rate, whichever takes longer."""
    ops_ms = 2 * macs / INT8_TOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def table_bytes(circuit) -> int:
    """A circuit's tables as the kernels read them: int8 members and
    children, Q and D thresholds in int32."""
    return circuit.members.size + circuit.child.size + 8 * circuit.n_units


def packed_bound_ms(plan, starts, rows, device):
    """Least time the card could take for one packed program of ``rows``
    rows from the per-group ``starts``.  The packed circuit is
    block-diagonal, so the function needs each lane group's own fixpoints
    on its own circuit, not the fused one: per group, its rows' passes
    (Q, and the D probe where that group's Q is not empty) times that
    group's MACs per pass, summed over the groups; against each group's
    tables read once and the (K,) int32 out.  A group's passes are counted
    on the fused circuit with every other group's lanes at 0, which the
    block-diagonal layout keeps at 0: the same count as on its own circuit,
    at a shape the plain version's int8 matmul takes on the card."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.kernels import packed_ref, sweep_ref as ref

    p = plan.packed
    pos, _, lane_group, group_ind = plan.tables
    tq = ref.CircuitTables(p.circuit, device)
    td = tq if p.circuit_d is None else ref.CircuitTables(p.circuit_d, device)
    pos_t = torch.from_numpy(pos).to(device)
    lanes = torch.from_numpy(np.asarray(lane_group, dtype=np.int64)).to(device)
    starts_t = torch.from_numpy(np.asarray(starts, dtype=np.int32)).to(device)
    chunk = min(1 << 17, rows)
    macs = nbytes = passes = 0
    for g, (circuit, _) in enumerate(plan.group_circuits):
        own = tq.cast(np.asarray(group_ind)[:, g] != 0)  # group g's real lanes
        g_passes = 0
        for lo in range(0, rows, chunk):
            avail = packed_ref.decode_masks_packed((starts_t + lo)[lanes], chunk, pos_t, tq.dtype) * own
            q, q_passes = ref.fixpoint_passes(tq, avail)
            probe = (own - q)[q.any(dim=1)]  # the group's lanes outside Q, where Q is not empty
            g_passes += int(q_passes.sum()) + int(ref.fixpoint_passes(td, probe)[1].sum())
        passes += g_passes
        macs += g_passes * macs_per_pass(circuit)
        nbytes += table_bytes(circuit)
    ms, by = bound(macs, nbytes + 4 * len(plan.group_circuits))
    return ms, by, passes


def guard_rows_of(circuit, bit_nodes, guard_rows: int):
    """The maximal candidates a pruned run's planner gave the guard,
    rebuilt from its row count (one row per block, 2^prefix_bits blocks):
    ``(masks, block_bits)``."""
    from quorum_intersection_tpu_torch.backends.sweep import guard_masks

    prefix_bits = guard_rows.bit_length() - 1
    block_bits = len(bit_nodes) - prefix_bits
    return guard_masks(circuit.n, bit_nodes, block_bits, prefix_bits), block_bits


def ptxas_instances(log: str):
    """``nvcc -Xptxas -v`` output → one record per kernel instance: its
    (demangled) name, registers, and spill stores and loads in bytes."""
    import re
    import shutil

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    names = list(out)
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        shown = subprocess.run([filt, *names], capture_output=True, text=True, timeout=60).stdout.splitlines()
    except OSError:
        shown = []
    if len(shown) != len(names):
        shown = names
    return [{"kernel": label, **out[name]} for name, label in zip(names, shown)
            if "kernel" in label and out[name]]


def device_ms_by_kernel(prof):
    """Device milliseconds per kernel name under a ``torch.profiler`` run."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / 1e3
    return out


def profiler_records(device) -> int:
    """Device events one ``torch.profiler`` session records around a
    PyTorch reduction: 0 where the profiler sees no device activity at this
    point of the process."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.ones(1 << 20, device=device).sum()
        torch.cuda.synchronize()
    return len(device_ms_by_kernel(prof))


def ms_of(by_kernel, *needles) -> float:
    return sum(ms for name, ms in by_kernel.items() if all(n in name for n in needles))


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, spin_cycles: int = 2_000_000) -> float:
    """ms a call on the device alone: each call queued behind a spin of the
    stream (``torch.cuda._sleep``), so that the host's launch cost stays off
    the clock, with CUDA events around it; the mean over ``reps``."""
    import torch

    fn()
    total = 0.0
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def window_bound_ms(circuit, circuit_d, lo_nodes, scc_mask, frozen, start, hi_row, device,
                    chunk: int = 1 << 17):
    """Least time the card could take for one window of the fused sweep:
    the MACs of the fixpoint passes its rows need, against the bytes
    (tables and decode table in, one int32 out)."""
    passes = fixpoint_work(circuit, circuit_d, lo_nodes, scc_mask, frozen, start, WINDOW, hi_row,
                           device, chunk)
    ms, by = bound(passes * macs_per_pass(circuit), table_bytes(circuit) + 4 * len(lo_nodes) + 4)
    return ms, by, passes


# A fresh process's first gpu-sweep solve against its second: the first-solve
# overhead the auto router's budget charges the sweep.  argv: the FBAS file,
# "warm" (the checkout's kernels/_build/) or "cold" (an empty build directory).
FIRST_SOLVE_PROBE = r"""
import json, pathlib, shutil, sys, tempfile, time
import torch
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.pipeline import solve
tmp = None
if sys.argv[2] == "cold":
    tmp = build.BUILD_DIR = pathlib.Path(tempfile.mkdtemp(prefix="qi-cold-build-"))
try:
    text = pathlib.Path(sys.argv[1]).read_text()
    t1 = time.perf_counter()
    first = solve(text, backend="gpu-sweep", with_cert=False)
    t2 = time.perf_counter()
    second = solve(text, backend="gpu-sweep", with_cert=False)
    t3 = time.perf_counter()
finally:
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)
print(json.dumps({"first_s": t2 - t1, "second_s": t3 - t2, "overhead_s": (t2 - t1) - (t3 - t2),
                  "verdict": first.intersects}))
"""


# A fresh process's first PageRank kernel call against its second: the CUDA
# context and library load a `-p` process pays before the kernel route can
# win; then a third call under the profiler, K12's device ms as a fresh
# process's profiler sees it.  argv: the watcher count of the
# stellar_like_fbas graph.
PAGERANK_FIRST_CALL_PROBE = r"""
import json, sys, time
import torch
from quorum_intersection_tpu_torch.analytics.pagerank import power_iteration
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.fbas.graph import build_graph
from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
graph = build_graph(parse_fbas(synth.stellar_like_fbas(n_watchers=int(sys.argv[1]), seed=7)))
t1 = time.perf_counter()
power_iteration(graph)
t2 = time.perf_counter()
power_iteration(graph)
t3 = time.perf_counter()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    power_iteration(graph)
    torch.cuda.synchronize()
traced = {e.key: getattr(e, "self_device_time_total", 0) / 1e3 for e in prof.key_averages()}
print(json.dumps({"first_s": t2 - t1, "second_s": t3 - t2, "overhead_s": (t2 - t1) - (t3 - t2),
                  "profiled_kernel_ms": sum(ms for k, ms in traced.items() if "pagerank_kernel" in k),
                  "profiled_events": len(traced)}))
"""

# The C15 quirk graphs of the PageRank comparison (the JAX package's
# tests/test_pagerank.py cases).  All but self-loop never converge (their
# mass swings) and run to a cap of 1000 iterations; cycle5 also at the caps
# 0, 1 and 7.
PAGERANK_QUIRKS = {
    "parallel-edges": [
        {"publicKey": "A", "quorumSet": {"threshold": 1, "validators": ["B", "B", "C"]}},
        {"publicKey": "B", "quorumSet": {"threshold": 1, "validators": ["A"]}},
        {"publicKey": "C", "quorumSet": {"threshold": 1, "validators": ["A"]}},
    ],
    "self-loop": [
        {"publicKey": "A", "quorumSet": {"threshold": 1, "validators": ["A", "B"]}},
        {"publicKey": "B", "quorumSet": {"threshold": 2, "validators": ["A", "B", "B"]}},
        {"publicKey": "C", "quorumSet": {"threshold": 1, "validators": ["C", "A"]}},
    ],
    "dangling": [
        {"publicKey": "A", "quorumSet": {"threshold": 1, "validators": ["B"]}},
        {"publicKey": "B", "quorumSet": None},
    ],
    "cycle5": [{"publicKey": f"C{i}", "quorumSet": {"threshold": 1, "validators": [f"C{(i + 1) % 5}"]}}
               for i in range(5)],
}
# Watcher counts of the stellar_like_fbas(seed=7) graphs PageRank is timed
# on: from the fixtures' size through the dump's (2971 nodes with n_null=150,
# n_dangling=40) to 200k nodes and about a million edges.
PAGERANK_SIZES = (30, 100, 300, 1000, 2800, 6000, 20_000, 200_000)


# Per entry: rtol 1e-3 and atol 1e-3 * m / n.  No rank is below m / n (a
# vertex nobody trusts gets the base m / n over a total of at most 1), so
# every entry, a watcher's included, is held to a thousandth of itself.  The
# JAX package's own tolerances (atol 2e-5; rtol 2e-3 + atol 2e-6 from 5k
# nodes) hold too: alone they exceed a watcher's rank and would pass a
# kernel that got every such entry wrong.
PAGERANK_RTOL = 1e-3
PAGERANK_TOLERANCE = ("each entry within rtol 1e-3 + atol 1e-3*m/n, and within atol 2e-5 "
                      "(rtol 2e-3 + atol 2e-6 from 5k nodes)")


def jax_tolerance(want):
    import numpy as np

    return 2e-6 + 2e-3 * np.abs(want) if len(want) >= 5000 else np.full(len(want), 2e-5)


def pagerank_close(got, want, m) -> float:
    """Max abs error, or inf past the tolerance."""
    import numpy as np

    diff = np.abs(np.asarray(got, dtype=np.float64) - want)
    tol = np.minimum(PAGERANK_RTOL * np.abs(want) + PAGERANK_RTOL * m / max(len(want), 1), jax_tolerance(want))
    return float(diff.max(initial=0.0)) if bool(np.all(diff <= tol)) else float("inf")


def pagerank_faults(ranks, row_ptr):
    """Wrong variants of a correct rank vector the check must refuse: the
    vertices with no in-edges zeroed, and the base term m / n dropped
    (every entry less such a vertex's rank, base / total)."""
    import numpy as np

    unreached = np.flatnonzero(np.diff(row_ptr) == 0)
    zeroed = ranks.copy()
    zeroed[unreached] = 0.0
    return {"unreached zeroed": zeroed, "base dropped": ranks - ranks[unreached[0]]}


def pagerank_bound(n: int, n_edges: int, iterations: int):
    """``(ms, by)``: the least time for one call of the loop, the larger of
    its bytes (row_ptr, src and outdeg read once, the ranks and the two
    scalars written once) at 3.35 TB/s and its float32 operations (per
    iteration an add a CSR entry and about 9 a vertex: send, the base, the
    two sums, |tmp - rank|, the division) at 67 TFLOP/s."""
    nbytes = 4 * (n + 1) + 4 * n_edges + 4 * n + 4 * n + 8
    ops = iterations * (n_edges + 9 * n)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def pagerank_iteration_bytes(n: int, n_edges: int) -> int:
    """Bytes one iteration moves when each of its vectors comes from memory
    once: src (4 E), row_ptr, outdeg, the ranks read and written, one read
    of send (about 20 n)."""
    return 4 * n_edges + 20 * n


PARENT_SEGMENT_ENTRIES = 1024  # the three-barrier kernel's segment length (its pagerank_cuda.SEGMENT_ENTRIES)


class ParentK12:
    """K12 of another tree (its ``csrc/pagerank.cu`` with the C interface of
    the three-barrier kernel: a segment pointer built by the caller, the
    grid asked per call), built with ``nvcc`` beside this tree's: ``call`` does what that
    tree's wrapper did on every call (the grid query, the segment pointer
    by four PyTorch kernels, nine tensors, the launch), ``prepare`` and
    ``launch`` the launch alone."""

    def __init__(self, tree, work):
        import ctypes

        from quorum_intersection_tpu_torch.kernels import build

        self.src = pathlib.Path(tree) / PORT / "kernels" / "csrc" / "pagerank.cu"
        lib_path = work / "parent_pagerank.so"
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(self.src)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail("timing_pagerank", f"nvcc refused {self.src}: {(proc.stdout + proc.stderr)[-2000:]}")
        self.ptxas = ptxas_instances(proc.stdout + proc.stderr)
        lib = self.lib = ctypes.CDLL(str(lib_path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.qi_pagerank_grid.argtypes = [ctypes.c_longlong, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.qi_pagerank_grid.restype = i
        lib.qi_pagerank.argtypes = [i, p, p, p, p, i, f, f, i, p, p, p, p, p, p, i, p, p, p]
        lib.qi_pagerank.restype = i

    def prepare(self, csr):
        import ctypes

        import torch

        row_ptr, src, outdeg = csr
        n, seg = outdeg.numel(), PARENT_SEGMENT_ENTRIES
        bound = n + -(-src.numel() // seg)
        grid, coop = ctypes.c_int(0), ctypes.c_int(0)
        if self.lib.qi_pagerank_grid(max(n, 32 * bound), ctypes.byref(grid), ctypes.byref(coop)) != 0:
            fail("timing_pagerank", "the parent's grid query failed")
        seg_ptr = torch.zeros(n + 1, dtype=torch.int32, device=outdeg.device)
        degree = row_ptr[1:] - row_ptr[:-1]
        seg_ptr[1:] = torch.cumsum((degree + seg - 1) // seg, dim=0, dtype=torch.int32)
        f32 = dict(dtype=torch.float32, device=outdeg.device)
        i32 = dict(dtype=torch.int32, device=outdeg.device)
        bufs = [torch.empty(n, **f32), torch.empty(n, **f32), torch.empty(n, **f32), torch.empty(bound, **f32),
                torch.empty(bound, **i32), torch.empty(3 * grid.value, **f32), torch.empty(1, **i32),
                torch.empty(1, **f32)]
        return grid.value, seg_ptr, bufs

    def launch(self, csr, prepared, m, conv, cap):
        import torch

        grid, seg_ptr, bufs = prepared
        row_ptr, src, outdeg = csr
        err = self.lib.qi_pagerank(
            outdeg.numel(), row_ptr.data_ptr(), src.data_ptr(), outdeg.data_ptr(), seg_ptr.data_ptr(),
            PARENT_SEGMENT_ENTRIES, float(m), float(conv), int(cap), *[b.data_ptr() for b in bufs[:6]], grid,
            bufs[6].data_ptr(), bufs[7].data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail("timing_pagerank", f"the parent's K12 launch failed: error {err}")
        return bufs[0], bufs[6][0], bufs[7][0]

    def call(self, csr, m, conv, cap):
        return self.launch(csr, self.prepare(csr), m, conv, cap)


def k12_body(csr, shape):
    """This tree's K12 launch alone (the C call on a workspace made once, at
    ``shape``): ``launch(m, conv, cap) -> (rank, iterations, diff)``."""
    import torch

    from quorum_intersection_tpu_torch.kernels import pagerank_cuda

    lib = pagerank_cuda._library()
    row_ptr, src, outdeg = csr
    n, n_edges = outdeg.numel(), src.numel()
    ws = torch.empty(-(-lib.qi_pagerank_bytes(n, n_edges, shape.seg, shape.grid) // 4), dtype=torch.float32,
                     device=outdeg.device)
    k = -(-n // 4) * 4

    def launch(m, conv, cap):
        err = lib.qi_pagerank(n, n_edges, row_ptr.data_ptr(), src.data_ptr(), outdeg.data_ptr(), float(m),
                              float(conv), int(cap), shape.seg, pagerank_cuda.THREADS, shape.grid, ws.data_ptr(),
                              None, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail("timing_pagerank", f"K12 launch failed: error {err}")
        return ws[:n], ws[k:k + 1].view(torch.int32)[0], ws[k + 1]

    return launch


def per_iteration_ms(fn) -> float:
    """ms an iteration: ``fn(cap)`` at 201 against 1 forced iterations,
    back to back, over 200."""
    return (time_ms(lambda: fn(201), 5) - time_ms(lambda: fn(1), 5)) / 200


def k12_split(csr, ms_per_iteration, want):
    """K12's timed instance over 201 forced iterations (its result held to
    the untimed kernel's ``want`` bit for bit): the cycles warp 0 of block 0
    spends in each part of an iteration, their shares, each share of the
    measured ``ms_per_iteration``, and the grid barriers it passed an
    iteration and in the prologue, as it counted them."""
    import torch

    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import TIMED_PHASES, pagerank_timed

    total, calls = None, 5
    for _ in range(calls):
        rank, iterations, diff, timing = pagerank_timed(*csr, 0.15, -1.0, 201)
        if not (torch.equal(rank, want[0]) and int(iterations) == int(want[1])):
            fail("timing_pagerank", "K12's timed instance differs from the untimed kernel")
        total = timing.clone() if total is None else total + timing
    counts = total.tolist()
    k = len(TIMED_PHASES)
    iterations, loop_barriers, prologue_barriers = counts[k:k + 3]
    per_iter = {name: c / iterations for name, c in zip(TIMED_PHASES, counts)}
    whole = sum(per_iter.values())
    return {"iterations": iterations, "cycles_per_iteration": per_iter, "cycles_per_iteration_total": whole,
            "share": {name: c / whole for name, c in per_iter.items()},
            "ms_per_iteration_by_share": {name: ms_per_iteration * c / whole for name, c in per_iter.items()},
            "clock_mhz_implied": whole / (ms_per_iteration * 1e3),
            "barriers_per_iteration": loop_barriers / iterations,
            "prologue_barriers_per_call": prologue_barriers / calls,
            "of": f"clock64() and the grid barriers counted by warp 0 of block 0 over {calls} calls "
                  "of 201 forced iterations (m=0.15)"}


def shape_label(s) -> str:
    return f"{s.grid} blocks, segments of {s.seg}"


def shape_record(s) -> dict:
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import THREADS

    return {"threads": THREADS, "blocks": s.grid, "segment_entries": s.seg}


def k12_shapes(csr, shapes, want_forced):
    """This tree's K12 launch alone (:func:`k12_body`) at each launch shape
    in turns (A B C ... C B A): ms an iteration and ms a call on the device
    alone, each result held to the plain version's ranks after 60 forced
    iterations."""
    res = {shape_label(s): {"per_iteration_ms": [], "call_ms_device_alone": []} for s in shapes}
    bodies = {shape: k12_body(csr, shape) for shape in shapes}
    for shape in list(shapes) + list(reversed(shapes)):
        row, body = res[shape_label(shape)], bodies[shape]
        got = body(0.15, -1.0, 60)
        if int(got[1]) != 60 or pagerank_close(got[0].cpu().numpy(), want_forced, 0.15) == float("inf"):
            fail("timing_pagerank", f"K12 at {shape} disagrees with the plain version")
        row["per_iteration_ms"].append(per_iteration_ms(lambda cap: body(0.15, -1.0, cap)))
        row["call_ms_device_alone"].append(device_ms(lambda: body(0.0001, 0.0001, 100000), 10))
    return res


def k12_parent_turns(parent, csr, want, m=0.0001):
    """K12's bodies in turns with the other tree's (parent, this, this,
    parent): per call through a wrapper (this tree's ``pagerank_power``;
    for the other tree :meth:`ParentK12.call`, this script's copy of what
    the three-barrier kernel's wrapper did a call) and by the launch alone, back to back (20 calls) and on the device alone (10 calls behind
    a stream spin), and per iteration by the launch alone; each result held
    to the plain version's ``want`` (ranks, iterations)."""
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import device_limits, launch_shape, pagerank_power

    row_ptr, src, outdeg = csr
    shape = launch_shape(outdeg.numel(), src.numel(), *device_limits(outdeg.device))
    this_body = k12_body(csr, shape)
    prepared = parent.prepare(csr)
    arms = {
        "parent": (lambda m, conv, cap: parent.launch(csr, prepared, m, conv, cap),
                   lambda m, conv, cap: parent.call(csr, m, conv, cap)),
        "this": (this_body, lambda m, conv, cap: pagerank_power(*csr, m, conv, cap)),
    }
    keys = ("body_call_ms_back_to_back", "body_call_ms_device_alone", "wrapper_call_ms_back_to_back",
            "wrapper_call_ms_device_alone", "body_per_iteration_ms")
    res = {who: {k: [] for k in keys} for who in arms}
    for who in ("parent", "this", "this", "parent"):
        body, wrapper = arms[who]
        for fn in (body, wrapper):
            got = fn(m, 0.0001, 100000)
            if int(got[1]) != want[1] or pagerank_close(got[0].cpu().numpy(), want[0], m) == float("inf"):
                fail("timing_pagerank", f"the {who} tree's K12 disagrees with the plain version")
        row = res[who]
        row["body_call_ms_back_to_back"].append(time_ms(lambda: body(m, 0.0001, 100000), 20))
        row["body_call_ms_device_alone"].append(device_ms(lambda: body(m, 0.0001, 100000), 10))
        row["wrapper_call_ms_back_to_back"].append(time_ms(lambda: wrapper(m, 0.0001, 100000), 20))
        row["wrapper_call_ms_device_alone"].append(device_ms(lambda: wrapper(m, 0.0001, 100000), 10))
        row["body_per_iteration_ms"].append(per_iteration_ms(lambda cap: body(0.15, -1.0, cap)))
    res["this_shape"] = shape_record(shape)
    res["of"] = f"the other tree's body from {parent.src}; its ptxas {parent.ptxas}"
    return res


def call_profile(device, fn):
    """One call of ``fn`` under ``torch.profiler`` (device activity only),
    after a control reduction in the same session (the profiler of a long
    process records intermittently, one session to the next): whether the
    session recorded the control, the call's device events by name with the
    control's one launch taken out, its kernels and any host-to-device
    copy."""
    import torch

    x = torch.ones(1 << 20, device=device)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        x.sum()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = device_ms_by_kernel(prof)
    counts = {}
    for e in prof.key_averages():
        if e.key in events:
            counts[e.key] = counts.get(e.key, 0) + e.count
    # The control launches one reduction kernel: that one launch goes, any
    # other launch of the same kernel stays the call's.
    control = next((k for k in events if "reduce_kernel" in k), None)
    if control is not None:
        counts[control] -= 1
    call = {k: ms for k, ms in events.items() if counts[k] > 0}
    kernels = {k: ms for k, ms in call.items() if not k.startswith(("aten::", "Memcpy", "Memset", "Activity "))}
    h2d = [k for k in call if "HtoD" in k]
    return {"control_recorded": control is not None, "kernels": kernels, "host_to_device": h2d,
            "events": call, "launches": {k: counts[k] for k in call}}


# Trust graphs built once a run, by label: phase native scans the 200k
# network the PageRank phases built.
GRAPHS = {}


def pagerank_phases(device, card, texts, work, k12_parent=None):
    """Phases compare_pagerank, timing_pagerank and pagerank_cli, and K12's
    main-path run; returns the kernel's record entry.  ``k12_parent``: a
    checkout whose K12 body timing_pagerank times in turns with this one."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.analytics import pagerank as pr
    from quorum_intersection_tpu_torch.backends import calibration as cal_mod
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import (
        LaunchShape,
        device_limits,
        launch_shape,
        pagerank_power,
    )
    from quorum_intersection_tpu_torch.kernels.pagerank_ref import power_loop

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_pagerank_graphs import heavy_row_fbas
    from _torch_pagerank_schedule import schedule

    limits = device_limits(device)

    def stellar(n_watchers, **kw):
        return synth.stellar_like_fbas(n_watchers=n_watchers, seed=7, **kw)

    graphs = GRAPHS

    def graph_of(label, data=None):
        if label not in graphs:
            graphs[label] = build_graph(parse_fbas(data))
        return graphs[label]

    def run_both(graph, m=0.0001, conv=0.0001, cap=100000):
        """K12 and its plain version on one CSR; where their iteration counts
        are one apart at the stop test's edge, the plain version once more,
        forced to the kernel's count, for the ranks' comparison."""
        csr = [torch.from_numpy(a).to(device) for a in pr.in_edge_csr(graph)]
        got = pagerank_power(*csr, m, conv, cap)
        got = (got[0].cpu().numpy(), int(got[1]), float(got[2]))
        want = power_loop(*csr, m, conv, cap)
        want = (want[0].cpu().numpy(), int(want[1]), float(want[2]))
        same_count = want
        if got[1] != want[1]:
            forced = power_loop(*csr, m, -1.0, got[1])
            same_count = (forced[0].cpu().numpy(), int(forced[1]), float(forced[2]))
        return got, want, same_count

    def model_bits(graph, got, m, conv, cap) -> bool:
        """Whether K12's result is ``tests/_torch_pagerank_schedule``'s, bit
        for bit, at the wrapper's launch shape."""
        shape = launch_shape(graph.n, graph.n_edges, *limits)
        rank, it, diff = schedule(*pr.in_edge_csr(graph), m, conv, cap, shape.grid, shape.seg)
        return rank.tobytes() == got[0].tobytes() and it == got[1] and np.float32(diff) == np.float32(got[2])

    def numpy_stops_after(graph, m, cap, k) -> bool:
        """Whether NumPy's model runs exactly k iterations: k gives its
        ranks bit for bit and k - 1 does not."""
        want = pr.pagerank_np(graph, m=m, max_iterations=cap)
        return np.array_equal(pr.pagerank_np(graph, m=m, max_iterations=k), want) and (
            k == 0 or not np.array_equal(pr.pagerank_np(graph, m=m, max_iterations=k - 1), want))

    # -- compare_pagerank ---------------------------------------------------
    cases = [(name, graph_of(name, text), 0.0001, 100000) for name, text in texts.items()]
    cases += [(name, graph_of(name, data), 0.0001, 100000 if name == "self-loop" else 1000)
              for name, data in PAGERANK_QUIRKS.items()]
    cases += [(f"cycle5 m=0.15 max_iterations={cap}", graph_of("cycle5"), 0.15, cap) for cap in (0, 1, 7)]
    dump_label = "stellar_like_fbas(n_watchers=2800,n_null=150,n_dangling=40,seed=7)"
    dump_shape = graph_of(dump_label, stellar(2800, n_null=150, n_dangling=40))
    cases.append((dump_label, dump_shape, 0.0001, 100000))
    heavy_label = "heavy_row_fbas(100000)"
    heavy = graph_of(heavy_label, heavy_row_fbas(100_000))
    cases.append((heavy_label, heavy, 0.0001, 100000))
    full_label = "stellar_like_fbas(n_watchers=200000,seed=7)"
    full = graph_of(full_label, stellar(200_000))
    cases.append((full_label, full, 0.0001, 100000))
    rows, max_err, faults = [], 0.0, []
    for label, graph, m, cap in cases:
        (got, it_got, diff_got), (_, it_want, diff_want), (want, _, _) = run_both(graph, m, 0.0001, cap)
        # NumPy's model run for the kernel's iteration count (its own stop
        # test sums in another order).
        ref_np = pr.pagerank_np(graph, m=m, convergence=-1.0, max_iterations=it_got)
        err_plain = pagerank_close(got, want, m)
        err_np = pagerank_close(got, ref_np, m)
        # The plain version's count, or one apart at the stop test's edge.
        # The heavy-row graph alone: its row of 100 003 entries puts the
        # plain version's float32 diff near conv, so there NumPy's count
        # (its rows summed in float64) holds the kernel's instead.
        by_plain = it_got == it_want or (abs(it_got - it_want) == 1
                                         and abs(min(diff_got, diff_want) - 1e-4) <= 1e-7)
        iterations_ok = numpy_stops_after(graph, m, cap, it_got) if graph is heavy else by_plain
        if err_plain == float("inf") or err_np == float("inf") or not iterations_ok:
            fail("compare_pagerank", f"{label}: kernel against plain {np.abs(got - want).max()} "
                                     f"and NumPy {np.abs(got - ref_np).max()}, iterations {it_got} / {it_want}")
        if cap == 0 and not (it_got == 0 and got[0] == 1.0 and not got[1:].any()):
            fail("compare_pagerank", f"{label}: max_iterations 0 did not return e0")
        if not model_bits(graph, (got, it_got, diff_got), m, 0.0001, cap):
            fail("compare_pagerank", f"{label}: K12 differs from the CPU model of its schedule")
        if graph is dump_shape or graph is full:
            # The check must refuse a kernel that got the watchers' ranks
            # wrong; the JAX package's tolerance, for the record, would not.
            for fault, wrong in pagerank_faults(got, pr.in_edge_csr(graph)[0]).items():
                if pagerank_close(wrong, want, m) != float("inf"):
                    fail("compare_pagerank", f"{label}: the check passed the planted fault {fault!r}")
                faults.append({"graph": label, "fault": fault, "refused": True,
                               "jax_tolerance_refuses": not bool(np.all(np.abs(wrong - want)
                                                                        <= jax_tolerance(want)))})
        max_err = max(max_err, err_plain)
        rows.append({"graph": label, "n": graph.n, "edges": graph.n_edges, "m": m, "max_iterations": cap,
                     "iterations": [it_got, it_want], "last_diff": [diff_got, diff_want],
                     "iterations_held_to": "numpy" if graph is heavy else "plain",
                     "max_abs_err_plain": err_plain, "max_abs_err_numpy": err_np, "model_bits_equal": True})
    # At full width with the cap binding: 60 iterations, against the plain
    # version and the model.
    (got, it_got, diff_got), (want, it_want, _), _ = run_both(full, 0.15, -1.0, 60)
    err = pagerank_close(got, want, 0.15)
    if err == float("inf") or not it_got == it_want == 60:
        fail("compare_pagerank", f"200k nodes, 60 forced iterations: {it_got} / {it_want}, "
                                 f"err {np.abs(got - want).max()}")
    if not model_bits(full, (got, it_got, diff_got), 0.15, -1.0, 60):
        fail("compare_pagerank", "200k nodes, 60 forced iterations: K12 differs from the CPU model")
    max_err = max(max_err, err)
    rows.append({"graph": f"{full_label} m=0.15 forced", "n": full.n,
                 "edges": full.n_edges, "iterations": [it_got, it_want], "max_abs_err_plain": err,
                 "model_bits_equal": True})
    # Determinism: the same bits from launch to launch (the heavy rows'
    # tickets are drawn in another order each time).
    repeats = {}
    for label, graph in ((heavy_label, heavy), (full_label, full)):
        csr = [torch.from_numpy(a).to(device) for a in pr.in_edge_csr(graph)]
        first = pagerank_power(*csr, 0.0001, 0.0001, 100000)
        first = (first[0].clone(), int(first[1]), float(first[2]))
        same = 0
        for _ in range(20):
            again = pagerank_power(*csr, 0.0001, 0.0001, 100000)
            same += torch.equal(again[0], first[0]) and int(again[1]) == first[1] and float(again[2]) == first[2]
        if same != 20:
            fail("compare_pagerank", f"{label}: {20 - same} of 20 launches differ from the first in their bits")
        repeats[label] = {"launches": 21, "bit_identical": same + 1}
    phase_line("compare_pagerank", tolerance=f"{PAGERANK_TOLERANCE}; iterations equal or one apart at the "
                                             "stop test's edge (then the ranks after the same count); "
                                             "and bit for bit the CPU model of the schedule",
               graphs=rows, planted_faults=faults, determinism=repeats)

    # -- timing_pagerank ----------------------------------------------------
    def host_ms(fn, reps):
        fn()
        out = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return sorted(out)[len(out) // 2]

    so, se, rc, _ = run_all([[sys.executable, "-c", PAGERANK_FIRST_CALL_PROBE, "20000"]])[0]
    if rc != 0:
        fail("timing_pagerank", f"first-call probe exit {rc}: {se[-600:]!r}")
    first_call = json.loads(so.strip().splitlines()[-1])
    timing = []
    for n_watchers in PAGERANK_SIZES:
        graph = graph_of(f"stellar_like_fbas(n_watchers={n_watchers},seed=7)", stellar(n_watchers))
        csr = [torch.from_numpy(a).to(device) for a in pr.in_edge_csr(graph)]
        _, iterations, _ = pr.power_iteration(graph)
        reps = 5 if graph.n < 100_000 else 3
        kernel_ms = time_ms(lambda: pagerank_power(*csr, 0.0001, 0.0001, 100000), 20)
        bound_ms, bound_by = pagerank_bound(graph.n, graph.n_edges, iterations)
        shape = launch_shape(graph.n, graph.n_edges, *limits)
        timing.append({
            "n": graph.n, "edges": graph.n_edges, "iterations": iterations,
            "grid": shape_record(shape),
            "call_ms": host_ms(lambda: pr.power_iteration(graph), reps),
            "kernel_ms": kernel_ms,
            "kernel_ms_device_alone": device_ms(lambda: pagerank_power(*csr, 0.0001, 0.0001, 100000), 10),
            # The launch, the prologue and the rank written, no iteration.
            "kernel_ms_device_alone_no_iteration": device_ms(lambda: pagerank_power(*csr, 0.0001, 0.0001, 0), 10),
            "per_iteration_ms": per_iteration_ms(lambda cap: pagerank_power(*csr, 0.15, -1.0, cap)),
            "per_iteration_bound_ms": pagerank_iteration_bytes(graph.n, graph.n_edges) / HBM_BYTES_PER_S * 1e3,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plain_ms": time_ms(lambda: power_loop(*csr, 0.0001, 0.0001, 100000), 3),
            "numpy_ms": host_ms(lambda: pr.pagerank_np(graph), reps),
            "library_ms": None,
        })
    # The timed instance's split of an iteration at the 200k graph and the
    # dump's shape.  With another tree, at both its body in turns with this
    # one, and this one's launch shapes in turns there and at 20k (the work
    # rule's grid against a block per 1024 vertices).
    split, shapes, parent_turns = {}, {}, {}
    parent = ParentK12(k12_parent, work) if k12_parent is not None else None
    mid_label = "stellar_like_fbas(n_watchers=20000,seed=7)"
    for label, graph in ((full_label, full), (dump_label, dump_shape), (mid_label, graph_of(mid_label))):
        csr = [torch.from_numpy(a).to(device) for a in pr.in_edge_csr(graph)]
        shape = launch_shape(graph.n, graph.n_edges, *limits)
        if label != mid_label:
            untimed = pagerank_power(*csr, 0.15, -1.0, 201)
            split[label] = k12_split(csr, per_iteration_ms(lambda cap: pagerank_power(*csr, 0.15, -1.0, cap)),
                                     untimed)
            split[label]["grid"] = shape_record(shape)
        if parent is not None:
            if graph is full:
                candidates = [shape, LaunchShape(limits[0], 512), LaunchShape(2 * limits[0], 512)]
            elif graph is dump_shape:
                candidates = [shape, LaunchShape(3, 1024), LaunchShape(33, 128)]
            else:
                candidates = [shape, LaunchShape(20, 1024)]
            candidates = [s for s in dict.fromkeys(candidates) if s.grid <= limits[0] * limits[1]]
            want_forced = power_loop(*csr, 0.15, -1.0, 60)[0].cpu().numpy()
            shapes[label] = k12_shapes(csr, candidates, want_forced)
            if label != mid_label:
                want = power_loop(*csr, 0.0001, 0.0001, 100000)
                parent_turns[label] = k12_parent_turns(parent, csr, (want[0].cpu().numpy(), int(want[1])))
    # The floor `-p` routes by: the fewest edges from which the kernel route,
    # a fresh process's first-call overhead included, beat NumPy at every
    # larger measured size (None: at no size).  The route in a process that
    # holds its CUDA context already is printed beside it.
    overhead_ms = first_call["overhead_s"] * 1e3
    wins_warm = [r["call_ms"] < r["numpy_ms"] for r in timing]
    wins_fresh = [r["call_ms"] + overhead_ms < r["numpy_ms"] for r in timing]
    floor = next((timing[i]["edges"] for i in range(len(timing)) if all(wins_fresh[i:])), None)
    phase_line("timing_pagerank", card=card, first_call=first_call, per_graph=timing,
               timed_split=split, grid_shapes_in_turns=shapes or None, parent_in_turns=parent_turns or None,
               kernel_wins_in_a_fresh_process=wins_fresh, kernel_wins_with_the_context_made=wins_warm,
               measured={"pagerank_min_edges": floor},
               committed={"pagerank_min_edges": cal_mod.H100.pagerank_min_edges},
               committed_for=cal_mod.H100.kind)

    # -- the main path: the library's entry point `pagerank` on the card (the
    # committed floor keeps `-p` on NumPy), then `pagerank_auto` ------------
    dump = graph_of("dump_scale_correct.json.gz")
    floor = cal_mod.H100.pagerank_min_edges
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    pagerank_power.launches = 0
    main_rows = []
    for label, graph in (("dump_scale_correct.json.gz", dump), (full_label, full)):
        start.record()
        ranks, iterations, _ = pr.power_iteration(graph)
        end.record()
        torch.cuda.synchronize()
        call_ms = start.elapsed_time(end)
        launched = pagerank_power.launches
        route_ranks, engine = pr.pagerank_auto(graph)
        want_engine = "cuda" if floor is not None and graph.n_edges >= floor else "numpy"
        if engine != want_engine or pagerank_power.launches != launched + (engine == "cuda"):
            fail("pagerank_cli", f"pagerank_auto on {label} took {engine}, the floor {floor} says {want_engine}")
        err = pagerank_close(ranks, pr.pagerank_np(graph, convergence=-1.0, max_iterations=iterations), 0.0001)
        if err == float("inf") or pagerank_close(route_ranks, pr.pagerank_np(graph), 0.0001) == float("inf"):
            fail("pagerank_cli", f"{label}: pagerank or pagerank_auto ({engine}) disagrees with pagerank_np")
        main_rows.append({"graph": label, "edges": graph.n_edges, "call_ms_by_events": call_ms,
                          "pagerank_auto_engine": engine, "max_abs_err_numpy": err})
    launches = pagerank_power.launches
    if launches < 2:
        fail("pagerank_cli", f"the PageRank main path launched pagerank_cuda {launches} times, not 2")
    # The main-path call once more under the profiler, with a PyTorch
    # reduction beside it as a control of what the profiler records here;
    # then one wrapper call on the uploaded CSR: K12 alone, no other kernel
    # and no host-to-device copy.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.ones(1 << 20, device=device).sum()
        pr.pagerank(full)
        torch.cuda.synchronize()
    profiled = device_ms_by_kernel(prof)
    main_device_ms = ms_of(profiled, "pagerank_kernel") or None
    profiler_saw = {"events": len(profiled), "kernel": main_device_ms is not None,
                    "control": any("reduce" in k for k in profiled)}
    full_csr = [torch.from_numpy(a).to(device) for a in pr.in_edge_csr(full)]
    one_call = call_profile(device, lambda: pagerank_power(*full_csr, 0.0001, 0.0001, 100000))
    if one_call["control_recorded"] and (one_call["host_to_device"] or len(one_call["kernels"]) != 1
                                         or not ms_of(one_call["kernels"], "pagerank_kernel")):
        fail("pagerank_cli", f"a pagerank_power call is not K12 alone under the profiler: {one_call}")

    # -- pagerank_cli: the CLI as a user runs it ------------------------------
    full_file = work / "stellar_200k.json"
    full_file.write_text(json.dumps(stellar(200_000)))
    dump_text = texts["dump_scale_correct.json.gz"]
    cmds = [[sys.executable, "-m", PORT, "-p"], [sys.executable, "-m", PORT, "-p", "-t"]]
    runs = run_all(cmds, inputs=[dump_text, full_file.read_text()], parallel=2)
    cli_rows = []
    for cmd, (so, se, rc, secs) in zip(cmds, runs):
        cli_rows.append({"argv": cmd[3:], "exit": rc, "process_s": secs})
        if rc != 0:
            fail("pagerank_cli", f"{cmd[3:]}: exit {rc} {se[-400:]!r}")
    # A CLI process routes by the committed floor: NumPy below it (the
    # lines byte for byte those of format_pagerank(pagerank_np)), the kernel
    # from it up (the printed ranks within tolerance).
    routes = {}
    for (so, se, _, _), (label, graph) in zip(runs, (("dump_scale_correct.json.gz", dump), (full_label, full))):
        route = routes[label] = "cuda" if floor is not None and graph.n_edges >= floor else "numpy"
        lines = so.splitlines()
        if route == "numpy" and so != pr.format_pagerank(graph, pr.pagerank_np(graph)):
            fail("pagerank_cli", f"-p on {label}: lines differ from format_pagerank(pagerank_np)")
        printed = dict(line.rsplit(": ", 1) for line in lines[1:])
        values = np.asarray([float(printed[graph.label(v)]) for v in range(graph.n)], dtype=np.float64)
        if (lines[:1] != ["PageRank:"] or len(lines) != graph.n + 1
                or pagerank_close(values, pr.pagerank_np(graph), 0.0001) == float("inf")):
            fail("pagerank_cli", f"-p on {label}: the printed ranks disagree with pagerank_np")
    if f"pagerank engine: {routes[full_label]}" not in runs[1][1]:
        fail("pagerank_cli", f"-p -t on 200k nodes took another route than the floor's: {runs[1][1][-300:]!r}")
    phase_line("pagerank_cli", card=card, main_path=main_rows, launches={"pagerank_cuda": launches},
               profiler=profiler_saw, profiled_ms=profiled, one_wrapper_call=one_call, cli=cli_rows,
               cli_routes=routes, floor=floor,
               cli_lines="byte-equal to format_pagerank(pagerank_np) on the numpy route")
    t200 = timing[-1]
    return {
        "name": "pagerank_cuda",
        "route": "cuda",
        "source": f"{PORT}/kernels/csrc/pagerank.cu",
        "replaces": "quorum_intersection_tpu/analytics/pagerank.py:116",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t200["kernel_ms"],
        "plain_ms": t200["plain_ms"],
        "bound_ms": t200["bound_ms"],
        "bound_by": t200["bound_by"],
        "library_ms": None,
        "barriers_per_iteration": split[full_label]["barriers_per_iteration"],
        "grid": t200["grid"],
        "per_iteration_ms": t200["per_iteration_ms"],
        "per_iteration_bound_ms": t200["per_iteration_bound_ms"],
        "main_path_ms": main_rows[-1]["call_ms_by_events"],
        "main_path_ms_of": f"power_iteration on {full_label}, CUDA events around the call "
                          "(CSR build, upload, launch, readback)",
        "main_path_device_ms": main_device_ms,
        "main_path_device_ms_of": f"pagerank on {full_label} under torch.profiler",
        "numpy_ms": t200["numpy_ms"],
        "iterations": t200["iterations"],
    }


# The analysis inputs pinned to the JAX CLI by tests/test_torch_analytics.py.
ANALYSIS_SYNTH = {
    "majority_fbas(5)": lambda synth: synth.majority_fbas(5),
    "stellar_like_fbas(5,3,seed=0)": lambda synth: synth.stellar_like_fbas(5, 3, seed=0),
}


# The pinned lines phase analysis runs as processes: one a flag set (each
# analysis mode, the sanitizer's three); the rest run in this process.
ANALYSIS_PROCESSES = ("nested_correct.json --top-tier", "nested_correct.json --blocking-set",
                      "nested_correct.json --splitting-set", "snapshot_correct.json",
                      "snapshot_correct.json --compat", "snapshot_correct.json --report-dangling")


def analysis_phase(card, texts):
    """Phase analysis: --top-tier, --blocking-set, --splitting-set and the
    sanitizer against the pinned lines: one process a flag set as a user
    runs it, every other pinned case through the same entry point in this
    process."""
    import hashlib

    from quorum_intersection_tpu_torch import cli
    from quorum_intersection_tpu_torch.fbas import sanitize, synth

    t = time.perf_counter()
    pinned = json.loads((ROOT / "tests" / "_torch_analysis_lines.json").read_text())
    cases = []  # (kind, key, the entry point, its argv, stdin)
    for key in pinned["analysis"]:
        source, mode = key.rsplit(" ", 1)
        text = texts[source] if source in texts else json.dumps(ANALYSIS_SYNTH[source](synth))
        cases.append(("analysis", key, ([sys.executable, "-m", PORT], cli.main), [mode], text))
    for key in pinned["sanitize"]:
        source, *flags = key.split(" ")
        cases.append(("sanitize", key, ([sys.executable, "-m", f"{PORT}.fbas.sanitize"], sanitize.main), flags,
                      texts[source]))
    procs = [c for c in cases if c[1] in ANALYSIS_PROCESSES]
    if len(procs) != len(ANALYSIS_PROCESSES):
        fail("analysis", f"the pinned lines lack a process case: {sorted(ANALYSIS_PROCESSES)}")
    runs = dict(zip([c[1] for c in procs], run_all([c[2][0] + c[3] for c in procs], inputs=[c[4] for c in procs],
                                                  parallel=len(procs))))
    for kind, key, (_, entry), argv, text in cases:
        so, se, rc = runs[key][:3] if key in runs else in_process(entry, argv, text)
        want = pinned[kind][key]
        got = (so if kind == "analysis" else
               {"stdout_sha256": hashlib.sha256(so.encode()).hexdigest(), "stderr": se, "exit": rc})
        if got != want or (kind == "analysis" and rc != 0):
            fail("analysis", f"{kind} {key}: printed {str(got)[:300]!r} exit {rc}, pinned {str(want)[:300]!r}")
    phase_line("analysis", card=card, seconds=round(time.perf_counter() - t, 3), processes=list(ANALYSIS_PROCESSES),
               analysis=f"{len(pinned['analysis'])}/{len(pinned['analysis'])} lines equal to the pinned JAX CLI's",
               sanitize=f"{len(pinned['sanitize'])}/{len(pinned['sanitize'])} outputs equal to the pinned ones")


def rank_phase(card, texts, manifest, sources, cert_jobs, witness_ok, work):
    """Phase rank: the sweeps under the rank order (QI_SWEEP_ORDER=rank):
    the fixtures and the full-width twins through K1, the 16-source batch
    through K3 and K4, and the CLI under the variable."""
    import os

    from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.kernels.packed_cuda import packed_sweep_bitset, packed_sweep_dense
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import sweep_fused
    from quorum_intersection_tpu_torch.pipeline import check_many, solve

    # The CLI under the variable, one process a backend (the default router's
    # sweep rung included), started first and read at the end.
    env = dict(os.environ, QI_SWEEP_ORDER="rank")
    cli_cases = [("snapshot_correct.json", backend) for backend in ("gpu-sweep", "auto")]
    procs, outs = [], []
    for i, (name, backend) in enumerate(cli_cases):
        cert = work / f"rank_cli{i}.cert.json"
        procs.append((name, backend, cert, subprocess.Popen(
            [sys.executable, "-m", PORT, "--backend", backend, "--cert-out", str(cert)], cwd=ROOT, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        twins = [(f"benchmark_fbas(256,core=34,broken={b})", synth.benchmark_fbas(256, 34, broken=b), not b)
                 for b in (False, True)]
        solo_sources = [(name, texts[name], manifest[name]["verdict"]) for name in manifest] + twins
        sweep_fused.launches = packed_sweep_dense.launches = packed_sweep_bitset.launches = 0
        solo_rows, solo = [], {}
        for name, src, want in solo_sources + [s for s in sources if s[0] not in manifest]:
            t = time.perf_counter()
            res = solo[name] = solve(src, backend=GpuSweepBackend(order="rank"))
            seconds = time.perf_counter() - t
            if res.intersects is not want:
                fail("rank", f"{name}: intersects={res.intersects}, expected {want}")
            if not want and not witness_ok(src, res):
                fail("rank", f"{name}: witness pair is not two disjoint quorums")
            order = res.stats.get("order")
            if res.stats.get("backend") == "gpu-sweep" and (not order or res.cert["provenance"].get("order") != order):
                fail("rank", f"{name}: no rank-order provenance on a swept verdict")
            cert_jobs.append((f"rank/solve/{name}", src, res.cert))
            solo_rows.append({"source": name, "verdict": res.intersects, "seconds": seconds,
                              "hit_index": res.stats.get("hit_index"),
                              "candidates": res.stats.get("candidates_checked"),
                              "order_source": (order or {}).get("source")})
        k1_launches = sweep_fused.launches
        batch_rows = {}
        for engine in (None, "bitset"):
            label = engine or "default"
            t = time.perf_counter()
            res = check_many([src for _, src, _ in sources], backend=GpuSweepBackend(engine=engine, order="rank"))
            seconds = time.perf_counter() - t
            for (name, src, want), r in zip(sources, res):
                if r.intersects is not want:
                    fail("rank", f"batch {name} (engine={label}): intersects={r.intersects}, expected {want}")
                if not want and not witness_ok(src, r):
                    fail("rank", f"batch {name} (engine={label}): witness pair is not two disjoint quorums")
                got, expect = r.stats.get("hit_index"), solo[name].stats.get("hit_index")
                if got != expect or r.stats.get("order") != solo[name].stats.get("order"):
                    fail("rank", f"batch {name} (engine={label}): hit index {got} != the unpacked rank-ordered "
                                 f"solve's {expect}")
                cert_jobs.append((f"rank/batch/{label}/{name}", src, r.cert))
            batch_rows[label] = {"seconds": seconds, "packed": sum(1 for r in res if r.stats.get("packed"))}
        launches = {"sweep_fused_cuda": k1_launches, "packed_sweep_dense_cuda": packed_sweep_dense.launches,
                    "packed_sweep_bitset_cuda": packed_sweep_bitset.launches}
        if min(launches.values()) < 1:
            fail("rank", f"a sweep kernel never launched under the rank order: {launches}")
        for name, backend, cert, proc in procs:
            so, se = proc.communicate(texts[name], timeout=300)
            outs.append((name, backend, cert, so, se, proc.returncode))
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cli_rows = []
    for name, backend, cert, so, se, rc in outs:
        want = manifest[name]["verdict"]
        if so.strip().splitlines()[-1:] != ["true" if want else "false"] or rc != (0 if want else 1):
            fail("rank", f"CLI {name} ({backend}): printed {so[-40:]!r} exit {rc}; {se[-400:]!r}")
        doc = json.loads(cert.read_text())
        provenance = doc["provenance"]
        if provenance["backend"] == "gpu-sweep" and (provenance.get("order") or {}).get("mode") != "rank":
            fail("rank", f"CLI {name} ({backend}): swept without the rank order")
        cert_jobs.append((f"rank/cli/{backend}/{name}", texts[name], doc))
        cli_rows.append({"source": name, "backend": backend, "engine": provenance["backend"],
                         "order": (provenance.get("order") or {}).get("source")})
    phase_line("rank", card=card, solve=solo_rows, batch=batch_rows, launches=launches, cli=cli_rows,
               hit_index_vs_unpacked_rank_solve=f"{len(sources)}/{len(sources)} equal on both engines")


# -- the frontier (K9, K10): phases compare_frontier, frontier, frontier_route, timing_frontier --

# The frontier's exact targets (all quorums intersect there, so the whole
# tree is enumerated whatever the pop size or order): states popped, flagged.
FRONTIER_COUNTS = {
    "majority_fbas(18)": (140997, 0),
    "hierarchical_fbas(6,4)": (770231, 3840),
    "hierarchical_fbas(7,4)": (23517191, 583632),
    "hierarchical_fbas(8,4)": (106527851, 688128),
}
FRONTIER_STATS = ("device_iters", "device_chunks", "states_popped", "flagged", "minimal_quorums", "host_checks",
                  "device_flag_checks", "spills", "discarded_chunks", "first_chunk_seconds", "chunk_seconds",
                  "seconds", "padded_shape")
# The native oracle's time cap per run in phase frontier_route (a capped run
# counts as a loss of the oracle only where the frontier finished first).
ORACLE_CAP_S = 5.0


def frontier_networks(synth):
    """Phase frontier's networks: ``(label, source, expected verdict)``."""
    return [
        ("majority_fbas(18)", synth.majority_fbas(18), True),
        ("majority_fbas(18,broken)", synth.majority_fbas(18, broken=True), False),
        ("hierarchical_fbas(6,4)", synth.hierarchical_fbas(6, 4), True),
        ("hierarchical_fbas(8,4)", synth.hierarchical_fbas(8, 4), True),
        ("stellar_like_fbas(16,3,broken)", synth.stellar_like_fbas(16, 3, broken=True), False),
        ("stellar_like_fbas(21,3,broken)", synth.stellar_like_fbas(21, 3, broken=True), False),
        # Past 64 lanes: 66 and 126, two words a state; past 128, over the
        # evaluator's two node k-slabs: 180 and 255 (padded to 192 and 256),
        # three and four.
        *[(f"stellar_like_fbas({orgs},3,broken)", synth.stellar_like_fbas(orgs, 3, broken=True), False)
          for orgs in (22, 42, 60, 85)],
    ]


# The pinned JAX cases (tests/_torch_frontier_jax.json) phase frontier holds
# gpu-frontier's counts to on the card, at their constants: the wide twins,
# padded and not.
FRONTIER_PINNED = ("stellar-22x3-broken", "stellar-42x3-broken", "stellar-22x3-broken-unpadded", "hier-5x3-unpadded",
                   "stellar-60x3-broken", "stellar-85x3-broken", "stellar-44x3-broken-unpadded")
# The runs of phase frontier that launch each words-a-state instance past
# one word: the networks above and the pinned cases, by label prefix.
FRONTIER_WORDS_RUNS = {2: ("stellar_like_fbas(22,3,broken)", "stellar_like_fbas(42,3,broken)", "stellar-22x3",
                           "stellar-42x3"),
                       3: ("stellar_like_fbas(60,3,broken)", "stellar-60x3", "stellar-44x3"),
                       4: ("stellar_like_fbas(85,3,broken)", "stellar-85x3")}


def frontier_setup(src, device, arena, pop, stream=None, chunk_iters=512):
    """The kernel, its plain version and the problem of ``src``'s
    quorum-bearing SCC, set up as ``GpuFrontierBackend`` sets it up."""
    from quorum_intersection_tpu_torch.backends.frontier import FLAG_EXIT, FLAG_EXIT_GROWTH, frontier_problem
    from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import FrontierKernels, FrontierRef
    from quorum_intersection_tpu_torch.kernels.frontier_ref import ChunkShape
    from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs

    graph = build_graph(parse_fbas(raw_json(src)))
    bearing = quorum_bearing_sccs(graph)
    prob = frontier_problem(graph, encode_circuit(graph), bearing[0][1])
    pop = min(pop, arena // 4)
    shape = ChunkShape(half=prob.half, K=pop, C=arena, chunk_iters=chunk_iters,
                       flag_cap=FLAG_EXIT * FLAG_EXIT_GROWTH + pop)
    args = (prob.circuit, prob.scc_dev, prob.a_scc, shape, prob.probe_circuit, prob.frozen)
    return (prob, shape, FrontierKernels(*args, device=device, stream=stream),
            FrontierRef(*args, device=device))


def instance_of(kern) -> str:
    """The evaluator instance a frontier kernel object launches."""
    tables = getattr(kern, "tables", None)
    return "plain" if tables is None else ("streamed" if tables.stream else "resident")


def frontier_seed(kern, prob):
    """An arena set holding the seed state (toRemove = the SCC)."""
    import torch

    st = kern.arena()
    st.T[0, : prob.s] = 1
    st.ctr.copy_(torch.tensor([1, 0, 0, 0], dtype=torch.int32))
    return st


def frontier_lockstep(prob, shape, kern, plain, chunks, flag_exit=512):
    """K9 and its plain version chunk for chunk from the seed state (the
    host's spill applied alike), each chunk's arena rows [0, top), counters
    and flags held equal, and K10 against its plain version on each chunk's
    flags.  Returns ``(chunks, iterations, flags, mismatches, exit reasons)``."""
    import torch

    from _torch_frontier_blocks import exit_reason
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import frontier_chunk, frontier_filter

    sets = [[frontier_seed(kern, prob), kern.arena()], [frontier_seed(kern, prob), kern.arena()]]
    src, done, iters, flags, bad, reasons = 0, 0, 0, 0, [], []
    for c in range(chunks):
        frontier_chunk(kern, sets[0][src], sets[0][1 - src], flag_exit)
        plain.chunk(sets[1][src], sets[1][1 - src], flag_exit)
        got, want = sets[0][1 - src], sets[1][1 - src]
        torch.cuda.synchronize()
        done += 1
        g_ctr, w_ctr = got.ctr.tolist(), want.ctr.tolist()
        top, fcount = w_ctr[:2]
        iters += w_ctr[2]
        flags += fcount
        if g_ctr != w_ctr:
            bad.append(f"chunk {c}: counters {g_ctr} != {w_ctr}")
            break
        reasons.append(exit_reason(g_ctr, shape, flag_exit))
        if not (torch.equal(got.T[:top], want.T[:top]) and torch.equal(got.D[:top], want.D[:top])):
            bad.append(f"chunk {c}: arena rows differ")
        if not torch.equal(got.flags[:fcount], want.flags[:fcount]):
            bad.append(f"chunk {c}: flags differ")
        if fcount:
            kf = frontier_filter(kern, got.flags, fcount).tolist()
            pf = plain.filter(want.flags, fcount).tolist()
            if kf != pf:
                bad.append(f"chunk {c}: flag filter {kf} != {pf}")
        if bad or top == 0:
            break
        if top > shape.C - 2 * shape.K:
            keep = top - shape.C // 2
            for st in (got, want):
                st.T[:keep] = st.T[shape.C // 2: top].clone()
                st.D[:keep] = st.D[shape.C // 2: top].clone()
                st.ctr[0] = keep
        src = 1 - src
    return done, iters, flags, bad, reasons


class LaunchTimer:
    """CUDA events around every K9 and K10 wrapper call on the current
    stream: the backend imports the wrappers from their module when it
    solves, so it calls these stand-ins while the timer is entered.  The
    launches stay counted by the wrappers themselves
    (``frontier_cuda.LAUNCHES``)."""

    NAMES = {"frontier_chunk": "frontier_chunk_cuda", "frontier_filter": "frontier_filter_cuda"}

    def __init__(self):
        self.events = {name: [] for name in self.NAMES.values()}

    def __enter__(self):
        import torch

        from quorum_intersection_tpu_torch.kernels import frontier_cuda

        self.mod = frontier_cuda
        self.orig = {fn: getattr(frontier_cuda, fn) for fn in self.NAMES}

        def timed(fn, name):
            def wrapper(*args, **kw):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                self.events[name].append((start, end))
                return out
            return wrapper

        for fn, name in self.NAMES.items():
            setattr(frontier_cuda, fn, timed(self.orig[fn], name))
        return self

    def __exit__(self, *exc):
        for fn, orig in self.orig.items():
            setattr(self.mod, fn, orig)

    def mark(self):
        """A point in the record, for :meth:`ms` of what follows it."""
        return {name: len(evs) for name, evs in self.events.items()}

    def ms(self, since=None, until=None):
        """Summed event ms by kernel, of all launches or of those between
        two marks."""
        import torch

        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in evs[(since or {}).get(name, 0):(until or {}).get(name)])
                for name, evs in self.events.items()}

    def launches(self, since, until):
        return {name: until[name] - since[name] for name in self.events}


def frontier_region(rows):
    """The JAX rule (calibration.py:202-303) over phase frontier_route's
    rows: the smallest |scc| from which every measured row wins (frontier
    at least 1x the native oracle, verdicts and counts right), and the
    largest measured |scc|; None where the largest loses."""
    by_scc = {}
    for r in rows:
        speed = r["speedup_vs_native"] if r["ok"] else 0.0
        by_scc[r["scc"]] = min(by_scc.get(r["scc"], speed), speed)
    win = None
    for scc in sorted(by_scc, reverse=True):
        if by_scc[scc] >= 1.0:
            win = scc
        else:
            break
    return None if win is None else (win, max(by_scc))


def native_capped(src, cap_s):
    """The native oracle on ``src`` on this host, cancelled after ``cap_s``:
    ``(intersects or None, seconds, capped)``."""
    import threading

    from quorum_intersection_tpu_torch.backends.base import CancelToken, SearchCancelled
    from quorum_intersection_tpu_torch.backends.cpp import CppOracleBackend
    from quorum_intersection_tpu_torch.pipeline import solve

    token = CancelToken()
    timer = threading.Timer(cap_s, token.cancel)
    timer.start()
    t = time.perf_counter()
    try:
        res = solve(src, backend=CppOracleBackend(cancel=token), with_cert=False)
        return res.intersects, time.perf_counter() - t, False
    except SearchCancelled:
        return None, time.perf_counter() - t, True
    finally:
        timer.cancel()


def k9_replay(prob, shape, plain, state, top, iters):
    """The plain version's iterations of a chunk from ``state`` (rows [0,
    ``top``)), replayed one at a time: ``(top, flags, fixpoint passes of the
    popped rows, the per-iteration traffic model in bytes: every popped row
    read and every child and flag row written)`` after ``iters`` of them
    (fewer where the chunk loop's guards end it first)."""
    import torch

    from quorum_intersection_tpu_torch.kernels.frontier_ref import expand, rows_in_circuit
    from quorum_intersection_tpu_torch.kernels.sweep_ref import fixpoint_passes

    T, D = state.T.clone(), state.D.clone()
    flags = torch.zeros_like(state.flags)
    ptop, fc, passes, model_bytes = top, 0, 0, 0
    for _ in range(iters):
        if ptop == 0 or ptop > shape.C - 2 * shape.K:
            break
        k = min(ptop, shape.K)
        base = ptop - k
        blk_T, blk_D = T[base:ptop].to(torch.int32), D[base:ptop].to(torch.int32)
        stacked = rows_in_circuit(plain.tables, plain.scc_idx, torch.cat([blk_D, torch.maximum(blk_T, blk_D)]))
        passes += int(fixpoint_passes(plain.tables, stacked)[1].sum())
        new_top, fc2, _ = expand(plain.tables, plain.scc_idx, plain.a_mat, shape, T, D, ptop, flags, fc)
        model_bytes += 2 * k * prob.s_dev + 2 * max(new_top - base, 0) * prob.s_dev + (fc2 - fc) * prob.s_dev
        ptop, fc = new_top, fc2
    return ptop, fc, passes, model_bytes


def k9_least_bytes(prob, kern, top, p_top, p_fc) -> int:
    """A chunk's own least traffic: its inputs read once (the source rows
    [0, top), the tables, the in-degree planes, the counters) and its
    outputs written once (the rows [0, p_top), the p_fc flags, the
    counters)."""
    return (2 * top * prob.s_dev + table_bytes(prob.circuit) + kern.planes.numel() * 8 + 16
            + 2 * p_top * prob.s_dev + p_fc * prob.s_dev + 16)


def k9_timing_state(kern, prob, shape):
    """timing_frontier's mid-search state at hier-8x4's shape: default
    chunks of K9 from the seed until the stack holds more than a pop and a
    flag block has gathered; ``(state, its top, the flag rows met)``."""
    import torch

    from quorum_intersection_tpu_torch.kernels import frontier_cuda

    cur, nxt = frontier_seed(kern, prob), kern.arena()
    flag_rows = []
    for _ in range(8):
        frontier_cuda.frontier_chunk(kern, cur, nxt, 512 * 16)
        top, fcount = nxt.ctr.tolist()[:2]
        flag_rows.append(nxt.flags[:fcount].clone())
        cur, nxt = nxt, cur
        if sum(len(f) for f in flag_rows) >= shape.flag_cap and top > shape.K:
            break
    torch.cuda.synchronize()
    return cur, cur.ctr.tolist()[0], flag_rows


def k9_breakdown(kern, state, dst, far, want, ms_per_iteration, reps=10):
    """K9's timed instance on ``reps`` 33-iteration chunks from ``state``
    (each held equal to the untimed chunk ``want``): the cycles warp 0 of
    block 0 spends in each part of an iteration, their shares, and each
    share of the measured ``ms_per_iteration``."""
    import torch

    from quorum_intersection_tpu_torch.kernels import frontier_cuda

    kern.shape.chunk_iters = 33
    total = torch.zeros(len(frontier_cuda.TIMED_PHASES) + 1, dtype=torch.int64, device=dst.T.device)
    for _ in range(reps):
        total += frontier_cuda.frontier_chunk_timed(kern, state, dst, far)
    kern.shape.chunk_iters = 512
    top, fcount = want.ctr.tolist()[:2]
    if dst.ctr.tolist() != want.ctr.tolist() or not (
        torch.equal(dst.T[:top], want.T[:top]) and torch.equal(dst.D[:top], want.D[:top])
        and torch.equal(dst.flags[:fcount], want.flags[:fcount])
    ):
        fail("timing_frontier", "K9's timed instance differs from its untimed chunk")
    cycles = total.tolist()
    iters = cycles[-1]
    per_iter = {name: c / iters for name, c in zip(frontier_cuda.TIMED_PHASES, cycles)}
    whole = sum(per_iter.values())
    return {"iterations": iters, "cycles_per_iteration": per_iter, "cycles_per_iteration_total": whole,
            "share": {name: c / whole for name, c in per_iter.items()},
            "ms_per_iteration_by_share": {name: ms_per_iteration * c / whole for name, c in per_iter.items()},
            "clock_mhz_implied": whole / (ms_per_iteration * 1e3),
            "of": "clock64() of warp 0 of block 0 over 33-iteration chunks from the timed state"}


def parent_frontier_library(parent_tree, work):
    """The other tree's ``frontier.cu`` (the checkout at ``parent_tree``)
    built with this tree's ``nvcc`` flags and typed as this tree's library
    (the C interface is unchanged): ``(library, its source, nvcc's
    output)``."""
    import ctypes

    from quorum_intersection_tpu_torch.kernels import build, frontier_cuda

    src = pathlib.Path(parent_tree) / PORT / "kernels" / "csrc" / "frontier.cu"
    lib_path = work / "parent_frontier.so"
    t = time.perf_counter()
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail("timing_frontier", f"nvcc refused {src}: {(proc.stdout + proc.stderr)[-2000:]}")
    phase_line("parent_build", source=str(src), seconds=round(time.perf_counter() - t, 3))
    return frontier_cuda.typed_library(ctypes.CDLL(str(lib_path))), src, proc.stdout + proc.stderr


def frontier_instance_key(name: str):
    """A frontier kernel instance's (kernel, table source, one child slab,
    words a state, timed) from its name, demangled (``true`` or ``(bool)1``)
    or mangled (a tree without the words parameter: 1), or None."""
    import re

    m = re.search(r"(\w+_kernel)<(?:qi_warp::)?(Resident|Streamed), ([^>]*)>", name)
    if m is not None:
        args = [a.strip() for a in m.group(3).split(",")]
        flags = [a in ("true", "(bool)1") for a in args if a in ("true", "false", "(bool)1", "(bool)0")]
        words = [int(re.sub(r"\D", "", a)) for a in args if a not in ("true", "false", "(bool)1", "(bool)0")]
    else:
        m = re.search(r"\d+((?:mesh_)?chunk_kernel|iteration_kernel|filter_kernel)IN7qi_warp\d+(Resident|Streamed)E"
                      r"((?:L[bi]\d+E)+)", name)
        if m is None:
            return None
        args = re.findall(r"L([bi])(\d+)E", m.group(3))
        flags = [v == "1" for kind, v in args if kind == "b"]
        words = [int(v) for kind, v in args if kind == "i"]
    return m.group(1), m.group(2), flags[0], words[0] if words else 1, len(flags) > 1 and flags[1]


def frontier_parent_turns(kern, prob, shape, state, far, block, count, want, parent_tree, work, wide):
    """This tree's frontier kernels against the other tree's at hier-8x4's
    shape, in turns (the other tree's, this one's, this one's, the other
    tree's): K9's 33-iteration chunk from the timed state, the mesh-chunk
    instance's time an iteration on 4 ranks of the card (its 1- and
    33-iteration chunks), and K9's time an iteration at two words a state
    (``wide``: the broken stellar 42x3's timed problem, state, destination
    and flag exit), all through this tree's wrappers with the other tree's
    library swapped in and each turn's result held to this tree's; K10's
    body (:func:`k10_bodies`); and ptxas's registers and spills of every
    one- and two-word instance in both builds, and of this tree's three- and
    four-word instances."""
    import torch

    from quorum_intersection_tpu_torch.kernels import build, frontier_cuda

    lib, src, parent_log = parent_frontier_library(parent_tree, work)
    libs = {"parent": lib, "this": frontier_cuda._library()}
    dst = kern.arena()
    card = frontier_cuda.CardState.empty(shape.K, 4, range(4), state, kern.arena())

    def k9():
        kern.shape.chunk_iters = 33
        frontier_cuda.frontier_chunk(kern, state, dst, far)

    def mesh(iters):
        kern.shape.chunk_iters = iters
        frontier_cuda.frontier_mesh_chunk([kern], [card], far)

    w_kern, w_state, w_dst, w_far = wide

    def k9_wide(iters):
        w_kern.shape.chunk_iters = iters
        frontier_cuda.frontier_chunk(w_kern, w_state, w_dst, w_far)

    def result():
        torch.cuda.synchronize()
        frontier_cuda.mesh_chunk_status([card])
        top, fc = dst.ctr.tolist()[:2]
        m_top = card.dst.ctr.tolist()[0]
        w_top, w_fc = w_dst.ctr.tolist()[:2]
        return (dst.ctr.tolist(), dst.T[:top].clone(), dst.D[:top].clone(), dst.flags[:fc].clone(),
                card.dst.ctr.tolist(), card.dst.T[:m_top].clone(), card.dst.D[:m_top].clone(),
                w_dst.ctr.tolist(), w_dst.T[:w_top].clone(), w_dst.D[:w_top].clone(), w_dst.flags[:w_fc].clone())

    turns = {who: {"k9_ms_33_iterations": [], "mesh_chunk_ms_per_iteration_4_ranks": [],
                   "k9_ms_per_iteration_42x3": []} for who in libs}
    results = {}
    own = frontier_cuda._library
    try:
        for who in ("parent", "this", "this", "parent"):
            frontier_cuda._library = lambda lib=libs[who]: lib
            turns[who]["k9_ms_33_iterations"].append(time_ms(k9, 10))
            m1, m33 = time_ms(lambda: mesh(1), 20), time_ms(lambda: mesh(33), 10)
            turns[who]["mesh_chunk_ms_per_iteration_4_ranks"].append((m33 - m1) / 32)
            w1, w33 = time_ms(lambda: k9_wide(1), 20), time_ms(lambda: k9_wide(33), 10)
            turns[who]["k9_ms_per_iteration_42x3"].append((w33 - w1) / 32)
            k9()
            mesh(33)
            k9_wide(33)
            results[who] = result()
    finally:
        frontier_cuda._library = own
        kern.shape.chunk_iters = 512
        w_kern.shape.chunk_iters = 512
    same = all(a == b if isinstance(a, list) else torch.equal(a, b)
               for a, b in zip(results["parent"], results["this"]))
    if not same:
        fail("timing_frontier", "the other tree's K9 or mesh-chunk instance differs from this tree's at hier-8x4 or "
                                "at the 42x3's two words a state")
    this_log = build.build_all(["frontier"])["frontier"].log
    listed = {who: ptxas_instances(log) for who, log in (("parent", parent_log), ("this", this_log))}
    ptx = {who: {frontier_instance_key(r["kernel"]): r for r in rows} for who, rows in listed.items()}
    unnamed = [r["kernel"] for rows in listed.values() for r in rows if frontier_instance_key(r["kernel"]) is None]
    instances = []
    for key, this_row in sorted(((k, r) for k, r in ptx["this"].items() if k and k[3] <= 2), key=str):
        parent_row = ptx["parent"].get(key)
        instances.append({"instance": "{}<{}, one slab {}, W {}, timed {}>".format(*key),
                          "this": {k: this_row.get(k) for k in ("registers", "spill_stores", "spill_loads")},
                          "parent": None if parent_row is None else {
                              k: parent_row.get(k) for k in ("registers", "spill_stores", "spill_loads")}})
    changed = [row["instance"] for row in instances if row["this"] != row["parent"]]
    return {"order": "parent, this, this, parent", "turns": turns, "results_equal": same,
            "K10_bodies": k10_bodies(kern, block, count, want, libs["parent"], src),
            "ptxas_one_and_two_word_instances": instances, "ptxas_changed_from_the_parent": changed,
            "ptxas_rows": {who: len(rows) for who, rows in listed.items()}, "ptxas_unnamed": unnamed[:4],
            "three_and_four_word_instances": [{"instance": "{}<{}, one slab {}, W {}, timed {}>".format(*k), **r}
                                              for k, r in ptx["this"].items() if k and k[3] > 2],
            "of": f"the other tree's frontier.cu from {src}"}


def k10_bodies(kern, block, count, want, parent_lib, parent_src):
    """K10's body against the other tree's (``parent_lib``, built from
    ``parent_src``), both through the same C call on one side stream, in
    turns (the other tree's, this one's, this one's through its wrapper,
    and back in the reverse order): ms a block on the device alone (20
    calls behind a stream spin) and back to back (50 calls), each turn's
    result held against the plain version's ``want``."""
    import torch

    from quorum_intersection_tpu_torch.kernels import frontier_cuda

    libs = {"parent": parent_lib, "this": frontier_cuda._library()}
    t = kern.tables
    init = torch.tensor([0, block.shape[0]], dtype=torch.int32, device=block.device)
    out = torch.empty_like(init)
    side = torch.cuda.Stream(block.device)
    side.wait_stream(torch.cuda.current_stream(block.device))

    def call(lib):
        out.copy_(init)
        err = lib.qi_frontier_filter(
            t.blocks.data_ptr(), t.chunks.data_ptr(), t.neg_thresholds.data_ptr(), kern.neg_thr_d.data_ptr(),
            t.n, t.n_units, t.units, t.depth, t.c0, t.slabs, t.pc, t.nblocks, int(t.stream), kern.pitch,
            block.data_ptr(), count, out.data_ptr(), side.cuda_stream)
        if err != 0:
            fail("timing_frontier", f"K10 body launch failed: {lib.qi_cuda_error_string(err).decode()}")

    def wrapped():
        out.copy_(frontier_cuda.frontier_filter(kern, block, count))

    arms = {"parent": lambda: call(libs["parent"]), "this": lambda: call(libs["this"]), "this_wrapper": wrapped}
    res = {who: {"ms_device_alone": [], "ms_back_to_back": []} for who in arms}
    with torch.cuda.stream(side):
        for who in ("parent", "this", "this_wrapper", "this_wrapper", "this", "parent"):
            alone = device_ms(arms[who], 20)
            b2b = time_ms(arms[who], 50)
            if out.tolist() != want:
                fail("timing_frontier", f"K10's {who} body: {out.tolist()} != plain {want}")
            res[who]["ms_device_alone"].append(alone)
            res[who]["ms_back_to_back"].append(b2b)
        # Device ms by kernel of 10 calls of each of this tree's arms under
        # the profiler: the body's own time through the wrapper and without.
        for who in ("this", "this_wrapper"):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    arms[who]()
                torch.cuda.synchronize()
            res[who]["profiler_device_ms_10_calls"] = device_ms_by_kernel(prof)
    res["of"] = f"{count} flags of hierarchical_fbas(8,4); the other tree's body from {parent_src}"
    return res


def frontier_phases(device, card, texts, manifest, cert_jobs, witness_ok, work, frontier_parent=None):
    """Phases compare_frontier, frontier, frontier_route and
    timing_frontier; returns the K9 and K10 records of the kernels line,
    each kernel's one-word and two-word instances.  ``frontier_parent``: a
    checkout whose frontier kernels timing_frontier times in turns with this
    one's at hier-8x4's shape (:func:`frontier_parent_turns`)."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.backends import calibration as cal_mod
    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.kernels import frontier_cuda
    from quorum_intersection_tpu_torch.kernels.frontier_ref import rows_in_circuit
    from quorum_intersection_tpu_torch.kernels.sweep_ref import fixpoint_passes
    from quorum_intersection_tpu_torch.pipeline import solve

    # -- compare_frontier ------------------------------------------------
    # (label, source, arena, pop, chunks, streamed, chunk_iters); between
    # them every exit of the chunk loop on both instances.
    compare_cases = [
        ("majority_fbas(14)", synth.majority_fbas(14), 8192, 256, 8, None),
        ("majority_fbas(14,broken)", synth.majority_fbas(14, broken=True), 8192, 256, 8, None),
        ("hierarchical_fbas(5,3)", synth.hierarchical_fbas(5, 3), 8192, 256, 8, None),
        ("hierarchical_fbas(5,3) streamed", synth.hierarchical_fbas(5, 3), 8192, 256, 8, True),
        ("hierarchical_fbas(5,3) chunk_iters 3", synth.hierarchical_fbas(5, 3), 8192, 256, 4, None, 3),
        ("hierarchical_fbas(5,3) chunk_iters 3 streamed", synth.hierarchical_fbas(5, 3), 8192, 256, 4, True, 3),
        *[(f"random_fbas(14,seed={sd},nested_prob=0.3,null_prob=0.1)",
           synth.random_fbas(14, seed=sd, nested_prob=0.3, null_prob=0.1), 8192, 256, 8, None) for sd in range(4)],
        ("hierarchical_fbas(4,3) spill", synth.hierarchical_fbas(4, 3), 64, 16, 8, None),
        ("hierarchical_fbas(4,3) spill streamed", synth.hierarchical_fbas(4, 3), 64, 16, 8, True),
        ("benchmark_fbas(64,14,seed=1) restricted", synth.benchmark_fbas(64, 14, seed=1), 4096, 128, 8, None),
        ("hierarchical_fbas(6,4) defaults, 3 chunks", synth.hierarchical_fbas(6, 4), 1 << 18, 2048, 3, None),
        ("hierarchical_fbas(8,4) defaults, 3 chunks", synth.hierarchical_fbas(8, 4), 1 << 18, 2048, 3, None),
        # Past 32 lanes, where a state's upper word is live: the wide broken
        # twins phase frontier decides, and intersecting networks as wide.
        *[(f"stellar_like_fbas({orgs},3{tag}) defaults, 3 chunks{' streamed' if st else ''}",
           synth.stellar_like_fbas(orgs, 3, broken=broken), 1 << 18, 2048, 3, st)
          for orgs in (16, 21) for broken, tag in ((True, ",broken"), (False, "")) for st in (None, True)
          if broken or not st],
        # Wide SCCs whose in-degrees differ from lane to lane, so the branch
        # variable's argmax over the upper lanes decides the children.
        ("random_fbas(48,seed=0,slice_size=12) defaults, 3 chunks", synth.random_fbas(48, seed=0, slice_size=12),
         1 << 18, 2048, 3, None),
        ("random_fbas(64,seed=0) defaults, 3 chunks", synth.random_fbas(64, seed=0), 1 << 18, 2048, 3, None),
        # Past 64 lanes, two words a state: the wide broken twins on both
        # instances, an intersecting 90-lane network, and SCCs of 96 and 128
        # lanes whose in-degrees differ.
        *[(f"stellar_like_fbas({orgs},3,broken) defaults, 2 chunks{' streamed' if st else ''}",
           synth.stellar_like_fbas(orgs, 3, broken=True), 1 << 18, 2048, 2, st)
          for orgs in (22, 42) for st in (None, True)],
        ("stellar_like_fbas(30,3) defaults, 2 chunks", synth.stellar_like_fbas(30, 3), 1 << 18, 2048, 2, None),
        ("random_fbas(96,seed=0) defaults, 2 chunks", synth.random_fbas(96, seed=0), 1 << 18, 2048, 2, None),
        ("random_fbas(128,seed=0) defaults, 2 chunks streamed", synth.random_fbas(128, seed=0), 1 << 18, 2048, 2,
         True),
        # Past 128 lanes, three and four words a state over two node
        # k-slabs: the broken twins of 129, 180 and 255 lanes on both
        # instances, and SCCs of 191 and 255 lanes whose in-degrees differ;
        # chunks of 64 iterations (the plain version's iterations are the
        # cost here).
        *[(f"stellar_like_fbas({orgs},3,broken) defaults, 2 chunks of 64 iterations{' streamed' if st else ''}",
           synth.stellar_like_fbas(orgs, 3, broken=True), 1 << 18, 2048, 2, st, 64)
          for orgs in (43, 60, 85) for st in (None, True)],
        ("random_fbas(192,seed=0) defaults, 2 chunks of 64 iterations", synth.random_fbas(192, seed=0), 1 << 18,
         2048, 2, None, 64),
        ("random_fbas(256,seed=0) defaults, 2 chunks of 64 iterations streamed", synth.random_fbas(256, seed=0),
         1 << 18, 2048, 2, True, 64),
    ]
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_frontier_blocks import EXIT_REASONS, wide_flag_block

    t0 = time.perf_counter()
    compare_rows, mismatches = {}, []
    exits = {"resident": set(), "streamed": set()}
    for label, src, arena, pop, chunks, stream, *iters_cap in compare_cases:
        prob, shape, kern, plain = frontier_setup(src, device, arena, pop, stream=stream,
                                                  chunk_iters=iters_cap[0] if iters_cap else 512)
        done, iters, flags, bad, reasons = frontier_lockstep(prob, shape, kern, plain, chunks)
        exits[instance_of(kern)].update(reasons)
        row = {"s": prob.s, "s_dev": prob.s_dev, "arena": arena, "pop": shape.K, "chunk_iters": shape.chunk_iters,
               "instance": instance_of(kern), "chunks": done, "iterations": iters, "flags": flags,
               "exits": reasons, "equal": not bad}
        if prob.s > 16:
            # K10 on sets of more than 16 members, off a multiple of 16 (a
            # set's leave-one-out rows span tiles).
            block = wide_flag_block(prob, plain)
            got = frontier_cuda.frontier_filter(kern, block, len(block)).tolist()
            want = plain.filter(block, len(block)).tolist()
            sizes = block.sum(-1)
            row["k10_wide_block"] = {"sets": len(block), "sizes": [int(sizes.min()), int(sizes.max())],
                                     "minimal": want[0], "witness": want[1], "equal": got == want}
            if got != want:
                bad.append(f"K10 on {len(block)} sets of {int(sizes.min())}-{int(sizes.max())} members: "
                           f"{got} != {want}")
        compare_rows[label] = row
        mismatches += [f"{label}: {b}" for b in bad]
    for instance, seen in exits.items():
        if set(EXIT_REASONS) - seen:
            mismatches.append(f"{instance}: no case left the chunk loop by {sorted(set(EXIT_REASONS) - seen)}")
    if mismatches:
        fail("compare_frontier", "; ".join(mismatches[:6]))
    phase_line("compare_frontier", card=card, seconds=round(time.perf_counter() - t0, 3),
               tolerance="exact (integer arena rows, counters, flags, minimal count and witness index)",
               exits={k: sorted(v) for k, v in exits.items()}, cases=compare_rows)

    # -- frontier: the CLI and GpuFrontierBackend in process ----------------
    nets = [(name, texts[name], manifest[name]["verdict"]) for name in manifest] + frontier_networks(synth)
    # The CLI as a process once a flag path: --cert-out on the broken twins of
    # scc 63 (past the sweep's reach), 126 (past one-word states), 180 and
    # 255 (past two-word states), --checkpoint on hier 6x4; every network
    # then runs through GpuFrontierBackend in process below.
    cli_nets = [net for net in nets if net[0] in ("stellar_like_fbas(21,3,broken)", "stellar_like_fbas(42,3,broken)",
                                                  "stellar_like_fbas(60,3,broken)", "stellar_like_fbas(85,3,broken)")]
    cmds, inputs = [], []
    for i, (label, src, _) in enumerate(cli_nets):
        cmds.append([sys.executable, "-m", PORT, "--backend", "gpu-frontier", "--cert-out",
                     str(work / f"frontier{i}.cert.json")])
        inputs.append(raw_json(src))
    ckpt = work / "frontier.ckpt"
    cmds.append([sys.executable, "-m", PORT, "--backend", "gpu-frontier", "--checkpoint", str(ckpt)])
    inputs.append(raw_json(synth.hierarchical_fbas(6, 4)))
    t = time.perf_counter()
    procs = run_all(cmds, inputs, parallel=len(cmds), timeout=600)
    cli_wall = time.perf_counter() - t
    cli_rows = {}
    for i, ((label, src, want), (so, se, rc, secs)) in enumerate(zip(cli_nets, procs)):
        if so.strip().splitlines()[-1:] != ["true" if want else "false"] or rc != (0 if want else 1):
            fail("frontier", f"CLI --backend gpu-frontier on {label}: printed {so[-40:]!r} exit {rc}; {se[-400:]!r}")
        cert_jobs.append((f"frontier/cli/{label}", src, json.loads((work / f"frontier{i}.cert.json").read_text())))
        cli_rows[label] = {"verdict": want, "process_s": secs}
    so, se, rc, secs = procs[-1]
    if rc != 0 or so.strip() != "true" or ckpt.exists():
        fail("frontier", f"CLI --checkpoint on hierarchical_fbas(6,4): exit {rc}, {so[-40:]!r}, "
                         f"checkpoint left: {ckpt.exists()}; {se[-400:]!r}")
    cli_rows["hierarchical_fbas(6,4) --checkpoint"] = {"verdict": True, "process_s": secs}

    for name in frontier_cuda.LAUNCHES:
        frontier_cuda.LAUNCHES[name] = 0
    runs, spans = {}, {}
    with LaunchTimer() as timer:
        for label, src, want in nets:
            since = timer.mark()
            t = time.perf_counter()
            res = solve(src, backend=GpuFrontierBackend())
            seconds = time.perf_counter() - t
            spans[label] = (since, timer.mark())
            if res.intersects is not want:
                fail("frontier", f"{label}: gpu-frontier says {res.intersects}, expected {want}")
            if not want and not witness_ok(src, res):
                fail("frontier", f"{label}: witness pair is not two disjoint quorums")
            row = {k: res.stats.get(k) for k in FRONTIER_STATS if k in res.stats}
            row.update(verdict=res.intersects, solve_seconds=seconds, backend=res.stats.get("backend"))
            if res.stats.get("backend") == "gpu-frontier":
                row["states_per_s"] = res.stats["states_popped"] / res.stats["seconds"]
                steady = res.stats["device_chunks"] - 1
                if steady > 0 and res.stats["chunk_seconds"] > 0:
                    row["steady_chunk_s"] = res.stats["chunk_seconds"] / steady
            if label in FRONTIER_COUNTS:
                got = (res.stats.get("states_popped"), res.stats.get("flagged"))
                if got != FRONTIER_COUNTS[label]:
                    fail("frontier", f"{label}: popped/flagged {got}, expected {FRONTIER_COUNTS[label]}")
                row["counts"] = "equal to the enumeration's exact count"
            cert_jobs.append((f"frontier/solve/{label}", src, res.cert))
            runs[label] = row
        # The pinned JAX cases past 64 lanes and off the pad ladder, at their
        # constants: verdict, witness and every pinned statistic.
        import _torch_frontier_pin as pin

        pins = json.loads(pin.PIN.read_text())
        for name in FRONTIER_PINNED:
            label = f"{name} (pinned constants {pin.CASES[name][3]})"
            src = pin.case_data(name, synth)
            since = timer.mark()
            t = time.perf_counter()
            res = solve(src, backend=GpuFrontierBackend(**pin.CASES[name][3]))
            seconds = time.perf_counter() - t
            spans[label] = (since, timer.mark())
            # The pins ran the host flag check (JAX on the CPU); here K10
            # checks the flags, so the check counts are not compared.
            keys = [k for k in pin.STAT_KEYS if k not in ("host_checks", "device_flag_checks", "minimal_quorums")]
            got = {"intersects": bool(res.intersects), "q1": res.q1, "q2": res.q2,
                   "stats": {k: res.stats.get(k) for k in keys}}
            want_pin = {**pins[name], "stats": {k: pins[name]["stats"][k] for k in keys}}
            if got != want_pin:
                fail("frontier", f"{name}: gpu-frontier gives {got}, the JAX pin {want_pin}")
            cert_jobs.append((f"frontier/pinned/{name}", src, res.cert))
            runs[label] = {**{k: res.stats.get(k) for k in pin.STAT_KEYS}, "verdict": res.intersects,
                           "solve_seconds": seconds, "counts": f"equal to the JAX pin: {', '.join(keys)}"}
    main_ms = timer.ms()
    for label, (since, until) in spans.items():
        runs[label]["device_ms_by_kernel"] = timer.ms(since, until)
        runs[label]["launches_by_kernel"] = timer.launches(since, until)
    launches = {name: frontier_cuda.LAUNCHES[fn] for fn, name in LaunchTimer.NAMES.items()}
    for name, n in launches.items():
        if n < 1:
            fail("frontier", f"the main path never launched {name}")
    # The launches of the instances of two, three and four words a state:
    # the runs past 64 and past 128 lanes.
    words_labels = {w: [label for label in runs if label.startswith(prefixes)]
                    for w, prefixes in FRONTIER_WORDS_RUNS.items()}
    words_launches = {w: {name: sum(runs[label]["launches_by_kernel"][name] for label in labels)
                          for name in launches} for w, labels in words_labels.items()}
    for w, counts in words_launches.items():
        for name, n in counts.items():
            if n < 1:
                fail("frontier", f"the main path's runs of {w} words a state never launched {name}")
    # A kill and a resume on the card: same verdict, the frontier picked up.
    from quorum_intersection_tpu_torch.backends.frontier import FrontierSearchInterrupted
    from quorum_intersection_tpu_torch.utils.checkpoint import FrontierCheckpoint

    ck = FrontierCheckpoint(work / "resume.ckpt")
    try:
        solve(synth.hierarchical_fbas(5, 3), backend=GpuFrontierBackend(
            arena=8192, pop=256, chunk_iters=2, checkpoint=ck, interrupt_after_chunks=2))
        fail("frontier", "the interrupt hook did not fire")
    except FrontierSearchInterrupted:
        pass
    resumed = solve(synth.hierarchical_fbas(5, 3), backend=GpuFrontierBackend(arena=8192, pop=256, checkpoint=ck))
    if resumed.intersects is not True or not resumed.stats.get("resumed_states"):
        fail("frontier", f"checkpoint resume on the card: {resumed.intersects}, {resumed.stats}")
    phase_line("frontier", card=card, launches=launches,
               launches_by_words_a_state={f"W={w}": counts for w, counts in words_launches.items()},
               main_path_device_ms=main_ms,
               main_path_device_ms_by="CUDA events around every launch", runs=runs, cli=cli_rows,
               cli_wall_seconds=cli_wall, resume={"resumed_states": resumed.stats["resumed_states"],
                                                  "states_popped": resumed.stats["states_popped"]})

    # -- frontier_route: gpu-frontier against the native oracle -------------
    route_nets = [
        ("hierarchical_fbas(6,4)", synth.hierarchical_fbas(6, 4), True),
        ("hierarchical_fbas(7,4)", synth.hierarchical_fbas(7, 4), True),
        ("hierarchical_fbas(8,4)", synth.hierarchical_fbas(8, 4), True),
        ("stellar_like_fbas(16,3,broken)", synth.stellar_like_fbas(16, 3, broken=True), False),
        ("stellar_like_fbas(21,3,broken)", synth.stellar_like_fbas(21, 3, broken=True), False),
        ("stellar_like_fbas(42,3,broken)", synth.stellar_like_fbas(42, 3, broken=True), False),
    ]
    route_rows = []
    for label, src, want in route_nets:
        t = time.perf_counter()
        res = solve(src, backend=GpuFrontierBackend(), with_cert=False)
        f_s = time.perf_counter() - t
        n_verdict, n_s, capped = native_capped(src, ORACLE_CAP_S)
        counts_ok = (label not in FRONTIER_COUNTS
                     or (res.stats["states_popped"], res.stats["flagged"]) == FRONTIER_COUNTS[label])
        ok = res.intersects is want and counts_ok and (capped or n_verdict is want)
        route_rows.append({"network": label, "scc": len(res.main_scc), "frontier_s": f_s, "native_s": n_s,
                           "native_capped": capped, "speedup_vs_native": n_s / f_s, "ok": ok})
    region = frontier_region(route_rows)
    committed = cal_mod.H100
    phase_line("frontier_route", card=card, rows=route_rows, native_cap_s=ORACLE_CAP_S,
               measured_region=None if region is None else {"frontier_win_min_scc": region[0],
                                                            "frontier_win_max_scc": region[1]},
               measured_on=torch.cuda.get_device_name(0), committed_for=committed.kind,
               committed_region={"frontier_win_min_scc": committed.frontier_win_min_scc,
                                 "frontier_win_max_scc": committed.frontier_win_max_scc},
               rule="smallest |scc| from which every measured row wins (>= 1x, verdicts and counts right); "
                    "the router takes it above the sweep limit only")

    # -- timing_frontier: K9 and K10 at hier-8x4's shape ---------------------
    src = synth.hierarchical_fbas(8, 4)
    prob, shape, kern, plain = frontier_setup(src, device, 1 << 18, 2048)
    # A mid-search state: default chunks from the seed until the stack holds
    # more than a pop, collecting the flagged sets on the way.
    state, top, flag_rows = k9_timing_state(kern, prob, shape)
    dst = kern.arena()
    far = shape.flag_cap - shape.K  # a flag exit no timed chunk reaches

    def k9(iters):
        kern.shape.chunk_iters = iters
        frontier_cuda.frontier_chunk(kern, state, dst, far)

    timing = {}
    t1, t33 = time_ms(lambda: k9(1), 20), time_ms(lambda: k9(33), 10)
    d1, d33 = device_ms(lambda: k9(1), 10), device_ms(lambda: k9(33), 10)
    k9(33)
    k33 = kern.arena()
    for name in ("T", "D", "flags", "ctr"):
        getattr(k33, name).copy_(getattr(dst, name))
    per_chunk_iters = k33.ctr.tolist()[2]
    # A default chunk (up to 512 iterations) from the same state: it ends
    # where its flags reach the exit, as the drive's chunks do.
    t_default = time_ms(lambda: k9(512), 3)
    k9(512)
    default_ctr = dst.ctr.tolist()
    # The plain version on the same 33 iterations, then the bound of that
    # work: the MACs of the fixpoint passes its rows take (counted by the
    # plain version) and the state rows it moves.
    kern.shape.chunk_iters = 33
    pdst = kern.arena()
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    plain.chunk(state, pdst, far)
    torch.cuda.synchronize()
    plain_33_ms = (time.perf_counter() - t_plain) * 1e3
    kern.shape.chunk_iters = 512
    # The fixpoint passes of the 33 iterations' rows, by a replay of the
    # plain version's iterations; the replay also gives PR 9's traffic model
    # (every popped row read and every child row written through the arena,
    # an iteration at a time), kept beside the chunk's own bound.
    ptop, fc, passes, model_bytes = k9_replay(prob, shape, plain, state, top, 33)
    p_top, p_fc = pdst.ctr.tolist()[:2]
    if k33.ctr.tolist() != pdst.ctr.tolist() or not (
        torch.equal(k33.T[:p_top], pdst.T[:p_top]) and torch.equal(k33.D[:p_top], pdst.D[:p_top])
        and torch.equal(k33.flags[:p_fc], pdst.flags[:p_fc])
    ):
        fail("timing_frontier", f"K9's timed 33-iteration chunk differs from the plain chunk: counters "
                                f"{k33.ctr.tolist()} against {pdst.ctr.tolist()}, or its rows or flags")
    if [ptop, fc] != [p_top, p_fc]:
        fail("timing_frontier", f"the bound's replay ended at top {ptop}, {fc} flags; the plain chunk at "
                                f"{pdst.ctr.tolist()}")
    macs = macs_per_pass(prob.circuit)
    nbytes = k9_least_bytes(prob, kern, top, p_top, p_fc)
    b_ms, b_by = bound(passes * macs, nbytes)
    model_ms, _ = bound(passes * macs, model_bytes)
    timing["K9_breakdown"] = k9_breakdown(kern, state, dst, far, k33, (t33 - t1) / 32)
    timing["K9"] = {"shape": f"hierarchical_fbas(8,4): s={prob.s} (s_dev {prob.s_dev}), K={shape.K}, "
                             f"C={shape.C}, top {top} at the timed state",
                    "instance": instance_of(kern), "grid_blocks": getattr(kern, "grid", None),
                    "ms_1_iteration_chunk": t1, "ms_33_iteration_chunk": t33,
                    "ms_per_iteration": (t33 - t1) / 32, "iterations_33": per_chunk_iters,
                    "device_alone_ms_1_and_33": [d1, d33], "ms_per_iteration_device_alone": (d33 - d1) / 32,
                    "ms_default_chunk": t_default, "default_chunk_counters": default_ctr,
                    "plain_ms_33_iterations": plain_33_ms, "bound_ms_33_iterations": b_ms, "bound_by": b_by,
                    "bytes_33": nbytes, "x_bound_33": t33 / b_ms,
                    "fixpoint_passes_33": passes, "macs_per_pass": macs,
                    "pr9_traffic_model": {"bytes_33": model_bytes, "bound_ms_33": model_ms,
                                          "bound_ms_per_iteration": model_ms / 33,
                                          "of": "every popped row read and every child row written, "
                                                "an iteration at a time"}}
    # K10 on a full block of hier-8x4's own flagged sets.
    rows = torch.cat(flag_rows)[: shape.flag_cap].contiguous()
    count = rows.shape[0]
    block = torch.zeros((shape.flag_cap, prob.s_dev), dtype=torch.int8, device=device)
    block[:count] = rows
    # Back to back (the card stays busy, as beside the chunk
    # in the drive), and each call alone behind a stream spin.
    k10_ms = time_ms(lambda: frontier_cuda.frontier_filter(kern, block, count), 50)
    k10_alone = device_ms(lambda: frontier_cuda.frontier_filter(kern, block, count), 20)
    got = frontier_cuda.frontier_filter(kern, block, count).tolist()
    t_plain = time.perf_counter()
    want = plain.filter(block, count).tolist()
    torch.cuda.synchronize()
    k10_plain = (time.perf_counter() - t_plain) * 1e3
    if got != want:
        fail("timing_frontier", f"K10 on hier-8x4's flags: {got} != plain {want}")
    member = block[:count].to(torch.int32)
    i_idx, j_idx = torch.nonzero(member, as_tuple=True)
    loo = member[i_idx].clone()
    loo[torch.arange(loo.shape[0], device=device), j_idx] = 0
    loo_passes = int(fixpoint_passes(plain.tables, rows_in_circuit(plain.tables, plain.scc_idx, loo))[1].sum())
    probe = torch.clamp(1 - member, 0, 1)
    probe_passes = int(fixpoint_passes(plain.probe_tables, rows_in_circuit(plain.probe_tables, plain.scc_idx,
                                                                            probe))[1].sum())
    k10_bound, k10_by = bound((loo_passes + probe_passes) * macs, count * prob.s_dev + 8)
    wide = {w: wide_timing(device, synth, orgs) for w, orgs in ((2, 42), (3, 60), (4, 85))}
    if frontier_parent is not None:
        timing["parent_in_turns"] = frontier_parent_turns(kern, prob, shape, state, far, block, count, want,
                                                          frontier_parent, work, wide[2][2])
    hier = runs["hierarchical_fbas(8,4)"]
    timing["K10"] = {"flags": count, "block": shape.flag_cap, "ms": k10_ms,
                     "ms_of": "50 launches back to back (CUDA events)", "ms_device_alone": k10_alone,
                     "plain_ms": k10_plain,
                     "bound_ms": k10_bound, "bound_by": k10_by, "minimal": got[0],
                     "loo_rows": int(loo.shape[0]), "fixpoint_passes": loo_passes + probe_passes,
                     "in_hier_8x4_solve_ms": hier["device_ms_by_kernel"]["frontier_filter_cuda"],
                     "in_hier_8x4_solve_launches": hier["launches_by_kernel"]["frontier_filter_cuda"]}
    for w, (k9_row, k10_row, _) in wide.items():
        timing[f"K9_w{w}"], timing[f"K10_w{w}"] = k9_row, k10_row
    phase_line("timing_frontier", card=card, timing=timing,
               bound="fixpoint passes x nonzero votes at the int8 peak against, at 3.35 TB/s, K9's source rows "
                     "read once and its rows and flags written once, K10's flag rows read once")

    records = [
        {"name": "frontier_chunk_cuda", "route": "cuda", "source": f"{PORT}/kernels/csrc/frontier.cu",
         "replaces": "quorum_intersection_tpu/backends/tpu/frontier.py:330",
         "launches": launches["frontier_chunk_cuda"], "max_abs_err": 0,
         "ms": t33, "plain_ms": plain_33_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
         "ms_of": "one 33-iteration chunk at hierarchical_fbas(8,4)'s shape (K=2048)",
         "ms_per_iteration": (t33 - t1) / 32, "x_bound": t33 / b_ms,
         "pr9_traffic_model_bound_ms": model_ms,
         "main_path_device_ms": main_ms["frontier_chunk_cuda"],
         "main_path_device_ms_of": "phase frontier, GpuFrontierBackend in process (CUDA events)"},
        {"name": "frontier_filter_cuda", "route": "cuda", "source": f"{PORT}/kernels/csrc/frontier.cu",
         "replaces": "quorum_intersection_tpu/backends/tpu/frontier.py:254",
         "launches": launches["frontier_filter_cuda"], "max_abs_err": 0,
         "ms": k10_ms, "plain_ms": k10_plain, "bound_ms": k10_bound, "bound_by": k10_by, "library_ms": None,
         "ms_of": f"one {count}-flag block of hierarchical_fbas(8,4)",
         "main_path_device_ms": main_ms["frontier_filter_cuda"],
         "main_path_device_ms_of": "phase frontier, GpuFrontierBackend in process (CUDA events)"},
    ]
    # The instances of two, three and four words a state (65-128, 129-192
    # and 193-256 lanes), timed at broken stellar_like_fbas(42 | 60 | 85,
    # 3)'s shape, their launches the runs of that many words.
    for w, orgs in ((2, 42), (3, 60), (4, 85)):
        for base, row, of in ((records[0], timing[f"K9_w{w}"], "one 33-iteration chunk"),
                              (records[1], timing[f"K10_w{w}"], f"one {timing[f'K10_w{w}']['flags']}-flag block")):
            records.append({**{k: base[k] for k in ("route", "source", "replaces", "max_abs_err", "library_ms")},
                            "name": f"{base['name']}_w{w}", "launches": words_launches[w][base["name"]],
                            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                            "bound_by": row["bound_by"], "x_bound": row["ms"] / row["bound_ms"],
                            "ms_of": f"{of} at stellar_like_fbas({orgs},3,broken)'s shape: {row['shape']}",
                            "launches_of": f"phase frontier's runs of {w} words a state: "
                                           + ", ".join(words_labels[w])})
    return records


def wide_timed_state(device, synth, phase, orgs=42):
    """The wide instances' timed state: broken stellar_like_fbas(orgs,3)
    (42: 126 lanes, two words a state; 60: 180, three; 85: 255, four) set up
    at the JAX constants and one chunk of 40 iterations from its seed (a
    flag exit no chunk reaches); ``(prob, shape, kern, plain, state, its
    top, that flag exit)``."""
    from quorum_intersection_tpu_torch.kernels import frontier_cuda

    prob, shape, kern, plain = frontier_setup(synth.stellar_like_fbas(orgs, 3, broken=True), device, 1 << 18, 2048)
    far = shape.flag_cap - shape.K
    state = kern.arena()
    kern.shape.chunk_iters = 40
    frontier_cuda.frontier_chunk(kern, frontier_seed(kern, prob), state, far)
    top = state.ctr.tolist()[0]
    if top <= shape.K:
        fail(phase, f"the {prob.s_dev}-lane timed state holds {top} states, not more than a pop")
    return prob, shape, kern, plain, state, top, far


def wide_timing(device, synth, orgs=42):
    """K9 and K10 past one word a state, at broken
    stellar_like_fbas(orgs,3)'s shape (42: 126 lanes padded to 128, 192
    units; 60: 180 lanes padded to 192, 256 units; 85: 255 lanes padded to
    256, 384 units; K 2048), from its own search: K9's 1- and 33-iteration
    chunks from the state 40 iterations after the seed (held to the plain
    chunk), K10 on the flags its whole search writes, each with its plain
    version and bound; and ``(kern, state, dst, far)``, the timed chunk's
    problem and arenas."""
    import torch

    from quorum_intersection_tpu_torch.kernels import frontier_cuda
    from quorum_intersection_tpu_torch.kernels.frontier_ref import rows_in_circuit
    from quorum_intersection_tpu_torch.kernels.sweep_ref import fixpoint_passes

    prob, shape, kern, plain, state, top, far = wide_timed_state(device, synth, "timing_frontier", orgs)
    dst = kern.arena()

    def k9(iters):
        kern.shape.chunk_iters = iters
        frontier_cuda.frontier_chunk(kern, state, dst, far)

    t1, t33 = time_ms(lambda: k9(1), 20), time_ms(lambda: k9(33), 10)
    d1, d33 = device_ms(lambda: k9(1), 10), device_ms(lambda: k9(33), 10)
    k9(33)
    pdst = kern.arena()
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain.chunk(state, pdst, far)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    kern.shape.chunk_iters = 512
    p_top, p_fc = pdst.ctr.tolist()[:2]
    if dst.ctr.tolist() != pdst.ctr.tolist() or not (
        torch.equal(dst.T[:p_top], pdst.T[:p_top]) and torch.equal(dst.D[:p_top], pdst.D[:p_top])
        and torch.equal(dst.flags[:p_fc], pdst.flags[:p_fc])
    ):
        fail("timing_frontier", f"K9's {prob.s_dev}-lane 33-iteration chunk differs from the plain chunk: counters "
                                f"{dst.ctr.tolist()} against {pdst.ctr.tolist()}, or its rows or flags")
    iters = dst.ctr.tolist()[2]
    _, _, passes, _ = k9_replay(prob, shape, plain, state, top, 33)
    macs = macs_per_pass(prob.circuit)
    b_ms, b_by = bound(passes * macs, k9_least_bytes(prob, kern, top, p_top, p_fc))
    shape_text = (f"s={prob.s} (s_dev {prob.s_dev}, {kern.st_T.numel() // (2 * frontier_cuda.stash_rows(shape.K))} "
                  f"words a state), units {prob.circuit.n_units}, K={shape.K}, C={shape.C}, top {top}")
    k9_row = {"shape": shape_text, "instance": instance_of(kern), "grid_blocks": kern.grid, "ms": t33,
              "ms_1_iteration_chunk": t1, "ms_per_iteration": (t33 - t1) / max(iters - 1, 1), "iterations": iters,
              "device_alone_ms_1_and_33": [d1, d33], "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "fixpoint_passes": passes, "macs_per_pass": macs}

    # K10 on every flag of the search, chunk after chunk from the seed.
    cur, nxt = frontier_seed(kern, prob), kern.arena()
    rows = []
    for _ in range(64):
        frontier_cuda.frontier_chunk(kern, cur, nxt, 512)
        top, fcount = nxt.ctr.tolist()[:2]
        rows.append(nxt.flags[:fcount].clone())
        cur, nxt = nxt, cur
        if top == 0 or top > shape.C - 2 * shape.K:
            break
    rows = torch.cat(rows)[: shape.flag_cap]
    count = rows.shape[0]
    if count < 1:
        fail("timing_frontier", f"the {prob.s_dev}-lane search flagged no set")
    block = torch.zeros((shape.flag_cap, prob.s_dev), dtype=torch.int8, device=device)
    block[:count] = rows
    k10_ms = time_ms(lambda: frontier_cuda.frontier_filter(kern, block, count), 50)
    got = frontier_cuda.frontier_filter(kern, block, count).tolist()
    t = time.perf_counter()
    want = plain.filter(block, count).tolist()
    torch.cuda.synchronize()
    k10_plain = (time.perf_counter() - t) * 1e3
    if got != want:
        fail("timing_frontier", f"K10 on the {prob.s_dev}-lane search's flags: {got} != plain {want}")
    member = block[:count].to(torch.int32)
    i_idx, j_idx = torch.nonzero(member, as_tuple=True)
    loo = member[i_idx].clone()
    loo[torch.arange(loo.shape[0], device=device), j_idx] = 0
    loo_passes = int(fixpoint_passes(plain.tables, rows_in_circuit(plain.tables, plain.scc_idx, loo))[1].sum())
    probe_passes = int(fixpoint_passes(plain.probe_tables, rows_in_circuit(
        plain.probe_tables, plain.scc_idx, torch.clamp(1 - member, 0, 1)))[1].sum())
    k10_bound, k10_by = bound((loo_passes + probe_passes) * macs, count * prob.s_dev + 8)
    k10_row = {"shape": shape_text, "flags": count, "block": shape.flag_cap, "ms": k10_ms,
               "ms_of": "50 launches back to back (CUDA events)", "plain_ms": k10_plain, "bound_ms": k10_bound,
               "bound_by": k10_by, "minimal": got[0], "witness": got[1], "fixpoint_passes": loo_passes + probe_passes}
    return k9_row, k10_row, (kern, state, dst, far)


class ParentK8:
    """K8 of another tree (its ``csrc/bitset_sweep.cu``, the one-warp-a-row
    kernel with its ``qi_bitset_sweep`` C interface), built with ``nvcc``
    beside this tree's.  :meth:`program` does what that tree's wrapper did
    a call (the int32 result filled on the stream, the launch) on the warp
    instance's tables of this tree, which are that tree's tables."""

    def __init__(self, tree, work):
        import ctypes

        from quorum_intersection_tpu_torch.kernels import build

        self.src = pathlib.Path(tree) / PORT / "kernels" / "csrc" / "bitset_sweep.cu"
        lib_path = work / "parent_bitset_sweep.so"
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(self.src)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail("timing_bitset", f"nvcc refused {self.src}: {(proc.stdout + proc.stderr)[-2000:]}")
        self.ptxas = ptxas_instances(proc.stdout + proc.stderr)
        lib = self.lib = ctypes.CDLL(str(lib_path))
        p, i, u64, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_longlong
        lib.qi_bitset_sweep.argtypes = [p, p, p, i, i, i, i, i, i, p, i, u64, u64, u64, i64, i64, p, p]
        lib.qi_bitset_sweep.restype = i

    def program(self, sweep, start, steps, hi_mask):
        import torch

        t = sweep.tables
        out = torch.empty((), dtype=torch.int32, device=sweep.device)
        out.fill_(2**31 - 1)
        err = self.lib.qi_bitset_sweep(
            t.units.data_ptr(), t.ranges.data_ptr(), t.words.data_ptr(), t.n_words, t.units_pad, t.nw, t.rounds,
            int(t.resident), t.warps, sweep.lo_nodes.data_ptr(), sweep.lo_bits, hi_mask, sweep.scc_bits,
            sweep.frozen_bits, start, steps * sweep.batch, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail("timing_bitset", f"the parent's K8 launch failed: error {err}")
        return out


class ParentK1:
    """K1 of another tree (its ``csrc/sweep.cu`` with the same
    ``qi_sweep_fused`` C interface), built with ``nvcc`` beside this tree's.
    :meth:`program` does what that tree's wrapper does a call (the int32
    result filled on the stream, the launch) on this tree's tables, which
    are that tree's."""

    def __init__(self, tree, work):
        import ctypes

        from quorum_intersection_tpu_torch.kernels import build

        src = pathlib.Path(tree) / PORT / "kernels" / "csrc" / "sweep.cu"
        lib_path = work / "parent_sweep.so"
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail("mesh", f"nvcc refused {src}: {(proc.stdout + proc.stderr)[-2000:]}")
        self.ptxas = ptxas_instances(proc.stdout + proc.stderr)
        lib = self.lib = ctypes.CDLL(str(lib_path))
        p, i, u64, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_longlong
        lib.qi_sweep_fused.argtypes = [p, p, p, p, p, i, u64, u64, u64, i, i, i, i, i, i, i, i, i, i64, i64, p, p]
        lib.qi_sweep_fused.restype = i

    def program(self, sweep, start, steps, hi_mask):
        import torch

        t = sweep.tables
        out = torch.full((), 2**31 - 1, dtype=torch.int32, device=sweep.device)
        err = self.lib.qi_sweep_fused(
            t.blocks.data_ptr(), t.chunks.data_ptr(), t.neg_thresholds.data_ptr(), sweep.neg_thr_d.data_ptr(),
            sweep.lo_nodes.data_ptr(), sweep.lo_bits, hi_mask, sweep.scc_bits, sweep.frozen_bits,
            t.n, t.n_units, t.units, t.depth, t.c0, t.slabs, t.pc, t.nblocks, int(t.stream),
            start, steps * sweep.batch, out.data_ptr(), torch.cuda.current_stream(sweep.device).cuda_stream)
        if err != 0:
            fail("mesh", f"the parent's K1 launch failed: error {err}")
        return out


class TrippingCancel:
    """A cancel token that reads as cancelled after ``after`` polls: a sweep
    stopped after a few programs, as a preempted run is."""

    def __init__(self, after: int):
        self.after = after
        self.polls = 0

    @property
    def cancelled(self) -> bool:
        self.polls += 1
        return self.polls > self.after


class engine_env:
    """``QI_SWEEP_ENGINE`` set to ``value`` (None: unset) inside the block,
    restored after."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        import os

        self.saved = os.environ.get("QI_SWEEP_ENGINE")
        os.environ.pop("QI_SWEEP_ENGINE", None)
        if self.value is not None:
            os.environ["QI_SWEEP_ENGINE"] = self.value

    def __exit__(self, *exc):
        import os

        os.environ.pop("QI_SWEEP_ENGINE", None)
        if self.saved is not None:
            os.environ["QI_SWEEP_ENGINE"] = self.saved


def bitset_phases(device, card, texts, manifest, cert_jobs, witness_ok, work, ptxas, k8_parent=None):
    """Phases compare_bitset, timing_bitset, bitset_route and checkpoint;
    returns K8's record entry.  K8's main path is bitset_route's solves under
    ``QI_SWEEP_ENGINE=bitset`` (launch count reset before, read after).
    ``k8_parent``: a tree whose K8 timing_bitset times in turns with this
    one's on every shape."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.backends import calibration as cal_mod
    from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
    from quorum_intersection_tpu_torch.encode.circuit import encode_circuit
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels.bitset_sweep_cuda import (
        INSTANCES,
        SMEM_LIMIT,
        BitsetSweep,
        KernelLimitError,
        bitset_sweep,
        smem_bytes,
    )
    from quorum_intersection_tpu_torch.kernels.bitset_sweep_ref import BitsetSweepRef
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import FusedSweep, mask_bits, sweep_fused
    from quorum_intersection_tpu_torch.pipeline import quorum_bearing_sccs, solve
    from quorum_intersection_tpu_torch.utils.checkpoint import SweepCheckpoint

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_bitset_cases import BitsetProblem, card_problems, circuit_problem

    int32_max = 2**31 - 1

    # -- compare_bitset: K8 against its plain version, every instance -------
    def fixture_problem(name):
        circuit, circuit_d, local, scc_mask, frozen = sweep_problem(fixture_text(name))
        return BitsetProblem(f"{name} SCC", circuit, circuit_d, local, scc_mask, frozen)

    cases = []
    for name in ("snapshot_broken.json", "snapshot_correct.json", "nested_broken.json", "nested_correct.json",
                 "trivial_broken.json"):
        prob = fixture_problem(name)
        bits = len(prob.local) - 1
        cases.append((prob, bits, [0], [0], 1 << 12, 2))
    cases += card_problems()
    t0 = time.perf_counter()
    rows, max_err, hits = [], 0, 0
    for prob, lo_bits, his, starts, batch, steps in cases:
        lo_nodes, _ = prob.decode(lo_bits)
        kernels = {}
        for instance in INSTANCES:
            try:
                kernels[instance] = BitsetSweep(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, batch,
                                                prob.circuit_d, device, instance=instance)
            except KernelLimitError:
                if instance == "streamed":
                    raise
        plain = BitsetSweepRef(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, batch, prob.circuit_d, device)
        windows = case_hits = 0
        for hi in his:
            _, hi_row = prob.decode(lo_bits, hi)
            for start in starts:
                want = int(plain.program(start, steps, hi_row if hi_row.any() else None))
                windows += 1
                case_hits += want != int32_max
                for instance, kern in kernels.items():
                    try:
                        got = int(kern.program(start, steps, mask_bits(hi_row)))
                        torch.cuda.synchronize()
                    except RuntimeError as exc:
                        fail("compare_bitset", f"{prob.label} ({instance}) hi={hi} start={start}: {exc}")
                    max_err = max(max_err, abs(got - want))
                    if got != want:
                        fail("compare_bitset", f"{prob.label} ({instance}) hi={hi} start={start}: "
                                               f"kernel {got} != plain {want}")
        hits += case_hits
        chosen = BitsetSweep(prob.circuit, lo_nodes, prob.scc_mask, prob.frozen, 1, prob.circuit_d, device).tables
        rows.append({"label": prob.label, "n": prob.circuit.n, "units": prob.circuit.n_units,
                     "depth": prob.circuit.depth, "restricted": prob.circuit_d is not None, "lo_bits": lo_bits,
                     "rows_a_program": batch * steps, "windows": windows, "windows_with_hits": case_hits,
                     "instances": list(kernels), "chosen": chosen.instance, "table_bytes": chosen.nbytes})
    chosen_ok = all(r["chosen"] == ("lanes" if r["units"] <= 128 else "streamed" if r["units"] > 3000
                                    else "resident") for r in rows)
    if not hits or not chosen_ok or not any("lanes" in r["instances"] for r in rows):
        fail("compare_bitset", "no window with a hit, or an instance chosen against the shape rule "
                               "(lanes up to 128 units, the 3001-unit circuit streamed, resident between)")
    phase_line("compare_bitset", tolerance="exact (integer hit indices)", seconds=time.perf_counter() - t0,
               windows_with_hits=hits, max_abs_err=max_err, cases=rows)

    # -- timing_bitset: K8 and K1 a 2^20-candidate window, in turns ---------
    parent = ParentK8(k8_parent, work) if k8_parent is not None else None

    def ring_problem(broken):
        data = synth.inner_set_ring_fbas(30, 12, broken=broken)
        return circuit_problem(f"inner_set_ring_fbas(30,12,broken={broken})", encode_circuit(build_graph(parse_fbas(data))))

    # label: (problem, lo_bits (None: all), hi, start, wide)
    shapes = {
        "bench256_34": (BitsetProblem("bench256_34", *sweep_problem(json.dumps(synth.benchmark_fbas(256, 34)))),
                        30, 5, 1 << 20, False),
        "snapshot": (BitsetProblem("snapshot", *sweep_problem(fixture_text("snapshot_broken.json"))), None, 0, 0,
                     False),
        "sparse_giant": (BitsetProblem("sparse_giant", *sweep_problem(json.dumps(synth.sparse_giant(400)))),
                         None, 0, 1 << 20, False),
        "ring390": (ring_problem(False), 29, 0, 1 << 20, True),
        "dense993": (circuit_problem("dense_child_circuit()", dense_child_circuit()), 30, 0, 1 << 20, True),
        "dense3001": (circuit_problem("dense_child_circuit(units=3001)", dense_child_circuit(units=3001)), 30, 0,
                      1 << 20, True),
    }
    timing = {}
    for label, (prob, lo_bits, hi, start, wide) in shapes.items():
        circuit, circuit_d, scc_mask, frozen = prob.circuit, prob.circuit_d, prob.scc_mask, prob.frozen
        lo_bits = len(prob.local) - 1 if lo_bits is None else lo_bits
        lo_nodes, hi_row = prob.decode(lo_bits, hi)
        hi_bits = mask_bits(hi_row)
        k8 = BitsetSweep(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device)
        k1 = FusedSweep(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device)
        arms = {"k8": lambda: k8.program(start, 8, hi_bits), "k1": lambda: k1.program(start, 8, hi_bits)}
        if parent is not None:
            fits = smem_bytes(k8.tables.units_pad, k8.tables.n_words, True, k8.tables.warps) <= SMEM_LIMIT
            k8_parent_sweep = BitsetSweep(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device,
                                          instance="resident" if fits else "streamed")
            arms["parent"] = lambda: parent.program(k8_parent_sweep, start, 8, hi_bits)
        answers = {who: int(fn()) for who, fn in arms.items()}
        if len(set(answers.values())) != 1:
            fail("timing_bitset", f"{label}: the arms disagree on the timed window: {answers}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        arms["k8"]()
        torch.cuda.synchronize()
        once_ms = (time.perf_counter() - t) * 1e3
        reps = 30 if not wide else max(2, min(30, int(300 / max(once_ms, 1e-3))))
        k8_before, k1_before = bitset_sweep.launches, sweep_fused.launches
        order = ("k8", "k1", "k1", "k8") if parent is None else ("parent", "k8", "k1", "k1", "k8", "parent")
        turns = {f"{who}{suffix}": [] for who in arms for suffix in ("", "_device")}
        for who in order:
            turns[who].append(time_ms(arms[who], reps))
            turns[f"{who}_device"].append(device_ms(arms[who], max(2, reps // 3)))
        if wide:
            plain_ms = None  # the plain version's (B, U) vote tensors at 3001 units: not timed
        else:
            plain = BitsetSweepRef(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device)
            plain_ms = time_ms(lambda: plain.program(start, 8, hi_row if hi_bits else None), 2)
        bound_ms, bound_by, passes = window_bound_ms(circuit, circuit_d, lo_nodes, scc_mask, frozen, start,
                                                     hi_row if hi_bits else None, device,
                                                     chunk=1 << 13 if wide else 1 << 17)
        k8_ms = sum(turns["k8"]) / 2
        k1_ms = sum(turns["k1"]) / 2
        row = {
            "n": circuit.n, "units": circuit.n_units, "depth": circuit.depth, "words": k8.tables.nw,
            "unit_words": k8.tables.units_pad // 32, "instance": k8.tables.instance,
            "lane_words": None if k8.tables.lanes is None else [k8.tables.lanes.cw, k8.tables.lanes.nw],
            "window": WINDOW, "start": start, "hit": answers["k8"], "reps": reps, "ms": k8_ms, "k1_ms": k1_ms,
            "k8_over_k1": k8_ms / k1_ms, "turns_ms": turns, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "over_bound": k8_ms / bound_ms, "fixpoint_passes": passes,
            "candidates_per_s": WINDOW / k8_ms * 1e3,
            "launches": {"bitset_sweep_cuda": bitset_sweep.launches - k8_before,
                         "sweep_fused_cuda": sweep_fused.launches - k1_before},
        }
        if parent is not None:
            row["parent_ms"] = sum(turns["parent"]) / 2
            row["parent_instance"] = "resident" if fits else "streamed"
            row["slower_turn_this_over_faster_turn_parent"] = max(turns["k8"]) / min(turns["parent"])
        timing[label] = row
    phase_line("timing_bitset", card=card, per_window=timing, ptxas=ptxas.get("bitset_sweep"),
               parent=None if parent is None else {"source": str(parent.src), "ptxas": parent.ptxas})

    # -- bitset_route: QI_SWEEP_ENGINE=bitset against the default, warm ------
    route_sources = [("sparse_giant()", synth.sparse_giant(), True, 1)]
    for broken in (False, True):
        route_sources += [(f"sparse_giant(400,broken={broken})", synth.sparse_giant(400, broken=broken), not broken, 2),
                          (f"benchmark_fbas(256,core=34,broken={broken})",
                           synth.benchmark_fbas(256, 34, broken=broken), not broken, 2),
                          (f"majority_fbas(18,broken={broken})", synth.majority_fbas(18, broken=broken), not broken, 2),
                          # The 390-unit ring, on the warp instance's trimmed child rows.  Neither
                          # twin intersects: the default engine's verdict is the one to match.
                          (f"inner_set_ring_fbas(30,12,broken={broken})",
                           synth.inner_set_ring_fbas(30, 12, broken=broken), None, 2)]
    route_rows = []
    bitset_sweep.launches = 0  # K8's main path: the bitset solves below
    for name, data, want, rounds in route_sources:
        text = json.dumps(data)
        graph = build_graph(parse_fbas(text))
        [(_, scc)] = quorum_bearing_sccs(graph)
        density = synth.scc_qset_density(graph, scc)
        runs = {None: [], "bitset": []}
        order = (None, "bitset", "bitset", None) if rounds == 2 else (None, "bitset")
        for engine in order:
            with engine_env(engine):
                t = time.perf_counter()
                res = solve(text, backend="gpu-sweep")
                runs[engine].append((time.perf_counter() - t, res))
        dense, bits = runs[None][-1][1], runs["bitset"][-1][1]
        ok = (want is None or dense.intersects is want) and bits.intersects is dense.intersects
        ok = (ok and (dense.q1, dense.q2, dense.stats.get("hit_index")) == (bits.q1, bits.q2, bits.stats.get("hit_index"))
              and bits.stats.get("encoding") == "bitset" and "encoding" not in dense.stats
              and (bits.intersects or witness_ok(text, bits)))
        if not ok:
            fail("bitset_route", f"{name}: the bitset solve disagrees with the default one")
        for engine, label in ((None, "default"), ("bitset", "bitset")):
            for i, (_, res) in enumerate(runs[engine]):
                cert_jobs.append((f"bitset_route/{label}/{i}/{name}", text, res.cert))
        default_s = min(s for s, _ in runs[None])
        bitset_s = min(s for s, _ in runs["bitset"])
        route_rows.append({"source": name, "scc": len(scc), "density": density, "verdict": dense.intersects,
                           "default_seconds": [s for s, _ in runs[None]],
                           "bitset_seconds": [s for s, _ in runs["bitset"]],
                           "default_sweep_seconds": dense.stats["seconds"], "bitset_sweep_seconds": bits.stats["seconds"],
                           "speedup": default_s / bitset_s, "verdict_ok": ok,
                           "hit_index": bits.stats.get("hit_index")})
    main_launches = bitset_sweep.launches
    if main_launches < 1:
        fail("bitset_route", "the bitset solves never launched bitset_sweep_cuda")
    with engine_env("bitset"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            solve(synth.benchmark_fbas(256, 34), backend="gpu-sweep")
            torch.cuda.synchronize()
    by_kernel = device_ms_by_kernel(prof)
    main_device_ms = ms_of(by_kernel, "bitset_lane_kernel") + ms_of(by_kernel, "bitset_sweep_kernel")
    region = cal_mod.bitset_region([(r["scc"], r["density"], r["speedup"], r["verdict_ok"]) for r in route_rows])
    committed = cal_mod.H100
    phase_line("bitset_route", card=card, rows=route_rows, launches={"bitset_sweep_cuda": main_launches},
               region=region, committed={"bitset_win_min_scc": committed.bitset_win_min_scc,
                                         "bitset_win_max_density": committed.bitset_win_max_density},
               main_path_device_ms=main_device_ms)

    # -- checkpoint: a full-width sweep stopped after a few programs, resumed
    full = synth.benchmark_fbas(256, 34)
    full_text = json.dumps(full)
    ck_rows = []
    for writer, reader in ((None, None), (None, "bitset"), ("bitset", None)):
        path = work / f"sweep-{writer}-{reader}.ckpt"
        ckpt = SweepCheckpoint(path)
        with engine_env(writer):
            try:
                solve(full_text, backend=GpuSweepBackend(checkpoint=ckpt, cancel=TrippingCancel(40)))
                fail("checkpoint", "the stopped sweep ran to its verdict")
            except Exception as exc:  # the stopped run raises SearchCancelled
                if type(exc).__name__ != "SearchCancelled":
                    raise
        recorded = json.loads(path.read_text())
        with engine_env(reader):
            t = time.perf_counter()
            res = solve(full_text, backend=GpuSweepBackend(checkpoint=SweepCheckpoint(path)))
            seconds = time.perf_counter() - t
        resumed = res.stats.get("resumed_from", 0)
        if not (res.intersects and resumed == recorded["position"] > 0
                and res.stats["candidates_checked"] + resumed == res.stats["enumeration_total"]
                and not path.exists()):
            fail("checkpoint", f"resume ({writer} -> {reader}): {res.stats.get('resumed_from')} of "
                               f"{recorded}, verdict {res.intersects}")
        cert_file, src_file = work / f"ck-{writer}-{reader}.json", work / f"ck-{writer}-{reader}.src.json"
        cert_file.write_text(json.dumps(res.cert))
        src_file.write_text(full_text)
        out = subprocess.run([sys.executable, str(ROOT / "tools" / "check_cert.py"), str(cert_file), str(src_file)],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0 or "checkpoint-resumed" not in out.stdout + out.stderr:
            fail("checkpoint", f"the checker on the resumed certificate: {out.returncode} {out.stdout[-300:]!r}")
        cert_jobs.append((f"checkpoint/{writer}->{reader}", full_text, res.cert))
        ck_rows.append({"written_by": writer or "default", "resumed_by": reader or "default",
                        "position": recorded["position"], "total": recorded["total"],
                        "resumed_from": resumed, "candidates_checked": res.stats["candidates_checked"],
                        "encoding": res.stats.get("encoding", "dense"), "seconds": seconds})
    phase_line("checkpoint", card=card, config="benchmark_fbas(256, core=34)", runs=ck_rows,
               checker="checkpoint-resumed note on every resumed certificate")

    t = timing["bench256_34"]
    return {
        "name": "bitset_sweep_cuda",
        "route": "cuda",
        "source": f"{PORT}/kernels/csrc/bitset_sweep.cu",
        "replaces": "quorum_intersection_tpu/backends/tpu/kernels.py:664",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "k1_ms_same_window": t["k1_ms"],
        "parent_ms_same_window": t.get("parent_ms"),
        "instance_by_shape": {label: row["instance"] for label, row in timing.items()},
        "main_path_device_ms": main_device_ms,
        "main_path_device_ms_of": "bitset_route, benchmark_fbas(256, core=34) under QI_SWEEP_ENGINE=bitset",
    }


def load_trace(path):
    """A trace-event file as Perfetto loads it (the array is left open)."""
    text = pathlib.Path(path).read_text().strip()
    if text.endswith(","):
        text = text[:-1]
    if not text.endswith("]"):
        text += "]"
    return {"traceEvents": json.loads(text)}


def stderr_stats(err: str) -> dict:
    """The ``[stats] key: value`` lines ``--timing`` prints, as text."""
    return dict(line[len("[stats] "):].split(": ", 1) for line in err.splitlines() if line.startswith("[stats] "))


def observe_phase(device, card, texts, manifest, cert_jobs, work, beside=None):
    """Phase observe: the CLI's observability flags on the card, then the
    JSONL sink's cost on the full-width solve, in turns.  ``beside``: other
    CLI processes (``{name: (args, stdin, env)}``, phase faults') started in
    the same wave; returns their ``{name: (stdout, stderr, code, seconds)}``."""
    from statistics import median

    from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import sweep_fused
    from quorum_intersection_tpu_torch.pipeline import solve
    from quorum_intersection_tpu_torch.utils import telemetry

    t0 = time.perf_counter()
    keys, cmds, inputs = [], [], []
    for name in ("snapshot_correct.json", "snapshot_broken.json"):
        for backend in ("gpu-sweep", "auto"):
            stem = work / f"observe-{backend}-{name[:-5]}"
            files = {k: pathlib.Path(f"{stem}.{k}") for k in ("jsonl", "prom", "trace.json", "cert.json")}
            cmds.append([sys.executable, "-m", PORT, "--backend", backend, "--timing",
                         "--metrics-json", str(files["jsonl"]), "--metrics-prom", str(files["prom"]),
                         "--trace-out", str(files["trace.json"]), "--cert-out", str(files["cert.json"])])
            keys.append((name, backend, files))
            inputs.append(texts[name])
    beside = beside or {}
    runs = run_all(cmds + [[sys.executable, "-m", PORT, *args] for args, _, _ in beside.values()],
                   inputs=inputs + [text for _, text, _ in beside.values()],
                   envs=[None] * len(cmds) + [env for _, _, env in beside.values()],
                   parallel=len(cmds) + len(beside))
    beside_runs = dict(zip(beside, runs[len(cmds):]))
    runs = runs[:len(cmds)]
    reports = run_all([[sys.executable, str(ROOT / "tools" / "metrics_report.py"), str(files["jsonl"]),
                        "--windows", "4"] for _, _, files in keys])
    rows = []
    for (name, backend, files), (so, se, rc, secs), (rso, rse, rrc, _) in zip(keys, runs, reports):
        label = f"{backend} {name}"
        want = manifest[name]["verdict"]
        if so.strip() != ("true" if want else "false") or rc != (0 if want else 1):
            fail("observe", f"{label}: printed {so[-40:]!r} exit {rc}; stderr {se[-600:]!r}")
        err = se.splitlines()
        legacy = [i for i, ln in enumerate(err) if ln.startswith(("[timing]", "[stats]"))]
        telem = [i for i, ln in enumerate(err) if ln.startswith("[telemetry]")]
        if not legacy or not telem or max(legacy) > min(telem):
            fail("observe", f"{label}: --timing lines out of order")
        lines = [json.loads(ln) for ln in files["jsonl"].read_text().splitlines()]
        if lines[0].get("schema") != "qi-telemetry/1":
            fail("observe", f"{label}: the JSONL does not open with its meta line")
        if rrc != 0 or "per-phase spans" not in rso:
            fail("observe", f"{label}: tools/metrics_report.py exit {rrc} {rse[-300:]!r}")
        counters = {ln["name"]: ln["value"] for ln in lines if ln["kind"] == "counter"}
        windows = [ln["attrs"]["candidates"] for ln in lines if ln["kind"] == "event" and ln["name"] == "sweep.window"]
        cert = json.loads(files["cert.json"].read_text())
        cert_jobs.append((f"observe/{label}", texts[name], cert))
        answered_by = cert["provenance"]["backend"]
        ledger = (cert.get("coverage") or {"sccs": [{}]})["sccs"][0].get("windows_enumerated")
        if answered_by == "gpu-sweep":
            if sum(windows) != counters.get("cert.windows_enumerated") or not windows:
                fail("observe", f"{label}: sweep.window candidates {sum(windows)} != cert.windows_enumerated "
                                f"{counters.get('cert.windows_enumerated')}")
            if ledger is not None and ledger != sum(windows):
                fail("observe", f"{label}: the certificate's ledger {ledger} != the windows' {sum(windows)}")
        trace = load_trace(files["trace.json"])
        spans = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
        if not {"phase.parse", "phase.scc"} <= spans:
            fail("observe", f"{label}: the Chrome trace lacks the phase spans ({sorted(spans)[:8]})")
        prom = files["prom"].read_text()
        missing = [c for c in counters if f"qi_{''.join(ch if ch.isalnum() else '_' for ch in c)} " not in prom]
        if missing:
            fail("observe", f"{label}: counters missing from the Prometheus file: {missing}")
        rows.append({"run": label, "exit": rc, "process_s": secs, "answered_by": answered_by,
                     "sweep_windows": len(windows), "windows_enumerated": counters.get("cert.windows_enumerated"),
                     "ledger": ledger, "trace_events": len(trace["traceEvents"]),
                     "trace_tids": len({e.get("tid") for e in trace["traceEvents"] if e.get("ph") == "X"}),
                     "jsonl_lines": len(lines), "prom_lines": len(prom.splitlines())})

    # The JSONL sink's cost on the hot path: the full-width twin, warm, in
    # one process, without and with a sink in turns.
    full = json.dumps(synth.benchmark_fbas(256, 34))
    solve(full, backend=GpuSweepBackend())
    turns = {"without": [], "with": []}
    events = []
    sweep_fused.launches = 0
    for arm in ("without", "with", "with", "without", "without", "with"):
        rec = telemetry.reset_run_record()
        if arm == "with":
            rec.add_sink(telemetry.JsonlSink(str(work / f"overhead-{len(turns['with'])}.jsonl")))
        t = time.perf_counter()
        res = solve(full, backend=GpuSweepBackend())
        turns[arm].append(time.perf_counter() - t)
        if not res.intersects:
            fail("observe", "the full-width correct twin did not intersect")
        events.append(sum(1 for ev in rec.events if ev["name"] == "sweep.window"))
        rec.finish()
    launches = sweep_fused.launches
    telemetry.reset_run_record()
    if launches < 1:
        fail("observe", "the full-width solves never launched sweep_fused_cuda")
    phase_line("observe", card=card, seconds=round(time.perf_counter() - t0, 3), cli=rows,
               overhead={"config": "benchmark_fbas(256, core=34), 2^33 candidates, warm, one process",
                         "without_s": turns["without"], "with_s": turns["with"],
                         "median_without_s": median(turns["without"]), "median_with_s": median(turns["with"]),
                         "sweep_window_events_per_solve": sorted(set(events))},
               launches={"sweep_fused_cuda": launches})
    return beside_runs


PREEMPT_AT = 33  # phase faults: the sweep.window hit a 2^30 sweep is preempted at


def faults_cli_jobs(texts, work):
    """Phase faults' CLI processes, one for each way a fired fault ends a
    process: ``{point: (args, stdin, env)}`` (a failed solve:
    ``sweep.dispatch``; a host fault that becomes a counter:
    ``checkpoint.write``, ``cert.write``)."""
    import os

    base_env = dict(os.environ)
    for var in ("QI_FAULTS", "QI_SWEEP_ENGINE", "QI_SWEEP_PRUNE"):
        base_env.pop(var, None)
    snapshot = texts["snapshot_correct.json"]
    jobs = {"sweep.dispatch": (["--backend", "gpu-sweep"], snapshot, dict(base_env, QI_FAULTS="sweep.dispatch=error"))}
    # Host-only points: the verdict and exit code stand, the counter rises.
    for point in ("checkpoint.write", "cert.write"):
        stem = work / f"fault-{point}"
        jobs[point] = (["--backend", "gpu-sweep", "--checkpoint", f"{stem}.ckpt", "--cert-out", f"{stem}.cert",
                        "--metrics-json", f"{stem}.jsonl"], snapshot, dict(base_env, QI_FAULTS=f"{point}=oserror"))
    return jobs


def faults_phase(device, card, texts, cert_jobs, work, out):
    """Phase faults: the results ``out`` of ``faults_cli_jobs``' processes
    (run in phase observe's wave); the other card points and a preempted
    2^30 sweep's resume fire in this process through the same fault
    points."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_faults_cases import late_hit_fbas

    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.pipeline import solve
    from quorum_intersection_tpu_torch.utils import faults
    from quorum_intersection_tpu_torch.utils.checkpoint import SweepCheckpoint

    t0 = time.perf_counter()
    snapshot = texts["snapshot_correct.json"]
    rows = {}
    so, se, rc, secs = out["sweep.dispatch"]
    if rc == 0 or so.strip() or "sweep.dispatch" not in se or "FaultInjected" not in se:
        fail("faults", f"sweep.dispatch: exit {rc}, stdout {so[-40:]!r} (a quiet degrade prints a verdict); "
                       f"stderr {se[-400:]!r}")
    rows["sweep.dispatch"] = {"exit": rc, "stdout": so, "process_s": secs}
    for point, counter in (("checkpoint.write", "checkpoint.save_errors"), ("cert.write", "cert.write_errors")):
        so, se, rc, secs = out[point]
        stem = work / f"fault-{point}"
        lines = [json.loads(ln) for ln in pathlib.Path(f"{stem}.jsonl").read_text().splitlines()]
        counters = {ln["name"]: ln["value"] for ln in lines if ln["kind"] == "counter"}
        if rc != 0 or so.strip() != "true" or counters.get(counter, 0) < 1 or counters.get("faults.injected", 0) < 1:
            fail("faults", f"{point}: exit {rc}, stdout {so!r}, {counter} {counters.get(counter)}; {se[-300:]!r}")
        rows[point] = {"exit": rc, "stdout": so.strip(), counter: counters[counter], "process_s": secs}

    def fired(spec, run):
        """``run`` under the plan ``spec``: the injected fault it raised."""
        faults.install_plan(faults.parse_faults(spec))
        try:
            run()
        except faults.FaultInjected as exc:
            return exc
        finally:
            faults.clear_plan()
        return None

    in_process = {
        "sweep.compile": lambda: solve(snapshot, backend=GpuSweepBackend()),
        "sweep.bitset": lambda: solve(snapshot, backend=GpuSweepBackend(engine="bitset")),
        "sweep.prune": lambda: solve(snapshot, backend=GpuSweepBackend(prune=True)),
        "frontier.chunk": lambda: solve(snapshot, backend=GpuFrontierBackend()),
    }
    for point, run in in_process.items():
        exc = fired(f"{point}=error", run)
        if exc is None or point not in str(exc):
            fail("faults", f"{point}: the solve did not fail with the injected fault ({exc!r})")
        rows[point] = {"raised": type(exc).__name__, "in_process": True}
    # Preempted at the 33rd window of a 2^30 sweep (1 of 33 drained), with
    # a checkpoint; resumed by a fresh backend; the same sweep uninterrupted.
    twins = {"benchmark_fbas(256,core=31)": json.dumps(synth.benchmark_fbas(256, 31)),
             "late_hit_fbas(29)": json.dumps(late_hit_fbas(29))}
    resumes = []
    for label, text in twins.items():
        t = time.perf_counter()
        plain = solve(text, backend=GpuSweepBackend())
        plain_s = time.perf_counter() - t
        ckpt = work / f"preempt-{label}.ckpt"
        exc = fired(f"sweep.window=preempt@{PREEMPT_AT}", lambda: solve(text, backend=GpuSweepBackend(
            checkpoint=SweepCheckpoint(ckpt))))
        if not isinstance(exc, faults.FaultPreempted) or not ckpt.exists():
            fail("faults", f"preempt {label}: {exc!r}, checkpoint written: {ckpt.exists()}")
        recorded = json.loads(ckpt.read_text())["position"]
        t = time.perf_counter()
        resumed = solve(text, backend=GpuSweepBackend(checkpoint=SweepCheckpoint(ckpt)))
        resumed_s = time.perf_counter() - t
        if not (recorded > 0 and resumed.stats.get("resumed_from") == recorded
                and resumed.intersects is plain.intersects
                and resumed.stats.get("hit_index") == plain.stats.get("hit_index") and not ckpt.exists()):
            fail("faults", f"resume {label}: recorded {recorded}, resumed {resumed.stats.get('resumed_from')}, "
                           f"{resumed.intersects} against {plain.intersects}, hit {resumed.stats.get('hit_index')} "
                           f"against {plain.stats.get('hit_index')}")
        cert_jobs.append((f"faults/resumed {label}", text, resumed.cert))
        resumes.append({"network": label, "recorded_position": recorded, "verdict": resumed.intersects,
                        "hit_index": resumed.stats.get("hit_index"),
                        "uninterrupted_hit_index": plain.stats.get("hit_index"),
                        "resumed_s": resumed_s, "uninterrupted_s": plain_s})
    phase_line("faults", card=card, seconds=round(time.perf_counter() - t0, 3), fired=rows, preempt=resumes)


def query_phase(device, card, texts, cert_jobs, work):
    """Phase query: the query subcommand on the card against ``--device
    cpu``: one process on the card for each kind and backend (relaxed, the
    what-if under gpu-sweep and auto, the four analytics metrics), the
    relaxed intersecting twin in this process on the card; every CPU run in
    this process."""
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.kernels.packed_cuda import packed_sweep_bitset, packed_sweep_dense
    from quorum_intersection_tpu_torch.query import Query, QueryEngine, mask_nodes, query_main

    t0 = time.perf_counter()
    snapshot = texts["snapshot_correct.json"]
    # (label, the card's flags, the CPU run's flags, stdin, a process on the
    # card).  The CPU run of a what-if takes the native oracle (the plain
    # sweep of its variants would take the CPU most of an hour); the
    # analytics run on nested_correct (a splitting-set search of the
    # snapshot's 21-node SCC is 232 host solves, minutes a run).
    nested = texts["nested_correct.json"]
    jobs = []
    for broken in (True, False):
        fa, fb = synth.two_family_preset(broken=broken)
        fb_file = work / f"family_b-{broken}.json"
        fb_file.write_text(json.dumps(fb))
        args = ["--kind", "relaxed", "--family-b", str(fb_file)]
        jobs.append((f"relaxed two_family_preset(broken={broken})", args, args, json.dumps(fa), broken))
    # Both what-ifs remove nested_correct's 15 nodes one at a time (16
    # variants): under gpu-sweep they lane-pack, under auto each races alone.
    # The snapshot's default 16 candidates two at a time (137 variants) run
    # in process below, K3's launches counted.
    whatif = ["--kind", "whatif", "--max-k", "1"]
    jobs.append(("whatif max_k 1 gpu-sweep nested_correct", whatif + ["--backend", "gpu-sweep"],
                 whatif + ["--backend", "cpp"], nested, True))
    jobs.append(("whatif max_k 1 auto nested_correct", whatif, whatif + ["--backend", "cpp"], nested, True))
    for metric in ("top_tier", "blocking_set", "splitting_set", "pagerank"):
        args = ["--kind", "analytics", "--metric", metric]
        jobs.append((f"analytics {metric} nested_correct", args, args, nested, True))
    cmds, inputs, index = [], [], {}
    for i, (label, args, cpu_args, text, process) in enumerate(jobs):
        if process:
            index[i] = len(cmds)
            cmds.append([sys.executable, "-m", PORT, "query", *args, "--device", "cuda",
                         "--cert-out", str(work / f"query{i}-cuda.json")])
            inputs.append(text)
    t = time.perf_counter()
    runs = run_all(cmds, inputs=inputs, parallel=len(cmds))
    process_wall = time.perf_counter() - t
    rows = []
    for i, (label, args, cpu_args, text, process) in enumerate(jobs):
        if process:
            so, se, rc, secs = runs[index[i]]
        else:
            t = time.perf_counter()
            so, se, rc = in_process(query_main, [*args, "--device", "cuda", "--cert-out",
                                                 str(work / f"query{i}-cuda.json")], text)
            secs = time.perf_counter() - t
        t = time.perf_counter()
        cso, cse, crc = in_process(query_main, [*cpu_args, "--device", "cpu"], text)
        csecs = time.perf_counter() - t
        try:
            line, cpu_line = json.loads(so), json.loads(cso)
        except json.JSONDecodeError:
            fail("query", f"{label}: no result line (exit {rc}/{crc}); {se[-400:]!r} {cse[-200:]!r}")
        failing = line["result"].pop("failing_cert", None)
        cpu_line["result"].pop("failing_cert", None)
        if (line, rc) != (cpu_line, crc) or "error" in line:
            fail("query", f"{label}: the card's {so[:300]!r} (exit {rc}) != the CPU's {cso[:300]!r} (exit {crc})")
        cert = json.loads((work / f"query{i}-cuda.json").read_text())
        cert_jobs.append((f"query/{label}", text, cert))
        if failing is not None:
            masked = mask_nodes(json.loads(text), line["result"]["minimal_failing"])
            cert_jobs.append((f"query/{label} failing variant", json.dumps(masked), failing))
        rows.append({"query": label, "verdict": line["verdict"], "exit": rc, "card_s": secs, "cpu_s": csecs,
                     "card_process": process,
                     **({"variants": line["result"]["variants"], "minimal_failing": line["result"]["minimal_failing"]}
                        if line["kind"] == "whatif" else {})})
    # The what-if query in process with the launch counts reset before and
    # read after: under gpu-sweep its variants lane-pack through K3.
    packed_sweep_dense.launches = packed_sweep_bitset.launches = 0
    t = time.perf_counter()
    out = QueryEngine(backend="gpu-sweep").resolve(json.loads(snapshot), Query.parse({"kind": "whatif", "max_k": 2}))
    in_process_s = time.perf_counter() - t
    launches = {"packed_sweep_dense_cuda": packed_sweep_dense.launches,
                "packed_sweep_bitset_cuda": packed_sweep_bitset.launches}
    if launches["packed_sweep_dense_cuda"] < 1:
        fail("query", "the what-if query under gpu-sweep never launched packed_sweep_dense_cuda")
    if out.result["minimal_failing"] is not None or out.verdict is not True:
        fail("query", f"the in-process what-if of 137 variants: {out.verdict}, {out.result['minimal_failing']}")
    phase_line("query", card=card, seconds=round(time.perf_counter() - t0, 3), runs=rows,
               process_wall_s=process_wall,
               whatif_in_process={"seconds": in_process_s, "variants": out.result["variants"],
                                  "launches": launches})


DELTA_TRACES = (
    # (label, snapshots a step, backend, churn_trace_steps arguments); the base
    # is built in delta_phase.
    ("dump_scale_correct", "auto", {"steps": 16, "seed": 3, "max_diff": 2}),
    ("benchmark_fbas(256,core=34)", "gpu-sweep", {"steps": 8, "seed": 5}),
    ("hierarchical_fbas(8,4)", "gpu-frontier", {"steps": 4, "seed": 6}),
)


def delta_ground_truth(metas, scratch) -> int:
    """Backend solves an incremental engine must make on a churn trace: the
    cold first solve plus every step whose predecessor's target SCC the
    generator's metas mark as affected (a step decided by the SCC guard
    solves nothing; a predecessor without a single target counts as
    affected)."""
    solves = 0
    for k, res in enumerate(scratch):
        if len(res.quorum_scc_ids) != 1:
            continue
        prev = scratch[k - 1] if k else None
        if prev is None or len(prev.quorum_scc_ids) != 1 or prev.quorum_scc_ids[0] in metas[k - 1]["affected_scc_ids"]:
            solves += 1
    return solves


def delta_phase(device, card, texts, cert_jobs, work):
    """Phase delta: incremental re-analysis on the card.  Each churn trace
    goes through one ``DeltaEngine`` (one store), a snapshot a call, and the
    same snapshots through ``check_many`` from scratch, in turns; then one
    batch of a trace twice over; then two faults.  Returns the incremental
    path's kernel launches."""
    from collections import Counter
    from statistics import median

    from quorum_intersection_tpu_torch.delta import DeltaEngine, SccVerdictStore
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.kernels import frontier_cuda
    from quorum_intersection_tpu_torch.kernels.bitset_sweep_cuda import bitset_sweep
    from quorum_intersection_tpu_torch.kernels.packed_cuda import packed_sweep_bitset, packed_sweep_dense
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import sweep_fused
    from quorum_intersection_tpu_torch.pipeline import check_many
    from quorum_intersection_tpu_torch.utils import faults, telemetry
    from quorum_intersection_tpu_torch.utils.faults import FaultInjected

    t0 = time.perf_counter()
    wrappers = {"sweep_fused_cuda": sweep_fused, "packed_sweep_dense_cuda": packed_sweep_dense,
                "packed_sweep_bitset_cuda": packed_sweep_bitset, "bitset_sweep_cuda": bitset_sweep}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0
        for name in frontier_cuda.LAUNCHES:
            frontier_cuda.LAUNCHES[name] = 0

    def counts_now():
        counts = {name: fn.launches for name, fn in wrappers.items()}
        counts.update(frontier_chunk_cuda=frontier_cuda.LAUNCHES["frontier_chunk"],
                      frontier_filter_cuda=frontier_cuda.LAUNCHES["frontier_filter"])
        return counts

    def witness(res):
        return None if res.intersects else sorted(sorted(q) for q in (res.q1 or [], res.q2 or []))

    def arm_call(rec, fn):
        """One call with the launch counts set to 0 just before and read just
        after: (results, seconds, launches, sweep.window events)."""
        zero_counts()
        ev0 = rec.event_count()
        t = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t
        return out, secs, counts_now(), sum(1 for ev in rec.events_since(ev0) if ev["name"] == "sweep.window")

    def same(label, got, want):
        for k, (a, b) in enumerate(zip(got, want)):
            if a.intersects is not b.intersects or witness(a) != witness(b):
                fail("delta", f"{label} step {k}: incremental {a.intersects} {witness(a)} != scratch "
                              f"{b.intersects} {witness(b)}")

    def row_of(label, backend, rec, engine, truth, times, launches, windows, n):
        counters, gauges = rec.snapshot()
        solves = counters.get("delta.solves", 0)
        if solves != truth:
            fail("delta", f"{label}: {solves} backend solves, ground truth {truth}")
        return {"trace": label, "backend": backend, "snapshots": n, "solves": solves, "ground_truth": truth,
                "scans_reused": counters.get("delta.scan_hits", 0),
                "scans_fresh": counters.get("delta.scan_misses", 0),
                "compositions": counters.get("delta.compositions", 0),
                "scc_reuse_pct": gauges.get("delta.scc_reuse_pct"), "reuse_pct": engine.store.reuse_pct(),
                "median_step_s": {arm: median(v) for arm, v in times.items()},
                "step_s": times, "launches": {arm: dict(c) for arm, c in launches.items()},
                "sweep_window_events": windows}

    bases = {
        "dump_scale_correct": json.loads(texts["dump_scale_correct.json.gz"]),
        "benchmark_fbas(256,core=34)": synth.benchmark_fbas(256, 34),
        "hierarchical_fbas(8,4)": synth.hierarchical_fbas(8, 4),
    }
    rows, delta_launches, engines = [], Counter(), {}
    for label, backend, kw in DELTA_TRACES:
        trace, metas = synth.churn_trace_steps(bases[label], **kw)
        rec = telemetry.reset_run_record()
        engine = DeltaEngine(SccVerdictStore())
        engines[label] = (engine, trace)
        inc, scratch = [], []
        times = {"incremental": [], "scratch": []}
        launches = {"incremental": Counter(), "scratch": Counter()}
        windows = {"incremental": 0, "scratch": 0}
        for k, snap in enumerate(trace):
            for arm in (("incremental", "scratch") if k % 2 == 0 else ("scratch", "incremental")):
                if arm == "incremental":
                    out, secs, counts, evs = arm_call(rec, lambda: engine.check_many([snap], backend=backend))
                else:
                    out, secs, counts, evs = arm_call(rec, lambda: check_many([snap], backend=backend))
                (inc if arm == "incremental" else scratch).append(out[0])
                times[arm].append(secs)
                launches[arm].update(counts)
                windows[arm] += evs
        same(label, inc, scratch)
        cert_jobs += [(f"delta/{label} step {k}", snap, res.cert) for k, (snap, res) in enumerate(zip(trace, inc))]
        delta_launches.update(launches["incremental"])
        rows.append(row_of(label, backend, rec, engine, delta_ground_truth(metas, scratch), times, launches,
                           windows, len(trace)))
    if delta_launches["sweep_fused_cuda"] < 1 or delta_launches["frontier_chunk_cuda"] < 1:
        fail("delta", f"the incremental path never launched K1 or K9: {dict(delta_launches)}")

    # One batch: the snapshot trace's 16 snapshots, each twice, in one call.
    trace, metas = synth.churn_trace_steps(json.loads(texts["snapshot_correct.json"]), 15, seed=3)
    batch = trace + trace
    rec = telemetry.reset_run_record()
    engine = DeltaEngine(SccVerdictStore())
    inc, inc_s, inc_counts, inc_windows = arm_call(rec, lambda: engine.check_many(batch, backend="gpu-sweep"))
    scratch, scratch_s, scratch_counts, scratch_windows = arm_call(
        rec, lambda: check_many(batch, backend="gpu-sweep"))
    same("one batch", inc, scratch)
    cert_jobs += [(f"delta/one batch {k}", snap, res.cert) for k, (snap, res) in enumerate(zip(batch, inc))]
    delta_launches.update(inc_counts)
    rows.append(row_of("snapshot_correct.json x2, one call", "gpu-sweep", rec, engine,
                       delta_ground_truth(metas, scratch[:len(trace)]),
                       {"incremental": [inc_s / len(batch)], "scratch": [scratch_s / len(batch)]},
                       {"incremental": inc_counts, "scratch": scratch_counts},
                       {"incremental": inc_windows, "scratch": scratch_windows}, len(batch)))
    rows[-1]["call_s"] = {"incremental": inc_s, "scratch": scratch_s}

    # Fault 1: sweep.dispatch inside the incremental solve of a step that
    # dirties the full-width core fails the call (no degrade); the same step
    # without the rule then solves once, equal to the scratch verdict.
    engine, trace = engines["benchmark_fbas(256,core=34)"]
    dirty = json.loads(json.dumps(trace[-1]))
    core_node = next(n for n in dirty if n["publicKey"].startswith("CORE"))
    core_node["quorumSet"]["threshold"] -= 1
    rec = telemetry.reset_run_record()
    plan = faults.install_plan(faults.parse_faults("sweep.dispatch=error"))
    try:
        engine.check_many([dirty], backend="gpu-sweep")
        fail("delta", "a sweep.dispatch fault under DeltaEngine did not fail the call")
    except FaultInjected as exc:
        if exc.point != "sweep.dispatch" or len(plan.fired) != 1 or rec.counters.get("delta.errors", 0):
            fail("delta", f"sweep.dispatch: point {exc.point}, fired {plan.fired}, "
                          f"delta.errors {rec.counters.get('delta.errors')}")
    finally:
        faults.clear_plan()
    got = engine.check_many([dirty], backend="gpu-sweep")[0]
    want = check_many([dirty], backend="gpu-sweep")[0]
    same("dirty core after the fault", [got], [want])
    if rec.counters.get("delta.solves") != 2 or got.cert["provenance"]["delta"]["resolved_sccs"] != 1:
        fail("delta", f"the dirtied core: delta.solves {rec.counters.get('delta.solves')} (2 expected)")
    cert_jobs.append(("delta/dirty core", dirty, got.cert))
    dispatch_fault = {"raised": "FaultInjected at sweep.dispatch", "fired": len(plan.fired),
                      "delta_errors": 0, "then_verdict": got.intersects, "then_resolved": 1}

    # Fault 2: delta.diff on every call degrades to the scratch verdicts.
    rec = telemetry.reset_run_record()
    faults.install_plan(faults.parse_faults("delta.diff=error@1+"))
    try:
        engine = DeltaEngine(SccVerdictStore())
        degraded = [engine.check_many([snap], backend="gpu-sweep")[0] for snap in batch[:4]]
    finally:
        faults.clear_plan()
    same("delta.diff fault", degraded, scratch[:4])
    if rec.counters.get("delta.diff_faults") != 4 or len(engine.store):
        fail("delta", f"delta.diff: {rec.counters.get('delta.diff_faults')} faults counted (4 expected), "
                      f"store size {len(engine.store)}")
    telemetry.reset_run_record()
    phase_line("delta", card=card, seconds=round(time.perf_counter() - t0, 3), traces=rows,
               faults={"sweep.dispatch": dispatch_fault,
                       "delta.diff": {"calls": 4, "delta.diff_faults": 4, "verdicts": "scratch's"}},
               incremental_launches=dict(delta_launches))
    return dict(delta_launches)


# The serve phase's launcher: the ``serve`` subcommand through the CLI's own
# entry point (``cli.main``, what ``python -m quorum_intersection_tpu_torch``
# calls), in a fresh process whose kernel launch counts start at 0; at exit it
# writes them (and, with ``--profile`` first, the device's busy ms under
# ``torch.profiler``) to stderr on one ``serve-launches`` line.
# Stream C's deadline on the 2^30 twin: past the short blocker's solve, short
# of its own pack (2^30 rows, about 0.5-1 s of K3).
SERVE_TWIN_DEADLINE_S = 0.35

SERVE_LAUNCHER = r"""
import json, sys, time
argv = sys.argv[1:]
profile = argv[:1] == ["--profile"]
argv = argv[1:] if profile else argv
from quorum_intersection_tpu_torch import cli
from quorum_intersection_tpu_torch.kernels import frontier_cuda
from quorum_intersection_tpu_torch.kernels.bitset_sweep_cuda import bitset_sweep
from quorum_intersection_tpu_torch.kernels.guard_cuda import guard_bitset, guard_dense
from quorum_intersection_tpu_torch.kernels.packed_cuda import packed_sweep_bitset, packed_sweep_dense
from quorum_intersection_tpu_torch.kernels.sweep_cuda import sweep_fused
wrappers = {"sweep_fused_cuda": sweep_fused, "packed_sweep_dense_cuda": packed_sweep_dense,
            "packed_sweep_bitset_cuda": packed_sweep_bitset, "bitset_sweep_cuda": bitset_sweep,
            "guard_dense_cuda": guard_dense, "guard_bitset_cuda": guard_bitset}
for fn in wrappers.values():
    fn.launches = 0
for name in frontier_cuda.LAUNCHES:
    frontier_cuda.LAUNCHES[name] = 0
busy = None
t0 = time.perf_counter()
if profile:
    import torch
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        rc = cli.main(["serve"] + argv)
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()) / 1e3
else:
    rc = cli.main(["serve"] + argv)
counts = {name: fn.launches for name, fn in wrappers.items()}
counts.update(frontier_chunk_cuda=frontier_cuda.LAUNCHES["frontier_chunk"],
              frontier_filter_cuda=frontier_cuda.LAUNCHES["frontier_filter"])
sys.stderr.write("serve-launches " + json.dumps({"launches": counts, "serve_s": time.perf_counter() - t0,
                                                  "device_busy_ms": busy}) + "\n")
sys.exit(rc)
"""


def serve_run(args, lines, env=None, kill_after_first=False, timeout=600, profile=False, launcher=None):
    """One ``serve`` process through ``SERVE_LAUNCHER`` on the card: every
    request line written to its stdin (on a thread of its own; a ``None``
    among the lines holds the rest until the first response has arrived, an
    ``("after", request_id)`` until that request's response has),
    every response line read with its arrival time.  ``kill_after_first``:
    SIGKILL it the moment the first response arrives.  Returns a dict: the
    response objects, arrival seconds from the process's start, the return
    code, the wall, stderr, and the launcher's record (launches, busy ms).
    ``launcher``: another command line to run instead (``args`` follow it)."""
    import os
    import signal
    import threading

    cmd = (list(launcher) if launcher is not None
           else [sys.executable, "-c", SERVE_LAUNCHER] + (["--profile"] if profile else [])) + list(args)
    full_env = {**os.environ, **(env or {})}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=full_env)
    err_chunks = []
    first_seen = threading.Event()
    answered = {}

    def feed():
        try:
            for line in lines:
                if line is None:
                    proc.stdin.flush()
                    first_seen.wait(120)
                    continue
                if isinstance(line, tuple):
                    proc.stdin.flush()
                    answered.setdefault(line[1], threading.Event()).wait(300)
                    continue
                proc.stdin.write(line + "\n")
            proc.stdin.close()
        except (BrokenPipeError, OSError):
            pass

    def drain_err():
        err_chunks.append(proc.stderr.read())

    threads = [threading.Thread(target=feed), threading.Thread(target=drain_err)]
    for th in threads:
        th.start()
    killer = threading.Timer(timeout, proc.kill)
    killer.start()
    out, times = [], []
    try:
        for raw in proc.stdout:
            try:
                obj = json.loads(raw)
            except json.JSONDecodeError:
                continue  # a line torn by the kill
            out.append(obj)
            times.append(time.perf_counter() - t0)
            if "verdict" in obj or "error" in obj:
                first_seen.set()
                answered.setdefault(obj.get("request_id"), threading.Event()).set()
            if kill_after_first and ("verdict" in obj or "error" in obj):
                os.kill(proc.pid, signal.SIGKILL)
                break
        proc.wait(timeout=timeout)
    finally:
        first_seen.set()
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for th in threads:
            th.join(60)
    err = "".join(err_chunks)
    record = None
    for line in err.splitlines():
        if line.startswith("serve-launches "):
            record = json.loads(line[len("serve-launches "):])
    return {"responses": out, "times": times, "rc": proc.returncode, "wall": time.perf_counter() - t0,
            "stderr": err, "record": record}


def serve_stream_stats(run, n_requests):
    """Requests, wall, requests per second, p50 / p99 of the responses'
    ``seconds`` field, seconds from process start to the first response."""
    from statistics import quantiles

    answered = [r for r in run["responses"] if "verdict" in r or "error" in r]
    secs = sorted(r["seconds"] for r in answered if "seconds" in r)
    p50 = secs[len(secs) // 2] if secs else None
    p99 = quantiles(secs, n=100)[98] if len(secs) >= 2 else (secs[0] if secs else None)
    first = next((t for r, t in zip(run["responses"], run["times"]) if "verdict" in r or "error" in r), None)
    return {"requests": n_requests, "answered": len(answered), "wall_s": run["wall"],
            "requests_per_s": n_requests / run["wall"], "p50_s": p50, "p99_s": p99,
            "first_response_s": first,
            "launches": (run["record"] or {}).get("launches")}


def metrics_of(path):
    """The final counters, gauges and tenant table of a ``--metrics-json``
    stream."""
    counters, gauges, tenants = {}, {}, {}
    for line in pathlib.Path(path).read_text().splitlines():
        obj = json.loads(line)
        if obj.get("kind") == "counter":
            counters[obj["name"]] = obj["value"]
        elif obj.get("kind") == "gauge":
            gauges[obj["name"]] = obj["value"]
        elif obj.get("kind") == "tenants":
            tenants = obj["tenants"]
    return counters, gauges, tenants


def serve_phase(device, card, texts, manifest, cert_jobs, work):
    """Phase serve: the ``serve`` subcommand as a process on the card, four
    streams (the default server; fused against unfused in turns; a deadline
    inside a pack; a kill and replay, and two faults).  Returns the serve
    path's kernel launches."""
    import threading
    from collections import Counter

    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.pipeline import check_many

    t0 = time.perf_counter()
    launches = Counter()
    streams = {}

    def req(rid, src, client, **extra):
        return json.dumps({"request_id": rid, "nodes": json.loads(raw_json(src)), "client": client, **extra})

    def answered(run, label):
        if run["rc"] != 0:
            fail("serve", f"{label}: exit {run['rc']}: {run['stderr'][-1500:]}")
        if run["record"] is None:
            fail("serve", f"{label}: no launch record: {run['stderr'][-1500:]}")
        launches.update(run["record"]["launches"])
        return {r["request_id"]: r for r in run["responses"] if "request_id" in r}

    def witness(res):
        w = res.get("cert", {}).get("witness") if isinstance(res, dict) else None
        return None if w is None else sorted(sorted(q) for q in (w["q1"], w["q2"]))

    # -- Stream A: the default server (auto, delta on, certificates) -------
    dump = json.loads(texts["dump_scale_correct.json.gz"])
    dump_trace, _ = synth.churn_trace_steps(dump, 8, seed=3, max_diff=2)
    snap_trace, _ = synth.churn_trace_steps(json.loads(texts["snapshot_correct.json"]), 8, seed=3)
    fixtures = [(name, texts[name]) for name in manifest]
    plan = []  # (request id, source, expected verdict or None for the scratch solve's)
    for k in range(max(len(dump_trace), len(snap_trace))):
        if k < len(dump_trace):
            plan.append((f"dump-{k}", dump_trace[k], None))
        if k < len(snap_trace):
            plan.append((f"snap-{k}", snap_trace[k], None))
        if k < len(fixtures):
            plan.append((f"fix-{fixtures[k][0]}", fixtures[k][1], manifest[fixtures[k][0]]["verdict"]))
    plan += [(f"fix-again-{name}", text, manifest[name]["verdict"]) for name, text in fixtures]
    clients = ("explorer", "validator-ops", "researcher")
    lines_a = [req(rid, src, clients[i % 3]) for i, (rid, src, _) in enumerate(plan)]
    # The churn steps' verdicts: the scratch check_many on the card.
    scratch = {}
    for label, trace in (("dump", dump_trace), ("snap", snap_trace)):
        for k, res in enumerate(check_many(trace, backend="gpu-sweep")):
            scratch[f"{label}-{k}"] = res
    metrics_a = work / "serve_a.jsonl"
    run = serve_run(["--backend", "auto", "--emit-certs", "--metrics-json", str(metrics_a)], lines_a)
    got = answered(run, "stream A")
    for rid, src, want in plan:
        r = got.get(rid)
        if r is None or "verdict" not in r:
            fail("serve", f"stream A: {rid} answered {r and r.get('error')}")
        expect = want if want is not None else scratch[rid].intersects
        if r["verdict"] is not expect:
            fail("serve", f"stream A: {rid} verdict {r['verdict']}, expected {expect}")
        if want is None and not scratch[rid].intersects:
            if witness(r) != sorted(sorted(scratch[rid].cert["witness"][q]) for q in ("q1", "q2")):
                fail("serve", f"stream A: {rid} witness differs from the scratch solve's")
        if r.get("cert") and not r["cached"]:
            cert_jobs.append((f"serve/A {rid}", src, r["cert"]))
    counters_a, gauges_a, tenants_a = metrics_of(metrics_a)
    streams["A"] = {**serve_stream_stats(run, len(lines_a)), "backend": "auto",
                    "cached": sum(1 for r in got.values() if r.get("cached")),
                    "delta_compositions": counters_a.get("delta.compositions"),
                    "delta_scc_reuse_pct": gauges_a.get("delta.scc_reuse_pct"),
                    "tenants": {c: row["requests"] for c, row in tenants_a.items()}}

    # -- Stream B: fused against unfused, in turns --------------------------
    sources = batch_sources(list(manifest))
    first = next(i for i, (label, _, _) in enumerate(sources) if label == "benchmark_fbas(256,core=31,broken=False)")
    sources = [sources[first]] + sources[:first] + sources[first + 1:]  # a long solve first: the rest queue
    lines_b = [req(f"b{i}", src, f"tenant-{i % 4}") for i, (_, src, _) in enumerate(sources)]
    want_b = check_many([src for _, src, _ in sources], backend="gpu-sweep")
    turns, results_b, counters_b = [], {}, {}
    # One fused run, under the profiler (an unfused drain serves streams A,
    # C's faults and D); every answer held to check_many's.
    for turn, window in enumerate(("5",)):
        path = work / f"serve_b{turn}.jsonl"
        run = serve_run(["--backend", "gpu-sweep", "--emit-certs", "--batch-max", "16", "--metrics-json", str(path)],
                        lines_b, env={"QI_SERVE_FUSE_WINDOW_MS": window}, profile=True)
        got = answered(run, f"stream B turn {turn}")
        counters, gauges, tenants = metrics_of(path)
        for i, ((label, src, expect), want) in enumerate(zip(sources, want_b)):
            r = got.get(f"b{i}")
            if r is None or r.get("verdict") is not expect or r["verdict"] is not want.intersects:
                fail("serve", f"stream B turn {turn}: {label} answered {r and (r.get('verdict'), r.get('error'))}, "
                              f"expected {expect}")
            if r["stats"].get("hit_index") != want.stats.get("hit_index"):
                fail("serve", f"stream B turn {turn}: {label} hit index {r['stats'].get('hit_index')} != "
                              f"check_many's {want.stats.get('hit_index')}")
            if not want.intersects and witness(r) != sorted(sorted(want.cert["witness"][q]) for q in ("q1", "q2")):
                fail("serve", f"stream B turn {turn}: {label} witness differs from check_many's")
        # Cost conservation: a packed request books lanes x the pack's rows,
        # the packs of one shape and row count hold a whole number of lane
        # tiles between them, and the solves' lane-windows together are the
        # device work the process counted; the tenant rows sum to the
        # requests'.  Requests of one fingerprint share one solve (the
        # snapshot fixtures are stellar_like_fbas(7, 3, seed=0) and its broken
        # twin), each rider booking it too: the solves are counted once.
        solves = {r["cert"]["provenance"]["serve"]["fingerprint"]: (rid, r) for rid, r in sorted(got.items())}
        packs = {}
        for rid, r in solves.values():
            st, cost = r.get("stats") or {}, r.get("cost")
            if not (st.get("packed") and cost and not cost.get("reused")):
                continue
            if cost["windows"] != st["pack_rows_dispatched"] or cost["lane_windows"] != cost["lanes"] * cost["windows"]:
                fail("serve", f"stream B turn {turn}: {rid} books {cost} in a pack of {st['pack_rows_dispatched']} rows")
            key = (st["pack_rows_dispatched"], st["pack_shape"][0])
            packs.setdefault(key, []).append((rid, int(cost["lanes"]), cost["groups"], st["pack_jobs"],
                                              st["pack_groups"], st["pack_slot"], st["pack_seconds"]))
        for (rows, n), members in packs.items():
            if sum(m[1] for m in members) % n:
                fail("serve", f"stream B turn {turn}: packs of {n} lanes x {rows} rows hold "
                              f"{sum(m[1] for m in members)} booked lanes: (request, lanes, groups, pack_jobs, "
                              f"pack_groups, pack_slot, pack_seconds) {members}")
        solved = sum(int(r["cost"]["lane_windows"]) for _, r in solves.values() if r.get("cost"))
        if solved != counters.get("cost.lane_windows_total"):
            fail("serve", f"stream B turn {turn}: the solves book {solved} lane-windows, the process counted "
                          f"{counters.get('cost.lane_windows_total')}")
        booked = sum(int(r["cost"]["lane_windows"]) for r in got.values() if r.get("cost"))
        if counters.get("cost.lane_windows_attributed") != counters.get("cost.lane_windows_total"):
            fail("serve", f"stream B turn {turn}: attributed {counters.get('cost.lane_windows_attributed')} != "
                          f"total {counters.get('cost.lane_windows_total')}")
        if sum(int(row["lane_windows"]) for row in tenants.values()) != booked:
            fail("serve", f"stream B turn {turn}: the tenant table books "
                          f"{sum(int(row['lane_windows']) for row in tenants.values())}, the requests {booked}")
        if window != "0" and (counters.get("fuse.packs_formed", 0) < 1 or counters.get("fuse.cross_request_lanes", 0) <= 0):
            fail("serve", f"stream B turn {turn}: no cross-request pack formed: {counters}")
        arm = "fused" if window != "0" else "unfused"
        if arm in results_b:
            for rid, r in got.items():
                if (r.get("verdict"), witness(r)) != (results_b[arm][rid].get("verdict"), witness(results_b[arm][rid])):
                    fail("serve", f"stream B: {rid} differs between two {arm} runs")
        results_b[arm] = got
        counters_b[arm] = counters
        turns.append({"arm": arm, **serve_stream_stats(run, len(lines_b)),
                      "packs_formed": counters.get("fuse.packs_formed", 0),
                      "cross_request_lanes": counters.get("fuse.cross_request_lanes", 0),
                      "fill_pct": gauges.get("fuse.fill_pct"), "solves": len(solves),
                      "pack_shapes": {f"{n}x{rows}": len(v) for (rows, n), v in packs.items()},
                      "lane_windows_total": counters.get("cost.lane_windows_total")})
    for i, (label, src, _) in enumerate(sources):
        cert_jobs.append((f"serve/B fused {label}", src, results_b["fused"][f"b{i}"]["cert"]))
    busy = run["record"].get("device_busy_ms") or 0.0
    streams["B"] = {"turns": turns, "profiled_fused": {
        "device_busy_ms": busy, "serve_s": run["record"]["serve_s"],
        "device_idle_share": 1 - busy / (run["record"]["serve_s"] * 1e3) if busy > 0
        else "not measured (no device events)"}}

    # -- Stream C: a deadline inside a pack; Stream D's faults, at once ------
    # C: a warm request (the CUDA context and kernel libraries come up), then,
    # once it is answered, a short blocker (2^27 rows) during whose solve the
    # 2^30 twin and three small requests queue; they drain as one batch and
    # fuse into one pack, where the twin's deadline fires.
    # 48 nodes: the batch former estimates lanes by node count, and a 256-node
    # twin would fill the tile alone and flush alone.
    twin = synth.benchmark_fbas(48, 31)
    small = [synth.majority_fbas(9, prefix="SA"), synth.majority_fbas(11, prefix="SB"),
             synth.majority_fbas(12, broken=True, prefix="SC")]
    lines_c = [req("warm", synth.majority_fbas(7, prefix="W"), "ops"), None,
               req("blocker", synth.benchmark_fbas(256, 28), "ops"),
               req("twin-deadline", twin, "ops", deadline_s=SERVE_TWIN_DEADLINE_S)]
    lines_c += [req(f"small-{i}", s, "ops") for i, s in enumerate(small)]
    metrics_c = work / "serve_c.jsonl"
    lines_dispatch = [req("faulted", synth.majority_fbas(13, prefix="F"), "ops")]
    lines_drain = [req(f"drain-{i}", s, "ops") for i, s in enumerate(small)]
    cmds = [["--backend", "gpu-sweep", "--emit-certs", "--metrics-json", str(metrics_c)], ["--backend", "gpu-sweep"],
            ["--backend", "gpu-sweep", "--emit-certs", "--batch-max", "16"]]
    envs = [{"QI_SERVE_FUSE_WINDOW_MS": "5"}, {"QI_FAULTS": "sweep.dispatch=error"},
            {"QI_FAULTS": "serve.drain=error@1"}]
    runs = [None] * 3

    def go(i, lines):
        runs[i] = serve_run(cmds[i], lines, env=envs[i])

    ths = [threading.Thread(target=go, args=(i, lines)) for i, lines in enumerate((lines_c, lines_dispatch, lines_drain))]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    got = answered(runs[0], "stream C")
    dead = got.get("twin-deadline", {})
    if dead.get("error", {}).get("code") != "deadline_exceeded":
        fail("serve", f"stream C: the 2^30 twin answered {dead}")
    small_truth = check_many(small, backend="gpu-sweep")
    copacked = []
    for i, (s, want) in enumerate(zip(small, small_truth)):
        r = got.get(f"small-{i}", {})
        if r.get("verdict") is not want.intersects or r["stats"].get("hit_index") != want.stats.get("hit_index"):
            fail("serve", f"stream C: small-{i} answered {r.get('verdict', r.get('error'))}, expected {want.intersects}")
        copacked.append({"pack_jobs": r["stats"].get("pack_jobs"), "pack_origin": r["stats"].get("pack_origin"),
                         "pack_rows_dispatched": r["stats"].get("pack_rows_dispatched")})
        cert_jobs.append((f"serve/C small-{i}", s, r["cert"]))
    counters_c, _, _ = metrics_of(metrics_c)
    cancelled = counters_c.get("cert.windows_cancelled", 0)
    if not 0 < cancelled < 1 << 30:
        fail("serve", f"stream C: the twin's deadline retired {cancelled} windows (mid-pack: between 1 and 2^30 - 1)")
    streams["C"] = {**serve_stream_stats(runs[0], len(lines_c) - 1), "twin": dead["error"],
                    "twin_windows_cancelled": cancelled, "twin_windows_swept": (1 << 30) - cancelled,
                    "copacked": copacked, "deadline_s": SERVE_TWIN_DEADLINE_S}
    got = answered(runs[1], "sweep.dispatch fault")
    faulted = got.get("faulted", {})
    if "verdict" in faulted or "sweep.dispatch" not in faulted.get("error", {}).get("message", ""):
        fail("serve", f"sweep.dispatch fault: {faulted}")
    dispatch_fault = {"faulted": faulted["error"], "rc": runs[1]["rc"]}
    got = answered(runs[2], "serve.drain fault")
    for i, (s, want) in enumerate(zip(small, small_truth)):
        r = got.get(f"drain-{i}", {})
        if r.get("verdict") is not want.intersects or not str(r["stats"].get("device", "")).startswith("cuda"):
            fail("serve", f"serve.drain fault: drain-{i} answered {r.get('verdict', r.get('error'))} on "
                          f"{r.get('stats', {}).get('device')}")
    drain_fault = {"verdicts": [got[f"drain-{i}"]["verdict"] for i in range(len(small))],
                   "devices": sorted({got[f"drain-{i}"]["stats"]["device"] for i in range(len(small))})}

    # -- Stream D: kill after the first response, replay, restart ------------
    journal = work / "serve.journal"
    full = synth.benchmark_fbas(256, 34)
    kill_plan = [("k-small-0", synth.majority_fbas(9, prefix="KA"), True),
                 ("k-small-1", synth.majority_fbas(10, broken=True, prefix="KB"), False),
                 ("k-full", full, True), ("k-small-2", synth.majority_fbas(11, prefix="KC"), True)]
    lines_d = [req(rid, s, "ops") for rid, s, _ in kill_plan]
    # The uninterrupted answers: verdict, hit index and witness of each.
    want_d = {rid: res for (rid, _, _), res in zip(kill_plan, check_many([s for _, s, _ in kill_plan],
                                                                         backend="gpu-sweep"))}
    killed = serve_run(["--backend", "gpu-sweep", "--emit-certs", "--journal", str(journal)], lines_d,
                       kill_after_first=True)
    seen = {r["request_id"]: r.get("verdict") for r in killed["responses"] if "request_id" in r}
    held_d = [r for r in killed["responses"] if "request_id" in r]
    twin_journal = work / "serve.journal.twin"
    twin_journal.write_bytes(journal.read_bytes())
    journaled = {json.loads(ln)["request_id"] for ln in journal.read_text().splitlines()
                 if ln.strip().startswith("{") and '"kind": "req"' in ln}
    # The replay and the restart read two copies of the journal: one wave.
    restart_lines = [req(rid, s, "ops") for rid, s, _ in kill_plan if seen.get(rid) is None]
    d_runs = [None, None]

    def d_go(i, args, lines):
        d_runs[i] = serve_run(args, lines)

    ths = [threading.Thread(target=d_go, args=(0, ["--backend", "gpu-sweep", "--journal", str(journal),
                                                    "--replay-only"], [])),
           threading.Thread(target=d_go, args=(1, ["--backend", "gpu-sweep", "--emit-certs", "--journal",
                                                    str(twin_journal)], restart_lines))]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    replay, restart = d_runs
    answered(replay, "stream D replay-only")
    report = next((r for r in replay["responses"] if r.get("kind") == "replay"), None)
    if report is None or report["pending"] < 1:
        fail("serve", f"stream D: the replay found no unfinished work: {report}")
    truth = {rid: v for rid, _, v in kill_plan}
    for rid, v in report["verdicts"].items():
        if v is not truth[rid]:
            fail("serve", f"stream D: replayed {rid} {v}, uninterrupted {truth[rid]}")
    if set(report["verdicts"]) | {k for k, v in seen.items() if v is not None} != journaled:
        fail("serve", f"stream D: answered {seen} + replayed {report['verdicts']} != journaled {sorted(journaled)}")
    got = answered(restart, "stream D restart")
    rep2 = next((r for r in restart["responses"] if r.get("kind") == "replay"), {})
    for rid, _, v in kill_plan:
        if seen.get(rid) is None and got.get(rid, {}).get("verdict") is not v:
            fail("serve", f"stream D restart: {rid} answered {got.get(rid)}, uninterrupted {v}")
    # The answers before the kill and after the restart (the replayed ones
    # from its cache) hold check_many's verdict, hit index and witness.
    for r in held_d + list(got.values()):
        want = want_d[r["request_id"]]
        if (r.get("verdict") is not want.intersects
                or (r.get("stats") or {}).get("hit_index") != want.stats.get("hit_index")
                or (not want.intersects
                    and witness(r) != sorted(sorted(want.cert["witness"][q]) for q in ("q1", "q2")))):
            fail("serve", f"stream D: {r['request_id']} answered {r.get('verdict')} at hit "
                          f"{r.get('stats', {}).get('hit_index')}, check_many {want.intersects} at "
                          f"{want.stats.get('hit_index')}, or another witness")
    streams["D"] = {"killed_after_first": {"answered": seen, "journaled": sorted(journaled), "rc": killed["rc"],
                                           "wall_s": killed["wall"]},
                    "replay_only": {k: report[k] for k in ("pending", "already_done", "verdicts", "torn_tail")},
                    "restart": {"replayed": rep2.get("verdicts"), "answered": {k: v.get("verdict") for k, v in got.items()},
                                "cached": sum(1 for v in got.values() if v.get("cached"))},
                    "sweep.dispatch": dispatch_fault, "serve.drain": drain_fault}

    phase_line("serve", card=card, seconds=round(time.perf_counter() - t0, 3), streams=streams,
               serve_launches={k: v for k, v in launches.items()})
    if launches["packed_sweep_dense_cuda"] + launches["packed_sweep_bitset_cuda"] < 1:
        fail("serve", f"the serve path never launched a packed kernel: {dict(launches)}")
    return dict(launches)


# Phase fleet's worker accounting: every process of a fleet run (the front
# door and each worker) appends its qi-telemetry stream to one file through
# QI_METRICS_JSON; a worker that launched a kernel writes its launch counts
# there at exit (``kernels.launch_counts``), one line a process.
FLEET_WAIT_S = 180.0
# Where phase fleet's workers must have solved (the stats' device prefix).
FLEET_DEVICE = "cuda"


def worker_launches(path):
    """The ``launches`` lines of a shared ``QI_METRICS_JSON`` stream, by pid."""
    out = {}
    if not pathlib.Path(path).exists():
        return out
    for line in pathlib.Path(path).read_text().splitlines():
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and obj.get("kind") == "launches":
            out[obj["pid"]] = obj["launches"]
    return out


def summed_counters(path, names):
    """Each counter in ``names`` summed over every process of a shared
    ``QI_METRICS_JSON`` stream."""
    out = {name: 0 for name in names}
    for line in pathlib.Path(path).read_text().splitlines():
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and obj.get("kind") == "counter" and obj.get("name") in out:
            out[obj["name"]] += obj["value"]
    return out


def journal_owners(journal_dir):
    """request id -> worker id, from each worker's journal in ``journal_dir``."""
    owners = {}
    for path in sorted(pathlib.Path(journal_dir).glob("*.journal")):
        for line in path.read_text().splitlines():
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and obj.get("kind") == "req":
                owners.setdefault(obj["request_id"], path.stem)
    return owners


def k1_k3(counts):
    return {"K1 sweep_fused_cuda": counts.get("sweep_fused_cuda", 0),
            "K3 packed_sweep_dense_cuda": counts.get("packed_sweep_dense_cuda", 0)}


def fleet_phase(device, card, texts, manifest, cert_jobs, work):
    """Phase fleet: the replicated serve tier on the card, three streams (a
    pipe fleet as a process; a kill of one of two worker processes; a socket
    peer joined over the mesh).  Returns the fleet path's kernel launches,
    summed over every worker process and the in-process worker of F3."""
    import os
    import signal
    import threading
    from collections import Counter

    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.fleet import FleetEngine, HashRing, MeshHandshakeError
    from quorum_intersection_tpu_torch.kernels import launch_counts
    from quorum_intersection_tpu_torch.pipeline import check_many
    from quorum_intersection_tpu_torch.serve import snapshot_fingerprint
    from quorum_intersection_tpu_torch.utils import telemetry
    from quorum_intersection_tpu_torch.utils.metrics_server import readyz_payload

    t_phase = time.perf_counter()
    launches = Counter()
    streams = {}

    def fp_of(src):
        return snapshot_fingerprint(build_graph(parse_fbas(raw_json(src))))

    def req(rid, src, client, **extra):
        return json.dumps({"request_id": rid, "nodes": json.loads(raw_json(src)), "client": client, **extra})

    def witness_of_cert(cert):
        w = (cert or {}).get("witness")
        return None if w is None else sorted(sorted(q) for q in (w["q1"], w["q2"]))

    def witness_of(res):
        return None if res.intersects else sorted(sorted(res.cert["witness"][q]) for q in ("q1", "q2"))

    def routed_to(ring, want, tag, n=9):
        for i in range(256):
            cand = synth.majority_fbas(n, prefix=f"{tag}{i}")
            if ring.route(fp_of(cand)) == want:
                return cand
        fail("fleet", f"no {tag} prefix routes to {want}")

    # -- F1: a pipe fleet of two worker processes on the card ---------------
    jdir, sdir = work / "fleet_f1", work / "fleet_f1_store"
    metrics_front, metrics_all = work / "fleet_f1.jsonl", work / "fleet_f1_all.jsonl"
    snap_trace, snap_metas = synth.churn_trace_steps(json.loads(texts["snapshot_correct.json"]), 15, seed=3, skew=1.0)
    twin = synth.benchmark_fbas(256, 31)
    ring = HashRing()
    for wid in ("w0", "w1"):
        ring.add(wid)
    base = routed_to(ring, "w0", "FB")
    other = routed_to(ring, "w1", "FO")
    fixtures = [(name, texts[name]) for name in manifest]
    plan = [(f"fix-{name}", text, manifest[name]["verdict"]) for name, text in fixtures]
    plan += [(f"churn-{k}", snap, None) for k, snap in enumerate(snap_trace)]
    plan += [("twin-2^30", twin, True)]
    plan += [(f"fix-again-{name}", text, manifest[name]["verdict"]) for name, text in fixtures]
    clients = ("explorer", "validator-ops", "researcher", "monitor")
    lines = [req(rid, src, clients[i % len(clients)]) for i, (rid, src, _) in enumerate(plan)]
    # The cross-worker pair last: the base first, its twin once the base is
    # answered, so the twin's worker composes the fragment the other banked.
    lines += [req("pair-base", base, "ops"), ("after", "pair-base"), req("pair-twin", other, "ops")]
    n_requests = len(plan) + 2
    scratch = dict(zip((f"churn-{k}" for k in range(len(snap_trace))), check_many(snap_trace, backend="gpu-sweep")))
    fleet_cmd = [sys.executable, "-m", PORT, "fleet", "-n", "2", "--backend", "gpu-sweep", "--emit-certs",
                 "--journal-dir", str(jdir), "--store-dir", str(sdir), "--metrics-json", str(metrics_front)]
    run = serve_run([], lines, env={"QI_METRICS_JSON": str(metrics_all)}, launcher=fleet_cmd)

    def stderr_tails():
        return {p.name: p.read_text()[-800:] for p in sorted(jdir.glob("*.stderr"))}

    if run["rc"] != 0:
        fail("fleet", f"F1: exit {run['rc']}: {run['stderr'][-1500:]} workers: {stderr_tails()}")
    start = next((r for r in run["responses"] if r.get("kind") == "fleet"), None)
    if start is None or start.get("workers") != ["w0", "w1"]:
        fail("fleet", f"F1: the fleet did not start both workers: {start} {stderr_tails()}")
    got = {r["request_id"]: r for r in run["responses"] if "request_id" in r}
    for rid, src, want in plan + [("pair-base", base, True), ("pair-twin", other, True)]:
        r = got.get(rid)
        if r is None or "verdict" not in r:
            fail("fleet", f"F1: {rid} answered {r and r.get('error')}")
        expect = want if want is not None else scratch[rid].intersects
        if r["verdict"] is not expect:
            fail("fleet", f"F1: {rid} verdict {r['verdict']}, expected {expect}")
        if want is None and witness_of_cert(r.get("cert")) != witness_of(scratch[rid]):
            fail("fleet", f"F1: {rid} witness differs from the scratch check_many's")
        if r.get("cert") and not r.get("cached"):
            cert_jobs.append((f"fleet/F1 {rid}", src, r["cert"]))
    counters_f, gauges_f, _ = metrics_of(metrics_front)
    if gauges_f.get("fleet.workers_live") != 2:
        fail("fleet", f"F1: fleet.workers_live {gauges_f.get('fleet.workers_live')} at exit, not 2")
    owners = journal_owners(jdir)
    groups = {}
    for rid, src, _ in plan:
        groups.setdefault(fp_of(src), []).append(rid)
    repeated = {fp: rids for fp, rids in groups.items() if len(rids) > 1}
    for fp, rids in repeated.items():
        on = {owners[rid] for rid in rids if rid in owners}
        if len(on) > 1:
            fail("fleet", f"F1: one snapshot answered by two workers: {rids} on {on}")
    # Every repeat of a snapshot is a cache hit or a coalesced waiter of its
    # one solve, on the worker its fingerprint routes to.
    n_repeats = sum(len(rids) - 1 for rids in repeated.values())
    single_flight = summed_counters(metrics_all, ("serve.cache_hits", "serve.coalesced", "serve.requests"))
    if single_flight["serve.cache_hits"] + single_flight["serve.coalesced"] < n_repeats:
        fail("fleet", f"F1: {n_repeats} repeated snapshots, single-flight counters {single_flight}")
    pair = {rid: owners.get(rid) for rid in ("pair-base", "pair-twin")}
    stamp = got["pair-twin"]["cert"]["provenance"].get("delta", {})
    if pair["pair-base"] == pair["pair-twin"] or (stamp.get("reused_sccs"), stamp.get("resolved_sccs")) != (1, 0):
        fail("fleet", f"F1: the twin on {pair} did not compose the other worker's fragment: {stamp}")
    per_worker = worker_launches(metrics_all)
    if len(per_worker) != 2:
        fail("fleet", f"F1: launch records from {len(per_worker)} worker processes, not 2: {per_worker}")
    for counts in per_worker.values():
        launches.update(counts)
    f1_k = sum(c.get("sweep_fused_cuda", 0) + c.get("packed_sweep_dense_cuda", 0) for c in per_worker.values())
    if f1_k < 1:
        fail("fleet", f"F1: no worker launched K1 or K3: {per_worker}")
    stats = serve_stream_stats(run, n_requests)
    stats.pop("launches", None)
    streams["F1"] = {**stats, "workers": start["workers"], "workers_live": gauges_f.get("fleet.workers_live"),
                     "store_hit_pct": gauges_f.get("fleet.store_hit_pct"),
                     "e2e_p99_ms": gauges_f.get("fleet.e2e_p99_ms"),
                     "cached": sum(1 for r in got.values() if r.get("cached")),
                     "repeated_snapshots": len(repeated), "repeats": n_repeats, "single_flight": single_flight,
                     "answered_by": dict(Counter(owners.get(rid, "cache") for rid in got)),
                     "cross_worker_pair": {**pair, "twin_delta": stamp},
                     "fleet_counters": {k: v for k, v in counters_f.items() if k.startswith("fleet.")},
                     "worker_launches": {str(pid): k1_k3(c) for pid, c in per_worker.items()}}

    # -- F2: kill one of two worker processes on the card ---------------------
    jdir2 = work / "fleet_f2"
    metrics_f2 = work / "fleet_f2_all.jsonl"
    small = [synth.majority_fbas(n, broken=n % 2 == 0, prefix=f"K{n}") for n in (9, 10, 11, 12)]
    f2_sources = [twin] + small
    truth = check_many(f2_sources, backend="gpu-sweep")
    rec = telemetry.reset_run_record()
    # Set after the reset, so only the worker processes (the respawned one
    # too) stream there, not this one.
    os.environ["QI_METRICS_JSON"] = str(metrics_f2)
    fleet = FleetEngine(2, backend="gpu-sweep", worker_mode="subprocess", journal_dir=jdir2, probe_interval_s=0.2)
    try:
        t = time.perf_counter()
        fleet.start()
        start_s = time.perf_counter() - t
        if fleet.worker_ids() != ["w0", "w1"]:
            fail("fleet", f"F2: workers live {fleet.worker_ids()}, not both")
        victim = fleet._ring.route(fp_of(twin))
        tickets = [("twin-2^30", fleet.submit(twin, request_id="twin-2^30"))]
        journal = jdir2 / f"{victim}.journal"
        deadline = time.monotonic() + FLEET_WAIT_S
        while '"twin-2^30"' not in (journal.read_text() if journal.exists() else ""):
            if time.monotonic() > deadline:
                fail("fleet", "F2: the twin never reached its worker's journal")
            time.sleep(0.005)
        fleet.kill_worker(victim)  # SIGKILL while the twin is in flight
        killed_t = time.monotonic()
        tickets += [(f"k-{i}", fleet.submit(s, request_id=f"k-{i}")) for i, s in enumerate(small)]
        ready_seen = []
        while not all(tk.done() for _, tk in tickets):
            if time.monotonic() - killed_t > FLEET_WAIT_S:
                fail("fleet", f"F2: requests unresolved {FLEET_WAIT_S} s after the kill")
            _, status = readyz_payload()
            if not ready_seen or ready_seen[-1] != status:
                ready_seen.append(status)
            time.sleep(0.01)
        results = {}
        for rid, tk in tickets:
            try:
                results[rid] = tk.result(timeout=1.0)
            except Exception as exc:  # noqa: BLE001 — a lost request is this stream's failure
                fail("fleet", f"F2: {rid} lost: {exc!r}")
        for (rid, _), want in zip(tickets, truth):
            r = results[rid]
            if (r.intersects, witness_of_cert(r.cert)) != (want.intersects, witness_of(want)):
                fail("fleet", f"F2: {rid} answered {r.intersects}, uninterrupted {want.intersects}")
        for (rid, _), src in zip(tickets, f2_sources):
            cert_jobs.append((f"fleet/F2 {rid}", src, results[rid].cert))
        deadline = time.monotonic() + FLEET_WAIT_S
        while rec.snapshot()[0].get("fleet.respawns", 0) < 1:
            if time.monotonic() > deadline:
                fail("fleet", f"F2: the killed slot never respawned: {rec.snapshot()[0]}")
            time.sleep(0.05)
        _, ready_after = readyz_payload()
        counters2 = dict(rec.snapshot()[0])
        live_after = fleet.worker_ids()
    finally:
        fleet.stop(drain=True, timeout=120.0)
        os.environ.pop("QI_METRICS_JSON", None)
    if counters2.get("fleet.respawns") != 1 or counters2.get("fleet.errors", 0) != 0:
        fail("fleet", f"F2: respawns {counters2.get('fleet.respawns')}, errors {counters2.get('fleet.errors', 0)}")
    if counters2.get("fleet.verdicts") != len(tickets):
        fail("fleet", f"F2: {counters2.get('fleet.verdicts')} verdicts delivered for {len(tickets)} requests")
    if 503 not in ready_seen or ready_after != 200:
        fail("fleet", f"F2: /readyz went {ready_seen} then {ready_after}; it must answer 503 until the replay")
    per_worker2 = worker_launches(metrics_f2)
    for counts in per_worker2.values():
        launches.update(counts)
    streams["F2"] = {"start_s": start_s, "victim": victim, "live_after": live_after,
                     "readyz_seen": ready_seen, "readyz_after": ready_after,
                     "kill_to_all_resolved_s": time.monotonic() - killed_t,
                     "verdicts": {rid: results[rid].intersects for rid, _ in tickets},
                     "fleet_counters": {k: v for k, v in counters2.items() if k.startswith("fleet.")},
                     "worker_launches": {str(pid): k1_k3(c) for pid, c in per_worker2.items()}}

    # -- F3: a socket peer on the card, joined over the mesh -----------------
    token = "chip-smoke-mesh-token"
    peer_journal, peer_metrics = work / "fleet_f3_peer.journal", work / "fleet_f3_peer.jsonl"
    peer = subprocess.Popen(
        [sys.executable, "-c", SERVE_LAUNCHER, "--socket", "0", "--journal", str(peer_journal),
         "--backend", "gpu-sweep", "--emit-certs", "--metrics-json", str(peer_metrics)],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "QI_FLEET_TOKEN": token})
    peer_err = []
    threading.Thread(target=lambda: peer_err.append(peer.stderr.read()), daemon=True).start()
    port = None
    t = time.perf_counter()
    for raw in peer.stdout:
        obj = json.loads(raw)
        if obj.get("kind") == "listening":
            port = int(obj["port"])
            break
    threading.Thread(target=lambda: peer.stdout.read(), daemon=True).start()
    peer_start_s = time.perf_counter() - t
    old_token = os.environ.get("QI_FLEET_TOKEN")
    mesh = None
    try:
        if port is None:
            fail("fleet", f"F3: the peer never listened: {''.join(peer_err)[-1500:]}")
        addr = f"127.0.0.1:{port}"
        os.environ["QI_FLEET_TOKEN"] = "not-the-peer-token"
        wrong = FleetEngine(0, backend="gpu-sweep", worker_mode="local", joins=[addr], respawn_max=0,
                            journal_dir=work / "fleet_f3_wrong", probe_interval_s=30.0)
        try:
            wrong.start()
            fail("fleet", "F3: a join under the wrong token was accepted")
        except MeshHandshakeError as exc:
            bad_token = {"reject_code": exc.reject_code, "code": exc.code}
        finally:
            wrong.stop(drain=False, timeout=10.0)
        if bad_token["reject_code"] != "bad_token":
            fail("fleet", f"F3: the wrong token was refused as {bad_token}")
        os.environ["QI_FLEET_TOKEN"] = token
        ring3 = HashRing()
        for wid in ("j0", "w0"):
            ring3.add(wid)
        remote = routed_to(ring3, "j0", "MR", n=11)
        local_base = routed_to(ring3, "w0", "ML", n=10)
        peer_twin = routed_to(ring3, "j0", "MT", n=10)
        pend = [routed_to(ring3, "j0", f"SP{i}", n=9 + i) for i in range(3)]
        want_remote = check_many([remote], backend="gpu-sweep")[0]
        pend_truth = check_many(pend, backend="gpu-sweep")
        rec = telemetry.reset_run_record()
        zero_script_launches()  # from here on: the in-process worker w0's launches
        mesh = FleetEngine(1, backend="gpu-sweep", worker_mode="local", joins=[addr], respawn_max=0,
                           journal_dir=work / "fleet_f3", store_dir=work / "fleet_f3_store",
                           probe_interval_s=0.2, lease_s=1.5)
        mesh.start()
        j0 = mesh._workers.get("j0")
        if mesh.worker_ids() != ["j0", "w0"] or j0 is None or j0.replay_report is None:
            fail("fleet", f"F3: the join did not answer hello_ok: {mesh.worker_ids()}")
        if any(mesh._ring.route(fp_of(src)) != want for src, want in (
                (remote, "j0"), (local_base, "w0"), (peer_twin, "j0"), *((s, "j0") for s in pend))):
            fail("fleet", "F3: the fleet's ring routes differently from the script's")
        r_remote = mesh.submit(remote, request_id="remote").result(timeout=FLEET_WAIT_S)
        if r_remote.intersects is not want_remote.intersects or not str(
                r_remote.stats.get("device", "")).startswith(FLEET_DEVICE):
            fail("fleet", f"F3: the peer answered {r_remote.intersects} on {r_remote.stats.get('device')}")
        cert_jobs.append(("fleet/F3 remote", remote, r_remote.cert))
        r_base = mesh.submit(local_base, request_id="local-base").result(timeout=FLEET_WAIT_S)
        r_twin = mesh.submit(peer_twin, request_id="peer-twin").result(timeout=FLEET_WAIT_S)
        stamp3 = r_twin.cert["provenance"].get("delta", {})
        if (r_base.intersects, r_twin.intersects) != (True, True) or (
                stamp3.get("reused_sccs"), stamp3.get("resolved_sccs")) != (1, 0):
            fail("fleet", f"F3: the peer's miss did not compose the gateway's fragment: {stamp3}")
        cert_jobs += [("fleet/F3 local-base", local_base, r_base.cert), ("fleet/F3 peer-twin", peer_twin, r_twin.cert)]
        deadline = time.monotonic() + 30.0
        while not (mesh.healthz()["workers"].get("j0", {}).get("counters", {}).get("fleet.store_hits", 0) >= 1):
            if time.monotonic() > deadline:
                fail("fleet", f"F3: the peer's pong shows no store hit: {mesh.healthz()['workers'].get('j0')}")
            time.sleep(0.05)
        peer_pong = mesh.healthz()["workers"]["j0"].get("counters", {})
        # The lease lapse: the peer stopped, its requests in flight, then let go
        # once the eviction has begun, so the journal ship completes.
        os.kill(peer.pid, signal.SIGSTOP)
        stopped_t = time.monotonic()
        try:
            pend_tickets = [mesh.submit(s, request_id=f"pend-{i}") for i, s in enumerate(pend)]
            deadline = time.monotonic() + 60.0
            while rec.snapshot()[0].get("fleet.evictions", 0) < 1:
                if time.monotonic() > deadline:
                    fail("fleet", f"F3: the stopped peer's lease never lapsed: {rec.snapshot()[0]}")
                time.sleep(0.02)
        finally:
            os.kill(peer.pid, signal.SIGCONT)
        evicted_after_s = time.monotonic() - stopped_t
        pend_got = [tk.result(timeout=FLEET_WAIT_S) for tk in pend_tickets]
        for i, (g, w) in enumerate(zip(pend_got, pend_truth)):
            if (g.intersects, witness_of_cert(g.cert)) != (w.intersects, witness_of(w)):
                fail("fleet", f"F3: pend-{i} answered {g.intersects}, expected {w.intersects}")
            cert_jobs.append((f"fleet/F3 pend-{i}", pend[i], g.cert))
        deadline = time.monotonic() + 60.0
        while rec.snapshot()[0].get("fleet.ships", 0) + rec.snapshot()[0].get("fleet.ship_errors", 0) < 1:
            if time.monotonic() > deadline:
                fail("fleet", "F3: the evicted peer's journal ship never ended")
            time.sleep(0.05)
        counters3 = dict(rec.snapshot()[0])
        spool = work / "fleet_f3" / "shipped" / "j0.shipped.journal"
        shipped = spool.exists() and peer_journal.read_bytes().startswith(spool.read_bytes())
        if counters3.get("fleet.ships") != 1 or not shipped:
            fail("fleet", f"F3: the journal ship failed: {counters3}")
        if mesh.worker_ids() != ["w0"] or counters3.get("fleet.errors", 0):
            fail("fleet", f"F3: after the lapse {mesh.worker_ids()}, errors {counters3.get('fleet.errors', 0)}")
        script_counts = launch_counts()
    finally:
        if mesh is not None:
            mesh.stop(drain=True, timeout=120.0)
        if old_token is None:
            os.environ.pop("QI_FLEET_TOKEN", None)
        else:
            os.environ["QI_FLEET_TOKEN"] = old_token
        try:
            peer.stdin.close()
            peer.wait(timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            peer.kill()
            peer.wait()
    peer_record = None
    time.sleep(0.2)
    for line in "".join(peer_err).splitlines():
        if line.startswith("serve-launches "):
            peer_record = json.loads(line[len("serve-launches "):])
    if peer_record is None:
        fail("fleet", f"F3: no launch record from the peer: {''.join(peer_err)[-1500:]}")
    launches.update(peer_record["launches"])
    launches.update(script_counts)
    peer_counters, _, _ = metrics_of(peer_metrics)
    if peer_counters.get("store.fetches", 0) < 1 or peer_counters.get("store.fetch_errors", 0):
        fail("fleet", f"F3: the peer fetched {peer_counters.get('store.fetches')} fragments, "
                      f"{peer_counters.get('store.fetch_errors', 0)} errors")
    streams["F3"] = {"peer_start_s": peer_start_s, "wrong_token": bad_token,
                     "remote": {"verdict": r_remote.intersects, "device": r_remote.stats.get("device"),
                                "seconds": r_remote.seconds},
                     "peer_twin_delta": stamp3, "peer_pong_counters": peer_pong,
                     "peer_store": {k: peer_counters.get(k, 0) for k in ("store.fetches", "store.publishes",
                                                                          "fleet.store_hits", "store.fetch_errors")},
                     "lease_lapse": {"stopped_to_evicted_s": evicted_after_s,
                                     "pending_replayed": [g.intersects for g in pend_got],
                                     "shipped_bytes": spool.stat().st_size},
                     "fleet_counters": {k: v for k, v in counters3.items() if k.startswith("fleet.")},
                     "peer_launches": k1_k3(peer_record["launches"]), "front_door_worker_launches": k1_k3(script_counts)}
    phase_line("fleet", card=card, seconds=round(time.perf_counter() - t_phase, 3), streams=streams,
               fleet_launches={k: v for k, v in launches.items()})
    if launches["sweep_fused_cuda"] + launches["packed_sweep_dense_cuda"] < 1:
        fail("fleet", f"the fleet path never launched K1 or K3: {dict(launches)}")
    return dict(launches)


# The per-SCC scan in turns (phase native): Python loop and native call on
# one graph, alternately, so both see the same host and cache state.
SCAN_TURNS = ("python", "native", "native", "python", "python", "native")
SCAN_WATCHERS = 30_000  # the larger of the two networks scanned in SCAN_TURNS
SCAN_FULL_WATCHERS = 200_000  # the 200k network: one turn each way (a native turn takes seconds)
SCAN_SCC_SIZES = (16, 32, 48, 64, 96, 128, 192, 256)  # one SCC: benchmark_fbas(s, s)
SCAN_SCC_REPS = 20  # scans a turn on one SCC, above the timer's resolution
TOOLING_TWIN_CORE = 31  # phase tooling's profiled solve: benchmark_fbas(256, core=31), 2^30 candidates


def scan_turns(graph, sccs, turns=SCAN_TURNS, reps=1):
    """``turns`` over one graph, each ``reps`` scans: the seconds of one scan
    each way, in order; fails unless every turn's quorums are equal."""
    from quorum_intersection_tpu_torch.backends.cpp import native_scc_scan
    from quorum_intersection_tpu_torch.pipeline import scan_scc_quorums

    secs = {"python": [], "native": []}
    want = None
    for way in turns:
        t = time.perf_counter()
        for _ in range(reps):
            got = native_scc_scan(graph, sccs) if way == "native" else scan_scc_quorums(graph, sccs)
        secs[way].append((time.perf_counter() - t) / reps)
        if want is None:
            want = got
        elif got != want:
            fail("native", f"the {way} scan's quorums differ from the first turn's")
    return secs


def crossover_members(rows):
    """The SCC size where the native scan's median meets the Python loop's:
    linear between the two sizes around the first at which the native one
    is faster; the first size if it is faster from the start, None if it
    never is."""
    prev = None
    for r in rows:
        d = r["python_median_s"] - r["native_median_s"]
        if d > 0:
            if prev is None:
                return r["members"]
            (s0, d0) = prev
            return round(s0 + (r["members"] - s0) * -d0 / (d - d0), 1)
        prev = (r["members"], d)
    return None


def native_phase(device, card, texts, manifest, cert_jobs, work, main_cli=None, k1_rate=None):
    """Phase native: the native host layer on the card's host.  The per-SCC
    scan in turns on the dump, the 30k and the 200k networks and on single
    SCCs of growing size, and the SCC size, if any, from which the native
    scan is the faster; the dump's ``gpu-sweep`` solve through K1 beside
    the native scan of its SCCs; the native binary against
    the ``gpu-sweep`` CLI processes on the fixtures (``main_cli``: phase
    main's; else run here) and, under ``-v``, against the port's CLI in
    process on the same native search (``--backend cpp``); ``native_candidate_rate`` beside K1's candidates/s
    (``k1_rate``: phase full's; else measured here)."""
    from statistics import median

    import numpy as np

    from quorum_intersection_tpu_torch import cli, pipeline
    from quorum_intersection_tpu_torch.backends import cpp
    from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph, group_sccs, tarjan_scc
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import sweep_fused
    from quorum_intersection_tpu_torch.utils import telemetry

    t0 = time.perf_counter()

    def graph_and_sccs(text=None, graph=None):
        graph = build_graph(parse_fbas(text)) if graph is None else graph
        count, comp = tarjan_scc(graph.n, graph.succ)
        return graph, group_sccs(graph.n, comp, count)

    def turns_row(g, sccs, turns=SCAN_TURNS, reps=1, **row):
        secs = scan_turns(g, sccs, turns, reps)
        med = {way: median(v) for way, v in secs.items()}
        return {**row, "nodes": g.n, "sccs": len(sccs), "largest_scc": max(map(len, sccs)),
                "turns": list(turns), "scans_a_turn": reps,
                "python_s": secs["python"], "native_s": secs["native"],
                "python_median_s": med["python"], "native_median_s": med["native"],
                "python_spread_s": max(secs["python"]) - min(secs["python"]),
                "native_spread_s": max(secs["native"]) - min(secs["native"]),
                "python_per_scc_us": med["python"] / len(sccs) * 1e6,
                "native_per_scc_us": med["native"] / len(sccs) * 1e6,
                "quorums_equal": True}

    # -- the scan in turns: networks of many small SCCs ----------------------
    cpp.build_library()
    rows = []
    for label, text in (("dump_scale_correct.json.gz", texts["dump_scale_correct.json.gz"]),
                        (f"stellar_like_fbas(n_watchers={SCAN_WATCHERS},seed=7)",
                         json.dumps(synth.stellar_like_fbas(n_watchers=SCAN_WATCHERS, seed=7)))):
        rows.append(turns_row(*graph_and_sccs(text), graph=label))
    label = f"stellar_like_fbas(n_watchers={SCAN_FULL_WATCHERS},seed=7)"
    t = time.perf_counter()
    if label in GRAPHS:
        graph, sccs = graph_and_sccs(graph=GRAPHS.pop(label))
    else:
        graph, sccs = graph_and_sccs(json.dumps(synth.stellar_like_fbas(n_watchers=SCAN_FULL_WATCHERS, seed=7)))
    rows.append(turns_row(graph, sccs, ("python", "native"), graph=label, graph_build_s=time.perf_counter() - t))
    del graph, sccs

    # -- the scan in turns: one SCC of growing size ---------------------------
    scc_rows = []
    for m in SCAN_SCC_SIZES:
        graph, sccs = graph_and_sccs(json.dumps(synth.benchmark_fbas(m, m)))
        if len(sccs) != 1:
            fail("native", f"benchmark_fbas({m}, {m}): {len(sccs)} SCCs, not one")
        scc_rows.append(turns_row(graph, sccs, reps=SCAN_SCC_REPS, graph=f"benchmark_fbas({m},{m})", members=m))
    crossover = crossover_members(scc_rows)

    # -- the dump solved on the card, beside the native scan of its SCCs ------
    graph, sccs = graph_and_sccs(texts["dump_scale_correct.json.gz"])
    telemetry.reset_run_record()
    sweep_fused.launches = 0
    t = time.perf_counter()
    res = pipeline.solve_graph(graph, backend=GpuSweepBackend(device=device))
    solve_s = time.perf_counter() - t
    if "native.scan_fixpoints" in telemetry.get_run_record().counters:
        fail("native", "the dump's solve scanned natively")
    cert_jobs.append(("native/dump_scale_correct.json.gz", texts["dump_scale_correct.json.gz"], res.cert))
    native_bearing = [sid for sid, q in enumerate(cpp.native_scc_scan(graph, sccs)) if q]
    if res.intersects is not True or sweep_fused.launches < 1 or native_bearing != res.quorum_scc_ids:
        fail("native", f"the dump: verdict {res.intersects}, K1 {sweep_fused.launches}, quorum-bearing SCCs "
                       f"{res.quorum_scc_ids} in the solve, {native_bearing} natively")
    solve_row = {"graph": "dump_scale_correct.json.gz", "nodes": graph.n, "sccs": len(sccs), "solve_s": solve_s,
                 "verdict": res.intersects, "k1_launches": sweep_fused.launches,
                 "scc_scan_timer_s": res.timers.get("scc_scan"), "quorum_scc_ids": res.quorum_scc_ids,
                 "native_quorum_scc_ids": native_bearing}
    del graph, sccs

    # -- the native binary against the CLI ------------------------------------
    binary = str(cpp.build_native_cli())
    names = list(manifest)
    if main_cli is None:
        runs = run_all([[sys.executable, "-m", PORT, "--backend", "gpu-sweep", "--device", device.type]
                        for _ in names], inputs=[texts[name] for name in names])
        main_cli = {name: (so, se, rc) for name, (so, se, rc, _) in zip(names, runs)}
    native_runs = run_all([[binary] for _ in names] + [[binary, "-v"] for _ in names],
                          inputs=[texts[name] for name in names] * 2)
    binary_rows = {}
    for i, name in enumerate(names):
        so, _, rc, secs = native_runs[i]
        cso, _, crc = main_cli[name]
        if (so, rc) != (cso, crc):
            fail("native", f"{name}: the binary printed {so[-60:]!r} exit {rc}, the CLI {cso[-60:]!r} exit {crc}")
        vso, _, vrc, _ = native_runs[len(names) + i]
        pso, _, prc = in_process(cli.main, ["--backend", "cpp", "--device", device.type, "-v"], texts[name])
        if (vso, vrc) != (pso, prc):
            fail("native", f"{name}: the binary's -v output differs from the port's CLI (cpp) in process")
        binary_rows[name] = {"stdout": so.strip(), "exit": rc, "binary_s": secs, "verbose_lines": len(vso.splitlines())}

    # -- the candidate rate --------------------------------------------------
    rate_graph = build_graph(parse_fbas(json.dumps(synth.benchmark_fbas(256, 34))))
    masks = np.random.default_rng(0).random((1 << 16, rate_graph.n)) < 0.5
    native_rate = cpp.native_candidate_rate(rate_graph, masks)
    if k1_rate is None:
        t = time.perf_counter()
        k1_res = pipeline.solve(synth.benchmark_fbas(256, 34), backend="gpu-sweep", device=device)
        k1_rate = k1_res.stats["candidates_checked"] / (time.perf_counter() - t)
    phase_line("native", card=card, seconds=round(time.perf_counter() - t0, 3), scan_turns=rows,
               scan_turns_one_scc=scc_rows, native_faster_from_members=crossover,
               gpu_sweep_solve=solve_row, binary=binary_rows,
               binary_vs="stdout and exit equal to the gpu-sweep CLI processes; -v byte-equal to the port's CLI "
                         "in process under --backend cpp (the same witness pair as the binary's search)",
               candidate_rate={"native_per_s": native_rate, "host_core": "one", "masks": int(masks.shape[0]),
                               "graph": "benchmark_fbas(256, core=34), random masks over all nodes (bench.py's)",
                               "k1_per_s": k1_rate, "k1_over_native": k1_rate / native_rate})


# A fresh process's kernel build: every library of kernels/build.py through
# the backends' own timed_build, with the build cache's counters.
BUILD_PROBE = r"""
import json
from quorum_intersection_tpu_torch.kernels import build
from quorum_intersection_tpu_torch.utils.telemetry import get_run_record
seconds = build.timed_build(build.SOURCES)
rec = get_run_record()
print(json.dumps({"kernel_build_seconds": seconds, "hits": rec.counters.get("compile_cache.hits", 0),
                  "misses": rec.counters.get("compile_cache.misses", 0),
                  "enabled_dirs": [ev["attrs"]["dir"] for ev in rec.events if ev["name"] == "compile_cache.enabled"],
                  "libraries": sorted(str(build._target(name)) for name in build.SOURCES)}))
"""


def tooling_phase(device, card, cert_jobs, work):
    """Phase tooling: the build cache, a process with
    ``QI_NO_COMPILE_CACHE=1`` (every library built into a private
    directory), then one with the cache (every library found); beside the
    second, a profiled CLI solve of the 2^30 twin (the trace holds K1's
    events and the run's ``qi-trace`` range, the id the metrics stream's);
    then the same solve unprofiled in process."""
    import os

    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.kernels import build
    from quorum_intersection_tpu_torch.pipeline import solve
    from quorum_intersection_tpu_torch.utils.profiling import trace_file

    t0 = time.perf_counter()
    base = {k: v for k, v in os.environ.items() if k != "QI_NO_COMPILE_CACHE"}
    twin = json.dumps(synth.benchmark_fbas(256, TOOLING_TWIN_CORE))
    prof_dir, metrics, cert = work / "profile", work / "profile.jsonl", work / "profile.cert.json"
    probe = [sys.executable, "-c", BUILD_PROBE]
    cold_run = run_all([probe], envs=[dict(base, QI_NO_COMPILE_CACHE="1")])[0]
    warm_run, (so, se, rc, process_s) = run_all(
        [probe, [sys.executable, "-m", PORT, "--backend", "gpu-sweep", "--device", device.type, "--profile-dir",
                 str(prof_dir), "--metrics-json", str(metrics), "--cert-out", str(cert)]],
        inputs=["", twin], envs=[base, base])
    def probe_result(run):
        out, err, code, secs = run
        if code != 0:
            fail("tooling", f"build probe exit {code}: {err[-800:]!r}")
        return dict(json.loads(out.strip().splitlines()[-1]), process_s=secs)

    cold, warm = probe_result(cold_run), probe_result(warm_run)
    n = len(build.SOURCES)
    private = all(str(ROOT) not in lib for lib in cold["libraries"])
    if (cold["misses"], cold["hits"], warm["hits"], warm["misses"]) != (n, 0, n, 0) or not private:
        fail("tooling", f"build cache: cold {cold}, warm {warm}")
    if warm["kernel_build_seconds"] > 0.1 * cold["kernel_build_seconds"]:
        fail("tooling", f"warm build {warm['kernel_build_seconds']} s > 10% of cold {cold['kernel_build_seconds']} s")

    if (so, rc) != ("true\n", 0):
        fail("tooling", f"profiled CLI: printed {so[-40:]!r} exit {rc}; {se[-600:]!r}")
    lines = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    trace_id = lines[0]["trace_id"]
    spans = {ln["name"]: ln for ln in lines if ln["kind"] == "span"}
    events = json.loads(trace_file(str(prof_dir), trace_id).read_text())["traceEvents"]
    k1_events = [ev for ev in events if "sweep_kernel" in ev.get("name", "")]
    ranges = [ev for ev in events if ev.get("name") == f"qi-trace:{trace_id}"]
    if not k1_events or not ranges or spans.get("profile.trace", {}).get("attrs", {}).get("trace_id") != trace_id:
        fail("tooling", f"trace {trace_id}: {len(k1_events)} K1 events, {len(ranges)} qi-trace ranges, "
                        f"span {spans.get('profile.trace')}")
    cert_jobs.append(("tooling/profiled twin", twin, json.loads(cert.read_text())))
    unprofiled = []
    for _ in range(3):
        t = time.perf_counter()
        res = solve(twin, backend="gpu-sweep", device=device)
        unprofiled.append(time.perf_counter() - t)
        if res.intersects is not True:
            fail("tooling", "the unprofiled twin solve is not true")
    profiled = {"process_s": process_s, "trace_id": trace_id, "k1_events": len(k1_events),
                "k1_device_ms": sum(ev.get("dur", 0) for ev in k1_events) / 1e3,
                "search_s": spans["phase.search"]["seconds"], "profile_span_s": spans["profile.trace"]["seconds"],
                "trace_bytes": trace_file(str(prof_dir), trace_id).stat().st_size,
                "unprofiled_in_process_s": unprofiled, "beside": "the warm build probe"}
    phase_line("tooling", card=card, seconds=round(time.perf_counter() - t0, 3), profiled=profiled,
               build_cache={"cold": cold, "warm": warm,
                            "warm_over_cold": warm["kernel_build_seconds"] / cold["kernel_build_seconds"]})


# -- 35. mesh: the mesh sweep K11, the candidate mesh and the multi-process runtime --

MESH_RANKS = (1, 2, 4, 8)  # ranks on the one card (repeated cuda:0) in K11's comparison
MESH_SOLVE_RANKS = 4  # the full-width solve's ranks on the one card
MESH_TWIN_CORE = 31  # the multi-process solves: benchmark_fbas(256, core=31), 2^30 candidates
MESH_COLLECTIVE_REPS = 200  # collectives timed back to back
MESH_MAIN_STEPS = 8  # blocks a program in K11's comparison at the main path's sizes
# A process of the multi-process part: joins through distributed.initialize,
# builds its ranks on its card, waits for the parent's go file (written once
# the parent's own comparisons are done, so nothing of them runs beside the
# solves and the timed collectives), solves the 2^30 twins on the global
# mesh, and times mesh_pmin and the bare all_reduce(MIN) alone.  argv: port, process id, processes,
# backend, card index, ranks on it, core, repetitions, go file.
MESH_WORKER = r"""
import json, os, sys, time
import torch
from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.kernels.sweep_cuda import sweep_fused, sweep_mesh
from quorum_intersection_tpu_torch.parallel import distributed
from quorum_intersection_tpu_torch.parallel.mesh import collective_of, mesh_pmin
from quorum_intersection_tpu_torch.pipeline import solve
port, backend = sys.argv[1], sys.argv[4]
pid, nprocs, card, ranks, core, reps = map(int, sys.argv[2:4] + sys.argv[5:9])
torch.cuda.set_device(card)
distributed.initialize(f"127.0.0.1:{port}", num_processes=nprocs, process_id=pid, local_device_ids=[card],
                       backend=backend)
mesh = distributed.global_candidate_mesh(devices=[torch.device("cuda", card)] * ranks)
assert mesh.process_count == nprocs, mesh
deadline = time.monotonic() + 600
while not os.path.exists(sys.argv[9]):
    if time.monotonic() > deadline:
        sys.exit("the parent's go file never came")
    time.sleep(0.01)
out = {"process_index": mesh.process_index, "process_count": mesh.process_count, "ranks": mesh.size,
       "collective": collective_of(mesh), "solves": {}}
for broken in (False, True):
    data = synth.benchmark_fbas(256, core, broken=broken)
    sweep_fused.launches = sweep_mesh.launches = 0
    t = time.perf_counter()
    res = solve(data, backend=GpuSweepBackend(mesh=mesh), with_cert=False)
    out["solves"][str(broken)] = {"intersects": res.intersects, "q1": res.q1, "q2": res.q2,
                                  "hit_index": res.stats.get("hit_index"), "seconds": time.perf_counter() - t,
                                  "candidates": res.stats.get("candidates_checked"),
                                  "k11_launches": sweep_mesh.launches, "k1_launches": sweep_fused.launches}
mine = torch.full((), 7 + pid, dtype=torch.int32, device=mesh.home)
for _ in range(10):
    mesh_pmin(mesh, mine.clone())
torch.cuda.synchronize()
torch.distributed.barrier()
t = time.perf_counter()
for _ in range(reps):
    best = mesh_pmin(mesh, mine.clone())
torch.cuda.synchronize()
out["pmin_ms"] = (time.perf_counter() - t) * 1e3 / reps
out["pmin_value"] = int(best)
# The bare all_reduce(MIN) of one int32 (mesh_pmin calls none in a group of
# one process; it reduces its argument in place, hence the clones above): on
# the card under nccl, a host tensor under gloo.
x = torch.full((), 7 + pid, dtype=torch.int32, device=f"cuda:{card}" if backend == "nccl" else "cpu")
for _ in range(10):
    torch.distributed.all_reduce(x, op=torch.distributed.ReduceOp.MIN)
torch.cuda.synchronize()
torch.distributed.barrier()
t = time.perf_counter()
for _ in range(reps):
    torch.distributed.all_reduce(x, op=torch.distributed.ReduceOp.MIN)
torch.cuda.synchronize()
out["all_reduce_ms"] = (time.perf_counter() - t) * 1e3 / reps
out["all_reduce_value"], out["all_reduce_on"] = int(x), str(x.device)
torch.distributed.destroy_process_group()
print(json.dumps(out), flush=True)
"""


def mesh_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_worker_cmds(nprocs, backend, cards, ranks, go):
    """One process group of MESH_WORKER: ``cards[i]`` is process i's card;
    each process starts its solves once the file ``go`` exists."""
    port = mesh_free_port()
    return [[sys.executable, "-c", MESH_WORKER, str(port), str(pid), str(nprocs), backend, str(cards[pid]),
             str(ranks), str(MESH_TWIN_CORE), str(MESH_COLLECTIVE_REPS), str(go)] for pid in range(nprocs)]


def mesh_worker_results(label, runs):
    rows = []
    for so, se, rc, seconds in runs:
        if rc != 0:
            fail("mesh", f"{label}: a process exited {rc}: {se[-1500:]}")
        row = json.loads(so.strip().splitlines()[-1])
        row["process_seconds"] = seconds
        rows.append(row)
    return rows


def mesh_layouts(cards: int):
    """K11's layouts: (label, ranks' devices) on 1, 2, 4 and 8 ranks of the
    one card and, on a host of four cards, over cuda:0-3 and over two cards
    holding two ranks each."""
    import torch

    card0 = torch.device("cuda", 0)
    out = [(f"{r} ranks, 1 card", [card0] * r) for r in MESH_RANKS]
    if cards >= 4:
        four = [torch.device("cuda", i) for i in range(4)]
        out += [("4 ranks, 4 cards", four), ("4 ranks, 2 cards", four[:2] * 2)]
    return out


def mesh_sweep(devices, circuit, circuit_d, lo_nodes, scc_mask, frozen, per_dev, stream=None):
    """K11 as the backend builds it (``_build_sharded_step``) over the ranks
    ``devices``: the mesh's ``ShardedSweep``, one ``FusedSweep`` a distinct
    card (``stream`` forces a table instance)."""
    from quorum_intersection_tpu_torch.backends.sweep import ShardedSweep
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import FusedSweep, MeshSweep
    from quorum_intersection_tpu_torch.parallel import candidate_mesh

    mesh = candidate_mesh(devices=devices)
    cards = [FusedSweep(circuit, lo_nodes, scc_mask, frozen, per_dev * mesh.devices.count(dev), circuit_d, dev,
                        stream=stream) for dev in dict.fromkeys(mesh.devices)]
    return ShardedSweep(mesh, per_dev, MeshSweep(cards))


def mesh_compare(device, card, texts) -> int:
    """Phase mesh, part 1: K11 (one launch of the fused kernel a card and
    program, the cards' minimum on the home card) against its plain version
    (K1's plain contiguous program over the same range) and against K1's
    contiguous program, at small launches on every layout, then at the
    main path's sizes with hits placed at the cards' share boundaries.
    Returns the largest difference (0 when it passes)."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.backends.sweep import _auto_batch
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import FusedSweep, KernelLimitError, mask_bits, sweep_mesh
    from quorum_intersection_tpu_torch.parallel import candidate_mesh
    from quorum_intersection_tpu_torch.parallel.mesh import card_shares

    max_err = 0

    def instances(devices, prob, lo_nodes, per_dev):
        circuit, circuit_d, _, scc_mask, frozen = prob
        out = {}
        for stream in (False, True):
            try:
                out["streamed" if stream else "resident"] = mesh_sweep(devices, circuit, circuit_d, lo_nodes,
                                                                       scc_mask, frozen, per_dev, stream)
            except KernelLimitError:  # a resident instance that does not fit
                if stream:
                    raise
        return out

    def check(label, kerns, start, steps, hi_bits, want, contiguous):
        """Every instance's mesh program equal to the plain ``want`` and
        to K1's ``contiguous``, one launch a card."""
        nonlocal max_err
        for inst, sharded in kerns.items():
            before = sweep_mesh.launches
            got = int(sharded.program(start, steps, hi_bits))
            cards = len(sharded.cards.devices)
            if sweep_mesh.launches != before + cards:
                fail("mesh", f"{label} {inst}: {sweep_mesh.launches - before} launches for {cards} cards")
            max_err = max(max_err, abs(got - want))
            if got != want:
                fail("mesh", f"{label} {inst} start={start}: K11 {got} != plain {want}")
        if contiguous != want:
            fail("mesh", f"{label} start={start}: K1's contiguous program {contiguous} != plain {want}")

    layouts = mesh_layouts(torch.cuda.device_count())
    problems = []
    problem = sweep_problem(texts["nested_correct.json"])
    problems.append(("nested_correct narrow", problem, len(problem[2]) - 1, 0))
    broken_snap = sweep_problem(texts["snapshot_broken.json"])
    problems.append(("snapshot_broken restricted", broken_snap, len(broken_snap[2]) - 1, 0))
    problems.append(("snapshot_correct restricted, a clean miss",
                     sweep_problem(texts["snapshot_correct.json"]), 20, 0))
    for broken in (False, True):
        problems.append((f"benchmark_fbas(256,34,broken={broken}) wide, hi row 5",
                         sweep_problem(json.dumps(synth.benchmark_fbas(256, 34, broken=broken))), 30, 5))
    compare_rows = []
    for label, prob, lo_bits, hi in problems:
        circuit, circuit_d, local, scc_mask, frozen = prob
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(circuit.n, dtype=np.int32)
        for j, v in enumerate(local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        hi_arg, hi_bits = (hi_row if hi_row.any() else None), mask_bits(hi_row)
        hits = windows = 0
        for layout, devices in layouts:
            ranks = len(devices)
            per_dev, steps = max(min(1 << 11, (1 << lo_bits) // (4 * ranks)), 1), 3
            base = per_dev * ranks
            plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, base, circuit_d, device)
            k1 = FusedSweep(circuit, lo_nodes, scc_mask, frozen, base, circuit_d, device)
            kerns = instances(devices, prob, lo_nodes, per_dev)
            for start in sorted({0, (1 << lo_bits) // 2, 3 << 27 if lo_bits == 30 else 0}):
                want = int(plain.program(start, steps, hi_arg))
                windows += 1
                hits += want != ref.INT32_MAX
                check(f"{label} {layout}", kerns, start, steps, hi_bits, want, int(k1.program(start, steps, hi_bits)))
        compare_rows.append({"label": label, "n": circuit.n, "units": circuit.n_units, "lo_bits": lo_bits,
                             "restricted": circuit_d is not None, "windows": windows, "windows_with_hits": hits,
                             "instances": list(kerns)})
    if any(r["windows_with_hits"] for r in compare_rows if "clean miss" in r["label"]):
        fail("mesh", "the clean-miss case has a hit")
    # K11 at the main path's sizes: the full-width drive's blocks
    # (_auto_batch(34) rows, _auto_batch(34) // 4 a rank) over
    # MESH_MAIN_STEPS blocks, so every warp walks the grid-stride loop.  The
    # broken twin's hits are dense (one in every 2^17 rows); late_hit_fbas(29)
    # misses on every row before its first hit h2 = 2^28 + 15, which is
    # placed at each card share's first and last row, inside the third
    # card's share (the one card's on one card) and at the program's last
    # row, so a share cut one row short or long shows.
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_faults_cases import late_hit_fbas

    block, steps = _auto_batch(34), MESH_MAIN_STEPS
    late = sweep_problem(json.dumps(late_hit_fbas(29)))
    late_k1 = FusedSweep(late[0], np.asarray(late[2][1:], dtype=np.int32), late[3], late[4], block, late[1], device)
    h2 = min(int(late_k1.program(0, 1024)), int(late_k1.program(1 << 29, 1024)))
    twins = {broken: problems[3 + broken][1] for broken in (False, True)}
    main_layouts = [row for row in layouts if row[0] in (f"{MESH_SOLVE_RANKS} ranks, 1 card", "4 ranks, 4 cards")]
    main_rows = []
    for layout, devices in main_layouts:
        sub = block // len(devices)
        shares = card_shares(candidate_mesh(devices=devices), sub, steps, 0)
        places = {}
        for c, (_, first, rows) in enumerate(shares):
            places.setdefault(first, f"card {c}'s first row")
            places.setdefault(first + rows - 1, f"card {c}'s last row")
        _, first, rows = shares[min(2, len(shares) - 1)]
        places.setdefault(first + rows // 2 + 17, f"inside card {min(2, len(shares) - 1)}'s share")
        places.setdefault(steps * block - 1, "the program's last row")
        windows = [("benchmark_fbas(256,34,broken=True), the main path's first program", twins[True], 0, None),
                   ("benchmark_fbas(256,34,broken=False), a clean miss", twins[False], 0, ref.INT32_MAX)]
        windows += [(f"late_hit_fbas(29), h2 at {name}", late, h2 - offset, h2) for offset, name in places.items()]
        kerns_of = {}
        for label, prob, start, expect in windows:
            circuit, circuit_d, local, scc_mask, frozen = prob
            lo_nodes = np.asarray(local[1:31], dtype=np.int32)
            if start < 0 or start + steps * block > 1 << 30:
                fail("mesh", f"{label}: the window from {start} leaves the 2^30 range")
            want = int(ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, block, circuit_d, device).program(start, steps))
            if (expect is not None and want != expect) or (expect is None and want == ref.INT32_MAX):
                fail("mesh", f"{label}: the plain version gives {want}, not {expect if expect else 'a hit'}")
            if id(prob) not in kerns_of:
                kerns_of[id(prob)] = instances(devices, prob, lo_nodes, sub)
            contiguous = int(FusedSweep(circuit, lo_nodes, scc_mask, frozen, block, circuit_d, device)
                             .program(start, steps))
            check(f"{label} ({layout})", kerns_of[id(prob)], start, steps, 0, want, contiguous)
            main_rows.append({"layout": layout, "label": label, "start": start, "min": want,
                              "instances": list(kerns_of[id(prob)])})
    phase_line("mesh_compare", card=card, tolerance="exact (integer hit indices)",
               layouts=[label for label, _ in layouts], cases=compare_rows, max_abs_err=max_err,
               main_path_sizes={"rows_a_rank_and_block": block // MESH_SOLVE_RANKS, "block": block, "steps": steps,
                                "late_hit_h2": h2, "windows": main_rows},
               against_k1="every mesh program equals K1's contiguous program and the plain version, "
                          "one launch a card")
    return max_err


def mesh_phase(device, card, texts, manifest, cert_jobs, work, k1_parent=None):
    """Phase mesh: K11 (one launch of the fused kernel a card and program)
    against its plain version and against K1 over the same range; the
    full-width twins on a 4-rank mesh of the one card against the unsharded
    solves; ``--mesh all`` as a CLI process; ``torch.distributed`` as a
    world-size-1 NCCL group and as two processes of two ranks each; the
    window's times (and ``k1_parent``'s K1 in turns with this tree's); and,
    on a host of several cards, the full width on 1, 2 and 4 of them.
    Returns the K11 record of the kernels line."""
    import numpy as np
    import torch

    from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend, ShardedSweep
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.fbas.semantics import is_quorum
    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import FusedSweep, mask_bits, sweep_fused, sweep_mesh
    from quorum_intersection_tpu_torch.parallel import candidate_mesh
    from quorum_intersection_tpu_torch.pipeline import solve

    # Programs the drive dispatches: K11 must launch once a card each.
    programs = [0]
    sharded_program = ShardedSweep.program

    def counted_program(self, *args, **kwargs):
        programs[0] += 1
        return sharded_program(self, *args, **kwargs)

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    card0 = torch.device("cuda", 0)
    # The processes first, in waves one after the other: the CLI under
    # --mesh all beside two processes of two ranks (NCCL on two cards, else
    # gloo on the one: NCCL refuses two ranks on one device); a world-size-1
    # NCCL group alone; on four cards, four NCCL processes alone.  They start
    # while mesh_compare runs, and solve and time once it is done (the go
    # file), so nothing of it and no other timed group runs beside them.
    go = work / "mesh.go"
    go.unlink(missing_ok=True)
    pair_backend = "nccl" if cards >= 2 else "gloo"
    cmds = [[sys.executable, "-m", PORT, "--backend", "gpu-sweep", "--mesh", "all"]]
    cmds += mesh_worker_cmds(2, pair_backend, [0, 1] if cards >= 2 else [0, 0], 2, go)
    waves = [(cmds, [texts["snapshot_broken.json"], None, None]),
             (mesh_worker_cmds(1, "nccl", [0], 2, go), [None])]
    if cards >= 4:
        waves.append((mesh_worker_cmds(4, "nccl", [0, 1, 2, 3], 1, go), [None] * 4))
    import threading

    wave_out = {}

    def run_waves():
        wave_out["runs"] = [run_all(c, inputs=i, timeout=600) for c, i in waves]

    wave_thread = threading.Thread(target=run_waves)
    wave_thread.start()
    try:
        max_err = mesh_compare(device, card, texts)
    finally:
        go.touch()  # a failed comparison still lets the processes run to their end

    # 3-4. The processes' results, before anything here is timed.
    wave_thread.join()
    (first_wave, world1_wave, *rest) = wave_out["runs"]
    out, err, code, cli_s = first_wave[0]
    want = manifest["snapshot_broken.json"]["verdict"]
    if out.strip().splitlines()[-1:] != ["true" if want else "false"] or code != (0 if want else 1):
        fail("mesh", f"--mesh all CLI: {out[-40:]!r} exit {code}; {err[-600:]!r}")
    world1 = mesh_worker_results("world-size-1 nccl", world1_wave)
    pair = mesh_worker_results(f"two processes ({pair_backend})", first_wave[1:3])
    four = mesh_worker_results("four processes (nccl)", rest[0]) if rest else []
    singles = {}
    for broken in (False, True):
        res = solve(synth.benchmark_fbas(256, MESH_TWIN_CORE, broken=broken), backend="gpu-sweep",
                    with_cert=False)
        singles[str(broken)] = [res.intersects, res.q1, res.q2, res.stats.get("hit_index")]
    for label, rows in (("world-size-1 nccl", world1), ("two processes", pair), ("four processes", four)):
        for row in rows:
            for key, want_row in singles.items():
                s = row["solves"][key]
                if [s["intersects"], s["q1"], s["q2"], s["hit_index"]] != want_row:
                    fail("mesh", f"{label}, process {row['process_index']}, broken={key}: {s} != the "
                                 f"single-process solve {want_row}")
                if s["k11_launches"] < 1 or s["k1_launches"]:
                    fail("mesh", f"{label}: K11 {s['k11_launches']}, K1 {s['k1_launches']} launches")
            if row["pmin_value"] != 7 or row["all_reduce_value"] != 7:
                fail("mesh", f"{label}: the collectives gave {row['pmin_value']} and "
                             f"{row['all_reduce_value']}, not 7")
    phase_line("mesh_processes", card=card,
               cli={"argv": "--backend gpu-sweep --mesh all", "fixture": "snapshot_broken.json", "exit": code,
                    "process_seconds": cli_s},
               world1=world1, pair={"backend": pair_backend, "host_copy": pair_backend == "gloo", "rows": pair},
               four=four or "not run (fewer than 4 cards)",
               verdicts="every process's verdict, witness and hit index equal the single-process solve's")
    # 2. Full width on a 4-rank mesh of the one card, in turns with the
    # unsharded solve; K11's launches counted on the sharded solves alone,
    # one a program on the one card.
    mesh4 = candidate_mesh(devices=[card0] * MESH_SOLVE_RANKS)
    full_rows, k11_launches = [], 0
    ShardedSweep.program = counted_program
    for broken in (False, True):
        data = synth.benchmark_fbas(256, 34, broken=broken)
        # Each solve starts on an idle card: a broken twin returns at its
        # first drained hit, leaving the programs behind it running.
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain_solve = solve(data, backend="gpu-sweep")
        unsharded_s = time.perf_counter() - t
        torch.cuda.synchronize()
        sweep_fused.launches = sweep_mesh.launches = programs[0] = 0
        t = time.perf_counter()
        res = solve(data, backend=GpuSweepBackend(mesh=mesh4))
        sharded_s = time.perf_counter() - t
        k11_launches += sweep_mesh.launches
        if sweep_mesh.launches < 1 or sweep_mesh.launches != programs[0] or sweep_fused.launches:
            fail("mesh", f"full width (broken={broken}) on the mesh: K11 {sweep_mesh.launches} launches for "
                         f"{programs[0]} programs on one card, K1 {sweep_fused.launches}")
        same = (res.intersects, res.q1, res.q2, res.stats.get("hit_index")) == (
            plain_solve.intersects, plain_solve.q1, plain_solve.q2, plain_solve.stats.get("hit_index"))
        if not same or res.intersects is broken:
            fail("mesh", f"full width (broken={broken}): the 4-rank solve differs from the unsharded one")
        if broken:
            graph = build_graph(parse_fbas(data))
            if not (is_quorum(graph, res.q1) and is_quorum(graph, res.q2) and not set(res.q1) & set(res.q2)):
                fail("mesh", "the broken twin's witness pair is not two disjoint quorums")
        cert_jobs.append((f"mesh/full/broken={broken}", data, res.cert))
        full_rows.append({"config": f"benchmark_fbas(256, core=34, broken={broken})", "ranks": mesh4.size,
                          "intersects": res.intersects, "hit_index": res.stats.get("hit_index"),
                          "sharded_seconds": sharded_s, "unsharded_seconds": unsharded_s,
                          "candidates": res.stats["candidates_checked"], "device_steps": res.stats["device_steps"],
                          "k11_launches": sweep_mesh.launches, "programs": programs[0], "mesh": res.stats["mesh"]})
    ShardedSweep.program = sharded_program
    phase_line("mesh_full", card=card, runs=full_rows, k11_launches=k11_launches,
               launches_of="one a program and card (1 card)",
               verdicts="verdict, witness and hit index equal to the unsharded solve's")

    # The window's times: a 2^20-candidate window at full width (the timing
    # phase's bench256_34 shape, hi row 5, start 2^20) through K11 on 1, 2
    # and 4 ranks of the one card and on 4 cards, beside K1 on the same
    # window (and k1_parent's K1 in turns with it), the plain version and
    # the bound (K1's window bound over the busiest card's rows).
    circuit, circuit_d, local, scc_mask, frozen = sweep_problem(json.dumps(synth.benchmark_fbas(256, 34)))
    lo_nodes = np.asarray(local[1:31], dtype=np.int32)
    hi_row = np.zeros(circuit.n, dtype=np.int32)
    for j, v in enumerate(local[31:]):
        hi_row[v] = (5 >> j) & 1
    start, hi_bits = 1 << 20, mask_bits(hi_row)
    k1_bound_ms, bound_by, _ = window_bound_ms(circuit, circuit_d, lo_nodes, scc_mask, frozen, start, hi_row,
                                               device)
    k1 = FusedSweep(circuit, lo_nodes, scc_mask, frozen, WINDOW // 8, circuit_d, device)
    want = int(k1.program(start, 8, hi_bits))
    k1_arms = {"k1": lambda: k1.program(start, 8, hi_bits)}
    if k1_parent is not None:
        parent = ParentK1(k1_parent, work)
        k1_arms["parent"] = lambda: parent.program(k1, start, 8, hi_bits)
        if int(k1_arms["parent"]()) != want:
            fail("mesh", f"the parent's K1 on the timed window: {int(k1_arms['parent']())} != {want}")
    k1_turns = {f"{who}{suffix}": [] for who in k1_arms for suffix in ("", "_device")}
    for who in (("k1", "k1") if k1_parent is None else ("parent", "k1", "k1", "parent")):
        k1_turns[who].append(time_ms(k1_arms[who], 50))
        k1_turns[f"{who}_device"].append(device_ms(k1_arms[who], 10))
    window_rows = {}
    for label, devices in [(f"{r} ranks, 1 card", [card0] * r) for r in (1, 2, 4)] + (
            [("4 ranks, 4 cards", [torch.device("cuda", i) for i in range(4)])] if cards >= 4 else []):
        sharded = mesh_sweep(devices, circuit, circuit_d, lo_nodes, scc_mask, frozen, WINDOW // 8 // len(devices))
        got = int(sharded.program(start, 8, hi_bits))
        if got != want:
            fail("mesh", f"the timed window on {label}: {got} != K1's {want}")
        used = len(sharded.cards.devices)
        window_rows[label] = {"hit": got, "ms": time_ms(lambda: sharded.program(start, 8, hi_bits), 50),
                              "device_ms": device_ms(lambda: sharded.program(start, 8, hi_bits), 10),
                              "bound_ms": k1_bound_ms / used, "bound_by": bound_by, "cards": used}
    if cards < 4:
        window_rows["4 ranks, 4 cards"] = "not measured (one card)"
    plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, WINDOW // 8, circuit_d, device)
    plain_ms = time_ms(lambda: plain.program(start, 8, hi_row), 2)
    phase_line("mesh_timing", card=card, window=WINDOW, per_window=window_rows, plain_ms=plain_ms,
               k1_window=k1_turns, k1_window_bound_ms=k1_bound_ms,
               k1_turns="parent, this, this, parent" if k1_parent is not None else "this tree only")

    # 5. More than one card: the full width on 1, 2 and 4 of them (one
    # process driving the cards), and on candidate_mesh() over all.
    if cards >= 2:
        multi = []
        data = synth.benchmark_fbas(256, 34)
        for n_cards in sorted({1, 2, min(4, cards), cards}):
            mesh = candidate_mesh(n_cards)
            sweep_mesh.launches = programs[0] = 0
            ShardedSweep.program = counted_program
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = solve(data, backend=GpuSweepBackend(mesh=mesh), with_cert=False)
            seconds = time.perf_counter() - t
            ShardedSweep.program = sharded_program
            if res.intersects is not True or sweep_mesh.launches != programs[0] * n_cards:
                fail("mesh", f"full width on {n_cards} cards: intersects={res.intersects}, K11 "
                             f"{sweep_mesh.launches} launches for {programs[0]} programs")
            multi.append({"cards": n_cards, "seconds": seconds, "k11_launches": sweep_mesh.launches,
                          "programs": programs[0], "mesh": res.stats["mesh"]})
        phase_line("mesh_cards", card=card, cards=cards, full_width_correct=multi)
    else:
        phase_line("mesh_cards", card=card, cards=cards,
                   skipped="one card: the full width on 2 and 4 cards needs a host with them")

    phase_line("mesh", card=card, seconds=round(time.perf_counter() - t_phase, 3))
    nccl_ms = [r["all_reduce_ms"] for r in (four or world1)]
    one_card = window_rows[f"{MESH_SOLVE_RANKS} ranks, 1 card"]
    return {
        "name": "sweep_mesh_cuda",
        "route": "cuda",
        "source": f"{PORT}/kernels/csrc/sweep.cu",
        "replaces": "quorum_intersection_tpu/backends/tpu/sweep.py:2196",
        "launches": k11_launches,
        "max_abs_err": max_err,
        "ms": one_card["ms"],
        "device_ms": one_card["device_ms"],
        "plain_ms": plain_ms,
        "bound_ms": one_card["bound_ms"],
        "bound_by": one_card["bound_by"],
        "library_ms": None,
        "k1_window": k1_turns,
        "nccl_all_reduce_ms": max(nccl_ms),
        "nccl_all_reduce_of": "all_reduce(MIN) of one int32, " + (
            "4 processes on 4 cards" if four else "a world-size-1 group on the one card"),
        "window_ms": window_rows,
        "main_path_launches_of": "mesh_full: the full-width twins on 4 ranks of one card",
    }


FRONTIER_MESH_RANKS = (1, 2, 4)  # ranks on the one card in the iteration instance's checks
FRONTIER_MESH_WORKER = r"""
import json, os, sys, time
import torch
from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
from quorum_intersection_tpu_torch.fbas import synth
from quorum_intersection_tpu_torch.kernels import frontier_cuda
from quorum_intersection_tpu_torch.parallel import distributed
from quorum_intersection_tpu_torch.parallel.mesh import collective_of
from quorum_intersection_tpu_torch.pipeline import solve
port, backend = sys.argv[1], sys.argv[4]
pid, nprocs, card, ranks = map(int, sys.argv[2:4] + sys.argv[5:7])
torch.cuda.set_device(card)
distributed.initialize(f"127.0.0.1:{port}", num_processes=nprocs, process_id=pid, local_device_ids=[card],
                       backend=backend)
mesh = distributed.global_candidate_mesh(devices=[torch.device("cuda", card)] * ranks)
assert mesh.process_count == nprocs, mesh
out = {"process_index": mesh.process_index, "process_count": mesh.process_count, "ranks": mesh.size,
       "collective": collective_of(mesh), "solves": {}}
for label, data in (("hierarchical_fbas(6,4)", synth.hierarchical_fbas(6, 4)),
                    ("stellar_like_fbas(16,3,broken)", synth.stellar_like_fbas(16, 3, broken=True)),
                    ("stellar_like_fbas(42,3,broken)", synth.stellar_like_fbas(42, 3, broken=True)),
                    ("stellar_like_fbas(60,3,broken)", synth.stellar_like_fbas(60, 3, broken=True)),
                    ("stellar_like_fbas(85,3,broken)", synth.stellar_like_fbas(85, 3, broken=True))):
    for name in frontier_cuda.LAUNCHES:
        frontier_cuda.LAUNCHES[name] = 0
    t = time.perf_counter()
    res = solve(data, backend=GpuFrontierBackend(mesh=mesh), with_cert=False)
    out["solves"][label] = {"intersects": res.intersects, "q1": res.q1, "q2": res.q2,
                            **{k: res.stats.get(k) for k in ("states_popped", "device_iters", "device_chunks",
                                                             "flagged", "minimal_quorums")},
                            "seconds": time.perf_counter() - t, "launches": dict(frontier_cuda.LAUNCHES),
                            "mesh": res.stats.get("mesh")}
torch.distributed.destroy_process_group()
print(json.dumps(out), flush=True)
"""
# The mesh phase's networks of two, three and four words a state: the
# broken stellar_like_fbas(orgs, 3) by words.
FRONTIER_MESH_WORDS = {2: 42, 3: 60, 4: 85}


def broken_stellar(synth, orgs):
    """``(label, source)`` of the broken stellar_like_fbas(orgs, 3)."""
    return f"stellar_like_fbas({orgs},3,broken)", synth.stellar_like_fbas(orgs, 3, broken=True)
FRONTIER_MESH_KEYS = ("states_popped", "device_iters", "device_chunks", "flagged", "minimal_quorums", "host_checks",
                      "device_flag_checks", "spills", "discarded_chunks")


NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink to the host's other cards, each way


def frontier_mesh_phase(device, card, texts, cert_jobs, work):
    """Phase frontier_mesh: K9's two instances under a mesh.  The mesh-chunk
    instance (a one-process mesh: one cooperative launch a chunk and a card)
    against its plain version ``mesh_chunk_ref`` chunk for chunk, stash
    included, and the iteration instance (joined processes) against its
    plain version rank by rank, on 1, 2 and 4 ranks of the one card (and
    across cards where there are several); GpuFrontierBackend on a 4-rank
    mesh of the card (and on 4 cards) against K9's single-card solve at the
    JAX constants, only the mesh-chunk instance launched; ``--backend
    gpu-frontier --mesh all --cert-out`` as a CLI process; two processes
    joined by ``distributed.initialize`` (gloo on one card, NCCL on two),
    which run the iteration instance; each instance's time an iteration on
    1, 2 and 4 ranks (and 4 cards) beside K9's, its 33 iterations held to
    K9's 33-iteration chunk, the gather alone, the launches.  Returns the
    kernels line's records: the mesh-chunk instance's, the iteration
    instance's."""
    import threading

    import torch

    from quorum_intersection_tpu_torch.backends.frontier import GpuFrontierBackend
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.fbas.semantics import is_quorum
    from quorum_intersection_tpu_torch.kernels import frontier_cuda
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import (
        CardState,
        IterationState,
        frontier_mesh_chunk,
        gather_shares,
        iteration_launcher,
        mesh_chunk,
        mesh_chunk_status,
    )
    from quorum_intersection_tpu_torch.kernels.frontier_ref import share_slots
    from quorum_intersection_tpu_torch.parallel import candidate_mesh
    from quorum_intersection_tpu_torch.pipeline import solve

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_frontier_blocks import mesh_chunk_lockstep, mesh_lockstep

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    card0 = torch.device("cuda", 0)
    # (c, d) The processes, in a thread while the comparison runs (nothing
    # of it is timed): the CLI
    # under --mesh all, then two processes of two ranks (NCCL on two cards,
    # gloo on the one: NCCL refuses two ranks on one device).
    pair_backend = "nccl" if cards >= 2 else "gloo"
    port = mesh_free_port()
    pair_cmds = [[sys.executable, "-c", FRONTIER_MESH_WORKER, str(port), str(pid), "2", pair_backend,
                  str(pid if cards >= 2 else 0), "2"] for pid in (0, 1)]
    cli_cert = work / "frontier_mesh.cert.json"
    cli_src = synth.stellar_like_fbas(16, 3, broken=True)
    cli_cmd = [sys.executable, "-m", PORT, "--backend", "gpu-frontier", "--mesh", "all", "--cert-out", str(cli_cert)]
    procs = {}

    def run_procs():
        procs["cli"] = run_all([cli_cmd], inputs=[raw_json(cli_src)], timeout=600)[0]
        procs["pair"] = run_all(pair_cmds, inputs=[None, None], parallel=2, timeout=600)

    proc_thread = threading.Thread(target=run_procs)
    proc_thread.start()

    # (a) Both instances against their plain versions, chunk for chunk.
    # (label, source, arena, pop, chunks, chunk_iters)
    cases = [("hierarchical_fbas(8,4) defaults, 3 chunks", synth.hierarchical_fbas(8, 4), 1 << 18, 2048, 3, 512),
             ("random_fbas(64,seed=0) defaults, 2 chunks of 64 iterations", synth.random_fbas(64, seed=0), 1 << 18,
              2048, 2, 64),
             ("hierarchical_fbas(4,3) spill, 8 chunks", synth.hierarchical_fbas(4, 3), 64, 16, 8, 512),
             # Two words a state: 126 lanes padded to 128; three and four,
             # over two node k-slabs: 180 lanes padded to 192, 255 to 256.
             ("stellar_like_fbas(42,3,broken) defaults, 2 chunks", synth.stellar_like_fbas(42, 3, broken=True),
              1 << 18, 2048, 2, 512),
             ("stellar_like_fbas(60,3,broken) defaults, 1 chunk of 33 iterations",
              synth.stellar_like_fbas(60, 3, broken=True), 1 << 18, 2048, 1, 33),
             ("stellar_like_fbas(85,3,broken) defaults, 2 chunks of 64 iterations",
              synth.stellar_like_fbas(85, 3, broken=True), 1 << 18, 2048, 2, 64)]
    compare_rows, mismatches, all_flags = {}, [], 0
    for label, src, arena, pop, chunks, chunk_iters in cases:
        prob, shape, kern, plain = frontier_setup(src, device, arena, pop, chunk_iters=chunk_iters)
        for ranks in FRONTIER_MESH_RANKS:
            for instance, lockstep in (("chunk", mesh_chunk_lockstep), ("iteration", mesh_lockstep)):
                done, iters, flags, launches, bad, reasons, tops = lockstep(prob, shape, kern, plain, ranks, chunks)
                compare_rows[f"{label}, {ranks} ranks, {instance} instance"] = {
                    "s": prob.s, "s_dev": prob.s_dev, "pop": shape.K, "arena": arena, "chunks": done,
                    "iterations": iters, "flags": flags, "launches": launches, "tops": tops, "exits": reasons,
                    "instance": instance_of(kern), "equal": not bad}
                mismatches += [f"{label}, {ranks} ranks, {instance} instance: {b}" for b in bad]
                all_flags += flags
                if not bad and iters < 2:
                    mismatches.append(f"{label}, {ranks} ranks, {instance} instance: {iters} iterations")
    if not all_flags:
        mismatches.append("no case wrote a flag")
    if cards >= 2:
        # The cards: the mesh-chunk instance against its plain version over
        # two default chunks, then one default chunk of each instance
        # against K9's.
        prob, shape, kern, plain = frontier_setup(cases[0][1], device, 1 << 18, 2048)
        devices = [torch.device("cuda", i) for i in range(min(cards, 4))]
        kerns = {d: kern if d == card0 else frontier_cuda.FrontierKernels(
            prob.circuit, prob.scc_dev, prob.a_scc, shape, prob.probe_circuit, prob.frozen, device=d) for d in devices}
        n = len(devices)
        done, iters, flags, launches, bad, reasons, tops = mesh_chunk_lockstep(prob, shape, kern, plain, n, 2,
                                                                               kerns=kerns, devices=devices)
        compare_rows[f"hierarchical_fbas(8,4) defaults, 2 chunks, {n} cards, chunk instance"] = {
            "chunks": done, "iterations": iters, "flags": flags, "launches": launches, "tops": tops, "equal": not bad}
        mismatches += [f"{n} cards, chunk instance: {b}" for b in bad]
        want_pair = (frontier_seed(kern, prob), kern.arena())
        frontier_cuda.frontier_chunk(kern, *want_pair, 512)
        i_states = [IterationState.empty(shape.K, n, frontier_seed(kerns[d], prob), kerns[d].arena()) for d in devices]
        mesh_chunk(candidate_mesh(n), [kerns[d] for d in devices], i_states, 512)
        c_states = [CardState.empty(shape.K, n, (r,), frontier_seed(kerns[d], prob), kerns[d].arena())
                    for r, d in enumerate(devices)]
        frontier_mesh_chunk([kerns[d] for d in devices], c_states, 512)
        mesh_chunk_status(c_states)
        for d in devices:
            torch.cuda.synchronize(d)
        top, fcount = want_pair[1].ctr.tolist()[:2]
        for instance, states in (("iteration", i_states), ("chunk", c_states)):
            same = all(st.dst.ctr.tolist() == want_pair[1].ctr.tolist()
                       and torch.equal(st.dst.T[:top].to(card0), want_pair[1].T[:top])
                       and torch.equal(st.dst.D[:top].to(card0), want_pair[1].D[:top])
                       and torch.equal(st.dst.flags[:fcount].to(card0), want_pair[1].flags[:fcount]) for st in states)
            compare_rows[f"hierarchical_fbas(8,4), one chunk on {n} cards, {instance} instance, against K9"] = {
                "equal": same}
            if not same:
                mismatches.append(f"{n} cards, {instance} instance: the chunk differs from K9's")
    if mismatches:
        fail("frontier_mesh", "; ".join(mismatches[:6]))
    phase_line("frontier_mesh_compare", card=card, tolerance="exact (integer arena rows, counters, flags and stash)",
               ranks=list(FRONTIER_MESH_RANKS), cases=compare_rows,
               across_cards="compared" if cards >= 2 else "not run (one card)")

    # (c, d) The processes' results, against single-process solves here.
    proc_thread.join()
    single = {}
    for label, src in (("hierarchical_fbas(6,4)", synth.hierarchical_fbas(6, 4)),
                       ("stellar_like_fbas(16,3,broken)", synth.stellar_like_fbas(16, 3, broken=True)),
                       *[broken_stellar(synth, orgs) for orgs in FRONTIER_MESH_WORDS.values()]):
        res = solve(src, backend=GpuFrontierBackend(), with_cert=False)
        single[label] = {"intersects": res.intersects, "q1": res.q1, "q2": res.q2,
                         **{k: res.stats.get(k) for k in FRONTIER_MESH_KEYS[:5]}}
    out, err, code, cli_s = procs["cli"]
    if out.strip().splitlines()[-1:] != ["false"] or code != 1:
        fail("frontier_mesh", f"--backend gpu-frontier --mesh all CLI: {out[-40:]!r} exit {code}; {err[-600:]!r}")
    cert_jobs.append(("frontier_mesh/cli/stellar_like_fbas(16,3,broken)", cli_src, json.loads(cli_cert.read_text())))
    pair = mesh_worker_results(f"frontier, two processes ({pair_backend})", procs["pair"])
    pair_launches, pair_words_launches = 0, {w: 0 for w in FRONTIER_MESH_WORDS}
    for row in pair:
        for label, want_row in single.items():
            s = row["solves"][label]
            if {k: s[k] for k in want_row} != want_row:
                fail("frontier_mesh", f"two processes, process {row['process_index']}, {label}: {s} != the "
                                      f"single-process solve {want_row}")
            if s["launches"]["frontier_iteration"] < 1 or s["launches"]["frontier_chunk"] \
                    or s["launches"]["frontier_mesh_chunk"] or s["mesh"]["instance"] != "iteration":
                fail("frontier_mesh", f"two processes, {label}: launches {s['launches']}, mesh {s['mesh']}")
            pair_launches += s["launches"]["frontier_iteration"]
            for w, orgs in FRONTIER_MESH_WORDS.items():
                if label == broken_stellar(synth, orgs)[0]:
                    pair_words_launches[w] += s["launches"]["frontier_iteration"]
    phase_line("frontier_mesh_processes", card=card,
               cli={"argv": "--backend gpu-frontier --mesh all --cert-out", "network": "stellar_like_fbas(16,3,broken)",
                    "exit": code, "process_seconds": cli_s},
               pair={"backend": pair_backend, "host_copy": pair_backend == "gloo", "rows": pair,
                     "iteration_launches": pair_launches},
               verdicts="every process's verdict, witness and counts equal to the single-process solve's; "
                        "the iteration instance alone launched")

    # (b) GpuFrontierBackend on a 4-rank mesh of the card (and on 4 cards)
    # against K9's single-card solve, at the JAX constants (pop 2048 splits
    # over 4): the mesh-chunk instance alone, one launch a chunk and a card.
    meshes = [("4 ranks, 1 card", candidate_mesh(devices=[card0] * 4), 1)]
    if cards >= 4:
        meshes.append(("4 cards", candidate_mesh(4), 4))
    solve_rows, launches = {}, {name: 0 for name in frontier_cuda.LAUNCHES}
    words_launches = {w: dict(launches) for w in FRONTIER_MESH_WORDS}
    for label, src in (("hierarchical_fbas(8,4)", synth.hierarchical_fbas(8, 4)),
                       ("stellar_like_fbas(16,3,broken)", synth.stellar_like_fbas(16, 3, broken=True)),
                       *[broken_stellar(synth, orgs) for orgs in FRONTIER_MESH_WORDS.values()]):
        # In turns: K9, each mesh, each mesh again, K9; none builds a
        # certificate (the certified solves come after).
        single_s, mesh_s = [], {where: [] for where, _, _ in meshes}

        def k9_solve():
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = solve(src, backend=GpuFrontierBackend(), with_cert=False)
            single_s.append(time.perf_counter() - t)
            return res

        want = k9_solve()
        for turn in range(2):
            for where, mesh, n_cards in meshes:
                zero_script_launches()
                for d in set(mesh.devices):
                    torch.cuda.synchronize(d)
                t = time.perf_counter()
                res = solve(src, backend=GpuFrontierBackend(mesh=mesh), with_cert=False)
                mesh_s[where].append(time.perf_counter() - t)
                got_launches = dict(frontier_cuda.LAUNCHES)
                for name, n in got_launches.items():
                    launches[name] += n
                    for w, orgs in FRONTIER_MESH_WORDS.items():
                        if label == broken_stellar(synth, orgs)[0]:
                            words_launches[w][name] += n
                # A launch a card for every chunk dispatched: the drained
                # ones and the ones the drive dropped (its speculative chunks).
                chunks = res.stats["device_chunks"] + res.stats["discarded_chunks"]
                if got_launches["frontier_iteration"] or got_launches["frontier_chunk"] \
                        or got_launches["frontier_mesh_chunk"] != chunks * n_cards \
                        or res.stats["mesh"]["instance"] != "chunk" \
                        or res.stats["mesh"]["chunk_launches"] != chunks * n_cards:
                    fail("frontier_mesh", f"{label} on {where}: launches {got_launches} for {chunks} chunks, "
                                          f"mesh {res.stats['mesh']}")
                if (res.intersects, res.q1, res.q2) != (want.intersects, want.q1, want.q2):
                    fail("frontier_mesh", f"{label} on {where}: the mesh solve says {res.intersects} {res.q1} "
                                          f"{res.q2}, K9's {want.intersects} {want.q1} {want.q2}")
                counts = {k: res.stats.get(k) for k in FRONTIER_MESH_KEYS}
                if counts != {k: want.stats.get(k) for k in FRONTIER_MESH_KEYS}:
                    fail("frontier_mesh", f"{label} on {where}: counts {counts} != K9's "
                                          f"{({k: want.stats.get(k) for k in FRONTIER_MESH_KEYS})}")
                if not res.intersects:
                    graph = build_graph(parse_fbas(raw_json(src)))
                    if not (is_quorum(graph, res.q1) and is_quorum(graph, res.q2) and not set(res.q1) & set(res.q2)):
                        fail("frontier_mesh", f"{label} on {where}: the witness pair is not two disjoint quorums")
                solve_rows[f"{label}, {where}"] = {
                    "verdict": res.intersects, **counts, "launches": got_launches, "mesh": res.stats["mesh"],
                    "single_card_chunk_launches": want.stats["device_chunks"] + want.stats["discarded_chunks"]}
            if turn:
                k9_solve()
        for where, mesh, _ in meshes:
            solve_rows[f"{label}, {where}"].update(mesh_seconds=mesh_s[where], single_card_seconds=single_s,
                                                   order="K9, the meshes, the meshes, K9")
            # Once more with its certificate, as the CLI builds it.
            cert_res = solve(src, backend=GpuFrontierBackend(mesh=mesh))
            if (cert_res.intersects, cert_res.q1, cert_res.q2) != (want.intersects, want.q1, want.q2):
                fail("frontier_mesh", f"{label} on {where}: the certified solve disagrees with K9's")
            cert_jobs.append((f"frontier_mesh/solve/{label}/{where}", src, cert_res.cert))
    phase_line("frontier_mesh_solves", card=card, runs=solve_rows, launches=launches,
               verdicts="verdict, witness pair and counts equal to K9's single-card solve; only the mesh-chunk "
                        "instance launched, once a dispatched chunk and a card")

    # (e) An iteration's time at hier-8x4's shape (s 32, K 2048) on 1, 2 and
    # 4 ranks of the card (and 4 cards), both instances, from
    # timing_frontier's mid-search state, beside K9's per iteration in this
    # call, the plain versions, the gather alone and the bound (one
    # iteration's share of K9's chunk bound).
    prob, shape, kern, plain = frontier_setup(synth.hierarchical_fbas(8, 4), device, 1 << 18, 2048)
    state, top, _ = k9_timing_state(kern, prob, shape)
    far = shape.flag_cap - shape.K

    def k9(iters):
        kern.shape.chunk_iters = iters
        frontier_cuda.frontier_chunk(kern, state, k9_dst, far)

    k9_dst = kern.arena()
    k9_1, k9_33 = time_ms(lambda: k9(1), 20), time_ms(lambda: k9(33), 10)
    k9_d1, k9_d33 = device_ms(lambda: k9(1), 10), device_ms(lambda: k9(33), 10)
    k9(33)
    want33 = [t.clone() for t in (k9_dst.ctr, k9_dst.T, k9_dst.D, k9_dst.flags)]
    p_top, p_fc = int(want33[0][0]), int(want33[0][1])
    layouts = [(f"{r} ranks, 1 card", [card0] * r) for r in FRONTIER_MESH_RANKS]
    if cards >= 4:
        layouts.append(("4 ranks, 4 cards", [torch.device("cuda", i) for i in range(4)]))
    kerns_on = {card0: kern}

    def equal_to_k9(label, instance, dst):
        got = [t.to(card0) for t in (dst.ctr, dst.T[:p_top], dst.D[:p_top], dst.flags[:p_fc])]
        if got[0].tolist() != want33[0].tolist() or not (
                torch.equal(got[1], want33[1][:p_top]) and torch.equal(got[2], want33[2][:p_top])
                and torch.equal(got[3], want33[3][:p_fc])):
            fail("frontier_mesh", f"{label}, {instance} instance: the timed 33 iterations differ from K9's "
                                  f"33-iteration chunk ({got[0].tolist()} against {want33[0].tolist()})")

    chunk_timing, timing, gather, gather_alone = {}, {}, {}, {}
    chunk_plain_ms = plain_ms = None
    for label, devices in layouts:
        mesh = candidate_mesh(devices=devices)
        ranks = mesh.size
        for d in mesh.devices:
            if d not in kerns_on:
                kerns_on[d] = frontier_cuda.FrontierKernels(prob.circuit, prob.scc_dev, prob.a_scc, shape,
                                                            prob.probe_circuit, prob.frozen, device=d)
        srcs = {d: state if d == card0 else frontier_cuda.ArenaSet(*(getattr(state, f).to(d) for f in
                                                                     ("T", "D", "flags", "ctr")))
                for d in mesh.devices}

        def sync():
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)

        # The mesh-chunk instance: one launch a card for the whole chunk.
        cards_of = frontier_cuda.mesh_cards(mesh.devices)
        c_kerns = [kerns_on[d] for d, _ in cards_of]
        c_states = [CardState.empty(shape.K, ranks, mine, srcs[d], kerns_on[d].arena()) for d, mine in cards_of]

        def chunk(iters):
            for k in c_kerns:
                k.shape.chunk_iters = iters
            frontier_mesh_chunk(c_kerns, c_states, far)

        t1, t33 = time_ms(lambda: chunk(1), 20), time_ms(lambda: chunk(33), 10)
        d1, d33 = device_ms(lambda: chunk(1), 10), device_ms(lambda: chunk(33), 10)
        chunk(33)
        sync()
        mesh_chunk_status(c_states)
        for st in c_states:
            equal_to_k9(label, "chunk", st.dst)
        chunk_timing[label] = {"ms_1_iteration": t1, "ms_33_iterations": t33, "ms_per_iteration": (t33 - t1) / 32,
                               "ms_per_iteration_device_alone": (d33 - d1) / 32, "launches_per_chunk": len(c_states),
                               "cards": len(c_states)}
        if label == "4 ranks, 1 card":
            # The plain version of the same 33 iterations on the 4 ranks,
            # its stash held to the kernel's.
            p_state = CardState.empty(shape.K, ranks, range(ranks), state, kern.arena())
            kern.shape.chunk_iters = 33
            torch.cuda.synchronize()
            t = time.perf_counter()
            plain.mesh_chunk(p_state, far)
            torch.cuda.synchronize()
            chunk_plain_ms = (time.perf_counter() - t) * 1e3 / 33
            equal_to_k9(label, "plain mesh-chunk", p_state.dst)
            if not torch.equal(p_state.stash, c_states[0].stash):
                fail("frontier_mesh", f"{label}: the timed chunk's stash differs from mesh_chunk_ref's")

        # The iteration instance: a launch a rank and a gather an iteration.
        kerns = [kerns_on[d] for d in mesh.devices]
        states = [IterationState.empty(shape.K, ranks, srcs[d], k.arena()) for d, k in zip(mesh.devices, kerns)]

        def iterations(iters):
            # iters iterations and the launch that ends the chunk, enqueued
            # without a read through the launches mesh_chunk prepares once a
            # chunk.
            for k in kerns:
                k.shape.chunk_iters = iters
            for st in states:
                st.begin(st.src, st.dst)
            steps = [iteration_launcher(k, st, r, ranks, far) for r, (k, st) in enumerate(zip(kerns, states))]
            for step in range(iters + 1):
                for launch in steps:
                    launch()
                gather_shares(mesh, states, shape.K, step & 1)

        t1, t33 = time_ms(lambda: iterations(1), 20), time_ms(lambda: iterations(33), 10)
        # Behind a longer spin than device_ms's default: the host enqueues
        # up to 34 launches a rank and 34 gathers a call.
        d1 = device_ms(lambda: iterations(1), 10, spin_cycles=40_000_000)
        d33 = device_ms(lambda: iterations(33), 10, spin_cycles=40_000_000)
        iterations(33)
        sync()
        for st in states:
            equal_to_k9(label, "iteration", st.dst)
        timing[label] = {"ms_1_iteration": t1, "ms_33_iterations": t33, "ms_per_iteration": (t33 - t1) / 32,
                         "ms_per_iteration_device_alone": (d33 - d1) / 32, "launches_per_iteration": ranks,
                         "gathers_per_iteration": 1, "cards": len(set(mesh.devices))}
        if ranks > 1:
            # The gather alone, by the cards' events (time_ms's events are on
            # the current card's stream, which every copy joins).
            gather[label] = time_ms(lambda: gather_shares(mesh, states, shape.K, 0), MESH_COLLECTIVE_REPS)
            gather_alone[label] = device_ms(lambda: gather_shares(mesh, states, shape.K, 0), 20)
        if label == "4 ranks, 1 card":
            # The plain version of the same 33 iterations on 4 ranks.
            for st in states:
                st.begin(state, st.dst)
            kern.shape.chunk_iters = 33
            torch.cuda.synchronize()
            t = time.perf_counter()
            mesh_chunk(mesh, [plain] * ranks, states, far, iterate=lambda k, st, r, n, fe: k.iteration(st, r, n, fe))
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3 / 33
    if cards < 4:
        chunk_timing["4 ranks, 4 cards"] = timing["4 ranks, 4 cards"] = "not measured (one card)"
    for k in kerns_on.values():
        k.shape.chunk_iters = 512
    _, _, passes, _ = k9_replay(prob, shape, plain, state, top, 33)
    k9_bound_33, bound_by = bound(passes * macs_per_pass(prob.circuit), k9_least_bytes(prob, kern, top, p_top, p_fc))
    per_iteration_bound = k9_bound_33 / 33
    # On 4 cards each card also sends its share, 18 Ks bytes, to each of
    # the 3 others an iteration, over NVLink.
    nvlink_ms = 3 * 18 * share_slots(shape.K, 4)[1] / NVLINK_BYTES_PER_S * 1e3
    k9_row = {"ms_per_iteration": (k9_33 - k9_1) / 32, "ms_per_iteration_device_alone": (k9_d33 - k9_d1) / 32}
    phase_line("frontier_mesh_timing", card=card, shape=f"hierarchical_fbas(8,4): s={prob.s} (s_dev {prob.s_dev}), "
                                                        f"K={shape.K}, C={shape.C}, top {top} at the timed state",
               chunk_instance=chunk_timing, iteration_instance=timing, k9=k9_row,
               plain_ms_per_iteration_4_ranks={"chunk instance (mesh_chunk_ref)": chunk_plain_ms,
                                               "iteration instance (share_iteration lockstep)": plain_ms},
               gather_ms=gather, gather_ms_device_alone=gather_alone,
               k9_bound_ms_per_iteration=per_iteration_bound, bound_ms_a_rank_of_4=per_iteration_bound / 4,
               nvlink_share_ms_per_iteration_4_cards=nvlink_ms, bound_by=bound_by)
    wide = {}
    for w, orgs in FRONTIER_MESH_WORDS.items():
        wide[w] = mesh_wide_timing(device, synth, orgs)
        phase_line(f"frontier_mesh_timing_w{w}", card=card, **wide[w])
    phase_line("frontier_mesh", card=card, seconds=round(time.perf_counter() - t_phase, 3))
    four, chunk_four = timing["4 ranks, 1 card"], chunk_timing["4 ranks, 1 card"]
    chunk_record = {
        "name": "frontier_mesh_chunk_cuda",
        "route": "cuda",
        "source": f"{PORT}/kernels/csrc/frontier.cu",
        "replaces": "quorum_intersection_tpu/backends/tpu/frontier.py:351",
        "launches": launches["frontier_mesh_chunk"],
        "max_abs_err": 0,
        "ms": chunk_four["ms_per_iteration"],
        "ms_of": "one iteration on 4 ranks of the one card (one launch a chunk), hier-8x4's shape",
        "plain_ms": chunk_plain_ms,
        "bound_ms": per_iteration_bound,
        "bound_of": "one iteration's work, all 4 ranks' shares on the one card (K9's per-iteration bound); on 4 "
                    "cards also each card's share to the 3 others over NVLink (bound_ms_4_cards)",
        "bound_ms_4_cards": max(per_iteration_bound, nvlink_ms),
        "bound_by": bound_by,
        "library_ms": None,
        "per_ranks": chunk_timing,
        "k9_ms_per_iteration": k9_row["ms_per_iteration"],
        "iteration_instance_ms_per_iteration": four["ms_per_iteration"],
        "main_path_launches_of": "frontier_mesh_solves: hier-8x4 and stellar 16x3 broken on 4 ranks of one card"
                                 + (" and on 4 cards" if cards >= 4 else ""),
    }
    iteration_record = {
        "name": "frontier_iteration_cuda",
        "route": "cuda",
        "source": f"{PORT}/kernels/csrc/frontier.cu",
        "replaces": "quorum_intersection_tpu/backends/tpu/frontier.py:351",
        "launches": pair_launches,
        "max_abs_err": 0,
        "ms": four["ms_per_iteration"],
        "ms_of": "one iteration on 4 ranks of the one card (4 launches and a gather), hier-8x4's shape",
        "plain_ms": plain_ms,
        "bound_ms": per_iteration_bound,
        "bound_of": "one iteration's work, all 4 ranks' shares on the one card (K9's per-iteration bound); "
                    "a rank's share is bound_ms / 4",
        "bound_by": bound_by,
        "library_ms": None,
        "gather_ms": gather["4 ranks, 1 card"],
        "gather_of": "mesh_all_gather of 4 ranks' stash shares on the one card (gather_shares)",
        "per_ranks": timing,
        "k9_ms_per_iteration": k9_row["ms_per_iteration"],
        "main_path_launches_of": "frontier_mesh_processes: hier-6x4 and stellar 16x3 and 42x3 broken in the two "
                                 "joined processes, both processes",
    }
    wide_records = []
    for w, orgs in FRONTIER_MESH_WORDS.items():
        label = broken_stellar(synth, orgs)[0]
        if words_launches[w]["frontier_mesh_chunk"] < 1 or pair_words_launches[w] < 1:
            fail("frontier_mesh", f"{label}: the main path launched the mesh-chunk instance "
                                  f"{words_launches[w]['frontier_mesh_chunk']} times, the iteration instance "
                                  f"{pair_words_launches[w]} times")
        for base, row, n in ((chunk_record, wide[w]["chunk_instance"], words_launches[w]["frontier_mesh_chunk"]),
                             (iteration_record, wide[w]["iteration_instance"], pair_words_launches[w])):
            wide_records.append({**{k: base[k] for k in ("route", "source", "replaces", "max_abs_err",
                                                          "library_ms")},
                                 "name": f"{base['name']}_w{w}", "launches": n, "ms": row["ms_per_iteration"],
                                 "plain_ms": row["plain_ms_per_iteration"],
                                 "bound_ms": wide[w]["k9_bound_ms_per_iteration"], "bound_by": wide[w]["bound_by"],
                                 "ms_of": f"one iteration on 4 ranks of the one card at {wide[w]['shape']}",
                                 "launches_of": ("frontier_mesh_solves" if base is chunk_record else
                                                 "frontier_mesh_processes") + f": {label}"})
    return [chunk_record, iteration_record, *wide_records]


def mesh_wide_timing(device, synth, orgs=42):
    """Both mesh instances past one word a state, on 4 ranks of the one
    card, at broken stellar_like_fbas(orgs,3)'s shape (42: 126 lanes padded
    to 128; 60: 180 padded to 192; 85: 255 padded to 256; K 2048), from its
    state 40 iterations after the seed: ms an iteration (1- and 33-iteration
    chunks), the 33 iterations held to K9's chunk, the plain versions' ms an
    iteration, K9's per-iteration bound."""
    import torch

    from quorum_intersection_tpu_torch.kernels import frontier_cuda
    from quorum_intersection_tpu_torch.kernels.frontier_cuda import (
        CardState,
        IterationState,
        frontier_mesh_chunk,
        gather_shares,
        iteration_launcher,
        mesh_chunk,
        mesh_chunk_status,
    )
    from quorum_intersection_tpu_torch.parallel import candidate_mesh

    prob, shape, kern, plain, state, top, far = wide_timed_state(device, synth, "frontier_mesh", orgs)
    want = kern.arena()
    kern.shape.chunk_iters = 33
    frontier_cuda.frontier_chunk(kern, state, want, far)
    torch.cuda.synchronize()
    w_top, w_fc = want.ctr.tolist()[:2]
    ranks = 4
    mesh = candidate_mesh(devices=[device] * ranks)

    def check(label, dst):
        if dst.ctr.tolist() != want.ctr.tolist() or not (
                torch.equal(dst.T[:w_top], want.T[:w_top]) and torch.equal(dst.D[:w_top], want.D[:w_top])
                and torch.equal(dst.flags[:w_fc], want.flags[:w_fc])):
            fail("frontier_mesh", f"{prob.s_dev} lanes, {label}: the 33 iterations differ from K9's chunk "
                                  f"({dst.ctr.tolist()} against {want.ctr.tolist()})")

    card = CardState.empty(shape.K, ranks, range(ranks), state, kern.arena())

    def chunk(iters):
        kern.shape.chunk_iters = iters
        frontier_mesh_chunk([kern], [card], far)

    c1, c33 = time_ms(lambda: chunk(1), 20), time_ms(lambda: chunk(33), 10)
    chunk(33)
    torch.cuda.synchronize()
    mesh_chunk_status([card])
    check("chunk instance", card.dst)
    states = [IterationState.empty(shape.K, ranks, state, kern.arena()) for _ in range(ranks)]

    def iterations(iters):
        kern.shape.chunk_iters = iters
        for st in states:
            st.begin(st.src, st.dst)
        steps = [iteration_launcher(kern, st, r, ranks, far) for r, st in enumerate(states)]
        for step in range(iters + 1):
            for launch in steps:
                launch()
            gather_shares(mesh, states, shape.K, step & 1)

    i1, i33 = time_ms(lambda: iterations(1), 20), time_ms(lambda: iterations(33), 10)
    iterations(33)
    torch.cuda.synchronize()
    for st in states:
        check("iteration instance", st.dst)
    # The plain versions of the same 33 iterations on the 4 ranks.
    kern.shape.chunk_iters = 33
    p_card = CardState.empty(shape.K, ranks, range(ranks), state, kern.arena())
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain.mesh_chunk(p_card, far)
    torch.cuda.synchronize()
    chunk_plain = (time.perf_counter() - t) * 1e3 / 33
    check("plain mesh-chunk", p_card.dst)
    if not torch.equal(p_card.stash, card.stash):
        fail("frontier_mesh", f"{prob.s_dev} lanes: the timed chunk's stash differs from mesh_chunk_ref's")
    for st in states:
        st.begin(state, st.dst)
    t = time.perf_counter()
    mesh_chunk(mesh, [plain] * ranks, states, far, iterate=lambda k, st, r, n, fe: k.iteration(st, r, n, fe))
    torch.cuda.synchronize()
    iteration_plain = (time.perf_counter() - t) * 1e3 / 33
    kern.shape.chunk_iters = 512
    _, _, passes, _ = k9_replay(prob, shape, plain, state, top, 33)
    b_ms, b_by = bound(passes * macs_per_pass(prob.circuit), k9_least_bytes(prob, kern, top, w_top, w_fc))
    return {"shape": f"stellar_like_fbas({orgs},3,broken): s={prob.s} (s_dev {prob.s_dev}), units "
                     f"{prob.circuit.n_units}, K={shape.K}, top {top} at the timed state",
            "ranks": ranks, "iterations": want.ctr.tolist()[2],
            "chunk_instance": {"ms_1_iteration": c1, "ms_33_iterations": c33, "ms_per_iteration": (c33 - c1) / 32,
                               "plain_ms_per_iteration": chunk_plain},
            "iteration_instance": {"ms_1_iteration": i1, "ms_33_iterations": i33, "ms_per_iteration": (i33 - i1) / 32,
                                   "plain_ms_per_iteration": iteration_plain},
            "k9_bound_ms_per_iteration": b_ms / 33, "bound_by": b_by}


def zero_script_launches():
    """This process's kernel launch counts set to 0."""
    from quorum_intersection_tpu_torch.kernels import frontier_cuda
    from quorum_intersection_tpu_torch.kernels.bitset_sweep_cuda import bitset_sweep
    from quorum_intersection_tpu_torch.kernels.guard_cuda import guard_bitset, guard_dense
    from quorum_intersection_tpu_torch.kernels.packed_cuda import packed_sweep_bitset, packed_sweep_dense
    from quorum_intersection_tpu_torch.kernels.pagerank_cuda import pagerank_power
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import sweep_fused, sweep_mesh

    for fn in (sweep_fused, sweep_mesh, packed_sweep_dense, packed_sweep_bitset, bitset_sweep, guard_dense,
               guard_bitset, pagerank_power):
        fn.launches = 0
    for name in frontier_cuda.LAUNCHES:
        frontier_cuda.LAUNCHES[name] = 0


def check_certificates(cert_jobs, work):
    """Every ``(label, source, certificate)`` through the unmodified
    ``tools/check_cert.py`` in a subprocess, from raw JSON: ``(refused,
    [(stdout, stderr, returncode, seconds)])``."""
    cmds = []
    for i, (label, src, doc) in enumerate(cert_jobs):
        if doc is None or doc.get("partial"):
            fail("cert", f"{label}: no verdict certificate")
        cert_file, src_file = work / f"cert{i}.json", work / f"cert{i}.src.json"
        cert_file.write_text(json.dumps(doc))
        src_file.write_text(raw_json(src))
        cmds.append([sys.executable, str(ROOT / "tools" / "check_cert.py"), "-q", str(cert_file), str(src_file)])
    checked = run_all(cmds)
    bad = [(label, rc, se[-300:]) for (label, _, _), (_, se, rc, _) in zip(cert_jobs, checked) if rc != 0]
    return bad, checked


def run_all(cmds, inputs=None, parallel: int = 8, timeout: int = 600, envs=None):
    """Run every command (``envs``: each one's environment, None for this
    process's), at most ``parallel`` at once, each on a thread of its own;
    returns ``[(stdout, stderr, returncode, seconds)]`` in order, each
    process timed from its start to its exit.  A process past ``timeout`` is
    killed (its return code then negative).  Every process started is waited
    for."""
    import threading

    out = [None] * len(cmds)
    slots = threading.Semaphore(parallel)
    started = []

    def run(i):
        with slots:
            t = time.perf_counter()
            proc = subprocess.Popen(cmds[i], cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, env=None if envs is None else envs[i])
            started.append(proc)
            try:
                so, se = proc.communicate(None if inputs is None else inputs[i], timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                so, se = proc.communicate()
                se += f"\n[killed after {timeout} s]"
            out[i] = (so, se, proc.returncode, time.perf_counter() - t)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(cmds))]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        for proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def in_process(main, argv, stdin_text):
    """One CLI entry point called in this process as a process would run
    it: ``stdin_text`` on stdin; returns ``(stdout, stderr, exit code)``."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    real_stdin, sys.stdin = sys.stdin, io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        sys.stdin = real_stdin
    return out.getvalue(), err.getvalue(), rc


def raw_json(src) -> str:
    return src if isinstance(src, str) else json.dumps(src)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke run of the PyTorch/CUDA port.")
    ap.add_argument("--stress", type=int, metavar="N", default=0,
                    help="only build, then launch the dense packed kernel N times on each of "
                         "compare_packed's repeated cases and the warp kernels N times on each of "
                         "compare_warp's (no ok line)")
    ap.add_argument("--frontier", action="store_true",
                    help="only build, then run the frontier's phases (compare_frontier, frontier, "
                         "frontier_route, timing_frontier, frontier_mesh) and check their certificates (no ok line)")
    ap.add_argument("--frontier-parent", metavar="DIR", default=None,
                    help="a checkout (git archive) whose frontier kernels timing_frontier times in turns with this "
                         "tree's at hier-8x4's shape (K9's chunk, the mesh-chunk instance's iteration, K10's body), "
                         "beside both builds' ptxas registers and spills")
    ap.add_argument("--pagerank", action="store_true",
                    help="only build, then run the PageRank phases (compare_pagerank, timing_pagerank, "
                         "pagerank_cli; no ok line)")
    ap.add_argument("--bitset", action="store_true",
                    help="only build, then run the bitset engine's phases (compare_bitset, timing_bitset, "
                         "bitset_route, checkpoint) and check their certificates (no ok line)")
    ap.add_argument("--k8-parent", metavar="DIR", default=None,
                    help="a checkout (git archive) whose bitset sweep kernel timing_bitset times in turns "
                         "with this tree's on every shape")
    ap.add_argument("--observe", action="store_true",
                    help="only build, then run the observability, fault and query phases (observe, faults, "
                         "query) and check their certificates (no ok line)")
    ap.add_argument("--delta", action="store_true",
                    help="only build, then run the incremental re-analysis phase (delta) and check its "
                         "certificates (no ok line)")
    ap.add_argument("--serve", action="store_true",
                    help="only build, then run the serve subcommand's phase (serve) and check its "
                         "certificates (no ok line)")
    ap.add_argument("--fleet", action="store_true",
                    help="only build, then run the replicated serve tier's phase (fleet: streams F1-F3) and "
                         "check its certificates (no ok line)")
    ap.add_argument("--native", action="store_true",
                    help="only build, then run the native host layer's and the tooling's phases (native, tooling) "
                         "and check their certificates (no ok line)")
    ap.add_argument("--mesh", action="store_true",
                    help="only build, then run the mesh phases (mesh, frontier_mesh) and check their "
                         "certificates (no ok line)")
    ap.add_argument("--frontier-mesh", action="store_true",
                    help="only build, then run the frontier's mesh phase (frontier_mesh) and check its certificates "
                         "(no ok line)")
    ap.add_argument("--k1-parent", metavar="DIR", default=None,
                    help="a checkout (git archive) whose fused sweep kernel K1 the mesh phase times in turns with "
                         "this tree's on the mesh window")
    ap.add_argument("--k12-parent", metavar="DIR", default=None,
                    help="a checkout (git archive) whose PageRank kernel timing_pagerank times in turns "
                         "with this tree's, per call and per iteration, beside this tree's launch shapes")
    args = ap.parse_args(argv)
    if not (ROOT / PORT / "kernels" / "csrc" / "sweep.cu").is_file():
        print(f"FAIL setup: {PORT}/ not found beside chip_smoke.py (run from a checkout)")
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    # -- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card, flush=True)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    phase_line("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__,
               cuda=torch.version.cuda, python=sys.version.split()[0])

    # -- 2. build --------------------------------------------------------
    from quorum_intersection_tpu_torch.kernels import build

    t0 = time.perf_counter()
    try:
        built = build.build_all()
    except build.KernelBuildError as exc:
        fail("build", str(exc))
    ptxas = {name: ptxas_instances(b.log) for name, b in built.items()}
    phase_line("build", seconds=round(time.perf_counter() - t0, 3),
               libraries=[str(b.path.relative_to(ROOT)) for b in built.values()], ptxas=ptxas)
    if args.stress:
        t0 = time.perf_counter()
        cases = {**stress_packed(device, args.stress), **stress_warp(device, args.stress)}
        phase_line("stress", card=card, seconds=round(time.perf_counter() - t0, 3), cases=cases)
        return 1 if stress_failed(cases) else 0

    if args.pagerank:
        import tempfile

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        record = pagerank_phases(device, card, texts, work, args.k12_parent)
        record["instances"] = ptxas.get("pagerank")
        print(json.dumps({"kernels": [record]}), flush=True)
        return 0

    if args.observe:
        import tempfile

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        cert_jobs = []
        fault_runs = observe_phase(device, card, texts, manifest, cert_jobs, work, beside=faults_cli_jobs(texts, work))
        faults_phase(device, card, texts, cert_jobs, work, fault_runs)
        query_phase(device, card, texts, cert_jobs, work)
        refused, _ = check_certificates(cert_jobs, work)
        phase_line("cert", card=card, checked=len(cert_jobs), refused=refused)
        return 1 if refused else 0

    if args.serve:
        import tempfile

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        cert_jobs = []
        serve_phase(device, card, texts, manifest, cert_jobs, work)
        refused, _ = check_certificates(cert_jobs, work)
        phase_line("cert", card=card, checked=len(cert_jobs), refused=refused)
        return 1 if refused else 0

    if args.native:
        import tempfile

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        cert_jobs = []
        native_phase(device, card, texts, manifest, cert_jobs, work)
        tooling_phase(device, card, cert_jobs, work)
        refused, _ = check_certificates(cert_jobs, work)
        phase_line("cert", card=card, checked=len(cert_jobs), refused=refused)
        return 1 if refused else 0

    if args.mesh:
        import tempfile

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        cert_jobs = []
        record = mesh_phase(device, card, texts, manifest, cert_jobs, work, args.k1_parent)
        record["instances"] = ptxas.get("sweep")
        frontier_records = frontier_mesh_phase(device, card, texts, cert_jobs, work)
        for entry in frontier_records:
            entry["instances"] = ptxas.get("frontier")
        refused, _ = check_certificates(cert_jobs, work)
        phase_line("cert", card=card, checked=len(cert_jobs), refused=refused)
        print(json.dumps({"kernels": [record, *frontier_records]}), flush=True)
        return 1 if refused else 0

    if args.frontier_mesh:
        import tempfile

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        cert_jobs = []
        records = frontier_mesh_phase(device, card, texts, cert_jobs, work)
        for entry in records:
            entry["instances"] = ptxas.get("frontier")
        refused, _ = check_certificates(cert_jobs, work)
        phase_line("cert", card=card, checked=len(cert_jobs), refused=refused)
        print(json.dumps({"kernels": records}), flush=True)
        return 1 if refused else 0

    if args.fleet:
        import tempfile

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        cert_jobs = []
        fleet_phase(device, card, texts, manifest, cert_jobs, work)
        refused, _ = check_certificates(cert_jobs, work)
        phase_line("cert", card=card, checked=len(cert_jobs), refused=refused)
        return 1 if refused else 0

    if args.delta:
        import tempfile

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        cert_jobs = []
        delta_phase(device, card, texts, cert_jobs, work)
        refused, _ = check_certificates(cert_jobs, work)
        phase_line("cert", card=card, checked=len(cert_jobs), refused=refused)
        return 1 if refused else 0

    if args.bitset:
        import tempfile

        from quorum_intersection_tpu_torch.fbas.graph import build_graph
        from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
        from quorum_intersection_tpu_torch.fbas.semantics import is_quorum

        def witness_ok(src, res) -> bool:
            graph = build_graph(parse_fbas(raw_json(src)))
            q1, q2 = res.q1 or [], res.q2 or []
            return is_quorum(graph, q1) and is_quorum(graph, q2) and not set(q1) & set(q2)

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        cert_jobs = []
        record = bitset_phases(device, card, texts, manifest, cert_jobs, witness_ok, work, ptxas, args.k8_parent)
        record["instances"] = ptxas.get("bitset_sweep")
        refused, _ = check_certificates(cert_jobs, work)
        phase_line("cert", card=card, checked=len(cert_jobs), refused=refused)
        print(json.dumps({"kernels": [record]}), flush=True)
        return 1 if refused else 0

    if args.frontier:
        import tempfile

        from quorum_intersection_tpu_torch.fbas.graph import build_graph
        from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
        from quorum_intersection_tpu_torch.fbas.semantics import is_quorum

        def witness_ok(src, res) -> bool:
            graph = build_graph(parse_fbas(raw_json(src)))
            q1, q2 = res.q1 or [], res.q2 or []
            return is_quorum(graph, q1) and is_quorum(graph, q2) and not set(q1) & set(q2)

        manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
        texts = {name: fixture_text(name) for name in manifest}
        work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
        cert_jobs = []
        records = frontier_phases(device, card, texts, manifest, cert_jobs, witness_ok, work, args.frontier_parent)
        records += frontier_mesh_phase(device, card, texts, cert_jobs, work)
        refused, _ = check_certificates(cert_jobs, work)
        phase_line("cert", card=card, checked=len(cert_jobs), refused=refused)
        print(json.dumps({"kernels": records}), flush=True)
        return 1 if refused else 0

    # -- 3. kernels ------------------------------------------------------
    kernels_meta = {
        "sweep_fused_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/sweep.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:119",
            "counterparts": "K1 pallas_sweep_program_factory (pallas_sweep.py:119, kernel :158); "
                            "K5 kernels.sweep_program_factory (kernels.py:305)",
        },
        "packed_sweep_dense_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/packed_sweep.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:343",
            "counterparts": "K3 pallas_packed_program_factory (pallas_sweep.py:343, kernel :404); "
                            "K7 kernels.packed_sweep_program_factory (kernels.py:445)",
        },
        "packed_sweep_bitset_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/packed_sweep.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:556",
            "counterparts": "K4 pallas_bitset_program_factory (pallas_sweep.py:556, kernel :622)",
        },
        "guard_dense_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/guard.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:257",
            "counterparts": "K2 pallas_guard_factory (pallas_sweep.py:257, kernel :285); "
                            "K6 kernels.guard_program_factory (kernels.py:359)",
        },
        "guard_bitset_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/guard.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/pallas_sweep.py:257",
            "counterparts": "K2 pallas_guard_factory (pallas_sweep.py:257); the guard half of K8, "
                            "kernels.bitset_guard_program_factory (kernels.py:722)",
        },
        "bitset_sweep_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/bitset_sweep.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/kernels.py:664",
            "counterparts": "K8 kernels.bitset_sweep_program_factory (kernels.py:664; step :635)",
        },
        "pagerank_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/pagerank.cu",
            "replaces": "quorum_intersection_tpu/analytics/pagerank.py:116",
            "counterparts": "K12 analytics/pagerank.py:116-174 _jitted_power_loops (dense :160, sparse :165)",
        },
        "frontier_chunk_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/frontier.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/frontier.py:330",
            "counterparts": "K9 TpuFrontierBackend._build_chunk (frontier.py:330; expand :380, chunk_fn :463)",
        },
        "frontier_filter_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/frontier.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/frontier.py:254",
            "counterparts": "K10 TpuFrontierBackend._build_flag_filter (frontier.py:254; filter_block :300)",
        },
        "sweep_mesh_cuda": {
            "route": "cuda",
            "source": f"{PORT}/kernels/csrc/sweep.cu",
            "replaces": "quorum_intersection_tpu/backends/tpu/sweep.py:2196",
            "counterparts": "K11 TpuSweepBackend._build_sharded_step (sweep.py:2196-2261; shard_map body :2227, "
                            "lax.pmin :2249): sweep.cu's qi_sweep_mesh, one launch a card over its contiguous "
                            "share, the cards' min on the home card; parallel/mesh.py mesh_pmin across processes",
        },
    }
    phase_line("kernels", kernels={k: v["counterparts"] for k, v in kernels_meta.items()})

    # -- 4. compare: kernel vs plain version on the card ------------------
    from quorum_intersection_tpu_torch.fbas import synth
    from quorum_intersection_tpu_torch.fbas.graph import build_graph
    from quorum_intersection_tpu_torch.fbas.schema import parse_fbas
    from quorum_intersection_tpu_torch.kernels import sweep_ref as ref
    from quorum_intersection_tpu_torch.kernels.sweep_cuda import (
        FusedSweep,
        KernelLimitError,
        mask_bits,
        sweep_fused,
    )

    def compare(label, circuit, circuit_d, local, scc_mask, frozen, lo_bits, his, starts,
                batch, steps):
        """Both instances of the fused kernel (tables resident and streamed;
        the resident one only where the tables fit) against the plain
        version on every hi row and start."""
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_nodes = local[1 + lo_bits:]
        kernels = {}
        for stream in (False, True):
            try:
                kernels[stream] = FusedSweep(circuit, lo_nodes, scc_mask, frozen, batch, circuit_d,
                                             device, stream=stream)
            except KernelLimitError:
                if stream:
                    raise
        plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, batch, circuit_d, device)
        hits = windows = 0
        max_err = 0
        for hi in his:
            hi_row = np.zeros(circuit.n, dtype=np.int32)
            for j, v in enumerate(hi_nodes):
                hi_row[v] = (hi >> j) & 1
            for start in starts:
                want = int(plain.program(start, steps, hi_row if hi_nodes else None))
                windows += 1
                hits += want != ref.INT32_MAX
                for stream, fused in kernels.items():
                    got = int(fused.program(start, steps, mask_bits(hi_row)))
                    torch.cuda.synchronize()
                    max_err = max(max_err, abs(got - want))
                    if got != want:
                        fail("compare", f"{label} (streamed={stream}) hi={hi} start={start}: "
                                        f"kernel {got} != plain {want}")
        natural = FusedSweep(circuit, lo_nodes, scc_mask, frozen, 1, circuit_d, device).tables
        return {"label": label, "n": circuit.n, "units": circuit.n_units, "depth": circuit.depth,
                "max_vote": int(max(circuit.members.max(), circuit.child.max(initial=0))),
                "restricted": circuit_d is not None, "lo_bits": lo_bits, "windows": windows,
                "windows_with_hits": hits, "max_abs_err": max_err,
                "instances": ["streamed" if s else "resident" for s in kernels],
                "chosen": "streamed" if natural.stream else "resident", "table_blocks": natural.nblocks}

    results = []
    launches_before_compare = sweep_fused.launches
    for name in ("snapshot_broken.json", "snapshot_correct.json"):
        problem = sweep_problem(fixture_text(name))
        bits = len(problem[2]) - 1
        results.append(compare(f"{name} restricted SCC", *problem, bits, [0],
                               sorted({0, (1 << bits) - WINDOW}), 1 << 17, 8))
    problem = sweep_problem(fixture_text("nested_correct.json"))
    bits = len(problem[2]) - 1
    results.append(compare("nested_correct.json", *problem, bits, [0], [0], 1 << bits, 1))
    for broken in (False, True):
        problem = sweep_problem(json.dumps(synth.benchmark_fbas(256, 34, broken=broken)))
        results.append(compare(f"benchmark_fbas(256,34,broken={broken}) wide", *problem, 30,
                               [0, 5, 7], [0, 3 << 27], 1 << 17, 8))
    me = multi_edge_circuit()
    me_scc = np.ones(me.n, dtype=np.int32)
    results.append(compare("multi-edge scoped", me, None, list(range(me.n)), me_scc, None,
                           me.n - 1, [0], [0], 1 << 11, 1))
    me_scc10 = np.zeros(me.n, dtype=np.int32)
    me_scc10[:10] = 1
    results.append(compare("multi-edge frozen (Q6)", me, None, list(range(10)), me_scc10,
                           1 - me_scc10, 9, [0], [0], 1 << 9, 1))
    from quorum_intersection_tpu_torch.encode.circuit import encode_circuit

    for broken in (False, True):
        # 30 nodes, 390 units: a child satisfaction mask of 8 words.
        ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12, broken=broken))))
        results.append(compare(f"inner_set_ring_fbas(30,12,broken={broken}) U={ring.n_units}",
                               ring, None, list(range(ring.n)), np.ones(ring.n, dtype=np.int32), None,
                               ring.n - 1, [0], [0, 3 << 20, (1 << 29) - (1 << 15)], 1 << 14, 2))
    for broken in (False, True):
        # 40 nodes, 1240 units: past the 1024 units the first fused kernel
        # took.  20 low bits and an alternating hi row, as the CPU model test.
        ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30, broken=broken))))
        results.append(compare(f"inner_set_ring_fbas(40,30,broken={broken}) U={ring.n_units}",
                               ring, None, list(range(ring.n)), np.ones(ring.n, dtype=np.int32), None,
                               20, [0, sum(1 << j for j in range(0, 19, 2))],
                               [0, 400, (1 << 19) - 67, (1 << 20) - 3000], 3000, 2))
    # A circuit whose tables pass one block's shared memory: streamed only.
    huge = dense_child_circuit(n=40, units=3000)
    results.append(compare(f"densely nested n=40 U={huge.n_units}", huge, None, list(range(huge.n)),
                           np.ones(huge.n, dtype=np.int32), None, 30, [0, 123],
                           [0, 1 << 20, (1 << 30) - 6000], 3000, 2))
    max_abs_err = max(r["max_abs_err"] for r in results)
    wide = [r for r in results if r["units"] > 1024]
    if not any(r["windows_with_hits"] for r in wide) or not any(r["chosen"] == "streamed" for r in wide):
        fail("compare", "the circuits above 1024 units lack a window with a hit or a streamed choice")
    phase_line("compare", tolerance="exact (integer hit indices)", circuits=results)
    # The warp kernels again and again, each launch against the plain result.
    repeated_warp = stress_warp(device, STRESS_REPEATS)
    if stress_failed(repeated_warp):
        fail("compare", f"a repeated warp-kernel launch differed: {repeated_warp}")
    phase_line("compare_warp", repeated=repeated_warp)

    # Times on two main-path shapes: the snapshot's restricted SCC and the
    # full-width config's restricted, wide one, then the 1240-unit ring.
    # One window = 2^20 candidates; each shape on both instances.
    ring40 = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30))))
    shapes = {
        "snapshot": sweep_problem(fixture_text("snapshot_broken.json")) + (None, 0),
        "bench256_34": sweep_problem(json.dumps(synth.benchmark_fbas(256, 34))) + (30, 5),
        "ring40_30": (ring40, None, list(range(40)), np.ones(40, dtype=np.int32), None, 30, 0),
    }
    timing = {}
    for label, (circuit, circuit_d, local, scc_mask, frozen, lo_bits, hi) in shapes.items():
        lo_bits = len(local) - 1 if lo_bits is None else lo_bits
        lo_nodes = np.asarray(local[1:1 + lo_bits], dtype=np.int32)
        hi_row = np.zeros(circuit.n, dtype=np.int32)
        for j, v in enumerate(local[1 + lo_bits:]):
            hi_row[v] = (hi >> j) & 1
        start = 0 if label == "snapshot" else 1 << 20  # a window with no early hit
        plain = ref.SweepRef(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device)
        hi_bits = mask_bits(hi_row)
        plain_ms = time_ms(lambda: plain.program(start, 8, hi_row if hi_bits else None), 3)
        bound_ms, bound_by, passes = window_bound_ms(circuit, circuit_d, lo_nodes, scc_mask, frozen,
                                                     start, hi_row if hi_bits else None, device)
        for stream in (False, True):
            fused = FusedSweep(circuit, lo_nodes, scc_mask, frozen, 1 << 17, circuit_d, device,
                               stream=stream)
            ms = time_ms(lambda: fused.program(start, 8, hi_bits), 20 if label == "ring40_30" else 50)
            timing[f"{label}/streamed" if stream else label] = {"n": circuit.n, "units": circuit.n_units, "depth": circuit.depth,
                           "window": WINDOW, "instance": "streamed" if stream else "resident",
                           "table_blocks": fused.tables.nblocks, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, "fixpoint_passes": passes,
                           "candidates_per_s": WINDOW / ms * 1e3}
    phase_line("timing", card=card, per_window=timing, ptxas=ptxas.get("sweep"))
    compare_launches = sweep_fused.launches - launches_before_compare

    # -- 5. main path ----------------------------------------------------
    from quorum_intersection_tpu_torch.fbas.semantics import is_quorum
    from quorum_intersection_tpu_torch.pipeline import solve

    manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
    texts = {name: fixture_text(name) for name in manifest}
    # The CLI as a user runs it, one process per fixture, all at once.
    procs = {}
    for name, text in texts.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", PORT, "--backend", "gpu-sweep"], cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
    cli = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(texts[name], timeout=300)
            cli[name] = (out, err, proc.returncode)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    sweep_fused.launches = 0
    main_rows = []
    for name, text in texts.items():
        t = time.perf_counter()
        res = solve(text, backend="gpu-sweep")
        seconds = time.perf_counter() - t
        want = manifest[name]["verdict"]
        out, err, code = cli[name]
        if res.intersects is not want:
            fail("main", f"{name}: solve says {res.intersects}, MANIFEST says {want}")
        if out.strip().splitlines()[-1:] != ["true" if want else "false"] or code != (0 if want else 1):
            fail("main", f"{name}: CLI printed {out[-40:]!r} exit {code}; stderr {err[-400:]!r}")
        if not want:
            graph = build_graph(parse_fbas(text))
            q1, q2 = res.q1 or [], res.q2 or []
            if not (is_quorum(graph, q1) and is_quorum(graph, q2) and not set(q1) & set(q2)):
                fail("main", f"{name}: witness pair is not two disjoint quorums")
        main_rows.append({"fixture": name, "verdict": res.intersects, "seconds": seconds,
                          "hit_index": res.stats.get("hit_index"),
                          "candidates": res.stats.get("candidates_checked")})
    phase_line("main", fixtures=main_rows,
               cli="python -m " + PORT + " --backend gpu-sweep: 7/7 verdicts and exit codes")

    # -- 6. full width ---------------------------------------------------
    full = []
    for broken in (False, True):
        data = synth.benchmark_fbas(256, 34, broken=broken)
        t = time.perf_counter()
        res = solve(data, backend="gpu-sweep")
        seconds = time.perf_counter() - t
        if res.intersects is broken:
            fail("full", f"benchmark_fbas(256,34,broken={broken}) gave intersects={res.intersects}")
        if broken:
            graph = build_graph(parse_fbas(data))
            if not (is_quorum(graph, res.q1) and is_quorum(graph, res.q2)
                    and not set(res.q1) & set(res.q2)):
                fail("full", "broken twin's witness pair is not two disjoint quorums")
        full.append({"config": f"benchmark_fbas(256, core=34, broken={broken})",
                     "intersects": res.intersects, "seconds": seconds,
                     "candidates": res.stats["candidates_checked"],
                     "enumeration_total": res.stats["enumeration_total"],
                     "candidates_per_s": res.stats["candidates_checked"] / seconds,
                     "hit_index": res.stats.get("hit_index")})
    launches = sweep_fused.launches
    # The correct twin once more under the profiler: the fused kernel's
    # device time on the main path.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        solve(synth.benchmark_fbas(256, 34), backend="gpu-sweep")
        torch.cuda.synchronize()
    full_device_ms = device_ms_by_kernel(prof)
    phase_line("full", card=card, runs=full)
    if launches < 1:
        fail("main", "the main path never launched sweep_fused_cuda")

    # -- 7. batch path ---------------------------------------------------
    def witness_ok(src, res) -> bool:
        graph = build_graph(parse_fbas(src))
        q1, q2 = res.q1 or [], res.q2 or []
        return is_quorum(graph, q1) and is_quorum(graph, q2) and not set(q1) & set(q2)

    from quorum_intersection_tpu_torch.backends.sweep import GpuSweepBackend
    from quorum_intersection_tpu_torch.encode.circuit import bitset_supported
    from quorum_intersection_tpu_torch.kernels.packed_cuda import (
        PackedSweep,
        packed_sweep_bitset,
        packed_sweep_dense,
    )
    from quorum_intersection_tpu_torch.kernels.packed_ref import PackedRef
    from quorum_intersection_tpu_torch.pipeline import check_many

    sources = batch_sources(list(manifest))
    batch_runs, batch_results, batch_launches = {}, {}, {}
    # (label, raw source, certificate) of the runs phase cert checks.
    cert_jobs = []
    for engine, kernel_name in ((None, "packed_sweep_dense_cuda"), ("bitset", "packed_sweep_bitset_cuda")):
        label = engine or "default"
        backend = GpuSweepBackend(engine=engine)
        sweep_fused.launches = packed_sweep_dense.launches = packed_sweep_bitset.launches = 0
        t = time.perf_counter()
        res = check_many([src for _, src, _ in sources], backend=backend)
        seconds = time.perf_counter() - t
        counts = {"sweep_fused_cuda": sweep_fused.launches,
                  "packed_sweep_dense_cuda": packed_sweep_dense.launches,
                  "packed_sweep_bitset_cuda": packed_sweep_bitset.launches}
        if counts[kernel_name] < 1:
            fail("batch", f"check_many (engine={label}) never launched {kernel_name}")
        batch_launches[kernel_name] = counts[kernel_name]
        for (name, src, want), r in zip(sources, res):
            if r.intersects is not want:
                fail("batch", f"{name} (engine={label}): intersects={r.intersects}, expected {want}")
            if not want:
                graph = build_graph(parse_fbas(src))
                q1, q2 = r.q1 or [], r.q2 or []
                if not (is_quorum(graph, q1) and is_quorum(graph, q2) and not set(q1) & set(q2)):
                    fail("batch", f"{name} (engine={label}): witness pair is not two disjoint quorums")
        candidates = sum(r.stats.get("candidates_checked", 0) for r in res)
        batch_results[label] = res
        cert_jobs += [(f"batch/{label}/{name}", src, r.cert) for (name, src, _), r in zip(sources, res)]
        if label == "default":
            plans = backend.pack_plans  # the packs this run swept, compared below
        # Each pack as the drive's own stats report it, in the order it ran.
        packs = {r.stats["pack_index"]: r.stats for r in res if r.stats.get("packed")}
        batch_runs[label] = {
            "seconds": seconds, "sources": len(sources), "packs": len(packs),
            "per_pack": [{key: s[key] for key in PACK_KEYS} for _, s in sorted(packs.items())],
            "candidates": candidates, "candidates_per_s": candidates / seconds, "launches": counts,
        }
    # One more run of each engine under the profiler: the card's busy time
    # (the sum of its kernels' times) against the run's wall time, and each
    # kernel's device time on the batch path.
    batch_device_ms = {}
    for engine in (None, "bitset"):
        label = engine or "default"
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            check_many([src for _, src, _ in sources], backend=GpuSweepBackend(engine=engine))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        by_kernel = batch_device_ms[label] = device_ms_by_kernel(prof)
        busy_ms = sum(by_kernel.values())
        batch_runs[f"profiled_{label}"] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured (no device events)",
            "device_ms_by_kernel": {k: v for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]},
        }
    # Every hit index equals the unpacked drive's (the fused kernel's path).
    solo_results = {}
    for i, (name, src, _) in enumerate(sources):
        solo = solo_results[name] = solve(src, backend="gpu-sweep")
        for label, res in batch_results.items():
            got, want = res[i].stats.get("hit_index"), solo.stats.get("hit_index")
            if (res[i].intersects, got) != (solo.intersects, want):
                fail("batch", f"{name} (engine={label}): hit index {got} != unpacked solve's {want}")
    phase_line("batch", card=card, runs=batch_runs,
               hit_index_vs_unpacked_solve=f"{len(sources)}/{len(sources)} equal on both engines")

    # Jobs whose window split would pass the packed kernels' 1024 units
    # (the JAX drive plans 4 and 5 windows, 1568 and 1560 fused units):
    # check_many plans packs within it, with the unpacked solve's answers.
    ring_sources = [(f"inner_set_ring_fbas({n},12,broken={b})", synth.inner_set_ring_fbas(n, 12, broken=b))
                    for n in (30, 24) for b in (False, True)]
    unit_runs = {}
    for engine in (None, "bitset"):
        label = engine or "default"
        backend = GpuSweepBackend(engine=engine)
        t = time.perf_counter()
        res = check_many([src for _, src in ring_sources], backend=backend)
        seconds = time.perf_counter() - t
        for (name, src), r in zip(ring_sources, res):
            solo = solo_results.setdefault(name, solve(src, backend="gpu-sweep"))
            if not r.intersects and not witness_ok(src, r):
                fail("batch_units", f"{name} (engine={label}): witness pair is not two disjoint quorums")
            if (r.intersects, r.stats.get("hit_index")) != (solo.intersects, solo.stats.get("hit_index")):
                fail("batch_units", f"{name} (engine={label}): hit index {r.stats.get('hit_index')} != "
                                    f"unpacked solve's {solo.stats.get('hit_index')}")
        unit_runs[label] = {
            "seconds": seconds,
            "packs": [{"groups": pl.packed.groups, "shape": [pl.packed.circuit.n, pl.packed.circuit.n_units]}
                      for pl in backend.pack_plans],
            "verdicts": {name: r.intersects for (name, _), r in zip(ring_sources, res)},
            "hit_index": {name: r.stats.get("hit_index") for (name, _), r in zip(ring_sources, res)}}
    phase_line("batch_units", card=card, runs=unit_runs,
               hit_index_vs_unpacked_solve=f"{len(ring_sources)}/{len(ring_sources)} equal on both engines")

    # -- 8. the packed kernels against their plain versions ---------------
    # On every pack the default batch run swept (a depth-1 pack and windows
    # with hits among them), a pack with vote counts up to 3 (dense only)
    # and two 1024-unit nested packs (the dense kernel's tables resident in
    # one, streamed in the densely nested other), with both kernels where
    # the circuit allows.  3000 rows per program: a ragged last tile.
    from quorum_intersection_tpu_torch.encode.circuit import pack_circuits, restrict_circuit_pair

    cmp_batch = 1500
    cmp_cases = []
    for pi, plan in enumerate(plans):
        los = np.asarray([g.lo for g in plan.groups], dtype=np.int64)
        his = np.asarray([g.hi for g in plan.groups], dtype=np.int64)
        cmp_cases.append((f"batch pack {pi}", plan.packed, plan.tables,
                          (los, los + (1 << 16), np.maximum(his - 2 * cmp_batch, 0))))
    me = multi_edge_circuit()
    multi = pack_circuits([(me, None)] * 3)
    cmp_cases.append(("multi-plane (votes up to 3)", multi, multi.decode_tables(),
                      (np.zeros(3, dtype=np.int64), np.asarray([100, 900, 2000]))))
    ring = encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12))))
    big = pack_circuits([restrict_circuit_pair(ring, list(range(ring.n)))] * 2)
    cmp_cases.append(("inner_set_ring_fbas(30,12) x2, 1024 units", big, big.decode_tables(),
                      (np.asarray([0, 3 << 20]), np.asarray([1 << 28, (1 << 29) - 5000]))))
    dense = pack_circuits([(dense_child_circuit(), None)])
    cmp_cases.append(("densely nested, 1024 units", dense, dense.decode_tables(),
                      (np.asarray([0]), np.asarray([(1 << 29) + 12345]))))
    packed_err = {"dense": 0, "bitset": 0}
    packed_results = []
    for label, pk, tables, windows in cmp_cases:
        for engine in ("dense", "bitset") if bitset_supported(pk.circuit) else ("dense",):
            kernel = PackedSweep(pk.circuit, pk.circuit_d, *tables, cmp_batch, engine=engine,
                                 device=device)
            plain = PackedRef(pk.circuit, pk.circuit_d, *tables, cmp_batch, engine, device)
            hits = 0
            for starts in windows:
                got = kernel.program(starts, 2).cpu().numpy()
                want = plain.program(starts, 2).cpu().numpy()
                torch.cuda.synchronize()
                hits += int((want != ref.INT32_MAX).sum())
                err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
                packed_err[engine] = max(packed_err[engine], err)
                if err:
                    fail("compare", f"{label} {engine} starts={list(starts)}: "
                                    f"kernel {got.tolist()} != plain {want.tolist()}")
            packed_results.append({"pack": label, "engine": engine, "route": kernel.tables.route,
                                   "streamed": kernel.tables.stream, "groups": pk.groups,
                                   "slot": pk.slot, "lanes": pk.circuit.n, "units": pk.circuit.n_units,
                                   "depth": pk.circuit.depth, "max_vote": int(pk.circuit.members.max()),
                                   "windows": len(windows) * pk.groups, "group_windows_with_hits": hits})
    if (not any(r["depth"] == 1 for r in packed_results)
            or not any(r["group_windows_with_hits"] for r in packed_results)
            or not any(r["streamed"] for r in packed_results)
            or not any(r["max_vote"] > 1 for r in packed_results)):
        fail("compare", "the packed comparison lacks a depth-1, a streamed or a multi-plane pack, "
                        "or a window with hits")
    # The dense kernel again and again on the odd packs: a fault in the
    # sharing of shared memory between a block's warps is intermittent.
    repeated = stress_packed(device, STRESS_REPEATS)
    if stress_failed(repeated):
        fail("compare", f"a repeated packed launch differed: {repeated}")
    phase_line("compare_packed", tolerance="exact (integer hit indices, per group)",
               rows_per_program=2 * cmp_batch, packs=packed_results, repeated=repeated)

    # The packed kernels at the widest packed shape: one 31-node job split
    # over 4 window groups (n = 128 lanes, slot 32), each group decoding 2^20
    # candidates of its own window per program; the pack is the one
    # check_many itself forms for that job.  Also at the shape of the batch's
    # first pack (the lockstep one of §5), kernels only.
    wide_backend = GpuSweepBackend()
    wide_res = check_many([synth.benchmark_fbas(256, 31)], backend=wide_backend)
    if wide_res[0].intersects is not True:
        fail("timing", "benchmark_fbas(256, core=31) alone did not intersect")
    shapes = {"widest": wide_backend.pack_plans[0], "batch_pack_0": plans[0]}
    wp = shapes["widest"].packed
    if (wp.groups, wp.slot, wp.circuit.n) != (4, 32, 128):
        fail("timing", f"widest pack is {wp.groups} groups of slot {wp.slot} over {wp.circuit.n} lanes")
    packed_timing = {}
    for shape, plan in shapes.items():
        pk = plan.packed
        starts = np.asarray([g.lo + WINDOW for g in plan.groups], dtype=np.int64)
        bound_ms, bound_by, passes = packed_bound_ms(plan, starts, WINDOW, device)
        plain_ms = {}
        for engine in ("dense", "bitset"):
            kernel = PackedSweep(pk.circuit, pk.circuit_d, *plan.tables, 1 << 17, engine=engine,
                                 device=device)
            ms = time_ms(lambda: kernel.program(starts, 8), 20)
            plain = PackedRef(pk.circuit, pk.circuit_d, *plan.tables, 1 << 17, engine, device)
            plain_ms[engine] = time_ms(lambda: plain.program(starts, 8), 2)
            t = kernel.tables
            packed_timing[f"{shape}/{engine}"] = {
                "groups": pk.groups, "lanes": pk.circuit.n, "units": pk.circuit.n_units,
                "depth": pk.circuit.depth, "route": t.route, "streamed": t.stream, "rows": WINDOW,
                "ms": ms, "plain_ms": plain_ms[engine], "bound_ms": bound_ms, "bound_by": bound_by,
                "fixpoint_passes": passes, "candidates_per_s": pk.groups * WINDOW / ms * 1e3}
    phase_line("timing_packed", card=card, per_program=packed_timing, ptxas=ptxas.get("packed_sweep"))

    # -- 9. prune: block-guard pruning on the unpacked path ----------------
    from quorum_intersection_tpu_torch.backends.sweep import _PrunePlan, guard_masks
    from quorum_intersection_tpu_torch.kernels.guard_cuda import BlockGuard, guard_bitset, guard_dense
    from quorum_intersection_tpu_torch.kernels.guard_ref import guard_counts

    def ledger_ok(stats) -> bool:
        """On a swept ``true``: every window checked, pruned or skipped."""
        if "enumeration_total" not in stats:
            return True  # decided by the SCC guard, no sweep
        cert = stats["cert"]
        return (stats["candidates_checked"] + cert["windows_pruned_guard"]
                + cert["windows_skipped_pack_fill"]) == stats["enumeration_total"] == cert["window_space"]

    def guard_counts_now():
        return {"guard_dense_cuda": guard_dense.launches, "guard_bitset_cuda": guard_bitset.launches,
                "sweep_fused_cuda": sweep_fused.launches,
                "packed_sweep_dense_cuda": packed_sweep_dense.launches,
                "packed_sweep_bitset_cuda": packed_sweep_bitset.launches}

    def reset_counts():
        guard_dense.launches = guard_bitset.launches = sweep_fused.launches = 0
        packed_sweep_dense.launches = packed_sweep_bitset.launches = 0

    prune_sources = [(name, texts[name], manifest[name]["verdict"]) for name in manifest]
    for core in (12, 15):
        for broken in (False, True):
            prune_sources.append((f"near_disjoint_cores({core},1,broken={broken})",
                                  synth.near_disjoint_cores(core, 1, broken=broken), not broken))
    unpruned = {}
    for label, src, _ in prune_sources:
        t = time.perf_counter()
        unpruned[label] = (solve(src, backend=GpuSweepBackend(prune=False)), time.perf_counter() - t)
    # (label, circuit, masks, pruned prefixes) of every plan the two pruned
    # runs build; compare_guard holds the rebuilt masks to the run's prefixes.
    guard_plans = []
    prune_rows, prune_seconds, prune_guard = [], {}, {}
    reset_counts()
    for label, src, want in prune_sources:
        backend = GpuSweepBackend(prune=True)
        t = time.perf_counter()
        res = solve(src, backend=backend)
        seconds = prune_seconds[label] = time.perf_counter() - t
        base, base_seconds = unpruned[label]
        if res.intersects is not want:
            fail("prune", f"{label}: pruned solve says {res.intersects}, expected {want}")
        if not want and not witness_ok(src, res):
            fail("prune", f"{label}: witness pair is not two disjoint quorums")
        if (res.intersects, res.stats.get("hit_index"), res.q1, res.q2) != (
                base.intersects, base.stats.get("hit_index"), base.q1, base.q2):
            fail("prune", f"{label}: pruned hit index {res.stats.get('hit_index')} != unpruned "
                          f"{base.stats.get('hit_index')}")
        if res.intersects and not ledger_ok(res.stats):
            fail("prune", f"{label}: checked + pruned != enumeration ({res.stats})")
        cert_jobs.append((f"prune/{label}", src, res.cert))
        ranges = None
        if "guard_rows" in res.stats:
            circuit, _, local, _, _ = sweep_problem(src)
            masks, k = guard_rows_of(circuit, local[1:], res.stats["guard_rows"])
            prefixes = res.stats["cert"].get("pruned_blocks", {}).get("prefixes", [])
            guard_plans.append((label, circuit, masks, prefixes))
            prune_guard[label] = (circuit, masks, res.stats["guard_seconds"])
            ranges = len(_PrunePlan.build(k, prefixes, res.stats["enumeration_total"], 0, len(masks)).ranges)
        prune_rows.append({
            "source": label, "verdict": res.intersects, "hit_index": res.stats.get("hit_index"),
            "seconds_pruned": seconds, "seconds_unpruned": base_seconds,
            "enumeration_total": res.stats.get("enumeration_total"),
            "windows_pruned": res.stats.get("cert", {}).get("windows_pruned_guard"),
            "guard_rows": res.stats.get("guard_rows"), "guard_seconds": res.stats.get("guard_seconds"),
            "surviving_ranges": ranges,
            "programs_pruned": res.stats.get("device_steps"),
            "programs_unpruned": base.stats.get("device_steps"),
        })
    prune_launches = guard_counts_now()
    if prune_launches["guard_dense_cuda"] < 1:
        fail("prune", "the pruned solves never launched guard_dense_cuda")
    phase_line("prune", card=card, launches=prune_launches, sources=prune_rows,
               hit_index_vs_unpruned_solve=f"{len(prune_rows)}/{len(prune_rows)} equal")

    # -- 10. batch_pruned: block-guard pruning on the packed path ----------
    pruned_batch = list(sources)
    pruned_batch += [(f"near_disjoint_cores(6,1,seed={seed})", synth.near_disjoint_cores(6, 1, seed=seed),
                      True) for seed in range(3)]
    pruned_batch += [(f"near_disjoint_cores(10,1,broken={broken})",
                      synth.near_disjoint_cores(10, 1, broken=broken), not broken) for broken in (False, True)]
    for name, src, _ in pruned_batch:
        if name not in solo_results:
            solo_results[name] = solve(src, backend="gpu-sweep")
    batch_pruned_runs, batch_pruned_launches, pruned_device_ms = {}, {}, {}
    for engine, guard_name in ((None, "guard_dense_cuda"), ("bitset", "guard_bitset_cuda")):
        label = engine or "default"
        backend = GpuSweepBackend(prune=True, engine=engine)
        reset_counts()
        t = time.perf_counter()
        res = check_many([src for _, src, _ in pruned_batch], backend=backend)
        seconds = time.perf_counter() - t
        counts = guard_counts_now()
        if counts[guard_name] < 1:
            fail("batch_pruned", f"check_many (engine={label}) never launched {guard_name}")
        batch_pruned_launches[guard_name] = counts[guard_name]
        for (name, src, want), r in zip(pruned_batch, res):
            solo = solo_results[name]
            if r.intersects is not want:
                fail("batch_pruned", f"{name} (engine={label}): intersects={r.intersects}, expected {want}")
            if not want and not witness_ok(src, r):
                fail("batch_pruned", f"{name} (engine={label}): witness pair is not two disjoint quorums")
            if (r.intersects, r.stats.get("hit_index")) != (solo.intersects, solo.stats.get("hit_index")):
                fail("batch_pruned", f"{name} (engine={label}): hit index {r.stats.get('hit_index')} != "
                                     f"unpruned solve's {solo.stats.get('hit_index')}")
            if r.intersects and not ledger_ok(r.stats):
                fail("batch_pruned", f"{name} (engine={label}): checked + pruned + skipped != enumeration")
            cert_jobs.append((f"batch_pruned/{label}/{name}", src, r.cert))
        for pi, plan in enumerate(backend.pack_plans):
            for jix, p in enumerate(plan.prune_plans):
                if p is not None:
                    gix = next(i for i, g in enumerate(plan.groups) if g.job == jix)
                    c = plan.group_circuits[gix][0]
                    masks, _ = guard_rows_of(c, np.arange(1, c.n), p.guard_rows)
                    guard_plans.append((f"batch {label} pack {pi} job {jix}", c, masks, p.prefixes))
        packs = {r.stats["pack_index"]: r.stats for r in res if r.stats.get("packed")}
        batch_pruned_runs[label] = {
            "seconds": seconds, "sources": len(pruned_batch), "packs": len(packs),
            "per_pack": [{key: s.get(key) for key in PACK_KEYS} for _, s in sorted(packs.items())],
            "windows_pruned": sum(r.stats.get("cert", {}).get("windows_pruned_guard", 0) for r in res),
            "candidates": sum(r.stats.get("candidates_checked", 0) for r in res), "launches": counts,
        }
    # Each engine once more under the profiler: the guards' device time.
    for engine in (None, "bitset"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            check_many([src for _, src, _ in pruned_batch], backend=GpuSweepBackend(prune=True, engine=engine))
            torch.cuda.synchronize()
        pruned_device_ms[engine or "default"] = device_ms_by_kernel(prof)
    phase_line("batch_pruned", card=card, runs=batch_pruned_runs,
               device_ms_by_kernel={k: {n: ms for n, ms in v.items() if "_kernel" in n}
                                    for k, v in pruned_device_ms.items()},
               unpruned_batch_seconds={k: batch_runs[k]["seconds"] for k in ("default", "bitset")},
               hit_index_vs_unpruned_solve=f"{len(pruned_batch)}/{len(pruned_batch)} equal on both engines")

    # -- 11. the guard instances against their plain version ---------------
    cases = {}  # one case per distinct (circuit, masks), with every plan that used it
    for label, c, masks, prefixes in guard_plans:
        key = (c.n, c.n_units, c.thresholds.tobytes(), c.members.tobytes(), c.child.tobytes(),
               masks.tobytes())
        encodings = ("dense", "bitset") if bitset_supported(c) else ("dense",)
        cases.setdefault(key, (label, c, masks, encodings, []))[4].append((label, prefixes))
    for label, c in (("multi-edge", multi_edge_circuit()),
                     ("inner_set_ring_fbas(30,12)",
                      encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(30, 12))))),
                     ("inner_set_ring_fbas(40,30), 1240 units",
                      encode_circuit(build_graph(parse_fbas(synth.inner_set_ring_fbas(40, 30)))))):
        bits = c.n - 1
        prefix = min(14, bits - 2)
        cases[label] = (label, c, guard_masks(c.n, np.arange(1, c.n), bits - prefix, prefix), ("dense",), [])
    guard_err = {"dense": 0, "bitset": 0}
    zero_rows = positive_rows = 0
    guard_results = []
    for label, c, masks, encodings, runs in cases.values():
        for enc in encodings:
            want = guard_counts(c, masks, enc, device).cpu().numpy()
            for stream in (False, True):  # both instances: tables resident and streamed
                got = BlockGuard(c, enc, device, stream=stream).counts(masks)
                err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0))
                guard_err[enc] = max(guard_err[enc], err)
                if err or got.shape != want.shape:
                    fail("compare_guard", f"{label} {enc} (streamed={stream}): kernel differs from plain "
                                          f"(max err {err})")
        for run, prefixes in runs:
            if np.nonzero(want == 0)[0].tolist() != list(prefixes):
                fail("compare_guard", f"{run}: the rebuilt guard rows do not give the run's pruned blocks")
        zero_rows += int((want == 0).sum())
        positive_rows += int((want > 0).sum())
        guard_results.append({"case": label, "n": c.n, "units": c.n_units, "depth": c.depth,
                              "rows": len(masks), "encodings": list(encodings),
                              "instances": ["resident", "streamed"],
                              "rows_pruned": int((want == 0).sum())})
    if not zero_rows or not positive_rows:
        fail("compare_guard", f"compared rows lack a zero ({zero_rows}) or a positive ({positive_rows}) count")
    phase_line("compare_guard", tolerance="exact (integer survivor counts)", cases=guard_results,
               rows_zero=zero_rows, rows_positive=positive_rows)

    # 16384-row guard calls at the widest pruned shape and the snapshot's.
    guard_timing = {}
    for shape, label in (("near_disjoint_cores(15,1)", "near_disjoint_cores(15,1,broken=False)"),
                         ("snapshot", "snapshot_correct.json")):
        c, masks, plan_seconds = prune_guard[label]
        tables = ref.CircuitTables(c, device)
        passes = int(ref.fixpoint_passes(tables, tables.cast(masks))[1].sum())
        # Tables once (int8 votes, Q thresholds in int32); per row, the
        # candidate's n-1 enumerated node bits in (scc[0] is in no mask)
        # and one int32 count out.
        nbytes = c.members.size + c.child.size + 4 * c.n_units + (-(-(c.n - 1) // 8) + 4) * len(masks)
        bound_ms, bound_by = bound(passes * macs_per_pass(c), nbytes)
        for enc in ("dense", "bitset") if bitset_supported(c) else ("dense",):
            guard = BlockGuard(c, enc, device)
            words = guard.upload(masks)
            launch = guard_dense if enc == "dense" else guard_bitset
            guard_timing[f"{shape}/{enc}"] = {
                "n": c.n, "units": c.n_units, "depth": c.depth, "rows": len(masks),
                "ms": time_ms(lambda: launch(guard, words), 50),
                "call_ms": time_ms(lambda: guard.counts(masks), 20),
                "plain_ms": time_ms(lambda: guard_counts(c, masks, enc, device), 3),
                "bound_ms": bound_ms, "bound_by": bound_by, "fixpoint_passes": passes,
                "plan_seconds": plan_seconds, "pruned_solve_seconds": prune_seconds[label],
                "guard_share_of_pruned_solve": plan_seconds / prune_seconds[label],
            }
    phase_line("timing_guard", card=card, per_call=guard_timing)


    # Whether the profiler still records device work, after each of the
    # phases below (phase pagerank_cli's profiled run found it did not).
    profiler_seen = {"timing_guard": profiler_records(device)}

    # -- 12. route: the auto router's constants on this card --------------
    import tempfile

    from quorum_intersection_tpu_torch.backends import calibration as cal_mod
    from quorum_intersection_tpu_torch.backends.auto import AutoBackend
    from quorum_intersection_tpu_torch.backends.cpp import CppOracleBackend
    from quorum_intersection_tpu_torch.backends.python_oracle import PythonOracleBackend

    work = pathlib.Path(tempfile.mkdtemp(prefix="qi-chip-smoke-"))
    # Host oracles: seconds per branch-and-bound call, from their own stats.
    oracle_sets = {
        "cpp": [(name, texts[name]) for name in manifest]
               + [(f"stellar_like_fbas({o},3,seed={sd})", synth.stellar_like_fbas(o, 3, seed=sd))
                  for o in (5, 7) for sd in (0, 1)],
        "python": [(name, texts[name]) for name in ("trivial_correct.json", "trivial_broken.json",
                                                     "nested_correct.json", "nested_broken.json")]
                  + [(f"stellar_like_fbas(5,3,seed={sd})", synth.stellar_like_fbas(5, 3, seed=sd))
                     for sd in (0, 1)],
    }
    oracle_rows = {}
    for engine, factory in (("cpp", CppOracleBackend), ("python", PythonOracleBackend)):
        secs = calls = 0
        for name, src in oracle_sets[engine]:
            res = solve(src, backend=factory(), with_cert=False)
            secs += res.stats.get("seconds", 0.0)
            calls += res.stats.get("bnb_calls", 0)
        oracle_rows[engine] = {"sources": len(oracle_sets[engine]), "bnb_calls": calls, "seconds": secs,
                               "seconds_per_call": secs / calls}
    # The sweep's first-solve overhead in a fresh process, kernels built
    # (warm) and with an empty build directory (cold: nvcc included).
    snap_file = work / "snapshot_correct.json"
    snap_file.write_text(texts["snapshot_correct.json"])
    overhead = {}
    for mode in ("warm", "cold"):
        so, se, rc, secs = run_all([[sys.executable, "-c", FIRST_SOLVE_PROBE, str(snap_file), mode]])[0]
        if rc != 0:
            fail("route", f"first-solve probe ({mode}) exit {rc}: {se[-600:]!r}")
        overhead[mode] = dict(json.loads(so.strip().splitlines()[-1]), process_s=secs)
    k1_rate = full[0]["candidates_per_s"]
    # The batch packed against per-problem sweeps, both engines.
    pack_rows = {}
    for engine in (None, "bitset"):
        label = engine or "default"
        for pack in (True, False):
            t = time.perf_counter()
            res = check_many([src for _, src, _ in sources], backend=GpuSweepBackend(engine=engine), pack=pack)
            pack_rows[f"{label}/{'packed' if pack else 'per_problem'}"] = time.perf_counter() - t
            if [r.intersects for r in res] != [want for _, _, want in sources]:
                fail("route", f"batch (engine={label}, pack={pack}): wrong verdicts")
            if pack:
                packed_sizes = [r.stats["enumeration_total"].bit_length() for r in res if r.stats.get("packed")]
    pack_won = all(pack_rows[f"{e}/packed"] < pack_rows[f"{e}/per_problem"] for e in ("default", "bitset"))
    measured = {
        "kind": kind,
        "sweep_rate": k1_rate * cal_mod.SWEEP_RATE_SAFETY,
        "sweep_rate_measured": k1_rate,
        "sweep_overhead_warm_s": overhead["warm"]["overhead_s"],
        "sweep_overhead_cold_s": overhead["cold"]["overhead_s"],
        "oracle_seconds_per_call": {e: r["seconds_per_call"] for e, r in oracle_rows.items()},
        "pack_win_max_scc": max(packed_sizes) if pack_won else None,
    }
    committed = cal_mod.H100
    phase_line("route", card=card, measured=measured, oracles=oracle_rows, first_solve=overhead,
               batch_seconds=pack_rows, committed_for=committed.kind,
               committed={"sweep_rate": committed.sweep_rate,
                          "sweep_overhead_warm_s": committed.sweep_overhead_warm_s,
                          "sweep_overhead_cold_s": committed.sweep_overhead_cold_s,
                          "oracle_seconds_per_call": committed.oracle_seconds_per_call,
                          "pack_win_max_scc": committed.pack_win_max_scc})

    profiler_seen["route"] = profiler_records(device)

    # -- 13. auto: the default backend, the CLI and in process ------------
    twins = {f"benchmark_fbas(256,core=34,broken={b})": (synth.benchmark_fbas(256, 34, broken=b), not b)
             for b in (False, True)}
    auto_sources = [(name, texts[name], manifest[name]["verdict"]) for name in manifest]
    auto_sources += [(name, json.dumps(src), want) for name, (src, want) in twins.items()]
    files = {}
    for i, (name, src, _) in enumerate(auto_sources):
        files[name] = work / f"source{i}.json"
        files[name].write_text(src)
    variants = {"auto": [], "auto_no_race": ["--no-race"], "gpu_sweep": ["--backend", "gpu-sweep"]}
    # The CLI as a process on one source per route the router takes (the
    # oracle, the sweep, the SCC guard) under each mode; every source runs
    # through AutoBackend in process below.
    cli_sources = ("snapshot_broken.json", "benchmark_fbas(256,core=34,broken=False)", "nested_broken.json")
    cmds, keys = [], []
    for name in cli_sources:
        for var, flags in variants.items():
            cert = work / f"{files[name].stem}.{var}.cert.json"
            cmds.append([sys.executable, "-m", PORT, *flags, "--cert-out", str(cert)])
            keys.append((name, var, cert))
    runs = run_all(cmds, inputs=[files[name].read_text() for name, _, _ in keys], parallel=len(cmds))
    cli_rows = {}
    for (name, var, cert), (so, se, rc, secs) in zip(keys, runs):
        want = dict((n, w) for n, _, w in auto_sources)[name]
        if so.strip().splitlines()[-1:] != ["true" if want else "false"] or rc != (0 if want else 1):
            fail("auto", f"{name} ({var}): printed {so[-40:]!r} exit {rc}; stderr {se[-600:]!r}")
        doc = json.loads(cert.read_text())
        race = (doc.get("provenance") or {}).get("race") or {}
        cli_rows.setdefault(name, {})[var] = {
            "exit": rc, "process_s": secs, "backend": doc["provenance"]["backend"],
            "winner": race.get("winner"), "loser_joined": race.get("loser_joined"),
            "witness": [doc["witness"]["q1_index"], doc["witness"]["q2_index"]] if "witness" in doc else None,
        }
        cert_jobs.append((f"cli/{var}/{name}", files[name].read_text(), doc))
    for name, row in cli_rows.items():
        codes = {var: r["exit"] for var, r in row.items()}
        if len(set(codes.values())) != 1:
            fail("auto", f"{name}: exit codes differ between backends {codes}")
        row["witness_equals_gpu_sweep"] = {var: row[var]["witness"] == row["gpu_sweep"]["witness"]
                                           for var in ("auto", "auto_no_race")}
        for var in variants:
            row[var].pop("witness")
    profiler_seen["auto CLI processes"] = profiler_records(device)
    # The end-to-end number a CLI user sees on a snapshot: one process alone
    # under the default backend, from start (Python, torch, CUDA context,
    # kernel load) to exit.
    cold_cli = {"auto": []}
    for var in cold_cli:
        so, se, rc, secs = run_all([[sys.executable, "-m", PORT, *variants[var]]],
                                   inputs=[texts["snapshot_correct.json"]])[0]
        if rc != 0 or so.strip() != "true":
            fail("auto", f"CLI alone ({var}) on snapshot_correct.json: exit {rc} {se[-400:]!r}")
        cold_cli[var].append(secs)
    # In process, with the launch counts reset before and read after: the
    # fixtures and the full-width twins through the router, race on and off,
    # then the batch through it.  The pipeline's certificate builder is timed
    # on the way (its seconds are part of each solve's).
    import quorum_intersection_tpu_torch.pipeline as pipeline_mod

    cert_build = {"count": 0, "seconds": 0.0}
    real_build_certificate = pipeline_mod.build_certificate

    def timed_build_certificate(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real_build_certificate(*args, **kwargs)
        finally:
            cert_build["count"] += 1
            cert_build["seconds"] += time.perf_counter() - t0

    pipeline_mod.build_certificate = timed_build_certificate
    auto_rows = []
    reset_counts()
    for name, src, want in auto_sources:
        for race in (True, False):
            t = time.perf_counter()
            res = solve(src, backend=AutoBackend(race=race))
            secs = time.perf_counter() - t
            if res.intersects is not want:
                fail("auto", f"{name} (race={race}): intersects={res.intersects}, expected {want}")
            if not want and res.q1 is not None and not witness_ok(src, res):
                fail("auto", f"{name} (race={race}): witness pair is not two disjoint quorums")
            race_stats = res.stats.get("race") or {}
            auto_rows.append({"source": name, "race": race, "seconds": secs,
                              "backend": res.stats.get("backend", res.stats.get("reason")),
                              "winner": race_stats.get("winner"), "loser_joined": race_stats.get("loser_joined"),
                              "oracle_outcome": race_stats.get("oracle_outcome")})
            cert_jobs.append((f"auto/{'race' if race else 'no_race'}/{name}", src, res.cert))
            profiler_seen[f"auto in process: {name} race={race}"] = profiler_records(device)
    auto_launches = guard_counts_now()
    if auto_launches["sweep_fused_cuda"] < 1:
        fail("auto", "the auto path never launched sweep_fused_cuda")
    twin_rows = [r for r in auto_rows if r["source"] == "benchmark_fbas(256,core=34,broken=False)"]
    if not all(r["backend"] == "gpu-sweep" for r in twin_rows):
        fail("auto", f"the full-width correct twin was not decided by the sweep: {twin_rows}")
    t = time.perf_counter()
    auto_batch = check_many([src for _, src, _ in sources])
    auto_batch_s = time.perf_counter() - t
    if [r.intersects for r in auto_batch] != [want for _, _, want in sources]:
        fail("auto", "check_many through the router: wrong verdicts")
    cert_jobs += [(f"auto_batch/{name}", src, r.cert) for (name, src, _), r in zip(sources, auto_batch)]
    pipeline_mod.build_certificate = real_build_certificate
    profiler_seen["auto check_many"] = profiler_records(device)
    phase_line("auto", card=card, cli=cli_rows, cold_cli_snapshot_correct_seconds=cold_cli,
               in_process=auto_rows, launches=auto_launches,
               batch={"seconds": auto_batch_s,
                      "backends": sorted({r.stats.get("backend", "scc_guard") for r in auto_batch}),
                      "packed": sum(1 for r in auto_batch if r.stats.get("packed"))},
               verdicts=f"{len(cli_sources)}/{len(cli_sources)} CLI exit codes equal across the modes; "
                        f"{len(auto_sources)}/{len(auto_sources)} in-process verdicts right")
    phase_line("profiler", device_events_recorded_after=profiler_seen)

    # -- 14-16. PageRank: K12 against its plain version, timed, -p ---------
    pagerank_record = pagerank_phases(device, card, texts, work, args.k12_parent)

    # -- 17. analysis: the analysis modes and the sanitizer ----------------
    analysis_phase(card, texts)

    # -- 18. rank: the sweeps under the rank order --------------------------
    rank_phase(card, texts, manifest, sources, cert_jobs, witness_ok, work)

    # -- 19-22. the frontier: K9 and K10 against their plain versions, driven,
    # routed and timed ----------------------------------------------------
    frontier_records = frontier_phases(device, card, texts, manifest, cert_jobs, witness_ok, work,
                                       args.frontier_parent)

    # -- 23-26. the bitset engine: K8 against its plain version, timed beside
    # K1, routed, and the sweep's checkpoints -------------------------------
    bitset_record = bitset_phases(device, card, texts, manifest, cert_jobs, witness_ok, work, ptxas, args.k8_parent)

    # -- 27-29. the observability and fault layer and the query subcommand --
    fault_runs = observe_phase(device, card, texts, manifest, cert_jobs, work, beside=faults_cli_jobs(texts, work))
    faults_phase(device, card, texts, cert_jobs, work, fault_runs)
    query_phase(device, card, texts, cert_jobs, work)

    # -- 30. delta: incremental re-analysis through the card's kernels ------
    delta_launches = delta_phase(device, card, texts, cert_jobs, work)

    # -- 31. serve: the serve subcommand as processes on the card ----------
    serve_launches = serve_phase(device, card, texts, manifest, cert_jobs, work)

    # -- 32. fleet: the replicated serve tier on the card --------------------
    fleet_launches = fleet_phase(device, card, texts, manifest, cert_jobs, work)

    # -- 33-34. the native host layer and the tooling ------------------------
    native_phase(device, card, texts, manifest, cert_jobs, work, main_cli=cli, k1_rate=full[0]["candidates_per_s"])
    tooling_phase(device, card, cert_jobs, work)

    # -- 35. mesh: the mesh sweep K11 and the multi-process runtime ----------
    mesh_record = mesh_phase(device, card, texts, manifest, cert_jobs, work, args.k1_parent)

    # -- 36. frontier_mesh: K9's two mesh instances, the frontier under a mesh
    frontier_mesh_records = frontier_mesh_phase(device, card, texts, cert_jobs, work)

    # -- 37. cert: every certificate through the unmodified checker --------
    t = time.perf_counter()
    bad, checked = check_certificates(cert_jobs, work)
    cert_wall = time.perf_counter() - t
    if bad:
        fail("cert", f"{len(bad)} certificate(s) refused by tools/check_cert.py: {bad[:5]}")
    pruned_blocks = sum(len((doc.get("coverage", {}).get("sccs") or [{}])[0].get("pruned_blocks", {})
                            .get("prefixes", [])) for _, _, doc in cert_jobs if doc.get("verdict"))
    phase_line("cert", card=card, checked=len(cert_jobs), refused=0,
               build_seconds_in_phase_auto=cert_build,
               checker_seconds_total=sum(r[3] for r in checked), checker_wall_seconds=cert_wall,
               pruned_blocks_reverified=pruned_blocks,
               verdicts={"true": sum(1 for _, _, d in cert_jobs if d.get("verdict")),
                         "false": sum(1 for _, _, d in cert_jobs if d.get("verdict") is False)})
    import shutil

    shutil.rmtree(work, ignore_errors=True)

    # Each kernel's device time on the main path (profiler): K1 in the
    # full-width solve, K3 in the default-engine batch, K4 in the bitset
    # batch, the guards in the pruned batches of their engine.
    main_device_ms = {
        "sweep_fused_cuda": ms_of(full_device_ms, "sweep_kernel"),
        "packed_sweep_dense_cuda": ms_of(batch_device_ms["default"], "packed_kernel"),
        "packed_sweep_bitset_cuda": ms_of(batch_device_ms["bitset"], "packed_kernel"),
        "guard_dense_cuda": ms_of(pruned_device_ms["default"], "guard_kernel"),
        "guard_bitset_cuda": ms_of(pruned_device_ms["bitset"], "guard_kernel"),
    }
    main_device_ms_of = {
        "sweep_fused_cuda": "full, benchmark_fbas(256, core=34)",
        "packed_sweep_dense_cuda": "batch, default engine",
        "packed_sweep_bitset_cuda": "batch, bitset engine",
        "guard_dense_cuda": "batch_pruned, default engine",
        "guard_bitset_cuda": "batch_pruned, bitset engine (both encodings' guards run one kernel)",
    }
    snap = timing["bench256_34"]
    record = {"kernels": [{
        "name": "sweep_fused_cuda",
        "route": kernels_meta["sweep_fused_cuda"]["route"],
        "source": kernels_meta["sweep_fused_cuda"]["source"],
        "replaces": kernels_meta["sweep_fused_cuda"]["replaces"],
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": snap["ms"],
        "plain_ms": snap["plain_ms"],
        "bound_ms": snap["bound_ms"],
        "bound_by": snap["bound_by"],
        "library_ms": None,
        "main_path_device_ms": main_device_ms["sweep_fused_cuda"],
        "main_path_device_ms_of": main_device_ms_of["sweep_fused_cuda"],
        "compare_launches": compare_launches,
        "auto_path_launches": auto_launches["sweep_fused_cuda"],
    }]}
    for engine, name in (("dense", "packed_sweep_dense_cuda"), ("bitset", "packed_sweep_bitset_cuda")):
        pt = packed_timing[f"widest/{engine}"]
        record["kernels"].append({
            "name": name,
            "route": kernels_meta[name]["route"],
            "source": kernels_meta[name]["source"],
            "replaces": kernels_meta[name]["replaces"],
            "launches": batch_launches[name],
            "max_abs_err": packed_err[engine],
            "ms": pt["ms"],
            "plain_ms": pt["plain_ms"],
            "bound_ms": pt["bound_ms"],
            "bound_by": pt["bound_by"],
            "library_ms": None,
            "main_path_device_ms": main_device_ms[name],
            "main_path_device_ms_of": main_device_ms_of[name],
        })
    for enc, name in (("dense", "guard_dense_cuda"), ("bitset", "guard_bitset_cuda")):
        gt = guard_timing[f"near_disjoint_cores(15,1)/{enc}"]
        record["kernels"].append({
            "name": name,
            "route": kernels_meta[name]["route"],
            "source": kernels_meta[name]["source"],
            "replaces": kernels_meta[name]["replaces"],
            "launches": prune_launches[name] if enc == "dense" else batch_pruned_launches[name],
            "max_abs_err": guard_err[enc],
            "ms": gt["ms"],
            "plain_ms": gt["plain_ms"],
            "bound_ms": gt["bound_ms"],
            "bound_by": gt["bound_by"],
            "library_ms": None,
            "main_path_device_ms": main_device_ms[name],
            "main_path_device_ms_of": main_device_ms_of[name],
        })
    # Each kernel's instances as ptxas built them: registers and spills.
    library_of = {"sweep_fused_cuda": "sweep", "packed_sweep_dense_cuda": "packed_sweep",
                  "packed_sweep_bitset_cuda": "packed_sweep", "guard_dense_cuda": "guard",
                  "guard_bitset_cuda": "guard"}
    record["kernels"].append(bitset_record)
    library_of["bitset_sweep_cuda"] = "bitset_sweep"
    record["kernels"].append(pagerank_record)
    library_of["pagerank_cuda"] = "pagerank"
    record["kernels"] += frontier_records
    library_of.update({entry["name"]: "frontier" for entry in frontier_records})
    record["kernels"].append(mesh_record)
    library_of["sweep_mesh_cuda"] = "sweep"
    record["kernels"] += frontier_mesh_records
    library_of.update({entry["name"]: "frontier" for entry in frontier_mesh_records})
    for entry in record["kernels"]:
        entry["instances"] = ptxas.get(library_of[entry["name"]])
        entry["delta_path_launches"] = delta_launches.get(entry["name"], 0)
        entry["serve_path_launches"] = serve_launches.get(entry["name"], 0)
        entry["fleet_path_launches"] = fleet_launches.get(entry["name"], 0)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
