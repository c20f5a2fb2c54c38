#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # one card: every phase below
    python3 chip_smoke.py --cards    # several cards: the multi-card
                                     # paths alone (``cards_phase``)

1. Prints the card (``nvidia-smi``) and builds the CUDA kernels from
   ``clawker_tpu_torch/kernels/csrc`` into ``build/kernels/``.
2. Kernel phase: K1 (score), K2 (fit step) and K3 (the whole fit, one
   launch) against their plain PyTorch versions on the card, at the main
   path's shapes, one ragged n, fewer rows than one K2 tile, more K2
   tiles than blocks and one odd F for each width K2 pads F to (16, 64),
   with the tolerances below; each K2 fit also beside the plain fit on
   the CPU, the drift that summation order alone gives; two K2 fits, and
   two K3 fits, from the same inputs must agree bit for bit, and K3 bit
   for bit with the loop of K2 launches; each kernel's median time beside
   its bound, and K1's beside the launch floor (an empty kernel in the
   same harness).  Two K1 scores from the same inputs must agree bit for
   bit, and K1's mean score must agree with K2's noise-free step-0 loss
   within STEP1_LOSS_RTOL.  K2's first step's slots, summed, must agree
   with the plain fp32 sums of the unrounded gradients
   (``reference.step_grads``) within SLOT_SUM_RTOL.  K3's staged weights
   must equal their plain version (``reference.staged``) bit for bit,
   and at RELOAD_SHAPE, too large for its x tiles to stay in shared
   memory, K3 must still be bit-identical to K2's loop.  At OPT_IN_SHAPE
   K1, K2 and K3 run on every visible device, each of which opts in to
   more than 48 KB of shared memory on its own.  At CHAOS_SHAPE x
   CHAOS_STEPS (the chaos sentinel's tick) K3 must be bit-identical to
   K2's loop and to itself, within the fit tolerances of the plain fit,
   and K1 after it within the score tolerances of the plain score; both
   timed beside their bounds.  The three kernels'
   registers and spills as ptxas reports them (spills must be 0).
3. Main-path phase, at full width (F = 32 / 40, H = 128): ``score_windows``
   on the bench's synthetic fleet ([640, 32] padded) and on an hour of a
   64-agent fleet ([4224, 32]), 120 fit steps each; the sentinel's
   ``ScoringEngine.score_tick`` on the 64-agent fused tick ([384, 40],
   40 steps) three times; a seeded exfil agent must score hottest.  The
   kernels' launch counters are zeroed before and read after each run:
   every fit is one K3 launch and no K2 launch.  Each case prints its
   fit's ``train_ms``, the host's enqueue time per fit (no synchronize
   inside) and its parts, K3's device time per fit beside its bound, its
   phase trace (the step's phases, and phase A's sub-stages), and the
   noise draw's (K4) device time beside its bound.
4. Sentinel phase, the live ``FleetSentinel`` on the card (F = 40),
   its streams under ``build/chip_smoke/sentinel/``: (a) the 64-agent
   fused tick over four worker files ([384, 40], 40 steps): the first
   tick scores every window, an idle tick launches nothing, a seeded
   exfil burst on one worker flags within two ticks with that worker and
   kind ``egress``, through a typed ``anomaly.flag`` bus event and the
   registry, and the state file resumes a fresh sentinel; (b) a full
   collector buffer (98,304 records, [4224, 40]), three scored ticks;
   (c) the flag latency of the reference bench's scenario
   (bench.py:2376-2440), live on the ticking thread, 5 reps, each flag
   within 10 s.  Every tick runs through ``_counted``: one K3 and one
   K1 launch per scored tick, none per idle tick, no ``on_error``
   message.  Prints each stage's host ms of a tick at (a) and (b), and
   the flag latency's p50 and max.
5. K5 (the fit over rows split into shards): the per-step route (a launch
   A per shard and a launch B a step) one step against its plain version
   at every KERNEL_SHAPES entry over 2 and 4 shards; the one-launch fit
   (``anomaly_fit_shard_fit``, the route of every fit whose shards lie on
   one card) bit for bit against the per-step route at every
   KERNEL_SHAPES entry over 1, 2, 4 and 8 shards, on both fleets, and at
   RELOAD_SHAPE over 2 shards (x not resident), bit for bit against K3
   over 1 shard, twice the same bits, and against the plain sharded fit
   at K3's tolerances; its time per 120-step fit on both fleets over 1,
   2, 4 and 8 shards beside the per-step route's and K3's, with its phase
   trace over 4 and 8 shards; the sharded main path (the hour over 4
   shards of the card) is one K5 launch and 4 K1 launches.  The graft
   entry (``entry``, ``dryrun_multichip(8)``: the per-step route, counted)
   and ``bench_lane`` on the card.
   K5b (the fit with the hidden dimension split over two model shards)
   over 2x2 and 4x2 meshes of the card: the per-step route's step
   against its plain version at every KERNEL_SHAPES entry; there, and at
   TIMED_SHAPE x FIT_STEPS, the fold (one launch) and the cards route
   with one participating card (``anomaly_fit_model_cards``) bit for bit
   the per-step route's; each route's time, trace and staged images.  On
   one card the main path takes the fold, so the cards route's launches
   there are 0 and those checks are what launch it; with several cards
   visible the sentinel tick over the fleet mesh takes it (one launch a
   card a fit).  With ``--cards`` the cards route runs over the fleet
   mesh of several cards (``cards_phase``).
6. Loop phase, the port's own ``LoopScheduler`` over ``FakeDriver`` (4
   workers, 8 loops x 3 iterations of 0.2 s each), its dirs under
   ``build/chip_smoke/loop/``, on default settings (the host proxy up on
   a free port): (a) with the live
   ``FleetSentinel`` ticking every 0.05 s while a writer fills the
   workers' streams mid-run (live timestamps, an exfil burst on one
   agent): every loop ends ``done`` after 3 iterations, every status row
   carries ``anomaly_z``, the burst agent has the highest peak z and an
   ``anomaly.flag`` on the run's bus, the behaviour tracker holds every
   loop (the bus tap) and ``audit()`` is zero; one K3 and one K1 launch
   per scored tick, none per idle tick, no K2 or K5; (b) the same run
   with the egress ``AnomalyWatch`` (F = 32): one K3 and one K1 per
   refresh; (c) ``python -m clawker_tpu_torch loop -p 4 -n 2 --sentinel
   --json`` on the fake driver in a subprocess must exit 0 with every
   agent done.  Prints the runs' wall ms, ticks and (a)'s per-tick stage
   medians.
7. loopd phase, its dirs under ``build/chip_smoke/loopd/``: (a) an
   in-process ``LoopdServer`` over 4 fake workers with its
   daemon-lifetime sentinel on the card every 0.05 s: two clients submit
   runs of (6)'s shape, an exfil burst lands mid-run; both runs are
   daemon-owned over one admission controller, the status RPC's rows
   hold the burst agent hottest and flagged, each scored tick is one K3
   and one K1, and ``fleet anomaly`` in a subprocess reads the daemon and
   exits 2; (b) ``loopd start`` (a forked daemon), ``loop -p 4 -n 2
   --json`` (submitted to it), ``loop attach``, ``loopd stop``: a
   ``sentinel.tick`` span scored on the card lands in the daemon's flight
   record; (c) no proxy or loopd pidfile is left.  One line per case
   with its host ms.
8. workerd phase, its dirs and sockets under ``build/chip_smoke/workerd/``:
   (a) (6a)'s run over workerd, one ``WorkerdServer`` per fake worker on
   its local engine view and a ``WorkerdExecutor`` for each: exactly 8
   ``container_create`` calls, all through the local views and no launch
   call through the remote ones, every server executed intents and
   streamed exits, each scored sentinel tick one K3 and one K1 on the
   card, the burst agent hottest and flagged, and ``tracing.merge_run``
   over the run's flight records one rooted tree per iteration with its
   ``workerd.*`` children and no ``gap``; (b) the fake-WAN legs of the
   reference's ``bench_workerd_rtt_independence`` (8 loops, 4 workers, 4
   iterations of 0.15 s, 50 ms injected RTT), workerd and direct at 0
   and 50 ms: the workerd leg's ratio at most 1.5; (c) an in-process
   ``LoopdServer(executors=<factory>)`` with its sentinel on the card
   hosts (a)'s run: the status RPC reads every worker's workerd
   ``live``, one is killed mid-run, its row turns ``degraded`` and its
   loops finish over the direct path, each scored tick one K3 and one
   K1; (d) ``workerd start`` / ``status`` / ``stop`` forked, no daemon
   left.  One line per case with its host ms.
9. resume phase, its dirs and sockets under ``build/chip_smoke/resume/``,
   the warm pool and ``--resume`` over (6)'s fake pod: (a) (6a)'s run
   with the reference's default warm pool (depth 2 a worker, prefilled:
   8 members) and the sentinel on the card, the scheduler killed once
   every loop finished iteration 1, then ``LoopScheduler.resume`` +
   ``reconcile`` with a fresh sentinel on the same run id: generation
   1's pool hits at least 1, every loop ``done`` with 3 exit codes
   journaled once each, the creates after the kill plus generation 2's
   pool hits equal to ``relaunched``, one container per agent (a create
   or an adopted member), every journaled pool member restored, swept or
   never created, the restored sentinel holding baseline samples and
   generation 1's flags, none of them flagged again, and each scored
   tick of both generations one K3 and one K1; prints the reconcile
   summary and wall ms, the create ms of a pool hit and of a cold create
   (the run's spans and the orchestrator's stages) and generation 2's
   tick stages; (b) (a)'s pooled run over workerd: fills as ``create``
   intents, hits as launch intents with a ``pool_cid`` whose ``created``
   event reads ``pool: True`` with no ``pool_error``, and after a kill
   and a resume one ``adopt`` intent per adopted container; (c) loopd's
   ``adopt_run``: a daemon with its sentinel on the card hosting a pooled
   2-loop run is killed mid-run and a second daemon adopts the run, every
   loop done with one container per agent, the second daemon's sentinel
   scoring the adopted run on the card; (d) ``loop --resume <prefix>
   --sentinel --json``, ``journal verify`` (0), on a copy with one byte
   flipped (2), ``--repair`` (the copy folds clean again), in process.
10. worktrees phase, its dirs under ``build/chip_smoke/worktrees/``, each
   project a git repository with one commit (``git --version`` printed
   first), gitguard over WT_HOSTS (three run-scoped rule keys) with its
   socket in a short temporary directory, and a user's rule in the
   egress store: (a) (6a)'s shape as a bind-mode ``loop --worktrees``
   swarm with the sentinel on the card: 8 ``seed_worktree`` records
   with distinct agents, paths and branches ``loop/<run>/<agent>``,
   each worktree linked (its ``.git`` a file), every agent ``merged``
   onto ``loop/<run>/merged``, the guard up and running through the
   run, one ``gitguard_rules`` record holding the 3 keys journaled
   before the store held them, after ``cleanup`` the guard down, the
   keys gone and the user's rule kept, each scored tick one K3 and one
   K1, the burst agent hottest and flagged; prints the provision,
   guard-setup, merge-tick and drain host ms; (b) a real git client
   through ``GitguardServer`` over TCP on a seed repository: its own
   push lands, a sibling's is ``[remote rejected]``, the integration
   branch takes the merge queue's identity only, ``ls-remote`` hides
   the sibling, the decisions and the ``gitguard_*`` counters read 2
   allow and 2 deny; (c) the swarm over the workerd phase's pod: in
   snapshot mode 8 creates all through workerd and one seed digest an
   agent, in bind mode every loop direct, the sentinel scoring both;
   (d) (a)'s swarm killed after iteration 1 and resumed with a fresh
   sentinel: no new worktree record or branch, the guard re-armed on
   the journaled keys, every agent landed, the keys gone after
   ``cleanup``; (e) ``loop --worktrees -p 2 -n 1 --sentinel --no-daemon
   --json`` through ``CliRunner``, and an in-process ``LoopdServer``
   with its sentinel hosting a 2-loop swarm, its status RPC's
   ``gitguard`` row enabled and running, its ticks on the card.
11. chaos phase, its dirs under ``build/chip_smoke/chaos/`` (the soft
   disk watermark below any disk, the host proxy off): (a) ``run_soak(4,
   20260803, keep_going=True, device="cuda")``, each scenario's verdict,
   kills, generations, injections and wall printed: all four hold every
   invariant, the observe-only twin passes, and every scored tick of the
   sentinel scenarios (1 and 3) and of the twin's sentinel run is one K3
   and one K1 on the card; (b) ``run_observe_only_check(device="cuda")``
   is ``[]`` with its sentinel scored on the card; (c) one hand-written
   plan with the sentinel, capacity (a traffic burst, a scale-down), the
   shipper (its index down) and a ``cli_sigkill`` armed at 0.0 s holds
   every invariant with one kill over two generations, the controller's
   decisions and the shipper's failed flushes and drops counted; (d)
   ``python -m clawker_tpu_torch chaos run --scenarios 4 --seed 20260803
   --json`` and ``chaos replay --seed 20260803 --scenario 1`` forked,
   exit 0; (e) an in-process ``LoopdServer`` with settings
   ``capacity.enable``, ``monitoring.shipper.enable`` and
   ``sentinel.enable`` hosts a run: its status RPC's ``capacity`` row
   ticked, its ``shipper`` row took docs, each scored tick one K3 and
   one K1.
12. views phase, its dirs under ``build/chip_smoke/views/`` (the host
   proxy off): (a) loop (a)'s run inside a ``LoopDashboard`` painting on
   the slave end of a 120x40 pseudo-terminal: the final frame (the
   escapes applied, then stripped) has the ANOM-Z column, each agent's
   cell ``sched.status()``'s ``anomaly_z`` to one decimal, the burst
   agent at or over ``ANOMALY_Z`` and red, the status bar's
   ``anom-max`` the largest z; (b) ``python -m clawker_tpu_torch loop
   --parallel 8 --iterations 6 --sentinel`` forked onto such a terminal
   (``pty.fork``) exits 0 having painted frames and no per-event lines,
   its final frame with the ANOM-Z column and the run's lines below it
   as the terminal shows them, and with ``--json`` paints nothing; (c) loopd with ``loopd.metrics_port`` hosts two 8-loop runs:
   ``fleet console --once`` and ``--format json`` (forked) show the burst
   agent's ANOM-Z equal to the status RPC's sentinel row,
   ``FleetConsole.snapshot()`` both runs, the daemon's ``/metrics`` that
   agent's ``anomaly_score`` and ``sentinel_ticks_total{result=
   "scored"}``; (d) ``loop --metrics-port`` in process with settings
   ``telemetry.otlp`` and a stub collector: a scrape mid-run carries the
   burst agent's ``anomaly_score``, the stub holds ``clawker-telemetry``
   batches, the last (``stop()``'s final flush) with that sample; (e)
   the reference bench's console repaint (256 agents over 4 runs, 80
   frames; host work): p95 under 50 ms, the frame at most 140 lines.
   Every scored tick of (a), (c) and (d) is one K3 and one K1.
13. engines phase, its dirs under ``build/chip_smoke/engines/``, every
   case over ``LocalDriver`` (the ``local`` driver's Docker HTTP
   client) and a ``FakeEngineDaemon`` on a unix socket in its dir (the
   loop image with (6)'s 0.2 s behaviour), stopped in a ``finally``;
   HOME at a home holding the claude harness's host files: (a) (6a)'s
   run on the one worker ``local-0`` with the reference's default warm
   pool depth (prefilled) and the sentinel on the card: every loop
   done, each agent's placement one create on the daemon (its own, or
   the fill of the pool member it adopted) and its starts, the
   client's pool ``reuses > 0`` and ``stale_retries == 0``, every
   ``engine.request`` span of the flight record a child of a span of
   the run's trace (unless the disk ladder sheds the record), the
   burst agent's z at least ``ANOMALY_Z`` and flagged,
   ``harness_seed.tar_cache_hit`` above 0; prints the run's wall, the
   requests and the dials beside the card line; (b) one create: the
   archive the daemon received at the container home holds
   settings.json with only ``enabledPlugins``, CLAUDE.md byte for byte
   and no credentials, and with settings ``credentials.stage: true``
   the credentials too; (c) (a)'s run killed after iteration 1 and
   resumed over a fresh ``LocalDriver``: the engine cannot relabel, so
   an adopted pool member keeps its ``pool`` epoch label, and at least
   one such row held by the journal is kept, with no create after the
   kill for it; (d) ``python -m clawker_tpu_torch loop -p 4 -n 2
   --sentinel --json`` forked with ``DOCKER_HOST`` at the daemon and
   no ``CLAWKER_TPU_DRIVER`` exits 0 with its creates served; at an
   absent socket it exits 1 with the reference's "Docker socket ...
   not found" and the daemon sees no request; ``loopd start`` with
   settings ``sentinel.enable`` hosts a 4-loop run against the daemon,
   a scored daemon tick lands in its flight record, ``loopd stop``; (e)
   the reference bench's ``bench_engine_dials`` (host work) through the
   port's client over its ``StubDockerDaemon``: ``dial_reduction`` at
   least 2.  Every scored tick of (a) and (c) is one K3 and one K1.
14. pod phase, its dirs under short temporary dirs (unix socket paths
   hold 107 bytes), every case over four worker hosts ``w0``..``w3`` on
   the loopback ssh (``testenv.install_ssh_shim``, first on ``PATH``),
   each a root with its own ``FakeEngineDaemon`` and egress file,
   settings ``runtime.driver: tpu_vm`` with the four workers and
   topology 2x2; no seam process, and no process whose home or cwd lies
   under a worker's root, may outlive a case: (a) (6a)'s run
   over ``get_driver`` (``TPUVMDriver``, its real ``Runner``) with the
   host proxy on and the sentinel on the card wired by ``wire_fleet``,
   the hot agent's egress on ``w2`` only: every loop done, creates and
   starts on all four daemons, one ``-L`` docker forward, one ``-R`` and
   one remote ``tail -F`` a worker, records tagged ``tpu-0``..``tpu-3``,
   the hot container flagged at ``ANOMALY_Z`` or more on ``tpu-2``, no
   forward left after ``close()``; (b) the port's workerd forked on
   ``w0``/``w1`` at the canonical socket under the worker's home:
   ``discover_executors`` finds those two over forwarded sockets,
   ``liveness`` reads them live and the others not live, and an 8 x 2
   run launches through workerd there and directly on ``tpu-2``/
   ``tpu-3``; the host proxy workerd's side channels left up on each
   worker is stopped as the worker; (c) an 8 x 4 run loses ``w1``'s daemon ("docker daemon
   unreachable but host ssh alive") and then ``w3``'s host ("host
   unreachable over ssh"), every loop ending on ``tpu-0``/``tpu-2``,
   and a pod whose ``w2`` is down from the start dials it engine-less
   and runs on the other three; (d) ``loop --sentinel``, ``fleet
   workers``, ``fleet anomaly`` (exit 2, the hot agent on ``tpu-2``),
   ``fleet provision --dry-run --no-cp`` and ``fleet provision
   --dry-run`` (the control plane's steps in the plan, no ssh) forked
   on default settings; (e) ``connect()``
   timed with and without 50 ms a seam call (host work).  Every scored
   tick of (a), (b) and (c) is one K3 and one K1.
15. images phase, its dirs under ``build/chip_smoke/images/``, every
   case forked over a ``FakeEngineDaemon`` socket on the ``local``
   driver that holds no image before the build, the supervisor built
   from ``native/`` into ``build/native/`` (``CLAWKER_TPU_SUPERVISOR_BIN``
   points at it): (a) ``init``, ``build`` off a TTY and ``build
   --plain`` with ``firewall.enable`` on the BuildKit lane: two
   ``version=2`` builds a command tagged ``:base`` and ``:claude`` and
   one ``:default`` tag, the decoded ``#N`` vertex lines, ``image ls``,
   each context's Dockerfile byte for byte the one ``generate_base`` /
   ``generate_harness`` write in this process, the harness context's
   tail (the CA, the supervisor, the zipapp); (b) ``build --plain`` on
   a legacy daemon, on one that refuses BuildKit (one refused request,
   then legacy for both stages) and on one whose stream carries an
   ``errorDetail`` (exit 1, nothing tagged), and ``image rm`` of the
   three tags; (c) the context's supervisor and the port's zipapp
   (deterministic, exactly the port's closure, ``python3 -I`` over it
   loads neither torch nor JAX), the supervisor running the zipapp as
   its ``--child`` with a session over mTLS that brings up the image
   command on ``AgentReady``; (d) the behaviour set on the built
   ``:default`` only then, ``loop -p 8 -n 3 --sentinel`` forked on it
   (the hot agent hottest, a flagged tick on the card) and the same run
   in this process over ``LocalDriver`` (the hot agent flagged first,
   every scored tick one K3 and one K1); (e) the host walls.
16. federation phase, its dirs under ``build/chip_smoke/federation/``,
   two in-process ``LoopdServer`` pods over one config on disk (pod A
   at the canonical socket through settings ``loopd.socket``, both under
   ``federation.pods``), each on 2 fake workers: (a) with ``sentinel.
   enable``, ``fed status --format json`` forked reads both pods alive
   and healthy; (b) ``loop -p 8 -n 3 --pods --json`` forked shards the
   run over both pods through the ``FederationRouter``; live egress for
   every agent and a 55-record burst on one agent of pod A's shard:
   each pod's daemon sentinel scores on the card (one K3 and one K1 a
   scored tick, counted a sentinel), the hot agent flags on pod A and
   pod B never sees it, and the forked ``fleet health`` (JSON, and its
   table's ANOM-Z on the hot agent's worker), ``fleet placement`` and
   ``fleet warmpool`` read pod A; (c) without sentinels, a run held on a hold-event behaviour is
   killed on pod A after its creates and ``migrate_pod`` moves it: every
   loop reaches its budget on pod B, ``cross_pod_exactly_once`` is
   green, the merged trace roots the iterations at ``router.submit``;
   the migration's walls printed; (d) host work: bench.py:1635's
   fan-out scaled to the two pods (128 loops, 5 ms a control RPC), the
   leases at least LEASE_AMORTIZATION_MIN x fewer admission RPCs than
   the per-launch protocol.
17. bundles phase, its dirs under ``build/chip_smoke/bundles/``, the
   repositories it makes ignoring the host's git config: (a)
   ``examples/clawker-test-bundle`` committed into a fresh repository,
   then forked ``bundle install file://...``, ``list``, ``validate``,
   ``update`` before and after a commit (the receipt's commit follows),
   ``prune`` dry run and ``--apply`` (an unreferenced install removed);
   (b) settings ``build.harness: echo``: ``build --plain`` over a
   ``FakeEngineDaemon`` on the installed harness, a drifting commit,
   ``run -d`` reporting the bundle update, then images (d)'s ``loop -p
   8 -n 3 --sentinel`` run on the built image in process (every scored
   tick one K3 and one K1; images (d) forks that same loop); (c) ``plugin install|list|remove`` of
   ``examples/clawker-plugin`` into a skills dir under ``build/``,
   ``gen-docs --out build/chip_smoke/docs/cli-reference`` (nothing under
   ``docs/`` changes), the update check with a stubbed fetcher.  No
   process this run starts checks for a release over the network
   (``CLAWKER_TPU_NO_NOTICES``).
18. egress phase, its dirs under ``build/chip_smoke/egress/`` (the host
   proxy off): (a) ``egress_traffic`` through the port's lane: 64
   cgroups enrolled with ``FLAG_ENFORCE`` in a ``FakeMaps``, routes from
   ``build_routes`` for two allowed zones, a ``DnsGate`` on loopback
   (port 0) forwarding to a loopback upstream (``LoopbackUpstream``,
   through the gate's ``_forward`` seam) that answers each container's
   query and writes ``dns_cache``, ``connect4`` decisions over three
   drains in three seconds (routed connects and a few ``NO_DNS_ENTRY``
   denies, then a 55-connect deny storm from one container), a
   ``NetLogger`` draining into the logs dir's ``ebpf-egress.jsonl``:
   ``emitted`` equals the decisions that emit an event, none dropped,
   and ``monitor egress --deny-only --tail 5`` forked prints the storm's
   lines; (b) ``monitor anomalies --window 1 --threshold 3.5`` forked on
   the card over that file exits 2 with the storm container first and
   anomalous; (c) a live ``FleetSentinel`` tailing the file (one-second
   windows) flags the storm container on the bus, ranks it first, and
   each scored tick is one K3 and one K1; (d) ``monitor init`` and
   ``monitor units`` forked (the five compose services, the seven log
   indices, the floor's ``claude-code`` unit seeded), then ``up``,
   ``status`` and ``down`` in process over a recording runner (the ``up
   -d`` argv, the units ledger reset on ``down``).  Each step's host ms.
19. firewall phase, its dirs under ``build/chip_smoke/firewall/`` (the
   host proxy off), settings ``firewall: {enable: true, default_deny:
   false, dns_upstreams: [the loopback upstream]}``: (a) ``firewall
   add-rule '*.pypi.org'``, ``rules``, ``resolve files.pypi.org`` and
   ``status`` forked over the fake driver seeded with Envoy's image (the
   rule persists into the next process, resolves to zone ``pypi.org``);
   (b) ``loop -p 8 -n 3 --sentinel`` in process on the card, each
   iteration's container held: the run's own creates bring up the data
   plane (Envoy's container, the DNS gate on loopback, the routes) and
   enroll every agent with ``FLAG_ENFORCE``, by its container id; each
   agent resolves through the handler's gate and connects over its maps
   for three drains a second apart, one adding the 55-connect deny
   storm; a ``NetLogger`` with ``handler_resolvers`` drains into the
   run's stream, none dropped; the storm agent's container id is flagged
   and ranks first, each scored tick one K3 and one K1; (c) on that
   handler: ``bypass`` of two agents (connects pass inside the deadline
   and are denied past it; one dead-man timer clears its entry, the
   other is lost and ``gc_tick`` clears it), ``add-rule`` while the run
   lives (more routes, Envoy recreated under a new sha), ``disable``
   unenrolls, ``remove`` after the run stops the gate and removes Envoy;
   (d) forked ``firewall status`` in strict mode exits 1 with
   ``FirewallUnavailable``'s text, and with ``control_plane.enable``
   starts the control plane (forked, on free ports) and answers over
   its AdminService; ``controlplane down`` stops it.  Each step's host
   ms.
20. fwkernel phase, its files under ``build/chip_smoke/fwkernel/``:
   (a) the nine eBPF programs assembled over ``FwMapFds(*range(3,
   11))``, each one's instruction count and sha256 printed and held
   against ``BPF_PROGRAM_SHA256``, and the port's ``RingBufReader`` over
   a memfd laid out as the kernel lays out a ring (``ring_sample``:
   records that wrap, one discarded, one busy); (b) one line of the
   probe's facts (euid, ``CapEff``, ``cgroup2_root()``,
   ``bpfkern.kernel_available()``, ``runtime.inprocess_kernel_available()``);
   (c) where the probe passes: the nine programs through the verifier in
   a ``KernelAttacher``, eight scratch cgroups attached and enrolled with
   ``FLAG_ENFORCE`` in its ``LiveMaps``, probe children forked into them
   making routed connects (landing on a loopback Envoy double, reading
   back the address they aimed at), denied literals (EPERM) and one
   agent's 50-connect deny storm over three drains a second apart, a
   ``NetLogger`` naming each cgroup draining the kernel's ring into the
   stream of a live sentinel, which flags the storm agent first, each
   scored tick one K3 and one K1; (d) where it fails: the reason
   printed, and the same storm's records decoded from a memfd ring by
   ``LiveMaps``' drain into the same netlogger and sentinel, labelled
   decoded, not enforced.
21. controlplane phase, its dirs under ``build/chip_smoke/controlplane/``
   (the host proxy off), the firewall phase's settings with
   ``control_plane: {enable: true}`` on free ports: (b) an in-process
   ``ControlPlaneDaemon`` on those ports and the settings' PKI dir holds
   the monitor-mode handler (its gate on a port free for TCP) and a
   ``NetLogger`` into the run's stream, its dialer resolving no endpoint
   for the fake driver's containers; ``loop -p 8 -n 3 --sentinel`` in
   process on the card, so every create's ``FirewallInit`` (a fresh
   container) and ``FirewallEnable`` (every start) arrive over the
   AdminService, counted by method; the firewall phase's rounds and
   storm from the run's enrolled agents over the daemon's maps; the
   storm agent flagged and first, each scored tick one K3 and one K1;
   ``ListAgents`` lists the run's 8 agents once the factory's
   bootstrapper bound their rows; the GC ticker ran; (c) the port's
   ``Agentd`` on loopback over material minted from the control plane's
   CA: ``Dialer.drive`` returns ``ready`` (registered through the
   daemon's AgentService, initialized, AgentReady) and again on the
   idempotent path; (d) once the run's containers are gone the watcher
   drains to zero, and the drain runs in the reference's order, teardown
   flushing the maps and removing Envoy; (a) while the drain waits out
   its two five-second joins, ``controlplane up``, ``status --format
   json`` (healthy, nothing unavailable), ``agents --format json``,
   ``down`` and ``status`` (exit 1) forked over their own daemon.  Each
   step's host ms.
22. nsd phase, its files and sockets under ``build/chip_smoke/nsd/``
   (never the default socket): (a) the probe's facts on one line (euid,
   ``CapEff``, ``cgroup2_root()``, ``nsd_capable()``, whether a task's
   ``children`` file reads), then the reference's exact container spawn
   argv once with ``true`` and an overlay mount of ``/`` inside a mount
   namespace of its own, each with its exit code and stderr; (b) over
   the kernel-free double (``testenv.install_nsd_double``, first on
   ``PATH``), ``NsdDriver`` spawns the port's daemon, which must be the
   process answering on the socket (``SO_PEERCRED``); tests/test_nsd.py's
   API checks (ping/info/version, a lifecycle's exit code and framed
   logs, attach and archive before start, exec and stop, a volume with
   label filters, 409/404, six lifecycles at once); then ``loop -p 8 -n
   3 --sentinel`` through the CLI in this process with ``runtime.driver:
   nsd``, the storm agent flagged, each scored tick one K3 and one K1;
   (c) the same on real namespaces, the daemon in a mount namespace of
   its own, where (a)'s trials pass, else why not.  No container,
   daemon or stand-in process left; each step's host ms.
23. analysis phase, its files under ``build/chip_smoke/analysis/``: (a)
   ``python -m clawker_tpu_torch.analysis --json`` and ``python -m
   clawker_tpu_torch analyze --json`` forked over this checkout, each
   exit 0 with the seven checkers, nothing new, nothing stale and the
   committed ``analysis-baseline-torch.json``'s entries grandfathered;
   ``--list-checkers`` lists the seven; the analyzer's modules load no
   torch, numpy, click or JAX; (b) ``run_corpus()`` into a capture DB,
   0 escaped, and the corpus over a monitor-mode surface grades at least
   one escape; (c) the reference's BASELINE config #5 shape: 8 loops x 2
   iterations on 4 fake workers with the live sentinel on the card and an
   egress burst while ``run_corpus()`` runs in a loop, all inside the
   port's ``testenv.lock_tracing()``: every pass (b)'s counts with 0
   escaped, every loop done at iteration 2, no invariant broken, no
   lock-order cycle, the burst agent flagged, each scored tick one K3
   and one K1.  Each step's host ms.
24. parity phase, its files under ``build/chip_smoke/parity/``: (a)
   ``python -m clawker_tpu_torch.parity --json`` forked as CI runs it,
   exit 0 with 22/22 scenarios, 35/35 techniques and 0 captures (where
   the host's bpf(2) probe passes, every kernel-regraded row passing),
   its ``firewall_parity_pass_rate`` and ``parity_suite_wall`` beside
   the reference's 10 s budget and the card, and what its modules load;
   (b) the canary: a port ``World`` with enforcement bypassed captures a
   TCP reach and a dug exfil name; (c) the red-team corpus (``jobs=1``)
   through one ``World`` whose ``FakeMaps`` a ``NetLogger`` drains into
   the red-team worker's stream beside the egress phase's benign fleet,
   a live sentinel on the card: the red-team agent first and flagged,
   its flag's ms after the last drain, each scored tick one K3 and one
   K1, 0 captures.
25. CLI phase: ``python -m clawker_tpu_torch monitor anomalies`` in a
   subprocess must exit 0 and report a CUDA device;
   ``python -m clawker_tpu_torch fleet anomaly`` on two workers' streams
   that hold a hot agent must exit 2 and flag it with kind ``egress``.

Every process the run starts carries ``CHIP_SMOKE_RUN`` in its
environment; one still running at the end of the pod phase or of the
run fails it (and is killed).  Any failure exits non-zero.  Without a GPU, or without the repository
beside it, the script fails before printing any result.  The last line
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
the line before it the per-kernel JSON record.  Imports nothing of JAX
or of the reference package.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import importlib
import json
import os
import re
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over HBM_BPS and its products over their type's rate
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
HIDDEN = 128

# Tolerances, kernel against plain version on the same card and inputs.
# Both sides round at the same points; they differ in summation order
# (fp32, ~1e-7 relative) and in tanh (a few ulp), which now and then tips
# a bf16 rounding of an activation or a weight gradient by one bf16 ulp.
SCORE_RTOL = 1e-3       # score: a tipped bf16(g) moves r by ~2^-9 |g w|
SCORE_ATOL = 1e-6
STEP1_PARAM_ATOL = 1e-5   # one step: a tipped bf16 gradient moves a
STEP1_LOSS_RTOL = 1e-5    # param by lr * 2^-8 |g| ~ 1e-6
FIT_PARAM_ATOL = 1e-4   # 120 steps: such tips accumulate, SGD does not
FIT_LOSS_RTOL = 1e-4    # amplify them (measured ~5e-6 CPU vs JAX)
# Every step's loss is also held against the plain loss of the kernel's
# own params, at FIT_LOSS_RTOL: the tensor cores' accumulation behaves
# like rounding toward zero, which now and then tips one bf16(g), and
# one tip moved a loss by 3.1e-5 at [100, 32] on an H100.  That check
# covers the loss output at every F; the one against the plain fit also
# covers the params' drift.  F < 16: the fit drives the loss to ~7% of
# its start (3.08 -> 0.22 at [130, 7]), so the same drift of the params
# (< 1e-5) moves the late losses by more of it: 3.0e-4 at [130, 7] on an
# H100, where two round-to-nearest fits (the plain one on the CPU and on
# the card, printed for each shape) drifted 3.7e-5.
NARROW_FIT_LOSS_RTOL = 1e-3
NARROW_F = 16
# One K2 step's slots, summed, against the plain fp32 sums of the same
# bf16 operands and unrounded fp32 cotangent (``reference.step_grads``):
# the larger normwise relative error of dW_enc and dW_dec.  It holds the
# backward's exact split of the cotangent (Split3), which the limits
# above barely see: a cotangent rounded to bf16 moves a param by about
# lr x 2^-8 |g| a step.  On an H100 the sound kernel read 2.5e-6 to
# 4.2e-5 over KERNEL_SHAPES; with Split3 cut to its hi term, 2.0e-3 at
# [100, 32], where every other check passed (only STEP1_PARAM_ATOL at
# [130, 7] failed, by 2x).
SLOT_SUM_RTOL = 3e-4

# (n, F): the main path pads rows to multiples of 128 -- the sentinel tick
# to [384, 40], the bench fleet to [640, 32], the hour of 64 agents to
# [4224, 32] -- beside round sizes, one ragged n that masks rows, fewer
# rows than one K2 tile (100), more K2 tiles than blocks (8192), and an
# odd F for the widths K2 pads F to that the main path does not take
# (7 -> 16, 61 -> 64; 32 and 40 -> 48 are the main path's)
KERNEL_SHAPES = [(100, 32), (130, 7), (200, 40), (256, 40), (260, 61),
                 (384, 40), (512, 32), (640, 32), (4096, 32), (4224, 32),
                 (8192, 32)]
# K3 keeps a block's x tiles in shared memory while they fit (up to 12
# tiles a block at F padded to 64: n <= 50688); one more row makes every
# block reload its tiles, the path this shape holds against K2
RELOAD_SHAPE = (50689, 61)
RELOAD_STEPS = 4
# F = 61 pads to 64, where K1, K2 and K3 all need more than 48 KB of
# shared memory: every device opts in to it on its own
OPT_IN_SHAPE = (260, 61)
TIMED_SHAPE = (4224, 32)
FIT_STEPS = 120
SPIN_CYCLES = 1_000_000   # ~0.5 ms: covers the host's enqueue in event_ms
# The chaos sentinel's tick (chaos.runner.SENTINEL_TRAIN_STEPS): its
# feeder writes 4 workers x 3 agents, one window each, padded to 128 rows
CHAOS_SHAPE = (128, 40)
CHAOS_STEPS = 20
# The live sentinel (sentinel_phase): its fit steps per tick, and the
# flag-latency scenario of the reference bench (bench.py:2376-2440)
SENTINEL_STEPS = 40
FLAG_REPS = 5
FLAG_DEADLINE_S = 10.0
# K5, the fit over rows split into shards: the shard counts of the
# per-step route's step held against its plain version at KERNEL_SHAPES,
# of the fit held against K3 on the two fleets, of the one-launch fit held
# against the per-step route (KERNEL_SHAPES, both fleets) and timed, and of
# its phase trace; RELOAD_SHAPE over RELOAD_SHARDS shards is too large for
# x to stay resident; the main path's sharded run uses MAIN_PATH_SHARDS
# shards (2x2)
SHARD_SOURCE = "anomaly_fit_shard"
SHARD_COUNTS = (2, 4)
MESH_SHARDS = (2, 4, 8)
TIMED_SHARDS = (1, 2, 4, 8)
TRACED_SHARDS = (4, 8)
RELOAD_SHARDS = 2
MAIN_PATH_SHARDS = 4
# K5's fit against K3's on the same inputs: the same function, but the
# slots group the rows otherwise where a shard's rows are not whole tiles
# (8 shards of 640 or 4224 rows), and the other order of the fp32 sums
# now and then tips a bf16 rounding of a weight gradient, as JAX's and
# the port's fits differ: the scores at tests/test_torch_runtime.py's
# FIT_RTOL / FIT_ATOL and the losses at its FIT_LOSS_RTOL, the limits that
# hold the port's fit against JAX's; the params at FIT_PARAM_ATOL
MESH_SCORE_RTOL = 5e-3
MESH_SCORE_ATOL = 1e-5
MESH_LOSS_RTOL = 1e-3
# K5b, the fit with the rows over `data` and the hidden dimension over
# `model` = 2 (the reference's layout at an even count): its step held
# against its plain version at every KERNEL_SHAPE, and its fit at
# TIMED_SHAPE held and timed, over the virtual meshes of MODEL_MESHES
# shards of one card (2x2, the main path's sharded hour; 4x2,
# dryrun_multichip(8)'s).  Its forward's partial outputs y against the
# plain ones normwise (the largest error over the largest |y|) at
# SCORE_RTOL: the products are exact, and a tipped bf16 activation moves
# y by ~2^-9 |g w|, as it moves K1's reconstruction.  K5 keeps its checks
# and times over data-only meshes of the same counts (``k5_mesh``), and
# runs on the main path over ODD_MESH_SHARDS shards (3x1).
MODEL_SOURCE = "anomaly_fit_model"
MODEL_MESHES = (4, 8)
# the cards route's fit at every KERNEL_SHAPES entry, held bit for bit;
# over the fleet meshes of several cards also at a batch whose data blocks
# are one row tile each at 2x2, so that one card of each block has no item
CARDS_CHECK_STEPS = 3
CARDS_TINY_SHAPE = (60, 32)
ODD_MESH_SHARDS = 3


def synth_egress_records(agents: int = 8, windows: int = 64,
                         per_window: int = 40) -> list[dict]:
    """Deterministic synthetic netlogger stream: `agents` containers with
    plausible verdict/port mixes across `windows` minutes (a copy of
    bench.py's generator)."""
    verdicts = ["ALLOW", "ALLOW", "ALLOW", "REDIRECT", "DENY"]
    reasons = {"ALLOW": "ROUTE", "REDIRECT": "ROUTE", "DENY": "NO_DNS_ENTRY"}
    base = 1_700_000_000
    out = []
    for a in range(agents):
        for w in range(windows):
            for i in range(per_window):
                ts = base + w * 60 + (i * 7) % 60
                v = verdicts[(a + w + i) % len(verdicts)]
                out.append({
                    "@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                time.gmtime(ts)),
                    "service": "ebpf-egress",
                    "container": f"clawker.loop-{a}",
                    "dst_ip": f"198.51.100.{(a * 13 + i) % 250}",
                    "dst_port": [443, 443, 80, 53, 8443][(w + i) % 5],
                    "proto": 6 if i % 5 else 17,
                    "verdict": v,
                    "reason": reasons[v],
                    "zone": f"z{(a + i) % 6}.example.com",
                })
    return out


def exfil_burst(agent: str, window: int, n: int = 55,
                base: int = 1_700_000_000) -> list[dict]:
    """One agent suddenly sprays denies at many hosts on odd ports."""
    start = base + window * 60
    return [{"@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime(start + i % 59)),
             "service": "ebpf-egress", "container": agent,
             "dst_ip": f"203.0.113.{i}", "dst_port": 4444 + i, "proto": 6,
             "verdict": "DENY", "reason": "NO_DNS_ENTRY", "zone": ""}
            for i in range(n)]


def benign_window(agent: str, window: int, n: int,
                  base: int = 1_700_000_000) -> list[dict]:
    """``n`` ordinary records of one agent in one more minute."""
    start = base + window * 60
    return [{"@timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime(start + i % 59)),
             "service": "ebpf-egress", "container": agent,
             "dst_ip": f"198.51.100.{i % 250}", "dst_port": 443, "proto": 6,
             "verdict": "ALLOW", "reason": "ROUTE", "zone": "z0.example.com"}
            for i in range(n)]


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing


def cuda_ms(fn, *, batches: int = 15, per_batch: int = 20) -> float:
    """Median device time per call of ``fn``: ``per_batch`` calls are
    captured in one CUDA graph (after a warm-up), and CUDA events time
    each replay, so the card runs the calls back to back and the host's
    dispatch of them is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    del graph
    return statistics.median(times)


def event_ms(fn, *, reps: int = 15) -> float:
    """Median device time of one call of ``fn`` by CUDA events, for calls
    too long or too many-launched to capture in a graph (K3's fit, the
    plain fit, the noise draw).  A spin kernel keeps the card busy while
    the host enqueues the events and the call, so the host's dispatch of a
    one-launch call is not in its time; a call whose host work outlasts
    the spin (the plain fit's thousands of launches) is timed with it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, *, reps: int = 200) -> float:
    """Median wall time per call of ``fn`` as the host sees it, each call
    synchronized: dispatch, launch and device time together."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def score_bound(n: int, f: int) -> tuple[float, str]:
    """Least time of K1: x in, weights in, one score per row out; the two
    products (bf16 operands) at the bf16 tensor rate."""
    nbytes = 4 * (n * f + 2 * f * HIDDEN + HIDDEN + f + n)
    ops = 4 * n * f * HIDDEN
    return _bound(nbytes / HBM_BPS, ops / BF16_FLOPS)


def step_flops(n: int, f: int) -> int:
    """bf16 tensor-core flops of one fit step: the two forward products
    (4 nFH) and the three backward ones.  Each backward product multiplies
    the fp32 cotangent unrounded, which the tensor cores take as three
    bf16 terms whose sum is exact: 18 nFH (at the fp32 rate, 6 nFH would
    take 4.9x as long)."""
    return (4 + 18) * n * f * HIDDEN


def fit_step_bound(n: int, f: int) -> tuple[float, str]:
    """Least time of K2: x and noise in, params in and out, the loss out;
    ``step_flops`` at the bf16 rate."""
    params = 2 * f * HIDDEN + HIDDEN + f
    nbytes = 4 * (2 * n * f + 2 * params + 1)
    return _bound(nbytes / HBM_BPS, step_flops(n, f) / BF16_FLOPS)


def fit_bound(n: int, f: int, steps: int,
              extra_bytes: int = 0) -> tuple[float, str]:
    """Least time of K3: x in once, each step's noise in once, the params
    in and out once, one loss per step out (and ``extra_bytes``); ``steps``
    x ``step_flops`` at the bf16 rate."""
    params = 2 * f * HIDDEN + HIDDEN + f
    nbytes = 4 * (n * f + steps * n * f + 2 * params + steps) + extra_bytes
    return _bound(nbytes / HBM_BPS, steps * step_flops(n, f) / BF16_FLOPS)


def noise_bound(n: int, f: int, steps: int) -> tuple[float, str]:
    """Least time of the noise draw (K4): steps x n x F floats written."""
    return _bound(4 * steps * n * f / HBM_BPS, 0.0)


def _bound(t_bytes: float, t_ops: float) -> tuple[float, str]:
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


# ------------------------------------------------------------ kernel phase


def _inputs(n: int, f: int, steps: int, device, seed: int):
    import torch

    from clawker_tpu_torch.analytics import anomaly

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((n, f), generator=gen).to(device)
    noises = torch.randn((steps, n, f), generator=gen).to(device)
    params = anomaly.AnomalyParams(*(
        p.to(device) for p in anomaly.init_params(gen, feat=f)))
    return params, x, noises


def _max_abs(a, b) -> float:
    return max(float((p - q).abs().max()) for p, q in zip(a, b))


def _close(got, want, *, rtol: float, atol: float = 0.0) -> tuple[bool, float]:
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def _rel(got, want) -> float:
    return float(((got - want).abs() / want.abs()).max())


def _slot_totals(slots, count: int, f: int):
    """The sum over the first ``count`` slots of a slot buffer, in fp64,
    unpacked: ((dW_enc [F, H], db_enc [H], dW_dec [H, F], db_dec [F]),
    the squared-error sum)."""
    from clawker_tpu_torch.kernels import anomaly as K

    fh = f * HIDDEN
    t = slots[:count * K.slot_floats(f)].view(
        count, K.slot_floats(f)).double().sum(0)
    return ((t[:fh].view(f, HIDDEN), t[fh:fh + HIDDEN],
             t[fh + HIDDEN:2 * fh + HIDDEN].view(f, HIDDEN).T,
             t[2 * fh + HIDDEN:2 * fh + HIDDEN + f]), t[-1])


def _slot_sum_err(params, x, noise, scratch, count: int | None = None
                  ) -> float:
    """A step from ``params`` left its slots at the start of ``scratch``
    (K2's fit_slots(n), or ``count`` of them): their sums of dW_enc and
    dW_dec (unrounded) against ``reference.step_grads``'s over all of x,
    as the larger normwise relative error."""
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = x.shape
    (got_enc, _, got_dec, _), _ = _slot_totals(
        scratch, K.fit_slots(n) if count is None else count, f)
    (dw_enc, _, dw_dec, _), _ = R.step_grads(*params, x, noise, 0.25)
    return max(float((g - w.double()).norm() / w.double().norm())
               for g, w in ((got_enc, dw_enc), (got_dec, dw_dec)))


def score_checks(params, x) -> tuple[float, float]:
    """K1 on ``params``: against the plain score; twice the same bits; its
    mean score against K2's noise-free step-0 loss (the two reconstruct
    alike).  -> (max abs error, the mean's relative error)."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = x.shape
    scores = K.score(params, x)
    ok, err = _close(scores, R.score(*params, x), rtol=SCORE_RTOL,
                     atol=SCORE_ATOL)
    check(ok, f"K1 score [{n},{f}] off by {err:.3g}")
    check(torch.equal(scores, K.score(params, x)),
          f"K1 [{n},{f}]: two scores from the same inputs differ")
    loss0 = torch.empty(1, device=x.device)
    K.fit_step_(tuple(p.clone() for p in params), x, None, lr=1e-2,
                sigma=0.0, loss_out=loss0)
    ok, lerr = _close(scores.double().mean(), loss0.double()[0],
                      rtol=STEP1_LOSS_RTOL)
    check(ok, f"K1 [{n},{f}]: mean score off K2's noise-free loss by "
              f"{lerr:.3g}")
    return err, lerr / float(loss0[0])


def kernel_phase(device) -> dict:
    import torch

    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    errs = {K.SCORE: 0.0, K.FIT_STEP: 0.0, K.FIT: 0.0}
    slot_max = 0.0
    score_loss_max = 0.0
    timings = {}
    for n, f in KERNEL_SHAPES:
        params, x, noises = _inputs(n, f, FIT_STEPS, device, seed=n + f)

        err, rel = score_checks(params, x)
        errs[K.SCORE] = max(errs[K.SCORE], err)
        score_loss_max = max(score_loss_max, rel)

        # K2: one step, then the whole fit, against the plain steps
        scratch = torch.empty(K.scratch_floats(n, f), device=device)
        kp = tuple(p.clone() for p in params)
        rp = tuple(p.clone() for p in params)
        k_loss = torch.empty(FIT_STEPS, device=device)
        r_loss = torch.empty(FIT_STEPS, device=device)
        own_loss = torch.empty(FIT_STEPS, device=device)
        for s in range(FIT_STEPS):
            _, own_loss[s] = R.fit_step(*kp, x, noises[s], 1e-2, 0.25)
            K.fit_step_(kp, x, noises[s], lr=1e-2, sigma=0.25,
                        loss_out=k_loss, step=s, scratch=scratch)
            rp, r_loss[s] = R.fit_step(*rp, x, noises[s], 1e-2, 0.25)
            if s == 0:
                torch.cuda.synchronize()
                slot_err = _slot_sum_err(params, x, noises[0], scratch)
                check(slot_err <= SLOT_SUM_RTOL,
                      f"K2 [{n},{f}] slot sums of step 1 off the plain fp32 "
                      f"sums by {slot_err:.3g} (normwise)")
                slot_max = max(slot_max, slot_err)
                err = _max_abs(kp, rp)
                check(err <= STEP1_PARAM_ATOL,
                      f"K2 [{n},{f}] params after 1 step off by {err:.3g}")
                ok, lerr = _close(k_loss[:1], r_loss[:1],
                                  rtol=STEP1_LOSS_RTOL)
                check(ok, f"K2 [{n},{f}] loss of step 1 off by {lerr:.3g}")
                errs[K.FIT_STEP] = max(errs[K.FIT_STEP], err)
        torch.cuda.synchronize()
        err = _max_abs(kp, rp)
        check(err <= FIT_PARAM_ATOL,
              f"K2 [{n},{f}] params after {FIT_STEPS} steps off by {err:.3g}")
        ok, lerr = _close(k_loss, own_loss, rtol=FIT_LOSS_RTOL)
        check(ok, f"K2 [{n},{f}] a step's loss off the plain loss of the "
                  f"kernel's own params by {lerr:.3g}")
        rtol = FIT_LOSS_RTOL if f >= NARROW_F else NARROW_FIT_LOSS_RTOL
        ok, lerr = _close(k_loss, r_loss, rtol=rtol)
        check(ok, f"K2 [{n},{f}] per-step losses off by {lerr:.3g}")
        errs[K.FIT_STEP] = max(errs[K.FIT_STEP], err)
        # the yardstick: the plain fit on the CPU against the one on the card
        cp = tuple(p.cpu() for p in params)
        c_loss = torch.empty(FIT_STEPS)
        for s in range(FIT_STEPS):
            cp, c_loss[s] = R.fit_step(*cp, x.cpu(), noises[s].cpu(), 1e-2,
                                       0.25)
        print(f"K2 [{n},{f}] after {FIT_STEPS} steps, off the plain fit on "
              f"the card: params {err:.3g}, losses {_rel(k_loss, r_loss):.3g} "
              f"relative (rtol {rtol}); the plain losses of the kernel's "
              f"own params {_rel(k_loss, own_loss):.3g} relative at most, "
              f"at step {int(((k_loss - own_loss).abs() / own_loss).argmax())}"
              f"; the plain fit on the CPU: "
              f"params {_max_abs(cp, [p.cpu() for p in rp]):.3g}, losses "
              f"{_rel(c_loss, r_loss.cpu()):.3g}; loss {float(r_loss[0]):.4g}"
              f" -> {float(r_loss[-1]):.4g}; step 1's slot sums off the "
              f"plain fp32 sums by {slot_err:.3g} (normwise)")

        # K2 is deterministic: the same fit again, bit for bit
        kq = tuple(p.clone() for p in params)
        q_loss = torch.empty(FIT_STEPS, device=device)
        for s in range(FIT_STEPS):
            K.fit_step_(kq, x, noises[s], lr=1e-2, sigma=0.25,
                        loss_out=q_loss, step=s, scratch=scratch)
        torch.cuda.synchronize()
        check(all(torch.equal(p, q) for p, q in zip(kp, kq))
              and torch.equal(k_loss, q_loss),
              f"K2 [{n},{f}]: two fits from the same inputs differ")

        # K3: the whole fit in one launch, bit for bit the loop of K2
        # launches, within K2's tolerances of the plain fit, and twice the
        # same
        fits = []
        for _ in range(2):
            fp = tuple(p.clone() for p in params)
            f_loss = torch.empty(FIT_STEPS, device=device)
            K.fit_(fp, x, noises, lr=1e-2, sigma=0.25, losses_out=f_loss,
                   scratch=scratch)
            torch.cuda.synchronize()
            fits.append((fp, f_loss))
        fp, f_loss = fits[0]
        off = (f_loss != k_loss).nonzero()
        check(all(torch.equal(p, q) for p, q in zip(fp, kp)) and not len(off),
              f"K3 [{n},{f}]: not bit-identical to {FIT_STEPS} K2 launches:"
              f" params {_max_abs(fp, kp):.3g} apart, first loss apart at "
              f"step {int(off[0]) if len(off) else None}")
        err = _max_abs(fp, rp)
        check(err <= FIT_PARAM_ATOL,
              f"K3 [{n},{f}] params after {FIT_STEPS} steps off by {err:.3g}")
        ok, lerr = _close(f_loss, r_loss, rtol=rtol)
        check(ok, f"K3 [{n},{f}] per-step losses off by {lerr:.3g}")
        errs[K.FIT] = max(errs[K.FIT], err)
        check(all(torch.equal(p, q) for p, q in zip(fp, fits[1][0]))
              and torch.equal(f_loss, fits[1][1]),
              f"K3 [{n},{f}]: two fits from the same inputs differ")
        # K3's staged weights (its prologue's layout, phase B's values) are
        # bit for bit their plain version built from the fitted params
        check(torch.equal(scratch[:K.staged_floats(f)].view(torch.int32),
                          R.staged(*fp).view(torch.int32)),
              f"K3 [{n},{f}]: the staged weights in its scratch are not "
              f"reference.staged of its params")

        # K1 again on the fitted params: the scores the lane reports
        ok, err = _close(K.score(kp, x), R.score(*kp, x),
                         rtol=SCORE_RTOL, atol=SCORE_ATOL)
        check(ok, f"K1 score [{n},{f}] on fitted params off by {err:.3g}")
        errs[K.SCORE] = max(errs[K.SCORE], err)

        # times: kernel and plain version on the same inputs
        tp = tuple(p.clone() for p in params)
        loss1 = torch.empty(1, device=device)
        calls = {
            K.SCORE: (lambda: K.score(params, x),
                      lambda: R.score(*params, x), score_bound(n, f)),
            K.FIT_STEP: (lambda: K.fit_step_(tp, x, noises[0], lr=1e-2,
                                             sigma=0.25, loss_out=loss1,
                                             scratch=scratch),
                         lambda: R.fit_step(*params, x, noises[0], 1e-2,
                                            0.25),
                         fit_step_bound(n, f)),
        }
        row = {}
        for name, (kernel_call, plain_call, (bound, by)) in calls.items():
            ms, plain = cuda_ms(kernel_call), cuda_ms(plain_call)
            row[name] = (ms, plain, bound, by)
            floor = ""
            if name == K.SCORE:   # an empty launch in the same harness
                floor = (f", launch floor "
                         f"{cuda_ms(lambda: torch.cuda._sleep(0)) * 1e3:.2f}"
                         f" us")
            print(f"kernel {name} [{n},{f}]: device {ms * 1e3:.2f} us, "
                  f"host per synchronized call "
                  f"{host_us(kernel_call):.2f} us (plain device "
                  f"{plain * 1e3:.2f} us, bound {bound * 1e3:.3f} us by {by}"
                  f"{floor})")
        # K3: one launch per fit, timed alone by events
        tq = tuple(p.clone() for p in params)
        losses = torch.empty(FIT_STEPS, device=device)

        def fit_call():
            K.fit_(tq, x, noises, lr=1e-2, sigma=0.25, losses_out=losses,
                   scratch=scratch)

        ms = event_ms(fit_call)
        plain = event_ms(lambda: R.fit(*params, x, noises, 1e-2, 0.25),
                         reps=5)
        bound, by = fit_bound(n, f, FIT_STEPS)
        row[K.FIT] = (ms, plain, bound, by)
        k2 = row[K.FIT_STEP][0]
        print(f"kernel {K.FIT} [{n},{f}]: device {ms:.4f} ms per "
              f"{FIT_STEPS}-step fit, {ms / FIT_STEPS * 1e3:.2f} us per step "
              f"({FIT_STEPS} x K2 {FIT_STEPS * k2:.4f} ms), host per "
              f"synchronized call {host_us(fit_call, reps=20):.2f} us (plain "
              f"fit {plain:.3f} ms, bound {bound:.4f} ms by {by})")
        timings[(n, f)] = row
    reload_check(device)
    chaos = chaos_shape_check(device)
    errs[K.FIT] = max(errs[K.FIT], chaos["fit_err"])
    errs[K.SCORE] = max(errs[K.SCORE], chaos["score_err"])
    print(f"kernel tolerances: score rtol {SCORE_RTOL} atol {SCORE_ATOL}; "
          f"fit step 1: params atol {STEP1_PARAM_ATOL}, loss rtol "
          f"{STEP1_LOSS_RTOL}; after {FIT_STEPS} steps: params atol "
          f"{FIT_PARAM_ATOL}, losses rtol {FIT_LOSS_RTOL} (F < {NARROW_F}: "
          f"{NARROW_FIT_LOSS_RTOL}), each step's loss rtol {FIT_LOSS_RTOL}"
          f" against the plain loss of the kernel's own params; step 1's "
          f"slot sums normwise rtol {SLOT_SUM_RTOL} (largest "
          f"{slot_max:.3g}); K1's mean score against K2's noise-free loss "
          f"rtol {STEP1_LOSS_RTOL} (largest {score_loss_max:.3g}); two K1 "
          f"scores and two K2 fits bit-identical at every shape; K3 at K2's "
          f"{FIT_STEPS}-step tolerances, bit-identical to the K2 loop and "
          f"to itself")
    print(f"kernel max abs err: {json.dumps(errs)}")
    return {"errs": errs, "timings": timings}


def reload_check(device) -> None:
    """K3 at RELOAD_SHAPE, where a block's x tiles do not fit in shared
    memory and it reloads them at each tile: bit for bit the loop of K2
    launches and itself, within K2's tolerances of the plain fit."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = RELOAD_SHAPE
    params, x, noises = _inputs(n, f, RELOAD_STEPS, device, seed=n + f)
    scratch = torch.empty(K.scratch_floats(n, f), device=device)
    kp = tuple(p.clone() for p in params)
    k_loss = torch.empty(RELOAD_STEPS, device=device)
    for s in range(RELOAD_STEPS):
        K.fit_step_(kp, x, noises[s], lr=1e-2, sigma=0.25, loss_out=k_loss,
                    step=s, scratch=scratch)
    rp, r_loss = R.fit(*params, x, noises, 1e-2, 0.25)
    fits = []
    for _ in range(2):
        fp = tuple(p.clone() for p in params)
        f_loss = torch.empty(RELOAD_STEPS, device=device)
        K.fit_(fp, x, noises, lr=1e-2, sigma=0.25, losses_out=f_loss,
               scratch=scratch)
        fits.append((fp, f_loss))
    torch.cuda.synchronize()
    (fp, f_loss), (fq, q_loss) = fits
    check(all(torch.equal(p, q) for p, q in zip(fp, kp))
          and torch.equal(f_loss, k_loss),
          f"K3 [{n},{f}] (x reloaded): not bit-identical to {RELOAD_STEPS} "
          f"K2 launches: params {_max_abs(fp, kp):.3g} apart")
    check(all(torch.equal(p, q) for p, q in zip(fp, fq))
          and torch.equal(f_loss, q_loss),
          f"K3 [{n},{f}] (x reloaded): two fits from the same inputs differ")
    err = _max_abs(fp, rp)
    check(err <= FIT_PARAM_ATOL,
          f"K3 [{n},{f}] (x reloaded) params off by {err:.3g}")
    ok, lerr = _close(f_loss, r_loss, rtol=FIT_LOSS_RTOL)
    check(ok, f"K3 [{n},{f}] (x reloaded) losses off by {lerr:.3g}")
    check(torch.equal(scratch[:K.staged_floats(f)].view(torch.int32),
                      R.staged(*fp).view(torch.int32)),
          f"K3 [{n},{f}] (x reloaded): staged weights off their plain "
          f"version")
    print(f"K3 [{n},{f}], x tiles reloaded, {RELOAD_STEPS} steps: "
          f"bit-identical to the K2 loop and to itself; off the plain fit: "
          f"params {err:.3g}, losses {_rel(f_loss, r_loss):.3g} relative")


def chaos_shape_check(device) -> dict:
    """K3 at the chaos sentinel's tick shape (CHAOS_SHAPE x CHAOS_STEPS,
    ``chaos.runner.SENTINEL_TRAIN_STEPS``): bit for bit the loop of K2
    launches and itself, within K2's tolerances of the plain fit; then K1
    on the fitted params against the plain score.  Prints both kernels'
    device times beside their plain versions' and their bounds.  -> the
    largest errors."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    (n, f), steps = CHAOS_SHAPE, CHAOS_STEPS
    params, x, noises = _inputs(n, f, steps, device, seed=n + f + steps)
    scratch = torch.empty(K.scratch_floats(n, f), device=device)
    kp = tuple(p.clone() for p in params)
    k_loss = torch.empty(steps, device=device)
    for s in range(steps):
        K.fit_step_(kp, x, noises[s], lr=1e-2, sigma=0.25, loss_out=k_loss,
                    step=s, scratch=scratch)
    rp, r_loss = R.fit(*params, x, noises, 1e-2, 0.25)
    fits = []
    for _ in range(2):
        fp = tuple(p.clone() for p in params)
        f_loss = torch.empty(steps, device=device)
        K.fit_(fp, x, noises, lr=1e-2, sigma=0.25, losses_out=f_loss,
               scratch=scratch)
        fits.append((fp, f_loss))
    torch.cuda.synchronize()
    (fp, f_loss), (fq, q_loss) = fits
    check(all(torch.equal(p, q) for p, q in zip(fp, kp))
          and torch.equal(f_loss, k_loss),
          f"K3 [{n},{f}] x{steps}: not bit-identical to {steps} K2 "
          f"launches: params {_max_abs(fp, kp):.3g} apart")
    check(all(torch.equal(p, q) for p, q in zip(fp, fq))
          and torch.equal(f_loss, q_loss),
          f"K3 [{n},{f}] x{steps}: two fits from the same inputs differ")
    fit_err = _max_abs(fp, rp)
    check(fit_err <= FIT_PARAM_ATOL,
          f"K3 [{n},{f}] x{steps} params off by {fit_err:.3g}")
    ok, lerr = _close(f_loss, r_loss, rtol=FIT_LOSS_RTOL)
    check(ok, f"K3 [{n},{f}] x{steps} losses off by {lerr:.3g}")
    ok, score_err = _close(K.score(fp, x), R.score(*rp, x),
                           rtol=SCORE_RTOL, atol=SCORE_ATOL)
    check(ok, f"K1 [{n},{f}] after the chaos fit off the plain score of the "
              f"plain fit by {score_err:.3g}")
    tq = tuple(p.clone() for p in params)
    losses = torch.empty(steps, device=device)
    fit_ms = event_ms(lambda: K.fit_(tq, x, noises, lr=1e-2, sigma=0.25,
                                     losses_out=losses, scratch=scratch))
    fit_plain = event_ms(lambda: R.fit(*params, x, noises, 1e-2, 0.25),
                         reps=5)
    fit_b, fit_by = fit_bound(n, f, steps)
    score_ms = cuda_ms(lambda: K.score(fp, x))
    score_plain = cuda_ms(lambda: R.score(*fp, x))
    score_b, score_by = score_bound(n, f)
    print(f"K3 [{n},{f}] x{steps} (the chaos sentinel's tick): bit-identical "
          f"to the K2 loop and to itself; off the plain fit: params "
          f"{fit_err:.3g}, losses {_rel(f_loss, r_loss):.3g} relative; device "
          f"{fit_ms!r} ms per fit (plain fit {fit_plain!r} ms, bound "
          f"{fit_b!r} ms by {fit_by}); K1 after it {score_err:.3g} off the "
          f"plain score (rtol {SCORE_RTOL} atol {SCORE_ATOL}), device "
          f"{score_ms * 1e3!r} us (plain {score_plain * 1e3!r} us, bound "
          f"{score_b * 1e3!r} us by {score_by})")
    return {"fit_err": fit_err, "score_err": score_err}


def every_device_check() -> None:
    """K1, K2 and K3 at OPT_IN_SHAPE on every visible device, each against
    its plain version (K3 bit for bit against K2's loop): all three need
    more than 48 KB of shared memory there, which each device must be
    opted in to."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = OPT_IN_SHAPE
    for d in range(torch.cuda.device_count()):
        device = torch.device("cuda", d)
        params, x, noises = _inputs(n, f, 2, device, seed=n + f)
        ok, err = _close(K.score(params, x), R.score(*params, x),
                         rtol=SCORE_RTOL, atol=SCORE_ATOL)
        check(ok, f"K1 [{n},{f}] on {device}: off by {err:.3g}")
        kp = tuple(p.clone() for p in params)
        k_loss = torch.empty(2, device=device)
        for s in range(2):
            K.fit_step_(kp, x, noises[s], lr=1e-2, sigma=0.25,
                        loss_out=k_loss, step=s)
        rp, _ = R.fit(*params, x, noises, 1e-2, 0.25)
        fp = tuple(p.clone() for p in params)
        f_loss = torch.empty(2, device=device)
        K.fit_(fp, x, noises, lr=1e-2, sigma=0.25, losses_out=f_loss)
        torch.cuda.synchronize(device)
        err = _max_abs(kp, rp)
        check(err <= STEP1_PARAM_ATOL,
              f"K2 [{n},{f}] on {device}: params off by {err:.3g}")
        check(all(torch.equal(p, q) for p, q in zip(fp, kp))
              and torch.equal(f_loss, k_loss),
              f"K3 [{n},{f}] on {device}: not bit-identical to K2's loop")
        print(f"device {d} ({torch.cuda.get_device_name(d)}): K1, K2 and "
              f"K3 at [{n},{f}], each opted in above 48 KB, agree with "
              f"their plain versions")
    shard_cards_check()


def shard_cards_check() -> None:
    """When there are several cards: K5 over a data-only mesh of every
    visible card, every card's params the same bits and those of the same
    shards on one card; and, when the fleet mesh splits the hidden
    dimension (an even count), K5b over the fleet meshes of 2, 4 and 8 of
    the cards (as many as are visible) and of all of them, by the route
    ``model_route`` gives, every card's half the bits of the same shards
    on one card and of the per-step route over the same cards, with each
    card's phase trace on the cards route."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K

    cards = torch.cuda.device_count()
    if cards < 2:
        print("K5 and K5b over several cards: one card visible, not run")
        return
    n, f = TIMED_SHAPE
    params, x, noises = _inputs(n, f, 8, "cuda:0", seed=n + f)
    fleet = M.fleet_mesh()
    mesh = M.Mesh(data=cards, model=1, devices=fleet.devices)
    replicas = M.shard_params(tuple(p.clone() for p in params), mesh)
    losses = torch.empty(len(noises), device=x.device)
    K.fit_shard_(replicas, M.shard_rows(x, mesh), M.shard_noise(noises, mesh),
                 lr=1e-2, sigma=0.25, losses_out=losses)
    for dev in mesh.distinct:
        torch.cuda.synchronize(dev)
    home = [p.cpu() for p in replicas[0]]
    check(all(torch.equal(p.cpu(), q) for r in replicas[1:]
              for p, q in zip(r, home)),
          f"K5 over {cards} cards: the cards' params differ")
    one_card = _shard_fit(params, x, noises, k5_mesh(cards, "cuda:0"))
    check(all(torch.equal(p.cpu(), q) for p, q in zip(one_card[0], home))
          and torch.equal(one_card[1], losses),
          f"K5 over {cards} cards: not the bits of {cards} shards of one "
          f"card")
    print(f"K5 [{n},{f}] x{len(noises)} over the {mesh.desc} mesh of "
          f"{cards} cards: every card's params the same bits, and those of "
          f"{cards} shards of cuda:0")
    if fleet.model != K.MODEL:
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def every_card(shape, mesh, steps, stamps=None) -> str:
        """K5b over ``mesh`` by its route, every card's half held bit for
        bit against the same shards of cuda:0 and the per-step route over
        the same cards -> the route."""
        k, route = len(mesh.devices), K.model_route(mesh.devices)
        sp, sx, sn = _inputs(*shape, steps, "cuda:0", seed=sum(shape))
        halves = M.shard_params(sp, mesh)
        got = torch.empty(steps, device=sx.device)
        K.fit_model_(halves, M.shard_rows(sx, mesh), M.shard_noise(sn, mesh),
                     lr=1e-2, sigma=0.25, losses_out=got, stamps=stamps)
        for dev in mesh.distinct:
            torch.cuda.synchronize(dev)
        for name, (h_want, l_want) in (
                ("the same shards of cuda:0",
                 _model_fit(sp, sx, sn, M.virtual_mesh(k, "cuda:0"))),
                ("the per-step route over the same cards",
                 _model_fit(sp, sx, sn, mesh, route=K.ROUTE_STEPS))):
            check(all(torch.equal(p.cpu(), q.cpu())
                      for s, h in enumerate(halves)
                      for p, q in zip(h, h_want[s % K.MODEL]))
                  and torch.equal(l_want.cpu(), got.cpu()),
                  f"K5b {list(shape)} x{steps} over the {mesh.desc} fleet "
                  f"mesh of {k} cards ({route} route): not the bits of "
                  f"{name} on every card")
        return route

    for k in sorted({c for c in (2, 4, 8) if c < cards} | {cards}):
        mesh = M.fleet_mesh(k)
        stamps = ([torch.zeros((len(noises), K.CARDS_STAMPS, sms),
                               dtype=torch.int64, device=dev)
                   for dev in mesh.distinct]
                  if K.model_route(mesh.devices) == K.ROUTE_CARDS else None)
        route = every_card((n, f), mesh, len(noises), stamps)
        for shape in KERNEL_SHAPES + [CARDS_TINY_SHAPE]:
            every_card(shape, mesh, CARDS_CHECK_STEPS)
        print(f"K5b [{n},{f}] x{len(noises)}, and at {len(KERNEL_SHAPES)} "
              f"KERNEL_SHAPES and {list(CARDS_TINY_SHAPE)} x"
              f"{CARDS_CHECK_STEPS}, over the {mesh.desc} fleet mesh of {k} "
              f"cards by the {route} route: every card's half the bits of "
              f"the same shards of cuda:0 and of the per-step route over the "
              f"same cards")
        for c, t in enumerate(stamps or ()):
            items = sum(map(len, K.cards_fit_plan(
                [len(b) for b in M.shard_rows(x, mesh)[::K.MODEL]],
                [mesh.distinct.index(d) for d in mesh.devices], sms,
                f).items[c]))
            print(f"K5b over the {mesh.desc} fleet mesh, card {c} "
                  f"({items} items) per step, " + _cards_trace(
                      t, min(items, sms)))
    if cards >= 4:
        _card_sets_at_once((n, f))


def _card_sets_at_once(shape, rounds: int = 24) -> None:
    """Two threads fit by K5b's cards route at once, each ``rounds``
    times, over card sets that share cards in opposite orders: (cuda:1,
    cuda:0) and the fleet mesh of cuda:0-3.  Every fit must end (a
    cross-card barrier past its deadline traps and raises) with the bits
    of the same fit run alone."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K

    meshes = [M.Mesh(data=1, model=K.MODEL, devices=(
        torch.device("cuda:1"), torch.device("cuda:0"))), M.fleet_mesh(4)]
    if any(K.model_route(m.devices) != K.ROUTE_CARDS for m in meshes):
        print("K5b's cards route from two threads at once: no peer access "
              "between the cards, not run")
        return
    steps = CARDS_CHECK_STEPS
    sp, sx, sn = _inputs(*shape, steps, "cuda:0", seed=sum(shape))

    def fit(mesh):
        halves = M.shard_params(sp, mesh)
        xs, ns = M.shard_rows(sx, mesh), M.shard_noise(sn, mesh)
        losses = torch.empty(steps, device=xs[0].device)
        K.fit_model_(halves, xs, ns, lr=1e-2, sigma=0.25, losses_out=losses)
        return halves, losses

    def synced(runs):
        for dev in range(4):
            torch.cuda.synchronize(dev)
        return [([[p.cpu() for p in h] for h in halves], losses.cpu())
                for halves, losses in runs]

    alone = synced([fit(mesh) for mesh in meshes])
    start = threading.Barrier(len(meshes))
    runs = [[] for _ in meshes]
    errors = []

    def worker(i):
        try:
            start.wait()
            for _ in range(rounds):
                runs[i].append(fit(meshes[i]))
        except Exception as e:      # raised again below, on the main thread
            errors.append(f"{meshes[i].devices}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(meshes))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = [synced(r) for r in runs]
    wall = time.perf_counter() - t0
    check(not errors, f"K5b's cards route from two threads: {errors}")
    def same(run, want) -> bool:
        return torch.equal(run[1], want[1]) and all(
            torch.equal(p, q) for h, hw in zip(run[0], want[0])
            for p, q in zip(h, hw))

    for mesh, want, mine in zip(meshes, alone, got):
        check(len(mine) == rounds and all(same(r, want) for r in mine),
              f"K5b's cards route from two threads over "
              f"{[str(d) for d in mesh.devices]}: not the bits of the same "
              f"fit alone")
    print(f"K5b {list(shape)} x{steps} by the cards route from two threads "
          f"at once, {rounds} fits each, over (cuda:1, cuda:0) and the "
          f"2x2 fleet mesh of cuda:0-3: every fit the bits of the same fit "
          f"alone, {wall:.3f} s")


def ptxas_report(name: str) -> None:
    """Print ptxas's register and spill lines for ``name``'s kernels; any
    spill fails."""
    from clawker_tpu_torch.kernels import build

    log = build.build_log(name)
    check(bool(log), f"no nvcc log for {name}: it was not built here")
    for line in log.splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print(f"ptxas {name}: {line.strip()}")
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", log)]
    check(bool(spills) and not any(spills),
          f"{name}: ptxas reports spills {spills}")


# ---------------------------------------------------------------- K5 phase


def plain_reduce(params, slots, count: int, n_total: int, f: int,
                 lr: float):
    """The plain version of K5's launch B: ``count`` slots summed, the
    update as ``reference.fit_step`` applies it.  -> (params, loss)."""
    from clawker_tpu_torch.kernels import reference as R

    grads, sq = _slot_totals(slots, count, f)
    new = R.sgd_update(params, tuple(g.float() for g in grads), lr)
    return new, sq.float() / (n_total * f)


def shard_bound(rows, f: int) -> tuple[tuple[float, str], tuple[float, str]]:
    """Least times of the per-step route's two launches: launch A of a
    shard of rows[0] rows (x and noise in, the params in, its slots out;
    the step's flops over its rows), and launch B over every shard's
    slots (the slots in, the params in and out, the loss out).  The fit
    itself, whatever implements it, is bound by ``fit_bound`` over all
    the rows."""
    from clawker_tpu_torch.kernels import anomaly as K

    params = 2 * f * HIDDEN + HIDDEN + f
    n = rows[0]
    a_bytes = 4 * (2 * n * f + params + K.fit_slots(n) * K.slot_floats(f))
    b_bytes = 4 * (K.shard_slot_floats(rows, f) + 2 * params + 1)
    return (_bound(a_bytes / HBM_BPS, step_flops(n, f) / BF16_FLOPS),
            _bound(b_bytes / HBM_BPS, 0.0))


def _shard_fit(params, x, noises, mesh, stamps=None):
    """K5's fit over ``mesh`` from a copy of ``params``, as ``fit_shard_``
    routes it (one launch when the shards lie on one card) -> (the first
    device's params, losses)."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K

    replicas = M.shard_params(tuple(p.clone() for p in params), mesh)
    losses = torch.empty(len(noises), device=x.device)
    K.fit_shard_(replicas, M.shard_rows(x, mesh), M.shard_noise(noises, mesh),
                 lr=1e-2, sigma=0.25, losses_out=losses, stamps=stamps)
    for dev in mesh.distinct:
        torch.cuda.synchronize(dev)
    return replicas[0], losses


def _per_step_fit(params, x, noises, mesh):
    """K5's fit over ``mesh`` from a copy of ``params`` by the per-step
    route (a launch A per shard and a launch B each step), on any layout
    -> (the first device's params, losses)."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K

    replicas = M.shard_params(tuple(p.clone() for p in params), mesh)
    xs, ns = M.shard_rows(x, mesh), M.shard_noise(noises, mesh)
    rows, f, by_dev = K._check_shards(replicas, xs, ns, len(noises))
    losses = torch.empty(len(noises), device=x.device)
    slots = torch.empty(K.shard_slot_floats(rows, f), device=x.device)
    K._fit_shard_steps(by_dev, xs, ns, rows, f, lr=1e-2, sigma=0.25,
                       slots=slots, losses_out=losses)
    for dev in mesh.distinct:
        torch.cuda.synchronize(dev)
    return replicas[0], losses


def _k3_fit(params, x, noises):
    import torch

    from clawker_tpu_torch.kernels import anomaly as K

    fp = tuple(p.clone() for p in params)
    losses = torch.empty(len(noises), device=x.device)
    K.fit_(fp, x, noises, lr=1e-2, sigma=0.25, losses_out=losses)
    torch.cuda.synchronize()
    return fp, losses


def _same_fit(a, b) -> bool:
    import torch

    (pa, la), (pb, lb) = a, b
    return (all(torch.equal(p, q) for p, q in zip(pa, pb))
            and torch.equal(la, lb))


def _routes_agree(tag: str, params, x, noises, mesh) -> None:
    """The one-launch fit over ``mesh`` (one card) bit for bit the
    per-step route's, and twice the same bits."""
    one = _shard_fit(params, x, noises, mesh)
    per = _per_step_fit(params, x, noises, mesh)
    check(_same_fit(one, per),
          f"{tag}: the one-launch fit is not the per-step route's bits: "
          f"params {_max_abs(one[0], per[0]):.3g} apart, losses "
          f"{float((one[1] - per[1]).abs().max()):.3g}")
    check(_same_fit(one, _shard_fit(params, x, noises, mesh)),
          f"{tag}: two one-launch fits from the same inputs differ")


def shard_kernel_phase(device) -> dict:
    """K5 at every KERNEL_SHAPE: over SHARD_COUNTS shards of one card, the
    per-step route's step against its plain version (params and loss at
    the fit-step tolerances; the gathered slots' sums at SLOT_SUM_RTOL;
    launch B against the plain reduce of its own slots); over
    TIMED_SHARDS shards the one-launch fit bit for bit the per-step
    route's (``_routes_agree``), over one shard K3's, and over
    MAIN_PATH_SHARDS within K3's tolerances of the plain sharded fit.
    Then ``shard_reload_check``.  -> max abs errors per launch."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    errs = {K.FIT_SHARD: 0.0, K.FIT_SHARD_PARTIALS: 0.0,
            K.FIT_SHARD_REDUCE: 0.0}
    slot_max = 0.0
    for n, f in KERNEL_SHAPES:
        params, x, noises = _inputs(n, f, FIT_STEPS, device, seed=n + f)
        for shards in SHARD_COUNTS:
            mesh = k5_mesh(shards, device)
            xs, ns = M.shard_rows(x, mesh), M.shard_rows(noises[0], mesh)
            rows = [len(t) for t in xs]
            total = K.shard_slot_offsets(rows)[-1]
            slots = torch.empty(K.shard_slot_floats(rows, f), device=device)
            kp = tuple(p.clone() for p in params)
            loss = torch.empty(1, device=device)
            K.fit_shard_step_([kp], xs, ns, lr=1e-2, sigma=0.25,
                              loss_out=loss, slots=slots)
            torch.cuda.synchronize()
            name = f"K5 [{n},{f}] over {shards} shards"
            rp, r_loss = R.fit_shard_step(*params, xs, ns, 1e-2, 0.25)
            err = _max_abs(kp, rp)
            check(err <= STEP1_PARAM_ATOL,
                  f"{name}: params after 1 step off by {err:.3g}")
            ok, lerr = _close(loss[0], r_loss, rtol=STEP1_LOSS_RTOL)
            check(ok, f"{name}: loss of step 1 off by {lerr:.3g}")
            # the gathered slots against the whole batch's unrounded
            # gradients, and launch B against the plain reduce of them
            slot_err = _slot_sum_err(params, x, noises[0], slots, total)
            check(slot_err <= SLOT_SUM_RTOL,
                  f"{name}: slot sums off the plain fp32 sums by "
                  f"{slot_err:.3g} (normwise)")
            slot_max = max(slot_max, slot_err)
            got, _ = _slot_totals(slots, total, f)
            want, _ = R.shard_step_grads(*params, xs, ns, 0.25)
            a_err = max(float((g - w.double()).abs().max())
                        for g, w in zip(got, want))
            pp, p_loss = plain_reduce(params, slots, total, n, f, 1e-2)
            b_err = _max_abs(kp, pp)
            check(b_err <= STEP1_PARAM_ATOL,
                  f"{name}: launch B off the plain reduce of its slots by "
                  f"{b_err:.3g}")
            ok, lerr = _close(loss[0], p_loss, rtol=STEP1_LOSS_RTOL)
            check(ok, f"{name}: launch B's loss off the plain one by "
                      f"{lerr:.3g}")
            errs[K.FIT_SHARD_PARTIALS] = max(errs[K.FIT_SHARD_PARTIALS],
                                             a_err)
            errs[K.FIT_SHARD_REDUCE] = max(errs[K.FIT_SHARD_REDUCE], err,
                                           b_err)
        for shards in TIMED_SHARDS:
            _routes_agree(f"K5 [{n},{f}] x{FIT_STEPS} over {shards} shards",
                          params, x, noises, k5_mesh(shards, device))
        one = _shard_fit(params, x, noises, k5_mesh(1, device))
        k3 = _k3_fit(params, x, noises)
        check(_same_fit(one, k3),
              f"K5 [{n},{f}] over 1 shard: not bit-identical to K3 after "
              f"{FIT_STEPS} steps: params {_max_abs(one[0], k3[0]):.3g} "
              f"apart")
        mesh = k5_mesh(MAIN_PATH_SHARDS, device)
        sp, s_loss = _shard_fit(params, x, noises, mesh)
        rp, r_loss = R.fit_shard(*params, M.shard_rows(x, mesh),
                                 M.shard_noise(noises, mesh), 1e-2, 0.25)
        err = _max_abs(sp, rp)
        check(err <= FIT_PARAM_ATOL,
              f"K5 [{n},{f}] x{FIT_STEPS} over {MAIN_PATH_SHARDS} shards: "
              f"params off the plain sharded fit by {err:.3g}")
        rtol = FIT_LOSS_RTOL if f >= NARROW_F else NARROW_FIT_LOSS_RTOL
        ok, lerr = _close(s_loss, r_loss, rtol=rtol)
        check(ok, f"K5 [{n},{f}] x{FIT_STEPS} over {MAIN_PATH_SHARDS} "
                  f"shards: losses off the plain sharded fit by {lerr:.3g}")
        errs[K.FIT_SHARD] = max(errs[K.FIT_SHARD], err)
    shard_reload_check(device)
    print(f"K5 at {len(KERNEL_SHAPES)} shapes over {SHARD_COUNTS} shards of "
          f"one card: step 1's params (atol {STEP1_PARAM_ATOL}) and loss "
          f"(rtol {STEP1_LOSS_RTOL}) against the plain sharded step and "
          f"launch B against the plain reduce of its own slots; the "
          f"gathered slots' sums normwise rtol {SLOT_SUM_RTOL} (largest "
          f"{slot_max:.3g}); the one-launch fit over {TIMED_SHARDS} shards "
          f"bit-identical to the per-step route and to itself, over one "
          f"shard to K3, and over {MAIN_PATH_SHARDS} shards at K3's "
          f"{FIT_STEPS}-step tolerances of the plain sharded fit")
    print(f"K5 max abs err: {json.dumps(errs)}")
    return errs


def shard_reload_check(device) -> None:
    """K5's one-launch fit at RELOAD_SHAPE over RELOAD_SHARDS shards,
    where a block's x tiles (two items' worth) do not fit in shared
    memory and it reloads them at each tile: bit for bit the per-step
    route and itself, within K3's tolerances of the plain sharded fit."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = RELOAD_SHAPE
    params, x, noises = _inputs(n, f, RELOAD_STEPS, device, seed=n + f)
    mesh = k5_mesh(RELOAD_SHARDS, device)
    rows = [len(t) for t in M.shard_rows(x, mesh)]
    plan = K.shard_fit_plan(
        rows, torch.cuda.get_device_properties(device).multi_processor_count,
        f)
    check(plan.resident_tiles == 0,
          f"K5 [{n},{f}] over {RELOAD_SHARDS} shards: planned resident")
    tag = f"K5 [{n},{f}] x{RELOAD_STEPS} over {RELOAD_SHARDS} shards"
    _routes_agree(f"{tag} (x reloaded)", params, x, noises, mesh)
    sp, s_loss = _shard_fit(params, x, noises, mesh)
    rp, r_loss = R.fit_shard(*params, M.shard_rows(x, mesh),
                             M.shard_noise(noises, mesh), 1e-2, 0.25)
    err = _max_abs(sp, rp)
    check(err <= FIT_PARAM_ATOL, f"{tag} (x reloaded) params off by "
                                 f"{err:.3g}")
    ok, lerr = _close(s_loss, r_loss, rtol=FIT_LOSS_RTOL)
    check(ok, f"{tag} (x reloaded) losses off by {lerr:.3g}")
    print(f"{tag}, x tiles reloaded ({K.shard_slot_offsets(rows)[-1]} "
          f"slots, {plan.smem} bytes of shared memory): the one-launch fit "
          f"bit-identical to the per-step route and to itself; off the "
          f"plain sharded fit: params {err:.3g}, losses "
          f"{_rel(s_loss, r_loss):.3g} relative")


def mesh_fit_phase(device) -> dict:
    """K5's fit of the two fleets' padded windows, drawn as
    ``_fit_and_score`` draws them (seed 0, FIT_STEPS steps), against K3's:
    over 1 shard bit for bit; over MESH_SHARDS shards twice the same
    bits, params within FIT_PARAM_ATOL, losses within MESH_LOSS_RTOL and
    the sharded score within MESH_SCORE_RTOL / MESH_SCORE_ATOL of K3's; the
    sharded score bit for bit K1's on the same params.  Over 1 and
    MESH_SHARDS shards the one-launch fit bit for bit the per-step
    route's.  Each fleet's ``shard_timings``.  -> the timings at
    TIMED_SHAPE."""
    import torch

    from clawker_tpu_torch.analytics import features as F
    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.analytics import runtime as art
    from clawker_tpu_torch.kernels import anomaly as K

    fleets = {
        "bench fleet": synth_egress_records(),
        "hour of 64 agents": synth_egress_records(agents=64, windows=64,
                                                  per_window=24),
    }
    timings = {}
    for name, records in fleets.items():
        _, X = F.featurize(records)
        data = M.virtual_mesh(max(MESH_SHARDS), device).data
        x = torch.from_numpy(art._pad_rows(X, X.shape[1], data)).to(device)
        n, f = x.shape
        params, noises = art._draw(0, FIT_STEPS, x)
        k3 = _k3_fit(params, x, noises)
        k3_scores = K.score(k3[0], x)
        check(_same_fit(_shard_fit(params, x, noises,
                                   k5_mesh(1, device)), k3),
              f"K5 {name} [{n},{f}] over 1 shard: not bit-identical to K3")
        for shards in (1, *MESH_SHARDS):
            _routes_agree(f"K5 {name} [{n},{f}] over {shards} shards",
                          params, x, noises, k5_mesh(shards, device))
        for shards in MESH_SHARDS:
            mesh = k5_mesh(shards, device)
            tag = f"K5 {name} [{n},{f}] over {shards} shards"
            sp, s_loss = _shard_fit(params, x, noises, mesh)
            err = _max_abs(sp, k3[0])
            check(err <= FIT_PARAM_ATOL,
                  f"{tag}: params off K3's by {err:.3g}")
            ok, lerr = _close(s_loss, k3[1], rtol=MESH_LOSS_RTOL)
            check(ok, f"{tag}: losses off K3's by {lerr:.3g}")
            scores = M.score_shards(M.shard_params(sp, mesh),
                                    M.shard_rows(x, mesh), mesh)
            check(torch.equal(scores, K.score(sp, x)),
                  f"{tag}: the sharded score is not K1's bit for bit")
            ok, serr = _close(scores, k3_scores, rtol=MESH_SCORE_RTOL,
                              atol=MESH_SCORE_ATOL)
            check(ok, f"{tag}: scores off K3's by {serr:.3g}")
            print(f"{tag}: the one-launch fit is the per-step route's "
                  f"bits, twice the same; off K3's fit: params "
                  f"{err:.3g}, losses {_rel(s_loss, k3[1]):.3g} relative, "
                  f"scores {_rel(scores, k3_scores):.3g} relative (rtol "
                  f"{MESH_SCORE_RTOL}); the sharded score is K1's bit for "
                  f"bit")
        timings.update(shard_timings(params, x, noises))
    return timings


def _enqueue_us(fn, reps: int = 20) -> float:
    """Median host us to enqueue ``fn`` (the card idle, no synchronize
    inside the clock)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def shard_timings(params, x, noises) -> dict:
    """K5's time per fit at TIMED_SHARDS shards of one card beside K3's,
    all in this call: the one-launch fit's and K3's device time by
    ``event_ms`` (events behind a spin kernel) and the host's enqueue per
    fit; the per-step route's device time (the fit captured in one CUDA
    graph); at TIMED_SHAPE also the plain sharded fit's time, the
    one-launch fit's phase trace over TRACED_SHARDS shards beside K3's,
    and each per-step launch's device time, plain time and bound at
    MAIN_PATH_SHARDS shards.  -> {kernel: (ms, plain, bound, by)} at
    MAIN_PATH_SHARDS shards (empty off TIMED_SHAPE)."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = x.shape
    steps = len(noises)
    timed = (n, f) == TIMED_SHAPE
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    losses = torch.empty(steps, device=x.device)
    tq = tuple(p.clone() for p in params)

    def k3_fit():
        K.fit_(tq, x, noises, lr=1e-2, sigma=0.25, losses_out=losses)

    k3_ms, k3_enq = event_ms(k3_fit), _enqueue_us(k3_fit)
    bound, by = fit_bound(n, f, steps)
    out = {}
    for shards in TIMED_SHARDS:
        mesh = k5_mesh(shards, x.device)
        xs, ns = M.shard_rows(x, mesh), M.shard_noise(noises, mesh)
        rows = [len(t) for t in xs]
        scratch = torch.empty(K.shard_scratch_floats(rows, f),
                              device=x.device)
        replicas = [tuple(p.clone() for p in params)]
        by_dev = {x.device: replicas[0]}
        slots = scratch[K.staged_floats(f):]

        def fit():
            K.fit_shard_(replicas, xs, ns, lr=1e-2, sigma=0.25,
                         losses_out=losses, scratch=scratch)

        def per_step():
            K._fit_shard_steps(by_dev, xs, ns, rows, f, lr=1e-2, sigma=0.25,
                               slots=slots, losses_out=losses)

        ms, enq = event_ms(fit), _enqueue_us(fit)
        per_ms = cuda_ms(per_step, batches=5, per_batch=1)
        plain = ""
        if timed:
            plain_ms = event_ms(
                lambda: R.fit_shard(*params, xs, ns, 1e-2, 0.25), reps=3)
            plain = f"; plain sharded fit {plain_ms:.3f} ms (host-bound)"
            if shards == MAIN_PATH_SHARDS:
                out[K.FIT_SHARD] = (ms, plain_ms, bound, by)
        plan = K.shard_fit_plan(rows, sms, f)
        print(f"K5 [{n},{f}] x{steps} over {shards} shard(s) of one card: "
              f"one launch {ms:.4f} ms per fit (device), host enqueue "
              f"{enq:.2f} us per fit, {K.shard_slot_offsets(rows)[-1]} "
              f"items on {sms} blocks (at most "
              f"{max(map(len, plan.items))} a block, "
              f"{plan.resident_tiles} x tiles resident a block); per-step "
              f"route {per_ms:.4f} ms per fit (device, one CUDA graph), "
              f"{steps * (shards + 1)} launches; K3 {k3_ms:.4f} ms per fit, "
              f"host enqueue {k3_enq:.2f} us; bound {bound:.4f} ms by {by}"
              f"{plain}")
    if not timed:
        return out
    k3_split, k3_sub = phase_split(params, x, noises)
    print(f"K3 [{n},{f}] per step, mean us of the phase trace: phase A "
          f"{k3_split[0]:.2f}, barrier {k3_split[1]:.2f}, phase B "
          f"{k3_split[2]:.2f}, barrier {k3_split[3]:.2f}; phase A's "
          f"sub-stages " + ", ".join(f"{k} {v:.2f}"
                                     for k, v in zip(A_SUBSTAGES, k3_sub)))
    for shards in TRACED_SHARDS:
        mesh = k5_mesh(shards, x.device)
        stamps = torch.zeros((steps, K.FIT_STAMPS, sms), dtype=torch.int64,
                             device=x.device)
        _shard_fit(params, x, noises, mesh, stamps=stamps)
        rows = [len(t) for t in M.shard_rows(x, mesh)]
        split, sub = _split(stamps, min(K.shard_slot_offsets(rows)[-1], sms))
        print(f"K5 [{n},{f}] over {shards} shards per step, mean us of the "
              f"phase trace: phase A {split[0]:.2f}, barrier {split[1]:.2f}"
              f", phase B {split[2]:.2f}, barrier {split[3]:.2f}; phase A's "
              f"sub-stages (each block's last item) "
              + ", ".join(f"{k} {v:.2f}" for k, v in zip(A_SUBSTAGES, sub)))
    # each launch of the per-step route alone, at the main path's shards
    mesh = k5_mesh(MAIN_PATH_SHARDS, x.device)
    xs, ns = M.shard_rows(x, mesh), M.shard_rows(noises[0], mesh)
    rows = [len(t) for t in xs]
    total = K.shard_slot_offsets(rows)[-1]
    slots = torch.empty(K.shard_slot_floats(rows, f), device=x.device)
    kp = tuple(p.clone() for p in params)
    K.fit_shard_step_([kp], xs, ns, lr=1e-2, sigma=0.25, loss_out=losses,
                      slots=slots)
    c_partials = K.kernel(K.FIT_SHARD_PARTIALS)
    c_reduce = K.kernel(K.FIT_SHARD_REDUCE)

    def partials():
        stream = torch.cuda.current_stream().cuda_stream
        K._launched(K.FIT_SHARD_PARTIALS, c_partials(
            xs[0].data_ptr(), ns[0].data_ptr(), 0.25,
            *(p.data_ptr() for p in params), slots.data_ptr(), slots.numel(),
            rows[0], n, f, stream))

    def reduce():
        stream = torch.cuda.current_stream().cuda_stream
        K._launched(K.FIT_SHARD_REDUCE, c_reduce(
            slots.data_ptr(), slots.numel(), total,
            *(p.data_ptr() for p in kp), losses.data_ptr(), 1e-2, n, f,
            stream))

    a_bound, b_bound = shard_bound(rows, f)
    for name, kernel_call, plain_call, (bound, by) in (
            (K.FIT_SHARD_PARTIALS, partials,
             lambda: R.step_grads(*params, xs[0], ns[0], 0.25, count=n * f),
             a_bound),
            (K.FIT_SHARD_REDUCE, reduce,
             lambda: plain_reduce(params, slots, total, n, f, 1e-2),
             b_bound)):
        ms, plain = cuda_ms(kernel_call), cuda_ms(plain_call)
        out[name] = (ms, plain, bound, by)
        print(f"kernel {name} [{n},{f}] over {MAIN_PATH_SHARDS} shards "
              f"(shard 0: {rows[0]} rows; {total} slots), the per-step "
              f"route's launch: device {ms * 1e3:.2f} us a launch (plain "
              f"{plain * 1e3:.2f} us, bound {bound * 1e3:.3f} us by {by})")
    return out


def graft_phase() -> dict:
    """The graft entry on the card: ``entry()``'s score against its plain
    version, ``dryrun_multichip(8)`` (K5b's per-step route over the 4x2
    mesh of 8 shards of the card and K1 per data block, counted),
    ``dryrun_multichip(ODD_MESH_SHARDS)`` (K5's per-step route over 3x1,
    counted), and ``python -m clawker_tpu_torch.graft_entry``.  -> the
    two dryruns' launches."""
    import torch

    from clawker_tpu_torch import graft_entry
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    fn, (params, x) = graft_entry.entry()
    out = fn(params, x)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (256,) and out.device.type == "cuda",
          f"entry: scores {tuple(out.shape)} on {out.device}")
    ok, err = _close(out, R.score(*params, x), rtol=SCORE_RTOL,
                     atol=SCORE_ATOL)
    check(ok, f"entry: score off the plain score by {err:.3g}")
    _, counts = _counted(lambda: graft_entry.dryrun_multichip(8))
    want = dict.fromkeys(K.LAUNCHES, 0)
    want.update({K.SCORE: 4, K.FIT_MODEL_FORWARD: 16,
                 K.FIT_MODEL_PARTIALS: 16, K.FIT_MODEL_REDUCE: 4})
    check(counts == want,
          f"dryrun_multichip(8): launches {counts}, want {want}")
    _, odd = _counted(lambda: graft_entry.dryrun_multichip(ODD_MESH_SHARDS))
    want = dict.fromkeys(K.LAUNCHES, 0)
    want.update({K.SCORE: ODD_MESH_SHARDS,
                 K.FIT_SHARD_PARTIALS: 2 * ODD_MESH_SHARDS,
                 K.FIT_SHARD_REDUCE: 2})
    check(odd == want, f"dryrun_multichip({ODD_MESH_SHARDS}): launches "
                       f"{odd}, want {want}")
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch.graft_entry"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and "multichip dryrun ok" in proc.stdout,
          f"python -m clawker_tpu_torch.graft_entry exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    print(f"graft entry: entry() scores (256,) on the card (off the plain "
          f"score by {err:.3g}); dryrun_multichip(8) over a 4x2 mesh of 8 "
          f"shards of cuda:0, launches {json.dumps(counts)}; "
          f"dryrun_multichip({ODD_MESH_SHARDS}) over 3x1, launches "
          f"{json.dumps(odd)}; python -m clawker_tpu_torch.graft_entry: "
          f"{' / '.join(proc.stdout.strip().splitlines())}")
    return {k: counts[k] + odd[k] for k in counts}


def bench_lane_phase(device) -> None:
    """``runtime.bench_lane`` on the bench fleet, on the card."""
    from clawker_tpu_torch.analytics import runtime as art

    doc = art.bench_lane(synth_egress_records(), device=device)
    check(set(doc) == {"windows", "featurize_ms", "train_ms", "train_steps",
                       "score_step_us", "device"}
          and doc["windows"] == 520 and doc["device"].startswith("cuda"),
          f"bench_lane: {doc}")
    print(f"bench_lane: {json.dumps(doc)}")


# ---------------------------------------------------------------- K5b phase


def k5_mesh(shards: int, device):
    """``shards`` shards of one card with the rows over all of them and the
    params replicated (model = 1): K5's layout at any count, which
    ``virtual_mesh`` takes only at an odd one."""
    from clawker_tpu_torch.analytics import mesh as M

    dev = M.virtual_mesh(1, device).devices[0]
    return M.Mesh(data=shards, model=1, devices=(dev,) * shards)


def _half_slot_totals(slots, count: int, f: int):
    """The sum over the first ``count`` slots of one half of K5b's slot
    buffer, in fp64, unpacked: ((dW_enc_m [F, H/2], db_enc_m [H/2],
    dW_dec_m [H/2, F], db_dec [F]), the squared-error sum)."""
    from clawker_tpu_torch.kernels import anomaly as K

    pf, fh = K.half_slot_floats(f), f * K.HALF
    t = slots[:count * pf].view(count, pf).double().sum(0)
    return ((t[:fh].view(f, K.HALF), t[fh:fh + K.HALF],
             t[fh + K.HALF:2 * fh + K.HALF].view(f, K.HALF).T,
             t[2 * fh + K.HALF:2 * fh + K.HALF + f]), t[-1])


def _model_fit(params, x, noises, mesh, scratch=None, route=None,
               stamps=None):
    """K5b's fit over ``mesh`` (model = 2) from the halves of ``params``,
    as ``fit_model_`` routes it (by layout, or by ``route``: the fold, the
    cards route or the per-step route) -> (the two halves after, losses).
    ``scratch`` and ``stamps`` as ``fit_model_`` takes them (None:
    allocated, none)."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K

    halves = M.shard_params(params, mesh)
    xs, ns = M.shard_rows(x, mesh), M.shard_noise(noises, mesh)
    losses = torch.empty(len(noises), device=x.device)
    K.fit_model_(halves, xs, ns, lr=1e-2, sigma=0.25, losses_out=losses,
                 scratch=scratch, route=route, stamps=stamps)
    for dev in mesh.distinct:
        torch.cuda.synchronize(dev)
    return halves[:K.MODEL], losses


def _same_model_fit(a, b) -> bool:
    import torch

    (ha, la), (hb, lb) = a, b
    return (all(torch.equal(p, q) for x, y in zip(ha, hb)
                for p, q in zip(x, y)) and torch.equal(la, lb))


def _model_plain_y(halves, xs, noises):
    """The plain partial outputs y_m of each half over each data block,
    [MODEL, N, F], as K5b's forward forms them."""
    import torch

    from clawker_tpu_torch.kernels import reference as R

    ys = []
    for w_enc, b_enc, w_dec, _ in halves:
        blocks = []
        for x, noise in zip(xs, noises):
            a = R.bf(x + 0.25 * noise) @ R.bf(w_enc) + b_enc
            blocks.append(R.bf(R.gelu_tanh(a)) @ R.bf(w_dec))
        ys.append(torch.cat(blocks))
    return torch.stack(ys)


def model_step_check(params, x, noise, mesh) -> dict:
    """One K5b step by the per-step route over ``mesh`` against its plain
    version: each half's params and the loss at the fit-step tolerances,
    the halves' b_dec the same bits; the forward's y normwise at
    SCORE_RTOL; each half's slot sums against the plain unrounded sums at
    SLOT_SUM_RTOL (normwise); the reduce against the plain update of its
    own slots.  -> max abs errors per launch."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = x.shape
    name = f"K5b [{n},{f}] over {mesh.desc}"
    halves = M.shard_params(params, mesh)
    start = [tuple(p.clone() for p in h) for h in halves[:K.MODEL]]
    xs, ns = M.shard_rows(x, mesh), M.shard_rows(noise, mesh)
    blocks, bnoise = xs[::K.MODEL], ns[::K.MODEL]
    rows = [len(t) for t in blocks]
    scratch = torch.empty(K.model_scratch_floats(rows, f), device=x.device)
    loss = torch.empty(1, device=x.device)
    K.fit_model_step_(halves, xs, ns, lr=1e-2, sigma=0.25, loss_out=loss,
                      scratch=scratch)
    torch.cuda.synchronize()
    want, w_loss = R.fit_model_step(start, blocks, bnoise, 1e-2, 0.25)
    err = max(_max_abs(h, w) for h, w in zip(halves[:K.MODEL], want))
    check(err <= STEP1_PARAM_ATOL,
          f"{name}: params after 1 step off by {err:.3g}")
    ok, lerr = _close(loss[0], w_loss, rtol=STEP1_LOSS_RTOL)
    check(ok, f"{name}: loss of step 1 off by {lerr:.3g}")
    check(torch.equal(halves[0].b_dec, halves[1].b_dec),
          f"{name}: the halves' b_dec differ")
    total = K.shard_slot_offsets(rows)[-1]
    pf = K.half_slot_floats(f)
    route = scratch[K.model_image_floats(f):]   # the slots, y, a float
    y = route[K.MODEL * total * pf:-1].view(K.MODEL, sum(rows), f)
    y_want = _model_plain_y(start, blocks, bnoise)
    y_err = float((y - y_want).abs().max())
    check(y_err <= SCORE_RTOL * float(y_want.abs().max()),
          f"{name}: the forward's y off by {y_err:.3g}")
    grads, _ = R.model_step_grads(start, blocks, bnoise, 0.25)
    a_err = b_err = slot_err = 0.0
    for m in range(K.MODEL):
        slots = route[m * total * pf:]
        (got_enc, got_be, got_dec, got_bd), sq = _half_slot_totals(
            slots, total, f)
        dw_enc, db_enc, dw_dec, db_dec = grads[m]
        slot_err = max(slot_err, *(
            float((g - w.double()).norm() / w.double().norm())
            for g, w in ((got_enc, dw_enc), (got_dec, dw_dec))))
        a_err = max(a_err, *(float((g - w.double()).abs().max()) for g, w in
                             zip((got_enc, got_be, got_dec, got_bd),
                                 grads[m])))
        plain = R.sgd_update(start[m], (got_enc.float(), got_be.float(),
                                        got_dec.float(), got_bd.float()),
                             1e-2)
        b_err = max(b_err, _max_abs(halves[m], plain))
        if m == 0:
            ok, lerr = _close(loss[0], sq.float() / (sum(rows) * f),
                              rtol=STEP1_LOSS_RTOL)
            check(ok, f"{name}: the reduce's loss off the plain one by "
                      f"{lerr:.3g}")
    check(slot_err <= SLOT_SUM_RTOL,
          f"{name}: slot sums off the plain fp32 sums by {slot_err:.3g} "
          f"(normwise)")
    check(b_err <= STEP1_PARAM_ATOL,
          f"{name}: the reduce off the plain update of its slots by "
          f"{b_err:.3g}")
    return {"y": y_err, "slots": a_err, "slot_rel": slot_err,
            "params": max(err, b_err)}


def model_kernel_phase(device) -> dict:
    """K5b over MODEL_MESHES of one card: ``model_step_check`` at every
    KERNEL_SHAPE, and there a fit of CARDS_CHECK_STEPS steps by the cards
    route with one participating card bit for bit the fold's and the
    per-step route's; at TIMED_SHAPE x FIT_STEPS the one-launch fit and
    the cards route bit for bit the per-step route's and each itself,
    within K5's FIT tolerances of the plain split fit
    (``reference.fit_model_shard``), the halves' b_dec the same bits, and
    each one's staged images after the fit bit for bit the plain staging
    of the halves it returns (``reference.staged``).  -> max abs errors
    per entry point."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    errs = {K.FIT_MODEL: 0.0, K.FIT_MODEL_FORWARD: 0.0,
            K.FIT_MODEL_PARTIALS: 0.0, K.FIT_MODEL_REDUCE: 0.0,
            K.FIT_MODEL_CARDS: 0.0}
    slot_max = 0.0
    for n, f in KERNEL_SHAPES:
        params, x, noises = _inputs(n, f, CARDS_CHECK_STEPS, device,
                                    seed=n + f)
        for shards in MODEL_MESHES:
            mesh = M.virtual_mesh(shards, device)
            cards = _model_fit(params, x, noises, mesh, route=K.ROUTE_CARDS)
            check(_same_model_fit(cards, _model_fit(params, x, noises, mesh))
                  and _same_model_fit(cards, _model_fit(
                      params, x, noises, mesh, route=K.ROUTE_STEPS)),
                  f"K5b [{n},{f}] x{CARDS_CHECK_STEPS} over {mesh.desc}: "
                  f"the cards route (one card) is not the fold's and the "
                  f"per-step route's bits")
            e = model_step_check(params, x, noises[0], mesh)
            errs[K.FIT_MODEL_FORWARD] = max(errs[K.FIT_MODEL_FORWARD],
                                            e["y"])
            errs[K.FIT_MODEL_PARTIALS] = max(errs[K.FIT_MODEL_PARTIALS],
                                             e["slots"])
            errs[K.FIT_MODEL_REDUCE] = max(errs[K.FIT_MODEL_REDUCE],
                                           e["params"])
            slot_max = max(slot_max, e["slot_rel"])
    n, f = TIMED_SHAPE
    params, x, noises = _inputs(n, f, FIT_STEPS, device, seed=n + f)
    for shards in MODEL_MESHES:
        mesh = M.virtual_mesh(shards, device)
        tag = f"K5b [{n},{f}] x{FIT_STEPS} over {mesh.desc}"
        rows = [len(t) for t in M.shard_rows(x, mesh)[::K.MODEL]]
        scratch = torch.empty(K.model_scratch_floats(rows, f),
                              device=x.device)
        one = _model_fit(params, x, noises, mesh, scratch=scratch)
        image = torch.cat([R.staged(*h) for h in one[0]])
        check(torch.equal(scratch[:K.model_image_floats(f)].view(torch.int32),
                          image.view(torch.int32)),
              f"{tag}: the staged images are not the halves' plain staging")
        per = _model_fit(params, x, noises, mesh, route=K.ROUTE_STEPS)
        check(_same_model_fit(one, per),
              f"{tag}: the one-launch fit is not the per-step route's bits")
        check(_same_model_fit(one, _model_fit(params, x, noises, mesh)),
              f"{tag}: two one-launch fits from the same inputs differ")
        c_scratch = torch.empty(K.cards_scratch_floats(rows, f),
                                device=x.device)
        cards = _model_fit(params, x, noises, mesh, scratch=c_scratch,
                           route=K.ROUTE_CARDS)
        image = torch.cat([R.staged(*h) for h in cards[0]])
        at = K.cards_copy_floats(f)
        check(torch.equal(c_scratch[at:at + K.model_image_floats(f)]
                          .view(torch.int32), image.view(torch.int32)),
              f"{tag}: the cards route's images are not the halves' plain "
              f"staging")
        check(_same_model_fit(cards, per) and _same_model_fit(
            cards, _model_fit(params, x, noises, mesh, route=K.ROUTE_CARDS)),
              f"{tag}: the cards route (one card) is not the per-step "
              f"route's bits, or not twice the same")
        check(torch.equal(one[0][0].b_dec, one[0][1].b_dec),
              f"{tag}: the halves' b_dec differ")
        xs, ns = M.shard_rows(x, mesh), M.shard_noise(noises, mesh)
        want, w_losses = R.fit_model_shard(
            [tuple(p) for p in M.shard_params(params, mesh)[:K.MODEL]],
            xs[::K.MODEL], ns[::K.MODEL], 1e-2, 0.25)
        err = max(_max_abs(h, w) for h, w in zip(one[0], want))
        check(err <= FIT_PARAM_ATOL,
              f"{tag}: params off the plain split fit by {err:.3g}")
        ok, lerr = _close(one[1], w_losses, rtol=FIT_LOSS_RTOL)
        check(ok, f"{tag}: losses off the plain split fit by {lerr:.3g}")
        errs[K.FIT_MODEL] = max(errs[K.FIT_MODEL], err)
        errs[K.FIT_MODEL_CARDS] = max(errs[K.FIT_MODEL_CARDS], max(
            _max_abs(h, w) for h, w in zip(cards[0], want)))
        print(f"{tag}: the one-launch fit and the cards route (one card) "
              f"are the per-step route's bits, each twice the same, the "
              f"halves' b_dec and staged images the plain bits; off the "
              f"plain split fit: params {err:.3g} (atol {FIT_PARAM_ATOL}), "
              f"losses {_rel(one[1], w_losses):.3g} relative (rtol "
              f"{FIT_LOSS_RTOL})")
    print(f"K5b at {len(KERNEL_SHAPES)} shapes over "
          f"{[M.virtual_mesh(s, device).desc for s in MODEL_MESHES]} of one "
          f"card: the cards route's {CARDS_CHECK_STEPS}-step fit the fold's "
          f"and the per-step route's bits; step 1's params (atol "
          f"{STEP1_PARAM_ATOL}) and loss (rtol {STEP1_LOSS_RTOL}) against the plain split step, the forward's "
          f"y normwise rtol {SCORE_RTOL}, the slots' sums normwise rtol "
          f"{SLOT_SUM_RTOL} (largest {slot_max:.3g}), the reduce against "
          f"the plain update of its own slots")
    print(f"K5b max abs err: {json.dumps(errs)}")
    return errs


def model_bound(rows, f: int) -> dict:
    """Least times of K5b's per-step launches over data blocks of ``rows``
    rows, each the larger of its bytes and its bf16 tensor flops: the
    forward of block 0's half (x, noise and the half's params in, y out;
    the two products over H/2), the partials (x, noise, the params and the
    peer's y in, the slots out; the forward again and the backward), and
    the reduce of one half (its slots in, its params in and out, the loss
    out)."""
    from clawker_tpu_torch.kernels import anomaly as K

    n, half = rows[0], K.HALF
    params = 2 * f * half + half + f
    slots = K.fit_slots(n) * K.half_slot_floats(f)
    fwd_flops = 4 * n * f * half
    return {
        K.FIT_MODEL_FORWARD: _bound(4 * (3 * n * f + params) / HBM_BPS,
                                    fwd_flops / BF16_FLOPS),
        K.FIT_MODEL_PARTIALS: _bound(
            4 * (3 * n * f + params + slots) / HBM_BPS,
            (fwd_flops + 18 * n * f * half) / BF16_FLOPS),
        K.FIT_MODEL_REDUCE: _bound(
            4 * (K.shard_slot_offsets(rows)[-1] * K.half_slot_floats(f)
                 + 2 * params + 1) / HBM_BPS, 0.0),
    }


def model_timings(device) -> dict:
    """K5b's time per fit at TIMED_SHAPE x FIT_STEPS over MODEL_MESHES of
    one card, beside K5 over k5_mesh of the same counts and K3, all in
    this call: each fit's device time by ``event_ms`` (median of 15 behind
    a spin kernel), K5b's per-step route's by ``cuda_ms`` (the fit
    captured in one CUDA graph), the plain split fit's (host-bound); the
    one-launch fit's phase trace (``fit_model_(stamps=)``, the step's
    phases and phase A's MODEL_SUBSTAGES); at the main path's 2x2 each
    per-step launch alone by ``cuda_ms`` beside its plain version and
    ``model_bound``.  -> {kernel: (ms, plain, bound, by)} at 2x2."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import reference as R

    n, f = TIMED_SHAPE
    params, x, noises = _inputs(n, f, FIT_STEPS, device, seed=n + f)
    steps = len(noises)
    losses = torch.empty(steps, device=x.device)
    tq = tuple(p.clone() for p in params)
    k3_ms = event_ms(lambda: K.fit_(tq, x, noises, lr=1e-2, sigma=0.25,
                                    losses_out=losses))
    bound, by = fit_bound(n, f, steps)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = {}
    for shards in MODEL_MESHES:
        mesh = M.virtual_mesh(shards, x.device)
        halves = M.shard_params(params, mesh)
        xs, ns = M.shard_rows(x, mesh), M.shard_noise(noises, mesh)
        rows, _, sets = K._check_model(halves, xs, ns, steps)
        scratch = torch.empty(K.model_scratch_floats(rows, f),
                              device=x.device)

        def fit():
            K.fit_model_(halves, xs, ns, lr=1e-2, sigma=0.25,
                         losses_out=losses, scratch=scratch)

        def per_step():
            K._fit_model_steps(sets, xs, ns, rows, f, lr=1e-2, sigma=0.25,
                               scratch=scratch, losses_out=losses)

        table, hv = K._fold_tables(sets, xs, ns, rows, x.device)
        c_fit = K.kernel(K.FIT_MODEL)
        stream = torch.cuda.current_stream().cuda_stream

        def c_call():
            check(c_fit(table, len(rows), hv, 0.25, scratch.data_ptr(),
                        scratch.numel(), losses.data_ptr(), 1e-2, f, steps,
                        0, 0, stream) == 0, "K5b's C call failed")

        c_scratch = torch.empty(K.cards_scratch_floats(rows, f),
                                device=x.device)

        def cards_fit(stamps=None):
            K.fit_model_(halves, xs, ns, lr=1e-2, sigma=0.25,
                         losses_out=losses, scratch=c_scratch, stamps=stamps,
                         route=K.ROUTE_CARDS)

        ms, enq, c_us = event_ms(fit), _enqueue_us(fit), _enqueue_us(c_call)
        cards_ms, cards_enq = event_ms(cards_fit), _enqueue_us(cards_fit)
        per_ms = cuda_ms(per_step, batches=5, per_batch=1)
        start = [tuple(p) for p in halves[:K.MODEL]]
        plain_ms = event_ms(lambda: R.fit_model_shard(
            start, xs[::K.MODEL], ns[::K.MODEL], 1e-2, 0.25), reps=3)
        k5 = k5_mesh(shards, x.device)
        replicas = [tuple(p.clone() for p in params)]
        k5_xs, k5_ns = M.shard_rows(x, k5), M.shard_noise(noises, k5)
        k5_ms = event_ms(lambda: K.fit_shard_(
            replicas, k5_xs, k5_ns, lr=1e-2, sigma=0.25, losses_out=losses))
        if shards == MAIN_PATH_SHARDS:
            out[K.FIT_MODEL] = (ms, plain_ms, bound, by)
            out[K.FIT_MODEL_CARDS] = (cards_ms, plain_ms, bound, by)
        plan = K.model_fit_plan(rows, sms, f)
        print(f"K5b [{n},{f}] x{steps} over {mesh.desc} of one card: one "
              f"launch {ms:.4f} ms per fit (device), host enqueue "
              f"{enq:.2f} us per fit (its C call {c_us:.2f}: the grid "
              f"queried once per card and F), "
              f"{K.shard_slot_offsets(rows)[-1]} items of both halves on "
              f"{sms} blocks (at most {max(map(len, plan.items))} a block, "
              f"{plan.resident_tiles} x tiles resident a block); per-step "
              f"route {per_ms:.4f} ms per fit (device, one CUDA graph), "
              f"{steps * (2 * shards + K.MODEL)} launches; plain split fit "
              f"{plain_ms:.3f} ms (host-bound); beside K5 over {k5.desc} "
              f"{k5_ms:.4f} ms ({ms / k5_ms:.3f}x) and K3 {k3_ms:.4f} ms "
              f"per fit; bound {bound:.4f} ms by {by}")
        stamps = torch.zeros((steps, K.FIT_STAMPS, sms), dtype=torch.int64,
                             device=x.device)
        K.fit_model_(halves, xs, ns, lr=1e-2, sigma=0.25, losses_out=losses,
                     scratch=scratch, stamps=stamps)
        split, sub = _split(stamps, min(K.shard_slot_offsets(rows)[-1], sms))
        print(f"K5b [{n},{f}] over {mesh.desc} per step, mean us of the "
              f"phase trace: phase A {split[0]:.2f}, barrier {split[1]:.2f}"
              f", phase B {split[2]:.2f}, barrier {split[3]:.2f}; phase A's "
              f"sub-stages (each block's last tile) "
              + ", ".join(f"{k} {v:.2f}"
                          for k, v in zip(MODEL_SUBSTAGES, sub)))
        print(f"K5b [{n},{f}] x{steps} over {mesh.desc} of one card by the "
              f"cards route (one participating card, "
              f"{K.FIT_MODEL_CARDS}): {cards_ms:.4f} ms per fit (device; "
              f"the fold {ms:.4f}, {cards_ms / ms:.3f}x), host enqueue "
              f"{cards_enq:.2f} us per fit (two C calls, the check and the "
              f"launch, and an event)")
        c_stamps = torch.zeros((steps, K.CARDS_STAMPS, sms),
                               dtype=torch.int64, device=x.device)
        cards_fit([c_stamps])
        print(f"K5b [{n},{f}] over {mesh.desc} by the cards route (one "
              f"card) per step, " + _cards_trace(
                  c_stamps, min(K.shard_slot_offsets(rows)[-1], sms)))
    # each launch of the per-step route alone, at the main path's 2x2
    mesh = M.virtual_mesh(MAIN_PATH_SHARDS, x.device)
    halves = M.shard_params(params, mesh)
    xs, ns = M.shard_rows(x, mesh), M.shard_rows(noises[0], mesh)
    blocks, bnoise = xs[::K.MODEL], ns[::K.MODEL]
    rows = [len(t) for t in blocks]
    total = K.shard_slot_offsets(rows)[-1]
    pf = K.half_slot_floats(f)
    scratch = torch.empty(K.model_scratch_floats(rows, f), device=x.device)
    K.fit_model_step_(halves, xs, ns, lr=1e-2, sigma=0.25, loss_out=losses,
                      scratch=scratch)
    route = scratch[K.model_image_floats(f):]   # the slots, y, a float
    y = route[K.MODEL * total * pf:]
    h0 = halves[0]
    c_fwd = K.kernel(K.FIT_MODEL_FORWARD)
    c_part = K.kernel(K.FIT_MODEL_PARTIALS)
    c_red = K.kernel(K.FIT_MODEL_REDUCE)

    def forward():
        stream = torch.cuda.current_stream().cuda_stream
        K._launched(K.FIT_MODEL_FORWARD, c_fwd(
            blocks[0].data_ptr(), bnoise[0].data_ptr(), 0.25,
            *(p.data_ptr() for p in h0), y.data_ptr(), rows[0], f, stream))

    def partials():
        stream = torch.cuda.current_stream().cuda_stream
        K._launched(K.FIT_MODEL_PARTIALS, c_part(
            blocks[0].data_ptr(), bnoise[0].data_ptr(), 0.25,
            *(p.data_ptr() for p in h0), y.data_ptr() + 4 * n * f,
            route.data_ptr(), route.numel(), rows[0], n, f, stream))

    def reduce():
        stream = torch.cuda.current_stream().cuda_stream
        K._launched(K.FIT_MODEL_REDUCE, c_red(
            route.data_ptr(), total * pf, total,
            *(p.data_ptr() for p in h0), losses.data_ptr(), 1e-2, n, f,
            stream))

    def plain_forward():
        a = R.bf(blocks[0] + 0.25 * bnoise[0]) @ R.bf(h0.w_enc) + h0.b_enc
        return R.bf(R.gelu_tanh(a)) @ R.bf(h0.w_dec)

    start = [tuple(h) for h in halves[:K.MODEL]]
    bounds = model_bound(rows, f)
    for name, kernel_call, plain_call in (
            (K.FIT_MODEL_FORWARD, forward, plain_forward),
            (K.FIT_MODEL_PARTIALS, partials,
             lambda: R.model_step_grads(start, blocks[:1], bnoise[:1], 0.25)),
            (K.FIT_MODEL_REDUCE, reduce,
             lambda: R.sgd_update(start[0], tuple(
                 g.float() for g in _half_slot_totals(route, total, f)[0]),
                 1e-2))):
        ms, plain = cuda_ms(kernel_call), cuda_ms(plain_call)
        b_ms, b_by = bounds[name]
        out[name] = (ms, plain, b_ms, b_by)
        print(f"kernel {name} [{n},{f}] over {mesh.desc} (data block 0: "
              f"{rows[0]} rows; {total} slots a half), the per-step route's "
              f"launch: device {ms * 1e3:.2f} us a launch (plain "
              f"{plain * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us by {b_by})")
    return out


# --------------------------------------------------------- main-path phase


def _counted(fn):
    """Run ``fn`` with the launch counters zeroed before and read after."""
    from clawker_tpu_torch.kernels import anomaly as K

    K.reset_launches()
    out = fn()
    return out, dict(K.LAUNCHES)


def fit_report(name: str, X, steps: int, device, reps: int = 5) -> None:
    """Prints the fit of the padded windows of X, as ``_fit_and_score``
    runs it (one K3 launch), and its noise draw (K4): the host's us to
    enqueue the fit and the fit's wall ms, medians over ``reps`` fits (the
    host clock stops once the launch is queued, and again after a
    synchronize); the enqueue's parts; K3's and the noise draw's device
    time by ``event_ms``, each beside its bound; K3's phase split.  Not
    counted: the caller runs it outside ``_counted``."""
    import torch

    from clawker_tpu_torch.analytics import runtime as art

    x = torch.from_numpy(art._pad_rows(X, X.shape[1])).to(device)
    enqueue, wall = [], []
    for _ in range(reps):
        params, noises = art._draw(0, steps, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art._fit(params, x, noises, 1e-2)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) * 1e6)
        wall.append((t2 - t0) * 1e3)
    params, noises = art._draw(0, steps, x)
    parts = enqueue_parts(params, x, noises)
    fit_ms = event_ms(lambda: art._fit(params, x, noises, 1e-2))
    split, sub = phase_split(params, x, noises)
    gen = torch.Generator(device=x.device).manual_seed(1)
    draw_ms = event_ms(lambda: torch.randn(noises.shape, device=x.device,
                                           generator=gen))
    n, f = x.shape
    bound, by = fit_bound(n, f, steps)
    nbound, _ = noise_bound(n, f, steps)
    print(f"main path {name}: fit enqueue "
          f"{statistics.median(enqueue):.2f} us per fit on the host, fit "
          f"wall {statistics.median(wall):.3f} ms (median of {reps}); K3 "
          f"device {fit_ms:.4f} ms per {steps}-step fit, "
          f"{fit_ms / steps * 1e3:.2f} us per step (bound {bound:.4f} ms by "
          f"{by}); noise draw (K4) device {draw_ms * 1e3:.2f} us (bound "
          f"{nbound * 1e3:.2f} us by bytes)")
    print(f"main path {name}: fit enqueue parts, median us: "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + " (the C call makes the device and occupancy queries on every "
            "launch)")
    print(f"main path {name}: K3 per step, mean us of the phase trace: "
          f"phase A {split[0]:.2f}, barrier {split[1]:.2f}, phase B "
          f"{split[2]:.2f}, barrier {split[3]:.2f}")
    print(f"main path {name}: K3 phase A's sub-stages, mean us per step "
          f"and block: "
          + ", ".join(f"{k} {v:.2f}" for k, v in zip(A_SUBSTAGES, sub))
          + f" (sum {sum(sub):.2f})")


# phase A's sub-stages in the order of the trace's points 1-6
A_SUBSTAGES = ("noise wait", "noisy x + weights wait", "forward", "dh/da",
               "weight sums", "slot")
# the same of K5b's one-launch fit (csrc/anomaly_fit_model.cu): of a
# block's last tile the noise, noisy x and the step's copy of both halves'
# weights, both halves' forwards, each half's backward; the two slots
MODEL_SUBSTAGES = ("noise wait", "noisy x + weights wait", "both forwards",
                   "half 0 backward", "half 1 backward", "two slots")


def enqueue_parts(params, x, noises, reps: int = 50) -> dict:
    """The parts of ``fit_``'s enqueue, median host us of each alone: the
    wrapper's checks, the scratch's allocation (``runtime._fit`` passes
    none), the stream's lookup, and the C call with its arguments made:
    the device and occupancy queries that size the launch, and the
    launch."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K

    n, f = x.shape
    losses = torch.empty(len(noises), device=x.device)
    scratch = torch.empty(K.scratch_floats(n, f), device=x.device)
    c_fit = K.kernel(K.FIT)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), noises.data_ptr(), 0.25,
            *(p.data_ptr() for p in params), scratch.data_ptr(),
            scratch.numel(), losses.data_ptr(), 1e-2, n, f, len(noises), 0,
            0, stream)

    def stream_lookup():
        with torch.cuda.device(x.device):
            return torch.cuda.current_stream().cuda_stream

    def c_call():
        check(c_fit(*args) == 0, "K3's C call failed")

    parts = {
        "checks": lambda: K._check_fit(params, x, noises, losses, None,
                                       None),
        "scratch alloc": lambda: torch.empty(K.scratch_floats(n, f),
                                             device=x.device),
        "stream lookup": stream_lookup,
        "C call": c_call,
    }
    times = {name: [] for name in parts}
    for _ in range(reps):            # the parts in turn, so drift hits all
        for name, fn in parts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {name: statistics.median(t) * 1e6 for name, t in times.items()}


def phase_split(params, x, noises) -> tuple[list[float], list[float]]:
    """One K3 fit with its phase trace on: -> the mean us per step of
    phase A (first block in to last block out), the first barrier (last
    block in to first block out), phase B and the second barrier; and of
    phase A's sub-stages (``A_SUBSTAGES``), each the mean over the steps
    and phase A's blocks of that block's time in it."""
    import torch

    from clawker_tpu_torch.kernels import anomaly as K

    steps = len(noises)
    n, f = x.shape
    ga = K.fit_slots(n)
    blocks = max(ga, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    stamps = torch.zeros((steps, K.FIT_STAMPS, blocks), dtype=torch.int64,
                         device=x.device)
    K.fit_(params, x, noises, lr=1e-2, sigma=0.25,
           losses_out=torch.empty(steps, device=x.device), stamps=stamps)
    return _split(stamps, ga)


def _split(stamps, ga: int) -> tuple[list[float], list[float]]:
    """A fit's trace [steps, FIT_STAMPS, blocks] -> ``phase_split``'s
    spans, and the sub-stages over the first ``ga`` blocks (phase A's)."""
    t = stamps.double().cpu()
    first, last = t.min(2).values, t.max(2).values
    spans = [last[:, 6] - first[:, 0], first[:, 7] - last[:, 6],
             last[:, 8] - first[:, 7], first[1:, 0] - last[:-1, 8]]
    sub = t[:, 1:7, :ga] - t[:, 0:6, :ga]
    return ([float(v.mean()) / 1e3 for v in spans],
            [float(v) / 1e3 for v in sub.mean(dim=(0, 2))])


def _cards_trace(stamps, ga: int) -> str:
    """A card's trace of the cards route [steps, CARDS_STAMPS, blocks] ->
    its mean us per step of phase A (first block in to last block out),
    the card's own barrier (last block out of phase A to the first at the
    barrier across cards), the wait across cards, phase B and the step's
    last barrier, and phase A's sub-stages over its first ``ga`` blocks."""
    t = stamps.double().cpu()
    first, last = t.min(2).values, t.max(2).values
    spans = [last[:, 6] - first[:, 0], first[:, 7] - last[:, 6],
             first[:, 8] - first[:, 7], last[:, 9] - first[:, 8],
             first[1:, 0] - last[:-1, 9]]
    sub = t[:, 1:7, :ga] - t[:, 0:6, :ga]
    a, own, across, b, end = (float(v.mean()) / 1e3 for v in spans)
    return (f"mean us of the phase trace: phase A {a:.2f}, the card's "
            f"barrier {own:.2f}, the wait across cards {across:.2f}, phase "
            f"B {b:.2f}, barrier {end:.2f}; phase A's sub-stages (each "
            f"block's last tile) " + ", ".join(
                f"{k} {float(v) / 1e3:.2f}" for k, v in
                zip(MODEL_SUBSTAGES, sub.mean(dim=(0, 2)))))


def _check_report(name: str, raw, z, n_windows: int) -> None:
    import numpy as np

    check(raw.shape == (n_windows,) and z.shape == (n_windows,),
          f"{name}: scores of shape {raw.shape}, want ({n_windows},)")
    check(bool(np.isfinite(raw).all() and np.isfinite(z).all()),
          f"{name}: non-finite scores")
    check(bool((raw >= 0).all()), f"{name}: negative squared error")


def fleet_blocks(cards: int) -> int:
    """The data blocks of the fleet mesh of ``cards`` cards: one K1 each
    a scored tick (model = 2 at an even count)."""
    return cards // 2 if cards % 2 == 0 else cards


def _check_fit_launches(name: str, counts: dict, cards: int = 1) -> None:
    """One fit is one K3 launch and no K2, K5 or K5b launch; one score one
    K1.  Over ``cards`` > 1 (the sentinel on a host with several cards,
    which scores over the fleet mesh): no K3 or K2, one K1 per data block,
    and at an even count K5b by the route ``model_route`` gives the fleet
    mesh's cards (the cards route: one ``anomaly_fit_model_cards`` launch
    a card and no per-step launch; the per-step route: ``cards`` forwards
    and partials per two reduces), at an odd one K5's per-step route
    (``cards`` partials per reduce); no one-launch fit of one card."""
    from clawker_tpu_torch.kernels import anomaly as K

    partials = counts[K.FIT_SHARD_PARTIALS]
    reduces = counts[K.FIT_SHARD_REDUCE]
    forwards = counts[K.FIT_MODEL_FORWARD]
    halves = counts[K.FIT_MODEL_PARTIALS]
    half_reduces = counts[K.FIT_MODEL_REDUCE]
    on_cards = counts[K.FIT_MODEL_CARDS]
    if cards > 1:
        if _cards_on_main_path():
            route = (partials == reduces == forwards == halves
                     == half_reduces == 0 and on_cards == cards)
        elif cards % 2 == 0:
            route = (partials == reduces == on_cards == 0 and half_reduces > 0
                     and forwards == halves == cards * half_reduces // 2)
        else:
            route = (forwards == halves == half_reduces == on_cards == 0
                     and reduces > 0 and partials == cards * reduces)
        check(counts[K.FIT] == counts[K.FIT_STEP] == counts[K.FIT_SHARD]
              == counts[K.FIT_MODEL] == 0 and route
              and counts[K.SCORE] == fleet_blocks(cards),
              f"{name}: launches {counts} over {cards} cards")
        return
    check(counts[K.FIT] == 1 and counts[K.FIT_STEP] == 0,
          f"{name}: {counts[K.FIT]} fit and {counts[K.FIT_STEP]} fit-step "
          f"launches, want 1 and 0")
    k5 = (partials, reduces, counts[K.FIT_SHARD], forwards, halves,
          half_reduces, counts[K.FIT_MODEL], on_cards)
    check(not any(k5), f"{name}: K5 and K5b launches {k5}, want none")
    check(counts[K.SCORE] == 1,
          f"{name}: {counts[K.SCORE]} score launches, want 1")


def _cards_on_main_path() -> bool:
    """Whether the sentinel's fleet mesh takes K5b's cards route: several
    visible cards at an even count (model = 2), peer access between every
    pair."""
    import torch

    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.kernels import anomaly as K

    cards = torch.cuda.device_count()
    return (cards > 1 and cards % 2 == 0
            and K.model_route(M.fleet_mesh().devices) == K.ROUTE_CARDS)


def main_path_phase(device) -> dict:
    """Drives the port's entry points; -> launches summed over the runs."""
    import torch

    from clawker_tpu_torch.analytics import features as F
    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.analytics import runtime as art
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.sentinel import ScoringEngine, featurize_fused

    total = {name: 0 for name in K.LAUNCHES}
    step_us = {}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    fleets = {
        "bench fleet 8x64x40": synth_egress_records(),
        "hour of 64 agents 64x64x24": synth_egress_records(
            agents=64, windows=64, per_window=24),
    }
    unsharded = {}
    for name, records in fleets.items():
        keys, X = F.featurize(records)
        rep, counts = _counted(lambda: art.score_windows(
            X, keys, train_steps=FIT_STEPS, device=device))
        _check_report(name, rep.raw, rep.z, len(keys))
        _check_fit_launches(name, counts)
        add(counts)
        unsharded[name] = (X, rep.raw)
        # steady-state score step on the fitted params (not counted)
        _, params, x, _ = art._fit_and_score(
            X, train_steps=FIT_STEPS, lr=1e-2, seed=0, device=device)
        us = host_us(lambda: K.score(params, x), reps=100)
        step_us[name] = us
        print(f"main path {name}: windows {len(keys)} padded "
              f"{tuple(x.shape)}, fit {FIT_STEPS} steps train_ms "
              f"{rep.train_ms:.2f}, score {rep.score_ms:.3f} ms, "
              f"score step {us:.2f} us, launches {json.dumps(counts)}, "
              f"device {rep.device}")
        fit_report(name, X, FIT_STEPS, device)

    # the sentinel's 64-agent fused tick
    recs = synth_egress_records(agents=64, windows=4, per_window=16)
    for i, r in enumerate(recs):
        r["worker"] = f"fake-{i % 4}"
    keys, X, worker_of = featurize_fused(recs, None)
    eng = ScoringEngine(train_steps=40, device=device)
    ticks = []
    for _ in range(3):
        t0 = time.perf_counter()
        rep, counts = _counted(lambda: eng.score_tick(keys, X, worker_of))
        ticks.append((time.perf_counter() - t0) * 1e3)
        _check_report("sentinel tick", rep.raw, rep.z, len(keys))
        _check_fit_launches("sentinel tick", counts,
                            torch.cuda.device_count())
        add(counts)
    print(f"main path sentinel tick [{len(keys)},{X.shape[1]}]: "
          f"{eng.train_steps} steps, train_ms {rep.train_ms:.2f}, score "
          f"{rep.score_ms:.3f} ms, tick ms {[round(t, 2) for t in ticks]}, "
          f"device {rep.device}")
    fit_report("sentinel tick", X, eng.train_steps, device)

    # a seeded exfil burst must score hottest
    recs = synth_egress_records() + exfil_burst("clawker.loop-3", window=63)
    keys, X = F.featurize(recs)
    rep, counts = _counted(lambda: art.score_windows(
        X, keys, train_steps=FIT_STEPS, device=device))
    _check_fit_launches("exfil", counts)
    add(counts)
    hottest = max(rep.agents, key=lambda a: a.peak)
    check(hottest.agent == "clawker.loop-3",
          f"exfil agent not hottest: {hottest.agent} peak {hottest.peak:.2f}")
    print(f"main path exfil: clawker.loop-3 hottest, peak z "
          f"{hottest.peak:.2f}, train_ms {rep.train_ms:.2f}")

    # the sharded path: the hour's fit and score over the 2x2 mesh of
    # MAIN_PATH_SHARDS shards of the card (the hidden dimension split: one
    # K5b launch, a K1 per data block), and over ODD_MESH_SHARDS shards
    # (3x1, the rows over every shard: one K5 launch, a K1 per shard)
    name = "hour of 64 agents 64x64x24"
    X, raw = unsharded[name]
    for shards, fit_name in ((MAIN_PATH_SHARDS, K.FIT_MODEL),
                             (ODD_MESH_SHARDS, K.FIT_SHARD)):
        mesh = M.virtual_mesh(shards, device)
        (got, _, x, t), counts = _counted(lambda: art._fit_and_score(
            X, train_steps=FIT_STEPS, lr=1e-2, seed=0, mesh=mesh))
        tag = f"{name} sharded {mesh.desc}"
        _check_report(tag, got, art._robust_z(got), len(X))
        want = dict.fromkeys(K.LAUNCHES, 0)
        want.update({K.SCORE: mesh.data, fit_name: 1})
        check(counts == want, f"{tag}: launches {counts}, want {want}")
        check(t["device"].startswith("cuda") and t["device"].endswith(
            f"mesh={mesh.desc}"), f"{tag}: device {t['device']!r}")
        got_t, raw_t = torch.from_numpy(got), torch.from_numpy(raw)
        ok, err = _close(got_t, raw_t, rtol=MESH_SCORE_RTOL,
                         atol=MESH_SCORE_ATOL)
        check(ok, f"{tag}: scores off the unsharded ones by {err:.3g}")
        add(counts)
        print(f"main path {tag}: padded {tuple(x.shape)}, fit "
              f"{FIT_STEPS} steps train_ms {t['train_ms']:.2f}, score "
              f"{t['score_ms']:.3f} ms, launches {json.dumps(counts)}, "
              f"device {t['device']}; scores off the unsharded run's by "
              f"{_rel(got_t, raw_t):.3g} relative")
    print(f"main path launches: {json.dumps(total)}")
    return {"launches": total, "step_us": step_us}


# --------------------------------------------------------- sentinel phase


class _Cfg:
    def __init__(self, logs_dir: Path):
        self.logs_dir = logs_dir


def _timed(stages: dict, name: str, fn):
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            stages[name] = (time.perf_counter() - t0) * 1e3
    return run


@contextlib.contextmanager
def stage_timers(stages: dict):
    """While open, the featurizer the sentinel calls and the runtime's
    fit-and-score write their host ms into ``stages``."""
    from clawker_tpu_torch.analytics import runtime as art

    sent = importlib.import_module("clawker_tpu_torch.sentinel.sentinel")
    saved = [(sent, "featurize_fused"), (art, "_fit_and_score")]
    originals = [getattr(mod, name) for mod, name in saved]
    for (mod, name), fn in zip(saved, originals):
        setattr(mod, name, _timed(stages, name, fn))
    try:
        yield stages
    finally:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)


class TickLog:
    """Every tick of one ``FleetSentinel``, whoever calls it (the caller,
    or the ticking thread, which calls ``refresh_once`` through the
    instance too), run through ``_counted``: -> ``ticks``, each (windows
    scored, launches, host ms of the tick and of its stages, the
    TickReport or None).  The sentinel's ``on_error`` messages land in
    ``errors``.  Ticks run one at a time: ``_counted`` zeroes the
    process-wide launch counters, so two ticks at once (the ticking
    thread and a caller's ``refresh_once``, as the chaos observe-only
    twin makes them) would zero each other's counts."""

    _serial = threading.Lock()

    def __init__(self, sentinel, stages: dict):
        self.sentinel = sentinel
        self.ticks: list[tuple] = []
        self.errors: list[str] = []
        sentinel.on_error = self.errors.append
        col, eng = sentinel.collector, sentinel.engine
        col.poll = _timed(stages, "poll", col.poll)
        col.records = _timed(stages, "records", col.records)
        eng.score_tick = _timed(stages, "score_tick", eng.score_tick)
        tick = sentinel.refresh_once

        def refresh_once() -> int:
            with TickLog._serial:
                stages.clear()
                t0 = time.perf_counter()
                n, counts = _counted(tick)
                ms = dict(stages, wall=(time.perf_counter() - t0) * 1e3)
                self.ticks.append((n, counts, ms, sentinel.last_tick if n
                                   else None))
            return n

        sentinel.refresh_once = refresh_once

    def check(self, name: str, entry, *, scored: bool) -> None:
        """A scored tick is one K3 and one K1 launch on the CUDA device;
        an idle one launches nothing; no tick reports an error."""
        n, counts, _, rep = entry
        check(not self.errors and not self.sentinel.last_error,
              f"{name}: the sentinel reported {self.errors or [self.sentinel.last_error]}")
        if scored:
            import torch

            check(n > 0, f"{name}: a tick that should score scored nothing")
            _check_fit_launches(name, counts, torch.cuda.device_count())
            check(rep.device.startswith("cuda"),
                  f"{name}: scored on {rep.device!r}")
        else:
            check(n == 0 and not any(counts.values()),
                  f"{name}: an idle tick scored {n} windows with launches "
                  f"{counts}")

    def check_run(self, name: str) -> list:
        """Every tick held, and the run's launches: one K3 and one K1 a
        scored tick on one card, K5b (K5 at an odd count) and a K1 a data
        block over several; -> the scored ticks."""
        import torch

        scored = [entry for entry in self.ticks if entry[0]]
        check(scored, f"{name}: the sentinel scored no tick")
        for entry in self.ticks:
            self.check(name, entry, scored=bool(entry[0]))
        cards = torch.cuda.device_count()
        launches = self.launches()
        fits = launches["anomaly_fit"] if cards == 1 else sum(
            1 for entry in scored if entry[1]["anomaly_fit_shard_reduce"]
            or entry[1]["anomaly_fit_model_reduce"])
        check(fits == len(scored)
              and launches["anomaly_score"] == fleet_blocks(cards) * len(
                  scored),
              f"{name}: launches {dict(launches)} over {len(scored)} scored "
              f"ticks on {cards} card(s)")
        return scored

    def tick(self, name: str, *, scored: bool) -> int:
        self.sentinel.refresh_once()
        self.check(name, self.ticks[-1], scored=scored)
        return self.ticks[-1][0]

    def launches(self) -> collections.Counter:
        total = collections.Counter()
        for _, counts, _, _ in self.ticks:
            total.update(counts)
        return total

    def stage_line(self) -> str:
        """Median host ms of each stage over the scored ticks."""
        rows = [(ms, rep) for n, _, ms, rep in self.ticks if n]
        parts = {
            "refresh_once": [ms["wall"] for ms, _ in rows],
            "collector.poll": [ms["poll"] for ms, _ in rows],
            "collector.records": [ms["records"] for ms, _ in rows],
            "featurize_fused": [ms["featurize_fused"] for ms, _ in rows],
            "score_tick": [ms["score_tick"] for ms, _ in rows],
            "_fit_and_score": [ms["_fit_and_score"] for ms, _ in rows],
            "train_ms": [rep.train_ms for _, rep in rows],
            "score_ms": [rep.score_ms for _, rep in rows],
            "score_tick rest (worker z, host copies, fold)": [
                ms["score_tick"] - ms["_fit_and_score"] for ms, _ in rows],
            "emit + _save_state rest": [
                ms["wall"] - ms["poll"] - ms["records"]
                - ms["featurize_fused"] - ms["score_tick"]
                for ms, _ in rows],
        }
        return (f"median host ms over {len(rows)} scored ticks: "
                + ", ".join(f"{k} {statistics.median(v)!r}"
                            for k, v in parts.items()))


def _write_workers(out: Path, records: list[dict], workers: int) -> list[Path]:
    """Records tagged ``fake-{i % workers}``, one file per worker."""
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    paths = [out / f"fake-{w}.jsonl" for w in range(workers)]
    files = [open(p, "w") for p in paths]
    try:
        for i, r in enumerate(records):
            r["worker"] = f"fake-{i % workers}"
            files[i % workers].write(json.dumps(r) + "\n")
    finally:
        for f in files:
            f.close()
    return paths


def _append(path: Path, records: list[dict]) -> None:
    with open(path, "a") as f:
        f.write("".join(json.dumps(r) + "\n" for r in records))


def _sentinel(out: Path, paths: list[Path], device, stages: dict, **kw):
    from clawker_tpu_torch.sentinel import FleetSentinel, StreamCollector

    col = StreamCollector()
    for w, p in enumerate(paths):
        col.add_local(f"fake-{w}", p)
    s = FleetSentinel(_Cfg(out), train_steps=SENTINEL_STEPS, collector=col,
                      device=device, **kw)
    return s, TickLog(s, stages)


def fused_tick_case(out: Path, device, stages: dict) -> collections.Counter:
    """(a): the 64-agent fused tick, an idle tick, a seeded exfil flagged
    within two ticks, the bus event, the registry, the state file."""
    from clawker_tpu_torch import telemetry
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG, AnomalyFlagEvent, EventBus
    from clawker_tpu_torch.sentinel import FleetSentinel, featurize_fused, state_path

    recs = synth_egress_records(agents=64, windows=4, per_window=16)
    paths = _write_workers(out, recs, 4)
    windows = len(featurize_fused(recs, None)[0])
    s, log = _sentinel(out, paths, device, stages, run_id="chip-smoke",
                       interval_s=999)
    bus_records = []
    bus = EventBus()
    bus.add_tap(bus_records.append)
    s.bind_run(events=bus)
    name = "sentinel (a)"
    n = log.tick(name, scored=True)
    check(n == windows, f"{name}: first tick scored {n} of {windows} windows")
    log.tick(name, scored=False)
    hot, worker = "clawker.loop-hot", "fake-1"
    _append(paths[1], exfil_burst(hot, window=3))
    for tick in (1, 2):
        log.tick(name, scored=True)
        flag = next((f for f in s.flags() if f["agent"] == hot), None)
        if flag is not None:
            break
    check(flag is not None, f"{name}: {hot} not flagged within two ticks")
    check(flag["worker"] == worker and flag["kind"] == "egress",
          f"{name}: flag {flag}, want worker {worker} kind egress")
    ev = next((r for r in bus_records if r.event == ANOMALY_FLAG
               and r.agent == hot), None)
    check(ev is not None, f"{name}: no {ANOMALY_FLAG} event on the bus")
    parsed = AnomalyFlagEvent.parse(ev.agent, ev.detail)
    check((parsed.agent, parsed.worker, parsed.kind) == (hot, worker,
                                                         "egress")
          and parsed.z >= s.engine.threshold,
          f"{name}: bus event {parsed}")
    text = telemetry.REGISTRY.exposition()
    check("anomaly_flags_total" in text
          and f'anomaly_score{{agent="{hot}"}}' in text,
          f"{name}: the flag metrics are not in the registry")
    for k in range(3):      # more scored ticks for the stage medians
        _append(paths[0], benign_window(f"clawker.loop-{k}", 5 + k, 16))
        log.tick(name, scored=True)
    s.stop()
    check(state_path(out, "chip-smoke").exists(), f"{name}: no state file")
    resumed = FleetSentinel(_Cfg(out), run_id="chip-smoke", device=device)
    check(resumed.engine.baseline_depth() == s.engine.baseline_depth() > 0
          and resumed.ticks == s.ticks,
          f"{name}: resumed depth {resumed.engine.baseline_depth()} ticks "
          f"{resumed.ticks}, want {s.engine.baseline_depth()} and {s.ticks}")
    check(not any(s.audit().values()), f"{name}: audit {s.audit()}")
    padded = -(-windows // 128) * 128
    print(f"sentinel (a) 64-agent fused tick [{padded},40] x"
          f"{SENTINEL_STEPS}, {len(recs)} records over 4 workers: "
          f"{windows} windows, {hot} flagged at tick {tick} after the burst "
          f"(z {flag['z']}, worker {flag['worker']}, kind {flag['kind']}), "
          f"{len(log.ticks)} ticks, state reloaded with "
          f"{resumed.engine.baseline_depth()} baseline samples")
    print(f"sentinel (a): {log.stage_line()}")
    return log.launches()


def full_buffer_case(out: Path, device, stages: dict) -> collections.Counter:
    """(b): a collector buffer near its bound (98,304 of 100,000
    records): what a long-running sentinel re-featurizes on every tick
    that has news."""
    recs = synth_egress_records(agents=64, windows=64, per_window=24)
    paths = _write_workers(out, recs, 4)
    s, log = _sentinel(out, paths, device, stages, interval_s=999)
    name = "sentinel (b)"
    counts = [log.tick(name, scored=True)]
    for k in range(2):      # one new window between ticks: none is idle
        _append(paths[k], benign_window(f"clawker.loop-{k}", 66 + k, 24))
        counts.append(log.tick(name, scored=True))
    held = len(s.collector.records())
    check(held == s.collector.total() == len(recs) + 48,
          f"{name}: the buffer holds {held} of {s.collector.total()} "
          f"records collected")
    check(counts[1:] == [counts[0] + 1, counts[0] + 2],
          f"{name}: windows per tick {counts}")
    s.stop()
    print(f"sentinel (b) full buffer: {held} records over 4 workers, "
          f"windows per tick {counts}, padded "
          f"[{-(-counts[-1] // 128) * 128},40] x{SENTINEL_STEPS}; "
          f"the first tick's collector.poll {log.ticks[0][2]['poll']!r} ms")
    print(f"sentinel (b): {log.stage_line()}")
    return log.launches()


def flag_latency_case(out: Path, device, stages: dict) -> collections.Counter:
    """(c): the reference bench's scenario: 8 agents x 6 windows x 16
    records over 2 workers, ticking every 0.05 s on the sentinel's
    thread after two warm ticks; a 60-record deny storm is appended to
    fake-1, and the time to its ``anomaly.flag`` on the bus is taken."""
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG, EventBus

    total = collections.Counter()
    lat = []
    hot = "clawker.hot"
    for rep in range(FLAG_REPS):
        d = out / f"rep{rep}"
        paths = _write_workers(d, synth_egress_records(
            agents=8, windows=6, per_window=16), 2)
        flags = {}
        bus = EventBus(lambda agent, ev, detail:
                       flags.setdefault(agent, time.perf_counter())
                       if ev == ANOMALY_FLAG else None)
        s, log = _sentinel(d, paths, device, stages, interval_s=0.05,
                           window_s=60)
        s.bind_run(events=bus)
        name = f"sentinel (c) rep {rep}"
        log.tick(name, scored=True)
        log.tick(name, scored=False)
        s.start()
        storm = exfil_burst(hot, window=2, n=60)
        for r in storm:
            r["worker"] = "fake-1"
        t0 = time.perf_counter()
        _append(paths[1], storm)
        deadline = t0 + FLAG_DEADLINE_S
        while hot not in flags and time.perf_counter() < deadline:
            time.sleep(0.005)
        s.stop()
        bus.close()
        check(not s._thread.is_alive(), f"{name}: the ticking thread lives")
        check(hot in flags,
              f"{name}: no flag within {FLAG_DEADLINE_S} s")
        for entry in log.ticks:
            log.check(name, entry, scored=bool(entry[0]))
        lat.append(flags[hot] - t0)
        total.update(log.launches())
    lat.sort()
    print(f"sentinel (c) flag latency, s, over {FLAG_REPS} reps: p50 "
          f"{lat[len(lat) // 2]!r}, max {lat[-1]!r} (all {lat!r})")
    return total


def sentinel_phase(device) -> collections.Counter:
    """Drives the live sentinel; -> launches summed over its ticks."""
    out = ROOT / "build" / "chip_smoke" / "sentinel"
    total = collections.Counter()
    with stage_timers({}) as stages:
        for case, sub in ((fused_tick_case, "a"), (full_buffer_case, "b"),
                          (flag_latency_case, "c")):
            total.update(case(out / sub, device, stages))
    print(f"sentinel launches: {json.dumps(total)}")
    return total


def cli_phase(device: str) -> None:
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "egress.jsonl"
    recs = synth_egress_records() + exfil_burst("clawker.loop-3", window=63)
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    env = dict(os.environ, CLAWKER_TORCH_DEVICE=device)
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch", "monitor", "anomalies",
         "--input", str(path), "--format", "json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    check(device in doc["device"], f"CLI scored on {doc['device']!r}")
    check(doc["agents"][0]["agent"] == "clawker.loop-3",
          f"CLI hottest agent {doc['agents'][0]['agent']}")
    print(f"cli: exit 0, {doc['windows']} windows on {doc['device']}, "
          f"fit {doc['train_ms']} ms, hottest {doc['agents'][0]['agent']}")


def fleet_cli_phase(device: str) -> None:
    """``fleet anomaly`` on two workers' streams, one of which holds a
    hot agent: exit 2, the agent flagged with kind egress, rows from
    both workers."""
    out = ROOT / "build" / "chip_smoke" / "sentinel" / "cli"
    paths = _write_workers(out, synth_egress_records(
        agents=8, windows=6, per_window=16), 2)
    hot = "clawker.hot"
    _append(paths[1], exfil_burst(hot, window=2, n=60))
    # the verb tails the configured driver's workers too: the fake's one
    # worker, whose streams under the state dir are empty
    env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
               CLAWKER_TPU_STATE_DIR=str(out / "state"),
               CLAWKER_TPU_DRIVER="fake")
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch", "fleet", "anomaly",
         "--no-daemon", "--format", "json",
         "--stream", f"fake-0={paths[0]}", "--stream", f"fake-1={paths[1]}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 2,
          f"fleet anomaly exited {proc.returncode}, want 2: "
          f"{proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    flags = {(f["agent"], f["kind"]) for f in doc["flags"]}
    workers = {r["worker"] for r in doc["rows"]}
    check((hot, "egress") in flags, f"fleet anomaly flags {flags}")
    check({"fake-0", "fake-1"} <= workers, f"fleet anomaly rows on {workers}")
    print(f"cli fleet anomaly: exit 2, {len(doc['rows'])} agents on "
          f"{sorted(workers)}, flags {sorted(flags)}")


# ------------------------------------------------------------- loop phase


LOOP_PROJECT = "chipsmoke"
LOOP_IMAGE = f"clawker-{LOOP_PROJECT}:default"
LOOP_WORKERS, LOOP_AGENTS, LOOP_ITERATIONS = 4, 8, 3
LOOP_ITER_S = 0.2           # each fake iteration holds its container this
#                             long, so sentinel ticks land mid-run
LOOP_TICK_S = 0.05
LOOP_CLI_TICK_S = 0.001     # the CLI's seeded fake exits at once, so its
#                             run lasts ~0.05 s: its sentinel must tick
#                             at once to score inside it
LOOP_WINDOWS, LOOP_PER_WINDOW = 6, 12
LOOP_HOT_SLOT = 5
LIVE_RUN_MARGIN_S = 8.0     # what an in-process live run needs of its
FORKED_RUN_MARGIN_S = 20.0  # minute (``_clear_of_minute_end``), and a
#                             forked one with its interpreter's start
_XDG = ("CONFIG", "DATA", "STATE", "CACHE")
_ISOLATED: list[Path] = []      # every state dir the loop phases used


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _isolated_dirs(base: Path, settings: str = "", *, proxy: bool = True):
    """Fresh XDG dirs under ``base`` (``CLAWKER_TPU_*_DIR``), default
    settings but for ``settings`` and the host proxy's port (a free one:
    each run's bootstrap starts its own ``clawker_tpu_torch.hostproxy``,
    stopped on the way out; with ``proxy`` false, the proxy off), and a
    project dir; -> the project dir."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.hostproxy import manager

    if base.exists():
        shutil.rmtree(base)
    saved = {}
    for name in _XDG:
        (base / name.lower()).mkdir(parents=True)
        key = f"CLAWKER_TPU_{name}_DIR"
        saved[key] = os.environ.get(key)
        os.environ[key] = str(base / name.lower())
    _ISOLATED.append(base / "state")
    (base / "config" / "settings.yaml").write_text(
        (f"host_proxy:\n  port: {_free_port()}\n" if proxy
         else "host_proxy:\n  enable: false\n") + settings)
    proj = base / "proj"
    proj.mkdir()
    (proj / ".clawker.yaml").write_text(f"project: {LOOP_PROJECT}\n")
    try:
        yield proj
    finally:
        manager.stop(load_config(proj))
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


def _clear_of_minute_end(need_s: float) -> None:
    """Sleep into the next wall-clock minute when fewer than ``need_s``
    seconds are left in this one.  A live run's egress lies in the
    current minute (``_loop_egress``); a run that crosses into the next
    opens a window of bus events only for every agent, and that window's
    z becomes each status row's ``anomaly_z``."""
    left = 60 - time.time() % 60
    if left < need_s:
        time.sleep(left + 0.2)


def _loop_egress(agents: list[str], hot: str, now: float,
                 workers: list[str] | None = None) -> dict[str, list[dict]]:
    """Worker id -> its loops' egress (spread: agent i on worker
    i % len(workers), by default fake-0..fake-3) over the minutes up to
    ``now``'s, with an exfil burst on ``hot`` in the last one when it is
    one of ``agents``: live records, which the sentinel fuses with the
    run's events of the same minute.  Records name containers, as the
    netlogger does."""
    workers = workers or [f"fake-{w}" for w in range(LOOP_WORKERS)]
    base = int(now) - int(now) % 60 - (LOOP_WINDOWS - 1) * 60
    out = {wid: [] for wid in workers}
    for a, agent in enumerate(agents):
        wid = workers[a % len(workers)]
        container = f"clawker.{LOOP_PROJECT}.{agent}"
        for w in range(LOOP_WINDOWS):
            out[wid] += benign_window(container, w, LOOP_PER_WINDOW, base)
    if hot in agents:
        wid = workers[agents.index(hot) % len(workers)]
        out[wid] += exfil_burst(f"clawker.{LOOP_PROJECT}.{hot}",
                                window=LOOP_WINDOWS - 1, base=base)
    for wid, recs in out.items():
        for r in recs:
            r["worker"] = wid
    return out


def _loop_run(proj: Path, attach, *, writer, pod=None):
    """One in-process run of the port's scheduler over the fake driver:
    ``attach(sched, cfg, driver)`` wires the rider (and returns it, not
    yet started); ``writer(cfg, agents)`` appends the fleet's egress on
    a thread while the loops run; ``pod(cfg, driver)`` -> an executor
    set puts the launches on workerd.  -> (scheduler, rider, agent
    names, run wall ms)."""
    import threading

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec

    cfg = load_config(proj)
    drv = FakeDriver(n_workers=LOOP_WORKERS)
    for api in drv.apis:
        api.add_image(LOOP_IMAGE)
        api.set_behavior(LOOP_IMAGE, exit_behavior(
            b"iteration done\n", 0, delay=LOOP_ITER_S))
    sched = LoopScheduler(cfg, drv, LoopSpec(parallel=LOOP_AGENTS,
                                             iterations=LOOP_ITERATIONS),
                          executors=pod(cfg, drv) if pod else None)
    rider = attach(sched, cfg, drv)
    agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
    fill = threading.Thread(target=writer, args=(cfg, agents),
                            name="loop-egress-writer")
    t0 = time.perf_counter()
    rider.start()
    sched.start()
    fill.start()
    try:
        sched.run(poll_s=0.05)
    finally:
        fill.join(30)
    wall = (time.perf_counter() - t0) * 1e3
    return sched, rider, agents, wall


def _check_loop_rows(name: str, rows: list[dict]) -> None:
    check(len(rows) == LOOP_AGENTS
          and all(r["status"] == "done" and r["iteration"] == LOOP_ITERATIONS
                  and r["exit_codes"] == [0] * LOOP_ITERATIONS
                  for r in rows), f"{name}: final rows {rows}")
    check(all("anomaly_z" in r for r in rows),
          f"{name}: rows without anomaly_z: {rows}")


def loop_sentinel_case(base: Path, device, stages: dict):
    """(a): 8 loops x 3 iterations over 4 fake workers with the live
    sentinel on its ticking thread; the workers' streams fill mid-run."""
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG
    from clawker_tpu_torch.sentinel import FleetSentinel

    name = "loop (a)"
    bus_records = []
    box = {}

    def attach(sched, cfg, drv):
        s = FleetSentinel(cfg, drv, run_id=sched.loop_id, device=device,
                          interval_s=LOOP_TICK_S,
                          train_steps=SENTINEL_STEPS)
        box["log"] = TickLog(s, stages)
        sched.attach_sentinel(s)
        sched.events.add_tap(bus_records.append)
        return s

    def writer(cfg, agents):
        streams = _loop_egress(agents, agents[LOOP_HOT_SLOT], time.time())
        for wid, recs in streams.items():
            _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)

    with _isolated_dirs(base) as proj:
        sched, s, agents, wall = _loop_run(proj, attach, writer=writer)
        log = box["log"]
        # a scored tick must have seen every record the writer appended
        want = sum(len(v) for v in _loop_egress(agents, agents[0],
                                                0).values())
        deadline = time.perf_counter() + 10
        while s._scored_at[0] < want and time.perf_counter() < deadline:
            time.sleep(LOOP_TICK_S)
        s.stop()
        sched.events.flush()
        rows = sched.status()
        peaks = {r["agent"]: r["peak_z"] for r in s.rows()}
        snapshot = s.behavior.snapshot()
        audit = s.audit()
        flags = s.flags()
        sched.cleanup(remove_containers=True)
    hot = agents[LOOP_HOT_SLOT]
    scored = log.check_run(name)
    _check_loop_rows(name, rows)
    container = f"clawker.{LOOP_PROJECT}.{hot}"
    check(max(peaks, key=peaks.get) == container,
          f"{name}: hottest {max(peaks, key=peaks.get)} (peak z {peaks}), "
          f"want {container}")
    check(any(r.event == ANOMALY_FLAG and r.agent == container
              for r in bus_records),
          f"{name}: no {ANOMALY_FLAG} for {container} on the run's bus "
          f"(flags {flags})")
    check(set(snapshot) == set(agents),
          f"{name}: behaviour snapshot holds {sorted(snapshot)}")
    check(not any(audit.values()), f"{name}: audit {audit}")
    print(f"loop (a) {LOOP_AGENTS} loops x {LOOP_ITERATIONS} iterations over "
          f"{LOOP_WORKERS} fake workers ({LOOP_ITER_S} s each) with the "
          f"sentinel ticking every {LOOP_TICK_S} s: run wall {wall!r} ms, "
          f"{len(log.ticks)} ticks, {len(scored)} scored (the last over "
          f"{scored[-1][3].windows} windows, [{-(-scored[-1][3].windows // 128) * 128},40] "
          f"x{SENTINEL_STEPS}), {hot} hottest "
          f"(peak z {peaks[container]}), flags "
          f"{sorted((f['agent'], f['kind']) for f in flags)}")
    print(f"loop (a): {log.stage_line()}")
    return log.launches()


def loop_watch_case(base: Path, device):
    """(b): the same run with the egress AnomalyWatch (F = 32) on the
    shared stream in place of the sentinel."""
    from clawker_tpu_torch.analytics.runtime import AnomalyWatch

    name = "loop (b)"
    refreshes = []
    errors = []

    def attach(sched, cfg, drv):
        w = AnomalyWatch(cfg.logs_dir / "ebpf-egress.jsonl", device=device,
                         interval_s=LOOP_TICK_S)
        sched.attach_anomaly_watch(w)
        w.on_error = errors.append
        refresh = w.refresh_once

        def counted() -> int:
            n, counts = _counted(refresh)
            refreshes.append((n, counts))
            return n

        w.refresh_once = counted
        return w

    def writer(cfg, agents):
        streams = _loop_egress(agents, agents[LOOP_HOT_SLOT], time.time())
        _append(cfg.logs_dir / "ebpf-egress.jsonl",
                [r for recs in streams.values() for r in recs])

    with _isolated_dirs(base) as proj:
        sched, w, agents, wall = _loop_run(proj, attach, writer=writer)
        w.stop()
        rows = sched.status()
        sched.cleanup(remove_containers=True)
    check(not errors, f"{name}: the watch reported {errors}")
    scored = [counts for n, counts in refreshes if n]
    check(scored, f"{name}: the watch scored nothing during the run")
    for n, counts in refreshes:
        if n:
            _check_fit_launches(name, counts)
        else:
            check(not any(counts.values()),
                  f"{name}: an empty refresh launched {counts}")
    _check_loop_rows(name, rows)
    launches = collections.Counter()
    for counts in scored:
        launches.update(counts)
    print(f"loop (b) the same run with AnomalyWatch every {LOOP_TICK_S} s: "
          f"run wall {wall!r} ms, {len(refreshes)} refreshes, "
          f"{len(scored)} scored; launches {json.dumps(launches)}")
    return launches


def loop_cli_case(base: Path, device: str) -> None:
    """(c): ``python -m clawker_tpu_torch loop -p 4 -n 2 --sentinel
    --json`` on the fake driver, in a subprocess, with the sentinel
    ticking every ``LOOP_CLI_TICK_S`` over egress written beforehand into its
    one worker's stream: the run must end with a ``sentinel.tick`` span
    scored on the card in its flight record and no rider error."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.monitor.ledger import flight_path
    from clawker_tpu_torch.telemetry import SPAN_SENTINEL_TICK, load_spans

    name = "loop (c)"
    # the check reads the run's flight record, which the soft disk
    # watermark (10% free by default) sheds on a nearly full disk
    settings = (f"sentinel:\n  interval_s: {LOOP_CLI_TICK_S}\n"
                + "loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
                + "    hard_free_pct: 0.0005\n")
    with _isolated_dirs(base, settings) as proj:
        logs = load_config(proj).logs_dir
        logs.mkdir(parents=True, exist_ok=True)
        agents = [f"cli-{i}" for i in range(LOOP_WINDOWS)]
        records = [r for recs in _loop_egress(agents, agents[-1],
                                              time.time()).values()
                   for r in recs]
        for r in records:
            r["worker"] = "fake-0"
        _append(logs / "ebpf-egress-fake-0.jsonl", records)
        env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
                   CLAWKER_TPU_DRIVER="fake",
                   CLAWKER_TPU_FAKE_IMAGES=LOOP_IMAGE,
                   PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "clawker_tpu_torch", "loop", "-p", "4",
             "-n", "2", "--sentinel", "--json"],
            cwd=proj, env=env, capture_output=True, text=True, timeout=300)
        wall = (time.perf_counter() - t0) * 1e3
        check(proc.returncode == 0,
              f"{name}: exited {proc.returncode}: {proc.stderr[-2000:]}")
        for bad in ("anomaly_watch_error", "no CUDA GPU"):
            check(bad not in proc.stderr,
                  f"{name}: the rider failed: {proc.stderr[-2000:]}")
        doc = json.loads(proc.stdout)
        spans = load_spans(flight_path(logs, doc["loop_id"]).read_text()
                           .splitlines())
    ticks = [sp for sp in spans if sp.name == SPAN_SENTINEL_TICK]
    iters = [sp for sp in spans if sp.name == "iteration"]
    check(len(doc["agents"]) == 4
          and all(a["status"] == "done" and a["iteration"] == 2
                  for a in doc["agents"]), f"{name}: agents {doc['agents']}")
    check(ticks and all(sp.attrs["device"].startswith(device)
                        for sp in ticks),
          f"{name}: scored ticks in the flight record: "
          f"{[sp.attrs for sp in ticks]} among "
          f"{collections.Counter(sp.name for sp in spans)}; stderr "
          f"{proc.stderr[-2000:]}")
    t0 = min(sp.t_start for sp in iters)
    print(f"loop (c) cli: exit 0, {len(doc['agents'])} agents done, "
          f"iterations from 0 to {max(sp.t_end for sp in iters) - t0!r} s; "
          f"{len(ticks)} sentinel ticks scored on "
          f"{ticks[0].attrs['device']}, the first from "
          f"{ticks[0].t_start - t0!r} to {ticks[0].t_end - t0!r} s over "
          f"{ticks[0].attrs['windows']} windows; durability "
          f"{doc['storage']['durability']}, subprocess wall {wall!r} ms")


def loop_phase(device) -> collections.Counter:
    """Drives the port's ``loop`` with its two riders; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "loop"
    total = collections.Counter()
    t0 = time.perf_counter()
    with stage_timers({}) as stages:
        total.update(loop_sentinel_case(out / "a", device, stages))
    total.update(loop_watch_case(out / "b", device))
    loop_cli_case(out / "c", device)
    print(f"loop launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# ------------------------------------------------------------ loopd phase


LOOPD_SETTINGS = (f"sentinel:\n  enable: true\n  interval_s: {LOOP_TICK_S}\n"
                  f"  train_steps: {SENTINEL_STEPS}\n"
                  # the daemon brings up the card before it answers
                  "loopd:\n  start_deadline_s: 120\n"
                  # the flight records keep every span on a full disk
                  "loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
                  "    hard_free_pct: 0.0005\n")


def _loopd_client_run(sock: Path, out: dict, tag: str, acked) -> None:
    """One client of the in-process daemon: submit a run of loop (a)'s
    shape and stream it to its end; -> ``out[tag]`` = (ack, run_done)."""
    from clawker_tpu_torch.loopd.client import LoopdClient

    with LoopdClient(sock) as c:
        c.hello()
        ack = c.submit_run({"parallel": LOOP_AGENTS,
                            "iterations": LOOP_ITERATIONS,
                            "tenant": f"client-{tag}"})
        acked.set()
        final = None
        for frame in c.events():
            if frame.get("type") == "run_done":
                final = frame
        out[tag] = (ack, final)


def loopd_inproc_case(base: Path, device, stages: dict):
    """(a): ``LoopdServer(cfg, FakeDriver(n_workers=4), device=...)`` with
    the daemon sentinel every 0.05 s (40 steps), the host proxy on a free
    port.  Two clients submit runs of loop (a)'s shape at once; a writer
    fills the workers' streams mid-run, a 55-record burst on one agent of
    the first run.  Both runs must be daemon-owned over the daemon's one
    admission controller, the status RPC's sentinel rows must hold the
    burst agent hottest and flagged, every scored tick one K3 and one K1
    (K5 and a K1 a card over several), and ``fleet anomaly`` in a
    subprocess must read the daemon (``source: loopd``) and exit 2."""
    import threading

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.loopd import pidfile_path
    from clawker_tpu_torch.loopd.client import LoopdClient
    from clawker_tpu_torch.loopd.server import LoopdServer

    name = "loopd (a)"
    with _isolated_dirs(base, LOOPD_SETTINGS) as proj:
        cfg = load_config(proj)
        drv = FakeDriver(n_workers=LOOP_WORKERS)
        for api in drv.apis:
            api.add_image(LOOP_IMAGE)
            api.set_behavior(LOOP_IMAGE, exit_behavior(
                b"iteration done\n", 0, delay=LOOP_ITER_S))
        t0 = time.perf_counter()
        srv = LoopdServer(cfg, drv, device=device).start()
        start_ms = (time.perf_counter() - t0) * 1e3
        log = TickLog(srv.sentinel, stages)
        try:
            results: dict = {}
            acks = [threading.Event(), threading.Event()]
            clients = [threading.Thread(
                target=_loopd_client_run,
                args=(srv.sock_path, results, tag, acked),
                name=f"loopd-client-{tag}")
                for tag, acked in zip(("one", "two"), acks)]
            t0 = time.perf_counter()
            for c in clients:
                c.start()
            check(all(a.wait(30) for a in acks),
                  f"{name}: a submit was not acknowledged")
            runs = list(srv.runs)
            agents = [a for rid in runs
                      for a in (f"loop-{rid[:6]}-{i}"
                                for i in range(LOOP_AGENTS))]
            hot = agents[LOOP_HOT_SLOT]
            streams = _loop_egress(agents, hot, time.time())
            for wid, recs in streams.items():
                _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
            for c in clients:
                c.join(60)
            wall = (time.perf_counter() - t0) * 1e3
            want = sum(len(v) for v in streams.values())
            deadline = time.perf_counter() + 10
            while (srv.sentinel._scored_at[0] < want
                   and time.perf_counter() < deadline):
                time.sleep(LOOP_TICK_S)
            shared = all(srv.runs[rid].sched.admission is srv.admission
                         and srv.runs[rid].sched.lanes is srv.lanes
                         for rid in runs)
            with LoopdClient(srv.sock_path) as c:
                doc = c.status()
            env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
                       PYTHONPATH=str(ROOT))
            t1 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "clawker_tpu_torch", "fleet",
                 "anomaly", "--format", "json"], cwd=proj, env=env,
                capture_output=True, text=True, timeout=300)
            cli_ms = (time.perf_counter() - t1) * 1e3
        finally:
            srv.stop()
        check(not pidfile_path(cfg).exists() and not srv.sock_path.exists(),
              f"{name}: the stopped daemon left its pidfile or socket")
    check(sorted(results) == ["one", "two"]
          and all(final and final["ok"] for _, final in results.values()),
          f"{name}: runs {results}")
    check(len(runs) == 2 and shared,
          f"{name}: runs {runs} not both daemon-owned over one admission "
          "controller and lane registry")
    tenants = doc["admission"]["tenants"]
    check(sorted(tenants) == ["client-one", "client-two"]
          and all(r["state"] == "done" for r in doc["runs"]),
          f"{name}: status runs {doc['runs']}, tenants {sorted(tenants)}")
    sent = doc["sentinel"]
    container = f"clawker.{LOOP_PROJECT}.{hot}"
    peaks = {r["agent"]: r["peak_z"] for r in sent["rows"]}
    check(peaks and max(peaks, key=peaks.get) == container,
          f"{name}: hottest {max(peaks, key=peaks.get) if peaks else None}"
          f" (peak z {peaks}), want {container}")
    check(any(r["agent"] == container and r["flagged"]
              for r in sent["rows"]),
          f"{name}: {container} not flagged in {sent['flags']}")
    scored = log.check_run(name)
    launches = log.launches()
    check(proc.returncode == 2,
          f"{name}: fleet anomaly exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout)
    check(cli["source"].startswith("loopd:")
          and any(r["agent"] == container and r["flagged"]
                  for r in cli["rows"]),
          f"{name}: fleet anomaly read {cli.get('source')}: {cli['rows']}")
    print(f"loopd (a) in process: start (card up, kernels loaded) "
          f"{start_ms!r} ms; two clients x {LOOP_AGENTS} loops x "
          f"{LOOP_ITERATIONS} iterations over {LOOP_WORKERS} fake workers: "
          f"wall {wall!r} ms, {len(log.ticks)} ticks, {len(scored)} scored "
          f"(the last over {scored[-1][3].windows} windows), {hot} hottest "
          f"(peak z {peaks[container]}), flags "
          f"{sorted((f['agent'], f['kind']) for f in sent['flags'])}; "
          f"fleet anomaly subprocess exit 2 from {cli['source']} in "
          f"{cli_ms!r} ms; launches {json.dumps(launches)}")
    print(f"loopd (a): {log.stage_line()}")
    return launches


def _python(args: list[str], cwd: Path, env: dict | None = None,
            timeout: float = 300):
    """``python ARGS`` in ``cwd``: -> (process, host ms)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return proc, (time.perf_counter() - t0) * 1e3


def _cli(args: list[str], proj: Path, env: dict, timeout: float = 300):
    """``python -m clawker_tpu_torch ARGS`` in ``proj``: -> (process,
    host ms)."""
    return _python(["-m", "clawker_tpu_torch", *args], proj, env, timeout)


def loopd_forked_case(base: Path, device: str) -> None:
    """(b): ``loopd start`` forks ``python -m clawker_tpu_torch.loopd``
    (its own seeded fake driver, its sentinel on the card every 0.05 s
    over egress written beforehand); ``loop -p 4 -n 2 --json`` submits
    to it by default, ``loop attach`` re-streams the run, and a
    ``sentinel.tick`` span scored on the card must land in the daemon's
    flight record before ``loopd stop``."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loopd import socket_path
    from clawker_tpu_torch.monitor.ledger import FLIGHT_DIR

    name = "loopd (b)"
    with _isolated_dirs(base, LOOPD_SETTINGS) as proj:
        cfg = load_config(proj)
        logs = cfg.logs_dir
        logs.mkdir(parents=True, exist_ok=True)
        agents = [f"cli-{i}" for i in range(LOOP_WINDOWS)]
        records = [r for recs in _loop_egress(agents, agents[-1],
                                              time.time()).values()
                   for r in recs]
        for r in records:
            r["worker"] = "fake-0"
        _append(logs / "ebpf-egress-fake-0.jsonl", records)
        env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
                   CLAWKER_TPU_DRIVER="fake",
                   CLAWKER_TPU_FAKE_IMAGES=LOOP_IMAGE,
                   PYTHONPATH=str(ROOT))
        flight = logs / FLIGHT_DIR / "loopd-loopd.jsonl"
        t_spawn = time.time()
        start, start_ms = _cli(["loopd", "start"], proj, env)
        try:
            check(start.returncode == 0,
                  f"{name}: loopd start exited {start.returncode}: "
                  f"{start.stderr[-2000:]} {start.stdout[-2000:]}")
            run, run_ms = _cli(["loop", "-p", "4", "-n", "2", "--json"],
                               proj, env)
            check(run.returncode == 0 and "daemon-owned" in run.stderr,
                  f"{name}: loop exited {run.returncode}: "
                  f"{run.stderr[-2000:]}")
            doc = json.loads(run.stdout)
            attach, attach_ms = _cli(["loop", "attach", doc["loop_id"],
                                      "--json"], proj, env)
            check(attach.returncode == 0
                  and json.loads(attach.stdout)["loop_id"] == doc["loop_id"],
                  f"{name}: loop attach exited {attach.returncode}: "
                  f"{attach.stderr[-2000:]}")
            ticks = []
            deadline = time.perf_counter() + 30
            while not ticks and time.perf_counter() < deadline:
                if flight.exists():
                    ticks = [json.loads(line) for line in
                             flight.read_text().splitlines()
                             if '"sentinel.tick"' in line]
                time.sleep(0.1)
        finally:
            stop, stop_ms = _cli(["loopd", "stop"], proj, env)
        check(stop.returncode == 0 and not socket_path(cfg).exists(),
              f"{name}: loopd stop exited {stop.returncode}: "
              f"{stop.stderr[-2000:]}")
    check(len(doc["agents"]) == 4
          and all(a["status"] == "done" and a["iteration"] == 2
                  for a in doc["agents"]), f"{name}: agents {doc['agents']}")
    check(ticks and all(t["attrs"]["device"].startswith(device)
                        for t in ticks),
          f"{name}: scored ticks in the daemon's flight record: "
          f"{[t['attrs'] for t in ticks]}")
    print(f"loopd (b) forked: loopd start {start_ms!r} ms, loop (submitted) "
          f"{run_ms!r} ms, loop attach {attach_ms!r} ms, loopd stop "
          f"{stop_ms!r} ms; {len(doc['agents'])} agents done; the first "
          f"daemon tick scored on {ticks[0]['attrs']['device']} over "
          f"{ticks[0]['attrs']['windows']} windows from "
          f"{ticks[0]['t_start'] - t_spawn!r} to "
          f"{ticks[0]['t_end'] - t_spawn!r} s after `loopd start` began")


def hostproxy_case(base: Path) -> None:
    """The host proxy alone, as a run's first create brings it up:
    ``ensure_running`` forks ``python -m clawker_tpu_torch.hostproxy`` and
    waits for its /healthz; a second call finds it up; ``stop`` ends
    it.  Host ms of each."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.hostproxy import manager

    with _isolated_dirs(base) as proj:
        cfg = load_config(proj)
        t0 = time.perf_counter()
        manager.ensure_running(cfg)
        spawn_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        manager.ensure_running(cfg)
        again_ms = (time.perf_counter() - t0) * 1e3
        health = manager.health(cfg)
        t0 = time.perf_counter()
        stopped = manager.stop(cfg)
        stop_ms = (time.perf_counter() - t0) * 1e3
    check(health == {"ok": True, "sessions": 0} and stopped,
          f"host proxy: health {health}, stopped {stopped}")
    print(f"host proxy: spawn to healthy {spawn_ms!r} ms, ensure_running "
          f"again {again_ms!r} ms, stop {stop_ms!r} ms")


RUN_MARK = "CHIP_SMOKE_RUN"  # in every process this run starts (main sets it)


def _procs(pred) -> list[tuple[int, str]]:
    """Running processes other than this one (not zombies) for which
    ``pred(environ bytes, cwd)`` holds: -> [(pid, command line)]."""
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit() or int(d.name) == os.getpid():
            continue
        try:
            state = (d / "stat").read_text().rsplit(")", 1)[1].split()[0]
            environ = (d / "environ").read_bytes()
            cwd = os.readlink(d / "cwd")
            cmd = (d / "cmdline").read_bytes()
        except OSError:
            continue
        if state != "Z" and pred(environ, cwd):
            out.append((int(d.name), cmd.replace(b"\0", b" ").decode(
                errors="replace").strip()))
    return out


def _spawned_left(wait_s: float = 0.0) -> list[tuple[int, str]]:
    """The processes this run started (they carry its ``RUN_MARK``)
    still running after up to ``wait_s``."""
    mark = os.environ.get(RUN_MARK)
    if not mark:
        return []
    needle = f"\0{RUN_MARK}={mark}\0".encode()

    def left():
        return _procs(lambda env, _: needle in b"\0" + env)

    _wait(lambda: not left(), wait_s, 0.05)
    return left()


def _kill(procs: list[tuple[int, str]]) -> None:
    for pid, _ in procs:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


def no_process_left(where: str) -> None:
    """Every process this run started has ended: what is left after 5 s
    is killed, and fails the run."""
    left = _spawned_left(5.0)
    _kill(left)
    check(not left, f"{where}: processes left running: {left}")
    print(f"{where}: no process of this run left")


def no_daemon_left() -> None:
    """No host proxy, loopd or workerd pidfile under any state dir the
    loop, loopd and workerd phases used."""
    left = [str(p) for d in _ISOLATED
            for p in (d / "hostproxy.pid", d / "loopd" / "loopd.pid",
                      d / "workerd" / "workerd.pid")
            if p.exists()]
    check(not left, f"pidfiles left behind: {left}")
    print(f"no proxy, loopd or workerd pidfile left in {len(_ISOLATED)} "
          "state dirs")


def loopd_phase(device) -> collections.Counter:
    """Drives the port's loopd with its daemon sentinel; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "loopd"
    t0 = time.perf_counter()
    hostproxy_case(out / "proxy")
    with stage_timers({}) as stages:
        launches = loopd_inproc_case(out / "a", device, stages)
    loopd_forked_case(out / "b", device)
    no_daemon_left()
    print(f"loopd launches: {json.dumps(launches)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return launches


# ---------------------------------------------------------- workerd phase


WD_RTT_S = 0.05                 # the reference bench's injected WAN RTT
WD_RTT_ITERATIONS, WD_RTT_ITER_S = 4, 0.15
WD_RTT_RATIO_MAX = 1.5          # the reference bench's gate
WD_INTENT_DEADLINE_S = 2.0      # (c): an intent pending at the kill fails
#                                 over to the rescue pass this fast
WD_SETTINGS = ("loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
               "    hard_free_pct: 0.0005\n")


def _record_calls(drv) -> list[list[tuple[str, bool]]]:
    """Per fake worker, every gated engine call as (name, through the
    worker-resident view): the fault gate's ``_gate`` wrapped on each
    instance."""
    seen: list[list[tuple[str, bool]]] = [[] for _ in drv.gates]
    for i, gate in enumerate(drv.gates):
        inner = gate._gate

        def gated(name, *, local=False, _inner=inner, _seen=seen[i]):
            _seen.append((name, local))
            return _inner(name, local=local)

        gate._gate = gated
    return seen


def _launch_calls(calls, *, local: bool, name: str | None = None) -> int:
    names = (name,) if name else ("container_create", "container_start")
    return sum(1 for n, loc in calls if loc == local and n in names)


def _wd_servers(sock_dir: Path, cfg, drv):
    """One ``WorkerdServer`` per fake worker on its local engine view:
    -> (servers, worker id -> socket)."""
    from clawker_tpu_torch.workerd.server import WorkerdServer

    sock_dir.mkdir(parents=True, exist_ok=True)
    servers, socks = [], {}
    for i, w in enumerate(drv.workers()):
        socks[w.id] = sock_dir / f"wd-{i}.sock"
        servers.append(WorkerdServer(cfg, drv.local_engine(i),
                                     worker_id=w.id,
                                     sock_path=socks[w.id]).start())
    return servers, socks


def _wd_executors(socks: dict, *, rtt_s: float = 0.0,
                  intent_deadline_s: float = 60.0):
    from clawker_tpu_torch.workerd.executor import (ExecutorSet,
                                                    WorkerdExecutor)

    return ExecutorSet({wid: WorkerdExecutor(
        wid, sock, rtt_s=rtt_s, intent_deadline_s=intent_deadline_s)
        for wid, sock in socks.items()})


def _fake_pod(iter_s: float):
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.fake import exit_behavior

    drv = FakeDriver(n_workers=LOOP_WORKERS)
    for api in drv.apis:
        api.add_image(LOOP_IMAGE)
        api.set_behavior(LOOP_IMAGE, exit_behavior(
            b"iteration done\n", 0, delay=iter_s))
    return drv


def workerd_inproc_case(base: Path, device, stages: dict):
    """(a): loop (a)'s run with the launch data plane on workerd."""
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG
    from clawker_tpu_torch.sentinel import FleetSentinel
    from clawker_tpu_torch.tracing import merge_run

    name = "workerd (a)"
    bus_records = []
    box = {}

    def attach(sched, cfg, drv):
        s = FleetSentinel(cfg, drv, run_id=sched.loop_id, device=device,
                          interval_s=LOOP_TICK_S,
                          train_steps=SENTINEL_STEPS)
        box["log"] = TickLog(s, stages)
        sched.attach_sentinel(s)
        sched.events.add_tap(bus_records.append)
        return s

    def pod(cfg, drv):
        box["calls"] = _record_calls(drv)
        box["servers"], socks = _wd_servers(base / "sock", cfg, drv)
        box["execset"] = _wd_executors(socks)
        return box["execset"]

    def writer(cfg, agents):
        streams = _loop_egress(agents, agents[LOOP_HOT_SLOT], time.time())
        for wid, recs in streams.items():
            _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)

    with _isolated_dirs(base / "dirs", WD_SETTINGS) as proj:
        try:
            sched, s, agents, wall = _loop_run(proj, attach, writer=writer,
                                               pod=pod)
            log = box["log"]
            want = sum(len(v) for v in _loop_egress(agents, agents[0],
                                                    0).values())
            deadline = time.perf_counter() + 10
            while s._scored_at[0] < want and time.perf_counter() < deadline:
                time.sleep(LOOP_TICK_S)
            s.stop()
            sched.events.flush()
            rows = sched.status()
            peaks = {r["agent"]: r["peak_z"] for r in s.rows()}
            flags = s.flags()
            drv = sched.driver
            creates = sum(len(api.calls_named("container_create"))
                          for api in drv.apis)
            stats = [dict(srv.stats) for srv in box["servers"]]
            sched.cleanup(remove_containers=True)
        finally:
            if "execset" in box:
                box["execset"].close_all()
            for srv in box.get("servers", ()):
                srv.stop()
        t0 = time.perf_counter()
        res = merge_run(sched.cfg.logs_dir, sched.loop_id)
        merge_ms = (time.perf_counter() - t0) * 1e3
    calls = box["calls"]
    hot = agents[LOOP_HOT_SLOT]
    scored = log.check_run(name)
    _check_loop_rows(name, rows)
    local_creates = sum(_launch_calls(c, local=True,
                                      name="container_create")
                        for c in calls)
    remote = sum(_launch_calls(c, local=False) for c in calls)
    check(creates == local_creates == LOOP_AGENTS and remote == 0,
          f"{name}: {creates} creates, {local_creates} on the local views, "
          f"{remote} launch calls on the remote views")
    check(all(st["intents"] > 0 and st["events"] >= 2 * 2 * LOOP_ITERATIONS
              for st in stats), f"{name}: server stats {stats}")
    container = f"clawker.{LOOP_PROJECT}.{hot}"
    check(max(peaks, key=peaks.get) == container,
          f"{name}: hottest {max(peaks, key=peaks.get)} (peak z {peaks}), "
          f"want {container}")
    check(any(r.event == ANOMALY_FLAG and r.agent == container
              for r in bus_records),
          f"{name}: no {ANOMALY_FLAG} for {container} on the run's bus "
          f"(flags {flags})")
    iters = [r for r in res.roots if r.record.name == "iteration"]
    others = {r.record.name for r in res.roots} - {"iteration"}
    keys = {(r.record.agent, r.record.attrs.get("iteration")) for r in iters}
    check(len(iters) == len(keys) == LOOP_AGENTS * LOOP_ITERATIONS
          and others <= {"sentinel.tick"} and res.gaps == 0
          and all(any(c.record.name.startswith("workerd.")
                      for c in r.children) for r in iters),
          f"{name}: merged {len(iters)} iteration trees ({len(keys)} "
          f"distinct), other roots {others}, {res.gaps} gaps, sources "
          f"{res.sources}")
    remote_spans = collections.Counter(
        c.record.name for r in iters for c in r.children
        if c.record.name.startswith("workerd."))
    print(f"workerd (a) {LOOP_AGENTS} loops x {LOOP_ITERATIONS} iterations "
          f"over {LOOP_WORKERS} fake workers' workerd ({LOOP_ITER_S} s "
          f"each), sentinel every {LOOP_TICK_S} s: run wall {wall!r} ms, "
          f"{creates} creates all local, intents per server "
          f"{[st['intents'] for st in stats]}, event batches per server "
          f"{[st['batches'] for st in stats]}; {len(log.ticks)} ticks, "
          f"{len(scored)} scored, {hot} hottest (peak z {peaks[container]}),"
          f" flags {sorted((f['agent'], f['kind']) for f in flags)}; merge "
          f"{merge_ms!r} ms: {len(iters)} iteration trees, remote children "
          f"{dict(remote_spans)}, sources {res.sources}")
    print(f"workerd (a): {log.stage_line()}")
    return log.launches()


def workerd_rtt_case(base: Path) -> None:
    """(b): the reference bench's four fake-WAN legs."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec

    name = "workerd (b)"

    def leg(cfg, tag: str, rtt_s: float, workerd: bool) -> float:
        drv = _fake_pod(WD_RTT_ITER_S)
        servers, execset = [], None
        if workerd:
            servers, socks = _wd_servers(base / "sock" / tag, cfg, drv)
            execset = _wd_executors(socks, rtt_s=rtt_s,
                                    intent_deadline_s=30.0)
        drv.set_rtt_all(rtt_s)
        try:
            sched = LoopScheduler(cfg, drv, LoopSpec(
                parallel=LOOP_AGENTS, iterations=WD_RTT_ITERATIONS,
                image=LOOP_IMAGE), executors=execset)
            t0 = time.perf_counter()
            sched.start()
            loops = sched.run(poll_s=0.2)
            wall = time.perf_counter() - t0
            check(len(loops) == LOOP_AGENTS and all(
                l.status == "done" and l.iteration == WD_RTT_ITERATIONS
                for l in loops), f"{name}: leg {tag} ended "
                f"{[(l.status, l.iteration) for l in loops]}")
            drv.set_rtt_all(0.0)        # cleanup off the fake WAN
            sched.cleanup(remove_containers=True)
        finally:
            if execset is not None:
                execset.close_all()
            for srv in servers:
                srv.stop()
            drv.close()
        return wall

    with _isolated_dirs(base / "dirs") as proj:
        cfg = load_config(proj)
        walls = {(wd, rtt): leg(cfg, f"{'wd' if wd else 'direct'}"
                                     f"{int(rtt * 1000)}", rtt, wd)
                 for wd in (True, False) for rtt in (0.0, WD_RTT_S)}
    wd_ratio = walls[True, WD_RTT_S] / walls[True, 0.0]
    direct_ratio = walls[False, WD_RTT_S] / walls[False, 0.0]
    print(f"workerd (b) fake WAN, {LOOP_AGENTS} loops x {WD_RTT_ITERATIONS} "
          f"iterations of {WD_RTT_ITER_S} s over {LOOP_WORKERS} workers: "
          f"workerd wall {walls[True, 0.0]!r} s at 0 ms, "
          f"{walls[True, WD_RTT_S]!r} s at {WD_RTT_S * 1000:.0f} ms (ratio "
          f"{wd_ratio!r}); direct {walls[False, 0.0]!r} s at 0 ms, "
          f"{walls[False, WD_RTT_S]!r} s at {WD_RTT_S * 1000:.0f} ms (ratio "
          f"{direct_ratio!r})")
    check(wd_ratio <= WD_RTT_RATIO_MAX,
          f"{name}: the workerd leg's RTT ratio {wd_ratio!r} > "
          f"{WD_RTT_RATIO_MAX}")


def workerd_loopd_case(base: Path, device, stages: dict):
    """(c): loopd hosting (a)'s run over workerd, one workerd killed
    mid-run."""
    import threading

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loopd.client import LoopdClient
    from clawker_tpu_torch.loopd.server import LoopdServer

    name = "workerd (c)"
    with _isolated_dirs(base / "dirs", LOOPD_SETTINGS) as proj:
        cfg = load_config(proj)
        drv = _fake_pod(LOOP_ITER_S)
        calls = _record_calls(drv)
        servers, socks = _wd_servers(base / "sock", cfg, drv)
        made = []

        def factory():
            made.append(_wd_executors(
                socks, intent_deadline_s=WD_INTENT_DEADLINE_S))
            return made[-1]

        srv = None
        try:
            t0 = time.perf_counter()
            srv = LoopdServer(cfg, drv, executors=factory,
                              device=device).start()
            start_ms = (time.perf_counter() - t0) * 1e3
            log = TickLog(srv.sentinel, stages)
            out: dict = {}
            acked = threading.Event()
            client = threading.Thread(
                target=_loopd_client_run, args=(srv.sock_path, out, "wd",
                                                acked),
                name="workerd-loopd-client")
            t0 = time.perf_counter()
            client.start()
            check(acked.wait(30), f"{name}: the submit was not acknowledged")
            (run_id,) = list(srv.runs)
            agents = [f"loop-{run_id[:6]}-{i}" for i in range(LOOP_AGENTS)]
            hot = agents[LOOP_HOT_SLOT]
            streams = _loop_egress(agents, hot, time.time())
            for wid, recs in streams.items():
                _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
            with LoopdClient(srv.sock_path) as c:
                def rows():
                    return next((r["agents"] for r in c.status()["runs"]
                                 if r["run"] == run_id), [])

                deadline = time.perf_counter() + 10
                while time.perf_counter() < deadline and not (
                        len(rows()) == LOOP_AGENTS
                        and all(a["status"] == "running"
                                and a["iteration"] == 0 for a in rows())):
                    time.sleep(0.005)
                live = c.status()["workerd"]
                first = rows()
                killed = drv.workers()[0].id
                mark = len(calls[0])
                t_kill = time.perf_counter()
                servers[0].kill()
                client.join(60)
                wall = (time.perf_counter() - t0) * 1e3
                after = c.status()["workerd"]
            want = sum(len(v) for v in streams.values())
            deadline = time.perf_counter() + 10
            while (srv.sentinel._scored_at[0] < want
                   and time.perf_counter() < deadline):
                time.sleep(LOOP_TICK_S)
            direct_starts = _launch_calls(calls[0][mark:], local=False,
                                          name="container_start")
            closed = all(not ex.live() for ex in made[0].executors.values())
        finally:
            if srv is not None:
                srv.stop()
            for w in servers:
                w.stop()
            drv.close()
    ack, final = out.get("wd", (None, None))
    all_live = {w: "live" for w in socks}
    check(len(first) == LOOP_AGENTS and live == all_live,
          f"{name}: rows while every loop ran {first}, workerd {live}")
    check(after == dict(all_live, **{killed: "degraded"}),
          f"{name}: workerd rows after the kill {after}")
    check(final and final["ok"] and all(
        a["status"] == "done" and a["iteration"] == LOOP_ITERATIONS
        for a in final["agents"]), f"{name}: run {final}")
    check(direct_starts >= 1,
          f"{name}: no direct start on {killed} after its workerd died")
    check(len(made) == 1 and closed,
          f"{name}: {len(made)} executor sets made, closed {closed}")
    scored = log.check_run(name)
    print(f"workerd (c) loopd over workerd: start {start_ms!r} ms; one "
          f"client x {LOOP_AGENTS} loops x {LOOP_ITERATIONS} iterations over "
          f"{LOOP_WORKERS} workers' workerd: rows {live} while running; "
          f"{killed}'s workerd killed {(t_kill - t0) * 1e3!r} ms in, row "
          f"{after[killed]}, {direct_starts} direct starts there after; "
          f"run wall {wall!r} ms, {len(log.ticks)} ticks, {len(scored)} "
          f"scored on {scored[-1][3].device}")
    print(f"workerd (c): {log.stage_line()}")
    return log.launches()


def _pid_running(pid: int, wait_s: float = 5.0) -> bool:
    """Whether ``pid`` still runs after up to ``wait_s``: a process that
    exited but waits to be reaped (state Z, its parent gone) has
    stopped."""
    deadline = time.perf_counter() + wait_s
    while True:
        try:
            os.kill(pid, 0)
            state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
        except OSError:
            return False
        if state.split()[0] == "Z":
            return False
        if time.perf_counter() > deadline:
            return True
        time.sleep(0.05)


def workerd_forked_case(base: Path) -> None:
    """(d): ``workerd start`` forks ``python -m clawker_tpu_torch.workerd``
    over its own seeded fake driver; ``status`` reads it live; ``stop``
    ends it."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.workerd import pidfile_path, socket_path

    name = "workerd (d)"
    with _isolated_dirs(base) as proj:
        cfg = load_config(proj)
        env = dict(os.environ, CLAWKER_TPU_DRIVER="fake",
                   CLAWKER_TPU_FAKE_IMAGES=LOOP_IMAGE,
                   PYTHONPATH=str(ROOT))
        start, start_ms = _cli(["workerd", "start"], proj, env)
        try:
            check(start.returncode == 0 and socket_path(cfg).exists(),
                  f"{name}: workerd start exited {start.returncode}: "
                  f"{start.stderr[-2000:]} {start.stdout[-2000:]}")
            pid = int(pidfile_path(cfg).read_text())
            status, status_ms = _cli(["workerd", "status", "--json"], proj,
                                     env)
        finally:
            stop, stop_ms = _cli(["workerd", "stop"], proj, env)
        check(status.returncode == 0
              and json.loads(status.stdout)["local"]["pid"] == pid,
              f"{name}: workerd status exited {status.returncode}: "
              f"{status.stdout[-2000:]} {status.stderr[-2000:]}")
        check(stop.returncode == 0 and not socket_path(cfg).exists()
              and not pidfile_path(cfg).exists(),
              f"{name}: workerd stop exited {stop.returncode}: "
              f"{stop.stderr[-2000:]}")
    check(not _pid_running(pid),
          f"{name}: workerd pid {pid} still running after stop")
    print(f"workerd (d) forked: workerd start {start_ms!r} ms, status "
          f"{status_ms!r} ms, stop {stop_ms!r} ms")


def workerd_phase(device) -> collections.Counter:
    """Drives the port's workerd under ``loop`` and loopd; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "workerd"
    total = collections.Counter()
    t0 = time.perf_counter()
    with stage_timers({}) as stages:
        total.update(workerd_inproc_case(out / "a", device, stages))
    workerd_rtt_case(out / "b")
    with stage_timers({}) as stages:
        total.update(workerd_loopd_case(out / "c", device, stages))
    workerd_forked_case(out / "d")
    no_daemon_left()
    print(f"workerd launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# ----------------------------------------------------------- resume phase


RESUME_POOL_DEPTH = 2           # the reference's default loop.warm_pool.depth
RESUME_HOT2_SLOT = 2            # the second generation's burst agent


def _tap_servers(servers) -> list[list[tuple]]:
    """Per ``WorkerdServer``, every intent it executed as (kind, names a
    ``pool_cid``) and every ``created`` event it emitted as ("created",
    pool, pool_error): the instance's ``_execute`` and ``_emit``
    wrapped."""
    seen: list[list[tuple]] = [[] for _ in servers]
    for srv, log in zip(servers, seen):
        execute, emit = srv._execute, srv._emit

        def traced(intent, _execute=execute, _log=log):
            _log.append((intent.get("kind"), bool(intent.get("pool_cid"))))
            return _execute(intent)

        def emitted(ev, _emit=emit, _log=log):
            if ev.get("ev") == "created":
                _log.append(("created", ev.get("pool"),
                             ev.get("pool_error")))
            return _emit(ev)

        srv._execute, srv._emit = traced, emitted
    return seen


def _agent_creates(drv) -> collections.Counter:
    """container_create calls per loop agent's container name (pool
    fills, named ``pool-*``, are not counted)."""
    return collections.Counter(
        a[0] for api in drv.apis for a, _k in api.calls_named(
            "container_create") if ".loop-" in a[0])


def _wait(pred, timeout: float = 30.0, step: float = 0.01) -> bool:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _pooled_run(cfg, drv, *, executors=None):
    """A scheduler of loop (a)'s shape with the reference's default
    warm pool depth, its pool prefilled: -> (scheduler, members)."""
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec

    sched = LoopScheduler(cfg, drv, LoopSpec(
        parallel=LOOP_AGENTS, iterations=LOOP_ITERATIONS,
        warm_pool_depth=RESUME_POOL_DEPTH), executors=executors)
    members = sched.prefill_pool(timeout=30.0)
    check(members == RESUME_POOL_DEPTH * LOOP_WORKERS,
          f"resume: prefill_pool filled {members} members, want "
          f"{RESUME_POOL_DEPTH * LOOP_WORKERS}")
    return sched, members


def _kill_after_iteration_1(sched):
    """Run ``sched`` on a thread and kill it once every loop finished
    its first iteration: -> the thread, joined."""
    import threading

    t = threading.Thread(target=sched.run, kwargs={"poll_s": 0.05},
                         daemon=True, name="resume-gen1")
    t.start()
    check(_wait(lambda: all(l.iteration >= 1 for l in sched.loops)),
          f"resume: loops never finished iteration 1: "
          f"{[(l.agent, l.status, l.iteration) for l in sched.loops]}")
    sched.kill()
    t.join(30)
    check(not t.is_alive(), "resume: the killed scheduler's run() lives on")


def _journal_records(cfg, run_id: str) -> list[dict]:
    from clawker_tpu_torch.loop.journal import RunJournal, journal_path

    return RunJournal.read(journal_path(cfg.logs_dir, run_id))


def _journal_image(cfg, run_id: str):
    from clawker_tpu_torch.loop.journal import replay

    return replay(_journal_records(cfg, run_id))


def _pool_accounting(name, drv, image, summary, records_after) -> dict:
    """Every journaled live member is restored, swept as stale, or was
    never created; -> the counts."""
    live = {a: m for a, m in image.pool.items()
            if m.state in ("pending", "ready")}
    present = {c["Names"][0].lstrip("/") for api in drv.apis
               for c in api.container_list(all=True)}
    never = sum(1 for a in live
                if f"clawker.{LOOP_PROJECT}.{a}" not in present)
    stale = sum(1 for r in records_after if r["kind"] == "pool_remove"
                and r.get("reason") == "stale at resume")
    check(summary["pool_restored"] + stale + never == len(live),
          f"{name}: {len(live)} journaled pool members, "
          f"{summary['pool_restored']} restored + {stale} swept + {never} "
          f"never created")
    return {"journaled": len(live), "restored": summary["pool_restored"],
            "swept": stale, "never_created": never}


def _one_create_per_agent(name, drv, records) -> None:
    """Each loop agent's one placement got exactly one container: a
    create, or a pool member it adopted -- never both, never two."""
    creates = _agent_creates(drv)
    adopts = collections.Counter(r["by"] for r in records
                                 if r["kind"] == "pool_adopt")
    per = {a: creates.get(f"clawker.{LOOP_PROJECT}.{a}", 0) + adopts.get(a, 0)
           for a in {r["agent"] for r in records
                     if r["kind"] == "placement"}}
    check(per and all(v == 1 for v in per.values()),
          f"{name}: creates + pool adoptions per agent {per}")


COLD_STAGES = ("workspace_mounts", "engine_create", "workspace_seed")
HIT_STAGES = ("pool_adopt_env", "pool_adopt_finalize")


def _create_ms(sched, totals: dict, counts: dict) -> dict:
    """Host ms of a create, pool hits apart from cold creates: the
    median of the run's ``create`` spans (its flight record) of each
    kind, and the mean per create of the orchestrator's stages
    (``util.phases``): a cold create's (which every pool fill pays, off
    the hot path) and an adoption's."""
    from clawker_tpu_torch import telemetry

    spans = telemetry.load_spans(
        sched.flight.path.read_text().splitlines())
    out = {}
    for hit, label in ((True, "pool hit spans"),
                       (False, "cold create spans")):
        ms = [(s.t_end - s.t_start) * 1e3 for s in spans
              if s.name == "create" and bool(s.attrs.get("pool")) == hit]
        out[label] = (statistics.median(ms), len(ms)) if ms else None
    for label, names in (("cold create stages", COLD_STAGES),
                         ("adoption stages", HIT_STAGES)):
        n = counts.get(names[1], 0)
        out[label] = ({k: totals.get(k, 0.0) * 1e3 / n for k in names}, n)\
            if n else None
    return out


def resume_inproc_case(base: Path, device, stages: dict):
    """(a): loop (a)'s run with the warm pool (depth 2, prefilled) and the
    sentinel on the card, killed once every loop finished iteration 1,
    then ``LoopScheduler.resume`` + ``reconcile`` with a fresh
    ``FleetSentinel`` on the same run id (its baselines restored from
    the state file), run to the end."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loop import LoopScheduler
    from clawker_tpu_torch.sentinel import FleetSentinel
    from clawker_tpu_torch.util import phases

    name = "resume (a)"
    with _isolated_dirs(base) as proj:
        cfg = load_config(proj)
        drv = _fake_pod(LOOP_ITER_S)

        def sentinel(run_id: str):
            s = FleetSentinel(cfg, drv, run_id=run_id, device=device,
                              interval_s=LOOP_TICK_S,
                              train_steps=SENTINEL_STEPS)
            return s, TickLog(s, stages)

        def egress(agents, hot):
            for wid, recs in _loop_egress(agents, hot, time.time()).items():
                _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)

        phases.enable()
        sched1, members = _pooled_run(cfg, drv)
        agents = [sched1._agent_name(i) for i in range(LOOP_AGENTS)]
        sen1, log1 = sentinel(sched1.loop_id)
        sched1.attach_sentinel(sen1)
        sen1.start()
        sched1.start()
        egress(agents, agents[LOOP_HOT_SLOT])
        _kill_after_iteration_1(sched1)
        check(_wait(lambda: any(e[0] for e in log1.ticks), 10),
              f"{name}: generation 1's sentinel scored no tick")
        sen1.stop()
        hits1 = sched1.warmpool.stats()["hits"]
        flagged1 = set(sen1._flagged)
        image = _journal_image(cfg, sched1.loop_id)
        n_at_kill = len(_journal_records(cfg, sched1.loop_id))
        creates_at_kill = _agent_creates(drv)
        t0 = time.perf_counter()
        sched2 = LoopScheduler.resume(cfg, drv, image)
        sen2, log2 = sentinel(sched1.loop_id)
        restored = sen2.engine.baseline_depth()
        restored_flags = set(sen2._flagged)
        sched2.attach_sentinel(sen2)
        summary = sched2.reconcile()
        reconcile_ms = (time.perf_counter() - t0) * 1e3
        sen2.start()
        egress(agents, agents[RESUME_HOT2_SLOT])
        sched2.run(poll_s=0.05)
        counts = phases.counts()
        create_ms = _create_ms(sched2, phases.disable(), counts)
        want = sum(len(v) for v in _loop_egress(agents, agents[0],
                                                0).values())
        _wait(lambda: sen2._scored_at[0] >= 2 * want, 10, LOOP_TICK_S)
        sen2.stop()
        records = _journal_records(cfg, sched1.loop_id)
        creates_after = _agent_creates(drv) - creates_at_kill
        hits2 = sched2.warmpool.stats()["hits"]
        pool = _pool_accounting(name, drv, image, summary,
                                records[n_at_kill:])
        _one_create_per_agent(name, drv, records)
        rows = sched2.status()
        flagged2 = set(sen2._flagged) - restored_flags
        sched2.cleanup(remove_containers=True)
    check(hits1 >= 1, f"{name}: generation 1 pool hits {hits1}")
    _check_loop_rows(name, rows)
    exits = collections.Counter(r["agent"] for r in records
                                if r["kind"] == "exited")
    check(all(exits[a] == LOOP_ITERATIONS for a in agents),
          f"{name}: exits journaled per agent {dict(exits)}")
    check(sum(creates_after.values()) + hits2 == summary["relaunched"],
          f"{name}: {sum(creates_after.values())} creates and {hits2} pool "
          f"hits after the kill, {summary['relaunched']} relaunched "
          f"({summary})")
    check(restored > 0, f"{name}: the resumed sentinel restored no "
          "baseline sample")
    check(restored_flags == flagged1,
          f"{name}: restored flags {restored_flags}, generation 1 "
          f"flagged {flagged1}")
    check(not flagged2 & flagged1,
          f"{name}: windows flagged again: {flagged2 & flagged1}")
    scored1 = log1.check_run(f"{name} generation 1")
    scored2 = log2.check_run(f"{name} generation 2")
    launches = log1.launches() + log2.launches()
    print(f"resume (a) {LOOP_AGENTS} loops x {LOOP_ITERATIONS} iterations "
          f"over {LOOP_WORKERS} fake workers ({LOOP_ITER_S} s each), warm "
          f"pool {RESUME_POOL_DEPTH} a worker ({members} prefilled), "
          f"killed after iteration 1: generation 1 pool hits {hits1}, "
          f"{len(scored1)} scored ticks, flags {sorted(flagged1)}; "
          f"reconcile {summary} in {reconcile_ms!r} ms (resume() + "
          f"reconcile()), pool {pool}; generation 2 pool hits {hits2}, "
          f"{sum(creates_after.values())} creates after the kill, "
          f"{restored} baseline samples restored, {len(scored2)} scored "
          f"ticks, new flags {sorted(flagged2)}; create ms (per kind, "
          f"count) {create_ms}")
    print(f"resume (a) generation 2: {log2.stage_line()}")
    return launches


def resume_workerd_case(base: Path) -> None:
    """(b): (a)'s pooled run over one in-process ``WorkerdServer`` per
    fake worker: the fills are ``create`` intents, the hits launch
    intents naming a ``pool_cid`` whose ``created`` event reads ``pool:
    True`` with no ``pool_error``; after a scheduler kill and a resume
    over fresh executors, the adopted containers get ``adopt`` intents
    and no loop agent is created twice."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loop import LoopScheduler

    name = "resume (b)"
    with _isolated_dirs(base / "dirs", WD_SETTINGS) as proj:
        cfg = load_config(proj)
        drv = _fake_pod(LOOP_ITER_S)
        servers, socks = _wd_servers(base / "sock", cfg, drv)
        seen = _tap_servers(servers)
        execsets = [_wd_executors(socks)]
        try:
            t0 = time.perf_counter()
            sched1, _ = _pooled_run(cfg, drv, executors=execsets[0])
            sched1.start()
            _kill_after_iteration_1(sched1)
            execsets[0].close_all()
            gen1 = [list(s) for s in seen]
            image = _journal_image(cfg, sched1.loop_id)
            execsets.append(_wd_executors(socks))
            sched2 = LoopScheduler.resume(cfg, drv, image,
                                          executors=execsets[1])
            summary = sched2.reconcile()
            loops = sched2.run(poll_s=0.05)
            wall = (time.perf_counter() - t0) * 1e3
            records = _journal_records(cfg, sched1.loop_id)
            _one_create_per_agent(name, drv, records)
            rows = sched2.status()
            sched2.cleanup(remove_containers=True)
        finally:
            for ex in execsets:
                ex.close_all()
            for srv in servers:
                srv.stop()
    gen2 = [s[len(g):] for s, g in zip(seen, gen1)]
    kinds1 = collections.Counter(e for s in gen1 for e in s)
    kinds2 = collections.Counter(e for s in gen2 for e in s)
    check(kinds1[("create", False)] >= RESUME_POOL_DEPTH * LOOP_WORKERS,
          f"{name}: generation 1's fills as create intents: {kinds1}")
    check(kinds1[("launch", True)] >= 1
          and kinds1[("created", True, "")] == kinds1[("launch", True)],
          f"{name}: pooled launch intents and their created events "
          f"{kinds1}")
    check(not any(e[0] == "created" and e[2] for s in seen for e in s),
          f"{name}: a created event with a pool_error: {kinds1 + kinds2}")
    check(summary["adopted"] >= 1
          and kinds2[("adopt", False)] == summary["adopted"],
          f"{name}: {summary['adopted']} adopted, adopt intents {kinds2}")
    check(all(r["status"] == "done" and r["iteration"] == LOOP_ITERATIONS
              for r in rows), f"{name}: final rows {rows}")
    print(f"resume (b) over {LOOP_WORKERS} workerd: generation 1 intents "
          f"{dict(kinds1)}; reconcile {summary}; generation 2 intents "
          f"{dict(kinds2)}; wall {wall!r} ms")


def resume_loopd_case(base: Path, device, stages: dict):
    """(c): a ``LoopdServer`` with ``sentinel.enable`` hosts a 2-loop run
    with warm pool depth 1 and is killed mid-run (its process's threads,
    the sentinel's among them, die with it); a second ``LoopdServer``
    on the same logs dir adopts the run (``LoopdClient.adopt_run``):
    every loop ends done with one container per agent, and the second
    daemon's sentinel scores the adopted run's ticks on the card."""
    import threading

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loopd.client import LoopdClient
    from clawker_tpu_torch.loopd.server import LoopdServer

    name = "resume (c)"
    hold = threading.Event()

    def held(io) -> int:
        if not hold.is_set():
            hold.wait(30.0)
        return 0

    with _isolated_dirs(base, LOOPD_SETTINGS) as proj:
        cfg = load_config(proj)
        drv = _fake_pod(0.0)
        for api in drv.apis:
            api.set_behavior(LOOP_IMAGE, held)
        srv1 = LoopdServer(cfg, drv, device=device).start()
        log1 = TickLog(srv1.sentinel, stages)
        srv2 = None
        try:
            with LoopdClient(srv1.sock_path) as c:
                c.hello()
                ack = c.submit_run({"parallel": 2, "iterations": 1,
                                    "warm_pool_depth": 1})
                started = 0
                for frame in c.events():
                    if frame.get("event") == "iteration_start":
                        started += 1
                        if started == 2:
                            break
                srv1.kill()
                srv1.sentinel.stop()
            run_id = ack["run"]
            t0 = time.perf_counter()
            srv2 = LoopdServer(cfg, drv, device=device).start()
            log2 = TickLog(srv2.sentinel, stages)
            with LoopdClient(srv2.sock_path) as c:
                c.hello()
                adopted = c.adopt_run(run_id, stream=True)
                run = srv2.runs[run_id]
                check(_wait(lambda: run.sched is not None and all(
                    l.status == "running" for l in run.sched.loops)),
                      f"{name}: the adopted loops never read running")
                agents = [l.agent for l in run.sched.loops]
                for wid, recs in _loop_egress(agents, agents[0],
                                              time.time()).items():
                    _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
                check(_wait(lambda: any(e[0] for e in log2.ticks), 10),
                      f"{name}: the adopting daemon's sentinel scored no "
                      "tick while the run lived")
                hold.set()
                final = None
                for frame in c.events():
                    if frame.get("type") == "run_done":
                        final = frame
                        break
            wall = (time.perf_counter() - t0) * 1e3
            records = _journal_records(cfg, run_id)
            _one_create_per_agent(name, drv, records)
        finally:
            hold.set()
            if srv2 is not None:
                srv2.stop()
            srv1.sock_path.unlink(missing_ok=True)
    check(adopted["type"] == "adopted" and final is not None
          and final["ok"]
          and all(a["status"] == "done" for a in final["agents"]),
          f"{name}: adopted {adopted}, final {final}")
    kinds = collections.Counter(r["kind"] for r in records)
    check(kinds["adopted"] == 2 and kinds["resume"] == 1,
          f"{name}: journal kinds {dict(kinds)}")
    if any(e[0] for e in log1.ticks):
        # the hosted run's events alone can give the first daemon a
        # scored tick before the kill
        log1.check_run(f"{name} first daemon")
    scored = log2.check_run(f"{name} adopting daemon")
    print(f"resume (c) loopd adopt_run: a daemon killed mid-run, the run "
          f"adopted by a second daemon and finished in {wall!r} ms, "
          f"journal {dict(kinds)}; the adopting daemon's sentinel scored "
          f"{len(scored)} ticks on {scored[-1][3].device}")
    return log1.launches() + log2.launches()


def _cli_runner():
    """A ``CliRunner`` whose ``stdout`` holds stdout alone: click before
    8.2 mixes stderr into it unless told not to."""
    import inspect

    from click.testing import CliRunner

    if "mix_stderr" in inspect.signature(CliRunner).parameters:
        return CliRunner(mix_stderr=False)
    return CliRunner()


def resume_cli_case(base: Path, device: str) -> None:
    """(d): the verbs in process through ``CliRunner`` with one shared
    fake driver (the fake engine dies with a forked CLI): ``loop
    --resume <6-char prefix> --sentinel --json`` on a killed run exits 0
    with every agent done; ``journal verify`` exits 0 on its journal and
    2 on a copy with one byte flipped; ``journal verify --repair`` makes
    that copy resumable again."""
    import threading

    from clawker_tpu_torch import cli
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec
    from clawker_tpu_torch.loop.journal import (RunJournal, journal_path,
                                                replay)

    name = "resume (d)"
    hold = threading.Event()

    def held(io) -> int:
        if not hold.is_set():
            hold.wait(30.0)
        return 0

    saved = os.environ.get(cli.DEVICE_ENV)
    os.environ[cli.DEVICE_ENV] = device
    try:
        with _isolated_dirs(base) as proj:
            cfg = load_config(proj)
            drv = _fake_pod(0.0)
            for api in drv.apis:
                api.set_behavior(LOOP_IMAGE, held)
            sched1 = LoopScheduler(cfg, drv, LoopSpec(parallel=4,
                                                      iterations=1))
            t = threading.Thread(target=sched1.run,
                                 kwargs={"poll_s": 0.05}, daemon=True)
            sched1.start()
            t.start()
            check(_wait(lambda: all(l.status == "running"
                                    for l in sched1.loops)),
                  f"{name}: the run never ran")
            sched1.kill()
            t.join(30)
            hold.set()
            creates = sum(len(api.calls_named("container_create"))
                          for api in drv.apis)
            factory = cli.Factory(cwd=proj, driver=drv)
            runner = _cli_runner()

            def invoke(*args):
                t0 = time.perf_counter()
                res = runner.invoke(cli.cli, list(args), obj=factory)
                return res, (time.perf_counter() - t0) * 1e3

            res, resume_ms = invoke("loop", "--resume", sched1.loop_id[:6],
                                    "--sentinel", "--json")
            check(res.exit_code == 0,
                  f"{name}: loop --resume exited {res.exit_code}: "
                  f"{res.output[-2000:]}")
            doc = json.loads(res.stdout)
            check(doc["loop_id"] == sched1.loop_id
                  and all(a["status"] == "done" for a in doc["agents"])
                  and sum(len(api.calls_named("container_create"))
                          for api in drv.apis) == creates,
                  f"{name}: resumed run {doc}")
            summary = next(line for line in res.stderr.splitlines()
                           if line.startswith("resume:"))
            path = journal_path(cfg.logs_dir, sched1.loop_id)
            clean, _ = invoke("journal", "verify", sched1.loop_id)
            copy = path.with_name("flipped.journal")
            data = bytearray(path.read_bytes())
            starts = [0] + [i + 1 for i, b in enumerate(data) if b == 0x0A]
            data[starts[2] + 3] ^= 0x01
            copy.write_bytes(bytes(data))
            flipped, _ = invoke("journal", "verify", str(copy))
            repaired, _ = invoke("journal", "verify", str(copy), "--repair")
            again, _ = invoke("journal", "verify", str(copy))
            records, integrity = RunJournal.read_verified(copy)
            image = replay(records)
    finally:
        if saved is None:
            os.environ.pop(cli.DEVICE_ENV, None)
        else:
            os.environ[cli.DEVICE_ENV] = saved
    check((clean.exit_code, flipped.exit_code, repaired.exit_code,
           again.exit_code) == (0, 2, 0, 0),
          f"{name}: journal verify exits clean {clean.exit_code}, flipped "
          f"{flipped.exit_code}, --repair {repaired.exit_code}, after "
          f"{again.exit_code}")
    check(not integrity.corrupt and image.run_id == sched1.loop_id,
          f"{name}: the repaired copy folds {integrity.to_doc()}")
    print(f"resume (d) verbs: loop --resume {sched1.loop_id[:6]} --sentinel "
          f"--json exit 0 in {resume_ms!r} ms ({summary}); journal verify "
          f"0, flipped copy 2, --repair 0 ({repaired.stdout.strip()!r}), "
          f"then 0")


def resume_phase(device) -> collections.Counter:
    """Drives the warm pool and ``--resume``; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "resume"
    total = collections.Counter()
    t0 = time.perf_counter()
    with stage_timers({}) as stages:
        total.update(resume_inproc_case(out / "a", device, stages))
    resume_workerd_case(out / "b")
    with stage_timers({}) as stages:
        total.update(resume_loopd_case(out / "c", device, stages))
    resume_cli_case(out / "d", device)
    no_daemon_left()
    print(f"resume launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# ---------------------------------------------------------- worktrees phase


WT_HOSTS = ("git.example.com",)
WT_RULE_KEYS = frozenset({"git.example.com:https:443",
                          "git.example.com:ssh:22",
                          "git.example.com:git:9418"})
WT_USER_RULE = "pypi.org:https:443"   # a user's standing rule: untouched
SUN_PATH_MAX = 107                    # AF_UNIX path bytes, less the NUL


def _git(cwd: Path, *args, header: str = "", check_rc: bool = True):
    """``git`` with a fixed identity (a card host may have none), and an
    identity header for the guard when ``header`` is given."""
    from clawker_tpu_torch.gitguard.refpolicy import IDENTITY_HEADER

    cmd = ["git", "-c", "user.email=chip@smoke", "-c", "user.name=chip"]
    if header:
        cmd += ["-c", f"http.extraHeader={IDENTITY_HEADER}: {header}"]
    proc = subprocess.run([*cmd, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=60)
    if check_rc:
        check(proc.returncode == 0,
              f"git {' '.join(args)} in {cwd} exited {proc.returncode}: "
              f"{proc.stderr[-1000:]}")
    return proc


def _git_repo(root: Path) -> None:
    """``root`` as a git repository on ``main`` with one commit."""
    _git(root, "init", "-q", "-b", "main")
    _git(root, "add", ".")
    _git(root, "commit", "-q", "-m", "root")


def _branches(repo: Path, pattern: str) -> list[str]:
    return sorted(b.strip(" *+") for b in _git(
        repo, "branch", "--list", pattern).stdout.splitlines())


@contextlib.contextmanager
def _wt_dirs(base: Path, settings: str = ""):
    """``_isolated_dirs`` with the swarm's settings (gitguard over
    WT_HOSTS, its socket in a short directory: the default under the
    data dir can pass ``sun_path``), the project a git repository with
    one commit and a user's rule in the egress store: -> (project dir,
    socket path)."""
    import tempfile

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.config.schema import EgressRule
    from clawker_tpu_torch.firewall.rules import RulesStore

    sock_dir = Path(tempfile.mkdtemp(prefix="gg"))
    sock = sock_dir / "g.sock"
    check(len(str(sock).encode()) < SUN_PATH_MAX,
          f"worktrees: the gitguard socket path {sock} passes sun_path")
    try:
        with _isolated_dirs(base, (
                f"gitguard:\n  hosts: [{', '.join(WT_HOSTS)}]\n"
                f"  socket: {sock}\n" + settings)) as proj:
            _git_repo(proj)
            RulesStore(load_config(proj).egress_rules_path).add(
                [EgressRule(dst="pypi.org")])
            yield proj, sock
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)


def _store_keys(cfg) -> set[str]:
    from clawker_tpu_torch.firewall.rules import RulesStore

    return {r.key() for r in RulesStore(cfg.egress_rules_path).load()}


def _wt_scheduler(cfg, drv, *, executors=None, **spec):
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec

    return LoopScheduler(cfg, drv, LoopSpec(
        parallel=LOOP_AGENTS, iterations=LOOP_ITERATIONS, worktrees=True,
        **spec), executors=executors)


def _wt_timed(sched, stages: dict) -> None:
    """Wrap the swarm's git work on the instance: each ``_maybe_worktree``
    (the provision under ``_git_lock``), the guard's setup and each
    merge drain, host ms into ``stages``'s lists."""
    for name in ("_maybe_worktree", "_gitguard_setup", "_drain_merges",
                 "_merge_tick"):
        fn = getattr(sched, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                stages.setdefault(_name, []).append(
                    (time.perf_counter() - t0) * 1e3)

        setattr(sched, name, timed)


def _wt_sentinel(sched, cfg, drv, device, stages: dict):
    from clawker_tpu_torch.sentinel import FleetSentinel

    s = FleetSentinel(cfg, drv, run_id=sched.loop_id, device=device,
                      interval_s=LOOP_TICK_S, train_steps=SENTINEL_STEPS)
    log = TickLog(s, stages)
    sched.attach_sentinel(s)
    return s, log


def _wt_egress(cfg, agents: list[str], hot: str) -> int:
    streams = _loop_egress(agents, hot, time.time())
    for wid, recs in streams.items():
        _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
    return sum(len(v) for v in streams.values())


def _wt_worktrees(name: str, records: list[dict], run_id: str) -> list[dict]:
    """The run's REC_SEED_WORKTREE records, held: one an agent, distinct
    paths and branches ``loop/<run>/<agent>``, each worktree linked (its
    ``.git`` a file), never a clone."""
    wts = [r for r in records if r["kind"] == "seed_worktree"]
    check(len(wts) == LOOP_AGENTS
          and len({r["agent"] for r in wts}) == LOOP_AGENTS
          and len({r["path"] for r in wts}) == LOOP_AGENTS
          and all(r["branch"] == f"loop/{run_id}/{r['agent']}"
                  for r in wts),
          f"{name}: worktree records {wts}")
    check(all((Path(r["path"]) / ".git").is_file() for r in wts),
          f"{name}: a worktree is not linked (its .git is not a file)")
    return wts


def _wt_landed(name: str, events: list, agents: list[str],
               run_id: str) -> None:
    merged = {a for a, e, d in events if e == "merged"
              and d.startswith(f"loop/{run_id}/merged:")}
    check(merged == set(agents),
          f"{name}: merged onto loop/{run_id}/merged: {sorted(merged)}; "
          f"merge events {[(a, e, d) for a, e, d in events if 'merge' in e]}")


def _wt_torn_down(name: str, cfg, guard) -> None:
    keys = _store_keys(cfg)
    check(guard is not None and not guard.running,
          f"{name}: the guard is still up after cleanup")
    check(not keys & WT_RULE_KEYS and WT_USER_RULE in keys,
          f"{name}: the store after cleanup holds {sorted(keys)}")


def _ms(xs: list[float]) -> str:
    return (f"{len(xs)} x median {statistics.median(xs)!r} ms, total "
            f"{sum(xs)!r} ms" if xs else "none")


def worktrees_inproc_case(base: Path, device, stages: dict):
    """(a): loop (a)'s shape as a bind-mode swarm (the default) with
    gitguard over WT_HOSTS and the sentinel on the card, in process."""
    import threading

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG

    name = "worktrees (a)"
    git_ms: dict = {}
    with _wt_dirs(base) as (proj, sock):
        cfg = load_config(proj)
        drv = _fake_pod(LOOP_ITER_S)
        sched = _wt_scheduler(cfg, drv)
        events: list = []
        sched.events.add_tap(lambda r: events.append(
            (r.agent, r.event, r.detail)))
        s, log = _wt_sentinel(sched, cfg, drv, device, stages)
        _wt_timed(sched, git_ms)
        journal = sched._journal
        at_wal = {}

        def spy(kind, **kw):
            if kind == "gitguard_rules":
                at_wal["store"] = _store_keys(cfg) & WT_RULE_KEYS
            return journal(kind, **kw)

        sched._journal = spy
        agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
        t0 = time.perf_counter()
        s.start()
        sched.start()
        guard = sched.gitguard
        summary = sched.gitguard_summary()
        installed = _store_keys(cfg)
        fill = threading.Thread(target=_wt_egress, args=(
            cfg, agents, agents[LOOP_HOT_SLOT]), name="wt-egress")
        fill.start()
        sched.run(poll_s=0.05)
        fill.join(30)
        wall = (time.perf_counter() - t0) * 1e3
        up_at_end = guard is not None and guard.running
        want = sum(len(v) for v in _loop_egress(agents, agents[0],
                                                0).values())
        _wait(lambda: s._scored_at[0] >= want, 10, LOOP_TICK_S)
        s.stop()
        sched.events.flush()
        rows = sched.status()
        peaks = {r["agent"]: r["peak_z"] for r in s.rows()}
        records = _journal_records(cfg, sched.loop_id)
        branches = _branches(proj, f"loop/{sched.loop_id}/*")
        t1 = time.perf_counter()
        sched.cleanup(remove_containers=True)
        cleanup_ms = (time.perf_counter() - t1) * 1e3
        _wt_torn_down(name, cfg, guard)
    run_id = sched.loop_id
    check(guard is not None and up_at_end and summary["running"]
          and summary["socket"] == str(sock),
          f"{name}: the guard was not up and running for the run "
          f"({summary})")
    check(set(summary["rules"]) == WT_RULE_KEYS <= installed,
          f"{name}: rule keys {summary['rules']}, store {sorted(installed)}")
    rules = [r for r in records if r["kind"] == "gitguard_rules"]
    check(len(rules) == 1 and set(rules[0]["keys"]) == WT_RULE_KEYS
          and at_wal.get("store") == set(),
          f"{name}: gitguard_rules records {rules}; the store held "
          f"{at_wal} when the keys were journaled")
    _wt_worktrees(name, records, run_id)
    check(branches == sorted([f"loop/{run_id}/merged"]
                             + [f"loop/{run_id}/{a}" for a in agents]),
          f"{name}: branches {branches}")
    _wt_landed(name, events, agents, run_id)
    _check_loop_rows(name, rows)
    scored = log.check_run(name)
    hot = f"clawker.{LOOP_PROJECT}.{agents[LOOP_HOT_SLOT]}"
    check(max(peaks, key=peaks.get) == hot
          and any(e == ANOMALY_FLAG and a == hot for a, e, _ in events),
          f"{name}: hottest {max(peaks, key=peaks.get)}, want {hot} "
          f"flagged")
    wt = git_ms.get("_maybe_worktree", [])
    print(f"worktrees (a) bind-mode swarm, {LOOP_AGENTS} loops x "
          f"{LOOP_ITERATIONS} iterations over {LOOP_WORKERS} fake workers "
          f"({LOOP_ITER_S} s each), gitguard over {list(WT_HOSTS)}: run wall "
          f"{wall!r} ms; setup_worktree (under _git_lock) {_ms(wt)}; "
          f"gitguard setup (rule install + proxy start) "
          f"{_ms(git_ms.get('_gitguard_setup', []))}; merge ticks "
          f"{_ms(git_ms.get('_merge_tick', []))}; end-of-run drain "
          f"{_ms(git_ms.get('_drain_merges', [])[:1])}; cleanup {cleanup_ms!r} "
          f"ms; {len(log.ticks)} ticks, {len(scored)} scored, "
          f"{hot} hottest")
    print(f"worktrees (a): {log.stage_line()}")
    return log.launches()


def worktrees_git_case(base: Path) -> None:
    """(b): a real git client through the guard (tests/test_gitguard.py:
    432) over TCP, git having no HTTP over a unix socket:
    ``GitguardServer(LocalRepoUpstream(repo), RefPolicy(run=...),
    tcp_addr=("127.0.0.1", 0))``."""
    from clawker_tpu_torch.gitguard import (GitguardServer,
                                            LocalRepoUpstream, RefPolicy)
    from clawker_tpu_torch.gitguard import server as gs

    name = "worktrees (b)"
    if base.exists():
        shutil.rmtree(base)
    seed = base / "seed"
    seed.mkdir(parents=True)
    (seed / "f.txt").write_text("base\n")
    _git_repo(seed)
    _git(seed, "branch", "loop/r1/a1")      # the sibling to hide

    def counted() -> dict:
        return {"allow": sum(c.peek() for c in gs.M_ALLOWED.children()),
                "deny": sum(c.peek() for c in gs.M_REFUSED.children())}

    before = counted()
    decisions: list = []
    t0 = time.perf_counter()
    srv = GitguardServer(LocalRepoUpstream(seed), RefPolicy(run="r1"),
                         tcp_addr=("127.0.0.1", 0),
                         on_decision=decisions.append).start()
    start_ms = (time.perf_counter() - t0) * 1e3
    push_ms = {}
    try:
        url = f"http://127.0.0.1:{srv.port}/seed"
        clone = base / "agent0"
        _git(base, "clone", "-q", url, str(clone))
        (clone / "work.txt").write_text("agent-0 was here\n")
        _git(clone, "add", ".")
        _git(clone, "commit", "-q", "-m", "work")
        pushes = {}
        for tag, ref, ident in (
                ("own", "loop/r1/a0", "r1/a0"),
                ("sibling", "loop/r1/a1", "r1/a0"),
                ("integration", "loop/r1/merged", "r1/a0"),
                ("mergeq", "loop/r1/merged", "r1/q/mergeq")):
            t0 = time.perf_counter()
            pushes[tag] = _git(clone, "push", "origin",
                               f"HEAD:refs/heads/{ref}", header=ident,
                               check_rc=False)
            push_ms[tag] = (time.perf_counter() - t0) * 1e3
        ls = _git(clone, "ls-remote", "origin", header="r1/a0").stdout
    finally:
        srv.close()
    after = counted()
    landed = _branches(seed, "loop/r1/*")
    check(pushes["own"].returncode == 0 and "loop/r1/a0" in landed,
          f"{name}: the agent's own push did not land: "
          f"{pushes['own'].stderr[-500:]}")
    check(pushes["sibling"].returncode != 0
          and "[remote rejected]" in pushes["sibling"].stderr
          and "namespace" in pushes["sibling"].stderr,
          f"{name}: the sibling push was not refused in-protocol: "
          f"{pushes['sibling'].stderr[-500:]}")
    check(pushes["integration"].returncode != 0
          and "merge-queue" in pushes["integration"].stderr
          and pushes["mergeq"].returncode == 0
          and "loop/r1/merged" in landed,
          f"{name}: the integration branch: {pushes['integration'].stderr}"
          f" / {pushes['mergeq'].stderr}")
    refs = [line.split("\t")[1] for line in ls.splitlines()]
    check("refs/heads/loop/r1/a0" in refs
          and "refs/heads/loop/r1/a1" not in refs,
          f"{name}: ls-remote shows {refs}")
    verdicts = collections.Counter(d.verdict for d in decisions
                                   if d.service == "git-receive-pack")
    delta = {k: after[k] - before[k] for k in after}
    check(verdicts == {"allow": 2, "deny": 2}
          and delta == {"allow": 2.0, "deny": 2.0},
          f"{name}: decisions {dict(verdicts)}, gitguard_* counters moved "
          f"{delta}")
    print(f"worktrees (b) git {_git(base, '--version').stdout.split()[-1]} "
          f"through the guard over TCP: start {start_ms!r} ms; pushes "
          f"(ms) {json.dumps(push_ms)}; decisions {dict(verdicts)}; "
          f"ls-remote hides the sibling")


def _tree_without_git_file(root: Path) -> bytes:
    """The worktree's seed tar with its linked ``.git`` file left out."""
    import io
    import tarfile

    from clawker_tpu_torch.workspace.strategy import _tar_tree

    out = io.BytesIO()
    with tarfile.open(fileobj=io.BytesIO(_tar_tree(root))) as tin, \
            tarfile.open(fileobj=out, mode="w",
                         format=tarfile.GNU_FORMAT) as tout:
        for ti in tin.getmembers():
            if ti.name != ".git":
                tout.addfile(ti, tin.extractfile(ti) if ti.isfile() else None)
    return out.getvalue()


def worktrees_workerd_case(base: Path, device, stages: dict):
    """(c): the swarm over workerd (the workerd phase's pod): in snapshot
    mode every launch dispatches through workerd and each agent's seed is
    its worktree; in bind mode over the same executors every loop
    launches direct.  The sentinel scores both on the card."""
    import tempfile

    from clawker_tpu_torch.config import load_config

    name = "worktrees (c)"
    out = {}
    launches = collections.Counter()
    for mode in ("snapshot", "bind"):
        with _wt_dirs(base / mode, WD_SETTINGS) as (proj, _sock):
            cfg = load_config(proj)
            drv = _fake_pod(LOOP_ITER_S)
            calls = _record_calls(drv)
            sock_dir = Path(tempfile.mkdtemp(prefix="wd"))
            servers, socks = _wd_servers(sock_dir, cfg, drv)
            execset = _wd_executors(socks)
            try:
                sched = _wt_scheduler(cfg, drv, executors=execset,
                                      workspace_mode=mode)
                events: list = []
                sched.events.add_tap(lambda r, _e=events: _e.append(
                    (r.agent, r.event, r.detail)))
                s, log = _wt_sentinel(sched, cfg, drv, device, stages)
                agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
                direct = [sched._workerd_for(w) is None
                          for w in drv.workers()]
                t0 = time.perf_counter()
                s.start()
                sched.start()
                want = _wt_egress(cfg, agents, agents[LOOP_HOT_SLOT])
                loops = sched.run(poll_s=0.05)
                wall = (time.perf_counter() - t0) * 1e3
                _wait(lambda: s._scored_at[0] >= want, 10, LOOP_TICK_S)
                s.stop()
                sched.events.flush()
                records = _journal_records(cfg, sched.loop_id)
                trees = {_tree_without_git_file(l.worktree) for l in loops}
                rows = sched.status()
                sched.cleanup(remove_containers=True)
            finally:
                execset.close_all()
                for srv in servers:
                    srv.stop()
                shutil.rmtree(sock_dir, ignore_errors=True)
            tag = f"{name} {mode}"
            _check_loop_rows(tag, rows)
            _wt_worktrees(tag, records, sched.loop_id)
            _wt_landed(tag, events, agents, sched.loop_id)
            scored = log.check_run(tag)
            launches.update(log.launches())
            seed_tars = [r for r in records if r["kind"] == "seed_tar"]
            local = sum(_launch_calls(c, local=True) for c in calls)
            remote = sum(_launch_calls(c, local=False) for c in calls)
            creates = sum(_launch_calls(c, local=mode == "snapshot",
                                        name="container_create")
                          for c in calls)
            out[mode] = (wall, len(seed_tars), len(trees), local, remote,
                         len(scored), direct)
            if mode == "snapshot":
                check(not any(direct) and remote == 0
                      and creates == LOOP_AGENTS,
                      f"{tag}: launch calls local {local} ({creates} "
                      f"creates), remote {remote}, direct workers {direct}")
                # the linked .git file (its gitdir: line names the agent)
                # rides each seed: one digest an agent, one tree without it
                check(len(seed_tars) == LOOP_AGENTS and len(trees) == 1,
                      f"{tag}: {len(seed_tars)} seed digests, "
                      f"{len(trees)} distinct trees without .git")
            else:
                check(all(direct) and local == 0
                      and creates == LOOP_AGENTS and not seed_tars,
                      f"{tag}: launch calls local {local}, remote {remote},"
                      f" direct workers {direct}, seeds {len(seed_tars)}")
    for mode, (wall, tars, trees, local, remote, n, _d) in out.items():
        print(f"worktrees (c) {mode}-mode swarm over workerd: run wall "
              f"{wall!r} ms, launch calls local {local} / remote {remote}, "
              f"{tars} seed digests ({trees} tree(s) without the linked "
              f".git file), {n} scored ticks on the card")
    return launches


def worktrees_resume_case(base: Path, device, stages: dict):
    """(d): (a)'s swarm killed once every loop finished iteration 1 (its
    guard dies with it), then ``LoopScheduler.resume`` + ``reconcile``
    with a fresh sentinel, run to the end."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loop import LoopScheduler

    name = "worktrees (d)"
    with _wt_dirs(base) as (proj, sock):
        cfg = load_config(proj)
        drv = _fake_pod(LOOP_ITER_S)
        sched1 = _wt_scheduler(cfg, drv)
        s1, log1 = _wt_sentinel(sched1, cfg, drv, device, stages)
        agents = [sched1._agent_name(i) for i in range(LOOP_AGENTS)]
        s1.start()
        sched1.start()
        _wt_egress(cfg, agents, agents[LOOP_HOT_SLOT])
        _kill_after_iteration_1(sched1)
        s1.stop()
        check(sched1.gitguard is not None and sched1.gitguard.running,
              f"{name}: generation 1's guard was not running at the kill")
        sched1.gitguard.close()     # a killed process's listener dies too
        run_id = sched1.loop_id
        records1 = _journal_records(cfg, run_id)
        branches1 = _branches(proj, f"loop/{run_id}/*")
        image = _journal_image(cfg, run_id)
        t0 = time.perf_counter()
        sched2 = LoopScheduler.resume(cfg, drv, image)
        events: list = []
        sched2.events.add_tap(lambda r: events.append(
            (r.agent, r.event, r.detail)))
        s2, log2 = _wt_sentinel(sched2, cfg, drv, device, stages)
        summary = sched2.reconcile()
        reconcile_ms = (time.perf_counter() - t0) * 1e3
        keys2 = list(sched2._gitguard_rule_keys)
        guard = sched2.gitguard
        running = guard is not None and guard.running
        s2.start()
        _wt_egress(cfg, agents, agents[RESUME_HOT2_SLOT])
        loops = sched2.run(poll_s=0.05)
        want = 2 * sum(len(v) for v in _loop_egress(agents, agents[0],
                                                    0).values())
        _wait(lambda: s2._scored_at[0] >= want, 10, LOOP_TICK_S)
        s2.stop()
        sched2.events.flush()
        records2 = _journal_records(cfg, run_id)[len(records1):]
        branches2 = _branches(proj, f"loop/{run_id}/*")
        rows = sched2.status()
        sched2.cleanup(remove_containers=True)
        _wt_torn_down(name, cfg, guard)
    new_wt = [r for r in records2 if r["kind"] == "seed_worktree"]
    check(not new_wt and [b for b in branches2 if not b.endswith("/merged")]
          == [b for b in branches1 if not b.endswith("/merged")]
          and len(branches2) == LOOP_AGENTS + 1,
          f"{name}: after the resume {len(new_wt)} new worktree records, "
          f"branches {branches1} -> {branches2}")
    check(sorted(keys2) == sorted(image.gitguard_rules)
          == sorted(WT_RULE_KEYS) and running,
          f"{name}: the resumed guard (running {running}) holds keys "
          f"{keys2}, journaled {image.gitguard_rules}")
    _check_loop_rows(name, rows)
    _wt_landed(name, events, agents, run_id)
    scored1 = log1.check_run(f"{name} generation 1")
    scored2 = log2.check_run(f"{name} generation 2")
    print(f"worktrees (d) the swarm killed after iteration 1 and resumed: "
          f"reconcile {summary} in {reconcile_ms!r} ms (resume() + "
          f"reconcile(), the guard re-armed on {len(keys2)} journaled keys);"
          f" 0 new worktrees, {len(branches2)} branches; scored ticks "
          f"{len(scored1)} + {len(scored2)}; loops "
          f"{[l.status for l in loops].count('done')} done")
    print(f"worktrees (d) generation 2: {log2.stage_line()}")
    return log1.launches() + log2.launches()


def worktrees_verbs_case(base: Path, device, stages: dict):
    """(e): ``loop --worktrees -p 2 -n 1 --sentinel --no-daemon --json``
    through ``CliRunner`` with one shared fake driver; an in-process
    ``LoopdServer`` with ``sentinel.enable`` hosting a 2-loop worktree
    submit, its status RPC's ``gitguard`` row enabled and running, its
    sentinel scoring the run on the card."""
    import threading

    from clawker_tpu_torch import cli
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loopd.client import LoopdClient
    from clawker_tpu_torch.loopd.server import LoopdServer

    name = "worktrees (e)"
    saved = os.environ.get(cli.DEVICE_ENV)
    os.environ[cli.DEVICE_ENV] = device
    try:
        with _wt_dirs(base / "cli") as (proj, _sock):
            drv = _fake_pod(0.0)
            runner = _cli_runner()
            t0 = time.perf_counter()
            res = runner.invoke(cli.cli, [
                "loop", "--worktrees", "-p", "2", "-n", "1", "--sentinel",
                "--no-daemon", "--json"],
                obj=cli.Factory(cwd=proj, driver=drv))
            cli_ms = (time.perf_counter() - t0) * 1e3
            check(res.exit_code == 0,
                  f"{name}: loop --worktrees exited {res.exit_code}: "
                  f"{res.output[-2000:]}")
            doc = json.loads(res.stdout)
            cli_branches = _branches(proj, f"loop/{doc['loop_id']}/*")
    finally:
        if saved is None:
            os.environ.pop(cli.DEVICE_ENV, None)
        else:
            os.environ[cli.DEVICE_ENV] = saved
    check(len(doc["agents"]) == 2
          and all(a["status"] == "done" for a in doc["agents"])
          and f"loop/{doc['loop_id']}/merged" in cli_branches,
          f"{name}: agents {doc['agents']}, branches {cli_branches}")

    hold = threading.Event()

    def held(io) -> int:
        if not hold.is_set():
            hold.wait(30.0)
        return 0

    with _wt_dirs(base / "loopd", LOOPD_SETTINGS) as (proj, sock):
        cfg = load_config(proj)
        drv = _fake_pod(0.0)
        for api in drv.apis:
            api.set_behavior(LOOP_IMAGE, held)
        srv = LoopdServer(cfg, drv, device=device).start()
        log = TickLog(srv.sentinel, stages)
        try:
            with LoopdClient(srv.sock_path) as c:
                c.hello()
                ack = c.submit_run({"parallel": 2, "iterations": 1,
                                    "worktrees": True}, stream=False)
            run = srv.runs[ack["run"]]
            check(_wait(lambda: run.sched is not None and all(
                l.status == "running" for l in run.sched.loops)),
                  f"{name}: the hosted swarm never ran")
            agents = [l.agent for l in run.sched.loops]
            for wid, recs in _loop_egress(agents, agents[0],
                                          time.time()).items():
                _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
            with LoopdClient(srv.sock_path) as c:
                row = {r["run"]: r for r in c.status()["runs"]}[ack["run"]]
            check(_wait(lambda: any(e[0] for e in log.ticks), 10),
                  f"{name}: the daemon's sentinel scored no tick")
            hold.set()
            check(run.done.wait(30), f"{name}: the hosted swarm never ended")
            daemon_branches = _branches(proj, f"loop/{ack['run']}/*")
        finally:
            hold.set()
            srv.stop()
        keys = _store_keys(cfg)
    gg = row["gitguard"]
    check(gg["enabled"] and gg["running"] and gg["socket"] == str(sock)
          and set(gg["rules"]) == WT_RULE_KEYS,
          f"{name}: the status RPC's gitguard row {gg}")
    check(run.result.get("ok") and len(daemon_branches) == 3
          and not keys & WT_RULE_KEYS,
          f"{name}: hosted run {run.result}, branches {daemon_branches}, "
          f"store {sorted(keys)}")
    scored = log.check_run(f"{name} loopd")
    print(f"worktrees (e) verbs: loop --worktrees -p 2 -n 1 --sentinel "
          f"--json exit 0 in {cli_ms!r} ms, branches {len(cli_branches)}; "
          f"loopd hosted a 2-loop swarm, status gitguard row enabled and "
          f"running ({len(gg['rules'])} rules), {len(scored)} daemon ticks "
          f"scored on {scored[-1][3].device}")
    return log.launches()


def worktrees_phase(device) -> collections.Counter:
    """Drives worktree swarms under ``loop --worktrees``: gitx, the merge
    queue and gitguard, with the sentinel scoring them; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "worktrees"
    ver = subprocess.run(["git", "--version"], capture_output=True,
                         text=True)
    check(ver.returncode == 0, f"worktrees: no git on this host: {ver}")
    print(f"worktrees: {ver.stdout.strip()}")
    total = collections.Counter()
    t0 = time.perf_counter()
    with stage_timers({}) as stages:
        total.update(worktrees_inproc_case(out / "a", device, stages))
    worktrees_git_case(out / "b")
    with stage_timers({}) as stages:
        total.update(worktrees_workerd_case(out / "c", device, stages))
    with stage_timers({}) as stages:
        total.update(worktrees_resume_case(out / "d", device, stages))
    with stage_timers({}) as stages:
        total.update(worktrees_verbs_case(out / "e", device, stages))
    no_daemon_left()
    print(f"worktrees launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# ------------------------------------------------------------ chaos phase

CHAOS_SEED = 20260803           # the reference's fixed soak
CHAOS_SCENARIOS = 4
# the scenarios' flight records keep every span on a nearly full disk:
# below the soft watermark the scheduler sheds its spans while workerd
# keeps its own, which the span audits would read as broken trees
CHAOS_SETTINGS = ("loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
                  "    hard_free_pct: 0.0005\n")


@contextlib.contextmanager
def _chaos_tick_logs(stages: dict):
    """Every ``FleetSentinel`` the chaos runner builds (it takes the
    class from ``clawker_tpu_torch.sentinel`` as it builds one), wrapped
    in a ``TickLog`` before it starts ticking: -> the logs, in order."""
    import clawker_tpu_torch.sentinel as S

    real = S.FleetSentinel
    logs: list[TickLog] = []

    def make(*args, **kw):
        sentinel = real(*args, **kw)
        logs.append(TickLog(sentinel, stages))
        return sentinel

    S.FleetSentinel = make
    try:
        yield logs
    finally:
        S.FleetSentinel = real


def _chaos_logs_check(name: str, logs: list) -> tuple[collections.Counter,
                                                      int]:
    """Each log's ticks: a scored one is one K3 and one K1 on the card, an
    idle one launches nothing, and each sentinel scored; -> (launches,
    scored ticks)."""
    launches = collections.Counter()
    scored = 0
    for i, log in enumerate(logs):
        scored += len(log.check_run(f"{name} sentinel {i}"))
        launches.update(log.launches())
    return launches, scored


def _decisions() -> float:
    from clawker_tpu_torch import telemetry

    return sum(r["value"] for r in telemetry.REGISTRY.snapshot()
               if r["metric"] == "capacity_decisions_total")


def chaos_soak_case(base: Path, device, stages: dict):
    """(a): ``run_soak(4, 20260803, keep_going=True, device=...)``, each
    scenario's verdict, kills, generations, injections and wall; every
    scenario holds every invariant (the CPU twins: tests/test_torch_
    chaos.py), the observe-only twin passes, and every scored tick of the
    sentinel scenarios and of the twin's sentinel run is one K3 and one
    K1 on the card."""
    from clawker_tpu_torch.chaos.runner import run_soak
    from clawker_tpu_torch.config import load_config

    name = "chaos (a)"
    rows = []
    with _isolated_dirs(base, CHAOS_SETTINGS, proxy=False) as proj, \
            _chaos_tick_logs(stages) as logs:
        cfg = load_config(proj)
        t0 = time.perf_counter()
        report = run_soak(CHAOS_SCENARIOS, CHAOS_SEED, keep_going=True,
                          shrink=False, cfg=cfg, device=device,
                          on_progress=rows.append)
        wall = (time.perf_counter() - t0) * 1e3
    for r in rows:
        riders = [k for k in ("sentinel", "workerd", "shipper", "capacity",
                              "gitguard") if r.plan_doc.get(k)]
        print(f"{name} scenario {r.scenario}: "
              f"{'ok' if r.ok else 'FAIL'}, kills {r.kills}, generations "
              f"{r.generations}, injected {r.injected}, wall {r.wall_s!r} s,"
              f" riders {riders}, events "
              f"{[e['kind'] for e in r.plan_doc['events']]}")
    check(len(rows) == CHAOS_SCENARIOS and all(r.ok for r in rows),
          f"{name}: failures {report['failures']}")
    check(report["observe_only"] == {"ok": True, "violations": []},
          f"{name}: observe-only {report['observe_only']}")
    sentinels = [r.scenario for r in rows if r.plan_doc.get("sentinel")]
    check(len(logs) == len(sentinels) + 1,
          f"{name}: {len(logs)} sentinels for the sentinel scenarios "
          f"{sentinels} and the twin")
    launches, scored = _chaos_logs_check(name, logs)
    print(f"{name}: {report['passed']}/{CHAOS_SCENARIOS} passed, "
          f"{report['kills']} kills, {report['injected']} injections, soak "
          f"wall {report['wall_s']!r} s ({wall!r} ms with the twin), "
          f"observe-only {report['observe_only']}; {scored} scored ticks "
          f"over {len(logs)} sentinels (scenarios {sentinels} and the twin),"
          f" launches {json.dumps(launches)}")
    return launches


def chaos_observe_case(device, stages: dict):
    """(b): ``run_observe_only_check(device=...)`` alone: no violation,
    and its sentinel scored on the card."""
    from clawker_tpu_torch.chaos.runner import run_observe_only_check

    name = "chaos (b)"
    with _chaos_tick_logs(stages) as logs:
        t0 = time.perf_counter()
        out = run_observe_only_check(CHAOS_SEED, device=device)
        wall = (time.perf_counter() - t0) * 1e3
    check(out == [], f"{name}: observe-only violations {out}")
    check(len(logs) == 1, f"{name}: {len(logs)} sentinels, want 1")
    launches, scored = _chaos_logs_check(name, logs)
    print(f"{name}: observe-only twin check [] in {wall!r} ms, {scored} "
          f"scored ticks, launches {json.dumps(launches)}")
    return launches


def chaos_riders_case(base: Path, device, stages: dict):
    """(c): one hand-written plan with every rider of this slice -- the
    sentinel (an egress flood), capacity (a traffic burst, a scale-down),
    the shipper (its index down) -- and a ``cli_sigkill`` armed at 0.0 s
    on ``launch.post_start`` with a torn tail: the scenario holds every
    invariant, one kill and two generations, the controller's decisions
    and the shipper's failed flushes and drops counted.  Each iteration
    holds its container LOOP_ITER_S, so the sentinel scores mid-run."""
    from clawker_tpu_torch.chaos.plan import FaultEvent, FaultPlan
    from clawker_tpu_torch.chaos.runner import ChaosRunner
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.fake import exit_behavior

    name = "chaos (c)"
    plan = FaultPlan(
        seed=CHAOS_SEED, scenario=99, n_workers=4, n_loops=8, iterations=3,
        warm_pool_depth=1, sentinel=True, capacity=True, shipper=True,
        events=[
            FaultEvent(at_s=0.0, kind="cli_sigkill", worker=-1,
                       arg="launch.post_start", torn_tail=20),
            FaultEvent(at_s=0.05, kind="traffic_burst", worker=1, arg=8),
            FaultEvent(at_s=0.1, kind="index_down", worker=-1),
            FaultEvent(at_s=0.15, kind="egress_flood", worker=2, arg=100),
            FaultEvent(at_s=0.2, kind="scale_down", worker=3)])
    with _isolated_dirs(base, CHAOS_SETTINGS, proxy=False) as proj, \
            _chaos_tick_logs(stages) as logs:
        before = _decisions()
        # iterations of LOOP_ITER_S: the run spans several sentinel ticks
        runner = ChaosRunner(load_config(proj), plan, device=device,
                             behavior=exit_behavior(b"", 0,
                                                    delay=LOOP_ITER_S))
        res = runner.run_scenario()
        decisions = _decisions() - before
        shipped = runner._shipper_audit()
        state = runner.capacity_ctrl.state()
    targets = {w: r["pool_target"] for w, r in state["workers"].items()}
    print(f"{name}: {'ok' if res.ok else 'FAIL'}, kills {res.kills}, "
          f"generations {res.generations}, injected {res.injected}, wall "
          f"{res.wall_s!r} s; capacity decisions {decisions!r}, pool "
          f"targets {targets}, drained {state['autoscale']['drained']}; "
          f"shipper ingested "
          f"{shipped['ingested_docs']}, flushed {shipped['flushed_docs']}, "
          f"dropped {shipped['dropped_docs']}, failed flushes "
          f"{shipped['failed_flushes']}")
    check(res.ok, f"{name}: violations {res.violations}")
    check((res.kills, res.generations) == (1, 2),
          f"{name}: {res.kills} kills over {res.generations} generations, "
          "want 1 over 2")
    check(decisions > 0, f"{name}: the controller decided nothing")
    check(shipped["down_injected"] and shipped["failed_flushes"] > 0
          and shipped["dropped_docs"] > 0,
          f"{name}: the down index cost no failed flush or drop: {shipped}")
    check(len(logs) == 1, f"{name}: {len(logs)} sentinels, want 1")
    launches, scored = _chaos_logs_check(name, logs)
    print(f"{name}: {scored} scored ticks over both generations, launches "
          f"{json.dumps(launches)}")
    return launches


def chaos_cli_case(base: Path, device: str) -> None:
    """(d): ``chaos run --scenarios 4 --seed 20260803 --json`` and ``chaos
    replay --seed 20260803 --scenario 1``, forked, on the card."""
    name = "chaos (d)"
    with _isolated_dirs(base, CHAOS_SETTINGS, proxy=False) as proj:
        env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
                   PYTHONPATH=str(ROOT))
        run, run_ms = _cli(["chaos", "run", "--scenarios",
                            str(CHAOS_SCENARIOS), "--seed", str(CHAOS_SEED),
                            "--json"], proj, env)
        replay, replay_ms = _cli(["chaos", "replay", "--seed",
                                  str(CHAOS_SEED), "--scenario", "1"],
                                 proj, env)
    check(run.returncode == 0,
          f"{name}: chaos run exited {run.returncode}: {run.stderr[-2000:]}")
    doc = json.loads(run.stdout)
    check(doc["ok"] and doc["passed"] == CHAOS_SCENARIOS
          and doc["observe_only"] == {"ok": True, "violations": []},
          f"{name}: chaos run report {doc}")
    check(replay.returncode == 0 and "ok" in replay.stdout,
          f"{name}: chaos replay exited {replay.returncode}: "
          f"{replay.stdout[-500:]} {replay.stderr[-2000:]}")
    print(f"{name}: chaos run --scenarios {CHAOS_SCENARIOS} exit 0 in "
          f"{run_ms!r} ms (soak wall {doc['wall_s']!r} s, {doc['kills']} "
          f"kills, {doc['injected']} injections); chaos replay --scenario 1 "
          f"exit 0 in {replay_ms!r} ms: {replay.stdout.strip()}")


def chaos_loopd_case(base: Path, device, stages: dict):
    """(e): an in-process ``LoopdServer`` with settings
    ``capacity.enable``, ``monitoring.shipper.enable`` (into an in-memory
    index) and ``sentinel.enable`` hosts one run of loop (a)'s shape with
    a warm pool; the status RPC's ``capacity`` row has ticked, its
    ``shipper`` row has taken docs, and every scored tick of the daemon
    sentinel is one K3 and one K1."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.loopd.client import LoopdClient
    from clawker_tpu_torch.loopd.server import LoopdServer
    from clawker_tpu_torch.monitor import shipper as shipmod
    from clawker_tpu_torch.testenv import FakeBulkIndex

    name = "chaos (e)"
    settings = LOOPD_SETTINGS + (
        "capacity:\n  enable: true\n  interval_s: 0.05\n"
        "  pool_max_depth: 2\n"
        "monitoring:\n  shipper:\n    enable: true\n    interval_s: 0.05\n")
    index = FakeBulkIndex()
    real_sink = shipmod.resolve_sink
    shipmod.resolve_sink = lambda _cfg: index
    try:
        with _isolated_dirs(base, settings) as proj:
            cfg = load_config(proj)
            drv = FakeDriver(n_workers=LOOP_WORKERS)
            for api in drv.apis:
                api.add_image(LOOP_IMAGE)
                api.set_behavior(LOOP_IMAGE, exit_behavior(
                    b"iteration done\n", 0, delay=LOOP_ITER_S))
            srv = LoopdServer(cfg, drv, device=device).start()
            log = TickLog(srv.sentinel, stages)
            try:
                t0 = time.perf_counter()
                with LoopdClient(srv.sock_path) as c:
                    c.hello()
                    ack = c.submit_run({"parallel": LOOP_AGENTS,
                                        "iterations": LOOP_ITERATIONS,
                                        "warm_pool_depth": 1})
                    agents = [f"loop-{ack['run'][:6]}-{i}"
                              for i in range(LOOP_AGENTS)]
                    streams = _loop_egress(agents, agents[LOOP_HOT_SLOT],
                                           time.time())
                    for wid, recs in streams.items():
                        _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl",
                                recs)
                    final = None
                    for frame in c.events():
                        if frame.get("type") == "run_done":
                            final = frame
                wall = (time.perf_counter() - t0) * 1e3
                want = sum(len(v) for v in streams.values())
                deadline = time.perf_counter() + 10
                while (srv.sentinel._scored_at[0] < want
                       and time.perf_counter() < deadline):
                    time.sleep(LOOP_TICK_S)
                with LoopdClient(srv.sock_path) as c:
                    doc = c.status()
            finally:
                srv.stop()
    finally:
        shipmod.resolve_sink = real_sink
    check(final and final["ok"], f"{name}: run_done {final}")
    cap, ship = doc["capacity"], doc["shipper"]
    check(cap["enabled"] and cap["ticks"] >= 1,
          f"{name}: status capacity row {cap}")
    check(ship["enabled"] and ship["ingested_docs"] > 0,
          f"{name}: status shipper row {ship}")
    check("capacity_wal" in doc["storage"],
          f"{name}: status storage row {doc['storage']}")
    scored = log.check_run(name)
    launches = log.launches()
    print(f"{name}: loopd with capacity, the shipper and the sentinel "
          f"hosted {LOOP_AGENTS} loops x {LOOP_ITERATIONS} iterations in "
          f"{wall!r} ms; capacity {cap['ticks']} ticks, pool targets "
          f"{ {w: r['pool_target'] for w, r in cap['workers'].items()} }; "
          f"shipper ingested {ship['ingested_docs']}, flushed "
          f"{ship['flushed_docs']}, index holds "
          f"{sum(len(v) for v in index.docs.values())}; {len(scored)} scored"
          f" ticks, launches {json.dumps(launches)}")
    return launches


def chaos_phase(device) -> collections.Counter:
    """Drives chaos soaks with the capacity and shipper riders and the
    observe-only twin, the sentinel scoring on the card; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "chaos"
    total = collections.Counter()
    t0 = time.perf_counter()
    with stage_timers({}) as stages:
        total.update(chaos_soak_case(out / "a", device, stages))
    with stage_timers({}) as stages:
        total.update(chaos_observe_case(device, stages))
    with stage_timers({}) as stages:
        total.update(chaos_riders_case(out / "c", device, stages))
    chaos_cli_case(out / "d", device)
    with stage_timers({}) as stages:
        total.update(chaos_loopd_case(out / "e", device, stages))
    no_daemon_left()
    print(f"chaos launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# ------------------------------------------------------------ views phase


VIEWS_COLS, VIEWS_ROWS = 120, 40        # the pseudo-terminal's window
# views (b)'s forked run: its seeded fake exits at once, so 3 iterations
# last 0.25-0.52 s against the 0.16-0.26 s of the first sentinel tick
# (the process's set-up); 6 leave the ticks that score the loops room
VIEWS_CLI_ITERATIONS = 6
CONSOLE_REPAINT_BUDGET_MS = 50.0        # bench.py:2075, p95 frame build +
#                                         paint at 256 agents over 4 runs
CONSOLE_FRAME_LINE_BOUND = 140          # bench.py:2078
CONSOLE_AGENTS, CONSOLE_RUNS, CONSOLE_FRAMES = 256, 4, 80
VIEWS_SETTINGS = ("loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
                  "    hard_free_pct: 0.0005\n")
_SGR = re.compile(r"\x1b\[[\d;]*m")


def _screen(text: str) -> list[str]:
    """The rows a terminal shows after ``text``: the damage painter's
    cursor-up, cursor-down and erase-line escapes applied (its rows never
    wrap), colour escapes kept, carriage returns dropped."""
    rows, cur = [""], 0
    for tok in re.split(r"(\x1b\[\d*[ABK]|\n)", text.replace("\r", "")):
        esc = re.fullmatch(r"\x1b\[(\d*)([ABK])", tok)
        if tok == "\n" or (esc and esc[2] == "B"):
            cur += 1 if tok == "\n" else int(esc[1] or 1)
            rows += [""] * (cur + 1 - len(rows))
        elif esc and esc[2] == "A":
            cur = max(0, cur - int(esc[1] or 1))
        elif esc:
            rows[cur] = ""
        else:
            rows[cur] += tok
    return rows


def _final_frame(rows: list[str], loop_id: str) -> list[str]:
    """The dashboard's last frame on the screen: from its head row to its
    status bar."""
    heads = [i for i, r in enumerate(rows)
             if _SGR.sub("", r).startswith(f"loop {loop_id}  ")]
    check(heads, f"no dashboard frame of loop {loop_id} on the screen")
    start = heads[-1]
    end = next((i for i in range(start, len(rows))
                if "ctrl-c stops" in rows[i]), None)
    check(end is not None, f"the frame of loop {loop_id} has no status bar")
    return rows[start:end + 1]


def _anom_cells(frame: list[str], why: str = "") -> dict[str, str]:
    """Agent -> its ANOM-Z cell, colour escapes kept, from a frame."""
    plain = [_SGR.sub("", r) for r in frame]
    head = next(i for i, r in enumerate(plain) if r.startswith("AGENT"))
    check(plain[head].split()[-1] == "ANOM-Z",
          f"the frame's table has no ANOM-Z column: {plain[head]!r}{why}")
    cells = {}
    for raw, row in zip(frame[head + 1:], plain[head + 1:]):
        if not row.strip():
            break
        cells[row.split()[0]] = raw.rstrip().rsplit(" ", 1)[-1]
    return cells


class _PtyDrain:
    """A pseudo-terminal of VIEWS_COLS x VIEWS_ROWS whose master end a
    thread drains into ``data``; ``tty`` is the slave end as a text
    stream."""

    def __init__(self):
        import fcntl
        import struct
        import termios

        self.master, slave = os.openpty()
        fcntl.ioctl(slave, termios.TIOCSWINSZ,
                    struct.pack("HHHH", VIEWS_ROWS, VIEWS_COLS, 0, 0))
        self.tty = os.fdopen(slave, "w", encoding="utf-8", buffering=1)
        self.data = bytearray()
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="pty-drain")
        self._thread.start()

    def _drain(self) -> None:
        while True:
            try:
                chunk = os.read(self.master, 65536)
            except OSError:
                return
            if not chunk:
                return
            self.data += chunk

    def close(self) -> str:
        self.tty.flush()
        deadline = time.perf_counter() + 5
        while time.perf_counter() < deadline:      # let the drain catch up
            n = len(self.data)
            time.sleep(0.05)
            if len(self.data) == n:
                break
        self.tty.close()
        self._thread.join(5)
        os.close(self.master)
        return self.data.decode("utf-8", "replace")


def _settled(log: TickLog, settle_s: float = 0.5,
             timeout: float = 30.0) -> bool:
    """Wait until ``log``'s sentinel has scored no tick for ``settle_s``
    and none is running; -> whether it did before ``timeout``."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        n = sum(1 for entry in log.ticks if entry[0])
        time.sleep(settle_s)
        if (n == sum(1 for entry in log.ticks if entry[0])
                and not TickLog._serial.locked()):
            return True
    return False


def views_dashboard_case(base: Path, device, stages: dict):
    """(a): loop (a)'s run (8 loops x 3 iterations on 4 fake workers, the
    sentinel on the card every 0.05 s, a burst on one agent) inside a
    ``LoopDashboard`` whose ``IOStreams`` stdout is the slave end of a
    120x40 pseudo-terminal (the in-process dashboard reads its width
    through ``shutil``, from ``COLUMNS``).  The final frame must carry
    the ANOM-Z column, each agent's cell ``sched.status()``'s
    ``anomaly_z`` formatted ``:.1f``, the burst agent at or over
    ``ANOMALY_Z`` and red, the status bar's ``anom-max`` the largest z,
    and each scored tick one K3 and one K1."""
    from clawker_tpu_torch.analytics.runtime import ANOMALY_Z
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.fleet.egress_tail import EgressFeed
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec
    from clawker_tpu_torch.sentinel import FleetSentinel
    from clawker_tpu_torch.ui import IOStreams
    from clawker_tpu_torch.ui.dashboard import LoopDashboard

    name = "views (a)"
    pty_out = _PtyDrain()
    saved = {k: os.environ.get(k) for k in ("COLUMNS", "LINES")}
    os.environ["COLUMNS"], os.environ["LINES"] = (str(VIEWS_COLS),
                                                  str(VIEWS_ROWS))
    try:
        with _isolated_dirs(base, VIEWS_SETTINGS, proxy=False) as proj:
            cfg = load_config(proj)
            drv = FakeDriver(n_workers=LOOP_WORKERS)
            for api in drv.apis:
                api.add_image(LOOP_IMAGE)
                api.set_behavior(LOOP_IMAGE, exit_behavior(
                    b"iteration done\n", 0, delay=LOOP_ITER_S))
            box: dict = {}

            def on_event(agent, event, detail=""):
                if event != "trace.span" and "dash" in box:
                    box["dash"].record_event(agent, event, detail)

            sched = LoopScheduler(cfg, drv, LoopSpec(
                parallel=LOOP_AGENTS, iterations=LOOP_ITERATIONS),
                on_event=on_event)
            s = FleetSentinel(cfg, drv, run_id=sched.loop_id, device=device,
                              interval_s=LOOP_TICK_S,
                              train_steps=SENTINEL_STEPS)
            log = TickLog(s, stages)
            sched.attach_sentinel(s)
            agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
            hot = agents[LOOP_HOT_SLOT]
            # the ticker tails each fake worker's own stream, the file
            # the sentinel reads for it
            feed = EgressFeed()
            for w in drv.workers():
                feed.add_local(w.id, cfg.logs_dir / f"ebpf-egress-{w.id}.jsonl")
            streams = IOStreams(stdout=pty_out.tty, env={"TERM": "xterm"})
            dash = box["dash"] = LoopDashboard(streams, sched,
                                               egress_feed=feed)
            _clear_of_minute_end(LIVE_RUN_MARGIN_S)
            egress = _loop_egress(agents, hot, time.time())
            want = sum(len(v) for v in egress.values())
            t0 = time.perf_counter()
            s.start()
            sched.start()
            try:
                with dash:
                    for wid, recs in egress.items():
                        _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl",
                                recs)
                    sched.run(poll_s=0.05)
                    wall = (time.perf_counter() - t0) * 1e3
                    # the final frame follows the last scored tick
                    deadline = time.perf_counter() + 10
                    while (s._scored_at[0] < want
                           and time.perf_counter() < deadline):
                        time.sleep(LOOP_TICK_S)
                    s.stop()
            finally:
                feed.stop()
                s.stop()
            rows = sched.status()
            painted = dash.painter.stats()
            sched.cleanup(remove_containers=True)
    finally:
        text = pty_out.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    scored = log.check_run(name)
    _check_loop_rows(name, rows)
    frame = _final_frame(_screen(text), sched.loop_id)
    cells = _anom_cells(frame)
    zs = {r["agent"]: r["anomaly_z"] for r in rows}
    check({a: _SGR.sub("", c) for a, c in cells.items()}
          == {a: f"{z:.1f}" for a, z in zs.items()},
          f"{name}: ANOM-Z cells {cells} against status {zs}")
    check(zs[hot] >= ANOMALY_Z and max(zs, key=zs.get) == hot
          and cells[hot] == f"\x1b[31m{zs[hot]:.1f}\x1b[0m",
          f"{name}: {hot} z {zs[hot]}, cell {cells[hot]!r} (threshold "
          f"{ANOMALY_Z}, hottest {max(zs, key=zs.get)})")
    bar = _SGR.sub("", frame[-1])
    check(f"anom-max:{max(zs.values()):.1f}" in bar and "done:8" in bar,
          f"{name}: status bar {bar!r}, largest z {max(zs.values())}")
    check(len(frame) < VIEWS_ROWS and painted["frames"] >= 2,
          f"{name}: {len(frame)} rows a frame, {painted['frames']} frames")
    print(f"{name} LoopDashboard on a {VIEWS_COLS}x{VIEWS_ROWS} pty over "
          f"loop (a)'s run: run wall {wall!r} ms, {painted['frames']} frames"
          f" ({painted['rows_painted']} of {painted['rows_total']} rows "
          f"rewritten), final frame {len(frame)} rows, {len(pty_out.data)} "
          f"bytes; {len(log.ticks)} ticks, {len(scored)} scored; {hot} "
          f"ANOM-Z {zs[hot]} (red), anom-max {max(zs.values())}")
    print(f"{name}: {log.stage_line()}")
    return log.launches()


def _pty_cli(args: list[str], proj: Path, env: dict,
             timeout: float = 300) -> tuple[int, str, float]:
    """``python -m clawker_tpu_torch ARGS`` in ``proj`` on a fresh
    VIEWS_COLS x VIEWS_ROWS pseudo-terminal (``pty.fork``; the window set
    in the child before it execs, ``COLUMNS``/``LINES`` cleared): ->
    (exit code, what the terminal received, host ms)."""
    import fcntl
    import pty
    import select
    import signal
    import struct
    import termios

    env = {k: v for k, v in env.items() if k not in ("COLUMNS", "LINES")}
    t0 = time.perf_counter()
    pid, fd = pty.fork()
    if pid == 0:            # the child: set the window, become the CLI
        try:
            fcntl.ioctl(1, termios.TIOCSWINSZ,
                        struct.pack("HHHH", VIEWS_ROWS, VIEWS_COLS, 0, 0))
            os.chdir(proj)
            os.execvpe(sys.executable, [sys.executable, "-m",
                                        "clawker_tpu_torch", *args], env)
        finally:
            os._exit(127)
    data = bytearray()
    deadline = time.perf_counter() + timeout
    status = None
    try:
        while True:
            ready, _, _ = select.select([fd], [], [], 0.2)
            if ready:
                try:
                    chunk = os.read(fd, 65536)
                except OSError:     # EIO: every holder closed the terminal
                    chunk = b""
                if chunk:
                    data += chunk
                    continue
                break
            done, st = os.waitpid(pid, os.WNOHANG)
            if done:
                status = st
                break
            if time.perf_counter() > deadline:
                os.kill(pid, signal.SIGKILL)
                break
        while select.select([fd], [], [], 0)[0]:    # what is left
            try:
                chunk = os.read(fd, 65536)
            except OSError:
                break
            if not chunk:
                break
            data += chunk
    finally:
        os.close(fd)
    if status is None:
        _, status = os.waitpid(pid, 0)
    return (os.waitstatus_to_exitcode(status), data.decode("utf-8",
                                                           "replace"),
            (time.perf_counter() - t0) * 1e3)


def views_cli_case(base: Path, device: str) -> None:
    """(b): ``python -m clawker_tpu_torch loop --parallel 8 --iterations
    6 --sentinel`` on the seeded fake driver, forked onto a 120x40
    pseudo-terminal: it must exit 0 having painted dashboard frames
    (and no per-event lines), the final frame with the ANOM-Z column;
    the same run with ``--json`` on the same terminal paints no frame.
    As in loop (c), egress written beforehand gives the sentinel's first
    tick (it starts before the run does) real work: the process's first
    fit pays its set-up there, not after the loops' first events, so the
    ticks scoring the loops land inside the short run."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.monitor.ledger import flight_path
    from clawker_tpu_torch.telemetry import SPAN_SENTINEL_TICK, load_spans

    name = "views (b)"
    settings = VIEWS_SETTINGS + f"sentinel:\n  interval_s: {LOOP_CLI_TICK_S}\n"
    with _isolated_dirs(base, settings, proxy=False) as proj:
        logs = load_config(proj).logs_dir
        logs.mkdir(parents=True, exist_ok=True)
        others = [f"cli-{i}" for i in range(LOOP_WINDOWS)]
        records = [r for recs in _loop_egress(others, others[-1],
                                              time.time()).values()
                   for r in recs]
        for r in records:
            r["worker"] = "fake-0"
        _append(logs / "ebpf-egress-fake-0.jsonl", records)
        env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
                   CLAWKER_TPU_DRIVER="fake",
                   CLAWKER_TPU_FAKE_IMAGES=LOOP_IMAGE,
                   PYTHONPATH=str(ROOT))
        args = ["loop", "--parallel", str(LOOP_AGENTS), "--iterations",
                str(VIEWS_CLI_ITERATIONS), "--sentinel"]
        rc, text, ms = _pty_cli(args, proj, env)
        run = re.search(r"loop ([0-9a-f]{12}): ", text)
        spans = []
        if run and flight_path(logs, run[1]).exists():
            spans = load_spans(flight_path(logs, run[1]).read_text()
                               .splitlines())
        rc_json, text_json, ms_json = _pty_cli([*args, "--json"], proj, env)
    check(rc == 0, f"{name}: exited {rc}: {text[-3000:]}")
    check(run, f"{name}: no run line: {text[-3000:]}")
    check("\x1b[2K" in text and not re.search(r"^\[loop-", text, re.M),
          f"{name}: no frame painted, or per-event lines: {text[-3000:]}")
    iters = [sp for sp in spans if sp.name == "iteration"]
    t0 = min((sp.t_start for sp in iters), default=0.0)
    timing = (f"; iterations from 0 to "
              f"{max((sp.t_end for sp in iters), default=0.0) - t0!r} s, "
              f"sentinel ticks (start, end, windows) "
              f"{[(sp.t_start - t0, sp.t_end - t0, sp.attrs.get('windows')) for sp in spans if sp.name == SPAN_SENTINEL_TICK]}")
    frame = _final_frame(_screen(text), run[1])
    cells = _anom_cells(frame, timing)
    # the run's lines as the terminal shows them: the painter may leave
    # its cursor with a cursor-down escape, not a newline, before them
    table = [line for line in (_SGR.sub("", r) for r in _screen(text))
             if re.match(rf"loop-{run[1][:6]}-\d+\t", line)]
    check(len(cells) == LOOP_AGENTS and len(table) == LOOP_AGENTS
          and all("\tdone\t" in line for line in table),
          f"{name}: cells {cells}, final lines {table}")
    check(rc_json == 0 and "\x1b[" not in text_json
          and "ctrl-c stops" not in text_json,
          f"{name}: --json exited {rc_json} or painted: {text_json[-3000:]}")
    doc = json.loads(text_json[text_json.index("\n{") + 1:
                               text_json.rindex("}") + 1])
    check(all(a["status"] == "done" for a in doc["agents"]),
          f"{name}: --json agents {doc['agents']}")
    print(f"{name} forked on a {VIEWS_COLS}x{VIEWS_ROWS} pty: exit 0 in "
          f"{ms!r} ms, {text.count(chr(27) + '[2K')} rows painted, "
          f"{text.count('ctrl-c stops')} status bars; final frame "
          f"{len(frame)} rows, ANOM-Z "
          f"{ {a: _SGR.sub('', c) for a, c in cells.items()} }{timing}; "
          f"with --json: exit 0 in {ms_json!r} ms, no frame")


def views_loopd_case(base: Path, device, stages: dict):
    """(c): an in-process ``LoopdServer`` with ``sentinel.enable`` and
    ``loopd.metrics_port`` on a free port hosts two runs of 8 loops (a
    burst on one agent of the first, the egress keyed by the loops'
    names, which the console's feed joins on); ``fleet console --once`` and
    ``fleet console --format json``, forked, must show the burst agent's
    ANOM-Z equal to the status RPC's sentinel row, ``FleetConsole
    .snapshot()`` both runs, the daemon's ``/metrics``
    ``anomaly_score{agent="<burst>"}`` at the same z and
    ``sentinel_ticks_total{result="scored"}`` at least 1, and each
    daemon tick one K3 and one K1."""
    import urllib.request

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.loopd.client import LoopdClient
    from clawker_tpu_torch.loopd.feed import console_feed, merge_feeds
    from clawker_tpu_torch.loopd.server import LoopdServer
    from clawker_tpu_torch.ui import IOStreams
    from clawker_tpu_torch.ui.fleetconsole import FleetConsole

    name = "views (c)"
    port = _free_port()
    settings = LOOPD_SETTINGS.replace(
        "loopd:\n", f"loopd:\n  metrics_port: {port}\n")
    with _isolated_dirs(base, settings, proxy=False) as proj:
        cfg = load_config(proj)
        drv = FakeDriver(n_workers=LOOP_WORKERS)
        for api in drv.apis:
            api.add_image(LOOP_IMAGE)
            api.set_behavior(LOOP_IMAGE, exit_behavior(
                b"iteration done\n", 0, delay=LOOP_ITER_S))
        srv = LoopdServer(cfg, drv, device=device).start()
        log = TickLog(srv.sentinel, stages)
        try:
            results: dict = {}
            acks = [threading.Event(), threading.Event()]
            clients = [threading.Thread(
                target=_loopd_client_run,
                args=(srv.sock_path, results, tag, acked),
                name=f"views-client-{tag}")
                for tag, acked in zip(("one", "two"), acks)]
            t0 = time.perf_counter()
            for c in clients:
                c.start()
            check(all(a.wait(30) for a in acks),
                  f"{name}: a submit was not acknowledged")
            runs = list(srv.runs)
            agents = [f"loop-{rid[:6]}-{i}" for rid in runs
                      for i in range(LOOP_AGENTS)]
            hot = agents[LOOP_HOT_SLOT]
            egress = _loop_egress(agents, hot, time.time())
            for wid, recs in egress.items():
                # keyed by the loop agent's own name: the console's feed
                # joins the sentinel's rows to a run's agents by exact
                # name, as the reference's does (a container-named row
                # shows "-" there)
                for r in recs:
                    r["container"] = r["container"].rsplit(".", 1)[-1]
                _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
            for c in clients:
                c.join(60)
            wall = (time.perf_counter() - t0) * 1e3
            want = sum(len(v) for v in egress.values())
            deadline = time.perf_counter() + 10
            while (srv.sentinel._scored_at[0] < want
                   and time.perf_counter() < deadline):
                time.sleep(LOOP_TICK_S)
            # the runs' last events re-score once more: read the rows
            # after the sentinel has gone quiet
            quiet = _settled(log)
            with LoopdClient(srv.sock_path) as c:
                before = c.status()
            env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
                       PYTHONPATH=str(ROOT))
            once, once_ms = _cli(["fleet", "console", "--once"], proj, env)
            js, js_ms = _cli(["fleet", "console", "--format", "json"], proj,
                             env)
            with LoopdClient(srv.sock_path) as c:
                after = c.status()
                streams, _, _, _ = IOStreams.test()
                t1 = time.perf_counter()
                snapshot = FleetConsole(
                    streams,
                    lambda: merge_feeds([console_feed(c.status())]),
                    logs_dir=cfg.logs_dir).snapshot()
                snapshot_ms = (time.perf_counter() - t1) * 1e3
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                body = r.read().decode()
        finally:
            srv.stop()
    check(sorted(results) == ["one", "two"]
          and all(final and final["ok"] for _, final in results.values()),
          f"{name}: runs {results}")
    row = {r["agent"]: r for r in before["sentinel"]["rows"]}.get(hot)
    check(row is not None and row["flagged"],
          f"{name}: {hot} not flagged in {before['sentinel']['rows']}")
    check(quiet, f"{name}: the daemon's sentinel kept scoring after the runs")
    moved = [(a, b) for a, b in zip(before["sentinel"]["rows"],
                                    after["sentinel"]["rows"]) if a != b]
    check(not moved and len(before["sentinel"]["rows"])
          == len(after["sentinel"]["rows"]),
          f"{name}: the sentinel's rows moved while the consoles read them: "
          f"{moved[:4]}")
    check(once.returncode == 0 and js.returncode == 0,
          f"{name}: fleet console exited {once.returncode} / "
          f"{js.returncode}: {once.stderr[-2000:]} {js.stderr[-2000:]}")
    feed = json.loads(js.stdout)
    json_z = {a["agent"]: a["anomaly_z"] for r in feed["runs"]
              for a in r["agents"]}
    check(json_z.get(hot) == round(row["latest_z"], 2),
          f"{name}: --format json z {json_z.get(hot)}, sentinel row "
          f"{row['latest_z']}")
    line = next((ln for ln in once.stdout.splitlines()
                 if ln.strip().startswith(hot + " ")), "")
    check(line.split()[-1:] == [f"{json_z[hot]:.1f}"]
          and "ANOM-Z" in once.stdout,
          f"{name}: --once row {line!r}, want ANOM-Z {json_z[hot]:.1f}")
    check(all(f"run {rid}" in snapshot for rid in runs),
          f"{name}: snapshot lacks a run: {snapshot[:3000]}")
    sample = re.search(
        rf'^anomaly_score\{{agent="{re.escape(hot)}"\}} (\S+)$', body, re.M)
    ticks = re.search(r'^sentinel_ticks_total\{result="scored"\} (\S+)$',
                      body, re.M)
    check(sample and abs(float(sample[1]) - row["latest_z"]) <= 0.005
          and ticks and float(ticks[1]) >= 1,
          f"{name}: /metrics anomaly_score {sample and sample[1]}, scored "
          f"ticks {ticks and ticks[1]}, sentinel row {row['latest_z']}")
    scored = log.check_run(name)
    launches = log.launches()
    print(f"{name} loopd with its metrics port: two runs x {LOOP_AGENTS} "
          f"loops in {wall!r} ms; {hot} ANOM-Z {json_z[hot]} in `fleet "
          f"console --once` ({once_ms!r} ms) and --format json "
          f"({js_ms!r} ms) = sentinel row {row['latest_z']} = /metrics "
          f"{sample[1]}; scored ticks in /metrics {ticks[1]}; snapshot of "
          f"{len(runs)} runs in {snapshot_ms!r} ms; {len(log.ticks)} ticks, "
          f"{len(scored)} scored, launches {json.dumps(launches)}")
    return launches


class _StubCollector:
    """An OTLP/HTTP collector on a free loopback port that keeps each
    ``POST /v1/logs`` body."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        bodies = self.bodies = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):          # noqa: N802 -- http.server contract
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if self.path == "/v1/logs":
                    bodies.append(json.loads(raw))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.srv = HTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self._thread = threading.Thread(
            target=self.srv.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="otlp-stub")
        self._thread.start()

    def stop(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self._thread.join(5)

    def samples(self, body: dict) -> list[dict]:
        return [json.loads(r["body"]["stringValue"])
                for rl in body["resourceLogs"] for sl in rl["scopeLogs"]
                for r in sl["logRecords"]]


def views_export_case(base: Path, device, stages: dict):
    """(d): ``loop -p 8 -n 3 --sentinel --metrics-port <free> --json`` in
    process (``CliRunner``) with settings ``telemetry.otlp`` and
    ``CLAWKER_TPU_OTLP`` naming a stub collector: a scrape during the run
    must carry the burst agent's ``anomaly_score``; after it the stub
    must hold batches of service ``clawker-telemetry`` only, the last (the
    final flush of ``stop()``) with that agent's ``anomaly_score``; each
    scored tick one K3 and one K1."""
    import urllib.request

    import clawker_tpu_torch.sentinel as S
    from clawker_tpu_torch import cli
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.fake import exit_behavior

    name = "views (d)"
    port = _free_port()
    settings = VIEWS_SETTINGS + (
        f"telemetry:\n  otlp: true\nsentinel:\n  interval_s: {LOOP_TICK_S}\n"
        f"  train_steps: {SENTINEL_STEPS}\n")
    stub = _StubCollector()
    real = S.FleetSentinel
    box: dict = {}

    def make(cfg, driver, *, run_id, **kw):
        # the run's agents are known once its id is: their egress lands
        # before the sentinel's first tick
        sentinel = real(cfg, driver, run_id=run_id, **kw)
        box["log"] = TickLog(sentinel, stages)
        agents = [f"loop-{run_id[:6]}-{i}" for i in range(LOOP_AGENTS)]
        box["hot"] = agents[LOOP_HOT_SLOT]
        egress = _loop_egress(agents, box["hot"], time.time())
        box["want"] = sum(len(v) for v in egress.values())
        for wid, recs in egress.items():
            _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
        box["sentinel"] = sentinel
        return sentinel

    scrapes: list[str] = []
    done = threading.Event()

    def scraper():
        while not done.is_set():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=2) as r:
                    body = r.read().decode()
            except OSError:
                time.sleep(0.02)
                continue
            hot = box.get("hot")
            if hot and f'anomaly_score{{agent="clawker.{LOOP_PROJECT}.{hot}"}}' \
                    in body:
                scrapes.append(body)
                return
            time.sleep(0.02)

    env = {"CLAWKER_TPU_OTLP": stub.endpoint, "CLAWKER_TORCH_DEVICE": device}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    S.FleetSentinel = make
    thread = threading.Thread(target=scraper, daemon=True, name="scraper")
    try:
        with _isolated_dirs(base, settings, proxy=False) as proj:
            drv = FakeDriver(n_workers=LOOP_WORKERS)
            for api in drv.apis:
                api.add_image(LOOP_IMAGE)
                api.set_behavior(LOOP_IMAGE, exit_behavior(
                    b"iteration done\n", 0, delay=LOOP_ITER_S))
            # the burst lies in this minute's window: a run that crosses
            # into the next scores the agent's bus events alone there, a
            # row by its name that status reads before the container's
            _clear_of_minute_end(LIVE_RUN_MARGIN_S)
            thread.start()
            t0 = time.perf_counter()
            res = _cli_runner().invoke(
                cli.cli, ["loop", "-p", str(LOOP_AGENTS), "-n",
                          str(LOOP_ITERATIONS), "--sentinel", "--no-daemon",
                          "--metrics-port", str(port), "--json"],
                obj=cli.Factory(cwd=proj, driver=drv))
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        done.set()
        thread.join(5)
        S.FleetSentinel = real
        stub.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(res.exit_code == 0, f"{name}: exited {res.exit_code}: "
          f"{res.output[-3000:]} {res.exception!r}")
    doc = json.loads(res.stdout)
    check(all(a["status"] == "done" for a in doc["agents"]),
          f"{name}: agents {doc['agents']}")
    container = f"clawker.{LOOP_PROJECT}.{box['hot']}"
    check(scrapes, f"{name}: no scrape during the run carried "
          f"anomaly_score for {container}")
    services = {rl["resource"]["attributes"][0]["value"]["stringValue"]
                for b in stub.bodies for rl in b["resourceLogs"]}
    check(stub.bodies and services == {"clawker-telemetry"},
          f"{name}: {len(stub.bodies)} batches of services {services}")
    last = [r for r in stub.samples(stub.bodies[-1])
            if r["metric"] == "anomaly_score"
            and r["labels"].get("agent") == container]
    z = {a["agent"]: a.get("anomaly_z") for a in doc["agents"]}[box["hot"]]
    check(last and abs(last[0]["value"] - z) <= 0.005,
          f"{name}: the final flush's anomaly_score for {container} "
          f"{last}, status z {z}")
    scored = box["log"].check_run(name)
    launches = box["log"].launches()
    print(f"{name} loop in process with --metrics-port and telemetry.otlp:"
          f" run wall {wall!r} ms; a scrape mid-run carried {container}; "
          f"the stub took {len(stub.bodies)} batches of clawker-telemetry, "
          f"the last with anomaly_score {last[0]['value']} (status z {z}); "
          f"{len(box['log'].ticks)} ticks, {len(scored)} scored, launches "
          f"{json.dumps(launches)}")
    return launches


def _console_status_doc(runs: int, per_run: int, tick: int,
                        statuses: dict) -> dict:
    """A copy of bench.py:2084-2135: a loopd status RPC doc for ``runs``
    hosted runs of ``per_run`` agents each."""
    workers = [f"w{i}" for i in range(4)]
    run_docs = []
    for r in range(runs):
        agents = []
        for i in range(per_run):
            status, iteration = statuses.get((r, i), ("running", 1))
            agents.append({
                "agent": f"loop-r{r}-{i:03d}", "worker": workers[i % 4],
                "status": status, "iteration": iteration,
                "exit_codes": [0],
                **({"anomaly_z": 4.2} if i == 7 else {}),
            })
        run_docs.append({
            "run": f"run{r:02d}", "state": "running", "tenant": f"t{r}",
            "client": "bench", "parallel": per_run, "iterations": 4,
            "placement": "spread", "agents": agents, "subscribers": 1,
            "events_dropped": tick % 3,
        })
    return {
        "pid": 4242, "project": "bench", "uptime_s": float(tick),
        "runs": run_docs,
        "admission": {
            "workers": {w: {"inflight": 2, "capacity": 4, "pending": 0,
                            "inflight_hwm": 3, "dispatched": 40 + tick,
                            "rejected": 0} for w in workers},
            "tenants": {f"t{r}": {"weight": 1.0, "inflight": 2,
                                  "queued": 1, "dispatched": 10 + tick}
                        for r in range(runs)},
        },
        "health": [{"worker": w, "state": "closed",
                    "breaker_state_gauge": 0, "probe_p50_ms": 1.2,
                    "probe_p95_ms": 2.0, "probes": 100 + tick,
                    "probe_failures": 0, "orphaned": 0,
                    "migrations_out": 0, "migrations_in": 0,
                    "last_error": ""} for w in workers],
        "workerd": {w: "ok" for w in workers},
        "warm_pools": {"run00": {"target_depth": 2, "hits": 9, "misses": 1,
                                 "refills": 3, "recycled": 0,
                                 "workers": {w: {"ready": 2, "inflight": 0}
                                             for w in workers}}},
        "sentinel": {"enabled": True, "ticks": tick, "rows": []},
        "shipper": {"enabled": True, "ingested_docs": 100 * tick,
                    "pending_batches": 0, "dropped_docs": 0},
        "events_dropped_total": tick % 3,
    }


def views_repaint_case(base: Path) -> None:
    """(e): the reference bench's ``bench_console_repaint``
    (bench.py:2137-2210) on the port: 256 agents over 4 runs, 8 rows
    changing a frame, 80 frames, span waterfalls tailed from a real
    flight file; the p95 of a frame's build + paint must be under
    CONSOLE_REPAINT_BUDGET_MS and the frame no taller than
    CONSOLE_FRAME_LINE_BOUND.  Host work, on the chip host's CPU."""
    from clawker_tpu_torch.loopd.feed import console_feed
    from clawker_tpu_torch.monitor.ledger import flight_path
    from clawker_tpu_torch.telemetry.spans import SpanRecord
    from clawker_tpu_torch.ui import IOStreams
    from clawker_tpu_torch.ui.fleetconsole import FleetConsole

    name = "views (e)"
    per_run = CONSOLE_AGENTS // CONSOLE_RUNS
    statuses: dict = {}
    tick = [0]
    if base.exists():
        shutil.rmtree(base)
    fpath = flight_path(base, "run00")
    fpath.parent.mkdir(parents=True)
    with open(fpath, "w", encoding="utf-8") as fh:
        for i in range(64):
            root = SpanRecord(
                trace_id="run00", span_id=f"s{i}", parent_id="",
                name="iteration", agent=f"loop-r0-{i % 8:03d}",
                worker=f"w{i % 4}", t_start=float(i),
                t_end=float(i) + 0.5, attrs={"iteration": i})
            child = SpanRecord(
                trace_id="run00", span_id=f"c{i}", parent_id=f"s{i}",
                name="wait", agent=root.agent, worker=root.worker,
                t_start=float(i) + 0.1, t_end=float(i) + 0.4,
                attrs={"iteration": i})
            fh.write(json.dumps(root.to_json()) + "\n")
            fh.write(json.dumps(child.to_json()) + "\n")

    def feed_fn() -> dict:
        return console_feed(_console_status_doc(
            CONSOLE_RUNS, per_run, tick[0], statuses))

    streams, _, out, _ = IOStreams.test()
    console = FleetConsole(streams, feed_fn, logs_dir=base)
    samples = []
    for f in range(CONSOLE_FRAMES):
        tick[0] = f
        for j in range(8):
            statuses[(j % CONSOLE_RUNS, (f + j) % per_run)] = (
                "running" if (f + j) % 5 else "done", f)
        t0 = time.perf_counter()
        console.render_once()
        samples.append((time.perf_counter() - t0) * 1000)
        out.truncate(0)
        out.seek(0)
    lines = len(console.frame_lines(feed_fn()))
    stats = console.painter.stats()
    samples.sort()
    p50 = samples[len(samples) // 2]
    p95 = samples[int(len(samples) * 0.95) - 1]
    ratio = stats["rows_painted"] / max(1, stats["rows_total"])
    check(p95 < CONSOLE_REPAINT_BUDGET_MS and lines <= CONSOLE_FRAME_LINE_BOUND,
          f"{name}: p95 {p95} ms (budget {CONSOLE_REPAINT_BUDGET_MS}), "
          f"frame {lines} lines (bound {CONSOLE_FRAME_LINE_BOUND})")
    print(card_line())
    print(f"{name} fleet console repaint, host work on the chip host's CPU "
          f"(no device time): {CONSOLE_AGENTS} agents over {CONSOLE_RUNS} "
          f"runs, {CONSOLE_FRAMES} frames: frame p50 {p50!r} ms, p95 "
          f"{p95!r} ms (budget {CONSOLE_REPAINT_BUDGET_MS}), frame {lines} "
          f"lines (bound {CONSOLE_FRAME_LINE_BOUND}), damage ratio {ratio!r}"
          f" ({stats['rows_painted']} of {stats['rows_total']} rows)")


def views_phase(device) -> collections.Counter:
    """Drives the live views of a run -- the loop dashboard, the fleet
    console, the metrics scrape and the OTLP lane -- over the sentinel
    scoring on the card; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "views"
    total = collections.Counter()
    t0 = time.perf_counter()
    with stage_timers({}) as stages:
        total.update(views_dashboard_case(out / "a", device, stages))
    views_cli_case(out / "b", device)
    with stage_timers({}) as stages:
        total.update(views_loopd_case(out / "c", device, stages))
    with stage_timers({}) as stages:
        total.update(views_export_case(out / "d", device, stages))
    views_repaint_case(out / "e")
    no_daemon_left()
    print(f"views launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# --------------------------------------------------------- engines phase


ENGINES_SETTINGS = ("loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
                    "    hard_free_pct: 0.0005\n")
ENGINES_LOCAL = "local-0"       # the local driver's one worker
BENCH_DIAL_DELAY_S = 0.01       # bench.py:1828's per-dial delay
BENCH_DIAL_REDUCTION_MIN = 2.0  # its docstring's bar
HARNESS_SETTINGS = {"enabledPlugins": {"chip-smoke@local": True},
                    "apiKey": "not-for-the-container"}
HARNESS_MEMORY = b"# chip smoke: the user's global memory\n"
HARNESS_CREDENTIALS = b'{"claudeAiOauth": {"accessToken": "tok"}}'


@contextlib.contextmanager
def _engine_daemon(base: Path):
    """A ``FakeEngineDaemon`` on a unix socket in ``base`` (a short
    temporary directory when that path is too long for AF_UNIX),
    serving a fake that holds the loop image with loop (a)'s
    behaviour; stopped on the way out."""
    import tempfile

    from clawker_tpu_torch.engine.fake import FakeDockerAPI, exit_behavior
    from clawker_tpu_torch.testenv import FakeEngineDaemon

    sock = base / "engine.sock"
    tmp = None
    if len(str(sock).encode()) >= SUN_PATH_MAX:
        tmp = Path(tempfile.mkdtemp(prefix="clawker-eng-"))
        sock = tmp / "engine.sock"
    api = FakeDockerAPI()
    api.add_image(LOOP_IMAGE)
    api.set_behavior(LOOP_IMAGE, exit_behavior(b"iteration done\n", 0,
                                               delay=LOOP_ITER_S))
    daemon = FakeEngineDaemon(sock, api).start()
    try:
        yield daemon
    finally:
        daemon.stop()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def _pinned_home(home: Path):
    """HOME at ``home`` and ``CLAUDE_CONFIG_DIR`` unset (the harness
    staging expands ``${CLAUDE_CONFIG_DIR:-~/.claude}``), the harness
    tar cache dropped on the way in and out."""
    from clawker_tpu_torch.runtime.orchestrate import clear_harness_seed_cache

    saved = {k: os.environ.get(k) for k in ("HOME", "CLAUDE_CONFIG_DIR")}
    os.environ["HOME"] = str(home)
    os.environ.pop("CLAUDE_CONFIG_DIR", None)
    clear_harness_seed_cache()
    try:
        yield home
    finally:
        clear_harness_seed_cache()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _harness_home(base: Path) -> Path:
    """A home with the three host files the claude harness stages from."""
    claude = base / "home" / ".claude"
    if claude.exists():
        shutil.rmtree(claude)
    claude.mkdir(parents=True)
    (claude / "settings.json").write_text(json.dumps(HARNESS_SETTINGS))
    (claude / "CLAUDE.md").write_bytes(HARNESS_MEMORY)
    (claude / ".credentials.json").write_bytes(HARNESS_CREDENTIALS)
    return base / "home"


def _local_egress(agents: list[str], hot: str) -> list[dict]:
    """``_loop_egress`` with every record on the local driver's worker."""
    out = [r for recs in _loop_egress(agents, hot, time.time()).values()
           for r in recs]
    for r in out:
        r["worker"] = ENGINES_LOCAL
    return out


def _local_driver(daemon):
    from clawker_tpu_torch.engine.drivers import LocalDriver

    return LocalDriver(docker_host=f"unix://{daemon.sock_path}")


def _creates_by_name(daemon) -> collections.Counter:
    """Container names of the ``POST /containers/create`` requests in
    the daemon's log."""
    import urllib.parse

    return collections.Counter(
        urllib.parse.parse_qs(query).get("name", [""])[0]
        for method, path, query, _ in list(daemon.log)
        if (method, path) == ("POST", "/containers/create"))


def _placements_served(name: str, daemon, records: list[dict]) -> dict:
    """From the daemon's request log: each loop agent's placement was
    one create -- its own cold create, or the pool fill of the member it
    adopted, never both, never two -- and its container was started.
    -> the counts."""
    creates = _creates_by_name(daemon)
    adopted = {r["by"]: r["agent"] for r in records
               if r["kind"] == "pool_adopt"}
    agents = sorted({r["agent"] for r in records if r["kind"] == "placement"})
    per = {}
    for a in agents:
        cold = creates.get(f"clawker.{LOOP_PROJECT}.{a}", 0)
        fill = creates.get(f"clawker.{LOOP_PROJECT}.{adopted[a]}", 0) \
            if a in adopted else 0
        per[a] = (cold, fill)
    check(per and all(cold + fill == 1 for cold, fill in per.values()),
          f"{name}: (cold creates, adopted pool fills) per agent {per}")
    started = collections.Counter(
        path.split("/")[2] for method, path, _, _ in list(daemon.log)
        if method == "POST" and path.endswith("/start")
        and path.startswith("/containers/"))
    cids = collections.defaultdict(set)
    for r in records:
        if r["kind"] == "created" and r.get("cid"):
            cids[r["agent"]].add(r["cid"])
    starts = {a: started.get(f"clawker.{LOOP_PROJECT}.{a}", 0)
              + sum(started.get(c, 0) for c in cids[a]) for a in agents}
    check(all(n >= 1 for n in starts.values()),
          f"{name}: container starts per agent {starts}")
    return {"cold": sum(c for c, _ in per.values()),
            "adopted": sum(f for _, f in per.values()),
            "starts": sum(starts.values())}


def _engine_spans(name: str, sched) -> tuple[int, str]:
    """The run's flight record holds ``engine.request`` spans, each a
    child of a span of the run's trace; a flight record the disk ladder
    sheds is reported, not failed.  -> (spans, note)."""
    from clawker_tpu_torch.telemetry import load_spans

    if sched.pressure is not None and sched.pressure.is_shedding("flight"):
        return 0, "flight record shed by the disk-pressure ladder"
    spans = load_spans(sched.flight.path.read_text().splitlines())
    eng = [sp for sp in spans if sp.name == "engine.request"]
    ids = {sp.span_id for sp in spans}
    orphans = [(sp.attrs.get("verb"), sp.attrs.get("path"), sp.parent_id)
               for sp in eng if sp.trace_id != sched.loop_id
               or sp.parent_id not in ids]
    check(eng and not orphans,
          f"{name}: {len(eng)} engine.request spans, {len(orphans)} without "
          f"a parent in run {sched.loop_id}'s trace: {orphans[:5]}; span "
          f"kinds {collections.Counter(sp.name for sp in spans)}")
    verbs = collections.Counter(sp.attrs.get("verb") for sp in eng)
    return len(eng), f"verbs {dict(verbs)}"


def engines_loop_case(base: Path, device, stages: dict, home: Path):
    """(a): loop (a)'s shape over ``LocalDriver`` and the daemon's unix
    socket -- 8 loops x 3 iterations on the one worker, the reference's
    default warm pool depth, the sentinel on the card, one hot agent in
    the egress."""
    from clawker_tpu_torch.analytics.runtime import ANOMALY_Z
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec
    from clawker_tpu_torch.sentinel import FleetSentinel
    from clawker_tpu_torch.util import phases

    name = "engines (a)"
    with _pinned_home(home), _isolated_dirs(base, ENGINES_SETTINGS) as proj, \
            _engine_daemon(base) as daemon:
        cfg = load_config(proj)
        drv = _local_driver(daemon)
        sched = LoopScheduler(cfg, drv, LoopSpec(
            parallel=LOOP_AGENTS, iterations=LOOP_ITERATIONS,
            warm_pool_depth=RESUME_POOL_DEPTH))
        members = sched.prefill_pool(timeout=30.0)
        s = FleetSentinel(cfg, drv, run_id=sched.loop_id, device=device,
                          interval_s=LOOP_TICK_S, train_steps=SENTINEL_STEPS)
        log = TickLog(s, stages)
        sched.attach_sentinel(s)
        agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
        hot = agents[LOOP_HOT_SLOT]
        _clear_of_minute_end(LIVE_RUN_MARGIN_S)
        egress = _local_egress(agents, hot)
        phases.enable()
        t0 = time.perf_counter()
        try:
            s.start()
            sched.start()
            _append(cfg.logs_dir / f"ebpf-egress-{ENGINES_LOCAL}.jsonl",
                    egress)
            sched.run(poll_s=0.05)
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            counts = phases.counts()
            phases.disable()
        _wait(lambda: s._scored_at[0] >= len(egress), 10, LOOP_TICK_S)
        s.stop()
        sched.events.flush()
        rows = sched.status()
        flags = {f["agent"] for f in s.flags()}
        stats = drv.engine().pool_stats()
        spans, span_note = _engine_spans(name, sched)
        records = _journal_records(cfg, sched.loop_id)
        served = _placements_served(name, daemon, records)
        sched.cleanup(remove_containers=True)
        drv.close()
        requests, unrouted = daemon.requests, list(daemon.unrouted)
        routes = collections.Counter(daemon.routes)
    scored = log.check_run(name)
    _check_loop_rows(name, rows)
    check(not unrouted, f"{name}: requests the daemon has no route for: "
          f"{unrouted}")
    check(stats["reuses"] > 0 and stats["stale_retries"] == 0,
          f"{name}: the client's pool {stats}")
    check(members == RESUME_POOL_DEPTH and served["adopted"] >= 1,
          f"{name}: {members} pool members prefilled, placements {served}")
    zs = {r["agent"]: r["anomaly_z"] for r in rows}
    container = f"clawker.{LOOP_PROJECT}.{hot}"
    check(zs[hot] >= ANOMALY_Z and max(zs, key=zs.get) == hot
          and (container in flags or hot in flags),
          f"{name}: {hot} z {zs[hot]} (threshold {ANOMALY_Z}, hottest "
          f"{max(zs, key=zs.get)}), flags {sorted(flags)}")
    check(counts.get("harness_seed.tar_cache_hit", 0) > 0,
          f"{name}: harness seed cache {counts}")
    dedicated = sum(routes[r] for r in ("container_wait", "container_stop",
                                        "container_remove", "put_archive"))
    print(card_line())
    print(f"{name} {LOOP_AGENTS} loops x {LOOP_ITERATIONS} iterations "
          f"({LOOP_ITER_S} s each) on {ENGINES_LOCAL} over a unix socket "
          f"(LocalDriver -> FakeEngineDaemon), warm pool "
          f"{RESUME_POOL_DEPTH} (prefilled), the sentinel every "
          f"{LOOP_TICK_S} s: run "
          f"wall {wall!r} ms; {requests} requests served ({requests - dedicated}"
          f" unary on the pool, {dedicated} wait/stop/remove/put_archive on "
          f"dedicated sockets), client pool {stats}; placements {served}; "
          f"harness seed cache hits {counts.get('harness_seed.tar_cache_hit')}"
          f" misses {counts.get('harness_seed.tar_cache_miss')}; "
          f"{spans} engine.request spans ({span_note}); {len(log.ticks)} "
          f"ticks, {len(scored)} scored; {hot} z {zs[hot]}")
    print(f"{name}: {log.stage_line()}")
    return log.launches()


def engines_staging_case(base: Path, home: Path) -> None:
    """(b): one agent created through ``LocalDriver`` with HOME at a
    home holding the claude harness's three host files: the archive the
    daemon received at the container home holds settings.json with
    only ``enabledPlugins``, CLAUDE.md byte for byte and no credentials
    -- and, with settings ``credentials.stage: true``, the credentials
    too."""
    import io
    import tarfile

    from clawker_tpu_torch import consts
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.runtime.orchestrate import AgentRuntime, CreateOptions

    name = "engines (b)"
    out = {}
    for stage in (False, True):
        settings = ENGINES_SETTINGS + ("credentials:\n  stage: true\n"
                                       if stage else "")
        case = base / ("stage" if stage else "default")
        with _pinned_home(home), \
                _isolated_dirs(case, settings, proxy=False) as proj, \
                _engine_daemon(case) as daemon:
            drv = _local_driver(daemon)
            rt = AgentRuntime(drv.engine(), load_config(proj))
            t0 = time.perf_counter()
            cid = rt.create(CreateOptions(agent="dev",
                                          workspace_mode="snapshot"))
            create_ms = (time.perf_counter() - t0) * 1e3
            tar = daemon.api.containers[cid].archives.get(
                consts.CONTAINER_HOME)
            puts = [r for r in daemon.log if r[0] == "PUT"
                    and r[2] == "path=%2Fhome%2Fagent"]
            rt.engine.remove_container(cid, force=True)
            drv.close()
        check(tar and len(puts) == 1,
              f"{name}: archive at {consts.CONTAINER_HOME}: "
              f"{len(tar or b'')} bytes, puts {puts}")
        tf = tarfile.open(fileobj=io.BytesIO(tar))
        files = {m.name: tf.extractfile(m).read() for m in tf.getmembers()
                 if m.isfile()}
        check(json.loads(files.get(".claude/settings.json", b"{}"))
              == {"enabledPlugins": HARNESS_SETTINGS["enabledPlugins"]},
              f"{name}: staged settings.json {files.get('.claude/settings.json')}")
        check(files.get(".claude/CLAUDE.md") == HARNESS_MEMORY,
              f"{name}: staged CLAUDE.md {files.get('.claude/CLAUDE.md')!r}")
        creds = files.get(".claude/.credentials.json")
        check(creds == (HARNESS_CREDENTIALS if stage else None),
              f"{name}: credentials staged {creds!r} with "
              f"credentials.stage {stage}")
        out[stage] = (sorted(files), len(tar), create_ms)
    print(f"{name} harness staging through the socket: default settings "
          f"{out[False][0]} ({out[False][1]} tar bytes, create "
          f"{out[False][2]!r} ms), credentials.stage {out[True][0]} "
          f"({out[True][1]} bytes, create {out[True][2]!r} ms)")


def engines_resume_case(base: Path, device, stages: dict, home: Path):
    """(c): (a)'s run with its pool prefilled, killed once every loop
    finished iteration 1, resumed over a fresh ``LocalDriver`` to the
    same daemon.  Over HTTP the engine cannot relabel, so an adopted
    pool member keeps its ``pool`` epoch label and the journal's
    container id decides."""
    from clawker_tpu_torch import consts
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec
    from clawker_tpu_torch.sentinel import FleetSentinel

    name = "engines (c)"
    with _pinned_home(home), _isolated_dirs(base, ENGINES_SETTINGS) as proj, \
            _engine_daemon(base) as daemon:
        cfg = load_config(proj)
        drv1 = _local_driver(daemon)
        check(not drv1.engine().supports_relabel,
              f"{name}: the HTTP engine claims an in-place relabel")

        def sentinel(drv, run_id: str):
            s = FleetSentinel(cfg, drv, run_id=run_id, device=device,
                              interval_s=LOOP_TICK_S,
                              train_steps=SENTINEL_STEPS)
            return s, TickLog(s, stages)

        sched1 = LoopScheduler(cfg, drv1, LoopSpec(
            parallel=LOOP_AGENTS, iterations=LOOP_ITERATIONS,
            warm_pool_depth=RESUME_POOL_DEPTH))
        members = sched1.prefill_pool(timeout=30.0)
        check(members == RESUME_POOL_DEPTH,
              f"{name}: prefill_pool filled {members} members")
        agents = [sched1._agent_name(i) for i in range(LOOP_AGENTS)]
        log_path = cfg.logs_dir / f"ebpf-egress-{ENGINES_LOCAL}.jsonl"
        sen1, log1 = sentinel(drv1, sched1.loop_id)
        sched1.attach_sentinel(sen1)
        sen1.start()
        sched1.start()
        _append(log_path, _local_egress(agents, agents[LOOP_HOT_SLOT]))
        _kill_after_iteration_1(sched1)
        check(_wait(lambda: any(e[0] for e in log1.ticks), 10),
              f"{name}: generation 1's sentinel scored no tick")
        sen1.stop()
        image = _journal_image(cfg, sched1.loop_id)
        n_at_kill = len(_journal_records(cfg, sched1.loop_id))
        creates_at_kill = _creates_by_name(daemon)
        pool_epoch = {c.name.removeprefix(f"clawker.{LOOP_PROJECT}."): c.id
                      for c in list(daemon.api.containers.values())
                      if c.labels.get(consts.LABEL_LOOP_EPOCH)
                      == consts.POOL_EPOCH and ".loop-" in c.name}
        held = sorted(a for a, cid in pool_epoch.items()
                      if a in image.loops
                      and image.loops[a].container_id == cid)
        drv1.close()
        drv2 = _local_driver(daemon)
        t0 = time.perf_counter()
        sched2 = LoopScheduler.resume(cfg, drv2, image)
        sen2, log2 = sentinel(drv2, sched1.loop_id)
        sched2.attach_sentinel(sen2)
        summary = sched2.reconcile()
        reconcile_ms = (time.perf_counter() - t0) * 1e3
        kept = sorted(a for a in held
                      if pool_epoch[a] in daemon.api.containers)
        sen2.start()
        _append(log_path, _local_egress(agents, agents[RESUME_HOT2_SLOT]))
        sched2.run(poll_s=0.05)
        want = 2 * len(_local_egress(agents, agents[0]))
        _wait(lambda: sen2._scored_at[0] >= want, 10, LOOP_TICK_S)
        sen2.stop()
        records = _journal_records(cfg, sched1.loop_id)
        served = _placements_served(name, daemon, records)
        dup = {n: k for n, k in (_creates_by_name(daemon)
                                 - creates_at_kill).items()
               if any(n.endswith("." + a) for a in held)}
        rows = sched2.status()
        sched2.cleanup(remove_containers=True)
        drv2.close()
        unrouted = list(daemon.unrouted)
    _check_loop_rows(name, rows)
    check(not unrouted, f"{name}: unrouted requests {unrouted}")
    check(kept and not dup,
          f"{name}: adopted rows still labelled with the pool epoch and "
          f"held by the journal {held}, kept by reconcile {kept}, creates "
          f"after the kill for them {dup} (summary {summary})")
    check(summary["ghosts"] == 0 and summary["adopted"] + summary[
        "exits_accounted"] + summary["continued"] > 0,
          f"{name}: reconcile summary {summary}")
    scored1 = log1.check_run(f"{name} generation 1")
    scored2 = log2.check_run(f"{name} generation 2")
    print(f"{name} warm pool over HTTP (no in-place relabel), {members} "
          f"members prefilled, killed after iteration 1: reconcile "
          f"{summary} in {reconcile_ms!r} ms over a fresh LocalDriver; "
          f"pool-epoch rows taken as the journal's containers {kept}; "
          f"{len(records) - n_at_kill} journal records after the kill, "
          f"placements over both generations {served}; "
          f"{len(scored1)} + {len(scored2)} scored ticks")
    return log1.launches() + log2.launches()


def engines_cli_case(base: Path, device: str) -> None:
    """(d): ``loop -p 4 -n 2 --sentinel --json`` forked on default
    settings with ``DOCKER_HOST`` at the daemon and no
    ``CLAWKER_TPU_DRIVER``: exit 0, its creates served; at an absent
    socket: exit 1 with the reference's text and no request; then
    ``loopd start`` on default settings with ``sentinel.enable`` against
    the daemon hosts a run of 4 loops with a scored daemon tick, and
    ``loopd stop``."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.loopd import socket_path
    from clawker_tpu_torch.monitor.ledger import FLIGHT_DIR

    name = "engines (d)"

    def env_for(host: str) -> dict:
        env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
                   DOCKER_HOST=host, PYTHONPATH=str(ROOT))
        for k in ("CLAWKER_TPU_DRIVER", "CLAWKER_TPU_FAKE_IMAGES"):
            env.pop(k, None)
        return env

    def egress(cfg, tag: str) -> None:
        agents = [f"{tag}-{i}" for i in range(LOOP_WINDOWS)]
        cfg.logs_dir.mkdir(parents=True, exist_ok=True)
        _append(cfg.logs_dir / f"ebpf-egress-{ENGINES_LOCAL}.jsonl",
                _local_egress(agents, agents[-1]))

    settings = (f"sentinel:\n  interval_s: {LOOP_CLI_TICK_S}\n"
                + ENGINES_SETTINGS)
    with _isolated_dirs(base / "loop", settings) as proj, \
            _engine_daemon(base / "loop") as daemon:
        egress(load_config(proj), "cli")
        run, run_ms = _cli(["loop", "-p", "4", "-n", "2", "--sentinel",
                            "--json"], proj,
                           env_for(f"unix://{daemon.sock_path}"))
        check(run.returncode == 0,
              f"{name}: loop exited {run.returncode}: {run.stderr[-2000:]}")
        doc = json.loads(run.stdout)
        creates = daemon.routes["container_create"]
        before = daemon.requests
        absent = base / "loop" / "absent.sock"
        gone, gone_ms = _cli(["loop", "-p", "4", "-n", "2", "--sentinel",
                              "--json"], proj, env_for(f"unix://{absent}"))
        after = daemon.requests
    text = f"Docker socket {absent} not found -- is the Docker daemon running?"
    check(len(doc["agents"]) == 4
          and all(a["status"] == "done" and a["iteration"] == 2
                  and a["worker"] == ENGINES_LOCAL for a in doc["agents"]),
          f"{name}: agents {doc['agents']}")
    check(creates >= 4, f"{name}: the daemon served {creates} creates")
    check(gone.returncode == 1 and text in gone.stderr and after == before,
          f"{name}: at an absent socket exited {gone.returncode} "
          f"({gone.stderr[-1000:]!r}), the daemon saw "
          f"{after - before} requests")
    with _isolated_dirs(base / "loopd", LOOPD_SETTINGS) as proj, \
            _engine_daemon(base / "loopd") as daemon:
        cfg = load_config(proj)
        egress(cfg, "daemon")
        env = env_for(f"unix://{daemon.sock_path}")
        flight = cfg.logs_dir / FLIGHT_DIR / "loopd-loopd.jsonl"
        start, start_ms = _cli(["loopd", "start"], proj, env)
        try:
            check(start.returncode == 0,
                  f"{name}: loopd start exited {start.returncode}: "
                  f"{start.stderr[-2000:]} {start.stdout[-2000:]}")
            hosted, hosted_ms = _cli(["loop", "-p", "4", "-n", "2", "--json"],
                                     proj, env)
            check(hosted.returncode == 0 and "daemon-owned" in hosted.stderr,
                  f"{name}: loop under loopd exited {hosted.returncode}: "
                  f"{hosted.stderr[-2000:]}")
            hdoc = json.loads(hosted.stdout)
            ticks = []
            deadline = time.perf_counter() + 30
            while not ticks and time.perf_counter() < deadline:
                if flight.exists():
                    ticks = [json.loads(line) for line in
                             flight.read_text().splitlines()
                             if '"sentinel.tick"' in line]
                time.sleep(0.1)
        finally:
            stop, stop_ms = _cli(["loopd", "stop"], proj, env)
        check(stop.returncode == 0 and not socket_path(cfg).exists(),
              f"{name}: loopd stop exited {stop.returncode}: "
              f"{stop.stderr[-2000:]}")
        loopd_creates = daemon.routes["container_create"]
    check(len(hdoc["agents"]) == 4
          and all(a["status"] == "done" for a in hdoc["agents"])
          and loopd_creates >= 4,
          f"{name}: loopd's run {hdoc['agents']}, {loopd_creates} creates")
    check(ticks and all(t["attrs"]["device"].startswith(device)
                        for t in ticks),
          f"{name}: scored ticks in loopd's flight record: "
          f"{[t['attrs'] for t in ticks]}")
    print(f"{name} forked on default settings over DOCKER_HOST: loop "
          f"--sentinel {run_ms!r} ms, {creates} creates served; at an "
          f"absent socket exit 1 in {gone_ms!r} ms, no request; loopd start "
          f"{start_ms!r} ms, a hosted run of 4 loops {hosted_ms!r} ms "
          f"({loopd_creates} creates), its first scored daemon tick on "
          f"{ticks[0]['attrs']['device']} over "
          f"{ticks[0]['attrs']['windows']} windows, loopd stop "
          f"{stop_ms!r} ms")


def bench_engine_dials(per_dial_delay: float = BENCH_DIAL_DELAY_S) -> dict:
    """The reference bench's ``bench_engine_dials`` (bench.py:1828-1895)
    over the port: the unary daemon calls of one create + start
    (``AgentRuntime`` over the fake driver) replayed through the port's
    ``HTTPDockerAPI`` over its ``StubDockerDaemon``, each dial paying
    ``per_dial_delay``, once pooled and once dial-per-request
    (``pool_max_idle=0``).  Host work: no kernel runs."""
    import tempfile

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.httpapi import (HTTPDockerAPI,
                                                  unix_socket_factory)
    from clawker_tpu_torch.runtime.orchestrate import (AgentRuntime,
                                                       CreateOptions)
    from clawker_tpu_torch.testenv import StubDockerDaemon, TestEnv

    non_unary = {"container_attach", "container_logs", "events", "exec_start",
                 "image_build", "image_build_buildkit", "image_pull",
                 "session_attach", "close", "close_events"}
    with TestEnv() as tenv:
        proj = tenv.base / "proj"
        tenv.make_project(proj, "project: benchdials\n")
        cfg = load_config(proj)
        driver = FakeDriver()
        driver.api.add_image("clawker-benchdials:default")
        rt = AgentRuntime(driver.engine(), cfg)
        cid = rt.create(CreateOptions(agent="a0", workspace_mode="snapshot"))
        rt.start(cid)
        unary = [(n, a, k) for n, a, k in driver.api.calls
                 if n not in non_unary and hasattr(HTTPDockerAPI, n)]

    with tempfile.TemporaryDirectory(prefix="clawker-bench-dials-") as td:
        sock = Path(td) / "stub.sock"
        daemon = StubDockerDaemon(sock).start()
        try:
            def replay(pooled: bool) -> tuple[int, float, dict]:
                base = unix_socket_factory(sock)
                dials = [0]

                def counting_factory():
                    dials[0] += 1
                    time.sleep(per_dial_delay)
                    return base()

                api = HTTPDockerAPI(counting_factory,
                                    pool_max_idle=None if pooled else 0)
                t0 = time.perf_counter()
                for name, args, kw in unary:
                    if name == "put_archive":  # fake records (cid, path) only
                        api.put_archive(args[0], args[1], b"")
                    else:
                        getattr(api, name)(*args, **kw)
                wall = time.perf_counter() - t0
                stats = api.pool_stats()
                api.close()
                return dials[0], wall, stats

            dials_pooled, wall_pooled, stats = replay(True)
            dials_per_req, wall_per_req, _ = replay(False)
        finally:
            daemon.stop()
    return {
        "unary_calls": len(unary),
        "dials_pooled": dials_pooled,
        "dials_per_request": dials_per_req,
        "dial_reduction": dials_per_req / max(dials_pooled, 1),
        "reuses": stats["reuses"],
        "stale_retries": stats["stale_retries"],
        "per_dial_delay_s": per_dial_delay,
        "wall_pooled_s": wall_pooled,
        "wall_per_request_s": wall_per_req,
    }


def engines_dials_case() -> None:
    """(e): the reference bench's dial count through the port's client."""
    doc = bench_engine_dials()
    check(doc["dial_reduction"] >= BENCH_DIAL_REDUCTION_MIN,
          f"engines (e): dial_reduction {doc['dial_reduction']} under "
          f"{BENCH_DIAL_REDUCTION_MIN} ({doc})")
    print(f"engines (e) bench_engine_dials (host work, no kernel): "
          f"{json.dumps(doc)}")


def engines_phase(device) -> collections.Counter:
    """Drives ``loop`` and loopd on the ``local`` driver over a real
    Docker-API socket (the port's test daemon), the harness staging of
    a create and the client's keep-alive pool, with the sentinel
    scoring on the card; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "engines"
    total = collections.Counter()
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    home = _harness_home(out)
    with stage_timers({}) as stages:
        total.update(engines_loop_case(out / "a", device, stages, home))
    engines_staging_case(out / "b", home)
    with stage_timers({}) as stages:
        total.update(engines_resume_case(out / "c", device, stages, home))
    engines_cli_case(out / "d", device)
    engines_dials_case()
    no_daemon_left()
    print(f"engines launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# -------------------------------------------------------------- pod phase


POD_HOSTS = ("w0", "w1", "w2", "w3")
POD_TOPOLOGY = "2x2"
POD_HOT_WORKER = 2              # the hot agent's egress lands on w2 only
POD_FAIL_ITERATIONS, POD_FAIL_ITER_S = 4, 0.5
POD_WAN_S = 0.05                # (e): a fake WAN, each seam call delayed
POD_DIAL_REPS = 5
POD_DIAL_SLACK_MS = 500.0       # (e): concurrent dial bound's slack
POD_SETTINGS = (ENGINES_SETTINGS + "runtime:\n  driver: tpu_vm\n  tpu:\n"
                f"    workers: [{', '.join(POD_HOSTS)}]\n"
                f"    topology: {POD_TOPOLOGY}\n")
# a worker's own paths, under its root (the ssh user's home)
POD_EGRESS = "home/clawker/.local/state/clawker-tpu/logs/ebpf-egress.jsonl"
POD_WORKERD = "home/clawker/.local/state/clawker-tpu/workerd/workerd.sock"


def _seam_left(shim, wait_s: float = 5.0) -> list[int]:
    """The seam's processes still running after ``wait_s`` at most."""
    _wait(lambda: not shim.live_pids(), wait_s, 0.05)
    return shim.live_pids()


@contextlib.contextmanager
def _pod(iter_s: float = LOOP_ITER_S, down=()):
    """Four worker hosts ``w0``..``w3`` on the loopback ssh
    (``testenv.install_ssh_shim``), first on ``PATH``: each a root under
    a short temporary dir with its own ``FakeEngineDaemon`` at
    ``<root>/var/run/docker.sock`` (the loop image, ``iter_s`` an
    iteration); hosts in ``down`` are down from the start.  Every daemon
    stops on the way out, and no seam process may be left."""
    import tempfile
    from types import SimpleNamespace

    from clawker_tpu_torch.engine.fake import FakeDockerAPI, exit_behavior
    from clawker_tpu_torch.testenv import FakeEngineDaemon, install_ssh_shim

    base = Path(tempfile.mkdtemp(prefix="p", dir="/tmp"))
    roots = {h: base / h for h in POD_HOSTS}
    shim = install_ssh_shim(base / "bin", roots)
    path = os.environ.get("PATH", "")
    os.environ["PATH"] = shim.env()["PATH"]
    for i in down:
        shim.set_down(POD_HOSTS[i])
    daemons = []
    try:
        for root in roots.values():
            api = FakeDockerAPI()
            api.add_image(LOOP_IMAGE)
            api.set_behavior(LOOP_IMAGE, exit_behavior(
                b"iteration done\n", 0, delay=iter_s))
            daemons.append(FakeEngineDaemon(root / "var/run/docker.sock",
                                            api).start())
        yield SimpleNamespace(shim=shim, roots=list(roots.values()),
                              daemons=daemons)
    finally:
        for d in daemons:
            d.stop()
        os.environ["PATH"] = path
        left = _seam_left(shim)
        for pid in left:        # a case that failed may leave forwards
            os.kill(pid, signal.SIGKILL)
        # a worker's own daemons: their home or their cwd under its root
        prefix = str(base) + "/"
        on_workers = _procs(lambda env, cwd: cwd.startswith(prefix) or (
            f"\0HOME={prefix}".encode() in b"\0" + env))
        _kill(on_workers)
        shutil.rmtree(base, ignore_errors=True)
    check(not left, f"pod: seam processes left after the case: {left}")
    check(not on_workers,
          f"pod: processes left on the workers after the case: {on_workers}")


def _pod_egress(roots: list[Path], agents: list[str], hot: str) -> int:
    """(6)'s egress of ``agents`` on each loop's worker file (agent i
    on ``w(i % 4)``), the hot agent's, burst and all, on ``w2``'s only,
    written where the worker's netlogger writes it; the records carry
    no ``worker``: the remote tail tags each with its worker.  -> the
    records written."""
    index = {f"clawker.{LOOP_PROJECT}.{a}": i for i, a in enumerate(agents)}
    by = collections.defaultdict(list)
    n = 0
    for recs in _loop_egress(agents, hot, time.time()).values():
        for r in recs:
            r.pop("worker", None)
            i = index[r["container"]]
            by[POD_HOT_WORKER if agents[i] == hot
               else i % len(roots)].append(r)
            n += 1
    for w, recs in by.items():
        path = roots[w] / POD_EGRESS
        path.parent.mkdir(parents=True, exist_ok=True)
        _append(path, recs)
    return n


def _seam_kinds(shim) -> collections.Counter:
    """The seam's invocations by (kind, host): ``L docker``, ``L
    workerd``, ``R``, ``probe`` (a reverse forward's readiness),
    ``tail``, ``true``, ``O`` (the mux exit), ``refused``."""
    out = collections.Counter()
    for r in shim.invocations():
        kind, cmd = r["kind"], r.get("cmd") or ""
        if kind == "L":
            kind = "L " + ("workerd" if "workerd.sock" in " ".join(r["argv"])
                           else "docker")
        elif kind == "cmd":
            kind = ("tail" if cmd.startswith("tail -n +1 -F ")
                    else "probe" if "/dev/tcp/" in cmd
                    else "true" if cmd == "true" else "refused")
        out[(kind, r["host"])] += 1
    return out


def _by_kind(kinds: collections.Counter) -> dict:
    out = collections.Counter()
    for (kind, _), n in kinds.items():
        out[kind] += n
    return dict(sorted(out.items()))


def _pod_sentinel(cfg, drv, sched, device, stages: dict):
    """The sentinel on the card over the pod, wired by ``wire_fleet``
    (one remote ``tail -F`` a worker) and attached to ``sched``: ->
    (sentinel, its TickLog)."""
    from clawker_tpu_torch.sentinel import FleetSentinel

    s = FleetSentinel(cfg, drv, run_id=sched.loop_id, device=device,
                      interval_s=LOOP_TICK_S, train_steps=SENTINEL_STEPS)
    log = TickLog(s, stages)
    sched.attach_sentinel(s)
    return s, log


def _settle(s, n: int) -> None:
    """Until the sentinel scored a tick over all ``n`` records the
    remote tails carried."""
    _wait(lambda: s.collector.total() >= n and s._scored_at[0] >= n, 15,
          LOOP_TICK_S)


def pod_loop_case(base: Path, device, stages: dict):
    """(a): loop (a)'s shape over ``get_driver`` on ``runtime.driver:
    tpu_vm`` (``TPUVMDriver``, its real ``Runner``) and the four-worker
    pod, the host proxy on, the sentinel on the card tailing every
    worker over its ssh, one hot agent whose egress is on ``w2`` only."""
    from clawker_tpu_torch.analytics.runtime import ANOMALY_Z
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import get_driver
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec

    name = "pod (a)"
    with _isolated_dirs(base, POD_SETTINGS) as proj, _pod() as p:
        cfg = load_config(proj)
        drv = get_driver(cfg.settings)
        check(type(drv).__name__ == "TPUVMDriver",
              f"{name}: get_driver built {type(drv).__name__}")
        sched = LoopScheduler(cfg, drv, LoopSpec(parallel=LOOP_AGENTS,
                                                 iterations=LOOP_ITERATIONS))
        t0 = time.perf_counter()
        s, log = _pod_sentinel(cfg, drv, sched, device, stages)
        dial_ms = (time.perf_counter() - t0) * 1e3
        agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
        hot = agents[LOOP_HOT_SLOT]
        s.start()
        sched.start()
        n = _pod_egress(p.roots, agents, hot)
        sched.run(poll_s=0.05)
        wall = (time.perf_counter() - t0) * 1e3
        _settle(s, n)
        s.stop()
        rows = sched.status()
        srows = {r["agent"]: r for r in s.rows()}
        flags = {f["agent"] for f in s.flags()}
        counts = s.collector.counts()
        sched.cleanup(remove_containers=True)
        drv.close()
        left = _seam_left(p.shim)
        kinds = _seam_kinds(p.shim)
        served = [dict(d.routes) for d in p.daemons]
        requests = [d.requests for d in p.daemons]
        unrouted = [list(d.unrouted) for d in p.daemons]
    scored = log.check_run(name)
    _check_loop_rows(name, rows)
    check(not any(unrouted), f"{name}: unrouted requests {unrouted}")
    check(all(r.get("container_create", 0) >= 1
              and r.get("container_start", 0) >= 1 for r in served),
          f"{name}: creates/starts per worker's daemon "
          f"{[(r.get('container_create'), r.get('container_start')) for r in served]}")
    for kind in ("L docker", "R", "tail"):
        per = [kinds[(kind, h)] for h in POD_HOSTS]
        check(per == [1] * len(POD_HOSTS),
              f"{name}: {kind} per worker {per} (want one each)")
    check(all(kinds[("probe", h)] >= 1 for h in POD_HOSTS),
          f"{name}: reverse-forward probes {dict(kinds)}")
    check(set(counts) == {f"tpu-{i}" for i in range(len(POD_HOSTS))},
          f"{name}: the sentinel's records by worker {counts}")
    # the sentinel's own rows: a loop row's z is its behaviour window's
    # when the run crossed into a minute its egress does not cover
    zs = {a: r["latest_z"] for a, r in srows.items()}
    container = f"clawker.{LOOP_PROJECT}.{hot}"
    hottest = max(zs, key=zs.get) if zs else None
    check(zs.get(container, 0) >= ANOMALY_Z and hottest == container
          and container in flags
          and srows[container]["worker"] == f"tpu-{POD_HOT_WORKER}",
          f"{name}: {container} (threshold {ANOMALY_Z}, hottest "
          f"{hottest}), flags {sorted(flags)}, its row "
          f"{srows.get(container)}")
    check(not left, f"{name}: seam processes after driver.close(): {left}")
    print(card_line())
    print(f"{name} {LOOP_AGENTS} loops x {LOOP_ITERATIONS} iterations "
          f"({LOOP_ITER_S} s each) over TPUVMDriver and the loopback ssh "
          f"on {len(POD_HOSTS)} workers ({POD_TOPOLOGY}), the sentinel every "
          f"{LOOP_TICK_S} s over the remote tails: run wall {wall!r} ms "
          f"(the dial and wiring {dial_ms!r} ms of it); seam invocations "
          f"{_by_kind(kinds)}; engine requests per worker {requests}; "
          f"records per worker {dict(sorted(counts.items()))}; "
          f"{len(log.ticks)} ticks, {len(scored)} scored; {container} z "
          f"{zs[container]} on {srows[container]['worker']}")
    print(f"{name}: {log.stage_line()}")
    return log.launches()


def _worker_env(root: Path) -> dict:
    """The environment a process on the worker at ``root`` runs in: HOME
    the ssh user's, ``DOCKER_HOST`` the worker's daemon, default
    settings."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CLAWKER_TPU_", "XDG_"))}
    env.update(HOME=str(root / "home" / "clawker"), PYTHONPATH=str(ROOT),
               DOCKER_HOST=f"unix://{root}/var/run/docker.sock")
    return env


def _stop_worker_proxies(roots: list[Path]) -> list[bool]:
    """Stop the host proxy each worker's workerd brought up (its side
    channels' ``ensure_running``, under the worker's home, a daemon
    that outlives workerd as it does on a worker VM), with the port's
    ``hostproxy.manager.stop`` run as the worker: -> whether one ran
    on each."""
    code = ("import sys; from pathlib import Path; "
            "from clawker_tpu_torch.config import load_config; "
            "from clawker_tpu_torch.hostproxy import manager; "
            "sys.exit(0 if manager.stop(load_config(Path.cwd())) else 3)")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root / "proj",
                              env=_worker_env(root),
                              stdin=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
             for root in roots]
    out = []
    for root, proc in zip(roots, procs):
        _, err = proc.communicate(timeout=30)
        check(proc.returncode in (0, 3),
              f"stopping {root}'s host proxy exited {proc.returncode}: "
              f"{err.decode(errors='replace')[-1000:]}")
        out.append(proc.returncode == 0)
    return out


def _start_workerd(root: Path):
    """``python -m clawker_tpu_torch.workerd`` as the worker at ``root``
    runs it: HOME the ssh user's, ``DOCKER_HOST`` the worker's daemon,
    default settings, in a project dir of the loop's project; -> the
    process, once its socket answers."""
    from clawker_tpu_torch.workerd.executor import ping_socket

    proj = root / "proj"
    proj.mkdir(exist_ok=True)
    (proj / ".clawker.yaml").write_text(f"project: {LOOP_PROJECT}\n")
    with open(root / "workerd.log", "wb") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "clawker_tpu_torch.workerd"], cwd=proj,
            env=_worker_env(root), stdout=logf, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL)
    if not _wait(lambda: ping_socket(root / POD_WORKERD)
                 or proc.poll() is not None, 30, 0.05) \
            or proc.poll() is not None:
        proc.kill()
        proc.wait()
        check(False, f"pod (b): workerd at {root} never answered: "
              f"{(root / 'workerd.log').read_text()[-2000:]}")
    return proc


def _count_creates(drv) -> dict:
    """Wrap each worker engine's ``container_create`` (the laptop's own
    calls, never workerd's): -> worker id -> a one-item list counting
    them."""
    out = {}
    for w in drv.workers():
        api = w.engine.api
        box = out[w.id] = [0]
        real = api.container_create

        def create(*a, _real=real, _box=box, **kw):
            _box[0] += 1
            return _real(*a, **kw)

        api.container_create = create
    return out


def pod_workerd_case(base: Path, device, stages: dict):
    """(b): the port's workerd on ``w0`` and ``w1`` only, each on its
    worker's canonical socket, reached through the forward of its
    transport: discovered, live, and serving those workers' launches of
    an 8 x 2 run while ``tpu-2``/``tpu-3`` launch directly."""
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import get_driver
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec
    from clawker_tpu_torch.workerd import liveness
    from clawker_tpu_torch.workerd.executor import discover_executors

    name = "pod (b)"
    with _isolated_dirs(base, POD_SETTINGS) as proj, _pod() as p:
        procs = [_start_workerd(p.roots[i]) for i in (0, 1)]
        try:
            cfg = load_config(proj)
            drv = get_driver(cfg.settings)
            execs = discover_executors(cfg, drv)
            found = sorted(execs.executors)
            live = liveness(cfg, drv)
            laptop = _count_creates(drv)
            sched = LoopScheduler(cfg, drv, LoopSpec(parallel=LOOP_AGENTS,
                                                     iterations=2),
                                  executors=execs)
            s, log = _pod_sentinel(cfg, drv, sched, device, stages)
            agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
            t0 = time.perf_counter()
            s.start()
            sched.start()
            n = _pod_egress(p.roots, agents, agents[LOOP_HOT_SLOT])
            sched.run(poll_s=0.05)
            wall = (time.perf_counter() - t0) * 1e3
            _settle(s, n)
            s.stop()
            rows = sched.status()
            intents = {w: ex.stats["intents"]
                       for w, ex in execs.executors.items()}
            sched.cleanup(remove_containers=True)
            execs.close_all()
            drv.close()
        finally:
            for proc in procs:
                proc.terminate()
            rcs = [proc.wait(15) for proc in procs]
            proxies = _stop_worker_proxies(p.roots[:2])
        creates = [d.routes.get("container_create", 0) for d in p.daemons]
        kinds = _seam_kinds(p.shim)
    scored = log.check_run(name)
    check(found == ["tpu-0", "tpu-1"], f"{name}: executors for {found}")
    check(live["tpu-0"] == live["tpu-1"] == "live"
          and live["tpu-2"] != "live" and live["tpu-3"] != "live",
          f"{name}: liveness {live}")
    check(len(rows) == LOOP_AGENTS
          and all(r["status"] == "done" and r["iteration"] == 2
                  for r in rows), f"{name}: rows {rows}")
    placed = collections.Counter(r["worker"] for r in rows)
    check(all(placed[f"tpu-{i}"] for i in range(len(POD_HOSTS))),
          f"{name}: placements {dict(placed)}")
    direct = {w: box[0] for w, box in laptop.items()}
    check(direct["tpu-0"] == direct["tpu-1"] == 0
          and all(direct[f"tpu-{i}"] >= placed[f"tpu-{i}"] for i in (2, 3))
          and all(creates[i] >= placed[f"tpu-{i}"] for i in range(4))
          and all(intents[f"tpu-{i}"] >= placed[f"tpu-{i}"] for i in (0, 1)),
          f"{name}: the laptop's creates {direct}, the daemons' "
          f"{creates}, workerd intents {intents}, placements "
          f"{dict(placed)}")
    check([kinds[("L workerd", h)] for h in POD_HOSTS] == [1] * 4,
          f"{name}: workerd forwards {_by_kind(kinds)}")
    check(rcs == [0, 0], f"{name}: workerd exits {rcs}")
    print(f"{name} workerd on w0/w1 over forwarded sockets: executors "
          f"{found}, liveness {live}; {LOOP_AGENTS} loops x 2 run wall "
          f"{wall!r} ms, placements {dict(sorted(placed.items()))}, "
          f"workerd intents {intents}, the laptop's own creates {direct}; "
          f"a host proxy left up by workerd and stopped on w0/w1 "
          f"{proxies}; "
          f"seam invocations {_by_kind(kinds)}; {len(log.ticks)} ticks, "
          f"{len(scored)} scored")
    return log.launches()


def _pod_health(m):
    """Probes every 0.1 s; two failures open a breaker for the run."""
    return m.HealthConfig(
        probe_interval_s=0.1, probe_deadline_s=2.0,
        breaker=m.BreakerConfig(failure_threshold=2, backoff_base_s=60.0,
                                backoff_max_s=60.0, backoff_jitter=0.0,
                                half_open_successes=2))


def _probe_error(drv, worker_id: str) -> str:
    """``drv.probe`` of one worker: -> its DriverError's text, or ""."""
    from clawker_tpu_torch.errors import DriverError

    worker = next(w for w in drv.workers() if w.id == worker_id)
    try:
        drv.probe(worker)
    except DriverError as e:
        return str(e)
    return ""


def pod_failover_case(base: Path, device, stages: dict):
    """(c): an 8 x 4 run; once every loop finished iteration 1, ``w1``'s
    daemon stops (its probe reads "docker daemon unreachable but host
    ssh alive", the breaker opens, its loops fail over), then ``w3`` is
    marked down ("host unreachable over ssh"): every loop ends on
    ``tpu-0``/``tpu-2``.  Then a pod whose ``w2`` is down from the
    start: ``connect()`` gives ``tpu-2`` engine-less with its
    ``dial_error``, its breaker opens at once, and a run lands on the
    other three."""
    from clawker_tpu_torch import health
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import get_driver
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec

    name = "pod (c)"
    with _isolated_dirs(base / "dead", POD_SETTINGS) as proj, \
            _pod(iter_s=POD_FAIL_ITER_S) as p:
        cfg = load_config(proj)
        drv = get_driver(cfg.settings)
        sched = LoopScheduler(cfg, drv, LoopSpec(
            parallel=LOOP_AGENTS, iterations=POD_FAIL_ITERATIONS,
            failover="migrate"), health_config=_pod_health(health))
        s, log = _pod_sentinel(cfg, drv, sched, device, stages)
        agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
        t0 = time.perf_counter()
        s.start()
        sched.start()
        n = _pod_egress(p.roots, agents, agents[LOOP_HOT_SLOT])
        t = threading.Thread(target=sched.run, kwargs={"poll_s": 0.05},
                             daemon=True, name="pod-failover")
        t.start()
        first = _wait(lambda: all(l.iteration >= 1 for l in sched.loops), 60)
        p.daemons[1].stop()
        opened1 = _wait(lambda: sched.health.state("tpu-1")
                        == health.BREAKER_OPEN, 20)
        err1 = _probe_error(drv, "tpu-1")
        p.shim.set_down(POD_HOSTS[3])
        opened3 = _wait(lambda: sched.health.state("tpu-3")
                        == health.BREAKER_OPEN, 20)
        err3 = _probe_error(drv, "tpu-3")
        t.join(120)
        wall = (time.perf_counter() - t0) * 1e3
        _settle(s, n)
        s.stop()
        rows = sched.status()
        sched.cleanup(remove_containers=True)
        drv.close()
    check(first and not t.is_alive(), f"{name}: the run never got past "
          f"iteration 1 or never ended: "
          f"{[(l.agent, l.status, l.iteration) for l in sched.loops]}")
    check(opened1 and "docker daemon unreachable but host ssh alive" in err1,
          f"{name}: tpu-1's breaker open {opened1}, its probe {err1!r}")
    check(opened3 and "host unreachable over ssh" in err3,
          f"{name}: tpu-3's breaker open {opened3}, its probe {err3!r}")
    check(len(rows) == LOOP_AGENTS
          and all(r["status"] == "done"
                  and r["iteration"] == POD_FAIL_ITERATIONS
                  and r["worker"] in ("tpu-0", "tpu-2") for r in rows),
          f"{name}: rows {rows}")
    scored = log.check_run(name)
    with _isolated_dirs(base / "down", POD_SETTINGS) as proj, \
            _pod(down=(2,)) as p:
        cfg = load_config(proj)
        drv = get_driver(cfg.settings)
        ws = drv.connect()
        sched2 = LoopScheduler(cfg, drv, LoopSpec(parallel=6, iterations=1),
                               health_config=_pod_health(health))
        sched2.start()
        pre_open = sched2.health.state("tpu-2") == health.BREAKER_OPEN
        sched2.run(poll_s=0.05)
        rows2 = sched2.status()
        sched2.cleanup(remove_containers=True)
        drv.close()
        creates2 = [d.routes.get("container_create", 0) for d in p.daemons]
    dial_error = ws[2].meta.get("dial_error", "")
    check([w.engine is None for w in ws] == [False, False, True, False]
          and "did not come up" in dial_error,
          f"{name}: a pod with w2 down dialed "
          f"{[(w.id, w.engine is not None, w.meta) for w in ws]}")
    check(pre_open and all(r["status"] == "done"
                           and r["worker"] in ("tpu-0", "tpu-1", "tpu-3")
                           for r in rows2) and creates2[2] == 0,
          f"{name}: tpu-2's breaker open at start {pre_open}, rows {rows2}, "
          f"creates per daemon {creates2}")
    print(f"{name} {LOOP_AGENTS} loops x {POD_FAIL_ITERATIONS} iterations "
          f"({POD_FAIL_ITER_S} s each), w1's daemon stopped then w3 down: "
          f"run wall {wall!r} ms; tpu-1 {err1!r}; tpu-3 {err3!r}; final "
          f"workers {dict(collections.Counter(r['worker'] for r in rows))}; "
          f"{len(log.ticks)} ticks, {len(scored)} scored; w2 down from the "
          f"start: tpu-2 dial_error {dial_error!r}, 6 loops on "
          f"{dict(collections.Counter(r['worker'] for r in rows2))}")
    return log.launches()


def pod_cli_case(base: Path, device: str) -> None:
    """(d): the verbs forked on default settings that hold ``runtime.
    driver: tpu_vm`` and the four workers, no ``CLAWKER_TPU_DRIVER``:
    ``loop -p 8 -n 2 --sentinel --json`` exits 0 with creates on every
    worker's daemon; ``fleet workers`` lists them in pod order; a
    one-shot ``fleet anomaly`` with no loopd tails the four workers,
    scores on the card and flags the hot agent on ``tpu-2`` (exit 2);
    ``fleet provision --dry-run --no-cp`` prints the plan; ``fleet
    provision --dry-run`` prints it with the control plane's
    ``cp-unit`` and ``verify-healthz`` steps, with no ssh."""
    from clawker_tpu_torch.config import load_config

    name = "pod (d)"
    settings = f"sentinel:\n  interval_s: {LOOP_CLI_TICK_S}\n" + POD_SETTINGS
    with _isolated_dirs(base, settings) as proj, _pod() as p:
        cfg = load_config(proj)
        env = dict(os.environ, CLAWKER_TORCH_DEVICE=device,
                   PYTHONPATH=str(ROOT))
        for k in ("CLAWKER_TPU_DRIVER", "CLAWKER_TPU_FAKE_IMAGES",
                  "DOCKER_HOST"):
            env.pop(k, None)
        agents = [f"cli-{i}" for i in range(LOOP_AGENTS)]
        _pod_egress(p.roots, agents, agents[LOOP_HOT_SLOT])
        hot = f"clawker.{LOOP_PROJECT}.{agents[LOOP_HOT_SLOT]}"
        run, run_ms = _cli(["loop", "-p", "8", "-n", "2", "--sentinel",
                            "--json"], proj, env)
        creates = [d.routes.get("container_create", 0) for d in p.daemons]
        check(run.returncode == 0,
              f"{name}: loop exited {run.returncode}: {run.stderr[-2000:]}")
        doc = json.loads(run.stdout)
        workers, workers_ms = _cli(["fleet", "workers"], proj, env)
        anom, anom_ms = _cli(["fleet", "anomaly", "--format", "json"], proj,
                             env)
        dry, dry_ms = _cli(["fleet", "provision", "--dry-run", "--no-cp"],
                           proj, env)
        before = len(p.shim.invocations())
        full, full_ms = _cli(["fleet", "provision", "--dry-run"], proj, env)
        after = len(p.shim.invocations())
        kinds = _seam_kinds(p.shim)
    check(len(doc["agents"]) == 8
          and all(a["status"] == "done" and a["iteration"] == 2
                  for a in doc["agents"]) and all(c >= 1 for c in creates),
          f"{name}: agents {doc['agents']}, creates per daemon {creates}")
    check(workers.returncode == 0 and workers.stdout == "".join(
        f"{i}\t{h}\n" for i, h in enumerate(POD_HOSTS)),
        f"{name}: fleet workers exited {workers.returncode}: "
        f"{workers.stdout!r} {workers.stderr[-500:]}")
    check(anom.returncode == 2,
          f"{name}: fleet anomaly exited {anom.returncode}, want 2: "
          f"{anom.stderr[-2000:]}")
    adoc = json.loads(anom.stdout)
    arows = {r["agent"]: r for r in adoc["rows"]}
    check(hot in arows and arows[hot]["flagged"]
          and arows[hot]["worker"] == f"tpu-{POD_HOT_WORKER}"
          and set(adoc["stream_counts"]) == {f"tpu-{i}" for i in range(4)},
          f"{name}: fleet anomaly rows {adoc['rows']}, stream counts "
          f"{adoc['stream_counts']}")
    check(dry.returncode == 0 and "preflight-docker" in dry.stdout
          and "verify-healthz" not in dry.stdout,
          f"{name}: provision --dry-run --no-cp exited {dry.returncode}: "
          f"{dry.stdout[-500:]} {dry.stderr[-500:]}")
    check(full.returncode == 0 and "cp-unit" in full.stdout
          and "verify-healthz" in full.stdout
          and "-m clawker_tpu_torch.controlplane" in full.stdout
          and after == before,
          f"{name}: fleet provision --dry-run exited {full.returncode} "
          f"({full.stdout[-800:]!r} {full.stderr[-500:]!r}), "
          f"{after - before} seam invocations")
    print(f"{name} forked on default settings (runtime.driver tpu_vm): loop "
          f"--sentinel {run_ms!r} ms, creates per worker {creates}; fleet "
          f"workers {workers_ms!r} ms; fleet anomaly {anom_ms!r} ms, exit 2, "
          f"{hot} z {arows[hot]['latest_z']} on {arows[hot]['worker']}, "
          f"records {adoc['stream_counts']}; provision --dry-run --no-cp "
          f"{dry_ms!r} ms; provision --dry-run with the control plane's "
          f"steps {full_ms!r} ms, no ssh; "
          f"seam invocations {_by_kind(kinds)}")


def pod_dial_case() -> None:
    """(e): ``TPUVMDriver.connect()`` of the four-worker pod, each time
    with a fresh mux dir, ``POD_DIAL_REPS`` times with no injected delay
    and again with every seam invocation delayed ``POD_WAN_S``: the
    dial is concurrent, so the delayed connect stays under twice one
    worker's dial plus ``POD_DIAL_SLACK_MS``.  Host work, no kernel."""
    import tempfile

    import clawker_tpu_torch.fleet.transport as fleet_transport
    from clawker_tpu_torch.config.schema import TPUSettings
    from clawker_tpu_torch.engine.drivers import TPUVMDriver

    name = "pod (e)"
    real = fleet_transport.connect_worker_engine
    per: dict = {}

    def timed(tpu, host, index, *, runner=None):
        t0 = time.perf_counter()
        try:
            return real(tpu, host, index, runner=runner)
        finally:
            per[host] = (time.perf_counter() - t0) * 1e3

    saved = os.environ.get("CLAWKER_TPU_STATE_DIR")
    out = {}
    fleet_transport.connect_worker_engine = timed
    try:
        with _pod() as p:
            for delay in (0.0, POD_WAN_S):
                p.shim.set_delay(delay)
                walls, dials = [], collections.defaultdict(list)
                for _ in range(POD_DIAL_REPS):
                    state = Path(tempfile.mkdtemp(prefix="m", dir="/tmp"))
                    os.environ["CLAWKER_TPU_STATE_DIR"] = str(state)
                    per.clear()
                    drv = TPUVMDriver(TPUSettings(workers=list(POD_HOSTS)))
                    t0 = time.perf_counter()
                    ws = drv.connect()
                    walls.append((time.perf_counter() - t0) * 1e3)
                    check(all(w.engine is not None for w in ws),
                          f"{name}: a dial failed: {[w.meta for w in ws]}")
                    drv.close()
                    shutil.rmtree(state, ignore_errors=True)
                    for h, ms in per.items():
                        dials[h].append(ms)
                out[delay] = (statistics.median(walls),
                              {h: statistics.median(v)
                               for h, v in sorted(dials.items())})
            p.shim.set_delay(0.0)
    finally:
        fleet_transport.connect_worker_engine = real
        if saved is None:
            os.environ.pop("CLAWKER_TPU_STATE_DIR", None)
        else:
            os.environ["CLAWKER_TPU_STATE_DIR"] = saved
    wan_wall, wan_dials = out[POD_WAN_S]
    one = statistics.median(wan_dials.values())
    check(wan_wall < 2 * one + POD_DIAL_SLACK_MS,
          f"{name}: connect {wan_wall!r} ms with {POD_WAN_S} s a call, one "
          f"worker's dial {one!r} ms: not concurrent")
    for delay, (wall, dials) in out.items():
        print(f"{name} connect() of {len(POD_HOSTS)} workers over the "
              f"loopback ssh (host work, no kernel), {delay} s injected a "
              f"call: median of {POD_DIAL_REPS} {wall!r} ms, each worker's "
              f"forward-ready median ms {dials}")


def pod_phase(device) -> collections.Counter:
    """Drives ``loop``, workerd discovery, failover and the fleet verbs
    on the ``tpu_vm`` driver over a pod of four SSH workers on this
    machine (the loopback ssh), with the sentinel scoring on the card
    over each worker's remote tail; -> launches."""
    import tempfile

    out = Path(tempfile.mkdtemp(prefix="c", dir="/tmp"))
    total = collections.Counter()
    t0 = time.perf_counter()
    try:
        with stage_timers({}) as stages:
            total.update(pod_loop_case(out / "a", device, stages))
        with stage_timers({}) as stages:
            total.update(pod_workerd_case(out / "b", device, stages))
        with stage_timers({}) as stages:
            total.update(pod_failover_case(out / "c", device, stages))
        pod_cli_case(out / "d", device)
        pod_dial_case()
        no_daemon_left()
        no_process_left("pod")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(f"pod launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# ------------------------------------------------------------ verbs phase


VERBS_PROJECT = "verbs"
VERBS_AGENTS = tuple("abcdefgh")       # one worktree and one agent each
VERBS_HOT = "e"                        # the agent given the deny burst
VERBS_EXEC_CODE = 4                    # what ``exec`` must propagate
VERBS_FG_CODE = 3                      # the foreground run's container exit
VERBS_REPS = 5                         # (e): forked walls, median of 5
VERBS_WINDOWS = 6                      # egress minutes per agent
VERBS_PER_WINDOW = 16
VERBS_SETTINGS = ENGINES_SETTINGS + "runtime:\n  driver: local\n"
VERBS_ENV_FILE = 'VERBS_NOTE="a b"\nexport VERBS_FROM=${VERBS_NOTE}-file\n'
VERBS_ALIAS = "fleet anomaly --no-daemon --format json"
BOOTSTRAP_MEMBERS = [                  # the reference's names and modes
    ("bootstrap", 0o700), ("bootstrap/agent.crt", 0o644),
    ("bootstrap/agent.key", 0o600), ("bootstrap/ca.crt", 0o644),
    ("bootstrap/assertion.jwt", 0o600), ("bootstrap/session.key", 0o600)]
# a forked CLI process that calls the port's ``main`` with the phase
# stopwatch on, and at exit appends what it loaded and its phases'
# totals to ``$VERBS_PROBE``
VERBS_PROBE = (
    "import atexit, json, os, sys\n"
    "from clawker_tpu_torch.util import phases\n"
    "phases.enable()\n"
    "def probe():\n"
    "    with open(os.environ['VERBS_PROBE'], 'a') as f:\n"
    "        f.write(json.dumps({'argv': sys.argv[1:],\n"
    "                            'torch': 'torch' in sys.modules,\n"
    "                            'phases': phases.totals()}) + '\\n')\n"
    "atexit.register(probe)\n"
    "from clawker_tpu_torch.cli import main\n"
    "sys.exit(main(sys.argv[1:]))\n")


@contextlib.contextmanager
def _verbs_daemon(base: Path):
    """``_engine_daemon``'s socket over a fake holding the project image
    (each container prints a line and runs until stopped), an image
    whose container exits ``VERBS_FG_CODE``, and an ``exec`` that exits
    with the number its command ends in."""
    import tempfile

    from clawker_tpu_torch.engine.fake import FakeDockerAPI, exit_behavior
    from clawker_tpu_torch.testenv import FakeEngineDaemon

    def hold(io) -> int:
        io.write_stdout(b"agent up\n")
        io.kill_event.wait(600)
        return 0

    def exec_handler(c, cmd: list[str]) -> tuple[int, bytes]:
        words = " ".join(cmd)
        m = re.search(r"exit (\d+)", words)
        return (int(m.group(1)) if m else 0), f"{c.name}: {words}\n".encode()

    tmp = Path(tempfile.mkdtemp(prefix="clawker-verbs-"))
    api = FakeDockerAPI()
    api.add_image(f"clawker-{VERBS_PROJECT}:default")
    api.set_behavior(f"clawker-{VERBS_PROJECT}:default", hold)
    api.add_image(f"clawker-{VERBS_PROJECT}:exit3")
    api.set_behavior(f"clawker-{VERBS_PROJECT}:exit3", exit_behavior(
        b"exiting\n", VERBS_FG_CODE))
    api.exec_handler = exec_handler
    daemon = FakeEngineDaemon(tmp / "engine.sock", api).start()
    try:
        yield daemon
    finally:
        daemon.stop()
        shutil.rmtree(tmp, ignore_errors=True)


class _Verbs:
    """The forked verbs of one project: ``run(args)`` is one process of
    ``VERBS_PROBE`` (-> process, host ms), ``probes()`` what each left."""

    def __init__(self, proj: Path, env: dict, probe: Path):
        self.proj, self.probe = proj, probe
        self.env = dict(env, VERBS_PROBE=str(probe))
        self.ms: dict[str, list[float]] = collections.defaultdict(list)

    def run(self, args: list[str], want: int = 0, timeout: float = 300,
            stdin=None):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", VERBS_PROBE, *args],
                              cwd=self.proj, env=self.env, stdin=stdin,
                              capture_output=True, text=True, timeout=timeout)
        ms = (time.perf_counter() - t0) * 1e3
        self.ms[args[0]].append(ms)
        check(proc.returncode == want,
              f"verbs: `{' '.join(args)}` exited {proc.returncode}, want "
              f"{want}: {proc.stdout[-1000:]} {proc.stderr[-2000:]}")
        return proc, ms

    def probes(self) -> list[dict]:
        return [json.loads(line) for line in
                self.probe.read_text().splitlines()]


def _verbs_egress(cfg) -> str:
    """``synth_egress_records`` renamed onto the running agents'
    containers on ``local-0``, with the hot agent's deny burst in the
    last minute; -> the hot container's name."""
    names = [f"clawker.{VERBS_PROJECT}.{a}" for a in VERBS_AGENTS]
    hot = f"clawker.{VERBS_PROJECT}.{VERBS_HOT}"
    recs = synth_egress_records(agents=len(names), windows=VERBS_WINDOWS,
                                per_window=VERBS_PER_WINDOW)
    for r in recs:      # clawker.loop-<i> -> the i-th agent's container
        r["container"] = names[int(r["container"].rsplit("-", 1)[1])]
    recs += exfil_burst(hot, window=VERBS_WINDOWS - 1)
    for r in recs:
        r["worker"] = ENGINES_LOCAL
    cfg.logs_dir.mkdir(parents=True, exist_ok=True)
    _append(cfg.logs_dir / f"ebpf-egress-{ENGINES_LOCAL}.jsonl", recs)
    return hot


def _jwt_claims(token: bytes) -> dict:
    import base64

    payload = token.decode().split(".")[1]
    return json.loads(base64.urlsafe_b64decode(payload + "=" * (-len(payload) % 4)))


def verbs_lifecycle_case(v: _Verbs, daemon) -> dict:
    """(a), up to the running fleet: ``init``, ``project register``,
    eight worktrees, eight ``run -d --worktree --env-file``, then ``ps``,
    ``container inspect``, ``exec`` and ``logs``; -> agent -> container
    id."""
    name = "verbs (a)"
    proc, _ = v.run(["init", "--yes", "--name", VERBS_PROJECT])
    check(f"initialized project {VERBS_PROJECT!r}" in proc.stdout,
          f"{name}: init printed {proc.stdout!r}")
    proc, _ = v.run(["project", "register"])
    check(proc.stdout == f"registered {VERBS_PROJECT} -> {v.proj}\n",
          f"{name}: project register printed {proc.stdout!r}")
    (v.proj / "agent.env").write_text(VERBS_ENV_FILE)
    for a in VERBS_AGENTS:
        proc, _ = v.run(["worktree", "add", a])
        check(proc.stdout.split("\t")[::2] == [a, f"clawker/{a}\n"],
              f"{name}: worktree add {a} printed {proc.stdout!r}")
    for a in VERBS_AGENTS:
        proc, _ = v.run(["run", "-d", "--worktree", a, "--agent", a,
                         "--env-file", "agent.env"])
        check(proc.stdout == f"clawker.{VERBS_PROJECT}.{a}\n",
              f"{name}: run -d {a} printed {proc.stdout!r}")
    proc, _ = v.run(["ps", "--format", "json"])
    rows = json.loads(proc.stdout)
    check(sorted(r["name"] for r in rows)
          == [f"clawker.{VERBS_PROJECT}.{a}" for a in VERBS_AGENTS]
          and all(r["state"] == "running" and r["worker"] == ENGINES_LOCAL
                  and r["project"] == VERBS_PROJECT
                  and r["name"].endswith("." + r["agent"]) for r in rows),
          f"{name}: ps rows {rows}")
    ids = {}
    for cid, c in daemon.api.containers.items():
        labels = c.config.get("Labels") or {}
        if labels.get("dev.clawker-tpu.project") == VERBS_PROJECT:
            ids[labels["dev.clawker-tpu.agent"]] = cid
    for a in VERBS_AGENTS:
        c = daemon.api.containers[ids[a]].config
        binds = c["HostConfig"]["Binds"]
        check("VERBS_NOTE=a b" in c["Env"] and "VERBS_FROM=a b-file" in c["Env"]
              and any(f"worktrees/{VERBS_PROJECT}/{a}:/workspace" in b
                      for b in binds)
              and any(b.endswith(":ro") and "/.git" in b for b in binds),
              f"{name}: {a}'s env {c['Env']} and binds {binds}")
    proc, _ = v.run(["container", "inspect", VERBS_AGENTS[0]])
    info = json.loads(proc.stdout)
    check(info["Name"].lstrip("/") == f"clawker.{VERBS_PROJECT}.a"
          and info["State"]["Running"],
          f"{name}: inspect read {info.get('Name')} {info.get('State')}")
    proc, _ = v.run(["exec", "a", "sh", "-c", f"echo hi; exit {VERBS_EXEC_CODE}"],
                    want=VERBS_EXEC_CODE)
    check(proc.stdout == f"clawker.{VERBS_PROJECT}.a: sh -c echo hi; exit "
          f"{VERBS_EXEC_CODE}\n", f"{name}: exec printed {proc.stdout!r}")
    proc, _ = v.run(["logs", "a"])
    check(proc.stdout == "agent up\n", f"{name}: logs printed {proc.stdout!r}")
    return ids


def verbs_bootstrap_case(v: _Verbs, daemon, ids: dict, cfg) -> None:
    """(b): each created container's archive at ``/run/clawker`` holds
    the bootstrap files with the reference's names and modes, its
    assertion names the project and the agent, and ``agents.db`` binds
    one row per agent to that container; the median
    ``identity_bootstrap`` of the eight forked creates."""
    import io
    import tarfile

    from clawker_tpu_torch.controlplane.registry import Registry

    name = "verbs (b)"
    for a, cid in ids.items():
        tar = daemon.api.containers[cid].archives.get("/run/clawker", b"")
        with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
            members = [(m.name, m.mode) for m in tf.getmembers()]
            claims = _jwt_claims(tf.extractfile(
                "bootstrap/assertion.jwt").read())
        check(members == BOOTSTRAP_MEMBERS,
              f"{name}: {a}'s bootstrap archive {members}")
        check(claims["project"] == VERBS_PROJECT and claims["agent"] == a
              and claims["sub"] == f"{VERBS_PROJECT}.{a}"
              and claims["container_id"] == cid,
              f"{name}: {a}'s assertion claims {claims}")
    reg = Registry(cfg.data_dir / "agents.db")
    try:
        rows = {r.agent: r.container_id for r in reg.list(VERBS_PROJECT)}
    finally:
        reg.close()
    check(rows == ids, f"{name}: agents.db rows {rows}, containers {ids}")
    boot = [p["phases"]["identity_bootstrap"] * 1e3 for p in v.probes()
            if p["argv"][:2] == ["run", "-d"]]
    check(len(boot) == len(VERBS_AGENTS), f"{name}: {len(boot)} bootstraps")
    print(f"{name}: {len(ids)} bootstrap archives with the reference's "
          f"names and modes, assertions naming {VERBS_PROJECT}.<agent>, "
          f"{len(rows)} agents.db rows; identity_bootstrap "
          f"{statistics.median(boot)!r} ms median of {len(boot)} forked "
          f"creates (min {min(boot)!r}, max {max(boot)!r}; host work)")


def verbs_surface_case(v: _Verbs) -> None:
    """(c): ``settings``, ``alias``, ``network``, ``volume``, ``harness``,
    ``version`` and ``auth`` forked."""
    name = "verbs (c)"
    outs = {}
    for args, want in (
            (["settings", "set", "sentinel.threshold", "3.5"],
             "sentinel.threshold = 3.5\n"),
            (["settings", "get", "sentinel.threshold"], "3.5\n"),
            (["alias", "set", "pl", "project list"], "pl -> project list\n"),
            (["alias", "ls"], "pl\tproject list\n"),
            (["pl"], None),
            (["alias", "rm", "pl"], "removed alias pl\n"),
            (["network", "ensure"], "clawker-net ready\n"),
            (["network", "ls"], None),
            (["network", "inspect", "clawker-net"], None),
            (["network", "rm", "clawker-net"], "removed network clawker-net\n"),
            (["volume", "ls"], None),
            (["harness", "ls"], None),
            (["version"], None),
            (["auth", "status"], None)):
        proc, ms = v.run(args)
        if want is not None:
            check(proc.stdout == want,
                  f"{name}: `{' '.join(args)}` printed {proc.stdout!r}")
        outs[" ".join(args)] = (proc.stdout, ms)
    check(outs["pl"][0].startswith(f"{VERBS_PROJECT}\t"),
          f"{name}: the alias pl printed {outs['pl'][0]!r}")
    check(outs["network ls"][0].startswith("clawker-net\t")
          and json.loads(outs["network inspect clawker-net"][0])["Name"]
          == "clawker-net", f"{name}: network ls/inspect "
          f"{outs['network ls'][0]!r}")
    vols = outs["volume ls"][0]
    check(all(f"clawker.{VERBS_PROJECT}.{a}.config" in vols
              for a in VERBS_AGENTS), f"{name}: volume ls {vols!r}")
    check("claude\t" in outs["harness ls"][0],
          f"{name}: harness ls {outs['harness ls'][0]!r}")
    check(outs["version"][0].startswith("clawker-tpu "),
          f"{name}: version {outs['version'][0]!r}")
    check(outs["auth status"][0].startswith("CA: "),
          f"{name}: auth status {outs['auth status'][0]!r}")
    print(f"{name} forked, host ms: " + ", ".join(
        f"{k} {ms!r}" for k, (_, ms) in outs.items()))


def verbs_card_case(v: _Verbs, cfg, device: str) -> collections.Counter:
    """(d): egress for the running agents under their container names,
    a user alias ``hot`` that expands to ``fleet anomaly``; ``hot``
    forked exits 2 and names the hot container, and ``main(["hot"])`` in
    this process launches exactly one K3 and one K1 on the card."""
    import io

    from clawker_tpu_torch.cli import DEVICE_ENV
    from clawker_tpu_torch.cli import main as cli_main

    name = "verbs (d)"
    hot = _verbs_egress(cfg)
    v.run(["alias", "set", "hot", VERBS_ALIAS])
    env = dict(v.env, CLAWKER_TORCH_DEVICE=device)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", VERBS_PROBE, "hot"],
                          cwd=v.proj, env=env, capture_output=True, text=True,
                          timeout=300)
    forked_ms = (time.perf_counter() - t0) * 1e3
    check(proc.returncode == 2,
          f"{name}: hot exited {proc.returncode}, want 2: "
          f"{proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    check(doc["flags"] and doc["flags"][0]["agent"] == hot,
          f"{name}: hot's flags {doc['flags']}")
    z = {r["agent"]: r["latest_z"] for r in doc["rows"]}
    check(max(z, key=z.get) == hot and len(z) == len(VERBS_AGENTS),
          f"{name}: hot's rows {doc['rows']}")
    # this process as the forked one: the project dir, the daemon's
    # socket and the device
    saved_cwd = os.getcwd()
    saved = {k: os.environ.get(k) for k in (DEVICE_ENV, "DOCKER_HOST")}
    os.chdir(v.proj)
    os.environ.update({DEVICE_ENV: device,
                       "DOCKER_HOST": v.env["DOCKER_HOST"]})
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            code, counts = _counted(lambda: cli_main(["hot"]))
    finally:
        os.chdir(saved_cwd)
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
    inproc_ms = (time.perf_counter() - t0) * 1e3
    check(code == 2, f"{name}: main(['hot']) returned {code}, want 2")
    _check_fit_launches(name, counts)
    idoc = json.loads(buf.getvalue())
    check(idoc["flags"] and idoc["flags"][0]["agent"] == hot,
          f"{name}: in-process flags {idoc['flags']}")
    windows = sum(r["windows"] for r in idoc["rows"])
    print(f"{name} through the alias hot -> `{VERBS_ALIAS}`: forked exit 2 "
          f"in {forked_ms!r} ms, in process exit 2 in {inproc_ms!r} ms, "
          f"launches {json.dumps(counts)}; hot {hot} z {z[hot]!r} "
          f"(next {sorted(z.values())[-2]!r}); {len(idoc['rows'])} rows, "
          f"the fit [{windows}, 40]")
    return collections.Counter(counts)


def verbs_teardown_case(v: _Verbs, daemon) -> None:
    """(a), the end: ``stop`` and ``rm -f`` of the eight, ``ps`` empty,
    and a foreground ``run --no-tty`` whose container exits
    ``VERBS_FG_CODE`` makes the CLI exit with it."""
    name = "verbs (a)"
    proc, _ = v.run(["stop", *VERBS_AGENTS])
    check(proc.stdout.split() == list(VERBS_AGENTS),
          f"{name}: stop printed {proc.stdout!r}")
    proc, _ = v.run(["rm", "-f", *VERBS_AGENTS])
    check(proc.stdout.split() == list(VERBS_AGENTS),
          f"{name}: rm -f printed {proc.stdout!r}")
    proc, _ = v.run(["ps"])
    check(proc.stdout == "no agent containers\n",
          f"{name}: ps after rm printed {proc.stdout!r}")
    # its stdin stays open, as a user's terminal does, after the
    # container exits (the repair of the port's runtime/attach.py)
    r, w = os.pipe()
    try:
        proc, _ = v.run(["run", "--no-tty", "--image", "@exit3", "--agent",
                         "fg"], want=VERBS_FG_CODE, stdin=r)
    finally:
        os.close(r)
        os.close(w)
    check(proc.stdout == "exiting\n", f"{name}: the foreground run printed "
          f"{proc.stdout!r}")
    v.run(["rm", "-f", "fg"])
    left = [c.name for c in daemon.api.containers.values()]
    check(not left, f"{name}: containers left {left}")
    print(f"{name} forked, host ms: " + ", ".join(
        f"{verb} {statistics.median(ms)!r} (median of {len(ms)})"
        for verb, ms in v.ms.items()))


def verbs_host_case(v: _Verbs) -> None:
    """(e): the forked wall of ``ps``, ``version`` and ``run -d`` as a
    user runs them (``python -m``, median of 5), and once more each as
    ``python -c`` over the port's ``main``: no torch loaded (host
    work, no budget)."""
    name = "verbs (e)"
    walls = {}
    for verb, args in (("ps", lambda i: ["ps"]),
                       ("version", lambda i: ["version"]),
                       ("run -d", lambda i: ["run", "-d", "--agent",
                                             f"t{i}"])):
        ms = []
        for i in range(VERBS_REPS):
            proc, wall = _cli(args(i), v.proj, v.env)
            check(proc.returncode == 0,
                  f"{name}: `{verb}` exited {proc.returncode}: "
                  f"{proc.stderr[-2000:]}")
            ms.append(wall)
        walls[verb] = ms
        v.run(args(VERBS_REPS))
    v.run(["rm", "-f", *(f"t{i}" for i in range(VERBS_REPS + 1))])
    loaded = {" ".join(p["argv"][:2]): p["torch"] for p in v.probes()
              if p["argv"][0] in ("ps", "version")
              or p["argv"][:2] == ["run", "-d"]}
    check(not any(loaded.values()), f"{name}: torch loaded by {loaded}")
    print(f"{name} host work, forked wall ms (median of {VERBS_REPS}): "
          + ", ".join(f"{verb} {statistics.median(ms)!r}"
                      for verb, ms in walls.items())
          + f"; torch loaded by ps/version/run -d: {any(loaded.values())}")


def verbs_phase(device) -> collections.Counter:
    """Drives the everyday verbs forked over a Docker-API socket (the
    port's test daemon) on the ``local`` driver -- ``init``, worktrees,
    eight detached agents, ``ps``/``exec``/``logs``/``stop``/``rm``, the
    surface verbs -- checks the create path's identity bootstrap, and
    reaches the card through a user alias to ``fleet anomaly``;
    -> launches."""
    from clawker_tpu_torch.cli import DEVICE_ENV
    from clawker_tpu_torch.config import load_config

    out = ROOT / "build" / "chip_smoke" / "verbs"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    home = _harness_home(out)
    with _pinned_home(home), _isolated_dirs(out / "x", VERBS_SETTINGS) as proj, \
            _verbs_daemon(out) as daemon:
        (proj / ".clawker.yaml").unlink()       # init writes it
        (proj / "README").write_text("verbs\n")
        _git_repo(proj)
        env = dict(os.environ, DOCKER_HOST=f"unix://{daemon.sock_path}",
                   PYTHONPATH=str(ROOT))
        for k in ("CLAWKER_TPU_DRIVER", "CLAWKER_TPU_FAKE_IMAGES", DEVICE_ENV):
            env.pop(k, None)
        v = _Verbs(proj, env, out / "probes.jsonl")
        ids = verbs_lifecycle_case(v, daemon)
        cfg = load_config(proj)
        verbs_bootstrap_case(v, daemon, ids, cfg)
        verbs_surface_case(v)
        total = verbs_card_case(v, cfg, device)
        verbs_teardown_case(v, daemon)
        verbs_host_case(v)
        check(not daemon.unrouted,
              f"verbs: requests the daemon has no route for: "
              f"{daemon.unrouted}")
        torch_procs = [p["argv"] for p in v.probes() if p["torch"]]
        check(torch_procs == [["hot"]],
              f"verbs: processes that loaded torch {torch_procs}")
        print(f"verbs: {len(v.probes())} forked CLI processes, only `hot` "
              "loaded torch; requests served "
              f"{dict(sorted(daemon.routes.items()))}")
    no_daemon_left()
    no_process_left("verbs")
    print(f"verbs launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# ------------------------------------------------------------ images phase


IMAGES_REPO = f"clawker-{LOOP_PROJECT}"
IMAGES_TAGS = tuple(f"{IMAGES_REPO}:{t}" for t in ("base", "claude", "default"))
IMAGES_TAG_REQUEST = ("POST", f"/images/{IMAGES_REPO}%3Aclaude/tag",
                      f"repo={IMAGES_REPO}&tag=default")
IMAGES_ITER_S = 0.5             # (d): an iteration of the built image
IMAGES_SETTINGS = f"sentinel:\n  interval_s: {LOOP_TICK_S}\n" + ENGINES_SETTINGS
IMAGES_FIREWALL = "firewall:\n  enable: true\n"
SUPERVISOR_OUT = ROOT / "build" / "native"   # (c): make -C native BUILD=
# the agentd zipapp's members: the port's stdlib-only closure
PYZ_CLOSURE = ["__main__.py"] + [f"clawker_tpu_torch/{m}" for m in (
    "__init__.py", "agentd/__init__.py", "agentd/__main__.py",
    "agentd/daemon.py", "agentd/protocol.py", "agentd/register.py",
    "agentd/supervisor_client.py", "consts.py", "errors.py",
    "socketbridge/__init__.py", "socketbridge/container.py",
    "socketbridge/protocol.py")]


@contextlib.contextmanager
def _images_daemon(version: str, *, refuse: bool = False,
                   error: bool = False):
    """A ``FakeEngineDaemon`` on a short temporary socket over a fake
    that holds no image, reports ``BuilderVersion`` ``version`` and
    refuses the BuildKit lane (``refuse``) or streams an
    ``errorDetail`` from every legacy build (``error``); each build's
    (tags, context tar) lands in ``daemon.contexts``."""
    import tempfile

    from clawker_tpu_torch.engine.fake import FakeDockerAPI
    from clawker_tpu_torch.testenv import FakeEngineDaemon

    api = FakeDockerAPI()
    api.builder_version = version
    api.buildkit_refuse = refuse
    contexts: list = []
    api.build_hook = lambda tar, tags: contexts.append((list(tags), tar))
    if error:
        def failing_build(context_tar, *, tags, **kw):
            api._record("image_build", tags=tags)
            contexts.append((list(tags), context_tar))
            return iter([{"stream": "Step 1/1 : RUN false\n"},
                         {"errorDetail": {"message": "exit code 1"},
                          "error": "exit code 1"}])
        api.image_build = failing_build
    tmp = Path(tempfile.mkdtemp(prefix="clawker-img-"))
    daemon = FakeEngineDaemon(tmp / "engine.sock", api).start()
    daemon.contexts = contexts
    try:
        yield daemon
    finally:
        daemon.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def _images_env(daemon, device: str = "") -> dict:
    """A forked CLI's environment: the daemon at ``DOCKER_HOST`` on
    default settings (no fake driver), the card for ``device``."""
    from clawker_tpu_torch.cli import DEVICE_ENV

    env = dict(os.environ, DOCKER_HOST=f"unix://{daemon.sock_path}",
               PYTHONPATH=str(ROOT))
    for k in ("CLAWKER_TPU_DRIVER", "CLAWKER_TPU_FAKE_IMAGES", DEVICE_ENV):
        env.pop(k, None)
    if device:
        env[DEVICE_ENV] = device
    return env


def _images_run(name: str, args: list[str], proj: Path, env: dict,
                want: int = 0):
    proc, ms = _cli(args, proj, env)
    check(proc.returncode == want,
          f"{name}: `{' '.join(args)}` exited {proc.returncode}, want {want}: "
          f"{proc.stdout[-1500:]} {proc.stderr[-2000:]}")
    return proc, ms


def _lanes(daemon) -> list[tuple]:
    return [(b["version"], b["tags"]) for b in daemon.builds]


def _tag_requests(daemon) -> list[tuple]:
    return [(m, p, q) for m, p, q, _ in list(daemon.log)
            if p.endswith("/tag")]


def _ctx_members(tar: bytes) -> dict:
    import io
    import tarfile

    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        return {m.name: tf.extractfile(m).read() for m in tf.getmembers()}


def _build_supervisor() -> tuple[Path, float]:
    """The native supervisor compiled from the checkout's source into
    ``build/native`` (always: ``make -B``, whatever a copy of the tree
    brought along): -> (binary, compile s)."""
    t0 = time.perf_counter()
    proc = subprocess.run(["make", "-B", "-C", str(ROOT / "native"),
                           f"BUILD={SUPERVISOR_OUT}"],
                          capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    binary = SUPERVISOR_OUT / "clawker-supervisord"
    check(proc.returncode == 0 and binary.is_file(),
          f"images (c): make -C native exited {proc.returncode}: "
          f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    return binary, secs


def images_buildkit_case(proj: Path, daemon, walls: dict) -> None:
    """(a): ``init``, then ``build`` off a TTY (the progress tree's state
    lines) and ``build --plain`` with ``firewall.enable``, on the
    BuildKit lane: two ``version=2`` builds a command tagged ``:base``
    and ``:claude``, then the ``:default`` tag; the decoded vertex
    lines; ``image ls``; each context's Dockerfile as the port writes it
    in this process, and the harness context's cache tail."""
    from clawker_tpu_torch.bundle import Resolver
    from clawker_tpu_torch.bundler import generate_base, generate_harness
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.firewall.pki import ensure_ca

    name = "images (a)"
    env = _images_env(daemon)
    check(not daemon.api.images, f"{name}: the fake holds images before the "
          f"build: {sorted(daemon.api.images)}")
    (proj / ".clawker.yaml").unlink()           # init writes it
    _images_run(name, ["init", "--yes", "--name", LOOP_PROJECT], proj, env)
    proc, walls["buildkit"] = _images_run(name, ["build"], proj, env)
    tree = proc.stdout.splitlines()
    check(tree[0].startswith(f"• building {IMAGES_TAGS[0]} (stack ")
          and any(l.startswith("+ [internal] load build definition")
                  for l in tree)
          and any(l.startswith("+ [1/1] FROM scratch") for l in tree)
          and any(l.startswith(f"+ tagged {IMAGES_TAGS[2]}") for l in tree)
          and tree[-1] == IMAGES_TAGS[2],
          f"{name}: build off a TTY printed {tree}")
    lanes = [("2", [IMAGES_TAGS[0]]), ("2", [IMAGES_TAGS[1]])]
    check(_lanes(daemon) == lanes and _tag_requests(daemon)
          == [IMAGES_TAG_REQUEST],
          f"{name}: builds {_lanes(daemon)}, tags {_tag_requests(daemon)}")
    settings = Path(os.environ["CLAWKER_TPU_CONFIG_DIR"]) / "settings.yaml"
    plain_settings = settings.read_text()
    settings.write_text(plain_settings + IMAGES_FIREWALL)
    try:
        proc, walls["buildkit --plain"] = _images_run(
            name, ["build", "--plain"], proj, env)
        cfg = load_config(proj)
    finally:
        settings.write_text(plain_settings)
    lines = proc.stdout.splitlines()
    check(lines.count("#1 [internal] load build definition") == 2
          and lines.count("#2 hello from buildkit") == 2
          and sum(l.startswith("#2 DONE ") for l in lines) == 2
          and lines[-2:] == [f"tagged {IMAGES_TAGS[2]}", IMAGES_TAGS[2]],
          f"{name}: build --plain printed {lines}")
    check(_lanes(daemon) == lanes * 2
          and all(b["buildid"] for b in daemon.builds)
          and _tag_requests(daemon) == [IMAGES_TAG_REQUEST] * 2,
          f"{name}: builds {_lanes(daemon)}, tags {_tag_requests(daemon)}")
    proc, _ = _images_run(name, ["image", "ls"], proj, env)
    check(proc.stdout.splitlines() == list(IMAGES_TAGS),
          f"{name}: image ls printed {proc.stdout!r}")
    # each context's Dockerfile, as the port writes it in this process
    pconf = cfg.project
    r = Resolver(cfg)
    harness = r.harness(pconf.build.harness or "claude")
    extra = list(harness.files) if harness.source_dir is not None else []
    base_df = generate_base(LOOP_PROJECT, r.stack(pconf.build.stack or "python"),
                            pconf.build)
    want = [base_df] + [generate_harness(
        LOOP_PROJECT, harness, pconf.build, base_ref=IMAGES_TAGS[0],
        with_ca_cert=ca, with_agentd=True, extra_files=extra)
        for ca in (False, True)]
    got = [_ctx_members(tar)["Dockerfile"].decode()
           for _, tar in daemon.contexts]
    check(got == [want[0], want[1], want[0], want[2]],
          f"{name}: the contexts' Dockerfiles differ from generate_base / "
          f"generate_harness in this process")
    # the cache tail: the CA, then the supervisor, then the zipapp
    df = want[2]
    tail = [df.index(s) for s in ("COPY clawker-ca.crt", "COPY clawker-supervisord",
                                  "COPY clawker-agentd.pyz", "ENTRYPOINT ")]
    runs = [i for i in range(len(df)) if df.startswith("RUN ", i)
            and i < tail[0]]
    check(tail == sorted(tail) and runs and df.rstrip().split("\n")[-1]
          .startswith("CMD "), f"{name}: the harness Dockerfile's tail "
          f"{df.splitlines()[-12:]}")
    ca_member = _ctx_members(daemon.contexts[3][1]).get("clawker-ca.crt")
    check(ca_member == ensure_ca(cfg.pki_dir).cert_pem
          and "clawker-ca.crt" not in _ctx_members(daemon.contexts[1][1]),
          f"{name}: the CA in the harness contexts")
    print(f"{name} BuildKit lane, forked: build {walls['buildkit']!r} ms "
          f"(the progress tree off a TTY, {len(tree)} lines), build --plain "
          f"with firewall.enable {walls['buildkit --plain']!r} ms "
          f"({sum(l.startswith('#') for l in lines)} vertex lines); "
          f"{len(daemon.builds)} version=2 builds, 2 :default tags; the "
          f"contexts' Dockerfiles as written in process; context bytes "
          f"{[len(tar) for _, tar in daemon.contexts]}")


def images_lanes_case(proj: Path, walls: dict) -> None:
    """(b): ``build --plain`` on a legacy daemon (two legacy builds), on
    one that advertises BuildKit and refuses it (one refused ``version=2``
    request, then legacy for both stages: the refusal is remembered),
    and on one whose stream carries an ``errorDetail`` (exit 1, "build
    of ... failed", nothing tagged); then ``image rm`` of the three
    tags."""
    name = "images (b)"
    base_only = [("1", [IMAGES_TAGS[0]]), ("1", [IMAGES_TAGS[1]])]
    with _images_daemon("1") as legacy:
        env = _images_env(legacy)
        proc, walls["legacy"] = _images_run(name, ["build", "--plain"], proj, env)
        check(_lanes(legacy) == base_only
              and proc.stdout.count("Step 1/1 : FROM scratch") == 2
              and _tag_requests(legacy) == [IMAGES_TAG_REQUEST],
              f"{name}: legacy builds {_lanes(legacy)}: {proc.stdout!r}")
        proc, _ = _images_run(name, ["image", "rm", *IMAGES_TAGS], proj, env)
        check(proc.stdout.splitlines() == list(IMAGES_TAGS),
              f"{name}: image rm printed {proc.stdout!r}")
        proc, _ = _images_run(name, ["image", "ls"], proj, env)
        check(proc.stdout == "" and not legacy.api.images,
              f"{name}: after image rm: {proc.stdout!r} "
              f"{sorted(legacy.api.images)}")
        legacy_routes = dict(legacy.routes)
    with _images_daemon("2", refuse=True) as refused:
        proc, walls["refused"] = _images_run(name, ["build", "--plain"], proj,
                                             _images_env(refused))
        check(_lanes(refused) == [("2", [IMAGES_TAGS[0]])] + base_only
              and _tag_requests(refused) == [IMAGES_TAG_REQUEST]
              and "buildkit lane refused" in proc.stderr,
              f"{name}: refused lane builds {_lanes(refused)}: "
              f"{proc.stderr[-1500:]}")
    with _images_daemon("1", error=True) as failing:
        proc, walls["errorDetail"] = _images_run(
            name, ["build", "--plain"], proj, _images_env(failing), want=1)
        check(f"build of {IMAGES_TAGS[0]} failed: exit code 1" in proc.stderr
              and not _tag_requests(failing) and not failing.api.images
              and len(failing.contexts) == 1,
              f"{name}: the failing build: {proc.stderr[-1500:]}, tags "
              f"{_tag_requests(failing)}, images {sorted(failing.api.images)}")
    print(f"{name} forked build --plain: legacy {walls['legacy']!r} ms (2 "
          f"legacy builds, image rm of 3 tags; routes {legacy_routes}), "
          f"BuildKit refused {walls['refused']!r} ms (1 refused v2 request, "
          f"then legacy for both stages), errorDetail {walls['errorDetail']!r}"
          f" ms (exit 1, nothing tagged)")


def images_payload_case(base: Path, daemon, supervisor: Path) -> dict:
    """(c): the harness context's tail holds the supervisor built from
    the checkout and the port's zipapp, deterministic and exactly the
    port's closure; ``python3 -I`` with only the zipapp on ``sys.path``
    imports the session daemon and loads neither torch nor JAX; then
    the supervisor runs the zipapp as its ``--child`` with the image
    command after ``--default-cmd``, and a session over mTLS from the
    port's ``dial_with_retry`` (material from the port's ``identity``
    and ``pki``) brings up the image command on ``AgentReady``; -> the
    sizes."""
    import io
    import zipfile

    from clawker_tpu_torch.agentd import SupervisorClient
    from clawker_tpu_torch.bundler.payload import build_agentd_pyz
    from clawker_tpu_torch.controlplane import identity
    from clawker_tpu_torch.controlplane.session_client import dial_with_retry
    from clawker_tpu_torch.firewall import pki

    name = "images (c)"
    members = _ctx_members(daemon.contexts[-1][1])
    sup = supervisor.read_bytes()
    pyz = build_agentd_pyz()
    check(members.get("clawker-supervisord") == sup and sup[:4] == b"\x7fELF",
          f"{name}: the context's supervisor is not the binary just built")
    check(pyz == build_agentd_pyz() == members.get("clawker-agentd.pyz"),
          f"{name}: the zipapp is not deterministic or not the context's")
    zf = zipfile.ZipFile(io.BytesIO(pyz))
    names = zf.namelist()
    check(names == PYZ_CLOSURE, f"{name}: the zipapp's members {names}")
    differ = [n for n in names[1:] if zf.read(n) != (ROOT / n).read_bytes()]
    check(not differ, f"{name}: members that are not the checkout's files "
          f"{differ}")
    base.mkdir(parents=True, exist_ok=True)
    pyz_path = base / "clawker-agentd.pyz"
    pyz_path.write_bytes(pyz)
    probe = subprocess.run(
        [sys.executable, "-I", "-c",
         "import json, sys\n"
         f"sys.path.insert(0, {str(pyz_path)!r})\n"
         "import clawker_tpu_torch.agentd.daemon\n"
         "import clawker_tpu_torch.socketbridge.container\n"
         "import clawker_tpu_torch\n"
         "print(json.dumps({'file': clawker_tpu_torch.__file__,\n"
         "                  'torch': 'torch' in sys.modules,\n"
         "                  'jax': 'jax' in sys.modules}))\n"],
        cwd=base, capture_output=True, text=True, timeout=60)
    check(probe.returncode == 0 and json.loads(probe.stdout) == {
        "file": f"{pyz_path}/clawker_tpu_torch/__init__.py", "torch": False,
        "jax": False}, f"{name}: python3 -I over the zipapp: "
        f"{probe.stdout!r} {probe.stderr[-1500:]}")
    # tests/test_agentd_payload.py's composition over the port
    ca = pki.generate_ca()
    cp = pki.generate_cp_cert(ca)
    certs = base / "certs"
    certs.mkdir()
    (certs / "cp.crt").write_bytes(cp.cert_pem)
    (certs / "cp.key").write_bytes(cp.key_pem)
    (certs / "ca.crt").write_bytes(ca.cert_pem)
    bdir = base / "bootstrap"
    bdir.mkdir()
    for fname, data in identity.mint_bootstrap_material(
            ca, LOOP_PROJECT, "dev").files().items():
        (bdir / fname).write_bytes(data)
    sock, marker = base / "sup.sock", base / "image-cmd-ran"
    port = _free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [str(supervisor), "--socket", str(sock), "--child",
         "python3", str(pyz_path), "--bootstrap-dir", str(bdir),
         "--host", "127.0.0.1", "--port", str(port),
         "--ready-file", str(base / "ready"),
         "--init-marker", str(base / "init"),
         "--supervisor-socket", str(sock), "--default-cmd",
         "/bin/sh", "-c", f"touch {marker}; exit 21"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        s = dial_with_retry("127.0.0.1", port, cert_file=certs / "cp.crt",
                            key_file=certs / "cp.key",
                            ca_file=certs / "ca.crt", deadline_s=15)
        with s:
            h = s.hello()
            shell = s.run_shell([{"argv": ["/bin/echo", "plan-step"]}])
            s.agent_initialized()
            pid = s.agent_ready([], cwd=str(base))
        _wait(marker.exists, 10, 0.05)
        with SupervisorClient(sock) as c:
            code = c.wait(timeout=10)
        ready_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(5)
        err = proc.stderr.read().decode(errors="replace")
        proc.stderr.close()
    check(not h.initialized and not h.cmd_running
          and shell.stdout.strip() == b"plan-step" and shell.code == 0
          and pid > 0 and marker.exists() and code == 21,
          f"{name}: the composition: hello {h}, shell {shell}, pid {pid}, "
          f"marker {marker.exists()}, exit {code}; supervisor {err[-1500:]}")
    print(f"{name} the supervisor (ELF, {len(sup)} bytes, built from "
          f"native/) and the port's zipapp ({len(pyz)} bytes, "
          f"{len(names)} members, the closure, deterministic) in the harness "
          f"context; python3 -I over it loads no torch or JAX; supervisor "
          f"--child python3 <pyz> --default-cmd: session over mTLS, shell "
          f"stage, AgentInitialized, AgentReady ran the image command (exit "
          f"{code}) in {ready_ms!r} ms from spawn")
    return {"supervisor": len(sup), "pyz": len(pyz)}


def _write_when_created(daemon, cfg, out: dict, stop) -> None:
    """The forked loop's egress, written once its containers exist:
    every agent's benign minutes and the hot slot's burst, keyed by the
    names its creates carry."""
    pattern = re.compile(rf"^clawker\.{LOOP_PROJECT}\.(loop-[0-9a-z]+)-\d+$")
    while not stop.is_set():
        names = [c.name.lstrip("/") for c in list(daemon.api.containers.values())]
        hits = [m.group(1) for m in map(pattern.match, names) if m]
        if hits:
            agents = [f"{hits[0]}-{i}" for i in range(LOOP_AGENTS)]
            out["agents"] = agents
            out["hot"] = agents[LOOP_HOT_SLOT]
            cfg.logs_dir.mkdir(parents=True, exist_ok=True)
            _append(cfg.logs_dir / f"ebpf-egress-{ENGINES_LOCAL}.jsonl",
                    _local_egress(agents, out["hot"]))
            return
        time.sleep(0.01)


def images_forked_loop(name: str, proj: Path, daemon, device: str) -> dict:
    """``loop -p 8 -n 3 --sentinel --json`` forked on the built image
    with the agents' egress and a hot agent: the hot agent hottest, at
    ``ANOMALY_Z`` or more, and a scored tick on the card with a flag in
    its flight record; -> what the summary line prints."""
    from clawker_tpu_torch.analytics.runtime import ANOMALY_Z
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.monitor.ledger import flight_path
    from clawker_tpu_torch.telemetry import SPAN_SENTINEL_TICK, load_spans

    cfg = load_config(proj)
    seen: dict = {}
    stop = threading.Event()
    _clear_of_minute_end(FORKED_RUN_MARGIN_S)
    writer = threading.Thread(target=_write_when_created,
                              args=(daemon, cfg, seen, stop),
                              name="images-egress-writer")
    writer.start()
    try:
        proc, forked_ms = _images_run(
            name, ["loop", "-p", str(LOOP_AGENTS), "-n", str(LOOP_ITERATIONS),
                   "--sentinel", "--json"], proj, _images_env(daemon, device))
    finally:
        stop.set()
        writer.join(10)
    for bad in ("anomaly_watch_error", "no CUDA GPU"):
        check(bad not in proc.stderr,
              f"{name}: the rider failed: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    hot = seen.get("hot")
    zs = {a["agent"]: a.get("anomaly_z") for a in doc["agents"]}
    check(len(doc["agents"]) == LOOP_AGENTS
          and all(a["status"] == "done" and a["iteration"] == LOOP_ITERATIONS
                  and a["worker"] == ENGINES_LOCAL for a in doc["agents"]),
          f"{name}: forked agents {doc['agents']}")
    check(hot in zs and None not in zs.values() and zs[hot] >= ANOMALY_Z
          and max(zs, key=zs.get) == hot,
          f"{name}: forked z {zs}, hot {hot} (threshold {ANOMALY_Z})")
    spans = load_spans(flight_path(cfg.logs_dir, doc["loop_id"]).read_text()
                       .splitlines())
    ticks = [sp for sp in spans if sp.name == SPAN_SENTINEL_TICK]
    check(ticks and all(sp.attrs["device"].startswith(device) for sp in ticks)
          and any(sp.attrs.get("flags") for sp in ticks),
          f"{name}: forked sentinel ticks {[sp.attrs for sp in ticks]}")
    creates = _creates_by_name(daemon)
    return {"ms": forked_ms, "creates": sum(creates.values()), "hot": hot,
            "z": zs[hot], "ticks": len(ticks),
            "device": ticks[0].attrs["device"]}


def images_card_case(base: Path, proj: Path, daemon, device: str,
                     stages: dict, home: Path, *, tags=IMAGES_TAGS,
                     name: str = "images (d)", fork: bool = True) -> tuple:
    """(d): the behaviour set on the BUILT ``:default`` (nothing was
    pre-seeded; ``tags`` are the build's base, harness and default
    tags), then, with ``fork``, ``images_forked_loop``, and the same run
    in this process over ``LocalDriver`` under the launch counters: the
    hot agent flagged first, every scored tick one K3 and one K1; ->
    (launches, walls)."""
    from clawker_tpu_torch.analytics.runtime import ANOMALY_Z
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec
    from clawker_tpu_torch.sentinel import FleetSentinel

    check(set(tags) <= set(daemon.api.images),
          f"{name}: the built images {sorted(daemon.api.images)}")
    daemon.api.set_behavior(tags[2], exit_behavior(
        b"iteration done\n", 0, delay=IMAGES_ITER_S))
    forked = images_forked_loop(name, proj, daemon, device) if fork else None
    # in this process, its own dirs, the same daemon and built image
    with _pinned_home(home), _isolated_dirs(base / "inproc", IMAGES_SETTINGS) \
            as proj2:
        cfg2 = load_config(proj2)
        drv = _local_driver(daemon)
        sched = LoopScheduler(cfg2, drv, LoopSpec(
            parallel=LOOP_AGENTS, iterations=LOOP_ITERATIONS))
        s = FleetSentinel(cfg2, drv, run_id=sched.loop_id, device=device,
                          interval_s=LOOP_TICK_S, train_steps=SENTINEL_STEPS)
        log = TickLog(s, stages)
        sched.attach_sentinel(s)
        agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
        hot2 = agents[LOOP_HOT_SLOT]
        _clear_of_minute_end(LIVE_RUN_MARGIN_S)
        egress = _local_egress(agents, hot2)
        t0 = time.perf_counter()
        s.start()
        sched.start()
        _append(cfg2.logs_dir / f"ebpf-egress-{ENGINES_LOCAL}.jsonl", egress)
        sched.run(poll_s=0.05)
        wall = (time.perf_counter() - t0) * 1e3
        _wait(lambda: s._scored_at[0] >= len(egress), 10, LOOP_TICK_S)
        s.stop()
        rows = sched.status()
        flags = [f["agent"] for f in s.flags()]
        sched.cleanup(remove_containers=True)
        drv.close()
    scored = log.check_run(name)
    _check_loop_rows(name, rows)
    zs2 = {r["agent"]: r["anomaly_z"] for r in rows}
    check(flags and flags[0] in (hot2, f"clawker.{LOOP_PROJECT}.{hot2}")
          and zs2[hot2] >= ANOMALY_Z and max(zs2, key=zs2.get) == hot2,
          f"{name}: in process flags {flags}, z {zs2}, hot {hot2}")
    tick_ms = [ms["wall"] for n, _, ms, _ in log.ticks if n]
    print(card_line())
    said = (f"loop -p {LOOP_AGENTS} -n {LOOP_ITERATIONS} --sentinel forked "
            f"{forked['ms']!r} ms, {forked['creates']} creates, "
            f"{forked['hot']} hottest at z {forked['z']} (threshold "
            f"{ANOMALY_Z}), {forked['ticks']} ticks scored on "
            f"{forked['device']}; " if forked else "no forked loop (images "
            "(d) forks it); ")
    print(f"{name} on the image the build tagged ({tags[2]}, "
          f"behaviour set after the build): {said}in process over "
          f"LocalDriver: run wall {wall!r} ms, {len(log.ticks)} ticks, "
          f"{len(scored)} scored (tick ms median "
          f"{statistics.median(tick_ms)!r}), first flag {flags[0]} (z "
          f"{zs2[hot2]}), launches {json.dumps(dict(log.launches()))}")
    print(f"{name}: {log.stage_line()}")
    walls = {"loop": wall, "tick": statistics.median(tick_ms)}
    if forked:
        walls["forked loop"] = forked["ms"]
    return log.launches(), walls


def images_phase(device) -> collections.Counter:
    """Builds the project image with the port's ``build`` over a
    Docker-API socket (the port's test daemon) on every builder lane,
    checks the contexts, the agentd zipapp and the supervisor it ships
    with, then runs ``loop --sentinel`` on the image the build tagged,
    the sentinel scoring on the card; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "images"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    supervisor, compile_s = _build_supervisor()
    saved = os.environ.get("CLAWKER_TPU_SUPERVISOR_BIN")
    os.environ["CLAWKER_TPU_SUPERVISOR_BIN"] = str(supervisor)
    walls: dict = {}
    home = _harness_home(out)
    try:
        with _pinned_home(home), _isolated_dirs(out / "a", IMAGES_SETTINGS) \
                as proj, _images_daemon("2") as daemon:
            images_buildkit_case(proj, daemon, walls)
            sizes = images_payload_case(out / "c", daemon, supervisor)
            with stage_timers({}) as stages:
                total, loop_ms = images_card_case(out / "d", proj, daemon,
                                                  device, stages, home)
            ctx_bytes = [len(tar) for _, tar in daemon.contexts]
            check(not daemon.unrouted, f"images: requests the daemon has no "
                  f"route for: {daemon.unrouted}")
            images_lanes_case(proj, walls)
    finally:
        if saved is None:
            os.environ.pop("CLAWKER_TPU_SUPERVISOR_BIN", None)
        else:
            os.environ["CLAWKER_TPU_SUPERVISOR_BIN"] = saved
    no_daemon_left()
    no_process_left("images")
    print(f"images (e) host walls: forked build ms by lane "
          f"{json.dumps(walls)}; context bytes (base, harness, base, "
          f"harness with the CA) {ctx_bytes}; the zipapp {sizes['pyz']} "
          f"bytes, the supervisor {sizes['supervisor']} bytes compiled in "
          f"{compile_s!r} s; loop ms {json.dumps(loop_ms)}")
    print(f"images launches: {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# ------------------------------------------------------- federation phase


FED_PODS = ("podA", "podB")     # the sock dirs' names: the pods' names
FED_WORKERS = 2                 # fake workers a pod in (a)-(c)
FED_STORAGE = ("loop:\n  storage_pressure:\n    soft_free_pct: 0.001\n"
               "    hard_free_pct: 0.0005\n")
FED_MIGRATE_AGENTS = 4          # (c): the held run's loops
FED_ORPHAN_GRACE_S = 0.5        # bench.py:1747's grace
FED_RTT_S = 0.005               # (d): bench.py:1635's injected DCN RTT
FED_LEASE_WORKERS = 4           # (d): bench.py:1635's workers a pod
FED_LEASE_RUNS, FED_LEASE_PER_RUN = 64, 2   # (d): 128 loops, two pods
LEASE_AMORTIZATION_MIN = 5.0    # bench.py:2851


def _fed_settings(socks: list[Path], *, sentinel: bool) -> str:
    """One config for both pods, on disk (the forked CLI reloads it):
    pod A at the canonical socket (settings ``loopd.socket``), so the
    fleet views find it, and both under ``federation.pods``."""
    text = (f"loopd:\n  start_deadline_s: 120\n  socket: {socks[0]}\n"
            + FED_STORAGE + "federation:\n  enable: true\n  pods:\n"
            + "".join(f"  - {s}\n" for s in socks))
    if sentinel:
        text += (f"sentinel:\n  enable: true\n  interval_s: {LOOP_TICK_S}\n"
                 f"  train_steps: {SENTINEL_STEPS}\n")
    return text


@contextlib.contextmanager
def _fed_pods(base: Path, device, *, sentinel: bool,
              workers: int = FED_WORKERS, behavior=None):
    """Two in-process ``LoopdServer`` pods over one config and so one
    journal store, each on its own ``FakeDriver`` (worker ids
    ``podA-0``.., the loop image with ``behavior``, by default loop
    (a)'s), their sockets in a short temporary directory when the state
    dir's path is too long for AF_UNIX; -> (project dir, cfg, drivers by
    pod, servers by pod).  A
    case that kills a pod pops it from the servers first: the others
    are stopped on the way out."""
    import tempfile

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.loopd.server import LoopdServer

    socks = [base / "state" / name / "loopd.sock" for name in FED_PODS]
    tmp = None
    if max(len(str(sock).encode()) for sock in socks) >= SUN_PATH_MAX:
        tmp = Path(tempfile.mkdtemp(prefix="clawker-fed-"))
        socks = [tmp / name / "loopd.sock" for name in FED_PODS]
    with _isolated_dirs(base, _fed_settings(socks, sentinel=sentinel),
                        proxy=False) as proj:
        cfg = load_config(proj)
        drivers: dict = {}
        servers: dict = {}
        try:
            for name, sock in zip(FED_PODS, socks):
                drv = FakeDriver(n_workers=workers, prefix=name)
                for api in drv.apis:
                    api.add_image(LOOP_IMAGE)
                    api.set_behavior(LOOP_IMAGE, behavior or exit_behavior(
                        b"iteration done\n", 0, delay=LOOP_ITER_S))
                drivers[name] = drv
                servers[name] = LoopdServer(cfg, drv, device=device,
                                            sock_path=sock).start()
            yield proj, cfg, drivers, servers
        finally:
            for srv in servers.values():
                srv.stop()
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)


def fed_status_case(proj: Path) -> float:
    """(a): forked ``fed status --format json`` reads both pods alive
    and healthy; -> its wall ms."""
    name = "federation (a)"
    proc, ms = _images_run(name, ["fed", "status", "--format", "json"], proj,
                           dict(os.environ, PYTHONPATH=str(ROOT)))
    pods = {p["pod"]: p for p in json.loads(proc.stdout)["pods"]}
    check(sorted(pods) == list(FED_PODS)
          and all(p["alive"] and p["healthy"] and p["workers"] == FED_WORKERS
                  for p in pods.values()),
          f"{name}: fed status {pods}")
    return ms


def _fed_row(name: str, rows: list[dict], container: str) -> dict:
    row = next((r for r in rows if r["agent"] == container), None)
    check(row is not None, f"{name}: no sentinel row for {container} in "
          f"{[r['agent'] for r in rows]}")
    return row


def fed_sentinel_case(proj: Path, cfg, servers: dict,
                      stages: dict) -> dict:
    """(b): forked ``loop -p 8 -n 3 --pods --json`` shards the run over
    both pods; live egress for every agent and a 55-record burst on one
    agent of pod A's shard.  Each pod's daemon sentinel scores its
    shard, the hot agent flags on pod A and pod B never sees it, and the
    forked fleet views read pod A (the canonical socket): ``fleet
    health`` with the sentinel's ANOM-Z on the hot agent's worker,
    ``placement``, ``warmpool``; -> each pod's ``TickLog``, for the
    caller to hold once the pods have stopped ticking
    (``fed_launches``)."""
    from clawker_tpu_torch.analytics.runtime import ANOMALY_Z
    from clawker_tpu_torch.loopd.client import LoopdClient

    name = "federation (b)"
    logs = {pod: TickLog(srv.sentinel, stages) for pod, srv in servers.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc, loop_ms = _images_run(
        name, ["loop", "-p", str(LOOP_AGENTS), "-n", str(LOOP_ITERATIONS),
               "--pods", "--json"], proj, env)
    shards = {sh["pod"]: sh for sh in
              json.loads(proc.stdout.splitlines()[-1])["shards"]}
    check(sorted(shards) == list(FED_PODS)
          and sum(sh["parallel"] for sh in shards.values()) == LOOP_AGENTS,
          f"{name}: shards {shards}")
    agents = {pod: [f"loop-{sh['loop_id'][:6]}-{i}"
                    for i in range(sh["parallel"])]
              for pod, sh in shards.items()}
    hot = agents[FED_PODS[0]][min(1, len(agents[FED_PODS[0]]) - 1)]
    container = f"clawker.{LOOP_PROJECT}.{hot}"
    now, want = time.time(), {}
    for pod in FED_PODS:
        streams = _loop_egress(agents[pod], hot, now, [
            f"{pod}-{w}" for w in range(FED_WORKERS)])
        for wid, recs in streams.items():
            _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
        want[pod] = sum(len(v) for v in streams.values())
    for pod, srv in servers.items():
        run = srv.runs.get(shards[pod]["loop_id"])
        check(run is not None and run.done.wait(60) and run.result["ok"]
              and all(a["status"] == "done"
                      and a["iteration"] == LOOP_ITERATIONS
                      for a in run.result["agents"]),
              f"{name}: {pod}'s shard {run.result if run else None}")
        _wait(lambda: srv.sentinel._scored_at[0] >= want[pod], 10,
              LOOP_TICK_S)
    docs = {}
    for pod, srv in servers.items():
        with LoopdClient(srv.sock_path) as c:
            docs[pod] = c.status()["sentinel"]
    row = _fed_row(name, docs[FED_PODS[0]]["rows"], container)
    check(row["flagged"] and row["latest_z"] >= ANOMALY_Z
          and any(f["agent"] == container for f in docs[FED_PODS[0]]["flags"]),
          f"{name}: {container} on {FED_PODS[0]}: {row}")
    # the hot agent is pod A's alone: pod B's sentinel never sees it (a
    # benign agent of pod B's may still cross the threshold: two agents a
    # worker make a thin baseline, as the reference's scoring does too)
    check(not any(r["agent"] == container for r in docs[FED_PODS[1]]["rows"])
          and not any(f["agent"] == container
                      for f in docs[FED_PODS[1]]["flags"]),
          f"{name}: {FED_PODS[1]} rows {docs[FED_PODS[1]]['rows']}")
    others = sorted((f["agent"], f["z"]) for f in docs[FED_PODS[1]]["flags"])
    # the fleet views, forked, against pod A's socket
    proc, health_ms = _images_run(name, ["fleet", "health", "--format",
                                         "json"], proj, env)
    health = json.loads(proc.stdout)
    hrow = _fed_row(name, health["sentinel"]["rows"], container)
    check(health["source"].startswith("loopd:") and hrow["flagged"],
          f"{name}: fleet health json {health['source']}: {hrow}")
    proc, _ = _images_run(name, ["fleet", "health"], proj, env)
    table = [line.split("\t") for line in proc.stdout.splitlines()]
    cell = next((r[-1] for r in table[1:] if r[0] == hrow["worker"]), None)
    check(table[0][-1] == "ANOM-Z" and cell is not None
          and float(cell) >= ANOMALY_Z,
          f"{name}: fleet health rows {table}, hot worker {hrow['worker']}")
    views = {}
    for verb in ("placement", "warmpool"):
        proc, views[verb] = _images_run(
            name, ["fleet", verb, "--format", "json"], proj, env)
        check(json.loads(proc.stdout).get("source", "").startswith("loopd:"),
              f"{name}: fleet {verb} {proc.stdout[-1500:]}")
    print(card_line())
    print(f"{name}: loop -p {LOOP_AGENTS} -n {LOOP_ITERATIONS} --pods forked "
          f"{loop_ms!r} ms, shards "
          f"{ {p: sh['parallel'] for p, sh in shards.items()} }; {container} "
          f"flagged on {FED_PODS[0]} at z {row['latest_z']} (ANOM-Z {cell} on "
          f"{hrow['worker']} in fleet health), not on {FED_PODS[1]} (its "
          f"flags {others}); "
          f"fleet health {health_ms!r} ms, placement "
          f"{views['placement']!r} ms, warmpool {views['warmpool']!r} ms")
    return logs


def fed_launches(logs: dict) -> collections.Counter:
    """Each pod's daemon sentinel, its pod stopped: every tick held, one
    K3 and one K1 a scored tick (counted a sentinel); -> the launches."""
    launches = collections.Counter()
    parts = []
    for pod, log in logs.items():
        scored = log.check_run(f"federation (b) {pod}")
        launches.update(log.launches())
        parts.append(f"{pod}: {len(log.ticks)} ticks, {len(scored)} scored, "
                     f"launches {json.dumps(dict(log.launches()))}; "
                     f"{log.stage_line()}")
    print(f"federation (b) daemon sentinels: {'; '.join(parts)}")
    return launches


def _total_creates(drv) -> int:
    return sum(len(api.calls_named("container_create")) for api in drv.apis)


def fed_migrate_case(base: Path, device) -> dict:
    """(c): a run held on a hold-event behaviour lands on pod A through
    the router; once its creates are on pod A's daemon, pod A is killed
    (``srv.kill()``) and ``migrate_pod`` moves the run to pod B.  Every
    loop reaches its budget there under the same id, pod A creates
    nothing more, ``cross_pod_exactly_once`` is green, and the merged
    trace roots the run's iterations at the router's ``router.submit``
    hop; -> walls."""
    from clawker_tpu_torch.chaos.invariants import cross_pod_exactly_once
    from clawker_tpu_torch.federation import FederationRouter
    from clawker_tpu_torch.loopd.client import discover_all
    from clawker_tpu_torch.tracing.merge import merge_run

    name = "federation (c)"
    hold = threading.Event()

    def held(io) -> int:
        if not hold.is_set():
            hold.wait(30.0)
        return 0

    with _fed_pods(base, device, sentinel=False, behavior=held) \
            as (proj, cfg, drivers, servers):
        router = FederationRouter(cfg, discover_all(cfg))
        try:
            pod, ack = router.submit({"parallel": FED_MIGRATE_AGENTS,
                                      "iterations": LOOP_ITERATIONS,
                                      "tenant": "mig"})
            run_id = ack["run"]
            check(pod == FED_PODS[0], f"{name}: the run landed on {pod}")
            victim = servers.pop(pod)
            survivor_name = next(p for p in FED_PODS if p != pod)
            survivor = servers[survivor_name]
            check(_wait(lambda: _total_creates(drivers[pod])
                        == FED_MIGRATE_AGENTS, 30),
                  f"{name}: {_total_creates(drivers[pod])} creates on {pod}")
            before = _total_creates(drivers[pod])
            t0 = time.perf_counter()
            victim.kill()
            moved = router.migrate_pod(pod, orphan_grace_s=FED_ORPHAN_GRACE_S)
            migrate_ms = (time.perf_counter() - t0) * 1e3
            hold.set()
            run = survivor.runs.get(run_id)
            done = run is not None and run.done.wait(60)
            wall = (time.perf_counter() - t0) * 1e3
            home = router.placements().get(run_id)
        finally:
            hold.set()
            router.close()
        check(moved == [run_id] and home == survivor_name and done
              and run.result["ok"]
              and len(run.result["agents"]) == FED_MIGRATE_AGENTS
              and all(a["status"] == "done"
                      and a["iteration"] == LOOP_ITERATIONS
                      for a in run.result["agents"]),
              f"{name}: moved {moved}, home {home}, result "
              f"{run.result if run else None}")
        check(_total_creates(drivers[pod]) == before,
              f"{name}: the dead pod created after the kill")
        violations = cross_pod_exactly_once(drivers, cfg, run_id)
        check(violations == [], f"{name}: {violations}")
        merged = merge_run(cfg.logs_dir, run_id)

    def iterations(node) -> int:
        return (node.record.name == "iteration") + sum(
            iterations(c) for c in node.children)

    rooted = [r for r in merged.roots if iterations(r)]
    check(len(rooted) == 1 and rooted[0].record.name == "router.submit"
          and iterations(rooted[0]) >= FED_MIGRATE_AGENTS * LOOP_ITERATIONS,
          f"{name}: trace roots {[(r.record.name, iterations(r)) for r in merged.roots]}")
    print(card_line())
    print(f"{name}: {FED_MIGRATE_AGENTS} loops x {LOOP_ITERATIONS} held on "
          f"{pod}, killed after {before} creates: migrate_pod {migrate_ms!r} "
          f"ms, kill to every loop done on {survivor_name} {wall!r} ms "
          f"(orphan grace {FED_ORPHAN_GRACE_S} s); cross_pod_exactly_once "
          f"green; the merged trace's {iterations(rooted[0])} iterations "
          f"under one router.submit root ({merged.spans} spans, "
          f"{merged.gaps} gaps)")
    return {"migrate_pod": migrate_ms, "migration": wall}


def fed_lease_case(base: Path, device) -> dict:
    """(d), host work: bench.py:1635's fan-out scaled to the two pods
    (4 fake workers each, 64 runs of 2 loops in global-WFQ order over
    four tenants) with FED_RTT_S injected on every admission RPC: every
    loop reaches its budget, no daemon launches past its cap, and the
    capacity leases cost at least LEASE_AMORTIZATION_MIN x fewer
    admission RPCs than the per-launch protocol over the same pods;
    -> walls and counts."""
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.federation import FederationRouter, LeaseManager
    from clawker_tpu_torch.loopd.client import discover_all

    name = "federation (d)"
    with _fed_pods(base, device, sentinel=False, workers=FED_LEASE_WORKERS,
                   behavior=exit_behavior(b"done\n", 0)) \
            as (proj, cfg, drivers, servers):
        cap = cfg.settings.loop.placement.max_inflight_per_worker
        router = FederationRouter(cfg, discover_all(cfg),
                                  control_rtt_s=FED_RTT_S)
        try:
            reqs = [(f"tenant-{i % 4}",
                     {"parallel": FED_LEASE_PER_RUN, "iterations": 1,
                      "tenant": f"tenant-{i % 4}"})
                    for i in range(FED_LEASE_RUNS)]
            t0 = time.perf_counter()
            results = router.submit_many(reqs)
            submit_ms = (time.perf_counter() - t0) * 1e3
            lease_rpcs = router.lease.rpcs
            runs = {ack["run"] for _, ack in results}
            check(_wait(lambda: all(
                srv.runs[r].done.is_set() for srv in servers.values()
                for r in list(srv.runs) if r in runs), 120),
                f"{name}: runs still live")
            fan_ms = (time.perf_counter() - t0) * 1e3
            loops = sum(len(run.result["agents"])
                        for srv in servers.values()
                        for run in srv.runs.values()
                        if run.result and run.result["ok"])
            per_pod = collections.Counter(pod for pod, _ in results)
            baseline = LeaseManager(tokens=1, ttl_s=1.0, amortize=False,
                                    rtt_s=FED_RTT_S)
            t1 = time.perf_counter()
            for pod, count in per_pod.items():
                client = router.registry.pods[pod].client
                for _ in range(count):
                    baseline.spend(pod, client)
            baseline_ms = (time.perf_counter() - t1) * 1e3
        finally:
            router.close()
        hwm = max(g.launch_hwm for drv in drivers.values() for g in drv.gates)
    ratio = baseline.rpcs / max(lease_rpcs, 1)
    check(len(results) == FED_LEASE_RUNS
          and loops == FED_LEASE_RUNS * FED_LEASE_PER_RUN and hwm <= cap,
          f"{name}: {loops} loops done, launch high-water mark {hwm} "
          f"(cap {cap})")
    check(ratio >= LEASE_AMORTIZATION_MIN,
          f"{name}: {lease_rpcs} lease RPCs against {baseline.rpcs} "
          f"per-launch ones ({ratio!r} x, want {LEASE_AMORTIZATION_MIN})")
    print(f"{name} (host work): {loops} loops in {FED_LEASE_RUNS} runs over "
          f"{dict(per_pod)} at {FED_RTT_S * 1e3} ms a control RPC: submits "
          f"{submit_ms!r} ms, every loop done {fan_ms!r} ms; {lease_rpcs} "
          f"lease RPCs against {baseline.rpcs} per-launch RPCs "
          f"({baseline_ms!r} ms): {ratio!r} x; launch high-water mark "
          f"{hwm} (cap {cap})")
    return {"lease_rpcs": lease_rpcs, "per_launch_rpcs": baseline.rpcs,
            "ratio": ratio}


def federation_phase(device) -> collections.Counter:
    """Drives ``loop --pods`` over two loopd pods with their daemon
    sentinels on the card, the fleet views, a pod's death and the
    capacity leases; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "federation"
    t0 = time.perf_counter()
    with stage_timers({}) as stages, \
            _fed_pods(out / "a", device, sentinel=True) \
            as (proj, cfg, drivers, servers):
        status_ms = fed_status_case(proj)
        logs = fed_sentinel_case(proj, cfg, servers, stages)
    launches = fed_launches(logs)
    walls = fed_migrate_case(out / "c", device)
    leases = fed_lease_case(out / "d", device)
    no_daemon_left()
    no_process_left("federation")
    print(f"federation: fed status forked {status_ms!r} ms; migration walls "
          f"{json.dumps(walls)}; lease RPC ratio {leases['ratio']!r}; "
          f"launches {json.dumps(launches)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return launches


# ---------------------------------------------------------- bundles phase


BUNDLE_NAME = "tb"                      # the example bundle, installed
BUNDLE_HARNESS = "echo"                 # its harness
BUNDLE_TAGS = tuple(f"{IMAGES_REPO}:{t}"
                    for t in ("base", BUNDLE_HARNESS, "default"))
BUNDLE_CMD = "echo hello from the updated bundle"
GIT_ENV = {"GIT_CONFIG_NOSYSTEM": "1"}  # the repos ignore the host's config
GRACE_AGE_S = 30 * 86400                # an install older than prune's grace


def _bundle_harness(repo: Path, cmd: str) -> None:
    (repo / "harnesses" / BUNDLE_HARNESS / "harness.yaml").write_text(
        f"name: {BUNDLE_HARNESS}\ndescription: example harness\n"
        f"cmd: [\"sh\", \"-c\", \"{cmd}\"]\n")


def _age_receipt(path: Path) -> None:
    from clawker_tpu_torch.bundle.manager import RECEIPT

    receipt = path / RECEIPT
    doc = json.loads(receipt.read_text())
    doc["installed_at"] = time.time() - GRACE_AGE_S
    receipt.write_text(json.dumps(doc))


def bundles_verbs_case(base: Path, proj: Path, env: dict) -> Path:
    """(a): ``examples/clawker-test-bundle`` committed into a fresh
    repository; forked ``bundle install file://REPO``, ``list``,
    ``validate``; a commit, then ``bundle update`` re-installs at the
    new commit; an unreferenced install past prune's grace is reported
    by ``bundle prune`` and removed by ``--apply`` (the example bundle's
    monitoring unit keeps it); -> the repository."""
    from clawker_tpu_torch.bundle import BundleManager
    from clawker_tpu_torch.config import load_config

    name = "bundles (a)"
    repo = base / "repo"
    shutil.copytree(ROOT / "examples" / "clawker-test-bundle", repo)
    _git_repo(repo)
    url = f"file://{repo}"

    def run(args, want=0):
        return _images_run(name, args, proj, env, want)[0]

    proc = run(["bundle", "install", url, "--name", BUNDLE_NAME])
    check(proc.stdout == f"installed local/{BUNDLE_NAME} (harness:1, "
          "stack:1, monitoring:1)\n", f"{name}: install said {proc.stdout!r}")
    listed = run(["bundle", "list"]).stdout.splitlines()
    check(f"bundle\tlocal/{BUNDLE_NAME}\t{url}" in listed
          and any(line.startswith(f"harness\t{BUNDLE_HARNESS}\t")
                  for line in listed), f"{name}: bundle list {listed}")
    check(run(["bundle", "validate", str(repo)]).stdout == "ok\n",
          f"{name}: validate")
    check(run(["bundle", "update"]).stdout == "all bundles current\n",
          f"{name}: update before a commit")
    _bundle_harness(repo, BUNDLE_CMD)
    _git(repo, "commit", "-q", "-am", "update the harness")
    head = _git(repo, "rev-parse", "HEAD").stdout.strip()
    check(run(["bundle", "update"]).stdout == f"updated local/{BUNDLE_NAME}\n",
          f"{name}: update after a commit")
    mgr = BundleManager(load_config(proj))
    (inst,) = [b for b in mgr.list_installed() if b.name == BUNDLE_NAME]
    check(inst.commit == head, f"{name}: receipt commit {inst.commit}, "
          f"HEAD {head}")
    lone = base / "lonely" / "harnesses" / "lonely"
    lone.mkdir(parents=True)
    (lone / "harness.yaml").write_text("name: lonely\ncmd: [true]\n")
    run(["bundle", "install", str(lone.parent.parent)])
    for b in mgr.list_installed():
        _age_receipt(b.path)
    dry = run(["bundle", "prune"]).stdout
    check(dry == "unreferenced\tlocal/lonely\ndry-run: pass --apply to "
          "delete\n", f"{name}: prune said {dry!r}")
    applied = run(["bundle", "prune", "--apply"]).stdout
    check(applied == "unreferenced\tlocal/lonely\nremoved 1\n"
          and [b.name for b in mgr.list_installed()] == [BUNDLE_NAME],
          f"{name}: prune --apply said {applied!r}")
    print(f"{name}: bundle install {url} at {head[:12]}, list, validate, "
          f"update (all current, then after a commit), prune dry run and "
          f"--apply: each as the reference's")
    return repo


def bundles_card_case(base: Path, proj: Path, repo: Path, device: str,
                      home: Path) -> collections.Counter:
    """(b): settings ``build.harness: echo``; forked ``build --plain``
    over a ``FakeEngineDaemon`` tags the bundle's harness stage with its
    updated command; a second commit, the auto-update's day stamp
    cleared, then ``run -d`` reports the drifted bundle and starts; then
    images (d)'s ``loop -p 8 -n 3 --sentinel`` run on the built image in
    process (every scored tick one K3 and one K1, the hot agent
    flagged); images (d) forks that same loop, so this case does not;
    -> launches."""
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.state import StateStore

    name = "bundles (b)"
    (proj / ".clawker.yaml").write_text(
        f"project: {LOOP_PROJECT}\nbuild:\n  harness: {BUNDLE_HARNESS}\n")
    with _images_daemon("2") as daemon:
        env = _images_env(daemon)
        _, build_ms = _images_run(name, ["build", "--plain"], proj, env)
        check(set(BUNDLE_TAGS) <= set(daemon.api.images),
              f"{name}: built {sorted(daemon.api.images)}")
        harness_ctx = next(tar for tags, tar in daemon.contexts
                           if tags == [BUNDLE_TAGS[1]])
        dockerfile = _ctx_members(harness_ctx)["Dockerfile"].decode()
        check(BUNDLE_CMD in dockerfile,
              f"{name}: the harness stage's Dockerfile {dockerfile[-600:]}")
        _bundle_harness(repo, BUNDLE_CMD + " again")
        _git(repo, "commit", "-q", "-am", "drift")
        StateStore().delete("bundle_auto_update")
        daemon.api.set_behavior(BUNDLE_TAGS[2], exit_behavior(b"hi\n", 0))
        proc, run_ms = _images_run(name, ["run", "-d", "--agent", "bundled"],
                                   proj, env)
        check(proc.stdout == f"clawker.{LOOP_PROJECT}.bundled\n"
              and f"bundle updated: local/{BUNDLE_NAME}" in proc.stderr,
              f"{name}: run -d said {proc.stdout!r} {proc.stderr[-1500:]!r}")
        with stage_timers({}) as stages:
            launches, walls = images_card_case(
                base / "d", proj, daemon, device, stages, home,
                tags=BUNDLE_TAGS, name=name, fork=False)
        check(not daemon.unrouted, f"{name}: requests the daemon has no "
              f"route for: {daemon.unrouted}")
    print(f"{name}: build --plain with the installed harness {build_ms!r} ms, "
          f"run -d with the auto-update {run_ms!r} ms, loop ms "
          f"{json.dumps(walls)}")
    return launches


def _tree_listing(root: Path) -> list[tuple]:
    return sorted((str(p.relative_to(root)), p.stat().st_size,
                   p.stat().st_mtime_ns) for p in root.rglob("*")
                  if p.is_file())


def bundles_tools_case(base: Path, proj: Path, env: dict) -> None:
    """(c): ``plugin install|list|remove`` of ``examples/clawker-plugin``
    into a harness skills dir under ``build/`` (``CLAUDE_CONFIG_DIR``);
    ``gen-docs --out build/chip_smoke/docs/cli-reference`` writes its
    pages and schemas there and nothing under ``docs/``; the update
    check with a stubbed fetcher, cached for its TTL."""
    from clawker_tpu_torch import __version__
    from clawker_tpu_torch.state import StateStore, check_for_update

    name = "bundles (c)"
    claude = base / "claude"
    penv = dict(env, CLAUDE_CONFIG_DIR=str(claude))
    source = str(ROOT / "examples" / "clawker-plugin")

    def run(args):
        return _images_run(name, args, proj, penv)[0].stdout

    check(run(["plugin", "install", "--source", source])
          == "installed hello-skill\n"
          and (claude / "skills" / "hello-skill" / "SKILL.md").is_file(),
          f"{name}: plugin install")
    check(run(["plugin", "list"]).startswith("hello-skill\t"),
          f"{name}: plugin list")
    check(run(["plugin", "remove", "--source", source, "--yes"])
          == "removed hello-skill\n"
          and not (claude / "skills" / "hello-skill").exists(),
          f"{name}: plugin remove")
    docs = ROOT / "docs"
    before = _tree_listing(docs)
    out = ROOT / "build" / "chip_smoke" / "docs" / "cli-reference"
    if out.parent.exists():
        shutil.rmtree(out.parent)
    said = run(["gen-docs", "--out", str(out)]).splitlines()
    pages = sorted(p.name for p in out.iterdir())
    schemas = sorted(p.name for p in (out.parent / "schemas").iterdir())
    check(said[0] == f"wrote {len(pages)} pages under {out}"
          and {"clawker.md", "README.md", "clawker_fed_status.md",
               "clawker_bundle_prune.md", "clawker_fleet_health.md",
               "clawker_plugin_install.md"} <= set(pages)
          and schemas == ["clawker.schema.json", "settings.schema.json"]
          and _tree_listing(docs) == before,
          f"{name}: gen-docs said {said}, pages {pages}, schemas {schemas}")
    fetched = []

    def fetch() -> str:
        fetched.append(1)
        return "v99.0.0"

    store = StateStore(base / "cli-state.json")
    lines = [check_for_update(state=store, fetch=fetch) for _ in range(2)]
    check(lines[0] == lines[1] == f"clawker-tpu v99.0.0 is available (you "
          f"have {__version__})" and fetched == [1],
          f"{name}: update check {lines}, fetched {len(fetched)}")
    print(f"{name}: plugin install/list/remove of hello-skill; gen-docs "
          f"{len(pages)} pages and {len(schemas)} schemas under "
          f"build/chip_smoke/docs, docs/ untouched; the update check with a "
          f"stubbed fetcher: {lines[0]!r}, fetched once")


def bundles_phase(device) -> collections.Counter:
    """Installs, updates and prunes a bundle with the ``bundle`` verbs,
    builds the project on its harness, runs ``run -d`` with the
    auto-update and ``loop --sentinel`` on the built image, the
    sentinel scoring on the card; then the plugin lanes, ``gen-docs``
    and the update check; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "bundles"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    supervisor = SUPERVISOR_OUT / "clawker-supervisord"
    if not supervisor.is_file():
        supervisor, _ = _build_supervisor()
    saved = {k: os.environ.get(k)
             for k in ("CLAWKER_TPU_SUPERVISOR_BIN", *GIT_ENV)}
    os.environ.update(GIT_ENV, CLAWKER_TPU_SUPERVISOR_BIN=str(supervisor))
    home = _harness_home(out)
    try:
        with _pinned_home(home), _isolated_dirs(out / "a", IMAGES_SETTINGS,
                                                proxy=False) as proj:
            env = dict(os.environ, PYTHONPATH=str(ROOT))
            for k in ("CLAWKER_TPU_DRIVER", "CLAWKER_TPU_FAKE_IMAGES"):
                env.pop(k, None)
            repo = bundles_verbs_case(out / "a", proj, env)
            launches = bundles_card_case(out / "b", proj, repo, device, home)
            bundles_tools_case(out / "c", proj, env)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    no_daemon_left()
    no_process_left("bundles")
    print(f"bundles launches: {json.dumps(launches)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return launches


# ------------------------------------------------------------ egress phase


EGRESS_SEED = 20260822
EGRESS_CONTAINERS = 64
EGRESS_ROUNDS = 3               # drains, each in its own second: the
#                                 netlogger stamps a record with the
#                                 second it drained it in
EGRESS_STORM = 55               # the storm's connects (exfil_burst's n)
EGRESS_STORM_SLOT = 37
EGRESS_CGROUP0 = 7000           # cgroup ids 7000..7063
EGRESS_ENVOY, EGRESS_GATE_IP = "10.99.0.2", "10.99.0.3"
EGRESS_TLS_PORT = 10000
EGRESS_RULES = (("*.alpha.example", "https", 0),     # Envoy redirect
                ("*.beta.example", "tcp", 443))      # direct allow
EGRESS_HOSTS = {"api.alpha.example": ["198.51.100.10", "198.51.100.11"],
                "cdn.beta.example": ["198.51.100.20"]}
EGRESS_QUERY_TIMEOUT_S = 2.0    # each DNS query's own timeout
EGRESS_THRESHOLD = 3.5
EGRESS_WINDOW_S = 1
EGRESS_FLAG_DEADLINE_S = 10.0
MONITOR_SERVICES = {"otel-collector", "opensearch", "opensearch-bootstrap",
                    "opensearch-dashboards", "prometheus"}
# the verdicts' reasons for which a decision emits an event
# (``firewall/policy.py`` ``decide``: every verdict but the early allows)
EMITTING_REASONS = {"BYPASS", "ROUTE", "NO_ROUTE", "NO_DNS_ENTRY", "MONITOR",
                    "IPV6", "RAW_SOCKET"}


def egress_modules():
    """The port's egress lane, as ``egress_traffic`` takes it."""
    from types import SimpleNamespace

    from clawker_tpu_torch.config import schema
    from clawker_tpu_torch.firewall import dnsgate, hashes, maps, model, policy
    from clawker_tpu_torch.monitor import netlogger

    return SimpleNamespace(dnsgate=dnsgate, hashes=hashes, maps=maps,
                           model=model, policy=policy, netlogger=netlogger,
                           schema=schema)


def egress_container(i: int) -> str:
    return f"clawker.{LOOP_PROJECT}.egress-{i:02d}"


class LoopbackUpstream:
    """A resolver on ``127.0.0.1``, port 0, answering A queries from
    ``EGRESS_HOSTS`` (NXDOMAIN otherwise): the DNS gate's upstream, as
    tests/test_dnsgate.py's fake; nothing leaves the host."""

    TTL_S = 120

    def __init__(self):
        import socket
        import socketserver
        import struct

        from clawker_tpu_torch.firewall import dnsgate

        def answer(data: bytes) -> bytes:
            q = dnsgate.parse_query(data)
            ips = EGRESS_HOSTS.get(q.qname)
            if ips is None:
                return dnsgate.synthesize(q, dnsgate.RCODE_NXDOMAIN)
            hdr = struct.pack(">HHHHHH", q.qid, 0x8180, 1, len(ips), 0, 0)
            return hdr + q.raw_question + b"".join(
                struct.pack(">HHHIH", 0xC00C, dnsgate.QTYPE_A, 1, self.TTL_S,
                            4)
                + socket.inet_aton(ip) for ip in ips)

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                data, sock = self.request
                try:
                    sock.sendto(answer(data), self.client_address)
                except dnsgate.DnsWireError:
                    pass

        self.srv = socketserver.ThreadingUDPServer(("127.0.0.1", 0), _H)
        self.addr = f"127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       kwargs={"poll_interval": 0.05},
                                       name="loopback-upstream", daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(2)


def loopback_forward(data: bytes, resolvers, *, tcp: bool):
    """``DnsGate._forward`` over resolvers named ``host:port`` on
    loopback (the gate's own forwards to port 53): UDP whichever lane
    the query came in on, a timeout per query, the reply's transaction
    id checked."""
    import socket

    for resolver in resolvers:
        host, port = resolver.rsplit(":", 1)
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.settimeout(EGRESS_QUERY_TIMEOUT_S)
                s.connect((host, int(port)))
                s.send(data)
                reply = s.recv(4096)
                if reply[:2] == data[:2]:
                    return reply
        except OSError:
            continue
    return None


def _gate_query(m, port: int, name: str, qid: int) -> bytes:
    """One A query to the gate over UDP, with its own timeout."""
    import socket
    import struct

    q = (struct.pack(">HHHHHH", qid, 0x0100, 1, 0, 0, 0)
         + m.dnsgate._encode_name(name)
         + struct.pack(">HH", m.dnsgate.QTYPE_A, 1))
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(EGRESS_QUERY_TIMEOUT_S)
        s.sendto(q, ("127.0.0.1", port))
        return s.recvfrom(4096)[0]


def egress_traffic(m, out_path: Path, upstream: str, *, next_drain,
                   containers: int = EGRESS_CONTAINERS,
                   storm_slot: int | None = EGRESS_STORM_SLOT) -> dict:
    """Seeded egress through one package's lane ``m`` (``dnsgate``,
    ``hashes``, ``maps``, ``model``, ``policy``, ``netlogger``,
    ``schema``): ``containers`` cgroups enrolled with ``FLAG_ENFORCE`` in
    a ``FakeMaps``, the routes ``build_routes`` makes of
    ``EGRESS_RULES``, a ``DnsGate`` on loopback forwarding to
    ``upstream``.  Each round every container connects to the gate (an
    allow, no event), resolves one of ``EGRESS_HOSTS`` through it (the
    gate writes ``dns_cache``), makes 6-10 connects to the answers
    (routed) and 1-2 to addresses it never resolved (``NO_DNS_ENTRY``
    denies), for ``EGRESS_ROUNDS`` rounds; in the last the storm
    container adds ``EGRESS_STORM`` connects to unresolved addresses on
    odd ports (no storm where ``storm_slot`` is None).
    ``next_drain()`` runs before each round's drains (the caller's
    clock: a new second), and a ``NetLogger`` with resolvers from this
    run's cgroup and zone tables drains the ring into ``out_path`` until
    it is empty; -> the run's counts."""
    import random

    M, P = m.model, m.policy
    rng = random.Random(EGRESS_SEED)
    rules = [m.schema.EgressRule(dst=d, proto=proto, port=port)
             for d, proto, port in EGRESS_RULES]
    maps = m.maps.FakeMaps()
    maps.sync_routes(P.build_routes(rules, envoy_ip=EGRESS_ENVOY,
                                    tls_port=EGRESS_TLS_PORT))
    names = {EGRESS_CGROUP0 + i: egress_container(i)
             for i in range(containers)}
    for cg in names:
        maps.enroll(cg, M.ContainerPolicy(envoy_ip=EGRESS_ENVOY,
                                          dns_ip=EGRESS_GATE_IP,
                                          flags=M.FLAG_ENFORCE))
    zones = {m.hashes.zone_hash(d[2:]): d[2:] for d, _, _ in EGRESS_RULES}
    nl = m.netlogger.NetLogger(
        maps, out_path=out_path, resolve_cgroup=lambda cg: names.get(cg, ""),
        resolve_zone=lambda zh: zones.get(zh, ""))
    gate = m.dnsgate.DnsGate(m.dnsgate.ZonePolicy.from_rules(rules), maps,
                             upstreams=(upstream,), host="127.0.0.1", port=0)
    gate._forward = loopback_forward
    hosts = sorted(EGRESS_HOSTS)
    verdicts = []
    drained = []
    gate.start()
    try:
        for r in range(EGRESS_ROUNDS):
            for i, cg in enumerate(names):
                verdicts.append(P.connect4(maps, cg, EGRESS_GATE_IP, 53,
                                           M.PROTO_UDP))
                reply = _gate_query(m, gate.bound_port,
                                    hosts[(i + r) % len(hosts)],
                                    qid=1 + r * containers + i)
                ips = [ip for ip, _ in m.dnsgate.parse_a_records(reply)]
                check(ips, f"egress: the gate answered {reply!r}")
                for k in range(rng.randint(6, 10)):
                    verdicts.append(P.connect4(maps, cg, ips[k % len(ips)],
                                               443))
                for _ in range(rng.randint(1, 2)):
                    verdicts.append(P.connect4(
                        maps, cg, f"192.0.2.{rng.randint(1, 254)}", 443))
            if r == EGRESS_ROUNDS - 1 and storm_slot is not None:
                storm = EGRESS_CGROUP0 + storm_slot
                for k in range(EGRESS_STORM):
                    verdicts.append(P.connect4(maps, storm, f"203.0.113.{k}",
                                               4444 + k))
            next_drain()
            n = 0
            while (got := nl.drain_once()):
                n += got
            drained.append(n)
    finally:
        gate.stop()
    return {
        "decisions": len(verdicts),
        "emitting": sum(1 for v in verdicts
                        if v.reason.name in EMITTING_REASONS
                        or v.action.name == "REDIRECT_DNS"),
        "denies": sum(1 for v in verdicts if v.action.name == "DENY"),
        "emitted": nl.emitted, "drained": drained,
        "events_dropped": maps.events_dropped,
        "dns_cache": len(maps.dns_entries()),
        "gate": dict(vars(gate.stats)),
        "storm": None if storm_slot is None else egress_container(storm_slot),
    }


def _next_second() -> None:
    """Sleep into the next wall-clock second (20 ms past its start), so a
    round's drains share one second and the next round's come at least
    one second later."""
    now = time.time()
    time.sleep(int(now) + 1.02 - now)


def egress_traffic_case(proj: Path, env: dict) -> tuple:
    """(a): ``egress_traffic`` through the port's lane into the logs
    dir's ``ebpf-egress.jsonl``; every event emitted, none dropped; the
    forked ``monitor egress --deny-only --tail 5`` prints the storm's
    last five denies; -> (the stream, the storm container)."""
    from clawker_tpu_torch.config import load_config

    name = "egress (a)"
    path = load_config(proj).logs_dir / "ebpf-egress.jsonl"
    t0 = time.perf_counter()
    with LoopbackUpstream() as up:
        run = egress_traffic(egress_modules(), path, up.addr,
                             next_drain=_next_second)
    traffic_ms = (time.perf_counter() - t0) * 1e3
    storm = run["storm"]
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    seconds = sorted({r["@timestamp"] for r in recs})
    check(run["emitted"] == run["emitting"] == len(recs)
          == sum(run["drained"]) and run["events_dropped"] == 0,
          f"{name}: {run}, {len(recs)} records")
    check(len(seconds) == EGRESS_ROUNDS and all(run["drained"]),
          f"{name}: drains {run['drained']} stamped {seconds}")
    check(run["gate"]["queries"] == run["gate"]["allowed"]
          == EGRESS_CONTAINERS * EGRESS_ROUNDS
          and run["gate"]["refused"] == run["gate"]["upstream_errors"] == 0
          and run["dns_cache"] == sum(map(len, EGRESS_HOSTS.values())),
          f"{name}: gate {run['gate']}, dns_cache {run['dns_cache']}")
    by_reason = collections.Counter((r["verdict"], r["reason"]) for r in recs)
    check(set(by_reason) == {("REDIRECT", "ROUTE"), ("ALLOW", "ROUTE"),
                             ("DENY", "NO_DNS_ENTRY")}
          and all(r["container"] for r in recs)
          and all(r["zone"] for r in recs if r["reason"] == "ROUTE"),
          f"{name}: verdicts {dict(by_reason)}")
    proc, tail_ms = _cli(["monitor", "egress", "--deny-only", "--tail", "5"],
                         proj, env)
    shown = proc.stdout.splitlines()
    check(proc.returncode == 0 and len(shown) == 5
          and all(f"\tDENY\t{storm}\t203.0.113." in line
                  and line.endswith("\t-\tNO_DNS_ENTRY") for line in shown),
          f"{name}: monitor egress exited {proc.returncode}: {shown} "
          f"{proc.stderr[-1500:]}")
    print(f"{name}: {run['decisions']} decisions ({run['denies']} denies) by "
          f"{EGRESS_CONTAINERS} containers over {EGRESS_ROUNDS} drains "
          f"{run['drained']} stamped {seconds}, {run['emitted']} events "
          f"emitted and written, 0 dropped; gate {json.dumps(run['gate'])}; "
          f"storm {storm}")
    print(f"{name} host ms: traffic with the drains {traffic_ms!r}, forked "
          f"monitor egress --deny-only --tail 5 {tail_ms!r}")
    return path, storm


def egress_cli_case(path: Path, storm: str, proj: Path, env: dict,
                    device: str) -> None:
    """(b): ``monitor anomalies --window 1 --threshold 3.5`` forked on
    the card over the netlogger's file: exit 2, the storm container
    first and anomalous."""
    name = "egress (b)"
    proc, ms = _cli(["monitor", "anomalies", "--input", str(path), "--window",
                     str(EGRESS_WINDOW_S), "--format", "json", "--threshold",
                     str(EGRESS_THRESHOLD)], proj,
                    dict(env, CLAWKER_TORCH_DEVICE=device))
    check(proc.returncode == 2, f"{name}: monitor anomalies exited "
          f"{proc.returncode}, want 2: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    top = doc["agents"][0]
    check(doc["device"].startswith(device)
          and top["agent"] == storm and top["anomalous"]
          and top["latest_z"] >= EGRESS_THRESHOLD,
          f"{name}: device {doc['device']}, top rows {doc['agents'][:3]}")
    flagged = [a["agent"] for a in doc["agents"] if a["anomalous"]]
    print(f"{name}: monitor anomalies exit 2, {doc['windows']} windows on "
          f"{doc['device']} (fit {doc['train_ms']} ms, score "
          f"{doc['score_ms']} ms), {storm} first at z {top['latest_z']}, "
          f"{len(flagged)} agent(s) anomalous")
    print(f"{name} host ms: forked monitor anomalies {ms!r}")


def egress_sentinel_case(base: Path, path: Path, storm: str, device: str,
                         stages: dict) -> collections.Counter:
    """(c): a live ``FleetSentinel`` whose collector tails the
    netlogger's file, one-second windows, ticking on its thread: the
    storm container's ``anomaly.flag`` reaches the bus, its row ranks
    first and is flagged, and every scored tick is one K3 and one K1;
    -> launches."""
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG, EventBus
    from clawker_tpu_torch.sentinel import FleetSentinel, StreamCollector

    name = "egress (c)"
    col = StreamCollector()
    col.add_local("egress", path)
    s = FleetSentinel(_Cfg(base), collector=col, window_s=EGRESS_WINDOW_S,
                      train_steps=SENTINEL_STEPS, interval_s=LOOP_TICK_S,
                      threshold=EGRESS_THRESHOLD, device=device)
    log = TickLog(s, stages)
    flags: dict = {}
    bus = EventBus(lambda agent, ev, detail:
                   flags.setdefault(agent, time.perf_counter())
                   if ev == ANOMALY_FLAG else None)
    s.bind_run(events=bus)
    t0 = time.perf_counter()
    s.start()
    _wait(lambda: storm in flags, EGRESS_FLAG_DEADLINE_S, 0.005)
    _wait(lambda: len(log.ticks) >= 2, 5.0, 0.005)   # an idle tick too
    s.stop()
    bus.close()
    check(storm in flags, f"{name}: no flag for {storm} within "
          f"{EGRESS_FLAG_DEADLINE_S} s: {s.flags()}")
    scored = log.check_run(name)
    rows = sorted(s.rows(), key=lambda r: -r["latest_z"])
    check(rows[0]["agent"] == storm and rows[0]["flagged"],
          f"{name}: rows {rows[:3]}")
    flagged = [r["agent"] for r in rows if r["flagged"]]
    print(f"{name}: live sentinel over the netlogger's file "
          f"({s.collector.total()} records, windows of {EGRESS_WINDOW_S} s): "
          f"{len(log.ticks)} ticks, {len(scored)} scored "
          f"({scored[0][0]} windows), {storm} first at z "
          f"{rows[0]['latest_z']} and flagged on the bus "
          f"{(flags[storm] - t0) * 1e3!r} ms after start; flagged "
          f"{flagged}; launches {json.dumps(dict(log.launches()))}")
    print(f"{name}: {log.stage_line()}")
    return log.launches()


class _ComposeRecorder:
    """The monitor stack's runner seam: records each ``docker compose``
    argv and answers as compose would."""

    def __init__(self, stdout: str = ""):
        self.calls: list[tuple] = []
        self.stdout = stdout

    def __call__(self, *args):
        self.calls.append(args)
        return subprocess.CompletedProcess(args, 0, self.stdout, "")


def egress_stack_case(proj: Path, env: dict) -> None:
    """(d): forked ``monitor init`` (the five compose services, the seven
    log indices) and ``monitor units`` (the floor's ``claude-code``
    seeded); then ``up``, ``status`` and ``down`` in process over a
    recording runner: the ``up -d`` argv and the units ledger reset."""
    import yaml

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.monitor.ledger import LEDGER_FILE
    from clawker_tpu_torch.monitor.stack import LOG_INDICES, MonitorStack

    name = "egress (d)"
    cfg = load_config(proj)
    stack_dir = cfg.data_dir / "monitor"
    proc, init_ms = _cli(["monitor", "init"], proj, env)
    check(proc.returncode == 0 and proc.stdout == (
        f"rendered monitor stack under {stack_dir}\nindices: "
        + ", ".join(LOG_INDICES) + "\n") and len(LOG_INDICES) == 7,
          f"{name}: monitor init exited {proc.returncode}: {proc.stdout!r} "
          f"{proc.stderr[-1500:]}")
    compose = yaml.safe_load((stack_dir / "compose.yaml").read_text())
    check(set(compose["services"]) == MONITOR_SERVICES,
          f"{name}: services {sorted(compose['services'])}")
    proc, units_ms = _cli(["monitor", "units"], proj, env)
    rows = [line.split("\t") for line in proc.stdout.splitlines()]
    check(proc.returncode == 0
          and ["claude-code", "seeded", "claude-code"] in
          [r[:3] for r in rows], f"{name}: monitor units said {rows}")
    runner = _ComposeRecorder(
        '{"Service": "opensearch", "State": "running"}\n'
        '[{"Service": "prometheus", "State": "running"}]\n')
    stack = MonitorStack(cfg, runner=runner)
    t0 = time.perf_counter()
    stack.up()
    status = stack.status()
    had_ledger = (stack.dir / LEDGER_FILE).exists()
    stack.down()
    inproc_ms = (time.perf_counter() - t0) * 1e3
    check(runner.calls == [("up", "-d", "--remove-orphans"),
                           ("ps", "--format", "json"), ("down", "--volumes")]
          and status == [{"Service": "opensearch", "State": "running"},
                         {"Service": "prometheus", "State": "running"}]
          and had_ledger and not (stack.dir / LEDGER_FILE).exists(),
          f"{name}: runner calls {runner.calls}, status {status}, ledger "
          f"before down {had_ledger}")
    print(f"{name}: monitor init rendered {sorted(compose['services'])} and "
          f"the indices {list(LOG_INDICES)}; monitor units {rows}; up, "
          f"status and down over the recording runner: {runner.calls}, the "
          f"units ledger reset")
    print(f"{name} host ms: forked monitor init {init_ms!r}, forked monitor "
          f"units {units_ms!r}, up+status+down in process {inproc_ms!r}")


def egress_phase(device) -> collections.Counter:
    """The egress lane and the monitor stack: policy decisions on names
    the DNS gate resolved, the netlogger's file, that file scored on the
    card through ``monitor anomalies`` and a live sentinel, and the
    stack's verbs; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "egress"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    with _isolated_dirs(out / "a", proxy=False) as proj:
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        for k in ("CLAWKER_TPU_DRIVER", "CLAWKER_TPU_FAKE_IMAGES"):
            env.pop(k, None)
        path, storm = egress_traffic_case(proj, env)
        egress_cli_case(path, storm, proj, env, device)
        with stage_timers({}) as stages:
            launches = egress_sentinel_case(out / "c", path, storm, device,
                                            stages)
        egress_stack_case(proj, env)
    no_process_left("egress")
    print(f"egress launches: {json.dumps(launches)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return launches


# ---------------------------------------------------------- firewall phase


FW_ENVOY_IMAGE = "envoyproxy/envoy:v1.30.2"
FW_ROUNDS = 3                   # drains, each in its own second
FW_HOLD_S = 60.0                # the longest an iteration holds its container
FW_BYPASS_S = 1.0
FW_VERB_TIMEOUT_S = 120
FW_ADDED = "*.gamma.example"    # the rule (c) adds while the run lives
FW_VERBS = (("add-rule", "*.pypi.org"), ("rules",),
            ("resolve", "files.pypi.org"), ("status",))


def _fw_settings(upstream: str, extra: str = "") -> str:
    """Settings of the monitor-mode firewall: the fake driver's
    containers have no cgroups for the kernel half to enforce, so
    ``default_deny`` off, and the gate's upstream the loopback fake."""
    return ("firewall:\n  enable: true\n  default_deny: false\n"
            f"  dns_upstreams: ['{upstream}']\n" + extra)


def _fw_project(proj: Path) -> None:
    """The project's egress rules are ``EGRESS_RULES``."""
    lines = [f"project: {LOOP_PROJECT}", "security:", "  egress:"]
    for dst, proto, port in EGRESS_RULES:
        lines += [f"    - dst: '{dst}'", f"      proto: {proto}"]
        lines += [f"      port: {port}"] if port else []
    (proj / ".clawker.yaml").write_text("\n".join(lines) + "\n")


def _fw_env() -> dict:
    """A forked verb's environment: the fake driver seeded with Envoy's
    image, so ``ensure_envoy`` pulls nothing."""
    return dict(os.environ, PYTHONPATH=str(ROOT), CLAWKER_TPU_DRIVER="fake",
                CLAWKER_TPU_FAKE_IMAGES=FW_ENVOY_IMAGE)


def firewall_verbs_case(proj: Path, env: dict) -> None:
    """(a): ``firewall add-rule '*.pypi.org'``, ``rules``, ``resolve
    files.pypi.org`` and ``status``, each forked: the rule persists into
    the next process, resolves to zone ``pypi.org``, and each process's
    monitor-mode handler exits with its verb."""
    name = "firewall (a)"
    docs, ms = {}, {}
    for argv in FW_VERBS:
        proc, ms[" ".join(argv)] = _cli(["firewall", *argv], proj, env,
                                        timeout=FW_VERB_TIMEOUT_S)
        check(proc.returncode == 0, f"{name}: firewall {' '.join(argv)} "
              f"exited {proc.returncode}: {proc.stderr[-2000:]}")
        check("userspace monitor mode only, NO enforcement" in proc.stderr,
              f"{name}: no monitor-mode warning: {proc.stderr[-1500:]}")
        docs[argv[0]] = json.loads(proc.stdout)
    key = "*.pypi.org:https:443"
    rules = {r["key"]: r["source"] for r in docs["rules"]["rules"]}
    res, st = docs["resolve"], docs["status"]
    check(docs["add-rule"]["added"] == [key] and rules.get(key) == "dynamic",
          f"{name}: add-rule {docs['add-rule']}, rules {rules}")
    check(res["allowed"] and res["zone"] == "pypi.org" and res["wildcard"],
          f"{name}: resolve {res}")
    # a fresh process's handler: nothing initialized, nothing enrolled
    check(not st["initialized"] and st["enrolled"] == []
          and not st["stack"]["running"], f"{name}: status {st}")
    print(f"{name}: add-rule added {docs['add-rule']['added']} "
          f"({docs['add-rule']['routes']} routes), rules lists "
          f"{len(rules)} ({key} {rules[key]}), resolve files.pypi.org -> "
          f"zone {res['zone']} allowed, {len(res['routes'])} route(s); "
          f"status initialized {st['initialized']}")
    print(f"{name} host ms: " + ", ".join(f"forked firewall {k} {v!r}"
                                          for k, v in ms.items()))


def _held(hold: threading.Event):
    """A fake behaviour: each iteration holds its container for
    ``LOOP_ITER_S`` and then until ``hold`` is set (at most
    ``FW_HOLD_S``), and exits 0.  A container that exits at once is gone
    before the post-start hook can enroll it, and the start fails."""
    def run(io) -> int:
        deadline = time.monotonic() + FW_HOLD_S
        if io.kill_event.wait(LOOP_ITER_S):
            return 137
        while not hold.wait(0.02):
            if io.kill_event.is_set():
                return 137
            if time.monotonic() > deadline:
                break
        return 0
    return run


def _fw_round(m, handler, cids: list[str], r: int, rng, storm: str,
              verdicts: list) -> None:
    """One round of every enrolled agent's egress over the handler's
    own maps: a connect to the gate, a query through it, 6-10 connects
    to the answers and 1-2 to addresses never resolved; in the last
    round ``storm`` adds ``EGRESS_STORM`` connects to unresolved
    addresses on odd ports."""
    M, P = m.model, m.policy
    maps, gate = handler.maps, handler.stack.gate
    hosts = sorted(EGRESS_HOSTS)
    for i, cid in enumerate(cids):
        cg = handler.enrollments[cid].cgroup_id
        verdicts.append(P.connect4(maps, cg, gate.host, 53, M.PROTO_UDP))
        reply = _gate_query(m, gate.bound_port, hosts[(i + r) % len(hosts)],
                            qid=1 + r * len(cids) + i)
        ips = [ip for ip, _ in m.dnsgate.parse_a_records(reply)]
        check(ips, f"firewall (b): the gate answered {reply!r}")
        for k in range(rng.randint(6, 10)):
            verdicts.append(P.connect4(maps, cg, ips[k % len(ips)], 443))
        for _ in range(rng.randint(1, 2)):
            verdicts.append(P.connect4(maps, cg,
                                       f"192.0.2.{rng.randint(1, 254)}", 443))
    if r == FW_ROUNDS - 1:
        cg = handler.enrollments[storm].cgroup_id
        for k in range(EGRESS_STORM):
            verdicts.append(P.connect4(maps, cg, f"203.0.113.{k}", 4444 + k))


def _fw_drain(nl) -> int:
    n = 0
    while (got := nl.drain_once()):
        n += got
    return n


def _fw_bypass_case(m, handler, cids: list[str], drain) -> dict:
    """(c), the bypass: two agents bypassed for ``FW_BYPASS_S``; the
    first keeps its dead-man timer, the second loses it (as a handler
    that died would); connects to an unresolved address pass while the
    deadline stands; past it the first's timer has cleared its entry,
    ``gc_tick`` clears the second's (``bypass_cleared`` 1), and both are
    denied."""
    name = "firewall (c)"
    M, P = m.model, m.policy
    (timed, lost), maps = cids[:2], handler.maps
    cgs = [handler.enrollments[c].cgroup_id for c in (timed, lost)]

    def verdicts():
        return [P.connect4(maps, cg, "192.0.2.250", 443) for cg in cgs]

    t0 = time.perf_counter()
    until = [handler.bypass({"container_id": c, "duration_s": FW_BYPASS_S})
             ["until_unix"] for c in (timed, lost)]
    bypass_ms = (time.perf_counter() - t0) * 1e3
    handler._cancel_bypass(lost)
    during = verdicts()
    check(all(v.allowed and v.reason.name == "BYPASS" for v in during),
          f"{name}: connects while bypassed: {during}")
    _wait(lambda: time.time() > max(until) + 0.05
          and cgs[0] not in maps.bypass_entries(), max(until) - time.time()
          + 5, 0.01)
    entries = maps.bypass_entries()
    check(cgs[0] not in entries and cgs[1] in entries,
          f"{name}: bypass entries past the deadline {entries}")
    t0 = time.perf_counter()
    gc = handler.gc_tick()
    gc_ms = (time.perf_counter() - t0) * 1e3
    after = verdicts()
    check(gc["bypass_cleared"] == 1 and not maps.bypass_entries()
          and all(v.action.name == "DENY" for v in after),
          f"{name}: gc_tick {gc}, connects after the deadline {after}")
    drain()
    print(f"{name} bypass: two agents until {until} (unix s); during it "
          f"{[v.reason.name for v in during]}; past it the timer cleared "
          f"one entry, gc_tick {gc} the other, then "
          f"{[(v.action.name, v.reason.name) for v in after]}")
    return {"bypass (2 verbs)": bypass_ms, "gc_tick": gc_ms}


def firewall_run_case(proj: Path, device, stages: dict) -> collections.Counter:
    """(b) and (c): ``loop -p 8 -n 3 --sentinel`` in this process over
    the fake driver with the firewall on, each iteration's container held
    until the checks are done.  The run's own creates bring up the data
    plane (``FirewallInit``) and enroll each agent (``FirewallEnable``);
    each agent then resolves through the handler's gate and connects
    over its maps for ``FW_ROUNDS`` drains a second apart, one agent
    adding the deny storm, and a ``NetLogger`` with
    ``handler_resolvers`` drains into the stream the run's sentinel
    reads.  The storm agent's container id, the key its enrollment and
    so its egress carry, is flagged and ranks first; each scored tick is
    one K3 and one K1.  Then the verbs on that handler: ``bypass``,
    ``add-rule`` while the run lives, ``disable`` and ``remove``; ->
    launches."""
    import random

    from clawker_tpu_torch import consts
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.firewall import lifecycle
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG
    from clawker_tpu_torch.monitor.netlogger import (NetLogger,
                                                     handler_resolvers)
    from clawker_tpu_torch.sentinel import FleetSentinel

    name = "firewall (b)"
    m = egress_modules()
    cfg = load_config(proj)
    drv = FakeDriver()
    drv.api.add_image(LOOP_IMAGE)
    drv.api.add_image(FW_ENVOY_IMAGE)
    hold = threading.Event()
    drv.api.set_behavior(LOOP_IMAGE, _held(hold))
    sched = LoopScheduler(cfg, drv, LoopSpec(parallel=LOOP_AGENTS,
                                             iterations=LOOP_ITERATIONS))
    s = FleetSentinel(cfg, drv, run_id=sched.loop_id, device=device,
                      interval_s=LOOP_TICK_S, window_s=EGRESS_WINDOW_S,
                      threshold=EGRESS_THRESHOLD, train_steps=SENTINEL_STEPS)
    log = TickLog(s, stages)
    sched.attach_sentinel(s)
    flags: dict = {}
    sched.events.add_tap(lambda r: flags.setdefault(r.agent, time.perf_counter())
                         if r.event == ANOMALY_FLAG else None)
    agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
    key = str(cfg.data_dir)
    runner = threading.Thread(target=sched.run, kwargs={"poll_s": 0.05},
                              name="firewall-loop")
    ms = {}
    handler = None
    t0 = time.perf_counter()
    s.start()
    sched.start()
    runner.start()
    try:
        check(_wait(lambda: key in lifecycle._local_handlers and len(
            lifecycle._local_handlers[key].enrollments) == LOOP_AGENTS, 60),
              f"{name}: the run's creates enrolled "
              f"{len(getattr(lifecycle._local_handlers.get(key), 'enrollments', ()))}"
              f" of {LOOP_AGENTS} agents: {sched.status()}")
        ms["creates through FirewallInit + FirewallEnable"] = \
            (time.perf_counter() - t0) * 1e3
        handler = lifecycle._local_handlers[key]
        rows = {r["agent"]: r for r in sched.status()}
        cid_of = {c.name.lstrip("/"): c.id for c in drv.api.containers.values()}
        cids = [cid_of[f"clawker.{LOOP_PROJECT}.{a}"] for a in agents]
        storm = cids[LOOP_HOT_SLOT]
        envoy = drv.engine().inspect_container(consts.ENVOY_CONTAINER)
        policies = [handler.maps.lookup_container(
            handler.enrollments[c].cgroup_id) for c in cids]
        check(handler.initialized and sorted(handler.enrollments) == sorted(cids)
              and all(p is not None and p.flags & m.model.FLAG_ENFORCE
                      for p in policies)
              and envoy["State"]["Running"] and handler.stack.gate.bound_port,
              f"{name}: initialized {handler.initialized}, enrolled "
              f"{sorted(handler.enrollments)} of {cids}, policies {policies}, "
              f"envoy {envoy['State']}, rows {rows}")
        print(f"{name}: the run's creates initialized the data plane (envoy "
              f"{envoy['Id'][:12]} sha "
              f"{envoy['Config']['Labels'][consts.LABEL_CONTENT_SHA]}, "
              f"gate 127.0.0.1:{handler.stack.gate.bound_port}, "
              f"{len(handler.maps.routes())} routes) and enrolled "
              f"{len(cids)} agents with FLAG_ENFORCE, each by its container id")
        handler.stack.gate._forward = loopback_forward
        rc, rz = handler_resolvers(handler)
        nl = NetLogger(handler.maps, out_path=cfg.logs_dir / "ebpf-egress.jsonl",
                       resolve_cgroup=rc, resolve_zone=rz)
        rng = random.Random(EGRESS_SEED)
        verdicts: list = []
        drained = []
        t1 = time.perf_counter()
        for r in range(FW_ROUNDS):
            _fw_round(m, handler, cids, r, rng, storm, verdicts)
            _next_second()
            drained.append(_fw_drain(nl))
        ms["traffic with the drains"] = (time.perf_counter() - t1) * 1e3
        emitting = sum(1 for v in verdicts
                       if v.reason.name in EMITTING_REASONS
                       or v.action.name == "REDIRECT_DNS")
        recs = [json.loads(line) for line in
                (cfg.logs_dir / "ebpf-egress.jsonl").read_text().splitlines()]
        check(nl.emitted == emitting == len(recs) == sum(drained)
              and all(drained) and handler.maps.events_dropped == 0
              and {r["container"] for r in recs} <= set(cids),
              f"{name}: {len(verdicts)} decisions, {emitting} emitting, "
              f"emitted {nl.emitted}, drained {drained}, dropped "
              f"{handler.maps.events_dropped}, containers "
              f"{sorted({r['container'] for r in recs})}")
        check(_wait(lambda: storm in flags, EGRESS_FLAG_DEADLINE_S, 0.005)
              and _wait(lambda: s._scored_at[0] >= len(recs), 10, 0.005),
              f"{name}: no flag for {storm} within {EGRESS_FLAG_DEADLINE_S} s: "
              f"{s.flags()}")
        ms["flag on the bus after the last drain"] = \
            (flags[storm] - t1) * 1e3 - ms["traffic with the drains"]
        by_z = sorted(s.rows(), key=lambda row: -row["latest_z"])
        check(by_z[0]["agent"] == storm and by_z[0]["flagged"],
              f"{name}: rows {by_z[:3]}")
        print(f"{name}: {len(verdicts)} decisions over the handler's maps "
              f"({sum(1 for v in verdicts if v.action.name == 'DENY')} "
              f"denies), {nl.emitted} events drained {drained} into the "
              f"run's stream, 0 dropped; gate {json.dumps(vars(handler.stack.gate.stats))}; "
              f"storm {agents[LOOP_HOT_SLOT]} (container id {storm[:12]}) "
              f"flagged and first at z {by_z[0]['latest_z']}, next "
              f"{by_z[1]['agent'][:24]} at {by_z[1]['latest_z']}")
        # (c) the verbs on live state
        ms.update(_fw_bypass_case(m, handler, cids, lambda: _fw_drain(nl)))
        routes0, sha0 = len(handler.maps.routes()), handler.stack.config_sha()
        t2 = time.perf_counter()
        added = handler.add_rules({"rules": [{"dst": FW_ADDED,
                                              "proto": "https"}]})
        ms["add-rule"] = (time.perf_counter() - t2) * 1e3
        envoy2 = drv.engine().inspect_container(consts.ENVOY_CONTAINER)
        sha1 = handler.stack.config_sha()
        check(added["added"] == [f"{FW_ADDED}:https:443"]
              and len(handler.maps.routes()) > routes0
              and envoy2["Id"] != envoy["Id"] and sha1 != sha0
              and sha1 in envoy2["Config"]["Labels"].values(),
              f"firewall (c): add-rule {added}, routes {routes0} -> "
              f"{len(handler.maps.routes())}, envoy {envoy['Id'][:12]} -> "
              f"{envoy2['Id'][:12]}, sha {sha0} -> {sha1}")
        print(f"firewall (c) add-rule {FW_ADDED} while the run lives: routes "
              f"{routes0} -> {len(handler.maps.routes())}, envoy recreated "
              f"{envoy['Id'][:12]} -> {envoy2['Id'][:12]} under sha {sha0} "
              f"-> {sha1}")
    finally:
        hold.set()
        runner.join(60)
    wall = (time.perf_counter() - t0) * 1e3
    try:
        s.stop()
        rows = sched.status()
        _check_loop_rows(name, rows)
        scored = log.check_run(name)
        off = cids[2]
        off_cg = handler.enrollments[off].cgroup_id
        t3 = time.perf_counter()
        res = handler.disable({"container_id": off})
        ms["disable"] = (time.perf_counter() - t3) * 1e3
        check(res == {"disabled": True} and off not in handler.enrollments
              and handler.maps.lookup_container(off_cg) is None,
              f"firewall (c): disable {res}, cgroup {off_cg} "
              f"{handler.maps.lookup_container(off_cg)}")
        t4 = time.perf_counter()
        gone = handler.remove({})
        ms["remove"] = (time.perf_counter() - t4) * 1e3
        check(gone == {"removed": True}
              and not drv.engine().container_exists(consts.ENVOY_CONTAINER)
              and handler.stack.gate is None and not handler.enrollments
              and handler.maps.enrolled() == {},
              f"firewall (c): remove {gone}, envoy left "
              f"{drv.engine().container_exists(consts.ENVOY_CONTAINER)}, gate "
              f"{handler.stack.gate}")
        check(_fw_drain(nl) == 0 and handler.maps.events_dropped == 0,
              f"firewall (c): events left or dropped")
        print(f"firewall (c): disable unenrolled {off[:12]}; remove after "
              f"the run: envoy gone, gate stopped, maps flushed")
        sched.cleanup(remove_containers=True)
    finally:
        if handler is not None:
            handler.close()
            if handler.stack.gate is not None:
                handler.stack.gate.stop()
        lifecycle._local_handlers.pop(key, None)
    print(f"{name} run: {LOOP_AGENTS} loops x {LOOP_ITERATIONS} iterations, "
          f"run wall {wall!r} ms, {len(log.ticks)} ticks, {len(scored)} "
          f"scored (the last over {scored[-1][3].windows} windows), launches "
          f"{json.dumps(dict(log.launches()))}")
    print(f"{name}: {log.stage_line()}")
    print("firewall (b)+(c) host ms: " + ", ".join(f"{k} {v!r}"
                                                 for k, v in ms.items()))
    return log.launches()


def firewall_refusals_case(base: Path, upstream: str) -> None:
    """(d): forked ``firewall status`` in strict mode (``default_deny``,
    the default, over the fake driver, whose containers have no cgroups
    for the kernel lane) exits 1 with ``FirewallUnavailable``'s text;
    with ``control_plane.enable`` the verb starts the control plane
    (forked, on free ports) and answers over its AdminService, and
    ``controlplane down`` stops it."""
    name = "firewall (d)"
    ms = {}
    with _isolated_dirs(base / "strict", "firewall:\n  enable: true\n",
                        proxy=False) as proj:
        proc, ms["strict"] = _cli(["firewall", "status"], proj, _fw_env(),
                                  timeout=FW_VERB_TIMEOUT_S)
    said = ("firewall enabled but no pinned programs under "
            "/sys/fs/bpf/clawker-tpu")
    check(proc.returncode == 1 and said in proc.stderr and not proc.stdout,
          f"{name} strict: exited {proc.returncode}: {proc.stdout!r} "
          f"{proc.stderr[-1500:]!r}")
    with _isolated_dirs(base / "control_plane",
                        _fw_settings(upstream, cp_settings(cp_ports())),
                        proxy=False) as proj:
        proc, ms["control_plane"] = _cli(["firewall", "status"], proj,
                                         _fw_env(), timeout=FW_VERB_TIMEOUT_S)
        down, ms["controlplane down"] = _cli(["controlplane", "down"], proj,
                                             _fw_env())
    check(proc.returncode == 0 and not json.loads(proc.stdout)["initialized"]
          and "NO enforcement" not in proc.stderr
          and down.returncode == 0
          and down.stdout == "control plane stopped\n",
          f"{name} control_plane: status exited {proc.returncode}: "
          f"{proc.stdout!r} {proc.stderr[-1500:]!r}; down {down.stdout!r}")
    print(f"{name}: strict mode without a kernel lane refused by name, exit "
          f"1; with control_plane.enable the verb started the control plane "
          f"and answered over its AdminService, then controlplane down")
    print(f"{name} host ms: " + ", ".join(f"forked {k} {v!r}"
                                          for k, v in ms.items()))


def firewall_phase(device) -> collections.Counter:
    """The firewall's user-space enforcement in monitor mode: the verbs
    forked, ``loop --sentinel`` whose creates bring up and enroll, the
    agents' egress through the handler's gate and maps scored on the
    card, the verbs on that live handler, and the refusals; ->
    launches."""
    out = ROOT / "build" / "chip_smoke" / "firewall"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    with LoopbackUpstream() as up:
        with _isolated_dirs(out / "a", _fw_settings(up.addr),
                            proxy=False) as proj:
            _fw_project(proj)
            firewall_verbs_case(proj, _fw_env())
            with stage_timers({}) as stages:
                launches = firewall_run_case(proj, device, stages)
        firewall_refusals_case(out / "d", up.addr)
    no_process_left("firewall")
    print(f"firewall launches: {json.dumps(launches)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return launches


# --------------------------------------------------- firewall kernel phase

# each of the nine programs assembled over ``FwMapFds(*range(3, 11))``:
# (instructions, sha256 of the bytecode); tests/test_torch_bpf.py holds
# this table against the reference's assembler
BPF_PROGRAM_SHA256 = {
    "fw_connect4": (256, "8ab227bf6d35c19501525c4724bcebca"
                         "51d2914f9a540de5932028663d299886"),
    "fw_sendmsg4": (252, "8480b8e9b29bc23ddde033fbe87690b2"
                         "4aee8c6c73a64c0631009ba713f17217"),
    "fw_recvmsg4": (36, "33f512e55dfc1535b4d6ca53fbdd3bf7"
                        "544bb488fa21daaca8b0be31cb63a5b3"),
    "fw_getpeername4": (42, "18332df3dc4387fcc78ffefd96e32224"
                            "7e0e1c1fa2709f9a4e729ed3302d41cb"),
    "fw_connect6": (299, "8540d6b01b3c6dca4f16b22e611d75a0"
                         "d2c15b796c28ccc69c19bd010b5c8b0b"),
    "fw_sendmsg6": (295, "0ff024a5e3d731f8832e5e8f00266479"
                         "e08f22e36833d98f8b8f7c2f2cc312b9"),
    "fw_recvmsg6": (43, "06bbdd258655108517797744ddb7be49"
                        "7c82ec6dcf489cfb1c6cc1a1fa505789"),
    "fw_getpeername6": (49, "244defbe95902f508ee87989c0b59d60"
                            "7092c86da34a443e53f84c7ba1113ef8"),
    "fw_sock_create": (111, "03573c91d241e7a781d01ad689c350cd"
                            "f62c27b9c36e9e69bf1f28e64992be61"),
}
BPF_AGENTS = 8
BPF_ROUNDS = 3                  # drains, each in its own second
BPF_STORM = 50                  # the storm's denied connects, one child
BPF_STORM_SLOT = 5
BPF_ZONE = "alpha.example"
BPF_ROUTED = ("198.51.100.10", "198.51.100.11")   # the zone's cached answers
BPF_CGROUP0 = 8000              # the decoded lane's cgroup ids
BPF_RING_BYTES = 1 << 14
BPF_CONNECT_TIMEOUT_S = 1.0
BPF_RL_GAP_S = 0.15             # past the programs' 100 ms rate-limit window
CAP_SYS_ADMIN, CAP_BPF = 21, 39


class MemfdRing:
    """A BPF ring buffer's memory as the kernel lays it out, in a memfd:
    the consumer page, the producer page, then the data pages twice (the
    kernel maps them twice, so a record that wraps reads on past the
    end; here each write lands in both copies).  ``push`` leaves a record
    as ``bpf_ringbuf_reserve`` and ``submit`` do: an 8-byte header (the
    length with bit 31 busy and bit 30 discarded, the page offset), then
    the payload, the producer position advanced by the 8-byte-aligned
    total."""

    BUSY, DISCARD = 1 << 31, 1 << 30

    def __init__(self, size: int = BPF_RING_BYTES, start: int = 0):
        import mmap

        self.page = mmap.PAGESIZE
        self.size = size
        self.fd = os.memfd_create("clawker-ringbuf")
        os.ftruncate(self.fd, 2 * self.page + 2 * size)
        self.producer = start
        os.pwrite(self.fd, struct.pack("<Q", start), 0)
        os.pwrite(self.fd, struct.pack("<Q", start), self.page)

    def push(self, payload: bytes, flags: int = 0) -> int:
        """-> the record's position."""
        at = self.producer
        check(at + 8 + len(payload) - self.consumer() <= self.size,
              f"MemfdRing: no room for {len(payload)} bytes")
        off = at & (self.size - 1)
        rec = struct.pack("<II", len(payload) | flags,
                          (2 * self.page + off) // self.page) + payload
        head = min(len(rec), self.size - off)
        for copy in (0, self.size):
            data = 2 * self.page + copy
            os.pwrite(self.fd, rec[:head], data + off)
            if head < len(rec):
                os.pwrite(self.fd, rec[head:], data)
        self.producer += (len(rec) + 7) & ~7
        os.pwrite(self.fd, struct.pack("<Q", self.producer), self.page)
        return at

    def consumer(self) -> int:
        return struct.unpack("<Q", os.pread(self.fd, 8, 0))[0]

    def close(self) -> None:
        os.close(self.fd)


def ring_sample(model) -> tuple:
    """A ring whose records start 88 bytes before the end of its third
    lap, so that the second record's payload runs past the end of the
    data pages: eight ``model.EgressEvent`` records, the fourth
    discarded, then one still busy; -> (ring, the events a reader
    returns, the busy record's position)."""
    ring = MemfdRing(BPF_RING_BYTES, start=3 * BPF_RING_BYTES - 88)
    kept = []
    for i in range(8):
        ev = model.EgressEvent(
            ts_ns=10**12 + i, cgroup_id=BPF_CGROUP0 + i % 3,
            dst_ip=f"203.0.113.{i}", dst_port=4444 + i, zone_hash=i * 0x1111,
            verdict=model.Action(i % 2), proto=model.PROTO_TCP,
            reason=model.Reason.NO_DNS_ENTRY)
        discard = i == 3
        ring.push(ev.pack(), MemfdRing.DISCARD if discard else 0)
        if not discard:
            kept.append(ev)
    busy = ring.push(bytes(model.EgressEvent.SIZE), MemfdRing.BUSY)
    return ring, kept, busy


def bpf_assembly_case() -> None:
    """(a), no privilege: the nine programs assembled against
    ``FwMapFds(*range(3, 11))`` match ``BPF_PROGRAM_SHA256``, and the
    port's ``RingBufReader`` over ``ring_sample``'s memfd returns the
    submitted records, skips the discarded one, stops at the busy one
    and leaves the consumer position there."""
    from clawker_tpu_torch.firewall import bpfkern, fwprogs
    from clawker_tpu_torch.firewall import model as M

    name = "fwkernel (a)"
    fds = fwprogs.FwMapFds(*range(3, 11))
    got = {}
    t0 = time.perf_counter()
    for prog, _, _, build in fwprogs.PROGRAM_SPECS:
        asm = build(fds)
        code = asm.assemble()
        check(len(code) == 8 * asm.insn_count, f"{name}: {prog} is "
              f"{len(code)} bytes for {asm.insn_count} instructions")
        got[prog] = (asm.insn_count, hashlib.sha256(code).hexdigest())
    asm_ms = (time.perf_counter() - t0) * 1e3
    for prog, (n, digest) in got.items():
        print(f"{name}: {prog} {n} insns sha256 {digest}")
    check(got == BPF_PROGRAM_SHA256, f"{name}: the programs differ from "
          f"BPF_PROGRAM_SHA256: "
          f"{sorted(k for k in got if got[k] != BPF_PROGRAM_SHA256.get(k))}")
    ring, kept, busy = ring_sample(M)
    try:
        reader = bpfkern.RingBufReader(ring.fd, ring.size)
        try:
            raw = reader.drain()
        finally:
            reader.close()
        decoded = [M.EgressEvent.unpack(r) for r in raw]
        check(decoded == kept and ring.consumer() == busy,
              f"{name}: the ring decoded {decoded}, consumer at "
              f"{ring.consumer()}; want {len(kept)} records and {busy}")
    finally:
        ring.close()
    print(f"{name}: the nine programs match BPF_PROGRAM_SHA256 (assembled in "
          f"{asm_ms!r} ms); the memfd ring decoded {len(decoded)} of 9 "
          f"records (one discarded, one busy, one wrapping), consumer left "
          f"at the busy record ({busy})")


def bpf_probe_case() -> tuple:
    """(b): the probe's facts on one line; -> (the lane is in, and if
    it is out why: the probe swallows the reason, so its two-instruction
    load is made again here to read the kernel's answer)."""
    from clawker_tpu_torch.firewall import bpfkern, runtime
    from clawker_tpu_torch.firewall.bpfasm import Asm

    status = Path("/proc/self/status").read_text()
    cap = next((line.split()[1] for line in status.splitlines()
                if line.startswith("CapEff:")), "")
    bits = int(cap, 16) if cap else 0
    root = bpfkern.cgroup2_root()
    probe = bpfkern.kernel_available()
    lane = runtime.inprocess_kernel_available()
    why = ""
    if root is None:
        why = "no writable cgroup-v2 mount"
    elif not lane:
        a = Asm("probe")
        a.ret_imm(1)
        try:
            fd, _ = bpfkern.prog_load(
                bpfkern.BPF_PROG_TYPE_CGROUP_SOCK, a.assemble(),
                expected_attach_type=bpfkern.BPF_CGROUP_INET_SOCK_CREATE,
                name="probe", log_level=0)
            os.close(fd)
        except (bpfkern.BpfError, OSError) as e:
            why = f"PROG_LOAD: {str(e).splitlines()[0]}"
    print(f"fwkernel (b): euid {os.geteuid()}, CapEff {cap} (CAP_BPF "
          f"{bool(bits >> CAP_BPF & 1)}, CAP_SYS_ADMIN "
          f"{bool(bits >> CAP_SYS_ADMIN & 1)}), cgroup2_root {root}, "
          f"bpfkern.kernel_available() {probe}, "
          f"runtime.inprocess_kernel_available() {lane}"
          + (f"; {why}" if why else ""))
    check(probe == lane, "fwkernel (b): the runtime's probe disagrees with "
          "bpfkern's")
    return lane, why


def bpf_agent(i: int) -> str:
    return f"clawker.{LOOP_PROJECT}.bpf-{i:02d}"


def bpf_plan(rng, i: int) -> list:
    """One agent's connects in a round: 6-10 to the zone's cached answers
    (routed to the Envoy double) and 1-2 to addresses never resolved;
    -> [(ip, port, routed)]."""
    plan = [(BPF_ROUTED[k % len(BPF_ROUTED)], 443, True)
            for k in range(rng.randint(6, 10))]
    plan += [(f"192.0.2.{rng.randint(1, 254)}", 443, False)
             for _ in range(rng.randint(1, 2))]
    return plan


def bpf_connects(plan: list, timeout: float) -> list:
    """Runs in a probe child inside an agent's cgroup."""
    from clawker_tpu_torch.firewall.bpflive import probe_tcp_connect

    return [probe_tcp_connect(ip, port, timeout) for ip, port, _ in plan]


def bpf_score(base: Path, nl, act, device, stages: dict,
              name: str) -> collections.Counter:
    """The storm through one lane, scored live: a ``FleetSentinel``
    tails the netlogger's file; for ``BPF_ROUNDS`` rounds every agent
    makes ``bpf_plan``'s connects through ``act(i, plan)`` (-> each
    connect's outcome), the last round adding the storm agent's
    ``BPF_STORM`` denied connects, and the netlogger drains once a
    second.  Routed connects land on the Envoy double and read back the
    address they aimed at; the rest are refused with EPERM.  The storm
    agent is flagged on the bus and ranks first; every scored tick is
    one K3 and one K1; -> launches."""
    import random

    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG, EventBus
    from clawker_tpu_torch.sentinel import FleetSentinel, StreamCollector

    col = StreamCollector()
    col.add_local("fwkernel", nl.out_path)
    s = FleetSentinel(_Cfg(base), collector=col, window_s=EGRESS_WINDOW_S,
                      train_steps=SENTINEL_STEPS, interval_s=LOOP_TICK_S,
                      threshold=EGRESS_THRESHOLD, device=device)
    log = TickLog(s, stages)
    flags: dict = {}
    bus = EventBus(lambda agent, ev, detail:
                   flags.setdefault(agent, time.perf_counter())
                   if ev == ANOMALY_FLAG else None)
    s.bind_run(events=bus)
    storm = bpf_agent(BPF_STORM_SLOT)
    rng = random.Random(EGRESS_SEED)
    outcomes: collections.Counter = collections.Counter()
    drained = []

    def run(i: int, plan: list) -> None:
        got = act(i, plan)
        check(isinstance(got, list) and len(got) == len(plan),
              f"{name}: agent {i}'s probe answered {got}")
        for (ip, port, routed), out in zip(plan, got):
            want = ({"result": "connected", "peer": [ip, port]} if routed
                    else {"result": "eperm"})
            check(out == want, f"{name}: agent {i} connect {ip}:{port} -> "
                  f"{out}, want {want}")
            outcomes["routed" if routed else "denied"] += 1

    s.start()
    try:
        t0 = time.perf_counter()
        for r in range(BPF_ROUNDS):
            for i in range(BPF_AGENTS):
                run(i, bpf_plan(rng, i))
            if r == BPF_ROUNDS - 1:
                time.sleep(BPF_RL_GAP_S)
                run(BPF_STORM_SLOT, [(f"203.0.113.{k}", 4444 + k, False)
                                     for k in range(BPF_STORM)])
            _next_second()
            drained.append(_fw_drain(nl))
        t_last = time.perf_counter()
        traffic_ms = (t_last - t0) * 1e3
        check(_wait(lambda: storm in flags, EGRESS_FLAG_DEADLINE_S, 0.005),
              f"{name}: no flag for {storm} within {EGRESS_FLAG_DEADLINE_S} "
              f"s: {s.flags()}")
        _wait(lambda: s._scored_at[0] >= nl.emitted, 10, 0.005)
    finally:
        s.stop()
        bus.close()
    scored = log.check_run(name)
    rows = sorted(s.rows(), key=lambda row: -row["latest_z"])
    check(rows[0]["agent"] == storm and rows[0]["flagged"],
          f"{name}: rows {rows[:3]}")
    expected = sum(outcomes.values())
    dropped = expected - sum(drained)
    check(dropped == 0 and all(drained),
          f"{name}: {expected} connects emitted {sum(drained)} events "
          f"({drained} a drain)")
    print(f"{name}: {BPF_AGENTS} agents x {BPF_ROUNDS} rounds, "
          f"{outcomes['routed']} routed connects landed on the Envoy double "
          f"and read back their address, {outcomes['denied']} refused with "
          f"EPERM ({BPF_STORM} the storm's); events drained {drained} "
          f"({sum(drained)}) against {dropped} dropped; traffic "
          f"{traffic_ms!r} ms; {storm} flagged "
          f"{(flags[storm] - t_last) * 1e3!r} ms after the last drain, first "
          f"at z {rows[0]['latest_z']}, next {rows[1]['agent']} at "
          f"{rows[1]['latest_z']}; {len(log.ticks)} ticks, {len(scored)} "
          f"scored, launches {json.dumps(dict(log.launches()))}")
    print(f"{name}: {log.stage_line()}")
    return log.launches()


def bpf_live_case(base: Path, device, stages: dict) -> collections.Counter:
    """(c), where the probe passes: the nine programs through the
    verifier in a ``KernelAttacher``, ``BPF_AGENTS`` scratch cgroups
    attached through it and enrolled with ``FLAG_ENFORCE`` in its
    ``LiveMaps``, the zone's answers in ``dns_cache`` and its route
    redirecting :443 to a loopback Envoy double; a raw socket refused in
    the first cgroup shows the programs enforce before any connect is
    made (a connect that escaped them would leave the host); each
    agent's connects
    are made by a probe child forked into its cgroup, and a
    ``NetLogger`` whose resolvers name each cgroup drains the kernel's
    ring buffer (``bpf_score``); -> launches."""
    from types import SimpleNamespace

    from clawker_tpu_torch.firewall import bpfkern, hashes
    from clawker_tpu_torch.firewall import model as M
    from clawker_tpu_torch.firewall.bpflive import (LiveSandbox, TcpEcho,
                                                    probe_raw_socket)
    from clawker_tpu_torch.firewall.enroll import KernelAttacher
    from clawker_tpu_torch.monitor.netlogger import NetLogger

    name = "fwkernel (c)"
    t0 = time.perf_counter()
    ka = KernelAttacher()
    load_ms = (time.perf_counter() - t0) * 1e3
    root = bpfkern.cgroup2_root()
    dirs = [root / f"clawker-smoke-{os.getpid()}-{i}"
            for i in range(BPF_AGENTS)]
    made: list = []
    echo = TcpEcho()
    echo.sock.listen(128)
    echo.start()
    try:
        progs = ka.kern.progs
        check(len(progs) == 9 and all(p.fd > 0 and "processed" in
                                      p.verifier_log for p in progs.values()),
              f"{name}: verifier loaded {sorted(progs)}")
        t1 = time.perf_counter()
        for d in dirs:
            d.mkdir()
            made.append(d)
            ka.attach(str(d))
        names = {bpfkern.cgroup_id(d): bpf_agent(i)
                 for i, d in enumerate(dirs)}
        for cg in names:
            ka.maps.enroll(cg, M.ContainerPolicy(
                envoy_ip="127.0.0.1", dns_ip="127.0.0.1",
                flags=M.FLAG_ENFORCE))
        zh = hashes.zone_hash(BPF_ZONE)
        for ip in BPF_ROUTED:
            ka.maps.cache_dns(ip, M.DnsEntry(zh, int(time.time()) + 300))
        ka.maps.sync_routes({M.RouteKey(zh, 443, M.PROTO_TCP): M.RouteVal(
            M.Action.REDIRECT, "127.0.0.1", echo.port)})
        enroll_ms = (time.perf_counter() - t1) * 1e3
        guard = LiveSandbox.run_in_cgroup(SimpleNamespace(cg_dir=dirs[0]),
                                          probe_raw_socket)
        check(guard.get("result") == "eperm", f"{name}: an enrolled cgroup "
              f"still opens a raw socket ({guard}): the programs do not "
              f"enforce, so no connect is made")
        print(f"{name}: the nine programs passed the verifier in "
              f"{load_ms!r} ms ({sum(p.insn_count for p in progs.values())} "
              f"insns); {BPF_AGENTS} scratch cgroups attached and enrolled "
              f"with FLAG_ENFORCE in {enroll_ms!r} ms")
        nl = NetLogger(ka.maps, out_path=base / "ebpf-egress.jsonl",
                       resolve_cgroup=lambda cg: names.get(cg, ""),
                       resolve_zone=lambda z: BPF_ZONE if z == zh else "")

        def act(i: int, plan: list) -> list:
            return LiveSandbox.run_in_cgroup(SimpleNamespace(cg_dir=dirs[i]),
                                             bpf_connects, plan,
                                             BPF_CONNECT_TIMEOUT_S)

        return bpf_score(base, nl, act, device, stages, name)
    finally:
        echo.stop()
        for d in made:
            ka.detach(str(d))
        ka.close()
        for d in made:
            d.rmdir()


def bpf_decoded_case(base: Path, device, stages: dict) -> collections.Counter:
    """(d), where the probe fails: the storm of (c) decided as the
    programs decide it (routed connects redirected, the rest denied
    ``NO_DNS_ENTRY``), each decision's event packed by the port's
    ``EgressEvent`` into a ``MemfdRing``; ``LiveMaps``' drain reads that
    ring through ``RingBufReader``, so the netlogger, the stream and the
    sentinel run as in (c), decoded, not enforced; -> launches."""
    from clawker_tpu_torch.firewall import bpfkern, hashes
    from clawker_tpu_torch.firewall import model as M
    from clawker_tpu_torch.firewall.fwprogs import LiveMaps
    from clawker_tpu_torch.monitor.netlogger import NetLogger

    class RingMaps(LiveMaps):
        """``LiveMaps`` over a memfd ring instead of a kernel's."""

        def __init__(self, ring: MemfdRing):
            self._reader = bpfkern.RingBufReader(ring.fd, ring.size)

    zh = hashes.zone_hash(BPF_ZONE)
    names = {BPF_CGROUP0 + i: bpf_agent(i) for i in range(BPF_AGENTS)}
    ring = MemfdRing()
    maps = RingMaps(ring)

    def act(i: int, plan: list) -> list:
        out = []
        for ip, port, routed in plan:
            ring.push(M.EgressEvent(
                ts_ns=time.monotonic_ns(), cgroup_id=BPF_CGROUP0 + i,
                dst_ip=ip, dst_port=port, zone_hash=zh if routed else 0,
                verdict=M.Action.REDIRECT if routed else M.Action.DENY,
                proto=M.PROTO_TCP,
                reason=M.Reason.ROUTE if routed else M.Reason.NO_DNS_ENTRY,
            ).pack())
            out.append({"result": "connected", "peer": [ip, port]}
                       if routed else {"result": "eperm"})
        return out

    nl = NetLogger(maps, out_path=base / "ebpf-egress.jsonl",
                   resolve_cgroup=lambda cg: names.get(cg, ""),
                   resolve_zone=lambda z: BPF_ZONE if z == zh else "")
    try:
        return bpf_score(base, nl, act, device, stages,
                         "fwkernel (d) decoded, not enforced")
    finally:
        maps.close()
        ring.close()


def fwkernel_phase(device) -> collections.Counter:
    """The firewall's kernel half: (a) the nine programs' bytecode and the
    ring-buffer reader, (b) the probe, then (c) the in-kernel lane
    enforcing a storm scored on the card where the probe passes, or (d)
    the same storm decoded from a memfd ring where it fails; ->
    launches."""
    out = ROOT / "build" / "chip_smoke" / "fwkernel"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    bpf_assembly_case()
    lane, why = bpf_probe_case()
    with stage_timers({}) as stages:
        if lane:
            launches = bpf_live_case(out, device, stages)
        else:
            print(f"fwkernel (d): the in-kernel lane is out on this host "
                  f"({why}): the storm's records are decoded from a memfd "
                  f"ring, not enforced")
            launches = bpf_decoded_case(out, device, stages)
    no_process_left("fwkernel")
    print(f"fwkernel lane {'in-kernel (c)' if lane else 'decoded (d)'}; "
          f"launches: {json.dumps(launches)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return launches


# ------------------------------------------------------ control plane phase

# the reference's drain sequence (controlplane/daemon.py ``drain``,
# ordering INV-B2-007): the firewall queue first, the netlogger before
# teardown, teardown only after drain-to-zero
CP_DRAIN_ORDER = ["firewall_queue", "admin", "agent_service", "watcher",
                  "dialer", "netlogger", "firewall_teardown", "feeder",
                  "registry"]
CP_WATCH_S = 0.5                # the watcher's poll: drain-to-zero after
CP_GRACE_POLLS = 2              # two polls with no agent running
CP_GC_S = 0.1                   # the dns_cache + bypass GC ticker
CP_DIAL_PROJECT = "cpdial"


def cp_ports() -> tuple[int, int, int]:
    """(admin, agent, health) ports free now: the control plane's fixed
    7443, 7444 and 7080 may be held on a shared host."""
    return _free_port(), _free_port(), _free_port()


def cp_settings(ports: tuple[int, int, int], enable: bool = True) -> str:
    return (f"control_plane:\n  enable: {str(enable).lower()}\n"
            f"  admin_port: {ports[0]}\n  agent_port: {ports[1]}\n"
            f"  health_port: {ports[2]}\n")


def controlplane_verbs_case(base: Path) -> None:
    """(a): ``controlplane up`` forks ``python -m
    clawker_tpu_torch.controlplane`` over its own fake driver;
    ``status --format json`` answers healthy with nothing unavailable,
    ``agents --format json`` lists the (empty) registry, ``down`` stops
    it, and ``status`` after ``down`` exits 1."""
    name = "controlplane (a)"
    ms, out = {}, {}
    with _isolated_dirs(base, cp_settings(cp_ports()), proxy=False) as proj:
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   CLAWKER_TPU_DRIVER="fake")
        for argv in (["up"], ["status", "--format", "json"],
                     ["agents", "--format", "json"], ["down"], ["status"]):
            key = " ".join(argv)
            out[key], ms[key] = _cli(["controlplane", *argv], proj, env)
    up, status, agents, down, after = out.values()
    check(up.returncode == 0 and up.stdout == "control plane running\n",
          f"{name}: up exited {up.returncode}: {up.stderr[-1500:]}")
    doc = json.loads(status.stdout or "{}")
    check(status.returncode == 0 and doc.get("running")
          and doc.get("admin") and doc.get("agent_service")
          and doc.get("feeder") and doc.get("unavailable") == [],
          f"{name}: status exited {status.returncode}: {status.stdout!r} "
          f"{status.stderr[-1500:]}")
    check(agents.returncode == 0 and json.loads(agents.stdout) == [],
          f"{name}: agents exited {agents.returncode}: {agents.stdout!r} "
          f"{agents.stderr[-1500:]}")
    check(down.returncode == 0 and down.stdout == "control plane stopped\n",
          f"{name}: down exited {down.returncode}: {down.stdout!r}")
    check(after.returncode == 1
          and after.stdout == "control plane: not running\n",
          f"{name}: status after down exited {after.returncode}: "
          f"{after.stdout!r}")
    print(f"{name}: up, status healthy ({', '.join(k for k in ('admin', 'agent_service', 'feeder', 'watcher') if doc.get(k))}; "
          f"unavailable []), agents [], down, status after down exit 1")
    print(f"{name} host ms: " + ", ".join(f"forked controlplane {k} {v!r}"
                                          for k, v in ms.items()))


def _no_agentd(container_id: str):
    """The daemon dialer's endpoint for a fake driver's container: none.
    Its containers run no agentd, and their bridge addresses lead
    nowhere on this host, so no dial leaves loopback; (c) dials a real
    agentd."""
    from clawker_tpu_torch.errors import ClawkerError

    raise ClawkerError(f"container {container_id[:12]}: a fake driver's "
                       f"container runs no agentd")


def _cp_daemon(cfg, drv, ports, handler, nl):
    """The port's daemon in process on the settings' ports and PKI dir,
    holding ``handler`` and ``nl``, its dialer resolving no endpoint for
    the fake driver's containers: -> (daemon, admin calls by method, gc
    ticks, drain order)."""
    from clawker_tpu_torch.controlplane.daemon import (ControlPlaneDaemon,
                                                       CPConfig)

    ticks, order = [], []
    gc_tick = handler.gc_tick
    handler.gc_tick = lambda: ticks.append(time.perf_counter()) or gc_tick()
    daemon = ControlPlaneDaemon(
        CPConfig(pki_dir=cfg.pki_dir, registry_path=cfg.data_dir / "agents.db",
                 host="127.0.0.1", admin_port=ports[0], agent_port=ports[1],
                 health_port=ports[2], cp_host="127.0.0.1",
                 watch_interval_s=CP_WATCH_S, drain_to_zero=True,
                 drain_grace_polls=CP_GRACE_POLLS, dns_gc_interval_s=CP_GC_S),
        drv.engine(), firewall=handler, netlogger=nl)
    daemon.start()
    # no agent container has started yet: every dial the run's starts
    # trigger resolves through this
    daemon.subs.dialer.resolve = _no_agentd
    calls = collections.Counter()
    handlers = daemon.subs.admin._handlers
    for method, fn in list(handlers.items()):
        def counted(req, _m=method, _f=fn):
            calls[_m] += 1
            return _f(req)
        handlers[method] = counted
    s = daemon.subs
    for key, obj, attr in (("firewall_queue", handler, "close"),
                           ("admin", s.admin, "stop"),
                           ("agent_service", s.agent_service, "stop"),
                           ("watcher", s.watcher, "stop"),
                           ("dialer", s.dialer, "stop"),
                           ("netlogger", nl, "stop"),
                           ("firewall_teardown", handler, "teardown"),
                           ("feeder", s.feeder, "stop"),
                           ("registry", s.registry, "close")):
        def recorded(*a, _k=key, _f=getattr(obj, attr), **kw):
            order.append(_k)
            return _f(*a, **kw)
        setattr(obj, attr, recorded)
    return daemon, calls, ticks, order


def controlplane_dial_case(cfg, daemon) -> dict:
    """(c): the port's ``Agentd`` on loopback over bootstrap material
    minted from the control plane's CA, its row bound in the daemon's
    registry file; a ``Dialer`` on the control plane's identity drives it
    to ``ready`` (Hello, RegisterRequired back to the daemon's
    AgentService, InitPlan, AgentInitialized, BootPlan, AgentReady), and
    again on the idempotent path (initialized, command running)."""
    from clawker_tpu_torch.agentd.daemon import Agentd, AgentdConfig
    from clawker_tpu_torch.controlplane import identity
    from clawker_tpu_torch.controlplane.daemon import ensure_cp_material
    from clawker_tpu_torch.controlplane.dialer import Dialer, DialerConfig
    from clawker_tpu_torch.controlplane.executor import AgentProfile
    from clawker_tpu_torch.controlplane.registry import Registry
    from clawker_tpu_torch.firewall import pki

    name = "controlplane (c)"
    base = cfg.data_dir / "agentd"
    (base / "bootstrap").mkdir(parents=True)
    ca = pki.ensure_ca(cfg.pki_dir)
    material = identity.mint_bootstrap_material(ca, CP_DIAL_PROJECT, "dev",
                                                container_id="c-dial")
    for fname, data in material.files().items():
        (base / "bootstrap" / fname).write_bytes(data)
    full = f"{CP_DIAL_PROJECT}.dev"
    reg = Registry(cfg.data_dir / "agents.db")
    reg.bind(full, CP_DIAL_PROJECT, "dev", container_id="c-dial",
             cert_sha256=identity.cert_fingerprint(material.agent_cert))
    reg.close()
    d = Agentd(AgentdConfig(bootstrap_dir=base / "bootstrap", port=0,
                            host="127.0.0.1", ready_file=base / "ready",
                            init_marker=base / "initialized"))
    threading.Thread(target=d.serve_forever, daemon=True).start()
    check(_wait(lambda: d.bound_port != 0, 10), f"{name}: agentd never bound")
    cert, key, ca_file = ensure_cp_material(cfg.pki_dir)
    dialer = Dialer(
        DialerConfig(cert_file=cert, key_file=key, ca_file=ca_file,
                     cp_host="127.0.0.1",
                     cp_agent_port=daemon.subs.agent_service.bound_port,
                     dial_deadline_s=10),
        daemon.subs.registry, resolve=lambda cid: ("127.0.0.1", d.bound_port),
        build_profile=lambda cid: AgentProfile(
            project=CP_DIAL_PROJECT, agent="dev", cmd=["/bin/sleep", "60"],
            workdir="/"))
    ms = {}
    try:
        t0 = time.perf_counter()
        first = dialer.drive("c-dial")
        ms["drive (register, init, boot)"] = (time.perf_counter() - t0) * 1e3
        rec = daemon.subs.registry.get(full)
        t1 = time.perf_counter()
        again = dialer.drive("c-dial")
        ms["drive again (idempotent)"] = (time.perf_counter() - t1) * 1e3
        child = d._direct_child
    finally:
        d.stop()
        if d._direct_child is not None:
            d._direct_child.kill()
            d._direct_child.wait()
    check(first == again == "ready" and rec.registered_at > 0
          and rec.initialized and rec.state == "ready"
          and child is not None and (base / "initialized").exists(),
          f"{name}: drive {first!r} then {again!r}, registry row "
          f"{vars(rec) if rec else None}")
    print(f"{name}: Dialer.drive -> {first!r} (registered_at "
          f"{rec.registered_at!r} through the daemon's AgentService, "
          f"initialized, AgentReady spawned pid {child.pid}), again -> "
          f"{again!r} on the idempotent path")
    return ms


def controlplane_run_case(proj: Path, ports, device, stages: dict,
                          meanwhile) -> collections.Counter:
    """(b), (c) and (d): an in-process ``ControlPlaneDaemon`` on the
    settings' ports and PKI dir holds the monitor-mode handler (its gate
    on a port free for TCP as well as UDP) and a ``NetLogger`` into the
    run's ``ebpf-egress.jsonl``; ``loop -p 8 -n 3 --sentinel`` in this
    process with ``control_plane.enable``, so each create's
    ``FirewallInit`` and ``FirewallEnable`` reach the handler over the
    AdminService (counted by method).  The firewall phase's rounds run
    from the run's enrolled agents over the daemon's maps, each round
    drained into the stream a second apart; the storm is flagged on the
    card (one K3 and one K1 a scored tick); ``ListAgents`` lists the
    run's 8 agents (bound by the factory's identity bootstrap); the GC
    ticker runs.  (c) dials an agentd.  (d): once the run's containers
    are gone the watcher drains to zero, and the drain runs in the
    reference's order with teardown last but for the feeder and the
    registry.  ``meanwhile()`` runs while the drain waits out its two
    five-second joins (kept from the reference: the dialer's consumer of
    a topic the drain never closes, and an ``accept`` that closing the
    AgentService's listener does not wake); -> launches."""
    import random

    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.controlplane import manager
    from clawker_tpu_torch.controlplane.identity import make_bootstrapper
    from clawker_tpu_torch.controlplane.registry import Registry
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.firewall import lifecycle
    from clawker_tpu_torch.firewall.runtime import build_handler
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG
    from clawker_tpu_torch.monitor.netlogger import (NetLogger,
                                                     handler_resolvers)
    from clawker_tpu_torch.sentinel import FleetSentinel

    name = "controlplane (b)"
    m = egress_modules()
    cfg = load_config(proj)
    drv = FakeDriver()
    drv.api.add_image(LOOP_IMAGE)
    drv.api.add_image(FW_ENVOY_IMAGE)
    hold = threading.Event()
    drv.api.set_behavior(LOOP_IMAGE, _held(hold))
    ms = {}
    t0 = time.perf_counter()
    handler = build_handler(cfg, drv.engine(), monitor_fallback=True,
                            inprocess_ok=drv.real_cgroups,
                            dns_host="127.0.0.1", dns_port=_free_port())
    rc, rz = handler_resolvers(handler)
    # drained a round at a time below, so each round's records share a
    # second; the daemon starts it and its drain stops it (final sweep)
    nl = NetLogger(handler.maps, out_path=cfg.logs_dir / "ebpf-egress.jsonl",
                   resolve_cgroup=rc, resolve_zone=rz, poll_s=3600.0)
    daemon, calls, gc_ticks, order = _cp_daemon(cfg, drv, ports, handler, nl)
    ms["daemon start"] = (time.perf_counter() - t0) * 1e3
    check(daemon.healthy() and manager.health(cfg) is not None,
          f"{name}: daemon health {daemon.health()}")
    sched = LoopScheduler(cfg, drv, LoopSpec(parallel=LOOP_AGENTS,
                                             iterations=LOOP_ITERATIONS))
    s = FleetSentinel(cfg, drv, run_id=sched.loop_id, device=device,
                      interval_s=LOOP_TICK_S, window_s=EGRESS_WINDOW_S,
                      threshold=EGRESS_THRESHOLD, train_steps=SENTINEL_STEPS)
    log = TickLog(s, stages)
    sched.attach_sentinel(s)
    flags: dict = {}
    sched.events.add_tap(lambda r: flags.setdefault(r.agent, time.perf_counter())
                         if r.event == ANOMALY_FLAG else None)
    agents = [sched._agent_name(i) for i in range(LOOP_AGENTS)]
    runner = threading.Thread(target=sched.run, kwargs={"poll_s": 0.05},
                              name="controlplane-loop")
    drained_at = None
    try:
        t1 = time.perf_counter()
        s.start()
        sched.start()
        runner.start()
        check(_wait(lambda: len(handler.enrollments) == LOOP_AGENTS, 60),
              f"{name}: the run's creates enrolled {len(handler.enrollments)}"
              f" of {LOOP_AGENTS} agents over the daemon: calls "
              f"{dict(calls)}, {sched.status()}")
        ms["creates through the AdminService"] = \
            (time.perf_counter() - t1) * 1e3
        local = str(cfg.data_dir) in lifecycle._local_handlers
        first = dict(calls)
        check(first.get("FirewallInit", 0) >= LOOP_AGENTS
              and first.get("FirewallEnable", 0) >= LOOP_AGENTS
              and handler.initialized and not local,
              f"{name}: AdminService calls {first}, handler initialized "
              f"{handler.initialized}, in-process handler {local}")
        cid_of = {c.name.lstrip("/"): c.id for c in drv.api.containers.values()}
        cids = [cid_of[f"clawker.{LOOP_PROJECT}.{a}"] for a in agents]
        storm = cids[LOOP_HOT_SLOT]
        # the factory's create path binds each agent's identity row in
        # agents.db (a loop's own creates bind none, as the reference's)
        reg = Registry(cfg.data_dir / "agents.db")
        bind = make_bootstrapper(cfg, drv.engine(), reg)
        for a, cid in zip(agents, cids):
            bind(cid, LOOP_PROJECT, a)
        reg.close()
        client = manager.admin_client(cfg)
        t2 = time.perf_counter()
        listed = client.call("ListAgents", {"project": LOOP_PROJECT})["agents"]
        ms["ListAgents"] = (time.perf_counter() - t2) * 1e3
        check(sorted(a["agent"] for a in listed) == sorted(agents)
              and sorted(a["container_id"] for a in listed) == sorted(cids),
              f"{name}: ListAgents {listed}")
        handler.stack.gate._forward = loopback_forward
        rng = random.Random(EGRESS_SEED)
        verdicts: list = []
        drained = []
        t3 = time.perf_counter()
        for r in range(FW_ROUNDS):
            _fw_round(m, handler, cids, r, rng, storm, verdicts)
            _next_second()
            drained.append(_fw_drain(nl))
        ms["traffic with the drains"] = (time.perf_counter() - t3) * 1e3
        recs = [json.loads(line) for line in
                (cfg.logs_dir / "ebpf-egress.jsonl").read_text().splitlines()]
        check(nl.emitted == len(recs) == sum(drained) and all(drained)
              and handler.maps.events_dropped == 0
              and {r["container"] for r in recs} <= set(cids),
              f"{name}: {len(verdicts)} decisions, emitted {nl.emitted}, "
              f"drained {drained}, dropped {handler.maps.events_dropped}")
        check(_wait(lambda: storm in flags, EGRESS_FLAG_DEADLINE_S, 0.005)
              and _wait(lambda: s._scored_at[0] >= len(recs), 10, 0.005),
              f"{name}: no flag for {storm} within {EGRESS_FLAG_DEADLINE_S} s: "
              f"{s.flags()}")
        ms["flag on the bus after the last drain"] = \
            (flags[storm] - t3) * 1e3 - ms["traffic with the drains"]
        by_z = sorted(s.rows(), key=lambda row: -row["latest_z"])
        check(by_z[0]["agent"] == storm and by_z[0]["flagged"],
              f"{name}: rows {by_z[:3]}")
        check(_wait(lambda: len(gc_ticks) >= 1, 5),
              f"{name}: the GC ticker never ran")
        print(f"{name}: the run's creates reached the daemon's handler over "
              f"the AdminService: {json.dumps(first)}; {len(verdicts)} "
              f"decisions over its maps, {nl.emitted} events drained "
              f"{drained} into the run's stream, 0 dropped; storm "
              f"{agents[LOOP_HOT_SLOT]} (container id {storm[:12]}) flagged "
              f"and first at z {by_z[0]['latest_z']}; ListAgents lists "
              f"{len(listed)} agents of {LOOP_PROJECT}; GC ticks "
              f"{len(gc_ticks)}")
        ms.update(controlplane_dial_case(cfg, daemon))
    finally:
        hold.set()
        runner.join(60)
        s.stop()
    try:
        scored = log.check_run(name)
        _check_loop_rows(name, sched.status())
        final = dict(calls)
        # a fresh container's start runs both hooks, a restart the
        # post-start one only
        check(final.get("FirewallInit") == LOOP_AGENTS
              and final.get("FirewallEnable") == LOOP_AGENTS * LOOP_ITERATIONS,
              f"{name}: AdminService calls over the whole run {final}")
        t4 = time.perf_counter()
        sched.cleanup(remove_containers=True)
        # (d) no agent runs: the watcher drains to zero, then the drain
        check(_wait(lambda: daemon._stop.is_set(), 30),
              f"controlplane (d): no drain-to-zero: watcher polls "
              f"{daemon.subs.watcher.polls}, last count "
              f"{daemon.subs.watcher.last_count}")
        ms["drain-to-zero after cleanup"] = (time.perf_counter() - t4) * 1e3
        check(daemon._drained_to_zero and not order,
              f"controlplane (d): drained to zero {daemon._drained_to_zero}, "
              f"stopped already {order}")
        t5 = time.perf_counter()
        draining = threading.Thread(target=daemon.drain, name="cp-drain")
        draining.start()
        meanwhile()
        draining.join(60)
        check(not draining.is_alive(), "controlplane (d): drain hung")
        drained_at = (time.perf_counter() - t5) * 1e3
    finally:
        if drained_at is None:
            daemon.request_stop()
            daemon.drain()
        if handler.stack.gate is not None:
            handler.stack.gate.stop()
    ms["drain (beside (a))"] = drained_at
    check(order == CP_DRAIN_ORDER and handler.maps.enrolled() == {}
          and not handler.enrollments and handler.stack.gate is None
          and not drv.engine().container_exists("clawker-envoy")
          and daemon.subs.unavailable == [],
          f"controlplane (d): drain order {order}, enrolled "
          f"{handler.maps.enrolled()}, gate {handler.stack.gate}, "
          f"unavailable {daemon.subs.unavailable}")
    print(f"controlplane (d): drain-to-zero fired once the run's containers "
          f"were gone; drain order {order} (the reference's), teardown "
          f"flushed the maps and removed Envoy")
    print(f"{name} run: {LOOP_AGENTS} loops x {LOOP_ITERATIONS} iterations, "
          f"{len(log.ticks)} ticks, {len(scored)} scored, AdminService calls "
          f"{json.dumps(final)}, launches {json.dumps(dict(log.launches()))}")
    print(f"{name}: {log.stage_line()}")
    print("controlplane (b)-(d) host ms: " + ", ".join(
        f"{k} {v!r}" for k, v in ms.items()))
    return log.launches()


def controlplane_phase(device) -> collections.Counter:
    """The control plane: an in-process daemon that carries ``loop
    --sentinel``'s firewall calls, whose netlogger's stream the card
    scores, dials an agentd, and drains to zero in the reference's order,
    with the forked verbs run while it drains; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "controlplane"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    ports = cp_ports()
    with LoopbackUpstream() as up:
        with _isolated_dirs(out / "b", _fw_settings(up.addr,
                                                    cp_settings(ports)),
                            proxy=False) as proj:
            _fw_project(proj)
            with stage_timers({}) as stages:
                launches = controlplane_run_case(
                    proj, ports, device, stages,
                    lambda: controlplane_verbs_case(out / "a"))
    no_process_left("controlplane")
    print(f"controlplane launches: {json.dumps(launches)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return launches


# -------------------------------------------------------------- nsd phase

NSD_IMAGE = "busybox:latest"    # tests/test_nsd.py's: the host's root
NSD_ITER_S = 0.2                # an nsd container's iteration (its sleep)
NSD_AGENT_CMD = ["sh", "-c", f"sleep {NSD_ITER_S}; echo iteration done"]
NSD_SETTINGS = (f"sentinel:\n  interval_s: {LOOP_TICK_S}\n"
                f"  train_steps: {SENTINEL_STEPS}\n" + ENGINES_SETTINGS)
NSD_RACES = 6                   # test_nsd.py's concurrent lifecycles
NSD_START_S = 10.0              # NsdDriver._spawn's own deadline


def nsd_probe_case(base: Path) -> tuple[bool, str]:
    """(a): the host's facts for nsd on one line (euid, ``CapEff``,
    ``cgroup2_root()``, ``nsd_capable()``, whether a task's
    ``children`` file reads), then the reference's exact spawn argv
    (``clawker_tpu/nsd/runtime.py:274-276``) once with ``true``, and an
    overlay mount of ``/`` under ``base`` made and unmounted inside a
    mount namespace of its own (the host's mount table is never
    touched); -> (real namespaces can run here, and if not why)."""
    from clawker_tpu_torch.engine.drivers.nsdriver import nsd_capable
    from clawker_tpu_torch.firewall import bpfkern

    status = Path("/proc/self/status").read_text()
    cap = next((line.split()[1] for line in status.splitlines()
                if line.startswith("CapEff:")), "")
    bits = int(cap, 16) if cap else 0
    capable = nsd_capable()
    tid = threading.get_native_id()
    try:
        Path(f"/proc/self/task/{tid}/children").read_text()
        children = True
    except OSError:
        children = False
    print(f"nsd (a): euid {os.geteuid()}, CapEff {cap} (CAP_SYS_ADMIN "
          f"{bool(bits >> CAP_SYS_ADMIN & 1)}), cgroup2_root "
          f"{bpfkern.cgroup2_root()}, nsd_capable() {capable}, "
          f"/proc/self/task/<tid>/children readable {children}")
    if not capable:
        return False, "nsd_capable() is False"
    trials = {}
    spawn = ["unshare", "--fork", "--pid", "--mount", "--uts", "--ipc",
             "--cgroup", "--kill-child", "true"]
    dirs = {sub: base / "overlay" / sub for sub in ("upper", "work", "merged")}
    for d in dirs.values():
        d.mkdir(parents=True)
    mount = (f"mount -t overlay overlay -o lowerdir=/,upperdir="
             f"{dirs['upper']},workdir={dirs['work']} {dirs['merged']} && "
             f"test -d {dirs['merged']}/proc && umount {dirs['merged']}")
    for name, argv in (("spawn", spawn),
                       ("overlay", ["unshare", "--mount", "--propagation",
                                    "private", "sh", "-c", mount])):
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=30)
        trials[name] = proc.returncode
        print(f"nsd (a): {name} `{' '.join(argv)}`: exit {proc.returncode} "
              f"in {(time.perf_counter() - t0) * 1e3!r} ms, stderr "
              f"{proc.stderr.strip()[-500:]!r}")
    why = [f"{k} exited {v}" for k, v in trials.items() if v]
    if not children:
        why.append("no children file (exec would be refused)")
    return not why, "; ".join(why)


def _nsd_sock(base: Path) -> Path:
    """``base/run/nsd.sock``, or one in a short temporary directory when
    that path passes what a unix socket path may hold."""
    import tempfile

    sock = base / "run" / "nsd.sock"
    if len(str(sock).encode()) >= SUN_PATH_MAX:
        sock = Path(tempfile.mkdtemp(prefix="clawker-nsd-")) / "nsd.sock"
    return sock


def _listener_argv(sock: Path) -> str:
    """The command line of the process that answers on ``sock``
    (``SO_PEERCRED`` of a connection to it)."""
    import socket

    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(str(sock))
        pid = struct.unpack("3i", s.getsockopt(
            socket.SOL_SOCKET, socket.SO_PEERCRED, struct.calcsize("3i")))[0]
    return (Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ")
            .decode(errors="replace").strip())


def _nsd_frames(raw: bytes) -> dict[int, bytes]:
    """A stdcopy stream's bytes by stream (``engine.api._demux_stdcopy``
    joins the streams, and the lifecycle check holds stdout and stderr
    apart)."""
    out: dict[int, bytes] = {}
    while raw:
        n = int.from_bytes(raw[4:8], "big")
        out[raw[0]] = out.get(raw[0], b"") + raw[8:8 + n]
        raw = raw[8 + n:]
    return out


def _nsd_tar(name: str, data: bytes) -> bytes:
    import io
    import tarfile

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        ti = tarfile.TarInfo(name)
        ti.size = len(data)
        tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


def nsd_api_case(name: str, api, *, real: bool) -> dict:
    """tests/test_nsd.py's API checks against the daemon: ping, info and
    version; a lifecycle's exit code and framed logs; attach and archive
    before start; exec and its exit code, then stop; a volume and label
    filters; 409 and 404; six lifecycles at once.  On real namespaces
    (``real``) also the PID and UTS isolation, the exec's hostname and
    stop's 137; over the double the command sees the host's hostname and
    stop's SIGTERM ends it (143).  -> host ms of the steps."""
    from clawker_tpu_torch.errors import ConflictError, NotFoundError

    ms: dict = {}

    def create(cname, cmd, **cfg):
        return api.container_create(cname, dict(
            {"Image": NSD_IMAGE, "Cmd": cmd, "Labels": {}}, **cfg))["Id"]

    check(api.ping() and api.info()["Name"] == "nsd"
          and api.version()["ApiVersion"] == "1.43",
          f"{name}: ping/info/version {api.info()} {api.version()}")
    t0 = time.perf_counter()
    cid = create("lc1", ["sh", "-c", "echo out-line; echo err-line >&2; "
                                     "exit 3"])
    t1 = time.perf_counter()
    api.container_start(cid)
    t2 = time.perf_counter()
    code = api.container_wait(cid)["StatusCode"]
    ms["create"], ms["start"], ms["to exit"] = (
        (t1 - t0) * 1e3, (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3)
    state = api.container_inspect(cid)["State"]
    logs = _nsd_frames(b"".join(api.container_logs(cid)))
    check(code == 3 and state["Status"] == "exited" and state["ExitCode"] == 3
          and logs == {1: b"out-line\n", 2: b"err-line\n"},
          f"{name}: lifecycle exit {code}, state {state}, logs {logs}")
    api.container_remove(cid, force=True)
    if real:
        cid = create("iso1", ["sh", "-c", 'echo "pid=$$ host=$(hostname)"'],
                     Hostname="isolated-ns")
        api.container_start(cid)
        api.container_wait(cid)
        out = _nsd_frames(b"".join(api.container_logs(cid))).get(1, b"")
        check(out == b"pid=1 host=isolated-ns\n",
              f"{name}: PID and UTS isolation: {out!r}")
        api.container_remove(cid, force=True)
    # attach and archive before start (the file read relative to the
    # working dir, which the double's rootfs holds too)
    cid = create("att1", ["sh", "-c", "read l; echo got:$l; cat f.txt"],
                 OpenStdin=True, WorkingDir="/seeded")
    api.put_archive(cid, "/seeded", _nsd_tar("f.txt", b"seeded-content\n"))
    stream = api.container_attach(cid, tty=False)
    api.container_start(cid)
    stream.write(b"over-stdin\n")
    got = b"".join(p for _, p in stream.frames())
    stream.close()
    api.container_wait(cid)
    check(got == b"got:over-stdin\nseeded-content\n",
          f"{name}: attach before start: {got!r}")
    api.container_remove(cid, force=True)
    # exec, then stop
    cid = create("ex1", ["sleep", "15"], Hostname="exhost")
    api.container_start(cid)
    check(_wait(lambda: api.container_inspect(cid)["State"]["Pid"], 5),
          f"{name}: no init pid")
    t0 = time.perf_counter()
    e = api.exec_create(cid, {"Cmd": ["sh", "-c", "hostname"]})
    host = b"".join(p for _, p in api.exec_start(e["Id"], tty=False).frames())
    ms["exec"] = (time.perf_counter() - t0) * 1e3
    e2 = api.exec_create(cid, {"Cmd": ["sh", "-c", "exit 9"]})
    list(api.exec_start(e2["Id"], tty=False).frames())
    check(_wait(lambda: not api.exec_inspect(e2["Id"])["Running"], 5)
          and api.exec_inspect(e2["Id"])["ExitCode"] == 9,
          f"{name}: exec exit {api.exec_inspect(e2['Id'])}")
    import socket

    want_host = (b"exhost" if real else socket.gethostname().encode()) + b"\n"
    check(host == want_host, f"{name}: exec hostname {host!r}, want "
          f"{want_host!r}")
    t0 = time.perf_counter()
    api.container_stop(cid, timeout=1)
    ms["stop"] = (time.perf_counter() - t0) * 1e3
    stopped = api.container_inspect(cid)["State"]["ExitCode"]
    check(stopped == (137 if real else 143),
          f"{name}: stop gave exit {stopped}")
    api.container_remove(cid, force=True)
    # a volume, label filters
    api.volume_create("nsdvol1", labels={"clawker.managed": "1"})
    vols = api.volume_list(filters={"label": ["clawker.managed=1"]})
    cid = create("vol1", ["sh", "-c", "echo kept > data/keep.txt"],
                 HostConfig={"Binds": ["nsdvol1:/data"]},
                 Labels={"clawker.project": "nsdtest"})
    api.container_start(cid)
    api.container_wait(cid)
    kept = _ctx_members(api.get_archive(cid, "/data/keep.txt"))
    rows = api.container_list(all=True,
                              filters={"label": ["clawker.project=nsdtest"]})
    check([v["Name"] for v in vols["Volumes"]] == ["nsdvol1"]
          and kept == {"keep.txt": b"kept\n"}
          and [r["Id"] for r in rows] == [cid],
          f"{name}: volumes {vols}, kept {kept}, rows {rows}")
    api.container_remove(cid, force=True)
    api.volume_remove("nsdvol1")
    # 409 and 404
    cid = create("dup1", ["true"])
    try:
        create("dup1", ["true"])
        dup = None
    except ConflictError as err:
        dup = str(err)
    try:
        api.container_inspect("definitely-missing")
        missing = None
    except NotFoundError as err:
        missing = str(err)
    check(dup is not None and "already in use" in dup and missing,
          f"{name}: 409 {dup!r}, 404 {missing!r}")
    api.container_remove(cid, force=True)
    # lifecycles at once, each its own exit code and output
    errors: list[str] = []

    def one(i: int) -> None:
        try:
            c = create(f"race{i}", ["sh", "-c", f"echo out-{i}; exit {10 + i}"])
            api.container_start(c)
            rc = api.container_wait(c)["StatusCode"]
            out = _nsd_frames(b"".join(api.container_logs(c)))
            api.container_remove(c, force=True)
            if (rc, out) != (10 + i, {1: f"out-{i}\n".encode()}):
                errors.append(f"race{i}: exit {rc}, logs {out}")
        except Exception as err:  # noqa: BLE001 - collected, then checked
            errors.append(f"race{i}: {err.__class__.__name__}: {err}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(NSD_RACES)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    ms[f"{NSD_RACES} lifecycles at once"] = (time.perf_counter() - t0) * 1e3
    check(not errors and not any(t.is_alive() for t in threads)
          and api.container_list(all=True) == [],
          f"{name}: concurrent lifecycles {errors}")
    print(f"{name}: ping/info/version, a lifecycle (exit 3, framed logs), "
          + ("PID 1 and its own hostname, " if real else "")
          + "attach and archive before start, exec (exit 9), stop (exit "
          f"{stopped}), a volume with label filters, 409/404 and "
          f"{NSD_RACES} lifecycles at once held")
    return ms


def _nsd_writer(api, cfg, out: dict, stop) -> None:
    """The loop's egress, written once its containers exist (their
    names, as the nsd daemon lists them): every agent's benign minutes
    and the hot slot's burst."""
    pattern = re.compile(rf"^/clawker\.{LOOP_PROJECT}\.(loop-[0-9a-z]+)-\d+$")
    while not stop.is_set():
        names = [n for c in api.container_list(all=True) for n in c["Names"]]
        hits = [m.group(1) for m in map(pattern.match, names) if m]
        if hits:
            agents = [f"{hits[0]}-{i}" for i in range(LOOP_AGENTS)]
            out["agents"] = agents
            out["hot"] = agents[LOOP_HOT_SLOT]
            cfg.logs_dir.mkdir(parents=True, exist_ok=True)
            _append(cfg.logs_dir / f"ebpf-egress-{ENGINES_LOCAL}.jsonl",
                    _local_egress(agents, out["hot"]))
            return
        time.sleep(0.01)


def nsd_loop_case(name: str, proj: Path, api, device: str,
                  stages: dict) -> tuple[collections.Counter, dict]:
    """``loop -p 8 -n 3 --sentinel --json`` through the CLI, in this
    process, with settings ``runtime.driver: nsd`` at the lane's socket:
    every agent done, the storm agent hottest at ``ANOMALY_Z`` or more
    and flagged, each scored tick one K3 and one K1 on the card (every
    sentinel the CLI builds is wrapped in a ``TickLog``); -> (launches,
    host ms)."""
    import io

    from clawker_tpu_torch.analytics.runtime import ANOMALY_Z
    from clawker_tpu_torch.cli import DEVICE_ENV
    from clawker_tpu_torch.cli import main as cli_main
    from clawker_tpu_torch.config import load_config

    cfg = load_config(proj)
    seen: dict = {}
    stop = threading.Event()
    # a run slower than its margin crosses a minute, and each row's z is
    # then its new window's, of bus events alone
    _clear_of_minute_end(FORKED_RUN_MARGIN_S)
    start_s = time.time() % 60
    writer = threading.Thread(target=_nsd_writer, args=(api, cfg, seen, stop),
                              name="nsd-egress-writer")
    saved_cwd = os.getcwd()
    saved = {k: os.environ.get(k) for k in (DEVICE_ENV, "CLAWKER_TPU_DRIVER",
                                            "CLAWKER_TPU_FAKE_IMAGES")}
    for k in saved:
        os.environ.pop(k, None)
    if device != "cuda":            # a dry run on the CPU: the card's
        os.environ[DEVICE_ENV] = device     # default is left alone
    handlers = {sig: signal.getsignal(sig)
                for sig in (signal.SIGINT, signal.SIGTERM)}
    os.chdir(proj)
    buf = io.StringIO()
    writer.start()
    t0 = time.perf_counter()
    try:
        with _chaos_tick_logs(stages) as logs, \
                contextlib.redirect_stdout(buf):
            code = cli_main(["loop", "-p", str(LOOP_AGENTS), "-n",
                             str(LOOP_ITERATIONS), "--sentinel", "--json"])
    finally:
        wall = (time.perf_counter() - t0) * 1e3
        stop.set()
        writer.join(10)
        os.chdir(saved_cwd)
        for sig, handler in handlers.items():   # the loop verb's own
            signal.signal(sig, handler)
        os.environ.pop(DEVICE_ENV, None)
        for k, old in saved.items():
            if old is not None:
                os.environ[k] = old
    print(f"{name}: loop exited {code} after {wall!r} ms, from second "
          f"{start_s:.2f} of its minute; {len(logs)} sentinel(s)")
    check(code == 0, f"{name}: loop exited {code}: {buf.getvalue()[-2000:]}")
    check(len(logs) == 1, f"{name}: {len(logs)} sentinels built")
    log = logs[0]
    scored = log.check_run(name)
    doc = json.loads(buf.getvalue())
    hot = seen.get("hot")
    zs = {a["agent"]: a.get("anomaly_z") for a in doc["agents"]}
    flags = [f["agent"] for f in log.sentinel.flags()]
    check(len(doc["agents"]) == LOOP_AGENTS
          and all(a["status"] == "done" and a["iteration"] == LOOP_ITERATIONS
                  and a["exit_codes"] == [0] * LOOP_ITERATIONS
                  and a["worker"] == ENGINES_LOCAL for a in doc["agents"]),
          f"{name}: agents {doc['agents']}")
    check(hot in zs and None not in zs.values() and zs[hot] >= ANOMALY_Z
          and max(zs, key=zs.get) == hot
          and (hot in flags or f"clawker.{LOOP_PROJECT}.{hot}" in flags),
          f"{name}: z {zs}, hot {hot} (threshold {ANOMALY_Z}), flags {flags}")
    check(api.container_list(all=True) == [],
          f"{name}: containers left {api.container_list(all=True)}")
    tick_ms = [ms["wall"] for n, _, ms, _ in log.ticks if n]
    print(f"{name}: loop -p {LOOP_AGENTS} -n {LOOP_ITERATIONS} --sentinel "
          f"through the CLI on the nsd driver: exit 0, run wall {wall!r} ms, "
          f"{LOOP_AGENTS} agents done; {len(log.ticks)} ticks, {len(scored)} "
          f"scored (tick ms median {statistics.median(tick_ms)!r}); storm "
          f"{hot} z {zs[hot]!r} (next {sorted(zs.values())[-2]!r}), flagged "
          f"{flags}; launches {json.dumps(dict(log.launches()))}")
    print(f"{name}: {log.stage_line()}")
    return log.launches(), {"loop": wall,
                            "refresh_once": statistics.median(tick_ms)}


def _lane_procs(base: Path, double) -> list[tuple[int, str]]:
    """Processes of a lane still running: a container's (its command
    line or working directory under ``base``: the shim's config, the
    double's rootfs) or one the double started."""
    from clawker_tpu_torch.testenv import live_pids

    needle = str(base).encode()

    def under_base(pid: int, _stat, cmdline: bytes) -> bool:
        try:
            cwd = os.readlink(f"/proc/{pid}/cwd").encode()
        except OSError:
            cwd = b""
        return needle in cmdline or needle in cwd

    pids = set(live_pids(under_base))
    if double is not None:
        pids.update(double.live_pids())
    out = []
    for pid in sorted(pids):
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
        except OSError:
            continue
        out.append((pid, cmd.replace(b"\0", b" ").decode(
            errors="replace").strip()))
    return out


def nsd_lane(name: str, base: Path, device: str, stages: dict, *,
             real: bool) -> tuple[collections.Counter, dict]:
    """One lane: ``NsdDriver`` brings up the port's daemon (over the
    double, its own spawn; on real namespaces, a daemon this phase
    starts in a mount namespace of its own, so the containers' overlay
    mounts never reach the host's table), the answering process is the
    port's, the API checks, then the loop; the containers, the daemon
    and every process of the lane gone after it; -> (launches, ms)."""
    from clawker_tpu_torch.engine.drivers.nsdriver import ENV_STATE, NsdDriver
    from clawker_tpu_torch.testenv import install_nsd_double

    sock = _nsd_sock(base)
    state = base / "state"
    settings = (NSD_SETTINGS + "runtime:\n  driver: nsd\n"
                f"  docker_host: unix://{sock}\n")
    saved = {k: os.environ.get(k) for k in ("PATH", ENV_STATE)}
    os.environ[ENV_STATE] = str(state)
    double = install_nsd_double(base / "double") if not real else None
    if double is not None:
        os.environ["PATH"] = double.env()["PATH"]
    drv = NsdDriver(docker_host=f"unix://{sock}")
    proc = api = None
    ms: dict = {}
    try:
        t0 = time.perf_counter()
        if real:
            sock.parent.mkdir(parents=True, exist_ok=True)
            with open(base / "nsd.log", "ab") as log:
                proc = subprocess.Popen(
                    ["unshare", "--mount", "--propagation", "private",
                     sys.executable, "-m", "clawker_tpu_torch.nsd",
                     "--socket", str(sock), "--state-dir", str(state)],
                    stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL, start_new_session=True,
                    env=dict(os.environ, PYTHONPATH=str(ROOT)))
            check(_wait(drv._answers, NSD_START_S),
                  f"{name}: the daemon never answered: "
                  f"{(base / 'nsd.log').read_text()[-2000:]}")
        drv.connect()
        ms["daemon start"] = (time.perf_counter() - t0) * 1e3
        proc = proc or drv._proc
        check(real or drv._proc is not None,
              f"{name}: NsdDriver spawned no daemon")
        argv = _listener_argv(sock)
        check("-m clawker_tpu_torch.nsd " in argv and str(sock) in argv
              and proc is not None and proc.poll() is None,
              f"{name}: the answering daemon is {argv!r}")
        api = drv.engine().api
        list(api.image_pull(NSD_IMAGE))
        list(api.image_pull(LOOP_IMAGE))
        ms.update(nsd_api_case(name, api, real=real))
        with _isolated_dirs(base / "loop", settings, proxy=False) as proj:
            (proj / ".clawker.yaml").write_text(
                f"project: {LOOP_PROJECT}\nagent:\n  cmd: "
                f"{json.dumps(NSD_AGENT_CMD)}\n")
            launches, loop_ms = nsd_loop_case(name, proj, api, device, stages)
        ms.update(loop_ms)
        left = api.container_list(all=True)
        check(left == [], f"{name}: containers left {left}")
    finally:
        if api is not None:     # a failed check may leave containers
            try:
                for row in api.container_list(all=True):
                    api.container_remove(row["Id"], force=True)
            except Exception:  # noqa: BLE001 - the daemon may be gone
                pass
        drv.close()
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(5)
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        if sock.parent.name.startswith("clawker-nsd-"):
            shutil.rmtree(sock.parent, ignore_errors=True)
    left = _lane_procs(base, double)
    if left:
        _wait(lambda: not _lane_procs(base, double), 5.0, 0.05)
        left = _lane_procs(base, double)
        _kill(left)
    check(not left, f"{name}: processes left {left}")
    print(card_line())
    print(f"{name} host ms: " + ", ".join(f"{k} {v!r}" for k, v in ms.items()))
    return launches, ms


def nsd_phase(device) -> collections.Counter:
    """nsd, the namespace container daemon, behind the nsd driver: (a)
    the probe, (b) the lane over the kernel-free double, (c) the lane on
    real namespaces where (a)'s trials pass; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "nsd"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    real, why = nsd_probe_case(out / "a")
    total = collections.Counter()
    lanes = ["(b) over the double"]
    with stage_timers({}) as stages:
        total.update(nsd_lane("nsd (b)", out / "b", device, stages,
                              real=False)[0])
        if real:
            total.update(nsd_lane("nsd (c)", out / "c", device, stages,
                                  real=True)[0])
            lanes.append("(c) on real namespaces")
        else:
            print(f"nsd (c): not run: {why}")
    no_process_left("nsd")
    print(f"nsd lanes: {', '.join(lanes)}; launches: {json.dumps(total)}; "
          f"phase wall {(time.perf_counter() - t0) * 1e3!r} ms")
    return total


ANALYSIS_BASELINE = "analysis-baseline-torch.json"
ANALYSIS_CHECKERS = {"chaos-determinism", "durable-append-checked",
                     "import-layering", "no-blocking-under-lock",
                     "registry-parity", "socket-hardening",
                     "wal-before-mutation"}
ANALYSIS_HEAVY = ("torch", "numpy", "click", "jax")
LOAD_LOOPS, LOAD_ITERATIONS = 8, 2      # tests/test_chaos.py:388-429


def analysis_gate_case() -> None:
    """(a): the port's analyzer over this checkout, forked as CI runs
    it: bare and through the ``analyze`` verb, each clean against the
    committed baseline; its checkers; its imports."""
    base = json.loads((ROOT / ANALYSIS_BASELINE).read_text())["findings"]
    for name, args in (
            ("python -m clawker_tpu_torch.analysis --json",
             ["-m", "clawker_tpu_torch.analysis", "--json"]),
            ("python -m clawker_tpu_torch analyze --json",
             ["-m", "clawker_tpu_torch", "analyze", "--json"])):
        proc, ms = _python(args, ROOT)
        check(proc.returncode == 0,
              f"analysis (a) {name}: exit {proc.returncode}: "
              f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        doc = json.loads(proc.stdout)
        check(doc["ok"] and set(doc["checkers"]) == ANALYSIS_CHECKERS
              and doc["new"] == [] and doc["stale_baseline"] == []
              and len(doc["grandfathered"]) == len(base),
              f"analysis (a) {name}: {json.dumps(doc)[:3000]}")
        print(f"analysis (a) {name}: exit 0, {doc['files_scanned']} files, "
              f"{len(doc['checkers'])} checkers, {len(doc['grandfathered'])} "
              f"grandfathered ({ANALYSIS_BASELINE}: {len(base)}), "
              f"{len(doc['suppressed'])} suppressed, none new or stale; "
              f"the analyzer's own wall {doc['wall_s']!r} s, the fork's "
              f"host {ms!r} ms")
    proc, ms = _python(["-m", "clawker_tpu_torch.analysis",
                        "--list-checkers"], ROOT)
    listed = {line.split()[0] for line in proc.stdout.splitlines() if line}
    check(proc.returncode == 0 and listed == ANALYSIS_CHECKERS,
          f"analysis (a) --list-checkers: exit {proc.returncode}, {listed}")
    proc, ms_imports = _python(["-c", (
        "import json, sys\n"
        "import clawker_tpu_torch.analysis\n"
        "import clawker_tpu_torch.analysis.runner\n"
        "import clawker_tpu_torch.analysis.checkers\n"
        f"print(json.dumps(sorted(set({ANALYSIS_HEAVY!r}) "
        "& set(sys.modules))))\n")], ROOT)
    check(proc.returncode == 0 and json.loads(proc.stdout) == [],
          f"analysis (a) imports: {proc.stdout} {proc.stderr[-2000:]}")
    print(f"analysis (a) --list-checkers: the {len(listed)} checkers, host "
          f"{ms!r} ms; the analyzer's three modules load none of "
          f"{', '.join(ANALYSIS_HEAVY)}, host {ms_imports!r} ms")


def _corpus_row(rep) -> tuple[int, int, int]:
    return rep.total, rep.captured, rep.contained


def analysis_corpus_case(out: Path) -> tuple[int, int, int]:
    """(b): the adversarial corpus on this host into a capture DB, 0
    escaped; the same corpus over a monitor-mode surface (the agent's
    cgroup without ``FLAG_ENFORCE``, tests/test_adversarial.py:70's
    shape) grades escapes; -> the clean pass's (total, captured,
    contained)."""
    from clawker_tpu_torch.adversarial import CaptureDB, harness, run_corpus
    from clawker_tpu_torch.adversarial import payloads as P
    from clawker_tpu_torch.firewall import model

    out.mkdir(parents=True)
    db = CaptureDB(out / "capture.db")
    try:
        t0 = time.perf_counter()
        rep = run_corpus(db)
        ms = (time.perf_counter() - t0) * 1e3
        counts = db.counts()
    finally:
        db.close()
    check(len(P.CORPUS) == 30 and rep.total >= 30 and rep.escaped == 0
          and rep.ok and sum(counts.values()) == rep.total,
          f"analysis (b): {rep.to_json()} capture rows {counts}")
    surface = harness.EgressSurface(P.default_rules(),
                                    resolutions=P.default_resolutions())
    surface.maps.enroll(harness.CG, model.ContainerPolicy(
        envoy_ip=harness.ENVOY_IP, dns_ip=harness.DNS_IP,
        hostproxy_ip=harness.HOSTPROXY_IP,
        hostproxy_port=harness.HOSTPROXY_PORT, flags=model.FLAG_HOSTPROXY))
    weak = collections.Counter(a.outcome.value for fn in P.CORPUS
                               for a in fn(surface))
    check(weak["escaped"] >= 1,
          f"analysis (b): the monitor-mode surface graded no escape: {weak}")
    print(f"analysis (b) run_corpus: {len(P.CORPUS)} classes, {rep.total} "
          f"attempts ({rep.captured} captured, {rep.contained} contained, "
          f"{rep.escaped} escaped), capture DB rows {dict(counts)}, host "
          f"{ms!r} ms; monitor mode: {dict(weak)}")
    return _corpus_row(rep)


def analysis_load_case(base: Path, device, stages: dict,
                       clean: tuple[int, int, int]) -> collections.Counter:
    """(c): the reference's BASELINE config #5 shape (tests/test_chaos.py:
    388-429) with the loop rig's live sentinel on the card and an egress
    burst: 8 loops x 2 iterations on 4 fake workers while the corpus runs
    in a loop, all inside the port's ``testenv.lock_tracing()``."""
    from clawker_tpu_torch import testenv
    from clawker_tpu_torch.adversarial import run_corpus
    from clawker_tpu_torch.analysis import lockgraph
    from clawker_tpu_torch.chaos.invariants import check_invariants
    from clawker_tpu_torch.config import load_config
    from clawker_tpu_torch.engine.drivers import FakeDriver
    from clawker_tpu_torch.engine.fake import exit_behavior
    from clawker_tpu_torch.loop import LoopScheduler, LoopSpec
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG
    from clawker_tpu_torch.sentinel import FleetSentinel

    name = "analysis (c)"
    check(lockgraph.installed_graph() is None,
          f"{name}: a lock tracer is installed already")
    bus_records: list = []
    reports: list = []
    with _isolated_dirs(base, CHAOS_SETTINGS, proxy=False) as proj:
        _clear_of_minute_end(LIVE_RUN_MARGIN_S)
        t0 = time.perf_counter()
        with testenv.lock_tracing() as graph:
            cfg = load_config(proj)
            drv = FakeDriver(n_workers=LOOP_WORKERS)
            for api in drv.apis:
                api.add_image(LOOP_IMAGE)
                api.set_behavior(LOOP_IMAGE, exit_behavior(
                    b"iteration done\n", 0, delay=LOOP_ITER_S))
            sched = LoopScheduler(cfg, drv, LoopSpec(
                parallel=LOAD_LOOPS, iterations=LOAD_ITERATIONS))
            s = FleetSentinel(cfg, drv, run_id=sched.loop_id, device=device,
                              interval_s=LOOP_TICK_S,
                              train_steps=SENTINEL_STEPS)
            log = TickLog(s, stages)
            sched.attach_sentinel(s)
            sched.events.add_tap(bus_records.append)
            agents = [sched._agent_name(i) for i in range(LOAD_LOOPS)]
            hot = agents[LOOP_HOT_SLOT]
            s.start()
            sched.start()
            runner = threading.Thread(target=sched.run,
                                      kwargs={"poll_s": 0.05},
                                      name="analysis-load-run")
            runner.start()
            for wid, recs in _loop_egress(agents, hot, time.time()).items():
                _append(cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
            while runner.is_alive():
                reports.append(run_corpus())
            runner.join(30)
            want = sum(len(v) for v in _loop_egress(agents, hot, 0).values())
            deadline = time.perf_counter() + 10
            while s._scored_at[0] < want and time.perf_counter() < deadline:
                time.sleep(LOOP_TICK_S)
            s.stop()
            sched.events.flush()
            wall = (time.perf_counter() - t0) * 1e3
            loops = [(lp.status, lp.iteration) for lp in sched.loops]
            sched.cleanup(remove_containers=True)
            violations = check_invariants(drv, cfg, sched.loop_id,
                                          loops=sched.loops, cap=4)
    check(lockgraph.installed_graph() is None,
          f"{name}: the tracer outlived its block")
    cycles = graph.cycles()
    check(cycles == [], f"{name}: lock-order cycles:\n"
          + graph.render_cycles())
    check(reports and all(r.escaped == 0 and _corpus_row(r) == clean
                          for r in reports),
          f"{name}: corpus passes under load "
          f"{[(_corpus_row(r), r.escaped) for r in reports]}, want "
          f"{clean} and 0 escaped")
    check(loops == [("done", LOAD_ITERATIONS)] * LOAD_LOOPS,
          f"{name}: loops {loops}")
    check(violations == [], f"{name}: invariants {violations}")
    scored = log.check_run(name)
    container = f"clawker.{LOOP_PROJECT}.{hot}"
    check(any(r.event == ANOMALY_FLAG and r.agent == container
              for r in bus_records),
          f"{name}: no {ANOMALY_FLAG} for {container} on the run's bus "
          f"(flags {s.flags()})")
    rep = graph.report()
    print(f"{name} {LOAD_LOOPS} loops x {LOAD_ITERATIONS} iterations over "
          f"{LOOP_WORKERS} fake workers ({LOOP_ITER_S} s each), the sentinel "
          f"on {device} and the corpus in a loop under lock tracing: run "
          f"wall {wall!r} ms; {len(reports)} corpus passes, each "
          f"{clean} (total, captured, contained), 0 escaped; every loop "
          f"done at iteration {LOAD_ITERATIONS}, no invariant broken; "
          f"{len(log.ticks)} ticks, {len(scored)} scored, {container} "
          f"flagged; lock graph: {rep['acquires']} acquires, "
          f"{rep['edges']} cross-site edges, "
          f"{sum(rep['same_site_nestings'].values())} same-site nestings, "
          f"0 cycles")
    print(f"{name}: {log.stage_line()}")
    return log.launches()


def analysis_phase(device) -> collections.Counter:
    """The static analyzer and the adversarial corpus: (a) the gate
    forked, (b) the corpus, (c) the corpus under a scored fleet's load
    with lock tracing; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "analysis"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    analysis_gate_case()
    clean = analysis_corpus_case(out / "b")
    with stage_timers({}) as stages:
        total = analysis_load_case(out / "c", device, stages, clean)
    check_no_reference_imports()
    no_process_left("analysis")
    print(f"analysis: launches {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


# ------------------------------------------------------------ parity phase


PARITY_SCENARIOS, PARITY_TECHNIQUES = 22, 35
PARITY_WALL_BUDGET_S = 10.0     # the reference's parallel-suite budget
#                                 (bench.py PARITY_WALL_BUDGET_S)
PARITY_AGENT = f"clawker.{LOOP_PROJECT}.redteam"
PARITY_MODULES = ("clawker_tpu_torch.parity", "clawker_tpu_torch.parity.world",
                  "clawker_tpu_torch.parity.scenarios",
                  "clawker_tpu_torch.parity.redteam",
                  "clawker_tpu_torch.parity.__main__")


def parity_scorecard_case(out: Path) -> None:
    """(a): ``python -m clawker_tpu_torch.parity --json`` forked as CI
    runs it (default jobs): 22/22 scenarios, 35/35 techniques, 0
    captures; where this host's bpf(2) probe passes, every kernel-
    regraded row passes too.  Its pass rate and wall beside the
    reference's budget, and what its modules load."""
    name = "parity (a)"
    proc, ms = _python(["-m", "clawker_tpu_torch.parity", "--json",
                        "--workdir", str(out)], ROOT)
    check(proc.returncode == 0,
          f"{name}: exit {proc.returncode}: {proc.stdout[-3000:]} "
          f"{proc.stderr[-3000:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    red = doc["redteam"]
    check(doc["passed"] == doc["total"] == PARITY_SCENARIOS
          and red["passed"] == red["total"] == PARITY_TECHNIQUES
          and red["captures"] == 0,
          f"{name}: {doc['passed']}/{doc['total']} scenarios, "
          f"{red['passed']}/{red['total']} techniques, {red['captures']} "
          f"captures: {json.dumps(doc)[:4000]}")
    regraded = [t for t in red["techniques"] if "kernel_regrade" in t]
    check(not red["kernel_regrade_available"]
          or (regraded and all(t["kernel_regrade"]["pass"]
                               for t in regraded)),
          f"{name}: kernel regrade {regraded}")
    # bench.py bench_parity: any capture voids the whole corpus
    passed = doc["passed"] + (red["passed"] if red["captures"] == 0 else 0)
    rate = 100.0 * passed / (doc["total"] + red["total"])
    print(f"{name} python -m clawker_tpu_torch.parity --json: exit 0, "
          f"{doc['passed']}/{doc['total']} scenarios, "
          f"{red['passed']}/{red['total']} techniques, {red['captures']} "
          f"captures; kernel_regrade_available "
          f"{red['kernel_regrade_available']} (regraded "
          f"{red['kernel_regraded']}, error {red['kernel_regrade_error']!r})")
    print(f"{name} firewall_parity_pass_rate {rate!r} %, parity_suite_wall "
          f"{doc['wall_s']!r} s against the reference's budget "
          f"{PARITY_WALL_BUDGET_S} s; the fork's host {ms!r} ms; card "
          f"{card_line()}")
    proc, ms_imports = _python(["-c", (
        "import importlib, json, sys\n"
        f"for m in {PARITY_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"print(json.dumps(sorted(set({ANALYSIS_HEAVY!r}) "
        "& set(sys.modules))))\n")], ROOT)
    check(proc.returncode == 0,
          f"{name} imports: {proc.stdout} {proc.stderr[-2000:]}")
    heavy = json.loads(proc.stdout)
    check("torch" not in heavy and "jax" not in heavy,
          f"{name}: the parity modules load {heavy}")
    print(f"{name}: the parity modules load {heavy} of "
          f"{', '.join(ANALYSIS_HEAVY)}, host {ms_imports!r} ms")


def parity_canary_case(base: Path) -> int:
    """(b): tests/test_redteam.py's canary on the port's world in this
    process: enforcement bypassed on ``CG_AGENT``, a TCP reach to the
    attacker and a dug exfil name land in the capture store; -> the
    captures."""
    from clawker_tpu_torch.parity.redteam import build_world
    from clawker_tpu_torch.parity.world import CG_AGENT

    name = "parity (b)"
    t0 = time.perf_counter()
    w = build_world(base)
    try:
        w.maps.set_bypass(CG_AGENT, int(time.time()) + 300)
        ip = w.dns_table["exfil.attacker.net"]
        sock = w.open_tcp(ip, 443, technique="canary")
        sock.close()
        _wait(lambda: w.attacker.store.count("canary") >= 1, 5.0)
        w.dig("aGVsbG8.exfil.attacker.net")
        _wait(lambda: w.attacker.store.count() >= 2, 5.0)
        canary = w.attacker.store.count("canary")
        rows = w.attacker.store.all()
    finally:
        w.close()
    check(canary >= 1 and len(rows) >= 2,
          f"{name}: the bypassed world captured {rows}")
    print(f"{name}: bypassed, the attacker captured {len(rows)} rows "
          f"({canary} tagged canary): {rows}; host "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return len(rows)


def parity_redteam_case(base: Path, device, stages: dict) -> collections.Counter:
    """(c): the red-team corpus (``jobs=1``) through one port ``World``;
    a ``NetLogger`` drains that world's ``FakeMaps`` into the red-team
    worker's ``ebpf-egress.jsonl``, naming ``CG_AGENT`` as an agent
    container, beside a benign fleet's stream (``egress_traffic``
    without its storm).  A live ``FleetSentinel`` ticks over both
    streams: the red-team agent ranks first and is flagged, every scored
    tick is one K3 and one K1, and the corpus captured nothing;
    -> launches."""
    from clawker_tpu_torch.firewall.hashes import zone_hash
    from clawker_tpu_torch.monitor.events import ANOMALY_FLAG, EventBus
    from clawker_tpu_torch.monitor.netlogger import NetLogger
    from clawker_tpu_torch.parity import redteam as R
    from clawker_tpu_torch.parity.world import CG_AGENT
    from clawker_tpu_torch.sentinel import FleetSentinel, StreamCollector

    name = "parity (c)"
    benign = base / "benign" / "ebpf-egress.jsonl"
    red_path = base / "redteam" / "ebpf-egress.jsonl"
    red_path.parent.mkdir(parents=True)
    with LoopbackUpstream() as up:
        run = egress_traffic(egress_modules(), benign, up.addr,
                             next_drain=_next_second, storm_slot=None)
    check(run["emitted"] == run["emitting"] == sum(run["drained"])
          and run["events_dropped"] == 0,
          f"{name}: the benign fleet {run}")
    col = StreamCollector()
    col.add_local("benign", benign)
    col.add_local("redteam", red_path)
    s = FleetSentinel(_Cfg(base), collector=col, window_s=EGRESS_WINDOW_S,
                      train_steps=SENTINEL_STEPS, interval_s=LOOP_TICK_S,
                      threshold=EGRESS_THRESHOLD, device=device)
    log = TickLog(s, stages)
    flags: dict = {}
    bus = EventBus(lambda agent, ev, detail:
                   flags.setdefault(agent, time.perf_counter())
                   if ev == ANOMALY_FLAG else None)
    s.bind_run(events=bus)
    s.start()
    _wait(lambda: any(entry[0] for entry in log.ticks), 10.0, 0.005)
    benign_flagged = sorted(flags)
    worlds: list = []
    build_world = R.build_world
    R.build_world = lambda tmp: worlds.append(build_world(tmp)) or worlds[-1]
    t0 = time.perf_counter()
    try:
        doc = R.run_corpus(base / "corpus", jobs=1)
    finally:
        R.build_world = build_world
    corpus_ms = (time.perf_counter() - t0) * 1e3
    check(len(worlds) == 1, f"{name}: the corpus built {len(worlds)} worlds")
    w = worlds[0]
    zones = {}
    for rule in w.rules:
        apex = rule.dst[2:] if rule.dst.startswith("*.") else rule.dst
        zones[zone_hash(apex)] = apex
    nl = NetLogger(w.maps, out_path=red_path,
                   resolve_cgroup=lambda cg:
                   PARITY_AGENT if cg == CG_AGENT else "",
                   resolve_zone=lambda zh: zones.get(zh, ""))
    drained = 0
    while (got := nl.drain_once()):
        drained += got
    t_drain = time.perf_counter()
    _wait(lambda: PARITY_AGENT in flags, EGRESS_FLAG_DEADLINE_S, 0.005)
    n_ticks = len(log.ticks)
    _wait(lambda: len(log.ticks) >= n_ticks + 2, 5.0, 0.005)  # idle ticks
    s.stop()
    bus.close()
    check(doc["passed"] == doc["total"] == PARITY_TECHNIQUES
          and doc["captures"] == 0,
          f"{name}: corpus {doc['passed']}/{doc['total']}, "
          f"{doc['captures']} captures {doc['capture_rows']}")
    check(drained > 0 and w.maps.events_dropped == 0,
          f"{name}: drained {drained}, dropped {w.maps.events_dropped}")
    check(PARITY_AGENT in flags, f"{name}: no flag for {PARITY_AGENT} "
          f"within {EGRESS_FLAG_DEADLINE_S} s: {s.flags()}")
    scored = log.check_run(name)
    rows = sorted(s.rows(), key=lambda r: -r["latest_z"])
    check(rows[0]["agent"] == PARITY_AGENT and rows[0]["flagged"],
          f"{name}: rows {rows[:3]}")
    recs = [json.loads(line) for line in red_path.read_text().splitlines()]
    reasons = collections.Counter((r["verdict"], r["reason"]) for r in recs)
    print(f"{name}: corpus jobs=1 through one World {doc['passed']}/"
          f"{doc['total']}, {doc['captures']} captures, host {corpus_ms!r} "
          f"ms; {drained} events drained for {PARITY_AGENT}, 0 dropped: "
          f"{dict(reasons)}; benign fleet {EGRESS_CONTAINERS} agents x "
          f"{EGRESS_ROUNDS} drains {run['drained']}")
    print(f"{name}: live sentinel over both streams "
          f"({s.collector.total()} records, windows of {EGRESS_WINDOW_S} s) "
          f"on {device}: {len(log.ticks)} ticks, {len(scored)} scored "
          f"({[entry[0] for entry in scored]} windows), {PARITY_AGENT} first "
          f"at z {rows[0]['latest_z']} and flagged on the bus "
          f"{(flags[PARITY_AGENT] - t_drain) * 1e3!r} ms after the last "
          f"drain; flagged before the corpus {benign_flagged}; launches "
          f"{json.dumps(dict(log.launches()))}")
    print(f"{name}: {log.stage_line()}")
    return log.launches()


def parity_phase(device) -> collections.Counter:
    """The firewall parity scorecard: (a) forked as CI runs it, (b) the
    canary, (c) red-team traffic scored on the card; -> launches."""
    out = ROOT / "build" / "chip_smoke" / "parity"
    t0 = time.perf_counter()
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    parity_scorecard_case(out / "a")
    parity_canary_case(out / "b")
    with stage_timers({}) as stages:
        total = parity_redteam_case(out / "c", device, stages)
    check_no_reference_imports()
    no_process_left("parity")
    print(f"parity: launches {json.dumps(total)}; phase wall "
          f"{(time.perf_counter() - t0) * 1e3!r} ms")
    return total


def check_no_reference_imports() -> None:
    leaked = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and (
                        m == "jax" or m.startswith("jax.")
                        or m == "clawker_tpu" or m.startswith("clawker_tpu.")))
    check(not leaked, f"reference modules imported: {leaked}")


def cards_phase() -> None:
    """``--cards``, on a host with several cards: the paths that exist
    only across cards, alone.  K1, K2 and K3 on every card, K5 over a
    data-only mesh of all of them and K5b over the fleet meshes
    (``every_device_check``); the sentinel's fused tick and
    ``bench_lane``, both sharded over the fleet mesh; and the fleet mesh's
    fit (K5b at an even count, else K5) of the hour's shape over the cards
    (K5b by the route ``model_route`` gives, and by the per-step route)
    beside the same shards on one card (host wall ms around a
    synchronized fit of shards placed before it, median of 5, and the
    placement's own)."""
    import torch

    from clawker_tpu_torch.analytics import features as F
    from clawker_tpu_torch.analytics import mesh as M
    from clawker_tpu_torch.analytics import runtime as art
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.sentinel import ScoringEngine, featurize_fused

    cards = torch.cuda.device_count()
    check(cards > 1, f"--cards needs several cards, {cards} visible")
    every_device_check()
    mesh = M.fleet_mesh()
    recs = synth_egress_records(agents=64, windows=4, per_window=16)
    for i, r in enumerate(recs):
        r["worker"] = f"fake-{i % 4}"
    keys, X, worker_of = featurize_fused(recs, None)
    rep, counts = _counted(lambda: ScoringEngine(
        train_steps=SENTINEL_STEPS).score_tick(keys, X, worker_of))
    _check_report("sentinel tick over the cards", rep.raw, rep.z, len(keys))
    _check_fit_launches("sentinel tick over the cards", counts, cards)
    check(rep.device.endswith(f"mesh={mesh.desc}"),
          f"sentinel tick over the cards: device {rep.device!r}")
    print(f"sentinel tick over the cards [{len(keys)},{X.shape[1]}]: "
          f"launches {json.dumps(counts)}, train_ms {rep.train_ms:.2f}, "
          f"device {rep.device}")
    doc = art.bench_lane(synth_egress_records())
    check(doc["windows"] == 520 and doc["device"].endswith(
        f"mesh={mesh.desc}"), f"bench_lane over the cards: {doc}")
    print(f"bench_lane over the cards: {json.dumps(doc)}")
    _, X = F.featurize(synth_egress_records(agents=64, windows=64,
                                            per_window=24))
    x = torch.from_numpy(art._pad_rows(X, X.shape[1], mesh.data)).to("cuda")
    params, noises = art._draw(0, FIT_STEPS, x)
    one_card = M.virtual_mesh(cards, "cuda:0")
    if mesh.model == 2:
        kname = "K5b"
        runs = ((f"the cards ({K.model_route(mesh.devices)} route)", mesh,
                 None), ("the cards (the per-step route)", mesh,
                         K.ROUTE_STEPS), ("one card", one_card, None))
    else:
        kname = "K5"
        runs = (("the cards", mesh, None), ("one card", one_card, None))
    for name, m, route in runs:
        placing, walls = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            shards = (M.shard_params(params, m), M.shard_rows(x, m),
                      M.shard_noise(noises, m))
            for dev in m.distinct:
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            losses = torch.empty(FIT_STEPS, device=x.device)
            if kname == "K5b":
                K.fit_model_(*shards, lr=1e-2, sigma=0.25, losses_out=losses,
                             route=route)
            else:
                K.fit_shard_(*shards, lr=1e-2, sigma=0.25, losses_out=losses)
            for dev in m.distinct:
                torch.cuda.synchronize(dev)
            placing.append((t1 - t0) * 1e3)
            walls.append((time.perf_counter() - t1) * 1e3)
        print(f"{kname} [{x.shape[0]},{x.shape[1]}] x{FIT_STEPS} over "
              f"{cards} shards on {name} ({m.desc}): wall "
              f"{statistics.median(walls)!r} ms per synchronized fit of "
              f"placed shards, median of 5 (placing them "
              f"{statistics.median(placing)!r} ms)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from clawker_tpu_torch.kernels import anomaly as K
    from clawker_tpu_torch.kernels import build

    os.environ[RUN_MARK] = f"{os.getpid()}.{time.time_ns()}"
    # no CLI this run forks onto a terminal checks for a release over the
    # network
    os.environ["CLAWKER_TPU_NO_NOTICES"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"build: {build.build_all():.1f} s")
    if sys.argv[1:] == ["--cards"]:
        cards_phase()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    ptxas_report(K.SCORE)
    ptxas_report(K.FIT_STEP)
    ptxas_report(K.FIT)
    ptxas_report(SHARD_SOURCE)
    ptxas_report(MODEL_SOURCE)
    device = "cuda"
    kernels = kernel_phase(device)
    shard_errs = shard_kernel_phase(device)
    model_errs = model_kernel_phase(device)
    every_device_check()
    main_path = main_path_phase(device)
    shard_times = mesh_fit_phase(device)
    model_times = model_timings(device)
    for k, v in graft_phase().items():
        main_path["launches"][k] += v
    bench_lane_phase(device)
    for k, v in sentinel_phase(device).items():
        main_path["launches"][k] += v
    for k, v in loop_phase(device).items():
        main_path["launches"][k] += v
    for k, v in loopd_phase(device).items():
        main_path["launches"][k] += v
    for k, v in workerd_phase(device).items():
        main_path["launches"][k] += v
    for k, v in resume_phase(device).items():
        main_path["launches"][k] += v
    for k, v in worktrees_phase(device).items():
        main_path["launches"][k] += v
    for k, v in chaos_phase(device).items():
        main_path["launches"][k] += v
    for k, v in views_phase(device).items():
        main_path["launches"][k] += v
    for k, v in engines_phase(device).items():
        main_path["launches"][k] += v
    for k, v in pod_phase(device).items():
        main_path["launches"][k] += v
    for k, v in verbs_phase(device).items():
        main_path["launches"][k] += v
    for k, v in images_phase(device).items():
        main_path["launches"][k] += v
    for k, v in federation_phase(device).items():
        main_path["launches"][k] += v
    for k, v in bundles_phase(device).items():
        main_path["launches"][k] += v
    for k, v in egress_phase(device).items():
        main_path["launches"][k] += v
    for k, v in firewall_phase(device).items():
        main_path["launches"][k] += v
    for k, v in fwkernel_phase(device).items():
        main_path["launches"][k] += v
    for k, v in controlplane_phase(device).items():
        main_path["launches"][k] += v
    for k, v in nsd_phase(device).items():
        main_path["launches"][k] += v
    for k, v in analysis_phase(device).items():
        main_path["launches"][k] += v
    for k, v in parity_phase(device).items():
        main_path["launches"][k] += v
    check_no_reference_imports()
    cli_phase(device)
    fleet_cli_phase(device)
    check_no_reference_imports()
    no_process_left("every phase")

    n, f = TIMED_SHAPE
    replaces = {
        K.SCORE: "clawker_tpu/analytics/anomaly.py:59",
        K.FIT_STEP: "clawker_tpu/analytics/anomaly.py:96",
        K.FIT: "clawker_tpu/analytics/runtime.py:128-144",
        K.FIT_SHARD: "clawker_tpu/analytics/anomaly.py:117-156",
        K.FIT_SHARD_PARTIALS: "clawker_tpu/analytics/anomaly.py:117-156",
        K.FIT_SHARD_REDUCE: "clawker_tpu/analytics/runtime.py:170-172,187-194",
        K.FIT_MODEL: "clawker_tpu/analytics/anomaly.py:132-145",
        K.FIT_MODEL_FORWARD: "clawker_tpu/analytics/anomaly.py:132-145",
        K.FIT_MODEL_PARTIALS: "clawker_tpu/analytics/anomaly.py:132-145",
        K.FIT_MODEL_REDUCE: "clawker_tpu/analytics/anomaly.py:132-145",
        K.FIT_MODEL_CARDS: "clawker_tpu/analytics/runtime.py:170-194",
    }
    # every kernel of the paths ran on them.  K2's body runs inside K3.
    # The cards route is the main path's only where the sentinel's fleet
    # mesh spans several cards with peer access: on one card the path takes
    # the fold, and model_kernel_phase and model_timings launch the cards
    # route with one participating card and hold its bits.
    exempt = {K.FIT_STEP}
    if not _cards_on_main_path():
        exempt.add(K.FIT_MODEL_CARDS)
    idle = [name for name in replaces
            if name not in exempt and not main_path["launches"][name]]
    check(not idle, f"kernels never launched on their paths: {idle}")
    timings = dict(kernels["timings"][(n, f)], **shard_times, **model_times)
    errs = dict(kernels["errs"], **shard_errs, **model_errs)
    record = []
    for name in replaces:
        ms, plain, bound, by = timings[name]
        source = (SHARD_SOURCE if name in shard_times else
                  MODEL_SOURCE if name in model_times else name)
        record.append({
            "name": name, "route": "cuda",
            "source": f"clawker_tpu_torch/kernels/csrc/{source}.cu",
            "replaces": replaces[name],
            "launches": main_path["launches"][name],
            "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    print(card_line())      # again beside the results: a tail shows it
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
    finally:
        _kill(_spawned_left())  # a failed phase may leave its daemons
