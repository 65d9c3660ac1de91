"""Cluster serving control plane: replicated engines behind one router,
with supervised respawn and rolling model swaps (port of
``paddle_tpu/serving/cluster.py``).

* N **replicas**, each a ServingEngine over a published-models root
  (``/v1/infer``) or a DecodeEngine over a decoder-LM servable dir
  (``/v1/generate``), behind the HTTP server (serving/replica.py), with
  the health.py readiness machine;
* a **model watcher** (``checkpoint.ModelWatcher``) polling the models
  root every ``FLAGS_serving_model_poll_s``: a new verified version
  starts the **rolling swap** (``roll_to``): one replica at a time, the
  controller POSTs ``/v1/admin/swap``; the replica goes not-ready, warms
  every bucket on the new predictor while the old one serves, flips, and
  comes back ready before the next replica starts. The controller never
  takes the last ready replica offline, so the router always has one;
* a **router** (router.py) with prefix affinity, failover on the
  core/retry.py schedule, request-id dedup and the session journal;
* **tiers**: ``role_counts={"prefill": 1, "decode": 2}`` provisions each
  slot with a role it keeps across respawns. Decode-role replicas pull
  their prefill shipments THROUGH the router (``prefill_urls`` = the
  router's URL, ``Router.forward_prefill``) and every replica but a
  prefill one journals its sessions to the router;
* a **monitor** thread: a death is counted (``router.replica_deaths``)
  and filed as one ``replica_death`` incident (core/incidents.py, never
  rate-limited), the handle is marked down (the router has failed over by
  then) and the slot is respawned on a core/retry.py schedule, up to
  ``FLAGS_cluster_max_restarts`` times (``router.replica_restarts``;
  ``router.affinity_remaps`` when a tier member comes back); a predictor
  replica that comes back on another version than the fleet's is swapped
  onto it. A replica that ``scale_to`` / ``scale_tier`` retired is never
  counted dead nor respawned (``_retired`` holds the replica objects
  themselves: a set of ids, as the reference keeps, could take a later
  replica that reuses a collected one's address for retired);
* **elastic scaling**: ``scale_to(n)`` grows the fleet (a newcomer
  converges on the fleet's version) or shrinks it (a ready peer must
  exist before a victim leaves; the router drops the victim before
  ``stop()`` drains it), ``scale_tier(role, n)`` one tier; each call is
  one transition, one ``router.scale_events`` and one
  ``incidents.scale_events``. ``attach_scaler(policy)`` /
  ``autoscale_tick()`` / ``start_autoscaler()`` drive it from a
  distributed/scaler.py policy;
* **retune**: ``retune_replica(name)`` re-swaps one replica onto the
  fleet's version with a ServingConfig built from this process's
  ``serving_*`` flags (``/v1/admin/swap`` with ``reload_config`` and
  ``serving_flags``): the lever of an online autotune trial
  (core/tuner.py ``OnlineTrial``). The reference's replica builds that
  config from its own flags, which only an in-process replica shares
  with the controller; the port sends the values, so a process replica
  takes the candidate too.

Two replica backends share every path:

* ``inprocess=False`` (default): OS processes, ``python -m
  paddle_tpu_torch.serving.replica --device <device>``;
* ``inprocess=True``: engine + HTTP server threads in this process, the
  same wire surface on real sockets (never respawned: a test kills one
  on purpose).

``device=None`` means the card (``cuda``; raising without CUDA), as in
every entry point of the port; tests pass ``"cpu"``.

Not in the port yet: the fleet observatory (ROADMAP A10b), whose
``fleet.queue_frac`` the reference's autoscaler reads; here the policy
reads that gauge from telemetry and whoever drives the fleet writes it.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .. import checkpoint as _ckpt
from ..core import incidents, retry, telemetry
from ..core.flags import flag as _flag
from .router import Router, RouterHTTPServer, _http_json


class ClusterError(RuntimeError):
    """Control-plane failure (a replica never came up, a swap never
    took)."""


# the flags a ServingConfig reads (serving/engine.py): what a retune sends
SERVING_CONFIG_FLAGS = ("serving_max_batch_size", "serving_batch_timeout_ms",
                        "serving_max_queue_depth",
                        "serving_default_deadline_ms", "serving_buckets")


def _device_arg(device) -> str:
    """The --device of a replica process: None means the card."""
    return "cuda" if device is None else str(device)


# ---------------------------------------------------------------------------
# replica backends
# ---------------------------------------------------------------------------

class ReplicaProcess:
    """One supervised replica OS process."""

    def __init__(self, name: str, model_root: str,
                 env: Optional[Dict[str, str]] = None,
                 serving_config=None, ready_timeout_s: float = 120.0,
                 role: str = "unified",
                 decode_model_dir: Optional[str] = None,
                 prefill_urls: str = "", prefix_cache: bool = False,
                 journal_url: str = "", device=None, **_ignored):
        self.name = name
        self.model_root = model_root
        self.serving_config = serving_config
        # a generative replica serves this dir over /v1/generate; without
        # it the replica runs a predictor over model_root (/v1/infer)
        self.decode_model_dir = decode_model_dir
        self.env = env
        self.ready_timeout_s = ready_timeout_s
        # disaggregated-serving tier: passed to the process and the
        # router's affinity pick
        self.role = str(role or "unified")
        self.prefill_urls = prefill_urls
        self.prefix_cache = bool(prefix_cache)
        self.journal_url = journal_url
        self.device = _device_arg(device)
        self.proc: Optional[subprocess.Popen] = None
        self.url: Optional[str] = None
        self.version: Optional[int] = None
        self.log_tail: "deque[str]" = deque(maxlen=200)
        self._drain_thread: Optional[threading.Thread] = None

    def spawn(self):
        """Launch and block until the PT_REPLICA_READY announce line (or
        ``ready_timeout_s``); a replica that exits or stays silent raises
        ClusterError with the tail of its output."""
        env = dict(os.environ if self.env is None else self.env)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + \
            env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
               "--port", "0", "--device", self.device]
        if self.decode_model_dir:
            cmd += ["--decode-model-dir", self.decode_model_dir]
            if self.prefill_urls:
                cmd += ["--prefill-urls", self.prefill_urls]
            if self.prefix_cache:
                cmd += ["--prefix-cache"]
            if self.journal_url and self.role != "prefill":
                cmd += ["--journal-url", self.journal_url]
        else:
            cmd += ["--model-root", self.model_root]
            if self.serving_config is not None:
                cmd += ["--max-batch-size",
                        str(self.serving_config.max_batch_size),
                        "--batch-timeout-ms",
                        str(self.serving_config.batch_timeout_ms)]
        if self.role != "unified":
            cmd += ["--role", self.role]
        self.proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1)
        announce = self._await_announce()
        if announce is None:
            if self.proc.poll() is None:
                self.proc.kill()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            raise ClusterError(
                f"replica {self.name} never announced readiness "
                f"(exit={self.proc.returncode}); last output:\n"
                + "\n".join(list(self.log_tail)[-20:]))
        self.url = announce["url"]
        self.version = announce.get("version")
        # keep draining stdout so the pipe never fills and wedges the child
        self._drain_thread = threading.Thread(
            target=self._drain, name=f"pt-torch-replica-log-{self.name}",
            daemon=True)
        self._drain_thread.start()
        return self

    def _await_announce(self) -> Optional[Dict[str, Any]]:
        """Read the child's output until its announce line, its exit or
        the deadline; a reader thread keeps the deadline in force while
        the child prints nothing."""
        found: Dict[str, Any] = {}
        done = threading.Event()

        def read():
            try:
                for line in self.proc.stdout:
                    self.log_tail.append(line.rstrip())
                    if line.startswith("PT_REPLICA_READY "):
                        found.update(json.loads(
                            line[len("PT_REPLICA_READY "):]))
                        return
                    if line.startswith("PT_REPLICA_FAIL"):
                        return
            except (OSError, ValueError):
                pass
            finally:
                done.set()

        reader = threading.Thread(target=read, daemon=True,
                                  name=f"pt-torch-replica-boot-{self.name}")
        reader.start()
        done.wait(self.ready_timeout_s)
        return found or None

    def _drain(self):
        try:
            for line in self.proc.stdout:
                self.log_tail.append(line.rstrip())
        except (OSError, ValueError):
            pass

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self, sig: int = signal.SIGKILL):
        """The ungraceful death (tests, chaos)."""
        if self.alive():
            self.proc.send_signal(sig)

    def stop(self, timeout: float = 30.0):
        """Graceful stop: SIGTERM (the replica drains), then SIGKILL."""
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5)
        if self._drain_thread is not None:
            self._drain_thread.join(timeout=2)


class InprocReplica:
    """Engine + HTTP server threads in this process: the same wire surface
    as ReplicaProcess at a fraction of the start-up cost."""

    def __init__(self, name: str, model_root: str, serving_config=None,
                 role: str = "unified",
                 decode_model_dir: Optional[str] = None,
                 prefill_urls: str = "", prefix_cache: bool = False,
                 journal_sink=None, device=None, **_ignored):
        self.name = name
        self.model_root = model_root
        self.serving_config = serving_config
        self.decode_model_dir = decode_model_dir
        self.role = str(role or "unified")
        self.prefill_urls = prefill_urls
        self.prefix_cache = bool(prefix_cache)
        # in-process replicas journal straight into the router's
        # SessionJournal: the same records, no HTTP hop
        self.journal_sink = journal_sink
        self.device = device
        self.engine = None
        self.server = None
        self.url: Optional[str] = None
        self.version: Optional[int] = None
        self._stopped = False

    def spawn(self):
        if not self.decode_model_dir:
            return self._spawn_predictor()
        from .decode import DecodeConfig, decode_engine_from_dir
        from .server import ServingHTTPServer

        config = DecodeConfig(role=self.role, prefill_urls=self.prefill_urls,
                              prefix_cache=self.prefix_cache or None)
        self.engine = decode_engine_from_dir(self.decode_model_dir,
                                             config=config,
                                             device=self.device)
        if self.journal_sink is not None and self.role != "prefill":
            self.engine.journal_sink = self.journal_sink
        self.server = ServingHTTPServer(
            None, decode_engine=self.engine).start()
        self.url = self.server.url
        self.version = self.engine.version
        self.engine.start(warmup=True)
        self._stopped = False
        return self

    def _spawn_predictor(self):
        from ..inference import AnalysisConfig, create_predictor
        from .engine import ServingEngine
        from .server import ServingHTTPServer

        newest = _ckpt.ModelWatcher(self.model_root).latest()
        if newest is None:
            raise ClusterError(f"no verified published model under "
                               f"{self.model_root}")
        version, model_dir = newest
        self.engine = ServingEngine(
            create_predictor(AnalysisConfig(model_dir), device=self.device),
            config=self.serving_config, version=version)
        self.server = ServingHTTPServer(self.engine).start()
        self.url = self.server.url
        self.version = version
        self.engine.start(warmup=True)
        self._stopped = False
        return self

    def alive(self) -> bool:
        return not self._stopped

    def kill(self, sig: int = signal.SIGKILL):
        """Abrupt death: tear the socket down and fail the backlog —
        in-flight router dispatches see reset/refused, as after a
        SIGKILL."""
        self._stopped = True
        if self.server is not None:
            self.server.shutdown()
        if self.engine is not None:
            self.engine.close(drain=False, timeout=5)

    def stop(self, timeout: float = 30.0):
        if self._stopped:
            return
        self._stopped = True
        if self.engine is not None:
            self.engine.close(drain=True, timeout=timeout)
        if self.server is not None:
            self.server.shutdown()


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class ClusterController:
    """Launch N replicas, front them with a router, respawn the ones that
    die, and roll the fleet onto each newly published model version.

        cluster = ClusterController(models_root, replicas=2).start()
        ... POST cluster.url + "/v1/infer" ...
        checkpoint.publish_model(models_root, new_dir)   # rolls the fleet
        cluster.close()

    With ``decode_model_dir`` the replicas are decode engines over that
    servable dir instead (``role_counts`` provisions tiers) and nothing
    is watched:

        cluster = ClusterController("", decode_model_dir=d,
                                    role_counts={"decode": 2}).start()
    """

    def __init__(self, model_root: str = "", replicas: int = 2,
                 inprocess: bool = False, serving_config=None,
                 replica_env: Optional[Dict[str, str]] = None,
                 host: str = "127.0.0.1", router_port: int = 0,
                 model_poll_s: Optional[float] = None,
                 max_restarts: Optional[int] = None,
                 auto_swap: bool = True,
                 decode_model_dir: Optional[str] = None,
                 role_counts: Optional[Dict[str, int]] = None,
                 prefix_cache: bool = False, device=None,
                 replica_ready_timeout_s: float = 120.0):
        if not model_root and not decode_model_dir:
            raise ValueError("ClusterController needs a published-models "
                             "root or a decode_model_dir")
        self.model_root = os.path.abspath(model_root) if model_root else ""
        self.n_replicas = int(replicas)
        self.inprocess = bool(inprocess)
        self.serving_config = serving_config
        self.replica_env = replica_env
        self.model_poll_s = float(
            _flag("serving_model_poll_s") if model_poll_s is None
            else model_poll_s)
        self.max_restarts = int(
            _flag("cluster_max_restarts") if max_restarts is None
            else max_restarts)
        self.auto_swap = bool(auto_swap) and not decode_model_dir
        self.device = device
        self.replica_ready_timeout_s = float(replica_ready_timeout_s)
        self.decode_model_dir = os.path.abspath(decode_model_dir) \
            if decode_model_dir else None
        self.prefix_cache = bool(prefix_cache)
        # role_counts is the tier view ({"prefill": 1, "decode": 2}): it
        # fixes each slot's role, which the router's affinity pick reads;
        # without it every replica is unified
        self.roles: List[str] = []
        for r in sorted(role_counts or {}):
            self.roles.extend([str(r)] * int(role_counts[r]))
        if self.roles:
            self.n_replicas = len(self.roles)
        # slot -> role: a respawn keeps the role its slot was provisioned
        # with
        self._slot_roles: Dict[int, str] = {}
        self.router = Router()
        self.router_server = RouterHTTPServer(self.router, host=host,
                                              port=router_port)
        self.replicas: List[Any] = []
        self._handles: Dict[str, Any] = {}
        self._restarts: Dict[str, int] = {}
        self._next_index = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # both sets hold replica objects (hashed by identity), never ids:
        # an object they hold stays alive, so no newcomer can share its id
        self._counted_dead: set = set()
        # replicas scale_to / scale_tier stopped on purpose: the monitor
        # never counts them dead nor respawns them
        self._retired: set = set()
        self._scaler = None
        self._watcher: Optional[_ckpt.ModelWatcher] = None
        # serialises rolling swaps and guards current_version: held
        # across a whole fleet roll, so swaps never overlap
        self._swap_lock = threading.Lock()
        self.current_version: Optional[int] = None
        # replica -> (status, reply) of its last failed swap attempt
        self.swap_errors: Dict[str, Any] = {}

    # -- lifecycle -----------------------------------------------------------
    @property
    def url(self) -> str:
        return self.router_server.url

    def _make_replica(self, index: int, role: Optional[str] = None):
        name = f"replica-{index}"
        cls = InprocReplica if self.inprocess else ReplicaProcess
        if role is None:
            role = self._slot_roles.get(index)
        if role is None:
            role = self.roles[index % len(self.roles)] if self.roles \
                else "unified"
        self._slot_roles[index] = role
        extra: Dict[str, Any] = {}
        if self.decode_model_dir:
            extra["decode_model_dir"] = self.decode_model_dir
            extra["prefix_cache"] = self.prefix_cache
            if role == "decode":
                # pull shipments THROUGH the router (forward_prefill): the
                # replica never tracks prefill-tier membership
                extra["prefill_urls"] = self.url
            if role != "prefill":
                # RouterHTTPServer binds its port at construction, so the
                # journal endpoint is known before any spawn
                extra["journal_url"] = self.url + "/v1/session/journal"
                extra["journal_sink"] = self.router.sessions.update
        return cls(name, self.model_root, env=self.replica_env,
                   serving_config=self.serving_config, role=role,
                   device=self.device,
                   ready_timeout_s=self.replica_ready_timeout_s, **extra)

    def start(self, ready_timeout_s: float = 120.0) -> "ClusterController":
        if not self.decode_model_dir:
            self._watcher = _ckpt.ModelWatcher(self.model_root)
            newest = self._watcher.poll()
            if newest is None:
                raise ClusterError(f"no verified published model under "
                                   f"{self.model_root} — publish_model() "
                                   f"one before starting the cluster")
            with self._swap_lock:
                self.current_version = newest[0]
        try:
            for _ in range(self.n_replicas):
                replica = self._make_replica(self._next_index)
                self._next_index += 1
                replica.spawn()
                self.replicas.append(replica)
                self._restarts[replica.name] = 0
                self._handles[replica.name] = self.router.add_replica(
                    replica.name, replica.url, role=replica.role)
            self.router.start()
            self.router_server.start()
            self._wait_ready(ready_timeout_s)
        except BaseException:
            self.close()
            raise
        mon = threading.Thread(target=self._monitor_loop,
                               name="pt-torch-cluster-monitor", daemon=True)
        mon.start()
        self._threads.append(mon)
        if self.auto_swap:
            watch = threading.Thread(target=self._watch_loop,
                                     name="pt-torch-cluster-modelwatch",
                                     daemon=True)
            watch.start()
            self._threads.append(watch)
        return self

    def _wait_ready(self, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            for handle in self.router.handles():
                self.router.probe(handle)
            if all(h.ready for h in self.router.handles()):
                return
            dead = [r.name for r in self.replicas if not r.alive()]
            if dead:
                break
            time.sleep(0.1)
        not_ready = [h.name for h in self.router.handles() if not h.ready]
        tails = {r.name: list(getattr(r, "log_tail", ()))[-20:]
                 for r in self.replicas if r.name in not_ready}
        raise ClusterError(f"replicas never became ready: {not_ready}; "
                           f"last output: {tails}")

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []
        self.router_server.shutdown()
        self.router.close()
        for replica in self.replicas:
            replica.stop()

    # -- supervision ---------------------------------------------------------
    def _monitor_loop(self):
        while not self._stop.wait(0.25):
            self._supervise(list(self.replicas))

    def _supervise(self, replicas):
        """One monitor pass over ``replicas`` (a snapshot of the fleet,
        which a scale transition may shrink meanwhile)."""
        for replica in replicas:
            if self._stop.is_set():
                return
            if replica in self._retired:
                continue   # scale_to drained it on purpose
            if replica.alive():
                self._counted_dead.discard(replica)
                continue
            handle = self._handles.get(replica.name)
            if handle is not None:
                handle.mark_down("process_died")
            if replica not in self._counted_dead:
                self._counted_dead.add(replica)
                telemetry.counter_add("router.replica_deaths", 1,
                                      replica=replica.name)
                # one incident per death, exempt from the rate limit:
                # two replicas dying back to back both land
                rc = getattr(getattr(replica, "proc", None), "returncode",
                             None)
                incidents.report_incident(
                    "cluster", "replica_death", 1.0,
                    context={"replica": replica.name,
                             "role": getattr(replica, "role", "unified"),
                             "exit_code": rc,
                             "signal": -rc if isinstance(rc, int)
                             and rc < 0 else None},
                    rate_limit=False)
            if self.inprocess:
                continue   # tests kill in-process replicas on purpose
            if self._restarts[replica.name] >= self.max_restarts:
                telemetry.counter_add("router.replica_abandoned", 1,
                                      replica=replica.name)
                continue
            self._restarts[replica.name] += 1
            telemetry.counter_add("router.replica_restarts", 1,
                                  replica=replica.name)
            self._respawn(replica, handle)

    def _respawn(self, replica, handle):
        """Relaunch a dead replica's slot (same name, same role) on a
        core/retry.py schedule and point its router handle at the new
        process."""
        sched = retry.RetryPolicy(max_retries=3, backoff=0.2,
                                  deadline=300.0).start()
        while not self._stop.is_set():
            try:
                fresh = self._make_replica(
                    int(replica.name.rsplit("-", 1)[-1]))
                fresh.spawn()
            except ClusterError:
                outcome, delay = sched.note_failure()
                if outcome != retry.RETRY:
                    telemetry.counter_add("router.replica_abandoned", 1,
                                          replica=replica.name)
                    return
                time.sleep(delay)
                continue
            slot = next((j for j, r in enumerate(self.replicas)
                         if r is replica), None)
            if slot is None or self._stop.is_set():
                fresh.stop()
                return
            self.replicas[slot] = fresh
            self._counted_dead.discard(replica)
            if handle is not None:
                handle.rebind(fresh.url)
                self.router.probe(handle)
            if fresh.role in ("decode", "prefill"):
                # tier membership changed: the affinity hash now maps some
                # sessions elsewhere
                telemetry.counter_add("router.affinity_remaps", 1,
                                      role=fresh.role, reason="respawn")
            # a respawn comes up on the newest published version: bring
            # it to the fleet's if that is another
            with self._swap_lock:
                current = self.current_version
            if current is not None and fresh.version != current:
                path = self.current_model_path()
                if path is not None:
                    self._swap_one(fresh, current, path)
            return

    # -- rolling model swap --------------------------------------------------
    def _watch_loop(self):
        while not self._stop.wait(self.model_poll_s):
            newest = self._watcher.poll()
            if newest is not None:
                version, path = newest
                try:
                    self.roll_to(version, path)
                except ClusterError as e:
                    telemetry.counter_add("router.swap_errors", 1)
                    print(f"[cluster] rolling swap to v{version} "
                          f"failed: {e}", file=sys.stderr)

    def _swap_one(self, replica, version: int, path: str) -> bool:
        """Swap one replica (POST /v1/admin/swap), with retries. Returns
        whether it took; on failure the replica serves its old
        version."""
        sched = retry.RetryPolicy(max_retries=2, backoff=0.1,
                                  deadline=120.0).start()
        while True:
            try:
                code, doc = _http_json(
                    "POST", replica.url, "/v1/admin/swap",
                    body=json.dumps({"model_dir": path,
                                     "version": version}).encode(),
                    timeout=sched.remaining(default=90.0) or 90.0)
            except (ConnectionError, OSError) as e:
                code, doc = -1, {"error": repr(e)}
            if code == 200:
                telemetry.counter_add("router.swaps", 1)
                replica.version = version
                return True
            telemetry.counter_add("router.swap_errors", 1)
            self.swap_errors[replica.name] = (code, doc)
            outcome, delay = sched.note_failure()
            if outcome != retry.RETRY:
                return False
            time.sleep(delay)

    def _await_peer_ready(self, name: str, timeout_s: float):
        """Wait until a replica other than ``name`` is ready (or the
        timeout): the last ready replica is never taken offline."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not self._stop.is_set():
            for handle in self.router.handles():
                if handle.name != name:
                    self.router.probe(handle)
            if any(h.ready for h in self.router.handles()
                   if h.name != name):
                return
            time.sleep(0.1)

    def roll_to(self, version: int, path: str):
        """The rolling swap: one replica at a time goes not-ready, warms
        and flips, and the next starts only once it is ready again, so
        N-1 replicas carry the traffic throughout."""
        with self._swap_lock:
            failed = []
            for replica in list(self.replicas):
                if not replica.alive():
                    continue
                self._await_peer_ready(replica.name, timeout_s=30.0)
                if not self._swap_one(replica, version, path):
                    failed.append(replica.name)
                    continue
                handle = self._handles.get(replica.name)
                deadline = time.monotonic() + 60.0
                while handle is not None and time.monotonic() < deadline:
                    self.router.probe(handle)
                    if handle.ready:
                        break
                    time.sleep(0.05)
            self.current_version = version
            if failed:
                raise ClusterError(
                    f"rolling swap to v{version}: replicas {failed} "
                    f"failed to swap (still serving their old version): "
                    f"{ {n: self.swap_errors.get(n) for n in failed} }")

    # -- online autotune lever -----------------------------------------------
    def retune_replica(self, name: str, timeout: float = 120.0) -> bool:
        """Re-swap one replica onto the fleet's current model version with
        a ServingConfig built from this process's ``serving_*`` flags
        (``POST /v1/admin/swap {reload_config, serving_flags}``): the
        warm-then-flip machinery of a model swap, on one replica. Returns
        whether it took; on failure the replica keeps its old config."""
        replica = self.replica_named(name)
        if replica is None or not replica.alive():
            return False
        path = self.current_model_path()
        if path is None:
            return False
        with self._swap_lock:
            version = self.current_version
        body = {"model_dir": path, "version": version,
                "reload_config": True,
                "serving_flags": {k: _flag(k) for k in SERVING_CONFIG_FLAGS}}
        try:
            code, doc = _http_json("POST", replica.url, "/v1/admin/swap",
                                   body=json.dumps(body).encode(),
                                   timeout=timeout)
        except (ConnectionError, OSError) as e:
            code, doc = -1, {"error": repr(e)}
        ok = code == 200
        telemetry.counter_add("router.swaps" if ok else "router.swap_errors",
                              1, replica=name, version=version,
                              reason="retune")
        if not ok:
            self.swap_errors[name] = (code, doc)
            return False
        # readiness back before the caller's next dispatch
        handle = self._handles.get(name)
        deadline = time.monotonic() + timeout
        while handle is not None and time.monotonic() < deadline:
            self.router.probe(handle)
            if handle.ready:
                break
            time.sleep(0.05)
        return True

    # -- elastic replica scaling ---------------------------------------------
    def _grow(self, count: int, role: Optional[str],
              ready_timeout_s: float):
        """Spawn ``count`` replicas (``role``: their tier, None the slot
        default), register them with the router, converge each on the
        fleet's version and wait for the fleet to be ready."""
        for _ in range(count):
            replica = self._make_replica(self._next_index, role=role)
            self._next_index += 1
            replica.spawn()
            self.replicas.append(replica)
            self._restarts[replica.name] = 0
            self._handles[replica.name] = self.router.add_replica(
                replica.name, replica.url, role=replica.role)
            # a newcomer comes up on the newest published version: bring
            # it to the fleet's if a roll moved past that
            if self.current_version is not None and \
                    replica.version != self.current_version:
                for v, path in _ckpt.list_model_versions(self.model_root):
                    if v == self.current_version:
                        self._swap_one(replica, v, path)
                        break
        deadline = time.monotonic() + ready_timeout_s
        while time.monotonic() < deadline:
            for handle in self.router.handles():
                if not handle.ready:
                    self.router.probe(handle)
            if all(h.ready for h in self.router.handles()):
                break
            time.sleep(0.05)

    def _retire(self, victim):
        """Take one replica out: a ready peer first, then the router drops
        it (no new dispatch lands on it), then ``stop()`` drains it."""
        self._await_peer_ready(victim.name, timeout_s=30.0)
        self._retired.add(victim)
        self.replicas.remove(victim)
        self._handles.pop(victim.name, None)
        self.router.remove_replica(victim.name)
        victim.stop()

    def scale_to(self, n: int, reason: str = "manual",
                 ready_timeout_s: float = 60.0) -> int:
        """Grow or shrink the fleet to exactly ``n`` replicas with no
        dropped request: a shrink retires the most recently added
        replicas. One call is one transition: one ``router.scale_events``
        and one ``incidents.report_scale_event``. Returns the count."""
        n = int(n)
        if n < 1:
            raise ClusterError("scale_to: need at least 1 replica")
        with self._swap_lock:
            old = len(self.replicas)
            if n == old:
                return old
            if n > old:
                self._grow(n - old, None, ready_timeout_s)
            else:
                for _ in range(old - n):
                    self._retire(self.replicas[-1])
            self.n_replicas = len(self.replicas)
        telemetry.counter_add("router.scale_events", 1,
                              direction="up" if n > old else "down",
                              replicas=n)
        incidents.report_scale_event("cluster", "resize", old, n,
                                     reason=reason)
        return n

    def scale_tier(self, role: str, n: int, reason: str = "manual",
                   ready_timeout_s: float = 60.0) -> int:
        """Grow or shrink one role tier (prefill / decode / unified) to
        exactly ``n`` replicas, the other tiers untouched; new slots keep
        their role across respawns. Returns the tier's size."""
        role = str(role)
        n = int(n)
        if n < 0:
            raise ClusterError("scale_tier: need n >= 0")
        with self._swap_lock:
            old = len(self.tier_members(role))
            if n == old:
                return old
            if n > old:
                self._grow(n - old, role, ready_timeout_s)
            else:
                for _ in range(old - n):
                    self._retire(self.tier_members(role)[-1])
            self.n_replicas = len(self.replicas)
        telemetry.counter_add("router.scale_events", 1,
                              direction="up" if n > old else "down",
                              tier=role, replicas=n)
        if role in ("decode", "prefill"):
            telemetry.counter_add("router.affinity_remaps", 1, role=role,
                                  reason="scale_tier")
        incidents.report_scale_event("cluster", f"resize_{role}", old, n,
                                     reason=reason)
        return n

    def attach_scaler(self, policy) -> "ClusterController":
        """Drive the replica count from a distributed/scaler.py
        ScalerPolicy."""
        self._scaler = policy
        return self

    def autoscale_tick(self, now: Optional[float] = None):
        """One policy evaluation and at most one transition; returns the
        executed ScaleDecision or None. The policy reads
        ``fleet.queue_frac`` from telemetry (no fleet observatory)."""
        if self._scaler is None:
            return None
        decision = self._scaler.decide(len(self.replicas), now=now)
        if decision is None:
            return None
        self.scale_to(decision.target, reason=decision.reason)
        return decision

    def start_autoscaler(self, interval_s: float = 5.0):
        """A background autoscale loop (tests call autoscale_tick)."""
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.autoscale_tick()
                except ClusterError:
                    telemetry.counter_add("router.scale_errors", 1)
        t = threading.Thread(target=loop, name="pt-torch-cluster-autoscale",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return self

    # -- introspection -------------------------------------------------------
    def replica_named(self, name: str):
        return next((r for r in self.replicas if r.name == name), None)

    def current_model_path(self) -> Optional[str]:
        """The path of the fleet's current model version (None when it
        was unpublished behind the controller's back)."""
        with self._swap_lock:
            version = self.current_version
        for v, path in _ckpt.list_model_versions(self.model_root):
            if v == version:
                return path
        return None

    def tier_members(self, role: str) -> List[Any]:
        """Live replicas provisioned into ``role`` (slot order)."""
        return [r for r in self.replicas
                if getattr(r, "role", "unified") == str(role)]

    def stats(self) -> Dict[str, Any]:
        out = self.router.stats()
        out["restarts"] = dict(self._restarts)
        out["replica_backend"] = "inprocess" if self.inprocess \
            else "process"
        out["current_version"] = self.current_version
        return out
