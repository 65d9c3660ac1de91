"""autotune: the CLI of core/tuner.py (port of ``tools/autotune.py``).

    python -m paddle_tpu_torch.tools.autotune offline --log RUN.jsonl \
        [--out profile.json] [--require-improvement] [--json]
    python -m paddle_tpu_torch.tools.autotune online --model-root ROOT \
        (--profile P | --set FLAG=VALUE ...) [--device cpu] [--json]
    python -m paddle_tpu_torch.tools.autotune space [--json]

``offline`` replays a captured telemetry run log (JSONL records and/or
bench rows) through the replay model: the search space's candidates are
constraint-gated and ranked on the measured objective (ms per
base-batch-equivalent step); the winner is written as a tuned profile.

``online`` starts an in-process cluster of ``--replicas`` replicas over a
published-models root on ``--device`` (the card unless ``cpu`` is
given), drives synthetic closed-loop load through its router and runs
one OnlineTrial of the candidate flags: promoted, or rolled back with
the flag snapshot restored.

``space`` dumps the typed search space.

Exit status: 0 done (offline: profile written; online: a verdict, the
flags clean), 2 unusable input (or residual flag overrides after a
rollback), 3 no improvement with --require-improvement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading


# ---------------------------------------------------------------------------
# offline
# ---------------------------------------------------------------------------


def cmd_offline(args) -> int:
    from ..core import tuner

    try:
        obs = tuner.RunLogObservations.load(args.log)
    except OSError as e:
        print(f"autotune: cannot read run log: {e}", file=sys.stderr)
        return 2
    try:
        result = tuner.offline_search(obs)
    except tuner.TunerError as e:
        print(f"autotune: {e}", file=sys.stderr)
        return 2

    best = result.best or tuner.Candidate()
    top = result.ranked[0] if result.ranked else None
    origin = {"run_log": [os.path.basename(p) for p in obs.sources],
              "created_by": "autotune-offline",
              "run_id": args.run_id or ""}
    profile = tuner.make_profile(
        best, objective=result.objective,
        replayed=top["score"] if top else None,
        default_objective=result.default_score,
        origin=origin, workload=args.workload)

    if args.json:
        print(json.dumps({
            "profile": profile,
            "default_objective": result.default_score,
            "improved": result.improved(),
            "observations": {
                "step_rows": len(obs.step_rows),
                "tokens_rows": len(obs.tokens_rows),
                "cost_programs": len(obs.cost_programs),
                "roofline": obs.roofline_summary(),
                "malformed": obs.malformed},
            "ranked": [{"label": r["candidate"].label,
                        "score": r["score"], "basis": r.get("basis"),
                        "reason": r.get("reason")}
                       for r in result.ranked]}, indent=2, default=str))
    else:
        print(f"autotune offline: {len(obs.step_rows)} step obs, "
              f"{len(obs.tokens_rows)} tokens obs, "
              f"{len(obs.cost_programs)} cost programs "
              f"(roofline {obs.roofline_summary() or 'n/a'})")
        print(f"  objective: {result.objective} (lower is better), "
              f"default = {result.default_score}")
        for r in result.ranked[:args.top]:
            c = r["candidate"]
            if r["score"] is None:
                print(f"  [rej ] {c.label:<40} {r.get('reason')}")
            else:
                print(f"  [{r['basis'][:4]:<4}] {c.label:<40} "
                      f"{r['score']:.4f}")
        verdict = "IMPROVED" if result.improved() else "no improvement"
        print(f"  best: {best.label} ({verdict}) -> "
              f"profile {profile['profile_hash']}")
    if args.out:
        tuner.save_profile(profile, args.out)
        if not args.json:
            print(f"  wrote {args.out}")
    if args.require_improvement and not result.improved():
        return 3
    return 0


# ---------------------------------------------------------------------------
# online
# ---------------------------------------------------------------------------


def _load_candidate_flags(args):
    from ..core import tuner

    if args.profile:
        doc = tuner.load_profile(args.profile)
        return dict(doc.get("flags") or {}), doc.get("profile_hash", "")
    flags = {}
    for item in args.set or []:
        name, _, val = item.partition("=")
        if not _:
            raise tuner.ProfileError(
                f"--set wants NAME=VALUE, got {item!r}")
        flags[name] = val
    return flags, "cli"


def _synthetic_load(url, model_root, stop, period_s=0.01):
    """Background closed-loop driver: POST random rows shaped off the
    published model's feed specs at the ROUTER url."""
    import urllib.request

    import numpy as np

    from .. import checkpoint as _ckpt
    from .. import io as _io

    newest = _ckpt.ModelWatcher(model_root).latest()
    assert newest is not None
    meta = _io.read_inference_model_meta(newest[1])
    rng = np.random.RandomState(0)

    def one():
        feeds = {}
        for name, spec in meta["feed_specs"].items():
            shape = [d if isinstance(d, int) and d > 0 else 1
                     for d in spec["shape"]]
            shape[0] = 1
            feeds[name] = rng.randn(*shape).astype("float32").tolist()
        req = urllib.request.Request(
            url + "/v1/infer",
            data=json.dumps({"inputs": feeds}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=30).read()
        except Exception:
            pass

    while not stop.is_set():
        one()
        stop.wait(period_s)


def run_online_trial(args):
    """Build an in-process cluster over ``args.model_root``, drive
    synthetic load, run one OnlineTrial; returns (TrialResult,
    residual_overrides: dict, fleet_version_ok: bool)."""
    from ..core import flags as _flags
    from ..core import tuner
    from ..serving.cluster import ClusterController

    candidate, label = _load_candidate_flags(args)
    if not candidate:
        raise tuner.TunerError("online mode needs a candidate: --profile "
                               "or --set FLAG=VALUE")
    pre = _flags.snapshot()
    cluster = ClusterController(args.model_root, replicas=args.replicas,
                                inprocess=True, device=args.device).start()
    stop = threading.Event()
    threads = [threading.Thread(
        target=_synthetic_load,
        args=(cluster.url, args.model_root, stop),
        name=f"pt-autotune-load-{i}", daemon=True)
        for i in range(args.load_threads)]
    incumbent_version = cluster.current_version
    try:
        for t in threads:
            t.start()
        trial = tuner.OnlineTrial(
            cluster, candidate, fraction=args.fraction,
            eval_interval_s=args.eval_interval,
            min_requests=args.min_requests, label=label)
        trial.start()
        result = trial.run()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
        fleet_version_ok = cluster.current_version == incumbent_version
        cluster.close()
    post = _flags.snapshot()
    if result.status == "promoted":
        residual = {}   # promoted flags are the new incumbent by design
    else:
        residual = {k: post[k] for k in post
                    if k in pre and post[k] != pre[k]}
    return result, residual, fleet_version_ok


def cmd_online(args) -> int:
    from ..core import tuner

    try:
        result, residual, version_ok = run_online_trial(args)
    except (tuner.TunerError, tuner.ProfileError) as e:
        print(f"autotune: {e}", file=sys.stderr)
        return 2
    doc = dict(result.as_dict(), residual_overrides=residual,
               fleet_on_incumbent_version=version_ok)
    if args.json:
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(f"autotune online: {result.status.upper()} "
              f"({result.reason}) after {result.evals} eval tick(s); "
              f"trial p99 {result.trial_p99} vs control "
              f"{result.control_p99}")
        if residual:
            print(f"  RESIDUAL OVERRIDES (bug!): {residual}")
    return 0 if not residual else 2


# ---------------------------------------------------------------------------
# space
# ---------------------------------------------------------------------------


def cmd_space(args) -> int:
    from ..core import tuner

    knobs = tuner.default_space()
    if args.json:
        print(json.dumps([k.as_dict() for k in knobs], indent=2,
                         default=str))
        return 0
    print(f"autotune search space ({len(knobs)} knobs):")
    for k in knobs:
        print(f"  {k.name:<26} [{k.target}] default={k.default!r} "
              f"domain={k.values!r}")
        if k.doc:
            print(f"      {k.doc}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cost-model-guided autotuner: offline replay search "
                    "+ online A/B promotion (core/tuner.py)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    off = sub.add_parser("offline", help="replay a run log, rank "
                                         "candidates, emit a profile")
    off.add_argument("--log", action="append", required=True,
                     help="telemetry JSONL run log or bench-row json "
                          "(repeatable; observations merge)")
    off.add_argument("--out", default="",
                     help="write the tuned profile here")
    off.add_argument("--workload", default="",
                     help="workload tag recorded in the profile")
    off.add_argument("--run-id", default="",
                     help="origin run id recorded in the profile")
    off.add_argument("--top", type=int, default=12,
                     help="ranked candidates to print")
    off.add_argument("--require-improvement", action="store_true",
                     help="exit 3 unless the best candidate beats the "
                          "default's replayed objective")
    off.add_argument("--json", action="store_true")

    on = sub.add_parser("online", help="A/B one candidate on a live "
                                       "in-process cluster")
    on.add_argument("--model-root", required=True,
                    help="published-models root (checkpoint."
                         "publish_model)")
    on.add_argument("--profile", default="",
                    help="tuned profile whose flags are the candidate")
    on.add_argument("--set", action="append", default=[],
                    help="candidate flag override NAME=VALUE "
                         "(repeatable; alternative to --profile)")
    on.add_argument("--replicas", type=int, default=2)
    on.add_argument("--device", default=None,
                    help="the replicas' device (default: the card)")
    on.add_argument("--fraction", type=float, default=None,
                    help="trial traffic slice (default "
                         "FLAGS_tuner_traffic_fraction)")
    on.add_argument("--eval-interval", type=float, default=0.5)
    on.add_argument("--min-requests", type=int, default=8)
    on.add_argument("--load-threads", type=int, default=2,
                    help="synthetic closed-loop client threads")
    on.add_argument("--json", action="store_true")

    sp = sub.add_parser("space", help="dump the typed search space")
    sp.add_argument("--json", action="store_true")

    args = ap.parse_args(argv)
    return {"offline": cmd_offline, "online": cmd_online,
            "space": cmd_space}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
