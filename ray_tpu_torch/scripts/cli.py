"""``rt``, the cluster's command line (port of ray_tpu/scripts/cli.py).

``status``, ``list`` and ``summary`` read the freshest session's
``state.json`` (``util/state.py``: the head writes it every
``state_dump_interval_s``), so they work from any shell of the host while
a driver runs. ``agent`` joins a running cluster as a node: another
host's, with a shared-memory namespace of its own, its credentials from
the flags or, on the head's host, from the session's
``cluster_info.json``. ``up`` launches a cluster from a JSON (or YAML)
configuration in the foreground (``autoscaler/launcher.py``) and ``down``
stops the newest live one. ``lint`` is not ported yet and raises naming its
ROADMAP.md item.

    python -m ray_tpu_torch.scripts.cli status
    python -m ray_tpu_torch.scripts.cli list nodes|actors|tasks|objects|pgs
    python -m ray_tpu_torch.scripts.cli summary tasks|actors
    python -m ray_tpu_torch.scripts.cli agent [--address host:port --authkey HEX --transfer-authkey HEX]
        [--num-cpus N] [--num-gpus N] [--reconnect S]
    python -m ray_tpu_torch.scripts.cli up cluster.json
    python -m ray_tpu_torch.scripts.cli down
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load():
    from ray_tpu_torch.util.state import load_latest_state, sessions_root

    snap = load_latest_state()
    if snap is None:
        print(f"no ray_tpu_torch session state found under {sessions_root()}", file=sys.stderr)
        sys.exit(1)
    age = time.time() - snap.get("ts", 0)
    if age > 30:
        print(f"warning: the snapshot is {age:.0f} s old (its driver may have exited)", file=sys.stderr)
    return snap


def _fmt_resources(res: dict) -> str:
    return ", ".join(f"{k}={v:g}" for k, v in sorted(res.items()))


def cmd_status(_args):
    snap = _load()
    st = snap["status"]
    print(f"== ray_tpu_torch status (session pid {snap['pid']}, {time.time() - snap['ts']:.1f} s ago) ==")
    print(f"Nodes ({len(st['nodes'])}):")
    for n in st["nodes"]:
        mark = "" if n["alive"] else " [DEAD]"
        print(f"  {n['node_id'][:12]}{mark}  workers={n['num_workers']}  "
              f"avail: {_fmt_resources(n['available'])}  total: {_fmt_resources(n['resources'])}")
    print(f"Cluster resources: {_fmt_resources(st['cluster_resources'])}")
    print(f"Available:         {_fmt_resources(st['available_resources'])}")
    if st.get("pending_demand"):
        print(f"Pending demand ({len(st['pending_demand'])} requests):")
        for r in st["pending_demand"][:10]:
            print(f"  {_fmt_resources(r)}")
    if st.get("actors"):
        print(f"Actors by state: {st['actors']}")


def cmd_list(args):
    snap = _load()
    kind = args.kind
    if kind == "nodes":
        rows = snap["status"]["nodes"]
    elif kind == "actors":
        rows = snap.get("actors_list") or []
    elif kind in ("pgs", "placement_groups"):
        rows = snap.get("placement_groups", [])
    else:  # tasks, objects
        rows = snap.get(kind, {})
    print(json.dumps(rows, indent=2, default=str))


def cmd_summary(args):
    snap = _load()
    print(json.dumps(snap.get("tasks", {}) if args.kind == "tasks" else snap["status"].get("actors", {}), indent=2))


def cmd_agent(args):
    """Join a running cluster as a node agent: another host's node, with a
    shm namespace of its own."""
    import os
    import secrets

    from ray_tpu_torch.core.node_agent import standalone_agent_main

    if args.address:
        if not args.authkey or not args.transfer_authkey:
            print("--address needs --authkey and --transfer-authkey (hex, from the head's cluster_info.json)",
                  file=sys.stderr)
            sys.exit(2)
        host, _, port = args.address.rpartition(":")
        authkey, transfer_key = bytes.fromhex(args.authkey), bytes.fromhex(args.transfer_authkey)
    else:
        from ray_tpu_torch.util.state import load_latest_cluster_info

        info = load_latest_cluster_info()
        if info is None:
            print("no running session found; pass --address, --authkey and --transfer-authkey", file=sys.stderr)
            sys.exit(1)
        host, port = info["agent_address"]
        authkey, transfer_key = bytes.fromhex(info["authkey"]), bytes.fromhex(info["transfer_authkey"])
    # a joined agent stands for another host: a namespace of its own, unique
    # beyond this pid (another host's agent, or the head, may share it)
    os.environ.setdefault("RT_SHM_NS", f"{os.getpid()}j{secrets.token_hex(2)}")
    resources = {"CPU": float(args.num_cpus)}
    cards = args.num_gpus or args.num_tpus
    if cards:
        resources["GPU"] = float(cards)
    labels = {"ray_tpu.io/join-token": args.join_token} if args.join_token else None
    print(f"joining the head at {host}:{port} with {resources}", flush=True)
    standalone_agent_main(host, int(port), authkey, transfer_key, resources, reconnect_s=args.reconnect,
                          labels=labels)


def _not_ported(what: str, item: str):
    from ray_tpu_torch.core.context import not_ported

    not_ported(what, item)


def cmd_up(args):
    from ray_tpu_torch.autoscaler.launcher import up

    print(f"launching the cluster of {args.config} (Ctrl-C or `rt down` stops it)", flush=True)
    up(args.config, block=True)


def cmd_down(_args):
    from ray_tpu_torch.autoscaler.launcher import down

    if down():
        print("sent shutdown to the cluster's head")
    else:
        print("no running `rt up` head found", file=sys.stderr)
        sys.exit(1)


def cmd_lint(_args):
    from ray_tpu_torch.core.context import LINT_ITEM

    _not_ported("rt lint (the static analyzer)", LINT_ITEM)


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv[:1] == ["lint"]:
        cmd_lint(None)
    p = argparse.ArgumentParser(prog="rt", description="ray_tpu_torch cluster CLI")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status")
    lp = sub.add_parser("list")
    lp.add_argument("kind", choices=["nodes", "actors", "tasks", "objects", "pgs", "placement_groups"])
    sp = sub.add_parser("summary")
    sp.add_argument("kind", choices=["tasks", "actors"])
    ap = sub.add_parser("agent", help="join a running cluster as a node (another host's)")
    ap.add_argument("--address", default=None, help="the head's agent listener, host:port")
    ap.add_argument("--authkey", default=None, help="the agent channel's authkey, hex")
    ap.add_argument("--transfer-authkey", default=None, help="the object transfer authkey, hex")
    ap.add_argument("--num-cpus", type=float, default=1.0)
    ap.add_argument("--num-gpus", type=float, default=0.0)
    ap.add_argument("--num-tpus", type=float, default=0.0, help="ray_tpu's name for --num-gpus")
    ap.add_argument("--reconnect", type=float, default=60.0, help="seconds to keep redialing a lost head")
    ap.add_argument("--join-token", default=None, help="an opaque token echoed in the hello")
    up = sub.add_parser("up", help="launch a cluster from a JSON or YAML config (head and autoscaler)")
    up.add_argument("config")
    sub.add_parser("down", help="stop the newest `rt up` head")
    sub.add_parser("lint", help="the static analyzer (not ported)", add_help=False)
    args = p.parse_args(argv)
    {"status": cmd_status, "list": cmd_list, "summary": cmd_summary, "agent": cmd_agent, "up": cmd_up,
     "down": cmd_down, "lint": cmd_lint}[args.cmd](args)


if __name__ == "__main__":
    main()
