"""CLI node runner (port of ``tensorlink_tpu/cli.py``; reference
bin/run_node.py:213-289 + run-node.sh).

``python -m tensorlink_tpu_torch.cli --config config.json`` starts a
worker / validator / user node from an operator config file, prints one
JSON line ``{"id", "role", "port"}`` once the node is up, prints the
terminal status dashboard on an interval (reference print_ui_status,
p2p/torch_node.py:963-1049), and shuts down cleanly on SIGINT/SIGTERM.

A worker serves on the card unless its config says ``"ml": {"device":
"cpu"}``. Unlike the JAX runner, which falls back to host capacity when
the accelerator is dead, a worker that asks for the card on a host
without one exits at once with the device error (status 1): it never
hangs and never moves to the CPU on its own."""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

from tensorlink_tpu_torch.core.config import NodeConfig, load_config


def status_report(node) -> str:
    """One-screen text dashboard (reference print_ui_status)."""
    st = node.status()
    lines = [
        f"=== tensorlink_tpu_torch {st['role']} {st['id'][:16]} ===",
        f"addr {st['addr'][0]}:{st['addr'][1]}  uptime {st['uptime_s']:.0f}s  "
        f"dht_keys {st['dht_keys']}",
        f"peers ({len(st['peers'])}):",
    ]
    for nid, p in sorted(st["peers"].items()):
        lat = p.get("latency_s")
        lines.append(
            f"  {nid} {p.get('role', '?'):<10} "
            f"tx {p.get('sent', 0):>10}  rx {p.get('recv', 0):>10}  "
            f"lat {f'{lat * 1e3:.1f}ms' if lat else '—':>8}  "
            f"ghosts {p.get('ghosts', 0)}"
        )
    return "\n".join(lines)


def make_node(cfg: NodeConfig):
    from tensorlink_tpu_torch.nodes.runners import (
        UserNode,
        ValidatorNode,
        WorkerNode,
    )

    cls = {"worker": WorkerNode, "validator": ValidatorNode, "user": UserNode}[
        cfg.role
    ]
    return cls(cfg)


def _seed_addr(s: str) -> tuple[str, int]:
    host, sep, port = s.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise argparse.ArgumentTypeError(f"expected HOST:PORT, got {s!r}")
    return (host, int(port))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="run-node", description=__doc__)
    ap.add_argument("--config", "-c", default="config.json",
                    help="operator config file (reference bin/config.json)")
    ap.add_argument("--role", choices=["worker", "validator", "user"],
                    help="override the config's role")
    ap.add_argument("--seed", action="append", default=[], type=_seed_addr,
                    metavar="HOST:PORT", help="seed validator (repeatable)")
    ap.add_argument("--port", type=int, help="listen port override")
    ap.add_argument("--local", action="store_true",
                    help="local test mode (127.0.0.1, no UPnP)")
    ap.add_argument("--ui-interval", type=float, default=180.0,
                    help="status dashboard interval, seconds (0 = off)")
    args = ap.parse_args(argv)

    try:
        cfg = load_config(args.config)
    except FileNotFoundError:
        cfg = NodeConfig()
    if args.role:
        from tensorlink_tpu_torch.core.config import ROLE_CONFIGS, _coerce

        # _coerce drops fields the target role's config doesn't define
        # (e.g. worker 'mining' when switching to validator)
        flat = {k: v for k, v in cfg.__dict__.items() if k != "role"}
        cfg = _coerce(ROLE_CONFIGS[args.role], flat)
    if args.seed:
        cfg.seed_validators = list(args.seed)
    if args.port is not None:
        cfg.port = args.port
    if args.local:
        cfg.local_test = True

    stop = {"flag": False}

    def handle(sig, frame):
        stop["flag"] = True

    # installed before the node starts, so a signal during start-up still
    # stops the node's processes below
    signal.signal(signal.SIGINT, handle)
    signal.signal(signal.SIGTERM, handle)
    try:
        node = make_node(cfg).start()
    except RuntimeError as e:
        # a worker asking for a card the host lacks (core/devices.py)
        print(f"run-node: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"id": node.node_id, "role": node.role,
                      "port": node.port}), flush=True)

    last_ui = time.monotonic()
    try:
        while not stop["flag"]:
            time.sleep(0.5)
            if args.ui_interval and time.monotonic() - last_ui >= args.ui_interval:
                print(status_report(node), flush=True)
                last_ui = time.monotonic()
    finally:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
