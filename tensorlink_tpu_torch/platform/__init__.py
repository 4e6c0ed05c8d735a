"""Platform services: state persistence, job monitoring, reward accounting,
proof-of-learning primitives (reference nodes/keeper.py, job_monitor.py,
contract_manager.py, ml/proofs.py)."""
