"""Parallel dispatch: the capacity-limited MoE dispatch on one device."""
