"""Host-side support: node configuration, logging, the control journal,
the IPC transports, metrics, tracing, faults, serialization and device
resolution."""
