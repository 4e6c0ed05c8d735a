"""Host-side support the serving engine needs: metrics, tracing, device
resolution."""
