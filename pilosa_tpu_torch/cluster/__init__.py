"""Node-to-node plumbing (counterpart of pilosa_tpu/cluster): static
topology and slice placement, the internal HTTP client, the metadata
broadcast plane and heartbeat membership."""
