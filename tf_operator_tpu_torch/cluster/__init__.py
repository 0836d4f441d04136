"""The port's side of the cluster: the Lease client of the heartbeat."""
