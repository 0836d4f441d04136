"""The in-container runtime of the port: the bootstrap from the
operator-injected env (``gpu_init``) and the gang-liveness heartbeat
(``heartbeat``)."""
