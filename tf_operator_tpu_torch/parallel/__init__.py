"""Device meshes (``mesh``) and the sharding of the model over them
(``sharding``): FSDP2 over the data axes, DTensor tensor parallelism over
``tp``."""
