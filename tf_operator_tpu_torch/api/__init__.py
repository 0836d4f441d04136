"""The port's side of the operator's API: GPU job manifests (``gpu``)."""
