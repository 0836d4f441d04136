"""Training machinery of the port: the train step with its optax-exact
optimizer, synthetic data, and the ``llama_train`` entry point."""
