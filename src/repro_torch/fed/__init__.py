"""Federated round loop of the port: engine, registries, spec API."""
