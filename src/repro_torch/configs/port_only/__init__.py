"""Configurations the port has and the JAX package has not, one module
each, registered in the registry's port-only table
(``configs.base.register(..., port_only=True)``, ``list_port_archs``): the
directory above holds one file per config of the JAX package's registry,
and the tests hold it to that."""
