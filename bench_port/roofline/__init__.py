"""One file per hand kernel of the port: the operations and bytes a
call's real problems need (registry.rooflines() finds them by name)."""
