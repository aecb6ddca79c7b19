"""Builders of the program's agents from a configuration file, one module
per ``agent.kind``."""
