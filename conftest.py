"""Every test under ``tests/`` runs under one time limit
(``tests/time_limit.py``); only a root conftest may load a plugin."""

pytest_plugins = ["tests.time_limit"]
