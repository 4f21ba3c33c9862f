"""Planner-as-a-service (``planner``, ``population``); the serving engine
of the JAX package's ``serve/engine.py`` is not ported yet."""
