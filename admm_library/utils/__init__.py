from . import checkpoint, compile_cache, oracle, profiling    # noqa: F401
