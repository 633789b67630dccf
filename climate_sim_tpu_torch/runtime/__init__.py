# The driver's names load on first use: the kernel wrappers under ops/
# import the tracer (runtime.tracing), and the driver imports them.
__all__ = ["RunResult", "prepare", "run_simulation"]


def __getattr__(name):
    if name in __all__:
        from . import driver

        return getattr(driver, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
