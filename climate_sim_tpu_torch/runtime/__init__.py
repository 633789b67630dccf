from .driver import RunResult, prepare, run_simulation

__all__ = ["RunResult", "prepare", "run_simulation"]
