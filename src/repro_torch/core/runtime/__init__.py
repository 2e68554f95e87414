from .runtime import FaseRuntime, Report, TargetCrash, Deadlock  # noqa: F401
