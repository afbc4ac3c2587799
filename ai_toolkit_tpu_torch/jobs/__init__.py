from .dispatch import get_job, run_job

__all__ = ["get_job", "run_job"]
