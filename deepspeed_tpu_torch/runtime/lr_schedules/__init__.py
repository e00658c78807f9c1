from .schedules import SCHEDULES, create_scheduler

__all__ = ["create_scheduler", "SCHEDULES"]
