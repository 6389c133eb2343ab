from .schedules import (
    DiffusionSchedule,
    get_beta_schedule,
    make_schedule,
    make_timestep_subsequence,
)

__all__ = ["get_beta_schedule", "DiffusionSchedule", "make_schedule",
           "make_timestep_subsequence"]
