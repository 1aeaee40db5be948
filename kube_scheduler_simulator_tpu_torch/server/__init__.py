"""The serving layer: a scheduling service over a resource store, the
multi-tenant session plane and the cross-tenant batch plane."""

from .batchplane import BatchPlane
from .service import SchedulerService, SimulatorService
from .sessions import SessionManager

__all__ = ["BatchPlane", "SchedulerService", "SessionManager", "SimulatorService"]
