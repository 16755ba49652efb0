from .tasks import spawn_logged

__all__ = ["spawn_logged"]
