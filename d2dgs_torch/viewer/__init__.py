from .network import ViewerServer

__all__ = ["ViewerServer"]
