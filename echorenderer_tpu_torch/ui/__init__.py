from .preview import PreviewServer, PreviewState

__all__ = ["PreviewServer", "PreviewState"]
