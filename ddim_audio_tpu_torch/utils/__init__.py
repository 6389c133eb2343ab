from .namespace import dict2namespace, namespace2dict

__all__ = ["dict2namespace", "namespace2dict"]
