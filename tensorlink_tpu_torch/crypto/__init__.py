from .identity import (
    NodeIdentity,
    authenticate_public_key,
    decrypt,
    encrypt,
    load_or_create_identity,
    node_id_from_public_key,
    sign,
    verify,
)

__all__ = [
    "NodeIdentity",
    "authenticate_public_key",
    "decrypt",
    "encrypt",
    "load_or_create_identity",
    "node_id_from_public_key",
    "sign",
    "verify",
]
