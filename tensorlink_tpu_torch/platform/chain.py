"""EVM submission layer, stdlib-only — the on-chain half of the contract
manager (the port's copy of ``tensorlink_tpu/platform/chain.py``: the
port imports nothing of the JAX package, so it keeps its own).

Reference: nodes/contract_manager.py submits proposal hashes, votes, and
executions to a Smartnodes contract via web3 (createProposal:534,
voteForProposal:208-242, executeProposal:683) with keys from
``.tensorlink.env``. web3/eth-account are not in this image, so the pieces
web3 would provide are implemented here directly:

- ``keccak256`` — Keccak-f[1600] (Ethereum's pre-standard padding; NOT
  hashlib's sha3_256, which pads differently and yields different digests).
- ``rlp_encode`` — recursive length prefix for legacy transactions.
- secp256k1 ECDSA with RFC-6979 deterministic nonces and EIP-2 low-s
  normalization; EIP-155 replay-protected ``v``.
- 4-byte ABI selectors + static-type argument encoding.
- A urllib JSON-RPC client (eth_chainId / nonce / gasPrice / estimateGas /
  sendRawTransaction / call).

``ChainClient`` composes them: build → sign → submit a legacy transaction.
Submission is *guarded*: every entry point raises :class:`ChainError` on
RPC failure, and the contract manager treats that as "stay off-chain this
round" rather than dying (the reference behaves the same when its RPC is
flaky).

**Validation status**: the wire artifacts (keccak vectors, RLP round-trips,
EIP-155 signature recovery, ABI word layout incl. dynamic types) are pinned
against known vectors and a local fake JSON-RPC node (tests/test_chain.py;
tests/test_torch_chain.py holds this copy byte-equal to the JAX one's).
No transaction has been attempted against a live testnet — treat the
layer as stub-tested until one has.
"""

from __future__ import annotations

import asyncio
import hmac
import hashlib
import http.client
import json
import threading
import urllib.request
from typing import Any, Sequence

from tensorlink_tpu_torch.core.logging import get_logger

log = get_logger("platform.chain")


class ChainError(Exception):
    pass


# ---------------------------------------------------------------------------
# keccak-256 (Ethereum variant)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
# tlint: disable=TL006(Keccak round constants — read-only)
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y]
# tlint: disable=TL006(Keccak rotation offsets — read-only)
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_RATE = 136  # 1088-bit rate for 256-bit output


def _rol(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _M64 if n else v


def _keccak_f(a: list[list[int]]) -> None:
    for rc in _RC:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        a[0][0] ^= rc


def keccak256(data: bytes) -> bytes:
    a = [[0] * 5 for _ in range(5)]
    # pad: 0x01 ... 0x80 (Keccak padding, not SHA-3's 0x06)
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % _RATE:
        padded.append(0x00)
    padded[-1] |= 0x80
    for off in range(0, len(padded), _RATE):
        block = padded[off : off + _RATE]
        for i in range(_RATE // 8):
            lane = int.from_bytes(block[8 * i : 8 * i + 8], "little")
            a[i % 5][i // 5] ^= lane
        _keccak_f(a)
    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes
        out += a[i % 5][i // 5].to_bytes(8, "little")
    return bytes(out)


# ---------------------------------------------------------------------------
# RLP
# ---------------------------------------------------------------------------


def _rlp_int(v: int) -> bytes:
    return b"" if v == 0 else v.to_bytes((v.bit_length() + 7) // 8, "big")


def rlp_encode(item: Any) -> bytes:
    if isinstance(item, int):
        item = _rlp_int(item)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _rlp_len(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        body = b"".join(rlp_encode(x) for x in item)
        return _rlp_len(len(body), 0xC0) + body
    raise TypeError(f"cannot RLP-encode {type(item)}")


def _rlp_len(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = _rlp_int(n)
    return bytes([offset + 55 + len(nb)]) + nb


def rlp_decode(data: bytes) -> Any:
    item, rest = _rlp_decode_one(data)
    if rest:
        raise ValueError("trailing RLP bytes")
    return item


def _rlp_decode_one(d: bytes) -> tuple[Any, bytes]:
    if not d:
        raise ValueError("empty RLP")
    b0 = d[0]
    if b0 < 0x80:
        return d[:1], d[1:]
    if b0 < 0xB8:
        n = b0 - 0x80
        return d[1 : 1 + n], d[1 + n :]
    if b0 < 0xC0:
        ln = b0 - 0xB7
        n = int.from_bytes(d[1 : 1 + ln], "big")
        return d[1 + ln : 1 + ln + n], d[1 + ln + n :]
    if b0 < 0xF8:
        n = b0 - 0xC0
        body, rest = d[1 : 1 + n], d[1 + n :]
    else:
        ln = b0 - 0xF7
        n = int.from_bytes(d[1 : 1 + ln], "big")
        body, rest = d[1 + ln : 1 + ln + n], d[1 + ln + n :]
    items = []
    while body:
        item, body = _rlp_decode_one(body)
        items.append(item)
    return items, rest


# ---------------------------------------------------------------------------
# secp256k1 (sign + verify; RFC-6979 nonces)
# ---------------------------------------------------------------------------

_P = 2**256 - 2**32 - 977
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
_G = (_GX, _GY)


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % _P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1) * _inv(2 * y1, _P) % _P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, _P) % _P
    x3 = (lam * lam - x1 - x2) % _P
    return x3, (lam * (x1 - x3) - y1) % _P


def _ec_mul(k: int, p):
    r = None
    while k:
        if k & 1:
            r = _ec_add(r, p)
        p = _ec_add(p, p)
        k >>= 1
    return r


def pubkey(priv: int) -> tuple[int, int]:
    return _ec_mul(priv, _G)


def priv_to_address(priv: int) -> str:
    x, y = pubkey(priv)
    raw = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return "0x" + keccak256(raw)[12:].hex()


def _rfc6979_k(z: int, priv: int) -> int:
    """Deterministic nonce (RFC 6979, HMAC-SHA256)."""
    zb = z.to_bytes(32, "big")
    xb = priv.to_bytes(32, "big")
    k = b"\x00" * 32
    v = b"\x01" * 32
    k = hmac.new(k, v + b"\x00" + xb + zb, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + xb + zb, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < _N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def ecdsa_sign(msg_hash: bytes, priv: int) -> tuple[int, int, int]:
    """Returns (r, s, recovery_id) with low-s normalization (EIP-2)."""
    z = int.from_bytes(msg_hash, "big")
    while True:
        k = _rfc6979_k(z, priv)
        R = _ec_mul(k, _G)
        r = R[0] % _N
        if r == 0:
            z += 1  # re-derive (astronomically unlikely)
            continue
        s = _inv(k, _N) * (z % _N + r * priv) % _N
        if s == 0:
            z += 1
            continue
        rec = R[1] & 1
        if s > _N // 2:
            s = _N - s
            rec ^= 1
        return r, s, rec


def ecdsa_verify(msg_hash: bytes, r: int, s: int, pub: tuple[int, int]) -> bool:
    if not (1 <= r < _N and 1 <= s < _N):
        return False
    z = int.from_bytes(msg_hash, "big") % _N
    w = _inv(s, _N)
    u1, u2 = z * w % _N, r * w % _N
    pt = _ec_add(_ec_mul(u1, _G), _ec_mul(u2, pub))
    return pt is not None and pt[0] % _N == r


# ---------------------------------------------------------------------------
# ABI
# ---------------------------------------------------------------------------


def selector(fn_sig: str) -> bytes:
    return keccak256(fn_sig.encode())[:4]


def _abi_static_word(t: str, a: Any) -> bytes:
    """One 32-byte word for a static type."""
    if t == "bytes32":
        b = bytes.fromhex(a[2:]) if isinstance(a, str) else bytes(a)
        if len(b) != 32:
            raise ValueError(f"bytes32 arg of length {len(b)}")
        return b
    if t.startswith("uint") or t.startswith("int"):
        v = int(a)
        return (v % (1 << 256)).to_bytes(32, "big")
    if t == "address":
        h = a[2:] if isinstance(a, str) and a.startswith("0x") else a
        return bytes.fromhex(h).rjust(32, b"\x00")
    if t == "bool":
        return int(bool(a)).to_bytes(32, "big")
    raise ValueError(f"unsupported ABI type {t}")


def _abi_is_dynamic(t: str) -> bool:
    return t.endswith("[]") or t in ("bytes", "string")


def _abi_tail(t: str, a: Any) -> bytes:
    """Tail encoding of a dynamic value (length word + padded payload)."""
    if t.endswith("[]"):
        base = t[:-2]
        if _abi_is_dynamic(base):
            raise ValueError(f"nested dynamic ABI type {t} not supported")
        items = list(a)
        return len(items).to_bytes(32, "big") + b"".join(
            _abi_static_word(base, x) for x in items
        )
    if t in ("bytes", "string"):
        b = a.encode() if t == "string" else (
            bytes.fromhex(a[2:]) if isinstance(a, str) else bytes(a)
        )
        pad = (-len(b)) % 32
        return len(b).to_bytes(32, "big") + b + b"\x00" * pad
    raise ValueError(f"unsupported dynamic ABI type {t}")


def abi_encode_args(fn_sig: str, args: Sequence[Any]) -> bytes:
    """Solidity ABI argument encoding with standard head/tail layout:
    static types inline, dynamic types (``T[]`` of static T, ``bytes``,
    ``string``) as head offsets into a shared tail — enough for the full
    Smartnodes surface, including reward claims whose ``bytes32[]`` merkle
    proof arrays the previous static-only encoder could not express
    (reference claim machinery, contract_manager.py:911-1000)."""
    types = fn_sig[fn_sig.index("(") + 1 : fn_sig.rindex(")")]
    type_list = [t for t in types.split(",") if t]
    if len(type_list) != len(args):
        raise ValueError(f"{fn_sig}: {len(args)} args for {len(type_list)} types")
    head_len = 32 * len(type_list)
    heads: list[bytes] = []
    tails: list[bytes] = []
    tail_off = 0
    for t, a in zip(type_list, args):
        if _abi_is_dynamic(t):
            heads.append((head_len + tail_off).to_bytes(32, "big"))
            tail = _abi_tail(t, a)
            tails.append(tail)
            tail_off += len(tail)
        else:
            heads.append(_abi_static_word(t, a))
    return b"".join(heads) + b"".join(tails)


def call_data(fn_sig: str, args: Sequence[Any]) -> bytes:
    return selector(fn_sig) + abi_encode_args(fn_sig, args)


# ---------------------------------------------------------------------------
# JSON-RPC + client
# ---------------------------------------------------------------------------


class JsonRpc:
    # an RPC response larger than this is hostile or broken — a registry
    # view or tx hash is well under 1 KB, and an unbounded read() would let
    # a malicious endpoint exhaust validator memory
    MAX_RESPONSE_BYTES = 1 << 20

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout
        self._id = 0

    def call(self, method: str, params: list | None = None) -> Any:
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "method": method, "params": params or [],
             "id": self._id}
        ).encode()
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                raw = r.read(self.MAX_RESPONSE_BYTES + 1)
                if len(raw) > self.MAX_RESPONSE_BYTES:
                    raise ChainError(
                        f"rpc {method}: response exceeds "
                        f"{self.MAX_RESPONSE_BYTES} bytes"
                    )
                resp = json.loads(raw)
        except ChainError:
            raise
        except (OSError, ValueError, http.client.HTTPException) as e:
            # HTTPException covers hostile non-HTTP banners (BadStatusLine)
            # and truncated chunked bodies (IncompleteRead) — neither is an
            # OSError, and callers catch ChainError to degrade
            raise ChainError(f"rpc {method} failed: {e}") from e
        if not isinstance(resp, dict):
            # a JSON array/string/number here is not a JSON-RPC envelope
            raise ChainError(f"rpc {method}: malformed response envelope")
        if "error" in resp:
            raise ChainError(f"rpc {method}: {resp['error']}")
        return resp.get("result")


class ChainClient:
    """Build, sign (EIP-155 legacy tx), and submit contract calls."""

    def __init__(
        self,
        rpc_url: str,
        contract: str,
        private_key_hex: str,
        *,
        chain_id: int | None = None,
        gas_limit: int = 500_000,
    ):
        self.rpc = JsonRpc(rpc_url)
        self.contract = contract
        self.priv = int(private_key_hex.removeprefix("0x"), 16)
        self.address = priv_to_address(self.priv)
        self._chain_id = chain_id
        self.gas_limit = gas_limit
        # submissions serialize: concurrent transact() calls would fetch
        # the same pending nonce and one tx would be silently replaced
        self._tx_lock = threading.Lock()

    @property
    def chain_id(self) -> int:
        if self._chain_id is None:
            self._chain_id = int(self.rpc.call("eth_chainId"), 16)
        return self._chain_id

    def _sign_tx(
        self, nonce: int, gas_price: int, data: bytes, to: str, value: int = 0
    ) -> bytes:
        to_b = bytes.fromhex(to.removeprefix("0x"))
        base = [nonce, gas_price, self.gas_limit, to_b, value, data]
        signing = rlp_encode(base + [self.chain_id, 0, 0])
        r, s, rec = ecdsa_sign(keccak256(signing), self.priv)
        v = self.chain_id * 2 + 35 + rec
        return rlp_encode(base + [v, r, s])

    def transact(self, fn_sig: str, args: Sequence[Any]) -> str:
        """Submit a state-changing call; returns the tx hash."""
        with self._tx_lock:
            nonce = int(
                self.rpc.call("eth_getTransactionCount", [self.address, "pending"]),
                16,
            )
            gas_price = int(self.rpc.call("eth_gasPrice"), 16)
            raw = self._sign_tx(
                nonce, gas_price, call_data(fn_sig, args), self.contract
            )
            return self.rpc.call("eth_sendRawTransaction", ["0x" + raw.hex()])

    def call_view(self, fn_sig: str, args: Sequence[Any]) -> bytes:
        result = self.rpc.call(
            "eth_call",
            [{"to": self.contract, "data": "0x" + call_data(fn_sig, args).hex()},
             "latest"],
        )
        # normalize EVERY malformed-result shape to ChainError: callers
        # (e.g. the handshake credential gate) catch ChainError to fail
        # CLOSED — an odd-length hex string or a non-string result from a
        # hostile RPC must not escape as ValueError/TypeError and crash
        # the caller instead
        try:
            if result is None:
                return b""
            if not isinstance(result, str) or not result.startswith("0x"):
                raise ValueError(f"non-hex eth_call result: {result!r:.80}")
            return bytes.fromhex(result[2:])
        except (ValueError, TypeError) as e:
            raise ChainError(f"rpc eth_call: malformed result: {e}") from e


class ChainSubmitter:
    """Guarded Smartnodes submission surface used by the contract manager
    (reference contract_manager.py:534 createProposal, :208 voteForProposal,
    :683 executeProposal). Every method degrades to a warning on RPC
    failure — a flaky chain endpoint must not take the validator down."""

    def __init__(self, client: ChainClient):
        self.client = client

    def _submit(self, fn_sig: str, args: Sequence[Any]) -> str | None:
        try:
            txh = self.client.transact(fn_sig, args)
            log.info("chain: %s -> %s", fn_sig.split("(")[0], txh)
            return txh
        except ChainError as e:
            log.warning("chain: %s submission failed: %s", fn_sig, e)
            return None

    def _guarded(self, fn_sig: str, args: Sequence[Any]) -> str | None:
        """Submit without ever blocking an event loop: called from async
        context (the validator's frame handlers / proposal round), the
        blocking HTTP round-trip is offloaded to a worker thread
        fire-and-forget; called synchronously, it submits inline."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return self._submit(fn_sig, args)
        loop.run_in_executor(None, self._submit, fn_sig, args)
        return None

    def submit_proposal(self, prop_hash: str, round_: int) -> str | None:
        return self._guarded(
            "createProposal(bytes32,uint256)", ["0x" + prop_hash, round_]
        )

    def submit_vote(self, prop_hash: str, approve: bool) -> str | None:
        return self._guarded(
            "voteForProposal(bytes32,bool)", ["0x" + prop_hash, approve]
        )

    def execute_proposal(self, round_: int) -> str | None:
        return self._guarded("executeProposal(uint256)", [round_])

    def submit_claim(self, round_: int, claim: dict) -> str | None:
        """Submit a worker's reward claim (reference claim flow,
        contract_manager.py:911-1000: distribution id + capacity + merkle
        proof; the contract recomputes the leaf from ``msg.sender`` and
        folds the proof to the executed round's stored root). ``claim`` is
        ``ContractManager.claim_data``'s dict: the proof's sibling hashes
        ride as ``bytes32[]``, and the leaf index lets the contract derive
        each fold's side (sib = index ^ 1 per level)."""
        proof = ["0x" + h for _side, h in claim["proof"]]
        return self._guarded(
            "claimRewards(uint256,uint256,uint256,bytes32[])",
            [round_, claim["capacity"], claim["index"], proof],
        )


def make_credential_check(client: ChainClient):
    """Handshake Sybil gate backed by the chain registry (reference
    smart_node.py:708-739: ``getValidatorInfo(addr)`` must say active and
    match the peer's key hash). Node ids here ARE sha256(pubkey) hex — a
    natural ``bytes32`` — so the registry views key on the id directly:
    ``isActiveValidator(bytes32)`` / ``isActiveWorker(bytes32)`` return a
    nonzero word for registered nodes. Users are not registry-gated (the
    reference accepts "U" roles without a chain check). A failed RPC
    REJECTS (fail closed, like the reference's contract-query-error path)."""

    def check(node_id: str, role: str) -> bool:
        view = {
            "validator": "isActiveValidator(bytes32)",
            "worker": "isActiveWorker(bytes32)",
        }.get(role)
        if view is None:
            return True
        try:
            out = client.call_view(view, ["0x" + node_id])
        except Exception as e:  # noqa: BLE001 — ANY failure fails closed:
            # a hostile RPC must not find an exception type that slips a
            # peer past the gate (or crashes the handshake loop)
            log.warning("credential check for %s failed: %s", node_id[:12], e)
            return False
        return any(out)

    return check


def from_env(env, *, default_chain_id: int | None = None) -> ChainSubmitter | None:
    """Build the submitter from ``.tensorlink_tpu.env`` — CHAIN_URL,
    CONTRACT_ADDRESS, CHAIN_PRIVATE_KEY (reference keys live in
    .tensorlink.env, contract_manager.py:222). Returns None (with a log
    line) when any piece is missing so ``off_chain=False`` without
    credentials degrades instead of crashing."""
    url = env.get("CHAIN_URL")
    contract = env.get("CONTRACT_ADDRESS")
    key = env.get("CHAIN_PRIVATE_KEY")
    if not (url and contract and key):
        log.warning(
            "on-chain mode requested but CHAIN_URL/CONTRACT_ADDRESS/"
            "CHAIN_PRIVATE_KEY are not all set — continuing off-chain"
        )
        return None
    cid = env.get("CHAIN_ID")
    return ChainSubmitter(
        ChainClient(
            url, contract, key,
            chain_id=int(cid) if cid else default_chain_id,
        )
    )


__all__ = [
    "ChainClient", "ChainError", "ChainSubmitter", "JsonRpc", "abi_encode_args",
    "call_data", "ecdsa_sign", "ecdsa_verify", "from_env", "keccak256",
    "priv_to_address", "pubkey", "rlp_decode", "rlp_encode", "selector",
]
