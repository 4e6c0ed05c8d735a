"""Wire protocol: frame layout and message tags.

Re-specification of the reference's ad-hoc binary protocol (SURVEY.md §2.3).
The reference delimits frames by scanning for a sentinel
(``EOT_CHAR = b"HELLOCHENQUI"``, p2p/connection.py:67) and dispatches on
variable-length ASCII prefixes (p2p/torch_node.py:119-131). Here every frame
is length-prefixed — O(1) boundary detection, arbitrary binary payloads:

    magic "TLNK" | u8 version | u8 kind | u16 tag_len | u64 payload_len
    | tag (ascii) | payload

``kind`` separates control (JSON payload) from bulk (TLTS array payload)
frames so receivers can route big tensors to spill files without parsing.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

MAGIC = b"TLNK"
VERSION = 1
HEADER = struct.Struct("<4sBBHQ")  # magic, version, kind, tag_len, payload_len
HEADER_SIZE = HEADER.size

# frame kinds
CONTROL = 0  # payload is UTF-8 JSON
BULK = 1  # payload is a TLTS blob (core/serialization.py) or raw bytes

# Practical ceiling for a single frame; module shipping above this streams
# through spill files on the receiver (reference spills >20 MB to
# tmp/streamed_data_* files, connection.py:110-122).
MAX_FRAME = 64 << 30
SPILL_THRESHOLD = 32 << 20  # frames larger than this land on disk

# ---------------------------------------------------------------------------
# Message tags. Same *semantics* as the reference's (SURVEY.md §2.3) so the
# job lifecycle and mental model carry over; the encoding does not.
# ---------------------------------------------------------------------------

# p2p substrate
PING = "ping"
PONG = "pong"
HELLO = "hello"  # handshake step 1 (initiator)
CHALLENGE = "challenge"  # handshake step 2 (listener)
PROOF = "proof"  # handshake step 3 (initiator)
WELCOME = "welcome"  # handshake step 4 (listener accepts)
DHT_GET = "dht.get"
DHT_GET_RESP = "dht.get.resp"
DHT_STORE = "dht.store"
DHT_DELETE = "dht.delete"
DHT_SYNC = "dht.sync"  # anti-entropy: digest of replicated keys
DHT_SYNC_RESP = "dht.sync.resp"  # entries the requester is missing
PEERS = "peers"  # bootstrap: list of known validators

# job lifecycle (reference validator_thread.py:150-161, worker_thread.py:128)
JOB_REQ = "job.req"
JOB_ACCEPT = "job.accept"
JOB_DECLINE = "job.decline"
JOB_UPDATE = "job.update"
JOB_SHUTDOWN = "job.shutdown"
JOB_REPAIR = "job.repair"  # user pulls a replacement worker for a dead stage
STATS_REQUEST = "stats.req"
STATS_RESPONSE = "stats.resp"
REQUEST_WORKERS = "workers.req"
WORKERS = "workers.resp"
PROPOSAL = "proposal"  # contract round: full proposal body for validation
PROPOSAL_VOTE = "proposal.vote"
PROOF_REQ = "proof.req"  # monitor pulls a worker's PoL log for a job
PROOF_RESP = "proof.resp"

# tensor-node layer (reference torch_node.py:119-131)
MODULE = "module"  # ship a stage assignment (plan + checkpoint ref)
MODULE_LOADED = "module.loaded"
FORWARD = "fwd"
FORWARD_RESP = "fwd.resp"
BACKWARD = "bwd"
BACKWARD_RESP = "bwd.resp"
GENERATE = "gen"
GENERATE_RESP = "gen.resp"
TOKEN = "token"
STREAM_END = "stream.end"
# user -> worker: confirmed stop-sequence matches for rows of a streamed
# generate; the worker's compiled chunked decode checks these at chunk
# boundaries and stops early instead of running out its token budget
STREAM_CANCEL = "stream.cancel"
# live slot migration (docs/FAILURE_MODEL.md "Migration & drain"):
# validator → worker DRAIN (shed every live serving slot to a destination
# worker, zero dropped streams); worker → worker MIGRATE (probe the
# destination's resident prefix, then ship a frozen slot's KV pages
# byte-exactly as one bulk TLTS frame)
MIGRATE = "mig"
MIGRATE_RESP = "mig.resp"
DRAIN = "drain"
DRAIN_RESP = "drain.resp"
# disaggregated prefill/decode pools (docs/SERVING.md "Disaggregated
# prefill/decode"): validator → prefill-pool worker, fire-and-forget —
# the decode-pool membership [{id, addr}, ...] the worker hands its
# completed prefills to through the MIGRATE export/stage/adopt path
HANDOFF = "handoff"
# fleet serving (docs/SERVING.md "Fleet serving"): validator → replica
# entry worker, fire-and-forget — the sibling-replica membership
# [{id, addr, job_id}, ...] this worker may drain onto when a DRAIN
# arrives with no explicit destination (the autopilot's rolling deploy)
REPLICA_SET = "replica.set"
PARAMS_REQ = "params.req"
PARAMETERS = "params"
OPTIMIZER = "opt"
OPTIMIZER_RESP = "opt.resp"
TRAIN_MODE = "train.mode"
TRAIN_MODE_ACK = "train.mode.ack"
CHECKPOINT = "ckpt"  # save/restore stage params + optimizer state
CHECKPOINT_RESP = "ckpt.resp"


def pack_header(kind: int, tag: str, payload_len: int) -> bytes:
    tag_b = tag.encode("ascii")
    if payload_len > MAX_FRAME:
        raise ValueError(f"frame too large: {payload_len}")
    return HEADER.pack(MAGIC, VERSION, kind, len(tag_b), payload_len) + tag_b


@dataclass(frozen=True)
class FrameHeader:
    kind: int
    tag_len: int
    payload_len: int


def unpack_header(data: bytes) -> FrameHeader:
    magic, version, kind, tag_len, payload_len = HEADER.unpack(data)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if version != VERSION:
        raise ProtocolError(f"unsupported version {version}")
    if payload_len > MAX_FRAME:
        raise ProtocolError(f"oversized frame {payload_len}")
    return FrameHeader(kind, tag_len, payload_len)


class ProtocolError(Exception):
    """Malformed or hostile frame."""


def control(tag: str, body: dict) -> tuple[int, str, bytes]:
    return CONTROL, tag, json.dumps(body, separators=(",", ":")).encode()


def parse_control(payload: bytes | memoryview) -> dict:
    return json.loads(bytes(payload))
