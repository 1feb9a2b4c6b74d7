"""Message-type space and typed pack/unpack helpers.

Reference being rebuilt: ``engine/proto/proto.go:12-152`` (MsgType enum with
routing ranges) and ``engine/proto/GoWorldConnection.go`` (one typed send
function per message). Ranges keep the reference's routing trick:

* 1..999      — dispatcher-routed server messages
* 1000..1499  — dispatcher/gate *redirect* range: the gate forwards these
                straight to the owning client proxy without decoding
* 1500..1999  — gate-service messages (handled by the gate itself)
* 2000+       — client-direct (heartbeat)

Position/yaw sync records are fixed 32-byte binary: 16B entity id +
4×f32 x,y,z,yaw (reference ``proto.go:122-149``; downstream records add a
16B client id prefix at the gate hop). Batch encode/decode lives in
:mod:`goworld_tpu_torch.net.codec`.
"""

from __future__ import annotations

from goworld_tpu_torch.net.packet import Packet, new_packet

# --- dispatcher-routed (1-999) -----------------------------------------
MT_INVALID = 0
MT_SET_GAME_ID = 1           # game -> dispatcher handshake
MT_SET_GATE_ID = 2           # gate -> dispatcher handshake
MT_SET_GAME_ID_ACK = 3
MT_NOTIFY_CREATE_ENTITY = 4
MT_NOTIFY_DESTROY_ENTITY = 5
MT_DECLARE_SERVICE = 6
MT_UNDECLARE_SERVICE = 7
MT_CALL_ENTITY_METHOD = 8
MT_CREATE_ENTITY_ANYWHERE = 9
MT_LOAD_ENTITY_ANYWHERE = 10
MT_NOTIFY_CLIENT_CONNECTED = 11
MT_NOTIFY_CLIENT_DISCONNECTED = 12
MT_CALL_ENTITY_METHOD_FROM_CLIENT = 13
MT_SYNC_POSITION_YAW_FROM_CLIENT = 14  # batched 32B records
MT_NOTIFY_ALL_GAMES_CONNECTED = 15
MT_NOTIFY_GATE_DISCONNECTED = 16
MT_START_FREEZE_GAME = 17
MT_START_FREEZE_GAME_ACK = 18
MT_NOTIFY_GAME_CONNECTED = 19
MT_NOTIFY_GAME_DISCONNECTED = 20
MT_NOTIFY_DEPLOYMENT_READY = 21
MT_GAME_LBC_INFO = 22
MT_KVREG_REGISTER = 23
MT_QUERY_SPACE_GAMEID_FOR_MIGRATE = 24
MT_QUERY_SPACE_GAMEID_FOR_MIGRATE_ACK = 25
MT_MIGRATE_REQUEST = 26
MT_MIGRATE_REQUEST_ACK = 27
MT_REAL_MIGRATE = 28
MT_CANCEL_MIGRATE = 29
MT_CALL_NIL_SPACES = 30
MT_GAME_READY = 31
# hot-standby replication leg (goworld_tpu/replication/): both lead
# with the TARGET game id so the dispatcher forwards verbatim without
# decoding the body (the create-anywhere idiom)
MT_REPLICATION_SUBSCRIBE = 32   # standby -> primary: attach / resync
MT_REPLICATION_FRAME = 33       # primary -> standby: one stream frame

# --- redirect range (1000-1499): forwarded verbatim to the client -------
MT_REDIRECT_TO_GATEPROXY_MSG_TYPE_START = 1000
MT_CREATE_ENTITY_ON_CLIENT = 1001
MT_DESTROY_ENTITY_ON_CLIENT = 1002
MT_CALL_ENTITY_METHOD_ON_CLIENT = 1003
MT_UPDATE_POSITION_ON_CLIENT = 1004
MT_UPDATE_YAW_ON_CLIENT = 1005
MT_NOTIFY_ATTR_CHANGE_ON_CLIENT = 1006
MT_NOTIFY_ATTR_DEL_ON_CLIENT = 1007
MT_CLEAR_CLIENT_FILTER_PROP = 1008
MT_REDIRECT_TO_GATEPROXY_MSG_TYPE_STOP = 1499

# --- gate-service range (1500-1999) -------------------------------------
MT_GATE_SERVICE_MSG_TYPE_START = 1500
MT_SET_CLIENT_FILTER_PROP = 1501
MT_CALL_FILTERED_CLIENTS = 1502
MT_SYNC_POSITION_YAW_ON_CLIENTS = 1503  # batched [16B cid + 32B record]
# ordered per-tick bundle of redirect-range client messages, one packet
# per gate per tick (the batched shape of the reference's per-message
# gate relay, GateService.go:258-306): the game coalesces every
# create/destroy/attr/rpc client message it would have sent as its own
# dispatcher packet; the gate unbundles and relays each record to its
# client EXACTLY as the per-message path does, so the client wire is
# unchanged. Cuts game->dispatcher->gate framing from
# O(client messages) to O(gates) per tick (churn-heavy AOI ticks emit
# thousands — docs/R5_MEASUREMENTS.md).
MT_CLIENT_EVENTS_BATCH = 1504
# delta-compressed sync fan-out ([gameN] sync_delta): same
# game -> gate leg as 1503, payload = net/codec.py DeltaSyncEncoder
# wire format ([u8 kind][u32 handle][4 x i16] deltas against in-band
# keyframed baselines) — steady-state bytes scale with
# dirty_frac * 13 B/record instead of 48 B/record
MT_SYNC_POSITION_YAW_DELTA_ON_CLIENTS = 1505
MT_GATE_SERVICE_MSG_TYPE_STOP = 1999

# --- client-direct (2000+) ----------------------------------------------
MT_HEARTBEAT = 2001
MT_CLIENT_SYNC_POSITION_YAW = 2002  # single 32B record, client -> gate

SYNC_RECORD_SIZE = 32          # 16B eid + x,y,z,yaw f32
CLIENT_SYNC_RECORD_SIZE = 48   # 16B cid + 32B record (gate -> client leg)

# filter-clients ops (reference proto.go:128-137)
FILTER_EQ, FILTER_NE, FILTER_GT, FILTER_LT, FILTER_GTE, FILTER_LTE = range(6)
_FILTER_OPS = {"=": FILTER_EQ, "!=": FILTER_NE, ">": FILTER_GT,
               "<": FILTER_LT, ">=": FILTER_GTE, "<=": FILTER_LTE}


def filter_op_code(op: str) -> int:
    return _FILTER_OPS[op]


# ------------------------------------------------------------------------
# typed constructors (reference GoWorldConnection.go one-per-message style;
# we keep one helper per message so call sites never hand-pack fields)
# ------------------------------------------------------------------------
def pack_set_game_id(game_id: int, is_reconnect: bool, is_restore: bool,
                     ban_boot: bool, entity_ids: list[str]) -> Packet:
    p = new_packet(MT_SET_GAME_ID)
    p.append_u16(game_id)
    p.append_bool(is_reconnect)
    p.append_bool(is_restore)
    p.append_bool(ban_boot)
    p.append_data(entity_ids)
    return p


def pack_set_gate_id(gate_id: int) -> Packet:
    p = new_packet(MT_SET_GATE_ID)
    p.append_u16(gate_id)
    return p


def pack_call_entity_method(eid: str, method: str, args: tuple,
                            from_client: str | None = None) -> Packet:
    mt = (MT_CALL_ENTITY_METHOD_FROM_CLIENT if from_client
          else MT_CALL_ENTITY_METHOD)
    p = new_packet(mt)
    p.append_entity_id(eid)
    if from_client:
        p.append_entity_id(from_client)
    p.append_var_str(method)
    p.append_args(args)
    return p


def pack_create_entity_anywhere(type_name: str, attrs: dict,
                                eid: str = "", gameid: int = 0) -> Packet:
    """gameid 0 = dispatcher chooses (min-load heap); nonzero pins the
    target game (reference CreateEntityOnGame / CreateSpaceOnGame,
    goworld.go:67,83)."""
    p = new_packet(MT_CREATE_ENTITY_ANYWHERE)
    p.append_u16(gameid)
    p.append_var_str(type_name)
    p.append_var_str(eid)
    p.append_data(attrs)
    return p


def pack_load_entity_anywhere(type_name: str, eid: str,
                              gameid: int = 0) -> Packet:
    """gameid 0 = dispatcher chooses (reference LoadEntityOnGame when
    nonzero, goworld.go:94)."""
    p = new_packet(MT_LOAD_ENTITY_ANYWHERE)
    p.append_u16(gameid)
    p.append_var_str(type_name)
    p.append_entity_id(eid)
    return p


def pack_notify_client_connected(boot_eid: str, client_id: str,
                                 gate_id: int) -> Packet:
    p = new_packet(MT_NOTIFY_CLIENT_CONNECTED)
    p.append_entity_id(boot_eid)
    p.append_entity_id(client_id)
    p.append_u16(gate_id)
    return p


def pack_notify_client_disconnected(client_id: str, owner_eid: str) -> Packet:
    p = new_packet(MT_NOTIFY_CLIENT_DISCONNECTED)
    p.append_entity_id(client_id)
    p.append_var_str(owner_eid)  # may be empty
    return p


def pack_create_entity_on_client(gate_id: int, client_id: str, eid: str,
                                 type_name: str, is_player: bool,
                                 attrs: dict, pos, yaw: float) -> Packet:
    p = new_packet(MT_CREATE_ENTITY_ON_CLIENT)
    p.append_u16(gate_id)
    p.append_entity_id(client_id)
    p.append_entity_id(eid)
    p.append_var_str(type_name)
    p.append_bool(is_player)
    p.append_f32(pos[0]); p.append_f32(pos[1]); p.append_f32(pos[2])
    p.append_f32(yaw)
    p.append_data(attrs)
    return p


def pack_destroy_entity_on_client(gate_id: int, client_id: str,
                                  eid: str, is_player: bool) -> Packet:
    p = new_packet(MT_DESTROY_ENTITY_ON_CLIENT)
    p.append_u16(gate_id)
    p.append_entity_id(client_id)
    p.append_entity_id(eid)
    p.append_bool(is_player)
    return p


def pack_client_events_batch(gate_id: int,
                             records: list[tuple[int, bytes]]) -> Packet:
    """One per-gate bundle of redirect-range client messages:
    ``[u16 gate_id][u32 n]`` then n x ``[u16 inner_msgtype][u32 len]
    [len bytes]`` where the bytes are the inner message's payload
    starting at the 16-byte client id (i.e. the per-message packet
    minus its msgtype and gate_id prefix — byte-identical to what the
    gate's per-message relay reads)."""
    p = new_packet(MT_CLIENT_EVENTS_BATCH)
    p.append_u16(gate_id)
    p.append_u32(len(records))
    for mt, body in records:
        p.append_u16(mt)
        p.append_u32(len(body))
        p.append_bytes(body)
    return p


def pack_call_entity_method_on_client(gate_id: int, client_id: str, eid: str,
                                      method: str, args: tuple) -> Packet:
    p = new_packet(MT_CALL_ENTITY_METHOD_ON_CLIENT)
    p.append_u16(gate_id)
    p.append_entity_id(client_id)
    p.append_entity_id(eid)
    p.append_var_str(method)
    p.append_args(args)
    return p


def pack_notify_attr_change_on_client(gate_id: int, client_id: str, eid: str,
                                      deltas: list[dict]) -> Packet:
    p = new_packet(MT_NOTIFY_ATTR_CHANGE_ON_CLIENT)
    p.append_u16(gate_id)
    p.append_entity_id(client_id)
    p.append_entity_id(eid)
    p.append_data(deltas)
    return p


def pack_set_client_filter_prop(gate_id: int, client_id: str,
                                key: str, val: str) -> Packet:
    p = new_packet(MT_SET_CLIENT_FILTER_PROP)
    p.append_u16(gate_id)
    p.append_entity_id(client_id)
    p.append_var_str(key)
    p.append_var_str(val)
    return p


def pack_call_filtered_clients(key: str, op: str, val: str,
                               eid: str, method: str, args: tuple) -> Packet:
    p = new_packet(MT_CALL_FILTERED_CLIENTS)
    p.append_u8(filter_op_code(op))
    p.append_var_str(key)
    p.append_var_str(val)
    p.append_var_str(eid)  # may be empty for non-entity broadcasts
    p.append_var_str(method)
    p.append_args(args)
    return p


def pack_kvreg_register(key: str, val: str, force: bool) -> Packet:
    p = new_packet(MT_KVREG_REGISTER)
    p.append_var_str(key)
    p.append_var_str(val)
    p.append_bool(force)
    return p


def pack_replication_subscribe(primary_gid: int, standby_gid: int) -> Packet:
    """Standby -> (dispatcher) -> primary: attach to the replication
    stream, or request a keyframe resync after a torn stream. Leading
    u16 is the ROUTING target (the primary)."""
    p = new_packet(MT_REPLICATION_SUBSCRIBE)
    p.append_u16(primary_gid)
    p.append_u16(standby_gid)
    return p


def pack_replication_frame(standby_gid: int, primary_gid: int,
                           frame: bytes) -> Packet:
    """Primary -> (dispatcher) -> standby: one framed stream record
    (goworld_tpu/replication/frames.py wire format, opaque here).
    Leading u16 is the ROUTING target (the standby)."""
    p = new_packet(MT_REPLICATION_FRAME)
    p.append_u16(standby_gid)
    p.append_u16(primary_gid)
    p.append_u32(len(frame))
    p.append_bytes(frame)
    return p


def pack_game_lbc_info(cpu_percent: float) -> Packet:
    p = new_packet(MT_GAME_LBC_INFO)
    p.append_f32(cpu_percent)
    return p


def pack_query_space_gameid(space_id: str, eid: str) -> Packet:
    p = new_packet(MT_QUERY_SPACE_GAMEID_FOR_MIGRATE)
    p.append_entity_id(space_id)
    p.append_entity_id(eid)
    return p


def pack_migrate_request(eid: str, space_id: str, space_game: int) -> Packet:
    p = new_packet(MT_MIGRATE_REQUEST)
    p.append_entity_id(eid)
    p.append_entity_id(space_id)
    p.append_u16(space_game)
    return p


def pack_real_migrate(eid: str, target_game: int, data: dict) -> Packet:
    p = new_packet(MT_REAL_MIGRATE)
    p.append_entity_id(eid)
    p.append_u16(target_game)
    p.append_data(data)
    return p


def pack_cancel_migrate(eid: str) -> Packet:
    p = new_packet(MT_CANCEL_MIGRATE)
    p.append_entity_id(eid)
    return p


def pack_call_nil_spaces(method: str, args: tuple) -> Packet:
    p = new_packet(MT_CALL_NIL_SPACES)
    p.append_var_str(method)
    p.append_args(args)
    return p
