// Native KCP ARQ core — the reliable-UDP state machine of the client edge.
//
// Reference being rebuilt: the reference gate links kcp-go (a native-speed
// Go library) for its KCP listener (components/gate/GateService.go:129-161,
// turbo tuning engine/consts/consts.go:99-106). The Python mirror of this
// state machine lives in goworld_tpu_torch/net/kcp.py (KcpCore) and stays
// the canonical implementation (GOWORLD_TPU_PURE_KCP=1 selects it); this C++ core processes segments off
// the interpreter's hot path for high-session gates. Wire format and
// semantics are identical (skywind3000 KCP, stream mode, nodelay):
//
//   conv u32 | cmd u8 | frg u8 | wnd u16 | ts u32 | sn u32 | una u32
//   | len u32 | data[len]                         (little-endian, 24B)
//
// Time is injected by the caller (now_ms params) so tests control the
// clock exactly like they monkeypatch the Python core's _now_ms.
//
// Built at first use by goworld_tpu_torch/native/__init__.py into
// goworld_tpu_torch/_build/ (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <vector>

namespace {

constexpr int OVERHEAD = 24;
constexpr uint8_t CMD_PUSH = 81, CMD_ACK = 82, CMD_WASK = 83, CMD_WINS = 84;
constexpr int DEAD_LINK = 20;

// Signed serial distance under u32 wrap (kcp-go's _itimediff): every
// sn/una window compare must go through this so a conversation that
// crosses sn 2^32 keeps flowing (and so the Python core's _sn_diff
// arithmetic stays bit-identical).
inline int32_t sn_diff(uint32_t a, uint32_t b) {
    return (int32_t)(a - b);
}

struct Seg {
    uint32_t sn;
    uint32_t ts;
    std::vector<char> data;
    int64_t resendts = 0;
    int64_t rto = 0;
    int fastack = 0;
    int xmit = 0;
};

struct Kcp {
    uint32_t conv;
    int mtu, mss;
    int snd_wnd, rcv_wnd, interval, resend, rx_minrto;

    uint32_t snd_una = 0, snd_nxt = 0, rcv_nxt = 0;
    uint32_t rmt_wnd;

    std::deque<std::vector<char>> snd_queue;
    std::deque<Seg> snd_buf;
    std::map<uint32_t, std::vector<char>> rcv_buf;
    std::deque<std::vector<char>> rcv_queue;
    std::vector<std::pair<uint32_t, uint32_t>> acklist;
    std::deque<std::vector<char>> out_queue;  // datagrams awaiting sendto

    int64_t rx_srtt = 0, rx_rttval = 0, rx_rto = 200;
    bool dead = false;
    bool wins_pending = false;
    bool wask_pending = false;  // liveness probe: WASK elicits a WINS

    Kcp(uint32_t c, int mtu_, int sw, int rw, int iv, int rs, int minrto)
        : conv(c), mtu(mtu_), mss(mtu_ - OVERHEAD), snd_wnd(sw),
          rcv_wnd(rw), interval(iv), resend(rs), rx_minrto(minrto),
          rmt_wnd(rw) {}

    int wnd_unused() const {
        int w = rcv_wnd - (int)rcv_queue.size();
        return w > 0 ? w : 0;
    }

    void update_rtt(int64_t rtt) {
        if (rtt < 0) return;
        if (rx_srtt == 0) {
            rx_srtt = rtt;
            rx_rttval = rtt / 2;
        } else {
            int64_t delta = rtt > rx_srtt ? rtt - rx_srtt : rx_srtt - rtt;
            rx_rttval = (3 * rx_rttval + delta) / 4;
            rx_srtt = (7 * rx_srtt + rtt) / 8;
            if (rx_srtt < 1) rx_srtt = 1;
        }
        int64_t rto = rx_srtt +
            (interval > 4 * rx_rttval ? interval : 4 * rx_rttval);
        rx_rto = rto < rx_minrto ? rx_minrto : (rto > 60000 ? 60000 : rto);
    }

    void parse_una(uint32_t una) {
        while (!snd_buf.empty() && sn_diff(snd_buf.front().sn, una) < 0)
            snd_buf.pop_front();
        snd_una = snd_buf.empty() ? snd_nxt : snd_buf.front().sn;
    }

    void parse_ack(uint32_t sn, uint32_t ts, uint32_t now32) {
        uint32_t rtt = now32 - ts;   // u32 wrap-safe
        if (rtt < 60000) update_rtt((int64_t)rtt);
        for (auto it = snd_buf.begin(); it != snd_buf.end(); ++it) {
            if (it->sn == sn) { snd_buf.erase(it); break; }
            if (sn_diff(it->sn, sn) > 0) break;
        }
        for (auto& seg : snd_buf)
            if (sn_diff(seg.sn, sn) < 0) seg.fastack++;
        snd_una = snd_buf.empty() ? snd_nxt : snd_buf.front().sn;
    }

    void input(const char* p, int n, uint32_t now32) {
        // 64-bit offset math: a crafted len near 2^31 must fail the
        // bounds check, not wrap negative into a wild memcpy
        int64_t off = 0;
        while (off + OVERHEAD <= n) {
            uint32_t c, ts, sn, una, len;
            uint8_t cmd, frg;
            uint16_t wnd;
            std::memcpy(&c, p + off, 4);
            cmd = (uint8_t)p[off + 4];
            frg = (uint8_t)p[off + 5];
            (void)frg;
            std::memcpy(&wnd, p + off + 6, 2);
            std::memcpy(&ts, p + off + 8, 4);
            std::memcpy(&sn, p + off + 12, 4);
            std::memcpy(&una, p + off + 16, 4);
            std::memcpy(&len, p + off + 20, 4);
            off += OVERHEAD;
            if (c != conv || off + (int64_t)len > n) return;
            const char* data = p + off;
            off += len;
            rmt_wnd = wnd;
            parse_una(una);
            if (cmd == CMD_ACK) {
                parse_ack(sn, ts, now32);
            } else if (cmd == CMD_PUSH) {
                int32_t ahead = sn_diff(sn, rcv_nxt);
                if (ahead >= 0 && ahead < rcv_wnd) {
                    acklist.emplace_back(sn, ts);
                    if (!rcv_buf.count(sn))
                        rcv_buf[sn] = std::vector<char>(data, data + len);
                    for (auto it = rcv_buf.find(rcv_nxt);
                         it != rcv_buf.end() && it->first == rcv_nxt;
                         it = rcv_buf.find(rcv_nxt)) {
                        // 0-len PUSH segments (legal on the wire) are
                        // acked but never queued: kcp_recv's 0 return
                        // must unambiguously mean "queue empty"
                        if (!it->second.empty())
                            rcv_queue.push_back(std::move(it->second));
                        rcv_buf.erase(it);
                        rcv_nxt++;  // uint32_t: wraps with the wire
                    }
                } else if (ahead < 0) {
                    acklist.emplace_back(sn, ts);  // re-ack duplicate
                }
            } else if (cmd == CMD_WASK) {
                wins_pending = true;
            }
            // CMD_WINS: header side effects already applied
        }
    }

    std::vector<char>* cur_dgram() {
        if (out_queue.empty() || (int)out_queue.back().size() >= mtu)
            out_queue.emplace_back();
        return &out_queue.back();
    }

    void emit(uint8_t cmd, uint32_t sn, uint32_t ts, uint16_t wnd,
              const char* data, uint32_t len) {
        std::vector<char>* d = cur_dgram();
        if ((int)(d->size() + OVERHEAD + len) > mtu && !d->empty()) {
            out_queue.emplace_back();
            d = &out_queue.back();
        }
        size_t base = d->size();
        d->resize(base + OVERHEAD + len);
        char* w = d->data() + base;
        std::memcpy(w, &conv, 4);
        w[4] = (char)cmd;
        w[5] = 0;
        std::memcpy(w + 6, &wnd, 2);
        std::memcpy(w + 8, &ts, 4);
        std::memcpy(w + 12, &sn, 4);
        std::memcpy(w + 16, &rcv_nxt, 4);
        std::memcpy(w + 20, &len, 4);
        if (len) std::memcpy(w + OVERHEAD, data, len);
    }

    void flush(int64_t now) {
        uint32_t now32 = (uint32_t)now;
        uint16_t wnd = (uint16_t)wnd_unused();
        for (auto& a : acklist) emit(CMD_ACK, a.first, a.second, wnd,
                                     nullptr, 0);
        acklist.clear();
        if (wins_pending) {
            emit(CMD_WINS, 0, now32, wnd, nullptr, 0);
            wins_pending = false;
        }
        if (wask_pending) {
            emit(CMD_WASK, 0, now32, wnd, nullptr, 0);
            wask_pending = false;
        }
        uint32_t cwnd = (uint32_t)snd_wnd;
        uint32_t rw = rmt_wnd > 0 ? rmt_wnd : 1;
        if (rw < cwnd) cwnd = rw;
        while (!snd_queue.empty() && sn_diff(snd_nxt, snd_una + cwnd) < 0) {
            Seg s;
            s.sn = snd_nxt++;
            s.data = std::move(snd_queue.front());
            snd_queue.pop_front();
            snd_buf.push_back(std::move(s));
        }
        for (auto& seg : snd_buf) {
            bool need = false;
            if (seg.xmit == 0) {
                need = true;
                seg.rto = rx_rto;
                seg.resendts = now + seg.rto;
            } else if (seg.fastack >= resend) {
                need = true;
                seg.fastack = 0;
                seg.resendts = now + seg.rto;
            } else if (now >= seg.resendts) {
                need = true;
                seg.rto += seg.rto / 2;           // nodelay backoff
                seg.resendts = now + seg.rto;
            }
            if (need) {
                seg.xmit++;
                seg.ts = now32;
                if (seg.xmit >= DEAD_LINK) dead = true;
                emit(CMD_PUSH, seg.sn, now32, wnd, seg.data.data(),
                     (uint32_t)seg.data.size());
            }
        }
    }
};

}  // namespace

extern "C" {

void* kcp_create(uint32_t conv, int mtu, int snd_wnd, int rcv_wnd,
                 int interval, int resend, int minrto) {
    return new Kcp(conv, mtu, snd_wnd, rcv_wnd, interval, resend, minrto);
}

void kcp_free(void* k) { delete (Kcp*)k; }

void kcp_send(void* k, const char* data, int len) {
    Kcp* kc = (Kcp*)k;
    for (int off = 0; off < len; off += kc->mss) {
        int n = len - off < kc->mss ? len - off : kc->mss;
        kc->snd_queue.emplace_back(data + off, data + off + n);
    }
}

void kcp_input(void* k, const char* dgram, int len, int64_t now_ms) {
    ((Kcp*)k)->input(dgram, len, (uint32_t)now_ms);
}

// Pop the next reassembled in-order chunk into buf; returns its length,
// 0 when empty, -1 when cap is too small (chunk stays queued).
int kcp_recv(void* k, char* buf, int cap) {
    Kcp* kc = (Kcp*)k;
    if (kc->rcv_queue.empty()) return 0;
    std::vector<char>& c = kc->rcv_queue.front();
    if ((int)c.size() > cap) return -1;
    int n = (int)c.size();
    std::memcpy(buf, c.data(), n);
    kc->rcv_queue.pop_front();
    return n;
}

void kcp_flush(void* k, int64_t now_ms) { ((Kcp*)k)->flush(now_ms); }

// Pop the next outgoing datagram; same return contract as kcp_recv.
int kcp_drain_out(void* k, char* buf, int cap) {
    Kcp* kc = (Kcp*)k;
    if (kc->out_queue.empty()) return 0;
    std::vector<char>& d = kc->out_queue.front();
    if (d.empty()) { kc->out_queue.pop_front(); return 0; }
    if ((int)d.size() > cap) return -1;
    int n = (int)d.size();
    std::memcpy(buf, d.data(), n);
    kc->out_queue.pop_front();
    return n;
}

int kcp_unsent(void* k) {
    Kcp* kc = (Kcp*)k;
    return (int)(kc->snd_queue.size() + kc->snd_buf.size());
}

int kcp_dead(void* k) { return ((Kcp*)k)->dead ? 1 : 0; }

void kcp_announce(void* k, int64_t now_ms) {
    Kcp* kc = (Kcp*)k;
    kc->emit(CMD_WINS, 0, (uint32_t)now_ms,
             (uint16_t)kc->wnd_unused(), nullptr, 0);
}

// Queue a WASK (window probe) for the next flush. The peer answers with
// a WINS, so this doubles as a liveness probe for idle-session reaping
// (KcpServer): a silent-but-alive peer refreshes last_heard, a dead one
// does not.
void kcp_probe(void* k) { ((Kcp*)k)->wask_pending = true; }

// TEST HOOK: preset the serial counters so u32-wrap behavior can be
// exercised without pushing 2^32 segments (tests/test_torch_kcp.py).
void kcp_test_set_serials(void* k, uint32_t snd_nxt, uint32_t snd_una,
                          uint32_t rcv_nxt) {
    Kcp* kc = (Kcp*)k;
    kc->snd_nxt = snd_nxt;
    kc->snd_una = snd_una;
    kc->rcv_nxt = rcv_nxt;
}

}  // extern "C"
