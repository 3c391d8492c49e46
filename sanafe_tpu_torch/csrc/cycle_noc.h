// Cycle-accurate concentrated-mesh NoC model for the "cycle" timing tier.
//
// The reference delegates this tier to a modified Booksim2 built with a
// fixed configuration (src/schedule.hpp:228-255): cmesh topology with
// x*y routers, c cores concentrated per router, DOR routing, one virtual
// channel with 8-flit input buffers, iSLIP allocation (1 iteration),
// single-flit packets, 1 ns clock, 1-cycle VC + 1-cycle switch allocation.
// This is an independent flit-level implementation of that router
// microarchitecture (not a Booksim port): input-buffered routers with
// round-robin output arbitration, credit-based backpressure, serialized
// per-core injection (generation delays) and ejection (processing delays).
//
// Semantics per timestep (schedule_messages_timestep_cycle,
// src/schedule.cpp:104-167): every message of the timestep is injected as
// one packet; placeholder messages only occupy their source core's
// generation pipeline; the returned simulated time is the cycle at which
// the last packet finished processing, plus the global sync delay.

#pragma once

#include <algorithm>
#include <cstdint>
#include <deque>
#include <vector>

namespace cycle_noc {

struct Params {
    int width = 8;        // routers in x
    int height = 4;       // routers in y
    int cores_per_router = 4;
    int buffer_size = 8;  // input-buffer depth (flits)
    // cycles per router traversal: VC alloc (1) + switch alloc (1)
    int router_delay = 2;
    int link_delay = 1;
    // Physical subnetwork copies (booksim.config `subnets = 2`, the
    // NanoMesh/Loihi dual-channel NoC): each subnet is an independent set
    // of routers/links/buffers; injection (source generation pipeline) and
    // ejection (destination core processing) stay shared, since cores are
    // physical. The fork's subnet-assignment policy lives inside its
    // modified Booksim and is not public; stock Booksim2 assigns untyped
    // traffic uniformly at random (trafficmanager.cpp RandomInt(_subnets-1)),
    // so this model uses the deterministic analog: per-source round-robin
    // across subnets, which reproduces the uniform split without RNG state.
    // Remaining uncertainty (documented in PARITY.md): the fork's exact
    // per-packet assignment and any subnet-aware arbitration internals.
    int subnets = 1;
    double clock_period = 1.0e-9;  // seconds per cycle
};

struct Packet {
    int32_t src_router;  // x * height + y
    int32_t dest_router;
    int32_t src_core;    // global core id (for injection ordering)
    int32_t dest_core;
    int64_t ready_cycle;       // generation complete at the source
    int64_t proc_cycles;       // ejection processing time at the dest
    int64_t done_cycle = -1;   // filled by run()
    int32_t subnet = 0;        // physical subnetwork (assigned by run())
};

// One flit in flight inside the network.
struct Flit {
    int32_t packet;      // index into packets
    int64_t arrive;      // cycle it entered the current buffer
};

class Network {
  public:
    Network(const Params &params, int n_cores)
        : p_(params),
          n_routers_(params.width * params.height),
          ports_per_router_(4 + params.cores_per_router),
          buffers_(static_cast<size_t>(std::max(params.subnets, 1)) *
                   n_routers_ * ports_per_router_),
          arb_pointer_(static_cast<size_t>(std::max(params.subnets, 1)) *
                           n_routers_ * ports_per_router_,
                       0),
          core_free_(n_cores, 0) {
        if (p_.subnets < 1) p_.subnets = 1;
    }

    // Run all packets to completion; returns the cycle at which the last
    // packet's destination processing completes. Packets must be grouped by
    // source core in injection order.
    int64_t run(std::vector<Packet> &packets) {
        // Per-source-core injection queues (in order).
        struct Source {
            std::vector<int32_t> queue;
            size_t head = 0;
        };
        std::vector<Source> sources;
        {
            // group by src_core preserving order
            std::vector<int32_t> order(packets.size());
            for (size_t i = 0; i < packets.size(); ++i) {
                order[i] = static_cast<int32_t>(i);
            }
            std::stable_sort(order.begin(), order.end(),
                             [&](int32_t a, int32_t b) {
                                 return packets[a].src_core <
                                        packets[b].src_core;
                             });
            Source current;
            int32_t current_core = -1;
            for (int32_t idx : order) {
                if (packets[idx].src_core != current_core) {
                    if (!current.queue.empty()) {
                        sources.push_back(std::move(current));
                        current = Source{};
                    }
                    current_core = packets[idx].src_core;
                }
                current.queue.push_back(idx);
            }
            if (!current.queue.empty()) sources.push_back(std::move(current));
        }

        // Subnet assignment: per-source round-robin over routed (non-
        // placeholder) packets — the deterministic analog of stock
        // Booksim2's uniform-random subnet pick for untyped traffic (see
        // Params::subnets). Placeholders never enter the network.
        if (p_.subnets > 1) {
            for (auto &src : sources) {
                int32_t next_subnet = 0;
                for (int32_t idx : src.queue) {
                    if (packets[idx].dest_router < 0) continue;
                    packets[idx].subnet = next_subnet;
                    next_subnet = (next_subnet + 1) % p_.subnets;
                }
            }
        }

        int64_t cycle = 0;
        int64_t last_done = 0;
        size_t in_flight = 0;
        size_t remaining = packets.size();
        const int64_t kIdleJump = 1;
        (void)kIdleJump;

        while (remaining > 0) {
            bool progressed = false;

            // 1. Injection: each source core offers its head packet once its
            //    generation completed and the local input buffer has space.
            for (auto &src : sources) {
                if (src.head >= src.queue.size()) continue;
                const int32_t pkt_idx = src.queue[src.head];
                Packet &pkt = packets[pkt_idx];
                if (pkt.ready_cycle > cycle) continue;
                if (pkt.dest_router < 0) {
                    // placeholder: occupies generation only
                    pkt.done_cycle = pkt.ready_cycle;
                    last_done = std::max(last_done, pkt.done_cycle);
                    ++src.head;
                    --remaining;
                    progressed = true;
                    continue;
                }
                const int local_port =
                    4 + (pkt.src_core % p_.cores_per_router);
                auto &buffer =
                    buffer_at(pkt.subnet, pkt.src_router, local_port);
                if (static_cast<int>(buffer.size()) >= p_.buffer_size) {
                    continue;  // backpressure at injection
                }
                buffer.push_back(Flit{pkt_idx, cycle});
                ++src.head;
                ++in_flight;
                progressed = true;
            }

            // 2. Switch allocation: every output port arbitrates round-robin
            //    among input ports whose head flit requests it (iSLIP with
            //    one iteration over a single VC reduces to round-robin
            //    output arbitration of head flits).
            struct Move {
                int32_t subnet, router, in_port;
                int32_t dest_router, dest_port;  // dest_port -1 => eject
                int32_t pkt;
            };
            std::vector<Move> moves;
            for (int32_t sub = 0; sub < p_.subnets; ++sub) {
            for (int32_t router = 0; router < n_routers_; ++router) {
                // collect head-flit requests per output
                // outputs: 0..3 = N/E/S/W link, 4.. = local ejection ports
                for (int out = 0; out < ports_per_router_; ++out) {
                    int32_t chosen_in = -1;
                    const size_t key =
                        (static_cast<size_t>(sub) * n_routers_ + router) *
                            ports_per_router_ +
                        out;
                    int pointer = arb_pointer_[key];
                    for (int probe = 0; probe < ports_per_router_; ++probe) {
                        const int in =
                            (pointer + probe) % ports_per_router_;
                        auto &buffer = buffer_at(sub, router, in);
                        if (buffer.empty()) continue;
                        const Flit &flit = buffer.front();
                        // router pipeline latency before a flit is eligible
                        if (cycle - flit.arrive < p_.router_delay) continue;
                        if (route_output(router, packets[flit.packet]) !=
                            out) {
                            continue;
                        }
                        chosen_in = in;
                        break;
                    }
                    if (chosen_in < 0) continue;
                    const Flit flit =
                        buffer_at(sub, router, chosen_in).front();
                    const Packet &pkt = packets[flit.packet];
                    if (out >= 4) {
                        // ejection: dest core must be free to accept (the
                        // core is PHYSICAL and shared across subnets)
                        if (core_free_[pkt.dest_core] > cycle) continue;
                        moves.push_back(Move{sub, router, chosen_in, -1, -1,
                                             flit.packet});
                    } else {
                        // link traversal: next router input buffer needs a
                        // credit (space)
                        const int32_t next = neighbor(router, out);
                        const int in_port = opposite(out);
                        auto &next_buffer = buffer_at(sub, next, in_port);
                        if (static_cast<int>(next_buffer.size()) >=
                            p_.buffer_size) {
                            continue;
                        }
                        moves.push_back(Move{sub, router, chosen_in, next,
                                             in_port, flit.packet});
                    }
                    arb_pointer_[key] =
                        (chosen_in + 1) % ports_per_router_;
                }
            }
            }

            // 3. Commit moves (all decided on this cycle's state; subnet 0
            //    commits first, so cross-subnet ejection ties to the same
            //    core resolve deterministically).
            for (const Move &move : moves) {
                auto &buffer =
                    buffer_at(move.subnet, move.router, move.in_port);
                const Flit flit = buffer.front();
                buffer.pop_front();
                Packet &pkt = packets[flit.packet];
                if (move.dest_router < 0) {
                    // ejected: serialize processing at the dest core
                    const int64_t start =
                        std::max(cycle + 1, core_free_[pkt.dest_core]);
                    core_free_[pkt.dest_core] = start + pkt.proc_cycles;
                    pkt.done_cycle = start + pkt.proc_cycles;
                    last_done = std::max(last_done, pkt.done_cycle);
                    --in_flight;
                    --remaining;
                } else {
                    buffer_at(move.subnet, move.dest_router, move.dest_port)
                        .push_back(Flit{flit.packet,
                                        cycle + p_.link_delay});
                }
                progressed = true;
            }

            if (progressed || in_flight > 0) {
                ++cycle;
            } else {
                // idle: jump to the next injection-ready cycle
                int64_t next_ready = INT64_MAX;
                for (auto &src : sources) {
                    if (src.head < src.queue.size()) {
                        next_ready = std::min(
                            next_ready,
                            packets[src.queue[src.head]].ready_cycle);
                    }
                }
                if (next_ready == INT64_MAX) break;  // nothing left
                cycle = std::max(cycle + 1, next_ready);
            }
            // safety valve against pathological livelock
            if (cycle > (1LL << 40)) break;
        }
        return last_done;
    }

  private:
    std::deque<Flit> &buffer_at(int32_t subnet, int32_t router, int port) {
        return buffers_[(static_cast<size_t>(subnet) * n_routers_ + router) *
                            ports_per_router_ +
                        port];
    }

    // DOR (x then y) output port for a packet at `router`.
    int route_output(int32_t router, const Packet &pkt) const {
        const int x = router / p_.height;
        const int y = router % p_.height;
        const int dx = pkt.dest_router / p_.height;
        const int dy = pkt.dest_router % p_.height;
        if (x < dx) return 1;  // east
        if (x > dx) return 3;  // west
        if (y < dy) return 0;  // north
        if (y > dy) return 2;  // south
        return 4 + (pkt.dest_core % p_.cores_per_router);  // eject
    }

    int32_t neighbor(int32_t router, int out) const {
        const int x = router / p_.height;
        const int y = router % p_.height;
        switch (out) {
            case 0: return router + 1;              // north: y+1
            case 1: return router + p_.height;      // east: x+1
            case 2: return router - 1;              // south: y-1
            case 3: return router - p_.height;      // west: x-1
        }
        (void)x;
        (void)y;
        return router;
    }

    static int opposite(int out) {
        switch (out) {
            case 0: return 2;
            case 1: return 3;
            case 2: return 0;
            case 3: return 1;
        }
        return out;
    }

    Params p_;
    int32_t n_routers_;
    int ports_per_router_;
    std::vector<std::deque<Flit>> buffers_;
    std::vector<int> arb_pointer_;
    std::vector<int64_t> core_free_;
};

}  // namespace cycle_noc
