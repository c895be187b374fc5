// Copied from native/resp_native.cpp:1-264 (comments reworded).
//
// Native host-side runtime of respmon_tpu_torch: the native pieces of the
// camera -> device feed, where decode threads push frames and the consumer
// pops the freshest one and uploads it.
//
//   - a lock-free single-producer/single-consumer frame ring buffer with
//     monotonically increasing sequence numbers (drop-oldest semantics, so
//     a slow consumer always sees the freshest frame, like a live camera),
//   - fused BGR(u8) -> grayscale(f32 in [0,1]) conversion with OpenCV's
//     integer-rounded BT.601 coefficients (cvtColor parity), written as a
//     flat loop the compiler auto-vectorizes,
//   - u8 -> f32 [0,1] grayscale conversion for pre-gray sources,
//   - the fleet's freshest-frame collection across many rings into one
//     contiguous batch.
//
// Built by the host C++ compiler as a plain shared library (no pybind11 --
// ctypes binds it; see respmon_tpu_torch/io/native.py and ops/_build.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// Color conversion
// ---------------------------------------------------------------------------

// Byte -> [0,1] float on the CANONICAL conversion chain (reference
// transforms.py:20-23 under numpy promotion: f64 multiply, then the
// monitor's f32 cast — io/capture.py:52-53).  A plain f32 reciprocal
// multiply is 1 ULP off on 126 of the 256 bytes; the 256-entry LUT holds
// the exactly-converted values and is L1-resident.
struct U8ToUnitLut {
    float v[256];
    U8ToUnitLut() {
        for (int i = 0; i < 256; ++i)
            v[i] = static_cast<float>(static_cast<double>(i) * (1.0 / 255.0));
    }
};
static const U8ToUnitLut kU8Unit;

// cv2.cvtColor BGR2GRAY uses fixed-point BT.601 at shift 15 (coefficients
// sum to 1<<15; verified exhaustively over all 2^24 BGR values against the
// deployed cv2 build):
//   y = (9798*R + 19235*G + 3735*B + (1<<14)) >> 15
void bgr_u8_to_gray_f32(const uint8_t* bgr, float* out, int64_t n_pixels) {
    for (int64_t i = 0; i < n_pixels; ++i) {
        const uint32_t b = bgr[3 * i + 0];
        const uint32_t g = bgr[3 * i + 1];
        const uint32_t r = bgr[3 * i + 2];
        const uint32_t y = (9798u * r + 19235u * g + 3735u * b + 16384u) >> 15;
        out[i] = kU8Unit.v[y];
    }
}

void gray_u8_to_f32(const uint8_t* gray, float* out, int64_t n_pixels) {
    for (int64_t i = 0; i < n_pixels; ++i) {
        out[i] = kU8Unit.v[gray[i]];
    }
}

void f32_to_u8_wrap(const float* in, uint8_t* out, int64_t n) {
    // The reference's float_to_uint8 wrap semantics (transforms.py:26-29):
    // trunc toward zero, wrap mod 256.
    for (int64_t i = 0; i < n; ++i) {
        const int32_t v = static_cast<int32_t>(in[i] * 255.0f);
        out[i] = static_cast<uint8_t>(v & 0xff);
    }
}

// ---------------------------------------------------------------------------
// SPSC frame ring
// ---------------------------------------------------------------------------

struct FrameRing {
    int64_t capacity;        // number of slots
    int64_t frame_floats;    // floats per frame
    float* slots;            // capacity * frame_floats
    // Per-slot seqlock stamp: the sequence number of the completed write,
    // or ~seq (negative) while seq's write is in progress.  The stamp is
    // flipped to ~seq BEFORE the data memcpy and back to seq after, so a
    // reader that overlaps an overwrite always sees a stamp mismatch on one
    // side of its copy.
    std::atomic<int64_t>* seqs;
    std::atomic<int64_t> head;  // next sequence to write
    std::atomic<int64_t> tail;  // oldest unread sequence
    std::atomic<int64_t> dropped;  // frames pushed but never delivered
};

// Advance ``tail`` to at least ``target`` (never backwards: both producer
// overwrite-advance and consumer pops race on it).  Returns how far it moved
// from the caller-observed value (for drop accounting), or 0 if another
// update won.
static int64_t tail_advance(FrameRing* r, int64_t target) {
    int64_t t = r->tail.load(std::memory_order_relaxed);
    while (t < target) {
        if (r->tail.compare_exchange_weak(t, target,
                                          std::memory_order_release,
                                          std::memory_order_relaxed)) {
            return target - t;
        }
    }
    return 0;
}

FrameRing* ring_create(int64_t capacity, int64_t frame_floats) {
    auto* r = new (std::nothrow) FrameRing();
    if (!r) return nullptr;
    r->capacity = capacity;
    r->frame_floats = frame_floats;
    r->slots = new (std::nothrow) float[capacity * frame_floats];
    r->seqs = new (std::nothrow) std::atomic<int64_t>[capacity];
    if (!r->slots || !r->seqs) {
        delete[] r->slots;
        delete[] r->seqs;
        delete r;
        return nullptr;
    }
    // No slot holds a completed write yet; ~0 marks "never written".
    for (int64_t i = 0; i < capacity; ++i) r->seqs[i].store(~int64_t(0));
    r->head.store(0);
    r->tail.store(0);
    r->dropped.store(0);
    return r;
}

void ring_destroy(FrameRing* r) {
    if (!r) return;
    delete[] r->slots;
    delete[] r->seqs;
    delete r;
}

// Producer: write a frame; overwrites the oldest when full (live-camera
// drop-oldest semantics).  Returns the frame's sequence number.
int64_t ring_push(FrameRing* r, const float* frame) {
    const int64_t seq = r->head.load(std::memory_order_relaxed);
    const int64_t slot = seq % r->capacity;
    // Seqlock write side: invalidate the stamp, fence, write data, publish
    // the stamp.  The release fence keeps the invalidation visible before
    // any of the data stores; the release store publishes the data.
    r->seqs[slot].store(~seq, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_release);
    std::memcpy(r->slots + slot * r->frame_floats, frame,
                sizeof(float) * r->frame_floats);
    r->seqs[slot].store(seq, std::memory_order_release);
    r->head.store(seq + 1, std::memory_order_release);
    // Advance tail past the slot we just overwrote (monotonic CAS so a
    // concurrent consumer pop can never be clobbered backwards).
    if (seq + 1 - r->tail.load(std::memory_order_relaxed) > r->capacity) {
        const int64_t moved = tail_advance(r, seq + 1 - r->capacity);
        if (moved > 0)
            r->dropped.fetch_add(moved, std::memory_order_relaxed);
    }
    return seq;
}

// Seqlock read side: copy slot ``slot`` expecting stamp ``want``.  Returns
// true iff the copy is consistent (stamp matched on both sides of the copy).
static bool read_slot(FrameRing* r, int64_t slot, int64_t want, float* out) {
    if (r->seqs[slot].load(std::memory_order_acquire) != want) return false;
    std::memcpy(out, r->slots + slot * r->frame_floats,
                sizeof(float) * r->frame_floats);
    std::atomic_thread_fence(std::memory_order_acquire);
    return r->seqs[slot].load(std::memory_order_relaxed) == want;
}

// Consumer: pop the OLDEST unread frame (FIFO).  Returns its sequence
// number, or -1 when empty.
int64_t ring_pop(FrameRing* r, float* out) {
    for (;;) {
        int64_t tail = r->tail.load(std::memory_order_relaxed);
        const int64_t head = r->head.load(std::memory_order_acquire);
        if (tail >= head) return -1;
        if (read_slot(r, tail % r->capacity, tail, out)) {
            // Deliver iff tail is still ours (the producer may have lapped
            // past this slot between the copy and here; the CAS loses and
            // we retry from the advanced tail — never a stale duplicate).
            int64_t expect = tail;
            if (r->tail.compare_exchange_strong(expect, tail + 1,
                                                std::memory_order_release,
                                                std::memory_order_relaxed)) {
                return tail;
            }
            continue;
        }
        // Torn or lapped: skip just past the slot being overwritten (the
        // producer writing seq ``head`` occupies slot head % capacity =
        // (head - capacity) % capacity).  Frames we skip were overwritten
        // and never delivered — count them dropped (invariant: every tail
        // step is either one delivered pop or a counted drop).
        int64_t fresh = r->head.load(std::memory_order_acquire)
            - r->capacity + 1;
        if (fresh > tail) {
            const int64_t moved = tail_advance(r, fresh);
            if (moved > 0)
                r->dropped.fetch_add(moved, std::memory_order_relaxed);
        }
    }
}

// Consumer: pop the NEWEST frame, discarding older ones (freshest-frame
// semantics for live monitoring).  Returns its sequence, or -1 when empty.
int64_t ring_pop_latest(FrameRing* r, float* out) {
    for (;;) {
        const int64_t head = r->head.load(std::memory_order_acquire);
        const int64_t tail = r->tail.load(std::memory_order_relaxed);
        if (tail >= head) return -1;
        const int64_t seq = head - 1;
        if (!read_slot(r, seq % r->capacity, seq, out)) continue;  // lapped
        int64_t expect = tail;
        // Monotonic claim up to ``head``; losing the race means the
        // producer overwrote more frames — retry with the fresher head.
        while (expect < head) {
            if (r->tail.compare_exchange_weak(expect, head,
                                              std::memory_order_release,
                                              std::memory_order_relaxed)) {
                if (seq > expect) {  // skipped frames were never delivered
                    r->dropped.fetch_add(seq - expect,
                                         std::memory_order_relaxed);
                }
                return seq;
            }
        }
    }
}

int64_t ring_size(const FrameRing* r) {
    const int64_t head = r->head.load(std::memory_order_acquire);
    const int64_t tail = r->tail.load(std::memory_order_acquire);
    const int64_t n = head - tail;
    return n < 0 ? 0 : (n > r->capacity ? r->capacity : n);
}

int64_t ring_dropped(const FrameRing* r) {
    // Cumulative count of frames pushed but never delivered to the
    // consumer: overwritten-while-unread plus skipped by pop_latest.
    return r->dropped.load(std::memory_order_acquire);
}

// ---------------------------------------------------------------------------
// Fleet batch collection
// ---------------------------------------------------------------------------

// Freshest-frame collection across ``n`` rings into one contiguous
// (n, stride_floats) batch: the host side of lockstep multi-stream
// monitoring (one (S, H, W) upload per fleet step instead of S frame-sized
// ones).  Row ``i`` is written only when ring ``i`` delivers;
// ``seqs_out[i]`` is the delivered sequence or -1 (row untouched, so the
// caller's persistent batch keeps the stream's previous frame: stale
// streams repeat their last frame).  All rings share ``stride_floats``
// (one frame shape and dtype).
void rings_collect_latest(void** rings, int64_t n, float* out,
                          int64_t stride_floats, int64_t* seqs_out) {
    for (int64_t i = 0; i < n; ++i) {
        auto* r = reinterpret_cast<FrameRing*>(rings[i]);
        seqs_out[i] = ring_pop_latest(r, out + i * stride_floats);
    }
}

}  // extern "C"
