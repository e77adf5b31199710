// Native host topology engine for ch_shrinkwrap_torch.
//
// C++ counterpart of the reference's native mesh layer (PYME
// triangle_mesh_utils.c + the Cython edit kernels in
// ch_shrinkwrap/_membrane_mesh.pyx /
// _skeleton_mesh.pyx), re-designed for the compact-(V,F) architecture:
// the device pipeline only ever sees padded SoA arrays, so this engine
// takes (V,F), builds halfedge connectivity internally, performs
// sequential guarded remeshing (split / collapse / flip / relax — a
// serial greedy pass has no independent-set sparsity limits, unlike
// the vectorized numpy passes), and emits a compacted (V,F) pair
// plus the neighbor tables the curvature/solver kernels consume.
//
// Plain C ABI for ctypes binding (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <algorithm>
#include <unordered_map>
#include <array>
#include <new>

namespace {

struct Vec3 {
    float x, y, z;
    Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
    Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    Vec3 operator*(float s) const { return {x * s, y * s, z * s}; }
    float dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
    Vec3 cross(const Vec3& o) const {
        return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
    }
    float norm2() const { return dot(*this); }
    float norm() const { return std::sqrt(norm2()); }
};

// 64-byte aligned allocation: each vertex block of the incidence slab
// starts on a cache line
template <class T>
struct LineAlloc {
    using value_type = T;
    LineAlloc() = default;
    template <class U> LineAlloc(const LineAlloc<U>&) {}
    T* allocate(std::size_t n) {
        void* p = nullptr;
        if (posix_memalign(&p, 64, n * sizeof(T)) != 0)
            throw std::bad_alloc();
        return static_cast<T*>(p);
    }
    void deallocate(T* p, std::size_t) { std::free(p); }
    template <class U>
    bool operator==(const LineAlloc<U>&) const { return true; }
    template <class U>
    bool operator!=(const LineAlloc<U>&) const { return false; }
};

// A vertex's valence (live faces it is a corner of) and a lower bound
// on its neighbours' valences, side by side for the flip pass's guard
struct Valence {
    int32_t val, nbmin;
};

// Edit-mesh: faces as index triples with a live flag, and each vertex's
// incident live faces in one flat slab.  Vertex v owns the block
// inc_[v*B, (v+1)*B): its count at [0], then up to B-1 face ids in list
// order, so a walk over its list reads one block (B = 16: one cache
// line).  A list that outgrows its block moves to spill_ (block[1]
// then holds its offset there, spill_[offset] the capacity) and moves
// back when it fits again.  A dying face leaves its vertices' lists,
// the rest keeping their order, so no walk reads face_live.
//
// The lists' order decides every greedy choice (the order ring()
// yields neighbours, which face edge_faces() returns first), so each
// edit appends and removes exactly as the per-vertex vectors with
// tombstones it replaces did: a list here is that vector's live
// entries, in that vector's order.
struct EditMesh {
    std::vector<Vec3> pos;
    std::vector<std::array<int32_t, 3>> faces;
    std::vector<uint8_t> face_live;
    std::vector<uint8_t> vert_live;
    int B = 16;
    std::vector<int32_t, LineAlloc<int32_t>> inc_;
    std::vector<int32_t> spill_;
    long n_spill = 0;               // lists moved out of their block
    // epoch-stamped vertex marks: O(deg) one-ring dedup / set
    // intersection instead of the O(deg^2) std::find scans that
    // dominated the collapse pass (60% of a growth remesh)
    mutable std::vector<uint32_t> mark_;
    mutable uint32_t epoch_ = 0;
    std::vector<int32_t> snap_;     // collapse: b's list while rewritten
    std::vector<Vec3> target_;      // relax

    inline uint32_t new_epoch() const {
        if (mark_.size() < pos.size())
            mark_.resize(pos.size() * 2 + 64, 0);
        if (++epoch_ == 0) {            // wraparound: clear and restart
            std::fill(mark_.begin(), mark_.end(), 0u);
            epoch_ = 1;
        }
        return epoch_;
    }

    // v_cap, f_cap: the caller's output capacities, which bound the
    // vertex and face slots a remesh makes between compactions (more
    // grow the arrays as before)
    void build(const float* verts, int nv, const int32_t* f, int nf,
               int v_cap, int f_cap) {
        size_t vres = std::max(nv, v_cap), fres = std::max(nf, f_cap);
        pos.reserve(vres);
        vert_live.reserve(vres);
        faces.reserve(fres);
        face_live.reserve(fres);
        mark_.assign(vres, 0);
        pos.resize(nv);
        std::memcpy(pos.data(), verts, sizeof(float) * 3 * nv);
        faces.resize(nf);
        face_live.assign(nf, 1);
        vert_live.assign(nv, 1);
        std::vector<int32_t> deg(nv, 0);
        for (int i = 0; i < nf; ++i) {
            faces[i] = {f[3 * i], f[3 * i + 1], f[3 * i + 2]};
            for (int k = 0; k < 3; ++k) ++deg[faces[i][k]];
        }
        // a block holds half again the input's largest list (a growth
        // pass lengthens lists until its collapses and flips even them
        // out); a remeshed surface's lists reach 8, so B is one line
        int maxdeg = 0;
        for (int d : deg) maxdeg = std::max(maxdeg, d);
        B = 16;
        while (2 * (B - 1) < 3 * maxdeg) B += 16;
        inc_.reserve(vres * B);
        inc_.assign((size_t)nv * B, 0);
        for (int i = 0; i < nf; ++i)
            for (int k = 0; k < 3; ++k) push(faces[i][k], i);
    }

    // v's incident live faces: their count in n, their ids at the
    // pointer returned (valid until the next list edit)
    inline const int32_t* inc(int v, int& n) const {
        const int32_t* blk = inc_.data() + (size_t)v * B;
        n = blk[0];
        return n < B ? blk + 1 : spill_.data() + blk[1] + 1;
    }

    void push(int v, int32_t fi) {
        int32_t* blk = inc_.data() + (size_t)v * B;
        int n = blk[0];
        if (n < B - 1) {
            blk[1 + n] = fi;
            blk[0] = n + 1;
            return;
        }
        int32_t off;
        if (n == B - 1) {               // the block is full: move out
            off = (int32_t)spill_.size();
            spill_.resize(off + 1 + 2 * B);
            spill_[off] = 2 * B;
            std::memcpy(&spill_[off + 1], blk + 1, sizeof(int32_t) * n);
            blk[1] = off;
            ++n_spill;
        } else {
            off = blk[1];
            if (n == spill_[off]) {     // the spill block is full: double
                int32_t grown = (int32_t)spill_.size();
                int cap = 2 * spill_[off];
                spill_.resize(grown + 1 + cap);
                spill_[grown] = cap;
                std::memcpy(&spill_[grown + 1], &spill_[off + 1],
                            sizeof(int32_t) * n);
                off = blk[1] = grown;
            }
        }
        spill_[off + 1 + n] = fi;
        blk[0] = n + 1;
    }

    // drop every entry fi from v's list, keeping the others' order
    void erase(int v, int32_t fi) {
        int32_t* blk = inc_.data() + (size_t)v * B;
        int n = blk[0];
        int32_t* p = n < B ? blk + 1 : &spill_[blk[1] + 1];
        int w = 0;
        for (int i = 0; i < n; ++i) {
            p[w] = p[i];
            w += p[i] != fi;
        }
        if (n >= B && w < B)            // fits its block again
            std::memcpy(blk + 1, p, sizeof(int32_t) * w);
        blk[0] = w;
    }

    void clear_list(int v) { inc_[(size_t)v * B] = 0; }

    // collect one-ring vertices of v into out, in the order their
    // faces list them; returns count
    int ring(int v, std::vector<int32_t>& out) const {
        uint32_t e = new_epoch();
        mark_[v] = e;                    // excludes v itself
        int n;
        const int32_t* L = inc(v, n);
        out.resize(3 * (size_t)n);
        int32_t* o = out.data();
        int k = 0;
        for (int i = 0; i < n; ++i) {
            const auto& F = faces[L[i]];
            for (int c = 0; c < 3; ++c) {
                int u = F[c];
                o[k] = u;                // kept only if not yet marked
                k += mark_[u] != e;
                mark_[u] = e;
            }
        }
        out.resize(k);
        return k;
    }

    // does any live face contain both a and b?  (early-exit variant
    // of edge_faces for existence-only callers)
    bool has_edge(int a, int b) const {
        int n;
        const int32_t* L = inc(a, n);
        for (int i = 0; i < n; ++i) {
            const auto& F = faces[L[i]];
            if (F[0] == b || F[1] == b || F[2] == b) return true;
        }
        return false;
    }

    // number of live faces containing both a and b, filling them
    int edge_faces(int a, int b, int out[2]) const {
        int c = 0, n;
        int32_t o[3];                   // o[2]: a slot for the rest
        const int32_t* L = inc(a, n);
        for (int i = 0; i < n; ++i) {
            const auto& F = faces[L[i]];
            o[std::min(c, 2)] = L[i];   // kept only if the face has b
            c += (F[0] == b) | (F[1] == b) | (F[2] == b);
        }
        out[0] = o[0];
        out[1] = o[1];
        return c;
    }

    // area-weighted (unnormalized) vertex normal over live faces
    Vec3 vnormal(int v) const {
        Vec3 nrm{0, 0, 0};
        int n;
        const int32_t* L = inc(v, n);
        for (int i = 0; i < n; ++i) nrm = nrm + face_normal(L[i]);
        return nrm;
    }

    Vec3 face_normal(int fi) const {
        const auto& F = faces[fi];
        return (pos[F[1]] - pos[F[0]]).cross(pos[F[2]] - pos[F[0]]);
    }

    void replace_vertex(int fi, int from, int to) {
        for (int k = 0; k < 3; ++k)
            if (faces[fi][k] == from) faces[fi][k] = to;
    }

    bool face_degenerate(int fi) const {
        const auto& F = faces[fi];
        return F[0] == F[1] || F[1] == F[2] || F[0] == F[2];
    }

    // a live face is listed only by vertices it holds, so leaving
    // those lists leaves every list
    void kill_face(int fi) {
        face_live[fi] = 0;
        const auto F = faces[fi];
        erase(F[0], fi);
        if (F[1] != F[0]) erase(F[1], fi);
        if (F[2] != F[0] && F[2] != F[1]) erase(F[2], fi);
    }

    // Collapse edge (a, b): b merges into a at the midpoint.  ra is
    // ring(a), which the caller holds.
    // Guards: both interior (exactly 2 shared faces), link condition
    // (|ring(a) & ring(b)| == 2), valence cap, fold-over normal test,
    // and (high2 > 0) no resulting edge longer than sqrt(high2) — the
    // Botsch-Kobbelt result guard; without it collapse re-creates
    // over-long edges that the next split pass re-splits, and the
    // split/collapse churn costs ~75% of a growth remesh (measured:
    // 350k splits + 340k collapses per pass with stable output).
    // The guards are pure tests and none writes state before a reject,
    // so their order changes no outcome: the result guard over ring(a)
    // comes first, since it rejects 96%+ of a growth remesh's attempts
    // (high2 156-182k vs link <500, fold <200 per pass) and needs no
    // walk.  *early is set when it rejects.
    bool collapse(int a, int b, int max_valence,
                  const std::vector<int32_t>& ra, std::vector<int32_t>& rb,
                  float high2, bool* early) {
        *early = false;
        Vec3 mid = (pos[a] + pos[b]) * 0.5f;
        if (high2 > 0.f) {
            bool far = false;
            for (int u : ra)
                far |= (u != b) & ((pos[u] - mid).norm2() > high2);
            if (far) {
                *early = true;
                return false;
            }
            // the same guard over ring(b), read straight off b's faces
            // (ring(b) is their corners but b)
            int n;
            const int32_t* L = inc(b, n);
            for (int i = 0; i < n; ++i) {
                const auto& F = faces[L[i]];
                for (int k = 0; k < 3; ++k) {
                    int u = F[k];
                    far |= (u != a) & (u != b)
                           & ((pos[u] - mid).norm2() > high2);
                }
            }
            if (far) {
                *early = true;
                return false;
            }
        }
        int ef[2];
        if (edge_faces(a, b, ef) != 2) return false;
        ring(b, rb);
        uint32_t e = new_epoch();
        for (int u : rb) mark_[u] = e;
        int common = 0;
        for (int u : ra) common += (mark_[u] == e);
        if (common != 2) return false;
        if ((int)(ra.size() + rb.size()) - 4 > max_valence) return false;

        // fold-over guard: surviving faces of a and b must not flip
        Vec3 old_a = pos[a], old_b = pos[b];
        pos[a] = mid;
        pos[b] = mid;
        for (int pass = 0; pass < 2; ++pass) {
            int v = pass == 0 ? a : b;
            int n;
            const int32_t* L = inc(v, n);
            for (int i = 0; i < n; ++i) {
                int fi = L[i];
                if (fi == ef[0] || fi == ef[1]) continue;
                const auto& F = faces[fi];
                // normal before (with old positions) vs after
                Vec3 p0 = pos[F[0]], p1 = pos[F[1]], p2 = pos[F[2]];
                Vec3 n_new = (p1 - p0).cross(p2 - p0);
                // recompute with original positions
                Vec3 q[3];
                for (int k = 0; k < 3; ++k) {
                    int u = F[k];
                    q[k] = (u == a) ? old_a : (u == b) ? old_b : pos[u];
                }
                Vec3 n_old = (q[1] - q[0]).cross(q[2] - q[0]);
                if (n_new.dot(n_old) <= 0.f) {
                    pos[a] = old_a;
                    pos[b] = old_b;
                    return false;
                }
            }
        }

        // apply: faces of b -> a; shared faces die
        kill_face(ef[0]);
        kill_face(ef[1]);
        int n;
        const int32_t* L = inc(b, n);
        snap_.assign(L, L + n);
        for (int fi : snap_) {
            if (!face_live[fi]) continue;   // a repeated entry killed
            replace_vertex(fi, b, a);
            if (face_degenerate(fi)) kill_face(fi);
            else push(a, fi);
        }
        clear_list(b);
        vert_live[b] = 0;
        return true;
    }

    // Split edge (a, b) at midpoint; the 1-2 incident faces become
    // 2-4.  Returns false on the silent no-op (edge_faces outside
    // 1..2, e.g. a transient nonmanifold edge) — the split-scan
    // dirty-set must know, or the baseline's next-pass retry of the
    // still-long edge is skipped (measured: 25 such skips diverged a
    // coarsening remesh before this returned a value).
    bool split(int a, int b) {
        int ef[2];
        int n = edge_faces(a, b, ef);
        if (n < 1 || n > 2) return false;
        int m = (int)pos.size();
        pos.push_back((pos[a] + pos[b]) * 0.5f);
        vert_live.push_back(1);
        inc_.resize(inc_.size() + B, 0);
        for (int e = 0; e < n; ++e) {
            int fi = ef[e];
            auto F = faces[fi];
            // face (x, y, z) keeps its winding: fi takes m for b, the
            // new face takes m for a
            int ia = F[0] == a ? 0 : F[1] == a ? 1 : 2;
            replace_vertex(fi, b, m);
            push(m, fi);
            std::array<int32_t, 3> f2 = F;
            f2[ia] = m;
            int nf = (int)faces.size();
            faces.push_back(f2);
            face_live.push_back(1);
            push(m, nf);
            for (int k = 0; k < 3; ++k)
                if (f2[k] != m) push(f2[k], nf);
            // b keeps face2 via the loop above; remove fi from b's list
            erase(b, fi);
        }
        return true;
    }

    // Flip the edge (a, b) shared by exactly two faces if it improves
    // valence regularity and passes geometry guards.  ``q``: the
    // caller-maintained valences, updated in place when the flip lands
    // (a/b lose one incident face pair, c/d gain).
    bool flip(int a, int b, Valence* q) {
        int ef[2];
        if (edge_faces(a, b, ef) != 2) return false;
        int f1 = ef[0], f2 = ef[1];
        int c = -1, d = -1;
        for (int k = 0; k < 3; ++k) {
            int u = faces[f1][k];
            if (u != a && u != b) c = u;
            int w = faces[f2][k];
            if (w != a && w != b) d = w;
        }
        if (c < 0 || d < 0 || c == d) return false;

        int va = q[a].val, vb = q[b].val, vc = q[c].val, vd = q[d].val;
        auto dev = [](int v) { return (v - 6) * (v - 6); };
        int before = dev(va) + dev(vb) + dev(vc) + dev(vd);
        int after = dev(va - 1) + dev(vb - 1) + dev(vc + 1) + dev(vd + 1);
        if (after >= before) return false;

        // c-d must not already be an edge (after the cheap valence
        // reject — this walks an incidence list)
        if (has_edge(c, d)) return false;

        // orientation guard
        Vec3 n_old = face_normal(f1) + face_normal(f2);
        // determine winding: in f1, is the directed edge a->b present?
        int ia = -1;
        for (int k = 0; k < 3; ++k)
            if (faces[f1][k] == a) ia = k;
        bool ab_in_f1 = faces[f1][(ia + 1) % 3] == b;
        int u = ab_in_f1 ? a : b;
        int v = ab_in_f1 ? b : a;
        // f1 = (u, v, c), f2 = (v, u, d) -> new (u, d, c), (d, v, c)
        std::array<int32_t, 3> nf1 = {(int32_t)u, (int32_t)d, (int32_t)c};
        std::array<int32_t, 3> nf2 = {(int32_t)d, (int32_t)v, (int32_t)c};
        Vec3 n1 = (pos[nf1[1]] - pos[nf1[0]]).cross(pos[nf1[2]] - pos[nf1[0]]);
        Vec3 n2 = (pos[nf2[1]] - pos[nf2[0]]).cross(pos[nf2[2]] - pos[nf2[0]]);
        if (n1.dot(n_old) <= 0.f || n2.dot(n_old) <= 0.f) return false;

        // detach old faces from vertex lists
        for (int e = 0; e < 2; ++e) {
            int fi = ef[e];
            for (int k = 0; k < 3; ++k) erase(faces[fi][k], fi);
        }
        faces[f1] = nf1;
        faces[f2] = nf2;
        for (int k = 0; k < 3; ++k) {
            push(nf1[k], f1);
            push(nf2[k], f2);
        }
        --q[a].val; --q[b].val;
        ++q[c].val; ++q[d].val;
        return true;
    }

    void relax(float l, int n_iter) {
        target_.resize(pos.size());
        for (int it = 0; it < n_iter; ++it) {
            for (size_t v = 0; v < pos.size(); ++v) {
                int n;
                const int32_t* L = inc((int)v, n);
                if (!vert_live[v] || n == 0) continue;
                Vec3 acc{0, 0, 0};
                float wsum = 0.f;
                Vec3 nrm{0, 0, 0};
                for (int i = 0; i < n; ++i) {
                    const auto& F = faces[L[i]];
                    Vec3 c = (pos[F[0]] + pos[F[1]] + pos[F[2]])
                             * (1.f / 3.f);
                    Vec3 fn = face_normal(L[i]);
                    float area = 0.5f * fn.norm();
                    acc = acc + c * area;
                    wsum += area;
                    nrm = nrm + fn;
                }
                if (wsum <= 0.f) { target_[v] = pos[v]; continue; }
                Vec3 t = acc * (1.f / wsum);
                float nn = nrm.norm();
                if (nn > 1e-12f) {
                    nrm = nrm * (1.f / nn);
                    Vec3 delta = t - pos[v];
                    delta = delta - nrm * delta.dot(nrm);
                    target_[v] = pos[v] + delta * l;
                } else {
                    target_[v] = pos[v];
                }
            }
            for (size_t v = 0; v < pos.size(); ++v)
                if (vert_live[v] && inc_[v * B] != 0) pos[v] = target_[v];
        }
    }

    // in-place tombstone removal: rebuild pos/faces and the lists from
    // the live set (indices are renumbered; callers hold no indices
    // across passes, so this is safe between passes)
    void rebuild_compact() {
        std::vector<int32_t> remap(pos.size(), -1);
        std::vector<Vec3> new_pos;
        new_pos.reserve(pos.capacity());
        std::vector<std::array<int32_t, 3>> new_faces;
        new_faces.reserve(faces.capacity());
        for (size_t f = 0; f < faces.size(); ++f) {
            if (!face_live[f]) continue;
            std::array<int32_t, 3> F;
            for (int k = 0; k < 3; ++k) {
                int u = faces[f][k];
                if (remap[u] < 0) {
                    remap[u] = (int32_t)new_pos.size();
                    new_pos.push_back(pos[u]);
                }
                F[k] = remap[u];
            }
            new_faces.push_back(F);
        }
        pos.swap(new_pos);
        faces.swap(new_faces);
        face_live.assign(faces.size(), 1);
        vert_live.assign(pos.size(), 1);
        inc_.resize(pos.size() * B);
        for (size_t v = 0; v < pos.size(); ++v) inc_[v * B] = 0;
        spill_.clear();
        for (size_t f = 0; f < faces.size(); ++f)
            for (int k = 0; k < 3; ++k) push(faces[f][k], (int32_t)f);
    }

    // write back compacted arrays; returns (nv_out, nf_out)
    void compact(float* verts_out, int32_t* faces_out, int32_t* nv_out,
                 int32_t* nf_out, int v_cap, int f_cap) {
        std::vector<int32_t> remap(pos.size(), -1);
        int nv = 0;
        for (size_t f = 0; f < faces.size(); ++f) {
            if (!face_live[f]) continue;
            for (int k = 0; k < 3; ++k) {
                int u = faces[f][k];
                if (remap[u] < 0) remap[u] = nv++;
            }
        }
        int nf = 0;
        for (size_t f = 0; f < faces.size(); ++f)
            if (face_live[f]) ++nf;
        if (nv > v_cap || nf > f_cap) {
            *nv_out = -nv;     // signal: caller must grow buffers
            *nf_out = -nf;
            return;
        }
        for (size_t u = 0; u < pos.size(); ++u) {
            if (remap[u] >= 0) {
                verts_out[3 * remap[u]] = pos[u].x;
                verts_out[3 * remap[u] + 1] = pos[u].y;
                verts_out[3 * remap[u] + 2] = pos[u].z;
            }
        }
        int fo = 0;
        for (size_t f = 0; f < faces.size(); ++f) {
            if (!face_live[f]) continue;
            for (int k = 0; k < 3; ++k)
                faces_out[3 * fo + k] = remap[faces[f][k]];
            ++fo;
        }
        *nv_out = nv;
        *nf_out = nf;
    }
};

}  // namespace

extern "C" {

// Isotropic remesh toward target edge length: n_passes of
// {split long, collapse short (greedy sequential, guarded), flip,
// relax}.  Buffers are caller-allocated with capacities; on overflow
// *nv/*nf return negated required sizes and no write happens.
// veto_cos / veto_min_len2: opt-in support for thin-tube pinch
// protection (MembraneMesh.remesh_collapse_veto): skip collapsing an
// edge whose endpoint normals diverge more than acos(veto_cos) AND
// whose length exceeds veto_min_len2 — on a tube whose diameter
// approaches the target edge length, the short circumferential edges
// carry strongly divergent normals, and collapsing them is what
// pinches a well-supported junction apart (TwoToruses low-cw regime,
// BASELINE.md round 4).  veto_cos > 1 disables (default).
// counts (9 entries) returns, in order: splits, collapses and flips
// landed; collapse and flip attempts; collapse and flip attempts
// rejected by the result and valence guards before the edge and link
// walks; lists that outgrew their slab block; compactions.
void remesh_native(const float* verts_in, int nv, const int32_t* faces_in,
                   int nf, float target, int n_passes, float l,
                   int n_relax, int max_valence,
                   float* verts_out, int32_t* faces_out,
                   int32_t* nv_out, int32_t* nf_out,
                   int v_cap, int f_cap,
                   float veto_cos, float veto_min_len2,
                   int64_t* counts) {
    EditMesh m;
    m.build(verts_in, nv, faces_in, nf, v_cap, f_cap);
    const float high2 = (4.f / 3.f * target) * (4.f / 3.f * target);
    const float low2 = (4.f / 5.f * target) * (4.f / 5.f * target);
    std::vector<int32_t> rb, ring;
    rb.reserve(64);
    ring.reserve(64);
    int64_t n_split = 0, n_coll = 0, n_flip = 0, n_att = 0, n_fatt = 0,
            n_early = 0, n_fearly = 0, n_compact = 0;

    // ---- split-scan skipping (behavior-identical) ----
    // A face can only carry a NEW over-long edge if one of its
    // endpoints was repositioned or its edge set was rewritten since
    // the previous split scan (split is unconditional on edge length
    // — no other guard).  Each landed edit stamps exactly the
    // vertices whose position or incident edge set changed (collapse:
    // the kept vertex; split: the new midpoint — every rewritten face
    // contains it; flip: all four vertices of the rewired quad), and
    // passes >= 1 skip faces whose three stamps predate the previous
    // scan.
    //
    // NOTE a committed negative: the stronger attempt-level fail-memo
    // (skip collapse/flip attempts whose 2-ring is unchanged since
    // they last failed, with ring-dilated marks) was built, proven
    // output-identical, and MEASURED SLOWER — a growth remesh churns
    // globally (~25k edits/pass dilate over the whole mesh), so <4% of
    // attempts were skippable while the marking cost ~35% of the pass.
    uint64_t seq = 1;
    std::vector<uint64_t> touched;
    touched.reserve(m.pos.capacity());
    touched.assign(m.pos.size(), 1);
    uint64_t prev_split_scan_seq = 0;
    auto stamp = [&](int v) {
        if ((size_t)v < touched.size()) touched[v] = seq;
        else touched.resize(m.pos.size(), seq);
    };
    std::vector<uint8_t> short_cand, irr2;
    std::vector<int32_t> cands;
    std::vector<Valence> vq;
    cands.reserve(m.pos.capacity());
    short_cand.reserve(m.pos.capacity());
    irr2.reserve(m.pos.capacity());
    vq.reserve(m.pos.capacity());

    for (int pass = 0; pass < n_passes; ++pass) {
        // split pass: iterate faces, split the longest over-long edge
        long n_edit = 0;
        const uint64_t scan_from = prev_split_scan_seq;
        prev_split_scan_seq = seq;
        size_t nf_now = m.faces.size();
        for (size_t fi = 0; fi < nf_now; ++fi) {
            if (!m.face_live[fi]) continue;
            if (scan_from > 0) {
                const auto& F = m.faces[fi];
                // endpoint positions unchanged since the last split
                // scan => no edge of this face became long
                if ((touched[F[0]] < scan_from) & (touched[F[1]] < scan_from)
                        & (touched[F[2]] < scan_from))
                    continue;
            }
            for (int k = 0; k < 3; ++k) {
                int a = m.faces[fi][k];
                int b = m.faces[fi][(k + 1) % 3];
                if ((a < b) & ((m.pos[a] - m.pos[b]).norm2() > high2)) {
                    bool did = m.split(a, b);
                    ++n_edit;
                    ++seq;
                    if (did) {
                        ++n_split;
                        stamp((int)m.pos.size() - 1);
                    } else {
                        // no-op split (nonmanifold transient):
                        // keep the edge dirty so the next pass
                        // retries it like the full scan would
                        stamp(a);
                        stamp(b);
                    }
                }
            }
        }

        // collapse pass: sequential greedy over vertices' short edges
        // (result-guarded: may not create an edge above 4/3 target).
        // Candidate prefilter: one face scan marks vertices carrying a
        // short edge; the greedy loop then ring-walks only those.  A
        // collapse repositions only the KEPT vertex, so any NEW short
        // edge is incident to it and its own while(again) loop catches
        // it — behavior-identical to scanning every vertex, but the
        // fit's incremental growth remeshes (few shorts, many splits)
        // skip the ~V ring() walks that dominated the pass (measured
        // 60-70% of remesh wall-clock).
        short_cand.assign(m.pos.size(), 0);
        nf_now = m.faces.size();
        for (size_t fi = 0; fi < nf_now; ++fi) {
            if (!m.face_live[fi]) continue;
            const auto& F = m.faces[fi];
            for (int k = 0; k < 3; ++k) {
                int a = F[k];
                int b = F[(k + 1) % 3];
                uint8_t s = (a < b) & ((m.pos[a] - m.pos[b]).norm2() < low2);
                short_cand[a] |= s;
                short_cand[b] |= s;
            }
        }
        cands.resize(m.pos.size());
        size_t n_cands = 0;
        for (size_t v = 0; v < m.pos.size(); ++v) {
            cands[n_cands] = (int32_t)v;
            n_cands += short_cand[v] & m.vert_live[v];
        }
        for (size_t ci = 0; ci < n_cands; ++ci) {
            const int v = cands[ci];
            if (!m.vert_live[v]) continue;     // collapsed into another
            bool again = true;
            int guard = 8;
            while (again && guard-- > 0) {
                again = false;
                m.ring(v, ring);
                for (int u : ring) {
                    float el2 = (m.pos[v] - m.pos[u]).norm2();
                    if (el2 < low2) {
                        if (veto_cos <= 1.f && el2 > veto_min_len2) {
                            Vec3 na = m.vnormal(v);
                            Vec3 nb = m.vnormal(u);
                            float dp = na.dot(nb);
                            float nn = std::sqrt(na.norm2() * nb.norm2())
                                       + 1e-30f;
                            if (dp < veto_cos * nn) continue;
                        }
                        ++n_att;
                        bool early;
                        if (m.collapse(v, u, max_valence, ring, rb, high2,
                                       &early)) {
                            again = true;
                            ++n_edit;
                            ++n_coll;
                            ++seq;
                            stamp(v);
                            break;
                        }
                        n_early += early;
                    }
                }
            }
        }

        // flip pass.  Candidate prefilter: a flip strictly reduces
        // Sum (valence-6)^2 over the 4 involved vertices (a, b and the
        // two opposite vertices c, d), so it needs at least one of
        // them irregular.  c and d are both adjacent to a AND b, so
        // one face-scan dilation (mark every vertex of a face
        // containing an irregular vertex) makes irr2[a] || irr2[b] an
        // exact superset test at pass start — converged passes then
        // skip the ~E edge_faces() walks that dominated them.
        // Valences drift as flips land, so a mid-pass flip can in
        // rare cases make an UNMARKED vertex irregular (its opposite
        // vertex across a flipped edge); a second-order flip through
        // it waits for the next pass's fresh scan — acceptable in a
        // fixed-point heuristic re-run every pass and every remesh
        // boundary.
        {
            vq.assign(m.pos.size(), Valence{0, INT32_MAX});
            Valence* q = vq.data();
            nf_now = m.faces.size();
            for (size_t fi = 0; fi < nf_now; ++fi) {
                if (!m.face_live[fi]) continue;
                for (int k = 0; k < 3; ++k) ++q[m.faces[fi][k]].val;
            }
            irr2.assign(m.pos.size(), 0);
            // q[v].nbmin: no neighbour of v has a lower valence (kept so
            // as flips land: see below)
            for (size_t fi = 0; fi < nf_now; ++fi) {
                if (!m.face_live[fi]) continue;
                const auto& F = m.faces[fi];
                uint8_t irr = (q[F[0]].val != 6) | (q[F[1]].val != 6)
                              | (q[F[2]].val != 6);
                irr2[F[0]] |= irr;
                irr2[F[1]] |= irr;
                irr2[F[2]] |= irr;
                for (int k = 0; k < 3; ++k)
                    q[F[k]].nbmin = std::min(q[F[k]].nbmin,
                                             std::min(q[F[(k + 1) % 3]].val,
                                                      q[F[(k + 2) % 3]].val));
            }
            for (size_t fi = 0; fi < nf_now; ++fi) {
                if (!m.face_live[fi]) continue;
                for (int k = 0; k < 3; ++k) {
                    int a = m.faces[fi][k];
                    int b = m.faces[fi][(k + 1) % 3];
                    // Valence guard before the walk.  A flip lands
                    // only if va + vb - vc - vd >= 3 (the Sum (v-6)^2
                    // test, rearranged), and fi, a live face on edge
                    // (a, b), is f1 or f2 of any flip that lands, so
                    // its third corner x is c or d, and the other, a
                    // neighbour of a and b, has a valence of at least
                    // both nbmins: the guard rejects only flips that
                    // flip() would reject.  Both tests are evaluated
                    // without branches.
                    int x = m.faces[fi][(k + 2) % 3];
                    bool att = (a < b) & (irr2[a] | irr2[b]);
                    bool go = att & (q[a].val + q[b].val - q[x].val
                                     - std::max(q[a].nbmin, q[b].nbmin)
                                     >= 3);
                    n_fatt += att;
                    n_fearly += att & !go;
                    if (go && m.flip(a, b, q)) {
                        ++n_flip;
                        // a and b lost one: so may their neighbours'
                        // nbmin; c-d is a new edge
                        for (int w : {a, b}) {
                            const int32_t vw = q[w].val;
                            int n;
                            const int32_t* L = m.inc(w, n);
                            for (int i = 0; i < n; ++i)
                                for (int u : m.faces[L[i]])
                                    q[u].nbmin = std::min(
                                        q[u].nbmin, u != w ? vw : INT32_MAX);
                        }
                        // (fi now holds c and d beside a or b)
                        int cd[2], j = 0;
                        for (int u : m.faces[fi])
                            if (u != a && u != b) cd[j++] = u;
                        q[cd[0]].nbmin = std::min(q[cd[0]].nbmin,
                                                  q[cd[1]].val);
                        q[cd[1]].nbmin = std::min(q[cd[1]].nbmin,
                                                  q[cd[0]].val);
                        ++seq;
                        // the rewired quad: a, b and the new
                        // diagonal (post-flip faces[fi] holds
                        // (u, d, c))
                        stamp(a);
                        stamp(b);
                        for (int kk = 0; kk < 3; ++kk)
                            stamp(m.faces[fi][kk]);
                    }
                }
            }
        }

        if (n_relax > 0) {
            m.relax(l, n_relax);
            // relax repositions every vertex: the whole dirty-set is
            // invalidated (fit remeshes run n_relax=0 and keep it)
            ++seq;
            std::fill(touched.begin(), touched.end(), seq);
        }

        // drop accumulated tombstones so later passes don't scan them
        // (a growth remesh otherwise inflates the edit arrays ~6x)
        if (pass + 1 < n_passes) {
            size_t dead = 0;
            for (auto fl : m.face_live) dead += !fl;
            if (dead * 3 > m.faces.size()) {
                m.rebuild_compact();
                ++n_compact;
                // compaction RENUMBERS vertices, which flips the
                // split scan's a<b orientation dedup for edges
                // whose ascending-oriented face died (a baseline
                // quirk: such edges are uncheckable until a
                // renumbering happens to restore an ascending
                // live face) — scan outcomes therefore change
                // with unchanged positions.  Mark everything
                // dirty: the next pass scans fully, exactly like
                // the baseline's post-compact pass (measured: 25
                // skipped-face divergences on a coarsening
                // remesh before this reset).
                ++seq;
                touched.assign(m.pos.size(), seq);
            }
        }

        // converged: remaining edits are churn, not progress
        if (n_edit * 100 < (long)m.faces.size())
            break;
    }
    m.compact(verts_out, faces_out, nv_out, nf_out, v_cap, f_cap);
    const int64_t out[9] = {n_split, n_coll, n_flip, n_att, n_fatt,
                            n_early, n_fearly, m.n_spill, n_compact};
    std::memcpy(counts, out, sizeof(out));
}

// Mean halfedge length (== unique-edge mean on closed meshes, each
// interior edge counted twice) in one streaming pass.  The numpy form
// allocates three (F, 3, 3) temporaries (~0.1 s at 350k faces) and the
// halfedge-table route pays a 3F argsort — this is the per-boundary
// fit-loop query (edge-length schedule logging, grid cell sizing).
double mean_edge_native(const float* verts, const int32_t* faces,
                        int nf) {
    double acc = 0.0;
    for (int f = 0; f < nf; ++f) {
        for (int k = 0; k < 3; ++k) {
            int a = faces[3 * f + k];
            int b = faces[3 * f + (k + 1) % 3];
            double dx = (double)verts[3 * a] - verts[3 * b];
            double dy = (double)verts[3 * a + 1] - verts[3 * b + 1];
            double dz = (double)verts[3 * a + 2] - verts[3 * b + 2];
            acc += std::sqrt(dx * dx + dy * dy + dz * dz);
        }
    }
    return nf ? acc / (3.0 * nf) : 0.0;
}

// Fused neighbor-table build: per-vertex one-ring vertex/face tables
// (K-capped) + per-face edge-adjacent faces.  Single counting-sort
// pass — the host-side prep for every device block.
// want_face_adj=0 skips the twin-matching scan (face_nbrs untouched):
// the production fit path's face_nbrs content is dead (correspondence
// polish off, curvature reads nbr_v/nbr_f only) and the scan is a
// measurable slice of the per-remesh-boundary 'build' phase.
void build_tables_native(const int32_t* faces, int nf, int nv, int K,
                         int32_t* nbr_v, int32_t* nbr_f,
                         int32_t* face_nbrs, int want_face_adj) {
    // counts per source vertex
    std::vector<int32_t> cnt(nv + 1, 0);
    for (int f = 0; f < nf; ++f)
        for (int k = 0; k < 3; ++k) ++cnt[faces[3 * f + k] + 1];
    std::vector<int32_t> start(cnt.begin(), cnt.end());
    for (int v = 0; v < nv; ++v) start[v + 1] += start[v];

    // halfedge lists sorted by src: record (dst, face)
    std::vector<int32_t> he_dst(3 * nf), he_face(3 * nf), he_slot(3 * nf);
    std::vector<int32_t> cursor(start.begin(), start.end() - 1);
    for (int f = 0; f < nf; ++f) {
        for (int k = 0; k < 3; ++k) {
            int src = faces[3 * f + k];
            int dst = faces[3 * f + (k + 1) % 3];
            int pos = cursor[src]++;
            he_dst[pos] = dst;
            he_face[pos] = f;
            he_slot[pos] = k;
        }
    }

    // neighbor tables (first K outgoing halfedges per vertex)
    for (int v = 0; v < nv; ++v) {
        int n = 0;
        for (int p = start[v]; p < start[v + 1] && n < K; ++p, ++n) {
            nbr_v[(size_t)v * K + n] = he_dst[p];
            nbr_f[(size_t)v * K + n] = he_face[p];
        }
        for (; n < K; ++n) {
            nbr_v[(size_t)v * K + n] = -1;
            nbr_f[(size_t)v * K + n] = -1;
        }
    }

    if (!want_face_adj) return;
    // face adjacency: for halfedge (src=v, dst=u) find (src=u, dst=v)
    for (int f = 0; f < nf * 3; ++f) face_nbrs[f] = -1;
    for (int v = 0; v < nv; ++v) {
        for (int p = start[v]; p < start[v + 1]; ++p) {
            int u = he_dst[p];
            int found = -1;
            int n_found = 0;
            for (int q = start[u]; q < start[u + 1]; ++q) {
                if (he_dst[q] == v) {
                    found = he_face[q];
                    ++n_found;
                }
            }
            if (n_found == 1)
                face_nbrs[3 * he_face[p] + he_slot[p]] = found;
        }
    }
}


// ---------------------------------------------------------------------
// Halfedge twin matching for HalfedgeTables (mesh/core.py): twin[h] is
// the reverse-directed halfedge iff both directed edges are singletons
// (equivalent to the numpy searchsorted + dup-severing + back-check
// chain; multiple matches in either direction are non-manifold and
// sever to -1).  dup_out marks directed edges appearing >1x
// (nonmanifold_edges); vhe_out is the first outgoing halfedge per
// vertex.  The numpy formulation costs ~1 s per rebuild at 163k verts
// on this 1-core host (repair() rebuilds several times per call);
// this is one counting-sort + small-bucket scans.
void halfedge_twins_native(const int32_t* faces, int nf, int nv,
                           int32_t* twin_out, uint8_t* dup_out,
                           int32_t* vhe_out) {
    const int64_t nhe = 3LL * nf;
    std::vector<int32_t> cnt(nv + 1, 0);
    for (int64_t h = 0; h < nhe; ++h) ++cnt[faces[h] + 1];
    std::vector<int32_t> start(cnt.begin(), cnt.end());
    for (int v = 0; v < nv; ++v) start[v + 1] += start[v];

    std::vector<int32_t> he_dst(nhe), he_id(nhe);
    std::vector<int32_t> cursor(start.begin(), start.end() - 1);
    for (int f = 0; f < nf; ++f) {
        for (int k = 0; k < 3; ++k) {
            int64_t h = 3LL * f + k;
            int src = faces[h];
            int dst = faces[3LL * f + (k + 1) % 3];
            int pos = cursor[src]++;
            he_dst[pos] = dst;
            he_id[pos] = (int32_t)h;
        }
    }

    for (int v = 0; v < nv; ++v)
        vhe_out[v] = start[v] < start[v + 1] ? he_id[start[v]] : -1;
    // buckets are filled in ascending h, but the FIRST outgoing
    // halfedge by id is what numpy's reversed write kept; he_id[start]
    // is already the minimum since insertion order is h-ascending.

    for (int v = 0; v < nv; ++v) {
        for (int p = start[v]; p < start[v + 1]; ++p) {
            int dst = he_dst[p];
            int32_t h = he_id[p];
            // own-direction duplicate count within bucket[v]
            int n_dir = 0;
            for (int q = start[v]; q < start[v + 1]; ++q)
                if (he_dst[q] == dst) ++n_dir;
            dup_out[h] = n_dir > 1;
            // reverse matches in bucket[dst]
            int n_rev = 0;
            int32_t rev = -1;
            for (int q = start[dst]; q < start[dst + 1]; ++q) {
                if (he_dst[q] == v) {
                    rev = he_id[q];
                    ++n_rev;
                }
            }
            twin_out[h] = (n_dir == 1 && n_rev == 1) ? rev : -1;
        }
    }
}


// ---------------------------------------------------------------------
// Face hygiene for repair() (mesh/core.py): one pass computing, per
// face, bad = degenerate | duplicate (same sorted vertex triple as an
// earlier face) | incident on an over-shared undirected edge (>2 face
// incidences).  Replaces two np.unique key sorts (~0.6 s/pass at 163k
// verts) with one 64-bit sort + counting-sort bucket scans.  Caller
// guarantees nv < 2^21 so a sorted triple packs into 63 bits.
void face_hygiene_native(const int32_t* faces, int nf, int nv,
                         uint8_t* bad_out) {
    std::memset(bad_out, 0, nf);

    // degenerate + duplicate faces
    std::vector<std::pair<int64_t, int32_t>> keys(nf);
    for (int f = 0; f < nf; ++f) {
        int32_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
        if (a == b || b == c || a == c) bad_out[f] = 1;
        int32_t lo = std::min(a, std::min(b, c));
        int32_t hi = std::max(a, std::max(b, c));
        int32_t mid = (int32_t)((int64_t)a + b + c - lo - hi);
        keys[f] = {((int64_t)lo << 42) | ((int64_t)mid << 21) | hi, f};
    }
    std::sort(keys.begin(), keys.end());
    for (int i = 1; i < nf; ++i)
        if (keys[i].first == keys[i - 1].first)
            bad_out[keys[i].second] = 1;  // keep lowest face index only

    // undirected edges incident on >2 faces: bucket by lo endpoint
    const int64_t nhe = 3LL * nf;
    std::vector<int32_t> cnt(nv + 1, 0);
    std::vector<int32_t> e_lo(nhe), e_hi(nhe);
    for (int f = 0; f < nf; ++f) {
        for (int k = 0; k < 3; ++k) {
            int32_t a = faces[3 * f + k];
            int32_t b = faces[3 * f + (k + 1) % 3];
            int64_t h = 3LL * f + k;
            e_lo[h] = std::min(a, b);
            e_hi[h] = std::max(a, b);
            ++cnt[e_lo[h] + 1];
        }
    }
    for (int v = 0; v < nv; ++v) cnt[v + 1] += cnt[v];
    std::vector<int32_t> b_hi(nhe), b_h(nhe);
    std::vector<int32_t> cursor(cnt.begin(), cnt.end() - 1);
    for (int64_t h = 0; h < nhe; ++h) {
        int pos = cursor[e_lo[h]]++;
        b_hi[pos] = e_hi[h];
        b_h[pos] = (int32_t)h;
    }
    for (int v = 0; v < nv; ++v) {
        for (int p = cnt[v]; p < cnt[v + 1]; ++p) {
            int n_inc = 0;
            for (int q = cnt[v]; q < cnt[v + 1]; ++q)
                if (b_hi[q] == b_hi[p]) ++n_inc;
            if (n_inc > 2) bad_out[b_h[p] / 3] = 1;
        }
    }
}


// ---------------------------------------------------------------------
// Vertex connected components over the face-edge graph (union-find
// with path halving).  Labels are assigned in order of first
// appearance scanning vertices 0..nv-1 — the same convention as
// scipy.sparse.csgraph.connected_components, which this replaces on
// the repair/remove_inner_surfaces path.  Returns the component count.
int32_t vertex_components_native(const int32_t* faces, int nf, int nv,
                                 int32_t* labels_out) {
    std::vector<int32_t> parent(nv);
    for (int v = 0; v < nv; ++v) parent[v] = v;
    auto find = [&parent](int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    };
    for (int f = 0; f < nf; ++f) {
        int32_t a = find(faces[3 * f]);
        int32_t b = find(faces[3 * f + 1]);
        int32_t c = find(faces[3 * f + 2]);
        if (a != b) parent[a] = b;
        int32_t r = find(b);
        if (c != r && find(c) != r) parent[find(c)] = r;
    }
    std::vector<int32_t> rootlab(nv, -1);
    int32_t n = 0;
    for (int v = 0; v < nv; ++v) {
        int32_t r = find(v);
        if (rootlab[r] < 0) rootlab[r] = n++;
        labels_out[v] = rootlab[r];
    }
    return n;
}


// ---------------------------------------------------------------------
// best-mass window bases for the sliding-ring gather schedule
// (ops/pallas_gather.ring_gather_schedule): per 128-row index chunk,
// the 128-aligned start of the densest `span`-wide window over the
// chunk's cared targets.  The numpy formulation (per-chunk sort +
// global searchsorted) costs ~12 s at 13M rows on this 1-core host;
// this runs the same computation in one cache-resident pass.
void best_mass_bases(const int32_t* idx, const uint8_t* care,
                     int64_t n_rows, int chunk, int span,
                     int32_t n_src, int32_t* bases_out) {
    int64_t nc = n_rows / chunk;
    std::vector<int32_t> buf(chunk);
    int32_t n_al = ((n_src + 127) / 128) * 128;
    int32_t maxbase = n_al - span > 0 ? n_al - span : 0;
    int32_t eff = span - 128;
    for (int64_t c = 0; c < nc; ++c) {
        int m = 0;
        const int32_t* row = idx + c * chunk;
        const uint8_t* cr = care + c * chunk;
        for (int j = 0; j < chunk; ++j)
            if (cr[j]) buf[m++] = row[j];
        if (m == 0) { bases_out[c] = 0; continue; }
        std::sort(buf.begin(), buf.begin() + m);
        // sliding count of targets in [buf[j], buf[j] + eff]
        int best = 0, bestcnt = -1, hi = 0;
        for (int j = 0; j < m; ++j) {
            if (hi < j) hi = j;
            while (hi < m && buf[hi] <= buf[j] + eff) ++hi;
            if (hi - j > bestcnt) { bestcnt = hi - j; best = j; }
        }
        int32_t base = (buf[best] / 128) * 128;
        if (base >= n_src) base = 0;
        if (base > maxbase) base = maxbase;
        if (base < 0) base = 0;
        bases_out[c] = base;
    }
}

// ---------------------------------------------------------------------
// Vertex->incident-corner-row table (ops/meshdata.incidence_table):
// counting sort of the valid flat face-corner rows by their vertex.
// Per vertex, rows ascend; the first K fill the table, the rest land
// on the overflow lists in (vertex, row) order — byte-matching the
// numpy stable-argsort formulation.
void incidence_native(const int32_t* faces, const uint8_t* fmask,
                      int64_t nf, int32_t nv, int K,
                      int32_t* inc,        // (nv*K,) -1-filled by caller
                      int32_t* ov_rows, int32_t* ov_verts,
                      int64_t ov_cap, int64_t* n_ov) {
    std::vector<int32_t> cnt(nv + 1, 0);
    for (int64_t f = 0; f < nf; ++f) {
        if (!fmask[f]) continue;
        for (int c = 0; c < 3; ++c) {
            int32_t v = faces[f * 3 + c];
            if (v >= 0 && v < nv) ++cnt[v];
        }
    }
    std::vector<int64_t> off(nv + 1, 0);
    for (int32_t v = 0; v < nv; ++v) off[v + 1] = off[v] + cnt[v];
    std::vector<int32_t> rows(off[nv]);
    std::vector<int32_t> fill(nv, 0);
    for (int64_t f = 0; f < nf; ++f) {
        if (!fmask[f]) continue;
        for (int c = 0; c < 3; ++c) {
            int32_t v = faces[f * 3 + c];
            if (v >= 0 && v < nv)
                rows[off[v] + fill[v]++] = (int32_t)(f * 3 + c);
        }
    }
    int64_t nov = 0;
    for (int32_t v = 0; v < nv; ++v) {
        int32_t m = fill[v];
        for (int32_t j = 0; j < m; ++j) {
            if (j < K) {
                inc[(int64_t)v * K + j] = rows[off[v] + j];
            } else {
                if (nov < ov_cap) {
                    ov_rows[nov] = rows[off[v] + j];
                    ov_verts[nov] = v;
                }
                ++nov;
            }
        }
    }
    *n_ov = nov;
}

// ---------------------------------------------------------------------
// Full ring-gather schedule (ops/pallas_gather.ring_gather_schedule,
// fixed-layout production path) in one cache-resident pass: best-mass
// window bases, ring/patch residency, patch bookkeeping, DMA
// descriptors, index rewrite, patch targets and the uncovered-row
// fixup list.  The numpy formulation costs ~0.6 s per fit-capacity
// topology rebuild on this 1-core host (x19 rebuilds per north-star
// fit); this runs in ~0.1 s.  Semantics byte-match the numpy path
// (tests/test_ring_gather.py::test_ring_schedule_native_matches_numpy).
void ring_schedule_native(
    const int32_t* idx, const uint8_t* care, int64_t R,
    int32_t n_src, int span,
    int ring_segs, int patch_segs, int patch_chunk_segs, int cps,
    int32_t* bases,        // (nc,)
    int32_t* pbases,       // (nc,)
    int32_t* dmas,         // (n_steps*8,)
    int32_t* idx_patched,  // (Rp,) caller passes idx copied+padded
    int32_t* targets,      // (patch_cap,) zero-filled by caller
    int32_t* uncov,        // (uncov_cap,) -1-filled by caller
    int64_t patch_cap, int64_t uncov_cap,
    int64_t* n_patch_out, int64_t* n_uncov_out) {
    const int64_t step_rows = (int64_t)cps * 128;
    const int64_t n_steps = (R + step_rows - 1) / step_rows;
    const int64_t Rp = n_steps * step_rows;
    const int64_t nc = Rp / 128;
    const int32_t n_al = ((n_src + 127) / 128) * 128;
    const int32_t patch_lane0 = n_al;

    // pass 1: per-chunk best-mass bases over the padded row range
    // (pad rows read idx 0 / care 0 via the guards below)
    std::vector<int64_t> care_chunks;   // chunk ids with >=1 care row
    std::vector<int64_t> chunk_med;     // per-care-chunk value median
    {
        std::vector<int32_t> buf(128);
        int32_t maxbase = n_al - span > 0 ? n_al - span : 0;
        int32_t eff = span - 128;
        for (int64_t c = 0; c < nc; ++c) {
            int m = 0;
            int32_t mn = INT32_MAX, mx = INT32_MIN;
            for (int j = 0; j < 128; ++j) {
                int64_t r = c * 128 + j;
                if (r < R && care[r]) {
                    int32_t v = idx[r];
                    buf[m++] = v;
                    if (v < mn) mn = v;
                    if (v > mx) mx = v;
                }
            }
            if (m == 0) { bases[c] = 0; continue; }
            care_chunks.push_back(c);
            int32_t base;
            if (mx - mn <= eff) {
                // whole chunk fits one window: the two-pointer scan on
                // the sorted buffer would find bestcnt == m at j == 0
                // (first-on-ties), i.e. base = (min/128)*128 — same
                // result without the sort (the common case on
                // Hilbert-sorted fit streams; the sort dominated the
                // pass).  The clamp median only needs the (m-1)/2
                // order statistic: nth_element.
                std::nth_element(buf.begin(), buf.begin() + (m - 1) / 2,
                                 buf.begin() + m);
                chunk_med.push_back(buf[(m - 1) / 2]);
                base = (mn / 128) * 128;
            } else {
                std::sort(buf.begin(), buf.begin() + m);
                chunk_med.push_back(buf[(m - 1) / 2]);
                int best = 0, bestcnt = -1, hi = 0;
                for (int j = 0; j < m; ++j) {
                    if (hi < j) hi = j;
                    while (hi < m && buf[hi] <= buf[j] + eff) ++hi;
                    if (hi - j > bestcnt) { bestcnt = hi - j; best = j; }
                }
                base = (buf[best] / 128) * 128;
            }
            if (base >= n_src) base = 0;
            if (base > maxbase) base = maxbase;
            if (base < 0) base = 0;
            bases[c] = base;
        }
    }

    // pass 1b: anchor clamp — bound each care-chunk's base to the
    // running lower-median of the surrounding +/-ANCHOR_W care-chunk
    // medians over the VALID window only (no edge replication: a
    // replicated edge window lets an outlier at either end of the
    // stream dominate its own anchor).  Outlier-driven far-ahead
    // bases drag the monotone prefetch head with them and strip ring
    // residency from every trailing chunk within the ring span;
    // clamped, the outliers only cost their own patch rows.  Must
    // stay bit-identical to ops/pallas_gather._anchor_clamp_bases.
    {
        const int64_t W = 16;           // ANCHOR_W
        const int64_t AHEAD = 4096;     // ANCHOR_AHEAD
        const int64_t K = (int64_t)care_chunks.size();
        int64_t maxbase = n_al - span > 0 ? n_al - span : 0;
        std::vector<int64_t> win;
        win.reserve(2 * W + 1);
        for (int64_t i = 0; i < K; ++i) {
            int64_t lo_i = i - W > 0 ? i - W : 0;
            int64_t hi_i = i + W < K - 1 ? i + W : K - 1;
            win.assign(chunk_med.begin() + lo_i,
                       chunk_med.begin() + hi_i + 1);
            int64_t mi = (int64_t)(win.size() - 1) / 2;
            std::nth_element(win.begin(), win.begin() + mi, win.end());
            int64_t anchor = win[mi];
            int64_t lo = anchor - AHEAD > 0 ? anchor - AHEAD : 0;
            int64_t hi = anchor + AHEAD;
            int64_t b = bases[care_chunks[i]];
            if (b < lo) b = lo;
            if (b > hi) b = hi;
            b = (b / 128) * 128;
            if (b < 0) b = 0;
            if (b > maxbase) b = maxbase;
            bases[care_chunks[i]] = (int32_t)b;
        }
    }

    // pass 2: ring heads (running max of seg_hi) per step, then the
    // main-ring residency bound per chunk
    std::vector<int64_t> step_hi(n_steps), next_head(n_steps);
    {
        int64_t head = 0;
        for (int64_t s = 0; s < n_steps; ++s) {
            for (int64_t k = 0; k < cps; ++k) {
                int64_t sh = (int64_t)(bases[s * cps + k] + span) / 128;
                if (sh > head) head = sh;
            }
            step_hi[s] = head;
        }
        for (int64_t s = 0; s + 1 < n_steps; ++s)
            next_head[s] = step_hi[s + 1];
        next_head[n_steps - 1] = step_hi[n_steps - 1];
    }

    // pass 3: row classification (cov / patch), running patch
    // positions, per-chunk patch bases
    std::vector<int32_t> ppos_row(Rp, -1);   // patch pos per patch row
    std::vector<uint8_t> has_patch(nc, 0);
    int64_t n_patch_rows = 0;
    for (int64_t c = 0; c < nc; ++c) {
        int64_t s = c / cps;
        bool resident = (int64_t)(bases[c] / 128)
                        >= next_head[s] - ring_segs;
        int32_t first_ppos = -1;
        for (int j = 0; j < 128; ++j) {
            int64_t r = c * 128 + j;
            bool cr = (r < R) && care[r];
            int32_t v = (r < R) ? idx[r] : 0;
            int64_t off = (int64_t)v - bases[c];
            bool cov = cr && resident && off >= 0 && off < span;
            if (cr && !cov) {
                ppos_row[r] = (int32_t)n_patch_rows;
                if (first_ppos < 0) first_ppos = (int32_t)n_patch_rows;
                ++n_patch_rows;
            }
        }
        if (first_ppos >= 0) {
            has_patch[c] = 1;
            pbases[c] = (first_ppos / 128) * 128;
        } else {
            pbases[c] = 0;
        }
    }

    // pass 4: patch-ring heads + residency, then the final per-row
    // rewrite / target staging / uncovered fixup list
    std::vector<int64_t> p_step_hi(n_steps), p_next(n_steps);
    {
        int64_t head = 0;
        for (int64_t s = 0; s < n_steps; ++s) {
            for (int64_t k = 0; k < cps; ++k) {
                int64_t c = s * cps + k;
                int64_t ph = has_patch[c]
                    ? (int64_t)(pbases[c] + patch_chunk_segs * 128) / 128
                    : 0;
                if (ph > head) head = ph;
            }
            p_step_hi[s] = head;
        }
        for (int64_t s = 0; s + 1 < n_steps; ++s)
            p_next[s] = p_step_hi[s + 1];
        p_next[n_steps - 1] = p_step_hi[n_steps - 1];
    }
    int64_t n_uncov = 0;
    for (int64_t c = 0; c < nc; ++c) {
        int64_t s = c / cps;
        bool p_res = (int64_t)(pbases[c] / 128) >= p_next[s] - patch_segs;
        for (int j = 0; j < 128; ++j) {
            int64_t r = c * 128 + j;
            int32_t pp = ppos_row[r];
            if (pp < 0) continue;               // not a patch row
            int32_t v = idx[r];                 // patch rows are < R
            if (pp < patch_cap) targets[pp] = v;
            bool fit = (pp - pbases[c]) < patch_chunk_segs * 128;
            if (p_res && fit) {
                idx_patched[r] = patch_lane0 + pp;
            } else {
                if (n_uncov < uncov_cap) uncov[n_uncov] = (int32_t)r;
                ++n_uncov;
            }
        }
    }

    // pass 5: DMA descriptors (split at the ring wrap; empty copies
    // encoded as idempotent 1-segment re-copies), [main | patch] per
    // step
    for (int pass = 0; pass < 2; ++pass) {
        const std::vector<int64_t>& hi_v = pass ? p_step_hi : step_hi;
        int64_t segs = pass ? patch_segs : ring_segs;
        int64_t h0 = pass ? (p_step_hi[0] > 1 ? p_step_hi[0] : 1)
                          : step_hi[0];
        int64_t prev = h0 - segs > 0 ? h0 - segs : 0;
        for (int64_t s = 0; s < n_steps; ++s) {
            int64_t hi_s = hi_v[s];
            if (pass && hi_s < 1) hi_s = 1;     // np.maximum(p_step_hi, 1)
            int64_t lo = prev;
            if (lo < hi_s - segs) lo = hi_s - segs;
            int64_t ln = hi_s - lo;
            if (ln <= 0) {      // numpy: lo=max(hi-1,0), ln=min(1,max(hi,1))=1
                lo = hi_s - 1 > 0 ? hi_s - 1 : 0;
                ln = 1;
            }
            int64_t r_lo = lo % segs;
            int64_t first = ln < segs - r_lo ? ln : segs - r_lo;
            int32_t* d = dmas + s * 8 + pass * 4;
            d[0] = (int32_t)lo;
            d[1] = (int32_t)first;
            d[2] = (int32_t)(lo + first);
            d[3] = (int32_t)(ln - first);
            if (ln - first == 0) {
                d[2] = (int32_t)(lo + first - 1 > 0 ? lo + first - 1 : 0);
                d[3] = (int32_t)(lo + first < 1 ? lo + first : 1);
            }
            prev = hi_s;
        }
    }
    *n_patch_out = n_patch_rows;
    *n_uncov_out = n_uncov;
}

// ---------------------------------------------------------------------
// Bounded k-th-nearest-neighbor field (the wrap_start density field,
// counterpart of the reference's cKDTree query in
// ch_shrinkwrap/holepunch.py:88-112).  Exact within
// `bound`: out[q] = distance from queries[q] to its k-th nearest point
// if that lies within `bound`, else 2*bound (caller clamps — matching
// scipy's distance_upper_bound -> inf semantics).
//
// Design for the wrap_start workload (1e6 points on a thin shell,
// ~120k grid-node queries, most of them deep inside the hollow
// interior where a kd-tree's bounded search is at its WORST): points
// are counting-sorted into a uniform cell grid once, a 2-pass
// chessboard distance transform over cell occupancy gives every query
// an O(1) lower bound that rejects interior/exterior nodes
// immediately, and the survivors run an expanding-ring search with a
// k-element max-heap and exact cell-AABB pruning.
// The grid/transform build depends only on the point set; the punch
// pass queries the SAME 1e6-point cloud at every boundary, so the
// build is exposed as a reusable handle (knn_field_build/query/free)
// with knn_field_native kept as the one-shot compatibility wrapper.
struct KnnFieldHandle {
    std::vector<float> pts;   // owned copy, (n, 3)
    int64_t n_pts;
    float lo[3];
    float hi[3];
    float cell;
    int dims[3];
    std::vector<int32_t> starts, order, cheb;
};

void* knn_field_build_native(const float* pts, int64_t n_pts) {
    if (n_pts <= 0) return nullptr;
    KnnFieldHandle* h = new KnnFieldHandle();
    h->pts.assign(pts, pts + 3 * n_pts);
    h->n_pts = n_pts;
    float* lo = h->lo;
    float* hi = h->hi;
    for (int d = 0; d < 3; ++d) lo[d] = hi[d] = pts[d];
    for (int64_t i = 1; i < n_pts; ++i)
        for (int d = 0; d < 3; ++d) {
            float v = pts[3 * i + d];
            if (v < lo[d]) lo[d] = v;
            if (v > hi[d]) hi[d] = v;
        }
    float maxext = 1e-6f;
    for (int d = 0; d < 3; ++d)
        if (hi[d] - lo[d] > maxext) maxext = hi[d] - lo[d];
    // ~n_pts cells (1 pt/cell average), dims capped
    int target_dim = (int)std::cbrt((double)n_pts) + 1;
    if (target_dim > 256) target_dim = 256;
    if (target_dim < 4) target_dim = 4;
    float cell = maxext / (float)target_dim;
    if (cell <= 0) cell = 1.0f;
    h->cell = cell;
    int* dims = h->dims;
    for (int d = 0; d < 3; ++d) {
        dims[d] = (int)((hi[d] - lo[d]) / cell) + 1;
        if (dims[d] < 1) dims[d] = 1;
    }
    const int64_t sy = dims[2], sx = (int64_t)dims[1] * dims[2];
    const int64_t ncells = (int64_t)dims[0] * sx;

    auto cell_coord = [&](const float* p, int* c) {
        for (int d = 0; d < 3; ++d) {
            int v = (int)((p[d] - lo[d]) / cell);
            if (v < 0) v = 0;
            if (v >= dims[d]) v = dims[d] - 1;
            c[d] = v;
        }
    };

    // counting sort of points into cells
    std::vector<int32_t> cell_of(n_pts);
    std::vector<int32_t>& starts = h->starts;
    starts.assign(ncells + 1, 0);
    for (int64_t i = 0; i < n_pts; ++i) {
        int c[3];
        cell_coord(pts + 3 * i, c);
        int64_t ci = c[0] * sx + c[1] * sy + c[2];
        cell_of[i] = (int32_t)ci;
        ++starts[ci + 1];
    }
    for (int64_t c = 0; c < ncells; ++c) starts[c + 1] += starts[c];
    std::vector<int32_t>& order = h->order;
    order.resize(n_pts);
    {
        std::vector<int32_t> cur(starts.begin(), starts.end() - 1);
        for (int64_t i = 0; i < n_pts; ++i)
            order[cur[cell_of[i]]++] = (int32_t)i;
    }

    // chessboard distance transform (in cells) to the nearest occupied
    // cell: 2-pass raster scan with the 13+13 half-neighborhoods.  A
    // query in cell c is >= (cheb[c]-1)*cell away from every point.
    const int32_t INF = 1 << 29;
    std::vector<int32_t>& cheb = h->cheb;
    cheb.resize(ncells);
    for (int64_t c = 0; c < ncells; ++c)
        cheb[c] = (starts[c + 1] > starts[c]) ? 0 : INF;
    auto relax_pass = [&](bool forward) {
        int x0 = forward ? 0 : dims[0] - 1, x1 = forward ? dims[0] : -1;
        int step = forward ? 1 : -1;
        for (int x = x0; x != x1; x += step)
            for (int y = forward ? 0 : dims[1] - 1;
                 y != (forward ? dims[1] : -1); y += step)
                for (int z = forward ? 0 : dims[2] - 1;
                     z != (forward ? dims[2] : -1); z += step) {
                    int64_t c = x * sx + y * sy + z;
                    int32_t best = cheb[c];
                    if (best == 0) continue;
                    // scan the 13 already-visited neighbors this pass
                    for (int dx = -1; dx <= 1; ++dx)
                        for (int dy = -1; dy <= 1; ++dy)
                            for (int dz = -1; dz <= 1; ++dz) {
                                if (dx == 0 && dy == 0 && dz == 0)
                                    continue;
                                // visited = lexicographically before in
                                // this pass's scan order
                                int key = dx * 9 + dy * 3 + dz;
                                if (forward ? key > 0 : key < 0)
                                    continue;
                                int nx2 = x + dx, ny2 = y + dy,
                                    nz2 = z + dz;
                                if (nx2 < 0 || nx2 >= dims[0]
                                    || ny2 < 0 || ny2 >= dims[1]
                                    || nz2 < 0 || nz2 >= dims[2])
                                    continue;
                                int32_t v =
                                    cheb[nx2 * sx + ny2 * sy + nz2] + 1;
                                if (v < best) best = v;
                            }
                    cheb[c] = best;
                }
    };
    relax_pass(true);
    relax_pass(false);
    return h;
}

void knn_field_free_native(void* hv) {
    delete static_cast<KnnFieldHandle*>(hv);
}

void knn_field_query_native(void* hv, const float* queries, int64_t n_q,
                            int k, float bound, float* out) {
    const float miss = 2.0f * bound;
    if (n_q <= 0) return;
    KnnFieldHandle* h = static_cast<KnnFieldHandle*>(hv);
    if (h == nullptr || h->n_pts < k || k <= 0 || bound <= 0) {
        for (int64_t q = 0; q < n_q; ++q) out[q] = miss;
        return;
    }
    const float* pts = h->pts.data();
    const float* lo = h->lo;
    const float* hi = h->hi;
    const float cell = h->cell;
    const int* dims = h->dims;
    const int64_t sy = dims[2], sx = (int64_t)dims[1] * dims[2];
    const std::vector<int32_t>& starts = h->starts;
    const std::vector<int32_t>& order = h->order;
    const std::vector<int32_t>& cheb = h->cheb;
    auto cell_coord = [&](const float* p, int* c) {
        for (int d = 0; d < 3; ++d) {
            int v = (int)((p[d] - lo[d]) / cell);
            if (v < 0) v = 0;
            if (v >= dims[d]) v = dims[d] - 1;
            c[d] = v;
        }
    };

    const float bound2 = bound * bound;
    std::vector<float> heap(k);   // max-heap of squared distances

    for (int64_t q = 0; q < n_q; ++q) {
        const float* Q = queries + 3 * q;
        int cq[3];
        cell_coord(Q, cq);
        // off-grid queries: account for the gap from Q to the clamped
        // cell (the chamfer bound below is measured from that cell)
        float off2 = 0.0f;
        for (int d = 0; d < 3; ++d) {
            float g = 0.0f;
            if (Q[d] < lo[d]) g = lo[d] - Q[d];
            else if (Q[d] > hi[d]) g = Q[d] - hi[d];
            off2 += g * g;
        }
        if (off2 > bound2) { out[q] = miss; continue; }
        int64_t cqi = cq[0] * sx + cq[1] * sy + cq[2];
        float lb = (float)(cheb[cqi] - 1) * cell;
        if (lb > 0 && lb * lb + off2 > bound2) { out[q] = miss; continue; }

        int hn = 0;
        float cur2 = bound2;    // current pruning radius^2
        int max_ring = (int)(bound / cell) + 2;
        int r0 = cheb[cqi] > 1 ? cheb[cqi] - 1 : 0;

        auto scan_cell = [&](int x, int y, int z) {
            if (x < 0 || x >= dims[0] || y < 0 || y >= dims[1]
                || z < 0 || z >= dims[2])
                return;
            int64_t ci = x * sx + y * sy + z;
            int32_t s = starts[ci], e = starts[ci + 1];
            if (s == e) return;
            // exact AABB minimum distance
            float mind2 = 0.0f;
            float cl[3] = {lo[0] + x * cell, lo[1] + y * cell,
                           lo[2] + z * cell};
            for (int d = 0; d < 3; ++d) {
                float g = 0.0f;
                if (Q[d] < cl[d]) g = cl[d] - Q[d];
                else if (Q[d] > cl[d] + cell) g = Q[d] - (cl[d] + cell);
                mind2 += g * g;
            }
            if (mind2 > cur2) return;
            for (int32_t ii = s; ii < e; ++ii) {
                const float* P = pts + 3 * (int64_t)order[ii];
                float dx = Q[0] - P[0], dy = Q[1] - P[1],
                      dz = Q[2] - P[2];
                float d2 = dx * dx + dy * dy + dz * dz;
                if (d2 > cur2) continue;
                if (hn < k) {
                    heap[hn++] = d2;
                    std::push_heap(heap.begin(), heap.begin() + hn);
                    if (hn == k) cur2 = heap[0];
                } else if (d2 < heap[0]) {
                    std::pop_heap(heap.begin(), heap.begin() + k);
                    heap[k - 1] = d2;
                    std::push_heap(heap.begin(), heap.begin() + k);
                    cur2 = heap[0];
                }
            }
        };

        for (int r = r0; r <= max_ring; ++r) {
            if (r > 0) {
                float ringlb = (float)(r - 1) * cell;
                if (ringlb * ringlb > cur2) break;
            }
            if (r == 0) {
                scan_cell(cq[0], cq[1], cq[2]);
                continue;
            }
            // canonical shell decomposition (each cell exactly once)
            for (int dx = -r; dx <= r; ++dx)
                for (int dy = -r; dy <= r; ++dy) {
                    scan_cell(cq[0] + dx, cq[1] + dy, cq[2] - r);
                    scan_cell(cq[0] + dx, cq[1] + dy, cq[2] + r);
                }
            for (int dx = -r; dx <= r; ++dx)
                for (int dz = -r + 1; dz <= r - 1; ++dz) {
                    scan_cell(cq[0] + dx, cq[1] - r, cq[2] + dz);
                    scan_cell(cq[0] + dx, cq[1] + r, cq[2] + dz);
                }
            for (int dy = -r + 1; dy <= r - 1; ++dy)
                for (int dz = -r + 1; dz <= r - 1; ++dz) {
                    scan_cell(cq[0] - r, cq[1] + dy, cq[2] + dz);
                    scan_cell(cq[0] + r, cq[1] + dy, cq[2] + dz);
                }
        }
        out[q] = (hn == k && heap[0] <= bound2)
                     ? std::sqrt(heap[0]) : miss;
    }
}

// one-shot compatibility wrapper (wrap_start, ad-hoc callers)
void knn_field_native(const float* pts, int64_t n_pts,
                      const float* queries, int64_t n_q,
                      int k, float bound, float* out) {
    if (n_q <= 0) return;
    if (n_pts < k || k <= 0 || bound <= 0) {
        const float miss = 2.0f * bound;
        for (int64_t q = 0; q < n_q; ++q) out[q] = miss;
        return;
    }
    void* h = knn_field_build_native(pts, n_pts);
    knn_field_query_native(h, queries, n_q, k, bound, out);
    knn_field_free_native(h);
}

// Hilbert codes from pre-quantized (n,3) uint32 coordinates (Skilling,
// "Programming the Hilbert curve", 2004).  Bit-exact twin of the numpy
// loops in ops.correspondence.hilbert_order — the quantization stays in
// numpy (vector ops are cheap there); the 9x3-pass transpose transform
// and the 3*bits-pass bit interleave are the wall-clock and go here.
static inline uint64_t hilbert_one(uint32_t x0, uint32_t x1, uint32_t x2,
                                   int bits) {
    const uint32_t M = 1u << (bits - 1);
    uint32_t X[3] = {x0, x1, x2};
    // inverse undo
    for (uint32_t Q = M; Q > 1; Q >>= 1) {
        const uint32_t P = Q - 1;
        for (int i = 0; i < 3; ++i) {
            if (X[i] & Q) {
                X[0] ^= P;
            } else {
                const uint32_t t = (X[0] ^ X[i]) & P;
                X[0] ^= t;
                X[i] ^= t;
            }
        }
    }
    // Gray encode
    X[1] ^= X[0];
    X[2] ^= X[1];
    uint32_t t = 0;
    for (uint32_t Q = M; Q > 1; Q >>= 1)
        if (X[2] & Q) t ^= Q - 1;
    X[0] ^= t;
    X[1] ^= t;
    X[2] ^= t;
    // transpose-interleave, axis 0 holds MSBs
    uint64_t code = 0;
    for (int b = bits - 1; b >= 0; --b)
        for (int i = 0; i < 3; ++i)
            code = (code << 1) | ((X[i] >> b) & 1u);
    return code;
}

void hilbert_codes_native(const uint32_t* Xin, int64_t n, int bits,
                          uint64_t* out) {
    for (int64_t j = 0; j < n; ++j)
        out[j] = hilbert_one(Xin[3 * j], Xin[3 * j + 1], Xin[3 * j + 2],
                             bits);
}

// Fused face-centroid Hilbert codes: centroid + bbox + quantize +
// code in two streaming passes, replacing the per-remesh-boundary
// numpy chain in mesh.core.spatial_sort (fc = v[f].mean(1) gather +
// float64 convert + separate code pass — measured ~110 ms of the
// ~170 ms boundary sort at 164k verts; this pass runs in ~8 ms).
// Matches the numpy path bit-for-bit: float32 (a+b)+c then /3
// centroid (numpy mean over a 3-row axis), float64 quantization with
// the same expression tree as ops.correspondence.hilbert_codes_for.
void face_hilbert_codes_native(const float* verts, const int32_t* faces,
                               int64_t nf, int bits, uint64_t* out) {
    double lo[3] = {1e300, 1e300, 1e300};
    double hi[3] = {-1e300, -1e300, -1e300};
    std::vector<float> cent(3 * nf);
    for (int64_t f = 0; f < nf; ++f) {
        const float* p0 = verts + 3 * faces[3 * f];
        const float* p1 = verts + 3 * faces[3 * f + 1];
        const float* p2 = verts + 3 * faces[3 * f + 2];
        for (int k = 0; k < 3; ++k) {
            float c = ((p0[k] + p1[k]) + p2[k]) / 3.0f;
            cent[3 * f + k] = c;
            double cd = (double)c;
            if (cd < lo[k]) lo[k] = cd;
            if (cd > hi[k]) hi[k] = cd;
        }
    }
    const double scale = (double)((1u << bits) - 1);
    double inv[3];
    for (int k = 0; k < 3; ++k) {
        double d = hi[k] - lo[k];
        inv[k] = d > 1e-12 ? d : 1e-12;
    }
    for (int64_t f = 0; f < nf; ++f) {
        uint32_t X[3];
        for (int k = 0; k < 3; ++k) {
            double c = (double)cent[3 * f + k];
            X[k] = (uint32_t)((c - lo[k]) / inv[k] * scale);
        }
        out[f] = hilbert_one(X[0], X[1], X[2], bits);
    }
}

// Gaussian curvature per vertex: host C++ twin of the K-only subset of
// ops/curvature.py::curvature_grad (method='lsq', itself the rebuild
// of the reference's c_curvature_grad one-ring Taubin pass,
// ch_shrinkwrap/membrane_mesh_utils.c:915-1250).  The
// fit loop uses it for the neck diagnostic at remesh boundaries
// (remove_necks consumes only K, pyx:1201-1219) so the CG block does
// not need the folded device curvature program — measured 4.2 MB of
// TPU executable (a ~7 s load through the remote compile service) plus
// per-block device time, vs ~40 ms/boundary here.
//
// verts: (nv,3) f32; faces: (nf,3) i32 (no padding rows);
// nbr_v: (nv,K) i32 one-ring neighbor ids, -1 padded; K_out: (nv) f32.
void gaussian_k_native(const float* verts, int nv,
                       const int32_t* faces, int nf,
                       const int32_t* nbr_v, int K,
                       float* K_out) {
    const Vec3* pos = reinterpret_cast<const Vec3*>(verts);
    // angle-weighted vertex normals (ops/normals.py::vertex_normals)
    std::vector<Vec3> vn(nv, Vec3{0.f, 0.f, 0.f});
    for (int f = 0; f < nf; ++f) {
        int a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
        Vec3 tri[3] = {pos[a], pos[b], pos[c]};
        Vec3 n = (tri[1] - tri[0]).cross(tri[2] - tri[0]);
        float nn = n.norm();
        if (nn < 1e-12f) continue;
        Vec3 fn = n * (1.f / nn);
        int vid[3] = {a, b, c};
        for (int k = 0; k < 3; ++k) {
            Vec3 e_next = tri[(k + 1) % 3] - tri[k];
            Vec3 e_prev = tri[(k + 2) % 3] - tri[k];
            float dot = e_next.dot(e_prev);
            float sin = e_next.cross(e_prev).norm();
            float ang = std::atan2(sin, dot);
            vn[vid[k]] = vn[vid[k]] + fn * ang;
        }
    }
    for (int v = 0; v < nv; ++v) {
        float nn = vn[v].norm();
        vn[v] = nn > 1e-12f ? vn[v] * (1.f / nn) : Vec3{0.f, 0.f, 0.f};
    }

    for (int v = 0; v < nv; ++v) {
        const Vec3 vi = pos[v], Nvi = vn[v];
        // Householder tangent frame (curvature.py:57-74)
        float sign = Nvi.x >= 0.f ? 1.f : -1.f;
        Vec3 u{Nvi.x + sign, Nvi.y, Nvi.z};
        float uu = u.norm2() > 1e-24f ? u.norm2() : 1.f;
        Vec3 e1{-2.f * u.x * u.y / uu, 1.f - 2.f * u.y * u.y / uu,
                -2.f * u.z * u.y / uu};
        Vec3 e2{-2.f * u.x * u.z / uu, -2.f * u.y * u.z / uu,
                1.f - 2.f * u.z * u.z / uu};

        float t1[32], t2[32], ke[32], w_r[32];
        int m = 0;
        float r_sum = 0.f;
        for (int j = 0; j < K; ++j) {
            int32_t nj = nbr_v[(int64_t)v * K + j];
            if (nj < 0) continue;
            Vec3 dv = pos[nj] - vi;
            float ld = dv.norm();
            float inv = 1.f / (ld > 1e-12f ? ld : 1e-12f);
            r_sum += inv;
            Vec3 dh = dv * inv;
            float ndotdv = Nvi.dot(dv);
            // tangent direction: -(dv - (N.dv) N), normalized
            Vec3 T = (dv - Nvi * ndotdv) * -1.f;
            float tn = T.norm();
            Vec3 Tij = tn > 1e-12f ? T * (1.f / tn) : Vec3{0.f, 0.f, 0.f};
            // chord-length normal difference (curvature.py:142-147)
            float d = Nvi.dot(dh);
            float inner = std::sqrt(std::fmax(0.f,
                              std::fmin(1.f, 1.f - d * d)));
            float ndiff = std::sqrt(std::fmax(0.f, 2.f - 2.f * inner));
            float kj = 2.f * (ndotdv > 0.f ? -1.f
                              : (ndotdv < 0.f ? 1.f : 0.f))
                       * ndiff * inv;
            t1[m] = Tij.dot(e1);
            t2[m] = Tij.dot(e2);
            ke[m] = kj;
            w_r[m] = inv;
            ++m;
        }
        if (m == 0) { K_out[v] = 0.f; continue; }

        // weighted LSQ of the second fundamental form (normal
        // equations via 3x3 adjugate, curvature.py:180-221)
        double g00 = 0, g01 = 0, g02 = 0, g11 = 0, g12 = 0, g22 = 0;
        double r0 = 0, r1 = 0, r2 = 0;
        double m00 = 0, m01 = 0, m11 = 0;
        for (int j = 0; j < m; ++j) {
            double w = w_r[j] / r_sum;
            double X0 = (double)t1[j] * t1[j];
            double X1 = 2.0 * t1[j] * t2[j];
            double X2 = (double)t2[j] * t2[j];
            double y = ke[j];
            g00 += w * X0 * X0; g01 += w * X0 * X1; g02 += w * X0 * X2;
            g11 += w * X1 * X1; g12 += w * X1 * X2; g22 += w * X2 * X2;
            r0 += w * X0 * y; r1 += w * X1 * y; r2 += w * X2 * y;
            double wk = w * y;
            m00 += wk * X0;         // wk * t1 * t1
            m01 += wk * t1[j] * t2[j];
            m11 += wk * X2;
        }
        double c00 = g11 * g22 - g12 * g12;
        double c01 = g02 * g12 - g01 * g22;
        double c02 = g01 * g12 - g02 * g11;
        double c11 = g00 * g22 - g02 * g02;
        double c12 = g01 * g02 - g00 * g12;
        double c22 = g00 * g11 - g01 * g01;
        double det = g00 * c00 + g01 * c01 + g02 * c02;
        double a, b, c;
        if (std::fabs(det) > 1e-10) {
            double invd = 1.0 / det;
            a = (c00 * r0 + c01 * r1 + c02 * r2) * invd;
            b = (c01 * r0 + c11 * r1 + c12 * r2) * invd;
            c = (c02 * r0 + c12 * r1 + c22 * r2) * invd;
        } else {
            // Taubin fallback on singular rings (curvature.py:211-219)
            double disc = std::sqrt((m00 - m11) * (m00 - m11)
                                    + 4.0 * m01 * m01);
            double l1 = 0.5 * (m00 + m11 - disc);
            double l2 = 0.5 * (m00 + m11 + disc);
            a = 3.0 * l1 - l2;
            b = 0.0;
            c = 3.0 * l2 - l1;
        }
        // K = k0 * k1 = det of the 2x2 form [[a, b], [b, c]]
        K_out[v] = (float)(a * c - b * b);
    }
}

// ---- fused stream prep for the ring-gather schedules ----
// (ops/meshdata.fit_ring_schedules).  Each replaces a chain of numpy
// allocations/copies (clip copy + care-mask alloc + block-interleave
// transpose copies) with ONE pass into caller-reused scratch buffers
// (~0.1 s/boundary of the warm e2e was these copies, 2026-08-20
// cProfile).  Semantics match the numpy formulations exactly.

// Block-interleaved k-major stream of tbl[:, :k_take] (row stride
// k_src), negatives clamped to 0, care = (entry >= 0):
//   out[(v/block)*k_take*block + k*block + v%block]
//     = max(tbl[v*k_src + k], 0)
// == ops/pallas_gather.blocked_kmajor_stream(clip(tbl[:, :k_take]),
//                                            tbl[:, :k_take] >= 0).
void kmaj_stream_clip_native(const int32_t* tbl, int64_t v_rows,
                             int32_t k_src, int32_t k_take,
                             int64_t block, int32_t* idx_out,
                             uint8_t* care_out) {
    const int64_t nb = v_rows / block;
    for (int64_t b = 0; b < nb; ++b) {
        const int32_t* src = tbl + b * block * k_src;
        int32_t* dst = idx_out + b * block * k_take;
        uint8_t* cst = care_out + b * block * k_take;
        for (int64_t k = 0; k < k_take; ++k) {
            for (int64_t v = 0; v < block; ++v) {
                int32_t x = src[v * k_src + k];
                cst[k * block + v] = (uint8_t)(x >= 0);
                dst[k * block + v] = x >= 0 ? x : 0;
            }
        }
    }
}

// Flat stream with clip + care (the fold/incidence stream):
// idx = clip(tbl, 0), care = tbl >= 0.
void flat_stream_clip_native(const int32_t* tbl, int64_t n,
                             int32_t* idx_out, uint8_t* care_out) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t x = tbl[i];
        care_out[i] = (uint8_t)(x >= 0);
        idx_out[i] = x >= 0 ? x : 0;
    }
}

// np.repeat(mask, 3) as uint8 (the faces-stream care mask).
void repeat3_mask_native(const uint8_t* mask, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        uint8_t m = mask[i] ? 1 : 0;
        out[3 * i] = m;
        out[3 * i + 1] = m;
        out[3 * i + 2] = m;
    }
}

// Strided column extract (the per-corner faces streams):
// out[i] = tbl[i*stride + col].
void strided_col_native(const int32_t* tbl, int64_t n, int32_t stride,
                        int32_t col, int32_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = tbl[i * stride + col];
}

// One-ring average of per-vertex scalar data (incl. self), bit-exact
// twin of mesh.core.TriangleMesh.smooth_per_vertex_data (float64
// accumulation in neighbor-slot order, cast to f32): the boundary
// neck-K smoothing pass cost ~40 ms/boundary in numpy at 131k verts.
void smooth_vertex_data_native(const float* data, const int32_t* nbr_v,
                               int64_t nv, int32_t K, int32_t n_iter,
                               float* out) {
    std::vector<double> cur(nv), nxt(nv);
    for (int64_t v = 0; v < nv; ++v) cur[v] = (double)data[v];
    for (int32_t it = 0; it < n_iter; ++it) {
        for (int64_t v = 0; v < nv; ++v) {
            double acc = cur[v];
            int cnt = 1;
            const int32_t* row = nbr_v + v * K;
            for (int32_t k = 0; k < K; ++k) {
                int32_t nj = row[k];
                if (nj >= 0) { acc += cur[nj]; ++cnt; }
            }
            nxt[v] = acc / cnt;
        }
        cur.swap(nxt);
    }
    for (int64_t v = 0; v < nv; ++v) out[v] = (float)cur[v];
}

// Non-manifold-vertex detection: a vertex is manifold iff its incident
// faces form a single fan.  Count fans by walking h -> next(twin(h))
// orbits over outgoing halfedges (the union-find construction in
// mesh.core._has_nonmanifold_vertices, which cost ~2 s of pure-Python
// find() at 131k verts per is_manifold call in the eval harness).
// he arrays are the packed halfedge tables; n = halfedge count.
// Returns 1 if any vertex has more than one fan, else 0.
int32_t has_nonmanifold_vertices_native(const int32_t* he_src,
                                        const int32_t* he_vertex,
                                        const int32_t* he_twin,
                                        const int32_t* he_next,
                                        int64_t n, int64_t nv) {
    // fan labeling: iterate orbits of the permutation
    // p(h) = next(twin(h)) restricted to halfedges with twins; count
    // distinct orbits per source vertex.
    std::vector<int32_t> orbit(n, -1);
    int32_t n_orbits = 0;
    for (int64_t h0 = 0; h0 < n; ++h0) {
        if (orbit[h0] >= 0 || he_src[h0] < 0) continue;
        int32_t label = n_orbits++;
        int64_t h = h0;
        // forward walk
        while (h >= 0 && orbit[h] < 0) {
            orbit[h] = label;
            int32_t tw = he_twin[h];
            if (tw < 0) break;
            h = he_next[tw];
            if (h >= 0 && he_src[h] != he_src[h0]) break;  // corrupt
        }
        // backward walk (orbits may be open chains at boundaries):
        // predecessor of h is twin(prev-of-orbit); find q with
        // next(twin(q)) == h0  <=>  twin(h0 is next of) ... walk via
        // twin(h0)'s prev is not available — use twin of the edge
        // arriving at src: q = twin's candidates; instead walk using
        // the inverse permutation q = twin(prevs) is O(1) only with
        // prev: approximate by walking from h0 via twin(h0)->... the
        // packed tables carry next only, so recover prev via two
        // nexts (triangles: prev == next(next)).
        int64_t q = h0;
        while (true) {
            int32_t pv = he_next[he_next[q]];      // prev(q)
            int32_t tw = he_twin[pv];
            if (tw < 0) break;
            q = tw;
            if (orbit[q] >= 0 || he_src[q] != he_src[h0]) break;
            orbit[q] = label;
        }
    }
    // count fans and used-vertex flags
    std::vector<int32_t> first_label(nv, -1);
    std::vector<uint8_t> multi(nv, 0);
    for (int64_t h = 0; h < n; ++h) {
        int32_t s = he_src[h];
        if (s < 0 || s >= nv) continue;
        int32_t lb = orbit[h];
        if (first_label[s] < 0) first_label[s] = lb;
        else if (first_label[s] != lb) multi[s] = 1;
    }
    for (int64_t v = 0; v < nv; ++v)
        if (multi[v]) return 1;
    return 0;
}

}  // extern "C"


// ---------------------------------------------------------------------
// Vertex removal and hole repair: mesh.core.TriangleMesh.repair, bit
// for bit the arrays of its numpy passes (TriangleMesh._repair_numpy).
//
// The numpy passes rebuild the whole mesh several times a pass.  Here
// faces keep their ids (killed faces drop out, fill triangles append,
// so the live faces stay in the numpy passes' order) and vertices keep
// theirs (split copies append in the order the numpy split numbers
// them), so one compaction at the end gives the same arrays.  What a
// pass reads about a vertex (the twins of its outgoing halfedges, its
// fans, the faces on its edges) depends on the faces around it alone.
// Every edit logs the corners of the faces it kills, adds or rewrites,
// and each check re-derives only what the log names since it last
// ran.  Only the first look is global: face hygiene, the boundary and
// the pinch candidates in one sweep over the vertices, and one
// union-find for the debris.
namespace {

constexpr int kDebrisFaces = 8;    // components under this many faces go
constexpr int kFanRounds = 64;     // the numpy split's propagation rounds
// a fan of at most this many halfedges converges within kFanRounds
constexpr int kFanConverges = kFanRounds + 1;
// below this many live faces the debris check runs over the whole mesh
constexpr int64_t kDebrisGlobal = 64;

enum { kHoles, kPasses, kAdded, kSplit, kRepairCounts };

// a boundary walk that does not close, or a pass that fills nothing:
// the numpy passes erode there, and the hygiene leaves neither
struct OpenWalk {};

// an outgoing halfedge with its face's other corners (its dst and its
// prev's src), as the input had them
struct OutEdge { int32_t h, b, c; };

struct RepairEngine {
    int32_t nv0 = 0;                  // input vertices
    int32_t nvt = 0;                  // vertex ids in use (input + copies)
    std::vector<int32_t> F;           // 3 a face, every face ever made
    std::vector<uint8_t> alive;
    int64_t n_alive = 0;
    std::vector<int32_t> origin;      // copy (id - nv0) -> input vertex
    // outgoing halfedges by source: the input's, then a list of its own
    // for each vertex whose faces changed (fills, splits); dead faces
    // are skipped on reading
    std::vector<int32_t> off;
    std::vector<OutEdge> lst;
    std::vector<int32_t> dyn_idx;
    std::vector<std::vector<int32_t>> dyn;
    bool compacted = false;           // numpy has dropped unused vertices
    bool edited = false;              // removal included
    bool edited_since_init = false;   // a face killed, added or split
    std::vector<int32_t> uf;          // the first look's union-find
    std::vector<int32_t> touched;     // corners of edited faces
    std::vector<int32_t> added;       // appended faces
    size_t cur_bnd = 0, cur_debris = 0, cur_split = 0, cur_hyg = 0;
    bool hyg_first = true, debris_first = true, split_first = true;
    std::vector<uint8_t> hyg0;        // the first hygiene's flags
    std::vector<int32_t> pinch0;      // the first split's candidates
    std::vector<uint8_t> is_bnd;      // per halfedge, valid while live
    std::vector<int32_t> bnd;         // boundary halfedges (candidates)
    std::vector<int32_t> vstamp, fstamp;
    int32_t stamp = 0;
    int64_t counts[kRepairCounts] = {0, 0, 0, 0};
    // one vertex's live outgoing halfedges, their far corners (dst and
    // prev's src), and per halfedge: the one whose prev is its twin
    // (-1 without a twin), and the halfedges on its undirected edge
    std::vector<int32_t> sH, sB, sC, sP, sN;
    std::vector<int32_t> fan_inv, fan_seen;

    static int32_t nxt(int32_t h) { return h % 3 == 2 ? h - 2 : h + 1; }
    static int32_t prv(int32_t h) { return h % 3 == 0 ? h + 2 : h - 1; }

    template <class Fn> void for_out(int32_t v, Fn&& fn) const {
        int32_t d = dyn_idx[v];
        if (d >= 0) {
            for (int32_t h : dyn[d])
                if (alive[h / 3]) fn(h);
        } else if (v < nv0) {
            for (int32_t p = off[v]; p < off[v + 1]; ++p)
                if (alive[lst[p].h / 3]) fn(lst[p].h);
        }
    }

    bool live_vertex(int32_t v) const {
        bool any = false;
        for_out(v, [&](int32_t) { any = true; });
        return any;
    }

    std::vector<int32_t>& own_list(int32_t v) {
        if (dyn_idx[v] < 0) {
            std::vector<int32_t> l;
            for_out(v, [&](int32_t h) { l.push_back(h); });
            dyn_idx[v] = (int32_t)dyn.size();
            dyn.push_back(std::move(l));
        }
        return dyn[dyn_idx[v]];
    }

    // sH.. of vertex v; sP[i] = j when halfedge i's directed edge is the
    // only one each way (numpy's twin: prev(sH[j])), sN[i] = halfedges
    // on its undirected edge (numpy's hygiene count)
    int gather(int32_t v) {
        sH.clear(); sB.clear(); sC.clear();
        for_out(v, [&](int32_t h) {
            sH.push_back(h);
            sB.push_back(F[nxt(h)]);
            sC.push_back(F[prv(h)]);
        });
        const int k = (int)sH.size();
        sP.assign(k, -1);
        sN.assign(k, 0);
        for (int i = 0; i < k; ++i) {
            const int32_t b = sB[i];
            int nd = 0, nr = 0, jr = -1;
            for (int j = 0; j < k; ++j) {
                if (sB[j] == b) ++nd;
                if (sC[j] == b) { ++nr; jr = j; }
            }
            if (nd == 1 && nr == 1) sP[i] = jr;
            sN[i] = b == v ? nd : nd + nr;
        }
        return k;
    }

    void touch_face(int32_t f) {
        touched.push_back(F[3 * f]);
        touched.push_back(F[3 * f + 1]);
        touched.push_back(F[3 * f + 2]);
    }

    void kill(int32_t f) {
        if (!alive[f]) return;
        edited_since_init = true;
        alive[f] = 0;
        --n_alive;
        touch_face(f);
        compacted = edited = true;
    }

    void add(int32_t a, int32_t b, int32_t c) {
        const int32_t f = (int32_t)alive.size();
        F.push_back(a); F.push_back(b); F.push_back(c);
        alive.push_back(1);
        is_bnd.resize(F.size(), 0);
        fstamp.push_back(0);
        ++n_alive;
        edited_since_init = true;
        const int32_t cs[3] = {a, b, c};
        for (int k = 0; k < 3; ++k) own_list(cs[k]).push_back(3 * f + k);
        touch_face(f);
        added.push_back(f);
        compacted = edited = true;
    }

    void init(const int32_t* faces, int64_t nf, int32_t nv,
              const uint8_t* remove) {
        nv0 = nvt = nv;
        F.assign(faces, faces + 3 * nf);
        alive.assign(nf, 1);
        off.assign(nv + 1, 0);
        n_alive = 0;
        if (remove != nullptr) compacted = edited = true;
        for (int64_t f = 0; f < nf; ++f) {
            const int32_t* c = &F[3 * f];
            if (remove != nullptr && (remove[c[0]] || remove[c[1]]
                                      || remove[c[2]])) {
                alive[f] = 0;
                continue;
            }
            ++n_alive;
            ++off[c[0] + 1]; ++off[c[1] + 1]; ++off[c[2] + 1];
        }
        for (int32_t v = 0; v < nv; ++v) off[v + 1] += off[v];
        lst.resize(off[nv]);
        {
            std::vector<int32_t> cur(off.begin(), off.end() - 1);
            for (int64_t f = 0; f < nf; ++f) {
                if (!alive[f]) continue;
                const int32_t* c = &F[3 * f];
                const int32_t h = (int32_t)(3 * f);
                lst[cur[c[0]]++] = {h, c[1], c[2]};
                lst[cur[c[1]]++] = {h + 1, c[2], c[0]};
                lst[cur[c[2]]++] = {h + 2, c[0], c[1]};
            }
        }
        dyn_idx.assign(nv, -1);
        vstamp.assign(nv, 0);
        fstamp.assign(nf, 0);
        is_bnd.assign(3 * nf, 0);
        hyg0.assign(nf, 0);
        uf.resize(nv);
        for (int32_t v = 0; v < nv; ++v) uf[v] = v;

        // the first look: hygiene flags, boundary, pinch candidates,
        // components
        for (int64_t f = 0; f < nf; ++f) {
            const int32_t a = F[3 * f], b = F[3 * f + 1], c = F[3 * f + 2];
            if (alive[f] && (a == b || b == c || a == c)) hyg0[f] = 1;
        }
        for (int32_t v = 0; v < nv; ++v) {
            const int k = off[v + 1] - off[v];
            if (k == 0) continue;
            const OutEdge* e = &lst[off[v]];
            sP.resize(k);
            for (int i = 0; i < k; ++i) {
                const int32_t b = e[i].b;
                int nd = 0, nr = 0, jr = -1;
                for (int j = 0; j < k; ++j) {
                    nd += e[j].b == b;
                    nr += e[j].c == b;
                    jr = e[j].c == b ? j : jr;
                }
                sP[i] = (nd == 1 && nr == 1) ? jr : -1;
                const int32_t h = e[i].h;
                if (sP[i] < 0) { is_bnd[h] = 1; bnd.push_back(h); }
                if ((b == v ? nd : nd + nr) > 2) hyg0[h / 3] = 1;
                // a duplicate: an earlier face of the same vertex set,
                // looked for at the set's lowest vertex.  Through a
                // halfedge with a twin, only the twin's face can be
                // one (a same-winding copy would double the halfedge)
                const int32_t lo = std::min(b, e[i].c);
                if (lo < v) continue;
                // components: each face joined at its lowest corner
                uf_union(v, b);
                uf_union(v, e[i].c);
                const int32_t f = h / 3;
                if (sP[i] >= 0) {
                    const OutEdge& t = e[sP[i]];
                    if (t.b == e[i].c && t.h / 3 < f) hyg0[f] = 1;
                    continue;
                }
                const int32_t hi = std::max(b, e[i].c);
                for (int j = 0; j < k; ++j) {
                    if (e[j].h / 3 < f && std::min(e[j].b, e[j].c) == lo
                        && std::max(e[j].b, e[j].c) == hi) {
                        hyg0[f] = 1;
                        break;
                    }
                }
            }
            if (k > kFanConverges || !one_fan(k)) pinch0.push_back(v);
        }
        std::sort(bnd.begin(), bnd.end());
    }

    // sP's k halfedges form one orbit of h -> next(twin(h))
    bool one_fan(int k) {
        // sP is one-to-one, so the walk from halfedge 0 comes back to
        // it (a closed fan) or ends (a fan with a boundary)
        int n = 1, x = sP[0];
        while (x > 0) { x = sP[x]; ++n; }
        if (x == 0) return n == k;
        // an open fan: walk back from halfedge 0 too
        std::vector<int32_t>& inv = fan_inv;
        std::vector<int32_t>& seen = fan_seen;
        inv.assign(k, -1);
        seen.assign(k, 0);
        for (int i = 0; i < k; ++i)
            if (sP[i] >= 0) inv[sP[i]] = i;
        n = 1;
        x = 0;
        seen[0] = 1;
        while (sP[x] >= 0 && !seen[sP[x]]) { x = sP[x]; seen[x] = 1; ++n; }
        x = 0;
        while (inv[x] >= 0 && !seen[inv[x]]) { x = inv[x]; seen[x] = 1; ++n; }
        return n == k;
    }

    // stamps only grow within a call: a call makes far fewer than 2^31
    int32_t next_stamp() { return ++stamp; }

    int32_t uf_find(int32_t x) {
        while (uf[x] != x) {
            uf[x] = uf[uf[x]];
            x = uf[x];
        }
        return x;
    }

    void uf_union(int32_t a, int32_t b) {
        a = uf_find(a);
        b = uf_find(b);
        if (a != b) uf[std::max(a, b)] = std::min(a, b);
    }

    // degenerate | duplicate (not the first face of its vertex set) |
    // on an undirected edge of more than two halfedges; true when any
    // face went
    bool hygiene() {
        std::vector<int32_t> bad;
        if (hyg_first) {
            hyg_first = false;
            for (size_t f = 0; f < hyg0.size(); ++f)
                if (hyg0[f] && alive[f]) bad.push_back((int32_t)f);
            std::vector<uint8_t>().swap(hyg0);
        } else {
            // only faces appended since the last look can be bad: kills
            // and splits make no face bad, and a duplicate pair's later
            // face is the appended one
            for (size_t i = cur_hyg; i < added.size(); ++i) {
                const int32_t f = added[i];
                if (!alive[f]) continue;
                const int32_t c[3] = {F[3 * f], F[3 * f + 1], F[3 * f + 2]};
                if (c[0] == c[1] || c[1] == c[2] || c[0] == c[2]) {
                    bad.push_back(f);
                    continue;
                }
                const int32_t lo = std::min(c[0], std::min(c[1], c[2]));
                const int32_t hi = std::max(c[0], std::max(c[1], c[2]));
                const int32_t mid = (int32_t)((int64_t)c[0] + c[1] + c[2]
                                              - lo - hi);
                for_out(lo, [&](int32_t h) {
                    const int32_t g = h / 3;
                    const int32_t b = F[nxt(h)], cc = F[prv(h)];
                    if (g < f && std::min(b, cc) == mid
                        && std::max(b, cc) == hi)
                        bad.push_back(f);
                });
                for (int e = 0; e < 3; ++e) {
                    const int32_t a = c[e], b = c[(e + 1) % 3];
                    const int k = gather(a);
                    for (int i2 = 0; i2 < k; ++i2) {
                        if (sB[i2] != b || sN[i2] <= 2) continue;
                        for (int j = 0; j < k; ++j)
                            if (sB[j] == b || sC[j] == b)
                                bad.push_back(sH[j] / 3);
                        break;
                    }
                }
            }
        }
        cur_hyg = added.size();
        if (bad.empty()) return false;
        for (int32_t f : bad) kill(f);
        return true;
    }

    // components under kDebrisFaces faces, when there is more than one
    // component; true when any went (numpy's _drop_debris)
    bool debris() {
        if (debris_first || n_alive < kDebrisGlobal) {
            const bool first = debris_first;
            debris_first = false;
            cur_debris = touched.size();
            // the first look comes before any fill or split, so the
            // input's lists still hold every live face's corners
            return first && !edited_since_init ? debris_first_look()
                                               : debris_global();
        }
        // one stamp a search: a vertex stamped by an earlier search of
        // this look lies in a component of kDebrisFaces or more (the
        // small ones are closed, so no search reaches into them)
        const int32_t st0 = stamp + 1;
        std::vector<int32_t> small_faces, queue, comp_faces;
        int n_small = 0;
        const size_t end = touched.size();
        for (size_t t = cur_debris; t < end; ++t) {
            const int32_t s = touched[t];
            if (vstamp[s] >= st0 || !live_vertex(s)) continue;
            const int32_t cur = ++stamp;
            queue.clear();
            comp_faces.clear();
            queue.push_back(s);
            vstamp[s] = cur;
            bool is_big = false;
            for (size_t qi = 0; qi < queue.size() && !is_big; ++qi) {
                for_out(queue[qi], [&](int32_t h) {
                    if (is_big) return;
                    const int32_t g = h / 3;
                    if (fstamp[g] != cur) {
                        fstamp[g] = cur;
                        comp_faces.push_back(g);
                        if ((int)comp_faces.size() >= kDebrisFaces) {
                            is_big = true;
                            return;
                        }
                    }
                    const int32_t w[2] = {F[nxt(h)], F[prv(h)]};
                    for (int32_t x : w) {
                        if (vstamp[x] == cur) continue;
                        if (vstamp[x] >= st0) {
                            is_big = true;
                            return;
                        }
                        vstamp[x] = cur;
                        queue.push_back(x);
                    }
                });
            }
            if (is_big) continue;
            ++n_small;
            small_faces.insert(small_faces.end(), comp_faces.begin(),
                               comp_faces.end());
        }
        cur_debris = end;
        if (n_small == 0) return false;
        if (n_small == 1 && (int64_t)small_faces.size() == n_alive)
            return false;              // one component: numpy keeps it
        for (int32_t g : small_faces) kill(g);
        return true;
    }

    // the first look's components, from the sweep's union-find, while
    // no face has gone since
    bool debris_first_look() {
        std::vector<int64_t> corners(nv0, 0);
        for (int32_t v = 0; v < nv0; ++v)
            corners[uf_find(v)] += off[v + 1] - off[v];
        int64_t n = 0;
        bool any_small = false;
        for (int32_t v = 0; v < nv0; ++v) {
            if (uf[v] != v) continue;
            // numpy's vertices: every input vertex until its first
            // compaction, the used ones after
            if (corners[v] == 0 && compacted) continue;
            ++n;
            any_small |= corners[v] / 3 < kDebrisFaces;
        }
        if (n <= 1 || !any_small) return false;
        for (int32_t v = 0; v < nv0; ++v)
            if (corners[uf_find(v)] / 3 < kDebrisFaces)
                for (int32_t p = off[v]; p < off[v + 1]; ++p)
                    kill(lst[p].h / 3);
        compacted = edited = true;
        return true;
    }

    bool debris_global() {
        std::vector<int32_t> parent(nvt);
        for (int32_t v = 0; v < nvt; ++v) parent[v] = v;
        auto find = [&parent](int32_t x) {
            while (parent[x] != x) {
                parent[x] = parent[parent[x]];
                x = parent[x];
            }
            return x;
        };
        std::vector<uint8_t> used(nvt, 0);
        const int64_t nf = (int64_t)alive.size();
        for (int64_t f = 0; f < nf; ++f) {
            if (!alive[f]) continue;
            const int32_t a = F[3 * f], b = F[3 * f + 1], c = F[3 * f + 2];
            used[a] = used[b] = used[c] = 1;
            const int32_t ra = find(a), rb = find(b);
            if (ra != rb) parent[ra] = rb;
            const int32_t r = find(b), rc = find(c);
            if (rc != r) parent[rc] = r;
        }
        std::vector<int32_t> size(nvt, 0);
        for (int64_t f = 0; f < nf; ++f)
            if (alive[f]) ++size[find(F[3 * f])];
        // numpy's vertices: every input vertex until its first
        // compaction, the used ones after
        int64_t n = 0;
        bool any_small = false;
        for (int32_t v = 0; v < nvt; ++v) {
            if (!(used[v] || (!compacted && v < nv0))) continue;
            if (find(v) != v) continue;
            ++n;
            if (size[v] < kDebrisFaces) any_small = true;
        }
        if (n <= 1 || !any_small) return false;
        for (int64_t f = 0; f < nf; ++f)
            if (alive[f] && size[find(F[3 * f])] < kDebrisFaces)
                kill((int32_t)f);
        compacted = edited = true;
        return true;
    }

    // the live boundary halfedges, ascending (numpy's halfedge order)
    void boundary() {
        const int32_t st = next_stamp();
        const size_t end = touched.size();
        for (size_t t = cur_bnd; t < end; ++t) {
            const int32_t v = touched[t];
            if (vstamp[v] == st) continue;
            vstamp[v] = st;
            const int k = gather(v);
            for (int i = 0; i < k; ++i) {
                is_bnd[sH[i]] = sP[i] < 0;
                if (sP[i] < 0) bnd.push_back(sH[i]);
            }
        }
        cur_bnd = end;
        size_t m = 0;
        for (int32_t h : bnd)
            if (alive[h / 3] && is_bnd[h]) bnd[m++] = h;
        bnd.resize(m);
        std::sort(bnd.begin(), bnd.end());
        bnd.erase(std::unique(bnd.begin(), bnd.end()), bnd.end());
    }

    // numpy's boundary_loops walk over bnd: loops of positions in bnd
    void loops(std::vector<std::vector<int32_t>>& out) const {
        const int nb = (int)bnd.size();
        // src map: positions by source vertex, ascending halfedge
        std::vector<std::pair<int32_t, int32_t>> by_src(nb);
        for (int p = 0; p < nb; ++p) by_src[p] = {F[bnd[p]], p};
        std::sort(by_src.begin(), by_src.end());
        std::vector<uint8_t> visited(nb, 0);
        out.clear();
        for (int p0 = 0; p0 < nb; ++p0) {
            if (visited[p0]) continue;
            std::vector<int32_t> loop;
            int p = p0, guard = 0;
            while (!visited[p] && guard <= nb) {
                visited[p] = 1;
                loop.push_back(p);
                const int32_t to = F[nxt(bnd[p])];
                auto it = std::lower_bound(
                    by_src.begin(), by_src.end(),
                    std::make_pair(to, (int32_t)INT32_MIN));
                int q = -1;
                for (; it != by_src.end() && it->first == to; ++it) {
                    const int c = it->second;
                    if (!visited[c] || (c == p0 && loop.size() > 1)) {
                        q = c;
                        break;
                    }
                }
                if (q < 0 || q == p0) break;
                p = q;
                ++guard;
            }
            out.push_back(std::move(loop));
        }
    }

    // one fill pass over the current boundary (numpy's loop body).
    // After the hygiene each vertex has as many outgoing as incoming
    // boundary halfedges, so every walk closes, and no ring is made of
    // 2-cycles alone (that needs an over-shared edge): the numpy
    // erosion never runs, and meeting it throws OpenWalk
    void fill() {
        std::vector<std::vector<int32_t>> lps;
        loops(lps);
        counts[kHoles] += (int64_t)lps.size();
        std::vector<int32_t> tris;
        std::vector<int32_t> ring, stack;
        std::unordered_map<int32_t, int32_t> pos;
        auto zig_zag = [&tris](const std::vector<int32_t>& cyc) {
            // numpy's zig_zag_triangulate(cyc[::-1])
            const int n = (int)cyc.size();
            auto r = [&cyc, n](int i) { return cyc[n - 1 - i]; };
            int lo = 0, hi = n - 1;
            bool take_lo = true;
            while (hi - lo >= 2) {
                if (take_lo) {
                    tris.push_back(r(lo)); tris.push_back(r(lo + 1));
                    tris.push_back(r(hi));
                    ++lo;
                } else {
                    tris.push_back(r(lo)); tris.push_back(r(hi - 1));
                    tris.push_back(r(hi));
                    --hi;
                }
                take_lo = !take_lo;
            }
        };
        for (const auto& lp : lps) {
            ring.clear();
            for (int32_t p : lp) ring.push_back(F[bnd[p]]);
            const bool closed = ring.size() >= 3
                && F[nxt(bnd[lp.back()])] == ring[0];
            if (!closed) throw OpenWalk();
            // numpy's _simple_cycles
            stack.clear();
            pos.clear();
            for (int32_t v : ring) {
                auto it = pos.find(v);
                if (it != pos.end()) {
                    const int32_t i = it->second;
                    std::vector<int32_t> cyc(stack.begin() + i, stack.end());
                    for (int32_t u : cyc) pos.erase(u);
                    stack.resize(i);
                    if (cyc.size() >= 3) zig_zag(cyc);
                }
                pos[v] = (int32_t)stack.size();
                stack.push_back(v);
            }
            if (stack.size() >= 3) zig_zag(stack);
        }
        if (tris.empty()) throw OpenWalk();
        for (size_t t = 0; t < tris.size(); t += 3)
            add(tris[t], tris[t + 1], tris[t + 2]);
        counts[kAdded] += (int64_t)(tris.size() / 3);
        ++counts[kPasses];
        edited = true;
    }

    void passes(int max_passes) {
        for (int p = 0; p < max_passes; ++p) {
            if (n_alive == 0) return;
            if (hygiene() || debris()) {
                ++counts[kPasses];
                continue;
            }
            boundary();
            if (bnd.empty()) break;
            fill();
        }
    }

    // numpy's split_pinched_vertices: a vertex whose outgoing halfedges
    // carry more than one fan label after the label propagation keeps
    // its lowest-labelled fan; each other fan gets a copy, numbered in
    // (vertex, label) order
    void split() {
        std::vector<int32_t> cand;
        if (split_first) {
            split_first = false;
            cand.swap(pinch0);
        }
        cand.insert(cand.end(), touched.begin() + cur_split, touched.end());
        cur_split = touched.size();
        std::sort(cand.begin(), cand.end());
        cand.erase(std::unique(cand.begin(), cand.end()), cand.end());
        struct Group { int32_t v; std::vector<int32_t> hs; };
        std::vector<Group> groups;
        std::vector<int32_t> inv, lab, nlab, order;
        for (int32_t v : cand) {
            const int k = gather(v);
            if (k == 0) continue;
            inv.assign(k, -1);
            for (int i = 0; i < k; ++i)
                if (sP[i] >= 0) inv[sP[i]] = i;
            lab.assign(sH.begin(), sH.end());
            nlab.resize(k);
            for (int r = 0; r < kFanRounds; ++r) {
                bool same = true;
                for (int i = 0; i < k; ++i) {
                    int32_t m = std::min(lab[i], lab[sP[i] >= 0 ? sP[i] : i]);
                    if (inv[i] >= 0) m = std::min(m, lab[inv[i]]);
                    nlab[i] = m;
                    same &= m == lab[i];
                }
                if (same) break;
                lab.swap(nlab);
            }
            order.resize(k);
            for (int i = 0; i < k; ++i) order[i] = i;
            std::sort(order.begin(), order.end(), [&lab](int a, int b) {
                return lab[a] != lab[b] ? lab[a] < lab[b] : a < b;
            });
            // the first label keeps v
            for (int i = 0; i < k;) {
                int j = i;
                while (j < k && lab[order[j]] == lab[order[i]]) ++j;
                if (i > 0) {
                    Group g{v, {}};
                    for (int t = i; t < j; ++t) g.hs.push_back(sH[order[t]]);
                    std::sort(g.hs.begin(), g.hs.end());
                    groups.push_back(std::move(g));
                }
                i = j;
            }
        }
        for (auto& g : groups) {
            const int32_t u = nvt++;
            origin.push_back(g.v < nv0 ? g.v : origin[g.v - nv0]);
            dyn_idx.push_back(-1);
            vstamp.push_back(0);
            std::vector<int32_t>& lv = own_list(g.v);
            std::vector<int32_t> keep;
            for (int32_t h : lv)
                if (!std::binary_search(g.hs.begin(), g.hs.end(), h))
                    keep.push_back(h);
            lv.swap(keep);
            for (int32_t h : g.hs) F[h] = u;
            dyn_idx[u] = (int32_t)dyn.size();
            dyn.push_back(g.hs);
            touched.push_back(g.v);
            for (int32_t h : g.hs) touch_face(h / 3);
        }
        counts[kSplit] += (int64_t)groups.size();
        if (!groups.empty()) edited = edited_since_init = true;
    }

    void run(int max_passes) {
        for (int round = 0; round < 2; ++round) {
            passes(max_passes);
            if (n_alive == 0) return;
            split();
            debris();
            boundary();
            if (bnd.empty()) return;
        }
    }
};

}  // namespace

extern "C" {

// Removal (vertices flagged in `remove`, may be null) and repair of a
// (nv, nf) mesh; returns a handle for repair_fetch_native, or null when
// memory ran out (sizes[2] 0) or a boundary walk did not close
// (sizes[2] -1).  sizes: vertices out, faces out, 1 when the mesh
// changed; counts: holes, passes, faces added, split vertices
// (native.REPAIR_COUNTS).
void* repair_native(const int32_t* faces, int64_t nf, int32_t nv,
                    const uint8_t* remove, int max_passes,
                    int64_t* sizes, int64_t* counts) {
    RepairEngine* e = nullptr;
    try {
        e = new RepairEngine();
        e->init(faces, nf, nv, remove);
        e->run(max_passes);
        // the numpy passes' compaction: used vertices in id order
        std::vector<int32_t>& remap = e->vstamp;
        remap.assign(e->nvt, -1);
        const int64_t nft = (int64_t)e->alive.size();
        for (int64_t f = 0; f < nft; ++f)
            if (e->alive[f])
                for (int k = 0; k < 3; ++k) remap[e->F[3 * f + k]] = 0;
        int32_t n = 0;
        for (int32_t v = 0; v < e->nvt; ++v)
            if (remap[v] >= 0) remap[v] = n++;
        sizes[0] = n;
        sizes[1] = e->n_alive;
        sizes[2] = (e->edited || n != nv) ? 1 : 0;
        for (int c = 0; c < kRepairCounts; ++c) counts[c] = e->counts[c];
        return e;
    } catch (const std::bad_alloc&) {
        delete e;
        return nullptr;
    } catch (const OpenWalk&) {
        delete e;
        sizes[2] = -1;
        return nullptr;
    }
}

// writes a repair_native result out (faces (sizes[1], 3), and per
// output vertex the input vertex it is) and frees it
void repair_fetch_native(void* handle, int32_t* faces_out,
                         int32_t* vmap_out) {
    auto* e = static_cast<RepairEngine*>(handle);
    const std::vector<int32_t>& remap = e->vstamp;
    const int64_t nft = (int64_t)e->alive.size();
    int64_t t = 0;
    for (int64_t f = 0; f < nft; ++f)
        if (e->alive[f])
            for (int k = 0; k < 3; ++k)
                faces_out[t++] = remap[e->F[3 * f + k]];
    for (int32_t v = 0; v < e->nvt; ++v)
        if (remap[v] >= 0)
            vmap_out[remap[v]] = v < e->nv0 ? v : e->origin[v - e->nv0];
    delete e;
}

}  // extern "C"
