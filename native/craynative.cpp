// craynative — native runtime components for craytracer_tpu.
//
// The reference implements its scene-ingest and accel-build runtime in C++
// (objloader/objloader.h:738-936, accelerator/bvh.h:117-154); these are the
// equivalents here: a fast OBJ scanner and a median-split BVH
// builder, exposed through a C ABI consumed via ctypes
// (craytracer_tpu/native.py). Semantics match the Python fallbacks
// bit-for-bit at the traversal level (same split rule, same leaf policy).
//
// Build: `make -C native` -> libcraynative.so

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <vector>
#include <string>
#include <algorithm>
#include <numeric>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader
//
// Returns counts + pointers into an opaque handle; caller copies and frees.

struct ObjGroup {
    int32_t face_begin;  // index into the face-corner arrays (in corners)
    int32_t face_end;
    char name[256];
    char mat[256];
};

struct ObjData {
    std::vector<float> positions;   // 3 * n_pos
    std::vector<float> texcoords;   // 2 * n_tex
    std::vector<float> normals;     // 3 * n_nrm
    // face corners, fan-triangulated: 3 ints per corner (v, vt, vn), 0-based,
    // -1 when absent
    std::vector<int32_t> corners;
    std::vector<ObjGroup> groups;
    std::string mtllib;
};

static inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

static inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') p++;
    return p < end ? p + 1 : end;
}

static inline float parse_float(const char*& p, const char* end) {
    char* q = nullptr;
    float v = strtof(p, &q);
    p = (q && q <= end) ? q : p;
    return v;
}

static inline int64_t parse_int(const char*& p, const char* end) {
    char* q = nullptr;
    long v = strtol(p, &q, 10);
    p = (q && q <= end) ? q : p;
    return v;
}

void* crn_load_obj(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf((size_t)size + 1);
    if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
        fclose(f);
        return nullptr;
    }
    fclose(f);
    buf[(size_t)size] = '\n';
    const char* p = buf.data();
    const char* end = buf.data() + size;

    auto* obj = new ObjData();
    obj->positions.reserve(1 << 16);
    obj->corners.reserve(1 << 17);
    char cur_name[256] = "";
    char cur_mat[256] = "";
    int32_t group_start = 0;

    auto flush_group = [&]() {
        int32_t cend = (int32_t)(obj->corners.size() / 3);
        if (cend > group_start) {
            ObjGroup g;
            g.face_begin = group_start;
            g.face_end = cend;
            snprintf(g.name, sizeof(g.name), "%s", cur_name);
            snprintf(g.mat, sizeof(g.mat), "%s", cur_mat);
            obj->groups.push_back(g);
        }
        group_start = cend;
    };

    std::vector<int64_t> face_tmp;  // (v, vt, vn) triples for one polygon
    while (p < end) {
        p = skip_ws(p, end);
        if (p >= end) break;
        char c0 = p[0];
        char c1 = (p + 1 < end) ? p[1] : '\0';
        if (c0 == 'v' && (c1 == ' ' || c1 == '\t')) {
            p += 2;
            float x = parse_float(p, end), y = parse_float(p, end), z = parse_float(p, end);
            obj->positions.push_back(x);
            obj->positions.push_back(y);
            obj->positions.push_back(z);
        } else if (c0 == 'v' && c1 == 't') {
            p += 2;
            float u = parse_float(p, end), v = parse_float(p, end);
            obj->texcoords.push_back(u);
            obj->texcoords.push_back(v);
        } else if (c0 == 'v' && c1 == 'n') {
            p += 2;
            float x = parse_float(p, end), y = parse_float(p, end), z = parse_float(p, end);
            obj->normals.push_back(x);
            obj->normals.push_back(y);
            obj->normals.push_back(z);
        } else if (c0 == 'f' && (c1 == ' ' || c1 == '\t')) {
            p += 1;
            face_tmp.clear();
            while (true) {
                p = skip_ws(p, end);
                if (p >= end || *p == '\n' || *p == '#') break;
                const char *corner_start = p;
                int64_t v = parse_int(p, end);
                int64_t vt = 0, vn = 0;
                if (p < end && *p == '/') {
                    p++;
                    if (p < end && *p != '/') vt = parse_int(p, end);
                    if (p < end && *p == '/') {
                        p++;
                        vn = parse_int(p, end);
                    }
                }
                // resolve 1-based / negative-relative indices now
                int64_t np_ = (int64_t)obj->positions.size() / 3;
                int64_t nt = (int64_t)obj->texcoords.size() / 2;
                int64_t nn = (int64_t)obj->normals.size() / 3;
                face_tmp.push_back(v > 0 ? v - 1 : (v < 0 ? np_ + v : -1));
                face_tmp.push_back(vt > 0 ? vt - 1 : (vt < 0 ? nt + vt : -1));
                face_tmp.push_back(vn > 0 ? vn - 1 : (vn < 0 ? nn + vn : -1));
                if (p == corner_start) break;  // malformed token: parse_int
                // did not advance — bail out of the corner loop instead of
                // spinning forever on the same character
                if (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) continue;
                if (p < end && *p != '\n') continue;
                break;
            }
            size_t nv = face_tmp.size() / 3;
            for (size_t i = 1; i + 1 < nv; i++) {  // fan triangulation
                for (int k = 0; k < 3; k++) obj->corners.push_back((int32_t)face_tmp[0 * 3 + k]);
                for (int k = 0; k < 3; k++) obj->corners.push_back((int32_t)face_tmp[i * 3 + k]);
                for (int k = 0; k < 3; k++) obj->corners.push_back((int32_t)face_tmp[(i + 1) * 3 + k]);
            }
        } else if ((c0 == 'g' || c0 == 'o') && (c1 == ' ' || c1 == '\t')) {
            flush_group();
            p += 2;
            p = skip_ws(p, end);
            size_t i = 0;
            while (p < end && *p != '\n' && *p != '\r' && !isspace((unsigned char)*p) && i < 255)
                cur_name[i++] = *p++;
            cur_name[i] = '\0';
        } else if (strncmp(p, "usemtl", 6) == 0) {
            flush_group();
            p += 6;
            p = skip_ws(p, end);
            size_t i = 0;
            while (p < end && *p != '\n' && *p != '\r' && !isspace((unsigned char)*p) && i < 255)
                cur_mat[i++] = *p++;
            cur_mat[i] = '\0';
        } else if (strncmp(p, "mtllib", 6) == 0) {
            p += 6;
            p = skip_ws(p, end);
            const char* s = p;
            while (p < end && *p != '\n' && *p != '\r') p++;
            obj->mtllib.assign(s, p - s);
        }
        p = next_line(p, end);
    }
    flush_group();
    return obj;
}

int64_t crn_obj_counts(void* h, int64_t* n_pos, int64_t* n_tex, int64_t* n_nrm,
                       int64_t* n_corners, int64_t* n_groups) {
    auto* obj = (ObjData*)h;
    if (!obj) return -1;
    *n_pos = (int64_t)obj->positions.size() / 3;
    *n_tex = (int64_t)obj->texcoords.size() / 2;
    *n_nrm = (int64_t)obj->normals.size() / 3;
    *n_corners = (int64_t)obj->corners.size() / 3;
    *n_groups = (int64_t)obj->groups.size();
    return 0;
}

int64_t crn_obj_copy(void* h, float* pos, float* tex, float* nrm, int32_t* corners,
                     int32_t* group_ranges, char* group_names, char* group_mats,
                     char* mtllib, int64_t name_stride) {
    auto* obj = (ObjData*)h;
    if (!obj) return -1;
    memcpy(pos, obj->positions.data(), obj->positions.size() * sizeof(float));
    if (!obj->texcoords.empty()) memcpy(tex, obj->texcoords.data(), obj->texcoords.size() * sizeof(float));
    if (!obj->normals.empty()) memcpy(nrm, obj->normals.data(), obj->normals.size() * sizeof(float));
    memcpy(corners, obj->corners.data(), obj->corners.size() * sizeof(int32_t));
    for (size_t i = 0; i < obj->groups.size(); i++) {
        group_ranges[2 * i] = obj->groups[i].face_begin;
        group_ranges[2 * i + 1] = obj->groups[i].face_end;
        snprintf(group_names + i * name_stride, (size_t)name_stride, "%s", obj->groups[i].name);
        snprintf(group_mats + i * name_stride, (size_t)name_stride, "%s", obj->groups[i].mat);
    }
    snprintf(mtllib, (size_t)name_stride, "%s", obj->mtllib.c_str());
    return 0;
}

void crn_obj_free(void* h) { delete (ObjData*)h; }

// ---------------------------------------------------------------------------
// BVH builder — median split on the largest centroid extent, <=leaf_size
// leaves, depth-first layout (left child = node + 1). Matches
// craytracer_tpu/accel/bvh.py::_build_arrays.

struct BVHOut {
    std::vector<float> node_min, node_max;  // 3 * n_nodes
    std::vector<int32_t> right, axis, first, count;
    std::vector<int32_t> order;
};

struct BuildCtx {
    const float* tmin;
    const float* tmax;
    const float* cent;
    int leaf_size;
    int split_mode = 0;          // 0 = median (reference parity), 1 = SAH
    std::vector<float> scratch;  // suffix SAH costs, reused across nodes
    BVHOut out;
    // Presorted-axis partition build (O(n log n)): arr[k] holds the node's
    // triangle ids sorted by the STRICT key (centroid[k], id) — a total
    // order, so no tie-dependence on parent ordering. Each split partitions
    // the other two axis arrays stably by membership, preserving their sort.
    std::vector<int32_t> arr[3];
    std::vector<uint8_t> side;    // per-triangle left/right flag
    std::vector<int32_t> tmp;     // partition scratch
    // 4-wide collapse products (crn_bvh4_collapse)
    std::vector<int32_t> q_slots;  // 4 per q node: binary slot ids or -1
    std::vector<int32_t> q_of;     // binary internal id -> q id
};

// Exact sweep SAH over all three presorted axis orders: for axis k the
// candidate splits are every position i in (lo, hi) of arr[k] (sorted by
// centroid along k), cost(i) = halfArea(prefix) * nL + halfArea(suffix)
// * nR. Returns false when SAH should not be used for this node (the
// median fallback keeps worst-case depth logarithmic: the traversal
// stacks are sized for depth <= ~50, see accel/bvh.py MAX_STACK).
// Deviation from the reference: CRaytracer builds median-split trees
// (accelerator/bvh.h:85-154); SAH is a quality improvement over it.
static bool sah_split(BuildCtx& c, int32_t lo, int32_t hi, int depth,
                      int* out_ax, int32_t* out_mid) {
    if (c.split_mode != 1 || depth >= 32) return false;
    const int32_t n = hi - lo;
    // Restrict splits to keep min(nL, nR) >= n/8: bounds tree depth at
    // log_{8/7}(n) before the depth-32 median switch kicks in.
    const int32_t margin = std::max((int32_t)c.leaf_size, n / 8);
    const int32_t i0 = lo + margin, i1 = hi - margin;
    if (i0 >= i1) return false;
    if ((int32_t)c.scratch.size() < hi) c.scratch.resize(hi);
    float best_cost = 1e30f;
    for (int k = 0; k < 3; k++) {
        const auto& ids = c.arr[k];
        float mn0 = 1e30f, mn1 = 1e30f, mn2 = 1e30f;
        float mx0 = -1e30f, mx1 = -1e30f, mx2 = -1e30f;
        for (int32_t i = hi - 1; i >= i0; i--) {  // suffix = [i, hi)
            int32_t t = ids[i];
            mn0 = std::min(mn0, c.tmin[3 * t + 0]);
            mn1 = std::min(mn1, c.tmin[3 * t + 1]);
            mn2 = std::min(mn2, c.tmin[3 * t + 2]);
            mx0 = std::max(mx0, c.tmax[3 * t + 0]);
            mx1 = std::max(mx1, c.tmax[3 * t + 1]);
            mx2 = std::max(mx2, c.tmax[3 * t + 2]);
            float dx = mx0 - mn0, dy = mx1 - mn1, dz = mx2 - mn2;
            c.scratch[i] = (dx * dy + dy * dz + dz * dx) * (float)(hi - i);
        }
        mn0 = mn1 = mn2 = 1e30f;
        mx0 = mx1 = mx2 = -1e30f;
        for (int32_t i = lo; i < i1; i++) {  // prefix = [lo, i]
            int32_t t = ids[i];
            mn0 = std::min(mn0, c.tmin[3 * t + 0]);
            mn1 = std::min(mn1, c.tmin[3 * t + 1]);
            mn2 = std::min(mn2, c.tmin[3 * t + 2]);
            mx0 = std::max(mx0, c.tmax[3 * t + 0]);
            mx1 = std::max(mx1, c.tmax[3 * t + 1]);
            mx2 = std::max(mx2, c.tmax[3 * t + 2]);
            if (i + 1 < i0) continue;
            float dx = mx0 - mn0, dy = mx1 - mn1, dz = mx2 - mn2;
            float cost = (dx * dy + dy * dz + dz * dx) * (float)(i + 1 - lo)
                         + c.scratch[i + 1];
            if (cost < best_cost) {
                best_cost = cost;
                *out_ax = k;
                *out_mid = i + 1;
            }
        }
    }
    return best_cost < 1e30f;
}

static int32_t build_node(BuildCtx& c, int32_t lo, int32_t hi, int parent_ax,
                          int depth = 0) {
    int32_t idx = (int32_t)c.out.right.size();
    c.out.right.push_back(-1);
    c.out.axis.push_back(0);
    c.out.first.push_back(-1);
    c.out.count.push_back(0);
    c.out.node_min.resize(c.out.node_min.size() + 3);
    c.out.node_max.resize(c.out.node_max.size() + 3);

    float bmin[3] = {1e30f, 1e30f, 1e30f}, bmax[3] = {-1e30f, -1e30f, -1e30f};
    float cmin[3] = {1e30f, 1e30f, 1e30f}, cmax[3] = {-1e30f, -1e30f, -1e30f};
    const auto& ids0 = c.arr[parent_ax < 0 ? 0 : parent_ax];
    for (int32_t i = lo; i < hi; i++) {
        int32_t t = ids0[i];
        for (int k = 0; k < 3; k++) {
            bmin[k] = std::min(bmin[k], c.tmin[3 * t + k]);
            bmax[k] = std::max(bmax[k], c.tmax[3 * t + k]);
            cmin[k] = std::min(cmin[k], c.cent[3 * t + k]);
            cmax[k] = std::max(cmax[k], c.cent[3 * t + k]);
        }
    }
    for (int k = 0; k < 3; k++) {
        c.out.node_min[3 * idx + k] = bmin[k];
        c.out.node_max[3 * idx + k] = bmax[k];
    }

    if (hi - lo <= c.leaf_size) {
        c.out.first[idx] = (int32_t)c.out.order.size();
        c.out.count[idx] = hi - lo;
        // Leaf triangle order: the parent's split-axis order — exactly the
        // subrange order the per-node-sort formulation would leave here
        // (the Python fallback's ids array after the parent's lexsort).
        for (int32_t i = lo; i < hi; i++) c.out.order.push_back(ids0[i]);
        return idx;
    }
    int ax = 0;
    int32_t mid = -1;
    if (!sah_split(c, lo, hi, depth, &ax, &mid)) {
        float best_ext = -1.0f;
        for (int k = 0; k < 3; k++) {
            float e = cmax[k] - cmin[k];
            if (e > best_ext) { best_ext = e; ax = k; }
        }
        mid = lo + (hi - lo) / 2;
    }
    c.out.axis[idx] = ax;
    // Mark which ids fall left: the first half of the split-axis order.
    for (int32_t i = lo; i < mid; i++) c.side[c.arr[ax][i]] = 0;
    for (int32_t i = mid; i < hi; i++) c.side[c.arr[ax][i]] = 1;
    // Stable-partition the other two axis arrays by the flag.
    for (int k = 0; k < 3; k++) {
        if (k == ax) continue;
        auto& a = c.arr[k];
        int32_t nl = lo, nr = 0;
        for (int32_t i = lo; i < hi; i++) {
            int32_t t = a[i];
            if (c.side[t] == 0) a[nl++] = t;
            else c.tmp[nr++] = t;
        }
        std::copy(c.tmp.begin(), c.tmp.begin() + nr, a.begin() + nl);
    }
    build_node(c, lo, mid, ax, depth + 1);
    c.out.right[idx] = build_node(c, mid, hi, ax, depth + 1);
    return idx;
}

void* crn_build_bvh(const float* v0, const float* v1, const float* v2,
                    int64_t n, int32_t leaf_size, int32_t split_mode) {
    auto* c = new BuildCtx();
    c->leaf_size = leaf_size;
    c->split_mode = split_mode;
    std::vector<float>* tmin = new std::vector<float>(3 * (size_t)n);
    std::vector<float>* tmax = new std::vector<float>(3 * (size_t)n);
    std::vector<float>* cent = new std::vector<float>(3 * (size_t)n);
    for (int64_t i = 0; i < n; i++) {
        for (int k = 0; k < 3; k++) {
            float a = v0[3 * i + k], b = v1[3 * i + k], d = v2[3 * i + k];
            float mn = std::min(a, std::min(b, d));
            float mx = std::max(a, std::max(b, d));
            (*tmin)[3 * i + k] = mn;
            (*tmax)[3 * i + k] = mx;
            (*cent)[3 * i + k] = 0.5f * (mn + mx);
        }
    }
    c->tmin = tmin->data();
    c->tmax = tmax->data();
    c->cent = cent->data();
    if (n > 0) {
        // Root-leaf special case keeps the original id order (matches the
        // Python fallback, which never sorts a <=leaf_size root).
        if (n <= leaf_size) {
            c->arr[0].resize((size_t)n);
            std::iota(c->arr[0].begin(), c->arr[0].end(), 0);
            build_node(*c, 0, (int32_t)n, -1);
        } else {
            const float* cent_p = c->cent;
            for (int k = 0; k < 3; k++) {
                c->arr[k].resize((size_t)n);
                std::iota(c->arr[k].begin(), c->arr[k].end(), 0);
                std::sort(c->arr[k].begin(), c->arr[k].end(),
                          [cent_p, k](int32_t a, int32_t b) {
                              float ca = cent_p[3 * a + k], cb = cent_p[3 * b + k];
                              if (ca != cb) return ca < cb;
                              return a < b;
                          });
            }
            c->side.resize((size_t)n);
            c->tmp.resize((size_t)n);
            build_node(*c, 0, (int32_t)n, -1);
        }
    }
    delete tmin;  // tmin/tmax/cent only needed during build; out holds
    delete tmax;  // node bounds.
    delete cent;
    c->tmin = c->tmax = c->cent = nullptr;
    return c;
}

int64_t crn_bvh_counts(void* h, int64_t* n_nodes, int64_t* n_order) {
    auto* c = (BuildCtx*)h;
    if (!c) return -1;
    *n_nodes = (int64_t)c->out.right.size();
    *n_order = (int64_t)c->out.order.size();
    return 0;
}

int64_t crn_bvh_copy(void* h, float* node_min, float* node_max, int32_t* right,
                     int32_t* axis, int32_t* first, int32_t* count,
                     int32_t* order) {
    auto* c = (BuildCtx*)h;
    if (!c) return -1;
    auto& o = c->out;
    memcpy(node_min, o.node_min.data(), o.node_min.size() * sizeof(float));
    memcpy(node_max, o.node_max.data(), o.node_max.size() * sizeof(float));
    memcpy(right, o.right.data(), o.right.size() * sizeof(int32_t));
    memcpy(axis, o.axis.data(), o.axis.size() * sizeof(int32_t));
    memcpy(first, o.first.data(), o.first.size() * sizeof(int32_t));
    memcpy(count, o.count.data(), o.count.size() * sizeof(int32_t));
    memcpy(order, o.order.data(), o.order.size() * sizeof(int32_t));
    return 0;
}

void crn_bvh_free(void* h) { delete (BuildCtx*)h; }

// ---------------------------------------------------------------------------
// Fat-row assembly — the device node layouts of accel/bvh.py (binary,
// [M, 8 + L*10]) and accel/bvh4.py (4-wide, [M, 28 + 4*L*10]) built directly
// in C++. The numpy assembly was measured at 3-15 MB/s on the target host
// (pathological page-fault behavior); these single-pass writers run at
// memory speed. Layouts and values are bit-identical to the numpy paths:
// edge vectors v1-v0 of f32 inputs are correctly rounded either way, pad
// triangle rows are zero with id -1, empty 4-wide slots carry min=+1/max=-1.

static const int TRI_COLS = 10;

static void write_tri_block(float* dst, int32_t s, const BuildCtx& c,
                            const float* v0, const float* v1, const float* v2,
                            int leaf_size) {
    // dst: leaf_size * TRI_COLS floats. s = binary leaf node id (or -1).
    const auto& o = c.out;
    int32_t cnt = s >= 0 ? o.count[s] : 0;
    int32_t fst = s >= 0 ? o.first[s] : -1;
    for (int j = 0; j < leaf_size; j++) {
        float* row = dst + j * TRI_COLS;
        if (j < cnt && fst >= 0) {
            int32_t t = o.order[fst + j];
            for (int k = 0; k < 3; k++) {
                row[k] = v0[3 * t + k];
                row[3 + k] = v1[3 * t + k] - v0[3 * t + k];
                row[6 + k] = v2[3 * t + k] - v0[3 * t + k];
            }
            row[9] = (float)t;
        } else {
            memset(row, 0, TRI_COLS * sizeof(float));
            row[9] = -1.0f;
        }
    }
}

// Binary fat rows: [0:3) min, [3:6) max, [6] right (-1 = leaf), [7] axis,
// [8:8+L*10) leaf triangles.
int64_t crn_bvh_fat(void* h, const float* v0, const float* v1,
                    const float* v2, int32_t leaf_size, float* fat) {
    auto* c = (BuildCtx*)h;
    if (!c) return -1;
    const auto& o = c->out;
    int64_t m = (int64_t)o.right.size();
    const int w = 8 + leaf_size * TRI_COLS;
    for (int64_t i = 0; i < m; i++) {
        float* row = fat + i * w;
        for (int k = 0; k < 3; k++) {
            row[k] = o.node_min[3 * i + k];
            row[3 + k] = o.node_max[3 * i + k];
        }
        bool leaf = o.count[i] > 0;
        row[6] = (float)(leaf ? -1 : o.right[i]);
        row[7] = (float)o.axis[i];
        write_tri_block(row + 8, leaf ? (int32_t)i : -1, *c, v0, v1, v2,
                        leaf_size);
    }
    return m;
}

// 4-wide collapse (accel/bvh4.py::collapse4): each q node adopts its
// grandchildren where its children are internal, the children themselves
// where they are leaves. Q-node ids are assigned in BFS appearance order
// (root = 0), matching the vectorized numpy wave collapse bit-for-bit.
int64_t crn_bvh4_collapse(void* h, int64_t* out_m) {
    auto* c = (BuildCtx*)h;
    if (!c) return -1;
    const auto& o = c->out;
    int64_t nb = (int64_t)o.right.size();
    c->q_slots.clear();
    if (nb == 0) { *out_m = 0; return 0; }
    if (o.count[0] > 0) {  // single-leaf tree
        c->q_slots = {0, -1, -1, -1};
        *out_m = 1;
        return 0;
    }
    std::vector<int32_t> queue;  // binary internal ids in q order
    queue.reserve(nb / 2 + 1);
    queue.push_back(0);
    auto is_leaf = [&](int32_t b) { return o.count[b] > 0; };
    for (size_t qi = 0; qi < queue.size(); qi++) {
        int32_t b = queue[qi];
        int32_t l = b + 1, r = o.right[b];
        int32_t s[4];
        if (is_leaf(l)) { s[0] = l; s[1] = -1; }
        else { s[0] = l + 1; s[1] = o.right[l]; }
        if (is_leaf(r)) { s[2] = r; s[3] = -1; }
        else { s[2] = r + 1; s[3] = o.right[r]; }
        for (int k = 0; k < 4; k++) {
            c->q_slots.push_back(s[k]);
            if (s[k] >= 0 && !is_leaf(s[k])) queue.push_back(s[k]);
        }
    }
    // map binary internal id -> q id (its index in the queue)
    c->q_of.assign(nb, -1);
    for (size_t qi = 0; qi < queue.size(); qi++) c->q_of[queue[qi]] = (int32_t)qi;
    *out_m = (int64_t)(c->q_slots.size() / 4);
    return 0;
}

// 4-wide fat rows: [0:12) 4 child mins, [12:24) 4 child maxs, [24:28)
// child q ids (-1 = leaf/empty), [28:28+4*L*10) per-slot leaf triangles.
int64_t crn_bvh4_fat(void* h, const float* v0, const float* v1,
                     const float* v2, int32_t leaf_size, float* fat) {
    auto* c = (BuildCtx*)h;
    if (!c || c->q_slots.empty()) return -1;
    const auto& o = c->out;
    int64_t m = (int64_t)(c->q_slots.size() / 4);
    const int tri_block = leaf_size * TRI_COLS;
    const int w = 28 + 4 * tri_block;
    for (int64_t i = 0; i < m; i++) {
        float* row = fat + i * w;
        for (int k = 0; k < 4; k++) {
            int32_t s = c->q_slots[4 * i + k];
            bool leaf = s >= 0 && o.count[s] > 0;
            for (int j = 0; j < 3; j++) {
                row[3 * k + j] = s >= 0 ? o.node_min[3 * s + j] : 1.0f;
                row[12 + 3 * k + j] = s >= 0 ? o.node_max[3 * s + j] : -1.0f;
            }
            row[24 + k] = (float)((s >= 0 && !leaf) ? c->q_of[s] : -1);
            write_tri_block(row + 28 + k * tri_block, leaf ? s : -1, *c,
                            v0, v1, v2, leaf_size);
        }
    }
    return m;
}

}  // extern "C"
