// Native OpenVDB `.vdb` decode (no OpenVDB library, no Python bindings).
//
// Counterpart of the reference's always-linked OpenVDB ingestion
// (CPURenderer/CPURenderer.cpp:448-460 `openvdb::io::File::readGrid`,
// GPURenderer/Vdb2Vbx.cpp:70-324 which walks 5-4-3 float trees into GVDB
// bricks).  The reference links the library; this image has neither the
// library nor its Python bindings, so this file implements the subset of
// the OpenVDB file format the reference's data path needs, from the
// format specification:
//
//   - archives written by OpenVDB with file version >= 220 (OpenVDB 2.x+,
//     per-grid compression from version 222),
//   - FloatGrid ("Tree_float_5_4_3"), optional "_HalfFloat" payload,
//   - leaf/tile payload compression NONE or ZIP (zlib); BLOSC payloads
//     are detected and rejected with a clear error,
//   - active-mask value compression (the per-node int8 metadata codes),
//   - linear transform maps (uniform/scale/translate/affine); frustum
//     maps are rejected.
//
// The tree is flattened into a dense (X, Y, Z) C-order float32 array over
// the active bounding box, matching what `BrickGrid.from_dense` consumes
// (the caller normalizes to the unit box like CPURenderer.cpp:448-460).
// Tiles fill their whole span; inactive voxels get the background value.
//
// C ABI for ctypes (no pybind11 in this image):
//   vdb_probe(path, name, bbox[6], voxel_size[3], err, errlen) -> 0/neg
//   vdb_load(path, name, out, err, errlen) -> 0/neg   (out sized from probe)
//   vdb_grid_names(path, buf, cap) -> count  (newline-joined names)
//
// Build: isosurfacesuperresolution_tpu_torch/native/build.py, at first use
//        (python -m isosurfacesuperresolution_tpu_torch.native.build; links zlib)

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- stream --

struct Reader {
    std::vector<uint8_t> data;
    size_t pos = 0;

    explicit Reader(const char* path) {
        std::FILE* f = std::fopen(path, "rb");
        if (!f) throw std::runtime_error("cannot open file");
        std::fseek(f, 0, SEEK_END);
        long n = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        data.resize(static_cast<size_t>(n));
        if (n > 0 && std::fread(data.data(), 1, data.size(), f) !=
                         data.size()) {
            std::fclose(f);
            throw std::runtime_error("short read");
        }
        std::fclose(f);
    }

    void need(size_t n) const {
        // overflow-safe: pos may have been seeked from an (untrusted)
        // file offset, and pos + n could wrap
        if (pos > data.size() || n > data.size() - pos)
            throw std::runtime_error("unexpected end of file");
    }
    void skip(size_t n) { need(n); pos += n; }
    void seek_to(int64_t p) {              // file-provided offsets
        if (p < 0 || static_cast<size_t>(p) > data.size())
            throw std::runtime_error("corrupt stream offset");
        pos = static_cast<size_t>(p);
    }
    const uint8_t* take(size_t n) { need(n); const uint8_t* p = data.data() + pos; pos += n; return p; }

    template <typename T> T get() {
        T v;
        std::memcpy(&v, take(sizeof(T)), sizeof(T));
        return v;
    }
    uint32_t u32() { return get<uint32_t>(); }
    int32_t i32() { return get<int32_t>(); }
    int64_t i64() { return get<int64_t>(); }
    float f32() { return get<float>(); }
    double f64() { return get<double>(); }
    uint8_t u8() { return get<uint8_t>(); }

    std::string str() {                    // io::readString: u32 len + chars
        uint32_t n = u32();
        if (n > (1u << 28)) throw std::runtime_error("string too long");
        const uint8_t* p = take(n);
        return std::string(reinterpret_cast<const char*>(p), n);
    }
};

inline float half_to_float(uint16_t h) {
    const uint32_t sign = (h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1f;
    uint32_t man = h & 0x3ffu;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {                            // subnormal
            exp = 127 - 15 + 1;
            while (!(man & 0x400u)) { man <<= 1; --exp; }
            man &= 0x3ffu;
            bits = sign | (exp << 23) | (man << 13);
        }
    } else if (exp == 0x1f) {
        bits = sign | 0x7f800000u | (man << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

// ------------------------------------------------------------ format ids --

constexpr int64_t kMagic = 0x56444220;     // int64(' BDV') little-endian
constexpr uint32_t kVerBoostUuid = 218;
constexpr uint32_t kVerSelectiveCompression = 220;
constexpr uint32_t kVerNodeMaskCompression = 222;
constexpr uint32_t kVerBloscCompression = 223;

constexpr uint32_t kCompressZip = 0x1;
constexpr uint32_t kCompressActiveMask = 0x2;
constexpr uint32_t kCompressBlosc = 0x4;

// io/Compression.h mask-compression metadata codes
constexpr int kNoMaskOrInactiveVals = 0;
constexpr int kNoMaskAndMinusBg = 1;
constexpr int kNoMaskAndOneInactiveVal = 2;
constexpr int kMaskAndNoInactiveVals = 3;
constexpr int kMaskAndOneInactiveVal = 4;
constexpr int kMaskAndTwoInactiveVals = 5;
constexpr int kNoMaskAndAllVals = 6;

struct Coord { int32_t x, y, z; };

// -------------------------------------------------------------- payloads --

// io::readData / readZipData: ZIP chunks are "int64 byte count, bytes";
// a NEGATIVE count marks incompressible data stored raw (|count| bytes).
void read_values(Reader& r, uint32_t compression, bool from_half,
                 size_t count, float* out) {
    const size_t elem = from_half ? 2 : 4;
    std::vector<uint8_t> raw;
    const uint8_t* src = nullptr;
    if (compression & kCompressBlosc) {
        throw std::runtime_error(
            "blosc-compressed .vdb payload: unsupported (re-save the file "
            "with zip or no compression)");
    }
    if (compression & kCompressZip) {
        int64_t nbytes = r.i64();
        if (nbytes == INT64_MIN)
            throw std::runtime_error("corrupt zip chunk size");
        if (nbytes <= 0) {
            src = r.take(static_cast<size_t>(-nbytes));
            if (static_cast<size_t>(-nbytes) != count * elem)
                throw std::runtime_error("raw chunk size mismatch");
        } else {
            const uint8_t* comp = r.take(static_cast<size_t>(nbytes));
            raw.resize(count * elem);
            uLongf dst_len = static_cast<uLongf>(raw.size());
            int rc = uncompress(raw.data(), &dst_len, comp,
                                static_cast<uLong>(nbytes));
            if (rc != Z_OK || dst_len != raw.size())
                throw std::runtime_error("zlib inflate failed");
            src = raw.data();
        }
    } else {
        src = r.take(count * elem);
    }
    if (count == 0) return;
    if (from_half) {
        const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
        for (size_t i = 0; i < count; ++i) out[i] = half_to_float(h[i]);
    } else {
        std::memcpy(out, src, count * 4);
    }
}

// io::readCompressedValues: scatter `count` destination values from the
// stored active set per the int8 metadata code.  `mask` has `count` bits.
void read_compressed_values(Reader& r, uint32_t compression, bool from_half,
                            uint32_t file_version, float background,
                            const std::vector<uint64_t>& mask, size_t count,
                            float* out) {
    int8_t meta = kNoMaskAndAllVals;
    float inactive0 = background, inactive1 = background;
    std::vector<uint64_t> selection;
    // The int8 metadata code is present for EVERY file version >= 222
    // stream, not only when COMPRESS_ACTIVE_MASK is set:
    // writeCompressedValues emits code 6 (NO_MASK_AND_ALL_VALS) even
    // with mask compression off (`if (!maskCompress) os.write(&metadata,
    // 1)`, io/Compression.h), and readCompressedValues consumes the
    // byte unconditionally at >= 222.
    bool have_meta = file_version >= kVerNodeMaskCompression;
    bool mask_compressed = (compression & kCompressActiveMask) && have_meta;
    if (have_meta) {
        meta = static_cast<int8_t>(r.u8());
        if (meta < kNoMaskOrInactiveVals || meta > kNoMaskAndAllVals)
            throw std::runtime_error(
                "corrupt node-value metadata code " + std::to_string(meta));
        // explicit inactive values are stored as full ValueType (never
        // half-converted; only the bulk buffer is)
        if (meta == kNoMaskAndOneInactiveVal ||
            meta == kMaskAndOneInactiveVal ||
            meta == kMaskAndTwoInactiveVals) {
            inactive0 = r.f32();
        }
        if (meta == kMaskAndTwoInactiveVals) inactive1 = r.f32();
        if (meta == kMaskAndNoInactiveVals ||
            meta == kMaskAndOneInactiveVal ||
            meta == kMaskAndTwoInactiveVals) {
            selection.resize((count + 63) / 64);
            const uint8_t* p = r.take(selection.size() * 8);
            std::memcpy(selection.data(), p, selection.size() * 8);
        }
        if (meta == kNoMaskAndMinusBg) inactive0 = -background;
        if (meta == kMaskAndNoInactiveVals) inactive1 = -background;
    }
    size_t stored = count;
    if (mask_compressed && meta != kNoMaskAndAllVals) {
        stored = 0;
        for (size_t w = 0; w < mask.size(); ++w)
            stored += static_cast<size_t>(__builtin_popcountll(mask[w]));
    }
    std::vector<float> tmp(stored);
    read_values(r, compression, from_half, stored, tmp.data());
    if (!mask_compressed || meta == kNoMaskAndAllVals) {
        std::memcpy(out, tmp.data(), count * 4);
        return;
    }
    size_t next = 0;
    for (size_t i = 0; i < count; ++i) {
        const bool active = (mask[i >> 6] >> (i & 63)) & 1;
        if (active) {
            out[i] = tmp[next++];
        } else {
            bool sel = !selection.empty() &&
                       ((selection[i >> 6] >> (i & 63)) & 1);
            out[i] = sel ? inactive1 : inactive0;
        }
    }
}

std::vector<uint64_t> read_mask(Reader& r, size_t bits) {
    std::vector<uint64_t> words((bits + 63) / 64);
    const uint8_t* p = r.take(words.size() * 8);
    std::memcpy(words.data(), p, words.size() * 8);
    return words;
}

inline bool mask_bit(const std::vector<uint64_t>& m, size_t i) {
    return (m[i >> 6] >> (i & 63)) & 1;
}

// ------------------------------------------------------------------ tree --

struct LeafNode {                          // 8^3, Log2Dim 3
    Coord origin;
    std::vector<uint64_t> value_mask;      // 512 bits
    std::vector<float> values;             // filled by readBuffers
};

struct Tile { Coord origin; int32_t dim; float value; bool active; };

struct Tree {
    float background = 0.0f;
    std::vector<Tile> tiles;               // root tiles + internal tiles
    std::vector<LeafNode> leaves;          // depth-first order (= file order)
};

// offset -> local (x, y, z): OpenVDB packs z fastest
// (offset = x << 2*Log2 | y << Log2 | z)
inline void offset_to_xyz(size_t n, int log2, int& x, int& y, int& z) {
    const int m = (1 << log2) - 1;
    z = static_cast<int>(n) & m;
    y = (static_cast<int>(n) >> log2) & m;
    x = (static_cast<int>(n) >> (2 * log2)) & m;
}

struct Context {
    uint32_t file_version;
    uint32_t compression;
    bool half;
    float background;
};

LeafNode read_leaf_topology(Reader& r, Coord origin) {
    LeafNode leaf;
    leaf.origin = origin;
    leaf.value_mask = read_mask(r, 512);
    return leaf;
}

// InternalNode<4> spans 128^3 (16 x leaf 8); InternalNode<5> spans 4096^3.
// Only the tiles and leaves survive parsing - the node structure itself is
// not needed for the dense fill.
template <int Log2>
void read_internal_topology(Reader& r, const Context& ctx, Coord origin,
                            int child_span, Tree& tree) {
    constexpr size_t kNum = size_t(1) << (3 * Log2);
    std::vector<uint64_t> child_mask = read_mask(r, kNum);
    std::vector<uint64_t> value_mask = read_mask(r, kNum);
    std::vector<float> tile_values(kNum, ctx.background);
    if (ctx.file_version < kVerNodeMaskCompression) {
        // 220/221 internal nodes store only the childMask.countOff()
        // tile values, scattered to the child-off slots in offset order
        // (InternalNode::readTopology's oldVersion branch).
        size_t n_off = kNum;
        for (uint64_t w : child_mask)
            n_off -= static_cast<size_t>(__builtin_popcountll(w));
        std::vector<float> packed(n_off);
        read_compressed_values(r, ctx.compression, ctx.half,
                               ctx.file_version, ctx.background,
                               value_mask, n_off, packed.data());
        size_t n = 0;
        for (size_t i = 0; i < kNum; ++i)
            if (!mask_bit(child_mask, i)) tile_values[i] = packed[n++];
    } else {
        read_compressed_values(r, ctx.compression, ctx.half,
                               ctx.file_version, ctx.background, value_mask,
                               kNum, tile_values.data());
    }
    // active tiles (value-mask bits that are not children)
    for (size_t i = 0; i < kNum; ++i) {
        if (mask_bit(value_mask, i) && !mask_bit(child_mask, i)) {
            int lx, ly, lz;
            offset_to_xyz(i, Log2, lx, ly, lz);
            tree.tiles.push_back(
                {{origin.x + lx * child_span, origin.y + ly * child_span,
                  origin.z + lz * child_span},
                 child_span, tile_values[i], true});
        }
    }
    // children in bit order
    for (size_t i = 0; i < kNum; ++i) {
        if (!mask_bit(child_mask, i)) continue;
        int lx, ly, lz;
        offset_to_xyz(i, Log2, lx, ly, lz);
        Coord corigin = {origin.x + lx * child_span,
                         origin.y + ly * child_span,
                         origin.z + lz * child_span};
        if constexpr (Log2 == 5) {
            read_internal_topology<4>(r, ctx, corigin, 8, tree);
        } else {
            tree.leaves.push_back(read_leaf_topology(r, corigin));
        }
    }
}

Tree read_tree(Reader& r, const Context& ctx_in) {
    Tree tree;
    Context ctx = ctx_in;
    uint32_t buffer_count = r.u32();       // TreeBase::readTopology
    if (buffer_count != 1)
        throw std::runtime_error("multi-buffer trees not supported");
    // RootNode::readTopology (file version >= 213 root-node map layout)
    tree.background = r.f32();
    ctx.background = tree.background;
    uint32_t num_tiles = r.u32();
    uint32_t num_children = r.u32();
    for (uint32_t i = 0; i < num_tiles; ++i) {
        Coord o{r.i32(), r.i32(), r.i32()};
        float v = r.f32();
        bool active = r.u8() != 0;
        if (active) tree.tiles.push_back({o, 4096, v, true});
    }
    for (uint32_t i = 0; i < num_children; ++i) {
        Coord o{r.i32(), r.i32(), r.i32()};
        read_internal_topology<5>(r, ctx, o, 128, tree);
    }
    return tree;
}

void read_leaf_buffers(Reader& r, const Context& ctx, Tree& tree) {
    for (LeafNode& leaf : tree.leaves) {
        // LeafNode::readBuffers re-loads the value mask from the buffer
        // section (writeBuffers serializes it again ahead of the
        // values); the re-read copy is authoritative for the payload.
        leaf.value_mask = read_mask(r, 512);
        if (ctx.file_version < kVerNodeMaskCompression) {
            // pre-222 leaf buffers carry the origin and a buffer count
            r.skip(12);                    // Coord mOrigin
            uint8_t num_buffers = r.u8();
            if (num_buffers != 1)
                throw std::runtime_error("multi-buffer leaves (pre-222 "
                                         "numBuffers != 1) not supported");
        }
        leaf.values.resize(512);
        read_compressed_values(r, ctx.compression, ctx.half,
                               ctx.file_version, ctx.background,
                               leaf.value_mask, 512, leaf.values.data());
    }
}

// ----------------------------------------------------------------- file --

struct GridEntry {
    std::string name;
    std::string type;
    bool half = false;
    int64_t grid_pos = 0, block_pos = 0, end_pos = 0;
};

struct FileInfo {
    uint32_t file_version = 0;
    uint32_t compression = 0;
    std::vector<GridEntry> grids;
};

FileInfo read_file_header(Reader& r) {
    FileInfo info;
    if (r.i64() != kMagic) throw std::runtime_error("not a .vdb file");
    info.file_version = r.u32();
    if (info.file_version < kVerSelectiveCompression)
        throw std::runtime_error(
            "file version " + std::to_string(info.file_version) +
            " predates OpenVDB 2.x; re-save with a newer OpenVDB");
    r.u32();                               // library major
    r.u32();                               // library minor
    bool has_offsets = r.u8() != 0;
    if (!has_offsets)
        throw std::runtime_error("streamed (non-seekable) archive");
    if (info.file_version < kVerNodeMaskCompression) {
        // 220..221: one global "is compressed" byte
        info.compression = r.u8() ? kCompressZip : 0;
    } else {
        info.compression = kCompressZip | kCompressActiveMask;
        if (info.file_version >= kVerBloscCompression)
            info.compression |= kCompressBlosc;  // may be refined per grid
    }
    if (info.file_version >= kVerBoostUuid) r.skip(36);  // ascii uuid
    uint32_t grid_count = r.u32();
    for (uint32_t i = 0; i < grid_count; ++i) {
        GridEntry g;
        std::string unique = r.str();      // GridDescriptor::stripSuffix
        size_t sep = unique.find('\x1e');
        g.name = (sep == std::string::npos) ? unique : unique.substr(0, sep);
        g.type = r.str();
        const std::string kHalfSuffix = "_HalfFloat";
        if (g.type.size() > kHalfSuffix.size() &&
            g.type.compare(g.type.size() - kHalfSuffix.size(),
                           kHalfSuffix.size(), kHalfSuffix) == 0) {
            g.half = true;
            g.type = g.type.substr(0, g.type.size() - kHalfSuffix.size());
        }
        r.str();                           // instance-parent name
        g.grid_pos = r.i64();
        g.block_pos = r.i64();
        g.end_pos = r.i64();
        info.grids.push_back(g);
        r.seek_to(g.end_pos);                  // next descriptor
    }
    return info;
}

struct Meta { std::string type; std::vector<uint8_t> value; };

std::map<std::string, Meta> read_metadata(Reader& r) {
    std::map<std::string, Meta> out;
    uint32_t n = r.u32();
    for (uint32_t i = 0; i < n; ++i) {
        std::string name = r.str();
        Meta m;
        m.type = r.str();
        uint32_t sz = r.u32();
        const uint8_t* p = r.take(sz);
        m.value.assign(p, p + sz);
        out[name] = m;
    }
    return out;
}

// Transform::read — linear maps only; returns voxel size (diag scale).
void read_transform(Reader& r, double voxel_size[3]) {
    std::string map = r.str();
    voxel_size[0] = voxel_size[1] = voxel_size[2] = 1.0;
    auto vec3 = [&](double* v) { v[0] = r.f64(); v[1] = r.f64(); v[2] = r.f64(); };
    double tmp[3];
    if (map == "UniformScaleMap" || map == "ScaleMap") {
        // mScaleValues, mVoxelSize, mScaleValuesInverse, mInvScaleSqr,
        // mInvTwiceScale
        vec3(voxel_size); vec3(tmp); vec3(tmp); vec3(tmp); vec3(tmp);
    } else if (map == "UniformScaleTranslateMap" ||
               map == "ScaleTranslateMap") {
        // mTranslation then the five scale vectors
        vec3(tmp); vec3(voxel_size); vec3(tmp); vec3(tmp); vec3(tmp);
        vec3(tmp);
    } else if (map == "TranslateMap") {
        vec3(tmp);
    } else if (map == "AffineMap") {
        double m[16];
        for (double& x : m) x = r.f64();
        voxel_size[0] = m[0]; voxel_size[1] = m[5]; voxel_size[2] = m[10];
    } else {
        throw std::runtime_error("unsupported transform map: " + map);
    }
}

struct LoadedGrid {
    Tree tree;
    int32_t bbox_min[3], bbox_max[3];
    double voxel_size[3];
};

void active_bbox(const Tree& tree, int32_t mn[3], int32_t mx[3]) {
    bool any = false;
    auto extend = [&](int32_t x0, int32_t y0, int32_t z0, int32_t x1,
                      int32_t y1, int32_t z1) {
        if (!any) {
            mn[0] = x0; mn[1] = y0; mn[2] = z0;
            mx[0] = x1; mx[1] = y1; mx[2] = z1;
            any = true;
            return;
        }
        mn[0] = std::min(mn[0], x0); mn[1] = std::min(mn[1], y0);
        mn[2] = std::min(mn[2], z0);
        mx[0] = std::max(mx[0], x1); mx[1] = std::max(mx[1], y1);
        mx[2] = std::max(mx[2], z1);
    };
    for (const Tile& t : tree.tiles)
        extend(t.origin.x, t.origin.y, t.origin.z, t.origin.x + t.dim - 1,
               t.origin.y + t.dim - 1, t.origin.z + t.dim - 1);
    for (const LeafNode& leaf : tree.leaves) {
        for (size_t i = 0; i < 512; ++i) {
            if (!mask_bit(leaf.value_mask, i)) continue;
            int x, y, z;
            offset_to_xyz(i, 3, x, y, z);
            extend(leaf.origin.x + x, leaf.origin.y + y, leaf.origin.z + z,
                   leaf.origin.x + x, leaf.origin.y + y, leaf.origin.z + z);
        }
    }
    if (!any) throw std::runtime_error("grid has no active voxels");
}

// load_values=false: topology-only decode (tiles + leaf value masks) -
// enough for active_bbox/voxel_size without inflating any leaf payload,
// so vdb_probe does not pay the zlib cost of the whole grid.
LoadedGrid load_grid(Reader& r, const FileInfo& info, const GridEntry& g,
                     bool load_values = true) {
    LoadedGrid out;
    if (g.type != "Tree_float_5_4_3")
        throw std::runtime_error("unsupported grid type: " + g.type +
                                 " (only Tree_float_5_4_3)");
    r.seek_to(g.grid_pos);
    Context ctx;
    ctx.file_version = info.file_version;
    ctx.compression = info.compression;
    ctx.half = g.half;
    ctx.background = 0.0f;
    if (info.file_version >= kVerNodeMaskCompression)
        ctx.compression = r.u32();         // per-grid compression flags
    read_metadata(r);                      // skipped generically
    read_transform(r, out.voxel_size);
    out.tree = read_tree(r, ctx);
    if (load_values) {
        r.seek_to(g.block_pos);
        ctx.background = out.tree.background;
        read_leaf_buffers(r, ctx, out.tree);
    }
    active_bbox(out.tree, out.bbox_min, out.bbox_max);
    return out;
}

void fill_dense(const LoadedGrid& g, float* out) {
    const int32_t* mn = g.bbox_min;
    const int64_t X = g.bbox_max[0] - mn[0] + 1;
    const int64_t Y = g.bbox_max[1] - mn[1] + 1;
    const int64_t Z = g.bbox_max[2] - mn[2] + 1;
    const float bg = g.tree.background;
    for (int64_t i = 0; i < X * Y * Z; ++i) out[i] = bg;
    auto put = [&](int64_t x, int64_t y, int64_t z, float v) {
        x -= mn[0]; y -= mn[1]; z -= mn[2];
        if (x < 0 || y < 0 || z < 0 || x >= X || y >= Y || z >= Z) return;
        out[(x * Y + y) * Z + z] = v;
    };
    // clip each tile to the output window BEFORE iterating: a legal
    // root-level tile spans 4096^3 voxels, and unclipped loops would run
    // ~7e10 iterations even when the caller's bbox is small
    for (const Tile& t : g.tree.tiles) {
        const int64_t x0 = std::max<int64_t>(t.origin.x, mn[0]) - mn[0];
        const int64_t y0 = std::max<int64_t>(t.origin.y, mn[1]) - mn[1];
        const int64_t z0 = std::max<int64_t>(t.origin.z, mn[2]) - mn[2];
        const int64_t x1 = std::min<int64_t>(t.origin.x + t.dim - 1,
                                             g.bbox_max[0]) - mn[0];
        const int64_t y1 = std::min<int64_t>(t.origin.y + t.dim - 1,
                                             g.bbox_max[1]) - mn[1];
        const int64_t z1 = std::min<int64_t>(t.origin.z + t.dim - 1,
                                             g.bbox_max[2]) - mn[2];
        for (int64_t x = x0; x <= x1; ++x)
            for (int64_t y = y0; y <= y1; ++y)
                for (int64_t z = z0; z <= z1; ++z)
                    out[(x * Y + y) * Z + z] = t.value;
    }
    for (const LeafNode& leaf : g.tree.leaves) {
        for (size_t i = 0; i < 512; ++i) {
            if (!mask_bit(leaf.value_mask, i)) continue;
            int x, y, z;
            offset_to_xyz(i, 3, x, y, z);
            put(leaf.origin.x + x, leaf.origin.y + y, leaf.origin.z + z,
                leaf.values[i]);
        }
    }
}

const GridEntry* find_grid(const FileInfo& info, const char* name) {
    if (info.grids.empty()) return nullptr;
    if (!name || !name[0]) return &info.grids[0];
    for (const auto& g : info.grids)
        if (g.name == name) return &g;
    return nullptr;
}

void set_err(char* err, int errlen, const std::string& msg) {
    if (err && errlen > 0) {
        std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
    }
}

}  // namespace

extern "C" {

// bbox_out: [x0 y0 z0 x1 y1 z1] (inclusive active bounds)
int vdb_probe(const char* path, const char* grid_name, int32_t* bbox_out,
              double* voxel_size_out, char* err, int errlen) {
    try {
        Reader r(path);
        FileInfo info = read_file_header(r);
        const GridEntry* g = find_grid(info, grid_name);
        if (!g) { set_err(err, errlen, "grid not found"); return -2; }
        LoadedGrid grid = load_grid(r, info, *g, /*load_values=*/false);
        for (int i = 0; i < 3; ++i) {
            bbox_out[i] = grid.bbox_min[i];
            bbox_out[3 + i] = grid.bbox_max[i];
            voxel_size_out[i] = grid.voxel_size[i];
        }
        return 0;
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

// out must hold prod(bbox_max - bbox_min + 1) floats ((X, Y, Z) C-order).
int vdb_load(const char* path, const char* grid_name, float* out, char* err,
             int errlen) {
    try {
        Reader r(path);
        FileInfo info = read_file_header(r);
        const GridEntry* g = find_grid(info, grid_name);
        if (!g) { set_err(err, errlen, "grid not found"); return -2; }
        LoadedGrid grid = load_grid(r, info, *g);
        fill_dense(grid, out);
        return 0;
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

// newline-joined grid names into buf; returns count (or negative error).
int vdb_grid_names(const char* path, char* buf, int cap) {
    try {
        Reader r(path);
        FileInfo info = read_file_header(r);
        std::string joined;
        for (const auto& g : info.grids) {
            if (!joined.empty()) joined += '\n';
            joined += g.name;
        }
        std::snprintf(buf, static_cast<size_t>(cap), "%s", joined.c_str());
        return static_cast<int>(info.grids.size());
    } catch (const std::exception&) {
        return -1;
    }
}

}  // extern "C"
