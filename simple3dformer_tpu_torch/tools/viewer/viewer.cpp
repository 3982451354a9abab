// Offscreen voxel-grid renderer: the capability rebuild of the reference's
// closed-source `utils/viewvox` binary (Patrick Min's interactive viewer,
// documented in its utils/README.md:34-66). That tool is an OpenGL app
// with a mouse loop; a training host is headless, so the rebuild is a
// deterministic software raycaster driven from Python (tools/view_voxels.py)
// — same feature surface, scriptable. The port's copy of
// simple3dformer_tpu/tools/viewer/viewer.cpp: the code unchanged, built
// with the same flags, so both render bit-equal:
//   - internal-voxel removal by default (`-ki` keeps them)
//   - orthographic or perspective projection (`p` toggle)
//   - free azimuth/elevation/distance camera (mouse rotate/zoom; x/y/z views)
//   - alternating voxel colours (`a` toggle)
//   - single-slice display with optional neighbour slices (`s`/`n`/`j`/`k`)
//
// Rendering: Amanatides-Woo DDA traversal per pixel; first occupied voxel
// wins; Lambert-ish shading by entry-face axis; white background. A 128^3
// grid at 512^2 renders in ~10 ms — fine for dataset contact sheets.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Vec3 {
    double x, y, z;
};

Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
Vec3 operator*(Vec3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
Vec3 cross(Vec3 a, Vec3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
Vec3 norm(Vec3 a) {
    const double n = std::sqrt(a.x * a.x + a.y * a.y + a.z * a.z);
    return n > 0 ? a * (1.0 / n) : a;
}

struct Grid {
    const uint8_t* v;
    int64_t dx, dy, dz;
    int slice_axis;    // -1 off, else 0/1/2
    int64_t slice_lo, slice_hi;  // inclusive visible range on that axis
    bool occupied(int64_t x, int64_t y, int64_t z) const {
        if (x < 0 || y < 0 || z < 0 || x >= dx || y >= dy || z >= dz)
            return false;
        if (slice_axis == 0 && (x < slice_lo || x > slice_hi)) return false;
        if (slice_axis == 1 && (y < slice_lo || y > slice_hi)) return false;
        if (slice_axis == 2 && (z < slice_lo || z > slice_hi)) return false;
        return v[(x * dy + y) * dz + z] != 0;
    }
};

// Slab-method AABB intersection; returns false on miss.
bool aabb(const Vec3& o, const Vec3& d, double bx, double by, double bz,
          double* t0, double* t1) {
    double tmin = -1e30, tmax = 1e30;
    const double od[3] = {o.x, o.y, o.z};
    const double dd[3] = {d.x, d.y, d.z};
    const double hi[3] = {bx, by, bz};
    for (int i = 0; i < 3; ++i) {
        if (std::fabs(dd[i]) < 1e-12) {
            if (od[i] < 0 || od[i] > hi[i]) return false;
        } else {
            double a = (0 - od[i]) / dd[i], b = (hi[i] - od[i]) / dd[i];
            if (a > b) { double t = a; a = b; b = t; }
            if (a > tmin) tmin = a;
            if (b < tmax) tmax = b;
        }
    }
    if (tmax < tmin || tmax < 0) return false;
    *t0 = tmin > 0 ? tmin : 0;
    *t1 = tmax;
    return true;
}

}  // namespace

extern "C" {

// Remove voxels with no empty 6-neighbour (viewvox's default display mode;
// pass -ki upstream to skip). In/out may alias only if in == out is false;
// caller passes distinct buffers.
void s3f_hollow(const uint8_t* in, uint8_t* out, int64_t dx, int64_t dy,
                int64_t dz) {
    auto at = [&](int64_t x, int64_t y, int64_t z) -> uint8_t {
        if (x < 0 || y < 0 || z < 0 || x >= dx || y >= dy || z >= dz)
            return 0;
        return in[(x * dy + y) * dz + z];
    };
    for (int64_t x = 0; x < dx; ++x)
        for (int64_t y = 0; y < dy; ++y)
            for (int64_t z = 0; z < dz; ++z) {
                const int64_t i = (x * dy + y) * dz + z;
                if (!in[i]) { out[i] = 0; continue; }
                const bool interior =
                    at(x - 1, y, z) && at(x + 1, y, z) && at(x, y - 1, z) &&
                    at(x, y + 1, z) && at(x, y, z - 1) && at(x, y, z + 1);
                out[i] = interior ? 0 : 1;
            }
}

// Render grid[dx][dy][dz] (C order, 0/1) to out_rgb[height][width][3].
//   azim/elev in degrees (azim 0 = +x, counter-clockwise around +z;
//   elev 90 = looking straight down -z), dist_mult scales the max grid
//   extent (perspective camera distance), perspective 0 = orthographic.
//   alt_colors: 1 = checkerboard two-tone palette (viewvox 'a' toggle).
//   slice_axis -1 = full model; else 0/1/2 with slice_index and
//   neighbours = extra slices included on each side ('s'/'n' modes).
// Returns 0, or -1 on bad arguments.
int s3f_render_voxels(const uint8_t* grid, int64_t dx, int64_t dy, int64_t dz,
                      int width, int height, double azim_deg, double elev_deg,
                      double dist_mult, int perspective, int alt_colors,
                      int slice_axis, int64_t slice_index, int neighbours,
                      uint8_t* out_rgb) {
    if (dx <= 0 || dy <= 0 || dz <= 0 || width <= 0 || height <= 0)
        return -1;
    if (slice_axis > 2) return -1;
    Grid g{grid, dx, dy, dz, slice_axis, 0, 0};
    if (slice_axis >= 0) {
        const int64_t ext[3] = {dx, dy, dz};
        if (slice_index < 0 || slice_index >= ext[slice_axis]) return -1;
        g.slice_lo = slice_index - neighbours;
        g.slice_hi = slice_index + neighbours;
    }

    const double az = azim_deg * M_PI / 180.0;
    const double el = elev_deg * M_PI / 180.0;
    const Vec3 center{dx * 0.5, dy * 0.5, dz * 0.5};
    const double extent = std::fmax(std::fmax((double)dx, (double)dy),
                                    (double)dz);
    // forward = from eye toward the target
    const Vec3 back{std::cos(el) * std::cos(az), std::cos(el) * std::sin(az),
                    std::sin(el)};
    const Vec3 fwd = back * -1.0;
    Vec3 up0{0, 0, 1};
    if (std::fabs(fwd.z) > 0.999) up0 = {0, 1, 0};  // poles: pick another up
    const Vec3 right = norm(cross(fwd, up0));
    const Vec3 up = norm(cross(right, fwd));
    const double dist = dist_mult * extent;
    const Vec3 eye = center + back * dist;
    // view size: the whole model fits with a small margin
    const double half = extent * 0.75;
    const double fov_scale = half / dist;  // perspective: tan(half-fov)

    const double face_shade[3] = {0.80, 0.62, 1.00};  // x, y, z entry faces
    const uint8_t base_a[3] = {70, 130, 180};   // steel blue
    const uint8_t base_b[3] = {205, 133, 63};   // peru (alternating tone)

    for (int py = 0; py < height; ++py) {
        for (int px = 0; px < width; ++px) {
            // NDC in [-1, 1], y up
            const double nx = (2.0 * (px + 0.5) / width - 1.0);
            const double ny = (1.0 - 2.0 * (py + 0.5) / height);
            Vec3 o, d;
            if (perspective) {
                o = eye;
                d = norm(fwd + right * (nx * fov_scale * width / height)
                             + up * (ny * fov_scale));
            } else {
                o = eye + right * (nx * half * width / height)
                        + up * (ny * half);
                d = fwd;
            }
            uint8_t* px_out = out_rgb + (py * (int64_t)width + px) * 3;
            px_out[0] = px_out[1] = px_out[2] = 255;  // background
            double t0, t1;
            if (!aabb(o, d, (double)dx, (double)dy, (double)dz, &t0, &t1))
                continue;
            // DDA (Amanatides-Woo) from the entry point
            const Vec3 p = o + d * (t0 + 1e-9);
            int64_t cx = (int64_t)std::floor(p.x);
            int64_t cy = (int64_t)std::floor(p.y);
            int64_t cz = (int64_t)std::floor(p.z);
            cx = cx < 0 ? 0 : (cx >= dx ? dx - 1 : cx);
            cy = cy < 0 ? 0 : (cy >= dy ? dy - 1 : cy);
            cz = cz < 0 ? 0 : (cz >= dz ? dz - 1 : cz);
            const int sx = d.x > 0 ? 1 : -1, sy = d.y > 0 ? 1 : -1,
                      sz = d.z > 0 ? 1 : -1;
            const double inf = 1e30;
            const double tdx = std::fabs(d.x) > 1e-12 ? 1.0 / std::fabs(d.x)
                                                      : inf;
            const double tdy = std::fabs(d.y) > 1e-12 ? 1.0 / std::fabs(d.y)
                                                      : inf;
            const double tdz = std::fabs(d.z) > 1e-12 ? 1.0 / std::fabs(d.z)
                                                      : inf;
            double tmx = std::fabs(d.x) > 1e-12
                ? ((sx > 0 ? cx + 1 - p.x : p.x - cx) * tdx) : inf;
            double tmy = std::fabs(d.y) > 1e-12
                ? ((sy > 0 ? cy + 1 - p.y : p.y - cy) * tdy) : inf;
            double tmz = std::fabs(d.z) > 1e-12
                ? ((sz > 0 ? cz + 1 - p.z : p.z - cz) * tdz) : inf;
            int axis = std::fabs(fwd.x) >= std::fabs(fwd.y)
                ? (std::fabs(fwd.x) >= std::fabs(fwd.z) ? 0 : 2)
                : (std::fabs(fwd.y) >= std::fabs(fwd.z) ? 1 : 2);
            while (cx >= 0 && cy >= 0 && cz >= 0 && cx < dx && cy < dy &&
                   cz < dz) {
                if (g.occupied(cx, cy, cz)) {
                    const uint8_t* base =
                        (alt_colors && ((cx + cy + cz) & 1)) ? base_b : base_a;
                    const double s = face_shade[axis];
                    px_out[0] = (uint8_t)(base[0] * s);
                    px_out[1] = (uint8_t)(base[1] * s);
                    px_out[2] = (uint8_t)(base[2] * s);
                    break;
                }
                if (tmx <= tmy && tmx <= tmz) {
                    cx += sx; tmx += tdx; axis = 0;
                } else if (tmy <= tmz) {
                    cy += sy; tmy += tdy; axis = 1;
                } else {
                    cz += sz; tmz += tdz; axis = 2;
                }
            }
        }
    }
    return 0;
}

}  // extern "C"
