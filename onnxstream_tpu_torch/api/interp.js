// In-tab (offline) model.txt interpreter — no server, no WASM toolchain.
//
// The PyTorch/CUDA port's counterpart of the reference's in-browser WASM runtime
// (reference src/wasm.js + src/BUILD.bazel:1-134): the reference compiles its
// C++ interpreter to WebAssembly so models run entirely inside the tab; this
// file reproduces that capability as a dependency-free JavaScript interpreter
// of the same text IR (grammar: reference README.md:210-216, parser semantics:
// reference onnxstream.cpp:2445-2616). Execution is sequential fp32 NCHW with
// free-after-last-use (reference onnxstream.cpp:2784-2801) and per-op declared
// -shape validation (check_output_shape, reference onnxstream.cpp:3070-3089).
//
// The method surface is identical to api/client.js's Model (which mirrors the
// reference WASM glue), so browser examples swap backends by swapping the
// constructor:
//
//   const model = await InterpModel.create();        // no URL: runs in-tab
//   await model.read_string(modelTxt);
//   for (const {type, name} of ...) model.add_weights_file(type, name, buf);
//   await model.add_tensor("x", [1, 3, 640, 640], float32Buffer);
//   await model.run();
//   const { shape, data } = await model.get_tensor("y");
//
// Scope: the fp32 + int64 op set of the browser examples (YOLOv8n and the
// injected pre/post text ops, reference examples/YOLOv8n_wasm/index.html:413-
// 421). It is a capability surface, not a performance surface — the compute
// path for production is the port's runtime on the card (api/client.js
// against cli/serve_main.py).

"use strict";

(function (root, factory) {
    const api = factory();
    if (typeof module !== "undefined") module.exports = api;
    root.InterpModel = api.InterpModel;
})(typeof globalThis !== "undefined" ? globalThis : this, function () {

const INT64_MAX = 9223372036854775807n;

// ------------------------------------------------------------------ parsing

// `name(shape)` / `name(dtype:shape)` / empty-shape `name()` (dynamic).
// Mirrors onnxstream_tpu_torch/ir.py parse_tensor_string (reference
// onnxstream.cpp:2540-2616). uint8[scale,zp] annotations are recognized but
// rejected at run time (this interpreter is fp32-only).
function parseTensorString(s) {
    if (!s) return { name: "", dtype: null, shape: null };
    const lp = s.indexOf("(");
    if (lp <= 0 || !s.endsWith(")")) throw new Error(`invalid tensor format: ${s}`);
    const name = s.slice(0, lp);
    const body = s.slice(lp + 1, -1);
    let dtype = null, shapeStr = body;
    const colon = body.indexOf(":");
    if (colon !== -1) {
        dtype = body.slice(0, colon);
        shapeStr = body.slice(colon + 1);
    }
    let shape = null;
    if (shapeStr !== "") {
        shape = shapeStr.split(",").map(d => {
            const v = parseInt(d, 10);
            if (!(v >= 0)) throw new Error(`invalid dim in ${s}`);
            return v;
        });
    } else if (colon !== -1) {
        shape = []; // explicit dtype with empty shape = scalar weight
    }
    return { name, dtype, shape };
}

// One op line: `name:OpType*input:a;b*output:c*k:v;k:v` (reference
// Model::next_op_impl, onnxstream.cpp:2445).
function parseOpLine(line, lineno) {
    const vec = line.split("*");
    if (vec.length !== 3 && vec.length !== 4)
        throw new Error(`line ${lineno}: invalid op line`);
    const colon = vec[0].lastIndexOf(":");
    if (colon === -1) throw new Error(`line ${lineno}: missing ':' in op name field`);
    const name = vec[0].slice(0, colon) || `onnxstream_fallback_name_${lineno}`;
    const opType = vec[0].slice(colon + 1);
    if (!vec[1].startsWith("input:")) throw new Error(`line ${lineno}: bad input field`);
    if (!vec[2].startsWith("output:")) throw new Error(`line ${lineno}: bad output field`);
    const inputs = vec[1].slice(6).split(";").map(parseTensorString);
    const outputs = vec[2].slice(7).split(";").map(parseTensorString);
    const attrs = {};
    if (vec.length === 4 && vec[3]) {
        for (const pair of vec[3].split(";")) {
            if (!pair) continue;
            const c = pair.indexOf(":");
            if (c === -1) throw new Error(`line ${lineno}: invalid attribute ${pair}`);
            attrs[pair.slice(0, c)] = pair.slice(c + 1);
        }
    }
    return { name, opType, inputs, outputs, attrs };
}

const attrInts = (attrs, k, dflt) =>
    attrs[k] === undefined ? dflt : attrs[k].split(",").map(Number);
const attrInt = (attrs, k, dflt) =>
    attrs[k] === undefined ? dflt : parseInt(attrs[k], 10);

// ------------------------------------------------------------------ tensors

const numel = shape => shape.reduce((a, b) => a * b, 1);

function rowStrides(shape) {
    const st = new Array(shape.length);
    let acc = 1;
    for (let i = shape.length - 1; i >= 0; i--) { st[i] = acc; acc *= shape[i]; }
    return st;
}

// {shape: number[], dtype: 'float32'|'int64', data: Float32Array|Float64Array}
// int64 is held as Float64Array of Numbers (values in the browser op set are
// shapes/indices, far below 2^53); INT64_MAX sentinels clamp on decode.
// A TypedArray argument (e.g. the Uint8Array of a fetched .bin) carries raw
// BYTES to reinterpret — `new Float32Array(someUint8Array)` would instead
// CONVERT each byte to one float (4x the elements, values 0-255), silently
// corrupting every weight. View the underlying bytes, like client.js's
// raw-bytes HTTP path.
function asByteView(buffer) {
    if (buffer instanceof ArrayBuffer) return new Uint8Array(buffer.slice(0));
    if (ArrayBuffer.isView(buffer)) {
        return new Uint8Array(
            buffer.buffer.slice(buffer.byteOffset, buffer.byteOffset + buffer.byteLength));
    }
    return new Uint8Array(buffer);
}

function tensorFromBuffer(dtype, shape, buffer) {
    const bytes = asByteView(buffer);
    if (dtype === "float32") {
        const data = new Float32Array(bytes.buffer, 0, bytes.byteLength >> 2);
        if (shape && data.length !== numel(shape))
            throw new Error(`size mismatch: ${data.length} vs shape ${shape}`);
        return { shape, dtype, data };
    }
    if (dtype === "int64") {
        const big = new BigInt64Array(bytes.buffer, 0, bytes.byteLength >> 3);
        const data = new Float64Array(big.length);
        for (let i = 0; i < big.length; i++) {
            let v = big[i];
            if (v > 4503599627370495n) v = 4503599627370495n;   // 2^52-1 clamp
            if (v < -4503599627370496n) v = -4503599627370496n;
            data[i] = Number(v);
        }
        return { shape, dtype, data };
    }
    throw new Error(`unsupported tensor dtype for in-tab interpreter: ${dtype}`);
}

// ----------------------------------------------------------------- op impls

function opConv(x, w, b, attrs) {
    const [N, C, H, W] = x.shape;
    const [OC, ICg, KH, KW] = w.shape;
    const g = attrInt(attrs, "group", 1);
    const [sh, sw] = attrInts(attrs, "strides", [1, 1]);
    const [dh, dw] = attrInts(attrs, "dilations", [1, 1]);
    const [pt, pl, pb, pr] = attrInts(attrs, "pads", [0, 0, 0, 0]);
    if (C !== ICg * g) throw new Error("Conv: channel/group mismatch");
    const OH = Math.floor((H + pt + pb - dh * (KH - 1) - 1) / sh) + 1;
    const OW = Math.floor((W + pl + pr - dw * (KW - 1) - 1) / sw) + 1;
    const OCg = OC / g;
    const out = new Float32Array(N * OC * OH * OW);
    const xd = x.data, wd = w.data, bd = b ? b.data : null;
    const row = new Float64Array(OW); // f64 accumulation, rounded on store
    for (let n = 0; n < N; n++)
        for (let oc = 0; oc < OC; oc++) {
            const g_ = Math.floor(oc / OCg);
            const bias = bd ? bd[oc] : 0;
            for (let oy = 0; oy < OH; oy++) {
                row.fill(bias);
                const iy0 = oy * sh - pt;
                for (let icg = 0; icg < ICg; icg++) {
                    const ic = g_ * ICg + icg;
                    for (let ky = 0; ky < KH; ky++) {
                        const iy = iy0 + ky * dh;
                        if (iy < 0 || iy >= H) continue;
                        const xBase = ((n * C + ic) * H + iy) * W;
                        const wBase = ((oc * ICg + icg) * KH + ky) * KW;
                        for (let kx = 0; kx < KW; kx++) {
                            const wv = wd[wBase + kx];
                            const xoff = kx * dw - pl;
                            // ox range keeping ix = ox*sw + xoff inside [0, W)
                            const lo = Math.max(0, Math.ceil(-xoff / sw));
                            const hi = Math.min(OW, Math.ceil((W - xoff) / sw));
                            for (let ox = lo; ox < hi; ox++)
                                row[ox] += wv * xd[xBase + ox * sw + xoff];
                        }
                    }
                }
                out.set(row.map(Math.fround), ((n * OC + oc) * OH + oy) * OW);
            }
        }
    return { shape: [N, OC, OH, OW], dtype: "float32", data: out };
}

function opMaxPool(x, attrs) {
    const [N, C, H, W] = x.shape;
    const [kh, kw] = attrInts(attrs, "kernel_shape", [1, 1]);
    const [sh, sw] = attrInts(attrs, "strides", [1, 1]);
    const [pt, pl, pb, pr] = attrInts(attrs, "pads", [0, 0, 0, 0]);
    const OH = Math.floor((H + pt + pb - kh) / sh) + 1;
    const OW = Math.floor((W + pl + pr - kw) / sw) + 1;
    const out = new Float32Array(N * C * OH * OW);
    const xd = x.data;
    for (let nc = 0; nc < N * C; nc++) {
        const xBase = nc * H * W, oBase = nc * OH * OW;
        for (let oy = 0; oy < OH; oy++)
            for (let ox = 0; ox < OW; ox++) {
                let m = -Infinity;
                const iy0 = oy * sh - pt, ix0 = ox * sw - pl;
                for (let ky = 0; ky < kh; ky++) {
                    const iy = iy0 + ky;
                    if (iy < 0 || iy >= H) continue;
                    for (let kx = 0; kx < kw; kx++) {
                        const ix = ix0 + kx;
                        if (ix < 0 || ix >= W) continue;
                        const v = xd[xBase + iy * W + ix];
                        if (v > m) m = v;
                    }
                }
                out[oBase + oy * OW + ox] = m;
            }
    }
    return { shape: [N, C, OH, OW], dtype: "float32", data: out };
}

function broadcastShapes(a, b) {
    const n = Math.max(a.length, b.length), out = new Array(n);
    for (let i = 0; i < n; i++) {
        const da = a[a.length - n + i] ?? 1, db = b[b.length - n + i] ?? 1;
        if (da !== db && da !== 1 && db !== 1)
            throw new Error(`cannot broadcast ${a} with ${b}`);
        out[i] = Math.max(da, db);
    }
    return out;
}

// dtype rule: int64 op int64 stays int64 (position/shape arithmetic feeding
// Gather/Less), everything else is float32; comparisons produce "bool"
// (0/1 in a Float32Array).
function binaryOutDtype(a, b, forced) {
    if (forced) return forced;
    return a.dtype === "int64" && b.dtype === "int64" ? "int64" : "float32";
}
const newData = (dtype, n) =>
    dtype === "int64" ? new Float64Array(n) : new Float32Array(n);

function opBinary(a, b, fn, forcedDtype) {
    const dtype = binaryOutDtype(a, b, forcedDtype);
    // fast paths: identical shapes, scalar rhs/lhs
    if (String(a.shape) === String(b.shape)) {
        const out = newData(dtype, a.data.length);
        for (let i = 0; i < out.length; i++) out[i] = fn(a.data[i], b.data[i]);
        return { shape: a.shape.slice(), dtype, data: out };
    }
    if (b.data.length === 1) {
        const s = b.data[0], out = newData(dtype, a.data.length);
        for (let i = 0; i < out.length; i++) out[i] = fn(a.data[i], s);
        return { shape: a.shape.slice(), dtype, data: out };
    }
    if (a.data.length === 1) {
        const s = a.data[0], out = newData(dtype, b.data.length);
        for (let i = 0; i < out.length; i++) out[i] = fn(s, b.data[i]);
        return { shape: b.shape.slice(), dtype, data: out };
    }
    const shape = broadcastShapes(a.shape, b.shape);
    const n = shape.length, total = numel(shape);
    const pad = (sh) => Array(n - sh.length).fill(1).concat(sh);
    const sa = pad(a.shape), sb = pad(b.shape);
    const sta = rowStrides(sa), stb = rowStrides(sb);
    for (let i = 0; i < n; i++) { if (sa[i] === 1) sta[i] = 0; if (sb[i] === 1) stb[i] = 0; }
    const out = newData(dtype, total);
    const idx = new Array(n).fill(0);
    let ia = 0, ib = 0;
    for (let o = 0; o < total; o++) {
        out[o] = fn(a.data[ia], b.data[ib]);
        for (let d = n - 1; d >= 0; d--) {
            idx[d]++; ia += sta[d]; ib += stb[d];
            if (idx[d] < shape[d]) break;
            idx[d] = 0; ia -= shape[d] * sta[d]; ib -= shape[d] * stb[d];
        }
    }
    return { shape, dtype, data: out };
}

// (cond ? x : y) with full three-way broadcasting.
function opWhere(c, x, y) {
    const shape = broadcastShapes(broadcastShapes(c.shape, x.shape), y.shape);
    const n = shape.length, total = numel(shape);
    const pad = (sh) => Array(n - sh.length).fill(1).concat(sh);
    const mk = (t) => {
        const s = pad(t.shape), st = rowStrides(s);
        for (let i = 0; i < n; i++) if (s[i] === 1) st[i] = 0;
        return st;
    };
    const stc = mk(c), stx = mk(x), sty = mk(y);
    const dtype = binaryOutDtype(x, y);
    const out = newData(dtype, total);
    const idx = new Array(n).fill(0);
    let ic = 0, ix = 0, iy = 0;
    for (let o = 0; o < total; o++) {
        out[o] = c.data[ic] ? x.data[ix] : y.data[iy];
        for (let d = n - 1; d >= 0; d--) {
            idx[d]++; ic += stc[d]; ix += stx[d]; iy += sty[d];
            if (idx[d] < shape[d]) break;
            idx[d] = 0;
            ic -= shape[d] * stc[d]; ix -= shape[d] * stx[d]; iy -= shape[d] * sty[d];
        }
    }
    return { shape, dtype, data: out };
}

// numpy-semantics batched matmul: (..., M, K) x (..., K, N) with broadcast
// batch dims; a 2-D rhs is the plain weight case.
function opMatMul(a, b) {
    const an = a.shape.length, bn = b.shape.length;
    if (an < 2 || bn < 2) throw new Error("MatMul: inputs must be >= 2-D");
    const M = a.shape[an - 2], K = a.shape[an - 1];
    const Kb = b.shape[bn - 2], N = b.shape[bn - 1];
    if (K !== Kb) throw new Error(`MatMul: K mismatch ${K} vs ${Kb}`);
    const batchShape = broadcastShapes(a.shape.slice(0, -2), b.shape.slice(0, -2));
    const nb = batchShape.length, batch = numel(batchShape);
    const pad = (sh) => Array(nb - sh.length).fill(1).concat(sh);
    const sa = pad(a.shape.slice(0, -2)), sb = pad(b.shape.slice(0, -2));
    // element-offset strides over the batch dims (matrix block = one entry)
    const sta = new Array(nb).fill(0), stb = new Array(nb).fill(0);
    for (let i = nb - 1, accA = M * K, accB = K * N; i >= 0; i--) {
        sta[i] = sa[i] === 1 ? 0 : accA;
        stb[i] = sb[i] === 1 ? 0 : accB;
        accA *= sa[i]; accB *= sb[i];
    }
    const out = new Float32Array(batch * M * N);
    const idx = new Array(nb).fill(0);
    let baseA = 0, baseB = 0;
    for (let bi = 0; bi < batch; bi++) {
        const oBase = bi * M * N;
        for (let m = 0; m < M; m++) {
            const aRow = baseA + m * K, oRow = oBase + m * N;
            for (let n2 = 0; n2 < N; n2++) {
                let acc = 0;
                for (let k = 0; k < K; k++) acc += a.data[aRow + k] * b.data[baseB + k * N + n2];
                out[oRow + n2] = Math.fround(acc);
            }
        }
        for (let d = nb - 1; d >= 0; d--) {
            idx[d]++; baseA += sta[d]; baseB += stb[d];
            if (idx[d] < batchShape[d]) break;
            idx[d] = 0; baseA -= batchShape[d] * sta[d]; baseB -= batchShape[d] * stb[d];
        }
    }
    return { shape: batchShape.concat([M, N]), dtype: "float32", data: out };
}

function opReduceMean(x, axes, keepdims) {
    const n = x.shape.length;
    const red = new Set(axes.map(a => a < 0 ? a + n : a));
    const outShapeKept = x.shape.map((d, i) => red.has(i) ? 1 : d);
    const outSt = rowStrides(outShapeKept);
    const mapSt = outSt.map((s, i) => red.has(i) ? 0 : s);
    const count = x.shape.reduce((acc, d, i) => red.has(i) ? acc * d : acc, 1);
    const out = new Float32Array(numel(outShapeKept));
    const idx = new Array(n).fill(0);
    let oi = 0;
    for (let i = 0; i < x.data.length; i++) {
        out[oi] += x.data[i];
        for (let d = n - 1; d >= 0; d--) {
            idx[d]++; oi += mapSt[d];
            if (idx[d] < x.shape[d]) break;
            idx[d] = 0; oi -= x.shape[d] * mapSt[d];
        }
    }
    for (let i = 0; i < out.length; i++) out[i] /= count;
    const shape = keepdims ? outShapeKept
        : x.shape.filter((_, i) => !red.has(i));
    return { shape: shape.length ? shape : [1], dtype: "float32", data: out };
}

function opGather(data, indices, axis) {
    const n = data.shape.length;
    if (axis < 0) axis += n;
    const outer = data.shape.slice(0, axis).reduce((a, b) => a * b, 1);
    const inner = data.shape.slice(axis + 1).reduce((a, b) => a * b, 1);
    const ax = data.shape[axis];
    const shape = data.shape.slice(0, axis)
        .concat(indices.shape, data.shape.slice(axis + 1));
    const out = newData(data.dtype, Math.max(numel(shape), 0));
    const rowIn = ax * inner;
    const nIdx = indices.data.length;
    for (let o = 0; o < outer; o++)
        for (let j = 0; j < nIdx; j++) {
            let k = indices.data[j];
            if (k < 0) k += ax;
            if (k < 0 || k >= ax) throw new Error(`Gather: index ${k} out of range ${ax}`);
            out.set(data.data.subarray(o * rowIn + k * inner, o * rowIn + (k + 1) * inner),
                    (o * nIdx + j) * inner);
        }
    return { shape, dtype: data.dtype, data: out };
}

// ONNX ScatterND: copy of data with updates written at the index tuples.
function opScatterND(data, indices, updates) {
    const n = data.shape.length;
    const K = indices.shape[indices.shape.length - 1];
    const slab = data.shape.slice(K).reduce((a, b) => a * b, 1);
    const st = rowStrides(data.shape);
    const out = newData(data.dtype, data.data.length);
    out.set(data.data);
    const nTuples = indices.data.length / K;
    for (let t = 0; t < nTuples; t++) {
        let off = 0;
        for (let j = 0; j < K; j++) {
            let v = indices.data[t * K + j];
            if (v < 0) v += data.shape[j];
            off += v * st[j];
        }
        out.set(updates.data.subarray(t * slab, (t + 1) * slab), off);
    }
    return { shape: data.shape.slice(), dtype: data.dtype, data: out };
}

function opTranspose(x, perm) {
    const n = x.shape.length;
    perm = perm ?? Array.from({ length: n }, (_, i) => n - 1 - i);
    const outShape = perm.map(p => x.shape[p]);
    const inSt = rowStrides(x.shape);
    const permSt = perm.map(p => inSt[p]);
    const total = numel(outShape);
    const out = x.dtype === "int64" ? new Float64Array(total) : new Float32Array(total);
    const idx = new Array(n).fill(0);
    let ii = 0;
    for (let o = 0; o < total; o++) {
        out[o] = x.data[ii];
        for (let d = n - 1; d >= 0; d--) {
            idx[d]++; ii += permSt[d];
            if (idx[d] < outShape[d]) break;
            idx[d] = 0; ii -= outShape[d] * permSt[d];
        }
    }
    return { shape: outShape, dtype: x.dtype, data: out };
}

function opConcat(inputs, axis) {
    const n = inputs[0].shape.length;
    if (axis < 0) axis += n;
    const outShape = inputs[0].shape.slice();
    outShape[axis] = inputs.reduce((a, t) => a + t.shape[axis], 0);
    const outer = inputs[0].shape.slice(0, axis).reduce((a, b) => a * b, 1);
    const inner = inputs[0].shape.slice(axis + 1).reduce((a, b) => a * b, 1);
    // dtype propagates like opBinary: int64 only when EVERY input is int64
    // (shape/index concats feeding Reshape/Gather must stay integer-typed)
    const dtype = inputs.every(t => t.dtype === "int64") ? "int64" : "float32";
    const out = newData(dtype, numel(outShape));
    const rowOut = outShape[axis] * inner;
    let off = 0;
    for (const t of inputs) {
        const rowIn = t.shape[axis] * inner;
        for (let o = 0; o < outer; o++)
            out.set(t.data.subarray(o * rowIn, (o + 1) * rowIn), o * rowOut + off);
        off += rowIn;
    }
    return { shape: outShape, dtype, data: out };
}

function opSplit(x, sizes, axis) {
    const n = x.shape.length;
    if (axis < 0) axis += n;
    const outer = x.shape.slice(0, axis).reduce((a, b) => a * b, 1);
    const inner = x.shape.slice(axis + 1).reduce((a, b) => a * b, 1);
    const rowIn = x.shape[axis] * inner;
    let off = 0;
    return sizes.map(sz => {
        const shape = x.shape.slice(); shape[axis] = sz;
        const rowOut = sz * inner;
        const out = x.dtype === "int64" ? new Float64Array(outer * rowOut)
                                        : new Float32Array(outer * rowOut);
        for (let o = 0; o < outer; o++)
            out.set(x.data.subarray(o * rowIn + off, o * rowIn + off + rowOut), o * rowOut);
        off += rowOut;
        return { shape, dtype: x.dtype, data: out };
    });
}

function opReshape(x, shapeSpec) {
    const total = numel(x.shape);
    let minus1 = -1, known = 1;
    const shape = shapeSpec.map((v, i) => {
        if (v === -1) { minus1 = i; return -1; }
        if (v === 0) { const d = x.shape[i]; known *= d; return d; } // allowzero:0
        known *= v; return v;
    });
    if (minus1 >= 0) shape[minus1] = total / known;
    if (numel(shape) !== total) throw new Error(`Reshape: ${x.shape} -> ${shapeSpec}`);
    return { shape, dtype: x.dtype, data: x.data };
}

function opSlice(x, starts, ends, axes, steps) {
    const n = x.shape.length;
    const st = x.shape.map(() => 0), en = x.shape.slice(), sp = x.shape.map(() => 1);
    for (let i = 0; i < starts.length; i++) {
        let ax = axes ? axes[i] : i;
        if (ax < 0) ax += n;
        const d = x.shape[ax];
        const step = steps ? steps[i] : 1;
        if (step === 0) throw new Error("Slice: step 0");
        let s = starts[i], e = ends[i];
        if (s < 0) s += d;
        if (e < 0) e += d;
        if (step > 0) {
            st[ax] = Math.min(Math.max(s, 0), d);
            en[ax] = Math.min(Math.max(e, 0), d);
        } else {
            // negative step: start clamps to [0, d-1], end to [-1, d-1]
            // (ONNX Slice-13; e may legitimately be -1-before-wrap = "past
            // the first element", which the caller passes as e-d after wrap)
            st[ax] = Math.min(Math.max(s, 0), d - 1);
            en[ax] = Math.min(Math.max(ends[i] < 0 && ends[i] + d < 0 ? -1 : e, -1), d - 1);
        }
        sp[ax] = step;
    }
    const outShape = st.map((s, i) => Math.max(Math.ceil((en[i] - s) / sp[i]), 0));
    const inSt = rowStrides(x.shape);
    const total = numel(outShape);
    const out = x.dtype === "int64" ? new Float64Array(total) : new Float32Array(total);
    if (total === 0) return { shape: outShape, dtype: x.dtype, data: out };
    const allUnit = sp.every(v => v === 1);
    if (allUnit) {
        const idx = new Array(n).fill(0);
        let base = st.reduce((a, s, i) => a + s * inSt[i], 0);
        const lastLen = outShape[n - 1];
        for (let o = 0; o < total; o += lastLen) {
            out.set(x.data.subarray(base, base + lastLen), o);
            for (let d = n - 2; d >= 0; d--) {
                idx[d]++; base += inSt[d];
                if (idx[d] < outShape[d]) break;
                idx[d] = 0; base -= outShape[d] * inSt[d];
            }
        }
        return { shape: outShape, dtype: x.dtype, data: out };
    }
    // general strided walk (reverse/step slices are rare and small)
    const idx = new Array(n).fill(0);
    for (let o = 0; o < total; o++) {
        let base = 0;
        for (let d = 0; d < n; d++) base += (st[d] + idx[d] * sp[d]) * inSt[d];
        out[o] = x.data[base];
        for (let d = n - 1; d >= 0; d--) {
            idx[d]++;
            if (idx[d] < outShape[d]) break;
            idx[d] = 0;
        }
    }
    return { shape: outShape, dtype: x.dtype, data: out };
}

function opResizeNearest(x, scales, attrs) {
    // nearest / asymmetric / floor — the converted-model configuration
    // (reference onnxstream.cpp:6120-6314 supports exactly this family).
    if ((attrs.mode ?? "nearest") !== "nearest")
        throw new Error("Resize: only nearest supported in-tab");
    const [N, C, H, W] = x.shape;
    const OH = Math.floor(H * scales[2]), OW = Math.floor(W * scales[3]);
    const out = new Float32Array(N * C * OH * OW);
    const mapY = new Int32Array(OH), mapX = new Int32Array(OW);
    for (let oy = 0; oy < OH; oy++) mapY[oy] = Math.min(Math.floor(oy / scales[2]), H - 1);
    for (let ox = 0; ox < OW; ox++) mapX[ox] = Math.min(Math.floor(ox / scales[3]), W - 1);
    for (let nc = 0; nc < N * C; nc++) {
        const xBase = nc * H * W, oBase = nc * OH * OW;
        for (let oy = 0; oy < OH; oy++) {
            const ib = xBase + mapY[oy] * W;
            const ob = oBase + oy * OW;
            for (let ox = 0; ox < OW; ox++) out[ob + ox] = x.data[ib + mapX[ox]];
        }
    }
    return { shape: [N, C, OH, OW], dtype: "float32", data: out };
}

function opSoftmax(x, axis) {
    const n = x.shape.length;
    if (axis < 0) axis += n;
    const ax = x.shape[axis];
    const inner = x.shape.slice(axis + 1).reduce((a, b) => a * b, 1);
    const outer = x.shape.slice(0, axis).reduce((a, b) => a * b, 1);
    const out = new Float32Array(x.data.length);
    for (let o = 0; o < outer; o++)
        for (let i = 0; i < inner; i++) {
            const base = o * ax * inner + i;
            let m = -Infinity;
            for (let k = 0; k < ax; k++) m = Math.max(m, x.data[base + k * inner]);
            let sum = 0;
            for (let k = 0; k < ax; k++) {
                const e = Math.exp(x.data[base + k * inner] - m);
                out[base + k * inner] = e; sum += e;
            }
            for (let k = 0; k < ax; k++) out[base + k * inner] /= sum;
        }
    return { shape: x.shape.slice(), dtype: "float32", data: out };
}

const UNARY = {
    Sigmoid: v => 1 / (1 + Math.exp(-v)),
    Sqrt: Math.sqrt, Erf: (v) => {
        // Abramowitz-Stegun 7.1.26 (matches fp32 tolerance)
        const s = v < 0 ? -1 : 1, t = 1 / (1 + 0.3275911 * Math.abs(v));
        const y = 1 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
            - 0.284496736) * t + 0.254829592) * t * Math.exp(-v * v);
        return s * y;
    },
    Cos: Math.cos, Sin: Math.sin, Neg: v => -v, Relu: v => Math.max(v, 0),
    Exp: Math.exp, Tanh: Math.tanh,
};

// --------------------------------------------------------------- the Model

class InterpModel {
    constructor() {
        this.ops = [];
        this.weights = new Map();     // name -> tensor
        this.pushed = new Map();      // name -> tensor (add_tensor)
        this.results = new Map();     // name -> tensor (after run)
        this.extraOutputs = new Set();
        this.options = {};
    }

    // Same construction call shape as client.js Model.create(baseUrl, wp);
    // both arguments are meaningless in-tab and ignored.
    static async create() { return new InterpModel(); }

    async read_string(text) {
        this.ops = [];
        let lineno = 0;
        for (const raw of text.split("\n")) {
            lineno++;
            const line = raw.trim();
            if (!line || line.startsWith("#")) continue;  // ir.py parity
            this.ops.push(parseOpLine(line, lineno));
        }
    }

    // Manifest in the reference exports.cpp:111-148 format: "type:name|...".
    async get_weights_names() {
        const seen = new Set(), parts = [];
        for (const op of this.ops)
            for (const t of op.inputs)
                if (t.dtype && !seen.has(t.name)) {
                    seen.add(t.name);
                    parts.push(`${t.dtype}:${t.name}`);
                }
        return parts.join("|");
    }

    async add_weights_file(type, name, buffer) {
        this.weights.set(name, tensorFromBuffer(type, null, buffer));
    }

    async add_tensor(name, shape, buffer, type) {
        type = typeof type === "string" ? type : "float32";
        if (Array.isArray(buffer)) {
            buffer = type === "int64"
                ? new BigInt64Array(buffer.map(BigInt)).buffer
                : new Float32Array(buffer).buffer;
        }
        this.pushed.set(name, tensorFromBuffer(type, shape.slice(), buffer));
    }

    async get_tensor(name) {
        const t = this.results.get(name);
        if (!t) throw new Error(`no tensor named ${name}`);
        return { shape: t.shape.slice(), data: Float32Array.from(t.data) };
    }

    async get_all_tensor_names() { return [...this.results.keys()]; }
    async set_option(name, value) { this.options[name] = !!value; }
    async add_extra_output(name) { this.extraOutputs.add(name); }
    async clear_tensors() { this.pushed.clear(); this.results.clear(); }
    async delete() { this.weights.clear(); this.clear_tensors(); }

    _get(pool, spec, refs) {
        const name = spec.name;
        if (pool.has(name)) {
            const t = pool.get(name);
            if (refs && --refs[name] === 0 && !this.extraOutputs.has(name))
                pool.delete(name); // free-after-last-use (reference 2784-2801)
            return t;
        }
        const w = this.weights.get(name);
        if (w) {
            if (spec.shape && w.data.length !== numel(spec.shape))
                throw new Error(`weight ${name}: size ${w.data.length} != shape ${spec.shape}`);
            return { shape: spec.shape ?? [w.data.length], dtype: w.dtype, data: w.data };
        }
        throw new Error(`missing tensor/weight: ${name}`);
    }

    async run() {
        const pool = new Map(this.pushed);
        const refs = {};
        for (const op of this.ops)
            for (const t of op.inputs)
                if (t.name && !this.weights.has(t.name)) refs[t.name] = (refs[t.name] || 0) + 1;

        for (const op of this.ops) {
            const get = i => this._get(pool, op.inputs[i], refs);
            const a = op.attrs;
            let outs;
            switch (op.opType) {
                case "Conv": {
                    const x = get(0), w = get(1);
                    const b = op.inputs.length > 2 && op.inputs[2].name ? get(2) : null;
                    outs = [opConv(x, w, b, a)];
                    break;
                }
                case "MaxPool": outs = [opMaxPool(get(0), a)]; break;
                case "Add": outs = [opBinary(get(0), get(1), (u, v) => u + v)]; break;
                case "Sub": outs = [opBinary(get(0), get(1), (u, v) => u - v)]; break;
                case "Mul": outs = [opBinary(get(0), get(1), (u, v) => u * v)]; break;
                case "Div": outs = [opBinary(get(0), get(1), (u, v) => u / v)]; break;
                case "Pow": outs = [opBinary(get(0), get(1), Math.pow)]; break;
                case "Concat":
                    outs = [opConcat(op.inputs.map((_, i) => get(i)), attrInt(a, "axis", 0))];
                    break;
                case "Split": {
                    const x = get(0);
                    // sizes: 'split' attr first, then input 1, then the
                    // ceil-based uneven default (last chunk takes the
                    // remainder) — the Python twin's order (ops/standard.py
                    // _split)
                    let sizes = attrInts(a, "split", null);
                    if (!sizes && op.inputs.length > 1 && op.inputs[1].name)
                        sizes = Array.from(get(1).data);
                    if (!sizes) {
                        let ax = attrInt(a, "axis", 0);
                        if (ax < 0) ax += x.shape.length;
                        const d = x.shape[ax], nOut = op.outputs.length;
                        const base = Math.ceil(d / nOut);
                        sizes = op.outputs.map((_, i) =>
                            i === nOut - 1 ? d - base * (nOut - 1) : base);
                    }
                    outs = opSplit(x, sizes, attrInt(a, "axis", 0));
                    break;
                }
                case "Reshape": outs = [opReshape(get(0), Array.from(get(1).data))]; break;
                case "Transpose": outs = [opTranspose(get(0), attrInts(a, "perm", null))]; break;
                case "Slice": {
                    const x = get(0);
                    const starts = Array.from(get(1).data), ends = Array.from(get(2).data);
                    const axes = op.inputs.length > 3 && op.inputs[3].name
                        ? Array.from(get(3).data) : null;
                    const steps = op.inputs.length > 4 && op.inputs[4].name
                        ? Array.from(get(4).data) : null;
                    outs = [opSlice(x, starts, ends, axes, steps)];
                    break;
                }
                case "Resize": {
                    const x = get(0);
                    // input 1 is the (always empty here) roi; input 2 = scales
                    const scales = Array.from(get(2).data);
                    outs = [opResizeNearest(x, scales, a)];
                    break;
                }
                case "Softmax": outs = [opSoftmax(get(0), attrInt(a, "axis", -1))]; break;
                case "MatMul": outs = [opMatMul(get(0), get(1))]; break;
                case "Identity": {
                    const x = get(0);
                    outs = [{ shape: x.shape.slice(), dtype: x.dtype, data: x.data }];
                    break;
                }
                case "Less":
                    outs = [opBinary(get(0), get(1), (u, v) => u < v ? 1 : 0, "bool")];
                    break;
                case "Greater":
                    outs = [opBinary(get(0), get(1), (u, v) => u > v ? 1 : 0, "bool")];
                    break;
                case "Equal":
                    outs = [opBinary(get(0), get(1), (u, v) => u === v ? 1 : 0, "bool")];
                    break;
                case "Where": outs = [opWhere(get(0), get(1), get(2))]; break;
                case "ReduceMean": {
                    const x = get(0);
                    const axes = op.inputs.length > 1 && op.inputs[1].name
                        ? Array.from(get(1).data)
                        : attrInts(a, "axes", x.shape.map((_, i) => i));
                    outs = [opReduceMean(x, axes, attrInt(a, "keepdims", 1) !== 0)];
                    break;
                }
                case "Gather":
                    outs = [opGather(get(0), get(1), attrInt(a, "axis", 0))];
                    break;
                case "ScatterND": outs = [opScatterND(get(0), get(1), get(2))]; break;
                case "Unsqueeze": {
                    const x = get(0);
                    const axes = op.inputs.length > 1 && op.inputs[1].name
                        ? Array.from(get(1).data) : attrInts(a, "axes", []);
                    const nOut = x.shape.length + axes.length;
                    const norm = axes.map(v => v < 0 ? v + nOut : v).sort((u, v) => u - v);
                    const shape = x.shape.slice();
                    for (const ax of norm) shape.splice(ax, 0, 1);
                    outs = [{ shape, dtype: x.dtype, data: x.data }];
                    break;
                }
                case "Squeeze": {
                    const x = get(0);
                    const axes = op.inputs.length > 1 && op.inputs[1].name
                        ? Array.from(get(1).data) : attrInts(a, "axes", []);
                    const norm = new Set(axes.map(v => v < 0 ? v + x.shape.length : v));
                    const shape = x.shape.filter((d, i) =>
                        norm.size ? !norm.has(i) : d !== 1);
                    outs = [{ shape, dtype: x.dtype, data: x.data }];
                    break;
                }
                case "Flatten": {
                    const x = get(0);
                    const ax = attrInt(a, "axis", 1);
                    const d0 = x.shape.slice(0, ax).reduce((u, v) => u * v, 1);
                    outs = [{ shape: [d0, numel(x.shape) / d0], dtype: x.dtype, data: x.data }];
                    break;
                }
                default:
                    if (UNARY[op.opType]) {
                        const x = get(0);
                        const out = new Float32Array(x.data.length);
                        const f = UNARY[op.opType];
                        for (let i = 0; i < out.length; i++) out[i] = f(x.data[i]);
                        outs = [{ shape: x.shape.slice(), dtype: "float32", data: out }];
                        break;
                    }
                    throw new Error(`op ${op.opType} not supported by the in-tab interpreter`);
            }
            if (outs.length !== op.outputs.length)
                throw new Error(`${op.name}: produced ${outs.length} outputs, declared ${op.outputs.length}`);
            for (let i = 0; i < outs.length; i++) {
                const decl = op.outputs[i].shape;
                if (decl && decl.length &&
                    String(decl) !== String(outs[i].shape))
                    throw new Error(
                        `${op.name}: output ${op.outputs[i].name} shape ` +
                        `${outs[i].shape} != declared ${decl}`);
                pool.set(op.outputs[i].name, outs[i]);
            }
        }
        this.results = pool;
    }
}

return { InterpModel };
});
