// Browser/node client for the onnxstream_tpu_torch HTTP model server
// (onnxstream_tpu_torch/cli/serve_main.py). Method surface mirrors the
// reference WASM glue's Model class (reference src/wasm.js) so browser
// examples port by swapping the constructor; execution happens server-side
// on the card (an NVIDIA GPU, or the CPU where the server runs --device cpu).
//
//   const model = await Model.create("http://localhost:8080", "dict");
//   await model.add_weights_file("float32", "w.bin", buffer);
//   await model.read_string(modelTxt);
//   await model.add_tensor("x", [2, 3], float32Buffer);
//   await model.run();
//   const { shape, data } = await model.get_tensor("y");
//   await model.delete();

"use strict";

class Model {
    constructor(baseUrl, handle) {
        this.base = baseUrl.endsWith("/") ? baseUrl.slice(0, -1) : baseUrl;
        this.handle = handle;
    }

    static async create(baseUrl, weightsProviderName) {
        const wp = weightsProviderName || "dict";
        const r = await fetch(`${baseUrl.endsWith("/") ? baseUrl.slice(0, -1) : baseUrl}/models?wp=${encodeURIComponent(wp)}`, { method: "POST" });
        const j = await r.json();
        if (j.error) throw new Error(j.error);
        return new Model(baseUrl, j.handle);
    }

    async _check(r) {
        const ct = r.headers.get("Content-Type") || "";
        if (ct.includes("json")) {
            const j = await r.json();
            if (j.error) throw new Error(j.error);
            return j;
        }
        return r;
    }

    async read_string(str) {
        await this._check(await fetch(`${this.base}/models/${this.handle}/read_string`, {
            method: "POST", body: str,
        }));
    }

    async get_weights_names() {
        const r = await fetch(`${this.base}/models/${this.handle}/weights_names`);
        return await r.text();
    }

    async add_weights_file(type, name, buffer) {
        await this._check(await fetch(
            `${this.base}/models/${this.handle}/weights/${encodeURIComponent(name)}?type=${type}`,
            { method: "PUT", body: buffer }));
    }

    async add_tensor(name, shape, buffer, type) {
        type = typeof type === "string" ? type : "float32";
        let body = buffer;
        if (Array.isArray(buffer)) {
            body = type === "int64" ? new BigInt64Array(buffer.map(BigInt)).buffer
                                    : new Float32Array(buffer).buffer;
        }
        await this._check(await fetch(
            `${this.base}/models/${this.handle}/tensors/${encodeURIComponent(name)}?type=${type}&dims=${shape.join(",")}`,
            { method: "PUT", body }));
    }

    async get_tensor(name) {
        const r = await fetch(`${this.base}/models/${this.handle}/tensors/${encodeURIComponent(name)}`);
        const checked = await this._check(r);
        const buf = await checked.arrayBuffer();
        const head = new Uint32Array(buf, 0, 1);
        const ndims = head[0];
        const shape = Array.from(new Uint32Array(buf, 4, ndims));
        const data = new Float32Array(buf, 4 + 4 * ndims);
        return { shape, data };
    }

    async get_all_tensor_names() {
        const r = await fetch(`${this.base}/models/${this.handle}/tensor_names`);
        return (await r.text()).split("|");
    }

    async run() {
        await this._check(await fetch(`${this.base}/models/${this.handle}/run`, { method: "POST" }));
    }

    async clear_tensors() {
        await this._check(await fetch(`${this.base}/models/${this.handle}/clear_tensors`, { method: "POST" }));
    }

    async set_option(name, value) {
        await this._check(await fetch(
            `${this.base}/models/${this.handle}/options?name=${encodeURIComponent(name)}&value=${value ? 1 : 0}`,
            { method: "POST" }));
    }

    async add_extra_output(name) {
        await this._check(await fetch(
            `${this.base}/models/${this.handle}/extra_output?name=${encodeURIComponent(name)}`,
            { method: "POST" }));
    }

    async delete() {
        await fetch(`${this.base}/models/${this.handle}`, { method: "DELETE" });
    }
}

if (typeof module !== "undefined") module.exports = { Model };
