// C# bindings for libonnxstream_tpu_torch, the C ABI of the PyTorch/CUDA
// port (onnxstream_tpu_torch/api/csrc/exports.cpp: model_new and the 15
// functions of the reference's ABI, built with g++ by
// onnxstream_tpu_torch/runtime/native.py exports_library). Surface parity
// with the reference src/bindings.cs: same entry points, same GetTensor
// return layout, IDisposable Model. The models run on the card unless the
// process sets ONNXSTREAM_TPU_TORCH_DEVICE=cpu.
//
// Usage:
//   using var model = new OnnxStreamTpu.Model(weightsProviderName: "dict");
//   model.AddWeightsFile("float32", "w.bin", rawBytes);
//   model.ReadString(modelTxt);
//   model.AddTensor("float32", "x", new uint[] { 2, 3 }, values);
//   model.Run();
//   float[] y = model.GetTensor("y", out long[] shape);
//
// Point the resolver at the built library if it is not on the loader path:
//   NativeLibrary.SetDllImportResolver(typeof(Model).Assembly,
//       (name, _, _) => name == "onnxstream_tpu_torch"
//           ? NativeLibrary.Load("/path/to/libonnxstream_tpu_torch.so")
//           : IntPtr.Zero);

using System;
using System.Collections.Generic;
using System.Runtime.InteropServices;
using System.Text;

namespace OnnxStreamTpu
{
    public class OnnxStreamTpuError : Exception
    {
        public OnnxStreamTpuError(string message) : base(message) { }
    }

    internal static class Native
    {
        private const string Lib = "onnxstream_tpu_torch";

        [StructLayout(LayoutKind.Sequential)]
        public struct TensorReturn
        {
            public IntPtr dims_num;
            public IntPtr dims;
            public IntPtr data_num;
            public IntPtr data;
        }

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern IntPtr model_new();

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern IntPtr model_new_2(int threads_count, [MarshalAs(UnmanagedType.LPStr)] string wp_name);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern void model_delete(IntPtr h);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern void model_read_string(IntPtr h, [MarshalAs(UnmanagedType.LPStr)] string s);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern IntPtr model_read_file(IntPtr h, [MarshalAs(UnmanagedType.LPStr)] string fn);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern IntPtr model_get_weights_names(IntPtr h);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern IntPtr model_add_weights_file(IntPtr h, [MarshalAs(UnmanagedType.LPStr)] string type, [MarshalAs(UnmanagedType.LPStr)] string name, uint size);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern IntPtr model_add_tensor(IntPtr h, [MarshalAs(UnmanagedType.LPStr)] string type, [MarshalAs(UnmanagedType.LPStr)] string name, uint dims_num, uint[] dims);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern IntPtr model_get_tensor(IntPtr h, [MarshalAs(UnmanagedType.LPStr)] string name);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern IntPtr model_get_all_tensor_names(IntPtr h);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern void model_run(IntPtr h);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern IntPtr model_run_2(IntPtr h);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern void model_clear_tensors(IntPtr h);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern void model_set_option(IntPtr h, [MarshalAs(UnmanagedType.LPStr)] string name, uint value);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern void model_add_extra_output(IntPtr h, [MarshalAs(UnmanagedType.LPStr)] string name);

        [DllImport(Lib, CallingConvention = CallingConvention.Cdecl)]
        public static extern void model_free_buffer(IntPtr p);
    }

    public class Model : IDisposable
    {
        private IntPtr _h;

        public Model(int threadsCount = 0, string weightsProviderName = "dict")
        {
            _h = Native.model_new_2(threadsCount, weightsProviderName);
            if (_h == IntPtr.Zero)
                throw new OnnxStreamTpuError("model_new_2 failed");
        }

        public void ReadString(string modelTxt) => Native.model_read_string(_h, modelTxt);

        public void ReadFile(string path)
        {
            IntPtr err = Native.model_read_file(_h, path);
            ThrowIfError(err);
        }

        public string[] GetWeightsNames()
        {
            IntPtr p = Native.model_get_weights_names(_h);
            string s = TakeString(p);
            return s.Length == 0 ? Array.Empty<string>() : s.Split('|');
        }

        public void AddWeightsFile(string type, string name, byte[] data)
        {
            IntPtr buf = Native.model_add_weights_file(_h, type, name, (uint)data.Length);
            Marshal.Copy(data, 0, buf, data.Length);
        }

        public void AddTensor(string type, string name, uint[] dims, float[] data)
        {
            IntPtr buf = Native.model_add_tensor(_h, type, name, (uint)dims.Length, dims);
            Marshal.Copy(data, 0, buf, data.Length);
        }

        public void AddTensor(string type, string name, uint[] dims, long[] data)
        {
            IntPtr buf = Native.model_add_tensor(_h, type, name, (uint)dims.Length, dims);
            Marshal.Copy(data, 0, buf, data.Length);
        }

        public float[] GetTensor(string name, out long[] shape)
        {
            IntPtr p = Native.model_get_tensor(_h, name);
            if (p == IntPtr.Zero)
                throw new OnnxStreamTpuError($"tensor '{name}' not found");
            var layout = Marshal.PtrToStructure<Native.TensorReturn>(p);
            int ndims = (int)layout.dims_num;
            shape = new long[ndims];
            for (int i = 0; i < ndims; i++)
                shape[i] = Marshal.ReadIntPtr(layout.dims, i * IntPtr.Size).ToInt64();
            var data = new float[(int)layout.data_num];
            Marshal.Copy(layout.data, data, 0, data.Length);
            Native.model_free_buffer(p);
            return data;
        }

        public string[] GetAllTensorNames()
        {
            IntPtr p = Native.model_get_all_tensor_names(_h);
            string s = TakeString(p);
            return s.Length == 0 ? Array.Empty<string>() : s.Split('|');
        }

        public void Run() => Native.model_run(_h);

        public void RunChecked() => ThrowIfError(Native.model_run_2(_h));

        public void ClearTensors() => Native.model_clear_tensors(_h);

        public void SetOption(string name, bool value) => Native.model_set_option(_h, name, value ? 1u : 0u);

        public void AddExtraOutput(string name) => Native.model_add_extra_output(_h, name);

        // option helpers matching the reference setter surface
        public void SetUseFp16Arithmetic(bool v) => SetOption("use_fp16_arithmetic", v);
        public void SetSupportDynamicShapes(bool v) => SetOption("support_dynamic_shapes", v);
        public void SetUseOpsCache(bool v) => SetOption("use_ops_cache", v);
        public void SetUseNextOpCache(bool v) => SetOption("use_next_op_cache", v);
        public void SetUseScaledDpAttnOp(bool v) => SetOption("use_scaled_dp_attn_op", v);
        public void SetOpsPrintf(bool v) => SetOption("ops_printf", v);
        public void SetOpsTimesPrintf(bool v) => SetOption("ops_times_printf", v);

        private static string TakeString(IntPtr p)
        {
            if (p == IntPtr.Zero) return "";
            string s = Marshal.PtrToStringAnsi(p) ?? "";
            Native.model_free_buffer(p);
            return s;
        }

        private static void ThrowIfError(IntPtr err)
        {
            if (err == IntPtr.Zero) return;
            string msg = Marshal.PtrToStringAnsi(err) ?? "unknown error";
            Native.model_free_buffer(err);
            throw new OnnxStreamTpuError(msg);
        }

        public void Dispose()
        {
            if (_h != IntPtr.Zero)
            {
                Native.model_delete(_h);
                _h = IntPtr.Zero;
            }
            GC.SuppressFinalize(this);
        }

        ~Model() => Dispose();
    }
}
