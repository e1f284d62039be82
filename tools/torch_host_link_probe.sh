#!/usr/bin/env bash
# The host side of the machine that holds the card: Python and libpython
# (what the C library links), the compilers, disk and memory, the card's
# name and power limit, a 1 GiB pinned host-to-device copy (three times), a
# host memcpy into pinned memory and a host fp16 -> bf16 conversion of 2^28
# elements.
#
#     bash tools/torch_host_link_probe.sh
python3 -c "
import sysconfig,sys,torch; print(sys.version, torch.__version__, torch.version.cuda)
for k in ['LIBDIR','LDLIBRARY','Py_ENABLE_SHARED','INCLUDEPY','VERSION','ABIFLAGS','LIBS','SYSLIBS']: print(k, sysconfig.get_config_var(k))
print(sysconfig.get_paths()['include'], sysconfig.get_paths()['purelib'], sys.prefix, sys.base_prefix)
"
which gcc g++ python3; ls $(python3 -c "import sysconfig;print(sysconfig.get_config_var('LIBDIR'))") | grep -i python | head; df -h /tmp . | tail -2; free -g | head -2; nproc
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c "
import torch,time
x=torch.empty(1<<30,dtype=torch.uint8,pin_memory=True); d=torch.empty(1<<30,dtype=torch.uint8,device='cuda')
for _ in range(3):
  torch.cuda.synchronize(); t=time.perf_counter(); d.copy_(x,non_blocking=True); torch.cuda.synchronize(); print('H2D pinned GB/s', 1.0737/(time.perf_counter()-t))
y=torch.empty(1<<30,dtype=torch.uint8)
t=time.perf_counter(); x.copy_(y); print('host memcpy GB/s', 1.0737/(time.perf_counter()-t))
h=torch.randn(1<<28).half(); t=time.perf_counter(); b=h.to(torch.bfloat16); print('host fp16->bf16 Melem/s', (1<<28)/1e6/(time.perf_counter()-t), torch.get_num_threads())
"
