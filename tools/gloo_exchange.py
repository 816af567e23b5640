"""Two gloo ranks on one card: all_to_all_single on CUDA bf16/fp32 tensors,
the exchange-based reduce-scatter against reduce_scatter_tensor (bitwise),
each timed on the host clock.

Run from the repo root on a machine with one CUDA card:
``python3 tools/gloo_exchange.py``. Rank 0 prints, for bf16 and fp32, the
exchange's and ``reduce_scatter_tensor``'s seconds (two runs each) and
whether the two sums are equal bit for bit (``engine/placement.py``'s
``reduce_scatter_dim`` rests on it)."""
import os, sys, time, torch, torch.distributed as dist
sys.path.insert(0, "src")
from repro_torch.engine.placement import reduce_scatter_dim

def main(r, port):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=r, world_size=2)
    for dt in (torch.bfloat16, torch.float32):
        g = torch.randn(8192, 51200, device="cuda", generator=torch.Generator("cuda").manual_seed(r)).to(dt)
        ts = {}
        for name in ("a2a", "rs", "a2a", "rs"):
            torch.cuda.synchronize(); dist.barrier(); t = time.perf_counter()
            if name == "a2a":
                out = reduce_scatter_dim(dist, g, 0, 2, None)
            else:
                out2 = g.new_empty((4096, 51200)); dist.reduce_scatter_tensor(out2, g.contiguous())
            torch.cuda.synchronize(); ts.setdefault(name, []).append(time.perf_counter() - t)
        if r == 0:
            print(f"{dt} {g.numel()*g.element_size()/1e9:.2f} GB: exchange {ts['a2a']} s, reduce_scatter_tensor {ts['rs']} s, bitwise {torch.equal(out, out2)}", flush=True)
    dist.destroy_process_group()

if __name__ == "__main__":
    if len(sys.argv) > 1:
        main(int(sys.argv[1]), int(sys.argv[2])); sys.exit()
    import subprocess, socket
    s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]; s.close()
    ps = [subprocess.Popen([sys.executable, __file__, str(r), str(port)]) for r in range(2)]
    sys.exit(max(p.wait() for p in ps))
