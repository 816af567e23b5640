"""Two gloo ranks on one card: all_gather of a 0.84 GB bf16 CUDA tensor
whole against the same in k flat chunks issued async, host clock, with
one, two and four gloo devices on the loopback (GLOO_SOCKET_IFNAME).

Run from the repo root on a machine with one CUDA card:
``python3 tools/gloo_gather_pieces.py``. Rank 0 prints one line a run:
the devices, k, seconds, GB/s of whole bytes and whether the gathered
tensor equals the first run's (``engine/placement.py``'s
GATHER_PIECE_BYTES and ``chip_smoke.py``'s GLOO_DEVICES rest on it)."""
import os, sys, time, torch, torch.distributed as dist

def gather(x, k):
    parts = [torch.empty_like(x) for _ in range(2)]
    flat = x.view(-1)
    n = flat.numel()
    step = -(-n // k)
    works = []
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        works.append(dist.all_gather([p.view(-1)[lo:hi] for p in parts], flat[lo:hi], async_op=True))
    for w in works:
        w.wait()
    return torch.cat(parts, 1)

def main(r, port):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=r, world_size=2)
    x = torch.randn(102400, 4096, device="cuda").to(torch.bfloat16) + r
    ref = None
    for k in (1, 8, 16, 1, 8, 16, 1, 8, 16, 1, 8, 16):
        torch.cuda.synchronize(); dist.barrier(); t = time.perf_counter()
        out = gather(x, k)
        torch.cuda.synchronize(); dt = time.perf_counter() - t
        ref = out if ref is None else ref
        if r == 0:
            print(f"{os.environ.get('GLOO_SOCKET_IFNAME', '-')} k={k}: {dt:.3f} s, {out.numel()*2/1e9/dt:.2f} GB/s of whole bytes, equal {torch.equal(out, ref)}", flush=True)
    dist.destroy_process_group()

if __name__ == "__main__":
    if len(sys.argv) > 1:
        main(int(sys.argv[1]), int(sys.argv[2])); sys.exit()
    import subprocess, socket
    s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]; s.close()
    rc = 0
    for ifname in (None, "lo,lo", "lo,lo,lo,lo"):
        env = dict(os.environ)
        if ifname:
            env["GLOO_SOCKET_IFNAME"] = ifname
        s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]; s.close()
        ps = [subprocess.Popen([sys.executable, __file__, str(r), str(port)], env=env) for r in range(2)]
        rc = max([rc] + [p.wait() for p in ps])
    sys.exit(rc)
