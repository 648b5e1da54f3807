"""The port's fleet launcher and chaos scenarios as processes (JAX-free).

- ``python -m fleetx_tpu_torch.tools.serve --demo --device cpu`` serves
  streamed completions through two replica processes; a replica process
  SIGKILLed mid-SSE leaves the stream byte-equal to the demo engine's in
  process (no token lost or repeated), and SIGTERM drains the fleet to
  exit 0 with no process left.
- The six ported chaos scenarios pass with ``--device cpu``.
- Without ``--device cpu`` the launcher, and a replica worker, exit
  non-zero with the device resolver's error where CUDA is absent.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from fleetx_tpu_torch.tools import chaos_check
from fleetx_tpu_torch.tools.serve import _build_demo_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_LEN = 20


def _env(**extra):
    env = dict(os.environ, **extra)
    env.pop("FLEETX_OBS_PORT", None)
    return env


def _children(pid):
    """pid -> command line of every live process whose parent is ``pid``."""
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        if int(fields[1]) == pid and fields[0] != "Z":
            out[int(entry)] = [c.decode() for c in cmd if c]
    return out


def _replica_urls(launcher_pid):
    """pid -> RPC URL of each replica process under the launcher (read
    from the port file its command line names)."""
    urls = {}
    for pid, cmd in _children(launcher_pid).items():
        if "--replica-worker" in cmd:
            pf = cmd[cmd.index("--port-file") + 1]
            with open(pf) as f:
                urls[pid] = f"http://127.0.0.1:{int(f.read())}"
    return urls


def test_serve_demo_cpu_survives_a_killed_replica_and_drains(tmp_path):
    eng = _build_demo_engine(0, device="cpu")
    rid = eng.submit([1, 2, 3], max_length=GEN_LEN)
    clean = eng.drain()[rid].tokens.tolist()
    assert len(clean) == GEN_LEN and len(set(clean)) > 1

    pf = tmp_path / "api.port"
    # every front-door RPC waits 20 ms, so the stream is still in flight
    # when the replica dies
    proc = subprocess.Popen(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.serve", "--demo",
         "--device", "cpu", "--replicas", "2", "--port", "0",
         "--api-port-file", str(pf), "--grace-s", "5"],
        cwd=ROOT, env=_env(FLEETX_FAULT_RPC_DELAY="0+",
                           FLEETX_FAULT_RPC_DELAY_S="0.02"))
    try:
        deadline = time.monotonic() + 120
        while not pf.exists():
            assert proc.poll() is None, "launcher died during start-up"
            assert time.monotonic() < deadline, "API port never published"
            time.sleep(0.1)
        base = f"http://127.0.0.1:{int(pf.read_text())}"
        replicas = _replica_urls(proc.pid)
        assert len(replicas) == 2
        req = urllib.request.Request(
            base + "/v1/chat/completions",
            json.dumps({"stream": True, "max_tokens": GEN_LEN,
                        "messages": [{"role": "user",
                                      "content": "1 2 3"}]}).encode(),
            {"Content-Type": "application/json"})
        toks, finish, killed = [], None, None
        with urllib.request.urlopen(req, timeout=120) as resp:
            for line in resp:
                line = line.decode().strip()
                if not line.startswith("data: ") or line[6:] == "[DONE]":
                    continue
                chunk = json.loads(line[6:])
                if "token" in chunk:
                    toks.append(chunk["token"])
                finish = chunk["choices"][0]["finish_reason"] or finish
                if len(toks) == 3 and killed is None:
                    for pid, url in replicas.items():
                        with urllib.request.urlopen(url + "/healthz",
                                                    timeout=30) as r:
                            if json.loads(r.read())["active"]:
                                killed = pid
                                os.kill(pid, signal.SIGKILL)
                                break
        assert killed is not None, "no replica was decoding the stream"
        assert toks == clean, "a token was lost or repeated"
        assert finish == "length"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["state"] == "ok" and "dead" in health["replicas"]
        survivors = set(_children(proc.pid)) - {killed}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        assert not _children(proc.pid)
        assert not any(os.path.exists(f"/proc/{p}") and
                       open(f"/proc/{p}/stat").read().rsplit(")", 1)[1]
                       .split()[0] != "Z" for p in survivors)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.parametrize("name", sorted(chaos_check.SCENARIOS))
def test_chaos_scenario_on_the_cpu(name, tmp_path, capsys):
    assert chaos_check.main(["--only", name, "--device", "cpu",
                             "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"PASS {name}:" in out and "1/1 scenarios passed" in out


def test_chaos_unknown_scenario_fails(tmp_path, capsys):
    assert chaos_check.main(["--only", "nope", "--device", "cpu",
                             "--workdir", str(tmp_path)]) == 1
    assert "FAIL nope: unknown scenario" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--demo", "--replicas", "1", "--port", "0"],
    ["--replica-worker", "--port-file", "unused.port"]],
    ids=["launcher", "replica-worker"])
def test_serve_without_cuda_exits_nonzero(argv, tmp_path):
    """No ``--device cpu`` and no card: the resolver's error, never a
    fallback to the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "fleetx_tpu_torch.tools.serve", *argv],
        cwd=tmp_path, env=_env(CUDA_VISIBLE_DEVICES="",
                               PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "unused.port").exists()
