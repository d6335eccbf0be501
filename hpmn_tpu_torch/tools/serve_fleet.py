"""Fleet launcher CLI: N uid-hash shard daemons from one command —
counterpart of ``tools/serve_fleet.py``.

    python -m hpmn_tpu_torch.tools.serve_fleet --bundle DIR --shards N
        [--base_port 7600] [--device cuda|cuda:N|cpu] [--journal_dir DIR]

A launcher for ``hpmn_tpu_torch.serving.fleet:main``; it prints ``FLEET
ready: host:port ...``, the address list ``ShardedServingClient`` takes.
See serving/fleet.py for the rest (per-shard journals, no save_on_exit by
design).
"""

from hpmn_tpu_torch.serving.fleet import main

if __name__ == "__main__":
    main()
