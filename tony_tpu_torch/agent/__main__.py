from tony_tpu_torch.agent.executor import main

if __name__ == "__main__":
    raise SystemExit(main())
