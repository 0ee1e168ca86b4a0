from csm_mlx_tpu_torch.cli.application import app

if __name__ == "__main__":
    app()
